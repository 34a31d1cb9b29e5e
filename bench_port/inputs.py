"""Everything a run feeds the program and the reference, made from
``--seed``: the host batches of a cell's pool and the model's weights.

The bags follow the port's ``data/synthetic.py SyntheticBagDataset``
recipe, copied here so that a change to the port cannot move the
yardstick: per bag a label drawn uniformly over the task's classes, the
patch features of both magnifications ``N(0, 1) + path_means[label]``
(``path_means ~ N(0, 0.5)`` a class), the omic vector ``N(0, 1) +
omic_means[label]`` with its tumor head and immune tail, and the twelve
label columns of the data contract.  The features, the bulk of the bytes,
are drawn on the run's device by one ``torch.Generator`` call and copied
to the host once; the pool's batches are host numpy arrays, contiguous by
field, as the port's loader hands them over.

The weights are drawn on the device by one ``torch.Generator`` call over
every parameter of the model, then scaled per tensor: a weight
``U(-a, a)`` with ``a = sqrt(3 / fan_in)`` (variance ``1 / fan_in``), a
bias ``U(-b, b)`` with ``b = 1 / sqrt(fan_in)`` of its layer, a LayerNorm
scale ``1 + U(-0.1, 0.1)`` and shift ``U(-0.1, 0.1)``.  Nothing of the
port's ``init_weights`` is used: both sides load the same state dict.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

NUM_LABEL_COLUMNS = 12
# data contract columns
IDH, CODEL, CDKN, HIS, GRADE, DIAG, HIS2, SUBTYPE, SURV_BIN, CENSOR, EVENT, \
    SURV_TIME = range(NUM_LABEL_COLUMNS)


@dataclasses.dataclass
class Batch:
    """One host batch, the fields the port's ``data/contract.py Batch``
    carries and its entries read."""

    x_path10: np.ndarray  # [B, N, D] float32
    x_path20: np.ndarray
    x_omic: np.ndarray    # [B, omic] float32
    x_omic_tumor: np.ndarray
    x_omic_immune: np.ndarray
    label: np.ndarray     # [B, 12] int32


def streams(seed: int) -> dict:
    """Independent 63-bit seeds of one run: ``data``, ``features``,
    ``weights`` and ``dropout``."""
    state = np.random.SeedSequence(int(seed) % 2 ** 64).generate_state(
        4, dtype=np.uint64)
    return {k: int(v) >> 1 for k, v in zip(
        ("data", "features", "weights", "dropout"), state)}


def make_pool(settings: dict, batches: int, batch_size: int, seed: int,
              device) -> list:
    """``batches`` distinct host batches of ``batch_size`` bags at the
    configuration's widths."""
    s = streams(seed)
    n, d = int(settings["fixdim"]), int(settings["input_path_dim"])
    n_omic = int(settings["input_size_omic"])
    n_tumor = int(settings["input_size_omic_tumor"])
    n_immune = int(settings["input_size_omic_immune"])
    classes = int(settings["label_dim"])
    rng = np.random.default_rng(s["data"])
    path_means = rng.normal(0, 0.5, (classes, d)).astype(np.float32)
    omic_means = rng.normal(0, 0.5, (classes, n_omic)).astype(np.float32)
    total = batches * batch_size
    y = rng.integers(0, classes, size=total)
    omic = (rng.normal(0, 1, (total, n_omic)).astype(np.float32)
            + omic_means[y])
    label = np.zeros((total, NUM_LABEL_COLUMNS), dtype=np.int32)
    label[:, IDH] = y % 2
    label[:, CODEL] = (y // 2) % 2
    label[:, HIS] = y % 3
    label[:, GRADE] = rng.integers(0, 3, size=total)
    label[:, DIAG] = y
    label[:, HIS2] = y % 2
    label[:, SUBTYPE] = rng.integers(0, 3, size=total)
    label[:, SURV_BIN] = rng.integers(0, 4, size=total)
    label[:, CENSOR] = rng.integers(0, 2, size=total)
    label[:, EVENT] = 1 - label[:, CENSOR]
    label[:, SURV_TIME] = rng.integers(30, 3000, size=total)

    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(s["features"])
    feats = torch.randn((2, total, n, d), generator=g, device=device)
    feats += torch.from_numpy(path_means).to(device)[
        torch.from_numpy(y).to(device)][None, :, None, :]
    feats = feats.cpu().numpy().reshape(2, batches, batch_size, n, d)
    omic = omic.reshape(batches, batch_size, n_omic)
    label = label.reshape(batches, batch_size, NUM_LABEL_COLUMNS)
    return [Batch(x_path10=feats[0, b], x_path20=feats[1, b],
                  x_omic=omic[b], x_omic_tumor=omic[b, :, :n_tumor].copy(),
                  x_omic_immune=omic[b, :, n_omic - n_immune:].copy(),
                  label=label[b]) for b in range(batches)]


def _fan_in(w: torch.Tensor) -> int:
    return max(1, w.numel() // w.shape[0])


def make_state(model: torch.nn.Module, seed: int, device) -> dict:
    """A state dict for ``model``'s parameters, drawn on ``device``."""
    layer_norms = {name for name, m in model.named_modules()
                   if isinstance(m, torch.nn.LayerNorm)}
    params = dict(model.named_parameters())
    names = list(params)
    scale, shift = [], []
    for name in names:
        p = params[name]
        owner, _, leaf = name.rpartition(".")
        if owner in layer_norms:
            a, b = 0.1, 1.0 if leaf == "weight" else 0.0
        elif p.dim() >= 2:
            a, b = math.sqrt(3.0 / _fan_in(p)), 0.0
        else:
            weight = params.get(f"{owner}.{leaf.replace('bias', 'weight')}")
            a, b = 1.0 / math.sqrt(_fan_in(weight) if weight is not None
                                   else p.numel()), 0.0
        scale.append(np.full(p.numel(), a, np.float32))
        shift.append(np.full(p.numel(), b, np.float32))
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(streams(seed)["weights"])
    u = torch.rand(sum(p.numel() for p in params.values()), generator=g,
                   device=device)
    flat = (torch.from_numpy(np.concatenate(shift)).to(device)
            + torch.from_numpy(np.concatenate(scale)).to(device) * (2 * u - 1))
    out, at = {}, 0
    for name in names:
        p = params[name]
        out[name] = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
    return out
