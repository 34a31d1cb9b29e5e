"""Checkpoints of the port (counterpart of
``disentangled_multimodal_learning_tpu/utils/checkpoint.py``:
``metric_stamped_name`` :22, ``save_checkpoint`` :43, ``load_checkpoint``
:58, ``restore_state`` :63), named as JAX names them:

    {mode}_fold_{k}_epoch_{e}_AUC_{...}_ACC_{...}_..._  /  {mode}_fold_{k}_epoch_{e}_cindex_{...}_

A checkpoint is one ``torch.save`` file holding

- ``params``: the model's reference-named state_dict (CPU tensors), the
  reference's own checkpoint format, which JAX's
  ``utils/torch_import.import_torch_checkpoint`` reads unchanged;
- ``opt_state``: ``optimizer.state_dict()``;
- ``scheduler``: the ``LambdaLR`` state;
- ``step``: the train steps taken;
- ``extra``: mode, task and fold (and the epoch, in a rolling checkpoint).

Its suffix is ``.pt``, not JAX's ``.ckpt``: JAX cannot restore the port's
optimizer state (it can import the ``params``).  :func:`load_checkpoint`
also reads a bare reference-named state_dict (a ``.pth``, as the reference
and JAX's ``save_torch_checkpoint`` write it): its payload holds the params
only.  It reads a JAX ``.ckpt`` (JAX's pickle backend) through
``utils/jax_checkpoint.py``, for the model of a mode: params,
``batch_stats``, the optimizer's state (``jax_opt_state``, which
:func:`restore_state` puts into the torch optimizer and its scheduler),
step and extra.  It refuses a ``.orbax`` directory, JAX's other backend:
reading it needs orbax.  JAX's ``load_checkpoint_any`` also chooses by
suffix.  :func:`restore_state` loads strictly but for :data:`IGNORABLE`
keys, the reference's members that no forward reads (JAX
``utils/torch_import.py`` ``_IGNORABLE``), which it drops where the model
has no such key.
"""

from __future__ import annotations

import os

import torch

from ..train.optim import capturable_flags, keep_capturable
from .jax_checkpoint import (jax_payload, load_optimizer_state,
                             read_jax_checkpoint)

SUFFIX = ".pt"
JAX_SUFFIX = ".ckpt"
# key prefixes of reference members the port does not build: the
# reference MultiScaleNet's FusionNet, never in its forward (model.py:619)
IGNORABLE = ("fusion.fusion_layer.",)


def metric_stamped_name(cur_fold: int, epoch: int, metrics: dict,
                        task_type: str, mode: str | None = None) -> str:
    """The reference's name (1-based fold and epoch), with JAX's ``mode``
    prefix so that the student and the distilled student of one fold do
    not overwrite each other."""
    prefix = f"{mode}_" if mode else ""
    if task_type == "survival":
        return prefix + "fold_{:d}_epoch_{:d}_cindex_{:f}_".format(
            cur_fold + 1, epoch + 1, metrics["cindex"])
    return prefix + ("fold_{:d}_epoch_{:d}_AUC_{:f}_ACC_{:f}_Sens_{:f}_"
                     "Spec_{:f}_F1_{:f}_".format(
                         cur_fold + 1, epoch + 1, metrics["auc"],
                         metrics["acc"], metrics["sens"], metrics["spec"],
                         metrics["f1"]))


def save_checkpoint(directory: str, name: str, model, optimizer=None,
                    scheduler=None, step: int = 0,
                    extra: dict | None = None) -> str:
    """Write ``<directory>/<name>.pt``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "params": {k: v.detach().cpu()
                   for k, v in model.state_dict().items()},
        "opt_state": optimizer.state_dict() if optimizer is not None
        else None,
        "scheduler": scheduler.state_dict() if scheduler is not None
        else None,
        "step": int(step),
        "extra": dict(extra or {}),
    }
    path = os.path.join(directory, name + SUFFIX)
    torch.save(payload, path)
    return path


def load_checkpoint(path: str, mode: str | None = None,
                    attn_dim: int = 2) -> dict:
    """The payload of a ``.pt`` checkpoint, or of a bare state_dict (params
    only, step 0), on the CPU; of a JAX ``.ckpt``, for the model of
    ``mode`` at ``attn_dim`` (default: the mode the file names; a file of
    another mode raises).  A ``.orbax`` path raises."""
    path = os.fspath(path)
    if path.rstrip("/").endswith(".orbax"):
        raise ValueError(f"{path}: a JAX orbax checkpoint; reading it needs "
                         "orbax, which the port does not use (write the fold "
                         "with JAX's pickle backend, a .ckpt)")
    if path.endswith(JAX_SUFFIX):
        return jax_payload(read_jax_checkpoint(path), mode, attn_dim)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "params" not in payload:
        payload = {"params": payload, "opt_state": None, "scheduler": None,
                   "step": 0, "extra": {}}
    return payload


def restore_state(model, optimizer, scheduler, source,
                  mode: str | None = None, attn_dim: int = 2) -> int:
    """Load ``source`` (a path, read by :func:`load_checkpoint` with
    ``mode`` and ``attn_dim``, or a payload of it) into ``model``
    (strictly) and, where the payload holds their state and they are
    given, into ``optimizer`` and ``scheduler``; returns the payload's
    step."""
    payload = (load_checkpoint(source, mode, attn_dim)
               if isinstance(source, (str, os.PathLike)) else source)
    own = model.state_dict()
    params = {k: v for k, v in payload["params"].items()
              if k in own or not k.startswith(IGNORABLE)}
    model.load_state_dict(params, strict=True)
    if optimizer is not None and payload.get("opt_state") is not None:
        flags = capturable_flags(optimizer)
        optimizer.load_state_dict(payload["opt_state"])
        keep_capturable(optimizer, flags)
    if scheduler is not None and payload.get("scheduler") is not None:
        scheduler.load_state_dict(payload["scheduler"])
    if optimizer is not None and payload.get("jax_opt_state") is not None:
        load_optimizer_state(model, optimizer, scheduler,
                             payload["jax_opt_state"])
    return int(payload.get("step", 0))
