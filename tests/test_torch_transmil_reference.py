"""The port's TransMIL against the benchmark's plain reference
(``bench_port/reference/transmil.py``) on the CPU at a small size: dim 64,
8 heads of 8, 32 landmarks, 3 bags of 150 patches (a 13 x 13 grid, 170
tokens left-padded to 192), so that the left pad and the pseudo-inverse's
normaliser over the whole batch both act.  One state dict loads into both.

Tolerances: the two compute the same f32 operations, the reference on the
padded sequence from ``to_qkv`` on (the published layer pads its input)
and the port from the core on: rows of one product summed in the same
order, so the logits and the loss agree within 1e-6 relative, every
gradient leaf and each of three AdamW updates within 1e-5 of the leaf's
norm (or the median leaf's, ``bench_port/compare.py``): the pinv's cubic
iterations amplify a first difference in the last bit, and AdamW divides
by the root of second moments that are small at the first steps.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import compare, inputs
from bench_port.reference import transmil as ref_transmil
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.models.mil import TransMIL
from disentangled_multimodal_learning_tpu_torch.ops import launches
from disentangled_multimodal_learning_tpu_torch.train import optim, trainers

REPO = Path(__file__).resolve().parents[1]
DIM, LANDMARKS, IN_DIM, PATH_DIM = 64, 32, 32, 16
BAGS, PATCHES = 3, 150
STEPS = 3
LOGIT_RTOL, LEAF_TOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings():
    cfg = json.loads((REPO / "bench_port" / "configs" /
                      "transmil_diag2021.json").read_text())
    return {**cfg["settings"], "input_path_dim": IN_DIM,
            "path_dim": PATH_DIM, "batch_size": BAGS}, cfg["class_weights"]


def _pair(seed=5):
    """``(port, reference, state)``: both models at the small widths, one
    seeded state dict loaded into each."""
    settings, _ = _settings()
    ref = ref_transmil.build(settings, "cpu", dim=DIM, landmarks=LANDMARKS)
    state = inputs.make_state(ref, seed, "cpu")
    ref.load_state_dict(state, strict=True)
    port = TransMIL(int(settings["label_dim"]), PATH_DIM, IN_DIM, dim=DIM)
    port.load_state_dict(state, strict=True)
    return port, ref, state


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((BAGS, PATCHES, IN_DIM),
                                             dtype=np.float32))
    label = torch.from_numpy(rng.integers(0, 4, (BAGS, 12)))
    return {"x_path10": x, "label": label}


def _rel(got, want) -> float:
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max())


def _logits(port, ref, batch):
    out = []
    for model in (port, ref):
        torch.manual_seed(11)  # one dropout seed: the same masks
        out.append(model.train()(batch["x_path10"])[1])
    return out


def _losses(port, ref, batch):
    _, cw = _settings()
    y = batch["label"][:, ref_transmil.CLASS_COL["diag2021"]]
    got, want = _logits(port, ref, batch)
    cw = torch.tensor(cw)
    return (ref_transmil.weighted_cross_entropy(got, y, cw),
            ref_transmil.weighted_cross_entropy(want, y, cw))


def _grads(port, ref, batch):
    for loss in _losses(port, ref, batch):
        loss.backward()
    return ({n: p.grad for n, p in port.named_parameters()
             if p.grad is not None},
            {n: p.grad for n, p in ref.named_parameters()
             if p.grad is not None})


def _updates(port, ref, state):
    """Three train steps of each: the port's ``make_step`` with the
    preset's AdamW and cosine schedule, the reference's ``Trainer``; the
    parameters' change over them."""
    settings, cw = _settings()
    cfg = Config.from_dict({**settings, "checkpoints": "#"}).validate()
    opt = optim.make_optimizer(cfg, port.parameters())
    sched = optim.make_scheduler(cfg, opt, 16)
    step, _ = trainers.make_step(cfg, port, opt, sched)
    trainer = ref_transmil.Trainer(ref, settings, 16, torch.tensor(cw))
    for i in range(STEPS):
        batch = _batch(20 + i)
        torch.manual_seed(30 + i)
        got = float(step(batch)["loss"])
        torch.manual_seed(30 + i)
        want = float(trainer.step(batch))
        assert abs(got - want) <= LOGIT_RTOL * abs(want), i
    return ({n: p.detach() - state[n] for n, p in port.named_parameters()},
            {n: p.detach() - state[n] for n, p in ref.named_parameters()})


@pytest.mark.parametrize("what", ["logits", "loss", "grads", "updates"])
def test_port_matches_the_reference(what):
    port, ref, state = _pair()
    batch = _batch()
    if what == "logits":
        got, want = _logits(port, ref, batch)
        assert _rel(got, want) <= LOGIT_RTOL
    elif what == "loss":
        got, want = _losses(port, ref, batch)
        assert abs(float(got - want)) <= LOGIT_RTOL * abs(float(want))
    elif what == "grads":
        got, want = _grads(port, ref, batch)
        assert set(got) == set(want) == {
            n for n, _ in ref.named_parameters()
            if not n.startswith("multimodal_projection")}
        assert compare.leaf_gap(got, want) <= LEAF_TOL
    else:
        got, want = _updates(port, ref, state)
        assert set(got) == set(state)
        assert compare.leaf_gap(got, want) <= LEAF_TOL
        # the projection, which the loss does not read, moved by decay
        assert float(want["multimodal_projection.weight"].abs().max()) > 0


def test_the_reference_imports_neither_jax_nor_the_port():
    tree = ast.parse(Path(ref_transmil.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    tops = {n.split(".")[0] for n in names}
    assert tops <= {"__future__", "math", "torch"}, names


def test_a_forward_counts_two_core_calls():
    port, _, _ = _pair()
    before = launches.core_calls()["nystrom"], launches.counts()
    with torch.no_grad():
        port.eval()(_batch()["x_path10"])
    assert launches.core_calls()["nystrom"] - before[0] == 2
    assert launches.counts() == before[1]  # no kernel of the port
