"""TransMIL's cell: its flops and the Nystrom core's bound against hand
counts, the three readers of the cores and TransMIL's flops on synthetic
spans (a number in the cell, None outside it or where the program keeps
no layer marks), and its entries in the manifest."""

import json
import types

import pytest

from bench_port import cores, harness, spans
from bench_port import trace as tr
from bench_port.counts import transmil_flops
from bench_port.reference import transmil as ref
from disentangled_multimodal_learning_tpu_torch.utils.profiling import Span

CELL = "transmil_train_k4"
READERS = ("nystrom_ms.train", "nystrom_roofline_pct.train",
           "train_mfu.transmil")


@pytest.fixture(scope="module")
def config():
    return json.loads((harness.ROOT / "configs" /
                       "transmil_diag2021.json").read_text())


def _core_per_head(n, m=256, d=64, iters=6):
    return (2 * n * m * d          # q k_l^T
            + 2 * m * m * d        # q_l k_l^T
            + 2 * m * n * d        # q_l k^T
            + iters * 4 * 2 * m ** 3  # the pseudo-inverse
            + 2 * n * m * m        # attn1 P
            + 2 * m * n * d        # attn3 v
            + 2 * n * m * d)       # (attn1 P) (attn3 v)


@pytest.mark.parametrize("fixdim,side,seq,n", [(9, 3, 10, 256),
                                               (2500, 50, 2501, 2560)])
def test_core_flops_by_hand(config, fixdim, side, seq, n):
    s = {**config["settings"], "fixdim": fixdim}
    assert transmil_flops.tokens(s) == (side, seq, n)
    assert transmil_flops.core_forward(s, 4) == 4 * 8 * _core_per_head(n)


def test_core_forward_and_bound_at_the_preset(config):
    s = config["settings"]
    # one core's forward at B 4: 25.8 GFLOP of pseudo-inverse, 10.7 of
    # attn1 P, 10.7 of the products with D 64 and 0.27 of q_l k_l^T
    assert transmil_flops.core_forward(s, 4) / 1e9 == pytest.approx(
        47.51, abs=0.01)
    # forward and backward, 3x the flops at 67 TFLOP/s: flops bound it
    assert transmil_flops.core_bound(s, 4) == pytest.approx(
        3 * transmil_flops.core_forward(s, 4) / 67e12)


def test_model_flops_by_hand(config):
    s, bags, seq = config["settings"], 4, 2501
    layer = (2 * bags * seq * 512 * 1536             # to_qkv
             + transmil_flops.core_forward(s, bags)
             + 2 * bags * 8 * seq * 64 * 33          # res_conv
             + 2 * bags * seq * 512 * 512)           # to_out
    grad = (2 * bags * 2500 * 1024 * 512             # _fc1
            + 2 * layer
            + 2 * bags * 512 * 2500 * (49 + 25 + 9)  # PPEG
            + 2 * bags * 512 * 4)                    # _fc2
    projection = 2 * bags * 512 * 128
    assert transmil_flops.forward(s, bags) == grad + projection
    assert transmil_flops.train(s, bags) == 3 * grad + projection


def _chunk(updates, core_ms, calls):
    """A replay's span: per update 1 ms of forward (its two cores' forward
    ``core_ms`` each) and 2 ms of backward (their backward ``core_ms``
    each), the cores' marks kept apart."""
    s = Span("chunk", 0, -1, {"waited_us": 5, "nystrom_calls": calls})
    t = 0.0
    for _ in range(updates):
        s.marks += [("step.start", t), ("step.loss", t + 1.0),
                    ("step.optimizer", t + 3.0), ("step.end", t + 3.5)]
        for part, at in (("fwd", t), ("fwd", t + 0.5), ("bwd", t + 1.0),
                         ("bwd", t + 2.0)):
            s.layer_marks += [(f"nystrom.{part}.start", at),
                              (f"nystrom.{part}.end", at + core_ms)]
        t += 4.0
    return s


def _run(mode="transmil", trace=True):
    settings = {**json.loads((harness.ROOT / "configs" /
                              "transmil_diag2021.json").read_text())
                ["settings"], "mode": mode}
    return harness.Run(
        cell=types.SimpleNamespace(settings=settings), setup_s=10.0,
        bags_per_call=16, updates_per_call=4, spans=[], window_s=20.0,
        calls=100, forward_done=[],
        trace=tr.Trace([], [], 1.0) if trace else None, traced_calls=2)


@pytest.fixture
def program(monkeypatch):
    class Program:
        spans = []

    monkeypatch.setattr(spans, "program_spans", lambda: Program.spans)
    return Program


def test_readers_read_the_cores(program):
    program.spans = [_chunk(4, 0.25, 8), _chunk(4, 0.25, 8),
                     Span("chunk", 0, -1, {"nystrom_calls": 8})]
    run = _run()
    # 4 marked intervals of 0.25 ms an update; the unread replay left out
    assert harness.reader("nystrom_ms.train")(run) == pytest.approx(1.0)
    bound = transmil_flops.core_bound(run.cell.settings, 4)
    assert harness.reader("nystrom_roofline_pct.train")(run) == \
        pytest.approx(100 * bound * 16 / 8e-3)
    flops = transmil_flops.train(run.cell.settings, 4) * 4 * 100
    assert harness.reader("train_mfu.transmil")(run) == pytest.approx(
        100 * flops / 20.0 / 989e12)
    assert [sum(cores.update_ms(s)) for s in program.spans[:1]] == [4.0]


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_gives_none(program, name):
    read = harness.reader(name)
    program.spans = [_chunk(4, 0.25, 8)]
    assert read(_run(mode="teacher")) is None
    if name == "train_mfu.transmil":
        return
    assert read(_run(trace=False)) is None
    program.spans = None  # no recorder
    assert read(_run()) is None
    old = Span("chunk", 0, -1, {"waited_us": 5})  # a program without
    old.marks = _chunk(4, 0.25, 8).marks           # layer marks
    program.spans = [old]
    assert read(_run()) is None


def test_the_manifest_holds_the_cell(manifest, config):
    cells = {w["name"]: w for w in manifest["workloads"]}
    assert cells[CELL]["config"] == "transmil_diag2021"
    assert cells[CELL]["chips"] == 1
    per_layer = {m["name"]: m for m in manifest["per_layer"]}
    for name in READERS:
        assert per_layer[name]["workloads"] == [CELL]
    for name in ("train_mfu", "kernel_roofline_pct.train",
                 "setup_kernels_s"):
        assert CELL not in per_layer[name]["workloads"]
    e2e = {m["name"] for m in harness.metrics_of(CELL, manifest, False)}
    assert e2e == {"train_bags_per_s", "setup_s"}
    entry = {c["name"]: c for c in manifest["configs"]}["transmil_diag2021"]
    assert entry["reduced"] == config["reduced"] == []
    assert len(entry["source"]) <= 200 and entry["source"] == \
        config["source"]


def test_the_widths_are_the_published_ones(config):
    """The configuration's stated widths are the reference's, and the
    port's model has them."""
    from disentangled_multimodal_learning_tpu_torch.models.mil import \
        TransMIL

    w = config["widths"]
    assert (w["dim"], w["heads"], w["num_landmarks"], w["pinv_iterations"],
            w["residual_conv_kernel"], tuple(w["ppeg_kernels"]),
            w["dropout"]) == (ref.DIM, ref.HEADS, ref.LANDMARKS,
                              ref.PINV_ITERS, ref.RES_KERNEL,
                              ref.PPEG_KERNELS, ref.DROPOUT)
    assert w["dim_head"] * w["heads"] == w["dim"]
    assert w["input_path_dim"] == config["settings"]["input_path_dim"]
    s = config["settings"]
    port = TransMIL(s["label_dim"], s["path_dim"], s["input_path_dim"])
    attn = port.layer1.attn
    assert (attn.heads, attn.dim_head, attn.num_landmarks,
            attn.pinv_iterations) == (8, 64, 256, 6)
    assert tuple(attn.res_conv.weight.shape) == (8, 1, 33, 1)
    assert [port.pos_layer.proj.kernel_size[0],
            port.pos_layer.proj1.kernel_size[0],
            port.pos_layer.proj2.kernel_size[0]] == [7, 5, 3]
    assert attn.dropout.p == 0.1
    assert sum(p.numel() for p in port.parameters()) == pytest.approx(
        2.7e6, rel=0.05)
