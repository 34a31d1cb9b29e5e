"""The committed JAX fold, ``tests/data/jax_teacher_fold.ckpt`` (written by
``tests/make_jax_checkpoint_fixture.py``, which says what it holds), and
what JAX computed from it (``jax_teacher_fold.npz``), on the CPU: JAX's
own ``restore_state`` reproduces the stored eval logits, so the fixture
cannot go stale; the port's serving entry with ``--checkpoint`` reproduces
them, and its training entry with ``resume`` takes the file as the fold's
rolling checkpoint, starts at epoch 3 and reproduces JAX's next 2 losses.
``chip_smoke.py`` phase 3n/5n does the same on the card.  A fresh
interpreter serves it without loading JAX, flax or optax.

Tolerances: JAX against itself 1e-6 abs (the same f32 program on the same
inputs; XLA may fuse otherwise across versions); the port's logits within
1e-4 abs and its losses within 2e-4 relative, as
``tests/test_torch_jax_checkpoint.py`` holds them.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu.models import deform_attention as jda
from disentangled_multimodal_learning_tpu.models.factory import (
    define_net as jdefine_net)
from disentangled_multimodal_learning_tpu.ops.pallas import deform_attn as jpda
from disentangled_multimodal_learning_tpu.train.state import TrainState
from disentangled_multimodal_learning_tpu.utils import checkpoint as jckpt
from disentangled_multimodal_learning_tpu_torch import inference
from disentangled_multimodal_learning_tpu_torch import main as tmain
from disentangled_multimodal_learning_tpu_torch.config import Config
from make_jax_checkpoint_fixture import (NAME, SETTINGS, eval_logits,
                                         fold_datasets, jax_config)

DATA = Path(__file__).resolve().parent / "data"
CKPT = DATA / f"{NAME}.ckpt"
JAX_TOL, LOGITS_TOL, LOSS_TOL = 1e-6, 1e-4, 2e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stored():
    with np.load(DATA / f"{NAME}.npz") as z:
        return {k: z[k] for k in z.files}


def test_fixture_holds_its_settings(stored):
    assert json.loads(str(stored["settings"])) == SETTINGS
    assert int(stored["seed"]) == SETTINGS["seed"]
    assert CKPT.stat().st_size <= 2 * 2 ** 20


def test_jax_reproduces_the_stored_logits(monkeypatch, stored):
    for mod, names in ((jda, ("CPB_REMAT", "CPB_TABLE_DIVISOR",
                              "FUSED_TABLE_ATTENTION", "ATTN_BF16_STREAMS")),
                       (jpda, ("TBL_BF16_OUT",))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(jda, "resolve_attn_layout", lambda layout: "kn")
    cfg = jax_config()
    state = jckpt.restore_state(TrainState(None, None, None, 0), str(CKPT))
    assert int(state.step) == 3
    got = eval_logits(jdefine_net(cfg), cfg, state, fold_datasets(cfg)[1])
    assert set(got) == {"logits_tea10", "logits_tea20", "logits_teas"}
    for k, v in got.items():
        np.testing.assert_allclose(v, stored[k], atol=JAX_TOL, rtol=0,
                                   err_msg=k)


def _port_config(**over):
    return Config.diag2021().replace(**SETTINGS, synthetic_data=True,
                                     debug=True, **over)


def test_port_serves_and_resumes_the_fixture(tmp_path, capsys, stored):
    _, logits = inference.main(_port_config(), checkpoint=str(CKPT),
                               device="cpu")
    assert set(logits) == {"logits_tea10", "logits_tea20", "logits_teas"}
    for k, v in logits.items():
        np.testing.assert_allclose(v, stored[k], atol=LOGITS_TOL, rtol=0,
                                   err_msg=k)
    latest = tmp_path / "teacher_fold_1_latest.ckpt"
    shutil.copy(CKPT, latest)
    capsys.readouterr()
    final = tmain.main(_port_config(resume=True, checkpoints=str(tmp_path)),
                       device="cpu")[0]
    assert (f"[resume] {latest}: step 3 -> starting at epoch 3"
            in capsys.readouterr().out)
    losses = final["train_losses"]
    assert len(losses) == len(stored["losses"]) == 2
    for got, want in zip(losses, stored["losses"]):
        assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)


def test_port_reads_the_fixture_without_jax():
    """A fresh interpreter serves the JAX fold through the port's serving
    entry on the CPU and never loads jax, jaxlib, flax or optax; no file
    of the port or ``chip_smoke.py`` imports them or the JAX package."""
    repo = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "from disentangled_multimodal_learning_tpu_torch import inference\n"
        "from disentangled_multimodal_learning_tpu_torch.config import Config\n"
        f"s = {SETTINGS!r}\n"
        "cfg = Config.diag2021().replace(**s, synthetic_data=True, debug=True)\n"
        "inference.main(cfg, checkpoint=sys.argv[1], device='cpu')\n"
        "print('HEAVY', [m for m in ('jax', 'jaxlib', 'flax', 'optax')"
        " if m in sys.modules])\n")
    proc = subprocess.run([sys.executable, "-c", code, str(CKPT)],
                          capture_output=True, text=True, cwd=repo,
                          env=dict(os.environ, PYTHONPATH=str(repo),
                                   OMP_NUM_THREADS="1"), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "HEAVY []" in proc.stdout
    files = [repo / "chip_smoke.py",
             *(repo / "disentangled_multimodal_learning_tpu_torch").rglob(
                 "*.py")]
    heavy = ("jax", "jaxlib", "flax", "optax",
             "disentangled_multimodal_learning_tpu")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in heavy, (f, name)
