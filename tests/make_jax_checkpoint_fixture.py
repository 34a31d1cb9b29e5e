"""Write ``tests/data/jax_teacher_fold.ckpt`` and ``jax_teacher_fold.npz``:
a teacher fold that the JAX package trained and saved with its own
``save_checkpoint``, and what JAX computes from it.

    JAX_PLATFORMS=cpu python tests/make_jax_checkpoint_fixture.py [OUT_DIR]

The fold: the teacher at fixdim 2,500 with the divisor-1 table CPB and f32
attention streams, under ``deterministic_training``, its synthetic fold 0
(``SETTINGS["seed"]``: 4 train bags, one batch of 4 an epoch) trained 3
epochs by JAX's ``make_train_step`` under AdamW and the preset's cosine
schedule over 5 epochs, and saved as the rolling checkpoint of epoch 3
(``teacher_fold_1_latest``'s payload; step 3).  JAX's attention runs in the
"kn" layout, the one that takes the table CPB (on the CPU its "auto" means
"nk").  The init is JAX's ``init_model_state`` with every bias moved by
N(0, 0.02): a zero CPB bias puts the divisor-1 table's centre relu input at
exactly 0, where JAX's ``maximum`` splits the gradient and torch's relu
does not.

Cut to fit the file in 2 MB (params and AdamW's two moments, f32): the
model width (``path_dim``, ``omic_dim``, ``mmhid``) 128 -> 16.  Kept at the
preset's: fixdim 2,500, the 1,024-d patch features, 59 + 361 genes, 8 heads
of 64, the CPB and its table, B = 4.

The npz holds ``settings`` (JSON: the port's ``Config`` keys over
``Config.diag2021()``), ``seed``, JAX's eval logits on the fold-0 test set
(4 bags from ``seed + 100``, one batch: ``logits_tea10``, ``logits_tea20``,
``logits_teas``), and ``losses``, JAX's losses of the next 2 steps from the
file (epochs 4 and 5 of the fold).  The port's serving entry with
``--checkpoint`` and its training entry with ``resume`` reproduce them
(``tests/test_torch_jax_fixture.py``, ``chip_smoke.py`` phase 3n/5n).
"""

from __future__ import annotations

import json
import os
import sys

import jax
import numpy as np

from disentangled_multimodal_learning_tpu import config as jconfig
from disentangled_multimodal_learning_tpu.data.loader import BagLoader
from disentangled_multimodal_learning_tpu.data.synthetic import (
    SyntheticBagDataset)
from disentangled_multimodal_learning_tpu.models import deform_attention
from disentangled_multimodal_learning_tpu.models.factory import define_net
from disentangled_multimodal_learning_tpu.train import optim, trainers
from disentangled_multimodal_learning_tpu.train.steps import (
    batch_to_arrays, make_eval_step, make_train_step)
from disentangled_multimodal_learning_tpu.utils import checkpoint

NAME = "jax_teacher_fold"
SETTINGS = dict(
    mode="teacher", task_type="diag2021", fixdim=2500, batch_size=4,
    epochs=5, lr=2e-4, lr_policy="cosine", optimizer="adamw",
    weight_decay=0.01, gradient_modulate=True, multiscale_attention=True,
    deterministic_training=True, cpb_table_divisor=1,
    attn_bf16_streams=False, synthetic_train_size=4, synthetic_test_size=4,
    eval_every_iters=100, kfold=1, seed=7,
    path_dim=16, omic_dim=16, mmhid=16)  # the cut: 128 -> 16
TRAINED, CONTINUED = 3, 2  # epochs of one step each


def jax_config(**over):
    return jconfig.Config(**{**SETTINGS, **over}).validate()


def fold_datasets(cfg):
    """JAX's synthetic fold 0 (root ``main.py _synthetic_fold_datasets``)
    and its loaders (``_make_loaders``, unbucketed)."""
    train = SyntheticBagDataset(size=cfg.synthetic_train_size,
                                fixdim=cfg.fixdim, label_dim=cfg.label_dim,
                                seed=cfg.seed, args=cfg)
    test = SyntheticBagDataset(size=cfg.synthetic_test_size,
                               fixdim=cfg.fixdim, label_dim=cfg.label_dim,
                               seed=cfg.seed + 100, args=cfg)
    return (BagLoader(train, cfg.batch_size, shuffle=True, drop_last=True,
                      seed=cfg.seed),
            BagLoader(test, cfg.batch_size, shuffle=False, drop_last=False))


def eval_logits(model, cfg, state, loader) -> dict:
    step = jax.jit(make_eval_step(model, cfg, need_attention=False))
    outs = [jax.device_get(step(state.params, state.batch_stats,
                                batch_to_arrays(b))[2]) for b in loader]
    return {k: np.concatenate([np.asarray(o[k]) for o in outs])
            for k in outs[0]}


def main(out_dir: str) -> None:
    deform_attention.resolve_attn_layout = lambda layout: "kn"
    cfg = jax_config()
    train, test = fold_datasets(cfg)
    model = define_net(cfg)
    tx = optim.make_optimizer(cfg, len(train))
    state = trainers.init_model_state(model, cfg, next(iter(train)), tx)
    rng = np.random.default_rng(cfg.seed)
    state = state.replace(params=jax.tree_util.tree_map_with_path(
        lambda path, v: v + rng.normal(0, 0.02, v.shape).astype(np.float32)
        if "bias" in str(path[-1]) else v, state.params))
    step = jax.jit(make_train_step(model, cfg, tx))

    def epoch(state, e):
        train.set_epoch(e)
        losses = []
        for batch in train:
            state, m = step(state, batch_to_arrays(batch),
                            jax.random.PRNGKey(e))
            losses.append(float(m["loss"]))
        return state, losses

    for e in range(TRAINED):
        state, _ = epoch(state, e)
    path = checkpoint.save_checkpoint(out_dir, NAME, state, extra={
        "mode": cfg.mode, "task": cfg.task_type, "fold": 0,
        "epoch": TRAINED})
    state = checkpoint.restore_state(state, path)
    logits = eval_logits(model, cfg, state, test)
    losses = []
    for e in range(TRAINED, TRAINED + CONTINUED):
        state, more = epoch(state, e)
        losses += more
    np.savez(os.path.join(out_dir, NAME + ".npz"),
             settings=json.dumps(SETTINGS), seed=cfg.seed,
             losses=np.asarray(losses, np.float64), **logits)
    print(f"{path}: {os.path.getsize(path)} bytes; losses {losses}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data"))
