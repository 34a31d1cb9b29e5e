"""Cohort evaluation through the serving entry's evaluator, one batch a
timed call, a closed loop of one client.

Set-up builds the configuration's model (``define_net``, the run's weights
loaded over it with ``strict=True``) and ``train/evaluation.py
Evaluator`` over the mode's tags, as ``inference.py``'s ``test*Model``
does, and runs every batch of the pool once (the warm-up).  A timed call
hands the next host batch of the pool to ``Evaluator.step``, which copies
the mode's inputs to the card (``model_inputs``), runs the forward and
brings every tag's logits back to the host.  The evaluator's model is
wrapped to record when its forward returns (before the host waits for the
card), the span that ``host_ms_per_batch`` reads.

Every output of the window is compared with the reference's forward of
its batch, computed once the window has closed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import compare, inputs
from .train_chunks import Marks, host_tensors, port_config


class _Timed:
    """The evaluator's model, with the host clock read when its forward
    returns."""

    def __init__(self, model, marks: list):
        self.model, self.marks = model, marks

    def __call__(self, *args, **kwargs):
        out = self.model(*args, **kwargs)
        self.marks.append(time.perf_counter())
        return out

    def __getattr__(self, name):
        return getattr(self.model, name)


class Session:
    def __init__(self, cell, seed: int, device):
        from disentangled_multimodal_learning_tpu_torch.models.factory import \
            define_net
        from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
            Evaluator, model_type_of)

        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        t = cell.traffic
        self.batch_size = int(t["batch_size"])
        self.bags_per_call = self.batch_size
        self.updates_per_call = 0
        mark = Marks()
        self.phases = mark.phases
        self.pool = inputs.make_pool(cell.settings, int(t["pool_batches"]),
                                     self.batch_size, seed, self.device)
        mark("inputs")
        ref = cell.reference.build(cell.settings, self.device)
        self.state0 = inputs.make_state(ref, seed, self.device)
        del ref
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        mark("weights")

        cfg = port_config(cell, self.device)
        model = define_net(cfg, self.device)
        model.load_state_dict(self.state0, strict=True)
        model.eval()
        self.evaluator = Evaluator(model, cfg, self.device,
                                   model_type_of(cfg.mode))
        self.forward_done: list = []
        self.evaluator.model = _Timed(model, self.forward_done)
        mark("program")
        for batch in self.pool:  # the warm-up
            self.evaluator.step(batch)
        mark("warm-up")
        self.forward_done.clear()
        self.next = 0
        self.outputs = []  # (pool index, tag -> logits) of every call

    def call(self) -> None:
        i = self.next % len(self.pool)
        self.next += 1
        self.outputs.append((i, self.evaluator.step(self.pool[i])))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def failed(self) -> int:
        return sum(not all(np.isfinite(v).all() for v in out.values())
                   for _, out in self.outputs)

    def release(self) -> None:
        self.state0 = {k: v.cpu() for k, v in self.state0.items()}
        del self.evaluator
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def reference_logits(self, tf32: bool = False) -> list:
        """The reference's eval forward of every pool batch: tag ->
        logits, per batch."""
        ref_mod = self.cell.reference
        model = ref_mod.build(self.cell.settings, self.device)
        model.load_state_dict({k: v.to(self.device)
                               for k, v in self.state0.items()}, strict=True)
        model.eval()
        mode = self.cell.settings["mode"]
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            out = []
            for batch in self.pool:
                t = host_tensors(batch, self.device)
                logits = model(*(t[k] for k in ref_mod.INPUTS[mode]))[0]
                out.append({k: v.float().cpu().numpy()
                            for k, v in logits.items()})
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
        del model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def check(self) -> dict:
        self.ref = self.reference_logits()
        worst = max((compare.logit_gap(out, self.ref[i])
                     for i, out in self.outputs), default=float("inf"))
        return {"logit_gap": worst}

    def control(self) -> dict:
        """The reference in the program's place in TF32."""
        ctl = self.reference_logits(tf32=True)
        return {"logit_gap": max(compare.logit_gap(c, r)
                                 for c, r in zip(ctl, self.ref))}

    def faults(self) -> dict:
        return {}


def start(cell, seed: int, device) -> Session:
    return Session(cell, seed, device)
