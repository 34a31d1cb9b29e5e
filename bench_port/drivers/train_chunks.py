"""Training through the trainer's own objects, one ``scan_steps`` chunk a
timed call.

Set-up builds one trainer, as ``train/trainers.py run_training`` does at
``scan_steps`` K: the configuration's model (``define_net``, the run's
weights loaded over it with ``strict=True``), ``make_optimizer`` with
``capturable`` on the card, ``make_scheduler``, ``make_step`` and a
``ChunkRunner``.  The dropout generator is seeded from the run's seed.  The
first chunk runs as K single steps (the trainer's warm-up), the second
through ``ChunkRunner.run``, which captures the chunk's CUDA graph and
replays it; every timed call is one more ``ChunkRunner.run`` over the
next K batches of the pool, each made a step's tensors by
``batch_to_tensors`` as the trainer does.  On the CPU (the tests) there is
no runner, and a chunk is K single steps, as in the trainer.

What is compared, in two stages.  Training is chaotic at this scale: the
atomics of ``grid_sample``'s backward make two runs of one program differ
by 1e-6 at a step's second update, and the gap grows about tenfold a step
(``PERF.md``), so the second stage follows the program from a state it
shares with the reference:

- stage A, the first step from the run's weights and dropout seed: its
  loss, the gradient AdamW took (``grad_gap``) and the update it applied
  (``first_change_gap``);
- stage B, the window's last chunk, a graph replay: before every chunk
  the program's state (parameters, AdamW's moments and step counts, the
  schedule's count, the generators' states) is copied aside on the card;
  the reference starts from the copy made before the last one and runs
  its K steps on its batches.  Compared are the loss of its first step
  and the parameters' change over the chunk, by the median leaf
  (``change_gap``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import compare, inputs

BETA1 = 0.9  # torch AdamW's default, which make_optimizer keeps


class Marks:
    """Set-up phases on the host clock: ``mark(name)`` closes the phase
    that began at the previous mark."""

    def __init__(self):
        self.phases, self.t = {}, time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now


def port_config(cell, device):
    from disentangled_multimodal_learning_tpu_torch.config import Config

    settings = dict(cell.settings)
    settings["scan_steps"] = int(cell.traffic.get("scan_steps", 1))
    settings["checkpoints"] = "#"
    return Config.from_dict(settings).validate()


def host_tensors(batch, device) -> dict:
    """The reference's copy of a host batch (its own, not the port's)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(getattr(batch, k))).to(
        device) for k in ("x_path10", "x_path20", "x_omic_tumor",
                          "x_omic_immune")}
    out["label"] = torch.from_numpy(batch.label).to(device, torch.int64)
    return out


def _cpu(tree):
    return {k: v.detach().cpu() for k, v in tree.items()}


class Session:
    def __init__(self, cell, seed: int, device):
        from disentangled_multimodal_learning_tpu_torch.models.factory import \
            define_net
        from disentangled_multimodal_learning_tpu_torch.train import (
            graph_chunk, optim, steps, trainers)

        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        t = cell.traffic
        self.k = int(t["scan_steps"])
        self.batch_size = int(t["batch_size"])
        self.steps_per_epoch = int(t["steps_per_epoch"])
        self.bags_per_call = self.k * self.batch_size
        self.updates_per_call = self.k
        mark = Marks()
        self.phases = mark.phases
        self.pool = inputs.make_pool(cell.settings, int(t["pool_batches"]),
                                     self.batch_size, seed, self.device)
        if len(self.pool) < 2 * self.k:
            raise ValueError("the pool needs 2 chunks of distinct batches")
        mark("inputs")
        ref = cell.reference.build(cell.settings, self.device)
        self.state0 = inputs.make_state(ref, seed, self.device)
        del ref
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        mark("weights")

        cfg = port_config(cell, self.device)
        self.model = define_net(cfg, self.device)
        self.model.load_state_dict(self.state0, strict=True)
        graphs = self.device.type == "cuda"
        self.optimizer = optim.make_optimizer(cfg, self.model.parameters(),
                                              capturable=graphs)
        self.scheduler = optim.make_scheduler(cfg, self.optimizer,
                                              self.steps_per_epoch)
        self.step_fn, _ = trainers.make_step(cfg, self.model, self.optimizer,
                                             None)
        self.runner = (graph_chunk.ChunkRunner(
            self.step_fn, self.optimizer, self.scheduler, self.k)
            if graphs else None)
        self.to_tensors = steps.batch_to_tensors
        mark("program")

        torch.manual_seed(inputs.streams(seed)["dropout"])
        self.first_loss = None
        for j in range(self.k):  # the first chunk: K single steps
            m = self._single(self.pool[j])
            if j == 0:
                self.first_loss = m["loss"]
                self.first_grad = self._first_moment()
                self.after_first = self._params()
        self.sync()
        mark("first chunk")
        self.losses = []
        self._make_snapshot()
        self.next = self.k
        self.call()  # the second chunk: the graph's capture and replay
        self.sync()
        mark("second chunk")
        self.losses = []

    def _single(self, batch):
        m = self.step_fn(self.to_tensors(batch, self.device))
        self.scheduler.step()
        return m

    def _first_moment(self) -> dict:
        """AdamW's first moment over ``1 - beta1``: after one step, the
        gradient it took (zero where it has no state)."""
        state = self.optimizer.state
        return {n: state[p]["exp_avg"].detach() / (1 - BETA1)
                if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
                for n, p in self.model.named_parameters()}

    def _params(self) -> dict:
        return {n: p.detach().clone() for n, p in
                self.model.named_parameters()}

    def _make_snapshot(self) -> None:
        """Buffers on the card for the trainer's state before a chunk: the
        parameters and, of every parameter that has them, AdamW's moments
        and step count."""
        state = self.optimizer.state
        self.live, names = [], []
        for n, p in self.model.named_parameters():
            self.live.append(p)
            names.append((n, None))
            s = state.get(p, {})
            if "exp_avg" in s:
                self.live += [s["exp_avg"], s["exp_avg_sq"], s["step"]]
                names += [(n, "exp_avg"), (n, "exp_avg_sq"), (n, "step")]
        self.saved = [t.detach().clone() for t in self.live]
        self.saved_names = names
        self.saved_at = None

    def _save(self, first: int) -> None:
        """Copy the state aside before the chunk from pool index
        ``first`` (one multi-tensor copy on the card)."""
        with torch.no_grad():
            torch._foreach_copy_(self.saved, [t.detach() for t in self.live])
        self.saved_at = {
            "first": first, "count": self.scheduler.last_epoch,
            "rng": (torch.get_rng_state(),
                    torch.cuda.get_rng_state(self.device)
                    if self.device.type == "cuda" else None)}

    def _saved_state(self) -> dict:
        """The copy made before the last chunk, on the host."""
        params, moments = {}, {}
        for (n, what), t in zip(self.saved_names, self.saved):
            if what is None:
                params[n] = t.cpu()
            else:
                moments.setdefault(n, {})[what] = t.cpu()
        return {"params": params,
                "moments": {n: (m["exp_avg"], m["exp_avg_sq"],
                                float(m["step"])) for n, m in moments.items()},
                **self.saved_at}

    def _chunk(self, first: int) -> list:
        batches = [self.pool[(first + i) % len(self.pool)]
                   for i in range(self.k)]
        if self.runner is None:
            return [self._single(b) for b in batches]
        tensors = [self.to_tensors(b, self.device) for b in batches]
        return self.runner.run(tuple(tensors[0]["x_path10"].shape), tensors)

    def call(self) -> None:
        self._save(self.next)
        ms = self._chunk(self.next)
        self.next += self.k
        self.recent = [m["loss"] for m in ms]
        self.losses += self.recent

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def failed(self) -> int:
        """Window updates whose loss is not finite."""
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def release(self) -> None:
        """Free the program's state; keep what the comparison reads: the
        first step's loss, gradient and parameters, the state saved before
        the last chunk, and that chunk's losses and parameters after it."""
        self.first_loss = float(self.first_loss)
        self.first_grad = _cpu(self.first_grad)
        self.after_first = _cpu(self.after_first)
        self.before_last = self._saved_state()
        self.last_losses = [float(x) for x in self.recent]
        self.after_last = _cpu(self._params())
        self.state0 = _cpu(self.state0)
        del self.model, self.optimizer, self.scheduler, self.step_fn
        del self.runner, self.losses, self.recent, self.live, self.saved
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference -------------------------------------------------------

    def _trainer(self, params):
        ref_mod = self.cell.reference
        model = ref_mod.build(self.cell.settings, self.device)
        model.load_state_dict({k: v.to(self.device) for k, v in
                               params.items()}, strict=True)
        cw = torch.tensor(self.cell.config["class_weights"],
                          dtype=torch.float32, device=self.device)
        return ref_mod.Trainer(model, self.cell.settings,
                               self.steps_per_epoch, cw)

    def _steps(self, trainer, first: int, n: int, rows) -> list:
        losses = []
        for j in range(first, first + n):
            t = host_tensors(self.pool[j % len(self.pool)], self.device)
            if rows is not None:
                t = {k: v[:rows] for k, v in t.items()}
            losses.append(float(trainer.step(t)))
        return losses

    def reference(self, tf32: bool = False, rows=None) -> dict:
        """Both stages of the reference.  ``tf32``: float32 products in
        TF32 (the control); ``rows``: only the first ``rows`` bags of each
        batch (a planted fault)."""
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            # stage A: the first step from the run's weights
            trainer = self._trainer(self.state0)
            torch.manual_seed(inputs.streams(self.seed)["dropout"])
            loss_a = self._steps(trainer, 0, 1, rows)
            first = {n: trainer.opt.state[p]["exp_avg"].detach().cpu()
                     / (1 - BETA1)
                     for n, p in trainer.model.named_parameters()}
            after_first = _cpu(dict(trainer.model.named_parameters()))
            # stage B: the window's last chunk from the program's own state
            a = self.before_last
            trainer = self._trainer(a["params"])
            for n, p in trainer.model.named_parameters():
                if n not in a["moments"]:  # a leaf the program never moved
                    continue
                m, v, step = a["moments"][n]
                trainer.opt.state[p] = {
                    "step": torch.tensor(step, dtype=torch.float32),
                    "exp_avg": m.to(self.device).clone(),
                    "exp_avg_sq": v.to(self.device).clone()}
            trainer.count = a["count"]
            torch.set_rng_state(a["rng"][0])
            if a["rng"][1] is not None:
                torch.cuda.set_rng_state(a["rng"][1], self.device)
            loss_b = self._steps(trainer, a["first"], self.k, rows)
            params = _cpu(dict(trainer.model.named_parameters()))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
        del trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"loss_a": loss_a, "first_grad": first,
                "params_a": after_first, "loss_b": loss_b, "params_b": params}

    def _program(self) -> dict:
        return {"loss_a": [self.first_loss], "first_grad": self.first_grad,
                "params_a": self.after_first, "loss_b": self.last_losses,
                "params_b": self.after_last}

    def details(self, got: dict, want: dict) -> dict:
        """The compared numbers of ``got`` against ``want`` and, beside
        them, the readings they were chosen over: the gap of every loss of
        the last chunk, the worst leaf's change over it, and where in the
        schedule it began."""
        moving = compare.moving_leaves(want["first_grad"])

        def delta(after, before):
            return {k: v - before[k] for k, v in after.items()}

        base = self.before_last["params"]
        change = delta(got["params_b"], base)
        ref_change = delta(want["params_b"], base)
        return {
            "loss_gap": max(compare.loss_gap(got["loss_a"], want["loss_a"]),
                            compare.loss_gap(got["loss_b"][:1],
                                             want["loss_b"][:1])),
            "grad_gap": compare.leaf_gap(got["first_grad"],
                                         want["first_grad"]),
            "first_change_gap": compare.leaf_gap(
                delta(got["params_a"], self.state0),
                delta(want["params_a"], self.state0), moving),
            "change_gap": compare.median_leaf_gap(change, ref_change, moving),
            "chunk_loss_gaps": [compare.loss_gap([g], [w]) for g, w in
                                zip(got["loss_b"], want["loss_b"])],
            "change_worst_leaf": compare.leaf_gap(change, ref_change, moving),
            "last_chunk_count": self.before_last["count"]}

    def gaps(self, got: dict, want: dict) -> dict:
        d = self.details(got, want)
        return {k: d[k] for k in ("loss_gap", "grad_gap", "first_change_gap",
                                  "change_gap")}

    def check(self) -> dict:
        self.ref = self.reference()
        return self.gaps(self._program(), self.ref)

    def control(self) -> dict:
        """The reference in the program's place in TF32."""
        return self.details(self.reference(tf32=True), self.ref)

    def faults(self) -> dict:
        """Planted in the reference put in the program's place: half of
        each batch left out (the mean over the rest)."""
        return {"half_batch": self.details(
            self.reference(rows=self.batch_size // 2), self.ref)}

    def program_details(self) -> dict:
        return self.details(self._program(), self.ref)


def start(cell, seed: int, device) -> Session:
    return Session(cell, seed, device)
