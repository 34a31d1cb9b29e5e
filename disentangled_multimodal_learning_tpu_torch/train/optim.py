"""Optimizers and learning-rate schedules (counterpart of
``disentangled_multimodal_learning_tpu/train/optim.py``): sgd / adam /
adagrad / adamw, each under the linear / exp / step / plateau / cosine /
cosinewithwarmup / onecycle policies (and ``cosine_torchstep``).

The schedule is stepped per iteration, as optax evaluates it at the update
count: :func:`make_scheduler` returns a ``LambdaLR`` over an optimizer built
with base lr 1, so each step's lr is the schedule's value itself.  The
update rules match the optax chains the JAX package builds:

- adamw: decoupled decay scaled by the scheduled lr (``torch.optim.AdamW``);
- adam and sgd (momentum 0.9): L2 decay added to the gradient
  (``weight_decay`` of ``torch.optim.Adam`` / ``SGD``);
- adagrad: :class:`OptaxAdagrad`, optax's rule (accumulator starts at 0.1,
  ``eps`` = 1e-7 inside the square root), with the L2 decay added to the
  gradient first.  torch's Adagrad adds its eps outside the root.

``plateau`` keeps the lr constant and lets :class:`ReduceLROnPlateau`, fed
the mean train loss of each epoch, scale it (:func:`set_learning_rate`); a
restored lr holds until the watcher's first decision
(:func:`hold_learning_rate`), as JAX's injected lr does.

``make_optimizer(..., capturable=True)`` builds the optimizer that the CUDA
graphs of ``scan_steps`` (``train/graph_chunk.py``) replay: its step reads
the lr from a device tensor set into the param group, and Adam and AdamW
keep their step counts on the card (torch's ``capturable=True``);
:class:`CapturableSGD` is SGD's rule written for a tensor lr, and
:class:`OptaxAdagrad` takes one as it is.  The graph steps the schedule K
steps at a time (:func:`scheduled_lrs`, :func:`set_schedule_count`).  The
default optimizers (``scan_steps`` 1, the CPU) are unchanged.
"""

from __future__ import annotations

import math

import torch

ONECYCLE_PEAK = 1e-3  # JAX optim.py:49


def make_schedule(cfg, steps_per_epoch: int, plateau=None):
    """``cfg.lr_policy`` -> ``step -> lr`` (per iteration, from 0)."""
    lr = float(cfg.lr)
    policy = cfg.lr_policy
    epochs = int(cfg.epochs)
    spe = max(1, steps_per_epoch)
    total = max(1, epochs * spe)

    def cosine(peak, decay, step):
        return peak * 0.5 * (1 + math.cos(math.pi * min(step, decay) / decay))

    if policy == "cosine":
        return lambda step: cosine(lr, total, step)
    if policy == "cosine_torchstep":
        def sched(step):
            t = step % (2 * epochs)
            return lr * (1 + math.cos(math.pi * min(t, epochs) / epochs)) / 2
        return sched
    if policy == "cosinewithwarmup":
        warmup = max(1, int(cfg.warmup_epochs) * spe)
        if total - warmup <= 0:
            raise ValueError(f"cosinewithwarmup: {total} steps leave no room "
                             f"for the cosine after {warmup} warmup steps")
        return lambda step: (lr * min(step, warmup) / warmup if step < warmup
                             else cosine(lr, total - warmup, step - warmup))
    if policy == "linear":
        return lambda step: lr * (1 - min(step, total) / total)
    if policy == "exp":
        return lambda step: lr * 0.1 ** (step / spe) if step > 0 else lr
    if policy == "step":
        decay_iters = getattr(cfg, "lr_decay_iters", spe)
        return lambda step: lr * 0.1 ** (step // decay_iters)
    if policy == "onecycle":
        return _onecycle(total)
    if policy == "plateau":
        if plateau is None:
            raise ValueError("lr_policy 'plateau' needs its ReduceLROnPlateau")

        def sched(step):
            held = plateau.held_lr
            return lr * plateau.scale if held is None else held

        sched.plateau = plateau  # for hold_learning_rate
        return sched
    raise NotImplementedError(f"lr policy [{policy}] is not implemented")


def _onecycle(total: int, pct_start: float = 0.3, div_factor: float = 25.0,
              final_div_factor: float = 1e4):
    """optax ``cosine_onecycle_schedule(total, peak_value=1e-3)``: cosine
    from peak/25 up to the peak at 30% of the steps, then down to
    peak/25/1e4."""
    bounds = (0, int(pct_start * total), total)
    values = (ONECYCLE_PEAK / div_factor, ONECYCLE_PEAK,
              ONECYCLE_PEAK / (div_factor * final_div_factor))

    def sched(step):
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2 * (math.cos(math.pi * pct) + 1)
        return values[-1]

    return sched


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.chain(add_decayed_weights(wd), adagrad(lr, 0.1))``:
    ``g += wd * p``, ``acc += g^2``, ``p -= lr * g / sqrt(acc + eps)``."""

    def __init__(self, params, lr=1.0, weight_decay=0.0,
                 initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, dict(
            lr=lr, weight_decay=weight_decay, eps=eps,
            initial_accumulator_value=initial_accumulator_value))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                acc = state["sum"]
                acc.add_(g * g)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                    torch.zeros_like(acc))
                p.sub_(group["lr"] * g * scale)


class CapturableSGD(torch.optim.SGD):
    """torch's SGD rule (momentum, dampening 0, not Nesterov, the L2 decay
    added to the gradient; the momentum buffer starts as the first
    gradient) with the lr allowed to be a tensor on the card: torch's SGD
    adds ``-lr`` as a Python scalar, which reads a tensor lr back to the
    host, and a CUDA graph cannot."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.add(p, alpha=wd) if wd else p.grad
                state = self.state[p]
                buf = state.get("momentum_buffer")
                if buf is None:
                    state["momentum_buffer"] = buf = g.clone()
                else:
                    buf.mul_(group["momentum"]).add_(g)
                p.sub_(buf * lr)


def make_optimizer(cfg, params, capturable: bool = False):
    """``cfg.optimizer`` over ``params`` at base lr 1 (the scheduler sets
    every step's lr); with ``capturable``, the variant that a CUDA graph
    replays (see the module docstring)."""
    name, wd = cfg.optimizer, float(cfg.weight_decay)
    if name == "sgd":
        sgd = CapturableSGD if capturable else torch.optim.SGD
        return sgd(params, lr=1.0, momentum=0.9, weight_decay=wd)
    if name == "adam":
        return torch.optim.Adam(params, lr=1.0, weight_decay=wd,
                                capturable=capturable)
    if name == "adagrad":
        return OptaxAdagrad(params, lr=1.0, weight_decay=wd)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=1.0, weight_decay=wd,
                                 capturable=capturable)
    raise NotImplementedError(f"optimizer [{name}] is not implemented")


def keep_capturable(optimizer, flags) -> None:
    """Give each param group of ``optimizer`` its ``capturable`` flag from
    ``flags`` back (a loaded state dict brings the saver's) and put Adam's
    step counts where the flag wants them: on the parameter's device for a
    capturable group (the graph advances them there), else on the CPU, as
    torch's loader does."""
    for group, flag in zip(optimizer.param_groups, flags):
        if "capturable" not in group:
            continue
        group["capturable"] = flag
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if torch.is_tensor(state.get("step")):
                state["step"] = state["step"].to(
                    p.device if flag else torch.device("cpu"), torch.float32)


def capturable_flags(optimizer) -> list:
    return [group.get("capturable", False)
            for group in optimizer.param_groups]


def make_scheduler(cfg, optimizer, steps_per_epoch: int, plateau=None):
    """Per-iteration ``LambdaLR``: step it after every optimizer step."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, make_schedule(cfg, steps_per_epoch, plateau))


def scheduled_lrs(scheduler, n: int) -> list:
    """The lr of each of the next ``n`` steps: what ``LambdaLR`` would set
    before each of them (one param group)."""
    base, fn = scheduler.base_lrs[0], scheduler.lr_lambdas[0]
    return [base * fn(scheduler.last_epoch + i) for i in range(n)]


def set_schedule_count(scheduler, optimizer, count: int) -> None:
    """Put ``scheduler`` at step ``count`` and the optimizer's lr at that
    step's value, a float, as ``count`` calls of ``scheduler.step()``
    leave them."""
    scheduler.last_epoch = count
    lrs = [base * fn(count) for base, fn in
           zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs


class ReduceLROnPlateau:
    """Host-side metric watcher with torch ``ReduceLROnPlateau`` semantics
    (mode 'min', factor 0.2, relative threshold 0.01, patience 5), fed the
    mean train loss of each epoch; ``step(metric)`` returns the cumulative
    lr scale (the JAX watcher, ``optim.py:53-91``)."""

    def __init__(self, factor: float = 0.2, patience: int = 5,
                 threshold: float = 0.01, mode: str = "min"):
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.mode = mode
        self.best: float | None = None
        self.num_bad = 0
        self.scale = 1.0
        # a restored lr, the schedule's value until the next decision
        self.held_lr: float | None = None

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        self.held_lr = None
        if self._improved(metric):
            self.best = float(metric)
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale *= self.factor
                self.num_bad = 0
        return self.scale


def set_learning_rate(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def hold_learning_rate(optimizer, scheduler, lr: float) -> None:
    """Set a restored ``lr``; under ``plateau`` the ``scheduler`` keeps it
    until its watcher's next decision (a restarted watcher, whose scale is
    1, as JAX keeps a restored injected lr)."""
    set_learning_rate(optimizer, lr)
    plateau = (getattr(scheduler.lr_lambdas[0], "plateau", None)
               if scheduler is not None else None)
    if plateau is not None:
        plateau.held_lr = lr


def current_learning_rate(optimizer) -> float:
    """The lr of ``optimizer``'s next step: the value ``LambdaLR`` or
    :func:`set_learning_rate` last wrote."""
    return float(optimizer.param_groups[0]["lr"])
