"""Checkpoints that the JAX package wrote with its pickle backend (``.ckpt``:
JAX ``utils/checkpoint.py`` ``save_checkpoint`` :43), read without JAX,
flax or optax.

Such a file is one pickle of ``{"params", "opt_state", "batch_stats",
"step", "extra"}`` whose leaves are numpy arrays; ``opt_state`` is an optax
state, a tree of optax's NamedTuples.  :func:`read_jax_checkpoint` unpickles
it with a reader that builds only numpy arrays, dtypes and scalars (under
numpy 2's ``numpy._core`` and numpy 1's ``numpy.core`` names alike), flax's
``FrozenDict`` (as a ``dict``) and the optax states below (as this module's
stand-ins with optax's fields); any other global raises
``pickle.UnpicklingError`` naming it, before anything of it runs.  So the
file gives what ``torch.load(..., weights_only=True)`` gives for a ``.pt``.

:func:`jax_payload` turns it into the payload of the port's own
checkpoints (``utils/checkpoint.py``) for the model of a mode:

- ``params`` and ``batch_stats`` through ``utils/jax_params.jax_state_dict``
  (a ``stacked_scales`` tree is unstacked there); distillation's student
  maps as ``student``, and a file of another mode is refused, naming both;
- ``jax_opt_state``: the optimizer's state by the model's parameter names,
  the moment trees carried by the same map (a pure rearrangement, so it
  carries them as it carries the params; moments of members the port does
  not build are dropped with their params): ``ScaleByAdamState`` ``mu`` /
  ``nu`` / ``count`` -> Adam's and AdamW's ``exp_avg`` / ``exp_avg_sq`` /
  ``step``; ``TraceState`` ``trace`` -> SGD's ``momentum_buffer``;
  ``ScaleByRssState`` ``sum_of_squares`` -> ``OptaxAdagrad``'s ``sum``;
  ``ScaleByScheduleState`` ``count``, the schedule's position; under
  ``plateau``, the injected ``learning_rate``.  Each state is found by its
  type, wherever it sits in the chain (``adam`` puts an ``EmptyState``
  first);
- ``step`` and ``extra`` as they are.

:func:`load_optimizer_state` puts ``jax_opt_state`` into a torch optimizer
and its ``LambdaLR``, where ``restore_state`` has the model: the first
update after it uses the lr that optax uses at that count, and Adam's bias
correction goes on from the restored count.  The plateau watcher's own
state (best, bad epochs, scale) is not in the file: the port's restarts,
as JAX's does, and the injected lr holds until its first decision.
"""

from __future__ import annotations

import importlib
import pickle
from typing import Any, NamedTuple

import numpy as np
import torch

from ..train.optim import OptaxAdagrad, hold_learning_rate
from .jax_params import jax_state_dict


# optax's state NamedTuples (optax 0.2.6's module paths and fields)
class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: Any


class EmptyState(NamedTuple):
    pass


class TraceState(NamedTuple):
    trace: Any


class ScaleByRssState(NamedTuple):
    sum_of_squares: Any


class InjectHyperparamsState(NamedTuple):
    count: Any
    hyperparams: Any
    inner_state: Any


class InjectStatefulHyperparamsState(NamedTuple):
    count: Any
    hyperparams: Any
    hyperparams_states: Any
    inner_state: Any


_OPTAX = {
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.transform", "ScaleByScheduleState"): ScaleByScheduleState,
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax.transforms._accumulation", "TraceState"): TraceState,
    ("optax._src.transform", "ScaleByRssState"): ScaleByRssState,
    ("optax.schedules._inject", "InjectHyperparamsState"):
        InjectHyperparamsState,
    ("optax.schedules._inject", "InjectStatefulHyperparamsState"):
        InjectStatefulHyperparamsState,
}
_INJECTED = (InjectHyperparamsState, InjectStatefulHyperparamsState)
# numpy's reconstructors: (submodule of numpy._core / numpy.core, name)
_NUMPY_CORE = {("multiarray", "_reconstruct"), ("multiarray", "scalar"),
               ("numeric", "_frombuffer")}
_NUMPY = {"dtype": np.dtype, "ndarray": np.ndarray}
_FROZEN_DICT = ("flax.core.frozen_dict", "FrozenDict")


def _numpy_core(sub: str, name: str):
    """``name`` of the running numpy's ``_core.<sub>`` (numpy 2) or
    ``core.<sub>`` (numpy 1), whichever the file named."""
    for base in ("numpy._core", "numpy.core"):
        try:
            return getattr(importlib.import_module(f"{base}.{sub}"), name)
        except (ImportError, AttributeError):
            continue
    raise pickle.UnpicklingError(f"numpy has no {sub}.{name}")


class _Reader(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _OPTAX:
            return _OPTAX[module, name]
        if (module, name) == _FROZEN_DICT:
            return dict
        if module == "numpy" and name in _NUMPY:
            return _NUMPY[name]
        for base in ("numpy._core.", "numpy.core."):
            sub = module[len(base):]
            if module.startswith(base) and (sub, name) in _NUMPY_CORE:
                return _numpy_core(sub, name)
        raise pickle.UnpicklingError(
            f"{module}.{name} is not allowed in a JAX checkpoint: the reader "
            "builds only numpy arrays, flax's FrozenDict and optax's states")


def read_jax_checkpoint(path: str) -> dict:
    """The pickle of a JAX ``.ckpt``, its optax states as this module's
    stand-ins; any other global raises ``pickle.UnpicklingError``."""
    with open(path, "rb") as f:
        return _Reader(f).load()


def tree_mode(mode: str) -> str:
    """The mode whose param tree ``mode`` trains (distillation: the
    student's)."""
    return "student" if mode == "distillation" else mode


def _states(state):
    """Every optax state in ``state`` (a chain is a tuple of them; an
    injected-hyperparams state holds its chain)."""
    if isinstance(state, tuple(set(_OPTAX.values()))):
        yield state
        if isinstance(state, _INJECTED):
            yield from _states(state.inner_state)
    elif isinstance(state, (tuple, list)):
        for s in state:
            yield from _states(s)


def optimizer_state(opt_state, mode: str, attn_dim: int = 2) -> dict | None:
    """An optax state of ``mode``'s param tree -> ``{"kind": "adam" | "sgd"
    | "adagrad" | None, "count", "moments": {name: {torch state key:
    array}}, "schedule_count", "learning_rate"}`` (None where there is no
    state)."""
    if opt_state is None:
        return None
    out = {"kind": None, "count": None, "moments": {},
           "schedule_count": None, "learning_rate": None}
    trees = {}
    for s in _states(opt_state):
        if isinstance(s, ScaleByAdamState):
            out["kind"], out["count"] = "adam", int(s.count)
            trees = {"exp_avg": s.mu, "exp_avg_sq": s.nu}
        elif isinstance(s, TraceState):
            out["kind"], trees = "sgd", {"momentum_buffer": s.trace}
        elif isinstance(s, ScaleByRssState):
            out["kind"], trees = "adagrad", {"sum": s.sum_of_squares}
        elif isinstance(s, ScaleByScheduleState):
            out["schedule_count"] = int(s.count)
        elif isinstance(s, _INJECTED):
            out["learning_rate"] = float(s.hyperparams["learning_rate"])
            out["schedule_count"] = int(s.count)
    for key, tree in trees.items():
        for name, v in jax_state_dict(tree, mode, attn_dim).items():
            out["moments"].setdefault(name, {})[key] = v
    return out


def jax_payload(raw: dict, mode: str | None = None,
                attn_dim: int = 2) -> dict:
    """The pickle of a JAX ``.ckpt`` -> the port's checkpoint payload for
    the model of ``mode`` (default: the mode the file names); a file of
    another mode raises ``ValueError`` naming both."""
    extra = dict(raw.get("extra") or {})
    written = extra.get("mode")
    mode = mode or written
    if mode is None:
        raise ValueError("the JAX checkpoint names no mode: give the mode "
                         "of the model it is for")
    if written is not None and tree_mode(written) != tree_mode(mode):
        raise ValueError(f"the JAX checkpoint was written by mode "
                         f"{written!r}, not by {mode!r}")
    tmode = tree_mode(mode)
    params = jax_state_dict(raw["params"], tmode, attn_dim,
                            raw.get("batch_stats"))
    return {"params": {k: torch.from_numpy(np.array(v, np.float32))
                       for k, v in params.items()},
            "opt_state": None, "scheduler": None,
            "jax_opt_state": optimizer_state(raw.get("opt_state"), tmode,
                                             attn_dim),
            "step": int(raw.get("step", 0)), "extra": extra}


_OPTIMIZERS = {"adam": (torch.optim.Adam, torch.optim.AdamW),
               "sgd": (torch.optim.SGD,), "adagrad": (OptaxAdagrad,)}


def load_optimizer_state(model, optimizer, scheduler, state: dict) -> None:
    """Put a payload's ``jax_opt_state`` into ``optimizer`` (built over
    ``model.parameters()``) and its ``scheduler``."""
    kind = state["kind"]
    if kind is not None:
        if not isinstance(optimizer, _OPTIMIZERS[kind]):
            raise ValueError(f"the JAX checkpoint holds {kind} state; the "
                             f"optimizer is {type(optimizer).__name__}")
        for name, p in model.named_parameters():
            if name not in state["moments"]:
                raise KeyError(f"the JAX checkpoint's {kind} state has no "
                               f"moments for {name}")
            st = {k: torch.from_numpy(np.array(v, np.float32)).to(p.device)
                  for k, v in state["moments"][name].items()}
            if kind == "adam":
                st["step"] = torch.tensor(float(state["count"]))
            optimizer.state[p] = st
    count = state["schedule_count"]
    if scheduler is not None and count is not None:
        scheduler.last_epoch = count
        lrs = [base * fn(count) for base, fn in
               zip(scheduler.base_lrs, scheduler.lr_lambdas)]
        for group, lr in zip(optimizer.param_groups, lrs):
            group["lr"] = lr
        scheduler._last_lr = lrs
    if state["learning_rate"] is not None:
        hold_learning_rate(optimizer, scheduler, state["learning_rate"])
