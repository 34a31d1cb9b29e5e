"""The process group, the rank layout and the collectives of training over
several processes (counterpart of
``disentangled_multimodal_learning_tpu/parallel/mesh.py`` and of the
rendezvous of the root ``main.py:146-170``).

JAX runs one controller over a mesh of devices; the port runs one process
per rank, each on its own ``torch.device`` (``cuda:<rank % local cards>``
on the card, the CPU otherwise), joined by a ``torch.distributed`` process
group: NCCL on the card, gloo on the CPU (:func:`init_process_group`).  The
ranks form a 2-D layout ``(data, inner)`` as JAX's meshes do (rank ``r`` =
``d * inner + i``): the ``data`` axis splits the global batch into
contiguous row blocks, as JAX's ``P("data")`` shards it, and the inner axis
is the token axis (``seq``), the attention heads (``model``), the two
magnifications (``scale``) or the pipeline's two stages (``stage``).

Every rank reads the same global batch and keeps its rows.  What JAX's jit
gets from the global view, the port does by hand: the terms of the loss
that mix rows (weighted CE's denominator, the Gram losses, distillation's
batch means) see every row because the step gathers the model's outputs
over the data axis and computes the loss of the whole batch on every rank
(:func:`backward_from_rows`: the gathered outputs are leaves, each rank
back-propagates its own rows' share of their gradient); BatchNorm's
statistics (:func:`batch_moments`) and the Nystrom pinv's maxima
(:func:`global_max`) are reduced over the data axis inside the model; and
one all-reduce of the flat gradient over every rank (:func:`sum_grads`) is
JAX's ``psum``.  The collectives that carry gradients inside a model are
``torch.autograd.Function``s whose backward is their adjoint (an all-reduce
of a sum is an all-reduce of its cotangent), and every rank of a group runs
the same graph, so their backward collectives meet in the same order.  Only
``all_reduce`` and ``broadcast`` are used: they are what gloo offers on CUDA
tensors, and a gather is an all-reduce of zero-padded blocks (exact: each
entry adds zeros).  bf16 and f16 tensors cross in f32.

The modules read the layout of the running step through :func:`current`
(None outside a sharded step, so evaluation, which rank 0 runs alone on
its full copy of the model, is plain single-process code).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

# the rendezvous of JAX's root main.py:146-170
ENV_COORDINATOR = "DMLT_COORDINATOR"
ENV_NUM_PROCESSES = "DMLT_NUM_PROCESSES"
ENV_PROCESS_ID = "DMLT_PROCESS_ID"
_LOW = (torch.bfloat16, torch.float16)


def wants_process_group(cfg) -> bool:
    """A run joins a process group when ``nodes > 1`` (JAX's condition) or
    when ``DMLT_COORDINATOR`` names a rendezvous (so that a group of one
    rank can be asked for)."""
    return int(cfg.nodes) > 1 or bool(os.environ.get(ENV_COORDINATOR))


def init_process_group(nodes: int = 1, device="cuda",
                       backend: str | None = None) -> torch.device:
    """Join the process group that ``DMLT_COORDINATOR=<host:port>``,
    ``DMLT_NUM_PROCESSES`` (default ``nodes``) and ``DMLT_PROCESS_ID``
    (default 0) name; returns this rank's device: ``cuda:<rank % local
    cards>`` where ``device`` is a CUDA device, else ``device``.  The
    backend is NCCL on the card and gloo on the CPU unless ``backend`` says
    otherwise (two ranks that share one card need gloo: NCCL refuses
    them)."""
    coordinator = os.environ.get(ENV_COORDINATOR, "")
    if not coordinator:
        raise ValueError(f"a process group needs {ENV_COORDINATOR}=<host:port>"
                         " (with DMLT_NUM_PROCESSES and DMLT_PROCESS_ID)")
    world = int(os.environ.get(ENV_NUM_PROCESSES, nodes))
    rank = int(os.environ.get(ENV_PROCESS_ID, "0"))
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=world, rank=rank)
    print(f"[parallel] process {rank} / {world} ({backend}) on {device}")
    return device


def leave_process_group() -> None:
    """Leave the process group (and forget its subgroups)."""
    _GROUPS.clear()
    dist.destroy_process_group()


def in_group() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def world_rank() -> tuple[int, int]:
    """``(world size, rank)`` of the process group, ``(1, 0)`` without one."""
    if in_group():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


_GROUPS: dict = {}


def _group(ranks):
    """The process group of ``ranks``, made once (every process makes every
    group, in the same order, as ``new_group`` requires)."""
    key = tuple(ranks)
    if key not in _GROUPS:
        _GROUPS[key] = (dist.group.WORLD if len(key) == dist.get_world_size()
                        else dist.new_group(list(key)))
    return _GROUPS[key]


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in a ``(dp, inner)`` layout of ``kind`` (``data``,
    ``seq``, ``model``, ``scale`` or ``stage``): its data and inner indices
    and groups, the group of every rank in the layout (the gradient's
    all-reduce), and the group the Nystrom pinv takes its maxima over (the
    data group, or None where each data group keeps its own, as JAX's
    ``seq_shard_dp`` mesh does).  A rank past ``dp * inner`` is ``idle``."""

    kind: str
    dp: int
    inner: int
    rank: int
    data_index: int = 0
    inner_index: int = 0
    data_group: object = None
    inner_group: object = None
    mesh_group: object = None
    pinv_group: object = None
    idle: bool = False

    @property
    def size(self) -> int:
        return self.dp * self.inner

    def rows(self, batch: int) -> tuple[int, int]:
        """``(offset, count)`` of this rank's rows of a global batch."""
        b = batch // self.dp
        return self.data_index * b, b


def make_layout(kind: str, dp: int, inner: int,
                pinv_local: bool = False) -> Layout:
    """The layout of this rank (every rank calls it, in the same order)."""
    world, rank = world_rank()
    n = dp * inner
    if n > world:
        raise ValueError(f"a {dp} x {inner} {kind} layout needs {n} "
                         f"processes, the group has {world}")
    data = [_group([d * inner + i for d in range(dp)]) for i in range(inner)]
    inner_groups = [_group([d * inner + i for i in range(inner)])
                    for d in range(dp)]
    mesh_group = _group(range(n))
    if rank >= n:
        return Layout(kind, dp, inner, rank, idle=True)
    d, i = divmod(rank, inner)
    return Layout(kind, dp, inner, rank, d, i, data[i], inner_groups[d],
                  mesh_group, None if pinv_local or dp == 1 else data[i])


def choose_layout(cfg, has_teacher: bool = False) -> Layout | None:
    """JAX's choice (``train/trainers.py:68-118``) over this group's ranks,
    in its order: the pipeline (distillation with a teacher, ``pipe_devices
    > 1``), tensor parallelism (``tp_devices > 1``), the scale branches
    (``branch_devices > 1``, the two-scale modes), TransMIL's token axis
    (``seq_shard_devices > 1``), else data parallelism over every rank;
    each halving the data axis until the batch (and, for the pipeline, its
    per-rank rows into ``pipe_microbatches``) divides.  Where the batch does
    not divide over the ranks, it warns as JAX does and returns None: every
    rank runs the whole batch."""
    world, _ = world_rank()
    B = int(cfg.batch_size)
    micro = max(1, int(cfg.pipe_microbatches or 1))

    def halve(dp, ok):
        while dp > 1 and not ok(dp):
            dp //= 2
        return max(1, dp)

    if (cfg.pipe_devices > 1 and world >= 2 and cfg.mode == "distillation"
            and has_teacher and B % micro == 0):
        dp = halve(world // 2, lambda d: B % d == 0 and (B // d) % micro == 0)
        return make_layout("stage", dp, 2)
    if cfg.tp_devices > 1 and world >= cfg.tp_devices:
        dp = halve(world // cfg.tp_devices, lambda d: B % d == 0)
        return make_layout("model", dp, cfg.tp_devices)
    two_scale = ("teacher", "uniteacher", "student", "multiscale")
    if cfg.branch_devices > 1 and world >= 2 and cfg.mode in two_scale:
        dp = halve(world // 2, lambda d: B % d == 0)
        return make_layout("scale", dp, 2)
    if cfg.mode == "transmil" and cfg.seq_shard_devices > 1:
        seq = cfg.seq_shard_devices
        dp = cfg.seq_shard_dp or max(1, world // seq)
        if B % dp:
            raise ValueError(f"batch {B} must divide over the {dp}-way "
                             "data axis")
        # with seq_shard_dp JAX's pinv runs inside shard_map on the rows of
        # one data group (parallel/seq_shard.py:125-133)
        return make_layout("seq", dp, seq, pinv_local=bool(cfg.seq_shard_dp))
    if B % world:
        warnings.warn(
            f"batch_size={B} is not divisible by the {world} processes; "
            "every process runs the whole batch. Set batch_size to a "
            "multiple of the process count to split it.", stacklevel=2)
        return None
    return make_layout("data", world, 1)


# ---------------------------------------------------------------- the step

@dataclasses.dataclass(frozen=True)
class _Active:
    layout: Layout
    offset: int
    total: int


_ACTIVE: list = []


@contextlib.contextmanager
def active(layout: Layout, offset: int, total: int):
    """Run the enclosed forward as this rank's share of a ``total``-row
    global batch whose rows ``[offset, offset + local rows)`` it holds."""
    _ACTIVE.append(_Active(layout, offset, total))
    try:
        yield
    finally:
        _ACTIVE.pop()


def current():
    """The running step's ``_Active`` record (``layout``, ``offset``,
    ``total``), None outside a sharded step."""
    return _ACTIVE[-1] if _ACTIVE else None


def batch_group():
    """The data group whose rows BatchNorm's statistics span, or None."""
    a = current()
    return a.layout.data_group if a and a.layout.dp > 1 else None


def inner_group(kind: str):
    """The inner group of a running ``kind`` layout of more than one rank."""
    a = current()
    if a and a.layout.kind == kind and a.layout.inner > 1:
        return a.layout.inner_group
    return None


def global_rows(b: int) -> tuple[int, int]:
    """``(offset, total)`` of the ``b`` rows a forward holds."""
    a = current()
    return (a.offset, a.total) if a else (0, b)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` (bf16 and f16 in f32)."""
    if t.dtype in _LOW:
        buf = t.float()
        dist.all_reduce(buf, op, group=group)
        t.copy_(buf)
    else:
        dist.all_reduce(t, op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In-place broadcast of global rank ``src``'s ``t`` over ``group``
    (bf16 and f16 in f32)."""
    if t.dtype in _LOW:
        buf = t.float()
        dist.broadcast(buf, src, group=group)
        t.copy_(buf)
    else:
        dist.broadcast(t, src, group=group)
    return t


def gather_rows(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The blocks of ``t`` of every rank of ``group`` in rank order along
    ``dim`` (no gradient): an all-reduce of zero-padded blocks."""
    n = group_size(group)
    if n == 1:
        return t
    shape = list(t.shape)
    size = shape[dim]
    shape[dim] = size * n
    full = t.new_zeros(shape)
    full.narrow(dim, group_rank(group) * size, size).copy_(t)
    return all_reduce_(full, group)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return gather_rows(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        own = g.narrow(ctx.dim, group_rank(ctx.group) * ctx.size, ctx.size)
        return own.contiguous(), None, None


class _Max(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        m = all_reduce_(x.max().reshape(1).clone(), group,
                        dist.ReduceOp.MAX)
        mask = x == m
        ties = all_reduce_(mask.sum().to(x.dtype).reshape(1), group)
        ctx.group = group
        ctx.save_for_backward(mask, ties)
        return m[0]

    @staticmethod
    def backward(ctx, g):
        mask, ties = ctx.saved_tensors
        g = all_reduce_(g.reshape(1).clone(), ctx.group)
        return mask.to(g.dtype) * (g / ties), None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable."""
    return x if group_size(group) == 1 else _Sum.apply(x, group)


def gather_over(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` along ``dim`` in rank order, differentiable (the
    backward hands each rank its block of the summed cotangent)."""
    return x if group_size(group) == 1 else _Gather.apply(x, dim, group)


def global_max(x: torch.Tensor, group) -> torch.Tensor:
    """The max of ``x`` over every rank of ``group``, differentiable as
    ``x.max()`` is: the cotangent is split evenly among the tied maxima of
    all ranks."""
    return x.max() if group_size(group) == 1 else _Max.apply(x, group)


def batch_moments(x: torch.Tensor, group) -> tuple:
    """The mean and biased variance of ``x [b, C]`` over the rows of every
    rank of ``group`` (equal row counts), differentiable."""
    n = x.shape[0] * group_size(group)
    mean = sum_over(x.sum(dim=0), group) / n
    var = sum_over(((x - mean) ** 2).sum(dim=0), group) / n
    return mean, var


def backward_from_rows(out, loss_fn, layout: Layout):
    """``loss_fn(gathered out)`` on the whole global batch, and this rank's
    share of its backward: every tensor of ``out`` (this rank's rows,
    leading axis) is gathered over the data group as a leaf, ``loss_fn``
    returns ``(loss, ...)``, and each rank back-propagates its own rows'
    block of the leaves' gradient into ``out``, divided by the ranks of its
    inner group that hold the same rows (so that the all-reduce of the
    gradient over every rank counts each row once).  Returns ``loss_fn``'s
    result."""
    flat, spec = pytree.tree_flatten(out)
    seen, roots, leaves = {}, [], []
    for t in flat:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            g = gather_rows(t.detach(), layout.data_group)
            g = g.detach().requires_grad_(t.requires_grad)
            seen[id(t)] = g
            if t.requires_grad:
                roots.append(t)
                leaves.append(g)
    result = loss_fn(pytree.tree_unflatten(
        [seen[id(t)] if isinstance(t, torch.Tensor) else t for t in flat],
        spec))
    grads = torch.autograd.grad(result[0], leaves, allow_unused=True)
    share = 1.0 / layout.inner if layout.kind in ("seq", "model") else 1.0
    pairs = [(t, (g.narrow(0, layout.data_index * t.shape[0], t.shape[0])
                  * share))
             for t, g in zip(roots, grads) if g is not None]
    if pairs:
        torch.autograd.backward([t for t, _ in pairs], [c for _, c in pairs])
    return result


def slice_rows(tensors: dict, offset: int, count: int) -> dict:
    """Rows ``[offset, offset + count)`` of every tensor of ``tensors``."""
    return {k: v.narrow(0, offset, count) for k, v in tensors.items()}


def sum_grads(params, layout: Layout) -> None:
    """One all-reduce of the flat gradient of ``params`` over every rank
    of ``layout`` (JAX's ``psum`` of the gradient)."""
    params = list(params)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_(flat, layout.mesh_group)
    i = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[i:i + n].view_as(p.grad))
        i += n


@torch.no_grad()
def broadcast_state(model: torch.nn.Module, layout: Layout) -> None:
    """Rank 0's parameters and buffers on every rank of ``layout``."""
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=0, group=layout.mesh_group)
