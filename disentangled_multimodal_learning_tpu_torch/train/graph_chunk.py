"""A full ``scan_steps`` chunk on the card as one CUDA graph of K train
steps (counterpart of JAX ``train/trainers.py:185-197``, ``multi_step``:
``jax.lax.scan`` of the train step over the K stacked batches, one dispatch
a chunk).

The trainer (``train/trainers.py run_training``) runs a bag shape's first
full chunk as K ordinary train steps, which are also the warm-up (the
kernels built, cuBLAS, the allocator and the pinned DPC noise initialised,
the optimizer's state made), and hands every later chunk of that shape to
:class:`ChunkRunner`:

- at its first chunk of a shape, K steps are captured once with
  ``torch.cuda.graph``, step i reading its slice of static ``[K, ...]``
  input buffers and element i of a ``[K]`` lr buffer, in a memory pool of
  that shape's own (JAX retraces per shape); capture runs nothing, so the
  graph is then replayed for that chunk;
- each chunk is copied into the buffers and replayed in one launch; its K
  metric dicts are the graph's outputs, cloned after each replay.

On the CPU and in a process group (``parallel/``: gloo's collectives are
not captured) there is no runner and every chunk runs as K train steps, in
the same order.  The trainer makes the choice from the device and the
layout and prints it; a capture that fails raises.

What capture asks of the step (``train/steps.py``): no read back to the
host (the class weights made on the card once; K6's dropout seed drawn on
the device, ``models/deform_attention.py``); dropout, the student's
density noise and K6's seed drawn from torch's CUDA generator, which each
replay advances; gradients set to None and made anew inside the graph's
pool; an optimizer built with ``capturable`` (``train/optim.py``), whose
lr the step reads from the lr buffer.  The runner, not the step, steps the
schedule, K at a time, so that a checkpoint after a chunk holds the count
that K single steps leave.  A graph's kernels launch with no Python: its
capture's launch counts are taken back out of the wrappers' ``launches``
and added again at each replay (``ops/launches.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import launches
from .optim import scheduled_lrs, set_learning_rate, set_schedule_count


class _ShapeGraph(NamedTuple):
    """One bag shape's graph of K steps, its static buffers and the launch
    counts its capture recorded."""
    graph: torch.cuda.CUDAGraph
    inputs: dict
    lr: torch.Tensor
    outputs: list
    captured: dict


class ChunkRunner:
    """Runs full chunks of ``k`` steps of ``step`` (``tensors -> metrics``,
    the optimizer stepped, the schedule not: this runner steps
    ``scheduler``) as CUDA graphs, one a bag shape: ``run(key, chunk)``
    captures ``key``'s graph at its first call and replays it, and returns
    the K steps' metric dicts, in order.  ``captures`` and ``replays`` count
    the graphs made and replayed."""

    def __init__(self, step, optimizer, scheduler, k: int):
        self.step, self.optimizer, self.scheduler = step, optimizer, scheduler
        self.k = k
        self.graphs: dict = {}
        self.captures = self.replays = 0

    def run(self, key, chunk: list) -> list:
        if len(chunk) != self.k:
            raise ValueError(f"a chunk of {len(chunk)} steps, want {self.k}")
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(chunk)
            self.captures += 1
        for name, buf in g.inputs.items():
            shapes = {tuple(t[name].shape) for t in chunk}
            if shapes != {tuple(buf.shape[1:])}:
                raise ValueError(f"chunk of bag shape {key}: {name} shapes "
                                 f"{shapes}, the graph's {tuple(buf.shape[1:])}")
            torch.stack([t[name] for t in chunk], out=buf)
        lrs = scheduled_lrs(self.scheduler, self.k)
        g.lr.copy_(torch.tensor(lrs).pin_memory(), non_blocking=True)
        g.graph.replay()
        self.replays += 1
        for name, n in g.captured.items():
            launches.WRAPPERS[name].launches += n
        set_schedule_count(self.scheduler, self.optimizer,
                           self.scheduler.last_epoch + self.k)
        return [{name: v.clone() for name, v in m.items()} for m in g.outputs]

    def _capture(self, chunk) -> _ShapeGraph:
        inputs = {name: torch.stack([t[name] for t in chunk])
                  for name in chunk[0]}
        device = self.optimizer.param_groups[0]["params"][0].device
        lr = torch.zeros(self.k, device=device)
        before = {name: fn.launches for name, fn in launches.WRAPPERS.items()}
        graph = torch.cuda.CUDAGraph()
        outputs = []
        with torch.cuda.graph(graph):
            for i in range(self.k):
                set_learning_rate(self.optimizer, lr[i])
                outputs.append(self.step(
                    {name: buf[i] for name, buf in inputs.items()}))
        captured = {}
        for name, fn in launches.WRAPPERS.items():
            n = fn.launches - before[name]
            if n:
                fn.launches -= n  # recorded into the graph, not run
                captured[name] = n
        return _ShapeGraph(graph, inputs, lr, outputs, captured)
