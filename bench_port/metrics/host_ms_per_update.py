"""Host ms of ChunkRunner.run (which returns before the card finishes)
an update, over the window before the profiler."""

from bench_port import readers


def read(run):
    if not readers.is_train(run) or not run.calls:
        return None
    return sum(readers.call_ms(run)) / (run.calls * run.updates_per_call)
