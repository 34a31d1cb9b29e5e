"""Host ms of Evaluator.step up to the return of its forward (the copy of
the inputs and the dispatch), less the wait for the card in its .cpu(), a
batch, over the window before the profiler."""

from bench_port import readers


def read(run):
    if readers.is_train(run) or not run.calls:
        return None
    n = min(run.calls, len(run.forward_done))
    return sum(1e3 * (run.forward_done[i] - run.spans[i][0])
               for i in range(n)) / n
