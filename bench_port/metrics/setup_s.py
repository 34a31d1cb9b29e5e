"""Process start to the first timed call: imports, inputs and weights,
the kernel build where it is not cached, the warm-up (graph capture
included)."""


def read(run):
    return run.setup_s
