"""Host bytes of the h2d spans over the device time of the host-to-device
copies in the profiled stretch, in GB/s."""

from bench_port import spans


def read(run):
    return spans.h2d_gbps(run, train=False)
