"""Seconds of the setup.kernels span: the kernel library's first load,
with the nvcc build where it is not cached."""

from bench_port import spans

read = spans.setup_span_s("setup.kernels")
