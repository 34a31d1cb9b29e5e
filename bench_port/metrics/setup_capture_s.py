"""Seconds of the setup.capture span: the capture of the chunk's CUDA
graph."""

from bench_port import spans

read = spans.setup_span_s("setup.capture", train_only=True)
