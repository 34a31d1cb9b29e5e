"""Seconds of the setup.optimizer span: make_optimizer, where the first
optimizer imports torch._dynamo."""

from bench_port import spans

read = spans.setup_span_s("setup.optimizer", train_only=True)
