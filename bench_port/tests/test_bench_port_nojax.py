"""The check that no module of JAX or of the JAX package is loaded
compares top-level names whole."""

import sys
import types

import pytest

from bench_port import harness


@pytest.mark.parametrize("name,hit", [
    ("disentangled_multimodal_learning_tpu_torch.x", False),
    ("disentangled_multimodal_learning_tpu_torchvision", False),
    ("jaxtyping", False),
    ("disentangled_multimodal_learning_tpu", True),
    ("disentangled_multimodal_learning_tpu.models.layers", True),
    ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("optax", True)])
def test_top_level_names(monkeypatch, name, hit):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert (name.split(".")[0] in found) == hit


def test_nothing_of_jax_after_a_run(manifest):
    """The harness, the drivers and the port load no forbidden module
    (this test process itself imports no JAX: run without tests/)."""
    before = set(harness.forbidden_modules())
    from bench_port.drivers import eval_batches, train_chunks  # noqa: F401
    import disentangled_multimodal_learning_tpu_torch.train.trainers  # noqa
    assert set(harness.forbidden_modules()) == before
