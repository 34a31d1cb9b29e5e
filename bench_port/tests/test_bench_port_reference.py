"""The frozen reference against the port's CPU path at a small width: the
same weights and batch give the same eval logits and the same first train
step, so that the copy is known to be faithful."""

import pytest
import torch

from bench_port import compare, harness, inputs
from bench_port.drivers.train_chunks import host_tensors, port_config

from conftest import SMALL


def _port(cell):
    from disentangled_multimodal_learning_tpu_torch.models.factory import \
        define_net

    return define_net(port_config(cell, "cpu"), "cpu")


@pytest.mark.parametrize("name", ["teacher_eval_b16", "student_eval_b16"])
def test_eval_logits_match(manifest, name):
    from disentangled_multimodal_learning_tpu_torch.train.evaluation import (
        Evaluator, model_type_of)

    cell = harness.load_cell(name, manifest, SMALL)
    ref = cell.reference.build(cell.settings, "cpu").eval()
    state = inputs.make_state(ref, 3, "cpu")
    ref.load_state_dict(state, strict=True)
    port = _port(cell)
    port.load_state_dict(state, strict=True)
    ev = Evaluator(port.eval(), port_config(cell, "cpu"), "cpu",
                   model_type_of(cell.settings["mode"]))
    batch = inputs.make_pool(cell.settings, 1, 3, 9, "cpu")[0]
    got = ev.step(batch)
    with torch.no_grad():
        t = host_tensors(batch, "cpu")
        want = ref(*(t[k] for k in cell.reference.INPUTS[
            cell.settings["mode"]]))[0]
    want = {k: v.numpy() for k, v in want.items()}
    assert compare.logit_gap(got, want) <= 1e-6


@pytest.mark.parametrize("name", ["teacher_train_k4", "student_train_k4"])
def test_first_train_step_matches(manifest, name):
    from disentangled_multimodal_learning_tpu_torch.train import (optim,
                                                                   steps,
                                                                   trainers)

    cell = harness.load_cell(name, manifest, SMALL)
    cfg = port_config(cell, "cpu")
    ref = cell.reference.build(cell.settings, "cpu")
    state = inputs.make_state(ref, 4, "cpu")
    ref.load_state_dict(state, strict=True)
    port = _port(cell)
    port.load_state_dict(state, strict=True)
    opt = optim.make_optimizer(cfg, port.parameters())
    optim.make_scheduler(cfg, opt, 16)  # sets the step's lr
    step, _ = trainers.make_step(cfg, port, opt, None)
    trainer = cell.reference.Trainer(
        ref, cell.settings, 16, torch.tensor(cell.config["class_weights"]))
    batch = inputs.make_pool(cell.settings, 1, 4, 8, "cpu")[0]
    torch.manual_seed(21)
    got = float(step(steps.batch_to_tensors(batch, "cpu"))["loss"])
    torch.manual_seed(21)
    want = float(trainer.step(host_tensors(batch, "cpu")))
    # the same dropout masks: the loss agrees to rounding
    assert abs(got - want) <= 1e-6 * abs(want)
    grads = {n: p.grad for n, p in port.named_parameters()}
    ref_grads = {n: p.grad for n, p in ref.named_parameters()}
    # the K1 backward's fraction cotangent sums in another order than
    # autograd through the reference's gather
    assert compare.leaf_gap(grads, ref_grads) <= 1e-5
    params = dict(port.named_parameters())
    moved = compare.leaf_gap(
        {n: params[n].detach() - state[n] for n in state},
        {n: p.detach() - state[n] for n, p in ref.named_parameters()},
        compare.moving_leaves(ref_grads))
    assert moved <= 1e-5
