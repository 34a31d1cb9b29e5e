"""A run driven with the timed path broken underneath (the look for a
card skipped, on the CPU at a small width) comes out not correct, once
for each fault the cell can have: a step that leaves the state unchanged,
half of each batch left out (the mean taken over the rest), and an answer
altered where it is produced (a train step's loss, a served logit).  One
chip has no exchange between chips to leave out."""

import time
import types

import pytest
import torch

from bench_port import harness

from conftest import SMALL


def _unchanged(monkeypatch):
    from disentangled_multimodal_learning_tpu_torch.train import optim

    make = optim.make_optimizer

    def broken(*args, **kwargs):
        opt = make(*args, **kwargs)
        opt.step = types.MethodType(lambda self, closure=None: None, opt)
        return opt

    monkeypatch.setattr(optim, "make_optimizer", broken)


def _half_batch(monkeypatch):
    from disentangled_multimodal_learning_tpu_torch.train import (evaluation,
                                                                   steps)

    def halved(to):
        def broken(batch, *args):
            t = to(batch, *args)
            half = len(batch.label) // 2
            return {k: v[:half] for k, v in t.items()}
        return broken

    monkeypatch.setattr(steps, "batch_to_tensors",
                        halved(steps.batch_to_tensors))
    monkeypatch.setattr(evaluation, "model_inputs",
                        halved(evaluation.model_inputs))


def _loss_altered(monkeypatch):
    from disentangled_multimodal_learning_tpu_torch.train import trainers

    make = trainers.make_step

    def broken(*args, **kwargs):
        step, cache = make(*args, **kwargs)

        def altered(tensors):
            m = step(tensors)
            m["loss"] = m["loss"] * 1.01
            return m

        return altered, cache

    monkeypatch.setattr(trainers, "make_step", broken)


def _answer_altered(monkeypatch):
    from disentangled_multimodal_learning_tpu_torch.train import evaluation

    step = evaluation.Evaluator.step

    def broken(self, batch):
        out = step(self, batch)
        k = sorted(out)[0]
        out[k][0, 0] += 0.01 * abs(out[k]).max()
        return out

    monkeypatch.setattr(evaluation.Evaluator, "step", broken)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "loss_altered": _loss_altered, "answer_altered": _answer_altered}


@pytest.mark.parametrize("name,fault", [
    ("teacher_train_k4", "unchanged"), ("teacher_train_k4", "half_batch"),
    ("teacher_train_k4", "loss_altered"),
    ("student_eval_b16", "half_batch"),
    ("student_eval_b16", "answer_altered")])
def test_fault_is_not_correct(manifest, monkeypatch, name, fault):
    torch.set_num_threads(4)
    FAULTS[fault](monkeypatch)
    cell = harness.load_cell(name, manifest, SMALL)
    t0 = time.perf_counter()
    line = harness.run_cell(cell, manifest, 77, 0.5, False, "cpu",
                            setup_clock=lambda: time.perf_counter() - t0)
    assert line["correct"] is False, line["compared"]


def test_unchanged_state_reads_one(manifest, monkeypatch):
    """A step that leaves the state unchanged reads 1 on ``change_gap`` and
    ``first_change_gap``, the reading that needs no run on the card."""
    _unchanged(monkeypatch)
    cell = harness.load_cell("student_train_k4", manifest, SMALL)
    session = cell.driver.start(cell, 5, "cpu")
    session.release()
    gaps = session.check()
    assert gaps["change_gap"] == pytest.approx(1.0)
    assert gaps["first_change_gap"] == pytest.approx(1.0)


def test_window_last_chunk_is_compared(manifest):
    """The chunk held against the reference is the window's last: the
    state is copied aside before every chunk, and the copy made before the
    last one is what the reference starts from."""
    torch.set_num_threads(4)
    cell = harness.load_cell("teacher_train_k4", manifest, SMALL)
    session = cell.driver.start(cell, 9, "cpu")
    k = session.k
    for _ in range(3):
        session.call()
    session.release()
    assert session.next == 5 * k
    assert session.before_last["first"] == 4 * k
    assert session.before_last["count"] == 4 * k
    d = session.details(session._program(), session.reference())
    assert d["last_chunk_count"] == 4 * k
    assert d["loss_gap"] <= cell.traffic["limits"]["loss_gap"]
    assert d["change_gap"] <= cell.traffic["limits"]["change_gap"]
