"""The port's reference-named surface (``compat.py``) and the reference
losses and metrics under it (``train/losses.py``, ``train/metrics.py``)
against the JAX package on the CPU: JAX's five ``tests/test_compat.py``
tests on the port; every new loss and its gradient against JAX's (the
detached operands of ``orthogonal_loss`` included); the micro metrics, the
confusion matrix and ``cindex_lifelines``; the regularizers on the same
pathomic weights.  numpy-seeded inputs; one torch thread a test.

Tolerances: f32 loss values within 1e-5 relative (``LOSS_TOL``; other
summation orders), their gradients within 1e-5 abs (``GRAD_TOL``); the
metrics in float64, within 1e-12; the regularizers (sums of ~50 k |w| in
f32) within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu import compat as jcompat
from disentangled_multimodal_learning_tpu.config import Config as JConfig
from disentangled_multimodal_learning_tpu.models.factory import (
    define_net as jdefine_net, model_inputs as jmodel_inputs)
from disentangled_multimodal_learning_tpu.data.synthetic import (
    SyntheticBagDataset as JSynthetic)
from disentangled_multimodal_learning_tpu.train import losses as JL
from disentangled_multimodal_learning_tpu.train import metrics as JM
from disentangled_multimodal_learning_tpu_torch import compat
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.models.factory import (
    define_net)
from disentangled_multimodal_learning_tpu_torch.train import losses as L
from disentangled_multimodal_learning_tpu_torch.train import metrics as M
from disentangled_multimodal_learning_tpu_torch.train import optim
from disentangled_multimodal_learning_tpu_torch.utils.jax_params import (
    load_jax_params)

LOSS_TOL, GRAD_TOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _surv_inputs(rng, B=5, K=4):
    h = 1 / (1 + np.exp(-rng.normal(size=(B, K)).astype(np.float32)))
    return (h, np.cumprod(1 - h, axis=1).astype(np.float32),
            rng.integers(0, K, size=B), rng.integers(0, 2, size=B))


# ------------------------------------------------- JAX test_compat.py, ported

def test_survival_loss_wrappers_match_functions(rng):
    hz, S, Y, c = map(torch.from_numpy, _surv_inputs(rng, B=3))
    assert compat.NLLSurvLoss(alpha=0.15)(hz, S, Y, c).item() == (
        L.nll_surv_loss(hz, S, Y, c, alpha=0.15).item())
    assert compat.CrossEntropySurvLoss(alpha=0.4)(hz, S, Y, c).item() == (
        L.ce_surv_loss(hz, S, Y, c, alpha=0.4).item())
    t = torch.tensor([100.0, 50.0, 400.0])
    pred = torch.from_numpy(rng.normal(size=(3, 1)).astype(np.float32))
    assert compat.CoxSurvLoss()(t, 1 - c, pred).item() == (
        L.cox_loss(t, 1 - c, pred).item())
    assert (compat.nll_loss, compat.CoxLoss, compat.ce_surv) == (
        L.nll_surv_loss, L.cox_loss, L.ce_surv_loss)


def test_define_loss_dispatch():
    assert isinstance(compat.define_loss("nll_surv"), compat.NLLSurvLoss)
    assert isinstance(compat.define_loss("ce_surv"),
                      compat.CrossEntropySurvLoss)
    assert isinstance(compat.define_loss("cox_surv"), compat.CoxSurvLoss)
    for name in ("kl", "cosine", "orthogonal"):
        assert compat.define_loss(name) is getattr(L, f"{name}_loss")
    with pytest.raises(NotImplementedError):
        compat.define_loss("nope")


@pytest.mark.parametrize("opt,policy", [("adamw", "cosine"),
                                        ("adam", "linear"), ("sgd", "step")])
def test_define_optimizer_and_scheduler(opt, policy):
    """The port's optimizer over a module's parameters and its LambdaLR:
    the lr of every step equals JAX's schedule (``define_scheduler``)
    within 1e-6 of the base lr (optax evaluates it in f32, the port in
    float64), and ``current_learning_rate`` reads it."""
    kw = dict(mode="omic", lr=1e-3, lr_policy=policy, epochs=2,
              optimizer=opt, checkpoints="#", debug=True)
    cfg, jcfg = Config(**kw).validate(), JConfig(**kw).validate()
    model = define_net(cfg, "cpu")
    tx = compat.define_optimizer(cfg, model)
    assert type(tx) is {"adamw": torch.optim.AdamW, "adam": torch.optim.Adam,
                        "sgd": torch.optim.SGD}[opt]
    sched = compat.define_scheduler(cfg, tx, steps_per_epoch=10)
    jsched = jcompat.define_scheduler(jcfg, steps_per_epoch=10)
    assert hasattr(jcompat.define_optimizer(jcfg, 10), "update")
    lrs = []
    for step in range(20):
        lrs.append(optim.current_learning_rate(tx))
        assert lrs[-1] == pytest.approx(float(jsched(step)),
                                        rel=0, abs=1e-6 * cfg.lr), step
        tx.step()
        sched.step()
    assert lrs[0] > lrs[-1] >= 0.0


def test_trilinear_variants():
    assert compat.TrilinearFusion_A().variant == "A"
    assert compat.TrilinearFusion_B().variant == "B"
    assert compat.TrilinearFusion_B(dim1=8, mmhid=4).pairs[2] == (1, 0)


def test_regularizers_target_subtrees():
    """JAX's dict case, then a pathomic model with JAX's weights: each
    regularizer's value equals JAX's on the same params; BatchNorm's
    statistics (buffers) are not params and count in neither."""
    params = {"path_net": torch.ones(2, 2), "omic_net": 2 * torch.ones(2, 2),
              "fusion_layer": 3 * torch.ones(2)}
    assert compat.regularize_path_weights(params).item() == 4.0
    assert compat.regularize_MM_omic(params).item() == 8.0
    assert compat.regularize_MM_weights(params).item() == 6.0
    assert compat.regularize_weights(params).item() == 18.0

    kw = dict(mode="pathomic", fusion_type="pofusion", fixdim=16,
              batch_size=2)
    jcfg, cfg = JConfig(**kw), Config(**kw).validate()
    batch = JSynthetic(size=2, fixdim=16, seed=0).batch([0, 1])
    jm = jdefine_net(jcfg)
    variables = jax.device_get(jax.jit(lambda k: jm.init(
        k, deterministic=True, **jmodel_inputs("pathomic", batch, False)))(
            jax.random.PRNGKey(0)))
    p = variables["params"]
    model = load_jax_params(define_net(cfg, "cpu"), p, "pathomic",
                            batch_stats=variables["batch_stats"])
    for name in ("regularize_weights", "regularize_path_weights",
                 "regularize_MM_weights", "regularize_MM_omic"):
        want = float(getattr(jcompat, name)(p))
        got = getattr(compat, name)(model).item()
        assert want > 0 and got == pytest.approx(want, rel=1e-5), name
    assert {k.split(".")[0] for k in compat._subtree(model, "fusion")} == {
        "fusion"}
    assert not any("running" in k for k in compat._subtree(model, "fusion"))


# ------------------------------------------------ losses and gradients vs JAX

def _both(fn, jfn, *arrays, grad_of=None):
    """``fn`` on tensors and ``jfn`` on jnp arrays of ``arrays``: values and
    the gradients of their sum with respect to the inputs ``grad_of``
    (indices; default every float input)."""
    grad_of = [i for i, a in enumerate(arrays) if a.dtype == np.float32] if (
        grad_of is None) else grad_of
    ts = [torch.tensor(a, requires_grad=i in grad_of)
          for i, a in enumerate(arrays)]
    out = fn(*ts)
    grads = torch.autograd.grad(out.sum(), [ts[i] for i in grad_of])
    js = [jnp.asarray(a) for a in arrays]
    jout = jfn(*js)

    def total(*xs):
        full = list(js)
        for i, x in zip(grad_of, xs):
            full[i] = x
        return jnp.sum(jfn(*full))

    jgrads = jax.grad(total, argnums=tuple(range(len(grad_of))))(
        *[js[i] for i in grad_of])
    return out.detach().numpy(), np.asarray(jout), (
        [g.numpy() for g in grads], [np.asarray(g) for g in jgrads])


def _close(got, want, grads):
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=1e-7)
    for g, w in zip(*grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL)


@pytest.mark.parametrize("name", ["cox", "ce_surv", "kl", "cosine",
                                  "orthogonal", "low_rank",
                                  "directional_consistency"])
def test_loss_and_gradient_match_jax(rng, name):
    if name == "cox":
        args = (rng.integers(10, 100, size=7).astype(np.float32),
                rng.integers(0, 2, size=7).astype(np.float32),
                rng.normal(size=(7, 1)).astype(np.float32))
        got, want, grads = _both(L.cox_loss, JL.cox_loss, *args, grad_of=[2])
    elif name == "ce_surv":
        h, S, Y, c = _surv_inputs(rng)
        got, want, grads = _both(
            lambda *a: L.ce_surv_loss(*a, alpha=0.4),
            lambda *a: JL.ce_surv_loss(*a, alpha=0.4), h, S, Y, c,
            grad_of=[0, 1])
    elif name in ("kl", "cosine"):
        args = [rng.normal(size=(4, 6)).astype(np.float32) for _ in range(2)]
        got, want, grads = _both(getattr(L, f"{name}_loss"),
                                 getattr(JL, f"{name}_loss"), *args)
    elif name == "orthogonal":
        args = [rng.normal(size=(4, 8)).astype(np.float32) for _ in range(4)]
        got, want, grads = _both(L.orthogonal_loss, JL.orthogonal_loss, *args)
        # P and G reach the positive and the cross terms only detached:
        # their gradient is that of gamma |cos(P, G)| alone (gamma 0.5)
        tp, tg = (torch.tensor(a, requires_grad=True) for a in args[::2])
        (0.5 * torch.abs(L._cossim(tp, tg))).sum().backward()
        np.testing.assert_allclose(grads[0][0], tp.grad.numpy(), atol=1e-7)
        np.testing.assert_allclose(grads[0][2], tg.grad.numpy(), atol=1e-7)
    elif name == "low_rank":
        got, want, grads = _both(L.low_rank_loss, JL.low_rank_loss,
                                 rng.normal(size=(5, 3)).astype(np.float32))
    else:
        m = rng.normal(size=(2, 6)).astype(np.float32)
        m[1, :2] = m[0, :2]  # ties: left out of the mean sign
        got, want, grads = _both(L.directional_consistency_loss,
                                 JL.directional_consistency_loss, m)
        assert L.directional_consistency_loss(torch.tensor(
            [[1.0, 2.0, 3.0], [0.0, 1.0, 2.0]])).item() == 0.0
        assert L.directional_consistency_loss(torch.tensor(
            [[1.0, 0.0], [0.0, 1.0]])).item() == 1.0
    _close(got, want, grads)


def test_cossim_clamps_the_product_of_the_norms():
    """``_cossim`` divides by max(|a| |b|, 1e-8), as JAX does, where
    ``F.cosine_similarity`` clamps each norm at eps: rows of norm 1e-5 and
    1.4e-4 (product 1.4e-9) differ between the two."""
    a = torch.tensor([[1e-5, 0.0]])
    b = torch.tensor([[1e-4, 1e-4]])
    want = float(JL._cossim(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))[0])
    assert L._cossim(a, b).item() == pytest.approx(want, rel=1e-6)
    assert L._cossim(a, b).item() != pytest.approx(
        torch.nn.functional.cosine_similarity(a, b, eps=1e-8).item(),
        rel=1e-3)


def test_sigmoid_rampup_and_l1_match_jax():
    for cur, length in ((0, 10), (3, 10), (10, 10), (12, 10), (-1, 10),
                        (5, 0)):
        assert L.sigmoid_rampup(cur, length) == pytest.approx(
            JL.sigmoid_rampup(cur, length), rel=1e-12)
    params = {"a": torch.tensor([-1.0, 2.0]),
              "b": {"c": torch.tensor([[3.0]])}}
    assert L.l1_regularizer(params).item() == 6.0
    assert L.l1_regularizer(iter([torch.tensor([-4.0])])).item() == 4.0


# ------------------------------------------------------------------- metrics

def test_micro_metrics_and_confusion_match_jax(rng):
    y = rng.integers(0, 3, size=40)
    logits = rng.normal(size=(40, 3))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    got = M.compute_avg_metrics_micro(y, probs)
    want = JM.compute_avg_metrics_micro(y, probs)
    for g, w in zip(got, want, strict=True):
        assert g == pytest.approx(w, abs=1e-12)
    assert got[0] == got[1] == got[4] == got[6]  # micro acc = f1 = rec = prec
    np.testing.assert_array_equal(M.make_one_hot(y, 3), JM.make_one_hot(y, 3))
    np.testing.assert_array_equal(M.make_one_hot(y), JM.make_one_hot(y))
    for labels in ([0, 1, 2], [2, 0], [0, 1, 2, 3]):
        np.testing.assert_array_equal(
            M.compute_confusion_matrix(y, probs, labels),
            JM.compute_confusion_matrix(y, probs, labels))
    assert M.compute_confusion_matrix(y, probs, [0, 1, 2]).sum() == 40


def test_cindex_lifelines_matches_jax(rng):
    n = 25
    t = rng.integers(1, 50, size=n).astype(float)
    ev = rng.integers(0, 2, size=n)
    r = rng.normal(size=n)
    r[:3] = r[3]  # tied risks count 0.5
    got = M.cindex_lifelines(r, ev, t)
    assert got == JM.cindex_lifelines(r, ev, t)
    assert got == M.cindex(r, 1 - ev, t)
