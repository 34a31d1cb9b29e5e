"""Scale-branch parallelism: the two magnifications on their own ranks
(counterpart of ``disentangled_multimodal_learning_tpu/parallel/branch_shard.py``).

The two-scale models run one architecturally identical subnetwork per
magnification: ``TeacherNet`` x2 (teacher, uniteacher), ``StudentNet`` x2
(student), ``TeacherStudentNet`` x2 (multiscale).  In a ``scale`` layout
rank 0 of each scale group runs the 10x subnetwork and rank 1 the 20x one,
on the rows of its data group; the omic encoders of ``TeachersNet`` are
computed on both ranks.  What crosses the seam is what JAX's docstring
says crosses it:

- the logits of each scale (``[B, C]``), which both ranks need for the
  task loss (the survival chain is recomputed from them) and the
  combination;
- the student's per-scale Gram means (``[B, B]``, ``losses.gram_mean``):
  ``path_batch_loss_stacked`` contracts each scale's maps before the seam;
- one scale's maps, for ``omic_domain_scale_loss``'s cross term: the 20x
  rank sends its two maps to the 10x rank, which computes the term, and
  the maps' cotangent goes back.

The exchange runs on detached tensors between the forward and the
backward: every rank computes the loss of both scales from leaves (its own
scale's boundary tensors, gathered over the data axis, and the other
scale's received ones), takes its own tensors' gradient (plus, on the 20x
rank, the cross term's gradient that the 10x rank sends back) and
back-propagates its own rows of it.  So no collective runs inside autograd
and the ranks' graphs may differ.  The all-reduce of the gradient over
every rank then sums the two branches (each rank's gradient of the other
scale's subnetwork is 0) and the omic encoders' two partial gradients.
Gradient modulation runs on each rank's own teacher classifier, and the
modulated gradients are exchanged (:func:`share_classifier_grads`).

Every rank keeps the whole model: rank 0 evaluates and saves it alone, as a
single-process model, and a branch-parallel checkpoint is the unstacked
one.  JAX stacks the two subnetworks on a leading axis to shard them
(``stacked_scales``); the port keeps its unstacked names, and
``utils/jax_params.py`` converts a stacked JAX param tree
(``unstack_scale_params``, ``stack_scale_params``).  JAX also turns its
Pallas CPB off here (``engage_branch``); each rank of the port is
single-device code, so its kernels stay on.
"""

from __future__ import annotations

import torch

from ..models.layers import survival_chain
from ..train import losses as L
from . import mesh

SCALES = ("10", "20")
# mode -> the subnetwork per scale
NETS = {"teacher": "teacher{}_net", "uniteacher": "teacher{}_net",
        "student": "student{}_net", "multiscale": "scale{}_net"}


def _branch_outputs(model, mode: str, own: dict, tag: str) -> dict:
    """This rank's scale ``tag``: its logits (``tea``, ``stu``), maps
    (``att1``, ``att2``, ``att``) and the teacher's feature halves."""
    net = getattr(model, NETS[mode].format(tag))
    path = own[f"x_path{tag}"]
    if mode in ("teacher", "uniteacher"):
        omic_t, _ = model.omic_net_tumor(own["x_omic_tumor"])
        omic_i, _ = model.omic_net_immune(own["x_omic_immune"])
        l, _, _, _, f1, f2, a1, a2 = net(path, [omic_t, omic_i])
        return {"tea": l, "att1": a1, "att2": a2, "f1": f1, "f2": f2}
    if mode == "student":
        l, _, _, _, _, a = net(path)
        return {"stu": l, "att": a}
    (ls, _, _, _, _, a, lt, _, _, _, _, _, a1, a2) = net(
        path, own["x_omic_tumor"], own["x_omic_immune"])
    return {"stu": ls, "att": a, "tea": lt, "att1": a1, "att2": a2}


def _src(layout, scale: int) -> int:
    """The global rank of ``scale``'s rank in this rank's scale group."""
    return layout.data_index * layout.inner + scale


def _exchange(t: torch.Tensor, layout) -> list:
    """Both scales' ``t`` (this rank's and the other's), as a list."""
    both = mesh.gather_rows(t[None], layout.inner_group)
    return [both[0], both[1]]


def _broadcast(t: torch.Tensor, layout, scale: int) -> torch.Tensor:
    """``scale``'s ``t`` on both ranks of the scale group (``t`` names the
    shape and dtype elsewhere)."""
    return mesh.broadcast_(t.contiguous().clone(), _src(layout, scale),
                           layout.inner_group)


def _task_loss(cfg, logits, label, cw):
    hazards, S, _ = survival_chain(logits)
    return L.task_loss(cfg.task_type, logits=logits, hazards=hazards, S=S,
                       label=label, class_weights=cw)


def forward_backward(model, cfg, own: dict, tensors: dict, layout, cw):
    """This rank's forward and backward of the scale-parallel step of
    ``cfg.mode`` (``own``: its rows of the global batch ``tensors``; ``cw``:
    the task's class weights); returns ``(loss, metrics, modulated
    classifiers)``, the loss and the metrics the same on every rank."""
    s = layout.inner_index
    tag = SCALES[s]
    label = tensors["label"]
    out = _branch_outputs(model, cfg.mode, own, tag)
    if not cfg.multiscale_attention:
        out = {k: v for k, v in out.items() if not k.startswith("att")}
    # own boundary tensors over the global batch's rows, as leaves
    leaves = {k: mesh.gather_rows(v.detach(), layout.data_group)
              .detach().requires_grad_(k not in ("f1", "f2"))
              for k, v in out.items()}
    taskloss = 0.0
    for key in ("tea", "stu"):  # the teacher pair's loss, then the student's
        if key in leaves:
            both = _exchange(leaves[key].detach(), layout)
            both[s] = leaves[key]
            taskloss = taskloss + sum(_task_loss(cfg, l, label, cw)
                                      for l in both)
    loss, metrics = taskloss, {"taskloss": taskloss}
    received = {}  # the 20x rank: its maps' cotangent from the cross term
    if cfg.multiscale_attention:
        batchloss = 0.0
        if "att1" in leaves:
            # the 20x maps cross to the 10x rank, which computes the term
            # and sends back its value and the 20x maps' cotangent
            a20 = [_broadcast(leaves[k].detach(), layout, 1)
                   .requires_grad_(s == 0) for k in ("att1", "att2")]
            cross = torch.zeros((), device=label.device)
            g20 = [torch.zeros_like(a) for a in a20]
            if s == 0:
                cross = L.omic_domain_scale_loss(leaves["att1"], a20[0],
                                                 leaves["att2"], a20[1])
                g20 = torch.autograd.grad(cross, a20, retain_graph=True)
            value = _broadcast(cross.detach().reshape(1), layout, 0)[0]
            g20 = [_broadcast(g, layout, 0) for g in g20]
            if s == 1:
                received = dict(zip(("att1", "att2"), g20))
            batchloss = batchloss + (cross if s == 0 else value)
        if "att" in leaves:
            gram = L.gram_mean(leaves["att"])
            grams = _exchange(gram.detach(), layout)
            grams[s] = gram
            batchloss = batchloss + 1000.0 * L.gram_mean_loss(*grams)
        loss = loss + batchloss
        metrics["batchloss"] = batchloss
    names = [k for k, v in leaves.items() if v.requires_grad]
    grads = dict(zip(names, torch.autograd.grad(
        loss, [leaves[k] for k in names], allow_unused=True)))
    for k, g in received.items():
        grads[k] = g if grads[k] is None else grads[k] + g
    off, b = layout.rows(label.shape[0])
    pairs = [(out[k], g.narrow(0, off, b)) for k, g in grads.items()
             if g is not None]
    torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])
    modulated = []
    if cfg.mode in ("teacher", "uniteacher"):
        cls = getattr(model, NETS[cfg.mode].format(tag)).classifier
        modulated.append((cls, leaves["f1"], leaves["f2"]))
    return loss, metrics, modulated


@torch.no_grad()
def share_classifier_grads(model, mode: str, layout) -> None:
    """Each scale's teacher classifier gradient as its own rank modulated
    it, on both ranks of the scale group (the teachers' modes only: JAX
    modulates no student or multiscale gradient)."""
    if mode not in ("teacher", "uniteacher"):
        return
    for s, tag in enumerate(SCALES):
        w = getattr(model, NETS[mode].format(tag)).classifier.weight
        g = w.grad if s == layout.inner_index else torch.zeros_like(w.grad)
        w.grad = mesh.all_reduce_(g.clone(), layout.inner_group)
