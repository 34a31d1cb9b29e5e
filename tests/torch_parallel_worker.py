"""One rank of the port's parallel tests (``tests/test_torch_parallel*.py``):
joins a gloo process group through a ``FileStore``, runs each case of a
spec in the layout its config chooses, and saves what the rank holds after
it.  It imports no JAX: the tests compute the references and compare.

    python tests/torch_parallel_worker.py SPEC.json RANK

A case is ``{"name", "kind"}`` and, for ``kind`` ``step``: ``cfg`` (a
``Config`` dict), ``weights`` (a ``.pt`` state_dict; distillation also
``teacher``), ``batch`` (an ``.npz`` of the global batch), optionally
``noise`` (an ``.npy`` of the pinned DPC noise to use) and ``cache``
(distillation through the teacher-output cache); it saves the step's
metrics, every gradient after the all-reduce (and the modulation) and the
updated parameters.  ``kind`` ``core``: the sequence-sharded Nystrom core
on ``q, k, v`` and a cotangent ``g`` of an ``.npz`` over a ``(data, seq)``
layout, saving its output rows and the gradients of this rank's rows.
``kind`` ``fold``: ``run_training`` of ``cfg`` from ``weights`` over a
shuffled loader of ``size`` synthetic bags drawn and shuffled with
``seed``, no test loader; it saves every update's loss, the final
parameters and the layout.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from disentangled_multimodal_learning_tpu_torch.config import Config  # noqa: E402
from disentangled_multimodal_learning_tpu_torch.data.loader import (  # noqa: E402
    BagLoader)
from disentangled_multimodal_learning_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticBagDataset)
from disentangled_multimodal_learning_tpu_torch.models.factory import (  # noqa: E402
    define_net)
from disentangled_multimodal_learning_tpu_torch.ops import cluster  # noqa: E402
from disentangled_multimodal_learning_tpu_torch.parallel import (  # noqa: E402
    mesh, seq_shard)
from disentangled_multimodal_learning_tpu_torch.train.optim import (  # noqa: E402
    make_optimizer, make_scheduler)
from disentangled_multimodal_learning_tpu_torch.train.trainers import (  # noqa: E402
    make_step, run_training)

FIELDS = ("x_path10", "x_path20", "x_omic", "x_omic_tumor", "x_omic_immune")


def batch_tensors(path: str) -> dict:
    z = np.load(path)
    out = {k: torch.from_numpy(z[k]) for k in FIELDS}
    out["label"] = torch.from_numpy(z["label"]).long()
    return out, z["indices"]


def run_step(case: dict, out_path: Path) -> None:
    cfg = Config.from_dict(case["cfg"]).validate()
    model = define_net(cfg, "cpu")
    teacher = None
    if cfg.mode == "distillation":
        model, teacher = model
        teacher.load_state_dict(torch.load(case["teacher"]))
    model.load_state_dict(torch.load(case["weights"]))
    if case.get("noise"):
        noise = torch.from_numpy(np.load(case["noise"]))
        cluster.pinned_density_noise = (
            lambda shape, device: noise[:shape[0], :shape[1]].to(device))
    layout = mesh.choose_layout(cfg, has_teacher=teacher is not None)
    opt = make_optimizer(cfg, model.parameters())
    tensors, indices = batch_tensors(case["batch"])
    step, cache = make_step(cfg, model, opt, make_scheduler(cfg, opt, 1),
                            teacher, layout,
                            len(indices) if case.get("cache") else None)
    if cache is not None:
        tensors.update(cache.boundary(tensors, indices))
    metrics = step(tensors)
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {n: p.grad.clone()
                          for n, p in model.named_parameters()},
                "params": model.state_dict(),
                "layout": (layout.kind, layout.dp, layout.inner)},
               out_path)


def run_core(case: dict, out_path: Path) -> None:
    """The sharded core over a ``(dp, seq)`` layout: this rank's data
    group's rows, the pinv normalised within its data group."""
    z = np.load(case["arrays"])
    layout = mesh.make_layout("seq", case["dp"], case["seq"], pinv_local=True)
    B = z["q"].shape[0]
    off, b = layout.rows(B)
    q, k, v = (torch.from_numpy(z[n][off:off + b]).requires_grad_()
               for n in ("q", "k", "v"))
    out = seq_shard.nystrom_attention_seq_sharded(
        q, k, v, case["landmarks"], layout.inner_group)
    # q, k and v are the same on the seq ranks: each back-propagates its
    # share of the cotangent, and their gradients sum over the group
    out.backward(torch.from_numpy(z["g"][off:off + b]) / layout.inner)
    grads = {n: mesh.all_reduce_(t.grad, layout.inner_group)
             for n, t in (("dq", q), ("dk", k), ("dv", v))}
    torch.save({"rows": (off, b), "out": out.detach(), **grads}, out_path)


def run_fold(case: dict, out_path: Path) -> None:
    cfg = Config.from_dict(case["cfg"]).validate()
    model = define_net(cfg, "cpu")
    model.load_state_dict(torch.load(case["weights"]))
    ds = SyntheticBagDataset(size=case["size"], fixdim=cfg.fixdim,
                             label_dim=cfg.label_dim, seed=case["seed"])
    loader = BagLoader(ds, cfg.batch_size, shuffle=True, seed=case["seed"])
    _, final, _ = run_training(cfg, model, (loader, None))
    layout = mesh.choose_layout(cfg)
    torch.save({"losses": final["train_losses"], "params": model.state_dict(),
                "layout": (layout.kind, layout.dp, layout.inner)}, out_path)


def main(spec_path: str, rank: int) -> None:
    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], spec["world"]),
        rank=rank, world_size=spec["world"])
    out_dir = Path(spec["out"])
    for case in spec["cases"]:
        out_path = out_dir / f"{case['name']}.rank{rank}.pt"
        {"step": run_step, "core": run_core,
         "fold": run_fold}[case["kind"]](case, out_path)
    mesh.leave_process_group()
    assert not any(m == "jax" or m.startswith(("jax.", "disentangled_multi"
                                               "modal_learning_tpu."))
                   for m in sys.modules), "a rank imported JAX"


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
