"""Experiment config of the port: the fields the teacher, student,
multiscale, deformpathomic, distillation and baseline serving and training
paths, the real-data loaders and the parallel layouts read, under the
names and defaults of the JAX ``Config``
(``disentangled_multimodal_learning_tpu/config.py``), so its YAML presets
load unchanged.  ``yaml`` is imported only when a YAML file is read;
:meth:`Config.diag2021` holds the flagship preset in code for machines
without it.

Every other key of the JAX ``Config`` sits in one of two tables:
:data:`IGNORED` (keys the port ignores on purpose, each with its reason) and
:data:`LATER` (keys a later part of the port reads, each with its JAX
default and that part's subject; empty since the parallel part).
:meth:`Config.from_dict` raises ``NotImplementedError`` for a LATER key
set to anything but its JAX default, and ``ValueError`` for a key in
neither table: JAX keeps such keys in
``cfg._extra`` and may read them (``define_net`` does, through ``getattr``),
so dropping one could change what runs."""

from __future__ import annotations

import argparse
import dataclasses
import os

_TASK_LABEL_DIM = {"diag2021": 4, "survival": 4, "grade": 3, "subtype": 3}
# weighted-CE class weights per task (JAX config.py:80-84)
TASK_CLASS_WEIGHTS = {
    "diag2021": (1.0, 4.15, 2.93, 2.43),
    "grade": (1.47, 1.51, 1.0),
    "subtype": (1.0, 1.72, 2.43),
}


_NOWHERE = "the JAX package reads it nowhere"
_UNREAD = "the JAX package reads it nowhere (a reference CLI key)"
_CLUSTER = ("the JAX package reads it nowhere (a reference cluster key; the "
            "process group comes from nodes and the DMLT_* environment)")
# JAX Config keys the port ignores on purpose -> why
IGNORED = {
    "remat": ("JAX's CPB_REMAT recomputes the CPB MLP in the backward to "
              "save memory, with equal results; the port's CPB backward "
              "kernels read no stored MLP activations"),
    "use_pallas": _NOWHERE, "mesh_data_axis": _NOWHERE,
    "compute_dtype": _NOWHERE + " (its compute dtype follows the backend)",
    "checkpoint_backend": "the JAX writer's orbax/pickle choice: the port "
                          "writes .pt, reads JAX's pickle .ckpt and does "
                          "not read .orbax",
    "gpus": _CLUSTER, "nr": _CLUSTER, "rank": _CLUSTER,
    "world_size": _CLUSTER, "dataparallel": _CLUSTER,
    "visiable_device": _CLUSTER,
    "cut_fuse_grad": _UNREAD, "image_size": _UNREAD, "return_grad": _UNREAD,
    "survival_interval": _UNREAD, "start_epoch": _UNREAD,
    "label_path": _UNREAD, "dataDir_pyramid": _UNREAD, "pyramid": _UNREAD,
    "dataset": _UNREAD, "combination_type": _UNREAD, "act_type": _UNREAD,
}
# JAX Config keys a later part of the port reads -> (JAX default, subject):
# none since the parallel part
LATER: dict = {}


def yaml_config_hook(config_file: str) -> dict:
    """Load a YAML config and merge its ``defaults:`` includes, each
    ``{subdir: name}`` -> ``<dir-of-config>/<subdir>/<name>.yaml``.  The
    includes WIN over the including file (the reference's dict.update
    order), as in the JAX ``yaml_config_hook``."""
    import yaml

    with open(config_file) as f:
        cfg = yaml.safe_load(f)
    for d in cfg.get("defaults", []):
        config_dir, cf = dict(d).popitem()
        cf = os.path.join(os.path.dirname(config_file), config_dir, cf + ".yaml")
        with open(cf) as g:
            cfg.update(yaml.safe_load(g))
    cfg.pop("defaults", None)
    return cfg


def _parse_bool(s: str) -> bool:
    return str(s).lower() in ("1", "true", "yes", "y")


@dataclasses.dataclass
class Config:
    mode: str = "teacher"
    task_type: str = "diag2021"
    label_dim: int = 4
    fixdim: int = 2500
    batch_size: int = 4
    input_size_omic: int = 431
    input_size_omic_tumor: int = 59
    input_size_omic_immune: int = 361
    input_path_dim: int = 1024
    path_dim: int = 128
    omic_dim: int = 128
    dropout_rate: float = 0.1
    combination_type_teas: str = "max_confidence"
    combination_type_stus: str = "max_confidence"
    # the student's DPC-KNN keeps ceil(fixdim * path_cluster_num) clusters
    # per bag, at least 2
    path_cluster_num: float = 0.0008
    # 0 = exact CPB (kernel K2); d >= 1 = the table CPB on a lattice d times
    # finer than the query grid (kernel K1 at 1, K5 at d >= 2)
    cpb_table_divisor: int = 0
    # the fused table attention (kernel K6: bias windows, sim, softmax,
    # dropout and PV in one kernel) at divisor 1
    fused_table_attention: bool = False
    # bf16 q/k/v, sim and attention streams on the card (softmax in f32)
    attn_bf16_streams: bool = False
    # bf16 store of the 2-D table CPB windows on the card (blend in f32)
    cpb_table_bf16: bool = False
    # deformpathomic (JAX config.py:153, :169, :196, :211-214): the
    # deformable attention's dimension (1: the cls-token 1-D attention, 2:
    # the 2-D one), the reference's degenerate 1-D sampler, the vgrid
    # consistency loss (attn_dim 2 only), the branch fusion
    attn_dim: int = 2
    degenerate_1d_sampling: bool = False
    return_vgrid: bool = False
    fusion_type: str = "concat"
    mmhid: int = 128
    # the pathomic baselines' BilinearFusion (JAX config.py:154-168): the
    # skip connection, the bilinear (else linear) gates, each branch's
    # gate and its width divisor
    skip: int = 0
    use_bilinear: int = 1
    path_gate: int = 1
    omic_gate: int = 1
    path_scale: int = 1
    omic_scale: int = 1
    # re-initialisation after the seeded init (JAX config.py:190-191,
    # utils/weight_init.py): max (MaxNet's own init) and none are no-ops;
    # normal, xavier, kaiming, orthogonal at init_gain
    init_type: str = "max"
    init_gain: float = 0.02
    synthetic_data: bool = False
    # real data (JAX config.py:96-98, :150, :255-258): the cohort root
    # (data/datasets.py), TCGA + IvYGAP co-training (else TCGA alone;
    # external_eval trains on CPTAC), comma-separated perfect-square bag
    # buckets (data/bucketing.py; "" = every bag at fixdim), the prefetch
    # depth of the train loader (0 = 2), and the per-fold split dumps
    dataDir: str = "./data/"
    coTraining: bool = True
    buckets: str = ""
    workers: int = 0
    printDataSplit: bool = False
    synthetic_train_size: int = 64
    synthetic_test_size: int = 32
    seed: int = 42
    checkpoints: str = "./checkpoints"
    checkpoints_teacher: str = "#"
    checkpoints_student: str = "#"
    # training (JAX config.py:172-203)
    epochs: int = 10
    lr: float = 2.0e-4
    lr_policy: str = "cosine"
    plateau_factor: float = 0.2
    plateau_patience: int = 5
    plateau_threshold: float = 0.01
    optimizer: str = "adamw"
    weight_decay: float = 0.01
    warmup_epochs: int = 1
    kfold: int = 3
    cur_fold: int = 0
    gradient_modulate: bool = True
    multiscale_attention: bool = True
    external_eval: bool = False
    # eval cadence and the trajectory-parity switch (JAX config.py:263-283)
    eval_every_iters: int = 200
    eval_during_training: bool = True
    deterministic_training: bool = False
    # K train steps a chunk, batches grouped by bag shape (JAX
    # config.py:276, trainers.py:234-285); read as max(1, K); on the card a
    # chunk is one CUDA graph (train/graph_chunk.py)
    scan_steps: int = 1
    # checkpoints (JAX config.py:110-111, :173): ``reload`` restores the
    # full state from checkpoints_teacher / checkpoints_student before
    # training; ``resume`` restarts a fold from its rolling checkpoint,
    # written every ``save_every_epochs`` epochs (0: never)
    reload: bool = False
    resume: bool = False
    save_every_epochs: int = 0
    # exports of the evaluation (JAX config.py:257-259): per-tag ROC score
    # CSVs, and the serving entry's attention-map npz
    save4roc: bool = False
    save4visualization: bool = False
    # distillation (JAX config.py:140, :200-202): the KL on the logits at
    # ``temperature`` and the MSE on the features, and the teacher-output
    # cache
    distill_logits: bool = True
    distill_feature: bool = True
    temperature: float = 2.0
    distill_teacher_cache: bool = True
    # run logging (JAX config.py:291, :295-296, utils/logging.py): the
    # entries log nothing under ``debug``, else to wandb where ``wandb`` is
    # set and importable, else to a JSONL file in ``log_dir``
    debug: bool = False
    log_dir: str = "./logs"
    wandb: bool = False
    # training over several processes (JAX config.py:113-145; the port's
    # parallel/): the process group joins with nodes > 1 (or a
    # DMLT_COORDINATOR rendezvous); tensor parallelism over the 2-D
    # attention's heads, the two magnifications on their own ranks, the
    # distillation pipeline with its microbatches, TransMIL's token axis
    # over seq_shard_devices ranks (seq_shard_dp data groups of them); else
    # data parallelism over every rank (train/trainers.py)
    nodes: int = 1
    tp_devices: int = 0
    branch_devices: int = 0
    pipe_devices: int = 0
    pipe_microbatches: int = 2
    seq_shard_devices: int = 0
    seq_shard_dp: int = 0

    @property
    def class_weights(self):
        return TASK_CLASS_WEIGHTS.get(self.task_type)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """The port's fields of ``d``; an :data:`IGNORED` key is dropped, a
        :data:`LATER` key at its JAX default too, and anything else raises
        (see the module docstring)."""
        known = {f.name for f in dataclasses.fields(cls)}
        for k, v in d.items():
            if k in known or k in IGNORED:
                continue
            if k not in LATER:
                raise ValueError(
                    f"unknown config key {k!r}: neither a field of the port "
                    "nor a key of the JAX Config it ignores or ports later")
            default, subject = LATER[k]
            if (tuple(v) if isinstance(v, list) else v) != default:
                raise NotImplementedError(
                    f"{k}={v!r}: the port runs only {k}={default!r} so far; "
                    f"{k} comes with the {subject}")
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        return cls.from_dict(yaml_config_hook(path))

    @classmethod
    def diag2021(cls) -> "Config":
        """``config/config_mine_diag2021.yaml`` on the fields above."""
        return cls(mode="teacher", task_type="diag2021", label_dim=4,
                   fixdim=2500, batch_size=4, input_size_omic=431,
                   input_size_omic_tumor=59, input_size_omic_immune=361,
                   input_path_dim=1024, path_dim=128, omic_dim=128,
                   dropout_rate=0.1, combination_type_teas="max_confidence",
                   combination_type_stus="max_confidence",
                   path_cluster_num=0.0008, cpb_table_divisor=1,
                   attn_dim=2, return_vgrid=False, fusion_type="concat",
                   mmhid=128,
                   attn_bf16_streams=True, synthetic_data=False, seed=42,
                   checkpoints="./checkpoints", checkpoints_teacher="#",
                   checkpoints_student="#", epochs=10, lr=2.0e-4,
                   lr_policy="cosine", optimizer="adamw", weight_decay=0.01,
                   warmup_epochs=1, kfold=3, gradient_modulate=True,
                   multiscale_attention=True, external_eval=False,
                   eval_every_iters=10, eval_during_training=True)

    @classmethod
    def from_args(cls, argv=None) -> tuple["Config", argparse.Namespace]:
        """``--config <yaml>`` (else the in-code diag2021 preset), then one
        ``--<field> <value>`` override per field.  Returns the config and
        the namespace of the remaining flags (``--checkpoint``, ``--device``)."""
        pre = argparse.ArgumentParser(add_help=False)
        pre.add_argument("--config", default=None)
        ns, _ = pre.parse_known_args(argv)
        base = cls.from_yaml(ns.config) if ns.config else cls.diag2021()
        parser = argparse.ArgumentParser(parents=[pre])
        for f in dataclasses.fields(cls):
            v = getattr(base, f.name)
            if f.name == "debug":  # a switch, as in JAX config.py:54-59
                parser.add_argument("--debug", action="store_true", default=v,
                                    help="debug mode (no logging sink)")
                continue
            parser.add_argument(f"--{f.name}", default=v,
                                type=_parse_bool if isinstance(v, bool)
                                else type(v))
        parser.add_argument("--checkpoint", default=None,
                            help="the port's .pt checkpoint or a "
                            "reference-named .pth state_dict")
        parser.add_argument("--device", default="cuda",
                            help="torch device (default: cuda; pass cpu to "
                            "run on the CPU)")
        args = parser.parse_args(argv)
        fields = {f.name for f in dataclasses.fields(cls)}
        cfg = cls.from_dict({k: v for k, v in vars(args).items()
                             if k in fields}).validate()
        return cfg, args

    def validate(self) -> "Config":
        if self.task_type not in _TASK_LABEL_DIM:
            raise ValueError(f"unknown task_type {self.task_type!r}")
        self.label_dim = _TASK_LABEL_DIM[self.task_type]
        r = int(round(self.fixdim ** 0.5))
        if self.fixdim <= 0 or r * r != self.fixdim:
            raise ValueError(f"fixdim={self.fixdim} must be a perfect square: "
                             "the deformable 2-D attention views the bag as a "
                             "sqrt(N) x sqrt(N) grid")
        if self.attn_dim not in (1, 2):
            raise ValueError(f"attn_dim={self.attn_dim}: want 1 or 2")
        if self.attn_dim == 1 and self.return_vgrid:
            raise ValueError(
                "return_vgrid needs attn_dim 2: at attn_dim 1 the model has "
                "no vgrid for batch_loss_vgrid (JAX returns None there and "
                "the loss fails on it)")
        if self.buckets:
            from .data.bucketing import validate_buckets

            validate_buckets(str(self.buckets).split(","))
        from .utils.weight_init import VALID_INIT_TYPES

        if self.init_type not in VALID_INIT_TYPES:
            raise NotImplementedError(
                f"initialization method [{self.init_type}] is not "
                f"implemented (valid: {', '.join(VALID_INIT_TYPES)})")
        return self

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
