"""Experiment config of the port: the fields the teacher, student and
deformpathomic serving and training paths read, under the names and defaults of the JAX
``Config`` (``disentangled_multimodal_learning_tpu/config.py``), so its YAML
presets load unchanged.  ``yaml`` is imported only when a YAML file is read;
:meth:`Config.diag2021` holds the flagship preset in code for machines
without it."""

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
    synthetic_data: bool = False
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

    @property
    def class_weights(self):
        return TASK_CLASS_WEIGHTS.get(self.task_type)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
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
            parser.add_argument(f"--{f.name}", default=v,
                                type=_parse_bool if isinstance(v, bool)
                                else type(v))
        parser.add_argument("--checkpoint", default=None,
                            help="reference-named .pth state_dict")
        parser.add_argument("--device", default="cuda",
                            help="torch device (default: cuda; pass cpu to "
                            "run on the CPU)")
        args = parser.parse_args(argv)
        cfg = cls.from_dict(vars(args)).validate()
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
        if self.fusion_type != "concat":
            raise NotImplementedError(
                f"fusion_type={self.fusion_type!r}: the port fuses the "
                "deformpathomic branches by concatenation; BilinearFusion "
                "(models/fusion.py) comes with the baselines slice (ROADMAP "
                "Queue 1)")
        return self

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
