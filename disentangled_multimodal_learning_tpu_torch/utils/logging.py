"""Run logging (counterpart of
``disentangled_multimodal_learning_tpu/utils/logging.py:11 Logger``): wandb
when ``cfg.wandb`` is set and ``wandb`` imports (project
"MultiScale_TMI25", the reference's), else a JSONL file
``run_<int(time)>.jsonl`` in ``cfg.log_dir``, one ``{"t": time, ...}``
line per :meth:`Logger.log`; nothing at all under ``cfg.debug``.  Falling
back from wandb to the file is JAX's own behaviour."""

from __future__ import annotations

import dataclasses
import json
import os
import time


class Logger:
    def __init__(self, cfg, project: str = "MultiScale_TMI25"):
        self.cfg = cfg
        self.path = None
        self._wandb = None
        self._fh = None
        if getattr(cfg, "debug", False):
            return
        if getattr(cfg, "wandb", False):
            try:
                import wandb

                self._wandb = wandb.init(project=project, notes=project,
                                         tags=["TMI25", "MultiScale"],
                                         config=self.run_config())
                return
            except Exception:
                self._wandb = None
        log_dir = getattr(cfg, "log_dir", "./logs")
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"run_{int(time.time())}.jsonl")
        self._fh = open(self.path, "a")

    def run_config(self) -> dict:
        """The experiment parameters recorded with the run; never None."""
        if dataclasses.is_dataclass(self.cfg):
            return dataclasses.asdict(self.cfg)
        return dict(vars(self.cfg))

    def log(self, payload: dict) -> None:
        """Write ``payload``; tensors, numpy scalars and anything else
        ``float`` takes become floats."""
        def to_py(x):
            try:
                return float(x)
            except (TypeError, ValueError):
                return x

        payload = json.loads(json.dumps(payload, default=to_py))
        if self._wandb is not None:
            self._wandb.log(payload)
        elif self._fh is not None:
            self._fh.write(json.dumps({"t": time.time(), **payload}) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
