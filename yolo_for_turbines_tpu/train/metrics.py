"""Metrics sink: W&B when available, JSONL + stdout otherwise.

The reference logs everything to wandb (reference: code/train.py:87-90,
133-136, 149-153). wandb is optional here: the same `log` calls fan out to
whichever sinks exist, so training is observable on air-gapped hosts.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, project: str, config: Optional[dict] = None, out_dir="."):
        self.project = project
        self.t0 = time.time()
        self._wandb = None
        try:  # optional dependency
            import wandb

            self._wandb = wandb
            wandb.init(project=project, config=config)
        except Exception:
            self._wandb = None
        self.path = Path(out_dir) / f"{project}_metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")
        if config:
            self.log({"config": config})

    def log(self, metrics: Dict) -> None:
        record = {"t": round(time.time() - self.t0, 3)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics)

    def log_model(self, path, name: str) -> None:
        if self._wandb is not None:
            self._wandb.log_model(str(path), name=name)

    def finish(self) -> None:
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
