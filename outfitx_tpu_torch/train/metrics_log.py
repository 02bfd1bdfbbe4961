"""Structured metrics sink: one JSONL file per run (the port of
``outfitx_tpu/train/metrics_log.py``, without the optional wandb sink)."""

from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str | pathlib.Path, run_name: str):
        self.path = pathlib.Path(log_dir) / f"{run_name}_metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")

    def log(
        self, split: str, epoch: int, metrics: Dict[str, float], step: Optional[int] = None
    ) -> None:
        rec = {
            "ts": time.time(),
            "split": split,
            "epoch": epoch,
            **({"step": step} if step is not None else {}),
            **{k: float(v) for k, v in metrics.items()},
        }
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
