"""Trainer harness (the port of ``outfitx_tpu/train/harness.py``).

A context manager with ``run()``, abstract hooks and the checkpoint and
metric gateways. There is no mesh: a trainer runs on one device, the card
by default (``device="cuda"``, which raises without one) or the CPU when
asked. Checkpoint saves are synchronous.

Usage::

    with CPTrainer(cfg, model_cfg, device="cuda") as t:
        t.run()
"""

from __future__ import annotations

import abc
import contextlib
import logging
import pathlib
import sys
import time
from typing import Any, Dict, Optional

import torch

from outfitx_tpu_torch.core.config import TrainConfig
from outfitx_tpu_torch.core.device import resolve_device
from outfitx_tpu_torch.train.checkpoint import (
    BestMetricTracker,
    CheckpointManager,
    load_optimizer_tree,
    optimizer_tree,
)
from outfitx_tpu_torch.train.metrics_log import MetricsLogger

RUN_MODES = ("train-valid", "test", "custom")


class Trainer(abc.ABC):
    def __init__(
        self,
        cfg: TrainConfig,
        run_mode: str = "train-valid",
        *,
        device: str | torch.device = "cuda",
    ):
        if run_mode not in RUN_MODES:
            raise ValueError(f"run_mode {run_mode!r} not in {RUN_MODES}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.run_mode = run_mode
        self.epoch = 0
        self.state = None  # TrainState, set by load_optimizer
        self.logger: Optional[logging.Logger] = None
        self.ckpt: Optional[CheckpointManager] = None
        self.best = BestMetricTracker(**self.best_metrics())
        self.metrics_log: Optional[MetricsLogger] = None

    # ------------------------------------------------------------ hooks --
    @property
    @abc.abstractmethod
    def model_name(self) -> str: ...

    def best_metrics(self) -> Dict[str, str]:
        """metric -> 'max'|'min' for best-checkpoint tracking."""
        return {}

    @abc.abstractmethod
    def load_model(self) -> None: ...

    @abc.abstractmethod
    def load_optimizer(self) -> None: ...

    @abc.abstractmethod
    def setup_data(self) -> None: ...

    def hook_after_setup(self) -> None:
        """Warm-start / checkpoint chaining point."""

    @abc.abstractmethod
    def train_epoch(self, epoch: int) -> Dict[str, float]: ...

    @abc.abstractmethod
    def valid_epoch(self, epoch: int) -> Dict[str, float]: ...

    def test(self) -> Dict[str, float]:
        raise NotImplementedError(f"{type(self).__name__} has no test mode")

    def custom_task(self) -> Any:
        raise NotImplementedError(f"{type(self).__name__} has no custom task")

    # ------------------------------------------------------------ setup --
    def setup(self) -> None:
        self.setup_logger()
        self.metrics_log = MetricsLogger(self.cfg.log_dir, self.model_name)
        self.ckpt = CheckpointManager(self.cfg.checkpoint_dir, self.model_name)
        self.load_model()
        # Data before optimizer: the OneCycle horizon needs len(train_split).
        self.setup_data()
        self.load_optimizer()
        self.hook_after_setup()
        self.log(f"device: {self.device}")

    def setup_logger(self) -> None:
        self.logger = logging.getLogger(f"{self.model_name}.torch")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        if not self.logger.handlers:
            fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
            sh = logging.StreamHandler(sys.stderr)
            sh.setFormatter(fmt)
            self.logger.addHandler(sh)
            log_dir = pathlib.Path(self.cfg.log_dir)
            log_dir.mkdir(parents=True, exist_ok=True)
            fh = logging.FileHandler(log_dir / f"{self.model_name}.log")
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)

    # -------------------------------------------------------------- run --
    def run(self) -> Any:
        if self.run_mode == "train-valid":
            result = None
            for epoch in range(self.epoch, self.cfg.n_epochs):
                self.epoch = epoch
                t0 = time.perf_counter()
                train_metrics = dict(self.train_epoch(epoch) or {})
                valid_metrics = self.valid_epoch(epoch)
                dt = time.perf_counter() - t0
                if train_metrics:
                    train_metrics["epoch_seconds"] = dt
                self.log_metrics("train", epoch, train_metrics)
                self.log_metrics("valid", epoch, valid_metrics)
                self.log(f"epoch {epoch} done in {dt:.1f}s")
                self.maybe_save_latest(epoch)
                result = valid_metrics
            return result
        if self.run_mode == "test":
            metrics = self.test()
            self.log_metrics("test", self.epoch, metrics)
            return metrics
        return self.custom_task()

    # ---------------------------------------------------------- logging --
    def log(self, msg: str, level: int = logging.INFO) -> None:
        if self.logger:
            self.logger.log(level, msg)

    def log_metrics(self, split: str, epoch: int, metrics: Dict[str, float]) -> None:
        """One JSONL record per split and epoch."""
        if not metrics:
            return
        parts = " ".join(f"{k}={v:.5f}" for k, v in metrics.items())
        self.log(f"[{split}] epoch {epoch}: {parts}")
        if self.metrics_log is not None:
            self.metrics_log.log(split, epoch, metrics)

    # ------------------------------------------------------ checkpoints --
    def _save(self, tag: str, *, with_optimizer: bool, **kwargs) -> None:
        model = self.state.model
        self.ckpt.save(
            tag,
            params=model.state_dict(),
            opt_state=(
                optimizer_tree(model, self.state.optimizer) if with_optimizer else None
            ),
            step=self.state.step,
            config=self.cfg,
            best=self.best.best,
            **kwargs,
        )

    def maybe_save_best(self, metrics: Dict[str, float], *, epoch: int) -> None:
        for name, value in metrics.items():
            if name in self.best.mode and self.best.update(name, value):
                self._save(
                    f"best_{name}", with_optimizer=False, epoch=epoch, metrics=metrics
                )
                self.log(f"saved best_{name} ({value:.5f}) at epoch {epoch}")

    def maybe_save_latest(self, epoch: int) -> None:
        """Rolling resume point every ``cfg.save_every_epochs`` epochs."""
        every = self.cfg.save_every_epochs
        if not every or (epoch + 1) % every or self.state is None:
            return
        self._save("latest", with_optimizer=True, epoch=epoch)
        self.log(f"saved latest (epoch {epoch})")

    def resume(self, tag_or_path: str = "final") -> None:
        """Restore parameters (and optimizer state, step and epoch when
        saved) and continue from the next epoch."""
        payload = self.ckpt.restore(tag_or_path)
        model = self.state.model
        model.load_state_dict(payload["params"])
        if payload["opt_state"] is not None:
            load_optimizer_tree(model, self.state.optimizer, payload["opt_state"])
            self.state.step = int(payload["meta"].get("step", 0))
        self.epoch = int(payload["meta"].get("epoch", -1)) + 1
        for name, value in payload["meta"].get("best", {}).items():
            if name in self.best.mode:
                self.best.best[name] = float(value)
        self.log(f"resumed from {tag_or_path} at epoch {self.epoch}")

    # ---------------------------------------------------------- context --
    def __enter__(self) -> "Trainer":
        self.setup()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if (
                exc_type is None
                and self.run_mode == "train-valid"
                and self.state is not None
            ):
                self._save("final", with_optimizer=True, epoch=self.epoch)
                self.log("saved final checkpoint")
        finally:
            if self.metrics_log is not None:
                self.metrics_log.close()
            if self.logger is not None:
                for h in list(self.logger.handlers):
                    with contextlib.suppress(OSError):
                        h.close()
                    self.logger.removeHandler(h)
