"""Trainer harness (the port of ``outfitx_tpu/train/harness.py``).

A context manager with ``run()``, abstract hooks and the checkpoint and
metric gateways. A trainer runs on the card by default (``device="cuda"``,
which raises without one) or the CPU when asked. ``cfg.mesh`` lays out a
training mesh of one process per position (``parallel.setup_parallel``,
under ``torchrun`` or any launcher that sets RANK and WORLD_SIZE): each
process runs the same trainer, holds its blocks of the weights
(``shard_model_params``) and its rows of each batch, and only rank 0 logs
and writes checkpoints, which hold the whole tree (gathered on the training
thread, since the gather is a collective). Mid-run saves (best metrics,
the rolling ``latest``) go through the checkpoint writer thread when
``cfg.async_saves``; the final save is
synchronous, after the queue is written. ``profile_dir`` set, epoch 1 (the
second; the first pays the kernels' builds) is traced by ``torch.profiler``
into a Chrome trace there, and the port's spans in it are logged.

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

from outfitx_tpu_torch.core import trace
from outfitx_tpu_torch.core.config import TrainConfig
from outfitx_tpu_torch.core.device import resolve_device
from outfitx_tpu_torch.core.mesh import DATA_AXIS
from outfitx_tpu_torch.parallel import gather_global, setup_parallel
from outfitx_tpu_torch.train.checkpoint import (
    BestMetricTracker,
    CheckpointManager,
    load_optimizer_tree,
    optimizer_tree,
    params_payload,
    params_tree,
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
        self.par = None  # ParallelContext under a mesh, set by setup_mesh
        self.logger: Optional[logging.Logger] = None
        self.ckpt: Optional[CheckpointManager] = None
        self.best = BestMetricTracker(**self.best_metrics())
        self.metrics_log: Optional[MetricsLogger] = None
        self.profile_dir: Optional[str] = None  # set to trace epoch 1

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
        self.setup_mesh()
        self.setup_logger()
        if self.is_writer:
            self.metrics_log = MetricsLogger(self.cfg.log_dir, self.model_name)
        self.ckpt = CheckpointManager(self.cfg.checkpoint_dir, self.model_name)
        self.load_model()
        # Data before optimizer: the OneCycle horizon needs len(train_split).
        self.setup_data()
        self.load_optimizer()
        self.hook_after_setup()
        self.log(f"device: {self.device}")
        if self.par is not None:
            self.log(
                f"mesh: data={self.par.data} model={self.par.model} "
                f"fsdp={self.par.fsdp}, backend {self.par.backend}"
            )

    def setup_logger(self) -> None:
        self.logger = logging.getLogger(f"{self.model_name}.torch")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        if not self.is_writer:
            self.logger.setLevel(logging.WARNING)
        elif not self.logger.handlers:
            fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
            sh = logging.StreamHandler(sys.stderr)
            sh.setFormatter(fmt)
            self.logger.addHandler(sh)
            log_dir = pathlib.Path(self.cfg.log_dir)
            log_dir.mkdir(parents=True, exist_ok=True)
            fh = logging.FileHandler(log_dir / f"{self.model_name}.log")
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)

    def setup_mesh(self) -> None:
        """This process's place in ``cfg.mesh`` (none on one device)."""
        self.par = setup_parallel(self.cfg.mesh, self.device)
        if self.par is not None:
            self.device = self.par.device

    @property
    def is_writer(self) -> bool:
        """Rank 0 (or the only process): the one that logs and writes."""
        return self.par is None or self.par.rank == 0

    def shard_model_params(self, model):
        """Under a mesh, cut ``model``'s weights to this rank's blocks (pure
        DP keeps them whole) and run it on its rows of each batch."""
        if self.par is not None:
            model.shard_(self.par)
        return model

    def full_params(self, module) -> Dict[str, Any]:
        """``module``'s state dict with every split weight whole."""
        if self.par is None:
            return module.state_dict()
        return self.par.full_state_dict(module)

    def load_params(self, module, sd) -> None:
        """Load a whole state dict onto ``module``'s live blocks."""
        if self.par is not None:
            sd = self.par.local_state_dict(module, sd)
        module.load_state_dict(sd, strict=True)

    def rows(self, batch):
        """This rank's rows of a global batch (a dict of tensors)."""
        return batch if self.par is None else self.par.batch_rows(batch)

    def gather_rows(self, t):
        """Every data rank's rows of ``t``, in row order (a collective)."""
        if self.par is None:
            return t
        return gather_global(t, group=self.par.groups[DATA_AXIS])

    # -------------------------------------------------------------- run --
    def run(self) -> Any:
        if self.run_mode == "train-valid":
            result = None
            for epoch in range(self.epoch, self.cfg.n_epochs):
                self.epoch = epoch
                with self._profiled(epoch):
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

    @contextlib.contextmanager
    def _profiled(self, epoch: int):
        """A torch.profiler trace of epoch 1 into ``profile_dir``, and a
        line in the log for each of the port's spans (``core/trace.py``)
        recorded in it: calls, host ms and device ms in all."""
        if self.profile_dir is None or epoch != 1:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        trace.clear()
        with profile(activities=activities) as prof:
            yield
        out = pathlib.Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{self.model_name}_epoch{epoch}.trace.json"
        prof.export_chrome_trace(str(path))
        self.log(f"profiler trace written to {path}")
        for name, (count, host_s, device_s) in trace.totals(trace.records()).items():
            device = "-" if device_s is None else f"{device_s * 1e3:.3f}"
            self.log(f"span {name}: {count} calls, host {host_s * 1e3:.3f} ms, "
                     f"device {device} ms")

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
    def checkpoint_params(self, named=None) -> Dict[str, Any]:
        """What a checkpoint holds of the parameters, as
        ``CheckpointManager.save`` takes it. ``named`` (a tensor for each of
        the optimizer's parameters, keyed by its name in ``state.model``:
        an Adam moment) takes the parameters' place, so that the moments
        are written in the parameters' layout."""
        return {"params": self.full_params(self.state.model) if named is None else named}

    def named_params(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """The inverse of ``checkpoint_params(named)``: ``restore``'s
        payload (or a moment's, ``params_payload``) keyed by
        ``state.model``'s parameter names."""
        return payload["params"]

    def load_checkpoint_params(self, payload: Dict[str, Any]) -> None:
        """The inverse of ``checkpoint_params``, from ``restore``'s
        payload."""
        self.load_params(self.state.model, payload["params"])

    def _save(self, tag: str, *, with_optimizer: bool, sync: bool = False, **kwargs) -> None:
        """Save through the writer thread when ``cfg.async_saves``, unless
        ``sync``. Under a mesh every rank gathers the whole state (a
        collective) and rank 0 writes it."""
        full = self.par.full if self.par is not None else None
        params = self.checkpoint_params()
        opt_state = None
        if with_optimizer:
            opt_state = optimizer_tree(
                self.state.model, self.state.optimizer, full,
                lambda named: params_tree(**self.checkpoint_params(named)),
            )
        if not self.is_writer:
            return
        save = self.ckpt.save if sync or not self.cfg.async_saves else self.ckpt.save_async
        save(
            tag,
            **params,
            opt_state=opt_state,
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
        saved) and continue from the next epoch, from a checkpoint of either
        package. An optimizer state that does not fit this model (one from
        before the QKV fusion) raises before anything is loaded."""
        payload = self.ckpt.restore(tag_or_path)
        if payload["opt_state"] is not None:
            load_optimizer_tree(
                self.state.model, self.state.optimizer, payload["opt_state"],
                self.par.local if self.par is not None else None,
                lambda tree: self.named_params(params_payload(tree)),
            )
            self.state.step = int(payload["meta"].get("step", 0))
        self.load_checkpoint_params(payload)
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
            # Queued saves reach the disk first, even on an exception. A
            # failed one does not stop the final save (the live state is
            # sound); it is raised after it.
            pending_err = None
            if self.ckpt is not None:
                try:
                    self.ckpt.wait()
                except RuntimeError as e:
                    if exc_type is None:
                        pending_err = e
            if (
                exc_type is None
                and self.run_mode == "train-valid"
                and self.state is not None
            ):
                self._save("final", with_optimizer=True, sync=True, epoch=self.epoch)
                self.log("saved final checkpoint")
            if self.par is not None and exc_type is None:
                import torch.distributed as dist

                dist.barrier()  # rank 0's files exist before any rank goes on
            if pending_err is not None:
                raise pending_err
        finally:
            if self.metrics_log is not None:
                self.metrics_log.close()
            if self.logger is not None:
                for h in list(self.logger.handlers):
                    with contextlib.suppress(OSError):
                        h.close()
                    self.logger.removeHandler(h)
