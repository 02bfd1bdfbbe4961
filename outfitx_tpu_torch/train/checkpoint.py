"""Checkpoints in the JAX package's directory format, and best-metric
tracking (the port of ``outfitx_tpu/train/checkpoint.py``).

A checkpoint is a directory holding:
- ``state.npz``: one flat uint8 buffer ``leaf_{i}`` per leaf;
- ``tree.json``: ``skeleton`` (the nested dict with each leaf replaced by
  its index, leaves numbered in sorted-key order) and ``specs`` (each leaf's
  shape and dtype name);
- ``meta.json``: step, epoch, metrics, the best values so far and the
  config.

Parameters are written in the JAX package's tree layout
(``models/from_jax.py:jax_params_from_state_dict``), so either package can
warm-start from a checkpoint of the other, and the JAX ``CheckpointManager``
restores this package's checkpoints. The original-CP trainer's tree is
``{"model": ..., "enc_heads": {"fc", "proj"}}``, as the JAX trainer's. The
optimizer state is this package's own subtree: ``count`` and the Adam
moments ``mu`` and ``nu`` keyed by parameter name.

``save`` writes on the calling thread. ``save_async`` copies every leaf to
the host on the calling thread (a snapshot: the optimizer updates the
parameters in place right after) and queues the file writes for one writer
thread, which touches numpy only. Queued saves are written in order, the
newest of a tag replacing a queued older one; a failed write is raised by
the next ``save_async`` or ``wait``. Both write the same bytes.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import pathlib
import shutil
import threading
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from outfitx_tpu_torch.models.from_jax import (  # noqa: F401 (re-exported)
    jax_params_from_state_dict,
    migrate_legacy_attn,
    read_checkpoint_tree,
    state_dict_from_jax,
)


def optimizer_tree(model: torch.nn.Module, optimizer, full=None) -> Dict[str, Any]:
    """The optimizer's state as a tree keyed by parameter name. ``full(p,
    moment)`` makes a mesh rank's block of a moment whole (a collective:
    every rank calls it)."""
    names = {id(p): n for n, p in model.named_parameters()}
    state = optimizer.state_dict()
    full = full or (lambda p, m: m)

    def keyed(moments):
        return {
            names[id(p)]: full(p, m).detach().cpu().numpy()
            for p, m in zip(optimizer.params, moments)
        }

    return {
        "count": np.asarray(state["count"], dtype=np.int32),
        "mu": keyed(state["mu"]),
        "nu": keyed(state["nu"]),
    }


def load_optimizer_tree(model: torch.nn.Module, optimizer, tree, local=None) -> None:
    """The inverse of ``optimizer_tree``; ``local(p, moment)`` cuts a whole
    moment to a mesh rank's block. Raises ValueError, loading nothing, when
    the moments are not keyed by this model's parameter names: the JAX
    package's optimizer state is optax's tree, and one saved before the QKV
    fusion holds moments of the per-projection wq/wk/wv."""
    names = {id(p): n for n, p in model.named_parameters()}
    want = sorted(names[id(p)] for p in optimizer.params)
    if not (
        isinstance(tree, dict)
        and all(isinstance(tree.get(k), dict) and sorted(tree[k]) == want for k in ("mu", "nu"))
    ):
        raise ValueError(
            "the checkpoint's optimizer state does not match this model's parameters "
            "(a JAX package checkpoint's is optax's; one saved before the QKV fusion "
            "holds per-projection wq/wk/wv moments), so a full resume from it is not "
            "supported: warm-start the parameters into a fresh optimizer instead "
            "(a CIR trainer's warm_start_from, or load_params on "
            "CheckpointManager.restore(...)['params'])"
        )
    local = local or (lambda p, m: m)

    def moments(key):
        return [local(p, np.asarray(tree[key][names[id(p)]])) for p in optimizer.params]

    optimizer.load_state_dict({
        "count": int(np.asarray(tree["count"])),
        "mu": moments("mu"),
        "nu": moments("nu"),
    })


def _flatten(tree, leaves):
    """Skeleton of ``tree`` with leaves numbered in sorted-key order (the
    order ``jax.tree.flatten`` walks a dict). Each leaf is copied to a
    C-ordered host array: a tensor on the card is copied on the calling
    thread, synchronised on the current stream."""
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    leaves.append(np.asarray(tree).copy(order="C"))  # keeps 0-d leaves 0-d
    return len(leaves) - 1


def _savez(path: pathlib.Path, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez`` with a fixed timestamp on each member, so the same
    arrays give the same bytes."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, arr in arrays.items():
            info = zipfile.ZipInfo(f"{name}.npy", date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)


# Snapshots queued for the writer thread live in host memory; a save that
# would take their total past this waits for the writer (one larger save
# is always admitted). One CP envelope state (parameters and both Adam
# moments at d=1536) is about 1.2 GB.
_STAGED_BYTES_MAX = 1_600_000_000


class CheckpointManager:
    def __init__(self, root: str | pathlib.Path, model_name: str):
        self.dir = pathlib.Path(root).absolute() / model_name
        self.dir.mkdir(parents=True, exist_ok=True)
        self._cv = threading.Condition()
        self._pending: Dict[pathlib.Path, Dict[str, Any]] = {}  # newest per tag
        self._order: collections.deque = collections.deque()
        self._inflight = False
        self._staged_bytes = 0  # queued and in-flight snapshots
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def path(self, tag: str) -> pathlib.Path:
        return self.dir / tag

    def exists(self, tag: str) -> bool:
        self.wait()  # a queued save counts once it is on disk
        return self.path(tag).exists()

    # ----------------------------------------------------------- format --
    @staticmethod
    def _stage(
        *,
        params: Dict[str, torch.Tensor],
        enc_heads: Optional[Dict[str, Any]] = None,
        opt_state: Optional[Dict[str, Any]] = None,
        step: int = 0,
        epoch: int = 0,
        metrics: Optional[Dict[str, float]] = None,
        config: Any = None,
        best: Optional[Dict[str, float]] = None,
    ) -> Dict[str, Any]:
        """Every leaf copied to the host, the tree's skeleton and specs,
        and the meta record: all that the files hold."""
        tree = jax_params_from_state_dict(params)
        if enc_heads is not None:
            tree = {"model": tree, "enc_heads": enc_heads}
        payload = {"params": tree}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        leaves: list = []
        skeleton = _flatten(payload, leaves)
        meta = {
            "step": int(step),
            "epoch": int(epoch),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        if best:
            meta["best"] = {k: float(v) for k, v in best.items()}
        if config is not None and dataclasses.is_dataclass(config):
            meta["config"] = dataclasses.asdict(config)
        return {
            "skeleton": skeleton,
            "specs": [[list(x.shape), str(x.dtype)] for x in leaves],
            "leaves": leaves,
            "meta": meta,
            "nbytes": sum(x.nbytes for x in leaves),
        }

    @staticmethod
    def _write(path: pathlib.Path, staged: Dict[str, Any]) -> None:
        """Write a staged checkpoint under ``path``, replacing an earlier
        one atomically (tmp dir, then a rename-aside swap). Host arrays
        only: the writer thread runs this."""
        tmp = path.parent / f".{path.name}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        _savez(
            tmp / "state.npz",
            {f"leaf_{i}": x.reshape(-1).view(np.uint8) for i, x in enumerate(staged["leaves"])},
        )
        with open(tmp / "tree.json", "w", encoding="utf-8") as f:
            json.dump({"skeleton": staged["skeleton"], "specs": staged["specs"]}, f)
        with open(tmp / "meta.json", "w", encoding="utf-8") as f:
            json.dump(staged["meta"], f, indent=2, default=str)
        old = path.parent / f".{path.name}.old{os.getpid()}"
        shutil.rmtree(old, ignore_errors=True)
        if path.exists():
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)

    # ------------------------------------------------------------ saves --
    def save(self, tag: str, **state) -> pathlib.Path:
        """Write ``params`` (an ``OutfitXModel`` state dict), with
        ``enc_heads`` (original-CP's trainable encoder heads, JAX layout)
        and ``opt_state`` (``optimizer_tree``) when given, under ``tag``,
        on this thread. Queued async saves are written first, so none of
        them lands after this one; their failures stay pending for
        ``wait``."""
        self._drain()
        path = self.path(tag)
        self._write(path, self._stage(**state))
        return path

    def save_async(self, tag: str, **state) -> None:
        """``save``, with only the copy to the host on this thread: the
        files are written by the writer thread, in the order saves were
        queued. A queued save of the same tag that has not started is
        replaced by this one. Raises a failure of an earlier async save."""
        self._raise_pending()
        staged = self._stage(**state)
        path = self.path(tag)
        self._ensure_worker()
        with self._cv:
            if path in self._pending:
                self._staged_bytes -= self._pending[path]["nbytes"]
            else:
                while (self._order or self._inflight) and (
                    self._staged_bytes + staged["nbytes"] > _STAGED_BYTES_MAX
                ):
                    self._cv.wait()
                self._order.append(path)
            self._pending[path] = staged
            self._staged_bytes += staged["nbytes"]
            self._cv.notify_all()

    def _ensure_worker(self) -> None:
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._write_loop, name="ckpt-writer", daemon=True
            )
            self._worker.start()

    def _write_loop(self) -> None:
        while True:
            with self._cv:
                while not self._order:
                    self._cv.wait()
                path = self._order.popleft()
                staged = self._pending.pop(path)
                self._inflight = True
            try:
                self._write(path, staged)
            except Exception as e:  # raised by the next wait or save_async
                self._error = e
            finally:
                with self._cv:
                    self._inflight = False
                    self._staged_bytes -= staged["nbytes"]
                    self._cv.notify_all()

    def _drain(self) -> None:
        """Block until every queued save is on disk."""
        with self._cv:
            while self._order or self._inflight:
                self._cv.wait()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def wait(self) -> None:
        """Block until every queued save is on disk; raise a writer
        failure."""
        self._drain()
        self._raise_pending()

    def restore(self, tag_or_path: str | pathlib.Path) -> Dict[str, Any]:
        """{'params': state dict (float32, CPU) of the set transformer,
        'opt_state': the saved optimizer tree or None, 'meta': dict}, and
        'enc_heads' (the JAX tree, numpy) where the checkpoint is
        original-CP's. Reads this package's checkpoints and the JAX
        package's ``state.npz`` checkpoints (whose optimizer subtree is
        optax's, returned as it is), those from before the QKV fusion
        included (``migrate_legacy_attn``). Waits for queued saves first."""
        self.wait()
        path = pathlib.Path(tag_or_path)
        if not path.exists():
            path = self.path(str(tag_or_path))
        raw = read_checkpoint_tree(path)
        meta = {}
        if (path / "meta.json").exists():
            with open(path / "meta.json", encoding="utf-8") as f:
                meta = json.load(f)
        params = raw["params"]
        out = {
            "params": state_dict_from_jax(params.get("model", params)),
            "opt_state": raw.get("opt_state"),
            "meta": meta,
        }
        if "enc_heads" in params:
            out["enc_heads"] = params["enc_heads"]
        return out


class BestMetricTracker:
    """Best value so far of each tracked metric ('max' or 'min')."""

    def __init__(self, **metrics_mode: str):
        self.mode = metrics_mode
        self.best: Dict[str, float] = {}

    def update(self, name: str, value: float) -> bool:
        mode = self.mode[name]
        cur = self.best.get(name)
        better = (
            cur is None
            or (mode == "max" and value > cur)
            or (mode == "min" and value < cur)
        )
        if better:
            self.best[name] = float(value)
        return better
