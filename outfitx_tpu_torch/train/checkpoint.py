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
(``params_tree``: ``models/from_jax.py:jax_params_from_state_dict``), so
either package can warm-start from a checkpoint of the other, and the JAX
``CheckpointManager`` restores this package's checkpoints. The original-CP
trainer's tree is ``{"model": ..., "enc_heads": {"fc", "proj"}}``, as the
JAX trainer's. The optimizer state is in optax's layout, the one the JAX
package writes for ``chain(clip_by_global_norm, adamw(schedule))``
(``optax_state``): ``[[], [[count, mu, nu], [], [count]]]``, the Adam
moments ``mu`` and ``nu`` trees of the parameters' layout, made by the same
mapping as the parameters, and both counts 0-d int32. So a run resumes in
either package from the other's checkpoint (``load_optimizer_tree``), and
the JAX manager's ``restore(template=...)``, which unflattens by leaf order,
finds its leaves where it expects them. Checkpoints this package wrote
before it wrote optax's layout (``{"count", "mu", "nu"}``, the moments keyed
by parameter name) still load.

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


def params_tree(params: Dict[str, Any], enc_heads: Optional[Dict[str, Any]] = None):
    """The JAX package's parameter tree of an ``OutfitXModel`` state dict,
    and of original-CP's encoder heads (JAX layout) where given."""
    tree = jax_params_from_state_dict(params)
    return tree if enc_heads is None else {"model": tree, "enc_heads": enc_heads}


def params_payload(tree) -> Dict[str, Any]:
    """The inverse of ``params_tree``, as ``restore`` returns it:
    ``{"params": state dict}``, with ``"enc_heads"`` for original-CP's
    tree."""
    out = {"params": state_dict_from_jax(tree.get("model", tree))}
    if "enc_heads" in tree:
        out["enc_heads"] = tree["enc_heads"]
    return out


def optax_state(count, mu, nu) -> list:
    """The state of the JAX package's optimizer, ``optax.chain(
    clip_by_global_norm, adamw(schedule))``, as its manager writes it, the
    NamedTuples as index-ordered lists: ``(EmptyState(),
    (ScaleByAdamState(count, mu, nu), EmptyState(),
    ScaleByScheduleState(count)))``, the clip's and the weight decay's states
    empty. This package's AdamW keeps one count for the bias correction and
    the schedule, so both counts take it."""
    count = np.asarray(count, dtype=np.int32)
    return [[], [[count, mu, nu], [], [count.copy()]]]


def adam_state(tree):
    """``(count, mu, nu)`` of a saved optimizer state: optax's layout
    (``optax_state``, with the moments in the parameters' tree layout), or
    this package's layout before it (``{"count", "mu", "nu"}``, the moments
    keyed by parameter name). Raises ValueError for any other tree, and
    where optax's two counts differ."""
    if isinstance(tree, dict) and {"count", "mu", "nu"} <= set(tree):
        return int(np.asarray(tree["count"])), tree["mu"], tree["nu"]
    try:
        clip, (adam, decay, (sched_count,)) = tree
        count, mu, nu = adam
    except (TypeError, ValueError):
        raise ValueError(_MISMATCH) from None
    if not all(isinstance(x, list) and not x for x in (clip, decay)):
        raise ValueError(_MISMATCH)
    count, sched_count = int(np.asarray(count)), int(np.asarray(sched_count))
    if count != sched_count:
        raise ValueError(
            f"the checkpoint's Adam count {count} and schedule count {sched_count} "
            "differ: this package's optimizer keeps one count for both"
        )
    return count, mu, nu


_MISMATCH = (
    "the checkpoint's optimizer state does not match this model's parameters "
    "(one saved before the QKV fusion holds per-projection wq/wk/wv moments), "
    "so a full resume from it is not supported: warm-start the parameters "
    "into a fresh optimizer instead (a CIR trainer's warm_start_from, or "
    "load_params on CheckpointManager.restore(...)['params'])"
)


def _size(tree) -> int:
    if isinstance(tree, dict):
        return sum(_size(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_size(v) for v in tree)
    return int(np.prod(np.shape(tree)))


def optimizer_tree(model: torch.nn.Module, optimizer, full=None, to_tree=None) -> list:
    """The optimizer's state in optax's layout (``optax_state``). ``full(p,
    moment)`` makes a mesh rank's block of a moment whole (a collective:
    every rank calls it); ``to_tree`` maps the moments, keyed by
    parameter name in ``model``, as it maps the parameters (default
    ``params_tree``, for an ``OutfitXModel``)."""
    names = {id(p): n for n, p in model.named_parameters()}
    state = optimizer.state_dict()
    full = full or (lambda p, m: m)
    to_tree = to_tree or params_tree

    def tree(moments):
        return to_tree({names[id(p)]: full(p, m) for p, m in zip(optimizer.params, moments)})

    return optax_state(state["count"], tree(state["mu"]), tree(state["nu"]))


def load_optimizer_tree(
    model: torch.nn.Module, optimizer, tree, local=None, named=None
) -> None:
    """The inverse of ``optimizer_tree``, from either layout that
    ``adam_state`` reads; ``local(p, moment)`` cuts a whole moment to a mesh
    rank's block, and ``named`` maps a moment's tree as the parameters'
    (default ``params_payload(tree)["params"]``, for an ``OutfitXModel``).
    Raises ValueError, loading nothing, when the counts differ or the
    moments do not cover exactly this model's trainable parameters with
    their shapes (an optax state saved before the QKV fusion holds moments
    of the per-projection wq/wk/wv)."""
    names = {id(p): n for n, p in model.named_parameters()}
    want = sorted(names[id(p)] for p in optimizer.params)
    named = named or (lambda t: params_payload(t)["params"])
    local = local or (lambda p, m: m)
    count, *trees = adam_state(tree)
    moments = []
    for t in trees:
        try:  # a name-keyed moment is this package's layout before optax's
            by_name = t if isinstance(t, dict) and sorted(t) == want else named(t)
            ms = [local(p, torch.as_tensor(by_name[names[id(p)]])) for p in optimizer.params]
        except (KeyError, TypeError, AttributeError, IndexError, RuntimeError):
            raise ValueError(_MISMATCH) from None
        if (
            sorted(by_name) != want
            or _size(t) != _size(by_name)  # a leaf the mapping left out
            or any(m.shape != p.shape for p, m in zip(optimizer.params, ms))
        ):
            raise ValueError(_MISMATCH)
        moments.append(ms)
    optimizer.load_state_dict({"count": count, "mu": moments[0], "nu": moments[1]})


def _flatten(tree, leaves):
    """Skeleton of ``tree`` with leaves numbered in the order
    ``jax.tree.flatten`` walks it: a dict's values in sorted-key order, a
    list's in order (an empty one stays ``[]``, an optax ``EmptyState``).
    Each leaf is copied to a C-ordered host array: a tensor on the card is
    copied on the calling thread, synchronised on the current stream."""
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, leaves) for v in tree]
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
        payload = {"params": params_tree(params, enc_heads)}
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
        'opt_state': the saved optimizer tree as it is (``adam_state``
        reads it) or None, 'meta': dict}, and 'enc_heads' (the JAX tree,
        numpy) where the checkpoint is original-CP's (``params_payload``).
        Reads this package's checkpoints and the JAX package's
        ``state.npz`` checkpoints, those from before the QKV fusion included
        (``migrate_legacy_attn`` on the parameters). Waits for queued saves
        first."""
        self.wait()
        path = pathlib.Path(tag_or_path)
        if not path.exists():
            path = self.path(str(tag_or_path))
        raw = read_checkpoint_tree(path)
        meta = {}
        if (path / "meta.json").exists():
            with open(path / "meta.json", encoding="utf-8") as f:
                meta = json.load(f)
        return {**params_payload(raw["params"]), "opt_state": raw.get("opt_state"), "meta": meta}


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
