"""Checkpoints in the JAX package's directory format, and best-metric
tracking (the port of ``outfitx_tpu/train/checkpoint.py``, synchronous
saves only).

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
restores this package's checkpoints. The optimizer state is this package's
own subtree: ``count`` and the Adam moments ``mu`` and ``nu`` keyed by
state-dict name.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from outfitx_tpu_torch.models.from_jax import (
    jax_params_from_state_dict,
    read_checkpoint_tree,
    state_dict_from_jax,
)


def optimizer_tree(model: torch.nn.Module, optimizer) -> Dict[str, Any]:
    """The optimizer's state as a tree keyed by parameter name."""
    names = {id(p): n for n, p in model.named_parameters()}
    state = optimizer.state_dict()

    def keyed(moments):
        return {
            names[id(p)]: m.detach().cpu().numpy()
            for p, m in zip(optimizer.params, moments)
        }

    return {
        "count": np.asarray(state["count"], dtype=np.int32),
        "mu": keyed(state["mu"]),
        "nu": keyed(state["nu"]),
    }


def load_optimizer_tree(model: torch.nn.Module, optimizer, tree) -> None:
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for p in optimizer.params]
    optimizer.load_state_dict({
        "count": int(np.asarray(tree["count"])),
        "mu": [tree["mu"][n] for n in order],
        "nu": [tree["nu"][n] for n in order],
    })


def _flatten(tree, leaves):
    """Skeleton of ``tree`` with leaves numbered in sorted-key order (the
    order ``jax.tree.flatten`` walks a dict)."""
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    leaves.append(np.asarray(tree).copy(order="C"))  # keeps 0-d leaves 0-d
    return len(leaves) - 1


class CheckpointManager:
    def __init__(self, root: str | pathlib.Path, model_name: str):
        self.dir = pathlib.Path(root).absolute() / model_name
        self.dir.mkdir(parents=True, exist_ok=True)

    def path(self, tag: str) -> pathlib.Path:
        return self.dir / tag

    def exists(self, tag: str) -> bool:
        return self.path(tag).exists()

    def save(
        self,
        tag: str,
        *,
        params: Dict[str, torch.Tensor],
        opt_state: Optional[Dict[str, Any]] = None,
        step: int = 0,
        epoch: int = 0,
        metrics: Optional[Dict[str, float]] = None,
        config: Any = None,
        best: Optional[Dict[str, float]] = None,
    ) -> pathlib.Path:
        """Write ``params`` (an ``OutfitXModel`` state dict) and, when
        given, ``opt_state`` (``optimizer_tree``) under ``tag``, replacing
        any earlier checkpoint of that tag atomically (tmp dir, then a
        rename-aside swap)."""
        path = self.path(tag)
        payload = {"params": jax_params_from_state_dict(params)}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        leaves: list = []
        skeleton = _flatten(payload, leaves)
        specs = [[list(x.shape), str(x.dtype)] for x in leaves]
        meta = {
            "step": int(step),
            "epoch": int(epoch),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        if best:
            meta["best"] = {k: float(v) for k, v in best.items()}
        if config is not None and dataclasses.is_dataclass(config):
            meta["config"] = dataclasses.asdict(config)

        tmp = path.parent / f".{path.name}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        np.savez(
            tmp / "state.npz",
            **{f"leaf_{i}": x.reshape(-1).view(np.uint8) for i, x in enumerate(leaves)},
        )
        with open(tmp / "tree.json", "w", encoding="utf-8") as f:
            json.dump({"skeleton": skeleton, "specs": specs}, f)
        with open(tmp / "meta.json", "w", encoding="utf-8") as f:
            json.dump(meta, f, indent=2, default=str)
        old = path.parent / f".{path.name}.old{os.getpid()}"
        shutil.rmtree(old, ignore_errors=True)
        if path.exists():
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
        return path

    def restore(self, tag_or_path: str | pathlib.Path) -> Dict[str, Any]:
        """{'params': state dict (float32, CPU), 'opt_state': the saved
        optimizer tree or None, 'meta': dict}. Reads this package's
        checkpoints and the JAX package's ``state.npz`` checkpoints (whose
        optimizer subtree is optax's, returned as it is)."""
        path = pathlib.Path(tag_or_path)
        if not path.exists():
            path = self.path(str(tag_or_path))
        raw = read_checkpoint_tree(path)
        meta = {}
        if (path / "meta.json").exists():
            with open(path / "meta.json", encoding="utf-8") as f:
                meta = json.load(f)
        return {
            "params": state_dict_from_jax(raw["params"]),
            "opt_state": raw.get("opt_state"),
            "meta": meta,
        }


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
