"""Serving engine: CP, CIR, FITB and similar-item requests over a
device-resident catalog (the port of ``outfitx_tpu/serve/engine.py``).

Holds a CP model and a CIR model (FITB shares the CIR model; one model when
both are given the same parameters), the catalog on the device and the
per-category candidate pools, and serves:
- CP: sigmoid compatibility scores;
- CIR: top-10 retrieval against the target category's pool, or against the
  whole catalog when the category has none;
- FITB: argmin over the candidates;
- similar items: nearest catalog neighbours of an item.

The sibling modules carry the rest behind the same ``ServingEngine``:
- serve/programs.py    the task functions, the whole-catalog route matrix
                       ({dense, int8} x {materialised, chunked, mesh-sharded}),
                       the warmup
- serve/batched.py     the batched request forms
- serve/live_update.py live catalog updates and appends
- serve/browse.py      dataset-sample browsing views

Top-k is exact on every route (``approx_topk`` is accepted; see
``ops/retrieval.py``). ``quantize_model`` serves the int8 (W8A8) twin of
each model (``models/quantized.py``). With ``mesh`` the catalog (dense or
int8) is row-sharded over the mesh's data axis (``ops/retrieval_sharded.py``):
each shard lives on its device, whole-catalog retrieval takes a top-k per
shard and merges on the engine's device, and the models stay on the
engine's device, where a request's rows are gathered from their shards.
"""

from __future__ import annotations

import dataclasses
import pathlib
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from outfitx_tpu_torch.core.config import OutfitXConfig
from outfitx_tpu_torch.core.device import resolve_device
from outfitx_tpu_torch.data.catalog import Catalog
from outfitx_tpu_torch.data.sampler import CandidatePools
from outfitx_tpu_torch.data.splits import CPSplit, FITBSplit, OutfitSplit, _pad_outfits
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.models.quantized import QuantizedOutfitX, quantize_outfitx_params
from outfitx_tpu_torch.ops.quantization import quantize_catalog
from outfitx_tpu_torch.serve.batched import BatchedRequests
from outfitx_tpu_torch.serve.browse import BrowseViews
from outfitx_tpu_torch.serve.live_update import LiveCatalogUpdates
from outfitx_tpu_torch.serve.programs import (
    CatalogRoute,
    TaskPrograms,
    cir_pool_task,
    cir_task,
    cp_task,
    fitb_task,
    sim_task,
)

_CATALOG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class UnknownItemError(KeyError):
    """Raised for item ids absent from the catalog."""


class _LockedRng:
    """``np.random.Generator`` is documented not thread-safe; the engine's
    sample and mock draws run on the HTTP server's handler threads, so the
    shared generator sits behind one lock (draws are tiny host work)."""

    def __init__(self, rng):
        self._rng = rng
        self._lock = threading.Lock()

    def choice(self, *a, **k):
        with self._lock:
            return self._rng.choice(*a, **k)

    def integers(self, *a, **k):
        with self._lock:
            return self._rng.integers(*a, **k)

    def random(self, *a, **k):
        with self._lock:
            return self._rng.random(*a, **k)


@dataclasses.dataclass
class ServingEngine(TaskPrograms, BatchedRequests, LiveCatalogUpdates, BrowseViews):
    model_cfg: OutfitXConfig
    catalog: Catalog
    # OutfitXModel state dicts (models/from_jax.py turns JAX parameters
    # into one). Pass the same object twice to share one model.
    cp_params: Optional[Dict[str, torch.Tensor]] = None
    cir_params: Optional[Dict[str, torch.Tensor]] = None
    pools: Optional[CandidatePools] = None
    device: str = "cuda"
    # Model-free answers (random scores and items) for a UI smoke test: no
    # model is built and no device is touched.
    mock: bool = False
    # int8 catalog for whole-catalog retrieval
    quantized: bool = False
    # int8 (W8A8) transformer forward: the params are quantized once at
    # construction (once when CP and CIR share them) and the int8 twin
    # serves every task.
    quantize_model: bool = False
    # Reserve this many spare catalog rows at construction so ``add_items``
    # can append new items at runtime without any shape change. Spare rows
    # hold huge-norm sentinels that can never win a top-k slot, so retrieval
    # sweeps the full capacity safely.
    spare_capacity: int = 0
    # Serve from a device mesh (``core.mesh.make_mesh``): the catalog is
    # row-sharded over its data axis, the rows padded host-side to a
    # multiple of the shard count (pads sit past the PAD row and never
    # win). None = one device (default).
    mesh: Optional[object] = None
    # Device-resident catalog storage dtype. "bfloat16" halves the catalog's
    # device memory and the one-time host-to-device copy. The forward
    # computes in bfloat16 regardless, so the only numeric change is rounding
    # at storage instead of after the gather.
    catalog_dtype: str = "float32"
    # Above this catalog size, whole-catalog retrieval streams the pool in
    # chunks of this many rows instead of materialising (Q, N).
    chunk_threshold: int = 262_144
    # Directory holding {item_id}.jpg files; None disables image URLs.
    images_dir: Optional[str] = None
    # The JAX engine's default is the TPU's approximate top-k. The port
    # accepts the flag and computes the exact top-k either way.
    approx_topk: bool = True
    # Test-split rows for the dataset-sample browsing views; None disables
    # the sample_* surfaces.
    cp_split: Optional[CPSplit] = None
    cir_split: Optional[OutfitSplit] = None
    fitb_split: Optional[FITBSplit] = None
    warmup: bool = True
    # Batched requests run in chunks of exactly this many entries.
    cp_batch_bucket: int = 8
    # Live updates are padded to this many rows per scatter.
    update_bucket: int = 1024
    # The set transformer's attention: "mha", or "block" for the fused
    # attention block (OutfitXModel's attn).
    attn: str = "mha"

    def __post_init__(self):
        if self.quantize_model and self.attn != "mha":
            raise ValueError(
                f"quantize_model has no attn={self.attn!r} route: the int8 "
                "forward runs masked_mha between its int8 products"
            )
        if self.catalog_dtype not in _CATALOG_DTYPES:
            raise ValueError(
                f"catalog_dtype must be one of {sorted(_CATALOG_DTYPES)}, "
                f"got {self.catalog_dtype!r}"
            )
        self._update_lock = threading.Lock()
        self.n_updated_rows = 0  # live-update counters (/api/stats)
        self.n_appended_items = 0
        if self.spare_capacity:
            # Grow the table to [items][sentinel spare rows][PAD]. Splits
            # built against the ungrown catalog hold the old pad index in
            # their padded slots: remap them (the old pad index is outside
            # the item-row range, so a value rewrite is exact).
            old_pad = self.catalog.reserve(self.spare_capacity)
            new_pad = self.catalog.pad_row
            for split in (self.cp_split, self.cir_split, self.fitb_split):
                if split is None:
                    continue
                for attr in ("item_rows", "cand_rows"):
                    arr = getattr(split, attr, None)
                    if arr is not None:
                        arr[arr == old_pad] = new_pad
        self._rng = _LockedRng(np.random.default_rng(0))
        if self.quantize_model and not self.mock:
            # Quantize once; CP and CIR often share one state dict.
            shared = self.cir_params is self.cp_params
            if self.cp_params is not None:
                self.cp_params = quantize_outfitx_params(self.cp_params, self.model_cfg)
            if self.cir_params is not None:
                self.cir_params = (
                    self.cp_params if shared
                    else quantize_outfitx_params(self.cir_params, self.model_cfg)
                )
        self._dev = None
        self.catalog_dev = None
        self._qcat = None
        self.cp_model = self.cir_model = None
        if self.mock:
            return
        self._dev = resolve_device(self.device)
        # The dtype is cast on the host, so a bfloat16 catalog ships half the
        # bytes; the copy is the engine's own (never the host array's memory).
        host = torch.from_numpy(self.catalog.embeddings)
        cast = host.to(_CATALOG_DTYPES[self.catalog_dtype])
        if self.mesh is not None:
            self._shard_catalog(cast)
        else:
            self.catalog_dev = cast.to(self._dev)
            if self.catalog_dev.data_ptr() == host.data_ptr():  # float32 on the CPU
                self.catalog_dev = host.clone()
        if self.quantized and self.mesh is None:
            # Quantise through pad_row: spare sentinel rows get huge
            # sq_norms (they never win) and appends requantise their rows in
            # place. The PAD row stays out of retrieval anyway.
            self._qcat = quantize_catalog(
                self.catalog_dev, n_rows=self.catalog.pad_row
            )
        n = self.catalog.pad_row
        self._route = CatalogRoute(
            n_rows=n,
            quantized=self.quantized,
            chunked=n > self.chunk_threshold,
            chunk_size=self.chunk_threshold,
            approx=self.approx_topk,
            mesh=self.mesh,
        )
        self.cp_model = self._model(self.cp_params)
        self.cir_model = (
            self.cp_model
            if self.cir_params is self.cp_params
            else self._model(self.cir_params)
        )
        if self.warmup:
            self._warmup()

    def _shard_catalog(self, cast: torch.Tensor) -> None:
        """Row-shard the catalog over the mesh's data axis: pad the rows
        host-side to a multiple of the shard count, then place each block on
        its device. The int8 catalog quantises every row, pads included (to
        zeros), shard by shard: the quantisation is row by row, so that
        equals quantising the padded table in one go."""
        from outfitx_tpu_torch.core.mesh import DATA_AXIS
        from outfitx_tpu_torch.ops.retrieval_sharded import (
            ShardedRows,
            pad_rows_to_shards,
            shard_rows,
        )

        n_pad = pad_rows_to_shards(cast.shape[0], self.mesh.shape[DATA_AXIS])
        if n_pad != cast.shape[0]:
            cast = torch.cat([cast, cast.new_zeros((n_pad - cast.shape[0], cast.shape[1]))])
        self.catalog_dev = shard_rows(cast, self.mesh)
        if self.quantized:
            parts = [quantize_catalog(s) for s in self.catalog_dev.shards]
            self._qcat = type(parts[0])(*(
                ShardedRows([getattr(p, f) for p in parts])
                for f in ("values", "scales", "sq_norms")
            ))

    def _model(self, state_dict) -> Optional[OutfitXModel | QuantizedOutfitX]:
        if state_dict is None:
            return None
        if self.quantize_model:
            model = QuantizedOutfitX(self.model_cfg, device=self._dev)
        else:
            model = OutfitXModel(self.model_cfg, device=self._dev, attn=self.attn)
        model.load_state_dict(state_dict, strict=True)
        return model.eval()

    def _run(self, task, *args):
        """Run a task function with its numpy arguments moved to the device
        (row indices as int64), its device work enqueued under the update
        lock.

        ``update_items`` and ``add_items`` write catalog rows in place under
        the same lock, and everything goes to the one CUDA stream, which
        runs in order: a request's gather and its whole-catalog distances
        see the same catalog, wholly before or wholly after an update. The
        lock is held for the enqueue only; the caller waits for the result
        (``.cpu()``) outside it. On the CPU the work itself runs under the
        lock. The JAX engine's bounded retry around a 'deleted' buffer has
        no counterpart: there a scatter donates the old catalog buffer and a
        request that captured it must capture again; here no buffer is ever
        given away, so a request cannot lose a race."""
        moved = []
        for a in args:
            if isinstance(a, np.ndarray):
                t = torch.from_numpy(a)
                if t.dtype == torch.int32:
                    t = t.long()
                a = t.to(self._dev)
            moved.append(a)
        with self._update_lock, torch.inference_mode():
            return task(*moved)

    def lookup_row(self, item_id: int) -> int:
        row = self.catalog.id_to_row.get(int(item_id))
        if row is None:
            raise UnknownItemError(f"unknown item_id {item_id}")
        return row

    # ------------------------------------------------------------ tasks --
    def _pad(self, item_ids: List[int]):
        """Host-side row/mask assembly for one outfit."""
        for i in item_ids:
            self.lookup_row(i)  # clear error for unknown ids
        return _pad_outfits(
            self.catalog, [list(item_ids)], self.model_cfg.max_outfit_len
        )

    def cp_score(self, item_ids: List[int]) -> float:
        """Sigmoid compatibility score for one outfit."""
        if self.mock:
            return float(self._rng.random())
        rows, mask = self._pad(item_ids)
        return float(
            self._run(cp_task, self.cp_model, self.catalog_dev, rows, mask)[0]
        )

    def cir_top10(
        self, item_ids: List[int], target_item_id: int
    ) -> List[Dict]:
        """Top-10 complementary items from the target's category pool."""
        if self.mock:
            rows = self._rng.choice(self.catalog.n_items, 10, replace=False)
            return [self._item_info(int(r), 1.0) for r in rows]
        target_row = self.lookup_row(target_item_id)
        cid = int(self.catalog.category_id[target_row])
        rows, mask = self._pad(item_ids)
        trow = np.asarray([target_row], dtype=np.int32)
        pool_rows = self.pools.pools.get(cid) if self.pools is not None else None
        if pool_rows is None:  # whole-catalog retrieval; idx are rows
            d2, idx = self._run(
                cir_task, self.cir_model, self.catalog_dev, self._qcat,
                self._route, rows, mask, trow,
            )
            found = idx.cpu().numpy()[0]
        else:
            d2, idx = self._run(
                cir_pool_task, self.cir_model, self.catalog_dev, rows, mask,
                trow, np.asarray(pool_rows, dtype=np.int32)[None],
            )
            found = np.asarray(pool_rows)[idx.cpu().numpy()[0]]
        # An unfilled spare sentinel is reachable only when fewer real items
        # than k exist (a sentinel never beats a real row): skip it.
        return [
            self._item_info(int(r), float(dist))
            for r, dist in zip(found, d2.cpu().numpy()[0])
            if int(r) < self.catalog.n_items
        ]

    def fitb_pick(
        self, item_ids: List[int], candidate_ids: List[int]
    ) -> int:
        """Index of the best-fitting candidate. The query uses the first
        candidate's text embedding (candidates share a category)."""
        if self.mock:
            return int(self._rng.integers(len(candidate_ids)))
        rows, mask = self._pad(item_ids)
        # The candidate count is bucketed to powers of two (at least 4), as
        # in the JAX engine, so arbitrary client counts run at a handful of
        # shapes. Pads repeat candidate 0's row: a pad's distance equals
        # slot 0's bit for bit, and ``torch.argmin`` returns the first
        # minimal index, so a pad slot can never win.
        cand_rows = self.catalog.rows(candidate_ids)
        bucket = max(4, 1 << (len(cand_rows) - 1).bit_length())
        if len(cand_rows) < bucket:
            cand_rows = np.concatenate(
                [cand_rows, np.repeat(cand_rows[:1], bucket - len(cand_rows))]
            )
        text_row = np.asarray(
            [self.lookup_row(candidate_ids[0])], dtype=np.int32
        )
        return int(
            self._run(
                fitb_task, self.cir_model, self.catalog_dev, rows, mask,
                text_row, cand_rows,
            )[0]
        )

    # ------------------------------------------------------------ util --
    def image_path(self, item_id: int):
        """Filesystem path of the item's jpg, or None (unknown id, no
        ``images_dir``, or file absent)."""
        if self.images_dir is None:
            return None
        p = pathlib.Path(self.images_dir) / f"{int(item_id)}.jpg"
        return p if p.is_file() else None

    def _item_info(self, row: int, score: float) -> Dict:
        item_id = int(self.catalog.item_ids[row])
        info = {
            "item_id": item_id,
            "score": score,
            "category_id": int(self.catalog.category_id[row]),
            "description": (
                self.catalog.descriptions[row]
                if self.catalog.descriptions
                else ""
            ),
        }
        if self.image_path(item_id) is not None:
            info["image_url"] = f"/images/{item_id}.jpg"
        return info

    def similar_items(self, item_id: int, k: int = 10) -> List[Dict]:
        """Nearest catalog neighbours of an item by embedding L2."""
        row = self.lookup_row(item_id)
        if self.mock:  # model-free UI smoke: random neighbours
            rows = self._rng.choice(self.catalog.n_items, k, replace=False)
            return [self._item_info(int(r), 1.0) for r in rows]
        d2, idx = self._run(
            sim_task, self.catalog_dev, self._qcat, self._route,
            np.asarray([row], dtype=np.int32), k + 1,
        )
        out = [
            self._item_info(int(i), float(dist))
            for i, dist in zip(idx.cpu().numpy()[0], d2.cpu().numpy()[0])
            # skip the query item itself and spare sentinels
            if int(i) != row and int(i) < self.catalog.n_items
        ]
        return out[:k]
