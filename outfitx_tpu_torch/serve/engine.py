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

Top-k is exact. The JAX engine's approximate top-k (a TPU primitive), int8
catalog and int8 model, mesh-sharded catalog, streamed retrieval over large
catalogs and live catalog updates are not ported yet: asking for one
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from outfitx_tpu_torch.core.config import OutfitXConfig
from outfitx_tpu_torch.core.device import resolve_device
from outfitx_tpu_torch.data.catalog import Catalog
from outfitx_tpu_torch.data.sampler import CandidatePools
from outfitx_tpu_torch.data.splits import _pad_outfits
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.serve.batched import BatchedRequests
from outfitx_tpu_torch.serve.programs import (
    TaskPrograms,
    cir_pool_task,
    cir_task,
    cp_task,
    fitb_task,
    sim_task,
)


class UnknownItemError(KeyError):
    """Raised for item ids absent from the catalog."""


@dataclasses.dataclass
class ServingEngine(TaskPrograms, BatchedRequests):
    model_cfg: OutfitXConfig
    catalog: Catalog
    # OutfitXModel state dicts (models/from_jax.py turns JAX parameters
    # into one). Pass the same object twice to share one model.
    cp_params: Optional[Dict[str, torch.Tensor]] = None
    cir_params: Optional[Dict[str, torch.Tensor]] = None
    pools: Optional[CandidatePools] = None
    device: str = "cuda"
    # Routes of the JAX engine that are not ported yet; each raises.
    quantized: bool = False
    quantize_model: bool = False
    spare_capacity: int = 0
    mesh: Optional[object] = None
    # Catalogs above this many rows need streamed retrieval (not ported).
    chunk_threshold: int = 262_144
    warmup: bool = True
    # Batched requests run in chunks of exactly this many entries.
    cp_batch_bucket: int = 8

    def __post_init__(self):
        unported = {
            "quantized": self.quantized,
            "quantize_model": self.quantize_model,
            "spare_capacity": self.spare_capacity,
            "mesh": self.mesh is not None,
        }
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(
                f"serving routes not ported to PyTorch yet: {asked}"
            )
        if self.catalog.pad_row > self.chunk_threshold:
            raise NotImplementedError(
                f"catalog of {self.catalog.pad_row} rows is above "
                f"chunk_threshold={self.chunk_threshold}; streamed retrieval "
                "is not ported to PyTorch yet"
            )
        self._dev = resolve_device(self.device)
        self.catalog_dev = torch.from_numpy(self.catalog.embeddings).to(self._dev)
        self.cp_model = self._model(self.cp_params)
        self.cir_model = (
            self.cp_model
            if self.cir_params is self.cp_params
            else self._model(self.cir_params)
        )
        # Request threads come with the HTTP layer (not ported yet); until
        # then one generator serves the sample draws.
        self._rng = np.random.default_rng(0)
        if self.warmup:
            self._warmup()

    def _model(self, state_dict) -> Optional[OutfitXModel]:
        if state_dict is None:
            return None
        model = OutfitXModel(self.model_cfg, device=self._dev)
        model.load_state_dict(state_dict, strict=True)
        return model.eval()

    def _run(self, task, *args):
        """Run a task function with its numpy arguments moved to the
        device (row indices as int64). The JAX engine's retry loop around
        catalog buffer donation has no counterpart: nothing here donates."""
        moved = []
        for a in args:
            if isinstance(a, np.ndarray):
                t = torch.from_numpy(a)
                if t.dtype == torch.int32:
                    t = t.long()
                a = t.to(self._dev)
            moved.append(a)
        with torch.inference_mode():
            return task(*moved)

    def lookup_row(self, item_id: int) -> int:
        row = self.catalog.id_to_row.get(int(item_id))
        if row is None:
            raise UnknownItemError(f"unknown item_id {item_id}")
        return row

    def sample_outfit(self, n: int = 4) -> List[int]:
        rows = self._rng.choice(self.catalog.n_items, n, replace=False)
        return [int(self.catalog.item_ids[r]) for r in rows]

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
        rows, mask = self._pad(item_ids)
        return float(
            self._run(cp_task, self.cp_model, self.catalog_dev, rows, mask)[0]
        )

    def cir_top10(
        self, item_ids: List[int], target_item_id: int
    ) -> List[Dict]:
        """Top-10 complementary items from the target's category pool."""
        target_row = self.lookup_row(target_item_id)
        cid = int(self.catalog.category_id[target_row])
        rows, mask = self._pad(item_ids)
        trow = np.asarray([target_row], dtype=np.int32)
        pool_rows = self.pools.pools.get(cid) if self.pools is not None else None
        if pool_rows is None:  # whole-catalog retrieval; idx are rows
            d2, idx = self._run(
                cir_task, self.cir_model, self.catalog_dev,
                self.catalog.pad_row, rows, mask, trow,
            )
            found = idx.cpu().numpy()[0]
        else:
            d2, idx = self._run(
                cir_pool_task, self.cir_model, self.catalog_dev, rows, mask,
                trow, np.asarray(pool_rows, dtype=np.int32)[None],
            )
            found = np.asarray(pool_rows)[idx.cpu().numpy()[0]]
        return [
            self._item_info(int(r), float(dist))
            for r, dist in zip(found, d2.cpu().numpy()[0])
        ]

    def fitb_pick(
        self, item_ids: List[int], candidate_ids: List[int]
    ) -> int:
        """Index of the best-fitting candidate. The query uses the first
        candidate's text embedding (candidates share a category)."""
        rows, mask = self._pad(item_ids)
        cand_rows = self.catalog.rows(candidate_ids)
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
    def _item_info(self, row: int, score: float) -> Dict:
        return {
            "item_id": int(self.catalog.item_ids[row]),
            "score": score,
            "category_id": int(self.catalog.category_id[row]),
            "description": (
                self.catalog.descriptions[row]
                if self.catalog.descriptions
                else ""
            ),
        }

    def similar_items(self, item_id: int, k: int = 10) -> List[Dict]:
        """Nearest catalog neighbours of an item by embedding L2."""
        row = self.lookup_row(item_id)
        d2, idx = self._run(
            sim_task, self.catalog_dev, self.catalog.pad_row,
            np.asarray([row], dtype=np.int32), k + 1,
        )
        out = [
            self._item_info(int(i), float(dist))
            for i, dist in zip(idx.cpu().numpy()[0], d2.cpu().numpy()[0])
            if int(i) != row  # skip the query item itself
        ]
        return out[:k]
