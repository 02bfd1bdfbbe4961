"""The serving task functions, the whole-catalog route matrix and the
engine's startup warmup.

Each task is a plain torch function over the device-resident catalog: an
index gather of the request's rows, the model forward, then sigmoid, top-k or
argmin. The JAX package compiles each into one jitted program
(``outfitx_tpu/serve/programs.py``); here they run eagerly, and every kernel
they reach launches on the current CUDA stream. Whole-catalog retrieval is
routed by the engine's configuration, fixed for its lifetime: {dense, int8} x
{materialised, streamed in chunks, row-sharded over a mesh}
(``CatalogRoute``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from outfitx_tpu_torch.ops.quantization import (
    retrieve_quantized,
    retrieve_quantized_chunked,
)
from outfitx_tpu_torch.ops.retrieval import (
    fitb_pick,
    retrieve,
    retrieve_chunked,
    retrieve_per_query_pools,
)
from outfitx_tpu_torch.ops.retrieval_sharded import (
    retrieve_quantized_sharded,
    retrieve_sharded,
)


def _bucket_chunks(idxs, bucket: int):
    """Yield ``(sel, padded)`` covering ``idxs`` in chunks of exactly
    ``bucket`` indices: ``sel`` are the real indices, ``padded`` the int64
    index array padded by repeating the chunk's first index. Every batched
    call therefore runs at one batch size; pad results are sliced away by
    the caller."""
    idxs = list(idxs)
    for s in range(0, len(idxs), bucket):
        sel = idxs[s : s + bucket]
        yield sel, np.asarray(sel + sel[:1] * (bucket - len(sel)), np.int64)


@dataclasses.dataclass(frozen=True)
class CatalogRoute:
    """How whole-catalog retrieval runs. ``n_rows`` is everything below the
    PAD row; with reserved spare capacity that includes the sentinel spare
    rows (they never win a top-k slot), so appended items become retrievable
    with no change here."""

    n_rows: int
    quantized: bool = False
    chunked: bool = False
    chunk_size: int = 262_144
    approx: bool = True
    mesh: object = None  # a mesh: the catalog is row-sharded over it


def catalog_topk(y, cat, qcat, route: CatalogRoute, k: int):
    """Top-k of queries ``y`` over the whole catalog by ``route``: (d2,
    catalog rows)."""
    if route.mesh is not None:
        if route.quantized:
            return retrieve_quantized_sharded(
                y, qcat, k, mesh=route.mesh, n_rows=route.n_rows, approx=route.approx
            )
        return retrieve_sharded(
            y, cat, k, mesh=route.mesh, n_rows=route.n_rows, approx=route.approx
        )
    if route.quantized and route.chunked:
        return retrieve_quantized_chunked(
            y, qcat, k, chunk_size=route.chunk_size, approx=route.approx
        )
    if route.quantized:
        return retrieve_quantized(y, qcat, k, approx=route.approx)
    if route.chunked:
        return retrieve_chunked(
            y, cat[: route.n_rows], k, chunk_size=route.chunk_size,
            approx=route.approx,
        )
    return retrieve(y, cat[: route.n_rows], k, approx=route.approx)


def _cir_query(model, cat, rows, mask, target_rows):
    """rows (B, L), target_rows (B,) -> predicted target embeddings (B, D).
    The target's text embedding is the second half of its catalog row."""
    d = cat.shape[1]
    emb = cat[rows]  # (B, L, D)
    text = cat[target_rows][:, d // 2 :]
    return model.cir_forward(emb, mask, text)


def cp_task(model, cat, rows, mask):
    """Sigmoid compatibility scores (B,)."""
    return torch.sigmoid(model.cp_forward(cat[rows], mask))


def cir_task(model, cat, qcat, route, rows, mask, target_rows):
    """Top-10 over the whole catalog: (d2, rows)."""
    y = _cir_query(model, cat, rows, mask, target_rows)
    return catalog_topk(y, cat, qcat, route, 10)


def cir_pool_task(model, cat, rows, mask, target_rows, pool_rows):
    """Top-10 where request b retrieves from its own pool ``pool_rows[b]``:
    (d2, pool-local indices). Always exact."""
    y = _cir_query(model, cat, rows, mask, target_rows)
    return retrieve_per_query_pools(y, cat[pool_rows], 10)


def fitb_task(model, cat, rows, mask, text_row, cand_rows):
    """Index of the candidate nearest the predicted embedding, (1,)."""
    y = _cir_query(model, cat, rows, mask, text_row)
    return fitb_pick(y, cat[cand_rows][None])


def sim_task(cat, qcat, route, qrows, k):
    """k nearest catalog rows of each query row: (d2, rows)."""
    return catalog_topk(cat[qrows], cat, qcat, route, k)


class TaskPrograms:
    """Engine mixin: the startup warmup."""

    def _warmup(self):
        """Run every task once at startup, so the first request does not pay
        for the kernel build, CUDA context and library handle set-up: cp single
        and the batch bucket, both CIR routes (single and bucket), fitb,
        similar (single and bucket), and the live-update scatter."""
        ids = self.sample_outfit(4)
        if self.cp_model is not None:
            self.cp_score(ids)
            self.cp_score_batch([ids[:2], ids[2:]])
        if self.cir_model is not None:
            rows, mask = self._pad(ids[:1])
            trow = np.asarray([self.lookup_row(ids[1])], dtype=np.int32)
            b = self.cp_batch_bucket
            rows_b = np.repeat(rows, b, axis=0)
            mask_b = np.repeat(mask, b, axis=0)
            trows_b = np.repeat(trow, b)
            for r, m, t in ((rows, mask, trow), (rows_b, mask_b, trows_b)):
                self._run(
                    cir_task, self.cir_model, self.catalog_dev, self._qcat,
                    self._route, r, m, t,
                )
                if self.pools is not None and self.pools.pools:
                    pool = np.asarray(next(iter(self.pools.pools.values())))
                    prows = np.repeat(pool[None].astype(np.int32), len(t), axis=0)
                    self._run(
                        cir_pool_task, self.cir_model, self.catalog_dev,
                        r, m, t, prows,
                    )
            self.fitb_pick(ids[:3], ids[:4])
        self.similar_items(ids[0])
        self.similar_items_batch(ids[:2])
        # Re-setting row 0 to its own value is idempotent and exact, so the
        # warmup leaves the catalog bit-identical: the value is taken through
        # the catalog's dtype, so a bfloat16 catalog's int8 row requantises
        # from exactly what the device holds.
        row0 = (
            torch.from_numpy(self.catalog.embeddings[:1])
            .to(self.catalog_dev.dtype).float().numpy()
        )
        with self._update_lock:
            self._scatter_locked(np.asarray([0], dtype=np.int32), row0)
