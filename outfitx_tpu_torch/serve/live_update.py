"""Live catalog updates and appends for the serving engine (the port of
``outfitx_tpu/serve/live_update.py``).

A production catalog gets corrected or re-embedded items and new ones. Every
task reads the catalog tensor it is handed, so a changed row is seen by the
very next request; appends fill reserved sentinel rows (``spare_capacity``),
so no shape ever changes.

The JAX engine is functional: a scatter returns a new catalog, and a request
in flight finishes against the one it captured. PyTorch writes the rows in
place, which needs no second catalog-sized allocation, but a task such as
whole-catalog CIR reads the catalog twice (the gather, then the distances),
and a write between the two reads would give a torn answer. The contract is
kept by order: every mutation runs under ``self._update_lock``, and
``ServingEngine._run`` enqueues a request's device work under the same lock.
All of it goes to the one CUDA stream, which runs in order, so each request
sees the catalog wholly before or wholly after an update. On a mesh each row
is written into the shard that owns it (``ShardedRows.index_copy_``), on
that shard's device's current stream, where the requests' work on that
shard is enqueued under the same lock.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from outfitx_tpu_torch.ops.quantization import _quantize_block


class LiveCatalogUpdates:
    """Engine mixin: the live-update and append write path. Uses the engine's
    catalog tensors, lock and counters."""

    def update_items(
        self,
        item_ids: List[int],
        embeddings,
        descriptions: Optional[List[str]] = None,
    ) -> None:
        """In-place embedding refresh for existing catalog items.

        Updates the host catalog, the device catalog (float32 or bfloat16)
        and, when the engine serves the int8 route, requantises exactly the
        touched rows (per-row symmetric int8 is row by row, so the result
        equals a requantisation of the whole catalog bit for bit). Update
        batches are padded to ``update_bucket`` rows by repeating the first
        row (an idempotent re-set), so every scatter runs at one size.
        Thread-safe: the whole mutation runs under the update lock."""
        if not item_ids:
            return
        rows = np.asarray([self.lookup_row(i) for i in item_ids], np.int32)
        vals = np.asarray(embeddings, dtype=np.float32)
        if vals.shape != (len(rows), self.catalog.d_embed):
            raise ValueError(
                f"embeddings shape {vals.shape} != "
                f"({len(rows)}, {self.catalog.d_embed})"
            )
        with self._update_lock:
            self.catalog.embeddings[rows] = vals  # host copy stays consistent
            if descriptions is not None and self.catalog.descriptions:
                for r, text in zip(rows, descriptions):
                    self.catalog.descriptions[int(r)] = text
            self.n_updated_rows += len(rows)
            if self.mock:
                return
            if len(np.unique(rows)) != len(rows):
                # Duplicate ids in one request: the host assignment above is
                # last-wins, but an index write with repeated rows is
                # unordered on the card. Keep each row's last value, so host
                # and device cannot diverge.
                last = {int(r): i for i, r in enumerate(rows)}
                keep = np.asarray(sorted(last.values()), dtype=np.int64)
                rows, vals = rows[keep], vals[keep]
            self._scatter_locked(rows, vals)

    def add_items(
        self,
        item_ids: List[int],
        embeddings,
        category_ids=None,
        semantic_categories: Optional[List[str]] = None,
        descriptions: Optional[List[str]] = None,
    ) -> None:
        """Append new items at runtime into reserved spare rows
        (``spare_capacity``); raises when the capacity is exhausted or an id
        already exists. The appended rows are retrievable by the very next
        request: whole-catalog CIR and similar-items sweep the full capacity
        (sentinel rows never win). Per-category candidate pools are frozen
        at construction, so targets in a pool-served category keep their
        pool; new or unpooled categories take whole-catalog retrieval."""
        if not item_ids:
            return
        # The lock covers the host append too: ``append_items`` claims spare
        # rows from a shared counter, so two appends outside it could claim
        # the same rows.
        with self._update_lock:
            rows = self.catalog.append_items(
                item_ids, embeddings,
                category_ids=category_ids,
                semantic_categories=semantic_categories,
                descriptions=descriptions,
            )
            self.n_appended_items += len(rows)
            if self.mock:
                return
            self._scatter_locked(rows, np.asarray(embeddings, dtype=np.float32))

    def _scatter_locked(self, rows: np.ndarray, vals: np.ndarray) -> None:
        """Write ``vals`` into catalog rows ``rows`` on the device, and
        requantise those rows of the int8 catalog. The caller holds
        ``_update_lock``; rows are distinct but for the bucket's padding,
        which repeats the first row with its own value."""
        b = self.update_bucket
        with torch.no_grad():
            for s in range(0, len(rows), b):
                chunk_rows = rows[s : s + b]
                chunk_vals = vals[s : s + b]
                if len(chunk_rows) < b:  # pad by repeating row 0 (idempotent)
                    pad = b - len(chunk_rows)
                    chunk_rows = np.concatenate(
                        [chunk_rows, np.repeat(chunk_rows[:1], pad)]
                    )
                    chunk_vals = np.concatenate(
                        [chunk_vals, np.repeat(chunk_vals[:1], pad, axis=0)]
                    )
                rows_dev = torch.from_numpy(chunk_rows.astype(np.int64)).to(self._dev)
                vals_host = torch.from_numpy(np.ascontiguousarray(chunk_vals))
                # cast on the host: a bfloat16 catalog ships half the bytes
                self.catalog_dev.index_copy_(
                    0, rows_dev, vals_host.to(self.catalog_dev.dtype).to(self._dev)
                )
                if self._qcat is not None:
                    v, s_, m = _quantize_block(vals_host.to(self._dev))
                    self._qcat.values.index_copy_(0, rows_dev, v)
                    self._qcat.scales.index_copy_(0, rows_dev, s_)
                    self._qcat.sq_norms.index_copy_(0, rows_dev, m)
