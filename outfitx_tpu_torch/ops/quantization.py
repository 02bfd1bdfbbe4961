"""Int8 catalog quantization for retrieval (the port of
``outfitx_tpu/ops/quantization.py``).

Per-row symmetric int8 cuts a catalog's device memory fourfold against
float32. Ranking quality is kept by computing ||q - p||^2 = ||q||^2 +
||p||^2 - 2 q.p with exact per-row dequantisation scales; the pool norms are
those of the *dequantised* rows, so the distance is exact with respect to the
quantised pool and the only error is the rows' quantisation.

The cross term keeps the JAX arithmetic: float32 queries times the int8
values widened to float32, the per-row scale applied to the float32 result.
Eager PyTorch would materialise the widened (N, D) table, a float32 copy
four times the int8 one, which undoes what int8 is for; so the values are
widened a block of rows at a time (``widen_rows``), and the peak extra memory
is one block's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from outfitx_tpu_torch.ops.retrieval import _chunked_topk_scan, topk_smallest


@dataclasses.dataclass
class QuantizedCatalog:
    values: torch.Tensor  # (N, D) int8
    scales: torch.Tensor  # (N,) float32 per-row dequantisation scale
    sq_norms: torch.Tensor  # (N,) float32 ||row||^2 after dequantisation

    @property
    def nbytes(self) -> int:
        return self.values.numel() + 8 * self.scales.numel()

    @classmethod
    def from_numpy(cls, values, scales, sq_norms, device="cpu") -> "QuantizedCatalog":
        """From the three arrays of the JAX package's ``QuantizedCatalog``
        (``np.asarray`` of its fields), so both packages can be held to one
        int8 table."""
        values = np.array(values)  # a writable, contiguous copy
        if values.dtype != np.int8:
            raise TypeError(f"values must be int8, got {values.dtype}")
        return cls(
            values=torch.from_numpy(values).to(device),
            scales=torch.from_numpy(np.asarray(scales, np.float32).copy()).to(device),
            sq_norms=torch.from_numpy(np.asarray(sq_norms, np.float32).copy()).to(device),
        )


def _quantize_block(x: torch.Tensor):
    """Per-row symmetric int8 for one (C, D) block: scale = max|row| / 127
    (1 for an all-zero row), values rounded half to even and clipped to
    [-127, 127], and the squared norms of the dequantised rows. The
    arithmetic is row by row, so quantising a catalog block by block equals
    quantising it in one go.

    The scale is max|row| times the float32 reciprocal of 127: the JAX
    function is jitted, and XLA rewrites its division by a constant so; a
    true division differs in the last bit on about 4% of rows, and the two
    packages are held to one table bit for bit."""
    x = x.float()
    absmax = x.abs().amax(dim=-1)
    scales = torch.where(absmax > 0, absmax * (1.0 / 127.0), torch.ones_like(absmax))
    values = torch.clamp(torch.round(x / scales[:, None]), -127, 127).to(torch.int8)
    deq = values.float() * scales[:, None]
    return values, scales, (deq * deq).sum(dim=-1)


def quantize_catalog(
    embeddings: torch.Tensor, *, n_rows: int | None = None,
    block_rows: int = 131_072,
) -> QuantizedCatalog:
    """Quantise ``embeddings[:n_rows]`` (default: all rows) in blocks of
    ``block_rows``, so the float32 temporaries are one block's and not the
    catalog's. ``n_rows`` lets a caller leave a trailing PAD row out. As in
    the JAX package the last block is cut overlapping backwards from ``n -
    block_rows`` and its rows that an earlier block covered are dropped; the
    result equals the one-shot quantisation bit for bit."""
    n = int(embeddings.shape[0]) if n_rows is None else int(n_rows)
    if n <= block_rows:
        return QuantizedCatalog(*_quantize_block(embeddings[:n]))
    vals, scls, nrms = [], [], []
    done = 0  # rows already emitted
    while done < n:
        start = min(done, n - block_rows)  # tail block overlaps backwards
        v, s, m = _quantize_block(embeddings[start : start + block_rows])
        off = done - start
        vals.append(v[off:])
        scls.append(s[off:])
        nrms.append(m[off:])
        done = start + block_rows
    return QuantizedCatalog(
        values=torch.cat(vals), scales=torch.cat(scls), sq_norms=torch.cat(nrms)
    )


def _quantized_dists(q, q2, catalog: QuantizedCatalog, start: int, stop: int,
                     widen_rows: int):
    """(Q, stop - start) squared distances to int8 rows ``start:stop``, the
    values widened to float32 ``widen_rows`` rows at a time."""
    parts = []
    for s in range(start, stop, widen_rows):
        e = min(s + widen_rows, stop)
        cross = (q @ catalog.values[s:e].float().T) * catalog.scales[None, s:e]
        parts.append(
            torch.clamp_min(q2 + catalog.sq_norms[None, s:e] - 2.0 * cross, 0.0)
        )
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def retrieve_quantized(
    queries: torch.Tensor, catalog: QuantizedCatalog, k: int,
    *, approx: bool = False, widen_rows: int = 65_536,
):
    """Top-k nearest rows by squared L2 against the int8 catalog; the (Q, N)
    distance matrix is materialised, the widened values only a block at a
    time. Returns (dists2 (Q, k), indices (Q, k))."""
    q = queries.float()
    q2 = (q * q).sum(dim=-1, keepdim=True)
    d2 = _quantized_dists(q, q2, catalog, 0, catalog.values.shape[0], widen_rows)
    return topk_smallest(d2, k, approx=approx)


def retrieve_quantized_chunked(
    queries: torch.Tensor, catalog: QuantizedCatalog, k: int,
    *, chunk_size: int = 65_536, approx: bool = False, widen_rows: int = 65_536,
):
    """Top-k against the int8 catalog with the pool streamed in chunks: a
    running (Q, k) best set with an exact merge, so neither the (Q, N)
    distance matrix nor a widened table is materialised. Returns (dists2
    (Q, k), global indices (Q, k))."""
    q = queries.float()
    q2 = (q * q).sum(dim=-1, keepdim=True)

    def chunk_dists(start, stop):
        return _quantized_dists(q, q2, catalog, start, stop, widen_rows)

    return _chunked_topk_scan(
        q.shape[0], k, catalog.values.shape[0], chunk_size, chunk_dists,
        device=q.device, approx=approx,
    )
