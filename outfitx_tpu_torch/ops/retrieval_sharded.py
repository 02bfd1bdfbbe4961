"""Mesh-sharded whole-catalog retrieval (the port of
``outfitx_tpu/ops/retrieval_sharded.py``): the catalog's rows split into
equal blocks over a mesh axis, a local top-k per shard on the shard's
device, and an exact merge of the shards' k candidates on the queries'
device.

The global top-k lies in the union of the per-shard top-k sets whenever
every shard holds at least k rows (each global winner is one of its own
shard's k best), so the merge, an exact top-k over shards x k candidates,
gives the single-device answer. The distances are the port's own:
``pairwise_l2`` for a dense shard, the int8 route's ``_quantized_dists``
for a quantized one. ``approx`` is accepted and the top-k is exact
(``ops/retrieval.py``).

One process drives every shard, as the JAX engine does: a shard's
distances run on its device's current stream, and only the (Q, k)
candidates cross devices.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from outfitx_tpu_torch.core.mesh import DATA_AXIS
from outfitx_tpu_torch.ops.quantization import QuantizedCatalog, _quantized_dists
from outfitx_tpu_torch.ops.retrieval import _BIG, pairwise_l2, topk_smallest


@dataclasses.dataclass
class ShardedRows:
    """A table split into equal blocks of rows, block i on its own device.

    Indexing with a tensor of global row numbers gathers those rows onto
    the index tensor's device; ``index_copy_`` writes each row into the
    shard that owns it, on that shard's device."""

    shards: List[torch.Tensor]

    @property
    def shard_rows(self) -> int:
        return self.shards[0].shape[0]

    @property
    def shape(self) -> torch.Size:
        s = self.shards[0].shape
        return torch.Size((s[0] * len(self.shards),) + tuple(s[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def __getitem__(self, rows: torch.Tensor) -> torch.Tensor:
        """Rows at global numbers ``rows`` (any shape), on ``rows``' device.
        Every shard gathers at the clamped local index and a select keeps
        the owner's row, so nothing waits on the host."""
        n = self.shard_rows
        owner = torch.div(rows, n, rounding_mode="floor")
        local = rows - owner * n
        out = None
        for i, shard in enumerate(self.shards):
            got = shard[local.clamp(0, n - 1).to(shard.device)].to(rows.device)
            if out is None:
                out = got
                continue
            sel = (owner == i).reshape(owner.shape + (1,) * (got.dim() - owner.dim()))
            out = torch.where(sel, got, out)
        return out

    def index_copy_(self, dim: int, rows: torch.Tensor, values: torch.Tensor) -> "ShardedRows":
        """Write ``values[j]`` into global row ``rows[j]``; the caller orders
        it with the readers (the serving engine's lock)."""
        assert dim == 0
        n = self.shard_rows
        rows_host = rows.cpu()
        for i, shard in enumerate(self.shards):
            sel = ((rows_host >= i * n) & (rows_host < (i + 1) * n)).nonzero().reshape(-1)
            if len(sel):
                shard.index_copy_(
                    0, (rows_host[sel] - i * n).to(shard.device),
                    values[sel.to(values.device)].to(shard.device),
                )
        return self


def catalog_row_sharding(mesh, axis: str = DATA_AXIS) -> List[torch.device]:
    """The devices of a row-sharded catalog over ``axis``: shard i lives on
    the device at coordinate i of that axis (coordinate 0 of the other)."""
    grid = mesh.devices if axis == DATA_AXIS else mesh.devices.T
    return [grid[i, 0] for i in range(grid.shape[0])]


def pad_rows_to_shards(n_rows: int, n_shards: int) -> int:
    """Rows after padding so the leading axis divides the shard count."""
    return -(-n_rows // n_shards) * n_shards


def shard_rows(x: torch.Tensor, mesh, axis: str = DATA_AXIS) -> ShardedRows:
    """Place a (N, ...) table row-sharded over ``axis``; N must divide the
    axis size."""
    devices = catalog_row_sharding(mesh, axis)
    if x.shape[0] % len(devices):
        raise ValueError(
            f"rows {x.shape[0]} must divide the '{axis}' axis ({len(devices)}); "
            f"pad to {pad_rows_to_shards(x.shape[0], len(devices))} first"
        )
    return ShardedRows([
        part.to(dev, copy=True) for part, dev in zip(x.chunk(len(devices)), devices)
    ])


def _as_sharded(x, mesh, axis) -> ShardedRows:
    if not isinstance(x, ShardedRows):
        return shard_rows(x, mesh, axis)
    if len(x.shards) != mesh.shape[axis]:
        raise ValueError(f"{len(x.shards)} shards on the '{axis}' axis of {mesh.shape[axis]}")
    return x


def _merge(local_dists, queries, k, n, shard_n, *, approx):
    """Per-shard (Q, shard_n) distances -> the exact global (Q, k) top-k on
    the queries' device. Rows at or past ``n`` (padding) never win."""
    cand_d, cand_i = [], []
    for i, d2 in enumerate(local_dists):
        gidx = i * shard_n + torch.arange(shard_n, device=d2.device)
        d2 = torch.where((gidx < n)[None, :], d2, torch.full_like(d2, _BIG))
        d, pos = topk_smallest(d2, k, approx=approx)
        cand_d.append(d.to(queries.device))
        cand_i.append((pos + i * shard_n).to(queries.device))
    d_all, i_all = torch.cat(cand_d, dim=1), torch.cat(cand_i, dim=1)
    best, pos = topk_smallest(d_all, k)  # exact merge over shards x k
    return best, torch.gather(i_all, 1, pos)


def _check_k(k: int, shard_n: int) -> None:
    if k > shard_n:
        # union-of-local-top-k containment needs every shard to hold >= k
        raise ValueError(f"k={k} exceeds shard rows {shard_n}")


def retrieve_sharded(
    queries, pool, k: int, *, mesh, n_rows: int | None = None,
    axis: str = DATA_AXIS, approx: bool = False,
):
    """Top-k nearest rows by squared L2 with ``pool`` row-sharded over
    ``mesh``'s ``axis``: (dists2 (Q, k), indices (Q, k)) on the queries'
    device, equal to ``retrieve`` on the first ``n_rows`` rows.

    ``pool`` is a ``ShardedRows`` (place it once with ``shard_rows``) or a
    tensor whose rows divide the axis (pad with ``pad_rows_to_shards``),
    which is sharded for this call. ``n_rows`` marks the real rows;
    padded rows never win."""
    pool = _as_sharded(pool, mesh, axis)
    n_pad, shard_n = pool.shape[0], pool.shard_rows
    n = n_pad if n_rows is None else int(n_rows)
    _check_k(k, shard_n)
    dists = [
        pairwise_l2(queries.to(shard.device), shard, squared=True)
        for shard in pool.shards
    ]
    return _merge(dists, queries, k, n, shard_n, approx=approx)


def shard_quantized(catalog: QuantizedCatalog, mesh, axis: str = DATA_AXIS) -> QuantizedCatalog:
    """An int8 catalog with its values, scales and norms row-sharded."""
    return QuantizedCatalog(
        values=shard_rows(catalog.values, mesh, axis),
        scales=shard_rows(catalog.scales, mesh, axis),
        sq_norms=shard_rows(catalog.sq_norms, mesh, axis),
    )


def retrieve_quantized_sharded(
    queries, catalog: QuantizedCatalog, k: int, *, mesh, n_rows: int | None = None,
    axis: str = DATA_AXIS, approx: bool = False, widen_rows: int = 65_536,
):
    """``retrieve_sharded`` against an int8 ``QuantizedCatalog`` whose
    values, scales and norms are row-sharded alike (``shard_quantized``;
    an unsharded catalog is sharded for this call). The distances are
    ``retrieve_quantized``'s."""
    if not isinstance(catalog.values, ShardedRows):
        catalog = shard_quantized(catalog, mesh, axis)
    values = _as_sharded(catalog.values, mesh, axis)
    n_pad, shard_n = values.shape[0], values.shard_rows
    n = n_pad if n_rows is None else int(n_rows)
    _check_k(k, shard_n)
    dists = []
    for v, s, m in zip(values.shards, catalog.scales.shards, catalog.sq_norms.shards):
        q = queries.to(v.device).float()
        q2 = (q * q).sum(dim=-1, keepdim=True)
        dists.append(_quantized_dists(q, q2, QuantizedCatalog(v, s, m), 0, shard_n, widen_rows))
    return _merge(dists, queries, k, n, shard_n, approx=approx)
