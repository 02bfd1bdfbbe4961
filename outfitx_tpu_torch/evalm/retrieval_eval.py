"""Per-category retrieval evaluation, CIR Recall@k (the port of
``outfitx_tpu/evalm/retrieval_eval.py``).

Queries are grouped by the true target's category; each category's pool is
gathered from the device catalog one pool at a time, so the evaluation holds
one (P, D) pool on the device beside the catalog, never all of them. Per
pool: squared L2 distances as |q|^2 + |p|^2 - 2 q.p in float32 and the 50
nearest pool positions; only the hit counting runs on the host.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

import numpy as np
import torch

from outfitx_tpu_torch.data.sampler import CandidatePools


@torch.no_grad()
def _pool_topk_50(catalog, queries, rows):
    """queries (Q, D), rows (P,) catalog rows -> (Q, min(50, P)) nearest
    pool positions."""
    pool = catalog.index_select(0, rows).float()
    q2 = (queries * queries).sum(dim=-1)[:, None]
    p2 = (pool * pool).sum(dim=-1)[None, :]
    d2 = q2 + p2 - 2.0 * torch.matmul(queries, pool.T)
    return torch.topk(-d2, min(50, pool.shape[0]), dim=-1).indices


def recall_over_pools(
    y_hats: torch.Tensor,  # (n, D) predicted target embeddings, on the device
    pos_rows: np.ndarray,  # (n,) catalog row of the true target
    pos_cats: np.ndarray,  # (n,) category_id of the true target
    pools: CandidatePools,
    catalog_embeddings: torch.Tensor,  # (N+1, D) device catalog
    ks: Sequence[int] = (1, 5, 10, 15, 30, 50),
) -> Dict[str, float]:
    by_cat = defaultdict(list)
    for i, cid in enumerate(pos_cats):
        if int(cid) in pools.pools:
            by_cat[int(cid)].append(i)
    if not by_cat:
        return {f"recall@{k}": float("nan") for k in ks}
    dev = catalog_embeddings.device
    y = torch.as_tensor(y_hats, device=dev).float()
    hits = {k: 0 for k in ks}
    n_queries = 0
    for cid in sorted(by_cat):
        pool = pools.pools[cid]
        # first-occurrence position of each row in this category's pool
        pos_map: Dict[int, int] = {}
        for p, row in enumerate(pool):
            pos_map.setdefault(int(row), p)
        members = by_cat[cid]
        gt = np.asarray([pos_map.get(int(pos_rows[i]), -1) for i in members])
        sel = torch.as_tensor(np.asarray(members, dtype=np.int64), device=dev)
        rows = torch.as_tensor(pool.astype(np.int64), device=dev)
        top = _pool_topk_50(catalog_embeddings, y.index_select(0, sel), rows)
        top = top.cpu().numpy()
        for k in ks:
            hits[k] += int((top[:, :k] == gt[:, None]).any(axis=-1).sum())
        n_queries += len(members)
    return {f"recall@{k}": hits[k] / max(n_queries, 1) for k in ks}
