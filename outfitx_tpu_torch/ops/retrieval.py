"""Retrieval ops: pairwise L2 distance and exact top-k against candidate
pools (CIR), argmin over candidates (FITB).

The distance matrix is one matrix product, ||q-p||^2 = ||q||^2 + ||p||^2 -
2 q.p, in float32. Top-k is exact (``torch.topk``); the JAX package's serving
default, the TPU's approximate top-k, has no counterpart here.
"""

from __future__ import annotations

import torch


def pairwise_l2(queries, pool, *, squared: bool = False):
    """(Q, D) x (N, D) -> (Q, N) L2 distances, float32."""
    qf = queries.float()
    pf = pool.float()
    q2 = (qf * qf).sum(dim=-1, keepdim=True)  # (Q, 1)
    p2 = (pf * pf).sum(dim=-1)[None, :]  # (1, N)
    cross = qf @ pf.T
    d2 = torch.clamp_min(q2 + p2 - 2.0 * cross, 0.0)
    return d2 if squared else torch.sqrt(d2)


def topk_smallest(dists, k: int):
    """Values and indices of the k smallest entries along the last axis,
    in ascending order (exact)."""
    vals, idx = torch.topk(dists, k, dim=-1, largest=False, sorted=True)
    return vals, idx


def retrieve(queries, pool, k: int):
    """Top-k nearest pool items by squared L2. Returns (dists2 (Q, k),
    indices (Q, k))."""
    return topk_smallest(pairwise_l2(queries, pool, squared=True), k)


def retrieve_per_query_pools(queries, pools, k: int):
    """Top-k where every query has its own candidate pool.

    queries: (B, D); pools: (B, P, D). Returns (dists2 (B, k), pool-local
    indices (B, k))."""
    qf = queries.float()
    pf = pools.float()
    q2 = (qf * qf).sum(dim=-1)[:, None]  # (B, 1)
    p2 = (pf * pf).sum(dim=-1)  # (B, P)
    cross = torch.bmm(pf, qf[:, :, None])[:, :, 0]  # (B, P)
    d2 = torch.clamp_min(q2 + p2 - 2.0 * cross, 0.0)
    return topk_smallest(d2, k)


def fitb_pick(query_emb, candidate_embs):
    """FITB: argmin L2 over per-row candidates.

    query_emb: (B, D); candidate_embs: (B, C, D). Returns (B,) indices; on a
    tie the first minimum wins (``torch.argmin``), which the engine's
    candidate padding relies on."""
    diff = candidate_embs.float() - query_emb.float()[:, None, :]
    d2 = (diff * diff).sum(dim=-1)
    return torch.argmin(d2, dim=-1)
