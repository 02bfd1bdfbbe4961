"""Retrieval ops: pairwise L2 distance and top-k against candidate pools
(CIR), argmin over candidates (FITB), and the streamed form for catalogs
whose (Q, N) distance matrix should not be materialised.

The distance matrix is one matrix product, ||q-p||^2 = ||q||^2 + ||p||^2 -
2 q.p, in float32. Top-k is always exact (``torch.topk``). The JAX package's
serving default is the TPU's approximate top-k primitive
(``lax.approx_max_k``, recall target 0.99), which is no kernel of the
repository and has no counterpart on a GPU: the functions here accept
``approx=True`` for the same call signatures and compute the exact top-k,
whose recall of 1.0 meets that target.
"""

from __future__ import annotations

import torch

# Distance of a pool row that must never win (a row beyond the pool's end).
_BIG = 3.4e38


def pairwise_l2(queries, pool, *, squared: bool = False):
    """(Q, D) x (N, D) -> (Q, N) L2 distances, float32."""
    qf = queries.float()
    pf = pool.float()
    q2 = (qf * qf).sum(dim=-1, keepdim=True)  # (Q, 1)
    p2 = (pf * pf).sum(dim=-1)[None, :]  # (1, N)
    cross = qf @ pf.T
    d2 = torch.clamp_min(q2 + p2 - 2.0 * cross, 0.0)
    return d2 if squared else torch.sqrt(d2)


def topk_smallest(dists, k: int, *, approx: bool = False):
    """Values and indices of the k smallest entries along the last axis,
    in ascending order. ``approx`` is accepted and ignored: the result is
    exact either way."""
    del approx
    vals, idx = torch.topk(dists, k, dim=-1, largest=False, sorted=True)
    return vals, idx


def retrieve(queries, pool, k: int, *, approx: bool = False):
    """Top-k nearest pool items by squared L2. Returns (dists2 (Q, k),
    indices (Q, k))."""
    return topk_smallest(pairwise_l2(queries, pool, squared=True), k, approx=approx)


def _chunked_topk_scan(n_queries, k, n, chunk_size, chunk_dists, *, device,
                       approx: bool = False):
    """The streaming top-k shared by the dense and the int8 route: a loop
    over pool chunks keeps a running (Q, k) best set. ``chunk_dists(start,
    stop)`` gives the (Q, stop - start) squared distances of pool rows
    ``start:stop``. The last chunk is simply shorter (the JAX scan pads it to
    the chunk size and sets the padded rows to 3.4e38; a Python loop needs no
    equal shapes), the within-chunk top-k and the merge with the incumbents
    are exact, and a best set that no row has filled yet holds 3.4e38.
    Returns (dists2 (Q, min(k, n)), global int64 indices)."""
    kk = min(k, n)
    best_d = torch.full((n_queries, kk), _BIG, dtype=torch.float32, device=device)
    best_i = torch.zeros((n_queries, kk), dtype=torch.int64, device=device)
    for start in range(0, n, chunk_size):
        stop = min(start + chunk_size, n)
        d2 = chunk_dists(start, stop)
        c_d, c_pos = topk_smallest(d2, min(kk, stop - start), approx=approx)
        cat_d = torch.cat([best_d, c_d], dim=1)
        cat_i = torch.cat([best_i, c_pos + start], dim=1)
        best_d, pos = topk_smallest(cat_d, kk)  # exact merge, <= 2k entries
        best_i = torch.gather(cat_i, 1, pos)
    return best_d, best_i


def retrieve_chunked(
    queries, pool, k: int, *, chunk_size: int = 65_536, approx: bool = False
):
    """Top-k retrieval with the pool streamed in chunks of rows.

    For catalogs where the full (Q, N) distance matrix and the float32
    temporaries of ``pairwise_l2`` over the whole table should not be
    materialised: peak extra memory is that of one chunk. Returns (dists2
    (Q, k), global indices (Q, k)), equal to ``retrieve`` on the same
    inputs."""
    n = pool.shape[0]
    q = queries.float()

    def chunk_dists(start, stop):
        return pairwise_l2(q, pool[start:stop], squared=True)

    return _chunked_topk_scan(
        q.shape[0], k, n, chunk_size, chunk_dists, device=q.device, approx=approx
    )


def retrieve_per_query_pools(queries, pools, k: int, *, approx: bool = False):
    """Top-k where every query has its own candidate pool.

    queries: (B, D); pools: (B, P, D). Returns (dists2 (B, k), pool-local
    indices (B, k))."""
    qf = queries.float()
    pf = pools.float()
    q2 = (qf * qf).sum(dim=-1)[:, None]  # (B, 1)
    p2 = (pf * pf).sum(dim=-1)  # (B, P)
    cross = torch.bmm(pf, qf[:, :, None])[:, :, 0]  # (B, P)
    d2 = torch.clamp_min(q2 + p2 - 2.0 * cross, 0.0)
    return topk_smallest(d2, k, approx=approx)


def fitb_pick(query_emb, candidate_embs):
    """FITB: argmin L2 over per-row candidates.

    query_emb: (B, D); candidate_embs: (B, C, D). Returns (B,) indices; on a
    tie the first minimum wins (``torch.argmin``), which the engine's
    candidate padding relies on."""
    diff = candidate_embs.float() - query_emb.float()[:, None, :]
    d2 = (diff * diff).sum(dim=-1)
    return torch.argmin(d2, dim=-1)
