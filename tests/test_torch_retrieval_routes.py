"""The PyTorch port's streamed and int8 retrieval against the JAX package's
on the same arrays: ``retrieve_chunked``, the quantisation functions (the
int8 table bit for bit) and both int8 retrieval routes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from outfitx_tpu.ops import quantization as jax_q
from outfitx_tpu.ops import retrieval as jax_r
from outfitx_tpu_torch.ops import quantization as tq
from outfitx_tpu_torch.ops import retrieval as tr

torch.set_num_threads(1)

# float32 distances: one product and three sums in another order.
TOL = 1e-5


def _data(n=300, d=32, q=5, seed=0):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    return queries, pool


def _same(got, want, rows_equal=True):
    d2, idx = got
    jd2, jidx = want
    assert idx.dtype == torch.int64
    if rows_equal:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    "n,chunk,k",
    [(300, 100, 10), (300, 128, 10), (300, 64, 7), (50, 8, 20), (40, 64, 5), (9, 4, 12)],
    ids=["divides", "ragged_tail", "many_chunks", "k_above_chunk", "one_chunk", "k_above_n"],
)
@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
def test_retrieve_chunked_matches_jax(n, chunk, k, approx):
    queries, pool = _data(n=n, seed=n + k)
    want = jax_r.retrieve_chunked(
        jnp.asarray(queries), jnp.asarray(pool), k, chunk_size=chunk, approx=approx
    )
    got = tr.retrieve_chunked(
        torch.from_numpy(queries), torch.from_numpy(pool), k, chunk_size=chunk,
        approx=approx,
    )
    assert tuple(got[0].shape) == (queries.shape[0], min(k, n))
    _same(got, want)


def test_retrieve_chunked_equals_dense():
    queries, pool = (torch.from_numpy(a) for a in _data(n=257, seed=3))
    dense = tr.retrieve(queries, pool, 10)
    for chunk in (32, 100, 257, 1000):
        d2, idx = tr.retrieve_chunked(queries, pool, 10, chunk_size=chunk)
        assert torch.equal(idx, dense[1])
        np.testing.assert_allclose(d2.numpy(), dense[0].numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fn", ["topk_smallest", "retrieve", "retrieve_per_query_pools"])
def test_approx_argument_is_accepted_and_exact(fn):
    queries, pool = (torch.from_numpy(a) for a in _data(seed=4))
    if fn == "topk_smallest":
        args = (tr.pairwise_l2(queries, pool), 10)
    elif fn == "retrieve":
        args = (queries, pool, 10)
    else:
        args = (queries, pool[None].repeat(5, 1, 1), 10)
    exact = getattr(tr, fn)(*args)
    approx = getattr(tr, fn)(*args, approx=True)
    assert torch.equal(exact[0], approx[0]) and torch.equal(exact[1], approx[1])


def _assert_tables_equal(got: tq.QuantizedCatalog, want):
    assert got.values.dtype == torch.int8
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    # The norms sum D products: the same values in another order.
    np.testing.assert_allclose(
        got.sq_norms.numpy(), np.asarray(want.sq_norms), rtol=1e-6, atol=0
    )


def test_quantize_block_matches_jax_bit_for_bit():
    """Rounding half to even, the zero-row guard and the clip, on rows that
    hit them: an all-zero row, exact .5 quotients, a huge sentinel row."""
    _, pool = _data(n=64, d=32, seed=5)
    pool[0] = 0.0
    pool[1] = np.linspace(-127, 127, 32) / 2.0  # quotients k/2 at scale 0.5
    pool[1, 0], pool[1, -1] = -63.5, 63.5
    pool[2] = 1.0e4
    want = jax_q._quantize_block(jnp.asarray(pool))
    v, s, m = tq._quantize_block(torch.from_numpy(pool))
    np.testing.assert_array_equal(v.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(m.numpy(), np.asarray(want[2]), rtol=1e-6, atol=0)
    assert float(s[0]) == 1.0 and not v[0].any()


@pytest.mark.parametrize("n_rows", [None, 299], ids=["all_rows", "without_pad_row"])
def test_quantize_catalog_matches_jax(n_rows):
    _, pool = _data(n=300, seed=6)
    want = jax_q.quantize_catalog(jnp.asarray(pool), n_rows=n_rows)
    got = tq.quantize_catalog(torch.from_numpy(pool), n_rows=n_rows)
    assert got.values.shape[0] == (n_rows or 300)
    _assert_tables_equal(got, want)
    assert got.nbytes == want.nbytes


@pytest.mark.parametrize("block_rows", [64, 100, 299, 7])
def test_blocked_quantize_equals_one_shot(block_rows):
    """Blocks with the overlapping tail block equal the one-shot table, and
    the JAX package's blocked table, bit for bit."""
    _, pool = _data(n=300, seed=7)
    pool_t = torch.from_numpy(pool)
    one = tq.quantize_catalog(pool_t, n_rows=299)
    blocked = tq.quantize_catalog(pool_t, n_rows=299, block_rows=block_rows)
    for name in ("values", "scales", "sq_norms"):
        assert torch.equal(getattr(blocked, name), getattr(one, name)), name
    want = jax_q.quantize_catalog(jnp.asarray(pool), n_rows=299, block_rows=block_rows)
    _assert_tables_equal(blocked, want)


def test_quantized_catalog_from_numpy_bridge():
    _, pool = _data(n=120, seed=8)
    jq = jax_q.quantize_catalog(jnp.asarray(pool))
    got = tq.QuantizedCatalog.from_numpy(
        np.asarray(jq.values), np.asarray(jq.scales), np.asarray(jq.sq_norms)
    )
    _assert_tables_equal(got, jq)
    assert got.values.is_contiguous() and got.scales.dtype == torch.float32
    with pytest.raises(TypeError, match="int8"):
        tq.QuantizedCatalog.from_numpy(
            np.zeros((2, 4), np.int32), np.ones(2), np.ones(2)
        )


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("widen_rows", [65_536, 50], ids=["one_block", "blocks_of_50"])
def test_retrieve_quantized_matches_jax(approx, widen_rows):
    """Both packages on one int8 table (through the bridge): rows equal,
    distances at 1e-5 relative."""
    queries, pool = _data(n=300, seed=9)
    jq = jax_q.quantize_catalog(jnp.asarray(pool))
    qc = tq.QuantizedCatalog.from_numpy(
        np.asarray(jq.values), np.asarray(jq.scales), np.asarray(jq.sq_norms)
    )
    want = jax_q.retrieve_quantized(jnp.asarray(queries), jq, 10, approx=approx)
    got = tq.retrieve_quantized(
        torch.from_numpy(queries), qc, 10, approx=approx, widen_rows=widen_rows
    )
    d2, idx = got
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(d2.numpy(), np.asarray(want[0]), rtol=TOL, atol=1e-4)


@pytest.mark.parametrize(
    "chunk,k", [(100, 10), (128, 10), (8, 20), (512, 5)],
    ids=["divides", "ragged_tail", "k_above_chunk", "one_chunk"],
)
def test_retrieve_quantized_chunked_matches_jax(chunk, k):
    queries, pool = _data(n=300, seed=10)
    jq = jax_q.quantize_catalog(jnp.asarray(pool))
    qc = tq.quantize_catalog(torch.from_numpy(pool))
    want = jax_q.retrieve_quantized_chunked(
        jnp.asarray(queries), jq, k, chunk_size=chunk
    )
    got = tq.retrieve_quantized_chunked(
        torch.from_numpy(queries), qc, k, chunk_size=chunk, widen_rows=37
    )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=1e-4)
    dense = tq.retrieve_quantized(torch.from_numpy(queries), qc, k)
    assert torch.equal(got[1], dense[1])


def test_int8_route_overlaps_the_dense_route():
    queries, pool = (torch.from_numpy(a) for a in _data(n=300, seed=11))
    dense = tr.retrieve(queries, pool, 10)[1]
    int8 = tq.retrieve_quantized(queries, tq.quantize_catalog(pool), 10)[1]
    overlap = np.mean([
        len(set(a.tolist()) & set(b.tolist())) / 10 for a, b in zip(dense, int8)
    ])
    assert overlap >= 0.9
