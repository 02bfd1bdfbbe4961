"""The PyTorch port's LayerNorm, activations and retrieval ops against the
JAX package's, on the same numpy inputs, in float32 at 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.ops import activations as jax_act
from outfitx_tpu.ops import layernorm as jax_ln
from outfitx_tpu.ops import retrieval as jax_ret
from outfitx_tpu_torch.ops import activations, layernorm, retrieval

torch.set_num_threads(1)

TOL = 1e-5


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def test_layer_norm():
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((4, 5, 64)) + 1.0).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = jax_ln.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = layernorm.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL)


def test_layer_norm_keeps_input_dtype():
    x = torch.randn(3, 16, generator=torch.Generator().manual_seed(0))
    got = layernorm.layer_norm(x.to(torch.bfloat16), torch.ones(16), torch.zeros(16))
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize(
    "name, jax_fn",
    [
        ("mish", jax_act.mish),
        ("gelu", jax.nn.gelu),  # the tanh approximation, JAX's default
        ("relu", jax.nn.relu),
    ],
)
def test_activations(name, jax_fn):
    x = np.linspace(-30.0, 30.0, 2001, dtype=np.float32)
    got = activations.resolve_activation(name)(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(jax_fn(jnp.asarray(x))), rtol=0, atol=TOL)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        activations.resolve_activation("swish")


def _retrieval_data(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    pool = rng.standard_normal((40, 32)).astype(np.float32)
    pools = rng.standard_normal((5, 30, 32)).astype(np.float32)
    return q, pool, pools


@pytest.mark.parametrize("squared", [False, True])
def test_pairwise_l2(squared):
    q, pool, _ = _retrieval_data()
    want = jax_ret.pairwise_l2(jnp.asarray(q), jnp.asarray(pool), squared=squared)
    got = retrieval.pairwise_l2(torch.from_numpy(q), torch.from_numpy(pool), squared=squared)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


def test_topk_smallest():
    rng = np.random.default_rng(1)
    d = rng.permutation(200).reshape(4, 50).astype(np.float32)  # tie-free
    want_v, want_i = jax_ret.topk_smallest(jnp.asarray(d), 7)
    got_v, got_i = retrieval.topk_smallest(torch.from_numpy(d), 7)
    np.testing.assert_array_equal(_np(got_i), _np(want_i))
    np.testing.assert_allclose(_np(got_v), _np(want_v), rtol=0, atol=TOL)


def test_retrieve():
    q, pool, _ = _retrieval_data(2)
    want_d, want_i = jax_ret.retrieve(jnp.asarray(q), jnp.asarray(pool), 10)
    got_d, got_i = retrieval.retrieve(torch.from_numpy(q), torch.from_numpy(pool), 10)
    np.testing.assert_array_equal(_np(got_i), _np(want_i))
    np.testing.assert_allclose(_np(got_d), _np(want_d), rtol=TOL, atol=TOL)


def test_retrieve_per_query_pools():
    q, _, pools = _retrieval_data(3)
    want_d, want_i = jax_ret.retrieve_per_query_pools(jnp.asarray(q), jnp.asarray(pools), 10)
    got_d, got_i = retrieval.retrieve_per_query_pools(
        torch.from_numpy(q), torch.from_numpy(pools), 10
    )
    np.testing.assert_array_equal(_np(got_i), _np(want_i))
    np.testing.assert_allclose(_np(got_d), _np(want_d), rtol=TOL, atol=TOL)


def test_fitb_pick():
    q, _, pools = _retrieval_data(4)
    cands = pools[:, :4]
    want = jax_ret.fitb_pick(jnp.asarray(q), jnp.asarray(cands))
    got = retrieval.fitb_pick(torch.from_numpy(q), torch.from_numpy(cands))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_fitb_pick_takes_the_first_of_tied_candidates():
    q = np.zeros((1, 8), dtype=np.float32)
    c = np.ones((1, 4, 8), dtype=np.float32)
    c[0, 2] = 0.5
    c[0, 3] = 0.5
    assert int(retrieval.fitb_pick(torch.from_numpy(q), torch.from_numpy(c))[0]) == 2
