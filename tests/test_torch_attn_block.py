"""The PyTorch port's fused attention block against the JAX package's.

On the CPU ``attn_block`` runs its plain version; it is held against the JAX
Pallas kernel (interpret mode off-TPU) on the same numpy inputs, in float32
at 1e-5 and in bfloat16 within 2 ulps at O(1). The CUDA kernel itself is
held against the same plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from outfitx_tpu.ops.attn_block import attn_block as jax_attn_block
from outfitx_tpu_torch.ops import attn_block as ab
from outfitx_tpu_torch.ops.attn_block import attn_block, attn_block_reference

torch.set_num_threads(1)

TOL = 1e-5
# bfloat16: q, k, v, P and ctx round to bfloat16 in both packages, whose
# products accumulate in another order, so a value at a rounding boundary may
# flip by one ulp in either; the float32 output sums such terms.
BF16_TOL = 2.0**-7


def _inputs(b, l, d, seed=0, pad_heavy=False):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(d)
    y = rng.standard_normal((b, l, d)).astype(np.float32)
    wqkv = rng.uniform(-bound, bound, (d, 3, d)).astype(np.float32)
    bqkv = rng.uniform(-bound, bound, (3, d)).astype(np.float32)
    wo = rng.uniform(-bound, bound, (d, d)).astype(np.float32)
    pad = rng.random((b, l)) < (0.8 if pad_heavy else 0.3)
    pad[:, 0] = False
    pad[0] = True  # every key masked: uniform weights, not NaN
    return y, wqkv, bqkv, wo, pad


def _torch(arrays, dtype=torch.float32):
    *floats, pad = arrays
    return [torch.from_numpy(a).to(dtype).clone() for a in floats] + [torch.from_numpy(pad)]


def _jax(arrays, dtype=jnp.float32):
    *floats, pad = arrays
    return [jnp.asarray(a, dtype=dtype) for a in floats] + [jnp.asarray(pad)]


@pytest.mark.parametrize(
    "b, l, d, h, causal, pad_heavy",
    [
        (3, 16, 64, 4, False, False),
        (3, 17, 64, 4, False, False),  # the set transformer's odd length
        (2, 64, 64, 4, False, True),  # a mostly padded 64-token row
        (3, 16, 64, 4, True, False),
        (5, 9, 96, 2, True, True),  # Dh = 48, a batch the tile does not divide
    ],
)
def test_attn_block_matches_jax(b, l, d, h, causal, pad_heavy):
    arrays = _inputs(b, l, d, seed=l + d, pad_heavy=pad_heavy)
    want = np.asarray(jax_attn_block(*_jax(arrays), n_heads=h, causal=causal))
    got = attn_block(*_torch(arrays), h, causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, l, d)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bfloat16_keeps_the_roundings_and_a_float32_output(causal):
    arrays = _inputs(3, 16, 64, seed=7)
    want = jax_attn_block(*_jax(arrays, jnp.bfloat16), n_heads=4, causal=causal)
    got = attn_block(*_torch(arrays, torch.bfloat16), 4, causal=causal)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BF16_TOL, atol=BF16_TOL)


def test_explicit_scale_is_kept():
    arrays = _inputs(2, 16, 64, seed=3)
    want = np.asarray(jax_attn_block(*_jax(arrays), n_heads=4, scale=0.5))
    got = attn_block(*_torch(arrays), 4, scale=0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    default = attn_block(*_torch(arrays), 4)
    assert not np.allclose(got.numpy(), default.numpy(), atol=1e-3)


def test_fully_masked_row_is_uniform():
    """Row 0 masks every key: its weights are uniform, so every token's
    context is the mean of v and every token's output is the same."""
    y, wqkv, bqkv, wo, pad = _torch(_inputs(2, 16, 64, seed=1))
    got = attn_block(y, wqkv, bqkv, wo, pad, 4)
    assert torch.isfinite(got).all()
    v = y[0] @ wqkv[:, 2, :] + bqkv[2]
    want = v.mean(dim=0) @ wo
    np.testing.assert_allclose(
        got[0].numpy(), want.expand(16, -1).numpy(), rtol=0, atol=1e-5
    )


def test_cpu_tensors_never_launch_the_kernel():
    before = attn_block.launches
    attn_block(*_torch(_inputs(2, 16, 64)), 4)
    assert attn_block.launches == before


def test_kernel_branch_swallows_no_error(monkeypatch):
    """With the kernel predicate true, a failing kernel load reaches the
    caller, and the plain version is not run in its place."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args)
        return attn_block_reference(*args, **kwargs)

    def broken_load(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(ab, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(ab._launch._build, "load", broken_load)
    monkeypatch.setattr(ab, "attn_block_reference", spy)
    before = attn_block.launches
    with pytest.raises(RuntimeError, match="cannot build attn_block"):
        attn_block(*_torch(_inputs(2, 16, 64)), 4)
    assert calls == []
    assert attn_block.launches == before


@pytest.mark.parametrize(
    "b, l, d, h, dtype, error",
    [
        (2, 65, 64, 4, torch.float32, ValueError),  # L above 64
        (2, 16, 96, 2, torch.float32, ValueError),  # d not a multiple of 64
        (2, 16, 64, 8, torch.float32, ValueError),  # Dh = 8, not a multiple of 16
        (2, 16, 256, 1, torch.float32, ValueError),  # Dh above 128
        (2, 16, 64, 4, torch.float16, TypeError),  # dtype the kernel lacks
    ],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(
    monkeypatch, b, l, d, h, dtype, error
):
    monkeypatch.setattr(ab, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(
        ab._launch._build, "load", lambda name: pytest.fail("kernel was loaded")
    )
    y = torch.zeros((b, l, d), dtype=dtype)
    wqkv = torch.zeros((d, 3, d), dtype=dtype)
    bqkv = torch.zeros((3, d), dtype=dtype)
    wo = torch.zeros((d, d), dtype=dtype)
    pad = torch.zeros((b, l), dtype=torch.bool)
    with pytest.raises(error):
        attn_block(y, wqkv, bqkv, wo, pad, h)


def test_kernel_wrapper_rejects_noncontiguous(monkeypatch):
    monkeypatch.setattr(ab, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(
        ab._launch._build, "load", lambda name: pytest.fail("kernel was loaded")
    )
    y, wqkv, bqkv, wo, pad = _torch(_inputs(2, 16, 64))
    with pytest.raises(ValueError, match="contiguous"):
        attn_block(y.transpose(0, 1).contiguous().transpose(0, 1), wqkv, bqkv, wo, pad, 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_hands_bfloat16_its_scratch(monkeypatch, dtype):
    """The bfloat16 kernel's phases hand over through two scratch tensors,
    q|k|v (B L, 3 d) and ctx (B, L, d); float32 gets none. One call is one
    launch."""
    calls = []
    sizes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append((tuple(t.shape), t.dtype))
        return t

    def bind(name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append(args)
            return 0
        return fn

    monkeypatch.setattr(ab, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(ab._launch, "bind", bind)
    monkeypatch.setattr(ab.torch, "empty", empty)
    monkeypatch.setattr(ab._launch, "current_stream", lambda index: 0)
    y, wqkv, bqkv, wo, pad = _torch(_inputs(5, 9, 128), dtype)
    before = attn_block.launches
    out = attn_block(y, wqkv, bqkv, wo, pad, 2)
    assert out.shape == (5, 9, 128) and out.dtype == torch.float32
    assert attn_block.launches == before + 1
    (args,) = calls
    qkv, ctx = args[5], args[6]
    assert args[8:12] == (5, 9, 128, 2)
    if dtype == torch.bfloat16:
        assert qkv is not None and ctx is not None
        assert ((45, 384), torch.bfloat16) in sizes
    else:
        assert qkv is None and ctx is None
        assert sizes == [((5, 9, 128), torch.float32)]
