"""The PyTorch port's masked attention against the JAX package's.

On the CPU ``masked_mha`` runs its plain versions, forward and backward;
they are held against the JAX Pallas kernels (interpret mode off-TPU) and
the JAX reference, on the same numpy inputs, in float32 at 1e-5 (bfloat16
within 2 ulps at O(1)). The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.ops.attention import _mha_bwd_pallas_impl, _mha_reference
from outfitx_tpu.ops.attention import masked_mha as jax_masked_mha
from outfitx_tpu_torch.ops import attention
from outfitx_tpu_torch.ops.attention import (
    _masked_mha_bwd_cuda,
    masked_mha,
    mha_bwd_reference,
    mha_reference,
)

torch.set_num_threads(1)

TOL = 1e-5


def _inputs(b, h, l, dh, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, l, dh)).astype(np.float32) for _ in range(3))
    pad = rng.random((b, l)) < 0.3
    pad[:, 0] = False
    pad[0] = True
    pad[0, 0] = False  # key 0 only: the JAX kernel's batch-padding rows
    pad[1] = True  # every key masked: uniform weights, not NaN
    return q, k, v, pad


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [9, 17])
def test_masked_mha_matches_jax(l, causal):
    q, k, v, pad = _inputs(3, 4, l, 16, seed=l)
    jq, jk, jv, jpad = (jnp.asarray(a) for a in (q, k, v, pad))
    want_pallas = np.asarray(
        jax_masked_mha(jq, jk, jv, jpad, causal=causal, impl="pallas")
    )
    want_ref = np.asarray(_mha_reference(jq, jk, jv, jpad, causal=causal))
    got = masked_mha(*_torch(q, k, v, pad), causal=causal).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("l, causal", [(50, False), (77, True), (196, False)])
def test_masked_mha_matches_jax_at_tower_lengths(l, causal):
    """The frozen towers' lengths: ViT-B/32 (50), CLIP text (77, causal) and
    SigLIP ViT-B/16 (196), against the route the JAX towers take (``auto``:
    the direct kernel up to 128, the padded kernel above) and the JAX
    reference."""
    q, k, v, pad = _inputs(2, 2, l, 16, seed=l)
    jq, jk, jv, jpad = (jnp.asarray(a) for a in (q, k, v, pad))
    want_auto = np.asarray(jax_masked_mha(jq, jk, jv, jpad, causal=causal))
    want_ref = np.asarray(_mha_reference(jq, jk, jv, jpad, causal=causal))
    got = masked_mha(*_torch(q, k, v, pad), causal=causal).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_auto, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=TOL)


def test_fully_masked_row_is_uniform():
    q, k, v, pad = _inputs(3, 2, 9, 8)
    got = masked_mha(*_torch(q, k, v, pad)).numpy()
    uniform = v[1].mean(axis=1, keepdims=True)  # row 1: every key masked
    np.testing.assert_allclose(got[1], np.broadcast_to(uniform, got[1].shape), atol=TOL)


def test_bfloat16_rounds_probabilities_like_jax():
    q, k, v, pad = _inputs(2, 2, 17, 16, seed=3)
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(_mha_reference(jq, jk, jv, jnp.asarray(pad)).astype(jnp.float32))
    tq, tk, tv = (t.to(torch.bfloat16) for t in _torch(q, k, v))
    got = masked_mha(tq, tk, tv, torch.from_numpy(pad)).float().numpy()
    # Same roundings (P and the output to bfloat16); 2 bf16 ulps at O(1).
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-7)


def test_cpu_tensors_never_launch_the_kernel():
    before = masked_mha.launches
    masked_mha(*_torch(*_inputs(2, 2, 9, 8)))
    assert masked_mha.launches == before


def test_kernel_branch_swallows_no_error(monkeypatch):
    """With the kernel predicate true, a failing kernel load reaches the
    caller, and the plain version is not run in its place."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args)
        return mha_reference(*args, **kwargs)

    def broken_load(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(attention, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(attention._build, "load", broken_load)
    monkeypatch.setattr(attention, "mha_reference", spy)
    before = masked_mha.launches
    with pytest.raises(RuntimeError, match="cannot build masked_mha_fwd"):
        masked_mha(*_torch(*_inputs(2, 2, 9, 8)))
    assert calls == []
    assert masked_mha.launches == before


@pytest.mark.parametrize(
    "shape, dtype, error",
    [
        ((2, 2, 9, 12), torch.float32, ValueError),  # Dh not a multiple of 8
        ((2, 2, 257, 16), torch.float32, ValueError),  # L above 256
        ((2, 2, 65, 24), torch.float32, ValueError),  # above L=64: Dh % 16
        ((2, 2, 9, 136), torch.float32, ValueError),  # Dh above 128
        ((2, 2, 9, 16), torch.float16, TypeError),  # dtype the kernel lacks
    ],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(
    monkeypatch, shape, dtype, error
):
    monkeypatch.setattr(attention, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(
        attention._build, "load", lambda name: pytest.fail("kernel was loaded")
    )
    q = torch.zeros(shape, dtype=dtype)
    pad = torch.zeros(shape[0], shape[2], dtype=torch.bool)
    with pytest.raises(error):
        masked_mha(q, q.clone(), q.clone(), pad)


def test_kernel_wrapper_rejects_noncontiguous(monkeypatch):
    monkeypatch.setattr(attention, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(
        attention._build, "load", lambda name: pytest.fail("kernel was loaded")
    )
    q = torch.zeros(2, 9, 2, 16).transpose(1, 2)
    pad = torch.zeros(2, 9, dtype=torch.bool)
    with pytest.raises(ValueError, match="contiguous"):
        masked_mha(q, q, q, pad)


def test_forward_wrapper_takes_tower_lengths(monkeypatch):
    """L up to 256 passes the wrapper's checks and reaches the kernel's
    loader (stubbed here: the CPU tests have no compiler)."""
    loaded = []

    def load(name):
        loaded.append(name)
        raise RuntimeError("no compiler here")

    monkeypatch.setattr(attention, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(attention._build, "load", load)
    for l in (65, 196, 256):
        q = torch.zeros((2, 2, l, 64))
        with pytest.raises(RuntimeError, match="no compiler here"):
            masked_mha(q, q.clone(), q.clone(), torch.zeros(2, l, dtype=torch.bool))
    assert loaded == ["masked_mha_fwd"] * 3


def test_backward_kernel_keeps_l_at_most_64(monkeypatch):
    """The towers are frozen: above L=64 the backward raises on the card."""
    monkeypatch.setattr(
        attention._build, "load", lambda name: pytest.fail("kernel was loaded")
    )
    q = torch.zeros((2, 2, 65, 16))
    pad = torch.zeros(2, 65, dtype=torch.bool)
    with pytest.raises(ValueError, match="backward kernel takes 1 <= L <= 64"):
        _masked_mha_bwd_cuda(q, q.clone(), q.clone(), pad, q.clone(), False)


def _cotangent(q, seed=1):
    return np.random.default_rng(seed).standard_normal(q.shape).astype(np.float32)


def _kept_key0_masked(pad, shape):
    """Masked keys of the batch rows whose key 0 is kept: their dk and dv
    must be exactly 0 (a fully masked row has uniform P, so not there)."""
    m = pad & ~pad[:, :1]
    return np.broadcast_to(m[:, None, :, None], shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [9, 17])
def test_bwd_reference_matches_pallas_bwd(l, causal, dtype):
    q, k, v, pad = _inputs(3, 4, l, 16, seed=l + 1)
    g = _cotangent(q)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = _mha_bwd_pallas_impl(
        *(jnp.asarray(a, dtype=jdt) for a in (q, k, v)), jnp.asarray(pad),
        jnp.asarray(g, dtype=jdt), causal,
    )
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    got = mha_bwd_reference(tq, tk, tv, torch.from_numpy(pad), tg, causal)
    m = _kept_key0_masked(pad, q.shape)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt, name
        a = a.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert np.isfinite(a).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(a, w, rtol=0, atol=TOL, err_msg=name)
        else:
            np.testing.assert_allclose(a, w, rtol=2.0**-7, atol=2.0**-7, err_msg=name)
        if name != "dq":
            assert np.all(a[m] == 0), name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [9, 17])
def test_autograd_matches_jax_grad(l, causal):
    q, k, v, pad = _inputs(3, 4, l, 16, seed=2 * l)
    w = _cotangent(q, seed=5)

    def jloss(q, k, v):
        out = jax_masked_mha(q, k, v, jnp.asarray(pad), causal=causal, impl="pallas")
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = masked_mha(tq, tk, tv, torch.from_numpy(pad), causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)


def test_cpu_backward_never_launches_the_kernel():
    before = masked_mha.bwd_launches
    q, k, v, pad = _torch(*_inputs(2, 2, 9, 8))
    q.requires_grad_()
    masked_mha(q, k, v, pad).sum().backward()
    assert q.grad is not None
    assert masked_mha.bwd_launches == before


def test_backward_kernel_branch_swallows_no_error(monkeypatch):
    """With the kernel predicate true, a failing backward-kernel load
    reaches the caller of ``backward()``, and the plain backward is not run
    in its place."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args)
        return mha_bwd_reference(*args, **kwargs)

    def load(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(attention, "_wants_kernel", lambda t: True)
    # The forward stands in for its kernel, so the backward is reached.
    monkeypatch.setattr(
        attention, "_masked_mha_cuda",
        lambda q, k, v, pad, causal: mha_reference(q, k, v, pad, causal),
    )
    monkeypatch.setattr(attention._build, "load", load)
    monkeypatch.setattr(attention, "mha_bwd_reference", spy)
    q, k, v, pad = _torch(*_inputs(2, 2, 9, 8))
    q.requires_grad_()
    out = masked_mha(q, k, v, pad)
    before = masked_mha.bwd_launches
    with pytest.raises(RuntimeError, match="cannot build masked_mha_bwd"):
        out.sum().backward()
    assert calls == []
    assert masked_mha.bwd_launches == before


@pytest.mark.parametrize(
    "bad", ["shape", "dtype", "noncontiguous"],
)
def test_backward_wrapper_rejects_a_g_it_cannot_take(monkeypatch, bad):
    monkeypatch.setattr(
        attention._build, "load", lambda name: pytest.fail("kernel was loaded")
    )
    q, k, v, pad = _torch(*_inputs(2, 2, 9, 16))
    g = {
        "shape": torch.zeros(2, 2, 8, 16),
        "dtype": torch.zeros(2, 2, 9, 16, dtype=torch.bfloat16),
        "noncontiguous": torch.zeros(2, 9, 2, 16).transpose(1, 2),
    }[bad]
    with pytest.raises(ValueError):
        _masked_mha_bwd_cuda(q, k, v, pad, g, False)
