"""The PyTorch port's masked attention against the JAX package's.

On the CPU ``masked_mha`` runs its plain versions, forward and backward;
they are held against the JAX Pallas kernels (interpret mode off-TPU) and
the JAX reference, on the same numpy inputs, in float32 at 1e-5 (bfloat16
within 2 ulps at O(1)). The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``. The bfloat16
forward's tile walk (packed slabs up to L = 32, one slab's query tiles
above) is emulated here in torch and held bit-equal to the plain version,
and the launch is checked to hand the C entry what it plans from. So is the
bfloat16 backward's walk (packed slabs at every L <= 64, block-diagonal P
and dS tiles, the four products over 64 rows), held against the plain
backward and the Pallas one, with the sum tree that its softmax and row sum
share.
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


# ---- the bfloat16 forward's tile walk --------------------------------------

TILE_ROWS = 64  # query rows of a tile (wgmma's M)


def _tile_plan(l):
    """The C entry's plan for length l (``csrc/masked_mha_fwd.cu``
    ``dispatch_tiles``): slabs a tile (``64 // L`` up to L = 32, then one),
    the score block's width in keys, and the query tiles of a slab, which
    one block takes in turn."""
    keys = TILE_ROWS if l <= TILE_ROWS else 128 if l <= 128 else 256
    return max(TILE_ROWS // l, 1), keys, -(-l // TILE_ROWS)


def _box(flat, row, n):
    """n rows of a flat (rows, Dh) array from ``row`` on, as a TMA box
    reads them: rows past the array are zeros."""
    out = torch.zeros((n, flat.shape[1]), dtype=flat.dtype)
    part = flat[row:row + n]
    out[: part.shape[0]] = part
    return out


def _emulate_tiles(q, k, v, pad, causal):
    """The bfloat16 kernels' walk (``csrc/masked_mha_fwd.cu``: the packed
    kernel where a tile holds two or more slabs, the query-tile kernel else)
    in float32 torch, block by block and tile by tile, with the C entry's
    plan. Each tile scores 64 query
    rows against its ``keys``-wide window of the flat arrays; a key outside
    the row's own slab (another slab, past L, past the array) is -inf, a pad
    or causal key of the slab -1e9 by the slab-local index. P is then 0
    outside the slab, so each row's softmax and P V are taken over its slab's
    L keys (as the plain version sums them). Every stored row is written
    once; the rest stay NaN."""
    b, h, l, dh = q.shape
    bh = b * h
    n_slabs, keys, q_tiles = _tile_plan(l)
    packed = n_slabs > 1
    fq, fk, fv = (t.reshape(bh * l, dh) for t in (q, k, v))
    out = torch.full_like(fq, float("nan"))
    scale = 1.0 / (dh**0.5)
    r = torch.arange(TILE_ROWS)[:, None]
    c = torch.arange(keys)[None, :]
    for blk in range(-(-bh // n_slabs)):
        slab0 = blk * n_slabs
        row0 = slab0 * l
        kt, vt = _box(fk, row0, keys), _box(fv, row0, keys)
        for tile in range(q_tiles):
            qt = _box(fq, row0 + TILE_ROWS * tile, TILE_ROWS)
            s = attention._scores(qt, kt) * scale
            if packed:  # row r is row r % L of slab slab0 + r // L
                sl = r // l
                slab = slab0 + sl
                live = (sl < n_slabs) & (slab < bh)
                lo, i_loc, flat = sl * l, r - sl * l, row0 + r
            else:  # row r is query tile * 64 + r of slab slab0
                slab = torch.full_like(r, slab0)
                lo, i_loc = torch.zeros_like(r), tile * TILE_ROWS + r
                live, flat = i_loc < l, row0 + i_loc
            j = c - lo  # the key's index in the row's slab
            window = live & (j >= 0) & (j < l)
            padded = pad[(slab // h).clamp(max=b - 1), j.clamp(0, l - 1)]
            s = s.masked_fill(window & padded, -1e9)
            if causal:
                s = s.masked_fill(window & (j > i_loc), -1e9)
            s = s.masked_fill(~window, float("-inf"))
            rows = live[:, 0]
            assert torch.all(torch.softmax(s[rows], dim=-1)[~window[rows]] == 0)
            for start in torch.unique(lo[rows]).tolist():
                sel = rows & (lo[:, 0] == start)
                p = torch.zeros(TILE_ROWS, l)
                p[sel] = torch.softmax(s[sel, start:start + l], dim=-1)
                out[flat[sel, 0]] = torch.matmul(p, vt[start:start + l])[sel]
    return out.reshape(q.shape)


# (B, H, L, causal): B * H leaves the last pack ragged wherever a tile
# packs more than one slab (L = 5: 15 slabs, 12 a tile; 8: 15, 8; 9: 12, 7;
# 13: 14, 4; 16: 15, 4; 17: 35, 3; 21: 10, 3; 32: 9, 2); L = 1 packs 64
# slabs a tile and L = 16 fills all 64 rows; from L = 33 a tile holds one
# slab, and L = 129 and 256 take the widest score block.
TILE_CASES = [
    (3, 4, 9, False), (7, 5, 17, False), (7, 5, 17, True), (5, 2, 21, False),
    (3, 3, 32, True), (3, 2, 33, False), (2, 3, 50, False), (2, 3, 64, True),
    (2, 3, 65, False), (2, 2, 77, True), (2, 2, 196, False),
    (5, 3, 1, False), (3, 5, 5, True), (3, 5, 8, False), (2, 7, 13, True),
    (3, 5, 16, False), (3, 5, 16, True), (2, 3, 129, True), (2, 1, 256, False),
]


@pytest.mark.parametrize("b, h, l, causal", TILE_CASES)
def test_tile_walk_matches_reference_and_pallas(b, h, l, causal):
    q, k, v, pad = _inputs(b, h, l, 16, seed=100 + l)
    tq, tk, tv, tpad = _torch(q, k, v, pad)
    got = _emulate_tiles(tq, tk, tv, tpad, causal)
    assert torch.isfinite(got).all()  # every row stored once
    assert torch.equal(got, mha_reference(tq, tk, tv, tpad, causal))
    jq, jk, jv, jpad = (jnp.asarray(a) for a in (q, k, v, pad))
    want = np.asarray(jax_masked_mha(jq, jk, jv, jpad, causal=causal, impl="pallas"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


class _FakeEntry:
    """A C entry that records its calls and how often its argtypes are set."""

    def __init__(self):
        self.calls = []
        self.argtypes_sets = 0
        self._argtypes = None
        self.restype = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.argtypes_sets += 1
        self._argtypes = value

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize(
    "l, dh, dtype",
    [
        (17, 96, torch.bfloat16), (50, 64, torch.bfloat16), (77, 64, torch.bfloat16),
        (196, 64, torch.bfloat16), (17, 96, torch.float32), (17, 24, torch.bfloat16),
        (9, 16, torch.bfloat16), (33, 48, torch.bfloat16), (256, 128, torch.bfloat16),
        (65, 64, torch.float32), (9, 8, torch.bfloat16), (17, 8, torch.bfloat16),
    ],
)
def test_forward_launch_hands_the_kernel_its_tile_plan(monkeypatch, l, dh, dtype):
    """The C entry receives what it plans the tiles from (the shape, the
    causal flag and the dtype code) and the current stream's handle, once
    per call, and nothing else."""
    entry = _FakeEntry()
    lib = type("Lib", (), {"masked_mha_fwd": entry})()
    monkeypatch.setattr(attention, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(attention._build, "load", lambda name: lib)
    monkeypatch.setattr(
        torch._C, "_cuda_getCurrentRawStream", lambda index: 0x7000 + index, raising=False
    )
    q = torch.zeros((7, 5, l, dh), dtype=dtype)
    pad = torch.zeros(7, l, dtype=torch.bool)
    before = masked_mha.launches
    for _ in range(2):
        masked_mha(q, q.clone(), q.clone(), pad, causal=True)
    assert masked_mha.launches == before + 2
    assert entry.argtypes_sets == 1 and len(entry.argtypes) == 12
    for args in entry.calls:
        assert len(args) == 12
        assert args[5:11] == (7, 5, l, dh, 1, 1 if dtype == torch.bfloat16 else 0)
        assert args[11] == 0x7000 + q.get_device()


# ---- the bfloat16 backward's tile walk -------------------------------------


def _bwd_tile_plan(l):
    """The C entry's plan for the backward (``csrc/masked_mha_bwd.cu``
    ``dispatch_tiles``): ``64 // L`` slabs a tile, one from L = 33 on."""
    return max(TILE_ROWS // l, 1)


def _emulate_bwd_tiles(q, k, v, pad, g, causal):
    """The bfloat16 backward kernel's walk (``masked_mha_bwd_tile_kernel``)
    in float32 torch, tile by tile, with the C entry's plan. A tile is 64
    rows of the flat arrays holding ``64 // L`` slabs (TMA's zeros past the
    array). S and dP are taken over the whole tile; a key outside the row's
    own slab is -inf, a pad or causal key of the slab -1e9 by the slab-local
    index. Each row's softmax, and the row sum of dP o P over ``_tree_sum``,
    run over its slab's L keys; P and dS * scale round to the input dtype
    into block-diagonal (64, 64) tiles, and the four products run over all
    64 rows: dP = G V^T, dV = Pb^T G, dQ = dSb K, dK = dSb^T Q. Rows of live
    slabs are stored once; the rest stay NaN."""
    b, h, l, dh = q.shape
    dt = q.dtype
    bh = b * h
    n_slabs = _bwd_tile_plan(l)
    fq, fk, fv, fg = (t.reshape(bh * l, dh) for t in (q, k, v, g))
    outs = [torch.full(fq.shape, float("nan")) for _ in range(3)]
    scale = 1.0 / (dh**0.5)
    r = torch.arange(TILE_ROWS)[:, None]
    c = torch.arange(TILE_ROWS)[None, :]
    for tile in range(-(-bh // n_slabs)):
        slab0 = tile * n_slabs
        row0 = slab0 * l
        qt, kt, vt, gt = (_box(t, row0, TILE_ROWS).float() for t in (fq, fk, fv, fg))
        sl = r // l
        slab = slab0 + sl
        live = (sl < n_slabs) & (slab < bh)
        lo, i_loc = sl * l, r - sl * l
        j = c - lo  # the key's index in the row's slab
        window = live & (j >= 0) & (j < l)
        s = attention._scores(qt, kt) * scale
        padded = pad[(slab // h).clamp(max=b - 1), j.clamp(0, l - 1)]
        s = s.masked_fill(window & padded, -1e9)
        if causal:
            s = s.masked_fill(window & (j > i_loc), -1e9)
        s = s.masked_fill(~window, float("-inf"))
        dp = attention._scores(gt, vt)
        p = torch.zeros(TILE_ROWS, TILE_ROWS)
        ds = torch.zeros(TILE_ROWS, TILE_ROWS)
        rows = live[:, 0]
        for start in torch.unique(lo[rows]).tolist():
            sel = rows & (lo[:, 0] == start)
            keys = slice(start, start + l)
            ps = torch.softmax(s[sel, keys], dim=-1)
            dps = dp[sel, keys]
            p[sel, keys] = ps
            ds[sel, keys] = ps * (dps - attention._tree_sum(dps * ps))
        assert torch.all(p[~window] == 0) and torch.all(ds[~window] == 0)
        pb = p.to(dt).float()
        dsb = (ds * scale).to(dt).float()
        tile_out = (dsb @ kt, dsb.T @ qt, pb.T @ gt)  # dq, dk, dv
        flat = row0 + torch.nonzero(rows)[:, 0]
        for out, t in zip(outs, tile_out):
            out[flat] = t[rows].to(dt).float()
    return [o.reshape(q.shape) for o in outs]


BWD_TILE_SHAPES = sorted({(b, h, l) for b, h, l, _ in TILE_CASES if l <= 64})


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b, h, l", BWD_TILE_SHAPES)
def test_bwd_tile_walk_matches_reference_and_pallas(b, h, l, causal):
    """float32: the walk against the plain backward and the Pallas backward
    (interpret mode) at 1e-5; the products sum over 64 rows with zeros,
    in another order than the plain version's L terms."""
    q, k, v, pad = _inputs(b, h, l, 16, seed=200 + l)
    g = _cotangent(q, seed=l)
    tq, tk, tv, tpad, tg = _torch(q, k, v, pad, g)
    got = _emulate_bwd_tiles(tq, tk, tv, tpad, tg, causal)
    want = mha_bwd_reference(tq, tk, tv, tpad, tg, causal)
    pallas = _mha_bwd_pallas_impl(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(pad), jnp.asarray(g), causal
    )
    m = _kept_key0_masked(pad, q.shape)
    for name, a, w, p in zip(("dq", "dk", "dv"), got, want, pallas):
        assert torch.isfinite(a).all(), name  # every row stored once
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0, atol=TOL, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(p), rtol=0, atol=TOL, err_msg=name)
        if name != "dq":
            assert np.all(a.numpy()[m] == 0), name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b, h, l", [(7, 5, 17), (2, 7, 13), (3, 3, 32), (2, 3, 64)])
def test_bwd_tile_walk_in_bfloat16_rounds_like_the_reference(b, h, l, causal):
    """bfloat16: the walk rounds P and dS where the plain backward does, so
    only the products' sum order differs: within 2 bf16 ulps at O(1)."""
    q, k, v, pad = _inputs(b, h, l, 16, seed=300 + l)
    g = _cotangent(q, seed=l + 1)
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g))
    tpad = torch.from_numpy(pad)
    got = _emulate_bwd_tiles(tq, tk, tv, tpad, tg, causal)
    want = mha_bwd_reference(tq, tk, tv, tpad, tg, causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(
            a.numpy(), w.float().numpy(), rtol=2.0**-7, atol=2.0**-7, err_msg=name
        )


def _tree_64(x):
    """The backward kernel's softmax and row-sum tree, as float32 torch ops:
    64 slots (zeros past the length), the upper 32 onto the lower, then the
    halves at 16, 8, 4, 2, 1."""
    t = torch.nn.functional.pad(x, (0, 64 - x.shape[-1]))
    t = t[..., :32] + t[..., 32:]
    for o in (16, 8, 4, 2, 1):
        t = t[..., :o] + t[..., o : 2 * o]
    return t[..., 0]


def _tree_32(x):
    """The forward's packed kernel's tree (``masked_mha_fwd.cu``, L <= 32):
    32 slots, t[j] = e[j] + e[j + 16], then 8, 4, 2, 1."""
    t = torch.nn.functional.pad(x, (0, 32 - x.shape[-1]))
    for o in (16, 8, 4, 2, 1):
        t = t[..., :o] + t[..., o : 2 * o]
    return t[..., 0]


def _quad_tree(x):
    """The same tree as the backward kernel's ``quad_tree_sum`` takes it:
    thread q of a quad holds slot 16 a + 4 q + i at x_q[4 a + i]; the steps
    at 32 and 16 run in a thread, 8 and 4 against the partner q ^ 2 and
    q ^ 1, 2 and 1 in thread 0."""
    slots = 32 if x.shape[-1] <= 32 else 64
    xs = torch.nn.functional.pad(x, (0, slots - x.shape[-1]))
    held = [
        [xs[..., 16 * a + 4 * q + i] for a in range(slots // 16) for i in range(4)]
        for q in range(4)
    ]
    t = []
    for q in range(4):
        xq = held[q]
        if slots == 64:
            t.append([(xq[i] + xq[8 + i]) + (xq[4 + i] + xq[12 + i]) for i in range(4)])
        else:
            t.append([xq[i] + xq[4 + i] for i in range(4)])
    for o in (2, 1):
        t = [[t[q][i] + t[q ^ o][i] for i in range(4)] for q in range(4)]
    return (t[0][0] + t[0][2]) + (t[0][1] + t[0][3])


def _softmax_terms(l, seed):
    """exp(s - max) of 4096 rows of l scores, float32 in (0, 1]."""
    s = torch.from_numpy(np.random.default_rng(seed).standard_normal((4096, l)) * 4)
    s = s.float()
    return torch.exp(s - s.max(dim=-1, keepdim=True).values)


@pytest.mark.parametrize("l", range(1, 33))
def test_64_slot_tree_sums_as_the_32_slot_tree(l):
    """Up to 32 keys the upper 32 slots are exact zeros, so the backward's
    64-slot tree gives the forward's 32-slot sums bit for bit. (The CPU's
    torch.softmax sums in another order than the card's warp softmax, so
    the tree is held against torch.softmax itself only on the card.)"""
    e = _softmax_terms(l, seed=l)
    assert torch.equal(_tree_64(e), _tree_32(e))


@pytest.mark.parametrize("l", [1, 5, 16, 17, 31, 32, 33, 40, 63, 64])
def test_quad_split_and_plain_version_take_the_64_slot_tree(l):
    """The kernel's four-thread split adds the same operands in the same
    tree, and the plain backward's ``_tree_sum`` is that tree: all equal
    bit for bit, on softmax terms and on signed products dP o P."""
    e = _softmax_terms(l, seed=100 + l)
    x = e * torch.from_numpy(np.random.default_rng(l).standard_normal(e.shape)).float()
    for terms in (e, x):
        want = _tree_64(terms)
        assert torch.equal(_quad_tree(terms), want)
        assert torch.equal(attention._tree_sum(terms)[..., 0], want)


@pytest.mark.parametrize(
    "l, dh, dtype",
    [
        (17, 96, torch.bfloat16), (9, 16, torch.bfloat16), (1, 16, torch.bfloat16),
        (32, 32, torch.bfloat16), (33, 48, torch.bfloat16), (64, 128, torch.bfloat16),
        (17, 96, torch.float32), (64, 8, torch.float32), (17, 24, torch.bfloat16),
        (17, 8, torch.bfloat16),
    ],
)
def test_backward_launch_hands_the_kernel_its_tile_plan(monkeypatch, l, dh, dtype):
    """On every route (the tile kernel for bfloat16 at Dh % 16 == 0, the
    narrow kernel at Dh = 8 up to L = 32, the scalar kernel else) the C
    entry receives the same 15 arguments: the
    seven tensors, the shape, the causal flag, the dtype code and the
    current stream's handle, once per call; it plans the tiles itself."""
    entry = _FakeEntry()
    lib = type("Lib", (), {"masked_mha_bwd": entry})()
    monkeypatch.setattr(attention._build, "load", lambda name: lib)
    monkeypatch.setattr(
        torch._C, "_cuda_getCurrentRawStream", lambda index: 0x7000 + index, raising=False
    )
    q = torch.zeros((7, 5, l, dh), dtype=dtype)
    pad = torch.zeros(7, l, dtype=torch.bool)
    before = masked_mha.bwd_launches
    for causal in (False, True):
        dq, dk, dv = _masked_mha_bwd_cuda(q, q.clone(), q.clone(), pad, q.clone(), causal)
        assert dq.shape == dk.shape == dv.shape == q.shape and dq.dtype == dtype
    assert masked_mha.bwd_launches == before + 2
    assert entry.argtypes_sets == 1 and len(entry.argtypes) == 15
    for causal, args in zip((0, 1), entry.calls):
        assert len(args) == 15
        assert args[8:14] == (7, 5, l, dh, causal, 1 if dtype == torch.bfloat16 else 0)
        assert args[14] == 0x7000 + q.get_device()
