"""The narrow-head (Dh = 8) bfloat16 route of the port's attention kernels.

``csrc/narrow_mha.cuh`` walks groups of ``THREADS // L`` slabs of the flat
(B H L, Dh) arrays, the last group ragged, a thread a query row. A row's key
mask comes from the warps' ballots of each group row's own pad flag, cut by
the slab-local index; S (and dP) sum over Dh in order; the softmax's and
the row sum's trees run serially in one thread; P (and dS) round to the
input dtype into blocks that the tensor cores read a slab at a time. That
walk is emulated here in torch and held bit-equal to the plain versions
(``mha_reference``, ``mha_bwd_reference``) in float32 and bfloat16, and to
the JAX Pallas kernels (interpret mode) within ``TOL``. As in
``test_torch_attention.py``'s ``_emulate_tiles``, the emulation takes P
from ``torch.softmax`` itself: on the CPU it sums in another order than the
card's warp softmax, whose tree the kernels repeat; the in-thread tree is
held against ``_tree_sum`` here, and against ``torch.softmax`` on the card
by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from outfitx_tpu.ops.attention import _mha_bwd_pallas_impl
from outfitx_tpu.ops.attention import masked_mha as jax_masked_mha
from outfitx_tpu_torch.ops import attention
from outfitx_tpu_torch.ops.attention import mha_bwd_reference, mha_reference

torch.set_num_threads(1)

TOL = 1e-5
FWD_THREADS = 256  # csrc/masked_mha_fwd.cu kNarrowThreads
BWD_THREADS = 128  # csrc/masked_mha_bwd.cu kNarrowThreads


def _inputs(b, h, l, seed):
    """q, k, v, g ~ N(0, 1) at Dh = 8 and a pad mask: 30% of keys padded,
    key 0 kept; batch row 0 keeps only key 0, row 1 masks every key (uniform
    P, not NaN)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, l, 8)).astype(np.float32) for _ in range(4))
    pad = rng.random((b, l)) < 0.3
    pad[:, 0] = False
    pad[0] = True
    pad[0, 0] = False
    pad[1] = True
    return q, k, v, g, pad


def _group_masks(pad, slab0, live, l, h, causal):
    """The kernel's key masks for the group of ``live`` slabs from slab0:
    each group row's own pad flag (row r stands for key r % L of slab slab0 +
    r // L), ballotted 32 rows a word; a slab's L bits cut from the words at
    its first row (``slab_pad_bits``), and a causal row's keys past it.
    Returns (live, L, L) bool, True = masked."""
    rows = live * l
    r = torch.arange(rows)
    flags = pad[(slab0 + r // l) // h, r % l]
    words = [0] * (rows // 32 + 2)
    for row in torch.nonzero(flags)[:, 0].tolist():
        words[row // 32] |= 1 << (row % 32)
    masks = torch.zeros((live, l, l), dtype=torch.bool)
    for sl in range(live):
        first = sl * l
        w, off = divmod(first, 32)
        bits = words[w] >> off
        if off:
            bits |= words[w + 1] << (32 - off)
        bits &= (1 << l) - 1
        masks[sl] = torch.tensor([bool(bits >> j & 1) for j in range(l)])[None, :]
    if causal:
        masks |= torch.ones((l, l), dtype=torch.bool).triu(1)
    return masks


def _groups(bh, l, threads):
    """(first slab, live slabs) of each group of the walk: threads // L slabs
    a group, the last one ragged."""
    per = threads // l
    return [(s0, min(per, bh - s0)) for s0 in range(0, bh, per)]


def _softmax_rows(q, k, masks, scale):
    """S of a group's slabs (in order over Dh), the masks where-set to
    -1e9, and P by torch.softmax."""
    s = attention._scores(q, k) * scale
    return torch.softmax(s.masked_fill(masks, -1e9), dim=-1)


def _emulate_narrow_fwd(q, k, v, pad, causal):
    """The narrow forward's walk (``masked_mha_fwd_narrow_kernel``), group by
    group: P of each slab's rows against its own keys, rounded to the input
    dtype, then O = P V a slab at a time. Rows stored once; the rest NaN."""
    b, h, l, dh = q.shape
    fq, fk, fv = (t.reshape(b * h, l, dh) for t in (q, k, v))
    out = torch.full((b * h, l, dh), float("nan"))
    scale = 1.0 / (dh**0.5)
    for slab0, live in _groups(b * h, l, FWD_THREADS):
        sel = slice(slab0, slab0 + live)
        masks = _group_masks(pad, slab0, live, l, h, causal)
        p = _softmax_rows(fq[sel], fk[sel], masks, scale).to(q.dtype)
        out[sel] = torch.matmul(p.float(), fv[sel].float()).to(q.dtype).float()
    return out.reshape(q.shape)


def _thread_tree(x, signed):
    """``narrow_mha.cuh tree_sum<L, SIGNED>`` as one thread takes it, a row at
    a time (vectorised over rows): the 64-slot tree with every addition of a
    slot of zeros only left out, and its first step, x + 0, only for signed
    terms."""
    l = x.shape[-1]
    t = [x[..., j] + 0.0 if signed else x[..., j] for j in range(l)]
    for step in range(5):
        o = 16 >> step
        for j in range(16):
            if j < o and j + o < l:
                t[j] = t[j] + t[j + o]
    return t[0]


def _emulate_narrow_bwd(q, k, v, pad, g, causal):
    """The narrow backward's walk (``masked_mha_bwd_narrow_kernel``), group
    by group: P of each slab's rows, dP in order over Dh, rowsum(dP o P)
    over the in-thread tree, dS = P o (dP - rowsum); Pb and dS * scale
    rounded to the input dtype; dQ = dSb K, dV = Pb^T G, dK = dSb^T Q a slab
    at a time. Rows stored once; the rest NaN."""
    b, h, l, dh = q.shape
    dt = q.dtype
    fq, fk, fv, fg = (t.reshape(b * h, l, dh) for t in (q, k, v, g))
    outs = [torch.full((b * h, l, dh), float("nan")) for _ in range(3)]
    scale = 1.0 / (dh**0.5)
    for slab0, live in _groups(b * h, l, BWD_THREADS):
        sel = slice(slab0, slab0 + live)
        masks = _group_masks(pad, slab0, live, l, h, causal)
        p = _softmax_rows(fq[sel], fk[sel], masks, scale)
        dp = attention._scores(fg[sel], fv[sel])
        ds = p * (dp - _thread_tree(dp * p, signed=True)[..., None])
        pb = p.to(dt).float()
        dsb = (ds * scale).to(dt).float()
        qf, kf, gf = (t[sel].float() for t in (fq, fk, fg))
        got = (dsb @ kf, dsb.transpose(-1, -2) @ qf, pb.transpose(-1, -2) @ gf)
        for out, t in zip(outs, got):
            out[sel] = t.to(dt).float()
    return [o.reshape(q.shape) for o in outs]


# (B, H, L): B*H leaves the last group ragged in both walks (forward 256 //
# L slabs a group, backward 128 // L): L=1: 300 slabs, 256 and 128 a group;
# 5: 60, 51 and 25; 9: 35, 28 and 14; 16: 35, 16 and 8; 17: 40, 15 and 7;
# 31 and 32: 15, 8 and 4.
NARROW_CASES = [
    (20, 15, 1), (12, 5, 5), (7, 5, 9), (7, 5, 16), (8, 5, 17), (5, 3, 31), (5, 3, 32),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b, h, l", NARROW_CASES)
def test_narrow_forward_walk_equals_the_plain_version(b, h, l, causal, dtype):
    q, k, v, _, pad = _inputs(b, h, l, seed=400 + l)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tpad = torch.from_numpy(pad)
    got = _emulate_narrow_fwd(tq, tk, tv, tpad, causal)
    assert torch.isfinite(got).all()  # every row stored once
    assert torch.equal(got, mha_reference(tq, tk, tv, tpad, causal).float())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b, h, l", NARROW_CASES)
def test_narrow_backward_walk_equals_the_plain_version(b, h, l, causal, dtype):
    q, k, v, g, pad = _inputs(b, h, l, seed=500 + l)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    tpad = torch.from_numpy(pad)
    got = _emulate_narrow_bwd(tq, tk, tv, tpad, tg, causal)
    want = mha_bwd_reference(tq, tk, tv, tpad, tg, causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name  # every row stored once
        assert torch.equal(a, w.float()), name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b, h, l", NARROW_CASES)
def test_narrow_walks_match_the_pallas_kernels(b, h, l, causal):
    """float32 against the JAX Pallas forward and backward (interpret mode)
    at 1e-5: their sums run in other orders than the plain version's."""
    q, k, v, g, pad = _inputs(b, h, l, seed=600 + l)
    tq, tk, tv, tg, tpad = (torch.from_numpy(a) for a in (q, k, v, g, pad))
    jq, jk, jv, jg, jpad = (jnp.asarray(a) for a in (q, k, v, g, pad))
    fwd = _emulate_narrow_fwd(tq, tk, tv, tpad, causal)
    want = np.asarray(jax_masked_mha(jq, jk, jv, jpad, causal=causal, impl="pallas"))
    np.testing.assert_allclose(fwd.numpy(), want, rtol=0, atol=TOL)
    bwd = _emulate_narrow_bwd(tq, tk, tv, tpad, tg, causal)
    pallas = _mha_bwd_pallas_impl(jq, jk, jv, jpad, jg, causal)
    for name, a, w in zip(("dq", "dk", "dv"), bwd, pallas):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=TOL, err_msg=name)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("l", range(1, 33))
def test_thread_tree_is_the_64_slot_tree(l):
    """The in-thread tree (additions of zero slots left out; the first step
    only for signed terms) gives ``_tree_sum``'s sums bit for bit, sign of
    zero too: on softmax terms exp(s - max) and on signed products dP o P,
    among them exact zeros and -0."""
    rng = np.random.default_rng(700 + l)
    s = torch.from_numpy(rng.standard_normal((2048, l)) * 4).float()
    e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    x = e * torch.from_numpy(rng.standard_normal(e.shape)).float()
    x[:64] = -0.0  # rows of -0 products only
    x[64:128, : l // 2] = 0.0
    for terms, signed in ((e, False), (x, True)):
        want = attention._tree_sum(terms)[..., 0]
        assert torch.equal(_bits(_thread_tree(terms, signed)), _bits(want))
