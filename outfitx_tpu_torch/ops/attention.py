"""Masked multi-head set attention, forward and backward.

Inputs are (B, H, L, Dh) with a (B, L) bool key-padding mask (True = pad).
Outfits are at most 16 items + 1 prefix token, so the set transformer's
attention runs over tiny sequences; the frozen towers call the forward at
50, 77 (causal) and 196 tokens. The forward takes L up to 256; the towers
take no gradient, so the backward kernel keeps L <= 64.

``masked_mha`` is differentiable through ``MaskedMHA``, a
``torch.autograd.Function`` that saves q, k, v and the mask (the JAX custom
VJP's residuals) and recomputes P in the backward. Both directions dispatch
on where the tensors lie. A CUDA tensor goes to the hand-written kernels
``csrc/masked_mha_fwd.cu`` and ``csrc/masked_mha_bwd.cu`` (the ports of
``outfitx_tpu/ops/attention.py:_mha_kernel`` and ``:_mha_bwd_kernel``) or
raises; a CPU tensor goes to ``mha_reference`` and ``mha_bwd_reference``,
the plain PyTorch versions of the same functions, which are also what the
kernels are held against on the card.

In bfloat16 at Dh a multiple of 16 both kernels work on tiles of 64 rows
of the flat (B H L, Dh) arrays, where each (b, h) slab is L consecutive
rows; each C entry cuts a call into tiles from (L, Dh, dtype). The forward
packs ``64 // L`` slabs into a tile up to L = 32 (the set transformer), each
row seeing only its own slab's keys, S summed in order over Dh on the CUDA
cores as ``mha_reference`` sums it; above, one slab's query tiles against
all of its keys at once, on the tensor cores. The backward packs ``64 //
L`` slabs a tile at every L <= 64 and repeats the plain version's float32
arithmetic up to the roundings of P and dS (S and dP in order over Dh, the
softmax's and the row sum's tree, ``_tree_sum``), then takes dV, dQ and dK
on the tensor cores. float32 (the correctness route) and bfloat16 at other
Dh run the scalar kernels.
"""

from __future__ import annotations

import ctypes

import torch

# The tests patch the kernel loader through this module's _build.
from outfitx_tpu_torch.ops import _build, _launch  # noqa: F401

_NEG = -1e9
_FWD = "masked_mha_fwd"
_BWD = "masked_mha_bwd"
_DTYPE_CODES = _launch.DTYPE_CODES
MAX_L = 256  # forward
SHORT_L = 64  # backward; above it the forward wants Dh a multiple of 16
MAX_DH = 128
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _scores(q, k):
    """Q K^T in float32, summed over Dh in order (d = 0, 1, ...), one
    product and one addition at a time. The order is this function's own,
    not a library's: the kernels' float32 sums of S follow it (bfloat16
    products are exact in float32, so a fused multiply-add gives the same
    sums), and a bfloat16 P that rounds on S's last bit cannot flip with a
    library's choice of summation order."""
    qf, kf = q.float(), k.float()
    s = qf.new_zeros((*qf.shape[:-1], kf.shape[-2]))
    for d in range(qf.shape[-1]):
        s += qf[..., :, d, None] * kf[..., None, :, d]
    return s


def _tree_sum(x):
    """Sum over the last axis (at most 64 entries) in a fixed order of this
    function's own, the tree of ``torch.softmax``'s warp sum on the card:
    64 slots, zeros past the length; the upper 32 added onto the lower, then
    the halves at 16, 8, 4, 2 and 1. Returns (..., 1). The backward kernel's
    tiles sum rowsum(dP o P) so, and a bfloat16 dS that rounds on the sum's
    last bit cannot flip with a library's choice of order."""
    n = x.shape[-1]
    if n > 64:
        raise ValueError(f"_tree_sum takes at most 64 entries, got {n}")
    x = torch.nn.functional.pad(x, (0, 64 - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x


def _probs(q, k, pad_mask, causal: bool):
    """float32 softmax of the masked scores: operands widened exactly, S by
    ``_scores``, the masks where-set to -1e9 (so a fully masked row is
    uniform, not NaN)."""
    dh = q.shape[-1]
    scale = 1.0 / (dh**0.5)
    scores = _scores(q, k) * scale
    scores = scores.masked_fill(pad_mask[:, None, None, :], _NEG)
    if causal:
        l = q.shape[2]
        above = torch.ones((l, l), dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(above, _NEG)
    return torch.softmax(scores, dim=-1)


def mha_reference(q, k, v, pad_mask, causal: bool = False):
    """Plain PyTorch attention with the TPU kernel's numerics: float32
    scores and softmax, probabilities rounded to the input dtype before P V,
    float32 accumulation, output in the input dtype."""
    probs = _probs(q, k, pad_mask, causal).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def mha_bwd_reference(q, k, v, pad_mask, g, causal: bool = False):
    """Plain PyTorch version of the fused backward (``_mha_bwd_kernel``),
    with its roundings: P recomputed and kept in float32; dv = Pb^T g with
    Pb = P in the input dtype; dp = g v^T in float32; ds = P o (dp -
    rowsum(dp o P)); dsb = ds * scale in the input dtype before dq = dsb k
    and dk = dsb^T q. Returns (dq, dk, dv) in the input dtype.

    dS rounds to bfloat16 before two products, so it is computed in orders
    of this module's own, which the bfloat16 kernel repeats: dp summed over
    Dh in order (``_scores``), the row sum of the rounded products dp o P
    over ``_tree_sum``."""
    dt = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p = _probs(q, k, pad_mask, causal)
    pb = p.to(dt).float()
    gf = g.float()
    dv = torch.matmul(pb.transpose(-1, -2), gf)
    dp = _scores(g, v)
    ds = p * (dp - _tree_sum(dp * p))
    dsb = (ds * scale).to(dt).float()
    dq = torch.matmul(dsb, k.float())
    dk = torch.matmul(dsb.transpose(-1, -2), q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _wants_kernel(t: torch.Tensor) -> bool:
    """The one dispatch predicate: the kernel for a tensor on the card."""
    return t.is_cuda


def _check(q, k, v, pad_mask, g=None):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"masked_mha kernel takes float32 or bfloat16, not {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, Dh), got {tuple(q.shape)}")
    b, _, l, dh = q.shape
    same = {"k": k, "v": v} if g is None else {"k": k, "v": v, "g": g}
    for name, t in same.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    if pad_mask.dtype != torch.bool or tuple(pad_mask.shape) != (b, l):
        raise ValueError(f"pad_mask must be bool (B, L) = {(b, l)}")
    if pad_mask.device != q.device:
        raise ValueError("pad_mask must lie on the same device as q")
    max_l = MAX_L if g is None else SHORT_L
    if not 1 <= l <= max_l or not 8 <= dh <= MAX_DH or dh % 8:
        raise ValueError(
            f"masked_mha {'forward' if g is None else 'backward'} kernel takes "
            f"1 <= L <= {max_l} and Dh a multiple of 8 up to {MAX_DH}, got "
            f"L={l}, Dh={dh}"
        )
    if l > SHORT_L and dh % 16:
        raise ValueError(
            f"masked_mha kernel above L={SHORT_L} takes Dh a multiple of 16, "
            f"got L={l}, Dh={dh}"
        )
    tensors = {"q": q, **same}
    for name, t in {**tensors, "pad_mask": pad_mask}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _masked_mha_cuda(q, k, v, pad_mask, causal: bool):
    _check(q, k, v, pad_mask)
    fn = _launch.bind(_FWD, _FWD_ARGTYPES)
    b, h, l, dh = q.shape
    out = torch.empty_like(q)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.data_ptr(),
        out.data_ptr(), b, h, l, dh, int(causal), _DTYPE_CODES[q.dtype],
        _launch.current_stream(q.get_device()),
    )
    if err != 0:
        raise RuntimeError(f"{_FWD} launch failed: cudaError {err}")
    masked_mha.launches += 1
    return out


def _masked_mha_bwd_cuda(q, k, v, pad_mask, g, causal: bool):
    _check(q, k, v, pad_mask, g)
    fn = _launch.bind(_BWD, _BWD_ARGTYPES)
    b, h, l, dh = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        pad_mask.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, l, dh, int(causal), _DTYPE_CODES[q.dtype],
        _launch.current_stream(q.get_device()),
    )
    if err != 0:
        raise RuntimeError(f"{_BWD} launch failed: cudaError {err}")
    masked_mha.bwd_launches += 1
    return dq, dk, dv


class MaskedMHA(torch.autograd.Function):
    """The attention core with its fused backward: on the card both
    directions launch their kernel, on the CPU both run the plain
    version."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, causal):
        ctx.save_for_backward(q, k, v, pad_mask)
        ctx.causal = causal
        if _wants_kernel(q):
            return _masked_mha_cuda(q, k, v, pad_mask, causal)
        return mha_reference(q, k, v, pad_mask, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, pad_mask = ctx.saved_tensors
        if _wants_kernel(q):
            dq, dk, dv = _masked_mha_bwd_cuda(
                q, k, v, pad_mask, g.contiguous(), ctx.causal
            )
        else:
            dq, dk, dv = mha_bwd_reference(q, k, v, pad_mask, g, ctx.causal)
        return dq, dk, dv, None, None


def masked_mha(q, k, v, pad_mask, causal: bool = False):
    """Multi-head attention with a key-padding mask (True = pad) and an
    optional causal mask. q, k, v: (B, H, L, Dh); pad_mask: (B, L) bool.
    Returns (B, H, L, Dh) in q's dtype; differentiable in q, k and v.

    On the card the forward launches its CUDA kernel and adds one to
    ``masked_mha.launches``, the backward launches its own and adds one to
    ``masked_mha.bwd_launches``; on the CPU both run the plain versions.
    The bfloat16 forward and backward on the card want finite inputs: their
    tiles multiply P = 0 (and, backward, dS = 0) by neighbouring slabs'
    values, so an Inf there gives NaN here."""
    return MaskedMHA.apply(q, k, v, pad_mask, causal)


masked_mha.launches = 0
masked_mha.bwd_launches = 0
