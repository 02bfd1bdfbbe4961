"""Masked multi-head set attention.

Inputs are (B, H, L, Dh) with a (B, L) bool key-padding mask (True = pad).
Outfits are at most 16 items + 1 prefix token, so this is attention over
tiny sequences: the whole (L, L) score block fits on chip.

``masked_mha`` dispatches on where the tensors lie. A CUDA tensor goes to the
hand-written kernel ``csrc/masked_mha_fwd.cu`` (the port of
``outfitx_tpu/ops/attention.py:_mha_kernel``) or raises; a CPU tensor goes to
``mha_reference``, the plain PyTorch version of the same function, which is
also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from outfitx_tpu_torch.ops import _build

_NEG = -1e9
_KERNEL = "masked_mha_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_L = 64
MAX_DH = 128


def mha_reference(q, k, v, pad_mask, causal: bool = False):
    """Plain PyTorch attention with the TPU kernel's numerics: float32
    scores (operands widened exactly), the mask where-set to -1e9, float32
    softmax, probabilities rounded to the input dtype before P V, float32
    accumulation, output in the input dtype."""
    dh = q.shape[-1]
    scale = 1.0 / (dh**0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = scores.masked_fill(pad_mask[:, None, None, :], _NEG)
    if causal:
        l = q.shape[2]
        above = torch.ones((l, l), dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(above, _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs.float(), v.float())
    return out.to(q.dtype)


def _wants_kernel(t: torch.Tensor) -> bool:
    """The one dispatch predicate: the kernel for a tensor on the card."""
    return t.is_cuda


def _check(q, k, v, pad_mask):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"masked_mha kernel takes float32 or bfloat16, not {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, Dh), got {tuple(q.shape)}")
    b, _, l, dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    if pad_mask.dtype != torch.bool or tuple(pad_mask.shape) != (b, l):
        raise ValueError(f"pad_mask must be bool (B, L) = {(b, l)}")
    if pad_mask.device != q.device:
        raise ValueError("pad_mask must lie on the same device as q")
    if not 1 <= l <= MAX_L or not 8 <= dh <= MAX_DH or dh % 8:
        raise ValueError(
            f"masked_mha kernel takes 1 <= L <= {MAX_L} and Dh a multiple of "
            f"8 up to {MAX_DH}, got L={l}, Dh={dh}"
        )
    for name, t in (("q", q), ("k", k), ("v", v), ("pad_mask", pad_mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _bind():
    lib = _build.load(_KERNEL)
    fn = lib.masked_mha_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _masked_mha_cuda(q, k, v, pad_mask, causal: bool):
    _check(q, k, v, pad_mask)
    fn = _bind()
    b, h, l, dh = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.data_ptr(),
        out.data_ptr(), b, h, l, dh, int(causal), _DTYPE_CODES[q.dtype],
        stream,
    )
    if err != 0:
        raise RuntimeError(f"masked_mha_fwd launch failed: cudaError {err}")
    masked_mha.launches += 1
    return out


def masked_mha(q, k, v, pad_mask, causal: bool = False):
    """Multi-head attention with a key-padding mask (True = pad) and an
    optional causal mask. q, k, v: (B, H, L, Dh); pad_mask: (B, L) bool.
    Returns (B, H, L, Dh) in q's dtype.

    On the card this launches the CUDA kernel and adds one to
    ``masked_mha.launches``; on the CPU it runs ``mha_reference``."""
    if _wants_kernel(q):
        return _masked_mha_cuda(q, k, v, pad_mask, causal)
    return mha_reference(q, k, v, pad_mask, causal)


masked_mha.launches = 0
