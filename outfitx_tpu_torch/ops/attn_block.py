"""The fused attention block: QKV projection, masked attention and
out-projection in one kernel (forward only: the towers are frozen).

``attn_block`` is the port of ``outfitx_tpu/ops/attn_block.py``. A CUDA
tensor goes to the hand-written kernel ``csrc/attn_block.cu`` (the port of
``_attn_block_kernel``) or raises; a CPU tensor goes to
``attn_block_reference``, the plain PyTorch version of the same function
with the same roundings, which is also what the kernel is held against on
the card. Weights keep the JAX layouts: ``wqkv (d, 3, d)`` and ``wo (d, d)``
as (in, out), ``bqkv (3, d)``. The output is float32 whatever the input, and
the out-projection bias stays with the caller.

In bfloat16 the kernel runs three phases (the QKV product, attention per
batch row and head, the out-projection) that hand over through two scratch
tensors this wrapper allocates: q|k|v (B L, 3 d) and ctx (B, L, d).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from outfitx_tpu_torch.ops import _launch

_NEG = -1e9
_NAME = "attn_block"
_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)
MAX_L = 64
MAX_D = 1536
MAX_DH = 128


def attn_block_reference(
    y, wqkv, bqkv, wo, pad_mask, n_heads: int, *,
    scale: Optional[float] = None, causal: bool = False,
):
    """Plain PyTorch version with the TPU kernel's roundings, head by head
    in order: projections accumulate in float32, are rounded to y's dtype
    and THEN get the bias (in that dtype); float32 scores and softmax with
    the masks where-set to -1e9 (pad first, then causal); P rounded to y's
    dtype; ctx rounded; the out-projection accumulates in float32 over the
    heads 0..H-1 and is not rounded."""
    b, l, d = y.shape
    dt = y.dtype
    dh = wqkv.shape[2] // n_heads
    if scale is None:
        scale = 1.0 / (dh**0.5)
    yf = y.float()
    above = torch.ones((l, l), dtype=torch.bool, device=y.device).triu(1)
    out = torch.zeros((b, l, d), dtype=torch.float32, device=y.device)
    for j in range(n_heads):
        cols = slice(j * dh, (j + 1) * dh)
        q, k, v = (
            torch.matmul(yf, wqkv[:, i, cols].float()).to(dt) + bqkv[i, cols].to(dt)
            for i in range(3)
        )
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        scores = scores.masked_fill(pad_mask[:, None, :], _NEG)
        if causal:
            scores = scores.masked_fill(above, _NEG)
        probs = torch.softmax(scores, dim=-1).to(dt)
        ctx = torch.matmul(probs.float(), v.float()).to(dt)
        out = out + torch.matmul(ctx.float(), wo[cols, :].float())
    return out


def _wants_kernel(t: torch.Tensor) -> bool:
    """The one dispatch predicate: the kernel for a tensor on the card."""
    return t.is_cuda


def _attn_block_cuda(y, wqkv, bqkv, wo, pad_mask, n_heads, scale, causal):
    if y.dim() != 3:
        raise ValueError(f"y must be (B, L, d), got {tuple(y.shape)}")
    b, l, d = y.shape
    if tuple(wqkv.shape) != (d, 3, d) or tuple(bqkv.shape) != (3, d):
        raise ValueError(f"wqkv must be {(d, 3, d)} and bqkv {(3, d)}")
    if tuple(wo.shape) != (d, d):
        raise ValueError(f"wo must be {(d, d)}")
    dh = d // n_heads if n_heads >= 1 and d % n_heads == 0 else 0
    if not (
        1 <= l <= MAX_L and 64 <= d <= MAX_D and d % 64 == 0
        and dh and dh % 16 == 0 and dh <= MAX_DH
    ):
        raise ValueError(
            f"attn_block kernel takes L <= {MAX_L}, d a multiple of 64 up to "
            f"{MAX_D} and Dh a multiple of 16 up to {MAX_DH}, got L={l}, "
            f"d={d}, heads={n_heads}"
        )
    _launch.check_operands(_NAME, y, y=y, wqkv=wqkv, bqkv=bqkv, wo=wo)
    if pad_mask.dtype != torch.bool or tuple(pad_mask.shape) != (b, l):
        raise ValueError(f"pad_mask must be bool (B, L) = {(b, l)}")
    if pad_mask.device != y.device or not pad_mask.is_contiguous():
        raise ValueError("pad_mask must be contiguous on the same device as y")
    fn = _launch.bind(_NAME, _ARGTYPES)
    out = torch.empty((b, l, d), dtype=torch.float32, device=y.device)
    # The bfloat16 kernel's phases hand over through these: q|k|v of every
    # head (biased, rounded), and ctx (every head's P v, rounded). The
    # float32 kernel needs no scratch.
    bf16 = y.dtype == torch.bfloat16
    qkv = torch.empty((b * l, 3 * d), dtype=y.dtype, device=y.device) if bf16 else None
    ctx = torch.empty_like(y) if bf16 else None
    stream = _launch.current_stream(y.get_device())
    err = fn(
        y.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(),
        pad_mask.data_ptr(), None if qkv is None else qkv.data_ptr(),
        None if ctx is None else ctx.data_ptr(), out.data_ptr(), b, l, d,
        n_heads, float(scale), int(causal), _launch.DTYPE_CODES[y.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"{_NAME} launch failed: cudaError {err}")
    attn_block.launches += 1
    return out


def attn_block(
    y, wqkv, bqkv, wo, pad_mask, n_heads: int, *,
    scale: Optional[float] = None, causal: bool = False,
):
    """``out_proj(MHA(y @ wqkv + bqkv))`` without the out-projection bias.

    y: (B, L, d) post-LN input; wqkv: (d, 3, d); bqkv: (3, d); wo: (d, d);
    pad_mask: (B, L) bool, True = pad. Returns (B, L, d) float32. ``scale``
    defaults to 1/sqrt(d / n_heads). Forward only.

    On the card it launches its CUDA kernel and adds one to
    ``attn_block.launches``, or raises; on the CPU it runs the plain version.
    """
    if scale is None:
        scale = 1.0 / ((wqkv.shape[2] // n_heads) ** 0.5)
    if _wants_kernel(y):
        return _attn_block_cuda(y, wqkv, bqkv, wo, pad_mask, n_heads, scale, causal)
    return attn_block_reference(
        y, wqkv, bqkv, wo, pad_mask, n_heads, scale=scale, causal=causal
    )


attn_block.launches = 0
