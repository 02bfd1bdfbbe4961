"""The fused tower MLP: act(x W1 + b1) W2 + b2 in one kernel (forward only).

``mlp_fused`` is the port of ``outfitx_tpu/ops/mlp.py``. A CUDA tensor goes
to the hand-written kernel ``csrc/mlp_fused.cu`` (the port of
``_mlp_kernel``) or raises; a CPU tensor goes to ``mlp_fused_reference``, the
plain PyTorch version with the same roundings, which is also what the kernel
is held against on the card. Weights keep the JAX layouts: ``w1 (d, d_mlp)``
and ``w2 (d_mlp, d)`` as (in, out).

In bfloat16 the kernel is two passes of a Hopper GEMM (``csrc/
hopper_gemm.cuh``): the first writes the rounded mid tensor to a scratch
tensor that this wrapper allocates, the second reads it back. Rows go in
chunks of ``mid_rows(rows, d_mlp)``, so the scratch stays under
``MID_SCRATCH_BYTES``. float32 keeps the mid tensor on chip and needs none.
"""

from __future__ import annotations

import ctypes

import torch

from outfitx_tpu_torch.ops import _launch
from outfitx_tpu_torch.ops.activations import TOWER_ACTIVATIONS

_NAME = "mlp_fused"
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ACT_CODES = {"quick_gelu": 0, "gelu_tanh": 1, "gelu": 2}
MAX_D = 768
MID_SCRATCH_BYTES = 512 << 20
_TILE_ROWS = 128  # the GEMM's row tile: a chunk of rows is whole tiles


def _act_fn(act: str):
    try:
        return TOWER_ACTIVATIONS[act]
    except KeyError:
        raise ValueError(
            f"unknown activation {act!r}; expected one of {sorted(_ACT_CODES)}"
        ) from None


def mlp_fused_reference(x, w1, b1, w2, b2, *, act: str = "quick_gelu"):
    """Plain PyTorch version with the TPU kernel's roundings: weights and
    biases cast to x's dtype first; x W1 accumulated in float32, the bias
    added and the activation taken in float32, then rounded to x's dtype;
    mid W2 accumulated in float32, the bias added in float32, rounded."""
    dt = x.dtype
    fn = _act_fn(act)
    w1, b1, w2, b2 = (t.to(dt).float() for t in (w1, b1, w2, b2))
    mid = fn(torch.matmul(x.float(), w1) + b1).to(dt)
    return (torch.matmul(mid.float(), w2) + b2).to(dt)


def mid_rows(rows: int, d_mlp: int) -> int:
    """Height of the bfloat16 kernel's mid scratch: every row where (rows,
    d_mlp) bfloat16 fits in ``MID_SCRATCH_BYTES``, else the most whole row
    tiles that do (at least one)."""
    cap = MID_SCRATCH_BYTES // (2 * d_mlp) // _TILE_ROWS * _TILE_ROWS
    return min(rows, max(cap, _TILE_ROWS))


def _wants_kernel(t: torch.Tensor) -> bool:
    """The one dispatch predicate: the kernel for a tensor on the card."""
    return t.is_cuda


def _mlp_fused_cuda(x, w1, b1, w2, b2, act: str):
    _act_fn(act)
    d = x.shape[-1]
    d_mlp = w1.shape[1]
    if tuple(w1.shape) != (d, d_mlp) or tuple(w2.shape) != (d_mlp, d):
        raise ValueError(f"w1 must be (d, d_mlp) and w2 (d_mlp, d), d={d}")
    if tuple(b1.shape) != (d_mlp,) or tuple(b2.shape) != (d,):
        raise ValueError("b1 must be (d_mlp,) and b2 (d,)")
    if not 16 <= d <= MAX_D or d % 16 or d_mlp % 16 or d_mlp < 16:
        raise ValueError(
            f"mlp_fused kernel takes d a multiple of 16 up to {MAX_D} and "
            f"d_mlp a multiple of 16, got d={d}, d_mlp={d_mlp}"
        )
    dt = x.dtype
    w1, b1, w2, b2 = (t.to(dt) for t in (w1, b1, w2, b2))
    x2 = x.reshape(-1, d)
    if x2.shape[0] < 1:
        raise ValueError("mlp_fused kernel takes at least one row")
    _launch.check_operands(_NAME, x2, x=x2, w1=w1, b1=b1, w2=w2, b2=b2)
    fn = _launch.bind(_NAME, _ARGTYPES)
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    n_mid = mid_rows(rows, d_mlp) if dt == torch.bfloat16 else 0
    mid = torch.empty((n_mid, d_mlp), dtype=dt, device=x.device) if n_mid else None
    stream = _launch.current_stream(x.get_device())
    err = fn(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), None if mid is None else mid.data_ptr(),
        n_mid, rows, d, d_mlp, _ACT_CODES[act], _launch.DTYPE_CODES[dt], stream,
    )
    if err != 0:
        raise RuntimeError(f"{_NAME} launch failed: cudaError {err}")
    mlp_fused.launches += 1
    return out.reshape(x.shape)


def mlp_fused(x, w1, b1, w2, b2, *, act: str = "quick_gelu"):
    """``act(x @ w1 + b1) @ w2 + b2`` with the mid tensor kept on chip.

    x: (..., d); w1: (d, d_mlp); b1: (d_mlp,); w2: (d_mlp, d); b2: (d,);
    act in {"quick_gelu", "gelu_tanh", "gelu"}. Returns x's shape and dtype.
    Forward only.

    On the card it launches its CUDA kernel and adds one to
    ``mlp_fused.launches``, or raises; on the CPU it runs the plain version.
    """
    if _wants_kernel(x):
        return _mlp_fused_cuda(x, w1, b1, w2, b2, act)
    return mlp_fused_reference(x, w1, b1, w2, b2, act=act)


mlp_fused.launches = 0
