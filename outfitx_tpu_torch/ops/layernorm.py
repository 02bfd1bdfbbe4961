"""LayerNorm over the last axis, with a hand-written CUDA kernel.

``layer_norm`` is the port of ``outfitx_tpu/ops/layernorm.py``. A CUDA
tensor goes to the kernel ``csrc/layernorm.cu`` (the port of ``_ln_kernel``)
or raises; a CPU tensor goes to ``layer_norm_reference``, the plain PyTorch
version, which is also what the kernel is held against on the card.
Statistics are float32 with the centred variance, the output has the input's
dtype, and ``eps`` is an argument (1e-5 in the set transformer, 1e-6 in the
SigLIP towers). The JAX package resolves its ``auto`` route to XLA, which
fuses the normalisation into its neighbours; eager PyTorch fuses nothing, so
here every ``layer_norm`` on the card launches the kernel.

Under autograd the call goes through ``LayerNormFn``: it saves only
``(x, weight, bias)`` and computes the closed-form backward of the JAX
package's ``_ln_bwd`` in plain float32 torch (no backward kernel, as there).

At the serving bucket (136 rows) the kernel takes a few microseconds and
the launch path is the cost, twelve times a forward: the wrapper casts,
reshapes or copies only what needs it, and takes the C entry and the stream
handle from ``_launch`` without rebuilding either.
"""

from __future__ import annotations

import ctypes

import torch

from outfitx_tpu_torch.ops import _launch

_NAME = "layernorm"
_EPS = 1e-5
_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]


def layer_norm_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = _EPS,
) -> torch.Tensor:
    """Plain PyTorch version: statistics and the affine map in float32,
    rounded once to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_bwd_reference(x, weight, bias, g, eps: float = _EPS):
    """Closed-form gradients of ``layer_norm`` for the output gradient ``g``:
    (dx in x's dtype, dweight, dbias in the parameters' dtypes), computed in
    float32; dweight and dbias are summed over all leading axes."""
    xf = x.float()
    gf = g.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    gxhat = gf * weight.float()
    dx = (
        gxhat
        - gxhat.mean(dim=-1, keepdim=True)
        - xhat * (gxhat * xhat).mean(dim=-1, keepdim=True)
    ) * rstd
    lead = tuple(range(x.dim() - 1))
    dweight = (gf * xhat).sum(dim=lead) if lead else gf * xhat
    dbias = gf.sum(dim=lead) if lead else gf
    return dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(bias.dtype)


def _wants_kernel(t: torch.Tensor) -> bool:
    """The one dispatch predicate: the kernel for a tensor on the card."""
    return t.is_cuda


def _check_param(name: str, p: torch.Tensor, d: int, device: int) -> torch.Tensor:
    """A (d,) parameter as the kernel takes it: float32 (cast here if the
    caller hands another dtype), contiguous, on x's device (an index, as
    ``Tensor.get_device`` gives it)."""
    if p.shape != (d,):
        raise ValueError(f"{_NAME}: {name} must be ({d},), got {tuple(p.shape)}")
    if p.get_device() != device:
        raise ValueError(f"{_NAME}: {name} must be on the input's device")
    if p.dtype != torch.float32:
        p = p.float()
    return p if p.is_contiguous() else p.contiguous()


def _check_aligned(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{_NAME}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{_NAME}: {name} must be 16-byte aligned")


def _prepare(x, weight, bias):
    """Checks shared by every device: x float32 or bfloat16 of at least one
    row, as contiguous (rows, d); the parameters float32 (d,). Operands that
    are ready already are returned as they are."""
    if x.dtype not in _launch.DTYPE_CODES:
        raise TypeError(f"{_NAME} kernel takes float32 or bfloat16, not {x.dtype}")
    shape = x.shape
    if not shape or shape[-1] < 1:
        raise ValueError(f"{_NAME}: x needs a last axis, got {tuple(shape)}")
    d = shape[-1]
    device = x.get_device()
    weight = _check_param("weight", weight, d, device)
    bias = _check_param("bias", bias, d, device)
    x2 = x if len(shape) == 2 and x.is_contiguous() else x.reshape(-1, d).contiguous()
    if x2.shape[0] < 1:
        raise ValueError(f"{_NAME} kernel takes at least one row")
    # Every operand is contiguous by now; name the one that is misaligned.
    if (x2.data_ptr() | weight.data_ptr() | bias.data_ptr()) % 16:
        _check_aligned(x=x2, weight=weight, bias=bias)
    return x2, weight, bias


def _layer_norm_cuda(x, weight, bias, eps: float = _EPS):
    x2, weight, bias = _prepare(x, weight, bias)
    fn = _launch.bind(_NAME, _ARGTYPES)
    out = torch.empty_like(x2)
    rows, d = x2.shape
    err = fn(
        x2.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, d, float(eps), _launch.DTYPE_CODES[x.dtype],
        _launch.current_stream(x.get_device()),
    )
    if err != 0:
        raise RuntimeError(f"{_NAME} launch failed: cudaError {err}")
    layer_norm.launches += 1
    return out if x2 is x else out.view(x.shape)


def _forward(x, weight, bias, eps):
    if _wants_kernel(x):
        return _layer_norm_cuda(x, weight, bias, eps)
    return layer_norm_reference(x, weight, bias, eps)


class LayerNormFn(torch.autograd.Function):
    """``layer_norm`` under autograd: the forward of the input's device, and
    the closed-form backward from the saved ``(x, weight, bias)``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        dx, dweight, dbias = layer_norm_bwd_reference(x, weight, bias, g, ctx.eps)
        need = ctx.needs_input_grad
        return (
            dx if need[0] else None,
            dweight if need[1] else None,
            dbias if need[2] else None,
            None,
        )


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = _EPS,
) -> torch.Tensor:
    """LayerNorm over the last axis: x (..., d), weight and bias (d,).

    On the card it launches its CUDA kernel and adds one to
    ``layer_norm.launches``, or raises (x must be float32 or bfloat16; the
    parameters are cast to float32 if they are not); on the CPU it runs the
    plain version. Returns x's shape and dtype.
    """
    if torch.is_grad_enabled() and (
        x.requires_grad or weight.requires_grad or bias.requires_grad
    ):
        return LayerNormFn.apply(x, weight, bias, eps)
    return _forward(x, weight, bias, eps)


layer_norm.launches = 0
