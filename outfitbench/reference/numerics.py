"""Exact float32 products, and the lower precision that a control computes
in (float8 e4m3 with a scale a tensor, in the forward and the backward)."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a scale that maps its largest
    magnitude to 448, back in float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Round8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return to_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return to_fp8(g)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Rounded to float8 going forward, its gradient rounded going back."""
    return _Round8.apply(x)


def matmul(a, b, low: bool = False):
    """a @ b in float32; ``low`` rounds both operands and the product (and
    their gradients) to float8, as a product on float8 tensor cores."""
    if not low:
        return a @ b
    return fp8(fp8(a) @ fp8(b))
