"""The ResNet-18 tower's passes outside its convolutions, NHWC, with
hand-written CUDA kernels (``csrc/resnet_nhwc.cu``).

The tower (``models/towers/resnet.py``) runs in PyTorch's channels-last
layout from its input to the global pool, each frozen BatchNorm folded into
its convolution, so a convolution leaves its raw output and a float32 bias:

- ``normalize``: uint8 images (B, C, H, W) -> the normaliser's
  ``(x / 255 - mean) / std`` in float32, rounded once to ``dtype``, NHWC;
- ``bias_add_relu``: ``relu((y + bias) + residual)``, the residual optional,
  in float32, rounded once; on the card in place over ``y``;
- ``stem_pool``: the stem's ``bias_add_relu`` and its 3x3/2 max-pool
  (padding 1) in one pass.

A CUDA tensor goes to the kernel or raises; a CPU tensor goes to the plain
PyTorch version beside each, which is also what the kernels are held
against on the card, bit for bit. The kernels compute no gradient: the
tower is frozen, and on the card an operand that asks for one raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from outfitx_tpu_torch.ops import _launch

_NAME = "resnet_nhwc"
_P = ctypes.c_void_p
_ARGTYPES = {
    "resnet_normalize": [_P] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_int, _P],
    "resnet_bias_act": [_P] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
    "resnet_stem_pool": [_P] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [_P],
}
_CL = torch.channels_last


def normalize_reference(x_uint8, mean, std, dtype):
    mean, std = mean.view(1, -1, 1, 1), std.view(1, -1, 1, 1)
    return ((x_uint8.to(torch.float32) / 255.0 - mean) / std).to(dtype, memory_format=_CL)


def bias_add_relu_reference(y, bias, residual=None):
    t = y.float() + bias.view(1, -1, 1, 1)
    if residual is not None:
        t = t + residual.float()
    return torch.relu(t).to(y.dtype)


def stem_pool_reference(y, bias):
    return F.max_pool2d(bias_add_relu_reference(y, bias), 3, 2, padding=1)


def _check_activation(what: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` is a float32 or bfloat16 NHWC activation the
    kernels take: contiguous channels-last, 16-byte aligned, its channels
    whole 16-byte vectors; and no gradient is asked of it."""
    if t.dtype not in _launch.DTYPE_CODES:
        raise TypeError(f"{_NAME}: {what} must be float32 or bfloat16, not {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous(memory_format=_CL):
        raise ValueError(f"{_NAME}: {what} must be a contiguous channels-last (B, C, H, W)")
    if t.shape[1] % (16 // t.element_size()) or t.data_ptr() % 16:
        raise ValueError(f"{_NAME}: {what}'s channels must be whole 16-byte vectors, aligned")
    if torch.is_grad_enabled() and t.requires_grad:
        raise ValueError(f"{_NAME}: the kernels compute no gradient; {what} asks for one")


def _bias(bias: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if bias.shape != (y.shape[1],) or bias.dtype != torch.float32 or bias.device != y.device:
        raise ValueError(f"{_NAME}: bias must be float32 ({y.shape[1]},) on the input's device")
    if torch.is_grad_enabled() and bias.requires_grad:
        raise ValueError(f"{_NAME}: the kernels compute no gradient; bias asks for one")
    return bias.contiguous()


def _run(entry: str, device: torch.device, *args) -> None:
    fn = _launch.bind(_NAME, _ARGTYPES[entry], entry)
    err = fn(*args, _launch.current_stream(device.index))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def normalize(x_uint8: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """(B, C, H, W) uint8 -> (B, C, H, W) ``dtype`` channels-last:
    ``(x / 255 - mean) / std`` in float32 (mean and std float32 (C,)),
    rounded once. On the card one pass; it adds one to
    ``normalize.launches``."""
    if not x_uint8.is_cuda:
        return normalize_reference(x_uint8, mean, std, dtype)
    if x_uint8.dtype != torch.uint8 or x_uint8.dim() != 4 or not x_uint8.is_contiguous():
        raise ValueError(f"{_NAME}: images must be contiguous uint8 (B, C, H, W)")
    if dtype not in _launch.DTYPE_CODES:
        raise TypeError(f"{_NAME}: normalises to float32 or bfloat16, not {dtype}")
    b, c, h, w = x_uint8.shape
    for t in (mean, std):
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != x_uint8.device:
            raise ValueError(f"{_NAME}: mean and std must be float32 ({c},) on the images' device")
    mean, std = mean.contiguous(), std.contiguous()
    out = torch.empty((b, c, h, w), dtype=dtype, device=x_uint8.device, memory_format=_CL)
    if b:
        _run("resnet_normalize", x_uint8.device, x_uint8.data_ptr(), mean.data_ptr(),
             std.data_ptr(), out.data_ptr(), b, c, h * w, _launch.DTYPE_CODES[dtype])
        normalize.launches += 1
    return out


def bias_add_relu(y: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A convolution's epilogue: ``relu((y + bias) + residual)`` over y (B, C,
    H, W) channels-last, bias float32 (C,), the residual y's shape, dtype
    and layout; float32 sums, rounded once to y's dtype. On the card in
    place (returns y), one pass; it adds one to ``bias_add_relu.launches``."""
    if not y.is_cuda:
        return bias_add_relu_reference(y, bias, residual)
    _check_activation("y", y)
    bias = _bias(bias, y)
    res = None
    if residual is not None:
        _check_activation("residual", residual)
        if residual.shape != y.shape or residual.dtype != y.dtype or residual.device != y.device:
            raise ValueError(f"{_NAME}: the residual must match y's shape, dtype and device")
        res = residual.data_ptr()
    if y.numel():
        _run("resnet_bias_act", y.device, y.data_ptr(), bias.data_ptr(), res, y.data_ptr(),
             y.numel(), y.shape[1], _launch.DTYPE_CODES[y.dtype])
        bias_add_relu.launches += 1
    return y


def stem_pool(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``F.max_pool2d(bias_add_relu(y, bias), 3, 2, padding=1)`` in one pass
    (y channels-last (B, C, H, W), bias float32 (C,)): the window's max of
    y, then the epilogue, which does not decrease, so the two are equal bit
    for bit. It adds one to ``stem_pool.launches``."""
    if not y.is_cuda:
        return stem_pool_reference(y, bias)
    _check_activation("y", y)
    bias = _bias(bias, y)
    b, c, h, w = y.shape
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = torch.empty((b, c, oh, ow), dtype=y.dtype, device=y.device, memory_format=_CL)
    if out.numel():
        _run("resnet_stem_pool", y.device, y.data_ptr(), bias.data_ptr(), out.data_ptr(),
             b, h, w, c, oh, ow, _launch.DTYPE_CODES[y.dtype])
        stem_pool.launches += 1
    return out


normalize.launches = 0
bias_add_relu.launches = 0
stem_pool.launches = 0
