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
  (padding 1) in one pass;
- ``stem_conv_pool``: the stem whole, its 7x7/2 convolution (padding 3) at
  C = 3, each sum rounded once to the input's dtype, then ``stem_pool``'s
  max-pool, bias and ReLU. In bfloat16 on the card one kernel, which writes
  only the pooled output; a float32 input on the card takes cuDNN's
  convolution and then ``stem_pool``.

A CUDA tensor goes to the kernel or raises; a CPU tensor goes to the plain
PyTorch version beside each, which is also what the kernels are held
against on the card: bit for bit, except the stem's convolution, whose
float32 sums are taken in another order than cuDNN's. The kernels compute
no gradient: the tower is frozen, and on the card an operand that asks for
one raises.
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
    "resnet_stem_conv_pool": [_P] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
}
# The stem's GEMM in the kernel: K is 7 kernel rows of STEM_ROW_K columns
# (a zero column, then the row's 21 (kx, c) values), zero-padded to STEM_K,
# so every pair of A's values is two channels of one input row; N is the 64
# output channels. An input row must be whole 16-byte units, at most
# STEM_MAX_W pixels.
STEM_COUT, STEM_ROW_K, STEM_K, STEM_MAX_W = 64, 22, 160, 224
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


def stem_conv_pool_reference(x, w, bias):
    return stem_pool_reference(F.conv2d(x, w, stride=2, padding=3), bias)


def pack_stem_weight(w: torch.Tensor) -> torch.Tensor:
    """The stem's folded weight (64, 3, 7, 7) -> the kernel's B operand
    (64, STEM_K) in its dtype: column ``22 ky + 1 + 3 kx + c`` holds
    ``w[:, c, ky, kx]``, every other column is zero."""
    out = w.new_zeros((STEM_COUT, STEM_K))
    rows = out[:, :7 * STEM_ROW_K].view(STEM_COUT, 7, STEM_ROW_K)
    rows[:, :, 1:] = w.permute(0, 2, 3, 1).reshape(STEM_COUT, 7, 21)
    return out


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


def _bias(bias: torch.Tensor, c: int, device: torch.device) -> torch.Tensor:
    if bias.shape != (c,) or bias.dtype != torch.float32 or bias.device != device:
        raise ValueError(f"{_NAME}: bias must be float32 ({c},) on the input's device")
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
    bias = _bias(bias, y.shape[1], y.device)
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
    bias = _bias(bias, y.shape[1], y.device)
    b, c, h, w = y.shape
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = torch.empty((b, c, oh, ow), dtype=y.dtype, device=y.device, memory_format=_CL)
    if out.numel():
        _run("resnet_stem_pool", y.device, y.data_ptr(), bias.data_ptr(), out.data_ptr(),
             b, h, w, c, oh, ow, _launch.DTYPE_CODES[y.dtype])
        stem_pool.launches += 1
    return out


def _check_stem(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> None:
    """Raise unless this is ResNet's stem: x (B, 3, H, W), w (64, 3, 7, 7),
    stride 2, padding 3. Every route checks it."""
    if x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"{_NAME}: the stem takes x (B, 3, H, W), not {tuple(x.shape)}")
    if tuple(w.shape) != (STEM_COUT, 3, 7, 7):
        raise ValueError(f"{_NAME}: the stem's weight is (64, 3, 7, 7), not {tuple(w.shape)}")
    if (stride, padding) != (2, 3):
        raise ValueError(f"{_NAME}: the stem strides 2 with padding 3, not {stride}, {padding}")


def _stem_kernel_operands(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Raise unless the stem's kernel takes these operands: x bfloat16,
    contiguous channels-last and 16-byte aligned, its width a multiple of 8
    up to STEM_MAX_W; w in x's dtype, on its device; bias float32 (64,);
    nothing asks for a gradient. Returns the packed weight and the bias."""
    if x.dtype != torch.bfloat16 or w.dtype != x.dtype:
        raise TypeError(f"{_NAME}: the stem's kernel takes bfloat16 x and w, not {x.dtype}, "
                        f"{w.dtype}")
    if w.device != x.device:
        raise ValueError(f"{_NAME}: the stem's weight must be on x's device")
    if not x.is_contiguous(memory_format=_CL) or x.data_ptr() % 16:
        raise ValueError(f"{_NAME}: x must be a contiguous channels-last (B, 3, H, W), aligned")
    if x.shape[3] % 8 or x.shape[3] > STEM_MAX_W:
        raise ValueError(f"{_NAME}: the stem's kernel takes a width that is a multiple of 8 "
                         f"up to {STEM_MAX_W}, not {x.shape[3]}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise ValueError(f"{_NAME}: the kernels compute no gradient; the stem's x or w asks for one")
    return pack_stem_weight(w), _bias(bias, STEM_COUT, x.device)


def stem_conv_pool(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, stride: int = 2,
                   padding: int = 3) -> torch.Tensor:
    """ResNet's stem: ``stem_pool(F.conv2d(x, w, stride=2, padding=3),
    bias)`` for x (B, 3, H, W) channels-last, w (64, 3, 7, 7) the folded
    weight in x's dtype, bias float32 (64,). In bfloat16 on the card one
    pass, which writes only the pooled (B, 64, H/4, W/4) and adds one to
    ``stem_conv_pool.launches``; float32 on the card is cuDNN's convolution
    and then ``stem_pool``."""
    _check_stem(x, w, stride, padding)
    if not x.is_cuda:
        return stem_conv_pool_reference(x, w, bias)
    if x.dtype == torch.float32:
        return stem_pool(F.conv2d(x, w, stride=2, padding=3), bias)
    packed, bias = _stem_kernel_operands(x, w, bias)
    b, _, h, wd = x.shape
    oh, ow = (h - 1) // 2 + 1, (wd - 1) // 2 + 1
    out = torch.empty((b, STEM_COUT, (oh - 1) // 2 + 1, (ow - 1) // 2 + 1), dtype=x.dtype,
                      device=x.device, memory_format=_CL)
    if b:
        zeros = x.new_zeros(3 * wd)  # the padding rows' source
        _run("resnet_stem_conv_pool", x.device, x.data_ptr(), packed.data_ptr(),
             zeros.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, wd)
        stem_conv_pool.launches += 1
    return out


normalize.launches = 0
bias_add_relu.launches = 0
stem_pool.launches = 0
stem_conv_pool.launches = 0
