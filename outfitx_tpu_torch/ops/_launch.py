"""What the kernel wrappers share: the dtype codes of the C entries, the
checks on a tensor handed to a kernel, and the binding of a C entry."""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from outfitx_tpu_torch.ops import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(kernel: str, ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Raise unless ``ref`` has a dtype the kernels take and every named
    tensor shares its dtype and device, is contiguous and 32-byte aligned
    (a tensor-core fragment is loaded straight from a weight)."""
    if ref.dtype not in DTYPE_CODES:
        raise TypeError(f"{kernel} kernel takes float32 or bfloat16, not {ref.dtype}")
    for name, t in tensors.items():
        if t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"{kernel}: {name} must share the input's dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.data_ptr() % 32:
            raise ValueError(f"{kernel}: {name} must be 32-byte aligned")


def bind(name: str, argtypes: Sequence):
    """The C entry ``name`` of ``csrc/<name>.cu``, built at first use."""
    fn = getattr(_build.load(name), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
