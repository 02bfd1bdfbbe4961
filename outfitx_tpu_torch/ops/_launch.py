"""What the kernel wrappers share: the dtype codes of the C entries, the
checks on a tensor handed to a kernel, the binding of a C entry and the
handle of the stream a kernel launches on.

A launch at the serving bucket costs host time, not device time, so the
per-call path does no more than it must: a C entry's ``argtypes`` are set
once per loaded library, and the stream handle comes from PyTorch's C
accessor without building a ``torch.cuda.Stream``."""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from outfitx_tpu_torch.ops import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# name -> (the library it was bound in, the bound C entry). The loader is
# asked on every call, so a failing or replaced library is never hidden
# behind this cache.
_bound: Dict[str, Tuple[object, object]] = {}


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
    """The C entry ``name`` of ``csrc/<name>.cu``, built at first use, with
    its argument and result types set the first time it is taken from a
    loaded library."""
    lib = _build.load(name)
    hit = _bound.get(name)
    if hit is not None and hit[0] is lib:
        return hit[1]
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    _bound[name] = (lib, fn)
    return fn


def current_stream(device_index: int) -> int:
    """The cudaStream_t of PyTorch's current stream on the device, as an
    int: a kernel launches there, in order with the caller's other work."""
    return torch._C._cuda_getCurrentRawStream(device_index)
