"""The native (C++) host assembler of CIR batches, loaded with ctypes (the
port of ``outfitx_tpu/native``).

``sampling.cpp`` is a copy of the JAX package's source with the same C
entry points (``cir_assemble``, ``cir_eval_assemble``,
``negatives_assemble``): integer-only splitmix64 streams, so the same seeds
give the same bytes in both packages, whatever the compiler flags.

The library is built with g++ at first use, never at import, into the
checkout's ``build/outfitx_tpu_torch/`` (git-ignored) under a name that
carries a hash of the source and the flags, so a stale library never
loads. It is compiled to a name of its own and moved into place, so
processes that build at the same moment do not see each other's partial
file. Without g++ ``available()`` is False and the samplers' ``auto``
routes take numpy or python; asking for the native route then raises with
g++'s message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Optional

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "sampling.cpp"
BUILD_DIR = _SRC.parents[2] / "build" / "outfitx_tpu_torch"
# No -march=native (the JAX package's flag): the library may be built on one
# x86-64 host and loaded on another that shares the checkout.
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> pathlib.Path:
    sha = hashlib.sha256(_SRC.read_bytes())
    sha.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libsampling-{sha.hexdigest()[:12]}.so"


def _build() -> pathlib.Path:
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
            capture_output=True, text=True,
        )
    except OSError as e:
        raise RuntimeError(f"native sampling library: g++ did not run: {e}") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native sampling library: g++ exit {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.cir_assemble.restype = None
    lib.cir_assemble.argtypes = [
        i32p, i32p, u8p, ctypes.c_int64, ctypes.c_int32,
        i64p, ctypes.c_int64,
        i32p, i32p, i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, ctypes.c_uint64,
        i32p, u8p, i32p, i32p, u8p,
    ]
    lib.cir_eval_assemble.restype = None
    lib.cir_eval_assemble.argtypes = [
        i32p, i32p, u8p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_uint64,
        i32p, u8p, i32p,
    ]
    lib.negatives_assemble.restype = None
    lib.negatives_assemble.argtypes = [
        i32p, ctypes.c_int64,
        i32p, i32p, i32p,
        ctypes.c_int32, ctypes.c_uint64, ctypes.c_uint64,
        i32p, u8p,
    ]
    return lib


def load() -> ctypes.CDLL:
    """The sampling library, built first if needed. Raises with g++'s
    message when it cannot be built; a failed build is not tried again."""
    global _lib, _error
    if _lib is None and _error is None:
        try:
            _lib = _bind(ctypes.CDLL(str(_build())))
        except (RuntimeError, OSError) as e:
            _error = str(e)
    if _lib is None:
        raise RuntimeError(_error)
    return _lib


def available() -> bool:
    """Whether the library is built or can be built here."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _outfits(item_rows, lengths, pos_eligible):
    """The split's arrays as the C entries read them, after the checks
    that keep those reads inside them: at most 64 members an outfit, each
    length within its row, and an eligible positive among its members."""
    item_rows = np.ascontiguousarray(item_rows, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    pos_eligible = np.ascontiguousarray(pos_eligible, dtype=bool)
    n, width = item_rows.shape
    if width > 64:
        raise ValueError("native assembler supports outfits up to L=64")
    if lengths.shape != (n,) or pos_eligible.shape != (n, width):
        raise ValueError("item_rows, lengths and pos_eligible disagree in shape")
    members = np.arange(width)[None, :] < lengths[:, None]
    if n and (lengths.min() < 1 or lengths.max() > width or not (pos_eligible & members).any(1).all()):
        raise ValueError("each outfit needs 1 to L members and an eligible positive among them")
    return item_rows, lengths, pos_eligible.view(np.uint8)


def _in_range(rows: np.ndarray, n: int, what: str) -> None:
    if len(rows) and (rows.min() < 0 or rows.max() >= n):
        raise IndexError(f"{what} outside [0, {n})")


def _csr_pools(key_of_row: np.ndarray):
    """CSR grouping of catalog rows by sampling key."""
    key_of_row = np.ascontiguousarray(key_of_row, dtype=np.int32)
    n_keys = int(key_of_row.max()) + 1 if len(key_of_row) else 1
    order = np.argsort(key_of_row, kind="stable").astype(np.int32)
    counts = np.bincount(key_of_row, minlength=n_keys)
    offsets = np.zeros(n_keys + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    return key_of_row, offsets, order


class NegativeBatchSampler:
    """k distinct same-key negatives for a batch of fixed positives (the
    CIR eval loss): one C call an epoch."""

    def __init__(self, key_of_row: np.ndarray, *, k: int, seed: int):
        self.lib = load()
        self.key_of_row, self.pool_offsets, self.pool_rows = _csr_pools(key_of_row)
        self.k = k
        self.seed = seed

    def sample(self, pos_rows: np.ndarray, epoch: int):
        pos_rows = np.ascontiguousarray(pos_rows, dtype=np.int32)
        _in_range(pos_rows, len(self.key_of_row), "positive rows")
        n = len(pos_rows)
        out_neg = np.empty((n, self.k), dtype=np.int32)
        out_negm = np.empty((n, self.k), dtype=np.uint8)
        self.lib.negatives_assemble(
            _p(pos_rows, ctypes.c_int32), ctypes.c_int64(n),
            _p(self.key_of_row, ctypes.c_int32),
            _p(self.pool_offsets, ctypes.c_int32),
            _p(self.pool_rows, ctypes.c_int32),
            ctypes.c_int32(self.k), ctypes.c_uint64(self.seed), ctypes.c_uint64(epoch),
            _p(out_neg, ctypes.c_int32), _p(out_negm, ctypes.c_uint8),
        )
        return out_neg, out_negm.astype(bool)


class CIRAssembler:
    """A split's outfits and the catalog's CSR key pools, held for native
    CIR batch assembly (outfits up to L=64)."""

    def __init__(
        self,
        item_rows: np.ndarray,  # (n, L) int32
        lengths: np.ndarray,  # (n,) int32
        pos_eligible: np.ndarray,  # (n, L) bool
        key_of_row: np.ndarray,  # (N,) int32 sampling key per catalog row
        *,
        pad_row: int,
        k: int,
        seed: int,
    ):
        self.lib = load()
        self.item_rows, self.lengths, self.pos_eligible = _outfits(
            item_rows, lengths, pos_eligible
        )
        self.n, self.L = self.item_rows.shape
        self.key_of_row, self.pool_offsets, self.pool_rows = _csr_pools(key_of_row)
        self.pad_row = pad_row
        self.k = k
        self.seed = seed

    def assemble(self, sel: np.ndarray, epoch: int):
        sel = np.ascontiguousarray(sel, dtype=np.int64)
        _in_range(sel, self.n, "outfit indices")
        b = len(sel)
        out_item = np.empty((b, self.L), dtype=np.int32)
        out_mask = np.empty((b, self.L), dtype=np.uint8)
        out_pos = np.empty((b,), dtype=np.int32)
        out_neg = np.empty((b, self.k), dtype=np.int32)
        out_negm = np.empty((b, self.k), dtype=np.uint8)
        self.lib.cir_assemble(
            _p(self.item_rows, ctypes.c_int32), _p(self.lengths, ctypes.c_int32),
            _p(self.pos_eligible, ctypes.c_uint8),
            ctypes.c_int64(self.n), ctypes.c_int32(self.L),
            _p(sel, ctypes.c_int64), ctypes.c_int64(b),
            _p(self.key_of_row, ctypes.c_int32),
            _p(self.pool_offsets, ctypes.c_int32),
            _p(self.pool_rows, ctypes.c_int32),
            ctypes.c_int32(self.k), ctypes.c_int32(self.pad_row),
            ctypes.c_uint64(self.seed), ctypes.c_uint64(epoch),
            _p(out_item, ctypes.c_int32), _p(out_mask, ctypes.c_uint8),
            _p(out_pos, ctypes.c_int32), _p(out_neg, ctypes.c_int32),
            _p(out_negm, ctypes.c_uint8),
        )
        return {
            "item_idx": out_item,
            "mask": out_mask.astype(bool),
            "pos_idx": out_pos,
            "neg_idx": out_neg,
            "neg_mask": out_negm.astype(bool),
        }


def eval_assemble(item_rows, lengths, pos_eligible, *, pad_row: int, seed: int):
    """CIR eval queries in one C call: (item_idx (n, L) int32, mask (n, L)
    bool True = pad, pos_idx (n,) int32)."""
    lib = load()
    item_rows, lengths, pos_eligible = _outfits(item_rows, lengths, pos_eligible)
    n, length = item_rows.shape
    item_idx = np.empty((n, length), dtype=np.int32)
    mask = np.empty((n, length), dtype=np.uint8)
    pos_idx = np.empty(n, dtype=np.int32)
    lib.cir_eval_assemble(
        _p(item_rows, ctypes.c_int32), _p(lengths, ctypes.c_int32),
        _p(pos_eligible, ctypes.c_uint8), ctypes.c_int64(n), ctypes.c_int32(length),
        ctypes.c_int32(pad_row), ctypes.c_uint64(seed),
        _p(item_idx, ctypes.c_int32), _p(mask, ctypes.c_uint8), _p(pos_idx, ctypes.c_int32),
    )
    return item_idx, mask.astype(bool), pos_idx
