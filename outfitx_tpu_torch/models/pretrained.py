"""Pretrained tower weights for the item encoder, from HF checkpoint
directories on the local disk.

The port of ``outfitx_tpu/models/pretrained.py``. A checkpoint is a
``vision/`` and a ``text/`` directory, or one directory holding both
towers; each holds ``model.safetensors`` or ``pytorch_model.bin``. Nothing
is downloaded. ``model.safetensors`` is read by this module's own reader
(``read_safetensors``: numpy and the standard library), since the package
imports no ``safetensors``; ``pytorch_model.bin`` by
``torch.load(weights_only=True)``. The converters (``models/convert.py``,
``towers/resnet.py``, ``towers/minilm.py``) map the HF names onto the
port's state dict.
"""

from __future__ import annotations

import json
import pathlib
import struct
from typing import Dict, Optional

import numpy as np
import torch

from outfitx_tpu_torch.models.convert import CONVERTERS
from outfitx_tpu_torch.models.towers import TextTowerConfig, VisionTowerConfig
from outfitx_tpu_torch.models.towers.minilm import MiniLMConfig, convert_minilm
from outfitx_tpu_torch.models.towers.resnet import ResNet18Config, convert_resnet18

# safetensors dtype names -> little-endian numpy dtypes; BF16 has none and
# is widened by hand.
_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: str | pathlib.Path) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file as numpy arrays: an 8-byte little-endian
    header length, a JSON header ({name: {dtype, shape, data_offsets}},
    offsets relative to the end of the header), then the raw buffers.
    F16 and BF16 tensors are widened to float32, which is exact; the other
    types keep theirs."""
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        body = np.fromfile(f, dtype=np.uint8)
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {dtype}")
        begin, end = info["data_offsets"]
        np_dtype = np.dtype(_ST_DTYPES[dtype])
        shape = tuple(info["shape"])
        if not 0 <= begin <= end <= body.size or end - begin != np_dtype.itemsize * int(
            np.prod(shape, dtype=np.int64)
        ):
            raise ValueError(f"{path}: tensor {name!r} has bad data_offsets {info['data_offsets']}")
        arr = body[begin:end].view(np_dtype).reshape(shape)
        if dtype == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        elif dtype == "F16":
            arr = arr.astype(np.float32)
        else:
            arr = arr.astype(np_dtype.newbyteorder("="), copy=True)
        out[name] = arr
    return out


def read_state_dict(path: str | pathlib.Path) -> Dict[str, object]:
    """The tower state dict under ``path``: ``model.safetensors`` (numpy
    arrays) or else ``pytorch_model.bin`` (tensors)."""
    path = pathlib.Path(path)
    st = path / "model.safetensors"
    if st.is_file():
        return read_safetensors(st)
    bin_path = path / "pytorch_model.bin"
    if bin_path.is_file():
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin under {path}")


def _strip_prefix(sd: Dict[str, object], prefix: str) -> Dict[str, object]:
    if any(k.startswith(prefix) for k in sd):
        return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}
    return sd


def _head(init_state: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {leaf: init_state[f"{prefix}.{leaf}"] for leaf in ("weight", "bias")}


# Each tower config's converter from its HF state dict: (config, state
# dict, init_state) -> the tower's state dict. ResNet-18 and MiniLM take
# their fresh heads from init_state.
_LOADERS = {
    VisionTowerConfig: lambda c, sd, init: CONVERTERS[f"{c.variant}_vision"](
        sd, n_layers=c.n_layers),
    TextTowerConfig: lambda c, sd, init: CONVERTERS[f"{c.variant}_text"](
        sd, n_layers=c.n_layers),
    ResNet18Config: lambda c, sd, init: convert_resnet18(
        sd, d_out=c.d_out, init_fc=_head(init, "vision.fc")),
    MiniLMConfig: lambda c, sd, init: convert_minilm(
        _strip_prefix(sd, "bert."), n_layers=c.n_layers, init_proj=_head(init, "text.proj")),
}


def load_item_encoder_state_dict(
    encoder,
    checkpoint_dir: str | pathlib.Path,
    init_state: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The state dict of ``encoder`` (an ``ItemEncoderModel``) with the
    pretrained tower weights under ``checkpoint_dir``, in float32, for
    ``encoder.load_state_dict``.

    ``resnet_sbert`` takes its fresh heads (``vision.fc`` unless the
    checkpoint's fc has the encoder's width, and ``text.proj``) from
    ``init_state``, a state dict of the encoder (its own random heads,
    ``encoder.state_dict()``), and raises without one. The MiniLM
    checkpoint may carry HF's ``bert.`` prefix."""
    root = pathlib.Path(checkpoint_dir)
    if not root.is_dir():
        raise FileNotFoundError(f"checkpoint directory {root} does not exist")
    vis_dir = root / "vision" if (root / "vision").is_dir() else root
    txt_dir = root / "text" if (root / "text").is_dir() else root
    loaders = [_LOADERS.get(type(tower.cfg)) for tower in (encoder.vision, encoder.text)]
    if None in loaders:
        raise NotImplementedError(encoder.cfg.encoder_type)
    if encoder.has_trainable_heads and init_state is None:
        raise ValueError(f"{encoder.cfg.encoder_type} needs init_state for its fresh fc and "
                         "proj heads")
    vision = loaders[0](encoder.vision.cfg, read_state_dict(vis_dir), init_state)
    text = loaders[1](encoder.text.cfg, read_state_dict(txt_dir), init_state)
    return {
        **{f"vision.{k}": v for k, v in vision.items()},
        **{f"text.{k}": v for k, v in text.items()},
    }
