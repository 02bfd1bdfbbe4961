"""The weight bridge: JAX parameter trees and checkpoints -> state dicts.

``state_dict_from_jax`` is this package's own copy of the mapping in
``outfitx_tpu/models/export_torch.py:reference_state_dict``: the fused
``wqkv (d, 3, d)`` becomes ``in_proj_weight (3d, d)`` and every matrix is
transposed to torch's (out, in). ``load_jax_checkpoint`` reads a checkpoint
directory written by the JAX package's ``CheckpointManager`` (``state.npz``
holding ``leaf_{i}`` byte buffers, ``tree.json`` holding the tree and each
leaf's shape and dtype) with numpy alone.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a JAX ``OutfitXModel`` parameter tree (numpy arrays, or tensors
    as ``load_jax_checkpoint`` reads them) onto ``OutfitXModel``'s state
    dict, in float32."""
    sd: Dict[str, torch.Tensor] = {}
    layers = params["layers"]
    attn, ffn = layers["attn"], layers["ffn"]
    wqkv, bqkv = _f32(attn["wqkv"]), _f32(attn["bqkv"])
    wo, bo = _f32(attn["wo"]), _f32(attn["bo"])
    w1, b1, w2, b2 = (_f32(ffn[k]) for k in ("w1", "b1", "w2", "b2"))
    ln1s, ln1b = _f32(layers["ln1"]["scale"]), _f32(layers["ln1"]["bias"])
    ln2s, ln2b = _f32(layers["ln2"]["scale"]), _f32(layers["ln2"]["bias"])
    for i in range(wqkv.shape[0]):
        p = f"transformer_encoder.layers.{i}."
        sd[p + "self_attn.in_proj_weight"] = torch.cat(
            [wqkv[i, :, j].T for j in range(3)], dim=0
        ).contiguous()
        sd[p + "self_attn.in_proj_bias"] = bqkv[i].reshape(-1)
        sd[p + "self_attn.out_proj.weight"] = wo[i].T.contiguous()
        sd[p + "self_attn.out_proj.bias"] = bo[i]
        sd[p + "linear1.weight"] = w1[i].T.contiguous()
        sd[p + "linear1.bias"] = b1[i]
        sd[p + "linear2.weight"] = w2[i].T.contiguous()
        sd[p + "linear2.bias"] = b2[i]
        sd[p + "norm1.weight"] = ln1s[i]
        sd[p + "norm1.bias"] = ln1b[i]
        sd[p + "norm2.weight"] = ln2s[i]
        sd[p + "norm2.bias"] = ln2b[i]
    if "final_ln" in params:
        sd["transformer_encoder.norm.weight"] = _f32(params["final_ln"]["scale"])
        sd["transformer_encoder.norm.bias"] = _f32(params["final_ln"]["bias"])
    sd["outfit_token"] = _f32(params["outfit_token"])
    sd["target_item_image_emb"] = _f32(params["target_image_emb"])
    sd["cp_ffn.1.weight"] = _f32(params["cp_head"]["w"]).T.contiguous()
    sd["cp_ffn.1.bias"] = _f32(params["cp_head"]["b"])
    sd["cir_ffn.0.weight"] = _f32(params["cir_proj"]["w"]).T.contiguous()
    return sd


def _leaf(buf: np.ndarray, dtype: str, shape) -> Any:
    """One saved leaf: a flat uint8 buffer reinterpreted as its dtype.
    bfloat16 has no numpy dtype here, so it goes through torch."""
    if dtype == "bfloat16":
        bits = torch.from_numpy(buf.view(np.int16).copy())
        return bits.view(torch.bfloat16).reshape(shape)
    return buf.view(np.dtype(dtype)).reshape(shape)


def load_jax_checkpoint(path: str | pathlib.Path) -> Dict[str, torch.Tensor]:
    """A JAX checkpoint directory's parameters as an ``OutfitXModel`` state
    dict (float32, on the CPU). Only the ``params`` subtree is read."""
    path = pathlib.Path(path)
    if not (path / "state.npz").is_file():
        raise FileNotFoundError(
            f"{path} holds no state.npz (orbax-format checkpoints are not read)"
        )
    with open(path / "tree.json", encoding="utf-8") as f:
        info = json.load(f)
    specs = info["specs"]
    with np.load(path / "state.npz") as z:

        def build(sk):
            if isinstance(sk, dict):
                return {k: build(v) for k, v in sk.items()}
            shape, dtype = specs[sk]
            return _leaf(z[f"leaf_{sk}"], dtype, shape)

        params = build(info["skeleton"]["params"])
    return state_dict_from_jax(params)
