"""The weight bridge between JAX parameter trees and state dicts.

``state_dict_from_jax`` is this package's own copy of the mapping in
``outfitx_tpu/models/export_torch.py:reference_state_dict``: the fused
``wqkv (d, 3, d)`` becomes ``in_proj_weight (3d, d)`` and every matrix is
transposed to torch's (out, in). ``load_jax_checkpoint`` reads a checkpoint
directory written by the JAX package's ``CheckpointManager`` (``state.npz``
holding ``leaf_{i}`` byte buffers, ``tree.json`` holding the tree and each
leaf's shape and dtype) with numpy alone. ``jax_params_from_state_dict``
is the inverse of ``state_dict_from_jax``: the port's checkpoints store
parameters in the JAX tree layout (``train/checkpoint.py``).
``item_encoder_state_dict_from_jax`` maps the item encoder's tower trees
(clip, siglip, and resnet_sbert's ResNet-18 and MiniLM) onto
``ItemEncoderModel``'s state dict. ``quantized_state_dict_from_jax`` maps
the JAX int8 serving tree (``quantize_outfitx_params``) onto
``QuantizedOutfitX``'s buffers.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict

import numpy as np
import torch


from outfitx_tpu_torch.models.towers.common import as_f32 as _f32


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


def jax_params_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``state_dict_from_jax``: an ``OutfitXModel`` state
    dict as the JAX package's parameter tree of float32 numpy arrays, the
    encoder layers stacked along a leading axis."""

    def f32(t) -> np.ndarray:
        return t.detach().to(device="cpu", dtype=torch.float32).numpy()

    n_layers = 1 + max(
        int(k.split(".")[2]) for k in sd if k.startswith("transformer_encoder.layers.")
    )

    def stack(name, fn=lambda t: t):
        return np.stack([
            fn(f32(sd[f"transformer_encoder.layers.{i}.{name}"]))
            for i in range(n_layers)
        ])

    def split_qkv(w):  # (3d, d) rows [Wq; Wk; Wv] -> (d_in, 3, d_out)
        return np.stack(np.split(w, 3, axis=0), axis=1).transpose(2, 1, 0)

    params: Dict[str, Any] = {
        "layers": {
            "attn": {
                "wqkv": stack("self_attn.in_proj_weight", split_qkv),
                "bqkv": stack("self_attn.in_proj_bias", lambda b: b.reshape(3, -1)),
                "wo": stack("self_attn.out_proj.weight", np.transpose),
                "bo": stack("self_attn.out_proj.bias"),
            },
            "ffn": {
                "w1": stack("linear1.weight", np.transpose),
                "b1": stack("linear1.bias"),
                "w2": stack("linear2.weight", np.transpose),
                "b2": stack("linear2.bias"),
            },
            "ln1": {"scale": stack("norm1.weight"), "bias": stack("norm1.bias")},
            "ln2": {"scale": stack("norm2.weight"), "bias": stack("norm2.bias")},
        },
        "outfit_token": f32(sd["outfit_token"]),
        "target_image_emb": f32(sd["target_item_image_emb"]),
        "cp_head": {
            "w": f32(sd["cp_ffn.1.weight"]).T.copy(),
            "b": f32(sd["cp_ffn.1.bias"]),
        },
        "cir_proj": {"w": f32(sd["cir_ffn.0.weight"]).T.copy()},
    }
    if "transformer_encoder.norm.weight" in sd:
        params["final_ln"] = {
            "scale": f32(sd["transformer_encoder.norm.weight"]),
            "bias": f32(sd["transformer_encoder.norm.bias"]),
        }
    return params


def _linear_from_jax(sd, prefix: str, p) -> None:
    """A JAX ``linear`` ({'w': (d_in, d_out)[, 'b']}) as an ``nn.Linear``."""
    sd[prefix + ".weight"] = _f32(p["w"]).T.contiguous()
    if "b" in p:
        sd[prefix + ".bias"] = _f32(p["b"])


def _ln_from_jax(sd, prefix: str, p) -> None:
    sd[prefix + ".weight"] = _f32(p["scale"])
    sd[prefix + ".bias"] = _f32(p["bias"])


def _encoder_from_jax(sd, prefix: str, layers) -> None:
    """The JAX towers hold every layer stacked along a leading ``n_layers``
    axis; the port holds a list of layers."""
    n_layers = np.shape(layers["ln1"]["scale"])[0]

    def at(tree, i):
        return {k: v[i] for k, v in tree.items()}

    for i in range(n_layers):
        lp = f"{prefix}.layers.{i}"
        _ln_from_jax(sd, f"{lp}.ln1", at(layers["ln1"], i))
        _ln_from_jax(sd, f"{lp}.ln2", at(layers["ln2"], i))
        for name in ("q", "k", "v", "o"):
            _linear_from_jax(sd, f"{lp}.{name}", at(layers["attn"][name], i))
        for name in ("fc1", "fc2"):
            _linear_from_jax(sd, f"{lp}.{name}", at(layers["mlp"][name], i))


def _bn_from_jax(sd, prefix: str, p) -> None:
    """A JAX folded-BatchNorm leaf set as torchvision's BatchNorm names."""
    sd[prefix + ".weight"] = _f32(p["scale"])
    sd[prefix + ".bias"] = _f32(p["bias"])
    sd[prefix + ".running_mean"] = _f32(p["mean"])
    sd[prefix + ".running_var"] = _f32(p["var"])


def _resnet_from_jax(sd, prefix: str, p) -> None:
    bb = p["backbone"]
    sd[prefix + ".conv1.weight"] = _f32(bb["conv1"])
    _bn_from_jax(sd, prefix + ".bn1", bb["bn1"])
    for si, blocks in enumerate(bb["stages"]):
        for bi, blk in enumerate(blocks):
            bp = f"{prefix}.layer{si + 1}.{bi}"
            for name in ("conv1", "conv2"):
                sd[f"{bp}.{name}.weight"] = _f32(blk[name])
            _bn_from_jax(sd, bp + ".bn1", blk["bn1"])
            _bn_from_jax(sd, bp + ".bn2", blk["bn2"])
            if "down_conv" in blk:
                sd[bp + ".downsample.0.weight"] = _f32(blk["down_conv"])
                _bn_from_jax(sd, bp + ".downsample.1", blk["down_bn"])
    _linear_from_jax(sd, prefix + ".fc", p["fc"])


def _minilm_from_jax(sd, prefix: str, p) -> None:
    bb = p["backbone"]
    for name in ("word_emb", "pos_emb", "type_emb"):
        sd[f"{prefix}.{name}"] = _f32(bb[name])
    _ln_from_jax(sd, prefix + ".emb_ln", bb["emb_ln"])
    layers = bb["layers"]
    for i in range(np.shape(layers["attn_ln"]["scale"])[0]):
        lp = f"{prefix}.layers.{i}"
        for name in ("attn_ln", "mlp_ln"):
            _ln_from_jax(sd, f"{lp}.{name}", {k: v[i] for k, v in layers[name].items()})
        for group, names in (("attn", "qkvo"), ("mlp", ("fc1", "fc2"))):
            for name in names:
                _linear_from_jax(
                    sd, f"{lp}.{name}", {k: v[i] for k, v in layers[group][name].items()}
                )
    _linear_from_jax(sd, prefix + ".proj", p["proj"])


def item_encoder_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a JAX ``ItemEncoderModel`` parameter tree ({'vision', 'text'} of
    the clip, siglip or resnet_sbert towers, numpy arrays) onto the port's
    ``ItemEncoderModel`` state dict, in float32: the layer stack is split
    per layer and every ``linear`` weight transposed to (out, in);
    convolution weights keep their (Cout, Cin, K, K) layout."""
    sd: Dict[str, torch.Tensor] = {}
    vis, txt = params["vision"], params["text"]
    if "backbone" in vis:  # resnet_sbert
        _resnet_from_jax(sd, "vision", vis)
        _minilm_from_jax(sd, "text", txt)
        return sd
    _linear_from_jax(sd, "vision.patch", vis["patch"])
    sd["vision.pos_emb"] = _f32(vis["pos_emb"])
    _encoder_from_jax(sd, "vision.encoder", vis["layers"])
    _ln_from_jax(sd, "vision.post_ln", vis["post_ln"])
    if "cls" in vis:  # clip
        sd["vision.cls"] = _f32(vis["cls"])
        _ln_from_jax(sd, "vision.pre_ln", vis["pre_ln"])
        _linear_from_jax(sd, "vision.proj", vis["proj"])
    else:  # siglip: the attention-pooling head
        mp = vis["map"]
        sd["vision.map.probe"] = _f32(mp["probe"])
        for name in ("q", "k", "v", "o"):
            _linear_from_jax(sd, f"vision.map.{name}", mp["attn"][name])
        _ln_from_jax(sd, "vision.map.ln", mp["ln"])
        for name in ("fc1", "fc2"):
            _linear_from_jax(sd, f"vision.map.{name}", mp["mlp"][name])
    sd["text.tok_emb"] = _f32(txt["tok_emb"])
    sd["text.pos_emb"] = _f32(txt["pos_emb"])
    _encoder_from_jax(sd, "text.encoder", txt["layers"])
    _ln_from_jax(sd, "text.final_ln", txt["final_ln"])
    _linear_from_jax(sd, "text.proj", txt["proj"])
    return sd


def _qlinear_from_jax(sd, prefix: str, q, i=None, bias=None) -> None:
    """A JAX ``QuantLinear`` ((.., d_in, d_out) int8 values, (.., d_out)
    scales; layer ``i`` of a stacked one) as ``QLinear`` buffers: the
    values transposed to (d_out, d_in), int8 kept."""
    values, scales = (np.asarray(getattr(q, k)) for k in ("values", "scales"))
    if i is not None:
        values, scales = values[i], scales[i]
    sd[prefix + ".values"] = torch.from_numpy(np.ascontiguousarray(values.T)).to(torch.int8)
    sd[prefix + ".scales"] = _f32(scales)
    if bias is not None:
        sd[prefix + ".bias"] = _f32(bias)


def quantized_state_dict_from_jax(qparams: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a JAX int8 serving tree (``outfitx_tpu/models/quantized.py
    quantize_outfitx_params``: ``QuantLinear`` values and scales, float32
    LayerNorms, biases, tokens and CP head; numpy leaves) onto
    ``QuantizedOutfitX``'s state dict, so that both packages run on the same
    int8 tables."""
    sd: Dict[str, torch.Tensor] = {}
    layers = qparams["layers"]
    attn, ffn = layers["attn"], layers["ffn"]
    for i in range(np.shape(layers["ln1"]["scale"])[0]):
        p = f"transformer_encoder.layers.{i}."
        _qlinear_from_jax(sd, p + "self_attn.in_proj", attn["wqkv"], i, attn["bqkv"][i])
        _qlinear_from_jax(sd, p + "self_attn.out_proj", attn["wo"], i, attn["bo"][i])
        _qlinear_from_jax(sd, p + "linear1", ffn["w1"], i, ffn["b1"][i])
        _qlinear_from_jax(sd, p + "linear2", ffn["w2"], i, ffn["b2"][i])
        for norm, ln in (("norm1", "ln1"), ("norm2", "ln2")):
            _ln_from_jax(sd, p + norm, {k: v[i] for k, v in layers[ln].items()})
    if "final_ln" in qparams:
        _ln_from_jax(sd, "transformer_encoder.norm", qparams["final_ln"])
    sd["outfit_token"] = _f32(qparams["outfit_token"])
    sd["target_item_image_emb"] = _f32(qparams["target_image_emb"])
    _linear_from_jax(sd, "cp_ffn.1", qparams["cp_head"])
    _qlinear_from_jax(sd, "cir_ffn.0", qparams["cir_proj"]["w"])
    return sd


def _read_leaf(buf: np.ndarray, dtype: str, shape) -> Any:
    """One saved leaf: a flat uint8 buffer reinterpreted as its dtype.
    bfloat16 has no numpy dtype here, so it goes through torch."""
    if dtype == "bfloat16":
        bits = torch.from_numpy(buf.view(np.int16).copy())
        return bits.view(torch.bfloat16).reshape(shape)
    if dtype == "bool":
        return buf.astype(bool).reshape(shape)
    return buf.view(np.dtype(dtype)).reshape(shape)


def read_checkpoint_tree(path: str | pathlib.Path) -> Dict[str, Any]:
    """The whole tree of a ``state.npz`` checkpoint directory (written by
    either package), leaves as numpy arrays (bfloat16 ones as tensors)."""
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
            if isinstance(sk, list):
                return [build(v) for v in sk]
            if sk is None:
                return None
            shape, dtype = specs[sk]
            return _read_leaf(z[f"leaf_{sk}"], dtype, shape)

        return build(info["skeleton"])


def load_jax_checkpoint(path: str | pathlib.Path) -> Dict[str, torch.Tensor]:
    """A checkpoint directory's parameters as an ``OutfitXModel`` state
    dict (float32, on the CPU)."""
    return state_dict_from_jax(read_checkpoint_tree(path)["params"])
