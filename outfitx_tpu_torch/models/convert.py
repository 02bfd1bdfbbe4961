"""Pretrained tower weights: HF state dicts -> the port's tower state dicts.

The port of ``outfitx_tpu/models/convert.py`` for the reference's tower
families: CLIP (patrickjohncyh/fashion-clip: ``CLIPVisionModelWithProjection``
and ``CLIPTextModelWithProjection``) and SigLIP (Marqo/marqo-fashionSigLIP:
``SiglipVisionModel`` and ``SiglipTextModel``). HF and the port both keep a
linear's weight as (out, in), so the conversion is a renaming: the patch
embedding's (D, 3, P, P) convolution becomes the (D, 3 P P) patch linear
(channel-first flatten, as ``VisionTower.patchify``), SigLIP's packed
attention-pooling projection is split into Q, K and V, and every tensor is
widened to float32. Each function returns the state dict of one tower
(``VisionTower`` or ``TextTower``), without the ``vision.`` / ``text.``
prefix of ``ItemEncoderModel``. The ResNet-18 and MiniLM converters sit
beside their towers (``towers/resnet.py``, ``towers/minilm.py``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from outfitx_tpu_torch.models.towers.common import as_f32

StateDict = Dict[str, torch.Tensor]


def _lin(out: StateDict, mine: str, sd, theirs: str, *, bias: bool = True) -> None:
    out[mine + ".weight"] = as_f32(sd[theirs + ".weight"])
    if bias:
        out[mine + ".bias"] = as_f32(sd[theirs + ".bias"])


def _encoder_layers(out: StateDict, sd, prefix: str, n_layers: int) -> None:
    """HF CLIP/SigLIP encoder layers -> ``TowerEncoder`` layers."""
    names = {
        "ln1": "layer_norm1", "ln2": "layer_norm2",
        "q": "self_attn.q_proj", "k": "self_attn.k_proj",
        "v": "self_attn.v_proj", "o": "self_attn.out_proj",
        "fc1": "mlp.fc1", "fc2": "mlp.fc2",
    }
    for i in range(n_layers):
        for mine, theirs in names.items():
            _lin(out, f"encoder.layers.{i}.{mine}", sd, f"{prefix}.layers.{i}.{theirs}")


def _patch(out: StateDict, sd, *, bias: bool) -> None:
    pe = as_f32(sd["vision_model.embeddings.patch_embedding.weight"])  # (D, 3, P, P)
    out["patch.weight"] = pe.reshape(pe.shape[0], -1)
    if bias:
        out["patch.bias"] = as_f32(sd["vision_model.embeddings.patch_embedding.bias"])


def convert_clip_vision(sd, n_layers: int = 12) -> StateDict:
    """CLIPVisionModelWithProjection -> ``VisionTower`` (variant clip)."""
    out: StateDict = {}
    _patch(out, sd, bias=False)
    out["cls"] = as_f32(sd["vision_model.embeddings.class_embedding"])
    out["pos_emb"] = as_f32(sd["vision_model.embeddings.position_embedding.weight"])
    _lin(out, "pre_ln", sd, "vision_model.pre_layrnorm")  # HF's spelling
    _encoder_layers(out, sd, "vision_model.encoder", n_layers)
    _lin(out, "post_ln", sd, "vision_model.post_layernorm")
    _lin(out, "proj", sd, "visual_projection", bias=False)
    return out


def convert_clip_text(sd, n_layers: int = 12) -> StateDict:
    """CLIPTextModelWithProjection -> ``TextTower`` (variant clip)."""
    out: StateDict = {
        "tok_emb": as_f32(sd["text_model.embeddings.token_embedding.weight"]),
        "pos_emb": as_f32(sd["text_model.embeddings.position_embedding.weight"]),
    }
    _encoder_layers(out, sd, "text_model.encoder", n_layers)
    _lin(out, "final_ln", sd, "text_model.final_layer_norm")
    _lin(out, "proj", sd, "text_projection", bias=False)
    return out


def convert_siglip_vision(sd, n_layers: int = 12) -> StateDict:
    """SiglipVisionModel -> ``VisionTower`` (variant siglip), its
    attention-pooling head from torch's packed ``in_proj``."""
    out: StateDict = {}
    _patch(out, sd, bias=True)
    out["pos_emb"] = as_f32(sd["vision_model.embeddings.position_embedding.weight"])
    _encoder_layers(out, sd, "vision_model.encoder", n_layers)
    _lin(out, "post_ln", sd, "vision_model.post_layernorm")
    head = "vision_model.head"
    out["map.probe"] = as_f32(sd[head + ".probe"]).reshape(-1)
    in_w = as_f32(sd[head + ".attention.in_proj_weight"])  # (3D, D) rows [Q; K; V]
    in_b = as_f32(sd[head + ".attention.in_proj_bias"])
    for name, w, b in zip("qkv", in_w.chunk(3, dim=0), in_b.chunk(3, dim=0)):
        out[f"map.{name}.weight"], out[f"map.{name}.bias"] = w.contiguous(), b.contiguous()
    _lin(out, "map.o", sd, head + ".attention.out_proj")
    _lin(out, "map.ln", sd, head + ".layernorm")
    _lin(out, "map.fc1", sd, head + ".mlp.fc1")
    _lin(out, "map.fc2", sd, head + ".mlp.fc2")
    return out


def convert_siglip_text(sd, n_layers: int = 12) -> StateDict:
    """SiglipTextModel -> ``TextTower`` (variant siglip, biased head)."""
    out: StateDict = {
        "tok_emb": as_f32(sd["text_model.embeddings.token_embedding.weight"]),
        "pos_emb": as_f32(sd["text_model.embeddings.position_embedding.weight"]),
    }
    _encoder_layers(out, sd, "text_model.encoder", n_layers)
    _lin(out, "final_ln", sd, "text_model.final_layer_norm")
    _lin(out, "proj", sd, "text_model.head")
    return out


CONVERTERS: Dict[str, Callable] = {
    "clip_vision": convert_clip_vision,
    "clip_text": convert_clip_text,
    "siglip_vision": convert_siglip_vision,
    "siglip_text": convert_siglip_text,
}
