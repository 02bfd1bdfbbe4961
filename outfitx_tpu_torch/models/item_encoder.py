"""The cross-modal item encoder: frozen vision and text towers with fusion.

The port of ``outfitx_tpu/models/item_encoder.py``: the tower pair named by
``cfg.encoder_type`` (CLIP, SigLIP, or ResNet-18 with MiniLM for
``resnet_sbert``) encodes both modalities, each embedding is optionally
L2-normalised, and the two are aggregated (concat, mean or sum). The towers
are frozen: CLIP and SigLIP take no gradient at all, and ``resnet_sbert``
only in its two fresh heads, ResNet's ``fc`` and MiniLM's ``proj`` (the JAX
encoder's ``has_trainable_heads``). ``resnet_dsv2lite`` (no JAX
counterpart) puts DeepSeek-V2-Lite in MiniLM's place
(``towers/deepseek_v2.py``), its bfloat16 weights made and drawn on the
encoder's device, with the same two fresh heads. ``kimivl_a3b`` (no JAX
counterpart) is the first joint pair: MoonViT's image tokens
(``towers/moonvit.py``) and the item's title go through one pass of
Kimi-VL-A3B's MoE decoder (``towers/deepseek_v2.py``); the decoder's mean
over the image positions goes through MoonViT's ``fc``, its mean over the
title's real tokens through the decoder's ``proj``. Outputs are float32;
with concat fusion the text half is ``emb[d // 2:]``, which the datasets
rely on.

A pair is one row of ``PAIR_TOWERS`` (its tower configs) and one of
``core/config.py ENCODER_PAIRS`` (its widths, names, image statistics,
trainable heads and tokenizer rule). A tower's class, its normaliser, and
whether the pair encodes jointly, follow from its config's type (``TOWERS``,
``NORMALIZERS``, ``JOINT``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from outfitx_tpu_torch.core import dtypes, trace
from outfitx_tpu_torch.core.config import ItemEncoderConfig
from outfitx_tpu_torch.core.device import resolve_device
from outfitx_tpu_torch.data.preprocess import image_stats, make_normalizer
from outfitx_tpu_torch.models.towers import (
    TextTower,
    TextTowerConfig,
    VisionTower,
    VisionTowerConfig,
)
from outfitx_tpu_torch.models.towers.common import ATTN_ROUTES, MLP_ROUTES, dense
from outfitx_tpu_torch.models.towers.deepseek_v2 import DeepseekV2, DeepseekV2Config
from outfitx_tpu_torch.models.towers.minilm import MiniLM, MiniLMConfig
from outfitx_tpu_torch.models.towers.moonvit import MoonViT, MoonViTConfig
from outfitx_tpu_torch.models.towers.resnet import ResNet18, ResNet18Config
from outfitx_tpu_torch.ops import resnet_nhwc
from outfitx_tpu_torch.utils import aggregate_embeddings

# The fresh heads of the pairs with ``trainable_heads``, the only parameters
# that take a gradient.
TRAINABLE_HEADS = ("vision.fc.", "text.proj.")


def kimivl_decoder(d: int) -> DeepseekV2Config:
    """Kimi-VL-A3B-Instruct's ``text_config`` (DeepSeek-V3's layout) as the
    joint pair's decoder, its ``proj`` at width ``d``."""
    return DeepseekV2Config(
        vocab_size=163840, max_len=131072, d_ffn=11264, routed_scaling=2.446, rms_eps=1e-5,
        rope_theta=800000.0, rope_factor=1.0, scoring="sigmoid", d_out=d)


# Each pair's towers at its width per modality: (vision config, text config).
# Its other facts are its row of ``ENCODER_PAIRS``.
PAIR_TOWERS = {
    "siglip": lambda d: (VisionTowerConfig.siglip_b16(), TextTowerConfig.siglip_b()),
    "clip": lambda d: (VisionTowerConfig.clip_b32(), TextTowerConfig.clip_b()),
    "resnet_sbert": lambda d: (ResNet18Config(d_out=d), MiniLMConfig(d_out=d)),
    "resnet_dsv2lite": lambda d: (ResNet18Config(d_out=d), DeepseekV2Config(d_out=d)),
    "kimivl_a3b": lambda d: (MoonViTConfig(d_out=d), kimivl_decoder(d)),
}

# The tower each config builds, and which of the encoder's arguments its
# constructor takes: the CLIP and SigLIP towers the routes, DeepSeek-V2 the
# device it is made on.
TOWERS = {
    VisionTowerConfig: (VisionTower, ("attn", "mlp")),
    TextTowerConfig: (TextTower, ("attn", "mlp")),
    ResNet18Config: (ResNet18, ()),
    MiniLMConfig: (MiniLM, ()),
    DeepseekV2Config: (DeepseekV2, ("device",)),
    MoonViTConfig: (MoonViT, ("device",)),
}

# Vision configs whose tower hands the text tower image tokens: one decoder
# pass over the image and the title encodes an item.
JOINT = (MoonViTConfig,)


def tower_configs(cfg: ItemEncoderConfig):
    if cfg.encoder_type not in PAIR_TOWERS:
        raise NotImplementedError(f"encoder_type {cfg.encoder_type!r} has no towers")
    return PAIR_TOWERS[cfg.encoder_type](cfg.dim_per_modality)


def resnet_normalizer(encoder_type: str, dtype: torch.dtype):
    """ResNet-18's input: (B, 3, H, W) uint8 -> ``make_normalizer``'s
    float32 ``(x / 255 - mean) / std``, rounded once to ``dtype`` and laid
    out channels-last, in one pass on the card (``ops/resnet_nhwc.py``)."""
    stats = image_stats(encoder_type, (3,))

    def normalize(x_uint8: torch.Tensor) -> torch.Tensor:
        return resnet_nhwc.normalize(x_uint8, *stats(x_uint8.device), dtype)

    return normalize


# The normaliser each vision tower's images go through, at the pair's
# statistics: ResNet-18's NHWC kernel, and the float32 one for the ViTs.
NORMALIZERS = {
    VisionTowerConfig: lambda etype, vc: make_normalizer(etype),
    ResNet18Config: lambda etype, vc: resnet_normalizer(etype, dtypes.resolve(vc.compute_dtype)),
    MoonViTConfig: lambda etype, vc: make_normalizer(etype),
}


class ItemEncoderModel(nn.Module):
    """Weights are random, drawn from ``seed`` with the JAX towers'
    distributions (not their numbers), until a state dict is loaded (see
    ``models/from_jax.py item_encoder_state_dict_from_jax`` and
    ``models/pretrained.py``). ``attn`` and ``mlp`` choose the CLIP and
    SigLIP towers' formulations (``towers/common.py``); ResNet-18, MiniLM,
    DeepSeek-V2 and MoonViT have one formulation each and take neither.
    DeepSeek-V2 and MoonViT are made on ``device`` and drawn there from a
    generator on that device seeded with ``seed``; the other towers are
    drawn on the host and moved."""

    def __init__(
        self,
        cfg: Optional[ItemEncoderConfig] = None,
        *,
        vision_cfg: Optional[VisionTowerConfig | ResNet18Config] = None,
        text_cfg: Optional[TextTowerConfig | MiniLMConfig | DeepseekV2Config] = None,
        device: str | torch.device = "cuda",
        seed: int = 0,
        attn: str = "mha",
        mlp: str = "plain",
    ):
        super().__init__()
        self.cfg = cfg = cfg or ItemEncoderConfig()
        dev = resolve_device(device)
        vc, tc = tower_configs(cfg)
        vc = vision_cfg or vc
        tc = text_cfg or tc
        # A tower whose width disagrees with dim_per_modality would corrupt
        # the concat layout (the text half must be emb[d // 2:]).
        for name, d_out in (("vision", vc.d_out), ("text", tc.d_out)):
            if d_out != cfg.dim_per_modality:
                raise ValueError(
                    f"{name} tower d_out={d_out} != dim_per_modality="
                    f"{cfg.dim_per_modality}; for siglip towers note "
                    "d_out == d_model (no output projection)"
                )
        if cfg.aggregation not in ("concat", "mean", "sum"):
            raise ValueError(f"aggregation {cfg.aggregation!r}")
        if attn not in ATTN_ROUTES or mlp not in MLP_ROUTES:
            raise ValueError(f"unknown tower route attn={attn!r}, mlp={mlp!r}")
        given = dict(attn=attn, mlp=mlp, device=dev)

        def build(tower_cfg):
            cls, takes = TOWERS[type(tower_cfg)]
            return cls(tower_cfg, **{k: given[k] for k in takes})

        self.vision = build(vc)
        self.joint = isinstance(vc, JOINT)
        self.normalize_images = NORMALIZERS[type(vc)](cfg.encoder_type, vc)
        self.text = build(tc)
        # Vision first, then text, from one host generator; a tower made on
        # the device draws from a generator there, seeded alike.
        gen = torch.Generator().manual_seed(seed)
        for tower in (self.vision, self.text):
            tower.init_weights_(torch.Generator(device=dev).manual_seed(seed)
                                if getattr(tower, "made_on_device", False) else gen)
        self.to(dev)
        for name, p in self.named_parameters():
            p.requires_grad_(self.has_trainable_heads and name.startswith(TRAINABLE_HEADS))
        self.eval()

    @property
    def has_trainable_heads(self) -> bool:
        """The pair's ``trainable_heads``: ResNet-18 and MiniLM or DeepSeek-V2
        train their fresh heads; CLIP and SigLIP are wholly frozen."""
        return self.cfg.pair.trainable_heads

    @property
    def device(self) -> torch.device:
        return self.text.proj.weight.device

    @property
    def image_size(self) -> int:
        return self.vision.cfg.image_size

    @property
    def text_vocab_size(self) -> int:
        return self.text.cfg.vocab_size

    def _finish(self, emb: torch.Tensor) -> torch.Tensor:
        emb = emb.float()
        if self.cfg.normalize_out:
            emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
        return emb

    def _image_tokens(self, images_uint8: torch.Tensor) -> torch.Tensor:
        """A joint pair's image tokens in the decoder's width: the
        normaliser and MoonViT inside the span ``outfitx.vision``, the merge
        and the projector inside ``outfitx.project``."""
        with trace.span("outfitx.vision"):
            states = self.vision.features(self.normalize_images(images_uint8))
        with trace.span("outfitx.project"):
            return self.vision.project(states)

    def _joint(self, images_uint8=None, input_ids=None, attention_mask=None):
        """One decoder pass over [image tokens; title] -> (image half
        through ``vision.fc``, title half through ``text.proj``), None for a
        part not given."""
        tokens = None if images_uint8 is None else self._image_tokens(images_uint8)
        img, txt = self.text.pooled(tokens, input_ids, attention_mask)
        return (None if img is None else self.vision.head(img),
                None if txt is None else dense(txt, self.text.proj.weight, self.text.proj.bias))

    def encode_images(self, images_uint8: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) uint8 -> (B, d) float32 image embeddings, inside the
        span ``outfitx.vision`` (a joint pair: the decoder over the image
        tokens alone)."""
        if self.joint:
            return self._finish(self._joint(images_uint8)[0])
        with trace.span("outfitx.vision"):
            return self._finish(self.vision(self.normalize_images(images_uint8)))

    def encode_texts(
        self, input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, T) token ids -> (B, d) float32 text embeddings. MiniLM and
        DeepSeek-V2 pool over ``attention_mask`` and take all-ones where none
        is given (a joint pair: the decoder over the title alone)."""
        return self._finish(self.text(input_ids, attention_mask))

    def aggregate(self, image_emb: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
        return aggregate_embeddings(image_emb, text_emb, self.cfg.aggregation)

    def encode(
        self, images_uint8: torch.Tensor, input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The full per-item embedding (B, d_embed), float32; a joint pair
        in one decoder pass an item."""
        if self.joint:
            img, txt = self._joint(images_uint8, input_ids, attention_mask)
            return self.aggregate(self._finish(img), self._finish(txt))
        img = self.encode_images(images_uint8)
        txt = self.encode_texts(input_ids, attention_mask)
        return self.aggregate(img, txt)
