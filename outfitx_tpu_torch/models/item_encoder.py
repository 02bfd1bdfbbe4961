"""The cross-modal item encoder: frozen vision and text towers with fusion.

The port of ``outfitx_tpu/models/item_encoder.py``: the tower pair named by
``cfg.encoder_type`` (CLIP, SigLIP, or ResNet-18 with MiniLM for
``resnet_sbert``) encodes both modalities, each embedding is optionally
L2-normalised, and the two are aggregated (concat, mean or sum). The towers
are frozen: CLIP and SigLIP take no gradient at all, and ``resnet_sbert``
only in its two fresh heads, ResNet's ``fc`` and MiniLM's ``proj`` (the JAX
encoder's ``has_trainable_heads``). Outputs are float32; with concat fusion
the text half is ``emb[d // 2:]``, which the datasets rely on.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from outfitx_tpu_torch.core.config import ItemEncoderConfig
from outfitx_tpu_torch.core.device import resolve_device
from outfitx_tpu_torch.data.preprocess import make_normalizer
from outfitx_tpu_torch.models.towers import (
    TextTower,
    TextTowerConfig,
    VisionTower,
    VisionTowerConfig,
)
from outfitx_tpu_torch.models.towers.common import ATTN_ROUTES, MLP_ROUTES
from outfitx_tpu_torch.models.towers.minilm import MiniLM, MiniLMConfig
from outfitx_tpu_torch.models.towers.resnet import ResNet18, ResNet18Config
from outfitx_tpu_torch.utils import aggregate_embeddings

# The fresh heads of resnet_sbert, the only parameters that take a gradient.
TRAINABLE_HEADS = ("vision.fc.", "text.proj.")


def tower_configs(cfg: ItemEncoderConfig):
    if cfg.encoder_type == "clip":
        return VisionTowerConfig.clip_b32(), TextTowerConfig.clip_b()
    if cfg.encoder_type == "siglip":
        return VisionTowerConfig.siglip_b16(), TextTowerConfig.siglip_b()
    if cfg.encoder_type == "resnet_sbert":
        return (
            ResNet18Config(d_out=cfg.dim_per_modality),
            MiniLMConfig(d_out=cfg.dim_per_modality),
        )
    raise NotImplementedError(f"encoder_type {cfg.encoder_type!r} has no towers")


class ItemEncoderModel(nn.Module):
    """Weights are random, drawn from ``seed`` with the JAX towers'
    distributions (not their numbers), until a state dict is loaded (see
    ``models/from_jax.py item_encoder_state_dict_from_jax`` and
    ``models/pretrained.py``). ``attn`` and ``mlp`` choose the CLIP and
    SigLIP towers' formulations (``towers/common.py``); ResNet-18 and MiniLM
    have one formulation each and take neither."""

    def __init__(
        self,
        cfg: Optional[ItemEncoderConfig] = None,
        *,
        vision_cfg: Optional[VisionTowerConfig | ResNet18Config] = None,
        text_cfg: Optional[TextTowerConfig | MiniLMConfig] = None,
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
        if cfg.encoder_type == "resnet_sbert":
            if attn not in ATTN_ROUTES or mlp not in MLP_ROUTES:
                raise ValueError(f"unknown tower route attn={attn!r}, mlp={mlp!r}")
            self.vision = ResNet18(vc)
            self.text = MiniLM(tc)
        else:
            self.vision = VisionTower(vc, attn=attn, mlp=mlp)
            self.text = TextTower(tc, attn=attn, mlp=mlp)
        self.normalize_images = make_normalizer(cfg.encoder_type)
        gen = torch.Generator().manual_seed(seed)
        self.vision.init_weights_(gen)
        self.text.init_weights_(gen)
        self.to(dev)
        for name, p in self.named_parameters():
            p.requires_grad_(self.has_trainable_heads and name.startswith(TRAINABLE_HEADS))
        self.eval()

    @property
    def has_trainable_heads(self) -> bool:
        """resnet_sbert trains its fresh heads; CLIP and SigLIP are wholly
        frozen."""
        return self.cfg.encoder_type == "resnet_sbert"

    @property
    def device(self) -> torch.device:
        return self.text.pos_emb.device

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

    def encode_images(self, images_uint8: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) uint8 -> (B, d) float32 image embeddings."""
        return self._finish(self.vision(self.normalize_images(images_uint8)))

    def encode_texts(
        self, input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, T) token ids -> (B, d) float32 text embeddings. MiniLM pools
        over ``attention_mask`` and takes all-ones where none is given."""
        if self.cfg.encoder_type == "resnet_sbert" and attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        return self._finish(self.text(input_ids, attention_mask))

    def aggregate(self, image_emb: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
        return aggregate_embeddings(image_emb, text_emb, self.cfg.aggregation)

    def encode(
        self, images_uint8: torch.Tensor, input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The full per-item embedding (B, d_embed), float32."""
        img = self.encode_images(images_uint8)
        txt = self.encode_texts(input_ids, attention_mask)
        return self.aggregate(img, txt)
