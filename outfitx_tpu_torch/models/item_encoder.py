"""The cross-modal item encoder: frozen vision and text towers with fusion.

The port of ``outfitx_tpu/models/item_encoder.py``: the tower pair named by
``cfg.encoder_type`` encodes both modalities, each embedding is optionally
L2-normalised, and the two are aggregated (concat, mean or sum). The towers
are frozen: no parameter takes a gradient and every method runs under
``torch.no_grad()``. Outputs are float32; with concat fusion the text half
is ``emb[d // 2:]``, which the datasets rely on.
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


def tower_configs(cfg: ItemEncoderConfig):
    if cfg.encoder_type == "clip":
        return VisionTowerConfig.clip_b32(), TextTowerConfig.clip_b()
    if cfg.encoder_type == "siglip":
        return VisionTowerConfig.siglip_b16(), TextTowerConfig.siglip_b()
    raise NotImplementedError(
        f"encoder_type {cfg.encoder_type!r} has no tower in this package yet"
    )


class ItemEncoderModel(nn.Module):
    """Weights are random, drawn from ``seed`` with the JAX towers'
    distributions (not their numbers), until a state dict is loaded (see
    ``models/from_jax.py item_encoder_state_dict_from_jax``). ``attn`` and
    ``mlp`` choose the towers' formulations (``towers/common.py``)."""

    def __init__(
        self,
        cfg: Optional[ItemEncoderConfig] = None,
        *,
        vision_cfg: Optional[VisionTowerConfig] = None,
        text_cfg: Optional[TextTowerConfig] = None,
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
        self.vision = VisionTower(vc, attn=attn, mlp=mlp)
        self.text = TextTower(tc, attn=attn, mlp=mlp)
        self.normalize_images = make_normalizer(cfg.encoder_type)
        gen = torch.Generator().manual_seed(seed)
        self.vision.init_weights_(gen)
        self.text.init_weights_(gen)
        self.to(dev)
        self.requires_grad_(False)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.text.tok_emb.device

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

    @torch.no_grad()
    def encode_images(self, images_uint8: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) uint8 -> (B, d) float32 image embeddings."""
        return self._finish(self.vision(self.normalize_images(images_uint8)))

    @torch.no_grad()
    def encode_texts(
        self, input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return self._finish(self.text(input_ids, attention_mask))

    def aggregate(self, image_emb: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
        agg = self.cfg.aggregation
        if agg == "concat":
            return torch.cat([image_emb, text_emb], dim=-1)
        if agg == "mean":
            return 0.5 * (image_emb + text_emb)
        return image_emb + text_emb

    @torch.no_grad()
    def encode(
        self, images_uint8: torch.Tensor, input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The full per-item embedding (B, d_embed), float32."""
        img = self.encode_images(images_uint8)
        txt = self.encode_texts(input_ids, attention_mask)
        return self.aggregate(img, txt)
