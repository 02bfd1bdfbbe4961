"""Model configuration (copy of ``outfitx_tpu/core/config.py``'s model
dataclasses, with the same defaults).

Only the serving model's configs are here: the item encoder (which fixes the
embedding width), the set transformer and the top-level ``OutfitXConfig``.
The training, mesh and precompute configs come with the slices that port
those paths.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ItemEncoderConfig:
    """Cross-modal item encoder: ``encoder_type`` names the frozen tower
    pair ('clip' 512/modality, 'resnet_sbert' 64, 'siglip' 768)."""

    encoder_type: str = "siglip"  # {'clip', 'resnet_sbert', 'siglip'}
    aggregation: str = "concat"  # {'concat', 'mean', 'sum'}
    normalize_out: bool = True  # L2-normalize each modality's embedding
    dim_per_modality: int = 768  # 512 clip / 64 resnet_sbert / 768 siglip
    image_model_name: str = "Marqo/marqo-fashionSigLIP"
    text_model_name: str = "Marqo/marqo-fashionSigLIP"
    text_max_length: int = 64

    @property
    def d_embed(self) -> int:
        """Fused per-item embedding width (concat doubles the modality dim)."""
        if self.aggregation == "concat":
            return self.dim_per_modality * 2
        return self.dim_per_modality

    @classmethod
    def for_type(cls, encoder_type: str) -> "ItemEncoderConfig":
        dims = {"clip": 512, "resnet_sbert": 64, "siglip": 768}
        names = {
            "clip": ("patrickjohncyh/fashion-clip",) * 2,
            "resnet_sbert": (
                "resnet18",
                "sentence-transformers/all-MiniLM-L6-v2",
            ),
            "siglip": ("Marqo/marqo-fashionSigLIP",) * 2,
        }
        img, txt = names[encoder_type]
        return cls(
            encoder_type=encoder_type,
            dim_per_modality=dims[encoder_type],
            image_model_name=img,
            text_model_name=txt,
        )


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Set-transformer encoder over the outfit sequence: 16 heads, d_ffn
    2024, 6 pre-LN layers, mish, no final LayerNorm. ``dropout`` is kept for
    checkpoint and config compatibility; this package runs eval only."""

    n_heads: int = 16
    d_ffn: int = 2024
    n_layers: int = 6
    dropout: float = 0.3
    activation: str = "mish"  # {'mish', 'relu', 'gelu'}
    norm_first: bool = True  # False = post-LN residual placement
    final_norm: bool = False  # True adds a terminal LN after the stack
    # Apply-time zero pad of the FFN hidden width in the JAX package (a TPU
    # tile-alignment choice). Numerically inert, so the port accepts it and
    # computes at d_ffn (models/outfit_transformer.py).
    ffn_pad_to: int = 2048


@dataclasses.dataclass(frozen=True)
class OutfitXConfig:
    """Top-level model config."""

    item_encoder: ItemEncoderConfig = dataclasses.field(
        default_factory=ItemEncoderConfig
    )
    transformer: TransformerConfig = dataclasses.field(
        default_factory=TransformerConfig
    )
    max_outfit_len: int = 16  # items per outfit after pad/truncate
    # Parameters are stored in float32; the forward runs in bfloat16.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def d_embed(self) -> int:
        return self.item_encoder.d_embed

    @property
    def model_name(self) -> str:
        # Same name as the JAX package: checkpoint directories are shared.
        return f"outfitx-tpu-{self.item_encoder.encoder_type}-d{self.d_embed}"
