"""Model and training configuration (copy of ``outfitx_tpu/core/config.py``'s
dataclasses, with the same defaults).

Here: the item encoder (which fixes the embedding width), the set
transformer, the top-level ``OutfitXConfig``, the optimizer, the CP, CIR
and FITB training configs and the precompute sweep's config. ``MeshConfig``
and the training configs' ``mesh`` field wait for the parallelism slice: the
trainers run on one card. The JAX package's ``remat`` options are not ported
(an 80 GB card holds the activations at the training envelope), nor
``async_saves`` (saves are synchronous).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
    2024, 6 pre-LN layers, dropout 0.3 (in train mode), mish, no final
    LayerNorm."""

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


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + OneCycle + global-norm clip, as the reference envelope."""

    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    clip_norm: float = 1.0
    # OneCycle: cosine up from lr/div_factor over pct_start of the horizon,
    # then cosine down to lr/(div_factor*final_div_factor).
    schedule: str = "onecycle"  # {'onecycle', 'constant'}
    pct_start: float = 0.3
    div_factor: float = 25.0
    final_div_factor: float = 1e4


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Base training configuration."""

    seed: int = 42
    n_epochs: int = 200
    batch_size: int = 3072  # batch per microbatch
    accumulation_steps: int = 4  # microbatches per optimizer step
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    dataset_dir: str = "datasets/polyvore"
    polyvore_type: str = "nondisjoint"  # {'nondisjoint', 'disjoint'}
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    # >0: save a rolling 'latest' checkpoint (params + optimizer state +
    # epoch) every N epochs, for resume('latest').
    save_every_epochs: int = 0
    log_every_steps: int = 0  # >0: per-step train loss to the metrics JSONL


@dataclasses.dataclass(frozen=True)
class CPTrainConfig(TrainConfig):
    """Compatibility-prediction training."""

    focal_alpha: float = 0.75
    focal_gamma: float = 2.0


@dataclasses.dataclass(frozen=True)
class CIRTrainConfig(TrainConfig):
    """Complementary-item-retrieval training."""

    n_epochs: int = 300
    batch_size: int = 512
    accumulation_steps: int = 1
    margin: float = 2.0
    n_negatives: int = 10
    switch_to_hard_epoch: int = 150  # curriculum: easy -> hard negatives
    recall_every: int = 5
    recall_ks: Tuple[int, ...] = (1, 5, 10, 15, 30, 50)
    candidate_pool_size: int = 3000
    warm_start_from: Optional[str] = None  # path to a CP checkpoint


@dataclasses.dataclass(frozen=True)
class FITBTrainConfig(TrainConfig):
    """Fill-in-the-blank evaluation (test only; its trainer comes with a
    later slice)."""

    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(learning_rate=4e-5)
    )
    n_candidates: int = 4
    checkpoint_from: Optional[str] = None  # path to a CIR checkpoint


@dataclasses.dataclass(frozen=True)
class PrecomputeConfig(TrainConfig):
    """Catalog embedding-precompute sweep (batch 2048)."""

    batch_size: int = 2048
    shard_prefix: str = "embedding_subset_"
