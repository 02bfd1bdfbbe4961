"""Model and training configuration (copy of ``outfitx_tpu/core/config.py``'s
dataclasses, with the same defaults).

Here: the item-encoder pairs (``ENCODER_PAIRS``: each pair's widths,
published names, image statistics, trainable heads and tokenizer rule), the
item encoder (which fixes the embedding width), the set transformer, the
top-level ``OutfitXConfig``, the optimizer, the CP, CIR and FITB training
configs, the precompute sweep's config and ``MeshConfig``, the training
configs' ``mesh`` layout. ``remat`` and
``remat_policy`` recompute the encoder layers' activations in the backward
(``models/outfit_transformer.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

REMAT_POLICIES = ("full", "masks", "dots")


@dataclasses.dataclass(frozen=True)
class EncoderPair:
    """One item-encoder pair's facts: its width per modality, the published
    towers it names, the image statistics of the image tower's checkpoint
    (``(x / 255 - mean) / std``), whether its fresh heads train
    (``models/item_encoder.py TRAINABLE_HEADS``), and whether its text tower
    reads texts only through its published tokenizer (without its files a
    trainer raises, naming them). Its towers are ``models/item_encoder.py
    PAIR_TOWERS``."""

    dim_per_modality: int
    image_model_name: str
    text_model_name: str
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    trainable_heads: bool = False
    published_tokenizer: bool = False


_IMAGENET = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
_SIGLIP = "Marqo/marqo-fashionSigLIP"
_CLIP = "patrickjohncyh/fashion-clip"
_KIMIVL = "moonshotai/Kimi-VL-A3B-Instruct"

# Every pair by its ``encoder_type``, in the order the CLI lists them.
ENCODER_PAIRS: Dict[str, EncoderPair] = {
    "siglip": EncoderPair(768, _SIGLIP, _SIGLIP, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
    "clip": EncoderPair(512, _CLIP, _CLIP, mean=(0.48145466, 0.4578275, 0.40821073),
                        std=(0.26862954, 0.26130258, 0.27577711)),
    "resnet_sbert": EncoderPair(64, "resnet18", "sentence-transformers/all-MiniLM-L6-v2",
                                **_IMAGENET, trainable_heads=True),
    "resnet_dsv2lite": EncoderPair(64, "resnet18", "deepseek-ai/DeepSeek-V2-Lite", **_IMAGENET,
                                   trainable_heads=True, published_tokenizer=True),
    "kimivl_a3b": EncoderPair(64, _KIMIVL, _KIMIVL, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                              trainable_heads=True, published_tokenizer=True),
}


@dataclasses.dataclass(frozen=True)
class ItemEncoderConfig:
    """Cross-modal item encoder: ``encoder_type`` names the frozen tower
    pair, a key of ``ENCODER_PAIRS``."""

    encoder_type: str = "siglip"  # a key of ENCODER_PAIRS
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

    @property
    def pair(self) -> EncoderPair:
        """The row of ``ENCODER_PAIRS`` that ``encoder_type`` names."""
        return ENCODER_PAIRS[self.encoder_type]

    @classmethod
    def for_type(cls, encoder_type: str) -> "ItemEncoderConfig":
        """The pair's row of ``ENCODER_PAIRS``, at the other fields' defaults."""
        row = ENCODER_PAIRS[encoder_type]
        return cls(encoder_type=encoder_type, dim_per_modality=row.dim_per_modality,
                   image_model_name=row.image_model_name, text_model_name=row.text_model_name)


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
    # Checkpoint each encoder layer in training: keep only its input and
    # recompute the rest in the backward.
    remat: bool = False
    # What a recomputed layer keeps from its forward when remat is on:
    #   'full'  - nothing (the least memory);
    #   'masks' - the dropout masks' random draws, which are not drawn again;
    #   'dots'  - the outputs of its matrix products.
    remat_policy: str = "full"

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be one of {REMAT_POLICIES}, got {self.remat_policy!r}"
            )

    @property
    def d_embed(self) -> int:
        return self.item_encoder.d_embed

    @property
    def model_name(self) -> str:
        # Same name as the JAX package: checkpoint directories are shared.
        return f"outfitx-tpu-{self.item_encoder.encoder_type}-d{self.d_embed}"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device-mesh layout for training: one process per position.

    ``data`` is the batch axis (DP); ``model`` is the tensor-parallel axis
    over which attention heads and FFN hidden units split Megatron-style.
    ``fsdp`` additionally splits the four layer matrices over the data axis
    (ZeRO-3): each layer all-gathers them before use and reduce-scatters
    their gradients."""

    data: int = -1  # -1: every remaining process
    model: int = 1
    fsdp: bool = False

    def resolve(self, n_devices: int) -> Tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else max(1, n_devices // model)
        return data, model


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
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    dataset_dir: str = "datasets/polyvore"
    polyvore_type: str = "nondisjoint"  # {'nondisjoint', 'disjoint'}
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    # >0: save a rolling 'latest' checkpoint (params + optimizer state +
    # epoch) every N epochs, for resume('latest').
    save_every_epochs: int = 0
    # Mid-run saves (best-metric, rolling latest) copy the state to the host
    # on the training loop and leave the file writes to a writer thread
    # (train/checkpoint.py save_async); the final save and every restore
    # wait for the queue first. False makes every save synchronous.
    async_saves: bool = True
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
    """Fill-in-the-blank evaluation (test only)."""

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
