"""Text towers: the CLIP text transformer (causal, pooled at the EOS token,
projected without bias) and the SigLIP text transformer (bidirectional,
pooled at the last token, projected with bias).

The port of ``outfitx_tpu/models/towers/text.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from outfitx_tpu_torch.core import dtypes
from outfitx_tpu_torch.models.towers.common import (
    LayerNorm,
    TowerEncoder,
    dense,
    init_linear_,
)


@dataclasses.dataclass(frozen=True)
class TextTowerConfig:
    variant: str = "clip"  # {'clip', 'siglip'}
    vocab_size: int = 49408
    max_len: int = 77
    d_model: int = 512
    n_heads: int = 8
    d_mlp: int = 2048
    n_layers: int = 12
    proj_dim: int = 512
    act: str = "quick_gelu"  # siglip: 'gelu_tanh'
    ln_eps: float = 1e-5  # siglip: 1e-6
    eos_token_id: int = 49407
    compute_dtype: str = "bfloat16"  # "float32" for parity tests

    @property
    def d_out(self) -> int:
        return self.proj_dim

    @classmethod
    def clip_b(cls) -> "TextTowerConfig":
        return cls()

    @classmethod
    def siglip_b(cls) -> "TextTowerConfig":
        """SigLIP-B text: 64-token context, bidirectional, gelu_tanh."""
        return cls(
            variant="siglip", vocab_size=32000, max_len=64, d_model=768,
            n_heads=12, d_mlp=3072, proj_dim=768, act="gelu_tanh",
            ln_eps=1e-6, eos_token_id=1,
        )


class TextTower(nn.Module):
    def __init__(self, cfg: TextTowerConfig, *, attn: str = "mha", mlp: str = "plain"):
        super().__init__()
        if cfg.variant not in ("clip", "siglip"):
            raise ValueError(f"unknown text tower variant {cfg.variant!r}")
        self.cfg = cfg
        d = cfg.d_model
        self.tok_emb = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.pos_emb = nn.Parameter(torch.empty(cfg.max_len, d))
        self.encoder = TowerEncoder(
            d=d, n_heads=cfg.n_heads, d_mlp=cfg.d_mlp, n_layers=cfg.n_layers,
            act=cfg.act, ln_eps=cfg.ln_eps, attn=attn, mlp=mlp,
        )
        self.final_ln = LayerNorm(d, cfg.ln_eps)
        self.proj = nn.Linear(d, cfg.proj_dim, bias=cfg.variant == "siglip")

    def init_weights_(self, gen: torch.Generator) -> None:
        """Random weights with the JAX tower's distributions."""
        with torch.no_grad():
            self.tok_emb.normal_(0.0, 0.02, generator=gen)
            self.pos_emb.normal_(0.0, 0.01, generator=gen)
            self.encoder.init_weights_(gen)
            init_linear_(self.proj, gen)

    def forward(
        self, input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """input_ids (B, T) integers, attention_mask (B, T) with 1 = real
        token -> (B, proj_dim) in the compute dtype."""
        cfg = self.cfg
        t = input_ids.shape[1]
        x = F.embedding(input_ids, self.tok_emb)
        x = x.to(dtypes.resolve(cfg.compute_dtype))
        x = x + self.pos_emb[None, :t].to(x.dtype)
        pad_mask = None if attention_mask is None else attention_mask == 0
        x = self.encoder(x, pad_mask, causal=cfg.variant == "clip")
        x = self.final_ln(x)
        if cfg.variant == "clip":
            # The first EOS token of each row, as the JAX argmax.
            eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
            pooled = x[torch.arange(x.shape[0], device=x.device), eos_pos]
        else:
            pooled = x[:, -1]
        return dense(pooled, self.proj.weight, self.proj.bias)
