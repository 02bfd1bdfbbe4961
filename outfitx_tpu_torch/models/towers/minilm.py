"""The MiniLM text tower of the ``resnet_sbert`` item encoder.

The port of ``outfitx_tpu/models/towers/minilm.py``:
sentence-transformers/all-MiniLM-L6-v2, a post-LN BERT (vocabulary 30522,
d = 384, 12 heads of 32, MLP 1536, 6 layers, LayerNorm eps 1e-12), frozen,
mean-pooled over the real tokens and projected by a fresh trainable
``proj`` to ``d_out``.

Word, position and type-0 embeddings are summed in float32 and cast to the
compute dtype, then LayerNormed. Each layer: separate Q, K and V products,
``masked_mha`` with keys masked where ``attention_mask == 0`` (the
hand-written kernel on the card: L = 64, Dh = 32 at the precompute sweep),
the out-projection, add and LayerNorm; then two products with the erf gelu
between them, add and LayerNorm. Products round to the compute dtype before
their bias is added, as the JAX ``linear``. Mean pooling runs in the
compute dtype. The tower has one formulation: the JAX tower reads neither
of the CLIP/SigLIP towers' route variables, so the attention block and the
fused MLP do not apply here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from outfitx_tpu_torch.core import dtypes
from outfitx_tpu_torch.models.towers.common import (
    LayerNorm,
    as_f32,
    dense,
    init_linear_,
)
from outfitx_tpu_torch.ops.attention import masked_mha
from outfitx_tpu_torch.utils import mean_pooling


@dataclasses.dataclass(frozen=True)
class MiniLMConfig:
    vocab_size: int = 30522
    max_len: int = 512
    d_model: int = 384
    n_heads: int = 12
    d_mlp: int = 1536
    n_layers: int = 6
    d_out: int = 64  # the fresh proj head's width (dim_per_modality)
    ln_eps: float = 1e-12  # BERT's
    type_vocab_size: int = 2
    compute_dtype: str = "bfloat16"  # "float32" for parity tests


class MiniLMLayer(nn.Module):
    def __init__(self, d: int, d_mlp: int, eps: float):
        super().__init__()
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.o = nn.Linear(d, d)
        self.attn_ln = LayerNorm(d, eps)
        self.fc1 = nn.Linear(d, d_mlp)
        self.fc2 = nn.Linear(d_mlp, d)
        self.mlp_ln = LayerNorm(d, eps)

    def linears(self):
        return (self.q, self.k, self.v, self.o, self.fc1, self.fc2)

    def forward(self, x, pad_mask, n_heads: int):
        b, t, d = x.shape

        def heads(lin):
            y = dense(x, lin.weight, lin.bias)
            return y.view(b, t, n_heads, d // n_heads).transpose(1, 2).contiguous()

        o = masked_mha(heads(self.q), heads(self.k), heads(self.v), pad_mask)
        o = o.transpose(1, 2).reshape(b, t, d)
        x = self.attn_ln(x + dense(o, self.o.weight, self.o.bias))
        mid = F.gelu(dense(x, self.fc1.weight, self.fc1.bias), approximate="none")
        return self.mlp_ln(x + dense(mid, self.fc2.weight, self.fc2.bias))


class MiniLM(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.word_emb = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.pos_emb = nn.Parameter(torch.empty(cfg.max_len, d))
        self.type_emb = nn.Parameter(torch.empty(cfg.type_vocab_size, d))
        self.emb_ln = LayerNorm(d, cfg.ln_eps)
        self.layers = nn.ModuleList(
            MiniLMLayer(d, cfg.d_mlp, cfg.ln_eps) for _ in range(cfg.n_layers)
        )
        self.proj = nn.Linear(d, cfg.d_out)

    def init_weights_(self, gen: torch.Generator) -> None:
        """N(0, 0.02) embeddings, uniform(+-1/sqrt(d_in)) linears: the JAX
        tower's distributions."""
        with torch.no_grad():
            for emb in (self.word_emb, self.pos_emb, self.type_emb):
                emb.normal_(0.0, 0.02, generator=gen)
            for layer in self.layers:
                for lin in layer.linears():
                    init_linear_(lin, gen)
            init_linear_(self.proj, gen)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor
    ) -> torch.Tensor:
        """input_ids (B, T) integers, attention_mask (B, T) with 1 = real
        token -> (B, d_out) in the compute dtype."""
        cfg = self.cfg
        t = input_ids.shape[1]
        x = (
            F.embedding(input_ids, self.word_emb)
            + self.pos_emb[None, :t]
            + self.type_emb[0][None, None]
        ).to(dtypes.resolve(cfg.compute_dtype))
        x = self.emb_ln(x)
        pad_mask = (attention_mask == 0).contiguous()
        for layer in self.layers:
            x = layer(x, pad_mask, cfg.n_heads)
        pooled = mean_pooling(x, attention_mask)  # in the compute dtype
        return dense(pooled, self.proj.weight, self.proj.bias)


# HF BertModel names of one layer's pieces, by the port's names.
_LAYER_NAMES = {
    "q": "attention.self.query", "k": "attention.self.key",
    "v": "attention.self.value", "o": "attention.output.dense",
    "attn_ln": "attention.output.LayerNorm", "fc1": "intermediate.dense",
    "fc2": "output.dense", "mlp_ln": "output.LayerNorm",
}


def convert_minilm(
    sd: Dict[str, object], n_layers: int = 6, init_proj: Optional[Dict] = None
) -> Dict[str, torch.Tensor]:
    """An HF BertModel state dict (tensors or numpy arrays, no ``bert.``
    prefix) -> ``MiniLM``'s state dict in float32. ``proj`` is the
    reference's fresh head: it comes from ``init_proj`` ({'weight',
    'bias'}) and is left out without one."""
    out = {
        "word_emb": as_f32(sd["embeddings.word_embeddings.weight"]),
        "pos_emb": as_f32(sd["embeddings.position_embeddings.weight"]),
        "type_emb": as_f32(sd["embeddings.token_type_embeddings.weight"]),
        "emb_ln.weight": as_f32(sd["embeddings.LayerNorm.weight"]),
        "emb_ln.bias": as_f32(sd["embeddings.LayerNorm.bias"]),
    }
    for i in range(n_layers):
        for mine, theirs in _LAYER_NAMES.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{mine}.{leaf}"] = as_f32(
                    sd[f"encoder.layer.{i}.{theirs}.{leaf}"]
                )
    if init_proj is not None:
        out["proj.weight"] = as_f32(init_proj["weight"])
        out["proj.bias"] = as_f32(init_proj["bias"])
    return out
