"""The OutfitX set transformer with its CP head, the focal loss and the
dropout draws, in plain float32 PyTorch.

The model (Krual-T/OutfitX, after OutfitTransformer, arXiv:2204.04812):
a learned prefix token (the CP outfit token) before the outfit's item
embeddings; pre-LN encoder layers (LayerNorm eps 1e-5) of multi-head
self-attention with a key-padding mask (the prefix is never masked) and an
FFN with mish; no final LayerNorm. The CP logit is a linear map of the
prefix's final state.

Dropout in training sits after the attention's out-projection, after the
FFN's activation and after the FFN's output (each before its residual
add), and on the CP head's input. Its masks are worked out again from the
seed: a fresh ``torch.Generator`` on the device for each step and
microbatch, seeded from (seed, step, microbatch) through numpy's
SeedSequence, drawing uint8 bits in the forward's order and keeping
``bits < round(256 (1 - rate))``, scaled by the kept share. Those are the
training job's stated draws: with them the reference's step is the
program's step, not merely one like it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from outfitbench.reference.numerics import fp8, matmul

NEG = -1e9


def stream_seed(*words: int) -> int:
    """A 63-bit seed from integer words (base seed, step, microbatch)."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(2)
    return (int(state[0]) << 31 | int(state[1])) & ((1 << 63) - 1)


class Dropout:
    """Inverted dropout replaying a generator's uint8 draws; identity at
    rate 0 or without a generator."""

    def __init__(self, rate: float, gen: Optional[torch.Generator]):
        self.rate = rate if gen is not None else 0.0
        self.gen = gen

    def __call__(self, x):
        if self.rate == 0.0:
            return x
        t = int(round((1.0 - self.rate) * 256))
        if 0 < t < 256:
            bits = torch.randint(0, 256, tuple(x.shape), dtype=torch.uint8,
                                 generator=self.gen, device=x.device)
            keep, q = bits < t, t / 256.0
        else:
            keep = torch.rand(tuple(x.shape), generator=self.gen, device=x.device) < 1.0 - self.rate
            q = 1.0 - self.rate
        return torch.where(keep, x / q, torch.zeros_like(x))


def layer_norm(x, w, b, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * w + b


def mish(x):
    return x * torch.tanh(torch.nn.functional.softplus(x))


def linear(x, w, b=None, low: bool = False):
    y = matmul(x, w.T, low)
    return y if b is None else y + b


def attention(q, k, v, pad, low: bool = False):
    """(B, H, S, Dh) each, pad (B, S) True = pad key."""
    s = matmul(q, k.transpose(-1, -2), low) / math.sqrt(q.shape[-1])
    s = s.masked_fill(pad[:, None, None, :], NEG)
    return matmul(torch.softmax(s, dim=-1), v, low)


def encode(p: Dict[str, torch.Tensor], x, pad, cfg: Dict, drop: Dropout, low: bool = False):
    """The encoder stack over (B, S, D) tokens; states (B, S, D). ``low``
    computes in float8 wherever the configuration computes in its compute
    dtype: the products, and the activations between them (the residual
    stream, the LayerNorms' and the FFN's outputs)."""
    b, s, d = x.shape
    h = cfg["n_heads"]
    r = fp8 if low else (lambda t: t)
    x = r(x)
    for i in range(cfg["n_layers"]):
        pre = f"transformer_encoder.layers.{i}."
        y = r(layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"]))
        qkv = linear(y, p[pre + "self_attn.in_proj_weight"], p[pre + "self_attn.in_proj_bias"], low)
        q, k, v = qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4)
        o = attention(q, k, v, pad, low).transpose(1, 2).reshape(b, s, d)
        o = linear(o, p[pre + "self_attn.out_proj.weight"], p[pre + "self_attn.out_proj.bias"], low)
        x = r(x + drop(o))
        y = r(layer_norm(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"]))
        hidden = drop(r(mish(linear(y, p[pre + "linear1.weight"], p[pre + "linear1.bias"], low))))
        out = linear(hidden, p[pre + "linear2.weight"], None, low) + p[pre + "linear2.bias"]
        x = r(x + drop(out))
    return x


def _with_prefix(p, prefix, emb, mask, cfg, drop, low):
    b = emb.shape[0]
    x = torch.cat([prefix, emb], dim=1)
    pad = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=mask.device), mask], dim=1)
    return encode(p, x, pad, cfg, drop, low)


def cp_logits(p, emb, mask, cfg: Dict, drop: Optional[Dropout] = None, low: bool = False):
    """CP logits (B,) of outfits emb (B, L, D), mask (B, L) True = pad."""
    drop = drop or Dropout(0.0, None)
    b = emb.shape[0]
    tok = p["outfit_token"][None, None, :].expand(b, 1, -1)
    states = _with_prefix(p, tok, emb, mask, cfg, drop, low)
    return linear(drop(states[:, 0]), p["cp_ffn.1.weight"], p["cp_ffn.1.bias"], low)[:, 0]


def focal_loss(logits, labels, alpha: float = 0.75, gamma: float = 2.0, reduction: str = "mean"):
    """Binary focal loss on logits (Lin et al., 2017)."""
    ce = torch.nn.functional.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    p = torch.sigmoid(logits)
    p_t = p * labels + (1 - p) * (1 - labels)
    loss = (alpha * labels + (1 - alpha) * (1 - labels)) * ce * (1 - p_t) ** gamma
    return loss.sum() if reduction == "sum" else loss.mean()
