"""DeepSeek-V2-Lite as the frozen text tower of the ``resnet_dsv2lite`` item
encoder, and the same layout as the decoder of the ``kimivl_a3b`` joint
encoder (Kimi-VL-A3B's Moonlight decoder, DeepSeek-V3's layout).

The architecture of deepseek-ai/DeepSeek-V2-Lite's ``config.json`` (no TPU
counterpart: the JAX package has no such tower): an embedding of 102,400 x
2,048 (the LM head is not used), then 27 pre-norm layers,
``h = x + MLA(RMSNorm(x)); x = h + FFN(RMSNorm(h))``, RMSNorm a weight
only with eps 1e-6, no projection with a bias; the final RMSNorm, a mean
over the item's real tokens, and a fresh trainable ``proj`` to ``d_out``.

- **MLA** (``q_lora_rank`` null): q = x W_q, 16 heads of 192 (128 without
  position, 64 rotary); x W_kva = [c_kv (512), k_pe (64)], one k_pe shared
  by every head; RMSNorm(c_kv) W_kvb = 16 x [k_nope (128), v (128)]. RoPE
  on q_pe and k_pe; Q = [q_nope, q_pe], K = [k_nope, k_pe]; attention
  causal with key padding through ``masked_mha``'s split route (Dqk 192,
  Dv 128), S scaled by 192^-0.5 mscale(40, 0.707)^2; W_o.
- **YaRN RoPE** (rotary dim 64, base 10,000, factor 40, 4,096 original
  positions, beta_fast 32, beta_slow 1): ``yarn_inv_freq``; cos and sin
  scaled by mscale(40, 0.707) / mscale(40, 0.707) = 1. The rotary columns
  use the rotate-half layout (pair i is columns i and i + 32). The
  published checkpoint interleaves them (pair i is columns 2i and 2i + 1):
  a loader permutes W_q's rope rows of each head and W_kva's last 64 rows
  so that new row i = old row 2i and new row 32 + i = old row 2i + 1.
- **FFN**: layer 0 a SwiGLU of 10,944, ``down(silu(gate x) * up x)``;
  layers 1-26 the mixture (``ops/moe.py``): softmax over 64 router logits
  in float32, greedy top-6, weights unnormalised and scaled by 1, the six
  experts (SwiGLU of 1,408) weighted and summed, plus the two shared
  experts as one SwiGLU of 2,816. No token is dropped. A SwiGLU keeps gate
  and up stacked in one weight, gate's rows first: a loader stacks the
  checkpoint's gate_proj and up_proj.

The tower is frozen and its weights are the published checkpoint's dtype,
bfloat16: 31 GB at these widths. They are made and drawn on the tower's
device (``init_weights_`` with a generator on that device), never on the
host or in float32; a state dict loads in place, a tensor at a time. The
residual stream is bfloat16; each RMSNorm, the rotary product and the
mixture's combine run in float32 and round once. Only ``proj`` trains; it
is float32, as the other towers' heads.

Kimi-VL-A3B's decoder (moonshotai/Kimi-VL-A3B-Instruct's ``text_config``)
differs by numbers and by two switches of the config: ``scoring``
"sigmoid" (the mixture's router is ``moe.route_sigmoid``: experts by
sigmoid score plus a float32 correction bias ``e_score_correction_bias``,
weighted by the score alone, normalised, times 2.446) and ``rope_factor``
1 (``rope_scaling`` null: plain RoPE at base 800,000, S scaled by
192^-0.5). Widths there: a dense SwiGLU of 11,264, vocabulary 163,840,
RMSNorm eps 1e-5. A joint pair hands ``features`` its image tokens as a
``prefix`` ahead of the title's embeddings, one causal pass over both, and
``pooled`` means the two position ranges apart.

Spans (``core/trace.py``): ``outfitx.mla`` around each layer's attention
block, ``outfitx.moe`` around each mixture, with ``outfitx.route`` (the
router and the permutation, and apart the un-permutation) and
``outfitx.experts`` (the grouped products and SwiGLU) inside; the counter
``outfitx.expert_tokens`` holds each mixture's tokens per expert, kept on
the device while a profiler records.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from outfitx_tpu_torch.core import dtypes, trace
from outfitx_tpu_torch.models.towers.common import dense, init_linear_
from outfitx_tpu_torch.ops import moe
from outfitx_tpu_torch.ops.attention import masked_mha
from outfitx_tpu_torch.utils import mean_pooling


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    max_len: int = 163840  # max_position_embeddings
    d_model: int = 2048
    n_layers: int = 27
    n_heads: int = 16
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    kv_lora_rank: int = 512
    d_ffn: int = 10944  # the dense layers' SwiGLU
    d_expert: int = 1408  # each routed expert's SwiGLU
    n_experts: int = 64
    top_k: int = 6
    n_shared: int = 2  # shared experts, one SwiGLU of n_shared * d_expert
    first_dense: int = 1  # leading dense layers
    routed_scaling: float = 1.0
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    init_std: float = 0.02
    d_out: int = 64  # the fresh proj head's width (dim_per_modality)
    compute_dtype: str = "bfloat16"  # the frozen weights' and the compute's
    # The mixture's router: "softmax" (greedy top-k of the softmax, weights
    # unnormalised) or "sigmoid" (top-k of sigmoid + correction bias, the
    # weights normalised); ``routed_scaling`` multiplies either's weights.
    scoring: str = "softmax"

    def __post_init__(self):
        if self.scoring not in ROUTERS:
            raise ValueError(f"scoring must be one of {ROUTERS}, got {self.scoring!r}")

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


ROUTERS = ("softmax", "sigmoid")


def yarn_mscale(scale: float, m: float) -> float:
    return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """qk_dim^-0.5 times mscale(factor, mscale_all_dim)^2."""
    return cfg.qk_dim ** -0.5 * yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim) ** 2


def yarn_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """(rope_dim / 2,) float32: base^(-2i/dim) where the ramp's mask is 1,
    a factor-th of it where 0, between the two on the ramp from floor(d(beta_fast))
    to ceil(d(beta_slow)), d(r) = dim ln(original / (2 pi r)) / (2 ln base).
    A factor of 1 (``rope_scaling`` null) leaves base^(-2i/dim): plain RoPE."""
    dim, base = cfg.qk_rope_dim, cfg.rope_theta

    def corr(r):
        return dim * math.log(cfg.rope_original_max / (2 * math.pi * r)) / (2 * math.log(base))

    low = max(math.floor(corr(cfg.beta_fast)), 0)
    high = min(math.ceil(corr(cfg.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return (extra / cfg.rope_factor * (1.0 - mask) + extra * mask).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in float32 over the last axis of x (..., T, dim)
    with cos, sin (T, dim); the result in x's dtype."""
    xf = x.float()
    half = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = _param((d,), dtype, device)

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


class SwiGLU(nn.Module):
    """down(silu(gate x) * up x), gate and up stacked in ``gate_up``."""

    def __init__(self, d: int, width: int, dtype, device):
        super().__init__()
        self.width = width
        self.gate_up = _param((2 * width, d), dtype, device)
        self.down = _param((d, width), dtype, device)

    def forward(self, x):
        g, u = F.linear(x, self.gate_up).split(self.width, dim=-1)
        return F.linear(F.silu(g) * u, self.down)


class MLA(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        self.q = _param((h * cfg.qk_dim, d), dtype, device)
        self.kv_a = _param((cfg.kv_lora_rank + cfg.qk_rope_dim, d), dtype, device)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, cfg.rms_eps, dtype, device)
        self.kv_b = _param((h * (cfg.qk_nope_dim + cfg.v_dim), cfg.kv_lora_rank), dtype, device)
        self.o = _param((d, h * cfg.v_dim), dtype, device)
        self.scale = softmax_scale(cfg)

    def forward(self, x, pad_mask, cos, sin):
        """x (N, T, d), pad_mask (N, T) True = pad -> (N, T, d)."""
        cfg = self.cfg
        n, t, _ = x.shape
        h, nope, rd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
        q = F.linear(x, self.q).view(n, t, h, cfg.qk_dim)
        c_kv, k_pe = F.linear(x, self.kv_a).split([cfg.kv_lora_rank, rd], dim=-1)
        kv = F.linear(self.kv_norm(c_kv), self.kv_b).view(n, t, h, nope + cfg.v_dim)
        k_nope, v = kv.split([nope, cfg.v_dim], dim=-1)
        q_pe = rope(q[..., nope:].transpose(1, 2), cos, sin)  # (N, H, T, rd)
        k_pe = rope(k_pe[:, None], cos, sin).expand(n, h, t, rd)
        qh = torch.cat([q[..., :nope].transpose(1, 2), q_pe], dim=-1).contiguous()
        kh = torch.cat([k_nope.transpose(1, 2), k_pe], dim=-1).contiguous()
        o = masked_mha(qh, kh, v.transpose(1, 2).contiguous(), pad_mask, causal=True,
                       scale=self.scale)
        return F.linear(o.transpose(1, 2).reshape(n, t, h * cfg.v_dim), self.o)


class Router(nn.Module):
    """The mixture's gate over a weight (E, d): ``moe.route``, or with
    ``scoring`` "sigmoid" ``moe.route_sigmoid`` with its float32
    correction bias (E,)."""

    def __init__(self, cfg: DeepseekV2Config, dtype, device):
        super().__init__()
        self.top_k, self.scaling, self.scoring = cfg.top_k, cfg.routed_scaling, cfg.scoring
        self.weight = _param((cfg.n_experts, cfg.d_model), dtype, device)
        if cfg.scoring == "sigmoid":
            self.e_score_correction_bias = _param((cfg.n_experts,), torch.float32, device)

    def forward(self, x):
        if self.scoring == "sigmoid":
            return moe.route_sigmoid(x, self.weight, self.e_score_correction_bias, self.top_k,
                                     self.scaling)
        return moe.route(x, self.weight, self.top_k, self.scaling)


class MoE(nn.Module):
    """Routed experts (stacked: gate_up (E, 2 F, d), down (E, d, F)) and the
    shared experts, over (M, d) tokens."""

    def __init__(self, cfg: DeepseekV2Config, layer: int, dtype, device):
        super().__init__()
        self.layer, self.cfg = layer, cfg
        d, f, e = cfg.d_model, cfg.d_expert, cfg.n_experts
        self.router = Router(cfg, dtype, device)
        self.gate_up = _param((e, 2 * f, d), dtype, device)
        self.down = _param((e, d, f), dtype, device)
        self.shared = SwiGLU(d, cfg.n_shared * f, dtype, device)

    def forward(self, x):
        cfg = self.cfg
        with trace.span("outfitx.moe", self.layer):
            with trace.span("outfitx.route", self.layer):
                w, idx = self.router(x)
                order, counts, ends = moe.permute(idx, cfg.n_experts)
                trace.count("outfitx.expert_tokens", counts, self.layer)
                xs = x.index_select(0, order // cfg.top_k)
            with trace.span("outfitx.experts", self.layer):
                g, u = moe.grouped_mm(xs, self.gate_up, ends).split(cfg.d_expert, dim=-1)
                ys = moe.grouped_mm(F.silu(g) * u, self.down, ends)
            with trace.span("outfitx.route", self.layer):
                y_pairs = moe.unpermute(ys, order)
            return (moe.combine(y_pairs, w) + self.shared(x).float()).to(x.dtype)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, index: int, dtype, device):
        super().__init__()
        self.index = index
        self.attn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, dtype, device)
        self.attn = MLA(cfg, dtype, device)
        self.ffn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, dtype, device)
        self.ffn = (SwiGLU(cfg.d_model, cfg.d_ffn, dtype, device) if index < cfg.first_dense
                    else MoE(cfg, index, dtype, device))

    def forward(self, x, pad_mask, cos, sin):
        with trace.span("outfitx.mla", self.index):
            x = x + self.attn(self.attn_norm(x), pad_mask, cos, sin)
        n, t, d = x.shape
        return x + self.ffn(self.ffn_norm(x).view(n * t, d)).view(n, t, d)


class DeepseekV2(nn.Module):
    # Made and drawn on the device (``init_weights_``), never on the host.
    made_on_device = True

    def __init__(self, cfg: DeepseekV2Config, device: str | torch.device = "cpu"):
        super().__init__()
        self.cfg = cfg
        dt = dtypes.resolve(cfg.compute_dtype)
        self.embed = _param((cfg.vocab_size, cfg.d_model), dt, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, dt, device) for i in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.d_model, cfg.rms_eps, dt, device)
        self.proj = nn.Linear(cfg.d_model, cfg.d_out, device=device)
        self.register_buffer("inv_freq", yarn_inv_freq(cfg).to(device), persistent=False)
        self.cos_sin_scale = yarn_mscale(cfg.rope_factor, cfg.mscale) / yarn_mscale(
            cfg.rope_factor, cfg.mscale_all_dim)

    def init_weights_(self, gen: torch.Generator) -> None:
        """N(0, init_std) matrices, embedding and router biases, RMSNorm
        weights 1, the head uniform(+-1/sqrt(d_in)), drawn on the tower's
        device from ``gen`` (a generator on that device)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("proj."):
                    continue
                if name.endswith("norm.weight"):
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, self.cfg.init_std, generator=gen)
            init_linear_(self.proj, gen)

    def rope_tables(self, t: int):
        """cos, sin (T, rope_dim) in float32 for positions 0..T-1."""
        pos = torch.arange(t, dtype=torch.float32, device=self.inv_freq.device)
        freqs = torch.outer(pos, self.inv_freq)
        emb = torch.cat([freqs, freqs], dim=-1)
        return emb.cos() * self.cos_sin_scale, emb.sin() * self.cos_sin_scale

    def features(self, input_ids: Optional[torch.Tensor], attention_mask: Optional[torch.Tensor],
                 prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T) ids and mask (1 = real token) -> (B, P + T, d) final
        states. ``prefix`` (B, P, d), where given, stands ahead of the ids'
        embeddings in the compute dtype and is never padding (a joint
        pair's image tokens); ids of None run the prefix alone. Positions
        run 0 .. P + T - 1."""
        parts, pads = [], []
        if prefix is not None:
            parts.append(prefix.to(self.embed.dtype))
            pads.append(torch.zeros(prefix.shape[:2], dtype=torch.bool, device=prefix.device))
        if input_ids is not None:
            parts.append(F.embedding(input_ids.long(), self.embed))
            pads.append(attention_mask == 0)
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        pad_mask = (pads[0] if len(pads) == 1 else torch.cat(pads, dim=1)).contiguous()
        t = x.shape[1]
        if t > self.cfg.max_len:
            raise ValueError(f"{t} tokens exceed max_len {self.cfg.max_len}")
        cos, sin = self.rope_tables(t)
        for layer in self.layers:
            x = layer(x, pad_mask, cos, sin)
        return self.norm(x)

    def pooled(self, prefix: Optional[torch.Tensor] = None,
               input_ids: Optional[torch.Tensor] = None,
               attention_mask: Optional[torch.Tensor] = None):
        """One pass over [prefix; ids] -> (the mean of the prefix's final
        states, the mean of the ids' real tokens' final states), each (B, d)
        in the compute dtype, None for a part not given; a mask of None is
        all-ones."""
        if input_ids is not None and attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        h = self.features(input_ids, attention_mask, prefix)
        p = 0 if prefix is None else prefix.shape[1]
        head = h[:, :p].mean(dim=1) if p else None
        tail = mean_pooling(h[:, p:], attention_mask) if input_ids is not None else None
        return head, tail

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """(B, T) ids and mask (all-ones if None) -> (B, d_out) in the
        compute dtype: the mean of the real tokens' final states, then
        ``proj``."""
        return dense(self.pooled(None, input_ids, attention_mask)[1], self.proj.weight,
                     self.proj.bias)
