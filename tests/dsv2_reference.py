"""DeepSeek-V2 as a text tower, in plain float32 PyTorch, for the CPU tests.

Written from the published ``config.json`` keys of deepseek-ai/DeepSeek-V2-Lite
(``cfg`` holds them under their own names) and nothing of the port: no
kernel, no module of ``outfitx_tpu_torch`` or ``outfitx_tpu``. Weights are a
dict by the port's state-dict names. Departures from the published model:
the rotary columns in rotate-half order (pair i is columns i and i + half),
and gate and up of each SwiGLU stacked in one weight, gate first.

- MLA computed naively: K and V expanded per head from the latent, k_pe
  repeated over the heads, scores in float32 with the causal and key-padding
  masks set to -1e9, softmax, P V;
- YaRN inverse frequencies from the formula: base^(-2i/dim) blended with a
  factor-th of it by 1 - ramp(i; floor(d(beta_fast)), ceil(d(beta_slow)));
- the mixture as a loop over experts: softmax over the router's logits,
  top-k, each expert's SwiGLU over its tokens, weighted, summed, plus the
  shared experts;
- the final RMSNorm, a mean over the real tokens, the head ``proj``, L2
  normalised (the pair's text half of an item embedding).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

NEG = -1e9


def mscale(scale: float, m: float) -> float:
    return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0


def inv_freq(cfg: Dict) -> torch.Tensor:
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]

    def d(r):
        return dim * math.log(rs["original_max_position_embeddings"] / (2 * math.pi * r)) / (
            2 * math.log(base))

    low = max(math.floor(d(rs["beta_fast"])), 0)
    high = min(math.ceil(d(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    out = []
    for i in range(dim // 2):
        extra = base ** (-2.0 * i / dim)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        mask = 1.0 - ramp
        out.append(extra * mask + extra / rs["factor"] * (1.0 - mask))
    return torch.tensor(out, dtype=torch.float32)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def rotate(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def swiglu(x, gate_up, down):
    width = down.shape[1]
    g, u = (x @ gate_up.T).split(width, dim=-1)
    return (F.silu(g) * u) @ down.T


def mla(p: Dict, pre: str, x, pad, cfg: Dict, cos, sin):
    b, t, _ = x.shape
    h, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rd, vd, r = cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (x @ p[pre + "q"].T).view(b, t, h, nope + rd)
    kv_a = x @ p[pre + "kv_a"].T
    c_kv, k_pe = kv_a[..., :r], kv_a[..., r:]
    kv = (rms_norm(c_kv, p[pre + "kv_norm.weight"], cfg["rms_norm_eps"]) @ p[pre + "kv_b"].T)
    kv = kv.view(b, t, h, nope + vd)
    out = []
    for head in range(h):
        qh = torch.cat([q[:, :, head, :nope], rotate(q[:, :, head, nope:], cos, sin)], dim=-1)
        kh = torch.cat([kv[:, :, head, :nope], rotate(k_pe, cos, sin)], dim=-1)
        vh = kv[:, :, head, nope:]
        s = qh @ kh.transpose(1, 2) * softmax_scale(cfg)
        s = s.masked_fill(pad[:, None, :], NEG)
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), NEG)
        out.append(torch.softmax(s, dim=-1) @ vh)
    return torch.cat(out, dim=-1) @ p[pre + "o"].T


def softmax_scale(cfg: Dict) -> float:
    rs = cfg["rope_scaling"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return dqk ** -0.5 * mscale(rs["factor"], rs["mscale_all_dim"]) ** 2


def moe(p: Dict, pre: str, x, cfg: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, d) -> (y (M, d), the top-k experts (M, k))."""
    scores = torch.softmax(x @ p[pre + "router.weight"].T, dim=-1)
    w, idx = torch.topk(scores, cfg["num_experts_per_tok"], dim=-1)
    w = w * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            y[tok] += w[tok, slot, None] * swiglu(x[tok], p[pre + "gate_up"][e], p[pre + "down"][e])
    shared = swiglu(x, p[pre + "shared.gate_up"], p[pre + "shared.down"])
    return y + shared, idx


def features(p: Dict, cfg: Dict, ids, attn) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(B, T) ids and mask -> (final states (B, T, d), each mixture's top-k
    experts (B T, k))."""
    b, t = ids.shape
    x = p["embed"][ids.long()]
    pad = attn == 0
    freqs = torch.outer(torch.arange(t, dtype=torch.float32), inv_freq(cfg))
    emb = torch.cat([freqs, freqs], dim=-1)
    m = mscale(cfg["rope_scaling"]["factor"], cfg["rope_scaling"]["mscale"]) / mscale(
        cfg["rope_scaling"]["factor"], cfg["rope_scaling"]["mscale_all_dim"])
    cos, sin = emb.cos() * m, emb.sin() * m
    eps = cfg["rms_norm_eps"]
    routes = []
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        x = x + mla(p, pre + "attn.", rms_norm(x, p[pre + "attn_norm.weight"], eps), pad, cfg,
                    cos, sin)
        y = rms_norm(x, p[pre + "ffn_norm.weight"], eps).reshape(b * t, -1)
        if i < cfg["first_k_dense_replace"]:
            y = swiglu(y, p[pre + "ffn.gate_up"], p[pre + "ffn.down"])
        else:
            y, idx = moe(p, pre + "ffn.", y, cfg)
            routes.append(idx)
        x = x + y.view(b, t, -1)
    return rms_norm(x, p["norm.weight"], eps), routes


def text_embedding(p: Dict, cfg: Dict, ids, attn) -> torch.Tensor:
    """(B, T) -> (B, d_out): the mean of the real tokens' final states, the
    head ``proj``, L2 normalised."""
    x, _ = features(p, cfg, ids, attn)
    w = attn.float()[..., None]
    pooled = (x * w).sum(dim=1) / w.sum(dim=1).clamp_min(1e-9)
    y = pooled @ p["proj.weight"].T + p["proj.bias"]
    return y / torch.linalg.norm(y, dim=-1, keepdim=True)
