"""DeepSeek-V2-Lite as the frozen text tower of the resnet_dsv2lite item
encoder, in plain float32 PyTorch (TF32 off, ``numerics.exact_float32``),
the benchmark's copy: computed in blocks so that it fits on the card
beside the program's weights.

Written from the keys of deepseek-ai/DeepSeek-V2-Lite's ``config.json``
(``cfg`` holds them under their own names). Weights are the program's
state-dict names (``tower_specs``), drawn from the run's seed in bfloat16,
the checkpoint's dtype (``draw_tower``); the reference keeps them so and
widens one layer's to float32 at a time, running every item through that
layer before the next. Departures from the published model, both layouts
only: the rotary columns in rotate-half order (pair i is columns i and i +
32), and gate and up of each SwiGLU stacked in one weight, gate first.

- MLA naively: K and V expanded per head from the latent (k_pe the same
  for every head), scores in float32, the causal and key-padding masks set
  to -1e9, softmax, P V; S scaled by 192^-0.5 mscale(40, 0.707)^2;
- YaRN's inverse frequencies from the formula, positions 0..T-1;
- the mixture as a loop over the experts: softmax over the router's
  logits, top-6, each expert's SwiGLU over its tokens, weighted by its
  unnormalised score, summed, plus the shared experts' SwiGLU;
- the final RMSNorm and the mean over each item's real tokens.

``low`` computes in float8 e4m3 wherever the program computes in bfloat16
(the products and the residual stream): the control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from outfitbench.reference.numerics import fp8, matmul

NEG = -1e9
INIT_STD = 0.02  # initializer_range is not in the config: assumed


def mscale(scale: float, m: float) -> float:
    return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0


def inv_freq(cfg: Dict) -> torch.Tensor:
    """YaRN: base^(-2i/dim) blended with a factor-th of it by 1 -
    ramp(i; floor(d(beta_fast)), ceil(d(beta_slow))), d(r) = dim ln(original
    / (2 pi r)) / (2 ln base)."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]

    def d(r):
        return dim * math.log(rs["original_max_position_embeddings"] / (2 * math.pi * r)) / (
            2 * math.log(base))

    low = max(math.floor(d(rs["beta_fast"])), 0)
    high = min(math.ceil(d(rs["beta_slow"])), dim - 1)
    out = []
    for i in range(dim // 2):
        extra = base ** (-2.0 * i / dim)
        mask = 1.0 - min(max((i - low) / (high - low), 0.0), 1.0)
        out.append(extra * mask + extra / rs["factor"] * (1.0 - mask))
    return torch.tensor(out, dtype=torch.float32)


def softmax_scale(cfg: Dict) -> float:
    rs = cfg["rope_scaling"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return dqk ** -0.5 * mscale(rs["factor"], rs["mscale_all_dim"]) ** 2


def tower_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(state-dict name, shape, 'normal' or 'norm') of every frozen weight,
    in the order they are drawn."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    r, f, e = cfg["kv_lora_rank"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    out = [("embed", (cfg["vocab_size"], d), "normal")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "attn_norm.weight", (d,), "norm"),
                (p + "attn.q", (h * (nope + rd), d), "normal"),
                (p + "attn.kv_a", (r + rd, d), "normal"),
                (p + "attn.kv_norm.weight", (r,), "norm"),
                (p + "attn.kv_b", (h * (nope + vd), r), "normal"),
                (p + "attn.o", (d, h * vd), "normal"),
                (p + "ffn_norm.weight", (d,), "norm")]
        if i < cfg["first_k_dense_replace"]:
            w = cfg["intermediate_size"]
            out += [(p + "ffn.gate_up", (2 * w, d), "normal"), (p + "ffn.down", (d, w), "normal")]
        else:
            s = cfg["n_shared_experts"] * f
            out += [(p + "ffn.router.weight", (e, d), "normal"),
                    (p + "ffn.gate_up", (e, 2 * f, d), "normal"),
                    (p + "ffn.down", (e, d, f), "normal"),
                    (p + "ffn.shared.gate_up", (2 * s, d), "normal"),
                    (p + "ffn.shared.down", (d, s), "normal")]
    out.append(("norm.weight", (d,), "norm"))
    return out


def draw_tower(cfg: Dict, gen: torch.Generator, device, sink: Callable) -> None:
    """Draw every frozen weight of ``tower_specs`` in bfloat16 on the device,
    one tensor at a time, from ``gen``: N(0, 0.02) matrices and embedding,
    RMSNorm weights uniform in 1 +- 0.1 (away from 1, so that a path that
    drops one shows); ``sink(name, tensor)`` takes each."""
    for name, shape, kind in tower_specs(cfg):
        t = torch.empty(shape, dtype=torch.bfloat16, device=device)
        if kind == "norm":
            t.uniform_(0.9, 1.1, generator=gen)
        else:
            t.normal_(0.0, INIT_STD, generator=gen)
        sink(name, t)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def rotate(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def swiglu(x, gate_up, down, low: bool = False):
    g, u = matmul(x, gate_up.T, low).split(down.shape[1], dim=-1)
    return matmul(F.silu(g) * u, down.T, low)


def mla(p: Dict, x, pad, cfg: Dict, cos, sin, low: bool = False):
    """x (B, T, d) -> (B, T, d), every head's K and V expanded."""
    b, t, _ = x.shape
    h, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rd, vd, r = cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = matmul(x, p["attn.q"].T, low).view(b, t, h, nope + rd)
    kv_a = matmul(x, p["attn.kv_a"].T, low)
    c_kv, k_pe = kv_a[..., :r], kv_a[..., r:]
    kv = matmul(rms_norm(c_kv, p["attn.kv_norm.weight"], cfg["rms_norm_eps"]), p["attn.kv_b"].T,
                low).view(b, t, h, nope + vd)
    qh = torch.cat([q[..., :nope], rotate(q[..., nope:].transpose(1, 2), cos, sin).transpose(1, 2)],
                   dim=-1).transpose(1, 2)
    k_pe = rotate(k_pe, cos, sin)[:, :, None, :].expand(b, t, h, rd)
    kh = torch.cat([kv[..., :nope], k_pe], dim=-1).transpose(1, 2)
    vh = kv[..., nope:].transpose(1, 2)
    s = matmul(qh, kh.transpose(-1, -2), low) * softmax_scale(cfg)
    s = s.masked_fill(pad[:, None, None, :], NEG)
    s = s.masked_fill(torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1), NEG)
    o = matmul(torch.softmax(s, dim=-1), vh, low).transpose(1, 2).reshape(b, t, h * vd)
    return matmul(o, p["attn.o"].T, low)


def moe(p: Dict, x, cfg: Dict, low: bool = False):
    """x (M, d) -> (y (M, d), the top-k experts (M, k)), a loop over experts."""
    scores = torch.softmax(x @ p["ffn.router.weight"].T, dim=-1)
    w, idx = torch.topk(scores, cfg["num_experts_per_tok"], dim=-1)
    w = w * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            out = swiglu(x[tok], p["ffn.gate_up"][e], p["ffn.down"][e], low)
            y.index_add_(0, tok, w[tok, slot, None] * out)
    return y + swiglu(x, p["ffn.shared.gate_up"], p["ffn.shared.down"], low), idx


@torch.no_grad()
def features(weights: Dict[str, torch.Tensor], cfg: Dict, ids, attn, low: bool = False,
             block: int = 1024) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(N, T) ids and masks (1 = real token) -> (the mean of each item's
    real final states (N, d) float32, each mixture's top-k experts (N T, k),
    sorted in each row, uint8). Layer by layer over all N items, in blocks
    of items: one layer's weights in float32 at a time."""
    n, t = ids.shape
    dev = ids.device
    eps = cfg["rms_norm_eps"]
    r = fp8 if low else (lambda z: z)
    x = r(weights["embed"][ids.long()].float())
    pad = attn == 0
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=dev), inv_freq(cfg).to(dev))
    emb = torch.cat([freqs, freqs], dim=-1)
    rs = cfg["rope_scaling"]
    m = mscale(rs["factor"], rs["mscale"]) / mscale(rs["factor"], rs["mscale_all_dim"])
    cos, sin = emb.cos() * m, emb.sin() * m
    routes = []
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        p = {k[len(pre):]: v.float() for k, v in weights.items() if k.startswith(pre)}
        found = []
        for s in range(0, n, block):
            xb = x[s : s + block]
            nb = xb.shape[0]
            xb = r(xb + mla(p, r(rms_norm(xb, p["attn_norm.weight"], eps)), pad[s : s + block],
                            cfg, cos, sin, low))
            y = r(rms_norm(xb, p["ffn_norm.weight"], eps)).view(nb * t, -1)
            if i < cfg["first_k_dense_replace"]:
                y = swiglu(y, p["ffn.gate_up"], p["ffn.down"], low)
            else:
                y, idx = moe(p, y, cfg, low)
                found.append(idx.sort(dim=-1).values.to(torch.uint8))
            x[s : s + block] = r(xb + y.view(nb, t, -1))
        if found:
            routes.append(torch.cat(found))
        del p
    x = rms_norm(x, weights["norm.weight"].float(), eps)
    w = attn.float()[..., None]
    return (x * w).sum(dim=1) / w.sum(dim=1).clamp_min(1e-9), routes
