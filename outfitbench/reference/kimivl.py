"""Kimi-VL-A3B as the joint item encoder of kimivl_a3b, in plain float32
PyTorch (TF32 off, ``numerics.exact_float32``), the benchmark's copy:
computed in blocks so that it fits on the card beside the program's
weights.

Written from moonshotai/Kimi-VL-A3B-Instruct's ``config.json`` (``cfg``
holds its ``text_config`` keys at the top and its ``vision_config`` under
that name) and the Kimi-VL report (arXiv:2504.07491). The decoder's pieces
are ``reference/dsv2.py``'s (RMSNorm, MLA, SwiGLU, the weights' names and
draw); what differs is here. Weights are the program's state-dict names
(``vision_specs``; ``dsv2.tower_specs`` and each mixture's correction
bias), drawn from the run's seed in
bfloat16, the checkpoint's dtype, but the router's correction bias in
float32 (``draw_towers``); the reference keeps them so and widens one
tower's, or one decoder layer's, to float32 at a time. Departures from the
published model, layouts only: MoonViT's q, k and v apart (the checkpoint
stacks them), its patch kernel flattened in (channel, y, x) order, the
decoder's rotary columns in rotate-half order, gate and up stacked.

- MoonViT: 14 x 14 patches, the 64 x 64 position table to the 16 x 16
  grid by bicubic convolution written out (a = -0.75, source (j + 0.5) 4 -
  0.5, indices clamped), 27 pre-LN blocks with the 2D rotary on q and k
  (pair j of a head's 72 columns turned by col w_(j // 2) for even j, row
  w_(j // 2) for odd j, w_i = 10000^(-4 i / 72)), attention over all 256
  patches, gelu (tanh) MLP, the final LayerNorm;
- the 2 x 2 merge after the projector's LayerNorm, Linear, gelu (erf),
  Linear to 2,048;
- the decoder over [64 image tokens; title] with dsv2's MLA at scale
  192^-0.5 (``rope_scaling`` null: YaRN's factor 1), plain RoPE at base
  800,000, a dense SwiGLU in layer 0, then the mixture as a loop over
  experts: s = sigmoid(x W^T), the top-6 of s + bias chosen, weighted by s
  there over their sum + 1e-20, times 2.446, plus the shared experts;
- the final RMSNorm, the mean over the image positions and the mean over
  the title's real tokens.

``low`` computes in float8 e4m3 wherever the program computes in bfloat16
(the products and the residual streams): the control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from outfitbench.reference import dsv2
from outfitbench.reference.numerics import fp8
from outfitbench.reference.set_transformer import attention, layer_norm, linear

LN_EPS = 1e-5  # nn.LayerNorm's default: MoonViT's LayerNorms set none, the projector's 1e-5
ROPE_2D_THETA = 10000.0  # MoonViT's Rope2DPosEmb theta_base
CUBIC_A = -0.75
# ``rope_scaling`` null, in the terms dsv2.mla reads: YaRN's mscale is 1 at factor 1.
NO_YARN = {"factor": 1.0, "mscale": 1.0, "mscale_all_dim": 1.0}


def vision_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(state-dict name under ``vision.``, shape, kind) of every frozen
    weight of MoonViT and the projector, in the order they are drawn."""
    vc = cfg["vision_config"]
    d, f, p = vc["hidden_size"], vc["intermediate_size"], vc["patch_size"]
    wide = vc["merge_kernel_size"][0] * vc["merge_kernel_size"][1] * d
    out = [("patch.weight", (d, 3 * p * p), "normal"), ("patch.bias", (d,), "normal"),
           ("pos_table", (vc["init_pos_emb_height"], vc["init_pos_emb_width"], d), "normal")]
    for i in range(vc["num_hidden_layers"]):
        pre = f"encoder.layers.{i}."
        for ln in ("ln1", "ln2"):
            out += [(pre + ln + ".weight", (d,), "norm"), (pre + ln + ".bias", (d,), "shift")]
        for name, shape in (("q", (d, d)), ("k", (d, d)), ("v", (d, d)), ("o", (d, d)),
                            ("fc1", (f, d)), ("fc2", (d, f))):
            out += [(pre + name + ".weight", shape, "normal"), (pre + name + ".bias", shape[:1],
                                                                  "normal")]
    for ln in ("final_ln", "proj_ln"):
        out += [(ln + ".weight", (d,), "norm"), (ln + ".bias", (d,), "shift")]
    out += [("proj_in.weight", (wide, wide), "normal"), ("proj_in.bias", (wide,), "normal"),
            ("proj_out.weight", (cfg["hidden_size"], wide), "normal"),
            ("proj_out.bias", (cfg["hidden_size"],), "normal")]
    return out


def mixtures(cfg: Dict) -> range:
    return range(cfg["first_k_dense_replace"], cfg["num_hidden_layers"])


def draw_towers(cfg: Dict, gen: torch.Generator, device, sink: Callable) -> None:
    """Draw every frozen weight on the device, one tensor at a time, from
    ``gen``: MoonViT's and the projector's in bfloat16 (N(0, 0.02)
    matrices, biases and table, LayerNorm scales uniform in 1 +- 0.1 and
    shifts in +-0.1, away from 1 and 0 so that a path that drops one
    shows), then the decoder's by ``dsv2.draw_tower``, then each mixture's
    correction bias, N(0, e_score_correction_bias_std) in float32.
    ``sink(name, tensor)`` takes each, named as in the program's encoder
    (``vision.``, ``text.``)."""
    for name, shape, kind in vision_specs(cfg):
        t = torch.empty(shape, dtype=torch.bfloat16, device=device)
        if kind == "norm":
            t.uniform_(0.9, 1.1, generator=gen)
        elif kind == "shift":
            t.uniform_(-0.1, 0.1, generator=gen)
        else:
            t.normal_(0.0, dsv2.INIT_STD, generator=gen)
        sink("vision." + name, t)
    dsv2.draw_tower(cfg, gen, device, lambda name, t: sink("text." + name, t))
    for i in mixtures(cfg):
        t = torch.empty(cfg["n_routed_experts"], dtype=torch.float32, device=device)
        sink(f"text.layers.{i}.ffn.router.e_score_correction_bias",
             t.normal_(0.0, cfg["e_score_correction_bias_std"], generator=gen))


def bicubic_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) float64: Keys' cubic convolution (a = -0.75) at source
    (j + 0.5) n_in / n_out - 0.5, indices clamped to the table."""
    a = CUBIC_A

    def near(x):
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def far(x):
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a

    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    for j in range(n_out):
        src = (j + 0.5) * n_in / n_out - 0.5
        x0 = math.floor(src)
        t = src - x0
        for k, w in enumerate((far(t + 1), near(t), near(1 - t), far(2 - t))):
            m[j, min(max(x0 - 1 + k, 0), n_in - 1)] += w
    return m


def rotary_angles(g: int, dh: int) -> torch.Tensor:
    """(g g, dh / 2) float64: token n = (row, col) = divmod(n, g); pair j
    turns by col w_(j // 2) for even j, row w_(j // 2) for odd j."""
    n = torch.arange(g * g, dtype=torch.float64)
    row, col = torch.div(n, g, rounding_mode="floor"), n % g
    j = torch.arange(dh // 2, dtype=torch.float64)
    w = ROPE_2D_THETA ** (-4.0 * torch.div(j, 2, rounding_mode="floor") / dh)
    return torch.where(j % 2 == 0, col[:, None], row[:, None]) * w


def rotate_pairs(x, cos, sin):
    """Pair (2j, 2j + 1) of x's last axis as a complex number, turned."""
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).flatten(-2)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


@torch.no_grad()
def vit_tokens(weights: Dict[str, torch.Tensor], cfg: Dict, images_uint8, low: bool = False,
               block: int = 128) -> torch.Tensor:
    """(N, 3, S, S) uint8 (host or device) -> (N, (g / 2)^2, hidden_size)
    float32 image tokens, MoonViT and the projector in float32, in blocks
    of images."""
    vc = cfg["vision_config"]
    v = {k[7:]: t.float() for k, t in weights.items() if k.startswith("vision.")}
    dev = v["patch.weight"].device
    ps, d, h = vc["patch_size"], vc["hidden_size"], vc["num_attention_heads"]
    s = images_uint8.shape[-1]
    g, dh, m = s // ps, d // h, vc["merge_kernel_size"][0]
    rows = bicubic_matrix(v["pos_table"].shape[0], g).float().to(dev)
    cols = bicubic_matrix(v["pos_table"].shape[1], g).float().to(dev)
    table = torch.einsum("ih,jw,hwd->ijd", rows, cols, v["pos_table"]).reshape(g * g, d)
    angles = rotary_angles(g, dh).to(dev)
    cos, sin = angles.cos().float(), angles.sin().float()
    mean = torch.tensor(cfg["image_mean"], device=dev).view(1, 3, 1, 1)
    std = torch.tensor(cfg["image_std"], device=dev).view(1, 3, 1, 1)
    r = fp8 if low else (lambda z: z)
    out = []
    for at in range(0, len(images_uint8), block):
        x = torch.as_tensor(images_uint8[at : at + block]).to(dev).float()
        b = x.shape[0]
        x = (x / 255.0 - mean) / std
        x = x.reshape(b, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, -1)
        x = r(linear(x, v["patch.weight"], v["patch.bias"], low) + table)
        pad = torch.zeros(b, g * g, dtype=torch.bool, device=dev)
        for i in range(vc["num_hidden_layers"]):
            pre = f"encoder.layers.{i}."

            def lin(name, z):
                return linear(z, v[pre + name + ".weight"], v[pre + name + ".bias"], low)

            y = layer_norm(x, v[pre + "ln1.weight"], v[pre + "ln1.bias"], LN_EPS)
            q, k, vv = (lin(n, y).view(b, g * g, h, dh).transpose(1, 2) for n in ("q", "k", "v"))
            q, k = rotate_pairs(q, cos, sin), rotate_pairs(k, cos, sin)
            x = r(x + lin("o", attention(q, k, vv, pad, low).transpose(1, 2).reshape(b, g * g, d)))
            y = layer_norm(x, v[pre + "ln2.weight"], v[pre + "ln2.bias"], LN_EPS)
            x = r(x + lin("fc2", gelu_tanh(lin("fc1", y))))
        x = layer_norm(x, v["final_ln.weight"], v["final_ln.bias"], LN_EPS)
        y = layer_norm(x, v["proj_ln.weight"], v["proj_ln.bias"], LN_EPS)
        y = y.view(b, g // m, m, g // m, m, d).permute(0, 1, 3, 2, 4, 5).reshape(b, -1, m * m * d)
        y = F.gelu(linear(y, v["proj_in.weight"], v["proj_in.bias"], low))
        out.append(r(linear(y, v["proj_out.weight"], v["proj_out.bias"], low)))
    return torch.cat(out)


def moe(p: Dict, x, cfg: Dict, low: bool = False):
    """x (M, d) -> (y (M, d), the chosen experts (M, k)), a loop over
    experts: chosen by s + bias, weighted by s."""
    s = torch.sigmoid(x @ p["ffn.router.weight"].T)
    idx = torch.topk(s + p["ffn.router.e_score_correction_bias"], cfg["num_experts_per_tok"],
                     dim=-1).indices
    w = s.gather(-1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            out = dsv2.swiglu(x[tok], p["ffn.gate_up"][e], p["ffn.down"][e], low)
            y.index_add_(0, tok, w[tok, slot, None] * out)
    return y + dsv2.swiglu(x, p["ffn.shared.gate_up"], p["ffn.shared.down"], low), idx


@torch.no_grad()
def features(weights: Dict[str, torch.Tensor], cfg: Dict, tokens, ids, attn,
             low: bool = False, block: int = 256):
    """N items' image tokens (N, P, d) float32 (``vit_tokens``) and title
    ids and masks (N, T) on the device -> (the mean of each item's image
    positions' final states (N, d), the mean of its title's real ones (N,
    d), each mixture's chosen experts (N (P + T), k), sorted in each row,
    uint8). The decoder layer by layer over all N items in blocks: one
    layer's weights in float32 at a time."""
    n, p = tokens.shape[:2]
    t = ids.shape[1]
    dev = ids.device
    eps = cfg["rms_norm_eps"]
    mla_cfg = dict(cfg, rope_scaling=NO_YARN)
    r = fp8 if low else (lambda z: z)
    x = torch.cat([tokens, r(weights["text.embed"][ids.long()].float())], dim=1)
    pad = torch.cat([torch.zeros(n, p, dtype=torch.bool, device=dev), attn == 0], dim=1)
    rd = cfg["qk_rope_head_dim"]
    inv = cfg["rope_theta"] ** (-torch.arange(0, rd, 2, dtype=torch.float64, device=dev) / rd)
    freqs = torch.outer(torch.arange(p + t, dtype=torch.float64, device=dev), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos().float(), emb.sin().float()
    routes = []
    for i in range(cfg["num_hidden_layers"]):
        pre = f"text.layers.{i}."
        lp = {k[len(pre):]: v.float() for k, v in weights.items() if k.startswith(pre)}
        found = []
        for s in range(0, n, block):
            xb = x[s : s + block]
            nb = xb.shape[0]
            xb = r(xb + dsv2.mla(lp, r(dsv2.rms_norm(xb, lp["attn_norm.weight"], eps)),
                                 pad[s : s + block], mla_cfg, cos, sin, low))
            y = r(dsv2.rms_norm(xb, lp["ffn_norm.weight"], eps)).view(nb * (p + t), -1)
            if i < cfg["first_k_dense_replace"]:
                y = dsv2.swiglu(y, lp["ffn.gate_up"], lp["ffn.down"], low)
            else:
                y, idx = moe(lp, y, cfg, low)
                found.append(idx.sort(dim=-1).values.to(torch.uint8))
            x[s : s + block] = r(xb + y.view(nb, p + t, -1))
        if found:
            routes.append(torch.cat(found))
        del lp
    x = dsv2.rms_norm(x, weights["text.norm.weight"].float(), eps)
    w = attn.float()[..., None]
    title = (x[:, p:] * w).sum(dim=1) / w.sum(dim=1).clamp_min(1e-9)
    return x[:, :p].mean(dim=1), title, routes
