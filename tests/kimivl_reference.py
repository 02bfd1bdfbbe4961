"""Kimi-VL-A3B as a joint item encoder, in plain float32 PyTorch, for the
CPU tests.

Written from moonshotai/Kimi-VL-A3B-Instruct's ``config.json`` (``cfg``
holds its ``text_config`` keys at the top and its ``vision_config`` under
that name) and the Kimi-VL report (arXiv:2504.07491), and nothing of the
port: no kernel, no module of ``outfitx_tpu_torch`` or ``outfitx_tpu``.
Weights are two dicts by the port's state-dict names, ``v`` (MoonViT, the
projector and ``fc``) and ``t`` (the decoder and ``proj``). The plain
pieces of DeepSeek-V2's block (RMSNorm, the rotate-half rotary, SwiGLU)
are ``dsv2_reference``'s. Departures from the published model, layouts
only: q, k and v apart where MoonViT stacks them (``wqkv``), the patch
kernel flattened in (channel, y, x) order, the decoder's rotary columns in
rotate-half order, and gate and up of each SwiGLU stacked, gate first.

- MoonViT: patches of 14 x 14, the 64 x 64 position table interpolated to
  the grid by bicubic convolution written out (PyTorch's: a = -0.75, the
  source pixel (j + 0.5) in / out - 0.5, indices clamped to the table),
  27 pre-LN blocks with the 2D rotary on q and k (pair j of a head's
  columns (2j, 2j + 1) turned by col w_(j // 2) for even j, row w_(j // 2)
  for odd j, w_i = 10000^(-4 i / 72)), attention over all patches,
  gelu (tanh) MLP, the final LayerNorm;
- the merge of each 2 x 2 block of patches (row offset, then column
  offset) into 4 d after the projector's LayerNorm, Linear, gelu (erf),
  Linear to the decoder's width;
- the decoder over [image tokens; title]: MLA naively (K and V expanded
  per head, causal and key-padding masks set to -1e9, S scaled by
  192^-0.5), plain RoPE at base 800,000 over positions 0..P+T-1, a dense
  SwiGLU in layer 0, then mixtures as a loop over experts: s =
  sigmoid(x W^T), the top-6 of s + bias chosen, weighted by s there over
  their sum + 1e-20, times 2.446, plus the shared experts;
- the final RMSNorm, the mean over the image positions through ``fc``, the
  mean over the title's real tokens through ``proj``, each L2 normalised,
  image half first.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from dsv2_reference import NEG, rms_norm, rotate, swiglu

CUBIC_A = -0.75
LN_EPS = 1e-5  # nn.LayerNorm's default: MoonViT's LayerNorms set none, the projector's 1e-5
ROPE_2D_THETA = 10000.0  # MoonViT's Rope2DPosEmb theta_base


def layer_norm(x, w, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def gelu_erf(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def cubic_weights(t: float) -> List[float]:
    """Keys' cubic convolution at fraction t: the weights of pixels x0 - 1,
    x0, x0 + 1 and x0 + 2."""
    a = CUBIC_A

    def near(x):  # |x| <= 1
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def far(x):  # 1 < |x| < 2
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a

    return [far(t + 1), near(t), near(1 - t), far(2 - t)]


def bicubic_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in): row j holds the weights that make output j."""
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    for j in range(n_out):
        src = (j + 0.5) * n_in / n_out - 0.5
        x0 = math.floor(src)
        for k, w in enumerate(cubic_weights(src - x0)):
            m[j, min(max(x0 - 1 + k, 0), n_in - 1)] += w
    return m


def position_table(table, g: int):
    """(H, W, d) -> (g g, d), rows of the grid."""
    rows = bicubic_matrix(table.shape[0], g).float()
    cols = bicubic_matrix(table.shape[1], g).float()
    return torch.einsum("ih,jw,hwd->ijd", rows, cols, table).reshape(g * g, -1)


def rotary_angles(g: int, dh: int, theta: float = ROPE_2D_THETA) -> torch.Tensor:
    """(g g, dh / 2): token n = (row, col) = divmod(n, g); pair j turns by
    col w_(j // 2) for even j, row w_(j // 2) for odd j."""
    out = torch.zeros(g * g, dh // 2, dtype=torch.float64)
    for n in range(g * g):
        row, col = divmod(n, g)
        for j in range(dh // 2):
            w = theta ** (-4.0 * (j // 2) / dh)
            out[n, j] = (col if j % 2 == 0 else row) * w
    return out


def rotate_pairs(x, angles):
    """x (..., N, dh): pair (2j, 2j + 1) as the complex number x_2j + i
    x_2j+1, times e^(i angle)."""
    z = torch.view_as_complex(x.reshape(*x.shape[:-1], -1, 2).contiguous())
    turned = z * torch.polar(torch.ones_like(angles), angles).to(z.dtype)
    return torch.view_as_real(turned).reshape(x.shape)


def vit(v: Dict, cfg: Dict, images) -> torch.Tensor:
    """Normalised images (B, 3, S, S) -> final states (B, g g, d)."""
    vc = cfg["vision_config"]
    ps, d, h = vc["patch_size"], vc["hidden_size"], vc["num_attention_heads"]
    b, s = images.shape[0], images.shape[-1]
    g, dh = s // ps, d // h
    patches = images.reshape(b, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, -1)
    x = patches @ v["patch.weight"].T + v["patch.bias"] + position_table(v["pos_table"], g)
    angles = rotary_angles(g, dh)
    eps = LN_EPS
    for i in range(vc["num_hidden_layers"]):
        pre = f"encoder.layers.{i}."

        def lin(name, z):
            return z @ v[pre + name + ".weight"].T + v[pre + name + ".bias"]

        y = layer_norm(x, v[pre + "ln1.weight"], v[pre + "ln1.bias"], eps)
        q, k, vv = (lin(n, y).view(b, g * g, h, dh).transpose(1, 2) for n in ("q", "k", "v"))
        q, k = rotate_pairs(q, angles), rotate_pairs(k, angles)
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1)
        x = x + lin("o", (p @ vv).transpose(1, 2).reshape(b, g * g, d))
        y = layer_norm(x, v[pre + "ln2.weight"], v[pre + "ln2.bias"], eps)
        x = x + lin("fc2", gelu_tanh(lin("fc1", y)))
    return layer_norm(x, v["final_ln.weight"], v["final_ln.bias"], eps)


def project(v: Dict, cfg: Dict, states) -> torch.Tensor:
    """(B, g g, d) -> (B, (g / 2)^2, hidden_size): each 2 x 2 block of
    patches, in the order (0, 0), (0, 1), (1, 0), (1, 1), after the
    projector's LayerNorm; Linear, gelu (erf), Linear."""
    vc = cfg["vision_config"]
    m = vc["merge_kernel_size"][0]
    b, n, d = states.shape
    g = int(round(math.sqrt(n)))
    y = layer_norm(states, v["proj_ln.weight"], v["proj_ln.bias"], LN_EPS)
    tokens = []
    for bi in range(g // m):
        for bj in range(g // m):
            tokens.append(torch.cat([y[:, (m * bi + a) * g + m * bj + c]
                                     for a in range(m) for c in range(m)], dim=-1))
    x = torch.stack(tokens, dim=1)
    x = gelu_erf(x @ v["proj_in.weight"].T + v["proj_in.bias"])
    return x @ v["proj_out.weight"].T + v["proj_out.bias"]


def mla(t: Dict, pre: str, x, pad, cfg: Dict, cos, sin):
    b, n, _ = x.shape
    h, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rd, vd, r = cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (x @ t[pre + "q"].T).view(b, n, h, nope + rd)
    kv_a = x @ t[pre + "kv_a"].T
    c_kv, k_pe = kv_a[..., :r], kv_a[..., r:]
    kv = (rms_norm(c_kv, t[pre + "kv_norm.weight"], cfg["rms_norm_eps"]) @ t[pre + "kv_b"].T)
    kv = kv.view(b, n, h, nope + vd)
    scale = (nope + rd) ** -0.5  # rope_scaling null: no YaRN factor
    out = []
    for head in range(h):
        qh = torch.cat([q[:, :, head, :nope], rotate(q[:, :, head, nope:], cos, sin)], dim=-1)
        kh = torch.cat([kv[:, :, head, :nope], rotate(k_pe, cos, sin)], dim=-1)
        s = qh @ kh.transpose(1, 2) * scale
        s = s.masked_fill(pad[:, None, :], NEG)
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1), NEG)
        out.append(torch.softmax(s, dim=-1) @ kv[:, :, head, nope:])
    return torch.cat(out, dim=-1) @ t[pre + "o"].T


def moe(t: Dict, pre: str, x, cfg: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, d) -> (y (M, d), the chosen experts (M, k)): chosen by s +
    bias, weighted by s."""
    s = torch.sigmoid(x @ t[pre + "router.weight"].T)
    idx = torch.topk(s + t[pre + "router.e_score_correction_bias"], cfg["num_experts_per_tok"],
                     dim=-1).indices
    w = s.gather(-1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            y[tok] += w[tok, slot, None] * swiglu(x[tok], t[pre + "gate_up"][e], t[pre + "down"][e])
    return y + swiglu(x, t[pre + "shared.gate_up"], t[pre + "shared.down"]), idx


def decoder(t: Dict, cfg: Dict, prefix, ids, attn) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """[prefix (B, P, d); embeddings of ids (B, T)] -> (final states (B, P
    + T, d), each mixture's chosen experts (B (P + T), k))."""
    parts, pads = [], []
    if prefix is not None:
        parts.append(prefix)
        pads.append(torch.zeros(prefix.shape[:2], dtype=torch.bool))
    if ids is not None:
        parts.append(t["embed"][ids.long()])
        pads.append(attn == 0)
    x, pad = torch.cat(parts, dim=1), torch.cat(pads, dim=1)
    b, n, _ = x.shape
    rd = cfg["qk_rope_head_dim"]
    inv = cfg["rope_theta"] ** (-torch.arange(0, rd, 2, dtype=torch.float64) / rd)
    freqs = torch.outer(torch.arange(n, dtype=torch.float64), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos().float(), emb.sin().float()
    eps = cfg["rms_norm_eps"]
    routes = []
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        x = x + mla(t, pre + "attn.", rms_norm(x, t[pre + "attn_norm.weight"], eps), pad, cfg,
                    cos, sin)
        y = rms_norm(x, t[pre + "ffn_norm.weight"], eps).reshape(b * n, -1)
        if i < cfg["first_k_dense_replace"]:
            y = swiglu(y, t[pre + "ffn.gate_up"], t[pre + "ffn.down"])
        else:
            y, idx = moe(t, pre + "ffn.", y, cfg)
            routes.append(idx)
        x = x + y.view(b, n, -1)
    return rms_norm(x, t["norm.weight"], eps), routes


def normalized(y):
    return y / torch.linalg.norm(y, dim=-1, keepdim=True)


def item_embedding(v: Dict, t: Dict, cfg: Dict, images, ids, attn):
    """Normalised images (B, 3, S, S), title ids and mask (B, T) -> (the
    item embedding (B, 2 d_out), each mixture's chosen experts): image
    half from the mean over the image positions through ``fc``, title half
    from the mean over its real tokens through ``proj``."""
    tokens = project(v, cfg, vit(v, cfg, images))
    x, routes = decoder(t, cfg, tokens, ids, attn)
    p = tokens.shape[1]
    img = x[:, :p].mean(dim=1) @ v["fc.weight"].T + v["fc.bias"]
    w = attn.float()[..., None]
    txt = (x[:, p:] * w).sum(dim=1) / w.sum(dim=1).clamp_min(1e-9)
    txt = txt @ t["proj.weight"].T + t["proj.bias"]
    return torch.cat([normalized(img), normalized(txt)], dim=-1), routes
