"""The int8 (W8A8) serving forward of the OutfitX set transformer.

The port of ``outfitx_tpu/models/quantized.py``. Serving-only quantization
of the large products (the QKV, attention-out and FFN projections and the
CIR projection) to int8 x int8 -> int32:

- weights: per-output-channel symmetric int8 (scale = max|row| / 127 over
  the contraction dim), quantized once from a float32 state dict
  (``quantize_outfitx_params``);
- activations: per-token symmetric int8 (scale = max|row| / 127), quantized
  on the fly (``q8_dot``);
- everything else (LayerNorm, the attention core, the residual stream, the
  biases, the CP head's d -> 1 product) stays in the compute dtype, as in
  ``OutfitXModel``.

The int8 product is ``torch._int_mm``, a library product as the JAX package
leaves its int8 ``dot_general`` to XLA; the attention core is
``ops.masked_mha`` and the LayerNorms are ``ops.layer_norm``, the
hand-written kernels on the card. The orders that decide the roundings
follow the JAX forward, and differ from ``OutfitXModel``'s ``_dense``: a
projection's bias is added to the float32 dequantized product and the sum
is then rounded to the compute dtype, and the FFN's activation runs in
float32 before that rounding. There is no ``attn="block"`` route: the JAX
int8 forward has none either.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from outfitx_tpu_torch.core import dtypes
from outfitx_tpu_torch.core.config import OutfitXConfig
from outfitx_tpu_torch.core.device import resolve_device
from outfitx_tpu_torch.models.outfit_transformer import (
    OutfitXModel,
    _dense,
    _LayerNorm,
    _Linear,
)
from outfitx_tpu_torch.ops import masked_mha, resolve_activation

# torch._int_mm on the card refuses an operand of 16 rows or fewer; fewer
# rows are padded with zero rows up to this count (on the CPU as well).
INT_MM_MIN_ROWS = 17


def quantize_weight(w: torch.Tensor, dim: int):
    """Per-channel symmetric int8 of ``w`` over ``dim`` (the contraction
    dim): returns (int8 values of w's shape, float32 scales of w's shape
    without ``dim``). scale = max|w| / 127 over ``dim``; an all-zero channel
    (the FFN's pad) gets scale 1.0 and quantizes to exact zeros. Values
    round half to even (``torch.round``, as ``jnp.round``)."""
    w = w.float()
    absmax = w.abs().amax(dim=dim)
    scales = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    values = torch.clamp(torch.round(w / scales.unsqueeze(dim)), -127, 127)
    return values.to(torch.int8), scales


def q8_dot(x: torch.Tensor, values: torch.Tensor, scales: torch.Tensor):
    """``x @ W.T`` with per-token int8 activations: x (..., d_in) float,
    ``values`` int8 (d_out, d_in) and ``scales`` float32 (d_out,) from
    ``quantize_weight(W, dim=1)`` -> float32 (..., d_out).

    The token scale is ``sx = max|x| / 127`` (1 for an all-zero token), the
    int32 product is dequantized as ``acc * sx * scales`` in that order.
    Fewer than ``INT_MM_MIN_ROWS`` token rows are padded with zero rows,
    which quantize to zero with scale 1 and are sliced away: the scale is
    per token, so a pad row cannot touch a real one."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    rows = xq.reshape(-1, xq.shape[-1])
    m = rows.shape[0]
    if m < INT_MM_MIN_ROWS:
        rows = F.pad(rows, (0, 0, 0, INT_MM_MIN_ROWS - m))
    acc = torch._int_mm(rows, values.t())[:m]
    return acc.reshape(*xq.shape[:-1], -1).float() * sx * scales


class QLinear(nn.Module):
    """An int8 weight (d_out, d_in), its float32 channel scales and an
    optional float32 bias, all buffers. Returns the float32 product with
    the bias added in float32."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.register_buffer("values", torch.zeros((d_out, d_in), dtype=torch.int8))
        self.register_buffer("scales", torch.ones(d_out))
        self.register_buffer("bias", torch.zeros(d_out) if bias else None)

    def forward(self, x):
        y = q8_dot(x, self.values, self.scales)
        return y if self.bias is None else y + self.bias


def _ffn_width(cfg: OutfitXConfig) -> int:
    """The FFN's quantized width: d_ffn zero-padded to ffn_pad_to."""
    return max(cfg.transformer.ffn_pad_to, cfg.transformer.d_ffn)


class _QAttention(nn.Module):
    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj = QLinear(d, 3 * d)  # rows [Wq; Wk; Wv]
        self.out_proj = QLinear(d, d)

    def forward(self, y, pad_mask):
        b, s, d = y.shape
        h = self.n_heads
        qkv = self.in_proj(y).to(y.dtype)
        qkv = qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4).contiguous()
        o = masked_mha(qkv[0], qkv[1], qkv[2], pad_mask)  # (B, H, S, Dh)
        o = o.transpose(1, 2).reshape(b, s, d)
        return self.out_proj(o).to(y.dtype)


class _QEncoderLayer(nn.Module):
    def __init__(self, cfg: OutfitXConfig):
        super().__init__()
        d, t = cfg.d_embed, cfg.transformer
        self.norm_first = t.norm_first
        self.act = resolve_activation(t.activation)
        self.self_attn = _QAttention(d, t.n_heads)
        self.linear1 = QLinear(d, _ffn_width(cfg))
        self.linear2 = QLinear(_ffn_width(cfg), d)
        self.norm1 = _LayerNorm(d)
        self.norm2 = _LayerNorm(d)

    def forward(self, x, pad_mask):
        y = self.norm1(x) if self.norm_first else x
        x = x + self.self_attn(y, pad_mask)
        if not self.norm_first:
            x = self.norm1(x)
        y = self.norm2(x) if self.norm_first else x
        hidden = self.act(self.linear1(y)).to(x.dtype)
        x = x + self.linear2(hidden).to(x.dtype)
        if not self.norm_first:
            x = self.norm2(x)
        return x


class _QEncoder(nn.Module):
    def __init__(self, cfg: OutfitXConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            _QEncoderLayer(cfg) for _ in range(cfg.transformer.n_layers)
        )
        self.norm = _LayerNorm(cfg.d_embed) if cfg.transformer.final_norm else None

    def forward(self, x, pad_mask):
        for layer in self.layers:
            x = layer(x, pad_mask)
        if self.norm is not None:
            x = self.norm(x)
        return x


class QuantizedOutfitX(nn.Module):
    """Eval-mode int8 twin of ``OutfitXModel``: the same task forwards with
    int8 projections. Its tables come from ``quantize_outfitx_params`` (or
    ``models/from_jax.py quantized_state_dict_from_jax``) through
    ``load_state_dict``; until then they are zeros. Nothing in it takes a
    gradient."""

    def __init__(
        self,
        cfg: Optional[OutfitXConfig] = None,
        *,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        self.cfg = cfg = cfg or OutfitXConfig()
        dev = resolve_device(device)
        d = cfg.d_embed
        self.transformer_encoder = _QEncoder(cfg)
        self.outfit_token = nn.Parameter(torch.zeros(d))
        self.target_item_image_emb = nn.Parameter(torch.zeros(d // 2))
        self.cp_ffn = nn.Sequential(nn.Identity(), _Linear(d, 1))
        self.cir_ffn = nn.Sequential(QLinear(d, d, bias=False))
        with torch.no_grad():
            for p in self.parameters():
                p.zero_()
        self.to(dev)
        self.requires_grad_(False)
        self.eval()

    @property
    def compute_dtype(self) -> torch.dtype:
        return dtypes.resolve(self.cfg.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.outfit_token.device

    def encode_set(self, tokens, pad_mask):
        """tokens (B, S, D), pad_mask (B, S) bool with True = pad ->
        states (B, S, D) in the compute dtype."""
        return self.transformer_encoder(tokens.to(self.compute_dtype), pad_mask)

    def _with_prefix(self, prefix, outfit_embedding, outfit_mask):
        b = outfit_embedding.shape[0]
        x = torch.cat([prefix, outfit_embedding.to(self.compute_dtype)], dim=1)
        keep = torch.zeros((b, 1), dtype=torch.bool, device=outfit_mask.device)
        return self.encode_set(x, torch.cat([keep, outfit_mask], dim=1))

    def cp_forward(self, outfit_embedding, outfit_mask):
        """Compatibility logits (B,) float32. The head is a compute-dtype
        product with its bias added after the rounding."""
        cdt = self.compute_dtype
        b = outfit_embedding.shape[0]
        tok = self.outfit_token.to(cdt)[None, None, :].expand(b, 1, -1)
        states = self._with_prefix(tok, outfit_embedding, outfit_mask)
        head = self.cp_ffn[1]
        return _dense(states[:, 0, :], head.weight, head.bias)[:, 0].float()

    def cir_forward(self, outfit_embedding, outfit_mask, target_item_text_embedding):
        """Predicted target-item embedding (B, D) float32: the int8 CIR
        projection, without bias."""
        cdt = self.compute_dtype
        b = outfit_embedding.shape[0]
        img = self.target_item_image_emb.to(cdt)[None, :].expand(b, -1)
        tok = torch.cat([img, target_item_text_embedding.to(cdt)], dim=-1)
        states = self._with_prefix(tok[:, None, :], outfit_embedding, outfit_mask)
        return self.cir_ffn(states[:, 0, :])

    # FITB shares the CIR forward.
    fitb_forward = cir_forward


def quantize_outfitx_params(
    state_dict: Dict[str, torch.Tensor], cfg: OutfitXConfig
) -> Dict[str, torch.Tensor]:
    """An ``OutfitXModel`` float32 state dict -> a ``QuantizedOutfitX``
    state dict, on the state dict's device.

    The FFN is zero-padded to ``ffn_pad_to`` before quantization
    (``linear1.weight`` gains zero rows and ``linear1.bias`` zeros,
    ``linear2.weight`` zero columns); zero channels are exact. Every
    projection is quantized per output channel, which for
    ``in_proj_weight`` (3d, d) is per row: its row order [Wq; Wk; Wv] is the
    channel order of the JAX package's (d, 3d) ``wqkv``. LayerNorms,
    biases, the prefix tokens and the CP head stay float32."""
    sd = {k: v.detach().float() for k, v in state_dict.items()}
    pad = _ffn_width(cfg) - cfg.transformer.d_ffn
    out: Dict[str, torch.Tensor] = {}

    def quantized(name, w, bias=None):
        out[name + ".values"], out[name + ".scales"] = quantize_weight(w, dim=1)
        if bias is not None:
            out[name + ".bias"] = bias

    for i in range(cfg.transformer.n_layers):
        p = f"transformer_encoder.layers.{i}."
        quantized(p + "self_attn.in_proj", sd[p + "self_attn.in_proj_weight"],
                  sd[p + "self_attn.in_proj_bias"])
        quantized(p + "self_attn.out_proj", sd[p + "self_attn.out_proj.weight"],
                  sd[p + "self_attn.out_proj.bias"])
        quantized(p + "linear1", F.pad(sd[p + "linear1.weight"], (0, 0, 0, pad)),
                  F.pad(sd[p + "linear1.bias"], (0, pad)))
        quantized(p + "linear2", F.pad(sd[p + "linear2.weight"], (0, pad)),
                  sd[p + "linear2.bias"])
        for norm in ("norm1", "norm2"):
            for leaf in ("weight", "bias"):
                out[f"{p}{norm}.{leaf}"] = sd[f"{p}{norm}.{leaf}"]
    for name in (
        "transformer_encoder.norm.weight", "transformer_encoder.norm.bias",
        "outfit_token", "target_item_image_emb", "cp_ffn.1.weight", "cp_ffn.1.bias",
    ):
        if name in sd:
            out[name] = sd[name]
    quantized("cir_ffn.0", sd["cir_ffn.0.weight"])
    return out


def quantized_twin(model: OutfitXModel) -> QuantizedOutfitX:
    """The int8 twin of a trained ``OutfitXModel``, on its device."""
    twin = QuantizedOutfitX(model.cfg, device=model.device)
    twin.load_state_dict(quantize_outfitx_params(model.state_dict(), model.cfg))
    return twin
