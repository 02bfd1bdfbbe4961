"""The OutfitX set transformer: outfit encoder and task heads.

The port of ``outfitx_tpu/models/outfit_transformer.py``. Parameter names
follow the reference system's torch ``OutfitX.state_dict()`` (the layout
``outfitx_tpu/models/export_torch.py`` writes), so a JAX parameter tree
becomes this module's state dict through one mapping
(``models/from_jax.py``) and loads with ``load_state_dict(strict=True)``.

Numerics follow the JAX forward:
- parameters are stored in float32 and cast to the compute dtype (bfloat16
  by default) where they are used;
- the residual stream stays in the compute dtype, not float32;
- each matrix product returns the compute dtype and its bias is added in
  the compute dtype after it;
- the prefix token (CP outfit token, CIR target token) is never masked;
- scores and CIR embeddings are returned in float32.

Dropout (train mode, ``model.train()``) sits at the JAX package's sites: the
attention output before its residual add, the FFN hidden state after the
activation, the FFN output, and the CP head's token state (the CIR head has
none). There is no attention-probability dropout (the JAX package folds it
into the output dropout). Masks come from ``core.rng.keep_mask`` with a
``torch.Generator`` the caller passes in, scaled by the actual keep
probability. A serving build (the default) has no trainable parameter; a
training build (``trainable=True``) has trainable float32 parameters.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from outfitx_tpu_torch.core import dtypes
from outfitx_tpu_torch.core import rng as rng_ops
from outfitx_tpu_torch.core.config import OutfitXConfig
from outfitx_tpu_torch.core.device import resolve_device
from outfitx_tpu_torch.ops import layer_norm, masked_mha, resolve_activation
from outfitx_tpu_torch.ops.attn_block import attn_block


def _dropout(x, rate: float, gen: Optional[torch.Generator]):
    """Inverted dropout at ``rate`` with a mask from ``gen``; identity at
    rate 0 (eval mode passes 0)."""
    if rate == 0.0:
        return x
    if gen is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep, q = rng_ops.keep_mask(gen, rate, x.shape, x.device)
    return torch.where(keep, x / q, torch.zeros_like(x))


def _dense(x, weight, bias=None):
    """x @ weight.T (+ bias), both in x's dtype, the bias added after the
    product's rounding (not fused into it)."""
    y = torch.matmul(x, weight.to(x.dtype).T)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


class _Linear(nn.Module):
    """Holds a torch-layout (out, in) weight and an optional bias."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        return _dense(x, self.weight, self.bias)


class _LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class _SelfAttention(nn.Module):
    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        # Fused Q/K/V projection, rows [Wq; Wk; Wv], as torch's MHA stores it.
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = _Linear(d, d)
        self._block = {}  # dtype -> (parameter versions, block weights)

    def _block_weights(self, dtype):
        """The block kernel's layouts in ``dtype``: wqkv (d, 3, d) and wo
        (d, d) as (in, out), bqkv (3, d). Made once and cached; made again
        after the parameters change in place (a state dict load, an
        optimizer step)."""
        params = (self.in_proj_weight, self.in_proj_bias, self.out_proj.weight)
        versions = tuple((p.data_ptr(), p._version) for p in params)
        hit = self._block.get(dtype)
        if hit is None or hit[0] != versions:
            d = self.in_proj_weight.shape[1]
            with torch.no_grad():
                wqkv = self.in_proj_weight.view(3, d, d).permute(2, 0, 1)
                weights = tuple(
                    t.to(dtype).contiguous()
                    for t in (wqkv, self.in_proj_bias.view(3, d), self.out_proj.weight.T)
                )
            hit = self._block[dtype] = (versions, weights)
        return hit[1]

    def forward(self, y, pad_mask, block: bool = False):
        b, s, d = y.shape
        h = self.n_heads
        if block:
            # The JAX package's OUTFITX_ATTN_BLOCK=fused route: the block's
            # float32 output cast to y's dtype, then the out-projection bias.
            wqkv, bqkv, wo = self._block_weights(y.dtype)
            o = attn_block(y, wqkv, bqkv, wo, pad_mask, h).to(y.dtype)
            return o + self.out_proj.bias.to(y.dtype)
        qkv = _dense(y, self.in_proj_weight, self.in_proj_bias)  # (B, S, 3d)
        qkv = qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4).contiguous()
        o = masked_mha(qkv[0], qkv[1], qkv[2], pad_mask)  # (B, H, S, Dh)
        o = o.transpose(1, 2).reshape(b, s, d)
        return self.out_proj(o)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: OutfitXConfig, attn: str = "mha"):
        super().__init__()
        self.attn = attn
        d = cfg.d_embed
        t = cfg.transformer
        self.norm_first = t.norm_first
        self.dropout = t.dropout
        self.act = resolve_activation(t.activation)
        self.self_attn = _SelfAttention(d, t.n_heads)
        # The JAX package zero-pads the hidden width to ffn_pad_to at apply
        # time for TPU tile alignment. That pad is numerically inert (act(0)
        # = 0 for every activation here, and the padded rows of w2 are zero),
        # so the port computes at d_ffn and ignores ffn_pad_to.
        self.linear1 = _Linear(d, t.d_ffn)
        self.linear2 = _Linear(t.d_ffn, d)
        self.norm1 = _LayerNorm(d)
        self.norm2 = _LayerNorm(d)

    def forward(self, x, pad_mask, gen=None):
        rate = self.dropout if self.training else 0.0
        y = self.norm1(x) if self.norm_first else x
        block = self.attn == "block" and not self.training
        x = x + _dropout(self.self_attn(y, pad_mask, block), rate, gen)
        if not self.norm_first:
            x = self.norm1(x)
        y = self.norm2(x) if self.norm_first else x
        hidden = _dropout(self.act(self.linear1(y)), rate, gen)
        x = x + _dropout(self.linear2(hidden), rate, gen)
        if not self.norm_first:
            x = self.norm2(x)
        return x


class _Encoder(nn.Module):
    def __init__(self, cfg: OutfitXConfig, attn: str = "mha"):
        super().__init__()
        self.layers = nn.ModuleList(
            _EncoderLayer(cfg, attn) for _ in range(cfg.transformer.n_layers)
        )
        self.norm = _LayerNorm(cfg.d_embed) if cfg.transformer.final_norm else None

    def forward(self, x, pad_mask, gen=None):
        for layer in self.layers:
            x = layer(x, pad_mask, gen)
        if self.norm is not None:
            x = self.norm(x)
        return x


class OutfitXModel(nn.Module):
    """Set transformer with the CP and CIR/FITB heads.

    Weights are random, drawn from ``seed`` with the JAX package's
    distributions (not its numbers), until a state dict is loaded. With
    ``trainable`` the parameters take gradients; otherwise (serving) none
    does. ``attn="block"`` runs each layer's attention as one fused block
    (``ops.attn_block``: QKV projection, masked attention, out-projection)
    when the model is not training, as the JAX package's
    ``OUTFITX_ATTN_BLOCK=fused`` does; the default ``"mha"`` runs the
    projections as products around ``masked_mha``.
    """

    def __init__(
        self,
        cfg: Optional[OutfitXConfig] = None,
        *,
        device: str | torch.device = "cuda",
        seed: int = 0,
        trainable: bool = False,
        attn: str = "mha",
    ):
        super().__init__()
        if attn not in ("mha", "block"):
            raise ValueError(f"attn must be 'mha' or 'block', got {attn!r}")
        self.cfg = cfg = cfg or OutfitXConfig()
        dev = resolve_device(device)
        d = cfg.d_embed
        self.transformer_encoder = _Encoder(cfg, attn)
        self.outfit_token = nn.Parameter(torch.empty(d))
        self.target_item_image_emb = nn.Parameter(torch.empty(d // 2))
        # Index 0 is the reference's dropout slot; the head's dropout is
        # applied in cp_forward.
        self.cp_ffn = nn.Sequential(nn.Identity(), _Linear(d, 1))
        self.cir_ffn = nn.Sequential(_Linear(d, d, bias=False))
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(device=dev, dtype=dtypes.resolve(cfg.param_dtype))
        self.requires_grad_(trainable)
        self.eval()  # dropout only after an explicit .train()

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator):
        cfg = self.cfg
        d, ffn = cfg.d_embed, cfg.transformer.d_ffn

        def uniform_(p, bound):
            p.uniform_(-bound, bound, generator=gen)

        bd, bf = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ffn)
        for layer in self.transformer_encoder.layers:
            attn = layer.self_attn
            # Xavier-uniform for each of Q, K and V; zero projection biases.
            uniform_(attn.in_proj_weight, math.sqrt(6.0 / (2 * d)))
            attn.in_proj_bias.zero_()
            uniform_(attn.out_proj.weight, bd)
            attn.out_proj.bias.zero_()
            uniform_(layer.linear1.weight, bd)
            uniform_(layer.linear1.bias, bd)
            uniform_(layer.linear2.weight, bf)
            uniform_(layer.linear2.bias, bf)
        self.outfit_token.normal_(0.0, 0.02, generator=gen)
        self.target_item_image_emb.normal_(0.0, 0.02, generator=gen)
        uniform_(self.cp_ffn[1].weight, bd)
        uniform_(self.cp_ffn[1].bias, bd)
        uniform_(self.cir_ffn[0].weight, bd)

    @property
    def compute_dtype(self) -> torch.dtype:
        return dtypes.resolve(self.cfg.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.outfit_token.device

    def encode_set(self, tokens, pad_mask, generator=None):
        """tokens (B, S, D), pad_mask (B, S) bool with True = pad ->
        states (B, S, D) in the compute dtype. In train mode ``generator``
        draws the dropout masks."""
        return self.transformer_encoder(
            tokens.to(self.compute_dtype), pad_mask, generator
        )

    def _with_prefix(self, prefix, outfit_embedding, outfit_mask, generator):
        b = outfit_embedding.shape[0]
        x = torch.cat([prefix, outfit_embedding.to(self.compute_dtype)], dim=1)
        keep = torch.zeros((b, 1), dtype=torch.bool, device=outfit_mask.device)
        mask = torch.cat([keep, outfit_mask], dim=1)
        return self.encode_set(x, mask, generator)

    def cp_forward(self, outfit_embedding, outfit_mask, *, generator=None):
        """Compatibility logits (B,) float32. outfit_embedding (B, L, D),
        outfit_mask (B, L) bool, True = pad."""
        cdt = self.compute_dtype
        b = outfit_embedding.shape[0]
        tok = self.outfit_token.to(cdt)[None, None, :].expand(b, 1, -1)
        states = self._with_prefix(tok, outfit_embedding, outfit_mask, generator)
        rate = self.cfg.transformer.dropout if self.training else 0.0
        token_state = _dropout(states[:, 0, :], rate, generator)
        return self.cp_ffn(token_state)[:, 0].float()

    def cir_forward(
        self, outfit_embedding, outfit_mask, target_item_text_embedding,
        *, generator=None,
    ):
        """Predicted target-item embedding (B, D) float32; the target token
        is the learned image half joined to the given text half (B, D/2)."""
        cdt = self.compute_dtype
        b = outfit_embedding.shape[0]
        img = self.target_item_image_emb.to(cdt)[None, :].expand(b, -1)
        tok = torch.cat([img, target_item_text_embedding.to(cdt)], dim=-1)
        states = self._with_prefix(
            tok[:, None, :], outfit_embedding, outfit_mask, generator
        )
        return self.cir_ffn(states[:, 0, :]).float()

    # FITB shares the CIR forward.
    fitb_forward = cir_forward
