"""The transformer-encoder core shared by the frozen CLIP and SigLIP towers.

The port of ``outfitx_tpu/models/towers/common.py``: pre-LN residual blocks,
``x = x + attn(ln1(x)); x = x + mlp(ln2(x))``, with biased Q/K/V/out
projections. Parameters are float32 ``nn.Linear``s in torch's (out, in)
layout; they are cast to the activations' dtype where they are used, each
product returns that dtype and its bias is added after it, as the JAX
``linear`` does.

The JAX package picks its attention and MLP formulations from environment
variables at call time; here they are arguments of the encoder:

- ``attn="mha"``: per-projection products and ``masked_mha`` (the
  hand-written attention kernel on the card) at every length;
- ``attn="block"``: the fused attention block ``attn_block`` where the JAX
  shape guard lets it through (non-causal, 32 < L <= 64, L a multiple of 8:
  the SigLIP text tower), ``masked_mha`` elsewhere;
- ``mlp="plain"``: two products with the activation between them;
- ``mlp="fused"``: ``mlp_fused``, the mid tensor kept on chip.

The towers are frozen, so the layouts the two fused kernels read (the
stacked ``(d, 3, d)`` / ``(3, d)`` projection and the (in, out) matrices, in
the compute dtype) are built once per dtype and device and kept; loading a
state dict drops them. The JAX ``xla``, padded ``pallas`` and ``flash``
routes are TPU formulations of the same function and have no counterpart.

MoonViT (``towers/moonvit.py``, no JAX counterpart) runs on the same
blocks: its weights are made on the card in bfloat16 (``dtype`` and
``device``), and a ``rotary`` function turns each layer's q and k, (B, H,
S, Dh), before the attention.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from outfitx_tpu_torch.models.outfit_transformer import _dense as dense
from outfitx_tpu_torch.ops.activations import TOWER_ACTIVATIONS
from outfitx_tpu_torch.ops.attention import masked_mha
from outfitx_tpu_torch.ops.attn_block import attn_block
from outfitx_tpu_torch.ops.layernorm import layer_norm
from outfitx_tpu_torch.ops.mlp import mlp_fused

ATTN_ROUTES = ("mha", "block")
MLP_ROUTES = ("plain", "fused")


def as_f32(x) -> torch.Tensor:
    """A weight (tensor or numpy array) as a float32 tensor of its own."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def init_linear_(lin: nn.Linear, gen: torch.Generator) -> None:
    """uniform(+-1/sqrt(d_in)) for weight and bias, as the JAX towers."""
    bound = 1.0 / math.sqrt(lin.in_features)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=gen)
        if lin.bias is not None:
            lin.bias.uniform_(-bound, bound, generator=gen)


class LayerNorm(nn.Module):
    """Scale and bias of a LayerNorm over the last axis, with its eps."""

    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


class TowerLayer(nn.Module):
    def __init__(self, d: int, d_mlp: int, ln_eps: float, dtype=None, device=None):
        super().__init__()
        lin = dict(dtype=dtype, device=device)
        self.ln1 = LayerNorm(d, ln_eps, device)
        self.ln2 = LayerNorm(d, ln_eps, device)
        self.q = nn.Linear(d, d, **lin)
        self.k = nn.Linear(d, d, **lin)
        self.v = nn.Linear(d, d, **lin)
        self.o = nn.Linear(d, d, **lin)
        self.fc1 = nn.Linear(d, d_mlp, **lin)
        self.fc2 = nn.Linear(d_mlp, d, **lin)

    def linears(self):
        return (self.q, self.k, self.v, self.o, self.fc1, self.fc2)


class TowerEncoder(nn.Module):
    """``n_layers`` pre-LN blocks over (B, S, d) activations; the linears
    in ``dtype`` on ``device`` where given (float32 on the host if not), the
    LayerNorms in float32."""

    def __init__(
        self, *, d: int, n_heads: int, d_mlp: int, n_layers: int, act: str,
        ln_eps: float = 1e-5, attn: str = "mha", mlp: str = "plain", dtype=None, device=None,
    ):
        super().__init__()
        if attn not in ATTN_ROUTES:
            raise ValueError(f"attn must be one of {ATTN_ROUTES}, got {attn!r}")
        if mlp not in MLP_ROUTES:
            raise ValueError(f"mlp must be one of {MLP_ROUTES}, got {mlp!r}")
        if act not in TOWER_ACTIVATIONS:
            raise ValueError(f"unknown activation {act!r}")
        self.n_heads = n_heads
        self.act = act
        self.attn = attn
        self.mlp = mlp
        self.layers = nn.ModuleList(
            TowerLayer(d, d_mlp, ln_eps, dtype, device) for _ in range(n_layers)
        )
        self._fused: Dict[Tuple[str, torch.dtype, torch.device], list] = {}
        self.register_load_state_dict_post_hook(
            lambda module, incompatible: module._fused.clear()
        )

    def init_weights_(self, gen: torch.Generator) -> None:
        for layer in self.layers:
            for lin in layer.linears():
                init_linear_(lin, gen)

    # ---------------------------------------------------- fused layouts --
    def _block_weights(self, dtype, device):
        """Per layer (wqkv (d, 3, d), bqkv (3, d), wo (d, d) as (in, out))."""
        key = ("block", dtype, device)
        if key not in self._fused:
            with torch.no_grad():
                self._fused[key] = [
                    (
                        torch.stack(
                            [lin.weight.T for lin in (lyr.q, lyr.k, lyr.v)], dim=1
                        ).to(dtype).contiguous(),
                        torch.stack(
                            [lin.bias for lin in (lyr.q, lyr.k, lyr.v)], dim=0
                        ).to(dtype).contiguous(),
                        lyr.o.weight.T.to(dtype).contiguous(),
                    )
                    for lyr in self.layers
                ]
        return self._fused[key]

    def _mlp_weights(self, dtype, device):
        """Per layer (w1 (d, d_mlp), b1, w2 (d_mlp, d), b2) in ``dtype``."""
        key = ("mlp", dtype, device)
        if key not in self._fused:
            with torch.no_grad():
                self._fused[key] = [
                    (
                        lyr.fc1.weight.T.to(dtype).contiguous(),
                        lyr.fc1.bias.to(dtype).contiguous(),
                        lyr.fc2.weight.T.to(dtype).contiguous(),
                        lyr.fc2.bias.to(dtype).contiguous(),
                    )
                    for lyr in self.layers
                ]
        return self._fused[key]

    def takes_block(self, s: int, causal: bool) -> bool:
        """The JAX package's shape guard of the block route."""
        return self.attn == "block" and not causal and 32 < s <= 64 and s % 8 == 0

    # ------------------------------------------------------------ apply --
    def forward(
        self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
        causal: bool = False, rotary: Optional[Callable] = None,
    ) -> torch.Tensor:
        """x (B, S, d); pad_mask (B, S) bool, True = pad; ``rotary`` maps q
        and k (B, H, S, Dh) to their turned copies (the block route takes
        none); returns (B, S, d) in x's dtype."""
        b, s, d = x.shape
        h_n = self.n_heads
        if pad_mask is None:
            pad_mask = torch.zeros((b, s), dtype=torch.bool, device=x.device)
        pad_mask = pad_mask.contiguous()
        use_block = self.takes_block(s, causal) and rotary is None
        block_w = self._block_weights(x.dtype, x.device) if use_block else None
        mlp_w = self._mlp_weights(x.dtype, x.device) if self.mlp == "fused" else None
        act_fn = TOWER_ACTIVATIONS[self.act]

        def heads(t):
            return t.view(b, s, h_n, d // h_n).transpose(1, 2).contiguous()

        h = x
        for i, layer in enumerate(self.layers):
            y = layer.ln1(h)
            if use_block:
                wqkv, bqkv, wo = block_w[i]
                o = attn_block(
                    y.contiguous(), wqkv, bqkv, wo, pad_mask, h_n, causal=causal
                ).to(h.dtype)
                h = h + o + layer.o.bias.to(h.dtype)
            else:
                q, k, v = (
                    heads(dense(y, lin.weight, lin.bias))
                    for lin in (layer.q, layer.k, layer.v)
                )
                if rotary is not None:
                    q, k = rotary(q), rotary(k)
                o = masked_mha(q, k, v, pad_mask, causal)
                o = o.transpose(1, 2).reshape(b, s, d)
                h = h + dense(o, layer.o.weight, layer.o.bias)
            y = layer.ln2(h)
            if mlp_w is not None:
                h = h + mlp_fused(y.contiguous(), *mlp_w[i], act=self.act)
            else:
                mid = act_fn(dense(y, layer.fc1.weight, layer.fc1.bias))
                h = h + dense(mid, layer.fc2.weight, layer.fc2.bias)
        return h
