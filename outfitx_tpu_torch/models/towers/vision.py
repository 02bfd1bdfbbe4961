"""Vision towers: the CLIP ViT and the SigLIP ViT.

The port of ``outfitx_tpu/models/towers/vision.py``. The patch embedding is
a reshape and one product over (B N, 3 P P) x (3 P P, D); inputs stay
channel-first so the patch pixel order is that of a torch Conv2d weight
(D, 3, P, P). CLIP prepends a class token, normalises before the encoder and
projects the class token's state; SigLIP has no class token (ViT-B/16 at 224
pixels: 196 tokens), normalises every token after the encoder and pools with
its attention head (``_map_pool``: one probe query, plain products outside
any kernel, as in the JAX package).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from outfitx_tpu_torch.core import dtypes
from outfitx_tpu_torch.models.towers.common import (
    LayerNorm,
    TowerEncoder,
    dense,
    init_linear_,
)
from outfitx_tpu_torch.ops.activations import gelu_tanh


@dataclasses.dataclass(frozen=True)
class VisionTowerConfig:
    variant: str = "clip"  # {'clip', 'siglip'}
    image_size: int = 224
    patch_size: int = 32
    d_model: int = 768
    n_heads: int = 12
    d_mlp: int = 3072
    n_layers: int = 12
    proj_dim: int = 512  # CLIP visual projection; ignored for siglip
    act: str = "quick_gelu"  # siglip: 'gelu_tanh'
    ln_eps: float = 1e-5  # siglip: 1e-6
    # LayerNorm and softmax stay float32 inside; "float32" for parity tests.
    compute_dtype: str = "bfloat16"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.n_patches + (1 if self.variant == "clip" else 0)

    @property
    def d_out(self) -> int:
        return self.proj_dim if self.variant == "clip" else self.d_model

    @classmethod
    def clip_b32(cls) -> "VisionTowerConfig":
        """fashion-clip / CLIP ViT-B/32."""
        return cls()

    @classmethod
    def siglip_b16(cls) -> "VisionTowerConfig":
        """marqo-fashionSigLIP (SigLIP ViT-B/16)."""
        return cls(
            variant="siglip", patch_size=16, act="gelu_tanh", proj_dim=768,
            ln_eps=1e-6,
        )


class _MapHead(nn.Module):
    """SigLIP's attention-pooling head: a probe query, Q/K/V/out
    projections, a LayerNorm and a residual MLP."""

    def __init__(self, d: int, d_mlp: int, ln_eps: float):
        super().__init__()
        self.probe = nn.Parameter(torch.empty(d))
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.o = nn.Linear(d, d)
        self.ln = LayerNorm(d, ln_eps)
        self.fc1 = nn.Linear(d, d_mlp)
        self.fc2 = nn.Linear(d_mlp, d)


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionTowerConfig, *, attn: str = "mha", mlp: str = "plain"):
        super().__init__()
        if cfg.variant not in ("clip", "siglip"):
            raise ValueError(f"unknown vision tower variant {cfg.variant!r}")
        self.cfg = cfg
        d = cfg.d_model
        self.patch = nn.Linear(3 * cfg.patch_size**2, d, bias=cfg.variant == "siglip")
        self.pos_emb = nn.Parameter(torch.empty(cfg.seq_len, d))
        self.encoder = TowerEncoder(
            d=d, n_heads=cfg.n_heads, d_mlp=cfg.d_mlp, n_layers=cfg.n_layers,
            act=cfg.act, ln_eps=cfg.ln_eps, attn=attn, mlp=mlp,
        )
        self.post_ln = LayerNorm(d, cfg.ln_eps)
        if cfg.variant == "clip":
            self.cls = nn.Parameter(torch.empty(d))
            self.pre_ln = LayerNorm(d, cfg.ln_eps)
            self.proj = nn.Linear(d, cfg.proj_dim, bias=False)
        else:
            self.map = _MapHead(d, cfg.d_mlp, cfg.ln_eps)

    def init_weights_(self, gen: torch.Generator) -> None:
        """Random weights with the JAX tower's distributions."""
        with torch.no_grad():
            init_linear_(self.patch, gen)
            self.pos_emb.normal_(0.0, 0.02, generator=gen)
            self.encoder.init_weights_(gen)
            if self.cfg.variant == "clip":
                self.cls.normal_(0.0, 0.02, generator=gen)
                init_linear_(self.proj, gen)
            else:
                self.map.probe.normal_(0.0, 0.02, generator=gen)
                for lin in (self.map.q, self.map.k, self.map.v, self.map.o,
                            self.map.fc1, self.map.fc2):
                    init_linear_(lin, gen)

    def patchify(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, N, 3 P P), channel-first patch pixel order."""
        cfg = self.cfg
        b = images.shape[0]
        g = cfg.image_size // cfg.patch_size
        p = cfg.patch_size
        x = images.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
        return x.reshape(b, g * g, 3 * p * p)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Preprocessed images (B, 3, H, W) -> (B, d_out) embeddings in the
        compute dtype."""
        cfg = self.cfg
        b = images.shape[0]
        images = images.to(dtypes.resolve(cfg.compute_dtype))
        x = dense(self.patchify(images), self.patch.weight, self.patch.bias)
        if cfg.variant == "clip":
            cls = self.cls.to(x.dtype)[None, None].expand(b, 1, cfg.d_model)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_emb.to(x.dtype)[None]
        if cfg.variant == "clip":
            x = self.pre_ln(x)
        x = self.encoder(x)
        if cfg.variant == "clip":
            return dense(self.post_ln(x[:, 0]), self.proj.weight)
        return self._map_pool(self.post_ln(x))

    def _map_pool(self, x: torch.Tensor) -> torch.Tensor:
        """The probe query attends over the tokens; residual MLP; (B, D)."""
        mp = self.map
        b, s, d = x.shape
        h = self.cfg.n_heads
        dh = d // h
        probe = mp.probe.to(x.dtype)[None, None].expand(b, 1, d)

        def heads(t, n):
            return t.view(b, n, h, dh).transpose(1, 2)

        q = heads(dense(probe, mp.q.weight, mp.q.bias), 1)
        k = heads(dense(x, mp.k.weight, mp.k.bias), s)
        v = heads(dense(x, mp.v.weight, mp.v.bias), s)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (dh**0.5)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(b, 1, d)
        o = dense(o, mp.o.weight, mp.o.bias)
        mid = gelu_tanh(dense(mp.ln(o), mp.fc1.weight, mp.fc1.bias))
        o = o + dense(mid, mp.fc2.weight, mp.fc2.bias)
        return o[:, 0]
