"""MoonViT and its projector: the image half of the ``kimivl_a3b`` joint
item encoder (moonshotai/Kimi-VL-A3B-Instruct's ``vision_config`` and the
Kimi-VL report, arXiv:2504.07491; no TPU counterpart).

An image of S x S pixels (S a multiple of 28) is a g x g grid of 14 x 14
patches, g = S / 14 (16 at 224 pixels), taken row by row:

- the patch embedding, one product over (B N, 3 P P) x (3 P P, d) in the
  pixel order of a Conv2d(3, 1152, 14, stride 14) weight (a loader
  flattens the checkpoint's (d, 3, P, P) kernel), with its bias;
- a learned 64 x 64 x 1,152 position table, interpolated to g x g by
  ``F.interpolate(..., mode="bicubic")`` (align_corners False, in float32,
  rounded once) and added;
- 27 pre-LN blocks on ``towers/common.py``'s ``TowerEncoder``, ``x += Wo
  attn(LN0 x)``, ``x += fc2 gelu_tanh(fc1 LN1 x)``, 16 heads of Dh 72, q k v
  and o with biases (a loader cuts the checkpoint's ``wqkv`` into q, k and
  v by rows), LayerNorm eps 1e-5, attention not causal through
  ``masked_mha`` (the bfloat16 tile route at L = 256, Dh = 72);
- the 2D rotary on q and k of each head, in float32: the head's 72
  columns are 36 pairs (2j, 2j + 1), and pair j turns by col w_(j // 2)
  for even j and by row w_(j // 2) for odd j, w_i = 10000^(-4 i / 72) (the
  checkpoint's own interleaved layout: no permutation);
- the final LayerNorm.

``project`` merges each 2 x 2 block of the grid into one token of 4 x d:
the LayerNorm of the projector on each d-vector, the grid (g, g, d) viewed
as (g/2, 2, g/2, 2, d) and laid out (g/2, g/2, 2, 2, d), then Linear(4 d,
4 d), gelu (erf) and Linear(4 d, d_text): 64 tokens of the decoder's
width at 224 pixels.

The tower is frozen: its weights are bfloat16, made and drawn on its
device (``init_weights_``: N(0, init_std) matrices, biases and table,
LayerNorm scales 1 and shifts 0, kept in float32). Its one trainable part
is ``fc``, the fresh head (d_text -> d_out, float32) that the joint encoder
applies to the decoder's mean over the image positions.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from outfitx_tpu_torch.core import dtypes
from outfitx_tpu_torch.models.towers.common import LayerNorm, TowerEncoder, dense, init_linear_
from outfitx_tpu_torch.ops.activations import gelu


@dataclasses.dataclass(frozen=True)
class MoonViTConfig:
    image_size: int = 224
    patch_size: int = 14
    d_model: int = 1152
    n_heads: int = 16
    d_mlp: int = 4304
    n_layers: int = 27
    pos_grid: int = 64  # init_pos_emb_height = init_pos_emb_width
    merge: int = 2  # merge_kernel_size, each way
    ln_eps: float = 1e-5
    rope_theta: float = 10000.0
    d_text: int = 2048  # the projector's output: the decoder's hidden size
    d_out: int = 64  # the fresh fc head's width (dim_per_modality)
    init_std: float = 0.02
    compute_dtype: str = "bfloat16"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def n_tokens(self) -> int:
        """Image tokens handed to the decoder."""
        return (self.grid // self.merge) ** 2


def rotary_tables(cfg: MoonViTConfig, device=None):
    """cos, sin (g g, Dh / 2) float32 of the 2D rotary: token n = (row,
    col) = divmod(n, g); pair j's angle col w_(j // 2) (j even) or row
    w_(j // 2) (j odd), w_i = theta^(-4 i / Dh)."""
    dh, g = cfg.d_model // cfg.n_heads, cfg.grid
    w = 1.0 / cfg.rope_theta ** (torch.arange(0, dh, 4, dtype=torch.float64)[: dh // 4] / dh)
    n = torch.arange(g * g, dtype=torch.float64)
    row, col = torch.div(n, g, rounding_mode="floor"), n % g
    angles = torch.stack([torch.outer(col, w), torch.outer(row, w)], dim=-1).flatten(1)
    return angles.cos().float().to(device), angles.sin().float().to(device)


def rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., N, Dh) with pairs (2j, 2j + 1) turned by cos, sin (N, Dh /
    2), in float32; the result in x's dtype."""
    xf = x.float().unflatten(-1, (-1, 2))
    a, b = xf[..., 0], xf[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).flatten(-2).to(x.dtype)


class MoonViT(nn.Module):
    # Made and drawn on the device (``init_weights_``), never on the host.
    made_on_device = True

    def __init__(self, cfg: MoonViTConfig, device: str | torch.device = "cpu"):
        super().__init__()
        if cfg.grid % cfg.merge or cfg.grid * cfg.patch_size != cfg.image_size:
            raise ValueError(f"image_size {cfg.image_size} is not a whole number of "
                             f"{cfg.merge} x {cfg.merge} blocks of {cfg.patch_size}-pixel patches")
        self.cfg = cfg
        d, dt = cfg.d_model, dtypes.resolve(cfg.compute_dtype)
        lin = dict(dtype=dt, device=device)
        self.patch = nn.Linear(3 * cfg.patch_size ** 2, d, **lin)
        self.pos_table = nn.Parameter(torch.empty(cfg.pos_grid, cfg.pos_grid, d, **lin))
        self.encoder = TowerEncoder(d=d, n_heads=cfg.n_heads, d_mlp=cfg.d_mlp,
                                    n_layers=cfg.n_layers, act="gelu_tanh", ln_eps=cfg.ln_eps,
                                    dtype=dt, device=device)
        self.final_ln = LayerNorm(d, cfg.ln_eps, device)
        wide = cfg.merge ** 2 * d
        self.proj_ln = LayerNorm(d, cfg.ln_eps, device)
        self.proj_in = nn.Linear(wide, wide, **lin)
        self.proj_out = nn.Linear(wide, cfg.d_text, **lin)
        self.fc = nn.Linear(cfg.d_text, cfg.d_out, device=device)
        cos, sin = rotary_tables(cfg, device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def init_weights_(self, gen: torch.Generator) -> None:
        """N(0, init_std) matrices, biases and position table, LayerNorms
        1 and 0, the head uniform(+-1/sqrt(d_in)), drawn on the tower's
        device from ``gen`` (a generator on that device)."""
        norms = {id(p) for m in self.modules() if isinstance(m, LayerNorm)
                 for p in m.parameters()}
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("fc."):
                    continue
                if id(p) in norms:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                else:
                    p.normal_(0.0, self.cfg.init_std, generator=gen)
            init_linear_(self.fc, gen)

    def patchify(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) -> (B, g g, 3 P P), rows of patches, each in the
        Conv2d weight's (channel, y, x) order."""
        b, g, p = images.shape[0], self.cfg.grid, self.cfg.patch_size
        x = images.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
        return x.reshape(b, g * g, 3 * p * p)

    def position_table(self, dtype) -> torch.Tensor:
        """The position table at the image's grid, (g g, d) in ``dtype``."""
        g = self.cfg.grid
        t = self.pos_table.float()
        if g != self.cfg.pos_grid:
            t = F.interpolate(t.permute(2, 0, 1)[None], size=(g, g), mode="bicubic",
                              align_corners=False)[0].permute(1, 2, 0)
        return t.reshape(g * g, -1).to(dtype)

    def rotary(self, x: torch.Tensor) -> torch.Tensor:
        return rotate_pairs(x, self.rope_cos, self.rope_sin)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """Normalised images (B, 3, S, S) -> (B, g g, d) final states in the
        compute dtype."""
        images = images.to(self.patch.weight.dtype)
        x = dense(self.patchify(images), self.patch.weight, self.patch.bias)
        x = x + self.position_table(x.dtype)
        return self.final_ln(self.encoder(x, rotary=self.rotary))

    def project(self, states: torch.Tensor) -> torch.Tensor:
        """(B, g g, d) -> (B, (g / 2)^2, d_text): the 2 x 2 merge and the
        projector."""
        b, _, d = states.shape
        h, m = self.cfg.grid // self.cfg.merge, self.cfg.merge
        x = self.proj_ln(states).view(b, h, m, h, m, d).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h * h, m * m * d)
        x = gelu(dense(x, self.proj_in.weight, self.proj_in.bias))
        return dense(x, self.proj_out.weight, self.proj_out.bias)

    def head(self, pooled: torch.Tensor) -> torch.Tensor:
        """The decoder's mean over the image positions (B, d_text) -> (B,
        d_out) through ``fc``."""
        return dense(pooled, self.fc.weight, self.fc.bias)
