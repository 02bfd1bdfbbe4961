"""The ResNet-18 image tower of the ``resnet_sbert`` item encoder.

The port of ``outfitx_tpu/models/towers/resnet.py``: torchvision's
resnet18, frozen, with a fresh trainable ``fc`` head to ``d_out``. A 7x7/2
stem convolution, BatchNorm and ReLU, a 3x3/2 max-pool, four stages of two
basic blocks (64/128/256/512 channels, a strided 1x1 downsample at the
first block of stages 2-4), a global mean pool and ``fc``.

The tower runs NHWC (``torch.channels_last``) from its input to the global
pool: cuDNN's own layout on the card, so it converts nothing. Each frozen
BatchNorm is folded into the convolution before it at every forward, from
the current statistics, in float32: ``scale = weight * rsqrt(var + eps)``
multiplies the convolution's weight before its cast to the compute dtype,
and ``bias - mean * scale`` stays a float32 bias. One epilogue a
convolution (``ops/resnet_nhwc.py``) adds the bias, then the block's
residual, then applies ReLU, rounding once; a downsample's bias joins its
block's second epilogue. The stem, its convolution, max-pool, bias and
ReLU, is one call (``stem_conv_pool``), in bfloat16 on the card one kernel.
The JAX tower (NCHW, BatchNorm as a multiply-add after each convolution)
agrees to float32 round-off. Parameter names are torchvision's, so
``convert_resnet18`` only selects and widens a torchvision state dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from outfitx_tpu_torch.core import dtypes
from outfitx_tpu_torch.models.towers.common import as_f32, dense
from outfitx_tpu_torch.ops.resnet_nhwc import bias_add_relu, stem_conv_pool


@dataclasses.dataclass(frozen=True)
class ResNet18Config:
    d_out: int = 64  # the fresh fc head's width (dim_per_modality)
    image_size: int = 224
    stage_channels: tuple = (64, 128, 256, 512)
    blocks_per_stage: int = 2
    bn_eps: float = 1e-5
    compute_dtype: str = "bfloat16"  # "float32" for parity tests


class FrozenBatchNorm(nn.Module):
    """BatchNorm on stored statistics (torchvision names, without
    ``num_batches_tracked``), folded into the convolution before it."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def fold(self):
        """(scale, bias) in float32 from the current statistics."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale


class Conv(nn.Module):
    """A bias-free convolution, weight (Cout, Cin, K, K) in float32."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))

    def fold(self, bn: FrozenBatchNorm, dtype: torch.dtype):
        """(the weight with ``bn``'s scale folded in, in ``dtype``
        channels-last; ``bn``'s float32 bias, for an epilogue)."""
        scale, bias = bn.fold()
        w = self.weight * scale[:, None, None, None]
        return w.to(dtype, memory_format=torch.channels_last), bias

    def forward(self, x, bn: FrozenBatchNorm):
        """x NHWC -> (the convolution with ``bn``'s scale folded into its
        weight, NHWC in x's dtype; ``bn``'s float32 bias, for an epilogue)."""
        w, bias = self.fold(bn, x.dtype)
        return F.conv2d(x, w, stride=self.stride, padding=self.padding), bias


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, eps: float):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride, 1)
        self.bn1 = FrozenBatchNorm(cout, eps)
        self.conv2 = Conv(cout, cout, 3, 1, 1)
        self.bn2 = FrozenBatchNorm(cout, eps)
        # The JAX tower downsamples exactly where the block strides.
        self.downsample = (
            nn.Sequential(Conv(cin, cout, 1, stride), FrozenBatchNorm(cout, eps))
            if stride != 1 else None
        )

    def forward(self, x):
        y = bias_add_relu(*self.conv1(x, self.bn1))
        y, bias = self.conv2(y, self.bn2)
        if self.downsample is not None:
            x, shortcut_bias = self.downsample[0](x, self.downsample[1])
            bias = bias + shortcut_bias
        return bias_add_relu(y, bias, x)


class ResNet18(nn.Module):
    """images (B, 3, H, W) normalised -> (B, d_out) in the compute dtype."""

    def __init__(self, cfg: ResNet18Config):
        super().__init__()
        self.cfg = cfg
        eps = cfg.bn_eps
        self.conv1 = Conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64, eps)
        cin = 64
        for si, cout in enumerate(cfg.stage_channels):
            blocks = []
            for bi in range(cfg.blocks_per_stage):
                stride = 2 if bi == 0 and si > 0 else 1
                blocks.append(BasicBlock(cin if bi == 0 else cout, cout, stride, eps))
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
            cin = cout
        self.fc = nn.Linear(cfg.stage_channels[-1], cfg.d_out)

    def stages(self):
        return [getattr(self, f"layer{si + 1}") for si in range(len(self.cfg.stage_channels))]

    def init_weights_(self, gen: torch.Generator) -> None:
        """He-normal convolutions, identity BatchNorm, uniform(+-1/sqrt(512))
        ``fc``: the JAX tower's distributions."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
            bound = 1.0 / math.sqrt(self.cfg.stage_channels[-1])
            self.fc.weight.uniform_(-bound, bound, generator=gen)
            self.fc.bias.uniform_(-bound, bound, generator=gen)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, 3, H, W) normalised, in any layout and dtype -> (B,
        512) globally pooled, in the compute dtype."""
        dtype = dtypes.resolve(self.cfg.compute_dtype)
        x = images.to(dtype, memory_format=torch.channels_last)
        x = stem_conv_pool(x, *self.conv1.fold(self.bn1, dtype), self.conv1.stride,
                           self.conv1.padding)
        for stage in self.stages():
            x = stage(x)
        return x.mean(dim=(2, 3))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return dense(self.features(images), self.fc.weight, self.fc.bias)


def convert_resnet18(
    sd: Dict[str, object], d_out: int = 64, init_fc: Optional[Dict] = None
) -> Dict[str, torch.Tensor]:
    """A torchvision resnet18 state dict (tensors or numpy arrays) ->
    ``ResNet18``'s state dict in float32. torchvision's ``fc`` (512 ->
    1000) converts only when its width is ``d_out``; otherwise the fresh
    head ``init_fc`` ({'weight', 'bias'}) is taken, as the reference
    replaces it, and without one ``fc`` is left out."""
    out = {
        k: as_f32(v) for k, v in sd.items()
        if not k.startswith("fc.") and not k.endswith("num_batches_tracked")
    }
    if "fc.weight" in sd and tuple(np.shape(sd["fc.weight"]))[0] == d_out:
        out["fc.weight"], out["fc.bias"] = as_f32(sd["fc.weight"]), as_f32(sd["fc.bias"])
    elif init_fc is not None:
        out["fc.weight"], out["fc.bias"] = as_f32(init_fc["weight"]), as_f32(init_fc["bias"])
    return out
