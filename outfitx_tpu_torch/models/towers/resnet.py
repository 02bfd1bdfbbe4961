"""The ResNet-18 image tower of the ``resnet_sbert`` item encoder.

The port of ``outfitx_tpu/models/towers/resnet.py``: torchvision's
resnet18, frozen, with a fresh trainable ``fc`` head to ``d_out``. A 7x7/2
stem convolution, BatchNorm and ReLU, a 3x3/2 max-pool, four stages of two
basic blocks (64/128/256/512 channels, a strided 1x1 downsample at the
first block of stages 2-4), a global mean pool and ``fc``.

The JAX tower convolves in the torch layout end to end (NCHW activations,
OIHW weights, ``dimension_numbers=("NCHW", "OIHW", "NCHW")``), so
``F.conv2d`` takes its weights as they are. BatchNorm runs on its stored
statistics, folded as the JAX tower folds it: ``scale * rsqrt(var + eps)``
rounded to the activations' dtype, then ``bias - mean * scale``, then one
multiply-add. ``F.max_pool2d``'s implicit padding is -inf, as the JAX
``reduce_window`` with a -inf initial value. Parameter names are
torchvision's, so ``convert_resnet18`` only selects and widens a
torchvision state dict.
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


@dataclasses.dataclass(frozen=True)
class ResNet18Config:
    d_out: int = 64  # the fresh fc head's width (dim_per_modality)
    image_size: int = 224
    stage_channels: tuple = (64, 128, 256, 512)
    blocks_per_stage: int = 2
    bn_eps: float = 1e-5
    compute_dtype: str = "bfloat16"  # "float32" for parity tests


class FrozenBatchNorm(nn.Module):
    """BatchNorm in inference mode on stored statistics (torchvision
    names, without ``num_batches_tracked``)."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        scale = (self.weight * torch.rsqrt(self.running_var + self.eps)).to(x.dtype)
        bias = (self.bias - self.running_mean * scale).to(x.dtype)
        return x * scale[None, :, None, None] + bias[None, :, None, None]


class Conv(nn.Module):
    """A bias-free convolution whose weight (Cout, Cin, K, K) is cast to the
    activations' dtype where it is used."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))

    def forward(self, x):
        return F.conv2d(
            x, self.weight.to(x.dtype), stride=self.stride, padding=self.padding
        )


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
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


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

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(dtypes.resolve(self.cfg.compute_dtype))
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage in self.stages():
            x = stage(x)
        x = x.mean(dim=(2, 3))  # global average pool
        return dense(x, self.fc.weight, self.fc.bias)


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
