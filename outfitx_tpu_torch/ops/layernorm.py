"""LayerNorm over the last axis, plain PyTorch.

Statistics in float32, eps 1e-5, output in the input dtype, as the JAX
package's ``_ln_reference``. Its Pallas kernel (``outfitx_tpu/ops/
layernorm.py:_ln_kernel``) is off the serving path there (``auto`` resolves
to XLA) and is ported in a later slice.
"""

from __future__ import annotations

import torch

_EPS = 1e-5


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = _EPS,
) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)
