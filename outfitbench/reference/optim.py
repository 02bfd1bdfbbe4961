"""AdamW with a global-norm clip over the OneCycle schedule, as optax
defines them (``clip_by_global_norm``, ``adamw``,
``cosine_onecycle_schedule``), in plain PyTorch."""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def onecycle_lr(opt: Dict, total_steps: int, count: int) -> float:
    """optax's cosine OneCycle at ``count``: from peak/div_factor up to the
    peak at int(pct_start T), then down to peak/(div_factor
    final_div_factor) at T. An empty warm-up phase adds nothing."""
    peak = opt["learning_rate"]
    t = max(total_steps, 1)
    bounds = [0, int(opt["pct_start"] * t), t]
    values = [peak / opt["div_factor"], peak, peak / (opt["div_factor"] * opt["final_div_factor"])]
    for i in range(2):
        lo, hi = bounds[i], bounds[i + 1]
        if lo <= count < hi:
            cos = math.cos(math.pi * (count - lo) / (hi - lo))
            return values[i + 1] + (values[i] - values[i + 1]) / 2 * (cos + 1)
    return values[-1]


class AdamW:
    """One state per parameter; ``step(grads)`` clips, then updates in place."""

    def __init__(self, params: List[torch.Tensor], opt: Dict, total_steps: int):
        self.params, self.opt, self.total = params, opt, total_steps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def clipped(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if norm >= self.opt["clip_norm"]:
            return [g / norm * self.opt["clip_norm"] for g in grads]
        return grads

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Apply one step; returns the clipped gradients it used."""
        o = self.opt
        grads = self.clipped(grads)
        lr = onecycle_lr(o, self.total, self.count)
        n = self.count + 1
        bc1, bc2 = 1 - o["b1"] ** n, 1 - o["b2"] ** n
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            nu.mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
            p.sub_(lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8) + o["weight_decay"] * p))
        self.count = n
        return grads
