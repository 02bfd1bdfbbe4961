"""AdamW with the OneCycle schedule and a global-norm clip, computed as
optax computes them (the port of ``outfitx_tpu/train/optim.py``, which
chains ``optax.clip_by_global_norm`` and ``optax.adamw`` over
``optax.cosine_onecycle_schedule``).

What differs from ``torch.optim``, and why it is written out here:
- the schedule is optax's piecewise cosine: it starts at peak/div_factor,
  reaches peak at ``int(pct_start * T)`` and ends at
  peak/(div_factor*final_div_factor) at T (``OneCycleLR`` puts its phase
  boundaries elsewhere);
- the clip scales by max_norm/||g|| with no eps when ||g|| >= max_norm
  (``clip_grad_norm_`` adds 1e-6);
- Adam's eps is outside the square root, bias correction uses count + 1,
  the learning rate is read at the count before the step, and weight decay
  adds lr*wd*p to every parameter.

One deliberate difference: where ``int(pct_start * T)`` is 0 (T <= 3 at
pct_start 0.3) optax's warm-up interval has zero length and its schedule
returns NaN at every step (0/0 times a false indicator); here that empty
interval contributes nothing, so the schedule is the cosine descent from
the peak. Everywhere else the two agree.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch

from outfitx_tpu_torch.core.config import OptimizerConfig


def make_schedule(cfg: OptimizerConfig, total_steps: int) -> Callable[[int], float]:
    """count -> learning rate, in the float32 arithmetic of optax's update
    (which evaluates the schedule at an int32 count)."""
    if cfg.schedule == "constant":
        return lambda count: float(np.float32(cfg.learning_rate))
    if cfg.schedule != "onecycle":
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    t = max(total_steps, 1)
    bounds = np.asarray([0, int(cfg.pct_start * t), int(t)])
    # float64, as optax keeps them; each phase's half-range is rounded to
    # float32 from float64, as optax's update computes it.
    values = np.cumprod(
        [cfg.learning_rate / cfg.div_factor, cfg.div_factor,
         1.0 / (cfg.div_factor * cfg.final_div_factor)]
    )

    def schedule(count: int) -> float:
        for i in range(2):
            lo, hi = bounds[i], bounds[i + 1]
            if lo <= count < hi:
                pct = np.float32(count - lo) / np.float32(hi - lo)
                cos = np.float32(math.cos(np.float32(np.pi) * pct))
                half = np.float32((values[i] - values[i + 1]) / 2.0)
                return float(np.float32(values[i + 1]) + half * (cos + np.float32(1.0)))
        return float(np.float32(values[-1]))

    return schedule


class AdamW:
    """AdamW over a list of parameters, reading each ``p.grad``.

    ``step()`` clips the gradients by their global norm (on the device, no
    host sync), takes one Adam step with decoupled weight decay at the
    schedule's current rate, and counts it."""

    def __init__(self, params, cfg: OptimizerConfig, total_steps: int):
        self.params: List[torch.nn.Parameter] = [p for p in params if p.requires_grad]
        self.cfg = cfg
        self.schedule = make_schedule(cfg, total_steps)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @property
    def learning_rate(self) -> float:
        """The rate the next step will use."""
        return self.schedule(self.count)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        cfg = self.cfg
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
        clip = norm >= cfg.clip_norm
        grads = [torch.where(clip, g / norm * cfg.clip_norm, g) for g in grads]
        lr = self.schedule(self.count)
        n = self.count + 1
        # The bias corrections in float32, as optax computes them.
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(n)) for b in (cfg.b1, cfg.b2))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(cfg.b1).add_(g, alpha=1.0 - cfg.b1)
            nu.mul_(cfg.b2).add_(g * g, alpha=1.0 - cfg.b2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)
            update.add_(p, alpha=cfg.weight_decay)
            p.add_(update, alpha=-lr)
        self.count = n

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(torch.as_tensor(np.asarray(src)))
