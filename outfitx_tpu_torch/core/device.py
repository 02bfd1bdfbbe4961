"""Device resolution: entry points run on the card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (the default of every entry point) or ``"cpu"``.

    Raises when CUDA is asked for and there is no card: there is no silent
    move to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
