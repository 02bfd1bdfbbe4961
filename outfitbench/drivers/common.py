"""What every driver shares: the run's context, its outcome, and the
program's configuration built from a configuration file."""

from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List, Optional

import torch

from outfitbench.trace import Record


@dataclasses.dataclass
class Context:
    cell: Dict  # the cell's entry in BENCHMARK.json
    config: Dict  # configs/<config>.json
    params: Dict  # workloads/<cell>.json
    seed: int
    seconds: float
    trace: bool
    started: float  # perf_counter at the process's start
    device: str = "cuda"
    # Tests plant faults here: name -> callable that replaces a step.
    faults: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    metrics: Dict[str, float]  # end-to-end metrics by name
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Check]
    record: Optional[Record] = None  # traced runs only
    notes: Dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def program_config(cfg: Dict):
    """The program's ``OutfitXConfig`` for a configuration file."""
    from outfitx_tpu_torch.core.config import ItemEncoderConfig, OutfitXConfig, TransformerConfig

    enc = dataclasses.replace(
        ItemEncoderConfig.for_type(cfg["encoder_type"]), dim_per_modality=cfg["dim_per_modality"]
    )
    tr = TransformerConfig(
        n_heads=cfg["n_heads"], d_ffn=cfg["d_ffn"], n_layers=cfg["n_layers"],
        dropout=cfg["dropout"], activation=cfg["activation"],
        norm_first=cfg["norm_first"], final_norm=cfg["final_norm"],
    )
    return OutfitXConfig(
        item_encoder=enc, transformer=tr, max_outfit_len=cfg["max_outfit_len"],
        param_dtype=cfg["param_dtype"], compute_dtype=cfg["compute_dtype"],
    )


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def release(device) -> None:
    """Free what the program left, before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
