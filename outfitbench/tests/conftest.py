"""Fixtures of the benchmark's own tests (run with
``python -m pytest outfitbench/tests``)."""

from __future__ import annotations

import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    """The CUDA card; tests that need it skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_siglip() -> dict:
    """outfitx-siglip cut to a size a CPU test holds (widths too: only the
    tests use it)."""
    cfg = json.loads((ROOT / "outfitbench/configs/outfitx-siglip.json").read_text())
    cfg.update(dim_per_modality=16, d_embed=32, n_heads=4, d_ffn=24, n_layers=2,
               catalog_items=500, n_categories=7)
    return cfg


def workload(name: str, **changes) -> dict:
    params = json.loads((ROOT / f"outfitbench/workloads/{name}.json").read_text())
    params.update(changes)
    return params
