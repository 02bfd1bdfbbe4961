"""Per-layer numbers of the resnet_dsv2lite text tower from the program's
own spans and counter (``outfitx_tpu_torch.core.trace``) over the profiled
steps: device ms a microbatch in a span, the routed products' share of
their least time, and the routers' largest load. Each returns None where
there is nothing to read, as in a program without the tower's spans or the
tracer's counter."""

from __future__ import annotations

import statistics
from typing import List, Optional

from outfitbench import program_spans


def microbatches(rec) -> int:
    return rec.params["accumulation"] * rec.derived["profiled_steps"]


def device_ms_per_microbatch(rec, name: str, records=None) -> Optional[float]:
    """Σ device seconds of the spans ``name`` over the profiled
    microbatches, in ms."""
    found = [r.device_s for r in program_spans._records(rec, records) if r.name == name]
    if not found or None in found:
        return None
    return 1e3 * sum(found) / microbatches(rec)


def expert_roofline(rec, records=None) -> Optional[float]:
    """% : the routed products' least time (``flops_dsv2.expert_bound``, a
    mixture over a microbatch's tokens) over the device time of the
    ``outfitx.experts`` spans; None unless there is one a mixture a
    profiled microbatch."""
    found = [r.device_s for r in program_spans._records(rec, records) if r.name == "outfitx.experts"]
    cfg = rec.config if rec else None
    if not found or None in found or not rec.derived.get("expert_s"):
        return None
    mixtures = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    if len(found) != mixtures * microbatches(rec) or sum(found) <= 0:
        return None
    return 100.0 * rec.derived["expert_s"] * len(found) / sum(found)


def program_counts(name: str) -> List:
    try:
        from outfitx_tpu_torch.core import trace

        return [c for c in trace.counters() if c.name == name]
    except (ImportError, AttributeError):  # a program without the counter
        return []


def expert_load_max(rec, counts=None) -> Optional[float]:
    """The median over mixtures of the largest expert's tokens over the
    mean expert's, each mixture's counts summed over the profiled
    microbatches."""
    if rec is None:
        return None
    counts = program_counts("outfitx.expert_tokens") if counts is None else counts
    by_layer = {}
    for c in counts:
        row = by_layer.setdefault(c.tag, [0] * len(c.values))
        by_layer[c.tag] = [a + b for a, b in zip(row, c.values)]
    ratios = [max(v) / (sum(v) / len(v)) for v in by_layer.values() if sum(v) > 0]
    return statistics.median(ratios) if ratios else None
