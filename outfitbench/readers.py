"""Reductions that several per-layer metrics share; each metric's own file
under ``metrics/`` names which one it reads."""

from __future__ import annotations

import statistics

from outfitbench.flops import attention_bound
from outfitbench.peaks import STEP_PEAK_FLOPS


def median_self_ms(rec, span: str):
    vals = rec.spans.self_ms.get(span) if rec and rec.spans else None
    return statistics.median(vals) if vals else None


def median_span_ms(rec, span: str):
    vals = rec.spans.durations_ms(span) if rec and rec.spans else None
    return statistics.median(vals) if vals else None


def idle_share(rec):
    """% of the profiled stretch in which no operation ran on the card."""
    tr = rec.trace if rec else None
    if not tr or not tr["n_events"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def step_mfu(rec):
    """% of the cards' bfloat16 peak: the model's operations in the
    profiled steps (flops.py) over the trace's seconds from the marker to
    the last operation's end."""
    d, tr = (rec.derived, rec.trace) if rec else (None, None)
    if not d or not tr or not d.get("step_flops") or tr.get("span_s", 0) <= 0:
        return None
    work = d["step_flops"] * d["profiled_steps"]
    return 100.0 * work / tr["span_s"] / (STEP_PEAK_FLOPS * d["chips"])


def attn_roofline(rec):
    """% : the least time of the attention launches the configuration's
    model asks for in the profiled steps (flops.attention_bound on their
    shapes) over the device time of the masked_mha kernels there; None
    where the kernels launched are not the ones asked for."""
    if rec is None or not rec.trace:
        return None
    d = rec.derived
    steps = d["profiled_steps"]
    least = sum(attention_bound(shape, d["compute_dtype"], bwd) * n * steps
                for shape, bwd, n in d["attention_launches"])
    want = sum(n * steps for _, _, n in d["attention_launches"])
    seconds = calls = 0
    for name, (sec, n) in rec.trace["kernels"].items():
        if "masked_mha" in name:
            seconds += sec
            calls += n
    if calls != want or seconds <= 0:
        return None
    return 100.0 * least / seconds


def kind_share(rec, kind: str):
    """% of the profiled kernels' device time in kernels of ``kind``."""
    tr = rec.trace if rec else None
    if not tr or not tr["kernels"]:
        return None
    total = sum(sec for sec, _ in tr["kernels"].values())
    return 100.0 * tr["by_kind"].get(kind, 0.0) / total if total > 0 else None


def host_gather_ms(rec):
    """ms a microbatch of the stager's gather_s growth over the window."""
    c = rec.counters if rec else None
    if not c or not c.get("microbatches") or "gather_s" not in c:
        return None
    return 1e3 * c["gather_s"] / c["microbatches"]
