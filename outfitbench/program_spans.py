"""Per-layer numbers from the program's own spans
(``outfitx_tpu_torch.core.trace``): the records of the profiled stretch,
the only time the program's tracer records in a run. Each function takes
the run's ``Record`` and, in tests, synthetic span records; each returns
None where there is nothing to read, as in a program without the tracer."""

from __future__ import annotations

from typing import List, Optional


def program_records() -> List:
    try:
        from outfitx_tpu_torch.core import trace
    except ImportError:  # a program without the tracer
        return []
    return trace.records()


def _records(rec, records) -> List:
    if rec is None:
        return []
    return program_records() if records is None else records


def _device_s(records, name: str) -> Optional[float]:
    """Σ device seconds of the spans ``name``; None where there are none or
    one has no device seconds."""
    found = [r.device_s for r in records if r.name == name]
    return None if not found or None in found else sum(found)


def device_ms_per_step(rec, name: str, records=None) -> Optional[float]:
    """Σ device seconds of the spans ``name`` over the number of
    ``outfitx.step`` spans, in ms."""
    records = _records(rec, records)
    steps = sum(r.name == "outfitx.step" for r in records)
    total = _device_s(records, name)
    return None if not steps or total is None else 1e3 * total / steps


def device_ms_mean(rec, name: str, records=None) -> Optional[float]:
    """Σ device seconds of the spans ``name`` over their count, in ms."""
    records = _records(rec, records)
    total = _device_s(records, name)
    return None if total is None else 1e3 * total / sum(r.name == name for r in records)


def enqueue_ms(rec, records=None) -> Optional[float]:
    """Σ host seconds of ``outfitx.forward`` and ``outfitx.backward`` over
    the microbatches (the forward spans), in ms: the host's time to queue
    a microbatch's work, its blocks included."""
    found = [r for r in _records(rec, records)
             if r.name in ("outfitx.forward", "outfitx.backward")]
    microbatches = sum(r.name == "outfitx.forward" for r in found)
    return 1e3 * sum(r.host_s for r in found) / microbatches if microbatches else None
