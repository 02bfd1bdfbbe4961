"""What a traced run records, and its reduction to numbers.

- ``Spans``: host spans that the benchmark's own wrappers record around
  calls into the program (perf_counter seconds), with each wrapper's self
  time where a child span runs inside it on the same thread.
- ``DeviceTrace``: ``torch.profiler`` over a short steady stretch of the
  window. A marker kernel launched right after the profiler starts ties
  the trace's clock to the host's, so idle gaps can be named by the host
  span that was open.
- ``Record``: what the metric readers (``metrics/<name>.py``) read.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from outfitbench.peaks import kind

SPAN_PREFIX = "outfitbench."


class Spans:
    """Named host spans; safe from many threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.closed: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
        self.self_ms: Dict[str, List[float]] = collections.defaultdict(list)
        self._local = threading.local()

    def wrap(self, name: str, fn, parent: bool = False):
        """``fn`` with a span ``name`` around each call. A ``parent`` span
        also records its self time: its length less the spans that ran
        inside it on its thread."""

        def wrapped(*args, **kwargs):
            outer = getattr(self._local, "child_s", None)
            if parent:
                self._local.child_s = 0.0
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self.closed[name].append((t0, t1))
                    if parent:
                        self.self_ms[name].append((t1 - t0 - self._local.child_s) * 1e3)
                if parent:
                    self._local.child_s = outer
                elif outer is not None:
                    self._local.child_s = outer + (t1 - t0)

        return wrapped

    def durations_ms(self, name: str) -> List[float]:
        with self._lock:
            return [(b - a) * 1e3 for a, b in self.closed.get(name, ())]

    def between(self, t0: float, t1: float) -> List[Tuple[float, float, str]]:
        """The spans that overlap host times [t0, t1], shortest first."""
        with self._lock:
            found = [(a, b, name) for name, spans in self.closed.items()
                     for a, b in spans if a <= t1 and b >= t0]
        return sorted(found, key=lambda s: s[1] - s[0])


def _open_at(host_spans, t: float) -> Optional[str]:
    """The shortest of ``host_spans`` (shortest first) open at ``t``."""
    return next((name for a, b, name in host_spans if a <= t <= b), None)


class DeviceTrace:
    """``torch.profiler`` over a stretch of the window (a context manager).
    On exit ``summary`` holds busy_s (the union of the device's operations),
    window_s (host seconds of the stretch), span_s (device seconds from the
    marker to the end of the last operation), kernels {name: [seconds,
    calls]}, by_kind {kind: seconds} and the idle gaps named by ``spans``."""

    def __init__(self, spans: Optional[Spans] = None):
        self.spans = spans
        self.summary: Optional[Dict] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self._marker = torch.empty(1, device="cuda")
        self._marker.fill_(1.0)
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            host = self.spans.between(self._t0, t1) if self.spans is not None else []
            self.summary = reduce_events(self._device_events(), self._t0, t1, host)
        return False

    def _device_events(self) -> List[Tuple[str, float, float]]:
        import torch

        out = []
        for e in self._prof.events():
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
                out.append((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6))
        return out


def reduce_events(events, t0: float, t1: float, host_spans=()) -> Dict:
    """Busy time, kernels, kinds and named idle gaps of device events
    (name, start s, end s on the trace's clock) over the stretch [t0, t1]
    of host time. The first event is the marker launched at t0; an idle
    gap is named by the shortest of ``host_spans`` (Spans.between) open at
    its middle."""
    if not events:
        return {"busy_s": 0.0, "window_s": t1 - t0, "span_s": 0.0, "kernels": {}, "by_kind": {},
                "idle": {}, "n_events": 0}
    events = sorted(events, key=lambda e: e[1])
    origin = events[0][1]  # the marker, launched at host time t0
    end = origin + (t1 - t0)
    kernels: Dict[str, List[float]] = {}
    by_kind: Dict[str, float] = collections.defaultdict(float)
    for name, a, b in events[1:]:
        row = kernels.setdefault(name, [0.0, 0])
        row[0] += b - a
        row[1] += 1
        by_kind[kind(name)] += b - a
    busy = 0.0
    idle: Dict[str, float] = collections.defaultdict(float)

    def gap(a, b):
        name = _open_at(host_spans, t0 + ((a + b) / 2 - origin))
        idle["idle:" + (name or "none")] += b - a

    cursor = origin
    for _, a, b in events:
        a, b = max(a, origin), min(b, end)
        if a >= end or b <= cursor:
            continue
        if a > cursor:
            gap(cursor, a)
            cursor = a
        busy += b - cursor
        cursor = b
    if end > cursor:
        gap(cursor, end)
    span = min(max(b for _, _, b in events), end) - origin
    return {"busy_s": busy, "window_s": t1 - t0, "span_s": span, "kernels": kernels,
            "by_kind": dict(by_kind), "idle": dict(idle), "n_events": len(events) - 1}


def breakdown(summary: Dict, top: int = 10) -> Dict:
    """The result line's ``breakdown``: the device operations that took most
    time and the idle time by what the host was doing, in seconds."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:120], sec] for name, (sec, _) in ops],
            "idle_gaps": [[name, sec] for name, sec in gaps]}


@dataclasses.dataclass
class Record:
    """What one traced run hands the metric readers."""

    cell: Dict
    config: Dict
    params: Dict
    spans: Spans
    counters: Dict[str, float]
    trace: Optional[Dict]  # DeviceTrace.summary of the profiled stretch
    derived: Dict  # numbers the driver worked out (step seconds, shapes)
