"""Spans at the port's layer boundaries, recorded while ``torch.profiler``
records and at no other time: the profiler is the switch.

``span(name, tag=None)`` is a context manager. With no profiler recording
it costs one check of the profiler's flag and records nothing. Under a
profiler (the benchmark's traced run, the CLI's ``--profile-dir``) each
span

- opens a profiler range of its name, so it lies on the profiler's clock
  in the same trace as the kernels it launched. The range has function
  scope: a user-scope ``record_function`` would also lay a
  ``gpu_user_annotation`` event over the kernels it launched, which the
  trace lists among the device's events, so that a reading of the device
  timeline would count the span's gaps as work;
- keeps a ``Record``: an id, the id of the span open around it on this
  thread, its name and tag, and the host's ``perf_counter`` at entry and
  exit;
- where CUDA is initialised, records a timing event on the current stream
  at entry and at exit. The span's device seconds are the time between
  them: the card's timeline from the end of the work queued before the
  span to the end of the work the span queued. A span that queues no work
  reads the card's idle inside it; one that queues work behind a backlog
  reads that work's device time.

Nothing on the hot path waits for the card: ``records()`` synchronises
once and resolves the events then. The newest ``CAPACITY`` records are
kept in memory; older ones are dropped and counted.

``count(name, values, tag=None)`` keeps a counter's values, a tensor left
where it lies (on the card: no copy to the host, no wait), under the same
switch: with no profiler recording it is one check of the flag.
``counters()`` brings the kept values to the host, once.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

CAPACITY = 65536

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class Count:
    name: str
    tag: object
    values: object  # a tensor until counters() resolves it, then a host list


@dataclasses.dataclass
class Record:
    id: int
    parent: Optional[int]  # the span open around this one on its thread
    name: str
    tag: object
    host_start: float  # perf_counter seconds
    host_end: float
    device_s: Optional[float] = None  # None where CUDA was not initialised

    @property
    def host_s(self) -> float:
        return self.host_end - self.host_start


class Tracer:
    """The records of closed spans, the newest ``capacity`` of them."""

    def __init__(self, capacity: int = CAPACITY):
        self._lock = threading.Lock()
        self._done: collections.deque = collections.deque()
        self._capacity = capacity
        self._pending: Dict[int, Tuple[torch.cuda.Event, torch.cuda.Event]] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._counts: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0

    def span(self, name: str, tag=None):
        if not _profiler_enabled():
            return _OFF
        return _Span(self, name, tag)

    def count(self, name: str, values: torch.Tensor, tag=None) -> None:
        if _profiler_enabled():
            with self._lock:
                self._counts.append(Count(name, tag, values.detach()))

    def counters(self) -> List[Count]:
        """The kept counts, oldest first, their values on the host."""
        with self._lock:
            kept = list(self._counts)
        for c in kept:
            if isinstance(c.values, torch.Tensor):
                c.values = c.values.tolist()
        return kept

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, rec: Record, events) -> None:
        with self._lock:
            if len(self._done) >= self._capacity:
                self._pending.pop(self._done.popleft().id, None)
                self.dropped += 1
            self._done.append(rec)
            if events is not None:
                self._pending[rec.id] = events

    def records(self) -> List[Record]:
        """The kept records, oldest first, their device seconds resolved."""
        with self._lock:
            done, pending = list(self._done), self._pending
            self._pending = {}
        if pending:
            torch.cuda.synchronize()
            for rec in done:
                events = pending.get(rec.id)
                if events is not None:
                    rec.device_s = events[0].elapsed_time(events[1]) / 1e3
        return done

    def clear(self) -> None:
        with self._lock:
            self._done.clear()
            self._pending.clear()
            self._counts.clear()
            self.dropped = 0


class _Span:
    __slots__ = ("tracer", "name", "tag", "id", "parent", "range", "start", "t0")

    def __init__(self, tracer: Tracer, name: str, tag):
        self.tracer, self.name, self.tag = tracer, name, tag

    def __enter__(self):
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        stack = self.tracer._stack()
        self.id = next(self.tracer._ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.start = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        events = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events = (self.start, end)
        self.tracer._stack().pop()
        self.range.__exit__(*exc)
        self.tracer._add(Record(self.id, self.parent, self.name, self.tag, self.t0, t1), events)
        return False


TRACER = Tracer()


def span(name: str, tag=None):
    """A span of ``name`` (tag: a step or microbatch index) on the
    process's tracer; records only while a profiler records."""
    return TRACER.span(name, tag)


def records() -> List[Record]:
    return TRACER.records()


def count(name: str, values: torch.Tensor, tag=None) -> None:
    """Keep ``values`` (a tag: a layer index) on the process's tracer;
    only while a profiler records."""
    TRACER.count(name, values, tag)


def counters() -> List[Count]:
    return TRACER.counters()


def clear() -> None:
    TRACER.clear()


def totals(recs: List[Record]) -> Dict[str, Tuple[int, float, Optional[float]]]:
    """By span name, in order of first appearance: the count, the host
    seconds and the device seconds (None where a record has none)."""
    out: Dict[str, list] = {}
    for r in recs:
        row = out.setdefault(r.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += r.host_s
        row[2] = None if row[2] is None or r.device_s is None else row[2] + r.device_s
    return {name: tuple(row) for name, row in out.items()}
