"""In-process serving statistics for the HTTP app (`GET /api/stats`; this
package's copy of ``outfitx_tpu/serve/stats.py``).

A deployment needs to answer "is it healthy, how loaded is it, what are
the tails" from the process itself. This keeps a bounded ring of recent
request latencies per route (so percentiles reflect current behaviour, not
the whole process lifetime) plus monotonic totals, all O(1) per request
under one lock, cheap next to a forward.

Deliberately not exported to any metrics system: it is a JSON endpoint a
scraper, load balancer, or human can poll; `train/metrics_log.py` covers
the training-side story.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Tuple


def _pct(sorted_ms, q: float):
    if not sorted_ms:
        return None
    return round(sorted_ms[min(len(sorted_ms) - 1, int(q * len(sorted_ms)))], 2)


def host_rss_mb() -> float:
    """This process's resident set in MB (Linux /proc; ru_maxrss-peak
    fallback elsewhere).

    Exposed in `/api/stats` as the signal for when to recycle a replica
    whose process grows; ``serve(max_rss_mb=...)`` is the mechanical hook.
    """
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024, 1)
    except OSError:
        pass
    import resource

    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1)


class ServerStats:
    """Per-route counters + rolling latency window.

    ``window`` bounds memory: 1024 samples/route ~= seconds-to-minutes of
    recent traffic at soak rates, enough for stable p50/p99.
    """

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._window = window
        # route -> (n, errors, ring of latencies ms)
        self._routes: Dict[str, Tuple[int, int, Deque[float]]] = {}

    def record(self, route: str, ms: float, ok: bool) -> None:
        with self._lock:
            n, err, ring = self._routes.get(
                route, (0, 0, deque(maxlen=self._window))
            )
            ring.append(ms)
            self._routes[route] = (n + 1, err + (0 if ok else 1), ring)

    def snapshot(self, engine=None) -> dict:
        with self._lock:
            routes = {
                r: (n, err, sorted(ring))
                for r, (n, err, ring) in self._routes.items()
            }
        out = {
            "uptime_s": round(time.time() - self._t0, 1),
            "host_rss_mb": host_rss_mb(),
            "total_requests": sum(n for n, _, _ in routes.values()),
            "total_errors": sum(err for _, err, _ in routes.values()),
            "routes": {
                r: {
                    "n": n,
                    "errors": err,
                    "p50_ms": _pct(lat, 0.50),
                    "p90_ms": _pct(lat, 0.90),
                    "p99_ms": _pct(lat, 0.99),
                }
                for r, (n, err, lat) in sorted(routes.items())
            },
        }
        if engine is not None:
            cat = engine.catalog
            out["catalog"] = {
                "n_items": int(cat.n_items),
                "capacity": int(getattr(cat, "capacity", cat.n_items)),
                "updated_rows": int(getattr(engine, "n_updated_rows", 0)),
                "appended_items": int(getattr(engine, "n_appended_items", 0)),
            }
        return out
