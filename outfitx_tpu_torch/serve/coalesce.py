"""Dynamic request coalescing for the serving engine (the port of
``outfitx_tpu/serve/coalesce.py``; pure threading, no device code).

Each serving request is one eager forward of many small kernel launches
(serve/engine.py), bound by the host at batch 1, and concurrent requests
enqueue one after another on the one stream. A coalescer collects requests
that arrive within a small window and runs them as one batched call: N
concurrent requests cost one forward at the engine's bucket instead of N.

Coalesced surfaces: CP scoring (``cp_score_batch``), CIR top-10
(``cir_top10_batch``) and similar items (``similar_items_batch``). Opt-in
through ``serve(..., coalesce_ms=...)``.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
from typing import List, Sequence

_CLOSE = object()


class _CoalescingWorker:
    """Shared collector: batches concurrent blocking calls into one
    batch-program execution on a background thread.

    window_ms: how long the collector waits for more requests after the
        first one arrives (the added worst-case latency when idle).
    max_batch: at most this many requests share one call; the engine pads
        every chunk to exactly its bucket (a duplicate of the first request,
        sliced away), so each coalescer runs at the one batch size that the
        engine warmed at construction.

    Subclasses define ``_validate`` (caller-thread, so a bad request cannot
    poison the shared batch), ``_execute_batch`` (one fused call) and
    ``_execute_single`` (per-request fallback when a batch fails).
    """

    _name = "coalescer"

    def __init__(self, engine, window_ms: float = 3.0, max_batch: int = 0):
        self.engine = engine
        self.window = window_ms / 1000.0
        # default: the engine's one batch bucket
        self.max_batch = max_batch or getattr(engine, "cp_batch_bucket", 8)
        self.batch_calls = 0  # observability + tests
        self._closed = False
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(
            target=self._loop, name=self._name, daemon=True
        )
        self._thread.start()

    # ------------------------------------------------- subclass surface --
    def _validate(self, request) -> None:
        raise NotImplementedError

    def _execute_batch(self, requests: List) -> List:
        raise NotImplementedError

    def _execute_single(self, request):
        raise NotImplementedError

    # ------------------------------------------------------------- api --
    def _submit(self, request):
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        self._validate(request)
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((request, fut))
        return fut.result()

    def close(self) -> None:
        self._closed = True
        self._q.put(_CLOSE)
        self._thread.join(timeout=5)

    # ------------------------------------------------------- collector --
    def _drain(self, first) -> List:
        import time

        batch = [first]
        deadline = time.monotonic() + self.window
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is _CLOSE:
                self._q.put(_CLOSE)  # re-post for the outer loop
                break
            batch.append(item)
        return batch

    def _flush_on_close(self) -> None:
        """Fail any request that raced past the _closed check and landed
        behind the close sentinel — nobody may block forever."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not _CLOSE:
                item[1].set_exception(
                    RuntimeError(f"{type(self).__name__} closed")
                )

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _CLOSE:
                self._flush_on_close()
                return
            batch = self._drain(item)
            try:
                results = self._execute_batch([b[0] for b in batch])
                self.batch_calls += 1
                for (_, fut), r in zip(batch, results):
                    fut.set_result(r)
            except Exception:
                # Execute individually so one failing request (or a
                # transient device error) does not fail the whole batch.
                for req, fut in batch:
                    try:
                        fut.set_result(self._execute_single(req))
                    except Exception as e:  # per-request failure
                        fut.set_exception(e)


class CoalescingCPScorer(_CoalescingWorker):
    """Batches concurrent ``cp_score`` calls into ``cp_score_batch``."""

    _name = "cp-coalescer"

    def score(self, item_ids: Sequence[int]) -> float:
        """Blocking scoring call, safe from many threads."""
        return self._submit([int(i) for i in item_ids])

    def _validate(self, ids) -> None:
        for i in ids:
            self.engine.lookup_row(i)

    def _execute_batch(self, outfits):
        # cp_score_batch itself pads every chunk to exactly the engine's
        # warmed bucket (programs._bucket_chunks): no pad on this side.
        return [float(s) for s in self.engine.cp_score_batch(outfits)]

    def _execute_single(self, ids):
        return self.engine.cp_score(ids)


class CoalescingCIRRetriever(_CoalescingWorker):
    """Batches concurrent ``cir_top10`` calls into ``cir_top10_batch``
    (whole-catalog and pool retrieval requests)."""

    _name = "cir-coalescer"

    def retrieve(self, item_ids: Sequence[int], target_item_id: int):
        return self._submit(([int(i) for i in item_ids], int(target_item_id)))

    def _validate(self, req) -> None:
        ids, target = req
        for i in ids:
            self.engine.lookup_row(i)
        self.engine.lookup_row(target)

    def _execute_batch(self, requests):
        # cir_top10_batch pads each per-route chunk to the engine bucket
        return self.engine.cir_top10_batch(requests)

    def _execute_single(self, req):
        return self.engine.cir_top10(req[0], req[1])


class CoalescingSimilarItems(_CoalescingWorker):
    """Batches concurrent ``similar_items`` calls into
    ``similar_items_batch``."""

    _name = "sim-coalescer"

    def similar(self, item_id: int, k: int = 10):
        return self._submit((int(item_id), int(k)))

    def _validate(self, req) -> None:
        self.engine.lookup_row(req[0])

    def _execute_batch(self, requests):
        ks = {k for _, k in requests}
        if len(ks) == 1:  # the common (HTTP default) case: one fused call
            return self.engine.similar_items_batch(
                [i for i, _ in requests], k=ks.pop()
            )
        return [self.engine.similar_items(i, k) for i, k in requests]

    def _execute_single(self, req):
        return self.engine.similar_items(req[0], req[1])
