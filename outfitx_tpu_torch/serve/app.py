"""Demo web app and engine wiring (the port of ``outfitx_tpu/serve/app.py``).

A dependency-free stdlib HTTP server with the three task surfaces (CP score,
CIR top-10, FITB pick) as a minimal HTML UI and a JSON API:

    GET  /                 HTML UI
    GET  /api/sample?n=4   random outfit from the catalog
    GET  /api/sample_cp?n=4    sampled CP test rows: label vs predicted prob
    GET  /api/sample_cir?n=4   sampled CIR rows: partial outfit, gt, top-10
    GET  /api/sample_fitb?n=4  sampled FITB rows: answer vs predicted pick
    GET  /api/similar?item_id=N  nearest catalog neighbours of an item
    GET  /api/stats        per-route request counts and rolling p50/p90/p99
                           latency, error totals, catalog occupancy and
                           live-update counters (serve/stats.py)
    GET  /api/health       {"ok": true, "mock": ...}
    GET  /api/openapi.json the API's OpenAPI document (serve/openapi.py)
    GET  /images/{id}.jpg  an item's image, where the engine has images
    POST /api/cp           {"outfit": [ids]}               -> {"score"}
                           (serve(coalesce_ms=...) batches concurrent
                           /api/cp calls into one batched forward)
    POST /api/cp_batch     {"outfits": [[ids], ...]}       -> {"scores"}
    POST /api/cir          {"outfit": [ids], "target": id} -> {"items": [...]}
    POST /api/fitb         {"outfit": [ids], "candidates": [ids]} -> {"pick"}
    POST /api/update_items {"item_ids": [ids], "embeddings": [[...]]}
                           -> {"updated": n}  (live in-place catalog update)
    POST /api/add_items    {"item_ids": [ids], "embeddings": [[...]], ...}
                           -> {"added": n, "n_items", "capacity"}  (live
                           append into the reserved spare rows)
"""

from __future__ import annotations

import json
import pathlib
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from outfitx_tpu_torch.core.config import OutfitXConfig
from outfitx_tpu_torch.core.device import resolve_device
from outfitx_tpu_torch.data.catalog import Catalog
from outfitx_tpu_torch.data.sampler import CandidatePools
from outfitx_tpu_torch.data.splits import CPSplit, FITBSplit, OutfitSplit
from outfitx_tpu_torch.models.from_jax import load_jax_checkpoint
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.serve.engine import ServingEngine, UnknownItemError
from outfitx_tpu_torch.serve.openapi import build_spec
from outfitx_tpu_torch.serve.stats import ServerStats, host_rss_mb
from outfitx_tpu_torch.serve.ui import _HTML


def make_handler(engine, cp_scorer=None, cir_retriever=None, sim_retriever=None):
    """The request handler class over ``engine``. With the optional
    coalescers (serve/coalesce.py), /api/cp, /api/cir and /api/similar share
    one batched call across concurrent requests."""

    stats = ServerStats()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload, content_type="application/json"):
            self._last_code = code
            body = (
                payload.encode()
                if isinstance(payload, str)
                else json.dumps(payload).encode()
            )
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        _ROUTES = frozenset(
            [
                "/", "/api/sample", "/api/sample_cp", "/api/sample_cir",
                "/api/sample_fitb", "/api/similar", "/api/stats",
                "/api/health", "/api/openapi.json", "/images",
                "/api/cp", "/api/cp_batch",
                "/api/cir", "/api/fitb", "/api/update_items",
                "/api/add_items",
            ]
        )

        def _timed(self, fn):
            # Bound route cardinality: strip query strings, collapse
            # per-item paths (/images/123.jpg -> /images) and unknown
            # paths (a URL scanner must not grow the stats forever).
            route = self.path.split("?")[0]
            if route.startswith("/images/"):
                route = "/images"
            elif route.startswith("/index"):
                route = "/"
            if route not in self._ROUTES:
                route = "(unmatched)"
            self._last_code = None
            t0 = time.perf_counter()
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 (last resort: a GET
                # handler fault, e.g. an image deleted between is_file and
                # read_bytes, must yield an HTTP 500, not a dropped socket)
                if self._last_code is None:
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                code = self._last_code or 500
                stats.record(
                    route,
                    (time.perf_counter() - t0) * 1000.0,
                    200 <= code < 400,
                )

        def do_GET(self):
            return self._timed(self._route_GET)

        def do_POST(self):
            return self._timed(self._route_POST)

        def _route_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                return self._send(200, _HTML, "text/html")
            if self.path.startswith("/api/sample"):
                n = 4
                if "n=" in self.path:
                    try:
                        n = int(self.path.split("n=")[1].split("&")[0])
                    except ValueError:
                        pass
                n = max(1, min(n, 32))
                route = self.path.split("?")[0]
                try:
                    if route == "/api/sample_cp":
                        return self._send(200, {"samples": engine.sample_cp(n)})
                    if route == "/api/sample_cir":
                        return self._send(
                            200, {"samples": engine.sample_cir(n)}
                        )
                    if route == "/api/sample_fitb":
                        return self._send(
                            200, {"samples": engine.sample_fitb(n)}
                        )
                except ValueError as e:  # split not loaded
                    return self._send(404, {"error": str(e)})
                return self._send(200, {"outfit": engine.sample_outfit(n)})
            if self.path.startswith("/api/similar"):
                try:
                    item_id = int(self.path.split("item_id=")[1].split("&")[0])
                except (IndexError, ValueError):
                    return self._send(400, {"error": "item_id required"})
                try:
                    items = (
                        sim_retriever.similar(item_id)
                        if sim_retriever is not None
                        else engine.similar_items(item_id)
                    )
                    return self._send(200, {"items": items})
                except KeyError as e:
                    return self._send(404, {"error": str(e.args[0])})
            if self.path.startswith("/api/health"):
                return self._send(200, {"ok": True, "mock": engine.mock})
            if self.path.startswith("/api/openapi.json"):
                return self._send(200, build_spec())
            if self.path.startswith("/api/stats"):
                return self._send(200, stats.snapshot(engine))
            if self.path.startswith("/images/"):
                # the id is int-parsed, so no path traversal
                name = self.path[len("/images/") :].split("?")[0]
                try:
                    item_id = int(name.removesuffix(".jpg"))
                except ValueError:
                    return self._send(400, {"error": "bad image name"})
                p = engine.image_path(item_id)
                if p is None:
                    return self._send(404, {"error": "no image"})
                body = p.read_bytes()
                self._last_code = 200  # raw response path bypasses _send
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "max-age=3600")
                self.end_headers()
                self.wfile.write(body)
                return None
            return self._send(404, {"error": "not found"})

        def _route_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/api/cp":
                    score = (
                        cp_scorer.score(req["outfit"])
                        if cp_scorer is not None
                        else engine.cp_score(req["outfit"])
                    )
                    return self._send(200, {"score": score})
                if self.path == "/api/cp_batch":
                    return self._send(
                        200,
                        {"scores": engine.cp_score_batch(req["outfits"])},
                    )
                if self.path == "/api/cir":
                    items = (
                        cir_retriever.retrieve(req["outfit"], req["target"])
                        if cir_retriever is not None
                        else engine.cir_top10(req["outfit"], req["target"])
                    )
                    return self._send(200, {"items": items})
                if self.path == "/api/fitb":
                    return self._send(
                        200,
                        {
                            "pick": engine.fitb_pick(
                                req["outfit"], req["candidates"]
                            )
                        },
                    )
                if self.path == "/api/update_items":
                    # {"item_ids": [...], "embeddings": [[...], ...],
                    #  "descriptions": [...]?}
                    engine.update_items(
                        req["item_ids"],
                        req["embeddings"],
                        descriptions=req.get("descriptions"),
                    )
                    return self._send(
                        200, {"updated": len(req["item_ids"])}
                    )
                if self.path == "/api/add_items":
                    # {"item_ids", "embeddings", "category_ids"?,
                    #  "semantic_categories"?, "descriptions"?}
                    engine.add_items(
                        req["item_ids"],
                        req["embeddings"],
                        category_ids=req.get("category_ids"),
                        semantic_categories=req.get("semantic_categories"),
                        descriptions=req.get("descriptions"),
                    )
                    return self._send(
                        200,
                        {
                            "added": len(req["item_ids"]),
                            "n_items": engine.catalog.n_items,
                            "capacity": engine.catalog.capacity,
                        },
                    )
                return self._send(404, {"error": "not found"})
            except KeyError as e:
                if isinstance(e, UnknownItemError):
                    return self._send(404, {"error": str(e.args[0])})
                return self._send(400, {"error": f"missing field {e}"})
            except (ValueError, TypeError) as e:
                # client-shaped garbage (malformed JSON, ragged embeddings,
                # capacity exhausted, wrong field types) is a 400, not a
                # 500: the error totals of /api/stats must mean server faults
                return self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 (surface errors to the client)
                return self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def build_engine(
    *,
    synthetic: bool = False,
    mock: bool = False,
    model_cfg: OutfitXConfig | None = None,
    dataset_dir: str = "datasets/polyvore",
    polyvore_type: str = "nondisjoint",
    checkpoint_dir: str = "checkpoints",
    quantized: bool = False,
    quantize_model: bool = False,
    exact_topk: bool = False,
    catalog_dtype: str = "float32",
    shard_catalog: bool = False,
    spare_capacity: int = 0,
    device: str = "cuda",
    attn: str = "mha",
) -> ServingEngine:
    """Build a serving engine.

    ``synthetic`` serves a generated 2,000-item catalog with pools of 1,000;
    otherwise the Polyvore catalog under ``dataset_dir`` is loaded, with
    pools from its CIR test split and the browsing views' test splits where
    those files exist. The CP and CIR weights come from the JAX package's
    ``best_auc`` and ``best_recall@1`` checkpoints under ``checkpoint_dir``
    where they exist, and are random (seed 0) otherwise; ``mock`` builds no
    model and touches no device. ``quantized`` serves whole-catalog
    retrieval from the int8 catalog and drops the per-category pools.
    ``attn="block"`` serves the set transformer through the fused attention
    block (``OutfitXModel``'s ``attn``). ``quantize_model`` serves the int8
    (W8A8) twin of the weights (``ServingEngine``'s ``quantize_model``).
    """
    if shard_catalog:
        raise NotImplementedError(
            "['shard_catalog'] not ported to PyTorch yet: the mesh-sharded "
            "catalog comes with the parallelism slice"
        )
    if not mock:
        resolve_device(device)  # fail before any loading when there is no card
    model_cfg = model_cfg or OutfitXConfig()
    pools = None
    cp_split = cir_split = fitb_split = None
    if synthetic:
        from outfitx_tpu_torch.data.synthetic import make_synthetic

        data = make_synthetic(
            n_items=2000,
            d_embed=model_cfg.d_embed,
            n_outfits=256,
            max_len=model_cfg.max_outfit_len,
        )
        catalog = data.catalog
        pools = CandidatePools.build(
            catalog, data.cir_valid, pool_size=1000, threshold=1
        )
        cp_split, cir_split, fitb_split = (
            data.cp_valid, data.cir_valid, data.fitb_test,
        )
    else:
        catalog = Catalog.from_polyvore(
            dataset_dir, model_name=model_cfg.model_name
        )
        try:
            cir_split = OutfitSplit.load(
                catalog, dataset_dir, polyvore_type, "test",
                model_cfg.max_outfit_len,
            )
            pools = CandidatePools.build(catalog, cir_split)
        except FileNotFoundError:
            pools = None  # whole-catalog retrieval
        # each browsing view degrades on its own when its file is absent
        try:
            cp_split = CPSplit.load(
                catalog, dataset_dir, polyvore_type, "test",
                model_cfg.max_outfit_len,
            )
        except FileNotFoundError:
            pass
        try:
            fitb_split = FITBSplit.load(
                catalog, dataset_dir, polyvore_type, "test",
                model_cfg.max_outfit_len,
            )
        except FileNotFoundError:
            pass
    cp_params = cir_params = None
    if not mock:
        params = OutfitXModel(model_cfg, device="cpu").state_dict()
        cp_params = cir_params = params
        root = pathlib.Path(checkpoint_dir)
        cp_dir = root / f"{model_cfg.model_name}-cp" / "best_auc"
        cir_dir = root / f"{model_cfg.model_name}-cir" / "best_recall@1"
        if cp_dir.exists():
            cp_params = load_jax_checkpoint(cp_dir)
        if cir_dir.exists():
            cir_params = load_jax_checkpoint(cir_dir)
    images_dir = pathlib.Path(dataset_dir) / "images"
    return ServingEngine(
        model_cfg=model_cfg,
        catalog=catalog,
        cp_params=cp_params,
        cir_params=cir_params,
        # int8 whole-catalog retrieval replaces the per-category pools
        pools=None if quantized else pools,
        device=device,
        mock=mock,
        quantized=quantized,
        spare_capacity=spare_capacity,
        approx_topk=not exact_topk,
        catalog_dtype=catalog_dtype,
        images_dir=str(images_dir) if images_dir.is_dir() else None,
        cp_split=cp_split,
        cir_split=cir_split,
        fitb_split=fitb_split,
        attn=attn,
        quantize_model=quantize_model,
    )


DRAIN_EXIT_CODE = 81  # supervisor contract: restart the replica


def start_drain_watchdog(
    httpd,
    *,
    max_rss_mb: Optional[float] = None,
    max_age_s: Optional[float] = None,
    interval_s: float = 1.0,
) -> dict:
    """Self-drain hook for replica recycling.

    When the process's resident set or its age crosses its limit, the
    watchdog calls ``httpd.shutdown()``: the accept loop stops (new
    connections are refused; the balancer or supervisor retries them on a
    fresh replica) while in-flight requests run to completion
    (``daemon_threads`` is forced off so ``server_close`` joins them).

    Returns a dict that gains a ``reason`` key once the drain fires.
    """
    # join in-flight handler threads on server_close -> graceful drain
    httpd.daemon_threads = False
    httpd.block_on_close = True
    fired: dict = {}
    t0 = time.time()

    def watchdog():
        while not fired:
            time.sleep(interval_s)
            rss = host_rss_mb()
            age = time.time() - t0
            if max_rss_mb is not None and rss > max_rss_mb:
                fired["reason"] = (
                    f"host RSS {rss:.0f} MB > --max-rss limit {max_rss_mb:.0f} MB"
                )
            elif max_age_s is not None and age > max_age_s:
                fired["reason"] = (
                    f"replica age {age:.0f} s > --max-age limit {max_age_s:.0f} s"
                )
            if fired:
                httpd.shutdown()

    threading.Thread(target=watchdog, daemon=True, name="drain-watchdog").start()
    return fired


def serve(
    port: int = 6006,
    *,
    synthetic: bool = False,
    mock: bool = False,
    engine=None,
    poll: Optional[float] = None,
    coalesce_ms: Optional[float] = None,
    max_rss_mb: Optional[float] = None,
    max_age_s: Optional[float] = None,
    device: str = "cuda",
):
    """Serve ``engine`` (or one built here on ``device``) over HTTP until
    interrupted or drained; raises ``SystemExit(DRAIN_EXIT_CODE)`` after a
    drain."""
    engine = engine or build_engine(synthetic=synthetic, mock=mock, device=device)
    coalescers = []
    cp_scorer = cir_retriever = sim_retriever = None
    if coalesce_ms:
        from outfitx_tpu_torch.serve.coalesce import (
            CoalescingCIRRetriever,
            CoalescingCPScorer,
            CoalescingSimilarItems,
        )

        cp_scorer = CoalescingCPScorer(engine, window_ms=coalesce_ms)
        sim_retriever = CoalescingSimilarItems(engine, window_ms=coalesce_ms)
        coalescers = [cp_scorer, sim_retriever]
        if engine.cir_params is not None or engine.mock:
            cir_retriever = CoalescingCIRRetriever(
                engine, window_ms=coalesce_ms
            )
            coalescers.append(cir_retriever)
    httpd = ThreadingHTTPServer(
        ("0.0.0.0", port),
        make_handler(engine, cp_scorer, cir_retriever, sim_retriever),
    )
    drained: dict = {}
    if max_rss_mb is not None or max_age_s is not None:
        drained = start_drain_watchdog(
            httpd, max_rss_mb=max_rss_mb, max_age_s=max_age_s
        )
    print(
        f"OutfitX demo (PyTorch) on http://0.0.0.0:{httpd.server_port} (mock={mock})",
        flush=True,
    )
    try:
        httpd.serve_forever(poll_interval=poll or 0.5)
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()  # joins in-flight threads when draining
        for c in coalescers:
            c.close()
    if drained:
        # exit nonzero so a supervisor restarts the replica; in-flight
        # requests completed above
        print(
            json.dumps({"drain": drained["reason"], "exit": DRAIN_EXIT_CODE}),
            flush=True,
        )
        raise SystemExit(DRAIN_EXIT_CODE)
