"""The PyTorch port's HTTP layer on the CPU: the counterparts of the JAX
package's ``TestHTTP``, ``TestImages``, ``TestCoalescingScorer``,
``TestMixedTaskCoalescing``, ``TestSampleBrowsing`` and
``TestReplicaRecycling`` (tests/test_serve.py), the OpenAPI document against
the JAX package's, a mock engine on every route, and ``serve()`` end to end.
Servers listen on port 0 of the loopback interface."""

import concurrent.futures
import contextlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from outfitx_tpu.serve import app as jax_app
from outfitx_tpu.serve.openapi import build_spec as jax_build_spec
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.data.sampler import CandidatePools
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.serve import app
from outfitx_tpu_torch.serve.coalesce import (
    CoalescingCIRRetriever,
    CoalescingCPScorer,
    CoalescingSimilarItems,
)
from outfitx_tpu_torch.serve.engine import ServingEngine, UnknownItemError
from outfitx_tpu_torch.serve.openapi import build_spec
from outfitx_tpu_torch.serve.stats import ServerStats, host_rss_mb

torch.set_num_threads(1)

D = 32


def _model_cfg():
    return tcfg.OutfitXConfig(
        item_encoder=tcfg.ItemEncoderConfig(dim_per_modality=D // 2),
        transformer=tcfg.TransformerConfig(n_heads=4, d_ffn=64, n_layers=2, dropout=0.1),
        max_outfit_len=8,
        compute_dtype="float32",
    )


_STATE = {}


def _state_dict():
    if not _STATE:
        _STATE["sd"] = OutfitXModel(_model_cfg(), device="cpu", seed=0).state_dict()
    return _STATE["sd"]


def _engine(n_items=300, seed=5, **kw):
    data = make_synthetic(n_items=n_items, d_embed=D, n_outfits=64, max_len=8, seed=seed)
    sd = None if kw.get("mock") else _state_dict()
    if kw.pop("browse", False):
        kw.update(
            pools=CandidatePools.build(data.catalog, data.cir_valid, pool_size=64, threshold=1),
            cp_split=data.cp_valid, cir_split=data.cir_valid, fitb_split=data.fitb_test,
        )
    return ServingEngine(**{
        "model_cfg": _model_cfg(), "catalog": data.catalog, "cp_params": sd,
        "cir_params": sd, "device": "cpu", "approx_topk": False, **kw,
    })


@pytest.fixture(scope="module")
def engine():
    return _engine()


@contextlib.contextmanager
def _serving(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.fixture()
def server(engine):
    with _serving(app.make_handler(engine)) as url:
        yield url


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _post(url, payload):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _error(fn, *args):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*args)
    return e.value.code, json.loads(e.value.read())


def _stats_when(server, cond, tries=60):
    # a request is recorded on the handler thread after its response is
    # written, so poll briefly for the expected row
    for _ in range(tries):
        stats = _get(server + "/api/stats")
        if cond(stats):
            break
        time.sleep(0.05)
    return stats


class TestHTTP:
    def test_ui_and_sample(self, server):
        with urllib.request.urlopen(server + "/") as r:
            assert b"OutfitX-TPU demo" in r.read()
            assert r.headers["Content-Type"] == "text/html"
        assert len(_get(server + "/api/sample?n=5")["outfit"]) == 5
        assert len(_get(server + "/api/sample?n=500")["outfit"]) == 32  # capped
        assert len(_get(server + "/api/sample")["outfit"]) == 4

    def test_cp_cir_fitb_roundtrip(self, server, engine):
        outfit = engine.sample_outfit(4)
        cp = _post(server + "/api/cp", {"outfit": outfit})
        assert abs(cp["score"] - engine.cp_score(outfit)) < 1e-6
        cpb = _post(server + "/api/cp_batch", {"outfits": [outfit, outfit[:2]]})
        np.testing.assert_allclose(
            cpb["scores"], [engine.cp_score(outfit), engine.cp_score(outfit[:2])], atol=1e-5
        )
        cir = _post(server + "/api/cir", {"outfit": outfit[:3], "target": outfit[3]})
        assert cir["items"] == engine.cir_top10(outfit[:3], outfit[3])
        assert len(cir["items"]) == 10
        cands = engine.sample_outfit(4)
        fitb = _post(server + "/api/fitb", {"outfit": outfit[:2], "candidates": cands})
        assert fitb["pick"] == engine.fitb_pick(outfit[:2], cands)

    def test_similar_route(self, server, engine):
        item = engine.sample_outfit(1)[0]
        got = _get(server + f"/api/similar?item_id={item}")
        assert got["items"] == engine.similar_items(item)
        assert _error(_get, server + "/api/similar")[0] == 400
        code, body = _error(_get, server + "/api/similar?item_id=999999999")
        assert code == 404 and "unknown item_id" in body["error"]

    def test_update_items_roundtrip(self):
        eng = _engine(seed=6, warmup=False)
        with _serving(app.make_handler(eng)) as server:
            src, dst = eng.sample_outfit(2)
            new_emb = eng.catalog.embeddings[eng.lookup_row(src)].tolist()
            out = _post(
                server + "/api/update_items", {"item_ids": [dst], "embeddings": [new_emb]}
            )
            assert out == {"updated": 1}
            sims = _get(server + f"/api/similar?item_id={src}")["items"]
            assert sims[0]["item_id"] == dst
            assert _stats_when(server, lambda s: True)["catalog"]["updated_rows"] == 1

    def test_add_items_roundtrip(self):
        eng = _engine(seed=7, warmup=False, spare_capacity=4)
        with _serving(app.make_handler(eng)) as server:
            src = eng.sample_outfit(1)[0]
            emb = eng.catalog.embeddings[eng.lookup_row(src)].tolist()
            out = _post(server + "/api/add_items", {
                "item_ids": [424242], "embeddings": [emb], "category_ids": [1],
                "descriptions": ["appended"],
            })
            assert out == {"added": 1, "n_items": 301, "capacity": 304}
            sims = _get(server + f"/api/similar?item_id={src}")["items"]
            assert sims[0]["item_id"] == 424242 and sims[0]["description"] == "appended"
            assert all(s["item_id"] in eng.catalog.id_to_row for s in sims)

    def test_add_items_without_capacity_gets_400(self, server):
        code, body = _error(
            _post, server + "/api/add_items",
            {"item_ids": [123456789], "embeddings": [[0.0] * D]},
        )
        assert code == 400 and "capacity" in body["error"]

    def test_bad_request_gets_400(self, server):
        code, body = _error(_post, server + "/api/cp", b"{}")
        assert code == 400 and "missing field" in body["error"]
        code, body = _error(_post, server + "/api/cp", {"outfit": [10**9]})
        assert code == 404 and "unknown item_id" in body["error"]
        assert _error(_post, server + "/api/nope", b"{}")[0] == 404
        assert _error(_get, server + "/nope")[0] == 404

    def test_malformed_json_gets_400(self, server):
        assert _error(_post, server + "/api/cp", b"not json")[0] == 400
        # ragged embeddings are the client's fault too
        code, _ = _error(
            _post, server + "/api/update_items",
            {"item_ids": [1], "embeddings": [[0.0, 1.0]]},
        )
        assert code in (400, 404)

    def test_server_fault_gets_500(self):
        eng = _engine(seed=8, warmup=False)

        def boom(ids):
            raise RuntimeError("device fault")

        eng.cp_score = boom
        with _serving(app.make_handler(eng)) as server:
            code, body = _error(_post, server + "/api/cp", {"outfit": eng.sample_outfit(2)})
            assert code == 500 and "device fault" in body["error"]
            stats = _stats_when(server, lambda s: s["total_errors"] >= 1)
            assert stats["routes"]["/api/cp"]["errors"] == 1

    def test_unmatched_routes_collapse_in_stats(self, server):
        for p in ("/wp-admin", "/scan-me-12345"):
            with contextlib.suppress(urllib.error.HTTPError):
                urllib.request.urlopen(server + p)
        stats = _stats_when(server, lambda s: s["routes"].get("(unmatched)", {}).get("n", 0) >= 2)
        assert stats["routes"]["(unmatched)"]["n"] >= 2
        assert "/wp-admin" not in stats["routes"]

    def test_stats_endpoint(self, server, engine):
        _post(server + "/api/cp", {"outfit": engine.sample_outfit(3)})
        assert _get(server + "/api/health") == {"ok": True, "mock": False}
        stats = _stats_when(
            server, lambda s: {"/api/cp", "/api/health"} <= set(s["routes"])
        )
        assert stats["total_requests"] >= 2
        cp = stats["routes"]["/api/cp"]
        assert cp["n"] >= 1 and cp["p50_ms"] is not None and cp["p99_ms"] >= cp["p50_ms"]
        assert stats["routes"]["/api/health"]["errors"] == 0
        cat = stats["catalog"]
        assert cat["n_items"] == engine.catalog.n_items == cat["capacity"]
        assert cat["updated_rows"] == engine.n_updated_rows
        _error(_post, server + "/api/cp", b"{}")
        stats2 = _stats_when(
            server, lambda s: s["routes"].get("/api/cp", {}).get("errors", 0) >= 1
        )
        assert stats2["routes"]["/api/cp"]["errors"] >= 1

    def test_openapi_route(self, server):
        assert _get(server + "/api/openapi.json") == build_spec()


class TestOpenAPI:
    def test_spec_equals_the_jax_packages(self):
        assert build_spec() == jax_build_spec()

    def test_spec_in_step_with_the_handler(self, engine):
        routes = set(app.make_handler(engine)._ROUTES)
        jax_routes = set(jax_app.make_handler(engine)._ROUTES)
        assert routes == jax_routes and len(routes) == 16
        documented = set(build_spec()["paths"])
        # the spec documents the JSON API: every /api route, and only those
        api = {r for r in routes if r.startswith("/api/")}
        assert api <= documented, api - documented
        assert all(p in api or p.startswith("/images/") for p in documented), documented


class TestImages:
    @pytest.fixture()
    def image_engine(self, tmp_path):
        eng = _engine(n_items=50, seed=7, mock=True, images_dir=str(tmp_path))
        for item_id in eng.catalog.item_ids[:2]:
            (tmp_path / f"{int(item_id)}.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a real jpeg")
        return eng

    def test_item_info_has_image_url(self, image_engine):
        info = image_engine._item_info(0, 0.0)
        assert info["image_url"] == f"/images/{info['item_id']}.jpg"
        assert "image_url" not in image_engine._item_info(10, 0.0)
        assert image_engine.image_path(10**9) is None

    def test_http_serves_image_bytes(self, image_engine):
        with _serving(app.make_handler(image_engine)) as server:
            item_id = int(image_engine.catalog.item_ids[0])
            with urllib.request.urlopen(f"{server}/images/{item_id}.jpg") as r:
                assert r.headers["Content-Type"] == "image/jpeg"
                assert r.read()[:2] == b"\xff\xd8"
            assert _error(_get, server + "/images/999999.jpg")[0] == 404
            assert _error(_get, server + "/images/..%2fsecret.jpg")[0] == 400
            stats = _stats_when(server, lambda s: s["routes"].get("/images", {}).get("n", 0) >= 3)
            assert stats["routes"]["/images"]["n"] >= 3

    def test_no_images_dir_means_no_urls(self, engine):
        assert engine.image_path(int(engine.catalog.item_ids[0])) is None


class TestMockEngine:
    def test_mock_engine_needs_no_params_and_no_device(self):
        # the default device is the card, and there is none here: a mock
        # engine must not ask for it
        data = make_synthetic(n_items=100, d_embed=D, n_outfits=16, max_len=8, seed=6)
        eng = ServingEngine(model_cfg=_model_cfg(), catalog=data.catalog, mock=True)
        assert eng.catalog_dev is None and eng.cp_model is None
        assert 0.0 <= eng.cp_score(eng.sample_outfit(3)) <= 1.0
        assert len(eng.cir_top10(eng.sample_outfit(3), eng.sample_outfit(1)[0])) == 10
        assert len(eng.similar_items(eng.sample_outfit(1)[0], k=5)) == 5
        assert 0 <= eng.fitb_pick(eng.sample_outfit(3), eng.sample_outfit(4)) < 4
        assert len(eng.cp_score_batch([eng.sample_outfit(2)])) == 1
        assert len(eng.cir_top10_batch([(eng.sample_outfit(2), eng.sample_outfit(1)[0])])[0]) == 10
        assert len(eng.similar_items_batch(eng.sample_outfit(2), k=3)[1]) == 3
        eng.update_items([int(eng.catalog.item_ids[0])], np.ones((1, D), np.float32))
        assert eng.n_updated_rows == 1 and eng.catalog.embeddings[0, 0] == 1.0

    def test_mock_engine_serves_every_route(self, tmp_path):
        eng = _engine(
            n_items=120, seed=9, mock=True, browse=True, spare_capacity=2,
            images_dir=str(tmp_path),
        )
        first = int(eng.catalog.item_ids[0])
        (tmp_path / f"{first}.jpg").write_bytes(b"\xff\xd8")
        ids = eng.sample_outfit(6)
        cp = CoalescingCPScorer(eng, window_ms=1.0)
        cir = CoalescingCIRRetriever(eng, window_ms=1.0)
        sim = CoalescingSimilarItems(eng, window_ms=1.0)
        try:
            with _serving(app.make_handler(eng, cp, cir, sim)) as s:
                with urllib.request.urlopen(s + "/index.html") as r:
                    assert b"<html>" in r.read()
                assert len(_get(s + "/api/sample?n=3")["outfit"]) == 3
                assert len(_get(s + "/api/sample_cp?n=2")["samples"]) == 2
                assert len(_get(s + "/api/sample_cir?n=2")["samples"][0]["retrieved"]) == 10
                assert "predicted_index" in _get(s + "/api/sample_fitb?n=2")["samples"][0]
                assert len(_get(s + f"/api/similar?item_id={ids[0]}")["items"]) == 10
                assert _get(s + "/api/health") == {"ok": True, "mock": True}
                assert _get(s + "/api/openapi.json")["openapi"] == "3.0.3"
                with urllib.request.urlopen(f"{s}/images/{first}.jpg") as r:
                    assert r.read() == b"\xff\xd8"
                assert 0.0 <= _post(s + "/api/cp", {"outfit": ids[:3]})["score"] <= 1.0
                assert len(_post(s + "/api/cp_batch", {"outfits": [ids[:2], ids[2:]]})["scores"]) == 2
                assert len(_post(s + "/api/cir", {"outfit": ids[:3], "target": ids[3]})["items"]) == 10
                assert 0 <= _post(s + "/api/fitb", {"outfit": ids[:2], "candidates": ids[2:]})["pick"] < 4
                emb = [[0.5] * D]
                assert _post(s + "/api/update_items", {"item_ids": ids[:1], "embeddings": emb})["updated"] == 1
                assert _post(s + "/api/add_items", {"item_ids": [77], "embeddings": emb})["n_items"] == 121
                stats = _stats_when(s, lambda st: len(st["routes"]) >= 15)
                served = set(stats["routes"]) | {"/api/stats"}
                assert served == set(app.make_handler(eng)._ROUTES)
                assert stats["total_errors"] == 0
                assert stats["catalog"] == {
                    "n_items": 121, "capacity": 122, "updated_rows": 1, "appended_items": 1,
                }
        finally:
            for c in (cp, cir, sim):
                c.close()


class TestCoalescingScorer:
    def test_concurrent_scores_match_and_coalesce(self, monkeypatch):
        eng = _engine(seed=10, warmup=False)
        outfits = [eng.sample_outfit(n % 4 + 2) for n in range(24)]
        expected = [eng.cp_score(o) for o in outfits]
        sizes = []
        real_run = eng._run

        def counting_run(task, *args):
            if task.__name__ == "cp_task":
                sizes.append(len(args[-1]))
            return real_run(task, *args)

        monkeypatch.setattr(eng, "_run", counting_run)
        scorer = CoalescingCPScorer(eng, window_ms=25.0)
        try:
            with concurrent.futures.ThreadPoolExecutor(max_workers=12) as ex:
                got = list(ex.map(scorer.score, outfits))
            np.testing.assert_allclose(got, expected, atol=1e-5)
            # 24 requests from 12 threads within a 25 ms window share
            # batches: strictly fewer batched calls than requests, and every
            # forward runs at the one bucket
            assert 1 <= scorer.batch_calls < 24
            assert set(sizes) == {scorer.max_batch} == {eng.cp_batch_bucket}
        finally:
            scorer.close()

    def test_bad_id_rejected_without_poisoning_batch(self, engine):
        good = engine.sample_outfit(3)
        scorer = CoalescingCPScorer(engine, window_ms=25.0)
        try:
            with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
                ok = ex.submit(scorer.score, good)
                with pytest.raises(UnknownItemError):
                    scorer.score([good[0], 10**9])
                assert abs(ok.result() - engine.cp_score(good)) < 1e-5
        finally:
            scorer.close()

    def test_http_cp_route_uses_coalescer(self, engine):
        scorer = CoalescingCPScorer(engine, window_ms=25.0)
        try:
            with _serving(app.make_handler(engine, scorer)) as server:
                outfits = [engine.sample_outfit(3) for _ in range(8)]
                with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                    got = list(ex.map(
                        lambda o: _post(server + "/api/cp", {"outfit": o})["score"], outfits
                    ))
                np.testing.assert_allclose(
                    got, [engine.cp_score(o) for o in outfits], atol=1e-5
                )
                assert 1 <= scorer.batch_calls < 8
        finally:
            scorer.close()

    def test_close_is_idempotent_and_unblocks(self, engine):
        scorer = CoalescingCPScorer(engine, window_ms=1.0)
        assert scorer.score(engine.sample_outfit(2)) >= 0.0
        scorer.close()
        scorer.close()
        with pytest.raises(RuntimeError):
            scorer.score(engine.sample_outfit(2))

    def test_failing_batch_falls_back_to_single_requests(self, monkeypatch):
        eng = _engine(seed=11, warmup=False)
        outfit = eng.sample_outfit(3)
        want = eng.cp_score(outfit)
        monkeypatch.setattr(
            eng, "cp_score_batch", lambda o: (_ for _ in ()).throw(RuntimeError("batch"))
        )
        scorer = CoalescingCPScorer(eng, window_ms=1.0)
        try:
            assert abs(scorer.score(outfit) - want) < 1e-6
            assert scorer.batch_calls == 0
        finally:
            scorer.close()


class TestMixedTaskCoalescing:
    def test_concurrent_mixed_tasks(self, engine):
        cp = CoalescingCPScorer(engine, window_ms=20.0)
        cir = CoalescingCIRRetriever(engine, window_ms=20.0)
        sim = CoalescingSimilarItems(engine, window_ms=20.0)
        outfits = [engine.sample_outfit(n % 3 + 2) for n in range(8)]
        targets = [engine.sample_outfit(1)[0] for _ in range(8)]
        items = engine.sample_outfit(8)
        exp_cp = [engine.cp_score(o) for o in outfits]
        exp_cir = [
            [x["item_id"] for x in engine.cir_top10(o, t)] for o, t in zip(outfits, targets)
        ]
        exp_sim = [[x["item_id"] for x in engine.similar_items(i)] for i in items]
        try:
            with concurrent.futures.ThreadPoolExecutor(max_workers=12) as ex:
                f_cp = [ex.submit(cp.score, o) for o in outfits]
                f_cir = [ex.submit(cir.retrieve, o, t) for o, t in zip(outfits, targets)]
                f_sim = [ex.submit(sim.similar, i) for i in items]
                got_cp = [f.result() for f in f_cp]
                got_cir = [[x["item_id"] for x in f.result()] for f in f_cir]
                got_sim = [[x["item_id"] for x in f.result()] for f in f_sim]
            np.testing.assert_allclose(got_cp, exp_cp, atol=1e-5)
            # exact top-k on both forms: a near-tie may still swap between
            # the B=1 and the batched product's summation order
            for g, e in zip(got_cir + got_sim, exp_cir + exp_sim):
                assert len(set(g) & set(e)) >= 9, (g, e)
            assert cir.batch_calls >= 1 and sim.batch_calls >= 1
        finally:
            for c in (cp, cir, sim):
                c.close()

    def test_bad_request_does_not_poison_batch(self, engine):
        cir = CoalescingCIRRetriever(engine, window_ms=5.0)
        try:
            with pytest.raises(UnknownItemError):
                cir.retrieve([10**9], 0)
            good = engine.sample_outfit(3)
            assert len(cir.retrieve(good[:2], good[2])) == 10
        finally:
            cir.close()

    def test_similar_with_mixed_k_runs_singly(self, engine):
        sim = CoalescingSimilarItems(engine, window_ms=20.0)
        items = engine.sample_outfit(4)
        try:
            with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
                futs = [ex.submit(sim.similar, i, 3 + j) for j, i in enumerate(items)]
                got = [f.result() for f in futs]
            assert [len(g) for g in got] == [3, 4, 5, 6]
        finally:
            sim.close()


class TestSampleBrowsing:
    @pytest.fixture(scope="class")
    def browse_engine(self):
        return _engine(seed=9, browse=True, warmup=False)

    def test_sample_cp(self, browse_engine):
        samples = browse_engine.sample_cp(3)
        assert len(samples) == 3
        for s in samples:
            assert s["label"] in (0, 1) and 0.0 <= s["prob"] <= 1.0
            assert s["predicted"] == int(s["prob"] > 0.5)
            assert len(s["items"]) >= 1 and all("item_id" in it for it in s["items"])

    def test_sample_cir_gt_marking(self, browse_engine):
        samples = browse_engine.sample_cir(3)
        assert len(samples) == 3
        for s in samples:
            assert len(s["retrieved"]) == 10
            gt = s["gt_item"]["item_id"]
            assert gt not in [i["item_id"] for i in s["partial_outfit"]]
            assert s["gt_in_top10"] == any(r["item_id"] == gt for r in s["retrieved"])

    def test_sample_fitb_correct_flag(self, browse_engine):
        for s in browse_engine.sample_fitb(3):
            assert len(s["candidates"]) == 4
            assert 0 <= s["answer_index"] < 4 and 0 <= s["predicted_index"] < 4
            assert s["correct"] == (s["answer_index"] == s["predicted_index"])

    def test_http_sample_endpoints(self, browse_engine):
        with _serving(app.make_handler(browse_engine)) as server:
            for task, key in (("cp", "prob"), ("cir", "gt_item"), ("fitb", "answer_index")):
                j = _get(f"{server}/api/sample_{task}?n=2")
                assert len(j["samples"]) == 2 and key in j["samples"][0]

    def test_sample_views_404_without_splits(self, server):
        for task in ("cp", "cir", "fitb"):
            code, body = _error(_get, f"{server}/api/sample_{task}?n=2")
            assert code == 404 and "split" in body["error"]


class TestReplicaRecycling:
    def test_stats_expose_recycling_signals(self, engine):
        snap = ServerStats().snapshot(engine)
        assert snap["host_rss_mb"] > 10.0  # a real python process
        assert snap["uptime_s"] >= 0.0
        assert host_rss_mb() == pytest.approx(snap["host_rss_mb"], rel=0.5)

    def test_age_drain_fires_and_requests_complete(self, engine):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), app.make_handler(engine))
        port = httpd.server_address[1]
        fired = app.start_drain_watchdog(httpd, max_age_s=1.0, interval_s=0.1)
        assert httpd.daemon_threads is False  # the drain joins in-flight threads
        t = threading.Thread(target=httpd.serve_forever)
        t.start()
        assert _get(f"http://127.0.0.1:{port}/api/health")["ok"]
        t.join(timeout=30)
        assert not t.is_alive(), "the drain watchdog never stopped the server"
        assert "age" in fired["reason"]
        httpd.server_close()
        with pytest.raises(OSError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/api/health", timeout=2)

    def test_rss_drain_threshold(self, engine):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), app.make_handler(engine))
        fired = app.start_drain_watchdog(
            httpd, max_rss_mb=max(1.0, host_rss_mb() / 2), interval_s=0.05
        )
        t = threading.Thread(target=httpd.serve_forever)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert "RSS" in fired["reason"]
        httpd.server_close()

    def test_in_flight_request_completes_during_drain(self):
        eng = _engine(seed=12, warmup=False)
        slow_started = threading.Event()
        orig = eng.cp_score

        def slow_cp_score(ids):
            slow_started.set()
            time.sleep(1.0)  # hold the request across the drain moment
            return orig(ids)

        eng.cp_score = slow_cp_score
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), app.make_handler(eng))
        port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever)
        t.start()
        result = {}

        def client():
            result["body"] = _post(
                f"http://127.0.0.1:{port}/api/cp", {"outfit": eng.sample_outfit(3)}
            )

        ct = threading.Thread(target=client)
        ct.start()
        assert slow_started.wait(timeout=10)
        fired = app.start_drain_watchdog(httpd, max_age_s=0.0, interval_s=0.05)
        t.join(timeout=30)
        assert not t.is_alive()
        httpd.server_close()  # joins the in-flight handler thread
        ct.join(timeout=30)
        assert "score" in result.get("body", {}), result
        assert fired["reason"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_end_to_end_with_coalescers_and_age_drain(capsys):
    """``serve()`` itself: its server with the three coalescers on, requests
    from several threads, then the age drain ends it with DRAIN_EXIT_CODE."""
    eng = _engine(seed=13, spare_capacity=4)
    calls = {"cp": 0, "cir": 0, "sim": 0}
    for key, name in (("cp", "cp_score_batch"), ("cir", "cir_top10_batch"),
                      ("sim", "similar_items_batch")):
        real = getattr(eng, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        setattr(eng, name, counted)
    port = _free_port()
    outcome = {}

    def run():
        try:
            app.serve(port, engine=eng, coalesce_ms=20.0, max_age_s=4.0, poll=0.05)
        except SystemExit as e:
            outcome["code"] = e.code

    t = threading.Thread(target=run)
    t.start()
    url = f"http://127.0.0.1:{port}"
    for _ in range(100):
        try:
            _get(url + "/api/health")
            break
        except OSError:
            time.sleep(0.05)
    outfits = [eng.sample_outfit(3) for _ in range(8)]
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        cp = list(ex.map(lambda o: _post(url + "/api/cp", {"outfit": o})["score"], outfits))
        cir = list(ex.map(
            lambda o: _post(url + "/api/cir", {"outfit": o[:2], "target": o[2]})["items"], outfits
        ))
        sim = list(ex.map(lambda o: _get(url + f"/api/similar?item_id={o[0]}")["items"], outfits))
    np.testing.assert_allclose(cp, [eng.cp_score(o) for o in outfits], atol=1e-5)
    for o, got_c, got_s in zip(outfits, cir, sim):
        assert len(got_c) == 10 and len(got_s) == 10
        assert len({x["item_id"] for x in got_s}
                   & {x["item_id"] for x in eng.similar_items(o[0])}) >= 9
    assert all(1 <= calls[k] < 8 for k in calls), calls
    t.join(timeout=30)
    assert not t.is_alive()
    assert app.DRAIN_EXIT_CODE == 81 and outcome == {"code": 81}
    out = capsys.readouterr().out
    assert f":{port}" in out and '"drain"' in out
    with pytest.raises(OSError):
        urllib.request.urlopen(url + "/api/health", timeout=2)


def test_build_engine_options(tmp_path):
    cfg = _model_cfg()
    eng = app.build_engine(
        synthetic=True, model_cfg=cfg, device="cpu", quantized=True, exact_topk=True,
        catalog_dtype="bfloat16", spare_capacity=8, checkpoint_dir=str(tmp_path),
    )
    assert eng.pools is None and eng._qcat is not None  # int8 replaces the pools
    assert eng.approx_topk is False and eng.catalog_dev.dtype == torch.bfloat16
    assert eng.catalog.capacity == 2008 and eng.images_dir is None
    assert eng.cp_split is not None and eng.cir_split is not None and eng.fitb_split is not None
    assert len(eng.sample_cp(2)) == 2
    mock = app.build_engine(synthetic=True, mock=True, model_cfg=cfg)  # no device asked
    assert mock.mock and mock.cp_params is None and mock.pools is not None
    # The row-sharded catalog (one shard on the CPU) answers as the
    # unsharded engine does.
    sharded = app.build_engine(synthetic=True, model_cfg=cfg, device="cpu", shard_catalog=True)
    plain = app.build_engine(synthetic=True, model_cfg=cfg, device="cpu")
    assert sharded.mesh is not None and plain.mesh is None
    ids = plain.sample_outfit(4)
    assert sharded.cp_score(ids) == plain.cp_score(ids)
    assert sharded.similar_items(ids[0], k=5) == plain.similar_items(ids[0], k=5)
    # The int8 model forward is ported: the flag reaches the engine.
    q8 = app.build_engine(synthetic=True, model_cfg=cfg, device="cpu", quantize_model=True)
    assert q8.quantize_model and type(q8.cp_model).__name__ == "QuantizedOutfitX"
