"""Live catalog updates and appends in the PyTorch port: the counterparts of
the JAX package's ``TestLiveCatalogUpdates``, ``TestCatalogAppend``,
``TestReviewHardening`` and ``TestConcurrentUpdates`` (tests/test_serve.py;
the mesh cases excepted), and the port's engine against the JAX engine after
the same sequence of updates and appends. Every test builds its own engine."""

import concurrent.futures
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
from outfitx_tpu.data.synthetic import make_synthetic as jax_make_synthetic
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu.serve.engine import ServingEngine as JaxEngine
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models import state_dict_from_jax
from outfitx_tpu_torch.ops.quantization import quantize_catalog
from outfitx_tpu_torch.serve.engine import ServingEngine, UnknownItemError

torch.set_num_threads(1)

D = 64  # tiny_cfg's d_embed


def port_config(cfg):
    def copy(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in dataclasses.asdict(src).items() if k in names}

    return tcfg.OutfitXConfig(
        item_encoder=tcfg.ItemEncoderConfig(**copy(tcfg.ItemEncoderConfig, cfg.item_encoder)),
        transformer=tcfg.TransformerConfig(**copy(tcfg.TransformerConfig, cfg.transformer)),
        max_outfit_len=cfg.max_outfit_len,
        param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype,
    )


_JAX_PARAMS = {}


def _params(tiny_cfg):
    """(JAX parameter tree, the port's state dict) from one seed."""
    if not _JAX_PARAMS:
        params = JaxModel(tiny_cfg).init(jax.random.PRNGKey(0))
        _JAX_PARAMS["jax"] = params
        _JAX_PARAMS["torch"] = state_dict_from_jax(jax.tree.map(np.asarray, params))
    return _JAX_PARAMS["jax"], _JAX_PARAMS["torch"]


def _engine(tiny_cfg, *, synth=None, **kw):
    data = make_synthetic(**{
        "n_items": 300, "d_embed": D, "n_outfits": 64, "max_len": 8, "seed": 21,
        **(synth or {}),
    })
    sd = _params(tiny_cfg)[1]
    splits = {
        name: getattr(data, attr)
        for name, attr in (("cp_split", "cp_valid"), ("fitb_split", "fitb_test"))
        if kw.pop(f"with_{name}", False)
    }
    return ServingEngine(**{
        "model_cfg": port_config(tiny_cfg), "catalog": data.catalog,
        "cp_params": sd, "cir_params": sd, "device": "cpu", "warmup": False,
        **splits, **kw,
    })


class TestLiveCatalogUpdates:
    def test_update_moves_neighbours_and_scores(self, tiny_cfg):
        eng = _engine(tiny_cfg)
        ids = eng.sample_outfit(3)
        target, clone_src = ids[0], ids[1]
        before = eng.cp_score(ids)
        new_emb = np.array(eng.catalog.embeddings[eng.lookup_row(clone_src)])
        eng.update_items([target], new_emb[None])
        row = eng.lookup_row(target)
        np.testing.assert_array_equal(eng.catalog.embeddings[row], new_emb)
        np.testing.assert_array_equal(eng.catalog_dev[row].numpy(), new_emb)
        sims = eng.similar_items(clone_src, k=3)
        assert sims[0]["item_id"] == target and sims[0]["score"] < 1e-6
        assert eng.cp_score(ids) != before
        assert eng.n_updated_rows == 1

    def test_update_unknown_id_raises(self, tiny_cfg):
        eng = _engine(tiny_cfg)
        with pytest.raises(UnknownItemError):
            eng.update_items([10**9], np.zeros((1, D), np.float32))
        with pytest.raises(ValueError):
            eng.update_items([eng.sample_outfit(1)[0]], np.zeros((1, 7), np.float32))
        eng.update_items([], np.zeros((0, D), np.float32))  # no-op
        assert eng.n_updated_rows == 0

    def test_update_chunks_and_padding(self, tiny_cfg):
        eng = _engine(tiny_cfg)
        eng.update_bucket = 4  # the chunk loop and the padded tail
        ids = [int(i) for i in eng.catalog.item_ids[:10]]
        vals = np.random.default_rng(3).normal(size=(10, D)).astype(np.float32)
        untouched = eng.catalog_dev[10:].clone()
        eng.update_items(ids, vals)
        rows = [eng.lookup_row(i) for i in ids]
        np.testing.assert_array_equal(eng.catalog_dev[rows].numpy(), vals)
        assert torch.equal(eng.catalog_dev[10:], untouched)

    def test_update_descriptions(self, tiny_cfg):
        eng = _engine(tiny_cfg)
        item = int(eng.catalog.item_ids[4])
        eng.update_items([item], np.ones((1, D), np.float32), descriptions=["fresh text"])
        assert eng._item_info(4, 0.0)["description"] == "fresh text"

    def test_quantized_rows_match_full_requantize(self, tiny_cfg):
        eng = _engine(tiny_cfg, quantized=True, pools=None)
        before = [t.clone() for t in (eng._qcat.values, eng._qcat.scales, eng._qcat.sq_norms)]
        ids = [int(i) for i in eng.catalog.item_ids[5:9]]
        vals = np.random.default_rng(5).normal(size=(4, D)).astype(np.float32)
        eng.update_items(ids, vals)
        full = quantize_catalog(eng.catalog_dev, n_rows=eng.catalog.pad_row)
        # every row, touched or not, equals the full requantisation
        for name in ("values", "scales", "sq_norms"):
            assert torch.equal(getattr(eng._qcat, name), getattr(full, name)), name
        assert not torch.equal(eng._qcat.values, before[0])

    def test_bf16_catalog_update(self, tiny_cfg):
        eng = _engine(tiny_cfg, catalog_dtype="bfloat16")
        vals = np.full((1, D), 0.5, np.float32)
        eng.update_items([int(eng.catalog.item_ids[0])], vals)
        assert eng.catalog_dev.dtype == torch.bfloat16
        np.testing.assert_array_equal(eng.catalog_dev[0].float().numpy(), vals[0])


class TestCatalogAppend:
    def test_sentinels_never_retrieved_then_append_found(self, tiny_cfg):
        eng = _engine(tiny_cfg, synth={"n_items": 200, "seed": 31}, spare_capacity=16)
        assert eng.catalog.capacity == 216 and eng.catalog.n_items == 200
        assert eng.catalog_dev.shape[0] == 217 and eng._route.n_rows == 216
        assert float(eng.catalog_dev[200:216].min()) == eng.catalog.SENTINEL
        assert not eng.catalog_dev[216].any()
        src = int(eng.catalog.item_ids[7])
        sims = eng.similar_items(src, k=10)
        assert len(sims) == 10
        assert all(s["item_id"] in eng.catalog.id_to_row for s in sims)
        new_id = 999_001
        emb = np.asarray(eng.catalog.embeddings[eng.lookup_row(src)])
        eng.add_items(
            [new_id], emb[None],
            category_ids=[int(eng.catalog.category_id[eng.lookup_row(src)])],
            descriptions=["appended clone"],
        )
        assert eng.catalog.n_items == 201 and eng.n_appended_items == 1
        sims = eng.similar_items(src, k=3)
        assert sims[0]["item_id"] == new_id
        assert sims[0]["description"] == "appended clone"
        assert 0.0 <= eng.cp_score([src, new_id] + eng.sample_outfit(2)) <= 1.0
        assert len(eng.cir_top10(eng.sample_outfit(3), new_id)) == 10

    def test_capacity_and_duplicate_errors(self, tiny_cfg):
        eng = _engine(tiny_cfg, synth={"n_items": 200}, spare_capacity=16)
        with pytest.raises(ValueError, match="capacity"):
            eng.add_items(list(range(1_000_000, 1_000_017)), np.zeros((17, D), np.float32))
        with pytest.raises(ValueError, match="already"):
            eng.add_items([int(eng.catalog.item_ids[0])], np.zeros((1, D), np.float32))
        with pytest.raises(ValueError, match="shape"):
            eng.add_items([1_000_000], np.zeros((1, 3), np.float32))
        assert eng.catalog.n_items == 200

    def test_quantized_append_matches_full_requantize(self, tiny_cfg):
        eng = _engine(
            tiny_cfg, synth={"n_items": 200}, spare_capacity=16, quantized=True,
            pools=None,
        )
        vals = np.random.default_rng(13).normal(size=(3, D)).astype(np.float32)
        eng.add_items([777_001, 777_002, 777_003], vals)
        full = quantize_catalog(eng.catalog_dev, n_rows=eng.catalog.pad_row)
        for name in ("values", "scales", "sq_norms"):
            assert torch.equal(getattr(eng._qcat, name), getattr(full, name)), name
        sims = eng.similar_items(777_001, k=3)
        assert len(sims) == 3
        assert all(s["item_id"] in eng.catalog.id_to_row for s in sims)

    def test_split_pad_rows_remapped(self, tiny_cfg):
        eng = _engine(
            tiny_cfg, synth={"n_items": 200, "seed": 31}, spare_capacity=8,
            with_cp_split=True, with_fitb_split=True,
        )
        pad = eng.catalog.pad_row
        assert pad == 208
        rows = eng.cp_split.item_rows
        assert (rows <= pad).all() and (rows == pad).any()
        assert not ((rows >= eng.catalog.n_items) & (rows < pad)).any()
        samples = eng.sample_cp(n=2)
        assert len(samples) == 2 and all(0 <= r["prob"] <= 1 for r in samples)
        assert len(eng.sample_fitb(n=2)) == 2


class TestReviewHardening:
    def test_fitb_any_candidate_count_buckets(self, tiny_cfg):
        eng = _engine(tiny_cfg)
        ids = eng.sample_outfit(8)
        outfit, cands5 = ids[:3], ids[3:8]
        pick5 = eng.fitb_pick(outfit, cands5)
        assert 0 <= pick5 < 5
        assert eng.fitb_pick(outfit, cands5 + [cands5[0]] * 3) == pick5
        assert 0 <= eng.fitb_pick(outfit, cands5 + [cands5[1]]) < 6
        # 2 candidates run at the bucket of 4; a pad can never win
        assert 0 <= eng.fitb_pick(outfit, cands5[:2]) < 2

    def test_tiny_catalog_with_spares_returns_only_real_items(self, tiny_cfg):
        eng = _engine(
            tiny_cfg, spare_capacity=64,
            synth={"n_items": 9, "n_styles": 1, "outfit_len": (2, 3), "n_outfits": 8,
                   "seed": 9},
        )
        ids = [int(i) for i in eng.catalog.item_ids[:4]]
        real = {int(i) for i in eng.catalog.item_ids[:9]}
        sims = eng.similar_items(ids[0], k=10)  # k + 1 > n_items
        assert 0 < len(sims) <= 8 and all(s["item_id"] in real for s in sims)
        top = eng.cir_top10(ids[:2], ids[2])
        assert 0 < len(top) <= 9
        batch = eng.cir_top10_batch([(ids[:2], ids[2])])[0]
        assert [t["item_id"] for t in batch] == [t["item_id"] for t in top]
        sims_b = eng.similar_items_batch([ids[0]], k=10)[0]
        assert [s["item_id"] for s in sims_b] == [s["item_id"] for s in sims]

    def test_duplicate_update_ids_last_wins_on_device(self, tiny_cfg):
        eng = _engine(tiny_cfg, quantized=True)
        a = int(eng.catalog.item_ids[0])
        row = eng.lookup_row(a)
        rng = np.random.default_rng(3)
        v1, v2 = (rng.normal(size=(D,)).astype(np.float32) for _ in range(2))
        eng.update_items([a, a], np.stack([v1, v2]))
        np.testing.assert_array_equal(eng.catalog.embeddings[row], v2)
        np.testing.assert_array_equal(eng.catalog_dev[row].numpy(), v2)
        full = quantize_catalog(eng.catalog_dev, n_rows=eng.catalog.pad_row)
        assert torch.equal(eng._qcat.values, full.values)

    @pytest.mark.parametrize("catalog_dtype", ["float32", "bfloat16"])
    def test_scatter_warmup_is_bit_exact(self, tiny_cfg, catalog_dtype):
        cold = _engine(tiny_cfg, quantized=True, catalog_dtype=catalog_dtype)
        warm = _engine(tiny_cfg, quantized=True, catalog_dtype=catalog_dtype, warmup=True)
        assert torch.equal(cold.catalog_dev, warm.catalog_dev)
        for name in ("values", "scales", "sq_norms"):
            assert torch.equal(getattr(cold._qcat, name), getattr(warm._qcat, name)), name
        assert warm.n_updated_rows == 0

    def test_device_catalog_is_the_engines_own_copy(self, tiny_cfg):
        """The in-place row writes must not reach the host array through
        shared memory (``torch.from_numpy`` alone would share it)."""
        eng = _engine(tiny_cfg)
        eng.catalog_dev[0] = 7.0
        assert float(eng.catalog.embeddings[0, 0]) != 7.0


class TestConcurrentUpdates:
    def test_requests_survive_update_storm(self, tiny_cfg):
        eng = _engine(
            tiny_cfg, synth={"n_items": 200, "seed": 41}, quantized=True,
            pools=None, spare_capacity=64,
        )
        rng = np.random.default_rng(0)
        rng_lock = threading.Lock()
        ids = [int(i) for i in eng.catalog.item_ids[:8]]

        def row():
            with rng_lock:
                return rng.normal(size=(1, D)).astype(np.float32)

        def updater(i):
            if i % 3 == 0:
                eng.add_items([500_000 + i], row())
            else:
                eng.update_items([ids[i % 8]], row())
            return "u"

        def requester(i):
            if i % 2:
                return eng.cp_score(ids[: 2 + i % 4])
            return eng.similar_items(ids[i % 8], k=5)

        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            futs = [
                ex.submit(updater if i % 4 == 0 else requester, i) for i in range(48)
            ]
            results = [f.result() for f in futs]  # raises on any failure
        assert len(results) == 48
        for r in results:
            if isinstance(r, list):
                assert len(r) == 5 and all(s["item_id"] in eng.catalog.id_to_row for s in r)
            elif r != "u":
                assert 0.0 <= r <= 1.0
        assert eng.catalog.n_items == 200 + len(
            [i for i in range(48) if i % 4 == 0 and i % 3 == 0]
        )
        # host, device and int8 catalogs agree after the storm
        np.testing.assert_array_equal(eng.catalog_dev.numpy(), eng.catalog.embeddings)
        full = quantize_catalog(eng.catalog_dev, n_rows=eng.catalog.pad_row)
        assert torch.equal(eng._qcat.values, full.values)
        assert torch.equal(eng._qcat.scales, full.scales)

    def test_request_never_sees_a_torn_catalog(self, tiny_cfg):
        """A task that reads the catalog twice, with an update arriving
        between the reads, sees one catalog: the update waits for the
        request's device work, and the next request sees it whole."""
        eng = _engine(tiny_cfg)
        rows = np.arange(16, dtype=np.int32)
        ids = [int(i) for i in eng.catalog.item_ids[:16]]
        first_read = threading.Event()

        def two_reads(cat, r):
            a = cat[r].clone()
            first_read.set()
            time.sleep(0.3)  # the updater is blocked on the lock meanwhile
            return a, cat[r].clone()

        def updater():
            assert first_read.wait(timeout=10)
            eng.update_items(ids, np.full((16, D), 3.0, np.float32))

        t = threading.Thread(target=updater)
        t.start()
        a, b = eng._run(two_reads, eng.catalog_dev, rows)
        t.join(timeout=10)
        assert not t.is_alive()
        assert torch.equal(a, b) and not (a == 3.0).all()
        after, _ = eng._run(two_reads, eng.catalog_dev, rows)
        assert (after == 3.0).all()


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_engine_state_equals_jax_after_the_same_updates(tiny_cfg, quantized):
    """The same updates (one with a duplicate id) and appends through both
    engines: host and device catalogs equal, the int8 table bit-equal, and
    the answers after them equal (exact top-k on both sides)."""
    synth = dict(n_items=200, d_embed=D, n_outfits=64, max_len=8, seed=31)
    jparams, sd = _params(tiny_cfg)
    jdata = jax_make_synthetic(**synth)
    jax_eng = JaxEngine(
        model_cfg=tiny_cfg, catalog=jdata.catalog, cp_params=jparams,
        cir_params=jparams, approx_topk=False, warmup=False, spare_capacity=16,
        quantized=quantized, update_bucket=4,
    )
    port = _engine(
        tiny_cfg, synth=synth, spare_capacity=16, quantized=quantized,
        approx_topk=False, update_bucket=4,
    )
    rng = np.random.default_rng(17)
    ids = [int(i) for i in port.catalog.item_ids[:6]]
    upd = rng.normal(size=(7, D)).astype(np.float32)
    new = rng.normal(size=(5, D)).astype(np.float32)
    new_ids = [880_001 + i for i in range(5)]
    for eng in (jax_eng, port):
        eng.update_items(ids + ids[:1], upd)  # the first id twice: last wins
        eng.add_items(new_ids[:3], new[:3], category_ids=[1, 2, 3])
        eng.update_items([new_ids[0]], upd[:1], descriptions=["renamed"])
        eng.add_items(new_ids[3:], new[3:], semantic_categories=["x", "y"])

    jc, tc = jax_eng.catalog, port.catalog
    for name in ("item_ids", "embeddings", "category_id", "semantic_category"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name))
    assert tc.id_to_row == jc.id_to_row and tc.descriptions == jc.descriptions
    assert tc.semantic_vocab == jc.semantic_vocab
    assert (port.n_updated_rows, port.n_appended_items) == (
        jax_eng.n_updated_rows, jax_eng.n_appended_items
    )
    np.testing.assert_array_equal(port.catalog_dev.numpy(), np.asarray(jax_eng.catalog_dev))
    if quantized:
        np.testing.assert_array_equal(
            port._qcat.values.numpy(), np.asarray(jax_eng._qcat.values)
        )
        np.testing.assert_array_equal(
            port._qcat.scales.numpy(), np.asarray(jax_eng._qcat.scales)
        )
        np.testing.assert_allclose(
            port._qcat.sq_norms.numpy(), np.asarray(jax_eng._qcat.sq_norms), rtol=1e-6
        )

    outfit = ids[1:4] + [new_ids[1]]
    assert abs(port.cp_score(outfit) - jax_eng.cp_score(outfit)) <= 1e-5
    for item in (ids[0], new_ids[0], new_ids[4]):
        got, want = port.similar_items(item, k=5), jax_eng.similar_items(item, k=5)
        assert [x["item_id"] for x in got] == [x["item_id"] for x in want]
        np.testing.assert_allclose(
            [x["score"] for x in got], [x["score"] for x in want], rtol=1e-4, atol=1e-4
        )
    got, want = port.cir_top10(outfit, new_ids[2]), jax_eng.cir_top10(outfit, new_ids[2])
    assert [x["item_id"] for x in got] == [x["item_id"] for x in want]
    assert [x["description"] for x in got] == [x["description"] for x in want]
