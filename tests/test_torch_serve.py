"""The PyTorch port's serving engine against the JAX engine: the same
synthetic data, the same weights (through the weight bridge), exact top-k on
both sides, float32 at the tiny test scale."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from outfitx_tpu.data.sampler import CandidatePools as JaxPools
from outfitx_tpu.data.synthetic import make_synthetic as jax_make_synthetic
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu.serve.engine import ServingEngine as JaxEngine
from outfitx_tpu.train.checkpoint import CheckpointManager
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.data.sampler import CandidatePools
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models import state_dict_from_jax
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.ops.attention import masked_mha
from outfitx_tpu_torch.serve.app import build_engine
from outfitx_tpu_torch.serve.engine import ServingEngine, UnknownItemError

torch.set_num_threads(1)

TOL = 1e-5
DATA = dict(n_items=300, d_embed=64, n_outfits=64, max_len=8, seed=5)
POOL = dict(pool_size=20, threshold=1)


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


@pytest.fixture(scope="module")
def engines(tiny_cfg):
    params = JaxModel(tiny_cfg).init(jax.random.PRNGKey(0))
    jdata = jax_make_synthetic(**DATA)
    tdata = make_synthetic(**DATA)
    jax_eng = JaxEngine(
        model_cfg=tiny_cfg, catalog=jdata.catalog, cp_params=params,
        cir_params=params, pools=JaxPools.build(jdata.catalog, jdata.cir_valid, **POOL),
        approx_topk=False, warmup=False,
    )
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params))
    port = ServingEngine(
        model_cfg=port_config(tiny_cfg), catalog=tdata.catalog, cp_params=sd,
        cir_params=sd, pools=CandidatePools.build(tdata.catalog, tdata.cir_valid, **POOL),
        device="cpu",
    )
    # Category 0 keeps no pool: its targets take the whole-catalog route.
    for eng in (jax_eng, port):
        eng.pools.pools.pop(0)
    return jax_eng, port, jdata, tdata


def _requests(catalog, seed=0):
    rng = np.random.default_rng(seed)

    def outfit():
        return [int(i) for i in rng.choice(catalog.item_ids, int(rng.integers(1, 9)), replace=False)]

    def in_category(cid):
        return int(catalog.item_ids[rng.choice(np.flatnonzero(catalog.category_id == cid))])

    return outfit, in_category


def test_synthetic_data_and_pools_match(engines):
    jax_eng, port, jdata, tdata = engines
    jc, tc = jdata.catalog, tdata.catalog
    for name in ("item_ids", "embeddings", "category_id", "semantic_category"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name))
    assert tc.id_to_row == jc.id_to_row and tc.descriptions == jc.descriptions
    for split in ("cp_train", "cp_valid", "cir_train", "cir_valid", "fitb_test"):
        js, ts = getattr(jdata, split), getattr(tdata, split)
        for f in dataclasses.fields(js):
            np.testing.assert_array_equal(getattr(ts, f.name), getattr(js, f.name))
    assert sorted(port.pools.pools) == sorted(jax_eng.pools.pools)
    for cid, rows in jax_eng.pools.pools.items():
        np.testing.assert_array_equal(port.pools.pools[cid], rows)


def test_cp_scores_match(engines):
    jax_eng, port, _, tdata = engines
    outfit, _ = _requests(tdata.catalog, 1)
    outfits = [outfit() for _ in range(11)]  # two buckets of 8
    for o in outfits[:3]:
        assert abs(port.cp_score(o) - jax_eng.cp_score(o)) <= TOL
    np.testing.assert_allclose(
        port.cp_score_batch(outfits), jax_eng.cp_score_batch(outfits), rtol=0, atol=TOL
    )


def _same_items(got, want):
    assert [x["item_id"] for x in got] == [x["item_id"] for x in want]
    for g, w in zip(got, want):
        assert g["category_id"] == w["category_id"]
        assert g["description"] == w["description"]
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("category", [0, 3], ids=["whole_catalog", "pool"])
def test_cir_top10_matches(engines, category):
    jax_eng, port, _, tdata = engines
    outfit, in_category = _requests(tdata.catalog, 2 + category)
    for _ in range(3):
        o, t = outfit(), in_category(category)
        got = port.cir_top10(o, t)
        assert len(got) == 10
        _same_items(got, jax_eng.cir_top10(o, t))


def test_cir_top10_batch_matches(engines):
    jax_eng, port, _, tdata = engines
    outfit, in_category = _requests(tdata.catalog, 7)
    reqs = [(outfit(), in_category(i % 8)) for i in range(11)]
    for got, want in zip(port.cir_top10_batch(reqs), jax_eng.cir_top10_batch(reqs)):
        _same_items(got, want)


def test_fitb_pick_matches(engines):
    jax_eng, port, _, tdata = engines
    outfit, in_category = _requests(tdata.catalog, 8)
    for i in range(6):
        o = outfit()
        cands = [in_category(i % 8) for _ in range(4 + i % 3)]
        assert port.fitb_pick(o, cands) == jax_eng.fitb_pick(o, cands)


def test_similar_items_match(engines):
    jax_eng, port, _, tdata = engines
    for item in tdata.catalog.item_ids[:4]:
        _same_items(port.similar_items(int(item), k=5), jax_eng.similar_items(int(item), k=5))
    items = [int(i) for i in tdata.catalog.item_ids[10:20]]
    for got, want in zip(port.similar_items_batch(items), jax_eng.similar_items_batch(items)):
        _same_items(got, want)


def test_cpu_engine_launches_no_kernel(engines):
    _, port, _, tdata = engines
    before = masked_mha.launches
    port.cp_score([int(i) for i in tdata.catalog.item_ids[:3]])
    assert masked_mha.launches == before


def test_unknown_item_raises(engines):
    _, port, _, _ = engines
    with pytest.raises(UnknownItemError):
        port.cp_score([1])


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_mesh_engine_matches_jax(engines, tiny_cfg, quantized):
    """The catalog row-sharded over 4 shards (one CPU device named 4
    times): the JAX engine's answers, pools and whole-catalog routes."""
    from outfitx_tpu_torch.core.mesh import MeshSpec, make_mesh

    jax_eng, port, _, tdata = engines
    meshed = ServingEngine(
        model_cfg=port.model_cfg, catalog=make_synthetic(**DATA).catalog,
        cp_params=port.cp_params, cir_params=port.cp_params, pools=port.pools,
        device="cpu", warmup=False, quantized=quantized,
        mesh=make_mesh(MeshSpec(data=4), devices=["cpu"] * 4),
    )
    outfit, in_category = _requests(tdata.catalog, 21)
    o = outfit()
    assert abs(meshed.cp_score(o) - jax_eng.cp_score(o)) <= TOL
    for category in (3, 0):  # a pool, then the whole catalog
        t = in_category(category)
        if quantized and category == 0:  # the int8 route: vs the port's own
            single = ServingEngine(
                model_cfg=port.model_cfg, catalog=make_synthetic(**DATA).catalog,
                cp_params=port.cp_params, cir_params=port.cp_params, pools=port.pools,
                device="cpu", warmup=False, quantized=True,
            )
            _same_items(meshed.cir_top10(o, t), single.cir_top10(o, t))
            continue
        _same_items(meshed.cir_top10(o, t), jax_eng.cir_top10(o, t))
    item = int(tdata.catalog.item_ids[7])
    if not quantized:
        _same_items(meshed.similar_items(item, k=5), jax_eng.similar_items(item, k=5))
    cands = [in_category(2) for _ in range(4)]
    assert meshed.fitb_pick(o, cands) == jax_eng.fitb_pick(o, cands)


def test_device_defaults_to_cuda_and_raises_without_it(tiny_cfg):
    data = make_synthetic(**DATA)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model_cfg=port_config(tiny_cfg), catalog=data.catalog)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine(synthetic=True, model_cfg=port_config(tiny_cfg))


@pytest.mark.parametrize(
    "option, error, match",
    [
        # The int8 forward is ported; its attn="block" route exists in
        # neither package.
        ({"quantize_model": True, "attn": "block"}, ValueError, "no attn='block' route"),
    ],
    ids=["quantize_model"],
)
def test_unported_routes_raise(tiny_cfg, option, error, match):
    data = make_synthetic(**DATA)
    with pytest.raises(error, match=match):
        ServingEngine(
            model_cfg=port_config(tiny_cfg), catalog=data.catalog, device="cpu",
            warmup=False, **option,
        )


@pytest.mark.parametrize(
    "option",
    [
        {"quantized": True},
        {"spare_capacity": 16},
        {"chunk_threshold": 100},
        {"catalog_dtype": "bfloat16"},
        {"approx_topk": False},
    ],
    ids=lambda o: next(iter(o)),
)
def test_ported_routes_build_and_answer(tiny_cfg, option):
    data = make_synthetic(**DATA)
    sd = OutfitXModel(port_config(tiny_cfg), device="cpu", seed=0).state_dict()
    eng = ServingEngine(
        model_cfg=port_config(tiny_cfg), catalog=data.catalog, cp_params=sd,
        cir_params=sd, device="cpu", **option,  # with the warmup
    )
    ids = eng.sample_outfit(4)
    assert 0.0 <= eng.cp_score(ids) <= 1.0
    assert len(eng.cir_top10(ids[:3], ids[3])) == 10
    assert len(eng.similar_items(ids[0], k=5)) == 5
    assert eng._route.chunked == ("chunk_threshold" in option)
    assert (eng._qcat is not None) == ("quantized" in option)


def test_unknown_catalog_dtype_raises(tiny_cfg):
    data = make_synthetic(**DATA)
    with pytest.raises(ValueError, match="catalog_dtype"):
        ServingEngine(
            model_cfg=port_config(tiny_cfg), catalog=data.catalog, device="cpu",
            catalog_dtype="float16",
        )


_ROUTE_ENGINES = {}


def _route_engines(tiny_cfg, quantized, chunk_threshold, approx):
    """The JAX engine with exact top-k and the port's engine on one route of
    the whole-catalog matrix (no pools), from the same weights. The JAX
    engines are kept: a route's programs compile once per process."""
    if "params" not in _ROUTE_ENGINES:
        params = JaxModel(tiny_cfg).init(jax.random.PRNGKey(0))
        _ROUTE_ENGINES["params"] = params
        _ROUTE_ENGINES["sd"] = state_dict_from_jax(jax.tree.map(np.asarray, params))
    key = (quantized, chunk_threshold)
    if key not in _ROUTE_ENGINES:
        _ROUTE_ENGINES[key] = JaxEngine(
            model_cfg=tiny_cfg, catalog=jax_make_synthetic(**DATA).catalog,
            cp_params=_ROUTE_ENGINES["params"], cir_params=_ROUTE_ENGINES["params"],
            approx_topk=False, warmup=False, quantized=quantized,
            chunk_threshold=chunk_threshold,
        )
    port = ServingEngine(
        model_cfg=port_config(tiny_cfg), catalog=make_synthetic(**DATA).catalog,
        cp_params=_ROUTE_ENGINES["sd"], cir_params=_ROUTE_ENGINES["sd"], device="cpu",
        warmup=False, quantized=quantized, chunk_threshold=chunk_threshold,
        approx_topk=approx,
    )
    return _ROUTE_ENGINES[key], port


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("chunk_threshold", [262_144, 100], ids=["materialised", "chunked"])
@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_route_matrix_matches_jax(tiny_cfg, quantized, chunk_threshold, approx):
    """{dense, int8} x {materialised, chunked} x {approx, exact}: CP at 1e-4,
    and the rows of whole-catalog CIR and similar items equal to the JAX
    engine's on the same route with exact top-k (the int8 rows to JAX's int8
    route; the port's ``approx`` is exact)."""
    jax_eng, port = _route_engines(tiny_cfg, quantized, chunk_threshold, approx)
    assert port._route == port._route.__class__(
        n_rows=300, quantized=quantized, chunked=chunk_threshold < 300,
        chunk_size=chunk_threshold, approx=approx,
    )
    if quantized:
        np.testing.assert_array_equal(
            port._qcat.values.numpy(), np.asarray(jax_eng._qcat.values)
        )
    outfit, in_category = _requests(port.catalog, 11)
    for i in range(3):
        o, t = outfit(), in_category(i)
        assert abs(port.cp_score(o) - jax_eng.cp_score(o)) <= 1e-4
        _same_items(port.cir_top10(o, t), jax_eng.cir_top10(o, t))
    items = [int(i) for i in port.catalog.item_ids[20:31]]  # two buckets
    for got, want in zip(port.similar_items_batch(items, k=5),
                         jax_eng.similar_items_batch(items, k=5)):
        _same_items(got, want)
    _same_items(port.similar_items(items[0], k=5), jax_eng.similar_items(items[0], k=5))


def test_bf16_catalog_matches_jax(tiny_cfg):
    """catalog_dtype="bfloat16": the device catalog equals the JAX engine's
    bit for bit (both round on the host), half the bytes, and the answers
    stay within the storage rounding of the float32 catalog's."""
    params = JaxModel(tiny_cfg).init(jax.random.PRNGKey(0))
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params))
    jax_eng = JaxEngine(
        model_cfg=tiny_cfg, catalog=jax_make_synthetic(**DATA).catalog,
        cp_params=params, cir_params=params, approx_topk=False, warmup=False,
        catalog_dtype="bfloat16",
    )
    mk = lambda dt: ServingEngine(
        model_cfg=port_config(tiny_cfg), catalog=make_synthetic(**DATA).catalog,
        cp_params=sd, cir_params=sd, device="cpu", warmup=False, catalog_dtype=dt,
    )
    f32, bf16 = mk("float32"), mk("bfloat16")
    assert bf16.catalog_dev.dtype == torch.bfloat16
    assert bf16.catalog_dev.nbytes * 2 == f32.catalog_dev.nbytes
    np.testing.assert_array_equal(
        bf16.catalog_dev.float().numpy(),
        np.asarray(jax_eng.catalog_dev).astype(np.float32),
    )
    outfit, in_category = _requests(f32.catalog, 12)
    outfits = [outfit() for _ in range(4)]
    a = np.asarray([f32.cp_score(o) for o in outfits])
    b = np.asarray([bf16.cp_score(o) for o in outfits])
    np.testing.assert_allclose(a, b, atol=2e-2)
    np.testing.assert_allclose(b, [jax_eng.cp_score(o) for o in outfits], atol=1e-4)
    o, t = outfit(), in_category(0)
    got = {x["item_id"] for x in bf16.cir_top10(o, t)}
    assert len(got & {x["item_id"] for x in f32.cir_top10(o, t)}) >= 8
    assert len(got & {x["item_id"] for x in jax_eng.cir_top10(o, t)}) >= 9


@pytest.mark.parametrize("n_cands", [2, 3, 4, 5, 8, 9])
def test_fitb_candidate_buckets_match_jax(engines, n_cands):
    """Any candidate count runs at a power-of-two bucket of at least 4, padded
    with candidate 0; the pick equals the JAX engine's, and a pad never wins."""
    jax_eng, port, _, tdata = engines
    outfit, in_category = _requests(tdata.catalog, 20 + n_cands)
    for i in range(3):
        o = outfit()
        cands = [in_category((i + j) % 8) for j in range(n_cands)]
        pick = port.fitb_pick(o, cands)
        assert 0 <= pick < n_cands
        assert pick == jax_eng.fitb_pick(o, cands)


def test_build_engine_loads_jax_checkpoints(tiny_cfg, tmp_path):
    """build_engine takes the CP and CIR weights from the JAX package's
    checkpoint directories and answers as the JAX engine does with them."""
    cfg = port_config(tiny_cfg)
    cp = JaxModel(tiny_cfg).init(jax.random.PRNGKey(1))
    cir = JaxModel(tiny_cfg).init(jax.random.PRNGKey(2))
    CheckpointManager(tmp_path, cfg.model_name + "-cp").save("best_auc", params=cp)
    CheckpointManager(tmp_path, cfg.model_name + "-cir").save("best_recall@1", params=cir)
    port = build_engine(
        synthetic=True, model_cfg=cfg, checkpoint_dir=str(tmp_path), device="cpu"
    )
    assert port.cir_model is not port.cp_model
    for model, params in ((port.cp_model, cp), (port.cir_model, cir)):
        want = state_dict_from_jax(jax.tree.map(np.asarray, params))
        got = model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
    jdata = jax_make_synthetic(
        n_items=2000, d_embed=cfg.d_embed, n_outfits=256, max_len=cfg.max_outfit_len
    )
    jax_eng = JaxEngine(
        model_cfg=tiny_cfg, catalog=jdata.catalog, cp_params=cp, cir_params=cir,
        pools=JaxPools.build(jdata.catalog, jdata.cir_valid, pool_size=1000, threshold=1),
        approx_topk=False, warmup=False,
    )
    outfit = [int(i) for i in jdata.catalog.item_ids[:5]]
    assert abs(port.cp_score(outfit) - jax_eng.cp_score(outfit)) <= TOL
    assert port.fitb_pick(outfit[:3], outfit[1:]) == jax_eng.fitb_pick(outfit[:3], outfit[1:])
