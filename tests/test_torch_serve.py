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


def test_device_defaults_to_cuda_and_raises_without_it(tiny_cfg):
    data = make_synthetic(**DATA)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model_cfg=port_config(tiny_cfg), catalog=data.catalog)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine(synthetic=True, model_cfg=port_config(tiny_cfg))


@pytest.mark.parametrize(
    "option",
    [
        {"quantized": True},
        {"quantize_model": True},
        {"spare_capacity": 16},
        {"mesh": object()},
        {"chunk_threshold": 100},
    ],
    ids=lambda o: next(iter(o)),
)
def test_unported_routes_raise(tiny_cfg, option):
    data = make_synthetic(**DATA)
    with pytest.raises(NotImplementedError):
        ServingEngine(
            model_cfg=port_config(tiny_cfg), catalog=data.catalog, device="cpu",
            warmup=False, **option,
        )


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
