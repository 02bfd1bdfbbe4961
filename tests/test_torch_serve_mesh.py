"""The port's serving engine on a mesh (the catalog row-sharded over 8
shards, one CPU device named 8 times) against the JAX engine on its 8 fake
devices: the same synthetic data and weights, exact top-k on both sides,
dense and int8 catalogs, before and after the same live updates and
appends, and ``build_engine(shard_catalog=True)``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from outfitx_tpu.core.mesh import MeshSpec as JaxMeshSpec
from outfitx_tpu.core.mesh import make_mesh as jax_make_mesh
from outfitx_tpu.data.synthetic import make_synthetic as jax_make_synthetic
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu.serve.engine import ServingEngine as JaxEngine
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.core.mesh import MeshSpec, make_mesh
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models import state_dict_from_jax
from outfitx_tpu_torch.ops.retrieval_sharded import ShardedRows
from outfitx_tpu_torch.serve.app import build_engine
from outfitx_tpu_torch.serve.engine import ServingEngine

torch.set_num_threads(1)

DATA = dict(n_items=301, d_embed=64, n_outfits=64, max_len=8, seed=5)


def port_config(cfg):
    def copy(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(src).items() if k in names})

    return tcfg.OutfitXConfig(
        item_encoder=copy(tcfg.ItemEncoderConfig, cfg.item_encoder),
        transformer=copy(tcfg.TransformerConfig, cfg.transformer),
        max_outfit_len=cfg.max_outfit_len,
        param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype,
    )


def _pair(tiny_cfg, **kw):
    params = JaxModel(tiny_cfg).init(jax.random.PRNGKey(0))
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params))
    common = dict(approx_topk=False, warmup=False, **kw)
    jax_eng = JaxEngine(
        model_cfg=tiny_cfg, catalog=jax_make_synthetic(**DATA).catalog, cp_params=params,
        cir_params=params, mesh=jax_make_mesh(JaxMeshSpec(data=8, model=1)), **common,
    )
    port = ServingEngine(
        model_cfg=port_config(tiny_cfg), catalog=make_synthetic(**DATA).catalog,
        cp_params=sd, cir_params=sd, device="cpu",
        mesh=make_mesh(MeshSpec(data=8), devices=["cpu"] * 8), **common,
    )
    return jax_eng, port


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "int8"])
def engines(request, tiny_cfg):
    return _pair(tiny_cfg, quantized=request.param, spare_capacity=8, update_bucket=4)


def _same_items(got, want):
    assert [x["item_id"] for x in got] == [x["item_id"] for x in want]
    np.testing.assert_allclose(
        [x["score"] for x in got], [x["score"] for x in want], rtol=1e-4, atol=1e-4
    )


def _answers_match(jax_eng, port, seed):
    rng = np.random.default_rng(seed)
    ids = port.catalog.item_ids[: port.catalog.n_items]
    for _ in range(3):
        outfit = [int(i) for i in rng.choice(ids, 4, replace=False)]
        target = int(rng.choice(ids))
        assert abs(port.cp_score(outfit) - jax_eng.cp_score(outfit)) <= 1e-5
        _same_items(port.cir_top10(outfit, target), jax_eng.cir_top10(outfit, target))
        cands = [int(i) for i in rng.choice(ids, 4, replace=False)]
        assert port.fitb_pick(outfit, cands) == jax_eng.fitb_pick(outfit, cands)
        item = int(rng.choice(ids))
        _same_items(port.similar_items(item, k=5), jax_eng.similar_items(item, k=5))


def test_catalog_is_row_sharded_with_padding(engines):
    jax_eng, port = engines
    cat = port.catalog_dev
    assert isinstance(cat, ShardedRows) and len(cat.shards) == 8
    # 301 items + 8 spare rows + PAD = 310 rows, padded to 312
    assert cat.shape[0] == np.asarray(jax_eng.catalog_dev).shape[0] == 312
    np.testing.assert_array_equal(
        torch.cat(cat.shards).numpy(), np.asarray(jax_eng.catalog_dev)
    )
    if port.quantized:
        assert isinstance(port._qcat.values, ShardedRows)
        np.testing.assert_array_equal(
            torch.cat(port._qcat.values.shards).numpy(), np.asarray(jax_eng._qcat.values)
        )


def test_answers_match_jax_mesh_engine(engines):
    _answers_match(*engines, seed=1)


def test_answers_match_after_update_and_append(engines):
    jax_eng, port = engines
    rng = np.random.default_rng(9)
    d = port.catalog.d_embed
    ids = [int(i) for i in port.catalog.item_ids[40:44]] + [int(port.catalog.item_ids[299])]
    vals = rng.normal(size=(5, d)).astype(np.float32)
    new = rng.normal(size=(3, d)).astype(np.float32)
    for eng in (jax_eng, port):
        eng.update_items(ids, vals)
        eng.add_items([990_001, 990_002, 990_003], new, category_ids=[1, 2, 3])
    np.testing.assert_array_equal(
        torch.cat(port.catalog_dev.shards).numpy(), np.asarray(jax_eng.catalog_dev)
    )
    _answers_match(jax_eng, port, seed=2)
    # an appended row is found: its own nearest neighbour after itself
    src = int(port.catalog.item_ids[3])
    emb = np.asarray(port.catalog.embeddings[port.lookup_row(src)])
    for eng in (jax_eng, port):
        eng.add_items([990_010], emb[None])
    assert port.similar_items(src, k=3)[0]["item_id"] == 990_010
    _same_items(port.similar_items(src, k=3), jax_eng.similar_items(src, k=3))


def test_mesh_engine_equals_single_engine(tiny_cfg):
    """The sharded route gives the one-device engine's answers."""
    _, meshed = _pair(tiny_cfg, quantized=True)
    params = JaxModel(tiny_cfg).init(jax.random.PRNGKey(0))
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params))
    single = ServingEngine(
        model_cfg=port_config(tiny_cfg), catalog=make_synthetic(**DATA).catalog,
        cp_params=sd, cir_params=sd, device="cpu", quantized=True,
        approx_topk=False, warmup=False,
    )
    _answers_match(single, meshed, seed=3)


def test_quantize_model_on_mesh(tiny_cfg):
    """The int8 forward composes with the sharded catalog, as in JAX."""
    jax_eng, port = _pair(tiny_cfg, quantize_model=True)
    rng = np.random.default_rng(4)
    outfit = [int(i) for i in rng.choice(port.catalog.item_ids, 4, replace=False)]
    assert abs(port.cp_score(outfit) - jax_eng.cp_score(outfit)) <= 1e-3
    got = port.cir_top10(outfit, outfit[0])
    want = jax_eng.cir_top10(outfit, outfit[0])
    assert len(set(x["item_id"] for x in got) & set(x["item_id"] for x in want)) >= 7


def test_build_engine_shard_catalog(tiny_cfg):
    eng = build_engine(
        synthetic=True, model_cfg=port_config(tiny_cfg), shard_catalog=True, device="cpu"
    )
    assert isinstance(eng.catalog_dev, ShardedRows) and len(eng.catalog_dev.shards) == 1
    assert eng.mesh.shape == {"data": 1, "model": 1}
    ids = [int(i) for i in eng.catalog.item_ids[:3]]
    assert 0.0 <= eng.cp_score(ids) <= 1.0
    assert len(eng.similar_items(ids[0], k=4)) == 4
