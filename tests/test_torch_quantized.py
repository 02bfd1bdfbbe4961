"""The PyTorch port's int8 (W8A8) serving forward against the JAX package's
``outfitx_tpu/models/quantized.py``.

- The int8 tables (``quantize_weight``, ``quantize_outfitx_params``) are
  bit-equal to JAX's, after the (in, out) -> (out, in) transpose.
- ``q8_dot`` is bit-equal to JAX's eager ``q8_dot``. Under ``jax.jit`` on
  the CPU, XLA keeps the division ``xf / sx`` (the compiled HLO holds one
  divide), so the int8 activations are equal; the jitted result differs
  only in the dequantize's rounding (XLA fuses ``acc * sx * scales`` into
  one expression): within 4 float32 ulps.
- The forwards run on the same int8 tables in float32 on both sides. A
  last-bit difference before a ``q8_dot`` (a LayerNorm's or an attention
  output's) can move one int8 activation by one step, so they are held to
  the size of one such step at the CIR head (``flip_size``: 2e-3 to 5e-3
  here). On these inputs no step flips: they agree to 5e-7.
- The JAX package's own accuracy bars (``tests/test_quantized_model.py``)
  are held against the port's own float32 model, and its engine bars
  against the port's engine.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu.models.quantized import QuantizedOutfitX as JaxQuantized
from outfitx_tpu.models.quantized import q8_dot as jax_q8_dot
from outfitx_tpu.models.quantized import quantize_outfitx_params as jax_quantize_params
from outfitx_tpu.models.quantized import quantize_weight as jax_quantize_weight
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models import state_dict_from_jax
from outfitx_tpu_torch.models.from_jax import quantized_state_dict_from_jax
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.models.quantized import (
    INT_MM_MIN_ROWS,
    QuantizedOutfitX,
    q8_dot,
    quantize_outfitx_params,
    quantize_weight,
    quantized_twin,
)
from outfitx_tpu_torch.ops.retrieval import retrieve
from outfitx_tpu_torch.serve import engine as engine_mod
from outfitx_tpu_torch.serve.app import build_engine
from outfitx_tpu_torch.serve.engine import ServingEngine

torch.set_num_threads(1)

# The JAX package's quantized-model test config: d=32, 4 heads, d_ffn 64
# padded to 2048, 2 layers, float32.
JAX_TEST_CFG = dict(dim_per_modality=16, n_heads=4, d_ffn=64, n_layers=2, max_len=8)
ULP4 = 4 * np.finfo(np.float32).eps


def configs(final_norm=False):
    """(JAX config, port config) of the JAX package's quantized test."""
    from outfitx_tpu.core.config import ItemEncoderConfig, OutfitXConfig, TransformerConfig

    kw = JAX_TEST_CFG
    tkw = dict(n_heads=kw["n_heads"], d_ffn=kw["d_ffn"], n_layers=kw["n_layers"],
               dropout=0.0, final_norm=final_norm)
    jcfg = OutfitXConfig(
        item_encoder=ItemEncoderConfig(dim_per_modality=kw["dim_per_modality"]),
        transformer=TransformerConfig(**tkw), max_outfit_len=kw["max_len"],
        compute_dtype="float32",
    )
    pcfg = tcfg.OutfitXConfig(
        item_encoder=tcfg.ItemEncoderConfig(dim_per_modality=kw["dim_per_modality"]),
        transformer=tcfg.TransformerConfig(**tkw), max_outfit_len=kw["max_len"],
        compute_dtype="float32",
    )
    return jcfg, pcfg


@pytest.fixture(scope="module", params=[False, True], ids=["pre_ln", "final_norm"])
def pair(request):
    """JAX params, their int8 tree, the port's f32 model and the port's int8
    twin made by the port's own quantizer from the same weights."""
    jcfg, pcfg = configs(final_norm=request.param)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    if request.param:  # a LayerNorm that is not the identity
        rng = np.random.default_rng(9)
        params["final_ln"] = {
            "scale": jnp.asarray(1 + 0.1 * rng.standard_normal(32), jnp.float32),
            "bias": jnp.asarray(0.1 * rng.standard_normal(32), jnp.float32),
        }
    qparams = jax_quantize_params(params, jcfg)
    model = OutfitXModel(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, pcfg, params, qparams, model, quantized_twin(model)


def batch(cfg, b=16, seed=1):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(b, cfg.max_outfit_len, cfg.d_embed)).astype(np.float32)
    lengths = rng.integers(2, cfg.max_outfit_len + 1, size=b)
    mask = np.arange(cfg.max_outfit_len)[None, :] >= lengths[:, None]
    emb[mask] = 0.0
    text = rng.normal(size=(b, cfg.d_embed // 2)).astype(np.float32)
    return emb, mask, text


def flip_size(qmodel, emb, mask):
    """The size of one int8 activation step at the CIR head: a token
    state's step, max|x| / 127, times the largest int8 weight's value,
    127 x the largest channel scale."""
    with torch.no_grad():
        states = qmodel._with_prefix(
            qmodel.target_item_image_emb.new_zeros(emb.shape[0], 1, emb.shape[2]),
            torch.from_numpy(emb), torch.from_numpy(mask),
        )
    head = qmodel.cir_ffn[0]
    return float(states[:, 0].abs().max()) * float(head.scales.max())


# ------------------------------------------------------------- tables --
def test_quantize_weight_is_bit_equal_to_jax_with_zero_channels():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((48, 24)).astype(np.float32) * rng.uniform(0.01, 5, 24)
    w[:, 3] = 0.0  # a zero output channel (as the FFN pad)
    w[:, 7] = np.float32(1e-30)  # a tiny one
    w[5, 9] = 0.5 * np.max(np.abs(w[:, 9]))  # not a tie-breaking case itself
    want = jax_quantize_weight(jnp.asarray(w), axis=0)
    values, scales = quantize_weight(torch.from_numpy(w.T.copy()), dim=1)
    assert values.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(values.numpy(), np.asarray(want.values).T)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want.scales))
    assert scales[3] == 1.0 and not values[3].any()
    # Halves round to even, as jnp.round: 2.5 -> 2, -3.5 -> -4, 127 kept.
    half = torch.tensor([[127.0, 2.5, -3.5, 0.5, 1.5]])
    np.testing.assert_array_equal(quantize_weight(half, dim=1)[0].numpy(), [[127, 2, -4, 0, 2]])


def test_quantize_outfitx_params_is_bit_equal_to_jax(pair):
    jcfg, pcfg, params, qparams, model, _ = pair
    got = quantize_outfitx_params(model.state_dict(), pcfg)
    want = quantized_state_dict_from_jax(jax.tree.map(np.asarray, qparams))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    # The FFN is padded to ffn_pad_to before quantization: zero channels
    # with scale 1.
    pad_to = pcfg.transformer.ffn_pad_to
    w1 = got["transformer_encoder.layers.0.linear1.values"]
    assert w1.shape == (pad_to, 32) and not w1[64:].any()
    assert bool((got["transformer_encoder.layers.0.linear1.scales"][64:] == 1).all())
    assert got["transformer_encoder.layers.1.linear2.values"].shape == (32, pad_to)
    # The JAX wqkv's channel order is the rows [Wq; Wk; Wv] of in_proj.
    assert np.asarray(qparams["layers"]["attn"]["wqkv"].values).shape == (2, 32, 96)
    # LayerNorms, biases, tokens and the CP head stay float32.
    for k in ("outfit_token", "cp_ffn.1.weight", "transformer_encoder.layers.0.norm1.weight",
              "transformer_encoder.layers.0.self_attn.in_proj.bias"):
        assert got[k].dtype == torch.float32


# -------------------------------------------------------------- q8_dot --
def test_q8_dot_equals_jax_eager_and_jit_up_to_the_dequantize_rounding():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    jw = jax_quantize_weight(jnp.asarray(w), axis=0)
    values, scales = quantize_weight(torch.from_numpy(w.T.copy()), dim=1)
    for trial in range(4):
        x = (rng.standard_normal((64, 96)) * 10.0 ** (trial - 1)).astype(np.float32)
        x[3] = 0.0  # an all-zero token: scale 1, exact zeros
        got = q8_dot(torch.from_numpy(x), values, scales).numpy()
        eager = np.asarray(jax_q8_dot(jnp.asarray(x), jw))
        np.testing.assert_array_equal(got, eager)
        jitted = np.asarray(jax.jit(jax_q8_dot)(jnp.asarray(x), jw))
        np.testing.assert_allclose(got, jitted, rtol=ULP4, atol=0)
        assert not got[3].any()


def test_q8_dot_pad_path_equals_the_unpadded_product():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((24, 32)).astype(np.float32))
    values, scales = quantize_weight(w, dim=1)
    x = torch.from_numpy(rng.standard_normal((40, 32)).astype(np.float32))
    full = q8_dot(x, values, scales)  # 40 rows: no pad
    for m in (1, 5, INT_MM_MIN_ROWS - 1):
        np.testing.assert_array_equal(q8_dot(x[:m], values, scales).numpy(), full[:m].numpy())
    # Leading dims are kept: (B, S, d) in, (B, S, d_out) out.
    np.testing.assert_array_equal(
        q8_dot(x[:6].view(2, 3, 32), values, scales).numpy(), full[:6].view(2, 3, 24).numpy()
    )


# ------------------------------------------------------------ forwards --
def test_forwards_match_jax_on_the_same_tables(pair):
    jcfg, pcfg, _, qparams, _, _ = pair
    qmodel = QuantizedOutfitX(pcfg, device="cpu")
    qmodel.load_state_dict(quantized_state_dict_from_jax(jax.tree.map(np.asarray, qparams)))
    jq = JaxQuantized(jcfg)
    emb, mask, text = batch(pcfg, b=16, seed=4)
    want_cp = np.asarray(jq.cp_forward(qparams, jnp.asarray(emb), jnp.asarray(mask)))
    want_cir = np.asarray(jq.cir_forward(qparams, *(jnp.asarray(a) for a in (emb, mask, text))))
    want_fitb = np.asarray(jq.fitb_forward(qparams, *(jnp.asarray(a) for a in (emb, mask, text))))
    with torch.no_grad():
        got_cp = qmodel.cp_forward(torch.from_numpy(emb), torch.from_numpy(mask))
        args = (torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(text))
        got_cir = qmodel.cir_forward(*args)
        got_fitb = qmodel.fitb_forward(*args)
    assert got_cp.dtype == got_cir.dtype == torch.float32
    assert tuple(got_cp.shape) == (16,) and tuple(got_cir.shape) == (16, 32)
    tol = flip_size(qmodel, emb, mask)
    assert 0 < tol < 0.01
    np.testing.assert_allclose(got_cp.numpy(), want_cp, rtol=0, atol=tol)
    np.testing.assert_allclose(got_cir.numpy(), want_cir, rtol=0, atol=tol)
    np.testing.assert_array_equal(got_fitb.numpy(), got_cir.numpy())
    np.testing.assert_allclose(want_fitb, want_cir, rtol=0, atol=0)


def test_twin_meets_the_jax_packages_own_accuracy_bars(pair):
    """tests/test_quantized_model.py's bars, the port's int8 twin against
    the port's float32 model."""
    _, pcfg, _, _, model, qmodel = pair
    emb, mask, _ = batch(pcfg, b=32, seed=1)
    with torch.no_grad():
        ref = model.cp_forward(torch.from_numpy(emb), torch.from_numpy(mask)).numpy()
        out = qmodel.cp_forward(torch.from_numpy(emb), torch.from_numpy(mask)).numpy()
    assert np.corrcoef(ref, out)[0, 1] > 0.995
    assert np.max(np.abs(ref - out)) < 0.15 * (np.std(ref) + 1e-6)

    emb, mask, text = batch(pcfg, b=16, seed=3)
    args = (torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(text))
    with torch.no_grad():
        ref, out = model.cir_forward(*args).numpy(), qmodel.cir_forward(*args).numpy()
    cos = (ref * out).sum(-1) / (np.linalg.norm(ref, axis=-1) * np.linalg.norm(out, axis=-1))
    assert float(cos.min()) > 0.999

    emb, mask, text = batch(pcfg, b=8, seed=5)
    pool = torch.from_numpy(np.random.default_rng(7).normal(size=(500, 32)).astype(np.float32))
    args = (torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(text))
    with torch.no_grad():
        _, i_ref = retrieve(model.cir_forward(*args), pool, 10, approx=False)
        _, i_q8 = retrieve(qmodel.cir_forward(*args), pool, 10, approx=False)
    overlaps = [len(set(a.tolist()) & set(b.tolist())) for a, b in zip(i_ref, i_q8)]
    assert np.mean(overlaps) >= 8.0, overlaps


def test_twin_is_eval_only_and_holds_buffers(pair):
    _, pcfg, _, _, model, qmodel = pair
    assert not any(p.requires_grad for p in qmodel.parameters())
    names = dict(qmodel.named_buffers())
    assert names["transformer_encoder.layers.0.self_attn.in_proj.values"].dtype == torch.int8
    assert names["cir_ffn.0.values"].dtype == torch.int8 and "cir_ffn.0.bias" not in names
    assert qmodel.device == model.device and not qmodel.training
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QuantizedOutfitX(pcfg)


# -------------------------------------------------------------- engine --
DATA = dict(n_items=300, d_embed=32, n_outfits=64, seed=5, max_len=8)


@pytest.fixture(scope="module")
def engines():
    """The f32 engine and the int8 engine on one synthetic catalog, the
    same weights (the JAX engine test's setup)."""
    _, pcfg = configs()
    data = make_synthetic(**DATA)
    sd = OutfitXModel(pcfg, device="cpu", seed=0).state_dict()

    def make(**kw):
        return ServingEngine(
            model_cfg=pcfg, catalog=data.catalog, cp_params=sd, cir_params=sd,
            device="cpu", warmup=False, **kw,
        )

    return make(), make(quantize_model=True)


def test_engine_cp_close_batch_equals_singles(engines):
    f32, q8 = engines
    assert isinstance(q8.cp_model, QuantizedOutfitX)
    outfit = f32.sample_outfit(4)
    assert abs(f32.cp_score(outfit) - q8.cp_score(outfit)) < 0.05
    outfits = [q8.sample_outfit(n) for n in (2, 4, 3)]
    np.testing.assert_allclose(
        q8.cp_score_batch(outfits), [q8.cp_score(o) for o in outfits], rtol=0, atol=1e-5
    )


def test_engine_cir_fitb_and_similar(engines):
    f32, q8 = engines
    overlaps = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        outfit = [int(i) for i in rng.choice(f32.catalog.item_ids, 4, replace=False)]
        target = int(rng.choice(f32.catalog.item_ids))
        top_f32 = [r["item_id"] for r in f32.cir_top10(outfit, target)]
        top_q8 = [r["item_id"] for r in q8.cir_top10(outfit, target)]
        assert len(top_q8) == 10
        overlaps.append(len(set(top_f32) & set(top_q8)))
    assert min(overlaps) >= 7, overlaps
    outfit = f32.sample_outfit(4)
    assert 0 <= q8.fitb_pick(outfit, f32.sample_outfit(4)) < 4
    item = int(f32.catalog.item_ids[0])
    assert [r["item_id"] for r in q8.similar_items(item)] == [
        r["item_id"] for r in f32.similar_items(item)
    ]


def test_shared_params_are_quantized_once(monkeypatch):
    _, pcfg = configs()
    calls = []
    real = engine_mod.quantize_outfitx_params
    monkeypatch.setattr(
        engine_mod, "quantize_outfitx_params", lambda *a: calls.append(1) or real(*a)
    )
    data = make_synthetic(**dict(DATA, n_items=100, n_outfits=16))
    sd = OutfitXModel(pcfg, device="cpu", seed=0).state_dict()
    eng = ServingEngine(model_cfg=pcfg, catalog=data.catalog, cp_params=sd,
                        cir_params=sd, device="cpu", quantize_model=True)
    assert len(calls) == 1
    assert eng.cir_params is eng.cp_params and eng.cir_model is eng.cp_model
    other = OutfitXModel(pcfg, device="cpu", seed=1).state_dict()
    ServingEngine(model_cfg=pcfg, catalog=data.catalog, cp_params=sd,
                  cir_params=other, device="cpu", warmup=False, quantize_model=True)
    assert len(calls) == 3


def test_build_engine_quantize_model_and_what_still_raises():
    _, pcfg = configs()
    cfg = dataclasses.replace(pcfg, item_encoder=tcfg.ItemEncoderConfig(dim_per_modality=32))
    eng = build_engine(synthetic=True, model_cfg=cfg, device="cpu", quantize_model=True)
    assert isinstance(eng.cp_model, QuantizedOutfitX) and eng.cir_model is eng.cp_model
    ids = eng.sample_outfit(3)
    assert 0.0 <= eng.cp_score(ids) <= 1.0
    assert len(eng.cir_top10(ids[:2], ids[2])) == 10
    with pytest.raises(ValueError, match="block"):
        build_engine(synthetic=True, model_cfg=cfg, device="cpu", quantize_model=True,
                     attn="block")
    # The int8 forward composes with the row-sharded catalog, as in JAX.
    sharded = build_engine(synthetic=True, model_cfg=cfg, device="cpu", quantize_model=True,
                           shard_catalog=True)
    assert sharded.mesh is not None
    assert sharded.cp_score(ids) == eng.cp_score(ids)
    assert sharded.cir_top10(ids[:2], ids[2]) == eng.cir_top10(ids[:2], ids[2])
    from outfitx_tpu_torch.core.mesh import MeshSpec, make_mesh

    data = make_synthetic(**DATA)
    sd = OutfitXModel(pcfg, device="cpu").state_dict()
    common = dict(model_cfg=pcfg, cp_params=sd, cir_params=sd, device="cpu",
                  quantize_model=True, warmup=False)
    meshed = ServingEngine(catalog=make_synthetic(**DATA).catalog, **common,
                           mesh=make_mesh(MeshSpec(data=4), devices=["cpu"] * 4))
    single = ServingEngine(catalog=data.catalog, **common)
    outfit = [int(i) for i in data.catalog.item_ids[:3]]
    assert meshed.cp_score(outfit) == single.cp_score(outfit)
    assert meshed.similar_items(outfit[0]) == single.similar_items(outfit[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine(synthetic=True, model_cfg=cfg, quantize_model=True)
