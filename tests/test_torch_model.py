"""The PyTorch port's OutfitXModel against the JAX model, through the
weight bridge, at the tiny test scale in float32 (1e-4)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu.train.checkpoint import CheckpointManager
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.models import (
    OutfitXModel,
    load_jax_checkpoint,
    state_dict_from_jax,
)

torch.set_num_threads(1)

TOL = 1e-4


def port_config(cfg):
    """The port's config with the JAX config's values."""

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


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(cfg, b=5, seed=0):
    rng = np.random.default_rng(seed)
    l, d = cfg.max_outfit_len, cfg.d_embed
    emb = rng.standard_normal((b, l, d)).astype(np.float32)
    lengths = rng.integers(1, l + 1, b)
    mask = np.arange(l)[None, :] >= lengths[:, None]
    text = rng.standard_normal((b, d // 2)).astype(np.float32)
    return emb, mask, text


def _pair(jcfg):
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = OutfitXModel(port_config(jcfg), device="cpu")
    model.load_state_dict(state_dict_from_jax(_host(params)), strict=True)
    return jmodel, params, model


VARIANTS = {
    "default": {},
    "ffn_unpadded": {"ffn_pad_to": 0},
    "post_ln": {"norm_first": False},
    "final_norm": {"final_norm": True},
    "gelu": {"activation": "gelu"},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forwards_match_jax(tiny_cfg, variant):
    jcfg = dataclasses.replace(
        tiny_cfg,
        transformer=dataclasses.replace(tiny_cfg.transformer, **VARIANTS[variant]),
    )
    jmodel, params, model = _pair(jcfg)
    emb, mask, text = _inputs(jcfg)
    want_cp = jax.jit(jmodel.cp_forward)(params, jnp.asarray(emb), jnp.asarray(mask))
    want_cir = jax.jit(jmodel.cir_forward)(
        params, jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(text)
    )
    te, tm, tt = torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(text)
    got_cp = model.cp_forward(te, tm)
    got_cir = model.cir_forward(te, tm, tt)
    assert got_cp.dtype == got_cir.dtype == torch.float32
    np.testing.assert_allclose(got_cp.numpy(), np.asarray(want_cp), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_cir.numpy(), np.asarray(want_cir), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        model.fitb_forward(te, tm, tt).numpy(), got_cir.numpy(), rtol=0, atol=0
    )


def test_padded_items_do_not_move_outputs(tiny_cfg):
    _, _, model = _pair(tiny_cfg)
    emb, mask, text = _inputs(tiny_cfg, seed=1)
    noisy = emb.copy()
    noisy[mask] = 1e3 * np.random.default_rng(2).standard_normal(noisy[mask].shape)
    tm, tt = torch.from_numpy(mask), torch.from_numpy(text)
    for a, b in (
        (model.cp_forward(torch.from_numpy(emb), tm),
         model.cp_forward(torch.from_numpy(noisy), tm)),
        (model.cir_forward(torch.from_numpy(emb), tm, tt),
         model.cir_forward(torch.from_numpy(noisy), tm, tt)),
    ):
        assert torch.equal(a, b)


def test_state_dict_names_match_the_reference_layout(tiny_cfg):
    from outfitx_tpu.models.export_torch import reference_state_dict

    params = JaxModel(tiny_cfg).init(jax.random.PRNGKey(1))
    ours = state_dict_from_jax(_host(params))
    ref = reference_state_dict(params)
    assert sorted(ours) == sorted(ref)
    for name, t in ref.items():
        assert torch.equal(ours[name], t), name


def test_model_has_no_gradients_and_defaults_to_cuda(tiny_cfg):
    model = OutfitXModel(port_config(tiny_cfg), device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OutfitXModel(port_config(tiny_cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip(tiny_cfg, tmp_path, dtype):
    params = JaxModel(tiny_cfg).init(jax.random.PRNGKey(3))
    params = jax.tree.map(lambda x: x.astype(dtype), params)
    CheckpointManager(tmp_path, "m").save("best_auc", params=params)
    got = load_jax_checkpoint(tmp_path / "m" / "best_auc")
    want = state_dict_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), params))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], want[name]), name
    model = OutfitXModel(port_config(tiny_cfg), device="cpu")
    model.load_state_dict(got, strict=True)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_jax_checkpoint(tmp_path)
