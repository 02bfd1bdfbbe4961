"""The set transformer's fused attention-block route (``attn="block"``)
against the JAX package's ``OUTFITX_ATTN_BLOCK=fused`` forward, at the tiny
test scale in float32 (1e-4), and the route's rules: eval only, weights
re-laid out once and refreshed after an in-place change, passed through by
the serving engine."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from outfitx_tpu.ops import attn_block as jax_ab
from outfitx_tpu_torch.models import OutfitXModel, state_dict_from_jax
from outfitx_tpu_torch.models import outfit_transformer as ot
from outfitx_tpu_torch.serve.app import build_engine
from test_torch_model import _host, _inputs, _pair, port_config

torch.set_num_threads(1)

TOL = 1e-4


def _jax_fused(monkeypatch, fn):
    """fn() with the JAX package's fused attention block switched on."""
    monkeypatch.setenv("OUTFITX_ATTN_BLOCK", "fused")
    jax_ab.fused_attn_block_enabled.cache_clear()
    try:
        return fn()
    finally:
        monkeypatch.delenv("OUTFITX_ATTN_BLOCK")
        jax_ab.fused_attn_block_enabled.cache_clear()


def _block_model(jcfg, params):
    model = OutfitXModel(port_config(jcfg), device="cpu", attn="block")
    model.load_state_dict(state_dict_from_jax(_host(params)), strict=True)
    return model


@pytest.mark.parametrize("variant", [{}, {"norm_first": False}, {"final_norm": True}])
def test_block_route_matches_jax_fused(tiny_cfg, monkeypatch, variant):
    jcfg = dataclasses.replace(
        tiny_cfg, transformer=dataclasses.replace(tiny_cfg.transformer, **variant)
    )
    jmodel, params, _ = _pair(jcfg)
    model = _block_model(jcfg, params)
    emb, mask, text = _inputs(jcfg)
    want_cp, want_cir = _jax_fused(monkeypatch, lambda: (
        np.asarray(jmodel.cp_forward(params, emb, mask)),
        np.asarray(jmodel.cir_forward(params, emb, mask, text)),
    ))
    with torch.no_grad():
        t_emb, t_mask = torch.from_numpy(emb), torch.from_numpy(mask)
        got_cp = model.cp_forward(t_emb, t_mask)
        got_cir = model.cir_forward(t_emb, t_mask, torch.from_numpy(text))
    np.testing.assert_allclose(got_cp.numpy(), want_cp, rtol=0, atol=TOL)
    np.testing.assert_allclose(got_cir.numpy(), want_cir, rtol=0, atol=TOL)


def test_block_route_equals_mha_route(tiny_cfg):
    jmodel, params, mha = _pair(tiny_cfg)
    block = _block_model(tiny_cfg, params)
    emb, mask, _ = (torch.from_numpy(a) for a in _inputs(tiny_cfg, b=7, seed=3))
    with torch.no_grad():
        np.testing.assert_allclose(
            block.cp_forward(emb, mask).numpy(), mha.cp_forward(emb, mask).numpy(),
            rtol=0, atol=1e-5,
        )


def test_block_route_is_eval_only(tiny_cfg, monkeypatch):
    """In train mode every layer takes the products around masked_mha (the
    block has no backward); in eval mode every layer takes the block."""
    _, params, _ = _pair(tiny_cfg)
    model = _block_model(tiny_cfg, params)
    calls = []
    real = ot.attn_block

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(ot, "attn_block", spy)
    emb, mask, _ = (torch.from_numpy(a) for a in _inputs(tiny_cfg))
    model.train()
    model.cp_forward(emb, mask, generator=torch.Generator().manual_seed(0))
    assert calls == []
    model.eval()
    with torch.no_grad():
        model.cp_forward(emb, mask)
    assert len(calls) == tiny_cfg.transformer.n_layers


def test_block_weights_follow_in_place_updates(tiny_cfg):
    """The (d, 3, d) re-layout is cached, and made again when a parameter
    changes in place (as an optimizer step or a state dict load does)."""
    _, params, mha = _pair(tiny_cfg)
    block = _block_model(tiny_cfg, params)
    emb, mask, _ = (torch.from_numpy(a) for a in _inputs(tiny_cfg))
    with torch.no_grad():
        block.cp_forward(emb, mask)
        attn = block.transformer_encoder.layers[0].self_attn
        first = attn._block_weights(torch.float32)
        assert attn._block_weights(torch.float32)[0] is first[0]
        for m in (block, mha):
            a = m.transformer_encoder.layers[0].self_attn
            a.in_proj_weight.mul_(1.5)
            a.out_proj.weight.add_(0.01)
        assert attn._block_weights(torch.float32)[0] is not first[0]
        np.testing.assert_allclose(
            block.cp_forward(emb, mask).numpy(), mha.cp_forward(emb, mask).numpy(),
            rtol=0, atol=1e-5,
        )


def test_unknown_attn_route_raises():
    with pytest.raises(ValueError, match="attn"):
        OutfitXModel(device="cpu", attn="flash")


def test_engine_passes_the_route_through(tiny_cfg):
    cfg = port_config(tiny_cfg)
    plain = build_engine(synthetic=True, model_cfg=cfg, device="cpu")
    block = build_engine(synthetic=True, model_cfg=cfg, device="cpu", attn="block")
    assert all(
        lyr.attn == "block" for lyr in block.cp_model.transformer_encoder.layers
    )
    assert all(lyr.attn == "mha" for lyr in plain.cp_model.transformer_encoder.layers)
    outfits = [[int(i) for i in plain.catalog.item_ids[k:k + 4]] for k in range(0, 40, 5)]
    np.testing.assert_allclose(
        block.cp_score_batch(outfits), plain.cp_score_batch(outfits), rtol=0, atol=1e-5
    )
