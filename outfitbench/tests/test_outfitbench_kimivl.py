"""The kimivl_a3b configuration's harness on the CPU at a tiny size
(Kimi-VL's widths cut, which only the tests do): the configuration against
the catalog's numbers, the driver's first steps against the reference, its
comparison with a sound and a broken step, the arithmetic of
``flops_kimivl.py`` against hand arithmetic at the published widths, and
the readers of the seven ``.kimivl`` metrics on synthetic records."""

from __future__ import annotations

import copy
import json
import time
import types

import pytest

from outfitbench import flops, flops_dsv2, flops_kimivl, registry
from outfitbench.drivers import train, train_ocp_dsv2 as dsv2, train_ocp_kimivl as kimivl
from outfitbench.drivers.common import Context
from outfitbench.tests.conftest import ROOT, workload
from outfitbench.tests.test_outfitbench_dsv2 import TINY_LIMITS, _half_batch

CELL = "kimivl.train_ocp"
# moonshotai/Kimi-VL-A3B-Instruct's text_config, as the catalog gives it.
PUBLISHED = {
    "vocab_size": 163840, "max_position_embeddings": 131072, "hidden_size": 2048,
    "intermediate_size": 11264, "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "n_shared_experts": 2, "n_routed_experts": 64, "ep_size": 1,
    "routed_scaling_factor": 2.446, "kv_lora_rank": 512, "q_lora_rank": None,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
    "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1, "num_experts_per_tok": 6,
    "moe_layer_freq": 1, "first_k_dense_replace": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "seq_aux": True, "num_key_value_heads": 16, "hidden_act": "silu",
    "rms_norm_eps": 1e-05, "rope_theta": 800000, "rope_scaling": None, "attention_bias": False,
    "tie_word_embeddings": False,
}


def config() -> dict:
    return json.loads((ROOT / "outfitbench/configs/outfitx-kimivl-a3b.json").read_text())


def tiny() -> dict:
    cfg = config()
    cfg.update(hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, kv_lora_rank=32, intermediate_size=96, moe_intermediate_size=24,
               n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
               num_hidden_layers=3, vocab_size=512, image_size=56, raw_items=64, text_len=8,
               compute_dtype="float32", tower_dtype="float32")
    cfg["vision_config"] = dict(cfg["vision_config"], hidden_size=32, num_attention_heads=4,
                                num_hidden_layers=2, intermediate_size=48, init_pos_emb_height=8,
                                init_pos_emb_width=8)
    return cfg


def ctx(tmp_path, monkeypatch, faults=None, seed=2**31 + 707) -> Context:
    monkeypatch.chdir(tmp_path)
    params = workload(CELL, batch=2, accumulation=2, outfits=24,
                      limits=dict(TINY_LIMITS, token_gap=1e-5))
    return Context(cell={"name": CELL, "chips": 1}, config=tiny(), params=params, seed=seed,
                   seconds=0.5, trace=False, started=time.perf_counter(), device="cpu",
                   faults=faults or {})


def test_the_configuration_holds_the_catalog_numbers():
    cfg = config()
    for key, value in PUBLISHED.items():
        assert cfg[key] == value, key
    bench = registry.load()
    entry = next(c for c in bench["configs"] if c["name"] == "outfitx-kimivl-a3b")
    assert entry["reduced"] == ["raw_items"] == list(cfg["reduced"])
    assert cfg["source"] == entry["source"]
    vision, decoder = kimivl.tower_configs(cfg)
    assert (vision.d_model, vision.n_heads, vision.d_mlp, vision.n_layers, vision.n_tokens) == (
        1152, 16, 4304, 27, 64)
    assert (decoder.scoring, decoder.rope_factor, decoder.routed_scaling, decoder.d_ffn) == (
        "sigmoid", 1.0, 2.446, 11264)


def test_the_cell_reports_its_metrics():
    bench = registry.load()
    assert {m["name"] for m in registry.end_to_end(bench, CELL)} == {"ocp_outfits_per_s",
                                                                     "setup_s"}
    names = {m["name"] for m in registry.per_layer(bench, CELL)}
    assert names == {"step_mfu.kimivl", "vit_ms.kimivl", "project_ms.kimivl",
                     "vit_attn_roofline.kimivl", "attn_roofline.kimivl",
                     "expert_roofline.kimivl", "expert_load_max.kimivl",
                     # the generic readers of the layers it shares with the other
                     # original-CP cells
                     "elementwise_share.ocp", "device_idle_share.ocp", "host_gather_ms.ocp",
                     "gather_idle_ms.ocp", "enqueue_ms.ocp", "towers_ms.ocp", "moe_ms.dsv2",
                     "mla_ms.dsv2", "route_ms.dsv2"}
    for name in names:
        assert callable(registry.reader(name))
    assert registry.workload(CELL)["driver"] == "train_ocp_kimivl"


def test_first_steps_follow_the_reference_in_float32(tmp_path, monkeypatch):
    """In float32 the program's first steps (MoonViT, the projector, the
    decoder, heads, set transformer, update) and the reference's agree to
    round-off, and every token routes alike."""
    c = ctx(tmp_path, monkeypatch)
    routes = kimivl.Readout()
    job = kimivl.ocp_job(c, routes)
    got = train.first_steps(job.step, job.batches, job.optimizer, job.names, 2,
                            c.config["optimizer"]["b1"])
    job.close()
    assert len(routes.program) == 2 * 2 * 2  # steps x microbatches x mixtures
    assert routes.program[0].shape == (2 * 16 * (4 + 8), 2)
    want = kimivl.reference_readings(c, job.names, routes=routes)
    gaps = train.gaps(got, want)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4, gaps
    assert routes.mismatch() == 0.0
    assert len(routes.tokens) == 2 * 2 and routes.tokens[0].shape == (2 * 16, 4, 64)
    assert routes.token_gap() < 1e-5
    assert {"encoder.vision.fc.weight", "encoder.text.proj.weight"} <= set(job.names)


def test_a_sound_run_is_correct_and_a_broken_step_is_not(tmp_path, monkeypatch):
    out = kimivl.run(ctx(tmp_path, monkeypatch))
    assert out.correct, [(c.name, c.value) for c in out.checks]
    assert [c.name for c in out.checks][-2:] == ["route_mismatch", "token_gap"]
    assert out.metrics["ocp_outfits_per_s"] > 0 and out.attempted >= 1
    bad = kimivl.run(ctx(tmp_path, monkeypatch, faults={"step": _half_batch}))
    assert not bad.correct


def test_the_control_routes_unlike_the_reference(tmp_path, monkeypatch):
    c = ctx(tmp_path, monkeypatch)
    names = ["model.outfit_token"]
    want, low = kimivl.Readout(), kimivl.Readout()
    kimivl.reference_readings(c, names, routes=want)
    kimivl.reference_readings(c, names, low=True, routes=low)
    same = dsv2.Routes()
    same.program, same.reference, same.real = want.reference, want.reference, want.real
    other = copy.copy(same)
    other.program = low.reference
    assert same.mismatch() == 0.0 and other.mismatch() > 0.01
    real = want.real_items
    assert real.any() and not real.all()  # pad slots hold no real item
    assert kimivl.token_gap([want.reference_tokens], want.reference_tokens, real) == 0.0
    assert kimivl.token_gap([low.reference_tokens], want.reference_tokens, real) > 0.01


def test_flops_by_hand():
    """At the published widths a microbatch of 512 items: MoonViT 112
    TFLOP, the projector 2, the decoder 184 at 80 tokens an item."""
    cfg = config()
    vit = 256 * (2 * 588 * 1152 + 27 * (2 * (4 * 1152 ** 2 + 2 * 1152 * 4304) + 4 * 256 * 1152))
    assert flops_kimivl.vit_image_flops(cfg) == vit
    assert 512 * vit == pytest.approx(112e12, rel=0.01)
    project = 64 * 2 * (4608 * 4608 + 4608 * 2048)
    assert flops_kimivl.project_image_flops(cfg) == project
    per_token = flops_dsv2.tower_token_flops(cfg, 80)
    attn = 2 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048) + 2 * 16 * 80 * 320
    assert per_token == 27 * attn + 2 * 3 * 2048 * 11264 + 26 * 2 * (2048 * 64
                                                                    + 3 * 2048 * 1408 * 8)
    assert 512 * 80 * per_token == pytest.approx(184e12, rel=0.01)
    step = 2 * (512 * (vit + project + 80 * per_token) + 6 * 512 * 4096 * 64
                + 3 * flops.set_transformer_forward_flops(cfg, 32))
    assert flops_kimivl.ocp_step_flops(cfg, 32, 2) == pytest.approx(step, rel=1e-12)
    assert flops_dsv2.expert_bound(cfg, 40960, "bfloat16") == pytest.approx(
        2 * 245760 * 3 * 2048 * 1408 / 989e12)
    launches = flops_kimivl.attention_launches(cfg, 32, 2)
    assert launches[2:] == [((512, 16, 256, 72), False, 54), ((512, 16, 80, 192, 128), False, 54)]


def _rec(kernels):
    cfg = config()
    derived = {"profiled_steps": 2, "compute_dtype": "bfloat16",
               "attention_launches": flops_kimivl.attention_launches(cfg, 32, 2)}
    return types.SimpleNamespace(config=cfg, params={"accumulation": 2}, derived=derived,
                                 trace={"kernels": kernels}, spans=None)


def test_the_rooflines_read_their_own_kernels():
    vit = flops.attention_bound((512, 16, 256, 72), "bfloat16")
    nbytes = 4 * 512 * 16 * 256 * 72 * 2 + 512 * 256
    assert vit == pytest.approx(nbytes / 3.35e12)  # bytes bound it
    split = flops_dsv2.split_attention_bound((512, 16, 80, 192, 128), "bfloat16")
    kernels = {"void masked_mha_fwd_long_tile_kernel<2, 256>(...)": [0.2, 108],
               "void masked_mha_fwd_split_kernel<__nv_bfloat16>(...)": [0.5, 108],
               "void masked_mha_fwd_narrow_kernel<17>(...)": [0.01, 24]}
    rec = _rec(kernels)
    assert flops_kimivl.roofline(rec, flops_kimivl.VIT_KERNEL, 4) == pytest.approx(
        100 * vit * 108 / 0.2)
    assert flops_kimivl.roofline(rec, flops_kimivl.SPLIT_KERNEL, 5) == pytest.approx(
        100 * split * 108 / 0.5)
    kernels["void masked_mha_fwd_split_kernel<__nv_bfloat16>(...)"] = [0.5, 107]
    assert flops_kimivl.roofline(_rec(kernels), flops_kimivl.SPLIT_KERNEL, 5) is None
    assert flops_kimivl.roofline(_rec({}), flops_kimivl.VIT_KERNEL, 4) is None
    for name in ("vit_attn_roofline.kimivl", "attn_roofline.kimivl"):
        assert registry.reader(name)(_rec({})) is None
        assert registry.reader(name)(None) is None
