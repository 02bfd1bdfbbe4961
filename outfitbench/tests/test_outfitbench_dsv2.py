"""The resnet_dsv2lite configuration's harness on the CPU at a tiny size
(DeepSeek-V2's widths cut, which only the tests do): the driver's first
steps against the reference, its comparison with a sound and a broken
step, the arithmetic of ``flops_dsv2.py`` against hand arithmetic at the
published widths, and the readers of the seven ``.dsv2`` metrics on
synthetic records."""

from __future__ import annotations

import copy
import json
import math
import time
import types

import pytest

from outfitbench import flops, flops_dsv2, registry, tower_spans
from outfitbench.drivers import train, train_ocp_dsv2 as dsv2
from outfitbench.drivers.common import Context
from outfitbench.peaks import HBM_BYTES_PER_S, PEAK_FLOPS
from outfitbench.tests.conftest import ROOT, workload

CELL = "dsv2lite.train_ocp"
PUBLISHED = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu", "hidden_size": 2048,
    "intermediate_size": 10944, "kv_lora_rank": 512, "max_position_embeddings": 163840,
    "model_type": "deepseek_v2", "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
    "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6, "num_hidden_layers": 27,
    "num_key_value_heads": 16, "q_lora_rank": None, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06, "rope_theta": 10000,
    "routed_scaling_factor": 1, "scoring_func": "softmax", "seq_aux": True,
    "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy", "v_head_dim": 128,
    "vocab_size": 102400,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
}
# Over a dozen seeds at this size sound float32 runs read at most 2e-6 on
# every gap; the half-batch fault reads 0.1 and more on the loss against
# its own logits.
TINY_LIMITS = {"score_gap": 1e-3, "grad_gap_median": 1e-3, "change_gap": 1e-3,
               "loss_logit_gap": 1e-4, "route_mismatch": 0.0}


def config() -> dict:
    return json.loads((ROOT / "outfitbench/configs/outfitx-resnet-dsv2lite.json").read_text())


def tiny() -> dict:
    cfg = config()
    cfg.update(hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, kv_lora_rank=32, intermediate_size=96, moe_intermediate_size=24,
               n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
               num_hidden_layers=3, vocab_size=512, image_size=32, raw_items=64, text_len=8,
               compute_dtype="float32", tower_dtype="float32")
    return cfg


def ctx(tmp_path, monkeypatch, faults=None, seed=2**31 + 505) -> Context:
    monkeypatch.chdir(tmp_path)
    params = workload(CELL, batch=4, accumulation=2, outfits=48, limits=TINY_LIMITS)
    return Context(cell={"name": CELL, "chips": 1}, config=tiny(), params=params, seed=seed,
                   seconds=0.5, trace=False, started=time.perf_counter(), device="cpu",
                   faults=faults or {})


def test_the_configuration_holds_the_published_numbers():
    cfg = config()
    for key, value in PUBLISHED.items():
        assert cfg[key] == value, key
    bench = registry.load()
    entry = next(c for c in bench["configs"] if c["name"] == "outfitx-resnet-dsv2lite")
    assert entry["reduced"] == ["raw_items"] == list(cfg["reduced"])
    assert cfg["source"] == entry["source"]


def test_the_cell_reports_its_metrics():
    bench = registry.load()
    assert {m["name"] for m in registry.end_to_end(bench, CELL)} == {"ocp_outfits_per_s",
                                                                     "setup_s"}
    names = {m["name"] for m in registry.per_layer(bench, CELL)}
    assert names == {"step_mfu.dsv2", "attn_roofline.dsv2", "expert_roofline.dsv2",
                     "moe_ms.dsv2", "route_ms.dsv2", "mla_ms.dsv2", "expert_load_max.dsv2"}
    for name in names:
        assert callable(registry.reader(name))
    assert registry.workload(CELL)["driver"] == "train_ocp_dsv2"


def test_first_steps_follow_the_reference_in_float32(tmp_path, monkeypatch):
    """In float32 the program's first steps (towers, heads, set transformer,
    update) and the reference's agree to round-off, and every token routes
    alike."""
    c = ctx(tmp_path, monkeypatch)
    routes = dsv2.Routes()
    job = dsv2.ocp_job(c, routes)
    got = train.first_steps(job.step, job.batches, job.optimizer, job.names, 2,
                            c.config["optimizer"]["b1"])
    job.close()
    assert len(routes.program) == 2 * 2 * 2  # steps x microbatches x mixtures
    want = dsv2.reference_readings(c, job.names, routes=routes)
    gaps = train.gaps(got, want)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4, gaps
    assert routes.mismatch() == 0.0
    assert any(n == "encoder.text.proj.weight" for n in job.names)


def _half_batch(state, microbatches, **kw):
    from outfitx_tpu_torch.train import steps

    focal = steps._focal

    def half(scores, labels, par, **k):
        n = scores.shape[0] // 2
        return focal(scores[:n], labels[:n], par, **k)

    steps._focal = half
    try:
        return steps.original_cp_train_step(state, microbatches, **kw)
    finally:
        steps._focal = focal


def test_a_sound_run_is_correct_and_a_broken_step_is_not(tmp_path, monkeypatch):
    out = dsv2.run(ctx(tmp_path, monkeypatch))
    assert out.correct, [(c.name, c.value) for c in out.checks]
    assert [c.name for c in out.checks][-1] == "route_mismatch"
    assert out.metrics["ocp_outfits_per_s"] > 0 and out.attempted >= 1
    bad = dsv2.run(ctx(tmp_path, monkeypatch, faults={"step": _half_batch}))
    assert not bad.correct


def test_the_controls_route_unlike_the_reference(tmp_path, monkeypatch):
    """The float8 control's top-k sets differ from the float32 reference's;
    the reference's own read 0."""
    c = ctx(tmp_path, monkeypatch)
    names = ["model.outfit_token"]
    want, low = dsv2.Routes(), dsv2.Routes()
    dsv2.reference_readings(c, names, routes=want)
    dsv2.reference_readings(c, names, low=True, routes=low)
    same = dsv2.Routes()
    same.program, same.reference, same.real = want.reference, want.reference, want.real
    other = copy.copy(same)
    other.program = low.reference
    assert same.mismatch() == 0.0 and other.mismatch() > 0.05


def test_tower_flops_by_hand():
    cfg = config()
    attn = 2 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048) + 2 * 16 * 16 * 320
    dense = 2 * 3 * 2048 * 10944
    mixture = 2 * (2048 * 64 + 3 * 2048 * 1408 * 8)
    per_token = 27 * attn + dense + 26 * mixture
    assert flops_dsv2.tower_token_flops(cfg, 16) == per_token
    assert per_token * 16384 == pytest.approx(73.4e12, rel=2e-3)
    items = 64 * 16
    step = 4 * (items * (flops.resnet18_forward_flops(224) + 16 * per_token)
                + 6 * items * 2560 * 64 + 3 * flops.set_transformer_forward_flops(cfg, 64))
    assert flops_dsv2.ocp_step_flops(cfg, 64, 4) == pytest.approx(step, rel=1e-12)


def test_bounds_by_hand():
    cfg = config()
    ops = 2 * 98304 * 3 * 2048 * 1408
    assert flops_dsv2.expert_bound(cfg, 16384, "bfloat16") == pytest.approx(ops / 989e12)
    assert ops / 989e12 == pytest.approx(1.72e-3, rel=0.01)
    shape = (1024, 16, 16, 192, 128)
    nbytes = 1024 * 16 * 16 * (2 * 192 + 2 * 128) * 2 + 1024 * 16
    assert flops_dsv2.split_attention_bound(shape, "bfloat16") == pytest.approx(
        max(nbytes / HBM_BYTES_PER_S, 2 * 1024 * 16 * 256 * 320 / PEAK_FLOPS["bfloat16"]))
    assert flops_dsv2.attention_bound((8, 16, 17, 8), "bfloat16", True) == flops.attention_bound(
        (8, 16, 17, 8), "bfloat16", True)
    launches = flops_dsv2.attention_launches(cfg, 64, 4)
    assert launches[-1] == (shape, False, 27 * 4)
    assert launches[:2] == [((64, 16, 17, 8), False, 24), ((64, 16, 17, 8), True, 24)]


def _rec(spans=(), kernels=None, trace=True):
    cfg = config()
    derived = {"profiled_steps": 2, "compute_dtype": "bfloat16",
               "attention_launches": flops_dsv2.attention_launches(cfg, 64, 4),
               "expert_s": flops_dsv2.expert_bound(cfg, 16384, "bfloat16")}
    tr = {"kernels": kernels or {}} if trace else None
    return types.SimpleNamespace(config=cfg, params={"accumulation": 4}, derived=derived,
                                 trace=tr, spans=None)


def _span(name, device_s):
    return types.SimpleNamespace(name=name, device_s=device_s)


def test_readers_on_synthetic_records():
    rec = _rec()
    experts = [_span("outfitx.experts", 0.004)] * (26 * 8)
    got = tower_spans.expert_roofline(rec, experts)
    assert got == pytest.approx(100 * rec.derived["expert_s"] / 0.004)
    assert tower_spans.expert_roofline(rec, experts[1:]) is None
    assert tower_spans.device_ms_per_microbatch(rec, "outfitx.experts", experts) == pytest.approx(
        1e3 * 0.004 * 26)
    assert tower_spans.device_ms_per_microbatch(rec, "outfitx.mla", experts) is None
    counts = [types.SimpleNamespace(name="outfitx.expert_tokens", tag=layer,
                                    values=[1] * 63 + [1 + layer]) for layer in (1, 2, 3)] * 2
    want = sorted((1 + layer) / ((63 + 1 + layer) / 64) for layer in (1, 2, 3))[1]
    assert tower_spans.expert_load_max(rec, counts) == pytest.approx(want)
    assert tower_spans.expert_load_max(rec, []) is None
    launches = sum(n * 2 for _, _, n in rec.derived["attention_launches"])
    rec = _rec(kernels={"masked_mha_fwd_split_kernel": [0.02, launches]})
    least = sum(flops_dsv2.attention_bound(s, "bfloat16", b) * n * 2
                for s, b, n in rec.derived["attention_launches"])
    assert flops_dsv2.attn_roofline(rec) == pytest.approx(100 * least / 0.02)
    rec = _rec(kernels={"masked_mha_fwd_split_kernel": [0.02, launches - 1]})
    assert flops_dsv2.attn_roofline(rec) is None
    assert math.isfinite(least) and least > 0
