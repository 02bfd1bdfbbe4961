"""DeepSeek-V2 as the port's text tower (``models/towers/deepseek_v2.py``,
``ops/moe.py``, ``masked_mha``'s split route) against the plain float32
reference ``tests/dsv2_reference.py``, at a tiny size on the CPU: hidden 64,
4 heads of nope 16 / rope 8 / v 16, kv rank 32, 8 experts top-2 and one
shared, one dense layer and two mixtures, vocabulary 512, T 8. The
``resnet_dsv2lite`` pair through ``ItemEncoderModel`` and one
``original_cp_train_step``. The tests marked ``card`` run on a CUDA card
only: the split attention and the grouped product against their plain
versions, and one mixture captured in a CUDA graph (nothing in it waits
for the host)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.core import trace
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.data.tokenizer import TOKENIZER_FILES, load_tokenizer
from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel, tower_configs
from outfitx_tpu_torch.models.towers.deepseek_v2 import (
    DeepseekV2,
    DeepseekV2Config,
    softmax_scale,
    yarn_inv_freq,
)
from outfitx_tpu_torch.models.towers.resnet import ResNet18Config
from outfitx_tpu_torch.ops import attention, moe
from outfitx_tpu_torch.ops.attention import masked_mha
from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPTrainer, RawItemSource
from outfitx_tpu_torch.train.steps import original_cp_train_step
import dsv2_reference as ref

torch.set_num_threads(1)

TINY = DeepseekV2Config(
    vocab_size=512, max_len=64, d_model=64, n_layers=3, n_heads=4, qk_nope_dim=16,
    qk_rope_dim=8, v_dim=16, kv_lora_rank=32, d_ffn=96, d_expert=24, n_experts=8, top_k=2,
    n_shared=1, first_dense=1, d_out=8, compute_dtype="float32",
)
T = 8

# The published config.json of deepseek-ai/DeepSeek-V2-Lite, as far as the tower reads it.
PUBLISHED = {
    "hidden_size": 2048, "num_hidden_layers": 27, "num_attention_heads": 16,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128, "kv_lora_rank": 512,
    "intermediate_size": 10944, "moe_intermediate_size": 1408, "n_routed_experts": 64,
    "num_experts_per_tok": 6, "n_shared_experts": 2, "first_k_dense_replace": 1,
    "routed_scaling_factor": 1, "rms_norm_eps": 1e-6, "rope_theta": 10000, "vocab_size": 102400,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
}


def published_names(c: DeepseekV2Config) -> dict:
    """A tower config under the published keys, for the reference."""
    return {
        "hidden_size": c.d_model, "num_hidden_layers": c.n_layers,
        "num_attention_heads": c.n_heads, "qk_nope_head_dim": c.qk_nope_dim,
        "qk_rope_head_dim": c.qk_rope_dim, "v_head_dim": c.v_dim, "kv_lora_rank": c.kv_lora_rank,
        "intermediate_size": c.d_ffn, "moe_intermediate_size": c.d_expert,
        "n_routed_experts": c.n_experts, "num_experts_per_tok": c.top_k,
        "n_shared_experts": c.n_shared, "first_k_dense_replace": c.first_dense,
        "routed_scaling_factor": c.routed_scaling, "rms_norm_eps": c.rms_eps,
        "rope_theta": c.rope_theta, "vocab_size": c.vocab_size,
        "rope_scaling": {"beta_fast": c.beta_fast, "beta_slow": c.beta_slow,
                         "factor": c.rope_factor, "mscale": c.mscale,
                         "mscale_all_dim": c.mscale_all_dim,
                         "original_max_position_embeddings": c.rope_original_max},
    }


def seeded_weights(tower: DeepseekV2, seed: int = 0) -> dict:
    """N(0, 0.15) matrices and norms 1 + N(0, 0.1), so that every term
    moves the result, loaded into the tower in place; the same dict for the
    reference."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in tower.state_dict().items():
        t = torch.randn(p.shape, generator=gen)
        sd[name] = 1.0 + 0.1 * t if name.endswith("norm.weight") else 0.15 * t
    tower.load_state_dict(sd, strict=True)
    return sd


def tokens(n: int, seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, TINY.vocab_size, (n, T), generator=gen)
    lengths = torch.randint(2, T + 1, (n, 1), generator=gen)
    lengths[0] = T
    attn = (torch.arange(T)[None, :] < lengths).to(torch.int32)
    return ids * attn, attn


def record_routes(tower):
    routes = []
    hooks = [layer.ffn.router.register_forward_hook(lambda m, i, o: routes.append(o[1]))
             for layer in tower.layers if hasattr(layer.ffn, "router")]
    return routes, hooks


@pytest.fixture(scope="module")
def tiny():
    tower = DeepseekV2(TINY)
    sd = seeded_weights(tower)
    return tower, sd


def test_tower_matches_the_reference_and_routes_alike(tiny):
    tower, sd = tiny
    ids, attn = tokens(6)
    routes, hooks = record_routes(tower)
    with torch.no_grad():
        got = tower.features(ids, attn)
        got_emb = tower(ids, attn)
    for h in hooks:
        h.remove()
    want, want_routes = ref.features(sd, published_names(TINY), ids, attn)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    assert len(routes) == 2 * len(want_routes) == 4  # features, then forward
    for r, w in zip(routes[:2], want_routes):
        assert torch.equal(r.sort(dim=-1).values, w.sort(dim=-1).values)
    want_emb = ref.text_embedding(sd, published_names(TINY), ids, attn)
    got_emb = got_emb / torch.linalg.norm(got_emb, dim=-1, keepdim=True)
    np.testing.assert_allclose(got_emb.numpy(), want_emb.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg", [TINY, DeepseekV2Config()], ids=["tiny", "published"])
def test_yarn_frequencies_follow_the_formula(cfg):
    got = yarn_inv_freq(cfg)
    want = ref.inv_freq(published_names(cfg))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    assert softmax_scale(cfg) == pytest.approx(ref.softmax_scale(published_names(cfg)))


def test_published_yarn_ramp_and_scale():
    """low = floor(d(32)) = 10, high = ceil(d(1)) = 23: frequencies 0-10
    keep base^(-2i/64), 23-31 are a 40th of it; m = 0.1 * 0.707 ln 40 + 1."""
    got = yarn_inv_freq(DeepseekV2Config()).double()
    extra = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    np.testing.assert_allclose(got[:11].numpy(), extra[:11].numpy(), rtol=1e-6)
    np.testing.assert_allclose(got[23:].numpy(), (extra[23:] / 40).numpy(), rtol=1e-6)
    assert ((got[11:23] < extra[11:23]) & (got[11:23] > extra[11:23] / 40)).all()
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m == pytest.approx(1.2608, abs=1e-4)
    assert softmax_scale(DeepseekV2Config()) == pytest.approx(192 ** -0.5 * m * m)
    assert ref.softmax_scale(PUBLISHED) == pytest.approx(192 ** -0.5 * m * m)


def test_pad_tokens_change_no_pooled_output(tiny):
    tower, _ = tiny
    ids, attn = tokens(5, seed=3)
    other = torch.where(attn == 1, ids, torch.randint_like(ids, 1, TINY.vocab_size))
    with torch.no_grad():
        a, b = tower(ids, attn), tower(other, attn)
    assert not torch.equal(ids, other)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(3, 2, 5, 24, 16), (2, 4, 16, 192, 128)])
def test_split_attention_matches_plain_softmax(shape, causal):
    b, h, l, dqk, dv = shape
    gen = torch.Generator().manual_seed(l)
    q, k = (torch.randn(b, h, l, dqk, generator=gen) for _ in range(2))
    v = torch.randn(b, h, l, dv, generator=gen)
    pad = torch.rand(b, l, generator=gen) < 0.3
    pad[:, 0] = False
    scale = 0.17
    got = masked_mha(q, k, v, pad, causal=causal, scale=scale)
    s = (q @ k.transpose(-1, -2) * scale).masked_fill(pad[:, None, None, :], -1e9)
    if causal:
        s = s.masked_fill(torch.ones(l, l, dtype=torch.bool).triu(1), -1e9)
    want = torch.softmax(s, dim=-1) @ v
    assert got.shape == (b, h, l, dv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_split_route_takes_only_dqk_unlike_dv(monkeypatch):
    """A scale with Dqk == Dv raises; Dqk != Dv reaches the split entry on
    the card (its loader stubbed); it has no backward."""
    q = torch.zeros(2, 2, 9, 16)
    pad = torch.zeros(2, 9, dtype=torch.bool)
    with pytest.raises(ValueError, match="only where Dqk != Dv"):
        masked_mha(q, q, q, pad, scale=0.5)
    bound = []
    monkeypatch.setattr(attention, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(attention._launch, "bind",
                        lambda name, types, entry=None: bound.append((name, entry)) or
                        pytest.skip("bound"))
    v = torch.zeros(2, 2, 9, 8)
    with pytest.raises(pytest.skip.Exception):
        masked_mha(q, q.clone(), v, pad)
    assert bound == [("masked_mha_fwd", "masked_mha_fwd_split")]


@pytest.mark.parametrize("shape, error", [
    ((2, 2, 81, 24, 16), "L <= 80"),
    ((2, 2, 9, 264, 16), "up to 256"),
    ((2, 2, 9, 24, 136), "up to 128"),
    ((2, 2, 9, 20, 16), "multiple"),
])
def test_split_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch, shape, error):
    monkeypatch.setattr(attention, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(attention._build, "load", lambda name: pytest.fail("kernel was loaded"))
    b, h, l, dqk, dv = shape
    q = torch.zeros(b, h, l, dqk)
    with pytest.raises(ValueError, match=error):
        masked_mha(q, q.clone(), torch.zeros(b, h, l, dv), torch.zeros(b, l, dtype=torch.bool))


def test_mixture_ops_match_a_per_expert_loop():
    """route, permute, grouped_mm, unpermute and combine against a loop
    over experts; an expert with no token leaves an empty group."""
    gen = torch.Generator().manual_seed(5)
    n, d, f, e, k = 40, 16, 12, 8, 2
    x = torch.randn(n, d, generator=gen)
    router = torch.randn(e, d, generator=gen)
    gate_up = torch.randn(e, 2 * f, d, generator=gen)
    down = torch.randn(e, d, f, generator=gen)
    w, idx = moe.route(x, router, k, scaling=1.5)
    scores = torch.softmax(x @ router.T, dim=-1)
    np.testing.assert_allclose(w.numpy(), 1.5 * scores.topk(k).values.numpy(), rtol=1e-6)
    # two distinct experts a token, never expert 3: an empty group
    kept = torch.tensor([0, 1, 2, 4, 5, 6, 7])
    idx = torch.stack([kept[torch.randperm(7, generator=gen)[:k]] for _ in range(n)])
    order, counts, ends = moe.permute(idx, e)
    assert counts.dtype == ends.dtype == torch.int32 and int(counts[3]) == 0
    assert torch.equal(ends, torch.cumsum(counts, 0, dtype=torch.int32))
    xs = x[order // k]
    g, u = moe.grouped_mm(xs, gate_up, ends).split(f, dim=-1)
    ys = moe.grouped_mm(torch.nn.functional.silu(g) * u, down, ends)
    got = moe.combine(moe.unpermute(ys, order), w)
    want = torch.zeros(n, d)
    for tok in range(n):
        for s in range(k):
            ex = int(idx[tok, s])
            gg, uu = (x[tok] @ gate_up[ex].T).split(f)
            want[tok] += w[tok, s] * ((torch.nn.functional.silu(gg) * uu) @ down[ex].T)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)


def test_expert_counter_records_only_under_the_profiler(tiny):
    tower, _ = tiny
    ids, attn = tokens(3)
    tracer = trace.TRACER
    tracer.clear()
    with torch.no_grad():
        tower(ids, attn)
    assert trace.counters() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            tower(ids, attn)
    counts = [c for c in trace.counters() if c.name == "outfitx.expert_tokens"]
    spans = trace.totals(trace.records())
    tracer.clear()
    assert [c.tag for c in counts] == [1, 2]
    assert all(sum(c.values) == 3 * T * TINY.top_k and len(c.values) == 8 for c in counts)
    assert spans["outfitx.mla"][0] == 3 and spans["outfitx.moe"][0] == 2
    assert spans["outfitx.route"][0] == 4 and spans["outfitx.experts"][0] == 2


def test_the_pair_builds_and_runs_one_original_cp_step(tmp_path):
    """resnet_dsv2lite through ItemEncoderModel, OriginalCPTrainer and one
    original_cp_train_step: the loss is finite, the heads move, the towers
    stay and take no gradient."""
    enc_cfg = dataclasses.replace(tcfg.ItemEncoderConfig.for_type("resnet_dsv2lite"),
                                  dim_per_modality=8)
    vc, tc = tower_configs(enc_cfg)
    assert isinstance(tc, DeepseekV2Config) and tc.n_experts == 64 and tc.d_out == 8
    enc = ItemEncoderModel(
        enc_cfg, vision_cfg=ResNet18Config(d_out=8, image_size=32, compute_dtype="float32"),
        text_cfg=dataclasses.replace(TINY, d_out=8), device="cpu",
    )
    assert enc.has_trainable_heads and enc.device.type == "cpu"
    trainable = {n for n, p in enc.named_parameters() if p.requires_grad}
    assert trainable == {"vision.fc.weight", "vision.fc.bias", "text.proj.weight",
                         "text.proj.bias"}
    model_cfg = tcfg.OutfitXConfig(
        item_encoder=enc_cfg, transformer=tcfg.TransformerConfig(n_heads=4, d_ffn=32,
                                                                 n_layers=1, dropout=0.0),
        max_outfit_len=8, compute_dtype="float32",
    )
    cfg = tcfg.CPTrainConfig(n_epochs=1, batch_size=8, accumulation_steps=2,
                             checkpoint_dir=str(tmp_path / "c"), log_dir=str(tmp_path / "l"))
    data = make_synthetic(n_items=60, d_embed=16, n_outfits=64, seed=2)
    source = RawItemSource.synthetic(n_items=60, image_size=32, text_len=T,
                                     vocab=TINY.vocab_size, seed=4)
    frozen = enc.text.layers[1].ffn.gate_up.detach().clone()
    with OriginalCPTrainer(cfg, model_cfg, "custom", encoder=enc, source=source,
                           train_split=data.cp_train, valid_split=data.cp_valid,
                           device="cpu") as t:
        head = enc.text.proj.weight.detach().clone()
        split = t._train_split
        sels = next(t.step_selections(split, 0))
        out = original_cp_train_step(t.state, (t.microbatch(split, s) for s in sels))
        assert torch.isfinite(out["loss"]) and out["scores"].shape == (2, 8)
        assert not torch.equal(enc.text.proj.weight, head)
        assert torch.equal(enc.text.layers[1].ffn.gate_up, frozen)
        assert enc.text.layers[1].ffn.gate_up.grad is None


def test_the_pair_without_its_tokenizer_names_the_missing_files(tmp_path):
    with pytest.raises(FileNotFoundError) as err:
        load_tokenizer(str(tmp_path / "DeepSeek-V2-Lite"), vocab_size=102400, required=True)
    assert all(f in str(err.value) for f in TOKENIZER_FILES)
    assert callable(load_tokenizer(str(tmp_path / "DeepSeek-V2-Lite"), vocab_size=512))


# --------------------------------------------------------------- card --
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.init()
    return torch.device("cuda")


@pytest.mark.card
def test_split_attention_kernel_matches_its_plain_version(card):
    """The split route at the tower's (1024, 16, 16, 192 / 128), causal with
    tail-padded keys, bfloat16 and float32."""
    b, h, l, dqk, dv = 1024, 16, 16, 192, 128
    gen = torch.Generator(device=card).manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        q, k = (torch.randn(b, h, l, dqk, generator=gen, device=card).to(dtype) for _ in range(2))
        v = torch.randn(b, h, l, dv, generator=gen, device=card).to(dtype)
        lengths = torch.randint(1, l + 1, (b, 1), generator=gen, device=card)
        pad = torch.arange(l, device=card)[None, :] >= lengths
        got = masked_mha(q, k, v, pad, causal=True, scale=0.1147)
        want = attention.mha_reference(q, k, v, pad, True, 0.1147)
        tol = 2.0 ** -7 * want.float().abs().clamp_min(1.0) if dtype == torch.bfloat16 else 1e-5
        assert ((got.float() - want.float()).abs() <= tol).all()


@pytest.mark.card
def test_one_mixture_captures_in_a_cuda_graph(card):
    """One mixture at DeepSeek-V2-Lite's widths over 2,048 tokens, bfloat16:
    captured in a CUDA graph (a read of a count on the host would break
    the capture) and replayed, equal to the eager call and near the
    per-expert loop."""
    cfg = dataclasses.replace(DeepseekV2Config(), n_layers=2)
    tower = DeepseekV2(cfg, device=card)
    tower.init_weights_(torch.Generator(device=card).manual_seed(0))
    layer = tower.layers[1].ffn
    x = torch.randn(2048, cfg.d_model, device=card).to(torch.bfloat16)
    with torch.no_grad():
        eager = layer(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            layer(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = layer(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
        w, idx = layer.router(x)
        order, _, ends = moe.permute(idx, cfg.n_experts)
        xs = x[order // cfg.top_k]
        g, u = moe.grouped_mm_reference(xs, layer.gate_up, ends).split(cfg.d_expert, dim=-1)
        ys = moe.grouped_mm_reference(torch.nn.functional.silu(g) * u, layer.down, ends)
        want = moe.combine(moe.unpermute(ys, order), w) + layer.shared(x).float()
        err = (eager.float() - want).abs().max() / want.abs().max()
        assert float(err) < 2e-2
