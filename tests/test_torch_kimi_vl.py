"""Kimi-VL-A3B as the port's joint item encoder (``kimivl_a3b``:
``models/towers/moonvit.py``, ``towers/deepseek_v2.py`` with the sigmoid
router, ``ops/moe.py route_sigmoid``, ``masked_mha`` at MoonViT's and the
joint sequence's shapes) against the plain float32 reference
``tests/kimivl_reference.py``, at a tiny size on the CPU: MoonViT of 2
layers, hidden 32, 4 heads of 8, 56-pixel images (a 4 x 4 grid, 4 image
tokens) with an 8 x 8 position table; the decoder of hidden 64, 4 heads of
nope 16 / rope 8 / v 16, one dense layer and two mixtures of 8 experts
top-2 and one shared; titles of 8 tokens. Tests marked ``card`` run on a
CUDA card only: the attention kernel's Dh-72 tile route and the split
route at L = 80 against their plain versions, and the sigmoid router on the
card against the CPU's."""

import dataclasses

import numpy as np
import pytest
import torch

from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.core import trace
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.data.tokenizer import TOKENIZER_FILES, load_tokenizer
from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel, tower_configs
from outfitx_tpu_torch.models.towers.deepseek_v2 import DeepseekV2Config, yarn_inv_freq
from outfitx_tpu_torch.models.towers.moonvit import MoonViT, MoonViTConfig, rotary_tables
from outfitx_tpu_torch.models.towers.resnet import ResNet18Config
from outfitx_tpu_torch.ops import attention, moe
from outfitx_tpu_torch.ops.attention import masked_mha
from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPTrainer, RawItemSource
from outfitx_tpu_torch.train.precompute import PrecomputeRunner
from outfitx_tpu_torch.train.steps import original_cp_train_step
import kimivl_reference as ref

torch.set_num_threads(1)

D = 8  # dim_per_modality
T = 8  # title tokens
VISION = MoonViTConfig(image_size=56, d_model=32, n_heads=4, d_mlp=48, n_layers=2, pos_grid=8,
                       d_text=64, d_out=D, compute_dtype="float32")
DECODER = DeepseekV2Config(
    vocab_size=512, max_len=64, d_model=64, n_layers=3, n_heads=4, qk_nope_dim=16,
    qk_rope_dim=8, v_dim=16, kv_lora_rank=32, d_ffn=96, d_expert=24, n_experts=8, top_k=2,
    n_shared=1, first_dense=1, routed_scaling=2.446, rms_eps=1e-5, rope_theta=800000.0,
    rope_factor=1.0, scoring="sigmoid", d_out=D, compute_dtype="float32",
)
# The float32 program against the float32 reference sums in other orders
# (batched products, the attention's per-head loop, the experts' grouped
# rows): a few ulps a product through 2 + 3 layers, under 1e-5 on
# embeddings of unit halves. A bfloat16 program reads about 1e-2 there
# (test_a_bfloat16_encoder_fails_the_tolerance), a thousand times over it.
TOL = 2e-5


def published_names(v: MoonViTConfig, t: DeepseekV2Config) -> dict:
    """The tiny towers under the published config.json's keys."""
    return {
        "hidden_size": t.d_model, "num_hidden_layers": t.n_layers,
        "num_attention_heads": t.n_heads, "qk_nope_head_dim": t.qk_nope_dim,
        "qk_rope_head_dim": t.qk_rope_dim, "v_head_dim": t.v_dim, "kv_lora_rank": t.kv_lora_rank,
        "intermediate_size": t.d_ffn, "moe_intermediate_size": t.d_expert,
        "n_routed_experts": t.n_experts, "num_experts_per_tok": t.top_k,
        "n_shared_experts": t.n_shared, "first_k_dense_replace": t.first_dense,
        "routed_scaling_factor": t.routed_scaling, "rms_norm_eps": t.rms_eps,
        "rope_theta": t.rope_theta, "vocab_size": t.vocab_size, "rope_scaling": None,
        "vision_config": {
            "patch_size": v.patch_size, "hidden_size": v.d_model,
            "num_attention_heads": v.n_heads, "num_hidden_layers": v.n_layers,
            "intermediate_size": v.d_mlp, "init_pos_emb_height": v.pos_grid,
            "init_pos_emb_width": v.pos_grid, "merge_kernel_size": [v.merge, v.merge],
        },
    }


CFG = published_names(VISION, DECODER)


def encoder(vision=VISION, decoder=DECODER, seed=0):
    enc_cfg = dataclasses.replace(tcfg.ItemEncoderConfig.for_type("kimivl_a3b"),
                                  dim_per_modality=D)
    return ItemEncoderModel(enc_cfg, vision_cfg=vision, text_cfg=decoder, device="cpu", seed=seed)


def seeded_weights(enc: ItemEncoderModel, seed: int = 0):
    """N(0, 0.15) matrices and biases, norms and LayerNorm scales 1 + N(0,
    0.1), shifts N(0, 0.1), router biases N(0, 0.1), so that every term
    moves the result, loaded into the encoder in place; (vision dict,
    decoder dict) in float32 for the reference."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in enc.state_dict().items():
        t = torch.randn(p.shape, generator=gen)
        if name.endswith(("norm.weight", "ln1.weight", "ln2.weight", "ln.weight")):
            t = 1.0 + 0.1 * t
        elif name.endswith(("ln1.bias", "ln2.bias", "ln.bias", "e_score_correction_bias")):
            t = 0.1 * t
        else:
            t = 0.15 * t
        sd[name] = t.to(p.dtype)
    enc.load_state_dict(sd, strict=True)
    v = {k[7:]: t.float() for k, t in sd.items() if k.startswith("vision.")}
    t = {k[5:]: x.float() for k, x in sd.items() if k.startswith("text.")}
    return v, t


def items(n: int, size: int = 56, seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (n, 3, size, size), generator=gen, dtype=torch.uint8)
    ids = torch.randint(1, DECODER.vocab_size, (n, T), generator=gen)
    lengths = torch.randint(4, T + 1, (n, 1), generator=gen)
    lengths[0] = T
    attn = (torch.arange(T)[None, :] < lengths).to(torch.int32)
    return images, ids * attn, attn


def normalized(images):
    return (images.float() / 255.0 - 0.5) / 0.5


def record_routes(tower):
    routes = []
    hooks = [layer.ffn.router.register_forward_hook(lambda m, i, o: routes.append(o[1]))
             for layer in tower.layers if hasattr(layer.ffn, "router")]
    return routes, hooks


@pytest.fixture(scope="module")
def tiny():
    enc = encoder()
    v, t = seeded_weights(enc)
    return enc, v, t


def test_the_encoder_matches_the_reference_and_routes_alike(tiny):
    enc, v, t = tiny
    images, ids, attn = items(5)
    routes, hooks = record_routes(enc.text)
    with torch.no_grad():
        got = enc.encode(images, ids, attn)
    for h in hooks:
        h.remove()
    want, want_routes = ref.item_embedding(v, t, CFG, normalized(images), ids, attn)
    assert got.shape == (5, 2 * D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    assert len(routes) == len(want_routes) == 2
    for r, w in zip(routes, want_routes):
        assert r.shape == (5 * (4 + T), DECODER.top_k)
        assert torch.equal(r.sort(dim=-1).values, w.sort(dim=-1).values)


def test_each_modality_alone_runs_the_decoder_over_it(tiny):
    """encode_images: the decoder over the image tokens alone, through fc;
    encode_texts: over the title alone, through proj."""
    enc, v, t = tiny
    images, ids, attn = items(3, seed=2)
    with torch.no_grad():
        img, txt = enc.encode_images(images), enc.encode_texts(ids, attn)
    tokens = ref.project(v, CFG, ref.vit(v, CFG, normalized(images)))
    x, _ = ref.decoder(t, CFG, tokens, None, None)
    want_img = ref.normalized(x.mean(dim=1) @ v["fc.weight"].T + v["fc.bias"])
    x, _ = ref.decoder(t, CFG, None, ids, attn)
    w = attn.float()[..., None]
    pooled = (x * w).sum(dim=1) / w.sum(dim=1)
    want_txt = ref.normalized(pooled @ t["proj.weight"].T + t["proj.bias"])
    np.testing.assert_allclose(img.numpy(), want_img.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(txt.numpy(), want_txt.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("low", ["decoder", "vision"])
def test_a_bfloat16_encoder_fails_the_tolerance(tiny, low):
    """The same weights with the decoder, or MoonViT, in bfloat16 miss the
    reference by far more than TOL: the tolerance would catch a lower
    precision than the float32 configured here."""
    _, v, t = tiny
    vision = dataclasses.replace(VISION, compute_dtype="bfloat16") if low == "vision" else VISION
    decoder = (dataclasses.replace(DECODER, compute_dtype="bfloat16") if low == "decoder"
               else DECODER)
    enc = encoder(vision, decoder)
    full = {**{"vision." + k: x for k, x in v.items()}, **{"text." + k: x for k, x in t.items()}}
    enc.load_state_dict({k: full[k].to(p.dtype) for k, p in enc.state_dict().items()})
    images, ids, attn = items(5)
    with torch.no_grad():
        got = enc.encode(images, ids, attn)
    want, _ = ref.item_embedding(v, t, CFG, normalized(images), ids, attn)
    assert float((got - want).abs().max()) > 100 * TOL


@pytest.mark.parametrize("cfg", [VISION, MoonViTConfig()], ids=["tiny", "published"])
def test_the_2d_rotary_follows_the_formula(cfg):
    """Pair j of a head's columns turns by col w_(j // 2) (even j) or row
    w_(j // 2) (odd j), w_i = 10000^(-4 i / Dh), token n = (row, col) =
    divmod(n, g); the turn is the complex product."""
    cos, sin = rotary_tables(cfg)
    dh, g = cfg.d_model // cfg.n_heads, cfg.grid
    angles = ref.rotary_angles(g, dh)
    np.testing.assert_allclose(cos.numpy(), angles.cos().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), angles.sin().numpy(), rtol=1e-6, atol=1e-6)
    n = g + 3  # row 1, column 3
    assert float(angles[n, 0]) == 3.0 and float(angles[n, 1]) == 1.0
    assert float(angles[n, 2]) == pytest.approx(3 * 10000.0 ** (-4.0 / dh))
    x = torch.randn(2, 3, g * g, dh, generator=torch.Generator().manual_seed(3))
    tower = MoonViT(cfg) if cfg is VISION else None
    if tower is not None:
        np.testing.assert_allclose(tower.rotary(x).numpy(), ref.rotate_pairs(x, angles).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_the_position_table_is_bicubic_by_the_formula(tiny):
    """The table through F.interpolate (bicubic, align_corners False)
    equals Keys' cubic convolution written out; from 64 to 16 every output
    lies halfway between two table entries, weights -3/32, 19/32, 19/32,
    -3/32."""
    enc, v, _ = tiny
    got = enc.vision.position_table(torch.float32)
    np.testing.assert_allclose(got.numpy(), ref.position_table(v["pos_table"], 4).numpy(),
                               rtol=1e-5, atol=1e-6)
    m = ref.bicubic_matrix(64, 16)
    assert torch.equal(m[5, 20:24], torch.tensor([-3 / 32, 19 / 32, 19 / 32, -3 / 32],
                                                 dtype=torch.float64))
    table = torch.randn(64, 64, 6, generator=torch.Generator().manual_seed(4))
    big = MoonViT(dataclasses.replace(MoonViTConfig(), d_model=6, n_heads=1, n_layers=0,
                                      d_text=8, compute_dtype="float32"))
    with torch.no_grad():
        big.pos_table.copy_(table)
    np.testing.assert_allclose(big.position_table(torch.float32).detach().numpy(),
                               ref.position_table(table, 16).numpy(), rtol=1e-5, atol=1e-5)


def test_the_correction_bias_flips_a_choice():
    """Selection follows s + bias, weights follow s alone: with a bias that
    lifts expert 3 above expert 0 for token 0, expert 3 is chosen and
    weighted by its own score, normalised over the chosen, times the
    scaling."""
    x = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    weight = torch.tensor([[2.0, 0.0], [1.5, 0.0], [0.0, 2.0], [0.5, 0.5]])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.4])
    s = torch.sigmoid(x @ weight.T)
    w, idx = moe.route_sigmoid(x, weight, bias, 2, scaling=2.446)
    assert torch.topk(s[0], 2).indices.tolist() == [0, 1]
    assert idx[0].tolist() == [3, 0]  # 0.622 + 0.4 lifts expert 3 over 0.881
    assert idx[1].tolist() == [3, 2]
    for row in range(2):
        sel = s[row, idx[row]]
        np.testing.assert_allclose(w[row].numpy(), (sel / sel.sum() * 2.446).numpy(), rtol=1e-6)
    w0, idx0 = moe.route_sigmoid(x, weight, torch.zeros(4), 2)
    assert idx0[0].tolist() == [0, 1] and not torch.equal(idx0, idx)
    np.testing.assert_allclose(w0.sum(dim=-1).numpy(), [1.0, 1.0], rtol=1e-6)


def test_plain_rope_without_rope_scaling():
    """rope_factor 1 (rope_scaling null): base^(-2i/dim) at base 800,000,
    and S scaled by Dqk^-0.5 with no YaRN factor."""
    from outfitx_tpu_torch.models.towers.deepseek_v2 import softmax_scale

    cfg = tower_configs(tcfg.ItemEncoderConfig.for_type("kimivl_a3b"))[1]
    want = 800000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    np.testing.assert_allclose(yarn_inv_freq(cfg).numpy(), want.numpy(), rtol=2e-7)
    assert softmax_scale(cfg) == 192 ** -0.5


def test_pad_title_tokens_change_no_output(tiny):
    enc, _, _ = tiny
    images, ids, attn = items(4, seed=3)
    other = torch.where(attn == 1, ids, torch.randint_like(ids, 1, DECODER.vocab_size))
    with torch.no_grad():
        a, b = enc.encode(images, ids, attn), enc.encode(images, other, attn)
    assert not torch.equal(ids, other)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_the_spans_and_the_counter_record_under_the_profiler(tiny):
    """One outfitx.vision and one outfitx.project an encode, the decoder's
    spans a layer, the expert counter a mixture over every joint token."""
    enc, _, _ = tiny
    images, ids, attn = items(3)
    tracer = trace.TRACER
    tracer.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            enc.encode(images, ids, attn)
    counts = [c for c in trace.counters() if c.name == "outfitx.expert_tokens"]
    spans = trace.totals(trace.records())
    tracer.clear()
    assert spans["outfitx.vision"][0] == 1 and spans["outfitx.project"][0] == 1
    assert spans["outfitx.mla"][0] == 3 and spans["outfitx.moe"][0] == 2
    assert [c.tag for c in counts] == [1, 2]
    assert all(sum(c.values) == 3 * (4 + T) * DECODER.top_k for c in counts)


def test_the_pair_builds_and_runs_one_original_cp_step(tmp_path):
    """kimivl_a3b through ItemEncoderModel, OriginalCPTrainer and one
    original_cp_train_step: the loss is finite, both heads move, the towers
    stay and take no gradient."""
    enc_cfg = dataclasses.replace(tcfg.ItemEncoderConfig.for_type("kimivl_a3b"),
                                  dim_per_modality=D)
    vc, tc = tower_configs(enc_cfg)
    assert (vc.d_model, vc.d_mlp, vc.n_layers, vc.patch_size, vc.n_tokens) == (
        1152, 4304, 27, 14, 64)
    assert (tc.d_ffn, tc.n_experts, tc.routed_scaling, tc.scoring, tc.vocab_size) == (
        11264, 64, 2.446, "sigmoid", 163840)
    enc = encoder()
    assert enc.joint and enc.has_trainable_heads
    trainable = {n for n, p in enc.named_parameters() if p.requires_grad}
    assert trainable == {"vision.fc.weight", "vision.fc.bias", "text.proj.weight",
                         "text.proj.bias"}
    model_cfg = tcfg.OutfitXConfig(
        item_encoder=enc_cfg, transformer=tcfg.TransformerConfig(n_heads=4, d_ffn=32,
                                                                 n_layers=1, dropout=0.0),
        max_outfit_len=8, compute_dtype="float32",
    )
    cfg = tcfg.CPTrainConfig(n_epochs=1, batch_size=4, accumulation_steps=2,
                             checkpoint_dir=str(tmp_path / "c"), log_dir=str(tmp_path / "l"))
    data = make_synthetic(n_items=40, d_embed=16, n_outfits=32, seed=2)
    source = RawItemSource.synthetic(n_items=40, image_size=56, text_len=T,
                                     vocab=DECODER.vocab_size, seed=4)
    frozen = enc.text.layers[1].ffn.gate_up.detach().clone()
    vit = enc.vision.encoder.layers[0].fc1.weight.detach().clone()
    with OriginalCPTrainer(cfg, model_cfg, "custom", encoder=enc, source=source,
                           train_split=data.cp_train, valid_split=data.cp_valid,
                           device="cpu") as t:
        heads = [enc.vision.fc.weight.detach().clone(), enc.text.proj.weight.detach().clone()]
        split = t._train_split
        sels = next(t.step_selections(split, 0))
        out = original_cp_train_step(t.state, (t.microbatch(split, s) for s in sels))
        assert torch.isfinite(out["loss"]) and out["scores"].shape == (2, 4)
        assert not torch.equal(enc.vision.fc.weight, heads[0])
        assert not torch.equal(enc.text.proj.weight, heads[1])
        assert torch.equal(enc.text.layers[1].ffn.gate_up, frozen)
        assert torch.equal(enc.vision.encoder.layers[0].fc1.weight, vit)
        assert enc.text.layers[1].ffn.gate_up.grad is None
        assert enc.vision.encoder.layers[0].fc1.weight.grad is None


def test_the_pair_without_its_tokenizer_names_the_missing_files(tmp_path):
    pair = tcfg.ENCODER_PAIRS["kimivl_a3b"]
    assert pair.published_tokenizer
    with pytest.raises(FileNotFoundError) as err:
        load_tokenizer(str(tmp_path / "Kimi-VL-A3B-Instruct"), vocab_size=163840, required=True)
    assert all(f in str(err.value) for f in TOKENIZER_FILES + ("tiktoken.model",))
    assert "a loader of its own" in str(err.value)


@pytest.mark.parametrize("pair", ["resnet_dsv2lite", "kimivl_a3b"])
def test_the_precompute_sweep_over_polyvore_needs_the_published_tokenizer(tmp_path, pair):
    """Read from Polyvore, a pair with a published tokenizer raises naming
    its files where they are missing, rather than tokenizing with the hash
    stand-in; a synthetic sweep needs none."""
    enc_cfg = dataclasses.replace(tcfg.ItemEncoderConfig.for_type(pair), dim_per_modality=D)
    if pair == "kimivl_a3b":
        enc = encoder()
    else:
        enc = ItemEncoderModel(
            enc_cfg, vision_cfg=ResNet18Config(d_out=D, image_size=32, compute_dtype="float32"),
            text_cfg=dataclasses.replace(DECODER, scoring="softmax", routed_scaling=1.0),
            device="cpu")
    model_cfg = tcfg.OutfitXConfig(item_encoder=enc_cfg)
    cfg = tcfg.PrecomputeConfig(dataset_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError) as err:
        PrecomputeRunner(cfg, model_cfg, encoder=enc, device="cpu")
    assert all(f in str(err.value) for f in TOKENIZER_FILES)
    runner = PrecomputeRunner(cfg, model_cfg, encoder=enc, synthetic_items=4, device="cpu")
    assert runner.tokenizer is not None


def _stub_kernels(monkeypatch):
    bound = []
    monkeypatch.setattr(attention, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(attention._launch, "bind",
                        lambda name, types, entry=None: bound.append((name, entry)) or
                        pytest.skip("bound"))
    return bound


@pytest.mark.parametrize("shape", [(2, 16, 256, 72), (2, 2, 80, 192, 128)],
                         ids=["vit_dh72", "split_l80"])
def test_the_wrappers_take_the_vit_and_joint_shapes(monkeypatch, shape):
    """MoonViT's (L 256, Dh 72) in bfloat16 reaches the forward kernel's
    entry, the joint decoder's split L = 80 the split entry (loaders
    stubbed: the CPU has no compiler)."""
    bound = _stub_kernels(monkeypatch)
    b, h, l = shape[:3]
    q = torch.zeros(b, h, l, shape[3], dtype=torch.bfloat16)
    v = torch.zeros(b, h, l, shape[-1], dtype=torch.bfloat16)
    pad = torch.zeros(b, l, dtype=torch.bool)
    with pytest.raises(pytest.skip.Exception):
        masked_mha(q, q.clone(), v, pad, causal=len(shape) == 5)
    entry = "masked_mha_fwd_split" if len(shape) == 5 else None
    assert bound == [("masked_mha_fwd", entry)]


@pytest.mark.parametrize("shape, dtype, error", [
    ((2, 2, 256, 72), torch.float32, "multiple of 16"),  # the float32 kernel above L=64
    ((2, 2, 257, 72), torch.bfloat16, "L <= 256"),
    ((2, 2, 256, 76), torch.bfloat16, "multiple of 8"),
    ((2, 2, 81, 192, 128), torch.bfloat16, "L <= 80"),
])
def test_the_wrappers_still_refuse_what_the_kernels_do_not_take(monkeypatch, shape, dtype, error):
    monkeypatch.setattr(attention, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(attention._build, "load", lambda name: pytest.fail("kernel was loaded"))
    b, h, l = shape[:3]
    q = torch.zeros(b, h, l, shape[3], dtype=dtype)
    v = torch.zeros(b, h, l, shape[-1], dtype=dtype)
    with pytest.raises(ValueError, match=error):
        masked_mha(q, q.clone(), v, torch.zeros(b, l, dtype=torch.bool))


# --------------------------------------------------------------- card --
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.init()
    return torch.device("cuda")


def _close(got, want):
    return bool(((got.float() - want.float()).abs()
                 <= 2.0 ** -7 * want.float().abs().clamp_min(1.0)).all())


@pytest.mark.card
def test_the_vit_attention_kernel_matches_its_plain_version(card):
    """MoonViT's attention on the bfloat16 tile route, (64, 16, 256, 72),
    not causal, against mha_reference."""
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(64, 16, 256, 72, generator=gen, device=card).to(torch.bfloat16)
               for _ in range(3))
    pad = torch.zeros(64, 256, dtype=torch.bool, device=card)
    assert _close(masked_mha(q, k, v, pad), attention.mha_reference(q, k, v, pad))


@pytest.mark.card
def test_the_split_kernel_at_l80_matches_its_plain_version(card):
    """The joint decoder's MLA, (256, 16, 80, 192 / 128), causal with the
    title's tail padded, bfloat16 and float32."""
    b, h, l, dqk, dv = 256, 16, 80, 192, 128
    gen = torch.Generator(device=card).manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        q, k = (torch.randn(b, h, l, dqk, generator=gen, device=card).to(dtype) for _ in range(2))
        v = torch.randn(b, h, l, dv, generator=gen, device=card).to(dtype)
        lengths = torch.randint(68, l + 1, (b, 1), generator=gen, device=card)
        pad = torch.arange(l, device=card)[None, :] >= lengths
        got = masked_mha(q, k, v, pad, causal=True, scale=192 ** -0.5)
        want = attention.mha_reference(q, k, v, pad, True, 192 ** -0.5)
        if dtype == torch.bfloat16:
            assert _close(got, want)
        else:
            assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.card
def test_the_sigmoid_router_on_the_card_matches_the_cpu(card):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4096, 2048, generator=gen).to(torch.bfloat16)
    weight = (torch.randn(64, 2048, generator=gen) * 0.02).to(torch.bfloat16)
    bias = torch.randn(64, generator=gen) * 0.05
    w, idx = moe.route_sigmoid(x.to(card), weight.to(card), bias.to(card), 6, 2.446)
    w0, idx0 = moe.route_sigmoid(x, weight, bias, 6, 2.446)
    same = (idx.cpu() == idx0).all(dim=-1)
    assert float(same.float().mean()) > 0.99
    np.testing.assert_allclose(w.cpu()[same].numpy(), w0[same].numpy(), rtol=1e-5, atol=1e-6)
