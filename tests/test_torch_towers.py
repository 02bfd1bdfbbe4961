"""The PyTorch port's frozen towers against the JAX package's.

The CLIP and SigLIP vision and text towers at tiny sizes, float32 compute on
both sides, weights carried over from the JAX trees by
``item_encoder_state_dict_from_jax``, the same numpy inputs, at 1e-4. The
``"block"`` attention route is held against the JAX package run with
``OUTFITX_TOWER_ATTN=block`` (its kernel in interpret mode), the ``"fused"``
MLP route against ``OUTFITX_TOWER_MLP=pallas``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.core.config import ItemEncoderConfig as JaxItemEncoderConfig
from outfitx_tpu.models.item_encoder import ItemEncoderModel as JaxItemEncoder
from outfitx_tpu.models.towers import TextTowerConfig as JaxTextCfg
from outfitx_tpu.models.towers import VisionTowerConfig as JaxVisionCfg
from outfitx_tpu_torch.core.config import ItemEncoderConfig
from outfitx_tpu_torch.models.from_jax import item_encoder_state_dict_from_jax
from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
from outfitx_tpu_torch.models.towers import (
    TextTowerConfig,
    TowerEncoder,
    VisionTowerConfig,
)
from outfitx_tpu_torch.models.towers import common as towers_common

torch.set_num_threads(1)

TOL = 1e-4

VISION = dict(
    image_size=32, patch_size=16, d_model=64, n_heads=4, d_mlp=96, n_layers=2,
    proj_dim=48, compute_dtype="float32",
)
TEXT = dict(
    vocab_size=500, max_len=16, d_model=64, n_heads=4, d_mlp=96, n_layers=2,
    proj_dim=48, eos_token_id=499, compute_dtype="float32",
)
SIGLIP = dict(variant="siglip", act="gelu_tanh", ln_eps=1e-6)


def tower_kwargs(variant, text_len=16):
    """(encoder_type, dim_per_modality, vision kwargs, text kwargs)."""
    if variant == "clip":
        return "clip", 48, dict(VISION), dict(TEXT, max_len=text_len)
    # SigLIP has no output projection: d_out == d_model.
    return (
        "siglip", 64, dict(VISION, **SIGLIP),
        dict(TEXT, **SIGLIP, proj_dim=64, eos_token_id=1, max_len=text_len),
    )


def make_pair(variant, *, text_len=16, attn="mha", mlp="plain", seed=0):
    """The JAX encoder with its parameters (numpy) and the port's encoder
    carrying the same weights."""
    enc_type, dim, vkw, tkw = tower_kwargs(variant, text_len)
    jenc = JaxItemEncoder(
        JaxItemEncoderConfig(encoder_type=enc_type, dim_per_modality=dim),
        vision_cfg=JaxVisionCfg(**vkw), text_cfg=JaxTextCfg(**tkw),
    )
    params = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(seed)))
    tenc = ItemEncoderModel(
        ItemEncoderConfig(encoder_type=enc_type, dim_per_modality=dim),
        vision_cfg=VisionTowerConfig(**vkw), text_cfg=TextTowerConfig(**tkw),
        device="cpu", attn=attn, mlp=mlp,
    )
    tenc.load_state_dict(item_encoder_state_dict_from_jax(params), strict=True)
    return jenc, params, tenc


def text_inputs(variant, b, t, seed=0):
    """Token ids with an EOS at a different place in every row and the
    padding behind it masked."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 400, (b, t)).astype(np.int32)
    mask = np.ones((b, t), dtype=np.int32)
    eos = 499 if variant == "clip" else 1
    for i in range(b):
        end = int(rng.integers(2, t))
        ids[i, end] = eos
        ids[i, end + 1:] = 0
        mask[i, end + 1:] = 0
    return ids, mask


@pytest.mark.parametrize("variant", ["clip", "siglip"])
def test_vision_tower_matches_jax(variant):
    jenc, params, tenc = make_pair(variant)
    x = np.random.default_rng(1).standard_normal((3, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jenc.vision(params["vision"], jnp.asarray(x)))
    with torch.no_grad():
        got = tenc.vision(torch.from_numpy(x))
    assert tuple(got.shape) == (3, jenc.vision.cfg.d_out)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_patchify_keeps_the_channel_first_patch_order():
    jenc, _, tenc = make_pair("clip")
    x = np.arange(2 * 3 * 32 * 32, dtype=np.float32).reshape(2, 3, 32, 32)
    want = np.asarray(jenc.vision.patchify(jnp.asarray(x)))
    got = tenc.vision.patchify(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("variant", ["clip", "siglip"])
def test_text_tower_matches_jax(variant, masked):
    """CLIP: causal, pooled at each row's EOS; SigLIP: pooled at the last
    token, which is a padded position when the mask is given."""
    jenc, params, tenc = make_pair(variant)
    ids, mask = text_inputs(variant, 4, 16, seed=2)
    jmask = jnp.asarray(mask) if masked else None
    want = np.asarray(jenc.text(params["text"], jnp.asarray(ids), jmask))
    with torch.no_grad():
        got = tenc.text(
            torch.from_numpy(ids), torch.from_numpy(mask) if masked else None
        )
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def _spy_routes(monkeypatch):
    """Count the calls the encoder makes to the two attention functions."""
    calls = {"attn_block": 0, "masked_mha": 0, "mlp_fused": 0}
    for name in calls:
        real = getattr(towers_common, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(towers_common, name, spy)
    return calls


@pytest.mark.parametrize(
    "variant, text_len, through_block",
    [
        ("siglip", 64, True),  # the SigLIP text tower's length
        ("siglip", 40, True),
        ("siglip", 16, False),  # L <= 32 falls through to masked_mha
        ("siglip", 44, False),  # not a multiple of 8
        ("clip", 64, False),  # causal
    ],
)
def test_block_route_matches_jax_and_keeps_its_shape_guard(
    monkeypatch, variant, text_len, through_block
):
    monkeypatch.setenv("OUTFITX_TOWER_ATTN", "block")
    jenc, params, tenc = make_pair(variant, text_len=text_len, attn="block")
    ids, mask = text_inputs(variant, 3, text_len, seed=3)
    want = np.asarray(jenc.text(params["text"], jnp.asarray(ids), jnp.asarray(mask)))
    calls = _spy_routes(monkeypatch)
    with torch.no_grad():
        got = tenc.text(torch.from_numpy(ids), torch.from_numpy(mask))
    n_layers = tenc.text.cfg.n_layers
    assert calls["attn_block"] == (n_layers if through_block else 0)
    assert calls["masked_mha"] == (0 if through_block else n_layers)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # The route changes the formulation, not the function.
    _, _, plain = make_pair(variant, text_len=text_len, attn="mha")
    with torch.no_grad():
        ref = plain.text(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=TOL)


def test_block_route_leaves_the_vision_tower_on_masked_mha(monkeypatch):
    """ViT-B/32-like: 4 patches + class token, outside the block's guard."""
    monkeypatch.setenv("OUTFITX_TOWER_ATTN", "block")
    jenc, params, tenc = make_pair("clip", attn="block")
    x = np.random.default_rng(4).standard_normal((2, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jenc.vision(params["vision"], jnp.asarray(x)))
    calls = _spy_routes(monkeypatch)
    with torch.no_grad():
        got = tenc.vision(torch.from_numpy(x))
    assert calls["attn_block"] == 0 and calls["masked_mha"] == 2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("variant", ["clip", "siglip"])
def test_fused_mlp_route_matches_jax(monkeypatch, variant):
    monkeypatch.setenv("OUTFITX_TOWER_MLP", "pallas")
    jenc, params, tenc = make_pair(variant, mlp="fused")
    ids, mask = text_inputs(variant, 3, 16, seed=5)
    x = np.random.default_rng(5).standard_normal((3, 3, 32, 32)).astype(np.float32)
    want_t = np.asarray(jenc.text(params["text"], jnp.asarray(ids), jnp.asarray(mask)))
    want_v = np.asarray(jenc.vision(params["vision"], jnp.asarray(x)))
    calls = _spy_routes(monkeypatch)
    with torch.no_grad():
        got_t = tenc.text(torch.from_numpy(ids), torch.from_numpy(mask))
        got_v = tenc.vision(torch.from_numpy(x))
    assert calls["mlp_fused"] == 4  # two layers in each tower
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0, atol=TOL)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=TOL)


def test_fused_layouts_follow_a_loaded_state_dict():
    """The stacked layouts are kept per dtype and device, and rebuilt after
    a state dict is loaded."""
    _, _, a = make_pair("siglip", text_len=64, attn="block", mlp="fused", seed=0)
    _, _, b = make_pair("siglip", text_len=64, attn="block", mlp="fused", seed=1)
    ids, mask = (torch.from_numpy(t) for t in text_inputs("siglip", 2, 64, seed=6))
    with torch.no_grad():
        first = a.text(ids, mask)
        kept = a.text.encoder._fused[("block", torch.float32, torch.device("cpu"))]
        a.text(ids, mask)
        assert a.text.encoder._fused[("block", torch.float32, torch.device("cpu"))] is kept
        a.load_state_dict(b.state_dict())
        assert a.text.encoder._fused == {}
        second = a.text(ids, mask)
        want = b.text(ids, mask)
    assert not torch.allclose(first, second, atol=1e-3)
    np.testing.assert_allclose(second.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_bridge_covers_every_parameter_and_transposes_linears():
    _, params, tenc = make_pair("siglip")
    sd = item_encoder_state_dict_from_jax(params)
    assert sorted(sd) == sorted(tenc.state_dict())
    w = params["text"]["layers"]["mlp"]["fc1"]["w"]  # (n_layers, d_in, d_out)
    np.testing.assert_array_equal(
        sd["text.encoder.layers.1.fc1.weight"].numpy(), w[1].T
    )
    assert all(not p.requires_grad for p in tenc.parameters())


def test_bfloat16_towers_stay_close_to_float32():
    """The default compute dtype: bfloat16 activations, float32 LayerNorm
    and softmax inside, against the float32 towers on the same weights."""
    _, params, f32 = make_pair("siglip", text_len=64)
    enc_type, dim, vkw, tkw = tower_kwargs("siglip", 64)
    bf16 = ItemEncoderModel(
        ItemEncoderConfig(encoder_type=enc_type, dim_per_modality=dim),
        vision_cfg=VisionTowerConfig(**dict(vkw, compute_dtype="bfloat16")),
        text_cfg=TextTowerConfig(**dict(tkw, compute_dtype="bfloat16")),
        device="cpu", attn="block", mlp="fused",
    )
    bf16.load_state_dict(f32.state_dict())
    ids, mask = (torch.from_numpy(t) for t in text_inputs("siglip", 3, 64, seed=7))
    imgs = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (3, 3, 32, 32), dtype=np.uint8)
    )
    want = f32.encode(imgs, ids, mask)
    got = bf16.encode(imgs, ids, mask)
    assert got.dtype == torch.float32
    for half in (slice(0, 64), slice(64, 128)):
        cos = torch.nn.functional.cosine_similarity(got[:, half], want[:, half], dim=-1)
        assert float(cos.min()) > 0.999


@pytest.mark.parametrize(
    "kwargs", [dict(attn="flash"), dict(mlp="pallas"), dict(act="swish")]
)
def test_unknown_routes_raise(kwargs):
    base = dict(d=64, n_heads=4, d_mlp=96, n_layers=1, act="gelu")
    with pytest.raises(ValueError):
        TowerEncoder(**{**base, **kwargs})


def test_configs_match_the_jax_presets():
    for mine, theirs in (
        (VisionTowerConfig.clip_b32(), JaxVisionCfg.clip_b32()),
        (VisionTowerConfig.siglip_b16(), JaxVisionCfg.siglip_b16()),
        (TextTowerConfig.clip_b(), JaxTextCfg.clip_b()),
        (TextTowerConfig.siglip_b(), JaxTextCfg.siglip_b()),
    ):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.d_out == theirs.d_out
    assert VisionTowerConfig.siglip_b16().seq_len == 196
    assert VisionTowerConfig.clip_b32().seq_len == 50
