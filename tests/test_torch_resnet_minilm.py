"""The PyTorch port's resnet_sbert towers (ResNet-18 and MiniLM) and item
encoder against the JAX package's.

Tiny towers in float32 on both sides, weights carried over from the JAX
trees by ``item_encoder_state_dict_from_jax``, the same numpy inputs. The
forwards agree to 1e-4 (float32, other summation orders of the
convolutions and products); the converters are exact (they only rename,
transpose and widen).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.core.config import ItemEncoderConfig as JaxItemEncoderConfig
from outfitx_tpu.core.config import PrecomputeConfig as JaxPrecomputeConfig
from outfitx_tpu.core.config import OutfitXConfig as JaxOutfitXConfig
from outfitx_tpu.models.item_encoder import ItemEncoderModel as JaxItemEncoder
from outfitx_tpu.models.towers.minilm import MiniLMConfig as JaxMiniLMConfig
from outfitx_tpu.models.towers.minilm import convert_minilm as jax_convert_minilm
from outfitx_tpu.models.towers.resnet import ResNet18Config as JaxResNetConfig
from outfitx_tpu.models.towers.resnet import convert_resnet18 as jax_convert_resnet18
from outfitx_tpu.train.precompute import PrecomputeRunner as JaxPrecomputeRunner
from outfitx_tpu.utils import aggregate_embeddings as jax_aggregate
from outfitx_tpu.utils import mean_pooling as jax_mean_pooling
from outfitx_tpu_torch.core.config import ItemEncoderConfig, OutfitXConfig, PrecomputeConfig
from outfitx_tpu_torch.models.from_jax import item_encoder_state_dict_from_jax
from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel, tower_configs
from outfitx_tpu_torch.models.towers.minilm import MiniLM, MiniLMConfig, convert_minilm
from outfitx_tpu_torch.models.towers.resnet import (
    ResNet18,
    ResNet18Config,
    convert_resnet18,
)
from outfitx_tpu_torch.ops.attention import masked_mha
from outfitx_tpu_torch.ops.layernorm import layer_norm
from outfitx_tpu_torch.train.precompute import PrecomputeRunner
from outfitx_tpu_torch.utils import aggregate_embeddings, mean_pooling

torch.set_num_threads(1)

TOL = 1e-4
DIM = 8
# ResNet-18 at small stage widths (the stem stays at 64 channels, as in the
# JAX tower) and a 32 x 32 image; MiniLM at 2 layers of width 48.
RESNET = dict(d_out=DIM, image_size=32, stage_channels=(64, 16, 16, 32),
              compute_dtype="float32")
MINILM = dict(vocab_size=300, max_len=32, d_model=48, n_heads=4, d_mlp=96,
              n_layers=2, d_out=DIM, compute_dtype="float32")


def make_pair(seed=0, aggregation="concat"):
    """The JAX resnet_sbert encoder with its parameters (numpy) and the
    port's encoder carrying the same weights."""
    cfg_kw = dict(encoder_type="resnet_sbert", dim_per_modality=DIM, aggregation=aggregation)
    jenc = JaxItemEncoder(
        JaxItemEncoderConfig(**cfg_kw),
        vision_cfg=JaxResNetConfig(**RESNET), text_cfg=JaxMiniLMConfig(**MINILM),
    )
    params = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(seed)))
    tenc = ItemEncoderModel(
        ItemEncoderConfig(**cfg_kw),
        vision_cfg=ResNet18Config(**RESNET), text_cfg=MiniLMConfig(**MINILM),
        device="cpu",
    )
    tenc.load_state_dict(item_encoder_state_dict_from_jax(params), strict=True)
    return jenc, params, tenc


def randomize_bn(params, seed):
    """Running statistics and affine maps away from the identity, so the
    folded BatchNorm is really tested."""
    rng = np.random.default_rng(seed)

    def visit(tree):
        if isinstance(tree, dict) and "var" in tree:
            c = tree["var"].shape
            tree["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            tree["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
            tree["mean"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
            tree["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        elif isinstance(tree, dict):
            for v in tree.values():
                visit(v)
        elif isinstance(tree, list):
            for v in tree:
                visit(v)

    visit(params["vision"]["backbone"])
    return params


def text_inputs(b=4, t=24, seed=0):
    """Token ids and an attention mask with padded rows of several lengths
    (one row unpadded)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 290, (b, t)).astype(np.int32)
    mask = np.ones((b, t), dtype=np.int32)
    for i in range(1, b):
        mask[i, int(rng.integers(1, t)):] = 0
    return ids, mask


def test_resnet18_matches_jax():
    jenc, params, tenc = make_pair()
    params = randomize_bn(params, 1)
    tenc.load_state_dict(item_encoder_state_dict_from_jax(params))
    x = np.random.default_rng(2).standard_normal((3, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jenc.vision(params["vision"], jnp.asarray(x)))
    with torch.no_grad():
        got = tenc.vision(torch.from_numpy(x))
    assert tuple(got.shape) == (3, DIM) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_minilm_matches_jax_with_pad_tokens():
    jenc, params, tenc = make_pair(seed=3)
    ids, mask = text_inputs(seed=4)
    want = np.asarray(jenc.text(params["text"], jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tenc.text(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # The pad positions' tokens do not reach the pooled embedding.
    ids2 = ids.copy()
    ids2[mask == 0] = 7
    with torch.no_grad():
        again = tenc.text(torch.from_numpy(ids2), torch.from_numpy(mask))
    np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=0, atol=1e-5)


def test_minilm_launches_one_attention_and_two_layernorms_a_layer(monkeypatch):
    """The counts chip_smoke.py holds exactly on the card: n_layers
    attention calls and 2 n_layers + 1 LayerNorms a pass."""
    from outfitx_tpu_torch.models.towers import common, minilm

    calls = {"mha": 0, "ln": 0}

    def spy(name, real):
        def f(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return f

    monkeypatch.setattr(minilm, "masked_mha", spy("mha", masked_mha))
    monkeypatch.setattr(common, "layer_norm", spy("ln", layer_norm))
    _, _, tenc = make_pair()
    ids, mask = text_inputs()
    with torch.no_grad():
        tenc.text(torch.from_numpy(ids), torch.from_numpy(mask))
    n = MINILM["n_layers"]
    assert calls == {"mha": n, "ln": 2 * n + 1}


@pytest.mark.parametrize("aggregation", ["concat", "mean", "sum"])
def test_encode_matches_jax(aggregation):
    jenc, params, tenc = make_pair(seed=5, aggregation=aggregation)
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 256, (3, 3, 32, 32), dtype=np.uint8)
    ids, mask = text_inputs(b=3, seed=7)
    want = np.asarray(jenc.encode(params, *(jnp.asarray(a) for a in (imgs, ids, mask))))
    with torch.no_grad():
        got = tenc.encode(*(torch.from_numpy(a) for a in (imgs, ids, mask)))
    assert got.dtype == torch.float32 and got.shape[1] == tenc.cfg.d_embed
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_encode_texts_without_a_mask_takes_every_token():
    jenc, params, tenc = make_pair(seed=8)
    ids, _ = text_inputs(b=2, seed=9)
    want = np.asarray(jenc.encode_texts(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = tenc.encode_texts(torch.from_numpy(ids))
        ones = tenc.encode_texts(torch.from_numpy(ids), torch.ones_like(torch.from_numpy(ids)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.numpy(), ones.numpy())


def test_only_the_fresh_heads_get_gradients():
    _, _, tenc = make_pair(seed=10)
    trainable = sorted(n for n, p in tenc.named_parameters() if p.requires_grad)
    assert trainable == ["text.proj.bias", "text.proj.weight", "vision.fc.bias", "vision.fc.weight"]
    rng = np.random.default_rng(11)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 3, 32, 32), dtype=np.uint8))
    ids, mask = (torch.from_numpy(a) for a in text_inputs(b=2, seed=12))
    tenc.encode(imgs, ids, mask).pow(2).sum().backward()
    for name, p in tenc.named_parameters():
        if p.requires_grad:
            assert p.grad is not None and float(p.grad.abs().sum()) > 0, name
        else:
            assert p.grad is None, name


def test_tower_configs_and_width_check():
    vc, tc = tower_configs(ItemEncoderConfig.for_type("resnet_sbert"))
    assert (vc.d_out, tc.d_out) == (64, 64)
    assert dataclasses.asdict(vc) == dataclasses.asdict(JaxResNetConfig(d_out=64))
    assert dataclasses.asdict(tc) == dataclasses.asdict(JaxMiniLMConfig(d_out=64))
    with pytest.raises(ValueError, match="d_out=8 != dim_per_modality=16"):
        ItemEncoderModel(
            ItemEncoderConfig(encoder_type="resnet_sbert", dim_per_modality=16),
            vision_cfg=ResNet18Config(**RESNET), text_cfg=MiniLMConfig(**MINILM),
            device="cpu",
        )
    with pytest.raises(ValueError, match="route"):
        ItemEncoderModel(
            ItemEncoderConfig(encoder_type="resnet_sbert", dim_per_modality=DIM),
            vision_cfg=ResNet18Config(**RESNET), text_cfg=MiniLMConfig(**MINILM),
            device="cpu", attn="flash",
        )


def _torchvision_state_dict(rng, fc_out):
    """A random state dict with torchvision resnet18's names and shapes at
    RESNET's widths, num_batches_tracked included."""
    sd = {"conv1.weight": rng.standard_normal((64, 3, 7, 7))}

    def bn(prefix, c):
        sd[prefix + ".weight"] = rng.uniform(0.5, 1.5, c)
        sd[prefix + ".bias"] = rng.uniform(-0.2, 0.2, c)
        sd[prefix + ".running_mean"] = rng.uniform(-0.5, 0.5, c)
        sd[prefix + ".running_var"] = rng.uniform(0.5, 1.5, c)
        sd[prefix + ".num_batches_tracked"] = np.asarray(7)

    bn("bn1", 64)
    cin = 64
    for si, c in enumerate(RESNET["stage_channels"]):
        for bi in range(2):
            p = f"layer{si + 1}.{bi}"
            sd[p + ".conv1.weight"] = rng.standard_normal((c, cin if bi == 0 else c, 3, 3))
            bn(p + ".bn1", c)
            sd[p + ".conv2.weight"] = rng.standard_normal((c, c, 3, 3))
            bn(p + ".bn2", c)
            if bi == 0 and si > 0:
                sd[p + ".downsample.0.weight"] = rng.standard_normal((c, cin, 1, 1))
                bn(p + ".downsample.1", c)
        cin = c
    sd["fc.weight"] = rng.standard_normal((fc_out, cin))
    sd["fc.bias"] = rng.standard_normal(fc_out)
    return {k: np.asarray(v, dtype=np.float32 if v.ndim else np.int64) for k, v in sd.items()}


@pytest.mark.parametrize("fc_out", [DIM, 1000], ids=["fc_kept", "fresh_fc"])
def test_convert_resnet18_matches_jax(fc_out):
    sd = _torchvision_state_dict(np.random.default_rng(13), fc_out)
    want_tree = jax_convert_resnet18(sd, d_out=DIM)
    assert ("fc" in want_tree) == (fc_out == DIM)
    fresh = {"weight": np.full((DIM, 32), 0.5, np.float32), "bias": np.zeros(DIM, np.float32)}
    got = convert_resnet18(sd, d_out=DIM, init_fc=fresh)
    want_tree = {
        "backbone": want_tree["backbone"],
        "fc": want_tree.get("fc", {"w": fresh["weight"].T, "b": fresh["bias"]}),
    }
    want = {
        k[len("vision."):]: v
        for k, v in item_encoder_state_dict_from_jax(
            {"vision": want_tree, "text": _jax_minilm_tree()}
        ).items() if k.startswith("vision.")
    }
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    model = ResNet18(ResNet18Config(**RESNET))
    model.load_state_dict(got, strict=True)
    assert "fc.weight" not in convert_resnet18(sd, d_out=DIM + 1)


def _hf_bert_state_dict(rng, n_layers=2):
    d, m = MINILM["d_model"], MINILM["d_mlp"]
    sd = {
        "embeddings.word_embeddings.weight": (MINILM["vocab_size"], d),
        "embeddings.position_embeddings.weight": (MINILM["max_len"], d),
        "embeddings.token_type_embeddings.weight": (2, d),
        "embeddings.LayerNorm.weight": (d,), "embeddings.LayerNorm.bias": (d,),
    }
    for i in range(n_layers):
        p = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = (d, d), (d,)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = (d,), (d,)
        sd[p + "intermediate.dense.weight"], sd[p + "intermediate.dense.bias"] = (m, d), (m,)
        sd[p + "output.dense.weight"], sd[p + "output.dense.bias"] = (d, m), (d,)
    sd["pooler.dense.weight"] = (d, d)  # HF's pooler: not part of the tower
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in sd.items()}


def _jax_minilm_tree():
    sd = _hf_bert_state_dict(np.random.default_rng(14))
    proj = {"w": np.ones((MINILM["d_model"], DIM), np.float32), "b": np.zeros(DIM, np.float32)}
    return {"backbone": jax_convert_minilm(sd, n_layers=2), "proj": proj}


def test_convert_minilm_matches_jax():
    sd = _hf_bert_state_dict(np.random.default_rng(14))
    want_tree = _jax_minilm_tree()
    proj = {"weight": want_tree["proj"]["w"].T, "bias": want_tree["proj"]["b"]}
    got = convert_minilm(sd, n_layers=2, init_proj=proj)
    resnet = jax_convert_resnet18(_torchvision_state_dict(np.random.default_rng(15), DIM), DIM)
    want = {
        k[len("text."):]: v
        for k, v in item_encoder_state_dict_from_jax(
            {"vision": resnet, "text": want_tree}
        ).items() if k.startswith("text.")
    }
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    MiniLM(MiniLMConfig(**MINILM)).load_state_dict(got, strict=True)
    assert "proj.weight" not in convert_minilm(sd, n_layers=2)


def test_utils_match_jax():
    rng = np.random.default_rng(16)
    states = rng.standard_normal((3, 5, 4)).astype(np.float32)
    mask = np.asarray([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], np.int32)
    np.testing.assert_allclose(
        mean_pooling(torch.from_numpy(states), torch.from_numpy(mask)).numpy(),
        np.asarray(jax_mean_pooling(jnp.asarray(states), jnp.asarray(mask))),
        rtol=0, atol=1e-6,
    )
    a, b = rng.standard_normal((2, 3, 4)).astype(np.float32)
    for method in ("concat", "mean", "sum"):
        np.testing.assert_allclose(
            aggregate_embeddings(torch.from_numpy(a), torch.from_numpy(b), method).numpy(),
            np.asarray(jax_aggregate(jnp.asarray(a), jnp.asarray(b), method)),
            rtol=0, atol=1e-7,
        )
    with pytest.raises(ValueError):
        aggregate_embeddings(torch.from_numpy(a), torch.from_numpy(b), "max")


def test_precompute_shards_match_the_jax_runner(tmp_path, monkeypatch):
    """Both runners sweep 11 synthetic items (a full batch of 8 and a
    trailing 3) with the same resnet_sbert weights."""
    import pickle

    monkeypatch.setenv("OUTFITX_TOWER_ATTN", "block")  # the JAX runner sets it
    jenc, params, tenc = make_pair(seed=17)
    jcfg = JaxPrecomputeConfig(batch_size=8, dataset_dir=str(tmp_path))
    JaxPrecomputeRunner(
        jcfg, JaxOutfitXConfig(item_encoder=dataclasses.replace(jenc.cfg, text_model_name="")),
        output_dir=str(tmp_path / "jax"), params=params, synthetic_items=11, encoder=jenc,
    ).run()
    cfg = PrecomputeConfig(batch_size=8, dataset_dir=str(tmp_path))
    model_cfg = OutfitXConfig(item_encoder=dataclasses.replace(tenc.cfg, text_model_name=""))
    result = PrecomputeRunner(
        cfg, model_cfg, output_dir=str(tmp_path / "port"), synthetic_items=11,
        encoder=tenc, device="cpu",
    ).run()
    assert (result["items"], result["shards"]) == (11, 1)
    name = f"{model_cfg.model_name}_embedding_subset_0.pkl"
    with open(tmp_path / "jax" / name, "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port" / name, "rb") as f:
        got = pickle.load(f)
    assert got["ids"] == want["ids"] == [10_000 + i for i in range(11)]
    assert got["embeddings"].dtype == np.float32 and got["embeddings"].shape == (11, 2 * DIM)
    np.testing.assert_allclose(got["embeddings"], np.asarray(want["embeddings"]), rtol=0, atol=TOL)
