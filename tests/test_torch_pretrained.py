"""Pretrained tower loading in the PyTorch port against the JAX package's
``load_item_encoder_params``.

The tests write tiny HF checkpoints themselves (random weights, nothing is
downloaded): CLIP as ``vision/`` + ``text/`` directories, SigLIP as one
directory holding both towers, resnet_sbert as a torchvision ResNet and an
HF BertModel saved with the ``bert.`` prefix; each in ``model.safetensors``
and in ``pytorch_model.bin``. The port and the JAX package load the same
files and their float32 forwards agree to 1e-4. The port's own safetensors
reader is held bit for bit against the ``safetensors`` package, which only
the tests import.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.core.config import ItemEncoderConfig as JaxItemEncoderConfig
from outfitx_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from outfitx_tpu.models.item_encoder import ItemEncoderModel as JaxItemEncoder
from outfitx_tpu.models.pretrained import load_item_encoder_params
from outfitx_tpu.models.towers import TextTowerConfig as JaxTextCfg
from outfitx_tpu.models.towers import VisionTowerConfig as JaxVisionCfg
from outfitx_tpu.models.towers.minilm import MiniLMConfig as JaxMiniLMConfig
from outfitx_tpu.models.towers.resnet import ResNet18Config as JaxResNetConfig
from outfitx_tpu_torch.core.config import ItemEncoderConfig
from outfitx_tpu_torch.data.tokenizer import HashTokenizer, load_tokenizer
from outfitx_tpu_torch.models.from_jax import item_encoder_state_dict_from_jax
from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
from outfitx_tpu_torch.models.pretrained import (
    load_item_encoder_state_dict,
    read_safetensors,
)
from outfitx_tpu_torch.models.towers import TextTowerConfig, VisionTowerConfig
from outfitx_tpu_torch.models.towers.minilm import MiniLMConfig
from outfitx_tpu_torch.models.towers.resnet import ResNet18, ResNet18Config

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

torch.set_num_threads(1)

TOL = 1e-4
FORMATS = ["safetensors", "bin"]

CLIP_V = dict(variant="clip", image_size=32, patch_size=16, d_model=64, n_heads=4,
              d_mlp=96, n_layers=2, proj_dim=40, compute_dtype="float32")
CLIP_T = dict(variant="clip", vocab_size=300, max_len=16, d_model=64, n_heads=4,
              d_mlp=96, n_layers=2, proj_dim=40, eos_token_id=299, compute_dtype="float32")
SIGLIP_V = dict(variant="siglip", image_size=32, patch_size=16, d_model=64, n_heads=4,
                d_mlp=128, n_layers=2, act="gelu_tanh", ln_eps=1e-6, compute_dtype="float32")
SIGLIP_T = dict(variant="siglip", vocab_size=300, max_len=16, d_model=64, n_heads=4,
                d_mlp=128, n_layers=2, proj_dim=64, act="gelu_tanh", ln_eps=1e-6,
                eos_token_id=1, compute_dtype="float32")
RESNET = dict(d_out=8, image_size=32, stage_channels=(64, 16, 16, 32), compute_dtype="float32")
MINILM = dict(vocab_size=300, max_len=32, d_model=48, n_heads=4, d_mlp=96, n_layers=2,
              d_out=8, compute_dtype="float32")


def _save(sd, directory, fmt):
    directory.mkdir(parents=True, exist_ok=True)
    sd = {k: v.detach().contiguous() for k, v in sd.items()}
    if fmt == "safetensors":
        safetensors_torch.save_file(sd, str(directory / "model.safetensors"))
    else:
        torch.save(sd, directory / "pytorch_model.bin")


@pytest.fixture(scope="module")
def hf_towers():
    """Tiny HF tower state dicts with random weights: CLIP and SigLIP, a
    torchvision-named ResNet-18 and an HF BertModel."""
    torch.manual_seed(0)
    t = transformers
    clip_v = t.CLIPVisionModelWithProjection(t.CLIPVisionConfig(
        hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
        image_size=32, patch_size=16, projection_dim=40)).state_dict()
    clip_t = t.CLIPTextModelWithProjection(t.CLIPTextConfig(
        vocab_size=300, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=16, projection_dim=40,
        eos_token_id=299)).state_dict()
    siglip_v = t.SiglipVisionModel(t.SiglipVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        image_size=32, patch_size=16)).state_dict()
    siglip_t = t.SiglipTextModel(t.SiglipTextConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=16)).state_dict()
    bert = t.BertModel(t.BertConfig(
        vocab_size=300, hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=96, max_position_embeddings=32)).state_dict()
    resnet = ResNet18(ResNet18Config(**dict(RESNET, d_out=1000)))
    resnet.init_weights_(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    resnet_sd = resnet.state_dict()
    for k, v in resnet_sd.items():  # BatchNorm away from the identity
        if k.endswith(("running_mean", "bn1.bias", "bn2.bias")):
            v.uniform_(-0.3, 0.3, generator=gen)
        elif k.endswith("running_var"):
            v.uniform_(0.5, 1.5, generator=gen)
    resnet_sd.update({
        k.replace("running_var", "num_batches_tracked"): torch.tensor(5)
        for k in resnet_sd if k.endswith("running_var")
    })
    return {"clip": (clip_v, clip_t), "siglip": (siglip_v, siglip_t),
            "resnet_sbert": (resnet_sd, {"bert." + k: v for k, v in bert.items()})}


def write_checkpoint(hf_towers, family, fmt, root):
    """CLIP and resnet_sbert as vision/ + text/, SigLIP as one directory."""
    vis, txt = hf_towers[family]
    if family == "siglip":
        _save({**vis, **txt}, root, fmt)
    else:
        _save(vis, root / "vision", fmt)
        _save(txt, root / "text", fmt)
    return root


def encoders(family):
    """The JAX encoder with its random init and the port's encoder, float32,
    unnormalised outputs."""
    kw = dict(encoder_type=family, normalize_out=False,
              dim_per_modality={"clip": 40, "siglip": 64, "resnet_sbert": 8}[family])
    if family == "resnet_sbert":
        jv, jt, pv, pt = (JaxResNetConfig(**RESNET), JaxMiniLMConfig(**MINILM),
                          ResNet18Config(**RESNET), MiniLMConfig(**MINILM))
    else:
        v, t = (CLIP_V, CLIP_T) if family == "clip" else (SIGLIP_V, SIGLIP_T)
        jv, jt, pv, pt = JaxVisionCfg(**v), JaxTextCfg(**t), VisionTowerConfig(**v), TextTowerConfig(**t)
    jenc = JaxItemEncoder(JaxItemEncoderConfig(**kw), vision_cfg=jv, text_cfg=jt)
    tenc = ItemEncoderModel(ItemEncoderConfig(**kw), vision_cfg=pv, text_cfg=pt, device="cpu")
    return jenc, tenc


def inputs(family, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (3, 3, 32, 32), dtype=np.uint8)
    t = 24 if family == "resnet_sbert" else 16
    ids = rng.integers(2, 290, (3, t)).astype(np.int32)
    mask = np.ones((3, t), dtype=np.int32)
    mask[1, 10:] = 0
    ids[:, -1] = 299 if family == "clip" else 1
    return imgs, ids, mask


def jax_resnet_sbert_params(root, init):
    """The JAX package's resnet_sbert branch of ``load_item_encoder_params``
    step by step, from its own reader and converters: the function itself
    reads ``encoder.vision.cfg.n_layers``, which ``ResNet18Config`` lacks,
    and raises AttributeError for this encoder type
    (``outfitx_tpu/models/pretrained.py:75``)."""
    from outfitx_tpu.models.pretrained import _load_state_dict, _strip_prefix
    from outfitx_tpu.models.towers.minilm import convert_minilm
    from outfitx_tpu.models.towers.resnet import convert_resnet18

    converted = convert_resnet18(_load_state_dict(root / "vision"), d_out=RESNET["d_out"])
    text_sd = _strip_prefix(_load_state_dict(root / "text"), "bert.")
    return {
        "vision": {"backbone": converted["backbone"],
                   "fc": converted.get("fc", init["vision"]["fc"])},
        "text": {"backbone": convert_minilm(text_sd, n_layers=MINILM["n_layers"]),
                 "proj": init["text"]["proj"]},
    }


def test_jax_loader_fails_on_resnet_sbert(hf_towers, tmp_path):
    """Recorded, not repaired (the JAX package is the reference and stays as
    it is): why the test above rebuilds its resnet_sbert branch."""
    root = write_checkpoint(hf_towers, "resnet_sbert", "safetensors", tmp_path)
    jenc, _ = encoders("resnet_sbert")
    with pytest.raises(AttributeError, match="n_layers"):
        load_item_encoder_params(jenc, root, init_params={"vision": {}, "text": {}})


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("family", ["clip", "siglip", "resnet_sbert"])
def test_checkpoint_loads_into_both_packages_alike(hf_towers, tmp_path, family, fmt):
    root = write_checkpoint(hf_towers, family, fmt, tmp_path / family)
    jenc, tenc = encoders(family)
    init = None
    if family == "resnet_sbert":
        # The fresh heads: the same random ones in both packages.
        init = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(3)))
        tenc.load_state_dict(item_encoder_state_dict_from_jax(init))
    if family == "resnet_sbert":
        params = jax_resnet_sbert_params(root, init)
    else:
        params = load_item_encoder_params(jenc, root, init_params=init)
    sd = load_item_encoder_state_dict(
        tenc, root, init_state=tenc.state_dict() if init is not None else None
    )
    assert all(v.dtype == torch.float32 for v in sd.values())
    tenc.load_state_dict(sd, strict=True)
    imgs, ids, mask = inputs(family)
    want = np.asarray(jenc.encode(params, *(jnp.asarray(a) for a in (imgs, ids, mask))))
    with torch.no_grad():
        got = tenc.encode(*(torch.from_numpy(a) for a in (imgs, ids, mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_resnet_sbert_keeps_a_checkpoint_fc_of_its_width_and_needs_init_state(
    hf_towers, tmp_path
):
    resnet_sd, bert = hf_towers["resnet_sbert"]
    narrow = dict(resnet_sd)
    narrow["fc.weight"], narrow["fc.bias"] = torch.ones(8, 32), torch.zeros(8)
    _save(narrow, tmp_path / "vision", "safetensors")
    _save(bert, tmp_path / "text", "safetensors")
    _, tenc = encoders("resnet_sbert")
    init = tenc.state_dict()
    sd = load_item_encoder_state_dict(tenc, tmp_path, init_state=init)
    np.testing.assert_array_equal(sd["vision.fc.weight"].numpy(), np.ones((8, 32)))
    np.testing.assert_array_equal(sd["text.proj.weight"].numpy(), init["text.proj.weight"].numpy())
    with pytest.raises(ValueError, match="init_state"):
        load_item_encoder_state_dict(tenc, tmp_path)


def test_missing_checkpoint_is_a_clear_error(tmp_path):
    _, tenc = encoders("clip")
    with pytest.raises(FileNotFoundError, match="model.safetensors or pytorch_model.bin"):
        load_item_encoder_state_dict(tenc, tmp_path)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        load_item_encoder_state_dict(tenc, tmp_path / "absent")


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(4)
    tensors = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "i64": rng.integers(-9, 9, (2, 2)).astype(np.int64),
        "u8": rng.integers(0, 255, (4,)).astype(np.uint8),
        "flag": np.asarray([True, False]),
        "scalar": np.asarray(2.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }
    save_file(tensors, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got = read_safetensors(tmp_path / "a.safetensors")
    want = load_file(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k == "f16":  # widened to float32, exactly
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w.astype(np.float32))
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w)

    bf16 = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)).to(torch.bfloat16)
    safetensors_torch.save_file({"bf16": bf16, "odd": torch.ones(3, dtype=torch.bfloat16)},
                                str(tmp_path / "b.safetensors"))
    got = read_safetensors(tmp_path / "b.safetensors")
    want = safetensors_torch.load_file(str(tmp_path / "b.safetensors"))
    for k in ("bf16", "odd"):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k].float().numpy())

    bad = tmp_path / "c.safetensors"
    header = json.dumps({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}}).encode()
    bad.write_bytes(len(header).to_bytes(8, "little") + header + bytes(8))
    with pytest.raises(ValueError, match="data_offsets"):
        read_safetensors(bad)


# A tiny CLIP BPE vocabulary in the HF slow-tokenizer format (the JAX
# package's tests/test_tokenizer_hf.py writes the same).
VOCAB = [
    "l", "o", "w", "e", "r", "s", "t", "i", "d", "n",
    "lo", "l</w>", "w</w>", "r</w>", "t</w>",
    "low</w>", "er</w>", "lowest</w>", "newer</w>", "wider",
    "<unk>", "<|startoftext|>", "<|endoftext|>",
]
MERGES = ["#version: 0.2", "l o", "lo w</w>", "e r</w>"]


def test_load_tokenizer_takes_the_hf_branch_for_local_files(tmp_path):
    (tmp_path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(VOCAB)}))
    (tmp_path / "merges.txt").write_text("\n".join(MERGES))
    tok = transformers.CLIPTokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    tok.save_pretrained(str(tmp_path))
    call = load_tokenizer(str(tmp_path))
    assert not isinstance(call, HashTokenizer)
    texts = ["lower newer", "low", "lowest wider lower low"]
    ids, mask = call(texts, max_length=8)
    assert ids.dtype == np.int32 and mask.dtype == np.int32 and ids.shape == (3, 8)
    want_ids, want_mask = jax_load_tokenizer(str(tmp_path))(texts, max_length=8)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    ref = transformers.AutoTokenizer.from_pretrained(str(tmp_path), local_files_only=True)(
        texts, padding="max_length", truncation=True, max_length=8, return_tensors="np"
    )
    np.testing.assert_array_equal(ids, ref["input_ids"])
    assert ids[0, 0] == VOCAB.index("<|startoftext|>")
    assert VOCAB.index("<|endoftext|>") in ids[0]
    # A directory without tokenizer files falls back to the hash tokenizer.
    assert isinstance(load_tokenizer(str(tmp_path / "absent"), vocab_size=100), HashTokenizer)
