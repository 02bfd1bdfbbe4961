"""The PyTorch port's item encoder and precompute sweep against the JAX
package's: the same tiny towers, weights carried over by
``item_encoder_state_dict_from_jax``, the same synthetic items, float32 on
both sides at 1e-4."""

import json
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.core.config import ItemEncoderConfig as JaxItemEncoderConfig
from outfitx_tpu.core.config import OutfitXConfig as JaxOutfitXConfig
from outfitx_tpu.core.config import PrecomputeConfig as JaxPrecomputeConfig
from outfitx_tpu.data.catalog import Catalog as JaxCatalog
from outfitx_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from outfitx_tpu.models.item_encoder import ItemEncoderModel as JaxItemEncoder
from outfitx_tpu.models.towers import TextTowerConfig as JaxTextCfg
from outfitx_tpu.models.towers import VisionTowerConfig as JaxVisionCfg
from outfitx_tpu.train.precompute import PrecomputeRunner as JaxPrecomputeRunner
from outfitx_tpu_torch.core.config import (
    ItemEncoderConfig,
    OutfitXConfig,
    PrecomputeConfig,
)
from outfitx_tpu_torch.data.catalog import Catalog
from outfitx_tpu_torch.data.preprocess import make_normalizer
from outfitx_tpu_torch.data.tokenizer import HashTokenizer, load_tokenizer
from outfitx_tpu_torch.models.from_jax import item_encoder_state_dict_from_jax
from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
from outfitx_tpu_torch.models.towers import TextTowerConfig, VisionTowerConfig
from outfitx_tpu_torch.train.precompute import PrecomputeRunner, _prefetch

torch.set_num_threads(1)

TOL = 1e-4

VISION = dict(
    variant="clip", image_size=32, patch_size=16, d_model=64, n_heads=4,
    d_mlp=96, n_layers=2, proj_dim=48, compute_dtype="float32",
)
TEXT = dict(
    variant="clip", vocab_size=500, max_len=16, d_model=64, n_heads=4,
    d_mlp=96, n_layers=2, proj_dim=48, eos_token_id=499, compute_dtype="float32",
)


def make_pair(aggregation="concat", seed=0, **port_kw):
    cfg_kw = dict(encoder_type="clip", aggregation=aggregation, dim_per_modality=48)
    jenc = JaxItemEncoder(
        JaxItemEncoderConfig(**cfg_kw),
        vision_cfg=JaxVisionCfg(**VISION), text_cfg=JaxTextCfg(**TEXT),
    )
    params = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(seed)))
    tenc = ItemEncoderModel(
        ItemEncoderConfig(**cfg_kw),
        vision_cfg=VisionTowerConfig(**VISION), text_cfg=TextTowerConfig(**TEXT),
        device="cpu", **port_kw,
    )
    tenc.load_state_dict(item_encoder_state_dict_from_jax(params), strict=True)
    return jenc, params, tenc


def _inputs(b=4, size=32, t=16, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, 3, size, size), dtype=np.uint8)
    ids = rng.integers(1, 400, (b, t)).astype(np.int32)
    ids[:, -1] = 499
    mask = np.ones((b, t), dtype=np.int32)
    return imgs, ids, mask


@pytest.mark.parametrize("aggregation, d_embed", [("concat", 96), ("mean", 48), ("sum", 48)])
def test_encode_matches_jax(aggregation, d_embed):
    jenc, params, tenc = make_pair(aggregation)
    imgs, ids, mask = _inputs()
    want = np.asarray(jenc.encode(params, *(jnp.asarray(a) for a in (imgs, ids, mask))))
    got = tenc.encode(*(torch.from_numpy(a) for a in (imgs, ids, mask)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, d_embed)
    assert tenc.cfg.d_embed == d_embed
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_concat_keeps_the_text_half_second_and_both_unit_norm():
    _, _, tenc = make_pair()
    imgs, ids, mask = (torch.from_numpy(a) for a in _inputs(seed=1))
    full = tenc.encode(imgs, ids, mask)
    np.testing.assert_allclose(
        full[:, 48:].numpy(), tenc.encode_texts(ids, mask).numpy(), rtol=0, atol=1e-6
    )
    np.testing.assert_allclose(
        full[:, :48].numpy(), tenc.encode_images(imgs).numpy(), rtol=0, atol=1e-6
    )
    for half in (full[:, :48], full[:, 48:]):
        np.testing.assert_allclose(half.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert not full.requires_grad


@pytest.mark.parametrize("encoder_type", ["clip", "siglip", "resnet_sbert"])
def test_normalizer_matches_jax(encoder_type):
    from outfitx_tpu.data.preprocess import make_normalizer as jax_make_normalizer

    imgs = _inputs(seed=2)[0]
    want = np.asarray(jax_make_normalizer(encoder_type)(jnp.asarray(imgs)))
    got = make_normalizer(encoder_type)(torch.from_numpy(imgs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_hash_tokenizer_matches_jax():
    texts = ["category 7", "Red  Leather jacket", "", "a " * 40]
    for vocab, max_length in ((500, 16), (32000, 64)):
        want = JaxHashTokenizer(vocab_size=vocab)(texts, max_length=max_length)
        got = HashTokenizer(vocab_size=vocab)(texts, max_length=max_length)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    assert isinstance(load_tokenizer("", vocab_size=500), HashTokenizer)
    assert isinstance(load_tokenizer(None, vocab_size=500), HashTokenizer)


def test_tower_width_must_agree_with_dim_per_modality():
    with pytest.raises(ValueError, match="d_out=48 != dim_per_modality=64"):
        ItemEncoderModel(
            ItemEncoderConfig(encoder_type="clip", dim_per_modality=64),
            vision_cfg=VisionTowerConfig(**VISION), text_cfg=TextTowerConfig(**TEXT),
            device="cpu",
        )


def test_resnet_sbert_waits_for_its_towers():
    """The resnet_sbert towers are ported: the default configuration builds
    ResNet-18 and MiniLM at the JAX package's widths."""
    enc = ItemEncoderModel(ItemEncoderConfig.for_type("resnet_sbert"), device="cpu")
    assert type(enc.vision).__name__ == "ResNet18" and type(enc.text).__name__ == "MiniLM"
    assert (enc.image_size, enc.text_vocab_size, enc.cfg.d_embed) == (224, 30522, 128)
    with pytest.raises(NotImplementedError, match="towers"):
        ItemEncoderModel(ItemEncoderConfig(encoder_type="vit_huge"), device="cpu")


def test_configs_match_the_jax_defaults():
    import dataclasses

    assert dataclasses.asdict(PrecomputeConfig()) == dataclasses.asdict(JaxPrecomputeConfig())
    for enc_type in ("clip", "siglip", "resnet_sbert"):
        assert dataclasses.asdict(ItemEncoderConfig.for_type(enc_type)) == (
            dataclasses.asdict(JaxItemEncoderConfig.for_type(enc_type))
        )
    assert OutfitXConfig().model_name == JaxOutfitXConfig().model_name


def _load_all(directory):
    out = {}
    for path in sorted(directory.glob("*.pkl")):
        with open(path, "rb") as f:
            payload = pickle.load(f)
        assert isinstance(payload["ids"], list)
        assert payload["embeddings"].dtype == np.float32
        for iid, e in zip(payload["ids"], payload["embeddings"]):
            assert iid not in out  # shards must not overlap
            out[iid] = np.asarray(e)
    return out


@pytest.fixture()
def runners(tmp_path, monkeypatch):
    """The JAX runner and the port's on 23 synthetic items (two full
    batches of 8 and a trailing one of 7), the same weights."""
    # The JAX runner sets this variable for the process if it is unset.
    monkeypatch.setenv("OUTFITX_TOWER_ATTN", "block")
    jenc, params, tenc = make_pair(attn="block")
    jax_cfg = JaxPrecomputeConfig(batch_size=8, dataset_dir=str(tmp_path))
    jax_runner = JaxPrecomputeRunner(
        jax_cfg, JaxOutfitXConfig(item_encoder=jenc.cfg),
        output_dir=str(tmp_path / "jax"), params=params, synthetic_items=23,
        encoder=jenc,
    )
    cfg = PrecomputeConfig(batch_size=8, dataset_dir=str(tmp_path))
    model_cfg = OutfitXConfig(item_encoder=tenc.cfg)
    runner = PrecomputeRunner(
        cfg, model_cfg, output_dir=str(tmp_path / "port"), synthetic_items=23,
        encoder=tenc, device="cpu",
    )
    return jax_runner, runner, cfg, model_cfg, tenc


def test_sweep_matches_the_jax_runner(runners, tmp_path):
    jax_runner, runner, _, model_cfg, _ = runners
    want_result = jax_runner.run()
    result = runner.run()
    assert sorted(result) == ["items", "items_per_sec", "seconds", "shards"]
    assert (result["items"], result["shards"]) == (23, 1)
    assert (want_result["items"], want_result["shards"]) == (23, 1)
    names = sorted(p.name for p in (tmp_path / "port").glob("*.pkl"))
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.pkl"))
    assert names == [f"{model_cfg.model_name}_embedding_subset_0.pkl"]
    want, got = _load_all(tmp_path / "jax"), _load_all(tmp_path / "port")
    assert list(got) == list(want) == [10_000 + i for i in range(23)]
    for iid in want:
        assert got[iid].shape == (96,)
        np.testing.assert_allclose(got[iid], want[iid], rtol=0, atol=TOL)


def test_sliced_sweep_equals_the_single_one(runners, tmp_path):
    _, single, cfg, model_cfg, tenc = runners
    single.run()
    for k in range(3):
        res = PrecomputeRunner(
            cfg, model_cfg, output_dir=str(tmp_path / "sliced"),
            synthetic_items=23, encoder=tenc, n_slices=3, slice_index=k,
            device="cpu",
        ).run()
        assert res["shards"] == 1 and res["items"] == len(range(k, 23, 3))
    names = sorted(p.name for p in (tmp_path / "sliced").glob("*.pkl"))
    prefix = f"{model_cfg.model_name}_embedding_subset_"
    assert names == [f"{prefix}{k}.pkl" for k in range(3)]
    one, sliced = _load_all(tmp_path / "port"), _load_all(tmp_path / "sliced")
    assert set(one) == set(sliced)
    for iid in one:
        # The same item in a batch of another composition: the same
        # arithmetic, up to the CPU product's blocking.
        np.testing.assert_allclose(one[iid], sliced[iid], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="slice 3 not in"):
        PrecomputeRunner(
            cfg, model_cfg, synthetic_items=23, encoder=tenc, n_slices=3,
            slice_index=3, device="cpu",
        )


def test_shards_are_read_by_both_catalog_loaders(tmp_path):
    _, _, tenc = make_pair()
    cfg = PrecomputeConfig(batch_size=8, dataset_dir=str(tmp_path))
    model_cfg = OutfitXConfig(item_encoder=tenc.cfg)
    # output_dir left out: <dataset_dir>/precomputed_embeddings, where the
    # catalog loaders look.
    result = PrecomputeRunner(
        cfg, model_cfg, synthetic_items=20, encoder=tenc, device="cpu"
    ).run()
    assert result["items"] == 20
    metadata = [
        {"item_id": 10_000 + i, "category_id": i % 13,
         "semantic_category": "tops", "title": f"item {i}"}
        for i in range(20)
    ]
    (tmp_path / "item_metadata.json").write_text(json.dumps(metadata))
    (tmp_path / "categories.json").write_text(
        json.dumps({str(i): f"category {i}" for i in range(13)})
    )
    emb = next(iter(_load_all(tmp_path / "precomputed_embeddings").values()))
    for loader in (JaxCatalog, Catalog):
        cat = loader.from_polyvore(tmp_path, model_name=model_cfg.model_name)
        assert cat.n_items == 20 and cat.d_embed == 96
        np.testing.assert_array_equal(cat.embeddings[0], emb)


def test_real_items_are_read_from_the_dataset_directory(tmp_path):
    """The dataset path: metadata, categories and JPEG files; an item
    without an image is left out."""
    from PIL import Image

    _, _, tenc = make_pair()
    (tmp_path / "images").mkdir()
    rng = np.random.default_rng(3)
    for iid in (7, 8, 9):
        pixels = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(tmp_path / "images" / f"{iid}.jpg")
    metadata = [{"item_id": iid, "category_id": 1} for iid in (7, 8, 9, 10)]
    (tmp_path / "item_metadata.json").write_text(json.dumps(metadata))
    (tmp_path / "categories.json").write_text(json.dumps({"1": "tops"}))
    cfg = PrecomputeConfig(batch_size=2, dataset_dir=str(tmp_path))
    result = PrecomputeRunner(
        cfg, OutfitXConfig(item_encoder=tenc.cfg), encoder=tenc, device="cpu"
    ).run()
    assert result["items"] == 3
    got = _load_all(tmp_path / "precomputed_embeddings")
    assert list(got) == [7, 8, 9]
    assert all(np.isfinite(e).all() for e in got.values())


def test_prefetch_hands_on_the_iterators_error():
    def items():
        yield 1
        raise OSError("unreadable image")

    it = _prefetch(items())
    assert next(it) == 1
    with pytest.raises(OSError, match="unreadable image"):
        next(it)
    assert list(_prefetch(iter(range(5)))) == [0, 1, 2, 3, 4]


def test_device_rule(tmp_path):
    """The runner and the encoder default to the card and raise without
    one; nothing falls back to the CPU."""
    assert not torch.cuda.is_available()
    cfg = PrecomputeConfig(batch_size=8, dataset_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrecomputeRunner(cfg, synthetic_items=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ItemEncoderModel(
            ItemEncoderConfig(encoder_type="clip", dim_per_modality=48),
            vision_cfg=VisionTowerConfig(**VISION), text_cfg=TextTowerConfig(**TEXT),
        )
    _, _, tenc = make_pair()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrecomputeRunner(cfg, synthetic_items=4, encoder=tenc)
