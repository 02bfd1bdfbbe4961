"""The item-encoder pairs' two tables (``core/config.py ENCODER_PAIRS``,
``models/item_encoder.py PAIR_TOWERS``), at tiny tower widths on the CPU.

For every pair: ``for_type`` is its row; the encoder builds its tower
classes, trains its heads only where the row says so, and normalises images
with the row's statistics; the text towers that pool over a mask take
all-ones where none is given; the weights are those of the hand-written
order (vision then text from one host generator, DeepSeek-V2 and MoonViT
from a generator on their device seeded alike). The CLI's ``--encoder`` lists the
table's keys. Nothing here imports JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from outfitx_tpu_torch.cli import main as cli
from outfitx_tpu_torch.core.config import ENCODER_PAIRS, ItemEncoderConfig
from outfitx_tpu_torch.models.item_encoder import (
    TRAINABLE_HEADS,
    ItemEncoderModel,
    tower_configs,
)
from outfitx_tpu_torch.models.pretrained import load_item_encoder_state_dict
from outfitx_tpu_torch.models.towers import (
    TextTower,
    TextTowerConfig,
    VisionTower,
    VisionTowerConfig,
)
from outfitx_tpu_torch.models.towers.deepseek_v2 import DeepseekV2, DeepseekV2Config
from outfitx_tpu_torch.models.towers.minilm import MiniLM, MiniLMConfig
from outfitx_tpu_torch.models.towers.moonvit import MoonViT, MoonViTConfig
from outfitx_tpu_torch.models.towers.resnet import ResNet18, ResNet18Config

torch.set_num_threads(1)

DIM = 16
# Each tower config at a tiny width, float32, keeping what the pair set
# (CLIP's or SigLIP's variant, act and eps).
TINY = {
    VisionTowerConfig: dict(image_size=32, patch_size=16, d_model=DIM, n_heads=4, d_mlp=32,
                            n_layers=1, proj_dim=DIM),
    TextTowerConfig: dict(vocab_size=100, max_len=16, d_model=DIM, n_heads=4, d_mlp=32,
                          n_layers=1, proj_dim=DIM, eos_token_id=99),
    ResNet18Config: dict(d_out=DIM, image_size=32, stage_channels=(64, 16, 16, 32)),
    MiniLMConfig: dict(vocab_size=100, max_len=16, d_model=DIM, n_heads=4, d_mlp=32,
                       n_layers=1, d_out=DIM),
    DeepseekV2Config: dict(vocab_size=100, max_len=16, d_model=32, n_layers=3, n_heads=4,
                           qk_nope_dim=8, qk_rope_dim=8, v_dim=8, kv_lora_rank=16, d_ffn=48,
                           d_expert=16, n_experts=4, top_k=2, n_shared=1, first_dense=1,
                           d_out=DIM),
    MoonViTConfig: dict(image_size=32, patch_size=8, d_model=DIM, n_heads=2, d_mlp=32,
                        n_layers=1, pos_grid=8, d_text=32, d_out=DIM),
}
# Each pair's tower classes.
CLASSES = {
    "siglip": (VisionTower, TextTower),
    "clip": (VisionTower, TextTower),
    "resnet_sbert": (ResNet18, MiniLM),
    "resnet_dsv2lite": (ResNet18, DeepseekV2),
    "kimivl_a3b": (MoonViT, DeepseekV2),
}
PAIRS = list(ENCODER_PAIRS)


def tiny(name):
    """(encoder config, vision config, text config) of the pair at DIM."""
    cfg = dataclasses.replace(ItemEncoderConfig.for_type(name), dim_per_modality=DIM)
    vc, tc = (dataclasses.replace(c, **TINY[type(c)], compute_dtype="float32")
              for c in tower_configs(cfg))
    return cfg, vc, tc


def build(name, seed=0):
    cfg, vc, tc = tiny(name)
    return ItemEncoderModel(cfg, vision_cfg=vc, text_cfg=tc, device="cpu", seed=seed)


@pytest.mark.parametrize("name", PAIRS)
def test_for_type_is_the_row(name):
    row = ENCODER_PAIRS[name]
    cfg = ItemEncoderConfig.for_type(name)
    assert cfg == ItemEncoderConfig(
        encoder_type=name, dim_per_modality=row.dim_per_modality,
        image_model_name=row.image_model_name, text_model_name=row.text_model_name,
    )
    assert cfg.pair is row
    assert tuple(c.d_out for c in tower_configs(cfg)) == (row.dim_per_modality,) * 2


@pytest.mark.parametrize("name", PAIRS)
def test_the_encoder_follows_the_row(name):
    row = ENCODER_PAIRS[name]
    enc = build(name)
    assert (type(enc.vision), type(enc.text)) == CLASSES[name]
    assert enc.has_trainable_heads == row.trainable_heads
    trainable = {n for n, p in enc.named_parameters() if p.requires_grad}
    heads = {n for n, _ in enc.named_parameters() if n.startswith(TRAINABLE_HEADS)}
    assert trainable == (heads if row.trainable_heads else set())
    assert not row.trainable_heads or len(heads) == 4

    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 3, 32, 32),
                                                           dtype=np.uint8))
    mean, std = (torch.tensor(v, dtype=torch.float32).view(1, 3, 1, 1)
                 for v in (row.mean, row.std))
    got = enc.normalize_images(x)
    assert got.dtype == torch.float32
    assert torch.equal(got.contiguous(), (x.to(torch.float32) / 255.0 - mean) / std)

    ids = torch.randint(0, 100, (2, 8), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        bare = enc.encode_texts(ids)
        ones = enc.encode_texts(ids, torch.ones_like(ids))
    assert bare.shape == (2, DIM) and bool(torch.isfinite(bare).all())
    if not isinstance(enc.text, TextTower):  # the towers that pool over a mask
        assert torch.equal(bare, ones)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", PAIRS)
def test_weights_are_drawn_in_the_hand_written_order(name, seed):
    """Vision ``init_weights_`` first, then text, from one host generator;
    DeepSeek-V2 and MoonViT are made on the device and drawn from a
    generator there, seeded alike. Every tensor bit-equal."""
    cfg, vc, tc = tiny(name)
    gen = torch.Generator().manual_seed(seed)
    towers = []
    for cls, c in zip(CLASSES[name], (vc, tc)):
        on_device = getattr(cls, "made_on_device", False)
        tower = cls(c, device="cpu") if on_device else cls(c)
        tower.init_weights_(torch.Generator(device="cpu").manual_seed(seed) if on_device else gen)
        towers.append(tower)
    vision, text = towers
    want = {**{f"vision.{k}": v for k, v in vision.state_dict().items()},
            **{f"text.{k}": v for k, v in text.state_dict().items()}}
    got = build(name, seed).state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_cli_encoder_choices_are_the_table():
    parser = cli.build_parser()
    subparsers = next(a for a in parser._actions if a.dest == "command").choices
    encoders = [a for p in subparsers.values() for a in p._actions if a.dest == "encoder"]
    assert encoders
    assert PAIRS == ["siglip", "clip", "resnet_sbert", "resnet_dsv2lite", "kimivl_a3b"]
    for action in encoders:
        assert list(action.choices) == PAIRS and action.default == "siglip"


def test_a_tower_without_a_checkpoint_converter_is_refused(tmp_path):
    """The port has no converter for DeepSeek-V2's published checkpoint:
    loading one into ``resnet_dsv2lite`` is refused, naming the pair."""
    enc = build("resnet_dsv2lite")
    with pytest.raises(NotImplementedError, match="resnet_dsv2lite"):
        load_item_encoder_state_dict(enc, tmp_path, init_state=enc.state_dict())
