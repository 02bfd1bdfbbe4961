"""The PyTorch port's export to the reference's ``.pth``
(``models/export_torch.py``) against the JAX package's.

``reference_state_dict`` gives the JAX exporter's keys, shapes and values
(exact: both only transpose, stack and widen float32); the ``.pth`` written
from a checkpoint directory of either package equals the JAX exporter's,
loads strictly into the port's ``OutfitXModel`` and scores as the JAX model
does (1e-5, float32 on the CPU); ``towers_from`` merges ``item_encoder.*``
and raises without those keys.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from outfitx_tpu.core.config import ItemEncoderConfig, OutfitXConfig, TransformerConfig
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu.models.export_torch import export_reference_checkpoint as jax_export
from outfitx_tpu.models.export_torch import reference_state_dict as jax_reference_state_dict
from outfitx_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.models import OutfitXModel, state_dict_from_jax
from outfitx_tpu_torch.models.export_torch import (
    export_reference_checkpoint,
    reference_state_dict,
)
from outfitx_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)


def _cfg(final_norm=False):
    return OutfitXConfig(
        item_encoder=ItemEncoderConfig(dim_per_modality=32),
        transformer=TransformerConfig(n_heads=4, d_ffn=96, n_layers=3, dropout=0.3,
                                      final_norm=final_norm),
        max_outfit_len=8,
        compute_dtype="float32",
    )


def port_config(cfg):
    def copy(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(src).items() if k in names})

    return tcfg.OutfitXConfig(
        item_encoder=copy(tcfg.ItemEncoderConfig, cfg.item_encoder),
        transformer=copy(tcfg.TransformerConfig, cfg.transformer),
        max_outfit_len=cfg.max_outfit_len,
        compute_dtype=cfg.compute_dtype,
    )


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, JaxModel(_cfg()).init(jax.random.PRNGKey(7)))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("final_norm", [False, True])
def test_reference_state_dict_matches_jax(final_norm):
    p = jax.tree.map(np.asarray, JaxModel(_cfg(final_norm)).init(jax.random.PRNGKey(3)))
    got = reference_state_dict(p)
    _assert_same(got, jax_reference_state_dict(p))
    assert ("transformer_encoder.norm.weight" in got) == final_norm


def _write(writer, params, root):
    """A checkpoint directory written by ``writer``'s manager."""
    if writer == "jax":
        return JaxCheckpoints(root, "run").save("best_auc", params=params, epoch=7)
    return CheckpointManager(root, "run").save(
        "best_auc", params=state_dict_from_jax(params), epoch=7
    )


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_export_from_either_package_matches_jax(params, tmp_path, writer):
    path = _write(writer, params, tmp_path)
    got = torch.load(export_reference_checkpoint(path, tmp_path / "port.pth"),
                     weights_only=True)
    want = torch.load(jax_export(path, tmp_path / "jax.pth"), weights_only=True)
    assert sorted(got) == sorted(want)
    assert got["epoch"] == want["epoch"] == 7
    for k in ("config", "optimizer", "scheduler", "scaler"):
        assert got[k] is None and want[k] is None
    _assert_same(got["model"], want["model"])

    # The export loads strictly into the port's model and scores as JAX's.
    cfg = _cfg()
    model = OutfitXModel(port_config(cfg), device="cpu")
    model.load_state_dict(got["model"], strict=True)
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((5, 8, 64)).astype(np.float32)
    mask = np.arange(8)[None, :] >= rng.integers(2, 9, size=(5, 1))
    ref = JaxModel(cfg).cp_forward(jax.tree.map(jnp.asarray, params), jnp.asarray(emb),
                                   jnp.asarray(mask))
    with torch.no_grad():
        scores = model.cp_forward(torch.from_numpy(emb), torch.from_numpy(mask))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_towers_from_merges_item_encoder_keys(params, tmp_path):
    path = _write("port", params, tmp_path)
    towers = nn.Sequential(nn.Linear(4, 4))
    donor = {f"item_encoder.{k}": v for k, v in towers.state_dict().items()}
    donor_path = tmp_path / "towers.pth"
    torch.save({"model": {**donor, "outfit_token": torch.zeros(64)}}, donor_path)
    out = torch.load(
        export_reference_checkpoint(path, tmp_path / "merged.pth", towers_from=donor_path),
        weights_only=True,
    )
    want = torch.load(jax_export(path, tmp_path / "jax.pth", towers_from=donor_path),
                      weights_only=True)
    _assert_same(out["model"], want["model"])
    for k, v in donor.items():
        assert torch.equal(out["model"][k], v), k
    # only the towers are taken from the donor
    assert not torch.equal(out["model"]["outfit_token"], torch.zeros(64))

    no_towers = tmp_path / "no_towers.pth"
    torch.save({"model": {"outfit_token": torch.zeros(64)}}, no_towers)
    with pytest.raises(ValueError, match="item_encoder"):
        export_reference_checkpoint(path, tmp_path / "x.pth", towers_from=no_towers)
