"""The PyTorch port's FITB trainer against the JAX package's.

A CIR checkpoint is trained by the port's ``CIRTrainer`` in a fixture and
written once by each package's ``CheckpointManager``; both FITB trainers
restore each and give equal picks and accuracy (float32, ``tiny_cfg``, on
the CPU). FITB is test-only in both.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from outfitx_tpu.core import config as jcfg
from outfitx_tpu.data.synthetic import make_synthetic as jax_synthetic
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from outfitx_tpu.train.fitb_trainer import FITBTrainer as JaxFITBTrainer
from outfitx_tpu.train.steps import make_fitb_eval_step
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models.from_jax import jax_params_from_state_dict
from outfitx_tpu_torch.train.cir_trainer import CIRTrainer
from outfitx_tpu_torch.train.fitb_trainer import FITBTrainer

torch.set_num_threads(1)

DATA = dict(n_items=600, d_embed=64, n_outfits=256, seed=4)


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
def cir_checkpoints(tiny_cfg, tmp_path_factory):
    """{'port': path, 'jax': path}: the same trained CIR parameters written
    by each package's manager."""
    tmp = tmp_path_factory.mktemp("fitb")
    td = make_synthetic(**DATA)
    cfg = tcfg.CIRTrainConfig(
        n_epochs=2, batch_size=32, switch_to_hard_epoch=1, recall_every=1,
        candidate_pool_size=64, optimizer=tcfg.OptimizerConfig(learning_rate=2e-3),
        checkpoint_dir=str(tmp / "ckpt"), log_dir=str(tmp / "logs"),
    )
    with CIRTrainer(cfg, port_config(tiny_cfg), catalog=td.catalog,
                    train_split=td.cir_train, valid_split=td.cir_valid,
                    pool_threshold=1, device="cpu") as t:
        t.run()
    port_path = t.ckpt.path("best_recall@1")
    params = t.ckpt.restore(port_path)["params"]
    jax_path = JaxCheckpoints(tmp / "jax", "cir").save(
        "best_recall@1", params=jax_params_from_state_dict(params)
    )
    return {"port": str(port_path), "jax": str(jax_path), "tmp": tmp}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fitb_picks_and_accuracy_match_jax(tiny_cfg, cir_checkpoints, writer):
    path = cir_checkpoints[writer]
    tmp = cir_checkpoints["tmp"] / f"eval_{writer}"
    jd, td = jax_synthetic(**DATA), make_synthetic(**DATA)

    def cfg(pkg, side):
        return pkg.FITBTrainConfig(checkpoint_from=path, checkpoint_dir=str(tmp / side),
                                   log_dir=str(tmp / side / "logs"))

    with JaxFITBTrainer(cfg(jcfg, "jax"), tiny_cfg, catalog=jd.catalog,
                        test_split=jd.fitb_test) as jt:
        want_acc = jt.run()
        split = jd.fitb_test
        answers = split.cand_rows[np.arange(len(split)), split.answer_idx]
        want = np.asarray(make_fitb_eval_step(JaxModel(tiny_cfg))(
            jt.params, jnp.asarray(jd.catalog.embeddings), jnp.asarray(split.item_rows),
            jnp.asarray(split.mask), jnp.asarray(split.cand_rows), jnp.asarray(answers),
        ))
    with FITBTrainer(cfg(tcfg, "torch"), port_config(tiny_cfg), catalog=td.catalog,
                     test_split=td.fitb_test, eval_batch_size=48, device="cpu") as t:
        got_acc = t.run()
        got = t.predict()
    assert len(got["picks"]) == len(split) == 64
    np.testing.assert_array_equal(got["picks"], want)
    np.testing.assert_array_equal(got["answers"], split.answer_idx)
    assert got_acc == want_acc
    # a trained CIR model beats chance (0.25 over 4 candidates)
    assert got_acc["accuracy"] > 0.4, got_acc


def test_fitb_is_test_only(tmp_path):
    cfg = tcfg.FITBTrainConfig(checkpoint_dir=str(tmp_path), log_dir=str(tmp_path))
    with pytest.raises(ValueError, match="test"):
        FITBTrainer(cfg, run_mode="train-valid", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FITBTrainer(cfg)
