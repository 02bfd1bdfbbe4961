"""Checkpoints written before the QKV fusion (per-projection ``wq``/``wk``/
``wv`` and ``bq``/``bk``/``bv`` a layer) in the PyTorch port, against the
JAX package.

Each test writes its own legacy checkpoint with the JAX package's
``CheckpointManager``, as ``tests/test_resume.py`` does, at that test's
size (d=32, 4 heads, d_ffn 64, 2 layers, float32 on the CPU). The port's
``migrate_legacy_attn`` is bit-equal to JAX's, bfloat16 leaves included;
every route that restores a checkpoint (``CheckpointManager.restore``,
``build_engine`` and its int8 engine, the export, the CIR warm start and
FITB) gives from the legacy checkpoint what it gives from the fused one,
bit for bit, and the CP forward matches JAX's to 1e-6 relative. A full
resume across the fusion (parameters and an optimizer state) raises in
both packages, the port's error naming the warm start.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.core import config as jcfg
from outfitx_tpu.data.synthetic import make_synthetic as jax_synthetic
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu.models.export_torch import export_reference_checkpoint as jax_export
from outfitx_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from outfitx_tpu.train.checkpoint import migrate_legacy_attn as jax_migrate
from outfitx_tpu.train.cir_trainer import CIRTrainer as JaxCIRTrainer
from outfitx_tpu.train.cp_trainer import CPTrainer as JaxCPTrainer
from outfitx_tpu.train.fitb_trainer import FITBTrainer as JaxFITBTrainer
from outfitx_tpu.train.optim import make_optimizer
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models import OutfitXModel, load_jax_checkpoint, state_dict_from_jax
from outfitx_tpu_torch.models.export_torch import export_reference_checkpoint
from outfitx_tpu_torch.models.from_jax import read_checkpoint_tree
from outfitx_tpu_torch.serve.app import build_engine
from outfitx_tpu_torch.train.checkpoint import CheckpointManager, migrate_legacy_attn
from outfitx_tpu_torch.train.cir_trainer import CIRTrainer
from outfitx_tpu_torch.train.cp_trainer import CPTrainer
from outfitx_tpu_torch.train.fitb_trainer import FITBTrainer

torch.set_num_threads(1)

CFG = jcfg.OutfitXConfig(
    item_encoder=jcfg.ItemEncoderConfig(dim_per_modality=16),
    transformer=jcfg.TransformerConfig(n_heads=4, d_ffn=64, n_layers=2, dropout=0.0),
    max_outfit_len=8,
    compute_dtype="float32",
)
DATA = dict(n_items=300, d_embed=32, n_outfits=128, max_len=8, seed=5)


def port_config(cfg=CFG):
    def copy(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(src).items() if k in names})

    return tcfg.OutfitXConfig(
        item_encoder=copy(tcfg.ItemEncoderConfig, cfg.item_encoder),
        transformer=copy(tcfg.TransformerConfig, cfg.transformer),
        max_outfit_len=cfg.max_outfit_len,
        compute_dtype=cfg.compute_dtype,
    )


def fused_params(seed=0, dtype=np.float32):
    """JAX-initialised parameters (numpy leaves of ``dtype``)."""
    params = JaxModel(CFG).init(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda x: np.asarray(x).astype(dtype), params)


def legacy_tree(params):
    """``params`` with its attention in the pre-fusion layout, as
    ``tests/test_resume.py`` builds it."""
    legacy = jax.tree.map(lambda x: x, params)
    attn = legacy["layers"]["attn"]
    wqkv, bqkv = attn.pop("wqkv"), attn.pop("bqkv")  # (L, d, 3, d), (L, 3, d)
    for j, n in enumerate("qkv"):
        attn[f"w{n}"] = wqkv[:, :, j, :]
        attn[f"b{n}"] = bqkv[:, j, :]
    return legacy


def save(root, name, tag, params, **kw):
    """A checkpoint directory written by the JAX package's manager."""
    return JaxCheckpoints(root, name).save(tag, params=params, **kw)


def port_leaves(tree):
    """``tree`` with its leaves of the kind the port's reader gives:
    bfloat16 ones as tensors, the others numpy arrays."""
    def leaf(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return x

    return jax.tree.map(leaf, tree)


def bits(x):
    """A leaf's bytes, whichever its kind."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _assert_sd_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _trees(case):
    if case in ("legacy-float32", "legacy-bfloat16"):
        dtype = np.float32 if case == "legacy-float32" else ml_dtypes.bfloat16
        return {"params": legacy_tree(fused_params(dtype=dtype)), "converts": True}
    params = fused_params()
    tree = {
        "fused": params,
        "no-layers": {k: v for k, v in params.items() if k != "layers"},
        "original-cp": {"model": legacy_tree(params), "enc_heads": {"fc": {"w": np.ones((4, 2))}}},
    }[case]
    return {"params": tree, "converts": False}


@pytest.mark.parametrize(
    "case", ["legacy-float32", "legacy-bfloat16", "fused", "no-layers", "original-cp"]
)
def test_migrate_legacy_attn_matches_jax(case):
    """Both rules on the same tree: the same return, the same keys, the
    same bytes in each leaf's own kind and dtype (a bfloat16 leaf stays a
    tensor in the port, bit-exact)."""
    made = _trees(case)
    want = jax.tree.map(lambda x: x, made["params"])
    got = port_leaves(made["params"])
    assert jax_migrate(want) is made["converts"]
    assert migrate_legacy_attn(got) is made["converts"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(bits(g), bits(w))
    if made["converts"]:
        attn = got["layers"]["attn"]
        assert sorted(attn) == ["bo", "bqkv", "wo", "wqkv"]
        assert tuple(attn["wqkv"].shape) == (2, 32, 3, 32)
        assert tuple(attn["bqkv"].shape) == (2, 3, 32)
        kind = torch.Tensor if case == "legacy-bfloat16" else np.ndarray
        assert isinstance(attn["wqkv"], kind) and isinstance(attn["bqkv"], kind)
        # the fused tree it was cut from, leaf for leaf
        fused = fused_params(dtype=ml_dtypes.bfloat16 if kind is torch.Tensor else np.float32)
        for k in ("wqkv", "bqkv"):
            np.testing.assert_array_equal(bits(attn[k]), bits(fused["layers"]["attn"][k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_of_legacy_checkpoint_matches_fused(tmp_path, dtype):
    """The port's readers of a JAX-written legacy checkpoint give the fused
    parameters' state dict bit for bit, and the CP forward on it matches
    JAX's on the fused parameters to 1e-6 relative."""
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    params = fused_params(seed=1, dtype=np_dtype)
    path = save(tmp_path, "legacy", "best_auc", legacy_tree(params), epoch=3)
    tree = read_checkpoint_tree(path)
    wqkv = tree["params"]["layers"]["attn"]["wqkv"]
    if dtype == "bfloat16":
        assert isinstance(wqkv, torch.Tensor) and wqkv.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(wqkv), bits(params["layers"]["attn"]["wqkv"]))

    want = state_dict_from_jax(port_leaves(params))
    payload = CheckpointManager(tmp_path, "legacy").restore("best_auc")
    assert payload["opt_state"] is None and payload["meta"]["epoch"] == 3
    _assert_sd_equal(payload["params"], want)
    _assert_sd_equal(load_jax_checkpoint(path), want)
    assert "wqkv" in JaxCheckpoints(tmp_path, "legacy").restore("best_auc")["params"]["layers"]["attn"]

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((6, 8, CFG.d_embed)).astype(np.float32)
    mask = np.arange(8)[None, :] >= rng.integers(1, 9, size=(6, 1))
    ref = JaxModel(CFG).cp_forward(
        jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params),
        jnp.asarray(emb), jnp.asarray(mask),
    )
    model = OutfitXModel(port_config(), device="cpu")
    model.load_state_dict(payload["params"], strict=True)
    with torch.no_grad():
        got = model.cp_forward(torch.from_numpy(emb), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def _engine_checkpoints(root, legacy: bool):
    """``best_auc`` and ``best_recall@1`` of two different weight sets under
    ``root``, in the legacy layout or the fused one."""
    name = port_config().model_name
    for tag, suffix, seed in (("best_auc", "-cp", 2), ("best_recall@1", "-cir", 3)):
        params = fused_params(seed=seed)
        save(root, name + suffix, tag, legacy_tree(params) if legacy else params)
    return str(root)


def _answers(engine):
    rng = np.random.default_rng(7)
    ids = engine.catalog.item_ids
    outfits = [[int(i) for i in rng.choice(ids, int(rng.integers(2, 9)), replace=False)]
               for _ in range(6)]
    targets = [int(i) for i in rng.choice(ids, 6, replace=False)]
    return {
        "cp": [engine.cp_score(o) for o in outfits],
        "cp_batch": list(engine.cp_score_batch(outfits)),
        "cir": [engine.cir_top10(o, t) for o, t in zip(outfits, targets)],
        "fitb": [engine.fitb_pick(o[:-1], [o[-1]] + targets[:3]) for o in outfits],
    }


@pytest.mark.parametrize("quantize_model", [False, True])
def test_build_engine_from_legacy_checkpoints_answers_as_from_fused(tmp_path, quantize_model):
    """``build_engine`` (``load_jax_checkpoint``) with legacy ``best_auc``
    and ``best_recall@1``: the same weights, and the same CP, CIR and FITB
    answers, as the engine built from the fused checkpoints, on the
    float32 route and on the int8 one."""
    engines = {
        layout: build_engine(
            synthetic=True, model_cfg=port_config(), device="cpu",
            checkpoint_dir=_engine_checkpoints(tmp_path / layout, layout == "legacy"),
            quantize_model=quantize_model,
        )
        for layout in ("legacy", "fused")
    }
    old, new = engines["legacy"], engines["fused"]
    assert old.cir_model is not old.cp_model
    for attr in ("cp_model", "cir_model"):
        _assert_sd_equal(getattr(old, attr).state_dict(), getattr(new, attr).state_dict())
    if not quantize_model:
        _assert_sd_equal(old.cp_params, state_dict_from_jax(fused_params(seed=2)))
        _assert_sd_equal(old.cir_params, state_dict_from_jax(fused_params(seed=3)))
    got, want = _answers(old), _answers(new)
    assert got == want
    assert all(len(r) == 10 for r in got["cir"])


def test_export_of_legacy_checkpoint_equals_fused(tmp_path):
    """The port's ``.pth`` from a legacy checkpoint equals the one from the
    fused checkpoint, and the JAX exporter's from the same legacy one."""
    params = fused_params(seed=4)
    legacy = save(tmp_path / "legacy", "run", "best_auc", legacy_tree(params), epoch=5)
    fused = save(tmp_path / "fused", "run", "best_auc", params, epoch=5)
    got = torch.load(export_reference_checkpoint(legacy, tmp_path / "legacy.pth"),
                     weights_only=True)
    for name, want_path in (
        ("port, fused", export_reference_checkpoint(fused, tmp_path / "fused.pth")),
        ("jax, legacy", jax_export(legacy, tmp_path / "jax.pth")),
    ):
        want = torch.load(want_path, weights_only=True)
        assert got["epoch"] == want["epoch"] == 5, name
        for k in ("config", "optimizer", "scheduler", "scaler"):
            assert got[k] is None and want[k] is None, name
        _assert_sd_equal(got["model"], want["model"])


def _cir_cfg(pkg, root, side, warm):
    return pkg.CIRTrainConfig(
        n_epochs=1, batch_size=32, recall_every=1, candidate_pool_size=64, seed=11,
        warm_start_from=warm, checkpoint_dir=str(root / side / "ckpt"),
        log_dir=str(root / side / "logs"),
    )


def _fitb_cfg(pkg, root, side, path):
    return pkg.FITBTrainConfig(
        checkpoint_from=path, checkpoint_dir=str(root / side / "ckpt"),
        log_dir=str(root / side / "logs"),
    )


@pytest.mark.parametrize("route", ["cir_warm_start", "fitb"])
def test_trainers_from_legacy_checkpoints_equal_fused(tmp_path, route):
    """A CIR warm start from a legacy ``best_auc`` (a FITB run from a legacy
    ``best_recall@1``) starts from the parameters, and answers as, the same
    trainer does from the fused checkpoint and JAX's does from the legacy
    one."""
    params = fused_params(seed=5)
    tag = "best_auc" if route == "cir_warm_start" else "best_recall@1"
    paths = {
        "legacy": str(save(tmp_path / "legacy", "run", tag, legacy_tree(params))),
        "fused": str(save(tmp_path / "fused", "run", tag, params)),
    }
    want_sd = state_dict_from_jax(params)
    td, jd = make_synthetic(**DATA), jax_synthetic(**DATA)
    if route == "cir_warm_start":
        for layout, path in paths.items():
            with CIRTrainer(
                _cir_cfg(tcfg, tmp_path, layout, path), port_config(), catalog=td.catalog,
                train_split=td.cir_train, valid_split=td.cir_valid, pool_threshold=1,
                device="cpu",
            ) as t:
                _assert_sd_equal(t.model.state_dict(), want_sd)
                t.run_mode = "test"  # no final save
        with JaxCIRTrainer(
            _cir_cfg(jcfg, tmp_path, "jax", paths["legacy"]), CFG, catalog=jd.catalog,
            train_split=jd.cir_train, valid_split=jd.cir_valid, pool_threshold=1,
        ) as jt:
            jax_sd = state_dict_from_jax(jax.tree.map(np.asarray, jt.state.params))
            jt.run_mode = "test"
        _assert_sd_equal(jax_sd, want_sd)
        return
    picks = {}
    for layout, path in paths.items():
        with FITBTrainer(
            _fitb_cfg(tcfg, tmp_path, layout, path), port_config(),
            catalog=td.catalog, test_split=td.fitb_test, device="cpu",
        ) as t:
            _assert_sd_equal(t.model.state_dict(), want_sd)
            picks[layout] = (t.run(), t.predict()["picks"])
    with JaxFITBTrainer(
        _fitb_cfg(jcfg, tmp_path, "jax", paths["legacy"]), CFG,
        catalog=jd.catalog, test_split=jd.fitb_test,
    ) as jt:
        jax_acc = jt.run()
    assert picks["legacy"][0] == picks["fused"][0] == jax_acc
    np.testing.assert_array_equal(picks["legacy"][1], picks["fused"][1])


@pytest.mark.parametrize("package", ["jax", "port"])
def test_full_resume_across_the_fusion_raises(tmp_path, package):
    """A legacy checkpoint with an optimizer state (optax's, over the
    per-projection parameters): ``Trainer.resume`` raises in both
    packages; the port's error names the warm start and loads nothing."""
    legacy = legacy_tree(fused_params(seed=6))
    opt_state = make_optimizer(jcfg.OptimizerConfig(), 10).init(legacy)
    path = str(save(tmp_path, "old", "latest", legacy, opt_state=opt_state, step=3, epoch=0))
    if package == "jax":
        jd = jax_synthetic(**DATA)
        with JaxCPTrainer(
            jcfg.CPTrainConfig(n_epochs=1, batch_size=32, checkpoint_dir=str(tmp_path / "ckpt"),
                               log_dir=str(tmp_path / "logs")),
            CFG, catalog=jd.catalog, train_split=jd.cp_train, valid_split=jd.cp_valid,
        ) as jt:
            jt.run_mode = "test"
            with pytest.raises(ValueError):
                jt.resume(path)
        return
    td = make_synthetic(**DATA)
    with CPTrainer(
        tcfg.CPTrainConfig(n_epochs=1, batch_size=32, checkpoint_dir=str(tmp_path / "ckpt"),
                           log_dir=str(tmp_path / "logs")),
        port_config(), catalog=td.catalog, train_split=td.cp_train,
        valid_split=td.cp_valid, device="cpu",
    ) as t:
        t.run_mode = "test"
        before = {k: v.clone() for k, v in t.model.state_dict().items()}
        with pytest.raises(ValueError, match="warm-start the parameters into a fresh optimizer"):
            t.resume(path)
        _assert_sd_equal(t.model.state_dict(), before)
        assert t.state.step == 0 and t.state.optimizer.count == 0 and t.epoch == 0
        # the parameters alone restore, as a warm start takes them
        t.load_checkpoint_params(t.ckpt.restore(path))
        _assert_sd_equal(t.model.state_dict(), state_dict_from_jax(fused_params(seed=6)))
