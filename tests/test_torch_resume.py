"""A training run resumed across the two packages: the port's checkpoints
hold the optimizer state in optax's layout, the JAX package's, so a run of
either package resumes in the other with its AdamW moments and counts.

At the ``tiny_cfg`` scale (the original-CP case at the tiny towers of
``test_torch_original_cp.py``) in float32 on the CPU, dropout 0. For CP,
CIR (the curriculum switch inside the resumed epochs) and original-CP (the
encoder heads' moments transposed as their weights): one package trains 2
epochs and writes ``final``; each package resumes it to 4 epochs. Right
after the load the step, the epoch, both counts, the parameters and both
moments are bit-equal to the checkpoint's in both packages; after the
resumed epochs the two runs' losses and parameters agree to 1e-4, the
tolerance of ``test_torch_train.py``'s trainer comparisons (every logged
metric but CIR's recall, a rank count that a near-tie moves). Also: the JAX
manager's ``restore(template=...)`` of a port checkpoint, the port's layout
from before optax's, and the states that must not load.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
from outfitx_tpu.core import config as jcfg
from outfitx_tpu.data.synthetic import make_synthetic as jax_synthetic
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu.models.item_encoder import ItemEncoderModel as JaxItemEncoder
from outfitx_tpu.models.towers.minilm import MiniLMConfig as JaxMiniLMConfig
from outfitx_tpu.models.towers.resnet import ResNet18Config as JaxResNetConfig
from outfitx_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from outfitx_tpu.train.cir_trainer import CIRTrainer as JaxCIRTrainer
from outfitx_tpu.train.cp_trainer import CPTrainer as JaxCPTrainer
from outfitx_tpu.train.optim import make_optimizer
from outfitx_tpu.train.original_cp_trainer import OriginalCPTrainer as JaxOCPTrainer
from outfitx_tpu.train.original_cp_trainer import RawItemSource as JaxSource
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models import OutfitXModel
from outfitx_tpu_torch.models.from_jax import (
    item_encoder_state_dict_from_jax,
    jax_params_from_state_dict,
)
from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
from outfitx_tpu_torch.models.towers.minilm import MiniLMConfig
from outfitx_tpu_torch.models.towers.resnet import ResNet18Config
from outfitx_tpu_torch.train.checkpoint import (
    CheckpointManager,
    optimizer_tree,
    params_tree,
)
from outfitx_tpu_torch.train.cir_trainer import CIRTrainer
from outfitx_tpu_torch.train.cp_trainer import CPTrainer
from outfitx_tpu_torch.train.optim import AdamW
from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPTrainer, RawItemSource

torch.set_num_threads(1)

TOL = 1e-4
DATA = dict(n_items=400, d_embed=64, n_outfits=192, seed=7)
# original-CP: the tiny towers and set transformer of test_torch_original_cp.py
OCP_DATA = dict(n_items=200, d_embed=16, n_outfits=128, seed=9)
N_ITEMS, IMAGE, TEXT_LEN, VOCAB = 200, 32, 12, 120
RESNET = dict(d_out=8, image_size=IMAGE, compute_dtype="float32")
MINILM = dict(vocab_size=VOCAB, max_len=TEXT_LEN, d_model=24, n_heads=4, d_mlp=48,
              n_layers=1, d_out=8, compute_dtype="float32")
ENCODER = dict(encoder_type="resnet_sbert", dim_per_modality=8)
SOURCE = dict(n_items=N_ITEMS, image_size=IMAGE, text_len=TEXT_LEN, vocab=VOCAB, seed=3)


def port_config(cfg):
    """The port's config with the JAX config's values."""

    def copy(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(src).items() if k in names})

    return tcfg.OutfitXConfig(
        item_encoder=copy(tcfg.ItemEncoderConfig, cfg.item_encoder),
        transformer=copy(tcfg.TransformerConfig, cfg.transformer),
        max_outfit_len=cfg.max_outfit_len,
        param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype,
    )


def _no_dropout(cfg):
    return dataclasses.replace(
        cfg, transformer=dataclasses.replace(cfg.transformer, dropout=0.0)
    )


def _ocp_model_cfg(pkg):
    return pkg.OutfitXConfig(
        item_encoder=pkg.ItemEncoderConfig(**ENCODER),
        transformer=pkg.TransformerConfig(n_heads=4, d_ffn=32, n_layers=1, dropout=0.0),
        max_outfit_len=8, compute_dtype="float32",
    )


@pytest.fixture(scope="module")
def synth():
    return jax_synthetic(**DATA), make_synthetic(**DATA)


@pytest.fixture(scope="module")
def ocp_synth(tmp_path_factory):
    """The splits, and the JAX trainer's frozen towers with its initial
    heads (every JAX trainer of one seed draws the same), for the port's
    encoder."""
    jd = jax_synthetic(**OCP_DATA)
    root = tmp_path_factory.mktemp("ocp")
    jt = _ocp_trainer(jcfg, jd, None, n_epochs=1, root=root).__enter__()
    frozen = jax.tree.map(np.asarray, jt.frozen)
    heads = jax.tree.map(np.asarray, jt.state.params["enc_heads"])
    jt.__exit__(ValueError, None, None)  # no final checkpoint
    enc = {
        "vision": {**frozen["vision"], "fc": heads["fc"]},
        "text": {**frozen["text"], "proj": heads["proj"]},
    }
    return jd, make_synthetic(**OCP_DATA), item_encoder_state_dict_from_jax(enc)


def _train_cfg(pkg, cls, root, **kw):
    return cls(
        **kw, optimizer=pkg.OptimizerConfig(learning_rate=2e-3),
        checkpoint_dir=str(root / "ckpt"), log_dir=str(root / "logs"),
    )


def _ocp_trainer(pkg, data, encoder_sd, *, n_epochs, root):
    cfg = pkg.CPTrainConfig(
        n_epochs=n_epochs, batch_size=16, accumulation_steps=2,
        optimizer=pkg.OptimizerConfig(learning_rate=1e-3),
        checkpoint_dir=str(root / "ckpt"), log_dir=str(root / "logs"),
    )
    splits = dict(train_split=data.cp_train, valid_split=data.cp_valid)
    if pkg is jcfg:
        encoder = JaxItemEncoder(
            jcfg.ItemEncoderConfig(**ENCODER),
            vision_cfg=JaxResNetConfig(**RESNET), text_cfg=JaxMiniLMConfig(**MINILM),
        )
        return JaxOCPTrainer(cfg, _ocp_model_cfg(jcfg), encoder=encoder,
                             source=JaxSource.synthetic(**SOURCE), **splits)
    encoder = ItemEncoderModel(
        tcfg.ItemEncoderConfig(**ENCODER), vision_cfg=ResNet18Config(**RESNET),
        text_cfg=MiniLMConfig(**MINILM), device="cpu",
    )
    encoder.load_state_dict(encoder_sd, strict=True)
    return OriginalCPTrainer(cfg, _ocp_model_cfg(tcfg), encoder=encoder,
                             source=RawItemSource.synthetic(**SOURCE), device="cpu", **splits)


def _trainer(kind, package, env, *, n_epochs, root):
    """A trainer of ``kind`` in ``package`` ('jax' or 'port'), entered."""
    pkg = jcfg if package == "jax" else tcfg
    if kind == "ocp":
        jd, td, encoder_sd = env
        return _ocp_trainer(pkg, jd if pkg is jcfg else td, encoder_sd,
                            n_epochs=n_epochs, root=root).__enter__()
    jd, td, cfg = env
    data = jd if pkg is jcfg else td
    model_cfg = cfg if pkg is jcfg else port_config(cfg)
    kw = dict(n_epochs=n_epochs, batch_size=32, seed=11)
    port = {} if pkg is jcfg else {"device": "cpu"}
    if kind == "cp":
        cls = JaxCPTrainer if pkg is jcfg else CPTrainer
        train_cfg = _train_cfg(pkg, pkg.CPTrainConfig, root, accumulation_steps=2, **kw)
        return cls(train_cfg, model_cfg, catalog=data.catalog, train_split=data.cp_train,
                   valid_split=data.cp_valid, **port).__enter__()
    cls = JaxCIRTrainer if pkg is jcfg else CIRTrainer
    train_cfg = _train_cfg(
        pkg, pkg.CIRTrainConfig, root, switch_to_hard_epoch=3, recall_every=1,
        candidate_pool_size=64, **kw,
    )
    return cls(train_cfg, model_cfg, catalog=data.catalog, train_split=data.cir_train,
               valid_split=data.cir_valid, pool_threshold=1, **port).__enter__()


def _state(t):
    """(step, parameter leaves, optimizer leaves) of a trainer of either
    package, in the JAX package's tree order."""
    if isinstance(t, (CPTrainer, CIRTrainer, OriginalCPTrainer)):
        params = params_tree(**t.checkpoint_params())
        opt = optimizer_tree(
            t.state.model, t.state.optimizer, None,
            lambda named: params_tree(**t.checkpoint_params(named)),
        )
        step = t.state.step
    else:
        params, opt, step = t.state.params, t.state.opt_state, int(t.state.step)
    def host(tree):
        return [np.asarray(x.detach() if torch.is_tensor(x) else x) for x in jax.tree.leaves(tree)]

    return step, host(params), host(opt)


def _assert_bit_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")


def _records(log_dir):
    (path,) = pathlib.Path(log_dir).glob("*_metrics.jsonl")
    return [json.loads(ln) for ln in path.read_text().splitlines()]


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("kind", ["cp", "cir", "ocp"])
def test_run_resumes_in_the_other_package(kind, first, synth, tiny_cfg, tmp_path, request):
    """``first`` trains 2 epochs and writes ``final``; both packages resume
    it to 4 epochs: bit-equal state after the load, the same run after."""
    if kind == "ocp":
        env = request.getfixturevalue("ocp_synth")
    else:
        env = (*synth, _no_dropout(tiny_cfg))
    a = _trainer(kind, first, env, n_epochs=2, root=tmp_path / "a")
    a.run()
    a.__exit__(None, None, None)
    path = a.ckpt.path("final")
    saved = JaxCheckpoints(path.parent.parent, path.parent.name).restore(path)
    want_params = [np.asarray(x) for x in jax.tree.leaves(saved["params"])]
    want_opt = [np.asarray(x) for x in jax.tree.leaves(saved["opt_state"])]
    assert saved["meta"]["epoch"] == 1 and saved["meta"]["step"] > 0
    assert int(want_opt[0]) == int(want_opt[-1]) == saved["meta"]["step"]

    runs = {}
    for package in ("jax", "port"):
        root = tmp_path / package
        t = _trainer(kind, package, env, n_epochs=4, root=root)
        try:
            t.resume(str(path))
            step, params, opt = _state(t)
            assert step == saved["meta"]["step"] and t.epoch == 2, package
            _assert_bit_equal(params, want_params, f"{package} parameters after the load")
            _assert_bit_equal(opt, want_opt, f"{package} optimizer state after the load")
            t.run()
            runs[package] = (_state(t), _records(root / "logs"))
        finally:
            t.__exit__(None, None, None)

    (jstep, jparams, jopt), jrecs = runs["jax"]
    (step, params, opt), recs = runs["port"]
    assert step == jstep == 2 * saved["meta"]["step"]
    assert [(r["split"], r["epoch"]) for r in recs] == [(r["split"], r["epoch"]) for r in jrecs]
    assert sorted({r["epoch"] for r in recs}) == [2, 3]
    for got, want in zip(recs, jrecs):
        for key in sorted(set(want) - {"split", "epoch", "epoch_seconds", "time"}):
            if key == "neg_mode":
                assert got[key] == want[key] == int(got["epoch"] >= 3)
                continue
            if key.startswith("recall@"):
                # a rank count over 64 candidates: a near-tie that the two
                # frameworks' last bits order differently moves it by 1/64
                continue
            np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL,
                                       err_msg=f"{got['split']} epoch {got['epoch']} {key}")
    for i, (g, w) in enumerate(zip(params, jparams)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=f"parameter leaf {i}")
    assert len(opt) == len(jopt)


# ------------------------------------------------------ the layout alone --


def _stepped(cfg, seed=3):
    """An ``OutfitXModel`` with an AdamW one step in."""
    model = OutfitXModel(port_config(cfg), device="cpu", seed=seed, trainable=True)
    opt = AdamW(model.parameters(), tcfg.OptimizerConfig(), 10)
    gen = torch.Generator().manual_seed(seed)
    for p in opt.params:
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    return model, opt


def test_jax_manager_restores_the_port_optimizer_state(tiny_cfg, tmp_path):
    """``restore(template={"params", "opt_state"})``, the call the JAX
    ``Trainer.resume`` makes, takes the port's checkpoint: optax's
    structure, both counts, and ``mu``/``nu`` bit-equal to the port's
    moments in the JAX layout."""
    model, opt = _stepped(tiny_cfg)
    path = CheckpointManager(tmp_path, "m").save(
        "latest", params=model.state_dict(), opt_state=optimizer_tree(model, opt), step=1,
    )
    params = JaxModel(tiny_cfg).init(jax.random.PRNGKey(0))
    template = {"params": params, "opt_state": make_optimizer(jcfg.OptimizerConfig(), 10).init(params)}
    payload = JaxCheckpoints(tmp_path, "m").restore(path, template=template)
    assert jax.tree.structure(payload["opt_state"]) == jax.tree.structure(template["opt_state"])
    _, (adam, _, schedule) = payload["opt_state"]
    assert int(adam.count) == int(schedule.count) == 1
    names = [n for n, _ in model.named_parameters()]
    for key in ("mu", "nu"):
        want = jax_params_from_state_dict(dict(zip(names, getattr(opt, key))))
        assert jax.tree.structure(getattr(adam, key)) == jax.tree.structure(want)
        _assert_bit_equal([np.asarray(x) for x in jax.tree.leaves(getattr(adam, key))],
                          jax.tree.leaves(want), key)


def _cp_trainer(synth, cfg, root):
    _, td = synth
    return CPTrainer(
        tcfg.CPTrainConfig(n_epochs=2, batch_size=32, checkpoint_dir=str(root / "ckpt"),
                           log_dir=str(root / "logs")),
        port_config(_no_dropout(cfg)), catalog=td.catalog, train_split=td.cp_train,
        valid_split=td.cp_valid, device="cpu",
    )


def test_port_layout_before_optax_still_resumes(synth, tiny_cfg, tmp_path):
    """A port checkpoint from before the port wrote optax's layout (count,
    and the moments keyed by parameter name) still resumes."""
    model, opt = _stepped(tiny_cfg)
    names = [n for n, _ in model.named_parameters()]
    old = {
        "count": np.asarray(opt.count, dtype=np.int32),
        **{key: {n: m.numpy() for n, m in zip(names, getattr(opt, key))} for key in ("mu", "nu")},
    }
    path = CheckpointManager(tmp_path, "old").save(
        "latest", params=model.state_dict(), opt_state=old, step=1, epoch=0,
    )
    with _cp_trainer(synth, tiny_cfg, tmp_path) as t:
        t.run_mode = "test"  # no final save
        t.resume(str(path))
        assert t.state.step == t.state.optimizer.count == 1 and t.epoch == 1
        for key in ("mu", "nu"):
            for got, want in zip(getattr(t.state.optimizer, key), getattr(opt, key)):
                assert torch.equal(got, want)
        for n, p in t.model.named_parameters():
            assert torch.equal(p, dict(model.named_parameters())[n]), n


def _spoil(opt_state, how):
    clip, (adam, decay, schedule) = opt_state
    if how == "counts":
        schedule = [np.asarray(2, np.int32)]
    elif how == "missing":
        del adam[1]["cp_head"]["b"]
    elif how == "extra":
        adam[2]["extra"] = np.zeros(3, np.float32)
    elif how == "shape":
        adam[1]["outfit_token"] = np.zeros(3, np.float32)
    return [clip, [adam, decay, schedule]]


@pytest.mark.parametrize("how", ["counts", "missing", "extra", "shape"])
def test_state_that_does_not_fit_raises_and_loads_nothing(synth, tiny_cfg, tmp_path, how):
    """Counts that differ, moments missing a parameter, with a leaf more
    or of another shape: ``resume`` raises ValueError and the trainer is
    as it was."""
    model, opt = _stepped(tiny_cfg)
    path = CheckpointManager(tmp_path, "bad").save(
        "latest", params=model.state_dict(), opt_state=_spoil(optimizer_tree(model, opt), how),
        step=1, epoch=0,
    )
    with _cp_trainer(synth, tiny_cfg, tmp_path) as t:
        t.run_mode = "test"
        before = {k: v.clone() for k, v in t.model.state_dict().items()}
        match = "differ" if how == "counts" else "warm-start the parameters"
        with pytest.raises(ValueError, match=match):
            t.resume(str(path))
        for k, v in t.model.state_dict().items():
            assert torch.equal(v, before[k]), k
        assert t.state.step == t.state.optimizer.count == 0 and t.epoch == 0
        assert all(not m.any() for m in t.state.optimizer.mu + t.state.optimizer.nu)
