"""The PyTorch port's training path against the JAX package's, at the
``tiny_cfg`` scale in float32 on the CPU.

The same numpy inputs and the same initial weights (through
``state_dict_from_jax``) go through both packages: the optimizer against
optax (1e-6 relative), dropout in train mode with the same keep masks
injected into both (1e-4), one CP and one CIR train step with A=2
(gradients 1e-5 abs and 1e-4 rel), the host samplers (equal), and the CP
and CIR trainers over two epochs (1e-4; recall equal), the CIR trainers both on
the python and numpy routes and on their default routes (the C++ assembler
where g++ builds it, in both packages). Dropout masks are not compared bit
for bit: the two frameworks' generators differ.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from outfitx_tpu import native
from outfitx_tpu.core import config as jcfg
from outfitx_tpu.data import sampler as jsampler
from outfitx_tpu.data.synthetic import make_synthetic as jax_synthetic
from outfitx_tpu.losses import focal_loss as jax_focal
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from outfitx_tpu.train.cir_trainer import CIRTrainer as JaxCIRTrainer
from outfitx_tpu.train.cp_trainer import CPTrainer as JaxCPTrainer
from outfitx_tpu.train.optim import make_optimizer
from outfitx_tpu.train.optim import make_schedule as jax_schedule
from outfitx_tpu.train.state import TrainState as JaxState
from outfitx_tpu.train.steps import make_cir_train_step, make_cp_train_step
from outfitx_tpu_torch import native as tnative
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.core import rng as trng
from outfitx_tpu_torch.data import sampler as tsampler
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.losses import focal_loss
from outfitx_tpu_torch.models import (
    OutfitXModel,
    load_jax_checkpoint,
    state_dict_from_jax,
)
from outfitx_tpu_torch.models import outfit_transformer
from outfitx_tpu_torch.train.checkpoint import CheckpointManager
from outfitx_tpu_torch.train.cir_trainer import CIRTrainer
from outfitx_tpu_torch.train.cp_trainer import CPTrainer
from outfitx_tpu_torch.train.optim import AdamW, make_schedule
from outfitx_tpu_torch.train.state import TrainState
from outfitx_tpu_torch.train.steps import cir_train_step, cp_train_step

torch.set_num_threads(1)

KEEP = 179 / 256  # keep probability of dropout 0.3 on uint8 bits


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


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _torch_model(jcfg_model, params):
    model = OutfitXModel(port_config(jcfg_model), device="cpu", trainable=True)
    model.load_state_dict(state_dict_from_jax(_host(params)), strict=True)
    return model


def _assert_named(got, want, *, atol, rtol, what):
    assert sorted(got) == sorted(want), what
    for name in want:
        np.testing.assert_allclose(
            got[name], want[name], atol=atol, rtol=rtol, err_msg=f"{what}: {name}"
        )


# ------------------------------------------------------------- optimizer --


@pytest.mark.parametrize("total", [10, 30, 101])
def test_schedule_matches_optax(total):
    cfg = dict(learning_rate=3e-3, pct_start=0.3, div_factor=25.0, final_div_factor=1e4)
    ours = make_schedule(tcfg.OptimizerConfig(**cfg), total)
    theirs = jax_schedule(jcfg.OptimizerConfig(**cfg), total)
    # optax evaluates the schedule at the optimizer state's int32 count.
    for count in range(total + 3):
        assert np.float32(ours(count)) == np.float32(theirs(jnp.int32(count))), count


def test_adamw_matches_optax_over_30_steps():
    """Clip active on every third step, the warm-up boundary at step 9 and
    the last step of the horizon; the rate equal at each step."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 5), "b": (5,), "s": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in shapes.items()}
    grads = [
        {k: np.asarray((3.0 if i % 3 == 0 else 0.05) * rng.standard_normal(s), np.float32)
         for k, s in shapes.items()}
        for i in range(30)
    ]
    norms = [np.sqrt(sum(float((g ** 2).sum()) for g in gs.values())) for gs in grads]
    assert any(n >= 1.0 for n in norms) and any(n < 1.0 for n in norms)
    cfg = dict(learning_rate=1e-2, weight_decay=0.01)
    total = 30

    tx = make_optimizer(jcfg.OptimizerConfig(**cfg), total)
    schedule = jax_schedule(jcfg.OptimizerConfig(**cfg), total)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = AdamW(list(tparams.values()), tcfg.OptimizerConfig(**cfg), total)
    for i, g in enumerate(grads):
        assert np.float32(opt.learning_rate) == np.float32(schedule(jnp.int32(i))), i
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        _assert_named(
            {k: p.detach().numpy() for k, p in tparams.items()},
            {k: np.asarray(v) for k, v in jparams.items()},
            atol=1e-7, rtol=1e-6, what=f"step {i}",
        )
    assert opt.count == total


# --------------------------------------------------------------- dropout --


def test_keep_mask_rate_and_scale():
    gen = torch.Generator().manual_seed(0)
    keep, q = trng.keep_mask(gen, 0.3, (1000, 1000), "cpu")
    assert keep.dtype == torch.bool and q == KEEP
    assert abs(keep.float().mean().item() - KEEP) <= 0.005 * KEEP
    out = outfit_transformer._dropout(torch.ones(64, 64), 0.3, gen)
    assert set(torch.unique(out).tolist()) <= {0.0, float(np.float32(1) / np.float32(KEEP))}
    # Degenerate thresholds fall back to exact Bernoulli draws.
    assert trng.keep_mask(gen, 0.0, (8,), "cpu")[0].all()
    assert not trng.keep_mask(gen, 1.0, (8,), "cpu")[0].any()


class _Masks:
    """One fixed keep mask per dropout site, for both packages. The sites
    are told apart by shape, and the two (B, S, d) sites of a layer
    (attention output, then FFN output) by the order of the calls; the
    JAX layer body is traced once for all layers, so one mask per site
    serves every layer, in both packages."""

    def __init__(self, b, s, d, ffn, seed=0):
        rng = np.random.default_rng(seed)
        self.masks = {
            site: rng.random(shape) < KEEP
            for site, shape in (
                ("attn", (b, s, d)), ("out", (b, s, d)),
                ("hidden", (b, s, ffn)), ("head", (b, d)),
            )
        }
        self.shapes = {(b, s, ffn): "hidden", (b, d): "head"}
        self.calls = 0

    def __call__(self, shape):
        site = self.shapes.get(tuple(shape))
        if site is None:
            site = ("attn", "out")[self.calls % 2]
            self.calls += 1
        return self.masks[site]


def _cp_inputs(cfg, b=6, seed=0):
    rng = np.random.default_rng(seed)
    l, d = cfg.max_outfit_len, cfg.d_embed
    emb = rng.standard_normal((b, l, d)).astype(np.float32)
    lengths = rng.integers(1, l + 1, b)
    mask = np.arange(l)[None, :] >= lengths[:, None]
    labels = (np.arange(b) % 2).astype(np.float32)
    return emb, mask, labels


def test_train_mode_dropout_matches_jax_with_injected_masks(tiny_cfg, monkeypatch):
    emb, mask, labels = _cp_inputs(tiny_cfg)
    b, l, d = emb.shape
    shape = (b, l + 1, d, tiny_cfg.transformer.d_ffn)
    jax_masks, torch_masks = _Masks(*shape), _Masks(*shape)
    monkeypatch.setattr(
        "outfitx_tpu.core.rng.keep_mask",
        lambda key, rate, shape: (jnp.asarray(jax_masks(shape)), KEEP),
    )
    monkeypatch.setattr(
        trng, "keep_mask",
        lambda gen, rate, shape, device: (torch.from_numpy(torch_masks(shape)), KEEP),
    )
    assert tiny_cfg.transformer.dropout == 0.3
    jmodel = JaxModel(tiny_cfg)
    params = jmodel.init(jax.random.PRNGKey(0))

    def jloss(p):
        scores = jmodel.cp_forward(
            p, jnp.asarray(emb), jnp.asarray(mask),
            deterministic=False, rng=jax.random.PRNGKey(1),
        )
        return jax_focal(scores, jnp.asarray(labels))

    want, want_g = jax.jit(jax.value_and_grad(jloss))(params)
    model = _torch_model(tiny_cfg, params).train()
    loss = focal_loss(
        model.cp_forward(torch.from_numpy(emb), torch.from_numpy(mask),
                         generator=torch.Generator()),
        torch.from_numpy(labels),
    )
    loss.backward()
    # Eval mode is another function: dropout changed the loss.
    eval_loss = jax_focal(
        jax.jit(jmodel.cp_forward)(params, jnp.asarray(emb), jnp.asarray(mask)),
        jnp.asarray(labels),
    )
    assert abs(float(eval_loss) - float(want)) > 1e-3
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-4, rtol=1e-4)
    _assert_named(
        {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None},
        {n: t.numpy() for n, t in state_dict_from_jax(_host(want_g)).items()
         if not n.startswith(("cir_ffn", "target_item"))},
        atol=1e-4, rtol=1e-4, what="grad",
    )


# -------------------------------------------------------------- samplers --


@pytest.fixture(scope="module")
def synth():
    kw = dict(n_items=800, d_embed=64, n_outfits=256, seed=7)
    return jax_synthetic(**kw), make_synthetic(**kw)


@pytest.fixture()
def python_routes(monkeypatch):
    """Both packages' samplers on their python and numpy routes (the C++
    assembler that their 'auto' routes prefer has streams of its own)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def test_samplers_match_jax(synth, python_routes):
    jd, td = synth
    np.testing.assert_array_equal(jd.catalog.embeddings, td.catalog.embeddings)
    assert np.array_equal(
        jsampler.cp_epoch_order(100, seed=3, epoch=2),
        tsampler.cp_epoch_order(100, seed=3, epoch=2),
    )
    kw = dict(batch_size=32, accum_steps=2, epoch=1, seed=5)
    pairs = [
        (jsampler.cp_train_batches(jd.cp_train, **kw),
         tsampler.cp_train_batches(td.cp_train, **kw)),
        (jsampler.eval_batches({"a": np.arange(70)}, batch_size=32),
         tsampler.eval_batches({"a": np.arange(70)}, batch_size=32)),
    ]
    for mode in ("easy", "hard"):
        ckw = dict(kw, n_negatives=10, sample_mode=mode, max_len=8)
        pairs.append((
            jsampler.cir_train_batches(jd.cir_train, jd.catalog, **ckw),
            tsampler.cir_train_batches(td.cir_train, td.catalog, **ckw),
        ))
    for want_it, got_it in pairs:
        want, got = list(want_it), list(got_it)
        assert len(want) == len(got) > 0
        for w, g in zip(want, got):
            assert sorted(w) == sorted(g)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    want_q = jsampler.cir_eval_queries(jd.cir_valid, jd.catalog, seed=4, max_len=8)
    got_q = tsampler.cir_eval_queries(td.cir_valid, td.catalog, seed=4, max_len=8)
    for k in want_q:
        np.testing.assert_array_equal(got_q[k], want_q[k], err_msg=k)
    for mode in ("easy", "hard"):
        want_n = jsampler.sample_negatives_batch(
            jsampler.NegativeSampler(jd.catalog, mode), want_q["pos_idx"],
            k=10, seed=4, epoch=3,
        )
        got_n = tsampler.sample_negatives_batch(
            tsampler.NegativeSampler(td.catalog, mode), got_q["pos_idx"],
            k=10, seed=4, epoch=3,
        )
        for w, g in zip(want_n, got_n):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------- train steps --


def _capture_grads():
    """An optax link that passes the updates on and keeps the gradients it
    was given in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, state, params=None: (g, {"g": g}),
    )


def _step_pair(tiny_cfg, synth, task):
    jd, _ = synth
    cfg = _no_dropout(tiny_cfg)
    opt = dict(learning_rate=1e-3)
    jmodel = JaxModel(cfg)
    params = jmodel.init(jax.random.PRNGKey(2))
    tx = optax.chain(_capture_grads(), make_optimizer(jcfg.OptimizerConfig(**opt), 10))
    kw = dict(batch_size=8, accum_steps=2, epoch=0, seed=1)
    if task == "cp":
        batch = next(jsampler.cp_train_batches(jd.cp_train, **kw))
        jstep, tstep = make_cp_train_step(jmodel, tx, donate=False), cp_train_step
    else:
        batch = next(jsampler.cir_train_batches(
            jd.cir_train, jd.catalog, **kw, max_len=cfg.max_outfit_len, impl="python",
        ))
        jstep, tstep = make_cir_train_step(jmodel, tx, donate=False), cir_train_step
    new, jout = jstep(
        JaxState.create(params, tx, jax.random.PRNGKey(3)),
        jnp.asarray(jd.catalog.embeddings), jax.tree.map(jnp.asarray, batch),
    )
    model = _torch_model(cfg, params)
    state = TrainState.create(
        model, AdamW(model.parameters(), tcfg.OptimizerConfig(**opt), 10), seed=0
    )
    tout = tstep(
        state, torch.from_numpy(jd.catalog.embeddings),
        {k: torch.from_numpy(v) for k, v in batch.items()},
    )
    return jout, new, tout, model, state


@pytest.mark.parametrize("task", ["cp", "cir"])
def test_one_train_step_matches_jax(tiny_cfg, synth, task):
    jout, new, tout, model, state = _step_pair(tiny_cfg, synth, task)
    assert state.step == 1 and state.optimizer.count == 1
    np.testing.assert_allclose(tout["loss"].item(), float(jout["loss"]), atol=1e-5, rtol=1e-5)
    if task == "cp":
        np.testing.assert_allclose(
            tout["scores"].numpy(), np.asarray(jout["scores"]), atol=1e-5, rtol=1e-5
        )
    # Parameters off the task's path have no gradient in the port and a
    # zero one in JAX.
    want_g = state_dict_from_jax(_host(new.opt_state[0]["g"]))
    got_g = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    assert all(not want_g[n].any() for n in set(want_g) - set(got_g))
    _assert_named(
        got_g, {n: want_g[n].numpy() for n in got_g}, atol=1e-5, rtol=1e-4, what="grad",
    )
    # The key bias's gradient is zero in exact arithmetic (softmax ignores a
    # shift shared by a row's scores), so it is rounding noise in both
    # packages, and Adam's first step, g / (|g| + eps), turns that noise
    # into O(lr) updates: leave the key third of in_proj_bias out.
    d = tiny_cfg.d_embed

    def comparable(sd):
        return {
            n: np.concatenate([t[:d], t[2 * d:]]) if n.endswith("in_proj_bias") else t
            for n, t in ((n, t.numpy()) for n, t in sd.items())
        }

    _assert_named(
        comparable(model.state_dict()),
        comparable(state_dict_from_jax(_host(new.params))),
        atol=1e-6, rtol=1e-5, what="param",
    )


# -------------------------------------------------------------- trainers --


def _records(log_dir):
    (path,) = pathlib.Path(log_dir).glob("*_metrics.jsonl")
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def _by_epoch(records, split):
    return {r["epoch"]: r for r in records if r["split"] == split}


@pytest.fixture(scope="module")
def cp_runs(tiny_cfg, synth, tmp_path_factory):
    """Both CP trainers, 2 epochs from the same initial weights, dropout 0.
    Returns their metrics records and the port's checkpoint directory."""
    jd, td = synth
    cfg = _no_dropout(tiny_cfg)
    tmp = tmp_path_factory.mktemp("cp")
    kw = dict(
        n_epochs=2, batch_size=32, accumulation_steps=2, seed=11,
        optimizer=dict(learning_rate=2e-3),
    )

    def train_cfg(pkg, side):
        return pkg.CPTrainConfig(**{
            **kw, "optimizer": pkg.OptimizerConfig(**kw["optimizer"]),
            "checkpoint_dir": str(tmp / side / "ckpt"), "log_dir": str(tmp / side / "logs"),
        })

    with JaxCPTrainer(
        train_cfg(jcfg, "jax"), cfg, catalog=jd.catalog,
        train_split=jd.cp_train, valid_split=jd.cp_valid,
    ) as jt:
        init = _host(jt.state.params)
        jt.run()
    with CPTrainer(
        train_cfg(tcfg, "torch"), port_config(cfg), catalog=td.catalog,
        train_split=td.cp_train, valid_split=td.cp_valid, device="cpu",
    ) as t:
        t.model.load_state_dict(state_dict_from_jax(init), strict=True)
        t.run()
    return {
        "jax": _records(tmp / "jax" / "logs"),
        "torch": _records(tmp / "torch" / "logs"),
        "ckpt": t.ckpt,
        "model": t.model,
        "cfg": cfg,
        "tmp": tmp,
    }


@pytest.mark.parametrize("split", ["train", "valid"])
def test_cp_trainer_matches_jax(cp_runs, split):
    want, got = _by_epoch(cp_runs["jax"], split), _by_epoch(cp_runs["torch"], split)
    assert sorted(got) == sorted(want) == [0, 1]
    for epoch in want:
        for key in ("loss", "auc", "acc", "f1"):
            np.testing.assert_allclose(
                got[epoch][key], want[epoch][key], atol=1e-4, rtol=1e-4,
                err_msg=f"{split} epoch {epoch} {key}",
            )


def test_cp_checkpoint_reads_back_in_both_packages(cp_runs):
    """The JAX CheckpointManager restores the port's checkpoint (the call
    the JAX serving app's ``build_engine`` and warm starts make), and the
    port's readers, its serving engine's among them, give the same
    parameters."""
    ckpt = cp_runs["ckpt"]
    path = ckpt.path("best_auc")
    live = {n: t.float() for n, t in cp_runs["model"].state_dict().items()}
    jax_mgr = JaxCheckpoints(ckpt.dir.parent, ckpt.dir.name)
    assert jax_mgr.exists("best_auc")
    jax_params = jax_mgr.restore("best_auc")["params"]
    jmodel = JaxModel(cp_runs["cfg"])
    template = jmodel.init(jax.random.PRNGKey(0))
    assert jax.tree.structure(jax_params) == jax.tree.structure(template)
    from outfitx_tpu_torch.serve.app import build_engine

    engine = build_engine(
        synthetic=True, model_cfg=port_config(cp_runs["cfg"]),
        checkpoint_dir=str(ckpt.dir.parent), device="cpu",
    )
    readers = {
        "jax": state_dict_from_jax(_host(jax_params)),
        "load_jax_checkpoint": load_jax_checkpoint(path),
        "port": CheckpointManager(ckpt.dir.parent, ckpt.dir.name).restore(path)["params"],
        "port build_engine": engine.cp_params,
    }
    best = readers["port"]
    for name, sd in readers.items():
        assert sorted(sd) == sorted(live), name
        for k in sd:
            assert torch.equal(sd[k], best[k]), (name, k)
    # 'final' holds the trained model, its optimizer and its step.
    final = ckpt.restore("final")
    for k in live:
        assert torch.equal(final["params"][k], live[k]), k
    adam, schedule = final["opt_state"][1][0], final["opt_state"][1][2]
    assert adam[0].shape == schedule[0].shape == ()
    assert int(adam[0]) == int(schedule[0]) == final["meta"]["step"] == 8
    # The JAX model on the restored tree scores as the port does.
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((4, 8, 64)).astype(np.float32)
    mask = np.zeros((4, 8), dtype=bool)
    mask[:, 5:] = True
    want = jmodel.cp_forward(
        jax.tree.map(jnp.asarray, JaxCheckpoints(ckpt.dir.parent, ckpt.dir.name)
                     .restore("final")["params"]),
        jnp.asarray(emb), jnp.asarray(mask),
    )
    got = cp_runs["model"].eval().cp_forward(torch.from_numpy(emb), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_cp_trainer_resumes_from_final(cp_runs, synth):
    _, td = synth
    ckpt = cp_runs["ckpt"]
    tmp = cp_runs["tmp"] / "resume"
    cfg = tcfg.CPTrainConfig(
        n_epochs=2, batch_size=32, accumulation_steps=2,
        checkpoint_dir=str(tmp / "ckpt"), log_dir=str(tmp / "logs"),
    )
    with CPTrainer(
        cfg, port_config(cp_runs["cfg"]), catalog=td.catalog,
        train_split=td.cp_train, valid_split=td.cp_valid, device="cpu",
    ) as t:
        t.resume(str(ckpt.path("final")))
        assert t.state.step == 8 and t.state.optimizer.count == 8 and t.epoch == 2
        want = cp_runs["model"].state_dict()
        for n, p in t.model.state_dict().items():
            assert torch.equal(p, want[n]), n
        assert t.run() is None  # nothing left to train


def test_cir_trainer_warm_starts_from_port_checkpoint_and_matches_jax(
    cp_runs, synth, tmp_path, python_routes
):
    """Two epochs across the curriculum switch (easy, then hard), recall
    every epoch, both trainers warm-started from the port's CP
    checkpoint."""
    t = _cir_trainers_match(cp_runs, synth, tmp_path)
    # Best checkpoints only after the switch: saved at epoch 1.
    assert t.ckpt.exists("best_recall@1")
    meta = t.ckpt.restore("best_recall@1")["meta"]
    assert meta["epoch"] == 1


def test_cir_trainer_on_default_routes_matches_jax(cp_runs, synth, tmp_path):
    """Both CIR trainers with their samplers' default routes, which take
    the C++ assembler in both packages where g++ builds it: the same
    batches, negatives and eval queries. (The CP sampler has one route, so
    ``test_cp_trainer_matches_jax`` runs both CP trainers on theirs.)"""
    assert tnative.available() == native.available()
    _cir_trainers_match(cp_runs, synth, tmp_path)


def _cir_trainers_match(cp_runs, synth, tmp_path):
    """Both CIR trainers, two epochs from the port's CP checkpoint: losses
    to 1e-4 and recall equal. Returns the port's trainer."""
    jd, td = synth
    cfg = cp_runs["cfg"]
    warm = str(cp_runs["ckpt"].path("best_auc"))
    kw = dict(
        n_epochs=2, batch_size=32, switch_to_hard_epoch=1, recall_every=1,
        candidate_pool_size=64, seed=11, warm_start_from=warm,
    )

    def train_cfg(pkg, side):
        return pkg.CIRTrainConfig(
            **kw, optimizer=pkg.OptimizerConfig(learning_rate=2e-3),
            checkpoint_dir=str(tmp_path / side / "ckpt"),
            log_dir=str(tmp_path / side / "logs"),
        )

    with JaxCIRTrainer(
        train_cfg(jcfg, "jax"), cfg, catalog=jd.catalog,
        train_split=jd.cir_train, valid_split=jd.cir_valid, pool_threshold=1,
    ) as jt:
        jt.run()
    with CIRTrainer(
        train_cfg(tcfg, "torch"), port_config(cfg), catalog=td.catalog,
        train_split=td.cir_train, valid_split=td.cir_valid, pool_threshold=1,
        device="cpu",
    ) as t:
        warm_sd = load_jax_checkpoint(warm)
        for n, p in t.model.state_dict().items():
            assert torch.equal(p, warm_sd[n]), n
        t.run()
    assert all(len(set(p.tolist())) == 64 for p in t._pools.pools.values())
    want_recs, got_recs = _records(tmp_path / "jax" / "logs"), _records(tmp_path / "torch" / "logs")
    for split in ("train", "valid"):
        want, got = _by_epoch(want_recs, split), _by_epoch(got_recs, split)
        assert sorted(got) == sorted(want) == [0, 1]
        for epoch in want:
            np.testing.assert_allclose(
                got[epoch]["loss"], want[epoch]["loss"], atol=1e-4, rtol=1e-4,
                err_msg=f"{split} epoch {epoch}",
            )
            if split == "train":
                assert got[epoch]["neg_mode"] == want[epoch]["neg_mode"] == epoch
                continue
            recall = sorted(k for k in want[epoch] if k.startswith("recall@"))
            assert len(recall) == 6
            for k in recall:
                assert got[epoch][k] == want[epoch][k], (epoch, k)
    return t


@pytest.mark.parametrize("trainer", [CPTrainer, CIRTrainer])
def test_trainers_default_to_the_card(trainer):
    cfg = tcfg.CPTrainConfig() if trainer is CPTrainer else tcfg.CIRTrainConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer(cfg)


# ------------------------------------------------------------ eval steps --


def test_eval_steps_match_jax(tiny_cfg, synth):
    """CP scores, CIR predictions, the CIR eval loss and FITB picks of the
    port's eval steps against the JAX package's, from the same weights."""
    from outfitx_tpu.train.steps import (
        make_cir_eval_loss_step,
        make_cir_eval_step,
        make_cp_eval_step,
        make_fitb_eval_step,
    )
    from outfitx_tpu_torch.train import steps

    jd, _ = synth
    jmodel = JaxModel(tiny_cfg)
    params = jmodel.init(jax.random.PRNGKey(4))
    model = _torch_model(tiny_cfg, params)
    cat = jd.catalog.embeddings
    q = jsampler.cir_eval_queries(jd.cir_valid, jd.catalog, seed=0, max_len=8, impl="python")
    neg, neg_mask = jsampler.sample_negatives_batch(
        jsampler.NegativeSampler(jd.catalog, "hard"), q["pos_idx"], k=10, seed=0,
        epoch=0, impl="numpy",
    )
    fitb = jd.fitb_test
    answers = fitb.cand_rows[np.arange(len(fitb)), fitb.answer_idx]
    j, t = jnp.asarray, torch.from_numpy
    cases = {
        "cp": (
            make_cp_eval_step(jmodel)(params, j(cat), j(jd.cp_valid.item_rows), j(jd.cp_valid.mask)),
            steps.cp_eval_step(model, t(cat), t(jd.cp_valid.item_rows), t(jd.cp_valid.mask)),
        ),
        "cir": (
            make_cir_eval_step(jmodel)(params, j(cat), j(q["item_idx"]), j(q["mask"]), j(q["pos_idx"])),
            steps.cir_eval_step(model, t(cat), t(q["item_idx"]), t(q["mask"]), t(q["pos_idx"])),
        ),
    }
    cases["cir_loss"] = (
        make_cir_eval_loss_step()(j(cat), cases["cir"][0], j(q["pos_idx"]), j(neg), j(neg_mask)),
        steps.cir_eval_loss_step(t(cat), cases["cir"][1], t(q["pos_idx"]), t(neg), t(neg_mask)),
    )
    cases["fitb"] = (
        make_fitb_eval_step(jmodel)(
            params, j(cat), j(fitb.item_rows), j(fitb.mask), j(fitb.cand_rows), j(answers),
        ),
        steps.fitb_eval_step(
            model, t(cat), t(fitb.item_rows), t(fitb.mask),
            t(fitb.cand_rows.astype(np.int64)), t(answers.astype(np.int64)),
        ),
    )
    for name, (want, got) in cases.items():
        if name == "fitb":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4, err_msg=name)


def test_metrics_and_recall_match_jax(synth):
    from outfitx_tpu import evalm as jevalm
    from outfitx_tpu.evalm.retrieval_eval import recall_over_pools as jax_recall
    from outfitx_tpu_torch import evalm
    from outfitx_tpu_torch.evalm.retrieval_eval import recall_over_pools

    rng = np.random.default_rng(0)
    scores = np.round(rng.standard_normal(200), 1)  # ties
    labels = (rng.random(200) < 0.4).astype(np.float32)
    for from_logits in (False, True):
        want = jevalm.binary_classification_metrics(scores, labels, from_logits=from_logits)
        got = evalm.binary_classification_metrics(scores, labels, from_logits=from_logits)
        assert got == want
    assert evalm.roc_auc(scores, labels) == jevalm.roc_auc(scores, labels)
    retrieved = rng.integers(0, 20, (30, 50))
    pos = rng.integers(0, 20, 30)
    valid = rng.random(30) < 0.8
    assert evalm.recall_at_k(retrieved, pos, valid=valid) == jevalm.recall_at_k(retrieved, pos, valid=valid)
    assert evalm.fitb_accuracy(pos, retrieved[:, 0]) == jevalm.fitb_accuracy(pos, retrieved[:, 0])

    jd, td = synth
    jpools = jsampler.CandidatePools.build(jd.catalog, jd.cir_valid, pool_size=64, threshold=1)
    tpools = tsampler.CandidatePools.build(td.catalog, td.cir_valid, pool_size=64, threshold=1)
    q = tsampler.cir_eval_queries(td.cir_valid, td.catalog, seed=0, max_len=8)
    y = rng.standard_normal((len(q["pos_idx"]), td.catalog.d_embed)).astype(np.float32)
    y[::3] = td.catalog.embeddings[q["pos_idx"][::3]]  # some hits at rank 1
    want = jax_recall(y, q["pos_idx"], q["pos_category"], jpools, jnp.asarray(jd.catalog.embeddings))
    got = recall_over_pools(
        torch.from_numpy(y), q["pos_idx"], q["pos_category"], tpools,
        torch.from_numpy(td.catalog.embeddings),
    )
    assert got == want and got["recall@1"] >= 1 / 3 - 0.01
