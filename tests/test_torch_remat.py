"""Activation recomputation in the port (``OutfitXConfig.remat``), on the
CPU in float32 at the ``tiny_cfg`` scale.

Under each policy ('full', 'masks', 'dots') the CP and CIR train steps
(A=2, dropout 0.3 drawn from the port's generators) give the plain step's
loss, gradients and updated parameters bit for bit, over two steps: the
recompute is the same arithmetic on the same masks. The generator's state
at the start is not a fresh seed's, and it leaves each layer where the
plain forward leaves it. The layers run twice under remat in training and
once in eval. Against the JAX package's ``remat=True`` forward and
gradient, with the same keep masks injected into both, to 1e-4; the
original-CP step (towers inside the step) against its plain step.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.losses import focal_loss as jax_focal
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.core import rng as trng
from outfitx_tpu_torch.data import sampler as tsampler
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.losses import focal_loss
from outfitx_tpu_torch.models import OutfitXModel, state_dict_from_jax
from outfitx_tpu_torch.train.optim import AdamW
from outfitx_tpu_torch.train.state import TrainState
from outfitx_tpu_torch.train.steps import cir_train_step, cp_train_step
from test_torch_train import KEEP, _assert_named, _cp_inputs, _host, _Masks, port_config

torch.set_num_threads(1)

POLICIES = ["full", "masks", "dots"]


def _remat(cfg, policy):
    return dataclasses.replace(cfg, remat=True, remat_policy=policy)


@pytest.fixture(scope="module")
def pcfg(tiny_cfg):
    cfg = port_config(tiny_cfg)
    assert cfg.transformer.dropout == 0.3 and not cfg.remat
    return cfg


@pytest.fixture(scope="module")
def data(pcfg):
    return make_synthetic(n_items=300, d_embed=pcfg.d_embed, n_outfits=128,
                          max_len=pcfg.max_outfit_len, seed=3)


def _batches(task, data, cfg):
    kw = dict(batch_size=8, accum_steps=2, seed=1)
    if task == "cp":
        return [next(tsampler.cp_train_batches(data.cp_train, epoch=e, **kw)) for e in (0, 1)]
    return [next(tsampler.cir_train_batches(
        data.cir_train, data.catalog, epoch=e, max_len=cfg.max_outfit_len, n_negatives=5,
        impl="python", **kw,
    )) for e in (0, 1)]


def _steps(cfg, task, data):
    """Two train steps from seed-0 weights: each step's loss, gradients and
    updated parameters."""
    model = OutfitXModel(cfg, device="cpu", seed=0, trainable=True)
    state = TrainState.create(
        model, AdamW(model.parameters(), tcfg.OptimizerConfig(learning_rate=1e-3), 10), seed=7
    )
    step = cp_train_step if task == "cp" else cir_train_step
    catalog = torch.from_numpy(data.catalog.embeddings)
    out = []
    for batch in _batches(task, data, cfg):
        res = step(state, catalog, {k: torch.from_numpy(v) for k, v in batch.items()})
        out.append((
            res["loss"].item(),
            {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            {n: p.detach().clone() for n, p in model.named_parameters()},
        ))
    return out


def _assert_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for n in want:
        assert torch.equal(got[n], want[n]), f"{what}: {n}"


@pytest.mark.parametrize("task", ["cp", "cir"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_steps_equal_the_plain_steps(pcfg, data, policy, task):
    want = _steps(pcfg, task, data)
    got = _steps(_remat(pcfg, policy), task, data)
    for i, ((gl, gg, gp), (wl, wg, wp)) in enumerate(zip(got, want)):
        assert gl == wl, f"step {i} loss"
        _assert_equal(gg, wg, f"step {i} grad")
        _assert_equal(gp, wp, f"step {i} param")


def _forward_backward(cfg, emb, mask, gen):
    model = OutfitXModel(cfg, device="cpu", seed=0, trainable=True).train()
    calls = []
    for layer in model.transformer_encoder.layers:
        layer.register_forward_pre_hook(lambda *a: calls.append(1))
    loss = model.cp_forward(emb, mask, generator=gen).square().mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return loss.item(), grads, len(calls), model


@pytest.mark.parametrize("policy", POLICIES)
def test_generator_state_is_replayed_in_the_recompute(pcfg, policy):
    """checkpoint restores only the global generators: the layers' masks
    come from an explicit one, whose state here is far from a fresh seed's.
    The recompute must see the forward's masks (a wrong mask would give a
    wrong gradient, not a NaN), and the generator must leave where the
    plain forward leaves it."""
    emb, mask, _ = (torch.from_numpy(a) for a in _cp_inputs(pcfg))

    def gen():
        g = torch.Generator().manual_seed(1234)
        torch.rand(4099, generator=g)
        return g

    g_plain, g_remat = gen(), gen()
    loss, grads, calls, _ = _forward_backward(pcfg, emb, mask, g_plain)
    r_loss, r_grads, r_calls, _ = _forward_backward(_remat(pcfg, policy), emb, mask, g_remat)
    n_layers = pcfg.transformer.n_layers
    assert (calls, r_calls) == (n_layers, 2 * n_layers)
    assert r_loss == loss
    _assert_equal(r_grads, grads, "grad")
    assert torch.equal(g_remat.get_state(), g_plain.get_state())
    assert torch.rand(3, generator=g_remat).tolist() == torch.rand(3, generator=g_plain).tolist()


def test_eval_and_no_grad_run_each_layer_once(pcfg):
    emb, mask, _ = (torch.from_numpy(a) for a in _cp_inputs(pcfg))
    plain = OutfitXModel(pcfg, device="cpu", seed=0)
    model = OutfitXModel(_remat(pcfg, "full"), device="cpu", seed=0, trainable=True)
    calls = []
    for layer in model.transformer_encoder.layers:
        layer.register_forward_pre_hook(lambda *a: calls.append(1))
    assert torch.equal(model.eval().cp_forward(emb, mask), plain.cp_forward(emb, mask))
    with torch.no_grad():
        model.train().cp_forward(emb, mask, generator=torch.Generator().manual_seed(0))
    assert len(calls) == 2 * pcfg.transformer.n_layers


def test_config_defaults_and_unknown_policy():
    from outfitx_tpu.core.config import OutfitXConfig as JaxConfig

    for cfg in (tcfg.OutfitXConfig(), JaxConfig()):
        assert (cfg.remat, cfg.remat_policy) == (False, "full")
    for policy in POLICIES:
        assert tcfg.OutfitXConfig(remat=True, remat_policy=policy).remat_policy == policy
    with pytest.raises(ValueError, match="remat_policy"):
        tcfg.OutfitXConfig(remat=True, remat_policy="offload")


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax_with_injected_masks(tiny_cfg, monkeypatch, policy):
    """The port's remat forward and gradient against the JAX package's
    ``remat=True`` under the same policy, the same keep masks injected
    into both (JAX's scan traces the layer body once, so its mask per site
    is the same in every layer, and the port's injection hands a layer's
    recompute the masks of its forward); the remat model loads the JAX
    weights' state dict strictly (remat adds no parameter)."""
    jcfg = dataclasses.replace(tiny_cfg, remat=True, remat_policy=policy)
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
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))

    def jloss(p):
        scores = jmodel.cp_forward(
            p, jnp.asarray(emb), jnp.asarray(mask),
            deterministic=False, rng=jax.random.PRNGKey(1),
        )
        return jax_focal(scores, jnp.asarray(labels))

    want, want_g = jax.jit(jax.value_and_grad(jloss))(params)
    model = OutfitXModel(_remat(port_config(tiny_cfg), policy), device="cpu", trainable=True)
    model.load_state_dict(state_dict_from_jax(_host(params)), strict=True)
    loss = focal_loss(
        model.train().cp_forward(torch.from_numpy(emb), torch.from_numpy(mask),
                                 generator=torch.Generator()),
        torch.from_numpy(labels),
    )
    loss.backward()
    # two (B, S, d) sites a layer, in the forward and again in the recompute
    assert torch_masks.calls == 2 * 2 * tiny_cfg.transformer.n_layers
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-4, rtol=1e-4)
    _assert_named(
        {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None},
        {n: t.numpy() for n, t in state_dict_from_jax(_host(want_g)).items()
         if not n.startswith(("cir_ffn", "target_item"))},
        atol=1e-4, rtol=1e-4, what="grad",
    )


def test_original_cp_remat_step_equals_plain_step(tmp_path):
    """The original-CP step (the towers encode raw items inside the step,
    then the set transformer, whose encoder is the same ``_Encoder``) with
    remat under the 'full' policy gives the plain step's loss and
    gradients, encoder heads included, with dropout on."""
    from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
    from outfitx_tpu_torch.models.towers.minilm import MiniLMConfig
    from outfitx_tpu_torch.models.towers.resnet import ResNet18Config
    from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPTrainer, RawItemSource
    from outfitx_tpu_torch.train.steps import original_cp_train_step

    split = make_synthetic(n_items=100, d_embed=16, n_outfits=64, seed=9)
    src = dict(n_items=100, image_size=32, text_len=12, vocab=120, seed=3)

    def step(remat):
        enc_cfg = tcfg.ItemEncoderConfig(encoder_type="resnet_sbert", dim_per_modality=8)
        model_cfg = tcfg.OutfitXConfig(
            item_encoder=enc_cfg, max_outfit_len=8, compute_dtype="float32", remat=remat,
            transformer=tcfg.TransformerConfig(n_heads=4, d_ffn=32, n_layers=2, dropout=0.3),
        )
        cfg = tcfg.CPTrainConfig(
            n_epochs=1, batch_size=8, accumulation_steps=2,
            checkpoint_dir=str(tmp_path / str(remat)), log_dir=str(tmp_path / f"{remat}logs"),
        )
        enc = ItemEncoderModel(
            enc_cfg, device="cpu", seed=1,
            vision_cfg=ResNet18Config(d_out=8, image_size=32, compute_dtype="float32"),
            text_cfg=MiniLMConfig(vocab_size=120, max_len=12, d_model=24, n_heads=4, d_mlp=48,
                                  n_layers=1, d_out=8, compute_dtype="float32"),
        )
        t = OriginalCPTrainer(
            cfg, model_cfg, encoder=enc, source=RawItemSource.synthetic(**src),
            train_split=split.cp_train, valid_split=split.cp_valid, device="cpu",
        ).__enter__()
        try:
            sels = next(t.step_selections(t._train_split, 0))
            out = original_cp_train_step(
                t.state, iter([t.microbatch(t._train_split, s) for s in sels])
            )
            grads = {n: p.grad.clone() for n, p in t.net.named_parameters() if p.grad is not None}
            return out["loss"].item(), grads
        finally:
            t.__exit__(ValueError, None, None)  # no final checkpoints

    loss, grads = step(False)
    r_loss, r_grads = step(True)
    assert any(n.startswith("encoder.") or "fc" in n for n in grads)
    assert r_loss == loss
    _assert_equal(r_grads, grads, "grad")
