"""The plain references against outfitx_tpu_torch, at tiny sizes on
seeded weights, on the CPU (where the port runs its kernels' plain
versions). In float32 the two compute the same functions, so they agree to
round-off; that is what lets the references judge the port on the card."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import torch

from outfitbench import inputs
from outfitbench.drivers import train
from outfitbench.drivers.common import Context, generator, program_config
from outfitbench.reference import optim as ref_optim, set_transformer as ref
from outfitbench.tests.conftest import ROOT, tiny_siglip, workload


def _port_model(cfg, weights, dtype="float32"):
    from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel

    pc = dataclasses.replace(program_config(cfg), compute_dtype=dtype)
    model = OutfitXModel(pc, device="cpu", trainable=True)
    model.load_state_dict(weights)
    return model


def _outfits(cfg, seed, b=6):
    gen = generator(seed, "cpu")
    (w,) = inputs.make_params(cfg, gen, "cpu")
    emb = inputs.make_catalog(cfg["catalog_items"], cfg["d_embed"], gen, "cpu")
    rows, mask, labels = inputs.cp_split_arrays(b, cfg["catalog_items"], cfg["max_outfit_len"],
                                                (2, 8), seed)
    return w, emb, torch.as_tensor(rows).long(), torch.as_tensor(mask), torch.as_tensor(labels)


def test_catalog_rows_have_unit_halves():
    emb = inputs.make_catalog(50, 32, generator(3, "cpu"), "cpu")
    norms = emb[:50].view(50, 2, 16).norm(dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)
    assert (emb[50] == 0).all()


def test_cp_forward_matches_the_port():
    cfg = tiny_siglip()
    w, emb, rows, mask, _ = _outfits(cfg, 11)
    model = _port_model(cfg, w).eval()
    with torch.no_grad():
        got = model.cp_forward(emb[rows], mask)
        want = ref.cp_logits(w, emb[rows], mask, cfg)
        assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_dropout_replays_the_trainings_draws():
    cfg = tiny_siglip()
    w, emb, rows, mask, _ = _outfits(cfg, 12)
    model = _port_model(cfg, w).train()
    seed = ref.stream_seed(2**31 + 9, 3, 1)
    got = model.cp_forward(emb[rows], mask, generator=generator(seed, "cpu"))
    want = ref.cp_logits(w, emb[rows], mask, cfg, ref.Dropout(cfg["dropout"], generator(seed, "cpu")))
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    plain = ref.cp_logits(w, emb[rows], mask, cfg)
    assert not torch.allclose(plain, want, atol=1e-3)


def test_stream_seed_is_the_programs():
    from outfitx_tpu_torch.core.rng import stream_seed

    for words in ((0, 0, 0), (2**31 + 5, 17, 3), (42, 1, 9)):
        assert ref.stream_seed(*words) == stream_seed(*words)


def test_focal_loss_matches_the_port():
    from outfitx_tpu_torch.losses import focal_loss

    g = torch.Generator().manual_seed(4)
    logits = torch.randn(64, generator=g) * 3
    labels = (torch.rand(64, generator=g) < 0.5).float()
    assert torch.allclose(ref.focal_loss(logits, labels), focal_loss(logits, labels), atol=1e-7)


def test_adamw_onecycle_matches_the_port():
    from outfitx_tpu_torch.core.config import OptimizerConfig
    from outfitx_tpu_torch.train.optim import AdamW, make_schedule

    opt_cfg = tiny_siglip()["optimizer"]
    total = 20
    sched = make_schedule(OptimizerConfig(**opt_cfg), total)
    for count in (0, 1, 5, 6, 7, 19, 20, 25):
        assert abs(ref_optim.onecycle_lr(opt_cfg, total, count) - sched(count)) < 1e-6 * sched(count) + 1e-12
    g = torch.Generator().manual_seed(5)
    p_port = [torch.nn.Parameter(torch.randn(7, 3, generator=g)), torch.nn.Parameter(torch.randn(5, generator=g))]
    p_ref = [p.detach().clone() for p in p_port]
    port = AdamW(p_port, OptimizerConfig(**opt_cfg), total)
    mine = ref_optim.AdamW(p_ref, opt_cfg, total)
    for step in range(6):
        grads = [torch.randn(p.shape, generator=g) * (0.1 if step % 2 else 3.0) for p in p_ref]
        for p, gr in zip(p_port, grads):
            p.grad = gr.clone()
        port.step()
        mine.step([gr.clone() for gr in grads])
        for a, b in zip(p_port, p_ref):
            assert torch.allclose(a.detach(), b, atol=1e-7, rtol=1e-6)


def test_training_reference_follows_the_programs_first_steps(tmp_path, monkeypatch):
    """In float32 the program's first steps (loss, first gradient,
    parameters' change, by leaf) and the reference's agree to round-off:
    the reference replays the same batches, dropout draws and update."""
    monkeypatch.chdir(tmp_path)
    cfg = dict(tiny_siglip(), compute_dtype="float32")
    params = workload("siglip.train_cp", batch=16, accumulation=2, outfits=200)
    ctx = Context(cell={"name": "t", "chips": 1}, config=cfg, params=params, seed=2**31 + 77,
                  seconds=0, trace=False, started=0.0, device="cpu")
    from outfitx_tpu_torch.train.steps import cp_train_step

    trainer = train.build(ctx)
    st = trainer.state
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    got = train.first_steps(lambda b: cp_train_step(st, trainer.catalog_dev, b), train._batches(trainer),
                            st.optimizer, names, 3, cfg["optimizer"]["b1"])
    want = train.reference_readings(ctx, names)
    gaps = train.gaps(got, want)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4, gaps
    assert gaps["grad_cos_gap_median"] < 1e-8, gaps
    assert len(got.leaves) == len(names) + 2 * 2 * cfg["n_layers"]


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        "import outfitbench.reference.set_transformer, outfitbench.reference.optim\n"
        "import outfitbench.reference.towers, outfitbench.reference.numerics\n"
        "from outfitbench.run import banned_modules\n"
        "print(banned_modules({'jax', 'jaxlib', 'flax', 'outfitx_tpu', 'outfitx_tpu_torch'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_banned_names_compare_whole():
    from outfitbench.run import banned_modules

    assert banned_modules(modules=["outfitx_tpu_torch.train.steps", "numpy", "jaxtyping"]) == []
    assert banned_modules(modules=["outfitx_tpu.core.config", "jax.numpy", "flax"]) == [
        "flax", "jax", "outfitx_tpu"]


def _tower_weights(cfg, seed):
    return inputs.encoder_params(cfg, generator(seed, "cpu"), "cpu")


def _ocp_cfg():
    cfg = json.loads((ROOT / "outfitbench/configs/outfitx-resnet-sbert.json").read_text())
    cfg.update(image_size=32, raw_items=24, text_positions=512)
    return cfg


def _f32_encoder(cfg, sd):
    from outfitx_tpu_torch.core.config import ItemEncoderConfig
    from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
    from outfitx_tpu_torch.models.towers.minilm import MiniLMConfig
    from outfitx_tpu_torch.models.towers.resnet import ResNet18Config

    enc = ItemEncoderModel(ItemEncoderConfig.for_type("resnet_sbert"), device="cpu",
                           vision_cfg=ResNet18Config(d_out=64, compute_dtype="float32"),
                           text_cfg=MiniLMConfig(d_out=64, compute_dtype="float32"))
    enc.load_state_dict(sd)
    return enc


def test_towers_match_the_port():
    from outfitbench.reference import towers

    cfg = _ocp_cfg()
    sd = _tower_weights(cfg, 21)
    images, ids, attn = (torch.as_tensor(x) for x in inputs.raw_items(23, cfg, generator(22, "cpu"), "cpu"))
    inputs.calibrate(sd, images)
    assert abs(float(sd["vision.layer4.1.bn2.running_var"].mean()) - 1.0) > 0.01
    enc = _f32_encoder(cfg, sd)
    with torch.no_grad():
        got = enc.encode(images, ids, attn)
        want = towers.item_embeddings(sd, cfg, images, ids, attn, block=10)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4)
    assert (attn[-1] == 0).all() and (attn[:-1].sum(1) >= 4).all()


def test_ocp_reference_follows_the_programs_first_steps(tmp_path, monkeypatch):
    """Original-CP in float32 (towers and set transformer): the program's
    first steps and the reference's agree to round-off."""
    import functools

    from outfitbench.drivers import train_ocp
    from outfitx_tpu_torch.models.towers.minilm import MiniLMConfig
    from outfitx_tpu_torch.models.towers.resnet import ResNet18Config
    from outfitx_tpu_torch.train import original_cp_trainer

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(original_cp_trainer, "ItemEncoderModel", functools.partial(
        original_cp_trainer.ItemEncoderModel,
        vision_cfg=ResNet18Config(d_out=64, compute_dtype="float32"),
        text_cfg=MiniLMConfig(d_out=64, compute_dtype="float32")))
    cfg = dict(_ocp_cfg(), compute_dtype="float32")
    params = workload("resnet-sbert.train_ocp", batch=3, accumulation=2, outfits=40)
    ctx = Context(cell={"name": "o", "chips": 1}, config=cfg, params=params, seed=2**31 + 78,
                  seconds=0, trace=False, started=0.0, device="cpu")
    job = train_ocp.ocp_job(ctx)
    got = train.first_steps(job.step, job.batches, job.optimizer, job.names, 2,
                            cfg["optimizer"]["b1"])
    job.close()
    want = train_ocp.reference_readings(ctx, job.names)
    gaps = train.gaps(got, want)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4, gaps
    assert gaps["grad_cos_gap_median"] < 1e-8, gaps
    assert any(n.startswith("encoder.vision.fc") for n in job.names)
