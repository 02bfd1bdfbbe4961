"""The PyTorch port's original-CP trainer (raw items through resnet_sbert's
towers inside the train step) against the JAX package's.

The JAX test's tiny towers (ResNet-18 with d_out 8 at 32 x 32, a MiniLM of
one layer 24 wide) and set transformer, in float32 on the CPU, dropout 0.
The weights go from the JAX trees to the port through ``models/from_jax.py``;
the raw items come from each package's ``RawItemSource.synthetic`` with one
seed. One train step (A=2) agrees with JAX's to 1e-4 in the loss, the scores
and the updated set transformer and encoder heads, and the eval step's
scores to 1e-4. The raw sources are bit-equal, synthetic and decoded from a
Polyvore-layout directory on disk.
"""

import numpy as np
import pytest
import torch

import jax
from outfitx_tpu.core import config as jcfg
from outfitx_tpu.data.synthetic import make_synthetic as jax_synthetic
from outfitx_tpu.models.item_encoder import ItemEncoderModel as JaxItemEncoder
from outfitx_tpu.models.towers.minilm import MiniLMConfig as JaxMiniLMConfig
from outfitx_tpu.models.towers.resnet import ResNet18Config as JaxResNetConfig
from outfitx_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from outfitx_tpu.train.original_cp_trainer import OriginalCPTrainer as JaxTrainer
from outfitx_tpu.train.original_cp_trainer import RawItemSource as JaxSource
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models.from_jax import item_encoder_state_dict_from_jax, state_dict_from_jax
from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
from outfitx_tpu_torch.models.towers.minilm import MiniLMConfig
from outfitx_tpu_torch.models.towers.resnet import ResNet18Config
from outfitx_tpu_torch.train.checkpoint import CheckpointManager
from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPTrainer, RawItemSource
from outfitx_tpu_torch.train.steps import original_cp_eval_step, original_cp_train_step

torch.set_num_threads(1)

TOL = 1e-4
N_ITEMS, IMAGE, TEXT_LEN, VOCAB = 200, 32, 12, 120
RESNET = dict(d_out=8, image_size=IMAGE, compute_dtype="float32")
MINILM = dict(vocab_size=VOCAB, max_len=TEXT_LEN, d_model=24, n_heads=4, d_mlp=48,
              n_layers=1, d_out=8, compute_dtype="float32")
ENCODER = dict(encoder_type="resnet_sbert", dim_per_modality=8)
TRANSFORMER = dict(n_heads=4, d_ffn=32, n_layers=1, dropout=0.0)
TRAIN = dict(n_epochs=1, batch_size=16, accumulation_steps=2)


def _configs(pkg, tmp):
    model_cfg = pkg.OutfitXConfig(
        item_encoder=pkg.ItemEncoderConfig(**ENCODER),
        transformer=pkg.TransformerConfig(**TRANSFORMER),
        max_outfit_len=8, compute_dtype="float32",
    )
    cfg = pkg.CPTrainConfig(
        **TRAIN, optimizer=pkg.OptimizerConfig(learning_rate=1e-3),
        checkpoint_dir=str(tmp / "ckpt"), log_dir=str(tmp / "logs"),
    )
    return model_cfg, cfg


def _host(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _encoder_params(frozen, heads):
    """The JAX encoder's full tree from the trainer's frozen backbones and
    trainable heads."""
    return {
        "vision": {**frozen["vision"], "fc": heads["fc"]},
        "text": {**frozen["text"], "proj": heads["proj"]},
    }


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX trainer (set up, its initial weights on the host) and the
    port's trainer on the CPU with the same weights, splits and source."""
    tmp = tmp_path_factory.mktemp("ocp")
    jd = jax_synthetic(n_items=N_ITEMS, d_embed=16, n_outfits=128, seed=9)
    td = make_synthetic(n_items=N_ITEMS, d_embed=16, n_outfits=128, seed=9)
    jenc = JaxItemEncoder(
        jcfg.ItemEncoderConfig(**ENCODER),
        vision_cfg=JaxResNetConfig(**RESNET), text_cfg=JaxMiniLMConfig(**MINILM),
    )
    jmodel_cfg, jtrain_cfg = _configs(jcfg, tmp / "jax")
    src = dict(n_items=N_ITEMS, image_size=IMAGE, text_len=TEXT_LEN, vocab=VOCAB, seed=3)
    jt = JaxTrainer(
        jtrain_cfg, jmodel_cfg, encoder=jenc, source=JaxSource.synthetic(**src),
        train_split=jd.cp_train, valid_split=jd.cp_valid,
    ).__enter__()
    params, frozen = _host(jt.state.params), _host(jt.frozen)

    model_cfg, train_cfg = _configs(tcfg, tmp / "torch")
    tenc = ItemEncoderModel(
        tcfg.ItemEncoderConfig(**ENCODER),
        vision_cfg=ResNet18Config(**RESNET), text_cfg=MiniLMConfig(**MINILM), device="cpu",
    )
    tenc.load_state_dict(
        item_encoder_state_dict_from_jax(_encoder_params(frozen, params["enc_heads"])),
        strict=True,
    )
    t = OriginalCPTrainer(
        train_cfg, model_cfg, encoder=tenc, source=RawItemSource.synthetic(**src),
        train_split=td.cp_train, valid_split=td.cp_valid, device="cpu",
    ).__enter__()
    t.model.load_state_dict(state_dict_from_jax(params["model"]), strict=True)
    yield {"jax": jt, "torch": t, "params": params, "frozen": frozen, "jd": jd, "tmp": tmp}
    jt.__exit__(ValueError, None, None)  # no final checkpoints
    t.__exit__(ValueError, None, None)


def test_raw_item_source_matches_jax():
    kw = dict(n_items=50, image_size=16, text_len=10, vocab=300, seed=5)
    want, got = JaxSource.synthetic(**kw), RawItemSource.synthetic(**kw)
    for name in ("image_bank", "input_ids", "attn"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    rows = np.random.default_rng(0).integers(0, 51, 37)
    w, g = want.gather(rows), got.gather(rows)
    assert sorted(g) == sorted(w)
    for k in w:
        assert np.array_equal(g[k], w[k]), k
    out = {k: np.empty_like(v) for k, v in w.items()}
    got.gather(rows, out=out)
    for k in w:
        assert np.array_equal(out[k], w[k]), k
    with pytest.raises(IndexError):
        got.gather(np.array([3, 51]))


def _comparable(sd, d):
    """The key bias's gradient is rounding noise in exact arithmetic, which
    Adam's first step turns into O(lr) updates in both packages: leave the
    key third of in_proj_bias out."""
    return {
        n: np.concatenate([t[:d], t[2 * d:]]) if n.endswith("in_proj_bias") else t
        for n, t in ((n, np.asarray(t)) for n, t in sd.items())
    }


def test_one_train_step_matches_jax(pair):
    jt, t = pair["jax"], pair["torch"]
    split = jt._train_split
    batch = next(jt._batches(split, 0))
    sels = next(t.step_selections(t._train_split, 0))
    # The same raw microbatches on both sides.
    mbs = [t.microbatch(t._train_split, sel) for sel in sels]
    for i, mb in enumerate(mbs):
        for k in ("images", "input_ids", "attn", "mask", "label"):
            assert np.array_equal(mb[k].numpy(), batch[k][i]), (i, k)
    new_state, jout = jt.train_step(jt.state, jt.frozen, batch)
    new = _host(new_state.params)
    jt.state = new_state
    out = original_cp_train_step(t.state, iter(mbs), alpha=0.75, gamma=2.0)
    assert t.state.step == 1 and t.state.optimizer.count == 1
    np.testing.assert_allclose(out["loss"].item(), float(jout["loss"]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out["scores"].detach().numpy(), np.asarray(jout["scores"]),
                               atol=TOL, rtol=TOL)
    d = t.model_cfg.d_embed
    want = _comparable({k: v.numpy() for k, v in state_dict_from_jax(new["model"]).items()}, d)
    got = _comparable({k: v.detach().numpy() for k, v in t.model.state_dict().items()}, d)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL, err_msg=k)
    heads = t.checkpoint_params()["enc_heads"]
    for head in ("fc", "proj"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(
                heads[head][leaf].detach().numpy(), new["enc_heads"][head][leaf],
                atol=TOL, rtol=TOL, err_msg=f"{head}.{leaf}",
            )
    # The heads moved: the step reached them.
    assert not np.allclose(new["enc_heads"]["fc"]["w"], pair["params"]["enc_heads"]["fc"]["w"])


def test_eval_step_matches_jax(pair):
    jt, t = pair["jax"], pair["torch"]
    split = t._valid_split
    rows, mask = split.item_rows[:16], split.mask[:16]
    raw = jt._source.gather(rows.ravel())
    batch = {k: v.reshape(16, 8, *v.shape[1:]) for k, v in raw.items()}
    batch["mask"] = mask
    # Both from the weights the packages hold now (equal after the step
    # test, or both initial when it runs alone).
    t.model.load_state_dict(state_dict_from_jax(_host(jt.state.params)["model"]))
    t.load_checkpoint_params({
        "params": t.model.state_dict(), "enc_heads": _host(jt.state.params)["enc_heads"],
    })
    want = np.asarray(jt.eval_step(jt.state.params, jt.frozen, batch))
    got = original_cp_eval_step(t.net, t.stage(rows, mask=mask)).numpy()
    assert got.shape == (16,)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_end_to_end_run_and_checkpoints_both_ways(pair, tmp_path):
    """A whole epoch on the port: finite metrics with an AUC, the frozen
    backbones bit-identical, the heads moved; the JAX manager restores the
    port's best checkpoint, and the port's trainer resumes from a JAX one."""
    td = make_synthetic(n_items=N_ITEMS, d_embed=16, n_outfits=128, seed=9)
    model_cfg, cfg = _configs(tcfg, tmp_path / "run")
    t = pair["torch"]
    enc = ItemEncoderModel(
        tcfg.ItemEncoderConfig(**ENCODER),
        vision_cfg=ResNet18Config(**RESNET), text_cfg=MiniLMConfig(**MINILM),
        device="cpu", seed=1,
    )
    source = RawItemSource.synthetic(N_ITEMS, IMAGE, TEXT_LEN, VOCAB, seed=3)
    with OriginalCPTrainer(
        cfg, model_cfg, encoder=enc, source=source,
        train_split=td.cp_train, valid_split=td.cp_valid, device="cpu",
    ) as run:
        before = {n: p.detach().clone() for n, p in enc.named_parameters()}
        metrics = run.run()
        live = {n: p.detach().clone() for n, p in run.model.named_parameters()}
        heads = {k: {a: b.detach().numpy().copy() for a, b in v.items()}
                 for k, v in run.checkpoint_params()["enc_heads"].items()}
    assert np.isfinite(metrics["loss"]) and 0.0 <= metrics["auc"] <= 1.0
    frozen = [n for n in before if not n.startswith(("vision.fc.", "text.proj."))]
    assert len(frozen) > 50
    after = dict(enc.named_parameters())
    for n in frozen:
        assert torch.equal(after[n], before[n]), n
        assert not after[n].requires_grad, n
    for n in ("vision.fc.weight", "vision.fc.bias", "text.proj.weight", "text.proj.bias"):
        assert not torch.equal(after[n], before[n]), n

    # The JAX manager restores the port's checkpoints as the JAX trainer's
    # tree; the final one holds the live parameters.
    jax_mgr = JaxCheckpoints(run.ckpt.dir.parent, run.ckpt.dir.name)
    assert jax_mgr.exists("best_auc") and jax_mgr.exists("final")
    restored = jax_mgr.restore("final")["params"]
    assert sorted(restored) == ["enc_heads", "model"]
    template = jax.tree.map(np.asarray, pair["params"])
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    for k, v in state_dict_from_jax(restored["model"]).items():
        assert torch.equal(v, live[k]), k
    for head in ("fc", "proj"):
        for leaf in ("w", "b"):
            assert np.array_equal(restored["enc_heads"][head][leaf], heads[head][leaf])

    # The port resumes from a JAX original-CP checkpoint.
    path = JaxCheckpoints(tmp_path / "jax_ckpt", "ocp").save("best_auc", params=pair["params"])
    payload = CheckpointManager(tmp_path / "jax_ckpt", "ocp").restore(path)
    t.load_checkpoint_params(payload)
    for k, v in state_dict_from_jax(pair["params"]["model"]).items():
        assert torch.equal(t.model.state_dict()[k], v), k
    np.testing.assert_array_equal(
        t.encoder.text.proj.weight.detach().numpy(), pair["params"]["enc_heads"]["proj"]["w"].T
    )


def test_original_cp_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OriginalCPTrainer(tcfg.CPTrainConfig())


def test_microbatches_reshape_to_outfits(pair):
    t = pair["torch"]
    split = t._train_split
    sel = np.arange(5)
    mb = t.microbatch(split, sel)
    assert tuple(mb["images"].shape) == (5, 8, 3, IMAGE, IMAGE)
    assert mb["images"].dtype == torch.uint8
    assert tuple(mb["input_ids"].shape) == (5, 8, TEXT_LEN)
    pad = split.item_rows[sel] == N_ITEMS
    assert pad.any() and bool((mb["images"].numpy()[pad] == 0).all())
    assert bool((mb["attn"].numpy()[pad] == 0).all())


def test_from_polyvore_matches_jax_and_trains(tmp_path):
    """The on-disk path: the metadata-only catalog, the JPEGs decoded once
    into the bank and the descriptions tokenized once give the JAX source's
    arrays bit for bit, and the trainer runs an epoch from that directory."""
    import pathlib
    import sys

    from outfitx_tpu.data.catalog import Catalog as JaxCatalog
    from outfitx_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
    from outfitx_tpu_torch.data.catalog import Catalog
    from outfitx_tpu_torch.data.tokenizer import load_tokenizer

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
    from make_synthetic_polyvore import generate

    root = tmp_path / "polyvore"
    generate(root, items=60, d_embed=16, outfits=64, image_size=IMAGE, seed=5)
    (root / "images" / "10001.jpg").unlink(missing_ok=True)  # a missing image stays zeros
    kw = dict(image_size=IMAGE, text_len=TEXT_LEN)
    want = JaxSource.from_polyvore(
        JaxCatalog.from_metadata_only(root), root,
        tokenizer=jax_load_tokenizer("", vocab_size=VOCAB), **kw,
    )
    catalog = Catalog.from_metadata_only(root)
    assert catalog.d_embed == 1 and catalog.n_items == 60
    got = RawItemSource.from_polyvore(
        catalog, root, tokenizer=load_tokenizer("", vocab_size=VOCAB), **kw,
    )
    for name in ("image_bank", "input_ids", "attn"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.image_bank[:60].any() and not got.image_bank[-1].any()

    enc_cfg = tcfg.ItemEncoderConfig(**ENCODER, text_model_name="")
    model_cfg = tcfg.OutfitXConfig(
        item_encoder=enc_cfg, transformer=tcfg.TransformerConfig(**TRANSFORMER),
        max_outfit_len=8, compute_dtype="float32",
    )
    cfg = tcfg.CPTrainConfig(**{**TRAIN, "accumulation_steps": 1}, dataset_dir=str(root),
                             checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"))
    enc = ItemEncoderModel(enc_cfg, vision_cfg=ResNet18Config(**RESNET),
                           text_cfg=MiniLMConfig(**MINILM), device="cpu")
    with OriginalCPTrainer(cfg, model_cfg, encoder=enc, device="cpu") as t:
        for name in ("image_bank", "input_ids", "attn"):
            assert np.array_equal(getattr(t._source, name), getattr(got, name)), name
        metrics = t.run()
    assert np.isfinite(metrics["loss"]) and "auc" in metrics
