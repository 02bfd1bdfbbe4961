"""Asynchronous checkpoint saves in the PyTorch port
(``train/checkpoint.py save_async``, the harness's ``async_saves``).

``save_async`` followed by ``wait`` writes the same bytes as ``save``; the
host copy is taken before ``save_async`` returns, so an in-place update
right after it does not reach the file; a failed write is raised by
``wait`` or the next ``save_async``; a trainer with ``async_saves`` resumes
to the state a synchronous one saved; and the JAX ``CheckpointManager``
restores an asynchronous checkpoint. The harness's ``profile_dir`` writes a
trace of epoch 1. At the ``tiny_cfg`` scale on the CPU.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
from outfitx_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models import OutfitXModel, state_dict_from_jax
from outfitx_tpu_torch.models.from_jax import jax_params_from_state_dict
from outfitx_tpu_torch.train.checkpoint import CheckpointManager, adam_state, optimizer_tree
from outfitx_tpu_torch.train.cp_trainer import CPTrainer
from outfitx_tpu_torch.train.optim import AdamW

torch.set_num_threads(1)

FILES = ("state.npz", "tree.json", "meta.json")


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


@pytest.fixture()
def trained(tiny_cfg):
    """A model with an optimizer one step in, so every tree is non-trivial."""
    model = OutfitXModel(port_config(tiny_cfg), device="cpu", seed=3, trainable=True)
    opt = AdamW(model.parameters(), tcfg.OptimizerConfig(), 10)
    for p in opt.params:
        p.grad = torch.full_like(p, 0.01)
    opt.step()
    return model, opt


def _state(model, opt):
    return dict(
        params=model.state_dict(), opt_state=optimizer_tree(model, opt), step=1,
        epoch=2, metrics={"auc": 0.75}, config=tcfg.CPTrainConfig(), best={"auc": 0.75},
    )


def _bytes(path):
    return {name: (path / name).read_bytes() for name in FILES}


def test_async_save_writes_the_bytes_of_a_sync_save(tmp_path, trained):
    mgr = CheckpointManager(tmp_path, "m")
    sync = mgr.save("sync", **_state(*trained))
    mgr.save_async("async", **_state(*trained))
    mgr.wait()
    assert _bytes(mgr.path("async")) == _bytes(sync)
    # and two saves of one state are equal bytes whatever the clock says
    again = mgr.save("sync", **_state(*trained))
    assert _bytes(again) == _bytes(mgr.path("async"))


def test_update_after_save_async_does_not_reach_the_file(tmp_path, trained):
    model, opt = trained
    mgr = CheckpointManager(tmp_path, "m")
    want = {k: v.clone() for k, v in model.state_dict().items()}
    want_mu = [m.clone() for m in opt.mu]
    for i in range(3):  # newest of a tag wins; earlier queued ones may go
        mgr.save_async("latest", **_state(model, opt))
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)  # in place, as the optimizer updates
            for m in opt.mu:
                m.add_(1.0)
        if i < 2:
            want = {k: v + 1.0 for k, v in want.items()}
            want_mu = [m + 1.0 for m in want_mu]
    payload = mgr.restore("latest")  # waits for the queue
    for k, v in payload["params"].items():
        assert torch.equal(v, want[k]), k
    names = [n for n, _ in model.named_parameters()]
    mu = state_dict_from_jax(adam_state(payload["opt_state"])[1])
    for n, m in zip(names, want_mu):
        np.testing.assert_array_equal(mu[n], m.numpy())


def test_failed_write_is_raised(tmp_path, trained):
    mgr = CheckpointManager(tmp_path, "m")
    # A file where the writer makes its temporary directory.
    (mgr.dir / f".bad.tmp{os.getpid()}").write_text("in the way")
    mgr.save_async("bad", **_state(*trained))
    with pytest.raises(RuntimeError, match="async checkpoint save failed") as err:
        mgr.wait()
    assert isinstance(err.value.__cause__, FileExistsError)
    mgr.wait()  # raised once
    mgr.save_async("bad", **_state(*trained))
    mgr._drain()
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.save_async("good", **_state(*trained))
    mgr.save_async("good", **_state(*trained))
    mgr.wait()
    assert mgr.exists("good") and not mgr.exists("bad")


def test_jax_manager_restores_an_async_checkpoint(tmp_path, trained):
    model, opt = trained
    mgr = CheckpointManager(tmp_path, "m")
    mgr.save_async("best_auc", **_state(model, opt))
    mgr.wait()
    payload = JaxCheckpoints(tmp_path, "m").restore("best_auc")
    want = jax_params_from_state_dict(model.state_dict())
    assert jax.tree.structure(payload["params"]) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(payload["params"]), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(got), ref)
    assert payload["meta"]["epoch"] == 2 and payload["meta"]["best"] == {"auc": 0.75}
    adam, schedule = payload["opt_state"][1][0], payload["opt_state"][1][2]
    assert int(adam[0]) == int(schedule[0]) == 1


def _run(tiny_cfg, data, root, *, async_saves, n_epochs=2, profile_dir=None):
    cfg = tcfg.CPTrainConfig(
        n_epochs=n_epochs, batch_size=16, accumulation_steps=2, seed=5,
        save_every_epochs=1, async_saves=async_saves,
        checkpoint_dir=str(root / "ckpt"), log_dir=str(root / "logs"),
    )
    with CPTrainer(cfg, port_config(tiny_cfg), catalog=data.catalog,
                   train_split=data.cp_train, valid_split=data.cp_valid,
                   device="cpu") as t:
        t.profile_dir = profile_dir
        t.run()
    return t


def test_trainer_with_async_saves_resumes_to_the_sync_state(tiny_cfg, tmp_path):
    data = make_synthetic(n_items=300, d_embed=64, n_outfits=96, seed=2)
    sync = _run(tiny_cfg, data, tmp_path / "sync", async_saves=False)
    asyn = _run(tiny_cfg, data, tmp_path / "async", async_saves=True,
                profile_dir=str(tmp_path / "trace"))
    for tag in ("latest", "best_auc", "best_loss", "final"):
        a, s = asyn.ckpt.restore(tag), sync.ckpt.restore(tag)
        for k in s["params"]:
            assert torch.equal(a["params"][k], s["params"][k]), (tag, k)
        meta_a = {k: v for k, v in a["meta"].items() if k != "config"}
        meta_s = {k: v for k, v in s["meta"].items() if k != "config"}
        assert meta_a == meta_s, tag
        assert a["meta"]["config"]["async_saves"] and not s["meta"]["config"]["async_saves"]
    # Resuming from the async 'latest' gives the trained state back.
    cfg = dataclasses.replace(asyn.cfg, checkpoint_dir=str(tmp_path / "resumed"))
    with CPTrainer(cfg, port_config(tiny_cfg), catalog=data.catalog,
                   train_split=data.cp_train, valid_split=data.cp_valid,
                   device="cpu") as t:
        t.resume(str(asyn.ckpt.path("latest")))
        assert t.epoch == 2 and t.state.step == asyn.state.step > 0
        live = asyn.model.state_dict()
        for k, v in t.model.state_dict().items():
            assert torch.equal(v, live[k]), k
        for a, b in zip(t.state.optimizer.nu, asyn.state.optimizer.nu):
            assert torch.equal(a, b)
    # The trace of epoch 1.
    (trace,) = (tmp_path / "trace").glob("*epoch1.trace.json")
    assert "traceEvents" in json.loads(trace.read_text())
