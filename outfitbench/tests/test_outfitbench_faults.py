"""``correct`` comes out false when the timed path is broken underneath,
and when the control takes the program's place. Each test drives the rest
of a run on the CPU at a tiny size (the look for a card is run.py's, which
these skip), with a fault planted in the program: a step that returns its
state unchanged; every outfit scored but the loss and gradient taken over
half of each microbatch, the mean over that half. The limits are set from
this size's own sound readings (below): a few outfits a microbatch read
far above the cells' own sizes."""

from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from outfitbench import controls
from outfitbench.drivers import train, train_ocp
from outfitbench.drivers.common import Context
from outfitbench.tests.conftest import ROOT, tiny_siglip, workload

# Over a dozen seeds at these sizes sound runs read at most: CP loss 0.0041,
# grad 0.0088, change 0.035, gradient cosine 0.0002 (the control 0.006 at
# least); original-CP (4 outfits a microbatch) loss 0.064, grad 0.086,
# change 0.050, gradient cosine 0.0013 (the control 0.041 at least); both
# the loss against their own logits under 5e-6 (the half-batch fault 0.16
# at least).
TINY_CP_LIMITS = {"loss_gap": 0.01, "grad_gap": 0.02, "change_gap": 0.08,
                  "grad_cos_gap_median": 0.002, "loss_logit_gap": 1e-4}
TINY_OCP_LIMITS = {"loss_gap": 0.15, "grad_gap": 0.2, "change_gap": 0.12,
                   "grad_cos_gap_median": 0.01, "loss_logit_gap": 1e-4}


def _train_ctx(tmp_path, monkeypatch, faults=None, seed=2**31 + 101):
    monkeypatch.chdir(tmp_path)
    params = workload("siglip.train_cp", batch=16, accumulation=2, outfits=200,
                      limits=TINY_CP_LIMITS)
    return Context(cell={"name": "siglip.train_cp", "chips": 1}, config=tiny_siglip(),
                   params=params, seed=seed, seconds=0.5, trace=False,
                   started=time.perf_counter(), device="cpu", faults=faults or {})


def _unchanged(state, catalog, batch, **kw):
    """The step runs, and its state comes back as it was."""
    from outfitx_tpu_torch.train.steps import cp_train_step

    opt = state.optimizer
    keep = ([p.detach().clone() for p in opt.params], copy.deepcopy(opt.mu), copy.deepcopy(opt.nu),
            opt.count, state.step)
    out = cp_train_step(state, catalog, batch, **kw)
    with torch.no_grad():
        for p, v in zip(opt.params, keep[0]):
            p.copy_(v)
    opt.mu, opt.nu, opt.count, state.step = keep[1], keep[2], keep[3], keep[4]
    return out


def _half_loss(step):
    """``step`` with every outfit scored and the loss (and so the gradient)
    over the first half of each microbatch, the mean taken over that half."""

    def faulty(*args, **kw):
        from outfitx_tpu_torch.train import steps

        focal = steps._focal

        def half(scores, labels, par, **k):
            n = scores.shape[0] // 2
            return focal(scores[:n], labels[:n], par, **k)

        steps._focal = half
        try:
            return step(*args, **kw)
        finally:
            steps._focal = focal

    return faulty


def _half_batch(state, catalog, batch, **kw):
    from outfitx_tpu_torch.train.steps import cp_train_step

    return _half_loss(cp_train_step)(state, catalog, batch, **kw)


def _ocp_ctx(tmp_path, monkeypatch, faults=None, seed=2**31 + 303):
    monkeypatch.chdir(tmp_path)
    cfg = json.loads((ROOT / "outfitbench/configs/outfitx-resnet-sbert.json").read_text())
    cfg.update(image_size=32, raw_items=64)
    params = workload("resnet-sbert.train_ocp", batch=4, accumulation=2, outfits=48,
                      limits=TINY_OCP_LIMITS)
    return Context(cell={"name": "resnet-sbert.train_ocp", "chips": 1}, config=cfg,
                   params=params, seed=seed, seconds=0.5, trace=False,
                   started=time.perf_counter(), device="cpu", faults=faults or {})


def _ocp_unchanged(state, microbatches, **kw):
    from outfitx_tpu_torch.train.steps import original_cp_train_step

    opt = state.optimizer
    keep = ([p.detach().clone() for p in opt.params], copy.deepcopy(opt.mu), copy.deepcopy(opt.nu),
            opt.count, state.step)
    out = original_cp_train_step(state, microbatches, **kw)
    with torch.no_grad():
        for p, v in zip(opt.params, keep[0]):
            p.copy_(v)
    opt.mu, opt.nu, opt.count, state.step = keep[1], keep[2], keep[3], keep[4]
    return out


def _ocp_half_batch(state, microbatches, **kw):
    from outfitx_tpu_torch.train.steps import original_cp_train_step

    return _half_loss(original_cp_train_step)(state, microbatches, **kw)


CELLS = {"train_cp": (train.run, _train_ctx, _unchanged, _half_batch),
         "train_ocp": (train_ocp.run, _ocp_ctx, _ocp_unchanged, _ocp_half_batch)}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_training_run_is_correct(tmp_path, monkeypatch, cell):
    run, make_ctx, _, _ = CELLS[cell]
    out = run(make_ctx(tmp_path, monkeypatch))
    assert out.correct, out.checks
    assert out.metrics[make_ctx(tmp_path, monkeypatch).params["rate_metric"]] > 0 and out.attempted > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_broken_training_step_is_not_correct(tmp_path, monkeypatch, cell, fault):
    run, make_ctx, unchanged, half = CELLS[cell]
    step = unchanged if fault == "unchanged" else half
    out = run(make_ctx(tmp_path, monkeypatch, {"step": step}))
    assert not out.correct, out.checks


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_training_control_fails_a_limit(tmp_path, monkeypatch, cell):
    """controls.py's readings on one seed: the program is correct, the
    control (the reference in float8 in the program's place) and the
    half-batch fault planted in the reference are not. At the cells' own
    sizes the same readings come from the card."""
    _, make_ctx, _, _ = CELLS[cell]
    readings = controls.readings(make_ctx(tmp_path, monkeypatch))
    assert readings["program"]["correct"], readings
    assert not readings["control"]["correct"], readings
    assert not readings["half_batch"]["correct"], readings
