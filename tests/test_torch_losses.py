"""The PyTorch port's losses against the JAX package's, values and
gradients, on the same numpy inputs in float32 (1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.losses import focal_loss as jax_focal
from outfitx_tpu.losses import set_wise_ranking_loss as jax_ranking
from outfitx_tpu_torch.losses import focal_loss, set_wise_ranking_loss

torch.set_num_threads(1)

TOL = 1e-6


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_focal_loss_matches_jax(reduction):
    rng = np.random.default_rng(0)
    logits = (3.0 * rng.standard_normal(64)).astype(np.float32)
    labels = (rng.random(64) < 0.5).astype(np.float32)

    def jf(x):
        return jnp.sum(jax_focal(x, jnp.asarray(labels), reduction=reduction))

    want, want_g = jax.value_and_grad(jf)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = focal_loss(x, torch.from_numpy(labels), reduction=reduction).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=TOL, atol=TOL)


def _ranking_inputs(seed=0, b=6, k=5, d=16):
    rng = np.random.default_rng(seed)
    pos, pred = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    negs = rng.standard_normal((b, k, d)).astype(np.float32)
    neg_mask = rng.random((b, k)) < 0.3
    neg_mask[0] = True  # a row whose negatives are all padding
    neg_mask[1] = False
    return pos, pred, negs, neg_mask


@pytest.mark.parametrize("margin", [2.0, 0.5])
def test_ranking_loss_matches_jax(margin):
    pos, pred, negs, neg_mask = _ranking_inputs()

    def jf(pos, pred, negs):
        return jax_ranking(pos, pred, negs, jnp.asarray(neg_mask), margin=margin)

    want, want_g = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (pos, pred, negs))
    )
    tp, tpred, tn = (torch.from_numpy(a).requires_grad_() for a in (pos, pred, negs))
    got = set_wise_ranking_loss(tp, tpred, tn, torch.from_numpy(neg_mask), margin=margin)
    got.backward()
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)
    for t, w in zip((tp, tpred, tn), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_ranking_loss_divides_by_the_global_valid_count():
    """L_all is normalised by the count of valid negatives over the whole
    batch, and the positive distance alone carries the 1e-6 eps."""
    pos, pred, negs, neg_mask = _ranking_inputs(seed=3)
    got = set_wise_ranking_loss(*(torch.from_numpy(a) for a in (pos, pred, negs, neg_mask)))
    d_pos = np.linalg.norm(pred - pos + 1e-6, axis=-1)
    d_neg = np.linalg.norm(pred[:, None] - negs, axis=-1)
    hinge = np.maximum(d_pos[:, None] - d_neg + 2.0, 0.0)
    l_all = (hinge * ~neg_mask).sum() / (~neg_mask).sum()
    hardest = np.where(neg_mask, np.inf, d_neg).min(axis=1)
    l_hard = np.maximum(d_pos - hardest + 2.0, 0.0).mean()
    np.testing.assert_allclose(got.item(), l_all + l_hard, rtol=1e-5)
