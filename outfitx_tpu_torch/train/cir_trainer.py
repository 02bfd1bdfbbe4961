"""Complementary-item-retrieval trainer (the port of
``outfitx_tpu/train/cir_trainer.py``).

Warm start from a CP checkpoint (either package's), the curriculum switch
from easy to hard negatives at ``switch_to_hard_epoch``, the set-wise
ranking loss with margin 2, Recall@{1,5,10,15,30,50} against the
per-category candidate pools every ``recall_every`` epochs and every epoch
after the switch, and best checkpoints only after the switch. Batches come
from the host sampler's python route (one int32 super-batch per step to the
device); the eval queries are staged on the device once. Under a mesh the
step takes each rank's rows of the super-batch, and the eval predictions
are gathered over the data axis, so loss and recall are computed whole on
every rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from outfitx_tpu_torch.core.config import CIRTrainConfig, OutfitXConfig
from outfitx_tpu_torch.data.catalog import Catalog
from outfitx_tpu_torch.data.sampler import (
    CandidatePools,
    NegativeSampler,
    cir_eval_queries,
    cir_train_batches,
    eval_batches,
    sample_negatives_batch,
)
from outfitx_tpu_torch.data.splits import OutfitSplit
from outfitx_tpu_torch.evalm.retrieval_eval import recall_over_pools
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.train.harness import Trainer
from outfitx_tpu_torch.train.optim import AdamW
from outfitx_tpu_torch.train.state import TrainState
from outfitx_tpu_torch.train.steps import (
    cir_eval_loss_step,
    cir_eval_step,
    cir_train_step,
)


class CIRTrainer(Trainer):
    def __init__(
        self,
        cfg: CIRTrainConfig,
        model_cfg: Optional[OutfitXConfig] = None,
        run_mode: str = "train-valid",
        *,
        catalog: Optional[Catalog] = None,
        train_split: Optional[OutfitSplit] = None,
        valid_split: Optional[OutfitSplit] = None,
        eval_batch_size: Optional[int] = None,
        pool_threshold: Optional[int] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(cfg, run_mode, device=device)
        self.model_cfg = model_cfg or OutfitXConfig()
        self._catalog = catalog
        self._train_split = train_split
        self._valid_split = valid_split
        self.eval_batch_size = eval_batch_size or cfg.batch_size
        # pool-eligibility threshold; small catalogs lower it
        self.pool_threshold = (
            pool_threshold if pool_threshold is not None else cfg.candidate_pool_size
        )

    @property
    def model_name(self) -> str:
        return f"{self.model_cfg.model_name}-cir"

    def best_metrics(self) -> Dict[str, str]:
        return {"recall@1": "max", "loss": "min"}

    # ------------------------------------------------------------ setup --
    def load_model(self) -> None:
        self.model = OutfitXModel(
            self.model_cfg, device=self.device, seed=self.cfg.seed, trainable=True
        )

    def load_optimizer(self) -> None:
        n_train = len(self._train_split) if self._train_split is not None else 0
        super_b = self.cfg.batch_size * self.cfg.accumulation_steps
        self.total_steps = max(n_train // super_b, 1) * self.cfg.n_epochs
        self.shard_model_params(self.model)
        optimizer = AdamW(
            self.model.parameters(), self.cfg.optimizer, self.total_steps, par=self.par
        )
        self.state = TrainState.create(self.model, optimizer, self.cfg.seed, par=self.par)

    def setup_data(self) -> None:
        if self._catalog is None:
            self._catalog = Catalog.from_polyvore(
                self.cfg.dataset_dir, model_name=self.model_cfg.model_name
            )
            self._train_split = OutfitSplit.load(
                self._catalog, self.cfg.dataset_dir, self.cfg.polyvore_type,
                "train", self.model_cfg.max_outfit_len,
            )
            eval_mode = "test" if self.run_mode == "test" else "valid"
            # the positive-eligibility rule shares the pool threshold
            self._valid_split = OutfitSplit.load(
                self._catalog, self.cfg.dataset_dir, self.cfg.polyvore_type,
                eval_mode, self.model_cfg.max_outfit_len,
                large_category_threshold=self.pool_threshold,
            )
        dev = self.device
        self.catalog_dev = torch.as_tensor(self._catalog.embeddings, device=dev)
        self._samplers = {
            "easy": NegativeSampler(self._catalog, "easy"),
            "hard": NegativeSampler(self._catalog, "hard"),
        }
        q = self._eval_queries = cir_eval_queries(
            self._valid_split, self._catalog,
            seed=self.cfg.seed, max_len=self.model_cfg.max_outfit_len,
        )
        self._pools = CandidatePools.build(
            self._catalog, self._valid_split,
            pool_size=self.cfg.candidate_pool_size,
            threshold=self.pool_threshold, seed=self.cfg.seed,
        )
        self._eval_pos_idx_dev = torch.as_tensor(q["pos_idx"], device=dev)
        self._eval_batches = []
        valid = []
        for b in eval_batches(
            {k: q[k] for k in ("item_idx", "mask", "pos_idx")},
            batch_size=self.eval_batch_size,
        ):
            self._eval_batches.append(
                {k: torch.as_tensor(b[k], device=dev) for k in ("item_idx", "mask", "pos_idx")}
            )
            valid.append(b["valid"])
        self._eval_valid_idx_dev = torch.as_tensor(
            np.flatnonzero(np.concatenate(valid)) if valid else np.zeros(0, np.int64),
            device=dev,
        )
        self.log(
            f"CIR data: train {len(self._train_split)} outfits, valid "
            f"{len(self._valid_split)}; {len(self._pools.pools)} candidate "
            f"pools x {self._pools.pool_size}"
        )

    def hook_after_setup(self) -> None:
        """Warm start: parameters from a CP checkpoint."""
        path = self.cfg.warm_start_from
        if path:
            payload = self.ckpt.restore(path)
            self.load_params(self.model, payload["params"])
            self.log(f"warm-started params from {path}")

    # ------------------------------------------------------------ train --
    def _mode_for_epoch(self, epoch: int) -> str:
        return "easy" if epoch < self.cfg.switch_to_hard_epoch else "hard"

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        mode = self._mode_for_epoch(epoch)
        losses = []
        for batch in cir_train_batches(
            self._train_split,
            self._catalog,
            batch_size=self.cfg.batch_size,
            accum_steps=self.cfg.accumulation_steps,
            epoch=epoch,
            seed=self.cfg.seed,
            n_negatives=self.cfg.n_negatives,
            sample_mode=mode,
            max_len=self.model_cfg.max_outfit_len,
            sampler=self._samplers[mode],
        ):
            batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
            out = cir_train_step(
                self.state, self.catalog_dev, batch, margin=self.cfg.margin
            )
            losses.append(out["loss"])
        if not losses:
            return {}
        return {
            "loss": float(np.mean(torch.stack(losses).cpu().numpy(), dtype=np.float64)),
            "neg_mode": 1.0 if mode == "hard" else 0.0,
        }

    # ------------------------------------------------------------- eval --
    def _predict_targets(self) -> torch.Tensor:
        """y_hats (n, D) on the device for all eval queries."""
        if len(self._eval_queries["pos_idx"]) == 0:
            return torch.zeros((0, self._catalog.d_embed), device=self.device)
        outs = []
        for b in self._eval_batches:
            b = self.rows(b)
            outs.append(self.gather_rows(cir_eval_step(
                self.state.model, self.catalog_dev,
                b["item_idx"], b["mask"], b["pos_idx"],
            )))
        return torch.cat(outs).index_select(0, self._eval_valid_idx_dev)

    def _eval_loss(self, epoch: int, y_hats: torch.Tensor) -> float:
        """Ranking loss on the eval queries with freshly sampled negatives;
        ``y_hats`` is the epoch's one eval sweep, shared with recall."""
        neg_idx, neg_mask = sample_negatives_batch(
            self._samplers[self._mode_for_epoch(epoch)],
            self._eval_queries["pos_idx"],
            k=self.cfg.n_negatives, seed=self.cfg.seed, epoch=epoch,
        )
        loss = cir_eval_loss_step(
            self.catalog_dev, y_hats, self._eval_pos_idx_dev,
            torch.as_tensor(neg_idx, device=self.device),
            torch.as_tensor(neg_mask, device=self.device),
            margin=self.cfg.margin,
        )
        return float(loss)

    def _recall(self, y_hats: torch.Tensor) -> Dict[str, float]:
        q = self._eval_queries
        return recall_over_pools(
            y_hats, q["pos_idx"], q["pos_category"], self._pools,
            self.catalog_dev, ks=self.cfg.recall_ks,
        )

    def valid_epoch(self, epoch: int) -> Dict[str, float]:
        y_hats = self._predict_targets()
        metrics: Dict[str, float] = {"loss": self._eval_loss(epoch, y_hats)}
        after_switch = epoch >= self.cfg.switch_to_hard_epoch
        if epoch % self.cfg.recall_every == 0 or after_switch:
            metrics.update(self._recall(y_hats))
        # checkpoints only after the curriculum switch
        if after_switch and "recall@1" in metrics:
            self.maybe_save_best(metrics, epoch=epoch)
        return metrics

    def test(self) -> Dict[str, float]:
        return self._recall(self._predict_targets())
