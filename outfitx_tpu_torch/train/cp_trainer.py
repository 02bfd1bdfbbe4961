"""Compatibility-prediction trainer (the port of
``outfitx_tpu/train/cp_trainer.py``).

Focal loss (alpha 0.75, gamma 2), AdamW + OneCycle over a horizon set by the
train split's length, gradient accumulation and clip 1.0; epoch-level
AUC/Acc/P/R/F1 from the logits of the whole epoch; best checkpoints on AUC
and loss. The split is staged on the device once and each super-batch is
gathered there by the epoch's stateless shuffle order.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from outfitx_tpu_torch.core.config import CPTrainConfig, OutfitXConfig
from outfitx_tpu_torch.data.catalog import Catalog
from outfitx_tpu_torch.data.sampler import cp_epoch_order, eval_batches
from outfitx_tpu_torch.data.splits import CPSplit
from outfitx_tpu_torch.evalm import binary_classification_metrics
from outfitx_tpu_torch.losses import focal_loss
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.train.harness import Trainer
from outfitx_tpu_torch.train.optim import AdamW
from outfitx_tpu_torch.train.state import TrainState
from outfitx_tpu_torch.train.steps import cp_eval_step, cp_train_step


class CPTrainer(Trainer):
    def __init__(
        self,
        cfg: CPTrainConfig,
        model_cfg: Optional[OutfitXConfig] = None,
        run_mode: str = "train-valid",
        *,
        catalog: Optional[Catalog] = None,
        train_split: Optional[CPSplit] = None,
        valid_split: Optional[CPSplit] = None,
        eval_batch_size: Optional[int] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(cfg, run_mode, device=device)
        self.model_cfg = model_cfg or OutfitXConfig()
        self._catalog = catalog
        self._train_split = train_split
        self._valid_split = valid_split
        self.eval_batch_size = eval_batch_size or cfg.batch_size

    @property
    def model_name(self) -> str:
        return f"{self.model_cfg.model_name}-cp"

    def best_metrics(self) -> Dict[str, str]:
        return {"auc": "max", "loss": "min"}

    # ------------------------------------------------------------ setup --
    def load_model(self) -> None:
        self.model = OutfitXModel(
            self.model_cfg, device=self.device, seed=self.cfg.seed, trainable=True
        )

    def load_optimizer(self) -> None:
        n_train = len(self._train_split) if self._train_split is not None else 0
        super_b = self.cfg.batch_size * self.cfg.accumulation_steps
        self.total_steps = max(n_train // super_b, 1) * self.cfg.n_epochs
        optimizer = AdamW(self.model.parameters(), self.cfg.optimizer, self.total_steps)
        self.state = TrainState.create(self.model, optimizer, self.cfg.seed)

    def setup_data(self) -> None:
        if self._catalog is None:
            self._catalog = Catalog.from_polyvore(
                self.cfg.dataset_dir, model_name=self.model_cfg.model_name
            )
            self._train_split = CPSplit.load(
                self._catalog, self.cfg.dataset_dir, self.cfg.polyvore_type,
                "train", self.model_cfg.max_outfit_len,
            )
            eval_mode = "test" if self.run_mode == "test" else "valid"
            self._valid_split = CPSplit.load(
                self._catalog, self.cfg.dataset_dir, self.cfg.polyvore_type,
                eval_mode, self.model_cfg.max_outfit_len,
            )
        dev = self.device
        self.catalog_dev = torch.as_tensor(self._catalog.embeddings, device=dev)
        s = self._train_split
        self._train_dev = {
            "item_idx": torch.as_tensor(s.item_rows, device=dev),
            "mask": torch.as_tensor(s.mask, device=dev),
            "label": torch.as_tensor(s.labels, device=dev),
        }
        self._eval_batches = self._stage_eval(self._valid_split)
        self.log(
            f"catalog: {self._catalog.n_items} items x {self._catalog.d_embed}d; "
            f"train {len(self._train_split)}, valid {len(self._valid_split)} outfits"
        )

    def _stage_eval(self, split: CPSplit):
        """Fixed-shape eval batches on the device, with the host labels and
        the wrap-around 'valid' mask for the metrics."""
        return [
            (
                {k: torch.as_tensor(b[k], device=self.device)
                 for k in ("item_idx", "mask", "label")},
                b["label"],
                b["valid"],
            )
            for b in eval_batches(
                {"item_idx": split.item_rows, "mask": split.mask, "label": split.labels},
                batch_size=self.eval_batch_size,
            )
        ]

    # ------------------------------------------------------------ train --
    def _iter_train_batches(self, epoch: int):
        n = len(self._train_split)
        a, b = self.cfg.accumulation_steps, self.cfg.batch_size
        order = torch.as_tensor(
            cp_epoch_order(n, seed=self.cfg.seed, epoch=epoch), device=self.device
        )
        s = self._train_dev
        for start in range(0, n - a * b + 1, a * b):
            sel = order[start : start + a * b]
            yield {
                "item_idx": s["item_idx"][sel].reshape(a, b, -1),
                "mask": s["mask"][sel].reshape(a, b, -1),
                "label": s["label"][sel].reshape(a, b),
            }

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        losses, scores, labels = [], [], []
        log_every = self.cfg.log_every_steps
        for step_i, batch in enumerate(self._iter_train_batches(epoch)):
            out = cp_train_step(
                self.state, self.catalog_dev, batch,
                alpha=self.cfg.focal_alpha, gamma=self.cfg.focal_gamma,
            )
            losses.append(out["loss"])
            scores.append(out["scores"])
            labels.append(out["labels"])
            if log_every and (step_i + 1) % log_every == 0:
                self.metrics_log.log(
                    "train_batch", epoch, {"loss": float(out["loss"])},
                    step=self.state.step,
                )
        if not losses:
            return {}
        # One host sync at the epoch's end.
        metrics = binary_classification_metrics(
            torch.cat([s.reshape(-1) for s in scores]).cpu().numpy(),
            torch.cat([y.reshape(-1) for y in labels]).cpu().numpy(),
            from_logits=True,
        )
        metrics["loss"] = float(np.mean(torch.stack(losses).cpu().numpy(), dtype=np.float64))
        return metrics

    def _eval_split(self, batches) -> Dict[str, float]:
        scores_all, labels_all, valid_all, losses = [], [], [], []
        for batch, label_host, valid in batches:
            s = cp_eval_step(
                self.state.model, self.catalog_dev, batch["item_idx"], batch["mask"]
            )
            # per-example loss, so the wrap-around rows leave the mean too
            losses.append(focal_loss(
                s, batch["label"], alpha=self.cfg.focal_alpha,
                gamma=self.cfg.focal_gamma, reduction="none",
            ).cpu().numpy())
            scores_all.append(s.cpu().numpy())
            labels_all.append(label_host)
            valid_all.append(valid)
        if not scores_all:
            return {}
        valid = np.concatenate(valid_all)
        metrics = binary_classification_metrics(
            np.concatenate(scores_all)[valid],
            np.concatenate(labels_all)[valid],
            from_logits=True,
        )
        metrics["loss"] = float(np.mean(np.concatenate(losses)[valid]))
        return metrics

    def valid_epoch(self, epoch: int) -> Dict[str, float]:
        metrics = self._eval_split(self._eval_batches)
        if metrics:
            self.maybe_save_best(metrics, epoch=epoch)
        return metrics

    def test(self) -> Dict[str, float]:
        return self._eval_split(self._eval_batches)
