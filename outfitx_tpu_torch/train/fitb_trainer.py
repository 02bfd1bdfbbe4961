"""Fill-in-the-blank evaluator (the port of
``outfitx_tpu/train/fitb_trainer.py``).

Test-only: any other run mode raises. The parameters come from
``cfg.checkpoint_from``, a CIR checkpoint of either package. Each question
picks, among its candidates, the one nearest (L2) the CIR prediction for
the partial outfit; the ground-truth answer's text half conditions the
prediction, as the reference's FITB dataset passes the answer as the
target. Accuracy is the share of questions whose pick is the answer.
Under a mesh each rank picks for its rows of every batch and the picks
are gathered over the data axis.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from outfitx_tpu_torch.core.config import FITBTrainConfig, OutfitXConfig
from outfitx_tpu_torch.data.catalog import Catalog
from outfitx_tpu_torch.data.sampler import eval_batches
from outfitx_tpu_torch.data.splits import FITBSplit
from outfitx_tpu_torch.evalm import fitb_accuracy
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.train.harness import Trainer
from outfitx_tpu_torch.train.steps import fitb_eval_step


class FITBTrainer(Trainer):
    def __init__(
        self,
        cfg: FITBTrainConfig,
        model_cfg: Optional[OutfitXConfig] = None,
        run_mode: str = "test",
        *,
        catalog: Optional[Catalog] = None,
        test_split: Optional[FITBSplit] = None,
        eval_batch_size: int = 512,
        device: str | torch.device = "cuda",
    ):
        if run_mode != "test":
            raise ValueError("FITB supports run_mode='test' only")
        super().__init__(cfg, run_mode, device=device)
        self.model_cfg = model_cfg or OutfitXConfig()
        self._catalog = catalog
        self._test_split = test_split
        self.eval_batch_size = eval_batch_size

    @property
    def model_name(self) -> str:
        return f"{self.model_cfg.model_name}-fitb"

    def load_model(self) -> None:
        self.model = OutfitXModel(self.model_cfg, device=self.device, seed=self.cfg.seed)

    def load_optimizer(self) -> None:  # evaluation only
        self.shard_model_params(self.model)

    def setup_data(self) -> None:
        if self._catalog is None:
            self._catalog = Catalog.from_polyvore(
                self.cfg.dataset_dir, model_name=self.model_cfg.model_name
            )
            self._test_split = FITBSplit.load(
                self._catalog, self.cfg.dataset_dir, self.cfg.polyvore_type,
                "test", self.model_cfg.max_outfit_len,
            )
        self.catalog_dev = torch.as_tensor(self._catalog.embeddings, device=self.device)
        self.log(f"FITB: {len(self._test_split)} questions")

    def hook_after_setup(self) -> None:
        path = self.cfg.checkpoint_from
        if path:
            self.load_params(self.model, self.ckpt.restore(path)["params"])
            self.log(f"loaded params from {path}")

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        raise NotImplementedError("FITB is test-only")

    valid_epoch = train_epoch

    def predict(self) -> Dict[str, np.ndarray]:
        """Every question's pick and answer index."""
        split = self._test_split
        answer_rows = split.cand_rows[np.arange(len(split)), split.answer_idx]
        picks, valids, answers = [], [], []
        for batch in eval_batches(
            {
                "item_idx": split.item_rows,
                "mask": split.mask,
                "cand_rows": split.cand_rows,
                "answer_rows": answer_rows.astype(np.int32),
                "answer_idx": split.answer_idx,
            },
            batch_size=self.eval_batch_size,
        ):
            dev = self.rows({
                k: torch.as_tensor(batch[k], device=self.device)
                for k in ("item_idx", "mask", "cand_rows", "answer_rows")
            })
            picks.append(self.gather_rows(fitb_eval_step(
                self.model, self.catalog_dev, dev["item_idx"], dev["mask"],
                dev["cand_rows"], dev["answer_rows"],
            )).cpu().numpy())
            valids.append(batch["valid"])
            answers.append(batch["answer_idx"])
        valid = np.concatenate(valids)
        return {
            "picks": np.concatenate(picks)[valid],
            "answers": np.concatenate(answers)[valid],
        }

    def test(self) -> Dict[str, float]:
        out = self.predict()
        return {"accuracy": fitb_accuracy(out["picks"], out["answers"])}
