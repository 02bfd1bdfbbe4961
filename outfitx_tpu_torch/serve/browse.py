"""Dataset-sample browsing views for the serving engine (the port of
``outfitx_tpu/serve/browse.py``).

Sample test-split rows and render the ground truth next to the model's
prediction. ``BrowseViews`` is an engine mixin: read-only surfaces over the
engine's task methods and splits.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class BrowseViews:
    """Engine mixin: sample_* browsing endpoints + outfit sampling."""

    def sample_outfit(self, n: int = 4) -> List[int]:
        rows = self._rng.choice(self.catalog.n_items, n, replace=False)
        return [int(self.catalog.item_ids[r]) for r in rows]

    def _row_ids(self, rows, mask_row) -> List[int]:
        return [
            int(self.catalog.item_ids[r])
            for r, pad in zip(rows, mask_row)
            if not pad
        ]

    def sample_cp(self, n: int = 4) -> List[Dict]:
        """n random CP test rows: outfit items + true label + predicted
        probability."""
        if self.cp_split is None:
            raise ValueError("no CP test split loaded")
        idx = self._rng.choice(len(self.cp_split), min(n, len(self.cp_split)),
                               replace=False)
        outfits = [
            self._row_ids(self.cp_split.item_rows[i], self.cp_split.mask[i])
            for i in idx
        ]
        probs = self.cp_score_batch(outfits)
        return [
            {
                "items": [
                    self._item_info(self.lookup_row(i), p) for i in ids
                ],
                "label": int(self.cp_split.labels[i_row]),
                "prob": p,
                "predicted": int(p > 0.5),
            }
            for ids, p, i_row in zip(outfits, probs, idx)
        ]

    def sample_cir(self, n: int = 4) -> List[Dict]:
        """n random CIR test rows: pop an eligible positive out of the
        outfit (the gt), retrieve top-10 for it, mark whether the gt was
        recovered."""
        if self.cir_split is None:
            raise ValueError("no CIR test split loaded")
        s = self.cir_split
        idx = self._rng.choice(len(s), min(n, len(s)), replace=False)
        out = []
        for i in idx:
            eligible = np.flatnonzero(s.pos_eligible[i])
            pos_slot = int(self._rng.choice(eligible))
            rows = s.item_rows[i][: s.lengths[i]]
            gt_row = int(rows[pos_slot])
            partial = [
                int(self.catalog.item_ids[r])
                for j, r in enumerate(rows)
                if j != pos_slot
            ]
            gt_id = int(self.catalog.item_ids[gt_row])
            retrieved = (
                [self._item_info(int(self._rng.integers(self.catalog.n_items)), 1.0)
                 for _ in range(10)]
                if self.mock
                else self.cir_top10(partial, gt_id)
            )
            out.append(
                {
                    "partial_outfit": [
                        self._item_info(self.lookup_row(i2), 0.0)
                        for i2 in partial
                    ],
                    "gt_item": self._item_info(gt_row, 0.0),
                    "retrieved": retrieved,
                    "gt_in_top10": any(
                        r["item_id"] == gt_id for r in retrieved
                    ),
                }
            )
        return out

    def sample_fitb(self, n: int = 4) -> List[Dict]:
        """n random FITB test rows: question outfit, 4 candidates, answer
        index vs predicted index."""
        if self.fitb_split is None:
            raise ValueError("no FITB test split loaded")
        s = self.fitb_split
        idx = self._rng.choice(len(s), min(n, len(s)), replace=False)
        out = []
        for i in idx:
            question = self._row_ids(s.item_rows[i], s.mask[i])
            cand_ids = [int(self.catalog.item_ids[r]) for r in s.cand_rows[i]]
            pick = self.fitb_pick(question, cand_ids)
            answer = int(s.answer_idx[i])
            out.append(
                {
                    "partial_outfit": [
                        self._item_info(self.lookup_row(q), 0.0)
                        for q in question
                    ],
                    "candidates": [
                        self._item_info(self.lookup_row(c), 0.0)
                        for c in cand_ids
                    ],
                    "answer_index": answer,
                    "predicted_index": pick,
                    "correct": pick == answer,
                }
            )
        return out
