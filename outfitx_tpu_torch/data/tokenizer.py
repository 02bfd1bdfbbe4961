"""Text tokenization for the frozen text towers.

Copy of ``outfitx_tpu/data/tokenizer.py``. Where a tokenizer's files lie on
the local disk the HF tokenizer is used; otherwise a deterministic hash
tokenizer stands in, so every pipeline runs end to end. The hash tokenizer
shares no vocabulary with pretrained weights and is for synthetic runs only.
"""

from __future__ import annotations

import hashlib
import logging
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class HashTokenizer:
    """Deterministic word-hash tokenizer with BOS/EOS, CLIP-style layout."""

    def __init__(
        self, vocab_size: int = 49408, bos: Optional[int] = None,
        eos: Optional[int] = None,
    ):
        self.vocab_size = vocab_size
        # The specials lie at the top of the vocabulary (CLIP's convention),
        # inside the actual vocabulary whatever its size.
        self.bos = bos if bos is not None else vocab_size - 2
        self.eos = eos if eos is not None else vocab_size - 1

    def _word_id(self, w: str) -> int:
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        return 1 + h % (min(self.bos, self.eos) - 1)

    def __call__(
        self, texts: List[str], max_length: int = 64
    ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.zeros((len(texts), max_length), dtype=np.int32)
        mask = np.zeros((len(texts), max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            toks = [self.bos] + [
                self._word_id(w) for w in t.lower().split()[: max_length - 2]
            ] + [self.eos]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask


# The files an HF tokenizer is loaded from; a tower whose ids must be the
# published ones (``required``) names them when they are missing.
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json")


def load_tokenizer(model_name_or_path: Optional[str], vocab_size: int = 49408,
                   required: bool = False):
    """The HF tokenizer if its files are on the local disk, else a
    ``HashTokenizer``; with ``required``, FileNotFoundError naming the
    files instead of the stand-in. Nothing is downloaded."""
    if model_name_or_path:
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(
                model_name_or_path, local_files_only=True
            )
        except Exception as e:  # no transformers, or no local files
            if required:
                raise FileNotFoundError(
                    f"the tokenizer of {model_name_or_path} is not on this disk: "
                    f"{' and '.join(TOKENIZER_FILES)} under {model_name_or_path} "
                    f"(or the HF cache), with transformers installed ({e}). "
                    "AutoTokenizer runs no code that a checkpoint ships, so a "
                    "tokenizer that brings its own (Kimi-VL's tiktoken.model and "
                    "tokenization_moonshot.py) needs a loader of its own, which "
                    "waits until those files are in the repository. Its token "
                    "ids index the tower's embedding; a hash tokenizer's would not."
                ) from e
            logger.warning(
                "tokenizer '%s' is not available locally (%s); using the "
                "HashTokenizer, which shares no vocabulary with pretrained "
                "weights: for synthetic runs only",
                model_name_or_path, e,
            )
        else:
            def call(texts: List[str], max_length: int = 64):
                out = tok(
                    texts, padding="max_length", truncation=True,
                    max_length=max_length, return_tensors="np",
                )
                return (
                    out["input_ids"].astype(np.int32),
                    out["attention_mask"].astype(np.int32),
                )

            return call
    return HashTokenizer(vocab_size=vocab_size)
