"""The catalog embedding-precompute sweep.

The port of ``outfitx_tpu/train/precompute.py``: a background thread decodes
and resizes images to uint8 while the device works, uint8 images go to the
device (a quarter of float32's bytes) and are normalised and encoded there
by the frozen item encoder. The output shards are pickled ``{ids,
embeddings}`` files with the JAX package's layout and file names, which its
``Catalog`` loaders and the reference's read alike. A sweep can be cut into
slices (``n_slices``, ``slice_index``); the CLI's ``pes --shards N`` runs
them as N child processes one after another, as the JAX CLI does.
"""

from __future__ import annotations

import json
import pathlib
import pickle
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from outfitx_tpu_torch.core.config import OutfitXConfig, PrecomputeConfig
from outfitx_tpu_torch.core.device import resolve_device
from outfitx_tpu_torch.data.preprocess import load_image_uint8
from outfitx_tpu_torch.data.tokenizer import load_tokenizer
from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel

SHARD_ITEMS = 50_000  # a single-slice sweep rolls a new shard this often


def _prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run ``it`` on a background thread, ``depth`` items ahead, so the
    host's decoding overlaps the device's work. An exception of the
    iterator is raised where the items are consumed."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for x in it:
                q.put(x)
            q.put(end)
        except BaseException as e:  # handed to the consumer, which re-raises
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        x = q.get()
        if x is end:
            return
        if isinstance(x, BaseException):
            raise x
        yield x


class PrecomputeRunner:
    """Encodes every item of a catalog (or ``synthetic_items`` synthetic
    ones) and writes embedding shards under ``output_dir``.

    It runs on the card unless given ``device="cpu"``, and raises without a
    card. The encoder is built from ``model_cfg.item_encoder`` with random
    weights from ``cfg.seed`` (``state_dict`` loads others) and, as the JAX
    runner, with the fused attention block as its attention route
    (``attn="block"``); or an ``encoder`` already built is used as it is.
    Only items whose enumeration index i has ``i % n_slices ==
    slice_index`` are encoded, and a sliced run writes one shard named by
    its slice index."""

    def __init__(
        self,
        cfg: PrecomputeConfig,
        model_cfg: Optional[OutfitXConfig] = None,
        *,
        output_dir: Optional[str] = None,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        synthetic_items: int = 0,
        encoder: Optional[ItemEncoderModel] = None,
        n_slices: int = 1,
        slice_index: int = 0,
        device: str | torch.device = "cuda",
        attn: str = "block",
        mlp: str = "plain",
    ):
        self.cfg = cfg
        self.model_cfg = model_cfg or OutfitXConfig()
        if not 0 <= slice_index < n_slices:
            raise ValueError(f"slice {slice_index} not in [0, {n_slices})")
        self.n_slices = n_slices
        self.slice_index = slice_index
        self.device = resolve_device(device)
        if encoder is None:
            encoder = ItemEncoderModel(
                self.model_cfg.item_encoder, device=self.device, seed=cfg.seed,
                attn=attn, mlp=mlp,
            )
        elif encoder.device.type != self.device.type:
            raise ValueError(
                f"the encoder lies on {encoder.device}, the runner on {self.device}"
            )
        if state_dict is not None:
            encoder.load_state_dict(state_dict)
        self.encoder = encoder
        self.output_dir = pathlib.Path(
            output_dir or pathlib.Path(cfg.dataset_dir) / "precomputed_embeddings"
        )
        self.synthetic_items = synthetic_items
        # Read from Polyvore, a pair whose tower takes only its published
        # tokenizer's ids raises, naming its files, where they are missing;
        # synthetic items need none.
        pair = self.model_cfg.item_encoder.pair
        self.tokenizer = load_tokenizer(
            self.model_cfg.item_encoder.text_model_name,
            vocab_size=encoder.text_vocab_size,
            required=pair.published_tokenizer and not synthetic_items,
        )

    # ------------------------------------------------------------- data --
    def _iter_items(self) -> Iterator[Tuple[int, np.ndarray, str]]:
        """This slice's (item_id, image uint8 (3, S, S), category text).
        Slicing is round-robin over the item enumeration, before any image
        is decoded, so N slices partition the catalog exactly."""
        size = self.encoder.image_size
        if self.synthetic_items:
            for i in range(self.synthetic_items):
                if i % self.n_slices != self.slice_index:
                    continue
                # Seeded by the item, not by the draw order: a sliced sweep
                # gives every item the image the single sweep gives it.
                img = np.random.default_rng([self.cfg.seed, i]).integers(
                    0, 256, (3, size, size), dtype=np.uint8
                )
                yield 10_000 + i, img, f"category {i % 13}"
            return
        dataset_dir = pathlib.Path(self.cfg.dataset_dir)
        with open(dataset_dir / "item_metadata.json", encoding="utf-8") as f:
            metadata = json.load(f)
        with open(dataset_dir / "categories.json", encoding="utf-8") as f:
            categories = json.load(f)
        for i, m in enumerate(metadata):
            if i % self.n_slices != self.slice_index:
                continue
            iid = int(m["item_id"])
            img_path = dataset_dir / "images" / f"{iid}.jpg"
            if not img_path.exists():
                continue
            img = load_image_uint8(str(img_path), size)
            text = categories.get(str(m.get("category_id", "")), "")
            yield iid, img, text

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        b = self.cfg.batch_size
        size = self.encoder.image_size
        ids: List[int] = []
        texts: List[str] = []
        imgs = np.zeros((b, 3, size, size), dtype=np.uint8)
        for iid, img, text in self._iter_items():
            imgs[len(ids)] = img
            ids.append(iid)
            texts.append(text)
            if len(ids) == b:
                yield self._finalize(ids, imgs.copy(), texts)
                ids, texts = [], []
        if ids:
            yield self._finalize(ids, imgs[: len(ids)].copy(), texts)

    def _finalize(self, ids, imgs, texts) -> Dict[str, np.ndarray]:
        """One batch as arrays. A trailing partial batch keeps its size:
        eager PyTorch needs no static shape."""
        max_len = min(
            self.model_cfg.item_encoder.text_max_length,
            self.encoder.text.cfg.max_len,
        )
        input_ids, attn = self.tokenizer(texts, max_length=max_len)
        return {
            "ids": np.asarray(ids, dtype=np.int64),
            "images": imgs,
            "input_ids": input_ids,
            "attention_mask": attn,
        }

    # -------------------------------------------------------------- run --
    def encode_batch(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """One batch's embeddings (n, d_embed) float32, on the host."""
        dev = self.device
        with torch.no_grad():  # resnet_sbert's heads would record a graph
            emb = self.encoder.encode(
                torch.from_numpy(batch["images"]).to(dev),
                torch.from_numpy(batch["input_ids"]).to(dev),
                torch.from_numpy(batch["attention_mask"]).to(dev),
            )
        return emb.cpu().numpy()

    def run(self) -> Dict[str, float]:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        model_name = self.model_cfg.model_name
        # A sliced run is one shard, named by its slice (one file per slice,
        # the reference's per-rank layout); a single run rolls shards.
        shard_items = SHARD_ITEMS if self.n_slices == 1 else (1 << 62)
        shard_base = 0 if self.n_slices == 1 else self.slice_index
        shard_idx, done = 0, 0
        cur_ids: List[np.ndarray] = []
        cur_embs: List[np.ndarray] = []
        t0 = time.perf_counter()
        for batch in _prefetch(self._batches()):
            cur_embs.append(self.encode_batch(batch))
            cur_ids.append(batch["ids"])
            done += len(batch["ids"])
            if sum(len(i) for i in cur_ids) >= shard_items:
                self._write_shard(model_name, shard_base + shard_idx, cur_ids, cur_embs)
                shard_idx += 1
                cur_ids, cur_embs = [], []
        if cur_ids:
            self._write_shard(model_name, shard_base + shard_idx, cur_ids, cur_embs)
            shard_idx += 1
        dt = time.perf_counter() - t0
        return {
            "items": done,
            "shards": shard_idx,
            "seconds": round(dt, 2),
            "items_per_sec": round(done / max(dt, 1e-9), 1),
        }

    def _write_shard(self, model_name, idx, ids, embs) -> None:
        path = self.output_dir / f"{model_name}_{self.cfg.shard_prefix}{idx}.pkl"
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "ids": np.concatenate(ids).tolist(),
                    "embeddings": np.concatenate(embs),
                },
                f,
            )
