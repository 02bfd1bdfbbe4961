"""Original-CP trainer: end-to-end CP with the item encoder inside the train
step (the port of ``outfitx_tpu/train/original_cp_trainer.py``; the
reference's resnet18 + MiniLM envelope is batch 350 x accumulation 10).

Raw items (uint8 images and token ids) go through the frozen towers and
their trainable heads into the set transformer. Only the set transformer,
its task heads and the encoder's fresh heads (``vision.fc`` and
``text.proj`` of resnet_sbert) reach AdamW: the backbones' parameters keep
``requires_grad=False``, so weight decay never touches them and autograd
records nothing of their activations (at 5,600 images a microbatch,
ResNet-18's first convolution alone is 9 GB in bfloat16).

The host gathers one microbatch of raw items at a time, from the epoch's
order (the JAX trainer's ``_batches``, which gathers a whole optimizer step,
8.4 GB at the envelope), into one of two pinned buffers, and copies it to
the card without blocking. A large gather is split into contiguous row
ranges, one for every ``PART_BYTES`` of rows, taken at once by a pool of
threads (one a core this process may run on, ``MAX_PARTS`` at most) into
disjoint slices of the buffers: the bytes are those of one ``np.take``.
The train step takes microbatch i+1 after it has queued microbatch i's
forward and before it queues i's backward (``steps._accumulate``), so the
gather of i+1 overlaps the card's forward of i; only each step's first
gather finds the card idle. Dropout draws from the trainer's generator, a
fresh stream for each step and microbatch.

Checkpoints hold the JAX trainer's tree, ``{"model": ..., "enc_heads":
{"fc", "proj"}}``, so either package restores the other's.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch import nn

from outfitx_tpu_torch.core.config import CPTrainConfig, ItemEncoderConfig, OutfitXConfig
from outfitx_tpu_torch.core.trace import span
from outfitx_tpu_torch.data.sampler import eval_batches
from outfitx_tpu_torch.evalm import binary_classification_metrics
from outfitx_tpu_torch.losses import focal_loss
from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.train.harness import Trainer
from outfitx_tpu_torch.train.optim import AdamW
from outfitx_tpu_torch.train.state import TrainState
from outfitx_tpu_torch.train.steps import original_cp_eval_step, original_cp_train_step

RAW_KEYS = ("images", "input_ids", "attn")

# A gather takes one part for every PART_BYTES of its rows (8 MiB: 56
# images at 224²), on at most MAX_PARTS threads: past 8, the host's memory
# bandwidth, not the thread count, bounds the copy.
PART_BYTES = 8 << 20
MAX_PARTS = 8


class RawItemSource:
    """Raw per-item inputs by catalog row: (N+1, 3, S, S) uint8 images and
    (N+1, T) int32 token ids and attention masks, the last row the pad
    item (all zeros).

    Its pool of gather threads holds one thread a core this process may
    run on, ``MAX_PARTS`` at most; the pool starts a thread only when a
    gather first splits, and keeps it for the next."""

    def __init__(self, *, image_bank: np.ndarray, input_ids: np.ndarray, attn: np.ndarray):
        self.image_bank = image_bank
        self.input_ids = input_ids
        self.attn = attn
        self._max_parts = min(len(os.sched_getaffinity(0)), MAX_PARTS)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            self._max_parts, thread_name_prefix="outfitx-gather"
        )

    @classmethod
    def synthetic(
        cls, n_items: int, image_size: int, text_len: int, vocab: int, seed: int = 0
    ) -> "RawItemSource":
        """Random items; the same draws as the JAX source for a seed."""
        rng = np.random.default_rng(seed)
        images = rng.integers(
            0, 256, (n_items + 1, 3, image_size, image_size), dtype=np.uint8
        )
        images[-1] = 0  # pad row
        ids = rng.integers(1, vocab - 2, (n_items + 1, text_len)).astype(np.int32)
        ids[:, -1] = vocab - 1
        ids[-1] = 0
        attn = np.ones_like(ids)
        attn[-1] = 0
        return cls(image_bank=images, input_ids=ids, attn=attn)

    @property
    def banks(self) -> Dict[str, np.ndarray]:
        return dict(zip(RAW_KEYS, (self.image_bank, self.input_ids, self.attn)))

    def parts(self, n_rows: int) -> int:
        """The number of parts a gather of ``n_rows`` rows runs in: one for
        every ``PART_BYTES`` of the rows' bytes, at least one, at most the
        pool's threads."""
        row_bytes = sum(bank.nbytes // len(bank) for bank in self.banks.values())
        return max(1, min(self._max_parts, n_rows * row_bytes // PART_BYTES))

    def gather(
        self, rows: np.ndarray, out: Optional[Dict[str, np.ndarray]] = None
    ) -> Dict[str, np.ndarray]:
        """The rows' inputs; into ``out`` (arrays of the right shapes and
        dtypes, each written in place and returned) where given. Rows must
        lie in [0, N]; they are checked before anything is written.

        The rows are cut into ``parts(len(rows))`` contiguous ranges, each
        taken by a thread of the pool into its own slice of the output
        (``np.take`` releases the GIL for these dtypes); the call returns
        when every part has finished, and raises what a part raised. The
        bytes equal one ``np.take``'s. A gather of one part runs on the
        caller's thread."""
        rows = np.asarray(rows)
        n = len(self.image_bank)
        if rows.size and (rows.min() < 0 or rows.max() >= n):
            raise IndexError(f"raw item rows must lie in [0, {n}), got "
                             f"{rows.min()}..{rows.max()}")
        banks = self.banks
        if out is None:
            out = {k: np.empty((*rows.shape, *b.shape[1:]), b.dtype) for k, b in banks.items()}

        def take(lo: int, hi: int) -> None:
            # mode="clip" (the rows are checked above): in its default mode
            # numpy takes into ``out`` through a temporary, a second copy of
            # 843 MB a microbatch at the envelope.
            for key, bank in banks.items():
                np.take(bank, rows[lo:hi], axis=0, out=out[key][lo:hi], mode="clip")

        parts = self.parts(len(rows))
        if parts == 1:
            take(0, len(rows))
        else:
            ends = [len(rows) * i // parts for i in range(parts + 1)]
            futures = [
                self._pool.submit(take, lo, hi) for lo, hi in zip(ends, ends[1:]) if hi > lo
            ]
            # every part ends before the call returns or raises: none may
            # still be writing into a buffer that the caller copies or refills
            concurrent.futures.wait(futures)
            for f in futures:
                f.result()
        return {key: out[key] for key in RAW_KEYS}

    @classmethod
    def from_polyvore(
        cls,
        catalog,
        dataset_dir,
        *,
        image_size: int,
        tokenizer,
        text_len: int = 16,
    ) -> "RawItemSource":
        """Decode ``images/{id}.jpg`` once into a uint8 bank (224² is about
        150 KB an item; a missing image stays zeros) and tokenize the item
        descriptions once. Decoding needs PIL, imported when called."""
        import pathlib

        from outfitx_tpu_torch.data.preprocess import load_image_uint8

        dataset_dir = pathlib.Path(dataset_dir)
        n = catalog.n_items
        images = np.zeros((n + 1, 3, image_size, image_size), dtype=np.uint8)
        for row in range(n):
            path = dataset_dir / "images" / f"{int(catalog.item_ids[row])}.jpg"
            if path.exists():
                images[row] = load_image_uint8(str(path), image_size)
        texts = list(catalog.descriptions or [""] * n) + [""]
        ids, attn = tokenizer(texts, max_length=text_len)
        ids[-1] = 0
        attn[-1] = 0
        return cls(
            image_bank=images,
            input_ids=ids.astype(np.int32),
            attn=attn.astype(np.int32),
        )


class RawBatchStager:
    """Gathers raw microbatches on the host and moves them to the device.

    On the card each gather lands in one of two pinned buffers, taken in
    turn, and is copied without blocking; before a buffer is filled again
    the host waits for its last copy. The gather overlaps the card's work
    only where the caller asks for the next microbatch before the card has
    run out of queued work: the train step asks for microbatch i+1 right
    after queueing forward i, whose buffer last held microbatch i-1, copied
    before forward i ran. The small per-outfit arrays (mask, label) go
    through pinned memory too. A large gather runs split over the
    source's threads (``RawItemSource.gather``), each part into its own
    slice of the buffer; its ``outfitx.gather`` span is tagged with the
    number of parts. ``gather_s`` counts the host's seconds in the
    gathers, waits included: the stretch of each ``outfitx.gather`` span,
    inside the call's ``outfitx.stage`` span."""

    def __init__(self, source: RawItemSource, device: torch.device):
        self.source = source
        self.device = device
        self.gather_s = 0.0
        self._slots: List[Dict[str, torch.Tensor]] = [{}, {}]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0

    def _host_buffers(self, slot: int, n: int) -> Dict[str, np.ndarray]:
        bufs = self._slots[slot]
        for key, bank in self.source.banks.items():
            shape = (n, *bank.shape[1:])
            if key not in bufs or tuple(bufs[key].shape) != shape:
                bufs[key] = torch.empty(
                    shape, dtype=torch.from_numpy(bank[:0]).dtype, pin_memory=True
                )
        return {k: t.numpy() for k, t in bufs.items()}

    def _gather(self, rows: np.ndarray, slot: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The rows' raw inputs on the host, into pinned ``slot`` after its
        last copy has left it: the stretch ``gather_s`` counts."""
        with span("outfitx.gather", tag=self.source.parts(len(rows))):
            t0 = time.perf_counter()
            if slot is None:
                raw = self.source.gather(rows)
            else:
                if self._copied[slot] is not None:
                    self._copied[slot].synchronize()
                raw = self.source.gather(rows, out=self._host_buffers(slot, len(rows)))
            self.gather_s += time.perf_counter() - t0
        return raw

    def __call__(self, item_rows: np.ndarray, **host: np.ndarray) -> Dict[str, torch.Tensor]:
        """item_rows (B, L) -> the raw inputs reshaped (B, L, ...), and each
        array of ``host`` (mask, label), on the device."""
        with span("outfitx.stage"):
            b, l = item_rows.shape
            rows = item_rows.reshape(-1)
            if self.device.type == "cuda":
                slot = self._turn
                self._turn ^= 1
                self._gather(rows, slot)
                out = {
                    k: self._slots[slot][k].to(self.device, non_blocking=True)
                    for k in RAW_KEYS
                }
                self._copied[slot] = torch.cuda.Event()
                self._copied[slot].record()
            else:
                out = {k: torch.from_numpy(v) for k, v in self._gather(rows).items()}
            out = {k: v.reshape(b, l, *v.shape[1:]) for k, v in out.items()}
            for k, v in host.items():
                t = torch.from_numpy(np.ascontiguousarray(v))
                if self.device.type == "cuda":
                    # from pageable memory the copy would wait for the card
                    # to finish its queue, and the gather would stop overlapping
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[k] = t
            return out


class OriginalCPModel(nn.Module):
    """The item encoder in front of the set transformer: raw items in, CP
    logits out. Its trainable parameters are the set transformer's and the
    encoder's heads."""

    def __init__(self, model: OutfitXModel, encoder: ItemEncoderModel):
        super().__init__()
        self.model = model
        self.encoder = encoder

    @property
    def device(self) -> torch.device:
        return self.model.device

    def encode_items(self, mb: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, L, ...) raw inputs -> (B, L, D) item embeddings, float32."""
        b, l = mb["mask"].shape
        images, ids, attn = (mb[k] for k in RAW_KEYS)
        with span("outfitx.encode"):
            emb = self.encoder.encode(
                images.reshape(b * l, *images.shape[2:]),
                ids.reshape(b * l, -1),
                attn.reshape(b * l, -1),
            )
        return emb.reshape(b, l, -1)

    def cp_forward(self, mb: Dict[str, torch.Tensor], *, generator=None) -> torch.Tensor:
        return self.model.cp_forward(self.encode_items(mb), mb["mask"], generator=generator)


# The JAX trainer's trainable encoder heads, by their names in
# ``OriginalCPModel``.
HEADS = {"fc": "encoder.vision.fc", "proj": "encoder.text.proj"}


def _linear_tree(named, prefix: str) -> Dict[str, torch.Tensor]:
    """An ``nn.Linear``'s weight and bias in ``named`` (or their Adam
    moments) as a JAX ``linear`` ({'w': (in, out), 'b'})."""
    return {"w": named[prefix + ".weight"].T, "b": named[prefix + ".bias"]}


def _linear_named(tree, prefix: str) -> Dict[str, torch.Tensor]:
    """The inverse of ``_linear_tree``."""
    return {
        prefix + ".weight": torch.as_tensor(np.asarray(tree["w"])).T,
        prefix + ".bias": torch.as_tensor(np.asarray(tree["b"])),
    }


class OriginalCPTrainer(Trainer):
    def __init__(
        self,
        cfg: CPTrainConfig,
        model_cfg: Optional[OutfitXConfig] = None,
        run_mode: str = "train-valid",
        *,
        encoder: Optional[ItemEncoderModel] = None,
        source: Optional[RawItemSource] = None,
        train_split=None,
        valid_split=None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(cfg, run_mode, device=device)
        self.model_cfg = model_cfg or OutfitXConfig(
            item_encoder=ItemEncoderConfig.for_type("resnet_sbert")
        )
        self._encoder = encoder
        self._source = source
        self._train_split = train_split
        self._valid_split = valid_split

    @property
    def model_name(self) -> str:
        return f"{self.model_cfg.model_name}-original-cp"

    def best_metrics(self) -> Dict[str, str]:
        return {"auc": "max", "loss": "min"}

    # ------------------------------------------------------------ setup --
    def load_model(self) -> None:
        self.model = OutfitXModel(
            self.model_cfg, device=self.device, seed=self.cfg.seed, trainable=True
        )
        self.encoder = self._encoder or ItemEncoderModel(
            self.model_cfg.item_encoder, device=self.device, seed=self.cfg.seed
        )
        if self.encoder.device.type != self.device.type:
            raise ValueError(
                f"the encoder lies on {self.encoder.device}, the trainer on {self.device}"
            )
        self.net = OriginalCPModel(self.model, self.encoder)

    def load_optimizer(self) -> None:
        n_train = len(self._train_split) if self._train_split is not None else 0
        super_b = self.cfg.batch_size * self.cfg.accumulation_steps
        total_steps = max(n_train // super_b, 1) * self.cfg.n_epochs
        # The mesh splits the set transformer; the encoder's heads (and its
        # frozen towers) stay whole on every rank, their gradients summed
        # over the data axis with the rest.
        self.shard_model_params(self.model)
        optimizer = AdamW(self.net.parameters(), self.cfg.optimizer, total_steps, par=self.par)
        self.state = TrainState.create(self.net, optimizer, self.cfg.seed, par=self.par)

    def setup_data(self) -> None:
        if self._source is None or self._train_split is None:
            from outfitx_tpu_torch.data.catalog import Catalog
            from outfitx_tpu_torch.data.splits import CPSplit
            from outfitx_tpu_torch.data.tokenizer import load_tokenizer

            catalog = Catalog.from_metadata_only(self.cfg.dataset_dir)
            self._train_split, self._valid_split = (
                CPSplit.load(
                    catalog, self.cfg.dataset_dir, self.cfg.polyvore_type,
                    mode, self.model_cfg.max_outfit_len,
                )
                for mode in ("train", "valid")
            )
            enc_cfg = self.model_cfg.item_encoder
            tokenizer = load_tokenizer(
                enc_cfg.text_model_name, vocab_size=self.encoder.text_vocab_size,
                required=enc_cfg.pair.published_tokenizer,
            )
            self._source = RawItemSource.from_polyvore(
                catalog, self.cfg.dataset_dir,
                image_size=self.encoder.image_size,
                tokenizer=tokenizer,
                text_len=min(16, self.encoder.text.cfg.max_len),
            )
        self.stage = RawBatchStager(self._source, self.device)

    # ------------------------------------------------------ checkpoints --
    def checkpoint_params(self, named=None) -> Dict[str, object]:
        """The JAX trainer's tree: the set transformer's state dict and the
        encoder's trainable heads, from the live parameters or from
        ``named`` (a tensor for each trainable parameter of ``self.net``,
        keyed by its name there: an Adam moment)."""
        if named is None:
            named = dict(self.net.named_parameters())
            named.update(("model." + k, v) for k, v in self.full_params(self.model).items())
        heads = {}
        if self.encoder.has_trainable_heads:
            heads = {key: _linear_tree(named, prefix) for key, prefix in HEADS.items()}
        model = {k[len("model."):]: v for k, v in named.items() if k.startswith("model.")}
        return {"params": model, "enc_heads": heads}

    def named_params(self, payload) -> Dict[str, object]:
        named = {"model." + k: v for k, v in payload["params"].items()}
        for key, tree in (payload.get("enc_heads") or {}).items():
            named.update(_linear_named(tree, HEADS[key]))
        return named

    @torch.no_grad()
    def load_checkpoint_params(self, payload) -> None:
        self.load_params(self.model, payload["params"])
        params = dict(self.net.named_parameters())
        for name, value in self.named_params(payload).items():
            if not name.startswith("model."):
                params[name].copy_(value)

    # ------------------------------------------------------------ train --
    def step_selections(self, split, epoch: int) -> Iterator[List[np.ndarray]]:
        """Each optimizer step's A microbatches, as rows of ``split``: the
        JAX trainer's epoch order, cut into super-batches of B*A."""
        rng = np.random.default_rng([self.cfg.seed, epoch, 7])
        order = rng.permutation(len(split))
        b, a = self.cfg.batch_size, self.cfg.accumulation_steps
        for start in range(0, len(split) - b * a + 1, b * a):
            yield [order[start + i * b : start + (i + 1) * b] for i in range(a)]

    def microbatch(self, split, sel: np.ndarray) -> Dict[str, torch.Tensor]:
        """The staged raw microbatch of rows ``sel`` (under a mesh, this
        rank's block of them only)."""
        if self.par is not None:
            sel = self.par.rows(sel)
        return self.stage(
            split.item_rows[sel], mask=split.mask[sel], label=split.labels[sel]
        )

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        split = self._train_split
        losses, scores, labels = [], [], []
        for sels in self.step_selections(split, epoch):
            out = original_cp_train_step(
                self.state, (self.microbatch(split, sel) for sel in sels),
                alpha=self.cfg.focal_alpha, gamma=self.cfg.focal_gamma,
            )
            losses.append(out["loss"])
            scores.append(out["scores"].reshape(-1))
            rows = [sel if self.par is None else self.par.rows(sel) for sel in sels]
            labels.append(split.labels[np.concatenate(rows)])
        if not losses:
            return {}
        labels = torch.as_tensor(np.concatenate(labels), device=scores[0].device)
        metrics = binary_classification_metrics(
            self.gather_rows(torch.cat(scores)).cpu().numpy(),
            self.gather_rows(labels).cpu().numpy(),
            from_logits=True,
        )
        metrics["loss"] = float(np.mean(torch.stack(losses).cpu().numpy(), dtype=np.float64))
        return metrics

    def valid_epoch(self, epoch: int) -> Dict[str, float]:
        split = self._valid_split
        scores_all, labels_all, valids = [], [], []
        for eb in eval_batches(
            {"item_rows": split.item_rows, "mask": split.mask, "label": split.labels},
            batch_size=self.cfg.batch_size,
        ):
            local = self.rows({"item_rows": eb["item_rows"], "mask": eb["mask"]})
            batch = self.stage(local["item_rows"], mask=local["mask"])
            scores_all.append(
                self.gather_rows(original_cp_eval_step(self.net, batch)).cpu().numpy()
            )
            labels_all.append(eb["label"])
            valids.append(eb["valid"])
        if not scores_all:
            return {}
        valid = np.concatenate(valids)
        scores = np.concatenate(scores_all)[valid]
        labels = np.concatenate(labels_all)[valid]
        metrics = binary_classification_metrics(scores, labels, from_logits=True)
        metrics["loss"] = float(focal_loss(
            torch.from_numpy(scores), torch.from_numpy(labels),
            alpha=self.cfg.focal_alpha, gamma=self.cfg.focal_gamma,
        ))
        self.maybe_save_best(metrics, epoch=epoch)
        return metrics

    def test(self) -> Dict[str, float]:
        return self.valid_epoch(self.epoch)
