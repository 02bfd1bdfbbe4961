"""When the port's train steps take their microbatches
(``outfitx_tpu_torch/train/steps.py _accumulate``).

Each microbatch after the first is taken one ahead: microbatch i+1 after
forward i is queued and before backward i is. A recording iterator and a
stub model over A = 3 show the order, that nothing is taken after the last
forward but the end, and that a take that raises raises from the step. CP's
and CIR's microbatches are still views of the super-batch, taken in order.
The original-CP step over a lazy generator of ``trainer.microbatch`` is bit
for bit the step over the same microbatches staged beforehand, dropout on.
One test needs the card: four microbatches staged through
``RawBatchStager``'s two pinned buffers, one ahead behind a busy card, each
equal to the rows it was asked for, in a gather of one part and in one
split over threads. Nothing here imports JAX, so the file
also runs on the card's machine (``--noconftest``).
"""

import numpy as np
import pytest
import torch
from torch import nn

from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.data import sampler as tsampler
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models import OutfitXModel
from outfitx_tpu_torch.train import steps
from outfitx_tpu_torch.train.optim import AdamW
from outfitx_tpu_torch.train.state import TrainState

torch.set_num_threads(1)

A = 3


class _Recording:
    """Yields ``items`` and logs ("pull", k) for each; logs ("end",) when
    asked past the last. Raises on take ``fail_at``."""

    def __init__(self, items, log, fail_at=None):
        self.items, self.log, self.fail_at, self.k = items, log, fail_at, 0

    def __iter__(self):
        return self

    def __next__(self):
        k = self.k
        if k == self.fail_at:
            raise RuntimeError(f"take {k} failed")
        if k == len(self.items):
            self.log.append(("end",))
            raise StopIteration
        self.k += 1
        self.log.append(("pull", k))
        return self.items[k]


class _Stub(nn.Module):
    """An original-CP model of one weight that logs its forward and, from a
    hook on its scores, its backward."""

    def __init__(self, log):
        super().__init__()
        self.w = nn.Parameter(torch.ones(()))
        self.log = log

    def cp_forward(self, mb, *, generator=None):
        i = int(mb["i"])
        self.log.append(("forward", i))
        scores = self.w * mb["x"]
        scores.register_hook(lambda g: self.log.append(("backward", i)) or g)
        return scores


def _stub_step(log, fail_at=None):
    net = _Stub(log)
    state = TrainState(step=0, model=net, optimizer=AdamW(net.parameters(),
                       tcfg.OptimizerConfig(learning_rate=1e-3), 10),
                       seed=0, generator=torch.Generator())
    gen = torch.Generator().manual_seed(0)
    mbs = [{"x": torch.randn(4, generator=gen), "label": torch.tensor([0.0, 1.0, 0.0, 1.0]),
            "i": torch.tensor(i)} for i in range(A)]
    return state, _Recording(mbs, log, fail_at)


def test_each_microbatch_is_taken_between_the_last_forward_and_its_backward():
    log = []
    state, mbs = _stub_step(log)
    out = steps.original_cp_train_step(state, mbs)
    assert log == [("pull", 0), ("forward", 0), ("pull", 1), ("backward", 0),
                   ("forward", 1), ("pull", 2), ("backward", 1),
                   ("forward", 2), ("end",), ("backward", 2)]
    last = log.index(("forward", A - 1))
    assert not [e for e in log[last:] if e[0] == "pull"]
    assert out["scores"].shape == (A, 4) and state.step == 1


@pytest.mark.parametrize("k", range(A))
def test_a_take_that_raises_raises_from_the_step(k):
    log = []
    state, mbs = _stub_step(log, fail_at=k)
    with pytest.raises(RuntimeError, match=f"take {k} failed"):
        steps.original_cp_train_step(state, mbs)
    assert [e for e in log if e[0] == "forward"] == [("forward", i) for i in range(k)]
    assert state.step == 0


def _catalog_state(task):
    cfg = tcfg.OutfitXConfig(
        item_encoder=tcfg.ItemEncoderConfig(encoder_type="siglip", dim_per_modality=32),
        transformer=tcfg.TransformerConfig(n_heads=4, d_ffn=96, n_layers=2, dropout=0.3),
        max_outfit_len=8, compute_dtype="float32",
    )
    data = make_synthetic(n_items=300, d_embed=cfg.d_embed, n_outfits=64,
                          max_len=cfg.max_outfit_len, seed=3)
    model = OutfitXModel(cfg, device="cpu", seed=0, trainable=True)
    state = TrainState.create(
        model, AdamW(model.parameters(), tcfg.OptimizerConfig(learning_rate=1e-3), 10), seed=7
    )
    kw = dict(batch_size=8, accum_steps=A, seed=1, epoch=0)
    if task == "cp":
        batch = next(tsampler.cp_train_batches(data.cp_train, **kw))
    else:
        batch = next(tsampler.cir_train_batches(
            data.cir_train, data.catalog, max_len=cfg.max_outfit_len, n_negatives=5,
            impl="python", **kw))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return state, torch.from_numpy(data.catalog.embeddings), batch


@pytest.mark.parametrize("task", ["cp", "cir"])
def test_catalog_steps_take_views_of_the_super_batch_in_order(task, monkeypatch):
    """CP and CIR take their microbatches one ahead as well, between a
    forward and its backward: views of microbatch i of each array, in
    order, the super-batch unchanged."""
    state, catalog, batch = _catalog_state(task)
    before = {k: v.clone() for k, v in batch.items()}
    log, seen = [], []
    split = steps._split

    def recording(b):
        for i, mb in enumerate(split(b)):
            log.append(("pull", i))
            seen.append(mb)
            yield mb

    monkeypatch.setattr(steps, "_split", recording)
    forward = "cp_forward" if task == "cp" else "cir_forward"
    model_forward = getattr(state.model, forward)

    def logged(*args, **kw):
        log.append(("forward",))
        out = model_forward(*args, **kw)
        out.register_hook(lambda g: log.append(("backward",)) or g)
        return out

    monkeypatch.setattr(state.model, forward, logged)
    step = steps.cp_train_step if task == "cp" else steps.cir_train_step
    step(state, catalog, batch)
    assert log == [("pull", 0), ("forward",), ("pull", 1), ("backward",), ("forward",),
                   ("pull", 2), ("backward",), ("forward",), ("backward",)]
    assert len(seen) == A
    for i, mb in enumerate(seen):
        assert mb.keys() == batch.keys()
        for k, v in mb.items():
            assert v._base is batch[k] and v.data_ptr() == batch[k][i].data_ptr()
            assert torch.equal(v, before[k][i])
    for k, v in batch.items():
        assert torch.equal(v, before[k])


def _ocp_trainer(tmp_path, name):
    from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
    from outfitx_tpu_torch.models.towers.minilm import MiniLMConfig
    from outfitx_tpu_torch.models.towers.resnet import ResNet18Config
    from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPTrainer, RawItemSource

    enc_cfg = tcfg.ItemEncoderConfig(encoder_type="resnet_sbert", dim_per_modality=8)
    model_cfg = tcfg.OutfitXConfig(
        item_encoder=enc_cfg, max_outfit_len=8, compute_dtype="float32",
        transformer=tcfg.TransformerConfig(n_heads=4, d_ffn=32, n_layers=2, dropout=0.3),
    )
    cfg = tcfg.CPTrainConfig(
        n_epochs=1, batch_size=8, accumulation_steps=A,
        checkpoint_dir=str(tmp_path / name), log_dir=str(tmp_path / f"{name}logs"),
    )
    enc = ItemEncoderModel(
        enc_cfg, device="cpu", seed=1,
        vision_cfg=ResNet18Config(d_out=8, image_size=32, compute_dtype="float32"),
        text_cfg=MiniLMConfig(vocab_size=120, max_len=12, d_model=24, n_heads=4, d_mlp=48,
                              n_layers=1, d_out=8, compute_dtype="float32"),
    )
    split = make_synthetic(n_items=100, d_embed=16, n_outfits=64, seed=9)
    return OriginalCPTrainer(
        cfg, model_cfg, encoder=enc,
        source=RawItemSource.synthetic(n_items=100, image_size=32, text_len=12, vocab=120,
                                       seed=3),
        train_split=split.cp_train, valid_split=split.cp_valid, device="cpu",
    ).__enter__()


def test_original_cp_step_over_a_lazy_generator_is_the_prestaged_step(tmp_path):
    """Staging each microbatch one ahead, between the forward before it and
    that forward's backward, changes nothing: loss, scores, every gradient
    and every updated parameter bit for bit, dropout 0.3."""
    results = []
    for lazy in (True, False):
        t = _ocp_trainer(tmp_path, str(lazy))
        try:
            split = t._train_split
            sels = next(t.step_selections(split, 0))
            mbs = (t.microbatch(split, s) for s in sels)
            out = steps.original_cp_train_step(t.state, mbs if lazy else list(mbs))
            named = list(t.net.named_parameters())
            results.append((out, {n: p.grad.clone() for n, p in named if p.grad is not None},
                            {n: p.detach().clone() for n, p in named}))
        finally:
            t.__exit__(ValueError, None, None)  # no final checkpoints
    (out, grads, params), (want, want_grads, want_params) = results
    assert torch.equal(out["loss"], want["loss"])
    assert out["scores"].shape == (A, 8) and torch.equal(out["scores"], want["scores"])
    assert any(n.startswith("encoder.") for n in grads)
    assert grads.keys() == want_grads.keys() and params.keys() == want_params.keys()
    for n in want_grads:
        assert torch.equal(grads[n], want_grads[n]), n
    for n in want_params:
        assert torch.equal(params[n], want_params[n]), n


# --------------------------------------------------------------- card --
@pytest.mark.card
@pytest.mark.parametrize("image_size, b, l", [(64, 16, 4), (224, 64, 8)])
def test_staged_one_ahead_behind_a_busy_card(image_size, b, l):
    """Four microbatches through the two pinned buffers, each taken while
    the card still sleeps through the forwards queued before it: microbatch
    3 is gathered into the buffer that microbatch 1's copy, queued behind
    microbatch 0's forward, is still to read. Each staged microbatch equals
    one ``np.take`` of its rows' items, at 64² (a gather of one part) and at
    224² (512 images, split over the gather's threads). A first step fills
    the allocators' caches, so that no allocation of the checked step waits
    for the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from outfitx_tpu_torch.train.original_cp_trainer import RawBatchStager, RawItemSource

    device = torch.device("cuda")
    source = RawItemSource.synthetic(
        n_items=300, image_size=image_size, text_len=12, vocab=120, seed=5)
    pending = []

    class Watched(RawBatchStager):
        """Notes, at each gather into a buffer, whether its last copy is
        still queued: the case the buffer's wait is for."""

        def _gather(self, rows, slot=None):
            if slot is not None and self._copied[slot] is not None:
                pending.append(not self._copied[slot].query())
            return super()._gather(rows, slot)

    stage = Watched(source, device)
    rng = np.random.default_rng(11)
    n = 4
    rows = [rng.integers(0, 301, (b, l)) for _ in range(n)]
    staged = []

    class Sleeper(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.ones((), device=device))

        def cp_forward(self, mb, *, generator=None):
            staged.append(mb)
            torch.cuda._sleep(200_000_000)  # about 0.1 s on an H100's clock
            return self.w * mb["mask"].float().sum(1)

    net = Sleeper()
    state = TrainState(step=0, model=net, seed=0, generator=torch.Generator(device=device),
                       optimizer=AdamW(net.parameters(), tcfg.OptimizerConfig(), 10))

    def step():
        staged.clear()
        pending.clear()
        steps.original_cp_train_step(state, (
            stage(r, mask=np.ones((b, l), bool), label=np.zeros(b, np.float32)) for r in rows))
        torch.cuda.synchronize()

    step()
    step()
    assert len(staged) == n and any(pending), pending
    assert (source.parts(b * l) > 1) == (image_size == 224)  # on a host of two or more cores
    for r, mb in zip(rows, staged):
        for k, bank in source.banks.items():
            v = np.take(bank, r.reshape(-1), axis=0)
            got = mb[k].cpu().numpy()
            np.testing.assert_array_equal(got, v.reshape(b, l, *v.shape[1:]), err_msg=k)
