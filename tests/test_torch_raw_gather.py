"""Original-CP's raw-item gather split over threads
(``outfitx_tpu_torch/train/original_cp_trainer.py RawItemSource.gather``).

A gather cut into 1, 2, 3 or 8 parts equals one ``np.take`` bit for bit,
for few rows, no rows, the pad row repeated and a row count the parts do
not divide, into arrays it allocates or into given ones, which it fills in
place and returns. An out-of-range row raises before any part writes; a
part that raises raises in the caller. The part count follows the rows'
bytes and the cores the process may run on, at most 8, and the stager's
``outfitx.gather`` span carries it as its tag. Nothing here imports JAX.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from outfitx_tpu_torch.core import trace
from outfitx_tpu_torch.train import original_cp_trainer as ocp
from outfitx_tpu_torch.train.original_cp_trainer import RawBatchStager, RawItemSource

N_ITEMS, IMAGE, TEXT_LEN, VOCAB = 200, 224, 16, 300
PARTS = (1, 2, 3, 8)
ROWS = {
    "fewer_than_parts": lambda rng: rng.integers(0, N_ITEMS + 1, 2),
    "none": lambda rng: np.zeros(0, np.int64),
    "pad_repeated": lambda rng: np.r_[rng.integers(0, N_ITEMS, 40), np.full(120, N_ITEMS)],
    "undivided": lambda rng: rng.integers(0, N_ITEMS + 1, 301),
}


@pytest.fixture(scope="module")
def source():
    return RawItemSource.synthetic(N_ITEMS, IMAGE, TEXT_LEN, VOCAB, seed=9)


def _one_take(source, rows):
    return {k: np.take(bank, rows, axis=0) for k, bank in source.banks.items()}


def _in_parts(source, monkeypatch, parts):
    monkeypatch.setattr(source, "parts", lambda n_rows: parts)
    return source


@pytest.mark.parametrize("given", [False, True], ids=["allocated", "given_out"])
@pytest.mark.parametrize("case", sorted(ROWS))
@pytest.mark.parametrize("parts", PARTS)
def test_split_gather_equals_one_take(source, monkeypatch, parts, case, given):
    rows = ROWS[case](np.random.default_rng(parts))
    want = _one_take(source, rows)
    out = {k: np.full_like(v, 0xAB) for k, v in want.items()} if given else None
    got = _in_parts(source, monkeypatch, parts).gather(rows, out=out)
    assert list(got) == list(ocp.RAW_KEYS)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k], v), k
        if given:
            assert got[k] is out[k], k


@pytest.mark.parametrize("parts", PARTS)
def test_a_row_out_of_range_raises_before_any_part_writes(source, monkeypatch, parts):
    _in_parts(source, monkeypatch, parts)
    for bad in (N_ITEMS + 1, -1):
        rows = np.r_[np.arange(99), bad]
        out = {k: np.full((len(rows), *b.shape[1:]), 0xAB, b.dtype)
               for k, b in source.banks.items()}
        with pytest.raises(IndexError):
            source.gather(rows, out=out)
        for k, v in out.items():
            assert (v == v.dtype.type(0xAB)).all(), (bad, k)


@pytest.mark.parametrize("parts", PARTS)
def test_a_part_that_raises_raises_in_the_caller(source, monkeypatch, parts):
    rows = np.arange(90)
    out = {k: np.empty_like(v) for k, v in _one_take(source, rows).items()}
    out["attn"] = out["attn"][:-1]  # the last part's slice is a row short
    with pytest.raises(ValueError):
        _in_parts(source, monkeypatch, parts).gather(rows, out=out)


@pytest.mark.parametrize("cores, envelope", [(1, 1), (4, 4), (16, 8)])
def test_part_count_follows_bytes_and_cores(monkeypatch, cores, envelope):
    monkeypatch.setattr(ocp.os, "sched_getaffinity", lambda pid: set(range(cores)))
    src = RawItemSource.synthetic(4, IMAGE, TEXT_LEN, VOCAB, seed=1)
    row_bytes = 3 * IMAGE * IMAGE + 2 * 4 * TEXT_LEN
    assert sum(b.nbytes // len(b) for b in src.banks.values()) == row_bytes
    per_part = -(-ocp.PART_BYTES // row_bytes)  # the fewest rows that fill a part: 56
    assert src.parts(0) == src.parts(1) == src.parts(2 * per_part - 1) == 1
    assert src.parts(2 * per_part) == min(2, cores)
    assert src.parts(5600) == envelope  # a microbatch of resnet-sbert.train_ocp
    tiny = RawItemSource.synthetic(50, 16, 10, VOCAB, seed=1)
    assert tiny.parts(350 * 16) == 1


def test_the_gather_span_carries_its_part_count(monkeypatch):
    """On the CPU path, under a profiler: a tiny gather runs in one part,
    one of 350 images at 224² in several, and each stages its rows."""
    monkeypatch.setattr(ocp.os, "sched_getaffinity", lambda pid: set(range(4)))
    tiny = RawItemSource.synthetic(50, 16, 10, VOCAB, seed=2)
    large = RawItemSource.synthetic(64, IMAGE, TEXT_LEN, VOCAB, seed=3)
    rng = np.random.default_rng(4)
    runs = [(tiny, rng.integers(0, 51, (8, 4))), (large, rng.integers(0, 65, (35, 10)))]
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        staged = [RawBatchStager(src, torch.device("cpu"))(rows) for src, rows in runs]
    tags = [r.tag for r in trace.records() if r.name == "outfitx.gather"]
    trace.clear()
    assert tags == [1, 4]
    for (src, rows), mb in zip(runs, staged):
        for k, v in _one_take(src, rows).items():
            assert np.array_equal(mb[k].numpy(), v), k
