"""The PyTorch port's collate layer (``data/types.py``,
``data/processors.py``) against the JAX package's: the same items give
equal batches (exact: both are numpy copies), the factory dispatches each
task type, and every processor pickles."""

import pickle

import numpy as np
import pytest

from outfitx_tpu.data import processors as jproc
from outfitx_tpu.data import types as jtypes
from outfitx_tpu_torch.data import processors as tproc
from outfitx_tpu_torch.data import types as ttypes

D = 12


def _items(types, rng, n, start=0):
    return [
        types.FashionItem(
            item_id=start + i, category=f"cat {i % 3}", description=f"item {start + i}",
            image=rng.integers(0, 256, (3, 4, 4), dtype=np.uint8),
            embedding=rng.standard_normal(D).astype(np.float32),
        )
        for i in range(n)
    ]


def _batch(types, task, seed=0):
    """A batch of ``task`` built from one numpy stream: outfits of 2..6
    items (some longer than max_len), negatives of ragged count."""
    rng = np.random.default_rng(seed)
    batch = []
    for i, n in enumerate((2, 4, 6, 3)):
        outfit = _items(types, rng, n, start=10 * i)
        target = _items(types, rng, 1, start=100 + i)[0]
        if task == "cp":
            batch.append((types.OutfitCompatibilityPredictionTask(outfit=outfit), float(i % 2)))
        elif task == "cir":
            negs = [rng.standard_normal(D).astype(np.float32) for _ in range(2 + 3 * i)]
            batch.append((types.OutfitComplementaryItemRetrievalTask(
                outfit=outfit, target_item=target), negs))
        elif task == "fitb":
            cands = rng.standard_normal((4, D)).astype(np.float32)
            batch.append((types.OutfitFillInTheBlankTask(
                outfit=outfit, target_item=target), cands, i % 4))
        else:
            batch.append(types.OutfitPrecomputeEmbeddingTask(fashion_item=target))
    return batch


TASKS = {
    "cp": ("OutfitCompatibilityPredictionTask", "CPProcessor", dict(max_len=5)),
    "cir": ("OutfitComplementaryItemRetrievalTask", "CIRProcessor",
            dict(max_len=5, n_negatives=6)),
    "fitb": ("OutfitFillInTheBlankTask", "FITBProcessor", dict(max_len=5)),
    "precompute": ("OutfitPrecomputeEmbeddingTask", "PrecomputeProcessor", {}),
}


@pytest.mark.parametrize("task", sorted(TASKS))
def test_processor_matches_jax(task):
    _, proc, kw = TASKS[task]
    want = getattr(jproc, proc)(**kw)(_batch(jtypes, task))
    got = getattr(tproc, proc)(**kw)(_batch(ttypes, task))
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], list):
            assert len(got[k]) == len(want[k]), k
            for a, b in zip(got[k], want[k]):
                assert np.array_equal(np.asarray(a), np.asarray(b)), k
        else:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), k


def test_factory_dispatch_and_pickle():
    for task_name, proc, kw in TASKS.values():
        task_type = getattr(ttypes, task_name)
        p = tproc.ProcessorFactory.get_processor(task_type, **kw)
        assert type(p) is getattr(tproc, proc)
        back = pickle.loads(pickle.dumps(p))
        assert type(back) is type(p) and back == p
    with pytest.raises(KeyError, match="no processor"):
        tproc.ProcessorFactory.get_processor(int)


def test_text_embedding_is_the_second_half():
    item = ttypes.FashionItem(item_id=1, embedding=np.arange(8, dtype=np.float32))
    np.testing.assert_array_equal(item.text_embedding, [4, 5, 6, 7])
    kept = ttypes.FashionItem(item_id=2, embedding=np.zeros(4), text_embedding=np.ones(2))
    np.testing.assert_array_equal(kept.text_embedding, [1, 1])
