"""The port's native (C++) host assembler (``outfitx_tpu_torch/native``) and
the samplers' ``impl`` routes, against the JAX package's on the CPU.

The same synthetic data and seeds go through both packages: the native
route's arrays are bit-equal to ``outfitx_tpu.native``'s (CIR train
batches, eval-loss negatives and eval queries, both curriculum modes, two
epochs), ``auto`` picks the JAX package's route, and the contract cases of
``tests/test_native_sampling.py`` hold for the port (invariants,
determinism, eval queries, the negatives contract, the bounded assembler
cache). Without g++ the native route raises with the compiler's message.
"""

import pathlib

import numpy as np
import pytest

from outfitx_tpu import native as jnative
from outfitx_tpu.data import sampler as jsampler
from outfitx_tpu.data.synthetic import make_synthetic as jax_synthetic
from outfitx_tpu_torch import native
from outfitx_tpu_torch.data import sampler as S
from outfitx_tpu_torch.data.synthetic import make_synthetic

ROOT = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(not native.available(), reason="no C++ toolchain")

L, K = 8, 5


@pytest.fixture(scope="module")
def synth():
    kw = dict(n_items=800, d_embed=16, n_outfits=512, seed=21)
    return jax_synthetic(**kw), make_synthetic(**kw)


def _batches(data, impl, epoch=0, k=K, mode="easy", pkg=S):
    return list(pkg.cir_train_batches(
        data.cir_train, data.catalog, batch_size=64, accum_steps=2, epoch=epoch,
        seed=7, n_negatives=k, sample_mode=mode, max_len=L, impl=impl,
    ))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_source_is_the_jax_package_copy():
    assert (ROOT / "outfitx_tpu_torch/native/sampling.cpp").read_bytes() == (
        ROOT / "outfitx_tpu/native/sampling.cpp"
    ).read_bytes()
    assert native.library_path().parent == ROOT / "build" / "outfitx_tpu_torch"


# ------------------------------------------------- bit-equal to JAX's --


@pytest.mark.parametrize("mode", ["easy", "hard"])
def test_train_batches_bit_equal_to_jax(synth, mode):
    jd, td = synth
    for epoch in (0, 1):
        want = _batches(jd, "native", epoch, mode=mode, pkg=jsampler)
        got = _batches(td, "native", epoch, mode=mode)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_same(g, w)


@pytest.mark.parametrize("mode", ["easy", "hard"])
def test_negatives_bit_equal_to_jax(synth, mode):
    jd, td = synth
    pos = np.random.default_rng(3).integers(0, td.catalog.n_items, 300).astype(np.int32)
    js, ts = jsampler.NegativeSampler(jd.catalog, mode), S.NegativeSampler(td.catalog, mode)
    for epoch in (0, 1):
        want = jsampler.sample_negatives_batch(js, pos, k=10, seed=4, epoch=epoch, impl="native")
        got = S.sample_negatives_batch(ts, pos, k=10, seed=4, epoch=epoch, impl="native")
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_eval_queries_bit_equal_to_jax(synth):
    jd, td = synth
    for seed in (0, 7):
        _assert_same(
            S.cir_eval_queries(td.cir_valid, td.catalog, seed=seed, max_len=L, impl="native"),
            jsampler.cir_eval_queries(jd.cir_valid, jd.catalog, seed=seed, max_len=L, impl="native"),
        )


# --------------------------------------------------------- auto route --


@pytest.mark.parametrize("built", [True, False], ids=["g++", "no g++"])
def test_auto_picks_the_jax_route(synth, monkeypatch, built):
    """``auto`` gives what the JAX package's ``auto`` gives, with and
    without the library; eval queries longer than 64 items take python."""
    jd, td = synth
    if not built:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    route = "native" if built else "python"
    for g, w, mine in zip(_batches(td, "auto"), _batches(jd, "auto", pkg=jsampler),
                          _batches(td, route)):
        _assert_same(g, w)
        _assert_same(g, mine)
    for max_len in (L, 65):
        want = jsampler.cir_eval_queries(jd.cir_valid, jd.catalog, seed=2, max_len=max_len)
        got = S.cir_eval_queries(td.cir_valid, td.catalog, seed=2, max_len=max_len)
        _assert_same(got, want)
        picked = route if max_len <= 64 else "python"
        _assert_same(got, S.cir_eval_queries(
            td.cir_valid, td.catalog, seed=2, max_len=max_len, impl=picked,
        ))
    pos = np.arange(0, 400, 3, dtype=np.int32)
    want = jsampler.sample_negatives_batch(
        jsampler.NegativeSampler(jd.catalog, "hard"), pos, k=K, seed=1, epoch=0)
    sampler = S.NegativeSampler(td.catalog, "hard")
    got = S.sample_negatives_batch(sampler, pos, k=K, seed=1, epoch=0)
    mine = S.sample_negatives_batch(
        sampler, pos, k=K, seed=1, epoch=0, impl="native" if built else "numpy")
    for g, w, m in zip(got, want, mine):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, m)


def test_native_route_without_gxx_raises_with_its_message(synth, monkeypatch, tmp_path):
    _, td = synth
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(S, "_NATIVE_ASSEMBLERS", type(S._NATIVE_ASSEMBLERS)())
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        _batches(td, "native")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        S.sample_negatives_batch(
            S.NegativeSampler(td.catalog, "easy"), np.zeros(4, np.int32),
            k=K, seed=0, epoch=0, impl="native",
        )
    # auto falls back to python and numpy
    _assert_same(_batches(td, "auto")[0], _batches(td, "python")[0])
    assert not list(tmp_path.glob("*.so"))


def test_assembler_refuses_what_it_would_read_outside():
    """The C entries trust their arrays: outfits longer than 64, lengths
    past their row or without an eligible member, and indices out of
    range are refused before a pointer is passed."""
    rows, ok = np.zeros((2, 4), np.int32), np.ones((2, 4), bool)
    keys = np.zeros(4, np.int32)
    kw = dict(pad_row=4, k=2, seed=0)
    with pytest.raises(ValueError, match="L=64"):
        native.CIRAssembler(np.zeros((2, 65), np.int32), np.ones(2, np.int32),
                            np.ones((2, 65), bool), keys, **kw)
    for lengths, elig in (([1, 5], ok), ([0, 2], ok), ([2, 2], np.zeros((2, 4), bool))):
        with pytest.raises(ValueError, match="eligible positive"):
            native.CIRAssembler(rows, np.asarray(lengths, np.int32), elig, keys, **kw)
        with pytest.raises(ValueError, match="eligible positive"):
            native.eval_assemble(rows, np.asarray(lengths, np.int32), elig, pad_row=4, seed=0)
    asm = native.CIRAssembler(rows, np.full(2, 2, np.int32), ok, keys, **kw)
    with pytest.raises(IndexError, match="outfit indices"):
        asm.assemble(np.array([0, 2]), epoch=0)
    with pytest.raises(IndexError, match="positive rows"):
        native.NegativeBatchSampler(keys, k=2, seed=0).sample(np.array([4], np.int32), 0)


# ----------------------------------------- the port's contract cases --


def test_invariants(synth):
    _, td = synth
    cat = td.catalog
    for batch in _batches(td, "native"):
        item_idx = batch["item_idx"].reshape(-1, L)
        mask = batch["mask"].reshape(-1, L)
        pos = batch["pos_idx"].ravel()
        neg = batch["neg_idx"].reshape(-1, K)
        negm = batch["neg_mask"].reshape(-1, K)
        # padded slots hold the pad row; real slots are real items
        assert (item_idx[mask] == cat.pad_row).all()
        assert (item_idx[~mask] < cat.n_items).all()
        for r in range(len(pos)):
            # the positive is never in its own partial outfit
            assert pos[r] not in item_idx[r][~mask[r]]
            # negatives share its semantic category, exclude it, distinct
            valid = neg[r][~negm[r]]
            assert pos[r] not in valid
            assert len(set(valid.tolist())) == len(valid)
            assert (cat.semantic_category[valid] == cat.semantic_category[pos[r]]).all()


def test_deterministic_and_epoch_varying(synth):
    _, td = synth
    a = _batches(td, "native", epoch=3)
    b = _batches(td, "native", epoch=3)
    c = _batches(td, "native", epoch=4)
    for x, y in zip(a, b):
        _assert_same(x, y)
    assert any(not np.array_equal(x["pos_idx"], z["pos_idx"]) for x, z in zip(a, c))


def test_eval_queries(synth):
    _, td = synth
    cat = td.catalog
    nat = S.cir_eval_queries(td.cir_valid, cat, seed=7, max_len=L, impl="native")
    py = S.cir_eval_queries(td.cir_valid, cat, seed=7, max_len=L, impl="python")
    for q in (nat, py):
        n = len(q["pos_idx"])
        assert q["item_idx"].shape == (n, L)
        for i in range(n):
            assert q["pos_idx"][i] not in q["item_idx"][i][~q["mask"][i]]
            assert (q["item_idx"][i][q["mask"][i]] == cat.pad_row).all()
        np.testing.assert_array_equal(q["pos_category"], cat.category_id[q["pos_idx"]])
    # the same outfits give the same query lengths on either route
    np.testing.assert_array_equal((~nat["mask"]).sum(1), (~py["mask"]).sum(1))
    again = S.cir_eval_queries(td.cir_valid, cat, seed=7, max_len=L, impl="native")
    np.testing.assert_array_equal(nat["pos_idx"], again["pos_idx"])


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_negatives_contract(synth, impl):
    _, td = synth
    cat = td.catalog
    sampler = S.NegativeSampler(cat, "easy")
    pos = np.random.default_rng(3).integers(0, cat.n_items, 200).astype(np.int32)
    neg, negm = S.sample_negatives_batch(sampler, pos, k=K, seed=7, epoch=2, impl=impl)
    assert neg.shape == negm.shape == (200, K)
    for r in range(200):
        valid = neg[r][~negm[r]]
        assert pos[r] not in valid
        assert len(set(valid.tolist())) == len(valid)
        assert (cat.semantic_category[valid] == cat.semantic_category[pos[r]]).all()
    again, _ = S.sample_negatives_batch(sampler, pos, k=K, seed=7, epoch=2, impl=impl)
    np.testing.assert_array_equal(neg, again)
    other, _ = S.sample_negatives_batch(sampler, pos, k=K, seed=7, epoch=3, impl=impl)
    assert not np.array_equal(neg, other)


def test_assembler_cache_is_bounded(monkeypatch):
    monkeypatch.setattr(S, "_NATIVE_ASSEMBLERS", type(S._NATIVE_ASSEMBLERS)())
    for seed in range(S._NATIVE_ASSEMBLERS_MAX + 2):
        data = make_synthetic(n_items=200, d_embed=8, n_outfits=256, seed=seed)
        assert _batches(data, "native")
        assert len(S._NATIVE_ASSEMBLERS) == min(seed + 1, S._NATIVE_ASSEMBLERS_MAX)
    assert S._NATIVE_ASSEMBLERS_MAX == 4


def test_aliased_cache_key_is_evicted_and_rebuilt(synth, monkeypatch):
    """An entry whose key names other objects (an ``id()`` reused after a
    collection) is dropped and built again from the data at hand."""
    _, td = synth
    monkeypatch.setattr(S, "_NATIVE_ASSEMBLERS", type(S._NATIVE_ASSEMBLERS)())
    want = _batches(td, "native")
    ((key, (_, _, stale)),) = S._NATIVE_ASSEMBLERS.items()
    other = make_synthetic(n_items=200, d_embed=8, n_outfits=256, seed=99)
    S._NATIVE_ASSEMBLERS[key] = (other.cir_train, other.catalog, stale)
    got = _batches(td, "native")
    split, catalog, fresh = S._NATIVE_ASSEMBLERS[key]
    assert split is td.cir_train and catalog is td.catalog and fresh is not stale
    for g, w in zip(got, want):
        _assert_same(g, w)
