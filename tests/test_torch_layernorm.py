"""The PyTorch port's LayerNorm against the JAX package's: the forward
against the Pallas kernel in interpret mode (eps 1e-5) and against
``_ln_reference`` (eps 1e-6), the ``LayerNormFn`` gradients against
``jax.grad`` through the Pallas kernel's custom VJP, and the wrapper's checks.
On the CPU the port runs its plain version; the CUDA kernel itself is held
against that plain version on the card by ``chip_smoke.py``."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.ops import layernorm as jax_ln
from outfitx_tpu_torch.ops import layernorm as ln

torch.set_num_threads(1)

# float32: the same arithmetic, sums taken in another order.
F32_TOL = 1e-5
# bfloat16: both compute in float32 and round once; a last-bit difference
# before the rounding may flip it, so one ulp of the output.
BF16_ULP_REL = 2.0**-7

SHAPES = [(8, 64), (5, 17, 96), (3, 1536), (13, 100), (2, 3, 7, 33), (1, 1)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, w, b


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _assert_one_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= BF16_ULP_REL * np.maximum(np.abs(want), 1.0))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_pallas_kernel_f32(shape):
    x, w, b = _inputs(shape, 0)
    want = jax_ln.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), impl="pallas")
    got = ln.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("shape", SHAPES[:4], ids=str)
def test_forward_matches_pallas_kernel_bf16(shape):
    """bfloat16 activations with float32 parameters, as the models call it."""
    x, w, b = _inputs(shape, 1)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax_ln.layer_norm(xj, jnp.asarray(w), jnp.asarray(b), impl="pallas")
    got = ln.layer_norm(_bf16(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    _assert_one_ulp(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference_at_siglip_eps(dtype):
    """eps is an argument: the SigLIP towers' 1e-6 (the Pallas kernel is
    fixed at 1e-5, so the JAX side is its plain reference)."""
    x, w, b = _inputs((9, 4, 768), 2)
    # Small inputs, so that eps is not negligible beside the variance.
    x = x * 1e-3
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    want = jax_ln._ln_reference(xj, jnp.asarray(w), jnp.asarray(b), eps=1e-6)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ln.layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b), eps=1e-6)
    other = ln.layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b), eps=1e-5)
    assert not torch.equal(got, other)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
    else:
        _assert_one_ulp(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_constant_and_sentinel_rows():
    """A row of one value has variance 0 and gives exactly the bias; a row
    around the catalog's spare-row sentinel stays finite in bfloat16."""
    x, w, b = _inputs((5, 64), 3)
    x[0], x[1], x[2] = 0.5, 1.0e4, 0.0
    x[3] = 1.0e4 + x[3]
    for dtype in (torch.float32, torch.bfloat16):
        got = ln.layer_norm(
            torch.from_numpy(x).to(dtype), torch.from_numpy(w), torch.from_numpy(b)
        )
        assert torch.isfinite(got.float()).all()
        for r in range(3):
            assert torch.equal(got[r], torch.from_numpy(b).to(dtype))


@pytest.mark.parametrize("shape", [(8, 64), (5, 17, 96), (13, 100)], ids=str)
def test_gradients_match_pallas_custom_vjp(shape):
    x, w, b = _inputs(shape, 4)
    g = np.random.default_rng(5).standard_normal(shape).astype(np.float32)

    def loss(xj, wj, bj):
        return jnp.sum(jax_ln.layer_norm(xj, wj, bj, impl="pallas") * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    out = ln.layer_norm(xt, wt, bt)
    assert isinstance(out.grad_fn, ln.LayerNormFn._backward_cls)
    out.backward(torch.from_numpy(g))
    for got, ref in zip((xt.grad, wt.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_gradients_bf16_input_f32_parameters():
    """The training dtypes: dx comes back in bfloat16, the parameters'
    gradients in float32, equal to the JAX closed form within one ulp of dx."""
    shape = (6, 9, 64)
    x, w, b = _inputs(shape, 6)
    g = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    gb = g.astype(ml_dtypes.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax_ln._ln_bwd((xj, jnp.asarray(w), jnp.asarray(b)), jnp.asarray(gb))
    xt = _bf16(x).requires_grad_()
    wt, bt = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    ln.layer_norm(xt, wt, bt).backward(torch.from_numpy(gb.astype(np.float32)).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    _assert_one_ulp(xt.grad.float().numpy(), np.asarray(want[0].astype(jnp.float32)))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-4)


def test_closed_form_equals_autograd_through_the_plain_version():
    x, w, b = (torch.from_numpy(a) for a in _inputs((7, 5, 48), 8))
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((7, 5, 48)).astype(np.float32))
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    want = torch.autograd.grad(ln.layer_norm_reference(xr, wr, br, 1e-6), (xr, wr, br), g)
    got = ln.layer_norm_bwd_reference(x, w, b, g, 1e-6)
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5, atol=1e-5)


def test_function_saves_only_its_inputs():
    x, w, b = (torch.from_numpy(a).requires_grad_() for a in _inputs((4, 32), 10))
    out = ln.layer_norm(x, w, b)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3
    assert all(s.data_ptr() == t.data_ptr() for s, t in zip(saved, (x, w, b)))


def test_no_function_without_grad():
    x, w, b = (torch.from_numpy(a) for a in _inputs((4, 32), 11))
    assert ln.layer_norm(x, w, b).grad_fn is None
    w.requires_grad_()
    with torch.no_grad():
        assert ln.layer_norm(x, w, b).grad_fn is None


def test_cpu_call_launches_no_kernel():
    x, w, b = (torch.from_numpy(a) for a in _inputs((4, 32), 12))
    before = ln.layer_norm.launches
    ln.layer_norm(x, w, b)
    assert ln.layer_norm.launches == before


@pytest.mark.parametrize(
    "case",
    ["dtype", "weight_shape", "bias_shape", "no_rows", "scalar"],
)
def test_wrapper_checks_raise(case):
    """The checks that the CUDA path runs before it launches, on CPU
    tensors: nothing here needs a card."""
    x, w, b = (torch.from_numpy(a) for a in _inputs((4, 32), 13))
    if case == "dtype":
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            ln._prepare(x.double(), w, b)
    elif case == "weight_shape":
        with pytest.raises(ValueError, match="weight must be"):
            ln._prepare(x, w[:16], b)
    elif case == "bias_shape":
        with pytest.raises(ValueError, match="bias must be"):
            ln._prepare(x, w, b[None])
    elif case == "no_rows":
        with pytest.raises(ValueError, match="at least one row"):
            ln._prepare(x[:0], w, b)
    else:
        with pytest.raises(ValueError, match="last axis"):
            ln._prepare(torch.tensor(1.0), w, b)


def test_wrapper_contiguity_and_alignment_checks():
    x = torch.zeros(8, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ln._check_aligned(x=x[:, ::2])
    # A tensor over a numpy buffer that starts 4 bytes into an allocation.
    raw = np.zeros(8 * 32 + 1, np.float32)
    off = torch.from_numpy(raw[1:]).reshape(8, 32)
    aligned = torch.from_numpy(raw[:-1]).reshape(8, 32)
    assert aligned.data_ptr() % 16 == 0 or off.data_ptr() % 16 == 0
    bad = off if off.data_ptr() % 16 else aligned
    with pytest.raises(ValueError, match="16-byte aligned"):
        ln._check_aligned(x=bad)


def test_prepare_flattens_casts_and_makes_contiguous():
    x, w, b = (torch.from_numpy(a) for a in _inputs((3, 5, 32), 14))
    xt = x.transpose(0, 1)  # not contiguous
    x2, w2, b2 = ln._prepare(xt.to(torch.bfloat16), w.double(), b.to(torch.bfloat16))
    assert tuple(x2.shape) == (15, 32) and x2.is_contiguous()
    assert w2.dtype == b2.dtype == torch.float32
    assert torch.equal(x2.reshape(5, 3, 32), xt.to(torch.bfloat16))


# ---- the launch path ---------------------------------------------------------


class _FakeEntry:
    """A C entry that records its calls and how often its argtypes are set."""

    def __init__(self):
        self.calls = []
        self.argtypes_sets = 0
        self._argtypes = None
        self.restype = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.argtypes_sets += 1
        self._argtypes = value

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _fake_kernel(monkeypatch, load):
    """The kernel branch on CPU tensors, with ``load`` as the loader and a
    stand-in for PyTorch's current-stream accessor."""
    monkeypatch.setattr(ln, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(ln._launch._build, "load", load)
    monkeypatch.setattr(
        torch._C, "_cuda_getCurrentRawStream", lambda index: 0x5000 + index, raising=False
    )


def test_launch_binds_once_and_hands_over_the_current_stream(monkeypatch):
    entry = _FakeEntry()
    lib = type("Lib", (), {"layernorm": entry})()
    loads = []

    def load(name):
        loads.append(name)
        return lib

    _fake_kernel(monkeypatch, load)
    x, w, b = (torch.from_numpy(a) for a in _inputs((2, 3, 64), 15))
    before = ln.layer_norm.launches
    for _ in range(3):
        out = ln.layer_norm(x.to(torch.bfloat16), w, b, eps=1e-6)
        assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert loads == ["layernorm"] * 3  # the loader is asked every time
    assert entry.argtypes_sets == 1 and len(entry.argtypes) == 9
    assert ln.layer_norm.launches == before + 3
    for args in entry.calls:
        assert args[4:8] == (6, 64, 1e-6, 1)
        assert args[8] == 0x5000 + x.get_device()


def test_a_failing_load_is_asked_again(monkeypatch):
    """Only a loaded library's binding is kept: after a failed build the
    next call loads anew, and raises again if the loader does."""
    entry = _FakeEntry()
    lib = type("Lib", (), {"layernorm": entry})()
    attempts = []

    def load(name):
        attempts.append(name)
        if len(attempts) <= 2:
            raise RuntimeError(f"cannot build {name}")
        return lib

    _fake_kernel(monkeypatch, load)
    x, w, b = (torch.from_numpy(a) for a in _inputs((4, 32), 16))
    before = ln.layer_norm.launches
    for _ in range(2):
        with pytest.raises(RuntimeError, match="cannot build layernorm"):
            ln.layer_norm(x, w, b)
    assert ln.layer_norm.launches == before and entry.calls == []
    for _ in range(2):
        ln.layer_norm(x, w, b)
    assert len(attempts) == 4 and entry.argtypes_sets == 1
    assert ln.layer_norm.launches == before + 2


def test_a_new_library_is_bound_anew(monkeypatch):
    """The binding is keyed on the loaded library, so a rebuilt (or another
    test's) library gets its own argtypes."""
    libs = [type("Lib", (), {"layernorm": _FakeEntry()})() for _ in range(2)]
    current = []
    _fake_kernel(monkeypatch, lambda name: current[-1])
    x, w, b = (torch.from_numpy(a) for a in _inputs((4, 32), 17))
    for lib in libs + libs[1:]:
        current.append(lib)
        ln.layer_norm(x, w, b)
    assert [lib.layernorm.argtypes_sets for lib in libs] == [1, 1]
    assert [len(lib.layernorm.calls) for lib in libs] == [1, 2]


def test_prepare_leaves_ready_operands_alone():
    """float32 contiguous parameters and a contiguous 2-D input go to the
    kernel as they are: no cast, copy or reshape on the launch path."""
    x, w, b = (torch.from_numpy(a) for a in _inputs((6, 32), 18))
    x2, w2, b2 = ln._prepare(x, w, b)
    assert x2 is x and w2 is w and b2 is b
