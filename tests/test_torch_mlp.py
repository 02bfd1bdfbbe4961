"""The PyTorch port's fused tower MLP against the JAX package's.

On the CPU ``mlp_fused`` runs its plain version; it is held against the JAX
Pallas kernel (interpret mode off-TPU) on the same numpy inputs, in float32
at 1e-5 and in bfloat16 within 2 ulps at O(1), for all three activations
and a row count no tile divides. The CUDA kernel itself is held against the
same plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from outfitx_tpu.ops.mlp import mlp_fused as jax_mlp_fused
from outfitx_tpu_torch.ops import activations
from outfitx_tpu_torch.ops import mlp as mlp_mod
from outfitx_tpu_torch.ops.mlp import mlp_fused, mlp_fused_reference

torch.set_num_threads(1)

TOL = 1e-5
ACTS = ["quick_gelu", "gelu_tanh", "gelu"]


def _inputs(shape, d_mlp, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w1 = rng.uniform(-1, 1, (d, d_mlp)).astype(np.float32) / np.sqrt(d)
    b1 = rng.uniform(-1, 1, (d_mlp,)).astype(np.float32) / np.sqrt(d)
    w2 = rng.uniform(-1, 1, (d_mlp, d)).astype(np.float32) / np.sqrt(d_mlp)
    b2 = rng.uniform(-1, 1, (d,)).astype(np.float32) / np.sqrt(d_mlp)
    return [a.astype(np.float32) for a in (x, w1, b1, w2, b2)]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype).clone() for a in arrays]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", [(4, 16, 64), (3, 7, 64), (1000, 64)])
def test_mlp_fused_matches_jax(shape, act):
    """(3, 7, 64) and (1000, 64) are row counts the JAX kernel pads."""
    arrays = _inputs(shape, 96, seed=len(shape))
    want = np.asarray(jax_mlp_fused(*(jnp.asarray(a) for a in arrays), act=act))
    got = mlp_fused(*_torch(arrays), act=act)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("act", ACTS)
def test_bfloat16_rounds_the_mid_tensor_like_jax(act):
    """The mid tensor and the output round to bfloat16 in both, and float32
    weights are cast to x's dtype first: 2 bf16 ulps at O(1)."""
    arrays = _inputs((5, 9, 64), 96, seed=5)
    x = jnp.asarray(arrays[0], dtype=jnp.bfloat16)
    want = jax_mlp_fused(x, *(jnp.asarray(a) for a in arrays[1:]), act=act)
    tx = torch.from_numpy(arrays[0]).to(torch.bfloat16)
    got = mlp_fused(tx, *_torch(arrays[1:]), act=act)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        rtol=2.0**-7, atol=2.0**-7,
    )


@pytest.mark.parametrize(
    "name, jax_fn",
    [
        ("quick_gelu", lambda x: x * jax.nn.sigmoid(1.702 * x)),
        ("gelu_tanh", lambda x: jax.nn.gelu(x, approximate=True)),
        ("gelu", lambda x: jax.nn.gelu(x, approximate=False)),
    ],
)
def test_tower_activations(name, jax_fn):
    x = np.linspace(-30.0, 30.0, 2001, dtype=np.float32)
    got = activations.TOWER_ACTIVATIONS[name](torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_fn(jnp.asarray(x))), rtol=0, atol=TOL
    )


def test_gelu_forms_differ():
    x = torch.linspace(-3, 3, 101)
    gap = (activations.gelu(x) - activations.gelu_tanh(x)).abs().max()
    assert 1e-5 < float(gap) < 1e-2


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        mlp_fused(*_torch(_inputs((4, 64), 96)), act="swish")


def test_cpu_tensors_never_launch_the_kernel():
    before = mlp_fused.launches
    mlp_fused(*_torch(_inputs((4, 64), 96)))
    assert mlp_fused.launches == before


def test_kernel_branch_swallows_no_error(monkeypatch):
    """With the kernel predicate true, a failing kernel load reaches the
    caller, and the plain version is not run in its place."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args)
        return mlp_fused_reference(*args, **kwargs)

    def broken_load(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(mlp_mod, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(mlp_mod._launch._build, "load", broken_load)
    monkeypatch.setattr(mlp_mod, "mlp_fused_reference", spy)
    before = mlp_fused.launches
    with pytest.raises(RuntimeError, match="cannot build mlp_fused"):
        mlp_fused(*_torch(_inputs((4, 64), 96)))
    assert calls == []
    assert mlp_fused.launches == before


@pytest.mark.parametrize(
    "d, d_mlp, dtype, error",
    [
        (72, 96, torch.float32, ValueError),  # d not a multiple of 16
        (64, 100, torch.float32, ValueError),  # d_mlp not a multiple of 16
        (784, 96, torch.float32, ValueError),  # d above 768
        (64, 96, torch.float16, TypeError),  # dtype the kernel lacks
    ],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(
    monkeypatch, d, d_mlp, dtype, error
):
    monkeypatch.setattr(mlp_mod, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(
        mlp_mod._launch._build, "load", lambda name: pytest.fail("kernel was loaded")
    )
    x = torch.zeros((4, d), dtype=dtype)
    w1, b1 = torch.zeros((d, d_mlp)), torch.zeros(d_mlp)
    w2, b2 = torch.zeros((d_mlp, d)), torch.zeros(d)
    with pytest.raises(error):
        mlp_fused(x, w1, b1, w2, b2)


@pytest.mark.parametrize(
    "rows, d_mlp, want",
    [
        (1000, 96, 1000),  # fits whole
        (4096, 2048, 4096),  # the CLIP text tower's batch fits whole
        (131072, 3072, 87296),  # text rows: whole 128-row tiles under 512 MiB
        (401408, 3072, 87296),  # vision rows: the same chunk, five chunks
        (5000, 1 << 22, 128),  # one tile at the least
    ],
)
def test_mid_scratch_rows(rows, d_mlp, want):
    assert mlp_mod.mid_rows(rows, d_mlp) == want


def _fake_launch(monkeypatch, module):
    """Replaces the kernel with a recorder of its C arguments (success)."""
    calls = []

    def bind(name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append(args)
            return 0
        return fn

    monkeypatch.setattr(module, "_wants_kernel", lambda t: True)
    monkeypatch.setattr(module._launch, "bind", bind)
    monkeypatch.setattr(module._launch, "current_stream", lambda index: 0)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_hands_bfloat16_its_mid_scratch_in_chunks(monkeypatch, dtype):
    """bfloat16 gets a (mid_rows, d_mlp) scratch, here smaller than the rows
    so that the kernel walks them in chunks; float32 gets none. One call is
    one launch whatever the chunks."""
    calls = _fake_launch(monkeypatch, mlp_mod)
    monkeypatch.setattr(mlp_mod, "MID_SCRATCH_BYTES", 3 * 128 * 96 * 2)
    x, w1, b1, w2, b2 = _torch(_inputs((1000, 64), 96), dtype)
    before = mlp_fused.launches
    out = mlp_fused(x, w1, b1, w2, b2, act="gelu_tanh")
    assert out.shape == x.shape and out.dtype == dtype
    assert mlp_fused.launches == before + 1
    (args,) = calls
    mid, mid_rows, rows, d, d_mlp, act, code = args[6:13]
    assert (rows, d, d_mlp, act) == (1000, 64, 96, 1)
    if dtype == torch.bfloat16:
        assert mid is not None and mid_rows == 384 and code == 1
    else:
        assert mid is None and mid_rows == 0 and code == 0
