"""The port's row-sharded retrieval against the JAX package's
``retrieve_sharded`` on 8 fake devices: the cases of
``tests/test_retrieval_sharded.py``, the port's 8 shards on the CPU (one
device named 8 times), indices equal and distances to 1e-5. The data are
continuous random values, so no two distances tie and the exact orders
are comparable."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outfitx_tpu.core.mesh import MeshSpec as JaxMeshSpec
from outfitx_tpu.core.mesh import make_mesh as jax_make_mesh
from outfitx_tpu.ops.quantization import quantize_catalog as jax_quantize
from outfitx_tpu.ops.retrieval_sharded import (
    catalog_row_sharding as jax_row_sharding,
    retrieve_quantized_sharded as jax_retrieve_quantized_sharded,
    retrieve_sharded as jax_retrieve_sharded,
)
from outfitx_tpu_torch.core.mesh import MeshSpec, make_mesh
from outfitx_tpu_torch.ops.quantization import (
    QuantizedCatalog,
    quantize_catalog,
    retrieve_quantized,
)
from outfitx_tpu_torch.ops.retrieval import retrieve
from outfitx_tpu_torch.ops.retrieval_sharded import (
    ShardedRows,
    catalog_row_sharding,
    pad_rows_to_shards,
    retrieve_quantized_sharded,
    retrieve_sharded,
    shard_quantized,
    shard_rows,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    return (
        make_mesh(MeshSpec(data=8), devices=["cpu"] * 8),
        jax_make_mesh(JaxMeshSpec(data=8, model=1)),
    )


def _pool(rng, n, d):
    return rng.standard_normal((n, d)).astype(np.float32)


def _padded(x, n_shards):
    n_pad = pad_rows_to_shards(x.shape[0], n_shards)
    return np.pad(x, ((0, n_pad - x.shape[0]), (0, 0)))


def _assert_same(got, want, single=None):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    if single is not None:
        np.testing.assert_array_equal(got[1].numpy(), single[1].numpy())


def test_dense_matches_jax_and_single_device(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(42)
    n, d, q, k = 777, 64, 16, 10  # ragged: pads to 8 x 98 = 784
    pool, queries = _pool(rng, n, d), _pool(rng, q, d)
    padded = _padded(pool, 8)
    want = jax_retrieve_sharded(
        jnp.asarray(queries), jax.device_put(padded, jax_row_sharding(jmesh)), k,
        mesh=jmesh, n_rows=n,
    )
    sharded = shard_rows(torch.from_numpy(padded), mesh)
    assert len(sharded.shards) == 8 and sharded.shard_rows == 98
    got = retrieve_sharded(torch.from_numpy(queries), sharded, k, mesh=mesh, n_rows=n)
    _assert_same(got, want, retrieve(torch.from_numpy(queries), torch.from_numpy(pool), k))
    assert int(got[1].max()) < n  # padded rows never win


def test_exact_fit_no_padding(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(1)
    pool, queries = _pool(rng, 512, 32), _pool(rng, 4, 32)
    want = jax_retrieve_sharded(jnp.asarray(queries), jnp.asarray(pool), 5, mesh=jmesh)
    got = retrieve_sharded(torch.from_numpy(queries), torch.from_numpy(pool), 5, mesh=mesh)
    _assert_same(got, want)


def test_bf16_pool(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(2)
    pool, queries = _pool(rng, 512, 32), _pool(rng, 4, 32)
    want = jax_retrieve_sharded(
        jnp.asarray(queries), jnp.asarray(pool, dtype=jnp.bfloat16), 5, mesh=jmesh
    )
    got = retrieve_sharded(
        torch.from_numpy(queries), torch.from_numpy(pool).bfloat16(), 5, mesh=mesh
    )
    _assert_same(got, want)


def test_rejects_undivisible_and_big_k(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_pool(rng, 2, 16))
    for pkg_mesh, call, cast in (
        (mesh, retrieve_sharded, torch.from_numpy),
        (jmesh, jax_retrieve_sharded, jnp.asarray),
    ):
        qq = cast(q.numpy())
        with pytest.raises(ValueError, match="pad to 104"):
            call(qq, cast(_pool(rng, 100, 16)), 5, mesh=pkg_mesh)  # 100 % 8 != 0
        with pytest.raises(ValueError, match="exceeds shard rows"):
            call(qq, cast(_pool(rng, 64, 16)), 9, mesh=pkg_mesh)  # 8 rows a shard


def test_quantized_matches_jax_and_single_device(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(4)
    n, d, q, k = 777, 64, 8, 10
    pool, queries = _pool(rng, n, d), _pool(rng, q, d)
    jqc = jax_quantize(jnp.asarray(_padded(pool, 8)))
    want = jax_retrieve_quantized_sharded(jnp.asarray(queries), jqc, k, mesh=jmesh, n_rows=n)
    qc = quantize_catalog(torch.from_numpy(_padded(pool, 8)))
    for field in ("values", "scales"):  # the same int8 table
        np.testing.assert_array_equal(getattr(qc, field).numpy(), np.asarray(getattr(jqc, field)))
    # the norms sum in another order
    np.testing.assert_allclose(qc.sq_norms.numpy(), np.asarray(jqc.sq_norms), rtol=1e-6)
    sharded = shard_quantized(qc, mesh)
    assert isinstance(sharded.values, ShardedRows)
    got = retrieve_quantized_sharded(torch.from_numpy(queries), sharded, k, mesh=mesh, n_rows=n)
    single = retrieve_quantized(
        torch.from_numpy(queries), quantize_catalog(torch.from_numpy(pool)), k
    )
    _assert_same(got, want, single)
    assert int(got[1].max()) < n


def test_approx_local_topk(meshes):
    """approx=True (the serving default) gives the exact answer here, as
    JAX's approx_max_k does on the CPU."""
    mesh, jmesh = meshes
    rng = np.random.default_rng(5)
    pool, queries = _pool(rng, 512, 32), _pool(rng, 4, 32)
    jqc = jax_quantize(jnp.asarray(pool))
    want = jax_retrieve_quantized_sharded(jnp.asarray(queries), jqc, 10, mesh=jmesh, approx=True)
    qc = QuantizedCatalog.from_numpy(
        *(np.asarray(getattr(jqc, f)) for f in ("values", "scales", "sq_norms"))
    )
    got = retrieve_quantized_sharded(torch.from_numpy(queries), qc, 10, mesh=mesh, approx=True)
    _assert_same(got, want)


def test_sharded_rows_gather_and_write(meshes):
    """``ShardedRows`` indexing gathers rows across shards in any index
    shape; ``index_copy_`` writes each row into its owner."""
    mesh, _ = meshes
    table = torch.arange(64 * 3, dtype=torch.float32).reshape(64, 3)
    sharded = shard_rows(table, mesh)
    assert catalog_row_sharding(mesh) == [torch.device("cpu")] * 8
    rows = torch.tensor([[0, 9, 63], [8, 7, 40]])
    torch.testing.assert_close(sharded[rows], table[rows])
    vals = -torch.ones(3, 3)
    sharded.index_copy_(0, torch.tensor([1, 30, 62]), vals)
    table[[1, 30, 62]] = vals
    torch.testing.assert_close(torch.cat(sharded.shards), table)
