"""The port's mesh, its placement helpers and the multi-process bring-up,
against the JAX package's ``core/mesh.py`` and ``MeshConfig`` on its 8
fake devices; ``gather_global`` and the launcher-environment bring-up
across 2 gloo processes on the CPU."""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P
from outfitx_tpu.core import config as jcfg
from outfitx_tpu.core.mesh import MeshSpec as JaxMeshSpec
from outfitx_tpu.core.mesh import make_mesh as jax_make_mesh
from outfitx_tpu.core.mesh import shard_batch as jax_shard_batch
from outfitx_tpu.core.mesh import shard_params as jax_shard_params
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    MeshSpec,
    batch_sharding,
    make_mesh,
    mesh_position,
    shard_batch,
    shard_params,
)
from outfitx_tpu_torch.parallel import choose_backend, gather_global, setup_parallel

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU8 = ["cpu"] * 8


def test_axis_names_and_spec_defaults():
    import outfitx_tpu.core.mesh as jmesh

    assert (DATA_AXIS, MODEL_AXIS) == (jmesh.DATA_AXIS, jmesh.MODEL_AXIS)
    assert MeshSpec(data=4).model == jmesh.MeshSpec(data=4).model == 1
    assert MeshSpec(4, 2).n_devices == jmesh.MeshSpec(4, 2).n_devices == 8


@pytest.mark.parametrize("spec", [None, (8, 1), (4, 2), (2, 4), (2, 2), (1, 1)])
def test_mesh_shape_and_rank_positions_match_jax(spec):
    """The port's grid has JAX's shape, and rank r's position is where the
    JAX device array holds device r."""
    jspec = None if spec is None else JaxMeshSpec(*spec)
    tspec = None if spec is None else MeshSpec(*spec)
    jm = jax_make_mesh(jspec)
    tm = make_mesh(tspec, devices=CPU8)
    assert tm.shape == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names)
    ids = np.vectorize(lambda d: d.id)(np.asarray(jm.devices))
    for rank in range(tm.size):
        pos = mesh_position(rank, MeshSpec(tm.shape[DATA_AXIS], tm.shape[MODEL_AXIS]))
        assert ids[pos] == jax.devices()[rank].id


def test_make_mesh_errors_match_jax():
    with pytest.raises(ValueError, match=r"needs 16 devices, have 8"):
        jax_make_mesh(JaxMeshSpec(data=8, model=2))
    with pytest.raises(ValueError, match=r"needs 16 devices, have 8"):
        make_mesh(MeshSpec(data=8, model=2), devices=CPU8)


def test_make_mesh_defaults_to_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


@pytest.mark.parametrize(
    "data, model, n", [(-1, 1, 8), (-1, 2, 8), (-1, 3, 8), (2, 2, 8), (3, 1, 4), (-1, 0, 8), (-1, 16, 8)]
)
def test_mesh_config_resolve_matches_jax(data, model, n):
    assert tcfg.MeshConfig(data, model).resolve(n) == jcfg.MeshConfig(data, model).resolve(n)


def test_mesh_config_fields_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(tcfg.MeshConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jcfg.MeshConfig)
    ]
    for cls in ("CPTrainConfig", "CIRTrainConfig", "FITBTrainConfig"):
        assert getattr(tcfg, cls)().mesh == tcfg.MeshConfig()


def test_placement_helpers_hold_jax_shards():
    """The block ``shard_batch``/``shard_params`` give position (d, m)
    equals the addressable shard JAX puts on device (d, m)."""
    rng = np.random.default_rng(0)
    jm = jax_make_mesh(JaxMeshSpec(data=4, model=2))
    tm = make_mesh(MeshSpec(4, 2), devices=CPU8)
    batch = {"x": rng.standard_normal((8, 3)).astype(np.float32), "y": np.arange(16).reshape(8, 2)}
    params = {"w": rng.standard_normal((6, 4)).astype(np.float32), "b": np.arange(4.0)}
    jspecs = {"w": P("data", "model"), "b": P(None)}
    tspecs = {"w": (DATA_AXIS, MODEL_AXIS), "b": (None,)}
    jb = jax_shard_batch(jm, batch)
    for call in (
        lambda: jax_shard_params(jm, params, jspecs),  # 6 rows over data=4
        lambda: shard_params(tm, params, tspecs, (0, 0)),
    ):
        with pytest.raises(ValueError, match="divisible by 4, but it is equal to 6"):
            call()
    params["w"] = rng.standard_normal((8, 4)).astype(np.float32)
    jp = jax_shard_params(jm, params, jspecs)
    devices = np.asarray(jm.devices)
    assert batch_sharding(tm) == (DATA_AXIS,)
    for d in range(4):
        for m in range(2):
            dev = devices[d, m]
            mine_b = shard_batch(tm, batch, (d, m))
            mine_p = shard_params(tm, params, tspecs, (d, m))
            for tree, mine in ((jb, mine_b), (jp, mine_p)):
                for k, arr in tree.items():
                    (shard,) = [s for s in arr.addressable_shards if s.device == dev]
                    np.testing.assert_array_equal(mine[k], np.asarray(shard.data))


def test_backend_follows_the_layout(monkeypatch):
    """NCCL where every local rank has a card of its own, else gloo."""
    assert choose_backend(torch.device("cpu"), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert choose_backend(torch.device("cuda", 0), 1) == "nccl"
    assert choose_backend(torch.device("cuda", 0), 2) == "gloo"  # two ranks share it


def test_one_process_needs_no_group():
    assert setup_parallel(tcfg.MeshConfig(), "cpu") is None
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        setup_parallel(tcfg.MeshConfig(data=2, model=2), "cpu")
    x = torch.arange(3)
    assert gather_global({"a": x})["a"] is x


_WORKER = r'''
import json, os, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
import torch.distributed as dist
from outfitx_tpu_torch.core.config import MeshConfig
from outfitx_tpu_torch.parallel import gather_global, maybe_initialize_distributed, setup_parallel
assert not dist.is_initialized()
started = maybe_initialize_distributed("cpu")
again = maybe_initialize_distributed("cpu")
rank = dist.get_rank()
par = setup_parallel(MeshConfig(data=-1, model=1), "cpu")
rows = torch.full((2, 3), float(rank))
out = gather_global({"rows": rows, "scalar": torch.tensor(10.0 + rank), "list": [rows[:1]]},
                    group=par.groups["data"])
bad = None
try:
    setup_parallel(MeshConfig(data=1, model=1), "cpu")
except ValueError as e:
    bad = str(e)
print(json.dumps({
    "started": started, "again": again, "backend": dist.get_backend(), "rank": rank,
    "position": list(par.position), "rows": out["rows"].tolist(),
    "scalar": out["scalar"].tolist(), "list": out["list"][0].tolist(), "bad": bad,
}))
dist.destroy_process_group()
'''


def test_two_process_bring_up_and_gather_global(tmp_path):
    """RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT bring the default group up
    on gloo (the CPU); ``gather_global`` joins the ranks' rows in rank
    order; a mesh that leaves a process without a position fails."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(REPO)],
            env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(2)
    ]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    for r, got in enumerate(res):
        assert got["started"] is True and got["again"] is False
        assert got["backend"] == "gloo" and got["rank"] == r
        assert got["position"] == [r, 0]
        assert got["rows"] == [[0.0] * 3] * 2 + [[1.0] * 3] * 2
        assert got["scalar"] == [10.0, 11.0]
        assert got["list"] == [[0.0] * 3, [1.0] * 3]
        assert "every process needs a position" in got["bad"]


def test_importing_parallel_starts_no_group():
    code = (
        "import torch.distributed as dist\n"
        "import outfitx_tpu_torch, outfitx_tpu_torch.parallel\n"
        "import outfitx_tpu_torch.train.harness, outfitx_tpu_torch.serve.engine\n"
        "assert not dist.is_initialized()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, RANK="0", WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
