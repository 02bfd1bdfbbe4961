"""The (data, model) device mesh and its placement helpers (the port of
``outfitx_tpu/core/mesh.py``).

JAX addresses a whole mesh from one process; the port uses a mesh in two
ways. Serving stays one process: the catalog's row shards live on the
mesh's devices (``ops/retrieval_sharded.py``). Training runs one process
per mesh position on ``torch.distributed`` (``parallel``): rank r sits at
``mesh_position(r, spec)``, the place the JAX device array gives device r.

A mesh's device list may name one device more than once. That is how the
CPU tests stand in for JAX's 8 fake devices, and how one card holds
several shards of a catalog.

A partition spec here is a tuple with one entry per tensor dimension: the
mesh axis that dimension is split over, or None (JAX's ``PartitionSpec``).
The placement helpers return the slice of a global tensor (numpy array or
torch tensor) that one mesh position holds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int
    model: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model


class Mesh:
    """A 2-D (data, model) grid of torch devices."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: np.ndarray):
        self.devices = devices  # (data, model) object array of torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _local_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass devices=[torch.device('cpu'), ...] "
            "to build a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    spec: Optional[MeshSpec] = None,
    devices: Optional[Sequence[torch.device | str]] = None,
) -> Mesh:
    """Build a 2-D (data, model) mesh.

    Defaults to every local card on the data axis (pure DP). ``devices``
    may repeat a device: ``[cuda:0] * 4`` is a 4-position mesh on one card.
    """
    devices = [torch.device(d) for d in (devices if devices is not None else _local_devices())]
    if spec is None:
        spec = MeshSpec(data=len(devices), model=1)
    if spec.n_devices > len(devices):
        raise ValueError(
            f"mesh {spec} needs {spec.n_devices} devices, have {len(devices)}"
        )
    grid = np.empty(spec.n_devices, dtype=object)
    grid[:] = devices[: spec.n_devices]
    return Mesh(grid.reshape(spec.data, spec.model))


def mesh_position(rank: int, spec: MeshSpec) -> Tuple[int, int]:
    """(data, model) coordinates of process ``rank``: row-major, as the JAX
    mesh reshapes its device list."""
    return rank // spec.model, rank % spec.model


def batch_sharding(mesh: Mesh) -> Spec:
    """Leading-axis (batch) split over the data axis."""
    return (DATA_AXIS,)


def shard_slice(x, spec: Spec, mesh_shape: Dict[str, int], position: Tuple[int, int]):
    """The block of ``x`` held at mesh ``position`` under ``spec``. A split
    dimension must divide its axis' size, as JAX requires."""
    coord = {DATA_AXIS: position[0], MODEL_AXIS: position[1]}
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        n, size = mesh_shape[axis], x.shape[dim]
        if size % n:
            raise ValueError(
                f"the size of dimension {dim}, split over the '{axis}' axis, "
                f"should be divisible by {n}, but it is equal to {size} "
                f"(full shape: {tuple(x.shape)})"
            )
        step = size // n
        index.append(slice(coord[axis] * step, (coord[axis] + 1) * step))
    return x[tuple(index)]


def shard_blocks(x, spec: Spec, blocks: int, mesh_shape: Dict[str, int], position):
    """``shard_slice`` of a tensor whose leading dimension stacks ``blocks``
    equal parts (QKV's [Q; K; V] rows): the leading-dimension split takes
    the same block of every part."""
    if blocks == 1 or spec[0] is None or mesh_shape[spec[0]] == 1:
        return shard_slice(x, spec, mesh_shape, position)
    parts = x.reshape((blocks, x.shape[0] // blocks) + tuple(x.shape[1:]))
    part = shard_slice(parts, (None,) + tuple(spec), mesh_shape, position)
    return part.reshape((-1,) + tuple(part.shape[2:]))


def join_blocks(pieces, axis: str, spec: Spec, blocks: int = 1):
    """The inverse of ``shard_blocks`` over one mesh axis: ``pieces`` holds
    the blocks at coordinates 0, 1, ... of ``axis`` (tensors or numpy
    arrays), joined along the dimension ``spec`` splits over it."""
    cat = torch.cat if torch.is_tensor(pieces[0]) else np.concatenate
    dim = spec.index(axis)
    if blocks == 1 or dim != 0:
        return cat(pieces, dim)
    parts = [p.reshape((blocks, p.shape[0] // blocks) + tuple(p.shape[1:])) for p in pieces]
    whole = cat(parts, 1)
    return whole.reshape((-1,) + tuple(whole.shape[2:]))


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def shard_batch(mesh: Mesh, batch, position: Tuple[int, int]):
    """The rows of each leaf of ``batch`` (split on axis 0 over 'data')
    that mesh ``position`` holds."""
    spec = batch_sharding(mesh)
    return _tree_map(lambda x: shard_slice(x, spec, mesh.shape, position), batch)


def shard_params(mesh: Mesh, params, specs, position: Tuple[int, int]):
    """Each leaf of ``params`` cut to its block at ``position`` by the
    matching leaf of ``specs`` (TP/FSDP layouts)."""
    return _tree_map(
        lambda x, s: shard_slice(x, s, mesh.shape, position), params, specs
    )
