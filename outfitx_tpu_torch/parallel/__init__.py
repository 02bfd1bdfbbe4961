"""Parallelism: the mesh, the process groups and their collectives (the
port of ``outfitx_tpu/parallel/__init__.py``).

- ``make_mesh(MeshSpec(data, model))``: a (data, model) grid of devices;
  the serving engine row-shards its catalog over one
- ``shard_params`` / ``shard_batch``: the block a mesh position holds
- ``maybe_initialize_distributed()``: the default process group from the
  launcher's environment (``torchrun``: RANK, WORLD_SIZE, MASTER_ADDR,
  MASTER_PORT, LOCAL_RANK)
- ``setup_parallel(mesh_cfg)``: this process's ``ParallelContext``, its
  (data, model) position and the two axis groups
- ``gather_global``: every rank's rows of a tree of tensors

JAX runs one program over the whole mesh and XLA inserts the collectives.
Training here runs one process per mesh position, and the collectives are
explicit: Megatron's f and g around each tensor-parallel block, FSDP's
all-gather of a layer's matrices and reduce-scatter of their gradients,
and one all-reduce of the gradients over the data axis per optimizer step.

The backend follows from the layout: NCCL where every rank on a host has a
card of its own, gloo where ranks share a card or run on the CPU (NCCL
refuses two ranks on one device). gloo takes CUDA tensors for every
collective used here and stages them through host memory. A collective over
a group of one rank moves nothing and is skipped. Importing this module
starts no process group.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from outfitx_tpu_torch.core.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshSpec,
    batch_sharding,
    join_blocks,
    make_mesh,
    mesh_position,
    shard_blocks,
    shard_batch,
    shard_params,
    shard_slice,
)

log = logging.getLogger(__name__)


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """'nccl' when every local rank has a card of its own, else 'gloo'."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: card LOCAL_RANK modulo the host's cards (ranks
    share a card when there are more ranks than cards), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    idx = int(os.environ.get("LOCAL_RANK", dev.index or 0)) % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def maybe_initialize_distributed(device: str | torch.device = "cuda") -> bool:
    """Set up the default process group from the launcher's environment
    (RANK and WORLD_SIZE set, MASTER_ADDR/MASTER_PORT for the rendezvous),
    with the backend ``choose_backend`` gives, and set the local device.
    Returns False, doing nothing, when the environment names no launcher
    or the group exists already."""
    if dist.is_initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dev = local_device(device)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    backend = choose_backend(dev, local_world)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]), **kwargs,
    )
    log.info(
        "process group: backend %s, rank %d of %d, device %s",
        backend, dist.get_rank(), dist.get_world_size(), dev,
    )
    return True


def gather_global(tree, group=None):
    """``tree`` with each tensor leaf replaced by the concatenation along
    axis 0 of every rank's leaf in ``group`` (0-d leaves are stacked), in
    rank order. A no-op in one process or a group of one rank."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return tree
    if isinstance(tree, dict):
        return {k: gather_global(v, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_global(v, group) for v in tree)
    x = tree.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts) if x.dim() == 0 else torch.cat(parts)


# ---------------------------------------------------------------- context --


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient over the
    model axis backward (the input of a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.par.all_reduce(g.clone(memory_format=torch.contiguous_format), MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce of the partial sums over the model axis
    forward (the output of a row-parallel product), identity backward."""

    @staticmethod
    def forward(ctx, x, par):
        return par.all_reduce(x.contiguous().clone(), MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFSDP(torch.autograd.Function):
    """FSDP: the all-gather of a weight's data-axis blocks along ``dim``
    forward, the reduce-scatter (sum) of its gradient backward."""

    @staticmethod
    def forward(ctx, w, par, dim):
        ctx.par, ctx.dim = par, dim
        return par.all_gather(w, DATA_AXIS, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.par.reduce_scatter(g, DATA_AXIS, ctx.dim), None, None


@dataclasses.dataclass
class ParallelContext:
    """One training process's place in the mesh and its collectives.

    ``position`` is (data, model); ``groups`` maps each axis to the process
    group of the ranks that share this rank's other coordinate.
    ``bytes_moved`` counts the payload handed to the collectives (each
    call's input bytes), for the per-step figures."""

    data: int
    model: int
    fsdp: bool
    rank: int
    position: Tuple[int, int]
    device: torch.device
    backend: str
    groups: Dict[str, object]
    bytes_moved: int = 0

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def size(self, axis: str) -> int:
        return self.mesh_shape[axis]

    # ---------------------------------------------------- collectives --
    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``t`` over ``axis``, in place (``t`` contiguous)."""
        if self.size(axis) > 1:
            self.bytes_moved += t.numel() * t.element_size()
            dist.all_reduce(t, group=self.groups[axis])
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The blocks of ``axis`` joined along ``dim``, in coordinate order."""
        n = self.size(axis)
        if n == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        self.bytes_moved += x.numel() * x.element_size()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=self.groups[axis])
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """This coordinate's block along ``dim`` of the sum over ``axis``."""
        n = self.size(axis)
        if n == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        self.bytes_moved += x.numel() * x.element_size()
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=self.groups[axis])
        return out.movedim(0, dim)

    # ---------------------------------------------- model-side helpers --
    def copy_to_model(self, x):
        return _CopyToModel.apply(x, self) if self.model > 1 else x

    def reduce_from_model(self, x):
        return _ReduceFromModel.apply(x, self) if self.model > 1 else x

    def gather_weight(self, w, dim: int):
        """A layer matrix whole along ``dim`` when FSDP splits it there."""
        return _GatherFSDP.apply(w, self, dim) if self.fsdp and self.data > 1 else w

    def rows(self, x, dim: int = 0):
        """This rank's rows of a global batch: block ``d`` of ``data``."""
        return shard_slice(x, (None,) * dim + (DATA_AXIS,), self.mesh_shape, self.position)

    def batch_rows(self, batch, dim: int = 0):
        """This rank's rows of each tensor of a global batch (a dict)."""
        return {k: self.rows(v, dim) for k, v in batch.items()}

    def columns(self, x):
        """This rank's block of the last dimension over the model axis."""
        return shard_slice(x, (None,) * (x.dim() - 1) + (MODEL_AXIS,), self.mesh_shape, self.position)

    # ------------------------------------------- parameter placement --
    def local(self, p, t):
        """The block of full tensor ``t`` (a parameter's value or one of its
        optimizer moments) that this rank holds for parameter ``p``
        (``OutfitXModel.shard_`` tags each parameter with its spec)."""
        spec = getattr(p, "mesh_spec", None)
        if spec is None:
            return t
        return shard_blocks(t, spec, p.mesh_blocks, self.mesh_shape, self.position)

    def full(self, p, t):
        """The inverse of ``local``, on every rank: the blocks of ``t``
        gathered over the axes ``p`` is split on (a collective)."""
        spec = getattr(p, "mesh_spec", None)
        if spec is None:
            return t
        for axis in (DATA_AXIS, MODEL_AXIS):
            if axis in spec and self.size(axis) > 1:
                pieces = self.all_gather(t.unsqueeze(0), axis).unbind(0)
                t = join_blocks(pieces, axis, spec, p.mesh_blocks)
        return t

    def full_state_dict(self, module) -> Dict[str, torch.Tensor]:
        """``module.state_dict()`` with every split parameter whole."""
        params = dict(module.named_parameters())
        return {
            k: self.full(params[k], v) if k in params else v
            for k, v in module.state_dict().items()
        }

    def local_state_dict(self, module, sd) -> Dict[str, object]:
        """A full state dict cut to this rank's blocks of ``module``."""
        params = dict(module.named_parameters())
        return {k: self.local(params[k], v) if k in params else v for k, v in sd.items()}

    # ------------------------------------------------- gradient helpers --
    @torch.no_grad()
    def reduce_gradients(self, params) -> None:
        """Sum the gradients over the data axis, in one flat all-reduce.
        Parameters FSDP splits over data were reduce-scattered in the
        backward and are left alone."""
        grads = [
            p.grad for p in params
            if p.grad is not None and DATA_AXIS not in getattr(p, "mesh_axes", ())
        ]
        if self.data == 1 or not grads:
            return
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        self.all_reduce(flat, DATA_AXIS)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    @torch.no_grad()
    def grad_sq_norm(self, params, grads) -> torch.Tensor:
        """The squared global norm of the gradients: each parameter's sum of
        squares summed over the axes it is split on, so that a replicated
        parameter counts once."""
        buckets: Dict[Tuple[str, ...], torch.Tensor] = {}
        for p, g in zip(params, grads):
            axes = tuple(sorted(getattr(p, "mesh_axes", ())))
            sq = (g.float() * g.float()).sum()
            buckets[axes] = buckets[axes] + sq if axes in buckets else sq
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for axes, sq in sorted(buckets.items()):
            sq = sq.reshape(1).clone()
            for axis in axes:
                self.all_reduce(sq, axis)
            total = total + sq[0]
        return total


# The context of a model that is not sharded: one position and no group,
# so that every collective and every cut above is the identity.
SINGLE = ParallelContext(
    data=1, model=1, fsdp=False, rank=0, position=(0, 0), device=None,
    backend="none", groups={},
)


def setup_parallel(mesh_cfg, device: str | torch.device = "cuda") -> Optional[ParallelContext]:
    """This process's ``ParallelContext`` for ``mesh_cfg`` (a
    ``MeshConfig``), after ``maybe_initialize_distributed``. None in one
    process without a process group (one mesh position). The world must
    fill the mesh: every rank takes position ``mesh_position(rank)``."""
    maybe_initialize_distributed(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    data, model = mesh_cfg.resolve(world)
    spec = MeshSpec(data=data, model=model)
    if spec.n_devices > world:
        raise ValueError(f"mesh {spec} needs {spec.n_devices} devices, have {world}")
    if spec.n_devices < world:
        raise ValueError(
            f"mesh {spec} has {spec.n_devices} positions for {world} processes; "
            "every process needs a position"
        )
    if not dist.is_initialized():
        return None
    rank = dist.get_rank()
    # Every rank creates every group, in the same order.
    groups = {}
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            groups[DATA_AXIS] = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            groups[MODEL_AXIS] = g
    dev = local_device(device)
    dist.barrier()
    return ParallelContext(
        data=data, model=model, fsdp=bool(mesh_cfg.fsdp), rank=rank,
        position=mesh_position(rank, spec), device=dev,
        backend=dist.get_backend(), groups=groups,
    )
