"""The process mesh and the batch's placement over ``torch.distributed``.

Port of ``stablediffusion_tpu/parallel/mesh.py``.  JAX runs one controller
over every device of a host and lets XLA's partitioner emit the
collectives; torch runs one process per GPU (``torchrun``), each with its
rank, and the collectives are explicit.  The mesh keeps JAX's two axes:

  * ``data``: each data group takes its rows of the global batch; the
    trainers average the gradients over it (``train_step.make_train_step``)
    and the handler gathers the rendered rows;
  * ``tensor``: the denoiser's attention and MLP projections split over it
    (``parallel/tp.py``).

Rank r sits at data index r // tensor and tensor index r % tensor, as
``np.reshape(devices, (data, tensor))`` lays JAX's devices out.  A rank's
rows of a global batch of B are ``data_index::data`` (strided, so that the
folder dataset's ``batches(shard_index=data_index, num_shards=data)`` at
B / data per rank yields exactly them).  A batch whose leading size does
not divide by ``data`` stays whole on every rank, as JAX leaves such an
array replicated.

Without an initialized process group a 1 x 1 mesh has no groups and its
collectives are identities; with one, every collective runs (world size 1
included, where it returns its input).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
TENSOR_AXIS = "tensor"


def maybe_initialize_distributed(device: Any = None) -> bool:
    """Initialize the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL when the processes run on the card (`device`
    cuda, or by default when one is present), gloo on the CPU; each rank
    takes the card of its local rank.  Idempotent.  Returns True if a
    process group is active."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    if on_card:
        torch.cuda.set_device(local)
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group("nccl" if on_card else "gloo", init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world)
    return True


class Mesh:
    """A ("data", "tensor") mesh over the ranks of the default process group
    (or over this process alone): its ``shape``, this rank's indices and the
    process group of each axis (None without a process group)."""

    def __init__(self, data: int, tensor: int, device_mesh=None):
        self.shape = {DATA_AXIS: data, TENSOR_AXIS: tensor}
        self.device_mesh = device_mesh
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.data_index, self.tensor_index = divmod(self.rank, tensor)
        self.groups = ({a: device_mesh.get_group(a) for a in (DATA_AXIS, TENSOR_AXIS)}
                       if device_mesh is not None else {DATA_AXIS: None, TENSOR_AXIS: None})

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def index(self, axis: str) -> int:
        return self.data_index if axis == DATA_AXIS else self.tensor_index

    def all_reduce_(self, t: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place all-reduce of `t` over `axis`."""
        if self.groups[axis] is not None:
            dist.all_reduce(t, op=op, group=self.groups[axis])
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The `axis` ranks' `t`, concatenated along `dim` in index order."""
        if self.groups[axis] is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t.contiguous(), group=self.groups[axis])
        return torch.cat(parts, dim=dim)

    def all_gather_object(self, obj: Any, axis: str) -> list:
        if self.groups[axis] is None:
            return [obj]
        out = [None] * self.shape[axis]
        dist.all_gather_object(out, obj, group=self.groups[axis])
        return out


@dataclass(frozen=True)
class MeshSpec:
    data: int = -1  # -1: all remaining ranks
    tensor: int = 1

    def build(self) -> Mesh:
        return make_mesh(self.data, self.tensor)


def make_mesh(data: int = -1, tensor: int = 1) -> Mesh:
    """A data x tensor mesh over every rank (JAX's ``make_mesh`` rule: -1
    takes the ranks the tensor axis leaves).  Needs an initialized process
    group unless the mesh is 1 x 1."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        assert n % tensor == 0, f"{n} ranks not divisible by tensor={tensor}"
        data = n // tensor
    assert data * tensor == n, f"mesh {data}x{tensor} != {n} ranks"
    if not dist.is_initialized():
        return Mesh(data, tensor)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (data, tensor), mesh_dim_names=(DATA_AXIS, TENSOR_AXIS))
    return Mesh(data, tensor, dm)


def data_sharding(mesh: Mesh, ndim: int = 1):
    """The DTensor placements of an array split on its leading (batch) dim
    over ``data`` and replicated over ``tensor``."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh: Mesh):
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def rows(mesh: Optional[Mesh], n: int):
    """This rank's row index (a slice) of a global batch of `n` rows: every
    ``data``-th row from its data index, or all rows when `n` does not
    divide."""
    if mesh is None or mesh.shape[DATA_AXIS] == 1 or n % mesh.shape[DATA_AXIS]:
        return slice(None)
    return slice(mesh.data_index, None, mesh.shape[DATA_AXIS])


def shard_batch(mesh: Mesh, batch):
    """This rank's rows (``rows``) of every tensor or array with a leading
    batch dim in a (nested) dict; other values stay as they are."""

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1:
            return x[rows(mesh, x.shape[0])]
        return x

    return place(batch)
