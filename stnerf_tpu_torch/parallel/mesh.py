"""Process groups and the sharding policy (counterpart of
``stnerf_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, model)`` mesh and lets
XLA insert the collectives. Here every rank is a process that owns one
card (``torchrun`` starts them), and the collectives are explicit
``torch.distributed`` calls on the mesh's process group:

* axis ``"data"``: rays. Training batches and render chunks shard along it.
  Parameters are replicated, so a training step needs one collective, the
  ``all_reduce`` of one flat buffer of gradients and metrics
  (``engine/trainer.py``), and a rendered pose one gather
  (:func:`gather_chunked`).
* axis ``"model"``: recorded for parity. The JAX package shards the
  stacked performer fields across it; the port does not, and
  :func:`shard_params` refuses such a mesh.

A mesh built without an initialised process group is the one-rank mesh:
its collectives do nothing.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """This process's place among the ranks: ``data`` ranks share the rays,
    ``model`` is the layer-parallel axis's size, ``rank`` this process's
    index on the data axis, ``group`` the process group (None: one rank,
    no collectives), ``device`` this rank's card."""
    data: int
    model: int
    rank: int
    group: object
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)

    def barrier(self):
        if self.group is not None:
            dist.barrier(group=self.group)

    def all_reduce_mean_(self, flat: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of ``flat``, in place: their sum divided by the
        data size (one collective)."""
        if self.group is not None:
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.data)
        return flat

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank."""
        if self.group is None:
            return obj
        box = [obj]
        device = self.device if self.backend == "nccl" else None
        dist.broadcast_object_list(box, src=0, group=self.group, device=device)
        return box[0]


def init_distributed(device=None, backend: str | None = None) -> torch.device:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) ->
    this rank's device.

    On a card (the default) the rank takes ``cuda:LOCAL_RANK`` and the group
    runs NCCL. Gloo runs only where the caller asks for it: ``device="cpu"``
    or ``backend="gloo"`` (several processes on one card). A rank without a
    card raises, and so does a failed ``init_process_group``."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = resolve_device(f"cuda:{local}" if device is None else device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        # NCCL bound to this rank's card: its communicator opens now, and
        # no collective has to guess the device
        dist.init_process_group(backend, init_method="env://",
                                world_size=int(os.environ["WORLD_SIZE"]),
                                rank=int(os.environ["RANK"]),
                                device_id=device if backend == "nccl" else None)
    return device


def make_mesh(model_parallel: int = 1, device=None) -> DeviceMesh:
    """The (data, model) mesh over every rank of the default process group
    (one rank, no group, when none is initialised): ``model_parallel``
    ranks form the model axis, the rest the data axis. ``device`` defaults
    to the current card."""
    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model_parallel:
        raise ValueError(f"{world} ranks do not split into a model axis of "
                         f"{model_parallel}")
    if not dist.is_initialized():
        return DeviceMesh(1, model_parallel, 0, None, device)
    rank = dist.get_rank()
    return DeviceMesh(world // model_parallel, model_parallel, rank // model_parallel,
                      dist.group.WORLD, device)


def _tensors(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@torch.no_grad()
def replicate(mesh: DeviceMesh, tree):
    """Rank 0's values of every tensor of ``tree`` (a module, a tensor or a
    nested tuple or list of them) on every rank, in place -> ``tree``.
    The tensors are packed into one buffer a dtype, one broadcast each."""
    if mesh.group is None:
        return tree
    by_dtype = {}
    for t in _tensors(tree):
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))
    return tree


def shard_params(mesh: DeviceMesh, model):
    """Replicate the model's parameters from rank 0 (the JAX package's
    ``shard_params`` with a model axis of 1). Sharding the performer fields
    over a model axis is not ported: such a mesh raises."""
    if mesh.model > 1:
        raise NotImplementedError(f"a model axis of {mesh.model}: layer-sharded "
                                  "parameters are not ported; the port replicates them")
    return replicate(mesh, model)


def shard_ray_batch(mesh: DeviceMesh, tree):
    """This rank's contiguous 1/D of the leading (ray) axis of every tensor
    or array of ``tree`` (a nested tuple). The axis must divide by D."""
    if isinstance(tree, tuple):
        return type(tree)(*(shard_ray_batch(mesh, x) for x in tree))
    n = tree.shape[0]
    if n % mesh.data:
        raise ValueError(f"{n} rays do not split over {mesh.data} ranks: pad them "
                         "(pad_for_mesh)")
    per = n // mesh.data
    return tree[mesh.rank * per:(mesh.rank + 1) * per]


def pad_for_mesh(n: int, mesh: DeviceMesh, chunk: int = 1) -> int:
    """Smallest multiple of (data axis size * chunk) that is >= n."""
    q = mesh.shape[DATA_AXIS] * chunk
    return ((n + q - 1) // q) * q


def gather_chunked(mesh: DeviceMesh, tensors: list, dims: list, n_chunks: int) -> list:
    """The whole of tensors that the ranks rendered in pieces: along
    ``dims[i]`` rank r holds the r-th contiguous 1/D of each of ``n_chunks``
    chunks, chunk after chunk -> every rank gets the tensors with that axis
    D times as long, in chunk order. One collective for all of them: the
    tensors travel as one byte buffer (NCCL: ``all_gather_into_tensor``;
    gloo, which gathers no CUDA tensor: an ``all_reduce`` of a zeroed
    buffer, each rank filling its own part)."""
    if mesh.group is None or mesh.data == 1:
        return list(tensors)
    D, r = mesh.data, mesh.rank
    parts = [t.contiguous() for t in tensors]
    local = torch.cat([t.reshape(-1).view(torch.uint8) for t in parts])
    nb = local.numel()
    if mesh.backend == "nccl":
        full = torch.empty(D * nb, dtype=torch.uint8, device=local.device)
        dist.all_gather_into_tensor(full, local, group=mesh.group)
    else:
        full = torch.zeros(D * nb, dtype=torch.uint8, device=local.device)
        full[r * nb:(r + 1) * nb] = local
        dist.all_reduce(full, group=mesh.group)
    full = full.view(D, nb)
    out, off = [], 0
    for t, dim in zip(parts, dims):
        size = t.numel() * t.element_size()
        x = full[:, off:off + size].contiguous().view(t.dtype).reshape(D, *t.shape)
        off += size
        shape = t.shape
        rows = shape[dim] // n_chunks
        # (D, ..., n_chunks, rows, ...) -> (..., n_chunks, D, rows, ...)
        x = x.reshape(D, *shape[:dim], n_chunks, rows, *shape[dim + 1:])
        x = x.movedim(0, dim + 1)
        out.append(x.reshape(*shape[:dim], n_chunks * D * rows, *shape[dim + 1:]))
    return out
