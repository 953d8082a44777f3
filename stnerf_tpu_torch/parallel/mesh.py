"""Process groups and the sharding policy (counterpart of
``stnerf_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, model)`` mesh and lets
XLA insert the collectives. Here every rank is a process that owns one
card (``torchrun`` starts them), and the collectives are explicit
``torch.distributed`` calls. Global rank ``g`` sits at data index
``g // M`` and model index ``g % M`` (the model axis inner, as JAX's
``make_mesh`` lays it out), and the mesh holds one process group per axis:

* axis ``"data"``: rays. Training batches and render chunks shard along it.
  A training step reduces one flat buffer of gradients and metrics over
  the data group, the ranks with this rank's model index
  (``engine/trainer.py``), and a rendered pose is gathered over it once
  (:func:`gather_chunked`).
* axis ``"model"``: the performer fields. :func:`shard_params` gives each
  model rank L/M performers (their SpaceNets, coarse and fine, and their
  MotionNets); the rank evaluates the background and its own performers,
  and :class:`LayerShard` gathers the fields' outputs over the model group,
  the ranks with this rank's data index, before the masks and the
  compositor. Every model rank then computes the same loss, so the
  gather's backward needs no collective.

A mesh built without an initialised process group is the one-rank mesh:
its collectives do nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the model's per-performer children, sharded over the model axis (JAX
# ``parallel/mesh.py:66-70``)
SHARDED_GROUPS = ("layers_coarse", "layers_fine", "motion")


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """This process's place among the ranks: ``data`` ranks share the rays,
    ``model`` ranks the performer fields; ``rank`` is this process's index
    on the data axis (the training draws are keyed by it, so the model
    ranks of one data row draw the same batch) and ``model_rank`` its index
    on the model axis; ``group`` every rank (None: one rank, no
    collectives), ``data_group`` the ranks with this model index and
    ``model_group`` those with this data index (None: that axis has one
    rank or no group), ``device`` this rank's card."""
    data: int
    model: int
    rank: int
    group: object
    device: torch.device
    model_rank: int = 0
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def is_main(self) -> bool:
        """The one rank that logs, validates and saves."""
        return self.rank == 0 and self.model_rank == 0

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)

    def barrier(self):
        if self.group is not None:
            dist.barrier(group=self.group)

    def all_reduce_mean_(self, flat: torch.Tensor) -> torch.Tensor:
        """The data ranks' mean of ``flat``, in place: their sum over the
        data group divided by the data size (one collective)."""
        if self.data_group is not None:
            dist.all_reduce(flat, group=self.data_group)
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
    to the current card. With a model axis every rank creates the axes'
    groups, in the same order."""
    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model_parallel:
        raise ValueError(f"{world} ranks do not split into a model axis of "
                         f"{model_parallel}")
    if not dist.is_initialized():
        return DeviceMesh(1, model_parallel, 0, None, device)
    g, M = dist.get_rank(), model_parallel
    D = world // M
    if M == 1:   # the data axis is every rank
        return DeviceMesh(D, 1, g, dist.group.WORLD, device, data_group=dist.group.WORLD)
    # dist.new_group is collective: every rank creates every group
    data_groups = [dist.new_group([d * M + m for d in range(D)]) for m in range(M)]
    model_groups = [dist.new_group([d * M + m for m in range(M)]) for d in range(D)]
    return DeviceMesh(D, M, g // M, dist.group.WORLD, device, model_rank=g % M,
                      data_group=data_groups[g % M] if D > 1 else None,
                      model_group=model_groups[g // M])


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


# -- bytes across ranks ------------------------------------------------------

def _to_bytes(tensors: list, device) -> torch.Tensor:
    """The tensors' bytes, one after another, in one uint8 buffer on
    ``device``."""
    return torch.cat([t.detach().to(device).contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def _from_bytes(buf: torch.Tensor, like: list) -> list:
    """:func:`_to_bytes` undone: tensors of the dtypes and shapes of
    ``like``, on ``buf``'s device."""
    out, off = [], 0
    for t in like:
        size = t.numel() * t.element_size()
        out.append(buf[off:off + size].clone().view(t.dtype).reshape(t.shape))
        off += size
    return out


def _gather_bytes(group, n: int, index: int, local: torch.Tensor) -> torch.Tensor:
    """Every rank's ``local`` (uint8, the same size on each) of a group of
    ``n`` ranks, this one at ``index`` -> (n, bytes), row i rank i's, on
    every rank. One collective: NCCL's ``all_gather_into_tensor``; gloo,
    which gathers no CUDA tensor, an ``all_reduce`` of a zeroed buffer that
    each rank fills in its own row (a byte plus zeros is that byte)."""
    nb = local.numel()
    if dist.get_backend(group) == "nccl":
        full = torch.empty(n * nb, dtype=torch.uint8, device=local.device)
        dist.all_gather_into_tensor(full, local, group=group)
    else:
        full = torch.zeros(n * nb, dtype=torch.uint8, device=local.device)
        full[index * nb:(index + 1) * nb] = local
        dist.all_reduce(full, group=group)
    return full.view(n, nb)


# -- the model axis -------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class LayerShard:
    """The performers ``[lo, hi)`` that this model rank of ``mesh`` owns:
    it evaluates the background and them, and :meth:`gather` makes the
    fields' outputs whole over the model group. A model holds it as
    ``model.layer_shard`` (:func:`shard_params`)."""
    mesh: DeviceMesh
    lo: int
    hi: int

    @property
    def layers(self) -> range:
        return range(self.lo, self.hi)

    def foreign(self, model) -> list:
        """The parameters of the performers that the other model ranks own:
        this rank gives them no gradient and no optimizer state."""
        return _performer_params(model, [layer for layer in range(model.spec.layer_num)
                                         if layer not in self.layers])

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """x (L, ...) per performer -> this rank's (L/M, ...). Its backward
        gathers the ranks' cotangents, so whatever feeds every performer
        gets the whole gradient on every rank."""
        if not x.requires_grad:
            return x[self.lo:self.hi]
        return _TakeLayers.apply(self, x)

    def share(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` unchanged, as the input of this rank's performers that the
        others' performers read too: its backward sums the cotangent over
        the model group (in another order than one rank's autograd sums
        the L fields' terms)."""
        return _SumOverModel.apply(self, x) if x.requires_grad else x

    def gather(self, *xs: torch.Tensor) -> tuple:
        """Per tensor, (1 + L/M, ...): the background and this rank's
        performers -> (L+1, ...) every field's, on every model rank, in one
        collective. Its backward keeps this rank's rows of the cotangent."""
        return _GatherLayers.apply(self, *xs)

    def all_gather(self, xs: list) -> list:
        """This rank's performer tensors ``xs`` (each (L/M, ...)) -> (L, ...)
        each, the ranks' in performer order."""
        m = self.mesh
        rows = _gather_bytes(m.model_group, m.model, m.model_rank,
                             _to_bytes(xs, xs[0].device))
        per = [_from_bytes(row, xs) for row in rows]
        return [torch.cat(parts) for parts in zip(*per)]


class _TakeLayers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, x):
        ctx.shard = shard
        return x[shard.lo:shard.hi].clone()

    @staticmethod
    def backward(ctx, g):
        return None, ctx.shard.all_gather([g.contiguous()])[0]


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, x):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.shard.mesh.model_group)
        return None, g


class _GatherLayers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, *xs):
        ctx.shard = shard
        whole = shard.all_gather([x[1:] for x in xs])
        return tuple(torch.cat([x[:1], w]) for x, w in zip(xs, whole))

    @staticmethod
    def backward(ctx, *gs):
        lo, hi = ctx.shard.lo, ctx.shard.hi
        return (None, *(torch.cat([g[:1], g[1 + lo:1 + hi]]) for g in gs))


def _performer_params(model, layers) -> list:
    """The parameters of performers ``layers`` in a fixed order: per
    performer, its coarse SpaceNet, fine SpaceNet and MotionNet."""
    out = []
    for layer in layers:
        for name in SHARDED_GROUPS:
            group = getattr(model, name)
            if group is not None:
                out.extend(group[layer].parameters())
    return out


def shard_params(mesh: DeviceMesh, model, optimizer=None):
    """Replicate the model's parameters from rank 0 (the JAX package's
    ``shard_params``), and over a model axis of M > 1 give model rank m the
    performers ``[m L/M, (m+1) L/M)``: their SpaceNets (coarse, and fine
    without SAME_SPACENET) and MotionNets are the ones it trains
    (``model.layer_shard``). The others' copies stay in the model but take
    no part in its renders, get no gradient (their ``.grad`` stays None),
    and so no optimizer state; ``optimizer`` (one already built over the
    model, e.g. restored from a whole checkpoint) drops theirs. Call it on
    a whole model, as rank 0 holds it: :func:`gather_whole` makes one
    whole again on rank 0. An L that does not split over M raises."""
    if mesh.model > 1:
        L = model.spec.layer_num
        if L < mesh.model or L % mesh.model:
            raise ValueError(f"{L} performer fields do not split over a model axis of "
                             f"{mesh.model}")
        if mesh.model_group is None:
            raise ValueError("a model axis needs its process group: build the mesh "
                             "with make_mesh(model_parallel=M) under torchrun")
        if model.layer_shard is not None:
            raise ValueError("the model is already sharded")
    replicate(mesh, model)
    if mesh.model == 1:
        return model
    per = model.spec.layer_num // mesh.model
    lo = mesh.model_rank * per
    model.layer_shard = LayerShard(mesh, lo, lo + per)
    if optimizer is not None:
        owned = {id(p) for p in _performer_params(model, range(lo, lo + per))}
        for p in _performer_params(model, range(model.spec.layer_num)):
            if id(p) not in owned:
                optimizer.state.pop(p, None)
    return model


@torch.no_grad()
def gather_whole(mesh: DeviceMesh, model, optimizer=None):
    """Make a layer-sharded model whole on rank 0, for checkpoints and
    validation: every model rank sends its performers' parameters (and,
    with ``optimizer``, their optimizer state) over the model group, and
    rank 0 copies them into its own copies of those performers, in place.
    Collective: every rank of the mesh calls it. -> on the main rank with
    ``optimizer``, the optimizer's ``state_dict()`` with every performer's
    state, as one unsharded rank's would hold it; else None. A model
    without a shard is whole already: None."""
    shard = model.layer_shard
    if shard is None:
        return None
    per = shard.hi - shard.lo
    # every rank's performers, in order, with their states: rank 0's own
    # (layers 0..per-1) are the template of each rank's
    mine = _performer_params(model, shard.layers)
    states = [optimizer.state.get(p, {}) if optimizer is not None else {} for p in mine]
    keys = [sorted(k for k, v in s.items() if isinstance(v, torch.Tensor)) for s in states]
    payload = [t for p, s, ks in zip(mine, states, keys) for t in (p, *(s[k] for k in ks))]
    device = mine[0].device
    local = _to_bytes(payload, device)
    sizes = _gather_bytes(mesh.model_group, mesh.model, mesh.model_rank,
                          _to_bytes([torch.tensor([local.numel()])], device))
    if len({bytes(row.cpu().numpy()) for row in sizes}) > 1:
        raise RuntimeError("the model ranks hold optimizer states of different sizes: "
                           "they did not take the same steps")
    rows = _gather_bytes(mesh.model_group, mesh.model, mesh.model_rank, local)
    if mesh.model_rank != 0:
        return None
    whole_state = optimizer.state_dict() if optimizer is not None else None
    index = ({id(p): i for i, p in enumerate(p for grp in optimizer.param_groups
                                             for p in grp["params"])}
             if optimizer is not None else {})
    for m in range(1, mesh.model):
        values = iter(_from_bytes(rows[m], payload))
        theirs = _performer_params(model, range(m * per, (m + 1) * per))
        for p, state, ks in zip(theirs, states, keys):
            p.copy_(next(values))
            got = {k: next(values).to(state[k].device) for k in ks}
            if whole_state is not None and state:
                whole_state["state"][index[id(p)]] = {**state, **got}
    return whole_state if mesh.is_main else None


@contextlib.contextmanager
def whole_model(model):
    """Within the block the model renders every field itself, as an
    unsharded model (rank 0 after :func:`gather_whole`); the shard returns
    after it."""
    shard = model.layer_shard
    model.layer_shard = None
    try:
        yield model
    finally:
        model.layer_shard = shard


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
    """The whole of tensors that the data ranks rendered in pieces: along
    ``dims[i]`` rank r holds the r-th contiguous 1/D of each of ``n_chunks``
    chunks, chunk after chunk -> every rank gets the tensors with that axis
    D times as long, in chunk order. One collective over the data group for
    all of them: the tensors travel as one byte buffer
    (:func:`_gather_bytes`)."""
    if mesh.data_group is None or mesh.data == 1:
        return list(tensors)
    D = mesh.data
    parts = [t.contiguous() for t in tensors]
    full = _gather_bytes(mesh.data_group, D, mesh.rank, _to_bytes(parts, parts[0].device))
    out = []
    for x, t, dim in zip(zip(*(_from_bytes(row, parts) for row in full)), parts, dims):
        shape = t.shape
        rows = shape[dim] // n_chunks
        # (D, ..., n_chunks, rows, ...) -> (..., n_chunks, D, rows, ...)
        x = torch.stack(x).reshape(D, *shape[:dim], n_chunks, rows, *shape[dim + 1:])
        x = x.movedim(0, dim + 1)
        out.append(x.reshape(*shape[:dim], n_chunks * D * rows, *shape[dim + 1:]))
    return out
