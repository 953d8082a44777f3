"""Training engine (counterpart of ``stnerf_tpu/engine/trainer.py``).

``make_train_step`` builds one step: the layered render of a ray batch
through the differentiable fields (the forward and backward field
kernels on the card), the RGB and mask-alpha losses, and the optimizer
update. ``make_train_epoch`` loops it over batches drawn from a pool
resident on the device, and ``do_train`` is the host loop with the
reference trainer's observability: the per-LOG_PERIOD "rays/s" log line
and TensorBoard scalars (ref: engine/layered_trainer.py:295-306), the
coarse-only stage (ref: :191-194), the mask-loss epochs, a checkpoint every
CHECKPOINT_PERIOD steps and per epoch, validation every VAL_PERIOD steps
and per epoch (ref: :308-317), and re-entry of an epoch at a saved step.

The step renders with its own spec (:func:`training_spec`, JAX's
``trainer.py:206-213``): the model's with the early exit stripped and the
fast fine stage kept only with FAST_FINE_TRAIN. The merge of every layer's
samples follows ``TPU.COMPOSITOR_KERNEL``: on, the step composites through
the JAX trainer's sort-free compositors (``composite_merged_nosort``, whose
cross-stream terms the kernels K4 and K5 compute on the card, and for the
fast fine stage ``composite_streams_nosort``); off, through the payload
sort and the sorted merge under autograd, the GPU-native form chosen for
the JAX trainer's default cube compositor (the two are gradient-equal,
PARITY.md). The decoded camera ids drive the pose refinement and the
view-deform net. Randomness comes from ``torch.Generator`` objects on the
device keyed by position: an epoch's batch order by (seed, epoch), a
step's sampling noise by (seed, epoch, step), so a run resumed at any step
draws what the uninterrupted run drew.

On a mesh (``parallel.make_mesh``) the step averages the gradients over
the data ranks, and with a layer-sharded model (``parallel.shard_params``)
each model rank trains its own performers: epoch training takes a mesh of
one data rank and M model ranks, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.layered import (EditState, LayeredModel, LayeredSpec, RayInputs,
                              SceneBoxes, _gather_boxes, render_rays)
from ..models.rays import unpack_rays
from ..ops.sampling import ray_aabb_intersect
from ..parallel import gather_whole, whole_model
from .checkpoint import save_checkpoint
from .loss import mask_alpha_loss, rgb_loss
from .solver import make_optimizer


class TrainBatch(NamedTuple):
    inputs: RayInputs
    rgb: torch.Tensor     # (N, 3)
    labels: torch.Tensor  # (N,) int segmentation label


class CompactPool(NamedTuple):
    """Device-resident training pool in the compact pixel format (13 bytes
    a ray); :func:`make_decode` rebuilds each batch's rays from the camera
    tables."""
    cams: torch.Tensor         # (N,) int32 camera index
    pix: torch.Tensor          # (N,) int32 flat pixel index v*W + u
    frames: torch.Tensor       # (N,) int32 1-based frame id
    labels: torch.Tensor       # (N,) uint8 segmentation label
    bbox_labels: torch.Tensor  # (N,) uint8 generating layer id
    rgb: torch.Tensor          # (N, 3) uint8


class CamTables(NamedTuple):
    """Per-camera constants for decoding rays on the device."""
    inv_K: torch.Tensor     # (M, 3, 3) transformed-K inverse
    rot: torch.Tensor       # (M, 3, 3) camera-to-world rotation
    origin: torch.Tensor    # (M, 3) camera centres
    near_far: torch.Tensor  # (L+1, F+1, M, 2) indexed [layer, frame, cam]


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    rgb_loss: torch.Tensor
    mask_loss: torch.Tensor
    psnr_coarse: torch.Tensor
    psnr_fine: torch.Tensor


class _RawMetrics(NamedTuple):
    loss: torch.Tensor
    mse_c: torch.Tensor
    mse_f: torch.Tensor
    mask: torch.Tensor


def _map(fn, tree):
    """``fn`` of every tensor of a (nested) NamedTuple."""
    if isinstance(tree, tuple):
        return type(tree)(*(_map(fn, x) for x in tree))
    return fn(tree)


def _take(tree, idx: torch.Tensor):
    """Rows ``idx`` of every tensor of a (nested) NamedTuple."""
    return _map(lambda x: x[idx], tree)


def _check_device(model: LayeredModel, device: torch.device):
    where = next(model.parameters()).device
    if where != device:
        raise ValueError(f"the model is on {where}, training runs on {device}: "
                         "build it there (LayeredModel(..., device=...)) or pass "
                         f"device={str(where)!r}")


def make_decode(tables: CamTables, spec: LayeredSpec, width: int):
    """CompactPool rows -> TrainBatch, with the host ray generator's math
    (data/cameras.pixel_rays_at): dir = rot @ normalize(K^-1 [u, v, 1]),
    origin = the camera centre. Tables are read by index; the 3x3 products
    are elementwise sums (no TF32)."""
    lp1 = spec.layer_num + 1

    def decode(rows: CompactPool) -> TrainBatch:
        cam = rows.cams.long()
        pix = rows.pix.long()
        u = (pix % width).float()
        v = torch.div(pix, width, rounding_mode="floor").float()
        pix3 = torch.stack([u, v, torch.ones_like(u)], -1)
        d = (tables.inv_K[cam] * pix3[:, None, :]).sum(-1)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        d = (tables.rot[cam] * d[:, None, :]).sum(-1)
        frames = rows.frames.long()
        nf = tables.near_far[rows.bbox_labels.long(), frames, cam]
        frame = frames.float()[:, None].expand(-1, lp1).contiguous()
        inputs = RayInputs(tables.origin[cam], d, frame, cam.float(), nf)
        return TrainBatch(inputs, rows.rgb.float() / 255.0, rows.labels.long())

    return decode


def training_spec(spec: LayeredSpec) -> LayeredSpec:
    """The spec a training step renders with (JAX ``trainer.py:206-213``):
    the early exit stripped, the fast fine stage kept exactly when
    FAST_FINE_TRAIN is on, and the sort-free compositor exactly when its
    kernels are on."""
    return dataclasses.replace(spec, nosort_composite=spec.compositor_kernel,
                               coarse_exit_segments=0,
                               fast_fine=bool(spec.fast_fine_train))


def _losses(model: LayeredModel, edits: EditState, remove_outliers: bool,
            scene: SceneBoxes, batch: TrainBatch, generator, mask_on: float,
            only_coarse: bool, plain: bool = False, spec: LayeredSpec | None = None,
            mask_scale: float = 1.0):
    """Forward and loss: MSE on the coarse (and fine) mixed composites plus
    the gated mask-alpha loss (ref: engine/layered_trainer.py:216-281);
    ``spec`` as ``render_rays`` takes it. ``mask_scale`` compensates the
    mask loss on a shard (JAX ``trainer.py:131-150``): the reference's term
    is a sum over rays, so a rank computing it over batch/D rays multiplies
    by D before the ranks' mean. -> (loss, _RawMetrics)."""
    out = render_rays(model, scene, batch.inputs, edits, generator, plain=plain,
                      only_coarse=only_coarse, trainable=True, spec=spec)
    zero = out.coarse.color.new_zeros(())
    mse_c = rgb_loss(out.coarse.color, batch.rgb)
    m = (mask_alpha_loss(out.coarse_layers.acc, batch.labels) * mask_on * mask_scale
         if remove_outliers else zero)
    loss = mse_c + m
    mse_f = mse_c  # only_coarse: fine == coarse composite, as the reference logs it
    if not only_coarse:
        mse_f = rgb_loss(out.fine.color, batch.rgb)
        m_f = (mask_alpha_loss(out.fine_layers.acc, batch.labels) * mask_on * mask_scale
               if remove_outliers else zero)
        loss = loss + mse_f + m_f
        m = m + m_f
    return loss, _RawMetrics(loss, mse_c, mse_f, m)


def _finalize_metrics(raw: _RawMetrics, only_coarse: bool) -> StepMetrics:
    def to_psnr(m):
        return -10.0 * torch.log10(torch.clamp(m, min=1e-12))

    rgb = raw.mse_c if only_coarse else raw.mse_c + raw.mse_f
    return StepMetrics(raw.loss, rgb, raw.mask, to_psnr(raw.mse_c), to_psnr(raw.mse_f))


def sort_batch_by_hit(spec: LayeredSpec, scene: SceneBoxes,
                      batch: TrainBatch) -> TrainBatch:
    """Reorder a batch so that rays sharing a performer-bbox hit pattern are
    contiguous: the loss does not change, but the field kernels' skip flags
    then cover whole tiles of rays that miss a performer."""
    L = spec.layer_num
    if L == 0:
        return batch
    inputs = batch.inputs
    N = inputs.rays_o.shape[0]
    boxes = _gather_boxes(scene, inputs.frame_ids[:, 1:])       # (N, L, 2, 3)
    o = inputs.rays_o[:, None, :].expand(N, L, 3)
    d = inputs.rays_d[:, None, :].expand(N, L, 3)
    _, _, hit = ray_aabb_intersect(o, d, boxes[..., 0, :], boxes[..., 1, :])
    key = (hit.long() * (2 ** torch.arange(L, device=hit.device))).sum(1)
    return _take(batch, torch.argsort(key, stable=True))


def _mean_over_ranks(mesh, params: list, raw: _RawMetrics) -> _RawMetrics:
    """JAX's ``pmean`` of the gradient tree and the raw metrics
    (``trainer.py:363-365``) as one ``all_reduce`` of one flat buffer over
    the data ranks: the gradients of ``params`` that have one (the data
    ranks of one model index build the same graph, so the same ones), then
    the four metrics. The averaged gradients are left in ``.grad`` -> the
    averaged metrics."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [torch.stack(tuple(raw))])
    mesh.all_reduce_mean_(flat)
    parts = flat.split([g.numel() for g in grads] + [len(raw)])
    for p, part in zip((p for p in params if p.grad is not None), parts):
        p.grad = part.view_as(p)
    return _RawMetrics(*parts[-1].unbind())


def _zero_missing_grads(owned: list):
    """A zero gradient for every parameter in ``owned`` that the step did
    not reach (the fine nets in the coarse-only stage): JAX's gradient tree
    holds every parameter, so optax's Adam counts every step in its bias
    correction and decays every moment, and the weight decay moves every
    parameter; torch's optimizers pass over a ``.grad`` of None, and a
    fine net's first Adam update after the coarse stage would be about
    twice JAX's."""
    for p in owned:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def make_train_step(model: LayeredModel, optimizer, scheduler=None,
                    remove_outliers: bool = False, plain: bool = False,
                    device=None, mesh=None):
    """-> step(scene, batch, generator, mask_on, only_coarse=False) ->
    StepMetrics (0-d tensors on the device). The step renders with
    :func:`training_spec` of the model's spec and leaves the gradients it
    applied in the parameters' ``.grad``. ``plain`` runs the plain forward
    and backward of every kernel instead. The model must already be on
    ``device`` (the CUDA card unless another is named).

    With a ``mesh`` the batch is this rank's shard: the mask loss is scaled
    by the data size D, and the gradients and raw metrics are averaged over
    the data ranks (one flat ``all_reduce``) before the optimizer step, so
    every rank takes the same step. The mesh may have a model axis, as
    JAX's step runs on any (data, model) mesh: with a layer-sharded model
    (``parallel.shard_params``) each rank's buffer holds the gradients it
    has, the background's and its own performers'; the model ranks of one
    data row draw the same batch and compute the same loss."""
    device = resolve_device(device)
    _check_device(model, device)
    spec = training_spec(model.spec)
    edits = EditState.identity(spec.layer_num, device=device)
    mask_scale = 1.0 if mesh is None else float(mesh.data)
    params = [p for p in model.parameters() if p.requires_grad]
    # a layer-sharded model's performers on other model ranks keep a .grad
    # of None: this rank holds no optimizer state for them
    foreign = ({id(p) for p in model.layer_shard.foreign(model)}
               if model.layer_shard is not None else set())
    owned = [p for p in params if id(p) not in foreign]

    def step(scene: SceneBoxes, batch: TrainBatch, generator, mask_on: float,
             only_coarse: bool = False) -> StepMetrics:
        optimizer.zero_grad(set_to_none=True)
        loss, raw = _losses(model, edits, remove_outliers, scene, batch, generator,
                            mask_on, only_coarse, plain=plain, spec=spec,
                            mask_scale=mask_scale)
        loss.backward()
        raw = _RawMetrics(*(x.detach() for x in raw))
        if mesh is not None:
            raw = _mean_over_ranks(mesh, params, raw)
        _zero_missing_grads(owned)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return _finalize_metrics(raw, only_coarse)

    return step


def make_train_epoch(model: LayeredModel, optimizer, scheduler=None,
                     remove_outliers: bool = False, mesh=None, decode=None,
                     block: int = 1, device=None):
    """-> epoch(scene, pool, generator, mask_on, batch_size, steps,
    only_coarse=False, first=0, step_generator=None, after_step=None) ->
    StepMetrics of (steps - first,) tensors.

    ``pool`` (a TrainBatch, or a CompactPool with ``decode``) lives on the
    device. Each step draws ``batch_size`` rays — a permutation of the pool
    when the epoch's draws fit in it four times over or less, else
    independent indices — or, with ``block`` > 1, ``batch_size / block``
    contiguous blocks (pools ordered by hit pattern). Batches are sorted by
    hit pattern when drawn ray by ray. ``generator`` draws the whole
    epoch's order; steps ``first`` to ``steps - 1`` run, each sampling from
    ``step_generator(i)`` (default: ``generator`` itself), and
    ``after_step(i + 1)`` is called after step i.

    With a ``mesh`` of D ranks, ``pool`` is this rank's shard
    (:func:`shard_pool`), ``batch_size`` the global batch (a multiple of
    D), and each step draws batch/D rays from the shard and averages the
    gradients over the ranks (:func:`make_train_step`); the generators are
    this rank's own. A mesh with a model axis and a data axis both over 1
    raises, as JAX's; a mesh of one data rank and M model ranks trains a
    layer-sharded model (``parallel.shard_params``)."""
    if mesh is not None and mesh.model > 1 and mesh.data > 1:
        raise ValueError("epoch training is data-parallel; use a mesh with "
                         "model axis 1 (params are replicated)")
    n_data = 1 if mesh is None else mesh.data
    step = make_train_step(model, optimizer, scheduler, remove_outliers, device=device,
                           mesh=mesh)
    spec = model.spec
    block = max(int(block), 1)
    # only the fused path's skip flags profit from hit-sorted batches; the
    # staged path of a view-deforming model runs every sample (JAX gates the
    # sort the same way)
    sort_hits = spec.layer_num > 0 and block == 1 and not spec.use_deform_view

    def epoch(scene: SceneBoxes, pool, generator, mask_on: float, batch_size: int,
              steps: int, only_coarse: bool = False, first: int = 0,
              step_generator=None, after_step=None) -> StepMetrics:
        if batch_size % n_data:
            raise ValueError(f"batch {batch_size} does not split over {n_data} ranks")
        batch_size //= n_data   # this rank's share
        n_pool = pool.rgb.shape[0]
        dev = pool.rgb.device
        unit, per = (block, batch_size // block) if block > 1 else (1, batch_size)
        if block > 1 and batch_size % block:
            raise ValueError(f"block {block} does not divide batch {batch_size}")
        n_units = n_pool // unit
        draw = steps * per
        if draw * 4 < n_units or draw > n_units:
            order = torch.randint(0, n_units, (steps, per), generator=generator, device=dev)
        else:
            order = torch.randperm(n_units, generator=generator, device=dev)[:draw]
            order = order.reshape(steps, per)
        offsets = torch.arange(unit, device=dev)
        metrics = []
        for i in range(first, steps):
            idx = (order[i][:, None] * unit + offsets).reshape(-1)
            batch = _take(pool, idx)
            if decode is not None:
                batch = decode(batch)
            if sort_hits:
                batch = sort_batch_by_hit(spec, scene, batch)
            gen = generator if step_generator is None else step_generator(i)
            metrics.append(step(scene, batch, gen, mask_on, only_coarse))
            if after_step is not None:
                after_step(i + 1)
        return StepMetrics(*(torch.stack(x) for x in zip(*metrics)))

    return epoch


def shard_pool(pool, mesh) -> tuple:
    """This rank's contiguous slice of the pool (a TrainBatch or a
    CompactPool, tensors on any device): the ray axis padded to a multiple
    of the data size by repeating the last row, then cut in D slices (JAX
    ``trainer.py:403-425``) -> (this rank's pool, the padded size)."""
    d = mesh.data
    n = pool.rgb.shape[0]
    n_pad = -(-n // d) * d

    def cut(x):
        if n_pad != n:
            x = torch.cat([x, x[-1:].expand(n_pad - n, *x.shape[1:])])
        per = n_pad // d
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    return _map(cut, pool), n_pad


def make_pool(train_pool: dict, spec: LayeredSpec, device) -> TrainBatch:
    """The pregenerated {rays, rgbs, labels, near_fars} arrays -> a TrainBatch
    pool on ``device``."""
    return TrainBatch(
        inputs=unpack_rays(train_pool["rays"], spec, train_pool["near_fars"], device),
        rgb=torch.as_tensor(np.asarray(train_pool["rgbs"], np.float32), device=device),
        labels=torch.as_tensor(np.asarray(train_pool["labels"]).reshape(-1),
                               device=device).long())


def split_compact_bundle(bundle: dict, device=None) -> tuple[CompactPool, CamTables, int]:
    """A compact pool bundle (the JAX package's data/raygen.build_ray_pool
    output for a deterministic transform) -> (CompactPool, CamTables,
    width) on ``device``."""
    def t(key, dtype):
        return torch.as_tensor(np.asarray(bundle[key], dtype), device=device)

    pool = CompactPool(cams=t("cams", np.int32), pix=t("pix", np.int32),
                       frames=t("frames", np.int32), labels=t("labels", np.uint8),
                       bbox_labels=t("bbox_labels", np.uint8), rgb=t("rgb", np.uint8))
    tables = CamTables(inv_K=t("table_inv_K", np.float32), rot=t("table_rot", np.float32),
                       origin=t("table_origin", np.float32),
                       near_far=t("table_near_far", np.float32))
    return pool, tables, int(bundle["width"])


def pool_camera_num(train_pool: dict, spec: LayeredSpec) -> int:
    """The cameras a training pool draws from — the ``camera_num`` of its
    model: a compact bundle's camera tables, else one more than the largest
    camera id in its rays."""
    if "pix" in train_pool:
        return int(np.asarray(train_pool["table_rot"]).shape[0])
    cam_ids = unpack_rays(train_pool["rays"], spec).cam_ids
    return int(cam_ids.max()) + 1 if cam_ids.numel() else 0


def _position_seed(*key: int) -> int:
    """Position-keyed: an epoch (seed, epoch) draws the same batches, and a
    step (seed, epoch, step) the same sampling noise, whatever ran before."""
    return int(np.random.SeedSequence(list(key)).generate_state(1)[0])


def _call_val(val_fn, model, epoch: int, step: int | None = None):
    """Call a validation callback, passing the mid-epoch global step only
    when it takes one (JAX ``trainer.py:454-464``)."""
    try:
        takes_step = len(inspect.signature(val_fn).parameters) >= 3
    except (TypeError, ValueError):
        takes_step = False
    return val_fn(model, epoch, step) if takes_step else val_fn(model, epoch)


def do_train(cfg, model: LayeredModel, scene: SceneBoxes, train_pool: dict,
             optimizer=None, scheduler=None, *, mesh=None, val_fn=None,
             resume_epoch: int = 0, resume_step: int = 0, psnr_thres: float = 100.0,
             seed: int = 0, logger: logging.Logger | None = None, device=None,
             swriter=None) -> list:
    """Training host loop (ref: engine/layered_trainer.py:133-331; JAX
    ``trainer.py:467-637``).

    ``train_pool`` is a compact bundle (``"pix"`` in it) or the
    pregenerated {rays, rgbs, labels, near_fars} arrays; it is uploaded to
    the device once. Epochs run from ``resume_epoch + 1`` to
    ``SOLVER.MAX_EPOCHS - 1``: coarse only before ``COARSE_STAGE``, the
    mask loss on before epoch 3. The first of them skips its first
    ``resume_step`` steps (a mid-epoch checkpoint's step; an epoch skipped
    whole is logged and passed over). Draws are keyed by position
    (``seed``, epoch, step), so a resumed run draws what the uninterrupted
    one would have. Each epoch logs the reference's line every LOG_PERIOD
    steps, with its loss, PSNR, mask and RGB losses written to ``swriter``
    (an ``utils.EventWriter``) at the global step ``(epoch - 1) * steps +
    step``. With ``OUTPUT_DIR`` set it saves a checkpoint every
    ``SOLVER.CHECKPOINT_PERIOD`` steps run (``_{epoch}_{step}``, none at an
    epoch's last step) and one per epoch; ``val_fn(model, epoch[, step])``
    runs every ``SOLVER.VAL_PERIOD`` steps (with the global step) and after
    each epoch. On a mesh the main rank alone logs, saves and validates; a
    layer-sharded model is first made whole on it (``parallel.gather_whole``,
    every rank taking part), so that its checkpoint holds the whole model
    and optimizer state as an unsharded run's does, and the main rank
    validates alone on those whole weights (``parallel.whole_model``): the
    main rank's ``val_fn`` decides for every rank. Training stops after an
    epoch whose mean fine PSNR exceeds ``psnr_thres``. Without an
    optimizer, ``make_optimizer`` builds one. With pose refinement the
    model must hold a correction for every camera of the pool: build it
    with ``LayeredSpec.from_cfg(cfg, camera_num=pool_camera_num(train_pool,
    spec))``; a model with fewer raises. -> [(epoch, StepMetrics of numpy
    arrays over the steps run)].
    """
    logger = logger or logging.getLogger("stnerf_tpu_torch.train")
    device = resolve_device(device)
    _check_device(model, device)
    sharded = model.layer_shard is not None
    if sharded and mesh is None:
        raise ValueError("a layer-sharded model trains on its mesh: pass mesh=")
    s = cfg.SOLVER
    batch_size = s.IMS_PER_BATCH
    n_data = 1 if mesh is None else mesh.data
    main = mesh is None or mesh.is_main
    if batch_size % n_data:
        batch_size -= batch_size % n_data
        if main:
            logger.warning("IMS_PER_BATCH trimmed to %d (multiple of data axis %d)",
                           batch_size, n_data)
    if optimizer is None:
        optimizer, scheduler = make_optimizer(cfg, model)
    spec = model.spec
    compact = "pix" in train_pool
    decode = None
    # with a mesh the pool is cut on the host and each rank uploads its slice
    host = device if mesh is None else torch.device("cpu")
    if compact:
        pool, tables, width = split_compact_bundle(train_pool, host)
        decode = make_decode(CamTables(*(t.to(device) for t in tables)), spec, width)
    else:
        pool = make_pool(train_pool, spec, host)
    n_cams = pool_camera_num(train_pool, spec)
    if model.cam_pose is not None and model.cam_pose.rvec.shape[0] < n_cams:
        raise ValueError(f"the pool draws from {n_cams} cameras, the pose refinement "
                         f"holds {model.cam_pose.rvec.shape[0]}: build the model from "
                         f"LayeredSpec.from_cfg(cfg, camera_num={n_cams})")
    n_pool = pool.rgb.shape[0]
    if mesh is not None:
        pool, _ = shard_pool(pool, mesh)
        pool = _map(lambda t: t.to(device), pool)
    block = int(getattr(cfg.TPU, "POOL_BLOCK_DRAW", 0) or 0)
    if block > 1 and not (compact and bool(np.asarray(train_pool.get("hit_ordered", 0)))):
        block = 1  # unordered pools: a block is scan-order pixels, no tile payoff
    # block draws apply per shard (JAX trainer.py:520-537)
    while block > 1 and (batch_size // n_data) % block:
        block -= 1
    if block > n_pool // n_data:
        block = 1
    epoch_fn = make_train_epoch(model, optimizer, scheduler,
                                remove_outliers=cfg.MODEL.REMOVE_OUTLIERS, mesh=mesh,
                                decode=decode, block=block, device=device)
    steps = max(n_pool // batch_size, 1)
    scene = SceneBoxes(*(t.to(device) for t in scene))
    if main:
        logger.info("pool resident on %s: %d rays, %d steps/epoch%s%s", device, n_pool,
                    steps, " (compact pixel format)" if compact else "",
                    f", sharded over {n_data} ranks" if n_data > 1 else "")
    ckpt_period = int(s.CHECKPOINT_PERIOD or 0)
    val_period = int(getattr(s, "VAL_PERIOD", 0) or 0)
    # per-rank draws only over several ranks: one rank draws as no mesh
    rank_key = (mesh.rank,) if n_data > 1 else ()

    has_val = (mesh.broadcast_object(val_fn is not None) if sharded
               else val_fn is not None)

    def save(epoch, step=None):
        # rank 0 writes; every rank waits until the file is there
        state = gather_whole(mesh, model, optimizer) if sharded else None
        if main:
            save_checkpoint(cfg.OUTPUT_DIR, model, optimizer, scheduler, epoch, step=step,
                            optimizer_state=state)
        if mesh is not None:
            mesh.barrier()

    def validate(epoch, step=None):
        # a sharded model renders through gathers: rank 0 validates alone
        # on whole weights
        if sharded:
            gather_whole(mesh, model)
        if main and val_fn is not None:
            with whole_model(model):
                _call_val(val_fn, model, epoch, step)

    history = []
    for epoch in range(1 + resume_epoch, s.MAX_EPOCHS):
        skip = resume_step if epoch == resume_epoch + 1 else 0
        if skip >= steps:
            if main:
                logger.info("Epoch %d already complete at resume; skipping", epoch)
            continue
        start = time.time()
        only_coarse = epoch < s.COARSE_STAGE
        mask_on = 1.0 if epoch < 3 else 0.0
        gen = torch.Generator(device=device).manual_seed(
            _position_seed(seed, epoch, *rank_key))
        since = {"ckpt": 0, "val": 0}

        def step_generator(i):
            return torch.Generator(device=device).manual_seed(
                _position_seed(seed, epoch, i, *rank_key))

        def after_step(done):
            # in-epoch checkpoints and validation, counted in steps run
            # (JAX trainer.py:595-608); none at the epoch's last step
            since["ckpt"] += 1
            since["val"] += 1
            if done >= steps:
                return
            if ckpt_period and since["ckpt"] >= ckpt_period and cfg.OUTPUT_DIR:
                save(epoch, done)
                since["ckpt"] = 0
            if val_period and since["val"] >= val_period and has_val:
                validate(epoch, (epoch - 1) * steps + done)
                since["val"] = 0

        m = epoch_fn(scene, pool, gen, mask_on, batch_size, steps, only_coarse,
                     first=skip, step_generator=step_generator, after_step=after_step)
        metrics = StepMetrics(*(x.cpu().numpy() for x in m))
        elapsed = time.time() - start
        ran = steps - skip
        rays_per_s = ran * batch_size / max(elapsed, 1e-9)
        if main:
            for i in range(0, ran, max(s.LOG_PERIOD, 1)):
                # the reference's line (ref: engine/layered_trainer.py:304-306)
                logger.info("Epoch[%d] Iteration[%d/%d] Loss: %.3e  Psnr coarse: %.2f "
                            "Psnr fine: %.2f Speed: %.1f[rays/s]", epoch, skip + i, steps,
                            float(metrics.loss[i]), float(metrics.psnr_coarse[i]),
                            float(metrics.psnr_fine[i]), rays_per_s)
                if swriter is not None:
                    global_step = (epoch - 1) * steps + skip + i
                    swriter.add_scalar("Loss/train_loss", float(metrics.loss[i]),
                                       global_step)
                    swriter.add_scalar("TrainPsnr", float(metrics.psnr_fine[i]),
                                       global_step)
                    swriter.add_scalar("Loss/mask_loss", float(metrics.mask_loss[i]),
                                       global_step)
                    swriter.add_scalar("Loss/rgb_loss", float(metrics.rgb_loss[i]),
                                       global_step)
        if cfg.OUTPUT_DIR:
            save(epoch)
        if has_val:
            validate(epoch)
        if main:
            logger.info("Epoch %d done. Time: %.3f[s] Speed: %.1f[rays/s]", epoch, elapsed,
                        rays_per_s)
        history.append((epoch, metrics))
        # the metrics are the ranks' means: every rank stops at the same epoch
        mean_psnr = float(np.mean(metrics.psnr_fine))
        if mean_psnr > psnr_thres:
            if main:
                logger.info("Mean epoch PSNR %.3f > threshold %.3f, stopping",
                            mean_psnr, psnr_thres)
            break
    return history
