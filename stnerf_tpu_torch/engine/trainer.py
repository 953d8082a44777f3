"""Training engine (counterpart of ``stnerf_tpu/engine/trainer.py``).

``make_train_step`` builds one step: the layered render of a ray batch
through the differentiable fields (the forward and backward field
kernels on the card), the RGB and mask-alpha losses, and the optimizer
update. ``make_train_epoch`` loops it over batches drawn from a pool
resident on the device, and ``do_train`` is the host loop with the
reference trainer's observability: the per-LOG_PERIOD "rays/s" log line
(ref: engine/layered_trainer.py:301-306), the coarse-only stage
(ref: :191-194), the mask-loss epochs, a checkpoint per epoch and an
optional validation callback.

Training keeps the exact semantics, as the JAX trainer forces them: the
step renders with its own spec (:func:`training_spec`, JAX's
``trainer.py:210-213``), the model's with the inference approximations
stripped (no fast fine stage, no early exit). The merge of every layer's
samples follows ``TPU.COMPOSITOR_KERNEL``: on, the step composites through
the JAX trainer's sort-free compositor (``composite_merged_nosort``), whose
cross-stream terms the kernels K4 and K5 compute on the card; off, through
the sorted merge under autograd, the GPU-native form chosen for the JAX
trainer's default cube compositor (the two are gradient-equal, PARITY.md).
The decoded camera ids drive the pose refinement and the view-deform net.
Randomness comes from a ``torch.Generator`` on the device. Multi-GPU
training is not ported yet; nor is JAX's mid-epoch ``resume_step``, a
workaround for TPU workers dying mid-epoch (resumption is per epoch).
"""

from __future__ import annotations

import dataclasses
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


def _take(tree, idx: torch.Tensor):
    """Rows ``idx`` of every tensor of a (nested) NamedTuple."""
    if isinstance(tree, tuple):
        return type(tree)(*(_take(x, idx) for x in tree))
    return tree[idx]


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
    """The spec a training step renders with (JAX ``trainer.py:210-213``):
    the inference approximations stripped (the early exit always, the fast
    fine stage unless FAST_FINE_TRAIN, which ``LayeredSpec`` refuses), and
    the sort-free compositor exactly when its kernels are on."""
    return dataclasses.replace(spec, nosort_composite=spec.compositor_kernel,
                               coarse_exit_segments=0,
                               fast_fine=bool(spec.fast_fine_train))


def _losses(model: LayeredModel, edits: EditState, remove_outliers: bool,
            scene: SceneBoxes, batch: TrainBatch, generator, mask_on: float,
            only_coarse: bool, plain: bool = False, spec: LayeredSpec | None = None):
    """Forward and loss: MSE on the coarse (and fine) mixed composites plus
    the gated mask-alpha loss (ref: engine/layered_trainer.py:216-281);
    ``spec`` as ``render_rays`` takes it. -> (loss, _RawMetrics)."""
    out = render_rays(model, scene, batch.inputs, edits, generator, plain=plain,
                      only_coarse=only_coarse, trainable=True, spec=spec)
    zero = out.coarse.color.new_zeros(())
    mse_c = rgb_loss(out.coarse.color, batch.rgb)
    m = (mask_alpha_loss(out.coarse_layers.acc, batch.labels) * mask_on
         if remove_outliers else zero)
    loss = mse_c + m
    mse_f = mse_c  # only_coarse: fine == coarse composite, as the reference logs it
    if not only_coarse:
        mse_f = rgb_loss(out.fine.color, batch.rgb)
        m_f = (mask_alpha_loss(out.fine_layers.acc, batch.labels) * mask_on
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


def make_train_step(model: LayeredModel, optimizer, scheduler=None,
                    remove_outliers: bool = False, plain: bool = False,
                    device=None):
    """-> step(scene, batch, generator, mask_on, only_coarse=False) ->
    StepMetrics (0-d tensors on the device). The step renders with
    :func:`training_spec` of the model's spec and leaves the gradients it
    applied in the parameters' ``.grad``. ``plain`` runs the plain forward
    and backward of every kernel instead. The model must already be on
    ``device`` (the CUDA card unless another is named)."""
    device = resolve_device(device)
    _check_device(model, device)
    spec = training_spec(model.spec)
    edits = EditState.identity(spec.layer_num, device=device)

    def step(scene: SceneBoxes, batch: TrainBatch, generator, mask_on: float,
             only_coarse: bool = False) -> StepMetrics:
        optimizer.zero_grad(set_to_none=True)
        loss, raw = _losses(model, edits, remove_outliers, scene, batch, generator,
                            mask_on, only_coarse, plain=plain, spec=spec)
        loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return _finalize_metrics(_RawMetrics(*(x.detach() for x in raw)), only_coarse)

    return step


def make_train_epoch(model: LayeredModel, optimizer, scheduler=None,
                     remove_outliers: bool = False, mesh=None, decode=None,
                     block: int = 1, device=None):
    """-> epoch(scene, pool, generator, mask_on, batch_size, steps,
    only_coarse=False) -> StepMetrics of (steps,) tensors.

    ``pool`` (a TrainBatch, or a CompactPool with ``decode``) lives on the
    device. Each step draws ``batch_size`` rays — a permutation of the pool
    when the epoch's draws fit in it four times over or less, else
    independent indices — or, with ``block`` > 1, ``batch_size / block``
    contiguous blocks (pools ordered by hit pattern). Batches are sorted by
    hit pattern when drawn ray by ray."""
    if mesh is not None:
        raise NotImplementedError("multi-GPU training is not ported to "
                                  "stnerf_tpu_torch yet")
    step = make_train_step(model, optimizer, scheduler, remove_outliers, device=device)
    spec = model.spec
    block = max(int(block), 1)
    # only the fused path's skip flags profit from hit-sorted batches; the
    # staged path of a view-deforming model runs every sample (JAX gates the
    # sort the same way)
    sort_hits = spec.layer_num > 0 and block == 1 and not spec.use_deform_view

    def epoch(scene: SceneBoxes, pool, generator, mask_on: float, batch_size: int,
              steps: int, only_coarse: bool = False) -> StepMetrics:
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
        for starts in order:
            idx = (starts[:, None] * unit + offsets).reshape(-1)
            batch = _take(pool, idx)
            if decode is not None:
                batch = decode(batch)
            if sort_hits:
                batch = sort_batch_by_hit(spec, scene, batch)
            metrics.append(step(scene, batch, generator, mask_on, only_coarse))
        return StepMetrics(*(torch.stack(x) for x in zip(*metrics)))

    return epoch


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


def _epoch_seed(seed: int, epoch: int) -> int:
    """Position-keyed: an epoch draws the same batches whatever ran before."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


def do_train(cfg, model: LayeredModel, scene: SceneBoxes, train_pool: dict,
             optimizer=None, scheduler=None, *, mesh=None, val_fn=None,
             resume_epoch: int = 0, psnr_thres: float = 100.0,
             seed: int = 0, logger: logging.Logger | None = None,
             device=None) -> list:
    """Training host loop (ref: engine/layered_trainer.py:133-331).

    ``train_pool`` is a compact bundle (``"pix"`` in it) or the
    pregenerated {rays, rgbs, labels, near_fars} arrays; it is uploaded to
    the device once. Epochs run from ``resume_epoch + 1`` to
    ``SOLVER.MAX_EPOCHS - 1``: coarse only before ``COARSE_STAGE``, the
    mask loss on before epoch 3; an epoch's batches depend on ``seed`` and
    its number alone, so a resumed run draws what the uninterrupted one
    would have. Each epoch logs the reference's line every
    LOG_PERIOD steps, saves a checkpoint when ``OUTPUT_DIR`` is set, and
    calls ``val_fn(model, epoch)`` if given; training stops after an epoch
    whose mean fine PSNR exceeds ``psnr_thres``. Without an optimizer,
    ``make_optimizer`` builds one. With pose refinement the model must
    hold a correction for every camera of the pool: build it with
    ``LayeredSpec.from_cfg(cfg, camera_num=pool_camera_num(train_pool,
    spec))``; a model with fewer raises. -> [(epoch, StepMetrics of numpy
    arrays)].
    """
    logger = logger or logging.getLogger("stnerf_tpu_torch.train")
    device = resolve_device(device)
    _check_device(model, device)
    if mesh is not None:
        raise NotImplementedError("multi-GPU training is not ported to "
                                  "stnerf_tpu_torch yet")
    s = cfg.SOLVER
    batch_size = s.IMS_PER_BATCH
    if optimizer is None:
        optimizer, scheduler = make_optimizer(cfg, model)
    spec = model.spec
    compact = "pix" in train_pool
    decode = None
    if compact:
        pool, tables, width = split_compact_bundle(train_pool, device)
        decode = make_decode(tables, spec, width)
    else:
        pool = make_pool(train_pool, spec, device)
    n_cams = pool_camera_num(train_pool, spec)
    if model.cam_pose is not None and model.cam_pose.rvec.shape[0] < n_cams:
        raise ValueError(f"the pool draws from {n_cams} cameras, the pose refinement "
                         f"holds {model.cam_pose.rvec.shape[0]}: build the model from "
                         f"LayeredSpec.from_cfg(cfg, camera_num={n_cams})")
    n_pool = pool.rgb.shape[0]
    block = int(getattr(cfg.TPU, "POOL_BLOCK_DRAW", 0) or 0)
    if block > 1 and not (compact and bool(np.asarray(train_pool.get("hit_ordered", 0)))):
        block = 1  # unordered pools: a block is scan-order pixels, no tile payoff
    while block > 1 and batch_size % block:
        block -= 1
    if block > n_pool:
        block = 1
    epoch_fn = make_train_epoch(model, optimizer, scheduler,
                                remove_outliers=cfg.MODEL.REMOVE_OUTLIERS,
                                decode=decode, block=block, device=device)
    steps = max(n_pool // batch_size, 1)
    scene = SceneBoxes(*(t.to(device) for t in scene))
    logger.info("pool resident on %s: %d rays, %d steps/epoch%s", device, n_pool, steps,
                " (compact pixel format)" if compact else "")

    history = []
    for epoch in range(1 + resume_epoch, s.MAX_EPOCHS):
        start = time.time()
        only_coarse = epoch < s.COARSE_STAGE
        mask_on = 1.0 if epoch < 3 else 0.0
        gen = torch.Generator(device=device).manual_seed(_epoch_seed(seed, epoch))
        m = epoch_fn(scene, pool, gen, mask_on, batch_size, steps, only_coarse)
        metrics = StepMetrics(*(x.cpu().numpy() for x in m))
        elapsed = time.time() - start
        rays_per_s = steps * batch_size / max(elapsed, 1e-9)
        for i in range(0, steps, max(s.LOG_PERIOD, 1)):
            # the reference's line (ref: engine/layered_trainer.py:304-306)
            logger.info("Epoch[%d] Iteration[%d/%d] Loss: %.3e  Psnr coarse: %.2f "
                        "Psnr fine: %.2f Speed: %.1f[rays/s]", epoch, i, steps,
                        float(metrics.loss[i]), float(metrics.psnr_coarse[i]),
                        float(metrics.psnr_fine[i]), rays_per_s)
        if cfg.OUTPUT_DIR:
            save_checkpoint(cfg.OUTPUT_DIR, model, optimizer, scheduler, epoch)
        if val_fn is not None:
            val_fn(model, epoch)
        logger.info("Epoch %d done. Time: %.3f[s] Speed: %.1f[rays/s]", epoch, elapsed,
                    rays_per_s)
        history.append((epoch, metrics))
        mean_psnr = float(np.mean(metrics.psnr_fine))
        if mean_psnr > psnr_thres:
            logger.info("Mean epoch PSNR %.3f > threshold %.3f, stopping", mean_psnr,
                        psnr_thres)
            break
    return history
