#!/usr/bin/env python3
"""Drive the PyTorch port (``stnerf_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Card and build: prints the card's ``name, power.limit`` as nvidia-smi
   gives them, builds every kernel of the render and training paths from the
   sources in this checkout (``build/kernels/``, one nvcc per source, in
   parallel) and prints the build's seconds.
2. Kernel vs plain: ``fused_field`` against ``fused_field_reference`` at the
   taekwondo widths (W=256, head 128, motion 128) on M = 4096 x 120 seeded
   samples, for a performer ("lerp" motion, time input), the background (no
   motion, no time), "direct" motion and a 4-layer rgb head, with skip
   flags that zero some tiles: float32 kernel (CUDA cores) vs float32 plain
   (TF32 off) within rtol 2e-3, atol 2e-4 and bitwise the same when run
   twice; bf16 kernel (tensor cores) vs
   bf16 plain within relative L2 1e-2 on rgb and on sigma, and vs float32
   plain >= 40 dB on sigmoid(rgb); the training forward (``checked``: the
   near-tie outputs recomputed in float32) within relative L2 1e-2 too,
   and the share of outputs not bitwise the plain version's printed for
   both; one ``checked`` launch's taps read back (``fwd_taps``: the
   encodings and every layer's bf16 output) and every tapped activation
   held to the k-order rounding of its layer on its own input tile (the
   count per layer printed, 0 allowed). Then the edges: a narrow model (trunk
   64, head 32, motion 32), a performer at widths no kernel tiles (96/48/48,
   packed at 128/64/64 with zeros in the padded units), a ragged M with
   all tiles on, all off and no flags, and three fields wider than 256,
   which every kernel runs with a smaller sample block:
   ``wide_performer`` (512/256/256), ``wide_padded``
   (384/192/160, packed at 512/256/256) and ``xwide_background``
   (1024/512), each with every route's sample block (the widths up to 256
   must keep 64 in float32 and 128 in bf16); a 1040-wide field refused
   before any launch. Prints both routes' times and bounds
   per case, and ``fused_field_float32_ring`` for the performer: the float32
   kernel's weight ring (stages, a stage's bytes, the block's dynamic shared
   memory) beside its ms, its ms before the ring, its bound and share.
3. The slice: five edit requests of the taekwondo model (L=2, 90+30
   samples, space-time and deform-time on, bf16, exact settings) rendered at
   480x270 through ``render_pose_host``, chunk 4096, 64-pixel tiles. Checks
   finite images, acc in [0, 1], exact zero acc for a hidden layer, >= 40 dB
   between the kernel path and the plain path on the same card, and that
   the field evaluations of those renders launched the kernel exactly as
   often as they imply. Prints seconds per pose for both paths.
4. Backward kernel vs plain: ``field_bwd`` against ``field_bwd_reference`` at
   the taekwondo widths on M = 2000 x 120 seeded samples (one fine stage of
   a batch), the same four fields, seeded cotangents, 25% of the tiles
   flagged off: skipped tiles give exactly zero d_xyz and d_dir; float32 vs
   float32 (TF32 off) per gradient leaf within rtol 2e-3, atol 2e-3 max|g|
   but for at most one entry or 0.1% of the leaf (a ReLU input within
   round-off of 0 masks differently under the two summation orders;
   ``f32_close``); bf16 (tensor cores, two passes) vs bf16 relative L2 <=
   1e-2 per leaf on the inputs of a real training step's backward (phase
   5's model, pool and batch; ``real_bwd_inputs``); both routes bitwise the
   same gradients when run twice (``check_field_bwd``; float32: three
   passes, 3xTF32 products, a fixed-order sum). The same edges as phase 2
   (bf16 on the real background inputs cut to the ragged M), each route's
   backward block (64 up to 256); the three wide ones as comparisons too,
   a leaf past the fixed bars held to ``order_bar`` (within twice the
   plain version's own deviation with its hidden units permuted: at 512
   and 1024 two plain summation orders alone miss the fixed bars), with
   each route's block, ms, bound and share; a training step of each wide
   performer (``field_planar_trainable``, forward and backward) launched on
   its dtype's route; a 1040-wide field refused before any launch. In every
   bf16 case the kernel's pass-1 records are read back (a launch into a
   workspace made here, ``bwd_records_check``) and every recorded bf16
   activation must be the k-order rounding of its layer on the record's own
   inputs (float32 FMAs in k order, as the near-tie recompute sums): the
   count per layer is printed and must be 0; each bf16 leaf's relative L2
   is printed, and the worst before the recompute was checked beside the
   wide ones; K1's ``checked`` forward on the same inputs is read back
   with taps and must equal the records bit for bit, tile by tile
   (``taps_vs_records``: the forward and the backward round alike). Prints
   both routes' times and bounds per case at the seeded shape, the float32
   route's workspace, and its time beside the former design's.
5. Training: ``do_train`` on the taekwondo model at batch 2000 (one
   coarse-only epoch, then one full epoch, 20 steps each) from a compact
   pool of 40,000 rays of 8 ring cameras at 1920x1080 around the scene of
   phase 3, flat colour per segmentation label. Checks finite losses, a
   falling loss over the full epoch, that the backward kernel launched
   once per field and stage of every step, and a checkpoint round trip;
   then one training step through the kernels and one through the plain
   versions from the same weights and batch, gradients compared per leaf
   (bf16: relative L2 <= 1e-2; float32 as phase 4), each kernel step's
   launches by route. Prints seconds per step and rays/s for both paths.
6. SpaceNet kernels vs plain: ``spacenet_fwd`` and ``spacenet_bwd`` (K3)
   against their plain versions at the taekwondo widths on M = 2000 x 120
   seeded encodings (every sample), for a performer with time, the
   background, a 4-layer rgb head and a field without directions: forward
   float32 (CUDA cores) at rtol 2e-3, atol 2e-4 and bf16 (tensor cores) vs
   float32 >= 40 dB; backward float32 at phase 4's bar and bf16 relative L2
   <= 1e-2 per leaf, both routes' gradients bitwise the same when run twice;
   the float32 forward bitwise the same when run twice too; for the
   performer, the device-side ``active`` flag: 1 leaves the forward and
   every gradient bitwise unchanged, 0 gives zeros everywhere. The same
   checks on the edges: a narrow model (trunk 64, head 32), a performer at
   F8_WIDTHS' trunk and head (96/48, packed at 128/64), a ragged M with
   the flag unset, 1 and 0, and phase 2's three wide fields (both halves,
   each route's forward and backward block, the backward held to
   ``order_bar`` as phase 4's, each backward route's ms, bound and
   share); a training step of each wide field
   (``spacenet_planar_trainable``) on its dtype's route; a 1040-wide
   field refused before any launch. Every bf16 case's records held to the
   k-order rounding as in phase 4, its leaves printed, and its forward's
   taps held to the same and to the records bit for bit. Then the three K6 entry points
   (``fused_spacenet*``, on K3's forward kernels) against their plain
   versions at one shape, and at 512/256 (``fused_spacenet_vs_plain_wide``),
   with the taps of their kernel (K3's forward) on the first entry's inputs.
   Prints both routes' times, bounds and shares of
   bound, and ``spacenet_fwd_float32_ring`` for the performer: the float32
   forward's weight ring (stages, a stage's bytes, the block's dynamic
   shared memory) beside its ms, its ms before the ring, its bound and
   share.
7. The view-deform + pose-refinement model (phase 3's model with
   USE_DEFORM_VIEW and POSE_REFINEMENT on, 8 cameras, camera 0's correction
   off the identity): three of phase 3's requests at 480x270 through
   ``render_pose_host``, every field through K3's forward (a performer that
   a chunk misses, or that is hidden, skipped by its flag on the device:
   the kernel still launches and its blocks exit). Checks finite
   images, exact zero acc for a hidden layer, >= 40 dB between the kernel
   and plain paths, and K3's forward launches against what the renders
   imply, every one on the tensor-core route. Prints seconds per pose.
7b. The wide slice (``phase_wide_slice``): the taekwondo model at trunk
   512, head 256, motion 256 (``merge_from_list`` on
   configs/config_taekwondo.yml):
   phase 3's five requests in bf16 (K1's tensor-core kernel, blocks of 64),
   the first in float32 (K1's CUDA-core kernel, blocks of 32) and phase
   7's three requests of its view-deform variant (K3's forward, blocks of
   64), at 480x270 through ``render_pose_host``. Checks finite images, the
   edits, the launches the renders imply, each route >= 40 dB from its
   plain path on the first request at 240x135; prints each field's sample
   block per route, then
   ``wide_kernels``: every forward route on the 512/256/256 performer at M
   = 240,000 (ms, plain ms, block, bound, share; the two checked bf16
   routes' taps held to the k-order rounding) and the phase's seconds.
8. Training that model on phase 5's pool as phase 5 does: finite losses, a
   falling loss over the full epoch, K3's forward and backward each once
   per field and stage of every step, all on the tensor-core route,
   non-zero ``cam_pose`` and ``view_deform`` gradients; then one step
   through the kernels and one through the plain versions in float32 and
   in bf16 (every leaf at relative L2 <= 1e-2 but the two ``cam_pose``
   leaves, held to a tenth of their own bf16 rounding error), each kernel
   step's K3 launches by route. Prints seconds per step and rays/s.
8b. The wide slice in training (``phase_wide_train``): phase 7b's
   512/256/256 model through ``do_train`` on phase 5's pool as phase 5
   does (bf16): finite losses, a falling loss over the full epoch, K1
   (``checked``) and K2 once per field and stage of every step, all on the
   tensor-core route, no plain field evaluation; one step through the
   kernels and one through the plain versions in bf16 and float32 (phase
   5's bars) and of its view-deform variant (K3's forward and backward,
   phase 8's bars), each also against the plain step on a copy of the
   model with its hidden units permuted (``order_bar``), every forward
   and backward call of each bf16 kernel step launched once more, the
   backward's records and the forward's taps held to the k-order rounding
   and to each other as in phase 4, every bf16 leaf printed
   (``train_step_bf16_leaves``, as in phases 5, 8 and 14); then
   ``wide_bwd_kernels``: every backward route on the 512/256/256
   performer at M = 240,000 (block, ms, plain ms, bound, share) and the
   phase's seconds.
9. Cross-stream kernels vs plain: ``cross_successor`` (K4) and
   ``cross_log_transmittance_fwd`` / ``_bwd`` (K5) against their plain cube
   forms at (3, 2000, 120), (3, 2000, 90), a ragged (3, 37, 24) with
   exact cross-layer ties, saturated factors and parked depths (sorted
   streams: the kernels' search route), the same with three streams
   shuffled and a NaN depth (the all-pairs route), and the edges S = 1,
   L = 1, N = 0, (5, 257, 45) and S = 512: K4 equal, NaN in the same
   places; K5 within rtol 1e-5, atol 1e-6 max|plain| wherever the plain
   form is finite, and bitwise the same run twice; each wrapper's
   ``pairwise_rays`` equal to the rays with an unsorted or NaN stream (0
   on sorted ones). Prints per case the kernel's device time (a CUDA
   graph's replay) and a call's time from the host, the plain version's,
   the bound for these inputs and the share of it.
10. The sort-free compositor at (3, 2000, 120) in float32:
   ``composite_merged_nosort(kernel=True)`` against ``kernel=False`` at the
   JAX package's bars, and against the sorted merge at phase 4's float32
   bar; forward + backward ms of the three forms.
11. The training entry point: a synthetic scene written by the port
   (12 cameras x 5 frames x 2+1 layers at 200x150), then
   ``stnerf_tpu_torch.tools.train.main`` in-process on
   configs/config_synthetic.yml with 90+30 samples, TPU.COMPOSITOR_KERNEL
   on, a 40,000-ray pool and one coarse-only and two full epochs of 20
   steps at batch 2000 (widths 256/128/128, bf16). Checks finite losses, a
   falling loss over the last epoch, a finite validation PSNR each epoch,
   K1, K2, K4 and K5 launched exactly as the steps and validation renders
   imply, no ray on K4/K5's all-pairs route (the training streams come
   sorted), no sorted merge in training and no plain compositor at all, the
   per-epoch checkpoints; with CHECKPOINT_PERIOD and VAL_PERIOD 10, the
   ``_{epoch}_10`` checkpoints and a validation at each epoch's step 10;
   the event file under OUTPUT_DIR/tb read back (JAX's tags at the global
   steps, the validation panels); then ``--resume`` for one more epoch,
   whose first loss must equal that of ``do_train`` from checkpoint 3's
   parameters; ``--resume`` from the mid-epoch ``_3_10`` file alone, whose
   losses must equal the uninterrupted epoch 3's from step 10 on, bitwise;
   ``--auto-restart 1`` on a healthy run in a process of its own (exit 0;
   the supervisor never initialised CUDA); then one float32 step with the
   flag on and one with it off from the same weights and batch, every
   gradient leaf at phase 4's bar.
12. The ``{"kernels": [...]}`` line (launches on the main paths, errors, times
   and bounds; the forward routes' rows also the wide slice's launches and
   their ``wide`` times), the card line again, and the result line
   ``{"ok": true, "device": {...}}`` last.
14. (runs after phase 13, before phase 12's lines) Training with the fast
   fine stage (TPU.FAST_FINE_TRAIN) and pose refinement on: ``do_train`` of
   the taekwondo model (bf16, 8 pose corrections) on phase 5's pool, one
   full epoch of 20 steps with TPU.COMPOSITOR_KERNEL off (the payload sort
   and the sorted merge) and one with it on (K4/K5 on the coarse stage,
   ``composite_streams_nosort`` on the fine one). Checks finite losses, a
   falling loss (mean of the last five steps under the first five's), K1
   and K2 once per field and stage of every step on the tensor-core route,
   K4/K5 once per step with the flag on and never without it, no plain
   field or compositor evaluation; prints the fine stage's tiles skipped
   (coarse opacity <= FAST_FINE_EPS) and seconds per step and rays/s
   beside phase 5's exact step, K1's and K2's times at the fine stage's M
   on the run's own last fine-stage inputs. Then one step through the
   kernels and one through the plain versions in float32 and in bf16 on
   the fast fine path and on the exact fused path with pose refinement
   (the port's default training model): every leaf at phase 4's float32
   bar, bf16 relative L2 <= 1e-2 but the two ``cam_pose`` leaves, held to
   a tenth of their own bf16 rounding error (phase 8's bar).
13. The render front end (it runs after phase 11, before phase 12's lines):
   ``LayeredNeuralRenderer`` on phase 11's last checkpoint and scene with
   the config's default inference approximations (fast fine stage, a
   3-segment early-exit coarse march, occupancy with an automatic tau, the
   fidelity gate). Checks that nothing logs "not ported", that the boxes
   were refined (K1 on the 64^3 lattice, held against its plain version
   at relative L2 1e-2) and then read from the cache, that the gate ran,
   set ``fidelity_db`` and kept the approximations. Then the taekwondo
   demo's runs (origin, shift, scale) on a 6-pose smooth path with the
   demo's key frames scaled into the scene's 5 frames, a hide and a
   hide-both pass, an ``s_alpha`` fade and ``render_path_walking``: every
   frame on disk (decoded through data/png.py to the rendered image,
   finite), hiding performers leaves the background stream alone, with
   both hidden the mix is the background stream (>= 40 dB on the
   approximate path) and, on the exact path, the unedited mix of the same
   model with zero-density performers (one u8 step), acc in [0, 1], K1
   against its plain version on one pose of the approximate path (>= 40
   dB), the approximate path against the exact one on the gate's pose at
   the frame's size (the gate's bar; on the path's pose read, unbarred),
   K1's launches against the poses, the
   segments, the fields and the gates' probes, and a second renderer on an
   exported reference ``.pt`` renders bitwise the same pose. Prints, each
   line with the card's name and power limit: the refine time and the
   cache hit, ``fidelity_db``, seconds per pose (end to end, device) and
   K1's tiles run of the approximate and the exact path on the same path
   (order approximate, exact, exact, approximate), seconds per 1920x1080
   frame and peak device memory of both, and one pose with OCC_SLICES = 2
   and OCC_GAP_SKIP on.
15. Distributed (after 14), on phase 11's entry-point config. (a) NCCL at
   world size 1 in this process: ``do_train(mesh=)`` over one full epoch
   of 20 steps against ``do_train`` without a mesh from the same weights
   (plain, mesh, mesh, plain): losses and parameters bitwise, s/step of
   both beside the card's name and power limit (the flat ``all_reduce``'s
   overhead); the first gt pose through ``render_pose_host(mesh=)``
   bitwise the unsharded pose. (b) Two processes on this one card over
   gloo: the pose sharded over both, then one sharded step on two fixed
   halves of a 2000-ray batch. The reduced gradients and the parameters
   after Adam bitwise the in-process reconstruction ((g0 + g1) / 2, one
   Adam step), equal on both ranks; the gathered pose >= 60 dB against
   the one-process pose with the hit masks equal (whether bitwise is
   printed). (b)'s seconds are printed under a key that says they are no
   speed figure: two processes share one card. No scaling across cards is
   measured.
16. The legacy renderer (after 15): ``NeuralRenderer`` on phase 11's last
   checkpoint, each layer's nets as a background-only field, through K1,
   with and without a textured quad (an OBJ with a PNG texture) as the
   mesh background, rasterized by the native host library built from
   ``stnerf_tpu_torch/native/``: ``mix_image``'s z-buffer the nearest
   layer's depth, K1's launches the renders', K1 against its plain
   version >= 40 dB on a field's rays.
17. The model axis (after 16), on phase 11's config (the taekwondo widths),
   each performer field on one model rank (``parallel.shard_params``).
   (a) Two processes on this card over gloo, a (1, 2) mesh: one step on a
   2000-ray batch, each rank's gradients and parameters after Adam bitwise
   the in-process unsharded step's, K1 and K2 launched 4 times a rank (the
   background and its performer, two stages; 6 unsharded); a do_train
   epoch of 20 steps, losses and checkpoints bitwise the unsharded run's;
   the first gt pose through ``render_pose_host(mesh=)`` bitwise. (b) Four
   processes on this card over gloo, a (2, 2) mesh, one step with each
   data row on its fixed half of the batch, every rank bitwise the
   in-process reconstruction ((g0 + g1) / 2, one Adam step). (c) (b) over
   NCCL, one card a rank, where the machine has four cards; with fewer it
   prints that it did not run and why. Per rank: launches, bytes of
   parameters and Adam state beside the unsharded step's, the bytes of
   every gather and of the flat reduction; seconds under a key that says
   they are no speed figure.
18. The convergence A/B's model on the card (after 17), against the
   fixture that the JAX package trained on the CPU
   (``tests/torch_fixtures/trained_synthetic``, written by
   ``tools/torch_convergence_ab.py --write-fixture``; this machine has no
   JAX). (a) ``do_train`` of the A/B's model (configs/config_synthetic.yml,
   widths 64/32/32, 48+24 samples, 6 epochs of 60 steps at batch 1024 from
   a 61,440-ray pool of phase 11's scene, the first coarse only) from the
   fixture's initial weights, in bf16 through K1/K2, once with
   TPU.COMPOSITOR_KERNEL on (K4/K5) and once on the sorted merge: after
   every epoch the mean PSNR on the A/B's fixed views (cameras 0, 3, 6, 9,
   frame indices 1 and 3) inside the band of the fixture's sound float32
   runs (both packages, several seeds, inits nudged one ulp: their range at
   that epoch widened on each side by max(0.5 dB, half the range)); K2
   once per field and stage of every step, K4/K5 once per stage sort-free
   and never sorted. (b) The fixture's JAX-trained checkpoint in
   ``LayeredNeuralRenderer`` at 100x75 from camera 0, each of the six edit
   cases through K1, on the exact path in bf16 and with the config's
   approximations (fast fine stage, 3-segment march, occupancy on the 64^3
   lattice; the gate off) in bf16 and in float32: each case's image (the
   mixed colour) against JAX's renders of the same path >= 40 dB (the
   approximations in bf16: >= 28 dB, as bf16 itself moves them), each
   layer's >= 35 dB on the exact path, whether the refined boxes equal
   JAX's printed; the same pose through the plain field in the same dtype,
   K1 against it >= 40 dB on every image. (c) On
   that checkpoint and one 1024-ray batch, a step through the kernels
   (bf16) against the plain versions in bf16 (relative L2 <= 1e-2 per
   leaf, phase 5's bar) and in float32 (printed per leaf: a trained
   model's bf16 against float32 gradients). Prints the phase's seconds
   and its K1/K2/K4/K5 launches, which the ``kernels`` line counts.
Then the whole script's seconds, the kernels' build included.

Weights are random from a seeded generator, but phase 18's, which come
from the fixture. It needs one CUDA card, and
fails where there is none or where the repository is not beside it.
``python3 chip_smoke.py --model-axis-nccl`` runs phase 17(c) alone (the
build, phase 11's scene written afresh), for a machine with four cards.
``python3 chip_smoke.py --trained-spread`` runs the readings behind 18(a)'s
band and then phase 18 alone: the same training in both forms, in bf16
and in float32, at seed 0, from the initial weights nudged one float32 ulp
and at seeds 1 and 2, each curve inside the band, and per dtype the
largest gap between the card's runs and their mean. ``python3 chip_smoke.py
--backward`` runs phases 4, 6 and 8b alone (K2 and K3 against their plain
versions, both routes, the records check, and the wide slice in training).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# H100 SXM data sheet peaks (dense): bf16 and tf32 tensor cores, FP32 CUDA
# cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# The float32 backward kernels' times before their redesign (three passes,
# 3xTF32 on the tensor cores), at M = 240,000 on the performer field:
# chip_smoke.py's phases 4 and 6 on an NVIDIA H100 80GB HBM3, 700 W (PERF.md)
F32_BWD_MS_BEFORE = {"field_bwd": 48.80, "spacenet_bwd": 52.02}
# K1's float32 kernel before the weight ring (CUDA cores, weights from L2),
# phase 2's performer at M = 491,520 on the same card (PERF.md)
K1_F32_MS_BEFORE = 13.15
# K3's float32 forward before the weight ring (CUDA cores, weights from L2),
# phase 6's performer with time at M = 240,000 on the same card (PERF.md)
K3_F32_FWD_MS_BEFORE = 6.802
# a field at widths no kernel tiles (trunk, head, motion): packed at the
# next kernel widths, 128/64/64
F8_WIDTHS = (96, 48, 48)
# fields wider than 256 (trunk, head, motion), which every kernel runs with
# a smaller sample block: the wide slice's widths, a padded one (packed at
# 512/256/256) and the widest (1024/512); and one wider than the kernels
# take, refused before any launch
WIDE_WIDTHS = (512, 256, 256)
WIDE_PADDED_WIDTHS = (384, 192, 160)
XWIDE_WIDTHS = (1024, 512, 512)
TOO_WIDE_WIDTHS = (1040, 256, 256)
# The wide bf16 backward's readings against its plain version before its
# recompute was near-tie checked (relative L2, the worst leaf of the case;
# PERF.md, Findings): printed beside this run's
UNCHECKED_BF16_WORST = {("field_bwd", "wide_performer"): 0.0116,
                   ("field_bwd", "xwide_background"): 0.0139,
                   ("spacenet_bwd", "xwide_background"): 0.0181,
                   ("step", "view_pose"): 0.0131}


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def check_refused(call, wrappers: list, what: str, limit: int) -> str:
    """``call()`` raises the kernels' ValueError for widths above ``limit``
    before any kernel launch: every wrapper of ``wrappers`` keeps its launch
    count. -> the message."""
    before = [w.launches for w in wrappers]
    try:
        call()
    except ValueError as e:
        check(f"at most {limit}" in str(e), f"{what}: refused for another reason: {e}")
        check([w.launches for w in wrappers] == before, f"{what}: a kernel launched before "
                                                         "the refusal")
        return str(e)
    raise RuntimeError(f"chip_smoke check failed: {what}: not refused")


def wider_than_256(field) -> bool:
    """Whether a packed field has a layer wider than 256: every kernel then
    takes a smaller sample block than at the taekwondo widths."""
    from stnerf_tpu_torch.kernels.fused_field import field_widths

    return max(field_widths(field)) > 256


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` as the device runs it: ``reps`` calls
    captured in one CUDA graph and replayed, so that the host's cost of a
    call (Python, the argument checks, the launch) stays out; after a
    warm-up call on a side stream."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 3) / reps


def field_macs(field) -> dict:
    """Multiply-adds per sample of one field: {"fwd": forward, "bwd": what
    its backward must do — the forward's activations, dW and dx for every
    layer, minus the unused time-input dx}."""
    spec = field.spec
    used = {s: k * o for s, (k, o) in ((s, field.shapes[s]) for s in field.shapes
                                       if len(field.shapes[s]) == 2)}
    if not spec.use_time:
        used.pop("r1c", None)
    if not spec.dir_dim:
        used.pop("r1b", None)
    fwd = sum(used.values())
    return {"fwd": fwd, "bwd": 3 * fwd - used.get("r1c", 0)}


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple:
    """The least time for the work: the larger of operations over the
    card's peak for the dtype and bytes over its memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def f32_bwd_bound_ms(macs: dict, samples: int, nbytes: float) -> tuple:
    """The least time for the operations the float32 backward kernels do
    (csrc/f32_bwd.cuh): the forward's recompute in float32 on CUDA cores,
    dx and dW as 3xTF32 (three tf32 products each) on the tensor cores; the
    two units run side by side, so the larger of the two times, and of the
    bytes' time."""
    t_f32 = 2 * macs["fwd"] * samples / PEAK_FLOPS["float32"] * 1e3
    t_tf32 = 3 * 2 * (macs["bwd"] - macs["fwd"]) * samples / PEAK_FLOPS["tf32"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max((t_f32, "operations"), (t_tf32, "operations"), (t_bytes, "bytes"))


def k6_entries() -> list:
    """K6's three wrappers: no path of the package calls them, so each main
    path's run zeroes and reads their counts too."""
    from stnerf_tpu_torch.kernels.fused_spacenet import (fused_spacenet,
                                                         fused_spacenet_planar,
                                                         fused_spacenet_stacked)

    return [fused_spacenet, fused_spacenet_planar, fused_spacenet_stacked]


def zero_k6():
    for f in k6_entries():
        f.launches = f.launches_tc = 0


def read_k6() -> dict:
    return {f.__name__: f.launches for f in k6_entries()}


def taekwondo_cfg():
    """configs/config_taekwondo.yml with the exact reference semantics set
    explicitly (no fast fine stage, no early exit, no occupancy)."""
    from stnerf_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "config_taekwondo.yml"))
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.FAST_FINE = False
    cfg.TPU.EARLY_EXIT_SEGMENTS = 0
    cfg.TPU.OCCUPANCY_SKIP = False
    cfg.TPU.OCC_GAP_SKIP = False
    cfg.TPU.RENDER_CHUNK = 4096
    cfg.TPU.TILE_COLS = 64
    return cfg


def view_pose_cfg():
    """taekwondo_cfg with view deformation and pose refinement on: the
    model of the staged path (K3)."""
    cfg = taekwondo_cfg()
    cfg.merge_from_list(["MODEL.USE_DEFORM_VIEW", True, "MODEL.POSE_REFINEMENT", True])
    return cfg


def make_model(spec, device):
    """The layered model from a seeded generator. A fresh init's raw
    densities are about +-0.02, an empty scene; the performers' density
    biases are raised by 2 (opaque bodies) and the background's by 0.02 (a
    thin medium in front of its far wall) so that every edit shows."""
    import torch

    from stnerf_tpu_torch.models import LayeredModel

    model = LayeredModel(spec, torch.Generator().manual_seed(SEED), device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("density.0.bias"):
                p += 0.02 if name.startswith("bkgd") else 2.0
    return model


def phase_kernel_vs_plain(device, m: int, reps: int):
    """fused_field vs fused_field_reference on seeded inputs -> per-case
    results (the plain version is the oracle)."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import (TILE, float32_ring, fused_field,
                                                      fused_field_reference, tc_launch)
    from stnerf_tpu_torch.models import LayeredSpec, MotionNet, SpaceNet
    from stnerf_tpu_torch.ops.encoding import positional_encoding_planar

    spec = LayeredSpec.from_cfg(taekwondo_cfg())
    model = make_model(spec, device)
    gen = torch.Generator().manual_seed(SEED + 1)
    direct_net = MotionNet(spec.motion_spec(input_time=False), gen).to(device)
    deep_net = SpaceNet(dataclasses.replace(spec.spacenet_spec(bkgd=False), deep_rgb=True),
                        gen).to(device)
    performer, motion = model.layers_coarse[0], model.motion[0]
    # the main path's two fields, then the kernel's other modes: "direct"
    # motion (a deforming background) and the 4-layer rgb head (DEEP_RGB)
    cases = [("performer_lerp", performer, motion, "lerp"),
             ("background", model.bkgd_coarse, None, None),
             ("background_direct", model.bkgd_coarse, direct_net, "direct"),
             ("performer_deep_rgb", deep_net, motion, "lerp")]

    rng = np.random.default_rng(SEED)
    xyz = torch.tensor(rng.uniform(-3.0, 3.0, (3, m)), dtype=torch.float32, device=device)
    ids = torch.tensor(rng.integers(1, 101, (1, m)) + rng.choice([0.0, 0.25, 0.5], (1, m)),
                       dtype=torch.float32, device=device)
    d = rng.normal(size=(3, m))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dir_enc = positional_encoding_planar(torch.tensor(d, dtype=torch.float32, device=device),
                                         4, True).contiguous()
    n_tiles = -(-m // TILE)
    flags_np = (rng.random(n_tiles) > 0.25).astype(np.int32)
    flags = torch.tensor(flags_np, device=device)
    skipped = torch.tensor(np.repeat(flags_np == 0, TILE)[:m], device=device)
    samples_run = int((~skipped).sum())

    results = []
    for name, net, mnet, mode in cases:
        fields = {dt: pack_dtype(net, mnet, mode, dt) for dt in ("float32", "bfloat16")}
        row = check_fused_field(name, fields, xyz, ids, dir_enc, flags, skipped)
        row["samples_run"] = samples_run
        for dt in ("float32", "bfloat16"):
            f = fields[dt]
            # bytes: xyz, ids, dir_enc in, rgb and sigma out, and the weights once
            nbytes = 4 * m * (4 + dir_enc.shape[0] + 4) + f.weights.element_size() * f.weights.numel()
            row[f"{dt}_bound_ms"], row[f"{dt}_bound_by"] = bound_ms(
                2 * field_macs(f)["fwd"] * samples_run, nbytes, dt)
            row[f"{dt}_ms"] = cuda_ms(lambda: fused_field(f, xyz, ids, dir_enc, flags), reps)
            if dt == "bfloat16":  # the training forward
                row["bfloat16_checked_ms"] = cuda_ms(
                    lambda: fused_field(f, xyz, ids, dir_enc, flags, checked=True), reps)
            row[f"{dt}_plain_ms"] = cuda_ms(
                lambda: fused_field_reference(f, xyz, ids, dir_enc, flags), reps)
        print("kernel_vs_plain", json.dumps(row), flush=True)
        if name == "performer_lerp":  # K1's float32 route on its weight ring
            f = fields["float32"]
            print("fused_field_float32_ring", json.dumps(
                {**float32_ring(f, m, dir_enc.shape[0]), "ms": row["float32_ms"],
                 "before_ms": K1_F32_MS_BEFORE, "plain_ms": row["float32_plain_ms"],
                 "bound_ms": row["float32_bound_ms"],
                 "share": row["float32_bound_ms"] / row["float32_ms"]}), flush=True)
        results.append(row)
    def check_edge(name, fields, xyz, ids, dir_enc, flags, skipped, nets):
        """check_fused_field, and each route's sample block: the widths up
        to 256 keep 64 (float32) and 128 (bf16, render and checked)."""
        row = check_fused_field(name, fields, xyz, ids, dir_enc, flags, skipped)
        m, rows = xyz.shape[1], dir_enc.shape[0]
        row["block_samples"] = {
            "float32": float32_ring(fields["float32"], m, rows)["block_samples"],
            "bfloat16": tc_launch(fields["bfloat16"], m, rows)["block_samples"],
            "bfloat16_checked": tc_launch(fields["bfloat16"], m, rows, True)["block_samples"]}
        if not wider_than_256(fields["float32"]):
            check(row["block_samples"] == {"float32": 64, "bfloat16": 128,
                                           "bfloat16_checked": 128},
                  f"{name}: a width up to 256 took another block: {row['block_samples']}")
        return row

    results += edge_cases(device, check_edge, "kernel_vs_plain_edge", seed=SEED + 5)
    # above the widest kernel width: refused before any launch, both routes
    over = SpaceNet(dataclasses.replace(spec.spacenet_spec(bkgd=True), backbone_dim=1040),
                    gen).to(device)
    for dt in ("float32", "bfloat16"):
        f = pack_dtype(over, None, None, dt)
        msg = check_refused(lambda: fused_field(f, xyz, ids, dir_enc), [fused_field],
                            f"a 1040-wide {dt} field", 1024)
        print("kernel_vs_plain_refused", json.dumps({"width": 1040, "dtype": dt,
                                                     "message": msg}), flush=True)
    return results


def pack_dtype(net, mnet, mode, dt: str):
    """One field's packed operands in compute dtype ``dt``."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import (pack_field, prepare_kernel_params_planar,
                                                      prepare_motion_params_planar)

    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    return pack_field(prepare_kernel_params_planar(net, tdt),
                      prepare_motion_params_planar(mnet, tdt) if mode else (), net.spec, mode, dt)


def check_fused_field(name, fields, xyz, ids, dir_enc, flags, skipped) -> dict:
    """fused_field against fused_field_reference for one field in both
    dtypes: finite outputs, exact zeros in skipped tiles, float32 within
    rtol 2e-3, atol 2e-4 (CUDA-core route) and bitwise the same when run
    twice, bf16 (tensor-core route) within
    relative L2 1e-2 of the bf16 plain version on rgb and on sigma, and bf16
    >= 40 dB from the float32 plain version on sigmoid(rgb); the checked bf16
    route (the training forward) within the same bar, and every activation
    of one launch's taps the k-order rounding of its layer
    (``fwd_taps_check``). -> the errors."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import fused_field, fused_field_reference

    out = {}
    for dt, f in fields.items():
        got = fused_field(f, xyz, ids, dir_enc, flags)
        sync(xyz.device)
        ref = fused_field_reference(f, xyz, ids, dir_enc, flags)
        check(all(bool(torch.isfinite(g).all()) for g in got), f"{name} {dt}: non-finite")
        if dt == "float32":
            again = fused_field(f, xyz, ids, dir_enc, flags)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name}: float32 outputs differ between two runs")
        check(bool((got[0][:, skipped] == 0).all() and (got[1][skipped] == 0).all()),
              f"{name} {dt}: skipped tiles are not exactly 0")
        out[dt] = got, ref
    (rgb_k, sig_k), (rgb_p, sig_p) = out["float32"]
    err = max(float((rgb_k - rgb_p).abs().max()), float((sig_k - sig_p).abs().max()))
    close = (torch.allclose(rgb_k, rgb_p, rtol=2e-3, atol=2e-4)
             and torch.allclose(sig_k, sig_p, rtol=2e-3, atol=2e-4))
    check(close, f"{name}: f32 kernel vs plain max |err| {err:.3g} outside rtol 2e-3, atol 2e-4")
    (rgb_b, sig_b), (rgb_bp, sig_bp) = out["bfloat16"]
    rel = [compare_leaf(rgb_b, rgb_bp)["rel"], compare_leaf(sig_b, sig_bp)["rel"]]
    check(max(rel) <= 1e-2, f"{name}: bf16 kernel vs bf16 plain relative L2 (rgb, sigma) {rel} "
                            "> 1e-2")
    # the training forward: near-tie outputs recomputed as the plain version
    # rounds them; the share of outputs not bitwise the plain version's
    rgb_c, sig_c = fused_field(fields["bfloat16"], xyz, ids, dir_enc, flags, checked=True)
    rel_c = [compare_leaf(rgb_c, rgb_bp)["rel"], compare_leaf(sig_c, sig_bp)["rel"]]
    check(max(rel_c) <= 1e-2, f"{name}: checked bf16 kernel vs bf16 plain relative L2 "
                              f"(rgb, sigma) {rel_c} > 1e-2")
    differ = [float(((rgb != rgb_bp).sum() + (sig != sig_bp).sum()) / (4 * sig.numel()))
              for rgb, sig in ((rgb_b, sig_b), (rgb_c, sig_c))]
    taps = fwd_taps_check("fused_field", fields["bfloat16"], (xyz, ids, dir_enc, flags))
    check_records(f"{name} K1 checked", taps, "bf16 forward taps")
    db = psnr(torch.sigmoid(rgb_b).cpu(), torch.sigmoid(rgb_p).cpu())
    check(db >= 40.0, f"{name}: bf16 kernel vs f32 plain {db:.1f} dB < 40")
    bf_err = max(float((rgb_b - rgb_bp).abs().max()), float((sig_b - sig_bp).abs().max()))
    return {"case": name, "m": int(xyz.shape[1]), "f32_max_abs_err": err,
            "bf16_vs_bf16_rel_l2": rel, "bf16_vs_bf16_max_abs_err": bf_err,
            "bf16_vs_f32_db": db, "bf16_checked_vs_bf16_rel_l2": rel_c,
            "bf16_share_not_plain_bits": differ[0],
            "bf16_checked_share_not_plain_bits": differ[1],
            "bf16_checked_taps_not_k_order": taps}


def widths_model(cfg, widths, device, camera_num=None):
    """make_model of ``cfg`` at ``widths`` (trunk, head, motion)."""
    from stnerf_tpu_torch.models import LayeredSpec

    cfg.merge_from_list(["MODEL.BACKBONE_DIM", widths[0], "MODEL.HEAD_DIM", widths[1],
                         "MODEL.MOTION_DIM", widths[2]])
    return make_model(LayeredSpec.from_cfg(cfg, camera_num=camera_num), device)


def edge_cases(device, check_fn, label: str, seed: int) -> list:
    """The kernels' edges, both dtypes: a narrow model (trunk 64, head 32,
    motion 32: every width the tiling pads) and a performer at widths no
    kernel tiles (F8_WIDTHS, "lerp" motion with time: packed at the next
    kernel widths, zeros in the padded units) with seeded skip flags (25% of
    the tiles off), and the taekwondo performer at a ragged M (not a
    multiple of 64 or 128) with all tiles flagged on, the seeded flags, all
    flagged off and no flags; then fields wider than 256, with the seeded
    flags: ``wide_performer`` (WIDE_WIDTHS, "lerp" with time),
    ``wide_padded`` (WIDE_PADDED_WIDTHS) and ``xwide_background``
    (XWIDE_WIDTHS' trunk and head). ``check_fn(name, fields, xyz, ids,
    dir_enc, flags, skipped, nets)`` is phase 2's or phase 4's check, nets
    the field's (SpaceNet, MotionNet or None, motion mode). -> its rows."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import TILE
    from stnerf_tpu_torch.models import LayeredSpec
    from stnerf_tpu_torch.ops.encoding import positional_encoding_planar

    m = 2000 * 61 + 45
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device).contiguous()

    xyz = t(rng.uniform(-3.0, 3.0, (3, m)))
    ids = t(rng.integers(1, 101, (1, m)) + rng.choice([0.0, 0.25, 0.5], (1, m)))
    d = rng.normal(size=(3, m))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dir_enc = positional_encoding_planar(t(d), 4, True, recursive=True).contiguous()
    n_tiles = -(-m // TILE)
    narrow = widths_model(taekwondo_cfg(), (64, 32, 32), device)
    f8 = widths_model(taekwondo_cfg(), F8_WIDTHS, device)
    taekwondo = make_model(LayeredSpec.from_cfg(taekwondo_cfg()), device)
    seeded = (rng.random(n_tiles) > 0.25).astype(np.int32)
    wide = widths_model(taekwondo_cfg(), WIDE_WIDTHS, device)
    padded = widths_model(taekwondo_cfg(), WIDE_PADDED_WIDTHS, device)
    xwide = widths_model(taekwondo_cfg(), XWIDE_WIDTHS, device)
    cases = [("narrow_performer", narrow.layers_fine[0], narrow.motion[0], "lerp", seeded),
             ("narrow_background", narrow.bkgd_fine, None, None, seeded),
             ("f8_performer", f8.layers_fine[0], f8.motion[0], "lerp", seeded),
             ("ragged_all_on", taekwondo.layers_fine[0], taekwondo.motion[0], "lerp",
              np.ones(n_tiles, np.int32)),
             ("ragged_quarter_off", taekwondo.layers_fine[0], taekwondo.motion[0], "lerp",
              seeded),
             ("ragged_all_off", taekwondo.layers_fine[0], taekwondo.motion[0], "lerp",
              np.zeros(n_tiles, np.int32)),
             ("ragged_no_flags", taekwondo.layers_fine[0], taekwondo.motion[0], "lerp", None),
             ("wide_performer", wide.layers_fine[0], wide.motion[0], "lerp", seeded),
             ("wide_padded", padded.layers_fine[0], padded.motion[0], "lerp", seeded),
             ("xwide_background", xwide.bkgd_fine, None, None, seeded)]
    rows = []
    for name, net, mnet, mode, flags_np in cases:
        fields = {dt: pack_dtype(net, mnet, mode, dt) for dt in ("float32", "bfloat16")}
        flags = None if flags_np is None else torch.tensor(flags_np, device=device)
        off = np.zeros(m, bool) if flags_np is None else np.repeat(flags_np == 0, TILE)[:m]
        row = check_fn(name, fields, xyz, ids, dir_enc, flags, torch.tensor(off, device=device),
                       (net, mnet, mode))
        print(label, json.dumps(row), flush=True)
        rows.append(row)
    return rows


def scene_and_requests(device, frames: int = 3):
    """The synthetic scene (a 12-unit background box, two 2x2x2 performer
    boxes at z 1-3, one centred and one above it) and five edit requests:
    (name, frame_ids, EditState)."""
    import torch

    from stnerf_tpu_torch.models import EditState, SceneBoxes, compute_scale_pivot

    boxes = torch.tensor([[[-1, -1, 1], [1, 1, 3]], [[-1, 2, 1], [1, 4, 3]]],
                         dtype=torch.float32).expand(frames, 2, 2, 3).contiguous()
    scene = SceneBoxes(torch.tensor([[-6.0, -6.0, -6.0], [6.0, 6.0, 6.0]]), boxes,
                       torch.tensor([0.5, 12.0]))
    scene = SceneBoxes(*(t.to(device) for t in scene))
    ident = EditState.identity(2, compute_scale_pivot(scene.bkgd_box, scene.boxes[0]),
                               device=device)
    ones = [1.0, 1.0, 1.0]

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    requests = [
        ("plain", ones, ident),
        ("hide_layer1", ones, ident._replace(visible=vec([1.0, 0.0, 1.0]))),
        ("shift_scale_layer2", ones, ident._replace(
            shift=vec([[0, 0, 0], [0, 0, 0], [0.5, -0.5, 0.0]]), scale=vec([1.0, 1.0, 1.5]))),
        ("retime_1.5", [1.0, 1.5, 1.5], ident),
        ("alpha_0.5_layer1", ones, ident._replace(alpha=vec([1.0, 0.5, 1.0]))),
    ]
    return scene, requests


def phase_slice(device, h: int, w: int, chunk: int, tile_cols: int):
    """Render the five requests through render_pose_host (kernel path),
    check them, and on the device frames of render_pose_on_device; the
    plain request also through the plain path. -> summary dict."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import fused_field
    from stnerf_tpu_torch.models import LayeredSpec
    from stnerf_tpu_torch.render.pose_device import (render_pose_host,
                                                     render_pose_on_device, tile_grid)

    spec = LayeredSpec.from_cfg(taekwondo_cfg())
    model = make_model(spec, device)
    scene, requests = scene_and_requests(device)
    K = np.array([[w, 0, w / 2], [0, h, h / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, -5.0]
    near_far = np.array([0.5, 12.0], np.float32)
    lp1 = spec.layer_num + 1

    # one untimed render: first-use costs (kernel library load, packing)
    render_pose_host(model, scene, K, c2w, [1.0, 1.0, 1.0], near_far, requests[0][2],
                     h, w, chunk=chunk, tile_cols=tile_cols)
    sync(device)
    fused_field.launches = fused_field.launches_tc = 0
    zero_k6()
    renders, seconds, images = 0, {}, {}
    for name, fids, edits in requests:
        t0 = time.perf_counter()
        color, depth, c_layers, d_layers = render_pose_host(
            model, scene, K, c2w, fids, near_far, edits, h, w, chunk=chunk,
            tile_cols=tile_cols)
        seconds[name] = time.perf_counter() - t0
        renders += 1
        check(color.shape == (h, w, 3) and depth.shape == (h, w, 1), f"{name}: shape")
        check(np.isfinite(color).all() and np.isfinite(depth).all(), f"{name}: non-finite")
        images[name] = color
        frame = render_pose_on_device(
            model, scene, K, torch.as_tensor(c2w, device=device),
            torch.as_tensor(fids, dtype=torch.float32, device=device),
            torch.as_tensor(near_far, device=device), edits, h=h, w=w, chunk=chunk,
            tile_cols=tile_cols)
        renders += 1
        acc, lacc = frame.acc.float(), frame.layer_acc.float()
        check(bool(torch.isfinite(acc).all() and (acc >= 0).all() and (acc <= 1).all()),
              f"{name}: acc outside [0, 1]")
        check(bool(((lacc >= 0) & (lacc <= 1)).all()), f"{name}: layer acc outside [0, 1]")
        if name == "hide_layer1":
            check(bool((lacc[1] == 0).all()), "hidden layer 1 has nonzero acc")
            check(not c_layers[1].any(), "hidden layer 1 has a nonzero image")
        else:
            check(float(lacc[1].max()) > 0, f"{name}: layer 1 not visible")
        print("pose", name, f"{seconds[name]:.3f} s", f"mean acc {float(acc.mean()):.4f}",
              f"mean color {float(color.mean()):.4f}", flush=True)
    for name in images:
        check(name == "plain" or not np.array_equal(images[name], images["plain"]),
              f"{name}: the edit left the image unchanged")
    launches, launches_tc, k6 = fused_field.launches, fused_field.launches_tc, read_k6()
    _, _, _, _, n_pad = tile_grid(h, w, chunk, tile_cols)
    expected = renders * (n_pad // chunk) * 2 * lp1
    check(launches == expected and launches_tc == expected,
          f"fused_field launched {launches} times ({launches_tc} on tensor cores), the bf16 "
          f"renders imply {expected}")

    t0 = time.perf_counter()
    plain_color, *_ = render_pose_host(model, scene, K, c2w, [1.0, 1.0, 1.0], near_far,
                                       requests[0][2], h, w, chunk=chunk,
                                       tile_cols=tile_cols, plain=True)
    plain_s = time.perf_counter() - t0
    db = psnr(images["plain"], plain_color)
    check(db >= 40.0, f"kernel pose vs plain pose {db:.1f} dB < 40")
    summary = {"h": h, "w": w, "chunk": chunk, "kernel_s_per_pose": seconds,
               "plain_s_per_pose": plain_s, "kernel_vs_plain_db": db,
               "launches": launches, "launches_tc": launches_tc, "launches_k6": k6}
    print("slice", json.dumps(summary), flush=True)
    return summary


def compare_leaf(a, b) -> dict:
    """A gradient leaf against its oracle: max abs error, relative L2
    error, and the entries outside rtol 2e-3, atol 2e-3 max|leaf|
    (tests/test_kernels.py's bar)."""
    a, b = (np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64)
            for x in (a, b))
    diff = np.abs(a - b)
    outside = int(np.sum(diff > 2e-3 * max(1e-3, np.abs(b).max()) + 2e-3 * np.abs(b)))
    return {"err": float(diff.max()), "rel": float(np.linalg.norm(a - b)
                                                   / max(np.linalg.norm(b), 1e-30)),
            "outside": outside, "size": int(b.size)}


def f32_close(stat: dict) -> bool:
    """The float32 bar: every entry within the elementwise bar but for at
    most one entry or 0.1% of the leaf. A ReLU whose input lies within
    float32 round-off of 0 masks differently under the kernel's and
    cuBLAS's summation orders; each such flip moves the entries that sample
    feeds by its whole contribution."""
    return stat["outside"] <= max(1, stat["size"] // 1000)


# A wide field's gradients may differ from the plain version's by at most
# this many times what the plain version itself moves when its sums run in
# another order (``order_bar``)
ORDER_FACTOR = 2


def order_bar(stats: dict, yard: dict, dtype: str, bars: dict | None = None) -> dict:
    """The leaves of ``stats`` (kernel vs plain, ``linear_stats``) beyond
    the dtype's bar (float32: ``f32_close``; bf16: relative L2 1e-2) and
    beyond ORDER_FACTOR times the plain version's own deviation ``yard``
    under another summation order (``permuted_nets``' copies, vs the same
    plain version) on that leaf: float32 its entries outside the
    elementwise bar (more than twice the reordered plain version's, plus
    ``f32_close``'s allowance), bf16 its relative L2. At widths above 256
    the two plain orders alone take some leaves beyond the fixed bars: a
    layer of 512 or 1024 units sums more terms, so more ReLU inputs (float32)
    and more bf16 roundings lie within an order's round-off of their flip
    (PERF.md, Findings). ``bars``: a bf16 leaf's fixed bar where it is not
    1e-2. -> {leaf: [kernel, reordered plain]}."""
    bad = {}
    for k, v in stats.items():
        y = yard[k]
        if dtype == "float32":
            if (not f32_close(v)
                    and v["outside"] > ORDER_FACTOR * y["outside"] + max(1, v["size"] // 1000)):
                bad[k] = [v["outside"], y["outside"]]
        elif v["rel"] > max((bars or {}).get(k, 1e-2), ORDER_FACTOR * y["rel"]):
            bad[k] = [v["rel"], y["rel"]]
    return bad


def _leaf_stats(field, got, ref, x_name: str = "d_xyz") -> dict:
    """compare_leaf for every weight and bias slot in the model's own shape
    (a padded field's padded rows and columns are dropped with the
    gradients), the input gradient (``x_name``: d_xyz or d_pos) and d_dir."""
    (gw, gb, gx, gd), (rw, rb, rx, rd) = got, ref

    def leaf(s, w, b):
        return field.cut(s, field.w(s, w) if len(field.shapes[s]) == 2 else field.b(s, b))

    pairs = {s: (leaf(s, gw, gb), leaf(s, rw, rb)) for s in field.shapes}
    pairs.update({x_name: (gx, rx), "d_dir": (gd, rd)})
    return {name: compare_leaf(a, b) for name, (a, b) in pairs.items()}


def _unit_linears(module) -> list:
    """A SpaceNet's linears (stage 1, stage 2, density, rgb: the order of
    ``_field_linears``) or a MotionNet's."""
    from stnerf_tpu_torch.models import MotionNet

    if isinstance(module, MotionNet):
        return list(module.net)
    return [*module.stage1, *module.stage2, *module.density, *module.rgb]


def permute_units(modules: list, seed: int) -> list:
    """Permute at random, in place, the units of every hidden layer of each
    SpaceNet or MotionNet in ``modules``: the same functions, whose every
    sum over a hidden layer runs in another order. -> per module, the
    (output, input) permutation of each of its linears (``_unit_linears``)."""
    import torch

    from stnerf_tpu_torch.models import MotionNet

    gen = torch.Generator().manual_seed(seed)

    def keep(n, start=0):
        return torch.arange(start, start + n)

    ios = []
    for module in modules:
        layers = _unit_linears(module)
        if isinstance(module, MotionNet):  # hidden layers u1-u5
            u = [torch.randperm(layers[0].out_features, generator=gen) for _ in range(5)]
            io = [(u[0], keep(layers[0].in_features))]
            io += [(u[k], u[k - 1]) for k in range(1, 5)] + [(keep(3), u[4])]
        else:  # trunk a0-a6, rgb head h0..
            width = layers[0].out_features
            a = [torch.randperm(width, generator=gen) for _ in range(7)]
            pos = layers[0].in_features
            io = [(a[0], keep(pos))] + [(a[k], a[k - 1]) for k in (1, 2, 3)]
            io += [(a[4], torch.cat([a[3], keep(pos, width)])), (a[5], a[4]), (a[6], a[5]),
                   (keep(1), a[6])]
            rgb = module.rgb
            h = [torch.randperm(rgb[0].out_features, generator=gen)
                 for _ in range(len(rgb) - 1)]
            io += [(h[0], torch.cat([a[6], keep(rgb[0].in_features - width, width)]))]
            io += [(h[i], h[i - 1]) for i in range(1, len(h))] + [(keep(3), h[-1])]
        with torch.no_grad():
            for layer, (po, pi) in zip(layers, io):
                dev = layer.weight.device
                layer.weight.copy_(layer.weight[po.to(dev)][:, pi.to(dev)])
                layer.bias.copy_(layer.bias[po.to(dev)])
        ios.append(io)
    return ios


def unpermute_grads(modules: list, ios: list):
    """Map the ``.grad`` of every linear of ``permute_units``' modules back
    to the units' first order, in place."""
    import torch

    for module, io in zip(modules, ios):
        for layer, (po, pi) in zip(_unit_linears(module), io):
            po, pi = (torch.argsort(q).to(layer.weight.device) for q in (po, pi))
            layer.weight.grad = layer.weight.grad[po][:, pi]
            layer.bias.grad = layer.bias.grad[po]


def permuted_nets(net, mnet, seed: int) -> tuple:
    """Copies of a SpaceNet and its MotionNet (or None) with their hidden
    units permuted (``permute_units``). -> (net, mnet, the (output, input)
    permutation of each linear in ``_field_linears`` order)."""
    import copy

    net, mnet = copy.deepcopy(net), copy.deepcopy(mnet)
    ios = permute_units([net] + ([mnet] if mnet is not None else []), seed)
    return net, mnet, [p for io in ios for p in io]


def linear_stats(field, got, ref, io=None) -> dict:
    """compare_leaf of the gradients per linear of the field (weight and
    bias in the model's own shape, ``_linear_grads``) and of its two input
    gradients. ``io``: ``got`` comes from ``permuted_nets``' copies, whose
    weight gradients are permuted back first."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import _linear_grads

    g, r = _linear_grads(field, *got[:2]), _linear_grads(field, *ref[:2])
    out = {}
    for i, ((gw, gb), (rw, rb)) in enumerate(zip(g, r)):
        if io is not None:
            po, pi = (torch.argsort(p).to(gw.device) for p in io[i])
            gw, gb = gw[po][:, pi], gb[po]
        out[f"L{i}.w"], out[f"L{i}.b"] = compare_leaf(gw, rw), compare_leaf(gb, rb)
    out["d_x"], out["d_dir"] = compare_leaf(got[2], ref[2]), compare_leaf(got[3], ref[3])
    return out


def train_batch(device, bundle, scene, cfg):
    """The trainer's first batch of the ring pool ``bundle`` for the model
    of ``cfg``: decoded, and sorted by hit on the fused path, as
    make_train_epoch makes it. -> (spec, batch)."""
    import torch

    from stnerf_tpu_torch.engine import (make_decode, pool_camera_num, sort_batch_by_hit,
                                         split_compact_bundle)
    from stnerf_tpu_torch.models import LayeredSpec

    spec = LayeredSpec.from_cfg(cfg)
    spec = dataclasses.replace(spec, camera_num=pool_camera_num(bundle, spec))
    pool, tables, width = split_compact_bundle(bundle, device)
    n = cfg.SOLVER.IMS_PER_BATCH
    idx = torch.arange(n, device=device) * (pool.rgb.shape[0] // n)
    batch = make_decode(tables, spec, width)(type(pool)(*(x[idx] for x in pool)))
    if not spec.use_deform_view:  # as the trainer: only the fused path sorts
        batch = sort_batch_by_hit(spec, scene, batch)
    return spec, batch


def real_bwd_inputs(device) -> dict:
    """K2's inputs in a real training step: one plain bf16 step of the
    taekwondo model on the ring pool's first batch (phase 5's), and the
    arguments of its full stage's backward calls (M = batch x 120 samples):
    the main path's sample positions, frame ids, skip flags and the
    rendering loss's cotangents. -> {"performer": (xyz, ids, dir_enc,
    d_rgb, d_sigma, tile_flags), "background": (...)}."""
    import torch

    from stnerf_tpu_torch.engine import make_optimizer, make_train_step
    from stnerf_tpu_torch.kernels import field_vjp

    scene, _ = scene_and_requests(device)
    cfg = taekwondo_cfg()
    cfg.SOLVER.WARMUP_ITERS = 1
    spec, batch = train_batch(device, ring_bundle(scene), scene, cfg)
    calls, plain = [], field_vjp.field_bwd_reference

    def record(field, *args):
        calls.append((bool(field.motion_mode),
                      tuple(None if a is None else a.clone() for a in args)))
        return plain(field, *args)

    field_vjp.field_bwd_reference = record  # the plain step's backward looks it up there
    try:
        model = make_model(spec, device)
        opt, sched = make_optimizer(cfg, model)
        step = make_train_step(model, opt, sched, remove_outliers=True, plain=True,
                               device=device)
        step(scene, batch, torch.Generator(device=device).manual_seed(SEED), 1.0)
    finally:
        field_vjp.field_bwd_reference = plain
    m = max(args[0].shape[1] for _, args in calls)
    return {name: next(args for motion, args in calls if motion == want and args[0].shape[1] == m)
            for name, want in (("performer", True), ("background", False))}


def _skipped(flags, m: int):
    """The samples of the tiles whose skip flag is 0 (none without flags)."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import TILE

    if flags is None:
        return torch.zeros(m, dtype=torch.bool, device="cpu")
    return (flags == 0).repeat_interleave(TILE)[:m]


def phase_field_bwd_vs_plain(device, m: int, reps: int):
    """field_bwd vs field_bwd_reference (the oracle) -> per-case results.
    float32 on seeded inputs and cotangents at M = m with 25% of the tiles
    off, the timed shape; bf16 on a real training step's inputs
    (``real_bwd_inputs``: the performer field's for the performer cases, the
    background's for the others). Seeded inputs are ill-conditioned for
    bf16: at random frame ids 1-100 and positions in [-3, 3]^3 the motion
    net's output, fed through the encoding's top octave (x 2^9), turns a
    bf16 rounding that a change of summation order flips into a different
    input of the trunk, and the leaves move by a few percent between any
    two orders (PERF.md, PR 5); their reading is printed, unbarred. The bf16
    route run twice gives the same gradients bit for bit (no atomics)."""
    import torch

    from stnerf_tpu_torch.kernels import f32_bwd
    from stnerf_tpu_torch.kernels.field_vjp import (field_bwd, field_bwd_reference,
                                                    field_planar_trainable, tc_bwd_launch)
    from stnerf_tpu_torch.kernels.fused_field import TILE, fused_field
    from stnerf_tpu_torch.models import LayeredSpec, MotionNet, SpaceNet
    from stnerf_tpu_torch.ops.encoding import positional_encoding_planar

    spec = LayeredSpec.from_cfg(taekwondo_cfg())
    model = make_model(spec, device)
    gen = torch.Generator().manual_seed(SEED + 1)
    direct_net = MotionNet(spec.motion_spec(input_time=False), gen).to(device)
    deep_net = SpaceNet(dataclasses.replace(spec.spacenet_spec(bkgd=False), deep_rgb=True),
                        gen).to(device)
    cases = [("performer_lerp", model.layers_fine[0], model.motion[0], "lerp"),
             ("background", model.bkgd_fine, None, None),
             ("background_direct", model.bkgd_fine, direct_net, "direct"),
             ("performer_deep_rgb", deep_net, model.motion[0], "lerp")]

    rng = np.random.default_rng(SEED + 2)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device).contiguous()

    xyz = t(rng.uniform(-3.0, 3.0, (3, m)))
    ids = t(rng.integers(1, 101, (1, m)) + rng.choice([0.0, 0.25, 0.5], (1, m)))
    d = rng.normal(size=(3, m))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dir_enc = positional_encoding_planar(t(d), 4, True, recursive=True).contiguous()
    cot = (t(rng.normal(size=(3, m))), t(rng.normal(size=m)))
    flags_np = (rng.random(-(-m // TILE)) > 0.25).astype(np.int32)
    flags = torch.tensor(flags_np, device=device)
    skipped = torch.tensor(np.repeat(flags_np == 0, TILE)[:m], device=device)
    samples_run = int((~skipped).sum())
    real = real_bwd_inputs(device)

    results = []
    for name, net, mnet, mode in cases:
        fields = {dt: pack_dtype(net, mnet, mode, dt) for dt in ("float32", "bfloat16")}
        seeded = (xyz, ids, dir_enc, *cot, flags)
        r_args = real["performer" if name.startswith("performer") else "background"]
        row = {"case": name, "m": m, "samples_run": samples_run,
               "bf16_real_m": int(r_args[0].shape[1])}
        row.update(check_field_bwd(name, fields["float32"], seeded, skipped))
        row.update(check_field_bwd(name, fields["bfloat16"], r_args,
                                   _skipped(r_args[-1], r_args[0].shape[1]).to(device)))
        f = fields["bfloat16"]
        first, second = field_bwd(f, *seeded), field_bwd(f, *seeded)
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"{name}: bf16 gradients differ between two runs")
        check(all(bool(torch.isfinite(g).all()) for g in first)
              and bool((first[2][:, skipped] == 0).all() and (first[3][:, skipped] == 0).all()),
              f"{name}: bf16 on seeded inputs: non-finite, or nonzero in skipped tiles")
        stats = _leaf_stats(f, first, field_bwd_reference(f, *seeded))
        row["bf16_seeded_max_rel_l2"] = max(v["rel"] for v in stats.values())
        for dt, f in fields.items():
            args = (f, *seeded)
            row[f"{dt}_ms"] = cuda_ms(lambda: field_bwd(*args), reps)
            row[f"{dt}_plain_ms"] = cuda_ms(lambda: field_bwd_reference(*args), reps)
            # bytes: xyz, ids, dir_enc, both cotangents in, d_xyz and d_dir
            # out, the weights read and their float32 gradients written once
            nbytes = (4 * m * (4 + dir_enc.shape[0] + 4 + 3 + dir_enc.shape[0])
                      + f.weights.element_size() * f.weights.numel()
                      + 4 * (f.weights.numel() + f.biases.numel()))
            row[f"{dt}_bound_ms"], row[f"{dt}_bound_by"] = bound_ms(
                2 * field_macs(f)["bwd"] * samples_run, nbytes, dt)
            if dt == "float32":  # what the kernels do: CUDA cores and 3xTF32
                row["float32_route_bound_ms"], _ = f32_bwd_bound_ms(field_macs(f), samples_run,
                                                                    nbytes)
                plan = f32_bwd.make_plan(f, m, f32_bwd.sm_count(device))
                row["float32_workspace_bytes"] = plan.workspace_bytes
                row["float32_slices_ranges"] = [plan.n_slices, plan.ranges]
        print("field_bwd_vs_plain", json.dumps(row), flush=True)
        if name == "performer_lerp":
            print("field_bwd_float32_new_vs_old", json.dumps(
                {"ms": row["float32_ms"], "before_ms": F32_BWD_MS_BEFORE["field_bwd"],
                 "plain_ms": row["float32_plain_ms"], "bound_ms": row["float32_bound_ms"],
                 "share": row["float32_bound_ms"] / row["float32_ms"]}), flush=True)
        results.append(row)
    background = real["background"]

    def check_edge(name, fields, xyz, ids, dir_enc, flags, skipped, nets):
        """float32 on the edge case's seeded inputs, bf16 on the real
        background inputs cut to its M, both with its flags. A field wider
        than 256: held to ``order_bar`` against its reordered plain version,
        each route's sample block (64 at widths up to 256), its ms, bound
        and share printed."""
        n = xyz.shape[1]
        rng = np.random.default_rng(n)
        cot = (t(rng.normal(size=(3, n))), t(rng.normal(size=n)))
        row = {"case": name, "m": n}
        args = {"float32": (xyz, ids, dir_enc, *cot, flags),
                "bfloat16": (*(a[..., :n].contiguous() for a in background[:5]), flags)}
        order = dict.fromkeys(fields)
        wide = wider_than_256(fields["float32"])
        if wide:
            net_p, mnet_p, io = permuted_nets(*nets[:2], SEED + 10)
            order = {dt: (pack_dtype(net_p, mnet_p, nets[2], dt), io) for dt in fields}
        for dt, f in fields.items():
            row.update(check_field_bwd(name, f, args[dt], skipped, order[dt]))
            row[f"{dt}_block_samples"] = (
                f32_bwd.make_plan(f, n, f32_bwd.sm_count(device),
                                  f32_bwd.smem_optin(device)).block if dt == "float32"
                else tc_bwd_launch(f, n, dir_enc.shape[0])["block_samples"])
            if not wide:
                check(row[f"{dt}_block_samples"] == 64,
                      f"{name} {dt}: a width up to 256 took a backward block of "
                      f"{row[f'{dt}_block_samples']}")
                continue
            a = args[dt]
            run = int((~skipped).sum())
            nbytes = (4 * n * (4 + dir_enc.shape[0] + 4 + 3 + dir_enc.shape[0])
                      + f.weights.element_size() * f.weights.numel()
                      + 4 * (f.weights.numel() + f.biases.numel()))
            ms = cuda_ms(lambda: field_bwd(f, *a), reps)
            b_ms, b_by = bound_ms(2 * field_macs(f)["bwd"] * run, nbytes, dt)
            row.update({f"{dt}_ms": ms, f"{dt}_bound_ms": b_ms, f"{dt}_bound_by": b_by,
                        f"{dt}_share": b_ms / ms})
        return row

    results += edge_cases(device, check_edge, "field_bwd_vs_plain_edge", seed=SEED + 6)
    # a training forward and backward of each wide field: launched, every
    # one on its dtype's route; then a field wider than the kernels take,
    # refused before any launch
    n = 4096
    part = tuple(a[:, :n].contiguous() for a in (xyz, ids, dir_enc))
    for widths in (WIDE_WIDTHS, WIDE_PADDED_WIDTHS, XWIDE_WIDTHS):
        net = widths_model(taekwondo_cfg(), widths, device)
        for dt in ("float32", "bfloat16"):
            for k in (fused_field, field_bwd):
                k.launches = k.launches_tc = 0
            rgb, sigma = field_planar_trainable(net.layers_fine[0], net.motion[0], *part,
                                                flags[:n // TILE], "lerp", dt)
            (rgb.sum() + sigma.sum()).backward()
            grads = [p.grad for p in net.layers_fine[0].parameters()]
            check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads),
                  f"a {widths} {dt} training step: a missing or non-finite gradient")
            tc = int(dt == "bfloat16")
            counts = [fused_field.launches, fused_field.launches_tc, field_bwd.launches,
                      field_bwd.launches_tc]
            check(counts == [1, tc, 1, tc], f"a {widths} {dt} training step launched "
                                            f"{counts} (fused_field, _tc, field_bwd, _tc)")
            print("field_bwd_vs_plain_train", json.dumps(
                {"widths": widths, "dtype": dt, "path": "field_planar_trainable",
                 "launches": counts}), flush=True)
    over = SpaceNet(dataclasses.replace(spec.spacenet_spec(bkgd=True),
                                        backbone_dim=TOO_WIDE_WIDTHS[0]), gen).to(device)
    for dt in ("float32", "bfloat16"):
        msg = check_refused(
            lambda: field_planar_trainable(over, None, *part, flags[:n // TILE], None, dt),
            [fused_field, field_bwd], f"a {TOO_WIDE_WIDTHS[0]}-wide {dt} training forward",
            1024)
        print("field_bwd_vs_plain_refused", json.dumps(
            {"width": TOO_WIDE_WIDTHS[0], "dtype": dt, "path": "field_planar_trainable",
             "message": msg}), flush=True)
    return results


def check_field_bwd(name, f, args, skipped, order=None) -> dict:
    """field_bwd against field_bwd_reference for one packed field on args =
    (xyz, ids, dir_enc, d_rgb, d_sigma, tile_flags): finite gradients, zero
    d_xyz and d_dir in skipped tiles (and all-zero weight gradients when
    every tile is skipped); float32 per leaf within rtol 2e-3, atol 2e-3
    max|g| but for at most one entry or 0.1% of the leaf (``f32_close``),
    and the same bits when run twice (no atomics: three passes, a
    fixed-order sum); bf16 per leaf within relative L2 1e-2 and the same
    bits when run twice, its pass-1 records the k-order rounding and
    bitwise the taps of K1's training forward on the same inputs.
    ``order``: (the field of ``permuted_nets``' copies, their permutations)
    for a field wider than 256: the leaves are the model's
    (``linear_stats``) and held to ``order_bar``. -> the errors."""
    import torch

    from stnerf_tpu_torch.kernels.field_vjp import field_bwd, field_bwd_reference

    dt = f.compute_dtype
    got = field_bwd(f, *args)
    sync(args[0].device)
    ref = field_bwd_reference(f, *args)
    for g in got:
        check(bool(torch.isfinite(g).all()), f"{name} {dt}: non-finite gradient")
    check(bool((got[2][:, skipped] == 0).all() and (got[3][:, skipped] == 0).all()),
          f"{name} {dt}: skipped tiles have nonzero d_xyz or d_dir")
    if bool(skipped.all()):
        check(not got[0].any() and not got[1].any(),
              f"{name} {dt}: every tile skipped, but weight gradients are nonzero")
    again = field_bwd(f, *args)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: {dt} gradients differ between two runs")
    out = {}
    if order is None:
        stats = _leaf_stats(f, got, ref)
        bad = ({k: v for k, v in stats.items() if not f32_close(v)} if dt == "float32" else
               {k: v["rel"] for k, v in stats.items() if v["rel"] > 1e-2})
    else:
        stats = linear_stats(f, got, ref)
        yard = linear_stats(f, field_bwd_reference(order[0], *args), ref, order[1])
        bad = order_bar(stats, yard, dt)
        out[f"{dt}_order_yardstick"] = {  # the leaves beyond the fixed bar: [kernel, plain]
            k: ([v["outside"], yard[k]["outside"]] if dt == "float32"
                else [v["rel"], yard[k]["rel"]])
            for k, v in stats.items() if (not f32_close(v) if dt == "float32" else v["rel"] > 1e-2)}
    if dt == "float32":
        check(not bad, f"{name}: f32 kernel vs plain beyond the float32 bar: {bad}")
        return {**out, "f32_max_abs_err": max(v["err"] for v in stats.values()),
                "f32_max_rel_l2": max(v["rel"] for v in stats.values()),
                "f32_entries_outside": {k: v["outside"] for k, v in stats.items()
                                        if v["outside"]}}
    worst = max(stats, key=lambda k: stats[k]["rel"])
    records = bwd_records("field_bwd", f, args)
    counts = count_not_k_order(f, records)
    out["bf16_records_not_k_order"] = counts
    # K1's training forward on the same inputs: its taps are these records
    agree = taps_vs_records(fwd_taps("fused_field", f, (*args[:3], args[5])), records)
    out["bf16_forward_taps_vs_records"] = agree
    out["bf16_leaf_rel_l2"] = {k: v["rel"] for k, v in stats.items()}
    if ("field_bwd", name) in UNCHECKED_BF16_WORST:
        out["unchecked_worst_rel_l2"] = UNCHECKED_BF16_WORST["field_bwd", name]
    check(not bad, f"{name}: bf16 kernel vs plain relative L2 beyond its bar: {bad}")
    check_records(f"{name} K2", counts)
    check_agree(f"{name} K1 and K2", agree)
    return {**out, "bf16_worst_rel_l2": [worst, stats[worst]["rel"]],
            "bf16_max_abs_err": max(v["err"] for v in stats.values())}


# The tiles of a pass-1 record of the bf16 backward, in tc_bwd.cuh's Rec order
REC_TILES = (["hs0", "hs1", "hs2", "dhs0", "dhs1", "dhs2", "g3rgb"]
             + [f"a{k}" for k in range(7)] + [f"d{k}" for k in range(7)]
             + ["pos", "dir", "time", "sig"] + [f"u{k}" for k in range(6)]
             + [f"du{k}" for k in range(1, 6)] + ["g3m"])


def bwd_record_tiles(f, pos_rows: int, dir_rows: int, time_rows: int) -> tuple:
    """The tiles of one pass-1 record of the bf16 backward of the packed
    field ``f`` (tc_bwd.cuh's ``Rec`` and ``finish_layout``): -> ({tile:
    (first row, rows)}, the record's rows). The rows of the position,
    direction and time encodings as the kernel takes them."""
    def pad(n):
        return -(-n // 16) * 16

    rows = dict.fromkeys(REC_TILES, 0)
    for i in range(f.n_rgb - 1):
        rows[f"hs{i}"] = rows[f"dhs{i}"] = f.head
    rows["g3rgb"] = rows["sig"] = 16
    for k in range(7):
        rows[f"a{k}"] = rows[f"d{k}"] = f.width
    rows.update(pos=pad(pos_rows), dir=pad(dir_rows), time=pad(time_rows))
    if f.motion_mode:
        rows["u0"] = pad(4 * (int(f.spec.include_input) + 2 * f.spec.pos_freqs))
        for k in range(1, 6):
            rows[f"u{k}"] = rows[f"du{k}"] = f.motion_width
        rows["g3m"] = 16
    tiles, at = {}, 0
    for name in REC_TILES:
        if rows[name]:
            tiles[name] = (at, rows[name])
            at += rows[name]
    return tiles, at


def record_layers(f) -> list:
    """Every product layer of pass 1 whose bf16 output the record holds:
    (output tile, [(weight slot, input tile), ...], bias slot), the
    segments in the kernel's order."""
    layers = [("a0", [("w1", "pos")], "b1")]
    layers += [(f"a{k}", [(f"w{k + 1}", f"a{k - 1}")], f"b{k + 1}") for k in (1, 2, 3)]
    layers += [("a4", [("s2a", "a3"), ("s2b", "pos")], "sb1"),
               ("a5", [("s2w2", "a4")], "sb2"), ("a6", [("s2w3", "a5")], "sb3")]
    head = [("r1a", "a6"), ("r1b", "dir")] + ([("r1c", "time")] if f.spec.use_time else [])
    layers.append(("hs0", head, "rb1"))
    layers += [(f"hs{i}", [(f"rgb{i}", f"hs{i - 1}")], f"rgbb{i}")
               for i in range(1, f.n_rgb - 1)]
    if f.motion_mode:
        layers += [(f"u{k}", [(f"m{k - 1}", f"u{k - 1}")], f"mb{k - 1}") for k in range(1, 6)]
    return layers


# The tiles of a record that the checked forwards' taps hold: the encodings
# and every product layer's bf16 output
FWD_TILES = (["hs0", "hs1", "hs2"] + [f"a{k}" for k in range(7)] + ["pos", "dir", "time"]
             + [f"u{k}" for k in range(6)])


def record_tiles(records, bm: int, tiles: dict, on):
    """Records (blocks, rec_rows x bm) int16 in the act layout, one a block
    of ``bm`` samples, with their ``tiles`` ({name: (first row, rows)}) ->
    tile(name): that tile of every block as (rows, samples) int16, the
    samples of [0, M) that ``on`` (a bool per sample) selects;
    ``tile.names`` the tiles there are."""
    nb = records.shape[0]

    def tile(name):
        r0, rows = tiles[name]
        t = records[:, r0 * bm:(r0 + rows) * bm].reshape(nb, rows // 8, bm // 8, 8, 8)
        return t.permute(1, 3, 0, 2, 4).reshape(rows, nb * bm)[:, :on.numel()][:, on]

    tile.names = tuple(tiles)
    return tile


def count_not_k_order(f, tile) -> dict:
    """Per layer of ``record_layers``, the recorded bf16 activations
    (``tile``: ``record_tiles``' accessor) that are not the k-order
    rounding of the layer on the record's own input tiles (so that a flip
    does not cascade): float32 acc + w_k x_k in k order, a segment at a
    time, the segments then the bias added in order, ReLU, rounded to bf16,
    as tc_blocks.cuh's ``recompute_one`` sums (a bf16 x bf16 product is
    exact in float32, so each step is the kernel's FMA). -> {layer: count,
    "outputs": the activations compared}."""
    import torch

    counts, outputs = {}, 0
    for out, segs, bslot in record_layers(f):
        total = None
        for wslot, src in segs:
            w = f.w(wslot).float()
            x = (tile(src).to(torch.int32) << 16).view(torch.float32)
            acc = torch.zeros((w.shape[1], x.shape[1]), device=x.device)
            for k in range(w.shape[0]):
                acc.addcmul_(w[k, :, None], x[k, None, :])
            total = acc if total is None else total + acc
        want = torch.relu(total + f.b(bslot).float()[:, None]).to(torch.bfloat16)
        want, got = want.view(torch.int16), tile(out)
        # +0 and -0 alike
        counts[out] = int(((got != want) & ((got | want) != -32768)).sum())
        outputs += got.numel()
    counts["outputs"] = outputs
    return counts


def tile_samples(flags, m: int, per_tile: bool):
    """Whether each sample of [0, m) ran: its 64-sample tile's skip flag
    (``per_tile``: K1 and K2) or the field's ``active`` flag (K3); every
    sample without flags."""
    import torch

    if flags is None:
        return torch.ones(m, dtype=torch.bool)
    on = flags != 0
    return (on.repeat_interleave(64)[:m] if per_tile else on.expand(m)).cpu()


def bwd_records(kind: str, f, args: tuple, launch=None):
    """One launch of the bf16 backward ``kind`` ("field_bwd": K2, args as
    ``field_bwd``'s; "spacenet_bwd": K3's, as ``spacenet_bwd``'s) into a
    workspace made here, its pass-1 records read back -> their
    ``record_tiles`` over the samples that ran. ``launch(f, args,
    workspace)``: how to launch it (default the wrapper's ``workspace``
    argument; ``tools/torch_ab_phases.py`` calls the C entry of a checkout
    whose wrapper has none). The launch is a check's: the caller reads no
    launch count across it."""
    import torch

    from stnerf_tpu_torch.kernels import field_vjp, spacenet_vjp

    spec = f.spec
    if kind == "field_bwd":
        xyz, ids, dir_enc, _, _, flags = args
        m, dev = xyz.shape[1], xyz.device
        q = field_vjp.tc_bwd_launch(f, m, dir_enc.shape[0])
        nbytes = q["workspace_bytes"]
        per = int(spec.include_input) + 2 * spec.pos_freqs
        tiles, rec_rows = bwd_record_tiles(f, 3 * per, dir_enc.shape[0],
                                           per if spec.use_time else 0)
        call = field_vjp.field_bwd
    else:
        pos, dir_enc, time_enc = args[:3]
        flags = args[5] if len(args) > 5 else None  # active: one flag for every block
        m, dev = pos.shape[1], pos.device
        q = spacenet_vjp.tc_bwd_launch(f, pos, dir_enc, time_enc)
        nbytes = spacenet_vjp.tc_workspace_bytes(f, pos, dir_enc, time_enc)
        tiles, rec_rows = bwd_record_tiles(f, pos.shape[0], dir_enc.shape[0],
                                           time_enc.shape[0] if spec.use_time else 0)
        call = spacenet_vjp.spacenet_bwd
    bm = q["block_samples"]
    n_blocks = -(-m // bm)
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    if launch is None:
        call(f, *args, workspace=work)
    else:
        launch(f, args, work)
    sync(dev)
    records = work[:n_blocks * rec_rows * bm * 2].view(torch.int16).view(n_blocks, rec_rows * bm)
    on = tile_samples(flags, m, kind == "field_bwd").to(dev)
    return record_tiles(records, bm, tiles, on)


def bwd_records_check(kind: str, f, args: tuple, launch=None) -> dict:
    """``bwd_records``' activations held to the k-order rounding
    (``count_not_k_order``) -> the counts."""
    return count_not_k_order(f, bwd_records(kind, f, args, launch))


def fwd_taps(kind: str, f, args: tuple, launch=None):
    """One launch of the checked bf16 forward ``kind`` ("fused_field": K1's
    training forward, args (xyz, ids, dir_enc, tile_flags); "spacenet_fwd":
    K3's forward, args (pos, dir_enc, time_enc[, active])) with taps made
    here: its encodings and bf16 layer outputs, in the backward's record
    layout at the forward's block -> their ``record_tiles`` over the samples
    that ran. ``launch(f, args, taps)``: how to launch it (default the
    wrapper's ``taps`` argument; ``tools/torch_near_tie_variants.py`` calls
    an edited build's C entry). The launch is a check's: the caller reads no
    launch count across it."""
    import torch

    from stnerf_tpu_torch.kernels import spacenet_vjp
    from stnerf_tpu_torch.kernels.fused_field import fused_field, tc_launch

    spec = f.spec
    if kind == "fused_field":
        xyz, ids, dir_enc, flags = args
        m, dev = xyz.shape[1], xyz.device
        q = tc_launch(f, m, dir_enc.shape[0], True)
        taps = torch.empty(q["taps_bytes"], dtype=torch.uint8, device=dev)
        if launch is None:
            fused_field(f, *args, checked=True, taps=taps)
        else:
            launch(f, args, taps)
        per = int(spec.include_input) + 2 * spec.pos_freqs
        tiles, rec_rows = bwd_record_tiles(f, 3 * per, dir_enc.shape[0],
                                           per if spec.use_time else 0)
    else:
        pos, dir_enc, time_enc = args[:3]
        flags = args[3] if len(args) > 3 else None
        m, dev = pos.shape[1], pos.device
        q = spacenet_vjp.tc_launch(f, pos, dir_enc, time_enc)
        taps = torch.empty(q["taps_bytes"], dtype=torch.uint8, device=dev)
        if launch is None:
            spacenet_vjp.spacenet_fwd(f, pos, dir_enc, time_enc, flags, taps=taps)
        else:
            launch(f, args, taps)
        tiles, rec_rows = bwd_record_tiles(f, pos.shape[0], dir_enc.shape[0],
                                           time_enc.shape[0] if spec.use_time else 0)
    sync(dev)
    check(rec_rows == q["tap_rows"], f"{kind}: the taps' record has {q['tap_rows']} rows, "
                                     f"the backward's layout {rec_rows}")
    bm = q["block_samples"]
    n_blocks = -(-m // bm)
    records = taps[:n_blocks * rec_rows * bm * 2].view(torch.int16).view(n_blocks, rec_rows * bm)
    on = tile_samples(flags, m, kind == "fused_field").to(dev)
    return record_tiles(records, bm, {k: v for k, v in tiles.items() if k in FWD_TILES}, on)


def fwd_taps_check(kind: str, f, args: tuple, launch=None) -> dict:
    """``fwd_taps``' activations held to the k-order rounding
    (``count_not_k_order``) -> the counts."""
    return count_not_k_order(f, fwd_taps(kind, f, args, launch))


def taps_vs_records(taps, records) -> dict:
    """The forward's taps against the backward's pass-1 records of the same
    inputs (``fwd_taps``, ``bwd_records``), tile by tile over the samples
    that ran: the bf16 values that differ (+0 and -0 alike). -> {tile:
    count, "values": the values compared}."""
    counts, values = {}, 0
    for name in taps.names:
        a, b = taps(name), records(name)
        counts[name] = int(((a != b) & ((a | b) != -32768)).sum())
        values += a.numel()
    counts["values"] = values
    return counts


def check_records(name: str, counts: dict, what: str = "bf16 pass-1 records"):
    """Fail on any recorded activation that is not the k-order rounding."""
    bad = {k: v for k, v in counts.items() if k != "outputs" and v}
    check(not bad, f"{name}: {what} not the k-order rounding of their layer "
                   f"(per layer, of {counts['outputs']} activations): {bad}")


def check_agree(name: str, counts: dict):
    """Fail on any forward tap that differs from the backward's record."""
    bad = {k: v for k, v in counts.items() if k != "values" and v}
    check(not bad, f"{name}: the checked forward's taps differ from the backward's pass-1 "
                   f"records (per tile, of {counts['values']} values): {bad}")


def _encoded_inputs(device, m: int, seed: int):
    """Seeded encodings as the staged path makes them (double-angle
    recursion): positions in [-3, 3]^3 (63 rows), unit directions (27),
    frame ids 1-100 (21), and seeded cotangents."""
    import torch

    from stnerf_tpu_torch.ops.encoding import positional_encoding_planar as pe

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device).contiguous()

    d = rng.normal(size=(3, m))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return {"pos": pe(t(rng.uniform(-3.0, 3.0, (3, m))), 10, True, recursive=True).contiguous(),
            "dir": pe(t(d), 4, True, recursive=True).contiguous(),
            "time": pe(t(rng.integers(1, 101, (1, m))), 10, True, recursive=True).contiguous(),
            "d_rgb": t(rng.normal(size=(3, m))), "d_sigma": t(rng.normal(size=m))}


def check_spacenet(name, net, x, flags: bool) -> dict:
    """spacenet_fwd / spacenet_bwd (K3) against their plain versions for one
    SpaceNet on the encodings ``x`` (``_encoded_inputs``), both routes:
    finite outputs; the float32 route at rtol 2e-3, atol 2e-4 in the
    forward (CUDA cores) and at phase 4's bar in the backward (three passes,
    3xTF32; ``f32_close``), both bitwise the same when run twice; the bf16
    route (tensor cores) >= 40 dB from the float32 plain forward, its
    backward within relative L2 1e-2 of the bf16 plain version per leaf and
    bitwise the same when run twice, the forward's taps and the backward's
    pass-1 records the k-order rounding and bitwise equal. With ``flags``, the device-side
    ``active`` flag on both routes: 1 leaves the forward and every
    gradient bitwise unchanged, 0 gives zeros everywhere,
    weight gradients included. Each route's sample block, forward and
    backward: at widths up to 256 the forward keeps 64 (float32) and 128
    (bf16), the backward 64 on both routes. A field wider than 256: its
    backward held to ``order_bar`` against a reordered plain version
    (``permuted_nets``) in both dtypes, on the model's leaves.
    -> the errors and each route's sample blocks; ``fields`` and the call
    arguments under "_args" for the timing."""
    import torch

    from stnerf_tpu_torch.kernels import f32_bwd
    from stnerf_tpu_torch.kernels.fused_field import pack_field, prepare_kernel_params_planar
    from stnerf_tpu_torch.kernels.spacenet_vjp import (float32_ring, spacenet_bwd,
                                                       spacenet_bwd_reference, spacenet_fwd,
                                                       spacenet_fwd_reference, tc_bwd_launch,
                                                       tc_launch)

    pos = x["pos"]
    m, device = pos.shape[1], pos.device
    dir_enc = x["dir"] if net.spec.use_dir else torch.zeros((1, m), device=device)
    time_enc = x["time"] if net.spec.use_time else None
    row, args = {"case": name, "m": m}, {}
    net_p, _, io = permuted_nets(net, None, SEED + 11)
    for dt in ("float32", "bfloat16"):
        tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
        f = pack_field(prepare_kernel_params_planar(net, tdt), (), net.spec, None, dt)
        wide = wider_than_256(f)
        fwd_args = (f, pos, dir_enc, time_enc)
        bwd_args = fwd_args + (x["d_rgb"], x["d_sigma"])
        args[dt] = fwd_args, bwd_args
        launch = float32_ring if dt == "float32" else tc_launch
        row[f"{dt}_block_samples"] = launch(*fwd_args)["block_samples"]
        row[f"{dt}_bwd_block_samples"] = (
            f32_bwd.make_plan(f, m, f32_bwd.sm_count(device), f32_bwd.smem_optin(device)).block
            if dt == "float32" else tc_bwd_launch(*fwd_args)["block_samples"])
        if not wide:
            blocks = [row[f"{dt}_block_samples"], row[f"{dt}_bwd_block_samples"]]
            check(blocks == [64 if dt == "float32" else 128, 64],
                  f"{name} {dt}: a width up to 256 took blocks (forward, backward) {blocks}")
        rgb_k, sig_k = spacenet_fwd(*fwd_args)
        got = spacenet_bwd(*bwd_args)
        sync(device)
        check(bool(torch.isfinite(rgb_k).all() and torch.isfinite(sig_k).all()),
              f"{name} {dt}: non-finite forward")
        for g in got:
            check(bool(torch.isfinite(g).all()), f"{name} {dt}: non-finite gradient")
        if flags:  # the device-side skip flag
            on, off = (torch.full((1,), v, dtype=torch.int32, device=device) for v in (1, 0))
            fwd_on, got_on = spacenet_fwd(*fwd_args, on), spacenet_bwd(*bwd_args, on)
            fwd_off, got_off = spacenet_fwd(*fwd_args, off), spacenet_bwd(*bwd_args, off)
            check(all(torch.equal(a, b) for a, b in zip(fwd_on, (rgb_k, sig_k)))
                  and all(torch.equal(a, b) for a, b in zip(got_on, got)),
                  f"{name} {dt}: active 1 changed the forward or a gradient")
            check(not any(bool(a.any()) for a in (*fwd_off, *got_off)),
                  f"{name} {dt}: active 0 left a nonzero output or gradient")
        rgb_p, sig_p = spacenet_fwd_reference(*fwd_args)
        fwd_err = max(float((rgb_k - rgb_p).abs().max()), float((sig_k - sig_p).abs().max()))
        ref = spacenet_bwd_reference(*bwd_args)
        if wide:  # the model's leaves, each against its reordered plain version's
            stats = linear_stats(f, got, ref)
            f_p = pack_field(prepare_kernel_params_planar(net_p, tdt), (), net.spec, None, dt)
            yard = linear_stats(f, spacenet_bwd_reference(f_p, *bwd_args[1:]), ref, io)
            bad = order_bar(stats, yard, dt)
            row[f"{dt}_order_yardstick"] = {
                k: ([v["outside"], yard[k]["outside"]] if dt == "float32"
                    else [v["rel"], yard[k]["rel"]])
                for k, v in stats.items()
                if (not f32_close(v) if dt == "float32" else v["rel"] > 1e-2)}
        else:
            stats = _leaf_stats(f, got, ref, "d_pos")
            bad = ({k: v for k, v in stats.items() if not f32_close(v)} if dt == "float32"
                   else {k: v["rel"] for k, v in stats.items() if v["rel"] > 1e-2})
        if dt == "float32":
            close = (torch.allclose(rgb_k, rgb_p, rtol=2e-3, atol=2e-4)
                     and torch.allclose(sig_k, sig_p, rtol=2e-3, atol=2e-4))
            check(close, f"{name}: f32 forward kernel vs plain max |err| {fwd_err:.3g} "
                         "outside rtol 2e-3, atol 2e-4")
            row["f32_fwd_max_abs_err"] = fwd_err
            check(all(torch.equal(a, b) for a, b in zip(spacenet_fwd(*fwd_args),
                                                        (rgb_k, sig_k))),
                  f"{name}: f32 forward differs between two runs")
            plain_rgb = rgb_p
            row["f32_bwd_max_abs_err"] = max(v["err"] for v in stats.values())
            row["f32_bwd_max_rel_l2"] = max(v["rel"] for v in stats.values())
            row["f32_entries_outside"] = {k: v["outside"] for k, v in stats.items()
                                          if v["outside"]}
            check(not bad, f"{name}: f32 backward kernel vs plain beyond the float32 "
                           f"bar: {bad}")
            again = spacenet_bwd(*bwd_args)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name}: f32 gradients differ between two runs")
        else:
            db = psnr(torch.sigmoid(rgb_k).cpu(), torch.sigmoid(plain_rgb).cpu())
            check(db >= 40.0, f"{name}: bf16 forward kernel vs f32 plain {db:.1f} dB < 40")
            row["bf16_vs_f32_db"] = db
            row["bf16_fwd_max_abs_err"] = fwd_err
            row["bf16_fwd_rel_l2"] = [compare_leaf(rgb_k, rgb_p)["rel"],
                                      compare_leaf(sig_k, sig_p)["rel"]]
            worst = max(stats, key=lambda k: stats[k]["rel"])
            row["bf16_bwd_worst_rel_l2"] = [worst, stats[worst]["rel"]]
            row["bf16_bwd_max_abs_err"] = max(v["err"] for v in stats.values())
            row["bf16_bwd_leaf_rel_l2"] = {k: v["rel"] for k, v in stats.items()}
            if ("spacenet_bwd", name) in UNCHECKED_BF16_WORST:
                row["unchecked_worst_rel_l2"] = UNCHECKED_BF16_WORST["spacenet_bwd", name]
            records = bwd_records("spacenet_bwd", f, bwd_args[1:])
            row["bf16_records_not_k_order"] = count_not_k_order(f, records)
            taps = fwd_taps("spacenet_fwd", f, fwd_args[1:])
            row["bf16_fwd_taps_not_k_order"] = count_not_k_order(f, taps)
            row["bf16_forward_taps_vs_records"] = taps_vs_records(taps, records)
            check(not bad, f"{name}: bf16 backward kernel vs plain relative L2 beyond its "
                           f"bar: {bad}")
            check_records(f"{name} K3", row["bf16_records_not_k_order"])
            check_records(f"{name} K3 forward", row["bf16_fwd_taps_not_k_order"],
                          "bf16 forward taps")
            check_agree(f"{name} K3", row["bf16_forward_taps_vs_records"])
            again = spacenet_bwd(*bwd_args)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name}: bf16 gradients differ between two runs")
    row["_args"] = args
    return row


def phase_spacenet_vs_plain(device, m: int, reps: int):
    """spacenet_fwd / spacenet_bwd (K3) against their plain versions on
    seeded encodings at the taekwondo widths (``check_spacenet``; the
    performer with the ``active`` flag), both routes' times, bounds and
    shares, and the float32 forward's weight ring; then the edges: a narrow
    model (trunk 64, head 32), a performer at F8_WIDTHS' trunk and head
    (packed at 128/64), a ragged M with ``active`` None, 1 and 0, and the
    wide fields of ``edge_cases`` (each with its blocks, and each route's
    backward ms, bound and share); a training step of each wide field
    through both kernels, and a 1040-wide training forward refused before
    any launch -> per-case results."""
    import torch

    from stnerf_tpu_torch.kernels import f32_bwd
    from stnerf_tpu_torch.kernels.spacenet_vjp import (float32_ring, spacenet_bwd,
                                                       spacenet_bwd_reference, spacenet_fwd,
                                                       spacenet_fwd_reference,
                                                       spacenet_planar_trainable,
                                                       tc_workspace_bytes)
    from stnerf_tpu_torch.models import LayeredSpec, SpaceNet

    spec = LayeredSpec.from_cfg(view_pose_cfg(), camera_num=8)
    model = make_model(spec, device)
    gen = torch.Generator().manual_seed(SEED + 4)
    sspec = spec.spacenet_spec(bkgd=False)
    deep_net = SpaceNet(dataclasses.replace(sspec, deep_rgb=True), gen).to(device)
    no_dir_net = SpaceNet(dataclasses.replace(sspec, use_dir=False), gen).to(device)
    cases = [("performer_time", model.layers_fine[0]), ("background", model.bkgd_fine),
             ("performer_deep_rgb", deep_net), ("performer_no_dir", no_dir_net)]
    x = _encoded_inputs(device, m, SEED + 5)

    results = []
    for name, net in cases:
        row = check_spacenet(name, net, x, flags=name == "performer_time")
        args = row.pop("_args")
        f, pos, dir_enc, time_enc = args["float32"][0]
        rows = pos.shape[0] + dir_enc.shape[0] + (0 if time_enc is None else time_enc.shape[0])
        for dt, (fwd_args, bwd_args) in args.items():
            f = fwd_args[0]
            if dt == "bfloat16":  # the records and partial sums of the two passes
                row["bf16_bwd_workspace_bytes"] = tc_workspace_bytes(*fwd_args)
            if name == "performer_time":  # a skipped launch: its blocks exit
                off = torch.zeros((1,), dtype=torch.int32, device=device)
                row[f"{dt}_skipped_fwd_ms"] = cuda_ms(lambda: spacenet_fwd(*fwd_args, off), reps)
                row[f"{dt}_skipped_bwd_ms"] = cuda_ms(lambda: spacenet_bwd(*bwd_args, off), reps)
            w_bytes = f.weights.element_size() * f.weights.numel()
            g_bytes = 4 * (f.weights.numel() + f.biases.numel())
            macs = field_macs(f)
            # forward: the encodings in, rgb and sigma out, the weights once;
            # backward: the encodings and cotangents in, d_pos and d_dir and
            # the float32 weight gradients out
            fwd_bound = bound_ms(2 * macs["fwd"] * m, 4 * m * (rows + 4) + w_bytes, dt)
            bwd_bound = bound_ms(2 * macs["bwd"] * m,
                                 4 * m * (rows + 4 + pos.shape[0] + dir_enc.shape[0])
                                 + w_bytes + g_bytes, dt)
            for half, fn, plain, a, (b_ms, b_by) in (
                    ("fwd", spacenet_fwd, spacenet_fwd_reference, fwd_args, fwd_bound),
                    ("bwd", spacenet_bwd, spacenet_bwd_reference, bwd_args, bwd_bound)):
                row[f"{dt}_{half}_ms"] = cuda_ms(lambda: fn(*a), reps)
                row[f"{dt}_{half}_plain_ms"] = cuda_ms(lambda: plain(*a), reps)
                row[f"{dt}_{half}_bound_ms"], row[f"{dt}_{half}_bound_by"] = b_ms, b_by
                row[f"{dt}_{half}_share"] = b_ms / row[f"{dt}_{half}_ms"]
            if dt == "float32":  # what the backward kernels do: CUDA cores and 3xTF32
                row["float32_bwd_route_bound_ms"], _ = f32_bwd_bound_ms(
                    macs, m, 4 * m * (rows + 4 + pos.shape[0] + dir_enc.shape[0])
                    + w_bytes + g_bytes)
                plan = f32_bwd.make_plan(f, m, f32_bwd.sm_count(device))
                row["float32_bwd_workspace_bytes"] = plan.workspace_bytes
        print("spacenet_vs_plain", json.dumps(row), flush=True)
        if name == "performer_time":
            print("spacenet_fwd_float32_ring", json.dumps(
                {**float32_ring(*args["float32"][0]), "ms": row["float32_fwd_ms"],
                 "before_ms": K3_F32_FWD_MS_BEFORE, "plain_ms": row["float32_fwd_plain_ms"],
                 "bound_ms": row["float32_fwd_bound_ms"],
                 "share": row["float32_fwd_share"]}), flush=True)
            print("spacenet_bwd_float32_new_vs_old", json.dumps(
                {"ms": row["float32_bwd_ms"], "before_ms": F32_BWD_MS_BEFORE["spacenet_bwd"],
                 "plain_ms": row["float32_bwd_plain_ms"],
                 "bound_ms": row["float32_bwd_bound_ms"],
                 "share": row["float32_bwd_share"]}), flush=True)
        results.append(row)

    # the edges: every width the tiling pads, a ragged M (not a multiple of
    # 64 or 128) with the flag unset, 1 and 0, and fields wider than 256
    narrow = widths_model(view_pose_cfg(), (64, 32, 32), device, camera_num=8)
    f8 = widths_model(view_pose_cfg(), F8_WIDTHS, device, camera_num=8)
    wide = {w: widths_model(view_pose_cfg(), w, device, camera_num=8)
            for w in (WIDE_WIDTHS, WIDE_PADDED_WIDTHS, XWIDE_WIDTHS)}
    xe = _encoded_inputs(device, 2000 * 61 + 45, SEED + 7)
    n_edge = xe["pos"].shape[1]
    for name, net, flags in (("narrow_performer", narrow.layers_fine[0], False),
                             ("narrow_background", narrow.bkgd_fine, False),
                             ("f8_performer", f8.layers_fine[0], False),
                             ("ragged_performer", model.layers_fine[0], True),
                             ("wide_performer", wide[WIDE_WIDTHS].layers_fine[0], False),
                             ("wide_padded", wide[WIDE_PADDED_WIDTHS].layers_fine[0], False),
                             ("xwide_background", wide[XWIDE_WIDTHS].bkgd_fine, False)):
        row = check_spacenet(name, net, xe, flags)
        args = row.pop("_args")
        if name.startswith(("wide", "xwide")):  # each backward route's time at the edge M
            for dt, (fwd_args, bwd_args) in args.items():
                f, pos, dir_enc, time_enc = fwd_args
                rows = sum(e.shape[0] for e in (pos, dir_enc, time_enc) if e is not None)
                nbytes = (4 * n_edge * (rows + 4 + pos.shape[0] + dir_enc.shape[0])
                          + f.weights.element_size() * f.weights.numel()
                          + 4 * (f.weights.numel() + f.biases.numel()))
                ms = cuda_ms(lambda: spacenet_bwd(*bwd_args), reps)
                b_ms, b_by = bound_ms(2 * field_macs(f)["bwd"] * n_edge, nbytes, dt)
                row.update({f"{dt}_bwd_ms": ms, f"{dt}_bwd_bound_ms": b_ms,
                            f"{dt}_bwd_bound_by": b_by, f"{dt}_bwd_share": b_ms / ms})
        print("spacenet_vs_plain_edge", json.dumps(row), flush=True)
        results.append(row)
    # a training step of each wide field through both kernels, every launch
    # on its dtype's route; then a field wider than the kernels take,
    # refused before any launch
    n = 4096
    enc = [xe[k][:, :n].contiguous() for k in ("pos", "dir", "time")]
    for widths, model_w in wide.items():
        net = model_w.layers_fine[0]
        for dt in ("float32", "bfloat16"):
            for k in (spacenet_fwd, spacenet_bwd):
                k.launches = k.launches_tc = 0
            pos = enc[0].clone().requires_grad_(True)
            rgb, sigma = spacenet_planar_trainable(net, pos, *enc[1:], dt)
            (rgb.sum() + sigma.sum()).backward()
            grads = [p.grad for p in net.parameters()] + [pos.grad]
            check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads),
                  f"a {widths} {dt} K3 training step: a missing or non-finite gradient")
            tc = int(dt == "bfloat16")
            counts = [spacenet_fwd.launches, spacenet_fwd.launches_tc, spacenet_bwd.launches,
                      spacenet_bwd.launches_tc]
            check(counts == [1, tc, 1, tc], f"a {widths} {dt} K3 training step launched "
                                            f"{counts} (spacenet_fwd, _tc, spacenet_bwd, _tc)")
            print("spacenet_vs_plain_train", json.dumps(
                {"widths": widths[:2], "dtype": dt, "path": "spacenet_planar_trainable",
                 "launches": counts}), flush=True)
    over = SpaceNet(dataclasses.replace(sspec, backbone_dim=TOO_WIDE_WIDTHS[0]),
                    gen).to(device)
    for dt in ("float32", "bfloat16"):
        msg = check_refused(lambda: spacenet_planar_trainable(over, *enc, dt),
                            [spacenet_fwd, spacenet_bwd],
                            f"a {TOO_WIDE_WIDTHS[0]}-wide {dt} K3 training forward", 1024)
        print("spacenet_vs_plain_refused", json.dumps(
            {"width": TOO_WIDE_WIDTHS[0], "dtype": dt, "path": "spacenet_planar_trainable",
             "message": msg}), flush=True)
    return results


def phase_fused_spacenet_vs_plain(device, m: int, reps: int):
    """The three K6 entry points against their plain versions at one shape
    (L = 2 weight sets for the stacked one), float32 (K3's CUDA-core
    forward) at K1's bar and bf16 (K3's tensor-core forward) at phase 2's
    relative L2 1e-2 on rgb and sigma, and both routes' times and bounds;
    then the same at the wide slice's widths (WIDE_WIDTHS, M / 4) ->
    {entry: result} at the taekwondo widths."""
    from stnerf_tpu_torch.models import LayeredSpec

    spec = LayeredSpec.from_cfg(view_pose_cfg(), camera_num=8)
    model = make_model(spec, device)
    results = entries_vs_plain(device, [model.layers_coarse[0], model.layers_fine[1]], m, reps,
                               "fused_spacenet_vs_plain")
    # the wide slice's fields: the forward kernels' smaller sample block
    wide = widths_model(view_pose_cfg(), WIDE_WIDTHS, device, camera_num=8)
    entries_vs_plain(device, [wide.layers_coarse[0], wide.layers_fine[1]], m // 4, reps,
                     "fused_spacenet_vs_plain_wide")
    return results


def entries_vs_plain(device, nets: list, m: int, reps: int, label: str) -> dict:
    """phase_fused_spacenet_vs_plain's checks and times on two SpaceNets
    (the stacked entry takes both) at ``m`` samples a weight set; each row
    printed under ``label``. -> {entry: result}."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import pack_field, prepare_kernel_params_planar
    from stnerf_tpu_torch.kernels.fused_spacenet import (
        fused_spacenet, fused_spacenet_planar, fused_spacenet_planar_reference,
        fused_spacenet_reference, fused_spacenet_stacked, fused_spacenet_stacked_reference)

    x = _encoded_inputs(device, 2 * m, SEED + 6)
    planar = (x["pos"][:, :m].contiguous(), x["dir"][:, :m].contiguous(),
              x["time"][:, :m].contiguous())
    rows = tuple(a.t().contiguous() for a in planar)
    stacked = tuple(torch.stack([a[:, :m].t(), a[:, m:].t()]).contiguous()
                    for a in (x["pos"], x["dir"], x["time"]))
    results = {}
    for dt in ("float32", "bfloat16"):
        tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
        fields = [pack_field(prepare_kernel_params_planar(n, tdt), (), n.spec, None, dt)
                  for n in nets]
        calls = {"fused_spacenet_planar": (fused_spacenet_planar,
                                           fused_spacenet_planar_reference,
                                           (fields[0], *planar), 1),
                 "fused_spacenet": (fused_spacenet, fused_spacenet_reference,
                                    (fields[0], *rows), 1),
                 "fused_spacenet_stacked": (fused_spacenet_stacked,
                                            fused_spacenet_stacked_reference,
                                            (fields, *stacked), 2)}
        for name, (kernel, plain, args, n_sets) in calls.items():
            samples = n_sets * m
            row = results.setdefault(name, {"entry": name, "samples": samples})
            if dt == "float32":
                (rgb_k, sig_k), (rgb_p, sig_p) = kernel(*args), plain(*args)
                sync(device)
                check(rgb_k.shape == rgb_p.shape and sig_k.shape == sig_p.shape,
                      f"{name}: shapes {tuple(rgb_k.shape)} vs {tuple(rgb_p.shape)}")
                err = max(float((rgb_k - rgb_p).abs().max()), float((sig_k - sig_p).abs().max()))
                check(torch.allclose(rgb_k, rgb_p, rtol=2e-3, atol=2e-4)
                      and torch.allclose(sig_k, sig_p, rtol=2e-3, atol=2e-4),
                      f"{name}: f32 kernel vs plain max |err| {err:.3g} outside rtol 2e-3, "
                      "atol 2e-4")
                row["f32_max_abs_err"] = err
                # the encodings in, rgb and sigma out, each weight set once
                n_rows = sum(a.shape[0] for a in planar)
                row["float32_bound_ms"], _ = bound_ms(
                    2 * field_macs(fields[0])["fwd"] * samples,
                    4 * samples * (n_rows + 4) + 4 * fields[0].weights.numel() * n_sets,
                    "float32")
            else:
                (rgb_k, sig_k), (rgb_p, sig_p) = kernel(*args), plain(*args)
                sync(device)
                rel = [compare_leaf(rgb_k, rgb_p)["rel"], compare_leaf(sig_k, sig_p)["rel"]]
                check(max(rel) <= 1e-2, f"{name}: bf16 kernel vs bf16 plain relative L2 "
                                        f"(rgb, sigma) {rel} > 1e-2")
                row["bf16_rel_l2"] = rel
                row["bf16_max_abs_err"] = max(float((rgb_k - rgb_p).abs().max()),
                                              float((sig_k - sig_p).abs().max()))
                if name == "fused_spacenet_planar":  # the forward kernel the entries launch
                    taps = fwd_taps_check("spacenet_fwd", fields[0], planar)
                    check_records(f"{label} K3 forward", taps, "bf16 forward taps")
                    row["bf16_taps_not_k_order"] = taps
                # the encodings in, rgb and sigma out, each weight set once
                n_rows = sum(a.shape[0] for a in planar)
                row["bf16_bound_ms"], row["bound_by"] = bound_ms(
                    2 * field_macs(fields[0])["fwd"] * samples,
                    4 * samples * (n_rows + 4) + 2 * fields[0].weights.numel() * n_sets,
                    "bfloat16")
            row[f"{dt}_ms"] = cuda_ms(lambda: kernel(*args), reps)
            row[f"{dt}_plain_ms"] = cuda_ms(lambda: plain(*args), reps)
    for row in results.values():
        row["float32_share"] = row["float32_bound_ms"] / row["float32_ms"]
        row["widths"] = [fields[0].width, fields[0].head]
        print(label, json.dumps(row), flush=True)
    return results


def ring_bundle(scene, n_rays: int = 40_000, n_cams: int = 8, frames: int = 3):
    """A compact training pool (the layout of the JAX package's
    data/raygen.build_ray_pool): ``n_rays`` pixels of ``n_cams`` cameras on
    a ring around the scene, 1920x1080 intrinsics, frames 1..``frames``.
    Each ray's label is the first performer box it hits (0: none), its
    target a flat colour per label."""
    w, h, focal = 1920, 1080, 1500.0
    rng = np.random.default_rng(SEED + 3)
    boxes = scene.boxes.cpu().numpy()                      # (F, L, 2, 3)
    L = boxes.shape[1]
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float64)
    centre = np.array([0.0, 1.5, 2.0])
    rots, origins = [], []
    for a in np.linspace(0.0, 2 * np.pi, n_cams, endpoint=False):
        pos = centre + 4.5 * np.array([np.cos(a), 0.0, np.sin(a)])
        fwd = (centre - pos) / np.linalg.norm(centre - pos)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        rots.append(np.stack([right, np.cross(fwd, right), fwd], 1))
        origins.append(pos)
    rots, origins = np.array(rots), np.array(origins)
    cams = np.repeat(np.arange(n_cams), n_rays // n_cams)
    pix = rng.integers(0, w * h, n_rays)
    fids = rng.integers(1, frames + 1, n_rays)
    pix3 = np.stack([pix % w, pix // w, np.ones(n_rays)], 1)
    d = pix3 @ np.linalg.inv(K).T
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.einsum("nij,nj->ni", rots[cams], d)
    o = origins[cams]
    t_first = np.full(n_rays, np.inf)
    labels = np.zeros(n_rays, np.int64)
    for layer in range(L):
        box = boxes[fids - 1, layer]                        # (N, 2, 3)
        inv = 1.0 / (d + 2.220446049250313e-16)
        t1, t2 = (box[:, 0] - o) * inv, (box[:, 1] - o) * inv
        t_near, t_far = np.minimum(t1, t2).max(1), np.maximum(t1, t2).min(1)
        hit = (t_far > t_near) & (t_far > 0) & (t_near < t_first)
        labels[hit], t_first[hit] = layer + 1, t_near[hit]
    palette = np.array([[40, 90, 200], [220, 60, 40], [50, 200, 80]], np.uint8)
    near_far = np.zeros((L + 1, frames + 1, n_cams, 2), np.float32)
    near_far[...] = [0.5, 12.0]
    return {"cams": cams, "pix": pix, "frames": fids, "labels": labels,
            "bbox_labels": labels, "rgb": palette[labels % len(palette)],
            "table_inv_K": np.tile(np.linalg.inv(K)[None], (n_cams, 1, 1)).astype(np.float32),
            "table_rot": rots.astype(np.float32), "table_origin": origins.astype(np.float32),
            "table_near_far": near_far, "width": w}


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _flat_leaves(x, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree, np.float64)


def compare_train_step(device, bundle, scene, dtype: str, cfg_fn=None,
                       f32_plain: dict | None = None, order: bool = False,
                       records: bool = False) -> tuple:
    """One training step through the kernels and one through their plain
    versions, from the same weights, batch and sampling noise: gradients
    per leaf, and the seconds of a second step of each path. ``cfg_fn``
    (default taekwondo_cfg) gives the model's config; the peak device memory
    of each second step. -> (row, the plain step's gradients by leaf).

    The bars: float32 as phase 4 (``f32_close``); bf16 relative L2 <= 1e-2
    per leaf, but for the pose refinement's two leaves when the float32
    plain step's gradients ``f32_plain`` are given: those are held to
    max(1e-2, a tenth of their own bf16 rounding error, bf16 plain vs
    float32 plain), a bar measured in the same run and printed beside the
    reading (``pose_bars``). Each sums every ray of its camera, terms that
    the encoding's top octave scales by 2^9 and that cancel, so a change of
    summation order moves it far more than the leaves it sums (even in
    float32: PERF.md, PR 3). The float32 step is therefore the fault check
    for ``cam_pose``: it holds both leaves to the fixed elementwise bar, as
    every other leaf, and the bf16 bar only bounds the rounding on top.
    ``order`` (the fields wider than 256): a third step, the plain versions
    on a copy of the model whose SpaceNets and MotionNets have their hidden
    units permuted (``permute_units``), and every leaf held to
    ``order_bar`` against that step's deviation from the plain one.
    ``records`` (bf16): every call of the checked bf16 kernels in the
    first kernel step (K1's training forward and K2, or K3's forward and
    backward) is launched once more, after the launches are read: the
    backward into a workspace of its own, its pass-1 records held to the
    k-order rounding (``bwd_records``), the forward with taps, held to the
    same (``fwd_taps``) and bitwise to the records of its field's backward
    call (``taps_vs_records``). Every bf16 leaf is printed."""
    import torch

    from stnerf_tpu_torch.engine import make_optimizer, make_train_step
    from stnerf_tpu_torch.models import export_jax_params

    cfg = (cfg_fn or taekwondo_cfg)()
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.SOLVER.WARMUP_ITERS = 1
    spec, batch = train_batch(device, bundle, scene, cfg)
    n = cfg.SOLVER.IMS_PER_BATCH
    from stnerf_tpu_torch.kernels.field_vjp import field_bwd
    from stnerf_tpu_torch.kernels.fused_field import fused_field
    from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_bwd, spacenet_fwd

    from stnerf_tpu_torch.kernels import field_vjp, spacenet_vjp

    counted = (fused_field, field_bwd, spacenet_fwd, spacenet_bwd)
    grads, seconds, launches, peak = {}, {}, {}, {}
    calls = []  # (kind, field, args) of the first kernel step's checked bf16 calls

    def recording(module, kind):
        original = getattr(module, kind)

        def call(field, *args, **kwargs):
            calls.append((kind, field, tuple(None if a is None else a.clone() for a in args)))
            return original(field, *args, **kwargs)
        # a wrapper counts its launches on the function its own module names
        # (the recorder, while it stands in its module's place)
        call.launches = call.launches_tc = 0
        return original, call

    for plain in (False, True):
        for k in counted:
            k.launches = k.launches_tc = 0
        model = make_model(spec, device)
        opt, sched = make_optimizer(cfg, model)
        step = make_train_step(model, opt, sched, remove_outliers=True, plain=plain,
                               device=device)
        watch = records and not plain and dtype == "bfloat16"
        saved = [(mod, kind, *recording(mod, kind)) for mod, kind in
                 ((field_vjp, "fused_field"), (field_vjp, "field_bwd"),
                  (spacenet_vjp, "spacenet_fwd"), (spacenet_vjp, "spacenet_bwd"))
                 ] if watch else []
        for mod, kind, _, call in saved:  # the autograd Functions look them up there
            setattr(mod, kind, call)
        try:
            m = step(scene, batch, torch.Generator(device=device).manual_seed(SEED), 1.0)
        finally:
            for mod, kind, original, call in saved:
                original.launches += call.launches
                original.launches_tc += call.launches_tc
                setattr(mod, kind, original)
        check(bool(torch.isfinite(m.loss)), f"{dtype} step (plain={plain}): loss not finite")
        grads[plain] = dict(_flat_leaves(export_jax_params(model, grad=True)))
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        step(scene, batch, torch.Generator(device=device).manual_seed(SEED + 1), 1.0)
        sync(device)
        seconds[plain] = time.perf_counter() - t0
        peak[plain] = torch.cuda.max_memory_allocated(device)
        if not plain:  # two steps through the kernels, by route
            launches = {f"{k.__name__}{route}": n for k in counted
                        for route, n in (("_tc", k.launches_tc),
                                         ("", k.launches - k.launches_tc))}
    stats = {k: compare_leaf(grads[False][k], b) for k, b in grads[True].items()}
    worst = max(stats, key=lambda k: stats[k]["rel"])
    bars, yard = {}, None
    if order:  # the plain step in another summation order
        from stnerf_tpu_torch.models import MotionNet, SpaceNet

        model = make_model(spec, device)
        mods = [mm for mm in model.modules() if isinstance(mm, (SpaceNet, MotionNet))]
        ios = permute_units(mods, SEED + 12)
        opt, sched = make_optimizer(cfg, model)
        step = make_train_step(model, opt, sched, remove_outliers=True, plain=True,
                               device=device)
        step(scene, batch, torch.Generator(device=device).manual_seed(SEED), 1.0)
        unpermute_grads(mods, ios)
        yard = {k: compare_leaf(a, grads[True][k])
                for k, a in _flat_leaves(export_jax_params(model, grad=True))}
    if dtype == "bfloat16":  # every leaf, kernel vs plain, before the bars
        print("train_step_bf16_leaves", json.dumps(
            {"model": "view_pose" if spec.use_deform_view else "taekwondo",
             "widths": [spec.backbone_dim, spec.head_dim], "pose_refinement": spec.pose_refinement,
             "fast_fine_train": spec.fast_fine_train,
             "rel_l2": {k: v["rel"] for k, v in stats.items()},
             **({"reordered_plain_rel_l2": {k: v["rel"] for k, v in yard.items()}}
                if yard is not None else {})}), flush=True)
        bars = {k: 1e-2 if f32_plain is None or not k.startswith("/cam_pose/") else
                max(1e-2, 0.1 * compare_leaf(grads[True][k], f32_plain[k])["rel"])
                for k in stats}
        if yard is None:
            bad = {k: [v["rel"], bars[k]] for k, v in stats.items() if v["rel"] > bars[k]}
        else:
            bad = order_bar(stats, yard, dtype, bars)
        check(not bad, f"bf16 step: kernel vs plain gradient relative L2 above its bar "
                       f"[rel, bar or reordered plain]: {bad}")
    else:
        bad = ({k: v for k, v in stats.items() if not f32_close(v)} if yard is None
               else order_bar(stats, yard, dtype))
        check(not bad, f"f32 step: kernel vs plain gradients beyond the float32 bar: {bad}")
    row = {"model": "view_pose" if spec.use_deform_view else "taekwondo", "dtype": dtype,
           "pose_refinement": spec.pose_refinement, "fast_fine_train": spec.fast_fine_train,
           "worst_rel_l2": [worst, stats[worst]["rel"]],
           "entries_outside": {k: v["outside"] for k, v in stats.items() if v["outside"]},
           "kernel_s_per_step": seconds[False], "plain_s_per_step": seconds[True],
           "kernel_rays_per_s": n / seconds[False], "plain_rays_per_s": n / seconds[True],
           "kernel_peak_bytes": peak[False], "plain_peak_bytes": peak[True],
           "launches": launches}
    # the fused path: every field through K1 and K2; the staged path
    # (view deformation): through K3's forward and backward
    route = "_tc" if dtype == "bfloat16" else ""
    pair = ("spacenet_fwd", "spacenet_bwd") if spec.use_deform_view else ("fused_field",
                                                                            "field_bwd")
    implied = 2 * 2 * (spec.layer_num + 1)  # two full steps, two stages
    check(launches[pair[0] + route] == implied == launches[pair[1] + route]
          and sum(launches.values()) == 2 * implied,
          f"{dtype} step launched {launches}; two full steps imply {implied} of each of "
          f"{pair} on the {dtype} route")
    if f32_plain is not None:
        row["pose_bars"] = {k: [stats[k]["rel"], b] for k, b in bars.items()
                            if k.startswith("/cam_pose/")}
    if records:  # after the launches were read
        fwd = [c for c in calls if c[0] in ("fused_field", "spacenet_fwd")]
        bwd = [c for c in calls if c[0] in ("field_bwd", "spacenet_bwd")]
        check(len(fwd) == len(bwd) == implied // 2,
              f"{dtype} step: {len(fwd)} forward and {len(bwd)} backward calls recorded, one "
              f"step implies {implied // 2} of each")
        for key in ("records_not_k_order", "forward_taps_not_k_order",
                    "forward_taps_vs_records"):
            row[key] = []
        for i, (kind, field, args) in enumerate(bwd):
            rec = bwd_records(kind, field, args)
            f_kind, _, f_args = next(c for c in fwd if c[1] is field)
            taps = fwd_taps(f_kind, field, f_args)
            row["records_not_k_order"].append(count_not_k_order(field, rec))
            row["forward_taps_not_k_order"].append(count_not_k_order(field, taps))
            row["forward_taps_vs_records"].append(taps_vs_records(taps, rec))
            what = f"{row['model']} {dtype} step, call {i}"
            check_records(what, row["records_not_k_order"][-1])
            check_records(what, row["forward_taps_not_k_order"][-1], "bf16 forward taps")
            check_agree(what, row["forward_taps_vs_records"][-1])
        if spec.use_deform_view:
            row["unchecked_worst_rel_l2"] = UNCHECKED_BF16_WORST["step", "view_pose"]
    if yard is not None:  # the leaves beyond the fixed bar: [kernel, reordered plain]
        row["order_yardstick"] = {
            k: ([v["outside"], yard[k]["outside"]] if dtype == "float32"
                else [v["rel"], yard[k]["rel"]])
            for k, v in stats.items()
            if (not f32_close(v) if dtype == "float32" else v["rel"] > bars.get(k, 1e-2))}
    print("train_step_kernel_vs_plain", json.dumps(row), flush=True)
    return row, grads[True]


def phase_train(device, bundle, scene) -> dict:
    """do_train at the taekwondo width and batch through the kernels on the
    ring pool ``bundle``, its checks, then the step comparison in both
    dtypes -> summary dict."""
    import torch

    from stnerf_tpu_torch.engine import do_train, load_checkpoint, make_optimizer
    from stnerf_tpu_torch.kernels.field_vjp import field_bwd
    from stnerf_tpu_torch.kernels.fused_field import fused_field
    from stnerf_tpu_torch.models import LayeredSpec

    cfg = taekwondo_cfg()
    s = cfg.SOLVER
    s.COARSE_STAGE, s.MAX_EPOCHS, s.WARMUP_ITERS, s.LOG_PERIOD = 2, 3, 1, 5
    cfg.OUTPUT_DIR = os.path.join(REPO, "build", "chip_smoke_train")
    spec = LayeredSpec.from_cfg(cfg)
    model = make_model(spec, device)
    opt, sched = make_optimizer(cfg, model)
    records = []
    logger = logging.getLogger("chip_smoke.train")
    logger.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.emit = lambda r: (records.append(r), print("train", r.getMessage(), flush=True))
    logger.addHandler(handler)

    for k in (fused_field, field_bwd):
        k.launches = k.launches_tc = 0
    zero_k6()
    history = do_train(cfg, model, scene, bundle, opt, sched, logger=logger, seed=SEED,
                       device=device)
    launches, fwd_launches, k6 = field_bwd.launches, fused_field.launches, read_k6()
    check(field_bwd.launches_tc == launches and fused_field.launches_tc == fwd_launches,
          "bf16 training launched a CUDA-core field kernel")
    steps = len(bundle["labels"]) // s.IMS_PER_BATCH
    lp1 = spec.layer_num + 1
    expected = sum(steps * (1 if epoch < s.COARSE_STAGE else 2) * lp1 for epoch, _ in history)
    check([e for e, _ in history] == [1, 2], f"epochs run: {[e for e, _ in history]}")
    check(launches == expected and fwd_launches == expected,
          f"field_bwd / fused_field launched {launches} / {fwd_launches} times in training, "
          f"the steps imply {expected}")
    for epoch, m in history:
        check(bool(np.isfinite(m.loss).all()), f"epoch {epoch}: non-finite loss")
    full = history[-1][1].loss
    check(full[-1] < full[0], f"epoch 2 loss did not fall: {full[0]:.4g} -> {full[-1]:.4g}")
    epoch_s = {r.args[0]: r.args[1] for r in records if r.msg.startswith("Epoch %d done")}

    fresh = make_model(spec, device)
    fresh_opt, fresh_sched = make_optimizer(cfg, fresh)
    info = load_checkpoint(os.path.join(cfg.OUTPUT_DIR, "stnerf_torch_checkpoint_2.pt"),
                           fresh, fresh_opt, fresh_sched)
    check(info["epoch"] == 2 and all(torch.equal(a, b) for a, b in
                                     zip(model.parameters(), fresh.parameters())),
          "checkpoint round trip changed the parameters")
    summary = {"steps_per_epoch": steps, "launches": launches,
               "loss_epoch2_first_last": [float(full[0]), float(full[-1])],
               "s_per_step": {e: t / steps for e, t in epoch_s.items()},
               "rays_per_s": {e: steps * s.IMS_PER_BATCH / t for e, t in epoch_s.items()},
               "launches_fused_field": fwd_launches, "launches_k6": k6}
    print("train", json.dumps(summary), flush=True)
    summary["steps"] = [compare_train_step(device, bundle, scene, dt)[0]
                        for dt in ("bfloat16", "float32")]
    return summary


def phase_view_pose_render(device, h: int, w: int, chunk: int, tile_cols: int):
    """Three of phase 3's requests rendered with the view-deform +
    pose-refinement model through render_pose_host: every field of both
    stages through K3's forward, camera 0's pose correction not the
    identity. -> summary dict."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import fused_field
    from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_fwd
    from stnerf_tpu_torch.models import LayeredSpec
    from stnerf_tpu_torch.render.pose_device import render_pose_on_device, tile_grid
    from stnerf_tpu_torch.render.pose_device import render_pose_host

    spec = LayeredSpec.from_cfg(view_pose_cfg(), camera_num=8)
    model = make_model(spec, device)
    with torch.no_grad():  # novel views take camera 0's correction
        model.cam_pose.rvec[0] = torch.tensor([0.01, -0.02, 0.015, 1.0])
        model.cam_pose.tvec[0] = torch.tensor([0.02, -0.01, 0.03])
    scene, requests = scene_and_requests(device)
    requests = requests[:3]
    K = np.array([[w, 0, w / 2], [0, h, h / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, -5.0]
    near_far = np.array([0.5, 12.0], np.float32)
    lp1 = spec.layer_num + 1

    render_pose_host(model, scene, K, c2w, [1.0, 1.0, 1.0], near_far, requests[0][2],
                     h, w, chunk=chunk, tile_cols=tile_cols)  # untimed: first use
    sync(device)
    spacenet_fwd.launches = spacenet_fwd.launches_tc = fused_field.launches = 0
    zero_k6()
    renders, seconds, images = 0, {}, {}
    for name, fids, edits in requests:
        t0 = time.perf_counter()
        color, depth, c_layers, _ = render_pose_host(model, scene, K, c2w, fids, near_far,
                                                     edits, h, w, chunk=chunk,
                                                     tile_cols=tile_cols)
        seconds[name] = time.perf_counter() - t0
        renders += 1
        check(color.shape == (h, w, 3) and depth.shape == (h, w, 1), f"{name}: shape")
        check(np.isfinite(color).all() and np.isfinite(depth).all(), f"{name}: non-finite")
        images[name] = color
        if name == "hide_layer1":
            frame = render_pose_on_device(
                model, scene, K, torch.as_tensor(c2w, device=device),
                torch.as_tensor(fids, dtype=torch.float32, device=device),
                torch.as_tensor(near_far, device=device), edits, h=h, w=w, chunk=chunk,
                tile_cols=tile_cols)
            renders += 1
            check(bool((frame.layer_acc[1] == 0).all()), "hidden layer 1 has nonzero acc")
            check(not c_layers[1].any(), "hidden layer 1 has a nonzero image")
        print("view_pose_pose", name, f"{seconds[name]:.3f} s",
              f"mean color {float(color.mean()):.4f}", flush=True)
    launches, launches_tc, k6 = spacenet_fwd.launches, spacenet_fwd.launches_tc, read_k6()
    check(fused_field.launches == 0, "the staged path launched the fused field kernel")
    _, _, _, _, n_pad = tile_grid(h, w, chunk, tile_cols)
    expected = renders * (n_pad // chunk) * 2 * lp1
    check(launches == expected,
          f"spacenet_fwd launched {launches} times, the renders imply {expected}")
    check(launches_tc == launches,
          f"bf16 render: {launches - launches_tc} of {launches} K3 forward launches missed "
          "the tensor-core route")
    check(not np.array_equal(images["shift_scale_layer2"], images["plain"]),
          "the shift/scale edit left the image unchanged")

    t0 = time.perf_counter()
    plain_color, *_ = render_pose_host(model, scene, K, c2w, [1.0, 1.0, 1.0], near_far,
                                       requests[0][2], h, w, chunk=chunk,
                                       tile_cols=tile_cols, plain=True)
    plain_s = time.perf_counter() - t0
    db = psnr(images["plain"], plain_color)
    check(db >= 40.0, f"view-pose kernel pose vs plain pose {db:.1f} dB < 40")
    summary = {"h": h, "w": w, "chunk": chunk, "kernel_s_per_pose": seconds,
               "plain_s_per_pose": plain_s, "kernel_vs_plain_db": db, "launches": launches,
               "launches_tc": launches_tc, "launches_k6": k6}
    print("view_pose_render", json.dumps(summary), flush=True)
    return summary


def wide_kernel_times(device, m: int, reps: int) -> dict:
    """The wide slice's performer (WIDE_WIDTHS) through each forward route
    at ``m`` samples, every sample run: K1 (bf16 render and ``checked``,
    float32) on seeded positions, frame ids and directions, K3's forward
    (bf16, float32) on seeded encodings of the view-deform variant's
    performer; each route's sample block, ms, plain ms, bound (operations
    at the dtype's peak, or bytes) and share. -> {route: row}."""
    import torch

    from stnerf_tpu_torch.kernels import spacenet_vjp
    from stnerf_tpu_torch.kernels.fused_field import (float32_ring, fused_field,
                                                      fused_field_reference, tc_launch)
    from stnerf_tpu_torch.ops.encoding import positional_encoding_planar

    rng = np.random.default_rng(SEED + 8)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device).contiguous()

    xyz = t(rng.uniform(-3.0, 3.0, (3, m)))
    ids = t(rng.integers(1, 101, (1, m)) + rng.choice([0.0, 0.25, 0.5], (1, m)))
    d = rng.normal(size=(3, m))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dir_enc = positional_encoding_planar(t(d), 4, True, recursive=True).contiguous()
    net = widths_model(taekwondo_cfg(), WIDE_WIDTHS, device)
    vp_net = widths_model(view_pose_cfg(), WIDE_WIDTHS, device, camera_num=8).layers_fine[0]
    x = _encoded_inputs(device, m, SEED + 9)
    enc = (x["pos"], x["dir"], x["time"])
    out = {}
    for dt in ("float32", "bfloat16"):
        f = pack_dtype(net.layers_fine[0], net.motion[0], "lerp", dt)
        g = pack_dtype(vp_net, None, None, dt)
        w_bytes = f.weights.element_size() * f.weights.numel()
        k1 = {"ms": lambda: fused_field(f, xyz, ids, dir_enc),
              "plain": lambda: fused_field_reference(f, xyz, ids, dir_enc),
              "block": (float32_ring(f, m, dir_enc.shape[0]) if dt == "float32"
                        else tc_launch(f, m, dir_enc.shape[0]))["block_samples"],
              "macs": field_macs(f)["fwd"],
              "bytes": 4 * m * (4 + dir_enc.shape[0] + 4) + w_bytes}
        k3 = {"ms": lambda: spacenet_vjp.spacenet_fwd(g, *enc),
              "plain": lambda: spacenet_vjp.spacenet_fwd_reference(g, *enc),
              "block": (spacenet_vjp.float32_ring if dt == "float32"
                        else spacenet_vjp.tc_launch)(g, *enc)["block_samples"],
              "macs": field_macs(g)["fwd"],
              "bytes": 4 * m * (sum(e.shape[0] for e in enc) + 4)
              + g.weights.element_size() * g.weights.numel()}
        routes = {f"fused_field_{dt}": k1, f"spacenet_fwd_{dt}": k3}
        if dt == "bfloat16":
            routes["fused_field_bfloat16_checked"] = {
                **k1, "ms": lambda: fused_field(f, xyz, ids, dir_enc, checked=True),
                "block": tc_launch(f, m, dir_enc.shape[0], True)["block_samples"]}
        for name, r in routes.items():
            b_ms, b_by = bound_ms(2 * r["macs"] * m, r["bytes"], dt)
            ms = cuda_ms(r["ms"], reps)
            out[name] = {"m": m, "widths": list(WIDE_WIDTHS), "block_samples": r["block"],
                         "ms": ms, "plain_ms": cuda_ms(r["plain"], reps), "bound_ms": b_ms,
                         "bound_by": b_by, "share": b_ms / ms}
        if dt == "bfloat16":  # the training forwards' taps: the k-order rounding
            for name, kind, f_k, a in (
                    ("fused_field_bfloat16_checked", "fused_field", f, (xyz, ids, dir_enc, None)),
                    ("spacenet_fwd_bfloat16", "spacenet_fwd", g, enc)):
                out[name]["taps_not_k_order"] = fwd_taps_check(kind, f_k, a)
                check_records(f"wide {name}", out[name]["taps_not_k_order"], "bf16 forward taps")
    return out


def phase_wide_slice(device, h: int, w: int, chunk: int, tile_cols: int, card: str) -> dict:
    """The taekwondo model at trunk 512, head 256, motion 256 (WIDE_WIDTHS,
    set on configs/config_taekwondo.yml through merge_from_list), rendered
    at h x w through
    render_pose_host: phase 3's five edit requests in bf16 (every field on
    K1's tensor-core kernel), the first in float32 (K1's CUDA-core kernel),
    and phase 7's three requests of its view-deform + pose-refinement
    variant (every field on K3's forward, bf16). Checks: finite images, the
    edits change them, the hidden layer's image zero, launches as the
    renders imply, each route's kernel path >= 40 dB from the plain path on
    the first request at (h / 2) x (w / 2); prints each field's sample block
    per route. Then the
    wide kernels' times at M = 240,000 on the performer (``wide_kernel_times``).
    -> summary."""
    import torch

    from stnerf_tpu_torch.kernels import spacenet_vjp
    from stnerf_tpu_torch.kernels.fused_field import float32_ring, fused_field, tc_launch
    from stnerf_tpu_torch.render.pose_device import render_pose_host, tile_grid

    t_phase = time.perf_counter()
    scene, requests = scene_and_requests(device)
    K = np.array([[w, 0, w / 2], [0, h, h / 2], [0, 0, 1]], np.float32)
    K_half = np.diag([0.5, 0.5, 1.0]).astype(np.float32) @ K
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, -5.0]
    near_far = np.array([0.5, 12.0], np.float32)
    chunks = tile_grid(h, w, chunk, tile_cols)[4] // chunk
    cfg32 = taekwondo_cfg()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    vp_cfg = view_pose_cfg()
    models = {"bfloat16": widths_model(taekwondo_cfg(), WIDE_WIDTHS, device),
              "float32": widths_model(cfg32, WIDE_WIDTHS, device),
              "view_pose": widths_model(vp_cfg, WIDE_WIDTHS, device, camera_num=8)}
    with torch.no_grad():  # novel views take camera 0's correction, as phase 7's
        models["view_pose"].cam_pose.rvec[0] = torch.tensor([0.01, -0.02, 0.015, 1.0])
        models["view_pose"].cam_pose.tvec[0] = torch.tensor([0.02, -0.01, 0.03])
    runs = {"bfloat16": requests, "float32": requests[:1], "view_pose": requests[:3]}
    out = {"widths": list(WIDE_WIDTHS), "h": h, "w": w, "chunk": chunk, "card": card}

    # each field's sample block per route (every launch of the field takes it)
    m = chunk * 8
    zeros = {k: torch.zeros((r, m), device=device) for k, r in (("pos", 63), ("dir", 27),
                                                                 ("time", 21), ("xyz", 3),
                                                                 ("ids", 1))}
    blocks = {}
    for key, model in models.items():
        for name, net, mnet, mode in (("performer", model.layers_fine[0], model.motion[0],
                                       "lerp"), ("background", model.bkgd_fine, None, None)):
            if key == "view_pose":
                f = pack_dtype(net, None, None, "bfloat16")
                blocks[f"{key}_{name}"] = spacenet_vjp.tc_launch(
                    f, zeros["pos"], zeros["dir"],
                    zeros["time"] if net.spec.use_time else None)["block_samples"]
            else:
                f = pack_dtype(net, mnet, mode, key)
                launch = float32_ring(f, m, 27) if key == "float32" else tc_launch(f, m, 27)
                blocks[f"{key}_{name}"] = launch["block_samples"]
    out["block_samples"] = blocks
    check(blocks == {"bfloat16_performer": 64, "bfloat16_background": 64,
                     "float32_performer": 32, "float32_background": 32,
                     "view_pose_performer": 64, "view_pose_background": 64},
          f"wide slice: unexpected sample blocks {blocks}")

    for key, model in models.items():
        spec = model.spec
        lp1 = spec.layer_num + 1
        fused_field.launches = fused_field.launches_tc = 0
        spacenet_vjp.spacenet_fwd.launches = spacenet_vjp.spacenet_fwd.launches_tc = 0
        zero_k6()
        images, seconds = {}, {}
        for name, fids, edits in runs[key]:
            t0 = time.perf_counter()
            color, depth, c_layers, _ = render_pose_host(model, scene, K, c2w, fids, near_far,
                                                         edits, h, w, chunk=chunk,
                                                         tile_cols=tile_cols)
            seconds[name] = time.perf_counter() - t0
            check(color.shape == (h, w, 3) and np.isfinite(color).all()
                  and np.isfinite(depth).all(), f"wide {key} {name}: shape or non-finite")
            if name == "hide_layer1":
                check(not c_layers[1].any(), f"wide {key}: hidden layer 1 has a nonzero image")
            images[name] = color
        expected = len(runs[key]) * chunks * 2 * lp1
        counts = {"fused_field": fused_field.launches, "fused_field_tc": fused_field.launches_tc,
                  "spacenet_fwd": spacenet_vjp.spacenet_fwd.launches,
                  "spacenet_fwd_tc": spacenet_vjp.spacenet_fwd.launches_tc, **read_k6()}
        want = {"bfloat16": (expected, expected, 0, 0), "float32": (expected, 0, 0, 0),
                "view_pose": (0, 0, expected, expected)}[key]
        check(tuple(counts[k] for k in ("fused_field", "fused_field_tc", "spacenet_fwd",
                                        "spacenet_fwd_tc")) == want,
              f"wide {key}: launches {counts}, the renders imply {want}")
        for name in images:
            check(name == "plain" or not np.array_equal(images[name], images["plain"]),
                  f"wide {key} {name}: the edit left the image unchanged")
        # kernel vs plain on the first request at half the size in each
        # direction (the plain path at these widths takes 12-18 s a pose)
        colors, half_s = [], []
        for plain in (False, True):
            t0 = time.perf_counter()
            colors.append(render_pose_host(model, scene, K_half, c2w, [1.0, 1.0, 1.0],
                                           near_far, requests[0][2], h // 2, w // 2,
                                           chunk=chunk, tile_cols=tile_cols,
                                           plain=plain)[0])
            half_s.append(time.perf_counter() - t0)
        db = psnr(*colors)
        check(db >= 40.0, f"wide {key}: kernel pose vs plain pose {db:.1f} dB < 40")
        out[key] = {"kernel_s_per_pose": seconds, "half_size_kernel_plain_s": half_s,
                    "kernel_vs_plain_db": db, "launches": counts}
        print("wide_slice_render", json.dumps({"route": key, **out[key]}), flush=True)
    out["render_s"] = time.perf_counter() - t_phase
    out["kernels"] = wide_kernel_times(device, 240_000, 3)
    for name, row in out["kernels"].items():
        print("wide_kernels", json.dumps({"route": name, **row, "card": card}), flush=True)
    out["s"] = time.perf_counter() - t_phase
    print("wide_slice", json.dumps({k: v for k, v in out.items()
                                    if k not in ("bfloat16", "float32", "view_pose",
                                                 "kernels")}), flush=True)
    return out


def phase_view_pose_train(device, bundle, scene) -> dict:
    """do_train of the view-deform + pose-refinement model on phase 5's
    pool (one coarse-only epoch, one full epoch), its checks, then the
    kernel vs plain step comparison in float32 and bf16 -> summary dict."""
    import torch

    from stnerf_tpu_torch.engine import do_train, make_optimizer, pool_camera_num
    from stnerf_tpu_torch.kernels.field_vjp import field_bwd
    from stnerf_tpu_torch.kernels.fused_field import fused_field
    from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_bwd, spacenet_fwd
    from stnerf_tpu_torch.models import LayeredSpec

    cfg = view_pose_cfg()
    s = cfg.SOLVER
    s.COARSE_STAGE, s.MAX_EPOCHS, s.WARMUP_ITERS, s.LOG_PERIOD = 2, 3, 1, 5
    cfg.OUTPUT_DIR = os.path.join(REPO, "build", "chip_smoke_view_pose")
    spec = LayeredSpec.from_cfg(cfg)
    spec = dataclasses.replace(spec, camera_num=pool_camera_num(bundle, spec))
    model = make_model(spec, device)
    opt, sched = make_optimizer(cfg, model)
    records = []
    logger = logging.getLogger("chip_smoke.view_pose_train")
    logger.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.emit = lambda r: (records.append(r),
                              print("view_pose_train", r.getMessage(), flush=True))
    logger.addHandler(handler)

    for k in (spacenet_fwd, spacenet_bwd):
        k.launches = k.launches_tc = 0
    fused_field.launches = field_bwd.launches = 0
    zero_k6()
    history = do_train(cfg, model, scene, bundle, opt, sched, logger=logger, seed=SEED,
                       device=device)
    fwd, bwd, k6 = spacenet_fwd.launches, spacenet_bwd.launches, read_k6()
    fwd_tc, bwd_tc = spacenet_fwd.launches_tc, spacenet_bwd.launches_tc
    check(fwd_tc == fwd and bwd_tc == bwd,
          f"bf16 training: K3 launches {fwd} / {bwd}, on the tensor-core route {fwd_tc} / "
          f"{bwd_tc}")
    check(fused_field.launches == 0 and field_bwd.launches == 0,
          "the staged path launched the fused field kernels")
    steps = len(bundle["labels"]) // s.IMS_PER_BATCH
    lp1 = spec.layer_num + 1
    expected = sum(steps * (1 if epoch < s.COARSE_STAGE else 2) * lp1 for epoch, _ in history)
    check([e for e, _ in history] == [1, 2], f"epochs run: {[e for e, _ in history]}")
    check(fwd == expected and bwd == expected,
          f"spacenet_fwd / spacenet_bwd launched {fwd} / {bwd} times in training, the "
          f"steps imply {expected}")
    for epoch, m in history:
        check(bool(np.isfinite(m.loss).all()), f"epoch {epoch}: non-finite loss")
    full = history[-1][1].loss
    check(full[-1] < full[0], f"epoch 2 loss did not fall: {full[0]:.4g} -> {full[-1]:.4g}")
    # the last step's gradients stay in .grad
    grad_max = {name: max(float(p.grad.abs().max()) for p in getattr(model, name).parameters())
                for name in ("cam_pose", "view_deform")}
    for name, g in grad_max.items():
        check(g > 0 and np.isfinite(g), f"{name}: gradient max |g| = {g}")
    epoch_s = {r.args[0]: r.args[1] for r in records if r.msg.startswith("Epoch %d done")}
    summary = {"steps_per_epoch": steps, "launches_fwd": fwd, "launches_bwd": bwd,
               "launches_fwd_tc": fwd_tc, "launches_bwd_tc": bwd_tc,
               "launches_k6": k6, "camera_num": spec.camera_num,
               "loss_epoch2_first_last": [float(full[0]), float(full[-1])],
               "grad_max": grad_max,
               "s_per_step": {e: t / steps for e, t in epoch_s.items()},
               "rays_per_s": {e: steps * s.IMS_PER_BATCH / t for e, t in epoch_s.items()}}
    print("view_pose_train", json.dumps(summary), flush=True)
    row32, plain32 = compare_train_step(device, bundle, scene, "float32", view_pose_cfg)
    row16, _ = compare_train_step(device, bundle, scene, "bfloat16", view_pose_cfg, plain32)
    summary["steps"] = [row16, row32]
    return summary


def wide_cfg(cfg_fn=None):
    """``cfg_fn()`` (default taekwondo_cfg) at the wide slice's widths
    (WIDE_WIDTHS), set through merge_from_list."""
    cfg = (cfg_fn or taekwondo_cfg)()
    cfg.merge_from_list(["MODEL.BACKBONE_DIM", WIDE_WIDTHS[0], "MODEL.HEAD_DIM",
                         WIDE_WIDTHS[1], "MODEL.MOTION_DIM", WIDE_WIDTHS[2]])
    return cfg


def wide_bwd_times(device, m: int, reps: int) -> dict:
    """The wide slice's performer (WIDE_WIDTHS) through each backward route
    at ``m`` samples, every sample run: K2 (bf16, float32) on seeded
    positions, frame ids, directions and cotangents, K3's backward (bf16,
    float32) on seeded encodings and cotangents of the view-deform
    variant's performer; each route's sample block, ms, plain ms, bound
    (operations at the dtype's peak, or bytes) and share; the float32
    routes' bound for the operations as they do them and their workspace.
    -> {route: row}."""
    import torch

    from stnerf_tpu_torch.kernels import f32_bwd, spacenet_vjp
    from stnerf_tpu_torch.kernels.field_vjp import (field_bwd, field_bwd_reference,
                                                    tc_bwd_launch)
    from stnerf_tpu_torch.ops.encoding import positional_encoding_planar

    rng = np.random.default_rng(SEED + 13)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device).contiguous()

    xyz = t(rng.uniform(-3.0, 3.0, (3, m)))
    ids = t(rng.integers(1, 101, (1, m)) + rng.choice([0.0, 0.25, 0.5], (1, m)))
    d = rng.normal(size=(3, m))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dir_enc = positional_encoding_planar(t(d), 4, True, recursive=True).contiguous()
    cot = (t(rng.normal(size=(3, m))), t(rng.normal(size=m)))
    net = widths_model(taekwondo_cfg(), WIDE_WIDTHS, device)
    vp_net = widths_model(view_pose_cfg(), WIDE_WIDTHS, device, camera_num=8).layers_fine[0]
    x = _encoded_inputs(device, m, SEED + 14)
    enc = (x["pos"], x["dir"], x["time"])
    out = {}
    for dt in ("float32", "bfloat16"):
        f = pack_dtype(net.layers_fine[0], net.motion[0], "lerp", dt)
        g = pack_dtype(vp_net, None, None, dt)
        k2 = (f, xyz, ids, dir_enc, *cot)
        k3 = (g, *enc, x["d_rgb"], x["d_sigma"])
        if dt == "float32":
            plans = [f32_bwd.make_plan(h, m, f32_bwd.sm_count(device),
                                       f32_bwd.smem_optin(device)) for h in (f, g)]
            blocks = [p.block for p in plans]
        else:
            blocks = [tc_bwd_launch(f, m, dir_enc.shape[0])["block_samples"],
                      spacenet_vjp.tc_bwd_launch(g, *enc)["block_samples"]]
        routes = {
            f"field_bwd_{dt}": (lambda: field_bwd(*k2), lambda: field_bwd_reference(*k2),
                                f, blocks[0], 4 * m * (4 + dir_enc.shape[0] + 4 + 3
                                                       + dir_enc.shape[0])),
            f"spacenet_bwd_{dt}": (lambda: spacenet_vjp.spacenet_bwd(*k3),
                                   lambda: spacenet_vjp.spacenet_bwd_reference(*k3),
                                   g, blocks[1],
                                   4 * m * (sum(e.shape[0] for e in enc) + 4
                                            + enc[0].shape[0] + enc[1].shape[0]))}
        for i, (name, (fn, plain, h, block, io_bytes)) in enumerate(routes.items()):
            nbytes = (io_bytes + h.weights.element_size() * h.weights.numel()
                      + 4 * (h.weights.numel() + h.biases.numel()))
            macs = field_macs(h)
            b_ms, b_by = bound_ms(2 * macs["bwd"] * m, nbytes, dt)
            ms = cuda_ms(fn, reps)
            row = {"m": m, "widths": list(WIDE_WIDTHS), "block_samples": block, "ms": ms,
                   "plain_ms": cuda_ms(plain, reps), "bound_ms": b_ms, "bound_by": b_by,
                   "share": b_ms / ms}
            if dt == "float32":
                row["route_bound_ms"], _ = f32_bwd_bound_ms(macs, m, nbytes)
                row["workspace_bytes"] = plans[i].workspace_bytes
            out[name] = row
    return out


def phase_wide_train(device, bundle, scene, card: str) -> dict:
    """The wide slice in training (phase 8b): the taekwondo model at
    WIDE_WIDTHS (wide_cfg) through do_train on phase 5's pool as phase 5
    does (one coarse-only epoch, one full epoch, bf16): finite losses, a
    falling loss over the full epoch, K1 (``checked``) and K2 launched once
    per field and stage of every step, all on the tensor-core route, and
    no plain field evaluation; then one step through the kernels and one
    through the plain versions in float32 and in bf16 (phase 5's bars), and
    one of the view-deform variant (K3's forward and backward) in float32
    and in bf16 (phase 8's bars), every step also against the plain step on
    a reordered copy of the model (``compare_train_step``'s ``order``: at
    these widths two plain orders alone take some leaves past the fixed
    bars); then the backward routes' times at M = 240,000
    (``wide_bwd_times``) and the phase's seconds. -> summary."""
    import torch

    from stnerf_tpu_torch.engine import do_train, make_optimizer
    from stnerf_tpu_torch.kernels import field_vjp
    from stnerf_tpu_torch.kernels.field_vjp import field_bwd
    from stnerf_tpu_torch.kernels.fused_field import fused_field
    from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_bwd, spacenet_fwd
    from stnerf_tpu_torch.models import LayeredSpec

    t_phase = time.perf_counter()
    cfg = wide_cfg()
    s = cfg.SOLVER
    s.COARSE_STAGE, s.MAX_EPOCHS, s.WARMUP_ITERS, s.LOG_PERIOD = 2, 3, 1, 5
    cfg.OUTPUT_DIR = os.path.join(REPO, "build", "chip_smoke_wide_train")
    spec = LayeredSpec.from_cfg(cfg)
    model = make_model(spec, device)
    opt, sched = make_optimizer(cfg, model)
    records = []
    logger = logging.getLogger("chip_smoke.wide_train")
    logger.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.emit = lambda r: (records.append(r), print("wide_train", r.getMessage(), flush=True))
    logger.addHandler(handler)

    counted = (fused_field, field_bwd, spacenet_fwd, spacenet_bwd)
    for k in counted:
        k.launches = k.launches_tc = 0
    zero_k6()
    names = ["fused_field_reference", "field_bwd_reference"]
    saved = {name: getattr(field_vjp, name) for name in names}
    plain = count_calls(field_vjp, names)
    try:
        history = do_train(cfg, model, scene, bundle, opt, sched, logger=logger, seed=SEED,
                           device=device)
    finally:
        for name, fn in saved.items():
            setattr(field_vjp, name, fn)
    launches = {f"{k.__name__}{route}": n for k in counted
                for route, n in (("_tc", k.launches_tc), ("", k.launches))}
    launches.update(read_k6())
    steps = len(bundle["labels"]) // s.IMS_PER_BATCH
    lp1 = spec.layer_num + 1
    expected = sum(steps * (1 if epoch < s.COARSE_STAGE else 2) * lp1 for epoch, _ in history)
    check([e for e, _ in history] == [1, 2], f"wide: epochs run: {[e for e, _ in history]}")
    check(all(launches[k] == expected for k in ("fused_field", "fused_field_tc", "field_bwd",
                                                "field_bwd_tc")),
          f"wide training launched {launches}, the steps imply {expected} of K1 and K2, all "
          "on the tensor-core route")
    check(not any(plain.values()), f"wide training evaluated a field plainly: {plain}")
    for epoch, m in history:
        check(bool(np.isfinite(m.loss).all()), f"wide: epoch {epoch}: non-finite loss")
    full = history[-1][1].loss
    check(full[-1] < full[0], f"wide: epoch 2 loss did not fall: {full[0]:.4g} -> "
                              f"{full[-1]:.4g}")
    epoch_s = {r.args[0]: r.args[1] for r in records if r.msg.startswith("Epoch %d done")}
    out = {"widths": list(WIDE_WIDTHS), "card": card, "steps_per_epoch": steps,
           "launches": launches, "plain_field_calls": plain,
           "loss_epoch2_first_last": [float(full[0]), float(full[-1])],
           "s_per_step": {e: t / steps for e, t in epoch_s.items()},
           "rays_per_s": {e: steps * s.IMS_PER_BATCH / t for e, t in epoch_s.items()}}
    out["train_s"] = time.perf_counter() - t_phase
    print("wide_train", json.dumps(out), flush=True)

    def vp_cfg():
        return wide_cfg(view_pose_cfg)

    out["steps"] = [compare_train_step(device, bundle, scene, dt, wide_cfg, order=True,
                                       records=dt == "bfloat16")[0]
                    for dt in ("bfloat16", "float32")]
    row32, plain32 = compare_train_step(device, bundle, scene, "float32", vp_cfg, order=True)
    row16, _ = compare_train_step(device, bundle, scene, "bfloat16", vp_cfg, plain32,
                                  order=True, records=True)
    out["view_pose_steps"] = [row16, row32]
    out["kernels"] = wide_bwd_times(device, 240_000, 3)
    for name, row in out["kernels"].items():
        print("wide_bwd_kernels", json.dumps({"route": name, **row, "card": card}), flush=True)
    out["s"] = time.perf_counter() - t_phase
    print(f"phase wide_train: {out['s']:.1f} s", flush=True)
    return out


def cross_inputs(device, L: int, N: int, S: int, seed: int, hard: bool = False,
                 unsorted: bool = False, special: bool = False) -> dict:
    """Seeded (L, N, S) inputs of K4/K5: ascending depths per stream, log
    factors as a compositor makes them (log of 1 - alpha + 1e-10, floored at
    1e-10) and cotangents. ``hard`` adds exact cross-layer ties (depths of
    rays 0-4 copied from stream 0 into every third sample of the others
    before each stream is sorted), saturated factors (log 1e-10) and one
    ray (7) whose streams all park at one depth; the streams stay sorted.
    ``special`` puts -inf, -3.4028235e38, the smallest denormals, -0, +0,
    3.4028235e38 and +inf into the streams of rays 12-17 before the sort.
    ``unsorted`` then shuffles one stream of rays 2, 11 and 23 and puts a
    NaN in ray 30. -> tensors, and ``pairwise``: the rays with a stream that
    is not non-decreasing or holds a NaN, counted in NumPy."""
    import torch

    rng = np.random.default_rng(seed)
    t = rng.uniform(0.5, 16.0, (L, N, S)).astype(np.float32)
    alpha = rng.uniform(0.0, 1.0, (L, N, S)) ** 4
    logf = np.log(np.maximum(1.0 - alpha + 1e-10, 1e-10)).astype(np.float32)
    if hard:
        for b in range(1, L):
            t[b, :5, b % S::3] = t[0, :5, :len(range(b % S, S, 3))]
        logf[0, :3, S // 2] = np.log(np.float32(1e-10))
    if special:
        edge = np.array([-np.inf, -3.4028235e38, -1e-45, -0.0, 0.0, 1e-45, 3.4028235e38,
                         np.inf], np.float32)
        for n in range(12, 18):
            t[:, n, :len(edge)] = np.roll(edge, n)[:S]
    t = np.sort(t, -1)
    if hard and N > 7:
        t[:, 7] = 4.0
    if unsorted:
        for n in (2, 11, 23):
            t[n % L, n] = rng.permutation(t[n % L, n])
        t[min(1, L - 1), 30, S // 3] = np.nan
    g = rng.normal(size=(L, N, S)).astype(np.float32)
    bad = ~(np.diff(t, axis=-1) >= 0).all(-1) | np.isnan(t).any(-1)
    return {**{k: torch.tensor(v, device=device) for k, v in
               (("t", t), ("logf", logf), ("g", g))},
            "pairwise": int(bad.any(0).sum())}


def cross_bound_ms(L: int, N: int, S: int, pairwise: int, n_io: int, scan: bool) -> tuple:
    """K4's or K5's bound for these inputs: each of ``n_io`` (L, N, S)
    float32 operands and outputs moved once; the operations the data
    needs: per sorted ray L(L-1) S binary searches of ceil(log2(S+1))
    compares and one min or add each, and for K5 L S scan adds; per
    all-pairs ray (an unsorted or NaN stream) a compare and a min or add
    for each of its (L-1) L S^2 sample pairs."""
    searches = L * (L - 1) * S * (int(np.ceil(np.log2(S + 1))) + 1) + (L * S if scan else 0)
    ops = (N - pairwise) * searches + pairwise * 2.0 * L * (L - 1) * S * S
    return bound_ms(ops, 4.0 * n_io * L * N * S, "float32")


def same_values(a, b) -> bool:
    """Equal, NaN in the same places (``torch.equal`` fails on NaN)."""
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def same_bits(a, b) -> bool:
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def max_abs(x) -> float:
    return float(x.abs().max()) if x.numel() else 0.0


def phase_cross_vs_plain(device, reps: int) -> list:
    """K4 and K5 (forward and backward) against their plain versions at the
    training shapes (3, 2000, 120) and (3, 2000, 90), a ragged (3, 37, 24)
    with ties, saturated factors and parked depths, the same with a few
    streams shuffled and a NaN depth (the kernels' all-pairs route), the
    same sorted with infinities, signed zeros and denormals, and the edges
    S = 1, L = 1, N = 0, L = 5 at an S that is no multiple of 4 and
    S = 512: K4 equal to plain, NaN in the same places; K5 float32
    within rtol 1e-5, atol 1e-6 max|plain| wherever the plain form is
    finite (sums of 10^2-10^3 terms in another order), and bitwise the same
    when run twice; every wrapper's ``pairwise_rays`` equal to the rays
    with an unsorted or NaN stream (0 on sorted streams). -> per-case rows
    with kernel and plain ms, the bound for these inputs
    (``cross_bound_ms``) and the share of it."""
    import torch

    from stnerf_tpu_torch.kernels import cross_trans as ct

    wrappers = (ct.cross_successor, ct.cross_log_transmittance_fwd,
                ct.cross_log_transmittance_bwd)
    rows = []
    for L, N, S, hard, unsorted, special in (
            (3, 2000, 120, False, False, False), (3, 2000, 90, False, False, False),
            (3, 37, 24, True, False, False), (3, 37, 24, True, False, True),
            (3, 37, 24, True, True, False), (3, 50, 1, True, False, False),
            (1, 50, 24, True, False, False), (3, 0, 24, True, False, False),
            (5, 257, 45, True, False, False), (3, 64, 512, True, False, False)):
        x = cross_inputs(device, L, N, S, SEED + 7 + S, hard, unsorted, special)
        t, logf, g = x["t"], x["logf"], x["g"]
        name = f"{L}x{N}x{S}" + ("_ties_saturated_parked" if hard else "") + \
            ("_infinities_zeros_denormals" if special else "") + \
            ("_unsorted_nan" if unsorted else "")
        for w in wrappers:
            w.pairwise_rays.clear()
        succ, succ_p = ct.cross_successor(t), ct.cross_successor_reference(t)
        fwd, fwd_p = ct.cross_log_transmittance_fwd(t, logf), \
            ct.cross_log_transmittance_reference(t, logf)
        bwd, bwd_p = ct.cross_log_transmittance_bwd(t, g), \
            ct.cross_log_transmittance_bwd_reference(t, g)
        pairwise = {w.__name__: ct.read_pairwise_rays(w) for w in wrappers}
        again = (ct.cross_log_transmittance_fwd(t, logf), ct.cross_log_transmittance_bwd(t, g))
        sync(device)
        check(all(v == x["pairwise"] for v in pairwise.values()),
              f"{name}: all-pairs rays {pairwise}, the inputs have {x['pairwise']}")
        check(same_values(succ, succ_p), f"K4 {name}: not equal to plain")
        ok = ~succ_p.isnan()  # equal infinities count as no error
        row = {"case": name, "pairwise_rays": x["pairwise"],
               "succ_max_abs_err": max_abs(torch.where(succ == succ_p, 0.0, succ - succ_p)[ok]),
               "succ_nan": int((~ok).sum())}
        for key, got, ref, twice in (("fwd", fwd, fwd_p, again[0]), ("bwd", bwd, bwd_p, again[1])):
            fin = ref.isfinite()
            got_f, ref_f = got[fin], ref[fin]
            check(bool(got_f.isfinite().all()), f"K5 {key} {name}: non-finite where plain is not")
            err, scale = max_abs(got_f - ref_f), max_abs(ref_f)
            check(bool((got_f - ref_f).abs().le(1e-5 * ref_f.abs() + 1e-6 * scale).all()),
                  f"K5 {key} {name}: max |err| {err:.3g} outside rtol 1e-5, atol "
                  f"1e-6 x {scale:.3g}")
            check(same_bits(got, twice), f"K5 {key} {name}: not bitwise equal run to run")
            row[f"{key}_max_abs_err"], row[f"{key}_max_abs_plain"] = err, scale
        for key, fn, plain, n_io, scan in (
                ("succ", lambda: ct.cross_successor(t),
                 lambda: ct.cross_successor_reference(t), 2, False),
                ("fwd", lambda: ct.cross_log_transmittance_fwd(t, logf),
                 lambda: ct.cross_log_transmittance_reference(t, logf), 3, True),
                ("bwd", lambda: ct.cross_log_transmittance_bwd(t, g),
                 lambda: ct.cross_log_transmittance_bwd_reference(t, g), 3, True)):
            # the kernel's device time; beside it a call's from the host
            # (the wrapper's Python and launch), which bounds it at these sizes
            row[f"{key}_ms"] = graph_ms(fn, 50) if N else cuda_ms(fn, reps)
            row[f"{key}_call_ms"] = cuda_ms(fn, reps)
            row[f"{key}_plain_ms"] = cuda_ms(plain, reps)
            row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = cross_bound_ms(
                L, N, S, x["pairwise"], n_io, scan)
            row[f"{key}_share"] = row[f"{key}_bound_ms"] / row[f"{key}_ms"]
        print("cross_vs_plain", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def composite_inputs(device, L: int, N: int, S: int, seed: int) -> dict:
    """Seeded compositor inputs at a training shape: interleaved ascending
    depths per layer (layer l's s-th sample in its own part of the s-th of S
    bins over [0.5, 16], so no two layers tie and the sorted merge's order
    is unique), raw rgb and raw sigma (a third of it negative, i.e.
    empty)."""
    import torch

    rng = np.random.default_rng(seed)
    u = rng.uniform(0.05, 0.95, (L, N, S))
    t = 0.5 + 15.5 * (np.arange(S) + (np.arange(L)[:, None, None] + u) / L) / S
    t = t.astype(np.float32)
    return {"t": torch.tensor(t, device=device),
            "rgb": torch.tensor(rng.normal(size=(L, 3, N, S)).astype(np.float32),
                                device=device),
            "sigma": torch.tensor(rng.normal(0.3, 1.0, (L, N, S)).astype(np.float32),
                                  device=device)}


def phase_compositor(device, reps: int) -> dict:
    """The sort-free compositor on the card at (3, 2000, 120), float32:
    ``composite_merged_nosort(kernel=True)`` against ``kernel=False`` at the
    JAX package's bars (tests/test_ops.py:526-535: values rtol 1e-5, atol
    1e-6; rgb gradients rtol 1e-4, atol 1e-6; sigma gradients rtol 1e-4,
    atol 1e-5), and against the sorted merge (``merge_layers_planar`` +
    ``volume_render_planar``) at phase 4's float32 bar; forward + backward
    ms of the three forms."""
    import torch

    from stnerf_tpu_torch.ops.volume import (composite_merged_nosort, merge_layers_planar,
                                             volume_render_planar)

    x = composite_inputs(device, 3, 2000, 120, SEED + 8)
    forms = {"nosort_kernel": lambda r, s: composite_merged_nosort(x["t"], r, s, kernel=True),
             "nosort_cube": lambda r, s: composite_merged_nosort(x["t"], r, s, kernel=False),
             "sorted_merge": lambda r, s: volume_render_planar(
                 *merge_layers_planar(x["t"], r, s))}

    def run(form, with_weights=True):
        rgb = x["rgb"].clone().requires_grad_(True)
        sigma = x["sigma"].clone().requires_grad_(True)
        out = forms[form](rgb, sigma)
        # tests/test_ops.py's scalar; the sorted merge's weights come in
        # sorted order, so against it they stay out
        loss = (out.color ** 2).sum() + out.acc.sum() + out.depth.sum()
        if with_weights:
            loss = loss + (out.weights ** 2).sum()
        return out, torch.autograd.grad(loss, (rgb, sigma))

    res = {form: run(form, form != "sorted_merge") for form in forms}
    sync(device)
    (ker, (gr_k, gs_k)), (cube, (gr_c, gs_c)) = res["nosort_kernel"], res["nosort_cube"]
    row = {"shape": [3, 2000, 120]}
    for name in ("color", "depth", "acc", "weights"):
        a, b = getattr(ker, name).detach(), getattr(cube, name).detach()
        check(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
              f"nosort kernel vs cube {name}: max |err| {float((a - b).abs().max()):.3g}")
    check(bool(torch.isfinite(gs_k).all()), "nosort kernel: non-finite sigma gradient")
    check(torch.allclose(gr_k, gr_c, rtol=1e-4, atol=1e-6)
          and torch.allclose(gs_k, gs_c, rtol=1e-4, atol=1e-5),
          "nosort kernel vs cube gradients outside rtol 1e-4, atol 1e-6 / 1e-5")
    row["kernel_vs_cube_max_abs_err"] = max(
        float((getattr(ker, n) - getattr(cube, n)).detach().abs().max())
        for n in ("color", "depth", "acc", "weights"))
    row["kernel_vs_cube_grad_max_abs_err"] = max(float((gr_k - gr_c).abs().max()),
                                                 float((gs_k - gs_c).abs().max()))
    srt, (gr_s, gs_s) = res["sorted_merge"]
    _, (gr_k, gs_k) = run("nosort_kernel", with_weights=False)
    stats = {n: compare_leaf(getattr(ker, n), getattr(srt, n))
             for n in ("color", "depth", "acc")}
    stats.update({"d_rgb": compare_leaf(gr_k, gr_s), "d_sigma": compare_leaf(gs_k, gs_s)})
    bad = {k: v for k, v in stats.items() if not f32_close(v)}
    check(not bad, f"nosort kernel vs sorted merge beyond the float32 bar: {bad}")
    row["nosort_vs_sorted_max_rel_l2"] = max(v["rel"] for v in stats.values())
    for form in forms:
        row[f"{form}_fwd_bwd_ms"] = cuda_ms(lambda: run(form), reps)
    print("compositor", json.dumps(row), flush=True)
    return row


def count_calls(module, names: list) -> dict:
    """Replace module.<name> by a wrapper that counts its calls -> the
    counts, by name (the callers look the functions up at call time)."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)

        setattr(module, name, counted)
    return counts


def read_event_dir(log_dir: str) -> list:
    """The records of every event file under ``log_dir``, oldest first."""
    from stnerf_tpu_torch.utils import read_events

    return [read_events(os.path.join(log_dir, f)) for f in sorted(os.listdir(log_dir))]


def entry_point_cfg_file(scene_root: str, output_dir: str,
                         name: str = "chip_smoke_train.yml") -> str:
    """configs/config_synthetic.yml's keys with the entry-point phase's
    overrides, written to build/``name`` -> its path."""
    import yaml

    with open(os.path.join(REPO, "configs", "config_synthetic.yml")) as f:
        raw = yaml.safe_load(f)
    raw["DATASETS"].update(TRAIN=scene_root, MAX_POOL_RAYS=40_000)
    raw["MODEL"].update(COARSE_RAY_SAMPLING=90, FINE_RAY_SAMPLING=30)
    raw["SOLVER"].update(COARSE_STAGE=2, MAX_EPOCHS=4, CHECKPOINT_PERIOD=10, VAL_PERIOD=10)
    raw.setdefault("TPU", {})["COMPOSITOR_KERNEL"] = True
    raw["OUTPUT_DIR"] = output_dir
    path = os.path.join(REPO, "build", name)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def compare_compositor_step(device, cfg_file: str, bundle, scene) -> dict:
    """One float32 training step with TPU.COMPOSITOR_KERNEL on (the
    sort-free compositor through K4/K5) and one with it off (the sorted
    merge), from the same weights, batch and sampling noise: every gradient
    leaf at phase 4's float32 bar; seconds per step of a second step of
    each."""
    import torch

    from stnerf_tpu_torch.config import get_cfg
    from stnerf_tpu_torch.engine import (make_decode, make_optimizer, make_train_step,
                                         sort_batch_by_hit, split_compact_bundle)
    from stnerf_tpu_torch.models import LayeredSpec, export_jax_params

    cfg = get_cfg()
    cfg.merge_from_file(cfg_file)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.SOLVER.WARMUP_ITERS = 1
    base = LayeredSpec.from_cfg(cfg)
    pool, tables, width = split_compact_bundle(bundle, device)
    n = cfg.SOLVER.IMS_PER_BATCH
    idx = torch.arange(n, device=device) * (pool.rgb.shape[0] // n)
    batch = make_decode(tables, base, width)(type(pool)(*(x[idx] for x in pool)))
    batch = sort_batch_by_hit(base, scene, batch)
    grads, seconds = {}, {}
    for flag in (True, False):
        model = make_model(dataclasses.replace(base, compositor_kernel=flag), device)
        opt, sched = make_optimizer(cfg, model)
        step = make_train_step(model, opt, sched, remove_outliers=True, device=device)
        m = step(scene, batch, torch.Generator(device=device).manual_seed(SEED), 1.0)
        check(bool(torch.isfinite(m.loss)), f"compositor kernel {flag}: loss not finite")
        grads[flag] = dict(_flat_leaves(export_jax_params(model, grad=True)))
        sync(device)
        t0 = time.perf_counter()
        step(scene, batch, torch.Generator(device=device).manual_seed(SEED + 1), 1.0)
        sync(device)
        seconds[flag] = time.perf_counter() - t0
    stats = {k: compare_leaf(grads[True][k], b) for k, b in grads[False].items()}
    bad = {k: v for k, v in stats.items() if not f32_close(v)}
    check(not bad, f"f32 step: compositor kernels vs sorted merge gradients beyond the "
                   f"float32 bar: {bad}")
    worst = max(stats, key=lambda k: stats[k]["rel"])
    row = {"dtype": "float32", "worst_rel_l2": [worst, stats[worst]["rel"]],
           "entries_outside": {k: v["outside"] for k, v in stats.items() if v["outside"]},
           "nosort_kernel_s_per_step": seconds[True], "sorted_s_per_step": seconds[False],
           "nosort_kernel_rays_per_s": n / seconds[True],
           "sorted_rays_per_s": n / seconds[False]}
    print("train_step_compositor_on_vs_off", json.dumps(row), flush=True)
    return row


def phase_entry_point(device, workers: int = 2) -> dict:
    """The training entry point from a scene on disk with the compositor
    kernels on: a synthetic scene written by the port, then
    ``stnerf_tpu_torch.tools.train.main`` in-process (one coarse-only epoch
    and two full epochs of 20 steps at batch 2000, validation each epoch),
    its checks, a ``--resume`` run of one more epoch, and the compositor
    on/off step comparison -> summary dict."""
    import shutil

    import torch

    from stnerf_tpu_torch.config import get_cfg
    from stnerf_tpu_torch.data import make_synthetic_scene, make_train_data
    from stnerf_tpu_torch.engine import do_train, load_checkpoint, make_optimizer
    from stnerf_tpu_torch.kernels import cross_trans
    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec, layered
    from stnerf_tpu_torch.tools import train

    root = os.path.join(REPO, "build", "chip_smoke_synthetic")
    out_dir = os.path.join(REPO, "build", "chip_smoke_entry")
    for d in (root, out_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_scene(root, width=200, height=150, num_cams=12, num_frames=5,
                         layer_num=2, seed=SEED)
    scene_s = time.perf_counter() - t0
    cfg_file = entry_point_cfg_file(root, out_dir)

    records = []
    logger = logging.getLogger("stnerf_tpu_torch.train")
    logger.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.emit = lambda r: (records.append(r), print("entry", r.getMessage(), flush=True))
    logger.addHandler(handler)   # before main(): its own stdout and file handlers stay off

    # the sorted merge and the compositor's plain versions, counted
    merges = count_calls(layered, ["merge_layers_planar"])
    plain = count_calls(cross_trans, ["cross_successor_reference",
                                      "cross_log_transmittance_reference",
                                      "cross_log_transmittance_bwd_reference"])
    cross = [cross_trans.cross_successor, cross_trans.cross_log_transmittance_fwd,
             cross_trans.cross_log_transmittance_bwd]
    zero_launches()
    for k in cross:
        k.pairwise_rays.clear()
    t0 = time.perf_counter()
    args = ["-c", cfg_file, "--seed", str(SEED), "--workers", str(workers),
            "--device", str(device)]
    history = train.main(args)
    train_s = time.perf_counter() - t0
    launches = read_launches()
    calls = {**merges, **plain}
    # the training streams come sorted: no ray takes K4/K5's all-pairs route
    pairwise = {k.__name__: cross_trans.read_pairwise_rays(k) for k in cross}
    check(not any(pairwise.values()), f"K4/K5 all-pairs rays in training: {pairwise}")

    cfg = get_cfg()
    cfg.merge_from_file(cfg_file)
    s = cfg.SOLVER
    n_rays = [r.args[0] for r in records if r.msg.startswith("ray pool: %d rays")][0]
    steps = n_rays // s.IMS_PER_BATCH
    check(n_rays == 40_000 and steps == 20, f"pool of {n_rays} rays, {steps} steps an epoch")
    epochs = [e for e, _ in history]
    check(epochs == [1, 2, 3], f"epochs run: {epochs}")
    for epoch, m in history:
        check(bool(np.isfinite(m.loss).all()), f"epoch {epoch}: non-finite loss")
    last = history[-1][1].loss
    check(last[-5:].mean() < last[:5].mean(),
          f"epoch 3 loss did not fall: first five {last[:5].mean():.4g}, last five "
          f"{last[-5:].mean():.4g}")
    val = {r.args[0]: r.args[3] for r in records if r.msg.startswith("Validation - Epoch")}
    check(sorted(val) == epochs and all(np.isfinite(v) for v in val.values()),
          f"validation PSNR by epoch: {val}")
    mid = [os.path.join(out_dir, f"stnerf_torch_checkpoint_{e}_10.pt") for e in epochs]
    check(all(os.path.exists(p) for p in mid), "a mid-epoch checkpoint (_{epoch}_10) is missing")
    events = read_event_dir(os.path.join(out_dir, "tb"))
    check(len(events) == 1, f"{len(events)} event files after one run")
    events = events[0]
    scalars = {}
    for step, tag, _ in events:
        scalars.setdefault(tag, []).append(step)
    train_steps = [(e - 1) * steps for e in epochs]     # LOG_PERIOD 20: each epoch's step 0
    val_steps = [x for e in epochs for x in ((e - 1) * steps + 10, e)]
    want = {**{t: train_steps for t in ("Loss/train_loss", "TrainPsnr", "Loss/mask_loss",
                                        "Loss/rgb_loss")},
            **{t: val_steps for t in ("Val/psnr", "GT/Image", "stage2/rendered", "stage2/depth",
                                      "stage2/alpha", "stage2_bkgd/rendered",
                                      "stage2_layer1/rendered", "stage2_layer2/rendered")}}
    check(scalars == want, f"event file tags and steps {scalars}, expected {want}")
    losses = [v for _, tag, v in events if tag == "Loss/train_loss"]
    check(np.allclose(losses, [float(m.loss[0]) for _, m in history], rtol=1e-6),
          f"event file losses {losses}")
    stage_steps = sum(steps * (1 if e < s.COARSE_STAGE else 2) for e in epochs)
    lp1 = cfg.DATASETS.LAYER_NUM + 1
    # validation renders one 200x150 view at each epoch's step 10 and end
    # through the inference path: both stages' fields through K1 and both
    # merges sorted, as JAX's
    val_runs = [r for r in records if r.msg.startswith("Validation - Epoch")]
    check(len(val_runs) == 2 * len(epochs), f"{len(val_runs)} validations in "
                                            f"{len(epochs)} epochs, VAL_PERIOD 10 implies 2 each")
    val_chunks = len(val_runs) * -(-200 * 150 // cfg.TPU.RENDER_CHUNK)
    expect = {"fused_field": (stage_steps + 2 * val_chunks) * lp1,
              "fused_field_tc": (stage_steps + 2 * val_chunks) * lp1,  # bf16: all of them
              "field_bwd": stage_steps * lp1, "field_bwd_tc": stage_steps * lp1,
              "cross_successor": stage_steps, "cross_log_transmittance_fwd": stage_steps,
              "cross_log_transmittance_bwd": stage_steps}
    wrong = {k: [launches[k], v] for k, v in expect.items() if launches[k] != v}
    check(not wrong, f"launches [counted, implied by the steps and renders]: {wrong}")
    check(calls["merge_layers_planar"] == 2 * val_chunks and not any(plain.values()),
          f"training called the sorted merge or a plain compositor: {calls} (validation "
          f"implies {2 * val_chunks} sorted merges)")
    ckpts = [os.path.join(out_dir, f"stnerf_torch_checkpoint_{e}.pt") for e in epochs]
    check(all(os.path.exists(p) for p in ckpts), "a per-epoch checkpoint is missing")

    epoch_s = {r.args[0]: r.args[1] for r in records if r.msg.startswith("Epoch %d done")}

    # --resume: one more epoch from checkpoint 3, and its first step's loss
    # against a run of do_train from that checkpoint's parameters
    records.clear()
    resumed = train.main(args + ["--resume", "--epochs", "5"])
    check([e for e, _ in resumed] == [4], f"resumed epochs: {[e for e, _ in resumed]}")
    check(any(r.msg.startswith("resumed %s") and r.args[1] == 3 for r in records),
          "the resumed run did not start from checkpoint 3")
    pool, scene = make_train_data(cfg, LayeredSpec.from_cfg(cfg), np.random.default_rng(SEED),
                                  workers=1, device=device)
    spec = LayeredSpec.from_cfg(cfg)
    model = LayeredModel(spec, torch.Generator().manual_seed(SEED + 9), device=device)
    opt, sched = make_optimizer(cfg, model)
    load_checkpoint(ckpts[-1], model, opt, sched)
    replay_cfg = cfg.clone()
    replay_cfg.SOLVER.MAX_EPOCHS, replay_cfg.OUTPUT_DIR = 5, ""
    replay = do_train(replay_cfg, model, scene, pool, opt, sched, resume_epoch=3, seed=SEED,
                      logger=logging.getLogger("chip_smoke.replay"), device=device)
    first, ref = float(resumed[0][1].loss[0]), float(replay[0][1].loss[0])
    check(abs(first - ref) <= 1e-6 * abs(ref),
          f"resumed epoch 4 first loss {first} vs {ref} from checkpoint 3's parameters")

    # --resume from the mid-epoch file alone: epoch 3 from step 10, the
    # uninterrupted run's losses bitwise
    mid_dir = os.path.join(REPO, "build", "chip_smoke_entry_mid")
    shutil.rmtree(mid_dir, ignore_errors=True)
    os.makedirs(mid_dir)
    shutil.copy(mid[-1], mid_dir)
    mid_args = ["-c", entry_point_cfg_file(root, mid_dir, "chip_smoke_train_mid.yml"),
                "--seed", str(SEED), "--workers", str(workers), "--device", str(device)]
    records.clear()
    mid_run = train.main(mid_args + ["--resume", "--epochs", "4"])
    check([e for e, _ in mid_run] == [3] and len(mid_run[0][1].loss) == steps - 10,
          f"mid-epoch resume ran {[(e, len(m.loss)) for e, m in mid_run]}")
    check(any(r.msg.startswith("resumed %s") and r.args[1:3] == (3, 10) for r in records),
          "the mid-epoch resume did not start from epoch 3, step 10")
    mid_losses = [mid_run[0][1].loss.tolist(), history[-1][1].loss[10:].tolist()]
    check(mid_losses[0] == mid_losses[1],
          f"epoch 3 from step 10: resumed {mid_losses[0]} vs uninterrupted {mid_losses[1]}")
    logger.removeHandler(handler)

    # --auto-restart 1 on a healthy run: the supervisor in a process of its
    # own, the run (epoch 4 of the mid-epoch directory) in its child
    code = ("import json, runpy, sys\n"
            "sys.argv = ['train'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('stnerf_tpu_torch.tools.train', run_name='__main__')\n"
            "    rc = 0\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "t = sys.modules.get('torch')\n"
            "print('supervisor', json.dumps({'rc': rc, 'torch_loaded': t is not None, "
            "'cuda_initialized': bool(t is not None and t.cuda.is_initialized())}))\n")
    t0 = time.perf_counter()
    sup = subprocess.run([sys.executable, "-c", code, *mid_args, "--resume", "--epochs", "5",
                          "--auto-restart", "1"], cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    supervised_s = time.perf_counter() - t0
    lines = [x for x in sup.stdout.splitlines() if x.startswith("supervisor ")]
    check(sup.returncode == 0 and len(lines) == 1,
          f"--auto-restart run exited {sup.returncode}: {sup.stdout[-3000:]}{sup.stderr[-3000:]}")
    supervisor = json.loads(lines[0].split(" ", 1)[1])
    check(supervisor["rc"] == 0 and not supervisor["cuda_initialized"],
          f"--auto-restart 1: {supervisor}")
    check(os.path.exists(os.path.join(mid_dir, "stnerf_torch_checkpoint_4.pt"))
          and "Epoch 4 done" in sup.stdout,
          "the supervised run did not train epoch 4")
    supervisor["s"] = supervised_s

    epoch_s.update({r.args[0]: r.args[1] for r in records
                    if r.msg.startswith("Epoch %d done")})
    summary = {"scene_s": scene_s, "train_main_s": train_s, "steps_per_epoch": steps,
               "launches": launches, "pairwise_rays": pairwise, "calls": calls,
               "val_psnr": val,
               "loss_epoch3_first_last": [float(last[0]), float(last[-1])],
               "resumed_first_loss": [first, ref],
               "mid_epoch_resume_losses": mid_losses[0], "supervisor": supervisor,
               "event_tags": sorted(scalars), "val_steps": val_steps,
               "launches_k6": {k.__name__: launches[k.__name__] for k in k6_entries()},
               "s_per_step": {e: t / steps for e, t in epoch_s.items()},
               "rays_per_s": {e: steps * s.IMS_PER_BATCH / t for e, t in epoch_s.items()}}
    print("entry_point", json.dumps(summary), flush=True)
    summary["step"] = compare_compositor_step(device, cfg_file, pool, scene)
    return summary


def scaled_key_frames(frames: list, frame_num: int, demo_frames: int = 101) -> list:
    """The taekwondo demo's key frames (a 101-frame capture) scaled onto a
    scene of ``frame_num`` frames."""
    return [1 + (f - 1) * (frame_num - 1) / (demo_frames - 1) for f in frames]


def check_written_frames(r, sub_dir: str) -> int:
    """Every frame of the renderer's last ``render_path`` is on disk under
    ``rendered/<sub_dir>``, decodes through data/png.py to the image that
    was rendered, and is finite -> the number of files checked."""
    from stnerf_tpu_torch.data.png import read_png
    from stnerf_tpu_torch.render import to_uint8

    root = os.path.join(r.output_dir, sub_dir)
    streams = [("mixed", r.images, r.depths)] + [
        (str(l), r.images_layer[l], r.depths_layer[l])
        for l in range(r.layer_num + 1) if r.is_shown_layer(l)]
    n = 0
    for sub, colors, depths in streams:
        check(len(colors) == len(depths) == r.image_num == len(r.poses),
              f"{sub_dir}/{sub}: {len(colors)} frames kept for {len(r.poses)} poses")
        for i, (c, d) in enumerate(zip(colors, depths)):
            check(np.isfinite(c).all() and np.isfinite(d).all(),
                  f"{sub_dir}/{sub} frame {i}: non-finite image")
            for kind, img in (("color", c), ("depth", d)):
                got = read_png(os.path.join(root, sub, kind, f"{i}.png"))
                want = to_uint8(img)
                check(np.array_equal(got, want[..., 0] if kind == "depth" else want),
                      f"{sub_dir}/{sub}/{kind}/{i}.png does not decode to the rendered image")
                n += 1
    return n


def k1_per_chunk(spec) -> int:
    """K1 launches per chunk of one render with ``spec``: every field once
    per coarse segment (one segment without the early exit) and once in
    the fine stage."""
    segments = (max(1, min(spec.coarse_exit_segments, spec.coarse_samples))
                if spec.coarse_exit_segments > 1 else 1)
    return (segments + 1) * (spec.layer_num + 1)


def gate_launches(r) -> int:
    """K1 launches of one renderer's fidelity gate: the probe (the first gt
    pose, FIDELITY_PROBE_RES wide) through the approximate and the exact
    spec."""
    from stnerf_tpu_torch.render.pose_device import tile_grid

    t = r.cfg.TPU
    pw = max(16, int(t.FIDELITY_PROBE_RES))
    ph = max(16, round(pw * r.height / r.width))
    chunk = min(int(t.RENDER_CHUNK), pw * ph)
    n_pad = tile_grid(ph, pw, chunk, min(int(t.TILE_COLS), pw))[4]
    approx = dataclasses.replace(r.spec, fast_fine=bool(t.FAST_FINE),
                                 coarse_exit_segments=int(t.EARLY_EXIT_SEGMENTS))
    exact = dataclasses.replace(r.spec, fast_fine=False, coarse_exit_segments=0)
    return n_pad // chunk * (k1_per_chunk(approx) + k1_per_chunk(exact))


def count_tiles(run) -> dict:
    """Run ``run()`` with every K1 call of the render core counted: launches,
    64-sample tiles run and tiles in total (a launch without flags runs
    them all) -> counts. A counting run only: each call syncs the card."""
    from stnerf_tpu_torch.models import layered

    real = layered.fused_field
    counts = {"launches": 0, "tiles_run": 0, "tiles_total": 0}

    def counted(field, xyz, ids, dir_enc, tile_flags=None):
        n = -(-xyz.shape[1] // layered.TILE)
        counts["launches"] += 1
        counts["tiles_total"] += n
        counts["tiles_run"] += n if tile_flags is None else int((tile_flags != 0).sum())
        return real(field, xyz, ids, dir_enc, tile_flags)

    layered.fused_field = counted
    try:
        run()
    finally:
        layered.fused_field = real
    counts["share_run"] = counts["tiles_run"] / max(counts["tiles_total"], 1)
    return counts


def render_path_times(r, records) -> dict:
    """Render ``r``'s queued path without saving -> seconds per pose end to
    end and on the device, from the renderer's log line."""
    before = len(records)
    r.render_path(False, 0, auto_save=False)
    (line,) = [x.args for x in records[before:] if x.msg.startswith("Rendered %d poses")]
    return {"s_per_pose": line[5], "device_s_per_pose": line[6]}


def hd_frames(r, idx: int, device) -> dict:
    """One pose of ``r``'s path at its size: a first-use render, then two
    timed ones -> seconds per frame (end to end, device), peak memory."""
    import torch

    pairs = r.layer_frame_pairs[idx]
    r.render_pose(r.poses[idx], r.Ks[idx], pairs, frame_idx=idx)  # first use
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = {"s_per_frame": [], "device_s_per_frame": []}
    for _ in range(2):
        timings = {}
        t0 = time.perf_counter()
        color, depth, _, _ = r.render_pose(r.poses[idx], r.Ks[idx], pairs,
                                           frame_idx=idx, timings=timings)
        out["s_per_frame"].append(time.perf_counter() - t0)
        out["device_s_per_frame"].append(timings["device_s"])
    peak = torch.cuda.max_memory_allocated(device)
    check(color.shape == (r.height, r.width, 3) and np.isfinite(color).all()
          and np.isfinite(depth).all(), f"{r.width}x{r.height} frame: shape or non-finite")
    out.update(max_memory_allocated=peak, max_memory_allocated_gib=peak / 2 ** 30,
               color=color)
    return out


def exact_cfg(cfg):
    """``cfg`` rendering the exact path (no fast fine stage, no early exit,
    no occupancy, so no gate)."""
    out = cfg.clone()
    out.TPU.FAST_FINE, out.TPU.EARLY_EXIT_SEGMENTS, out.TPU.OCCUPANCY_SKIP = False, 0, False
    return out


def phase_render_front_end(device, cfg_file: str, card: str,
                           hd_size=(1920, 1080)) -> dict:
    """The render front end on the checkpoint that phase 11 trained
    (``cfg_file``'s OUTPUT_DIR, its scene) with the config's default
    inference approximations: ``LayeredNeuralRenderer`` refines the boxes
    (K1 on the 64^3 lattice, then from the cache) and runs the fidelity
    gate, which must keep the approximations; the taekwondo demo's runs
    (origin, shift, scale) on a 6-pose smooth path with its key frames
    scaled into the scene's frames, a hide and a hide-both pass, an
    ``s_alpha`` fade, and ``render_path_walking``; the frames on disk, K1
    against its plain version on one pose of the approximate path and on
    one lattice, the approximate path against the exact one, K1's
    launches, a ``.pt`` export read back by a second renderer; the
    approximate and the exact path's seconds per pose, tiles and 1080p
    frame (``hd_size``, width and height); one pose with OCC_SLICES = 2 and
    OCC_GAP_SKIP. Each reading's line carries ``card`` -> summary dict."""
    import glob
    import shutil

    import torch

    from stnerf_tpu_torch.config import get_cfg
    from stnerf_tpu_torch.engine import export_reference_checkpoint
    from stnerf_tpu_torch.kernels.fused_field import fused_field
    from stnerf_tpu_torch.models import export_jax_params, load_jax_params
    from stnerf_tpu_torch.render import LayeredNeuralRenderer
    from stnerf_tpu_torch.render.occupancy import _occupancy_cube
    from stnerf_tpu_torch.render.pose_device import (render_pose_host,
                                                     render_pose_on_device, tile_grid)

    cfg = get_cfg()
    cfg.merge_from_file(cfg_file)
    shutil.rmtree(os.path.join(cfg.OUTPUT_DIR, "rendered"), ignore_errors=True)
    for path in glob.glob(os.path.join(cfg.OUTPUT_DIR, "occ_boxes_*.npz")):
        os.remove(path)
    records = []
    logger = logging.getLogger("stnerf_tpu_torch.render")
    logger.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.emit = lambda r: (records.append(r), print("render", r.getMessage(), flush=True))
    logger.addHandler(handler)

    def logged(prefix, start=0):
        return [x for x in records[start:] if x.getMessage().startswith(prefix)]

    # 1. the renderer with the config's defaults: boxes refined on the
    # lattice through K1, the gate run, the approximations kept
    t = cfg.TPU
    check(t.FAST_FINE and t.EARLY_EXIT_SEGMENTS == 3 and t.OCCUPANCY_SKIP and t.OCC_AUTO_TAU
          and t.FIDELITY_GATE, "the synthetic config does not run the defaults")
    sync(device)
    fused_field.launches = 0
    t0 = time.perf_counter()
    r = LayeredNeuralRenderer(cfg, device=device)
    ctor_s = time.perf_counter() - t0
    ctor_launches = fused_field.launches
    check(not any("not ported" in x.getMessage() for x in records),
          "the renderer still logs an unported approximation")
    check(os.path.basename(r._ckpt_path) == "stnerf_torch_checkpoint_4.pt",
          f"the renderer loaded {r._ckpt_path}, not phase 11's last checkpoint")
    refined = logged("occupancy: refined boxes in")
    check(len(refined) == 1 and r.scene is not r._exact_scene, "the boxes were not refined")
    frame_num, lp1 = cfg.DATASETS.FRAME_NUM, r.layer_num + 1
    lattice = frame_num * r.layer_num * 2                     # frames x performers x nets
    check(ctor_launches == lattice + gate_launches(r),
          f"the renderer's construction launched K1 {ctor_launches} times; the lattice "
          f"and the gate imply {lattice} + {gate_launches(r)}")
    check(r.fidelity_db is not None and np.isfinite(r.fidelity_db)
          and r.fidelity_db >= float(t.FIDELITY_MIN_DB),
          f"the gate read {r.fidelity_db} dB (bar {t.FIDELITY_MIN_DB})")
    check(r.spec.fast_fine and r.spec.coarse_exit_segments == 3
          and r.spec.compute_dtype == "bfloat16", f"render spec {r.spec}")
    orig, new = r._exact_scene.boxes.cpu().numpy(), r.scene.boxes.cpu().numpy()
    check(new.shape == orig.shape and (new[..., 0, :] >= orig[..., 0, :] - 1e-6).all()
          and (new[..., 1, :] <= orig[..., 1, :] + 1e-6).all(),
          "refined boxes do not lie inside the scene's")
    vol = lambda b: np.prod(np.maximum(b[..., 1, :] - b[..., 0, :], 0), -1)
    # K1 on one lattice against its plain version (bf16 bar of phase 2)
    box = orig[frame_num // 2, 0]
    cubes = [_occupancy_cube(r.model, 1, box, frame_num // 2 + 1, int(t.OCC_GRID), plain)
             for plain in (False, True)]
    cube_rel = float(np.linalg.norm(cubes[0] - cubes[1]) / max(np.linalg.norm(cubes[1]), 1e-30))
    check(cube_rel <= 1e-2, f"occupancy lattice, K1 vs plain relative L2 {cube_rel:.2e}")
    occupancy = {"card": card, "refine_s": refined[0].args[0], "constructor_s": ctor_s,
                 "cache_hit": False, "lattice_launches": lattice,
                 "box_volume_share": float(vol(new).sum() / vol(orig).sum()),
                 "lattice_kernel_vs_plain_rel_l2": cube_rel,
                 "fidelity_db": r.fidelity_db, "fidelity_min_db": float(t.FIDELITY_MIN_DB)}
    kf1 = scaled_key_frames([21, 49, 74, 87], frame_num)
    kf2 = scaled_key_frames([13, 42, 80, 90], frame_num)
    kf = scaled_key_frames([20, 50, 74, 85], frame_num)
    steps = 6

    # 2. the demo's runs and the other edits, counted; each renderer built
    # here reads the cached boxes and runs its own gate
    sync(device)
    fused_field.launches = fused_field.launches_tc = 0
    zero_k6()
    # per run: (renderer, its mixed frames, its background stream's frames)
    runs, files, poses, path_s, expected = {}, 0, 0, 0.0, 0
    _, _, _, _, n_pad = tile_grid(r.height, r.width, t.RENDER_CHUNK, t.TILE_COLS)
    chunks = n_pad // t.RENDER_CHUNK
    for name, kwargs in (("origin", {}), ("shift", {"shift": [[0, 0, 0], [0, 0.5, 0],
                                                              [0, -0.5, 0]]}),
                         ("scale", {"scale": [1, 0.75, 1.5]}),
                         ("alpha", {"s_alpha": [1.0, 0.0]})):
        if name == "origin":
            rr = r
        else:
            start = len(records)
            rr = LayeredNeuralRenderer(cfg, device=device, **kwargs)
            check(len(logged("occupancy: loaded cached boxes", start)) == 1,
                  f"{name}: the renderer did not read the cached boxes")
            check(rr.fidelity_db is not None and rr.spec == r.spec,
                  f"{name}: the gate read {rr.fidelity_db} dB with spec {rr.spec}")
            occupancy["cache_hit"] = True
            expected += gate_launches(rr)
        rr.set_save_dir(name)
        rr.set_fps(25)
        rr.set_smooth_path_poses(steps, around=False)
        rr.retime_by_key_frames(1, kf1, kf)
        rr.retime_by_key_frames(2, kf2, kf)
        t0 = time.perf_counter()
        rr.render_path(False, 0, auto_save=True)
        path_s += time.perf_counter() - t0
        poses += rr.image_num
        expected += rr.image_num * chunks * k1_per_chunk(rr.spec)
        files += check_written_frames(rr, os.path.join(name, "video_0"))
        rr.save_video()
        runs[name] = (rr, list(rr.images), list(rr.images_layer[0]))
    for layer, name in ((1, "hide_man_1"), (2, "hide_both")):
        r.hide_layer(layer)
        r.set_save_dir(name)
        t0 = time.perf_counter()
        r.render_path(False, 0, auto_save=True)
        path_s += time.perf_counter() - t0
        poses += r.image_num
        expected += r.image_num * chunks * k1_per_chunk(r.spec)
        files += check_written_frames(r, os.path.join(name, f"video_{r.save_count}"))
        runs[name] = (r, list(r.images), list(r.images_layer[0]))
        r.save_video()
    walk = LayeredNeuralRenderer(cfg, device=device)
    expected += gate_launches(walk)
    walk.set_pose_duration(1, min(14, walk.camera_num - 1))
    walk.set_smooth_path_poses(steps, around=False)
    walk.invert_poses()
    walk.set_save_dir("walking")
    t0 = time.perf_counter()
    walk.render_path_walking(False, 0, 0, auto_save=True)
    path_s += time.perf_counter() - t0
    poses += walk.image_num
    expected += walk.image_num * chunks * k1_per_chunk(walk.spec)
    files += check_written_frames(walk, os.path.join("walking", "video_0"))
    for i in range(walk.image_num):
        check(os.path.exists(os.path.join(walk.output_dir, "02", "color", f"{i}.png")),
              f"render_path_walking wrote no occlusion composite {i}")
    sync(device)
    launches, launches_tc, k6 = fused_field.launches, fused_field.launches_tc, read_k6()
    h, w = r.height, r.width
    # every pose: each of the L+1 fields once per chunk and coarse segment
    # and once in the fine stage; every renderer built: its gate's probes
    check(launches == expected and launches_tc == expected,
          f"fused_field launched {launches} times ({launches_tc} on tensor cores); "
          f"{poses} poses and the gates imply {expected}")
    check(not any(k6.values()), f"the front end launched K6: {k6}")

    # 3. hiding a performer does not touch the background's stream (to one
    # u8 step), and with every performer hidden the mix is the background
    # alone up to the quadrature of the hidden samples' interleaved depths,
    # which cut the background's segments: the gate's bar here, on the
    # approximate path (6 holds the exact path's mix to an oracle)
    _, origin, origin_bg = runs["origin"]
    _, hide_both, hide_both_bg = runs["hide_both"]
    hide_both_db = []
    for i, mixed in enumerate(hide_both):
        err = float(np.abs(hide_both_bg[i] - origin_bg[i]).max())
        check(err <= 1.0 / 255 + 1e-7,
              f"hide_both pose {i}: hiding the performers moved the background stream by {err}")
        hide_both_db.append(psnr(mixed, hide_both_bg[i]))
        check(hide_both_db[-1] >= float(t.FIDELITY_MIN_DB),
              f"hide_both pose {i}: the mix is {hide_both_db[-1]:.1f} dB from the background "
              f"stream")
    for name in ("shift", "scale", "alpha", "hide_man_1", "hide_both"):
        check(any(not np.array_equal(a, b) for a, b in zip(runs[name][1], origin)),
              f"{name}: the edit left every frame unchanged")

    # 4. on one pose of the approximate path, with the renderer's own model,
    # scene and edits: K1 against its plain version; the approximate path
    # against the exact one on the original boxes (what the gate measures,
    # its bar) and on the refined boxes (unbarred: the tighter intervals
    # move every sample); acc in [0, 1]
    sr, idx = runs["scale"][0], steps // 2
    frame_ids = np.ones(lp1, np.float32)
    for layer, fid in sr.layer_frame_pairs[idx]:
        frame_ids[layer] = fid
    edits = sr._edits(idx, 0, 0)
    kw = dict(chunk=t.RENDER_CHUNK, tile_cols=t.TILE_COLS, far_clip=sr.far,
              download_layers=list(range(lp1)))
    exact_spec = dataclasses.replace(sr.spec, fast_fine=False, coarse_exit_segments=0)

    def pose(scene, spec, **extra):
        return render_pose_host(sr.model, scene, sr.Ks[idx], sr.poses[idx], frame_ids,
                                sr.dataset.near_far, edits, h, w, spec=spec, **kw, **extra)

    def images_db(a, b):
        return min(psnr(x, y) for x, y in zip([a[0], *a[2]], [b[0], *b[2]]))

    kernel = pose(sr.scene, sr.spec)
    plain = pose(sr.scene, sr.spec, plain=True)
    db = images_db(kernel, plain)
    check(db >= 40.0, f"front-end pose, kernel vs plain {db:.1f} dB < 40")
    check(np.array_equal(kernel[0], runs["scale"][1][idx]),
          "render_pose_host on the renderer's inputs differs from its render_path frame")
    # the approximate path against the exact one, the gate's measure (the
    # mixed colour's PSNR) on the gate's own pose at the frame's size with
    # deterministic sampling: its bar holds there. On the path's pose (and
    # the per-layer images, the refined boxes) it is read, unbarred: the
    # gate certifies its one pose, not every pose of a path
    exact = pose(sr._exact_scene, exact_spec)
    approx = pose(sr._exact_scene, sr.spec)
    approx_db, approx_layers_db = psnr(approx[0], exact[0]), images_db(approx, exact)
    refined_db, refined_layers_db = psnr(kernel[0], exact[0]), images_db(kernel, exact)
    # which approximation the path pose's gap comes from
    parts_db = {f"path_pose_{name}_only_db": psnr(pose(sr._exact_scene, spec_)[0], exact[0])
                for name, spec_ in (("fast_fine", dataclasses.replace(sr.spec,
                                                                      coarse_exit_segments=0)),
                                    ("early_exit", dataclasses.replace(sr.spec,
                                                                       fast_fine=False)))}
    err = (r._fidelity_probe(r.spec, r._exact_scene, None, width=w)
           - r._fidelity_probe(exact_spec, r._exact_scene, None, width=w))
    gate_pose_db = float(-10.0 * torch.log10(torch.clamp(torch.mean(err * err), min=1e-12)))
    frame = render_pose_on_device(
        sr.model, sr.scene, np.asarray(sr.Ks[idx], np.float32),
        torch.as_tensor(np.asarray(sr.poses[idx], np.float32), device=device),
        torch.as_tensor(frame_ids, device=device),
        torch.as_tensor(sr.dataset.near_far, device=device), edits, h=h, w=w,
        chunk=t.RENDER_CHUNK, tile_cols=t.TILE_COLS, spec=sr.spec)
    for acc in (frame.acc.float(), frame.layer_acc.float()):
        check(bool(torch.isfinite(acc).all() and (acc >= 0).all() and (acc <= 1).all()),
              "front-end pose: acc outside [0, 1]")
    tiles = {name: count_tiles(lambda: pose(scene, spec))
             for name, scene, spec in (("approximate", sr.scene, sr.spec),
                                       ("exact", sr._exact_scene, exact_spec))}
    check(tiles["approximate"]["launches"] == chunks * k1_per_chunk(sr.spec),
          f"approximate pose: {tiles['approximate']['launches']} K1 launches")
    print("render_fidelity", json.dumps({
        "card": card, "fidelity_db": r.fidelity_db, "kernel_vs_plain_db": db,
        "gate_pose_full_size_db": gate_pose_db, "path_pose_approximate_vs_exact_db": approx_db,
        "path_pose_least_image_db": approx_layers_db,
        "path_pose_refined_boxes_vs_exact_db": refined_db,
        "path_pose_refined_boxes_least_image_db": refined_layers_db, **parts_db}), flush=True)
    check(gate_pose_db >= float(t.FIDELITY_MIN_DB),
          f"the gate's pose at {w}x{h}, approximate vs exact path {gate_pose_db:.2f} dB < "
          f"{t.FIDELITY_MIN_DB}")

    # 5. the reference .pt export, read back by a second renderer
    pt_dir = os.path.join(cfg.OUTPUT_DIR, "reference_export")
    shutil.rmtree(pt_dir, ignore_errors=True)
    os.makedirs(pt_dir)
    export_reference_checkpoint(os.path.join(pt_dir, "layered_rfnr_checkpoint_4.pt"), r.model)
    pt_cfg = cfg.clone()
    pt_cfg.OUTPUT_DIR = pt_dir
    r_pt = LayeredNeuralRenderer(pt_cfg, device=device)
    check(r_pt._ckpt_path.endswith("layered_rfnr_checkpoint_4.pt"),
          f"the second renderer loaded {r_pt._ckpt_path}")
    r_pt.set_smooth_path_poses(steps, around=False)
    r0 = LayeredNeuralRenderer(cfg, device=device)
    r0.set_smooth_path_poses(steps, around=False)
    a = r0.render_pose(r0.poses[idx], r0.Ks[idx], r0.layer_frame_pairs[idx], frame_idx=idx)
    b = r_pt.render_pose(r_pt.poses[idx], r_pt.Ks[idx], r_pt.layer_frame_pairs[idx],
                         frame_idx=idx)
    check(all(np.array_equal(x, y) for x, y in zip([a[0], a[1], *a[2], *a[3]],
                                                   [b[0], b[1], *b[2], *b[3]])),
          "the renderer on the exported .pt differs from the one on the port's checkpoint")

    # 6. the approximate and the exact path on the same 6-pose path, in the
    # order approximate, exact, exact, approximate; tiles run of one pose
    re = LayeredNeuralRenderer(exact_cfg(cfg), device=device)
    check(not re.spec.fast_fine and re.spec.coarse_exit_segments == 0
          and re.scene is re._exact_scene and re.fidelity_db is None,
          "the exact renderer runs an approximation")
    re.set_smooth_path_poses(steps, around=False)
    paths = {"approximate": [], "exact": []}
    for name, rr in (("approximate", r0), ("exact", re), ("exact", re), ("approximate", r0)):
        paths[name].append(render_path_times(rr, records))
    # hiding both performers zeroes their densities in the merged composite
    # (the reference's semantics: their samples stay in the merge, so the
    # mix is not the background stream's own composite, by up to 13 u8
    # steps on the JAX package's trained fixture at 100x75, PERF.md Findings).
    # The oracle shares no edit code: the same renderer's model with each
    # performer's density head set to output -1 (w = 0, b = -1), so that
    # the fields themselves put zero-density samples into an unedited merge
    zero = LayeredNeuralRenderer(exact_cfg(cfg), device=device)
    zp = export_jax_params(zero.model)
    for group in ("layers_coarse", "layers_fine"):
        head = zp[group]["density"][-1]
        head["w"], head["b"] = np.zeros_like(head["w"]), np.full_like(head["b"], -1.0)
    load_jax_params(zero.model, zp)
    zero.set_smooth_path_poses(steps, around=False)
    zeroed = [zero.render_pose(zero.poses[i], zero.Ks[i], zero.layer_frame_pairs[i],
                               frame_idx=i, download_layers=[0])
              for i in range(len(zero.poses))]
    re.hide_layer(1)
    re.hide_layer(2)
    hide_both_oracle = []  # per pose: max |mix - oracle|, max |mix - background|
    for i in range(len(re.poses)):
        c, _, cl, _ = re.render_pose(re.poses[i], re.Ks[i], re.layer_frame_pairs[i],
                                     frame_idx=i, download_layers=[0])
        err = float(np.abs(c - zeroed[i][0]).max())
        hide_both_oracle.append([err, float(np.abs(c - cl[0]).max())])
        check(err <= 1.0 / 255 + 1e-7,
              f"exact hide_both pose {i}: the mix differs from the unedited mix of "
              f"zero-density performers by {err}")
        check(np.array_equal(cl[0], zeroed[i][2][0]),
              f"exact hide_both pose {i}: hiding the performers changed the background stream")
    for name in paths:
        row = {"card": card, "path": name, "h": h, "w": w, "runs": paths[name],
               "k1_launches_per_pose": tiles[name]["launches"],
               "tiles_run": tiles[name]["tiles_run"], "tiles_total": tiles[name]["tiles_total"],
               "tiles_share_run": tiles[name]["share_run"]}
        print("render_path_times", json.dumps(row), flush=True)

    # 7. one pose at 1920x1080, approximate and exact (the Ks rescaled by
    # the width ratio as RenderScene does; the 4:3 scene cropped to 16:9)
    hd = {}
    for name, base in (("approximate", cfg), ("exact", exact_cfg(cfg))):
        hd_cfg = base.clone()
        hd_cfg.INPUT.SIZE_TEST = list(hd_size)
        rh = LayeredNeuralRenderer(hd_cfg, device=device)
        check(np.allclose(rh.gt_Ks[:, :2], r.gt_Ks[:, :2] * hd_size[0] / w),
              "1080p Ks not rescaled")
        check(rh.spec.fast_fine == (name == "approximate"), f"1080p {name}: spec {rh.spec}")
        rh.set_smooth_path_poses(steps, around=False)
        hd[name] = hd_frames(rh, idx, device)
    hd_db = psnr(hd["approximate"].pop("color"), hd["exact"].pop("color"))
    for name, row in hd.items():
        print("render_hd", json.dumps({"card": card, "path": name, "size": list(hd_size),
                                       **row, "approximate_vs_exact_db": hd_db}), flush=True)

    # 8. one pose with the boxes in two slices and the gap skip
    sl_cfg = cfg.clone()
    sl_cfg.TPU.OCC_SLICES, sl_cfg.TPU.OCC_GAP_SKIP = 2, True
    start = len(records)
    rs = LayeredNeuralRenderer(sl_cfg, device=device)
    check(rs.scene.boxes.ndim == 5 and rs.scene.boxes.shape[2] == 2 and rs.spec.occ_gap_skip,
          f"sliced renderer: boxes {tuple(rs.scene.boxes.shape)}")
    rs.set_smooth_path_poses(steps, around=False)
    t0 = time.perf_counter()
    sc = rs.render_pose(rs.poses[idx], rs.Ks[idx], rs.layer_frame_pairs[idx], frame_idx=idx)
    sliced_s = time.perf_counter() - t0
    check(np.isfinite(sc[0]).all() and sc[0].shape == (h, w, 3), "sliced pose: non-finite")
    sliced = {"card": card, "refine_s": logged("occupancy: refined boxes in", start)[0].args[0],
              "fidelity_db": rs.fidelity_db, "s_per_pose": sliced_s,
              "vs_approximate_db": psnr(sc[0], a[0])}
    print("render_sliced", json.dumps(sliced), flush=True)
    print("render_occupancy", json.dumps(occupancy), flush=True)

    logger.removeHandler(handler)
    summary = {"card": card, "h": h, "w": w, "poses": poses, "files_checked": files,
               "s_per_pose": path_s / poses, "kernel_vs_plain_db": db,
               "launches": launches, "launches_tc": launches_tc,
               "launches_expected": expected, "launches_k6": k6,
               "fidelity_db": r.fidelity_db, "gate_pose_full_size_db": gate_pose_db,
               "path_pose_approximate_vs_exact_db": approx_db,
               "hide_both_mix_vs_background_db": hide_both_db,
               "exact_hide_both_vs_zero_density_and_background_max": hide_both_oracle,
               "paths": paths, "tiles": tiles, "hd": hd, "occupancy": occupancy,
               "sliced": sliced}
    print("render_front_end", json.dumps(summary), flush=True)
    return summary


def fast_fine_cfg():
    """taekwondo_cfg with the fast fine stage kept in training and pose
    refinement on (phase 14's model)."""
    cfg = pose_cfg()
    cfg.TPU.FAST_FINE_TRAIN = True
    return cfg


def pose_cfg():
    """taekwondo_cfg with pose refinement on: the exact fused path of the
    port's default training model."""
    cfg = taekwondo_cfg()
    cfg.MODEL.POSE_REFINEMENT = True
    return cfg


def fine_stage_times(call: tuple, reps: int) -> dict:
    """K1 (the training forward, ``checked``) and K2, bf16, against their
    plain versions on one recorded fine-stage performer call of the fast
    fine path (its samples, frame ids, directions and skip flags; seeded
    cotangents): K1's relative L2 (bar 1e-2, phase 2's), both kernels' and
    plain versions' ms, bounds."""
    import torch

    from stnerf_tpu_torch.kernels.field_vjp import field_bwd, field_bwd_reference
    from stnerf_tpu_torch.kernels.fused_field import TILE, fused_field, fused_field_reference

    net, motion, mode, xyz, ids, dir_enc, flags = call
    f = pack_dtype(net, motion, mode, "bfloat16")
    m = xyz.shape[1]
    run = min(int(flags.sum()) * TILE, m)
    gen = torch.Generator(device=xyz.device).manual_seed(SEED + 14)
    d_rgb = torch.randn((3, m), generator=gen, device=xyz.device)
    d_sigma = torch.randn((m,), generator=gen, device=xyz.device)
    got, ref = fused_field(f, xyz, ids, dir_enc, flags, checked=True), fused_field_reference(
        f, xyz, ids, dir_enc, flags)
    rel = [compare_leaf(a, b)["rel"] for a, b in zip(got, ref)]
    check(max(rel) <= 1e-2, f"fine stage K1 vs plain relative L2 (rgb, sigma) {rel} > 1e-2")
    macs = field_macs(f)
    io = 4 * m * (4 + dir_enc.shape[0] + 4)
    weights = f.weights.element_size() * f.weights.numel()
    row = {"m": m, "samples_run": run, "tiles_run": int(flags.sum()),
           "tiles": int(flags.numel()), "k1_rel_l2": rel}
    row["k1_bound_ms"], row["k1_bound_by"] = bound_ms(2 * macs["fwd"] * run, io + weights,
                                                      "bfloat16")
    row["k2_bound_ms"], row["k2_bound_by"] = bound_ms(2 * macs["bwd"] * run,
                                                      io + 2 * weights, "bfloat16")
    row["k1_ms"] = cuda_ms(lambda: fused_field(f, xyz, ids, dir_enc, flags, checked=True),
                           reps)
    row["k1_plain_ms"] = cuda_ms(lambda: fused_field_reference(f, xyz, ids, dir_enc, flags),
                                 reps)
    args = (f, xyz, ids, dir_enc, d_rgb, d_sigma, flags)
    row["k2_ms"] = cuda_ms(lambda: field_bwd(*args), reps)
    row["k2_plain_ms"] = cuda_ms(lambda: field_bwd_reference(*args), reps)
    return row


def phase_fast_fine_train(device, bundle, scene, card: str, exact: dict) -> dict:
    """do_train with TPU.FAST_FINE_TRAIN and pose refinement on phase 5's
    pool, one full epoch in each compositor form, its checks and readings
    (``exact``: phase 5's summary, the exact step on this card), then the
    kernel vs plain step comparisons on the fast fine and the exact fused
    path with pose refinement -> summary dict."""
    import torch

    from stnerf_tpu_torch.engine import do_train, make_optimizer, pool_camera_num
    from stnerf_tpu_torch.kernels import cross_trans, field_vjp
    from stnerf_tpu_torch.kernels.field_vjp import field_bwd
    from stnerf_tpu_torch.kernels.fused_field import fused_field
    from stnerf_tpu_torch.models import LayeredSpec, layered

    cross = [cross_trans.cross_successor, cross_trans.cross_log_transmittance_fwd,
             cross_trans.cross_log_transmittance_bwd]
    plain = count_calls(field_vjp, ["fused_field_reference", "field_bwd_reference"])
    plain.update(count_calls(cross_trans, ["cross_successor_reference",
                                           "cross_log_transmittance_reference",
                                           "cross_log_transmittance_bwd_reference"]))
    real = layered.field_planar_trainable
    tiles, last_fine = [], {}

    def recording(net, motion, xyz, ids, dir_enc, flags=None, mode=None, *rest):
        # the performers' skip flags (kept on the device until the end)
        if flags is not None:
            tiles.append((xyz.shape[1], (flags == 0).sum(), flags.numel()))
            last_fine[xyz.shape[1]] = (net, motion, mode, xyz.detach(), ids.detach(),
                                       dir_enc.detach(), flags)
        return real(net, motion, xyz, ids, dir_enc, flags, mode, *rest)

    layered.field_planar_trainable = recording
    rows = {}
    try:
        for kernel in (False, True):
            cfg = fast_fine_cfg()
            cfg.TPU.COMPOSITOR_KERNEL = kernel
            s = cfg.SOLVER
            s.COARSE_STAGE, s.MAX_EPOCHS, s.WARMUP_ITERS, s.LOG_PERIOD = 1, 2, 1, 5
            spec = LayeredSpec.from_cfg(cfg)
            spec = dataclasses.replace(spec, camera_num=pool_camera_num(bundle, spec))
            model = make_model(spec, device)
            opt, sched = make_optimizer(cfg, model)
            label = "nosort" if kernel else "sorted"
            records = []
            logger = logging.getLogger(f"chip_smoke.fast_fine_train.{label}")
            logger.setLevel(logging.INFO)
            handler = logging.StreamHandler(sys.stdout)
            handler.emit = lambda r, label=label: (
                records.append(r), print("fast_fine_train", label, r.getMessage(), flush=True))
            logger.addHandler(handler)
            for k in (fused_field, field_bwd, *cross):
                k.launches = 0
            fused_field.launches_tc = field_bwd.launches_tc = 0
            for k in plain:
                plain[k] = 0
            zero_k6()
            tiles.clear()
            history = do_train(cfg, model, scene, bundle, opt, sched, logger=logger, seed=SEED,
                               device=device)
            launches = {k.__name__: k.launches for k in (fused_field, field_bwd, *cross)}
            launches.update(fused_field_tc=fused_field.launches_tc,
                            field_bwd_tc=field_bwd.launches_tc)
            k6 = read_k6()
            steps = len(bundle["labels"]) // s.IMS_PER_BATCH
            lp1 = spec.layer_num + 1
            check([e for e, _ in history] == [1], f"epochs run: {[e for e, _ in history]}")
            loss = history[0][1].loss
            check(bool(np.isfinite(loss).all()), f"{label}: non-finite loss")
            check(loss[-5:].mean() < loss[:5].mean(),
                  f"{label}: loss did not fall: first five {loss[:5].mean():.4g}, last five "
                  f"{loss[-5:].mean():.4g}")
            implied = {"fused_field": 2 * lp1 * steps, "fused_field_tc": 2 * lp1 * steps,
                       "field_bwd": 2 * lp1 * steps, "field_bwd_tc": 2 * lp1 * steps,
                       **{k.__name__: steps if kernel else 0 for k in cross}}
            check(launches == implied, f"{label}: launches {launches}, the steps imply {implied}")
            check(not any(plain.values()), f"{label}: plain evaluations {plain}")
            m_fine = s.IMS_PER_BATCH * spec.fine_samples
            by_stage = {}
            for m, off, total in tiles:
                st = by_stage.setdefault("fine" if m == m_fine else "coarse", [0, 0])
                st[0] += int(off)
                st[1] += total
            t = [r.args[1] for r in records if r.msg.startswith("Epoch %d done")][0]
            rows[label] = {"card": card, "steps": steps, "launches": launches,
                           "launches_k6": k6, "plain_calls": dict(plain),
                           "tiles_skipped_of_total": by_stage,
                           "loss_first_last": [float(loss[0]), float(loss[-1])],
                           "s_per_step": t / steps, "rays_per_s": steps * s.IMS_PER_BATCH / t,
                           "exact_s_per_step": exact["s_per_step"][2],
                           "exact_rays_per_s": exact["rays_per_s"][2]}
            print("fast_fine_train", json.dumps({"compositor": label, **rows[label]}),
                  flush=True)
            logger.removeHandler(handler)
    finally:
        layered.field_planar_trainable = real
    summary = {"forms": rows,
               "fine_stage": fine_stage_times(last_fine[s.IMS_PER_BATCH * spec.fine_samples],
                                              reps=5)}
    print("fast_fine_stage_kernels", json.dumps({"card": card, **summary["fine_stage"]}),
          flush=True)
    steps_rows = {}
    for name, cfg_fn in (("fast_fine", fast_fine_cfg), ("exact_fused", pose_cfg)):
        row32, plain32 = compare_train_step(device, bundle, scene, "float32", cfg_fn)
        row16, _ = compare_train_step(device, bundle, scene, "bfloat16", cfg_fn, plain32)
        steps_rows[name] = [row16, row32]
    summary["steps"] = steps_rows
    return summary


def path_kernels() -> tuple:
    """(every kernel wrapper, those with a tensor-core route)."""
    from stnerf_tpu_torch.kernels import cross_trans
    from stnerf_tpu_torch.kernels.field_vjp import field_bwd
    from stnerf_tpu_torch.kernels.fused_field import fused_field
    from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_bwd, spacenet_fwd

    by_route = [fused_field, field_bwd, spacenet_fwd, spacenet_bwd]
    cross = [cross_trans.cross_successor, cross_trans.cross_log_transmittance_fwd,
             cross_trans.cross_log_transmittance_bwd]
    return [*by_route, *cross, *k6_entries()], by_route


def zero_launches():
    kernels, by_route = path_kernels()
    for k in kernels:
        k.launches = 0
    for k in by_route:
        k.launches_tc = 0


def read_launches() -> dict:
    """Each wrapper's launches since ``zero_launches``, the tensor-core
    routes also under ``<name>_tc``."""
    kernels, by_route = path_kernels()
    out = {k.__name__: k.launches for k in kernels}
    out.update({f"{k.__name__}_tc": k.launches_tc for k in by_route})
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def set_rank_env(rank: int, world: int, port: int):
    """What torchrun gives each rank: RANK, LOCAL_RANK, WORLD_SIZE and the
    rendezvous address."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))


def entry_model(cfg, device, state=None):
    """Phase 11's model (its config's spec, weights from the seed, or
    ``state``)."""
    import torch

    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec

    model = LayeredModel(LayeredSpec.from_cfg(cfg), torch.Generator().manual_seed(SEED),
                         device=device)
    if state is not None:
        model.load_state_dict(state)
    return model


def flat_params(model):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def flat_grads(model):
    import torch

    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


def pose_arrays(out) -> list:
    """render_pose_host's (color, depth, color_layer, depth_layer) as one
    list of arrays."""
    return [out[0], out[1], *out[2], *out[3]]


def entry_pose(cfg, device):
    """The first gt camera of phase 11's scene at the config's test size ->
    ((K, c2w, frame ids, near_far, h, w), the scene's boxes)."""
    from stnerf_tpu_torch.data import RenderScene

    scene = RenderScene(cfg, device)
    lp1 = cfg.DATASETS.LAYER_NUM + 1
    return ((scene.Ks[0], scene.poses[0], np.full(lp1, 2.0, np.float32), scene.near_far,
             scene.height, scene.width), scene.scene_boxes)


def dist_worker(rank: int, world: int, port: int, work: str, device: str):
    """One of phase 15(b)'s ranks: two processes on one card over gloo. The
    sharded pose, then one sharded training step on this rank's fixed
    shard; saves the reduced gradients, the parameters after Adam, the
    pose, the launches and the host seconds to ``work``/rank<r>.pt."""
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from stnerf_tpu_torch.config import get_cfg
    from stnerf_tpu_torch.engine import make_optimizer, make_train_step
    from stnerf_tpu_torch.models import EditState
    from stnerf_tpu_torch.parallel import init_distributed, make_mesh
    from stnerf_tpu_torch.render import LayeredNeuralRenderer, render_pose_host

    set_rank_env(rank, world, port)
    device = init_distributed(device, backend="gloo")
    mesh = make_mesh(device=device)
    blob = torch.load(os.path.join(work, "inputs.pt"), map_location=device,
                      weights_only=False)
    cfg = get_cfg()
    cfg.merge_from_file(blob["cfg_file"])
    model = entry_model(cfg, device, blob["model"])
    scene = type(blob["scene"])(*(t.to(device) for t in blob["scene"]))
    K, c2w, fids, nf, h, w = blob["pose"]
    zero_launches()
    sync(device)
    t0 = time.perf_counter()
    pose = render_pose_host(model, scene, K, c2w, fids, nf,
                            EditState.identity(cfg.DATASETS.LAYER_NUM, device=device), h, w,
                            chunk=cfg.TPU.RENDER_CHUNK, tile_cols=cfg.TPU.TILE_COLS, mesh=mesh)
    pose_s = time.perf_counter() - t0
    opt, sched = make_optimizer(cfg, model)
    step = make_train_step(model, opt, sched, remove_outliers=True, device=device, mesh=mesh)
    shard = blob["shards"][rank]
    t0 = time.perf_counter()
    m = step(scene, shard, torch.Generator(device=device).manual_seed(SEED + 100 + rank), 1.0)
    sync(device)
    step_s = time.perf_counter() - t0
    launches = read_launches()
    result = {"grads": flat_grads(model).cpu(), "params": flat_params(model).cpu(),
              "loss": float(m.loss), "pose": pose_arrays(pose), "launches": launches,
              "pose_s": pose_s, "step_s": step_s}
    # the renderer front end on phase 11's checkpoint over both ranks
    r = LayeredNeuralRenderer(cfg, mesh=mesh, device=device)
    result["renderer_pose"] = pose_arrays(r.render_pose(*renderer_pose_args(r)))
    result["renderer_state"] = (r.fidelity_db, str(r.spec))
    torch.save(result, os.path.join(work, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def renderer_pose_args(r) -> tuple:
    """The renderer's first gt camera at frame 2 of every layer."""
    return r.gt_poses[0], r.gt_Ks[0], [(i, 2) for i in range(r.layer_num + 1)]


def phase_distributed(device, cfg_file: str, card: str) -> dict:
    """Phase 15 on phase 11's entry-point config (its synthetic scene and
    cached pool, TPU.COMPOSITOR_KERNEL on, bf16).

    (a) NCCL at world size 1 in this process: do_train(mesh=) over one full
    epoch of 20 steps against do_train without a mesh from the same
    weights (order plain, mesh, mesh, plain): losses and parameters
    bitwise; s/step of both from do_train's epoch seconds, and the flat
    all_reduce of a step's gradients and metrics timed alone (host clock
    to a sync, 50 calls). The first gt
    pose through render_pose_host(mesh=) bitwise the unsharded pose.
    (b) Two processes on this one card over gloo (``dist_worker``): one
    sharded step on two fixed shards of a 2000-ray batch: the reduced
    gradients bitwise (g0 + g1) / 2 reconstructed in this process, the
    parameters after Adam bitwise the reconstruction's and equal on both
    ranks; the gathered pose >= 60 dB against the one-process pose with the
    hit masks (a layer's depth set) equal, and whether it is bitwise.
    -> summary dict (launches by path)."""
    import shutil

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from stnerf_tpu_torch.config import get_cfg
    from stnerf_tpu_torch.data import make_train_data
    from stnerf_tpu_torch.engine import (do_train, make_decode, make_optimizer,
                                         sort_batch_by_hit, split_compact_bundle,
                                         training_spec)
    from stnerf_tpu_torch.engine.trainer import _losses, _mean_over_ranks, _RawMetrics, _take
    from stnerf_tpu_torch.models import EditState, LayeredSpec
    from stnerf_tpu_torch.parallel import init_distributed, make_mesh
    from stnerf_tpu_torch.render import LayeredNeuralRenderer, render_pose_host

    cfg = get_cfg()
    cfg.merge_from_file(cfg_file)
    cfg.OUTPUT_DIR = ""
    cfg.SOLVER.MAX_EPOCHS, cfg.SOLVER.COARSE_STAGE = 2, 1   # one full epoch
    spec = LayeredSpec.from_cfg(cfg)
    pool, scene = make_train_data(cfg, spec, np.random.default_rng(SEED), workers=1,
                                  device=device)
    state = {k: v.clone() for k, v in entry_model(cfg, device).state_dict().items()}
    # do_train's "Epoch %d done" records give the epoch's seconds
    quiet = logging.getLogger("chip_smoke.distributed")
    quiet.setLevel(logging.INFO)
    quiet.propagate = False
    epoch_s = []

    def on_record(r):
        if r.msg.startswith("Epoch %d done"):
            epoch_s.append(r.args[1])

    handler = logging.Handler()
    handler.emit = on_record
    quiet.addHandler(handler)
    L = cfg.DATASETS.LAYER_NUM
    pose, _ = entry_pose(cfg, device)
    K, c2w, fids, nf, h, w = pose
    edits = EditState.identity(L, device=device)

    # (a) NCCL, world size 1
    set_rank_env(0, 1, free_port())
    init_distributed(device)
    mesh = make_mesh(device=device)
    backend = mesh.backend
    check(backend == ("nccl" if device.type == "cuda" else "gloo") and mesh.data == 1,
          f"mesh {mesh}")
    runs, seconds, launches_a, runs_model = {}, {"plain": [], "mesh": []}, None, {}
    try:
        for name in ("plain", "mesh", "mesh", "plain"):
            model = entry_model(cfg, device, state)
            if name == "mesh":
                zero_launches()
            hist = do_train(cfg, model, scene, pool, mesh=mesh if name == "mesh" else None,
                            seed=SEED, logger=quiet, device=device)
            seconds[name].append(epoch_s[-1])
            runs_model[name] = model
            if name == "mesh" and launches_a is None:
                launches_a = read_launches()
            runs.setdefault(name, []).append((hist[0][1].loss, flat_params(model)))
        steps = len(runs["plain"][0][0])
        for (la, pa), (lb, pb) in zip(runs["plain"], runs["mesh"]):
            check(np.array_equal(la, lb) and torch.equal(pa, pb),
                  "15(a): the one-rank NCCL epoch is not bitwise the unsharded epoch")
        check(np.array_equal(runs["plain"][0][0], runs["plain"][1][0]),
              "15(a): the unsharded epoch is not bitwise repeatable")
        model = entry_model(cfg, device, state)
        base = render_pose_host(model, scene, K, c2w, fids, nf, edits, h, w,
                                chunk=cfg.TPU.RENDER_CHUNK, tile_cols=cfg.TPU.TILE_COLS)
        sharded = render_pose_host(model, scene, K, c2w, fids, nf, edits, h, w,
                                   chunk=cfg.TPU.RENDER_CHUNK, tile_cols=cfg.TPU.TILE_COLS,
                                   mesh=mesh)
        check(all(np.array_equal(a, b) for a, b in zip(pose_arrays(base),
                                                        pose_arrays(sharded))),
              "15(a): the one-rank NCCL pose is not bitwise the unsharded pose")
        # the step's collective alone: the flat all_reduce of the last
        # mesh epoch's gradients and metrics, host clock to a sync
        grads_model = runs_model["mesh"]
        params = [p for p in grads_model.parameters() if p.grad is not None]
        raw = _RawMetrics(*torch.zeros(4, device=device).unbind())
        flat_bytes = 4 * (sum(p.numel() for p in params) + len(raw))
        _mean_over_ranks(mesh, params, raw)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(50):
            _mean_over_ranks(mesh, params, raw)
        sync(device)
        all_reduce_ms = (time.perf_counter() - t0) / 50 * 1e3
    finally:
        dist.destroy_process_group()
    on_path = ("fused_field_tc", "field_bwd_tc", "cross_successor",
               "cross_log_transmittance_fwd", "cross_log_transmittance_bwd")
    check(all(launches_a[k] > 0 for k in on_path),
          f"15(a): a kernel of the training path did not launch: {launches_a}")
    s_step = {k: [t / steps for t in v] for k, v in seconds.items()}
    row_a = {"backend": backend, "world_size": 1, "steps": steps, "bitwise_epoch": True,
             "bitwise_pose": True, "s_per_step": s_step,
             "all_reduce_overhead_s_per_step": float(np.mean(s_step["mesh"])
                                                     - np.mean(s_step["plain"])),
             "flat_all_reduce_ms": all_reduce_ms, "flat_all_reduce_bytes": flat_bytes,
             "flat_all_reduce_tensors": len(params),
             "launches": launches_a, "card": card}
    print("distributed_nccl_world1", json.dumps(row_a), flush=True)

    # (b) two processes on this card over gloo
    bundle_pool, tables, width = split_compact_bundle(pool, device)
    n = cfg.SOLVER.IMS_PER_BATCH
    idx = torch.arange(n, device=device) * (bundle_pool.rgb.shape[0] // n)
    batch = make_decode(tables, spec, width)(_take(bundle_pool, idx))
    batch = sort_batch_by_hit(spec, scene, batch)
    shards = [_take(batch, torch.arange(r * n // 2, (r + 1) * n // 2, device=device))
              for r in range(2)]
    work = os.path.join(REPO, "build", "chip_smoke_dist")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.save({"cfg_file": cfg_file, "model": state, "scene": scene, "pose": pose,
                "shards": shards}, os.path.join(work, "inputs.pt"))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(dist_worker, args=(2, free_port(), work, str(device)), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t0
    got = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    check(torch.equal(got[0]["params"], got[1]["params"]),
          "15(b): the two ranks' parameters differ after the step")

    # the in-process reconstruction: (g0 + g1) / 2 and one Adam step
    model = entry_model(cfg, device, state)
    tspec = training_spec(model.spec)
    grads = []
    for r in range(2):
        model.zero_grad(set_to_none=True)
        loss, _ = _losses(model, edits, True, scene, shards[r],
                          torch.Generator(device=device).manual_seed(SEED + 100 + r), 1.0,
                          False, spec=tspec, mask_scale=2.0)
        loss.backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    opt, _ = make_optimizer(cfg, model)
    for p, g0, g1 in zip(model.parameters(), *grads):
        p.grad = (g0 + g1) / 2
    mean_g = flat_grads(model).cpu()
    opt.step()
    g_equal = torch.equal(mean_g, got[0]["grads"])
    p_equal = torch.equal(flat_params(model).cpu(), got[0]["params"])
    diff = float((mean_g - got[0]["grads"]).abs().max())
    check(g_equal and p_equal, f"15(b): reduced gradients bitwise {g_equal} (max diff "
                               f"{diff}), parameters after Adam bitwise {p_equal}")
    one = pose_arrays(base)
    two = got[0]["pose"]
    pose_db = min(psnr(a, b) for a, b in zip(two, one))
    hits_equal = all(np.array_equal(a > 0, b > 0) for a, b in zip(two[-(L + 1):],
                                                                   one[-(L + 1):]))
    check(pose_db >= 60 and hits_equal, f"15(b): sharded pose {pose_db} dB, hit masks "
                                        f"equal {hits_equal}")
    check(all(np.array_equal(a, b) for a, b in zip(got[1]["pose"], two)),
          "15(b): the two ranks hold different poses")
    # LayeredNeuralRenderer(mesh=): both ranks on rank 0's gate and spec,
    # against the renderer in this one process
    fresh = get_cfg()
    fresh.merge_from_file(cfg_file)
    alone = LayeredNeuralRenderer(fresh, device=device)
    ref = pose_arrays(alone.render_pose(*renderer_pose_args(alone)))
    check(got[0]["renderer_state"] == got[1]["renderer_state"]
          == (alone.fidelity_db, str(alone.spec)),
          f"15(b): the ranks' renderers decided {[g['renderer_state'] for g in got]}, the "
          f"one-process renderer {(alone.fidelity_db, str(alone.spec))}")
    renderer_db = min(psnr(a, b) for a, b in zip(got[0]["renderer_pose"], ref))
    check(renderer_db >= 60 and all(np.array_equal(a, b) for a, b in
                                    zip(got[0]["renderer_pose"], got[1]["renderer_pose"])),
          f"15(b): the sharded renderer's pose {renderer_db} dB against one process")
    launches_b = {k: got[0]["launches"][k] + got[1]["launches"][k] for k in got[0]["launches"]}
    check(all(g["launches"][k] > 0 for g in got for k in on_path),
          f"15(b): a kernel of the path did not launch on a rank: "
          f"{[g['launches'] for g in got]}")
    row_b = {"backend": "gloo", "world_size": 2, "processes_on_one_card": True,
             "grads_bitwise": bool(g_equal), "params_bitwise": bool(p_equal),
             "pose_db_vs_one_process": pose_db, "pose_bitwise": bool(pose_db == float("inf")),
             "hit_masks_equal": bool(hits_equal), "loss": [g["loss"] for g in got],
             "renderer_pose_db_vs_one_process": renderer_db,
             "renderer_fidelity_db": got[0]["renderer_state"][0],
             "launches": launches_b, "spawn_s": spawn_s,
             "times_not_a_speed_figure_two_processes_share_one_card": {
                 "step_s": [g["step_s"] for g in got], "pose_s": [g["pose_s"] for g in got]},
             "card": card}
    print("distributed_gloo_two_processes", json.dumps(row_b), flush=True)
    for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        os.environ.pop(key, None)
    return {"nccl": row_a, "gloo": row_b}


def write_quad(root: str, K, c2w, h: int, w: int, depth: float) -> str:
    """A textured quad that fills the view of camera (K, c2w) at ``depth``
    (camera z), as an OBJ with its MTL and a PNG texture under ``root`` ->
    the OBJ's path."""
    from stnerf_tpu_torch.data.png import write_png

    os.makedirs(root, exist_ok=True)
    corners = np.array([[-1, -1], [w + 1, -1], [w + 1, h + 1], [-1, h + 1]], np.float64)
    cam = np.linalg.inv(np.asarray(K, np.float64)) @ np.concatenate(
        [corners, np.ones((4, 1))], 1).T * depth                  # (3, 4)
    c2w = np.asarray(c2w, np.float64)
    world = (c2w[:3, :3] @ cam).T + c2w[:3, 3]
    tex = np.zeros((32, 32, 3), np.uint8)
    tex[..., 0] = np.arange(32)[None, :] * 8
    tex[..., 1] = np.arange(32)[:, None] * 8
    tex[..., 2] = 96
    write_png(os.path.join(root, "wall.png"), tex)
    with open(os.path.join(root, "wall.mtl"), "w") as f:
        f.write("newmtl wall\nmap_Kd wall.png\n")
    path = os.path.join(root, "wall.obj")
    with open(path, "w") as f:
        f.write("mtllib wall.mtl\n")
        f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in world)
        f.write("vt 0 1\nvt 1 1\nvt 1 0\nvt 0 0\nf 1/1 2/2 3/3 4/4\n")
    return path


def phase_legacy_renderer(device, cfg_file: str, card: str) -> dict:
    """Phase 16: ``NeuralRenderer`` on phase 11's last checkpoint, each
    layer's nets as a background-only field (a performer's without its
    motion net: the legacy renderer's fields are per frame), through K1,
    at the config's test size from the scene's first camera; with a
    textured quad behind the scene as the mesh background, rasterized by
    the native library. Checks: finite images, ``mix_image``'s z-buffer
    the nearest layer's depth, K1's launches (fields x chunks x 2 stages),
    K1 against its plain version >= 40 dB on one field's rays ->
    summary."""
    import torch

    from stnerf_tpu_torch.config import get_cfg
    from stnerf_tpu_torch.data import native
    from stnerf_tpu_torch.data.cameras import pixel_rays
    from stnerf_tpu_torch.engine import latest_checkpoint, load_params_any
    from stnerf_tpu_torch.models import EditState, LayeredModel, RayInputs, SceneBoxes, render_rays
    from stnerf_tpu_torch.render import FieldEntry, NeuralRenderer

    cfg = get_cfg()
    cfg.merge_from_file(cfg_file)
    ckpt = latest_checkpoint(cfg.OUTPUT_DIR)
    trained = load_params_any(ckpt, entry_model(cfg, device))
    spec = trained.spec
    L = spec.layer_num
    (K, c2w, _, _, h, w), pool_scene = entry_pose(cfg, device)
    nf = pool_scene.bkgd_near_far.cpu().numpy()
    nr = NeuralRenderer(output_dir=os.path.join(REPO, "build", "chip_smoke_legacy"))
    for layer in range(L + 1):
        # exact semantics: the legacy renderer has no fidelity gate
        one = dataclasses.replace(spec, layer_num=0, fast_fine=False, coarse_exit_segments=0,
                                  **({} if layer == 0 else dict(
                                      bkgd_use_space_time=spec.use_space_time,
                                      bkgd_use_deform_time=False)))
        field = LayeredModel(one, device=device)
        if layer == 0:
            for name in ("bkgd_coarse", "bkgd_fine", "bkgd_motion"):
                if getattr(field, name) is not None:
                    getattr(field, name).load_state_dict(getattr(trained, name).state_dict())
            bbox = pool_scene.bkgd_box
        else:
            field.bkgd_coarse.load_state_dict(trained.layers_coarse[layer - 1].state_dict())
            field.bkgd_fine.load_state_dict(trained.layers_fine[layer - 1].state_dict())
            bbox = pool_scene.boxes[0, layer - 1]
        nr.add_model(0, layer, FieldEntry(field, one, bbox.cpu().numpy(), nf))
    check(native.available(), "the native host library did not build")
    obj = write_quad(os.path.join(REPO, "build", "chip_smoke_legacy", "mesh"), K, c2w, h, w,
                     depth=float(nf[1]))    # behind the scene: the fields win in front
    nr.set_bkgd_mesh(obj)
    chunks = -(-h * w // 8192)

    out = {}
    for name, use_mesh in (("fields", False), ("mesh_background", True)):
        zero_launches()
        sync(device)
        t0 = time.perf_counter()
        colors, depths = [], []
        if use_mesh:
            c, d = nr.render_bkgd(c2w, K, h, w)
            colors.append(c)
            depths.append(d)
        for layer in range(1 if use_mesh else 0, L + 1):
            c, d = nr.render_frame_layer(0, layer, c2w, K, h, w)
            colors.append(c)
            depths.append(d)
        mixed, zbuf = NeuralRenderer.mix_image(colors, depths)
        sync(device)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        fields = L + (0 if use_mesh else 1)
        check(launches["fused_field"] == fields * chunks * 2,
              f"16 {name}: K1 launched {launches['fused_field']} times, the renders imply "
              f"{fields * chunks * 2}")
        check(launches["fused_field_tc"] == launches["fused_field"],
              f"16 {name}: bf16 fields off the tensor-core route")
        check(mixed.shape == (h, w, 3) and np.isfinite(mixed).all()
              and mixed.min() >= 0 and mixed.max() <= 1, f"16 {name}: the mix is not an image")
        check(np.array_equal(zbuf, np.minimum.reduce(depths)),
              f"16 {name}: mix_image's z-buffer is not the nearest layer's depth")
        pose_mixed, pose_zbuf = nr.render_pose(0, c2w, K, h, w, use_mesh_bkgd=use_mesh)
        check(np.array_equal(pose_mixed, mixed) and np.array_equal(pose_zbuf, zbuf),
              f"16 {name}: render_pose differs from its layers' mix")
        hit = np.isfinite(zbuf)
        out[name] = {"s_per_pose": seconds, "launches": launches, "covered": float(hit.mean()),
                     "nearest_share_by_layer": [float(((d == zbuf) & hit).mean())
                                                for d in depths]}
    check(out["mesh_background"]["covered"] > 0.95,
          f"16: the quad covers {out['mesh_background']['covered']} of the view")

    # K1 against its plain version on the background field's rays
    e = nr.models[0][0]
    rays = pixel_rays(np.asarray(K, np.float32), np.asarray(c2w, np.float32), h, w)
    rays = torch.as_tensor(rays[:8192], device=device)
    m = rays.shape[0]
    inputs = RayInputs(rays[:, :3], rays[:, 3:6], torch.ones(m, 1, device=device),
                       torch.zeros(m, device=device),
                       torch.as_tensor(nf, device=device).expand(m, 2))
    scene0 = SceneBoxes(torch.as_tensor(e.bbox, device=device),
                        torch.zeros(1, 0, 2, 3, device=device),
                        torch.as_tensor(nf, device=device))
    edits0 = EditState.identity(0, device=device)
    with torch.no_grad():
        k1, plain = (render_rays(e.params, scene0, inputs, edits0, None, plain=p).fine.color
                     for p in (False, True))
    k1_db = psnr(k1.float().cpu().numpy(), plain.float().cpu().numpy())
    check(k1_db >= 40, f"16: K1 vs plain on the legacy field {k1_db} dB < 40")
    row = {**out, "k1_vs_plain_db": k1_db, "checkpoint": os.path.basename(ckpt),
           "size": [w, h], "card": card}
    print("legacy_renderer", json.dumps(row), flush=True)
    return row


def performer_of(name: str):
    """The performer whose field or motion net parameter ``name`` belongs
    to, or None for the replicated groups."""
    group, _, rest = name.partition(".")
    return int(rest.split(".")[0]) if group in ("layers_coarse", "layers_fine",
                                                "motion") else None


def state_bytes(model, opt) -> dict:
    """Bytes a rank holds: every parameter (resident), those it trains (a
    gradient this step: the background's and its own performers'), their
    gradients, and the optimizer's state tensors."""
    import torch

    trained = [p for p in model.parameters() if p.grad is not None]
    return {"params_resident": sum(p.numel() * p.element_size() for p in model.parameters()),
            "params_trained": sum(p.numel() * p.element_size() for p in trained),
            "params_trained_count": sum(p.numel() for p in trained),
            "grads": sum(p.grad.numel() * p.grad.element_size() for p in trained),
            "adam": sum(t.numel() * t.element_size() for s in opt.state.values()
                        for t in s.values() if isinstance(t, torch.Tensor))}


def model_axis_worker(rank: int, world: int, port: int, work: str, device: str,
                      backend: str):
    """One rank of phase 17 on a (world / 2, 2) mesh: over gloo with every
    process on ``device``, or over NCCL with rank r on card r. A
    layer-sharded step on its data row's batch; on a (1, 2) mesh also a
    do_train epoch and the first gt pose. The launches of each part, the
    gathers' bytes (every call of the byte gather), the bytes held and
    the host seconds go to ``work``/rank<r>.pt."""
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from stnerf_tpu_torch.config import get_cfg
    from stnerf_tpu_torch.engine import do_train, make_optimizer, make_train_step
    from stnerf_tpu_torch.models import EditState
    from stnerf_tpu_torch.parallel import init_distributed, make_mesh, shard_params
    from stnerf_tpu_torch.parallel import mesh as mesh_module
    from stnerf_tpu_torch.render import render_pose_host

    set_rank_env(rank, world, port)
    device = init_distributed(f"cuda:{rank}" if backend == "nccl" else device,
                              backend=backend)
    mesh = make_mesh(model_parallel=2, device=device)
    blob = torch.load(os.path.join(work, "inputs.pt"), map_location=device,
                      weights_only=False)
    cfg = get_cfg()
    cfg.merge_from_file(blob["cfg_file"])
    scene = type(blob["scene"])(*(t.to(device) for t in blob["scene"]))
    gathered = []
    gather = mesh_module._gather_bytes

    def counted_gather(group, n, index, local):
        gathered.append(n * local.numel())
        return gather(group, n, index, local)

    mesh_module._gather_bytes = counted_gather
    out = {"mesh": [mesh.data, mesh.model, mesh.rank, mesh.model_rank, mesh.is_main],
           "backend": mesh.backend, "device": str(device)}

    model = shard_params(mesh, entry_model(cfg, device, blob["model"]))
    opt, sched = make_optimizer(cfg, model)
    step = make_train_step(model, opt, sched, remove_outliers=True, device=device, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(SEED + 100 + mesh.rank)
    zero_launches()
    gathered.clear()
    sync(device)
    t0 = time.perf_counter()
    m = step(scene, blob["batches"][mesh.rank], gen, 1.0)
    sync(device)
    seconds = time.perf_counter() - t0
    out["step"] = {"s": seconds, "loss": float(m.loss), "launches": read_launches(),
                   "gather_bytes": list(gathered), "bytes": state_bytes(model, opt),
                   "performers": list(model.performers()),
                   "grads": {n: p.grad.cpu() for n, p in model.named_parameters()
                             if p.grad is not None},
                   "params": {n: p.detach().cpu() for n, p in model.named_parameters()
                              if p.grad is not None}}
    if mesh.data == 1:
        quiet = logging.getLogger(f"chip_smoke.model_axis.{rank}")
        quiet.propagate = False
        cfg.OUTPUT_DIR = os.path.join(work, "sharded")
        cfg.SOLVER.MAX_EPOCHS, cfg.SOLVER.COARSE_STAGE = 2, 1    # one full epoch
        model = shard_params(mesh, entry_model(cfg, device, blob["model"]))
        zero_launches()
        sync(device)
        t0 = time.perf_counter()
        hist = do_train(cfg, model, scene, blob["pool"], mesh=mesh, seed=SEED, logger=quiet,
                        device=device)
        sync(device)
        out["epoch"] = {"s": time.perf_counter() - t0, "loss": hist[0][1].loss,
                        "launches": read_launches()}
        model = shard_params(mesh, entry_model(cfg, device, blob["model"]))
        K, c2w, fids, nf, h, w = blob["pose"]
        zero_launches()
        gathered.clear()
        sync(device)
        t0 = time.perf_counter()
        pose = render_pose_host(model, scene, K, c2w, fids, nf,
                                EditState.identity(cfg.DATASETS.LAYER_NUM, device=device),
                                h, w, chunk=cfg.TPU.RENDER_CHUNK, tile_cols=cfg.TPU.TILE_COLS,
                                mesh=mesh)
        out["pose"] = {"s": time.perf_counter() - t0, "arrays": pose_arrays(pose),
                       "launches": read_launches(), "gather_bytes": list(gathered)}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def compare_named(got: dict, ref: dict) -> tuple:
    """(every tensor of ``got`` bitwise ``ref``'s under its name, the
    largest absolute difference)."""
    import torch

    same = all(torch.equal(t, ref[n]) for n, t in got.items())
    diff = max(float((t - ref[n]).abs().max()) for n, t in got.items())
    return same, diff


def phase_model_axis(device, cfg_file: str, card: str,
                     parts: tuple = ("1x2", "2x2", "2x2_nccl")) -> dict:
    """Phase 17, the model axis, on phase 11's entry-point config (the
    taekwondo widths, L = 2, 90+30 samples, bf16, batch 2000, the
    compositor kernels on), each performer field on one model rank
    (``parallel.shard_params``).

    (a) "1x2": two processes on this card over gloo, a (1, 2) mesh: one
    step on the whole 2000-ray batch, each rank's gradients (the
    background's and its own performer's) and parameters after Adam
    bitwise the in-process unsharded step's, K1 and K2 launched 4 times a
    rank (2 fields x 2 stages); a do_train epoch of 20 steps whose losses
    and checkpoints (mid-epoch and the epoch's) are bitwise the unsharded
    run's; the first gt pose through render_pose_host(mesh=) bitwise the
    unsharded pose. (b) "2x2": four processes on this card over gloo, a
    (2, 2) mesh, one step with each data row on its fixed half of the
    batch: every rank bitwise the in-process reconstruction ((g0 + g1) /
    2, one Adam step). (c) "2x2_nccl": (b) over NCCL, one card a rank,
    where the machine has four; with fewer it prints why it did not run.
    Per rank: the launches, the bytes of parameters and Adam state (beside
    the unsharded step's), the bytes of every gather and of the flat
    reduction; host seconds under a key that says they are no speed
    figure. -> summary dict (launches by path)."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    from stnerf_tpu_torch.config import get_cfg
    from stnerf_tpu_torch.data import make_train_data
    from stnerf_tpu_torch.engine import (do_train, make_decode, make_optimizer,
                                         make_train_step, sort_batch_by_hit,
                                         split_compact_bundle, training_spec)
    from stnerf_tpu_torch.engine.trainer import _losses, _take
    from stnerf_tpu_torch.models import EditState, LayeredSpec
    from stnerf_tpu_torch.render import render_pose_host

    cfg = get_cfg()
    cfg.merge_from_file(cfg_file)
    spec = LayeredSpec.from_cfg(cfg)
    L = cfg.DATASETS.LAYER_NUM
    pool, scene = make_train_data(cfg, spec, np.random.default_rng(SEED), workers=1,
                                  device=device)
    state = {k: v.clone() for k, v in entry_model(cfg, device).state_dict().items()}
    pose, _ = entry_pose(cfg, device)
    bundle_pool, tables, width = split_compact_bundle(pool, device)
    n = cfg.SOLVER.IMS_PER_BATCH
    idx = torch.arange(n, device=device) * (bundle_pool.rgb.shape[0] // n)
    batch = sort_batch_by_hit(spec, scene, make_decode(tables, spec, width)(
        _take(bundle_pool, idx)))
    halves = [_take(batch, torch.arange(r * n // 2, (r + 1) * n // 2, device=device))
              for r in range(2)]
    edits = EditState.identity(L, device=device)
    root = os.path.join(REPO, "build", "chip_smoke_model_axis")
    shutil.rmtree(root, ignore_errors=True)

    # the in-process references: the unsharded step on the whole batch, and
    # the reconstruction of the (2, 2) step from the halves
    model = entry_model(cfg, device, state)
    opt, sched = make_optimizer(cfg, model)
    zero_launches()
    make_train_step(model, opt, sched, remove_outliers=True, device=device)(
        scene, batch, torch.Generator(device=device).manual_seed(SEED + 100), 1.0)
    unsharded = {"launches": read_launches(), "bytes": state_bytes(model, opt),
                 "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
                 "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}
    model = entry_model(cfg, device, state)
    tspec = training_spec(model.spec)
    grads = []
    for r in range(2):
        model.zero_grad(set_to_none=True)
        loss, _ = _losses(model, edits, True, scene, halves[r],
                          torch.Generator(device=device).manual_seed(SEED + 100 + r), 1.0,
                          False, spec=tspec, mask_scale=2.0)
        loss.backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    opt, _ = make_optimizer(cfg, model)
    for p, g0, g1 in zip(model.parameters(), *grads):
        p.grad = (g0 + g1) / 2
    halves_ref = {"grads": {n: p.grad.cpu() for n, p in model.named_parameters()}}
    opt.step()
    halves_ref["params"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
    names = set(unsharded["grads"])

    def run(part: str, world: int, backend: str) -> list:
        work = os.path.join(root, part)
        os.makedirs(work)
        torch.save({"cfg_file": cfg_file, "model": state, "scene": scene, "pose": pose,
                    "pool": pool, "batches": [batch] if world == 2 else halves},
                   os.path.join(work, "inputs.pt"))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mp.spawn(model_axis_worker, args=(world, free_port(), work, str(device), backend),
                 nprocs=world, join=True)
        spawn_s = time.perf_counter() - t0
        got = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
               for r in range(world)]
        check([g["mesh"] for g in got] == [[world // 2, 2, r // 2, r % 2, r == 0]
                                           for r in range(world)],
              f"17 {part}: the ranks' places {[g['mesh'] for g in got]}")
        for r, g in enumerate(got):
            s = g["step"]
            check(s["performers"] == [r % 2], f"17 {part}: rank {r} owns {s['performers']}")
            mine = {n for n in names if performer_of(n) in (None, r % 2)}
            check(set(s["grads"]) == mine, f"17 {part}: rank {r} has gradients "
                  f"{sorted(names ^ set(s['grads']))[:4]}... apart from its own")
            launches = s["launches"]
            check(launches["fused_field"] == launches["fused_field_tc"] == 4
                  and launches["field_bwd"] == launches["field_bwd_tc"] == 4,
                  f"17 {part}: rank {r}'s step launched K1 {launches['fused_field']}, K2 "
                  f"{launches['field_bwd']} times (2 fields x 2 stages: 4)")
            check(all(launches[k] > 0 for k in ("cross_successor",
                                                "cross_log_transmittance_fwd",
                                                "cross_log_transmittance_bwd")),
                  f"17 {part}: rank {r}'s step launched no K4/K5: {launches}")
        return got, spawn_s

    out = {}
    if "1x2" in parts:
        got, spawn_s = run("1x2", 2, "gloo")
        step_same = [compare_named(g["step"]["grads"], unsharded["grads"]) for g in got]
        param_same = [compare_named(g["step"]["params"], unsharded["params"]) for g in got]
        check(all(s for s, _ in step_same + param_same),
              f"17(a): the sharded step's gradients {step_same} and parameters {param_same} "
              "are not bitwise the unsharded step's")
        # the unsharded epoch, its checkpoints and the pose
        work = os.path.join(root, "1x2")
        ecfg = get_cfg()
        ecfg.merge_from_file(cfg_file)
        ecfg.OUTPUT_DIR = os.path.join(work, "plain")
        ecfg.SOLVER.MAX_EPOCHS, ecfg.SOLVER.COARSE_STAGE = 2, 1
        quiet = logging.getLogger("chip_smoke.model_axis")
        quiet.propagate = False
        hist = do_train(ecfg, entry_model(cfg, device, state), scene, pool, seed=SEED,
                        logger=quiet, device=device)
        for g in got:
            check(np.array_equal(g["epoch"]["loss"], hist[0][1].loss),
                  "17(a): the sharded epoch's losses are not bitwise the unsharded epoch's")
        files = sorted(os.listdir(ecfg.OUTPUT_DIR))
        check(files == sorted(os.listdir(os.path.join(work, "sharded"))) and len(files) == 2,
              f"17(a): checkpoint files {files}")
        for f in files:
            a, b = (torch.load(os.path.join(work, d, f), map_location="cpu", weights_only=True)
                    for d in ("plain", "sharded"))
            sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
            same = (a["model"].keys() == b["model"].keys()
                    and all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
                    and sa.keys() == sb.keys()
                    and all(sa[k].keys() == sb[k].keys()
                            and all(torch.equal(sa[k][x], sb[k][x]) for x in sa[k])
                            for k in sa)
                    and a["scheduler"] == b["scheduler"] and a["step"] == b["step"])
            check(same, f"17(a): checkpoint {f} is not the unsharded run's key for key")
        K, c2w, fids, nf, h, w = pose
        base = render_pose_host(entry_model(cfg, device, state), scene, K, c2w, fids, nf, edits,
                                h, w, chunk=cfg.TPU.RENDER_CHUNK, tile_cols=cfg.TPU.TILE_COLS)
        for g in got:
            check(all(np.array_equal(a, b) for a, b in zip(g["pose"]["arrays"],
                                                           pose_arrays(base))),
                  "17(a): the sharded pose is not bitwise the unsharded pose")
        steps = len(hist[0][1].loss)
        for g in got:
            e = g["epoch"]["launches"]
            check(e["fused_field_tc"] == e["field_bwd_tc"] == steps * 2 * 2,
                  f"17(a): the epoch's K1/K2 launches a rank {e['fused_field_tc']} / "
                  f"{e['field_bwd_tc']}, {steps} steps x 2 stages x 2 fields")
            check(g["pose"]["launches"]["fused_field_tc"] > 0, "17(a): the pose launched no K1")
        launches = {k: sum(g[part]["launches"][k] for g in got for part in ("step", "epoch",
                                                                           "pose"))
                    for k in got[0]["step"]["launches"]}
        row = {"mesh": "(1, 2)", "backend": "gloo", "processes_on_one_card": True,
               "step_grads_bitwise": True, "step_params_bitwise": True,
               "epoch_steps": steps, "epoch_losses_bitwise": True, "checkpoints_bitwise": files,
               "pose_bitwise": True,
               "k1_k2_launches_per_rank_step": [[g["step"]["launches"]["fused_field_tc"],
                                                 g["step"]["launches"]["field_bwd_tc"]]
                                                for g in got],
               "k1_launches_unsharded_step": unsharded["launches"]["fused_field_tc"],
               "k2_launches_unsharded_step": unsharded["launches"]["field_bwd_tc"],
               "bytes_per_rank": [g["step"]["bytes"] for g in got],
               "bytes_unsharded": unsharded["bytes"],
               "gather_bytes_step": [g["step"]["gather_bytes"] for g in got],
               "gather_bytes_pose": [sum(g["pose"]["gather_bytes"]) for g in got],
               "gather_calls_pose": [len(g["pose"]["gather_bytes"]) for g in got],
               "flat_reduction_bytes": 0, "launches": launches, "spawn_s": spawn_s,
               "times_not_a_speed_figure_two_processes_share_one_card": {
                   "step_s": [g["step"]["s"] for g in got],
                   "epoch_s": [g["epoch"]["s"] for g in got],
                   "pose_s": [g["pose"]["s"] for g in got]},
               "card": card}
        print("model_axis_1x2", json.dumps(row), flush=True)
        out["1x2"] = row
    for part, backend in (("2x2", "gloo"), ("2x2_nccl", "nccl")):
        if part not in parts:
            continue
        if backend == "nccl" and torch.cuda.device_count() < 4:
            row = {"ran": False, "why": f"{torch.cuda.device_count()} card(s): NCCL takes one "
                   "card a rank and refuses two ranks on one card", "card": card}
            print(f"model_axis_{part}", json.dumps(row), flush=True)
            out[part] = row
            continue
        got, spawn_s = run(part, 4, backend)
        same = [compare_named(g["step"]["grads"], halves_ref["grads"]) for g in got]
        psame = [compare_named(g["step"]["params"], halves_ref["params"]) for g in got]
        check(all(s for s, _ in same + psame),
              f"17 {part}: the (2, 2) step's gradients {same} and parameters {psame} are not "
              "bitwise the reconstruction's")
        launches = {k: sum(g["step"]["launches"][k] for g in got)
                    for k in got[0]["step"]["launches"]}
        row = {"mesh": "(2, 2)", "backend": backend, "processes_on_one_card": backend == "gloo",
               "devices": [g["device"] for g in got], "grads_bitwise": True,
               "params_bitwise": True,
               "k1_k2_launches_per_rank_step": [[g["step"]["launches"]["fused_field_tc"],
                                                 g["step"]["launches"]["field_bwd_tc"]]
                                                for g in got],
               "bytes_per_rank": [g["step"]["bytes"] for g in got],
               "gather_bytes_step": [g["step"]["gather_bytes"] for g in got],
               "flat_reduction_bytes": [4 * (sum(t.numel() for t in g["step"]["grads"].values())
                                             + 4) for g in got],
               "loss": [g["step"]["loss"] for g in got], "launches": launches,
               "spawn_s": spawn_s, "card": card,
               ("times_not_a_speed_figure_four_processes_share_one_card" if backend == "gloo"
                else "times_not_a_speed_figure_one_step_after_start_up"): {
                   "step_s": [g["step"]["s"] for g in got]}}
        print(f"model_axis_{part}", json.dumps(row), flush=True)
        out[part] = row
    for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        os.environ.pop(key, None)
    return out


TRAINED = os.path.join(REPO, "tests", "torch_fixtures", "trained_synthetic")


def trained_cfg(meta: dict, scene_root: str, dtype: str = "bfloat16"):
    """The convergence A/B's config (its file and ``merge_from_list``
    overrides, recorded in the fixture's curve.json) on ``scene_root``, in
    ``dtype``."""
    from stnerf_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, meta["config"]))
    cfg.merge_from_list(meta["opts"])
    cfg.DATASETS.TRAIN = scene_root
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.OUTPUT_DIR = ""
    return cfg


def trained_band(meta: dict) -> list:
    """Phase 18(a)'s bar: per epoch, the range of the fixture's sound runs
    (both packages' float32 CPU runs: three JAX seeds, the port's two
    forms at two seeds, and each package from the initial weights nudged
    one float32 ulp), widened on each side by max(0.5 dB, half the range):
    a curve that a reordered sum moves stays inside, one that learns more
    slowly or not at all leaves it where the runs agree (epochs 1-4)."""
    out = []
    for lo, hi in meta["sound_range"]:
        m = max(meta["bar_db"], (hi - lo) / 2)
        out.append([lo - m, hi + m])
    return out


def trained_setup(device) -> tuple:
    """Phase 18's fixture, config, pool and views -> (meta, cfg, root,
    pool, scene, views)."""
    from stnerf_tpu_torch.data import ViewScene, make_synthetic_scene, make_train_data
    from stnerf_tpu_torch.models import LayeredSpec

    with open(os.path.join(TRAINED, "curve.json")) as f:
        meta = json.load(f)
    root = os.path.join(REPO, "build", "chip_smoke_synthetic")  # phase 11's scene
    if not os.path.exists(os.path.join(root, "pose", "K.txt")):
        make_synthetic_scene(root, width=200, height=150, num_cams=12, num_frames=5,
                             layer_num=2, seed=SEED)
    cfg = trained_cfg(meta, root)
    # the A/B's pool: built serially (spawned workers draw another pool)
    pool, scene = make_train_data(cfg, LayeredSpec.from_cfg(cfg), np.random.default_rng(0),
                                  workers=1, device=device)
    return meta, cfg, root, pool, scene, ViewScene(cfg)


def train_trained(device, setup: tuple, kernel: bool, seed: int = SEED,
                  nudged: bool = False, dtype: str = "bfloat16") -> tuple:
    """``do_train`` of the A/B's model in ``dtype`` from the fixture's
    initial weights (each nudged one float32 ulp up where ``nudged``),
    sort-free where ``kernel`` -> (PSNR per epoch, history, seconds,
    launches)."""
    import torch

    from stnerf_tpu_torch.engine import do_evaluate, do_train, load_params_any
    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec

    meta, cfg, _, pool, scene, views = setup
    cfg = cfg.clone()
    cfg.TPU.COMPOSITOR_KERNEL = kernel
    cfg.TPU.COMPUTE_DTYPE = dtype
    spec = LayeredSpec.from_cfg(cfg)
    model = load_params_any(os.path.join(TRAINED, meta["init"]),
                            LayeredModel(spec, device=device))
    if nudged:
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    curve = []

    def val_fn(m, epoch):
        with torch.no_grad():
            curve.append(do_evaluate(m, spec, scene, views, meta["views"], meta["frames"],
                                     chunk=cfg.TPU.RENDER_CHUNK)["psnr"])

    logger = logging.getLogger("chip_smoke.trained")
    logger.setLevel(logging.WARNING)
    zero_launches()
    t0 = time.perf_counter()
    history = do_train(cfg, model, scene, pool, val_fn=val_fn, seed=seed, logger=logger,
                       device=device)
    sync(device)
    return curve, history, time.perf_counter() - t0, read_launches()


def phase_trained_synthetic(device, card: str) -> dict:
    """Phase 18: the convergence A/B's model on the card, against the
    fixture that JAX trained on the CPU (tests/torch_fixtures/
    trained_synthetic, written by tools/torch_convergence_ab.py). (a) The
    port trains it from the fixture's initial parameters, under the A/B's
    config and schedule, in bf16 through K1/K2, once sort-free (K4/K5) and
    once on the sorted merge; after every epoch the mean PSNR on the A/B's
    fixed views must lie in :func:`trained_band` (the float32 runs' range,
    widened). (b) The fixture's JAX-trained checkpoint rendered in each
    edit case at 100x75 through K1, on the exact path in bf16 and with the
    config's approximations (gate off) in bf16 and float32: each case's
    image against JAX's renders of the same path >= 40 dB (the
    approximations in bf16: 28), each layer's >= 35 dB on the exact path,
    and K1 >= 40 dB against its plain version on every image. (c) On that
    checkpoint and one batch, a step through the kernels (bf16) against the
    plain versions in bf16 (relative L2 <= 1e-2 per leaf, phase 5's bar)
    and in float32 (printed: the trained model's bf16 finding)."""
    import shutil

    import torch

    from stnerf_tpu_torch.engine import (load_params_any, make_optimizer,
                                         make_train_step)
    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec, export_jax_params
    from stnerf_tpu_torch.render import LayeredNeuralRenderer
    from stnerf_tpu_torch.render.pose_device import render_pose_host

    t_phase = time.perf_counter()
    failed = []

    def check(cond, msg: str):  # every part runs; the phase fails at its end
        if not cond:
            print(f"chip_smoke check failed: {msg}", flush=True)
            failed.append(msg)
    setup = trained_setup(device)
    meta, cfg, root, pool, scene, _ = setup
    with open(os.path.join(TRAINED, "renders.npz"), "rb") as f:
        jax_renders = dict(np.load(f))
    band = trained_band(meta)
    out = {"card": card, "train": {}}

    # (a) both training compositor forms from the fixture's initial weights
    for form, kernel in (("nosort", True), ("sorted", False)):
        curve, history, seconds, launches = train_trained(device, setup, kernel)
        lp1 = LayeredSpec.from_cfg(cfg).layer_num + 1
        steps = sum(len(m.loss) for _, m in history)
        full = sum(len(m.loss) for e, m in history if e >= cfg.SOLVER.COARSE_STAGE)
        row = {"psnr": curve, "band_db": band,
               "jax_f32_psnr": meta["runs"]["a"]["psnr"],
               "s": seconds, "steps": steps,
               "losses_finite": all(bool(np.isfinite(m.loss).all()) for _, m in history),
               "launches": {k: v for k, v in launches.items() if v}}
        print(f"trained_synthetic_train_{form}", json.dumps(row), flush=True)
        check(row["losses_finite"], f"18(a) {form}: a loss is not finite")
        check(len(curve) == len(band) and all(lo <= c <= hi for c, (lo, hi) in zip(curve, band)),
              f"18(a) {form}: PSNR per epoch {curve} outside the sound runs' band {band}")
        # K1 and K2 once per field and stage of every step, on the
        # tensor-core route, and K1 per field, stage and chunk of every
        # evaluated view; K4/K5 once per stage of every step, sort-free only
        stages = steps + full
        w, h = cfg.INPUT.SIZE_TEST
        evals = len(curve) * len(meta["views"]) * len(meta["frames"]) * 2 * lp1
        k1 = stages * lp1 + evals * -(-w * h // cfg.TPU.RENDER_CHUNK)
        check(launches["field_bwd_tc"] == launches["field_bwd"] == stages * lp1,
              f"18(a) {form}: K2 launched {launches['field_bwd_tc']} "
              f"({launches['field_bwd']}), {stages * lp1} implied")
        check(launches["fused_field_tc"] == launches["fused_field"] == k1,
              f"18(a) {form}: K1 launched {launches['fused_field']} "
              f"({launches['fused_field_tc']} tensor-core), {k1} implied")
        for name in ("cross_successor", "cross_log_transmittance_fwd",
                     "cross_log_transmittance_bwd"):
            want = stages if kernel else 0
            check(launches[name] == want,
                  f"18(a) {form}: {name} launched {launches[name]}, {want} implied")
        out["train"][form] = row

    # (b) the JAX-trained checkpoint, each edit case at 100x75: on the exact
    # path in bf16, and with the config's approximations (gate off) in bf16
    # and in float32 (K1's CUDA-core route). Bars (dB against JAX's float32
    # renders of the same path; the mixed colour, then each layer's): the
    # exact path 40 and 35 (bf16's rounding: the plain bf16 path reads 37.5-
    # 40.8 dB on the second performer's layer); the approximations 28 in
    # bf16 (the plain bf16 path reads 30.4-31.6 dB: on this checkpoint they
    # are 16 dB from the exact path, and the gate refuses them) and 40 in
    # float32 (the port reads 74.4 dB on the CPU); K1 against its plain
    # version 40 on every image
    bars = {("exact", "bfloat16"): (40.0, 35.0), ("defaults", "bfloat16"): (28.0, None),
            ("defaults", "float32"): (40.0, None)}
    renders, k1_vs_plain, plain_vs_jax, boxes_equal, launches = {}, {}, {}, {}, {}
    render_s = 0.0
    for (path, dtype), (bar, layer_bar) in bars.items():
        tag = f"{path}_{'bf16' if dtype == 'bfloat16' else 'f32'}"
        ckpt_dir = os.path.join(REPO, "build", f"chip_smoke_trained_{tag}")
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        os.makedirs(ckpt_dir)
        shutil.copy(os.path.join(TRAINED, meta["checkpoint"]), ckpt_dir)
        rcfg = trained_cfg(meta, root, dtype)
        rcfg.INPUT.SIZE_TEST = meta["render_size"]
        rcfg.OUTPUT_DIR = ckpt_dir
        for k, v in meta["render_paths"][path].items():
            rcfg.TPU[k] = v
        counts = {}
        for name, kwargs, hidden, frame in meta["render_cases"]:
            r = LayeredNeuralRenderer(rcfg, device=device, **kwargs)
            check(r._ckpt_path.endswith(meta["checkpoint"]), f"18(b): loaded {r._ckpt_path}")
            check((r.scene is not r._exact_scene) == (path != "exact"),
                  f"18(b) {tag}: the renderer's approximations are "
                  f"{'off' if path != 'exact' else 'on'}")
            if path != "exact":
                boxes_equal[tag] = bool(np.array_equal(np.asarray(r.scene.boxes.cpu()),
                                                       jax_renders[f"{path}_boxes"]))
            if hidden is not None:
                r.hide_layer(hidden)
            pairs = [(0, 1.0)] + [(l, frame) for l in range(1, r.layer_num + 1)]
            pose, K = np.asarray(r.gt_poses[0]), np.asarray(r.gt_Ks[0])
            layers = list(range(r.layer_num + 1))
            zero_launches()
            t0 = time.perf_counter()
            c, _, cl, _ = r.render_pose(pose, K, pairs, frame_idx=0, download_layers=layers)
            sync(device)
            render_s += time.perf_counter() - t0
            for k, v in read_launches().items():
                counts[k] = counts.get(k, 0) + v
            # the same pose through the plain field in the same dtype: the
            # kernel's share of any difference from JAX's float32 renders
            fids = np.array([f for _, f in sorted(pairs)], np.float32)
            pc, _, pcl, _ = render_pose_host(
                r.model, r.scene, K, pose, fids, r.dataset.near_far, r._edits(0, 0, 0),
                r.height, r.width, chunk=rcfg.TPU.RENDER_CHUNK,
                tile_cols=rcfg.TPU.TILE_COLS, far_clip=r.far, download_layers=layers,
                spec=r.spec, plain=True)
            got, plain = np.concatenate([c, *cl], -1), np.concatenate([pc, *pcl], -1)
            want = jax_renders[f"{path}_{name}"].astype(np.float32)  # exact: + layers

            def dbs(x, y):
                return [psnr(x[..., i:i + 3], y[..., i:i + 3])
                        for i in range(0, x.shape[-1], 3)]

            key, n = f"{tag}_{name}", want.shape[-1]
            renders[key], k1_vs_plain[key] = dbs(got[..., :n], want), dbs(got, plain)
            plain_vs_jax[key] = dbs(plain[..., :n], want)
            check(renders[key][0] >= bar, f"18(b) {key}: the image renders "
                                          f"{renders[key][0]:.2f} dB against JAX's (bar {bar})")
            if layer_bar is not None:
                check(min(renders[key][1:]) >= layer_bar,
                      f"18(b) {key}: a layer renders {renders[key][1:]} dB against JAX's "
                      f"(bar {layer_bar})")
            check(min(k1_vs_plain[key]) >= 40.0,
                  f"18(b) {key}: K1 against its plain version {k1_vs_plain[key]} dB (bar 40)")
        tc = counts["fused_field"] if dtype == "bfloat16" else 0
        check(counts["fused_field"] > 0 and counts["fused_field_tc"] == tc
              and counts["field_bwd"] == 0,
              f"18(b) {tag}: K1 launched {counts['fused_field']} "
              f"({counts['fused_field_tc']} tensor-core), K2 {counts['field_bwd']}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    out["render"] = {"db_mixed_then_layers": renders, "k1_vs_plain_db": k1_vs_plain,
                     "plain_vs_jax_f32_db": plain_vs_jax, "bars_db": {
                         f"{p}_{d}": b for (p, d), b in bars.items()},
                     "boxes_equal_jax": boxes_equal, "s": render_s,
                     "launches": {k: v for k, v in launches.items() if v}}
    print("trained_synthetic_render", json.dumps(out["render"]), flush=True)

    # (c) one step on the trained checkpoint: kernels (bf16) against plain
    batch_spec, batch = train_batch(device, pool, scene, trained_cfg(meta, root))
    grads, step_launches = {}, {}
    for dtype, plain in (("bfloat16", False), ("bfloat16", True), ("float32", True)):
        scfg = trained_cfg(meta, root, dtype)
        scfg.TPU.COMPOSITOR_KERNEL = True
        model = load_params_any(os.path.join(TRAINED, meta["checkpoint"]),
                                LayeredModel(LayeredSpec.from_cfg(scfg), device=device))
        opt, sched = make_optimizer(scfg, model)
        step = make_train_step(model, opt, sched, remove_outliers=True, plain=plain,
                               device=device)
        zero_launches()
        m = step(scene, batch, torch.Generator(device=device).manual_seed(SEED), 1.0)
        check(bool(torch.isfinite(m.loss)), f"18(c) {dtype} plain={plain}: loss not finite")
        grads[(dtype, plain)] = dict(_flat_leaves(export_jax_params(model, grad=True)))
        if not plain:
            step_launches = {k: v for k, v in read_launches().items() if v}
    kern = grads[("bfloat16", False)]
    vs_bf16 = {k: compare_leaf(kern[k], b)["rel"] for k, b in grads[("bfloat16", True)].items()}
    vs_f32 = {k: compare_leaf(kern[k], b)["rel"] for k, b in grads[("float32", True)].items()}
    plain_bf16_vs_f32 = {k: compare_leaf(grads[("bfloat16", True)][k], b)["rel"]
                         for k, b in grads[("float32", True)].items()}
    out["step"] = {
        "kernel_bf16_vs_plain_bf16_worst": max(vs_bf16.items(), key=lambda kv: kv[1]),
        "kernel_bf16_vs_plain_f32_worst": max(vs_f32.items(), key=lambda kv: kv[1]),
        "plain_bf16_vs_plain_f32_worst": max(plain_bf16_vs_f32.items(),
                                             key=lambda kv: kv[1]),
        "kernel_bf16_vs_plain_f32_by_leaf": vs_f32, "launches": step_launches}
    print("trained_synthetic_step", json.dumps(out["step"]), flush=True)
    bad = {k: v for k, v in vs_bf16.items() if v > 1e-2}
    check(not bad, f"18(c): kernel vs plain bf16 gradients above relative L2 1e-2: {bad}")
    lp1 = batch_spec.layer_num + 1
    check(step_launches.get("fused_field_tc") == step_launches.get("field_bwd_tc") == 2 * lp1,
          f"18(c): the kernel step launched {step_launches}, {2 * lp1} of K1 and K2 implied")
    out["s"] = time.perf_counter() - t_phase
    out["launches"] = {form: r["launches"] for form, r in out["train"].items()}
    out["launches"]["render"] = out["render"]["launches"]
    out["launches"]["step"] = step_launches
    print(f"phase trained_synthetic: {out['s']:.1f} s", flush=True)
    if failed:
        raise RuntimeError(f"chip_smoke check failed: phase 18: {failed}")
    return out


def trained_spread(device, card: str) -> dict:
    """The readings behind phase 18(a)'s band: the port's training on the
    card in both forms, in bf16 and in float32 (K1/K2's CUDA-core routes),
    at seed 0 (in bf16 phase 18(a)'s runs), from the fixture's initial
    weights nudged one float32 ulp, and at seeds 1 and 2 -> each curve, the
    band, where each lies in it, and per dtype the largest gap between two
    of its eight runs and their mean per epoch. Barred as phase 18(a)
    bars."""
    setup = trained_setup(device)
    band = trained_band(setup[0])
    curves, failed = {}, []  # every run goes; the check comes at the end
    for dtype in ("bfloat16", "float32"):
        for form, kernel in (("nosort", True), ("sorted", False)):
            for seed, nudged in ((SEED, False), (SEED, True), (1, False), (2, False)):
                curve, _, seconds, _ = train_trained(device, setup, kernel, seed, nudged,
                                                     dtype)
                name = f"{dtype}_{form}_seed{seed}{'_nudged' if nudged else ''}"
                curves[name] = curve
                inside = [lo <= c <= hi for c, (lo, hi) in zip(curve, band)]
                inside += [False] * (len(band) - len(curve))
                print("trained_spread", json.dumps({"run": name, "psnr": curve,
                                                     "inside": inside, "s": seconds,
                                                     "card": card}), flush=True)
                if not all(inside):
                    failed.append(name)
    row = {"band_db": band, "outside": failed, "card": card}
    for dtype in ("bfloat16", "float32"):
        runs = [c for name, c in curves.items() if name.startswith(dtype)]
        n = min(len(c) for c in runs)
        row[f"{dtype}_largest_gap_db"] = [max(c[e] for c in runs) - min(c[e] for c in runs)
                                          for e in range(n)]
        row[f"{dtype}_mean_db"] = [float(np.mean([c[e] for c in runs])) for e in range(n)]
    print("trained_spread_summary", json.dumps(row), flush=True)
    check(not failed, f"trained spread: {failed} left the band")
    return row


def route_launches(launches: dict, name: str) -> int:
    """A kernel row's launches in a path's counts: a CUDA-core route counts
    what its wrapper launched off the tensor-core route."""
    n = launches.get(name, 0)
    if f"{name}_tc" in launches:
        n -= launches[f"{name}_tc"]
    return n


def model_axis_nccl_only(device, card: str) -> dict:
    """Phase 17(c) alone, for a machine with four cards: phase 11's
    synthetic scene and config written afresh, then the (2, 2) step over
    NCCL against its in-process reconstruction."""
    import shutil

    from stnerf_tpu_torch.data import make_synthetic_scene

    root = os.path.join(REPO, "build", "chip_smoke_synthetic")
    shutil.rmtree(root, ignore_errors=True)
    make_synthetic_scene(root, width=200, height=150, num_cams=12, num_frames=5,
                         layer_num=2, seed=SEED)
    cfg_file = entry_point_cfg_file(root, os.path.join(REPO, "build", "chip_smoke_entry"))
    return phase_model_axis(device, cfg_file, card, parts=("2x2_nccl",))


def main():
    script_t0 = time.perf_counter()
    import torch

    modes = (["--model-axis-nccl"], ["--trained-spread"], ["--backward"])
    if sys.argv[1:] not in ([], *modes):
        raise SystemExit("usage: python3 chip_smoke.py [--model-axis-nccl | --trained-spread | "
                         "--backward]")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() "
                           "is False")
    sys.path.insert(0, REPO)
    from stnerf_tpu_torch.kernels._build import BUILD_DIR, load_library

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 oracles in float32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.splitlines()[0]
    print(card, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)

    t0 = time.perf_counter()
    load_library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for log in sorted(BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print("ptxas", line.strip(), flush=True)
    if sys.argv[1:] in modes:
        if sys.argv[1:] == ["--backward"]:  # phases 4, 6 and 8b alone
            m = taekwondo_cfg().SOLVER.IMS_PER_BATCH * 120
            for name, phase in (("field_bwd_vs_plain", phase_field_bwd_vs_plain),
                                ("spacenet_vs_plain", phase_spacenet_vs_plain)):
                t0 = time.perf_counter()
                phase(device, m=m, reps=3)
                print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
            scene, _ = scene_and_requests(device)
            phase_wide_train(device, ring_bundle(scene), scene, card)
        elif sys.argv[1:] == ["--model-axis-nccl"]:
            row = model_axis_nccl_only(device, card)["2x2_nccl"]
            check(row.get("ran", True), f"17(c) did not run: {row.get('why')}")
        else:
            t0, errors = time.perf_counter(), []
            for part in (trained_spread, phase_trained_synthetic):
                try:  # both parts print their readings; the run fails after
                    part(device, card)
                except RuntimeError as e:
                    errors.append(str(e))
            print(f"phase trained_synthetic + spread: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            check(not errors, f"{errors}")
        print(f"chip_smoke: {time.perf_counter() - script_t0:.1f} s in all, the kernels' "
              "build included", flush=True)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    t0 = time.perf_counter()
    cases = phase_kernel_vs_plain(device, m=4096 * 120, reps=5)
    print(f"phase kernel_vs_plain: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cfg = taekwondo_cfg()
    summary = phase_slice(device, h=270, w=480, chunk=cfg.TPU.RENDER_CHUNK,
                          tile_cols=cfg.TPU.TILE_COLS)
    print(f"phase slice: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    bwd_cases = phase_field_bwd_vs_plain(device, m=cfg.SOLVER.IMS_PER_BATCH * 120, reps=3)
    print(f"phase field_bwd_vs_plain: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    scene, _ = scene_and_requests(device)
    bundle = ring_bundle(scene)
    shares = np.bincount(bundle["labels"], minlength=3) / len(bundle["labels"])
    print("pool", json.dumps({"rays": len(bundle["labels"]), "label_shares": shares.tolist()}),
          flush=True)
    train = phase_train(device, bundle, scene)
    print(f"phase train: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    k3_cases = phase_spacenet_vs_plain(device, m=cfg.SOLVER.IMS_PER_BATCH * 120, reps=3)
    k6 = phase_fused_spacenet_vs_plain(device, m=65536, reps=3)
    print(f"phase spacenet_vs_plain: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    vp_render = phase_view_pose_render(device, h=270, w=480, chunk=cfg.TPU.RENDER_CHUNK,
                                       tile_cols=cfg.TPU.TILE_COLS)
    print(f"phase view_pose_render: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    wide_slice = phase_wide_slice(device, h=270, w=480, chunk=cfg.TPU.RENDER_CHUNK,
                                  tile_cols=cfg.TPU.TILE_COLS, card=card)
    print(f"phase wide_slice: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    vp_train = phase_view_pose_train(device, bundle, scene)
    print(f"phase view_pose_train: {time.perf_counter() - t0:.1f} s", flush=True)
    wide_train = phase_wide_train(device, bundle, scene, card)
    t0 = time.perf_counter()
    cross = phase_cross_vs_plain(device, reps=20)
    compositor = phase_compositor(device, reps=3)
    print(f"phase cross_vs_plain + compositor: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    entry = phase_entry_point(device)
    print(f"phase entry_point: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    front = phase_render_front_end(device, os.path.join(REPO, "build", "chip_smoke_train.yml"),
                                   card)
    print(f"phase render_front_end: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    fast = phase_fast_fine_train(device, bundle, scene, card, train)
    print(f"phase fast_fine_train: {time.perf_counter() - t0:.1f} s", flush=True)
    entry_cfg = os.path.join(REPO, "build", "chip_smoke_train.yml")
    t0 = time.perf_counter()
    distributed = phase_distributed(device, entry_cfg, card)
    print(f"phase distributed: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    legacy = phase_legacy_renderer(device, entry_cfg, card)
    print(f"phase legacy_renderer: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    model_axis = phase_model_axis(device, entry_cfg, card)
    print(f"phase model_axis: {time.perf_counter() - t0:.1f} s", flush=True)
    trained = phase_trained_synthetic(device, card)

    # the performer field: the main paths' case. K1 and K2 in two routes
    # each: bf16 fields on the tensor-core kernels (every main path), float32
    # fields on the CUDA-core kernels (phase 5's float32 training step)
    perf, bwd, k3 = cases[0], bwd_cases[0], k3_cases[0]
    f32_step = train["steps"][1]["launches"]
    vp_f32_step = vp_train["steps"][1]["launches"]  # K3's float32 route
    kernels = [
        {"name": "fused_field_tc", "route": "cuda",
         "source": "stnerf_tpu_torch/kernels/csrc/fused_field_tc.cu",
         "replaces": "stnerf_tpu/kernels/fused_field.py:144",
         "launches": summary["launches_tc"],
         "launches_by_path": {"render": summary["launches_tc"],
                              "train": train["launches_fused_field"],
                              "render_front_end": front["launches_tc"]},
         "max_abs_err": max(c["bf16_vs_bf16_max_abs_err"] for c in cases),
         "ms": perf["bfloat16_ms"], "checked_ms": perf["bfloat16_checked_ms"],
         "plain_ms": perf["bfloat16_plain_ms"],
         "bound_ms": perf["bfloat16_bound_ms"], "bound_by": perf["bfloat16_bound_by"],
         "library_ms": None},
        {"name": "fused_field", "route": "cuda",
         "source": "stnerf_tpu_torch/kernels/csrc/fused_field.cu",
         "replaces": "stnerf_tpu/kernels/fused_field.py:144",
         "launches": f32_step["fused_field"],
         "launches_by_path": {"train_step_float32": f32_step["fused_field"]},
         "max_abs_err": max(c["f32_max_abs_err"] for c in cases),
         "ms": perf["float32_ms"], "plain_ms": perf["float32_plain_ms"],
         "bound_ms": perf["float32_bound_ms"], "bound_by": perf["float32_bound_by"],
         "library_ms": None},
        {"name": "field_bwd_tc", "route": "cuda",
         "source": "stnerf_tpu_torch/kernels/csrc/field_bwd_tc.cu",
         "replaces": "stnerf_tpu/kernels/field_vjp.py:192",
         "launches": train["launches"],
         "launches_by_path": {"train": train["launches"]},
         "max_abs_err": max(c["bf16_max_abs_err"] for c in bwd_cases),
         "ms": bwd["bfloat16_ms"], "plain_ms": bwd["bfloat16_plain_ms"],
         "bound_ms": bwd["bfloat16_bound_ms"], "bound_by": bwd["bfloat16_bound_by"],
         "library_ms": None},
        {"name": "field_bwd", "route": "cuda",
         "source": "stnerf_tpu_torch/kernels/csrc/field_bwd.cu",
         "replaces": "stnerf_tpu/kernels/field_vjp.py:192",
         "launches": f32_step["field_bwd"],
         "launches_by_path": {"train_step_float32": f32_step["field_bwd"]},
         "max_abs_err": max(c["f32_max_abs_err"] for c in bwd_cases),
         "ms": bwd["float32_ms"], "plain_ms": bwd["float32_plain_ms"],
         "bound_ms": bwd["float32_bound_ms"], "bound_by": bwd["float32_bound_by"],
         "route_bound_ms": bwd["float32_route_bound_ms"],
         "workspace_bytes": bwd["float32_workspace_bytes"], "library_ms": None},
        {"name": "spacenet_fwd_tc", "route": "cuda",
         "source": "stnerf_tpu_torch/kernels/csrc/spacenet_tc.cu",
         "replaces": "stnerf_tpu/kernels/spacenet_vjp.py:210",
         "launches": vp_render["launches_tc"] + vp_train["launches_fwd_tc"],
         "launches_by_path": {"render": vp_render["launches_tc"],
                              "train": vp_train["launches_fwd_tc"]},
         "max_abs_err": max(c["bf16_fwd_max_abs_err"] for c in k3_cases),
         "ms": k3["bfloat16_fwd_ms"], "plain_ms": k3["bfloat16_fwd_plain_ms"],
         "bound_ms": k3["bfloat16_fwd_bound_ms"], "bound_by": k3["bfloat16_fwd_bound_by"],
         "library_ms": None},
        {"name": "spacenet_fwd", "route": "cuda",
         "source": "stnerf_tpu_torch/kernels/csrc/spacenet.cu",
         "replaces": "stnerf_tpu/kernels/spacenet_vjp.py:210",
         "launches": vp_f32_step["spacenet_fwd"],
         "launches_by_path": {"train_step_float32": vp_f32_step["spacenet_fwd"]},
         "max_abs_err": max(c["f32_fwd_max_abs_err"] for c in k3_cases),
         "ms": k3["float32_fwd_ms"], "plain_ms": k3["float32_fwd_plain_ms"],
         "bound_ms": k3["float32_fwd_bound_ms"], "bound_by": k3["float32_fwd_bound_by"],
         "library_ms": None},
        {"name": "spacenet_bwd_tc", "route": "cuda",
         "source": "stnerf_tpu_torch/kernels/csrc/spacenet_tc.cu",
         "replaces": "stnerf_tpu/kernels/spacenet_vjp.py:238",
         "launches": vp_train["launches_bwd_tc"],
         "launches_by_path": {"train": vp_train["launches_bwd_tc"]},
         "max_abs_err": max(c["bf16_bwd_max_abs_err"] for c in k3_cases),
         "ms": k3["bfloat16_bwd_ms"], "plain_ms": k3["bfloat16_bwd_plain_ms"],
         "bound_ms": k3["bfloat16_bwd_bound_ms"], "bound_by": k3["bfloat16_bwd_bound_by"],
         "library_ms": None},
        {"name": "spacenet_bwd", "route": "cuda",
         "source": "stnerf_tpu_torch/kernels/csrc/spacenet.cu",
         "replaces": "stnerf_tpu/kernels/spacenet_vjp.py:238",
         "launches": vp_f32_step["spacenet_bwd"],
         "launches_by_path": {"train_step_float32": vp_f32_step["spacenet_bwd"]},
         "max_abs_err": max(c["f32_bwd_max_abs_err"] for c in k3_cases),
         "ms": k3["float32_bwd_ms"], "plain_ms": k3["float32_bwd_plain_ms"],
         "bound_ms": k3["float32_bwd_bound_ms"], "bound_by": k3["float32_bwd_bound_by"],
         "route_bound_ms": k3["float32_bwd_route_bound_ms"],
         "workspace_bytes": k3["float32_bwd_workspace_bytes"], "library_ms": None}]
    # what each launched in the entry point's run too (bf16: the CUDA-core
    # routes of K1, K2 and K3 count what the tensor-core ones did not take)
    entry_launches = dict(entry["launches"])
    for name in ("fused_field", "field_bwd", "spacenet_fwd", "spacenet_bwd"):
        entry_launches[name] -= entry_launches[f"{name}_tc"]
    for row in kernels:
        row["launches_by_path"]["entry_point"] = entry_launches[row["name"]]
    # the fast fine training path in both compositor forms (bf16: K1 and K2
    # on the tensor-core routes only)
    for form, r in fast["forms"].items():
        for row in kernels:
            name = row["name"]
            n = r["launches"].get(name, 0)
            if name in ("fused_field", "field_bwd"):
                n -= r["launches"][f"{name}_tc"]
            row["launches_by_path"][f"fast_fine_train_{form}"] = n
    # K6's launches as counted in the six main paths' runs (no path calls it)
    main_paths = {"render": summary, "train": train, "view_pose_render": vp_render,
                  "view_pose_train": vp_train, "entry_point": entry,
                  "render_front_end": front,
                  **{f"fast_fine_train_{k}": r for k, r in fast["forms"].items()}}
    for name, line in (("fused_spacenet", 139), ("fused_spacenet_planar", 245),
                       ("fused_spacenet_stacked", 292)):
        row = k6[name]
        by_path = {p: r["launches_k6"][name] for p, r in main_paths.items()}
        kernels.append({"name": name, "route": "cuda",
                        "source": "stnerf_tpu_torch/kernels/csrc/spacenet_tc.cu",
                        "replaces": f"stnerf_tpu/kernels/fused_spacenet.py:{line}",
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "max_abs_err": row["bf16_max_abs_err"],
                        "ms": row["bfloat16_ms"], "plain_ms": row["bfloat16_plain_ms"],
                        "bound_ms": row["bf16_bound_ms"], "bound_by": row["bound_by"],
                        "float32_ms": row["float32_ms"],
                        "float32_plain_ms": row["float32_plain_ms"],
                        "float32_bound_ms": row["float32_bound_ms"], "library_ms": None})
    # K4 and K5 at the training shape (3, 2000, 120), float32: ms the
    # device's time, call_ms a call's from the host; launches in the entry
    # point's run (the paths above composite with the sorted merge)
    for name, key, replaces in (
            ("cross_successor", "succ", "stnerf_tpu/kernels/cross_trans.py:109"),
            ("cross_log_transmittance_fwd", "fwd", "stnerf_tpu/kernels/cross_trans.py:126"),
            ("cross_log_transmittance_bwd", "bwd", "stnerf_tpu/kernels/cross_trans.py:157")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "stnerf_tpu_torch/kernels/csrc/cross_trans.cu",
                        "replaces": replaces, "launches": entry["launches"][name],
                        "launches_by_path": {"entry_point": entry["launches"][name],
                                             **{f"fast_fine_train_{k}": r["launches"][name]
                                                for k, r in fast["forms"].items()}},
                        "max_abs_err": max(c[f"{key}_max_abs_err"] for c in cross),
                        "ms": cross[0][f"{key}_ms"], "call_ms": cross[0][f"{key}_call_ms"],
                        "plain_ms": cross[0][f"{key}_plain_ms"],
                        "bound_ms": cross[0][f"{key}_bound_ms"],
                        "bound_by": cross[0][f"{key}_bound_by"], "library_ms": None})
    # the distributed paths (phase 15: the children's counts summed), the
    # legacy renderer (phase 16) and the model axis (phase 17: every rank's
    # counts summed)
    new_paths = {"distributed_nccl_world1": distributed["nccl"]["launches"],
                 "distributed_gloo_two_processes": distributed["gloo"]["launches"],
                 "legacy_renderer_fields": legacy["fields"]["launches"],
                 "legacy_renderer_mesh_background": legacy["mesh_background"]["launches"],
                 **{f"model_axis_{k}": r["launches"] for k, r in model_axis.items()
                    if "launches" in r},
                 **{f"trained_synthetic_{k}": r for k, r in trained["launches"].items()},
                 **{f"wide_slice_{k}": wide_slice[k]["launches"]
                    for k in ("bfloat16", "float32", "view_pose")},
                 "wide_slice_train": wide_train["launches"],
                 **{f"wide_slice_{r['model']}_step_{r['dtype']}": r["launches"]
                    for r in wide_train["steps"] + wide_train["view_pose_steps"]}}
    # the forward routes at the wide slice's widths (M = 240,000, every
    # sample run): their sample block, times, bound and share
    for name, route in (("fused_field_tc", "fused_field_bfloat16"),
                        ("fused_field", "fused_field_float32"),
                        ("spacenet_fwd_tc", "spacenet_fwd_bfloat16"),
                        ("spacenet_fwd", "spacenet_fwd_float32")):
        row = next(r for r in kernels if r["name"] == name)
        row["wide"] = wide_slice["kernels"][route]
    # and the backward routes (phase 8b)
    for name, route in (("field_bwd_tc", "field_bwd_bfloat16"),
                        ("field_bwd", "field_bwd_float32"),
                        ("spacenet_bwd_tc", "spacenet_bwd_bfloat16"),
                        ("spacenet_bwd", "spacenet_bwd_float32")):
        next(r for r in kernels if r["name"] == name)["wide"] = wide_train["kernels"][route]
    next(r for r in kernels if r["name"] == "fused_field_tc")["wide_checked"] = (
        wide_slice["kernels"]["fused_field_bfloat16_checked"])
    for row in kernels:
        for path, launches in new_paths.items():
            row["launches_by_path"][path] = route_launches(launches, row["name"])
        if row["name"].startswith("fused_spacenet"):
            row["launches"] = sum(row["launches_by_path"].values())
    print("compositor_fwd_bwd_ms", json.dumps({k: v for k, v in compositor.items()
                                                if k.endswith("_ms")}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - script_t0:.1f} s in all, the kernels' "
          "build included", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
