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
   (TF32 off) within rtol 2e-3, atol 2e-4; bf16 kernel (tensor cores) vs
   bf16 plain within relative L2 1e-2 on rgb and on sigma, and vs float32
   plain >= 40 dB on sigmoid(rgb). Then the edges: a narrow model (trunk
   64, head 32, motion 32) and a ragged M with all tiles on, all off and no
   flags. Prints both routes' times and bounds per case.
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
   5's model, pool and batch; ``real_bwd_inputs``), and bitwise the same
   gradients when run twice (``check_field_bwd``). The same edges as phase
   2 (bf16 on the real background inputs cut to the ragged M). Prints both
   routes' times and bounds per case at the seeded shape.
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
   <= 1e-2 per leaf, the bf16 gradients bitwise the same when run twice;
   for the performer, the device-side ``active`` flag: 1 leaves the
   forward and d_pos / d_dir (bf16: every gradient) bitwise unchanged, 0
   gives zeros everywhere. The same checks on the edges: a narrow model
   (trunk 64, head 32) and a ragged M with the flag unset, 1 and 0. Then
   the three K6 entry points (``fused_spacenet*``, on K3's forward kernels)
   against their plain versions at one shape. Prints both routes' times,
   bounds and shares of bound.
7. The view-deform + pose-refinement model (phase 3's model with
   USE_DEFORM_VIEW and POSE_REFINEMENT on, 8 cameras, camera 0's correction
   off the identity): three of phase 3's requests at 480x270 through
   ``render_pose_host``, every field through K3's forward (a performer that
   a chunk misses, or that is hidden, skipped by its flag on the device:
   the kernel still launches and its blocks exit). Checks finite
   images, exact zero acc for a hidden layer, >= 40 dB between the kernel
   and plain paths, and K3's forward launches against what the renders
   imply, every one on the tensor-core route. Prints seconds per pose.
8. Training that model on phase 5's pool as phase 5 does: finite losses, a
   falling loss over the full epoch, K3's forward and backward each once
   per field and stage of every step, all on the tensor-core route,
   non-zero ``cam_pose`` and ``view_deform`` gradients; then one step
   through the kernels and one through the plain versions in float32 and
   in bf16 (every leaf at relative L2 <= 1e-2 but the two ``cam_pose``
   leaves, held to a tenth of their own bf16 rounding error), each kernel
   step's K3 launches by route. Prints seconds per step and rays/s.
9. Cross-stream kernels vs plain: ``cross_successor`` (K4) and
   ``cross_log_transmittance_fwd`` / ``_bwd`` (K5) against their plain cube
   forms at (3, 2000, 120), (3, 2000, 90) and a ragged (3, 37, 24) with
   exact cross-layer ties, saturated factors and parked depths: K4 bitwise
   equal, K5 within rtol 1e-5, atol 1e-6 max|plain|. Prints both times and
   the bound per case.
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
   imply, no sorted merge in training and no plain compositor at all, the
   per-epoch checkpoints; then ``--resume`` for one more epoch, whose first
   loss must equal that of ``do_train`` from checkpoint 3's parameters;
   then one float32 step with the flag on and one with it off from the same
   weights and batch, every gradient leaf at phase 4's bar.
12. The ``{"kernels": [...]}`` line (launches on the main paths, errors, times
   and bounds), the card line again, and the result line
   ``{"ok": true, "device": {...}}`` last.
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
   both hidden the mix is the background stream (one u8 step on the exact
   path, >= 40 dB on the approximate one), acc in [0, 1], K1 against its
   plain version on one pose of
   the approximate path (>= 40 dB), the approximate path against the exact
   one on the gate's pose at the frame's size (the gate's bar; on the path's
   pose read, unbarred), K1's launches against the poses, the
   segments, the fields and the gates' probes, and a second renderer on an
   exported reference ``.pt`` renders bitwise the same pose. Prints, each
   line with the card's name and power limit: the refine time and the
   cache hit, ``fidelity_db``, seconds per pose (end to end, device) and
   K1's tiles run of the approximate and the exact path on the same path
   (order approximate, exact, exact, approximate), seconds per 1920x1080
   frame and peak device memory of both, and one pose with OCC_SLICES = 2
   and OCC_GAP_SKIP on.

Weights are random from a seeded generator. It needs one CUDA card, and
fails where there is none or where the repository is not beside it.
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
# H100 SXM data sheet peaks (dense): bf16 tensor cores, FP32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


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

    from stnerf_tpu_torch.kernels.fused_field import TILE, fused_field, fused_field_reference
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
            row[f"{dt}_plain_ms"] = cuda_ms(
                lambda: fused_field_reference(f, xyz, ids, dir_enc, flags), reps)
        print("kernel_vs_plain", json.dumps(row), flush=True)
        results.append(row)
    results += edge_cases(device, check_fused_field, "kernel_vs_plain_edge", seed=SEED + 5)
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
    rtol 2e-3, atol 2e-4 (CUDA-core route), bf16 (tensor-core route) within
    relative L2 1e-2 of the bf16 plain version on rgb and on sigma, and bf16
    >= 40 dB from the float32 plain version on sigmoid(rgb). -> the errors."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import fused_field, fused_field_reference

    out = {}
    for dt, f in fields.items():
        got = fused_field(f, xyz, ids, dir_enc, flags)
        sync(xyz.device)
        ref = fused_field_reference(f, xyz, ids, dir_enc, flags)
        check(all(bool(torch.isfinite(g).all()) for g in got), f"{name} {dt}: non-finite")
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
    db = psnr(torch.sigmoid(rgb_b).cpu(), torch.sigmoid(rgb_p).cpu())
    check(db >= 40.0, f"{name}: bf16 kernel vs f32 plain {db:.1f} dB < 40")
    bf_err = max(float((rgb_b - rgb_bp).abs().max()), float((sig_b - sig_bp).abs().max()))
    return {"case": name, "m": int(xyz.shape[1]), "f32_max_abs_err": err,
            "bf16_vs_bf16_rel_l2": rel, "bf16_vs_bf16_max_abs_err": bf_err,
            "bf16_vs_f32_db": db}


def edge_cases(device, check_fn, label: str, seed: int) -> list:
    """The kernels' edges, both dtypes: a narrow model (trunk 64, head 32,
    motion 32: every width the tiling pads) with seeded skip flags, and the
    taekwondo performer at a ragged M (not a multiple of 64 or 128) with all
    tiles flagged on, all flagged off and no flags. ``check_fn(name,
    fields, xyz, ids, dir_enc, flags, skipped)`` is phase 2's or phase 4's
    check. -> its rows."""
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
    narrow_cfg = taekwondo_cfg()
    narrow_cfg.merge_from_list(["MODEL.BACKBONE_DIM", 64, "MODEL.HEAD_DIM", 32,
                                "MODEL.MOTION_DIM", 32])
    narrow = make_model(LayeredSpec.from_cfg(narrow_cfg), device)
    wide = make_model(LayeredSpec.from_cfg(taekwondo_cfg()), device)
    seeded = (rng.random(n_tiles) > 0.25).astype(np.int32)
    cases = [("narrow_performer", narrow.layers_fine[0], narrow.motion[0], "lerp", seeded),
             ("narrow_background", narrow.bkgd_fine, None, None, seeded),
             ("ragged_all_on", wide.layers_fine[0], wide.motion[0], "lerp",
              np.ones(n_tiles, np.int32)),
             ("ragged_all_off", wide.layers_fine[0], wide.motion[0], "lerp",
              np.zeros(n_tiles, np.int32)),
             ("ragged_no_flags", wide.layers_fine[0], wide.motion[0], "lerp", None)]
    rows = []
    for name, net, mnet, mode, flags_np in cases:
        fields = {dt: pack_dtype(net, mnet, mode, dt) for dt in ("float32", "bfloat16")}
        flags = None if flags_np is None else torch.tensor(flags_np, device=device)
        off = np.zeros(m, bool) if flags_np is None else np.repeat(flags_np == 0, TILE)[:m]
        row = check_fn(name, fields, xyz, ids, dir_enc, flags, torch.tensor(off, device=device))
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


def _leaf_stats(field, got, ref, x_name: str = "d_xyz") -> dict:
    """compare_leaf for every weight and bias slot, the input gradient
    (``x_name``: d_xyz or d_pos) and d_dir."""
    (gw, gb, gx, gd), (rw, rb, rx, rd) = got, ref
    pairs = {s: (field.w(s, gw), field.w(s, rw)) if len(shape) == 2 else
             (field.b(s, gb), field.b(s, rb)) for s, shape in field.shapes.items()}
    pairs.update({x_name: (gx, rx), "d_dir": (gd, rd)})
    return {name: compare_leaf(a, b) for name, (a, b) in pairs.items()}


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

    from stnerf_tpu_torch.kernels.field_vjp import field_bwd, field_bwd_reference
    from stnerf_tpu_torch.kernels.fused_field import TILE
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
        print("field_bwd_vs_plain", json.dumps(row), flush=True)
        results.append(row)
    background = real["background"]

    def check_edge(name, fields, xyz, ids, dir_enc, flags, skipped):
        """float32 on the edge case's seeded inputs, bf16 on the real
        background inputs cut to its M, both with its flags."""
        n = xyz.shape[1]
        rng = np.random.default_rng(n)
        cot = (t(rng.normal(size=(3, n))), t(rng.normal(size=n)))
        row = {"case": name, "m": n}
        row.update(check_field_bwd(name, fields["float32"], (xyz, ids, dir_enc, *cot, flags),
                                   skipped))
        cut = tuple(a[..., :n].contiguous() for a in background[:5])
        row.update(check_field_bwd(name, fields["bfloat16"], (*cut, flags), skipped))
        return row

    results += edge_cases(device, check_edge, "field_bwd_vs_plain_edge", seed=SEED + 6)
    return results


def check_field_bwd(name, f, args, skipped) -> dict:
    """field_bwd against field_bwd_reference for one packed field on args =
    (xyz, ids, dir_enc, d_rgb, d_sigma, tile_flags): finite gradients, zero
    d_xyz and d_dir in skipped tiles (and all-zero weight gradients when
    every tile is skipped); float32 per leaf within rtol 2e-3, atol 2e-3
    max|g| but for at most one entry or 0.1% of the leaf (``f32_close``);
    bf16 per leaf within relative L2 1e-2. -> the errors."""
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
    stats = _leaf_stats(f, got, ref)
    if dt == "float32":
        bad = {k: v for k, v in stats.items() if not f32_close(v)}
        check(not bad, f"{name}: f32 kernel vs plain beyond the float32 bar: {bad}")
        return {"f32_max_abs_err": max(v["err"] for v in stats.values()),
                "f32_max_rel_l2": max(v["rel"] for v in stats.values()),
                "f32_entries_outside": {k: v["outside"] for k, v in stats.items()
                                        if v["outside"]}}
    worst = max(stats, key=lambda k: stats[k]["rel"])
    check(stats[worst]["rel"] <= 1e-2, f"{name}: bf16 kernel vs plain relative L2 "
                                      f"{stats[worst]['rel']:.3g} on {worst} > 1e-2")
    return {"bf16_worst_rel_l2": [worst, stats[worst]["rel"]],
            "bf16_max_abs_err": max(v["err"] for v in stats.values())}


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
    finite outputs; the float32 route (CUDA cores) at rtol 2e-3, atol 2e-4
    in the forward and at phase 4's bar in the backward (``f32_close``); the
    bf16 route (tensor cores) >= 40 dB from the float32 plain forward, its
    backward within relative L2 1e-2 of the bf16 plain version per leaf and
    bitwise the same when run twice. With ``flags``, the device-side
    ``active`` flag on both routes: 1 leaves the forward and d_pos / d_dir
    (bf16: every gradient) bitwise unchanged, 0 gives zeros everywhere,
    weight gradients included. -> the errors; ``fields`` and the call
    arguments under "_args" for the timing."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import pack_field, prepare_kernel_params_planar
    from stnerf_tpu_torch.kernels.spacenet_vjp import (spacenet_bwd, spacenet_bwd_reference,
                                                       spacenet_fwd, spacenet_fwd_reference)

    pos = x["pos"]
    m, device = pos.shape[1], pos.device
    dir_enc = x["dir"] if net.spec.use_dir else torch.zeros((1, m), device=device)
    time_enc = x["time"] if net.spec.use_time else None
    row, args = {"case": name, "m": m}, {}
    for dt in ("float32", "bfloat16"):
        tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
        f = pack_field(prepare_kernel_params_planar(net, tdt), (), net.spec, None, dt)
        fwd_args = (f, pos, dir_enc, time_enc)
        bwd_args = fwd_args + (x["d_rgb"], x["d_sigma"])
        args[dt] = fwd_args, bwd_args
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
            same = got_on if dt == "bfloat16" else got_on[2:]
            check(all(torch.equal(a, b) for a, b in zip(fwd_on, (rgb_k, sig_k)))
                  and all(torch.equal(a, b) for a, b in zip(same, got[-len(same):])),
                  f"{name} {dt}: active 1 changed the forward or a gradient")
            check(not any(bool(a.any()) for a in (*fwd_off, *got_off)),
                  f"{name} {dt}: active 0 left a nonzero output or gradient")
        rgb_p, sig_p = spacenet_fwd_reference(*fwd_args)
        ref = spacenet_bwd_reference(*bwd_args)
        stats = _leaf_stats(f, got, ref, "d_pos")
        fwd_err = max(float((rgb_k - rgb_p).abs().max()), float((sig_k - sig_p).abs().max()))
        if dt == "float32":
            close = (torch.allclose(rgb_k, rgb_p, rtol=2e-3, atol=2e-4)
                     and torch.allclose(sig_k, sig_p, rtol=2e-3, atol=2e-4))
            check(close, f"{name}: f32 forward kernel vs plain max |err| {fwd_err:.3g} "
                         "outside rtol 2e-3, atol 2e-4")
            row["f32_fwd_max_abs_err"] = fwd_err
            row["f32_bwd_max_abs_err"] = max(v["err"] for v in stats.values())
            row["f32_bwd_max_rel_l2"] = max(v["rel"] for v in stats.values())
            row["f32_entries_outside"] = {k: v["outside"] for k, v in stats.items()
                                          if v["outside"]}
            bad = {k: v for k, v in stats.items() if not f32_close(v)}
            check(not bad, f"{name}: f32 backward kernel vs plain beyond the float32 "
                           f"bar: {bad}")
            plain_rgb = rgb_p
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
            check(stats[worst]["rel"] <= 1e-2,
                  f"{name}: bf16 backward kernel vs plain relative L2 "
                  f"{stats[worst]['rel']:.3g} on {worst} > 1e-2")
            again = spacenet_bwd(*bwd_args)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name}: bf16 gradients differ between two runs")
    row["_args"] = args
    return row


def phase_spacenet_vs_plain(device, m: int, reps: int):
    """spacenet_fwd / spacenet_bwd (K3) against their plain versions on
    seeded encodings at the taekwondo widths (``check_spacenet``; the
    performer with the ``active`` flag), both routes' times, bounds and
    shares; then the edges: a narrow model (trunk 64, head 32) and a
    ragged M with ``active`` None, 1 and 0 -> per-case results."""
    import torch

    from stnerf_tpu_torch.kernels.spacenet_vjp import (spacenet_bwd, spacenet_bwd_reference,
                                                       spacenet_fwd, spacenet_fwd_reference,
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
        print("spacenet_vs_plain", json.dumps(row), flush=True)
        results.append(row)

    # the edges: every width the tiling pads, and a ragged M (not a
    # multiple of 64 or 128) with the flag unset, 1 and 0
    narrow_cfg = view_pose_cfg()
    narrow_cfg.merge_from_list(["MODEL.BACKBONE_DIM", 64, "MODEL.HEAD_DIM", 32,
                                "MODEL.MOTION_DIM", 32])
    narrow = make_model(LayeredSpec.from_cfg(narrow_cfg, camera_num=8), device)
    xe = _encoded_inputs(device, 2000 * 61 + 45, SEED + 7)
    for name, net, flags in (("narrow_performer", narrow.layers_fine[0], False),
                             ("narrow_background", narrow.bkgd_fine, False),
                             ("ragged_performer", model.layers_fine[0], True)):
        row = check_spacenet(name, net, xe, flags)
        row.pop("_args")
        print("spacenet_vs_plain_edge", json.dumps(row), flush=True)
        results.append(row)
    return results


def phase_fused_spacenet_vs_plain(device, m: int, reps: int):
    """The three K6 entry points against their plain versions at one shape
    (L = 2 weight sets for the stacked one), float32 (K3's CUDA-core
    forward) at K1's bar and bf16 (K3's tensor-core forward) at phase 2's
    relative L2 1e-2 on rgb and sigma, and their bf16 times -> {entry:
    result}."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import pack_field, prepare_kernel_params_planar
    from stnerf_tpu_torch.kernels.fused_spacenet import (
        fused_spacenet, fused_spacenet_planar, fused_spacenet_planar_reference,
        fused_spacenet_reference, fused_spacenet_stacked, fused_spacenet_stacked_reference)
    from stnerf_tpu_torch.models import LayeredSpec

    spec = LayeredSpec.from_cfg(view_pose_cfg(), camera_num=8)
    model = make_model(spec, device)
    nets = [model.layers_coarse[0], model.layers_fine[1]]
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
            else:
                (rgb_k, sig_k), (rgb_p, sig_p) = kernel(*args), plain(*args)
                sync(device)
                rel = [compare_leaf(rgb_k, rgb_p)["rel"], compare_leaf(sig_k, sig_p)["rel"]]
                check(max(rel) <= 1e-2, f"{name}: bf16 kernel vs bf16 plain relative L2 "
                                        f"(rgb, sigma) {rel} > 1e-2")
                row["bf16_rel_l2"] = rel
                row["bf16_max_abs_err"] = max(float((rgb_k - rgb_p).abs().max()),
                                              float((sig_k - sig_p).abs().max()))
                # the encodings in, rgb and sigma out, each weight set once
                n_rows = sum(a.shape[0] for a in planar)
                row["bf16_bound_ms"], row["bound_by"] = bound_ms(
                    2 * field_macs(fields[0])["fwd"] * samples,
                    4 * samples * (n_rows + 4) + 2 * fields[0].weights.numel() * n_sets,
                    "bfloat16")
            row[f"{dt}_ms"] = cuda_ms(lambda: kernel(*args), reps)
            row[f"{dt}_plain_ms"] = cuda_ms(lambda: plain(*args), reps)
    for row in results.values():
        print("fused_spacenet_vs_plain", json.dumps(row), flush=True)
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
                       f32_plain: dict | None = None) -> tuple:
    """One training step through the kernels and one through their plain
    versions, from the same weights, batch and sampling noise: gradients
    per leaf, and the seconds of a second step of each path. ``cfg_fn``
    (default taekwondo_cfg) gives the model's config. -> (row, the plain
    step's gradients by leaf).

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
    every other leaf, and the bf16 bar only bounds the rounding on top."""
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

    counted = (fused_field, field_bwd, spacenet_fwd, spacenet_bwd)
    grads, seconds, launches = {}, {}, {}
    for plain in (False, True):
        for k in counted:
            k.launches = k.launches_tc = 0
        model = make_model(spec, device)
        opt, sched = make_optimizer(cfg, model)
        step = make_train_step(model, opt, sched, remove_outliers=True, plain=plain,
                               device=device)
        m = step(scene, batch, torch.Generator(device=device).manual_seed(SEED), 1.0)
        check(bool(torch.isfinite(m.loss)), f"{dtype} step (plain={plain}): loss not finite")
        grads[plain] = dict(_flat_leaves(export_jax_params(model, grad=True)))
        sync(device)
        t0 = time.perf_counter()
        step(scene, batch, torch.Generator(device=device).manual_seed(SEED + 1), 1.0)
        sync(device)
        seconds[plain] = time.perf_counter() - t0
        if not plain:  # two steps through the kernels, by route
            launches = {f"{k.__name__}{route}": n for k in counted
                        for route, n in (("_tc", k.launches_tc),
                                         ("", k.launches - k.launches_tc))}
    stats = {k: compare_leaf(grads[False][k], b) for k, b in grads[True].items()}
    worst = max(stats, key=lambda k: stats[k]["rel"])
    bars = {}
    if dtype == "bfloat16":
        bars = {k: 1e-2 if f32_plain is None or not k.startswith("/cam_pose/") else
                max(1e-2, 0.1 * compare_leaf(grads[True][k], f32_plain[k])["rel"])
                for k in stats}
        bad = {k: [v["rel"], bars[k]] for k, v in stats.items() if v["rel"] > bars[k]}
        check(not bad, f"bf16 step: kernel vs plain gradient relative L2 above its bar "
                       f"[rel, bar]: {bad}")
    else:
        bad = {k: v for k, v in stats.items() if not f32_close(v)}
        check(not bad, f"f32 step: kernel vs plain gradients beyond the float32 bar: {bad}")
    row = {"model": "view_pose" if spec.use_deform_view else "taekwondo", "dtype": dtype,
           "worst_rel_l2": [worst, stats[worst]["rel"]],
           "entries_outside": {k: v["outside"] for k, v in stats.items() if v["outside"]},
           "kernel_s_per_step": seconds[False], "plain_s_per_step": seconds[True],
           "kernel_rays_per_s": n / seconds[False], "plain_rays_per_s": n / seconds[True],
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


def cross_inputs(device, L: int, N: int, S: int, seed: int, hard: bool = False) -> dict:
    """Seeded (L, N, S) inputs of K4/K5: ascending depths per stream, log
    factors as a compositor makes them (log of 1 - alpha + 1e-10, floored at
    1e-10) and cotangents. ``hard`` adds exact cross-layer ties (copied
    depths, as tests/test_ops.py:503-505), saturated factors (log 1e-10) and
    one ray whose streams all park at one depth."""
    import torch

    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.5, 16.0, (L, N, S)), -1).astype(np.float32)
    alpha = rng.uniform(0.0, 1.0, (L, N, S)) ** 4
    logf = np.log(np.maximum(1.0 - alpha + 1e-10, 1e-10)).astype(np.float32)
    if hard:
        t[1, :5, 3:7] = t[0, :5, 3:7]
        t[2, :5, 10] = t[0, :5, 10]
        t[:, 7] = 4.0
        logf[0, :3, 4] = np.log(np.float32(1e-10))
    g = rng.normal(size=(L, N, S)).astype(np.float32)
    return {k: torch.tensor(v, device=device) for k, v in
            (("t", t), ("logf", logf), ("g", g))}


def phase_cross_vs_plain(device, reps: int) -> list:
    """K4 and K5 (forward and backward) against their plain versions at the
    training shapes (3, 2000, 120) and (3, 2000, 90) and a ragged (3, 37, 24)
    with ties, saturated factors and parked depths: K4 bitwise equal; K5
    float32 within rtol 1e-5, atol 1e-6 max|plain| (sums of 10^2-10^3
    same-signed terms in another order). -> per-case rows with kernel and
    plain ms and the bounds (2 operations, a compare and a min or an add,
    per pair of samples of different streams; each operand read once and
    the output written once)."""
    import torch

    from stnerf_tpu_torch.kernels import cross_trans as ct

    rows = []
    for L, N, S, hard in ((3, 2000, 120, False), (3, 2000, 90, False), (3, 37, 24, True)):
        x = cross_inputs(device, L, N, S, SEED + 7 + S, hard)
        t, logf, g = x["t"], x["logf"], x["g"]
        succ, succ_p = ct.cross_successor(t), ct.cross_successor_reference(t)
        fwd, fwd_p = ct.cross_log_transmittance_fwd(t, logf), \
            ct.cross_log_transmittance_reference(t, logf)
        bwd, bwd_p = ct.cross_log_transmittance_bwd(t, g), \
            ct.cross_log_transmittance_bwd_reference(t, g)
        sync(device)
        name = f"{L}x{N}x{S}" + ("_ties_saturated_parked" if hard else "")
        check(torch.equal(succ, succ_p), f"K4 {name}: not bitwise equal to plain")
        row = {"case": name, "succ_max_abs_err": float((succ - succ_p).abs().max())}
        for key, got, ref in (("fwd", fwd, fwd_p), ("bwd", bwd, bwd_p)):
            check(bool(torch.isfinite(got).all()), f"K5 {key} {name}: non-finite")
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            check(torch.allclose(got, ref, rtol=1e-5, atol=1e-6 * scale),
                  f"K5 {key} {name}: max |err| {err:.3g} outside rtol 1e-5, atol "
                  f"1e-6 x {scale:.3g}")
            row[f"{key}_max_abs_err"], row[f"{key}_max_abs_plain"] = err, scale
        ops = 2.0 * L * (L - 1) * N * S * S
        elems = L * N * S
        for key, fn, plain, n_io in (
                ("succ", lambda: ct.cross_successor(t),
                 lambda: ct.cross_successor_reference(t), 2),
                ("fwd", lambda: ct.cross_log_transmittance_fwd(t, logf),
                 lambda: ct.cross_log_transmittance_reference(t, logf), 3),
                ("bwd", lambda: ct.cross_log_transmittance_bwd(t, g),
                 lambda: ct.cross_log_transmittance_bwd_reference(t, g), 3)):
            row[f"{key}_ms"] = cuda_ms(fn, reps)
            row[f"{key}_plain_ms"] = cuda_ms(plain, reps)
            row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = bound_ms(
                ops, 4.0 * n_io * elems, "float32")
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


def entry_point_cfg_file(scene_root: str, output_dir: str) -> str:
    """configs/config_synthetic.yml's keys with the entry-point phase's
    overrides, written to build/ -> its path."""
    import yaml

    with open(os.path.join(REPO, "configs", "config_synthetic.yml")) as f:
        raw = yaml.safe_load(f)
    raw["DATASETS"].update(TRAIN=scene_root, MAX_POOL_RAYS=40_000)
    raw["MODEL"].update(COARSE_RAY_SAMPLING=90, FINE_RAY_SAMPLING=30)
    raw["SOLVER"].update(COARSE_STAGE=2, MAX_EPOCHS=4)
    raw.setdefault("TPU", {})["COMPOSITOR_KERNEL"] = True
    raw["OUTPUT_DIR"] = output_dir
    path = os.path.join(REPO, "build", "chip_smoke_train.yml")
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
    from stnerf_tpu_torch.kernels.field_vjp import field_bwd
    from stnerf_tpu_torch.kernels.fused_field import fused_field
    from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_bwd, spacenet_fwd
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
    kernels = [fused_field, field_bwd, cross_trans.cross_successor,
               cross_trans.cross_log_transmittance_fwd, cross_trans.cross_log_transmittance_bwd,
               spacenet_fwd, spacenet_bwd, *k6_entries()]
    by_route = [fused_field, field_bwd, spacenet_fwd, spacenet_bwd]
    for k in kernels:
        k.launches = 0
    for k in by_route:
        k.launches_tc = 0
    t0 = time.perf_counter()
    args = ["-c", cfg_file, "--seed", str(SEED), "--workers", str(workers),
            "--device", str(device)]
    history = train.main(args)
    train_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    launches.update({f"{k.__name__}_tc": k.launches_tc for k in by_route})
    calls = {**merges, **plain}

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
    stage_steps = sum(steps * (1 if e < s.COARSE_STAGE else 2) for e in epochs)
    lp1 = cfg.DATASETS.LAYER_NUM + 1
    # validation renders one 200x150 view per epoch through the inference
    # path: both stages' fields through K1 and both merges sorted, as JAX's
    val_chunks = len(epochs) * -(-200 * 150 // cfg.TPU.RENDER_CHUNK)
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
    logger.removeHandler(handler)

    epoch_s.update({r.args[0]: r.args[1] for r in records
                    if r.msg.startswith("Epoch %d done")})
    summary = {"scene_s": scene_s, "train_main_s": train_s, "steps_per_epoch": steps,
               "launches": launches, "calls": calls, "val_psnr": val,
               "loss_epoch3_first_last": [float(last[0]), float(last[-1])],
               "resumed_first_loss": [first, ref],
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
    # which cut the background's segments: one u8 step on the exact path
    # (checked in 6), the gate's bar on the approximate one, whose carried
    # coarse-net samples cut differently
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
    re.hide_layer(1)
    re.hide_layer(2)
    for i in range(len(re.poses)):
        c, _, cl, _ = re.render_pose(re.poses[i], re.Ks[i], re.layer_frame_pairs[i],
                                     frame_idx=i, download_layers=[0])
        err = float(np.abs(c - cl[0]).max())
        check(err <= 1.0 / 255 + 1e-7,
              f"exact hide_both pose {i}: the mix differs from the background stream by {err}")
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
               "paths": paths, "tiles": tiles, "hd": hd, "occupancy": occupancy,
               "sliced": sliced}
    print("render_front_end", json.dumps(summary), flush=True)
    return summary


def main():
    import torch

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
    vp_train = phase_view_pose_train(device, bundle, scene)
    print(f"phase view_pose_train: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cross = phase_cross_vs_plain(device, reps=5)
    compositor = phase_compositor(device, reps=3)
    print(f"phase cross_vs_plain + compositor: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    entry = phase_entry_point(device)
    print(f"phase entry_point: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    front = phase_render_front_end(device, os.path.join(REPO, "build", "chip_smoke_train.yml"),
                                   card)
    print(f"phase render_front_end: {time.perf_counter() - t0:.1f} s", flush=True)

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
         "ms": perf["bfloat16_ms"], "plain_ms": perf["bfloat16_plain_ms"],
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
         "library_ms": None},
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
         "library_ms": None}]
    # what each launched in the entry point's run too (bf16: the CUDA-core
    # routes of K1, K2 and K3 count what the tensor-core ones did not take)
    entry_launches = dict(entry["launches"])
    for name in ("fused_field", "field_bwd", "spacenet_fwd", "spacenet_bwd"):
        entry_launches[name] -= entry_launches[f"{name}_tc"]
    for row in kernels:
        row["launches_by_path"]["entry_point"] = entry_launches[row["name"]]
    # K6's launches as counted in the six main paths' runs (no path calls it)
    main_paths = {"render": summary, "train": train, "view_pose_render": vp_render,
                  "view_pose_train": vp_train, "entry_point": entry,
                  "render_front_end": front}
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
                        "library_ms": None})
    # K4 and K5 at the training shape (3, 2000, 120), float32; launches in
    # the entry point's run (the paths above composite with the sorted merge)
    for name, key, replaces in (
            ("cross_successor", "succ", "stnerf_tpu/kernels/cross_trans.py:109"),
            ("cross_log_transmittance_fwd", "fwd", "stnerf_tpu/kernels/cross_trans.py:126"),
            ("cross_log_transmittance_bwd", "bwd", "stnerf_tpu/kernels/cross_trans.py:157")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "stnerf_tpu_torch/kernels/csrc/cross_trans.cu",
                        "replaces": replaces, "launches": entry["launches"][name],
                        "launches_by_path": {"entry_point": entry["launches"][name]},
                        "max_abs_err": max(c[f"{key}_max_abs_err"] for c in cross),
                        "ms": cross[0][f"{key}_ms"], "plain_ms": cross[0][f"{key}_plain_ms"],
                        "bound_ms": cross[0][f"{key}_bound_ms"],
                        "bound_by": cross[0][f"{key}_bound_by"], "library_ms": None})
    print("compositor_fwd_bwd_ms", json.dumps({k: v for k, v in compositor.items()
                                                if k.endswith("_ms")}), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
