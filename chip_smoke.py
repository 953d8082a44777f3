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
   flags that zero some tiles: float32 kernel vs float32 plain (TF32 off) within rtol 2e-3,
   atol 2e-4; bf16 kernel vs float32 plain >= 40 dB on sigmoid(rgb).
   Prints both times per case.
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
   ``f32_close``); bf16 vs bf16 relative L2 <= 1e-2 per leaf. Prints both
   times per case.
5. Training: ``do_train`` on the taekwondo model at batch 2000 (one
   coarse-only epoch, then one full epoch, 20 steps each) from a compact
   pool of 40,000 rays of 8 ring cameras at 1920x1080 around the scene of
   phase 3, flat colour per segmentation label. Checks finite losses, a
   falling loss over the full epoch, that the backward kernel launched
   once per field and stage of every step, and a checkpoint round trip;
   then one training step through the kernels and one through the plain
   versions from the same weights and batch, gradients compared per leaf
   (bf16: relative L2 <= 1e-2; float32 as phase 4). Prints seconds per
   step and rays/s for both paths.
6. The ``{"kernels": [...]}`` line (launches on the main paths, errors, times
   and bounds), the card line again, and the result line
   ``{"ok": true, "device": {...}}`` last.

Weights are random from a seeded generator. It needs one CUDA card, and
fails where there is none or where the repository is not beside it.
"""

from __future__ import annotations

import dataclasses
import json
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

    from stnerf_tpu_torch.kernels.fused_field import (
        TILE, fused_field, fused_field_reference, pack_field,
        prepare_kernel_params_planar, prepare_motion_params_planar)
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
        fields = {}
        for dt in ("float32", "bfloat16"):
            tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
            fields[dt] = pack_field(prepare_kernel_params_planar(net, tdt),
                                    prepare_motion_params_planar(mnet, tdt) if mode else (),
                                    net.spec, mode, dt)
        rgb_k, sig_k = fused_field(fields["float32"], xyz, ids, dir_enc, flags)
        rgb_p, sig_p = fused_field_reference(fields["float32"], xyz, ids, dir_enc, flags)
        sync(device)
        check(torch.isfinite(rgb_k).all() and torch.isfinite(sig_k).all(), f"{name}: non-finite")
        check(bool((rgb_k[:, skipped] == 0).all() and (sig_k[skipped] == 0).all()),
              f"{name}: skipped tiles are not exactly 0")
        err = max(float((rgb_k - rgb_p).abs().max()), float((sig_k - sig_p).abs().max()))
        close = (torch.allclose(rgb_k, rgb_p, rtol=2e-3, atol=2e-4)
                 and torch.allclose(sig_k, sig_p, rtol=2e-3, atol=2e-4))
        check(close, f"{name}: f32 kernel vs plain max |err| {err:.3g} "
                     "outside rtol 2e-3, atol 2e-4")
        rgb_b, sig_b = fused_field(fields["bfloat16"], xyz, ids, dir_enc, flags)
        db = psnr(torch.sigmoid(rgb_b).cpu(), torch.sigmoid(rgb_p).cpu())
        check(db >= 40.0, f"{name}: bf16 kernel vs f32 plain {db:.1f} dB < 40")
        f = fields["bfloat16"]
        # bytes: xyz, ids, dir_enc in, rgb and sigma out, and the weights once
        nbytes = 4 * m * (4 + dir_enc.shape[0] + 4) + 2 * f.weights.numel()
        t, by = bound_ms(2 * field_macs(f)["fwd"] * samples_run, nbytes, "bfloat16")
        row = {"case": name, "f32_max_abs_err": err, "bf16_vs_f32_db": db,
               "samples_run": samples_run, "bf16_bound_ms": t, "bound_by": by}
        for dt in ("float32", "bfloat16"):
            f = fields[dt]
            row[f"{dt}_ms"] = cuda_ms(lambda: fused_field(f, xyz, ids, dir_enc, flags), reps)
            row[f"{dt}_plain_ms"] = cuda_ms(
                lambda: fused_field_reference(f, xyz, ids, dir_enc, flags), reps)
        print("kernel_vs_plain", json.dumps(row), flush=True)
        results.append(row)
    return results


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
    fused_field.launches = 0
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
    launches = fused_field.launches
    _, _, _, _, n_pad = tile_grid(h, w, chunk, tile_cols)
    expected = renders * (n_pad // chunk) * 2 * lp1
    check(launches == expected,
          f"fused_field launched {launches} times, the renders imply {expected}")

    t0 = time.perf_counter()
    plain_color, *_ = render_pose_host(model, scene, K, c2w, [1.0, 1.0, 1.0], near_far,
                                       requests[0][2], h, w, chunk=chunk,
                                       tile_cols=tile_cols, plain=True)
    plain_s = time.perf_counter() - t0
    db = psnr(images["plain"], plain_color)
    check(db >= 40.0, f"kernel pose vs plain pose {db:.1f} dB < 40")
    summary = {"h": h, "w": w, "chunk": chunk, "kernel_s_per_pose": seconds,
               "plain_s_per_pose": plain_s, "kernel_vs_plain_db": db,
               "launches": launches}
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


def _leaf_stats(field, got, ref) -> dict:
    """compare_leaf for every weight and bias slot, d_xyz and d_dir."""
    (gw, gb, gx, gd), (rw, rb, rx, rd) = got, ref
    pairs = {s: (field.w(s, gw), field.w(s, rw)) if len(shape) == 2 else
             (field.b(s, gb), field.b(s, rb)) for s, shape in field.shapes.items()}
    pairs.update(d_xyz=(gx, rx), d_dir=(gd, rd))
    return {name: compare_leaf(a, b) for name, (a, b) in pairs.items()}


def phase_field_bwd_vs_plain(device, m: int, reps: int):
    """field_bwd vs field_bwd_reference on seeded inputs and cotangents ->
    per-case results (the plain version is the oracle)."""
    import torch

    from stnerf_tpu_torch.kernels.field_vjp import field_bwd, field_bwd_reference
    from stnerf_tpu_torch.kernels.fused_field import (
        TILE, pack_field, prepare_kernel_params_planar, prepare_motion_params_planar)
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
    d_rgb, d_sigma = t(rng.normal(size=(3, m))), t(rng.normal(size=m))
    flags_np = (rng.random(-(-m // TILE)) > 0.25).astype(np.int32)
    flags = torch.tensor(flags_np, device=device)
    skipped = torch.tensor(np.repeat(flags_np == 0, TILE)[:m], device=device)
    samples_run = int((~skipped).sum())

    results = []
    for name, net, mnet, mode in cases:
        row = {"case": name, "m": m, "samples_run": samples_run}
        for dt in ("float32", "bfloat16"):
            tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
            f = pack_field(prepare_kernel_params_planar(net, tdt),
                           prepare_motion_params_planar(mnet, tdt) if mode else (),
                           net.spec, mode, dt)
            args = (f, xyz, ids, dir_enc, d_rgb, d_sigma, flags)
            got = field_bwd(*args)
            sync(device)
            ref = field_bwd_reference(*args)
            for g in got:
                check(bool(torch.isfinite(g).all()), f"{name} {dt}: non-finite gradient")
            check(bool((got[2][:, skipped] == 0).all() and (got[3][:, skipped] == 0).all()),
                  f"{name} {dt}: skipped tiles have nonzero d_xyz or d_dir")
            stats = _leaf_stats(f, got, ref)
            if dt == "float32":
                row["f32_max_abs_err"] = max(v["err"] for v in stats.values())
                row["f32_max_rel_l2"] = max(v["rel"] for v in stats.values())
                row["f32_entries_outside"] = {k: v["outside"] for k, v in stats.items()
                                              if v["outside"]}
                bad = {k: v for k, v in stats.items() if not f32_close(v)}
                check(not bad, f"{name}: f32 kernel vs plain beyond the float32 bar: {bad}")
            else:
                worst = max(stats, key=lambda k: stats[k]["rel"])
                row["bf16_worst_rel_l2"] = [worst, stats[worst]["rel"]]
                check(stats[worst]["rel"] <= 1e-2,
                      f"{name}: bf16 kernel vs plain relative L2 {stats[worst]['rel']:.3g} "
                      f"on {worst} > 1e-2")
            row[f"{dt}_ms"] = cuda_ms(lambda: field_bwd(*args), reps)
            row[f"{dt}_plain_ms"] = cuda_ms(lambda: field_bwd_reference(*args), reps)
            if dt == "bfloat16":
                # bytes: xyz, ids, dir_enc, both cotangents in, d_xyz and d_dir
                # out, the weights read and their float32 gradients written once
                nbytes = (4 * m * (4 + dir_enc.shape[0] + 4 + 3 + dir_enc.shape[0])
                          + 2 * f.weights.numel() + 4 * (f.weights.numel() + f.biases.numel()))
                row["bf16_bound_ms"], row["bound_by"] = bound_ms(
                    2 * field_macs(f)["bwd"] * samples_run, nbytes, "bfloat16")
        print("field_bwd_vs_plain", json.dumps(row), flush=True)
        results.append(row)
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


def compare_train_step(device, bundle, scene, dtype: str) -> dict:
    """One training step through the kernels and one through their plain
    versions, from the same weights, batch and sampling noise: gradients
    per leaf, and the seconds of a second step of each path."""
    import torch

    from stnerf_tpu_torch.engine import (make_decode, make_optimizer, make_train_step,
                                         sort_batch_by_hit, split_compact_bundle)
    from stnerf_tpu_torch.models import LayeredSpec, export_jax_params

    cfg = taekwondo_cfg()
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.SOLVER.WARMUP_ITERS = 1
    spec = LayeredSpec.from_cfg(cfg)
    pool, tables, width = split_compact_bundle(bundle, device)
    n = cfg.SOLVER.IMS_PER_BATCH
    idx = torch.arange(n, device=device) * (pool.rgb.shape[0] // n)
    batch = make_decode(tables, spec, width)(type(pool)(*(x[idx] for x in pool)))
    batch = sort_batch_by_hit(spec, scene, batch)
    grads, seconds = {}, {}
    for plain in (False, True):
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
    stats = {k: compare_leaf(grads[False][k], b) for k, b in grads[True].items()}
    worst = max(stats, key=lambda k: stats[k]["rel"])
    if dtype == "bfloat16":
        check(stats[worst]["rel"] <= 1e-2, f"bf16 step: kernel vs plain gradient relative "
                                           f"L2 {stats[worst]['rel']:.3g} on {worst} > 1e-2")
    else:
        bad = {k: v for k, v in stats.items() if not f32_close(v)}
        check(not bad, f"f32 step: kernel vs plain gradients beyond the float32 bar: {bad}")
    row = {"dtype": dtype, "worst_rel_l2": [worst, stats[worst]["rel"]],
           "entries_outside": {k: v["outside"] for k, v in stats.items() if v["outside"]},
           "kernel_s_per_step": seconds[False], "plain_s_per_step": seconds[True],
           "kernel_rays_per_s": n / seconds[False], "plain_rays_per_s": n / seconds[True]}
    print("train_step_kernel_vs_plain", json.dumps(row), flush=True)
    return row


def phase_train(device) -> dict:
    """do_train at the taekwondo width and batch through the kernels, its
    checks, then the step comparison in both dtypes -> summary dict."""
    import logging

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
    scene, _ = scene_and_requests(device)
    bundle = ring_bundle(scene)
    shares = np.bincount(bundle["labels"], minlength=3) / len(bundle["labels"])
    print("pool", json.dumps({"rays": len(bundle["labels"]), "label_shares": shares.tolist()}),
          flush=True)
    model = make_model(spec, device)
    opt, sched = make_optimizer(cfg, model)
    records = []
    logger = logging.getLogger("chip_smoke.train")
    logger.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.emit = lambda r: (records.append(r), print("train", r.getMessage(), flush=True))
    logger.addHandler(handler)

    fused_field.launches = field_bwd.launches = 0
    history = do_train(cfg, model, scene, bundle, opt, sched, logger=logger, seed=SEED,
                       device=device)
    launches, fwd_launches = field_bwd.launches, fused_field.launches
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
               "launches_fused_field": fwd_launches}
    print("train", json.dumps(summary), flush=True)
    summary["steps"] = [compare_train_step(device, bundle, scene, dt)
                        for dt in ("bfloat16", "float32")]
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
            if "registers" in line or "spill" in line:
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
    train = phase_train(device)
    print(f"phase train: {time.perf_counter() - t0:.1f} s", flush=True)

    perf, bwd = cases[0], bwd_cases[0]  # the performer field, bf16: the main paths' case
    print(json.dumps({"kernels": [
        {"name": "fused_field", "route": "cuda",
         "source": "stnerf_tpu_torch/kernels/csrc/fused_field.cu",
         "replaces": "stnerf_tpu/kernels/fused_field.py:144",
         "launches": summary["launches"],
         "launches_by_path": {"render": summary["launches"],
                              "train": train["launches_fused_field"]},
         "max_abs_err": max(c["f32_max_abs_err"] for c in cases),
         "ms": perf["bfloat16_ms"], "plain_ms": perf["bfloat16_plain_ms"],
         "bound_ms": perf["bf16_bound_ms"], "bound_by": perf["bound_by"],
         "library_ms": None},
        {"name": "field_bwd", "route": "cuda",
         "source": "stnerf_tpu_torch/kernels/csrc/field_bwd.cu",
         "replaces": "stnerf_tpu/kernels/field_vjp.py:192",
         "launches": train["launches"],
         "max_abs_err": max(c["f32_max_abs_err"] for c in bwd_cases),
         "ms": bwd["bfloat16_ms"], "plain_ms": bwd["bfloat16_plain_ms"],
         "bound_ms": bwd["bf16_bound_ms"], "bound_by": bwd["bound_by"],
         "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
