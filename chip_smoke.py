#!/usr/bin/env python3
"""Drive the PyTorch port (``stnerf_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Card and build: prints the card's ``name, power.limit`` as nvidia-smi
   gives them, builds every kernel of the render path from the sources in
   this checkout (``build/kernels/``) and prints the build's seconds.
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
4. One JSON line per kernel, then the result line
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
KERNEL_SOURCE = "stnerf_tpu_torch/kernels/csrc/fused_field.cu"
KERNEL_REPLACES = "stnerf_tpu/kernels/fused_field.py:144"
SEED = 0


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

    model = LayeredModel(spec, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("density.0.bias"):
                p += 0.02 if name.startswith("bkgd") else 2.0
    return model.to(device)


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
        row = {"case": name, "f32_max_abs_err": err, "bf16_vs_f32_db": db}
        if device.type == "cuda":
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

    perf = cases[0]  # the performer field: the main path's configuration
    print(json.dumps({"kernels": [{
        "name": "fused_field", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": summary["launches"],
        "max_abs_err": max(c["f32_max_abs_err"] for c in cases),
        "ms": perf["bfloat16_ms"], "plain_ms": perf["bfloat16_plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
