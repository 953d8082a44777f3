#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time on a CUDA card.

    python3 tools/torch_profile_train.py [--steps 3] [--view-pose]
        [--compositor-kernel] [--synthetic]

Builds the taekwondo model of ``chip_smoke.py`` (random weights from its
seed) and its 40,000-ray ring pool, runs warm-up steps, then profiles full
(coarse + fine) training steps at batch 2000 through the kernels with
``torch.profiler``. ``--view-pose`` takes the model with view deformation
and pose refinement instead (the staged path: K3, every sample, batches
not sorted by hit pattern). ``--compositor-kernel`` turns
TPU.COMPOSITOR_KERNEL on (the sort-free compositor through K4/K5).
``--synthetic`` draws the batches from the pool of chip_smoke.py's entry
point instead (its synthetic scene, written under build/, 40,000 rays,
ordered by hit pattern and drawn in blocks as the trainer does). Prints the
card's ``name, power.limit``, seconds per step on the host clock, the
device's busy and idle share, and the device time by kernel, largest first
(kernels only, so nothing counts twice).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3, help="profiled steps")
    parser.add_argument("--view-pose", action="store_true",
                        help="the view-deform + pose-refinement model")
    parser.add_argument("--compositor-kernel", action="store_true",
                        help="TPU.COMPOSITOR_KERNEL on: the sort-free compositor")
    parser.add_argument("--synthetic", action="store_true",
                        help="the entry point's synthetic-scene pool")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stnerf_tpu_torch.engine import (make_decode, make_optimizer, make_train_step,
                                         pool_camera_num, sort_batch_by_hit,
                                         split_compact_bundle)
    from stnerf_tpu_torch.models import LayeredSpec

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    device = torch.device("cuda", 0)
    cfg = cs.view_pose_cfg() if args.view_pose else cs.taekwondo_cfg()
    cfg.SOLVER.WARMUP_ITERS = 1
    cfg.TPU.COMPOSITOR_KERNEL = args.compositor_kernel
    if args.synthetic:
        import numpy as np

        from stnerf_tpu_torch.config import get_cfg
        from stnerf_tpu_torch.data import make_synthetic_scene, make_train_data

        root = os.path.join(REPO, "build", "profile_synthetic")
        make_synthetic_scene(root, width=200, height=150, num_cams=12, num_frames=5,
                             layer_num=2, seed=cs.SEED)
        data_cfg = get_cfg()
        data_cfg.merge_from_file(cs.entry_point_cfg_file(root, ""))
        bundle, scene = make_train_data(data_cfg, LayeredSpec.from_cfg(data_cfg),
                                        np.random.default_rng(cs.SEED), workers=1,
                                        device=device)
    else:
        scene, _ = cs.scene_and_requests(device)
        bundle = cs.ring_bundle(scene)
    spec = LayeredSpec.from_cfg(cfg)
    spec = LayeredSpec.from_cfg(cfg, camera_num=pool_camera_num(bundle, spec))
    pool, tables, width = split_compact_bundle(bundle, device)
    decode = make_decode(tables, spec, width)
    model = cs.make_model(spec, device)
    opt, sched = make_optimizer(cfg, model)
    step = make_train_step(model, opt, sched, remove_outliers=True, device=device)
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    n = cfg.SOLVER.IMS_PER_BATCH

    block = 125 if args.synthetic else 1  # the trainer's draw from a hit-ordered pool

    def one_step():
        starts = torch.randint(0, pool.rgb.shape[0] // block, (n // block,), generator=gen,
                               device=device)
        idx = (starts[:, None] * block + torch.arange(block, device=device)).reshape(-1)
        batch = decode(type(pool)(*(x[idx] for x in pool)))
        if not spec.use_deform_view and block == 1:  # as the trainer's per-ray draws
            batch = sort_batch_by_hit(spec, scene, batch)
        return step(scene, batch, gen, 1.0, only_coarse=False)

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / args.steps
    busy = sum(by_name.values())
    print(json.dumps({"model": "view_pose" if args.view_pose else "taekwondo",
                      "pool": "synthetic" if args.synthetic else "ring",
                      "compositor_kernel": args.compositor_kernel,
                      "s_per_step": wall, "rays_per_s": n / wall,
                      "device_busy_ms_per_step": busy,
                      "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3))}))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"{ms:9.3f} ms/step  {100 * ms / busy:5.1f}%  {name[:110]}")


if __name__ == "__main__":
    main()
