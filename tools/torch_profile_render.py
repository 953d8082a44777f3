#!/usr/bin/env python3
"""Where a posed render of the PyTorch port spends its time on a CUDA card.

    python3 tools/torch_profile_render.py [--poses 2] [--view-pose]

Builds the taekwondo model of ``chip_smoke.py`` (random weights from its
seed) and renders its plain request at 480x270 through
``render_pose_host`` (chunk 4096, 64-pixel tiles): one warm-up pose, then
profiled poses with ``torch.profiler``. ``--view-pose`` takes the model
with view deformation and pose refinement instead (the staged path, K3).
Prints the card's ``name, power.limit``, seconds per pose on the host
clock, the device's busy and idle share, and the device time by kernel,
largest first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--poses", type=int, default=2, help="profiled poses")
    parser.add_argument("--view-pose", action="store_true",
                        help="the view-deform + pose-refinement model")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stnerf_tpu_torch.models import LayeredSpec
    from stnerf_tpu_torch.render.pose_device import render_pose_host

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    device = torch.device("cuda", 0)
    cfg = cs.view_pose_cfg() if args.view_pose else cs.taekwondo_cfg()
    model = cs.make_model(LayeredSpec.from_cfg(cfg, camera_num=8), device)
    scene, requests = cs.scene_and_requests(device)
    h, w = 270, 480
    K = np.array([[w, 0, w / 2], [0, h, h / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, -5.0]
    near_far = np.array([0.5, 12.0], np.float32)

    def pose():
        return render_pose_host(model, scene, K, c2w, [1.0, 1.0, 1.0], near_far,
                                requests[0][2], h, w, chunk=cfg.TPU.RENDER_CHUNK,
                                tile_cols=cfg.TPU.TILE_COLS)

    pose()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.poses):
            pose()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.poses
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / args.poses
    busy = sum(by_name.values())
    print(json.dumps({"model": "view_pose" if args.view_pose else "taekwondo",
                      "s_per_pose": wall, "device_busy_ms_per_pose": busy,
                      "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3))}))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"{ms:9.3f} ms/pose  {100 * ms / busy:5.1f}%  {name[:110]}")


if __name__ == "__main__":
    main()
