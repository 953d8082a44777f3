#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time on a CUDA card.

    python3 tools/torch_profile_train.py [--steps 3]

Builds the taekwondo model of ``chip_smoke.py`` (random weights from its
seed) and its 40,000-ray ring pool, runs warm-up steps, then profiles full
(coarse + fine) training steps at batch 2000 through the kernels with
``torch.profiler``. Prints the card's ``name, power.limit``, seconds per
step on the host clock, the device's busy and idle share, and the device
time by kernel, largest first (kernels only, so nothing counts twice).
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stnerf_tpu_torch.engine import (make_decode, make_optimizer, make_train_step,
                                         sort_batch_by_hit, split_compact_bundle)
    from stnerf_tpu_torch.models import LayeredSpec

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    device = torch.device("cuda", 0)
    cfg = cs.taekwondo_cfg()
    cfg.SOLVER.WARMUP_ITERS = 1
    spec = LayeredSpec.from_cfg(cfg)
    scene, _ = cs.scene_and_requests(device)
    pool, tables, width = split_compact_bundle(cs.ring_bundle(scene), device)
    decode = make_decode(tables, spec, width)
    model = cs.make_model(spec, device)
    opt, sched = make_optimizer(cfg, model)
    step = make_train_step(model, opt, sched, remove_outliers=True, device=device)
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    n = cfg.SOLVER.IMS_PER_BATCH

    def one_step():
        idx = torch.randint(0, pool.rgb.shape[0], (n,), generator=gen, device=device)
        batch = sort_batch_by_hit(spec, scene, decode(type(pool)(*(x[idx] for x in pool))))
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
    print(json.dumps({"s_per_step": wall, "rays_per_s": n / wall,
                      "device_busy_ms_per_step": busy,
                      "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3))}))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"{ms:9.3f} ms/step  {100 * ms / busy:5.1f}%  {name[:110]}")


if __name__ == "__main__":
    main()
