#!/usr/bin/env python3
"""Compare phases of two checkouts of the PyTorch port on one CUDA card.

    python3 tools/torch_ab_phases.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]
        [--set view_pose|field] [--rounds 1]

Runs ``chip_smoke.py``'s phases from each OTHER_CHECKOUT and from this one,
each in a fresh process from its own root (so each builds and loads its own
kernels), in the order other, this, this, other (with two others a and b:
a, b, this, this, b, a), ``--rounds`` times. Every phase keeps its own
checks. Prints the card's ``name, power.limit``, then one JSON line per
run. Compare checkouts only within one invocation.

* ``view_pose`` (default): the K3 phase (kernel vs plain at M = 2000 x
  120), the view-pose render phase (three requests at 480x270) and the
  view-pose training phase (one coarse-only and one full epoch of 20 steps
  at batch 2000): K3's bf16 and float32 forward and backward ms on the
  performer field, seconds per pose by request, seconds per step by epoch,
  the launches; and K2's bf16 ms on phase 4's seeded inputs (M = 2000 x
  120, 25% of tiles off) for the performer and the background field, the
  kernel that shares K3's backward passes.
* ``field``: the K1 phase (M = 4096 x 120, 25% of tiles off), the render
  phase (five requests at 480x270 on the taekwondo model), the K2 phase
  (M = 2000 x 120) and the fused training phase (one coarse-only and one
  full epoch of 20 steps at batch 2000 on the ring pool): K1's and K2's
  bf16 and float32 ms on the performer field (and K2's bf16 ms on the
  background), seconds per pose by request,
  seconds per step by epoch, the launches.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run in the checkout's root: its chip_smoke, its package, its kernels
PRELUDE = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from stnerf_tpu_torch.kernels._build import load_library
torch.backends.cuda.matmul.allow_tf32 = False
device = torch.device("cuda", 0)
load_library()
cfg = cs.taekwondo_cfg()
"""
CHILD = {"view_pose": PRELUDE + """
import numpy as np
from stnerf_tpu_torch.kernels.field_vjp import field_bwd
from stnerf_tpu_torch.models import LayeredSpec
from stnerf_tpu_torch.ops.encoding import positional_encoding_planar
m = cfg.SOLVER.IMS_PER_BATCH * 120
model = cs.make_model(LayeredSpec.from_cfg(cfg), device)
rng = np.random.default_rng(cs.SEED + 2)
t = lambda a: torch.tensor(a, dtype=torch.float32, device=device).contiguous()
d = rng.normal(size=(3, m))
d /= np.linalg.norm(d, axis=0, keepdims=True)
seeded = (t(rng.uniform(-3.0, 3.0, (3, m))),
          t(rng.integers(1, 101, (1, m)) + rng.choice([0.0, 0.25, 0.5], (1, m))),
          positional_encoding_planar(t(d), 4, True, recursive=True).contiguous(),
          t(rng.normal(size=(3, m))), t(rng.normal(size=m)),
          torch.tensor((rng.random(-(-m // 64)) > 0.25).astype(np.int32), device=device))
k2 = {}
for name, net, mnet, mode in (("performer", model.layers_fine[0], model.motion[0], "lerp"),
                              ("background", model.bkgd_fine, None, None)):
    f = cs.pack_dtype(net, mnet, mode, "bfloat16")
    k2[name] = cs.cuda_ms(lambda: field_bwd(f, *seeded), 5)
k3 = cs.phase_spacenet_vs_plain(device, m=m, reps=5)[0]
render = cs.phase_view_pose_render(device, h=270, w=480, chunk=cfg.TPU.RENDER_CHUNK,
                                   tile_cols=cfg.TPU.TILE_COLS)
scene, _ = cs.scene_and_requests(device)
train = cs.phase_view_pose_train(device, cs.ring_bundle(scene), scene)
print("AB " + json.dumps({"k3_bf16_ms": [k3["bfloat16_fwd_ms"], k3["bfloat16_bwd_ms"]],
                          "k3_f32_ms": [k3["float32_fwd_ms"], k3["float32_bwd_ms"]],
                          "k2_bf16_ms": k2,
                          "s_per_pose": render["kernel_s_per_pose"],
                          "render_launches": render["launches"],
                          "s_per_step": train["s_per_step"],
                          "train_launches": [train["launches_fwd"], train["launches_bwd"]]}))
""", "field": PRELUDE + """
k1 = cs.phase_kernel_vs_plain(device, m=4096 * 120, reps=5)[0]
render = cs.phase_slice(device, h=270, w=480, chunk=cfg.TPU.RENDER_CHUNK,
                        tile_cols=cfg.TPU.TILE_COLS)
k2, k2_bkgd = cs.phase_field_bwd_vs_plain(device, m=cfg.SOLVER.IMS_PER_BATCH * 120,
                                          reps=3)[:2]
scene, _ = cs.scene_and_requests(device)
train = cs.phase_train(device, cs.ring_bundle(scene), scene)
print("AB " + json.dumps({"k1_ms": {k: k1[k] for k in ("bfloat16_ms", "float32_ms")},
                          "k2_ms": {k: k2[k] for k in ("bfloat16_ms", "float32_ms")},
                          "k2_background_bf16_ms": k2_bkgd["bfloat16_ms"],
                          "s_per_pose": render["kernel_s_per_pose"],
                          "render_launches": render["launches"],
                          "s_per_step": train["s_per_step"],
                          "train_launches": [train["launches_fused_field"], train["launches"]]}))
"""}


def run(root: str, phases: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD[phases]], cwd=root, check=True,
                         stdout=subprocess.PIPE, text=True).stdout
    return json.loads(next(l for l in out.splitlines() if l.startswith("AB "))[3:])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("others", nargs="+", help="roots of the other checkouts")
    parser.add_argument("--set", dest="phases", choices=sorted(CHILD), default="view_pose",
                        help="which phases to time")
    parser.add_argument("--rounds", type=int, default=1,
                        help="repeats of (others, this, this, others reversed)")
    args = parser.parse_args()
    others = [os.path.abspath(o) for o in args.others]
    for other in others:
        if not os.path.isfile(os.path.join(other, "chip_smoke.py")):
            raise SystemExit(f"{other} holds no chip_smoke.py")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    order = [*others, REPO, REPO, *reversed(others)]
    for _ in range(args.rounds):
        for root in order:
            name = "this" if root == REPO else os.path.relpath(root, REPO)
            print(json.dumps({"checkout": name, **run(root, args.phases)}), flush=True)


if __name__ == "__main__":
    main()
