#!/usr/bin/env python3
"""Compare the view-pose phases of two checkouts of the PyTorch port on one
CUDA card.

    python3 tools/torch_ab_phases.py OTHER_CHECKOUT [--rounds 1]

Runs ``chip_smoke.py``'s K3 phase (kernel vs plain at M = 2000 x 120), its
view-pose render phase (three requests at 480x270) and its view-pose
training phase (one coarse-only and one full epoch of 20 steps at batch
2000) from OTHER_CHECKOUT and from this one, each in a
fresh process from its own root (so each builds and loads its own
kernels), in the order other, this, this, other (``--rounds`` times that
pair). Every phase keeps its own checks. Prints the card's ``name,
power.limit``, then one JSON line per run: K3's bf16 forward and backward
ms on the performer field, seconds per pose by request, seconds per step
by epoch, and the launches. Compare the two checkouts
only within one invocation.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run in the checkout's root: its chip_smoke, its package, its kernels
CHILD = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from stnerf_tpu_torch.kernels._build import load_library
torch.backends.cuda.matmul.allow_tf32 = False
device = torch.device("cuda", 0)
load_library()
cfg = cs.taekwondo_cfg()
k3 = cs.phase_spacenet_vs_plain(device, m=cfg.SOLVER.IMS_PER_BATCH * 120, reps=5)[0]
render = cs.phase_view_pose_render(device, h=270, w=480, chunk=cfg.TPU.RENDER_CHUNK,
                                   tile_cols=cfg.TPU.TILE_COLS)
scene, _ = cs.scene_and_requests(device)
train = cs.phase_view_pose_train(device, cs.ring_bundle(scene), scene)
print("AB " + json.dumps({"k3_bf16_ms": [k3["bfloat16_fwd_ms"], k3["bfloat16_bwd_ms"]],
                          "s_per_pose": render["kernel_s_per_pose"],
                          "render_launches": render["launches"],
                          "s_per_step": train["s_per_step"],
                          "train_launches": [train["launches_fwd"], train["launches_bwd"]]}))
"""


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root, check=True,
                         stdout=subprocess.PIPE, text=True).stdout
    return json.loads(next(l for l in out.splitlines() if l.startswith("AB "))[3:])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="root of the other checkout")
    parser.add_argument("--rounds", type=int, default=1,
                        help="pairs of (other, this, this, other)")
    args = parser.parse_args()
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "chip_smoke.py")):
        raise SystemExit(f"{other} holds no chip_smoke.py")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for _ in range(args.rounds):
        for name, root in (("other", other), ("this", REPO), ("this", REPO),
                           ("other", other)):
            print(json.dumps({"checkout": name, **run(root)}), flush=True)


if __name__ == "__main__":
    main()
