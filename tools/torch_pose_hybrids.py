#!/usr/bin/env python3
"""Which part of K3 moves the pose-refinement gradients of a bf16 staged step.

    python3 tools/torch_pose_hybrids.py

On one CUDA card, one training step of ``chip_smoke.py``'s view-deform +
pose-refinement model on its ring pool (phase 8's step, batch 2000), from
the same weights, batch and sampling noise: the plain versions in float32
and in bf16, then the bf16 step through the kernels with single outputs of
K3 swapped for the plain version's on the same inputs: its backward's
d_pos_enc, d_dir_enc or weight gradients, or its whole forward. Prints,
per hybrid, the relative L2 distance from the bf16 plain step of the two
``cam_pose`` leaves and of the worst ``view_deform`` leaf, beside phase 8's
bars (``cam_pose``: max(1e-2, a tenth of the leaf's bf16 rounding error);
the rest 1e-2), and the card's ``name, power.limit``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from stnerf_tpu_torch.engine import make_optimizer, make_train_step
    from stnerf_tpu_torch.kernels import spacenet_vjp as sv
    from stnerf_tpu_torch.kernels._build import load_library
    from stnerf_tpu_torch.models import export_jax_params

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)
    load_library()
    scene, _ = cs.scene_and_requests(device)
    bundle = cs.ring_bundle(scene)
    kernel_fwd, kernel_bwd = sv.spacenet_fwd, sv.spacenet_bwd

    def swapped(parts):
        """K3's backward with the outputs at `parts` (0 gw, 1 gb, 2 d_pos,
        3 d_dir) taken from the plain version."""
        def bwd(field, *args):
            got = kernel_bwd(field, *args)
            if field.compute_dtype != "bfloat16":
                return got
            ref = sv.spacenet_bwd_reference(field, *args)
            return tuple(ref[i] if i in parts else g for i, g in enumerate(got))
        bwd.launches = bwd.launches_tc = 0  # the wrapper counts on its module name
        return bwd

    def step_grads(dtype, plain, bwd=None, fwd=None):
        cfg = cs.view_pose_cfg()
        cfg.TPU.COMPUTE_DTYPE = dtype
        cfg.SOLVER.WARMUP_ITERS = 1
        spec, batch = cs.train_batch(device, bundle, scene, cfg)
        model = cs.make_model(spec, device)
        opt, sched = make_optimizer(cfg, model)
        step = make_train_step(model, opt, sched, remove_outliers=True, plain=plain,
                               device=device)
        sv.spacenet_bwd, sv.spacenet_fwd = bwd or kernel_bwd, fwd or kernel_fwd
        try:  # the autograd Function looks both up in the module
            step(scene, batch, torch.Generator(device=device).manual_seed(cs.SEED), 1.0)
        finally:
            sv.spacenet_bwd, sv.spacenet_fwd = kernel_bwd, kernel_fwd
        torch.cuda.synchronize()
        return dict(cs._flat_leaves(export_jax_params(model, grad=True)))

    f32, p16 = step_grads("float32", True), step_grads("bfloat16", True)
    pose = [k for k in p16 if k.startswith("/cam_pose/")]
    bars = {k: max(1e-2, 0.1 * cs.compare_leaf(p16[k], f32[k])["rel"]) for k in pose}
    print("bars", json.dumps(bars), flush=True)
    hybrids = {"kernel": {}, "d_pos_plain": {"bwd": swapped({2})},
               "d_dir_plain": {"bwd": swapped({3})},
               "weight_grads_plain": {"bwd": swapped({0, 1})},
               "forward_plain": {"fwd": lambda f, *a: sv.spacenet_fwd_reference(f, *a)}}
    for name, kw in hybrids.items():
        g = step_grads("bfloat16", False, **kw)
        rel = {k: cs.compare_leaf(g[k], p16[k])["rel"] for k in p16}
        print("hybrid", name, json.dumps({
            "cam_pose": {k: rel[k] for k in pose},
            "view_deform_max": max(v for k, v in rel.items() if k.startswith("/view_deform/")),
            "other_max": max(v for k, v in rel.items()
                             if not k.startswith(("/cam_pose/", "/view_deform/")))}),
            flush=True)


if __name__ == "__main__":
    main()
