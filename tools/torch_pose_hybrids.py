#!/usr/bin/env python3
"""Which kernel moves the pose-refinement gradients of a bf16 training step.

    python3 tools/torch_pose_hybrids.py [--path staged|fused|fast_fine]

On one CUDA card, one training step of one of ``chip_smoke.py``'s
pose-refining models on its ring pool (batch 2000), from the same weights,
batch and sampling noise: the plain versions in float32 and in bf16, then
the bf16 step through the kernels with single outputs of the path's field
kernels swapped for the plain version's on the same inputs: the backward's
position and direction gradients, its weight gradients, the whole backward
or the whole forward. ``staged`` (the default) is phase 8's view-deform
model, whose fields run K3 (``spacenet_fwd``, ``spacenet_bwd``); ``fused``
and ``fast_fine`` are phase 14's taekwondo model with pose refinement on
the exact and the fast fine training path, whose fields run K1 and K2
(``fused_field``, ``field_bwd``). Prints, per hybrid, the relative L2
distance from the bf16 plain step of the two ``cam_pose`` leaves, of the
worst ``view_deform`` leaf and of the worst other leaf, beside phase 8's
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
    import argparse

    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from stnerf_tpu_torch.engine import make_optimizer, make_train_step
    from stnerf_tpu_torch.kernels import field_vjp, spacenet_vjp
    from stnerf_tpu_torch.kernels._build import load_library
    from stnerf_tpu_torch.models import export_jax_params

    parser = argparse.ArgumentParser()
    parser.add_argument("--path", choices=("staged", "fused", "fast_fine"), default="staged")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)
    load_library()
    scene, _ = cs.scene_and_requests(device)
    bundle = cs.ring_bundle(scene)
    # the module whose kernel wrappers the path's autograd Function looks up
    # at call time, their names, plain versions and the model's config
    mod, fwd_name, bwd_name, cfg_fn = {
        "staged": (spacenet_vjp, "spacenet_fwd", "spacenet_bwd", cs.view_pose_cfg),
        "fused": (field_vjp, "fused_field", "field_bwd", cs.pose_cfg),
        "fast_fine": (field_vjp, "fused_field", "field_bwd", cs.fast_fine_cfg)}[args.path]
    kernel_fwd, kernel_bwd = getattr(mod, fwd_name), getattr(mod, bwd_name)
    fwd_ref, bwd_ref = (getattr(mod, f"{fwd_name}_reference"),
                        getattr(mod, f"{bwd_name}_reference"))

    def swapped(parts):
        """The backward with the outputs at `parts` (0 gw, 1 gb, 2 d_pos or
        d_xyz, 3 d_dir) taken from the plain version."""
        def bwd(field, *args):
            got = kernel_bwd(field, *args)
            if field.compute_dtype != "bfloat16":
                return got
            ref = bwd_ref(field, *args)
            return tuple(ref[i] if i in parts else g for i, g in enumerate(got))
        bwd.launches = bwd.launches_tc = 0  # the wrapper counts on its module name
        return bwd

    def step_grads(dtype, plain, bwd=None, fwd=None):
        cfg = cfg_fn()
        cfg.TPU.COMPUTE_DTYPE = dtype
        cfg.SOLVER.WARMUP_ITERS = 1
        spec, batch = cs.train_batch(device, bundle, scene, cfg)
        model = cs.make_model(spec, device)
        opt, sched = make_optimizer(cfg, model)
        step = make_train_step(model, opt, sched, remove_outliers=True, plain=plain,
                               device=device)
        setattr(mod, bwd_name, bwd or kernel_bwd)
        setattr(mod, fwd_name, fwd or kernel_fwd)
        try:  # the autograd Function looks both up in the module
            step(scene, batch, torch.Generator(device=device).manual_seed(cs.SEED), 1.0)
        finally:
            setattr(mod, bwd_name, kernel_bwd)
            setattr(mod, fwd_name, kernel_fwd)
        torch.cuda.synchronize()
        return dict(cs._flat_leaves(export_jax_params(model, grad=True)))

    f32, p16 = step_grads("float32", True), step_grads("bfloat16", True)
    pose = [k for k in p16 if k.startswith("/cam_pose/")]
    bars = {k: max(1e-2, 0.1 * cs.compare_leaf(p16[k], f32[k])["rel"]) for k in pose}
    print("bars", args.path, json.dumps(bars), flush=True)
    hybrids = {"kernel": {}, "d_pos_plain": {"bwd": swapped({2})},
               "d_dir_plain": {"bwd": swapped({3})},
               "weight_grads_plain": {"bwd": swapped({0, 1})},
               "backward_plain": {"bwd": swapped({0, 1, 2, 3})},
               "forward_plain": {"fwd": lambda f, *a, **kw: fwd_ref(f, *a)}}
    for name, kw in hybrids.items():
        g = step_grads("bfloat16", False, **kw)
        rel = {k: cs.compare_leaf(g[k], p16[k])["rel"] for k in p16}
        print("hybrid", args.path, name, json.dumps({
            "cam_pose": {k: rel[k] for k in pose},
            "view_deform_max": max((v for k, v in rel.items() if k.startswith("/view_deform/")),
                                   default=None),
            "other_max": max((v, k) for k, v in rel.items()
                             if not k.startswith(("/cam_pose/", "/view_deform/")))}),
            flush=True)


if __name__ == "__main__":
    main()
