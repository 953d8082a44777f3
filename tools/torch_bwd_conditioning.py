#!/usr/bin/env python3
"""How far apart correct bf16 backward passes of the field land, on one CUDA card.

    python3 tools/torch_bwd_conditioning.py

For the four fields of ``chip_smoke.py``'s phase 4, on the inputs of a real
training step (``chip_smoke.real_bwd_inputs``) and on phase 4's seeded
inputs (M = 2000 x 120, random frame ids 1-100, positions in [-3, 3]^3,
normal cotangents), prints the largest relative L2 over the gradient
leaves between:

* ``kernel_vs_plain``: ``field_bwd`` (the tensor-core kernel) and
  ``field_bwd_reference`` on the card (phase 4's check);
* ``plain64_vs_plain``: the same plain version with its matrix products in
  float64 (the bf16 roundings unchanged) and the plain version;
* ``kernel_vs_plain64``: the kernel and that float64 version;
* ``own_error``: the bf16 plain version and the float32 one.

The first three differ only in how the float32 (or float64) sums are
ordered and rounded, so they show how much the inputs amplify a change of
summation order. One JSON line per field and input set, after the card's
``name, power.limit``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stnerf_tpu_torch.kernels._build import load_library
    from stnerf_tpu_torch.kernels.field_vjp import field_bwd, field_bwd_reference
    from stnerf_tpu_torch.kernels.fused_field import TILE
    from stnerf_tpu_torch.models import LayeredSpec, MotionNet, SpaceNet
    from stnerf_tpu_torch.ops.encoding import positional_encoding_planar

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    load_library()
    matmul = torch.Tensor.__matmul__

    def plain64(*args):
        """field_bwd_reference with every ``@`` in float64, rounded back to
        float32: its roundings to bf16 stay where they are."""
        torch.Tensor.__matmul__ = lambda a, b: torch.matmul(a.double(), b.double()).float()
        try:
            return field_bwd_reference(*args)
        finally:
            torch.Tensor.__matmul__ = matmul

    spec = LayeredSpec.from_cfg(cs.taekwondo_cfg())
    model = cs.make_model(spec, device)
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    direct_net = MotionNet(spec.motion_spec(input_time=False), gen).to(device)
    deep_net = SpaceNet(dataclasses.replace(spec.spacenet_spec(bkgd=False), deep_rgb=True),
                        gen).to(device)
    cases = [("performer_lerp", model.layers_fine[0], model.motion[0], "lerp"),
             ("background", model.bkgd_fine, None, None),
             ("background_direct", model.bkgd_fine, direct_net, "direct"),
             ("performer_deep_rgb", deep_net, model.motion[0], "lerp")]

    m = 2000 * 120
    rng = np.random.default_rng(cs.SEED + 2)   # phase 4's seeded inputs

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device).contiguous()

    xyz = t(rng.uniform(-3.0, 3.0, (3, m)))
    ids = t(rng.integers(1, 101, (1, m)) + rng.choice([0.0, 0.25, 0.5], (1, m)))
    d = rng.normal(size=(3, m))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dir_enc = positional_encoding_planar(t(d), 4, True, recursive=True).contiguous()
    cot = (t(rng.normal(size=(3, m))), t(rng.normal(size=m)))
    flags = torch.tensor((rng.random(-(-m // TILE)) > 0.25).astype(np.int32), device=device)
    seeded = (xyz, ids, dir_enc, *cot, flags)
    real = cs.real_bwd_inputs(device)

    def worst(field, a, b):
        stats = cs._leaf_stats(field, a, b)
        k = max(stats, key=lambda s: stats[s]["rel"])
        return [k, stats[k]["rel"]]

    for name, net, mnet, mode in cases:
        f = cs.pack_dtype(net, mnet, mode, "bfloat16")
        f32 = cs.pack_dtype(net, mnet, mode, "float32")
        real_args = real["performer" if name.startswith("performer") else "background"]
        for inputs, args in (("real", real_args), ("seeded", seeded)):
            kernel = field_bwd(f, *args)
            plain = field_bwd_reference(f, *args)
            p64 = plain64(f, *args)
            row = {"case": name, "inputs": inputs, "m": int(args[0].shape[1]),
                   "kernel_vs_plain": worst(f, kernel, plain),
                   "plain64_vs_plain": worst(f, p64, plain),
                   "kernel_vs_plain64": worst(f, kernel, p64),
                   "own_error": worst(f, plain, field_bwd_reference(f32, *args))}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
