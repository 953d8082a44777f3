#!/usr/bin/env python3
"""Compare phases of two checkouts of the PyTorch port on one CUDA card.

    python3 tools/torch_ab_phases.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]
        [--set view_pose|field|kernels|k1_f32|k3_f32|cross|bwd] [--rounds 1]

Runs ``chip_smoke.py``'s phases from each OTHER_CHECKOUT and from this one,
each in a fresh process from its own root (so each builds and loads its own
kernels), in the order other, this, this, other (with two others a and b:
a, b, this, this, b, a), ``--rounds`` times. Every phase keeps its own
checks. Prints the card's ``name, power.limit``, then one JSON line per
run, and last a ``summary`` line: which digests of this checkout (every
key ending in "digest" or "digests") equal the first other checkout's and
which differ. It fails nothing: a change that is meant to move some bits
shows there which. Compare checkouts only within one invocation.

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
  bf16 and float32 ms on the performer field (K1's bf16 also ``checked``,
  the training forward; and K2's bf16 ms on the background), seconds per
  pose by request, seconds per step by epoch, the launches. Then K3's bf16
  forward on phase 6's performer encodings (M = 2000 x 120) and K6's
  planar entry on phase 6's K6 shape (M = 65,536), ms and a digest of each
  (and of K1's bf16 render and checked routes on phase 2's inputs). Then
  the float32 backward
  kernels alike in every checkout: K2 on phase 4's seeded inputs and K3's
  backward on phase 6's performer encodings (M = 2000 x 120), float32 ms
  and a digest of the bf16 route's outputs (sha256 of their bytes: equal
  digests, bitwise equal gradients); a float32 full training step of the
  taekwondo model (seconds of a second step, peak device memory); and one
  float32 run of phase 18(a)'s training (sort-free, seed 0, seconds).
* ``kernels``: K1's bf16 ms on phase 2's performer inputs (M = 4096 x 120,
  25% of tiles off), also with ``checked`` (the training forward) where the
  checkout's ``fused_field`` takes it, and K3's bf16 forward ms on phase
  6's performer encodings (M = 2000 x 120), each timed alike by this
  checkout's ``chip_smoke.cuda_ms``; and ptxas's registers, stack and
  spills for the tensor-core K1 and K3 forward kernels of the checkout's
  build (by sample block where a checkout has several).
* ``k1_f32``: K1's float32 route. A digest of its outputs (sha256 of
  their bytes: equal digests, the same bits) in every case of phase 2 on
  phase 2's inputs: the four fields at M = 4096 x 120 with 25% of the
  tiles off, then the edges at M = 122,045 (the narrow 64/32/32 fields, a
  96/48/48 performer, which a checkout that pads no widths refuses, and
  the ragged M with all tiles on, a quarter off, all off and no flags),
  each run twice ("differs run to run" if the two differ), and the bf16
  route's digests (render, run twice, and ``checked``) in the same cases;
  its ms on the
  performer and the background at phase 2's shape; the bf16 routes' K1 ms
  and output digest there and K2's on phase 4's seeded inputs (K2's ms
  also first of all, before any float32 call); a digest of
  every gradient of phase 5's float32 step through the kernels (two fresh
  runs) and the seconds of a second step.
* ``k3_f32``: K3's float32 forward. Digests (as ``k1_f32``'s, each run
  twice) of its outputs and of the three K6 entries' float32 outputs
  (planar, row-major, stacked with one weight set) in every case of phase
  6 on phase 6's encodings: the performer with time, the background, the
  4-layer rgb head and no directions at M = 2000 x 120, then the narrow
  64/32 fields, a 96/48 performer and the ragged M = 122,045 with the
  ``active`` flag unset, 1 and 0 (0: "zeros" when every output is exactly
  zero), and the bf16 route's digests of K3 and the three K6 entries in the
  same cases; K3's float32 ms on four of them; the K6 entries' float32 ms and
  digests at phase 6's K6 shape (M = 65,536, two weight sets); K1's
  float32 digests and ms as ``k1_f32``; the bf16 routes' digests (K1, K2,
  K3's forward and backward); a digest of every gradient of phase 8's
  float32 staged step through the kernels (two fresh runs) and the seconds
  of a second step.
* ``cross``: K4 and K5 (forward and backward) at (3, 2000, 120) and (3,
  2000, 90) on ``chip_smoke.cross_inputs`` (sorted streams), each timed
  alike in every checkout by this checkout's ``chip_smoke``: the device
  time (``graph_ms``: 50 calls replayed from a CUDA graph) and a call's
  time from the host (``cuda_ms``); the checkout's own phase 9 (its
  checks); phase 10, the sort-free compositor's forward + backward ms at
  (3, 2000, 120); and phase 11's entry point (the ``train`` CLI on the
  synthetic scene with TPU.COMPOSITOR_KERNEL on, one coarse-only and two
  full epochs of 20 steps): seconds per step by epoch and K4/K5's
  launches.
* ``bwd``: the four backward routes (K2 and K3's backward, bf16 and
  float32) at the widths up to 256. A digest (sha256 of the bytes of the
  weight and bias gradients and both input gradients; each run twice,
  "differs run to run" if the two differ) in every case of phases 4 and 6
  on seeded inputs: K2 on phase 4's four fields at M = 2000 x 120 with
  25% of the tiles off, then its edges at M = 122,045 (the narrow 64/32/32
  fields, a 96/48/48 performer, the ragged M with all tiles on, a quarter
  off, all off and no flags); K3 on phase 6's four fields at M = 2000 x
  120, then the narrow 64/32 fields, a 96/48 performer and the ragged M
  with the ``active`` flag unset, 1 and 0. Each route's ms on the performer
  and the background (10 calls each, timed alike by each checkout's
  ``chip_smoke.cuda_ms``). Then, in every bf16 case of phases 4 and 6 on
  the inputs those phases hold the bf16 route on (K2: a real training
  step's, ``real_bwd_inputs``; K3: the seeded encodings), each leaf's
  relative L2 distance from the plain version and, per layer, the pass-1
  records that are not the k-order rounding of their layer (this
  checkout's ``chip_smoke.bwd_records_check``, run against each checkout's
  kernels; a checkout whose wrappers take no ``workspace`` is launched
  through its C entry points with one). The bf16 digests of a checkout
  whose bf16 backward rounds its recompute otherwise differ by design; the
  closing ``summary`` line says which digests match the first other
  checkout's, and fails nothing. Last, a bf16 full training step of the
  taekwondo model at batch 2000 (phase 5's model and batch), the seconds
  of steps 2-6 from the host.
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
import hashlib, time
import numpy as np
from stnerf_tpu_torch.engine import make_optimizer, make_train_step
from stnerf_tpu_torch.kernels.field_vjp import field_bwd
from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_bwd
from stnerf_tpu_torch.models import LayeredSpec
from stnerf_tpu_torch.ops.encoding import positional_encoding_planar
def digest(ts):
    h = hashlib.sha256()
    for x in ts:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]
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
vp = cs.make_model(LayeredSpec.from_cfg(cs.view_pose_cfg(), camera_num=8), device)
x = cs._encoded_inputs(device, m, cs.SEED + 5)
k3_args = (x["pos"], x["dir"], x["time"], x["d_rgb"], x["d_sigma"])
# K3's bf16 forward and K6's planar entry (its kernel), ms and digests
from stnerf_tpu_torch.kernels.fused_spacenet import fused_spacenet_planar
from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_fwd
g = cs.pack_dtype(vp.layers_fine[0], None, None, "bfloat16")
x6 = cs._encoded_inputs(device, 65536, cs.SEED + 6)
g6 = cs.pack_dtype(vp.layers_coarse[0], None, None, "bfloat16")
fwd_calls = {"k3_fwd_bf16": lambda: spacenet_fwd(g, *k3_args[:3]),
             "k6_planar_bf16": lambda: fused_spacenet_planar(g6, x6["pos"], x6["dir"],
                                                             x6["time"])}
fwd = {f"{k}_ms": cs.cuda_ms(fn, 10) for k, fn in fwd_calls.items()}
fwd_digests = {k: digest(fn()) for k, fn in fwd_calls.items()}
bwd = {}
for dt in ("float32", "bfloat16"):
    f2 = cs.pack_dtype(model.layers_fine[0], model.motion[0], "lerp", dt)
    f3 = cs.pack_dtype(vp.layers_fine[0], None, None, dt)
    for name, fn in (("k2", lambda: field_bwd(f2, *seeded)), ("k3_bwd", lambda: spacenet_bwd(f3, *k3_args))):
        bwd[f"{name}_{dt}_ms"] = cs.cuda_ms(fn, 5)
        if dt == "bfloat16":
            bwd[f"{name}_bf16_digest"] = digest(fn())
scene, _ = cs.scene_and_requests(device)
bundle = cs.ring_bundle(scene)
cfg32 = cs.taekwondo_cfg()
cfg32.TPU.COMPUTE_DTYPE = "float32"
cfg32.SOLVER.WARMUP_ITERS = 1
spec32, batch = cs.train_batch(device, bundle, scene, cfg32)
net = cs.make_model(spec32, device)
opt, sched = make_optimizer(cfg32, net)
step = make_train_step(net, opt, sched, remove_outliers=True, plain=False, device=device)
step(scene, batch, torch.Generator(device=device).manual_seed(cs.SEED), 1.0)
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats(device)
t0 = time.perf_counter()
step(scene, batch, torch.Generator(device=device).manual_seed(cs.SEED + 1), 1.0)
torch.cuda.synchronize()
f32_step = {"s": time.perf_counter() - t0, "peak_bytes": torch.cuda.max_memory_allocated(device)}
del net, opt, step
_, _, trained_s, _ = cs.train_trained(device, cs.trained_setup(device), True, cs.SEED, False,
                                      "float32")
k1 = cs.phase_kernel_vs_plain(device, m=4096 * 120, reps=5)[0]
render = cs.phase_slice(device, h=270, w=480, chunk=cfg.TPU.RENDER_CHUNK,
                        tile_cols=cfg.TPU.TILE_COLS)
k2, k2_bkgd = cs.phase_field_bwd_vs_plain(device, m=cfg.SOLVER.IMS_PER_BATCH * 120,
                                          reps=3)[:2]
scene, _ = cs.scene_and_requests(device)
train = cs.phase_train(device, cs.ring_bundle(scene), scene)
from stnerf_tpu_torch.kernels.fused_field import fused_field
rng = np.random.default_rng(cs.SEED)
m2 = 4096 * 120
xyz2 = t(rng.uniform(-3.0, 3.0, (3, m2)))
ids2 = t(rng.integers(1, 101, (1, m2)) + rng.choice([0.0, 0.25, 0.5], (1, m2)))
d2 = rng.normal(size=(3, m2))
d2 /= np.linalg.norm(d2, axis=0, keepdims=True)
dir2 = positional_encoding_planar(t(d2), 4, True).contiguous()
flags2 = torch.tensor((rng.random(-(-m2 // 64)) > 0.25).astype(np.int32), device=device)
f1 = cs.pack_dtype(model.layers_coarse[0], model.motion[0], "lerp", "bfloat16")
fwd_digests["k1_bf16_render"] = digest(fused_field(f1, xyz2, ids2, dir2, flags2))
fwd_digests["k1_bf16_checked"] = digest(fused_field(f1, xyz2, ids2, dir2, flags2, checked=True))
print("AB " + json.dumps({"k1_ms": {k: k1[k] for k in ("bfloat16_ms", "bfloat16_checked_ms",
                                                      "float32_ms") if k in k1},
                          "fwd_ms": fwd, "fwd_digests": fwd_digests,
                          "k2_ms": {k: k2[k] for k in ("bfloat16_ms", "float32_ms")},
                          "k2_background_bf16_ms": k2_bkgd["bfloat16_ms"],
                          "s_per_pose": render["kernel_s_per_pose"],
                          "render_launches": render["launches"],
                          "s_per_step": train["s_per_step"],
                          "train_launches": [train["launches_fused_field"], train["launches"]],
                          "f32_step_kernel_vs_plain_s": [train["steps"][1]["kernel_s_per_step"],
                                                         train["steps"][1]["plain_s_per_step"]],
                          "bwd": bwd, "f32_step": f32_step,
                          "trained_f32_nosort_s": trained_s}))
"""}
CHILD["kernels"] = PRELUDE + """
import importlib.util, inspect, re
import numpy as np
from stnerf_tpu_torch.kernels._build import BUILD_DIR
from stnerf_tpu_torch.kernels.fused_field import fused_field
from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_fwd
from stnerf_tpu_torch.models import LayeredSpec
from stnerf_tpu_torch.ops.encoding import positional_encoding_planar
spec = importlib.util.spec_from_file_location("timing", sys.argv[1])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
m = 4096 * 120
model = cs.make_model(LayeredSpec.from_cfg(cfg), device)
rng = np.random.default_rng(cs.SEED)
t = lambda a: torch.tensor(a, dtype=torch.float32, device=device).contiguous()
xyz = t(rng.uniform(-3.0, 3.0, (3, m)))
ids = t(rng.integers(1, 101, (1, m)) + rng.choice([0.0, 0.25, 0.5], (1, m)))
d = rng.normal(size=(3, m))
d /= np.linalg.norm(d, axis=0, keepdims=True)
dir_enc = positional_encoding_planar(t(d), 4, True).contiguous()
flags = torch.tensor((rng.random(-(-m // 64)) > 0.25).astype(np.int32), device=device)
f = cs.pack_dtype(model.layers_coarse[0], model.motion[0], "lerp", "bfloat16")
out = {"k1_bf16_ms": timing.cuda_ms(lambda: fused_field(f, xyz, ids, dir_enc, flags), 10)}
if "checked" in inspect.signature(fused_field).parameters:
    out["k1_bf16_checked_ms"] = timing.cuda_ms(
        lambda: fused_field(f, xyz, ids, dir_enc, flags, checked=True), 10)
vp = cs.make_model(LayeredSpec.from_cfg(cs.view_pose_cfg(), camera_num=8), device)
x = cs._encoded_inputs(device, 2000 * 120, cs.SEED + 5)
g = cs.pack_dtype(vp.layers_fine[0], None, None, "bfloat16")
out["k3_fwd_bf16_ms"] = timing.cuda_ms(lambda: spacenet_fwd(g, x["pos"], x["dir"], x["time"]),
                                       10)
ptxas, name = {}, None
for line in "".join(p.read_text() for p in sorted(BUILD_DIR.glob("*.log"))).splitlines():
    if "entry function" in line:
        name = next((k for k in ("fused_field_tc_kernel", "spacenet_fwd_tc_kernel")
                     if k in line), None)
        block = re.search(r"kernelILi(\\d+)E", line)
        name = name and name + (f"<{block.group(1)}>" if block else "") + (
            "<true>" if "Lb1E" in line else "")
    elif name and ("registers" in line or "spill" in line):
        ptxas.setdefault(name, []).append(line.strip())
out["ptxas"] = ptxas
print("AB " + json.dumps(out))
"""
K1_CASES = """
import dataclasses, hashlib, time
import numpy as np
from stnerf_tpu_torch.engine import make_optimizer, make_train_step
from stnerf_tpu_torch.kernels.field_vjp import field_bwd
from stnerf_tpu_torch.kernels.fused_field import fused_field
from stnerf_tpu_torch.models import LayeredSpec, MotionNet, SpaceNet, export_jax_params
from stnerf_tpu_torch.ops.encoding import positional_encoding_planar
def digest(ts):
    h = hashlib.sha256()
    for x in ts:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]
t = lambda a: torch.tensor(a, dtype=torch.float32, device=device).contiguous()
def inputs(m, seed, recursive):
    rng = np.random.default_rng(seed)
    xyz = t(rng.uniform(-3.0, 3.0, (3, m)))
    ids = t(rng.integers(1, 101, (1, m)) + rng.choice([0.0, 0.25, 0.5], (1, m)))
    d = rng.normal(size=(3, m))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dir_enc = positional_encoding_planar(t(d), 4, True, recursive=recursive).contiguous()
    return rng, xyz, ids, dir_enc
def widths(w, h, mw):
    c = cs.taekwondo_cfg()
    c.merge_from_list(["MODEL.BACKBONE_DIM", w, "MODEL.HEAD_DIM", h, "MODEL.MOTION_DIM", mw])
    return cs.make_model(LayeredSpec.from_cfg(c), device)
spec = LayeredSpec.from_cfg(cfg)
model = cs.make_model(spec, device)
# K2's bf16 route on phase 4's seeded inputs, first of all
m4 = cfg.SOLVER.IMS_PER_BATCH * 120
rng, x4, i4, d4 = inputs(m4, cs.SEED + 2, True)
seeded4 = (x4, i4, d4, t(rng.normal(size=(3, m4))), t(rng.normal(size=m4)),
           torch.tensor((rng.random(-(-m4 // 64)) > 0.25).astype(np.int32), device=device))
f2 = cs.pack_dtype(model.layers_fine[0], model.motion[0], "lerp", "bfloat16")
k2_first_ms = cs.cuda_ms(lambda: field_bwd(f2, *seeded4), 5)
# phase 2's four cases on its inputs, then its edges on theirs
gen = torch.Generator().manual_seed(cs.SEED + 1)
direct_net = MotionNet(spec.motion_spec(input_time=False), gen).to(device)
deep_net = SpaceNet(dataclasses.replace(spec.spacenet_spec(bkgd=False), deep_rgb=True),
                    gen).to(device)
m = 4096 * 120
rng, xyz, ids, dir_enc = inputs(m, cs.SEED, False)
flags = torch.tensor((rng.random(-(-m // 64)) > 0.25).astype(np.int32), device=device)
main_in = (xyz, ids, dir_enc, flags)
cases = [("performer_lerp", model.layers_coarse[0], model.motion[0], "lerp", main_in),
         ("background", model.bkgd_coarse, None, None, main_in),
         ("background_direct", model.bkgd_coarse, direct_net, "direct", main_in),
         ("performer_deep_rgb", deep_net, model.motion[0], "lerp", main_in)]
m_e = 2000 * 61 + 45
rng, xyz_e, ids_e, dir_e = inputs(m_e, cs.SEED + 5, True)
n_tiles = -(-m_e // 64)
narrow, f8, wide = widths(64, 32, 32), widths(96, 48, 48), cs.make_model(spec, device)
seeded = torch.tensor((rng.random(n_tiles) > 0.25).astype(np.int32), device=device)
edge = lambda fl: (xyz_e, ids_e, dir_e, fl)
cases += [("narrow_performer", narrow.layers_fine[0], narrow.motion[0], "lerp", edge(seeded)),
          ("narrow_background", narrow.bkgd_fine, None, None, edge(seeded)),
          ("ragged_all_on", wide.layers_fine[0], wide.motion[0], "lerp",
           edge(torch.ones(n_tiles, dtype=torch.int32, device=device))),
          ("ragged_quarter_off", wide.layers_fine[0], wide.motion[0], "lerp", edge(seeded)),
          ("ragged_all_off", wide.layers_fine[0], wide.motion[0], "lerp",
           edge(torch.zeros(n_tiles, dtype=torch.int32, device=device))),
          ("ragged_no_flags", wide.layers_fine[0], wide.motion[0], "lerp", edge(None)),
          ("f8_performer", f8.layers_fine[0], f8.motion[0], "lerp", edge(seeded))]
"""
# K1's float32 route on every case: digests, and ms on the main two; the
# bf16 route's digests (render and checked) on every case
K1_F32 = """
k1_digests, k1_bf16_digests, k1_ms = {}, {}, {}
for name, net, mnet, mode, args in cases:
    f = cs.pack_dtype(net, mnet, mode, "float32")
    fb16 = cs.pack_dtype(net, mnet, mode, "bfloat16")
    try:
        first, again = fused_field(f, *args), fused_field(f, *args)
    except ValueError as e:  # a checkout that refuses the widths
        k1_digests[name] = k1_bf16_digests[name] = "refused"
        continue
    k1_digests[name] = digest(first) if digest(again) == digest(first) else "differs run to run"
    k1_bf16_digests[name] = [
        digest(fused_field(fb16, *args)) if digest(fused_field(fb16, *args))
        == digest(fused_field(fb16, *args)) else "differs run to run",
        digest(fused_field(fb16, *args, checked=True))]
    if name in ("performer_lerp", "background"):
        k1_ms[name] = cs.cuda_ms(lambda: fused_field(f, *args), 10)
"""
CHILD["k1_f32"] = PRELUDE + K1_CASES + K1_F32 + """
perf = (model.layers_coarse[0], model.motion[0], "lerp")
fb = cs.pack_dtype(*perf, "bfloat16")
bf16 = {"k1_ms": cs.cuda_ms(lambda: fused_field(fb, *main_in), 10),
        "k1_digest": digest(fused_field(fb, *main_in))}
# K2's bf16 route again, after K1's float32 runs
bf16["k2_ms"] = cs.cuda_ms(lambda: field_bwd(f2, *seeded4), 5)
bf16["k2_digest"] = digest(field_bwd(f2, *seeded4))
# phase 5's float32 step through the kernels: gradient digests of two fresh
# runs, and the seconds of a second step
scene, _ = cs.scene_and_requests(device)
cfg32 = cs.taekwondo_cfg()
cfg32.TPU.COMPUTE_DTYPE = "float32"
cfg32.SOLVER.WARMUP_ITERS = 1
spec32, batch = cs.train_batch(device, cs.ring_bundle(scene), scene, cfg32)
step_digests = []
for _ in range(2):
    net = cs.make_model(spec32, device)
    opt, sched = make_optimizer(cfg32, net)
    step = make_train_step(net, opt, sched, remove_outliers=True, plain=False, device=device)
    step(scene, batch, torch.Generator(device=device).manual_seed(cs.SEED), 1.0)
    leaves = [torch.as_tensor(v) for _, v in cs._flat_leaves(export_jax_params(net, grad=True))]
    step_digests.append(digest(leaves))
torch.cuda.synchronize()
t0 = time.perf_counter()
step(scene, batch, torch.Generator(device=device).manual_seed(cs.SEED + 1), 1.0)
torch.cuda.synchronize()
bf16["k2_first_ms"] = k2_first_ms
print("AB " + json.dumps({"k1_f32_ms": k1_ms, "k1_f32_digests": k1_digests,
                          "k1_bf16_digests": k1_bf16_digests, "bf16": bf16,
                          "f32_step_grad_digests": step_digests,
                          "f32_step_s": time.perf_counter() - t0}))
"""
CHILD["k3_f32"] = PRELUDE + K1_CASES + K1_F32 + """
from stnerf_tpu_torch.kernels.fused_field import pack_field, prepare_kernel_params_planar
from stnerf_tpu_torch.kernels.fused_spacenet import (fused_spacenet, fused_spacenet_planar,
                                                     fused_spacenet_stacked)
from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_bwd, spacenet_fwd
def pack32(net):
    return pack_field(prepare_kernel_params_planar(net, torch.float32), (), net.spec, None,
                      "float32")
def twice(fn):
    first, again = digest(fn()), digest(fn())
    return first if again == first else "differs run to run"
# phase 6's fields and encodings: its four cases, then its edges
vp_spec = LayeredSpec.from_cfg(cs.view_pose_cfg(), camera_num=8)
vp = cs.make_model(vp_spec, device)
gen = torch.Generator().manual_seed(cs.SEED + 4)
sspec = vp_spec.spacenet_spec(bkgd=False)
k3_deep = SpaceNet(dataclasses.replace(sspec, deep_rgb=True), gen).to(device)
k3_no_dir = SpaceNet(dataclasses.replace(sspec, use_dir=False), gen).to(device)
def vp_widths(w, h):
    c = cs.view_pose_cfg()
    c.merge_from_list(["MODEL.BACKBONE_DIM", w, "MODEL.HEAD_DIM", h, "MODEL.MOTION_DIM", h])
    return cs.make_model(LayeredSpec.from_cfg(c, camera_num=8), device)
k3_narrow, k3_f8 = vp_widths(64, 32), vp_widths(96, 48)
x = cs._encoded_inputs(device, 2000 * 120, cs.SEED + 5)
xe = cs._encoded_inputs(device, 2000 * 61 + 45, cs.SEED + 7)
k3_cases = [("performer_time", vp.layers_fine[0], x), ("background", vp.bkgd_fine, x),
            ("performer_deep_rgb", k3_deep, x), ("performer_no_dir", k3_no_dir, x),
            ("narrow_performer", k3_narrow.layers_fine[0], xe),
            ("narrow_background", k3_narrow.bkgd_fine, xe),
            ("f8_performer", k3_f8.layers_fine[0], xe),
            ("ragged_performer", vp.layers_fine[0], xe)]
k3_digests, k6_digests, k3_bf16_digests, k3_ms = {}, {}, {}, {}
on, off = (torch.full((1,), v, dtype=torch.int32, device=device) for v in (1, 0))
for name, net, enc in k3_cases:
    f = pack32(net)
    m = enc["pos"].shape[1]
    pos = enc["pos"]
    dir_enc = enc["dir"] if net.spec.use_dir else torch.zeros((1, m), device=device)
    time_enc = enc["time"] if net.spec.use_time else None
    a = (f, pos, dir_enc, time_enc)
    k3_digests[name] = twice(lambda: spacenet_fwd(*a))
    if name == "ragged_performer":  # the device-side flag, 1 and 0
        k3_digests[name + "_active_1"] = twice(lambda: spacenet_fwd(*a, on))
        zeros = spacenet_fwd(*a, off)
        k3_digests[name + "_active_0"] = ("zeros" if not any(bool(z.any()) for z in zeros)
                                          else digest(zeros))
    rows = tuple(None if e is None else e.t().contiguous() for e in (pos, dir_enc, time_enc))
    stack = tuple(None if e is None else e[None] for e in rows)
    k6_digests[name] = [twice(lambda: fused_spacenet_planar(*a)),
                        twice(lambda: fused_spacenet(f, *rows)),
                        twice(lambda: fused_spacenet_stacked([f], *stack))]
    fb16 = pack_field(prepare_kernel_params_planar(net, torch.bfloat16), (), net.spec, None,
                      "bfloat16")
    b = (fb16, pos, dir_enc, time_enc)
    k3_bf16_digests[name] = [twice(lambda: spacenet_fwd(*b)),
                             twice(lambda: fused_spacenet_planar(*b)),
                             twice(lambda: fused_spacenet(fb16, *rows)),
                             twice(lambda: fused_spacenet_stacked([fb16], *stack))]
    if name in ("performer_time", "background", "performer_deep_rgb", "narrow_performer"):
        k3_ms[name] = cs.cuda_ms(lambda: spacenet_fwd(*a), 10)
# K6's float32 entries at phase 6's K6 shape (M = 65,536; two weight sets)
m6 = 65536
x6 = cs._encoded_inputs(device, 2 * m6, cs.SEED + 6)
f6 = [pack32(vp.layers_coarse[0]), pack32(vp.layers_fine[1])]
planar = tuple(x6[k][:, :m6].contiguous() for k in ("pos", "dir", "time"))
rows6 = tuple(a.t().contiguous() for a in planar)
stacked = tuple(torch.stack([x6[k][:, :m6].t(), x6[k][:, m6:].t()]).contiguous()
                for k in ("pos", "dir", "time"))
k6_calls = {"fused_spacenet_planar": lambda: fused_spacenet_planar(f6[0], *planar),
            "fused_spacenet": lambda: fused_spacenet(f6[0], *rows6),
            "fused_spacenet_stacked": lambda: fused_spacenet_stacked(f6, *stacked)}
k6_ms = {k: cs.cuda_ms(fn, 10) for k, fn in k6_calls.items()}
k6_digests["phase6_shape"] = [twice(fn) for fn in k6_calls.values()]
# the bf16 routes: K1, K2 and K3's forward and backward
perf = (model.layers_coarse[0], model.motion[0], "lerp")
fb = cs.pack_dtype(*perf, "bfloat16")
g = pack_field(prepare_kernel_params_planar(vp.layers_fine[0], torch.bfloat16), (),
               vp.layers_fine[0].spec, None, "bfloat16")
k3_args = (x["pos"], x["dir"], x["time"])
bf16 = {"k1_digest": twice(lambda: fused_field(fb, *main_in)),
        "k2_digest": twice(lambda: field_bwd(f2, *seeded4)),
        "k3_fwd_digest": twice(lambda: spacenet_fwd(g, *k3_args)),
        "k3_bwd_digest": twice(lambda: spacenet_bwd(g, *k3_args, x["d_rgb"], x["d_sigma"])),
        "k2_first_ms": k2_first_ms}
# phase 8's float32 staged step through the kernels: gradient digests of
# two fresh runs, and the seconds of a second step
scene, _ = cs.scene_and_requests(device)
cfg32 = cs.view_pose_cfg()
cfg32.TPU.COMPUTE_DTYPE = "float32"
cfg32.SOLVER.WARMUP_ITERS = 1
spec32, batch = cs.train_batch(device, cs.ring_bundle(scene), scene, cfg32)
step_digests = []
for _ in range(2):
    net = cs.make_model(spec32, device)
    opt, sched = make_optimizer(cfg32, net)
    step = make_train_step(net, opt, sched, remove_outliers=True, plain=False, device=device)
    step(scene, batch, torch.Generator(device=device).manual_seed(cs.SEED), 1.0)
    leaves = [torch.as_tensor(v) for _, v in cs._flat_leaves(export_jax_params(net, grad=True))]
    step_digests.append(digest(leaves))
torch.cuda.synchronize()
t0 = time.perf_counter()
step(scene, batch, torch.Generator(device=device).manual_seed(cs.SEED + 1), 1.0)
torch.cuda.synchronize()
print("AB " + json.dumps({"k3_f32_fwd_ms": k3_ms, "k6_f32_ms": k6_ms,
                          "k3_f32_digests": k3_digests, "k6_f32_digests": k6_digests,
                          "k3_k6_bf16_digests": k3_bf16_digests,
                          "k1_f32_ms": k1_ms, "k1_f32_digests": k1_digests,
                          "k1_bf16_digests": k1_bf16_digests, "bf16": bf16,
                          "staged_f32_step_grad_digests": step_digests,
                          "staged_f32_step_s": time.perf_counter() - t0}))
"""
CHILD["cross"] = PRELUDE + """
import importlib.util, logging, os, shutil
from stnerf_tpu_torch.data import make_synthetic_scene
from stnerf_tpu_torch.kernels import cross_trans as ct
from stnerf_tpu_torch.tools import train
spec = importlib.util.spec_from_file_location("timing", sys.argv[1])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
kernels = {}
for L, N, S in ((3, 2000, 120), (3, 2000, 90)):
    x = cs.cross_inputs(device, L, N, S, cs.SEED + 7 + S)
    t, logf, g = x["t"], x["logf"], x["g"]
    for key, fn in (("succ", lambda: ct.cross_successor(t)),
                    ("fwd", lambda: ct.cross_log_transmittance_fwd(t, logf)),
                    ("bwd", lambda: ct.cross_log_transmittance_bwd(t, g))):
        kernels[f"{key}_{S}"] = {"ms": timing.graph_ms(fn, 50),
                                 "call_ms": timing.cuda_ms(fn, 20)}
cs.phase_cross_vs_plain(device, reps=20)
comp = cs.phase_compositor(device, reps=20)
root = os.path.join(cs.REPO, "build", "ab_synthetic")
out_dir = os.path.join(cs.REPO, "build", "ab_entry")
for d in (root, out_dir):
    shutil.rmtree(d, ignore_errors=True)
make_synthetic_scene(root, width=200, height=150, num_cams=12, num_frames=5, layer_num=2,
                     seed=cs.SEED)
cfg_file = cs.entry_point_cfg_file(root, out_dir)
seconds, steps = {}, []
class Epochs(logging.Handler):
    def emit(self, r):
        if r.msg.startswith("Epoch %d done"):
            seconds[r.args[0]] = r.args[1]
        elif r.msg.startswith("pool resident on"):
            steps.append(r.args[2])
logger = logging.getLogger("stnerf_tpu_torch.train")
logger.setLevel(logging.INFO)
logger.addHandler(Epochs())
wrappers = (ct.cross_successor, ct.cross_log_transmittance_fwd, ct.cross_log_transmittance_bwd)
for w in wrappers:
    w.launches = 0
train.main(["-c", cfg_file, "--seed", str(cs.SEED), "--workers", "2", "--device", "cuda:0"])
print("AB " + json.dumps({"kernels": kernels,
                          "compositor_fwd_bwd_ms": {k: v for k, v in comp.items()
                                                    if k.endswith("_ms")},
                          "entry_s_per_step": {e: s / steps[0] for e, s in seconds.items()},
                          "entry_launches": [w.launches for w in wrappers]}))
"""

CHILD["bwd"] = PRELUDE + """
import dataclasses, hashlib, os
import numpy as np
from stnerf_tpu_torch.kernels.field_vjp import field_bwd
from stnerf_tpu_torch.kernels.fused_field import pack_field, prepare_kernel_params_planar
from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_bwd
from stnerf_tpu_torch.models import LayeredSpec, MotionNet, SpaceNet
from stnerf_tpu_torch.ops.encoding import positional_encoding_planar
def digest(ts):
    h = hashlib.sha256()
    for x in ts:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]
def twice(fn):
    first, again = digest(fn()), digest(fn())
    return first if again == first else "differs run to run"
t = lambda a: torch.tensor(a, dtype=torch.float32, device=device).contiguous()
def inputs(m, seed):
    rng = np.random.default_rng(seed)
    xyz = t(rng.uniform(-3.0, 3.0, (3, m)))
    ids = t(rng.integers(1, 101, (1, m)) + rng.choice([0.0, 0.25, 0.5], (1, m)))
    d = rng.normal(size=(3, m))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dir_enc = positional_encoding_planar(t(d), 4, True, recursive=True).contiguous()
    cot = (t(rng.normal(size=(3, m))), t(rng.normal(size=m)))
    return rng, (xyz, ids, dir_enc, *cot)
def widths(c, w, h, mw, cams=None):
    c.merge_from_list(["MODEL.BACKBONE_DIM", w, "MODEL.HEAD_DIM", h, "MODEL.MOTION_DIM", mw])
    return cs.make_model(LayeredSpec.from_cfg(c, camera_num=cams), device)
digests, ms = {}, {}
# K2: phase 4's four fields at its seeded shape, then its edges
spec = LayeredSpec.from_cfg(cfg)
model = cs.make_model(spec, device)
gen = torch.Generator().manual_seed(cs.SEED + 1)
direct_net = MotionNet(spec.motion_spec(input_time=False), gen).to(device)
deep_net = SpaceNet(dataclasses.replace(spec.spacenet_spec(bkgd=False), deep_rgb=True),
                    gen).to(device)
m = cfg.SOLVER.IMS_PER_BATCH * 120
rng, main = inputs(m, cs.SEED + 2)
main = (*main, torch.tensor((rng.random(-(-m // 64)) > 0.25).astype(np.int32), device=device))
m_e = 2000 * 61 + 45
rng, edge = inputs(m_e, cs.SEED + 6)
n_tiles = -(-m_e // 64)
seeded = torch.tensor((rng.random(n_tiles) > 0.25).astype(np.int32), device=device)
narrow, f8 = widths(cs.taekwondo_cfg(), 64, 32, 32), widths(cs.taekwondo_cfg(), 96, 48, 48)
perf = (model.layers_fine[0], model.motion[0], "lerp")
k2_cases = [("performer_lerp", *perf, main), ("background", model.bkgd_fine, None, None, main),
            ("background_direct", model.bkgd_fine, direct_net, "direct", main),
            ("performer_deep_rgb", deep_net, model.motion[0], "lerp", main),
            ("narrow_performer", narrow.layers_fine[0], narrow.motion[0], "lerp",
             (*edge, seeded)),
            ("narrow_background", narrow.bkgd_fine, None, None, (*edge, seeded)),
            ("f8_performer", f8.layers_fine[0], f8.motion[0], "lerp", (*edge, seeded)),
            ("ragged_all_on", *perf, (*edge, torch.ones_like(seeded))),
            ("ragged_quarter_off", *perf, (*edge, seeded)),
            ("ragged_all_off", *perf, (*edge, torch.zeros_like(seeded))),
            ("ragged_no_flags", *perf, (*edge, None))]
for dt in ("bfloat16", "float32"):
    for name, net, mnet, mode, args in k2_cases:
        f = cs.pack_dtype(net, mnet, mode, dt)
        digests[f"field_bwd_{dt}_{name}"] = twice(lambda: field_bwd(f, *args))
        if name in ("performer_lerp", "background"):
            ms[f"field_bwd_{dt}_{name}"] = cs.cuda_ms(lambda: field_bwd(f, *args), 10)
# K3: phase 6's four fields at its shape, then its edges
vp_spec = LayeredSpec.from_cfg(cs.view_pose_cfg(), camera_num=8)
vp = cs.make_model(vp_spec, device)
gen = torch.Generator().manual_seed(cs.SEED + 4)
sspec = vp_spec.spacenet_spec(bkgd=False)
k3_deep = SpaceNet(dataclasses.replace(sspec, deep_rgb=True), gen).to(device)
k3_no_dir = SpaceNet(dataclasses.replace(sspec, use_dir=False), gen).to(device)
k3_narrow = widths(cs.view_pose_cfg(), 64, 32, 32, 8)
k3_f8 = widths(cs.view_pose_cfg(), 96, 48, 48, 8)
x = cs._encoded_inputs(device, 2000 * 120, cs.SEED + 5)
xe = cs._encoded_inputs(device, 2000 * 61 + 45, cs.SEED + 7)
on, off = (torch.full((1,), v, dtype=torch.int32, device=device) for v in (1, 0))
k3_cases = [("performer_time", vp.layers_fine[0], x, None),
            ("background", vp.bkgd_fine, x, None), ("performer_deep_rgb", k3_deep, x, None),
            ("performer_no_dir", k3_no_dir, x, None),
            ("narrow_performer", k3_narrow.layers_fine[0], xe, None),
            ("narrow_background", k3_narrow.bkgd_fine, xe, None),
            ("f8_performer", k3_f8.layers_fine[0], xe, None),
            ("ragged_performer", vp.layers_fine[0], xe, None),
            ("ragged_performer_active_1", vp.layers_fine[0], xe, on),
            ("ragged_performer_active_0", vp.layers_fine[0], xe, off)]
for dt in ("bfloat16", "float32"):
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    for name, net, enc, active in k3_cases:
        f = pack_field(prepare_kernel_params_planar(net, tdt), (), net.spec, None, dt)
        n = enc["pos"].shape[1]
        dir_enc = enc["dir"] if net.spec.use_dir else torch.zeros((1, n), device=device)
        a = (f, enc["pos"], dir_enc, enc["time"] if net.spec.use_time else None,
             enc["d_rgb"], enc["d_sigma"], active)
        digests[f"spacenet_bwd_{dt}_{name}"] = twice(lambda: spacenet_bwd(*a))
        if name in ("performer_time", "background"):
            ms[f"spacenet_bwd_{dt}_{name}"] = cs.cuda_ms(lambda: spacenet_bwd(*a), 10)
# the bf16 records and leaves, by this checkout's chip_smoke; a checkout
# whose wrappers take no workspace is launched through its C entry points
# (tools/torch_near_tie_variants.py's launchers)
import importlib.util, inspect
from stnerf_tpu_torch.kernels.field_vjp import field_bwd_reference
from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_bwd_reference
def load(name, path):
    spec_ = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module
ts = load("this_smoke", sys.argv[1])
tv = load("this_variants", os.path.join(os.path.dirname(sys.argv[1]), "tools",
                                         "torch_near_tie_variants.py"))
k2_launch, k3_launch = tv.launchers(load_library(), load_library())
own = "workspace" in inspect.signature(field_bwd).parameters
records, leaves = {}, {}
real = cs.real_bwd_inputs(device)
cut = tuple(a[..., :m_e].contiguous() for a in real["background"][:5])
for name, net, mnet, mode, args in k2_cases:
    f = cs.pack_dtype(net, mnet, mode, "bfloat16")
    if len(args) == 6 and args[0].shape[1] == m:  # phase 4's four fields: the real inputs
        args = real["performer" if name.startswith("performer") else "background"]
    else:  # its edges: the real background inputs cut to the edge's M, the edge's flags
        args = (*cut, args[5])
    stats = ts._leaf_stats(f, field_bwd(f, *args), field_bwd_reference(f, *args))
    leaves[f"field_bwd_{name}"] = {k: v["rel"] for k, v in stats.items()}
    records[f"field_bwd_{name}"] = ts.bwd_records_check("field_bwd", f, args,
                                                        None if own else k2_launch)
for name, net, enc, active in k3_cases:
    f = pack_field(prepare_kernel_params_planar(net, torch.bfloat16), (), net.spec, None,
                   "bfloat16")
    n = enc["pos"].shape[1]
    dir_enc = enc["dir"] if net.spec.use_dir else torch.zeros((1, n), device=device)
    a = (enc["pos"], dir_enc, enc["time"] if net.spec.use_time else None,
         enc["d_rgb"], enc["d_sigma"], active)
    stats = ts._leaf_stats(f, spacenet_bwd(f, *a), spacenet_bwd_reference(f, *a), "d_pos")
    leaves[f"spacenet_bwd_{name}"] = {k: v["rel"] for k, v in stats.items()}
    records[f"spacenet_bwd_{name}"] = ts.bwd_records_check("spacenet_bwd", f, a,
                                                           None if own else k3_launch)
# a bf16 full training step of the taekwondo model at batch 2000 (phase 5's):
# the seconds of steps 2-6 from the host, each after a sync
import time
from stnerf_tpu_torch.engine import make_optimizer, make_train_step
scene, _ = cs.scene_and_requests(device)
bundle = cs.ring_bundle(scene)
cfg16 = cs.taekwondo_cfg()
cfg16.SOLVER.WARMUP_ITERS = 1
spec16, batch = cs.train_batch(device, bundle, scene, cfg16)
net = cs.make_model(spec16, device)
opt, sched = make_optimizer(cfg16, net)
step = make_train_step(net, opt, sched, remove_outliers=True, plain=False, device=device)
bf16_step_s = []
for i in range(6):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(scene, batch, torch.Generator(device=device).manual_seed(cs.SEED + i), 1.0)
    torch.cuda.synchronize()
    bf16_step_s.append(time.perf_counter() - t0)
print("AB " + json.dumps({"ms": ms, "digests": digests, "bf16_leaf_rel_l2": leaves,
                          "bf16_records_not_k_order": records,
                          "bf16_step_s": bf16_step_s[1:]}))
"""


def run(root: str, phases: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD[phases],
                          os.path.join(REPO, "chip_smoke.py")], cwd=root, check=True,
                         stdout=subprocess.PIPE, text=True).stdout
    return json.loads(next(l for l in out.splitlines() if l.startswith("AB "))[3:])


def flat_digests(out: dict, key: str = "") -> dict:
    """Every digest of a run's line by a flat key ("a/b/0"): the values
    under the keys that end in "digest" or "digests" (a digest, a list of
    them, or a dict of either)."""
    found = {}
    for k, v in out.items():
        path = f"{key}/{k}" if key else k
        if k.endswith(("digest", "digests")):
            found.update(flat_values(v, path))
        elif isinstance(v, dict):
            found.update(flat_digests(v, path))
    return found


def flat_values(v, key: str) -> dict:
    """A digest, or a list or dict of them -> {flat key: digest}."""
    items = (v.items() if isinstance(v, dict) else enumerate(v) if isinstance(v, list)
             else None)
    if items is None:
        return {key: v}
    return {k2: d for k, x in items for k2, d in flat_values(x, f"{key}/{k}").items()}


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
    digests = {}
    for _ in range(args.rounds):
        for root in order:
            name = "this" if root == REPO else os.path.relpath(root, REPO)
            out = run(root, args.phases)
            print(json.dumps({"checkout": name, **out}), flush=True)
            for key, d in flat_digests(out).items():
                digests.setdefault(key, {}).setdefault(name, set()).add(d)
    if digests:  # which digests match the first other checkout's (no check fails)
        first = os.path.relpath(others[0], REPO)
        same = {k: v.get("this") == v.get(first) and len(v["this"]) == 1
                for k, v in digests.items()}
        print(json.dumps({"summary": {
            "equal_to": first, "equal": sorted(k for k, e in same.items() if e),
            "differ": sorted(k for k, e in same.items() if not e)}}), flush=True)


if __name__ == "__main__":
    main()
