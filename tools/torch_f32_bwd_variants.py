#!/usr/bin/env python3
"""Where the float32 backward kernels' time goes (K2 and K3, on one CUDA card).

    python3 tools/torch_f32_bwd_variants.py [VARIANT ...]

Copies the port's package once per variant under
``build/f32_bwd_variants/<variant>/``, edits the copy's kernel sources as
the variant says (``VARIANTS``: each a list of (file under ``csrc/``, text,
replacement)), builds the copies in parallel (only ``field_bwd.cu`` and
``spacenet.cu``: the float32 backward's entry points), then in a fresh
process per variant times K2 (``field_bwd``, phase 4's performer field and
seeded inputs, M = 2000 x 120, 25% of the tiles off) and K3's backward
(``spacenet_bwd``, phase 6's performer encodings, M = 2000 x 120) in
float32: each kernel's device ms per call from ``torch.profiler`` (pass 1,
pass 2, pass 3) and a call's ms from CUDA events. Prints the card's
``name, power.limit``, then per variant ptxas's registers and spills for
the float32 backward's kernels and one JSON line. A variant that removes
work gives wrong gradients: it measures what that work costs, nothing
else. Compare variants only within one invocation.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "f32_bwd_variants")
F = "f32_bwd.cuh"
FWD8 = ("  fwd_seg<float, float, RBM, TO, 8>(acc, w0, O, k0, in0, to, tm);\n"
        "  if (k1) fwd_seg<float, float, RBM, TO, 8>(acc, w1, O, k1, in1, to, tm);\n"
        "  if (k2) fwd_seg<float, float, RBM, TO, 8>(acc, w2, O, k2, in2, to, tm);")
VARIANTS = {
    "base": [],
    # pass 1 ends after the forward (K2: and skips the motion net's backward)
    "fwd_only": [(F, "  // ---- rgb head backward: x holds the last head activation, y is free ----",
                  "  if (p.M > 0) return;\n"),
                 ("field_bwd.cu", "  if (p.motion_mode) {\n    if (t < 3 * RBM) s.G3[t] = dx_out;",
                  "  if (p.motion_mode && p.M < 0) {\n    if (t < 3 * RBM) s.G3[t] = dx_out;")],
    # pass 1's tensor-core dx without its products (their loads die with them)
    "no_dx_mma": [(F, "      for (int i = 0; i < MT; ++i) mma3(acc[i][j], ah[i], al[i], bh, bl);", "")],
    # no record copied
    "no_copy": [(F, "  __device__ void save(int r, const float* tile, int rows) const {",
                 "  __device__ void save(int r, const float* tile, int rows) const {\n"
                 "    if (rows > 0) return;")],
    # pass 2 without its products
    "dw_no_mma": [(F, "          for (int i = 0; i < 4; ++i) mma3(acc[i][j], ah[i], al[i], bh, bl);",
                   "")],
    # the forward's weights from 8 rows a layer (L1-resident): their L2 traffic
    "l1_weights": [("mlp_blocks.cuh", "load_w<WS, TO>(wp + static_cast<size_t>(k) * O, wv);",
                    "load_w<WS, TO>(wp + static_cast<size_t>(k & 7) * O, wv);")],
    # the dx fragments of 2 steps a layer (L1-resident): their L2 traffic
    "l1_frags": [(F, "f[i] = frag[static_cast<size_t>((mt0 + i) * steps + kt) * 32 + l];",
                  "f[i] = frag[static_cast<size_t>((mt0 + i) * steps + (kt & 1)) * 32 + l];")],
    # the products inlined into the pass-1 kernels
    "inline": [(F, "__device__ __noinline__ void dx_tc_t(", "__device__ __forceinline__ void dx_tc_t("),
               (F, "__device__ __noinline__ void dense_t(", "__device__ __forceinline__ void dense_t(")],
    # four k steps of the forward in flight, as the forward kernels have it
    "unroll4": [(F, FWD8, FWD8.replace(", 8>", ", 4>"))],
    # the TF32 split by two cvt.rna
    "cvt": [(F, "  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
                "  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));",
             "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(hi) : \"f\"(v));\n"
             "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(lo) : \"f\"(__fsub_rn(v, __uint_as_float(hi))));")],
}

CHILD = r'''
import json, sys
root = sys.argv[1]
sys.path.insert(0, sys.argv[2])
sys.path.insert(0, root)
import numpy as np, torch
import stnerf_tpu_torch
assert stnerf_tpu_torch.__file__.startswith(root), stnerf_tpu_torch.__file__
torch.backends.cuda.matmul.allow_tf32 = False
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from stnerf_tpu_torch.kernels._build import BUILD_DIR, load_library
from stnerf_tpu_torch.kernels.field_vjp import field_bwd
from stnerf_tpu_torch.kernels.fused_field import TILE
from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_bwd
from stnerf_tpu_torch.models import LayeredSpec
from stnerf_tpu_torch.ops.encoding import positional_encoding_planar
load_library()
keep, ptxas = False, []
for line in "".join(p.read_text() for p in BUILD_DIR.glob("*.log")).splitlines():
    if "Compiling entry function" in line:
        keep = "bwd_kernel" in line or "f32_dw_kernel" in line
    if keep and ("spill" in line or "registers" in line):
        ptxas.append(line.strip())
device = torch.device("cuda", 0)
cfg = cs.taekwondo_cfg()
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
          torch.tensor((rng.random(-(-m // TILE)) > 0.25).astype(np.int32), device=device))
f2 = cs.pack_dtype(model.layers_fine[0], model.motion[0], "lerp", "float32")
vp = cs.make_model(LayeredSpec.from_cfg(cs.view_pose_cfg(), camera_num=8), device)
x = cs._encoded_inputs(device, m, cs.SEED + 5)
f3 = cs.pack_dtype(vp.layers_fine[0], None, None, "float32")
out = {"ptxas": ptxas}
for name, fn in (("k2", lambda: field_bwd(f2, *seeded)),
                 ("k3", lambda: spacenet_bwd(f3, x["pos"], x["dir"], x["time"], x["d_rgb"],
                                             x["d_sigma"]))):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    passes = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0 and "namespace" in e.key:
            passes[e.key.split("::")[1].split("(")[0]] = us / 3 / 1000
    out[name] = {"passes_ms": passes, "call_ms": cs.cuda_ms(fn, 3)}
print("VARIANT " + json.dumps(out), flush=True)
'''


def make(name: str) -> str:
    """The variant's copy of the package, edited; -> its root."""
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "stnerf_tpu_torch"), os.path.join(root, "stnerf_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    kernels = os.path.join(root, "stnerf_tpu_torch", "kernels")
    for fn, text, new in VARIANTS[name]:
        path = os.path.join(kernels, "csrc", fn)
        src = open(path).read()
        if src.count(text) != 1:
            raise SystemExit(f"variant {name}: the text to edit is not once in {fn}: {text!r}")
        open(path, "w").write(src.replace(text, new))
    # build and bind only the float32 backward's sources
    path = os.path.join(kernels, "_build.py")
    src = open(path).read()
    src = src.replace("SOURCES = (", "_ALL_SOURCES = (", 1).replace(
        "HEADERS = (", "SOURCES = (CSRC / 'field_bwd.cu', CSRC / 'spacenet.cu')\nHEADERS = (", 1)
    src = src.replace("    for name, argtypes in SIGNATURES.items():\n",
                      "    for name, argtypes in SIGNATURES.items():\n"
                      "        if name not in ('stnerf_field_bwd', 'stnerf_spacenet_bwd'):\n"
                      "            continue\n", 1)
    open(path, "w").write(src)
    return root


def main():
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    roots = {n: make(n) for n in names}
    builds = {n: subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                   "from stnerf_tpu_torch.kernels._build import build; build()", r])
              for n, r in roots.items()}
    failed = [n for n, p in builds.items() if p.wait() != 0]
    if failed:
        raise SystemExit(f"variants failed to build: {failed}")
    for n, r in roots.items():
        res = subprocess.run([sys.executable, "-c", CHILD, r, REPO], check=True,
                             stdout=subprocess.PIPE, text=True).stdout
        row = json.loads(next(l for l in res.splitlines() if l.startswith("VARIANT "))[8:])
        for line in row.pop("ptxas"):
            print(n, "ptxas", line, flush=True)
        print(json.dumps({"variant": n, **row}), flush=True)


if __name__ == "__main__":
    main()
