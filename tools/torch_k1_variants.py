#!/usr/bin/env python3
"""Where K1's float32 time goes (``csrc/fused_field.cu`` on one CUDA card).

    python3 tools/torch_k1_variants.py [VARIANT ...]

Copies the kernel sources once per variant under
``build/k1_variants/<variant>/``, edits the copy as the variant says
(``VARIANTS``: each a list of (file under ``csrc/``, text, replacement)),
builds each copy's ``fused_field.cu`` alone into a shared library, all in
parallel, and calls its ``stnerf_fused_field`` through ctypes on phase 2's
inputs (M = 4096 x 120 seeded samples, 25% of the tiles flagged off) for
the taekwondo performer ("lerp" motion, time input) and background fields
and the narrow (64/32/32) performer, float32. Prints the card's
``name, power.limit``, each variant's ptxas registers, stack and spills,
then one JSON line per field: each variant's ms per call (CUDA events, 10
calls after a warm-up) and whether its outputs are bitwise the base's. A
variant that drops a barrier gives wrong outputs: it measures what the
barrier costs, nothing else. Compare variants only within one invocation.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "k1_variants")
STAGE = "constexpr int STAGE_FLOATS = 8192;"
LOOP = "#pragma unroll 4\n  for (int k = 0; k < rows; ++k) {"
VARIANTS = {
    "base": [],
    # smaller ring stages: more slabs, each a wait and a release
    "stages_16k": [("w_ring.cuh", STAGE, "constexpr int STAGE_FLOATS = 4096;")],
    "stages_22k": [("w_ring.cuh", STAGE, "constexpr int STAGE_FLOATS = 5632;")],
    "stages_8k": [("w_ring.cuh", STAGE, "constexpr int STAGE_FLOATS = 2048;")],
    # k steps of the FMA loop unrolled (their loads in flight together)
    "unroll2": [("ring_dense.cuh", LOOP, LOOP.replace("unroll 4", "unroll 2"))],
    "unroll8": [("ring_dense.cuh", LOOP, LOOP.replace("unroll 4", "unroll 8"))],
    # the weights' bulk copies with an L2 evict-last hint
    "evict_last": [("w_ring.cuh",
                    '"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "\n'
                    '          "[%0], [%1], %2, [%3];\\n" ::',
                    '"{\\n.reg .b64 pol;\\ncreatepolicy.fractional.L2::evict_last.b64 pol, 1.0;\\n"'
                    '"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes'
                    '.L2::cache_hint "\n          "[%0], [%1], %2, [%3], pol;\\n}\\n" ::')],
    # the dense layers inlined at each call site (ring_dense.cuh's
    # dense_call keeps one copy in K1)
    "dense_inline": [("ring_dense.cuh", "__device__ __noinline__ void dense_call(",
                      "__device__ __forceinline__ void dense_call(")],
    # no barrier between layers (wrong outputs): what the barriers cost
    "no_layer_sync": [("ring_dense.cuh",
                       'asm volatile("bar.sync 1, %0;\\n" ::"n"(CONSUMERS) : "memory");', "")],
}


def build(names: list) -> dict:
    """Edited copies of csrc/, each fused_field.cu built alone -> {name: .so}."""
    sys.path.insert(0, REPO)
    from stnerf_tpu_torch.kernels._build import CSRC, NVCC_FLAGS, find_nvcc

    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        shutil.copytree(CSRC, d)
        for f, text, repl in VARIANTS[name]:
            path = os.path.join(d, f)
            src = open(path).read()
            if text not in src:
                raise SystemExit(f"variant {name}: {f} has no {text!r}")
            open(path, "w").write(src.replace(text, repl))
        procs[name] = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-shared", "-o", os.path.join(d, "k1.so"),
             os.path.join(d, "fused_field.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log[-4000:]}")
        lines = [line.strip() for line in log.splitlines()
                 if "fused_field_kernel" in line or "registers" in line or "stack frame" in line]
        print(name, "ptxas", json.dumps(lines[:4]), flush=True)
        libs[name] = os.path.join(OUT, name, "k1.so")
    return libs


def main():
    names = sys.argv[1:] or list(VARIANTS)
    if "base" not in names:
        names = ["base", *names]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    paths = build(names)

    import numpy as np
    import torch

    import chip_smoke as cs
    from stnerf_tpu_torch.kernels.fused_field import kernel_ints
    from stnerf_tpu_torch.models import LayeredSpec
    from stnerf_tpu_torch.ops.encoding import positional_encoding_planar

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    dev = torch.device("cuda", 0)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        lib.stnerf_fused_field.argtypes = [ptr] * 8 + [i32] * 10 + [ptr]
        lib.stnerf_fused_field.restype = i32
        libs[name] = lib

    m = 4096 * 120
    rng = np.random.default_rng(cs.SEED)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev).contiguous()

    xyz = t(rng.uniform(-3.0, 3.0, (3, m)))
    ids = t(rng.integers(1, 101, (1, m)) + rng.choice([0.0, 0.25, 0.5], (1, m)))
    d = rng.normal(size=(3, m))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dir_enc = positional_encoding_planar(t(d), 4, True).contiguous()
    flags = torch.tensor((rng.random(-(-m // 64)) > 0.25).astype(np.int32), device=dev)
    wide = cs.make_model(LayeredSpec.from_cfg(cs.taekwondo_cfg()), dev)
    narrow_cfg = cs.taekwondo_cfg()
    narrow_cfg.merge_from_list(["MODEL.BACKBONE_DIM", 64, "MODEL.HEAD_DIM", 32,
                                "MODEL.MOTION_DIM", 32])
    narrow = cs.make_model(LayeredSpec.from_cfg(narrow_cfg), dev)
    fields = {"performer": cs.pack_dtype(wide.layers_coarse[0], wide.motion[0], "lerp",
                                         "float32"),
              "background": cs.pack_dtype(wide.bkgd_coarse, None, None, "float32"),
              "narrow_performer": cs.pack_dtype(narrow.layers_fine[0], narrow.motion[0],
                                                "lerp", "float32")}

    def call(lib, f):
        out = torch.empty((4, m), dtype=torch.float32, device=dev)
        err = lib.stnerf_fused_field(
            ptr(xyz.data_ptr()), ptr(ids.data_ptr()), ptr(dir_enc.data_ptr()),
            ptr(flags.data_ptr()), ptr(f.weights.data_ptr()), ptr(f.biases.data_ptr()),
            f.offsets.ctypes.data_as(ptr), ptr(out.data_ptr()),
            *kernel_ints(f, m, dir_enc.shape[0]), ptr(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    for case, f in fields.items():
        base = call(libs["base"], f)
        row = {"case": case, "m": m}
        for name, lib in libs.items():
            row[name] = {"ms": cs.cuda_ms(lambda: call(lib, f), 10),
                         "bitwise_base": bool(torch.equal(call(lib, f), base))}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
