#!/usr/bin/env python3
"""Where the cross-stream kernels K4 and K5 spend their time on the card.

    python3 tools/torch_cross_timeline.py

Builds with ``nvcc`` into ``build/cross_timeline/`` one probe library per
variant of ``stnerf_tpu_torch/kernels/csrc/cross_trans.cu``, with the
source's ``CROSS_STAMP`` hook recording, for every warp (its lane 0), the
SM clock at the phase boundaries (start, copies landed, sortedness voted,
scans done, outputs written), the global timer at its start and end, and
its SM. The variants: the source as it is (``base``); the same with one
constant changed (``kGroup``, the searches a lane runs side by side, 1 or
8; ``kMaxRays``, the rays a block, 1 or 8); and without the search
(``no_search``: each output is the depth as loaded, the floor of the
copies, the vote and the stores). For each variant, kernel and shape
(L = 3 sorted streams, ``chip_smoke.cross_inputs``, N = 500, 2000 and 8000
rays at S = 120, 2000 at S = 90): the device time of 50 calls replayed
from a CUDA graph (the probe's entry points called directly), the
makespan (the last warp's end minus the first warp's start, global
timer), the spread of the warps' starts, each phase's mean and largest
cycles per warp, and the most warps an SM ran. The library's own kernels
(the wrappers of ``kernels/cross_trans.py``) are timed alike beside them.
Prints the card's ``name, power.limit`` and its SM clocks first, then
one JSON line per variant, kernel and shape.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "stnerf_tpu_torch", "kernels", "csrc")
OUT = os.path.join(REPO, "build", "cross_timeline")

PROBE = r'''
#include <cstdint>
#include <cstddef>

__device__ unsigned long long* g_stamps;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

// per warp: clock64 at phases 0-4, global timer at start and end, SM
#define CROSS_STAMP(phase, n, lane)                                        \
  do {                                                                     \
    if ((lane) == 0 && g_stamps != nullptr) {                              \
      unsigned long long* s_ = g_stamps + static_cast<size_t>(n) * 8;      \
      if ((phase) == 0) {                                                  \
        s_[5] = global_ns();                                               \
        s_[7] = sm_id();                                                   \
      }                                                                    \
      s_[phase] = clock64();                                               \
      if ((phase) == 4) s_[6] = global_ns();                               \
    }                                                                      \
  } while (0)

#include "variant.cu"

extern "C" int set_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
'''

SEARCH_CALL = "      searched<kMode>(st, sv, out + at(o, n, 0, N, S), L, S, o, s0);\n"
NO_SEARCH = ("      for (int g = 0; g < kGroup; ++g)\n"
             "        if (s0 + g * kWarp < S)\n"
             "          out[at(o, n, s0 + g * kWarp, N, S)] =\n"
             "              st[o * padded(S) + pad(s0 + g * kWarp)];\n")
VARIANTS = {
    "base": [],
    "group1": [("constexpr int kGroup = 4;", "constexpr int kGroup = 1;")],
    "group8": [("constexpr int kGroup = 4;", "constexpr int kGroup = 8;")],
    "rays1": [("constexpr int kMaxRays = 4;", "constexpr int kMaxRays = 1;")],
    "rays8": [("constexpr int kMaxRays = 4;", "constexpr int kMaxRays = 8;")],
    "no_search": [(SEARCH_CALL, NO_SEARCH)],
}
ENTRIES = {"succ": ("stnerf_cross_successor", 1), "fwd": ("stnerf_cross_logt_fwd", 2),
           "bwd": ("stnerf_cross_logt_bwd", 2)}
SHAPES = ((3, 500, 120), (3, 2000, 120), (3, 8000, 120), (3, 2000, 90))


def build() -> dict:
    """One probe library per variant, compiled in parallel -> {name: CDLL}."""
    sys.path.insert(0, REPO)
    from stnerf_tpu_torch.kernels._build import ARCH, find_nvcc

    with open(os.path.join(CSRC, "cross_trans.cu")) as f:
        source = f.read()
    nvcc, procs = find_nvcc(), {}
    for name, edits in VARIANTS.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in cross_trans.cu")
            text = text.replace(old, new)
        with open(os.path.join(d, "variant.cu"), "w") as f:
            f.write(text)
        with open(os.path.join(d, "probe.cu"), "w") as f:
            f.write(PROBE)
        procs[name] = subprocess.Popen(
            [nvcc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", d,
             "-o", os.path.join(d, "probe.so"), os.path.join(d, "probe.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, name, "probe.so"))
        for entry, n_in in ENTRIES.values():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * (n_in + 2) + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.set_stamps.argtypes, lib.set_stamps.restype = [ctypes.c_void_p], ctypes.c_int
        libs[name] = lib
    return libs


def stamp_stats(stamps: np.ndarray) -> dict:
    """Per-warp stamps (N, 8) -> the makespan, start spread, phase cycles."""
    clk = stamps[:, :5].astype(np.int64)
    phases = np.diff(clk, axis=1)
    start_ns = (stamps[:, 5] - stamps[:, 5].min()).astype(np.int64)
    sms = np.bincount(stamps[:, 7].astype(np.int64))
    return {"makespan_us": float(stamps[:, 6].max() - stamps[:, 5].min()) / 1e3,
            "warp_us_mean": float((stamps[:, 6] - stamps[:, 5]).mean()) / 1e3,
            "start_us_p50_p90_max": [float(np.percentile(start_ns, q)) / 1e3
                                     for q in (50, 90, 100)],
            "cycles_mean": dict(zip(("load", "vote", "scan", "search"),
                                    phases.mean(0).round(1).tolist())),
            "cycles_max": dict(zip(("load", "vote", "scan", "search"),
                                   phases.max(0).tolist())),
            "sms": int((sms > 0).sum()), "most_warps_an_sm": int(sms.max())}


def main():
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stnerf_tpu_torch.kernels import cross_trans as ct
    from stnerf_tpu_torch.kernels._build import load_library

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    load_library()
    libs = build()
    device = torch.device("cuda", 0)
    ptr = ctypes.c_void_p
    for L, N, S in SHAPES:
        x = cs.cross_inputs(device, L, N, S, cs.SEED + 7 + S)
        inputs = {"succ": (x["t"],), "fwd": (x["t"], x["logf"]), "bwd": (x["t"], x["g"])}
        library = {"succ": lambda: ct.cross_successor(x["t"]),
                   "fwd": lambda: ct.cross_log_transmittance_fwd(x["t"], x["logf"]),
                   "bwd": lambda: ct.cross_log_transmittance_bwd(x["t"], x["g"])}
        for key, fn in library.items():
            print(json.dumps({"variant": "library", "kernel": key, "shape": [L, N, S],
                              "ms": cs.graph_ms(fn, 50)}), flush=True)
        for name, lib in libs.items():
            for key, (entry, _) in ENTRIES.items():
                out = torch.empty_like(x["t"])
                counter = torch.zeros(1, dtype=torch.int32, device=device)
                args = [ptr(a.data_ptr()) for a in (*inputs[key], out, counter)]

                def call(entry=entry, args=args):
                    err = getattr(lib, entry)(*args, L, N, S,
                                              ptr(torch.cuda.current_stream().cuda_stream))
                    if err:
                        raise RuntimeError(f"{name} {entry}: CUDA error {err}")

                ms = cs.graph_ms(call, 50)
                stamps = torch.zeros(N * 8, dtype=torch.int64, device=device)
                lib.set_stamps(ptr(stamps.data_ptr()))
                call()
                torch.cuda.synchronize()
                lib.set_stamps(None)
                row = {"variant": name, "kernel": key, "shape": [L, N, S], "ms": ms,
                       **stamp_stats(stamps.view(N, 8).cpu().numpy())}
                if name != "no_search":
                    ref = {"succ": library["succ"], "fwd": library["fwd"],
                           "bwd": library["bwd"]}[key]()
                    row["equal_to_library"] = bool(torch.equal(out, ref))
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
