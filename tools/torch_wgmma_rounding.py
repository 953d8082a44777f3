#!/usr/bin/env python3
"""How a Hopper wgmma (bf16 operands, float32 accumulator) rounds its sums.

    python3 tools/torch_wgmma_rounding.py

Builds a one-block probe with ``nvcc`` into ``build/wgmma_rounding/`` from
the port's ``csrc/tc_blocks.cuh`` and runs one m64n16k16 product whose A
rows are chosen sums (B is a column of ones), then a second product into
the same accumulator. Prints, per row, the float32 result minus the exact
sum in units of 2^-24, with A as given and negated (the instruction's
scale-a of -1). Read there: how many bits of the smaller terms survive the
alignment to the largest one, the rounding of the normalised sum, and
whether the truncation is of magnitude (negation mirrors it) or toward
minus infinity. Prints the card's ``name, power.limit`` first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "wgmma_rounding")

PROBE = r'''
#include <cstdint>
#include "tc_blocks.cuh"

// D1 = (neg ? -A1 : A1) B, then D2 = D1 + A2 B; out (64, 32): D1 | D2
__global__ void probe(const uint4* a1f, const uint4* a2f, const unsigned short* bt,
                      float* out, int neg) {
  __shared__ __align__(128) unsigned short b[16 * 16];
  const int t = threadIdx.x;
  for (int i = t; i < 256; i += 128) b[i] = bt[i];
  fence_smem_async();
  __syncthreads();
  float d[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const uint64_t db = make_desc(b, 256, 128);
  const uint4 a1 = a1f[t], a2 = a2f[t];
  wg_fence();
  if (neg) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, -1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a1.x), "r"(a1.y), "r"(a1.z), "r"(a1.w), "l"(db), "r"(0));
  } else {
    wgmma_rs<1>(d, a1, db, 0);
  }
  wg_commit();
  wg_wait0();
  fence_acc(d);
  const int w = t >> 5, l = t & 31, r = 16 * w + (l >> 2), c = 2 * (l & 3);
  for (int pass = 0; pass < 2; ++pass) {
    for (int j = 0; j < 2; ++j) {
      float* o = out + pass * 16 + c + 8 * j;
      o[r * 32] = d[4 * j];
      o[r * 32 + 1] = d[4 * j + 1];
      o[(r + 8) * 32] = d[4 * j + 2];
      o[(r + 8) * 32 + 1] = d[4 * j + 3];
    }
    if (pass == 0) {
      wg_fence();
      wgmma_rs<1>(d, a2, db, 1);
      wg_commit();
      wg_wait0();
      fence_acc(d);
    }
  }
}

extern "C" int run_probe(const void* a1, const void* a2, const void* b, void* out, int neg) {
  probe<<<1, 128>>>(static_cast<const uint4*>(a1), static_cast<const uint4*>(a2),
                    static_cast<const unsigned short*>(b), static_cast<float*>(out), neg);
  return static_cast<int>(cudaDeviceSynchronize());
}
'''

# (label, terms of the first product's row, terms of the second's)
CASES = [(f"1 {s} 2^-{e}", [1.0, sign * 2.0 ** -e], [])
         for e in (24, 25, 26, 27) for s, sign in (("+", 1.0), ("-", -1.0))]
CASES += [("1 + 3 x 2^-25", [1.0] + [2.0 ** -25] * 3, []),
          ("1 + 15 x 2^-26", [1.0] + [2.0 ** -26] * 15, []),
          ("1.5 + 2^-24 + 2^-25", [1.5, 2.0 ** -24, 2.0 ** -25], []),
          ("C = 1, then + 2^-25", [1.0], [2.0 ** -25]),
          ("C = 1, then - 2^-25", [1.0], [-2.0 ** -25]),
          ("C = 1, then + 15 x 2^-27", [1.0], [2.0 ** -27] * 15)]


def main():
    sys.path.insert(0, REPO)
    import torch

    from stnerf_tpu_torch.kernels._build import ARCH, CSRC, find_nvcc
    from stnerf_tpu_torch.kernels.fused_field import tc_fragments

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    src, lib_path = os.path.join(OUT, "probe.cu"), os.path.join(OUT, "probe.so")
    with open(src, "w") as f:
        f.write(PROBE)
    subprocess.run([find_nvcc(), *ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(CSRC), "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.run_probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]

    def bf16_bits(a):
        return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16).view(torch.int16)

    def frag(rows):
        a = np.zeros((64, 16))
        for i, terms in enumerate(rows):
            a[i, :len(terms)] = terms
        bits = bf16_bits(a).numpy().reshape(-1)
        return torch.tensor(bits[tc_fragments(np.arange(64 * 16).reshape(64, 16))].copy(),
                            device="cuda")

    ones = np.zeros(256, np.int16)  # B (16 k x 16 n) in the act layout, column 0 all ones
    one = bf16_bits([1.0]).numpy()[0]
    for k in range(16):
        ones[(k >> 3) * 128 + (k & 7) * 8] = one
    b = torch.tensor(ones, device="cuda")
    a1, a2 = frag([c[1] for c in CASES]), frag([c[2] for c in CASES])
    for neg in (0, 1):
        out = torch.zeros((64, 32), device="cuda")
        if lib.run_probe(a1.data_ptr(), a2.data_ptr(), b.data_ptr(), out.data_ptr(), neg):
            raise RuntimeError("probe launch failed")
        o = out.cpu().numpy().astype(np.float64)
        for i, (label, t1, t2) in enumerate(CASES):
            e1 = (-1.0 if neg else 1.0) * float(np.sum(t1))
            e2 = e1 + float(np.sum(t2))
            print(f"{'-A' if neg else ' A'}  {label:26s}  D1 - exact {(o[i, 0] - e1) * 2 ** 24:+8.3f}"
                  f"  D2 - exact {(o[i, 16] - e2) * 2 ** 24:+8.3f}  (units of 2^-24)", flush=True)


if __name__ == "__main__":
    main()
