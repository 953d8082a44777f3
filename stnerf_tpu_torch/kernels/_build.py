"""Build and bind the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use each is
compiled with ``nvcc`` for Hopper (``sm_90a``), all of them at once in
parallel, and the objects are linked into one shared library in
``build/kernels/`` at the repository root, loaded with ``ctypes``. The
library's name carries a hash of the sources, the shared headers and the
flags, so an edit to any of them rebuilds it. Without ``nvcc`` the build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "fused_field.cu", CSRC / "fused_field_tc.cu", CSRC / "field_bwd.cu",
           CSRC / "field_bwd_tc.cu", CSRC / "spacenet.cu", CSRC / "spacenet_tc.cu",
           CSRC / "cross_trans.cu")
HEADERS = (CSRC / "field_common.cuh", CSRC / "mlp_blocks.cuh", CSRC / "tc_blocks.cuh",
           CSRC / "tc_bwd.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # float32 fields: xyz, ids, dir, flags, weights, biases, offsets (host),
    # out, then M, dir_rows, width, head, motion_width, freqs,
    # include_input, use_time, n_rgb, motion_mode, and the stream
    "stnerf_fused_field": [_P] * 8 + [_I] * 10 + [_P],
    # bf16 fields (tensor cores): xyz, ids, dir, flags, weights, fragments,
    # biases, offsets (host), out, then the same 10 ints, and the stream
    "stnerf_fused_field_tc": [_P] * 9 + [_I] * 10 + [_P],
    # float32: xyz, ids, dir, d_rgb, d_sigma, flags, weights, biases,
    # offsets (host), gw, gb, d_xyz, d_dir, then the same 10 ints, and the
    # stream
    "stnerf_field_bwd": [_P] * 13 + [_I] * 10 + [_P],
    # bf16 (tensor cores): the same with the fragments after the weights and
    # the workspace after d_dir, then the same 10 ints, the packed weights'
    # and biases' element counts, and the stream
    "stnerf_field_bwd_tc": [_P] * 15 + [_I] * 12 + [_P],
    # the 10 ints and the two counts, then a host int64 for the workspace's
    # bytes
    "stnerf_field_bwd_tc_workspace": [_I] * 12 + [_P],
    # float32 fields: pos, dir, time, weights, biases, offsets (host),
    # active, out, then M, pos_rows, dir_rows, time_rows, width, head, n_rgb,
    # and the stream
    "stnerf_spacenet_fwd": [_P] * 8 + [_I] * 7 + [_P],
    # float32: pos, dir, time, d_rgb, d_sigma, weights, biases, offsets
    # (host), active, gw, gb, d_pos, d_dir, then the same 7 ints, and the
    # stream
    "stnerf_spacenet_bwd": [_P] * 13 + [_I] * 7 + [_P],
    # bf16 fields (tensor cores): pos, dir, time, weights, fragments, biases,
    # offsets (host), active, out, then the same 7 ints, and the stream
    "stnerf_spacenet_fwd_tc": [_P] * 9 + [_I] * 7 + [_P],
    # the same 7 ints, the packed weights' and biases' element counts, then
    # a host int64 for the workspace's bytes
    "stnerf_spacenet_bwd_tc_workspace": [_I] * 9 + [_P],
    # bf16 (tensor cores): pos, dir, time, d_rgb, d_sigma, weights,
    # fragments, biases, offsets (host), active, gw, gb, d_pos, d_dir,
    # workspace, then the same 7 ints and the two counts, and the stream
    "stnerf_spacenet_bwd_tc": [_P] * 15 + [_I] * 9 + [_P],
    # t, out, then L, N, S, and the stream
    "stnerf_cross_successor": [_P] * 2 + [_I] * 3 + [_P],
    # t, logf (forward) or the cotangent (backward), out, then L, N, S, and
    # the stream
    "stnerf_cross_logt_fwd": [_P] * 3 + [_I] * 3 + [_P],
    "stnerf_cross_logt_bwd": [_P] * 3 + [_I] * 3 + [_P],
}


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found on PATH, under $CUDA_HOME/bin or at "
                       "/usr/local/cuda/bin: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*SOURCES, *HEADERS):
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if this hash has no library yet; -> its path.
    The compiler's resource report (registers, shared memory, spills) is
    kept beside the library as ``.log``."""
    lib = BUILD_DIR / f"libstnerf_kernels_{_source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [lib.with_name(f"{src.stem}.{tag}.o") for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [src.name for src, p in zip(SOURCES, procs) if p.returncode != 0]
    tmp = lib.with_suffix(f".{tag}")
    if not failed:
        r = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += r.stdout
        if r.returncode != 0:
            failed = ["link"]
    for obj in objs:
        obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log[-6000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
