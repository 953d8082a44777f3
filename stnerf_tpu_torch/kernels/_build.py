"""Build and bind the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use each is
compiled with ``nvcc`` for Hopper (``sm_90a``), all of them at once in
parallel, and the objects are linked into one shared library in
``build/kernels/`` at the repository root, loaded with ``ctypes``. The
library's name carries a hash of the sources, the shared header and the
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
SOURCES = (CSRC / "fused_field.cu", CSRC / "field_bwd.cu")
HEADERS = (CSRC / "field_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # xyz, ids, dir, flags, weights, biases, offsets (host), out, then
    # M, dir_rows, width, head, motion_width, freqs, include_input,
    # use_time, n_rgb, motion_mode, bf16, and the stream
    "stnerf_fused_field": [_P] * 8 + [_I] * 11 + [_P],
    # xyz, ids, dir, d_rgb, d_sigma, flags, weights, biases, offsets (host),
    # gw, gb, d_xyz, d_dir, then the same 11 ints, and the stream
    "stnerf_field_bwd": [_P] * 13 + [_I] * 11 + [_P],
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
