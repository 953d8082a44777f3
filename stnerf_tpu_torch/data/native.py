"""ctypes bindings for the native host library (counterpart of
``stnerf_tpu/data/native.py``).

The library is the port's own copy of the C++ source,
``stnerf_tpu_torch/native/stnerf_host.cpp``, compiled with ``g++`` at first
use into ``build/native/`` at the repository root. A ``.srchash`` sidecar
records the sha256 of the source the binary was built from, with the
compiler flags and the host CPU's (``-march=native``), and a binary whose
sidecar does not match is rebuilt, never loaded.
The JAX package's ``native/libstnerf_host.so`` is never loaded. Every entry
point returns None when the library cannot be built (no compiler), and
every caller has a NumPy path for that case.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "stnerf_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIBRARY = BUILD_DIR / "libstnerf_host.so"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


def _src_hash() -> str:
    """The source, the flags and this CPU's feature flags, hashed."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    try:
        with open("/proc/cpuinfo") as f:
            h.update(next((line for line in f if line.startswith("flags")), "").encode())
    except OSError:
        pass
    return h.hexdigest()


def _stored_hash() -> str | None:
    try:
        return LIBRARY.with_name(LIBRARY.name + ".srchash").read_text().strip()
    except OSError:
        return None


def _build(want: str) -> bool:
    """Compile the source unless the library on disk was built from it; one
    process at a time (a file lock), the binary and its sidecar each written
    under a temporary name and renamed. -> whether the library is there."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if LIBRARY.exists() and _stored_hash() == want:
            return True
        tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                           capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return False
        os.replace(tmp, LIBRARY)
        side = LIBRARY.with_name(f"{LIBRARY.name}.srchash.{os.getpid()}.tmp")
        side.write_text(want)
        os.replace(side, LIBRARY.with_name(LIBRARY.name + ".srchash"))
        return True


@functools.lru_cache(maxsize=None)
def _load():
    """The library, built if needed, loaded once per process; None when it
    cannot be built."""
    want = _src_hash()
    if not _build(want):
        return None
    lib = ctypes.CDLL(str(LIBRARY))
    if lib.stnerf_abi_version() != 1:
        raise RuntimeError(f"{LIBRARY}: ABI version {lib.stnerf_abi_version()}, expected 1")
    _configure(lib)
    return lib


def _configure(lib):
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.stnerf_abi_version.restype = ctypes.c_int
    lib.stnerf_abi_version.argtypes = []
    lib.stnerf_ply_read_points.restype = ctypes.c_long
    lib.stnerf_ply_read_points.argtypes = [ctypes.c_char_p, f32p, ctypes.c_long]
    lib.stnerf_pixel_rays.restype = None
    lib.stnerf_pixel_rays.argtypes = [f32p, f32p] + [ctypes.c_int] * 4 + [f32p]
    lib.stnerf_rasterize.restype = None
    lib.stnerf_rasterize.argtypes = [f32p, f32p, ctypes.c_long, i32p,
                                     ctypes.c_long, u8p, ctypes.c_int,
                                     ctypes.c_int, f32p, f32p, ctypes.c_int,
                                     ctypes.c_int, u8p, f32p]
    lib.stnerf_near_far.restype = None
    lib.stnerf_near_far.argtypes = [f32p, ctypes.c_long, f32p, ctypes.c_int,
                                    f32p, f32p]


def _camera(K, c2w):
    """K (3, 3) and a (3, 4) or (4, 4) pose as contiguous float32 arrays."""
    K = np.ascontiguousarray(K, np.float32)
    c2w = np.ascontiguousarray(c2w, np.float32)
    if K.shape != (3, 3) or c2w.shape not in ((3, 4), (4, 4)):
        raise ValueError(f"K {K.shape} and pose {c2w.shape}: expected (3, 3) and (4, 4)")
    return K, c2w


def available() -> bool:
    return _load() is not None


def ply_read_points(path: str) -> np.ndarray | None:
    """Native PLY read; None on an unsupported layout (the caller reads it
    with NumPy)."""
    lib = _load()
    if lib is None:
        return None
    # size the buffer from the header's vertex count (a cheap text scan)
    try:
        with open(path, "rb") as f:
            head = f.read(8192).decode("ascii", "replace")
    except OSError:
        return None
    for line in head.splitlines():
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
            break
    else:
        return None
    out = np.empty((n, 3), np.float32)
    got = lib.stnerf_ply_read_points(path.encode(), out, out.size)
    return out if got == n else None


def pixel_rays(K: np.ndarray, c2w: np.ndarray, h: int, w: int,
               roi=None) -> np.ndarray | None:
    """Rays [origin | direction] (N, 6) through every pixel of ``roi``
    (min_h, max_h, min_w, max_w; default the whole image), row-major."""
    lib = _load()
    if lib is None:
        return None
    minh, maxh, minw, maxw = roi if roi is not None else (0, h, 0, w)
    if not (0 <= minh <= maxh and 0 <= minw <= maxw):
        raise ValueError(f"bad roi {roi}")
    K, c2w = _camera(K, c2w)
    out = np.empty(((maxh - minh) * (maxw - minw), 6), np.float32)
    lib.stnerf_pixel_rays(K, c2w, minh, maxh, minw, maxw, out)
    return out


def rasterize(verts, uvs, faces, texture, K, c2w, h: int, w: int):
    """Textured-mesh rasterization -> (rgb (H,W,3) u8, depth (H,W) f32).
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    verts = np.ascontiguousarray(verts, np.float32)
    uvs = np.ascontiguousarray(uvs, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    texture = np.ascontiguousarray(texture, np.uint8)
    if uvs.shape != (len(verts), 2) or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"mesh shapes: verts {verts.shape}, uvs {uvs.shape}, "
                         f"faces {faces.shape}")
    if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError("a face indexes a vertex outside the mesh")
    if texture.ndim != 3 or texture.shape[2] != 3:
        raise ValueError(f"texture of shape {texture.shape}, expected (H, W, 3)")
    K, _ = _camera(K, c2w)
    w2c = np.ascontiguousarray(np.linalg.inv(np.asarray(c2w, np.float64)),
                               np.float32)
    rgb = np.empty((h, w, 3), np.uint8)
    depth = np.empty((h, w), np.float32)
    lib.stnerf_rasterize(verts, uvs, len(verts), faces, len(faces), texture,
                         texture.shape[0], texture.shape[1],
                         K, w2c, h, w, rgb, depth)
    return rgb, depth


def near_far(pts: np.ndarray, w2c: np.ndarray):
    """Per camera, the nearest and farthest depth of ``pts`` (N, 3) under
    each of the ``w2c`` (M, 4, 4) poses -> (near (M,), far (M,))."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, np.float32)
    w2c = np.ascontiguousarray(w2c, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3 or w2c.ndim != 3 or w2c.shape[1:] != (4, 4):
        raise ValueError(f"points {pts.shape} and poses {w2c.shape}: expected (N, 3) "
                         "and (M, 4, 4)")
    m = w2c.shape[0]
    near = np.empty(m, np.float32)
    far = np.empty(m, np.float32)
    lib.stnerf_near_far(pts, len(pts), w2c, m, near, far)
    return near, far
