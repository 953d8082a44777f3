"""Minimal PLY point-cloud IO in pure NumPy — the port's copy of
``stnerf_tpu/data/ply.py``.

Replaces the reference's open3d dependency, which it used only to read point
positions (ref: data/datasets/frame_dataset.py:45-46, 170-171:
``o3d.io.read_point_cloud(...).points``). Supports ascii and
binary_little_endian, reads the vertex element's x/y/z properties and
ignores everything else. A writer is provided for the synthetic-scene
generator and tests.

The JAX package's optional native C++ reader (``data/native.py``) is not
ported: the port always reads through NumPy.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply_points(path: str) -> np.ndarray:
    """Read vertex (x, y, z) from a PLY file -> (N, 3) float32."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype_code)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                cur = (tok[1], int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == "property":
                if tok[1] == "list":
                    cur[2].append((tok[-1], ("list", _DTYPES[tok[2]], _DTYPES[tok[3]])))
                else:
                    cur[2].append((tok[-1], _DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break

        for name, count, props in elements:
            if name != "vertex":
                continue
            names = [p for p, _ in props]
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    vals = f.readline().split()
                    rows.append([float(v) for v in vals[:len(props)]])
                arr = np.asarray(rows, np.float64)
                idx = [names.index(c) for c in ("x", "y", "z")]
                return arr[:, idx].astype(np.float32)
            elif fmt in ("binary_little_endian", "binary_big_endian"):
                order = "<" if fmt == "binary_little_endian" else ">"
                if any(isinstance(d, tuple) for _, d in props):
                    raise ValueError(f"{path}: list property in vertex element")
                dt = np.dtype([(p, order + d) for p, d in props])
                arr = np.frombuffer(f.read(count * dt.itemsize), dtype=dt, count=count)
                return np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
            else:
                raise ValueError(f"{path}: unknown format {fmt}")
        raise ValueError(f"{path}: no vertex element")


def write_ply_points(path: str, points: np.ndarray, binary: bool = True) -> None:
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    header = (f"ply\nformat {'binary_little_endian' if binary else 'ascii'} 1.0\n"
              f"element vertex {len(pts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(pts.astype("<f4").tobytes())
        else:
            np.savetxt(f, pts, fmt="%.7g")
