"""Textured-mesh background rasterization — the port's copy of
``stnerf_tpu/render/bkgd_renderer.py``.

Counterpart of the reference's pyrender/EGL offscreen renderer
(ref: render/bkgd_renderer.py:13-71: abstract ``MeshRender`` + ``PrRender``
rendering ``background/textured.obj`` with pinhole intrinsics). The
rasterizer runs on the host: the native C++ z-buffer rasterizer
(``data/native.py``) when it builds, else the NumPy one here, as in the JAX
package. ``Mesh`` is a triangle mesh; the device mesh of several ranks is
``parallel.DeviceMesh``.

The texture is read with the port's PNG codec (``data/png.py``); a texture
in another format raises and names it.

Camera convention matches the ray generator (OpenCV pinhole); the
reference's GL-vs-CV axis-flip matrix (ref: bkgd_renderer.py:25-30) is
unnecessary because nothing here is GL.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.png import read_png

# leading bytes of the image formats a texture may come in
_MAGIC = ((b"\x89PNG\r\n\x1a\n", "PNG"), (b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"),
          (b"GIF8", "GIF"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"RIFF", "WebP"))


class Mesh:
    """A textured triangle mesh: vertices (V, 3), per-vertex uvs (V, 2),
    faces (F, 3) of vertex ids and a texture (H, W, 3) uint8."""

    def __init__(self, verts, uvs, faces, texture):
        self.verts = np.asarray(verts, np.float32)
        self.uvs = np.asarray(uvs, np.float32)
        self.faces = np.asarray(faces, np.int32)
        self.texture = np.asarray(texture, np.uint8)


def read_texture(path: str) -> np.ndarray:
    """A PNG texture -> (H, W, 3) uint8 (grey repeated, alpha dropped). A
    file in any other format raises with its format's name."""
    with open(path, "rb") as f:
        head = f.read(8)
    kind = next((name for magic, name in _MAGIC if head.startswith(magic)), "unknown")
    if kind != "PNG":
        raise ValueError(f"{path}: a {kind} texture; only PNG textures are read")
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):      # grey, grey + alpha
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def load_textured_obj(path: str) -> Mesh:
    """Minimal OBJ+MTL loader for ``v``/``vt``/``f`` with one diffuse texture
    (the reference scene's ``background/textured.obj``)."""
    verts, uvs, faces = [], [], []
    tex_path = None
    mtl = None
    base = os.path.dirname(path)
    uv_of_vert: dict[int, int] = {}
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                uvs.append([float(tok[1]), float(tok[2])])
            elif tok[0] == "mtllib":
                mtl = os.path.join(base, tok[1])
            elif tok[0] == "f":
                idx = []
                for part in tok[1:]:
                    comp = part.split("/")
                    vi = int(comp[0]) - 1
                    ti = int(comp[1]) - 1 if len(comp) > 1 and comp[1] else vi
                    uv_of_vert[vi] = ti
                    idx.append(vi)
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if mtl and os.path.exists(mtl):
        with open(mtl) as f:
            for line in f:
                tok = line.split()
                if tok and tok[0] == "map_Kd":
                    tex_path = os.path.join(base, tok[-1])
    verts = np.asarray(verts, np.float32)
    uv_arr = np.zeros((len(verts), 2), np.float32)
    if uvs:
        uvs = np.asarray(uvs, np.float32)
        for vi, ti in uv_of_vert.items():
            uv_arr[vi] = uvs[ti]
    if tex_path and os.path.exists(tex_path):
        texture = read_texture(tex_path)
    else:
        texture = np.full((2, 2, 3), 128, np.uint8)
    return Mesh(verts, uv_arr, np.asarray(faces, np.int32), texture)


def _rasterize_numpy(mesh: Mesh, K, c2w, h, w):
    """Vectorized-per-triangle NumPy rasterizer (same math as the C++ path)."""
    w2c = np.linalg.inv(np.asarray(c2w, np.float64)).astype(np.float32)
    cam = mesh.verts @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    px = K[0, 0] * cam[:, 0] / z + K[0, 2]
    py = K[1, 1] * cam[:, 1] / z + K[1, 2]
    rgb = np.zeros((h, w, 3), np.uint8)
    depth = np.zeros((h, w), np.float32)
    zbuf = np.full((h, w), 1e30, np.float32)
    for f in mesh.faces:
        if np.any(z[f] <= 1e-6):
            continue
        xs, ys, zs = px[f], py[f], z[f]
        x0, x1 = int(max(0, np.floor(xs.min()))), int(min(w - 1, np.ceil(xs.max())))
        y0, y1 = int(max(0, np.floor(ys.min()))), int(min(h - 1, np.ceil(ys.max())))
        if x0 > x1 or y0 > y1:
            continue
        den = (ys[1] - ys[2]) * (xs[0] - xs[2]) + (xs[2] - xs[1]) * (ys[0] - ys[2])
        if abs(den) < 1e-12:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        l0 = ((ys[1] - ys[2]) * (gx - xs[2]) + (xs[2] - xs[1]) * (gy - ys[2])) / den
        l1 = ((ys[2] - ys[0]) * (gx - xs[2]) + (xs[0] - xs[2]) * (gy - ys[2])) / den
        l2 = 1 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        if not inside.any():
            continue
        w0, w1, w2 = l0 / zs[0], l1 / zs[1], l2 / zs[2]
        zp = 1.0 / (w0 + w1 + w2)
        win = zbuf[y0:y1 + 1, x0:x1 + 1]
        upd = inside & (zp < win)
        if not upd.any():
            continue
        uv = mesh.uvs[f]
        u = (w0 * uv[0, 0] + w1 * uv[1, 0] + w2 * uv[2, 0]) * zp
        v = (w0 * uv[0, 1] + w1 * uv[1, 1] + w2 * uv[2, 1]) * zp
        th, tw = mesh.texture.shape[:2]
        tu = np.clip((u * (tw - 1) + 0.5).astype(np.int32), 0, tw - 1)
        tv = np.clip(((1 - v) * (th - 1) + 0.5).astype(np.int32), 0, th - 1)
        texel = mesh.texture[tv, tu]
        win[upd] = zp[upd]
        rgb[y0:y1 + 1, x0:x1 + 1][upd] = texel[upd]
        depth[y0:y1 + 1, x0:x1 + 1][upd] = zp[upd]
    return rgb, depth


class MeshRender:
    """Rasterize a textured mesh from arbitrary poses.

    Same role as the reference's ``PrRender`` (ref: render/bkgd_renderer.py:24-71);
    the native C++ rasterizer when it builds, NumPy otherwise.
    """

    def __init__(self, mesh: Mesh | str):
        self.mesh = load_textured_obj(mesh) if isinstance(mesh, str) else mesh

    def render(self, K, c2w, h: int, w: int):
        """-> (rgb (H, W, 3) uint8, depth (H, W) float32 camera z, 0 where
        nothing is hit)."""
        from ..data import native

        out = native.rasterize(self.mesh.verts, self.mesh.uvs, self.mesh.faces,
                               self.mesh.texture, K, c2w, h, w)
        if out is None:
            out = _rasterize_numpy(self.mesh, np.asarray(K, np.float32), c2w, h, w)
        return out


# Reference-name alias (ref: render/bkgd_renderer.py:24)
PrRender = MeshRender
