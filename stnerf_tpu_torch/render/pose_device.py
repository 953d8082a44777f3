"""Whole-pose rendering on the device.

Counterpart of ``stnerf_tpu/render/pose_device.py``. The host sends only
the camera (K, c2w), per-layer frame ids and the edit state. Pixel rays are
generated on the device in screen-tile order — each chunk of rays is one
compact screen tile, so a performer off that tile gets all-zero kernel
skip flags for the whole chunk — and rendered chunk by chunk. Outputs come
back quantized as the JAX package's do (u8 color, f16 depth and alpha);
the host unscrambles the tile order into row-major images.

With a mesh (``parallel.make_mesh``) of D data ranks each rank renders its
contiguous 1/D of every chunk, and the pose is gathered once, after its
last chunk, in one collective over the data group; every rank gets the
whole frame. The chunk is rounded up to a multiple of D x 64
(``render.chunked.shard_chunk``), so each rank's 64-ray kernel tiles are
those of the unsharded render. A layer-sharded model
(``parallel.shard_params``) also splits the fields over the model axis, a
gather over the model group per chunk and stage (``render_rays``).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..models.layered import (EditState, LayeredModel, LayeredSpec, RayInputs,
                              SceneBoxes, render_rays)
from ..parallel import gather_chunked
from .chunked import shard_chunk


class QuantizedFrame(NamedTuple):
    color: torch.Tensor         # (N, 3) u8
    depth: torch.Tensor         # (N,) f16 (raw expected depth)
    acc: torch.Tensor           # (N,) f16
    layer_color: torch.Tensor   # (L+1, N, 3) u8
    layer_depth: torch.Tensor   # (L+1, N) f16
    layer_acc: torch.Tensor     # (L+1, N) f16


def tile_grid(h: int, w: int, chunk: int, tile_cols: int = 256):
    """Static tile geometry: (tile_h, tile_w, tiles_x, tiles_y, n_pad)."""
    tile_w = min(tile_cols, chunk)
    tile_h = chunk // tile_w
    tiles_x = -(-w // tile_w)
    tiles_y = -(-h // tile_h)
    return tile_h, tile_w, tiles_x, tiles_y, tiles_x * tiles_y * chunk


def tile_pixel_coords(h: int, w: int, chunk: int, tile_cols: int = 256):
    """NumPy copy of the device-side tile->pixel mapping, for unscrambling.
    Returns (vs, us, valid) of length n_pad (coords clamped in range)."""
    th, tw, tiles_x, _, n_pad = tile_grid(h, w, chunk, tile_cols)
    idx = np.arange(n_pad)
    tile, r = idx // chunk, idx % chunk
    vs = (tile // tiles_x) * th + r // tw
    us = (tile % tiles_x) * tw + r % tw
    return np.minimum(vs, h - 1), np.minimum(us, w - 1), (vs < h) & (us < w)


def _device_tile_rays(K: np.ndarray, c2w: torch.Tensor, h: int, w: int,
                      chunk: int, tile_cols: int):
    """Pixel rays in tile order -> (origin (3,), dirs (3, n_pad)), float32.
    The rotation is applied as elementwise products (no TF32 matmul)."""
    th, tw, tiles_x, _, n_pad = tile_grid(h, w, chunk, tile_cols)
    device = c2w.device
    idx = torch.arange(n_pad, device=device)
    tile, r = idx // chunk, idx % chunk
    vs = torch.clamp((tile // tiles_x) * th + r // tw, max=h - 1).float()
    us = torch.clamp((tile % tiles_x) * tw + r % tw, max=w - 1).float()
    k_inv = torch.as_tensor(np.linalg.inv(np.asarray(K, np.float32)),
                            dtype=torch.float32, device=device)
    x = k_inv[0, 0] * us + k_inv[0, 1] * vs + k_inv[0, 2]
    y = k_inv[1, 1] * vs + k_inv[1, 2]
    z = torch.ones_like(us)
    norm = torch.rsqrt(x * x + y * y + z * z)
    cam = torch.stack([x * norm, y * norm, z * norm])          # (3, n_pad)
    dirs = (c2w[:3, :3, None] * cam[None]).sum(1)
    return c2w[:3, 3], dirs


def _q8(c: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(c, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


@torch.no_grad()
def render_pose_on_device(model: LayeredModel, scene: SceneBoxes, K, c2w,
                          frame_ids, near_far, edits: EditState, *, h: int,
                          w: int, chunk: int = 32768, tile_cols: int = 256,
                          generator: torch.Generator | None = None,
                          layer_outputs: tuple | None = None,
                          plain: bool = False,
                          spec: LayeredSpec | None = None,
                          mesh=None) -> QuantizedFrame:
    """Render a full pose; K (3, 3) on the host, c2w (4, 4), frame_ids
    (L+1,) and near_far (2,) tensors on the model's device. Returns the
    quantized per-pixel outputs in TILE order (see
    :func:`tile_pixel_coords`; with a mesh, of the chunk rounded as
    ``shard_chunk`` rounds it). Chunks are queued on the device one after
    another with no host synchronisation in between. ``spec`` is the
    render spec ``render_rays`` takes (default: the model's). With a mesh
    over several ranks ``generator`` must be None."""
    if mesh is not None and mesh.data > 1 and generator is not None:
        raise ValueError("a pose sharded over several ranks samples "
                         "deterministically: pass generator=None")
    chunk = shard_chunk(chunk, mesh)
    _, _, _, _, n_pad = tile_grid(h, w, chunk, tile_cols)
    o, dirs = _device_tile_rays(K, c2w, h, w, chunk, tile_cols)
    lp1 = frame_ids.shape[0]
    D, r = (1, 0) if mesh is None else (mesh.data, mesh.rank)
    part = chunk // D
    parts = []
    for c in range(n_pad // chunk):
        d_c = dirs[:, c * chunk + r * part:c * chunk + (r + 1) * part]
        inputs = RayInputs(
            rays_o=o.expand(part, 3), rays_d=d_c.T,
            frame_ids=frame_ids.expand(part, lp1),
            cam_ids=torch.zeros(part, device=dirs.device),
            near_far=near_far.expand(part, 2))
        out = render_rays(model, scene, inputs, edits, generator,
                          layer_outputs=layer_outputs, plain=plain, spec=spec)
        parts.append(QuantizedFrame(
            _q8(out.fine.color), out.fine.depth[:, 0].half(),
            out.fine.acc[:, 0].half(), _q8(out.fine_layers.color),
            out.fine_layers.depth[..., 0].half(),
            out.fine_layers.acc[..., 0].half()))
    # per-layer leaves carry the layer axis first: chunks join along rays
    dims = [1 if name.startswith("layer") else 0 for name in QuantizedFrame._fields]
    frame = [torch.cat(xs, dim=d) for d, xs in zip(dims, zip(*parts))]
    if mesh is not None:
        frame = gather_chunked(mesh, frame, dims, n_pad // chunk)
    return QuantizedFrame(*frame)


def render_pose_host(model: LayeredModel, scene: SceneBoxes, K, c2w,
                     frame_ids, near_far, edits: EditState, h: int, w: int,
                     chunk: int = 32768, tile_cols: int = 256,
                     generator: torch.Generator | None = None,
                     far_clip: float = 20.0, download_layers=None,
                     plain: bool = False, spec: LayeredSpec | None = None,
                     timings: dict | None = None, mesh=None):
    """-> (color (H,W,3), depth (H,W,1), color_layer list, depth_layer list),
    numpy images in [0, 1] (depth divided by ``far_clip``).

    ``download_layers`` (layer ids) limits the per-layer work to those
    layers: the others' fine composites are not computed, they are not
    downloaded, and they come back as zero images. The mixed color and
    depth always come back. ``plain`` renders with the plain PyTorch field
    evaluation instead of the kernel; ``spec`` as
    :func:`render_pose_on_device` takes it. ``timings`` (a dict) receives
    ``device_s``, the seconds from the call to the device's end of the
    pose (a CUDA synchronisation on a card), and ``download_s``, the
    seconds of the copy to the host. With ``mesh`` the rays shard across
    its ranks (:func:`render_pose_on_device`) and every rank returns the
    whole images.
    """
    device = next(model.parameters()).device
    lp1 = model.spec.layer_num + 1
    dl = (list(range(lp1)) if download_layers is None else
          sorted({int(i) for i in download_layers if 0 <= int(i) < lp1}))
    lo = None if download_layers is None else tuple(dl)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    t0 = time.perf_counter()
    out = render_pose_on_device(
        model, scene, np.asarray(K, np.float32), dev(c2w), dev(frame_ids),
        dev(near_far), edits, h=h, w=w, chunk=chunk, tile_cols=tile_cols,
        generator=generator, layer_outputs=lo, plain=plain, spec=spec, mesh=mesh)
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings["device_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    lc, ld = out.layer_color, out.layer_depth
    if len(dl) < lp1:
        lc, ld = lc[dl], ld[dl]
    color_q, depth_q, lcolor_q, ldepth_q = (
        t.cpu().numpy() for t in (out.color, out.depth, lc, ld))
    if timings is not None:
        timings["download_s"] = time.perf_counter() - t0
    vs, us, valid = tile_pixel_coords(h, w, shard_chunk(chunk, mesh), tile_cols)

    def unscramble(flat, channels):
        img = np.zeros((h, w, channels), flat.dtype)
        img[vs[valid], us[valid]] = flat[valid].reshape(-1, channels)
        return img

    color = unscramble(color_q, 3).astype(np.float32) / 255.0
    depth = np.clip(unscramble(depth_q[:, None], 1).astype(np.float32),
                    0, None) / far_clip
    pos = {layer: k for k, layer in enumerate(dl)}
    color_layer = [
        unscramble(lcolor_q[pos[i]], 3).astype(np.float32) / 255.0
        if i in pos else np.zeros((h, w, 3), np.float32)
        for i in range(lp1)]
    depth_layer = [
        np.clip(unscramble(ldepth_q[pos[i]][:, None], 1).astype(np.float32),
                0, None) / far_clip
        if i in pos else np.zeros((h, w, 1), np.float32)
        for i in range(lp1)]
    return color, depth, color_layer, depth_layer
