"""Legacy per-(frame, layer) renderer (counterpart of
``stnerf_tpu/render/neural_renderer.py``).

Counterpart of the reference's older ``NeuralRenderer`` design
(ref: render/neural_renderer.py:11-322): one independent radiance field per
(frame, layer) held in nested dicts, an optionally mesh-rasterized
background (ref: :76-86, 189-206), and z-buffer ``mix_image`` compositing of
the per-layer renders (ref: :212-234). Superseded by
``LayeredNeuralRenderer`` for the main path but kept for parity and for
scenes captured as per-frame models.

Each field is a background-only :class:`LayeredModel` (``layer_num=0``;
a JAX package's field crosses over through ``models.load_jax_params``) and
renders through ``render_rays_chunked``, so its network runs the field
kernel K1 on a card. Frames are written as PNG.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..data.cameras import pixel_rays
from ..models import EditState, LayeredModel, LayeredSpec, RayInputs, SceneBoxes
from .bkgd_renderer import MeshRender
from .chunked import render_rays_chunked
from .video import write_image


@dataclasses.dataclass
class FieldEntry:
    params: LayeredModel   # a background-only model (layer_num=0)
    spec: LayeredSpec      # its render spec (usually params.spec)
    bbox: np.ndarray       # (2, 3)
    near_far: np.ndarray   # (2,)


class NeuralRenderer:

    def __init__(self, cfg=None, output_dir: str = ""):
        self.cfg = cfg
        self.output_dir = output_dir or (cfg.OUTPUT_DIR if cfg else "")
        self.models: dict[int, dict[int, FieldEntry]] = {}
        self.images: dict = {}
        self.depths: dict = {}
        self.image_num = 0
        self.bkgd_mesh: MeshRender | None = None
        self.far = 20.0

    # -- model management -------------------------------------------------
    def add_model(self, frame_id: int, layer_id: int, entry: FieldEntry):
        if entry.params.spec.layer_num != 0:
            raise ValueError("a field of the legacy renderer is a background-only "
                             f"model (layer_num 0), not {entry.params.spec.layer_num}")
        self.models.setdefault(frame_id, {})[layer_id] = entry

    def set_bkgd_mesh(self, mesh_or_path):
        """Use a textured mesh for the background instead of a field
        (ref: render/neural_renderer.py:76-86)."""
        self.bkgd_mesh = (mesh_or_path if isinstance(mesh_or_path, MeshRender)
                          else MeshRender(mesh_or_path))

    # -- rendering ---------------------------------------------------------
    def render_frame_layer(self, frame_id: int, layer_id: int, pose, K,
                           h: int, w: int, chunk: int = 8192):
        """Render one field -> (color (H,W,3), depth (H,W))."""
        e = self.models[frame_id][layer_id]
        device = next(e.params.parameters()).device
        rays = pixel_rays(np.asarray(K, np.float32), np.asarray(pose, np.float32), h, w)
        n = rays.shape[0]
        inputs = RayInputs(rays[:, :3], rays[:, 3:6],
                           np.ones((n, 1), np.float32),
                           np.zeros(n, np.float32),
                           np.tile(e.near_far[None], (n, 1)).astype(np.float32))

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        scene = SceneBoxes(bkgd_box=t(e.bbox), boxes=t(np.zeros((1, 0, 2, 3))),
                           bkgd_near_far=t(e.near_far))
        out = render_rays_chunked(e.params, e.spec, scene, inputs,
                                  EditState.identity(0, device=device), chunk=chunk)
        color = np.asarray(out.fine.color).reshape(h, w, 3)
        depth = np.asarray(out.fine.depth).reshape(h, w)
        acc = np.asarray(out.fine.acc).reshape(h, w)
        # empty space -> infinite depth so mix_image composites correctly
        depth = np.where(acc > 1e-3, depth / np.maximum(acc, 1e-6), np.inf)
        return color, depth

    def render_bkgd(self, pose, K, h: int, w: int):
        if self.bkgd_mesh is None:
            raise ValueError("no background mesh: call set_bkgd_mesh first")
        rgb, depth = self.bkgd_mesh.render(np.asarray(K, np.float32), pose, h, w)
        depth = np.where(depth > 0, depth, np.inf)
        return rgb.astype(np.float32) / 255.0, depth

    @staticmethod
    def mix_image(colors, depths):
        """Z-buffer composite of per-layer renders
        (ref: render/neural_renderer.py:212-234)."""
        colors = [np.asarray(c, np.float32) for c in colors]
        depths = [np.asarray(d, np.float32) for d in depths]
        out = np.zeros_like(colors[0])
        zbuf = np.full(depths[0].shape, np.inf, np.float32)
        for c, d in zip(colors, depths):
            closer = d < zbuf
            out[closer] = c[closer]
            zbuf[closer] = d[closer]
        return out, zbuf

    def render_pose(self, frame_id: int, pose, K, h: int, w: int,
                    use_mesh_bkgd: bool = False):
        """Render every layer of one frame and z-composite."""
        colors, depths = [], []
        if use_mesh_bkgd:
            c, d = self.render_bkgd(pose, K, h, w)
            colors.append(c)
            depths.append(d)
        for layer_id, entry in sorted(self.models.get(frame_id, {}).items()):
            if use_mesh_bkgd and layer_id == 0:
                continue
            c, d = self.render_frame_layer(frame_id, layer_id, pose, K, h, w)
            colors.append(c)
            depths.append(d)
        return self.mix_image(colors, depths)

    def render_path_frame_layer(self, frame_id: int, layer_id: int, poses, K,
                                h: int, w: int, save_dir: str = ""):
        """Render one (frame, layer) along a pose path
        (ref: render/render_functions.py:131-188); with ``save_dir``, each
        frame's colour and depth as ``color/<i>.png`` and ``depth/<i>.png``
        (the JAX package writes colour as JPEG)."""
        rgbs, depths = [], []
        for i, pose in enumerate(poses):
            c, d = self.render_frame_layer(frame_id, layer_id, pose, K, h, w)
            rgbs.append(c)
            depths.append(d)
            if save_dir:
                os.makedirs(os.path.join(save_dir, "color"), exist_ok=True)
                os.makedirs(os.path.join(save_dir, "depth"), exist_ok=True)
                write_image(os.path.join(save_dir, "color", f"{i}.png"), c)
                finite = np.where(np.isfinite(d), d, 0.0) / self.far
                write_image(os.path.join(save_dir, "depth", f"{i}.png"), finite[..., None])
        return rgbs, depths
