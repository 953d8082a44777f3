"""LayeredNeuralRenderer — the user-facing free-viewpoint rendering API, the
port's counterpart of ``stnerf_tpu/render/renderer.py``.

Method for method the JAX package's renderer (ref:
render/layered_neural_renderer.py:17-741): checkpoint discovery and loading
(the port's own files, the JAX package's ``.ckpt`` and the reference's
``.pt``), camera-path authoring (smooth SLERP/B-spline paths, gt-pose paths,
lookat paths), per-layer frame scheduling with retiming, edits (hide/show,
shift/scale/alpha animation via ``s_*`` schedules, near clip, zoom), batch
rendering of paths with per-frame disk output, and video export. Edits are
collected into an ``EditState`` per output frame and passed to the render:
nothing is mutated on the model.

Every pose renders through ``render_pose_host``: the field kernel K1 on a
CUDA card. The config's inference approximations render as the JAX
renderer's do: the fast fine stage and the early-exit coarse march
(``TPU.FAST_FINE``, ``TPU.EARLY_EXIT_SEGMENTS``), and boxes refined to the
trained fields' occupancy (``TPU.OCCUPANCY_SKIP``, ``render/occupancy.py``,
only with a checkpoint loaded). The fidelity gate (``TPU.FIDELITY_GATE``)
probes them against the exact path on the first gt pose at the loaded
weights, sets ``fidelity_db``, and below ``TPU.FIDELITY_MIN_DB`` falls back
to the exact path for the renderer's life. Frames are written as PNG (the
JAX renderer writes colour as JPEG), in the same directory tree.

With a mesh (``parallel.make_mesh``) every rank constructs the renderer
and renders every pose with its rays sharded across the ranks
(``render_pose_host(mesh=)``). Rank 0 alone refines the occupancy boxes,
runs the fidelity gate and writes frames; the other ranks take its boxes,
its gate decision and its parameters, so that no two ranks render a pose
on different paths. The parameters stay replicated on any mesh, a model
axis included, as the JAX renderer's do.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from ..data import RenderScene
from ..device import resolve_device
from ..engine.checkpoint import latest_checkpoint, load_params_any
from ..models import EditState, LayeredModel, LayeredSpec, SceneBoxes, compute_scale_pivot
from ..parallel import replicate
from .occupancy import refined_boxes_cached
from .paths import lookat_path, lookat_path_centers, retime_frames, smooth_pose_path
from .pose_device import render_pose_host, render_pose_on_device
from .video import write_image, write_video


def _exact(spec: LayeredSpec) -> LayeredSpec:
    """``spec`` with the approximations stripped: the gate's reference."""
    return dataclasses.replace(spec, fast_fine=False, coarse_exit_segments=0)


class LayeredNeuralRenderer:

    def __init__(self, cfg, scale=None, shift=None, rotation=None,
                 s_shift=None, s_scale=None, s_alpha=None, params=None,
                 mesh=None, device=None):
        """``params``: a :class:`LayeredModel` to render; by default the
        newest checkpoint under ``cfg.OUTPUT_DIR`` is loaded into a model
        built from ``cfg``, or, with none there, a fresh model from seed 0.
        ``device``: where the scene and the model live (default: the CUDA
        card; raises without one). ``rotation`` is accepted for ctor parity
        and ignored, as in the JAX package and the reference. ``mesh``: the
        ranks to shard every pose's rays over (``parallel.make_mesh``), each
        on its own ``device``."""
        self.cfg = cfg
        self.mesh = mesh
        self.logger = logging.getLogger("stnerf_tpu_torch.render")
        self.device = resolve_device(device)
        self.scale = scale
        self.shift = shift
        self.rotation = rotation
        self.s_shift = s_shift
        self.s_scale = s_scale
        self.s_alpha = s_alpha
        self.alpha = s_alpha[0] if s_alpha is not None else None
        if s_shift is not None:
            self.shift = s_shift[0]
        if s_scale is not None:
            self.scale = s_scale[0]

        self.dataset_dir = cfg.OUTPUT_DIR
        self.output_dir = os.path.join(cfg.OUTPUT_DIR, "rendered")

        self.dataset = RenderScene(cfg, self.device)
        self.scene = self.dataset.scene_boxes
        self._exact_scene = self.scene  # the boxes before occupancy (the gate)
        self._ckpt_path = None
        self._params_supplied = params is not None
        self.model = params if params is not None else self._load_params(
            LayeredSpec.from_cfg(cfg, camera_num=self.dataset.camera_num))
        if mesh is not None:
            replicate(mesh, self.model)
        # the spec every pose renders with: the model's, with the config's
        # approximations, and the sorted merge as the JAX renderer's spec
        self.spec = dataclasses.replace(
            self.model.spec, fast_fine=cfg.TPU.FAST_FINE, nosort_composite=False,
            coarse_exit_segments=int(cfg.TPU.EARLY_EXIT_SEGMENTS))
        # the scale edit's pivot comes from the original frame-0 boxes, so
        # edits do not move when occupancy shrinks the boxes
        self.scale_pivot = compute_scale_pivot(self.scene.bkgd_box, self.scene.boxes[0])
        # occupancy only means something for a trained field: a fresh model
        # (no checkpoint on disk) keeps the scene's boxes
        if cfg.TPU.OCCUPANCY_SKIP and self._ckpt_path is not None and self._main:
            self.scene = refined_boxes_cached(
                self.model, self.scene, cache_dir=self.dataset_dir,
                ckpt_path=self._ckpt_path, grid=cfg.TPU.OCC_GRID,
                sigma_thresh=cfg.TPU.OCC_SIGMA_THRESH, pad_voxels=cfg.TPU.OCC_PAD_VOXELS,
                refine_bkgd=cfg.TPU.OCC_BKGD, slices=cfg.TPU.OCC_SLICES,
                auto_tau_db=(float(cfg.TPU.FIDELITY_MIN_DB)
                             if cfg.TPU.OCC_AUTO_TAU else None))

        ln = cfg.DATASETS.LAYER_NUM
        self.layer_num = ln
        self.frame_num = cfg.DATASETS.FRAME_NUM
        self.camera_num = self.dataset.camera_num
        self.display_layers = {i: 1 for i in range(ln + 1)}
        self.min_frame = [1 + cfg.DATASETS.FRAME_OFFSET] * (ln + 1)
        self.max_frame = [cfg.DATASETS.FRAME_NUM + cfg.DATASETS.FRAME_OFFSET] * (ln + 1)
        self.min_camera_id = 0
        self.max_camera_id = self.camera_num - 1

        self.gt_poses = self.dataset.poses
        self.gt_Ks = self.dataset.Ks
        self.near = 0.0
        self.far = 20.0
        self.fps = 25
        self.height = cfg.INPUT.SIZE_TEST[1]
        self.width = cfg.INPUT.SIZE_TEST[0]

        self.poses: list = []
        self.Ks: list = []
        self.layer_frame_pairs: list = []
        self.images: list = []
        self.depths: list = []
        self.image_num = 0
        self.save_count = 0
        self.dir_name = ""
        self.trace_layer = -1
        self.s_shift_frame = None
        self.s_scale_frame = None
        self.s_alpha_frame = None

        # the fidelity gate (renderer.py:118-143): a trained model, from disk
        # or passed in, must hold FIDELITY_MIN_DB against the exact path
        # before any frame ships with the approximations. Occupancy boxes
        # enter the probe only under a manual tau: auto-tau culling carries
        # its own analytic bound (render/occupancy.auto_tau)
        self.fidelity_db = None
        occ_in_probe = (self.scene is not self._exact_scene
                        and not cfg.TPU.OCC_AUTO_TAU)
        approx = (self.spec.fast_fine or self.spec.coarse_exit_segments > 1
                  or occ_in_probe)
        if (approx and cfg.TPU.FIDELITY_GATE and self._main
                and (self._ckpt_path is not None or self._params_supplied)
                and len(self.gt_poses) > 0):
            self._apply_fidelity_gate()
        if mesh is not None:
            self._follow_main()

    @property
    def _main(self) -> bool:
        return self.mesh is None or self.mesh.is_main

    def _follow_main(self):
        """Every rank renders with rank 0's boxes, spec and gate reading."""
        state = None
        if self._main:
            state = (self.spec, self.fidelity_db, self.scene is self._exact_scene,
                     [t.cpu().numpy() for t in self.scene])
        self.spec, self.fidelity_db, exact, boxes = self.mesh.broadcast_object(state)
        self.scene = self._exact_scene if exact else SceneBoxes(
            *(torch.as_tensor(x, device=self.device) for x in boxes))

    # ------------------------------------------------------------------
    def _load_params(self, spec: LayeredSpec) -> LayeredModel:
        model = LayeredModel(spec, torch.Generator().manual_seed(0), device=self.device)
        path = latest_checkpoint(self.dataset_dir)
        if path is None:
            self.logger.warning("no checkpoint under %s — using fresh params",
                                self.dataset_dir)
            return model
        self.logger.info("loading checkpoint %s", path)
        self._ckpt_path = path
        return load_params_any(path, model)

    # ------------------------------------------------------------------
    def _fidelity_probe(self, spec: LayeredSpec, scene, seed: int | None = 0,
                        width: int | None = None) -> torch.Tensor:
        """The gate's probe image: the first gt pose, ``FIDELITY_PROBE_RES``
        (or ``width``) wide, frame ``min_frame[0]``, no edits, rendered with
        ``spec`` on ``scene`` -> float colour in [0, 1] (u8 steps), tile
        order, on the device. ``seed``: a generator seeded so for the
        render (the JAX gate's ``PRNGKey(0)``), None for deterministic
        sampling."""
        cfg = self.cfg
        pw = max(16, int(cfg.TPU.FIDELITY_PROBE_RES if width is None else width))
        ph = max(16, round(pw * self.height / self.width))
        K = np.array(self.gt_Ks[0], np.float32).copy()
        K[0] *= pw / self.width
        K[1] *= ph / self.height
        c2w = np.array(self.gt_poses[0], np.float32)
        if c2w.shape == (3, 4):
            c2w = np.concatenate([c2w, [[0, 0, 0, 1]]], 0).astype(np.float32)

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        generator = (None if seed is None else
                     torch.Generator(device=self.device).manual_seed(seed))
        out = render_pose_on_device(
            self.model, scene, K, dev(c2w),
            dev(np.full(self.layer_num + 1, self.min_frame[0])),
            dev(self.dataset.near_far),
            EditState.identity(self.layer_num, scale_pivot=self.scale_pivot,
                               device=self.device),
            h=ph, w=pw, chunk=min(int(cfg.TPU.RENDER_CHUNK), pw * ph),
            tile_cols=min(int(cfg.TPU.TILE_COLS), pw), generator=generator, spec=spec)
        return out.color.float() / 255.0

    def _probe_db(self, scene) -> float:
        """PSNR of the probe rendered with ``self.spec`` on ``scene``
        against the exact spec on the original boxes, both with the same
        stratification."""
        err = self._fidelity_probe(self.spec, scene) - self._fidelity_probe(
            _exact(self.spec), self._exact_scene)
        mse = torch.clamp(torch.mean(err * err), min=1e-12)
        return float(-10.0 * torch.log10(mse))

    def _apply_fidelity_gate(self):
        """Probe the approximate path against the exact one at the loaded
        weights (``renderer.py:157-250``); below ``TPU.FIDELITY_MIN_DB``
        fall back to the exact path (first, with manual-tau occupancy, by
        dropping only the occupancy boxes). Sets ``self.fidelity_db``."""
        cfg = self.cfg
        # auto-tau culling carries its own worst-case bound, and probing the
        # tightened boxes would reject it spuriously (the smaller interval
        # re-stratifies every sample: the probe caps near 38 dB from the
        # quadrature shift alone); the probe measures the approximations
        # without analytic bounds on the original boxes
        probe_scene = (self._exact_scene
                       if cfg.TPU.OCCUPANCY_SKIP and cfg.TPU.OCC_AUTO_TAU
                       else self.scene)
        self.fidelity_db = self._probe_db(probe_scene)
        min_db = float(cfg.TPU.FIDELITY_MIN_DB)
        if self.fidelity_db >= min_db:
            self.logger.info(
                "fidelity gate: approximate path %.1f dB vs exact (>= %.1f dB) — "
                "production fast path active", self.fidelity_db, min_db)
            return
        if probe_scene is not self._exact_scene:
            # manual-tau occupancy was in the probe: before reverting the
            # whole fast stack, probe the fast flags on the original boxes
            no_occ_db = self._probe_db(self._exact_scene)
            if no_occ_db >= min_db:
                self.logger.warning(
                    "fidelity gate: manual-tau occupancy takes the probe to %.1f "
                    "dB (< %.1f) but the fast path alone holds %.1f dB — dropping "
                    "occupancy boxes, keeping the fast path (OCC_AUTO_TAU culling "
                    "would ship under its own analytic bound instead)",
                    self.fidelity_db, min_db, no_occ_db)
                self.fidelity_db = no_occ_db
                self.scene = self._exact_scene
                return
        self.logger.warning(
            "fidelity gate: approximate path %.1f dB vs exact at the loaded weights "
            "(< %.1f dB) — falling back to the exact reference-semantics path for "
            "this session", self.fidelity_db, min_db)
        self.spec = _exact(self.spec)
        self.scene = self._exact_scene

    # -- layer display --------------------------------------------------
    def hide_layer(self, layer_id: int):
        self.display_layers[layer_id] = 0

    def show_layer(self, layer_id: int):
        self.display_layers[layer_id] = 1

    def is_shown_layer(self, layer_id: int) -> bool:
        return self.display_layers[layer_id] == 1

    # -- small setters (ref: layered_neural_renderer.py:643-741) --------
    def set_save_dir(self, dir_name: str):
        self.dir_name = dir_name

    def set_fps(self, fps: int):
        self.fps = fps

    def set_near(self, near: float):
        self.near = float(near)

    def set_frame_duration(self, min_frame: int, max_frame: int, layer_id: int = -1):
        ids = range(self.layer_num + 1) if layer_id == -1 else [layer_id]
        for i in ids:
            self.min_frame[i] = min_frame
            self.max_frame[i] = max_frame

    def set_pose_duration(self, min_camera_id: int, max_camera_id: int):
        self.min_camera_id = min_camera_id
        self.max_camera_id = max_camera_id

    def set_trace_layer(self, layer_id: int):
        self.trace_layer = layer_id

    def invert_poses(self):
        self.poses = list(self.poses)[::-1]
        self.Ks = list(self.Ks)[::-1]

    def get_center_frame_layer(self, frame_id: int, layer_id: int):
        return self.dataset.layer_center(layer_id, frame_id)

    def zoom_in(self, layer_id: int, frame_id: int, scale: float):
        """Pull every gt camera toward a layer's center
        (ref: layered_neural_renderer.py:731-738)."""
        center = self.dataset.layer_center(layer_id, frame_id)
        self.gt_poses = self.gt_poses.copy()
        self.gt_poses[:, :3, 3] = center + (self.gt_poses[:, :3, 3] - center) / scale

    def save_poses(self, path: str):
        np.save(path, np.asarray(self.poses))

    # -- frame scheduling ------------------------------------------------
    def _append_layer_frame_pairs(self, count: int, smooth_time: bool = False):
        for idx in range(count + 1):
            pair = []
            for layer_id in range(self.layer_num + 1):
                if self.is_shown_layer(layer_id):
                    span = self.max_frame[layer_id] - self.min_frame[layer_id]
                    fid = span / count * idx + self.min_frame[layer_id]
                    pair.append((layer_id, fid if smooth_time else int(fid)))
            self.layer_frame_pairs.append(pair)

    def _animate_edit_schedules(self, step_num: int):
        def table(spec):
            a, b = np.asarray(spec[0], float), np.asarray(spec[1], float)
            return [(a + (b - a) * i / max(step_num - 1, 1)).tolist()
                    for i in range(step_num)]

        if self.s_shift is not None:
            self.s_shift_frame = table(self.s_shift)
        if self.s_scale is not None:
            self.s_scale_frame = table(self.s_scale)
        if self.s_alpha is not None:
            self.s_alpha_frame = [float(x) for x in
                                  np.linspace(self.s_alpha[0], self.s_alpha[1], step_num)]

    # -- path authoring (ref: layered_neural_renderer.py:144-361) --------
    def set_smooth_path_poses(self, step_num: int, around: bool = False,
                              smooth_time: bool = False):
        lo, hi = self.min_camera_id, self.max_camera_id + 1
        poses, Ks = smooth_pose_path(self.gt_poses[lo:hi], self.gt_Ks[lo:hi],
                                     step_num, around=around)
        self._animate_edit_schedules(step_num)
        self.poses = list(self.poses) + list(poses)
        self.Ks = list(self.Ks) + list(Ks)
        self._append_layer_frame_pairs(step_num, smooth_time)

    def set_path_gt_poses(self):
        poses = list(self.gt_poses)
        self.poses += poses
        self.Ks += list(self.gt_Ks)
        self._append_layer_frame_pairs(len(poses))

    def set_path_fixed_gt_poses(self, id: int, num: int):
        self._animate_edit_schedules(num)
        self.poses += [self.gt_poses[id]] * num
        self.Ks += [self.gt_Ks[id]] * num
        self._append_layer_frame_pairs(num)

    def set_path_lookat(self, start, end, step_num, center, up):
        if self.trace_layer == -1:
            poses = lookat_path(start, end, step_num, center, up)
        else:
            centers = []
            for idx in range(step_num):
                lo, hi = self.min_frame[self.trace_layer], self.max_frame[self.trace_layer]
                fid = int((hi - lo) / step_num * (idx + 1)) + lo
                centers.append(self.dataset.layer_center(self.trace_layer,
                                                         fid - 1 - self.cfg.DATASETS.FRAME_OFFSET))
            poses = lookat_path_centers(start, end, centers, up)
        self.poses += list(poses)
        self.Ks += [self.gt_Ks[self.min_camera_id]] * len(poses)
        self._append_layer_frame_pairs(len(poses))

    def load_path_poses(self, poses):
        self.poses = list(poses)
        n = len(poses)
        # the reference's end K is gt_Ks[max_camera_id - 1], kept as it is
        K0, K1 = self.gt_Ks[self.min_camera_id], self.gt_Ks[self.max_camera_id - 1]
        self.Ks = [(K1 - K0) * i / max(n - 1, 1) + K0 for i in range(n)]
        self._append_layer_frame_pairs(n)

    def load_cams_from_path(self, path: str):
        campose = np.load(os.path.join(path, "RT_c2w.npy"))
        Ts = np.zeros((campose.shape[0], 4, 4), np.float32)
        Ts[:, :3, :] = campose.reshape(-1, 3, 4)
        Ts[:, 3, 3] = 1.0
        Ts[:, :3, 3] *= self.cfg.DATASETS.SCALE
        self.poses = list(Ts)
        self.Ks = list(np.load(os.path.join(path, "K.npy")).reshape(-1, 3, 3)
                       .astype(np.float32))
        self._append_layer_frame_pairs(len(self.poses))

    def retime_by_key_frames(self, layer_id, key_frames_layer, key_frames):
        """Remap one layer's timeline (ref: layered_neural_renderer.py:495-544)."""
        for i, pairs in enumerate(self.layer_frame_pairs):
            new_pairs = []
            for layer, frame in pairs:
                if layer == layer_id:
                    frame = retime_frames([frame], key_frames_layer, key_frames,
                                          self.min_frame[layer],
                                          self.max_frame[layer])[0]
                new_pairs.append((layer, frame))
            self.layer_frame_pairs[i] = new_pairs

    # -- edit state ------------------------------------------------------
    def _edits(self, frame_idx: int | None, density_threshold: float,
               bkgd_density_threshold: float) -> EditState:
        lp1 = self.layer_num + 1
        e = EditState.identity(self.layer_num, scale_pivot=self.scale_pivot,
                               device=self.device)
        vis = np.array([float(self.display_layers[i]) for i in range(lp1)],
                       np.float32)

        shift = self.shift
        scale = self.scale
        alpha = self.alpha
        if frame_idx is not None:
            if self.s_shift_frame is not None:
                shift = self.s_shift_frame[frame_idx]
            if self.s_scale_frame is not None:
                scale = self.s_scale_frame[frame_idx]
            if self.s_alpha_frame is not None:
                alpha = self.s_alpha_frame[frame_idx]

        shift_arr = np.zeros((lp1, 3), np.float32)
        if shift is not None:
            for i, s in enumerate(shift):
                if s is not None:
                    shift_arr[i] = s
        scale_arr = np.ones(lp1, np.float32)
        if scale is not None:
            scale_arr[:len(list(scale))] = scale
        alpha_arr = np.ones(lp1, np.float32)
        if alpha is not None:
            if np.ndim(alpha) == 0:
                # the reference fades layer 2 only
                # (ref: modeling/layered_rfrender.py:575-576)
                if lp1 > 2:
                    alpha_arr[2] = alpha
            else:
                alpha_arr[:len(list(alpha))] = alpha

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        return e._replace(visible=t(vis), shift=t(shift_arr), scale=t(scale_arr),
                          alpha=t(alpha_arr), near=t(self.near),
                          density_threshold=t(density_threshold),
                          bkgd_density_threshold=t(bkgd_density_threshold))

    # -- rendering -------------------------------------------------------
    def render_pose(self, pose, K, layer_frame_pair, density_threshold=0,
                    bkgd_density_threshold=0, frame_idx=None, timings=None,
                    download_layers=None):
        """Render one pose -> (color (H,W,3), depth (H,W,1),
        color_layer [L+1 x (H,W,3)], depth_layer [L+1 x (H,W,1)])
        (ref: layered_neural_renderer.py:364-392), through
        ``render_pose_host``: rays generated on the device, fields through
        the kernel on a card. Frame ids go to the device as float32, so a
        fractional (smooth-time) frame stays fractional."""
        frame_ids = np.ones(self.layer_num + 1, np.float32)
        for layer_id, frame_id in layer_frame_pair:
            frame_ids[layer_id] = frame_id
        edits = self._edits(frame_idx, density_threshold, bkgd_density_threshold)
        return render_pose_host(
            self.model, self.scene, K, pose, frame_ids, self.dataset.near_far,
            edits, self.height, self.width, chunk=self.cfg.TPU.RENDER_CHUNK,
            tile_cols=self.cfg.TPU.TILE_COLS, far_clip=self.far,
            download_layers=download_layers, spec=self.spec, timings=timings,
            mesh=self.mesh)

    def _video_dir(self, sub: str) -> str:
        parts = [self.output_dir]
        if self.dir_name:
            parts.append(self.dir_name)
        parts += [f"video_{self.save_count}", sub]
        path = os.path.join(*parts)
        os.makedirs(os.path.join(path, "color"), exist_ok=True)
        os.makedirs(os.path.join(path, "depth"), exist_ok=True)
        return path

    def render_path(self, inverse_y_axis=False, density_threshold=0,
                    bkgd_density_threshold=0, auto_save=True):
        """Render every queued pose; save per-frame mixed + per-layer
        color/depth images and the pose/K tables
        (ref: layered_neural_renderer.py:401-488). With a mesh every rank
        renders every pose; rank 0 alone keeps and writes the frames."""
        auto_save = auto_save and self._main
        if self._main:
            save_dir = self._video_dir("mixed")
            with open(os.path.join(save_dir, "poses"), "w") as f:
                for pose in self.poses:
                    f.write(str(pose) + "\n")
            with open(os.path.join(save_dir, "Ks"), "w") as f:
                for K in self.Ks:
                    f.write(str(K) + "\n")

        self.images, self.depths = [], []
        self.images_layer = [[] for _ in range(self.layer_num + 1)]
        self.depths_layer = [[] for _ in range(self.layer_num + 1)]
        self.image_num = 0

        path_t0 = time.perf_counter()
        device_s = download_s = 0.0
        # hidden layers are never saved below — skip their per-layer work
        shown = [l for l in range(self.layer_num + 1)
                 if self.is_shown_layer(l)]
        for idx, pose in enumerate(self.poses):
            if self._main:
                self.logger.info("Rendering image %d", idx)
            timings = {}
            color, depth, color_layer, depth_layer = self.render_pose(
                pose, self.Ks[idx], self.layer_frame_pairs[idx],
                density_threshold, bkgd_density_threshold, frame_idx=idx,
                timings=timings, download_layers=shown)
            device_s += timings["device_s"]
            download_s += timings["download_s"]

            if inverse_y_axis:
                color, depth = color[::-1], depth[::-1]
                color_layer = [c[::-1] for c in color_layer]
                depth_layer = [d[::-1] for d in depth_layer]

            if auto_save:
                write_image(os.path.join(save_dir, "color", f"{self.image_num}.png"), color)
                write_image(os.path.join(save_dir, "depth", f"{self.image_num}.png"), depth)
                self.images.append(color)
                self.depths.append(depth)
                for layer_id in range(self.layer_num + 1):
                    if not self.is_shown_layer(layer_id):
                        continue
                    ldir = self._video_dir(str(layer_id))
                    write_image(os.path.join(ldir, "color", f"{self.image_num}.png"),
                                color_layer[layer_id])
                    write_image(os.path.join(ldir, "depth", f"{self.image_num}.png"),
                                depth_layer[layer_id])
                    self.images_layer[layer_id].append(color_layer[layer_id])
                    self.depths_layer[layer_id].append(depth_layer[layer_id])
            self.image_num += 1
        if self.image_num and self._main:
            elapsed = time.perf_counter() - path_t0
            # device: from the call to the end of the pose on the device (a
            # CUDA sync); download: the copy of the frames to the host; the
            # rest of end-to-end is unscrambling, encoding and writing
            self.logger.info(
                "Rendered %d poses at %dx%d on %s in %.3f s (%.4f s/pose "
                "end-to-end; %.4f s/pose device render, %.4f s/pose image "
                "download)", self.image_num, self.width, self.height, self.device,
                elapsed, elapsed / self.image_num,
                device_s / self.image_num, download_s / self.image_num)

    def render_path_walking(self, inverse_y_axis=False, density_threshold=0,
                            bkgd_density_threshold=0, auto_save=True):
        """Variant with the cross-layer occlusion composite of background and
        layer 2 (ref: layered_neural_renderer.py:550-617)."""
        self.render_path(inverse_y_axis, density_threshold,
                         bkgd_density_threshold, auto_save)
        if not auto_save or self.layer_num < 2 or not self._main:
            return
        out_dir = os.path.join(self.output_dir, "02", "color")
        os.makedirs(out_dir, exist_ok=True)
        for i in range(len(self.images_layer[0])):
            bg = self.images_layer[0][i].copy()
            front = self.images_layer[2][i]
            occl = (self.depths_layer[2][i] < self.depths_layer[0][i]) & (front != 0).any(-1, keepdims=True)
            bg = np.where(occl, front, bg)
            write_image(os.path.join(out_dir, f"{i}.png"), bg)

    def save_video(self):
        """Encode the last path's colour and depth frames as videos (where
        an encoder imports; ``render.video.write_video``); rank 0's alone
        with a mesh."""
        if not self._main:
            return
        if not self.images:
            self.logger.warning("no rendered images; nothing to save")
            return
        parts = [self.output_dir] + ([self.dir_name] if self.dir_name else []) + ["video"]
        video_dir = os.path.join(*parts)
        os.makedirs(video_dir, exist_ok=True)
        write_video(os.path.join(video_dir, f"color_{self.save_count}.mp4"),
                    self.images, fps=self.fps)
        write_video(os.path.join(video_dir, f"depth_{self.save_count}.mp4"),
                    [np.repeat(d, 3, axis=-1) for d in self.depths], fps=self.fps)
        self.save_count += 1

    def check_label(self):
        """Dump label-masked inputs for inspection
        (ref: layered_neural_renderer.py:124-138)."""
        out = os.path.join(self.output_dir, "masked_images")
        for frame in range(self.frame_num):
            fdir = os.path.join(out, f"frame{frame}")
            os.makedirs(fdir, exist_ok=True)
            for cam in range(self.camera_num):
                image, label = self.dataset.get_image_label(cam, frame)
                img = np.moveaxis(image, 0, -1).copy()
                img[label[0] == 0] = 0
                write_image(os.path.join(fdir, f"{cam}.png"), img)
