"""The port's render front end against the JAX package's on the CPU:
``LayeredNeuralRenderer`` (camera paths, layer/frame schedules, edits,
``render_path``'s directory tree), the video writer without an encoder, and
the three demos. Both renderers load the same JAX ``.ckpt`` (float32, the
JAX side without Pallas, the inference approximations off). A 24x18 scene
with 4 cameras and 2 frames; narrow models (32/16/16 widths, 8+4 samples).
Every test runs in a fresh child process (``isolate``).
"""

import logging
import os
import shutil
import sys

import numpy as np
import pytest

from test_torch_data import CAMS, H, W, _cfgs, _scene_pair

pytestmark = pytest.mark.isolate

_APPROX_OFF = {"FAST_FINE": False, "EARLY_EXIT_SEGMENTS": 0, "FIDELITY_GATE": False,
               "OCCUPANCY_SKIP": False}
# the approximations on at eps 0, occupancy at a manual tau of 0 (every box
# comes back as it was) on an 8^3 lattice, a 16-pixel gate probe
_APPROX_ON = {"FAST_FINE": True, "EARLY_EXIT_SEGMENTS": 3, "FIDELITY_GATE": True,
              "OCCUPANCY_SKIP": True, "FAST_FINE_EPS": 0.0, "EARLY_EXIT_EPS": 0.0,
              "OCC_AUTO_TAU": False, "OCC_SIGMA_THRESH": 0.0, "OCC_GRID": 8,
              "FIDELITY_PROBE_RES": 16}
# the edit cases: (name, renderer kwargs, path options, hidden layer)
_CASES = [
    ("plain", {}, {}, None),
    ("hide", {}, {}, 1),
    ("shift", {"shift": [[0, 0, 0], [0, 0.4, 0], [0, -0.4, 0]]}, {}, None),
    ("scale", {"scale": [1, 0.75, 1.5]}, {}, None),
    ("alpha", {"s_alpha": [1.0, 0.2]}, {}, None),
    ("smooth_time", {}, {"smooth_time": True}, None),
]


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def _setup(tmp_path):
    """The scene pair, each package's config on its own scene with its own
    OUTPUT_DIR, and one JAX ``.ckpt`` (density biases raised, as
    chip_smoke.py raises them, so that the scene is not empty; a real
    ``make_optimizer(cfg).init`` state) in both output directories."""
    import jax

    from stnerf_tpu.engine.checkpoint import save_checkpoint
    from stnerf_tpu.engine.solver import make_optimizer
    from stnerf_tpu.models import LayeredSpec as JSpec, init_layered_params

    roots = _scene_pair(tmp_path)
    cfgs = _cfgs(roots)
    for cfg, name in zip(cfgs, ("jax", "torch")):
        cfg.OUTPUT_DIR = str(tmp_path / f"out_{name}")
        cfg.TPU.USE_PALLAS = False
        cfg.TPU.TILE_COLS = 8
        for k, v in _APPROX_OFF.items():
            cfg.TPU[k] = v
    params = jax.tree.map(np.asarray, init_layered_params(
        jax.random.PRNGKey(0), JSpec.from_cfg(cfgs[0], camera_num=CAMS)))
    for group in ("bkgd_coarse", "bkgd_fine", "layers_coarse", "layers_fine"):
        params[group]["density"][0]["b"] = params[group]["density"][0]["b"] + (
            0.02 if group.startswith("bkgd") else 2.0)
    path = save_checkpoint(cfgs[0].OUTPUT_DIR, params,
                           make_optimizer(cfgs[0]).init(params), epoch=1)
    os.makedirs(cfgs[1].OUTPUT_DIR)
    shutil.copy(path, cfgs[1].OUTPUT_DIR)
    return cfgs


def _author(r, hidden, smooth_time=False):
    """A 3-pose smooth path, layer 1 retimed, ``hidden`` hidden."""
    if hidden is not None:
        r.hide_layer(hidden)
    r.set_smooth_path_poses(3, around=False, smooth_time=smooth_time)
    if not smooth_time:
        r.retime_by_key_frames(1, [2], [1])


def _frames(r, lp1):
    """Every pose of the path, all layers computed -> list of 2(L+1)+2
    images per pose (mixed colour, depth, then per layer)."""
    out = []
    for idx, pose in enumerate(r.poses):
        c, d, cl, dl = r.render_pose(pose, r.Ks[idx], r.layer_frame_pairs[idx],
                                     frame_idx=idx, download_layers=list(range(lp1)))
        out.append([c, d, *cl, *dl])
    return out


def test_renderer_matches_jax(tmp_path, caplog):
    """Six edit cases through one JAX render program (the edits are data):
    the same poses, Ks and layer/frame schedules, every image >= 60 dB.
    Then both renderers with the config's approximations on (eps 0,
    occupancy at tau 0): each refines its boxes (to themselves), runs the
    gate and keeps the approximate path, the port logs no "not ported",
    and the two render the same images >= 60 dB, which are the exact
    path's too (fine nets equal to coarse nets make the fast fine stage
    exact)."""
    from stnerf_tpu.render import LayeredNeuralRenderer as JRenderer
    from stnerf_tpu_torch.render import LayeredNeuralRenderer

    jcfg, tcfg = _setup(tmp_path)
    lp1 = tcfg.DATASETS.LAYER_NUM + 1
    for name, kwargs, opts, hidden in _CASES:
        jr = JRenderer(jcfg, **kwargs)
        tr = LayeredNeuralRenderer(tcfg, device="cpu", **kwargs)
        assert tr._ckpt_path.endswith("layered_rfnr_checkpoint_1.ckpt")
        assert tr.fidelity_db is None and jr.fidelity_db is None
        for r in (jr, tr):
            _author(r, hidden, **opts)
        np.testing.assert_array_equal(np.stack(tr.poses), np.stack(jr.poses))
        np.testing.assert_array_equal(np.stack(tr.Ks), np.stack(jr.Ks))
        assert tr.layer_frame_pairs == jr.layer_frame_pairs, name
        if name == "smooth_time":
            assert any(f % 1 for pairs in tr.layer_frame_pairs for _, f in pairs)
        got, ref = _frames(tr, lp1), _frames(jr, lp1)
        for idx, (g, e) in enumerate(zip(got, ref)):
            for k, (a, b) in enumerate(zip(g, e)):
                assert a.shape == b.shape and a.dtype == np.float32
                db = _psnr(a, b)
                assert db >= 60.0, f"{name} pose {idx} image {k}: {db:.1f} dB"
        if hidden is not None:
            for g in got:
                assert not g[2 + hidden].any() and not g[2 + lp1 + hidden].any()
        if name == "plain":
            plain_frames = got
        else:
            assert any(not np.array_equal(g[0], p[0])
                       for g, p in zip(got, plain_frames)), f"{name}: no edit shows"

    # the other path authors (host NumPy): the same poses, Ks and schedules
    jr, tr = JRenderer(jcfg), LayeredNeuralRenderer(tcfg, device="cpu")
    for r in (jr, tr):
        r.set_path_gt_poses()
        r.set_path_fixed_gt_poses(1, 2)
        r.set_trace_layer(1)
        r.set_path_lookat([0, 0, -5], [1, 0, -5], 3, [0, 0, 0], [0, 1, 0])
        r.zoom_in(1, 0, 1.5)
        r.set_frame_duration(1, 2, layer_id=2)
        r.set_smooth_path_poses(4, around=True, smooth_time=True)
        r.invert_poses()
    np.testing.assert_array_equal(np.stack(tr.poses), np.stack(jr.poses))
    np.testing.assert_array_equal(np.stack(tr.Ks), np.stack(jr.Ks))
    np.testing.assert_array_equal(tr.gt_poses, jr.gt_poses)
    assert tr.layer_frame_pairs == jr.layer_frame_pairs
    for r in (jr, tr):
        r.set_pose_duration(1, 3)
        r.load_path_poses(np.stack(jr.poses[:3]))
    np.testing.assert_array_equal(np.stack(tr.Ks), np.stack(jr.Ks))

    ons = [cfg.clone() for cfg in (jcfg, tcfg)]
    for on in ons:
        for k, v in _APPROX_ON.items():
            on.TPU[k] = v
    caplog.clear()
    with caplog.at_level(logging.INFO):
        jr, tr = JRenderer(ons[0]), LayeredNeuralRenderer(ons[1], device="cpu")
    assert not any("not ported" in r.getMessage() for r in caplog.records)
    for r in (jr, tr):
        assert r.fidelity_db is not None and r.fidelity_db >= 40.0, r.fidelity_db
        assert r.spec.fast_fine and r.spec.coarse_exit_segments == 3
        assert r.scene is not r._exact_scene
        np.testing.assert_array_equal(np.asarray(r.scene.boxes),
                                      np.asarray(r._exact_scene.boxes))
        _author(r, None)
    for g, e, p in zip(_frames(tr, lp1), _frames(jr, lp1), plain_frames):
        for k, (a, b, c) in enumerate(zip(g, e, p)):
            for ref, what in ((b, "JAX"), (c, "the exact path")):
                db = _psnr(a, ref)
                assert db >= 60.0, f"approximate path image {k} vs {what}: {db:.1f} dB"


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_render_path_tree_and_frames(tmp_path, monkeypatch):
    """``render_path`` and ``render_path_walking`` write the JAX renderer's
    tree, with ``.png`` for ``.jpg``; every frame decodes to the image that
    was rendered (the depth bytes are the JAX writer's ``to_uint8``); the
    ``poses``/``Ks`` tables are the JAX ones; ``check_label`` and
    ``load_cams_from_path`` match the JAX renderer's; ``save_video`` with
    imageio and cv2 unimportable keeps the frames and writes nothing."""
    from stnerf_tpu.render import LayeredNeuralRenderer as JRenderer
    from stnerf_tpu.render.video import to_uint8 as jto_uint8
    from stnerf_tpu_torch.data.png import read_png
    from stnerf_tpu_torch.render import LayeredNeuralRenderer, to_uint8, write_video

    jcfg, tcfg = _setup(tmp_path)
    rs = [JRenderer(jcfg), LayeredNeuralRenderer(tcfg, device="cpu")]
    for r in rs:
        r.set_save_dir("walk")
        _author(r, None)
        r.render_path_walking(False, 0, 0, auto_save=True)
    jr, tr = rs
    jtree, ttree = _tree(jr.output_dir), _tree(tr.output_dir)
    assert ttree == [p[:-4] + ".png" if p.endswith(".jpg") else p for p in jtree]
    assert any(p.startswith(os.path.join("02", "color")) for p in ttree)
    mixed = os.path.join("walk", "video_0", "mixed")
    for table in ("poses", "Ks"):
        with open(os.path.join(jr.output_dir, mixed, table)) as f, \
                open(os.path.join(tr.output_dir, mixed, table)) as g:
            assert f.read() == g.read()

    lp1 = tcfg.DATASETS.LAYER_NUM + 1
    for i in range(tr.image_num):
        for sub, color, depth in [("mixed", tr.images[i], tr.depths[i])] + [
                (str(l), tr.images_layer[l][i], tr.depths_layer[l][i]) for l in range(lp1)]:
            d = os.path.join(tr.output_dir, "walk", "video_0", sub)
            np.testing.assert_array_equal(read_png(os.path.join(d, "color", f"{i}.png")),
                                          to_uint8(color))
            got = read_png(os.path.join(d, "depth", f"{i}.png"))
            np.testing.assert_array_equal(got, to_uint8(depth)[..., 0])
            np.testing.assert_array_equal(got, jto_uint8(depth)[..., 0])
            assert got.shape == (H, W)
    assert (to_uint8(np.array([-1.0, 0.5, 2.0], np.float32))
            == jto_uint8(np.array([-1.0, 0.5, 2.0], np.float32))).all()

    # check_label's tree and pixels; load_cams_from_path's poses and Ks
    for r in rs:
        r.check_label()
    jm, tm = (_tree(os.path.join(r.output_dir, "masked_images")) for r in rs)
    assert tm == [p[:-4] + ".png" for p in jm] and len(tm) == CAMS * tcfg.DATASETS.FRAME_NUM
    image, label = jr.dataset.get_image_label(1, 0)
    want = np.moveaxis(image, 0, -1).copy()
    want[label[0] == 0] = 0
    np.testing.assert_array_equal(
        read_png(os.path.join(tr.output_dir, "masked_images", "frame0", "1.png")),
        jto_uint8(want))
    cams = tmp_path / "cams"
    cams.mkdir()
    np.save(cams / "RT_c2w.npy", np.asarray(jr.gt_poses)[:, :3, :4])
    np.save(cams / "K.npy", np.asarray(jr.gt_Ks))
    for r in rs:
        r.load_cams_from_path(str(cams))
    np.testing.assert_array_equal(np.stack(tr.poses), np.stack(jr.poses))
    np.testing.assert_array_equal(np.stack(tr.Ks), np.stack(jr.Ks))
    assert tr.layer_frame_pairs == jr.layer_frame_pairs

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    before = _tree(tr.output_dir)
    tr.save_video()
    assert tr.save_count == 1
    assert _tree(tr.output_dir) == before
    assert write_video(str(tmp_path / "v.mp4"), tr.images) is None


def test_demos_run_on_cpu(tmp_path, monkeypatch):
    """Each demo's ``main`` runs in-process on the CPU with a two-pose path
    and writes its frame tree; a demo on a machine without CUDA raises
    unless it is given ``--device cpu``."""
    import torch

    from stnerf_tpu_torch.demo import taekwondo_demo, taekwondo_scale_only, walking_demo

    _, tcfg = _setup(tmp_path)
    cfg_file = str(tmp_path / "scene.yml")
    with open(cfg_file, "w") as f:
        f.write(tcfg.dump())
    monkeypatch.setenv("STNERF_DEMO_POSES", "2")
    out = os.path.join(tcfg.OUTPUT_DIR, "rendered")
    # (save dir, video index): the walking demo's one renderer counts its
    # saved videos up, the taekwondo demos build a renderer per run
    for demo, runs in ((taekwondo_demo, [("origin", 0), ("shift", 0), ("scale", 0)]),
                       (taekwondo_scale_only, [("scale", 0)]),
                       (walking_demo, [("origin", 0), ("hide_man_1", 1),
                                       ("hide_both", 2)])):
        shutil.rmtree(out, ignore_errors=True)
        demo.main(["-c", cfg_file, "--device", "cpu"])
        assert sorted(os.listdir(out)) == sorted(d for d, _ in runs), demo.__name__
        for d, k in runs:
            colors = os.listdir(os.path.join(out, d, f"video_{k}", "mixed", "color"))
            assert sorted(colors) == ["0.png", "1.png"], (demo.__name__, d)
    assert sorted(os.listdir(os.path.join(out, "hide_both", "video_2"))) == ["0", "mixed"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            walking_demo.main(["-c", cfg_file])
