"""The port's data path and training entry point against the JAX package's
on the CPU: the PNG codec (against PIL), the synthetic scene writer,
``FrameLayerScene``, the training ray pool (``build_ray_pool`` /
``make_train_data``: the same bundle, array for array, from the same seed),
the validation views, the metrics, chunked rendering, validation and
evaluation, and the ``train`` CLI (two epochs, a checkpoint, validation,
``--resume``). A 24x18 scene with 4 cameras and 2 frames; narrow models
(32/16/16 widths, 8+4 samples). Every test runs in a fresh child process
(``isolate``).
"""

import logging
import os
import struct
import zlib

import numpy as np
import pytest
from conftest import _ISOLATED_ENV

pytestmark = pytest.mark.isolate

W, H, CAMS, FRAMES = 24, 18, 4, 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in a test's own child process (every
    port test is ``isolate``: tests/conftest.py). The suite runs six
    workers on the host's cores, and at torch's default of a thread per
    core every small op waits for threads that the other workers keep off
    the cores (a (32, 63) x (63, 1536) product: 26 ms at 8 threads, 0.09 ms
    at one, with one other training process on an 8-core host). The other
    port test files import this fixture."""
    if os.environ.get(_ISOLATED_ENV):
        import torch

        torch.set_num_threads(1)


def _scene_pair(tmp_path):
    """The same synthetic scene written by each package, in its own
    directory (the ray caches live beside the scene)."""
    from stnerf_tpu.data import make_synthetic_scene as jmake
    from stnerf_tpu_torch.data import make_synthetic_scene as tmake

    roots = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmake(roots[0], width=W, height=H, num_cams=CAMS, num_frames=FRAMES, seed=0)
    tmake(roots[1], width=W, height=H, num_cams=CAMS, num_frames=FRAMES, seed=0)
    return roots


def _cfgs(roots, **overrides):
    """synthetic_cfg of each package on its own scene, narrow model."""
    from stnerf_tpu.data import synthetic_cfg as jcfg
    from stnerf_tpu_torch.data import synthetic_cfg as tcfg

    out = []
    for make, root in ((jcfg, roots[0]), (tcfg, roots[1])):
        cfg = make(root, W, H, FRAMES)
        cfg.MODEL.COARSE_RAY_SAMPLING, cfg.MODEL.FINE_RAY_SAMPLING = 8, 4
        cfg.MODEL.BACKBONE_DIM, cfg.MODEL.HEAD_DIM, cfg.MODEL.MOTION_DIM = 32, 16, 16
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.TPU.RENDER_CHUNK = 128
        for k, v in overrides.items():
            node, key = k.split(".")
            cfg[node][key] = v
        out.append(cfg)
    return out


def _specs(cfgs):
    from stnerf_tpu.models import LayeredSpec as JSpec
    from stnerf_tpu_torch.models import LayeredSpec

    return JSpec.from_cfg(cfgs[0]), LayeredSpec.from_cfg(cfgs[1])


def _filtered_png(path, img):
    """An RGB PNG whose rows cycle through all five filters (None, Sub,
    Up, Average, Paeth), encoded by hand."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        ftype = y % 5
        prev = x[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[y, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ftype == 0:
            pred = np.zeros_like(x[y])
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([ftype]) + ((x[y] - pred) % 256).astype(np.uint8).tobytes())

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(
            ">I", zlib.crc32(t + body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_png_codec(tmp_path, rng):
    from PIL import Image

    from stnerf_tpu_torch.data.png import png_size, read_png, write_png

    smooth = np.add.outer(np.arange(17), np.arange(23))[..., None] * np.array([3, 5, 7, 11])
    smooth = (smooth + rng.integers(0, 9, smooth.shape)) % 256
    for shape in ((17, 23), (17, 23, 2), (17, 23, 3), (17, 23, 4)):
        img = (smooth[..., 0] if len(shape) == 2 else smooth[..., :shape[2]]).astype(np.uint8)
        p = str(tmp_path / f"port{len(shape)}_{shape[-1]}.png")
        write_png(p, img)
        np.testing.assert_array_equal(read_png(p), img)             # round trip
        np.testing.assert_array_equal(np.asarray(Image.open(p)), img)  # PIL reads it
        q = str(tmp_path / f"pil{len(shape)}_{shape[-1]}.png")
        Image.fromarray(img).save(q)                                  # adaptive filters
        np.testing.assert_array_equal(read_png(q), np.asarray(Image.open(q)))
        assert png_size(q) == Image.open(q).size
    rgb = smooth[..., :3].astype(np.uint8)
    f = str(tmp_path / "filters.png")
    _filtered_png(f, rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(f)), rgb)
    np.testing.assert_array_equal(read_png(f), rgb)
    jpg = str(tmp_path / "x.jpg")
    Image.fromarray(rgb).save(jpg)
    with pytest.raises(ValueError, match="x.jpg: a JPEG"):
        read_png(jpg)
    deep = str(tmp_path / "deep.png")
    Image.fromarray(smooth[..., 0].astype(np.uint16) * 200).save(deep)
    with pytest.raises(ValueError, match="deep.png"):
        read_png(deep)


def test_synthetic_scene_matches_jax(tmp_path):
    from PIL import Image

    from stnerf_tpu.data import read_ply_points as jread
    from stnerf_tpu_torch.data import read_ply_points

    roots = _scene_pair(tmp_path)
    for rel in ("pose/RT_c2w.txt", "pose/K.txt"):
        a, b = (np.loadtxt(os.path.join(r, rel)) for r in roots)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(read_ply_points(os.path.join(roots[1], "background/0.ply")),
                                  jread(os.path.join(roots[0], "background/0.ply")))
    for frame in range(1, FRAMES + 1):
        for layer in (1, 2):
            rel = f"frame{frame}/pointclouds/{layer}.ply"
            np.testing.assert_array_equal(read_ply_points(os.path.join(roots[1], rel)),
                                          jread(os.path.join(roots[0], rel)))
        for cam in range(CAMS):
            img = [np.asarray(Image.open(os.path.join(r, f"frame{frame}/images/{cam:03d}.png")))
                   for r in roots]
            np.testing.assert_array_equal(img[1], img[0])
            lab = [np.load(os.path.join(r, f"frame{frame}/labels/{cam:03d}.npy")) for r in roots]
            np.testing.assert_array_equal(lab[1], lab[0])
    assert (lab[0] > 0).any()

    # the port's CLI with every flag off its default writes JAX's tree
    from stnerf_tpu.data import make_synthetic_scene as jmake
    from stnerf_tpu_torch.tools import make_synthetic

    cli, ref = str(tmp_path / "cli"), str(tmp_path / "ref")
    make_synthetic.main(["--root", cli, "--width", "20", "--height", "14", "--cams", "3",
                         "--frames", "3", "--layers", "3", "--seed", "5", "--bbox-slack",
                         "0.2", "--blobs", "3", "--blob-spread", "0.4", "--blob-axis", "1",
                         "--label-noise", "0.1"])
    jmake(ref, width=20, height=14, num_cams=3, num_frames=3, layer_num=3, seed=5,
          bbox_slack=0.2, blobs=3, blob_spread=0.4, blob_axis=1, label_noise=0.1)
    files = sorted(os.path.relpath(os.path.join(d, f), ref)
                   for d, _, fs in os.walk(ref) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), cli)
                           for d, _, fs in os.walk(cli) for f in fs)
    assert "frame3/pointclouds/3.ply" in files
    for rel in files:
        a, b = os.path.join(cli, rel), os.path.join(ref, rel)
        if rel.endswith(".png"):
            got, want = np.asarray(Image.open(a)), np.asarray(Image.open(b))
        elif rel.endswith(".npy"):
            got, want = np.load(a), np.load(b)
        elif rel.endswith(".ply"):
            got, want = read_ply_points(a), jread(b)
        else:
            got, want = np.loadtxt(a), np.loadtxt(b)
        np.testing.assert_array_equal(got, want, err_msg=rel)


def test_frame_layer_scene_and_transform_match_jax(tmp_path):
    from stnerf_tpu.data import FrameLayerScene as JScene
    from stnerf_tpu.data import JointTransform as JTransform
    from stnerf_tpu_torch.data import FrameLayerScene, JointTransform

    roots = _scene_pair(tmp_path)
    cfgs = _cfgs(roots)
    jt, tt = JTransform((H, W), is_train=False), JointTransform((H, W), is_train=False)
    for frame in range(1, FRAMES + 1):
        for layer in range(3):
            a = JScene(cfgs[0], jt, frame, layer)
            b = FrameLayerScene(cfgs[1], tt, frame, layer)
            for name in ("bbox", "center", "near", "far", "Ts", "Ks"):
                np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)
            assert b.original_size() == a.original_size() == (W, H)
            for cam in range(CAMS):
                for x, y in zip(b.get_data(cam), a.get_data(cam)):
                    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # the augmenting and the resizing transform (tests/test_torch_train_resume.py
    # holds every augmentation against JAX's PIL warp)
    img = np.asarray(FrameLayerScene(cfgs[1], tt, 1, 1).get_data(0)[0])
    img = (np.moveaxis(img, 0, -1) * 255).round().astype(np.uint8)
    for kw, src in (({"random_range": 2}, img), ({}, np.repeat(img, 2, axis=0))):
        ref = JTransform((H, W), rng=np.random.default_rng(4), **kw)(
            src, np.eye(3), np.eye(4), src[..., 0])
        got = JointTransform((H, W), rng=np.random.default_rng(4), **kw)(
            src, np.eye(3), np.eye(4), src[..., 0])
        for x, y in zip(got, ref):
            np.testing.assert_allclose(x, y, rtol=0, atol=1 / 255 + 1e-6)
        np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("case", ["hit_ordered_capped", "unordered_f32", "workers"])
def test_ray_pool_matches_jax(tmp_path, case):
    """make_train_data (build_ray_pool) of both packages from the same
    seed: the same bundle, array for array, and the same scene boxes."""
    import torch

    from stnerf_tpu.data import build_ray_pool as jbuild
    from stnerf_tpu.data import make_train_data as jmake
    from stnerf_tpu_torch.data import build_ray_pool, make_train_data

    roots = _scene_pair(tmp_path)
    over = {"hit_ordered_capped": {"DATASETS.MAX_POOL_RAYS": 300},
            "unordered_f32": {"TPU.POOL_HIT_ORDER": False},
            "workers": {}}[case]
    cfgs = _cfgs(roots, **over)
    jspec, spec = _specs(cfgs)
    if case == "unordered_f32":
        ref, jboxes = jbuild(cfgs[0], jspec, np.random.default_rng(3), compact=False)
        got, boxes = build_ray_pool(cfgs[1], spec, np.random.default_rng(3), compact=False)
        np.testing.assert_array_equal(boxes, jboxes)
    else:
        # spawned workers draw from per-(frame, layer) seeds, the serial
        # path from the one generator: both packages take the same path
        workers = 2 if case == "workers" else 1
        ref, jscene = jmake(cfgs[0], jspec, np.random.default_rng(3), workers=workers)
        got, scene = make_train_data(cfgs[1], spec, np.random.default_rng(3), workers=workers,
                                     device="cpu")
        for a, b in zip(scene, jscene):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
    n = got["pix" if "pix" in got else "rays"].shape[0]
    if case == "hit_ordered_capped":
        assert n == 300 and int(got["hit_ordered"]) == 1
    assert n > 0


def test_view_and_render_scenes_match_jax(tmp_path):
    from stnerf_tpu.data import RenderScene as JRender
    from stnerf_tpu.data import ViewScene as JView
    from stnerf_tpu_torch.data import RenderScene, ViewScene

    roots = _scene_pair(tmp_path)
    cfgs = _cfgs(roots)
    jv, tv = JView(cfgs[0]), ViewScene(cfgs[1])
    for view, frame in ((0, 0), (3, 1)):
        for a, b in zip(tv.get_fixed_image(view, frame), jv.get_fixed_image(view, frame)):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    assert tv.get_random_image(rng_a)[-2:] == jv.get_random_image(rng_b)[-2:]
    jr, tr = JRender(cfgs[0]), RenderScene(cfgs[1], device="cpu")
    np.testing.assert_array_equal(tr.Ks, jr.Ks)
    for a, b in zip(tr.scene_boxes, jr.scene_boxes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pairs = [(0, 1), (1, 2), (2, 1)]
    for a, b in zip(tr.rays_for_pose(tr.poses[1], tr.Ks[1], pairs),
                    jr.rays_for_pose(jr.poses[1], jr.Ks[1], pairs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_metrics_match_jax(rng):
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.ops import metrics as J
    from stnerf_tpu_torch.ops import metrics as T

    yy, xx = np.mgrid[:30, :40] / 40.0
    gt = np.stack([np.sin(3 * xx), np.cos(2 * yy), xx * yy], -1) * 0.4 + 0.5
    pred = np.clip(gt + rng.normal(0, 0.03, gt.shape), 0, 1)
    pred, gt = pred.astype(np.float32), gt.astype(np.float32)
    for name in ("mae", "psnr", "ssim"):
        a = float(getattr(T, name)(torch.tensor(pred), torch.tensor(gt)))
        b = float(getattr(J, name)(jnp.asarray(pred), jnp.asarray(gt)))
        exact = float(getattr(T, name)(torch.tensor(pred, dtype=torch.float64),
                                       torch.tensor(gt, dtype=torch.float64)))
        np.testing.assert_allclose(a, exact, rtol=1e-5, err_msg=name)
        # SSIM's variance terms cancel: JAX's float32 convolution lands
        # ~2.5e-5 from the float64 value on this image, the port's sums 1e-6
        np.testing.assert_allclose(a, b, rtol=1e-4 if name == "ssim" else 1e-5, err_msg=name)
    assert 0.5 < float(T.ssim(torch.tensor(pred), torch.tensor(gt))) < 1.0
    assert float(T.ssim(torch.tensor(gt), torch.tensor(gt))) == pytest.approx(1.0, abs=1e-6)


def test_render_rays_chunked_matches_jax():
    """A ragged number of rays (100 over chunks of 32), key None."""
    import jax.numpy as jnp
    import torch

    from stnerf_tpu import models as J
    from stnerf_tpu.render.chunked import render_rays_chunked as jchunked
    from stnerf_tpu_torch import models as T
    from stnerf_tpu_torch.render.chunked import render_rays_chunked
    from test_torch_render import _cfg, _models, _psnr, _rays, _scene

    jspec, params, model = _models(_cfg())
    bkgd, boxes, nf = _scene()
    rays = _rays([2.0, 1.5, 2.5], n=100)
    ref = jchunked(params, jspec, J.SceneBoxes(*map(jnp.asarray, (bkgd, boxes, nf))),
                   J.RayInputs(*map(jnp.asarray, rays)), chunk=32)
    out = render_rays_chunked(model, None, T.SceneBoxes(*map(torch.tensor, (bkgd, boxes, nf))),
                              T.RayInputs(*rays), chunk=32)
    assert isinstance(out.fine.color, np.ndarray) and out.fine.color.shape == (100, 3)
    assert out.fine_layers.color.shape == (3, 100, 3) and out.hit.shape == (3, 100)
    np.testing.assert_array_equal(out.hit, ref.hit)
    for name in ("color", "acc"):
        assert _psnr(getattr(out.fine, name), getattr(ref.fine, name)) >= 60.0, name
        assert _psnr(getattr(out.fine_layers, name), getattr(ref.fine_layers, name)) >= 60.0
    assert _psnr(out.fine.depth / 12.0, ref.fine.depth / 12.0) >= 60.0


def test_validation_and_evaluation_match_jax(tmp_path):
    """make_val_fn's PSNR and do_evaluate's MAE/PSNR/SSIM on the synthetic
    scene, the same weights in both packages (the spec's default inference
    approximations stripped, as the JAX package strips them)."""
    import jax

    from stnerf_tpu.data import ViewScene as JView
    from stnerf_tpu.data import make_train_data as jmake
    from stnerf_tpu.engine.evaluate import do_evaluate as jeval
    from stnerf_tpu.engine.evaluate import make_val_fn as jval
    from stnerf_tpu.models import init_layered_params
    from stnerf_tpu_torch.data import ViewScene, make_train_data
    from stnerf_tpu_torch.engine import do_evaluate, make_val_fn
    from stnerf_tpu_torch.models import LayeredModel, load_jax_params

    roots = _scene_pair(tmp_path)
    cfgs = _cfgs(roots)
    jspec, spec = _specs(cfgs)
    assert spec.fast_fine and spec.coarse_exit_segments == 3  # the defaults, held
    params = jax.tree.map(np.array, jax.device_get(
        init_layered_params(jax.random.PRNGKey(0), jspec)))
    for group in ("layers_coarse", "layers_fine"):
        params[group]["density"][0]["b"] = params[group]["density"][0]["b"] + 2.0
    model = load_jax_params(LayeredModel(spec, device="cpu"), params)
    _, jscene = jmake(cfgs[0], jspec, np.random.default_rng(0), workers=1)
    _, scene = make_train_data(cfgs[1], spec, np.random.default_rng(0), workers=1,
                               device="cpu")
    log = logging.getLogger("test_validation")
    psnr_j = jval(cfgs[0], jspec, jscene, JView(cfgs[0]), log)(params, 1)
    psnr_t = make_val_fn(cfgs[1], spec, scene, ViewScene(cfgs[1]), log)(model, 1)
    np.testing.assert_allclose(psnr_t, psnr_j, rtol=1e-4)
    ref = jeval(params, jspec, jscene, JView(cfgs[0]), [0, 2], [0, 1], chunk=100)
    got = do_evaluate(model, spec, scene, ViewScene(cfgs[1]), [0, 2], [0, 1], chunk=100,
                      save_dir=str(tmp_path / "eval"))
    for k in ("mae", "psnr", "ssim"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    assert os.path.exists(tmp_path / "eval" / "v2_f1.png")
    assert os.path.exists(tmp_path / "eval" / "metrics.json")


def test_train_cli_on_cpu_and_resume(tmp_path):
    """``python -m stnerf_tpu_torch.tools.train`` in-process on the CPU with
    the compositor kernels on (their plain versions here): two epochs
    (coarse only, then full) with a checkpoint and a validation PSNR each,
    then ``--resume`` goes on from epoch 2's checkpoint, and from a JAX
    package checkpoint written beside it."""
    import yaml

    from stnerf_tpu_torch.data import make_synthetic_scene
    from stnerf_tpu_torch.tools import train

    root = str(tmp_path / "scene")
    make_synthetic_scene(root, width=W, height=H, num_cams=CAMS, num_frames=FRAMES, seed=0)
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                           "config_synthetic.yml")) as f:
        raw = yaml.safe_load(f)
    raw["DATASETS"].update(TRAIN=root, FRAME_NUM=FRAMES)
    raw["INPUT"].update(SIZE_TRAIN=[W, H], SIZE_LAYER=[W, H], SIZE_TEST=[W, H])
    raw["MODEL"].update(COARSE_RAY_SAMPLING=8, FINE_RAY_SAMPLING=4, BACKBONE_DIM=32,
                        HEAD_DIM=16, MOTION_DIM=16)
    raw["SOLVER"].update(IMS_PER_BATCH=64, MAX_EPOCHS=3, COARSE_STAGE=2, WARMUP_ITERS=1,
                         LOG_PERIOD=4)
    raw["TPU"] = {"COMPOSITOR_KERNEL": True, "COMPUTE_DTYPE": "float32", "RENDER_CHUNK": 128}
    out = str(tmp_path / "out")
    raw["OUTPUT_DIR"] = out
    cfg_file = str(tmp_path / "cfg.yml")
    with open(cfg_file, "w") as f:
        yaml.safe_dump(raw, f)

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("stnerf_tpu_torch.train").addHandler(handler)
    args = ["-c", cfg_file, "--device", "cpu", "--workers", "1", "--model-parallel", "2"]
    history = train.main(args)
    msgs = [r.getMessage() for r in records]
    assert [e for e, _ in history] == [1, 2]
    for _, m in history:
        assert np.isfinite(m.loss).all() and len(m.loss) >= 5
    val = [r.args[3] for r in records if r.msg.startswith("Validation - Epoch")]
    assert len(val) == 2 and np.isfinite(val).all()
    assert any("ignoring model_parallel=2" in m for m in msgs)
    for e in (1, 2):
        assert os.path.exists(os.path.join(out, f"stnerf_torch_checkpoint_{e}.pt"))

    records.clear()
    resumed = train.main(args + ["--resume", "--epochs", "4"])
    assert [e for e, _ in resumed] == [3]
    assert any(m.startswith("resumed") and "checkpoint_2.pt (epoch 2, step 0)" in m
               for m in (r.getMessage() for r in records))
    assert os.path.exists(os.path.join(out, "stnerf_torch_checkpoint_3.pt"))

    # a JAX package checkpoint: its parameters and optax state resume epoch 10
    import jax

    from stnerf_tpu.engine import save_checkpoint
    from stnerf_tpu.engine.solver import make_optimizer as jopt
    from stnerf_tpu_torch.config import get_cfg
    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec, export_jax_params

    cfg = get_cfg()
    cfg.merge_from_file(cfg_file)
    params = export_jax_params(LayeredModel(LayeredSpec.from_cfg(cfg), device="cpu"))
    save_checkpoint(out, params, jax.device_get(jopt(cfg).init(params)), 9)
    records.clear()
    assert [e for e, _ in train.main(args + ["--resume", "--epochs", "11"])] == [10]
    assert any("layered_rfnr_checkpoint_9.ckpt (epoch 9, step 0)" in r.getMessage()
               for r in records)
