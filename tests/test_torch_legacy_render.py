"""The port's last modules against the JAX package's on the CPU: the legacy
per-field renderer (``render/neural_renderer.py``) with its textured-mesh
background (``render/bkgd_renderer.py``), the native host library
(``data/native.py``, the port's own copy of the C++ source built into
``build/native/``), and ``utils/{misc,profiling}.py``. Every test runs in a
fresh child process (``isolate``).
"""

import os

import numpy as np
import pytest
from test_torch_data import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.isolate

TARGET_DB = 60.0


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return np.inf if mse == 0 else -10.0 * np.log10(mse)


def _quad(mesh_cls):
    """The JAX package's test quad (tests/test_render.py:47-56): red left,
    blue right, at depth 2."""
    verts = np.array([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]], np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:, :4] = [255, 0, 0]
    tex[:, 4:] = [0, 0, 255]
    return mesh_cls(verts, uvs, faces, tex)


def test_legacy_renderer_native_and_utils_match_jax(tmp_path, caplog):
    """One child process for the file's checks (each child costs ~12 s of
    start-up): ``_native_and_rasterizers_match_jax``, then
    ``NeuralRenderer`` with one background-only field (the JAX test's
    spec, tests/test_render.py:164-189, weights through
    ``load_jax_params``): the field's colour and depth >= 60 dB against
    JAX's with the same empty-space mask; ``render_pose`` over a mesh
    background >= 60 dB; ``mix_image`` bitwise; the path frames on disk.
    Then ``vis_density`` at rtol 1e-4, ``corrupt_cameras`` bitwise, and
    ``profiling`` on the CPU."""
    import jax

    from stnerf_tpu.models import init_layered_params
    from stnerf_tpu.models.layered import LayeredSpec as JSpec
    from stnerf_tpu.render import bkgd_renderer as jbk
    from stnerf_tpu.render.neural_renderer import FieldEntry as JEntry
    from stnerf_tpu.render.neural_renderer import NeuralRenderer as JRenderer
    from stnerf_tpu.utils.misc import corrupt_cameras as jcorrupt
    from stnerf_tpu.utils.misc import vis_density as jvis
    from stnerf_tpu_torch.data.png import read_png
    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec, load_jax_params
    from stnerf_tpu_torch.render import FieldEntry, Mesh, MeshRender, NeuralRenderer
    from stnerf_tpu_torch.utils import (corrupt_cameras, device_memory_stats, phase, trace,
                                        vis_density)

    _native_and_rasterizers_match_jax(tmp_path)

    kw = dict(layer_num=0, coarse_samples=8, fine_samples=4, backbone_dim=16, head_dim=8,
              compute_dtype="float32")
    jspec = JSpec(**kw)
    params = jax.tree.map(np.array, jax.device_get(init_layered_params(jax.random.PRNGKey(1),
                                                                       jspec)))
    for group in ("bkgd_coarse", "bkgd_fine"):   # a visible field
        params[group]["density"][0]["b"] = params[group]["density"][0]["b"] + 1.0
    model = load_jax_params(LayeredModel(LayeredSpec(**kw), device="cpu"), params)
    box = np.array([[-2.0, -2, 1], [2, 2, 5]], np.float32)
    nf = np.array([0.5, 8.0], np.float32)
    K = np.array([[12.0, 0, 8], [0, 12, 8], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.3, 0, -3]

    jr, tr = JRenderer(), NeuralRenderer(output_dir=str(tmp_path))
    jr.add_model(0, 1, JEntry(params=params, spec=jspec, bbox=box, near_far=nf))
    tr.add_model(0, 1, FieldEntry(params=model, spec=model.spec, bbox=box, near_far=nf))
    with pytest.raises(ValueError):
        tr.add_model(0, 2, FieldEntry(LayeredModel(LayeredSpec(**{**kw, "layer_num": 1}),
                                                   device="cpu"), None, box, nf))
    jc, jd = jr.render_frame_layer(0, 1, pose, K, 16, 16, chunk=64)
    tc, td = tr.render_frame_layer(0, 1, pose, K, 16, 16, chunk=64)
    assert tc.shape == (16, 16, 3) and td.shape == (16, 16)
    assert _psnr(tc, jc) >= TARGET_DB
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    assert np.isfinite(td).any() and not np.isfinite(td).all()
    fin = np.isfinite(td)
    assert _psnr(td[fin] / tr.far, jd[fin] / jr.far) >= TARGET_DB

    jr.set_bkgd_mesh(jbk.MeshRender(_quad(jbk.Mesh)))
    tr.set_bkgd_mesh(MeshRender(_quad(Mesh)))
    wide = np.eye(4, dtype=np.float32)
    (jm, jz), (tm, tz) = (r.render_pose(0, wide, K, 16, 16, use_mesh_bkgd=True)
                          for r in (jr, tr))
    assert _psnr(tm, jm) >= TARGET_DB
    np.testing.assert_array_equal(np.isfinite(tz), np.isfinite(jz))
    assert (tm[..., 0] > 0.9).any()        # the quad's red half wins somewhere

    rng = np.random.default_rng(0)
    colors = [rng.uniform(size=(6, 5, 3)).astype(np.float32) for _ in range(3)]
    depths = [rng.uniform(1, 4, size=(6, 5)).astype(np.float32) for _ in range(3)]
    depths[1][0, 0] = np.inf
    for a, b in zip(NeuralRenderer.mix_image(colors, depths),
                    JRenderer.mix_image(colors, depths)):
        np.testing.assert_array_equal(a, b)

    save = str(tmp_path / "path")
    rgbs, _ = tr.render_path_frame_layer(0, 1, [pose, wide], K, 16, 16, save_dir=save)
    for i in range(2):
        img = read_png(os.path.join(save, "color", f"{i}.png"))
        assert img.shape == (16, 16, 3)
        assert np.abs(img / 255.0 - rgbs[i]).max() <= 1 / 255 + 1e-6  # to_uint8 truncates
        assert os.path.exists(os.path.join(save, "depth", f"{i}.png"))

    dens = vis_density(model.bkgd_coarse, box, L=8, chunk=200)
    ref = jvis(params["bkgd_coarse"], jspec.spacenet_spec(bkgd=True), box, L=8, chunk=200)
    assert dens.shape == (8, 8, 8) and (dens > 0).any()
    np.testing.assert_allclose(dens, ref, rtol=1e-4, atol=1e-6)
    poses = np.tile(pose[None], (4, 1, 1))
    np.testing.assert_array_equal(corrupt_cameras(poses, rng=np.random.default_rng(3)),
                                  jcorrupt(poses, rng=np.random.default_rng(3)))

    caplog.set_level("INFO", logger="stnerf_tpu_torch.profile")
    import torch

    with phase("sum", sync_on=torch.ones(3)) as holder:
        torch.ones(64).sum()
    assert holder["seconds"] >= 0 and any("[phase] sum:" in r.getMessage()
                                          for r in caplog.records)
    assert device_memory_stats("cpu") == {}
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(64).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0 and prof.key_averages()


def _native_and_rasterizers_match_jax(tmp_path):
    """The port's native library (its own source, built into
    ``build/native/``) against the JAX package's bitwise: ``ply_read_points``
    (binary and ascii), ``pixel_rays`` (whole image and a roi),
    ``rasterize`` and ``near_far``; the NumPy rasterizer equal to JAX's
    and to the native one (tests/test_render.py:60-98); the OBJ loader
    with a PNG texture equal to JAX's (PIL), a JPEG texture refused."""
    from stnerf_tpu.data import native as jn
    from stnerf_tpu.data.ply import read_ply_points as jread
    from stnerf_tpu.render import bkgd_renderer as jbk
    from stnerf_tpu_torch.data import native as tn
    from stnerf_tpu_torch.data.ply import read_ply_points, write_ply_points
    from stnerf_tpu_torch.data.png import write_png
    from stnerf_tpu_torch.render import bkgd_renderer as tbk

    assert tn.available() and jn.available()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(tn.SOURCE) == os.path.join(root, "stnerf_tpu_torch", "native", "stnerf_host.cpp")
    assert str(tn.LIBRARY) == os.path.join(root, "build", "native", "libstnerf_host.so")

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(57, 3)).astype(np.float32)
    for binary in (True, False):
        path = str(tmp_path / f"p{int(binary)}.ply")
        write_ply_points(path, pts, binary=binary)
        got, ref = tn.ply_read_points(path), jn.ply_read_points(path)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(read_ply_points(path), jread(path))

    K = np.array([[30.0, 0.5, 16], [0, 28, 11], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    c2w[:3, 3] = [0.1, -0.2, -4]
    for roi in (None, (2, 9, 3, 17)):
        np.testing.assert_array_equal(tn.pixel_rays(K, c2w, 22, 32, roi),
                                      jn.pixel_rays(K, c2w, 22, 32, roi))
    w2c = np.stack([np.linalg.inv(c2w), np.eye(4, dtype=np.float32)]).astype(np.float32)
    for a, b in zip(tn.near_far(pts, w2c), jn.near_far(pts, w2c)):
        np.testing.assert_array_equal(a, b)

    Kq = np.array([[40.0, 0, 32], [0, 40, 32], [0, 0, 1]], np.float32)
    eye = np.eye(4, dtype=np.float32)
    tq, jq = _quad(tbk.Mesh), _quad(jbk.Mesh)
    native = tbk.MeshRender(tq).render(Kq, eye, 64, 64)
    for a, b in zip(native, jn.rasterize(jq.verts, jq.uvs, jq.faces, jq.texture, Kq, eye,
                                         64, 64)):
        np.testing.assert_array_equal(a, b)
    numpy_out = tbk._rasterize_numpy(tq, Kq, eye, 64, 64)
    for a, b in zip(numpy_out, jbk._rasterize_numpy(jq, Kq, eye, 64, 64)):
        np.testing.assert_array_equal(a, b)
    (rgb_n, d_n), (rgb_p, d_p) = native, numpy_out
    assert abs(d_n[32, 32] - 2.0) < 1e-3 and d_n[0, 0] == 0.0
    assert rgb_n[32, 20, 0] > 200 and rgb_n[32, 44, 2] > 200
    both = (d_n > 0) & (d_p > 0)   # triangle-boundary pixels may round apart
    assert ((d_n > 0) == (d_p > 0)).mean() > 0.99
    np.testing.assert_allclose(d_n[both], d_p[both], atol=1e-3)
    assert (rgb_n[both] == rgb_p[both]).mean() > 0.999

    tex = np.zeros((4, 6, 4), np.uint8)
    tex[..., 0] = np.arange(6) * 40
    tex[..., 3] = 200
    write_png(str(tmp_path / "tex.png"), tex)
    with open(tmp_path / "quad.mtl", "w") as f:
        f.write("newmtl m\nmap_Kd tex.png\n")
    with open(tmp_path / "quad.obj", "w") as f:
        f.write("mtllib quad.mtl\nv -1 -1 2\nv 1 -1 2\nv 1 1 2\nv -1 1 2\n"
                "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nf 1/1 2/2 3/3 4/4\n")
    got, ref = (m.load_textured_obj(str(tmp_path / "quad.obj")) for m in (tbk, jbk))
    for name in ("verts", "uvs", "faces", "texture"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    (tmp_path / "tex.png").write_bytes(b"\xff\xd8\xff\xe0" + bytes(32))
    with pytest.raises(ValueError, match="JPEG"):
        tbk.load_textured_obj(str(tmp_path / "quad.obj"))
