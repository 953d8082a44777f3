"""The port's view deformation and pose refinement (``models/camera.py``,
``models/rays.py``, the staged field path of ``models/layered.py`` and its
training) against the JAX package on the CPU, with the same weights through
``load_jax_params`` and inputs from numpy with a seed.

The model: L=2 performers, 16+8 samples, width 32, view deformation and
pose refinement on (2 cameras, a correction that is not the identity),
48 rays. The JAX side runs its own staged kernel path, as
tests/test_kernels.py does: ``_use_trainable_kernel`` patched to True and
K3 (``spacenet_planar_trainable``) in interpret mode at tile 128; the port
runs the plain versions of its K3 kernels. Both use double-angle
encodings, so the two agree to float32 round-off. Every test runs in a
fresh child process (``isolate``).
"""

import numpy as np
import pytest
from test_torch_data import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.isolate

TARGET_DB = 60.0
CAMERAS = 2


def _cfg(deform_view=True):
    from stnerf_tpu.config import get_cfg

    cfg = get_cfg()
    cfg.DATASETS.LAYER_NUM = 2
    cfg.MODEL.COARSE_RAY_SAMPLING = 16
    cfg.MODEL.FINE_RAY_SAMPLING = 8
    cfg.MODEL.SAMPLE_METHOD = "BBOX"
    cfg.MODEL.USE_SPACE_TIME = True
    cfg.MODEL.USE_DEFORM_TIME = True
    cfg.MODEL.DEEP_RGB = False
    cfg.MODEL.USE_DEFORM_VIEW = deform_view
    cfg.MODEL.POSE_REFINEMENT = True
    cfg.MODEL.BACKBONE_DIM = 32
    cfg.MODEL.HEAD_DIM = 16
    cfg.MODEL.MOTION_DIM = 32
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.FAST_FINE = False
    cfg.TPU.EARLY_EXIT_SEGMENTS = 0
    return cfg


def _models(cfg):
    """Same weights in both packages: density biases raised (+0.3
    background, +2 performers) so that every field shows, and a camera
    correction off the identity (a rotation and a translation) so that the
    direction gradients run off axis."""
    import jax

    from stnerf_tpu.models import LayeredSpec as JSpec
    from stnerf_tpu.models import init_layered_params
    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec, load_jax_params

    jspec = JSpec.from_cfg(cfg, camera_num=CAMERAS)
    params = jax.tree.map(np.array, jax.device_get(
        init_layered_params(jax.random.PRNGKey(0), jspec)))
    for group, delta in (("bkgd_coarse", 0.3), ("bkgd_fine", 0.3),
                         ("layers_coarse", 2.0), ("layers_fine", 2.0)):
        params[group]["density"][0]["b"] = params[group]["density"][0]["b"] + delta
    params["cam_pose"]["rvec"] = params["cam_pose"]["rvec"] + np.array(
        [[0.0, 0.02, -0.01, 0.015], [0.01, -0.01, 0.02, 0.0]], np.float32)
    params["cam_pose"]["tvec"] = params["cam_pose"]["tvec"] + np.array(
        [[0.02, -0.01, 0.0], [0.0, 0.03, -0.02]], np.float32)
    spec = LayeredSpec.from_cfg(cfg, camera_num=CAMERAS)
    return jspec, params, load_jax_params(LayeredModel(spec, device="cpu"), params)


def _scene(frames=3):
    boxes = np.zeros((frames, 2, 2, 3), np.float32)
    for f in range(frames):
        boxes[f, 0] = [[-1 + 0.1 * f, -1, 1], [1 + 0.1 * f, 1, 3]]
        boxes[f, 1] = [[-1, 1.5, 1], [1, 3.5, 3]]
    return (np.array([[-6.0, -6.0, -6.0], [6.0, 6.0, 6.0]], np.float32), boxes,
            np.array([0.5, 12.0], np.float32))


def _rays(frame_ids=(2.0, 2.0, 2.0), n=48):
    o = np.tile(np.array([[0.0, 0.0, -5.0]], np.float32), (n, 1))
    d = np.stack([np.linspace(-0.4, 0.4, n), np.linspace(-0.1, 0.5, n),
                  np.ones(n)], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o, d, np.tile(np.asarray(frame_ids, np.float32), (n, 1)),
            (np.arange(n) % CAMERAS).astype(np.float32),
            np.tile([[0.5, 12.0]], (n, 1)).astype(np.float32))


def _jax_staged_path(monkeypatch):
    """The JAX package's staged kernel path on the CPU: K3 in interpret
    mode at tile 128 (tests/test_kernels.py:394-400)."""
    from stnerf_tpu.kernels import spacenet_vjp
    from stnerf_tpu.models import layered as layered_mod

    orig = spacenet_vjp.spacenet_planar_trainable
    monkeypatch.setattr(
        spacenet_vjp, "spacenet_planar_trainable",
        lambda p, s, pe_, de_, te, cd="bfloat16", interpret=False, tile=1024:
        orig(p, s, pe_, de_, te, cd, True, 128))
    monkeypatch.setattr(layered_mod, "_use_trainable_kernel", lambda s: True)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return np.inf if mse == 0 else -10.0 * np.log10(mse)


def _leaves_close(got, ref, rtol, scale_atol):
    """Per leaf: rtol, atol = scale_atol * max |leaf| (tests/test_kernels.py)."""
    import jax

    flat_r, _ = jax.tree_util.tree_flatten_with_path(ref)
    flat_g, gdef = jax.tree.flatten(got)
    assert jax.tree.structure(ref) == gdef
    for (path, b), a in zip(flat_r, flat_g):
        scale = max(1e-3, float(np.max(np.abs(b))))
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=scale_atol * scale, err_msg=jax.tree_util.keystr(path))


def test_camera_transform_matches_jax(rng):
    """Refined rays and their gradients wrt rvec and tvec, on quaternions
    off the identity (and one far from unit length: the soft
    normalisation)."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.models.camera import apply_camera_transform as japply
    from stnerf_tpu_torch.models import CameraTransform, apply_camera_transform

    cams, n = 4, 64
    rvec = (np.tile([0.0, 0.0, 0.0, 1.0], (cams, 1)) + rng.normal(size=(cams, 4)) * 0.2)
    rvec[3] *= 3.0
    tvec = rng.normal(size=(cams, 3)) * 0.1
    o, d = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    ids = rng.integers(0, cams, n).astype(np.float32)
    c_o, c_d = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    f32 = [np.asarray(a, np.float32) for a in (rvec, tvec, o, d, c_o, c_d)]
    rvec, tvec, o, d, c_o, c_d = f32

    def jloss(p):
        ro, rd = japply(p, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ids))
        return jnp.sum(ro * c_o) + jnp.sum(rd * c_d), (ro, rd)

    (_, (ro_j, rd_j)), g_j = jax.device_get(jax.value_and_grad(jloss, has_aux=True)(
        {"rvec": jnp.asarray(rvec), "tvec": jnp.asarray(tvec)}))
    cam = CameraTransform(cams)
    with torch.no_grad():
        cam.rvec.copy_(torch.tensor(rvec))
        cam.tvec.copy_(torch.tensor(tvec))
    ro, rd = apply_camera_transform(cam, torch.tensor(o), torch.tensor(d), torch.tensor(ids))
    ((ro * torch.tensor(c_o)).sum() + (rd * torch.tensor(c_d)).sum()).backward()
    np.testing.assert_allclose(ro.detach().numpy(), ro_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rd.detach().numpy(), rd_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cam.rvec.grad.numpy(), g_j["rvec"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cam.tvec.grad.numpy(), g_j["tvec"], rtol=1e-5, atol=1e-6)
    fresh = CameraTransform(cams)  # the identity at init
    ro0, rd0 = fresh(torch.tensor(o), torch.tensor(d), torch.tensor(ids))
    np.testing.assert_allclose(ro0.detach().numpy(), o)
    np.testing.assert_allclose(rd0.detach().numpy(), d, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_deform_view,use_time", [
    (False, False), (True, False), (False, True), (True, True)])
def test_ray_packing_matches_jax(use_deform_view, use_time):
    """The pose-refinement prefix [o, cam, d, cam], then the view-deform
    camera column and the frame id (tests/test_layered.py:215-244): the
    port's pack_rays equals JAX's, and its unpack_rays reads JAX's packing
    back into the same RayInputs."""
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.models import LayeredSpec as JSpec
    from stnerf_tpu.models import RayInputs as JRays
    from stnerf_tpu.models.rays import pack_rays as jpack
    from stnerf_tpu.models.rays import unpack_rays as junpack
    from stnerf_tpu_torch.models import LayeredSpec, RayInputs
    from stnerf_tpu_torch.models.rays import pack_rays, unpack_rays

    kw = dict(layer_num=2, pose_refinement=True, camera_num=4,
              use_deform_view=use_deform_view, use_deform_time=use_time,
              use_space_time=use_time)
    jspec, spec = JSpec(**kw), LayeredSpec(**kw)
    n = 6
    rng = np.random.default_rng(0)
    arrays = (rng.normal(size=(n, 3)).astype(np.float32),
              rng.normal(size=(n, 3)).astype(np.float32),
              np.tile(rng.integers(1, 4, size=(n, 1)), (1, 3)).astype(np.float32),
              rng.integers(0, 4, size=(n,)).astype(np.float32),
              np.tile([[0.5, 12.0]], (n, 1)).astype(np.float32))
    packed = jpack(JRays(*map(jnp.asarray, arrays)), jspec)
    np.testing.assert_array_equal(pack_rays(RayInputs(*map(torch.tensor, arrays)), spec),
                                  packed)
    assert packed.shape == (n, 8 + int(use_deform_view) + int(use_time))
    ref = junpack(packed, jspec, arrays[4])
    got = unpack_rays(packed, spec, arrays[4])
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):  # one column too many
        unpack_rays(np.concatenate([packed, packed[:, :1]], 1), spec)


def _render_both(monkeypatch, hide=None):
    """-> (JAX's render, the port's) of the same rays; ``hide``: a layer
    the edits hide."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu import models as J
    from stnerf_tpu_torch import models as T

    jspec, params, model = _models(_cfg())
    bkgd, boxes, nf = _scene()
    rays = _rays()
    visible = np.ones(3, np.float32)
    if hide is not None:
        visible[hide] = 0.0
    _jax_staged_path(monkeypatch)
    render = jax.jit(J.render_rays, static_argnames=("spec", "only_coarse", "layer_outputs"))
    j_edits = J.EditState.identity(2)._replace(visible=jnp.asarray(visible))
    ref = jax.device_get(render(params, jspec, J.SceneBoxes(*map(jnp.asarray, (bkgd, boxes, nf))),
                                J.RayInputs(*map(jnp.asarray, rays)), j_edits, key=None))
    t_edits = T.EditState.identity(2)
    t_edits = t_edits._replace(visible=torch.tensor(visible).to(t_edits.visible.dtype))
    out = T.render_rays(model, T.SceneBoxes(*map(torch.tensor, (bkgd, boxes, nf))),
                        T.RayInputs(*map(torch.tensor, rays)), t_edits)
    return ref, out


def test_render_rays_matches_jax(monkeypatch):
    """The slice's render: view deformation and pose refinement, every
    field of both stages through the staged path, against JAX's staged
    kernel path; >= 60 dB, hit masks equal. The staged path launches no
    kernel on the CPU."""
    from stnerf_tpu_torch.kernels import fused_field, spacenet_fwd

    ref, out = _render_both(monkeypatch)
    np.testing.assert_array_equal(out.hit.numpy(), np.asarray(ref.hit))
    assert out.hit[1:].any() and not out.hit[1:].all()  # hits and misses
    assert float(out.fine.acc.min()) > 0.5              # the scene is visible
    assert _psnr(out.fine.color, ref.fine.color) >= TARGET_DB
    assert _psnr(out.fine.acc, ref.fine.acc) >= TARGET_DB
    assert _psnr(out.coarse.color, ref.coarse.color) >= TARGET_DB
    for i in range(3):
        assert _psnr(out.fine_layers.color[i], ref.fine_layers.color[i]) >= TARGET_DB, i
        assert _psnr(out.fine_layers.acc[i], ref.fine_layers.acc[i]) >= TARGET_DB, i
    assert _psnr(out.fine.depth / 12.0, ref.fine.depth / 12.0) >= TARGET_DB
    assert spacenet_fwd.launches == 0 and fused_field.launches == 0


def test_hidden_performer_matches_jax(monkeypatch):
    """A hidden performer on the staged path: the port skips its field (the
    active flag, zeros) where JAX's lax.cond skips it; the images agree at
    >= 60 dB and the hidden layer composites nothing."""
    ref, out = _render_both(monkeypatch, hide=2)
    np.testing.assert_array_equal(out.hit.numpy(), np.asarray(ref.hit))
    assert out.hit[2].any()                  # hit, so only the edit skips it
    assert not out.fine_layers.acc[2].any() and not out.coarse_layers.acc[2].any()
    assert _psnr(out.fine.color, ref.fine.color) >= TARGET_DB
    assert _psnr(out.fine.acc, ref.fine.acc) >= TARGET_DB
    assert _psnr(out.fine_layers.color[1], ref.fine_layers.color[1]) >= TARGET_DB


@pytest.mark.parametrize("only_coarse", [True, False])
def test_train_step_matches_jax(rng, monkeypatch, only_coarse):
    """Loss and every gradient leaf of a training step of the view-deform +
    pose-refinement model, the view_deform and cam_pose leaves included:
    the port's ``_losses`` (staged path, plain K3 forward and backward)
    against ``jax.value_and_grad`` of the JAX ``_losses`` on its staged
    kernel path; rtol 3e-3, atol 3e-3 max|g| (tests/test_kernels.py:407-410)."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu import models as J
    from stnerf_tpu.engine.trainer import TrainBatch as JBatch
    from stnerf_tpu.engine.trainer import _losses as jlosses
    from stnerf_tpu_torch import models as T
    from stnerf_tpu_torch.engine.trainer import TrainBatch, _losses

    jspec, params, model = _models(_cfg())
    scene = _scene()
    rays = _rays()
    rgb = rng.uniform(size=(48, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 48)
    _jax_staged_path(monkeypatch)
    jbatch = JBatch(J.RayInputs(*map(jnp.asarray, rays)), jnp.asarray(rgb), jnp.asarray(labels))

    def jloss(p):
        return jlosses(jspec, J.EditState.identity(2), True, p,
                       J.SceneBoxes(*map(jnp.asarray, scene)), jbatch, None, 1.0, only_coarse)

    (v_j, _), g_j = jax.device_get(jax.jit(jax.value_and_grad(jloss, has_aux=True))(params))
    batch = TrainBatch(T.RayInputs(*map(torch.tensor, rays)), torch.tensor(rgb),
                       torch.tensor(labels))
    v_t, _ = _losses(model, T.EditState.identity(2), True,
                     T.SceneBoxes(*map(torch.tensor, scene)), batch, None, 1.0, only_coarse)
    v_t.backward()
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=2e-5)
    g_t = T.export_jax_params(model, grad=True)
    # the slice's own leaves train
    assert all(np.any(x) for x in jax.tree.leaves(g_t["view_deform"]))
    assert np.any(g_t["cam_pose"]["rvec"]) and np.any(g_t["cam_pose"]["tvec"])
    _leaves_close(g_t, g_j, rtol=3e-3, scale_atol=3e-3)


def test_pose_refinement_on_fused_path_matches_jax(rng, monkeypatch):
    """Pose refinement without view deformation trains through the fused
    field kernels (K1, K2; their plain versions on the CPU): the coarse
    stage's loss and every gradient leaf, cam_pose included, against the
    JAX package's own fused trainable path (``_use_trainable_fused``
    patched to True, ``field_planar_trainable`` in interpret mode), which
    encodes by the same double-angle recursion.

    The coarse stage only: a pose gradient sums every ray of its camera,
    and in the fine stage the deterministic ``sample_pdf`` can place one
    ray's fine samples a bin apart in the two packages
    (tests/test_torch_ops.py), which moves that camera's rotation gradient
    by ~2% (the slice test above covers the full step at its wider bar)."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu import models as J
    from stnerf_tpu.engine.trainer import TrainBatch as JBatch
    from stnerf_tpu.engine.trainer import _losses as jlosses
    from stnerf_tpu_torch import models as T
    from stnerf_tpu_torch.engine.trainer import TrainBatch, _losses

    from stnerf_tpu.kernels import field_vjp
    from stnerf_tpu.models import layered as layered_mod

    orig = field_vjp.field_planar_trainable
    monkeypatch.setattr(field_vjp, "field_planar_trainable",
                        lambda *a: orig(*a[:9], True, *a[10:]))
    monkeypatch.setattr(layered_mod, "_use_trainable_fused", lambda s: True)
    jspec, params, model = _models(_cfg(deform_view=False))
    assert model.view_deform is None
    scene = _scene()
    rays = _rays()
    rgb = rng.uniform(size=(48, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 48)
    jbatch = JBatch(J.RayInputs(*map(jnp.asarray, rays)), jnp.asarray(rgb), jnp.asarray(labels))

    def jloss(p):
        return jlosses(jspec, J.EditState.identity(2), True, p,
                       J.SceneBoxes(*map(jnp.asarray, scene)), jbatch, None, 1.0, True)

    (v_j, _), g_j = jax.device_get(jax.jit(jax.value_and_grad(jloss, has_aux=True))(params))
    batch = TrainBatch(T.RayInputs(*map(torch.tensor, rays)), torch.tensor(rgb),
                       torch.tensor(labels))
    v_t, _ = _losses(model, T.EditState.identity(2), True,
                     T.SceneBoxes(*map(torch.tensor, scene)), batch, None, 1.0, True)
    v_t.backward()
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=2e-5)
    g_t = T.export_jax_params(model, grad=True)
    assert np.any(g_t["cam_pose"]["rvec"]) and np.any(g_t["cam_pose"]["tvec"])
    _leaves_close(g_t, g_j, rtol=2e-3, scale_atol=2e-3)


def test_convert_round_trip_and_frozen_groups():
    """load_jax_params then export_jax_params gives the pytree back, the
    view_deform and cam_pose groups included; a pytree without them is
    refused; both groups can be frozen, as in the JAX solver."""
    import jax

    from stnerf_tpu.engine.solver import make_frozen_mask as jmask
    from stnerf_tpu_torch.engine import make_frozen_mask
    from stnerf_tpu_torch.models import LayeredModel, export_jax_params, load_jax_params

    _, params, model = _models(_cfg())
    back = export_jax_params(model)
    assert set(back) == set(params) and {"view_deform", "cam_pose"} <= set(back)
    flat_r, tdef = jax.tree.flatten(params)
    flat_b, bdef = jax.tree.flatten(back)
    assert tdef == bdef
    assert all(np.array_equal(a, b) for a, b in zip(flat_b, flat_r))
    for group in ("view_deform", "cam_pose"):
        partial = {k: v for k, v in params.items() if k != group}
        with pytest.raises(ValueError):
            load_jax_params(LayeredModel(model.spec, device="cpu"), partial)
    groups = ["cam_pose", "view_deform"]
    assert make_frozen_mask(model, groups) == jmask(params, groups)


def test_default_config_and_camera_count(rng):
    """The port's default config builds a pose-refining model with one
    correction per camera (its two inference approximations, fast fine and
    early exit, held by the spec as the JAX package's holds them; the
    trainer strips them); do_train trains the view-pose model on the CPU,
    refuses a model with fewer pose corrections than the pool has cameras,
    and launches no kernel there."""
    import torch

    from stnerf_tpu_torch.config import get_cfg
    from stnerf_tpu_torch.engine import do_train, make_optimizer, pool_camera_num
    from stnerf_tpu_torch.kernels import spacenet_bwd, spacenet_fwd
    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec, SceneBoxes

    cfg = get_cfg()
    assert cfg.MODEL.POSE_REFINEMENT
    spec = LayeredSpec.from_cfg(cfg, camera_num=8)
    assert spec.fast_fine and spec.coarse_exit_segments == 3
    assert spec.pose_refinement and spec.camera_num == 8
    assert LayeredModel(spec, device="cpu").cam_pose.rvec.shape == (8, 4)

    from tests.test_torch_train import _compact_pool

    cfg = _cfg()
    cfg.SOLVER.IMS_PER_BATCH, cfg.SOLVER.MAX_EPOCHS, cfg.SOLVER.COARSE_STAGE = 100, 3, 2
    cfg.SOLVER.WARMUP_ITERS = 1
    bundle = _compact_pool(rng, cams=4)
    spec = LayeredSpec.from_cfg(cfg)
    assert pool_camera_num(bundle, spec) == 4
    scene = SceneBoxes(*map(torch.tensor, _scene()))
    small = LayeredModel(LayeredSpec.from_cfg(cfg, camera_num=CAMERAS), device="cpu")
    with pytest.raises(ValueError):
        do_train(cfg, small, scene, bundle, device="cpu")
    model = LayeredModel(LayeredSpec.from_cfg(cfg, camera_num=4),
                         torch.Generator().manual_seed(0), device="cpu")
    before = [p.detach().clone() for p in (model.cam_pose.rvec, model.view_deform.net[0].weight)]
    opt, sched = make_optimizer(cfg, model)
    history = do_train(cfg, model, scene, bundle, opt, sched, device="cpu")
    assert [e for e, _ in history] == [1, 2]
    assert all(np.isfinite(m.loss).all() for _, m in history)
    after = (model.cam_pose.rvec, model.view_deform.net[0].weight)
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
    assert spacenet_fwd.launches == 0 and spacenet_bwd.launches == 0
