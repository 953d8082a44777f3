"""The port's sort-free compositor against the JAX package's on the CPU:
the cross-stream kernels' plain versions (K4 ``cross_successor``, K5
``cross_log_transmittance``, forward and backward) against the JAX
kernels in interpret mode, ``composite_merged_nosort`` in both branches,
``render_rays`` and a whole training step with ``nosort_composite`` on, and
the config repair (the inference approximations are held by the spec,
refused by ``render_rays`` and stripped by the trainer). On the CPU the
kernel wrappers run their plain versions. Shapes as
tests/test_torch_render.py. Every test runs in a fresh child process
(``isolate``).
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from test_torch_render import EDITS, TARGET_DB, _psnr, _rays
from test_torch_train import _batch, _cfg, _leaves_close, _models, _scene

pytestmark = pytest.mark.isolate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _streams(rng, L, N=37, S=24):
    """(L, N, S) ascending depths with exact cross-layer ties (copied
    depths, tests/test_ops.py:503-505) and one ray whose streams all park
    at one depth; log factors as a compositor makes them, some saturated
    (log 1e-10); cotangents."""
    t = np.sort(rng.uniform(0.5, 16.0, (L, N, S)), -1).astype(np.float32)
    if L > 1:
        t[1, :5, 3:7] = t[0, :5, 3:7]
        t[-1, :5, 10] = t[0, :5, 10]
    t[:, 7] = 4.0
    alpha = rng.uniform(size=(L, N, S)) ** 4
    logf = np.log(np.maximum(1.0 - alpha + 1e-10, 1e-10)).astype(np.float32)
    logf[0, :3, 4] = np.log(np.float32(1e-10))
    return t, logf, rng.normal(size=(L, N, S)).astype(np.float32)


@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_cross_successor_matches_jax(rng, L):
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.kernels.cross_trans import cross_successor as jsucc
    from stnerf_tpu_torch.kernels import cross_trans as ct

    t, _, _ = _streams(rng, L)
    ref = np.asarray(jsucc(jnp.asarray(t), interpret=True))
    got = ct.cross_successor(torch.tensor(t)).numpy()
    np.testing.assert_array_equal(got, ref)
    if L == 1:
        assert (got == np.float32(3.4e38)).all()
    assert ct.cross_successor.launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("L", [2, 3])
def test_cross_log_transmittance_matches_jax(rng, L):
    """Forward, and the backward through torch.autograd.grad against
    jax.vjp, at rtol 1e-5, atol 1e-6 max|ref|."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.kernels.cross_trans import cross_log_transmittance as jclt
    from stnerf_tpu_torch.kernels import cross_trans as ct

    t, logf, g = _streams(rng, L)
    ref, vjp = jax.vjp(lambda lf: jclt(jnp.asarray(t), lf, 32, True), jnp.asarray(logf))
    (ref_d,) = vjp(jnp.asarray(g))
    x = torch.tensor(logf, requires_grad=True)
    got = ct.cross_log_transmittance(torch.tensor(t), x)
    (got_d,) = torch.autograd.grad(got, x, torch.tensor(g))
    for a, b in ((got.detach(), ref), (got_d, ref_d)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6 * np.abs(b).max())
    assert ct.cross_log_transmittance_fwd.launches == ct.cross_log_transmittance_bwd.launches == 0


def _composite_inputs(rng, L=3, N=37, S=24):
    """tests/test_ops.py:490-535's data: ties and a saturated density."""
    t = np.sort(rng.uniform(0.5, 16, size=(L, N, S)).astype(np.float32), -1)
    t[1, :5, 3:7] = t[0, :5, 3:7]
    t[2, :5, 10] = t[0, :5, 10]
    sig = rng.normal(size=(L, N, S)).astype(np.float32)
    sig[0, :3, 4] = 1e6
    rgb = rng.normal(size=(L, 3, N, S)).astype(np.float32)
    return t, rgb, sig


@pytest.mark.parametrize("kernel", [False, True])
def test_composite_merged_nosort_matches_jax(kernel):
    """Values and rgb/sigma gradients of both branches against JAX's
    (its kernel branch in interpret mode), at tests/test_ops.py's bars."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.ops.volume import composite_merged_nosort as jcomp
    from stnerf_tpu_torch.ops.volume import composite_merged_nosort as tcomp

    t, rgb, sig = _composite_inputs(np.random.default_rng(7))

    def jloss(r, s):
        out = jcomp(jnp.asarray(t), r, s, 1e10, kernel=kernel, interpret=True)
        return (jnp.sum(out.color ** 2) + jnp.sum(out.acc) + jnp.sum(out.depth)
                + jnp.sum(out.weights ** 2)), out

    (_, ref), (gr_j, gs_j) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(rgb), jnp.asarray(sig))
    r, s = torch.tensor(rgb, requires_grad=True), torch.tensor(sig, requires_grad=True)
    out = tcomp(torch.tensor(t), r, s, 1e10, kernel=kernel)
    loss = (out.color ** 2).sum() + out.acc.sum() + out.depth.sum() + (out.weights ** 2).sum()
    loss.backward()
    for name in ("color", "depth", "acc", "weights"):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert np.isfinite(s.grad.numpy()).all()
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gr_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs_j), rtol=1e-4, atol=1e-5)


def test_nosort_matches_sorted_merge(rng):
    """Without ties, the sort-free compositor equals the sorted merge
    (``volume_render_planar(*merge_layers_planar(...))``) in values and
    gradients: the finite sentinel only differs where 0 < sigma < ~1e-8."""
    import torch

    from stnerf_tpu_torch.ops.volume import (composite_merged_nosort, merge_layers_planar,
                                             volume_render_planar)

    L, N, S = 3, 40, 16
    u = rng.uniform(0.05, 0.95, (L, N, S))
    t = torch.tensor(0.5 + 15.5 * (np.arange(S) + (np.arange(L)[:, None, None] + u) / L) / S,
                     dtype=torch.float32)
    rgb0 = rng.normal(size=(L, 3, N, S)).astype(np.float32)
    sig0 = rng.normal(0.3, 1.0, (L, N, S)).astype(np.float32)

    def run(fn):
        r, s = torch.tensor(rgb0, requires_grad=True), torch.tensor(sig0, requires_grad=True)
        out = fn(r, s)
        ((out.color ** 2).sum() + out.acc.sum() + out.depth.sum()).backward()
        return out, r.grad, s.grad

    a = run(lambda r, s: composite_merged_nosort(t, r, s, kernel=True))
    b = run(lambda r, s: volume_render_planar(*merge_layers_planar(t, r, s)))
    for x, y in zip((a[0].color, a[0].depth, a[0].acc, a[1], a[2]),
                    (b[0].color, b[0].depth, b[0].acc, b[1], b[2])):
        y = y.detach().numpy()
        np.testing.assert_allclose(x.detach().numpy(), y, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(y).max()))


@pytest.mark.parametrize("case", ["plain", "shift_scale", "hide"])
def test_render_rays_nosort_matches_jax(case):
    """render_rays with the sort-free compositor (the kernels' plain
    versions on the CPU) against JAX's render_rays with
    ``nosort_composite`` (its cube form off a TPU): >= 60 dB, hit masks
    equal."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu import models as J
    from stnerf_tpu_torch import models as T

    jspec, params, model = _models(_cfg())
    jspec = dataclasses.replace(jspec, nosort_composite=True)
    spec = dataclasses.replace(model.spec, nosort_composite=True, compositor_kernel=True)
    frame_ids, edit = EDITS[case]
    bkgd, boxes, nf = _scene()
    rays = _rays(frame_ids)
    jed = J.EditState.identity(2)._replace(
        scale_pivot=J.compute_scale_pivot(jnp.asarray(bkgd), jnp.asarray(boxes[0])),
        **{k: jnp.asarray(v, jnp.float32) for k, v in edit.items()})
    ted = T.EditState.identity(
        2, T.compute_scale_pivot(torch.tensor(bkgd), torch.tensor(boxes[0])))._replace(
        **{k: torch.tensor(v, dtype=torch.float32) for k, v in edit.items()})
    render = jax.jit(J.render_rays, static_argnames=("spec", "only_coarse", "layer_outputs"))
    ref = jax.device_get(render(params, jspec, J.SceneBoxes(*map(jnp.asarray, (bkgd, boxes, nf))),
                                J.RayInputs(*map(jnp.asarray, rays)), jed, key=None))
    out = T.render_rays(model, T.SceneBoxes(*map(torch.tensor, (bkgd, boxes, nf))),
                        T.RayInputs(*map(torch.tensor, rays)), ted, spec=spec)
    np.testing.assert_array_equal(out.hit.numpy(), np.asarray(ref.hit))
    assert float(out.fine.acc.min()) > 0.5
    for name in ("color", "acc"):
        assert _psnr(getattr(out.fine, name), getattr(ref.fine, name)) >= TARGET_DB, name
        assert _psnr(getattr(out.coarse, name), getattr(ref.coarse, name)) >= TARGET_DB, name
    assert _psnr(out.fine.depth / 12.0, ref.fine.depth / 12.0) >= TARGET_DB


@pytest.mark.parametrize("only_coarse", [True, False])
def test_train_step_nosort_matches_jax(rng, only_coarse):
    """A training step of the port with TPU.COMPOSITOR_KERNEL on (the
    trainer's spec composites sort-free; the kernels' plain versions on the
    CPU) against jax.value_and_grad of JAX's ``_losses`` with
    ``nosort_composite``: the loss, and every gradient leaf at rtol 2e-3,
    atol 2e-3 max|g| (tests/test_torch_train.py's bar)."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu import models as J
    from stnerf_tpu.engine.trainer import TrainBatch as JBatch
    from stnerf_tpu.engine.trainer import _losses as jlosses
    from stnerf_tpu_torch import models as T
    from stnerf_tpu_torch.engine.trainer import TrainBatch, _losses, training_spec

    cfg = _cfg()
    cfg.TPU.COMPOSITOR_KERNEL = True
    jspec, params, model = _models(cfg)
    jspec = dataclasses.replace(jspec, nosort_composite=True)
    spec = training_spec(model.spec)
    assert spec.nosort_composite and spec.compositor_kernel
    scene = _scene()
    rays, rgb, labels = _batch(rng)
    jbatch = JBatch(J.RayInputs(*map(jnp.asarray, rays)), jnp.asarray(rgb), jnp.asarray(labels))

    def jloss(p):
        return jlosses(jspec, J.EditState.identity(2), True, p,
                       J.SceneBoxes(*map(jnp.asarray, scene)), jbatch, None, 1.0, only_coarse)

    (v_j, _), g_j = jax.device_get(jax.jit(jax.value_and_grad(jloss, has_aux=True))(params))
    batch = TrainBatch(T.RayInputs(*map(torch.tensor, rays)), torch.tensor(rgb),
                       torch.tensor(labels))
    v_t, _ = _losses(model, T.EditState.identity(2), True,
                     T.SceneBoxes(*map(torch.tensor, scene)), batch, None, 1.0, only_coarse,
                     spec=spec)
    v_t.backward()
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=2e-5)
    _leaves_close(T.export_jax_params(model, grad=True), g_j)


def test_every_config_builds_and_the_trainer_strips_approximations():
    """The config repair: LayeredSpec.from_cfg builds for the default
    config and every configs/*.yml (FAST_FINE and EARLY_EXIT_SEGMENTS held
    as the JAX package's spec holds them), render_rays renders them but
    refuses FAST_FINE with the sort-free compositor (the unported
    FAST_FINE_TRAIN path), and the trainer's spec strips them and
    composites sort-free exactly when the compositor kernels are on."""
    import torch

    from stnerf_tpu_torch import models as T
    from stnerf_tpu_torch.config import get_cfg
    from stnerf_tpu_torch.engine import training_spec

    default = T.LayeredSpec.from_cfg(get_cfg())
    assert default.fast_fine and default.coarse_exit_segments == 3
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml"))):
        cfg = get_cfg()
        cfg.merge_from_file(path)
        spec = T.LayeredSpec.from_cfg(cfg)
        train = training_spec(spec)
        assert not train.fast_fine and train.coarse_exit_segments == 0, path
        assert train.nosort_composite == spec.compositor_kernel, path

    cfg = _cfg()
    cfg.TPU.FAST_FINE = True
    cfg.TPU.EARLY_EXIT_SEGMENTS = 3
    cfg.TPU.COMPOSITOR_KERNEL = True
    _, _, model = _models(_cfg())
    model.spec = T.LayeredSpec.from_cfg(cfg)
    scene = T.SceneBoxes(*map(torch.tensor, _scene()))
    inputs = T.RayInputs(*map(torch.tensor, _rays([2.0] * 3)))
    assert torch.isfinite(T.render_rays(model, scene, inputs,
                                        T.EditState.identity(2)).fine.color).all()
    with pytest.raises(NotImplementedError, match="FAST_FINE"):
        T.render_rays(model, scene, inputs, T.EditState.identity(2),
                      spec=dataclasses.replace(model.spec, nosort_composite=True))
    spec = training_spec(model.spec)
    assert spec.nosort_composite and not spec.fast_fine and spec.coarse_exit_segments == 0
    out = T.render_rays(model, scene, inputs, T.EditState.identity(2), spec=spec)
    assert torch.isfinite(out.fine.color).all()
    with pytest.raises(ValueError, match="may differ"):  # widths are the model's
        T.render_rays(model, scene, inputs, T.EditState.identity(2),
                      spec=dataclasses.replace(spec, head_dim=8))


def test_kernel_wrappers_check_inputs():
    import torch

    from stnerf_tpu_torch.kernels import cross_trans as ct

    t = torch.rand(2, 5, 4)
    with pytest.raises(TypeError):
        ct.cross_successor(t.double())
    with pytest.raises(ValueError):
        ct.cross_successor(t.transpose(1, 2))
    with pytest.raises(ValueError):
        ct.cross_log_transmittance_fwd(t, torch.rand(2, 5, 3))
    with pytest.raises(ValueError):
        ct.cross_log_transmittance_bwd(t[0], t[0])
