"""The port of the trainable fused field (``stnerf_tpu_torch.kernels.
field_vjp``) against the JAX package's ``field_planar_trainable``, run as
tests/test_kernels.py runs it on the CPU (interpret mode, float32).

On the CPU the port's backward wrapper runs its plain version,
``field_bwd_reference``; the CUDA kernel itself is checked against that
plain version on the card by ``chip_smoke.py``. Weights reach both packages
from the same JAX pytree. Every test runs in a fresh child process
(``isolate``).
"""

import dataclasses

import numpy as np
import pytest
from test_torch_data import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.isolate

M = 200          # samples: not a multiple of either package's tile
JAX_TILE = 128
W, HEAD, MOTION_W = 32, 16, 16


def _nets(mode, use_time, deep):
    """-> (jax SpaceNet spec, params, MotionNet params or None; the port's
    SpaceNet and MotionNet with the same weights)."""
    import jax

    from stnerf_tpu.models.motionnet import MotionNetSpec as JMSpec
    from stnerf_tpu.models.motionnet import init_motionnet
    from stnerf_tpu.models.spacenet import SpaceNetSpec as JSSpec
    from stnerf_tpu.models.spacenet import init_spacenet
    from stnerf_tpu_torch.models import (MotionNet, MotionNetSpec, SpaceNet,
                                         SpaceNetSpec, load_linears, load_spacenet)

    kw = dict(use_dir=True, use_time=use_time, deep_rgb=deep, backbone_dim=W,
              head_dim=HEAD)
    jsspec = JSSpec(**kw)
    sparams = jax.device_get(init_spacenet(jax.random.PRNGKey(3), jsspec))
    net = load_spacenet(SpaceNet(SpaceNetSpec(**kw)), sparams)
    mparams, mnet = None, None
    if mode:
        mkw = dict(width=MOTION_W, input_time=mode == "lerp")
        mparams = jax.device_get(init_motionnet(jax.random.PRNGKey(4), JMSpec(**mkw)))
        mnet = MotionNet(MotionNetSpec(**mkw))
        load_linears(mnet.net, mparams["net"])
    return jsspec, sparams, mparams, net, mnet


def _inputs(rng, mode, m=M):
    from stnerf_tpu.ops.encoding import positional_encoding_planar as jpe

    xyz = rng.normal(size=(3, m)).astype(np.float32)
    ids = rng.integers(1, 4, size=(1, m)).astype(np.float32)
    if mode == "lerp":
        ids += 0.3  # fractional retiming ids
    dir_enc = np.asarray(jpe(rng.normal(size=(3, m)).astype(np.float32), 4, True), np.float32)
    c_rgb = rng.normal(size=(3, m)).astype(np.float32)
    c_sig = rng.normal(size=(m,)).astype(np.float32)
    return xyz, ids, dir_enc, c_rgb, c_sig


def _jax_grads(jsspec, sparams, mparams, mode, xyz, ids, dir_enc, c_rgb, c_sig,
               flags=None, tile=JAX_TILE):
    """-> (loss, (d space, d motion or None, d xyz, d dir_enc), (rgb, sigma))."""
    import jax
    import jax.numpy as jnp

    from stnerf_tpu.kernels.field_vjp import field_planar_trainable

    fl = None if flags is None else jnp.asarray(flags)

    def loss(sp, mp, x, de):
        rgb, sig = field_planar_trainable(sp, mp, x, jnp.asarray(ids), de, fl, jsspec, mode,
                                          "float32", True, tile)
        return jnp.sum(rgb * c_rgb) + jnp.sum(sig * c_sig), (rgb, sig)

    (v, out), g = jax.value_and_grad(loss, (0, 1, 2, 3), has_aux=True, allow_int=True)(
        sparams, mparams, jnp.asarray(xyz), jnp.asarray(dir_enc))
    return float(v), jax.device_get(g), jax.device_get(out)


def _port_grads(net, mnet, mode, xyz, ids, dir_enc, c_rgb, c_sig, flags=None,
                compute_dtype="float32"):
    import torch

    from stnerf_tpu_torch.kernels.field_vjp import field_planar_trainable
    from stnerf_tpu_torch.models import export_linears, export_spacenet

    for p in net.parameters():
        p.grad = None
    x = torch.tensor(xyz, requires_grad=True)
    de = torch.tensor(dir_enc, requires_grad=True)
    rgb, sig = field_planar_trainable(net, mnet, x, torch.tensor(ids), de,
                                      None if flags is None else torch.tensor(flags),
                                      mode, compute_dtype)
    v = (rgb * torch.tensor(c_rgb)).sum() + (sig * torch.tensor(c_sig)).sum()
    v.backward()
    g_m = {"net": export_linears(mnet.net, grad=True)} if mode else None
    grads = (export_spacenet(net, grad=True), g_m, x.grad.numpy(), de.grad.numpy())
    return float(v), grads, (rgb.detach().numpy(), sig.detach().numpy())


def _assert_tree_close(got, ref):
    """Per leaf: rtol 2e-3, atol 2e-3 * max |leaf| (tests/test_kernels.py)."""
    import jax

    flat_r, tdef = jax.tree.flatten(ref)
    flat_g, gdef = jax.tree.flatten(got)
    assert tdef == gdef
    for a, b in zip(flat_g, flat_r):
        scale = max(1e-3, float(np.max(np.abs(b))))
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-3 * scale)


@pytest.mark.parametrize("mode,use_time,deep", [
    (None, False, False), ("direct", False, False), ("lerp", True, False),
    ("lerp", True, True)])
def test_trainable_field_matches_jax(rng, mode, use_time, deep):
    jsspec, sparams, mparams, net, mnet = _nets(mode, use_time, deep)
    args = _inputs(rng, mode)
    v_j, g_j, _ = _jax_grads(jsspec, sparams, mparams, mode, *args)
    v_t, g_t, _ = _port_grads(net, mnet, mode, *args)
    np.testing.assert_allclose(v_t, v_j, rtol=2e-4)
    if not mode:
        g_j, g_t = (g_j[0], g_j[2], g_j[3]), (g_t[0], g_t[2], g_t[3])
    _assert_tree_close(g_t, g_j)


def test_tile_flags_match_jax(rng):
    """A zero flag zeroes its tile's outputs and gradients in both
    packages. JAX's flags cover 128 samples, the port's TILE = 64: one JAX
    flag is two port flags. Cotangents are zero on the skipped tile, as the
    downstream hit mask makes them."""
    from stnerf_tpu_torch.kernels.fused_field import TILE

    m = 256
    jsspec, sparams, mparams, net, mnet = _nets("lerp", True, False)
    xyz, ids, dir_enc, c_rgb, c_sig = _inputs(rng, "lerp", m)
    keep = np.arange(m) < JAX_TILE
    c_rgb, c_sig = c_rgb * keep, c_sig * keep
    jflags = np.array([1, 0], np.int32)
    pflags = np.repeat(jflags, JAX_TILE // TILE).astype(np.int32)
    args = (xyz, ids, dir_enc, c_rgb, c_sig)
    v_j, g_j, (rgb_j, _) = _jax_grads(jsspec, sparams, mparams, "lerp", *args, flags=jflags)
    v_t, g_t, (rgb_t, sig_t) = _port_grads(net, mnet, "lerp", *args, flags=pflags)
    assert not rgb_t[:, JAX_TILE:].any() and not sig_t[JAX_TILE:].any()
    assert not g_t[2][:, JAX_TILE:].any() and not g_t[3][:, JAX_TILE:].any()
    np.testing.assert_allclose(rgb_t, np.asarray(rgb_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v_t, v_j, rtol=2e-4)
    _assert_tree_close(g_t, g_j)


@pytest.mark.parametrize("mode,use_time,deep", [
    (None, False, False), ("direct", False, False), ("lerp", True, True)])
def test_plain_backward_matches_autograd(rng, mode, use_time, deep):
    """field_bwd_reference (the TPU kernel's hand-written backward) against
    torch.autograd through the plain forward, float32, with skip flags. The
    two differ by the double-angle recursion: the VJP uses the analytic
    derivative of each octave, autograd that of the recursion's round-off."""
    import torch

    from stnerf_tpu_torch.kernels.field_vjp import field_bwd_reference
    from stnerf_tpu_torch.kernels.fused_field import (fused_field_reference, pack_field,
                                                      prepare_kernel_params_planar,
                                                      prepare_motion_params_planar)

    _, _, _, net, mnet = _nets(mode, use_time, deep)
    field = pack_field(prepare_kernel_params_planar(net, torch.float32),
                       prepare_motion_params_planar(mnet, torch.float32) if mode else (),
                       net.spec, mode, "float32")
    xyz, ids, dir_enc, c_rgb, c_sig = (torch.tensor(a) for a in _inputs(rng, mode))
    flags = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    weights = field.weights.clone().requires_grad_(True)
    biases = field.biases.clone().requires_grad_(True)
    x = xyz.clone().requires_grad_(True)
    d = dir_enc.clone().requires_grad_(True)
    rgb, sig = fused_field_reference(dataclasses.replace(field, weights=weights, biases=biases),
                                     x, ids, d, flags)
    ((rgb * c_rgb).sum() + (sig * c_sig).sum()).backward()
    got = field_bwd_reference(field, xyz, ids, dir_enc, c_rgb, c_sig, flags)
    for name, a, b in zip(("weights", "biases", "xyz", "dir_enc"), got,
                          (weights.grad, biases.grad, x.grad, d.grad)):
        scale = max(1e-3, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-3 * scale,
                                   err_msg=name)
    assert not got[2][:, 64:128].any() and not got[3][:, 64:128].any()


def test_wrapper_on_cpu_and_bf16(rng):
    """On CPU tensors field_bwd is its plain version and counts no launch;
    it refuses malformed cotangents; in bf16 the plain backward rounds, so
    it differs from float32."""
    import torch

    from stnerf_tpu_torch.kernels.field_vjp import field_bwd, field_bwd_reference
    from stnerf_tpu_torch.kernels.fused_field import (pack_field, prepare_kernel_params_planar,
                                                      prepare_motion_params_planar)

    _, _, _, net, mnet = _nets("lerp", True, False)
    xyz, ids, dir_enc, c_rgb, c_sig = (torch.tensor(a) for a in _inputs(rng, "lerp"))
    out = {}
    for dt, tdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        field = pack_field(prepare_kernel_params_planar(net, tdt),
                           prepare_motion_params_planar(mnet, tdt), net.spec, "lerp", dt)
        before = field_bwd.launches
        out[dt] = field_bwd(field, xyz, ids, dir_enc, c_rgb, c_sig)
        assert field_bwd.launches == before
        ref = field_bwd_reference(field, xyz, ids, dir_enc, c_rgb, c_sig)
        assert all(torch.equal(a, b) for a, b in zip(out[dt], ref))
    # random cotangents cancel in every sum, and a bf16 activation near 0
    # flips its ReLU mask, so at these widths bf16 sits 0.3-25% off float32
    for a, b in zip(out["bfloat16"], out["float32"]):
        assert torch.isfinite(a).all()
        assert 0 < float((a - b).norm() / b.norm()) < 0.5
    for bad in (c_rgb[:, :-1], c_rgb.double(), c_rgb.t().contiguous().t()):
        with pytest.raises(ValueError):
            field_bwd(field, xyz, ids, dir_enc, bad, c_sig)
