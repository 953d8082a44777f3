"""The port of the SpaceNet kernels on encoded inputs (``stnerf_tpu_torch.
kernels.spacenet_vjp``, K3, and ``kernels.fused_spacenet``, K6) against the
JAX package's ``spacenet_planar_trainable`` and ``fused_spacenet*``, run as
tests/test_kernels.py runs them on the CPU (interpret mode, float32).

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are checked against those plain versions on the card by ``chip_smoke.py``.
Weights reach both packages from the same JAX pytree, inputs from numpy
with a seed. Every test runs in a fresh child process (``isolate``).
"""

import dataclasses

import numpy as np
import pytest

pytestmark = pytest.mark.isolate

M = 200          # samples: not a multiple of the JAX tile
JAX_TILE = 128
W, HEAD = 32, 16


def _net(seed, **kw):
    """-> (JAX SpaceNet spec, params; the port's SpaceNet with the same weights)."""
    import jax

    from stnerf_tpu.models.spacenet import SpaceNetSpec as JSpec
    from stnerf_tpu.models.spacenet import init_spacenet
    from stnerf_tpu_torch.models import SpaceNet, SpaceNetSpec, load_spacenet

    kw = dict(backbone_dim=W, head_dim=HEAD, **kw)
    jspec = JSpec(**kw)
    params = jax.device_get(init_spacenet(jax.random.PRNGKey(seed), jspec))
    return jspec, params, load_spacenet(SpaceNet(SpaceNetSpec(**kw)), params)


def _encodings(rng, spec, m=M):
    """Seeded pos, dir (a (1, m) zero row without directions) and time
    (None without a time input) encodings, numpy float32."""
    from stnerf_tpu.ops.encoding import positional_encoding_planar as jpe

    def enc(x, freqs):
        return np.asarray(jpe(x.astype(np.float32), freqs, True), np.float32)

    pos = enc(rng.normal(size=(3, m)), spec.pos_freqs)
    dirs = (enc(rng.normal(size=(3, m)), spec.dir_freqs) if spec.use_dir
            else np.zeros((1, m), np.float32))
    time = enc(rng.integers(1, 5, size=(1, m)), spec.time_freqs) if spec.use_time else None
    return pos, dirs, time


def _pack(net, dtype="float32"):
    import torch

    from stnerf_tpu_torch.kernels.fused_field import pack_field, prepare_kernel_params_planar

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return pack_field(prepare_kernel_params_planar(net, tdt), (), net.spec, None, dtype)


def _assert_tree_close(got, ref):
    """Per leaf: rtol 2e-3, atol 2e-3 * max |leaf| (tests/test_kernels.py)."""
    import jax

    flat_r, tdef = jax.tree.flatten(ref)
    flat_g, gdef = jax.tree.flatten(got)
    assert tdef == gdef
    for a, b in zip(flat_g, flat_r):
        scale = max(1e-3, float(np.max(np.abs(b))))
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-3 * scale)


@pytest.mark.parametrize("deep,use_dir,use_time", [
    (False, True, True), (True, True, False), (False, False, False)])
def test_trainable_spacenet_matches_jax(rng, deep, use_dir, use_time):
    """Value and every gradient of a random linear loss: the port's
    autograd Function (plain forward and backward on the CPU) against JAX's
    custom_vjp over the interpret-mode Pallas kernels."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.kernels.spacenet_vjp import spacenet_planar_trainable as jtrain
    from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_planar_trainable
    from stnerf_tpu_torch.models import export_spacenet

    jspec, params, net = _net(3, use_dir=use_dir, use_time=use_time, deep_rgb=deep)
    pos, dirs, time = _encodings(rng, jspec)
    c_rgb = rng.normal(size=(3, M)).astype(np.float32)
    c_sig = rng.normal(size=(M,)).astype(np.float32)
    t_j = None if time is None else jnp.asarray(time)

    def loss(p, pe_, de_):
        rgb, sig = jtrain(p, jspec, pe_, de_, t_j, "float32", True, JAX_TILE)
        return jnp.sum(rgb * c_rgb) + jnp.sum(sig * c_sig)

    v_j, (gp_j, gx_j, gd_j) = jax.device_get(jax.value_and_grad(loss, (0, 1, 2))(
        params, jnp.asarray(pos), jnp.asarray(dirs)))

    x = torch.tensor(pos, requires_grad=True)
    d = torch.tensor(dirs, requires_grad=True)
    rgb, sig = spacenet_planar_trainable(net, x, d, None if time is None else torch.tensor(time),
                                         "float32")
    v_t = (rgb * torch.tensor(c_rgb)).sum() + (sig * torch.tensor(c_sig)).sum()
    v_t.backward()
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=2e-4)
    np.testing.assert_allclose(x.grad.numpy(), gx_j, rtol=2e-3, atol=2e-4)
    # the direction-encoding gradient: the pose refinement's signal
    np.testing.assert_allclose(d.grad.numpy(), gd_j, rtol=2e-3, atol=2e-4)
    _assert_tree_close(export_spacenet(net, grad=True), gp_j)


@pytest.mark.parametrize("deep,use_dir,use_time", [(False, True, True), (True, False, False)])
def test_plain_backward_matches_autograd(rng, deep, use_dir, use_time):
    """spacenet_bwd_reference (the TPU kernel's _bwd_math written out)
    against torch.autograd through spacenet_fwd_reference, float32, on the
    packed weights and biases and the two encodings."""
    import torch

    from stnerf_tpu_torch.kernels.spacenet_vjp import (spacenet_bwd_reference,
                                                       spacenet_fwd_reference)

    jspec, _, net = _net(4, use_dir=use_dir, use_time=use_time, deep_rgb=deep)
    field = _pack(net)
    pos, dirs, time = (None if a is None else torch.tensor(a) for a in _encodings(rng, jspec))
    c_rgb = torch.tensor(rng.normal(size=(3, M)).astype(np.float32))
    c_sig = torch.tensor(rng.normal(size=(M,)).astype(np.float32))
    weights = field.weights.clone().requires_grad_(True)
    biases = field.biases.clone().requires_grad_(True)
    x = pos.clone().requires_grad_(True)
    d = dirs.clone().requires_grad_(True)
    rgb, sig = spacenet_fwd_reference(dataclasses.replace(field, weights=weights, biases=biases),
                                      x, d, time)
    ((rgb * c_rgb).sum() + (sig * c_sig).sum()).backward()
    got = spacenet_bwd_reference(field, pos, dirs, time, c_rgb, c_sig)
    for name, a, b in zip(("weights", "biases", "pos_enc", "dir_enc"), got,
                          (weights.grad, biases.grad, x.grad, d.grad)):
        scale = max(1e-3, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-3 * scale,
                                   err_msg=name)


def test_wrappers_on_cpu_and_bf16(rng):
    """On CPU tensors the wrappers are their plain versions and count no
    launch; they refuse malformed inputs and a field with a motion net; in
    bf16 the plain versions round, so they differ from float32."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import (pack_field, prepare_kernel_params_planar,
                                                      prepare_motion_params_planar)
    from stnerf_tpu_torch.kernels.fused_spacenet import fused_spacenet_planar
    from stnerf_tpu_torch.kernels.spacenet_vjp import (spacenet_bwd, spacenet_bwd_reference,
                                                       spacenet_fwd, spacenet_fwd_reference)
    from stnerf_tpu_torch.models import MotionNet, MotionNetSpec

    jspec, _, net = _net(5, use_dir=True, use_time=True)
    pos, dirs, time = (torch.tensor(a) for a in _encodings(rng, jspec))
    c_rgb = torch.tensor(rng.normal(size=(3, M)).astype(np.float32))
    c_sig = torch.tensor(rng.normal(size=(M,)).astype(np.float32))
    out = {}
    for dt in ("float32", "bfloat16"):
        field = _pack(net, dt)
        counts = [f.launches for f in (spacenet_fwd, spacenet_bwd, fused_spacenet_planar)]
        fwd = spacenet_fwd(field, pos, dirs, time)
        assert all(torch.equal(a, b) for a, b in
                   zip(fwd, spacenet_fwd_reference(field, pos, dirs, time)))
        assert all(torch.equal(a, b) for a, b in
                   zip(fwd, fused_spacenet_planar(field, pos, dirs, time)))
        out[dt] = spacenet_bwd(field, pos, dirs, time, c_rgb, c_sig)
        ref = spacenet_bwd_reference(field, pos, dirs, time, c_rgb, c_sig)
        assert all(torch.equal(a, b) for a, b in zip(out[dt], ref))
        assert counts == [f.launches for f in (spacenet_fwd, spacenet_bwd,
                                               fused_spacenet_planar)]
    for a, b in zip(out["bfloat16"], out["float32"]):
        assert torch.isfinite(a).all()
        assert 0 < float((a - b).norm() / b.norm()) < 0.5
    field = _pack(net)
    for bad in (pos[:-1], pos.double(), pos.t().contiguous().t()):
        with pytest.raises((ValueError, TypeError)):
            spacenet_fwd(field, bad, dirs, time)
    with pytest.raises(ValueError):
        spacenet_fwd(field, pos, dirs, None)  # the field takes a time input
    with pytest.raises(ValueError):
        spacenet_bwd(field, pos, dirs, time, c_rgb[:, :-1], c_sig)
    mnet = MotionNet(MotionNetSpec(width=16))
    moving = pack_field(prepare_kernel_params_planar(net, torch.float32),
                        prepare_motion_params_planar(mnet, torch.float32), net.spec, "direct",
                        "float32")
    with pytest.raises(ValueError):
        spacenet_fwd(moving, pos, dirs, time)


def test_active_flag_skips_the_field(rng):
    """``active`` 0 (JAX's chunk-level lax.cond taking its skip branch):
    zeros out and zero gradients for the field and both encodings; 1: the
    same values and gradients as no flag. A malformed flag is refused."""
    import torch

    from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_fwd, spacenet_planar_trainable

    jspec, _, net = _net(8, use_dir=True, use_time=True)
    pos, dirs, time = (torch.tensor(a) for a in _encodings(rng, jspec))
    c_rgb = torch.tensor(rng.normal(size=(3, M)).astype(np.float32))
    runs = {}
    for flag in (None, 1, 0):
        net.zero_grad()
        x, d = pos.clone().requires_grad_(True), dirs.clone().requires_grad_(True)
        active = None if flag is None else torch.tensor([flag], dtype=torch.int32)
        rgb, sig = spacenet_planar_trainable(net, x, d, time, "float32", active=active)
        ((rgb * c_rgb).sum() + sig.sum()).backward()
        runs[flag] = [rgb, sig, x.grad, d.grad] + [p.grad.clone() for p in net.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(runs[1], runs[None]))
    assert all(not a.any() for a in runs[0])
    assert all(a.any() for a in runs[None])
    for bad in (torch.tensor([1]), torch.tensor([1, 1], dtype=torch.int32),
                torch.tensor(1, dtype=torch.int32)):
        with pytest.raises(ValueError):
            spacenet_fwd(_pack(net), pos, dirs, time, bad)


@pytest.mark.parametrize("entry", ["fused_spacenet", "fused_spacenet_planar",
                                   "fused_spacenet_stacked"])
def test_fused_spacenet_matches_jax(rng, entry):
    """K6's three entry points (their plain versions on the CPU) against the
    JAX package's, interpret mode, float32, at each entry's own layout."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.kernels import fused_spacenet as jfs
    from stnerf_tpu.kernels import fused_spacenet_planar as jfs_planar
    from stnerf_tpu.kernels import fused_spacenet_stacked as jfs_stacked
    from stnerf_tpu.kernels import prepare_kernel_params, prepare_kernel_params_planar
    from stnerf_tpu_torch.kernels import (fused_spacenet, fused_spacenet_planar,
                                          fused_spacenet_stacked)

    kw = dict(use_dir=True, use_time=entry != "fused_spacenet_planar", deep_rgb=entry == "fused_spacenet")
    nets = [_net(seed, **kw) for seed in (6, 7)]
    jspec = nets[0][0]
    if entry == "fused_spacenet_planar":
        pos, dirs, time = _encodings(rng, jspec, 260)
        kp = prepare_kernel_params_planar(nets[0][1], jspec, jnp.float32)
        ref = jfs_planar(kp, jspec, jnp.asarray(pos), jnp.asarray(dirs), None,
                                      compute_dtype="float32", interpret=True, tile=128)
        got = fused_spacenet_planar(_pack(nets[0][2]), torch.tensor(pos),
                                      torch.tensor(dirs), None)
    elif entry == "fused_spacenet":
        pos, dirs, time = (a.T.copy() for a in _encodings(rng, jspec, 300))
        kp = prepare_kernel_params(nets[0][1], jspec, jnp.float32)
        ref = jfs(kp, jspec, jnp.asarray(pos), jnp.asarray(dirs),
                               jnp.asarray(time), compute_dtype="float32", interpret=True)
        got = fused_spacenet(_pack(nets[0][2]), torch.tensor(pos), torch.tensor(dirs),
                               torch.tensor(time))
    else:
        encs = [_encodings(rng, jspec, 128) for _ in nets]
        pos, dirs, time = (np.stack([e[i].T for e in encs]) for i in range(3))
        kp = jax.tree.map(lambda *a: jnp.stack(a),
                          *[prepare_kernel_params(p, jspec, jnp.float32) for _, p, _ in nets])
        ref = jfs_stacked(kp, jspec, jnp.asarray(pos), jnp.asarray(dirs),
                                       jnp.asarray(time), compute_dtype="float32",
                                       interpret=True)
        got = fused_spacenet_stacked([_pack(n) for _, _, n in nets], torch.tensor(pos),
                                       torch.tensor(dirs), torch.tensor(time))
    for a, b in zip(got, jax.device_get(ref)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=2e-4)


def test_build_sources_and_cpu_routes(rng):
    """The build hash covers every kernel source: ``_build.SOURCES`` and
    ``HEADERS`` are exactly the ``.cu`` and ``.cuh`` files under
    ``kernels/csrc/``. On CPU tensors ``spacenet_fwd`` and ``spacenet_bwd``
    launch nothing on either route (``launches`` and ``launches_tc`` stay 0)
    and return their plain versions' results, with and without ``active``,
    for a float32 and a bf16 field."""
    import torch

    from stnerf_tpu_torch.kernels import _build
    from stnerf_tpu_torch.kernels.spacenet_vjp import (spacenet_bwd, spacenet_bwd_reference,
                                                       spacenet_fwd, spacenet_fwd_reference)

    assert set(_build.SOURCES) == set(_build.CSRC.glob("*.cu"))
    assert set(_build.HEADERS) == set(_build.CSRC.glob("*.cuh"))
    assert len(_build.SOURCES) == len(set(_build.SOURCES))
    assert len(_build.HEADERS) == len(set(_build.HEADERS))

    jspec, _, net = _net(9, use_dir=True, use_time=True)
    pos, dirs, time = (torch.tensor(a) for a in _encodings(rng, jspec))
    c_rgb = torch.tensor(rng.normal(size=(3, M)).astype(np.float32))
    c_sig = torch.tensor(rng.normal(size=(M,)).astype(np.float32))
    for dt in ("float32", "bfloat16"):
        field = _pack(net, dt)
        for active in (None, torch.tensor([1], dtype=torch.int32),
                       torch.tensor([0], dtype=torch.int32)):
            fwd = spacenet_fwd(field, pos, dirs, time, active)
            ref = spacenet_fwd_reference(field, pos, dirs, time, active)
            assert all(torch.equal(a, b) for a, b in zip(fwd, ref))
            bwd = spacenet_bwd(field, pos, dirs, time, c_rgb, c_sig, active)
            ref = spacenet_bwd_reference(field, pos, dirs, time, c_rgb, c_sig, active)
            assert all(torch.equal(a, b) for a, b in zip(bwd, ref))
    assert [spacenet_fwd.launches, spacenet_fwd.launches_tc,
            spacenet_bwd.launches, spacenet_bwd.launches_tc] == [0, 0, 0, 0]
