"""The port's ops and nets (``stnerf_tpu_torch.ops``, ``models.spacenet``,
``models.motionnet``, ``models.layered.LayeredModel``) against the JAX
package's, in float32, on the same seeded numpy inputs.

Every test runs in a fresh child process (``isolate``): torch must never
load into the long-lived pytest process (tests/conftest.py), so torch and
jax are imported inside the test bodies only.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.isolate


def _t(x):
    import torch

    return torch.tensor(np.asarray(x))


def _j(x):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(x))


@pytest.mark.parametrize("recursive,include_input",
                         [(False, True), (True, True), (False, False)])
def test_positional_encoding_planar(rng, recursive, include_input):
    from stnerf_tpu.ops.encoding import positional_encoding_planar as jpe
    from stnerf_tpu_torch.ops.encoding import positional_encoding_planar as tpe

    x = rng.uniform(-3.0, 3.0, size=(3, 40, 5)).astype(np.float32)
    ref = np.asarray(jpe(_j(x), 10, include_input, recursive))
    out = tpe(_t(x), 10, include_input, recursive).numpy()
    assert out.shape == ref.shape
    # exact form: two libraries' float32 sin/cos of the same arguments
    # (|x| 2^9 up to ~1500), a few ulp; recursive form: each side's
    # rounding error doubles per octave, ~2^L * eps = 1.2e-4 per side at L=10
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3 if recursive else 1e-6)


def test_lerp_encoded_time_planar(rng):
    from stnerf_tpu.ops.encoding import lerp_encoded_time_planar as jlerp
    from stnerf_tpu_torch.ops.encoding import lerp_encoded_time_planar as tlerp

    xyz = rng.normal(size=(3, 64)).astype(np.float32)
    t = (rng.integers(1, 5, size=64) + rng.choice([0.0, 0.25, 0.5], 64)).astype(np.float32)
    ref = np.asarray(jlerp(_j(xyz), _j(t), 10, True))
    out = tlerp(_t(xyz), _t(t), 10, True).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)  # as the exact form


def test_ray_aabb_intersect(rng):
    from stnerf_tpu.ops.sampling import ray_aabb_intersect as jint
    from stnerf_tpu_torch.ops.sampling import ray_aabb_intersect as tint

    o = rng.normal(size=(200, 3)).astype(np.float32) * 3
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lo = rng.uniform(-2, 0, size=(200, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.5, 2, size=(200, 3)).astype(np.float32)
    jn, jf, jh = (np.asarray(a) for a in jint(_j(o), _j(d), _j(lo), _j(hi)))
    tn, tf, th = (a.numpy() for a in tint(_t(o), _t(d), _t(lo), _t(hi)))
    assert 0 < th.sum() < 200  # both hits and misses
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_allclose(tn, jn, rtol=1e-6, atol=1e-6)  # same float32 ops
    np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-6)


def test_stratified_det_matches_jax(rng):
    from stnerf_tpu.ops import sampling as js
    from stnerf_tpu_torch.ops import sampling as ts

    a = rng.uniform(0, 2, size=30).astype(np.float32)
    b = a + rng.uniform(0.1, 5, size=30).astype(np.float32)
    np.testing.assert_allclose(ts.stratified_between(_t(a), _t(b), 16).numpy(),
                               np.asarray(js.stratified_between(_j(a), _j(b), 16)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.stratified_near_far(_t(a), _t(b), 16).numpy(),
                               np.asarray(js.stratified_near_far(_j(a), _j(b), 16)),
                               rtol=1e-6, atol=1e-6)


def test_stratified_with_generator(rng):
    """Generator mode: one uniform draw per bin (torch's bits differ from
    JAX's, so the contract is checked, not the values)."""
    import torch

    from stnerf_tpu_torch.ops import sampling as ts

    a = torch.tensor(rng.uniform(0, 2, size=30), dtype=torch.float32)
    b = a + 3.0
    t1 = ts.stratified_between(a, b, 16, torch.Generator().manual_seed(1))
    t2 = ts.stratified_between(a, b, 16, torch.Generator().manual_seed(1))
    t3 = ts.stratified_between(a, b, 16, torch.Generator().manual_seed(2))
    assert torch.equal(t1, t2) and not torch.equal(t1, t3)
    bin_idx = torch.floor((t1 - a[:, None]) / ((b - a)[:, None] / 16))
    assert torch.equal(bin_idx, torch.arange(16.0).expand(30, 16))
    z = ts.stratified_near_far(a, b, 16, torch.Generator().manual_seed(1))
    det = ts.stratified_near_far(a, b, 16)
    half = (b - a)[:, None] / 15 / 2 + 1e-6
    assert ((z - det).abs() <= half).all()
    assert (z[:, 1:] >= z[:, :-1]).all()


def test_sample_pdf_det_matches_jax(rng):
    from stnerf_tpu.ops.sampling import sample_pdf as jpdf
    from stnerf_tpu_torch.ops.sampling import sample_pdf as tpdf

    z = np.sort(rng.uniform(1, 6, size=(40, 16)), axis=1).astype(np.float32)
    # weights bounded away from 0: where an interval holds < 1e-5 of the
    # mass the algorithm is discontinuous (its denom < 1e-5 -> 1 rule), and
    # the u = 1 sample then lands a whole bin apart depending on whether
    # the float32 cdf total rounds above or below 1 — in both packages
    w = rng.uniform(0.05, 1, size=(40, 14)).astype(np.float32) ** 2
    w[:5] = 0.0  # empty rays: uniform pdf from the 1e-5 floor
    ref = np.asarray(jpdf(_j(z), _j(w), 8))
    out = tpdf(_t(z), _t(w), 8).numpy()
    # float32 cumsum in two orders, then a divide by cdf gaps >= 1e-5
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_sample_pdf_with_generator(rng):
    import torch

    from stnerf_tpu_torch.ops.sampling import sample_pdf

    z = torch.tensor(np.linspace(0, 1, 16)[None].repeat(50, 0), dtype=torch.float32)
    w = torch.zeros(50, 14)
    w[:, 7] = 1.0  # all mass in one interior bin
    s1 = sample_pdf(z, w, 32, torch.Generator().manual_seed(3))
    s2 = sample_pdf(z, w, 32, torch.Generator().manual_seed(3))
    assert torch.equal(s1, s2)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    assert ((s1 >= bins[:, :1]) & (s1 <= bins[:, -1:])).all()
    # the peak bin is [bins[7], bins[8]]; with pdf ~(1 + 1e-5) vs 1e-5 the
    # other bins hold ~1e-4 of the mass
    in_peak = (s1 >= bins[:, 7:8] - 1e-6) & (s1 <= bins[:, 8:9] + 1e-6)
    assert in_peak.float().mean() > 0.99


def test_volume_render_planar_matches_jax(rng):
    from stnerf_tpu.ops.volume import volume_render_planar as jvr
    from stnerf_tpu_torch.ops.volume import volume_render_planar as tvr

    L, N, S = 3, 20, 12
    t = np.sort(rng.uniform(0, 5, size=(L, N, S)), axis=-1).astype(np.float32)
    rgb = rng.normal(size=(L, 3, N, S)).astype(np.float32)
    sigma = rng.normal(size=(L, N, S)).astype(np.float32) * 2
    out = tvr(_t(t), _t(rgb), _t(sigma))  # leading layer axis as a batch axis
    for l in range(L):
        ref = jvr(_j(t[l]), _j(rgb[l]), _j(sigma[l]))
        for name in ("color", "depth", "acc", "weights"):
            np.testing.assert_allclose(getattr(out, name)[l].numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_merged_composite_matches_jax(rng):
    """Merge + composite; the sorts are compared through what they feed,
    the composite, since neither sort is stable at ties."""
    from stnerf_tpu.ops import volume as jv
    from stnerf_tpu_torch.ops import volume as tv

    L, N, S = 3, 24, 10
    t = np.sort(rng.uniform(0, 5, size=(L, N, S)), axis=-1).astype(np.float32)
    t[1, :4] = -1e3  # MISS_T-parked rays of a missed layer: ties
    rgb = rng.normal(size=(L, 3, N, S)).astype(np.float32)
    sigma = rng.normal(size=(L, N, S)).astype(np.float32)
    sigma[1, :4] = 0.0
    ref = jv.volume_render_planar(*jv.merge_layers_planar(_j(t), _j(rgb), _j(sigma)))
    t_m, rgb_m, sig_m = tv.merge_layers_planar(_t(t), _t(rgb), _t(sigma))
    assert (t_m[:, 1:] >= t_m[:, :-1]).all()
    out = tv.volume_render_planar(t_m, rgb_m, sig_m)
    for name in ("color", "depth", "acc"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    a = rng.uniform(0, 5, size=(N, S)).astype(np.float32)
    b = rng.uniform(0, 5, size=(N, 6)).astype(np.float32)
    np.testing.assert_array_equal(tv.sort_merge_t(_t(a), _t(b)).numpy(),
                                  np.asarray(jv.sort_merge_t(_j(a), _j(b))))


def _jax_spacenet(spec_kwargs, key):
    import jax

    from stnerf_tpu.models.spacenet import SpaceNetSpec, init_spacenet

    spec = SpaceNetSpec(**spec_kwargs)
    return spec, jax.device_get(init_spacenet(jax.random.PRNGKey(key), spec))


@pytest.mark.parametrize("deep_rgb,use_time,dtype",
                         [(False, True, "float32"), (True, True, "float32"),
                          (False, False, "float32"), (False, True, "bfloat16")])
def test_spacenet_matches_jax(rng, deep_rgb, use_time, dtype):
    import torch

    from stnerf_tpu.models.spacenet import apply_spacenet_planar
    from stnerf_tpu_torch.models import SpaceNet, SpaceNetSpec, load_spacenet

    kw = dict(use_dir=True, use_time=use_time, deep_rgb=deep_rgb,
              backbone_dim=32, head_dim=16)
    jspec, params = _jax_spacenet(kw, 4)
    net = load_spacenet(SpaceNet(SpaceNetSpec(**kw)), params)
    pos = rng.normal(size=(3, 50, 4)).astype(np.float32)
    dirs = rng.normal(size=(3, 50, 4)).astype(np.float32)
    times = rng.integers(1, 5, size=(50, 4)).astype(np.float32)
    # the JAX side always runs float32: XLA's CPU backend has no
    # bf16 x bf16 -> f32 dot, so the port's bf16 is held against float32
    rgb_r, sig_r = apply_spacenet_planar(params, jspec, _j(pos), _j(dirs),
                                         _j(times) if use_time else None)
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    with torch.no_grad():
        rgb, sig = net(_t(pos), _t(dirs), _t(times) if use_time else None, tdt)
    assert rgb.shape == (3, 50, 4) and sig.shape == (50, 4)
    if dtype == "bfloat16":
        # bf16 rounding of every layer's inputs: ~2^-8 relative per layer
        mse = float(((torch.sigmoid(rgb) - torch.sigmoid(_t(rgb_r))) ** 2).mean())
        assert -10 * np.log10(mse) >= 40.0
        np.testing.assert_allclose(sig.numpy(), np.asarray(sig_r), rtol=0, atol=2e-2)
    else:  # reassociated float32 sums
        np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_r), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sig.numpy(), np.asarray(sig_r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("input_time", [True, False])
def test_motionnet_matches_jax(rng, input_time):
    import jax
    import torch

    from stnerf_tpu.models.motionnet import MotionNetSpec as JSpec
    from stnerf_tpu.models.motionnet import apply_motionnet_planar, init_motionnet
    from stnerf_tpu_torch.models import MotionNet, MotionNetSpec, load_linears

    jspec = JSpec(width=32, input_time=input_time)
    params = jax.device_get(init_motionnet(jax.random.PRNGKey(2), jspec))
    net = MotionNet(MotionNetSpec(width=32, input_time=input_time))
    with torch.no_grad():
        load_linears(net.net, params["net"])
    xyz = rng.normal(size=(3, 64)).astype(np.float32)
    ids = (rng.integers(1, 5, size=64) + rng.choice([0.0, 0.5], 64)).astype(np.float32)
    ref = np.asarray(apply_motionnet_planar(params, jspec, _j(xyz), _j(ids)))
    with torch.no_grad():
        out = net(_t(xyz), _t(ids)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_layered_model_init():
    """Init sharing of init_layered_params: performers start as copies of
    performer 0, fine nets as copies of the coarse ones; weights and biases
    within U(+-1/sqrt(d_in)); the same seed gives the same model."""
    import torch

    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec

    spec = LayeredSpec(layer_num=2, use_space_time=True, use_deform_time=True,
                       backbone_dim=32, head_dim=16, motion_dim=32)
    m1 = LayeredModel(spec, torch.Generator().manual_seed(0))
    m2 = LayeredModel(spec, torch.Generator().manual_seed(0))
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    sd = m1.state_dict()
    for k, v in sd.items():
        if k.startswith("layers_coarse.1.") or k.startswith("layers_fine.0."):
            assert torch.equal(v, sd["layers_coarse.0." + k.split(".", 2)[2]])
        if k.startswith("bkgd_fine."):
            assert torch.equal(v, sd["bkgd_coarse." + k.split(".", 1)[1]])
        if k.startswith("motion.1."):
            assert torch.equal(v, sd["motion.0." + k.split(".", 2)[2]])
    assert not torch.equal(sd["bkgd_coarse.stage1.0.weight"][:, :63],
                           sd["layers_coarse.0.stage1.0.weight"][:, :63])
    for mod in m1.modules():
        if isinstance(mod, torch.nn.Linear):
            bound = 1.0 / mod.in_features ** 0.5
            assert mod.weight.abs().max() <= bound and mod.bias.abs().max() <= bound
    shared = LayeredModel(LayeredSpec(layer_num=2, same_spacenet=True,
                                      backbone_dim=32, head_dim=16))
    assert shared.layers_fine is None and shared.motion is None
