"""The port of the fused field kernel (``stnerf_tpu_torch.kernels.
fused_field``) against the JAX package's Pallas ``fused_field``, run as
tests/test_kernels.py runs it on the CPU (interpret mode, float32).

On the CPU the port's wrapper runs its plain PyTorch version,
``fused_field_reference``; the CUDA kernel itself is checked against that
plain version on the card by ``chip_smoke.py``. Weights reach both packages
through ``load_jax_params`` from the same ``init_layered_params`` pytree.
Every test runs in a fresh child process (``isolate``).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.isolate

M = 200        # samples: not a multiple of either package's tile
JAX_TILE = 128


def _pair(motion_mode, deep_rgb=False, compute_dtype="float32"):
    """-> (jax fused_field args, port PackedField) for one field of a tiny
    layered model: the background (motion None or "direct") or performer
    1 ("lerp", with a time input)."""
    import jax

    from stnerf_tpu.kernels import prepare_kernel_params_planar as jprep
    from stnerf_tpu.kernels.fused_field import prepare_motion_params_planar as jmprep
    from stnerf_tpu.models import LayeredSpec as JSpec
    from stnerf_tpu.models import init_layered_params
    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec, load_jax_params

    kw = dict(layer_num=2, coarse_samples=8, fine_samples=4,
              use_space_time=True, use_deform_time=True,
              bkgd_use_deform_time=motion_mode == "direct", deep_rgb=deep_rgb,
              backbone_dim=32, head_dim=16, motion_dim=32)
    jspec = JSpec(compute_dtype="float32", **kw)
    params = jax.device_get(init_layered_params(jax.random.PRNGKey(3), jspec))
    model = load_jax_params(LayeredModel(LayeredSpec(compute_dtype=compute_dtype, **kw), device="cpu"),
                            params)
    field = model.kernel_fields(fine=False)[1 if motion_mode == "lerp" else 0]
    if motion_mode == "lerp":
        tree = jax.tree.map(lambda x: x[0], params["layers_coarse"])
        mtree = jax.tree.map(lambda x: x[0], params["motion"])
        sspec = jspec.spacenet_spec(bkgd=False)
    else:
        tree, mtree = params["bkgd_coarse"], params.get("bkgd_motion")
        sspec = jspec.spacenet_spec(bkgd=True)
    import jax.numpy as jnp

    jargs = (jprep(tree, sspec, jnp.float32),
             jmprep(mtree, jnp.float32) if motion_mode else (), sspec)
    return jargs, field


def _inputs(rng, motion_mode):
    from stnerf_tpu.ops.encoding import positional_encoding_planar as jpe

    xyz = rng.normal(size=(3, M)).astype(np.float32) * 1.5
    ids = rng.integers(1, 4, size=(1, M)).astype(np.float32)
    if motion_mode == "lerp":
        ids += rng.choice([0.0, 0.25, 0.5], size=(1, M)).astype(np.float32)
    dirs = rng.normal(size=(3, M)).astype(np.float32)
    dir_enc = np.asarray(jpe(dirs, 4, True), np.float32)
    return xyz, ids, dir_enc


def _jax_field(jargs, motion_mode, xyz, ids, dir_enc, flags=None):
    import jax.numpy as jnp

    from stnerf_tpu.kernels.fused_field import fused_field

    rgb, sig = fused_field(*jargs, jnp.asarray(xyz), jnp.asarray(ids),
                           jnp.asarray(dir_enc), motion_mode=motion_mode,
                           compute_dtype="float32", interpret=True,
                           tile=JAX_TILE,
                           tile_flags=None if flags is None else jnp.asarray(flags))
    return np.asarray(rgb), np.asarray(sig)


def _port_field(field, xyz, ids, dir_enc, flags=None):
    import torch

    from stnerf_tpu_torch.kernels.fused_field import fused_field_reference

    rgb, sig = fused_field_reference(
        field, torch.tensor(xyz), torch.tensor(ids), torch.tensor(dir_enc),
        None if flags is None else torch.tensor(flags))
    return rgb.numpy(), sig.numpy()


# float32 on both sides with the same double-angle encoding: they differ by
# the libraries' sin/cos ulps, doubled per octave, and by summation order
RTOL, ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("motion_mode", [None, "direct", "lerp"])
def test_reference_matches_jax_kernel(rng, motion_mode):
    jargs, field = _pair(motion_mode)
    xyz, ids, dir_enc = _inputs(rng, motion_mode)
    rgb_j, sig_j = _jax_field(jargs, motion_mode, xyz, ids, dir_enc)
    rgb_t, sig_t = _port_field(field, xyz, ids, dir_enc)
    assert rgb_t.shape == (3, M) and sig_t.shape == (M,)
    np.testing.assert_allclose(rgb_t, rgb_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sig_t, sig_j, rtol=RTOL, atol=ATOL)


def test_deep_rgb_reference_matches_jax_kernel(rng):
    jargs, field = _pair("lerp", deep_rgb=True)
    assert field.n_rgb == 4
    xyz, ids, dir_enc = _inputs(rng, "lerp")
    rgb_j, sig_j = _jax_field(jargs, "lerp", xyz, ids, dir_enc)
    rgb_t, sig_t = _port_field(field, xyz, ids, dir_enc)
    np.testing.assert_allclose(rgb_t, rgb_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sig_t, sig_j, rtol=RTOL, atol=ATOL)


def test_tile_flags_zero_skipped_tiles(rng):
    """A zero flag gives exact zeros over its tile; the rest is unchanged.
    JAX's flags cover 128 samples, the port's TILE = 64: one JAX flag is
    two port flags."""
    from stnerf_tpu_torch.kernels.fused_field import TILE

    assert JAX_TILE % TILE == 0
    jargs, field = _pair("lerp")
    xyz, ids, dir_enc = _inputs(rng, "lerp")
    jflags = np.array([0, 1], np.int32)
    pflags = np.repeat(jflags, JAX_TILE // TILE).astype(np.int32)
    rgb_j, sig_j = _jax_field(jargs, "lerp", xyz, ids, dir_enc, jflags)
    rgb_t, sig_t = _port_field(field, xyz, ids, dir_enc, pflags)
    assert not rgb_t[:, :JAX_TILE].any() and not sig_t[:JAX_TILE].any()
    assert rgb_t[:, JAX_TILE:].any()
    np.testing.assert_allclose(rgb_t, rgb_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sig_t, sig_j, rtol=RTOL, atol=ATOL)


def test_bf16_reference_close_to_float32(rng):
    """bf16 compute against the JAX kernel in float32 (XLA's CPU backend
    has no bf16 x bf16 -> f32 dot): rounding only, >= 40 dB on
    sigmoid(rgb), the bar chip_smoke.py holds the bf16 kernel to."""
    jargs, _ = _pair("lerp")
    _, field = _pair("lerp", compute_dtype="bfloat16")
    assert field.weights.dtype.is_floating_point and field.compute_dtype == "bfloat16"
    xyz, ids, dir_enc = _inputs(rng, "lerp")
    rgb_j, sig_j = _jax_field(jargs, "lerp", xyz, ids, dir_enc)
    rgb_t, sig_t = _port_field(field, xyz, ids, dir_enc)
    s_j, s_t = 1 / (1 + np.exp(-rgb_j)), 1 / (1 + np.exp(-rgb_t))
    assert -10 * np.log10(np.mean((s_j - s_t) ** 2)) >= 40.0
    assert not np.array_equal(rgb_t, rgb_j)  # the rounding did happen


def test_wrapper_on_cpu_runs_reference(rng):
    import torch

    from stnerf_tpu_torch.kernels.fused_field import (TILE, fused_field,
                                                      fused_field_reference)

    _, field = _pair("lerp")
    xyz, ids, dir_enc = (torch.tensor(a) for a in _inputs(rng, "lerp"))
    flags = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    assert flags.shape[0] == -(-M // TILE)
    before = fused_field.launches
    out = fused_field(field, xyz, ids, dir_enc, flags)
    ref = fused_field_reference(field, xyz, ids, dir_enc, flags)
    assert fused_field.launches == before  # the plain version is no launch
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided", "flags_len",
                                 "flags_dtype", "device"])
def test_wrapper_rejects_bad_inputs(rng, bad):
    import torch

    from stnerf_tpu_torch.kernels.fused_field import fused_field

    _, field = _pair(None)
    xyz, ids, dir_enc = (torch.tensor(a) for a in _inputs(rng, None))
    flags = None
    if bad == "shape":
        ids = ids[:, :-1]
    elif bad == "dtype":
        xyz = xyz.double()
    elif bad == "strided":
        xyz = torch.tensor(np.asarray(xyz).T.copy()).T
    elif bad == "flags_len":
        flags = torch.ones(3, dtype=torch.int32)
    elif bad == "flags_dtype":
        flags = torch.ones(4, dtype=torch.int64)
    else:
        xyz = xyz.to("meta")
    with pytest.raises((ValueError, TypeError)):
        fused_field(field, xyz, ids, dir_enc, flags)


def test_packing_matches_jax_operands():
    """pack_field keeps every operand of the JAX kernel's list (weights
    (in, out), biases (out, 1), the split concat layers, the (1, head) zero
    dummy of a field without time), each 16-element aligned."""
    import jax

    from stnerf_tpu_torch.kernels.fused_field import B_SLOTS, W_SLOTS

    (jk, jm, _), field = _pair("direct")
    order = ["w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4", "s2a", "s2b",
             "sb1", "s2w2", "sb2", "s2w3", "sb3", "dw", "db", "r1a", "r1b",
             "r1c", "rb1", "rgb1", "rgbb1"]
    order = [f"{p}{k}" for k in range(6) for p in ("m", "mb")] + order
    ops = list(jax.device_get(jm)) + list(jax.device_get(jk))
    assert len(ops) == len(order)
    for slot, op in zip(order, ops):
        op = np.asarray(op)
        got = (field.w(slot) if slot in W_SLOTS else field.b(slot)[:, None]).numpy()
        np.testing.assert_array_equal(got, op, err_msg=slot)
    assert not field.w("r1c").any() and field.w("r1c").shape == (1, 16)
    offs = field.offsets
    assert offs[W_SLOTS.index("rgb2")] == -1 and offs[len(W_SLOTS) + B_SLOTS.index("rgbb3")] == -1
    assert all(o % 16 == 0 for o in offs if o >= 0)


def test_tensor_core_fragments_hold_the_weights():
    """The tensor-core kernels' operand gather (``PackedField.tc``): every
    fragment value sits where csrc/tc_blocks.cuh's register layout of a
    64 x 16 wgmma A tile reads it — W^T for the forward, W for dx = W dy —
    and the padding up to 64 rows and 16 columns is zero."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import W_SLOTS

    _, field = _pair("lerp", deep_rgb=True, compute_dtype="bfloat16")
    frags, offsets = field.tc
    n_w = len(W_SLOTS)
    assert frags.dtype == torch.bfloat16 and offsets.shape == (len(field.offsets) + 2 * n_w,)
    f_offs = offsets[len(field.offsets):len(field.offsets) + n_w]
    g_offs = offsets[len(field.offsets) + n_w:]
    frags = frags.float().numpy()
    # thread t = 32 w + 4 q + p holds registers j = 0..3 of two values each:
    # row 16 w + q + 8 (j % 2), column 2 p + e + 8 (j // 2)
    t, j, e = np.meshgrid(np.arange(128), np.arange(4), np.arange(2), indexing="ij")
    rows = 16 * (t // 32) + (t % 32) // 4 + 8 * (j % 2)
    cols = 2 * (t % 4) + e + 8 * (j // 2)
    checked = 0
    for slot in W_SLOTS:
        if slot not in field.shapes:
            continue
        w = field.w(slot).float().numpy()
        for off, a in ((f_offs[W_SLOTS.index(slot)], w.T), (g_offs[W_SLOTS.index(slot)], w)):
            if w.shape[1] < 32:  # the 1- and 3-wide layers stay on CUDA cores
                assert off == -1, slot
                continue
            mp, kp = -(-a.shape[0] // 64) * 64, -(-a.shape[1] // 16) * 16
            padded = np.zeros((mp, kp), np.float32)
            padded[:a.shape[0], :a.shape[1]] = a
            got = frags[8 * off:8 * off + mp * kp].reshape(mp // 64, kp // 16, 128, 4, 2)
            for mt in range(mp // 64):
                for ks in range(kp // 16):
                    want = padded[64 * mt + rows, 16 * ks + cols]
                    np.testing.assert_array_equal(got[mt, ks], want, err_msg=slot)
            checked += 1
    # motion 0-4, trunk 1-4, s2a/b, s2w2/3 (the head is 16 wide here: thin)
    assert checked == 2 * 13
