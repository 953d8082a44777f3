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
from test_torch_data import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.isolate

M = 200        # samples: not a multiple of either package's tile
JAX_TILE = 128
WIDTHS = (32, 16, 32)     # trunk, head, motion: the head packs at 32
F8_WIDTHS = (96, 48, 48)  # none a kernel width: packed at 128, 64, 64
WIDE_WIDTHS = (384, 192, 160)  # packed at 512, 256, 256: a smaller sample block


def _pair(motion_mode, deep_rgb=False, compute_dtype="float32", widths=WIDTHS):
    """-> (jax fused_field args, port PackedField) for one field of a tiny
    layered model of ``widths`` (trunk, head, motion): the background
    (motion None or "direct") or performer 1 ("lerp", with a time input)."""
    import jax

    from stnerf_tpu.kernels import prepare_kernel_params_planar as jprep
    from stnerf_tpu.kernels.fused_field import prepare_motion_params_planar as jmprep
    from stnerf_tpu.models import LayeredSpec as JSpec
    from stnerf_tpu.models import init_layered_params
    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec, load_jax_params

    kw = dict(layer_num=2, coarse_samples=8, fine_samples=4,
              use_space_time=True, use_deform_time=True,
              bkgd_use_deform_time=motion_mode == "direct", deep_rgb=deep_rgb,
              backbone_dim=widths[0], head_dim=widths[1], motion_dim=widths[2])
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


@pytest.mark.parametrize("motion_mode,widths", [
    pytest.param(None, WIDTHS, id="None"), pytest.param("direct", WIDTHS, id="direct"),
    pytest.param("lerp", WIDTHS, id="lerp"), pytest.param("lerp", F8_WIDTHS, id="lerp-f8"),
    pytest.param("lerp", WIDE_WIDTHS, id="lerp-wide")])
def test_reference_matches_jax_kernel(rng, motion_mode, widths):
    """The port's plain version on the packed field against JAX's kernel,
    also at widths the CUDA kernels take only padded (F8: 96/48/48) and at
    widths the forward kernels take with a smaller sample block
    (384/192/160, packed at 512/256/256)."""
    from stnerf_tpu_torch.kernels.fused_field import kernel_width

    jargs, field = _pair(motion_mode, widths=widths)
    assert (field.width, field.head) == tuple(kernel_width(w) for w in widths[:2])
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
    dummy of a field without time), each 16-element aligned, in the model's
    own shape within its operand at the kernel widths (the 16-wide head
    packed at 32, zeros beyond)."""
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
        packed = field.w(slot) if slot in W_SLOTS else field.b(slot)
        got = field.cut(slot, packed)
        np.testing.assert_array_equal(got.reshape(op.shape).numpy(), op, err_msg=slot)
        rest = packed.clone()
        field.cut(slot, rest).zero_()
        assert not rest.any(), slot  # zeros beyond the model's shape
    assert not field.w("r1c").any() and field.w("r1c").shape == (1, 32)
    assert field.model_shapes["r1c"] == (1, 16) and field.shapes["r1a"] == (32, 32)
    offs = field.offsets
    assert offs[W_SLOTS.index("rgb2")] == -1 and offs[len(W_SLOTS) + B_SLOTS.index("rgbb3")] == -1
    assert all(o % 16 == 0 for o in offs if o >= 0)


def test_padded_pack_and_gradient_map():
    """F8: a field of widths outside KERNEL_WIDTHS (96/48/48) packs at the
    next kernel widths, every padded entry zero and every real one its
    operand's; ``_linear_grads`` hands each nn.Linear a gradient of its own
    shape, cut from the packed one; a field already at kernel widths packs
    as the unpadded layout (each operand in slot order, 16-element aligned,
    nothing else); the kernels' width check passes every padded width up to
    1024 (300 packs at 512, 600 at 1024) and refuses 1025, and so does the
    backward kernels' (``check_backward_support``): they train every width
    the forward kernels take."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import (B_SLOTS, W_SLOTS, _field_linears,
                                                      _linear_grads, check_backward_support,
                                                      check_forward_widths,
                                                      pack_field, prepare_kernel_params_planar,
                                                      prepare_motion_params_planar)
    from stnerf_tpu_torch.models import MotionNet, MotionNetSpec, SpaceNet, SpaceNetSpec

    order = ["w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4", "s2a", "s2b", "sb1", "s2w2",
             "sb2", "s2w3", "sb3", "dw", "db", "r1a", "r1b", "r1c", "rb1", "rgb1", "rgbb1"]
    order += [f"{p}{k}" for k in range(6) for p in ("m", "mb")]

    def build(w, h, mw):
        gen = torch.Generator().manual_seed(w)
        net = SpaceNet(SpaceNetSpec(use_dir=True, use_time=True, backbone_dim=w, head_dim=h),
                       gen)
        motion = MotionNet(MotionNetSpec(width=mw, input_time=True), gen)
        ops = (*prepare_kernel_params_planar(net, torch.float32),
               *prepare_motion_params_planar(motion, torch.float32))
        field = pack_field(ops[:-12], ops[-12:], net.spec, "lerp", "float32")
        return net, motion, dict(zip(order, ops)), field

    net, motion, ops, field = build(*F8_WIDTHS)
    assert (field.width, field.head, field.motion_width) == (128, 64, 64)
    check_forward_widths([field.width, field.head, field.motion_width])
    check_backward_support(field)
    for slot, op in ops.items():
        packed = field.w(slot) if slot in W_SLOTS else field.b(slot)
        assert tuple(packed.shape) == field.shapes[slot], slot
        assert torch.equal(field.cut(slot, packed), op.reshape(field.model_shapes[slot])), slot
        rest = packed.clone()
        field.cut(slot, rest).zero_()
        assert not rest.any(), slot
    gw = torch.randn(field.weights.shape, generator=torch.Generator().manual_seed(1))
    gb = torch.randn(field.biases.shape, generator=torch.Generator().manual_seed(2))
    grads = _linear_grads(field, gw, gb)
    layers = _field_linears(net, motion)
    assert len(grads) == len(layers)
    for (d_w, d_b), layer in zip(grads, layers):
        assert d_w.shape == layer.weight.shape and d_b.shape == layer.bias.shape
    assert torch.equal(grads[1][0], gw[field.offsets[W_SLOTS.index("w2")]:][:128 * 128]
                       .view(128, 128)[:96, :96].t())

    for widths in ((32, 32, 32), (64, 32, 128)):  # kernel widths: the unpadded layout
        _, _, ops, field = build(*widths)
        assert field.shapes == field.model_shapes
        for slots, buf in ((W_SLOTS, field.weights), (B_SLOTS, field.biases)):
            parts = [ops[s].reshape(-1) for s in slots if s in ops]
            want = torch.cat([torch.cat([t, t.new_zeros(-t.numel() % 16)]) for t in parts])
            assert torch.equal(buf, want)
    for w in (1, 5, 33, 200, 256):
        field = build(w, w, w)[3]
        check_forward_widths([field.width, field.head, field.motion_width])
        check_backward_support(field)
    for w, packed in ((300, 512), (600, 1024)):
        field = build(w, 48, 48)[3]
        assert field.width == packed
        check_forward_widths([field.width, field.head, field.motion_width])
        check_backward_support(field)
    with pytest.raises(ValueError, match="at most 1024"):
        check_forward_widths([build(1025, 48, 48)[3].width])
    with pytest.raises(ValueError, match="at most 1024"):
        check_backward_support(build(1025, 48, 48)[3])


def test_tensor_core_fragments_hold_the_weights():
    """The tensor-core kernels' operand gather (``PackedField.tc``): every
    fragment value sits where csrc/tc_blocks.cuh's register layout of a
    64 x 16 wgmma A tile reads it — W^T for the forward, W for dx = W dy —
    and the padding up to 64 rows and 16 columns is zero. The offsets end
    with each slot's first row in ``PackedField.tc_norms``: the checked
    products' slots (those with forward fragments), their output rows one
    after another in slot order (``_norm_jobs``)."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import W_SLOTS, _norm_jobs

    _, field = _pair("lerp", deep_rgb=True, compute_dtype="bfloat16")
    frags, offsets = field.tc
    n_w, n = len(W_SLOTS), len(field.offsets)
    assert frags.dtype == torch.bfloat16 and offsets.shape == (n + 3 * n_w,)
    f_offs = offsets[n:n + n_w]
    g_offs = offsets[n + n_w:n + 2 * n_w]
    n_offs, jobs = _norm_jobs(field)
    np.testing.assert_array_equal(offsets[n + 2 * n_w:], n_offs)
    assert ((n_offs >= 0) == (f_offs >= 0)).all()
    slots = [s for s, o in zip(W_SLOTS, n_offs) if o >= 0]
    assert [tuple(j) for j in jobs] == [
        (field.offsets[W_SLOTS.index(s)], *field.shapes[s]) for s in slots]
    np.testing.assert_array_equal(n_offs[n_offs >= 0], np.cumsum([0, *jobs[:-1, 2]]))
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
    # motion 0-4, trunk 1-4, s2a/b, s2w2/3, and the head's r1a/b/c and
    # rgb1/2 (16 wide in the model, packed at 32)
    assert checked == 2 * 18


def test_taps_refused_off_the_cards_checked_bf16_route(rng):
    """The taps (a check's read-back of the checked bf16 forward's
    activations, ``chip_smoke.fwd_taps``) are taken on the card's checked
    tensor-core route only: ``fused_field`` refuses them on CPU tensors in
    either dtype, checked or not, and ``spacenet_fwd`` on CPU tensors; the
    shared check refuses a CUDA tensor of the float32 or the unchecked
    route and passes the checked bf16 one. Nothing launches."""
    import torch

    from stnerf_tpu_torch.kernels.fused_field import _check_taps, fused_field
    from stnerf_tpu_torch.kernels.spacenet_vjp import spacenet_fwd

    taps = torch.empty(16, dtype=torch.uint8)
    xyz, ids, dir_enc = (torch.tensor(a) for a in _inputs(rng, "lerp"))
    for dt in ("float32", "bfloat16"):
        field = _pair("lerp", compute_dtype=dt)[1]
        for checked in (False, True):
            with pytest.raises(ValueError, match="taps"):
                fused_field(field, xyz, ids, dir_enc, checked=checked, taps=taps)
    space = _pair(None, compute_dtype="bfloat16")[1]
    pos, time = (torch.tensor(rng.normal(size=(space.shapes[s][0], M)).astype(np.float32))
                 for s in ("w1", "r1c"))
    with pytest.raises(ValueError, match="taps"):
        spacenet_fwd(space, pos, dir_enc, time if space.spec.use_time else None, taps=taps)
    cuda = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="taps"):
        _check_taps(taps, False, cuda, "fused_field")
    _check_taps(taps, True, cuda, "fused_field")
    _check_taps(None, False, torch.device("cpu"), "fused_field")
    assert fused_field.launches == spacenet_fwd.launches == 0
