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
F8_WIDTHS = (96, 48, 48)  # none a kernel width: packed at 128, 64, 64
WIDE_WIDTHS = (384, 192, 160)  # wider than 256: packed at 512, 256, 256


def _nets(mode, use_time, deep, widths=(W, HEAD, MOTION_W)):
    """-> (jax SpaceNet spec, params, MotionNet params or None; the port's
    SpaceNet and MotionNet with the same weights) at ``widths`` (trunk,
    head, motion)."""
    import jax

    from stnerf_tpu.models.motionnet import MotionNetSpec as JMSpec
    from stnerf_tpu.models.motionnet import init_motionnet
    from stnerf_tpu.models.spacenet import SpaceNetSpec as JSSpec
    from stnerf_tpu.models.spacenet import init_spacenet
    from stnerf_tpu_torch.models import (MotionNet, MotionNetSpec, SpaceNet,
                                         SpaceNetSpec, load_linears, load_spacenet)

    kw = dict(use_dir=True, use_time=use_time, deep_rgb=deep, backbone_dim=widths[0],
              head_dim=widths[1])
    jsspec = JSSpec(**kw)
    sparams = jax.device_get(init_spacenet(jax.random.PRNGKey(3), jsspec))
    net = load_spacenet(SpaceNet(SpaceNetSpec(**kw)), sparams)
    mparams, mnet = None, None
    if mode:
        mkw = dict(width=widths[2], input_time=mode == "lerp")
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


def _away_from_kinks(net, mnet, xyz, ids, dir_enc, tau=1e-5):
    """Per sample: whether every hidden pre-activation of the field (the
    motion net's, the trunk's and the rgb head's), evaluated in float64,
    lies more than ``tau`` x its layer's largest |pre-activation| from the
    ReLU's kink. Nearer, float32 round-off under another summation order
    (JAX's against the port's) flips the mask, which moves every gradient
    entry that sample feeds by its whole contribution; at wide layers and
    M = 200 one such sample takes a leaf beyond the bar."""
    import torch

    from stnerf_tpu_torch.ops.encoding import (lerp_encoded_time_planar,
                                               positional_encoding_planar)

    spec, pres = net.spec, []

    def mlp(layers, x, final):
        for i, layer in enumerate(layers):
            x = layer.weight.double() @ x + layer.bias.double()[:, None]
            if i < len(layers) - 1 or final:
                pres.append(x)
                x = torch.relu(x)
        return x

    def d(a):
        return torch.as_tensor(a, dtype=torch.float64)

    with torch.no_grad():
        enc = lerp_encoded_time_planar(d(xyz), d(ids[0]), mnet.spec.freqs,
                                       mnet.spec.include_input, True)
        p = positional_encoding_planar(d(xyz) + mlp(mnet.net, enc, False), spec.pos_freqs,
                                       spec.include_input, recursive=True)
        x = mlp(net.stage2, torch.cat([mlp(net.stage1, p, True), p]), True)
        t = positional_encoding_planar(d(ids), spec.time_freqs, spec.include_input,
                                       recursive=True)
        mlp(net.rgb, torch.relu(torch.cat([x, d(dir_enc), t])), False)
    margin = torch.stack([(q.abs() / q.abs().amax(1, keepdim=True)).amin(0) for q in pres])
    return (margin.amin(0) > tau).numpy()


def _assert_tree_close(got, ref):
    """Per leaf: rtol 2e-3, atol 2e-3 * max |leaf| (tests/test_kernels.py)."""
    import jax

    flat_r, tdef = jax.tree.flatten(ref)
    flat_g, gdef = jax.tree.flatten(got)
    assert tdef == gdef
    for a, b in zip(flat_g, flat_r):
        scale = max(1e-3, float(np.max(np.abs(b))))
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-3 * scale)


@pytest.mark.parametrize("mode,use_time,deep,widths", [
    pytest.param(None, False, False, None, id="None-False-False"),
    pytest.param("direct", False, False, None, id="direct-False-False"),
    pytest.param("lerp", True, False, None, id="lerp-True-False"),
    pytest.param("lerp", True, True, None, id="lerp-True-True"),
    pytest.param("lerp", True, False, F8_WIDTHS, id="lerp-True-False-f8"),
    pytest.param("lerp", True, False, WIDE_WIDTHS, id="lerp-True-False-wide")])
def test_trainable_field_matches_jax(rng, mode, use_time, deep, widths):
    """Value and every gradient through the port's autograd Function
    (plain forward and backward on the CPU) against JAX's VJP over the
    interpret-mode kernels; also at widths the CUDA kernels take only
    padded (F8), whose padded gradients are cut away, and at widths wider
    than 256 (packed at 512/256/256), which the backward kernels take with
    a smaller sample block."""
    jsspec, sparams, mparams, net, mnet = _nets(mode, use_time, deep,
                                                widths or (W, HEAD, MOTION_W))
    args = _inputs(rng, mode)
    if widths == WIDE_WIDTHS:  # no sample within float32 round-off of a ReLU kink
        keep = _away_from_kinks(net, mnet, *args[:3])
        assert keep.mean() > 0.75
        args = (*args[:3], args[3] * keep, args[4] * keep)
    v_j, g_j, _ = _jax_grads(jsspec, sparams, mparams, mode, *args)
    v_t, g_t, _ = _port_grads(net, mnet, mode, *args)
    np.testing.assert_allclose(v_t, v_j, rtol=2e-4)
    if not mode:
        g_j, g_t = (g_j[0], g_j[2], g_j[3]), (g_t[0], g_t[2], g_t[3])
    _assert_tree_close(g_t, g_j)
    if widths:  # the packed field's padding cut away: every leaf the model's shape
        import jax

        assert ([np.shape(a) for a in jax.tree.leaves(g_t)]
                == [np.shape(b) for b in jax.tree.leaves(g_j)])
        assert max(p.shape[0] for p in net.parameters()) == max(widths)


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


@pytest.mark.parametrize("k", [8, 256, 4096])
def test_tf32_split_products_against_float64(k):
    """ops.rounding's 3xTF32 helpers on seeded inputs: round_tf32 rounds to
    nearest with ties away from zero and clears the low 13 bits; the split
    leaves |x - hi - lo| <= 2^-21 |x|; tf32x3_matmul is within its stated
    bound (2^-19 + K 2^-24) (|a| @ |b|) of the float64 product, and closer
    to it than one TF32 product (hi_a hi_b) is."""
    import torch

    from stnerf_tpu_torch.ops.rounding import round_tf32, split_tf32, tf32x3_matmul

    one = 1.0 + 2.0 ** -11  # halfway between two TF32 values: away from zero
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -10 + 2.0 ** -11, 0.0, 3.0], dtype=torch.float32)
    assert round_tf32(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                      1.0 + 2.0 ** -9, 0.0, 3.0]
    rng = np.random.default_rng(k)
    a = torch.tensor((rng.normal(size=(48, k)) * np.exp(rng.normal(size=(48, k)))).astype(np.float32))
    b = torch.tensor(rng.normal(size=(k, 40)).astype(np.float32))
    for t in (a, b):
        hi, lo = split_tf32(t)
        assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
        err = (t.double() - hi.double() - lo.double()).abs()
        assert bool((err <= 2.0 ** -21 * t.double().abs()).all())
    ref = a.double() @ b.double()
    bound = (2.0 ** -19 + k * 2.0 ** -24) * (a.double().abs() @ b.double().abs())
    err3 = (tf32x3_matmul(a, b).double() - ref).abs()
    assert bool((err3 <= bound).all())
    err1 = (round_tf32(a).double() @ round_tf32(b).double() - ref).abs()
    assert float(err3.max()) < 0.1 * float(err1.max())


@pytest.mark.parametrize("mode,use_time,deep", [(None, False, False), ("lerp", True, True)])
def test_tf32x3_backward_matches_jax(rng, monkeypatch, mode, use_time, deep):
    """The float32 kernels' backward arithmetic on the CPU: the plain
    backward with every backward product (dx and dW) as 3xTF32
    (``ops.rounding.tf32x3_matmul``, a bound on the kernels: they keep the
    1- and 3-wide layers in float32) against JAX's float32
    ``field_planar_trainable`` (interpret mode) at the float32 bars."""
    import functools

    from stnerf_tpu_torch.kernels import field_vjp
    from stnerf_tpu_torch.ops.rounding import tf32x3_matmul

    monkeypatch.setattr(field_vjp, "field_bwd_reference",
                        functools.partial(field_vjp.field_bwd_reference, product=tf32x3_matmul))
    jsspec, sparams, mparams, net, mnet = _nets(mode, use_time, deep)
    args = _inputs(rng, mode)
    v_j, g_j, _ = _jax_grads(jsspec, sparams, mparams, mode, *args)
    v_t, g_t, _ = _port_grads(net, mnet, mode, *args)
    np.testing.assert_allclose(v_t, v_j, rtol=2e-4)
    if not mode:
        g_j, g_t = (g_j[0], g_j[2], g_j[3]), (g_t[0], g_t[2], g_t[3])
    _assert_tree_close(g_t, g_j)


# sha256 (first 16 hex digits) of f32_bwd.make_plan(...).array() without
# its block entry, as the plan before the block was chosen per launch made
# it: (mode, use_time, deep) at the test's widths, m = 700 and 8
# multiprocessors, then with slices of 8 blocks; and the taekwondo
# performer (256/128/128, "lerp" with time) at M = 240,000 on 132
PLAN_DIGESTS = {("direct", False, False): ("2e63ecad01984aa0", "b731d3476c7a481a"),
                ("lerp", True, True): ("a2af7b5626fb90c7", "b681b586a5821b08"),
                "taekwondo": "b7970d81a5db8f9d"}


def _digest(arr) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("mode,use_time,deep,widths", [
    pytest.param("direct", False, False, None, id="direct-False-False"),
    pytest.param("lerp", True, True, None, id="lerp-True-True"),
    pytest.param("lerp", True, False, (512, 256, 256), id="lerp-True-False-512"),
    pytest.param("lerp", True, False, (1024, 512, 512), id="lerp-True-False-1024")])
def test_f32_plan_layout_and_order(rng, monkeypatch, mode, use_time, deep, widths):
    """The float32 kernels' plan (kernels/f32_bwd.py) for K2's fields: the
    record block (64 samples at widths up to 256, 32 at 512, 16 at 1024:
    the largest whose pass-1 shared memory fits an H100's 227 KB); the
    record's tiles in REC_TILES order, packed in whole rows of the block;
    one pass-2 job per weight that has a gradient, on the tiles of its
    input and output cotangent, with its packed offsets and each bias once;
    the dx fragments in mma order, their rows padded to a kernel width up
    to 1024; the int array the C entry points read, at widths up to 256
    bitwise the array before the block was chosen per launch but for the
    block's entry. Then the fixed order, with slices of 8 blocks and two
    ranges or more each (one at the wide widths) at a ragged M: the ranges
    partition the blocks in
    order, each record lies in one skip-flag tile and takes its flag, and
    the plain backward summed range by range in that order is the one-shot
    plain backward to float32 round-off, the same bits when run again. At
    the wide widths and M = 240,000 on 132 multiprocessors, each slice's
    records stay within SLICE_BYTES."""
    import torch

    from stnerf_tpu_torch.kernels import f32_bwd
    from stnerf_tpu_torch.kernels.field_vjp import field_bwd_reference
    from stnerf_tpu_torch.kernels.fused_field import (B_SLOTS, TILE, W_SLOTS, pack_field,
                                                      prepare_kernel_params_planar,
                                                      prepare_motion_params_planar)

    if widths:  # random weights: the plan depends on the shapes alone
        from stnerf_tpu_torch.models import MotionNet, MotionNetSpec, SpaceNet, SpaceNetSpec

        gen = torch.Generator().manual_seed(0)
        net = SpaceNet(SpaceNetSpec(use_dir=True, use_time=use_time, deep_rgb=deep,
                                    backbone_dim=widths[0], head_dim=widths[1]), gen)
        mnet = MotionNet(MotionNetSpec(width=widths[2], input_time=mode == "lerp"), gen)
    else:
        _, _, _, net, mnet = _nets(mode, use_time, deep)
    field = pack_field(prepare_kernel_params_planar(net, torch.float32),
                       prepare_motion_params_planar(mnet, torch.float32), net.spec, mode,
                       "float32")
    m, sms = 700, 8
    rows = f32_bwd.record_rows(field)
    one = f32_bwd.make_plan(field, m, sms)
    block = {None: 64, 512: 32, 1024: 16}[widths and widths[0]]
    assert one.block == block and TILE % block == 0
    assert f32_bwd.pass1_smem_bytes(field, block) <= f32_bwd.SMEM_OPTIN
    if block < 64:  # the next larger block does not fit
        assert f32_bwd.pass1_smem_bytes(field, 2 * block) > f32_bwd.SMEM_OPTIN
    if widths is None:
        assert _digest(np.delete(one.array(), 4)) == PLAN_DIGESTS[mode, use_time, deep][0]
    monkeypatch.setattr(f32_bwd, "SLICE_BYTES", 4 * one.rec_floats * 8)
    plan = f32_bwd.make_plan(field, m, sms)
    if widths is None:
        assert _digest(np.delete(plan.array(), 4)) == PLAN_DIGESTS[mode, use_time, deep][1]

    # the record: the tiles present, packed in order, in rows of the block
    off = 0
    for i, name in enumerate(f32_bwd.REC_TILES):
        assert plan.tile[i] == (off if name in rows else -1), name
        off += rows.get(name, 0) * block
    assert plan.rec_floats == off
    # pass 2: every weight with a gradient once, each bias once
    n_w = field.weights.numel()
    names = f32_bwd.job_list(field)
    grads = {s for s, shape in field.shapes.items() if len(shape) == 2}
    if not use_time:
        grads.discard("r1c")
    assert sorted(w for w, _, _, _ in names) == sorted(grads)
    biases = [b for _, b, _, _ in names if b is not None]
    assert sorted(biases) == sorted(s for s, shape in field.shapes.items() if len(shape) == 1)
    for (w, b, x, y), job in zip(names, plan.jobs.tolist()):
        k_in, o = field.shapes[w]
        narrow = o <= f32_bwd.NARROW_O
        assert job == [plan.tile[f32_bwd.REC_TILES.index(x)], k_in,
                       plan.tile[f32_bwd.REC_TILES.index(y)], o,
                       field.offsets[W_SLOTS.index(w)],
                       -1 if b is None else n_w + field.offsets[len(W_SLOTS) + B_SLOTS.index(b)],
                       -(-k_in // (256 if narrow else 128)), 1 if narrow else -(-o // 128)]
        assert (rows[x], rows[y]) == (k_in, o)
    # the dx operands: layers of >= 8 outputs, rows padded, mma A order
    frags = field.dx_frags
    for slot, f_off in zip(W_SLOTS, plan.frag.tolist()):
        if f_off < 0:
            continue
        w = field.w(slot)
        k, o = w.shape
        kp = f32_bwd.padded_rows(k)
        tile = frags[f_off:f_off + kp * o].view(kp // 16, o // 8, 8, 4, 2, 2)
        t, s, g, q = (int(v) for v in rng.integers(0, [kp // 16, o // 8, 8, 4]))
        got = tile[t, s, g, q].reshape(-1).tolist()  # a0, a1, a2, a3
        want = [w[r, c] if r < k else 0.0 for c in (8 * s + q, 8 * s + q + 4)
                for r in (16 * t + g, 16 * t + g + 8)]
        assert got == [float(v) for v in want]
    arr = plan.array()
    assert arr.dtype == np.int32 and len(arr) == (f32_bwd.PLAN_HEAD + len(f32_bwd.REC_TILES)
                                                  + len(W_SLOTS) + f32_bwd.JOB_INTS * len(names))
    assert arr[:5].tolist() == [plan.rec_floats, plan.slice_blocks, plan.ranges, len(names),
                                block]
    assert plan.workspace_bytes == 4 * (plan.slice_blocks * plan.rec_floats
                                        + plan.n_slices * plan.ranges * (n_w + field.biases.numel()))
    assert [f32_bwd.padded_rows(k) for k in (27, 63, 84, 300, 512, 600, 1024)] == [
        32, 64, 128, 512, 512, 1024, 1024]

    # the fixed order: slices [0, 8) and the rest, two ranges or more each
    # (one at the wide widths: their dW tiles fill 8 multiprocessors' waves)
    n_blocks = -(-m // block)
    assert (plan.n_blocks, plan.slice_blocks, plan.n_slices) == (n_blocks, 8, -(-n_blocks // 8))
    assert plan.ranges >= (2 if widths is None else 1)
    spans = plan.record_ranges()
    assert [(s, r) for s, r, _, _ in spans] == [(s, r) for s in range(plan.n_slices)
                                                for r in range(plan.ranges)]
    assert spans[0][2] == 0 and spans[-1][3] == plan.n_blocks
    assert all(a[3] == b[2] for a, b in zip(spans, spans[1:]))
    xyz, ids, dir_enc, c_rgb, c_sig = (torch.tensor(a) for a in _inputs(rng, mode, m))
    flags = torch.tensor((rng.random(-(-m // TILE)) > 0.25).astype(np.int32))
    # record b (samples [b block, (b + 1) block)) lies in tile b // (TILE // block)
    rec_flag = flags[torch.arange(plan.n_blocks) // (TILE // block)]
    on = rec_flag.repeat_interleave(block)[:m].float()
    assert torch.equal(on, flags.repeat_interleave(TILE)[:m].float())

    def in_order():
        gw = gb = 0.0
        for _, _, b_lo, b_hi in spans:
            if b_lo == b_hi:  # an empty range: zero partials
                continue
            lo, hi = b_lo * block, min(b_hi * block, m)
            # a record whose flag is 0 adds nothing: zero cotangents
            part = field_bwd_reference(field, xyz[:, lo:hi], ids[:, lo:hi], dir_enc[:, lo:hi],
                                       c_rgb[:, lo:hi] * on[lo:hi], c_sig[lo:hi] * on[lo:hi])
            gw, gb = gw + part[0], gb + part[1]
        return gw, gb

    first, second = in_order(), in_order()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    ref = field_bwd_reference(field, xyz, ids, dir_enc, c_rgb, c_sig, flags)
    for a, b in zip(first, ref[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))

    if widths is None:  # the taekwondo performer, bitwise the former plan
        from stnerf_tpu_torch.models import MotionNet, MotionNetSpec, SpaceNet, SpaceNetSpec

        gen = torch.Generator().manual_seed(0)
        net = SpaceNet(SpaceNetSpec(use_dir=True, use_time=True), gen)
        mnet = MotionNet(MotionNetSpec(width=128, input_time=True), gen)
        field = pack_field(prepare_kernel_params_planar(net, torch.float32),
                           prepare_motion_params_planar(mnet, torch.float32), net.spec, "lerp",
                           "float32")
    monkeypatch.undo()
    big = f32_bwd.make_plan(field, 240_000, 132)
    if widths is None:
        assert big.block == 64 and _digest(np.delete(big.array(), 4)) == PLAN_DIGESTS["taekwondo"]
    else:  # records of whole waves of blocks, each slice within SLICE_BYTES
        assert big.block == block and big.n_blocks == 240_000 // block
        assert 4 * big.slice_blocks * big.rec_floats <= f32_bwd.SLICE_BYTES
        assert big.slice_blocks % 132 == 0 and big.n_slices >= 2


def _recorded_roundings(monkeypatch, modules: list) -> list:
    """Every ``round_to`` result of the given modules from here on, in call
    order (the plain versions round each activation to the compute dtype
    through their module's ``round_to``)."""
    from stnerf_tpu_torch.ops.rounding import round_to

    rounded = []

    def recording(x, dt):
        y = round_to(x, dt)
        rounded.append(y)
        return y

    for module in modules:
        monkeypatch.setattr(module, "round_to", recording)
    return rounded


@pytest.mark.parametrize("widths", [(W, HEAD, MOTION_W), WIDE_WIDTHS], ids=["narrow", "wide"])
def test_plain_backward_recomputes_the_forward(rng, monkeypatch, widths):
    """The plain bf16 backward (``field_bwd_reference``) recomputes, layer
    for layer, the very bf16 activations of the plain bf16 forward
    (``fused_field_reference``) on the same inputs, and so its ReLU masks:
    the motion net's encoding and five hidden layers, the encodings, the
    trunk's seven layers and the rgb head's hidden layers, bit for bit, at
    a narrow width and at 384/192/160 (packed at 512/256/256), a 4-layer
    rgb head with time. The bf16 backward kernels are held to the same
    property on the card (``chip_smoke.bwd_records_check``: their pass-1
    records are the k-order rounding, to which the training forward rounds
    every output it flags)."""
    import importlib

    import torch

    from stnerf_tpu_torch.kernels import field_vjp
    from stnerf_tpu_torch.models import MotionNet, MotionNetSpec, SpaceNet, SpaceNetSpec
    from stnerf_tpu_torch.ops.encoding import positional_encoding_planar

    # the module (the package's name fused_field is the function)
    ff = importlib.import_module("stnerf_tpu_torch.kernels.fused_field")
    gen = torch.Generator().manual_seed(11)
    net = SpaceNet(SpaceNetSpec(use_time=True, deep_rgb=True, backbone_dim=widths[0],
                                head_dim=widths[1]), gen)
    mnet = MotionNet(MotionNetSpec(width=widths[2], input_time=True), gen)
    field = ff.pack_field(ff.prepare_kernel_params_planar(net, torch.bfloat16),
                          ff.prepare_motion_params_planar(mnet, torch.bfloat16), net.spec,
                          "lerp", "bfloat16")
    m = M
    xyz = torch.tensor(rng.normal(size=(3, m)), dtype=torch.float32)
    ids = torch.tensor(rng.integers(1, 4, size=(1, m)) + 0.3, dtype=torch.float32)
    dir_enc = positional_encoding_planar(torch.tensor(rng.normal(size=(3, m)),
                                                      dtype=torch.float32), 4, True).contiguous()
    c_rgb = torch.tensor(rng.normal(size=(3, m)), dtype=torch.float32)
    c_sig = torch.tensor(rng.normal(size=m), dtype=torch.float32)

    rounded = _recorded_roundings(monkeypatch, [ff, field_vjp])
    ff.fused_field_reference(field, xyz, ids, dir_enc)
    fwd = list(rounded)
    rounded.clear()
    field_vjp.field_bwd_reference(field, xyz, ids, dir_enc, c_rgb, c_sig)
    # motion encoding, u1-u5, time, position and direction encodings, a0-a6,
    # the rgb head's hidden layers; the backward then rounds its cotangents
    assert len(fwd) == 1 + 5 + 3 + 7 + field.n_rgb - 1
    assert len(rounded) > len(fwd)
    for i, (a, b) in enumerate(zip(fwd, rounded)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"rounded activation {i} differs"
        assert torch.equal(a > 0, b > 0)
