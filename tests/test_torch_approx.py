"""The port's inference approximations against the JAX package's on the CPU:
``sort_samples_planar`` and ``stratified_union``, the early-exit coarse
march, the fast fine stage, sliced boxes with the gap skip
(``models/layered.render_rays``), the occupancy refinement
(``render/occupancy.py``) and the renderer's fidelity gate.

The JAX side runs its XLA field path on the CPU, which skips no ray: it
evaluates every early-exited and every fast-fine-skipped sample, where the
port's K1 (its plain version here) writes zeros for a skipped 64-sample
tile. So at ``EARLY_EXIT_EPS = FAST_FINE_EPS = 0``, with the densities
raised so that every hit ray has opacity > 0, the two must agree to float32
round-off (>= 60 dB, hit masks equal); at the default eps the port is held
to the eps contract of ``config/defaults.py``. Shapes as
tests/test_torch_render.py (L=2, 16+8 samples, width 32, 48 rays). Every
test runs in a fresh child process (``isolate``).
"""

import dataclasses
import logging
import os

import numpy as np
import pytest

from test_torch_render import TARGET_DB, _cfg, _rays, _scene
from test_torch_data import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.isolate

EPS = 1e-3      # FAST_FINE_EPS and EARLY_EXIT_EPS at their defaults
F32_TOL = 1e-4  # the packages' encodings differ by float32 round-off


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def test_sort_and_stratified_union_match_jax(monkeypatch):
    """``sort_samples_planar`` on seeded (L, N, S) samples with ties carries
    the payload as JAX's does (composites equal to 1e-6; sorted depths
    equal); ``stratified_union`` on seeded slice intervals with misses,
    duplicate slices, contained and overlapping slices, deterministic and
    with every draw at the last float32 below 1 (the ``1 - 2**-20`` clamp):
    equal to JAX's within 1e-5 relative, inside the union, ascending."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.ops import sampling as jsampling
    from stnerf_tpu.ops.volume import sort_samples_planar as jsort
    from stnerf_tpu.ops.volume import volume_render_planar as jrender
    from stnerf_tpu_torch.ops import sampling
    from stnerf_tpu_torch.ops.volume import sort_samples_planar, volume_render_planar

    rng = np.random.default_rng(0)
    L, N, S = 3, 40, 12
    t = rng.uniform(1.0, 5.0, (L, N, S)).astype(np.float32)
    t[:, :, 6] = t[:, :, 2]                              # ties inside a ray
    rgb = rng.normal(size=(L, 3, N, S)).astype(np.float32)
    sig = rng.uniform(0.0, 2.0, (L, N, S)).astype(np.float32)
    got = sort_samples_planar(*map(torch.tensor, (t, rgb, sig)))
    ref = jsort(*map(jnp.asarray, (t, rgb, sig)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert (np.diff(got[0].numpy(), axis=-1) >= 0).all()
    for a, b in zip(volume_render_planar(*got)[:3],
                    jax.vmap(jrender)(*ref)[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)

    n, K, num = 64, 4, 16
    lo = rng.uniform(1.0, 8.0, (n, K)).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 3.0, (n, K))).astype(np.float32)
    hit = rng.uniform(size=(n, K)) > 0.3
    hit[0] = False                                       # a ray missing every slice
    lo[1, 1], hi[1, 1] = lo[1, 0], hi[1, 0]              # a duplicate slice
    lo[2, 1], hi[2, 1] = lo[2, 0] + 0.1, hi[2, 0] - 0.05  # a contained one
    hit[1:3, :2] = True
    lo_m, hi_m = (np.where(hit, x, jsampling.MISS_T).astype(np.float32) for x in (lo, hi))

    def check(a, b):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        assert (a[0] == jsampling.MISS_T).all()
        assert (np.diff(a[1:], axis=-1) >= 0).all()
        inside = ((a[1:, :, None] >= lo_m[1:, None] - 1e-5)
                  & (a[1:, :, None] <= hi_m[1:, None] + 1e-5) & hit[1:, None])
        assert inside.any(-1).all()

    args = (lo_m, hi_m, hit)
    check(sampling.stratified_union(*map(torch.tensor, args), num).numpy(),
          np.asarray(jsampling.stratified_union(*map(jnp.asarray, args), num, None)))
    worst = np.float32(1.0) - np.float32(2.0) ** -24
    monkeypatch.setattr(sampling, "_uniform",
                        lambda shape, like, gen: torch.full(shape, float(worst)))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=jnp.float32: jnp.full(shape, worst, dtype))
    got = sampling.stratified_union(*map(torch.tensor, args), num, torch.Generator())
    check(got.numpy(), np.asarray(jsampling.stratified_union(
        *map(jnp.asarray, args), num, jax.random.PRNGKey(0))))


def _pair(cfg, dense: bool = False, fine_delta: float = 0.05, layer1=None):
    """The JAX spec and params and the port's model on them, from ``cfg``
    (test_torch_render._models' density raise: +0.3 background, +2
    performers; ``dense``: +3 and +12, so that the background and the
    performers saturate within the first coarse segment). The fine nets are
    the coarse nets plus seeded noise of ``fine_delta`` on every weight, so
    that the fast fine stage differs from the exact one. ``layer1`` (w
    scale, bias): performer 1's density head in both nets, its weights
    scaled and its bias set."""
    import jax

    from stnerf_tpu.models import LayeredSpec as JSpec
    from stnerf_tpu.models import init_layered_params
    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec, load_jax_params

    jspec = JSpec.from_cfg(cfg)
    params = jax.tree.map(np.array, jax.device_get(
        init_layered_params(jax.random.PRNGKey(0), jspec)))
    rng = np.random.default_rng(1)
    for group in ("bkgd_fine", "layers_fine"):
        params[group] = jax.tree.map(
            lambda a: (a + fine_delta * rng.normal(size=a.shape)).astype(np.float32),
            params[group])
    for group, delta in (("bkgd_coarse", 3.0 if dense else 0.3),
                         ("bkgd_fine", 3.0 if dense else 0.3),
                         ("layers_coarse", 12.0 if dense else 2.0),
                         ("layers_fine", 12.0 if dense else 2.0)):
        params[group]["density"][0]["b"] = params[group]["density"][0]["b"] + delta
        if layer1 is not None and group.startswith("layers"):
            params[group]["density"][0]["w"][0] *= layer1[0]
            params[group]["density"][0]["b"][0] = layer1[1]
    model = load_jax_params(LayeredModel(LayeredSpec.from_cfg(cfg), device="cpu"), params)
    return jspec, params, model


def _render_both(cfg, jscene, scene_np, frame_ids=(2.0, 2.0, 1.5), edits=None,
                 **pair_kw):
    """The JAX and the port's render_rays on the same rays, deterministic
    sampling, with ``edits`` ({EditState field: value}, default none) ->
    (jax outputs, port outputs, port model, port inputs, port scene),
    outputs as numpy."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.models import EditState as JEdit
    from stnerf_tpu.models import RayInputs as JRays
    from stnerf_tpu.models import SceneBoxes as JScene
    from stnerf_tpu.models import render_rays as jrender
    from stnerf_tpu_torch import models as T

    jspec, params, model = _pair(cfg, **pair_kw)
    rays = _rays(list(frame_ids))
    edits = {k: np.asarray(v, np.float32) for k, v in (edits or {}).items()}
    jedit = JEdit.identity(2)._replace(**{k: jnp.asarray(v) for k, v in edits.items()})
    tedit = T.EditState.identity(2)._replace(**{k: torch.tensor(v) for k, v in edits.items()})
    ref = jax.jit(jrender, static_argnames=("spec",))(params, jspec, JScene(*map(jnp.asarray, jscene)),
                  JRays(*map(jnp.asarray, rays)), jedit, key=None)
    scene = T.SceneBoxes(*map(torch.tensor, scene_np))
    inputs = T.RayInputs(*map(torch.tensor, rays))
    out = T.render_rays(model, scene, inputs, tedit)
    to_np = lambda tree: type(tree)(*(to_np(x) if isinstance(x, tuple) else np.asarray(x)
                                      for x in tree))
    return to_np(ref), to_np(out), model, inputs, scene


def _assert_close_db(out, ref, what):
    assert np.array_equal(out.hit, ref.hit), f"{what}: hit masks differ"
    for name, a, b in (("fine", out.fine.color, ref.fine.color),
                       ("coarse", out.coarse.color, ref.coarse.color),
                       ("fine_layers", out.fine_layers.color, ref.fine_layers.color),
                       ("coarse_layers", out.coarse_layers.color, ref.coarse_layers.color),
                       ("fine_acc", out.fine.acc, ref.fine.acc),
                       ("fine_layers_acc", out.fine_layers.acc, ref.fine_layers.acc)):
        db = _psnr(a, b)
        assert db >= TARGET_DB, f"{what} {name}: {db:.1f} dB < {TARGET_DB}"


@pytest.mark.parametrize("case", ["march", "fast_fine", "sliced", "edits"])
def test_approx_render_matches_jax(case, monkeypatch):
    """The port's render_rays against JAX's with the approximation of each
    case on.

    march: EARLY_EXIT_SEGMENTS = 3. At eps 0 the port's segmented march
    equals its single dispatch bitwise, and JAX's render >= 60 dB, hit masks
    equal. At the default eps on a dense model (saturating in the first
    segment) K1 skips tiles of the later segments, and each per-layer coarse
    colour and acc stays within eps (+1e-4 float32) of JAX's, which skips
    nothing (the contract of config/defaults.py: the skipped samples could
    add at most eps to a layer's output).

    fast_fine: FAST_FINE on, fine nets differing from coarse nets. At eps 0
    >= 60 dB against JAX. At the default eps with performer 1 faint (coarse
    opacity < eps on every ray, so its fine samples are skipped) each
    per-layer fine colour and acc within eps (+1e-4) of JAX's, and the
    merged pixel within 2 eps (the skipped matter's own emission and the
    transmittance it would take from what lies behind it).

    edits: the approximations on at eps 0, the fine nets apart from the
    coarse ones, with a hidden performer, a shift, a scale and an alpha
    fade: each >= 60 dB, hit masks equal.

    sliced: (F, L, K, 2, 3) boxes, each performer box cut in two with a gap,
    with OCC_GAP_SKIP off (the hull of the hit slices) and on (the union of
    the slices), the approximations on at eps 0: >= 60 dB, hit masks equal
    (tests/test_torch_render.py renders duplicate slices bitwise as their
    box)."""
    import torch

    from stnerf_tpu_torch import models as T
    from stnerf_tpu_torch.models import layered

    bkgd, boxes, nf = _scene()
    cfg = _cfg()
    cfg.TPU.EARLY_EXIT_EPS = 0.0
    cfg.TPU.FAST_FINE_EPS = 0.0
    if case == "march":
        cfg.TPU.EARLY_EXIT_SEGMENTS = 3
        ref, out, model, inputs, scene = _render_both(cfg, (bkgd, boxes, nf),
                                                      (bkgd, boxes, nf))
        _assert_close_db(out, ref, "eps 0")
        single = T.render_rays(model, scene, inputs, T.EditState.identity(2),
                               spec=dataclasses.replace(model.spec, coarse_exit_segments=0))
        for a, b in zip(single, T.render_rays(model, scene, inputs, T.EditState.identity(2))):
            for x, y in zip(a if isinstance(a, tuple) else [a], b if isinstance(b, tuple) else [b]):
                assert torch.equal(x, y), "segmented march at eps 0 != single dispatch"

        cfg.TPU.EARLY_EXIT_EPS = EPS
        flags = []
        real = layered.fused_field
        monkeypatch.setattr(layered, "fused_field",
                            lambda f, x, i, d, fl=None: flags.append(fl) or real(f, x, i, d, fl))
        ref, out, *_ = _render_both(cfg, (bkgd, boxes, nf), (bkgd, boxes, nf), dense=True)
        assert np.array_equal(out.hit, ref.hit)
        skipped = [int((f == 0).sum()) for f in flags]
        # launches by segment, three fields each, then the fine stage's: the
        # background skips tiles in segments 2 and 3 that segment 1 ran
        assert skipped[3] > skipped[0] and skipped[6] > skipped[0], skipped
        for name in ("color", "acc"):
            err = np.abs(getattr(out.coarse_layers, name) - getattr(ref.coarse_layers, name))
            assert err.max() <= EPS + F32_TOL, f"coarse_layers.{name}: {err.max():.2e}"
        return

    cfg.TPU.FAST_FINE = True
    cfg.TPU.EARLY_EXIT_SEGMENTS = 3
    if case == "fast_fine":
        ref, out, *_ = _render_both(cfg, (bkgd, boxes, nf), (bkgd, boxes, nf))
        _assert_close_db(out, ref, "eps 0")
        exact = _render_both(_cfg(), (bkgd, boxes, nf), (bkgd, boxes, nf))[1]
        assert _psnr(out.fine.color, exact.fine.color) < 100, "fast fine == exact"
        cfg.TPU.EARLY_EXIT_SEGMENTS = 0
        cfg.TPU.FAST_FINE_EPS = EPS
        # performer 1 faint (density ~ +-1e-5 about 0, relu'd): a hit ray
        # whose last coarse sample is empty has opacity < eps (the border
        # delta makes any density there opaque) and skips its fine samples
        ref, out, *_ = _render_both(cfg, (bkgd, boxes, nf), (bkgd, boxes, nf),
                                    layer1=(1e-3, 0.0))
        acc_c = out.coarse_layers.acc[1][out.hit[1]]
        assert ((acc_c > 0) & (acc_c <= EPS)).any(), acc_c.ravel()
        for name in ("color", "acc"):
            err = np.abs(getattr(out.fine_layers, name) - getattr(ref.fine_layers, name))
            assert err.max() <= EPS + F32_TOL, f"fine_layers.{name}: {err.max():.2e}"
            err = np.abs(getattr(out.fine, name) - getattr(ref.fine, name))
            assert err.max() <= 2 * EPS + F32_TOL, f"fine.{name}: {err.max():.2e}"
        # performer 1 empty (density 0): its fine launch skips every tile
        flags = []
        real = layered.fused_field
        monkeypatch.setattr(layered, "fused_field",
                            lambda f, x, i, d, fl=None: flags.append(fl) or real(f, x, i, d, fl))
        ref, out, *_ = _render_both(cfg, (bkgd, boxes, nf), (bkgd, boxes, nf),
                                    layer1=(1e-3, -1.0))
        assert out.hit[1].any() and flags[1].any() and not flags[4].any()
        _assert_close_db(out, ref, "empty performer")
        return

    if case == "edits":
        for name, edit in (("hide", {"visible": [1, 0, 1]}),
                           ("shift", {"shift": [[0, 0, 0], [0, 0.4, 0], [0, -0.4, 0]]}),
                           ("scale", {"scale": [1, 1.3, 0.8]}),
                           ("alpha", {"alpha": [1, 0.5, 0.7]})):
            ref, out, *_ = _render_both(cfg, (bkgd, boxes, nf), (bkgd, boxes, nf),
                                        edits=edit)
            _assert_close_db(out, ref, name)
            if name == "hide":
                assert out.hit[1].any() and not out.fine_layers.acc[1].any()
        return

    # sliced: each performer box split along x into two slices with a gap
    lo, hi = boxes[..., 0, :], boxes[..., 1, :]
    mid = 0.5 * (lo[..., 0] + hi[..., 0])
    sliced = np.repeat(boxes[:, :, None], 2, axis=2)
    sliced[:, :, 0, 1, 0] = mid - 0.3
    sliced[:, :, 1, 0, 0] = mid + 0.2
    for gap_skip in (False, True):
        cfg.TPU.OCC_GAP_SKIP = gap_skip
        ref, out, *_ = _render_both(cfg, (bkgd, sliced, nf), (bkgd, sliced, nf))
        _assert_close_db(out, ref, f"gap skip {gap_skip}")
        assert out.hit[1:].any() and not out.hit[1:].all()


def test_refine_scene_boxes_matches_jax(tmp_path):
    """``render/occupancy.py`` against the JAX package's on one small model
    (the JAX occupancy tests' spec; the performers' density head scaled x40
    and its bias raised by 1, so that a few percent of the lattice is
    occupied):
    the NumPy helpers give bitwise the same results on the same cube; the
    relu(sigma) cubes agree to float16 rounding (2^-10 relative, 1e-3 of the
    cube's max absolute); refined boxes at a manual tau, at an auto tau and
    in two slices lie within one voxel per face of JAX's; tau 0 returns
    every box exactly, its slices tile the box, and a render on them equals
    the render on the original boxes bitwise; the cache writes an
    ``occ_boxes_torch_`` file and reads it back; K1's "lerp" and "direct"
    motion modes agree bitwise at integer frame ids."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.models import LayeredSpec as JSpec
    from stnerf_tpu.models import SceneBoxes as JScene
    from stnerf_tpu.models import init_layered_params
    from stnerf_tpu.render import occupancy as jocc
    from stnerf_tpu_torch import models as T
    from stnerf_tpu_torch.kernels.fused_field import (fused_field_reference, pack_field,
                                                      prepare_kernel_params_planar,
                                                      prepare_motion_params_planar)
    from stnerf_tpu_torch.render import occupancy as occ

    kw = dict(layer_num=2, coarse_samples=8, fine_samples=4, sample_method="BBOX",
              use_space_time=True, use_deform_time=True, backbone_dim=16, head_dim=8,
              motion_dim=8, compute_dtype="float32")
    jspec, spec = JSpec(**kw), T.LayeredSpec(**kw)
    params = jax.tree.map(np.array, jax.device_get(
        init_layered_params(jax.random.PRNGKey(0), jspec)))
    for group in ("layers_coarse", "layers_fine"):
        params[group]["density"][0]["w"] = params[group]["density"][0]["w"] * 40.0
        params[group]["density"][0]["b"] = params[group]["density"][0]["b"] + 1.0
    model = T.load_jax_params(T.LayeredModel(spec, device="cpu"), params)
    grid = 8
    boxes = np.zeros((3, 2, 2, 3), np.float32)
    for f in (1, 2):  # frame 0: a FRAME_OFFSET zero row
        boxes[f, 0] = [[-1 + 0.1 * f, -1, 1], [1 + 0.1 * f, 1, 3]]
        boxes[f, 1] = [[-1, 2, 1], [1, 4, 3]]
    bkgd, nf = np.array([[-6.0] * 3, [6.0] * 3], np.float32), np.array([0.5, 12.0], np.float32)
    jscene = JScene(*map(jnp.asarray, (bkgd, boxes, nf)))
    scene = T.SceneBoxes(*map(torch.tensor, (bkgd, boxes, nf)))

    # the cubes, and the NumPy helpers on one cube
    box = boxes[1, 0]
    ref = np.asarray(jocc._occupancy_cube(jocc._layer_net_params(params, jspec, 1), jspec,
                                          jnp.asarray(box), jnp.float32(2.0), bkgd=False,
                                          grid=grid), np.float32)
    got = occ._occupancy_cube(model, 1, box, 2.0, grid)
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -10, atol=1e-3 * ref.max())
    assert ref.max() > 0.3 and (ref < 0.1).any()
    def same(a, b):
        if isinstance(a, tuple):
            assert isinstance(b, tuple) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    occ_cube = got >= np.median(got)
    for name, args in (("auto_tau", (got, box, grid, 1, 1e-2)),
                       ("auto_slice_tau", (got, box, 0, 2, grid, 1, 1e-2)),
                       ("_extent_from_cube", (occ_cube,)),
                       ("_hull_keep_mask", (occ_cube, grid, 1)),
                       ("_culled_alpha_bound", (got, occ_cube, box, grid)),
                       ("_slice_boxes", (box, occ_cube, 1, 3, grid, 1)),
                       ("_boxes_keep_mask", (box, boxes[1], grid)),
                       ("_shrink", (box, [1, 2, 0], [5, 6, 7], grid, 1)),
                       ("_eps_alpha", (40.0,))):
        same(getattr(occ, name)(*args), getattr(jocc, name)(*args))

    # refined boxes within one voxel per face; tau 0 exact
    voxel = (boxes[:, :, 1] - boxes[:, :, 0]) / grid              # (F, L, 3)
    shrunk = False
    for knobs in (dict(sigma_thresh=0.3), dict(auto_tau_db=40.0),
                  dict(sigma_thresh=0.3, slices=2)):
        a = occ.refine_scene_boxes(model, scene, grid=grid, **knobs)
        b = jocc.refine_scene_boxes(params, jspec, jscene, grid=grid, **knobs)
        a_b, b_b = a.boxes.numpy(), np.asarray(b.boxes)
        assert a_b.shape == b_b.shape, knobs
        v = voxel[:, :, None, None] if a_b.ndim == 5 else voxel[:, :, None]
        assert (np.abs(a_b - b_b) <= v + 1e-6).all(), knobs
        np.testing.assert_array_equal(a.bkgd_box.numpy(), np.asarray(b.bkgd_box))
        shrunk |= bool((a_b[1:] != boxes[1:, :, None] if a_b.ndim == 5
                        else a_b[1:] != boxes[1:]).any())
    assert shrunk, "no box shrank: the comparison would be vacuous"
    exact = occ.refine_scene_boxes(model, scene, grid=grid, sigma_thresh=0.0)
    np.testing.assert_array_equal(exact.boxes.numpy(), boxes)
    np.testing.assert_array_equal(exact.bkgd_box.numpy(), bkgd)
    tiled = occ.refine_scene_boxes(model, scene, grid=grid, sigma_thresh=0.0, slices=3)
    tb = tiled.boxes.numpy()
    assert tb.shape == (3, 2, 3, 2, 3)
    np.testing.assert_array_equal(tb.min(2)[1:, :, 0], boxes[1:, :, 0])
    np.testing.assert_array_equal(tb.max(2)[1:, :, 1], boxes[1:, :, 1])
    rays = T.RayInputs(*map(torch.tensor, _rays([2.0] * 3, n=24)))
    a = T.render_rays(model, scene, rays, T.EditState.identity(2))
    b = T.render_rays(model, tiled, rays, T.EditState.identity(2))
    assert torch.equal(a.fine.color, b.fine.color) and torch.equal(a.hit, b.hit)

    # the cache, under the port's own prefix
    ckpt = tmp_path / "ckpt.pt"
    ckpt.write_bytes(b"x")
    first = occ.refined_boxes_cached(model, scene, str(tmp_path), str(ckpt), grid=grid,
                                     sigma_thresh=0.5)
    (name,) = [p for p in os.listdir(tmp_path) if p.endswith(".npz")]
    assert name == f"occ_boxes_torch_ckpt.pt_{int(os.path.getmtime(ckpt))}_g8_t0.5_p1_b0.npz"
    again = occ.refined_boxes_cached(model, scene, str(tmp_path), str(ckpt), grid=grid,
                                     sigma_thresh=0.5)
    assert torch.equal(first.boxes, again.boxes)

    # "lerp" equals "direct" at integer ids (the lattice runs "lerp")
    net, motion = model.layers_coarse[0], model.motion[0]
    fields = [pack_field(prepare_kernel_params_planar(net, torch.float32),
                         prepare_motion_params_planar(motion, torch.float32),
                         net.spec, mode, "float32") for mode in ("lerp", "direct")]
    xyz = torch.tensor(np.random.default_rng(2).uniform(-1, 1, (3, 300)), dtype=torch.float32)
    ids = torch.full((1, 300), 3.0)
    dirs = torch.zeros((fields[0].shapes["r1b"][0], 300))
    lerp, direct = (fused_field_reference(f, xyz, ids, dirs) for f in fields)
    assert torch.equal(lerp[0], direct[0]) and torch.equal(lerp[1], direct[1])


def _gate_setup(tmp_path, **tpu):
    """test_torch_renderer's scene pair and JAX ``.ckpt`` with the
    approximations on at eps 0, an 8^3 occupancy lattice and a 16-pixel
    probe, plus ``tpu`` overrides on both configs."""
    from test_torch_renderer import _setup

    cfgs = _setup(tmp_path)
    for cfg in cfgs:
        cfg.TPU.FAST_FINE, cfg.TPU.EARLY_EXIT_SEGMENTS = True, 3
        cfg.TPU.FAST_FINE_EPS = cfg.TPU.EARLY_EXIT_EPS = 0.0
        cfg.TPU.OCCUPANCY_SKIP, cfg.TPU.OCC_GRID = True, 8
        cfg.TPU.FIDELITY_GATE, cfg.TPU.FIDELITY_PROBE_RES = True, 16
        for k, v in tpu.items():
            cfg.TPU[k] = v
    return cfgs


def test_fidelity_gate_decisions(tmp_path, monkeypatch, caplog):
    """The renderer's fidelity gate. With FIDELITY_MIN_DB far below the
    reading both packages keep the approximations and set ``fidelity_db``;
    far above, both fall back to the exact spec and the original boxes.
    The probe images with deterministic sampling (the port's ``seed=None``,
    JAX's ``key=None``) agree >= 60 dB, approximate and exact. The staged
    fallback under a manual tau, with the probe's reading set by scene:
    occupancy failing alone drops only the boxes; everything failing
    reverts to the exact path. Nothing logs "not ported"."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.models import EditState as JEdit
    from stnerf_tpu.render import LayeredNeuralRenderer as JRenderer
    from stnerf_tpu.render.pose_device import render_pose_on_device as jpose
    from stnerf_tpu_torch.render import LayeredNeuralRenderer
    from stnerf_tpu_torch.render import renderer as trenderer

    for bar, keeps in ((-1000.0, True), (1000.0, False)):
        jcfg, tcfg = _gate_setup(tmp_path / str(keeps), FIDELITY_MIN_DB=bar)
        with caplog.at_level(logging.INFO):
            jr, tr = JRenderer(jcfg), LayeredNeuralRenderer(tcfg, device="cpu")
        assert not any("not ported" in r.getMessage() for r in caplog.records)
        for r in (jr, tr):
            assert r.fidelity_db is not None and np.isfinite(r.fidelity_db)
            assert r.spec.fast_fine == keeps and (r.spec.coarse_exit_segments == 3) == keeps
            assert (r.scene is r._exact_scene) == (not keeps)
        if keeps:  # the probe images, deterministic
            for spec in (tr.spec, dataclasses.replace(tr.spec, fast_fine=False,
                                                      coarse_exit_segments=0)):
                got = tr._fidelity_probe(spec, tr._exact_scene, seed=None).numpy()
                pw, ph = 16, max(16, round(16 * tr.height / tr.width))
                K = np.array(jr.gt_Ks[0], np.float32).copy()
                K[0] *= pw / jr.width
                K[1] *= ph / jr.height
                jspec = dataclasses.replace(jr.spec, fast_fine=spec.fast_fine,
                                            coarse_exit_segments=spec.coarse_exit_segments)
                ref = jpose(jr.params, jspec, jr._exact_scene, jnp.asarray(K),
                            jnp.asarray(np.asarray(jr.gt_poses[0], np.float32)),
                            jnp.full((3,), float(jr.min_frame[0]), jnp.float32),
                            jnp.asarray(jr.dataset.near_far, jnp.float32),
                            JEdit.identity(2, scale_pivot=jr.scale_pivot), h=ph, w=pw,
                            chunk=min(int(jcfg.TPU.RENDER_CHUNK), pw * ph),
                            tile_cols=min(int(jcfg.TPU.TILE_COLS), pw), key=None)
                db = _psnr(got, np.asarray(jax.device_get(ref.color), np.float32) / 255.0)
                assert db >= TARGET_DB, f"probe fast_fine={spec.fast_fine}: {db:.1f} dB"

    # the staged fallback (manual tau: occupancy inside the probe)
    readings = {}

    def probe_db(self, scene):
        return readings["exact" if scene is self._exact_scene else "occ"]

    monkeypatch.setattr(trenderer.LayeredNeuralRenderer, "_probe_db", probe_db)
    for occ_db, exact_db, keeps_fast, keeps_occ in ((30.0, 50.0, True, False),
                                                    (30.0, 35.0, False, False),
                                                    (45.0, 0.0, True, True)):
        readings.update(occ=occ_db, exact=exact_db)
        _, tcfg = _gate_setup(tmp_path / f"staged{occ_db}{exact_db}", OCC_AUTO_TAU=False,
                              OCC_SIGMA_THRESH=0.0)
        tr = LayeredNeuralRenderer(tcfg, device="cpu")
        assert tr.spec.fast_fine == keeps_fast
        assert (tr.scene is not tr._exact_scene) == keeps_occ
        assert tr.fidelity_db == (exact_db if keeps_fast and not keeps_occ else occ_db)
    assert isinstance(tr.scene.boxes, torch.Tensor)
