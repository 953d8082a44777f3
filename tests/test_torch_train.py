"""The port's training path (``stnerf_tpu_torch.engine`` and the
differentiable render) against the JAX package's on the CPU: the
compositing weights' gradient, the losses, the learning-rate schedules, one
optimizer update, the on-device ray decoding, and a whole training step's
loss and gradients, with the same weights through ``load_jax_params`` and
``export_jax_params``. Then a short ``do_train`` on the CPU with a
checkpoint round trip. Shapes as tests/test_torch_render.py: L=2, 16+8
samples, width 32, 48 rays. Every test runs in a fresh child process
(``isolate``).
"""

import contextlib
import os

import numpy as np
import pytest
from test_torch_data import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.isolate


def _cfg():
    from stnerf_tpu.config import get_cfg

    cfg = get_cfg()
    cfg.DATASETS.LAYER_NUM = 2
    cfg.MODEL.COARSE_RAY_SAMPLING = 16
    cfg.MODEL.FINE_RAY_SAMPLING = 8
    cfg.MODEL.SAMPLE_METHOD = "BBOX"
    cfg.MODEL.USE_SPACE_TIME = True
    cfg.MODEL.USE_DEFORM_TIME = True
    cfg.MODEL.DEEP_RGB = False
    cfg.MODEL.POSE_REFINEMENT = False
    cfg.MODEL.BACKBONE_DIM = 32
    cfg.MODEL.HEAD_DIM = 16
    cfg.MODEL.MOTION_DIM = 32
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.FAST_FINE = False
    cfg.TPU.EARLY_EXIT_SEGMENTS = 0
    return cfg


def _models(cfg):
    """Same weights in both packages, density biases raised so that the
    fields are visible (+0.3 background, +2 performers)."""
    import jax

    from stnerf_tpu.models import LayeredSpec as JSpec
    from stnerf_tpu.models import init_layered_params
    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec, load_jax_params

    jspec = JSpec.from_cfg(cfg)
    params = jax.tree.map(np.array, jax.device_get(
        init_layered_params(jax.random.PRNGKey(0), jspec)))
    for group, delta in (("bkgd_coarse", 0.3), ("bkgd_fine", 0.3),
                         ("layers_coarse", 2.0), ("layers_fine", 2.0)):
        params[group]["density"][0]["b"] = params[group]["density"][0]["b"] + delta
    model = load_jax_params(LayeredModel(LayeredSpec.from_cfg(cfg), device="cpu"), params)
    return jspec, params, model


def _scene(frames=3):
    boxes = np.zeros((frames, 2, 2, 3), np.float32)
    for f in range(frames):
        boxes[f, 0] = [[-1 + 0.1 * f, -1, 1], [1 + 0.1 * f, 1, 3]]
        boxes[f, 1] = [[-1, 1.5, 1], [1, 3.5, 3]]
    return (np.array([[-6.0, -6.0, -6.0], [6.0, 6.0, 6.0]], np.float32), boxes,
            np.array([0.5, 12.0], np.float32))


def _batch(rng, n=48):
    o = np.tile(np.array([[0.0, 0.0, -5.0]], np.float32), (n, 1))
    d = np.stack([np.linspace(-0.4, 0.4, n), np.linspace(-0.1, 0.5, n),
                  np.ones(n)], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = (o, d, np.full((n, 3), 2.0, np.float32), np.zeros(n, np.float32),
            np.tile([[0.5, 12.0]], (n, 1)).astype(np.float32))
    return rays, rng.uniform(size=(n, 3)).astype(np.float32), rng.integers(0, 3, n)


def _leaves_close(got, ref, rtol=2e-3, scale_atol=2e-3):
    """Per leaf: rtol, atol = scale_atol * max |leaf| (tests/test_kernels.py)."""
    import jax

    flat_r, tdef = jax.tree.flatten(ref)
    flat_g, gdef = jax.tree.flatten(got)
    assert tdef == gdef
    for a, b in zip(flat_g, flat_r):
        scale = max(1e-3, float(np.max(np.abs(b))))
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=scale_atol * scale)


def test_render_weights_grad_matches_jax(rng):
    """The transmittance cumprod's closed-form backward, on samples that
    include saturated ones (alpha = 1: a huge density, and the 1e10 border
    delta)."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.ops.volume import render_weights as jrw
    from stnerf_tpu_torch.ops.volume import render_weights as trw

    n, s = 16, 12
    sigma = rng.normal(size=(n, s)).astype(np.float32) * 3
    sigma[::3, 5] = 1e4
    delta = rng.uniform(0.01, 0.3, size=(n, s)).astype(np.float32)
    delta[:, -1] = 1e10
    cot = rng.normal(size=(n, s)).astype(np.float32)
    w_j, vjp = jax.vjp(lambda x: jrw(x, jnp.asarray(delta)), jnp.asarray(sigma))
    (g_j,) = vjp(jnp.asarray(cot))
    x = torch.tensor(sigma, requires_grad=True)
    w_t = trw(x, torch.tensor(delta))
    (w_t * torch.tensor(cot)).sum().backward()
    assert (w_t[::3, 6:] < 1e-9).all()  # ~nothing behind a saturated sample
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-7)
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("gate", ["on", "off"])
def test_mask_alpha_loss_matches_jax(rng, gate):
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.engine.loss import mask_alpha_loss as jmask
    from stnerf_tpu_torch.engine.loss import mask_alpha_loss as tmask

    n = 400
    labels = rng.integers(0, 3, n)
    acc = rng.uniform(size=(3, n, 1)).astype(np.float32)
    if gate == "off":  # alpha matches the labels almost everywhere: below the gate
        acc = (labels[None, :, None] == np.arange(3)[:, None, None]).astype(np.float32)
        acc[1:, labels == 0] = 0.0
        acc += 1e-6
    v_j, g_j = jax.value_and_grad(jmask)(jnp.asarray(acc), jnp.asarray(labels))
    x = torch.tensor(acc, requires_grad=True)
    v_t = tmask(x, torch.tensor(labels))
    v_t.backward()
    assert (float(v_t) > 0) == (gate == "on")
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-12)


def test_lr_schedules_match_jax():
    from stnerf_tpu.engine import solver as J
    from stnerf_tpu_torch.engine import solver as T

    steps = np.arange(201)
    pairs = [(J.make_lr_schedule(4e-4, 10, 50, 150, 0.09),
              T.make_lr_schedule(4e-4, 10, 50, 150, 0.09))]
    for method in ("linear", "constant"):
        pairs.append((J.make_warmup_multistep(1e-3, [30, 80], 0.5, 0.25, 20, method),
                      T.make_warmup_multistep(1e-3, [30, 80], 0.5, 0.25, 20, method)))
    for js, ts in pairs:
        np.testing.assert_allclose([ts(int(s)) for s in steps],
                                   [float(js(s)) for s in steps], rtol=1e-6)


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_optimizer_updates_match_optax(rng, name):
    """Two updates with weight decay, warmup and a frozen group, on the same
    gradients: the torch optimizer and LambdaLR against the optax chain."""
    import jax
    import optax
    import torch

    from stnerf_tpu.engine.solver import make_frozen_mask as jmask
    from stnerf_tpu.engine.solver import make_optimizer as jopt
    from stnerf_tpu_torch.engine import make_frozen_mask, make_optimizer
    from stnerf_tpu_torch.models import export_jax_params, load_jax_params

    cfg = _cfg()
    cfg.SOLVER.OPTIMIZER_NAME = name
    cfg.SOLVER.BASE_LR = 1e-2
    cfg.SOLVER.WEIGHT_DECAY = 0.05
    cfg.SOLVER.WARMUP_ITERS = 3
    _, params, model = _models(cfg)
    with pytest.raises(ValueError):
        make_frozen_mask(model, ["bkgd_fin"])
    tx = jopt(cfg, jmask(params, ["bkgd_fine"]))
    opt, sched = make_optimizer(cfg, model, make_frozen_mask(model, ["bkgd_fine"]))
    state = tx.init(params)
    for _ in range(2):
        grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        updates, state = tx.update(grads, state, params)
        params = jax.device_get(optax.apply_updates(params, updates))
        holder = load_jax_params(type(model)(model.spec, device="cpu"), grads)
        for p, g in zip(model.parameters(), holder.parameters()):
            p.grad = g.detach().clone()
        opt.step()
        sched.step()
        _leaves_close(export_jax_params(model), params, rtol=1e-5, scale_atol=1e-6)
    frozen = export_jax_params(model)["bkgd_fine"]
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(frozen), jax.tree.leaves(_models(cfg)[1]["bkgd_fine"])))
    assert not np.array_equal(export_jax_params(model)["bkgd_coarse"]["stage1"][0]["w"],
                              _models(cfg)[1]["bkgd_coarse"]["stage1"][0]["w"])


def _compact_pool(rng, n=300, cams=4, width=64, height=48, frames=3, lp1=3):
    """A seeded compact pool and camera tables, as numpy arrays."""
    angles = np.linspace(0, 2 * np.pi, cams, endpoint=False)
    rot = np.stack([np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                              [-np.sin(a), 0, np.cos(a)]]) for a in angles]).astype(np.float32)
    K = np.array([[width, 0, width / 2], [0, width, height / 2], [0, 0, 1]], np.float32)
    bundle = {
        "cams": rng.integers(0, cams, n), "pix": rng.integers(0, width * height, n),
        "frames": rng.integers(1, frames + 1, n), "labels": rng.integers(0, lp1, n),
        "bbox_labels": rng.integers(0, lp1, n), "rgb": rng.integers(0, 256, (n, 3)),
        "table_inv_K": np.tile(np.linalg.inv(K)[None], (cams, 1, 1)).astype(np.float32),
        "table_rot": rot,
        "table_origin": (-8.0 * rot[:, :, 2]).astype(np.float32),
        "table_near_far": np.stack(np.broadcast_arrays(
            rng.uniform(0.5, 2.0, (lp1, frames + 1, cams)),
            rng.uniform(12.0, 14.0, (lp1, frames + 1, cams))), -1).astype(np.float32),
        "width": width,
    }
    return bundle


def test_decode_and_hit_sort_match_jax(rng):
    import jax
    import torch

    from stnerf_tpu.engine import trainer as J
    from stnerf_tpu.models import SceneBoxes as JScene
    from stnerf_tpu_torch.engine import trainer as T
    from stnerf_tpu_torch.models import SceneBoxes

    jspec, params, model = _models(_cfg())
    bundle = _compact_pool(rng)
    jpool, jtables, width = J.split_compact_bundle(bundle)
    tpool, ttables, twidth = T.split_compact_bundle(bundle, "cpu")
    assert twidth == width
    ref = jax.device_get(J.make_decode(jtables, jspec, width)(jpool))
    got = T.make_decode(ttables, model.spec, width)(tpool)
    for a, b in zip(jax.tree.leaves(got._replace(inputs=tuple(got.inputs))),
                    jax.tree.leaves(ref._replace(inputs=tuple(ref.inputs)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    scene = _scene()
    ref_s = jax.device_get(J.sort_batch_by_hit(jspec, JScene(*scene), ref))
    got_s = T.sort_batch_by_hit(model.spec, SceneBoxes(*map(torch.tensor, scene)), got)
    np.testing.assert_array_equal(got_s.labels.numpy(), np.asarray(ref_s.labels))
    np.testing.assert_allclose(got_s.inputs.rays_d.numpy(), np.asarray(ref_s.inputs.rays_d),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("only_coarse", [True, False])
def test_train_step_matches_jax(rng, only_coarse):
    """Loss and every gradient leaf of a training step (``_losses`` with
    REMOVE_OUTLIERS on, deterministic sampling) against
    ``jax.value_and_grad`` of the JAX ``_losses``. The JAX side runs its XLA
    field path (exact encodings); the port the plain versions of its field
    kernels (double-angle encodings, the hand-written backward)."""
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
    rays, rgb, labels = _batch(rng)
    jbatch = JBatch(J.RayInputs(*map(jnp.asarray, rays)), jnp.asarray(rgb), jnp.asarray(labels))

    def jloss(p):
        return jlosses(jspec, J.EditState.identity(2), True, p,
                       J.SceneBoxes(*map(jnp.asarray, scene)), jbatch, None, 1.0, only_coarse)

    (v_j, raw_j), g_j = jax.device_get(jax.jit(jax.value_and_grad(jloss, has_aux=True))(params))
    batch = TrainBatch(T.RayInputs(*map(torch.tensor, rays)), torch.tensor(rgb),
                       torch.tensor(labels))
    v_t, raw_t = _losses(model, T.EditState.identity(2), True,
                         T.SceneBoxes(*map(torch.tensor, scene)), batch, None, 1.0, only_coarse)
    v_t.backward()
    assert float(raw_t.mask) > 0  # the mask loss is on and above its gate
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=2e-5)
    np.testing.assert_allclose(float(raw_t.mask), float(raw_j.mask), rtol=2e-5)
    g_t = T.export_jax_params(model, grad=True)
    if only_coarse:  # the fine nets get no gradient
        assert not any(np.any(x) for x in jax.tree.leaves(g_t["bkgd_fine"]))
    _leaves_close(g_t, g_j)


@contextlib.contextmanager
def _jax_draws():
    """Every ``jax.random.uniform`` draw made inside, as numpy arrays in
    call order: an ordered callback records each at run time, jitted or
    not (the caches are cleared, so that programs are traced inside)."""
    import jax

    draws, real = [], jax.random.uniform

    def record(*args, **kwargs):
        u = real(*args, **kwargs)
        jax.debug.callback(lambda v: draws.append(np.asarray(v)), u, ordered=True)
        return u

    jax.clear_caches()
    jax.random.uniform = record
    try:
        yield draws
        jax.effects_barrier()
    finally:
        jax.random.uniform = real


@contextlib.contextmanager
def _replayed(draws):
    """The port's samplers draw ``draws`` in call order (through
    ``ops.sampling._uniform``); every draw must be taken, at its shape."""
    import torch

    from stnerf_tpu_torch.ops import sampling

    replay, real = iter(draws), sampling._uniform

    def uniform(shape, like, generator):
        u = next(replay)
        assert tuple(shape) == u.shape, (tuple(shape), u.shape)
        return torch.tensor(u, dtype=like.dtype, device=like.device)

    sampling._uniform = uniform
    try:
        yield
    finally:
        sampling._uniform = real
    assert next(replay, None) is None, "a JAX draw was not taken"


def test_random_mode_train_step_matches_jax(rng):
    """``test_train_step_matches_jax`` in random mode: the JAX ``_losses``
    runs with a key, its uniform draws are recorded (``_jax_draws``) and
    replayed into the port's ``_losses`` in call order (``_replayed``). Both packages draw in the
    same order — the coarse stage's one (N, S1) draw per layer, background
    first, then the fine stage's one ((L+1) N, S2) ``sample_pdf`` draw — so
    the draws need no matching by stage. Loss and every gradient leaf at
    that test's bars."""
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
    rays, rgb, labels = _batch(rng)
    jbatch = JBatch(J.RayInputs(*map(jnp.asarray, rays)), jnp.asarray(rgb), jnp.asarray(labels))

    def jloss(p, key):
        return jlosses(jspec, J.EditState.identity(2), True, p,
                       J.SceneBoxes(*map(jnp.asarray, scene)), jbatch, key, 1.0, False)

    with _jax_draws() as draws:
        (v_j, raw_j), g_j = jax.device_get(jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(params, jax.random.PRNGKey(3)))
    n = len(labels)
    assert [d.shape for d in draws] == [(n, 16)] * 3 + [(3 * n, 8)]
    batch = TrainBatch(T.RayInputs(*map(torch.tensor, rays)), torch.tensor(rgb),
                       torch.tensor(labels))
    with _replayed(draws):
        v_t, raw_t = _losses(model, T.EditState.identity(2), True,
                             T.SceneBoxes(*map(torch.tensor, scene)), batch,
                             torch.Generator(), 1.0, False)
    v_t.backward()
    assert float(raw_t.mask) > 0
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=2e-5)
    np.testing.assert_allclose(float(raw_t.mask), float(raw_j.mask), rtol=2e-5)
    _leaves_close(T.export_jax_params(model, grad=True), g_j)


def _lockstep_batches(rng, steps, n=48):
    """``steps`` seeded batches: rays from around (0, 0, -5) fanned over
    both performers' boxes, frames 1-2, random colours and labels."""
    out = []
    for _ in range(steps):
        o = np.array([0.0, 0.0, -5.0], np.float32) + rng.normal(size=(n, 3)).astype(
            np.float32) * 0.05
        d = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.2, 0.6, n),
                      np.ones(n)], 1).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        frames = np.repeat(rng.integers(1, 3, (n, 1)), 3, 1).astype(np.float32)
        rays = (o, d, frames, np.zeros(n, np.float32),
                np.tile([[0.5, 12.0]], (n, 1)).astype(np.float32))
        out.append((rays, rng.uniform(size=(n, 3)).astype(np.float32),
                    rng.integers(0, 3, n)))
    return out


@pytest.mark.parametrize("form", ["nosort", "sorted"])
def test_twenty_step_lockstep_matches_jax(rng, form):
    """20 training steps of JAX's ``make_train_step`` and the port's, from
    the same init on the same batches with JAX's draws replayed: the first
    10 coarse only (COARSE_STAGE), then full steps; REMOVE_OUTLIERS with
    mask_on 1; Adam under the warmup-and-decay schedule. The port runs the
    sort-free compositor (``TPU.COMPOSITOR_KERNEL``: the plain cube form on
    the CPU) or the sorted merge; JAX always trains sort-free. Every step's
    loss within rtol 1e-3 of JAX's, or where float32 round-off amplified by
    Adam is larger, within twice the distance between JAX's run and JAX's
    run from an init nudged one float32 ulp in every leaf. The final
    parameters' per-leaf relative L2 against JAX's is printed."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu import models as J
    from stnerf_tpu.engine.solver import make_optimizer as jopt
    from stnerf_tpu.engine.trainer import TrainBatch as JBatch
    from stnerf_tpu.engine.trainer import make_train_step as jmake_step
    from stnerf_tpu_torch import models as T
    from stnerf_tpu_torch.engine import make_optimizer, make_train_step
    from stnerf_tpu_torch.engine.trainer import TrainBatch

    steps, coarse = 20, 10
    cfg = _cfg()
    cfg.SOLVER.OPTIMIZER_NAME = "Adam"
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.SOLVER.WEIGHT_DECAY = 0.0
    cfg.SOLVER.WARMUP_ITERS, cfg.SOLVER.START_ITERS, cfg.SOLVER.END_ITERS = 5, 12, 20
    cfg.MODEL.REMOVE_OUTLIERS = True
    cfg.TPU.COMPOSITOR_KERNEL = form == "nosort"
    jspec, params, model = _models(cfg)
    assert model.spec.compositor_kernel == (form == "nosort")
    scene = _scene()
    jscene = J.SceneBoxes(*map(jnp.asarray, scene))
    data = _lockstep_batches(rng, steps)
    jbatches = [JBatch(J.RayInputs(*map(jnp.asarray, r)), jnp.asarray(c), jnp.asarray(l))
                for r, c, l in data]
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), i) for i in range(steps)]
    tx = jopt(cfg)

    def jax_run(p, recorded=None):
        """-> (final parameters, losses, each step's draws from ``recorded``)."""
        step, state = jmake_step(jspec, tx, remove_outliers=True), tx.init(p)
        losses, draws = [], []
        for i in range(steps):
            n = len(recorded or ())
            p, state, m = step(p, state, jscene, jbatches[i], keys[i], jnp.asarray(1.0),
                               only_coarse=i < coarse)
            losses.append(float(m.loss))
            if recorded is not None:
                jax.effects_barrier()
                draws.append(recorded[n:])
        return jax.device_get(p), np.array(losses), draws

    with _jax_draws() as recorded:
        p_j, loss_j, draws = jax_run(params, recorded)
    opt, sched = make_optimizer(cfg, model)
    step = make_train_step(model, opt, sched, remove_outliers=True, device="cpu")
    tscene = T.SceneBoxes(*map(torch.tensor, scene))
    loss_t = []
    for i, (r, c, l) in enumerate(data):
        batch = TrainBatch(T.RayInputs(*map(torch.tensor, r)), torch.tensor(c),
                           torch.tensor(l))
        with _replayed(draws[i]):
            loss_t.append(float(step(tscene, batch, torch.Generator(), 1.0,
                                     only_coarse=i < coarse).loss))
    loss_t = np.array(loss_t)
    nudged = jax.tree.map(lambda x: np.nextafter(x, np.float32(np.inf)), params)
    p_n, loss_n, _ = jax_run(nudged)
    bar = np.maximum(1e-3 * np.abs(loss_j), 2 * np.abs(loss_n - loss_j))

    def worst_rel_l2(a, b):
        rel = {jax.tree_util.keystr(k): float(np.linalg.norm(np.asarray(x) - np.asarray(y))
                                              / max(np.linalg.norm(np.asarray(y)), 1e-30))
               for (k, x), y in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                                    jax.tree.leaves(b))}
        return f"{max(rel.values()):.3e} at {max(rel, key=rel.get)}"

    print(f"{form}: final parameters, worst relative L2 of a leaf against JAX's: port "
          f"{worst_rel_l2(T.export_jax_params(model), p_j)}, JAX from the nudged init "
          f"{worst_rel_l2(p_n, p_j)}; loss, worst step relative to JAX's: port "
          f"{np.max(np.abs(loss_t - loss_j) / loss_j):.3e}, nudged JAX "
          f"{np.max(np.abs(loss_n - loss_j) / loss_j):.3e}")
    assert (np.abs(loss_t - loss_j) <= bar).all(), (
        f"JAX {loss_j.tolist()}\nport {loss_t.tolist()}\nbar {bar.tolist()}")
    # the coarse stage left the fine nets as they were; the full steps moved them
    assert not np.array_equal(p_j["bkgd_fine"]["density"][0]["w"],
                              params["bkgd_fine"]["density"][0]["w"])


def test_do_train_on_cpu_and_checkpoint(rng, tmp_path):
    """Two short epochs (coarse only, then full) on the CPU from a compact
    pool: finite losses, the log line, the validation callback, a checkpoint
    per epoch that restores the model, optimizer and scheduler exactly; the
    field kernels never launch on the CPU."""
    import logging

    import torch

    from stnerf_tpu_torch.engine import do_train, load_checkpoint, make_optimizer
    from stnerf_tpu_torch.kernels import field_bwd, fused_field
    from stnerf_tpu_torch.models import SceneBoxes

    cfg = _cfg()
    cfg.SOLVER.OPTIMIZER_NAME = "Adam"
    cfg.SOLVER.IMS_PER_BATCH = 100
    cfg.SOLVER.MAX_EPOCHS = 3
    cfg.SOLVER.COARSE_STAGE = 2
    cfg.SOLVER.WARMUP_ITERS = 1
    cfg.SOLVER.LOG_PERIOD = 1
    cfg.MODEL.REMOVE_OUTLIERS = True
    cfg.OUTPUT_DIR = str(tmp_path)
    _, _, model = _models(cfg)
    opt, sched = make_optimizer(cfg, model)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("test_do_train")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    validated = []
    history = do_train(cfg, model, SceneBoxes(*map(torch.tensor, _scene())),
                       _compact_pool(rng), opt, sched, logger=logger, device="cpu",
                       val_fn=lambda m, epoch: validated.append((m is model, epoch)))
    assert [e for e, _ in history] == [1, 2]
    assert validated == [(True, 1), (True, 2)]
    for _, m in history:
        assert len(m.loss) == 3 and np.isfinite(m.loss).all()
        assert np.isfinite(m.psnr_fine).all()
    assert any("Iteration[2/3] Loss" in r.getMessage() for r in records)
    assert fused_field.launches == 0 and field_bwd.launches == 0
    assert sched.last_epoch == 6

    _, _, fresh = _models(_cfg())
    fresh_opt, fresh_sched = make_optimizer(cfg, fresh)
    info = load_checkpoint(os.path.join(str(tmp_path), "stnerf_torch_checkpoint_2.pt"),
                           fresh, fresh_opt, fresh_sched)
    assert info == {"epoch": 2, "step": 0}
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    state, fresh_state = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
    assert state.keys() == fresh_state.keys()
    for k in state:
        assert torch.equal(state[k]["exp_avg_sq"], fresh_state[k]["exp_avg_sq"])
    assert fresh_sched.last_epoch == 6


def test_block_draws_take_contiguous_runs(rng):
    """With ``block`` > 1 an epoch draws each batch as batch/block runs of
    ``block`` consecutive pool rows (pools ordered by hit pattern)."""
    import torch

    from stnerf_tpu_torch.engine import make_optimizer, make_train_epoch
    from stnerf_tpu_torch.engine.trainer import make_decode, split_compact_bundle
    from stnerf_tpu_torch.models import SceneBoxes

    cfg = _cfg()
    cfg.MODEL.COARSE_RAY_SAMPLING, cfg.MODEL.FINE_RAY_SAMPLING = 8, 4
    _, _, model = _models(cfg)
    bundle = _compact_pool(rng, n=64)
    bundle["pix"] = np.arange(64)  # a row's pixel index names the row
    pool, tables, width = split_compact_bundle(bundle, "cpu")
    decode = make_decode(tables, model.spec, width)
    drawn = []

    def recording_decode(rows):
        drawn.append(rows.pix.numpy())
        return decode(rows)

    opt, sched = make_optimizer(cfg, model)
    epoch = make_train_epoch(model, opt, sched, decode=recording_decode, block=4,
                             device="cpu")
    m = epoch(SceneBoxes(*map(torch.tensor, _scene())), pool,
              torch.Generator().manual_seed(0), 1.0, batch_size=8, steps=2,
              only_coarse=True)
    assert m.loss.shape == (2,) and torch.isfinite(m.loss).all()
    assert len(drawn) == 2
    for rows in drawn:
        runs = rows.reshape(2, 4)
        assert (runs[:, 0] % 4 == 0).all()
        assert (np.diff(runs, axis=1) == 1).all()
