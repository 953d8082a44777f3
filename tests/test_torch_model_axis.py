"""The port's model axis on the CPU: ``parallel.make_mesh(model_parallel=M)``
with a process group per axis, ``shard_params`` giving each model rank L/M
performer fields, the layer-sharded training step, ``do_train`` epoch with
its checkpoints and validation on whole weights, and the chunked and posed
renders of a sharded model. Ranks are processes started with
``torch.multiprocessing`` over gloo, single-threaded, as in
tests/test_torch_parallel.py, at its shapes (L=2, width 32, 16+8 samples,
deterministic sampling).

Each sharded result is held bitwise against the port's unsharded one, and
the steps against JAX's ``make_train_step`` on its ``make_mesh(
model_parallel=2)`` (the conftest's 8 CPU devices, a 4 x 2 mesh; the
parameters replicated, see :func:`_jax_step_grads`) at the port's float32
bar (rtol 2e-3, atol 2e-3 max|g| a leaf). Two faults of the
mesh before the model axis was ported are held here too: the mean over
ranks summed over every rank and divided by the data size only (M times
the mean on a (1, M) mesh), and every model rank of data row 0 was main.
"""

import os

import numpy as np
import pytest

from test_torch_parallel import (CHUNK, TARGET_DB, TILE_COLS, H, K, W, _c2w, _flat_params,
                                 _free_port, _pose_args, _port_model, _psnr, _torch_scene,
                                 _train_cfg)
from test_torch_train import _batch, _compact_pool, _leaves_close, _models, _scene
from test_torch_data import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.isolate


def _join(rank: int, world: int, port: int, model_parallel: int):
    """Join a gloo group on the CPU as torchrun's environment describes it
    -> the (data, model) mesh."""
    import torch

    from stnerf_tpu_torch.parallel import init_distributed, make_mesh

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    return make_mesh(model_parallel=model_parallel, device=init_distributed("cpu"))


def _spawn(fn, world: int, *args):
    import torch.multiprocessing as mp

    mp.spawn(fn, args=(world, _free_port(), *args), nprocs=world, join=True)


def _grads(model) -> dict:
    """name -> a copy of the parameter's gradient, or None."""
    return {n: None if p.grad is None else p.grad.clone()
            for n, p in model.named_parameters()}


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _owned(name: str, layers) -> bool:
    """Whether parameter ``name`` is one of performers ``layers``' or
    replicated (every other group)."""
    group, _, rest = name.partition(".")
    if group not in ("layers_coarse", "layers_fine", "motion"):
        return True
    return int(rest.split(".")[0]) in layers


def _mesh_row(mesh) -> tuple:
    return (mesh.data, mesh.model, mesh.rank, mesh.model_rank, mesh.is_main)


def _count_field_calls() -> list:
    """Count the trainable field calls of ``models.layered`` from now on
    (on a card each is one K1 and, backward, one K2 launch) -> [count]."""
    from stnerf_tpu_torch.models import layered

    calls = [0]
    real = layered.field_planar_trainable

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    layered.field_planar_trainable = counted
    return calls


def _jax_step_grads(jspec, params, rays, rgb, labels):
    """JAX's ``make_train_step`` on ``make_mesh(model_parallel=2)``, the
    batch sharded over its data axis: the full batch's gradients (an optax
    transformation keeps them as its state) and metrics. The parameters
    are replicated: with the performer fields sharded over the model axis
    (JAX's ``shard_params``) the JAX package computes the second
    performer's coarse stage wrong on these CPU devices, and its loss and
    gradients with it (``tools/model_axis_jax_probe.py`` prints how far)."""
    import jax
    import jax.numpy as jnp
    import optax

    from stnerf_tpu import models as J
    from stnerf_tpu.engine import make_train_step as jmake_train_step
    from stnerf_tpu.engine.trainer import TrainBatch as JBatch
    from stnerf_tpu.parallel import make_mesh as jmake_mesh
    from stnerf_tpu.parallel import replicate as jreplicate
    from stnerf_tpu.parallel import shard_ray_batch as jshard_ray_batch

    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, state, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    mesh = jmake_mesh(model_parallel=2)
    step = jmake_train_step(jspec, keep, remove_outliers=True)
    p = jreplicate(mesh, jax.tree.map(jnp.asarray, params))
    batch = JBatch(jshard_ray_batch(mesh, J.RayInputs(*map(jnp.asarray, rays))),
                   jshard_ray_batch(mesh, jnp.asarray(rgb)),
                   jshard_ray_batch(mesh, jnp.asarray(labels)))
    scene = jreplicate(mesh, J.SceneBoxes(*map(jnp.asarray, _scene())))
    with jax.sharding.set_mesh(mesh):
        _, grads, metrics = step(p, keep.init(p), scene, batch, None, jnp.asarray(1.0),
                                 only_coarse=False)
    return jax.device_get(grads), jax.device_get(metrics)


def _whole_grads(model, ranks: list):
    """The unsharded ``model`` with each parameter's gradient taken from the
    rank that owns it -> its gradients as a JAX tree."""
    from stnerf_tpu_torch.models import export_jax_params

    for n, p in model.named_parameters():
        got = [r["grads"][n] for r in ranks if r["grads"][n] is not None]
        p.grad = got[0]
    return export_jax_params(model, grad=True)


def test_model_axis_refusals_in_process():
    """Without a process group: an L that does not split over M, and a
    model axis with no group, are refused by ``shard_params``; epoch
    training refuses a (2, 2) mesh, as JAX's does, and ``do_train`` a
    sharded model without its mesh; ``is_main`` is the one rank at data
    index 0 and model index 0; an unsharded model is whole already."""
    import torch

    from stnerf_tpu_torch.engine import do_train, make_optimizer, make_train_epoch
    from stnerf_tpu_torch.parallel import (DeviceMesh, LayerShard, gather_whole, shard_params,
                                           whole_model)

    cpu = torch.device("cpu")
    cfg = _train_cfg()
    model = _models(cfg)[2]
    with pytest.raises(ValueError, match="do not split"):
        shard_params(DeviceMesh(1, 3, 0, None, cpu), model)   # L = 2 over 3
    with pytest.raises(ValueError, match="process group"):
        shard_params(DeviceMesh(1, 2, 0, None, cpu), model)
    assert model.layer_shard is None
    opt, sched = make_optimizer(cfg, model)
    with pytest.raises(ValueError, match="data-parallel"):
        make_train_epoch(model, opt, sched, mesh=DeviceMesh(2, 2, 0, None, cpu), device="cpu")
    model.layer_shard = LayerShard(DeviceMesh(1, 2, 0, None, cpu), 0, 1)
    with pytest.raises(ValueError, match="pass mesh="):
        do_train(cfg, model, _torch_scene(), _compact_pool(np.random.default_rng(1)),
                 device="cpu")
    model.layer_shard = None
    rows = [DeviceMesh(2, 2, d, None, cpu, model_rank=m) for d in range(2) for m in range(2)]
    assert [m.is_main for m in rows] == [True, False, False, False]
    assert gather_whole(rows[0], model, opt) is None
    with whole_model(model):
        assert model.layer_shard is None
    assert list(model.performers()) == [0, 1]


def _staged_model():
    """A model with view deformation and pose refinement (the staged
    path): its fields' inputs carry gradients, so the sharded step's
    backward gathers the performers' input cotangents and sums the shared
    direction encoding's over the model ranks."""
    import torch

    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec

    cfg = _train_cfg()
    cfg.MODEL.USE_DEFORM_VIEW = True
    cfg.MODEL.POSE_REFINEMENT = True
    model = LayeredModel(LayeredSpec.from_cfg(cfg, camera_num=1),
                         torch.Generator().manual_seed(1), device="cpu")
    with torch.no_grad():   # visible fields, as test_torch_train's models
        for name, p in model.named_parameters():
            if name.endswith("density.0.bias"):
                p += 0.3 if name.startswith("bkgd") else 2.0
    return model


def _one_by_two_worker(rank, world, port, tmp):
    """Rank ``rank`` of a (1, 2) mesh: the mean and main rank of the mesh,
    one step with the model replicated, one with it sharded (field calls
    counted), one of the staged model (view deformation and pose
    refinement), a sharded do_train of a coarse and a full epoch with
    mid-epoch checkpoints and validation, a sharded resume of the full
    epoch, and the sharded chunked and posed renders."""
    import torch

    from stnerf_tpu_torch.engine import (TrainBatch, do_train, load_checkpoint,
                                         make_optimizer, make_train_step)
    from stnerf_tpu_torch.models import EditState, RayInputs
    from stnerf_tpu_torch.parallel import shard_params
    from stnerf_tpu_torch.render import render_pose_host, render_rays_chunked

    mesh = _join(rank, world, port, 2)
    out = {"mesh": _mesh_row(mesh), "ones": mesh.all_reduce_mean_(torch.ones(3))}
    cfg = _train_cfg()
    path = os.path.join(tmp, "model.pt")
    rays, rgb, labels = _batch(np.random.default_rng(0))
    batch = TrainBatch(RayInputs(*map(torch.tensor, rays)), torch.tensor(rgb),
                       torch.tensor(labels))
    calls = _count_field_calls()
    for name, sharded in (("replicated", False), ("sharded", True)):
        model = _port_model(cfg, path)
        if sharded:
            shard_params(mesh, model)
        calls[0] = 0
        opt, sched = make_optimizer(cfg, model)
        step = make_train_step(model, opt, sched, remove_outliers=True, device="cpu",
                               mesh=mesh)
        m = step(_torch_scene(), batch, None, 1.0)
        out[name] = {"grads": _grads(model), "params": _params(model),
                     "metrics": torch.stack(tuple(m)), "field_calls": calls[0],
                     "performers": list(model.performers())}
    model = shard_params(mesh, _staged_model())
    opt, sched = make_optimizer(cfg, model)
    m = make_train_step(model, opt, sched, remove_outliers=True, device="cpu", mesh=mesh)(
        _torch_scene(), batch, None, 1.0)
    out["staged"] = {"grads": _grads(model), "metrics": torch.stack(tuple(m))}

    cfg.SOLVER.IMS_PER_BATCH = 100
    cfg.SOLVER.MAX_EPOCHS = 3
    cfg.SOLVER.COARSE_STAGE = 2
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.SOLVER.VAL_PERIOD = 2
    cfg.OUTPUT_DIR = os.path.join(tmp, "sharded")
    model = shard_params(mesh, _port_model(cfg, path))
    validated = []

    def val_fn(m, epoch, step=None):
        validated.append((m is model, m.layer_shard is None, epoch, step, _flat_params(m)))

    hist = do_train(cfg, model, _torch_scene(), _compact_pool(np.random.default_rng(1)),
                    mesh=mesh, seed=5, device="cpu", val_fn=val_fn if mesh.is_main else None)
    out["epochs"] = [(e, m.loss) for e, m in hist]
    out["validated"] = validated
    out["shard_after"] = model.layer_shard is not None

    # resume the full epoch from epoch 1's checkpoint into a sharded model
    model = _port_model(cfg, path)
    opt, sched = make_optimizer(cfg, model)
    load_checkpoint(os.path.join(cfg.OUTPUT_DIR, "stnerf_torch_checkpoint_1.pt"), model, opt,
                    sched)
    shard_params(mesh, model, opt)
    out["resumed_state"] = len(opt.state)
    cfg.OUTPUT_DIR = ""
    hist = do_train(cfg, model, _torch_scene(), _compact_pool(np.random.default_rng(1)), opt,
                    sched, mesh=mesh, seed=5, device="cpu", resume_epoch=1)
    out["resumed"] = [(e, m.loss) for e, m in hist]

    model = shard_params(mesh, _port_model(cfg, path))
    out["pose"] = render_pose_host(model, _torch_scene(), K, _c2w(), *_pose_args(),
                                   EditState.identity(2), H, W, chunk=CHUNK,
                                   tile_cols=TILE_COLS)
    out["chunked"] = render_rays_chunked(model, None, _torch_scene(),
                                         RayInputs(*_batch(np.random.default_rng(3), n=100)[0]),
                                         chunk=CHUNK, mesh=mesh)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def test_one_by_two_mesh(tmp_path):
    """Two processes on a (1, 2) mesh over gloo.

    The mesh: ``is_main`` on global rank 0 alone, and the mean over the
    (one) data rank of ones is ones; the step with the model replicated
    gives the one-process step's gradients and metrics bitwise (before
    the repair: twice the gradient and the loss). The layer-sharded step:
    each rank has gradients for the background and its own performer
    alone (two trainable field calls a stage, not three), bitwise the
    one-process step's, and after Adam those parameters bitwise; the
    ranks' gradients together against JAX's step on its (4, 2) mesh at
    the float32 bar. The same for a model with view deformation and pose
    refinement (the staged path, whose field inputs carry gradients):
    bitwise but for the two pose leaves (rtol 1e-5: the direction
    encoding that every field reads sums its cotangent over the ranks).
    A sharded ``do_train`` (a coarse and a full epoch, a checkpoint every 2
    steps and validation every 2): losses bitwise the
    unsharded run's, every checkpoint file the unsharded one key for key
    and bitwise (model, optimizer state, schedule), the main rank alone
    validating on whole weights equal to the unsharded run's at each call;
    a checkpoint resumes into an unsharded model (its parameters the
    unsharded run's) and into a sharded one (the full epoch's losses
    bitwise). The sharded pose and chunked render on every rank bitwise
    the unsharded port's, and >= 60 dB against JAX's with the hit masks
    equal."""
    import jax
    import torch

    from stnerf_tpu import models as J
    from stnerf_tpu.render.chunked import render_rays_chunked as jchunked
    from stnerf_tpu_torch.engine import (TrainBatch, do_train, load_checkpoint,
                                         make_optimizer, make_train_step)
    from stnerf_tpu_torch.models import EditState, RayInputs
    from stnerf_tpu_torch.render import render_pose_host, render_rays_chunked

    torch.set_num_threads(1)
    cfg = _train_cfg()
    jspec, params, model = _models(cfg)
    torch.save(model.state_dict(), str(tmp_path / "model.pt"))
    _spawn(_one_by_two_worker, 2, str(tmp_path))
    got = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(2)]

    assert [g["mesh"] for g in got] == [(1, 2, 0, 0, True), (1, 2, 0, 1, False)]
    for g in got:
        assert torch.equal(g["ones"], torch.ones(3))

    # the one-process step
    rays, rgb, labels = _batch(np.random.default_rng(0))
    batch = TrainBatch(RayInputs(*map(torch.tensor, rays)), torch.tensor(rgb),
                       torch.tensor(labels))
    opt, sched = make_optimizer(cfg, model)
    m = make_train_step(model, opt, sched, remove_outliers=True, device="cpu")(
        _torch_scene(), batch, None, 1.0)
    ref_grads, ref_params, ref_metrics = _grads(model), _params(model), torch.stack(tuple(m))
    for g in got:
        rep = g["replicated"]
        assert torch.equal(rep["metrics"], ref_metrics)
        assert all(torch.equal(rep["grads"][n], ref_grads[n]) for n in ref_grads)
        assert all(torch.equal(rep["params"][n], ref_params[n]) for n in ref_params)
    for r, g in enumerate(got):
        sh = g["sharded"]
        assert sh["performers"] == [r] and sh["field_calls"] == 4
        assert torch.equal(sh["metrics"], ref_metrics)
        for n, grad in sh["grads"].items():
            if _owned(n, [r]):
                assert torch.equal(grad, ref_grads[n]), n
                assert torch.equal(sh["params"][n], ref_params[n]), n
            else:
                assert grad is None, n
    staged = _staged_model()
    sopt, ssched = make_optimizer(cfg, staged)
    m = make_train_step(staged, sopt, ssched, remove_outliers=True, device="cpu")(
        _torch_scene(), batch, None, 1.0)
    staged_grads = _grads(staged)
    assert all(staged_grads[n].abs().max() > 0 for n in ("cam_pose.rvec", "cam_pose.tvec"))
    for r, g in enumerate(got):
        assert torch.equal(g["staged"]["metrics"], torch.stack(tuple(m)))
        for n, grad in g["staged"]["grads"].items():
            if not _owned(n, [r]):
                assert grad is None, n
            elif n.startswith("cam_pose"):  # the shared directions: summed in another order
                np.testing.assert_allclose(grad.numpy(), staged_grads[n].numpy(), rtol=1e-5,
                                           atol=1e-6 * float(staged_grads[n].abs().max()))
            else:
                assert torch.equal(grad, staged_grads[n]), n
    whole = _whole_grads(_port_model(cfg, str(tmp_path / "model.pt")),
                         [g["sharded"] for g in got])
    jgrads, jmetrics = _jax_step_grads(jspec, params, rays, rgb, labels)
    _leaves_close(whole, jgrads)
    np.testing.assert_allclose(float(ref_metrics[0]), float(jmetrics.loss), rtol=1e-5)

    # the unsharded epoch, its checkpoints and validation
    cfg.SOLVER.IMS_PER_BATCH = 100
    cfg.SOLVER.MAX_EPOCHS = 3
    cfg.SOLVER.COARSE_STAGE = 2
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.SOLVER.VAL_PERIOD = 2
    cfg.OUTPUT_DIR = str(tmp_path / "plain")
    plain = _port_model(cfg, str(tmp_path / "model.pt"))
    validated = []
    hist = do_train(cfg, plain, _torch_scene(), _compact_pool(np.random.default_rng(1)),
                    seed=5, device="cpu",
                    val_fn=lambda m, epoch, step=None: validated.append(
                        (epoch, step, _flat_params(m))))
    for g in got:
        assert [e for e, _ in g["epochs"]] == [e for e, _ in hist] == [1, 2]
        for (_, a), (_, b) in zip(g["epochs"], hist):
            np.testing.assert_array_equal(a, b.loss)
        assert g["shard_after"]
    assert got[1]["validated"] == []
    calls = got[0]["validated"]
    assert len(calls) == len(validated) >= 4
    for (same, whole_view, e, s, p), (e0, s0, p0) in zip(calls, validated):
        assert same and whole_view and (e, s) == (e0, s0) and torch.equal(p, p0)
    files = sorted(os.listdir(tmp_path / "plain"))
    assert files == sorted(os.listdir(tmp_path / "sharded"))
    assert "stnerf_torch_checkpoint_1_2.pt" in files
    for f in files:
        a = torch.load(tmp_path / "plain" / f, weights_only=True)
        b = torch.load(tmp_path / "sharded" / f, weights_only=True)
        assert a.keys() == b.keys() and (a["epoch"], a["step"]) == (b["epoch"], b["step"])
        assert a["model"].keys() == b["model"].keys()
        assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
        sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
        assert sa.keys() == sb.keys() and len(sa) > 0
        for k in sa:
            assert sa[k].keys() == sb[k].keys()
            assert all(torch.equal(sa[k][x], sb[k][x]) for x in sa[k])
        assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
        assert a["scheduler"] == b["scheduler"]
    # a sharded run's checkpoint resumes unsharded
    resumed = _port_model(cfg, str(tmp_path / "model.pt"))
    ropt, rsched = make_optimizer(cfg, resumed)
    load_checkpoint(str(tmp_path / "sharded" / "stnerf_torch_checkpoint_2.pt"), resumed, ropt,
                    rsched)
    assert torch.equal(_flat_params(resumed), _flat_params(plain))
    # ... and sharded: the full epoch again, bitwise
    n_state = len(make_optimizer(cfg, plain)[0].param_groups[0]["params"])
    for g in got:
        assert 0 < g["resumed_state"] < n_state
        assert [e for e, _ in g["resumed"]] == [2]
        np.testing.assert_array_equal(g["resumed"][0][1], hist[1][1].loss)

    # the renders
    base = _port_model(cfg, str(tmp_path / "model.pt"))
    pose = render_pose_host(base, _torch_scene(), K, _c2w(), *_pose_args(),
                            EditState.identity(2), H, W, chunk=CHUNK, tile_cols=TILE_COLS)
    rays = RayInputs(*_batch(np.random.default_rng(3), n=100)[0])
    chunked = render_rays_chunked(base, None, _torch_scene(), rays, chunk=CHUNK)
    for g in got:
        for a, b in zip([g["pose"][0], g["pose"][1], *g["pose"][2], *g["pose"][3]],
                        [pose[0], pose[1], *pose[2], *pose[3]]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree.leaves(g["chunked"]), jax.tree.leaves(chunked)):
            np.testing.assert_array_equal(a, b)
    ref = jchunked(params, jspec, J.SceneBoxes(*_scene()), J.RayInputs(*rays), chunk=CHUNK)
    out = got[1]["chunked"]
    for a, b in zip(jax.tree.leaves(out._replace(hit=np.zeros(1))),
                    jax.tree.leaves(ref._replace(hit=np.zeros(1)))):
        assert _psnr(a, b) >= TARGET_DB
    np.testing.assert_array_equal(out.hit, np.asarray(ref.hit))
    assert out.hit[1].any() and not out.hit[1].all()


def _two_by_two_worker(rank, world, port, tmp):
    """Rank ``rank`` of a (2, 2) mesh: one layer-sharded step on its data
    row's half of a fixed batch, then the pose of a sharded model."""
    import torch

    from stnerf_tpu_torch.engine import TrainBatch, make_optimizer, make_train_step
    from stnerf_tpu_torch.models import EditState, RayInputs
    from stnerf_tpu_torch.parallel import shard_params
    from stnerf_tpu_torch.render import render_pose_host

    mesh = _join(rank, world, port, 2)
    cfg = _train_cfg()
    model = shard_params(mesh, _port_model(cfg, os.path.join(tmp, "model.pt")))
    rays, rgb, labels = _batch(np.random.default_rng(0))
    half = slice(mesh.rank * 24, (mesh.rank + 1) * 24)
    batch = TrainBatch(RayInputs(*(torch.tensor(x[half]) for x in rays)),
                       torch.tensor(rgb[half]), torch.tensor(labels[half]))
    opt, sched = make_optimizer(cfg, model)
    m = make_train_step(model, opt, sched, remove_outliers=True, device="cpu", mesh=mesh)(
        _torch_scene(), batch, None, 1.0)
    pose = render_pose_host(shard_params(mesh, _port_model(cfg, os.path.join(tmp, "model.pt"))),
                            _torch_scene(), K, _c2w(), *_pose_args(), EditState.identity(2),
                            H, W, chunk=CHUNK, tile_cols=TILE_COLS, mesh=mesh)
    torch.save({"mesh": _mesh_row(mesh), "grads": _grads(model), "params": _params(model),
                "metrics": torch.stack(tuple(m)), "performers": list(model.performers()),
                "pose": pose}, os.path.join(tmp, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def test_two_by_two_mesh_step(tmp_path):
    """Four processes on a (2, 2) mesh over gloo: global rank g at data
    index g // 2 and model index g % 2, main alone at 0. One layer-sharded
    step, each data row on its half of a fixed 48-ray batch: every rank's
    gradients (the background's and its own performer's, none for the
    other) and its parameters after Adam bitwise the in-process
    reconstruction ((g0 + g1) / 2 of the halves' gradients with the mask
    loss scaled by 2, one Adam step), the metrics the halves' mean; the
    ranks' gradients together against JAX's step on its (4, 2) mesh on
    the whole batch at the float32 bar. A sharded model's pose, its rays
    over the data rows and its fields over the model ranks: every rank's
    bitwise the unsharded pose."""
    import torch

    from stnerf_tpu_torch.engine import TrainBatch, make_optimizer
    from stnerf_tpu_torch.engine.trainer import _losses
    from stnerf_tpu_torch.models import EditState, RayInputs
    from stnerf_tpu_torch.render import render_pose_host

    torch.set_num_threads(1)
    cfg = _train_cfg()
    jspec, params, model = _models(cfg)
    torch.save(model.state_dict(), str(tmp_path / "model.pt"))
    _spawn(_two_by_two_worker, 4, str(tmp_path))
    got = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(4)]
    assert [g["mesh"] for g in got] == [(2, 2, g // 2, g % 2, g == 0) for g in range(4)]
    assert [g["performers"] for g in got] == [[0], [1], [0], [1]]

    rays, rgb, labels = _batch(np.random.default_rng(0))
    gs, losses = [], []
    for half in (slice(0, 24), slice(24, 48)):
        batch = TrainBatch(RayInputs(*(torch.tensor(x[half]) for x in rays)),
                           torch.tensor(rgb[half]), torch.tensor(labels[half]))
        model.zero_grad(set_to_none=True)
        loss, _ = _losses(model, EditState.identity(2), True, _torch_scene(), batch, None,
                          1.0, False, mask_scale=2.0)
        loss.backward()
        losses.append(loss.detach())
        gs.append(_grads(model))
    opt, _ = make_optimizer(cfg, model)
    for n, p in model.named_parameters():
        p.grad = (gs[0][n] + gs[1][n]) / 2
    mean = _grads(model)
    opt.step()
    after = _params(model)
    for g in got:
        row = g["performers"]
        np.testing.assert_allclose(float(g["metrics"][0]), float((losses[0] + losses[1]) / 2),
                                   rtol=1e-6)
        for n, grad in g["grads"].items():
            if _owned(n, row):
                assert torch.equal(grad, mean[n]), n
                assert torch.equal(g["params"][n], after[n]), n
            else:
                assert grad is None, n
    whole = _whole_grads(_port_model(cfg, str(tmp_path / "model.pt")), got[:2])
    jgrads, _ = _jax_step_grads(jspec, params, rays, rgb, labels)
    _leaves_close(whole, jgrads)
    pose = render_pose_host(_port_model(cfg, str(tmp_path / "model.pt")), _torch_scene(), K,
                            _c2w(), *_pose_args(), EditState.identity(2), H, W, chunk=CHUNK,
                            tile_cols=TILE_COLS)
    for g in got:
        for a, b in zip([g["pose"][0], g["pose"][1], *g["pose"][2], *g["pose"][3]],
                        [pose[0], pose[1], *pose[2], *pose[3]]):
            np.testing.assert_array_equal(a, b)
