"""The port's data-parallel training and ray-sharded rendering
(``stnerf_tpu_torch.parallel``, ``engine.do_train(mesh=)``,
``render_pose_host(mesh=)``, ``render_rays_chunked(mesh=)``, the train CLI
under several ranks) on the CPU. Two ranks are two processes started with
``torch.multiprocessing`` over gloo; a one-rank mesh runs in the test's own
process. The two-rank step is held against JAX's host reconstruction
(``tests/test_parallel.py:229-260``: ``_losses`` per shard with the mask
loss scaled by D, the gradients averaged, one optax Adam update) at the
port's float32 bar, and against the port's own in-process reconstruction
bitwise; a two-rank epoch against a reconstruction of its per-rank draws,
bitwise; a sharded pose against JAX's unsharded one (>= 60 dB, hit masks
equal) and the port's unsharded one (bitwise). Shapes as
tests/test_torch_train.py: L=2, 16+8 samples, width 32, deterministic
sampling. Every test runs in a fresh child process (``isolate``); the
ranks and the reconstructions run single-threaded, so that their float32
sums are the same sums.
"""

import copy
import json
import os
import socket

import numpy as np
import pytest

from test_torch_train import _batch, _cfg, _compact_pool, _leaves_close, _models, _scene
from test_torch_data import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.isolate

TARGET_DB = 60.0
K = np.array([[12.0, 0, 12], [0, 12, 8], [0, 0, 1]], np.float32)
H, W, CHUNK, TILE_COLS = 16, 24, 128, 16


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return np.inf if mse == 0 else -10.0 * np.log10(mse)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(fn, *args, world: int = 2):
    import torch.multiprocessing as mp

    mp.spawn(fn, args=(world, _free_port(), *args), nprocs=world, join=True)


def _join(rank: int, world: int, port: int):
    """Join a gloo group on the CPU as torchrun's environment describes it
    -> the mesh."""
    import torch

    from stnerf_tpu_torch.parallel import init_distributed, make_mesh

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    return make_mesh(device=init_distributed("cpu"))


def _port_model(cfg, path):
    import torch

    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec

    model = LayeredModel(LayeredSpec.from_cfg(cfg), device="cpu")
    model.load_state_dict(torch.load(path, weights_only=True))
    return model


def _train_cfg():
    cfg = _cfg()
    cfg.SOLVER.OPTIMIZER_NAME = "Adam"
    cfg.SOLVER.WEIGHT_DECAY = 0.0
    cfg.SOLVER.WARMUP_ITERS = 1
    cfg.MODEL.REMOVE_OUTLIERS = True
    return cfg


def _torch_scene():
    import torch

    from stnerf_tpu_torch.models import SceneBoxes

    return SceneBoxes(*map(torch.tensor, _scene()))


def _flat_params(model):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def test_mesh_helpers_and_one_rank_mesh(tmp_path):
    """``pad_for_mesh`` and ``shard_pool`` against JAX's on its 8-device
    mesh (``tests/test_parallel.py:29-33``, ``:149-163``): the eight ranks'
    slices, joined, are JAX's padded, sharded pool; ``shard_ray_batch``
    cuts the same slices; a mesh without a process group is one rank; a
    model axis without its process group is refused. Then a one-rank
    gloo group: ``do_train(mesh=)`` over two epochs (coarse only, then
    full; mid-epoch and per-epoch checkpoints) gives the unsharded run's
    losses and parameters bit for bit, and ``render_pose_host(mesh=)`` the
    unsharded pose."""
    import jax
    import jax.numpy as jnp
    import torch
    import torch.distributed as dist

    from stnerf_tpu.engine import shard_pool as jshard_pool
    from stnerf_tpu.engine.trainer import TrainBatch as JBatch
    from stnerf_tpu.models import RayInputs as JRays
    from stnerf_tpu.parallel import make_mesh as jmake_mesh
    from stnerf_tpu.parallel import pad_for_mesh as jpad
    from stnerf_tpu_torch.engine import (TrainBatch, do_train, make_optimizer,
                                         make_train_epoch, shard_pool)
    from stnerf_tpu_torch.models import EditState, RayInputs
    from stnerf_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS, DeviceMesh, make_mesh,
                                           pad_for_mesh, shard_params, shard_ray_batch)
    from stnerf_tpu_torch.render import render_pose_host

    jmesh = jmake_mesh()
    meshes = [DeviceMesh(8, 1, r, None, torch.device("cpu")) for r in range(8)]
    assert meshes[0].shape == {DATA_AXIS: 8, MODEL_AXIS: 1}
    for n, chunk in ((10, 1), (16, 1), (17, 4), (130, 1), (1, 64)):
        assert pad_for_mesh(n, meshes[0], chunk) == jpad(n, jmesh, chunk)

    rng = np.random.default_rng(0)
    n = 130  # not a multiple of 8
    rays, rgb, labels = _batch(rng, n)
    jpool, n_pad = jshard_pool(JBatch(JRays(*map(jnp.asarray, rays)), jnp.asarray(rgb),
                                      jnp.asarray(labels)), jmesh)
    pool = TrainBatch(RayInputs(*map(torch.tensor, rays)), torch.tensor(rgb),
                      torch.tensor(labels))
    shards = [shard_pool(pool, m) for m in meshes]
    assert {p for _, p in shards} == {n_pad} == {136}
    for i, ref in enumerate(jax.tree.leaves(jax.device_get(jpool))):
        got = torch.cat([jax.tree.leaves(s)[i] for s, _ in shards]).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref))
    padded = shards[0][0]._replace(rgb=torch.cat([s.rgb for s, _ in shards]))
    for m in meshes:
        np.testing.assert_array_equal(shard_ray_batch(m, padded.rgb).numpy(),
                                      shards[m.rank][0].rgb.numpy())
    with pytest.raises(ValueError):
        shard_ray_batch(meshes[0], pool.rgb)        # 130 rays over 8 ranks

    one = make_mesh(device="cpu")
    assert (one.data, one.model, one.rank, one.group) == (1, 1, 0, None)
    with pytest.raises(ValueError):
        make_mesh(model_parallel=2, device="cpu")    # one process, no model axis
    cfg = _train_cfg()
    base = _models(cfg)[2]
    with pytest.raises(ValueError, match="process group"):
        shard_params(DeviceMesh(1, 2, 0, None, torch.device("cpu")), base)
    opt, sched = make_optimizer(cfg, base)
    with pytest.raises(ValueError):
        make_train_epoch(base, opt, sched, mesh=DeviceMesh(2, 2, 0, None,
                                                           torch.device("cpu")),
                         device="cpu")

    torch.set_num_threads(1)
    mesh = _join(0, 1, _free_port())
    try:
        assert (mesh.data, mesh.rank, mesh.backend) == (1, 0, "gloo")
        cfg.SOLVER.IMS_PER_BATCH = 100
        cfg.SOLVER.MAX_EPOCHS = 3
        cfg.SOLVER.COARSE_STAGE = 2
        cfg.SOLVER.CHECKPOINT_PERIOD = 2
        runs = {}
        for name, m in (("plain", None), ("mesh", mesh)):
            model = copy.deepcopy(base)
            cfg.OUTPUT_DIR = str(tmp_path / name)
            h = do_train(cfg, model, _torch_scene(), _compact_pool(np.random.default_rng(1)),
                         mesh=m, seed=5, device="cpu")
            runs[name] = (h, _flat_params(model), sorted(os.listdir(cfg.OUTPUT_DIR)))
        (h0, p0, f0), (h1, p1, f1) = runs["plain"], runs["mesh"]
        assert [e for e, _ in h0] == [e for e, _ in h1] == [1, 2]
        for (_, a), (_, b) in zip(h0, h1):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert torch.equal(p0, p1) and not torch.equal(p0, _flat_params(base))
        assert f0 == f1 and "stnerf_torch_checkpoint_1_2.pt" in f0

        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0, 0, -5]
        args = (base, _torch_scene(), K, c2w, np.array([1.0, 2.0, 1.0], np.float32),
                np.array([0.5, 12.0], np.float32), EditState.identity(2), H, W)
        a = render_pose_host(*args, chunk=CHUNK, tile_cols=TILE_COLS)
        b = render_pose_host(*args, chunk=CHUNK, tile_cols=TILE_COLS, mesh=mesh)
        for x, y in zip([a[0], a[1], *a[2], *a[3]], [b[0], b[1], *b[2], *b[3]]):
            np.testing.assert_array_equal(x, y)
    finally:
        dist.destroy_process_group()


def _two_rank_worker(rank, world, port, tmp):
    """One sharded step on this rank's half of a fixed batch, a two-step
    do_train epoch from the same weights on a sharded pool, then the
    sharded pose (all layers, then two) and the sharded chunked render of
    100 rays."""
    import torch

    from stnerf_tpu_torch.engine import TrainBatch, do_train, make_optimizer, make_train_step
    from stnerf_tpu_torch.models import EditState, RayInputs, export_jax_params
    from stnerf_tpu_torch.render import render_pose_host, render_rays_chunked

    mesh = _join(rank, world, port)
    cfg = _train_cfg()
    model = _port_model(cfg, os.path.join(tmp, "model.pt"))
    rays, rgb, labels = _batch(np.random.default_rng(0))
    half = slice(rank * 24, (rank + 1) * 24)
    batch = TrainBatch(RayInputs(*(torch.tensor(x[half]) for x in rays)),
                       torch.tensor(rgb[half]), torch.tensor(labels[half]))
    opt, sched = make_optimizer(cfg, model)
    step = make_train_step(model, opt, sched, remove_outliers=True, device="cpu", mesh=mesh)
    m = step(_torch_scene(), batch, None, 1.0)
    out = {"grads": export_jax_params(model, grad=True), "params": _flat_params(model),
           "metrics": torch.stack(tuple(m))}

    cfg.SOLVER.IMS_PER_BATCH = 150
    cfg.SOLVER.MAX_EPOCHS = 2
    cfg.SOLVER.COARSE_STAGE = 1
    model = _port_model(cfg, os.path.join(tmp, "model.pt"))
    hist = do_train(cfg, model, _torch_scene(), _compact_pool(np.random.default_rng(2)),
                    mesh=mesh, seed=7, device="cpu")
    out["epoch_loss"] = torch.tensor(hist[0][1].loss)
    out["epoch_params"] = _flat_params(model)

    model = _port_model(cfg, os.path.join(tmp, "model.pt"))
    for name, layers in (("pose", None), ("pose_trim", [0, 2])):
        out[name] = render_pose_host(model, _torch_scene(), K, _c2w(), *_pose_args(),
                                     EditState.identity(2), H, W, chunk=CHUNK,
                                     tile_cols=TILE_COLS, download_layers=layers, mesh=mesh)
    rays = RayInputs(*_batch(np.random.default_rng(3), n=100)[0])
    out["chunked"] = render_rays_chunked(model, None, _torch_scene(), rays, chunk=CHUNK,
                                         mesh=mesh)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _c2w():
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.2, 0.3, -5]
    return c2w


def _pose_args():
    return np.array([1.0, 2.0, 1.0], np.float32), np.array([0.5, 12.0], np.float32)


def test_two_ranks_train_and_render(tmp_path):
    """Two ranks over gloo (one process each). One step: the reduced
    gradients against JAX's ``_losses`` per shard with ``mask_scale=2``,
    averaged (rtol 2e-3, atol 2e-3 max|g| per leaf; metrics rtol 1e-5), and
    bitwise against the port's own (g0 + g1) / 2; the parameters after Adam
    bitwise the in-process Adam step's and equal on both ranks. One epoch
    of two steps at batch 150 from a 300-ray pool: each rank's draws (seed,
    epoch, rank) and (seed, epoch, step, rank) reconstructed in-process,
    the parameters bitwise. A 16x24 pose (chunk 128: 64 rays a rank a
    chunk) and 100 rays in chunks of 128: every rank returns the whole,
    bitwise the port's unsharded render, and the pose >= 60 dB against
    JAX's unsharded ``render_pose_host`` with the hit masks equal; a render
    with a generator is refused over two ranks."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu import models as J
    from stnerf_tpu.engine.trainer import TrainBatch as JBatch
    from stnerf_tpu.engine.trainer import _losses as jlosses
    from stnerf_tpu.render.pose_device import render_pose_host as jpose
    from stnerf_tpu_torch.engine import (TrainBatch, make_decode, make_optimizer, shard_pool,
                                         sort_batch_by_hit, split_compact_bundle)
    from stnerf_tpu_torch.engine.trainer import _losses, _position_seed, _take
    from stnerf_tpu_torch.models import EditState, RayInputs, export_jax_params
    from stnerf_tpu_torch.parallel import DeviceMesh
    from stnerf_tpu_torch.render import render_pose_host, render_rays_chunked

    torch.set_num_threads(1)
    cfg = _train_cfg()
    jspec, params, model = _models(cfg)
    torch.save(model.state_dict(), str(tmp_path / "model.pt"))
    _spawn(_two_rank_worker, str(tmp_path))
    got = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    for key in ("params", "epoch_params"):
        assert torch.equal(got[0][key], got[1][key])

    # the renders: each rank's whole, the unsharded port's bit for bit
    tscene = _torch_scene()
    edits = EditState.identity(2)
    base = render_pose_host(model, tscene, K, _c2w(), *_pose_args(), edits, H, W,
                            chunk=CHUNK, tile_cols=TILE_COLS)
    trim = render_pose_host(model, tscene, K, _c2w(), *_pose_args(), edits, H, W,
                            chunk=CHUNK, tile_cols=TILE_COLS, download_layers=[0, 2])
    rays = RayInputs(*_batch(np.random.default_rng(3), n=100)[0])
    chunked = render_rays_chunked(model, None, tscene, rays, chunk=CHUNK)

    def flat(pose):
        return [pose[0], pose[1], *pose[2], *pose[3]]

    for g in got:
        for ref, key in ((base, "pose"), (trim, "pose_trim")):
            for a, b in zip(flat(g[key]), flat(ref)):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree.leaves(g["chunked"]), jax.tree.leaves(chunked)):
            np.testing.assert_array_equal(a, b)
    two = DeviceMesh(2, 1, 0, None, torch.device("cpu"))
    with pytest.raises(ValueError):
        render_rays_chunked(model, None, tscene, rays, chunk=CHUNK, mesh=two,
                            generator=torch.Generator().manual_seed(0))

    # the sharded pose against JAX's unsharded one
    scene = J.SceneBoxes(*map(jnp.asarray, _scene()))
    ref = jpose(params, jspec, scene, K, _c2w(), *_pose_args(), J.EditState.identity(2),
                H, W, chunk=CHUNK, tile_cols=TILE_COLS)
    pose = got[1]["pose"]
    for a, b in zip(flat(pose), flat(ref)):
        assert _psnr(a, b) >= TARGET_DB
    for a, b in zip(pose[3], ref[3]):   # a layer's hits: where its depth is set
        np.testing.assert_array_equal(a > 0, np.asarray(b) > 0)
    assert (pose[3][1] > 0).any() and not (pose[3][1] > 0).all()

    # JAX's host reconstruction of the sharded step
    rays, rgb, labels = _batch(np.random.default_rng(0))

    def jloss(p, jb):
        return jlosses(jspec, J.EditState.identity(2), True, p, scene, jb, None, 1.0,
                       False, mask_scale=2.0)

    jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    halves = [slice(0, 24), slice(24, 48)]
    grads, losses = [], []
    for half in halves:
        jb = JBatch(J.RayInputs(*(jnp.asarray(x[half]) for x in rays)),
                    jnp.asarray(rgb[half]), jnp.asarray(labels[half]))
        (_, raw), g = jgrad(params, jb)
        grads.append(g)
        losses.append(jax.device_get(raw))
    _leaves_close(got[0]["grads"],
                  jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2, *grads))
    metrics = got[0]["metrics"].numpy()  # loss, rgb, mask, psnr_c, psnr_f
    mean = {k: np.mean([float(getattr(x, k)) for x in losses])
            for k in ("loss", "mse_c", "mse_f", "mask")}
    np.testing.assert_allclose(metrics[0], mean["loss"], rtol=1e-5)
    np.testing.assert_allclose(metrics[1], mean["mse_c"] + mean["mse_f"], rtol=1e-5)
    np.testing.assert_allclose(metrics[2], mean["mask"], rtol=1e-5)

    # the port's own reconstruction: (g0 + g1) / 2, one Adam step
    gs = []
    for half in halves:
        batch = TrainBatch(RayInputs(*(torch.tensor(x[half]) for x in rays)),
                           torch.tensor(rgb[half]), torch.tensor(labels[half]))
        model.zero_grad(set_to_none=True)
        loss, _ = _losses(model, edits, True, tscene, batch, None, 1.0, False,
                          mask_scale=2.0)
        loss.backward()
        gs.append([p.grad.clone() for p in model.parameters()])
    opt, sched = make_optimizer(cfg, model)
    for p, g0, g1 in zip(model.parameters(), *gs):
        p.grad = (g0 + g1) / 2
    for a, b in zip(jax.tree.leaves(export_jax_params(model, grad=True)),
                    jax.tree.leaves(got[0]["grads"])):
        np.testing.assert_array_equal(a, b)
    opt.step()
    assert torch.equal(_flat_params(model), got[0]["params"])

    # the epoch: each rank's draws from its own generators, in-process
    model = _port_model(cfg, str(tmp_path / "model.pt"))
    cfg.SOLVER.IMS_PER_BATCH = 150
    opt, sched = make_optimizer(cfg, model)
    pool, tables, width = split_compact_bundle(_compact_pool(np.random.default_rng(2)), "cpu")
    decode = make_decode(tables, model.spec, width)
    shards = [shard_pool(pool, DeviceMesh(2, 1, r, None, torch.device("cpu")))[0]
              for r in range(2)]
    orders = [torch.randperm(150, generator=torch.Generator().manual_seed(
        _position_seed(7, 1, r)))[:150].reshape(2, 75) for r in range(2)]
    losses = []
    for i in range(2):
        gs, step_loss = [], 0.0
        for r in range(2):
            batch = sort_batch_by_hit(model.spec, tscene, decode(_take(shards[r], orders[r][i])))
            gen = torch.Generator().manual_seed(_position_seed(7, 1, i, r))
            opt.zero_grad(set_to_none=True)
            loss, _ = _losses(model, edits, True, tscene, batch, gen, 1.0, False,
                              mask_scale=2.0)
            loss.backward()
            step_loss += loss.detach()
            gs.append([p.grad.clone() for p in model.parameters()])
        for p, g0, g1 in zip(model.parameters(), *gs):
            p.grad = (g0 + g1) / 2
        opt.step()
        sched.step()
        losses.append(step_loss / 2)
    assert torch.equal(torch.stack(losses), got[0]["epoch_loss"])
    assert torch.equal(_flat_params(model), got[0]["epoch_params"])


def _cli_worker(rank, world, port, tmp, cfg_file):
    """The train CLI on this rank: one epoch, then --resume for one more;
    the pool cache writes (np.savez) and the checkpoint saves counted."""
    import numpy
    import torch

    from stnerf_tpu_torch.engine import trainer
    from stnerf_tpu_torch.tools import train

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    counts = {"savez": 0, "save_checkpoint": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    numpy.savez = counted("savez", numpy.savez)
    trainer.save_checkpoint = counted("save_checkpoint", trainer.save_checkpoint)
    args = ["-c", cfg_file, "--device", "cpu", "--workers", "1", "--seed", "3"]
    first = train.main(args)
    built = dict(counts)
    os.environ["MASTER_PORT"] = str(port + 1)
    resumed = train.main(args + ["--resume", "--epochs", "3"])
    result = {"built": built, "counts": counts,
              "first": [(e, m.loss.tolist()) for e, m in first],
              "resumed": [(e, m.loss.tolist()) for e, m in resumed]}

    # the renderer on the trained checkpoint over both ranks: rank 0 refines
    # the boxes, runs the gate and writes the frames
    from stnerf_tpu_torch.config import get_cfg
    from stnerf_tpu_torch.render import LayeredNeuralRenderer, renderer

    cfg = get_cfg()
    cfg.merge_from_file(cfg_file)
    cfg.TPU.OCC_GRID = 16                 # a small lattice and probe: the CPU's
    cfg.TPU.FIDELITY_PROBE_RES = 16       # plain fields are slow
    mesh = _join(rank, world, port + 2)
    written = []
    renderer.write_image = lambda path, img: written.append(path)
    r = LayeredNeuralRenderer(cfg, mesh=mesh, device="cpu")
    r.set_path_fixed_gt_poses(1, 2)
    r.render_path()
    pose = r.render_pose(r.poses[0], r.Ks[0], r.layer_frame_pairs[0])
    result.update(written=len(written), kept=len(r.images), fidelity_db=r.fidelity_db,
                  spec=str(r.spec), boxes=r.scene.boxes.tolist())
    torch.save(pose, os.path.join(tmp, f"pose{rank}.pt"))
    if rank == 0:
        alone = LayeredNeuralRenderer(cfg, device="cpu")
        torch.save(alone.render_pose(r.poses[0], r.Ks[0], r.layer_frame_pairs[0]),
                   os.path.join(tmp, "pose_alone.pt"))
    torch.distributed.destroy_process_group()
    with open(os.path.join(tmp, f"cli{rank}.json"), "w") as f:
        json.dump(result, f)


def test_train_cli_two_ranks(tmp_path, monkeypatch):
    """``tools/train.py`` as torchrun would start it, two ranks over gloo
    on the CPU on the synthetic scene: one short epoch, then ``--resume``
    from its checkpoint for one more. Rank 0 alone builds the pool (the
    other rank writes no cache file) and saves the checkpoints; both ranks
    log the same losses. ``--auto-restart`` and a ``TPU.MESH_DATA`` other
    than the world size are refused under two ranks. Then
    ``LayeredNeuralRenderer(mesh=)`` on the trained checkpoint with the
    config's approximations: both ranks render with rank 0's boxes, spec
    and gate reading, rank 0 alone writes and keeps frames, and a pose
    equals the one-process renderer's bit for bit."""
    import yaml

    from stnerf_tpu_torch.data import make_synthetic_scene
    from stnerf_tpu_torch.tools import train

    root = str(tmp_path / "scene")
    w, h = 24, 18
    make_synthetic_scene(root, width=w, height=h, num_cams=4, num_frames=2, seed=0)
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                           "config_synthetic.yml")) as f:
        raw = yaml.safe_load(f)
    raw["DATASETS"].update(TRAIN=root, FRAME_NUM=2)
    raw["INPUT"].update(SIZE_TRAIN=[w, h], SIZE_LAYER=[w, h], SIZE_TEST=[w, h])
    raw["MODEL"].update(COARSE_RAY_SAMPLING=8, FINE_RAY_SAMPLING=4, BACKBONE_DIM=32,
                        HEAD_DIM=16, MOTION_DIM=16)
    raw["SOLVER"].update(IMS_PER_BATCH=256, MAX_EPOCHS=2, COARSE_STAGE=1, WARMUP_ITERS=1,
                         LOG_PERIOD=4)
    raw["TPU"] = {"COMPUTE_DTYPE": "float32", "RENDER_CHUNK": 128}
    out = str(tmp_path / "out")
    raw["OUTPUT_DIR"] = out
    cfg_file = str(tmp_path / "cfg.yml")
    with open(cfg_file, "w") as f:
        yaml.safe_dump(raw, f)

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="max-restarts"):
        train.main(["-c", cfg_file, "--device", "cpu", "--auto-restart", "1"])
    raw["TPU"]["MESH_DATA"] = 3
    bad = str(tmp_path / "bad.yml")
    with open(bad, "w") as f:
        yaml.safe_dump(raw, f)
    with pytest.raises(SystemExit, match="nproc_per_node 3"):
        train.main(["-c", bad, "--device", "cpu"])
    monkeypatch.delenv("WORLD_SIZE")

    port = _free_port()
    import torch.multiprocessing as mp

    mp.spawn(_cli_worker, args=(2, port, str(tmp_path), cfg_file), nprocs=2, join=True)
    res = []
    for r in range(2):
        with open(tmp_path / f"cli{r}.json") as f:
            res.append(json.load(f))
    assert res[0]["built"]["savez"] > 0 and res[1]["built"]["savez"] == 0
    assert res[1]["counts"]["savez"] == 0
    assert res[0]["built"]["save_checkpoint"] == 1 and res[1]["counts"]["save_checkpoint"] == 0
    assert res[0]["counts"]["save_checkpoint"] == 2
    assert [e for e, _ in res[0]["first"]] == [1] and [e for e, _ in res[0]["resumed"]] == [2]
    assert res[0]["first"] == res[1]["first"] and res[0]["resumed"] == res[1]["resumed"]
    assert all(np.isfinite(x) for _, ls in res[0]["first"] + res[0]["resumed"] for x in ls)
    assert sorted(f for f in os.listdir(out) if f.endswith(".pt")) == [
        "stnerf_torch_checkpoint_1.pt", "stnerf_torch_checkpoint_2.pt"]

    import torch

    assert res[0]["written"] > 0 and res[1]["written"] == 0
    assert res[0]["kept"] == 2 and res[1]["kept"] == 0
    for key in ("fidelity_db", "spec", "boxes"):
        assert res[0][key] == res[1][key]
    assert res[0]["fidelity_db"] is not None
    poses = [torch.load(tmp_path / f, weights_only=False)
             for f in ("pose0.pt", "pose1.pt", "pose_alone.pt")]
    for a, b, c in zip(*(p[:2] + tuple(p[2]) + tuple(p[3]) for p in poses)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
