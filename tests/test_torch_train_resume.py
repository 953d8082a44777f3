"""The port's training entry point beyond the exact step, against the JAX
package's on the CPU: ``composite_streams_nosort``, a training step with
the fast fine stage (FAST_FINE_TRAIN) in both compositor forms, resuming
from a JAX ``.ckpt`` (its optax state mapped onto torch's optimizer) and
from a reference ``.pt``, mid-epoch checkpoints and validation with the
event writer, the ``--auto-restart`` supervisor, and the augmenting
``JointTransform`` against the JAX package's PIL version. Shapes as
tests/test_torch_train.py (L=2, 16+8 samples, width 32). Every test runs
in a fresh child process (``isolate``).
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_train import _batch, _cfg, _compact_pool, _leaves_close, _models, _scene
from test_torch_data import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.isolate


def _streams(rng, lengths=(24, 9, 24, 9), n=37):
    """Ascending streams of unequal length with cross-stream ties, a
    saturated sample and rays parked at one depth (a missed layer's)."""
    ts = [np.sort(rng.uniform(0.5, 16, size=(n, s)), -1).astype(np.float32)
          for s in lengths]
    ts[1][:5, 2:5] = ts[0][:5, 3:6]          # exact ties across streams
    ts[3][:4, 0] = ts[2][:4, 7]
    ts[2][5:8] = -1e3                        # parked: every sample at MISS_T
    ts = [np.sort(t, -1) for t in ts]
    rgbs = [rng.normal(size=(3, n, s)).astype(np.float32) for s in lengths]
    sigs = [rng.normal(size=(n, s)).astype(np.float32) for s in lengths]
    sigs[0][:3, 4] = 1e6                     # saturated: a zero factor
    return ts, rgbs, sigs


def test_composite_streams_nosort_matches_jax(rng):
    """Values at rtol 1e-5, atol 1e-6 and the rgb / sigma gradients at
    tests/test_ops.py:526-535's bars; the backward keeps no (N, S_a, S_b)
    tensor alive (the precedence masks are rebuilt from the depths)."""
    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu.ops.volume import composite_streams_nosort as jcomp
    from stnerf_tpu_torch.ops.volume import composite_streams_nosort

    ts, rgbs, sigs = _streams(rng)
    n = ts[0].shape[0]

    def jloss(rgbs, sigs, reduce=True):
        out = jcomp([(jnp.asarray(t), r, s) for t, r, s in zip(ts, rgbs, sigs)], 1e10)
        return (jnp.sum(out.color ** 2) + jnp.sum(out.acc) + jnp.sum(out.depth)
                + jnp.sum(out.weights ** 2)) if reduce else out

    args = ([jnp.asarray(r) for r in rgbs], [jnp.asarray(s) for s in sigs])
    ref = jax.jit(lambda r, s: jloss(r, s, False))(*args)
    g_r, g_s = jax.jit(jax.grad(jloss, (0, 1)))(*args)
    r_t = [torch.tensor(r, requires_grad=True) for r in rgbs]
    s_t = [torch.tensor(s, requires_grad=True) for s in sigs]
    saved = []

    def pack(x):
        saved.append(x.numel())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = composite_streams_nosort(
            [(torch.tensor(t), r, s) for t, r, s in zip(ts, r_t, s_t)], 1e10)
    for name in ("color", "depth", "acc", "weights"):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    smallest_cube = n * min(len(t[0]) for t in ts) ** 2
    assert max(saved) < smallest_cube, (max(saved), smallest_cube)
    (out.color.pow(2).sum() + out.acc.sum() + out.depth.sum()
     + out.weights.pow(2).sum()).backward()
    for a, b in zip(r_t, g_r):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    for a, b in zip(s_t, g_s):
        assert np.isfinite(a.grad.numpy()).all()
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_fast_fine_train_step_matches_jax(rng, monkeypatch):
    """A FAST_FINE_TRAIN training step (the port's ``_losses`` with
    ``training_spec``) against JAX's ``_losses`` with its trainer's spec
    (sort-free, fast fine kept), as test_train_step_matches_jax does for
    the exact step: loss and every gradient leaf at rtol 2e-3, atol 2e-3
    max|g|, in both of the port's compositor forms: sort-free
    (``composite_streams_nosort``, K4/K5's plain versions on the coarse
    stage) and sorted (payload sort and the sorted merge, gradient-equal up
    to reassociation). FAST_FINE_EPS 0 with raised densities: every hit ray
    keeps its fine samples, so the port's skip flags cut only what JAX
    masks."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch

    from stnerf_tpu import models as J
    from stnerf_tpu.engine.trainer import TrainBatch as JBatch
    from stnerf_tpu.engine.trainer import _losses as jlosses
    from stnerf_tpu_torch import models as T
    from stnerf_tpu_torch.engine import training_spec
    from stnerf_tpu_torch.engine.trainer import TrainBatch, _losses
    from stnerf_tpu_torch.models import layered

    cfg = _cfg()
    cfg.TPU.FAST_FINE_TRAIN = True
    cfg.TPU.FAST_FINE_EPS = 0.0
    jspec, params, _ = _models(cfg)
    jspec = dataclasses.replace(jspec, use_pallas=False, nosort_composite=True,
                                coarse_exit_segments=0, fast_fine=True)
    scene = _scene()
    rays, rgb, labels = _batch(rng)
    jbatch = JBatch(J.RayInputs(*map(jnp.asarray, rays)), jnp.asarray(rgb),
                    jnp.asarray(labels))

    def jloss(p):
        return jlosses(jspec, J.EditState.identity(2), True, p,
                       J.SceneBoxes(*map(jnp.asarray, scene)), jbatch, None, 1.0, False)

    (v_j, raw_j), g_j = jax.device_get(jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params))
    calls = {"streams": 0}
    real = layered.composite_streams_nosort

    def counted(*a, **k):
        calls["streams"] += 1
        return real(*a, **k)

    monkeypatch.setattr(layered, "composite_streams_nosort", counted)
    batch = TrainBatch(T.RayInputs(*map(torch.tensor, rays)), torch.tensor(rgb),
                       torch.tensor(labels))
    for nosort in (True, False):
        cfg.TPU.COMPOSITOR_KERNEL = nosort
        model = _models(cfg)[2]
        spec = training_spec(model.spec)
        assert spec.fast_fine and spec.nosort_composite == nosort
        calls["streams"] = 0
        v_t, raw_t = _losses(model, T.EditState.identity(2), True,
                             T.SceneBoxes(*map(torch.tensor, scene)), batch, None, 1.0, False,
                             spec=spec)
        v_t.backward()
        assert calls["streams"] == (4 if nosort else 0)  # 3 layers + the merged pixel
        np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=2e-5)
        np.testing.assert_allclose(float(raw_t.mask), float(raw_j.mask), rtol=2e-5)
        _leaves_close(T.export_jax_params(model, grad=True), g_j)


def _jax_ckpt(tmp_path, cfg, params, rng, steps: int = 2):
    """``steps`` optax updates of the JAX optimizer for ``cfg`` (frozen
    groups from SOLVER.FROZEN_GROUPS) on seeded gradients, saved mid-epoch
    as the JAX trainer saves -> (path, params, optax state, the jitted
    step(grads, state, params) -> (params, state))."""
    import jax
    import optax

    from stnerf_tpu.engine import save_checkpoint
    from stnerf_tpu.engine.solver import make_frozen_mask, make_optimizer

    tx = make_optimizer(cfg, make_frozen_mask(params, cfg.SOLVER.FROZEN_GROUPS))

    @jax.jit
    def step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    state = tx.init(params)
    for _ in range(steps):
        grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        params, state = jax.device_get(step(grads, state, params))
    path = save_checkpoint(str(tmp_path), params, state, epoch=1, step=steps)
    return path, params, state, step


def test_resume_from_jax_ckpt_matches_optax(rng, tmp_path):
    """A JAX ``.ckpt`` saved mid-epoch after two optax steps (Adam with
    weight decay, warmup and a frozen group; SGD with momentum), resumed by
    the port: parameters, Adam moments or momentum and the schedule's
    count restored, then one more update on the same gradients matches
    optax's at test_optimizer_updates_match_optax's bar."""
    import jax

    from stnerf_tpu_torch.engine import make_frozen_mask, make_optimizer, resume_checkpoint
    from stnerf_tpu_torch.models import export_jax_params, load_jax_params

    for name in ("Adam", "SGD"):
        cfg = _cfg()
        cfg.SOLVER.OPTIMIZER_NAME = name
        cfg.SOLVER.BASE_LR = 1e-2
        cfg.SOLVER.WEIGHT_DECAY = 0.05
        cfg.SOLVER.WARMUP_ITERS = 3
        cfg.SOLVER.FROZEN_GROUPS = ["bkgd_fine"]
        _, params, model = _models(cfg)
        path, params, state, step = _jax_ckpt(tmp_path / name, cfg, params, rng)
        opt, sched = make_optimizer(cfg, model, make_frozen_mask(model, ["bkgd_fine"]))
        info = resume_checkpoint(path, cfg, model, opt, sched)
        assert info == {"epoch": 1, "step": 2, "optimizer": True}
        assert sched.last_epoch == 2
        _leaves_close(export_jax_params(model), params, rtol=0, scale_atol=0)
        grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        params, state = jax.device_get(step(grads, state, params))
        holder = load_jax_params(type(model)(model.spec, device="cpu"), grads)
        for p, g in zip(model.parameters(), holder.parameters()):
            p.grad = g.detach().clone()
        opt.step()
        sched.step()
        _leaves_close(export_jax_params(model), params, rtol=1e-5, scale_atol=1e-6)


def test_resume_refuses_another_optimizer_and_imports_a_reference_pt(rng, tmp_path):
    """A JAX state whose structure does not fit the config raises
    (FROZEN_GROUPS set or unset across the resume, weight decay turned off,
    another optimizer);
    a reference ``.pt`` resumes at epoch 0 with its parameters and a fresh
    optimizer; the newest checkpoint ranks an epoch's own file after its
    mid-epoch files."""
    import torch

    from stnerf_tpu_torch.engine import (export_reference_checkpoint, latest_checkpoint,
                                         make_frozen_mask, make_optimizer, resume_checkpoint)
    from stnerf_tpu_torch.models import export_jax_params

    def adam(frozen):
        cfg = _cfg()
        cfg.SOLVER.OPTIMIZER_NAME = "Adam"
        cfg.SOLVER.FROZEN_GROUPS = frozen
        return cfg

    cfg = adam(["bkgd_fine"])
    _, params, model = _models(cfg)
    path = _jax_ckpt(tmp_path / "jax", cfg, params, rng, steps=0)[0]
    for key, value in (("FROZEN_GROUPS", []), ("WEIGHT_DECAY", 0.0),
                       ("OPTIMIZER_NAME", "SGD")):
        other = adam(["bkgd_fine"])
        other.SOLVER[key] = value
        opt, sched = make_optimizer(other, model, make_frozen_mask(
            model, other.SOLVER.FROZEN_GROUPS))
        with pytest.raises(ValueError, match="changed across the resume"):
            resume_checkpoint(path, other, model, opt, sched)
    plain_path = _jax_ckpt(tmp_path / "plain", adam([]), params, rng, steps=0)[0]
    with pytest.raises(ValueError, match="changed across the resume"):
        resume_checkpoint(plain_path, cfg, model,
                          *make_optimizer(cfg, model, make_frozen_mask(model, ["bkgd_fine"])))

    _, ref_params, ref_model = _models(_cfg())
    with torch.no_grad():
        for p in ref_model.parameters():
            p.add_(0.01)
    pt = export_reference_checkpoint(str(tmp_path / "layered_rfnr_checkpoint_5.pt"),
                                     ref_model)
    _, _, fresh = _models(_cfg())
    opt, sched = make_optimizer(_cfg(), fresh)
    assert resume_checkpoint(pt, _cfg(), fresh, opt, sched) == {
        "epoch": 0, "step": 0, "optimizer": False}
    _leaves_close(export_jax_params(fresh), export_jax_params(ref_model), rtol=0,
                  scale_atol=0)
    assert not opt.state and sched.last_epoch == 0

    out = tmp_path / "order"
    out.mkdir()
    for name in ("stnerf_torch_checkpoint_2_10.pt", "stnerf_torch_checkpoint_2.pt",
                 "stnerf_torch_checkpoint_1_30.pt", "layered_rfnr_checkpoint_1.ckpt"):
        (out / name).touch()
    assert os.path.basename(latest_checkpoint(str(out))) == "stnerf_torch_checkpoint_2.pt"
    (out / "stnerf_torch_checkpoint_3_5.pt").touch()
    assert os.path.basename(latest_checkpoint(str(out))) == "stnerf_torch_checkpoint_3_5.pt"


def test_mid_epoch_save_resume_and_events(rng, tmp_path):
    """do_train on the CPU with CHECKPOINT_PERIOD and VAL_PERIOD 2 at four
    steps an epoch: ``_{epoch}_2`` files and validation at the global
    steps; a run resumed from ``_2_2`` gives the uninterrupted run's losses
    from step 2 on, bitwise; a resume at an epoch's last step skips it. The
    event file holds JAX's four tags at the global steps, and the port's
    writer gives JAX's records up to wall time."""
    import torch

    from stnerf_tpu.utils.tb_writer import EventWriter as JWriter
    from stnerf_tpu_torch.engine import do_train, load_checkpoint, make_optimizer
    from stnerf_tpu_torch.models import SceneBoxes
    from stnerf_tpu_torch.utils import EventWriter, read_events

    cfg = _cfg()
    s = cfg.SOLVER
    s.IMS_PER_BATCH, s.MAX_EPOCHS, s.COARSE_STAGE, s.WARMUP_ITERS = 75, 3, 2, 1
    s.LOG_PERIOD, s.CHECKPOINT_PERIOD, s.VAL_PERIOD = 1, 2, 2
    cfg.MODEL.REMOVE_OUTLIERS = True
    cfg.OUTPUT_DIR = str(tmp_path / "run")
    scene = SceneBoxes(*map(torch.tensor, _scene()))
    pool = _compact_pool(rng)
    _, _, model = _models(cfg)
    opt, sched = make_optimizer(cfg, model)
    val = []
    writer = EventWriter(str(tmp_path / "tb"))
    full = do_train(cfg, model, scene, pool, opt, sched, device="cpu", swriter=writer,
                    val_fn=lambda m, epoch, step=None: val.append((epoch, step)))
    writer.close()
    assert [e for e, _ in full] == [1, 2]
    assert val == [(1, 2), (1, None), (2, 6), (2, None)]
    for name in ("1_2", "1", "2_2", "2"):
        assert os.path.exists(os.path.join(cfg.OUTPUT_DIR,
                                           f"stnerf_torch_checkpoint_{name}.pt")), name

    _, _, again = _models(cfg)
    opt, sched = make_optimizer(cfg, again)
    info = load_checkpoint(os.path.join(cfg.OUTPUT_DIR, "stnerf_torch_checkpoint_2_2.pt"),
                           again, opt, sched)
    assert info == {"epoch": 2, "step": 2}
    cfg.OUTPUT_DIR = str(tmp_path / "resumed")
    resumed = do_train(cfg, again, scene, pool, opt, sched, device="cpu",
                       resume_epoch=1, resume_step=2)
    assert [e for e, _ in resumed] == [2]
    for a, b in zip(resumed[0][1], full[1][1]):
        np.testing.assert_array_equal(a, b[2:])
    for x, y in zip(again.parameters(), model.parameters()):
        assert torch.equal(x, y)
    records = []
    log = logging.getLogger("test_resume_skip")
    log.addHandler(logging.Handler())
    log.handlers[-1].emit = records.append
    log.setLevel(logging.INFO)
    assert do_train(cfg, again, scene, pool, opt, sched, device="cpu", resume_epoch=1,
                    resume_step=4, logger=log) == []
    assert any("already complete" in r.getMessage() for r in records)

    (path,) = [os.path.join(tmp_path / "tb", f) for f in os.listdir(tmp_path / "tb")]
    events = read_events(path)
    tags = ("Loss/train_loss", "TrainPsnr", "Loss/mask_loss", "Loss/rgb_loss")
    assert [(st, tag) for st, tag, _ in events] == [(st, tag) for st in range(8)
                                                    for tag in tags]
    assert [v for _, tag, v in events if tag == "Loss/train_loss"] == pytest.approx(
        np.concatenate([m.loss for _, m in full]).tolist(), rel=1e-6)

    img = rng.uniform(size=(3, 5, 7)).astype(np.float32)
    dirs = []
    for cls, sub in ((JWriter, "jax"), (EventWriter, "port")):
        w = cls(str(tmp_path / sub))
        w.add_scalar("Val/psnr", 21.5, 7)
        w.add_image("stage2/rendered", img, 7)
        w.add_image("stage2/alpha", img[:1], 8)
        w.close()
        (f,) = os.listdir(tmp_path / sub)
        dirs.append(read_events(str(tmp_path / sub / f)))
    assert dirs[0] == dirs[1] == [(7, "Val/psnr", 21.5), (7, "stage2/rendered", (5, 7, 3)),
                                  (8, "stage2/alpha", (5, 7, 1))]
    for sub in ("jax", "port"):  # the payloads, wall times cut out
        (f,) = os.listdir(tmp_path / sub)
        dirs.append(_payloads(str(tmp_path / sub / f)))
    assert dirs[2] == dirs[3]


def _payloads(path):
    """Each event record's payload without its wall time (field 1, a
    double: 9 bytes at the start)."""
    import struct

    out, data = [], open(path, "rb").read()
    i = 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        payload = data[i + 12:i + 12 + n]
        assert payload[0] == 0x09
        out.append(payload[9:])
        i += 16 + n
    return out


def test_supervise_and_auto_restart():
    """``supervise`` as tests/test_engine.py holds JAX's: retries until a
    success with ``--resume`` appended once, gives up after N restarts,
    runs once with none; ``--auto-restart N`` relaunches the entry point
    as a child with the other flags, and the supervisor loads no torch."""
    from stnerf_tpu_torch.tools import train

    calls = []

    def fake_run(cmd):
        calls.append(list(cmd))
        return 1 if len(calls) < 3 else 0

    assert train.supervise(["prog", "-c", "x.yml"], restarts=5, backoffs=(0,),
                           run=fake_run) == 0
    assert len(calls) == 3 and "--resume" not in calls[0]
    assert calls[1][-1] == "--resume" and calls[2].count("--resume") == 1
    calls.clear()
    assert train.supervise(["prog"], restarts=2, backoffs=(0,),
                           run=lambda c: calls.append(1) or 7) == 7 and len(calls) == 3
    calls.clear()
    assert train.supervise(["prog"], restarts=0, backoffs=(0,),
                           run=lambda c: calls.append(1) or 3) == 3 and len(calls) == 1

    # the supervisor in a process of its own: it launches the child (here a
    # stand-in for subprocess.call) and never imports torch
    code = ("import json, sys\n"
            "from stnerf_tpu_torch.tools import train\n"
            "calls = []\n"
            "train.subprocess.call = lambda c, env=None: calls.append([c, env]) or 0\n"
            "try:\n"
            "    train.main(['-c', 'x.yml', '--auto-restart', '2', '--seed', '3',\n"
            "                '--auto-restart=4', '--device', 'cpu'])\n"
            "except SystemExit as e:\n"
            "    print(json.dumps([e.code, calls, 'torch' in sys.modules]))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=120,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    rc, launched, torch_loaded = json.loads(r.stdout.strip().splitlines()[-1])
    assert rc == 0 and not torch_loaded
    (cmd, env), = launched
    assert cmd == [sys.executable, "-u", "-m", "stnerf_tpu_torch.tools.train", "-c",
                   "x.yml", "--seed", "3", "--device", "cpu"]
    assert env["PYTHONPATH"].split(os.pathsep)[0] == root


def test_joint_transform_matches_pil(rng):
    """The augmenting ``JointTransform`` against the JAX package's PIL one
    on seeded images, the same draws: rotation, shift, ratio, a mask, an
    image off SIZE_TRAIN, and all at once. Image and ROI within one u8 step
    on every pixel, labels equal, K and T within 1e-5."""
    from stnerf_tpu.data.transforms import JointTransform as JTransform
    from stnerf_tpu_torch.data.transforms import JointTransform

    size = (48, 64)
    cases = {"rotation": ({"random_rotation": 30}, size, False),
             "shift": ({"random_range": 5}, size, False),
             "ratio": ({"random_ratio": 0.3}, size, False),
             "mask": ({}, size, True),
             "resize": ({}, (75, 90), False),
             "all": ({"random_rotation": 20, "random_range": 3, "random_ratio": 0.2},
                     (61, 101), True)}
    for name, (kw, (h, w), masked) in cases.items():
        img = np.clip(rng.normal(128, 60, (h, w, 3)), 0, 255).astype(np.uint8)
        lab = rng.integers(0, 3, (h, w)).astype(np.uint8)
        K = np.array([[50, 0, w / 2 + 1.3], [0, 52, h / 2 - 0.7], [0, 0, 1]], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.1, 0.2, 0.3]
        for seed in range(2):
            mask = lab > 0 if masked else None
            ref = JTransform(size, rng=np.random.default_rng(seed), **kw)(img, K, T, lab, mask)
            got = JointTransform(size, rng=np.random.default_rng(seed), **kw)(
                img, K, T, lab, mask)
            for what, a, b, tol in (("image", 0, 0, 1 / 255 + 1e-6),
                                    ("roi", 4, 4, 1 / 255 + 1e-6),
                                    ("K", 2, 2, 1e-5), ("T", 3, 3, 1e-5)):
                assert got[a].shape == ref[b].shape, (name, what)
                np.testing.assert_allclose(got[a], ref[b], rtol=0, atol=tol,
                                           err_msg=f"{name} {what}")
            np.testing.assert_array_equal(got[1], ref[1], err_msg=f"{name} label")
            assert got[0].shape == (3,) + size and got[1].shape == (1,) + size
