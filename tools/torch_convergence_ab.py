"""Convergence A/B of the port's trainer against the JAX package's, on the CPU.

    python tools/torch_convergence_ab.py [--runs a,b,c,d,e,f,g,h,i] [--work DIR]
        [--batch 1024] [--threads N] [--write-fixture]

Both packages train the same narrow model from the same initial parameters
on the same synthetic scene, each through its own ``engine.do_train`` with
its own draws, and after every epoch each runs its own
``engine.evaluate.do_evaluate`` on the same fixed views (cameras 0, 3, 6, 9;
frame indices 1 and 3: a random view per epoch, as ``make_val_fn`` picks,
would compare different images). The runs:

    a  JAX                                      seed 0
    b  JAX                                      seed 1
    c  port, sort-free (TPU.COMPOSITOR_KERNEL)  seed 0
    d  port, sorted merge                       seed 0
    e  JAX, initial weights nudged one float32 ulp    seed 0
    f  JAX                                      seed 2
    g  port, sort-free                          seed 1
    h  port, sort-free, initial weights nudged  seed 0
    i  port, sorted, initial weights nudged     seed 0

A seed keys every draw (batch order and sampling noise); the two packages'
generators never agree, so runs of the two packages share no draw. Runs
e, h and i differ from a, c and d only in round-off: they measure how far
each package's own round-off moves the curve.

The bar: each port run within 0.5 dB of a in mean PSNR at every epoch, or
within |a - b| at an epoch where JAX's two seeds differ by more. Beside it
the report prints, per epoch, each package's spread (the largest gap
between two of its runs) and the gap between the two packages' means.

Scene: ``make_synthetic_scene``'s defaults (200x150, 12 cameras, 5 frames,
L = 2, seed 0), written once under ``--work``. Config:
``configs/config_synthetic.yml`` (BBOX, 48+24 samples, mask loss, Adam at
4e-4, warmup 200) with the overrides in ``OVERRIDES``: widths 64/32/32,
float32, the pool cut to 61,440 rays, 6 epochs of 60 steps at batch 1024,
the first coarse only (COARSE_STAGE 2; the mask loss is on in epochs 1-2).
The initial parameters come from the port's ``LayeredModel`` on a seeded
generator, their density biases raised as ``chip_smoke.make_model`` raises
them (+2 performers, +0.02 background: at a fresh init's raw densities the
performers stay empty and get no gradient), rounded to float16 values
(held exactly in float32, so the fixture stores them in half the bytes),
exported with ``export_jax_params``.

Each run writes ``curve_<run>.json`` (mean PSNR per epoch, seconds per
step) under ``--work``, so runs may go in separate processes; every call
ends by printing the table of the curves there and the bar, and exits 1 if
c and d are there and a port run misses it. ``--write-fixture`` (after
run a) writes ``tests/torch_fixtures/trained_synthetic/``:

    layered_rfnr_checkpoint_0.ckpt  the initial parameters (float16 leaves)
    layered_rfnr_checkpoint_6.ckpt  run a's trained parameters
    curve.json    every run's curve, the sound runs' range per epoch, the
                  config file and its overrides (``opts``, a
                  ``merge_from_list`` list), the seeds, the commit
    renders.npz   JAX's renders of the six edit cases of
                  tests/test_torch_renderer.py at 100x75 from camera 0,
                  frame 1 (float16): ``exact_<case>`` on the exact path
                  (the mixed colour, then each layer's),
                  ``defaults_<case>`` with the config's approximations
                  (the gate off; the mixed colour), ``defaults_boxes``
                  their refined boxes

The checkpoints are JAX ``.ckpt`` files of parameters only, which the
port's ``engine.load_params_any`` reads. Rebuild the fixture after any
change to the synthetic scene, to the config's keys or to the JAX package.

The script imports both packages; it runs on the CPU only.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "trained_synthetic")
CONFIG = os.path.join(ROOT, "configs", "config_synthetic.yml")
VIEWS, FRAMES = [0, 3, 6, 9], [1, 3]
INIT_SEED = 0
# a fresh init's raw densities are about +-0.02: an empty scene, whose
# performer fields the mask loss shuts before they learn (their density
# ReLU then passes no gradient); raised as chip_smoke.make_model raises them
DENSITY_RAISE = {"layers_coarse": 2.0, "layers_fine": 2.0,
                 "bkgd_coarse": 0.02, "bkgd_fine": 0.02}
BAR_DB = 0.5
OVERRIDES = {
    "MODEL.BACKBONE_DIM": 64, "MODEL.HEAD_DIM": 32, "MODEL.MOTION_DIM": 32,
    "TPU.COMPUTE_DTYPE": "float32", "TPU.USE_PALLAS": False,
    "DATASETS.MAX_POOL_RAYS": 61440, "SOLVER.IMS_PER_BATCH": 1024,
    "SOLVER.MAX_EPOCHS": 7, "SOLVER.COARSE_STAGE": 2, "SOLVER.LOG_PERIOD": 20,
    "TPU.RENDER_CHUNK": 4096,
}
# run -> (package, training seed, TPU.COMPOSITOR_KERNEL, initial weights
# nudged one float32 ulp)
RUNS = {"a": ("jax", 0, False, False), "b": ("jax", 1, False, False),
        "c": ("torch", 0, True, False), "d": ("torch", 0, False, False),
        "e": ("jax", 0, False, True), "f": ("jax", 2, False, False),
        "g": ("torch", 1, True, False), "h": ("torch", 0, True, True),
        "i": ("torch", 0, False, True)}
# (name, renderer kwargs, layer hidden, performer frame) for the fixture's
# renders: test_torch_renderer._CASES at one pose, smooth_time as the
# performers between frames 1 and 2
RENDER_CASES = [
    ("plain", {}, None, 1.0),
    ("hide", {}, 1, 1.0),
    ("shift", {"shift": [[0, 0, 0], [0, 0.4, 0], [0, -0.4, 0]]}, None, 1.0),
    ("scale", {"scale": [1, 0.75, 1.5]}, None, 1.0),
    ("alpha", {"s_alpha": [1.0, 0.2]}, None, 1.0),
    ("smooth_time", {}, None, 1.5),
]
RENDER_SIZE = [100, 75]
# the fixture's two render paths: the exact one, and the config's
# approximations (fast fine stage, 3-segment march, occupancy boxes on a
# 64^3 lattice with an automatic tau) with the gate off, so that they render
RENDER_PATHS = {
    "exact": {"FAST_FINE": False, "EARLY_EXIT_SEGMENTS": 0, "FIDELITY_GATE": False,
              "OCCUPANCY_SKIP": False},
    "defaults": {"FIDELITY_GATE": False},
}


def opts(batch: int) -> list:
    """OVERRIDES (the batch as given) as a ``merge_from_list`` list."""
    return [x for kv in {**OVERRIDES, "SOLVER.IMS_PER_BATCH": batch}.items() for x in kv]


def make_cfg(package: str, scene: str, batch: int, compositor_kernel: bool = False):
    """configs/config_synthetic.yml with OVERRIDES, in ``package``'s tree."""
    if package == "jax":
        from stnerf_tpu.config import get_cfg
    else:
        from stnerf_tpu_torch.config import get_cfg
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(opts(batch))
    cfg.DATASETS.TRAIN = scene
    cfg.TPU.COMPOSITOR_KERNEL = compositor_kernel
    cfg.OUTPUT_DIR = ""
    return cfg


def ensure_scene(work: str) -> str:
    from stnerf_tpu_torch.data import make_synthetic_scene

    root = os.path.join(work, "scene")
    if not os.path.exists(os.path.join(root, "pose", "K.txt")):
        make_synthetic_scene(root)
    return root


def init_params(cfg) -> dict:
    """The port's seeded init with the density biases raised as
    chip_smoke.make_model raises them (+2 performers, +0.02 background),
    rounded to float16 values, as a JAX tree."""
    import jax
    import torch

    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec, export_jax_params

    model = LayeredModel(LayeredSpec.from_cfg(cfg),
                         generator=torch.Generator().manual_seed(INIT_SEED), device="cpu")
    params = export_jax_params(model)
    for group, delta in DENSITY_RAISE.items():
        params[group]["density"][0]["b"] = params[group]["density"][0]["b"] + delta
    return jax.tree.map(lambda v: np.asarray(v).astype(np.float16).astype(np.float32), params)


def _logger(run: str) -> logging.Logger:
    log = logging.getLogger(f"convergence_ab.{run}")
    log.setLevel(logging.INFO)
    if not log.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(f"[{run}] %(message)s"))
        log.addHandler(h)
    return log


def run_jax(run: str, seed: int, cfg, params: dict):
    """-> (mean PSNR per epoch, seconds per step, trained params)."""
    import jax

    from stnerf_tpu.data import ViewScene, make_train_data
    from stnerf_tpu.engine.evaluate import do_evaluate
    from stnerf_tpu.engine.solver import make_optimizer
    from stnerf_tpu.engine.trainer import do_train
    from stnerf_tpu.models import LayeredSpec

    spec = LayeredSpec.from_cfg(cfg)
    pool, scene = make_train_data(cfg, spec, np.random.default_rng(0), workers=1)
    views, curve, stamps = ViewScene(cfg), [], [time.time()]

    def val_fn(p, epoch):
        stamps.append(time.time())
        curve.append(do_evaluate(p, spec, scene, views, VIEWS, FRAMES,
                                 chunk=cfg.TPU.RENDER_CHUNK)["psnr"])
        _logger(run).info("epoch %d: mean PSNR %.4f", epoch, curve[-1])
        stamps.append(time.time())

    params, _ = do_train(cfg, spec, params, scene, pool, make_optimizer(cfg), val_fn=val_fn,
                         seed=seed, logger=_logger(run))
    return curve, _seconds_per_step(cfg, pool, stamps), jax.device_get(params)


def run_torch(run: str, seed: int, cfg, params: dict):
    import torch

    from stnerf_tpu_torch.data import ViewScene, make_train_data
    from stnerf_tpu_torch.engine import do_evaluate, do_train
    from stnerf_tpu_torch.models import LayeredModel, LayeredSpec, load_jax_params

    spec = LayeredSpec.from_cfg(cfg)
    pool, scene = make_train_data(cfg, spec, np.random.default_rng(0), workers=1,
                                  device="cpu")
    model = load_jax_params(LayeredModel(spec, device="cpu"), params)
    views, curve, stamps = ViewScene(cfg), [], [time.time()]

    def val_fn(m, epoch):
        stamps.append(time.time())
        with torch.no_grad():
            curve.append(do_evaluate(m, spec, scene, views, VIEWS, FRAMES,
                                     chunk=cfg.TPU.RENDER_CHUNK)["psnr"])
        _logger(run).info("epoch %d: mean PSNR %.4f", epoch, curve[-1])
        stamps.append(time.time())

    do_train(cfg, model, scene, pool, val_fn=val_fn, seed=seed, logger=_logger(run),
             device="cpu")
    return curve, _seconds_per_step(cfg, pool, stamps), None


def _seconds_per_step(cfg, pool, stamps) -> float:
    """Training seconds a step: the time between validations over the steps."""
    n = pool["pix"].shape[0] if "pix" in pool else pool["rays"].shape[0]
    steps = max(n // cfg.SOLVER.IMS_PER_BATCH, 1)
    train_s = sum(stamps[i + 1] - stamps[i] for i in range(0, len(stamps) - 1, 2))
    return train_s / (steps * (len(stamps) - 1) // 2)


def read_curves(work: str) -> dict:
    curves = {}
    for run in RUNS:
        path = os.path.join(work, f"curve_{run}.json")
        if os.path.exists(path):
            with open(path) as f:
                curves[run] = json.load(f)
    return curves


def spread(curves: dict, runs, epoch: int) -> float:
    """The largest gap between two of ``runs`` at ``epoch`` (0 for one)."""
    vals = [curves[r]["psnr"][epoch] for r in runs if r in curves]
    return max(vals) - min(vals) if vals else float("nan")


def report(work: str) -> int:
    """Print the curves under ``work``, the bar and each package's spread
    -> 1 if c and d are there and a port run misses the bar."""
    curves = read_curves(work)
    if not curves:
        print("no curves yet")
        return 0
    jax_runs = [r for r in curves if RUNS[r][0] == "jax"]
    port_runs = [r for r in curves if RUNS[r][0] == "torch"]
    epochs = min(len(c["psnr"]) for c in curves.values())
    print("epoch  " + "  ".join(f"{r:>8}" for r in curves)
          + "     bar  JAX spread  port spread  mean gap")
    failed = False
    for e in range(epochs):
        ps = {r: c["psnr"][e] for r, c in curves.items()}
        bar = BAR_DB
        if "a" in ps and "b" in ps:
            bar = max(BAR_DB, abs(ps["a"] - ps["b"]))
        mean_gap = (abs(np.mean([ps[r] for r in port_runs]) - np.mean([ps[r] for r in jax_runs]))
                    if jax_runs and port_runs else float("nan"))
        line = (f"{e + 1:5d}  " + "  ".join(f"{ps[r]:8.4f}" for r in curves)
                + f"  {bar:6.4f}  {spread(curves, jax_runs, e):10.4f}"
                  f"  {spread(curves, port_runs, e):11.4f}  {mean_gap:8.4f}")
        if "a" in ps:
            for r in port_runs:
                gap = abs(ps[r] - ps["a"])
                failed |= gap > bar
                line += f"  |{r}-a| {gap:.4f}{'' if gap <= bar else ' MISSED'}"
        print(line)
    for r, c in curves.items():
        print(f"run {r} ({c['package']}, seed {c['seed']}"
              f"{', ' + c['form'] if c.get('form') else ''}"
              f"{', nudged' if RUNS[r][3] else ''}): {c['s_per_step']:.3f} s a "
              f"training step at batch {c['batch']} on {c['cpus']} CPU cores")
    return 1 if failed and "c" in curves and "d" in curves else 0


def render_cfg(package: str, scene: str, output_dir: str, path: str):
    """The A/B's model config for the renderer at 100x75 on ``path``."""
    cfg = make_cfg(package, scene, OVERRIDES["SOLVER.IMS_PER_BATCH"])
    cfg.INPUT.SIZE_TEST = RENDER_SIZE
    cfg.OUTPUT_DIR = output_dir
    for k, v in RENDER_PATHS[path].items():
        cfg.TPU[k] = v
    return cfg


def write_fixture(work: str, scene: str, batch: int):
    """tests/torch_fixtures/trained_synthetic/ from run a and every curve
    under ``work``."""
    import pickle

    import jax

    from stnerf_tpu.engine.checkpoint import save_checkpoint
    from stnerf_tpu.render import LayeredNeuralRenderer

    with open(os.path.join(work, "params_a.pkl"), "rb") as f:
        trained = pickle.load(f)
    curves = read_curves(work)
    shutil.rmtree(FIXTURE, ignore_errors=True)
    os.makedirs(FIXTURE)
    save_checkpoint(FIXTURE, jax.tree.map(lambda v: v.astype(np.float16), load_init(work)),
                    None, 0)
    epochs = OVERRIDES["SOLVER.MAX_EPOCHS"] - 1
    ckpt = save_checkpoint(FIXTURE, trained, None, epochs)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip()
    dirty = bool(subprocess.run(["git", "status", "--porcelain", "--", "stnerf_tpu",
                                 "stnerf_tpu_torch", "configs"], cwd=ROOT,
                                capture_output=True, text=True).stdout.strip())
    n = min(len(c["psnr"]) for c in curves.values())
    meta = {"runs": {r: {"psnr": c["psnr"], "package": c["package"], "seed": c["seed"],
                         "form": c["form"], "nudged": RUNS[r][3]} for r, c in curves.items()},
            "sound_range": [[min(c["psnr"][e] for c in curves.values()),
                             max(c["psnr"][e] for c in curves.values())] for e in range(n)],
            "views": VIEWS, "frames": FRAMES, "init_seed": INIT_SEED,
            "init_density_raise": DENSITY_RAISE,
            "config": os.path.relpath(CONFIG, ROOT), "opts": opts(batch),
            "scene": "make_synthetic_scene defaults (200x150, 12 cameras, 5 frames, "
                     "L = 2, seed 0)",
            "bar_db": BAR_DB, "init": "layered_rfnr_checkpoint_0.ckpt",
            "checkpoint": os.path.basename(ckpt), "render_size": RENDER_SIZE,
            "render_paths": RENDER_PATHS,
            "render_cases": [[n, kw, h, f] for n, kw, h, f in RENDER_CASES],
            "commit": commit + (" (with uncommitted changes)" if dirty else "")}
    with open(os.path.join(FIXTURE, "curve.json"), "w") as f:
        json.dump(meta, f, indent=1)

    renders = {}
    for path in RENDER_PATHS:
        out_dir = os.path.join(work, f"render_{path}")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        shutil.copy(ckpt, out_dir)
        for name, kwargs, hidden, frame in RENDER_CASES:
            r = LayeredNeuralRenderer(render_cfg("jax", scene, out_dir, path), **kwargs)
            assert r._ckpt_path.endswith(meta["checkpoint"]), r._ckpt_path
            assert (r.scene is not r._exact_scene) == (path != "exact"), path
            if hidden is not None:
                r.hide_layer(hidden)
            pairs = [(0, 1.0)] + [(l, frame) for l in range(1, r.layer_num + 1)]
            c, d, cl, _ = r.render_pose(np.asarray(r.gt_poses[0]), np.asarray(r.gt_Ks[0]),
                                        pairs, frame_idx=0,
                                        download_layers=list(range(r.layer_num + 1)))
            # the exact path's mixed colour and layers, the approximate
            # path's mixed colour (the fixture's 2 MB)
            img = np.concatenate([c, *cl], -1) if path == "exact" else c
            renders[f"{path}_{name}"] = img.astype(np.float16)
        if path != "exact":
            renders[f"{path}_boxes"] = np.asarray(r.scene.boxes)
    np.savez_compressed(os.path.join(FIXTURE, "renders.npz"), **renders)
    size = sum(os.path.getsize(os.path.join(FIXTURE, f)) for f in os.listdir(FIXTURE))
    print(f"fixture written to {os.path.relpath(FIXTURE, ROOT)}: {size} bytes")


def load_init(work: str) -> dict:
    """The work directory's initial parameters (a JAX tree), made once."""
    import pickle

    path = os.path.join(work, "init.pkl")
    if not os.path.exists(path):
        with open(path, "wb") as f:
            pickle.dump(init_params(make_cfg("torch", ensure_scene(work),
                                             OVERRIDES["SOLVER.IMS_PER_BATCH"])), f)
    with open(path, "rb") as f:
        return pickle.load(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", default="a,b,c,d,e,f,g,h,i")
    p.add_argument("--work", default=os.path.join(ROOT, "build", "convergence_ab"))
    p.add_argument("--batch", type=int, default=OVERRIDES["SOLVER.IMS_PER_BATCH"])
    p.add_argument("--threads", type=int, default=0,
                   help="torch's intra-op threads for the port's runs (0: its default)")
    p.add_argument("--write-fixture", action="store_true")
    args = p.parse_args(argv)
    if args.threads:
        import torch
        torch.set_num_threads(args.threads)
    os.makedirs(args.work, exist_ok=True)
    scene = ensure_scene(args.work)
    params = load_init(args.work)
    for run in [r for r in args.runs.split(",") if r]:
        import jax

        package, seed, kernel, nudged = RUNS[run]
        cfg = make_cfg(package, scene, args.batch, kernel)
        start = time.time()
        init = (jax.tree.map(lambda v: np.nextafter(v, np.float32(np.inf)), params)
                if nudged else params)
        curve, s_step, trained = (run_jax if package == "jax" else run_torch)(
            run, seed, cfg, init)
        with open(os.path.join(args.work, f"curve_{run}.json"), "w") as f:
            json.dump({"psnr": curve, "package": package, "seed": seed,
                       "form": ("sort-free" if kernel else "sorted") if package == "torch"
                       else "", "s_per_step": s_step, "batch": args.batch,
                       "cpus": len(os.sched_getaffinity(0)), "seconds": time.time() - start},
                      f)
        if trained is not None and run == "a":
            import pickle
            with open(os.path.join(args.work, "params_a.pkl"), "wb") as f:
                pickle.dump(trained, f)
    if args.write_fixture:
        write_fixture(args.work, scene, args.batch)
    return report(args.work)


if __name__ == "__main__":
    sys.exit(main())
