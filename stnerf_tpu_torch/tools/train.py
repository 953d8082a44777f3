"""Training entry point of the port (counterpart of the JAX package's
``tools/train.py``).

    python -m stnerf_tpu_torch.tools.train -c configs/config_synthetic.yml
        [--resume] [--epochs N] [--seed S] [--psnr-thres X] [--workers W]
        [--auto-restart N] [--device cpu|cuda[:i]]
    torchrun --nproc_per_node N -m stnerf_tpu_torch.tools.train -c CONFIG ...

The flow is the JAX entry point's: the config, then the training ray pool
from the scene on disk (``data.make_train_data``, cached under
``DATASETS.TRAIN/TMP_RAYS``), then the model — fresh from ``--seed``, or
with ``--resume`` from the newest checkpoint in ``OUTPUT_DIR``: the port's
own (model, optimizer and schedule, mid-epoch files re-entering their
epoch at their step), a JAX ``.ckpt`` (parameters, its optax state mapped
onto torch's optimizer, its epoch and step) or a reference ``.pt``
(parameters, a fresh optimizer, epoch 0) — then the optimizer with its
frozen groups, the TensorBoard event writer at ``OUTPUT_DIR/tb``, the
validation callback (a warning and no validation when the scene has no
labeled views), and ``engine.do_train``. It runs on the CUDA card unless
``--device`` names another. ``main(argv)`` runs in-process and returns
``do_train``'s history.

``--auto-restart N`` supervises the run (:func:`supervise`): the training
runs in a child process, relaunched with ``--resume`` up to N times after
a crash, so at most the steps since the last checkpoint are lost
(``SOLVER.CHECKPOINT_PERIOD``). The supervisor imports no torch and never
initialises CUDA: one process owns the card.

Under ``torchrun`` (``WORLD_SIZE`` > 1) the run trains data-parallel over
the ranks, one card each (``cuda:LOCAL_RANK``, NCCL; gloo on the CPU with
``--device cpu``): the parameters replicated from rank 0, each rank on its
slice of the pool, one ``all_reduce`` a step (``engine.do_train(mesh=)``).
``TPU.MESH_DATA`` -1 takes every rank; any other value must equal the
world size. Rank 0 builds the ray pool and its cache, the other ranks load
that cache after it; rank 0 alone logs, validates, writes events and saves
checkpoints, and with ``--resume`` every rank loads the same file.
``--auto-restart`` is refused under torchrun: a restart must take down
every rank, which torchrun's own ``--max-restarts`` does.
``--model-parallel`` is accepted and ignored with a warning, as in the JAX
entry point: training replicates the parameters (the library shards the
performer fields over a model axis: ``parallel.shard_params``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import subprocess
import sys
import time

_BACKOFF_S = (15, 30, 60, 120, 300)  # then 300 s between further restarts


def _setup_logger(name: str, save_dir: str | None) -> logging.Logger:
    """Stream + file logger (ref: utils/logger.py:12-30)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
        ch = logging.StreamHandler(sys.stdout)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(save_dir, "log.txt"), mode="w")
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def supervise(cmd, restarts, backoffs=_BACKOFF_S, run=None):
    """Run ``cmd`` (argv list); on a nonzero exit relaunch it up to
    ``restarts`` times with growing backoff, ``--resume`` appended once.
    -> the final exit code (0 on any success). ``run`` launches a command
    (default ``subprocess.call``)."""
    run = run or subprocess.call
    for attempt in range(restarts + 1):
        rc = run(cmd)
        if rc == 0:
            return 0
        if attempt == restarts:
            return rc
        wait = backoffs[min(attempt, len(backoffs) - 1)]
        print(f"[supervise] attempt {attempt + 1} exited rc={rc}; relaunching with "
              f"--resume in {wait}s ({restarts - attempt} restarts left)",
              file=sys.stderr, flush=True)
        time.sleep(wait)
        if "--resume" not in cmd:
            cmd = cmd + ["--resume"]
    return rc


def _child_argv(argv: list) -> list:
    """``argv`` without its ``--auto-restart N`` / ``--auto-restart=N``."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--auto-restart":
            skip = True
        elif not a.startswith("--auto-restart="):
            out.append(a)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a layered ST-NeRF with the "
                                            "PyTorch port")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in OUTPUT_DIR")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--psnr-thres", type=float, default=100.0,
                   help="early-stop when mean epoch PSNR exceeds this")
    p.add_argument("--model-parallel", type=int, default=None,
                   help="ignored: training replicates the parameters")
    p.add_argument("--workers", type=int, default=None,
                   help="ray-pregeneration processes (default: "
                        "DATALOADER.NUM_WORKERS capped at host CPUs)")
    p.add_argument("--auto-restart", type=int, default=0, metavar="N",
                   help="supervise the run: relaunch it with --resume up to N times "
                        "after a crash")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))   # the ranks torchrun started
    if args.auto_restart > 0 and world > 1:
        raise SystemExit("--auto-restart supervises one process; under torchrun "
                         "restart every rank with torchrun's --max-restarts instead")
    if args.auto_restart > 0:
        # the supervisor: the run is a child process with the same flags
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        cmd = [sys.executable, "-u", "-m", "stnerf_tpu_torch.tools.train"] + _child_argv(argv)
        sys.exit(supervise(cmd, args.auto_restart,
                           run=lambda c: subprocess.call(c, env=env)))

    import torch

    from ..config import get_cfg
    from ..device import resolve_device
    from ..parallel import init_distributed, make_mesh

    cfg = get_cfg()
    cfg.merge_from_file(args.config)
    if args.epochs is not None:
        cfg.SOLVER.MAX_EPOCHS = args.epochs
    cfg.freeze()
    if cfg.TPU.MESH_DATA not in (-1, world):
        raise SystemExit(f"TPU.MESH_DATA {cfg.TPU.MESH_DATA} does not match the {world} "
                         "rank(s) started: launch with torchrun --nproc_per_node "
                         f"{cfg.TPU.MESH_DATA}, or set TPU.MESH_DATA -1 (all ranks)")

    mesh = None
    if world > 1:
        device = init_distributed(args.device)
        mesh = make_mesh(device=device)
    else:
        device = resolve_device(args.device)
    main_rank = mesh is None or mesh.is_main
    logger = _setup_logger("stnerf_tpu_torch.train",
                           (cfg.OUTPUT_DIR or None) if main_rank else None)
    if not main_rank:
        logger.setLevel(logging.WARNING)  # rank 0 alone logs
    logger.info("device: %s%s%s", device, f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "",
                f", rank 0 of {world} ({mesh.backend})" if mesh is not None else "")

    try:
        return _train(args, cfg, mesh, device, logger)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _train(args, cfg, mesh, device, logger) -> list:
    import numpy as np
    import torch

    from ..data import ViewScene, make_train_data
    from ..engine import (do_train, latest_checkpoint, make_frozen_mask, make_optimizer,
                          make_val_fn, pool_camera_num, resume_checkpoint)
    from ..models import LayeredModel, LayeredSpec
    from ..parallel import shard_params
    from ..utils import EventWriter

    main_rank = mesh is None or mesh.is_main
    spec = LayeredSpec.from_cfg(cfg)
    logger.info("building training ray pool (cached under %s/%s)...",
                cfg.DATASETS.TRAIN, cfg.DATASETS.TMP_RAYS)
    # the pool is built once: rank 0 fills the cache, the others read it
    if not main_rank:
        mesh.barrier()
    pool, scene = make_train_data(cfg, spec, np.random.default_rng(args.seed),
                                  workers=args.workers, device=device)
    if main_rank and mesh is not None:
        mesh.barrier()
    n_rays = pool["pix" if "pix" in pool else "rays"].shape[0]
    logger.info("ray pool: %d rays%s", n_rays,
                " (compact pixel format)" if "pix" in pool else "")
    if spec.pose_refinement:
        spec = dataclasses.replace(spec, camera_num=pool_camera_num(pool, spec))

    ckpt = latest_checkpoint(cfg.OUTPUT_DIR) if args.resume else None
    model = LayeredModel(spec, torch.Generator().manual_seed(args.seed), device=device)

    mp = args.model_parallel or cfg.TPU.MESH_MODEL
    if mp != 1:
        logger.warning("epoch training replicates params; ignoring "
                       "model_parallel=%d (render-path option only)", mp)
    if mesh is not None:
        shard_params(mesh, model)
    frozen_mask = make_frozen_mask(model, cfg.SOLVER.FROZEN_GROUPS)
    if frozen_mask is not None:
        logger.info("frozen param groups: %s (receive zero updates)",
                    list(cfg.SOLVER.FROZEN_GROUPS))
    optimizer, scheduler = make_optimizer(cfg, model, frozen_mask)

    resume_epoch = resume_step = 0
    if ckpt:
        info = resume_checkpoint(ckpt, cfg, model, optimizer, scheduler)
        # a mid-epoch file (step > 0) re-enters its epoch at that step
        resume_step = info["step"]
        resume_epoch = info["epoch"] - (1 if resume_step else 0)
        logger.info("resumed %s (epoch %d, step %d)%s", ckpt, info["epoch"], resume_step,
                    "" if info["optimizer"] else ": parameters only, a fresh optimizer")

    # rank 0 alone validates and writes events
    swriter = (EventWriter(os.path.join(cfg.OUTPUT_DIR, "tb"))
               if cfg.OUTPUT_DIR and main_rank else None)
    val_fn = None
    if main_rank:
        try:
            view_scene = ViewScene(cfg)
            val_fn = make_val_fn(cfg, model.spec, scene, view_scene, logger, swriter)
        except (OSError, ValueError) as e:
            logger.warning("validation disabled: %s", e)

    try:
        return do_train(cfg, model, scene, pool, optimizer, scheduler, mesh=mesh,
                        val_fn=val_fn, resume_epoch=resume_epoch, resume_step=resume_step,
                        psnr_thres=args.psnr_thres, seed=args.seed, logger=logger,
                        device=device, swriter=swriter)
    finally:
        if swriter is not None:
            swriter.close()


if __name__ == "__main__":
    main()
