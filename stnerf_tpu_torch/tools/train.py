"""Training entry point of the port (counterpart of the JAX package's
``tools/train.py``).

    python -m stnerf_tpu_torch.tools.train -c configs/config_synthetic.yml
        [--resume] [--epochs N] [--seed S] [--psnr-thres X] [--workers W]
        [--device cpu|cuda[:i]]

The flow is the JAX entry point's: the config, then the training ray pool
from the scene on disk (``data.make_train_data``, cached under
``DATASETS.TRAIN/TMP_RAYS``), then the model — fresh from ``--seed``, or
with ``--resume`` the newest of the port's checkpoints in ``OUTPUT_DIR``,
with its optimizer and schedule — then the optimizer with its frozen
groups, the validation callback (a warning and no validation when the
scene has no labeled views), and ``engine.do_train``. It runs on the CUDA
card unless ``--device`` names another. ``main(argv)`` runs in-process and
returns ``do_train``'s history.

Not ported yet: ``--auto-restart`` (the crash supervisor), resuming from a
reference ``.pt`` or a JAX ``.ckpt`` checkpoint (``--resume`` refuses them:
their optimizer state is not mapped onto torch's Adam; their parameters load
for rendering through ``engine.load_params_any``), and multi-GPU training. ``--model-parallel`` is accepted and ignored with a
warning, as in the JAX entry point: training replicates the parameters.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys


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
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)

    import numpy as np
    import torch

    from ..config import get_cfg
    from ..data import ViewScene, make_train_data
    from ..device import resolve_device
    from ..engine import (do_train, latest_checkpoint, load_checkpoint,
                          make_frozen_mask, make_optimizer, make_val_fn,
                          pool_camera_num)
    from ..models import LayeredModel, LayeredSpec

    cfg = get_cfg()
    cfg.merge_from_file(args.config)
    if args.epochs is not None:
        cfg.SOLVER.MAX_EPOCHS = args.epochs
    cfg.freeze()

    logger = _setup_logger("stnerf_tpu_torch.train", cfg.OUTPUT_DIR or None)
    device = resolve_device(args.device)
    logger.info("device: %s%s", device, f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")

    spec = LayeredSpec.from_cfg(cfg)
    logger.info("building training ray pool (cached under %s/%s)...",
                cfg.DATASETS.TRAIN, cfg.DATASETS.TMP_RAYS)
    pool, scene = make_train_data(cfg, spec, np.random.default_rng(args.seed),
                                  workers=args.workers, device=device)
    n_rays = pool["pix" if "pix" in pool else "rays"].shape[0]
    logger.info("ray pool: %d rays%s", n_rays,
                " (compact pixel format)" if "pix" in pool else "")
    if spec.pose_refinement:
        spec = dataclasses.replace(spec, camera_num=pool_camera_num(pool, spec))

    ckpt = latest_checkpoint(cfg.OUTPUT_DIR) if args.resume else None
    if ckpt and not os.path.basename(ckpt).startswith("stnerf_torch_checkpoint_"):
        raise ValueError(f"--resume found {ckpt}, a checkpoint of the JAX package or of "
                         "the reference; the port resumes only from its own "
                         "stnerf_torch_checkpoint_*.pt files (mapping a foreign optimizer "
                         "state onto torch's Adam is not ported yet). Its parameters load "
                         "for rendering: stnerf_tpu_torch.engine.load_params_any")
    model = LayeredModel(spec, torch.Generator().manual_seed(args.seed), device=device)

    mp = args.model_parallel or cfg.TPU.MESH_MODEL
    if mp != 1:
        logger.warning("epoch training replicates params; ignoring "
                       "model_parallel=%d (render-path option only)", mp)
    frozen_mask = make_frozen_mask(model, cfg.SOLVER.FROZEN_GROUPS)
    if frozen_mask is not None:
        logger.info("frozen param groups: %s (receive zero updates)",
                    list(cfg.SOLVER.FROZEN_GROUPS))
    optimizer, scheduler = make_optimizer(cfg, model, frozen_mask)

    resume_epoch = 0
    if ckpt:
        info = load_checkpoint(ckpt, model, optimizer, scheduler)
        resume_epoch = info["epoch"]
        logger.info("resumed %s (epoch %d)", ckpt, resume_epoch)

    val_fn = None
    try:
        view_scene = ViewScene(cfg)
        val_fn = make_val_fn(cfg, model.spec, scene, view_scene, logger)
    except (OSError, ValueError) as e:
        logger.warning("validation disabled: %s", e)

    return do_train(cfg, model, scene, pool, optimizer, scheduler, val_fn=val_fn,
                    resume_epoch=resume_epoch, psnr_thres=args.psnr_thres,
                    seed=args.seed, logger=logger, device=device)


if __name__ == "__main__":
    main()
