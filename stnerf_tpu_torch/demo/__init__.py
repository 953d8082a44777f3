"""The JAX package's three demos (``demo/*.py``) on the port:

    python -m stnerf_tpu_torch.demo.taekwondo_demo -c CONFIG [-g 0] [--device cpu]
    python -m stnerf_tpu_torch.demo.taekwondo_scale_only -c CONFIG [-g 0] [--device cpu]
    python -m stnerf_tpu_torch.demo.walking_demo -c CONFIG [-g 0] [--device cpu]

Each renders the newest checkpoint under the config's ``OUTPUT_DIR`` with
the same call sequence, key frames and thresholds as its JAX counterpart,
and writes PNG frames under ``OUTPUT_DIR/rendered``. ``-g i`` renders on
``cuda:i``; ``--device`` names another device. ``STNERF_DEMO_POSES`` trims
the camera path. Each module's ``main(argv)`` runs in-process.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def parse_args(argv, description: str) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-c", "--config", default="", help="scene config YAML")
    p.add_argument("-g", "--gpu", type=int, default=0,
                   help="render on cuda:GPU (unless --device is given)")
    p.add_argument("--device", default=None,
                   help="torch device to render on (default: cuda:GPU)")
    return p.parse_args(argv)


def setup(args: argparse.Namespace):
    """-> (frozen cfg, device) for a demo, with the renderer's log lines
    going to stdout."""
    from ..config import get_cfg

    logger = logging.getLogger("stnerf_tpu_torch.render")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(handler)
    cfg = get_cfg()
    cfg.merge_from_file(args.config)
    cfg.freeze()
    return cfg, args.device or f"cuda:{args.gpu}"


def demo_poses(default: int) -> int:
    """The camera path's pose count: ``STNERF_DEMO_POSES`` or the reference
    demo's."""
    return int(os.environ.get("STNERF_DEMO_POSES", default))
