"""Rerun only the per-layer-scale drive of the taekwondo demo (the third
``run`` of ``taekwondo_demo``), with the same edits (the port's copy of
``demo/taekwondo_scale_only.py``).

    python -m stnerf_tpu_torch.demo.taekwondo_scale_only -c configs/config_taekwondo.yml
        [-g 0] [--device cpu]
"""

from __future__ import annotations

from . import parse_args, setup
from .taekwondo_demo import run


def main(argv=None):
    cfg, device = setup(parse_args(
        argv, "Render the taekwondo scene's per-layer-scale edit"))
    run(cfg, device, "scale", scale=[1, 0.75, 1.5])


if __name__ == "__main__":
    main()
