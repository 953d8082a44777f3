"""Walking-scene demo: render the original view path, then hide performer
layers one by one (layer edits without retraining) — the port's copy of
``demo/walking_demo.py`` (ref: demo/walking_demo.py:27-68).

    python -m stnerf_tpu_torch.demo.walking_demo -c configs/config_walking.yml
        [-g 0] [--device cpu]
"""

from __future__ import annotations

from . import demo_poses, parse_args, setup

DENSITY_THRESHOLD = 20        # raise to suppress translucent ghosting
BKGD_DENSITY_THRESHOLD = 0.8
INVERSE_Y_AXIS = False


def main(argv=None):
    from ..render import LayeredNeuralRenderer

    cfg, device = setup(parse_args(
        argv, "Render the layered walking scene with layer-hiding edits"))
    r = LayeredNeuralRenderer(cfg, device=device)
    r.set_fps(25)
    r.set_pose_duration(1, min(14, r.camera_num - 1))
    r.set_smooth_path_poses(demo_poses(100), around=False)
    r.set_near(4)
    r.invert_poses()

    for hide, name in ((None, "origin"), (1, "hide_man_1"), (2, "hide_both")):
        if hide is not None:
            r.hide_layer(hide)
        r.set_save_dir(name)
        r.render_path(INVERSE_Y_AXIS, DENSITY_THRESHOLD, BKGD_DENSITY_THRESHOLD,
                      auto_save=True)
        r.save_video()
    return r


if __name__ == "__main__":
    main()
