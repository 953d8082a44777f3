"""Taekwondo-scene demo: retime both performers onto a common timeline, then
render the original, per-layer-shifted and per-layer-scaled versions — all
edits applied at render time without retraining (the port's copy of
``demo/taekwondo_demo.py``; ref: demo/taekwondo_demo.py:25-72).

    python -m stnerf_tpu_torch.demo.taekwondo_demo -c configs/config_taekwondo.yml
        [-g 0] [--device cpu]
"""

from __future__ import annotations

from . import demo_poses, parse_args, setup

KEY_FRAMES_LAYER_1 = [21, 49, 74, 87]  # performer 1's own timeline
KEY_FRAMES_LAYER_2 = [13, 42, 80, 90]  # performer 2's own timeline
KEY_FRAMES = [20, 50, 74, 85]          # common output timeline
DENSITY_THRESHOLD = 0
INVERSE_Y_AXIS = False


def run(cfg, device, name, **renderer_kwargs):
    from ..render import LayeredNeuralRenderer

    r = LayeredNeuralRenderer(cfg, device=device, **renderer_kwargs)
    r.set_save_dir(name)
    r.set_fps(25)
    r.set_smooth_path_poses(demo_poses(101), around=False)
    r.retime_by_key_frames(1, KEY_FRAMES_LAYER_1, KEY_FRAMES)
    r.retime_by_key_frames(2, KEY_FRAMES_LAYER_2, KEY_FRAMES)
    r.render_path(INVERSE_Y_AXIS, DENSITY_THRESHOLD, auto_save=True)
    r.save_video()
    return r


def main(argv=None):
    cfg, device = setup(parse_args(
        argv, "Render the taekwondo scene with retiming/shift/scale edits"))
    run(cfg, device, "origin")
    run(cfg, device, "shift", shift=[[0, 0, 0], [0, 2, 0], [0, -2, 0]])
    run(cfg, device, "scale", scale=[1, 0.75, 1.5])


if __name__ == "__main__":
    main()
