"""Write the synthetic validation scene (the reference's dataset layout) with
the port's generator: the JAX package's ``tools/make_synthetic.py`` with
the same flags, without PIL or JAX.

    python -m stnerf_tpu_torch.tools.make_synthetic --root data/synthetic
        [--width 200 --height 150 --cams 12 --frames 5 --layers 2 --seed 0
         --bbox-slack 0 --blobs 1 --blob-spread 0 --blob-axis -1
         --label-noise 0]

``main(argv)`` runs in-process.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Write the synthetic layered scene.")
    p.add_argument("--root", default="data/synthetic")
    p.add_argument("--width", type=int, default=200)
    p.add_argument("--height", type=int, default=150)
    p.add_argument("--cams", type=int, default=12)
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bbox-slack", type=float, default=0.0,
                   help="inflate performer hull boxes by this fraction via "
                        "invisible outlier points (loose-box regime)")
    p.add_argument("--blobs", type=int, default=1,
                   help="spheres per performer body; >1 = articulated "
                        "performers whose PLY hulls carry interior gaps")
    p.add_argument("--blob-spread", type=float, default=0.0,
                   help="how far limb blobs articulate from the torso "
                        "(world units, grows over the sequence)")
    p.add_argument("--blob-axis", type=int, default=-1,
                   help="articulate limbs along this world axis (0/1/2) "
                        "with small transverse jitter; -1 = random 3D "
                        "directions")
    p.add_argument("--label-noise", type=float, default=0.0,
                   help="boundary-biased segmentation label error rate "
                        "(plus rate/10 uniform salt)")
    args = p.parse_args(argv)

    from ..data import make_synthetic_scene

    make_synthetic_scene(args.root, width=args.width, height=args.height,
                         num_cams=args.cams, num_frames=args.frames,
                         layer_num=args.layers, seed=args.seed,
                         bbox_slack=args.bbox_slack, blobs=args.blobs,
                         blob_spread=args.blob_spread, blob_axis=args.blob_axis,
                         label_noise=args.label_noise)
    print(f"synthetic scene written to {args.root}: {args.cams} cams x "
          f"{args.frames} frames x {args.layers}+1 layers at "
          f"{args.width}x{args.height}")


if __name__ == "__main__":
    main()
