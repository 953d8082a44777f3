"""stnerf_tpu_torch — the PyTorch/CUDA port of ``stnerf_tpu``.

The JAX package beside it is the reference: every module here has a
counterpart of the same name there, and the tests hold each against it.
This package imports ``torch`` and never ``jax``; the one import from the
JAX package is its framework-free config tree (``stnerf_tpu.config``).

Layout (mirrors ``stnerf_tpu``):
  config.py  ``get_cfg`` re-exported from the shared config tree
  ops/       encoding, ray sampling, compositing (plain PyTorch)
  models/    SpaceNet, MotionNet, the layered field and its render core
  kernels/   hand-written Hopper kernels, each beside its plain version
  render/    whole-pose rendering in screen-tile order

This slice carries the exact layered render path (inference). Training,
the renderer front end and the inference approximations are not ported yet
(ROADMAP.md, Queue 1).
"""

__version__ = "0.1.0"
