"""stnerf_tpu_torch — the PyTorch/CUDA port of ``stnerf_tpu``.

The JAX package beside it is the reference: every module here has a
counterpart of the same name there, and the tests hold each against it.
This package imports ``torch`` and never ``jax``, and nothing of the JAX
package: where it needs a module of that package's that does not import
jax (the config tree), it keeps its own copy. Its entry points run on the
CUDA card unless the caller names another device (``device="cpu"``).

Layout (mirrors ``stnerf_tpu``):
  config/    the config tree: keys, defaults, YAML merging
  ops/       encoding, ray sampling, compositing, metrics (plain PyTorch)
  models/    SpaceNet, MotionNet, the layered field and its render core
  kernels/   hand-written Hopper kernels, each beside its plain version
  engine/    losses, optimizer, checkpoints, the training step and loop
  render/    whole-pose rendering in screen-tile order

This carries the exact layered render path and training. The data path,
the renderer front end and the inference approximations are not ported yet
(ROADMAP.md, Queue 1).
"""

__version__ = "0.1.0"
