"""stnerf_tpu_torch — the PyTorch/CUDA port of ``stnerf_tpu``.

The JAX package beside it is the reference: every module here has a
counterpart of the same name there, and the tests hold each against it.
This package imports ``torch`` and never ``jax``, and nothing of the JAX
package: where it needs a module of that package's that does not import
jax (the config tree), it keeps its own copy. Its entry points run on the
CUDA card unless the caller names another device (``device="cpu"``).

Layout (mirrors ``stnerf_tpu``):
  config/    the config tree: keys, defaults, YAML merging
  data/      scenes on disk, training ray pools, validation views (NumPy,
             with its own PNG codec)
  ops/       encoding, ray sampling, compositing, metrics (plain PyTorch)
  models/    SpaceNet, MotionNet, the layered field and its render core
  kernels/   hand-written Hopper kernels, each beside its plain version
  engine/    losses, optimizer, checkpoints, the training step and loop,
             validation
  render/    whole-pose rendering in screen-tile order, chunked rendering,
             the ``LayeredNeuralRenderer`` front end (camera paths, edits,
             frame and video output)
  parallel/  process groups and the sharding policy (data-parallel
             training, ray-sharded rendering over ``torch.distributed``)
  native/    the C++ source of the host library (``data/native.py`` builds
             it with g++ at first use)
  tools/     entry points (``python -m stnerf_tpu_torch.tools.train``, also
             under ``torchrun``)
  demo/      the three demos (``python -m stnerf_tpu_torch.demo.walking_demo``)
  utils/     the TensorBoard event writer, profiling helpers

This carries the layered render path, exact or with the inference
approximations, rendering edited videos from the port's, the JAX
package's or the reference's checkpoints, and training from a scene on
disk (the fast fine stage too) with mid-epoch checkpoints, resumption from
any of those checkpoints and a crash supervisor, on one card or
data-parallel over several; the legacy per-field renderer with a
textured-mesh background.
"""

__version__ = "0.1.0"
