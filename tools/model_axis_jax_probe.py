"""How far the JAX package's layer-sharded render and training step lie
from its unsharded ones, on the CPU's virtual devices.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tools/model_axis_jax_probe.py

The shapes of the port's model-axis tests (tests/test_torch_model_axis.py):
L = 2, 16 + 8 samples, width 32, float32, deterministic sampling, 48 rays,
density biases raised (+0.3 background, +2 performers). Prints one JSON
line per comparison: the per-layer max abs difference of the coarse and
fine composites of ``render_rays`` with ``shard_params`` over
``make_mesh(model_parallel=2)`` against the same call with the parameters
replicated, and the loss and the worst gradient leaf (max abs difference
over max |g|) of ``make_train_step`` on the (4, 2) mesh, layer-sharded and
replicated, against the unsharded step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from stnerf_tpu import models as J  # noqa: E402
from stnerf_tpu.config import get_cfg  # noqa: E402
from stnerf_tpu.engine import make_train_step  # noqa: E402
from stnerf_tpu.engine.trainer import TrainBatch  # noqa: E402
from stnerf_tpu.parallel import make_mesh, replicate, shard_params, shard_ray_batch  # noqa: E402


def _cfg():
    cfg = get_cfg()
    cfg.DATASETS.LAYER_NUM = 2
    cfg.MODEL.COARSE_RAY_SAMPLING, cfg.MODEL.FINE_RAY_SAMPLING = 16, 8
    cfg.MODEL.SAMPLE_METHOD = "BBOX"
    cfg.MODEL.USE_SPACE_TIME = cfg.MODEL.USE_DEFORM_TIME = True
    cfg.MODEL.DEEP_RGB = cfg.MODEL.POSE_REFINEMENT = False
    cfg.MODEL.BACKBONE_DIM, cfg.MODEL.HEAD_DIM, cfg.MODEL.MOTION_DIM = 32, 16, 32
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.FAST_FINE = False
    cfg.TPU.EARLY_EXIT_SEGMENTS = 0
    return cfg


def _inputs(n: int = 48):
    rng = np.random.default_rng(0)
    o = np.tile(np.array([[0.0, 0.0, -5.0]], np.float32), (n, 1))
    d = np.stack([np.linspace(-0.4, 0.4, n), np.linspace(-0.1, 0.5, n), np.ones(n)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = J.RayInputs(jnp.asarray(o), jnp.asarray(d), jnp.full((n, 3), 2.0),
                       jnp.zeros(n), jnp.tile(jnp.array([[0.5, 12.0]]), (n, 1)))
    boxes = np.zeros((3, 2, 2, 3), np.float32)
    for f in range(3):
        boxes[f, 0] = [[-1 + 0.1 * f, -1, 1], [1 + 0.1 * f, 1, 3]]
        boxes[f, 1] = [[-1, 1.5, 1], [1, 3.5, 3]]
    scene = J.SceneBoxes(jnp.array([[-6.0] * 3, [6.0] * 3]), jnp.asarray(boxes),
                         jnp.array([0.5, 12.0]))
    return rays, rng.uniform(size=(n, 3)).astype(np.float32), rng.integers(0, 3, n), scene


def main():
    cfg = _cfg()
    spec = J.LayeredSpec.from_cfg(cfg)
    params = J.init_layered_params(jax.random.PRNGKey(0), spec)
    for group, delta in (("bkgd_coarse", 0.3), ("bkgd_fine", 0.3),
                         ("layers_coarse", 2.0), ("layers_fine", 2.0)):
        params[group]["density"][0]["b"] = params[group]["density"][0]["b"] + delta
    params = jax.tree.map(np.asarray, params)   # host copies: the step donates its own
    rays, rgb, labels, scene = _inputs()

    # the forward: layer-sharded against replicated, on a (1, 2) mesh
    render_spec = dataclasses.replace(spec, use_pallas=False, nosort_composite=True)
    render = jax.jit(lambda p, i, s: J.render_rays(p, render_spec, s, i,
                                                   J.EditState.identity(2), None))
    mesh = make_mesh(jax.devices()[:2], model_parallel=2)
    outs = {name: jax.device_get(render(place(mesh, params), replicate(mesh, rays),
                                        replicate(mesh, scene)))
            for name, place in (("replicated", replicate), ("sharded", shard_params))}
    row = {}
    for stage in ("coarse_layers", "fine_layers"):
        for key in ("color", "acc", "depth"):
            a, b = (np.asarray(getattr(getattr(outs[n], stage), key))
                    for n in ("replicated", "sharded"))
            row[f"{stage}.{key}"] = [float(np.abs(a[l] - b[l]).max()) for l in range(3)]
    print(json.dumps({"render_sharded_vs_replicated_max_abs_by_layer": row}), flush=True)

    # the step: gradients kept as the optimizer's state
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, state, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    step = make_train_step(spec, keep, remove_outliers=True)
    batch = TrainBatch(rays, jnp.asarray(rgb), jnp.asarray(labels))

    def run(mesh=None, place=None):
        p = jax.tree.map(jnp.asarray, params)
        b, s = batch, scene
        if mesh is not None:
            p, b, s = place(mesh, p), shard_ray_batch(mesh, batch), replicate(mesh, scene)
            with jax.sharding.set_mesh(mesh):
                _, g, m = step(p, keep.init(p), s, b, None, jnp.asarray(1.0))
        else:
            _, g, m = step(p, keep.init(p), s, b, None, jnp.asarray(1.0))
        return jax.device_get(g), float(m.loss)

    ref, ref_loss = run()
    mesh = make_mesh(model_parallel=2)
    for name, place in (("replicated", replicate), ("sharded", shard_params)):
        g, loss = run(mesh, place)
        worst = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()
                          / max(1e-3, float(np.abs(np.asarray(a)).max())))
                    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(g)))
        print(json.dumps({"step_on_4x2_mesh": name, "loss": loss, "unsharded_loss": ref_loss,
                          "worst_leaf_max_abs_over_max_abs_g": worst}), flush=True)


if __name__ == "__main__":
    main()
