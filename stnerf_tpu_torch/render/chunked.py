"""Chunked rendering of any number of rays (counterpart of
``stnerf_tpu/render/chunked.py``).

The rays are padded to a whole number of chunks (the last ray repeated),
moved to the model's device once, and rendered chunk by chunk through
``render_rays``; the outputs come back as host numpy arrays with the padding
cut off. Per-layer outputs keep their leading (L+1) axis. Sharding the
chunks over several cards (the JAX package's ``mesh``) is not ported yet.
"""

from __future__ import annotations

import torch

from ..models.layered import (EditState, LayeredModel, LayeredSpec, RayInputs,
                              RenderOutputs, SceneBoxes, render_rays)


def render_rays_chunked(model: LayeredModel, spec: LayeredSpec | None, scene: SceneBoxes,
                        inputs: RayInputs, edits: EditState | None = None, *,
                        chunk: int = 8192, generator: torch.Generator | None = None,
                        mesh=None, only_coarse: bool = False) -> RenderOutputs:
    """Render ``inputs`` (numpy arrays or tensors, N rays) with ``spec``
    (None: the model's; see ``render_rays``) -> RenderOutputs of numpy
    arrays. ``generator`` None samples deterministically."""
    if mesh is not None:
        raise NotImplementedError("multi-GPU rendering is not ported to "
                                  "stnerf_tpu_torch yet")
    device = next(model.parameters()).device
    lp1 = model.spec.layer_num + 1
    edits = edits if edits is not None else EditState.identity(lp1 - 1, device=device)
    n = int(inputs.rays_o.shape[0])
    n_pad = -(-n // chunk) * chunk

    def upload(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        if n_pad != n:
            x = torch.cat([x, x[-1:].expand(n_pad - n, *x.shape[1:])])
        return x

    rays = RayInputs(*(upload(x) for x in inputs))
    scene = SceneBoxes(*(t.to(device) for t in scene))
    outs = []
    for start in range(0, n_pad, chunk):
        part = RayInputs(*(x[start:start + chunk] for x in rays))
        outs.append(render_rays(model, scene, part, edits, generator,
                                only_coarse=only_coarse, spec=spec))

    def join(leaves):
        per_layer = leaves[0].dim() >= 2 and leaves[0].shape[0] == lp1 \
            and leaves[0].shape[1] == chunk
        x = torch.cat(leaves, 1 if per_layer else 0)
        return (x[:, :n] if per_layer else x[:n]).cpu().numpy()

    def walk(items):
        first = items[0]
        if isinstance(first, tuple):
            return type(first)(*(walk([it[i] for it in items]) for i in range(len(first))))
        return join(items)

    return walk(outs)
