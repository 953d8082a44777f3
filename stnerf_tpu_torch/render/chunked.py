"""Chunked rendering of any number of rays (counterpart of
``stnerf_tpu/render/chunked.py``).

The rays are padded to a whole number of chunks (the last ray repeated),
moved to the model's device once, and rendered chunk by chunk through
``render_rays``; the outputs come back as host numpy arrays with the padding
cut off. Per-layer outputs keep their leading (L+1) axis.

With a mesh (``parallel.make_mesh``) of D data ranks each rank renders
its contiguous 1/D of every chunk, and the ranks' outputs are gathered
once at the end over the data group; every rank returns the whole. The
chunk is rounded up to a multiple of D x 64, so that no 64-ray tile of the
field kernel straddles two ranks and each rank's tiles are the unsharded
render's. A layer-sharded model (``parallel.shard_params``) shards the
fields over the model axis besides: each rank evaluates the background and
its own performers, and every chunk's field outputs are gathered over the
model group inside ``render_rays``.
"""

from __future__ import annotations

import torch

from ..models.layered import (EditState, LayeredModel, LayeredSpec, RayInputs,
                              RenderOutputs, SceneBoxes, render_rays)
from ..parallel import gather_chunked

TILE = 64  # rays of one skip flag of the field kernel


def shard_chunk(chunk: int, mesh) -> int:
    """``chunk`` rounded up to a multiple of D x 64 (unchanged without a
    mesh)."""
    if mesh is None:
        return chunk
    q = mesh.data * TILE
    return -(-chunk // q) * q


def render_rays_chunked(model: LayeredModel, spec: LayeredSpec | None, scene: SceneBoxes,
                        inputs: RayInputs, edits: EditState | None = None, *,
                        chunk: int = 8192, generator: torch.Generator | None = None,
                        mesh=None, only_coarse: bool = False) -> RenderOutputs:
    """Render ``inputs`` (numpy arrays or tensors, N rays) with ``spec``
    (None: the model's; see ``render_rays``) -> RenderOutputs of numpy
    arrays. ``generator`` None samples deterministically; with a mesh over
    several ranks it must be None."""
    if mesh is not None and mesh.data > 1 and generator is not None:
        raise ValueError("a render sharded over several ranks samples "
                         "deterministically: pass generator=None")
    device = next(model.parameters()).device
    lp1 = model.spec.layer_num + 1
    edits = edits if edits is not None else EditState.identity(lp1 - 1, device=device)
    chunk = shard_chunk(chunk, mesh)
    n = int(inputs.rays_o.shape[0])
    n_pad = -(-n // chunk) * chunk
    D, r = (1, 0) if mesh is None else (mesh.data, mesh.rank)
    part = chunk // D

    def upload(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        if n_pad != n:
            x = torch.cat([x, x[-1:].expand(n_pad - n, *x.shape[1:])])
        return x

    rays = RayInputs(*(upload(x) for x in inputs))
    scene = SceneBoxes(*(t.to(device) for t in scene))
    outs = []
    for start in range(r * part, n_pad, chunk):
        piece = RayInputs(*(x[start:start + part] for x in rays))
        outs.append(render_rays(model, scene, piece, edits, generator,
                                only_coarse=only_coarse, spec=spec))

    # per-layer leaves carry the (L+1) axis first: pieces join along rays
    pieces, rebuild = zip(*(_flatten(o) for o in outs))
    dims = [1 if x.dim() >= 2 and x.shape[0] == lp1 and x.shape[1] == part else 0
            for x in pieces[0]]
    leaves = [torch.cat(xs, d) for xs, d in zip(zip(*pieces), dims)]
    if mesh is not None:
        leaves = gather_chunked(mesh, leaves, dims, n_pad // chunk)
    return rebuild[0]([(x[:, :n] if d else x[:n]).cpu().numpy()
                       for x, d in zip(leaves, dims)])


def _flatten(tree):
    """-> (leaves, rebuild(leaves) -> a tree of ``tree``'s structure)."""
    if not isinstance(tree, tuple):
        return [tree], lambda leaves: leaves[0]
    subs = [_flatten(x) for x in tree]
    sizes = [len(leaves) for leaves, _ in subs]

    def rebuild(leaves):
        out, i = [], 0
        for (_, fn), k in zip(subs, sizes):
            out.append(fn(leaves[i:i + k]))
            i += k
        return type(tree)(*out)

    return [x for leaves, _ in subs for x in leaves], rebuild
