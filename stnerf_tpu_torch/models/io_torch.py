"""Reference-checkpoint interchange — the port's copy of
``stnerf_tpu/models/io_torch.py``.

Converts between the reference's torch ``state_dict`` layout
(``layered_rfnr_checkpoint_*.pt``; key structure defined by
ref: modeling/layered_rfrender.py:59-93, modeling/spacenet.py:45-86,
modeling/motion_net.py:20-32, layers/camera_transform.py:57-58) and the JAX
package's parameter pytree (numpy leaves), in both directions and key for
key as the JAX module does. ``models.convert`` moves such a pytree into and
out of a :class:`~stnerf_tpu_torch.models.LayeredModel`.

torch stores Linear weights as (out, in); the pytree uses (in, out).
"""

from __future__ import annotations

import numpy as np
import torch

# Sequential indices of the Linear modules inside each reference block.
_STAGE1_IDX = (0, 2, 4, 6)
_STAGE2_IDX = (0, 2, 4)
_RGB_IDX = (1, 3)            # Sequential(ReLU, Linear, ReLU, Linear)
_RGB_DEEP_IDX = (1, 3, 5, 7)
_MOTION_IDX = (0, 2, 4, 6, 8, 10)


def _get(sd: dict, key: str) -> np.ndarray:
    v = sd[key]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _linear_from(sd, prefix):
    return {"w": _get(sd, f"{prefix}.weight").T.copy(),
            "b": _get(sd, f"{prefix}.bias")}


def _spacenet_from(sd, prefix, deep_rgb):
    rgb_idx = _RGB_DEEP_IDX if deep_rgb else _RGB_IDX
    return {
        "stage1": [_linear_from(sd, f"{prefix}.stage1.{i}") for i in _STAGE1_IDX],
        "stage2": [_linear_from(sd, f"{prefix}.stage2.{i}") for i in _STAGE2_IDX],
        "density": [_linear_from(sd, f"{prefix}.density_net.0")],
        "rgb": [_linear_from(sd, f"{prefix}.rgb_net.{i}") for i in rgb_idx],
    }


def _motionnet_from(sd, prefix):
    return {"net": [_linear_from(sd, f"{prefix}.motion_net.{i}") for i in _MOTION_IDX]}


def _stack(trees: list):
    """Stack equally shaped nested dicts/lists of arrays leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_stack(list(items)) for items in zip(*trees)]
    return np.stack(trees)


def params_from_state_dict(sd: dict, spec) -> dict:
    """Reference state_dict -> parameter pytree (numpy leaves)."""
    deep = spec.deep_rgb
    L = spec.layer_num
    params = {
        "bkgd_coarse": _spacenet_from(sd, "bkgd_spacenet", deep),
        "bkgd_fine": _spacenet_from(sd, "bkgd_spacenet_fine", deep),
        "layers_coarse": _stack([_spacenet_from(sd, f"spacenets.{i}", deep)
                                 for i in range(L)]) if L else {},
    }
    if not spec.same_spacenet:
        params["layers_fine"] = _stack([_spacenet_from(sd, f"spacenets_fine.{i}", deep)
                                        for i in range(L)]) if L else {}
    if spec.use_deform_time and L:
        params["motion"] = _stack([_motionnet_from(sd, f"time_deform_nets.{i}")
                                   for i in range(L)])
    if spec.bkgd_use_deform_time:
        params["bkgd_motion"] = _motionnet_from(sd, "bkgd_time_deform_net")
    if spec.use_deform_view:
        params["view_deform"] = _motionnet_from(sd, "view_deform_net")
    if spec.pose_refinement:
        params["cam_pose"] = {"rvec": _get(sd, "cam_pose.rvec"),
                              "tvec": _get(sd, "cam_pose.tvec")}
    return params


# -- export ---------------------------------------------------------------

def _linear_to(out: dict, prefix: str, p: dict):
    out[f"{prefix}.weight"] = np.asarray(p["w"], np.float32).T.copy()
    out[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)


def _spacenet_to(out, prefix, p, deep_rgb):
    rgb_idx = _RGB_DEEP_IDX if deep_rgb else _RGB_IDX
    for i, li in zip(_STAGE1_IDX, p["stage1"]):
        _linear_to(out, f"{prefix}.stage1.{i}", li)
    for i, li in zip(_STAGE2_IDX, p["stage2"]):
        _linear_to(out, f"{prefix}.stage2.{i}", li)
    _linear_to(out, f"{prefix}.density_net.0", p["density"][0])
    for i, li in zip(rgb_idx, p["rgb"]):
        _linear_to(out, f"{prefix}.rgb_net.{i}", li)


def _unstack(tree, i):
    """Slice ``i`` of the leading axis of every leaf."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unstack(v, i) for v in tree]
    return np.asarray(tree)[i]


def state_dict_from_params(params: dict, spec) -> dict:
    """Parameter pytree -> reference-layout state_dict (numpy values)."""
    out: dict = {}
    deep = spec.deep_rgb
    L = spec.layer_num
    _spacenet_to(out, "bkgd_spacenet", params["bkgd_coarse"], deep)
    _spacenet_to(out, "bkgd_spacenet_fine", params["bkgd_fine"], deep)
    fine = params.get("layers_fine", params["layers_coarse"])
    for i in range(L):
        _spacenet_to(out, f"spacenets.{i}", _unstack(params["layers_coarse"], i), deep)
        _spacenet_to(out, f"spacenets_fine.{i}", _unstack(fine, i), deep)
    if "motion" in params:
        for i in range(L):
            m = _unstack(params["motion"], i)
            for j, li in zip(_MOTION_IDX, m["net"]):
                _linear_to(out, f"time_deform_nets.{i}.motion_net.{j}", li)
    if "bkgd_motion" in params:
        for j, li in zip(_MOTION_IDX, params["bkgd_motion"]["net"]):
            _linear_to(out, f"bkgd_time_deform_net.motion_net.{j}", li)
    if "view_deform" in params:
        for j, li in zip(_MOTION_IDX, params["view_deform"]["net"]):
            _linear_to(out, f"view_deform_net.motion_net.{j}", li)
    if "cam_pose" in params:
        out["cam_pose.rvec"] = np.asarray(params["cam_pose"]["rvec"], np.float32)
        out["cam_pose.tvec"] = np.asarray(params["cam_pose"]["tvec"], np.float32)
    return out


def load_reference_checkpoint(path: str, spec) -> dict:
    """Load a reference ``layered_rfnr_checkpoint_*.pt`` file and return the
    parameter pytree (from its ``['model']`` entry;
    ref: render/layered_neural_renderer.py:110-117).

    Only tensors and plain containers are unpickled (``weights_only``): a
    file that holds any other object is refused, with the global it names in
    torch's error, and is not read again less safely."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob["model"] if isinstance(blob, dict) and "model" in blob else blob
    return params_from_state_dict(sd, spec)

