from .camera import CameraTransform, apply_camera_transform
from .convert import (export_jax_params, export_linears, export_spacenet,
                      load_jax_params, load_linears, load_spacenet)
from .io_torch import (load_reference_checkpoint, params_from_state_dict,
                       state_dict_from_params)
from .layered import (EditState, LayeredModel, LayeredSpec, LayerOutputs,
                      RayInputs, RenderOutputs, SceneBoxes,
                      compute_scale_pivot, render_rays)
from .motionnet import MotionNet, MotionNetSpec
from .spacenet import SpaceNet, SpaceNetSpec

__all__ = [
    "CameraTransform", "apply_camera_transform",
    "export_jax_params", "export_linears", "export_spacenet", "load_jax_params", "load_linears", "load_spacenet",
    "load_reference_checkpoint", "params_from_state_dict", "state_dict_from_params",
    "EditState", "LayeredModel", "LayeredSpec", "LayerOutputs", "RayInputs",
    "RenderOutputs", "SceneBoxes", "compute_scale_pivot", "render_rays",
    "MotionNet", "MotionNetSpec", "SpaceNet", "SpaceNetSpec",
]
