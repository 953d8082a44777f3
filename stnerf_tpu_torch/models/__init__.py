from .convert import (export_jax_params, export_linears, export_spacenet,
                      load_jax_params, load_linears, load_spacenet)
from .layered import (EditState, LayeredModel, LayeredSpec, LayerOutputs,
                      RayInputs, RenderOutputs, SceneBoxes,
                      compute_scale_pivot, render_rays)
from .motionnet import MotionNet, MotionNetSpec
from .spacenet import SpaceNet, SpaceNetSpec

__all__ = [
    "export_jax_params", "export_linears", "export_spacenet", "load_jax_params", "load_linears", "load_spacenet",
    "EditState", "LayeredModel", "LayeredSpec", "LayerOutputs", "RayInputs",
    "RenderOutputs", "SceneBoxes", "compute_scale_pivot", "render_rays",
    "MotionNet", "MotionNetSpec", "SpaceNet", "SpaceNetSpec",
]
