"""The port's config tree: the same keys, defaults and YAML merging as the
JAX package's ``stnerf_tpu.config``, kept as a copy so that the port imports
nothing of that package."""

from .defaults import get_cfg
from .node import CfgNode

__all__ = ["CfgNode", "get_cfg"]
