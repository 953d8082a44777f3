"""The config tree, shared with the JAX package.

``stnerf_tpu.config`` is framework-free (importing it loads no jax), so the
port reads the same keys from the same YAMLs instead of keeping a copy.
"""

from stnerf_tpu.config import CfgNode, get_cfg

__all__ = ["CfgNode", "get_cfg"]
