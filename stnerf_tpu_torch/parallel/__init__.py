from .mesh import (DATA_AXIS, MODEL_AXIS, DeviceMesh, LayerShard, gather_chunked,
                   gather_whole, init_distributed, make_mesh, pad_for_mesh, replicate,
                   shard_params, shard_ray_batch, whole_model)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "DeviceMesh", "LayerShard", "gather_chunked",
           "gather_whole", "init_distributed", "make_mesh", "pad_for_mesh", "replicate",
           "shard_params", "shard_ray_batch", "whole_model"]
