from .mesh import (DATA_AXIS, MODEL_AXIS, DeviceMesh, gather_chunked, init_distributed,
                   make_mesh, pad_for_mesh, replicate, shard_params, shard_ray_batch)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "DeviceMesh", "gather_chunked", "init_distributed",
           "make_mesh", "pad_for_mesh", "replicate", "shard_params", "shard_ray_batch"]
