from adaptigraph_torch.parallel.mesh import (gather_params_model, make_mesh,
                                             make_mesh_2d, replicate,
                                             shard_batch, shard_params_model)

__all__ = ["gather_params_model", "make_mesh", "make_mesh_2d", "replicate",
           "shard_batch", "shard_params_model"]
