from adaptigraph_torch.parallel.mesh import (make_mesh, replicate,
                                             shard_batch)

__all__ = ["make_mesh", "replicate", "shard_batch"]
