from adaptigraph_torch.ops.fps import (farthest_point_sampling, fps_radius,
                                       fps_subsample)
from adaptigraph_torch.ops.edges import (EdgeSet, build_edges, build_edges_batch,
                                         build_edges_slotted,
                                         build_edges_slotted_batch,
                                         edges_to_incidence)
from adaptigraph_torch.ops.losses import (box_loss, chamfer,
                                          earth_mover_distance, hausdorff,
                                          masked_chamfer)
