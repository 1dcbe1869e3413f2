from adaptigraph_torch.ops.edges import (EdgeSet, build_edges, build_edges_batch,
                                         build_edges_slotted,
                                         build_edges_slotted_batch,
                                         edges_to_incidence)
