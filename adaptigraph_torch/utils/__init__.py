from adaptigraph_torch.utils import geometry
from adaptigraph_torch.utils.device import resolve_device
