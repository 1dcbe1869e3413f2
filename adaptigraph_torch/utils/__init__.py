from adaptigraph_torch.utils import geometry
from adaptigraph_torch.utils.config import Config, load_config, load_yaml
from adaptigraph_torch.utils.device import resolve_device
