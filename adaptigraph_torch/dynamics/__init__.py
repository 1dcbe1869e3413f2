from adaptigraph_torch.dynamics.model import DynamicsPredictor, ModelConfig
