from adaptigraph_torch.scenes.samplers import (
    rope_scene, granular_scene, cloth_scene, sample_scene)
from adaptigraph_torch.scenes.build import build_scene, SceneBuild, MATERIAL_CAPS
