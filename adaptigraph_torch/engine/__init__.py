from adaptigraph_torch.engine.state import (
    ParticleState,
    SpringSet,
    ClusterSet,
    ShapeSet,
    SolverParams,
    SceneSpec,
    SceneState,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    SHAPE_PLANE,
    SHAPE_CONVEX,
    make_params,
    scene_from_numpy,
)
from adaptigraph_torch.engine.solver import xpbd_step, rollout_steps
