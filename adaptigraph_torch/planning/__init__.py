from adaptigraph_torch.planning.actions import (
    decode_action,
    decode_action_single,
    sample_action_seq,
    optimize_action_mppi,
    clip_actions,
)
from adaptigraph_torch.planning.planner import Planner
