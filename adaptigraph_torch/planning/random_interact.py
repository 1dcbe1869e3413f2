"""Exploration for physics-parameter estimation: the port of
adaptigraph_tpu/planning/random_interact.py.

The closed loop of plan.py in change mode with the online estimate on:
the reward is built from the chamfer distance to the current state, under
the same collision and workspace penalties. Kept as the JAX package has
it: the population-wide error weight then turns negative and MPPI picks
the push that changes the state least (see planning/plan.py).

Usage:
  python -m adaptigraph_torch.planning.random_interact --task-config \\
      planning/granular --env sim --params PARAMS.pt --n-actions 5 \\
      [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from adaptigraph_torch.planning import plan as plan_mod
from adaptigraph_torch.utils import load_config
from adaptigraph_torch.utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task-config", type=str, default="planning/granular")
    ap.add_argument("--env", type=str, default="sim", choices=["sim", "real"])
    ap.add_argument("--n-actions", type=int, default=5)
    ap.add_argument("--n-sample", type=int, default=None)
    ap.add_argument("--name", type=str, default="dump/random_interact")
    ap.add_argument("--params", type=str, required=True,
                    help="a state_dict saved with torch.save")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    tc = load_config(args.task_config)["task_config"]
    env = plan_mod.make_env(tc, args.env, device=resolve_device(args.device))
    params = torch.load(args.params, map_location="cpu", weights_only=True)
    return plan_mod.plan(tc, env, args.name, params, use_ppo=True,
                         n_actions=args.n_actions, n_sample=args.n_sample,
                         reward_mode="change", device=args.device)


if __name__ == "__main__":
    main()
