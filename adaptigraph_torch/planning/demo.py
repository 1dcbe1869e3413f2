"""Offline physics-parameter estimation demo: the port of
adaptigraph_tpu/planning/demo.py.

Runs the online physics-parameter optimiser over a directory of recorded
interaction_*.npz logs (no robot, no simulator): the reference's
end-to-end acceptance test, whose coffee-bean interactions estimate a
granularity of ~0.04.

Usage:
  python -m adaptigraph_torch.planning.demo --task-config planning/granular \\
      --name DIR --params PARAMS.pt [--iterations 50] [--device cpu]

PARAMS.pt is a state_dict of the task's dynamics model saved with
torch.save (for example `dynamics.model.params_from_jax` of a JAX
checkpoint).
"""

from __future__ import annotations

import argparse
import glob
import os

import torch

from adaptigraph_torch.planning.physics_optimizer import (
    PhysicsParamOnlineOptimizer)
from adaptigraph_torch.planning.plan import load_model
from adaptigraph_torch.utils import load_config
from adaptigraph_torch.utils.device import resolve_device


def run_demo(task_config, save_dir, params, iterations=50, device=None):
    """Estimate the task material's physics parameter from the logs in
    save_dir with the model of task_config['config'] holding `params` (a
    state_dict), on `device` (CUDA unless given). Returns the estimate."""
    device = resolve_device(device)
    material = task_config["material"]
    model = load_model(task_config, params, device)

    ppm = PhysicsParamOnlineOptimizer(task_config, model,
                                      dict(model.state_dict()), material,
                                      save_dir, device=device)
    n = len(glob.glob(os.path.join(save_dir, "interaction_*.npz")))
    if n == 0:
        raise FileNotFoundError(f"no interaction_*.npz logs in {save_dir}")
    est, err, err0 = ppm.optimize(n - 1, iterations=iterations)
    print(f"estimated {material} physics param: {est} "
          f"(error {err:.5f}, init {err0:.5f})")
    return est


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task-config", type=str, default="planning/granular")
    ap.add_argument("--name", type=str, default="dump/demo_granular")
    ap.add_argument("--params", type=str, required=True,
                    help="a state_dict saved with torch.save")
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    tc = load_config(args.task_config)["task_config"]
    params = torch.load(args.params, map_location="cpu", weights_only=True)
    run_demo(tc, args.name, params, iterations=args.iterations,
             device=args.device)


if __name__ == "__main__":
    main()
