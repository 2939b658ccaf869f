#!/usr/bin/env python
"""How fast two cartpole solves part that start a rounding error apart.

Solves the cartpole of ``aligator_tpu_torch/examples/cartpole.py`` (N =
100, float64, the published options with ``rollout='nonlinear'``) twice on
the CPU from the same 16 initial states 0.1·N(0, 1) (numpy seed 8, the
states of ``chip_smoke.py``'s cartpole phase), the second time with every
initial state scaled by 1 + 1e-15, and prints, for each iteration, the
largest difference of the two histories (each column relative to max(1,
its largest magnitude)), then the trajectories' relative difference at the
end. The card's and the CPU's solves of one problem differ by rounding
from their first Newton step (the sums run in other orders), so this is
how far apart they can be expected after k iterations.

    python tools/torch_cartpole_divergence.py [--iters 30] [--eps 1e-15]
"""

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import aligator_tpu_torch as at  # noqa: E402
from aligator_tpu_torch.examples.cartpole import (SOLVE_OPTIONS,  # noqa: E402
                                                  create_cartpole_problem)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--eps", type=float, default=1e-15)
    args = ap.parse_args()
    x0s = 0.1 * np.random.default_rng(8).standard_normal((16, 4))
    cfg = at.solvers.ProxDDPConfig(**{**SOLVE_OPTIONS, "max_iters": args.iters},
                                   record_history=True)
    runs = []
    for scale in (1.0, 1.0 + args.eps):
        prob = create_cartpole_problem(device="cpu")
        runs.append(at.solvers.solve(dataclasses.replace(prob, x0=torch.tensor(x0s * scale)),
                                     cfg))
    a, b = (r.history for r in runs)
    d = torch.where(a == b, 0.0, (a - b).abs())
    col = torch.where(torch.isfinite(b), b.abs(), 0.0).amax((0, 1)).clamp(min=1.0)
    per_iter = (d / col).amax((0, 2))
    for k, v in enumerate(per_iter.tolist()):
        print(f"iteration {k:3d}: history rel diff {v:.3e}")
    xs = (runs[0].xs - runs[1].xs).abs().max() / runs[1].xs.abs().max()
    print(f"after {args.iters} iterations: trajectories rel diff {xs.item():.3e}")


if __name__ == "__main__":
    main()
