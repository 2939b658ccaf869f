#!/usr/bin/env python
"""How far apart the free-dynamics paths' solves land when their rounding
differs.

Solves the first 16 scenarios of each free-dynamics path of
``chip_smoke.py`` (the UR5 reach, the dual-arm FFSR reach and the acrobot:
their published options and sizes, float64) on the CPU for a few
iterations, then again

* from initial states one ulp away, x0·(1 + 1e-15) and x0·(1 - 1e-15);
* with the forward dynamics of the rollout summed in another order,
  ``torch.linalg.solve(M, τ - b)`` in place of ``model.aba``'s Cholesky
  solve (what the card's free-dynamics kernel changes, by ~cond(M)·eps),

and prints, for each iteration, the largest difference of the history rows
(each column relative to max(1, its largest magnitude)) and of the iterates
against the first solve. The card's and the CPU's solves differ by rounding
in every operation, so this is how far apart they can be expected after k
iterations; ``chip_smoke.py`` holds them to 100 times the one-ulp spread.

    python tools/torch_free_divergence.py [--paths ur5,ffsr,acrobot] [--iters 4]
"""

import argparse
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

import aligator_tpu_torch as at  # noqa: E402
from aligator_tpu_torch._linalg import mv  # noqa: E402
from aligator_tpu_torch.modelling.dynamics import multibody_free  # noqa: E402
from aligator_tpu_torch.modelling.multibody import model as rbd  # noqa: E402


def acceleration_by_lu(self, space, x, u):
    """The free ODE's acceleration by an LU solve of M (another summation
    order than model.aba's Cholesky)."""
    q, v = x[..., :self.model.nq], x[..., self.model.nq:]
    rhs = mv(self.actuation, u) - rbd.nonlinear_effects(self.model, q, v)
    return torch.linalg.solve(rbd.mass_matrix(self.model, q), rhs[..., None])[..., 0]


def gaps(a, b, k):
    """History rows by iteration and the iterates (at the start of each
    iteration) of ``a`` against ``b``, each relative to max(1, max |b|)."""
    rows = [chip_smoke.col_rel(a.history[:, i:i + 1], b.history[:, i:i + 1])
            for i in range(k)]
    xs = [max(chip_smoke.col_rel(a.history_xs[:, i], b.history_xs[:, i]),
              chip_smoke.col_rel(a.history_us[:, i], b.history_us[:, i])) for i in range(k)]
    xs.append(max(chip_smoke.col_rel(a.xs, b.xs), chip_smoke.col_rel(a.us, b.us)))
    return rows, xs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default="ur5,ffsr,acrobot")
    ap.add_argument("--iters", type=int, default=chip_smoke.CART_CPU_ITERS)
    args = ap.parse_args()
    torch.set_num_threads(4)
    paths = chip_smoke.free_paths()
    n = chip_smoke.FREE_CPU_SCENARIOS
    for case in args.paths.split(","):
        create, opts, _ = paths[case]
        cfg = at.solvers.ProxDDPConfig(**{**opts, "max_iters": args.iters},
                                       record_history=True, record_history_trajs=True)

        def solve(scale=1.0):
            return at.solvers.solve(chip_smoke.free_problem(case, create, "cpu", n, scale), cfg)

        base = solve()
        runs = {f"x0*(1{s:+g})": solve(1.0 + s) for s in (1e-15, -1e-15)}
        plain = multibody_free.MultibodyFreeFwdDynamics.acceleration
        multibody_free.MultibodyFreeFwdDynamics.acceleration = acceleration_by_lu
        try:
            runs["LU forward dynamics"] = solve()
        finally:
            multibody_free.MultibodyFreeFwdDynamics.acceleration = plain
        for name, r in runs.items():
            rows, xs = gaps(r, base, args.iters)
            print(f"{case} {name}: history rows by iteration "
                  f"{[f'{e:.1e}' for e in rows]}; iterates at the start of each iteration "
                  f"and after the last {[f'{e:.1e}' for e in xs]}")


if __name__ == "__main__":
    main()
