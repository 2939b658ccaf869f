"""Acrobot swing-up: the double pendulum actuated at the elbow only.

Port of ``examples/acrobot.py``: the analytic double pendulum (l = 0.5, m =
1), torque on the second joint only, semi-implicit Euler with dt = 0.025, N
= 120, |u| <= 12, from hanging to upright. The published configuration
solves it with ``ProxDDPConfig(tol=2e-3, mu_init=1e-2, max_iters=250,
rollout="nonlinear")``. Its LQ subproblems (nx = 4, nu = 1, one constraint,
general E on the tangent bundle) take the fused solve K1.
"""

from __future__ import annotations

import math

import torch

from .. import core
from .._device import resolve
from ..modelling.multibody.robots import make_double_pendulum
from .pendulum import swing_up_problem

SOLVE_OPTIONS = dict(tol=2e-3, mu_init=1e-2, max_iters=250, rollout="nonlinear")


def create_acrobot_problem(nsteps: int = 120, timestep: float = 0.025, u_bound=12.0,
                           dtype=torch.float64, device="cuda") -> core.TrajOptProblem:
    """The published acrobot swing-up, one scenario hanging at rest; replace
    ``x0`` by a ``(B, 4)`` batch to solve B scenarios."""
    dev = resolve(device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return swing_up_problem(
        make_double_pendulum(l1=0.5, l2=0.5, m1=1.0, m2=1.0, dtype=dtype, device=dev),
        actuation=t([[0.0], [1.0]]), x0=t([[0.0] * 4]), x_target=t([math.pi, 0.0, 0.0, 0.0]),
        w_x=torch.diag(t([0.1, 0.1, 0.01, 0.01])) * timestep, w_u=t([[1e-3]]) * timestep,
        w_term=torch.diag(t([100.0, 100.0, 10.0, 10.0])), timestep=t(timestep),
        nsteps=nsteps, u_bound=u_bound)


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = solvers.solve(create_acrobot_problem(device=args.device),
                        solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("xN:", res.xs[0, -1].tolist(), "(target: [pi, 0, 0, 0])")
