"""Double-pendulum swing-up, both joints actuated.

Port of ``examples/double_pendulum.py``: the analytic double pendulum
(l = 1, m = 1) under the free multibody dynamics, semi-implicit Euler with
dt = 0.025, N = 120, |u| <= 25, from hanging to upright. The published
configuration solves it with ``ProxDDPConfig(tol=1e-5, mu_init=1e-2,
max_iters=300, rollout="nonlinear")``.
"""

from __future__ import annotations

import math

import torch

from .. import core
from .._device import resolve
from ..modelling.multibody.robots import make_double_pendulum
from .pendulum import swing_up_problem

SOLVE_OPTIONS = dict(tol=1e-5, mu_init=1e-2, max_iters=300, rollout="nonlinear")


def create_double_pendulum_problem(nsteps: int = 120, timestep: float = 0.025,
                                   u_bound=25.0, dtype=torch.float64,
                                   device="cuda") -> core.TrajOptProblem:
    """The published double-pendulum swing-up, one scenario hanging at rest."""
    dev = resolve(device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    eye = torch.eye(4, dtype=dtype, device=dev)
    return swing_up_problem(
        make_double_pendulum(dtype=dtype, device=dev),
        actuation=torch.eye(2, dtype=dtype, device=dev), x0=t([[0.0] * 4]),
        x_target=t([math.pi, 0.0, 0.0, 0.0]),
        w_x=torch.diag(t([1.0, 1.0, 0.1, 0.1])) * timestep,
        w_u=1e-3 * eye[:2, :2] * timestep, w_term=100.0 * eye, timestep=t(timestep),
        nsteps=nsteps, u_bound=u_bound)


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = solvers.solve(create_double_pendulum_problem(device=args.device),
                        solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("xN:", res.xs[0, -1].tolist(), "(target: [pi, 0, 0, 0])")
