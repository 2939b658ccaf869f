"""Pendulum swing-up on the rigid-body layer.

Port of ``examples/pendulum.py``: a pendulum (l = 0.5, m = 1) under the
free multibody dynamics, semi-implicit Euler with dt = 0.025, N = 80, |u| <=
2.5, swung from hanging (θ = 0) to upright (θ = π). The published
configuration solves it with ``ProxDDPConfig(tol=1e-3, max_iters=250,
rollout="nonlinear")``. :func:`swing_up_problem` is the problem of the
pendulum, the double pendulum and the acrobot, from their leaves.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorSemiImplEuler
from ..modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from ..modelling.multibody.model import RobotModel
from ..modelling.multibody.robots import make_pendulum

SOLVE_OPTIONS = dict(tol=1e-3, max_iters=250, rollout="nonlinear")


def swing_up_problem(model: RobotModel, actuation: Tensor, x0: Tensor, x_target: Tensor,
                     w_x: Tensor, w_u: Tensor, w_term: Tensor, timestep: Tensor,
                     nsteps: int, u_bound=None) -> core.TrajOptProblem:
    """A swing-up of a fixed-base chain from its leaves: free dynamics with
    ``actuation (nv, nu)`` under semi-implicit Euler, stage cost
    ½‖x ⊖ x_target‖²_{w_x} + ½‖u‖²_{w_u}, terminal cost
    ½‖x ⊖ x_target‖²_{w_term}, initial states ``x0 (B, nx)``; ``u_bound``
    adds |u| <= u_bound."""
    space = model.phase_space()
    nu = actuation.shape[-1]
    ode = MultibodyFreeFwdDynamics(model=model, actuation=actuation)
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=timestep)
    rcost = core.CostStack.create(core.QuadraticStateCost(x_target, w_x),
                                  core.QuadraticControlCost(w_u))
    constraints = ()
    if u_bound is not None:
        ones = w_u.new_ones(nu)
        constraints = ((core.ControlErrorResidual(target=w_u.new_zeros(nu)),
                        core.BoxConstraint(lower=-u_bound * ones, upper=u_bound * ones)),)
    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    return core.make_problem(x0, stage, nsteps, core.QuadraticStateCost(x_target, w_term))


def create_pendulum_problem(nsteps: int = 80, timestep: float = 0.025, u_bound=2.5,
                            dtype=torch.float64, device="cuda") -> core.TrajOptProblem:
    """The published pendulum swing-up, one scenario hanging at rest."""
    dev = resolve(device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return swing_up_problem(
        make_pendulum(l=0.5, m=1.0, dtype=dtype, device=dev), actuation=t([[1.0]]),
        x0=t([[0.0, 0.0]]), x_target=t([math.pi, 0.0]),
        w_x=torch.diag(t([0.1, 0.01])) * timestep, w_u=t([[1e-3]]) * timestep,
        w_term=torch.diag(t([100.0, 10.0])), timestep=t(timestep), nsteps=nsteps,
        u_bound=u_bound)


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = solvers.solve(create_pendulum_problem(device=args.device),
                        solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("xN:", res.xs[0, -1].tolist(), "(target: [pi, 0])")
