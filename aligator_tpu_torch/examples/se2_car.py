"""SE(2) car parking: the problem of the batched ProxDDP benchmark.

Port of ``examples/se2_car.py``: a unicycle on SE(2), state
x = (px, py, cosθ, sinθ), control u = (v, ω), explicit Euler with
dt = 0.05, quadratic tracking costs to the origin.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import ODE, SE2, IntegratorEuler

THETA0 = 0.15355
TIMESTEP = 0.05


@dataclass
class CarDynamics(ODE):
    """Unicycle kinematics ẋ = (v·cosθ, v·sinθ, ω) as a body twist."""

    def xdot(self, space, x, u):
        c, s = x[..., 2:3], x[..., 3:4]
        v, w = u[..., 0:1], u[..., 1:2]
        return torch.cat([v * c, v * s, w], -1)


def se2_problem(x0: Tensor, w_x: Tensor, w_u: Tensor, w_term: Tensor,
                target: Tensor, timestep: Tensor, nsteps: int,
                u_bound=None) -> core.TrajOptProblem:
    """Build the car problem from its leaves: stage cost
    ½‖x ⊖ target‖²_{w_x} + ½‖u‖²_{w_u}, terminal cost ½‖x ⊖ target‖²_{w_term},
    initial states ``x0 (B, 4)``; ``u_bound`` adds |u_i| ≤ u_bound."""
    space = SE2()
    nu = 2
    rcost = core.CostStack.create(
        core.QuadraticStateCost(target, w_x), core.QuadraticControlCost(w_u)
    )
    term_cost = core.QuadraticStateCost(target, w_term)
    dyn = IntegratorEuler(ode=CarDynamics(), timestep=timestep)
    constraints = ()
    if u_bound is not None:
        ones = w_u.new_ones(nu)
        constraints = ((
            core.ControlErrorResidual(target=w_u.new_zeros(nu)),
            core.BoxConstraint(lower=-u_bound * ones, upper=u_bound * ones),
        ),)
    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    return core.make_problem(x0, stage, nsteps, term_cost)


def create_se2_problem(nsteps: int = 50, dtype=torch.float32, device="cuda",
                       u_bound=None) -> core.TrajOptProblem:
    """The reference car problem with one scenario, the nominal initial
    state; replace ``x0`` by a ``(B, 4)`` batch to solve B scenarios."""
    dev = resolve(device)
    ndx, nu = 3, 2

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    x0 = t([[0.7, -0.1, math.cos(THETA0), math.sin(THETA0)]])
    w_x = 0.01 * torch.eye(ndx, dtype=dtype, device=dev)
    return se2_problem(
        x0=x0, w_x=w_x * TIMESTEP,
        w_u=torch.eye(nu, dtype=dtype, device=dev) * TIMESTEP,
        w_term=10.0 * w_x, target=SE2().neutral(dtype, dev),
        timestep=t(TIMESTEP), nsteps=nsteps, u_bound=u_bound,
    )
