"""Cartpole swing-up with a control bound.

Port of ``examples/cartpole.py``: state x = (p, θ, ṗ, θ̇) ∈ R⁴ (θ = 0
hanging down, θ = π upright), control u the horizontal force on the cart,
the classic analytic dynamics integrated by RK2 (or, with
``integrator="midpoint"``, by the implicit midpoint rule), N = 100 steps of
dt = 0.02, |u| <= 25. The published configuration solves it with
``ProxDDPConfig(tol=1e-5, mu_init=0.01, max_iters=300,
rollout="nonlinear")`` in float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import ODE, IntegratorMidpoint, IntegratorRK2

SOLVE_OPTIONS = dict(tol=1e-5, mu_init=0.01, max_iters=300, rollout="nonlinear")


@dataclass
class CartpoleODE(ODE):
    """Cart of mass ``mc`` carrying a pole of mass ``mp`` and length
    ``length`` under ``gravity``."""

    mc: Tensor
    mp: Tensor
    length: Tensor
    gravity: Tensor

    def xdot(self, space, x, u):
        th, pdot, thdot = x[..., 1], x[..., 2], x[..., 3]
        f = u[..., 0]
        s, c = torch.sin(th), torch.cos(th)
        mt = self.mc + self.mp
        denom = mt - self.mp * c * c
        thdot2 = thdot * thdot
        pddot = (f + self.mp * s * (self.length * thdot2 + self.gravity * c)) / denom
        thddot = (-f * c - self.mp * self.length * thdot2 * c * s
                  - mt * self.gravity * s) / (self.length * denom)
        return torch.stack([pdot, thdot, pddot, thddot], -1)


def cartpole_problem(x0: Tensor, mc: Tensor, mp: Tensor, length: Tensor,
                     gravity: Tensor, timestep: Tensor, x_target: Tensor,
                     w_x: Tensor, w_u: Tensor, w_term: Tensor, nsteps: int,
                     u_bound=None, integrator: str = "rk2") -> core.TrajOptProblem:
    """Build the cartpole problem from its leaves: stage cost
    ½‖x − x_target‖²_{w_x} + ½‖u‖²_{w_u}, terminal cost
    ½‖x − x_target‖²_{w_term}, initial states ``x0 (B, 4)``; ``u_bound``
    adds |u| <= u_bound; ``integrator`` is ``"rk2"`` or ``"midpoint"``."""
    space = core.VectorSpace(4)
    nu = 1
    ode = CartpoleODE(mc=mc, mp=mp, length=length, gravity=gravity)
    integ = {"rk2": IntegratorRK2, "midpoint": IntegratorMidpoint}[integrator]
    dyn = integ(ode=ode, timestep=timestep)
    rcost = core.CostStack.create(core.QuadraticStateCost(x_target, w_x),
                                  core.QuadraticControlCost(w_u))
    term_cost = core.QuadraticStateCost(x_target, w_term)
    constraints = ()
    if u_bound is not None:
        ones = w_u.new_ones(nu)
        constraints = ((
            core.ControlErrorResidual(target=w_u.new_zeros(nu)),
            core.BoxConstraint(lower=-u_bound * ones, upper=u_bound * ones),
        ),)
    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    return core.make_problem(x0, stage, nsteps, term_cost)


def create_cartpole_problem(nsteps: int = 100, timestep: float = 0.02,
                            u_bound=25.0, dtype=torch.float64, device="cuda",
                            integrator: str = "rk2") -> core.TrajOptProblem:
    """The published cartpole problem with one scenario at x0 = 0; replace
    ``x0`` by a ``(B, 4)`` batch to solve B scenarios."""
    dev = resolve(device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return cartpole_problem(
        x0=t([[0.0, 0.0, 0.0, 0.0]]), mc=t(1.0), mp=t(0.1), length=t(0.5),
        gravity=t(9.81), timestep=t(timestep), x_target=t([0.0, math.pi, 0.0, 0.0]),
        w_x=torch.diag(t([0.1, 1.0, 0.01, 0.01])) * timestep,
        w_u=1e-3 * torch.eye(1, dtype=dtype, device=dev) * timestep,
        w_term=torch.diag(t([10.0, 100.0, 1.0, 1.0])), nsteps=nsteps,
        u_bound=u_bound, integrator=integrator,
    )


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--integrator", default="rk2", choices=("rk2", "midpoint"))
    args = ap.parse_args()
    problem = create_cartpole_problem(device=args.device, integrator=args.integrator)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    print("xN:", res.xs[0, -1].tolist(), "(target: [0, pi, 0, 0])")
    print("max |u|:", float(res.us.abs().max()))
