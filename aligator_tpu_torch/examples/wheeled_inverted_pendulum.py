"""Wheeled inverted pendulum (segway) point-to-point transfer.

Port of ``examples/wheeled_inverted_pendulum.py``: drive the base 1 m
forward with the pendulum upright (θ = 0, the unstable equilibrium) under
the wheel-torque bound |u| ≤ 3, N = 100 stages of RK2 at dt = 0.02, solved
with the nonlinear rollout (``SOLVE_OPTIONS``). On the card its LQ
subproblems, (ndx, nu) = (4, 1) with E = −I, take K1.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorRK2
from ..modelling.dynamics.centroidal import WheeledInvertedPendulumDynamics

SOLVE_OPTIONS = dict(tol=1e-5, mu_init=1e-2, max_iters=60, rollout="nonlinear")
PARAMS = dict(mass_cart=2.0, mass_pole=1.0, length=0.6, wheel_radius=0.15, gravity=9.81)


def wip_problem(x0: Tensor, params: dict, timestep: Tensor, x_target: Tensor,
                w_x: Tensor, w_u: Tensor, w_term: Tensor, u_bound: Tensor,
                nsteps: int) -> core.TrajOptProblem:
    """The problem from its leaves: the ODE's ``params`` (name: scalar
    tensor), stage cost ½‖x − x_target‖²_{w_x} + ½‖u‖²_{w_u}, terminal
    ½‖x − x_target‖²_{w_term}, |u| ≤ u_bound, initial states ``x0 (B,
    4)``."""
    space = core.VectorSpace(4)
    nu = 1
    ode = WheeledInvertedPendulumDynamics(**params)
    dyn = IntegratorRK2(ode=ode, timestep=timestep)
    rcost = core.CostStack.create(core.QuadraticStateCost(x_target, w_x),
                                  core.QuadraticControlCost(w_u))
    term_cost = core.QuadraticStateCost(x_target, w_term)
    ones = w_u.new_ones(nu)
    constraints = ((core.ControlErrorResidual(target=w_u.new_zeros(nu)),
                    core.BoxConstraint(lower=-u_bound * ones, upper=u_bound * ones)),)
    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    return core.make_problem(x0, stage, nsteps, term_cost)


def create_wip_problem(nsteps: int = 100, timestep: float = 0.02, u_bound: float = 3.0,
                       x_goal: float = 1.0, dtype=torch.float64,
                       device="cuda") -> core.TrajOptProblem:
    """The published problem, one scenario upright at the origin; replace
    ``x0`` by a ``(B, 4)`` batch to solve B scenarios."""
    dev = resolve(device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return wip_problem(
        x0=t([[0.0, 0.0, 0.0, 0.0]]), params={k: t(v) for k, v in PARAMS.items()},
        timestep=t(timestep), x_target=t([x_goal, 0.0, 0.0, 0.0]),
        w_x=torch.diag(t([1.0, 10.0, 0.1, 0.1])) * timestep,
        w_u=1e-2 * torch.eye(1, dtype=dtype, device=dev) * timestep,
        w_term=torch.diag(t([100.0, 100.0, 10.0, 10.0])), u_bound=t(u_bound),
        nsteps=nsteps)


def initial_states(batch: int, seed: int):
    """``(batch, 4)`` numpy initial states: the base displaced by 0.1 m and
    the pendulum tilted by 0.05 rad (normal), at rest; the first rows are
    the same whatever the batch."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((batch, 4))
    x0[:, :2] = np.array([0.1, 0.05]) * rng.standard_normal((batch, 2))
    return x0


def solution_checks(xs: Tensor, us: Tensor, x_goal: float = 1.0, u_bound: float = 3.0,
                    tol: float = 1e-6) -> dict:
    """Per scenario ``(B,)`` bools: the base at its goal within 5 cm, the
    pendulum upright within 0.02 rad, the torque within its bound (as the
    JAX package's ``tests/test_modelling.py`` asserts)."""
    xN = xs[:, -1]
    return {"at goal": (xN[:, 0] - x_goal).abs() < 0.05, "upright": xN[:, 1].abs() < 0.02,
            "torque": us.abs().amax((1, 2)) <= u_bound + tol}
