"""Quadrotor goto with obstacle avoidance.

Port of ``examples/quadrotor.py``: a free-flying rigid body driven by four
rotor thrusts (:func:`make_quadrotor`) flies from the origin to (1.5, 1.5,
1) past two vertical columns (:class:`CylinderKeepOut`), above the floor
z >= 0 (a linear state residual), with thrusts in [0, 12], under the free
multibody dynamics and semi-implicit Euler (N = 60, dt = 0.033); with
``term_cstr`` the goal position is also a terminal equality constraint.
The published configuration solves it with ``ProxDDPConfig(tol=1e-4,
mu_init=1e-2, max_iters=200, rollout="nonlinear")``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorSemiImplEuler
from ..core.functions import StageFunction
from ..modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from ..modelling.multibody.model import FREEFLYER, RobotModel, make_model

SOLVE_OPTIONS = dict(tol=1e-4, mu_init=1e-2, max_iters=200, rollout="nonlinear")
COLUMNS = ((0.75, 0.75), (1.25, 0.25))
COLUMN_RADIUS = 0.3
GOAL = (1.5, 1.5, 1.0)


def make_quadrotor(mass=1.5, arm=0.2, kf=1.0, km=0.016, dtype=torch.float64,
                   device="cuda"):
    """The quadrotor's model (one free-flyer body, frame "base") and its
    actuation ``(6, 4)``: rotor thrusts to the body wrench (f_z and the
    roll, pitch and yaw torques)."""
    device = resolve(device)
    model = make_model([dict(type=FREEFLYER, parent=-1, mass=mass, com=(0.0, 0.0, 0.0),
                             inertia=np.diag([0.013, 0.013, 0.022]))],
                       frames=[dict(name="base", parent=0)], dtype=dtype, device=device)
    B = torch.tensor([[0.0, 0.0, 0.0, 0.0],
                      [0.0, 0.0, 0.0, 0.0],
                      [kf, kf, kf, kf],
                      [0.0, arm * kf, 0.0, -arm * kf],
                      [-arm * kf, 0.0, arm * kf, 0.0],
                      [km, -km, km, -km]], dtype=dtype, device=device)
    return model, B


@dataclass
class CylinderKeepOut(StageFunction):
    """r(x) = radius² − ‖p_xy − c‖² ≤ 0: stay outside the vertical
    cylinder of axis ``center (2,)``."""

    center: Tensor
    radius: Tensor

    def dim(self, space, nu):
        return 1

    def value(self, space, x, u):
        dxy = x[..., :2] - self.center
        return (self.radius ** 2 - (dxy * dxy).sum(-1))[..., None]


def quadrotor_problem(model: RobotModel, actuation: Tensor, x0: Tensor, x_target: Tensor,
                      u_hover: Tensor, w_x: Tensor, w_u: Tensor, w_term: Tensor,
                      columns: Tensor, column_radius: Tensor, u_max: Tensor,
                      timestep: Tensor, nsteps: int,
                      term_cstr: bool = False) -> core.TrajOptProblem:
    """The flight from its leaves: stage cost dt·(½‖x ⊖ x_target‖²_{w_x} +
    ½‖u − u_hover‖²_{w_u}), terminal cost ½‖x ⊖ x_target‖²_{w_term}, the
    columns ``(k, 2)`` of radius ``column_radius`` kept out, z >= 0, 0 <= u
    <= u_max, initial states ``x0 (B, 13)``; ``term_cstr`` adds the goal
    position as a terminal equality."""
    space = model.phase_space()
    nu = actuation.shape[-1]
    ode = MultibodyFreeFwdDynamics(model=model, actuation=actuation)
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=timestep)
    rcost = core.CostStack.create(core.QuadraticStateCost(x_target, w_x * timestep),
                                  core.QuadraticControlCost(w_u * timestep, u_hover))
    obstacles = tuple((CylinderKeepOut(center=c, radius=column_radius), core.NegativeOrthant())
                      for c in columns)
    Az = x0.new_zeros((1, space.ndx))
    Az[0, 2] = -1.0
    floor = (core.LinearFunction(A=Az, B=x0.new_zeros((1, nu)), c=x0.new_zeros(1)),
             core.NegativeOrthant())
    bounds = (core.ControlErrorResidual(target=u_max.new_zeros(nu)),
              core.BoxConstraint(lower=u_max.new_zeros(nu), upper=u_max))
    stage = core.make_stage(rcost, dyn, space, nu, obstacles + (floor, bounds))
    term_constraints = ()
    if term_cstr:
        term_constraints = ((core.FunctionSlice(func=core.StateErrorResidual(target=x_target),
                                                indices=(0, 1, 2)),
                             core.EqualityConstraint()),)
    return core.make_problem(x0, stage, nsteps, core.QuadraticStateCost(x_target, w_term),
                             term_constraints=term_constraints)


def create_quadrotor_problem(nsteps: int = 60, timestep: float = 0.033, dtype=torch.float64,
                             term_cstr: bool = False, device="cuda") -> core.TrajOptProblem:
    """The published flight, one scenario from the origin at rest; replace
    ``x0`` by a ``(B, 13)`` batch to solve B scenarios."""
    dev = resolve(device)
    model, B = make_quadrotor(dtype=dtype, device=dev)
    space = model.phase_space()
    nu = B.shape[-1]
    x0 = space.neutral(dtype, dev)
    x_target = x0.clone()
    x_target[:3] = torch.tensor(GOAL, dtype=dtype, device=dev)
    w_x = torch.diag(torch.tensor([1.0] * 3 + [0.1] * 3 + [0.1] * 6, dtype=dtype, device=dev))

    def t(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    return quadrotor_problem(
        model, B, x0[None], x_target, torch.full((nu,), 1.5 * 9.81 / 4, dtype=dtype, device=dev),
        w_x, 0.1 * torch.eye(nu, dtype=dtype, device=dev), 10.0 * w_x, t(COLUMNS),
        t(COLUMN_RADIUS), torch.full((nu,), 12.0, dtype=dtype, device=dev), t(timestep),
        nsteps, term_cstr=term_cstr)


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--term_cstr", action="store_true")
    args = ap.parse_args()
    problem = create_quadrotor_problem(term_cstr=args.term_cstr, device=args.device)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("pN:", res.xs[0, -1, :3].tolist(), "(target:", list(GOAL), ")")
    print("min z:", float(res.xs[..., 2].min()), "(floor z >= 0)")
