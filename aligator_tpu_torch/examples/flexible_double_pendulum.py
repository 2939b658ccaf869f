"""Flexible double-pendulum swing-up (underactuated, spring-coupled).

Port of ``examples/flexible_double_pendulum.py``: each link of a double
pendulum split into two rigid half-segments joined by a passive torsional
spring-damper, a 4-DoF chain actuated at the shoulder and the elbow only,
under :class:`MultibodyFlexibleFwdDynamics` (τ = B u − K(q − q₀) − D v) and
RK2 with dt = 0.025, N = 120, |u| <= 12, from hanging to upright. The
published configuration solves it with ``ProxDDPConfig(tol=1e-4,
mu_init=1e-2, max_iters=200, rollout="nonlinear", ls_strategy="armijo")``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorRK2
from ..modelling.dynamics.multibody_free import MultibodyFlexibleFwdDynamics
from ..modelling.multibody.model import REVOLUTE, RobotModel, make_model

SOLVE_OPTIONS = dict(tol=1e-4, mu_init=1e-2, max_iters=200, rollout="nonlinear",
                     ls_strategy="armijo")


def make_flexible_double_pendulum(l1=0.5, l2=0.5, m1=0.8, m2=0.6, dtype=torch.float64,
                                  device="cuda") -> RobotModel:
    """A planar 4-revolute chain about +y: [shoulder, flex1, elbow, flex2],
    each link split into two half-length segments of half its mass; hangs
    along −z at q = 0."""
    y, h1, h2 = (0.0, 1.0, 0.0), l1 / 2, l2 / 2
    inertia = 1e-6 * np.eye(3)
    segs = [(m1 / 2, None, h1), (m1 / 2, h1, h1), (m2 / 2, h1, h2), (m2 / 2, h2, h2)]
    joints = [dict(type=REVOLUTE, parent=i - 1, axis=y, mass=m, com=(0.0, 0.0, -c),
                   inertia=inertia, **({} if off is None else
                                       dict(placement_p=(0.0, 0.0, -off))))
              for i, (m, off, c) in enumerate(segs)]
    frames = [dict(name="tip", parent=3, placement_p=(0.0, 0.0, -h2))]
    return make_model(joints, frames, dtype=dtype, device=device)


def flexible_pendulum_problem(model: RobotModel, actuation: Tensor, stiffness: Tensor,
                              damping: Tensor, q_rest: Tensor, x0: Tensor,
                              x_target: Tensor, w_x: Tensor, w_u: Tensor, w_term: Tensor,
                              timestep: Tensor, nsteps: int,
                              u_bound=None) -> core.TrajOptProblem:
    """The swing-up from its leaves: the flexible dynamics (``actuation (nv,
    nu)``, diagonal ``stiffness``, ``damping``, rest configuration
    ``q_rest``) under RK2, stage cost ½‖x − x_target‖²_{w_x} + ½‖u‖²_{w_u},
    terminal cost ½‖x − x_target‖²_{w_term}, initial states ``x0 (B, 8)``;
    ``u_bound`` adds |u| <= u_bound."""
    nu = actuation.shape[-1]
    space = model.phase_space()
    ode = MultibodyFlexibleFwdDynamics(model=model, actuation=actuation, stiffness=stiffness,
                                       damping=damping, q_rest=q_rest)
    dyn = IntegratorRK2(ode=ode, timestep=timestep)
    rcost = core.CostStack.create(core.QuadraticStateCost(x_target, w_x),
                                  core.QuadraticControlCost(w_u))
    constraints = ()
    if u_bound is not None:
        ones = w_u.new_ones(nu)
        constraints = ((core.ControlErrorResidual(target=w_u.new_zeros(nu)),
                        core.BoxConstraint(lower=-u_bound * ones, upper=u_bound * ones)),)
    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    return core.make_problem(x0, stage, nsteps, core.QuadraticStateCost(x_target, w_term))


def create_flexible_pendulum_problem(nsteps: int = 120, timestep: float = 0.025,
                                     u_bound=12.0, k_flex=60.0, d_flex=0.08,
                                     dtype=torch.float64,
                                     device="cuda") -> core.TrajOptProblem:
    """The published swing-up, one scenario hanging at rest."""
    dev = resolve(device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    B = torch.zeros((4, 2), dtype=dtype, device=dev)
    B[0, 0] = B[2, 1] = 1.0
    return flexible_pendulum_problem(
        make_flexible_double_pendulum(dtype=dtype, device=dev), actuation=B,
        stiffness=t([0.0, k_flex, 0.0, k_flex]), damping=t([0.12, d_flex, 0.1, d_flex]),
        q_rest=t([0.0] * 4), x0=t([[0.0] * 8]), x_target=t([math.pi] + [0.0] * 7),
        w_x=torch.diag(t([1.0, 0.5, 1.0, 0.5, 0.05, 0.05, 0.05, 0.05])) * timestep,
        w_u=1e-3 * torch.eye(2, dtype=dtype, device=dev) * timestep,
        w_term=torch.diag(t([100.0, 50.0, 100.0, 50.0, 10.0, 10.0, 10.0, 10.0])),
        timestep=t(timestep), nsteps=nsteps, u_bound=u_bound)


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = solvers.solve(create_flexible_pendulum_problem(device=args.device),
                        solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("final q:", res.xs[0, -1, :4].tolist(), "(target q0 = pi, flex ~ 0)")
