"""UR10 reach integrated by the implicit midpoint rule.

Port of ``examples/ur10_midpoint.py``: the UR10 under the free multibody
dynamics and :class:`IntegratorMidpoint` (dt = 0.02, N = 50; the rollout
solves each stage by Newton steps), a terminal end-effector target, torque
limits from ur_description, warm-started by the rollout of the
quasi-static torque u₀ = RNEA(q₀, 0, 0). The published configuration solves
it with ``ProxDDPConfig(tol=1e-4, mu_init=1e-2, max_iters=80,
rollout="nonlinear", rollout_max_iters=5, ls_strategy="armijo")`` from
:func:`warm_start`. Its LQ subproblems (nx = 12, general E) take the
per-stage loop on K2 and the forward substitution K4.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorMidpoint
from ..modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from ..modelling.multibody import model as rbd
from ..modelling.multibody.residuals import FrameTranslationResidual
from ..modelling.multibody.robots import make_ur10, ur10_effort_limits
from ..utils.rollout import rollout

SOLVE_OPTIONS = dict(tol=1e-4, mu_init=1e-2, max_iters=80, rollout="nonlinear",
                     rollout_max_iters=5, ls_strategy="armijo")
P_TARGET = tuple(0.707 * c for c in (0.5, 0.7, 1.2))


def ur10_midpoint_problem(model: rbd.RobotModel, x0: Tensor, x_ref: Tensor, u0: Tensor,
                          p_target: Tensor, w_x: Tensor, w_u: Tensor, w_term: Tensor,
                          effort: Tensor, timestep: Tensor,
                          nsteps: int) -> core.TrajOptProblem:
    """The reach from its leaves: stage cost ½‖x ⊖ x_ref‖²_{w_x} +
    ½‖u − u0‖²_{w_u}, terminal cost ½‖p_ee − p_target‖²_{w_term}, |u| <=
    effort, initial states ``x0 (B, 12)``."""
    nv = model.nv
    space = model.phase_space()
    ode = MultibodyFreeFwdDynamics(model=model, actuation=torch.eye(
        nv, dtype=x0.dtype, device=x0.device))
    dyn = IntegratorMidpoint(ode=ode, timestep=timestep)
    frame_res = FrameTranslationResidual(model=model, p_ref=p_target,
                                         frame_id=model.frame_id("ee"))
    rcost = core.CostStack.create(core.QuadraticStateCost(x_ref, w_x),
                                  core.QuadraticControlCost(w_u, target=u0))
    constraints = ((core.ControlErrorResidual(target=effort.new_zeros(nv)),
                    core.BoxConstraint(lower=-effort, upper=effort)),)
    stage = core.make_stage(rcost, dyn, space, nv, constraints)
    term_cost = core.QuadraticResidualCost(residual=frame_res, weights=w_term)
    return core.make_problem(x0, stage, nsteps, term_cost)


def create_ur10_midpoint_problem(nsteps: int = 50, timestep: float = 0.02,
                                 dtype=torch.float64, device="cuda") -> core.TrajOptProblem:
    """The published reach, one scenario at the neutral configuration at
    rest."""
    dev = resolve(device)
    model = make_ur10(dtype=dtype, device=dev)
    nv = model.nv
    x0 = model.phase_space().neutral(dtype, dev)
    zero = x0.new_zeros(nv)
    u0 = rbd.rnea(model, x0[:nv], zero, zero)
    w_x = torch.cat([x0.new_full((nv,), 1e-6), x0.new_full((nv,), 5e-2)])
    return ur10_midpoint_problem(
        model, x0[None], x_ref=x0, u0=u0,
        p_target=torch.tensor(P_TARGET, dtype=dtype, device=dev),
        w_x=torch.diag(w_x) * timestep,
        w_u=1e-3 * torch.eye(nv, dtype=dtype, device=dev) * timestep,
        w_term=6.0 * torch.eye(3, dtype=dtype, device=dev),
        effort=ur10_effort_limits(dtype, dev),
        timestep=torch.tensor(timestep, dtype=dtype, device=dev), nsteps=nsteps)


def warm_start(problem: core.TrajOptProblem):
    """The quasi-static warm start ``(xs_init, us_init)``: u₀ at every stage
    and the rollout of the dynamics under it."""
    u0 = problem.stages.cost.costs[1].residual.target
    us = u0.expand(problem.x0.shape[:1] + (problem.nsteps,) + u0.shape).clone()
    xs = rollout(problem.stages.dynamics, problem.stages.space, problem.x0, us)
    return xs, us


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    problem = create_ur10_midpoint_problem(device=args.device)
    xs, us = warm_start(problem)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS), xs_init=xs,
                        us_init=us)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
