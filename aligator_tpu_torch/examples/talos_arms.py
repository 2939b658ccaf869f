"""Talos upper-body dual-arm reach.

Port of ``examples/talos_arms.py``: the fixed-base upper body (torso and two
4-dof arms, :func:`~..modelling.multibody.humanoid.make_humanoid_upper_body`)
under the free multibody dynamics and semi-implicit Euler (N = 80, dt =
0.01) moves its left gripper to a point 0.25 m forward, 0.1 m left and 0.35
m up of where it starts, with a posture cost and the upper body's torque
limits. The published configuration solves it with ``ProxDDPConfig(tol=1e-5,
mu_init=1e-3, max_iters=100, rollout="nonlinear")``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorSemiImplEuler
from ..modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from ..modelling.multibody import model as rbd
from ..modelling.multibody.humanoid import make_humanoid_upper_body, upper_body_effort_limits
from ..modelling.multibody.residuals import FrameTranslationResidual

SOLVE_OPTIONS = dict(tol=1e-5, mu_init=1e-3, max_iters=100, rollout="nonlinear")
TARGET_OFFSET = (0.25, 0.1, 0.35)


def talos_arms_problem(model: rbd.RobotModel, x0: Tensor, x_ref: Tensor, p_target: Tensor,
                       w_x: Tensor, w_u: Tensor, w_frame: Tensor, w_term_x: Tensor,
                       w_term_frame: Tensor, timestep: Tensor, nsteps: int,
                       effort: Tensor | None = None) -> core.TrajOptProblem:
    """The reach from its leaves: stage cost dt·(½‖x ⊖ x_ref‖²_{w_x} +
    ½‖u‖²_{w_u} + ½‖p_lg − p_target‖²_{w_frame}), terminal cost ½‖x ⊖
    x_ref‖²_{w_term_x} + ½‖p_lg − p_target‖²_{w_term_frame}, p_lg the left
    gripper's position, every joint actuated, initial states ``x0 (B, 20)``;
    ``effort`` adds |τ| <= effort."""
    nv = model.nv
    space = model.phase_space()
    ode = MultibodyFreeFwdDynamics(model=model, actuation=torch.eye(
        nv, dtype=x0.dtype, device=x0.device))
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=timestep)
    frame_res = FrameTranslationResidual(model=model, p_ref=p_target,
                                         frame_id=model.frame_id("left_gripper"))
    rcost = core.CostStack.create(
        core.QuadraticStateCost(x_ref, w_x * timestep),
        core.QuadraticControlCost(w_u * timestep),
        core.QuadraticResidualCost(residual=frame_res, weights=w_frame * timestep))
    term_cost = core.CostStack.create(
        core.QuadraticStateCost(x_ref, w_term_x),
        core.QuadraticResidualCost(residual=frame_res, weights=w_term_frame))
    constraints = ()
    if effort is not None:
        constraints = ((core.ControlErrorResidual(target=effort.new_zeros(nv)),
                        core.BoxConstraint(lower=-effort, upper=effort)),)
    stage = core.make_stage(rcost, dyn, space, nv, constraints)
    return core.make_problem(x0, stage, nsteps, term_cost)


def create_talos_arms_problem(nsteps: int = 80, timestep: float = 0.01, bounds: bool = True,
                              dtype=torch.float64, device="cuda") -> core.TrajOptProblem:
    """The published reach, one scenario at the neutral posture at rest;
    replace ``x0`` by a ``(B, 20)`` batch to solve B scenarios."""
    dev = resolve(device)
    model = make_humanoid_upper_body(dtype=dtype, device=dev)
    nv = model.nv
    x0 = model.phase_space().neutral(dtype, dev)
    _, p0 = rbd.frame_placement(model, x0[:model.nq], model.frame_id("left_gripper"))
    p_target = p0 + torch.tensor(TARGET_OFFSET, dtype=dtype, device=dev)
    w_x = torch.diag(torch.tensor([1.0] * 2 + [0.01] * (nv - 2) + [1e-4] * nv,
                                  dtype=dtype, device=dev))
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    return talos_arms_problem(
        model, x0[None], x0, p_target, w_x, 1e-4 * torch.eye(nv, dtype=dtype, device=dev),
        10.0 * eye3 * 0.01, w_x, 10.0 * eye3, torch.tensor(timestep, dtype=dtype, device=dev),
        nsteps, effort=upper_body_effort_limits(dtype, dev) if bounds else None)


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    problem = create_talos_arms_problem(device=args.device)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    model = problem.stages.dynamics.ode.model
    frame_res = problem.stages.cost.costs[2].residual
    err = frame_res.value(problem.space, res.xs[:, -1], res.us[:, -1])
    print("gripper error:", float(err.norm()))
