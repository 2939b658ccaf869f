"""Panda SE(3) reach with collision avoidance and torque limits.

Port of ``examples/panda_reach.py`` on the nominal Panda
(:func:`~..modelling.multibody.robots.make_panda`): the flange reaches a
full SE(3) pose (placement and terminal velocity costs) past a vertical
capsule post that the flange and the elbow must clear
(:class:`~..modelling.multibody.extra_residuals.FrameCollisionResidual`),
under the Panda's torque limits, the free multibody dynamics and
semi-implicit Euler (N = 50, dt = 0.02). The published configuration
solves it with ``ProxDDPConfig(tol=1e-4, mu_init=1e-2, max_iters=300,
rollout="nonlinear")``. The real Panda model (``make_panda_real``, read
from the vendored MJCF) is not ported: ``real_model=True`` raises.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorSemiImplEuler
from ..modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from ..modelling.multibody.extra_residuals import FrameCollisionResidual
from ..modelling.multibody.model import RobotModel
from ..modelling.multibody.residuals import FramePlacementResidual, FrameVelocityResidual
from ..modelling.multibody.robots import PANDA_EFFORT_LIMIT, PANDA_Q_HOME, make_panda

SOLVE_OPTIONS = dict(tol=1e-4, mu_init=1e-2, max_iters=300, rollout="nonlinear")
P_TARGET = (0.35, 0.45, 0.35)
R_TARGET = ((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0))  # flange pointing down
POST = ((0.25, 0.25, 0.0), (0.25, 0.25, 0.9))  # the post's axis
POST_RADIUS = 0.12  # its radius and the margin


def panda_reach_problem(model: RobotModel, x0: Tensor, R_target: Tensor, p_target: Tensor,
                        w_pose: Tensor, w_u: Tensor, w_term_pose: Tensor, w_term_vel: Tensor,
                        effort: Tensor, timestep: Tensor, nsteps: int,
                        post: tuple | None = None) -> core.TrajOptProblem:
    """The reach from its leaves: stage cost dt·(½‖log₆(M_ref⁻¹ M_ee)‖²_{w_pose}
    + ½‖u‖²_{w_u}), terminal cost ½‖log₆‖²_{w_term_pose} +
    ½‖v_ee‖²_{w_term_vel}, |τ| <= effort, initial states ``x0 (B, 14)``;
    ``post = (seg_a, seg_b, radius)`` keeps the frames "ee" and "elbow"
    ``radius`` away from the segment."""
    nv = model.nv
    space = model.phase_space()
    ode = MultibodyFreeFwdDynamics(model=model, actuation=torch.eye(
        nv, dtype=x0.dtype, device=x0.device))
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=timestep)
    ee = model.frame_id("ee")
    pose = FramePlacementResidual(model=model, R_ref=R_target, p_ref=p_target, frame_id=ee)
    vel = FrameVelocityResidual(model=model, v_ref=x0.new_zeros(6), frame_id=ee)
    rcost = core.CostStack.create(
        core.QuadraticResidualCost(residual=pose, weights=w_pose * timestep),
        core.QuadraticControlCost(w_u * timestep))
    term_cost = core.CostStack.create(
        core.QuadraticResidualCost(residual=pose, weights=w_term_pose),
        core.QuadraticResidualCost(residual=vel, weights=w_term_vel))
    constraints = [(core.ControlErrorResidual(target=effort.new_zeros(nv)),
                    core.BoxConstraint(lower=-effort, upper=effort))]
    if post is not None:
        seg_a, seg_b, radius = post
        for fid in (ee, model.frame_id("elbow")):
            constraints.append((FrameCollisionResidual(
                model=model, seg_a=seg_a, seg_b=seg_b, radius=radius, frame_id=fid),
                core.NegativeOrthant()))
    stage = core.make_stage(rcost, dyn, space, nv, tuple(constraints))
    return core.make_problem(x0, stage, nsteps, term_cost)


def create_panda_problem(nsteps: int = 50, timestep: float = 0.02,
                         with_collision: bool = True, dtype=torch.float64,
                         real_model: bool = False, device="cuda") -> core.TrajOptProblem:
    """The published reach on the nominal Panda, one scenario from the home
    posture at rest; replace ``x0`` by a ``(B, 14)`` batch to solve B
    scenarios."""
    if real_model:
        raise NotImplementedError(
            "the real Panda model (make_panda_real, from the vendored MJCF) is not "
            "ported; real_model=False builds the nominal make_panda")
    dev = resolve(device)
    model = make_panda(dtype=dtype, device=dev)
    nv = model.nv

    def t(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    x0 = torch.cat([t(PANDA_Q_HOME), torch.zeros(nv, dtype=dtype, device=dev)])
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    post = (t(POST[0]), t(POST[1]), t(POST_RADIUS)) if with_collision else None
    return panda_reach_problem(
        model, x0[None], t(R_TARGET), t(P_TARGET), 10.0 * eye6,
        1e-4 * torch.eye(nv, dtype=dtype, device=dev), 100.0 * eye6, 50.0 * eye6,
        t(PANDA_EFFORT_LIMIT), t(timestep), nsteps, post=post)


if __name__ == "__main__":
    import argparse

    from .. import solvers
    from ..modelling.multibody import model as rbd

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    problem = create_panda_problem(device=args.device)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    model = problem.stages.dynamics.ode.model
    R, p = rbd.frame_placement(model, res.xs[0, -1, :model.nq], model.frame_id("ee"))
    print("pos error:", float((p - torch.tensor(P_TARGET, dtype=p.dtype,
                                                device=p.device)).norm()))
