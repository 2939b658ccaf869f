"""Dual-arm free-floating space robot (FFSR) reach.

Port of ``examples/dual_ffsr_reach.py``: a free-flyer satellite bus with
two 7-DOF arms in zero gravity reaches displaced world-frame poses with
both tool frames under torque bounds, the base unactuated (14 arm
torques), semi-implicit Euler with dt = 0.05, N = 60. The model
(:func:`load_ffsr_model`) is the fork's MJCF file read by
:func:`~..modelling.multibody.mjcf.load_mjcf` (real masses, inertias and
armature; a synthetic free-flyer at the bus, the grasp object dropped;
tools ``grip1``/``grip2``, |τ| <= 500) where that file exists, else the
nominal :func:`make_dual_arm_ffsr` (Panda-kinematics arms, tools
``arm1_tool``/``arm2_tool``, Panda-scale efforts). The published configuration solves it with
``ProxDDPConfig(tol=1e-4, mu_init=1e-2, max_iters=120, rollout="nonlinear",
ls_strategy="armijo")``. Its LQ subproblems (ndx = 40, general E) take the
per-stage loop on K2 and the forward substitution K4. ``with_collision``
keeps arm 1's tool out of a vertical capsule ahead of its target
(:class:`~..modelling.multibody.extra_residuals.FrameCollisionResidual`),
``with_self_collision`` keeps capsules on the two tools apart
(:class:`~..modelling.multibody.extra_residuals.LinkCollisionResidual`).
"""

from __future__ import annotations

import os

import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorSemiImplEuler
from ..modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from ..modelling.multibody import model as rbd
from ..modelling.multibody.extra_residuals import FrameCollisionResidual, LinkCollisionResidual
from ..modelling.multibody.residuals import FramePlacementResidual, FrameVelocityResidual
from ..modelling.multibody.robots import (FFSR_Q_ARM1, FFSR_Q_ARM2, REFERENCE_DIR,
                                          make_dual_arm_ffsr)

SOLVE_OPTIONS = dict(tol=1e-4, mu_init=1e-2, max_iters=120, rollout="nonlinear",
                     ls_strategy="armijo")
TOOLS = ("arm1_tool", "arm2_tool")
U_MAX = (87.0, 87.0, 87.0, 87.0, 12.0, 12.0, 12.0) * 2  # Panda-scale efforts
# the fork's model file (read at run time) and its tools and torque bounds
# (its actuatorfrcrange)
FFSR_MJCF = os.path.join(REFERENCE_DIR, "dual-FFSR_ProxDDP", "xml", "dual_arm_space_robot.xml")
MJCF_TOOLS = ("grip1", "grip2")
MJCF_U_MAX = (500.0,) * 14
# the target posture: these arm joints displaced from the nominal one
TARGET_DQ = {8: 0.35, 10: -0.3, 12: 0.25, 15: -0.3, 17: 0.3, 19: -0.2}


def nominal_configuration(model: rbd.RobotModel) -> Tensor:
    """The base at the neutral pose and both arms at the application's
    nominal posture."""
    q = model.neutral().clone()
    q[7:14] = torch.as_tensor(FFSR_Q_ARM1, dtype=q.dtype, device=q.device)
    q[14:21] = torch.as_tensor(FFSR_Q_ARM2, dtype=q.dtype, device=q.device)
    return q


def load_ffsr_model(use_mjcf=None, dtype=torch.float64, device="cuda"):
    """``(model, tools, u_max)``: the model read from :data:`FFSR_MJCF`
    (``root_joint="freeflyer"``, the ``object`` body skipped) with
    ``MJCF_TOOLS`` and ``MJCF_U_MAX``, or the nominal
    :func:`make_dual_arm_ffsr` with ``TOOLS`` and ``U_MAX``; ``use_mjcf``
    None takes the file where it exists, as the JAX example does. The
    module constant is read at call time."""
    if use_mjcf is None:
        use_mjcf = os.path.exists(FFSR_MJCF)
    if use_mjcf:
        from ..modelling.multibody.mjcf import load_mjcf

        model, _ = load_mjcf(FFSR_MJCF, root_joint="freeflyer", skip_bodies=("object",),
                             dtype=dtype, device=device)
        return model, MJCF_TOOLS, MJCF_U_MAX
    return make_dual_arm_ffsr(dtype=dtype, device=device), TOOLS, U_MAX


def reach_targets(model: rbd.RobotModel, tools=TOOLS) -> dict:
    """Reachable poses ``{tool: (R, p)}`` of the frames ``tools``: the
    forward kinematics of the nominal posture displaced by ``TARGET_DQ``,
    the base at neutral."""
    q = nominal_configuration(model)
    for i, d in TARGET_DQ.items():
        q[i] += d
    return {name: rbd.frame_placement(model, q, model.frame_id(name)) for name in tools}


def ffsr_reach_problem(model: rbd.RobotModel, x0: Tensor, targets: dict, u_max: Tensor,
                       timestep: Tensor, nsteps: int, w_pose=5.0, w_u=1e-3,
                       w_term_pose=200.0, w_term_vel=20.0, with_collision: bool = False,
                       with_self_collision: bool = False) -> core.TrajOptProblem:
    """The reach from its leaves: initial states ``x0 (B, 41)``, tool poses
    ``targets {tool: (R (3, 3), p (3,))}`` (two tools, in order),
    torque bounds ``u_max (14,)``;
    stage cost dt·(Σ ½ w_pose‖log₆(M_ref⁻¹ M_tool)‖² + ½ w_u‖u‖²), terminal
    cost Σ ½ w_term_pose‖log₆‖² + ½ w_term_vel‖v_tool‖² (LOCAL velocities).
    ``with_collision``: arm 1's tool at least 0.15 from the segment from its
    target + (0.3, 0, −0.5) one metre up; ``with_self_collision``: capsules
    (radius 0.06, half-length 0.12 along each tool's z) on the two tools
    0.02 apart."""
    nv = model.nv
    nu = nv - 6
    dt, dev = x0.dtype, x0.device
    tools = tuple(targets)
    space = model.phase_space()
    actuation = torch.eye(nv, nu, dtype=dt, device=dev).roll(6, 0)
    dyn = IntegratorSemiImplEuler(
        ode=MultibodyFreeFwdDynamics(model=model, actuation=actuation), timestep=timestep)
    pose = {n: FramePlacementResidual(model=model, R_ref=R, p_ref=p, frame_id=model.frame_id(n))
            for n, (R, p) in targets.items()}
    vel = {n: FrameVelocityResidual(model=model, v_ref=x0.new_zeros(6),
                                    frame_id=model.frame_id(n)) for n in targets}
    w6 = torch.eye(6, dtype=dt, device=dev)
    rcost = core.CostStack.create(
        *(core.QuadraticResidualCost(residual=pose[n], weights=w_pose * w6 * timestep)
          for n in tools),
        core.QuadraticControlCost(w_u * torch.eye(nu, dtype=dt, device=dev) * timestep))
    term_cost = core.CostStack.create(
        *(core.QuadraticResidualCost(residual=pose[n], weights=w_term_pose * w6)
          for n in tools),
        *(core.QuadraticResidualCost(residual=vel[n], weights=w_term_vel * w6)
          for n in tools))
    constraints = [(core.ControlErrorResidual(target=u_max.new_zeros(nu)),
                    core.BoxConstraint(lower=-u_max, upper=u_max))]

    def t(v):
        return torch.tensor(v, dtype=dt, device=dev)

    if with_collision:
        seg_a = targets[tools[0]][1] + t((0.3, 0.0, -0.5))
        constraints.append((FrameCollisionResidual(
            model=model, seg_a=seg_a, seg_b=seg_a + t((0.0, 0.0, 1.0)), radius=t(0.15),
            frame_id=model.frame_id(tools[0])), core.NegativeOrthant()))
    if with_self_collision:
        z = t((0.0, 0.0, 1.0))
        constraints.append((LinkCollisionResidual(
            model=model, axis1=z, half_len1=t(0.12), radius1=t(0.06), axis2=z,
            half_len2=t(0.12), radius2=t(0.06), offset1=t((0.0, 0.0, 0.0)),
            offset2=t((0.0, 0.0, 0.0)), margin=t(0.02), frame_id1=model.frame_id(tools[0]),
            frame_id2=model.frame_id(tools[1])), core.NegativeOrthant()))
    stage = core.make_stage(rcost, dyn, space, nu, tuple(constraints))
    return core.make_problem(x0, stage, nsteps, term_cost)


def create_ffsr_problem(nsteps: int = 60, timestep: float = 0.05, dtype=torch.float64,
                        with_collision: bool = False, with_self_collision: bool = False,
                        use_mjcf=None, device="cuda") -> core.TrajOptProblem:
    """The published reach on :func:`load_ffsr_model`'s model, one scenario
    at the nominal posture at rest; replace ``x0`` by a ``(B, 41)`` batch
    to solve B scenarios."""
    dev = resolve(device)
    model, tools, u_max = load_ffsr_model(use_mjcf, dtype=dtype, device=dev)
    x0 = torch.cat([nominal_configuration(model), model.neutral().new_zeros(model.nv)])
    return ffsr_reach_problem(
        model, x0[None], reach_targets(model, tools),
        torch.tensor(u_max, dtype=dtype, device=dev),
        torch.tensor(timestep, dtype=dtype, device=dev), nsteps,
        with_collision=with_collision, with_self_collision=with_self_collision)


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    problem = create_ffsr_problem(device=args.device)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("base drift:", float((res.xs[0, -1, :3] - res.xs[0, 0, :3]).norm()))
