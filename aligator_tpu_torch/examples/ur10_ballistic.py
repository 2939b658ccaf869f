"""UR10 payload throw: grasp, swing, release, hit a target.

Port of ``examples/ur10_ballistic.py``: a UR10 holding a free-flying payload
(the "mug") in a rigid 6D grasp must throw it so that its ballistic flight
ends on a target point, under torque and joint-velocity limits, with a
terminal equality constraint on the payload's position. One model (the arm
and the payload as a two-root forest, ``make_ur10_with_payload``) and one
stage model carry the whole schedule: the grasp is a 6D loop constraint
(``contact_frames2``) whose stage-varying ``active (N, 1)`` flag is the
model switch, constrained dynamics while it is 1, free fall after. The
grasp's Baumgarte gains are the reference's corrector gains, kp = 1e-3 and
kd = 2√kp, with the relative position reference 0 (the payload starts at
the tool).

The published run is N = 80, dt = 0.025 with :data:`SOLVE_OPTIONS` from
:func:`warm_start` (u₀, the grasp's static inverse dynamics, at every
stage, and its rollout). Its LQ subproblems (ndx 24, general E) take the
per-stage loop on K2 and the forward substitution K4; the loop
constraint's derivatives are exact tangents through the KKT solve, on K2.
``target_pos`` may be ``(B, 3)``, one target a scenario.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling.dynamics.ode import IntegratorSemiImplEuler
from ..modelling.multibody import model as rbd
from ..modelling.multibody.contact import (MultibodyConstraintFwdDynamics,
                                           underactuated_constrained_rnea)
from ..modelling.multibody.residuals import FrameTranslationResidual
from ..modelling.multibody.robots import make_ur10_with_payload, ur10_effort_limits
from ..utils.rollout import rollout

Q0_ARM = (0.0, math.radians(-120), 2 * math.pi / 3, math.radians(-45), 0.0, 0.0)
TARGET_POS = (1.0, 1.5, 0.0)
UR10_VEL_LIMITS = (2.16, 2.16, 3.15, 3.2, 3.2, 3.2)
SOLVE_OPTIONS = dict(tol=1e-4, dual_tol=1e-3, mu_init=1e-2, max_iters=400,
                     rollout="linear", ls_strategy="filter")
KP_GRASP = 1e-3


def ur10_ballistic_problem(model: rbd.RobotModel, x0: Tensor, u0: Tensor, active: Tensor,
                           w_x: Tensor, w_u: Tensor, w_term: Tensor, effort: Tensor,
                           vel_limits: Tensor, target_pos: Tensor, p_refs: Tensor,
                           timestep: Tensor, nsteps: int, kp: float, kd: float,
                           prox_mu: float) -> core.TrajOptProblem:
    """The throw from its leaves: stage cost ½‖x ⊖ x0‖²_{w_x} + ½‖u −
    u0‖²_{w_u}, terminal cost ½‖x ⊖ x0‖²_{w_term}, |u| <= effort and the
    arm's |v| <= vel_limits at every stage and at the end, the payload on
    ``target_pos`` ((3,), or (B, 3) one a scenario) at the end; the grasp
    (tool ``ee`` to payload ``mug``, 6D) active by ``active (N, 1)``;
    initial states ``x0 (B, 25)``."""
    nv, nu = model.nv, u0.shape[-1]
    space = model.phase_space()
    dt, dev = x0.dtype, x0.device
    B = torch.cat([torch.eye(nu, dtype=dt, device=dev),
                   torch.zeros(nv - nu, nu, dtype=dt, device=dev)])
    ee, mug = model.frame_id("ee"), model.frame_id("mug")
    ode = MultibodyConstraintFwdDynamics(
        model=model, actuation=B, active=active, contact_frames=(ee,), contact_dims=(6,),
        contact_frames2=(mug,), prox_mu=prox_mu, kp=kp, kd=kd, p_refs=p_refs)
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=timestep)
    x_ref = x0[0] if x0.ndim == 2 else x0
    rcost = core.CostStack.create(core.QuadraticStateCost(x_ref, w_x),
                                  core.QuadraticControlCost(w_u, target=u0))
    vel_fn = core.FunctionSlice(func=core.StateErrorResidual(target=space.neutral(dt, dev)),
                                indices=tuple(range(nv, nv + 6)))
    vel_box = (vel_fn, core.BoxConstraint(lower=-vel_limits, upper=vel_limits))
    constraints = ((core.ControlErrorResidual(target=u0.new_zeros(nu)),
                    core.BoxConstraint(lower=-effort, upper=effort)), vel_box)
    mug_pos = FrameTranslationResidual(model=model, p_ref=target_pos, frame_id=mug,
                                       per_scenario=target_pos.ndim == 2)
    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    return core.make_problem(x0, stage, nsteps, core.QuadraticStateCost(x_ref, w_term),
                             term_constraints=((mug_pos, core.EqualityConstraint()), vel_box))


def grasp_schedule(nsteps: int, t_contact_frac: float = 0.4) -> np.ndarray:
    """The grasp's activity ``(N, 1)``: 1 up to stage ⌊t_contact_frac·N⌋,
    then 0 (the release)."""
    return (np.arange(nsteps) <= int(t_contact_frac * nsteps)).astype(np.float64)[:, None]


def create_ur10_ballistic_problem(nsteps: int = 200, timestep: float = 0.01,
                                  t_contact_frac: float = 0.4, dtype=torch.float64,
                                  target_pos=TARGET_POS, device="cuda"):
    """The published throw, one scenario (or one per row of ``target_pos
    (B, 3)``) from the arm's reference posture with the payload at the
    tool, at rest. Returns ``(problem, model, u0, schedule)``."""
    dev = resolve(device)
    model = make_ur10_with_payload(dtype=dtype, device=dev)
    nv, nu = model.nv, 6
    ee = model.frame_id("ee")
    q = torch.tensor(Q0_ARM + (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0), dtype=dtype, device=dev)
    q[6:9] = rbd.frame_placement(model, q, ee)[1]
    x0 = torch.cat([q, q.new_zeros(nv)])
    B = torch.cat([torch.eye(nu, dtype=dtype, device=dev),
                   torch.zeros(nv - nu, nu, dtype=dtype, device=dev)])
    u0, _ = underactuated_constrained_rnea(model, q, q.new_zeros(nv), B, (ee,),
                                           contact_dims=(6,),
                                           contact_frames2=(model.frame_id("mug"),))
    w_x = np.concatenate([[1e-3] * nv, [0.1] * nv])
    w_x[6:12] = 0.0  # the payload's configuration and velocity are free
    w_x[nv + 6:nv + 12] = 0.0
    w_xf = np.zeros(2 * nv)
    w_xf[:6] = 1e-4
    w_xf[nv + 6:] = 1e-6

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    target = t(target_pos)
    x0s = x0[None].expand(target.shape[0] if target.ndim == 2 else 1, -1).clone()
    sched = t(grasp_schedule(nsteps, t_contact_frac))
    problem = ur10_ballistic_problem(
        model, x0s, u0, sched, w_x=t(np.diag(w_x) * timestep),
        w_u=t(1e-5 * np.eye(nu) * timestep), w_term=t(np.diag(w_xf)),
        effort=ur10_effort_limits(dtype, dev), vel_limits=t(UR10_VEL_LIMITS),
        target_pos=target, p_refs=q.new_zeros(1, 3), timestep=t(timestep),
        nsteps=nsteps, kp=KP_GRASP, kd=2.0 * math.sqrt(KP_GRASP), prox_mu=1e-9)
    return problem, model, u0, sched


def warm_start(problem: core.TrajOptProblem):
    """The published initial guess ``(xs_init, us_init)``: u₀ at every stage
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
    ap.add_argument("--full", action="store_true", help="N = 200, dt = 0.01")
    args = ap.parse_args()
    n, h = (200, 0.01) if args.full else (80, 0.025)
    problem, model, u0, _ = create_ur10_ballistic_problem(n, h, device=args.device)
    xs, us = warm_start(problem)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS), xs_init=xs,
                        us_init=us)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    print("payload final pos:", res.xs[0, -1, 6:9].tolist(), "target:", TARGET_POS)
