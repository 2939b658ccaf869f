"""Talos-class humanoid walking: the problem of the whole-body benchmark.

Port of ``examples/talos_walk.py``: the nv = 28 humanoid, two 6D flat-foot
sole contacts under a double/single-support schedule, semi-implicit Euler
with dt = 0.01, a control box. One stage model serves every stage; the
schedule lives in three stage-varying leaves with a leading N axis: the
contact activity ``(N, 2)`` of the dynamics, and each foot's swing-cost
weights ``(N, 3, 3)`` and targets ``(N, 3)`` (weight 0 while the foot is in
stance). ``bench_talos.py`` runs it at t_ds = 4, t_ss = 10 (N = 32).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling.dynamics.ode import IntegratorSemiImplEuler
from ..modelling.multibody import model as rbd
from ..modelling.multibody.contact import MultibodyConstraintFwdDynamics
from ..modelling.multibody.humanoid import (actuation_matrix, effort_limits,
                                            half_sitting, make_humanoid)
from ..modelling.multibody.residuals import FrameTranslationResidual

SOLES = ("left_sole", "right_sole")


def walk_schedule(t_ds: int, t_ss: int, swing_apex: float = 0.1):
    """Contact activity ``(N, 2)`` [left, right], per-foot swing weight
    ``(N, 2)`` and swing-foot z-targets ``(N, 2)`` (float64 numpy), with
    the reference's sine profile."""
    acts, w_swing, z_tgt = [], [], []

    def phase(n, act, swing_foot=None):
        for k in range(n):
            acts.append(act)
            w, z = [0.0, 0.0], [0.0, 0.0]
            if swing_foot is not None:
                w[swing_foot] = 1.0
                z[swing_foot] = swing_apex * np.sin(np.pi * (k + 1) / t_ss)
            w_swing.append(w)
            z_tgt.append(z)

    phase(t_ds, [1.0, 1.0])
    phase(t_ss, [1.0, 0.0], swing_foot=1)  # left support: the right foot swings
    phase(t_ds, [1.0, 1.0])
    phase(t_ss, [0.0, 1.0], swing_foot=0)  # right support: the left foot swings
    phase(t_ds, [1.0, 1.0])
    return np.asarray(acts), np.asarray(w_swing), np.asarray(z_tgt)


def talos_walk_problem(model: rbd.RobotModel, x_ref: Tensor, x0: Tensor,
                       state_weights: Tensor, control_weights: Tensor,
                       term_weights: Tensor, active: Tensor, swing_weights: Tensor,
                       swing_targets: Tensor, swing_frames, actuation: Tensor,
                       timestep: Tensor, contact_frames, contact_dims, kd: float,
                       prox_mu: float, u_box=None) -> core.TrajOptProblem:
    """The walk problem from its leaves: stage cost ½‖x ⊖ x_ref‖² +
    ½‖u‖² + the two swing-foot costs ½‖p_foot − target_t‖²_{W_t}
    (``swing_weights (2, N, 3, 3)``, ``swing_targets (2, N, 3)``),
    terminal cost ½‖x ⊖ x_ref‖², contact-constrained semi-implicit Euler
    with the schedule ``active (N, ncont)``, initial states ``x0 (B, nx)``;
    ``u_box = (lower, upper)`` adds the control box."""
    space = model.phase_space()
    nu = actuation.shape[1]
    ode = MultibodyConstraintFwdDynamics(
        model=model, actuation=actuation, active=active,
        contact_frames=tuple(contact_frames), contact_dims=tuple(contact_dims),
        kd=kd, prox_mu=prox_mu)
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=timestep)
    feet = [core.QuadraticResidualCost(
        FrameTranslationResidual(model=model, p_ref=swing_targets[k],
                                 frame_id=int(swing_frames[k])),
        weights=swing_weights[k]) for k in range(2)]
    rcost = core.CostStack.create(core.QuadraticStateCost(x_ref, state_weights),
                                  core.QuadraticControlCost(control_weights), *feet)
    constraints = ()
    if u_box is not None:
        constraints = ((core.ControlErrorResidual(target=x0.new_zeros(nu)),
                        core.BoxConstraint(lower=u_box[0], upper=u_box[1])),)
    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    return core.make_problem(x0, stage, active.shape[0],
                             core.QuadraticStateCost(x_ref, term_weights))


def create_talos_walk_problem(t_ds: int = 20, t_ss: int = 80, timestep: float = 0.01,
                              swing_apex: float = 0.1, dtype=torch.float64,
                              w_foot: float = 1e5, bounds: bool = True,
                              device="cuda"):
    """The reference walk with one scenario at the half-sitting initial
    state (replace ``x0`` by a ``(B, nx)`` batch to solve B scenarios).
    The model and the schedule are computed in float64, then cast. Returns
    ``(problem, model, schedule)``."""
    dev = resolve(device)
    model64 = make_humanoid()
    nv, nu = model64.nv, model64.nv - 6
    soles = tuple(model64.frame_id(s) for s in SOLES)
    q0 = half_sitting(model64)
    x0 = torch.cat([q0, q0.new_zeros(nv)])
    sole_pos = [rbd.frame_placement(model64, q0, f)[1].numpy() for f in soles]
    sched, w_swing, z_tgt = walk_schedule(t_ds, t_ss, swing_apex)
    N = sched.shape[0]

    # the reference's weights: base position free, base orientation pinned,
    # legs 1, torso 1e3, arms 1e2; velocity weights below
    w_x = np.concatenate([np.zeros(3), np.full(3, 1e4), np.full(12, 1.0),
                          np.full(2, 1e3), np.full(8, 1e2), np.full(6, 1e2),
                          np.full(12, 10.0), np.full(2, 1e3), np.full(8, 10.0)])
    targets = np.stack([np.tile(sole_pos[k], (N, 1)) for k in range(2)])
    targets[:, :, 2] += z_tgt.T
    weights = (w_foot * timestep) * w_swing.T[:, :, None, None] * np.eye(3)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    x0 = t(x0)
    u_box = None
    if bounds:
        umax = t(effort_limits())
        u_box = (-umax, umax)
    problem = talos_walk_problem(
        model64.to(dtype, dev), x_ref=x0, x0=x0,
        state_weights=t(np.diag(w_x) * timestep),
        control_weights=t(1e-3 * np.eye(nu) * timestep),
        term_weights=t(100.0 * np.diag(w_x)), active=t(sched),
        swing_weights=t(weights), swing_targets=t(targets), swing_frames=soles,
        actuation=t(actuation_matrix(model64)), timestep=t(timestep),
        contact_frames=soles, contact_dims=(6, 6), kd=50.0, prox_mu=1e-9,
        u_box=u_box)
    return problem, problem.stages.dynamics.ode.model, t(sched)
