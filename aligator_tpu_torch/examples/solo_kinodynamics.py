"""Solo quadruped kinodynamics gait.

Port of ``examples/solo_kinodynamics.py`` (reference
``examples/solo_kinodynamics.py``): the centroidal state (c, h, L) with the
8 joint coordinates of a Solo-8-class quadruped driven by commanded
accelerations, u = (contact forces, joint accelerations); T = 64 stages of
explicit Euler at dt = 0.02, (nx, nu) = (25, 20). The walk schedule (two
diagonal swing phases: activity, contact points, the joint-space swing
reference q_ref, the cones' gates) is made of stage-varying leaves of one
stage model, where the JAX package stacks one model a stage. Solved in
float64 with ``SOLVE_OPTIONS`` (``mu_init`` 1e-7).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorEuler
from ..modelling.centroidal import (CentroidalCoMResidual, CentroidalFrictionConeResidual,
                                    LinearMomentumResidual)
from ..modelling.dynamics.centroidal import ContactMap, KinodynamicsFwdDynamics

NK = 4  # LF, RF, LB, RB
NJ = 8  # hip + knee per leg
NU = 3 * NK + NJ
NX = 9 + 2 * NJ
MASS = 2.24
GRAVITY = (0.0, 0.0, -9.81)
MU_FRICTION = 0.8
DT = 0.02
COM0 = (0.0, 0.0, 0.22)
COM_STEP = (0.16, 0.0, 0.0)
SOLVE_OPTIONS = dict(tol=1e-5, mu_init=1e-7, max_iters=200, max_al_iters=20,
                     rollout="linear", ls_strategy="filter")


def make_schedule():
    """``(active (T, nk), points (T, nk, 3), q_ref (T, nj), q_nom (nj,))``,
    numpy: two diagonal swing phases, the swinging legs' hips flexed by 0.3
    and knees by −0.4 in ``q_ref``."""
    p0 = np.array([[0.2, 0.15, 0.0], [0.2, -0.15, 0.0], [-0.2, 0.15, 0.0],
                   [-0.2, -0.15, 0.0]])
    p1 = p0.copy()
    p1[[0, 3], 0] += 0.08
    p2 = p1.copy()
    p2[[1, 2], 0] += 0.08
    T_ds, T_ss = 8, 20
    phases = [(T_ds, [1, 1, 1, 1], p0), (T_ss, [0, 1, 1, 0], p0), (T_ds, [1, 1, 1, 1], p1),
              (T_ss, [1, 0, 0, 1], p1), (T_ds, [1, 1, 1, 1], p2)]
    active = np.concatenate([np.tile(a, (n, 1)) for n, a, _ in phases]).astype(float)
    points = np.concatenate([np.tile(p, (n, 1, 1)) for n, _, p in phases])
    q_nom = np.tile([0.8, -1.6], NK)
    q_ref = np.tile(q_nom, (active.shape[0], 1))
    swing = active == 0
    for k in range(NK):
        q_ref[swing[:, k], 2 * k] += 0.3
        q_ref[swing[:, k], 2 * k + 1] -= 0.4
    return active, points, q_ref, q_nom


def kinodynamics_problem(x0: Tensor, active: Tensor, points: Tensor, q_ref: Tensor,
                         q_nom: Tensor, mass: Tensor, gravity: Tensor, timestep: Tensor,
                         com_final: Tensor, mu: Tensor) -> core.TrajOptProblem:
    """The problem from its leaves: the schedule ``active (T, nk)``,
    ``points (T, nk, 3)``, ``q_ref (T, nj)``, the nominal joints ``q_nom``,
    mass, gravity, timestep, terminal CoM and friction coefficient; ``x0
    (B, 25)``."""
    dtype, dev = x0.dtype, x0.device
    T = active.shape[0]
    space = core.VectorSpace(NX)
    cmap = ContactMap(points=points, active=active)
    ode = KinodynamicsFwdDynamics(contact_map=cmap, mass=mass, gravity=gravity, n_joints=NJ)
    dyn = IntegratorEuler(ode=ode, timestep=timestep)
    w_x = np.zeros(NX)
    w_x[3:9] = 1e-1
    w_x[9 + NJ:] = 1e-2
    w_x[9:9 + NJ] = 10.0
    zeros = x0.new_zeros
    x_ref = torch.cat([zeros((T, 9)), q_ref, zeros((T, NJ))], -1)
    cost = core.CostStack.create(
        core.QuadraticStateCost(x_ref, torch.diag(torch.as_tensor(w_x, dtype=dtype,
                                                                  device=dev))),
        core.QuadraticControlCost(1e-4 * torch.eye(NU, dtype=dtype, device=dev)),
        core.QuadraticResidualCost(LinearMomentumResidual(h_ref=zeros(3)),
                                   1e-1 * torch.eye(3, dtype=dtype, device=dev)),
    )
    cones = tuple((CentroidalFrictionConeResidual(mu=mu, eps=zeros(()), active=active[:, k],
                                                  contact_id=k),
                   core.NegativeOrthant()) for k in range(NK))
    stage = core.make_stage(cost, dyn, space, NU, cones)
    x_term = torch.cat([com_final, zeros(6), q_nom, zeros(NJ)])
    w_term = np.r_[np.zeros(3), np.ones(6), 10 * np.ones(NJ), np.ones(NJ)]
    term_cost = core.QuadraticStateCost(
        x_term, torch.diag(torch.as_tensor(w_term, dtype=dtype, device=dev)))
    term = ((CentroidalCoMResidual(c_ref=com_final), core.EqualityConstraint()),)
    return core.make_problem(x0, stage, T, term_cost, term_constraints=term)


def create_kinodynamics_problem(dtype=torch.float64, device="cuda") -> core.TrajOptProblem:
    """The published problem, one scenario standing at ``COM0``; replace
    ``x0`` by a ``(B, 25)`` batch to solve B scenarios."""
    dev = resolve(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    active, points, q_ref, q_nom = make_schedule()
    x0 = np.r_[COM0, np.zeros(6), q_nom, np.zeros(NJ)]
    return kinodynamics_problem(
        x0=t(x0)[None], active=t(active), points=t(points), q_ref=t(q_ref), q_nom=t(q_nom),
        mass=t(MASS), gravity=t(GRAVITY), timestep=t(DT),
        com_final=t(np.add(COM0, COM_STEP)), mu=t(MU_FRICTION))


def initial_states(batch: int, seed: int):
    """``(batch, 25)`` numpy initial states: the CoM displaced by 2 cm
    (normal, each axis) from ``COM0``, at rest, the joints at ``q_nom``."""
    rng = np.random.default_rng(seed)
    q_nom = make_schedule()[3]
    x0 = np.tile(np.r_[COM0, np.zeros(6), q_nom, np.zeros(NJ)], (batch, 1))
    x0[:, :3] += 0.02 * rng.standard_normal((batch, 3))
    return x0


def solution_checks(xs: Tensor, us: Tensor, tol: float = 1e-5) -> dict:
    """Per scenario ``(B,)`` bools: the final CoM at its target, the forces
    in the cone on active contacts and zero on swing ones (as the JAX
    package's ``tests/test_modelling.py:191-196`` asserts)."""
    from .centroidal_locomotion import contact_checks
    active = torch.as_tensor(make_schedule()[0], dtype=xs.dtype, device=xs.device)
    target = torch.as_tensor(np.add(COM0, COM_STEP), dtype=xs.dtype, device=xs.device)
    f = us[..., :3 * NK].reshape(us.shape[:2] + (NK, 3))
    return {"com": (xs[:, -1, :3] - target).abs().amax(-1) < tol,
            **contact_checks(f, active, MU_FRICTION, 10 * tol)}
