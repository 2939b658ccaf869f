"""Centroidal locomotion: a quadruped gait on the 9-D centroidal state.

Port of ``examples/centroidal_locomotion.py`` (reference
``examples/centroidal.py``): x = (c, h, L), four contact points, a
double-support / single-support schedule, friction cones on the active
contacts and a terminal CoM equality; N = 90 stages of explicit Euler at
dt = 0.01, (nx, nu) = (9, 12). The JAX package stacks one model a stage;
here the schedule (activity, contact points, the cones' gates) is made of
stage-varying leaves of one stage model. Solved in float64 with
``SOLVE_OPTIONS`` (``mu_init`` 1e-7). On the card its LQ subproblems (nu >
8 and nx < 12) take the per-stage loop: K2 for its Schur and KKT solves.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorEuler
from ..modelling.centroidal import (AngularAccelerationResidual,
                                    CentroidalAccelerationResidual, CentroidalCoMResidual,
                                    CentroidalFrictionConeResidual,
                                    LinearMomentumResidual)
from ..modelling.dynamics.centroidal import CentroidalFwdDynamics, ContactMap

MASS = 10.5
GRAVITY = (0.0, 0.0, -9.81)
MU_FRICTION = 0.8
NK = 4  # LF, RF, LB, RB
NU = 3 * NK
DT = 0.01
COM_INITIAL = (0.1, 0.05, 0.15)
COM_FINAL = (0.2, 0.05, 0.15)
SOLVE_OPTIONS = dict(tol=1e-5, mu_init=1e-7, max_iters=200, max_al_iters=20,
                     rollout="linear", ls_strategy="filter")


def make_schedule():
    """``(active (N, nk), points (N, nk, 3))``, numpy: double support →
    swing {LF, RB} → double support (stepped) → swing {RF, LB} → double
    support (reference ``examples/centroidal.py:44-125``)."""
    p0 = np.array([[0.2, 0.1, 0.0], [0.2, 0.0, 0.0], [0.0, 0.1, 0.0], [0.0, 0.0, 0.0]])
    p1 = p0.copy()
    p1[[0, 3], 0] += 0.05
    p2 = p1.copy()
    p2[[1, 2], 0] += 0.05
    T_ds, T_ss = 10, 30
    phases = [(T_ds, [1, 1, 1, 1], p0), (T_ss, [0, 1, 1, 0], p0), (T_ds, [1, 1, 1, 1], p1),
              (T_ss, [1, 0, 0, 1], p1), (T_ds, [1, 1, 1, 1], p2)]
    active = np.concatenate([np.tile(a, (n, 1)) for n, a, _ in phases]).astype(float)
    points = np.concatenate([np.tile(p, (n, 1, 1)) for n, _, p in phases])
    return active, points


def centroidal_problem(x0: Tensor, active: Tensor, points: Tensor, mass: Tensor,
                       gravity: Tensor, timestep: Tensor, com_final: Tensor,
                       mu: Tensor) -> core.TrajOptProblem:
    """The problem from its leaves: the schedule ``active (N, nk)``,
    ``points (N, nk, 3)``, the mass, gravity, timestep, terminal CoM target
    and friction coefficient; ``x0 (B, 9)``."""
    dtype, dev = x0.dtype, x0.device
    N = active.shape[0]
    space = core.VectorSpace(9)
    cmap = ContactMap(points=points, active=active)
    ode = CentroidalFwdDynamics(contact_map=cmap, mass=mass, gravity=gravity)
    dyn = IntegratorEuler(ode=ode, timestep=timestep)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    zero3 = x0.new_zeros(3)
    cost = core.CostStack.create(
        core.QuadraticCost.create(x0.new_zeros((9, 9)),
                                  1e-1 * torch.eye(NU, dtype=dtype, device=dev)),
        core.QuadraticResidualCost(LinearMomentumResidual(h_ref=zero3), 10.0 * eye3),
        core.QuadraticResidualCost(AngularAccelerationResidual(contact_map=cmap, ref=zero3),
                                   0.1 * eye3),
        core.QuadraticResidualCost(
            CentroidalAccelerationResidual(contact_map=cmap, mass=mass, gravity=gravity,
                                           a_ref=zero3), 100.0 * eye3),
    )
    cones = tuple((CentroidalFrictionConeResidual(mu=mu, eps=x0.new_zeros(()),
                                                  active=active[:, k], contact_id=k),
                   core.NegativeOrthant()) for k in range(NK))
    stage = core.make_stage(cost, dyn, space, NU, cones)
    term = ((CentroidalCoMResidual(c_ref=com_final), core.EqualityConstraint()),)
    return core.make_problem(x0, stage, N, core.ConstantCost(c=x0.new_zeros(())),
                             term_constraints=term)


def create_centroidal_problem(dtype=torch.float64, device="cuda") -> core.TrajOptProblem:
    """The published problem, one scenario at rest at ``COM_INITIAL``;
    replace ``x0`` by a ``(B, 9)`` batch to solve B scenarios."""
    dev = resolve(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    active, points = make_schedule()
    return centroidal_problem(
        x0=t(np.r_[COM_INITIAL, np.zeros(6)])[None], active=t(active), points=t(points),
        mass=t(MASS), gravity=t(GRAVITY), timestep=t(DT), com_final=t(COM_FINAL),
        mu=t(MU_FRICTION))


def initial_states(batch: int, seed: int):
    """``(batch, 9)`` numpy initial states: ``COM_INITIAL`` displaced by 2 cm
    (normal, each axis), at rest."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((batch, 9))
    x0[:, :3] = np.asarray(COM_INITIAL) + 0.02 * rng.standard_normal((batch, 3))
    return x0


def contact_checks(f: Tensor, active: Tensor, mu: float, tol: float) -> dict:
    """Per scenario ``(B,)`` bools on the forces ``f (B, N, nk, 3)`` under
    the schedule ``active (N, nk)``: inside the friction pyramid on active
    contacts (fz >= −tol, |fx|, |fy| <= μ fz + tol), zero (within 1e-2) on
    swing contacts."""
    on = active > 0
    fz, ft = f[..., 2], f[..., :2].abs().amax(-1)
    return {"cone": (torch.where(on, fz, 0.0).amin((1, 2)) > -tol)
            & (torch.where(on, ft - mu * fz, -1.0).amax((1, 2)) < tol),
            "swing": torch.where(on, 0.0, f.abs().amax(-1)).amax((1, 2)) < 1e-2}


def solution_checks(xs: Tensor, us: Tensor, tol: float = 1e-4) -> dict:
    """Per scenario ``(B,)`` bools: the final CoM at its target, the forces
    in the cone on active contacts and zero on swing ones (as the JAX
    package's ``tests/test_modelling.py`` asserts)."""
    active = torch.as_tensor(make_schedule()[0], dtype=xs.dtype, device=xs.device)
    target = torch.as_tensor(COM_FINAL, dtype=xs.dtype, device=xs.device)
    f = us.reshape(us.shape[:2] + (NK, 3))
    return {"com": (xs[:, -1, :3] - target).abs().amax(-1) < tol,
            **contact_checks(f, active, MU_FRICTION, tol)}
