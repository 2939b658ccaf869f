"""Continuous-centroidal locomotion: the forces in the state, their rates
the control.

Port of ``examples/continuous_centroidal.py`` (reference
``examples/continuous-centroidal.py``): the gait of
:mod:`.centroidal_locomotion` on x = (c, h, L, f₁..f₄) ∈ R²¹ with u the
force rates, friction cones on state slices through
``CentroidalWrapperResidual``, and the first and last stages' boundary
equalities (zero force rate, zero linear acceleration and momentum, zero
angular momentum) as ``GatedFunction``s; the published T_ds = 10, T_ss =
40, T_tail = 50 give T = 210 stages of explicit Euler at dt = 0.01,
(nx, nu) = (21, 12). The schedule (activity, contact points, the force
weights ×100 at contact switches, the cones' and the boundary gates) is
made of stage-varying leaves of one stage model, where the JAX package
stacks one model a stage. Solved in float64 with ``SOLVE_OPTIONS``
(``mu_init`` 1e-8) from :func:`rest_forces`' warm start.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorEuler
from ..modelling.centroidal import (AngularAccelerationResidual, AngularMomentumResidual,
                                    CentroidalAccelerationResidual, CentroidalCoMResidual,
                                    CentroidalFrictionConeResidual,
                                    CentroidalWrapperResidual, LinearMomentumResidual)
from ..modelling.dynamics.centroidal import ContactMap, ContinuousCentroidalFwdDynamics

MASS = 10.5
GRAVITY = (0.0, 0.0, -9.81)
MU_FRICTION = 0.8
NK = 4
NU = 3 * NK
NX = 9 + NU
DT = 0.01
COM_INITIAL = (0.1, 0.05, 0.15)
SOLVE_OPTIONS = dict(tol=1e-5, mu_init=1e-8, max_iters=100, max_al_iters=20,
                     rollout="linear", ls_strategy="filter", filter_beta=1e-5)


def make_schedule(T_ds=10, T_ss=40, T_tail=50):
    """``(active (T, nk), points (T, nk, 3), com_final (3,), w_force (T,
    nu), g_first (T,), g_last (T,))``, numpy: the reference gait cp1..cp7,
    the force-regularization weights (fz ×100 where a contact switches) and
    the first- and last-stage gates."""
    p0 = np.array([[0.2, 0.1, 0.0], [0.2, 0.0, 0.0], [0.0, 0.1, 0.0], [0.0, 0.0, 0.0]])
    p1 = p0.copy()
    p1[[0, 3], 0] += 0.05
    p2 = p1.copy()
    p2[[1, 2], 0] += 0.05
    phases = [(T_ds, [1, 1, 1, 1], p0), (T_ss, [0, 1, 1, 0], p0), (T_ds, [1, 1, 1, 1], p1),
              (T_ss, [1, 0, 0, 1], p1), (T_ds, [1, 1, 1, 1], p2), (T_ss, [0, 1, 1, 0], p2),
              (T_ds + T_tail, [1, 1, 1, 1], p2)]
    active = np.concatenate([np.tile(a, (n, 1)) for n, a, _ in phases]).astype(float)
    points = np.concatenate([np.tile(p, (n, 1, 1)) for n, _, p in phases])
    com_final = points[-1].mean(axis=0)
    com_final[2] = COM_INITIAL[2]
    T = active.shape[0]
    switched = np.zeros((T, NK), bool)
    switched[1:] = active[1:] != active[:-1]
    w_force = np.ones((T, NK, 3))
    w_force[switched, 2] = 100.0
    g_first, g_last = np.zeros(T), np.zeros(T)
    g_first[0], g_last[-1] = 1.0, 1.0
    return active, points, com_final, w_force.reshape(T, NU), g_first, g_last


def rest_forces(active: Tensor) -> Tensor:
    """``(..., nu)``: the weight spread over the active contacts (reference
    warm start, ``continuous-centroidal.py:288-299``)."""
    n_act = active.sum(-1, keepdim=True).clamp(min=1.0)
    fz = -MASS * GRAVITY[2] / n_act * active
    f = torch.stack([torch.zeros_like(fz), torch.zeros_like(fz), fz], -1)
    return f.reshape(active.shape[:-1] + (NU,))


def continuous_problem(x0: Tensor, active: Tensor, points: Tensor, w_force: Tensor,
                       g_first: Tensor, g_last: Tensor, mass: Tensor, gravity: Tensor,
                       timestep: Tensor, com_final: Tensor, mu: Tensor) -> core.TrajOptProblem:
    """The problem from its leaves: the schedule ``active (T, nk)``, ``points
    (T, nk, 3)``, ``w_force (T, nu)`` and the gates ``g_first``, ``g_last``
    (T,); mass, gravity, timestep, terminal CoM, friction coefficient;
    ``x0 (B, 21)``."""
    dtype, dev = x0.dtype, x0.device
    T = active.shape[0]
    space = core.VectorSpace(NX)
    zero3 = x0.new_zeros(3)
    cmap = ContactMap(points=points, active=active)
    ode = ContinuousCentroidalFwdDynamics(contact_map=cmap, mass=mass, gravity=gravity)
    dyn = IntegratorEuler(ode=ode, timestep=timestep)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    w_state = torch.cat([x0.new_zeros((T, 9)), 1e-2 * w_force], -1)
    lin_acc = CentroidalAccelerationResidual(contact_map=cmap, mass=mass, gravity=gravity,
                                             a_ref=zero3)
    ang_acc = AngularAccelerationResidual(contact_map=cmap, ref=zero3)
    lin_mom = LinearMomentumResidual(h_ref=zero3)
    cost = core.CostStack.create(
        core.QuadraticCost.create(torch.diag_embed(w_state),
                                  1e-4 * torch.eye(NU, dtype=dtype, device=dev)),
        core.QuadraticResidualCost(CentroidalWrapperResidual(inner=lin_mom), 10.0 * eye3),
        core.QuadraticResidualCost(CentroidalWrapperResidual(inner=ang_acc), 0.1 * eye3),
        core.QuadraticResidualCost(CentroidalWrapperResidual(inner=lin_acc), 0.1 * eye3),
    )
    cones = tuple(
        (CentroidalWrapperResidual(inner=CentroidalFrictionConeResidual(
            mu=mu, eps=x0.new_tensor(1e-3), active=active[:, k], contact_id=k)),
         core.NegativeOrthant()) for k in range(NK))
    eq = core.EqualityConstraint()
    boundary = (
        (core.GatedFunction(func=core.ControlErrorResidual(target=x0.new_zeros(NU)),
                            gate=g_first), eq),
        (core.GatedFunction(func=CentroidalWrapperResidual(inner=lin_acc),
                            gate=g_first + g_last), eq),
        (core.GatedFunction(func=CentroidalWrapperResidual(inner=lin_mom),
                            gate=g_first + g_last), eq),
        (core.GatedFunction(func=CentroidalWrapperResidual(
            inner=AngularMomentumResidual(L_ref=zero3)), gate=g_last), eq),
    )
    stage = core.make_stage(cost, dyn, space, NU, cones + boundary)
    term = ((CentroidalCoMResidual(c_ref=com_final), eq),)
    return core.make_problem(x0, stage, T, core.ConstantCost(c=x0.new_zeros(())),
                             term_constraints=term)


def warm_start(problem: core.TrajOptProblem) -> Tensor:
    """``xs_init (B, T+1, 21)``: every stage at the initial (c, h, L) with
    the weight spread over that stage's active contacts (the last stage's
    at T)."""
    active = problem.stages.dynamics.ode.contact_map.active
    T = problem.nsteps
    forces = rest_forces(torch.cat([active, active[-1:]], 0))  # (T+1, nu)
    x0 = problem.x0
    head = x0[:, None, :9].expand(x0.shape[0], T + 1, 9)
    return torch.cat([head, forces.expand(x0.shape[0], T + 1, NU)], -1)


def create_problem(T_ds=10, T_ss=40, T_tail=50, dtype=torch.float64, device="cuda"):
    """``(problem, xs_init, com_final)``: the published problem, one
    scenario at rest at ``COM_INITIAL`` with the forces of
    :func:`rest_forces`; replace ``x0`` by a ``(B, 21)`` batch (and take
    :func:`warm_start` of the new problem) to solve B scenarios."""
    dev = resolve(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    active, points, com_final, w_force, g_first, g_last = make_schedule(T_ds, T_ss, T_tail)
    act = t(active)
    x0 = torch.cat([t(COM_INITIAL), t(np.zeros(6)), rest_forces(act[0])])[None]
    problem = continuous_problem(
        x0=x0, active=act, points=t(points), w_force=t(w_force), g_first=t(g_first),
        g_last=t(g_last), mass=t(MASS), gravity=t(GRAVITY), timestep=t(DT),
        com_final=t(com_final), mu=t(MU_FRICTION))
    return problem, warm_start(problem), com_final


def initial_states(batch: int, seed: int, T_ds=10, T_ss=40, T_tail=50):
    """``(batch, 21)`` numpy initial states: ``COM_INITIAL`` displaced by 2
    cm (normal, each axis), at rest, the weight spread over the first
    stage's active contacts."""
    rng = np.random.default_rng(seed)
    active = make_schedule(T_ds, T_ss, T_tail)[0]
    fz = -MASS * GRAVITY[2] / max(active[0].sum(), 1.0) * active[0]
    forces = np.stack([np.zeros(NK), np.zeros(NK), fz], -1).reshape(NU)
    x0 = np.tile(np.r_[COM_INITIAL, np.zeros(6), forces], (batch, 1))
    x0[:, :3] += 0.02 * rng.standard_normal((batch, 3))
    return x0


def solution_checks(xs: Tensor, us: Tensor, tol: float = 1e-4, T_ds=10, T_ss=40,
                    T_tail=50) -> dict:
    """Per scenario ``(B,)`` bools: the final CoM at its target, the forces
    of the state in the cone on active contacts, the force rate pinned to
    zero at the first stage (as the JAX package's
    ``tests/test_modelling.py:397-407`` asserts; the forces of swing contacts
    are state, which only their rates' cost drives down)."""
    from .centroidal_locomotion import contact_checks
    active, _, com_final = make_schedule(T_ds, T_ss, T_tail)[:3]
    active = torch.as_tensor(active, dtype=xs.dtype, device=xs.device)
    target = torch.as_tensor(com_final, dtype=xs.dtype, device=xs.device)
    f = xs[:, :-1, 9:].reshape(xs.shape[:1] + (-1, NK, 3))
    return {"com": (xs[:, -1, :3] - target).abs().amax(-1) < tol,
            "cone": contact_checks(f, active, MU_FRICTION, tol)["cone"],
            "first rate": us[:, 0].abs().amax(-1) < 1e-5}
