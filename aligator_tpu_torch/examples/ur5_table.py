"""UR5 reach over a table with collision keep-outs.

Port of ``examples/ur5_table.py``: the UR5's end effector reaches a point
just above a table (z = 0.15) while a capsule on it (radius 0.04, half-length
0.06 along the frame's z) stays above the table plane
(:class:`~..modelling.multibody.geometry.FrameHalfspaceResidual`) and a
sphere of the same radius clears a box on the table by 0.01
(:class:`~..modelling.multibody.geometry.FrameBoxResidual`), under |τ| <= 80,
the free multibody dynamics and semi-implicit Euler. The published
configuration (N = 30, dt = 0.05) solves it with ``ProxDDPConfig(tol=1e-4,
mu_init=1e-2, max_iters=100)`` from an elbow-up start. Its LQ subproblems
(nx = 12, general E on the tangent bundle) take the per-stage loop, whose
solves run on K2, and the forward substitution K4.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorSemiImplEuler
from ..modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from ..modelling.multibody import geometry as geo
from ..modelling.multibody import model as rbd
from ..modelling.multibody.model import RobotModel
from ..modelling.multibody.residuals import FrameTranslationResidual
from ..modelling.multibody.robots import make_ur5

SOLVE_OPTIONS = dict(tol=1e-4, mu_init=1e-2, max_iters=100)
TABLE_HEIGHT = 0.15
EE_RADIUS = 0.04
CAPSULE_HALF_LEN = 0.06
P_TARGET = (0.45, 0.25, TABLE_HEIGHT + EE_RADIUS + 0.03)
BOX_CENTER = (0.35, 0.0, TABLE_HEIGHT + 0.1)
BOX_HALF_EXTENTS = (0.08, 0.08, 0.1)
BOX_MARGIN = 0.01
Q0 = (0.0, -1.2, 1.6, 0.0, 0.0, 0.0)  # elbow up: the end effector above the table


def ur5_table_problem(model: RobotModel, x0: Tensor, p_target: Tensor, w_frame: Tensor,
                      w_u: Tensor, w_v: Tensor, w_term: Tensor, timestep: Tensor,
                      nsteps: int, tau_bound: Tensor, table: dict,
                      box: dict | None = None) -> core.TrajOptProblem:
    """The reach from its leaves: stage cost dt·(½‖p_ee − p_target‖²_{w_frame}
    + ½‖u‖²_{w_u} + ½‖v‖²_{w_v}), terminal cost ½‖p_ee − p_target‖²_{w_term},
    |τ| <= tau_bound, initial states ``x0 (B, 12)``; ``table`` the fields of
    the end effector's :class:`~..modelling.multibody.geometry.FrameHalfspaceResidual`
    (normal, plane_offset, offset, radius, axis, half_len, margin), ``box``
    those of its :class:`~..modelling.multibody.geometry.FrameBoxResidual`
    (box_center, box_rot, half_extents, offset, radius, margin) or None."""
    nv = model.nv
    space = model.phase_space()
    ee = model.frame_id("ee")
    ode = MultibodyFreeFwdDynamics(model=model, actuation=torch.eye(
        nv, dtype=x0.dtype, device=x0.device))
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=timestep)
    frame_res = FrameTranslationResidual(model=model, p_ref=p_target, frame_id=ee)
    W_v = w_v.new_zeros((2 * nv, 2 * nv))
    W_v[nv:, nv:] = w_v
    rcost = core.CostStack.create(
        core.QuadraticResidualCost(residual=frame_res, weights=w_frame * timestep),
        core.QuadraticControlCost(w_u * timestep),
        core.QuadraticStateCost(space.neutral(x0.dtype, x0.device), W_v * timestep),
    )
    ones = w_u.new_ones(nv)
    constraints = [
        (core.ControlErrorResidual(target=w_u.new_zeros(nv)),
         core.BoxConstraint(lower=-tau_bound * ones, upper=tau_bound * ones)),
        (geo.FrameHalfspaceResidual(model=model, frame_id=ee, **table), core.NegativeOrthant()),
    ]
    if box is not None:
        constraints.append((geo.FrameBoxResidual(model=model, frame_id=ee, **box),
                            core.NegativeOrthant()))
    stage = core.make_stage(rcost, dyn, space, nv, tuple(constraints))
    term_cost = core.QuadraticResidualCost(residual=frame_res, weights=w_term)
    return core.make_problem(x0, stage, nsteps, term_cost)


def table_leaves(dtype=torch.float64, device="cuda") -> dict:
    """The table keep-out's fields: the plane z = TABLE_HEIGHT, the end
    effector's capsule (radius EE_RADIUS, half-length CAPSULE_HALF_LEN along
    the frame's z), no margin."""
    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return dict(normal=t((0.0, 0.0, 1.0)), plane_offset=t(TABLE_HEIGHT),
                offset=t((0.0, 0.0, 0.0)), radius=t(EE_RADIUS), axis=t((0.0, 0.0, 1.0)),
                half_len=t(CAPSULE_HALF_LEN), margin=t(0.0))


def box_leaves(dtype=torch.float64, device="cuda") -> dict:
    """The box obstacle's fields: the box on the table between the start and
    the target, the end effector's sphere (radius EE_RADIUS), margin
    BOX_MARGIN."""
    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return dict(box_center=t(BOX_CENTER), box_rot=torch.eye(3, dtype=dtype, device=device),
                half_extents=t(BOX_HALF_EXTENTS), offset=t((0.0, 0.0, 0.0)),
                radius=t(EE_RADIUS), margin=t(BOX_MARGIN))


def create_ur5_table_problem(nsteps: int = 40, timestep: float = 0.05, tau_bound=80.0,
                             dtype=torch.float64, with_box: bool = True,
                             device="cuda") -> core.TrajOptProblem:
    """The published reach, one scenario from the elbow-up start at rest;
    replace ``x0`` by a ``(B, 12)`` batch to solve B scenarios."""
    dev = resolve(device)
    model = make_ur5(dtype=dtype, device=dev)
    eye = torch.eye(model.nv, dtype=dtype, device=dev)
    x0 = torch.zeros(2 * model.nv, dtype=dtype, device=dev)
    x0[:model.nq] = torch.tensor(Q0, dtype=dtype, device=dev)
    return ur5_table_problem(
        model, x0=x0[None], p_target=torch.tensor(P_TARGET, dtype=dtype, device=dev),
        w_frame=10.0 * eye[:3, :3], w_u=1e-4 * eye, w_v=1e-2 * eye,
        w_term=200.0 * eye[:3, :3], timestep=torch.tensor(timestep, dtype=dtype, device=dev),
        nsteps=nsteps, tau_bound=torch.tensor(tau_bound, dtype=dtype, device=dev),
        table=table_leaves(dtype, dev), box=box_leaves(dtype, dev) if with_box else None)


def ee_heights(model: RobotModel, xs: Tensor) -> Tensor:
    """The end effector's height over the trajectories ``xs (..., nx)``."""
    return rbd.frame_placement(model, xs[..., :model.nq], model.frame_id("ee"))[1][..., 2]


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    problem = create_ur5_table_problem(nsteps=30, device=args.device)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    model = problem.stages.dynamics.ode.model
    print("min ee z over trajectory:", float(ee_heights(model, res.xs).min()),
          "(table at", TABLE_HEIGHT, ")")
    _, p = rbd.frame_placement(model, res.xs[0, -1, :model.nq], model.frame_id("ee"))
    print("final ee error:", float((p - torch.tensor(P_TARGET, dtype=p.dtype,
                                                      device=p.device)).norm()))
