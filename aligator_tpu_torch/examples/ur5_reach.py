"""UR5 end-effector reach with joint torque limits.

Port of ``examples/ur5_reach.py``: drive the UR5's end effector to
(0.4, 0.3, 0.4) with a quadratic task-space cost, control and velocity
regularization and |τ| <= 80, under the free multibody dynamics and
semi-implicit Euler (dt = 0.05, N = 40). The published configuration solves
it with ``ProxDDPConfig(tol=1e-4, mu_init=1e-2, max_iters=100,
rollout="nonlinear")``. Its LQ subproblems (nx = 12, general E on the
tangent bundle) take the per-stage loop, whose solves run on K2, and the
forward substitution K4.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorSemiImplEuler
from ..modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from ..modelling.multibody.model import RobotModel
from ..modelling.multibody.residuals import FrameTranslationResidual
from ..modelling.multibody.robots import make_ur5

SOLVE_OPTIONS = dict(tol=1e-4, mu_init=1e-2, max_iters=100, rollout="nonlinear")
P_TARGET = (0.4, 0.3, 0.4)


def ur5_reach_problem(model: RobotModel, x0: Tensor, p_target: Tensor, w_frame: Tensor,
                      w_u: Tensor, w_v: Tensor, w_term: Tensor, timestep: Tensor,
                      nsteps: int, tau_bound=None) -> core.TrajOptProblem:
    """The reach from its leaves: stage cost dt·(½‖p_ee − p_target‖²_{w_frame}
    + ½‖u‖²_{w_u} + ½‖v‖²_{w_v}), terminal cost ½‖p_ee − p_target‖²_{w_term},
    every joint actuated, initial states ``x0 (B, 2 nv)``; ``tau_bound``
    adds |τ| <= tau_bound."""
    nv = model.nv
    space = model.phase_space()
    ode = MultibodyFreeFwdDynamics(model=model, actuation=torch.eye(
        nv, dtype=x0.dtype, device=x0.device))
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=timestep)
    frame_res = FrameTranslationResidual(model=model, p_ref=p_target,
                                         frame_id=model.frame_id("ee"))
    W_v = w_v.new_zeros((2 * nv, 2 * nv))
    W_v[nv:, nv:] = w_v
    rcost = core.CostStack.create(
        core.QuadraticResidualCost(residual=frame_res, weights=w_frame * timestep),
        core.QuadraticControlCost(w_u * timestep),
        core.QuadraticStateCost(space.neutral(x0.dtype, x0.device), W_v * timestep),
    )
    constraints = ()
    if tau_bound is not None:
        ones = w_u.new_ones(nv)
        constraints = ((core.ControlErrorResidual(target=w_u.new_zeros(nv)),
                        core.BoxConstraint(lower=-tau_bound * ones, upper=tau_bound * ones)),)
    stage = core.make_stage(rcost, dyn, space, nv, constraints)
    term_cost = core.QuadraticResidualCost(residual=frame_res, weights=w_term)
    return core.make_problem(x0, stage, nsteps, term_cost)


def create_ur5_problem(nsteps: int = 40, timestep: float = 0.05, tau_bound=80.0,
                       dtype=torch.float64, device="cuda") -> core.TrajOptProblem:
    """The published reach, one scenario at the neutral configuration at
    rest; replace ``x0`` by a ``(B, 12)`` batch to solve B scenarios."""
    dev = resolve(device)
    model = make_ur5(dtype=dtype, device=dev)
    eye = torch.eye(model.nv, dtype=dtype, device=dev)
    return ur5_reach_problem(
        model, x0=model.phase_space().neutral(dtype, dev)[None],
        p_target=torch.tensor(P_TARGET, dtype=dtype, device=dev),
        w_frame=10.0 * eye[:3, :3], w_u=1e-4 * eye, w_v=1e-2 * eye,
        w_term=100.0 * eye[:3, :3], timestep=torch.tensor(timestep, dtype=dtype, device=dev),
        nsteps=nsteps, tau_bound=tau_bound)


if __name__ == "__main__":
    import argparse

    from .. import solvers
    from ..modelling.multibody import model as rbd

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    problem = create_ur5_problem(device=args.device)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    model = problem.stages.dynamics.ode.model
    _, p = rbd.frame_placement(model, res.xs[0, -1, :model.nq], model.frame_id("ee"))
    print("final ee position:", p.tolist(), "target:", list(P_TARGET))
