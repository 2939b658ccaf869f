"""UR5 ballistic throw: land a point released from the end effector on a
ground target.

Port of ``examples/ur5_ballistic.py``: the UR5 under the free multibody
dynamics and semi-implicit Euler (N = 40, dt = 0.025, |τ| <= 90) releases a
point from its end effector at the last knot; a terminal equality
constraint puts the point's ballistic landing on z = 0 at the target
(:class:`~..modelling.multibody.extra_residuals.BallisticLandingResidual`).
The published configuration solves it with ``ProxDDPConfig(tol=1e-3,
mu_init=1e-3, max_iters=300, rollout="nonlinear", ls_strategy="armijo")``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorSemiImplEuler
from ..modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from ..modelling.multibody.extra_residuals import BallisticLandingResidual
from ..modelling.multibody.model import RobotModel
from ..modelling.multibody.robots import make_ur5

SOLVE_OPTIONS = dict(tol=1e-3, mu_init=1e-3, max_iters=300, rollout="nonlinear",
                     ls_strategy="armijo")
TARGET_XY = (1.6, 0.8)
Q0 = (0.0, -1.2, 1.8, -0.6, 0.0, 0.0)


def ur5_ballistic_problem(model: RobotModel, x0: Tensor, target_xy: Tensor, w_x: Tensor,
                          w_u: Tensor, w_term: Tensor, tau_bound: Tensor, gravity: Tensor,
                          z_ground: Tensor, timestep: Tensor,
                          nsteps: int) -> core.TrajOptProblem:
    """The throw from its leaves: stage cost ½‖x‖²_{w_x} + ½‖u‖²_{w_u} (the
    weights already scaled by dt), terminal cost ½‖x‖²_{w_term}, |τ| <=
    tau_bound, the landing of the point released from "ee" at the last knot
    on z = z_ground equal to ``target_xy``; initial states ``x0 (B, 12)``."""
    nv = model.nv
    space = model.phase_space()
    ode = MultibodyFreeFwdDynamics(model=model, actuation=torch.eye(
        nv, dtype=x0.dtype, device=x0.device))
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=timestep)
    landing = BallisticLandingResidual(model=model, target_xy=target_xy, gravity=gravity,
                                       z_ground=z_ground, frame_id=model.frame_id("ee"))
    x_ref = w_x.new_zeros(2 * nv)
    rcost = core.CostStack.create(core.QuadraticStateCost(x_ref, w_x),
                                  core.QuadraticControlCost(w_u))
    ones = w_u.new_ones(nv)
    constraints = ((core.ControlErrorResidual(target=w_u.new_zeros(nv)),
                    core.BoxConstraint(lower=-tau_bound * ones, upper=tau_bound * ones)),)
    stage = core.make_stage(rcost, dyn, space, nv, constraints)
    return core.make_problem(x0, stage, nsteps, core.QuadraticStateCost(x_ref, w_term),
                             term_constraints=((landing, core.EqualityConstraint()),))


def create_ballistic_problem(nsteps: int = 40, timestep: float = 0.025, tau_bound=90.0,
                             target_xy=TARGET_XY, dtype=torch.float64,
                             device="cuda") -> core.TrajOptProblem:
    """The published throw, one scenario from its start at rest; replace
    ``x0`` by a ``(B, 12)`` batch to solve B scenarios."""
    dev = resolve(device)
    model = make_ur5(dtype=dtype, device=dev)
    nv = model.nv
    eye = torch.eye(nv, dtype=dtype, device=dev)
    w_x = torch.zeros((2 * nv, 2 * nv), dtype=dtype, device=dev)
    w_x[:nv, :nv] = 0.01 * eye * timestep
    w_term = torch.zeros_like(w_x)
    w_term[nv:, nv:] = 1e-3 * eye
    x0 = torch.zeros(2 * nv, dtype=dtype, device=dev)
    x0[:nv] = torch.tensor(Q0, dtype=dtype, device=dev)

    def t(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    return ur5_ballistic_problem(model, x0[None], t(target_xy), w_x, 1e-4 * eye * timestep,
                                 w_term, t(tau_bound), t(9.81), t(0.0), t(timestep), nsteps)


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    problem = create_ballistic_problem(device=args.device)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    landing = problem.term_constraints[0][0]
    miss = landing.value(problem.space, res.xs[:, -1], res.us[:, -1])
    print("landing miss (m):", miss[0].tolist())
    print("max |tau|:", float(res.us.abs().max()))
