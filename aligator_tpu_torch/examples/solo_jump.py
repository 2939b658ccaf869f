"""Quadruped jump under a contact schedule: stance, flight, landing.

Port of ``examples/solo_jump.py``: the nv = 14 quadruped on its four point
feet (3D world contacts, kd = 10), semi-implicit Euler with dt = 0.02, a
stage-varying contact activity ``(N, 4)`` (all feet, none, all feet) and
stage-varying state targets ``(N, nx)`` (the base 0.25 m higher during the
flight). One stage model serves every stage: its schedule and targets are
leaves with a leading N axis, read a stage at a time by the nonlinear
rollout. The published run is n_stance, n_flight, n_land = 10, 8, 10 with
:data:`SOLVE_OPTIONS`. On the card the derivative rows go to K5 for the
whole (B, N) block at once, the contact-KKT derivative solves and the
per-stage LQ loop (ndx 28, general E) to K2, the forward substitution to
K4.

:func:`legged_problem` builds the problems of this family from their
leaves (also ``solo_bend`` and ``biped_walk``).
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
from ..modelling.multibody.quadruped import make_quadruped, standing_configuration

SOLVE_OPTIONS = dict(tol=1e-3, mu_init=1e-2, max_iters=60, rollout="nonlinear")


def legged_problem(model: rbd.RobotModel, actuation: Tensor, x0: Tensor, active: Tensor,
                   targets: Tensor, w_x: Tensor, w_u: Tensor, term_target: Tensor,
                   w_term: Tensor, timestep: Tensor, nsteps: int, contact_frames,
                   kd: float, prox_mu: float) -> core.TrajOptProblem:
    """A legged problem from its leaves: stage cost ½‖x ⊖ target_t‖²_{w_x}
    + ½‖u‖²_{w_u} (``targets`` ``(nx,)`` or ``(N, nx)``), terminal cost
    ½‖x ⊖ term_target‖²_{w_term}, 3D world contacts on ``contact_frames``
    with the activity ``active`` (``(ncont,)`` or ``(N, ncont)``),
    semi-implicit Euler, initial states ``x0 (B, nx)``."""
    ode = MultibodyConstraintFwdDynamics(
        model=model, actuation=actuation, active=active,
        contact_frames=tuple(contact_frames), kd=kd, prox_mu=prox_mu)
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=timestep)
    rcost = core.CostStack.create(core.QuadraticStateCost(targets, w_x),
                                  core.QuadraticControlCost(w_u))
    stage = core.make_stage(rcost, dyn, model.phase_space(), actuation.shape[-1])
    return core.make_problem(x0, stage, nsteps, core.QuadraticStateCost(term_target, w_term))


def feet(model: rbd.RobotModel, n: int = 4) -> tuple:
    return tuple(model.frame_id(f"foot{k}") for k in range(n))


def base_actuation(nv: int, dtype=torch.float64, device="cuda") -> Tensor:
    """(nv, nv − 6): every joint but the free-flyer base actuated."""
    dev = resolve(device)
    B = torch.zeros(nv, nv - 6, dtype=dtype, device=dev)
    B[6:] = torch.eye(nv - 6, dtype=dtype, device=dev)
    return B


def jump_schedule(n_stance: int, n_flight: int, n_land: int) -> np.ndarray:
    """The contact activity ``(N, 4)``: all feet, none, all feet."""
    return np.concatenate([np.ones((n_stance, 4)), np.zeros((n_flight, 4)),
                           np.ones((n_land, 4))])


def create_solo_jump_problem(n_stance: int = 10, n_flight: int = 8, n_land: int = 10,
                             timestep: float = 0.02, dtype=torch.float64, device="cuda"):
    """The published jump, one scenario from the standing state at rest.
    Returns ``(problem, model, (n_stance, n_flight, n_land))``."""
    dev = resolve(device)
    model = make_quadruped(dtype=dtype, device=dev)
    nv = model.nv
    nu = nv - 6
    N = n_stance + n_flight + n_land
    q0 = standing_configuration(model)
    x0 = torch.cat([q0, q0.new_zeros(nv)])
    w = torch.cat([x0.new_full((6,), 1.0), x0.new_full((nu,), 0.1), x0.new_full((nv,), 0.01)])
    x_up = x0.clone()
    x_up[2] += 0.25
    flight = torch.arange(N, device=dev)
    flight = ((flight >= n_stance) & (flight < n_stance + n_flight))[:, None]
    targets = torch.where(flight, x_up, x0)
    problem = legged_problem(
        model, base_actuation(nv, dtype, dev), x0[None],
        torch.as_tensor(jump_schedule(n_stance, n_flight, n_land), dtype=dtype, device=dev),
        targets, torch.diag(w) * timestep, 1e-4 * torch.eye(nu, dtype=dtype, device=dev) * timestep,
        x0, 10.0 * torch.diag(w), torch.tensor(timestep, dtype=dtype, device=dev), N,
        feet(model), kd=10.0, prox_mu=1e-8)
    return problem, model, (n_stance, n_flight, n_land)


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    problem, model, _ = create_solo_jump_problem(device=args.device)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    z = res.xs[0, :, 2]
    print(f"base height: start {z[0]:.3f} peak {z.max():.3f} end {z[-1]:.3f}")
