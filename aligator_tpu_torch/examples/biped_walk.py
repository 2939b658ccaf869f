"""Biped walk under an alternating contact schedule.

Port of ``examples/biped_walk.py``: a compact biped (free-flyer base, two
legs of hip and knee, point feet) built with ``model.make_model``; double
support, single support (right foot lifted), double support, single
support (left foot lifted), double support, as a stage-varying activity
``(N, 2)``; the base tracks a reference that advances by ``step_fwd``. The
published run solves it with :data:`SOLVE_OPTIONS`.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..modelling.multibody.model import FREEFLYER, REVOLUTE, make_model
from .solo_jump import base_actuation, feet, legged_problem

SOLVE_OPTIONS = dict(tol=1e-3, mu_init=1e-2, max_iters=60, rollout="nonlinear",
                     ls_strategy="armijo")


def make_biped(base_mass=10.0, thigh_mass=1.5, shank_mass=1.0, foot_y=0.1,
               upper_len=0.35, lower_len=0.35, dtype=torch.float64, device="cuda"):
    """The biped: a free-flyer base and two legs (hip and knee about y),
    feet ``foot0`` (left) and ``foot1`` (right)."""
    joints = [dict(type=FREEFLYER, parent=-1, mass=base_mass, com=(0.0, 0.0, 0.0),
                   inertia=np.diag([0.1, 0.1, 0.05]))]
    frames = []
    for k, sy in enumerate((+1.0, -1.0)):
        joints.append(dict(type=REVOLUTE, parent=0, placement_p=(0.0, sy * foot_y, 0.0),
                           axis=(0.0, 1.0, 0.0), mass=thigh_mass,
                           com=(0.0, 0.0, -upper_len / 2),
                           inertia=np.diag([0.01, 0.01, 0.002])))
        joints.append(dict(type=REVOLUTE, parent=len(joints) - 1,
                           placement_p=(0.0, 0.0, -upper_len), axis=(0.0, 1.0, 0.0),
                           mass=shank_mass, com=(0.0, 0.0, -lower_len / 2),
                           inertia=np.diag([0.008, 0.008, 0.001])))
        frames.append(dict(name=f"foot{k}", parent=len(joints) - 1,
                           placement_p=(0.0, 0.0, -lower_len)))
    return make_model(joints, frames, dtype=dtype, device=device)


def standing_q(model, height=0.62, bend=0.35):
    q = model.neutral().clone()
    q[2] = height
    for leg in range(2):
        q[7 + 2 * leg] = bend / 2
        q[7 + 2 * leg + 1] = -bend
    return q


def walk_schedule(n_ds: int, n_ss: int) -> np.ndarray:
    """The activity ``(N, 2)`` [left, right]: DS, SS (right lifted), DS, SS
    (left lifted), DS."""
    phases = [(n_ds, (1.0, 1.0)), (n_ss, (1.0, 0.0)), (n_ds, (1.0, 1.0)),
              (n_ss, (0.0, 1.0)), (n_ds, (1.0, 1.0))]
    return np.concatenate([np.tile(np.asarray(a), (n, 1)) for n, a in phases])


def create_biped_walk_problem(n_ds: int = 6, n_ss: int = 6, step_fwd: float = 0.05,
                              timestep: float = 0.02, dtype=torch.float64, device="cuda"):
    """The published walk, one scenario from the standing state at rest.
    Returns ``(problem, model, schedule)``."""
    dev = resolve(device)
    model = make_biped(dtype=dtype, device=dev)
    nv = model.nv
    nu = nv - 6
    sched = torch.as_tensor(walk_schedule(n_ds, n_ss), dtype=dtype, device=dev)
    N = sched.shape[0]
    q0 = standing_q(model)
    x0 = torch.cat([q0, q0.new_zeros(nv)])
    xf = x0.clone()
    xf[0] += step_fwd
    frac = torch.linspace(0.0, 1.0, N, dtype=dtype, device=dev)[:, None]
    targets = x0 * (1 - frac) + xf * frac
    w = torch.cat([x0.new_full((6,), 50.0), x0.new_full((nu,), 1.0), x0.new_full((nv,), 0.5)])
    problem = legged_problem(
        model, base_actuation(nv, dtype, dev), x0[None], sched, targets,
        torch.diag(w) * timestep, 1e-4 * torch.eye(nu, dtype=dtype, device=dev) * timestep,
        xf, 10.0 * torch.diag(w), torch.tensor(timestep, dtype=dtype, device=dev), N,
        feet(model, 2), kd=10.0, prox_mu=1e-8)
    return problem, model, sched


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    problem, model, _ = create_biped_walk_problem(device=args.device)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    print(f"base x: start {res.xs[0, 0, 0]:.3f} end {res.xs[0, -1, 0]:.3f}")
