"""Quadruped squat ("bend") with all four feet in contact.

Port of ``examples/solo_bend.py``: the quadruped of ``solo_jump`` with its
four feet pinned (no schedule) while the base tracks a height profile z(t) =
0.7 z₀ + 0.4 z₀ sin²(freq·t), shifted to (−0.02, 0.03) in x and y; the
targets are a stage-varying ``(N, nx)`` leaf of the state cost. The
published run is N = 120 with ``solo_jump.SOLVE_OPTIONS``.
"""

from __future__ import annotations

import torch

from .._device import resolve
from ..modelling.multibody.quadruped import make_quadruped, standing_configuration
from .solo_jump import SOLVE_OPTIONS, base_actuation, feet, legged_problem

__all__ = ["SOLVE_OPTIONS", "create_solo_bend_problem"]


def create_solo_bend_problem(nsteps: int = 40, timestep: float = 0.01, freq: float = 3.0,
                             dtype=torch.float64, device="cuda"):
    """The published squat, one scenario from the standing state at rest.
    Returns ``(problem, model, targets)``."""
    dev = resolve(device)
    model = make_quadruped(dtype=dtype, device=dev)
    nv = model.nv
    nu = nv - 6
    q0 = standing_configuration(model)
    x0 = torch.cat([q0, q0.new_zeros(nv)])
    z0 = x0[2]
    t = timestep * torch.arange(nsteps, dtype=dtype, device=dev)
    targets = x0.expand(nsteps, -1).clone()
    targets[:, 0], targets[:, 1] = -0.02, 0.03
    targets[:, 2] = 0.7 * z0 + 0.4 * z0 * torch.sin(freq * t) ** 2
    w = torch.cat([x0.new_full((3,), 2.0), x0.new_full((3 + nu + nv,), 1e-3)])
    problem = legged_problem(
        model, base_actuation(nv, dtype, dev), x0[None], x0.new_ones(4), targets,
        torch.diag(w) * timestep, 1e-3 * torch.eye(nu, dtype=dtype, device=dev) * timestep,
        targets[-1], 10.0 * torch.diag(w), torch.tensor(timestep, dtype=dtype, device=dev),
        nsteps, feet(model), kd=10.0, prox_mu=1e-8)
    return problem, model, targets


if __name__ == "__main__":
    import argparse

    from .. import solvers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    problem, model, targets = create_solo_bend_problem(nsteps=120, device=args.device)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    z, zt = res.xs[0, :, 2], targets[:, 2]
    print(f"base z: start {z[0]:.3f} min {z.min():.3f} max {z.max():.3f} "
          f"(target {zt.min():.3f}..{zt.max():.3f})")
