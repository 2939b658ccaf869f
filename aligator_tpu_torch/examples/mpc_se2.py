"""Receding-horizon MPC: apply the first control, shift the warm start,
re-solve.

Port of ``examples/mpc_se2.py`` with the protocol of ``bench_mpc.py``: the
SE(2) car at N = 50 in float32 with the linear rollout, a cold solve
(``COLD``: 10 iterations, 4 AL iterations, tol 1e-4) and then chained warm
cycles (``WARM``: 2 and 2), 20 of them; the same loop at humanoid dims
(``medium_dims.make_humanoid_dims_problem``, nx = 36, N = 100). Every
scenario of the batch is one vehicle: :func:`run_cycles` cycles them in
lockstep. On the card each cycle's solve takes the LQ route of its shape
(K1 on the SE(2) car, K3 and K4 at humanoid dims).

    python -m aligator_tpu_torch.examples.mpc_se2 [--device cpu] [--batch 4]
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import core, solvers
from ..utils.mpc import cycle_warm_start, stage_dynamics
from .se2_car import THETA0, create_se2_problem

N_CYCLES = 20
_COMMON = dict(tol=1e-4, mu_init=1e-3, rollout="linear", ls_max_steps=6)
COLD = dict(_COMMON, max_iters=10, max_al_iters=4)
WARM = dict(_COMMON, max_iters=2, max_al_iters=2)


def se2_initial_states(batch: int, seed: int = 0, dtype=torch.float32,
                       device="cuda") -> torch.Tensor:
    """``(batch, 4)`` initial states of the fleet configuration: the nominal
    car position perturbed by 0.2 m and its heading by 0.2 rad (normal)."""
    rng = np.random.default_rng(seed)
    d_p = 0.2 * rng.standard_normal((batch, 2))
    th0 = THETA0 + 0.2 * rng.standard_normal(batch)
    x0 = np.stack([0.7 + d_p[:, 0], -0.1 + d_p[:, 1], np.cos(th0), np.sin(th0)], -1)
    return torch.tensor(x0, dtype=dtype, device=device)


def mpc_cycle(problem: core.TrajOptProblem, cfg: solvers.ProxDDPConfig,
              x_cur: torch.Tensor, xs_w: torch.Tensor, us_w: torch.Tensor):
    """One cycle for every scenario: apply the first control ``us_w[:, 0]``
    to ``x_cur (B, nx)``, shift the warm start one stage and re-solve from
    the new state. The new state is written into ``problem.x0`` in place
    (the reference's ``setInitState``): the problem stays the same object,
    so the line-search trial graph it keeps (``solvers.proxddp``) is
    captured at its first cycle and replayed by the later ones, the same
    operations on the new state. Returns ``(x_next, results)``."""
    x_next = stage_dynamics(problem, 0).forward(problem.space, x_cur, us_w[:, 0])
    problem.x0.copy_(x_next)
    xs0, us0 = cycle_warm_start(xs_w, us_w)
    res = solvers.solve(problem, cfg, xs_init=xs0, us_init=us0)
    return x_next, res


def run_cycles(problem: core.TrajOptProblem, cfg: solvers.ProxDDPConfig,
               x0: torch.Tensor, xs_w: torch.Tensor, us_w: torch.Tensor,
               n_cycles: int = N_CYCLES):
    """``n_cycles`` chained cycles from ``x0`` and the warm start ``(xs_w,
    us_w)`` (``problem.x0`` ends at the last state, :func:`mpc_cycle`):
    returns the final state, the last solution and, per scenario and cycle
    ``(B, n_cycles)``, the primal infeasibility, the iterations and the
    convergence flag (device tensors; nothing is read on the host between
    cycles but what each solve's loop reads)."""
    prims, iters, convs = [], [], []
    x, xs, us = x0, xs_w, us_w
    for _ in range(n_cycles):
        x, res = mpc_cycle(problem, cfg, x, xs, us)
        xs, us = res.xs, res.us
        prims.append(res.prim_infeas)
        iters.append(res.num_iters)
        convs.append(res.conv)
    return (x, xs, us, torch.stack(prims, 1), torch.stack(iters, 1),
            torch.stack(convs, 1))


def create_mpc_problem(batch: int = 1, nsteps: int = 50, dtype=torch.float32,
                       device="cuda", seed: int = 0) -> core.TrajOptProblem:
    """The SE(2) car at ``nsteps``; one scenario is the nominal initial
    state, a batch the fleet of :func:`se2_initial_states`."""
    problem = create_se2_problem(nsteps=nsteps, dtype=dtype, device=device)
    if batch > 1:
        problem = dataclasses.replace(problem, x0=se2_initial_states(
            batch, seed, dtype, problem.x0.device))
    return problem


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--cycles", type=int, default=N_CYCLES)
    args = ap.parse_args(argv)
    problem = create_mpc_problem(args.batch, device=args.device)
    cold = solvers.solve(problem, solvers.ProxDDPConfig(**COLD))
    x, xs, us, prims, iters, _ = run_cycles(problem, solvers.ProxDDPConfig(**WARM),
                                            problem.x0, cold.xs, cold.us, args.cycles)
    dist = x[:, :2].norm(dim=-1)
    print(f"cycles {args.cycles}: |pos| mean {dist.mean().item():.4f}, iterations a "
          f"cycle {iters.float().mean().item():.2f}, primal-feasible share "
          f"{(prims <= WARM['tol']).float().mean().item():.3f}, heading "
          f"{math.degrees(math.atan2(x[0, 3].item(), x[0, 2].item())):.2f} deg")


if __name__ == "__main__":
    main()
