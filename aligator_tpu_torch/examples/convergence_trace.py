"""Per-iteration convergence traces and multiplier iterates.

Port of ``examples/convergence_trace.py``: the SE(2) car (N = 40, float64)
solved with ``record_history`` and ``record_history_trajs``; prints the
history table of each scenario (:func:`~..utils.logger.print_history`) and
how far the costates λ move from one iteration to the next, which is what
the λ traces are for: watching the multipliers settle across the BCL
iterations. The JAX example also plots the trace with matplotlib; this one
prints it.

Run: ``python -m aligator_tpu_torch.examples.convergence_trace [--device cpu]``.
"""

from __future__ import annotations

import torch

from .. import solvers
from ..utils.logger import print_history
from .se2_car import create_se2_problem

SOLVE_OPTIONS = dict(tol=1e-6, mu_init=1e-2, max_iters=40, record_history=True,
                     record_history_trajs=True)


def main(device="cuda"):
    problem = create_se2_problem(nsteps=40, dtype=torch.float64, device=device)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("history shapes: hist", tuple(res.history.shape), "xs",
          tuple(res.history_xs.shape), "us", tuple(res.history_us.shape), "vs",
          tuple(res.history_vs.shape), "lams", tuple(res.history_lams.shape))
    for b in range(problem.batch):
        n = int(res.num_iters[b])
        print(f"scenario {b}: conv {bool(res.conv[b])}, {n} iterations")
        print_history(res.history[b], n)
        lam_steps = torch.linalg.vector_norm(
            res.history_lams[b, 1:n] - res.history_lams[b, :n - 1], dim=(1, 2))
        print("‖Δλ‖ per iteration:", [f"{v:.3e}" for v in lam_steps.tolist()])
    return res


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
