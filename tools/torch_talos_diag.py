#!/usr/bin/env python
"""Diagnostics of the port's Talos-walk solve on the CPU.

Runs the ``bench_talos.py`` protocol (N = 32, ProxDDP 4×4 budget) on a few
scenarios and prints:

1. the PyTorch ops dispatched by one float32 solve, by phase (derivative
   evaluation, line-search evaluation, primal contact solves, the SE(3)
   chart Jacobians of ``batched_jacfwd``, the LQ solve): on the card each
   op is roughly one kernel launch, so this shows where the host time of a
   host-bound solve goes;
2. the primal and dual infeasibility after 1..4 iterations in float32 and
   float64;
3. every SPD factorization of the float32 solve that fails, with the
   extreme eigenvalues of its matrix (float64 eigvalsh).

Run from the repository root (about a minute)::

    python tools/torch_talos_diag.py [batch]
"""

import collections
import dataclasses
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import aligator_tpu_torch as at  # noqa: E402
from aligator_tpu_torch.core import manifolds, problem as problem_mod  # noqa: E402
from aligator_tpu_torch.examples.talos_walk import create_talos_walk_problem  # noqa: E402
from aligator_tpu_torch.gar import riccati, spd_solve  # noqa: E402
from aligator_tpu_torch.modelling.multibody import contact  # noqa: E402

PHASES = ((problem_mod, "compute_derivatives", "derivatives"),
          (problem_mod, "evaluate", "line-search evaluation"),
          (contact, "cfd_internals", "primal contact solve"),
          (manifolds, "batched_jacfwd", "SE(3) chart Jacobians"),
          (riccati, "solve_and_gains", "LQ solve"))


def problem(batch, dtype):
    prob, model, _ = create_talos_walk_problem(4, 10, dtype=dtype, device="cpu")
    rng = np.random.default_rng(0)
    x0s = np.repeat(prob.x0.double().numpy(), batch, 0)
    x0s[:, model.nq:] += 0.01 * rng.standard_normal((batch, model.nv))
    return dataclasses.replace(prob, x0=torch.tensor(x0s, dtype=dtype))


def config(max_iters=4):
    return at.solvers.ProxDDPConfig(tol=1e-3, mu_init=1e-3, max_iters=max_iters,
                                    max_al_iters=4, ls_max_steps=6)


def count_ops(prob):
    counts, stack = collections.Counter(), ["other"]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[stack[-1]] += 1
            return func(*args, **(kwargs or {}))

    saved = []
    for mod, name, tag in PHASES:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapped(*a, _fn=fn, _tag=tag, **k):
            stack.append(_tag)
            try:
                return _fn(*a, **k)
            finally:
                stack.pop()

        setattr(mod, name, wrapped)
    try:
        with Count():
            at.solvers.solve(prob, config())
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    total = sum(counts.values())
    print(f"ops dispatched by one float32 solve: {total}")
    for tag, n in counts.most_common():
        print(f"  {n:8d} ({100 * n / total:4.1f}%)  {tag} (innermost phase)")


def failed_factorizations(prob):
    plain = spd_solve.spd_solve_plain

    downstream = collections.Counter()

    def checked(A, R):
        _, info = torch.linalg.cholesky_ex(A)
        flat = A.reshape(-1, *A.shape[-2:])
        for i in torch.nonzero(info.flatten()).flatten().tolist():
            if not torch.isfinite(flat[i]).all():
                downstream[A.shape[-1]] += 1
                continue
            ev = torch.linalg.eigvalsh(flat[i].double())
            print(f"  n={A.shape[-1]} r={R.shape[-1]}: Cholesky failed, eigenvalues "
                  f"{ev.min().item():.3e} .. {ev.max().item():.3e}")
        return plain(A, R)

    spd_solve.spd_solve_plain = checked
    try:
        at.solvers.solve(prob, config())
    finally:
        spd_solve.spd_solve_plain = plain
    print(f"  and {sum(downstream.values())} non-finite matrices downstream of a "
          f"failure (by n: {dict(downstream)})")


def main(batch):
    torch.set_num_threads(4)
    count_ops(problem(batch, torch.float32))
    for dtype in (torch.float32, torch.float64):
        prob = problem(batch, dtype)
        for it in range(1, 5):
            r = at.solvers.solve(prob, config(it))
            print(f"{dtype} after {it} iteration(s): max prim "
                  f"{r.prim_infeas.max().item():.3e}, max dual {r.dual_infeas.max().item():.3e}")
    print("failed factorizations of the float32 solve:")
    failed_factorizations(problem(batch, torch.float32))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
