#!/usr/bin/env python
"""Write the float32 Talos-walk reference of the PyTorch port's checks.

Solves the ``bench_talos.py`` protocol of the JAX package in float32 (x64
off, as the bench runs): the whole-body Talos walk at N = 32 (t_ds = 4,
t_ss = 10), 2 scenarios whose initial velocities are perturbed by
0.01·N(0, 1) (numpy, seed 0, rounded to float32), ProxDDP with a 4×4
budget, tol 1e-3, μ₀ 1e-3, linear rollout, ``ls_max_steps=6``. With
``record_history`` and ``record_history_trajs`` it keeps, per scenario:

* ``prim``, ``dual`` (B, 5): the infeasibilities at the initial iterate and
  after each of the 4 Newton steps;
* ``rejected`` (B, 4): whether each Newton step left the iterate unchanged
  (the line search rejected its trial point);
* ``num_iters``, ``al_iter``, ``x0`` and the solver configuration.

``chip_smoke.py`` holds the port's float32 solve on the card against it, and
``tests/test_torch_talos.py`` the port's initial iterate on the CPU; a slow
test there reruns this script. Run from the repository root (about 4
minutes on a CPU, nearly all of it XLA compilation)::

    python tools/torch_talos_fp32_fixture.py [tests/data/torch_talos_fp32_ref.npz]
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aligator_tpu import solvers  # noqa: E402
from aligator_tpu._pytree import replace  # noqa: E402
from examples.talos_walk import create_talos_walk_problem  # noqa: E402

T_DS, T_SS = 4, 10
BATCH = 2
SEED = 0
CONFIG = dict(tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4,
              rollout="linear", ls_max_steps=6, force_initial_condition=True)


def main(path):
    problem, model, _ = create_talos_walk_problem(t_ds=T_DS, t_ss=T_SS,
                                                  dtype=jnp.float32)
    rng = np.random.default_rng(SEED)
    x0s = np.repeat(np.asarray(problem.x0, np.float64)[None], BATCH, 0)
    x0s[:, model.nq:] += 0.01 * rng.standard_normal((BATCH, model.nv))
    x0s = x0s.astype(np.float32)
    cfg = solvers.ProxDDPConfig(**CONFIG, record_history=True,
                                record_history_trajs=True)

    def one(x0i):
        return solvers.solve(replace(problem, x0=x0i), cfg)

    res = jax.jit(jax.vmap(one))(jnp.asarray(x0s))
    hist = np.asarray(res.history)  # (B, iters, 8): prim, dual, ... at each start
    # the iterate at the start of each iteration, then the final one
    xs = np.concatenate([np.asarray(res.history_xs), np.asarray(res.xs)[:, None]], 1)
    us = np.concatenate([np.asarray(res.history_us), np.asarray(res.us)[:, None]], 1)
    rejected = ((xs[:, 1:] == xs[:, :-1]).all((2, 3))
                & (us[:, 1:] == us[:, :-1]).all((2, 3)))
    arrays = dict(
        x0=x0s, nsteps=np.asarray(problem.nsteps), config=np.asarray(json.dumps(CONFIG)),
        prim=np.concatenate([hist[:, :, 0], np.asarray(res.prim_infeas)[:, None]], 1),
        dual=np.concatenate([hist[:, :, 1], np.asarray(res.dual_infeas)[:, None]], 1),
        rejected=rejected, num_iters=np.asarray(res.num_iters),
        al_iter=np.asarray(res.al_iter),
    )
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: N={problem.nsteps} batch={BATCH} num_iters="
          f"{arrays['num_iters'].tolist()} rejected={rejected.tolist()} prim="
          f"{arrays['prim'].tolist()}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tests/data/torch_talos_fp32_ref.npz")
