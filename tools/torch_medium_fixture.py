#!/usr/bin/env python
"""Write the medium-dim reference fixture of the PyTorch port's tests.

Solves, in float64 with ``jax.jit(jax.vmap(...))`` of the JAX package:

* the humanoid-dims problem of ``bench.py`` (nx=36, nu=12, nc=12) at N = 20,
  4 initial states ``x0 + 0.1·N(0, 1)`` (numpy, seed 3), ProxDDP with
  ``HUMANOID_OPTS``;
* the dense LQR-56 of ``bench_lqr.py`` (``PRNGKey(42)``) at N = 20, 4
  initial states ``x0 + 0.1·N(0, 1)`` (numpy, seed 7), with ProxDDP
  (``LQR_PROX_OPTS``) and with FDDP (``LQR_FDDP_OPTS``).

The archive holds the initial states, the LQR's parameters (the port
builds its problem from them, ``convert.linear_problem_from_numpy``) and
the solvers' results; ``tests/test_torch_medium.py`` holds the port's
solves against them, and its ``slow`` tests rerun these solves live.

Run from the repository root (about a minute on a CPU, most of it XLA
compilation)::

    python tools/torch_medium_fixture.py [tests/data/torch_medium_ref.npz]
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from aligator_tpu import solvers  # noqa: E402
from aligator_tpu._pytree import replace  # noqa: E402
from bench import make_humanoid_dims_problem  # noqa: E402
from bench_lqr import make_dense_lqr  # noqa: E402

N, BATCH = 20, 4
HUMANOID_OPTS = dict(tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4,
                     rollout="linear", ls_max_steps=6)
LQR_PROX_OPTS = dict(tol=1e-7, mu_init=1e-9, max_iters=2, rollout="linear")
LQR_FDDP_OPTS = dict(tol=1e-7, max_iters=2)
HUMANOID_FIELDS = ("num_iters", "conv", "al_iter", "xs", "us", "vs", "lams")
PROX_FIELDS = ("num_iters", "conv", "al_iter", "xs", "us", "lams")
FDDP_FIELDS = ("num_iters", "conv", "xs", "us", "K", "kff", "prim_infeas",
               "dual_infeas", "traj_cost")


def _fields(res, names):
    return {k: np.asarray(getattr(res, k)) for k in names}


def humanoid_reference():
    """``{x0s, <HUMANOID_FIELDS>}`` of the humanoid-dims ProxDDP solve."""
    jprob = make_humanoid_dims_problem(N, jnp.float64)
    x0s = np.asarray(jprob.x0) + 0.1 * np.random.default_rng(3).standard_normal((BATCH, 36))
    res = jax.jit(jax.vmap(lambda x0: solvers.solve(
        replace(jprob, x0=x0), solvers.ProxDDPConfig(**HUMANOID_OPTS))))(jnp.asarray(x0s))
    return dict(x0s=x0s, **_fields(res, HUMANOID_FIELDS))


def dense_lqr_params():
    """The dense LQR's JAX problem and its leaves for the port: ``A B c Q R
    Q_term`` and the perturbed initial states ``x0``."""
    jprob = make_dense_lqr(nsteps=N, dtype=jnp.float64)
    dyn, cost = jprob.stages.dynamics, jprob.stages.cost
    x0s = np.asarray(jprob.x0) + 0.1 * np.random.default_rng(7).standard_normal((BATCH, 56))
    params = dict(A=dyn.A[0], B=dyn.B[0], c=dyn.c[0], Q=cost.Q[0], R=cost.R[0],
                  Q_term=jprob.term_cost.Q)
    params = {k: np.asarray(v) for k, v in params.items()}
    return jprob, dict(params, x0=x0s)


def dense_lqr_reference(solver):
    """``<PROX_FIELDS>`` (solver "proxddp") or ``<FDDP_FIELDS>`` ("fddp") of
    the dense LQR's solve."""
    jprob, params = dense_lqr_params()
    if solver == "proxddp":
        def one(x0):
            return solvers.solve(replace(jprob, x0=x0), solvers.ProxDDPConfig(**LQR_PROX_OPTS))
        names = PROX_FIELDS
    else:
        def one(x0):
            return solvers.fddp.solve(replace(jprob, x0=x0), solvers.FDDPConfig(**LQR_FDDP_OPTS))
        names = FDDP_FIELDS
    return _fields(jax.jit(jax.vmap(one))(jnp.asarray(params["x0"])), names)


def main(path):
    arrays = {f"humanoid_{k}": v for k, v in humanoid_reference().items()}
    arrays.update({f"lqr_{k}": v for k, v in dense_lqr_params()[1].items()})
    for solver in ("proxddp", "fddp"):
        arrays.update({f"{solver}_{k}": v for k, v in dense_lqr_reference(solver).items()})
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: humanoid num_iters {arrays['humanoid_num_iters'].tolist()}, "
          f"LQR ProxDDP {arrays['proxddp_num_iters'].tolist()}, FDDP "
          f"{arrays['fddp_num_iters'].tolist()}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tests/data/torch_medium_ref.npz")
