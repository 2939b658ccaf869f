#!/usr/bin/env python
"""Write the parallel-in-time reference fixture of the PyTorch port's tests.

Solves the double-integrator LQR of ``examples/lqr.py`` (N = 24) with the
JAX package's ProxDDP, ``jax.jit(jax.vmap(...))`` over 4 initial states
``(1, 0) + 0.1·N(0, 1)`` (numpy, seed 11), on each LQ route of ``CASES``:

* ``lqr`` and ``box`` (float64, without and with the bound ``|u| <=
  1``, which is active on some stages): ``linear_solver`` ``'serial_scan'``, ``'associative'`` and
  ``'parallel'`` (4 legs over T = 25 knots: two leg groups);
* ``below`` (float32, ``mu_init`` 1e-4 under the float32 μ floor) and
  ``cross`` (float32, ``|u| <= 0.05``, BCL failures driving μ from 1e-2 to
  1e-4 across ``associative_mu_floor`` = 1e-6 on ``mu_dyn``):
  ``'serial_scan'`` and ``'associative'``.

It also holds ``associative.solve`` (no refinement) of 2 random LQ
problems (``gar.random_problem``, ``PRNGKey(5)``, N = 16, (4, 2, 1)) at
μ = 1e-2, 1e-4 and 1e-6, with the serial factors at each μ
(``riccati.backward``): run in a test process, that solve took down the
worker now and then (ROADMAP.md, Queue 3).

``tests/test_torch_parallel.py`` holds the port's solves against the
archive, and its ``slow`` test reruns these solves live.

XLA's CPU runtime now and then returns a wrong associative scan, or
corrupts its heap, in the JAX package's ``associative.solve`` with
``return_gains=True``, which ProxDDP's ``'associative'`` route calls
(ROADMAP.md, Queue 3): each solve is repeated until two runs agree bit for
bit, and a run that dies is run again.

Run from the repository root (about two minutes on a CPU, most of it XLA
compilation)::

    python tools/torch_parallel_fixture.py [tests/data/torch_parallel_ref.npz]
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

from aligator_tpu import gar, solvers  # noqa: E402
from aligator_tpu._pytree import replace  # noqa: E402
from aligator_tpu.gar import associative, riccati  # noqa: E402
from examples.lqr import make_lqr_problem  # noqa: E402

NSTEPS, BATCH, LEGS = 24, 4, 4
# case: (dtype name, u_bound, ProxDDP options, routes)
CASES = {
    "lqr": ("float64", None, dict(tol=1e-8, mu_init=1e-3, max_iters=10),
            ("serial_scan", "associative", "parallel")),
    "box": ("float64", 1.0, dict(tol=1e-6, mu_init=1e-2, max_iters=20),
            ("serial_scan", "associative", "parallel")),
    "below": ("float32", None, dict(tol=1e-5, mu_init=1e-4, max_iters=10),
              ("serial_scan", "associative")),
    "cross": ("float32", 0.05, dict(tol=3e-4, mu_init=1e-2, mu_update_factor=1e-2,
                                    prim_tol0=1e-4, max_iters=40,
                                    associative_mu_floor=1e-6),
              ("serial_scan", "associative")),
}
FIELDS = ("num_iters", "conv", "al_iter", "xs", "us", "vs", "lams", "K", "kff",
          "mu_final")
ASSOC_MUS = (1e-2, 1e-4, 1e-6)
KNOT_FIELDS = ("Q", "S", "R", "q", "r", "A", "B", "E", "f", "C", "D", "d")
SOLUTION = ("xs", "us", "vs", "lams")
FACTORS = ("kff", "K", "zff", "Z", "lff", "L", "yff", "Afb", "Pmat", "pvec")


def settled(fn, *args):
    """``fn(*args)`` as numpy arrays, the result two runs agree on bit for
    bit: XLA's CPU runtime now and then returns a wrong associative scan, a
    different one each run (ROADMAP.md, Queue 3)."""
    seen = []
    for _ in range(8):
        out = [np.asarray(a) for a in jax.tree.leaves(fn(*args))]
        if any(all(np.array_equal(a, b) for a, b in zip(out, prev)) for prev in seen):
            return jax.tree.unflatten(jax.tree.structure(jax.eval_shape(fn, *args)), out)
        seen.append(out)
    raise RuntimeError("eight runs of the JAX solve all differ")


def x0s():
    rng = np.random.default_rng(11)
    return np.array([1.0, 0.0]) + 0.1 * rng.standard_normal((BATCH, 2))


def reference(case, route):
    """``{<FIELDS>}`` of the JAX solve of ``case`` on ``route``."""
    dtype, u_bound, opts, _ = CASES[case]
    dt = jnp.dtype(dtype)
    prob = make_lqr_problem(nsteps=NSTEPS, dtype=dt, u_bound=u_bound)
    cfg = solvers.ProxDDPConfig(**opts, rollout="linear", linear_solver=route,
                                parallel_legs=LEGS)
    def one(x0):
        res = solvers.solve(replace(prob, x0=x0), cfg)
        return {k: getattr(res, k) for k in FIELDS}

    return settled(jax.jit(jax.vmap(one)), jnp.asarray(x0s(), dt))


def assoc_reference():
    """The associative solves' problems (``<KNOT_FIELDS>``, ``G0``, ``g0``)
    and, for each μ of ``ASSOC_MUS`` (as ``mu<i>_<name>``), the solution
    ``<SOLUTION>`` and the serial factors ``<FACTORS>``."""
    probs = jax.jit(jax.vmap(lambda k: gar.random_problem(k, 16, 4, 2, 1, dtype=jnp.float64)))(
        jax.random.split(jax.random.PRNGKey(5), 2))
    out = {k: np.asarray(getattr(probs.knots, k)) for k in KNOT_FIELDS}
    out.update(G0=np.asarray(probs.G0), g0=np.asarray(probs.g0))
    fn = jax.jit(jax.vmap(lambda p, mu: (
        dict(zip(SOLUTION, associative.solve(p, mu, mu))),
        {k: getattr(riccati.backward(p, mu, mu, assume_explicit=True), k) for k in FACTORS}),
        in_axes=(0, None)))
    for i, mu in enumerate(ASSOC_MUS):
        sol, facs = settled(fn, probs, mu)
        out.update({f"mu{i}_{k}": v for k, v in {**sol, **facs}.items()})
    return out


def main(path):
    arrays = {"x0s": x0s()}
    arrays.update({f"assoc_{k}": v for k, v in assoc_reference().items()})
    for case, (*_, routes) in CASES.items():
        for route in routes:
            ref = reference(case, route)
            arrays.update({f"{case}_{route}_{k}": v for k, v in ref.items()})
            print(f"{case} {route}: num_iters {ref['num_iters'].tolist()}, conv "
                  f"{ref['conv'].tolist()}, mu_final {ref['mu_final'].tolist()}")
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tests/data/torch_parallel_ref.npz")
