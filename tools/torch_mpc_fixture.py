#!/usr/bin/env python
"""Write the reference fixture of the port's MPC tests.

Every solve is the JAX package's, float64, one scenario at a time:

* ``lqr_<case>``: the warm-started cycles of
  ``tests/test_mpc.py::test_mpc_warm_start_converges_in_two_iters`` on the
  double integrator of ``tests/test_proxddp.py::make_lqr`` (N = 20;
  ``free`` and ``box``, |u| <= 0.3): the cold solve, then 6 cycles each
  applying the first control, shifting the warm start with
  ``utils.cycle_warm_start(..., problem=problem)`` (the tail rolled out, the
  terminal costate refreshed) and re-solving at ``mu_init`` 1e-8; per
  cycle the state, xs, us, iteration count and convergence flag;
* ``se2``: 6 cycles of the receding-horizon loop of ``bench_mpc.py`` (the
  SE(2) car at N = 50, linear rollout, tol 1e-4, ``ls_max_steps`` 6; cold
  10 iterations and 4 AL iterations, warm 2 and 2) in float64 from 4
  initial states of the port's ``examples.mpc_se2.se2_initial_states``
  (numpy, seed 3), the tail duplicated as ``bench_mpc.py`` does; per cycle
  the same records.

``tests/test_torch_mpc.py`` holds the port against the archive; its
``slow`` test reruns these solves live.

Run from the repository root (about a minute on a CPU)::

    python tools/torch_mpc_fixture.py [tests/data/torch_mpc_ref.npz]
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
sys.path.insert(0, os.path.join(ROOT, "tests"))

from aligator_tpu import solvers, utils  # noqa: E402
from aligator_tpu._pytree import replace  # noqa: E402
from aligator_tpu_torch.examples import mpc_se2  # noqa: E402
from examples.se2_car import create_se2_problem  # noqa: E402
from test_proxddp import make_lqr  # noqa: E402

N_CYCLES = 6
LQR_CASES = {"free": dict(u_bound=None, cold_iters=60), "box": dict(u_bound=0.3, cold_iters=80)}
LQR_WARM = dict(tol=1e-6, mu_init=1e-8, max_iters=60)
SE2_N, SE2_SCENARIOS, SE2_SEED = 50, 4, 3


def lqr_leaves(problem):
    st = problem.stages
    out = dict(A=st.dynamics.A[0], B=st.dynamics.B[0], c=st.dynamics.c[0], Q=st.cost.Q[0],
               R=st.cost.R[0], Q_term=problem.term_cost.Q, x0=problem.x0[None])
    if st.constraints:
        box = st.constraints[0][1]
        out.update(u_lower=box.lower[0], u_upper=box.upper[0])
    return {k: np.asarray(v) for k, v in out.items()}


def _records(rows, r, x):
    for k, v in (("x", x), ("xs", r.xs), ("us", r.us), ("num_iters", r.num_iters),
                 ("conv", r.conv)):
        rows.setdefault(k, []).append(np.asarray(v))


def lqr_reference(case):
    opts = LQR_CASES[case]
    problem = make_lqr(nsteps=20, u_bound=opts["u_bound"])
    space, stage0 = problem.space, problem.stage_at(0)
    cfg = solvers.ProxDDPConfig(**LQR_WARM)
    res = solvers.solve(problem, solvers.ProxDDPConfig(tol=1e-8, max_iters=opts["cold_iters"]))
    out = {f"cold_{k}": np.asarray(getattr(res, k))
           for k in ("xs", "us", "vs", "lams", "num_iters", "conv")}

    @jax.jit
    def cycle(x_cur, xs, us, vs, lams):
        x_next = stage0.dynamics.forward(space, x_cur, us[0])
        w = utils.cycle_warm_start(xs, us, vs, lams, problem=problem)
        r = solvers.solve(replace(problem, x0=x_next), cfg, xs_init=w[0], us_init=w[1],
                          vs_init=w[2], lams_init=w[3])
        return x_next, r

    rows = {}
    x = problem.x0
    for _ in range(N_CYCLES):
        x, res = cycle(x, res.xs, res.us, res.vs, res.lams)
        _records(rows, res, x)
    out.update({k: np.stack(v) for k, v in rows.items()})
    out.update({f"prob_{k}": v for k, v in lqr_leaves(problem).items()})
    return out


def se2_reference():
    problem = create_se2_problem(nsteps=SE2_N, dtype=jnp.float64)
    space, stage0 = problem.space, problem.stage_at(0)
    cold_cfg = solvers.ProxDDPConfig(**mpc_se2.COLD)
    warm_cfg = solvers.ProxDDPConfig(**mpc_se2.WARM)
    x0s = mpc_se2.se2_initial_states(SE2_SCENARIOS, SE2_SEED, device="cpu").double().numpy()
    cold = jax.jit(lambda x0: solvers.solve(replace(problem, x0=x0), cold_cfg))

    @jax.jit
    def cycle(x_cur, xs, us):
        x_next = stage0.dynamics.forward(space, x_cur, us[0])
        xs_w, us_w = utils.cycle_warm_start(xs, us)
        return x_next, solvers.solve(replace(problem, x0=x_next), warm_cfg, xs_init=xs_w,
                                     us_init=us_w)

    per = []
    for x0 in x0s:
        res = cold(jnp.asarray(x0))
        rows = {}
        _records(rows, res, x0)
        x = jnp.asarray(x0)
        for _ in range(N_CYCLES):
            x, res = cycle(x, res.xs, res.us)
            _records(rows, res, x)
        per.append({k: np.stack(v) for k, v in rows.items()})
    # (scenario, 1 + cycle, ...): row 0 the cold solve
    out = {k: np.stack([p[k] for p in per]) for k in per[0]}
    out["x0s"] = x0s
    return out


def main(path=os.path.join(ROOT, "tests", "data", "torch_mpc_ref.npz")):
    refs = {}
    for case in LQR_CASES:
        refs.update({f"lqr_{case}_{k}": v for k, v in lqr_reference(case).items()})
    refs.update({f"se2_{k}": v for k, v in se2_reference().items()})
    np.savez_compressed(path, **refs)
    print(f"wrote {path}")


if __name__ == "__main__":
    main(*sys.argv[1:])
