#!/usr/bin/env python
"""Write the JAX references of the port's utility and gar-example tests:
``tests/data/torch_utils_ref.npz``.

Float64 on the CPU, the JAX package's functions on the inputs the tests
give the port:

* ``inst_<name>_*``: the NumPy oracle's solve (``aligator_tpu.oracle``) of
  each archive ``tests/data/ref_{lqr,lqr_bounded,lqr_term_cstr,se2_car}.npz``
  loaded by the JAX package, at the options of ``tests/test_interchange.py``;
* ``nlp_*``: ``utils.nlp.to_nlp`` of the box LQR (N = 10, |u| <= 0.2) at
  a random z (numpy seed 0): the objective, its gradient, the constraints
  and their Jacobians;
* ``lqr_*``, ``join_*``, ``cyc_*``: the problems of ``examples/gar_lqr.py``
  (``random_problem(PRNGKey(0), 23, 4, 2, 1)``), ``gar_lqr_join.py``
  (``PRNGKey(42)``, T = 10, (2, 1, 0)) and ``gar_cyclic_lqr.py`` (T = 30)
  as knot arrays, and their outputs: the serial and 4-leg parallel solves
  and the θ sensitivities with Gx = 0.1 (nth = 3), ``split_and_join`` at
  t0 = 5, μ = 1e-8 with the joint solve, ``solve_cyclic``.

``tests/test_torch_utils.py``'s ``slow`` test recomputes them live. Run
from the repository root (about a minute)::

    python tools/torch_utils_fixture.py [--out PATH]
"""

import argparse
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
from aligator_tpu.gar import parallel  # noqa: E402
from aligator_tpu.oracle import NumpyProxDDP  # noqa: E402
from aligator_tpu.utils import interchange, nlp  # noqa: E402

KNOTS = ("Q", "S", "R", "q", "r", "A", "B", "E", "f", "C", "D", "d")
# (archive, mu_init, tol, max_iters): tests/test_interchange.py's options
INSTANCES = (("ref_lqr", 1e-4, 1e-8, 20), ("ref_lqr_bounded", 1e-1, 1e-8, 20),
             ("ref_lqr_term_cstr", 1e-4, 1e-8, 20), ("ref_se2_car", 1e-2, 1e-6, 12))
LQR_MU = (1e-4, 1e-5)
LQR_LEGS, LQR_NTH = 4, 3
JOIN_T0, JOIN_MU = 5, 1e-8


def problem_arrays(prefix, problem):
    out = {f"{prefix}_{k}": np.asarray(getattr(problem.knots, k)) for k in KNOTS}
    out[f"{prefix}_G0"], out[f"{prefix}_g0"] = np.asarray(problem.G0), np.asarray(problem.g0)
    return out


def instance_refs():
    out = {}
    for name, mu0, tol, iters in INSTANCES:
        prob = interchange.load_problem(os.path.join(ROOT, "tests", "data", f"{name}.npz"))
        r = NumpyProxDDP(prob, solvers.ProxDDPConfig(tol=tol, mu_init=mu0,
                                                     max_iters=iters)).solve()
        out.update({f"inst_{name}_xs": np.asarray(r.xs), f"inst_{name}_us": np.asarray(r.us),
                    f"inst_{name}_conv": np.asarray(bool(r.conv))})
    return out


def nlp_refs():
    from examples.lqr import make_lqr_problem

    prob = make_lqr_problem(nsteps=10, u_bound=0.2)
    fns = nlp.to_nlp(prob, jnp.broadcast_to(prob.x0, (11, 2)), jnp.zeros((10, 1)))
    z = np.random.default_rng(0).standard_normal(fns["nz"])
    out = {"nlp_z": z}
    for k in ("objective", "grad", "cons_eq", "jac_eq", "cons_ineq", "jac_ineq"):
        out[f"nlp_{k}"] = np.asarray(fns[k](jnp.asarray(z)))
    return out


def gar_refs():
    from examples import gar_cyclic_lqr, gar_lqr_join

    out = {}
    p = gar.random_problem(jax.random.PRNGKey(0), 23, 4, 2, 1, dtype=jnp.float64)
    kn = gar.add_parameterization(p.knots, LQR_NTH)
    p_th = replace(p, knots=replace(kn, Gx=0.1 * jnp.ones_like(kn.Gx)))

    @jax.jit
    def lqr(p, p_th):
        facs = gar.backward(p_th, *LQR_MU, assume_explicit=True)
        return (gar.solve(p, *LQR_MU, assume_explicit=True),
                parallel.solve(p, *LQR_MU, legs=LQR_LEGS, assume_explicit=True),
                facs.th_grad, facs.th_hess)

    serial, par, th_grad, th_hess = lqr(p, p_th)
    out.update(problem_arrays("lqr", p))
    out.update({f"lqr_serial_{i}": np.asarray(a) for i, a in enumerate(serial)})
    out.update({f"lqr_parallel_{i}": np.asarray(a) for i, a in enumerate(par)})
    out.update(lqr_th_grad=np.asarray(th_grad), lqr_th_hess=np.asarray(th_hess))

    p = gar.random_problem(jax.random.PRNGKey(42), 9, 2, 1, 0, dtype=jnp.float64)
    join, joint = jax.jit(lambda p: (gar_lqr_join.split_and_join(p, JOIN_T0, JOIN_MU),
                                     gar.solve(p, JOIN_MU, JOIN_MU, assume_explicit=True)))(p)
    out.update(problem_arrays("join", p))
    out.update({f"join_out_{i}": np.asarray(a) for i, a in enumerate(join)})
    out.update({f"join_joint_{i}": np.asarray(a) for i, a in enumerate(joint)})

    p = gar_cyclic_lqr.create_cyclic_problem(T=30)
    out.update(problem_arrays("cyc", p))
    out.update({f"cyc_out_{i}": np.asarray(a)
                for i, a in enumerate(jax.jit(gar_cyclic_lqr.solve_cyclic)(p))})
    return out


def references():
    return {**instance_refs(), **nlp_refs(), **gar_refs()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data", "torch_utils_ref.npz"))
    args = ap.parse_args()
    np.savez_compressed(args.out, **references())
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
