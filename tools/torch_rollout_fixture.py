#!/usr/bin/env python
"""Write the reference fixture of the port's rollout, diff and sensitivity
tests.

Every solve is the JAX package's, float64, ``jax.jit(jax.vmap(...))`` over a
small batch:

* ``cartpole_<case>``: ProxDDP on the cartpole of ``examples/cartpole.py`` at
  N = 20 from 4 initial states 0.1·N(0, 1) (numpy, seed 0) with
  ``rollout='nonlinear'``: ``rk2`` (the published options, to convergence,
  with ``record_history`` and ``record_history_trajs``), ``midpoint`` (the
  dynamics replaced by ``IntegratorMidpoint``, general E; 3 iterations),
  ``midpoint_conv`` (the same with two Newton steps a stage in the
  rollout, ``rollout_max_iters=2``, to convergence: with one, no scenario
  converges within the 300 iterations) and ``exact``
  (``hessian_approx='exact'``; 10 iterations);
* ``partial``: ``examples/partial_initial_condition.py`` (N = 100, x0[1]
  pinned) from 2 desired initial states;
* ``fddp``: FDDP on ``examples/linear_euler.py`` (N = 20) from 2 initial
  states, with its history and iterates;
* ``sens_<case>``: ``solvers.solve_with_sensitivities`` on the θ family of
  ``tests/test_sensitivity.py`` at 4 values of θ (numpy, seed 13),
  ``free`` (tol 1e-11, μ₀ 1e-4) and ``box`` (|u| <= 0.12; tol 1e-8, μ₀
  1e-2, 300 iterations);
* ``diff_<case>_<field>``: ``jax.grad`` through ``gar.diff.solve`` of the
  loss ``Σu² + Σx_N² + Σv² + Σλ³`` wrt every knot field, ``G0`` and ``g0``
  (μ = 1e-3): ``explicit`` on ``gar.random_problem(PRNGKey(2), 8, 3, 2,
  1)`` as in ``tests/gar/test_diff.py``, ``general_E`` on the port's
  ``random_convex_problem`` (numpy seed 3, N = 6, (3, 2, 1), E = −I + 0.1
  N(0, 1)) with ``assume_explicit=False``; ``diffin_<case>_<field>``
  holds the problem itself;
* ``inverse_lqr_*``: the loss of ``examples/inverse_lqr.py`` and its
  gradient at the starting weights (N = 10, 4 demonstrations from numpy
  seed 5), and the expert's trajectories.

``tests/test_torch_rollout.py`` and ``tests/test_torch_diff.py`` hold the
port against the archive; a ``slow`` test reruns these solves live.

Run from the repository root (about a minute on a CPU, most of it XLA
compilation)::

    python tools/torch_rollout_fixture.py [tests/data/torch_rollout_ref.npz]
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

from aligator_tpu import core, gar, solvers  # noqa: E402
from aligator_tpu.gar import diff  # noqa: E402
from aligator_tpu._pytree import replace  # noqa: E402
from aligator_tpu.modelling import IntegratorMidpoint  # noqa: E402
from examples import inverse_lqr  # noqa: E402
from examples.cartpole import create_cartpole_problem  # noqa: E402
from examples.linear_euler import create_linear_euler_problem  # noqa: E402
from examples.partial_initial_condition import make_problem as make_partial  # noqa: E402
from test_sensitivity import problem_of_theta_factory  # noqa: E402

CART_N = 20
CART_OPTIONS = dict(tol=1e-5, mu_init=0.01, max_iters=300, rollout="nonlinear")
CART_CASES = {
    "rk2": dict(record_history=True, record_history_trajs=True),
    "midpoint": dict(max_iters=3),
    "midpoint_conv": dict(rollout_max_iters=2),
    "exact": dict(hessian_approx="exact", max_iters=10),
}
PARTIAL_N = 100
PARTIAL_OPTIONS = dict(tol=1e-6, mu_init=1e-2, max_iters=40, max_al_iters=10,
                       force_initial_condition=False)
PARTIAL_X0S = np.array([[0.0, 0.1], [0.3, -0.2]])
FDDP_N = 20
FDDP_OPTIONS = dict(tol=1e-8, record_history=True, record_history_trajs=True)
FDDP_X0S = np.array([[1.0, -0.5], [-0.4, 0.8]])
SENS_CASES = {
    "free": (None, dict(tol=1e-11, mu_init=1e-4, max_iters=40)),
    "box": (0.12, dict(tol=1e-8, mu_init=1e-2, max_iters=300)),
}
DIFF_MU = 1e-3
INV_N = 10
RESULT_FIELDS = ("xs", "us", "vs", "lams", "conv", "num_iters", "al_iter",
                 "prim_infeas", "dual_infeas", "traj_cost")
HISTORY_FIELDS = ("history", "history_xs", "history_us", "history_vs",
                  "history_lams")


def cart_x0s():
    return 0.1 * np.random.default_rng(0).standard_normal((4, 4))


def thetas():
    rng = np.random.default_rng(13)
    return np.stack([0.5 * rng.standard_normal(4), 0.3 * rng.standard_normal(4)], -1)


def _arrays(res, names):
    return {k: np.asarray(getattr(res, k)) for k in names
            if getattr(res, k, None) is not None}


def cartpole_problem(case):
    prob = create_cartpole_problem(nsteps=CART_N)
    if case.startswith("midpoint"):
        d = prob.stages.dynamics
        prob = replace(prob, stages=replace(
            prob.stages, dynamics=IntegratorMidpoint(ode=d.ode, timestep=d.timestep)))
    return prob


def cartpole_reference(case):
    prob = cartpole_problem(case)
    cfg = solvers.ProxDDPConfig(**{**CART_OPTIONS, **CART_CASES[case]})
    res = jax.jit(jax.vmap(lambda x0: solvers.solve(replace(prob, x0=x0), cfg)))(
        jnp.asarray(cart_x0s()))
    return _arrays(res, RESULT_FIELDS + HISTORY_FIELDS)


def partial_reference():
    prob = make_partial(nsteps=PARTIAL_N)
    cfg = solvers.ProxDDPConfig(**PARTIAL_OPTIONS)

    def one(x0):
        init = replace(prob.init_constraint,
                       func=core.StateErrorResidual(target=x0))
        return solvers.solve(replace(prob, x0=x0, init_constraint=init), cfg)

    res = jax.jit(jax.vmap(one))(jnp.asarray(PARTIAL_X0S))
    return _arrays(res, RESULT_FIELDS)


def fddp_reference():
    prob = create_linear_euler_problem(nsteps=FDDP_N)
    cfg = solvers.FDDPConfig(**FDDP_OPTIONS)
    res = jax.jit(jax.vmap(lambda x0: solvers.fddp.solve(replace(prob, x0=x0), cfg)))(
        jnp.asarray(FDDP_X0S))
    return _arrays(res, ("xs", "us", "conv", "num_iters", "prim_infeas",
                         "dual_infeas", "traj_cost", "history", "history_xs",
                         "history_us"))


def sensitivity_reference(case):
    u_bound, opts = SENS_CASES[case]
    pf = problem_of_theta_factory(u_bound=u_bound)
    cfg = solvers.ProxDDPConfig(**opts)
    res = jax.jit(jax.vmap(lambda th: solvers.solve_with_sensitivities(pf, th, cfg)))(
        jnp.asarray(thetas()))
    return _arrays(res, ("xs", "us", "conv", "num_iters", "traj_cost", "th_grad",
                         "th_hess", "mu_final"))


def diff_problems():
    """The two LQ problems of the gradient checks, as the JAX package's."""
    from aligator_tpu_torch.gar.lqr_problem import random_convex_problem

    tp = random_convex_problem(np.random.default_rng(3), 1, 6, 3, 2, 1,
                               general_E=True, device="cpu")
    general = gar.LQRProblem(
        knots=gar.LQRKnots(**{k: jnp.asarray(getattr(tp.knots, k)[0].numpy())
                              for k in diff_fields()[:-2]}),
        G0=jnp.asarray(tp.G0[0].numpy()), g0=jnp.asarray(tp.g0[0].numpy()))
    explicit = gar.random_problem(jax.random.PRNGKey(2), 8, 3, 2, 1, dtype=jnp.float64)
    return {"explicit": (explicit, True), "general_E": (general, False)}


def diff_fields():
    return ("Q", "S", "R", "q", "r", "A", "B", "E", "f", "C", "D", "d", "G0", "g0")


def diff_loss(sol):
    xs, us, vs, lams = sol
    return jnp.sum(us ** 2) + jnp.sum(xs[-1] ** 2) + jnp.sum(vs ** 2) + jnp.sum(lams ** 3)


def diff_reference(case):
    prob, explicit = diff_problems()[case]
    g = jax.jit(jax.grad(lambda p: diff_loss(diff.solve(p, DIFF_MU, DIFF_MU, explicit))))(prob)
    return {k: np.asarray(getattr(g, k) if k in ("G0", "g0") else getattr(g.knots, k))
            for k in diff_fields()}


def inverse_lqr_x0s():
    return np.random.default_rng(5).standard_normal((4, 4))


def inverse_lqr_reference():
    x0s = jnp.asarray(inverse_lqr_x0s())
    tmpl = inverse_lqr.make_problem_template(N=INV_N)
    q_true = jnp.log(jnp.asarray([3.0, 0.5, 0.1, 2.0]))
    r_true = jnp.log(jnp.asarray([0.3, 1.5]))
    xs_e, us_e = jax.vmap(lambda x0: inverse_lqr.solve_traj(tmpl, q_true, r_true, x0))(x0s)

    def loss(params):
        xs, us = jax.vmap(lambda x0: inverse_lqr.solve_traj(tmpl, params["q"], params["r"], x0))(x0s)
        return jnp.mean((xs - xs_e) ** 2) + jnp.mean((us - us_e) ** 2)

    val, g = jax.jit(jax.value_and_grad(loss))({"q": jnp.zeros(4), "r": jnp.zeros(2)})
    return dict(loss=np.asarray(val), grad_q=np.asarray(g["q"]), grad_r=np.asarray(g["r"]),
                xs_e=np.asarray(xs_e), us_e=np.asarray(us_e))


def references():
    out = {}
    for case in CART_CASES:
        out.update({f"cartpole_{case}_{k}": v for k, v in cartpole_reference(case).items()})
    out.update({f"partial_{k}": v for k, v in partial_reference().items()})
    out.update({f"fddp_{k}": v for k, v in fddp_reference().items()})
    for case in SENS_CASES:
        out.update({f"sens_{case}_{k}": v for k, v in sensitivity_reference(case).items()})
    for case, (prob, _) in diff_problems().items():
        out.update({f"diff_{case}_{k}": v for k, v in diff_reference(case).items()})
        out.update({f"diffin_{case}_{k}": np.asarray(
            getattr(prob, k) if k in ("G0", "g0") else getattr(prob.knots, k))
            for k in diff_fields()})
    out.update({f"inverse_lqr_{k}": v for k, v in inverse_lqr_reference().items()})
    return out


def main(path=os.path.join(ROOT, "tests", "data", "torch_rollout_ref.npz")):
    np.savez_compressed(path, cart_x0s=cart_x0s(), thetas=thetas(),
                        inverse_lqr_x0s=inverse_lqr_x0s(), **references())
    print("wrote", path)


if __name__ == "__main__":
    main(*sys.argv[1:])
