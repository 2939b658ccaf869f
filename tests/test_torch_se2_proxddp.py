"""The port's SE(2)-car ProxDDP slice against the JAX package, float64 on
the CPU: the Lie group, the problem's derivatives, and the whole batched
solve at the bench.py configuration.

The JAX package's batched solves (``jax_solve_refs``, whose compiles took
most of this file's time) are ``tests/data/torch_se2_ref.npz``, written by
``tools/torch_jax_refs_fixture.py --only se2``; the ``slow`` test reruns
them live."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligator_tpu import solvers as jsolvers
from aligator_tpu._pytree import replace
from aligator_tpu.core import problem as jproblem
from aligator_tpu.modelling import SE2 as JSE2
from aligator_tpu.modelling.spaces.se2 import SO2 as JSO2
from examples.se2_car import create_se2_problem as jax_se2_problem

import aligator_tpu_torch as at
from aligator_tpu_torch import convert
from aligator_tpu_torch.core import problem as tproblem
from aligator_tpu_torch.examples.se2_car import create_se2_problem
from aligator_tpu_torch.modelling import SE2, SO2

torch.set_num_threads(2)
REFS = pathlib.Path(__file__).resolve().parent / "data" / "torch_se2_ref.npz"
RESULT_FIELDS = ("num_iters", "al_iter", "conv", "xs", "us", "vs", "lams", "prim_infeas",
                 "dual_infeas", "traj_cost")

BENCH_CFG = dict(
    tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4, rollout="linear",
    ls_max_steps=6, ls_strategy="filter",
)


def _points(rng, n, zero_omega=False):
    th = rng.uniform(-np.pi, np.pi, n)
    x = np.stack([rng.standard_normal(n), rng.standard_normal(n),
                  np.cos(th), np.sin(th)], -1)
    v = rng.standard_normal((n, 3))
    if zero_omega:
        v[:, 2] = 0.0
    return x, v


@pytest.mark.parametrize("zero_omega", [False, True])
def test_se2_maps_and_jacobians_match_jax(zero_omega):
    rng = np.random.default_rng(0)
    x0, v = _points(rng, 6, zero_omega)
    # for ω = 0 in difference, x1 shares x0's heading
    x1 = np.asarray(jax.vmap(JSE2().integrate)(jnp.asarray(x0), jnp.asarray(v)))
    js, ts = JSE2(), SE2()
    tx0, tv, tx1 = (torch.tensor(a) for a in (x0, v, x1))

    np.testing.assert_allclose(ts.integrate(tx0, tv).numpy(), x1, atol=1e-14)
    jd = np.asarray(jax.vmap(js.difference)(jnp.asarray(x0), jnp.asarray(x1)))
    np.testing.assert_allclose(ts.difference(tx0, tx1).numpy(), jd, atol=1e-12)
    if zero_omega:
        assert np.all(np.abs(ts.difference(tx0, tx1).numpy()[:, 2]) < 1e-12)
    for arg in (0, 1):
        ji = jax.jit(jax.vmap(lambda a, b: js.jintegrate(a, b, arg)))(x0, v)
        np.testing.assert_allclose(ts.jintegrate(tx0, tv, arg).numpy(),
                                   np.asarray(ji), atol=1e-12)
        jdd = jax.jit(jax.vmap(lambda a, b: js.jdifference(a, b, arg)))(x0, x1)
        got = ts.jdifference(tx0, tx1, arg).numpy()
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, np.asarray(jdd), atol=1e-10)


def test_so2_matches_jax():
    rng = np.random.default_rng(5)
    th = rng.uniform(-np.pi, np.pi, 5)
    x0 = np.stack([np.cos(th), np.sin(th)], -1)
    v = rng.standard_normal((5, 1))
    js, ts = JSO2(), SO2()
    x1 = np.asarray(jax.vmap(js.integrate)(jnp.asarray(x0), jnp.asarray(v)))
    tx0, tv, tx1 = (torch.tensor(a) for a in (x0, v, x1))
    np.testing.assert_allclose(ts.integrate(tx0, tv).numpy(), x1, atol=1e-14)
    np.testing.assert_allclose(
        ts.difference(tx0, tx1).numpy(),
        np.asarray(jax.vmap(js.difference)(jnp.asarray(x0), jnp.asarray(x1))),
        atol=1e-12,
    )
    for arg in (0, 1):
        jdd = jax.jit(jax.vmap(lambda a, b: js.jdifference(a, b, arg)))(x0, x1)
        np.testing.assert_allclose(ts.jdifference(tx0, tx1, arg).numpy(),
                                   np.asarray(jdd), atol=1e-12)


def _se2_params(jprob, x0s):
    st = jprob.stages
    return dict(
        x0=x0s, w_x=np.asarray(st.cost.costs[0].weights[0]),
        w_u=np.asarray(st.cost.costs[1].weights[0]),
        w_term=np.asarray(jprob.term_cost.weights),
        target=np.asarray(jprob.term_cost.residual.target),
        timestep=np.asarray(st.dynamics.timestep[0]),
    )


def _bench_x0s(B, seed=0):
    rng = np.random.default_rng(seed)
    d_p = 0.2 * rng.standard_normal((B, 2))
    th = 0.15355 + 0.2 * rng.standard_normal(B)
    return np.stack([0.7 + d_p[:, 0], -0.1 + d_p[:, 1], np.cos(th), np.sin(th)], -1)


def test_compute_derivatives_match_jax():
    N, B = 6, 2
    jprob = jax_se2_problem(nsteps=N, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    x0s = _bench_x0s(B, seed=2)
    xs = np.stack([_points(rng, N + 1)[0] for _ in range(B)])
    us = rng.standard_normal((B, N, 2))
    tprob = convert.se2_problem_from_numpy(_se2_params(jprob, x0s), nsteps=N,
                                           device="cpu")
    got = tproblem.compute_derivatives(tprob, torch.tensor(xs), torch.tensor(us))
    ref = jax.jit(jax.vmap(lambda x0, x, u: jproblem.compute_derivatives(
        replace(jprob, x0=x0), x, u
    )))(jnp.asarray(x0s), jnp.asarray(xs), jnp.asarray(us))
    for f in dataclasses.fields(tproblem.ProblemData):
        np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                   np.asarray(getattr(ref, f.name)), atol=1e-10,
                                   err_msg=f.name)


# the two solves: (scenarios, horizon, x0 seed, u_bound, options)
SOLVES = {
    "bench": (8, 50, 0, None, BENCH_CFG),
    "backtracking": (4, 20, 3, 0.05, dict(BENCH_CFG, ls_strategy="nonmonotone",
                                          multiplier_update_mode="primal_dual",
                                          max_iters=8)),
}


def jax_solve_refs(name):
    """``jax.vmap(solvers.solve)`` of the JAX package on the solve ``name``
    of SOLVES, jitted; numpy results and the problems' parameters."""
    B, N, seed, u_bound, opts = SOLVES[name]
    jprob = jax_se2_problem(nsteps=N, dtype=jnp.float64, u_bound=u_bound)
    x0s = _bench_x0s(B, seed)
    jcfg = jsolvers.ProxDDPConfig(**opts)
    ref = jax.jit(jax.vmap(
        lambda x0: jsolvers.solve(replace(jprob, x0=x0), jcfg)
    ))(jnp.asarray(x0s))
    out = {f"param_{k}": v for k, v in _se2_params(jprob, x0s).items()}
    out.update({k: getattr(ref, k) for k in RESULT_FIELDS})
    return {k: np.asarray(v) for k, v in out.items()}


def _refs(name):
    with np.load(REFS) as f:
        return {k[len(name) + 1:]: f[k] for k in f.files if k.startswith(name + "_")}


def _solve_fixture(name):
    """The fixture's JAX results of the solve ``name`` and the port's solve
    of the same problems."""
    B, N, seed, u_bound, opts = SOLVES[name]
    ref = _refs(name)
    assert np.array_equal(ref["param_x0"], _bench_x0s(B, seed))
    params = {k[len("param_"):]: v for k, v in ref.items() if k.startswith("param_")}
    kw = {} if u_bound is None else dict(u_bound=u_bound)
    tprob = convert.se2_problem_from_numpy(params, nsteps=N, device="cpu", **kw)
    return ref, at.solvers.solve(tprob, at.solvers.ProxDDPConfig(**opts))


def test_batched_proxddp_matches_jax_vmap():
    """The whole slice: 8 scenarios through the port's batched solve and
    jax.vmap(solvers.solve) at the bench.py configuration, float64."""
    ref, got = _solve_fixture("bench")
    np.testing.assert_array_equal(got.num_iters.numpy(), ref["num_iters"])
    np.testing.assert_array_equal(got.al_iter.numpy(), ref["al_iter"])
    np.testing.assert_array_equal(got.conv.numpy(), ref["conv"])
    assert got.conv.all()
    for name in ("xs", "us", "lams"):
        np.testing.assert_allclose(getattr(got, name).numpy(), ref[name], atol=1e-8,
                                   err_msg=name)
    for name in ("prim_infeas", "dual_infeas", "traj_cost"):
        np.testing.assert_allclose(getattr(got, name).numpy(), ref[name], atol=1e-10,
                                   err_msg=name)


def test_batched_proxddp_backtracking_bounds_matches_jax():
    """Nonmonotone line search with cubic interpolation, primal-dual
    multiplier updates and control bounds (nc = 2), float64."""
    ref, got = _solve_fixture("backtracking")
    np.testing.assert_array_equal(got.num_iters.numpy(), ref["num_iters"])
    np.testing.assert_array_equal(got.al_iter.numpy(), ref["al_iter"])
    np.testing.assert_array_equal(got.conv.numpy(), ref["conv"])
    assert (got.vs.numpy() != 0.0).any()  # some bounds are active
    for name in ("xs", "us", "vs", "lams"):
        np.testing.assert_allclose(getattr(got, name).numpy(), ref[name], atol=1e-8,
                                   err_msg=name)


JAX_REFS = {name: (jax_solve_refs, (name,)) for name in SOLVES}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SOLVES))
def test_fixture_matches_live_jax_refs(name):
    """The fixture's JAX solves run again, live."""
    live, ref = jax_solve_refs(name), _refs(name)
    assert sorted(live) == sorted(ref)
    for k, v in live.items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-12, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("option", [
    dict(rollout="nonlinear"), dict(verbose=True),
    dict(hessian_approx="exact"), dict(record_history=True),
])
def test_unported_options_raise(option, capsys):
    """These options raised NotImplementedError until the port carried
    them; each now runs on the SE(2) car and reaches the optimum of the
    default solve, and an unknown value of an option still raises."""
    prob = create_se2_problem(nsteps=3, dtype=torch.float64, device="cpu")
    got = at.solvers.solve(prob, at.solvers.ProxDDPConfig(**option))
    ref = at.solvers.solve(prob, at.solvers.ProxDDPConfig())
    assert got.conv.all() and ref.conv.all()
    np.testing.assert_allclose(got.xs.numpy(), ref.xs.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.us.numpy(), ref.us.numpy(), atol=1e-5)
    if option.get("record_history"):
        assert got.history.shape == (1, 100, 8)
        n = int(got.num_iters[0])
        assert (got.history[0, :n, 5] > 0).all() and (got.history[0, n:] == 0).all()
    if option.get("verbose"):
        rows = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.strip()[:1].isdigit()]
        assert len(rows) == int(got.num_iters[0])
    name, value = next(iter(option.items()))
    if isinstance(value, str):
        with pytest.raises(ValueError):
            at.solvers.solve(prob, at.solvers.ProxDDPConfig(**{name: "unknown"}))
