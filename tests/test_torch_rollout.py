"""The port's nonlinear rollout, implicit dynamics and the rest of ``core/``
against the JAX package, float64 on the CPU.

The costs, functions and integrators are held against the JAX package's
``vmap``ped functions on the same numpy inputs; the solves (ProxDDP with
``rollout='nonlinear'`` on the cartpole, with RK2, the implicit midpoint
rule and ``'exact'`` Hessians; a partial initial condition; FDDP's history)
against ``tests/data/torch_rollout_ref.npz``, written by
``tools/torch_rollout_fixture.py``, whose solves the ``slow`` test reruns
live. The kernels these paths launch on the card are checked there by
tests/test_torch_cuda.py.
"""

import dataclasses
import importlib.util
import io
import pathlib
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligator_tpu import core as jcore
from aligator_tpu._pytree import replace
from aligator_tpu.core import problem as jproblem
from aligator_tpu.core.costs import DirectSumCost as JDirectSumCost
from aligator_tpu.core.functions import LinearFunctionComposition as JComposition
from aligator_tpu.modelling import IntegratorEuler as JEuler
from aligator_tpu.modelling import IntegratorMidpoint as JMidpoint
from aligator_tpu.modelling import IntegratorRK2 as JRK2
from aligator_tpu.modelling import IntegratorRK4 as JRK4
from aligator_tpu.modelling import LinearODE as JLinearODE
from examples.cartpole import CartpoleODE as JCartpoleODE
from examples.cartpole import create_cartpole_problem as jax_cartpole
from examples.linear_euler import create_linear_euler_problem as jax_linear_euler
from examples.partial_initial_condition import make_problem as jax_partial

import aligator_tpu_torch as at
from aligator_tpu_torch import convert, core
from aligator_tpu_torch.core import problem as tproblem
from aligator_tpu_torch.examples.cartpole import CartpoleODE
from aligator_tpu_torch.modelling import (IntegratorEuler, IntegratorMidpoint,
                                          IntegratorRK2, IntegratorRK4, LinearODE,
                                          autodiff)

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_rollout_ref.npz"
SPACE = (jcore.VectorSpace(4), core.VectorSpace(4))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_rollout_fixture", ROOT / "tools" / "torch_rollout_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixture(prefix):
    with np.load(FIXTURE) as f:
        return {k[len(prefix):]: f[k] for k in f.files if k.startswith(prefix)}


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, ref, tol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol, err_msg=msg)


def _inputs(n=6, nx=4, nu=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, nx)), rng.standard_normal((n, nu))


# ------------------------------------------------------------ costs, functions


def _residual_pair(rng):
    target = rng.standard_normal(4)
    return (jcore.StateErrorResidual(target=jnp.asarray(target)),
            core.StateErrorResidual(target=_t(target)))


def _cost_pairs():
    rng = np.random.default_rng(1)
    jres, tres = _residual_pair(rng)
    w = rng.uniform(0.5, 2.0, 4)
    W = np.diag(rng.uniform(0.5, 2.0, 2))
    jsub, tsub = jcore.VectorSpace(2), core.VectorSpace(2)
    return {
        "constant": (jcore.ConstantCost(c=jnp.asarray(1.5)), core.ConstantCost(c=_t(1.5))),
        "log_residual": (
            jcore.LogResidualCost(residual=jres, weights=jnp.asarray(w), scale=jnp.asarray(0.7)),
            core.LogResidualCost(residual=tres, weights=_t(w), scale=_t(0.7))),
        "relaxed_log_barrier": (
            jcore.RelaxedLogBarrierCost(residual=jres, weights=jnp.asarray(w),
                                        threshold=jnp.asarray(0.3)),
            core.RelaxedLogBarrierCost(residual=tres, weights=_t(w), threshold=_t(0.3))),
        "direct_sum": (
            JDirectSumCost(cost=jcore.QuadraticCost.create(jnp.asarray(W), jnp.asarray(W)),
                                sub_space=jsub, x_slice=(1, 3), u_slice=(0, 2)),
            core.DirectSumCost(cost=core.QuadraticCost.create(_t(W), _t(W)),
                               sub_space=tsub, x_slice=(1, 3), u_slice=(0, 2))),
        "exact_residual": (
            jcore.QuadraticResidualCost(residual=jres, weights=jnp.eye(4), gauss_newton=False),
            core.QuadraticResidualCost(residual=tres, weights=torch.eye(4, dtype=torch.float64),
                                       gauss_newton=False)),
    }


@pytest.mark.parametrize("name", ["constant", "log_residual", "relaxed_log_barrier",
                                  "direct_sum", "exact_residual"])
def test_costs_match_jax(name):
    jc, tc = _cost_pairs()[name]
    x, u = _inputs()
    js, ts = SPACE
    ref = jax.jit(jax.vmap(lambda x, u: (jc.value(js, x, u), jc.gradients(js, x, u),
                                         jc.hessians(js, x, u))))(x, u)
    tx, tu = _t(x), _t(u)
    _close(tc.value(ts, tx, tu), ref[0], 1e-12, "value")
    for g, r in zip(tc.gradients(ts, tx, tu), ref[1]):
        _close(g, r, 1e-10, "gradients")
    for h, r in zip(tc.hessians(ts, tx, tu), ref[2]):
        _close(torch.broadcast_to(h, r.shape), r, 1e-10, "hessians")
    # the finite-difference helper agrees with the port's gradients
    for g, fd in zip(tc.gradients(ts, tx, tu), autodiff.fd_cost_gradients(tc, ts, tx, tu)):
        _close(torch.broadcast_to(g, fd.shape), fd, 1e-6, "fd")


def _function_pairs():
    rng = np.random.default_rng(2)
    jres, tres = _residual_pair(rng)
    A, B, c = rng.standard_normal((3, 4)), rng.standard_normal((3, 2)), rng.standard_normal(3)
    M, b = rng.standard_normal((2, 4)), rng.standard_normal(2)
    lo, hi = -rng.uniform(0.1, 1, 2), rng.uniform(0.1, 1, 2)
    return {
        "linear": (jcore.LinearFunction(A=jnp.asarray(A), B=jnp.asarray(B), c=jnp.asarray(c)),
                   core.LinearFunction(A=_t(A), B=_t(B), c=_t(c))),
        "control_box": (jcore.ControlBoxFunction(umin=jnp.asarray(lo), umax=jnp.asarray(hi)),
                        core.ControlBoxFunction(umin=_t(lo), umax=_t(hi))),
        "slice": (jcore.FunctionSlice(func=jres, indices=(3, 1)),
                  core.FunctionSlice(func=tres, indices=(3, 1))),
        "gated": (jcore.GatedFunction(func=jres, gate=jnp.asarray(0.4)),
                  core.GatedFunction(func=tres, gate=_t(0.4))),
        "composition": (JComposition(func=jres, A=jnp.asarray(M),
                                                        b=jnp.asarray(b)),
                        core.LinearFunctionComposition(func=tres, A=_t(M), b=_t(b))),
    }


@pytest.mark.parametrize("name", ["linear", "control_box", "slice", "gated", "composition"])
def test_functions_match_jax(name):
    jf, tf = _function_pairs()[name]
    x, u = _inputs(seed=3)
    js, ts = SPACE
    ref = jax.jit(jax.vmap(lambda x, u: (jf.value(js, x, u), jf.jacobians(js, x, u))))(x, u)
    tx, tu = _t(x), _t(u)
    val = tf.value(ts, tx, tu)
    assert val.shape[-1] == tf.dim(ts, 2)
    _close(val, ref[0], 1e-12, "value")
    Jx, Ju = tf.jacobians(ts, tx, tu)
    _close(torch.broadcast_to(Jx, ref[1][0].shape), ref[1][0], 1e-12, "Jx")
    _close(torch.broadcast_to(Ju, ref[1][1].shape), ref[1][1], 1e-12, "Ju")
    fdx, fdu = autodiff.fd_stage_function_jacobians(tf, ts, tx, tu)
    _close(torch.broadcast_to(Jx, fdx.shape), fdx, 1e-6, "fd Jx")
    _close(torch.broadcast_to(Ju, fdu.shape), fdu, 1e-6, "fd Ju")


def test_gated_function_stage_gate_matches_jax_stacked_stages():
    """A gate that varies over the stages, as JAX's stacked stage leaves hold
    it, against the JAX package's per-stage ``vmap``."""
    rng = np.random.default_rng(4)
    jres, tres = _residual_pair(rng)
    gates = np.array([1.0, 0.0, 0.5])
    x = rng.standard_normal((2, 3, 4))
    u = rng.standard_normal((2, 3, 2))
    js, ts = SPACE

    def one(g, x, u):
        f = jcore.GatedFunction(func=jres, gate=g)
        return f.value(js, x, u), f.jacobians(js, x, u)[0]

    ref = jax.vmap(jax.vmap(one), in_axes=(None, 0, 0))(jnp.asarray(gates), x, u)
    tf = core.GatedFunction(func=tres, gate=_t(gates))
    _close(tf.value(ts, _t(x), _t(u)), ref[0], 1e-12)
    _close(tf.jacobians(ts, _t(x), _t(u))[0], ref[1], 1e-12)


# ------------------------------------------------------------------ dynamics


def _cartpole_odes():
    params = dict(mc=1.0, mp=0.1, length=0.5, gravity=9.81)
    return (JCartpoleODE(**{k: jnp.asarray(v) for k, v in params.items()}),
            CartpoleODE(**{k: _t(v) for k, v in params.items()}))


def _linear_odes():
    rng = np.random.default_rng(5)
    A, B, c = rng.standard_normal((4, 4)), rng.standard_normal((4, 2)), rng.standard_normal(4)
    return (JLinearODE(A=jnp.asarray(A), B=jnp.asarray(B), c=jnp.asarray(c)),
            LinearODE(A=_t(A), B=_t(B), c=_t(c)))


INTEGRATORS = {"rk2": (JRK2, IntegratorRK2, _cartpole_odes),
               "rk4": (JRK4, IntegratorRK4, _cartpole_odes),
               "midpoint": (JMidpoint, IntegratorMidpoint, _cartpole_odes),
               "euler_linear_ode": (JEuler, IntegratorEuler, _linear_odes)}


@pytest.mark.parametrize("name", list(INTEGRATORS))
def test_integrators_match_jax(name):
    jcls, tcls, odes = INTEGRATORS[name]
    jode, tode = odes()
    jdyn = jcls(ode=jode, timestep=jnp.asarray(0.05))
    tdyn = tcls(ode=tode, timestep=_t(0.05))
    x, u = _inputs(n=5, nu=2 if name == "euler_linear_ode" else 1, seed=6)
    js, ts = SPACE
    assert tdyn.is_explicit == jdyn.is_explicit
    ref = jax.jit(jax.vmap(lambda x, u: (
        jdyn.forward(js, x, u),
        jdyn.jacobians(js, x, u, jdyn.forward(js, x, u)))))(x, u)
    tx, tu = _t(x), _t(u)
    y = tdyn.forward(ts, tx, tu)
    _close(y, ref[0], 1e-12, "forward")
    for J, r, n in zip(tdyn.jacobians(ts, tx, tu, y), ref[1], "ABE"):
        _close(J, r, 1e-10, n)
    for J, fd, n in zip(tdyn.jacobians(ts, tx, tu, y),
                        autodiff.fd_dynamics_jacobians(tdyn, ts, tx, tu), "ABE"):
        _close(J, fd, 1e-6, f"fd {n}")


def test_forward_with_gap_matches_jax():
    """ImplicitDynamics.forward_with_gap: Newton steps seeded at x with a
    gap, at 1 and 3 steps, and the converged residual."""
    jode, tode = _cartpole_odes()
    jdyn = JMidpoint(ode=jode, timestep=jnp.asarray(0.05))
    tdyn = IntegratorMidpoint(ode=tode, timestep=_t(0.05))
    x, u = _inputs(n=5, nu=1, seed=8)
    gap = 0.01 * np.random.default_rng(9).standard_normal((5, 4))
    js, ts = SPACE
    for iters in (1, 3):
        ref = jax.jit(jax.vmap(lambda x, u, g: jdyn.forward_with_gap(js, x, u, g, iters)))(
            x, u, gap)
        got = tdyn.forward_with_gap(ts, _t(x), _t(u), _t(gap), iters)
        _close(got, ref, 1e-12, f"iters {iters}")
    y = tdyn.forward(ts, _t(x), _t(u))
    assert tdyn.residual(ts, _t(x), _t(u), y).abs().max() < 1e-12


# ---------------------------------------------------------- problems, solves


def _cartpole_params(jprob, x0s):
    st = jprob.stages
    ode = st.dynamics.ode
    return dict(
        x0=x0s, mc=np.asarray(ode.mc[0]), mp=np.asarray(ode.mp[0]),
        length=np.asarray(ode.length[0]), gravity=np.asarray(ode.gravity[0]),
        timestep=np.asarray(st.dynamics.timestep[0]),
        x_target=np.asarray(jprob.term_cost.residual.target),
        w_x=np.asarray(st.cost.costs[0].weights[0]),
        w_u=np.asarray(st.cost.costs[1].weights[0]),
        w_term=np.asarray(jprob.term_cost.weights),
    )


def _derivatives_match(jprob, tprob, x0s, seed, exact=False):
    N, nx, nu = tprob.nsteps, tprob.space.nx, tprob.nu
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((x0s.shape[0], N + 1, nx))
    us = rng.standard_normal((x0s.shape[0], N, nu))
    lams = rng.standard_normal((x0s.shape[0], N + 1, tprob.space.ndx)) if exact else None

    def one(x0, x, u, lam):
        p = replace(jprob, x0=x0)
        if jprob.init_constraint is not None:
            p = replace(p, init_constraint=replace(
                jprob.init_constraint, func=jcore.StateErrorResidual(target=x0)))
        return jproblem.compute_derivatives(p, x, u, lams=lam)

    ref = jax.jit(jax.vmap(one))(jnp.asarray(x0s), xs, us, lams)
    got = tproblem.compute_derivatives(tprob, _t(xs), _t(us))
    for f in dataclasses.fields(tproblem.ProblemData):
        _close(getattr(got, f.name), getattr(ref, f.name), 1e-10, f.name)
    if exact:
        vhp = tproblem.dynamics_vhp(tprob, _t(xs), _t(us), _t(lams[:, 1:]))
        for got, name in zip(vhp, ("Hxx", "Hxu", "Huu")):
            _close(got, getattr(ref, name), 1e-10, name)


def _partial_params(x0s):
    A = np.eye(2)
    A[0, 1] = 0.1
    return dict(A=A, B=np.eye(2), w_u=1e-3 * np.eye(2), w_term=np.eye(2), x0=x0s,
                pinned=(1,))


def test_convert_cartpole_round_trip():
    """The cartpole's leaves carried to the port through numpy give the JAX
    problem's derivatives, with and without the 'exact' Hessian terms."""
    jprob = jax_cartpole(nsteps=5)
    x0s = _tool().cart_x0s()[:2]
    tprob = convert.cartpole_problem_from_numpy(_cartpole_params(jprob, x0s), nsteps=5,
                                                device="cpu", u_bound=25.0)
    _derivatives_match(jprob, tprob, x0s, 10)
    _derivatives_match(jprob, tprob, x0s, 11, exact=True)


def _linear_euler(x0s, N):
    jprob = jax_linear_euler(nsteps=N)
    ode = jprob.stages.dynamics.ode
    tprob = convert.linear_euler_problem_from_numpy(dict(
        A=ode.A[0], B=ode.B[0], c=ode.c[0], w_x=jprob.term_cost.Q,
        w_u=np.asarray(jprob.stages.cost.R[0]) / 0.001,
        timestep=jprob.stages.dynamics.timestep[0], x0=x0s), nsteps=N, device="cpu")
    return jprob, tprob


def test_convert_linear_euler_and_partial_round_trip():
    x0s = np.array([[1.0, -0.5], [0.2, 0.3]])
    jprob, tprob = _linear_euler(x0s, 5)
    _derivatives_match(jprob, tprob, x0s, 12)

    jp = jax_partial(nsteps=5)
    tp = convert.partial_initial_condition_from_numpy(_partial_params(x0s), nsteps=5,
                                                      device="cpu")
    assert tp.init_cstr_dim == jp.init_cstr_dim == 1
    _derivatives_match(jp, tp, x0s, 13)


def test_replicate_and_stack_stages():
    """A replicated stage evaluates as the shared one; stacked stages with
    their own weights evaluate as the JAX package's stacked stages."""
    x0s = np.array([[1.0, -0.5], [0.2, 0.3]])
    jprob, tprob = _linear_euler(x0s, 4)
    rng = np.random.default_rng(14)
    xs, us = _t(rng.standard_normal((2, 5, 2))), _t(rng.standard_normal((2, 4, 2)))
    shared = tproblem.compute_derivatives(tprob, xs, us)
    rep = dataclasses.replace(tprob, stages=core.replicate_stage(tprob.stages, 4))
    assert rep.stages.nstack == 4 and rep.stages.cost.Q.shape == (4, 2, 2)
    got = tproblem.compute_derivatives(rep, xs, us)
    for f in dataclasses.fields(tproblem.ProblemData):
        if getattr(shared, f.name) is not None:
            _close(getattr(got, f.name), getattr(shared, f.name).numpy(), 1e-14, f.name)

    # the stage weights scaled by 1, 2, 3, 4 in both packages
    def jscaled(k):
        st = jax.tree.map(lambda a: a[0], jprob.stages)
        return replace(st, cost=replace(st.cost, Q=(k + 1.0) * st.cost.Q))

    def tscaled(k):
        st = tprob.stages
        return dataclasses.replace(st, cost=dataclasses.replace(st.cost, Q=(k + 1.0) * st.cost.Q))

    jst = jcore.stack_stages([jscaled(k) for k in range(4)])
    tst = core.stack_stages([tscaled(k) for k in range(4)])
    ref = jax.vmap(lambda x0, x, u: jproblem.compute_derivatives(
        replace(jprob, stages=jst, x0=x0), x, u))(jnp.asarray(x0s), xs.numpy(), us.numpy())
    got = tproblem.compute_derivatives(dataclasses.replace(tprob, stages=tst), xs, us)
    for name in ("cost", "stage_costs", "Lx", "Lu", "Lxx", "Luu", "A", "B", "E"):
        _close(getattr(got, name), getattr(ref, name), 1e-10, name)


def _solve_cartpole(case, **extra):
    tool = _tool()
    jprob = tool.cartpole_problem(case)
    x0s = tool.cart_x0s()
    tprob = convert.cartpole_problem_from_numpy(
        _cartpole_params(jax_cartpole(nsteps=tool.CART_N), x0s), nsteps=tool.CART_N,
        device="cpu", u_bound=25.0,
        integrator="midpoint" if case.startswith("midpoint") else "rk2")
    assert tprob.stages.dynamics.is_explicit == jprob.stages.dynamics.is_explicit
    cfg = at.solvers.ProxDDPConfig(**{**tool.CART_OPTIONS, **tool.CART_CASES[case],
                                      **extra})
    return at.solvers.solve(tprob, cfg)


def _same_solve(got, ref, tol=1e-8, fields=("xs", "us", "vs", "lams")):
    for k in ("num_iters", "al_iter", "conv"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), ref[k], err_msg=k)
    for k in fields:
        _close(getattr(got, k), ref[k], tol, k)
    for k in ("prim_infeas", "dual_infeas", "traj_cost"):
        _close(getattr(got, k), ref[k], tol, k)


@pytest.mark.parametrize("case", ["rk2", "midpoint", "midpoint_conv", "exact"])
def test_nonlinear_rollout_matches_jax(case):
    """ProxDDP with rollout='nonlinear' on the cartpole (N = 20, 4 scenarios):
    RK2 to convergence with its history, the implicit midpoint rule (general
    E; forward_with_gap in the rollout) for 3 iterations and, with two
    Newton steps a stage, to convergence, and 'exact' Hessians, to 1e-8."""
    ref = _fixture(f"cartpole_{case}_")
    got = _solve_cartpole(case)
    _same_solve(got, ref)
    if case in ("rk2", "midpoint_conv"):
        assert got.conv.all()
    if case == "rk2":
        n = got.history.shape[1]
        assert got.history.shape == (4, n, 8) and got.history_xs.shape == (4, n, 21, 4)
        assert got.history_lams.shape == (4, n, 21, 4) and got.history_vs.shape == (4, n, 20, 1)
        for k in ("history", "history_xs", "history_us", "history_vs", "history_lams"):
            _close(getattr(got, k), ref[k], 1e-8, k)


def test_init_constraint_matches_jax():
    """examples/partial_initial_condition.py: only x0[1] pinned, with
    force_initial_condition=False, against the JAX package; the forced
    initial condition with a general init_constraint raises as there."""
    tool = _tool()
    ref = _fixture("partial_")
    tprob = convert.partial_initial_condition_from_numpy(
        _partial_params(tool.PARTIAL_X0S), nsteps=tool.PARTIAL_N, device="cpu")
    got = at.solvers.solve(tprob, at.solvers.ProxDDPConfig(**tool.PARTIAL_OPTIONS))
    _same_solve(got, ref)
    _close(got.xs[:, 0, 1], tool.PARTIAL_X0S[:, 1], 1e-6, "pinned component")
    with pytest.raises(ValueError, match="force_initial_condition"):
        at.solvers.solve(tprob, at.solvers.ProxDDPConfig())


def test_fddp_history_matches_jax():
    tool = _tool()
    ref = _fixture("fddp_")
    _, tprob = _linear_euler(tool.FDDP_X0S, tool.FDDP_N)
    got = at.solvers.fddp.solve(tprob, at.solvers.FDDPConfig(**tool.FDDP_OPTIONS))
    np.testing.assert_array_equal(got.num_iters.numpy(), ref["num_iters"])
    for k in ("xs", "us", "history", "history_xs", "history_us"):
        _close(getattr(got, k), ref[k], 1e-8, k)


def test_verbose_and_callback_rows():
    """verbose prints one row per running scenario and iteration; the
    callback gets the batch's trace once per iteration."""
    tool = _tool()
    seen = []
    buf = io.StringIO()
    x0s = tool.cart_x0s()[:2]
    tprob = convert.cartpole_problem_from_numpy(
        _cartpole_params(jax_cartpole(nsteps=6), x0s), nsteps=6, device="cpu",
        u_bound=25.0)
    cfg = at.solvers.ProxDDPConfig(**{**tool.CART_OPTIONS, "max_iters": 5},
                                   verbose=True, callback=seen.append)
    with redirect_stdout(buf):
        res = at.solvers.solve(tprob, cfg)
    rows = [ln for ln in buf.getvalue().splitlines() if ln.strip()[:1].isdigit()]
    assert len(rows) == int(res.num_iters.sum())
    assert len(seen) == int(res.num_iters.max())
    assert all(t["prim_err"].shape == (2,) for t in seen)
    assert int(sum(t["running"].sum() for t in seen)) == len(rows)


@pytest.mark.slow
def test_fixture_matches_a_live_jax_solve():
    """Every fixture entry solved live by the JAX package."""
    live = _tool().references()
    with np.load(FIXTURE) as f:
        assert set(live) <= set(f.files)
        for k, v in live.items():
            np.testing.assert_allclose(f[k], v, rtol=1e-12, atol=1e-12, err_msg=k)
