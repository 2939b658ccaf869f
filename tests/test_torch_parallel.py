"""The port's parallel-in-time LQ solvers against the JAX package.

``aligator_tpu_torch.gar`` ``associative``, ``parallel``, ``block_tridiag``
and the θ branch of ``riccati``, and ProxDDP's ``linear_solver`` routes
``'serial_scan'``, ``'parallel'`` and ``'associative'``. The LQ instances
are built by the JAX package in float64 and carried to the port through
numpy; the JAX references are jitted at small shapes. The ProxDDP
references are ``tests/data/torch_parallel_ref.npz``, written by
``tools/torch_parallel_fixture.py``; the ``slow`` test reruns them live.
The kernels these routes launch on the card are checked there by
tests/test_torch_cuda.py.
"""

import dataclasses
import importlib.util
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligator_tpu import gar as jgar
from aligator_tpu._pytree import replace
from aligator_tpu.gar import parallel as jparallel
from aligator_tpu.gar import riccati as jriccati

import aligator_tpu_torch as at
from aligator_tpu_torch import convert
from aligator_tpu_torch.examples.lqr import make_lqr_problem
from aligator_tpu_torch.examples.se2_car import create_se2_problem
from aligator_tpu_torch.gar import (associative, block_tridiag, fused_riccati,
                                    fused_stage, lqr_problem, parallel, riccati)
from aligator_tpu_torch.solvers import proxddp

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_parallel_ref.npz"
SOL = ("xs", "us", "vs", "lams")


def _problems(N, nx, nu, nc, B, seed, general_E=False):
    """``B`` random convex LQ problems (``random_convex_problem``'s law, drawn
    with numpy from ``seed``), as the JAX package's and as the port's."""
    tp = lqr_problem.random_convex_problem(np.random.default_rng(seed), B, N, nx,
                                           nu, nc, general_E, device="cpu")
    arrays = {f.name: jnp.array(getattr(tp.knots, f.name).numpy())
              for f in dataclasses.fields(tp.knots)
              if getattr(tp.knots, f.name) is not None}
    jp = jgar.LQRProblem(knots=jgar.LQRKnots(**arrays),
                         G0=jnp.array(tp.G0.numpy()), g0=jnp.array(tp.g0.numpy()))
    return jp, tp


def _settled(fn, *args):
    """The result of the jitted JAX reference ``fn(*args)`` that two runs
    agree on bit for bit. On XLA's CPU runtime one executable of the JAX
    package's ``associative.solve`` now and then returns a wrong forward
    scan, a different one each run (ROADMAP.md, Queue 3); a right result is
    the same in every run."""
    seen = []
    for _ in range(8):
        out = jax.tree.map(np.asarray, fn(*args))
        leaves = jax.tree.leaves(out)
        if any(all(np.array_equal(a, b) for a, b in zip(leaves, prev))
               for prev in seen):
            return out
        seen.append(leaves)
    raise AssertionError("eight runs of the JAX reference all differ")


def _per_scenario(fn, batch, *args):
    """``fn(one, *args)`` jitted once and run on each scenario of the pytree
    ``batch`` (leading axis) in turn, the results stacked: what
    ``jax.vmap`` computes, at a third less tracing and compiling."""
    jitted = jax.jit(fn)
    n = jax.tree.leaves(batch)[0].shape[0]
    outs = [_settled(jitted, jax.tree.map(lambda a: a[b], batch), *args)
            for b in range(n)]
    return jax.tree.map(lambda *xs: np.stack(xs), *outs)


def _to_torch(probs):
    arrays = {k: np.asarray(v) for k, v in dataclasses.asdict(probs.knots).items()
              if v is not None}
    arrays.update(G0=np.asarray(probs.G0), g0=np.asarray(probs.g0))
    return convert.lqr_problem_from_numpy(arrays, device="cpu")


def _close(got, ref, atol, msg=""):
    ref = np.asarray(ref)
    scale = 1.0 + (np.abs(ref).max() if ref.size else 0.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol * scale,
                               err_msg=msg)


# ---------------------------------------------------------------- scans


@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_pairs_as_jax(reverse):
    """Products of integer 2x2 matrices are exact, so a pairing that differs
    from jax.lax.associative_scan's shows as a different result."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 6, 11):  # odd and even lengths at each recursion depth
        a = rng.integers(-1, 2, (n, 2, 2)).astype(np.float64)
        ref = jax.lax.associative_scan(lambda x, y: x @ y, jnp.asarray(a),
                                       reverse=reverse)
        got, = associative.associative_scan(
            lambda x, y: (x[0] @ y[0],), (torch.tensor(a)[None],), reverse)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))


def test_block_tridiag_solve_matches_a_dense_solve():
    B, K, n = 3, 7, 4
    g = torch.Generator().manual_seed(0)
    D = torch.randn(B, K, n, n, dtype=torch.float64, generator=g)
    D = D + D.mT
    L = torch.randn(B, K - 1, n, n, dtype=torch.float64, generator=g)
    rhs = torch.randn(B, K, n, dtype=torch.float64, generator=g)
    M = torch.zeros(B, K * n, K * n, dtype=torch.float64)
    for k in range(K):
        M[:, k * n:(k + 1) * n, k * n:(k + 1) * n] = D[:, k]
    for k in range(K - 1):
        M[:, (k + 1) * n:(k + 2) * n, k * n:(k + 1) * n] = L[:, k]
        M[:, k * n:(k + 1) * n, (k + 1) * n:(k + 2) * n] = L[:, k].mT
    ref = torch.linalg.solve(M, rhs.reshape(B, -1)).reshape(B, K, n)
    for steps in (0, 1):
        got = block_tridiag.solve(D, L, rhs, refine_steps=steps)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-10)
    torch.testing.assert_close(block_tridiag.matmul(D, L, ref), rhs, rtol=0,
                               atol=1e-10)


# ---------------------------------------------------------------- θ branch


THETA_MUS = (1e-3, 2e-3)


@pytest.fixture(scope="module")
def theta_case():
    """Problems with θ blocks (N=5, (3, 2, 1), nth = 2), with E = -I and with
    a general E, a non-zero θ, and JAX's backward (general E) and forward at
    θ for both (one jit: E is data)."""
    N, nx, nu, nc, nth, B = 5, 3, 2, 1, 2, 3
    probs, _ = _problems(N, nx, nu, nc, B, seed=1)
    rng = np.random.default_rng(1)
    T = N + 1
    th = dict(Gx=rng.standard_normal((B, T, nx, nth)),
              Gu=rng.standard_normal((B, T, nu, nth)),
              Gth=np.zeros((B, T, nth, nth)) + np.eye(nth),
              gamma=rng.standard_normal((B, T, nth)))
    probs = replace(probs, knots=replace(
        probs.knots, **{k: jnp.asarray(v) for k, v in th.items()}))
    E = np.asarray(probs.knots.E) + 0.1 * rng.standard_normal(probs.knots.E.shape)
    both = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), probs,
                        replace(probs, knots=replace(probs.knots, E=jnp.asarray(E))))
    theta = jnp.asarray(rng.standard_normal((B, nth)))

    def one(pt):
        f = jriccati.backward(pt[0], *THETA_MUS, assume_explicit=False)
        return f, jriccati.forward(f, theta=pt[1])

    refs = _per_scenario(one, (both, jnp.concatenate([theta, theta])))
    rows = {True: slice(0, B), False: slice(B, 2 * B)}
    return {explicit: (jax.tree.map(lambda a: a[sl], both), theta,
                       jax.tree.map(lambda a: a[sl], refs))
            for explicit, sl in rows.items()}


@pytest.mark.parametrize("explicit", [True, False])
def test_theta_riccati_matches_jax(theta_case, explicit):
    """backward with θ blocks and forward at a non-zero θ: every θ factor,
    the initial-stage sensitivities and the solution, against JAX."""
    probs, theta, (jf, jsol) = theta_case[explicit]
    tp = _to_torch(probs)
    assert tp.nth == theta.shape[-1]
    theta = torch.tensor(np.asarray(theta))
    f = riccati.backward(tp, *THETA_MUS, explicit)
    sol = riccati.forward(f, theta)
    for k in ("kff", "K", "Pmat", "Kth", "Zth", "Lth", "Yth", "Vxt", "Vtt", "vt",
              "x0_th", "lam0_th", "th_grad", "th_hess"):
        _close(getattr(f, k), getattr(jf, k), 1e-11, k)
    for k, g, r in zip(SOL, sol, jsol):
        _close(g, r, 1e-11, k)
    # the solution is stationary for the problem at θ
    for e in lqr_problem.kkt_error(tp, *sol, *THETA_MUS, theta):
        assert e.max().item() < 1e-9


def test_theta_blocks_keep_the_fused_routes_off():
    """K1 and K3 have no θ blocks: the gates say no once nth > 0."""
    tp = lqr_problem.random_convex_problem(np.random.default_rng(0), 2, 4, 3, 2,
                                           1, device="cpu")
    assert fused_riccati.available(tp)
    tp.knots = lqr_problem.add_parameterization(tp.knots, 3)
    assert tp.nth == 3 and not fused_riccati.available(tp)
    assert fused_stage.sweep_eligible(36, 12, 12, True, 4)
    assert not fused_stage.sweep_eligible(36, 12, 12, True, 4, nth=36)


# ---------------------------------------------------------------- associative


@pytest.fixture(scope="module")
def assoc_case():
    """Random problems (N=16, (4, 2, 1)) and, at μ = 1e-2, 1e-4 and 1e-6,
    JAX's associative solve and its serial factors, whose gains the
    associative solve's equal, from tests/data/torch_parallel_ref.npz: run
    in a test process, JAX's ``associative.solve`` took down the worker now
    and then (ROADMAP.md, Queue 3)."""
    tool = _tool()
    fix = _load("assoc_")
    refs = {mu: ([fix[f"mu{i}_{k}"] for k in SOL],
                 SimpleNamespace(**{k: fix[f"mu{i}_{k}"] for k in tool.FACTORS}))
            for i, mu in enumerate(tool.ASSOC_MUS)}
    return convert.lqr_problem_from_numpy(fix, device="cpu"), refs


# the JAX test's tolerances (tests/gar/test_associative.py): the folded 1/μ
# scale costs ~μ⁻¹·eps against the serial recursion
ASSOC_TOL = {1e-2: 1e-9, 1e-4: 1e-5}


@pytest.mark.parametrize("gains", [False, True])
@pytest.mark.parametrize("mu", [1e-2, 1e-4])
def test_associative_solve_matches_jax(assoc_case, mu, gains):
    tp, refs = assoc_case
    jsol, jf = refs[mu]
    out = associative.solve(tp, mu, mu, return_gains=gains)
    assert len(out) == 4 + gains
    for k, g, r in zip(SOL, out, jsol):
        _close(g, r, ASSOC_TOL[mu], k)
    if gains:
        N = tp.horizon
        for k in ("kff", "K", "zff", "Z", "Pmat", "pvec"):
            _close(getattr(out[4], k), getattr(jf, k), ASSOC_TOL[mu], k)
        for k in ("lff", "L", "yff", "Afb"):
            _close(getattr(out[4], k)[:, :N], getattr(jf, k)[:, :N],
                   ASSOC_TOL[mu], k)


def test_associative_refinement_at_mu_1e_6(assoc_case):
    """At μ = 1e-6 the scan alone loses digits (the port's raw scan follows
    JAX's); one KKT-residual refinement restores solver-grade accuracy, as
    in the JAX package's own test."""
    tp, refs = assoc_case
    mu = 1e-6
    raw = associative.solve(tp, mu, mu)
    got = associative.solve(tp, mu, mu, refine_steps=1)
    for k, g, r in zip(SOL, raw, refs[mu][0]):
        _close(g, r, 1e-3, k)

    def kkt(sol):
        return torch.stack(lqr_problem.kkt_error(tp, *sol, mu, mu)).amax(0)

    assert (kkt(got) < 1e-8).all() and (kkt(got) <= kkt(raw)).all()
    ref = riccati.solve(tp, mu, mu, True)
    for k, g, r in zip(SOL, got, ref):
        _close(g, r.numpy(), 1e-6, k)


# ---------------------------------------------------------------- parallel


PAR_MUS = (1e-3, 1e-4)
PAR_LEGS = (2, 4, 3)  # T = 16: 3 legs make two leg groups (6, 5, 5)


@pytest.fixture(scope="module")
def parallel_case():
    """Convex problems, N=15, (4, 2, 1), and JAX's parallel solves with gains
    at 2, 4 and 3 legs (one jit)."""
    probs, _ = _problems(15, 4, 2, 1, 2, seed=7)
    return probs, _per_scenario(lambda p: {
        legs: jparallel.solve(p, *PAR_MUS, legs=legs, assume_explicit=True,
                              return_gains=True) for legs in PAR_LEGS}, probs)


@pytest.mark.parametrize("legs", PAR_LEGS)
def test_parallel_solve_matches_jax(parallel_case, legs):
    probs, refs = parallel_case
    *jsol, jgains = refs[legs]
    tp = _to_torch(probs)
    *sol, gains = parallel.solve(tp, *PAR_MUS, legs=legs, assume_explicit=True,
                                 return_gains=True)
    for k, g, r in zip(SOL, sol, jsol):
        _close(g, r, 1e-8, k)
    _close(gains.kff, jgains.kff, 1e-8, "kff")
    _close(gains.K, jgains.K, 1e-8, "K")
    torch.testing.assert_close(gains.kff + (gains.K @ sol[0][..., None])[..., 0],
                               sol[1], rtol=0, atol=1e-8)
    serial = riccati.backward(tp, *PAR_MUS, True)
    # collapseFeedback: the first-stage feedback is the serial solver's
    torch.testing.assert_close(gains.K[:, 0], serial.K[:, 0], rtol=0, atol=1e-8)
    for k, g, r in zip(SOL, sol, riccati.forward(serial)):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-8, msg=k)


def test_parallel_condensed_refinement_fp32():
    """A float32 solve over 16 legs at the JAX test's dimensions: refinement
    of the condensed system keeps it within 1e-5 of the float64 serial
    solve of the same problem (held against JAX in test_torch_gar.py)."""
    _, tp64 = _problems(31, 6, 3, 2, 1, seed=5)
    tp = tp64.map(torch.Tensor.float)
    xs_t, us_t, _, _ = riccati.solve(tp64, 1e-2, 1e-2, True)
    xs, us, _, _ = parallel.solve(tp, 1e-2, 1e-2, legs=16, assume_explicit=True,
                                  refine_steps=2)
    for got, ref in ((us, us_t), (xs, xs_t)):
        assert (got.double() - ref).abs().max() / ref.abs().max() < 1e-5


# ---------------------------------------------------------------- ProxDDP


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_parallel_fixture", ROOT / "tools" / "torch_parallel_fixture.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _load(prefix):
    with np.load(FIXTURE) as f:
        return {k[len(prefix):]: f[k] for k in f.files if k.startswith(prefix)}


def _fixture(case, route):
    return _load(f"{case}_{route}_")


def _port_solve(tool, case, route):
    """The port's solve of a fixture case on ``route``, and the Newton steps
    each route took."""
    dtype, u_bound, opts, _ = tool.CASES[case]
    dt = getattr(torch, dtype)
    prob = make_lqr_problem(tool.NSTEPS, dt, u_bound, device="cpu")
    prob = dataclasses.replace(prob, x0=torch.tensor(tool.x0s(), dtype=dt))
    for k in proxddp.ROUTE_STEPS:
        proxddp.ROUTE_STEPS[k] = 0
    res = at.solvers.solve(prob, at.solvers.ProxDDPConfig(
        **opts, rollout="linear", linear_solver=route, parallel_legs=tool.LEGS))
    return res, {k: int(v) for k, v in proxddp.ROUTE_STEPS.items()}


def _same_iterations(got, ref):
    for k in ("num_iters", "al_iter", "conv"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("case,route", [
    ("lqr", "associative"), ("lqr", "parallel"), ("box", "associative"),
    ("box", "parallel"),
])
def test_proxddp_route_matches_serial_scan_and_jax(case, route):
    """float64: the route's solve equals the port's 'serial_scan' solve and
    the JAX package's solve on the same route; on 'parallel' K[:, 0] is the
    collapsed feedback, and the last leg's gains are the serial ones."""
    tool = _tool()
    got, steps = _port_solve(tool, case, route)
    base, _ = _port_solve(tool, case, "serial_scan")
    ref = _fixture(case, route)
    assert steps[route] == int(got.newton_steps.sum()) > 0
    _same_iterations(got, ref)
    _same_iterations(base, _fixture(case, "serial_scan"))
    assert got.conv.all()
    if case == "box":
        assert (got.vs != 0).any()  # some bounds are active
    for k in SOL:
        np.testing.assert_allclose(getattr(got, k).numpy(), ref[k], rtol=0,
                                   atol=1e-8, err_msg=k)
        torch.testing.assert_close(getattr(got, k), getattr(base, k), rtol=0,
                                   atol=1e-8, msg=k)
    # 'associative' gains are the serial ones; the 'parallel' ones are on
    # the last leg, and K[:, 0] is the collapsed first-stage feedback
    starts, _ = parallel.get_work(tool.NSTEPS + 1, tool.LEGS)
    same = slice(None) if route == "associative" else slice(starts[-1], None)
    for k in ("K", "kff"):
        np.testing.assert_allclose(getattr(got, k).numpy(), ref[k], rtol=0,
                                   atol=1e-6, err_msg=k)
        torch.testing.assert_close(getattr(got, k)[:, same],
                                   getattr(base, k)[:, same], rtol=0, atol=1e-6)
    torch.testing.assert_close(got.K[:, 0], base.K[:, 0], rtol=0, atol=1e-6)


def test_fp32_mu_floor_start_below():
    """float32, mu_init 1e-4: every Newton step is under the μ floor, so
    'associative' takes the serial solve throughout and equals 'serial_scan'."""
    tool = _tool()
    got, steps = _port_solve(tool, "below", "associative")
    base, _ = _port_solve(tool, "below", "serial_scan")
    assert steps["associative"] == 0
    assert steps["associative_fallback"] == int(got.newton_steps.sum()) > 0
    assert got.conv.all()
    for k in SOL + ("K", "kff"):
        torch.testing.assert_close(getattr(got, k), getattr(base, k), rtol=0, atol=0)
    ref = _fixture("below", "associative")
    _same_iterations(got, ref)
    np.testing.assert_allclose(got.us.numpy(), ref["us"], rtol=0, atol=1e-4)


def test_fp32_mu_floor_crossed_by_bcl():
    """float32, a bound at 0.05 and tight primal tolerances: BCL failures
    drive μ from 1e-2 to 1e-4, across the floor (1e-6 on μ_dyn = 1e-3 μ), so
    each scenario takes the associative scan first and the serial solve
    after; the result is the JAX package's and 'serial_scan''s."""
    tool = _tool()
    got, steps = _port_solve(tool, "cross", "associative")
    base, _ = _port_solve(tool, "cross", "serial_scan")
    assert steps["associative"] > 0 and steps["associative_fallback"] > 0
    assert steps["associative"] + steps["associative_fallback"] == int(
        got.newton_steps.sum())
    assert got.conv.all() and (got.mu_final < 1e-3).all()
    ref = _fixture("cross", "associative")
    _same_iterations(got, ref)
    np.testing.assert_allclose(got.us.numpy(), ref["us"], rtol=0, atol=1e-3)
    torch.testing.assert_close(got.us, base.us, rtol=0, atol=1e-3)


def test_linear_solver_options_are_checked():
    prob = make_lqr_problem(3, torch.float64, device="cpu")
    with pytest.raises(ValueError):
        at.solvers.solve(prob, at.solvers.ProxDDPConfig(linear_solver="dense"))
    with pytest.raises(ValueError):
        at.solvers.solve(prob, at.solvers.ProxDDPConfig(linear_solver="parallel",
                                                        rollout="nonlinear"))
    se2 = create_se2_problem(nsteps=3, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError):  # SE(2) is not a vector space
        at.solvers.solve(se2, at.solvers.ProxDDPConfig(linear_solver="associative"))


@pytest.mark.slow
def test_fixture_matches_a_live_jax_solve():
    """Every fixture case solved live by the JAX package: the archive holds
    its results."""
    tool = _tool()
    with np.load(FIXTURE) as f:
        np.testing.assert_array_equal(f["x0s"], tool.x0s())
    live, fix = tool.assoc_reference(), _load("assoc_")
    assert set(live) == set(fix)
    for k, v in live.items():
        np.testing.assert_allclose(fix[k], v, rtol=1e-12, atol=1e-12, err_msg=k)
    for case, (dtype, *_, routes) in tool.CASES.items():
        for route in routes:
            live, fix = tool.reference(case, route), _fixture(case, route)
            assert set(live) == set(fix)
            rtol = 1e-12 if dtype == "float64" else 1e-5
            for k, v in live.items():
                np.testing.assert_allclose(fix[k], v, rtol=rtol, atol=rtol,
                                           err_msg=f"{case} {route} {k}")
