"""The port's medium-dim slice against the JAX package, float64 on the CPU:
the plain versions of the kernels K2 (SPD solve), K3 (fused backward stage)
and K4 (forward substitution) against the Pallas kernels in interpret mode,
the routed LQ solve, and the humanoid-dims ProxDDP and dense-LQR ProxDDP and
FDDP solves at full width, against the JAX package's solves stored in
tests/data/torch_medium_ref.npz by tools/torch_medium_fixture.py (the slow
tests solve them again live). The CUDA kernels themselves are checked against
the same plain versions on the card by tests/test_torch_cuda.py.
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
from aligator_tpu.gar import pallas_spd, pallas_stage
from aligator_tpu.gar import riccati as jriccati

import aligator_tpu_torch as at
from aligator_tpu_torch import convert
from aligator_tpu_torch.examples import medium_dims
from aligator_tpu_torch.gar import fused_stage, lqr_problem, riccati, spd_solve

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    if ref.size == 0:
        assert got.shape == ref.shape
        return 0.0
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def _log_mus(rng, B, lo=-4.0, hi=-1.0):
    return 10 ** rng.uniform(lo, hi, B), 10 ** rng.uniform(lo, hi, B)


# ---------------------------------------------------------------- K2


@pytest.mark.parametrize("n,r", [(12, 1), (24, 13)])
def test_spd_solve_plain_matches_jax_kernel_interpret(n, r):
    rng = np.random.default_rng(n)
    M = 128
    G = rng.standard_normal((M, n, n))
    A = G @ G.swapaxes(-1, -2) / n + 0.1 * np.eye(n)
    R = rng.standard_normal((M, n, r))
    ref = jax.jit(lambda a, b: pallas_spd.spd_solve_lanes(a, b, interpret=True))(
        jnp.asarray(A), jnp.asarray(R))
    got = spd_solve.spd_solve_plain(torch.tensor(A), torch.tensor(R))
    assert _rel_err(got.numpy(), ref) < 1e-10
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(spd_solve.spd_solve(torch.tensor(A), torch.tensor(R)), got)


def test_spd_solve_plain_nan_row_for_non_pd_system():
    rng = np.random.default_rng(1)
    n, M = 6, 5
    G = rng.standard_normal((M, n, n))
    A = G @ G.swapaxes(-1, -2) + np.eye(n)
    A[2, 3, 3] = -1.0
    X = spd_solve.spd_solve(torch.tensor(A), torch.tensor(rng.standard_normal((M, n, 2))))
    assert torch.isnan(X[2]).all()
    assert torch.isfinite(X[[0, 1, 3, 4]]).all()


# ---------------------------------------------------------------- K3 and K4


def _sweep_inputs(rng, B, N, nx, nu, nc):
    """Random convex knots, a random SPD terminal value and per-scenario μ."""
    kn = lqr_problem.random_convex_problem(rng, B, N, nx, nu, nc,
                                           device="cpu").knots
    G = rng.standard_normal((B, nx, nx))
    P = G @ G.swapaxes(-1, -2) / nx + np.eye(nx)
    p = rng.standard_normal((B, nx))
    md, me = _log_mus(rng, B)
    return kn, P, p, md, me


def _jax_knot_fields(kn, N):
    return {k: jnp.asarray(getattr(kn, k)[:, :N].numpy())
            for k in fused_stage.STAGE_FIELDS}


@pytest.mark.parametrize("dims", [(6, 13, 4, 3), (4, 16, 5, 0)])
def test_stage_sweep_plain_matches_jax_kernel_interpret(dims):
    """K3's plain sweep against the Pallas sweep in interpret mode, with
    per-scenario μ; nc = 0 runs without the JAX's padding row."""
    N, nx, nu, nc = dims
    B = 128
    kn, P, p, md, me = _sweep_inputs(np.random.default_rng(N), B, N, nx, nu, nc)
    carry, ref = jax.jit(lambda kf, c0, a, b: pallas_stage.sweep_lanes(
        kf, c0, a, b, interpret=True))(
        _jax_knot_fields(kn, N), dict(P=jnp.asarray(P), p=jnp.asarray(p)),
        jnp.asarray(md), jnp.asarray(me))
    got = fused_stage.sweep(kn, torch.tensor(P), torch.tensor(p),
                            torch.tensor(md), torch.tensor(me))
    for k in fused_stage.FACTOR_FIELDS:
        assert got[k].shape[1] == N + 1
        assert (got[k][:, N] == 0).all(), k
        assert _rel_err(got[k][:, :N].numpy(), ref[k]) < 1e-9, k
    assert _rel_err(got["Pmat"][:, 0].numpy(), carry["P"]) < 1e-9
    assert _rel_err(got["pvec"][:, 0].numpy(), carry["p"]) < 1e-9
    # one stage alone is the last stage of the sweep
    t = N - 1
    one = fused_stage.stage({k: getattr(kn, k)[:, t] for k in fused_stage.STAGE_FIELDS},
                            torch.tensor(P), torch.tensor(p), torch.tensor(md),
                            torch.tensor(me))
    for k in fused_stage.FACTOR_FIELDS:
        assert torch.equal(one[k], got[k][:, t]), k


@pytest.mark.parametrize("mu", [1e-2, 1e-4])
def test_stage_sweep_gap_to_xla_sweep(mu):
    """K3 skips the in-stage symmetrizations of the XLA sweep and forms Ŝᵀ
    apart from Ŝ: down to μ = 1e-4 its plain sweep stays within 1e-9
    (relative to the output scale) of the JAX ``riccati.sweep``, yet differs
    from it. ``pytest -s`` prints the gap."""
    N, nx, nu, nc, B = 6, 13, 4, 3, 8
    kn, P, p, _, _ = _sweep_inputs(np.random.default_rng(2), B, N, nx, nu, nc)
    jkn = jgar.LQRKnots(**{k: jnp.asarray(getattr(kn, k).numpy())
                           for k in convert.KNOT_FIELDS})
    carry, ref = jax.jit(jax.vmap(
        lambda k: jriccati.sweep(k, mu, mu, assume_explicit=True)))(jkn)
    # the same terminal value for the port's sweep
    got = fused_stage.sweep(kn, torch.tensor(np.asarray(ref["Pmat"][:, N])),
                            torch.tensor(np.asarray(ref["pvec"][:, N])),
                            torch.full((B,), mu, dtype=torch.float64),
                            torch.full((B,), mu, dtype=torch.float64))
    gap = max(_rel_err(got[k][:, :N].numpy(), np.asarray(ref[k])[:, :N])
              for k in fused_stage.FACTOR_FIELDS)
    print(f"K3 sweep vs XLA sweep at mu={mu:g}: max relative gap {gap:.3e}")
    assert 0.0 < gap < 1e-9, gap


@pytest.mark.parametrize("nc", [3, 0])
def test_forward_plain_matches_jax_kernel_interpret(nc):
    N, nx, nu, B = 6, 13, 4, 128
    rng = np.random.default_rng(nc)
    shapes = dict(kff=(nu,), K=(nu, nx), zff=(nc,), Z=(nc, nx), lff=(nx,),
                  L=(nx, nx), yff=(nx,), Afb=(nx, nx))
    gains = {k: rng.standard_normal((B, N + 1) + s) / np.sqrt(nx)
             for k, s in shapes.items()}
    x0, lam0 = rng.standard_normal((B, nx)), rng.standard_normal((B, nx))
    xN, outs = jax.jit(lambda f, x: pallas_stage.forward_lanes(f, x, interpret=True))(
        {k: jnp.asarray(v[:, :N]) for k, v in gains.items()}, jnp.asarray(x0))
    xs, us, vs, lams = fused_stage.forward(
        {k: torch.tensor(v) for k, v in gains.items()}, torch.tensor(x0),
        torch.tensor(lam0))
    assert _rel_err(xs[:, :N].numpy(), outs["x"]) < 1e-12
    assert _rel_err(xs[:, N].numpy(), xN) < 1e-12
    assert _rel_err(us[:, :N].numpy(), outs["u"]) < 1e-12
    assert _rel_err(vs[:, :N].numpy(), outs["v"]) < 1e-12
    assert _rel_err(lams[:, 1:].numpy(), outs["lam_next"]) < 1e-12
    assert torch.equal(lams[:, 0], torch.tensor(lam0))
    K_N = torch.tensor(gains["K"][:, N])
    ref_uN = torch.tensor(gains["kff"][:, N]) + (K_N @ xs[:, N, :, None])[..., 0]
    torch.testing.assert_close(us[:, N], ref_uN, rtol=0, atol=1e-12)


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize("dims", [(8, 16, 5, 2), (4, 56, 6, 0)])
def test_routed_solve_and_gains_matches_jax(dims):
    """nx=16 takes the K3 sweep, nx=56 the per-stage loop with K2 solves;
    both forward sweeps take K4 (plain versions here). Held against the
    JAX solve with its kernel routes switched on (XLA on the CPU)."""
    N, nx, nu, nc = dims
    B = 4
    probs = jax.jit(jax.vmap(
        lambda k: jgar.random_convex_problem(k, N, nx, nu, nc, dtype=jnp.float64)
    ))(jax.random.split(jax.random.PRNGKey(nx), B))
    md, me = _log_mus(np.random.default_rng(nx), B, -3.0, -1.0)
    ref = jax.jit(jax.vmap(lambda p, a, b: jriccati.solve_and_gains(
        p, a, b, True, spd_lanes=True, stage_fused=True)))(
        probs, jnp.asarray(md), jnp.asarray(me))
    arrays = {k: np.asarray(getattr(probs.knots, k)) for k in convert.KNOT_FIELDS}
    arrays.update(G0=np.asarray(probs.G0), g0=np.asarray(probs.g0))
    tp = convert.lqr_problem_from_numpy(arrays, device="cpu")
    assert fused_stage.sweep_eligible(nx, nu, nc, True, 8) == (nx <= 44)
    got = riccati.solve_and_gains(tp, torch.tensor(md), torch.tensor(me), True)
    for g, r in zip(got[:4], ref[:4]):
        assert _rel_err(g.numpy(), r) < 1e-9
    for k in riccati.GAIN_FIELDS:
        assert _rel_err(got[4][k].numpy(), ref[4][k]) < 1e-9, k


def test_sweep_past_k3s_shared_memory_takes_the_loop(monkeypatch):
    """K3's route has a shared-memory term, as the JAX gate has a VMEM term:
    (44, 64, 64) needs 243 KB a block in fp64, more than the 227 KB a block
    may have, so the routed sweep takes the per-stage loop (K2's solves);
    in fp32 (122 KB) it takes K3."""
    assert fused_stage.stage_smem_bytes(44, 79, 6, 8) == 231736
    assert fused_stage.stage_smem_bytes(44, 64, 64, 8) > fused_stage.MAX_SHARED
    assert not fused_stage.sweep_eligible(44, 64, 64, True, 8)
    assert fused_stage.sweep_eligible(44, 64, 64, True, 4)
    assert fused_stage.sweep_eligible(44, 79, 6, True, 8)
    N, B = 2, 2
    kn = lqr_problem.random_convex_problem(np.random.default_rng(5), B, N, 44, 64,
                                           64, device="cpu").knots
    md, me = (torch.tensor(m) for m in _log_mus(np.random.default_rng(6), B))
    ref = riccati.sweep_plain(kn, md, me, True)
    monkeypatch.setattr(fused_stage, "sweep",
                        lambda *a: pytest.fail("the sweep went to K3"))
    solves = []
    spd = spd_solve.spd_solve
    monkeypatch.setattr(spd_solve, "spd_solve", lambda A, R: solves.append(
        A.shape[-1]) or spd(A, R))
    got = riccati.sweep(kn, md, me, True)
    assert solves == [44, 64] * N  # Schur and reduced KKT, stage by stage
    for k in fused_stage.FACTOR_FIELDS:
        assert _rel_err(got[k].numpy(), ref[k].numpy()) < 1e-12, k


# ---------------------------------------------------------------- slices


def _assert_same_solve(got, ref, fields):
    for name in ("num_iters", "conv") + (("al_iter",) if hasattr(got, "al_iter") else ()):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-8,
                                   err_msg=name)


FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / "torch_medium_ref.npz"


def _medium_tool():
    """tools/torch_medium_fixture.py, which writes the fixture and computes
    the live JAX references of the slow tests."""
    spec = importlib.util.spec_from_file_location(
        "torch_medium_fixture", ROOT / "tools" / "torch_medium_fixture.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _fixture(prefix):
    with np.load(FIXTURE) as f:
        return {k[len(prefix) + 1:]: f[k] for k in f.files if k.startswith(prefix + "_")}


def _humanoid_solve(x0s):
    """The port's humanoid-dims solve (K3 sweep, K4 forward) from the
    fixture's initial states, at the fixture's configuration."""
    tool = _medium_tool()
    prob = medium_dims.make_humanoid_dims_problem(tool.N, torch.float64, "cpu")
    prob = dataclasses.replace(prob, x0=torch.tensor(x0s))
    return at.solvers.solve(prob, at.solvers.ProxDDPConfig(**tool.HUMANOID_OPTS))


def _dense_lqr_solve(params, solver):
    tool = _medium_tool()
    prob = convert.linear_problem_from_numpy(params, tool.N, device="cpu")
    if solver == "proxddp":
        return at.solvers.solve(prob, at.solvers.ProxDDPConfig(**tool.LQR_PROX_OPTS))
    return at.solvers.fddp.solve(prob, at.solvers.FDDPConfig(**tool.LQR_FDDP_OPTS))


def _check_fddp(got, ref):
    _assert_same_solve(got, ref, ("xs", "us", "K", "kff"))
    for name in ("prim_infeas", "dual_infeas", "traj_cost"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-8,
                                   atol=1e-12, err_msg=name)


def test_humanoid_proxddp_matches_jax_vmap():
    """Humanoid dims (nx=36, nu=12, nc=12) at the bench configuration, the
    horizon cut to 20: the port's solve (K3 sweep, K4 forward) against
    jax.vmap of the JAX solver, stored in tests/data/torch_medium_ref.npz
    (``test_humanoid_fixture_matches_a_live_jax_solve`` reruns it)."""
    ref = _fixture("humanoid")
    got = _humanoid_solve(ref["x0s"])
    assert got.conv.any() and (got.vs != 0).any()
    _assert_same_solve(got, SimpleNamespace(**ref), ("xs", "us", "vs", "lams"))


def test_dense_lqr_proxddp_matches_jax_vmap():
    got = _dense_lqr_solve(_fixture("lqr"), "proxddp")
    _assert_same_solve(got, SimpleNamespace(**_fixture("proxddp")), ("xs", "us", "lams"))


def test_dense_lqr_fddp_matches_jax_vmap():
    _check_fddp(_dense_lqr_solve(_fixture("lqr"), "fddp"),
                SimpleNamespace(**_fixture("fddp")))


def _same_arrays(live: dict, fix: dict):
    assert set(live) == set(fix)
    for k, v in live.items():
        if np.asarray(v).dtype.kind == "f":
            np.testing.assert_allclose(fix[k], v, rtol=1e-12, atol=1e-14, err_msg=k)
        else:
            assert np.array_equal(fix[k], v), k


@pytest.mark.slow
def test_humanoid_fixture_matches_a_live_jax_solve():
    """The humanoid reference solved live by the JAX package: the fixture
    holds it, and the port matches it."""
    live = _medium_tool().humanoid_reference()
    _same_arrays(live, _fixture("humanoid"))
    got = _humanoid_solve(live["x0s"])
    _assert_same_solve(got, SimpleNamespace(**live), ("xs", "us", "vs", "lams"))


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["proxddp", "fddp"])
def test_dense_lqr_fixture_matches_a_live_jax_solve(solver):
    tool = _medium_tool()
    _, params = tool.dense_lqr_params()
    _same_arrays(params, _fixture("lqr"))
    live = tool.dense_lqr_reference(solver)
    _same_arrays(live, _fixture(solver))
    got = _dense_lqr_solve(params, solver)
    if solver == "fddp":
        _check_fddp(got, SimpleNamespace(**live))
    else:
        _assert_same_solve(got, SimpleNamespace(**live), ("xs", "us", "lams"))


def test_make_dense_lqr_law():
    prob = medium_dims.make_dense_lqr(56, 22, 3, torch.float64, "cpu")
    A = prob.stages.dynamics.A.numpy()
    np.testing.assert_allclose(np.abs(np.linalg.eigvals(A)).max(), 0.95, rtol=1e-12)
    assert np.linalg.eigvalsh(prob.stages.cost.R.numpy()).min() > 0.1 - 1e-12
    assert prob.x0.shape == (1, 56)


@pytest.mark.parametrize("option", [dict(record_history=True), dict(verbose=True)])
def test_fddp_unported_options_raise(option, capsys):
    """These options raised NotImplementedError until the port carried
    them; FDDP now records its history and prints a row per iteration."""
    prob = medium_dims.make_dense_lqr(4, 2, 3, torch.float64, "cpu")
    res = at.solvers.fddp.solve(prob, at.solvers.FDDPConfig(**option))
    n = int(res.num_iters[0])
    assert res.conv.all() and n >= 1
    if option.get("record_history"):
        assert res.history.shape == (1, 200, 6)
        np.testing.assert_allclose(res.history[0, 0, 2].item(),
                                   at.core.evaluate(prob, prob.x0[:, None].expand(1, 4, 4),
                                                    torch.zeros(1, 3, 2, dtype=torch.float64)
                                                    ).cost.item(), rtol=1e-12)
    else:
        rows = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.strip()[:1].isdigit()]
        assert len(rows) == n
