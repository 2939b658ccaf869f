"""The port's receding-horizon MPC against the JAX package, float64 on the CPU.

``utils.mpc`` (``roll_left``, ``cycle_problem`` on a stacked model and on a
model whose schedule is made of stage-varying leaves, ``cycle_warm_start``
with and without ``problem=``) against the JAX package's functions on the
same numpy inputs, to 1e-10 relative; the warm-started LQR cycles of
``tests/test_mpc.py::test_mpc_warm_start_converges_in_two_iters`` and 6
cycles of the SE(2) receding-horizon loop (``examples/mpc_se2.py``, the
protocol of ``bench_mpc.py``) against ``tests/data/torch_mpc_ref.npz``,
written by ``tools/torch_mpc_fixture.py`` (the ``slow`` test reruns it
live): per cycle the iteration count and convergence flag exactly, xs and us
to 1e-8. The card's cycles are checked by tests/test_torch_cuda.py.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aligator_tpu_torch as at
from aligator_tpu import utils as jutils
from aligator_tpu._pytree import replace as jreplace
from aligator_tpu_torch import convert
from aligator_tpu_torch.core import problem as problem_mod
from aligator_tpu_torch.examples import centroidal_locomotion, mpc_se2
from aligator_tpu_torch.examples.se2_car import create_se2_problem
from aligator_tpu_torch.utils import mpc

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_mpc_ref.npz"
TOL = 1e-10
TOL_SOLVE = 1e-8


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_mpc_fixture", ROOT / "tools" / "torch_mpc_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixture(prefix):
    with np.load(FIXTURE) as f:
        return {k[len(prefix):]: f[k] for k in f.files if k.startswith(prefix)}


def _close(got, ref, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max()) if ref.size else 0.0
    assert err <= tol, (msg, err)


# ---------------------------------------------------------------- components


@pytest.mark.parametrize("new_last", [False, True])
def test_roll_left_matches_jax(new_last):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 7, 4))
    last = rng.standard_normal((3, 4))
    got = mpc.roll_left(torch.tensor(a), torch.tensor(last) if new_last else None)
    for b in range(3):
        ref = jutils.roll_left(jnp.asarray(a[b]), jnp.asarray(last[b]) if new_last else None)
        _close(got[b], ref)


def _jax_lqr(nsteps=6, u_bound=None):
    from tests.test_proxddp import make_lqr
    return make_lqr(nsteps=nsteps, u_bound=u_bound)


def _port_lqr(jp, nsteps):
    return convert.linear_problem_from_numpy(_tool().lqr_leaves(jp), nsteps, device="cpu")


@pytest.mark.parametrize("with_new_stage", [False, True])
def test_cycle_problem_on_a_stacked_model_matches_jax(with_new_stage):
    """As tests/test_mpc.py::test_cycle_problem_rotates_stages: the stage
    weights R scaled by 1..6 rotate to 2..6, 1 (or the new stage's last)."""
    jp = _jax_lqr()
    w = jnp.arange(1.0, 7.0)[:, None, None]
    jp = jreplace(jp, stages=jreplace(jp.stages, cost=jreplace(jp.stages.cost,
                                                                 R=jp.stages.cost.R * w)))
    tp = _port_lqr(jp, 6)
    stages = problem_mod.replicate_stage(tp.stages, 6)
    R = torch.tensor(np.asarray(jp.stages.cost.R))
    stages = dataclasses.replace(stages, cost=dataclasses.replace(stages.cost, R=R))
    tp = dataclasses.replace(tp, stages=stages)
    new_x0 = torch.tensor([[0.3, -0.2]], dtype=torch.float64)
    if with_new_stage:
        jnew = jreplace(jp.stage_at(0), cost=jreplace(jp.stage_at(0).cost,
                                                      R=jnp.full((1, 1), 9.0)))
        jc = jutils.cycle_problem(jp, jnew, new_x0=jnp.asarray(new_x0[0]))
        tnew = dataclasses.replace(tp.stages.at(0), cost=dataclasses.replace(
            tp.stages.at(0).cost, R=torch.full((1, 1), 9.0, dtype=torch.float64)))
        tc = mpc.cycle_problem(tp, tnew, new_x0=new_x0)
    else:
        jc = jutils.cycle_problem(jp, new_x0=jnp.asarray(new_x0[0]))
        tc = mpc.cycle_problem(tp, new_x0=new_x0)
    assert tc.stages.nstack == 6
    _close(tc.stages.cost.R, jc.stages.cost.R)
    _close(tc.stages.cost.Q, jc.stages.cost.Q)
    _close(tc.x0[0], jc.x0)


def _centroidal(device="cpu"):
    return centroidal_locomotion.create_centroidal_problem(device=device)


def test_cycle_problem_on_a_schedule_model_matches_jax():
    """The centroidal gait, its schedule stage-varying leaves of one model:
    the contact map's activity and points, the cones' gates rotate as the
    JAX package's stacked stages do; with a new stage its row lands last."""
    from examples.centroidal_locomotion import create_centroidal_problem
    jp = create_centroidal_problem()
    tp = _centroidal()
    jc = jutils.cycle_problem(jp)
    tc = mpc.cycle_problem(tp)
    jmap, tmap = jc.stages.dynamics.ode.contact_map, tc.stages.dynamics.ode.contact_map
    _close(tmap.active, jmap.active)
    _close(tmap.points, jmap.points)
    for (tf, _), (jf, _) in zip(tc.stages.constraints, jc.stages.constraints):
        _close(tf.active, jf.active)
    # the residuals' contact maps rotate with the dynamics'
    _close(tc.stages.cost.costs[2].residual.contact_map.active, jmap.active)
    # a new last stage: the schedule row of the JAX package's first stage
    N = tp.nsteps
    jc = jutils.cycle_problem(jp, jp.stage_at(N - 1))
    last = core_stage_row(tp, N - 1)
    tc = mpc.cycle_problem(tp, last)
    _close(tc.stages.dynamics.ode.contact_map.active,
           jc.stages.dynamics.ode.contact_map.active)
    # the rotated model evaluates as one built from the rotated schedule
    rng = np.random.default_rng(2)
    xs = torch.tensor(0.1 * rng.standard_normal((2, N + 1, 9)))
    us = torch.tensor(rng.standard_normal((2, N, 12)))
    act, pts = centroidal_locomotion.make_schedule()
    direct = convert.centroidal_problem_from_numpy(dict(
        x0=tp.x0.numpy(), active=np.roll(act, -1, 0), points=np.roll(pts, -1, 0),
        mass=centroidal_locomotion.MASS, gravity=np.asarray(centroidal_locomotion.GRAVITY),
        timestep=centroidal_locomotion.DT, com_final=np.asarray(centroidal_locomotion.COM_FINAL),
        mu=centroidal_locomotion.MU_FRICTION), device="cpu")
    a = problem_mod.compute_derivatives(mpc.cycle_problem(tp), xs, us)
    b = problem_mod.compute_derivatives(direct, xs, us)
    for k in ("cost", "dyn_res", "cstr_vals", "Lx", "Luu", "A", "B", "cstr_Ju"):
        _close(getattr(a, k), getattr(b, k), msg=k)


def core_stage_row(problem, t):
    """One stage of a schedule model: its stage-varying leaves' row t."""
    N = problem.nsteps

    def row(obj):
        import dataclasses as dc
        if isinstance(obj, tuple):
            return tuple(row(o) for o in obj)
        if not dc.is_dataclass(obj) or isinstance(obj, type):
            return obj
        varying = getattr(obj, "STAGE_PARAMS", {})
        new = {}
        for f in dc.fields(obj):
            val = getattr(obj, f.name)
            if f.name in varying and isinstance(val, torch.Tensor) and \
                    val.ndim == varying[f.name] + 1 and val.shape[0] == N:
                new[f.name] = val[t]
            elif isinstance(val, tuple) or dc.is_dataclass(val):
                new[f.name] = row(val)
        return dc.replace(obj, **new)

    return row(problem.stages)


@pytest.mark.parametrize("model", ["lqr", "centroidal"])
@pytest.mark.parametrize("with_problem", [False, True])
def test_cycle_warm_start_matches_jax(model, with_problem):
    """The shifted warm start (xs, us, vs, lams), the tail rolled out through
    the last stage's dynamics (its schedule row) and the terminal costate
    refreshed with ``problem=``."""
    rng = np.random.default_rng(3)
    if model == "lqr":
        jp = _jax_lqr(nsteps=8, u_bound=0.3)
        tp = _port_lqr(jp, 8)
    else:
        from examples.centroidal_locomotion import create_centroidal_problem
        jp, tp = create_centroidal_problem(), _centroidal()
    N, nx, nu, nc = tp.nsteps, tp.space.nx, tp.nu, tp.nc
    B = 2
    xs, us = rng.standard_normal((B, N + 1, nx)), rng.standard_normal((B, N, nu))
    vs, lams = rng.standard_normal((B, N, nc)), rng.standard_normal((B, N + 1, nx))
    got = mpc.cycle_warm_start(*(torch.tensor(a) for a in (xs, us, vs, lams)),
                               problem=tp if with_problem else None)
    for b in range(B):
        ref = jutils.cycle_warm_start(*(jnp.asarray(a[b]) for a in (xs, us, vs, lams)),
                                      problem=jp if with_problem else None)
        for g, r, name in zip(got, ref, ("xs", "us", "vs", "lams")):
            _close(g[b], r, msg=name)


# ---------------------------------------------------------------- solves


def _solve(problem, cfg, **init):
    return at.solvers.solve(problem, at.solvers.ProxDDPConfig(**cfg), **init)


@pytest.mark.parametrize("case", ["free", "box"])
def test_lqr_warm_cycles_match_jax(case):
    """Cold solve, then 6 warm cycles at mu_init 1e-8 with the repaired tail:
    each cycle's iteration count and flag exactly, xs and us to 1e-8, and
    (as the JAX test asserts) every cycle converged, at most 2 iterations
    without the bound."""
    ref = _fixture(f"lqr_{case}_")
    tool = _tool()
    prob = convert.linear_problem_from_numpy(
        {k[5:]: v for k, v in ref.items() if k.startswith("prob_")}, 20, device="cpu")
    res = _solve(prob, dict(tol=1e-8, max_iters=tool.LQR_CASES[case]["cold_iters"]))
    _close(res.xs[0], ref["cold_xs"], TOL_SOLVE, "cold xs")
    assert int(res.num_iters[0]) == int(ref["cold_num_iters"])
    x = prob.x0
    dyn = mpc.stage_dynamics(prob, 0)
    for k in range(tool.N_CYCLES):
        x = dyn.forward(prob.space, x, res.us[:, 0])
        w = mpc.cycle_warm_start(res.xs, res.us, res.vs, res.lams, problem=prob)
        res = _solve(dataclasses.replace(prob, x0=x), tool.LQR_WARM, xs_init=w[0],
                     us_init=w[1], vs_init=w[2], lams_init=w[3])
        assert int(res.num_iters[0]) == int(ref["num_iters"][k]), k
        assert bool(res.conv[0]) == bool(ref["conv"][k]) and bool(res.conv[0])
        _close(x[0], ref["x"][k], TOL_SOLVE, f"x {k}")
        _close(res.xs[0], ref["xs"][k], TOL_SOLVE, f"xs {k}")
        _close(res.us[0], ref["us"][k], TOL_SOLVE, f"us {k}")
    if case == "free":
        assert int(ref["num_iters"].max()) <= 2


def test_se2_mpc_cycles_match_jax():
    """The SE(2) receding-horizon loop (bench_mpc.py's protocol, float64):
    the cold solve and 6 cycles for 4 scenarios in one batch, each held to
    the JAX package's single-scenario cycles."""
    ref = _fixture("se2_")
    tool = _tool()
    x0s = torch.tensor(ref["x0s"])
    _close(x0s, mpc_se2.se2_initial_states(4, tool.SE2_SEED, device="cpu").double())
    prob = dataclasses.replace(create_se2_problem(tool.SE2_N, torch.float64, "cpu"), x0=x0s)
    res = _solve(prob, mpc_se2.COLD)
    warm = at.solvers.ProxDDPConfig(**mpc_se2.WARM)
    x = x0s
    for k in range(tool.N_CYCLES + 1):
        if k:
            x, res = mpc_se2.mpc_cycle(prob, warm, x, res.xs, res.us)
        assert torch.equal(res.num_iters, torch.tensor(ref["num_iters"][:, k])), k
        assert torch.equal(res.conv, torch.tensor(ref["conv"][:, k])), k
        _close(x, ref["x"][:, k], TOL_SOLVE, f"x {k}")
        _close(res.xs, ref["xs"][:, k], TOL_SOLVE, f"xs {k}")
        _close(res.us, ref["us"][:, k], TOL_SOLVE, f"us {k}")


def test_run_cycles_chains_mpc_cycle():
    """``run_cycles`` is ``mpc_cycle`` chained: its per-cycle records and
    final state equal a hand loop's (float32, the bench's type), and the
    problem holds the latest state."""
    prob = mpc_se2.create_mpc_problem(batch=3, nsteps=20, device="cpu", seed=4)
    cold = _solve(prob, mpc_se2.COLD)
    warm = at.solvers.ProxDDPConfig(**mpc_se2.WARM)
    x_start = prob.x0.clone()
    x, xs, us, prims, iters, convs = mpc_se2.run_cycles(prob, warm, x_start, cold.xs,
                                                        cold.us, 3)
    assert prims.shape == iters.shape == convs.shape == (3, 3)
    assert torch.equal(prob.x0, x)  # the problem holds the last state
    hx, hres = x_start, cold
    for k in range(3):
        hx, hres = mpc_se2.mpc_cycle(prob, warm, hx, hres.xs, hres.us)
        assert torch.equal(iters[:, k], hres.num_iters)
    assert torch.equal(x, hx) and torch.equal(xs, hres.xs)


@pytest.mark.slow
def test_fixture_matches_a_live_jax_solve():
    tool = _tool()
    with np.load(FIXTURE) as f:
        stored = {k: f[k] for k in f.files}
    live = {}
    for case in tool.LQR_CASES:
        live.update({f"lqr_{case}_{k}": v for k, v in tool.lqr_reference(case).items()})
    live.update({f"se2_{k}": v for k, v in tool.se2_reference().items()})
    assert set(live) == set(stored)
    for k, v in live.items():
        np.testing.assert_allclose(v, stored[k], rtol=0, atol=1e-9, err_msg=k)

