"""The port's utilities (problem interchange, NLP export, profiling,
plotting) and its gar examples against the JAX package, float64 on the CPU.

Interchange: the archives of ``tests/data`` (``tools/make_reference_
instances.py``, independent of both packages' constructors) load in the
port and solve as in ``tests/test_interchange.py``; a problem saved by
either package loads in the other and evaluates alike, stage-varying costs
included; the gar-level LQ archives too. NLP: the box LQR of
``tests/test_nlp_export.py`` exported and solved by scipy against the
port's ProxDDP and the JAX export. The gar examples' outputs against the
JAX examples' on the JAX examples' own problems. The JAX package's solves,
exports and example outputs are read from ``tests/data/torch_utils_ref.npz``
(``tools/torch_utils_fixture.py``; the ``slow`` test recomputes them).
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligator_tpu import gar as jgar
from aligator_tpu._pytree import replace as jreplace
from aligator_tpu.core import problem as jproblem
from aligator_tpu.utils import interchange as jinter

import aligator_tpu_torch as at
from aligator_tpu_torch import convert
from aligator_tpu_torch import core as tcore
from aligator_tpu_torch.core import problem as tproblem
from aligator_tpu_torch.examples import gar_cyclic_lqr, gar_lqr, gar_lqr_join
from aligator_tpu_torch.examples.lqr import make_lqr_problem
from aligator_tpu_torch.examples.se2_car import create_se2_problem
from aligator_tpu_torch.utils import interchange, nlp, plotting, profiling

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
FIXTURE = DATA / "torch_utils_ref.npz"


def _fixture(prefix=""):
    with np.load(FIXTURE) as f:
        return {k[len(prefix):]: f[k] for k in f.files if k.startswith(prefix)}


def _tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_utils_fixture", ROOT / "tools" / "torch_utils_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max()) if got.size else 0.0


def _traj(problem, seed):
    """A random trajectory ``(xs (N+1, nx), us (N, nu))`` on the problem's
    space, numpy."""
    rng = np.random.default_rng(seed)
    N, nu = problem.nsteps, problem.nu
    x0 = problem.x0.reshape(-1, problem.x0.shape[-1])[0]
    sp = problem.space
    dx = torch.tensor(0.1 * rng.standard_normal((N + 1, sp.ndx)), dtype=x0.dtype)
    xs = sp.integrate(x0.expand(N + 1, -1), dx)
    return xs.numpy(), rng.standard_normal((N, nu))


def _evaluations_match(tprob, jprob, seed=0, tol=1e-12):
    xs, us = _traj(tprob, seed)
    dj = jproblem.evaluate(jprob, jnp.asarray(xs), jnp.asarray(us))
    dt = tproblem.evaluate(tprob, torch.tensor(xs)[None], torch.tensor(us)[None])
    for k in ("stage_costs", "term_cost", "init_res", "dyn_res", "cstr_vals",
              "term_cstr_vals"):
        assert _rel(getattr(dt, k)[0], getattr(dj, k)) <= tol, k
    return dt


# ---------------------------------------------------------------- interchange


@pytest.mark.parametrize("name,mu0,tol,iters", [
    ("ref_lqr", 1e-4, 1e-8, 20), ("ref_lqr_bounded", 1e-1, 1e-8, 20),
    ("ref_lqr_term_cstr", 1e-4, 1e-8, 20), ("ref_se2_car", 1e-2, 1e-6, 12)])
def test_reference_instances_load_and_solve(name, mu0, tol, iters):
    """The checked-in instances load in the port as in the JAX package (the
    same evaluation), and the port's ProxDDP converges on them to the
    solution of the JAX package's NumPy oracle on the JAX-loaded instance
    (1e-6; the fixture), as tests/test_interchange.py holds the JAX
    solver."""
    tprob = interchange.load_problem(DATA / f"{name}.npz", device="cpu")
    _evaluations_match(tprob, jinter.load_problem(DATA / f"{name}.npz"))
    res = at.solvers.solve(tprob, at.solvers.ProxDDPConfig(tol=tol, mu_init=mu0,
                                                          max_iters=iters))
    ref = _fixture(f"inst_{name}_")
    assert bool(res.conv[0]) and bool(ref["conv"])
    assert _rel(res.us[0], ref["us"]) < 1e-6 and _rel(res.xs[0], ref["xs"]) < 1e-6


def test_problems_cross_between_the_packages(tmp_path):
    """The SE(2) car with a control box saved by the JAX package loads in
    the port, the port's saved loads in the JAX package, each evaluating as
    the problem it came from; both archives hold the same manifest."""
    from examples.se2_car import create_se2_problem as jcreate

    jprob = jcreate(nsteps=12, dtype=jnp.float64, u_bound=0.5)
    jinter.save_problem(tmp_path / "jax.npz", jprob)
    from_jax = interchange.load_problem(tmp_path / "jax.npz", device="cpu")
    _evaluations_match(from_jax, jprob)
    tprob = create_se2_problem(nsteps=12, dtype=torch.float64, device="cpu", u_bound=0.5)
    interchange.save_problem(tmp_path / "port.npz", tprob)
    from_port = jinter.load_problem(tmp_path / "port.npz")
    _evaluations_match(tprob, from_port)
    _evaluations_match(tprob, jprob)
    # the round trip in the port keeps every leaf
    again = interchange.load_problem(tmp_path / "port.npz", device="cpu")
    for a, b in zip(_leaves(tprob), _leaves(again)):
        assert torch.equal(a, b)
    assert _manifest(tmp_path / "jax.npz") == _manifest(tmp_path / "port.npz")


def _manifest(path):
    """An archive's manifest with each array reference replaced by its
    array's values (the two packages name the arrays differently)."""
    import json

    with np.load(path) as z:
        def walk(o):
            if isinstance(o, dict):
                return {k: walk(v) for k, v in o.items()}
            if isinstance(o, list):
                return [walk(v) for v in o]
            if isinstance(o, str) and o.startswith("@"):
                return z[o[1:]].tolist()
            return o

        return walk(json.loads(str(z["manifest"])))


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, tuple):
        return [t for o in obj for t in _leaves(o)]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _leaves(getattr(obj, f.name))]
    return []


def _varying_problems(N=8):
    """tests/test_interchange.py's stage-varying state target, in both
    packages."""
    targets = np.linspace(0.0, 1.0, N)[:, None] * np.ones((N, 2))
    from aligator_tpu import core as jcore

    eye = jnp.eye(2)
    jdyn = jcore.LinearDiscreteDynamics(A=eye, B=eye, c=jnp.zeros(2))
    jstage = jcore.make_stage(jcore.QuadraticStateCost(jnp.zeros(2), eye), jdyn,
                              jcore.VectorSpace(2), 2)
    jstages = jcore.replicate_stage(jstage, N)
    jstages = jreplace(jstages, cost=jreplace(jstages.cost, residual=jreplace(
        jstages.cost.residual, target=jnp.asarray(targets))))
    jprob = jcore.make_problem(jnp.zeros(2), jstage, N,
                               jcore.QuadraticStateCost(jnp.ones(2), eye), stages=jstages)
    teye = torch.eye(2, dtype=torch.float64)
    tdyn = tcore.LinearDiscreteDynamics(A=teye, B=teye, c=torch.zeros(2, dtype=torch.float64))
    tstage = tcore.make_stage(tcore.QuadraticStateCost(torch.tensor(targets), teye), tdyn,
                              tcore.VectorSpace(2), 2)
    tprob = tcore.make_problem(torch.zeros(2, dtype=torch.float64), tstage, N,
                               tcore.QuadraticStateCost(torch.ones(2, dtype=torch.float64),
                                                        teye))
    return tprob, jprob


def test_stage_varying_costs_cross_between_the_packages(tmp_path):
    """A stage-varying cost target (the port's leaf with a stage axis; the
    JAX package's stacked stages) is stored stacked by either package and
    restored as a stacked stage model by either."""
    tprob, jprob = _varying_problems()
    d = _evaluations_match(tprob, jprob)
    assert float(d.stage_costs.std()) > 1e-3
    interchange.save_problem(tmp_path / "port.npz", tprob)
    jinter.save_problem(tmp_path / "jax.npz", jprob)
    from_port = jinter.load_problem(tmp_path / "port.npz")
    from_jax = interchange.load_problem(tmp_path / "jax.npz", device="cpu")
    assert from_jax.stages.nstack == 8
    _evaluations_match(tprob, from_port)
    _evaluations_match(from_jax, jprob)
    _evaluations_match(interchange.load_problem(tmp_path / "port.npz", device="cpu"), jprob)


def test_lqr_archives_cross_between_the_packages(tmp_path):
    """save_lqr / load_lqr: a JAX problem (with θ blocks) saved by the JAX
    package loads in the port with its knots equal; the port's, saved, loads
    in the JAX package equal."""
    src = at.gar.lqr_problem.random_convex_problem(np.random.default_rng(3), 1, 10, 4, 2, 1,
                                                   device="cpu")
    src = dataclasses.replace(src, knots=at.gar.add_parameterization(src.knots, 2))
    jp = jgar.LQRProblem(
        knots=jgar.LQRKnots(**{k: jnp.asarray(getattr(src.knots, k)[0].numpy())
                               for k in interchange._LQR_FIELDS + interchange._LQR_TH_FIELDS}),
        G0=jnp.asarray(src.G0[0].numpy()), g0=jnp.asarray(src.g0[0].numpy()))
    jinter.save_lqr(tmp_path / "jax.npz", jp)
    tp = interchange.load_lqr(tmp_path / "jax.npz", device="cpu")
    for k in interchange._LQR_FIELDS + interchange._LQR_TH_FIELDS + ("G0", "g0"):
        src = jp if k in ("G0", "g0") else jp.knots
        dst = tp if k in ("G0", "g0") else tp.knots
        assert torch.equal(getattr(dst, k)[0], torch.tensor(np.asarray(getattr(src, k)))), k
    interchange.save_lqr(tmp_path / "port.npz", tp)
    back = jinter.load_lqr(tmp_path / "port.npz")
    for k in interchange._LQR_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back.knots, k)),
                                      np.asarray(getattr(jp.knots, k)), err_msg=k)
    # a batch keeps its batch axis through the port's own round trip
    batch = at.gar.lqr_problem.random_convex_problem(np.random.default_rng(1), 3, 5, 2, 1, 1,
                                                     device="cpu")
    interchange.save_lqr(tmp_path / "batch.npz", batch)
    again = interchange.load_lqr(tmp_path / "batch.npz", device="cpu")
    assert torch.equal(again.knots.Q, batch.knots.Q) and torch.equal(again.g0, batch.g0)


# ---------------------------------------------------------------- NLP export


def test_nlp_export_matches_jax():
    """to_nlp's shapes and values (objective, gradient, constraints and
    their Jacobians at a random z) against the JAX export on the box LQR
    (N = 10, |u| <= 0.2; the fixture)."""
    tprob = make_lqr_problem(nsteps=10, u_bound=0.2, device="cpu")
    N = 10
    fns = nlp.to_nlp(tprob, tprob.x0.expand(N + 1, -1), torch.zeros(N, 1, dtype=torch.float64))
    ref = _fixture("nlp_")
    assert fns["nz"] == ref["z"].shape[0] == 11 * 2 + 10
    tz = torch.tensor(ref["z"])
    assert fns["objective"](tz).shape == ()
    assert fns["cons_eq"](tz).shape == (22,) and fns["cons_ineq"](tz).shape == (20,)
    assert fns["jac_eq"](tz).shape == (22, 32) and fns["jac_ineq"](tz).shape == (20, 32)
    for k in ("objective", "grad", "cons_eq", "jac_eq", "cons_ineq", "jac_ineq"):
        assert _rel(fns[k](tz), ref[k]) < 1e-12, k


def test_scipy_nlp_matches_proxddp_box_lqr():
    """scipy's SLSQP on the exported box LQR (N = 20, |u| <= 0.15) finds
    the port's ProxDDP solution (1e-6), with the bound active."""
    prob = make_lqr_problem(nsteps=20, u_bound=0.15, device="cpu")
    res = at.solvers.solve(prob, at.solvers.ProxDDPConfig(tol=1e-10, mu_init=1e-2,
                                                          max_iters=200))
    assert bool(res.conv[0])
    xs0 = prob.x0.expand(21, -1)
    xs, us, r = nlp.solve_scipy(prob, xs0, torch.zeros(20, 1, dtype=torch.float64), tol=1e-12)
    assert r.success, r.message
    assert np.abs(us.numpy() - res.us[0].numpy()).max() < 1e-6
    assert np.abs(xs.numpy() - res.xs[0].numpy()).max() < 1e-6
    assert float(res.us.abs().max()) > 0.15 - 1e-8


# ---------------------------------------------------------------- profiling, plotting


def test_profiling_zones_show_in_a_trace(tmp_path):
    """zone and annotate ranges appear among a torch.profiler trace's events,
    and trace_to writes a Chrome trace under its directory."""

    @profiling.annotate()
    def step(x):
        return x @ x

    @profiling.annotate("named_zone")
    def other(x):
        return x + 1

    x = torch.ones(4, 4)
    with profiling.trace_to(str(tmp_path)) as prof:
        with profiling.zone("outer_zone"):
            other(step(x))
    names = {e.name for e in prof.events()}
    assert {"outer_zone", "named_zone"} <= names
    assert any(n.endswith("step") for n in names)
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1 and "outer_zone" in traces[0].read_text()


def test_plotting_draws_with_agg(tmp_path):
    """The four plot functions draw a solve's history, controls, velocities
    and SE(2) poses (tensors) under the Agg backend."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    prob = create_se2_problem(nsteps=10, dtype=torch.float64, device="cpu")
    res = at.solvers.solve(prob, at.solvers.ProxDDPConfig(tol=1e-6, mu_init=1e-2,
                                                          max_iters=10, record_history=True))
    fig, axes = plt.subplots(2, 2)
    ax = plotting.plot_convergence(res.history[0], axes[0, 0], num_iters=res.num_iters[0])
    assert len(ax.lines) == 2 and len(ax.lines[0].get_xdata()) == int(res.num_iters[0])
    t = torch.arange(11) * 0.05
    assert len(plotting.plot_controls_traj(t, res.us[0], axes[0, 1]).lines) == 2
    assert len(plotting.plot_velocity_traj(t, res.xs[0], axes[1, 0]).lines) == 4
    rect = plotting.plot_se2_pose(res.xs[0, 0], axes[1, 1])
    assert rect in axes[1, 1].patches
    fig.savefig(tmp_path / "plots.png")
    plt.close(fig)
    assert (tmp_path / "plots.png").stat().st_size > 0


# ---------------------------------------------------------------- gar examples


def _port(prefix):
    """A fixture problem (its knot arrays) as the port's batch of one."""
    ref = _fixture(prefix + "_")
    arrays = {k: ref[k][None] for k in convert.KNOT_FIELDS + ("G0", "g0")}
    return convert.lqr_problem_from_numpy(arrays, device="cpu")


def _outputs(prefix):
    ref = _fixture(prefix)
    return [ref[str(i)] for i in range(len(ref))]


def test_gar_lqr_matches_jax():
    """examples/gar_lqr.py on its own problem (N = 23, (4, 2, 1), explicit
    E): the serial solve, its KKT residuals, the 4-leg parallel solve, the
    dense oracle and the θ sensitivities against the JAX example's (the
    fixture)."""
    out = gar_lqr.run(_port("lqr"))
    serial = _outputs("lqr_serial_")
    # the dense oracle against the serial solve: the same KKT system
    for name, ref in (("serial", serial), ("parallel", _outputs("lqr_parallel_")),
                      ("dense", serial)):
        for g, r in zip(out[name], ref):
            assert _rel(g[0], r) < 1e-9, name
    for e in out["kkt"]:
        assert float(e.max()) < 1e-8
    ref = _fixture("lqr_")
    assert _rel(out["th_grad"][0], ref["th_grad"]) < 1e-9
    assert _rel(out["th_hess"][0], ref["th_hess"]) < 1e-9


def test_gar_lqr_join_matches_jax():
    """examples/gar_lqr_join.py's split_and_join on its problem (T = 10,
    (2, 1, 0), t0 = 5, μ = 1e-8) against the JAX example's, and against
    the joint solve (the fixture)."""
    got = gar_lqr_join.split_and_join(_port("join"), 5, 1e-8)
    for g, r in zip(got, _outputs("join_out_")):
        assert _rel(g[0], r) < 1e-12
    joint = _outputs("join_joint_")
    for k in (0, 1, 3):
        assert _rel(got[k][0], joint[k]) < 1e-6


def test_gar_cyclic_lqr_matches_jax():
    """examples/gar_cyclic_lqr.py: solve_cyclic on the JAX example's
    problem gives its orbit (x_0 = x_T), controls, multipliers and θ (the
    fixture); create_cyclic_problem builds that problem but for its random
    drift and control gradients (a numpy generator), which keep their
    ranges, and its orbit is periodic too."""
    got = gar_cyclic_lqr.solve_cyclic(_port("cyc"))
    for g, r in zip(got, _outputs("cyc_out_")):
        assert _rel(g[0], r) < 1e-12
    assert float((got[0][0, 0] - got[0][0, -1]).abs().max()) < 1e-6
    tp = gar_cyclic_lqr.create_cyclic_problem(T=30, device="cpu")
    ref = _fixture("cyc_")
    for k in convert.KNOT_FIELDS:
        if k not in ("r", "f"):
            assert torch.equal(getattr(tp.knots, k)[0], torch.tensor(ref[k])), k
    assert float(tp.knots.r.abs().max()) <= 0.01 and float(tp.knots.f.abs().max()) <= 0.1
    xs = gar_cyclic_lqr.solve_cyclic(tp)[0]
    assert float((xs[0, 0] - xs[0, -1]).abs().max()) < 1e-6


@pytest.mark.slow
def test_fixture_matches_a_live_jax_run():
    """The fixture's references recomputed live by the JAX package."""
    live = _tool().references()
    ref = _fixture()
    assert live.keys() == ref.keys()
    for k, v in live.items():
        np.testing.assert_allclose(ref[k], v, rtol=1e-12, atol=1e-12, err_msg=k)
