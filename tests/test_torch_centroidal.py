"""The port's centroidal models against the JAX package, float64 on the CPU.

The centroidal, continuous-centroidal, kinodynamics and wheeled
inverted pendulum ODEs (``xdot`` and its Jacobians), ``DirectSumDynamics``,
the eight centroidal residuals and the wrapper (value and Jacobians, with a
stage-varying schedule over a ``(B, N)`` block) against the JAX package's
functions on the same numpy inputs, to 1e-10 relative; each example's
problem, one stage model with stage-varying leaves, against the JAX
package's stacked stages at its evaluation and derivatives, and its solves
(the iterate after 4 iterations to 1e-9, the converged flag and iteration
count at the published budget) against ``tests/data/torch_centroidal_ref.npz``,
written by ``tools/torch_centroidal_fixture.py`` (the ``slow`` test reruns
its small group live). The card's solves are checked by
tests/test_torch_cuda.py and chip_smoke.py.
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
from aligator_tpu import core as jcore
from aligator_tpu.modelling import centroidal as jres
from aligator_tpu.modelling.dynamics import centroidal as jdyn
from aligator_tpu_torch import convert, core
from aligator_tpu_torch.core import problem as problem_mod
from aligator_tpu_torch.examples import (centroidal_locomotion, continuous_centroidal,
                                         solo_kinodynamics, wheeled_inverted_pendulum)
from aligator_tpu_torch.modelling import centroidal as tres
from aligator_tpu_torch.modelling.dynamics import centroidal as tdyn
from aligator_tpu_torch.modelling.dynamics.direct_sum import direct_sum

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_centroidal_ref.npz"
TOL = 1e-10
TOL_ITER = 1e-9
B, N, NK = 2, 5, 4


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_centroidal_fixture", ROOT / "tools" / "torch_centroidal_fixture.py")
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


def _schedule(rng):
    """A (N, nk) activity with every pattern, (N, nk, 3) points."""
    active = (rng.uniform(size=(N, NK)) > 0.4).astype(float)
    active[0] = 1.0
    return active, rng.standard_normal((N, NK, 3))


def _per_stage(fn, active, points, x, u):
    """``fn(cmap_t, x, u)`` of the JAX package on every (b, t): the schedule
    row t, as the JAX package's stacked stages hold it."""
    def stage(a, p, xt, ut):
        return fn(jdyn.ContactMap(points=p, active=a), xt, ut)

    over_t = jax.vmap(stage, in_axes=(0, 0, 0, 0))
    return jax.vmap(over_t, in_axes=(None, None, 0, 0))(
        jnp.asarray(active), jnp.asarray(points), jnp.asarray(x), jnp.asarray(u))


def _jax_jacobians(fn, active, points, x, u):
    def jx(c, xt, ut):
        return jax.jacfwd(lambda y: fn(c, y, ut))(xt)

    def ju(c, xt, ut):
        return jax.jacfwd(lambda v: fn(c, xt, v))(ut)

    return (_per_stage(jx, active, points, x, u), _per_stage(ju, active, points, x, u))


# ---------------------------------------------------------------- ODEs


ODES = {
    "centroidal3": (9, 12, lambda c, m, g: jdyn.CentroidalFwdDynamics(
        contact_map=c, mass=m, gravity=g), lambda c, m, g: tdyn.CentroidalFwdDynamics(
        contact_map=c, mass=m, gravity=g)),
    "centroidal6": (9, 24, lambda c, m, g: jdyn.CentroidalFwdDynamics(
        contact_map=c, mass=m, gravity=g, force_size=6),
        lambda c, m, g: tdyn.CentroidalFwdDynamics(contact_map=c, mass=m, gravity=g,
                                                   force_size=6)),
    "continuous": (21, 12, lambda c, m, g: jdyn.ContinuousCentroidalFwdDynamics(
        contact_map=c, mass=m, gravity=g),
        lambda c, m, g: tdyn.ContinuousCentroidalFwdDynamics(contact_map=c, mass=m,
                                                             gravity=g)),
    "kinodynamics": (25, 20, lambda c, m, g: jdyn.KinodynamicsFwdDynamics(
        contact_map=c, mass=m, gravity=g, n_joints=8),
        lambda c, m, g: tdyn.KinodynamicsFwdDynamics(contact_map=c, mass=m, gravity=g,
                                                     n_joints=8)),
}


@pytest.mark.parametrize("name", list(ODES))
def test_centroidal_odes_match_jax(name):
    """xdot and its closed-form Jacobians, a schedule over the (B, N) block;
    the explicit Euler step's (A, B, E) from them."""
    nx, nu, jmake, tmake = ODES[name]
    rng = np.random.default_rng(len(name))
    active, points = _schedule(rng)
    x, u = rng.standard_normal((B, N, nx)), rng.standard_normal((B, N, nu))
    m, g = 10.5, np.array([0.0, 0.0, -9.81])
    space = core.VectorSpace(nx)
    tode = tmake(tdyn.ContactMap(points=torch.tensor(points), active=torch.tensor(active)),
                 torch.tensor(m, dtype=torch.float64), torch.tensor(g))

    def jfn(c, xt, ut):
        return jmake(c, jnp.asarray(m), jnp.asarray(g)).xdot(jcore.VectorSpace(nx), xt, ut)

    tx, tu = torch.tensor(x), torch.tensor(u)
    _close(tode.xdot(space, tx, tu), _per_stage(jfn, active, points, x, u), msg="xdot")
    Jx, Ju = tode.xdot_jacobians(space, tx, tu)
    rx, ru = _jax_jacobians(jfn, active, points, x, u)
    _close(Jx, rx, msg="Jx")
    _close(Ju, ru, msg="Ju")
    h = 0.01
    dyn = at.modelling.IntegratorEuler(ode=tode, timestep=torch.tensor(h, dtype=torch.float64))
    A, Bm, E = dyn.jacobians(space, tx, tu, tx)
    _close(A, np.eye(nx) + h * rx, msg="A")
    _close(Bm, h * ru, msg="B")
    _close(E, -np.broadcast_to(np.eye(nx), E.shape), msg="E")


def test_wheeled_inverted_pendulum_ode_matches_jax():
    rng = np.random.default_rng(4)
    x, u = rng.standard_normal((B, N, 4)), rng.standard_normal((B, N, 1))
    p = wheeled_inverted_pendulum.PARAMS
    jode = jdyn.WheeledInvertedPendulumDynamics(**{k: jnp.asarray(v) for k, v in p.items()})
    tode = tdyn.WheeledInvertedPendulumDynamics(**{k: torch.tensor(v, dtype=torch.float64)
                                                  for k, v in p.items()})
    ref = jax.vmap(jax.vmap(lambda a, b: jode.xdot(jcore.VectorSpace(4), a, b)))(
        jnp.asarray(x), jnp.asarray(u))
    _close(tode.xdot(core.VectorSpace(4), torch.tensor(x), torch.tensor(u)), ref)
    # its RK2 step's Jacobians, forward-mode in both packages
    from aligator_tpu.modelling import IntegratorRK2 as JRK2
    jd = JRK2(ode=jode, timestep=jnp.asarray(0.02))
    td = at.modelling.IntegratorRK2(ode=tode, timestep=torch.tensor(0.02, dtype=torch.float64))
    y = rng.standard_normal((B, N, 4))
    got = td.jacobians(core.VectorSpace(4), torch.tensor(x), torch.tensor(u), torch.tensor(y))
    ref = jax.vmap(jax.vmap(lambda a, b, c: jd.jacobians(jcore.VectorSpace(4), a, b, c)))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(y))
    for g_, r_ in zip(got, ref):
        _close(g_, r_)


def test_direct_sum_dynamics_matches_jax():
    """A linear system ⊕ the pendulum's RK2 step: the next state and its
    Jacobians."""
    from aligator_tpu.modelling import IntegratorRK2 as JRK2
    from aligator_tpu.modelling.dynamics.direct_sum import direct_sum as jdirect_sum
    rng = np.random.default_rng(5)
    A1, B1, c1 = rng.standard_normal((3, 3)), rng.standard_normal((3, 2)), rng.standard_normal(3)
    p = wheeled_inverted_pendulum.PARAMS
    jd, jspace, jnu = jdirect_sum(
        jcore.LinearDiscreteDynamics(A=jnp.asarray(A1), B=jnp.asarray(B1), c=jnp.asarray(c1)),
        jcore.VectorSpace(3), 2,
        JRK2(ode=jdyn.WheeledInvertedPendulumDynamics(**{k: jnp.asarray(v) for k, v in
                                                          p.items()}),
             timestep=jnp.asarray(0.02)), jcore.VectorSpace(4), 1)
    td, tspace, tnu = direct_sum(
        core.LinearDiscreteDynamics(A=torch.tensor(A1), B=torch.tensor(B1), c=torch.tensor(c1)),
        core.VectorSpace(3), 2,
        at.modelling.IntegratorRK2(ode=tdyn.WheeledInvertedPendulumDynamics(
            **{k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()}),
            timestep=torch.tensor(0.02, dtype=torch.float64)),
        core.VectorSpace(4), 1)
    assert (tspace.nx, tnu) == (jspace.nx, jnu) == (7, 3)
    x, u, y = (rng.standard_normal((B, N, n)) for n in (7, 3, 7))
    fwd = jax.vmap(jax.vmap(lambda a, b: jd.forward(jspace, a, b)))
    _close(td.forward(tspace, torch.tensor(x), torch.tensor(u)),
           fwd(jnp.asarray(x), jnp.asarray(u)))
    got = td.jacobians(tspace, torch.tensor(x), torch.tensor(u), torch.tensor(y))
    ref = jax.vmap(jax.vmap(lambda a, b, c: jd.jacobians(jspace, a, b, c)))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(y))
    for g_, r_ in zip(got, ref):
        _close(g_, r_)


# ---------------------------------------------------------------- residuals


def _residuals(rng, active, points):
    """Pairs (JAX factory of the schedule row, port residual with the
    stage-varying leaves) and the state and control sizes they take."""
    mass, grav = 10.5, np.array([0.0, 0.0, -9.81])
    ref3 = rng.standard_normal(3)
    a_k = active[:, 1]

    def t(a):
        return torch.tensor(np.asarray(a))

    tmap = tdyn.ContactMap(points=t(points), active=t(active))
    return {
        "com": (lambda c, k: jres.CentroidalCoMResidual(c_ref=jnp.asarray(ref3)),
                tres.CentroidalCoMResidual(c_ref=t(ref3))),
        "linear_momentum": (lambda c, k: jres.LinearMomentumResidual(h_ref=jnp.asarray(ref3)),
                            tres.LinearMomentumResidual(h_ref=t(ref3))),
        "angular_momentum": (lambda c, k: jres.AngularMomentumResidual(
            L_ref=jnp.asarray(ref3)), tres.AngularMomentumResidual(L_ref=t(ref3))),
        "centroidal_acceleration": (
            lambda c, k: jres.CentroidalAccelerationResidual(
                contact_map=c, mass=jnp.asarray(mass), gravity=jnp.asarray(grav),
                a_ref=jnp.asarray(ref3)),
            tres.CentroidalAccelerationResidual(contact_map=tmap, mass=t(mass),
                                                gravity=t(grav), a_ref=t(ref3))),
        "angular_acceleration": (
            lambda c, k: jres.AngularAccelerationResidual(contact_map=c, ref=jnp.asarray(ref3)),
            tres.AngularAccelerationResidual(contact_map=tmap, ref=t(ref3))),
        "friction_cone": (
            lambda c, k: jres.CentroidalFrictionConeResidual(
                mu=jnp.asarray(0.8), eps=jnp.asarray(1e-3), active=k, contact_id=1),
            tres.CentroidalFrictionConeResidual(mu=t(0.8), eps=t(1e-3), active=t(a_k),
                                                contact_id=1)),
        "wrench_cone": (
            lambda c, k: jres.CentroidalWrenchConeResidual(
                mu=jnp.asarray(0.7), half_length_x=jnp.asarray(0.1),
                half_length_y=jnp.asarray(0.05), contact_id=1),
            tres.CentroidalWrenchConeResidual(mu=t(0.7), half_length_x=t(0.1),
                                              half_length_y=t(0.05), contact_id=1)),
        "wrapper": (
            lambda c, k: jres.CentroidalWrapperResidual(
                inner=jres.CentroidalFrictionConeResidual(
                    mu=jnp.asarray(0.8), eps=jnp.asarray(1e-3), active=k, contact_id=2)),
            tres.CentroidalWrapperResidual(inner=tres.CentroidalFrictionConeResidual(
                mu=t(0.8), eps=t(1e-3), active=t(active[:, 2]), contact_id=2))),
    }


@pytest.mark.parametrize("name", ["com", "linear_momentum", "angular_momentum",
                                  "centroidal_acceleration", "angular_acceleration",
                                  "friction_cone", "wrench_cone", "wrapper"])
def test_centroidal_residuals_match_jax(name):
    """Value and Jacobians over a (B, N) block, the schedule (activity,
    points, the cone's gate) stage-varying; the wrapper on the 21-D
    force-in-state of the continuous gait."""
    rng = np.random.default_rng(11)
    active, points = _schedule(rng)
    jmake, tfun = _residuals(rng, active, points)[name]
    nx, nu = (21, 12) if name == "wrapper" else (9, 24)
    x, u = rng.standard_normal((B, N, nx)), rng.standard_normal((B, N, nu))
    gate = active[:, 1] if name == "friction_cone" else active[:, 2]
    space = core.VectorSpace(nx)

    def stage(a, p, k, xt, ut, what):
        f = jmake(jdyn.ContactMap(points=p, active=a), k)
        sp = jcore.VectorSpace(nx)
        if what == "value":
            return f.value(sp, xt, ut)
        return jax.jacfwd(lambda y: f.value(sp, y, ut))(xt) if what == "jx" else \
            jax.jacfwd(lambda v: f.value(sp, xt, v))(ut)

    def ref(what):
        over_t = jax.vmap(lambda a, p, k, xt, ut: stage(a, p, k, xt, ut, what))
        return jax.vmap(over_t, in_axes=(None, None, None, 0, 0))(
            jnp.asarray(active), jnp.asarray(points), jnp.asarray(gate), jnp.asarray(x),
            jnp.asarray(u))

    tx, tu = torch.tensor(x), torch.tensor(u)
    _close(tfun.value(space, tx, tu), ref("value"), msg="value")
    Jx, Ju = tfun.jacobians(space, tx, tu)
    _close(Jx, ref("jx"), msg="Jx")
    _close(Ju, ref("ju"), msg="Ju")
    assert tfun.dim(space, nu) == Jx.shape[-2]


def test_kinodynamics_n_joints_is_metadata():
    """``n_joints`` is a dataclass field of int type, not a tensor leaf: a
    cycled or row-selected model keeps it (the JAX regression of
    tests/test_modelling.py:172)."""
    prob = solo_kinodynamics.create_kinodynamics_problem(device="cpu")
    ode = prob.stages.dynamics.ode
    assert isinstance(ode.n_joints, int) and ode.n_joints == solo_kinodynamics.NJ
    row = core.dynamics_at(prob.stages.dynamics, 3, prob.nsteps).ode
    assert row.n_joints == solo_kinodynamics.NJ and row.contact_map.active.shape == (4,)
    from aligator_tpu_torch.utils import mpc
    assert mpc.cycle_problem(prob).stages.dynamics.ode.n_joints == solo_kinodynamics.NJ


# ---------------------------------------------------------------- problems and solves


PATHS = {
    "wip": (convert.wip_problem_from_numpy, wheeled_inverted_pendulum),
    "centroidal": (convert.centroidal_problem_from_numpy, centroidal_locomotion),
    "kinodynamics": (convert.kinodynamics_problem_from_numpy, solo_kinodynamics),
    "continuous": (convert.continuous_centroidal_problem_from_numpy, continuous_centroidal),
}


def _problem(path, x0=None):
    ref = _fixture(f"{path}_prob_")
    params = dict(ref)
    if x0 is not None:
        params["x0"] = x0
    return PATHS[path][0](params, device="cpu"), ref


@pytest.mark.parametrize("path", list(PATHS))
def test_problem_matches_jax_stacked_stages(path):
    """One stage model with stage-varying leaves against the JAX package's
    stacked stages: costs, residuals, constraints and every derivative at a
    random (xs, us)."""
    prob, ref = _problem(path)
    xs, us = torch.tensor(ref["xs"])[None], torch.tensor(ref["us"])[None]
    data = problem_mod.compute_derivatives(prob, xs, us)
    for k in ("cost", "stage_costs", "dyn_res", "cstr_vals", "term_cstr_vals", "Lx", "Lu",
              "Lxx", "Lxu", "Luu", "A", "B", "E", "cstr_Jx", "cstr_Ju", "term_cstr_Jx"):
        _close(getattr(data, k)[0], ref[k], msg=k)


def _port_solve(path, group, max_iters=None, scale=1.0):
    small = _fixture(f"{path}_{group}_")
    x0 = small["x0"] * scale
    tool = _tool()
    mod = PATHS[path][1]
    if path == "continuous":
        prob = convert.continuous_centroidal_problem_from_numpy(dict(
            _continuous_leaves(tool.SMALL_CC), x0=x0), device="cpu")
        init = dict(xs_init=continuous_centroidal.warm_start(prob))
    else:
        prob, _ = _problem(path, x0)
        init = {}
    assert np.array_equal(small["x0"], tool.initial_states(path, len(x0), int(small["seed"]),
                                                           group == "small"))
    opts = dict(mod.SOLVE_OPTIONS)
    if max_iters is not None:
        opts["max_iters"] = max_iters
    return at.solvers.solve(prob, at.solvers.ProxDDPConfig(**opts), **init), small


def _continuous_leaves(sizes):
    active, points, com_final, w_force, g_first, g_last = \
        continuous_centroidal.make_schedule(**sizes)
    return dict(active=active, points=points, w_force=w_force, g_first=g_first,
                g_last=g_last, mass=continuous_centroidal.MASS,
                gravity=np.asarray(continuous_centroidal.GRAVITY),
                timestep=continuous_centroidal.DT, com_final=com_final,
                mu=continuous_centroidal.MU_FRICTION)


@pytest.mark.parametrize("path", list(PATHS))
def test_solve_first_iterations_match_jax(path):
    """The iterate after 4 iterations, 2 scenarios in one batch, against the
    JAX package's single-scenario solves to 1e-9, or to 100 times the
    distance between the port's solve and its solves from x0·(1 ± 1e-15)
    where that is larger (at μ₀ = 1e-7 the kinodynamics' second iteration
    parts by 2.4e-8 from one ulp in x0), as the free and contact paths are
    held."""
    iters = _tool().SMALL_ITERS
    res, ref = _port_solve(path, "small", max_iters=iters)
    assert res.num_iters.tolist() == ref["it4_num_iters"].tolist()
    spread = [_port_solve(path, "small", max_iters=iters, scale=s)[0]
              for s in (1.0 + 1e-15, 1.0 - 1e-15)]
    for name in ("xs", "us", "lams"):
        got = getattr(res, name)
        scale = max(1.0, got.abs().max().item())
        apart = max((getattr(r, name) - got).abs().max().item() for r in spread) / scale
        _close(got, ref[f"it4_{name}"], max(TOL_ITER, 100 * apart), name)


@pytest.mark.parametrize("path", list(PATHS))
def test_solve_at_the_budget_matches_jax(path):
    """The converged flag and iteration count at the published budget, and
    the solution, against the JAX package's solves; each converged
    scenario's physical checks (the CoM target, forces in the cone on
    active contacts and zero on swing ones, the pendulum upright at its
    goal within its torque bound)."""
    res, ref = _port_solve(path, "small")
    assert res.conv.tolist() == ref["conv"].tolist()
    assert res.num_iters.tolist() == ref["num_iters"].tolist()
    _close(res.xs, ref["xs"], 1e-6, "xs")
    _close(res.us, ref["us"], 1e-6, "us")
    assert bool(res.conv.any())
    mod = PATHS[path][1]
    sizes = _tool().SMALL_CC if path == "continuous" else {}
    ok = mod.solution_checks(res.xs, res.us, **sizes)
    assert all(bool((v | ~res.conv).all()) for v in ok.values()), ok


def test_full_size_fixture_records_the_card_floor():
    """The fixture holds, for chip_smoke.py's centroidal phase, each path's
    first 16 scenarios at the published size: their initial states are the
    port's initial_states at the phase's seed, and the JAX package's
    converged flags from them and from one ulp away."""
    tool = _tool()
    for path in PATHS:
        ref = _fixture(f"{path}_full_")
        assert ref["conv"].shape == (tool.FULL_N,)
        for k in tool.ULP_SCALES:
            assert ref[f"conv_{k}"].shape == (tool.FULL_N,)
        assert np.array_equal(ref["x0"], tool.initial_states(path, tool.FULL_N,
                                                             int(ref["seed"]), False))


@pytest.mark.slow
def test_fixture_matches_a_live_jax_solve():
    """Reruns the small group's JAX solves (one child process each) and the
    problem references against the stored fixture."""
    import subprocess
    import sys
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = str(pathlib.Path(tmp) / "live.npz")
        subprocess.run([sys.executable, str(ROOT / "tools" / "torch_centroidal_fixture.py"),
                        "--only", "prob", "small", "--out", out], check=True, cwd=ROOT)
        with np.load(out) as live, np.load(FIXTURE) as stored:
            for k in live.files:
                np.testing.assert_allclose(live[k], stored[k], rtol=0, atol=1e-9, err_msg=k)


def test_stage_varying_leaves_are_read_per_stage_in_a_rollout():
    """A stage of a schedule model applied to one stage's (B, nx) states
    through dynamics_at equals the whole-horizon evaluation's column."""
    prob = centroidal_locomotion.create_centroidal_problem(device="cpu")
    rng = np.random.default_rng(9)
    x = torch.tensor(0.1 * rng.standard_normal((3, prob.nsteps, 9)))
    u = torch.tensor(rng.standard_normal((3, prob.nsteps, 12)))
    whole = prob.stages.dynamics.forward(prob.space, x, u)
    for t in (0, 15, prob.nsteps - 1):
        one = core.dynamics_at(prob.stages.dynamics, t, prob.nsteps).forward(
            prob.space, x[:, t], u[:, t])
        _close(one, whole[:, t])
    with pytest.raises(ValueError, match="stage-varying"):
        prob.stages.dynamics.forward(prob.space, x[:, 0], u[:, 0])


def test_problem_builders_default_to_the_card():
    """Every centroidal builder takes ``device=`` and defaults to the
    card: without one, asking for it raises here rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (centroidal_locomotion.create_centroidal_problem,
                 solo_kinodynamics.create_kinodynamics_problem,
                 wheeled_inverted_pendulum.create_wip_problem,
                 continuous_centroidal.create_problem):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    from aligator_tpu_torch.examples.solo_jump import base_actuation
    with pytest.raises(RuntimeError, match="device='cpu'"):
        base_actuation(12)
    assert dataclasses.is_dataclass(tdyn.ContactMap)
