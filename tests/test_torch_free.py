"""The port's robot builders and free multibody dynamics against the JAX
package, float64 on the CPU.

The builders' leaves are held against the JAX package's models. The
rigid-body algorithms (ABA, RNEA with external forces, the ABA derivatives,
frame velocities and their Jacobians, the centre of mass), the three
free-dynamics ODEs, the frame placement and velocity residuals, the
rollouts and the solves (UR5 and FFSR reaches, double pendulum, acrobot,
flexible double pendulum, UR10 midpoint rule) are held against
``tests/data/torch_free_ref.npz``: the JAX package's jitted, vmapped
functions and solves on the same numpy inputs, written by
``tools/torch_free_fixture.py``, which the ``slow`` test reruns live.
The kernels these paths launch on the card are checked by
tests/test_torch_cuda.py.
"""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from aligator_tpu._pytree import replace
from aligator_tpu.modelling.multibody import model as jrbd
from aligator_tpu.modelling.multibody import residuals as jres
from aligator_tpu.modelling.multibody import robots as jrobots

import aligator_tpu_torch as at
from aligator_tpu_torch import _build, convert
from aligator_tpu_torch.core.dynamics import ExplicitDynamics
from aligator_tpu_torch.modelling import IntegratorSemiImplEuler
from aligator_tpu_torch.modelling.dynamics import multibody_free as tfree
from aligator_tpu_torch.modelling.multibody import derivatives as tder
from aligator_tpu_torch.modelling.multibody import model as rbd
from aligator_tpu_torch.modelling.multibody import residuals as tres
from aligator_tpu_torch.modelling.multibody import robots as trobots
from aligator_tpu_torch.utils import rollout as trollout

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_free_ref.npz"
TOL = 1e-10  # float64 on both sides, relative to max(1, max |ref|)
BUILDERS = ("make_pendulum", "make_double_pendulum", "make_ur5", "make_ur10", "make_panda",
            "make_dual_arm_ffsr", "make_free_sphere", "make_ur10_with_payload")
MODELS = {"ur5": "make_ur5", "ffsr": "make_dual_arm_ffsr",
          "double_pendulum": "make_double_pendulum", "free_sphere": "make_free_sphere",
          "ur10_payload": "make_ur10_with_payload", "pendulum": "make_pendulum"}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_free_fixture", ROOT / "tools" / "torch_free_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixture(prefix):
    with np.load(FIXTURE) as f:
        return {k[len(prefix):]: f[k] for k in f.files if k.startswith(prefix)}


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, ref, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max()) if got.size else 0.0
    assert err <= tol, f"{msg}: rel err {err:.3e} > {tol:g}"


def _pair(name):
    """The JAX model and the port's, carried across by ``convert``."""
    jm = getattr(jrobots, name)()
    return jm, convert.robot_model_from_numpy(_tool().model_leaves(jm), device="cpu")


def _states(jm, B, seed):
    """B random configurations (the neutral one moved by 0.5·N(0, 1)
    along the tangent), velocities, torques and external forces."""
    rng = np.random.default_rng(seed)
    cs = jm.configuration_space()
    dq = 0.5 * rng.standard_normal((B, jm.nv))
    q = np.asarray(jax.vmap(lambda d: cs.integrate(jm.neutral(), d))(dq))
    return (q, rng.standard_normal((B, jm.nv)), rng.standard_normal((B, jm.nv)),
            rng.standard_normal((B, jm.njoints, 6)))


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("name", BUILDERS)
def test_builders_match_jax(name):
    """Every builder gives the JAX model's leaves and topology."""
    jm = getattr(jrobots, name)()
    tm = getattr(trobots, name)(device="cpu")
    for k in rbd.LEAVES:
        _close(getattr(tm, k), getattr(jm, k), 1e-15, k)
    assert jm.armature is None
    for k in ("joint_types", "parents", "frame_parents", "frame_names"):
        assert getattr(tm, k) == getattr(jm, k), k
    assert tm.q_slices == jm.q_slices and tm.v_slices == jm.v_slices
    assert (tm.nq, tm.nv) == (jm.nq, jm.nv)


def test_constants_and_effort_limits_match_jax():
    for k in ("PANDA_Q_HOME", "PANDA_EFFORT_LIMIT", "PANDA_Q_LOWER", "PANDA_Q_UPPER",
              "FFSR_Q_ARM1", "FFSR_Q_ARM2"):
        np.testing.assert_array_equal(getattr(trobots, k), getattr(jrobots, k), err_msg=k)
    _close(trobots.ur10_effort_limits(device="cpu"), jrobots.ur10_effort_limits(), 0.0)


def test_neutral_in_the_models_dtype_and_device():
    """neutral() follows the model's dtype and device unless asked (it once
    returned the default float32 on the CPU)."""
    for dtype in (torch.float64, torch.float32):
        m = trobots.make_dual_arm_ffsr(dtype=dtype, device="cpu")
        q = m.neutral()
        assert q.dtype == dtype and q.device == m.mass.device and q.shape == (21,)
        _close(q.double(), jrobots.make_dual_arm_ffsr().neutral(), 0.0)
    assert m.neutral(torch.float64).dtype == torch.float64


def test_with_frame_and_armature():
    jm, tm = _pair("make_ur5")
    jm2 = jrbd.with_frame(jm, "tool", 4, placement_p=[0.1, 0.0, 0.2])
    tm2 = rbd.with_frame(tm, "tool", 4, placement_p=[0.1, 0.0, 0.2])
    assert tm2.frame_names == jm2.frame_names and tm2.frame_parents == jm2.frame_parents
    _close(tm2.fplac_p, jm2.fplac_p, 0.0)
    _close(tm2.fplac_q, jm2.fplac_q, 0.0)
    # an armature carries across, survives with_frame and the casts, and
    # enters the mass matrix as the JAX package's does
    arm = np.linspace(0.1, 0.6, jm.nv)
    leaves = _tool().model_leaves(jm)
    leaves["armature"] = arm
    tm3 = convert.robot_model_from_numpy(leaves, device="cpu")
    _close(tm3.armature, arm, 0.0)
    assert rbd.with_frame(tm3, "tool", 4).armature is tm3.armature
    assert tm3.to(torch.float32).armature.dtype == torch.float32
    q = np.linspace(-1.0, 1.0, jm.nq)
    _close(rbd.mass_matrix(tm3, _t(q)[None])[0],
           jrbd.mass_matrix(replace(jm, armature=jax.numpy.asarray(arm)), q), 1e-12)


@pytest.mark.parametrize("model", ["ur5", "ffsr", "double_pendulum", "free_sphere",
                                   "ur10_payload"])
def test_algorithms_match_jax(model):
    """aba (with and without external forces), nonlinear_effects, rnea with
    external forces, aba_derivatives (with them; its RNEA derivative pass
    included), frame_velocity and its Jacobians and center_of_mass against
    the JAX package's jitted functions (the fixture), to 1e-10;
    aba_derivatives also against forward-mode autodiff of the port's own
    aba."""
    jm, fid, (q, v, tau, fx) = _tool().algorithm_inputs(model)
    tm = convert.robot_model_from_numpy(_tool().model_leaves(jm), device="cpu")
    ref = _fixture(f"alg_{model}_")
    tq, tv, ttau, tfx = map(_t, (q, v, tau, fx))
    _close(rbd.aba(tm, tq, tv, ttau), ref["aba"], msg="aba")
    _close(rbd.aba(tm, tq, tv, ttau, tfx), ref["a"], msg="aba ext")
    _close(rbd.nonlinear_effects(tm, tq, tv), ref["nle"], msg="nle")
    _close(rbd.rnea(tm, tq, tv, ttau, tfx), ref["rnea_ext"], msg="rnea ext")
    a, da_dq, da_dv, solve_M = tder.aba_derivatives(tm, tq, tv, ttau, tfx)
    eye = torch.eye(tm.nv, dtype=torch.float64)
    for got, n in ((a, "a"), (da_dq, "da_dq"), (da_dv, "da_dv"), (solve_M(eye), "da_dtau")):
        _close(got, ref[n], msg=n)
    _close(rbd.frame_velocity(tm, tq, tv, fid), ref["fvel"], msg="frame velocity")
    for got, n in zip(tder.frame_velocity_jacobians(tm, tq, tv, fid), ("Jq", "Jv")):
        _close(got, ref[f"fvel_{n}"], msg=n)
    _close(rbd.center_of_mass(tm, tq), ref["com"], msg="com")
    # external forces enter RNEA through the linear map ext_generalized
    kin = rbd.kinematics(tm, tq, tv)
    _close(tder.ext_generalized(tm, kin, tfx),
           rbd.rnea(tm, tq, tv, ttau) - rbd.rnea(tm, tq, tv, ttau, tfx), TOL, "fext ↦ τ")

    # against the port's own autodiff (tangent coordinates on the chart)
    cs = tm.configuration_space()

    def acc(dq, dv, q, v, tau, fx):
        return rbd.aba(tm, cs.integrate(q, dq), v + dv, tau, fx)

    zero = torch.zeros(tm.nv, dtype=torch.float64)
    jq, jv = torch.func.vmap(torch.func.jacfwd(acc, argnums=(0, 1)),
                             in_dims=(None, None, 0, 0, 0, 0))(zero, zero, tq, tv, ttau, tfx)
    _close(da_dq, jq, 1e-9, "da_dq vs jacfwd")
    _close(da_dv, jv, 1e-9, "da_dv vs jacfwd")


def test_ffsr_zero_gravity_momentum_conservation():
    """Internal (arm) torques conserve the free-floating FFSR's spatial
    momentum at the world origin: its time derivative along the ABA flow
    (q̇ = v, v̇ = aba(q, v, τ)), by forward-mode autodiff, is zero."""
    tm = trobots.make_dual_arm_ffsr(device="cpu")
    q = tm.neutral().clone()
    q[7:14], q[14:21] = _t(trobots.FFSR_Q_ARM1), _t(trobots.FFSR_Q_ARM2)
    v = 0.3 * _t(np.random.default_rng(0).standard_normal(tm.nv))
    tau = torch.zeros(tm.nv, dtype=torch.float64)
    tau[8], tau[11], tau[15] = 3.0, -2.0, 1.5
    a = rbd.aba(tm, q, v, tau)
    cs = tm.configuration_space()

    def momentum(s):
        qq, vv = cs.integrate(q, s * v), v + s * a
        kin = rbd.kinematics(tm, qq, vv)
        m, c, I_w = rbd.world_inertia(tm, kin["R"], kin["p"])
        return rbd.inertia_apply(m, c, I_w, kin["V"]).sum(-2)

    h, hdot = torch.func.jvp(momentum, (torch.tensor(0.0, dtype=torch.float64),),
                             (torch.tensor(1.0, dtype=torch.float64),))
    assert h.abs().max() > 1.0  # the system moves
    assert hdot.abs().max() < 1e-10 * max(1.0, float(a.abs().max()))


# ------------------------------------------------------------------ ODEs


def _odes(kind):
    """(JAX ODE, port ODE, JAX model, x, u) of each free-dynamics ODE."""
    jm, jode, pars, x, u = _tool().ode_inputs(kind)
    tm = convert.robot_model_from_numpy(_tool().model_leaves(jm), device="cpu")
    cls = {"free": "MultibodyFreeFwdDynamics",
           "gravity_compensated": "MultibodyGravityCompensatedDynamics",
           "flexible": "MultibodyFlexibleFwdDynamics"}[kind]
    return jode, getattr(tfree, cls)(model=tm, **{k: _t(a) for k, a in pars.items()}), jm, x, u


@pytest.mark.parametrize("kind", ["free", "gravity_compensated", "flexible"])
def test_odes_match_jax(kind):
    """xdot of the three ODEs and acc_derivatives where the JAX ODE has
    them (free on the FFSR, flexible) against the JAX package's (the
    fixture), to 1e-10; the semi-implicit Euler step, and its (A, B, E)
    assembled from acc_derivatives against the port's own forward-mode
    autodiff of that step."""
    jode, tode, jm, x, u = _odes(kind)
    tspace = tode.model.phase_space()
    has_acc = hasattr(jode, "acc_derivatives")
    tdyn = IntegratorSemiImplEuler(ode=tode, timestep=_t(0.01))
    ref = _fixture(f"ode_{kind}_")
    tx, tu = _t(x), _t(u)
    _close(tode.xdot(tspace, tx, tu), ref["xdot"], msg="xdot")
    y = tdyn.forward(tspace, tx, tu)
    _close(y, ref["y"], msg="semi-implicit Euler")
    if has_acc:
        generic = ExplicitDynamics.jacobians(tdyn, tspace, tx, tu, y)
        for got, r, n in zip(tdyn.jacobians(tspace, tx, tu, y), generic, "ABE"):
            _close(got, r, 1e-9, f"{n} vs autodiff")
    assert has_acc == hasattr(tode, "acc_derivatives") == ("a" in ref)
    if has_acc:
        for got, n in zip(tode.acc_derivatives(tspace, tx, tu),
                          ("a", "da_dq", "da_dv", "da_du")):
            _close(got, ref[n], msg=n)


def test_free_fd_takes_aba_on_the_cpu():
    """The free-dynamics kernel's wrapper sends CPU tensors to model.aba, and
    semi-implicit Euler's step reads the free ODE's acceleration through it
    (the card runs the kernel there: tests/test_torch_cuda.py)."""
    from aligator_tpu_torch.modelling.multibody import free_fd

    jm, tm = _pair("make_dual_arm_ffsr")
    q, v, tau, _ = _states(jm, 3, 31)
    before = _build.LAUNCHES["free_fd"]
    got = free_fd.free_fd(tm, _t(q), _t(v), _t(tau))
    assert _build.LAUNCHES["free_fd"] == before
    _close(got, rbd.aba(tm, _t(q), _t(v), _t(tau)), 0.0, "free_fd plain")
    ode = tfree.MultibodyFreeFwdDynamics(model=tm, actuation=torch.eye(
        tm.nv, tm.nv - 6, dtype=torch.float64).roll(6, 0))
    x, u = _t(np.concatenate([q, v], -1)), _t(tau[:, 6:])
    space = tm.phase_space()
    _close(ode.acceleration(space, x, u), ode.xdot(space, x, u)[:, tm.nv:], 0.0,
           "acceleration")


@pytest.mark.parametrize("model", ["ur5", "ffsr"])
def test_free_fd_derivatives_match_autodiff(model):
    """free_fd's analytic derivatives (its autograd.Function: forward and
    reverse mode, vmap, a Hessian through semi-implicit Euler's step, the
    'exact' Hessian's path) against autograd through model.aba, in tangent
    coordinates, to 1e-9 relative."""
    from aligator_tpu_torch.modelling.multibody import free_fd

    jm, tm = _pair(MODELS[model])
    q, v, tau, _ = map(_t, _states(jm, 3, 41))
    cs = tm.configuration_space()

    def acc(fn):
        return lambda d, qq, vv, tt: fn(tm, cs.integrate(qq, d), vv, tt)

    zero = torch.zeros_like(v)
    jac = [torch.func.vmap(torch.func.jacfwd(acc(fn), argnums=(0, 2, 3)))(zero, q, v, tau)
           for fn in (free_fd.free_fd, rbd.aba)]
    rev = [torch.func.vmap(torch.func.jacrev(acc(fn), argnums=(0, 2, 3)))(zero, q, v, tau)
           for fn in (free_fd.free_fd, rbd.aba)]
    for n, g, r in zip(("dq", "dv", "dtau"), jac[0], jac[1]):
        _close(g, r, 1e-9, f"jacfwd {n}")
    for n, g, r in zip(("dq", "dv", "dtau"), rev[0], rev[1]):
        _close(g, r, 1e-9, f"jacrev {n}")
    # a q shared by the batch: its gradient sums over the batch
    w = torch.randn(3, tm.nv, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    grads = []
    for fn in (free_fd.free_fd, rbd.aba):
        d = torch.zeros(tm.nv, dtype=torch.float64, requires_grad=True)
        vv = v.clone().requires_grad_()
        grads.append(torch.autograd.grad((fn(tm, cs.integrate(q[0], d), vv, tau) * w).sum(),
                                         (d, vv)))
    for n, g, r in zip(("dq", "dv"), *grads):
        _close(g, r, 1e-9, f"grad {n}")
    # second order through semi-implicit Euler, whose step reads the ODE's
    # acceleration (free_fd)
    act = torch.eye(tm.nv, dtype=torch.float64)
    dyn = IntegratorSemiImplEuler(ode=tfree.MultibodyFreeFwdDynamics(model=tm, actuation=act),
                                  timestep=_t(0.05))
    space = tm.phase_space()
    x = torch.cat([q[0], v[0]])
    lam = torch.randn(space.nx, dtype=torch.float64, generator=torch.Generator().manual_seed(6))

    def lagrangian(step):
        return lambda dx, u: (step(space.integrate(x, dx), u) * lam).sum()

    def step_by_aba(y, u):
        q1, v1 = y[:tm.nq], y[tm.nq:]
        v2 = v1 + dyn.timestep * rbd.aba(tm, q1, v1, u)
        return torch.cat([cs.integrate(q1, dyn.timestep * v2), v2])

    zx = torch.zeros(space.ndx, dtype=torch.float64)
    h = [torch.func.hessian(lagrangian(f), argnums=(0, 1))(zx, tau[0])
         for f in (lambda y, u: dyn.forward(space, y, u), step_by_aba)]
    for i in range(2):
        for j in range(2):
            _close(h[0][i][j], h[1][i][j], 1e-9, f"hessian {i}{j}")


# ------------------------------------------------------------------ residuals


@pytest.mark.parametrize("model", ["ur5", "ffsr", "pendulum"])
def test_residuals_match_jax(model):
    """FramePlacementResidual and FrameVelocityResidual values and
    Jacobians against the JAX package's (the fixture), to 1e-10."""
    jm, _, pars, x, u = _tool().residual_inputs(model)
    tm = convert.robot_model_from_numpy(_tool().model_leaves(jm), device="cpu")
    fid = pars["fid"]
    tspace = tm.phase_space()
    pairs = {
        "placement": tres.FramePlacementResidual(model=tm, R_ref=_t(pars["R_ref"]),
                                                 p_ref=_t(pars["p_ref"]), frame_id=fid),
        "velocity": tres.FrameVelocityResidual(model=tm, v_ref=_t(pars["v_ref"]), frame_id=fid),
    }
    for name, tr in pairs.items():
        ref = _fixture(f"res_{model}_{name}_")
        _close(tr.value(tspace, _t(x), _t(u)), ref["value"], msg=f"{name} value")
        assert tr.dim(tspace, 2) == 6
        for got, n in zip(tr.jacobians(tspace, _t(x), _t(u)), ("Jx", "Ju")):
            _close(got, ref[n], msg=f"{name} {n}")


def test_matrix_to_quat_matches_jax_on_every_branch():
    rng = np.random.default_rng(23)
    from aligator_tpu.modelling.spaces.se3 import exp3_quat, quat_to_matrix
    ws = np.concatenate([0.3 * rng.standard_normal((4, 3)),
                         np.pi * np.eye(3) * 0.999, rng.standard_normal((4, 3))])
    R = np.asarray(jax.vmap(lambda w: quat_to_matrix(exp3_quat(w)))(ws))
    ref = np.asarray(jax.vmap(jres._matrix_to_quat)(R))
    got = tres.matrix_to_quat(_t(R))
    _close(got, ref, 1e-14, "quaternions")
    tr = np.trace(R, axis1=1, axis2=2)
    branch = np.argmax(np.stack([tr, R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]], -1), -1)
    assert set(branch.tolist()) == {0, 1, 2, 3}


def test_rollouts_match_jax():
    """utils.rollout and closed_loop_rollout on the UR5's semi-implicit
    Euler dynamics against the JAX package's (the fixture)."""
    jm, tm = _pair("make_ur5")
    tdyn = IntegratorSemiImplEuler(ode=tfree.MultibodyFreeFwdDynamics(
        model=tm, actuation=torch.eye(6, dtype=torch.float64)), timestep=_t(0.05))
    x0, us, xs_ref, K, kff = _tool().rollout_inputs()
    ts = tm.phase_space()
    ref = _fixture("rollout_")
    _close(trollout.rollout(tdyn, ts, _t(x0), _t(us)), ref["xs"], msg="rollout")
    got = trollout.closed_loop_rollout(tdyn, ts, _t(x0), _t(us), _t(xs_ref), _t(K), _t(kff))
    for g, n in zip(got, ("xs", "us")):
        _close(g, ref[f"closed_{n}"], msg=f"closed loop {n}")


# ------------------------------------------------------------------ solves

CONVERT = {
    "ur5": convert.ur5_reach_problem_from_numpy,
    "ffsr": convert.ffsr_reach_problem_from_numpy,
    "double_pendulum": lambda p, nsteps, device: convert.swing_up_problem_from_numpy(
        p, nsteps, u_bound=25.0, device=device),
    "acrobot": lambda p, nsteps, device: convert.swing_up_problem_from_numpy(
        p, nsteps, u_bound=12.0, device=device),
    "flexible": convert.flexible_pendulum_problem_from_numpy,
    "ur10_midpoint": convert.ur10_midpoint_problem_from_numpy,
}


@pytest.mark.parametrize("case", list(CONVERT))
def test_solves_match_jax(case):
    """ProxDDP with the published options on each example at a small size
    (its iterations cut as the fixture's) against the JAX package's solve:
    num_iters, al_iter and conv equal, trajectories, multipliers,
    infeasibilities and costs to 1e-8."""
    tool = _tool()
    small = tool.SMALL[case]
    ref = _fixture(f"{case}_")
    x0 = ref["x0s"]
    np.testing.assert_array_equal(x0, tool.x0s(case, small["batch"]))
    prob = CONVERT[case](tool.params(case, small["nsteps"], x0), nsteps=small["nsteps"],
                         device="cpu")
    cfg = at.solvers.ProxDDPConfig(**{**tool.SOLVE_OPTIONS[case],
                                      "max_iters": small["max_iters"]})
    kw = {}
    if case == "ur10_midpoint":
        from aligator_tpu_torch.examples.ur10_midpoint import warm_start
        kw = dict(zip(("xs_init", "us_init"), warm_start(prob)))
    got = at.solvers.solve(prob, cfg, **kw)
    for k in ("num_iters", "al_iter", "conv"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), ref[k], err_msg=k)
    for k in ("xs", "us", "vs", "lams", "prim_infeas", "dual_infeas", "traj_cost"):
        _close(getattr(got, k), ref[k], 1e-8, k)


@pytest.mark.parametrize("case", ["ur5", "ffsr", "acrobot"])
def test_full_size_jax_reference_is_recorded(case):
    """The chip script's floor: the JAX package's conv on the first 16
    scenarios at the published size, for the initial states that
    ``x0s`` draws."""
    tool = _tool()
    ref = _fixture(f"{case}_full_")
    np.testing.assert_array_equal(ref["x0s"], tool.x0s(case, tool.FULL_SCENARIOS))
    assert ref["conv"].shape == ref["num_iters"].shape == (tool.FULL_SCENARIOS,)


@pytest.mark.slow
def test_fixture_matches_a_live_jax_solve():
    """Every fixture entry solved live by the JAX package."""
    live = _tool().references()
    with np.load(FIXTURE) as f:
        assert set(live) <= set(f.files)
        for k, v in live.items():
            np.testing.assert_allclose(f[k], v, rtol=1e-12, atol=1e-12, err_msg=k)
