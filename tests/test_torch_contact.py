"""The port's contact dynamics against the JAX package, float64 on the CPU.

Loop (body-body) constraints and position references in the contact KKT,
the relative and world-frame contact kinematics, the differentiable SPD
solve, the contact-dynamics derivative rows (K5's plain version) with
position references, ``underactuated_constrained_rnea``, the contact,
centre-of-mass and gravity-compensation residuals, and the problems of the
UR10 payload throw, the Solo jump and squat and the biped walk, held against
``tests/data/torch_contact_ref.npz``: the JAX package's jitted functions and
solves on the same numpy inputs, written by ``tools/torch_contact_fixture.py``,
which the ``slow`` test reruns live. The kernels these paths launch on the
card are checked by tests/test_torch_cuda.py.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import aligator_tpu_torch as at
from aligator_tpu_torch import _build, convert
from aligator_tpu_torch._linalg import chol_solve
from aligator_tpu_torch.core import problem as problem_mod
from aligator_tpu_torch.core.dynamics import dynamics_at
from aligator_tpu_torch.examples import biped_walk, solo_bend, solo_jump, ur10_ballistic
from aligator_tpu_torch.gar import spd_solve
from aligator_tpu_torch.modelling.multibody import contact, derivatives, fd_rows
from aligator_tpu_torch.modelling.multibody import model as rbd
from aligator_tpu_torch.modelling.multibody import residuals

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_contact_ref.npz"
TOL = 1e-10  # float64 on both sides, relative to max(1, max |ref|)
TOL_DERIV = 1e-8


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_contact_fixture", ROOT / "tools" / "torch_contact_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


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


def _model(name):
    """The JAX model's contact configuration, the port's model carried
    across by convert, and the states of the fixture."""
    jm, frames, dims, frames2 = TOOL.jax_models()[name]
    tm = convert.robot_model_from_numpy(TOOL.model_leaves(jm), device="cpu")
    return tm, frames, dims, frames2, TOOL.states(name, jm)


# ---------------------------------------------------------------- kinematics


@pytest.mark.parametrize("name", ["ur10", "quadruped", "humanoid"])
def test_contact_kinematics_and_kkt_match_jax(name):
    """The primal KKT solve (a, λ) with position references (kp = 1) on
    world contacts and on the UR10's 6D grasp, its payload away from the
    tool, one instance's last contact inactive; the relative velocity,
    Jacobian and drift of the grasp in 3D and 6D; a frame's point velocity,
    contact Jacobian and drift; the centre-of-mass Jacobians; to 1e-10."""
    tm, frames, dims, frames2, s = _model(name)
    ref = _fixture(f"kin_{name}_")
    q, v, tau, pr, act = (_t(s[k]) for k in ("q", "v", "tau", "p_refs", "act"))
    kd = 10.0 if name == "quadruped" else TOOL.KD
    out = contact.cfd_internals(tm, q, v, tau, frames, act, prox_mu=TOOL.PROX[name], kp=1.0,
                                kd=kd, p_refs=pr, contact_dims=dims, contact_frames2=frames2)
    _close(out["a"], ref["a"], msg="a")
    _close(out["lam"], ref["lam"], msg="lam")
    f1 = frames[0]
    for got, k in zip(contact.frame_point_and_world_velocity(tm, q, v, f1), "01"):
        _close(got, ref[f"point_{k}"], msg="point")
    _close(contact.contact_jacobian(tm, q, f1), ref["cjac"], msg="contact_jacobian")
    _close(contact.contact_drift(tm, q, v, f1), ref["cdrift"], msg="contact_drift")
    _close(derivatives.com_jacobian(tm, q), ref["com_jac"], msg="com_jacobian")
    for got, k in zip(derivatives.com_velocity_jacobians(tm, q, v), "01"):
        _close(got, ref[f"com_vel_jac_{k}"], msg="com_velocity_jacobians")
    if frames2 is None:
        return
    f2 = frames2[0]
    for d in (3, 6):
        got = (contact.relative_velocity_lwa(tm, q, v, f1, f2, d),
               contact.relative_jacobian_lwa(tm, q, f1, f2, d),
               contact._rel_drift(tm, q, v, f1, f2, d))
        for g, k in zip(got, "012"):
            _close(g, ref[f"rel{d}_{k}"], msg=f"relative {d}D [{k}]")


def test_loop_ode_matches_jax():
    """The grasp's xdot and acc_derivatives (exact tangents through the KKT
    solve with implicit SPD tangents) against JAX's jacfwd, to 1e-8; and
    against the port's own forward-mode autodiff through the Cholesky
    solves."""
    tm, frames, dims, frames2, s = _model("ur10")
    ref = _fixture("kin_ur10_")
    B = torch.eye(tm.nv, 6, dtype=torch.float64)
    ode = contact.MultibodyConstraintFwdDynamics(
        model=tm, actuation=B, active=torch.ones(1, dtype=torch.float64),
        contact_frames=frames, contact_dims=dims, contact_frames2=frames2,
        prox_mu=TOOL.PROX["ur10"], kp=TOOL.KP, kd=TOOL.KD, p_refs=_t(s["p_refs"][0]))
    sp = tm.phase_space()
    x, u = _t(np.concatenate([s["q"], s["v"]], -1)), _t(s["tau"][:, :6])
    _close(ode.xdot(sp, x, u), ref["xdot"], msg="xdot")
    got = ode.acc_derivatives(sp, x, u)
    for g, k in zip(got, ("a", "da_dq", "da_dv", "da_du")):
        _close(g, ref[f"acc_{k}"], TOL_DERIV, k)

    cs = tm.configuration_space()

    def acc(z, q, v, u):
        out = contact.cfd_internals(tm, cs.integrate(q, z[:tm.nv]), v + z[tm.nv:2 * tm.nv],
                                    B @ (u + z[2 * tm.nv:]), frames, ode.active,
                                    prox_mu=ode.prox_mu, kp=ode.kp, kd=ode.kd,
                                    p_refs=ode.p_refs, contact_dims=dims,
                                    contact_frames2=frames2)
        return out["a"]

    nq = tm.nq
    J = torch.func.vmap(torch.func.jacfwd(acc), in_dims=(None, 0, 0, 0))(
        x.new_zeros(2 * tm.nv + 6), x[:, :nq], x[:, nq:], u)
    _close(torch.cat(got[1:], -1), J, TOL_DERIV, "vs autodiff through Cholesky")


def test_grasp_statics_release_and_relative_acceleration():
    """The port's counterparts of tests/test_ballistic.py: the grasp's
    inverse dynamics hold the payload (zero acceleration, the grasp force
    carries its weight), an active grasp pins the relative acceleration
    (J_rel a + γ = 0) and a released one lets the payload fall freely with
    zero force."""
    prob, tm, u0, _ = ur10_ballistic.create_ur10_ballistic_problem(nsteps=4, device="cpu")
    ee, mug = tm.frame_id("ee"), tm.frame_id("mug")
    q0 = prob.x0[0, :tm.nq]
    z = q0.new_zeros(tm.nv)
    B = prob.stages.dynamics.ode.actuation
    kw = dict(contact_dims=(6,), contact_frames2=(mug,), prox_mu=1e-10)
    u, f = contact.underactuated_constrained_rnea(tm, q0, z, B, (ee,), contact_dims=(6,),
                                                  contact_frames2=(mug,))
    _close(u, u0, 0.0, "u0")
    assert abs(abs(float(f[2])) - 0.5 * 9.81) < 1e-6
    a, _ = contact.constrained_fwd_dynamics(tm, q0, z, B @ u, (ee,), q0.new_ones(1), **kw)
    assert float(a.abs().max()) < 1e-6
    v0 = 0.1 * torch.sin(torch.arange(tm.nv, dtype=torch.float64))
    a, _ = contact.constrained_fwd_dynamics(tm, q0, v0, B @ q0.new_full((6,), 10.0), (ee,),
                                            q0.new_ones(1), **kw)
    Jr = contact.relative_jacobian_lwa(tm, q0, ee, mug, 6)
    assert float((Jr @ a + contact._rel_drift(tm, q0, v0, ee, mug, 6)).abs().max()) < 1e-7
    a, f = contact.constrained_fwd_dynamics(tm, q0, z, B @ q0.new_zeros(6), (ee,),
                                            q0.new_zeros(1), **kw)
    assert float(f.abs().max()) < 1e-9
    assert float((a[6:9] - a.new_tensor([0.0, 0.0, -9.81])).abs().max()) < 1e-8


# ---------------------------------------------------------------- SPD solve


@pytest.mark.parametrize("shared", [False, True])
def test_spd_solve_diff_matches_autodiff_through_cholesky(shared):
    """spd_solve_diff's jvp, jacfwd, jacrev, vmap (per-system A, and one A
    shared by a batch of right-hand sides: the folded route) and reverse
    mode against torch.func through chol_solve, to 1e-10."""
    g = torch.Generator().manual_seed(3)
    K, n, r = 3, 6, 4
    P = torch.randn((1 if shared else K), n, n, dtype=torch.float64, generator=g)
    R = torch.randn(K, n, r, dtype=torch.float64, generator=g)

    def f(solve):
        def fn(P, R):
            return solve(P @ P.mT + n * torch.eye(n, dtype=P.dtype), R)
        return fn

    for tr in (torch.func.jacfwd, torch.func.jacrev):
        got = tr(f(spd_solve.spd_solve_diff), argnums=(0, 1))(P, R)
        ref = tr(f(chol_solve), argnums=(0, 1))(P, R)
        for a, b in zip(got, ref):
            _close(a, b, msg=tr.__name__)
    dims = (None, 0) if shared else (0, 0)
    P1 = P[0] if shared else P
    for tr in (torch.func.jacfwd, torch.func.jacrev):
        got = torch.func.vmap(tr(f(spd_solve.spd_solve_diff), argnums=(0, 1)), dims)(P1, R)
        ref = torch.func.vmap(tr(f(chol_solve), argnums=(0, 1)), dims)(P1, R)
        for a, b in zip(got, ref):
            _close(a, b, msg=f"vmap {tr.__name__}")
    tangents = (torch.randn(P.shape, dtype=torch.float64, generator=g),
                torch.randn(R.shape, dtype=torch.float64, generator=g))
    _close(torch.func.jvp(f(spd_solve.spd_solve_diff), (P, R), tangents)[1],
           torch.func.jvp(f(chol_solve), (P, R), tangents)[1], msg="jvp")
    grads = []
    for solve in (spd_solve.spd_solve_diff, chol_solve):
        Pg, Rg = P.clone().requires_grad_(), R.clone().requires_grad_()
        grads.append(torch.autograd.grad(f(solve)(Pg, Rg).sin().sum(), (Pg, Rg)))
    for a, b in zip(*grads):
        _close(a, b, msg="backward")


def test_spd_solve_launch_refuses_tensors_that_need_a_gradient():
    A = torch.eye(3, dtype=torch.float64)[None].requires_grad_()
    with pytest.raises(ValueError, match="values only"):
        spd_solve.launch(A, torch.ones(1, 3, 2, dtype=torch.float64))


# ---------------------------------------------------------------- K5 rows


def test_fd_rows_with_position_references_match_jax():
    """K5's plain version with kp ≠ 0 and position references against
    ``derivatives._fd_rows_std`` and the Pallas kernel in interpret mode
    (the quadruped, an instance's foot inactive), at the JAX primal
    solution."""
    tm, frames, dims, _, s = _model("quadruped")
    s = TOOL.states("quadruped", TOOL.jax_models()["quadruped"][0], 4)
    ref = _fixture("fdrows_")
    q, v, tau, pr, act = (_t(s[k]) for k in ("q", "v", "tau", "p_refs", "act"))
    out = contact.cfd_internals(tm, q, v, tau, frames, act, prox_mu=1e-5, kp=50.0, kd=10.0,
                                p_refs=pr, contact_dims=dims)
    _close(out["a"], ref["a"], 1e-9, "a")
    _close(out["lam"], ref["lam"], 1e-9, "lam")
    before = _build.LAUNCHES["fd_rows"]
    got = fd_rows.fd_rows(tm, q, v, _t(ref["a"]), _t(ref["lam"]), act, frames, dims, kd=10.0,
                          kp=50.0, has_prefs=True)
    assert _build.LAUNCHES["fd_rows"] == before
    for g, n in zip(got, ("ra1_q", "ra1_v", "r2_q", "r2_v")):
        _close(g, ref[f"std_{n}"], msg=n)
        _close(g, ref[f"ker_{n}"], msg=f"{n} (Pallas interpret)")


@pytest.mark.parametrize("name", ["quadruped", "humanoid"])
def test_world_contact_derivatives_with_position_references(name):
    """The analytic route (K5's rows, the joint KKT solve) with kp ≠ 0 and
    position references, 3D and 6D, against the port's forward-mode
    autodiff of the primal solve."""
    tm, frames, dims, _, s = _model(name)
    q, v, tau, pr, act = (_t(s[k]) for k in ("q", "v", "tau", "p_refs", "act"))
    kw = dict(prox_mu=1e-5, kp=30.0, kd=10.0, contact_dims=dims)
    got = derivatives.constrained_fd_derivatives(tm, q, v, tau, frames, act, p_refs=pr, **kw)
    cs = tm.configuration_space()
    nv = tm.nv

    def acc(z, q, v, tau, act, pr):
        return contact.cfd_internals(tm, cs.integrate(q, z[:nv]), v + z[nv:2 * nv],
                                     tau + z[2 * nv:], frames, act, p_refs=pr, **kw)["a"]

    J = torch.func.vmap(torch.func.jacfwd(acc), in_dims=(None, 0, 0, 0, 0, 0))(
        q.new_zeros(3 * nv), q, v, tau, act, pr)
    _close(torch.cat(got[2:5], -1), J, 1e-7, "acc derivatives")


# ---------------------------------------------------------------- statics


@pytest.mark.parametrize("name", ["ur10", "quadruped"])
def test_underactuated_constrained_rnea_matches_jax(name):
    """The minimum-norm solution on the UR10 grasp (square [B, Jcᵀ]) and on
    the quadruped with a foot listed twice (rank-deficient), to 1e-10."""
    tm, frames, dims, frames2, s = _model(name)
    ref = _fixture(f"rnea_{name}_")
    if name == "ur10":
        Bm = torch.eye(tm.nv, 6, dtype=torch.float64)
    else:
        frames, dims = frames + frames[:1], dims + dims[:1]
        Bm = torch.zeros(tm.nv, tm.nv - 6, dtype=torch.float64)
        Bm[6:] = torch.eye(tm.nv - 6, dtype=torch.float64)
    u, f = contact.underactuated_constrained_rnea(tm, _t(s["q"]), 0.1 * _t(s["v"]), Bm,
                                                  frames, contact_dims=dims,
                                                  contact_frames2=frames2)
    _close(u, ref["u"], msg="u")
    _close(f, ref["f"], msg="forces")
    if name == "quadruped":  # the two copies of the foot share its force
        assert torch.allclose(f[..., :3], f[..., -3:], atol=1e-9)


# ---------------------------------------------------------------- residuals


@pytest.mark.parametrize("name", ["quadruped", "humanoid"])
def test_residuals_match_jax(name):
    """ContactForceResidual, the friction cone (3D) or the wrench cone
    (6D), the centre-of-mass translation and velocity residuals and the
    gravity-compensation residual: values and Jacobians, to 1e-8."""
    tm, frames, dims, _, s = _model(name)
    nu = tm.nv - 6
    Bm = torch.zeros(tm.nv, nu, dtype=torch.float64)
    Bm[6:] = torch.eye(nu, dtype=torch.float64)
    common = dict(model=tm, actuation=Bm, active=torch.ones(len(frames), dtype=torch.float64),
                  contact_frames=frames, contact_dims=dims, contact_id=1,
                  prox_mu=TOOL.PROX[name])
    fns = {"force": contact.ContactForceResidual(
               f_ref=torch.arange(dims[1], dtype=torch.float64), **common),
           "com": residuals.CenterOfMassTranslationResidual(
               model=tm, p_ref=torch.ones(3, dtype=torch.float64)),
           "comvel": residuals.CenterOfMassVelocityResidual(
               model=tm, v_ref=torch.ones(3, dtype=torch.float64)),
           "gravity": residuals.GravityCompensationResidual(model=tm, actuation=Bm)}
    mu = torch.tensor(0.7, dtype=torch.float64)
    if dims[1] == 3:
        fns["friction"] = contact.MultibodyFrictionConeResidual(mu_friction=mu, **common)
    else:
        fns["wrench"] = contact.MultibodyWrenchConeResidual(
            mu_friction=mu, half_length=torch.tensor(0.1, dtype=torch.float64),
            half_width=torch.tensor(0.05, dtype=torch.float64), **common)
    sp = tm.phase_space()
    x, u = _t(np.concatenate([s["q"], s["v"]], -1)), _t(s["tau"][:, :nu])
    ref = _fixture(f"res_{name}_")
    for k, fn in fns.items():
        val = fn.value(sp, x, u)
        assert fn.dim(sp, nu) == val.shape[-1]
        _close(val, ref[f"{k}_value"], TOL_DERIV, f"{k} value")
        for g, n in zip(fn.jacobians(sp, x, u), ("Jx", "Ju")):
            _close(g, ref[f"{k}_{n}"], TOL_DERIV, f"{k} {n}")


@pytest.mark.parametrize("name", ["quadruped", "humanoid"])
def test_stage_varying_activity_matches_jax(name):
    """ContactForceResidual and the friction (3D) or wrench (6D) cone with
    an ``(N, ncont)`` schedule of two stages that differ, on ``(B, N, ·)``
    inputs: values and both Jacobians against the JAX package's stacked
    stages (one row of the schedule a stage), to 1e-9."""
    tm, frames, dims, _, _ = _model(name)
    ref = _fixture(f"sched_{name}_")
    nu = tm.nv - 6
    Bm = torch.zeros(tm.nv, nu, dtype=torch.float64)
    Bm[6:] = torch.eye(nu, dtype=torch.float64)
    common = dict(model=tm, actuation=Bm, active=_t(ref["active"]), contact_frames=frames,
                  contact_dims=dims, contact_id=1, prox_mu=TOOL.PROX[name])
    mu = torch.tensor(0.7, dtype=torch.float64)
    fns = {"force": contact.ContactForceResidual(
        f_ref=torch.arange(dims[1], dtype=torch.float64), **common)}
    if dims[1] == 3:
        fns["cone"] = contact.MultibodyFrictionConeResidual(mu_friction=mu, **common)
    else:
        fns["cone"] = contact.MultibodyWrenchConeResidual(
            mu_friction=mu, half_length=torch.tensor(0.1, dtype=torch.float64),
            half_width=torch.tensor(0.05, dtype=torch.float64), **common)
    sp = tm.phase_space()
    x, u = _t(ref["x"]), _t(ref["u"])
    for k, fn in fns.items():
        _close(fn.value(sp, x, u), ref[f"{k}_value"], 1e-9, f"{k} value")
        for g, n in zip(fn.jacobians(sp, x, u), ("Jx", "Ju")):
            _close(g, ref[f"{k}_{n}"], 1e-9, f"{k} {n}")


# ---------------------------------------------------------------- problems


def _prob_params(case):
    size = TOOL.PROB_SIZES[case]
    p = TOOL.params(case, size)
    n = p["active"].shape[0] if case != "ur10" else size
    return p, n


CREATE = {
    "ur10": lambda: ur10_ballistic.create_ur10_ballistic_problem(
        nsteps=10, timestep=0.025, device="cpu")[0],
    "solo_jump": lambda: solo_jump.create_solo_jump_problem(3, 2, 3, device="cpu")[0],
    "solo_bend": lambda: solo_bend.create_solo_bend_problem(6, device="cpu")[0],
    "biped": lambda: biped_walk.create_biped_walk_problem(2, 2, device="cpu")[0],
}


@pytest.mark.parametrize("case", list(CREATE))
def test_problems_match_jax(case):
    """Each example's problem, converted from the JAX problem's leaves and
    built by the port's own builder: compute_derivatives along a seeded
    trajectory (costs, dynamics residuals and (A, B, E), constraints and
    their Jacobians, terminal constraints) against the JAX package's, to
    1e-8."""
    params, n = _prob_params(case)
    ref = _fixture(f"prob_{case}_")
    conv = (convert.ur10_ballistic_problem_from_numpy if case == "ur10"
            else convert.legged_problem_from_numpy)
    xs, us = _t(ref["xs"])[None], _t(ref["us"])[None]
    for label, prob in (("converted", conv(params, nsteps=n, device="cpu")),
                        ("built", CREATE[case]())):
        got = problem_mod.compute_derivatives(prob, xs, us)
        for f, r in ref.items():
            if f in ("xs", "us"):
                continue
            _close(getattr(got, f)[0], r, TOL_DERIV, f"{label} {f}")


def test_rollout_reads_the_schedule_a_stage_at_a_time():
    """dynamics_at gives stage t's row of a stage-varying schedule; the
    rollout and the nonlinear rollout's stage loop apply it, so stance and
    flight stages differ (a one-stage call with the (N, 4) leaf raises)."""
    from aligator_tpu_torch.utils.rollout import rollout

    prob, _, (ns, nf, nl) = solo_jump.create_solo_jump_problem(2, 2, 2, device="cpu")
    dyn, sp, N = prob.stages.dynamics, prob.space, prob.nsteps
    x = prob.x0
    u = x.new_zeros(1, prob.nu)
    with pytest.raises(ValueError, match="stage-varying"):
        dyn.forward(sp, x, u)
    assert dynamics_at(dyn, 0, N).ode.active.shape == (4,)
    assert float(dynamics_at(dyn, ns, N).ode.active.sum()) == 0.0
    xs = rollout(dyn, sp, x, u[:, None].expand(1, N, -1))
    for t in range(N):
        y = dynamics_at(dyn, t, N).forward(sp, xs[:, t], u)
        _close(xs[:, t + 1], y, 0.0, f"stage {t}")
    # in flight no contact acts: the unconstrained dynamics, zero forces
    ode = dynamics_at(dyn, ns, N).ode
    m, nq = ode.model, ode.model.nq
    q, v = xs[:, ns, :nq], xs[:, ns, nq:]
    a = ode.xdot(sp, xs[:, ns], u)[..., m.nv:]
    _close(a, rbd.aba(m, q, v, u @ ode.actuation.mT), 1e-12, "flight")
    _, f = contact.constrained_fwd_dynamics(m, q, v, u @ ode.actuation.mT, ode.contact_frames,
                                            ode.active, prox_mu=ode.prox_mu, kd=ode.kd)
    assert float(f.abs().max()) == 0.0


# ---------------------------------------------------------------- solves


def _small_problem(case, ref):
    s = TOOL.SMALL[case]
    if case == "ur10":
        p = TOOL.params("ur10", s["nsteps"], target_pos=ref["targets"])
        p["x0"] = np.tile(p["x0"], (len(ref["targets"]), 1))
        prob = convert.ur10_ballistic_problem_from_numpy(p, nsteps=s["nsteps"], device="cpu")
        return prob, dict(zip(("xs_init", "us_init"), ur10_ballistic.warm_start(prob)))
    p = TOOL.params("solo", s["nsteps"], x0=ref["x0s"])
    return convert.legged_problem_from_numpy(p, nsteps=sum(s["nsteps"]), device="cpu"), {}


@pytest.mark.parametrize("case", ["ur10", "solo"])
def test_solves_match_jax(case):
    """ProxDDP with the published options on the UR10 throw (N = 10, two
    targets, from the warm start) and the Solo jump (N = 8, two initial
    states), cut to 4 iterations, against the JAX package's solve:
    num_iters, al_iter and conv equal, trajectories, multipliers,
    infeasibilities and costs to 1e-8, or to 100 times the distance of the
    port's own solves from initial states one ulp away (these solves
    magnify any difference of rounding, as the free-dynamics ones do)."""
    ref = _fixture(f"{case}_")
    s = TOOL.SMALL[case]
    if case == "ur10":
        np.testing.assert_array_equal(ref["targets"], TOOL.ur10_targets(s["batch"]))
    else:
        np.testing.assert_array_equal(ref["x0s"], TOOL.solo_x0s(
            s["batch"], TOOL.solo_x0(s["nsteps"])))
    prob, kw = _small_problem(case, ref)
    cfg = at.solvers.ProxDDPConfig(**{**TOOL.SOLVE_OPTIONS[case],
                                      "max_iters": s["max_iters"]})
    got = at.solvers.solve(prob, cfg, **kw)
    for k in ("num_iters", "al_iter", "conv"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), ref[k], err_msg=k)
    spread = None
    for k in ("xs", "us", "vs", "lams", "prim_infeas", "dual_infeas", "traj_cost"):
        g, r = getattr(got, k).numpy(), ref[k]
        assert g.shape == r.shape, k
        if not g.size:
            continue
        scale = max(1.0, np.abs(r).max())
        err = np.abs(g - r).max() / scale
        if err > TOL_DERIV and spread is None:
            # these solves magnify rounding: the port's own solves from
            # initial states one ulp away, x0·(1 ± 1e-15), part as far
            runs = []
            for f in (1.0 + 1e-15, 1.0 - 1e-15):
                p1 = dataclasses.replace(prob, x0=prob.x0 * f)
                kw1 = (dict(zip(("xs_init", "us_init"), ur10_ballistic.warm_start(p1)))
                       if kw else {})
                runs.append(at.solvers.solve(p1, cfg, **kw1))
            spread = runs
        if spread is not None:
            apart = max(np.abs(getattr(s, k).numpy() - g).max() for s in spread) / scale
            assert err <= max(TOL_DERIV, 100 * apart), (k, err, apart)
        else:
            assert err <= TOL_DERIV, (k, err)


@pytest.mark.parametrize("case", ["ur10", "solo"])
def test_full_size_jax_reference_is_recorded(case):
    """The chip script's floor: the JAX package's conv on the first
    scenarios at the published size (4 throws, 64 jumps), for the
    scenarios the tool draws."""
    ref = _fixture(f"{case}_full_")
    n = TOOL.FULL_SCENARIOS[case]
    if case == "ur10":
        np.testing.assert_array_equal(ref["targets"], TOOL.ur10_targets(n))
        assert (ref["landing_err"][ref["conv"]] < 1e-3).all()
    else:
        np.testing.assert_array_equal(ref["x0s"], TOOL.solo_x0s(n, TOOL.solo_x0(TOOL.FULL[case])))
    assert ref["conv"].shape == ref["num_iters"].shape == (n,)


@pytest.mark.slow
def test_fixture_matches_a_live_jax_solve():
    """Every fixture entry computed live by the JAX package."""
    live = TOOL.references()
    with np.load(FIXTURE) as f:
        assert set(live) <= set(f.files)
        for k, v in live.items():
            np.testing.assert_allclose(f[k], v, rtol=1e-12, atol=1e-12, err_msg=k)
