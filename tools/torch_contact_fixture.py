#!/usr/bin/env python
"""Write the reference fixture of the port's contact-dynamics tests.

Every reference is the JAX package's, float64 on the CPU, jitted:

* ``kin_*``: the relative and world-frame contact kinematics, the primal
  constrained solve with a 6D loop constraint (the UR10 and its payload,
  the payload moved away from the tool) and with position references on
  world contacts (the quadruped's 3D feet, the humanoid's 6D soles), the
  loop constraint's ``acc_derivatives`` and ``xdot``, the centre-of-mass
  Jacobians, at the states of :func:`states`;
* ``fdrows_*``: the contact-dynamics derivative rows with kp ≠ 0 and
  position references (``derivatives._fd_rows_std`` and the Pallas kernel
  in interpret mode) on the quadruped;
* ``rnea_*``: ``underactuated_constrained_rnea`` on the UR10 grasp (square)
  and on the quadruped with a foot listed twice (rank-deficient);
* ``res_*``: the contact force, friction and wrench cone, centre-of-mass
  and gravity-compensation residuals, values and Jacobians;
* ``sched_*``: the contact force and cone residuals with an activity that
  varies over two stages (:func:`sched_refs`);
* ``prob_<case>_*``: ``compute_derivatives`` of each example's problem
  (``examples/ur10_ballistic.py``, ``solo_jump.py``, ``solo_bend.py``,
  ``biped_walk.py``, cut to a few stages) along a seeded trajectory;
* ``<case>_*`` for the small solves (UR10 throw N = 10, Solo jump N = 8, 2
  scenarios each, 4 iterations, ``lax.map``ped);
* ``<case>_full_*`` for ``chip_smoke.py``'s contact phase: the first
  scenarios of its batches (4 throws, 64 jumps) at the published size
  (UR10 N = 80, 400 iterations; Solo jump N = 28, 60 iterations),
  ``lax.map``ped (one
  scenario a solve, as the JAX package's own tests solve the throw; under
  ``vmap`` its solve of the same 4 throws takes other steps and converges
  none in 400 iterations): ``conv``, ``num_iters``, infeasibilities and
  the payload's landing error, the floor the card's converged count is
  held to.

:func:`ur10_targets` and :func:`solo_x0s` draw the scenarios from numpy
seeds; ``chip_smoke.py`` draws its batches with the same functions.
:func:`params` gives a case's problem leaves as numpy arrays, from which
``aligator_tpu_torch.convert`` builds the port's problem.
``tests/test_torch_contact.py`` holds the port against the archive; a
``slow`` test reruns it live.

Run from the repository root (``--only KEY...`` recomputes those groups,
``kin fdrows rnea res sched prob small full``, and keeps the rest of the
archive; ``full_ur10`` and ``full_solo`` are the two halves of ``full``)::

    python tools/torch_contact_fixture.py [--only ...] [--out PATH]
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(ROOT, "tests", "data", "torch_contact_ref.npz")
SEED = 0  # chip_smoke.py's SEED
SEED_OFFSET = {"ur10": 15, "solo": 16, "states": 17}
SMALL = {"ur10": dict(nsteps=10, batch=2, max_iters=4),
         "solo": dict(nsteps=(3, 2, 3), batch=2, max_iters=4)}
FULL = {"ur10": 80, "solo": (10, 8, 10)}
FULL_SCENARIOS = {"ur10": 4, "solo": 64}
PROB_SIZES = {"ur10": 10, "solo_jump": (3, 2, 3), "solo_bend": 6, "biped": (2, 2)}
SOLVE_OPTIONS = {
    "ur10": dict(tol=1e-4, dual_tol=1e-3, mu_init=1e-2, max_iters=400, rollout="linear",
                 ls_strategy="filter"),
    "solo": dict(tol=1e-3, mu_init=1e-2, max_iters=60, rollout="nonlinear"),
}
UR10_DT = 0.025
TARGET_POS = (1.0, 1.5, 0.0)
RESULT_FIELDS = ("xs", "us", "vs", "lams", "conv", "num_iters", "al_iter",
                 "prim_infeas", "dual_infeas", "traj_cost")
KP, KD = 1e-3, 2.0 * np.sqrt(1e-3)  # the throw's grasp gains
# the quadruped's 4 point feet make G rank-deficient: its primal solve is
# conditioning-limited at 1e-9, so it is compared at 1e-5
PROX = {"ur10": 1e-9, "quadruped": 1e-5, "humanoid": 1e-9}


def ur10_targets(batch):
    """The throw's targets ``(batch, 3)``: TARGET_POS + U(−0.1, 0.1) m per
    axis, numpy seed ``SEED + 15``; scenario 0 keeps TARGET_POS."""
    rng = np.random.default_rng(SEED + SEED_OFFSET["ur10"])
    t = np.asarray(TARGET_POS) + rng.uniform(-0.1, 0.1, (batch, 3))
    t[0] = TARGET_POS
    return t


def solo_x0s(batch, x0):
    """The jump's initial states ``(batch, nx)``: the standing state ``x0``
    with joint velocities 0.1·N(0, 1) (numpy seed ``SEED + 16``), the base
    at rest."""
    rng = np.random.default_rng(SEED + SEED_OFFSET["solo"])
    out = np.tile(np.asarray(x0), (batch, 1))
    out[:, -8:] = 0.1 * rng.standard_normal((batch, 8))  # nq 15, nv 14: v[6:]
    return out


def _jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    return jax


def model_leaves(model):
    """A JAX robot model's leaves and topology, numpy (the keys of
    ``convert.robot_model_from_numpy``)."""
    from aligator_tpu_torch.modelling.multibody.model import LEAVES

    out = {k: np.asarray(getattr(model, k)) for k in LEAVES}
    out.update(joint_types=model.joint_types, parents=model.parents,
               frame_parents=model.frame_parents, frame_names=model.frame_names,
               armature=None if model.armature is None else np.asarray(model.armature))
    return out


def jax_models():
    """``{name: (JAX model, contact frames, dims, second frames)}``: the UR10
    with its payload (the grasp), the quadruped (4 feet) and the humanoid
    (2 soles)."""
    _jax()
    from aligator_tpu.modelling.multibody import humanoid, quadruped, robots

    ur = robots.make_ur10_with_payload()
    qd = quadruped.make_quadruped()
    hu = humanoid.make_humanoid()
    return {
        "ur10": (ur, (ur.frame_id("ee"),), (6,), (ur.frame_id("mug"),)),
        "quadruped": (qd, tuple(qd.frame_id(f"foot{k}") for k in range(4)), (3,) * 4, None),
        "humanoid": (hu, (hu.frame_id("left_sole"), hu.frame_id("right_sole")), (6, 6), None),
    }


def states(name, model, B=3):
    """B configurations (the neutral one, or the base pose of the robot's
    workload, moved by 0.3·N(0, 1) along the tangent; the UR10's payload
    thrown 0.3 m off the tool), velocities, torques, controls, position
    references and activity flags, numpy."""
    import jax

    rng = np.random.default_rng(SEED + SEED_OFFSET["states"] + len(name))
    cs = model.configuration_space()
    q0 = np.asarray(model.neutral())
    if name == "quadruped":
        from aligator_tpu.modelling.multibody.quadruped import standing_configuration
        q0 = np.asarray(standing_configuration(model))
    elif name == "humanoid":
        from aligator_tpu.modelling.multibody.humanoid import half_sitting
        q0 = np.asarray(half_sitting(model))
    dq = 0.3 * rng.standard_normal((B, model.nv))
    q = np.array(jax.vmap(lambda d: cs.integrate(q0, d))(dq))
    if name == "ur10":
        q[:, 6:9] += 0.3 * rng.standard_normal((B, 3))
    ncont = {"ur10": 1, "quadruped": 4, "humanoid": 2}[name]
    act = np.ones((B, ncont))
    act[1, -1] = 0.0
    return dict(q=q, v=rng.standard_normal((B, model.nv)),
                tau=rng.standard_normal((B, model.nv)),
                p_refs=0.1 * rng.standard_normal((B, ncont, 3)), act=act)


def kin_refs():
    jax = _jax()
    import jax.numpy as jnp

    from aligator_tpu.modelling.multibody import contact as jc
    from aligator_tpu.modelling.multibody import derivatives as jder

    out = {}
    for name, (m, frames, dims, frames2) in jax_models().items():
        s = states(name, m)
        kd = 10.0 if name == "quadruped" else KD
        f1 = frames[0]

        def one(q, v, tau, pr, act):
            cfd = jc._cfd_internals(m, q, v, tau, frames, act, prox_mu=PROX[name], kp=1.0,
                                    kd=kd, p_refs=pr, contact_dims=dims,
                                    contact_frames2=frames2)
            r = dict(a=cfd["a"], lam=cfd["lam"],
                     point=jc.frame_point_and_world_velocity(m, q, v, f1),
                     cjac=jc.contact_jacobian(m, q, f1), cdrift=jc.contact_drift(m, q, v, f1),
                     com_jac=jder.com_jacobian(m, q),
                     com_vel_jac=jder.com_velocity_jacobians(m, q, v))
            if frames2 is not None:
                f2 = frames2[0]
                r.update({f"rel{d}": (jc.relative_velocity_lwa(m, q, v, f1, f2, d),
                                      jc.relative_jacobian_lwa(m, q, f1, f2, d),
                                      jc._rel_drift(m, q, v, f1, f2, d)) for d in (3, 6)})
            return r

        ref = jax.jit(jax.vmap(one))(s["q"], s["v"], s["tau"], s["p_refs"], s["act"])
        flat = jax.tree_util.tree_flatten_with_path(ref)[0]
        for path, leaf in flat:
            key = "_".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            out[f"kin_{name}_{key}"] = np.asarray(leaf)
        if frames2 is not None:
            # the loop constraint's ODE: xdot and acc_derivatives
            nu = 6
            Bm = jnp.asarray(np.eye(m.nv, nu))
            ode = jc.MultibodyConstraintFwdDynamics(
                model=m, actuation=Bm, active=jnp.ones(1), contact_frames=frames,
                contact_dims=dims, contact_frames2=frames2, prox_mu=PROX[name], kp=KP, kd=KD,
                p_refs=jnp.asarray(s["p_refs"][0]))
            sp = m.phase_space()
            x = np.concatenate([s["q"], s["v"]], -1)
            u = s["tau"][:, :nu]
            acc = jax.jit(jax.vmap(lambda x, u: (ode.xdot(sp, x, u),
                                                 ode.acc_derivatives(sp, x, u))))(x, u)
            out[f"kin_{name}_xdot"] = np.asarray(acc[0])
            for k, a in zip(("a", "da_dq", "da_dv", "da_du"), acc[1]):
                out[f"kin_{name}_acc_{k}"] = np.asarray(a)
    return out


def fdrows_refs():
    jax = _jax()
    import jax.numpy as jnp

    from aligator_tpu.modelling.multibody import contact as jc
    from aligator_tpu.modelling.multibody import derivatives as jder
    from aligator_tpu.modelling.multibody import model as jrbd
    from aligator_tpu.modelling.multibody import pallas_tensors

    m, frames, dims, _ = jax_models()["quadruped"]
    s = states("quadruped", m, 4)
    kp, kd = 50.0, 10.0
    bodies = tuple(m.frame_parents[f] for f in frames)
    top = jrbd._topology(m.joint_types, m.parents)
    A_np = np.asarray(top["A"], np.float64)
    D_np = A_np[top["dof_joint"], :]

    @jax.jit
    def reference(qs, vs, taus, act, prefs):
        def primal(q, v, t, a, pr):
            out = jc._cfd_internals(m, q, v, t, frames, a, prox_mu=1e-5, kp=kp, kd=kd,
                                    p_refs=pr, contact_dims=dims)
            return out["a"], out["lam"]

        a, lam = jax.vmap(primal)(qs, vs, taus, act, prefs)
        std = jax.vmap(lambda q, v, a, lam, ac, pr: jder._fd_rows_std(
            m, q, v, a, lam, ac, pr, frames, dims, kp, kd, True))(qs, vs, a, lam, act, prefs)
        S, Vb, Vpar, Vdof, Ca, Capar, Accb, h, y, I6, pcs = jax.vmap(
            lambda q, v, a: jder._prep_lane_inputs(m, q, v, a, frames))(qs, vs, a)
        ker = pallas_tensors.fd_rows_lanes(
            S, vs, Vb, Vpar, Vdof, Ca, Capar, Accb, h, y, I6, lam, pcs, act, prefs,
            jnp.asarray(A_np), jnp.asarray(D_np), jnp.asarray(D_np.T),
            contact_bodies=bodies, contact_dims=dims, kd=kd, kp=kp, has_prefs=True,
            interpret=True)
        return a, lam, std, ker

    a, lam, std, ker = reference(s["q"], s["v"], s["tau"], s["act"], s["p_refs"])
    out = {"fdrows_a": np.asarray(a), "fdrows_lam": np.asarray(lam)}
    for i, n in enumerate(("ra1_q", "ra1_v", "r2_q", "r2_v")):
        out[f"fdrows_std_{n}"] = np.asarray(std[i])
        out[f"fdrows_ker_{n}"] = np.asarray(ker[i])
    return out


def rnea_refs():
    jax = _jax()
    import jax.numpy as jnp

    from aligator_tpu.modelling.multibody import contact as jc

    out = {}
    models = jax_models()
    for name, dup in (("ur10", False), ("quadruped", True)):
        m, frames, dims, frames2 = models[name]
        if dup:  # a foot listed twice: [B, Jcᵀ] loses rank
            frames, dims = frames + frames[:1], dims + dims[:1]
        nu = 6 if name == "ur10" else m.nv - 6
        Bm = np.eye(m.nv, nu) if name == "ur10" else np.eye(m.nv, nu, -6)
        s = states(name, m)
        ref = jax.jit(jax.vmap(lambda q, v: jc.underactuated_constrained_rnea(
            m, q, v, jnp.asarray(Bm), frames, contact_dims=dims, contact_frames2=frames2)))(
            s["q"], 0.1 * s["v"])
        out[f"rnea_{name}_u"], out[f"rnea_{name}_f"] = map(np.asarray, ref)
    return out


def res_refs():
    jax = _jax()
    import jax.numpy as jnp

    from aligator_tpu.modelling.multibody import contact as jc
    from aligator_tpu.modelling.multibody import residuals as jres

    out = {}
    for name, (m, frames, dims, _) in jax_models().items():
        if name == "ur10":
            continue
        s = states(name, m)
        nu = m.nv - 6
        Bm = jnp.asarray(np.eye(m.nv, nu, -6))
        act = jnp.ones(len(frames))
        sp = m.phase_space()
        x = np.concatenate([s["q"], s["v"]], -1)
        u = s["tau"][:, :nu]
        common = dict(model=m, actuation=Bm, active=act, contact_frames=frames,
                      contact_dims=dims, contact_id=1, prox_mu=PROX[name])
        fns = {"force": jc.ContactForceResidual(f_ref=jnp.arange(dims[1], dtype=float),
                                                **common),
               "com": jres.CenterOfMassTranslationResidual(model=m, p_ref=jnp.ones(3)),
               "comvel": jres.CenterOfMassVelocityResidual(model=m, v_ref=jnp.ones(3)),
               "gravity": jres.GravityCompensationResidual(model=m, actuation=Bm)}
        if dims[1] == 3:
            fns["friction"] = jc.MultibodyFrictionConeResidual(mu_friction=jnp.asarray(0.7),
                                                               **common)
        else:
            fns["wrench"] = jc.MultibodyWrenchConeResidual(
                mu_friction=jnp.asarray(0.7), half_length=jnp.asarray(0.1),
                half_width=jnp.asarray(0.05), **common)
        ref = jax.jit(jax.vmap(lambda x, u: {k: (f.value(sp, x, u), f.jacobians(sp, x, u))
                                             for k, f in fns.items()}))(x, u)
        for k, (val, (Jx, Ju)) in ref.items():
            out[f"res_{name}_{k}_value"] = np.asarray(val)
            out[f"res_{name}_{k}_Jx"] = np.asarray(Jx)
            out[f"res_{name}_{k}_Ju"] = np.asarray(Ju)
    return out


def sched_refs():
    """The contact force and the friction (3D) or wrench (6D) cone of
    contact 1 with a stage-varying activity: two stages, the second with
    every other contact off, at 3 × 2 states (the JAX package's stacked
    stages, one row of the schedule a stage)."""
    jax = _jax()
    import jax.numpy as jnp

    from aligator_tpu.modelling.multibody import contact as jc

    out = {}
    for name in ("quadruped", "humanoid"):
        m, frames, dims, _ = jax_models()[name]
        s = states(name, m, B=6)
        nu = m.nv - 6
        x = np.concatenate([s["q"], s["v"]], -1).reshape(3, 2, -1)
        u = s["tau"][:, :nu].reshape(3, 2, nu)
        sched = np.ones((2, len(frames)))
        sched[1, ::2] = 0.0
        Bm = jnp.asarray(np.eye(m.nv, nu, -6))
        sp = m.phase_space()
        out.update({f"sched_{name}_x": x, f"sched_{name}_u": u, f"sched_{name}_active": sched})
        for t in range(2):
            common = dict(model=m, actuation=Bm, active=jnp.asarray(sched[t]),
                          contact_frames=frames, contact_dims=dims, contact_id=1,
                          prox_mu=PROX[name])
            fns = {"force": jc.ContactForceResidual(f_ref=jnp.arange(dims[1], dtype=float),
                                                    **common)}
            if dims[1] == 3:
                fns["cone"] = jc.MultibodyFrictionConeResidual(mu_friction=jnp.asarray(0.7),
                                                               **common)
            else:
                fns["cone"] = jc.MultibodyWrenchConeResidual(
                    mu_friction=jnp.asarray(0.7), half_length=jnp.asarray(0.1),
                    half_width=jnp.asarray(0.05), **common)
            ref = jax.jit(jax.vmap(lambda x, u: {
                k: (f.value(sp, x, u), *f.jacobians(sp, x, u)) for k, f in fns.items()}))(
                    x[:, t], u[:, t])
            for k, vals in ref.items():
                for field, v in zip(("value", "Jx", "Ju"), vals):
                    key = f"sched_{name}_{k}_{field}"
                    out.setdefault(key, np.zeros((3, 2) + v.shape[1:]))[:, t] = np.asarray(v)
    return out


def jax_problem(case, size, target_pos=TARGET_POS):
    """The JAX package's problem of ``case`` (one scenario) at ``size``."""
    _jax()
    if case == "ur10":
        from examples.ur10_ballistic import create_ur10_ballistic_problem
        return create_ur10_ballistic_problem(nsteps=size, timestep=UR10_DT,
                                             target_pos=np.asarray(target_pos))[0]
    if case in ("solo", "solo_jump"):
        from examples.solo_jump import create_solo_jump_problem
        return create_solo_jump_problem(*size)[0]
    if case == "solo_bend":
        from examples.solo_bend import create_solo_bend_problem
        return create_solo_bend_problem(nsteps=size)[0]
    from examples.biped_walk import create_biped_walk_problem
    return create_biped_walk_problem(n_ds=size[0], n_ss=size[1])[0]


def params(case, size, x0=None, target_pos=TARGET_POS):
    """The leaves of the JAX problem of ``case`` as numpy arrays (the keys of
    its ``convert.*_from_numpy``), with the initial states ``x0`` (the
    problem's own by default) and, for the UR10, ``target_pos``."""
    import jax

    prob = jax_problem(case, size)
    st = prob.stages
    ode = st.dynamics.ode
    costs = st.cost.costs
    model = jax.tree.map(lambda a: a[0], ode.model)  # the stages are stacked
    out = dict(model_leaves(model), timestep=np.asarray(st.dynamics.timestep[0]),
               x0=np.asarray(prob.x0)[None] if x0 is None else x0,
               active=np.asarray(ode.active), w_x=np.asarray(costs[0].weights[0]),
               w_u=np.asarray(costs[1].weights[0]), w_term=np.asarray(prob.term_cost.weights),
               kd=float(ode.kd), prox_mu=float(ode.prox_mu))
    if case == "ur10":
        out.update(u0=np.asarray(costs[1].residual.target[0]),
                   effort=np.asarray(st.constraints[0][1].upper[0]),
                   vel_limits=np.asarray(st.constraints[1][1].upper[0]),
                   target_pos=np.asarray(target_pos), p_refs=np.asarray(ode.p_refs[0]),
                   kp=float(ode.kp))
    else:
        out.update(actuation=np.asarray(ode.actuation[0]),
                   targets=np.asarray(costs[0].residual.target),
                   term_target=np.asarray(prob.term_cost.residual.target),
                   contact_frames=np.asarray(ode.contact_frames))
    return out


def trajectory(case, nsteps, nx, nu, x0, seed):
    """A seeded trajectory near ``x0``: xs (N + 1, nx) moved 0.05·N(0, 1)
    along the tangent, us 0.5·N(0, 1)."""
    import jax

    prob = jax_problem(case, PROB_SIZES[case])
    sp = prob.space
    rng = np.random.default_rng(seed)
    dx = 0.05 * rng.standard_normal((nsteps + 1, sp.ndx))
    xs = np.asarray(jax.vmap(lambda d: sp.integrate(x0, d))(dx))
    return xs, 0.5 * rng.standard_normal((nsteps, nu))


def prob_refs():
    jax = _jax()
    from aligator_tpu.core import problem as jproblem

    out = {}
    for k, case in enumerate(PROB_SIZES):
        prob = jax_problem(case, PROB_SIZES[case])
        xs, us = trajectory(case, prob.nsteps, prob.space.nx, prob.nu, prob.x0, 100 + k)
        ref = jax.jit(lambda xs, us: jproblem.compute_derivatives(prob, xs, us))(xs, us)
        out[f"prob_{case}_xs"], out[f"prob_{case}_us"] = xs, us
        for f, v in vars(ref).items():
            if v is not None:
                out[f"prob_{case}_{f}"] = np.asarray(v)
    return out


def jax_solve(case, size, x0s=None, targets=None, max_iters=None, batched=False):
    """The JAX package's solve of ``case``: the UR10 throw at each target of
    ``targets`` from its warm start, the Solo jump from each row of
    ``x0s``; one after another, or ``batched`` under ``vmap``."""
    jax = _jax()
    import jax.numpy as jnp

    from aligator_tpu import solvers
    from aligator_tpu._pytree import replace
    from aligator_tpu.utils.rollout import rollout

    prob = jax_problem(case, size)
    opts = dict(SOLVE_OPTIONS[case])
    if max_iters is not None:
        opts["max_iters"] = max_iters
    cfg = solvers.ProxDDPConfig(**opts)
    if case == "ur10":
        (fn, eq), vel = prob.term_constraints

        def one(target):
            p = replace(prob, term_constraints=((replace(fn, p_ref=target), eq), vel))
            u0 = p.stages.cost.costs[1].residual.target[0]
            us = jnp.tile(u0[None], (p.nsteps, 1))
            xs = rollout(p.stages.dynamics, p.space, p.x0, us)
            return solvers.solve(p, cfg, xs_init=xs, us_init=us)

        arg = jnp.asarray(targets)
    else:
        def one(x0):
            return solvers.solve(replace(prob, x0=x0), cfg)

        arg = jnp.asarray(x0s)
    res = jax.jit(jax.vmap(one) if batched else lambda a: jax.lax.map(one, a))(arg)
    return {k: np.asarray(getattr(res, k)) for k in RESULT_FIELDS}


def solo_x0(size):
    return np.asarray(jax_problem("solo", size).x0)


def small_refs():
    out = {}
    s = SMALL["ur10"]
    t = ur10_targets(s["batch"])
    out["ur10_targets"] = t
    out.update({f"ur10_{k}": v for k, v in
                jax_solve("ur10", s["nsteps"], targets=t, max_iters=s["max_iters"]).items()})
    s = SMALL["solo"]
    x0 = solo_x0s(s["batch"], solo_x0(s["nsteps"]))
    out["solo_x0s"] = x0
    out.update({f"solo_{k}": v for k, v in
                jax_solve("solo", s["nsteps"], x0s=x0, max_iters=s["max_iters"]).items()})
    return out


def full_ur10_refs():
    t = ur10_targets(FULL_SCENARIOS["ur10"])
    res = jax_solve("ur10", FULL["ur10"], targets=t)
    land = np.abs(res["xs"][:, -1, 6:9] - t).max(-1)
    return dict(ur10_full_targets=t, ur10_full_conv=res["conv"],
                ur10_full_num_iters=res["num_iters"], ur10_full_landing_err=land,
                ur10_full_prim_infeas=res["prim_infeas"],
                ur10_full_dual_infeas=res["dual_infeas"])


def full_solo_refs():
    x0 = solo_x0s(FULL_SCENARIOS["solo"], solo_x0(FULL["solo"]))
    res = jax_solve("solo", FULL["solo"], x0s=x0)
    return dict(solo_full_x0s=x0, solo_full_conv=res["conv"],
                solo_full_num_iters=res["num_iters"],
                solo_full_peak=res["xs"][:, :, 2].max(-1))


def full_refs():
    return {**full_ur10_refs(), **full_solo_refs()}


GROUPS = {"kin": kin_refs, "fdrows": fdrows_refs, "rnea": rnea_refs, "res": res_refs,
          "sched": sched_refs,
          "prob": prob_refs, "small": small_refs, "full": full_refs,
          "full_ur10": full_ur10_refs, "full_solo": full_solo_refs}
ALL = ("kin", "fdrows", "rnea", "res", "sched", "prob", "small", "full")


def references(groups=ALL):
    out = {}
    for g in groups:
        out.update(GROUPS[g]())
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(GROUPS))
    ap.add_argument("--out", dest="path", default=PATH)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    old = {}
    if args.only and os.path.exists(args.path):
        with np.load(args.path) as f:
            old = {k: f[k] for k in f.files}
    refs = references(args.only or ALL)
    np.savez_compressed(args.path, **{**old, **refs})
    for case in ("ur10", "solo"):
        if f"{case}_full_conv" in refs:
            print(case, "JAX converged", int(refs[f"{case}_full_conv"].sum()), "of",
                  FULL_SCENARIOS[case], "iterations",
                  refs[f"{case}_full_num_iters"].tolist())
    if "ur10_full_landing_err" in refs:
        print("ur10 landing errors", refs["ur10_full_landing_err"].tolist())
    print("wrote", args.path)


if __name__ == "__main__":
    main()
