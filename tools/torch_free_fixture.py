#!/usr/bin/env python
"""Write the reference fixture of the port's free-dynamics tests.

Every solve is the JAX package's ProxDDP, float64, jitted, each example's
published options:

* ``<case>_*`` for the small solves of ``tests/test_torch_free.py``: the UR5
  reach (``examples/ur5_reach.py``, N = 10), the dual-arm FFSR reach
  (``examples/dual_ffsr_reach.py``, the nominal model without collisions,
  N = 8), the double pendulum and the acrobot (N = 20), the flexible double
  pendulum and the UR10 midpoint reach (N = 10, the UR10 from its quasi-static warm
  start), 4 scenarios each (2 for the UR10), their iterations cut to
  ``SMALL[case]['max_iters']``; the scenarios are solved one after another
  (``lax.map``);
* ``<case>_full_*`` for ``chip_smoke.py``'s free-dynamics phase: the first
  16 scenarios of its batches at the published size (UR5 N = 40, FFSR N =
  60, acrobot N = 120), their ``conv`` and ``num_iters``, the floor its
  converged fractions are held to, ``jax.vmap``ped as the JAX package
  batches its scenarios.

Under ``jax.jit(jax.vmap(...))`` the JAX package's solve of the double
pendulum takes other steps (the first iteration's primal infeasibility
9.97 against 7.1e-6 on scenario 0) than its jit of one scenario and its
eager ``vmap``, which agree with each other and with the port; the small
solves are therefore mapped. The full-size paths' small counterparts
agree under both.

The initial states are made by :func:`x0s` from numpy seeds, the same
function ``chip_smoke.py`` draws its batches with (it checks its first 16
against ``<case>_full_x0s``). :func:`params` gives a case's problem leaves
as numpy arrays, from which ``aligator_tpu_torch.convert`` builds the
port's problem. ``tests/test_torch_free.py`` holds the port against the
archive; a ``slow`` test reruns these solves live.

* the jitted, vmapped references of the function tests (``alg_*`` the
  rigid-body algorithms, ``ode_*`` the free-dynamics ODEs and semi-implicit
  Euler, ``res_*`` the frame residuals, ``rollout_*`` the rollouts), at the
  inputs that :func:`algorithm_inputs`, :func:`ode_inputs`,
  :func:`residual_inputs` and :func:`rollout_inputs` draw.

Run from the repository root (~21 minutes on a CPU, most of it the
full-size solves; ``--only functions`` or ``--only solves`` recomputes one
group and keeps the rest of the archive)::

    python tools/torch_free_fixture.py [--only ...] [--out PATH]
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0  # chip_smoke.py's SEED
SEED_OFFSET = {"ur5": 9, "ffsr": 10, "acrobot": 11, "double_pendulum": 12,
               "flexible": 13, "ur10_midpoint": 14}
# the small solves' iterations: the paths are chaotic, rounding differences
# between the packages grow ~10x an iteration on the FFSR and the acrobot,
# so each is cut where the two still agree to 1e-8 (the flexible pendulum's
# line search rejects its first steps, in both)
SMALL = {
    "ur5": dict(nsteps=10, batch=4, max_iters=20),
    "ffsr": dict(nsteps=8, batch=4, max_iters=4),
    "double_pendulum": dict(nsteps=20, batch=4, max_iters=10),
    "acrobot": dict(nsteps=20, batch=4, max_iters=6),
    "flexible": dict(nsteps=10, batch=4, max_iters=4),
    "ur10_midpoint": dict(nsteps=10, batch=2, max_iters=3),
}
FULL = {"ur5": 40, "ffsr": 60, "acrobot": 120}
FULL_SCENARIOS = 16
SOLVE_OPTIONS = {
    "ur5": dict(tol=1e-4, mu_init=1e-2, max_iters=100, rollout="nonlinear"),
    "ffsr": dict(tol=1e-4, mu_init=1e-2, max_iters=120, rollout="nonlinear",
                 ls_strategy="armijo"),
    "double_pendulum": dict(tol=1e-5, mu_init=1e-2, max_iters=300, rollout="nonlinear"),
    "acrobot": dict(tol=2e-3, mu_init=1e-2, max_iters=250, rollout="nonlinear"),
    "flexible": dict(tol=1e-4, mu_init=1e-2, max_iters=200, rollout="nonlinear",
                     ls_strategy="armijo"),
    "ur10_midpoint": dict(tol=1e-4, mu_init=1e-2, max_iters=80, rollout="nonlinear",
                          rollout_max_iters=5, ls_strategy="armijo"),
}
RESULT_FIELDS = ("xs", "us", "vs", "lams", "conv", "num_iters", "al_iter",
                 "prim_infeas", "dual_infeas", "traj_cost")


def x0s(case, batch):
    """Initial states of ``case``, numpy seed ``SEED + SEED_OFFSET[case]``:
    the UR5 at its neutral configuration + 0.1·N(0, 1) on q and the UR10
    + 0.01·N(0, 1) (its quasi-static warm start holds only near the
    neutral configuration: from 0.1 its rollout reaches joint speeds of
    ~10³); the FFSR at the nominal arm posture + 0.05·N(0, 1) on the 14 arm
    joints; the pendulums at 0 + 0.1·N(0, 1) on the whole state; every
    velocity of the arms and the FFSR zero."""
    from aligator_tpu_torch.modelling.multibody.robots import FFSR_Q_ARM1, FFSR_Q_ARM2

    rng = np.random.default_rng(SEED + SEED_OFFSET[case])
    if case in ("ur5", "ur10_midpoint"):
        x = np.zeros((batch, 12))
        x[:, :6] = (0.1 if case == "ur5" else 0.01) * rng.standard_normal((batch, 6))
        return x
    if case == "ffsr":
        x = np.zeros((batch, 41))
        x[:, 6] = 1.0  # base quaternion w
        x[:, 7:21] = np.concatenate([FFSR_Q_ARM1, FFSR_Q_ARM2]) + 0.05 * rng.standard_normal(
            (batch, 14))
        return x
    nx = 8 if case == "flexible" else 4
    return 0.1 * rng.standard_normal((batch, nx))


def _jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    return jax


def jax_problem(case, nsteps):
    """The JAX package's problem of ``case`` (one scenario)."""
    _jax()
    if case == "ur5":
        from examples.ur5_reach import create_ur5_problem
        return create_ur5_problem(nsteps=nsteps)[0]
    if case == "ffsr":
        from examples.dual_ffsr_reach import create_ffsr_problem
        return create_ffsr_problem(nsteps=nsteps, use_mjcf=False)[0]
    if case == "double_pendulum":
        from examples.double_pendulum import create_double_pendulum_problem
        return create_double_pendulum_problem(nsteps=nsteps)[0]
    if case == "acrobot":
        from examples.acrobot import create_acrobot_problem
        return create_acrobot_problem(nsteps=nsteps)
    if case == "flexible":
        from examples.flexible_double_pendulum import create_flexible_pendulum_problem
        return create_flexible_pendulum_problem(nsteps=nsteps)[0]
    from examples.ur10_midpoint import create_ur10_midpoint_problem
    return create_ur10_midpoint_problem(nsteps=nsteps)[0]


def model_leaves(model):
    """A JAX robot model's leaves and topology, numpy (the keys of
    ``convert.robot_model_from_numpy``)."""
    from aligator_tpu_torch.modelling.multibody.model import LEAVES

    out = {k: np.asarray(getattr(model, k)) for k in LEAVES}
    out.update(joint_types=model.joint_types, parents=model.parents,
               frame_parents=model.frame_parents, frame_names=model.frame_names,
               armature=None if model.armature is None else np.asarray(model.armature))
    return out


def params(case, nsteps, x0):
    """The leaves of the JAX problem of ``case`` as numpy arrays, with the
    initial states ``x0``: the keys of its ``convert.*_from_numpy``."""
    import jax

    prob = jax_problem(case, nsteps)
    st = prob.stages
    ode = st.dynamics.ode
    costs = st.cost.costs
    model = jax.tree.map(lambda a: a[0], ode.model)  # the stages are stacked

    def w(k):  # the k-th stage cost's weights (the stages are stacked)
        return np.asarray(costs[k].weights[0])

    out = dict(model_leaves(model), x0=x0, timestep=np.asarray(st.dynamics.timestep[0]))
    if case == "ur5":
        res = costs[0].residual
        out.update(p_target=np.asarray(res.p_ref[0]), w_frame=w(0) / out["timestep"],
                   w_u=w(1) / out["timestep"],
                   w_v=w(2)[6:, 6:] / out["timestep"], w_term=np.asarray(prob.term_cost.weights))
    elif case == "ffsr":
        tc = prob.term_cost.costs
        out.update(R_targets=np.stack([np.asarray(c.residual.R_ref) for c in tc[:2]]),
                   p_targets=np.stack([np.asarray(c.residual.p_ref) for c in tc[:2]]),
                   u_max=np.asarray(st.constraints[0][1].upper[0]))
    elif case == "ur10_midpoint":
        out.update(x_ref=np.asarray(costs[0].residual.target[0]),
                   u0=np.asarray(costs[1].residual.target[0]),
                   p_target=np.asarray(prob.term_cost.residual.p_ref),
                   w_x=w(0), w_u=w(1), w_term=np.asarray(prob.term_cost.weights),
                   effort=np.asarray(st.constraints[0][1].upper[0]))
    else:
        out.update(actuation=np.asarray(ode.actuation[0]),
                   x_target=np.asarray(costs[0].residual.target[0]), w_x=w(0), w_u=w(1),
                   w_term=np.asarray(prob.term_cost.weights))
        if case == "flexible":
            out.update(stiffness=np.asarray(ode.stiffness[0]),
                       damping=np.asarray(ode.damping[0]), q_rest=np.asarray(ode.q_rest[0]))
    return out


def jax_solve(case, nsteps, x0, max_iters=None, batched=False):
    """The JAX package's solve of ``case`` from each row of ``x0``, one
    after another, or ``batched`` under ``vmap``."""
    jax = _jax()
    import jax.numpy as jnp

    from aligator_tpu import solvers
    from aligator_tpu._pytree import replace

    prob = jax_problem(case, nsteps)
    opts = dict(SOLVE_OPTIONS[case])
    if max_iters is not None:
        opts["max_iters"] = max_iters
    cfg = solvers.ProxDDPConfig(**opts)

    def one(x0):
        p = replace(prob, x0=x0)
        if case != "ur10_midpoint":
            return solvers.solve(p, cfg)
        from aligator_tpu.utils.rollout import rollout

        us = jnp.tile(p.stages.cost.costs[1].residual.target[0][None], (nsteps, 1))
        xs = rollout(p.stages.dynamics, p.stages.space, x0, us)
        return solvers.solve(p, cfg, xs_init=xs, us_init=us)

    res = jax.jit(jax.vmap(one) if batched else lambda x: jax.lax.map(one, x))(
        jnp.asarray(x0))
    return {k: np.asarray(getattr(res, k)) for k in RESULT_FIELDS}


# ---------------------------------------------------------------- functions
#
# the jitted, vmapped JAX references of tests/test_torch_free.py's function
# tests: the rigid-body algorithms on six models, the free-dynamics ODEs and
# semi-implicit Euler, the frame residuals and the rollouts, at the inputs
# that the functions below draw from numpy seeds

ALG_MODELS = {"ur5": "make_ur5", "ffsr": "make_dual_arm_ffsr",
              "double_pendulum": "make_double_pendulum", "free_sphere": "make_free_sphere",
              "ur10_payload": "make_ur10_with_payload", "pendulum": "make_pendulum"}


def states(jm, B, seed):
    """B random configurations (the neutral one moved by 0.5·N(0, 1) along
    the tangent), velocities, torques and external forces, numpy."""
    import jax

    rng = np.random.default_rng(seed)
    cs = jm.configuration_space()
    dq = 0.5 * rng.standard_normal((B, jm.nv))
    q = np.asarray(jax.vmap(lambda d: cs.integrate(jm.neutral(), d))(dq))
    return (q, rng.standard_normal((B, jm.nv)), rng.standard_normal((B, jm.nv)),
            rng.standard_normal((B, jm.njoints, 6)))


def jax_model(model):
    _jax()
    from aligator_tpu.modelling.multibody import robots

    return getattr(robots, ALG_MODELS[model])()


def algorithm_inputs(model):
    jm = jax_model(model)
    return jm, len(jm.frame_names) - 1, states(jm, 3, sorted(ALG_MODELS).index(model))


def algorithm_refs():
    jax = _jax()
    import jax.numpy as jnp

    from aligator_tpu.modelling.multibody import derivatives as jder
    from aligator_tpu.modelling.multibody import model as jrbd

    out = {}
    for model in ("ur5", "ffsr", "double_pendulum", "free_sphere", "ur10_payload"):
        jm, fid, (q, v, tau, fx) = algorithm_inputs(model)

        def one(q, v, tau, fx):
            a, da_dq, da_dv, solve_M = jder.aba_derivatives(jm, q, v, tau, fx)
            Jq, Jv = jder.frame_velocity_jacobians(jm, q, v, fid)
            return dict(
                aba=jrbd.aba(jm, q, v, tau), nle=jrbd.nonlinear_effects(jm, q, v),
                rnea_ext=jrbd.rnea(jm, q, v, tau, fx),
                a=a, da_dq=da_dq, da_dv=da_dv, da_dtau=solve_M(jnp.eye(jm.nv)),
                fvel=jrbd.frame_velocity(jm, q, v, fid), fvel_Jq=Jq, fvel_Jv=Jv,
                com=jrbd.center_of_mass(jm, q))

        ref = jax.jit(jax.vmap(one))(q, v, tau, fx)
        out.update({f"alg_{model}_{k}": np.asarray(x) for k, x in ref.items()})
    return out


def ode_inputs(kind):
    """The JAX ODE of ``kind`` ('free' on the FFSR, 'gravity_compensated' on
    the UR5, 'flexible'), its parameters (numpy) and its inputs x, u."""
    _jax()
    import jax.numpy as jnp

    from aligator_tpu.modelling.dynamics import multibody_free as jfree

    rng = np.random.default_rng(7)
    if kind == "flexible":
        from examples.flexible_double_pendulum import make_flexible_double_pendulum
        jm = make_flexible_double_pendulum()
        k, d, q_rest = rng.uniform(1, 50, 4), rng.uniform(0.05, 0.2, 4), \
            0.1 * rng.standard_normal(4)
        B = np.zeros((4, 2))
        B[0, 0] = B[2, 1] = 1.0
        pars = dict(actuation=B, stiffness=k, damping=d, q_rest=q_rest)
        jode = jfree.MultibodyFlexibleFwdDynamics(model=jm, **{
            n: jnp.asarray(a) for n, a in pars.items()})
    else:
        jm = jax_model("ffsr" if kind == "free" else "ur5")
        B = np.eye(jm.nv, jm.nv - 6, -6) if kind == "free" else np.eye(jm.nv)
        cls = ("MultibodyFreeFwdDynamics" if kind == "free"
               else "MultibodyGravityCompensatedDynamics")
        pars = dict(actuation=B)
        jode = getattr(jfree, cls)(model=jm, actuation=jnp.asarray(B))
    q, v, _, _ = states(jm, 3, 11)
    x = np.concatenate([q, v], -1)
    u = np.random.default_rng(12).standard_normal((3, B.shape[-1]))
    return jm, jode, pars, x, u


def ode_refs():
    jax = _jax()
    import jax.numpy as jnp

    from aligator_tpu.modelling import IntegratorSemiImplEuler

    out = {}
    for kind in ("free", "gravity_compensated", "flexible"):
        jm, jode, _, x, u = ode_inputs(kind)
        space = jm.phase_space()
        dyn = IntegratorSemiImplEuler(ode=jode, timestep=jnp.asarray(0.01))

        def one(x, u):
            r = dict(xdot=jode.xdot(space, x, u), y=dyn.forward(space, x, u))
            if hasattr(jode, "acc_derivatives"):
                r.update(zip(("a", "da_dq", "da_dv", "da_du"),
                             jode.acc_derivatives(space, x, u)))
            return r

        ref = jax.jit(jax.vmap(one))(x, u)
        out.update({f"ode_{kind}_{k}": np.asarray(a) for k, a in ref.items()})
    return out


def residual_inputs(model):
    """The JAX residuals (placement and velocity) on the last frame of
    ``model``, their parameters and inputs x, u."""
    _jax()
    import jax.numpy as jnp

    from aligator_tpu.modelling.multibody import model as jrbd
    from aligator_tpu.modelling.multibody import residuals as jres

    jm = jax_model(model)
    fid = len(jm.frame_names) - 1
    q, v, _, _ = states(jm, 3, 21)
    rng = np.random.default_rng(22)
    pars = dict(R_ref=np.asarray(jrbd.frame_placement(jm, q[1], fid)[0]),
                p_ref=rng.standard_normal(3), v_ref=rng.standard_normal(6), fid=fid)
    fns = {"placement": jres.FramePlacementResidual(
               model=jm, R_ref=jnp.asarray(pars["R_ref"]), p_ref=jnp.asarray(pars["p_ref"]),
               frame_id=fid),
           "velocity": jres.FrameVelocityResidual(model=jm, v_ref=jnp.asarray(pars["v_ref"]),
                                                  frame_id=fid)}
    x = np.concatenate([q, v], -1)
    return jm, fns, pars, x, rng.standard_normal((3, 2))


def residual_refs():
    jax = _jax()
    out = {}
    for model in ("ur5", "ffsr", "pendulum"):
        jm, fns, _, x, u = residual_inputs(model)
        space = jm.phase_space()
        ref = jax.jit(jax.vmap(lambda x, u: {
            name: (f.value(space, x, u), *f.jacobians(space, x, u))
            for name, f in fns.items()}))(x, u)
        for name, (val, Jx, Ju) in ref.items():
            out.update({f"res_{model}_{name}_value": np.asarray(val),
                        f"res_{model}_{name}_Jx": np.asarray(Jx),
                        f"res_{model}_{name}_Ju": np.asarray(Ju)})
    return out


def rollout_inputs():
    rng = np.random.default_rng(24)
    x0, us = 0.1 * rng.standard_normal((2, 12)), 0.01 * rng.standard_normal((2, 5, 6))
    K, xs_ref = 0.01 * rng.standard_normal((2, 5, 6, 12)), 0.1 * rng.standard_normal((2, 6, 12))
    kff = 0.01 * rng.standard_normal((2, 5, 6))
    return x0, us, xs_ref, K, kff


def rollout_refs():
    jax = _jax()
    import jax.numpy as jnp

    from aligator_tpu.modelling import IntegratorSemiImplEuler
    from aligator_tpu.modelling.dynamics import multibody_free as jfree
    from aligator_tpu.utils.rollout import closed_loop_rollout, rollout

    jm = jax_model("ur5")
    dyn = IntegratorSemiImplEuler(ode=jfree.MultibodyFreeFwdDynamics(
        model=jm, actuation=jnp.eye(6)), timestep=jnp.asarray(0.05))
    js = jm.phase_space()
    x0, us, xs_ref, K, kff = rollout_inputs()
    xs = jax.jit(jax.vmap(lambda x0, us: rollout(dyn, js, x0, us)))(x0, us)
    cl = jax.jit(jax.vmap(lambda *a: closed_loop_rollout(dyn, js, *a)))(x0, us, xs_ref, K, kff)
    return {"rollout_xs": np.asarray(xs), "rollout_closed_xs": np.asarray(cl[0]),
            "rollout_closed_us": np.asarray(cl[1])}


def function_refs():
    out = {}
    for fn in (algorithm_refs, ode_refs, residual_refs, rollout_refs):
        out.update(fn())
    return out


def solve_refs():
    out = {}
    for case, s in SMALL.items():
        x0 = x0s(case, s["batch"])
        out[f"{case}_x0s"] = x0
        out.update({f"{case}_{k}": v for k, v in
                    jax_solve(case, s["nsteps"], x0, s["max_iters"]).items()})
    for case, n in FULL.items():
        x0 = x0s(case, FULL_SCENARIOS)
        res = jax_solve(case, n, x0, batched=True)
        out.update({f"{case}_full_x0s": x0, f"{case}_full_conv": res["conv"],
                    f"{case}_full_num_iters": res["num_iters"]})
    return out


GROUPS = {"functions": function_refs, "solves": solve_refs}


def references(groups=tuple(GROUPS)):
    out = {}
    for g in groups:
        out.update(GROUPS[g]())
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(GROUPS))
    ap.add_argument("--out", dest="path",
                    default=os.path.join(ROOT, "tests", "data", "torch_free_ref.npz"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    old = {}
    if args.only and os.path.exists(args.path):
        with np.load(args.path) as f:
            old = {k: f[k] for k in f.files}
    refs = references(args.only or tuple(GROUPS))
    np.savez_compressed(args.path, **{**old, **refs})
    for case in FULL:
        if f"{case}_full_conv" in refs:
            print(case, "JAX converged", int(refs[f"{case}_full_conv"].sum()), "of",
                  FULL_SCENARIOS, "iterations", refs[f"{case}_full_num_iters"].tolist())
    print("wrote", args.path)


if __name__ == "__main__":
    main()
