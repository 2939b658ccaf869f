#!/usr/bin/env python
"""Write the reference fixture of the port's geometry and collision tests.

Every reference is the JAX package's, float64 on the CPU, jitted:

* ``prim_*``: the distance primitives, support maps, the triangle's
  least-norm point, the segment-segment distance, ``convex_distance`` (a
  sphere, a convex hull and a cylinder against boxes),
  ``capsule_box_distance`` and ``hull_halfspace_distance`` of
  ``aligator_tpu/modelling/multibody/geometry.py`` and
  ``extra_residuals.py``, values and Jacobians (``jax.jacfwd``) at the
  seeded inputs of :func:`prim_inputs`;
* ``res_<name>_*``: every residual of ``geometry.py`` and
  ``extra_residuals.py`` (:data:`RESIDUALS`), value and Jacobians, at the
  states of :func:`states`;
* ``prob_<case>_*``: ``compute_derivatives`` of each example's problem
  (:data:`PROB_SIZES`: ``examples/ur5_table.py``, ``ur5_ballistic.py``,
  ``panda_reach.py`` on the nominal Panda, ``quadrotor.py`` without and
  with its terminal constraint, ``talos_arms.py``, ``dual_ffsr_reach.py``
  with both collision flags, cut to a few stages) along a seeded
  trajectory;
* ``<case>_*`` for the small solves (:data:`SMALL`: the UR5 table, the
  Panda reach and the quadrotor, 2 scenarios each, 4 iterations, one
  scenario at a time through ``lax.map``);
* ``table_full_*`` for ``chip_smoke.py``'s UR5 table phase: the first 16
  scenarios of its batch (:func:`table_x0s`) at the published size and
  options (N = 30, ``ProxDDPConfig(tol=1e-4, mu_init=1e-2,
  max_iters=100)``), one at a time: ``conv``, ``num_iters``, the end
  effector's lowest height, the floor the card's converged count is held
  to.

:func:`params` gives a case's problem leaves as numpy arrays, from which
``aligator_tpu_torch.convert`` builds the port's problem.
``tests/test_torch_geometry.py`` and ``tests/test_torch_collision.py`` hold
the port against the archive; a ``slow`` test in each reruns it live.

Run from the repository root (``--only KEY...`` recomputes those groups,
``prim res prob small full``, and keeps the rest of the archive)::

    python tools/torch_collision_fixture.py [--only ...] [--out PATH]
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(ROOT, "tests", "data", "torch_collision_ref.npz")
SEED = 0  # chip_smoke.py's SEED
SEED_OFFSET = {"prim": 30, "states": 31, "table": 18}
K = 6  # samples of each primitive
TABLE_Q0 = (0.0, -1.2, 1.6, 0.0, 0.0, 0.0)
TABLE_FULL = dict(nsteps=30, scenarios=16)
TABLE_OPTIONS = dict(tol=1e-4, mu_init=1e-2, max_iters=100)
PROB_SIZES = {"ur5_table": 5, "ur5_ballistic": 5, "panda": 5, "quadrotor": 5,
              "quadrotor-term": 5, "talos_arms": 5, "ffsr": 3}
SMALL = {"table": dict(nsteps=10, batch=2, max_iters=4, options=TABLE_OPTIONS),
         "panda": dict(nsteps=10, batch=2, max_iters=4,
                       options=dict(tol=1e-4, mu_init=1e-2, rollout="nonlinear")),
         "quadrotor": dict(nsteps=10, batch=2, max_iters=4,
                           options=dict(tol=1e-4, mu_init=1e-2, rollout="nonlinear"))}
RESULT_FIELDS = ("xs", "us", "vs", "lams", "conv", "num_iters", "al_iter",
                 "prim_infeas", "dual_infeas", "traj_cost")

# residual name: (module, class, model, numeric fields, frame fields)
RESIDUALS = {
    "halfspace": ("geometry", "FrameHalfspaceResidual", "ur5", dict(
        normal=(0.1, -0.2, 0.9746794344808963), plane_offset=0.2, offset=(0.01, 0.02, 0.03),
        radius=0.04, axis=(0.0, 0.6, 0.8), half_len=0.06, margin=0.01), dict(frame_id="ee")),
    "sphere": ("geometry", "FrameSphereResidual", "ur5", dict(
        center_obs=(0.4, 0.1, 0.3), radius_obs=0.1, offset=(0.0, 0.0, 0.05), radius=0.05,
        margin=0.02), dict(frame_id="ee")),
    "box": ("geometry", "FrameBoxResidual", "ur5", dict(
        box_center=(0.35, 0.05, 0.25), box_rot="rot", half_extents=(0.08, 0.1, 0.12),
        offset=(0.0, 0.01, 0.0), radius=0.04, margin=0.01), dict(frame_id="ee")),
    "sphere_sphere": ("geometry", "FrameSphereSphereResidual", "upper_body", dict(
        offset1=(0.0, 0.0, 0.02), radius1=0.05, offset2=(0.01, 0.0, 0.0), radius2=0.06,
        margin=0.02), dict(frame_id1="left_gripper", frame_id2="right_gripper")),
    "hull_box": ("geometry", "FrameConvexHullObstacleResidual", "ur5", dict(
        local_verts="verts", obs_center=(0.4, 0.0, 0.1), obs_rot="rot",
        obs_half_extents=(0.1, 0.15, 0.2), margin=0.01),
        dict(frame_id="ee", obstacle_kind="box")),
    "hull_cylinder": ("geometry", "FrameConvexHullObstacleResidual", "ur5", dict(
        local_verts="verts", obs_center=(0.3, 0.3, 0.0), obs_rot="rot",
        obs_half_extents=(0.1, 0.1, 0.3), margin=0.01),
        dict(frame_id="ee", obstacle_kind="cylinder")),
    "capsule_box": ("geometry", "FrameCapsuleBoxResidual", "ur5", dict(
        offset=(0.0, 0.0, 0.03), axis=(0.0, 0.0, 1.0), half_len=0.05, radius=0.03,
        box_center=(0.45, -0.1, 0.2), box_rot="rot", half_extents=(0.05, 0.1, 0.08),
        margin=0.01), dict(frame_id="ee")),
    "frame_collision": ("extra_residuals", "FrameCollisionResidual", "ur5", dict(
        seg_a=(0.3, 0.2, 0.0), seg_b=(0.3, 0.2, 0.8), radius=0.12), dict(frame_id="ee")),
    "fly_high": ("extra_residuals", "FlyHighResidual", "humanoid", dict(slope=0.05),
                 dict(frame_id="left_sole")),
    "dcm": ("extra_residuals", "DCMPositionResidual", "humanoid", dict(
        omega_inv=0.3, ref=(0.02, -0.01, 0.9)), {}),
    "momentum": ("extra_residuals", "CentroidalMomentumResidual", "humanoid", dict(
        h_ref=(0.1, -0.2, 0.3, 0.01, 0.02, -0.03)), {}),
    "momentum_derivative": ("extra_residuals", "CentroidalMomentumDerivativeResidual",
                            "humanoid", dict(actuation="actuation",
                                             h_ref=(0.1, 0.2, -0.3, 0.0, 0.1, 0.0)), {}),
    "link_collision": ("extra_residuals", "LinkCollisionResidual", "upper_body", dict(
        axis1=(0.0, 0.0, 1.0), half_len1=0.12, radius1=0.06, axis2=(0.0, 0.6, 0.8),
        half_len2=0.1, radius2=0.05, offset1=(0.0, 0.0, 0.01), offset2=(0.01, 0.0, 0.0),
        margin=0.02), dict(frame_id1="left_gripper", frame_id2="right_gripper")),
    "ballistic": ("extra_residuals", "BallisticLandingResidual", "ur5", dict(
        target_xy=(1.6, 0.8), gravity=9.81, z_ground=0.0), dict(frame_id="ee")),
}


def _jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    return jax


def _rotation(rng):
    Q, R = np.linalg.qr(rng.standard_normal((3, 3)))
    Q = Q * np.sign(np.diag(R))
    return Q if np.linalg.det(Q) > 0 else -Q


def prim_inputs():
    """The seeded inputs of the primitives, numpy, K samples each: points,
    segments, unit normals and offsets, boxes (centres, rotations,
    half-extents), spheres, triangles, directions, a cylinder and a hull's
    vertices (8 of them) moved per sample."""
    rng = np.random.default_rng(SEED + SEED_OFFSET["prim"])

    def vec(scale=1.0):
        return scale * rng.standard_normal((K, 3))

    n = vec()
    out = dict(p=vec(), a=vec(), b=vec(), normal=n / np.linalg.norm(n, axis=-1)[:, None],
               offset=rng.standard_normal(K), center=vec(0.3),
               rot=np.stack([_rotation(rng) for _ in range(K)]),
               half=rng.uniform(0.2, 1.0, (K, 3)), c1=vec(), c2=vec(),
               r1=rng.uniform(0.1, 0.5, K), r2=rng.uniform(0.1, 0.5, K),
               p0=vec(), p1=vec(), p2=vec(), d=vec(), q1=vec(), q2=vec(),
               sphere_c=vec(0.5) + np.array([3.0, 0.5, -0.5]),
               hull=rng.standard_normal((8, 3)) * 0.3, hull_shift=vec(0.2) + np.array(
                   [0.0, 2.5, 0.5]),
               cyl_c=vec(0.3) + np.array([0.2, -0.3, 2.5]),
               cyl_r=rng.uniform(0.2, 0.5, K), cyl_h=rng.uniform(0.2, 0.8, K),
               cap_a=vec(0.3) + np.array([2.0, 0.3, 0.0]),
               cap_b=vec(0.3) + np.array([2.5, -0.5, 1.0]), cap_r=rng.uniform(0.05, 0.3, K))
    return out


def prim_refs():
    jax = _jax()
    import jax.numpy as jnp

    from aligator_tpu.modelling.multibody import extra_residuals as ex
    from aligator_tpu.modelling.multibody import geometry as geo

    s = {k: jnp.asarray(v) for k, v in prim_inputs().items()}
    fns = {
        "point_halfspace": (lambda p, n, o: geo.point_halfspace_distance(p, n, o),
                            ("p", "normal", "offset")),
        "segment_halfspace": (lambda a, b, n, o: geo.segment_halfspace_distance(a, b, n, o),
                              ("a", "b", "normal", "offset")),
        "point_box": (lambda p, c, R, h: geo.point_box_distance(p, c, R, h),
                      ("p", "center", "rot", "half")),
        "point_segment": (lambda p, a, b: geo.point_segment_distance(p, a, b), ("p", "a", "b")),
        "sphere_sphere": (lambda c1, r1, c2, r2: geo.sphere_sphere_distance(c1, r1, c2, r2),
                          ("c1", "r1", "c2", "r2")),
        "support_sphere": (lambda d, c, r: geo.support_sphere(c, r, d), ("d", "c1", "r1")),
        "support_capsule": (lambda d, a, b, r: geo.support_capsule(a, b, r, d),
                            ("d", "a", "b", "r1")),
        "support_box": (lambda d, c, R, h: geo.support_box(c, R, h, d),
                        ("d", "center", "rot", "half")),
        "support_cylinder": (lambda d, c, R, r, h: geo.support_cylinder(c, R, r, h, d),
                             ("d", "center", "rot", "r1", "r2")),
        "support_hull": (lambda d, v: geo.support_hull(s["hull"] + v, d), ("d", "hull_shift")),
        "min_norm_triangle": (lambda p0, p1, p2: geo._min_norm_triangle(p0, p1, p2),
                              ("p0", "p1", "p2")),
        "segment_sqdist": (lambda p1, q1, p2, q2: ex._segment_segment_sqdist(p1, q1, p2, q2),
                           ("p1", "q1", "p2", "q2")),
        "hull_halfspace": (lambda v, n, o: geo.hull_halfspace_distance(s["hull"] + v, n, o),
                           ("hull_shift", "normal", "offset")),
        "convex_sphere_box": (lambda c, r, bc, R, h: geo.convex_distance(
            lambda u: geo.support_sphere(c, r, u),
            lambda u: geo.support_box(bc, R, h, u))[0],
            ("sphere_c", "r1", "center", "rot", "half")),
        "convex_hull_box": (lambda v, bc, R, h: geo.convex_distance(
            lambda u: geo.support_hull(s["hull"] + v, u),
            lambda u: geo.support_box(bc, R, h, u),
            x_init=v - bc)[0], ("hull_shift", "center", "rot", "half")),
        "convex_cylinder_box": (lambda c, R, r, hl, bc, h: geo.convex_distance(
            lambda u: geo.support_cylinder(c, R, r, hl, u),
            lambda u: geo.support_box(bc, jnp.eye(3), h, u))[0],
            ("cyl_c", "rot", "cyl_r", "cyl_h", "center", "half")),
        "capsule_box": (lambda a, b, r, c, R, h: geo.capsule_box_distance(a, b, r, c, R, h),
                        ("cap_a", "cap_b", "cap_r", "center", "rot", "half")),
    }
    out = {}
    for name, (f, args) in fns.items():
        vals = [s[a] for a in args]
        out[f"prim_{name}_value"] = np.asarray(jax.jit(jax.vmap(f))(*vals))
        # the Jacobian with respect to the first argument (a point or a
        # direction)
        out[f"prim_{name}_jac"] = np.asarray(jax.jit(jax.vmap(jax.jacfwd(f)))(*vals))
    return out


def jax_model(name):
    """The JAX package's model ``name``: ur5, upper_body or humanoid."""
    _jax()
    from aligator_tpu.modelling.multibody import humanoid, robots

    return {"ur5": robots.make_ur5, "upper_body": humanoid.make_humanoid_upper_body,
            "humanoid": humanoid.make_humanoid}[name]()


def states(model, B=3, seed=0):
    """B states (q, v) and controls of ``model``, numpy: its neutral
    configuration moved by 0.3·N(0, 1) along the tangent (the humanoid's
    base lifted to 1 m), velocities N(0, 1), controls N(0, 1) of size nv."""
    import jax

    rng = np.random.default_rng(SEED + SEED_OFFSET["states"] + seed)
    cs = model.configuration_space()
    q0 = np.array(model.neutral())
    if model.nq > model.nv:
        q0[2] = 1.0
    dq = 0.3 * rng.standard_normal((B, model.nv))
    q = np.array(jax.vmap(lambda d: cs.integrate(q0, d))(dq))
    return (np.concatenate([q, rng.standard_normal((B, model.nv))], -1),
            rng.standard_normal((B, model.nv)))


def residual_leaves(name, nv):
    """The numeric fields of residual ``name`` (:data:`RESIDUALS`), numpy:
    "rot" a fixed rotation, "verts" a hull of 6 points in the frame,
    "actuation" the humanoid's (nv, nv − 6) selector."""
    rng = np.random.default_rng(SEED + SEED_OFFSET["states"] + 100)
    special = dict(rot=_rotation(rng), verts=0.05 * rng.standard_normal((6, 3)),
                   actuation=np.eye(nv, nv - 6, -6))
    return {k: special[v] if isinstance(v, str) else np.asarray(v, np.float64)
            for k, v in RESIDUALS[name][3].items()}


def jax_residual(name, model):
    _jax()
    import jax.numpy as jnp

    from aligator_tpu.modelling.multibody import extra_residuals, geometry

    mod, cls, _, _, frames = RESIDUALS[name]
    module = {"geometry": geometry, "extra_residuals": extra_residuals}[mod]
    kw = {k: jnp.asarray(v) for k, v in residual_leaves(name, model.nv).items()}
    kw.update({k: (model.frame_id(v) if k.startswith("frame_id") else v)
               for k, v in frames.items()})
    return getattr(module, cls)(model=model, **kw)


def res_refs():
    jax = _jax()

    out = {}
    for k, name in enumerate(RESIDUALS):
        model = jax_model(RESIDUALS[name][2])
        f = jax_residual(name, model)
        x, u = states(model, seed=k)
        sp = model.phase_space()
        if name == "momentum_derivative":
            u = u[:, :model.nv - 6]
        val, (Jx, Ju) = jax.jit(jax.vmap(lambda x, u: (f.value(sp, x, u),
                                                       f.jacobians(sp, x, u))))(x, u)
        out.update({f"res_{name}_x": x, f"res_{name}_u": u,
                    f"res_{name}_value": np.asarray(val), f"res_{name}_Jx": np.asarray(Jx),
                    f"res_{name}_Ju": np.asarray(Ju)})
    return out


def jax_problem(case, size):
    """The JAX package's problem of ``case`` (one scenario) at ``size``."""
    _jax()
    if case == "ur5_table":
        from examples.ur5_table import create_ur5_table_problem
        return create_ur5_table_problem(nsteps=size)[0]
    if case == "ur5_ballistic":
        from examples.ur5_ballistic import create_ballistic_problem
        return create_ballistic_problem(nsteps=size)[0]
    if case == "panda":
        from examples.panda_reach import create_panda_problem
        return create_panda_problem(nsteps=size, real_model=False)[0]
    if case in ("quadrotor", "quadrotor-term"):
        from examples.quadrotor import create_quadrotor_problem
        return create_quadrotor_problem(nsteps=size, term_cstr=case == "quadrotor-term")
    if case == "talos_arms":
        from examples.talos_arms import create_talos_arms_problem
        return create_talos_arms_problem(nsteps=size)[0]
    from examples.dual_ffsr_reach import create_ffsr_problem
    return create_ffsr_problem(nsteps=size, with_collision=True, with_self_collision=True,
                               use_mjcf=False)[0]


def model_leaves(model):
    """A JAX robot model's leaves and topology, numpy (the keys of
    ``convert.robot_model_from_numpy``)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from torch_contact_fixture import model_leaves as leaves

    return leaves(model)


def params(case, size, x0=None):
    """The leaves of the JAX problem of ``case`` as numpy arrays (the keys
    of its ``convert.*_from_numpy``), with the initial states ``x0`` (the
    problem's own by default)."""
    import jax

    from aligator_tpu_torch.convert import BOX_FIELDS, TABLE_FIELDS

    prob = jax_problem(case, size)
    st = jax.tree.map(lambda a: a[0], prob.stages)  # the stages are stacked
    ode = st.dynamics.ode
    costs = st.cost.costs
    dt = np.asarray(st.dynamics.timestep)
    out = dict(model_leaves(ode.model), timestep=dt,
               x0=np.asarray(prob.x0)[None] if x0 is None else x0)
    if case == "ur5_table":
        cons = st.constraints
        out.update(p_target=np.asarray(costs[0].residual.p_ref),
                   w_frame=np.asarray(costs[0].weights) / dt,
                   w_u=np.asarray(costs[1].weights) / dt,
                   w_v=np.asarray(costs[2].weights)[6:, 6:] / dt,
                   w_term=np.asarray(prob.term_cost.weights),
                   tau_bound=np.asarray(cons[0][1].upper[0]))
        out.update({f"table_{k}": np.asarray(getattr(cons[1][0], k)) for k in TABLE_FIELDS})
        if len(cons) > 2:
            out.update({"box_" + k.removeprefix("box_"): np.asarray(getattr(cons[2][0], k))
                        for k in BOX_FIELDS})
    elif case == "ur5_ballistic":
        landing = prob.term_constraints[0][0]
        out.update(target_xy=np.asarray(landing.target_xy), g=np.asarray(landing.gravity),
                   z_ground=np.asarray(landing.z_ground), w_x=np.asarray(costs[0].weights),
                   w_u=np.asarray(costs[1].weights), w_term=np.asarray(prob.term_cost.weights),
                   tau_bound=np.asarray(st.constraints[0][1].upper[0]))
    elif case == "panda":
        pose = costs[0].residual
        out.update(R_target=np.asarray(pose.R_ref), p_target=np.asarray(pose.p_ref),
                   w_pose=np.asarray(costs[0].weights) / dt,
                   w_u=np.asarray(costs[1].weights) / dt,
                   w_term_pose=np.asarray(prob.term_cost.costs[0].weights),
                   w_term_vel=np.asarray(prob.term_cost.costs[1].weights),
                   effort=np.asarray(st.constraints[0][1].upper))
        if len(st.constraints) > 1:
            coll = st.constraints[1][0]
            out.update(post_a=np.asarray(coll.seg_a), post_b=np.asarray(coll.seg_b),
                       post_radius=np.asarray(coll.radius))
    elif case in ("quadrotor", "quadrotor-term"):
        cons = st.constraints
        out.update(actuation=np.asarray(ode.actuation),
                   x_target=np.asarray(costs[0].residual.target), u_hover=np.asarray(
                       costs[1].residual.target), w_x=np.asarray(costs[0].weights) / dt,
                   w_u=np.asarray(costs[1].weights) / dt,
                   w_term=np.asarray(prob.term_cost.weights),
                   columns=np.stack([np.asarray(c[0].center) for c in cons[:2]]),
                   column_radius=np.asarray(cons[0][0].radius),
                   u_max=np.asarray(cons[3][1].upper))
    elif case == "talos_arms":
        out.update(x_ref=np.asarray(costs[0].residual.target), p_target=np.asarray(
                       costs[2].residual.p_ref), w_x=np.asarray(costs[0].weights) / dt,
                   w_u=np.asarray(costs[1].weights) / dt,
                   w_frame=np.asarray(costs[2].weights) / dt,
                   w_term_x=np.asarray(prob.term_cost.costs[0].weights),
                   w_term_frame=np.asarray(prob.term_cost.costs[1].weights))
        if st.constraints:
            out["effort"] = np.asarray(st.constraints[0][1].upper)
    else:  # the FFSR reach
        pose = [c.residual for c in costs[:2]]
        out.update(R_targets=np.stack([np.asarray(r.R_ref) for r in pose]),
                   p_targets=np.stack([np.asarray(r.p_ref) for r in pose]),
                   u_max=np.asarray(st.constraints[0][1].upper))
    return out


def trajectory(prob, seed):
    """A seeded trajectory near the problem's x0: xs (N + 1, nx) moved
    0.05·N(0, 1) along the tangent, us 0.5·N(0, 1)."""
    import jax

    sp = prob.space
    rng = np.random.default_rng(seed)
    dx = 0.05 * rng.standard_normal((prob.nsteps + 1, sp.ndx))
    xs = np.asarray(jax.vmap(lambda d: sp.integrate(prob.x0, d))(dx))
    return xs, 0.5 * rng.standard_normal((prob.nsteps, prob.nu))


def prob_refs():
    jax = _jax()
    from aligator_tpu.core import problem as jproblem

    out = {}
    for k, case in enumerate(PROB_SIZES):
        prob = jax_problem(case, PROB_SIZES[case])
        xs, us = trajectory(prob, 200 + k)
        ref = jax.jit(lambda xs, us: jproblem.compute_derivatives(prob, xs, us))(xs, us)
        out[f"prob_{case}_xs"], out[f"prob_{case}_us"] = xs, us
        for f, v in vars(ref).items():
            if v is not None:
                out[f"prob_{case}_{f}"] = np.asarray(v)
    return out


def table_x0s(batch):
    """The UR5 table reach's initial states ``(batch, 12)``: the elbow-up
    start TABLE_Q0 + 0.1·N(0, 1) on q (numpy seed ``SEED + 18``), at rest."""
    rng = np.random.default_rng(SEED + SEED_OFFSET["table"])
    x = np.zeros((batch, 12))
    x[:, :6] = np.asarray(TABLE_Q0) + 0.1 * rng.standard_normal((batch, 6))
    return x


def small_x0s(case, batch):
    """The small solves' initial states: the table's :func:`table_x0s`, the
    Panda's and the quadrotor's own x0 with 0.05·N(0, 1) on their first
    (position) coordinates."""
    if case == "table":
        return table_x0s(batch)
    prob = jax_problem("panda" if case == "panda" else "quadrotor", SMALL[case]["nsteps"])
    rng = np.random.default_rng(SEED + SEED_OFFSET["states"] + 50 + len(case))
    x = np.tile(np.asarray(prob.x0), (batch, 1))
    n = 7 if case == "panda" else 3
    x[:, :n] += 0.05 * rng.standard_normal((batch, n))
    return x


def jax_solve(case, nsteps, x0s, options, max_iters=None):
    """The JAX package's solves of ``case`` from each row of ``x0s``, one
    scenario at a time (``lax.map``)."""
    jax = _jax()
    import jax.numpy as jnp

    from aligator_tpu import solvers
    from aligator_tpu._pytree import replace

    prob = jax_problem({"table": "ur5_table"}.get(case, case), nsteps)
    opts = dict(options)
    if max_iters is not None:
        opts["max_iters"] = max_iters
    cfg = solvers.ProxDDPConfig(**opts)
    res = jax.jit(lambda a: jax.lax.map(lambda x0: solvers.solve(replace(prob, x0=x0), cfg),
                                        a))(jnp.asarray(x0s))
    return {k: np.asarray(getattr(res, k)) for k in RESULT_FIELDS}


def small_refs():
    out = {}
    for case, s in SMALL.items():
        x0 = small_x0s(case, s["batch"])
        out[f"{case}_x0s"] = x0
        out.update({f"{case}_{k}": v for k, v in jax_solve(
            case, s["nsteps"], x0, s["options"], max_iters=s["max_iters"]).items()})
    return out


def ee_heights(xs):
    """The UR5 end effector's heights along trajectories ``xs (..., 12)``."""
    jax = _jax()
    from aligator_tpu.modelling.multibody import model as rbd

    model = jax_model("ur5")
    ee = model.frame_id("ee")
    flat = xs.reshape(-1, xs.shape[-1])
    z = jax.jit(jax.vmap(lambda x: rbd.frame_placement(model, x[:6], ee)[1][2]))(flat)
    return np.asarray(z).reshape(xs.shape[:-1])


def full_refs():
    n = TABLE_FULL["scenarios"]
    x0 = table_x0s(n)
    res = jax_solve("table", TABLE_FULL["nsteps"], x0, TABLE_OPTIONS)
    return dict(table_full_x0s=x0, table_full_conv=res["conv"],
                table_full_num_iters=res["num_iters"],
                table_full_min_height=ee_heights(res["xs"]).min(-1))


GROUPS = {"prim": prim_refs, "res": res_refs, "prob": prob_refs, "small": small_refs,
          "full": full_refs}


def references(groups=tuple(GROUPS)):
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
    refs = references(args.only or tuple(GROUPS))
    np.savez_compressed(args.path, **{**old, **refs})
    if "table_full_conv" in refs:
        print("UR5 table: JAX converged", int(refs["table_full_conv"].sum()), "of",
              TABLE_FULL["scenarios"], "iterations", refs["table_full_num_iters"].tolist(),
              "lowest end-effector heights", refs["table_full_min_height"].round(4).tolist())
    print("wrote", args.path)


if __name__ == "__main__":
    main()
