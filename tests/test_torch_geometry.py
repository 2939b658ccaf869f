"""The port's collision geometry against the JAX package, float64 on the CPU.

The distance primitives, support maps, the triangle's least-norm point,
``convex_distance`` (24 fixed steps), ``capsule_box_distance`` and
``hull_halfspace_distance`` of ``modelling/multibody/geometry.py``, its six
frame residuals, and the UR5 table reach (``examples/ur5_table.py``: its
problem's derivatives, a solve cut to 4 iterations, the JAX solves of the
card path's first 16 scenarios), held against
``tests/data/torch_collision_ref.npz``: the JAX package's jitted functions
and solves on the same numpy inputs, written by
``tools/torch_collision_fixture.py``, which the ``slow`` test reruns live.
The card runs of these paths are checked by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import aligator_tpu_torch as at
from aligator_tpu_torch import convert
from aligator_tpu_torch.core import problem as problem_mod
from aligator_tpu_torch.examples import ur5_table
from aligator_tpu_torch.modelling.multibody import extra_residuals as ex
from aligator_tpu_torch.modelling.multibody import geometry as geo
from aligator_tpu_torch.modelling.multibody import humanoid, robots

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_collision_ref.npz"
TOL = 1e-10  # float64 on both sides, relative to max(1, max |ref|)
TOL_CONVEX = 1e-9  # convex_distance and its gradient
TOL_PROB = 1e-9


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_collision_fixture", ROOT / "tools" / "torch_collision_fixture.py")
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


# ---------------------------------------------------------------- primitives

_S = {k: _t(v) for k, v in TOOL.prim_inputs().items()}
PRIMS = {
    "point_halfspace": (geo.point_halfspace_distance, ("p", "normal", "offset")),
    "segment_halfspace": (geo.segment_halfspace_distance, ("a", "b", "normal", "offset")),
    "point_box": (geo.point_box_distance, ("p", "center", "rot", "half")),
    "point_segment": (geo.point_segment_distance, ("p", "a", "b")),
    "sphere_sphere": (geo.sphere_sphere_distance, ("c1", "r1", "c2", "r2")),
    "support_sphere": (lambda d, c, r: geo.support_sphere(c, r, d), ("d", "c1", "r1")),
    "support_capsule": (lambda d, a, b, r: geo.support_capsule(a, b, r, d),
                        ("d", "a", "b", "r1")),
    "support_box": (lambda d, c, R, h: geo.support_box(c, R, h, d),
                    ("d", "center", "rot", "half")),
    "support_cylinder": (lambda d, c, R, r, h: geo.support_cylinder(c, R, r, h, d),
                         ("d", "center", "rot", "r1", "r2")),
    "support_hull": (lambda d, v: geo.support_hull(_S["hull"] + v, d), ("d", "hull_shift")),
    "min_norm_triangle": (geo._min_norm_triangle, ("p0", "p1", "p2")),
    "segment_sqdist": (ex._segment_segment_sqdist, ("p1", "q1", "p2", "q2")),
    "hull_halfspace": (lambda v, n, o: geo.hull_halfspace_distance(_S["hull"] + v, n, o),
                       ("hull_shift", "normal", "offset")),
    "convex_sphere_box": (lambda c, r, bc, R, h: geo.convex_distance(
        lambda u: geo.support_sphere(c, r, u),
        lambda u: geo.support_box(bc, R, h, u))[0],
        ("sphere_c", "r1", "center", "rot", "half")),
    "convex_hull_box": (lambda v, bc, R, h: geo.convex_distance(
        lambda u: geo.support_hull(_S["hull"] + v, u),
        lambda u: geo.support_box(bc, R, h, u), x_init=v - bc)[0],
        ("hull_shift", "center", "rot", "half")),
    "convex_cylinder_box": (lambda c, R, r, hl, bc, h: geo.convex_distance(
        lambda u: geo.support_cylinder(c, R, r, hl, u),
        lambda u: geo.support_box(bc, torch.eye(3, dtype=bc.dtype), h, u))[0],
        ("cyl_c", "rot", "cyl_r", "cyl_h", "center", "half")),
    "capsule_box": (geo.capsule_box_distance,
                    ("cap_a", "cap_b", "cap_r", "center", "rot", "half")),
}


# the primitives whose every argument is a point (or a scalar the result
# takes as is): the whole batch at once broadcasts as one sample does
BATCHED = ("point_halfspace", "segment_halfspace", "point_box", "point_segment",
           "sphere_sphere", "support_box", "min_norm_triangle", "segment_sqdist")


@pytest.mark.parametrize("name", list(PRIMS))
def test_primitives_match_jax(name):
    """Each primitive's value and its Jacobian in its first argument (a
    point or a direction), one sample at a time under ``vmap``, and the
    value on the whole batch at once, against ``jax.vmap(jax.jacfwd)`` of
    the JAX function: to 1e-10, ``convex_distance`` and the functions
    built on it to 1e-9."""
    f, args = PRIMS[name]
    vals = [_S[a] for a in args]
    tol = TOL_CONVEX if name.startswith(("convex", "capsule")) else TOL
    _close(torch.func.vmap(f)(*vals), _fixture("prim_")[f"{name}_value"], tol, name)
    _close(torch.func.vmap(torch.func.jacfwd(f))(*vals), _fixture("prim_")[f"{name}_jac"],
           tol, f"{name} jacobian")
    if name in BATCHED:
        _close(f(*vals), _fixture("prim_")[f"{name}_value"], tol, f"{name} batched")


def test_convex_distance_converges_to_the_closed_forms():
    """The fixed 24 steps of convex_distance on pairs with closed forms: two
    spheres, and a point against a box's vertex hull (its SDF outside)."""
    c1, c2 = torch.zeros(3, dtype=torch.float64), _t([3.0, 1.0, -2.0])
    d, x = geo.convex_distance(lambda u: geo.support_sphere(c1, 0.5, u),
                               lambda u: geo.support_sphere(c2, 0.7, u), iters=40)
    assert abs(float(d) - (float((c1 - c2).norm()) - 1.2)) < 1e-4
    assert abs(float(x.norm()) - float(d)) < 1e-5
    corners = _t([[float(sx), sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    p = _t([3.0, 0.2, -0.3])
    d, _ = geo.convex_distance(lambda u: geo.support_hull(corners, u), lambda u: p, iters=40)
    exact = geo.point_box_distance(p, torch.zeros(3, dtype=torch.float64),
                                   torch.eye(3, dtype=torch.float64),
                                   torch.ones(3, dtype=torch.float64))
    assert abs(float(d) - float(exact)) < 1e-3


# ---------------------------------------------------------------- residuals

MODELS = {"ur5": lambda: robots.make_ur5(device="cpu"),
          "upper_body": lambda: humanoid.make_humanoid_upper_body(device="cpu"),
          "humanoid": lambda: humanoid.make_humanoid(device="cpu")}


def port_residual(name):
    """The port's residual ``name`` of the tool's RESIDUALS, with its
    model."""
    mod, cls, model_name, _, frames = TOOL.RESIDUALS[name]
    model = MODELS[model_name]()
    module = {"geometry": geo, "extra_residuals": ex}[mod]
    kw = {k: _t(v) for k, v in TOOL.residual_leaves(name, model.nv).items()}
    kw.update({k: (model.frame_id(v) if k.startswith("frame_id") else v)
               for k, v in frames.items()})
    return getattr(module, cls)(model=model, **kw), model


def check_residual(name, tol=TOL):
    """Value and Jacobians of the port's residual ``name`` at the fixture's
    states, against the JAX package's."""
    fn, model = port_residual(name)
    ref = _fixture(f"res_{name}_")
    sp = model.phase_space()
    x, u = _t(ref["x"]), _t(ref["u"])
    val = fn.value(sp, x, u)
    assert fn.dim(sp, u.shape[-1]) == val.shape[-1]
    _close(val, ref["value"], tol, f"{name} value")
    for g, n in zip(fn.jacobians(sp, x, u), ("Jx", "Ju")):
        _close(g, ref[n], tol, f"{name} {n}")


GEOMETRY_RESIDUALS = [n for n, spec in TOOL.RESIDUALS.items() if spec[0] == "geometry"]


@pytest.mark.parametrize("name", GEOMETRY_RESIDUALS)
def test_frame_residuals_match_jax(name):
    """The six Frame*Residual classes (the hull against a box and a
    cylinder): values and the generic forward-mode Jacobians, to 1e-10
    (those through convex_distance to 1e-9)."""
    check_residual(name, TOL_CONVEX if name.startswith(("hull", "capsule")) else TOL)


# ---------------------------------------------------------------- UR5 table


def test_ur5_table_problem_matches_jax():
    """The UR5 table reach's problem (N = 5), converted from the JAX
    problem's leaves and built by the port's own builder:
    compute_derivatives along a seeded trajectory against the JAX
    package's, to 1e-9."""
    ref = _fixture("prob_ur5_table_")
    n = TOOL.PROB_SIZES["ur5_table"]
    xs, us = _t(ref["xs"])[None], _t(ref["us"])[None]
    for label, prob in (("converted", convert.ur5_table_problem_from_numpy(
                            TOOL.params("ur5_table", n), nsteps=n, device="cpu")),
                        ("built", ur5_table.create_ur5_table_problem(nsteps=n, device="cpu"))):
        got = problem_mod.compute_derivatives(prob, xs, us)
        for f, r in ref.items():
            if f not in ("xs", "us"):
                _close(getattr(got, f)[0], r, TOL_PROB, f"{label} {f}")


def small_solve_matches(case, make):
    """The port's solve of the tool's small case ``case`` (``make(nsteps)``
    its problem, the fixture's initial states) against the JAX package's:
    num_iters, al_iter and conv equal, the rest to 1e-9 or to 100 times the
    distance of the port's own solves from initial states one ulp away,
    x0·(1 ± 1e-15), whichever is larger (as tests/test_torch_contact.py
    holds its solves: these magnify any difference of rounding)."""
    ref = _fixture(f"{case}_")
    s = TOOL.SMALL[case]
    prob = dataclasses.replace(make(s["nsteps"]), x0=_t(ref["x0s"]))
    cfg = at.solvers.ProxDDPConfig(**{**s["options"], "max_iters": s["max_iters"]})
    got = at.solvers.solve(prob, cfg)
    for k in ("num_iters", "al_iter", "conv"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), ref[k], err_msg=k)
    spread = None
    for k in ("xs", "us", "vs", "lams", "prim_infeas", "dual_infeas", "traj_cost"):
        g, r = getattr(got, k).numpy(), ref[k]
        assert g.shape == r.shape, k
        scale = max(1.0, np.abs(r).max())
        err = np.abs(g - r).max() / scale
        if err > TOL_PROB and spread is None:
            spread = [at.solvers.solve(dataclasses.replace(prob, x0=prob.x0 * f), cfg)
                      for f in (1.0 + 1e-15, 1.0 - 1e-15)]
        apart = 0.0 if spread is None else max(
            np.abs(getattr(o, k).numpy() - g).max() for o in spread) / scale
        assert err <= max(TOL_PROB, 100 * apart), (case, k, err, apart)


def test_ur5_table_solve_matches_jax():
    """ProxDDP with the published options on the UR5 table reach (N = 10,
    two perturbed starts), cut to 4 iterations, against the JAX package's
    one-at-a-time solves (:func:`small_solve_matches`)."""
    np.testing.assert_array_equal(_fixture("table_")["x0s"], TOOL.table_x0s(2))
    small_solve_matches("table", lambda n: ur5_table.create_ur5_table_problem(
        nsteps=n, device="cpu"))


def test_ur5_table_full_size_jax_reference_is_recorded():
    """chip_smoke.py's floor: the JAX package's conv on the first 16
    scenarios of the card batch at the published size, one at a time, and
    every converged trajectory's end effector above the table (z_ee >= 0.15
    less the tolerance; an unconverged one may dip below: scenario 6 reaches
    0.134 m in 100 iterations)."""
    ref = _fixture("table_full_")
    n = TOOL.TABLE_FULL["scenarios"]
    np.testing.assert_array_equal(ref["x0s"], TOOL.table_x0s(n))
    assert ref["conv"].shape == ref["num_iters"].shape == (n,)
    assert ref["conv"].any()
    tol = TOOL.TABLE_OPTIONS["tol"]
    assert (ref["min_height"][ref["conv"]] >= ur5_table.TABLE_HEIGHT - tol).all()


@pytest.mark.slow
def test_fixture_matches_a_live_jax_solve():
    """The primitives, the residuals and the UR5 table's full-size solves of
    the fixture computed live by the JAX package."""
    live = TOOL.references(("prim", "res", "full"))
    with np.load(FIXTURE) as f:
        for k, v in live.items():
            np.testing.assert_allclose(f[k], v, rtol=1e-12, atol=1e-12, err_msg=k)
