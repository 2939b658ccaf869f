"""The port's multibody modules against the JAX package, float64 on the CPU:
the SE(3) and tangent-bundle spaces, the rigid-body algorithms, the primal
contact solve, the plain version of the derivative-rows kernel K5 against
the JAX reference rows and the Pallas kernel in interpret mode, the contact
dynamics' Jacobians and the semi-implicit Euler assembly of (A, B, E), and
the SPD solve (K2) at the contact-KKT shapes. The CUDA kernels themselves
are checked against the same plain versions on the card by
tests/test_torch_cuda.py.

The jitted JAX references of the rigid-body algorithms, the primal contact
solve with K5's rows and the contact dynamics' Jacobians (the ``jax_*``
functions below) are ``tests/data/torch_multibody_ref.npz``, written by
``tools/torch_jax_refs_fixture.py --only multibody`` (their compiles took
most of this file's time); the ``slow`` test reruns them live.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligator_tpu.core import manifolds as jman
from aligator_tpu.gar import pallas_spd
from aligator_tpu.modelling import IntegratorSemiImplEuler as JIntegratorSemiImplEuler
from aligator_tpu.modelling.multibody import contact as jcontact
from aligator_tpu.modelling.multibody import derivatives as jder
from aligator_tpu.modelling.multibody import humanoid as jhum
from aligator_tpu.modelling.multibody import model as jrbd
from aligator_tpu.modelling.multibody import pallas_tensors
from aligator_tpu.modelling.multibody import quadruped as jquad
from aligator_tpu.modelling.spaces import se3 as jse3

from aligator_tpu_torch import _build, convert
from aligator_tpu_torch.core.functions import stage_param
from aligator_tpu_torch.core.manifolds import CartesianProduct, TangentBundle, VectorSpace
from aligator_tpu_torch.gar import spd_solve
from aligator_tpu_torch.modelling.dynamics.ode import IntegratorSemiImplEuler
from aligator_tpu_torch.modelling.multibody import contact, fd_rows
from aligator_tpu_torch.modelling.multibody import model as rbd
from aligator_tpu_torch.modelling.spaces.se3 import SE3, SO3

torch.set_num_threads(2)
TOL = 1e-10  # float64 on both sides; the JAX and torch sums run in other orders
REFS = pathlib.Path(__file__).resolve().parent / "data" / "torch_multibody_ref.npz"
ROWS = ("ra1_q", "ra1_v", "r2_q", "r2_v")  # K5's outputs


def _refs(prefix):
    """The fixture's arrays under ``prefix``, the prefix dropped."""
    with np.load(REFS) as f:
        return {k[len(prefix):]: f[k] for k in f.files if k.startswith(prefix)}


def _same_inputs(ref, **inputs):
    """The inputs this test draws are the fixture's, bit for bit."""
    for k, v in inputs.items():
        assert np.array_equal(np.asarray(v), ref[k]), k


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def _robot(name):
    """The JAX model, the port's model carried across by convert, a base
    configuration and the contact configuration of the workloads: the
    humanoid's 2×6D soles (kd = 50) and the quadruped's 4×3D feet (kd = 10)."""
    if name == "humanoid":
        jm = jhum.make_humanoid()
        q0 = jhum.half_sitting(jm)
        frames, dims, kd = (jm.frame_id("left_sole"), jm.frame_id("right_sole")), (6, 6), 50.0
    else:
        jm = jquad.make_quadruped()
        q0 = jquad.standing_configuration(jm)
        frames, dims, kd = tuple(jm.frame_id(f"foot{k}") for k in range(4)), (3,) * 4, 10.0
    leaves = {k: np.asarray(getattr(jm, k)) for k in rbd.LEAVES}
    leaves.update(joint_types=jm.joint_types, parents=jm.parents,
                  frame_parents=jm.frame_parents, frame_names=jm.frame_names)
    return jm, convert.robot_model_from_numpy(leaves, device="cpu"), q0, frames, dims, kd


def _states(tm, q0, K, seed):
    """K random configurations around q0 (integrated on the manifold) and
    random velocities and torques, numpy float64."""
    rng = np.random.default_rng(seed)
    dq = 0.05 * rng.standard_normal((K, tm.nv))
    qs = tm.configuration_space().integrate(torch.tensor(np.asarray(q0))[None],
                                            torch.tensor(dq)).numpy()
    return qs, 0.2 * rng.standard_normal((K, tm.nv)), 2.0 * rng.standard_normal((K, tm.nv))


# ---------------------------------------------------------------- spaces


def test_se3_and_tangent_bundle_match_jax():
    rng = np.random.default_rng(0)
    K = 5
    jspace = jman.TangentBundle(jman.CartesianProduct(jse3.SE3(), jman.VectorSpace(2),
                                                      jman.VectorSpace(1)))
    space = TangentBundle(CartesianProduct(SE3(), VectorSpace(2), VectorSpace(1)))
    assert space.base.components == (SE3(), VectorSpace(3))  # adjacent R^n merged

    @jax.jit
    def reference(d0, d):
        x0 = jax.vmap(lambda e: jspace.integrate(jspace.neutral(), e))(d0)
        x1 = jax.vmap(jspace.integrate)(x0, d)
        jac = [(jax.vmap(lambda a, b: jspace.jdifference(a, b, arg))(x0, x1),
                jax.vmap(lambda a, b: jspace.jintegrate(a, b, arg))(x0, d))
               for arg in (0, 1)]
        return x0, x1, jax.vmap(jspace.difference)(x0, x1), jac

    d = 0.7 * rng.standard_normal((K, 18))
    x0, x1, diff, jac = reference(rng.standard_normal((K, 18)), d)
    t0, t1, td = (torch.tensor(np.asarray(a)) for a in (x0, x1, d))
    assert _rel_err(space.integrate(t0, td), x1) < TOL
    assert _rel_err(space.difference(t0, t1), diff) < 1e-9
    for arg, (jd, ji) in zip((0, 1), jac):
        assert _rel_err(space.jdifference(t0, t1, arg), jd) < 1e-9
        assert _rel_err(space.jintegrate(t0, td, arg), ji) < 1e-9
    # SO(3) alone, and SE(3) near the identity (the Taylor branches)
    q0, q1 = (np.asarray(x0)[:, 3:7], np.asarray(x1)[:, 3:7])
    w = jax.jit(jax.vmap(jse3.SO3().difference))(q0, q1)
    assert _rel_err(SO3().difference(torch.tensor(q0), torch.tensor(q1)), w) < 1e-9
    assert _rel_err(SO3().integrate(torch.tensor(q0), torch.tensor(np.asarray(w))), q1) < 1e-9
    small = 1e-5 * rng.standard_normal((K, 6))
    t = SE3().integrate(SE3().neutral(torch.float64)[None], torch.tensor(small))
    assert _rel_err(SE3().difference(SE3().neutral(torch.float64)[None], t), small) < 1e-12


# ---------------------------------------------------------------- rigid bodies


def jax_rbd_refs(robot):
    """The JAX package's kinematics, RNEA, mass matrix and frame placements
    and Jacobians at 4 random states, jitted; numpy."""
    jm, tm, q0, _, _, _ = _robot(robot)
    qs, vs, a = _states(tm, q0, 4, 1)
    nf = len(jm.frame_names)

    @jax.jit
    def reference(qs, vs, a):
        kin = jax.vmap(lambda q, v: jrbd.kinematics(jm, q, v))(qs, vs)
        frames = [jax.vmap(lambda q: (*jrbd.frame_placement(jm, q, f),
                                      jrbd.frame_jacobian_lwa(jm, q, f)))(qs)
                  for f in range(nf)]
        return (kin, jax.vmap(lambda q, v, a: jrbd.rnea(jm, q, v, a))(qs, vs, a),
                jax.vmap(lambda q: jrbd.mass_matrix(jm, q))(qs), frames)

    jkin, tau, M, frames = reference(qs, vs, a)
    out = dict(qs=qs, vs=vs, a=a, tau=tau, M=M, q0=q0)
    out.update({f"kin_{k}": jkin[k] for k in ("R", "p", "Phi", "V")})
    for i, name in enumerate(("frame_R", "frame_p", "frame_J")):
        out[name] = np.stack([np.asarray(f[i]) for f in frames])
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("robot", ["humanoid", "quadruped"])
def test_rigid_body_algorithms_match_jax(robot):
    """Kinematics, RNEA, the mass matrix and every frame's placement and
    Jacobian against the JAX package's (the fixture of jax_rbd_refs)."""
    ref = _refs(f"rbd_{robot}_")
    jm, tm, q0, _, _, _ = _robot(robot)
    qs, vs, a = _states(tm, q0, 4, 1)
    _same_inputs(ref, qs=qs, vs=vs, a=a)
    tq, tv, ta = (torch.tensor(x) for x in (qs, vs, a))
    kin = rbd.kinematics(tm, tq, tv)
    # the masks are row-major, as the sums over them were pinned with
    assert all(rbd.tables(tm, tq)[k].is_contiguous() for k in ("A", "D"))
    for k in ("R", "p", "Phi", "V"):
        assert _rel_err(kin[k], ref[f"kin_{k}"]) < TOL, k
    assert _rel_err(rbd.rnea(tm, tq, tv, ta), ref["tau"]) < TOL
    assert _rel_err(rbd.mass_matrix(tm, tq), ref["M"]) < TOL
    assert len(ref["frame_R"]) == len(jm.frame_names)
    for f, (jR, jp, jJ) in enumerate(zip(ref["frame_R"], ref["frame_p"], ref["frame_J"])):
        R, p = rbd.frame_placement(tm, tq, f)
        assert _rel_err(R, jR) < TOL and _rel_err(p, jp) < TOL
        assert _rel_err(rbd.frame_jacobian_lwa(tm, tq, f), jJ) < TOL
    if robot == "humanoid":
        from aligator_tpu_torch.modelling.multibody import humanoid

        assert _rel_err(humanoid.half_sitting(humanoid.make_humanoid(device="cpu")), q0) < 1e-14


@pytest.mark.parametrize("build", ["make_humanoid", "make_quadruped", "effort_limits"])
def test_robot_models_default_to_the_card(monkeypatch, build):
    """Without CUDA make_humanoid, make_quadruped and effort_limits raise
    unless the caller asks for the CPU."""
    from aligator_tpu_torch.modelling.multibody import humanoid, quadruped

    fn = getattr(quadruped if build == "make_quadruped" else humanoid, build)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="finds no CUDA device"):
        fn()
    out = fn(device="cpu")
    ref = out if build == "effort_limits" else out.mass
    assert ref.device.type == "cpu" and ref.dtype == torch.float64


# ---------------------------------------------------------------- contacts


# the quadruped's four coplanar point feet make the Delassus matrix
# rank-deficient: at the humanoid's μ = 1e-9 its forces (up to 1e7) are
# conditioning-limited, 1e-6 apart between two float64 Cholesky orders, so
# its primal solve is compared at μ = 1e-5
PROX_MU = {"humanoid": 1e-9, "quadruped": 1e-5}


def _contact_inputs(robot, K=4):
    jm, tm, q0, frames, dims, kd = _robot(robot)
    qs, vs, taus = _states(tm, q0, K, 3)
    active = np.ones((K, len(frames)))
    active[0, 0] = active[2, -1] = 0.0  # a swing foot in two instances
    return jm, tm, frames, dims, kd, qs, vs, taus, active


def jax_contact_refs(robot):
    """The JAX package's primal contact solve (``contact._cfd_internals``)
    at 4 random states, and at its solution the reference rows
    (``derivatives._fd_rows_std``) and the Pallas kernel's in interpret mode
    (``pallas_tensors.fd_rows_lanes``), jitted; numpy."""
    jm, tm, frames, dims, kd, qs, vs, taus, active = _contact_inputs(robot)
    K = len(qs)
    prefs = np.zeros((K, len(frames), 3))
    bodies = tuple(jm.frame_parents[f] for f in frames)
    top = jrbd._topology(jm.joint_types, jm.parents)
    A_np = np.asarray(top["A"], np.float64)
    D_np = A_np[top["dof_joint"], :]
    mu = PROX_MU[robot]

    @jax.jit
    def reference(qs, vs, taus, active, prefs):
        def primal(q, v, t, act):
            out = jcontact._cfd_internals(jm, q, v, t, frames, act, prox_mu=mu,
                                          kd=kd, contact_dims=dims)
            return out["a"], out["lam"]

        a, lam = jax.vmap(primal)(qs, vs, taus, active)
        std = jax.vmap(lambda q, v, a, lam, act, pr: jder._fd_rows_std(
            jm, q, v, a, lam, act, pr, frames, dims, 0.0, kd, False))(
            qs, vs, a, lam, active, prefs)
        S, Vb, Vpar, Vdof, Ca, Capar, Accb, h, y, I6, pcs = jax.vmap(
            lambda q, v, a: jder._prep_lane_inputs(jm, q, v, a, frames))(qs, vs, a)
        ker = pallas_tensors.fd_rows_lanes(
            S, vs, Vb, Vpar, Vdof, Ca, Capar, Accb, h, y, I6, lam, pcs, active,
            prefs, jnp.asarray(A_np), jnp.asarray(D_np), jnp.asarray(D_np.T),
            contact_bodies=bodies, contact_dims=dims, kd=kd, kp=0.0,
            has_prefs=False, interpret=True)
        return a, lam, std, ker

    a, lam, std, ker = reference(qs, vs, taus, active, prefs)
    out = dict(qs=qs, vs=vs, taus=taus, active=active, a=a, lam=lam)
    for name, g, k in zip(ROWS, std, ker):
        out[f"std_{name}"], out[f"ker_{name}"] = g, k
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("robot", ["humanoid", "quadruped"])
def test_primal_contact_solve_and_fd_rows_plain_match_jax(robot):
    """The primal solve (a, λ) against ``contact._cfd_internals``; then, at
    the JAX primal solution, the plain version of K5 against the JAX
    reference rows (``derivatives._fd_rows_std``) and the Pallas kernel in
    interpret mode (``pallas_tensors.fd_rows_lanes``): the fixture of
    jax_contact_refs."""
    ref = _refs(f"contact_{robot}_")
    jm, tm, frames, dims, kd, qs, vs, taus, active = _contact_inputs(robot)
    _same_inputs(ref, qs=qs, vs=vs, taus=taus, active=active)
    mu = PROX_MU[robot]
    tq, tv, tt, tact = (torch.tensor(x) for x in (qs, vs, taus, active))
    out = contact.cfd_internals(tm, tq, tv, tt, frames, tact, prox_mu=mu, kd=kd,
                                contact_dims=dims)
    assert _rel_err(out["a"], ref["a"]) < 1e-9
    assert _rel_err(out["lam"], ref["lam"]) < 1e-9

    got = fd_rows.fd_rows(tm, tq, tv, torch.tensor(ref["a"]), torch.tensor(ref["lam"]),
                          tact, frames, dims, kd=kd)
    for name, g in zip(ROWS, got):
        assert _rel_err(g, ref[f"std_{name}"]) < TOL, name
        assert _rel_err(g, ref[f"ker_{name}"]) < TOL, name


def test_fd_rows_cpu_wrapper_is_the_plain_version():
    jm, tm, q0, frames, dims, kd = _robot("quadruped")
    qs, vs, a = (torch.tensor(x) for x in _states(tm, q0, 3, 4))
    lam = torch.randn(3, sum(dims), dtype=torch.float64)
    act = torch.tensor([[1.0, 0.0, 1.0, 1.0]] * 3, dtype=torch.float64)
    before = _build.LAUNCHES["fd_rows"]
    got = fd_rows.fd_rows(tm, qs, vs, a, lam, act, frames, dims, kd=kd)
    ref = fd_rows.fd_rows_plain(tm, qs, vs, a, lam, act, frames, dims, kd=kd)
    assert _build.LAUNCHES["fd_rows"] == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert (got[2][:, 3:6] == 0).all()  # the inactive contact's rows


@pytest.mark.parametrize("robot", ["humanoid", "quadruped"])
def test_fd_rows_support_lists_match_the_masks(robot):
    """K5's index lists hold exactly the nonzeros of the dense masks A and D,
    each list in the order its sums take and each map the inverse of its
    list."""
    from aligator_tpu_torch.modelling.multibody import humanoid, quadruped

    tm = (humanoid.make_humanoid if robot == "humanoid" else quadruped.make_quadruped)(
        device="cpu")
    top = rbd.topology(tm.joint_types, tm.parents)
    A, D = top["A"] != 0, top["D"] != 0
    nb, nv = A.shape
    lists, (npair, nslot, nrel, nsp, neb) = fd_rows.support_lists(tm.joint_types,
                                                                  tm.parents)
    assert lists.dtype == np.int32
    sizes = (npair, npair, nslot, nslot, nb * nv, nslot + 1, nsp, nv + 1, nslot, nv * nv,
             nrel, nrel + 1, neb)
    assert len(lists) == sum(sizes)
    (pj, pk, slot_b, slot_j, slot_of, sp_off, sp, sub_off, sub, ent, ent_pair, eb_off,
     eb) = np.split(lists, np.cumsum(sizes)[:-1])
    slot_of = slot_of.reshape(nb, nv)
    # pairs (j, k): D[k, j] = 1
    assert npair == D.sum()
    pairs = np.zeros((nv, nv), bool)
    pairs[pk, pj] = True
    assert (pairs == D).all()
    pair_of = {(j, k): p for p, (j, k) in enumerate(zip(pj, pk))}
    # slots (b, j): A[b, j] = 1, and each slot's pairs over the dofs of b
    assert nslot == A.sum() and (A[slot_b, slot_j]).all()
    assert (slot_of[slot_b, slot_j] == np.arange(nslot)).all()
    assert (slot_of == -1).sum() == nb * nv - nslot
    for s_, (b, j) in enumerate(zip(slot_b, slot_j)):
        ks = [k for k in range(nv) if A[b, k] and D[k, j]]
        assert list(sp[sp_off[s_]:sp_off[s_ + 1]]) == [pair_of[j, k] for k in ks]
    for k in range(nv):
        assert list(sub[sub_off[k]:sub_off[k + 1]]) == list(np.nonzero(A[:, k])[0])
    # entries: every (k, j) once; those of a body's dofs first, with their
    # pair and the slots (b, j) of the bodies both dofs move
    assert sorted(ent) == list(range(nv * nv))
    both = A[:, :, None] & A[:, None, :]
    assert nrel == both.any(0).sum()
    for e in range(nv * nv):
        k, j = divmod(ent[e], nv)
        if e >= nrel:
            assert not both[:, k, j].any()
            continue
        assert ent_pair[e] == pair_of.get((j, k), -1)
        bodies = np.nonzero(both[:, k, j])[0]
        assert list(eb[eb_off[e]:eb_off[e + 1]]) == list(slot_of[bodies, j])
    assert list(np.diff(eb_off)) == sorted(np.diff(eb_off), reverse=True)


def _many_contact_chain():
    """A free-flyer ``robots.make_chain`` of 20 revolute joints with a frame
    at the end of every body, the port's model and the JAX package's with
    the same leaves, and a contact configuration past the old 16-contact
    cap of the CUDA kernel: twenty 3D contacts and one 6D."""
    from aligator_tpu_torch.modelling.multibody import robots

    tm = robots.make_chain(20, True, device="cpu", frame_stride=1)
    leaves = {k: jnp.asarray(getattr(tm, k).numpy()) for k in rbd.LEAVES
              if getattr(tm, k) is not None}
    jm = jrbd.RobotModel(**leaves, joint_types=tm.joint_types, parents=tm.parents,
                         frame_parents=tm.frame_parents, frame_names=tm.frame_names)
    nb = tm.njoints
    return jm, tm, tuple(range(1, nb)) + (nb - 1,), (3,) * (nb - 1) + (6,)


def _many_contact_inputs(K=2):
    jm, tm, frames, dims = _many_contact_chain()
    rng = np.random.default_rng(20)
    nv = tm.nv
    qs = tm.configuration_space().integrate(
        tm.neutral()[None], torch.tensor(0.3 * rng.standard_normal((K, nv)))).numpy()
    vs, a = 0.2 * rng.standard_normal((K, nv)), rng.standard_normal((K, nv))
    lam = 5.0 * rng.standard_normal((K, sum(dims)))
    active = np.ones((K, len(frames)))
    active[0, 3] = active[1, -1] = 0.0
    return jm, tm, frames, dims, qs, vs, a, lam, active


def jax_many_contact_refs(kd=10.0):
    """The JAX reference rows and the Pallas kernel's in interpret mode on
    :func:`_many_contact_chain`'s 21 contacts, jitted; numpy."""
    jm, tm, frames, dims, qs, vs, a, lam, active = _many_contact_inputs()
    prefs = np.zeros(active.shape + (3,))
    bodies = tuple(jm.frame_parents[f] for f in frames)
    top = jrbd._topology(jm.joint_types, jm.parents)
    A_np = np.asarray(top["A"], np.float64)
    D_np = A_np[top["dof_joint"], :]

    @jax.jit
    def reference(qs, vs, a, lam, active, prefs):
        std = jax.vmap(lambda q, v, a, lam, act, pr: jder._fd_rows_std(
            jm, q, v, a, lam, act, pr, frames, dims, 0.0, kd, False))(
            qs, vs, a, lam, active, prefs)
        S, Vb, Vpar, Vdof, Ca, Capar, Accb, h, y, I6, pcs = jax.vmap(
            lambda q, v, a: jder._prep_lane_inputs(jm, q, v, a, frames))(qs, vs, a)
        ker = pallas_tensors.fd_rows_lanes(
            S, vs, Vb, Vpar, Vdof, Ca, Capar, Accb, h, y, I6, lam, pcs, active,
            prefs, jnp.asarray(A_np), jnp.asarray(D_np), jnp.asarray(D_np.T),
            contact_bodies=bodies, contact_dims=dims, kd=kd, kp=0.0,
            has_prefs=False, interpret=True)
        return std, ker

    std, ker = reference(qs, vs, a, lam, active, prefs)
    out = dict(qs=qs, vs=vs, a=a, lam=lam, active=active)
    for name, g, k in zip(ROWS, std, ker):
        out[f"std_{name}"], out[f"ker_{name}"] = g, k
    return {k: np.asarray(v) for k, v in out.items()}


def test_fd_rows_plain_past_sixteen_contacts_matches_jax():
    """K5's plain rows on 21 contacts (twenty 3D, one 6D) against the JAX
    reference rows and the Pallas kernel in interpret mode (the fixture of
    jax_many_contact_refs), to 1e-12 in float64; the wrapper takes the
    contacts on the CPU (the CUDA kernel's old cap of 16 contacts is gone;
    tests/test_torch_cuda.py holds the kernel to these rows at 20 and 40
    contacts)."""
    ref = _refs("many_")
    jm, tm, frames, dims, qs, vs, a, lam, active = _many_contact_inputs()
    assert len(frames) == 21 and sum(dims) == 66
    _same_inputs(ref, qs=qs, vs=vs, a=a, lam=lam, active=active)
    before = _build.LAUNCHES["fd_rows"]
    got = fd_rows.fd_rows(tm, *(torch.tensor(x) for x in (qs, vs, a, lam, active)),
                          frames, dims, kd=10.0)
    assert _build.LAUNCHES["fd_rows"] == before
    for name, g in zip(ROWS, got):
        assert _rel_err(g, ref[f"std_{name}"]) < 1e-12, name
        assert _rel_err(g, ref[f"ker_{name}"]) < 1e-12, name
    assert (got[2][0, 9:12] == 0).all()  # the inactive contact's rows


def _jacobian_inputs():
    jm, tm, q0, frames, dims, kd = _robot("quadruped")
    K, nv = 3, jm.nv
    nu = nv - 6
    qs, vs, _ = _states(tm, q0, K, 5)
    rng = np.random.default_rng(6)
    us = rng.standard_normal((K, nu))
    xs = np.concatenate([qs, vs], -1)
    dys = 0.01 * rng.standard_normal((K, 2 * nv))
    act = np.ones(len(frames))
    act[-1] = 0.0
    return jm, tm, frames, dims, kd, qs, vs, us, xs, dys, act, np.eye(nv, nu, -6)


def jax_jacobian_refs():
    """The JAX package's semi-implicit Euler (A, B, E) of the quadruped's
    contact dynamics, jitted; numpy."""
    jm, tm, frames, dims, kd, qs, vs, us, xs, dys, act, Bm = _jacobian_inputs()
    ys = np.asarray(jax.vmap(lambda x, d: jm.phase_space().integrate(x, d))(xs, dys))
    jode = jcontact.MultibodyConstraintFwdDynamics(
        model=jm, actuation=jnp.asarray(Bm), active=jnp.asarray(act),
        contact_frames=frames, contact_dims=dims, kd=kd, prox_mu=1e-9)
    jdyn = JIntegratorSemiImplEuler(ode=jode, timestep=jnp.asarray(0.01))
    jspace = jm.phase_space()
    A, B, E = jax.jit(jax.vmap(lambda x, u, y: jdyn.jacobians(jspace, x, u, y)))(
        xs, us, ys)
    return {k: np.asarray(v) for k, v in dict(xs=xs, us=us, ys=ys, A=A, B=B, E=E).items()}


def test_contact_dynamics_jacobians_match_jax():
    """acc_derivatives and the semi-implicit Euler (A, B, E) against the JAX
    package's direct assembly (the fixture of jax_jacobian_refs), on the
    quadruped's 4×3D contacts (the humanoid's run through the whole Talos
    problem in tests/test_torch_talos.py)."""
    ref = _refs("jac_")
    jm, tm, frames, dims, kd, qs, vs, us, xs, dys, act, Bm = _jacobian_inputs()
    _same_inputs(ref, xs=xs, us=us)
    nv = jm.nv
    ys = ref["ys"]
    ode = contact.MultibodyConstraintFwdDynamics(
        model=tm, actuation=torch.tensor(Bm), active=torch.tensor(act),
        contact_frames=frames, contact_dims=dims, kd=kd, prox_mu=1e-9)
    h = 0.01
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=torch.tensor(h, dtype=torch.float64))
    space = tm.phase_space()
    tx, tu, ty = (torch.tensor(x) for x in (xs, us, ys))
    for name, g in zip("ABE", dyn.jacobians(space, tx, tu, ty)):
        assert _rel_err(g, ref[name]) < 1e-9, name
    # acc_derivatives against the JAX package's through the velocity rows of
    # (A, B): h ∂a/∂q, I + h ∂a/∂v and h ∂a/∂u
    a, da_dq, da_dv, da_du = ode.acc_derivatives(space, tx, tu)
    A, B = ref["A"], ref["B"]
    assert _rel_err(h * da_dq, A[:, nv:, :nv]) < 1e-9
    assert _rel_err(torch.eye(nv) + h * da_dv, A[:, nv:, nv:]) < 1e-9
    assert _rel_err(h * da_du, B[:, nv:]) < 1e-9
    # the step itself: v⁺ = v + h a, q⁺ = q ⊕ h v⁺
    v_next = torch.tensor(vs) + h * a
    q_next = tm.configuration_space().integrate(torch.tensor(qs), h * v_next)
    assert _rel_err(dyn.forward(space, tx, tu), torch.cat([q_next, v_next], -1)) < 1e-14


JAX_REFS = {
    **{f"rbd_{r}": (jax_rbd_refs, (r,)) for r in ("humanoid", "quadruped")},
    **{f"contact_{r}": (jax_contact_refs, (r,)) for r in ("humanoid", "quadruped")},
    "jac": (jax_jacobian_refs, ()),
    "many": (jax_many_contact_refs, ()),
}


@pytest.mark.slow
@pytest.mark.parametrize("group", sorted(JAX_REFS))
def test_fixture_matches_live_jax_refs(group):
    """The fixture's JAX references computed again, live."""
    fn, args = JAX_REFS[group]
    ref = _refs(f"{group}_")
    live = fn(*args)
    assert sorted(live) == sorted(ref)
    for k, v in live.items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-12, atol=1e-12, err_msg=k)


def test_stage_varying_parameter_rejects_one_stage_input():
    N, B = 5, 5
    leaf = torch.ones(N, 2)
    assert stage_param(leaf, torch.zeros(B, N, 7), 1) is leaf
    assert stage_param(torch.ones(2), torch.zeros(B, 7), 1) is not None
    with pytest.raises(ValueError, match="stage-varying"):
        stage_param(leaf, torch.zeros(B, 7), 1)  # one stage, B == N
    with pytest.raises(ValueError, match="stage-varying"):
        stage_param(leaf, torch.zeros(B, N + 1, 7), 1)


# ---------------------------------------------------------------- K2 at the contact-KKT shapes


@pytest.mark.parametrize("n,r", [(28, 84), (12, 84)])
def test_spd_solve_contact_kkt_shapes_match_jax_kernel_interpret(n, r):
    rng = np.random.default_rng(n)
    M = 128
    G = rng.standard_normal((M, n, n))
    A = G @ G.swapaxes(-1, -2) / n + 0.1 * np.eye(n)
    R = rng.standard_normal((M, n, r))
    ref = jax.jit(lambda a, b: pallas_spd.spd_solve_lanes(a, b, interpret=True))(
        jnp.asarray(A), jnp.asarray(R))
    got = spd_solve.spd_solve(torch.tensor(A), torch.tensor(R))
    assert _rel_err(got, ref) < TOL
    assert spd_solve.MAX_R >= r  # one block's columns; n has no cap
