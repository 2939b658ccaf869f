"""Contact-constrained forward dynamics, batched.

PyTorch counterpart of ``aligator_tpu/modelling/multibody/contact.py``: 3D
point and 6D flat-foot contacts in the LOCAL_WORLD_ALIGNED frame, against
the world or (loop constraints, a grasp) against a second frame of the
model, solved as the proximally regularized KKT system

    [[M,  Jᶜᵀ], [Jᶜ, −μI]] [a; −λ] = [τ − b; −(γ + Baumgarte)]

by a Cholesky Schur complement. Contact activity is a per-contact 0/1 flag
(rows of inactive contacts are masked), so a schedule is a stage-varying
``active (N, ncont)`` leaf. The Baumgarte term is kd·v (+ kp·(p − p_ref)
with position references ``p_refs``: world targets for world contacts,
relative targets p₁ − p₂ for loop constraints).

The primal solves are torch Cholesky and triangular solves (which a CUDA
graph captures), as the JAX package computes them outside its kernels. With
``diff_solves`` they go through :func:`~...gar.spd_solve.spd_solve_diff`
instead, K2 on the card with implicit tangents: the route of loop
constraints, whose derivatives are exact forward-mode tangents through the
KKT solve; the derivative pass of world contacts (:mod:`.derivatives`)
reaches the kernels K5 and K2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from ..._linalg import cholesky, cholesky_solve_tri, mv
from ...core.functions import StageFunction, stage_param
from ...gar.spd_solve import spd_solve_diff
from ..dynamics.ode import ODE
from ..spaces.se3 import cross
from . import model as rbd
from .derivatives import parent_velocity


def contact_offsets(contact_dims):
    """Start offset of each contact's force block in the flat vector."""
    return tuple(int(o) for o in np.cumsum((0,) + tuple(contact_dims))[:-1])


def _has_loop(contact_frames2) -> bool:
    return contact_frames2 is not None and any(f is not None for f in contact_frames2)


def frame_point_and_world_velocity(model, q, v, frame_id, kin=None):
    """World position p(q) (..., 3) and world-frame linear velocity (..., 3)
    of a frame origin."""
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    _, p = rbd.frame_placement(model, q, frame_id, kin=kin)
    V = kin["V"][..., model.frame_parents[frame_id], :]
    return p, V[..., :3] + cross(V[..., 3:], p)


def frame_velocity_lwa(model, q, v, frame_id, kin=None) -> Tensor:
    """6D LOCAL_WORLD_ALIGNED velocity (linear at the frame origin, angular)
    of a frame, world-aligned axes."""
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    _, p = rbd.frame_placement(model, q, frame_id, kin=kin)
    V = kin["V"][..., model.frame_parents[frame_id], :]
    return torch.cat([V[..., :3] + cross(V[..., 3:], p), V[..., 3:]], -1)


def contact_jacobian(model, q, frame_id, kin=None) -> Tensor:
    """LOCAL_WORLD_ALIGNED (..., 3, nv) contact Jacobian: ∂(world point
    velocity)/∂v."""
    return rbd.frame_jacobian_lwa(model, q, frame_id, kin=kin)[..., :3, :]


def relative_velocity_lwa(model, q, v, f1, f2, dim, kin=None) -> Tensor:
    """Relative LOCAL_WORLD_ALIGNED velocity of frame ``f1`` with respect to
    ``f2``, its linear part at f1's origin (the constraint's anchor):
    (v₁(p₁) − v₂(p₁)[, ω₁ − ω₂])."""
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    _, p1 = rbd.frame_placement(model, q, f1, kin=kin)
    V1 = kin["V"][..., model.frame_parents[f1], :]
    V2 = kin["V"][..., model.frame_parents[f2], :]
    lin = (V1[..., :3] + cross(V1[..., 3:], p1)) - (V2[..., :3] + cross(V2[..., 3:], p1))
    return lin if dim == 3 else torch.cat([lin, V1[..., 3:] - V2[..., 3:]], -1)


def relative_jacobian_lwa(model, q, f1, f2, dim, kin=None) -> Tensor:
    """(..., dim, nv) Jacobian of :func:`relative_velocity_lwa` with respect
    to v: the loop constraint's J = J₁(p₁) − J₂(p₁)."""
    if kin is None:
        kin = rbd.kinematics(model, q)
    _, p1 = rbd.frame_placement(model, q, f1, kin=kin)
    Phi = kin["Phi"]

    def body_jac_at(body):
        mask = kin["A"][body][:, None]
        lin = (Phi[..., :3] + cross(Phi[..., 3:], p1[..., None, :])) * mask
        return torch.cat([lin.mT, (Phi[..., 3:] * mask).mT], -2)

    J = body_jac_at(model.frame_parents[f1]) - body_jac_at(model.frame_parents[f2])
    return J[..., :dim, :]


def _body_velocity_rate(model, kin, body) -> Tensor:
    """∂V_b along the tangent v at fixed v (zero acceleration), (..., 6):
    ∂V_b = Σ_j A[b,j] v_j S_j ×ₘ (V_b − V_π(j)) = −Σ_j A[b,j] (v_j S_j) ×ₘ
    V_π(j)."""
    if "_SvxVpar" not in kin:
        kin["_SvxVpar"] = rbd.motion_cross(kin["Phi"] * kin["v"][..., None],
                                           parent_velocity(model, kin["V"]))
    return -(kin["A"][body][:, None] * kin["_SvxVpar"]).sum(-2)


def drift(model, q, kin, frame_id, dim) -> Tensor:
    """γ = d/dt(Jᶜ v) at zero joint acceleration, in closed form: with ∂V_b
    of :func:`_body_velocity_rate` and the frame origin moving at ṗ = V_lin
    + ω × p, γ_lin = ∂V_lin + ∂ω × p + ω × ṗ and γ_ang = ∂ω. (The JAX
    package takes the same derivative as a JVP through the kinematics.)"""
    body = model.frame_parents[frame_id]
    _, p = rbd.frame_placement(model, q, frame_id, kin=kin)
    dV = _body_velocity_rate(model, kin, body)
    Vb = kin["V"][..., body, :]
    omega = Vb[..., 3:]
    pdot = Vb[..., :3] + cross(omega, p)
    lin = dV[..., :3] + cross(dV[..., 3:], p) + cross(omega, pdot)
    return lin if dim == 3 else torch.cat([lin, dV[..., 3:]], -1)


def contact_drift(model, q, v, frame_id, kin=None) -> Tensor:
    """The acceleration drift (..., 3) of a 3D world contact."""
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    return drift(model, q, kin, frame_id, 3)


def _rel_drift(model, q, v, f1, f2, dim, kin=None) -> Tensor:
    """Acceleration drift of a loop constraint, d/dt(J_rel v) at zero joint
    acceleration, in closed form: with p₁ moving with body 1 at ṗ₁,
    d/dt(V₂,lin + ω₂ × p₁) = ∂V₂,lin + ∂ω₂ × p₁ + ω₂ × ṗ₁, likewise for
    body 1, and the angular rows ∂ω₁ − ∂ω₂."""
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    b1, b2 = model.frame_parents[f1], model.frame_parents[f2]
    _, p1 = rbd.frame_placement(model, q, f1, kin=kin)
    V1, V2 = kin["V"][..., b1, :], kin["V"][..., b2, :]
    dV1, dV2 = _body_velocity_rate(model, kin, b1), _body_velocity_rate(model, kin, b2)
    p1dot = V1[..., :3] + cross(V1[..., 3:], p1)

    def rate(V, dV):
        return dV[..., :3] + cross(dV[..., 3:], p1) + cross(V[..., 3:], p1dot)

    lin = rate(V1, dV1) - rate(V2, dV2)
    return lin if dim == 3 else torch.cat([lin, dV1[..., 3:] - dV2[..., 3:]], -1)


def _chol_solve(M: Tensor, rhs: Tensor) -> Tensor:
    return cholesky_solve_tri(cholesky(M), rhs)


def cfd_internals(model, q, v, tau, contact_frames, active, prox_mu=1e-8, kp=0.0,
                  kd=0.0, p_refs=None, contact_dims=None, contact_frames2=None,
                  diff_solves=False) -> dict:
    """Primal constrained-dynamics solve over leading dims (the JAX
    ``_cfd_internals``): returns ``a``, ``lam``, the kinematics pass
    ``kin``, the masked contact Jacobian ``Jc (..., nc, nv)``, ``MinvJt``,
    ``M``, ``G`` (the regularized Delassus matrix) and ``mu_eff``.
    ``active`` is ``(..., ncont)`` and ``p_refs`` ``(..., ncont, 3)``,
    broadcast against ``q``. ``contact_frames2`` gives each contact a
    second frame (a loop constraint) or None (a world contact).
    ``diff_solves`` routes the two SPD solves through
    :func:`~...gar.spd_solve.spd_solve_diff` (implicit tangents; K2 on the
    card), as the loop constraints' derivatives need: the JAX package
    measured that the UR10 throw converges with implicit tangents and
    stalls with autodiff through the Cholesky recursion. The kinematics
    ``kin`` are taken at the first joint (``rbd.kinematics``): the frame
    positions it holds are relative to ``kin["origin"]``."""
    if contact_dims is None:
        contact_dims = (3,) * len(contact_frames)
    if contact_frames2 is None:
        contact_frames2 = (None,) * len(contact_frames)
    dtype = q.dtype
    # every spatial quantity at the first joint (rbd.kinematics), the world
    # position references translated with it
    kin = rbd.kinematics(model, q, v, at_first_joint=True)
    M = rbd.mass_matrix(model, q, kin=kin)
    free = tau - rbd.rnea(model, q, v, torch.zeros_like(v), kin=kin)

    Js, gammas = [], []
    for k, (fid, f2, dim) in enumerate(zip(contact_frames, contact_frames2, contact_dims)):
        if f2 is None:
            Js.append(rbd.frame_jacobian_lwa(model, q, fid, kin=kin)[..., :dim, :])
            vel = frame_velocity_lwa(model, q, v, fid, kin=kin)[..., :dim]
            gamma = drift(model, q, kin, fid, dim) + kd * vel
        else:
            Js.append(relative_jacobian_lwa(model, q, fid, f2, dim, kin=kin))
            vel = relative_velocity_lwa(model, q, v, fid, f2, dim, kin=kin)
            gamma = _rel_drift(model, q, v, fid, f2, dim, kin=kin) + kd * vel
        if p_refs is not None:
            # Baumgarte on the position: world target, or relative p₁ − p₂
            p1 = rbd.frame_placement(model, q, fid, kin=kin)[1]
            if f2 is None:
                perr = p1 - (p_refs[..., k, :] - kin["origin"])
            else:
                perr = p1 - p_refs[..., k, :] - rbd.frame_placement(model, q, f2, kin=kin)[1]
            if dim == 6:
                perr = torch.cat([perr, torch.zeros_like(perr)], -1)
            gamma = gamma + kp * perr
        gammas.append(gamma)
    active = torch.broadcast_to(active.to(dtype), q.shape[:-1] + active.shape[-1:])
    act = torch.cat([active[..., k:k + 1].expand(active.shape[:-1] + (dim,))
                     for k, dim in enumerate(contact_dims)], -1)
    Jc = torch.cat(Js, -2) * act[..., None]
    gamma = torch.cat(gammas, -1) * act
    solve = spd_solve_diff if diff_solves else _chol_solve

    # one factorization of M for [Jcᵀ | τ − b]
    Y = solve(M, torch.cat([Jc.mT, free[..., None]], -1))
    MinvJt, a_free = Y[..., :-1], Y[..., -1]

    # Delassus matrix with the prox regularization; inactive rows reduce to
    # μ·λ = 0. The μ floor 64·eps·max diag G keeps the float32 Cholesky of a
    # structurally rank-deficient G (redundant contacts) finite.
    G0 = Jc @ MinvJt
    G0 = 0.5 * (G0 + G0.mT)
    eps = torch.finfo(dtype).eps
    mu_eff = torch.clamp(64.0 * eps * torch.diagonal(G0, dim1=-2, dim2=-1).amax(-1),
                         min=prox_mu)
    nc = Jc.shape[-2]
    G = G0 + mu_eff[..., None, None] * torch.eye(nc, dtype=dtype, device=q.device)
    lam = solve(G, (mv(Jc, a_free) + gamma)[..., None])[..., 0]
    a = a_free - mv(MinvJt, lam)
    return {"a": a, "lam": lam, "kin": kin, "Jc": Jc, "act": act,
            "MinvJt": MinvJt, "mu_eff": mu_eff, "M": M, "G": G}


def constrained_fwd_dynamics(model, q, v, tau, contact_frames, active, prox_mu=1e-8,
                             kp=0.0, kd=0.0, p_refs=None, contact_dims=None,
                             contact_frames2=None):
    """Forward dynamics under 3D/6D contacts: ``(a, forces)``, the forces
    the flat (..., Σdims) world-aligned vector (zero for inactive contacts;
    slice with :func:`contact_offsets`). With a loop constraint the solves
    are :func:`~...gar.spd_solve.spd_solve_diff`'s, as in the JAX
    package."""
    out = cfd_internals(model, q, v, tau, contact_frames, active, prox_mu=prox_mu,
                        kp=kp, kd=kd, p_refs=p_refs, contact_dims=contact_dims,
                        contact_frames2=contact_frames2,
                        diff_solves=_has_loop(contact_frames2))
    return out["a"], -out["lam"]


def underactuated_constrained_rnea(model, q, v, act_matrix, contact_frames,
                                   contact_dims=None, contact_frames2=None):
    """Static inverse dynamics under contacts of an underactuated robot:
    the minimum-norm least-squares solution of ``[B, Jcᵀ]·[u; f] = nle(q,
    v)``, the torque and world-aligned contact forces that hold the robot
    at (q, v) with zero acceleration. Returns ``(u, forces)`` with
    ``forces`` the flat (..., Σdims) vector, the convention of
    :func:`constrained_fwd_dynamics`.

    The JAX package takes ``jnp.linalg.lstsq`` (SVD, minimum norm); on CUDA
    ``torch.linalg.lstsq`` has only the full-rank ``gels`` driver, so the
    same solution comes from the SVD pseudo-inverse, with the same cutoff
    eps·max(rows, columns) of the largest singular value."""
    if contact_dims is None:
        contact_dims = (3,) * len(contact_frames)
    if contact_frames2 is None:
        contact_frames2 = (None,) * len(contact_frames)
    nu = act_matrix.shape[-1]
    kin = rbd.kinematics(model, q, v)
    nle = rbd.rnea(model, q, v, torch.zeros_like(v), kin=kin)
    Js = [rbd.frame_jacobian_lwa(model, q, fid, kin=kin)[..., :dim, :] if f2 is None
          else relative_jacobian_lwa(model, q, fid, f2, dim, kin=kin)
          for fid, f2, dim in zip(contact_frames, contact_frames2, contact_dims)]
    Jc = torch.cat(Js, -2)
    work = torch.cat([act_matrix.expand(Jc.shape[:-2] + act_matrix.shape[-2:]), Jc.mT], -1)
    sol = mv(torch.linalg.pinv(work), nle)
    return sol[..., :nu], sol[..., nu:]


@dataclass
class MultibodyConstraintFwdDynamics(ODE):
    """Phase-space ODE with contact-constrained accelerations.

    ``active`` is ``(ncont,)``, or ``(N, ncont)`` for a contact schedule
    that varies over the N stages (a stage-varying leaf: the state must
    then be a ``(B, N, nx)`` block, or one stage's state after
    :func:`~...core.dynamics.dynamics_at`); ``p_refs`` likewise ``(ncont,
    3)`` or ``(N, ncont, 3)``. ``contact_dims`` selects 3D point or 6D
    flat-foot contacts per frame, ``contact_frames2`` a second frame per
    contact (a loop constraint) or None."""

    model: rbd.RobotModel
    actuation: Tensor  # (nv, nu)
    active: Tensor  # (ncont,) or (N, ncont)
    contact_frames: tuple = ()
    contact_dims: tuple = None
    prox_mu: float = 1e-8
    kd: float = 1e-2
    kp: float = 0.0
    p_refs: Tensor = None  # (ncont, 3) or (N, ncont, 3)
    contact_frames2: tuple = None

    # the leaves that may vary over the stages, with their per-stage ndim
    STAGE_PARAMS = {"active": 1, "p_refs": 2}

    def _split(self, x, u):
        nq = self.model.nq
        active = stage_param(self.active, x, 1)
        return x[..., :nq], x[..., nq:], mv(self.actuation, u), active

    def _cfg(self, x):
        p_refs = None if self.p_refs is None else stage_param(self.p_refs, x, 2)
        return dict(prox_mu=self.prox_mu, kd=self.kd, kp=self.kp, p_refs=p_refs,
                    contact_dims=self.contact_dims, contact_frames2=self.contact_frames2)

    def xdot(self, space, x, u):
        q, v, tau, active = self._split(x, u)
        a, _ = constrained_fwd_dynamics(self.model, q, v, tau, self.contact_frames,
                                        active, **self._cfg(x))
        return torch.cat([v, a], -1)

    def acc_derivatives(self, space, x, u):
        """``(a, ∂a/∂dq, ∂a/∂dv, ∂a/∂u)``, the protocol
        ``IntegratorSemiImplEuler.jacobians`` consumes. World contacts take
        the analytic constrained KKT derivative pass
        (:func:`.derivatives.constrained_fd_derivatives`: K5 and K2 on the
        card). With a loop constraint, whose anchor moves with a body, the
        analytic rows do not hold: the derivatives are the exact
        forward-mode tangents of :func:`cfd_internals` with
        ``diff_solves`` (K2 for the solves and their tangents), composed
        with the configuration chart."""
        if _has_loop(self.contact_frames2):
            return self._loop_acc_derivatives(x, u)
        from .derivatives import constrained_fd_derivatives

        q, v, tau, active = self._split(x, u)
        cfg = self._cfg(x)
        del cfg["contact_frames2"]
        a, _f, da_dq, da_dv, da_dt, *_ = constrained_fd_derivatives(
            self.model, q, v, tau, self.contact_frames, active, **cfg)
        return a, da_dq, da_dv, da_dt @ self.actuation

    def _loop_acc_derivatives(self, x, u):
        model, nv = self.model, self.model.nv
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        x, u = x.expand(lead + x.shape[-1:]), u.expand(lead + u.shape[-1:])
        q, v, _, active = self._split(x, u)
        cfg = self._cfg(x)
        cs = model.configuration_space()

        # one tangent z = (dq, dv, du) shared by every sample: each sample's
        # acceleration depends on its own copy only, so the Jacobian of the
        # batch is each sample's Jacobian
        def acc_of(z):
            dq, dv, du = (z[s].expand(lead + z[s].shape) for s in
                          (slice(0, nv), slice(nv, 2 * nv), slice(2 * nv, None)))
            out = cfd_internals(model, cs.integrate(q, dq), v + dv,
                                mv(self.actuation, u + du), self.contact_frames,
                                active, diff_solves=True, **cfg)
            return out["a"], out["a"]

        J, a = torch.func.jacfwd(acc_of, has_aux=True)(x.new_zeros(2 * nv + u.shape[-1]))
        return a, J[..., :nv], J[..., nv:2 * nv], J[..., 2 * nv:]


# ---------------------------------------------------------------- residuals


class _ContactForceBase(StageFunction):
    """The contact force of contact ``contact_id`` (world contacts, kd = 0,
    as the JAX package's ``_contact_force``), recovered from the
    constrained-dynamics KKT solve. ``active`` is ``(ncont,)``, or ``(N,
    ncont)`` for a schedule that varies over the N stages; the Jacobians are
    forward-mode ones that keep the ``(B, N, ·)`` lead of the inputs, so that
    such a schedule meets its stages."""

    def _force(self, x, u):
        nq = self.model.nq
        dims = self.contact_dims or (3,) * len(self.contact_frames)
        active = stage_param(self.active, x, 1)
        _, forces = constrained_fwd_dynamics(
            self.model, x[..., :nq], x[..., nq:], mv(self.actuation, u),
            self.contact_frames, active, prox_mu=self.prox_mu, contact_dims=dims)
        off = contact_offsets(dims)[self.contact_id]
        return forces[..., off:off + dims[self.contact_id]]

    def jacobians(self, space, x, u):
        # one tangent z = (dx, du) shared by every sample: each sample's
        # force depends on its own copy only, so the Jacobian of the batch
        # is each sample's, and the inputs keep their (B, N, ·) lead
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        x, u = x.expand(lead + x.shape[-1:]), u.expand(lead + u.shape[-1:])
        ndx, nu = space.ndx, u.shape[-1]

        def f(z):
            dx, du = z[:ndx].expand(lead + (ndx,)), z[ndx:].expand(lead + (nu,))
            return self.value(space, space.integrate(x, dx), u + du)

        J = torch.func.jacfwd(f)(x.new_zeros(ndx + nu))
        return J[..., :ndx], J[..., ndx:]


@dataclass
class ContactForceResidual(_ContactForceBase):
    """r(x, u) = f_k(x, u) − f_ref for contact k."""

    model: rbd.RobotModel
    actuation: Tensor
    active: Tensor
    f_ref: Tensor  # (dim,)
    contact_frames: tuple = ()
    contact_dims: tuple = None
    contact_id: int = 0
    prox_mu: float = 1e-8

    def dim(self, space, nu):
        return self.f_ref.shape[-1]

    def value(self, space, x, u):
        return self._force(x, u) - self.f_ref


@dataclass
class MultibodyFrictionConeResidual(_ContactForceBase):
    """Linearized friction cone on a contact force: r ≤ 0 ⇔ the force lies
    inside the pyramid (5 rows: −fz, ±fx − μ fz, ±fy − μ fz)."""

    model: rbd.RobotModel
    actuation: Tensor
    active: Tensor
    mu_friction: Tensor
    contact_frames: tuple = ()
    contact_dims: tuple = None
    contact_id: int = 0
    prox_mu: float = 1e-8

    def dim(self, space, nu):
        return 5

    def value(self, space, x, u):
        f = self._force(x, u)
        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        m = self.mu_friction
        return torch.stack([-fz, fx - m * fz, -fx - m * fz, fy - m * fz, -fy - m * fz], -1)


@dataclass
class MultibodyWrenchConeResidual(_ContactForceBase):
    """Wrench cone on a 6D contact: the linearized friction pyramid on the
    force and the centre-of-pressure box from the torque, for a rectangular
    foot of half-extents (hL, hW); r ≤ 0 inside. Rows (the LOCAL_WORLD_ALIGNED
    wrench (f, τ) at the sole): −fz; ±fx − μ fz; ±fy − μ fz; ±τx − hW fz;
    ±τy − hL fz."""

    model: rbd.RobotModel
    actuation: Tensor
    active: Tensor
    mu_friction: Tensor
    half_length: Tensor
    half_width: Tensor
    contact_frames: tuple = ()
    contact_dims: tuple = None
    contact_id: int = 0
    prox_mu: float = 1e-8

    def dim(self, space, nu):
        return 9

    def value(self, space, x, u):
        w = self._force(x, u)
        fx, fy, fz, tx, ty = (w[..., i] for i in range(5))
        m, hl, hw = self.mu_friction, self.half_length, self.half_width
        return torch.stack([-fz, fx - m * fz, -fx - m * fz, fy - m * fz, -fy - m * fz,
                            tx - hw * fz, -tx - hw * fz, ty - hl * fz, -ty - hl * fz], -1)
