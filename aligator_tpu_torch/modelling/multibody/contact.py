"""Contact-constrained forward dynamics (world contacts), batched.

PyTorch counterpart of ``aligator_tpu/modelling/multibody/contact.py``: 3D
point and 6D flat-foot contacts in the LOCAL_WORLD_ALIGNED frame, solved as
the proximally regularized KKT system

    [[M,  Jᶜᵀ], [Jᶜ, −μI]] [a; −λ] = [τ − b; −(γ + Baumgarte)]

by a Cholesky Schur complement. Contact activity is a per-contact 0/1 flag
(rows of inactive contacts are masked), so a schedule is a stage-varying
``active (N, ncont)`` leaf. The primal solves are torch Cholesky, as the JAX
package computes them outside its kernels; the derivative pass
(:mod:`.derivatives`) reaches the kernels K5 and K2.

Loop (body-body) constraints, position references ``p_refs``/``kp`` and the
JAX package's custom-JVP wrappers are not ported: the port assembles its
Jacobians through :meth:`MultibodyConstraintFwdDynamics.acc_derivatives`,
so nothing differentiates through the KKT solve.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from ..._linalg import chol_solve, mv
from ...core.functions import stage_param
from ..dynamics.ode import ODE
from ..spaces.se3 import cross
from . import model as rbd
from .derivatives import parent_velocity


def _not_ported(p_refs, kp, contact_frames2):
    if p_refs is not None or kp != 0.0:
        raise NotImplementedError("contact position references (p_refs, kp) are "
                                  "not ported yet")
    if contact_frames2 is not None and any(f is not None for f in contact_frames2):
        raise NotImplementedError("loop (body-body) constraints are not ported yet")


def contact_offsets(contact_dims):
    """Start offset of each contact's force block in the flat vector."""
    return tuple(int(o) for o in np.cumsum((0,) + tuple(contact_dims))[:-1])


def frame_velocity_lwa(model, q, v, frame_id, kin=None) -> Tensor:
    """6D LOCAL_WORLD_ALIGNED velocity (linear at the frame origin, angular)
    of a frame, world-aligned axes."""
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    _, p = rbd.frame_placement(model, q, frame_id, kin=kin)
    V = kin["V"][..., model.frame_parents[frame_id], :]
    return torch.cat([V[..., :3] + cross(V[..., 3:], p), V[..., 3:]], -1)


def drift(model, q, kin, frame_id, dim) -> Tensor:
    """γ = d/dt(Jᶜ v) at zero joint acceleration, in closed form: along the
    tangent v, ∂V_b = Σ_j A[b,j] v_j S_j ×ₘ (V_b − V_π(j)) = −Σ_j A[b,j]
    (v_j S_j) ×ₘ V_π(j) and the frame origin moves at ṗ = V_lin + ω × p,
    so γ_lin = ∂V_lin + ∂ω × p + ω × ṗ and γ_ang = ∂ω. (The JAX package
    takes the same derivative as a JVP through the kinematics.)"""
    body = model.frame_parents[frame_id]
    _, p = rbd.frame_placement(model, q, frame_id, kin=kin)
    S, V, v = kin["Phi"], kin["V"], kin["v"]
    if "_SvxVpar" not in kin:
        kin["_SvxVpar"] = rbd.motion_cross(S * v[..., None], parent_velocity(model, V))
    dV = -(kin["A"][body][:, None] * kin["_SvxVpar"]).sum(-2)
    Vb = V[..., body, :]
    omega = Vb[..., 3:]
    pdot = Vb[..., :3] + cross(omega, p)
    lin = dV[..., :3] + cross(dV[..., 3:], p) + cross(omega, pdot)
    return lin if dim == 3 else torch.cat([lin, dV[..., 3:]], -1)


def cfd_internals(model, q, v, tau, contact_frames, active, prox_mu=1e-8, kp=0.0,
                  kd=0.0, p_refs=None, contact_dims=None, contact_frames2=None) -> dict:
    """Primal constrained-dynamics solve over leading dims (the JAX
    ``_cfd_internals``, world contacts): returns ``a``, ``lam``, the
    kinematics pass ``kin``, the masked contact Jacobian ``Jc (..., nc,
    nv)``, ``MinvJt``, ``M``, ``G`` (the regularized Delassus matrix) and
    ``mu_eff``. ``active`` is ``(..., ncont)``, broadcast against ``q``."""
    _not_ported(p_refs, kp, contact_frames2)
    if contact_dims is None:
        contact_dims = (3,) * len(contact_frames)
    dtype = q.dtype
    kin = rbd.kinematics(model, q, v)
    M = rbd.mass_matrix(model, q, kin=kin)
    free = tau - rbd.rnea(model, q, v, torch.zeros_like(v), kin=kin)

    Js, gammas = [], []
    for fid, dim in zip(contact_frames, contact_dims):
        Js.append(rbd.frame_jacobian_lwa(model, q, fid, kin=kin)[..., :dim, :])
        # Baumgarte stabilization on the velocity
        vel = frame_velocity_lwa(model, q, v, fid, kin=kin)[..., :dim]
        gammas.append(drift(model, q, kin, fid, dim) + kd * vel)
    active = torch.broadcast_to(active.to(dtype), q.shape[:-1] + active.shape[-1:])
    act = torch.cat([active[..., k:k + 1].expand(active.shape[:-1] + (dim,))
                     for k, dim in enumerate(contact_dims)], -1)
    Jc = torch.cat(Js, -2) * act[..., None]
    gamma = torch.cat(gammas, -1) * act

    # one factorization of M for [Jcᵀ | τ − b]
    Y = chol_solve(M, torch.cat([Jc.mT, free[..., None]], -1))
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
    lam = chol_solve(G, (mv(Jc, a_free) + gamma)[..., None])[..., 0]
    a = a_free - mv(MinvJt, lam)
    return {"a": a, "lam": lam, "kin": kin, "Jc": Jc, "act": act,
            "MinvJt": MinvJt, "mu_eff": mu_eff, "M": M, "G": G}


def constrained_fwd_dynamics(model, q, v, tau, contact_frames, active, prox_mu=1e-8,
                             kp=0.0, kd=0.0, p_refs=None, contact_dims=None,
                             contact_frames2=None):
    """Forward dynamics under 3D/6D world contacts: ``(a, forces)``, the
    forces the flat (..., Σdims) world-aligned vector (zero for inactive
    contacts; slice with :func:`contact_offsets`)."""
    out = cfd_internals(model, q, v, tau, contact_frames, active, prox_mu=prox_mu,
                        kp=kp, kd=kd, p_refs=p_refs, contact_dims=contact_dims,
                        contact_frames2=contact_frames2)
    return out["a"], -out["lam"]


@dataclass
class MultibodyConstraintFwdDynamics(ODE):
    """Phase-space ODE with contact-constrained accelerations.

    ``active`` is ``(ncont,)``, or ``(N, ncont)`` for a contact schedule
    that varies over the N stages (a stage-varying leaf: the state must
    then be a ``(B, N, nx)`` block). ``contact_dims`` selects 3D point or 6D
    flat-foot contacts per frame."""

    model: rbd.RobotModel
    actuation: Tensor  # (nv, nu)
    active: Tensor  # (ncont,) or (N, ncont)
    contact_frames: tuple = ()
    contact_dims: tuple = None
    prox_mu: float = 1e-8
    kd: float = 1e-2
    kp: float = 0.0
    p_refs: Tensor = None
    contact_frames2: tuple = None

    def __post_init__(self):
        _not_ported(self.p_refs, self.kp, self.contact_frames2)

    def _split(self, x, u):
        nq = self.model.nq
        active = stage_param(self.active, x, 1)
        return x[..., :nq], x[..., nq:], mv(self.actuation, u), active

    def _cfg(self):
        return dict(prox_mu=self.prox_mu, kd=self.kd, contact_dims=self.contact_dims)

    def xdot(self, space, x, u):
        q, v, tau, active = self._split(x, u)
        a, _ = constrained_fwd_dynamics(self.model, q, v, tau, self.contact_frames,
                                        active, **self._cfg())
        return torch.cat([v, a], -1)

    def acc_derivatives(self, space, x, u):
        """Analytic ``(a, ∂a/∂dq, ∂a/∂dv, ∂a/∂u)`` through the constrained
        KKT derivative pass (:func:`.derivatives.constrained_fd_derivatives`),
        the protocol ``IntegratorSemiImplEuler.jacobians`` consumes."""
        from .derivatives import constrained_fd_derivatives

        q, v, tau, active = self._split(x, u)
        a, _f, da_dq, da_dv, da_dt, *_ = constrained_fd_derivatives(
            self.model, q, v, tau, self.contact_frames, active, **self._cfg())
        return a, da_dq, da_dv, da_dt @ self.actuation
