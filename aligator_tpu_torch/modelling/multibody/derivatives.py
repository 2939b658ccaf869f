"""Analytic rigid-body and contact-dynamics derivatives, batched.

PyTorch counterpart of ``aligator_tpu/modelling/multibody/derivatives.py``
(world contacts). With every spatial quantity at the world origin, the
derivatives under a right-perturbation ``q ⊕ δ e_j`` are closed
cross-product forms over the static masks ``A (nbody, nv)`` and ``D (nv,
nv)``:

    ∂S_k/∂q_j  = D[k,j] · S_j ×ₘ S_k
    ∂V_b/∂q_j  = A[b,j] · S_j ×ₘ (V_b − V_{π(j)})
    ∂I_b/∂q_j  = A[b,j] · (S_j ×* I_b − I_b S_j ×)

so ∂τ/∂q and ∂τ/∂v follow by the product rule as einsums, with no
recursion over joints and no autodiff through a factorization.
:func:`constrained_fd_derivatives` turns the derivative rows of
``fd_rows.fd_rows`` (K5) into the Jacobians of the contact-constrained
forward dynamics with one joint KKT solve through
:func:`~aligator_tpu_torch.gar.spd_solve.spd_solve` (K2), as the JAX package
sends them to its SPD kernel.

Conventions: spatial vectors are (linear, angular) 6-vectors at the world
origin; tangent coordinates are the manifold's local (right) convention.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..._linalg import cholesky, cholesky_solve_tri
from ...gar import spd_solve
from ..spaces.se3 import _hat, cross
from . import model as rbd
from .model import inertia_apply, motion_cross, motion_cross_force


def cross_motion_matrix(S: Tensor) -> Tensor:
    """(…,6) motion vector → (…,6,6) matrix of m ↦ S ×ₘ m:
    [[ŵ, v̂], [0, ŵ]]."""
    hw, hv = _hat(S[..., 3:]), _hat(S[..., :3])
    return torch.cat([torch.cat([hw, hv], -1),
                      torch.cat([torch.zeros_like(hw), hw], -1)], -2)


def spatial_inertia6(m: Tensor, c: Tensor, I_c: Tensor) -> Tensor:
    """Explicit 6×6 spatial inertia at the world origin from (mass, world
    com, world-rotated I about the com): p = m v − m ĉ w,
    L = m ĉ v + (I_c − m ĉ ĉ) w. Broadcasts."""
    chat = _hat(c)
    eye3 = torch.eye(3, dtype=c.dtype, device=c.device)
    mI = m[..., None, None] * eye3
    mchat = m[..., None, None] * chat
    return torch.cat([torch.cat([mI.expand(chat.shape), -mchat], -1),
                      torch.cat([mchat, I_c - mchat @ chat], -1)], -2)


def parent_velocity(model, X: Tensor) -> Tensor:
    """``X[..., π(j), :]`` for every dof j (zero where π(j) is the world),
    from a per-body ``X (..., nb, 6)``."""
    tab = rbd.tables(model, X)
    return X[..., tab["dof_parent"], :] * tab["has_parent"]


def rnea_tensors(model, q: Tensor, v: Tensor, a: Tensor, fext=None, kin=None) -> dict:
    """The shared derivative tensor pass of the JAX ``rnea_tensors``, over
    leading dims: primal S (..., nv, 6), Vb/Accb (..., nb, 6), I6 (..., nb,
    6, 6), f (..., nb, 6), F (..., nv, 6), the q-direction derivative
    tensors dV/dAcc and v-direction dVv/dAccv (..., nv, nb, 6) indexed
    ``[j, b]``, ∂τ/∂q and ∂τ/∂v (..., nv, nv) with rows the τ component,
    and the masks A, D and the pair table SxS (..., nv, nv, 6). Forms
    ``dI6`` (..., nv, nb, 6, 6) explicitly. ``fext``: external spatial
    forces (..., nb, 6) in each joint's LOCAL frame (body-fixed under a
    perturbation), as :func:`.model.rnea`."""
    dt = q.dtype
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    tab = rbd.tables(model, q)
    nv = model.nv
    A = kin["A"]  # (nb, nv)
    S = kin["Phi"]
    Vb = kin["V"]
    D = tab["D"]
    maskjb = A.T[:, :, None]  # (nv, nb, 1)
    Vpar = parent_velocity(model, Vb)
    Vdof = Vb[..., tab["dof_joint"], :]

    Ca = torch.einsum("bk,...k,...ks->...bs", A, a, S)
    Capar = parent_velocity(model, Ca)
    Sv = S * v[..., None]
    beta = motion_cross(Vdof, Sv)
    Accb = Ca + torch.einsum("bk,...ks->...bs", A, beta) + rbd.gravity_offset(model, q)

    Sj = S[..., :, None, :]
    SxS = motion_cross(Sj, S[..., None, :, :])  # [j, k]
    dV = maskjb * motion_cross(Sj, Vb[..., None, :, :] - Vpar[..., :, None, :])
    dAcc = maskjb * motion_cross(Sj, Ca[..., None, :, :] - Capar[..., :, None, :])
    X1 = motion_cross(Sj, Vdof[..., None, :, :] - Vpar[..., :, None, :])
    X2 = motion_cross(X1, Sv[..., None, :, :])
    X3 = motion_cross(Vdof[..., None, :, :].expand(X1.shape),
                      SxS * v[..., None, :, None])
    G = D.T[:, :, None] * (X2 + X3)  # [j, k]
    dAcc = dAcc + torch.einsum("bk,...jks->...jbs", A, G)

    dVv = maskjb * S[..., :, None, :]
    eye = torch.eye(nv, dtype=dt, device=q.device)
    Gv = (D.T[:, :, None] * SxS * v[..., None, :, None]
          + eye[:, :, None] * motion_cross(Vdof, S)[..., None, :, :])
    dAccv = torch.einsum("bk,...jks->...jbs", A, Gv)

    m_w, c_w, I_w = rbd.world_inertia(model, kin["R"], kin["p"])
    I6 = spatial_inertia6(m_w, c_w, I_w)
    h = inertia_apply(m_w, c_w, I_w, Vb)
    f = inertia_apply(m_w, c_w, I_w, Accb) + motion_cross_force(Vb, h)

    cmS = cross_motion_matrix(S)
    cfS = -cmS.mT
    dI6 = maskjb[..., None] * (
        torch.einsum("...jst,...btu->...jbsu", cfS, I6)
        - torch.einsum("...bst,...jtu->...jbsu", I6, cmS))

    def i6(x):  # I6_b applied to x[..., j, b, :]
        return torch.einsum("...bsu,...jbu->...jbs", I6, x)

    hb = h[..., None, :, :]
    df = (torch.einsum("...jbsu,...bu->...jbs", dI6, Accb) + i6(dAcc)
          + motion_cross_force(dV, hb)
          + motion_cross_force(Vb[..., None, :, :],
                               torch.einsum("...jbsu,...bu->...jbs", dI6, Vb) + i6(dV)))
    if fext is not None:
        fxw = rbd.ext_forces_world(kin, fext)
        f = f - fxw
        df = df - maskjb * motion_cross_force(Sj, fxw[..., None, :, :])
    dfv = (i6(dAccv) + motion_cross_force(dVv, hb)
           + motion_cross_force(Vb[..., None, :, :], i6(dVv)))

    F = torch.einsum("bk,...bs->...ks", A, f)
    dtau_dq = (D * torch.einsum("...jks,...ks->...jk", SxS, F).mT
               + torch.einsum("bk,...jbs,...ks->...kj", A, df, S))
    dtau_dv = torch.einsum("bk,...jbs,...ks->...kj", A, dfv, S)
    return {"kin": kin, "S": S, "Vb": Vb, "Accb": Accb, "I6": I6, "f": f, "F": F,
            "dV": dV, "dAcc": dAcc, "dVv": dVv, "dAccv": dAccv,
            "dtau_dq": dtau_dq, "dtau_dv": dtau_dv, "A": A, "D": D, "SxS": SxS}


def rnea_derivatives(model, q: Tensor, v: Tensor, a: Tensor, fext=None, kin=None):
    """Analytic ∂τ/∂q (local tangent coordinates) and ∂τ/∂v of
    ``rnea(model, q, v, a, fext)``, each (..., nv, nv), rows the τ
    component; ∂τ/∂a is the mass matrix."""
    t = rnea_tensors(model, q, v, a, fext=fext, kin=kin)
    return t["dtau_dq"], t["dtau_dv"]


def aba_deriv_pack(model, q: Tensor, v: Tensor, tau: Tensor, fext=None) -> dict:
    """Forward dynamics and its analytic derivatives from one kinematics
    pass and one Cholesky factor of M: ``a``, ``da_dq``, ``da_dv`` (...,
    nv, nv), ``solve_M`` (X ↦ M⁻¹X for X (..., nv, k)) and ``kin``. The
    inverse-dynamics identity ∂a/∂θ = −M⁻¹ ∂RNEA/∂θ at a = a* gives every
    direction from the RNEA derivative pass."""
    kin = rbd.kinematics(model, q, v, at_first_joint=True)
    b = rbd.rnea(model, q, v, torch.zeros_like(v), fext, kin=kin)
    L = cholesky(rbd.mass_matrix(model, q, kin=kin))

    def solve_M(X: Tensor) -> Tensor:
        lead = torch.broadcast_shapes(L.shape[:-2], X.shape[:-2])
        return cholesky_solve_tri(L.expand(lead + L.shape[-2:]),
                                  X.expand(lead + X.shape[-2:]))

    a = solve_M((tau - b)[..., None])[..., 0]
    dtau_dq, dtau_dv = rnea_derivatives(model, q, v, a, fext=fext, kin=kin)
    nv = model.nv
    da = -solve_M(torch.cat([dtau_dq, dtau_dv], -1))
    return {"a": a, "da_dq": da[..., :nv], "da_dv": da[..., nv:],
            "solve_M": solve_M, "kin": kin}


def aba_derivatives(model, q: Tensor, v: Tensor, tau: Tensor, fext=None):
    """Analytic derivatives of ``a = aba(model, q, v, tau, fext)``: returns
    ``(a, da_dq, da_dv, solve_M)``, ∂a/∂τ = M⁻¹ applied by ``solve_M``
    (:func:`aba_deriv_pack`)."""
    pack = aba_deriv_pack(model, q, v, tau, fext)
    return pack["a"], pack["da_dq"], pack["da_dv"], pack["solve_M"]


def ext_generalized(model, kin: dict, ext: Tensor) -> Tensor:
    """Generalized torque (..., nv) of external spatial forces given in the
    joints' LOCAL frames (the linear map fext ↦ τ of RNEA at fixed
    kinematics)."""
    fxw = rbd.ext_forces_world(kin, ext)
    return (kin["Phi"] * torch.einsum("bk,...bs->...ks", kin["A"], fxw)).sum(-1)


def velocity_tensors(model, q: Tensor, v: Tensor, kin=None) -> dict:
    """The kinematics plus the body-velocity derivative tensor dV (..., nv,
    nb, 6) only: what the kinematic residuals' Jacobians need."""
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    S, Vb = kin["Phi"], kin["V"]
    dV = kin["A"].T[:, :, None] * motion_cross(
        S[..., :, None, :], Vb[..., None, :, :] - parent_velocity(model, Vb)[..., :, None, :])
    return {"kin": kin, "S": S, "A": kin["A"], "Vb": Vb, "dV": dV}


def frame_velocity_jacobians(model, q: Tensor, v: Tensor, frame_id: int):
    """Analytic (Jq, Jv), each (..., 6, nv): tangent-space Jacobians of the
    LOCAL-frame spatial velocity of ``frame_id``."""
    t = velocity_tensors(model, q, v)
    kin, S, dV = t["kin"], t["S"], t["dV"]
    body = model.frame_parents[frame_id]
    R, p = rbd.frame_placement(model, q, frame_id, kin=kin)
    V = t["Vb"][..., body, :]
    omega, VL = V[..., 3:], V[..., :3]
    ab = t["A"][body][:, None]  # (nv, 1)
    J6 = rbd.frame_jacobian_lwa(model, q, frame_id, kin=kin)
    Jv = torch.cat([R.mT @ J6[..., :3, :], R.mT @ J6[..., 3:, :]], -2)
    pc = p[..., None, :]
    dom, dVL = dV[..., body, 3:], dV[..., body, :3]
    dp = ab * (S[..., :3] + cross(S[..., 3:], pc))
    wmask = ab * S[..., 3:]  # each dof screw's angular velocity at the frame
    v_at_f = (VL + cross(omega, p))[..., None, :]
    # d(Rᵀx)[j] = −Rᵀ(w_j × x) + Rᵀ dx[j]; rows j are world vectors
    dlin = -cross(wmask, v_at_f) + dVL + cross(dom, pc) + cross(omega[..., None, :], dp)
    dang = -cross(wmask, omega[..., None, :]) + dom
    Jq = torch.cat([(dlin @ R).mT, (dang @ R).mT], -2)
    return Jq, Jv


def com_jacobian(model, q: Tensor, kin=None) -> Tensor:
    """Analytic (..., 3, nv) Jacobian of the centre of mass: dof j moves
    body b's com c_b at the point velocity of its screw, A[b,j] (S_j,lin +
    S_j,ang × c_b), weighted by the masses."""
    if kin is None:
        kin = rbd.kinematics(model, q)
    dt = q.dtype
    m = model.mass.to(dt)
    c_w = kin["p"] + (kin["R"] @ model.com.to(dt)[..., None])[..., 0]
    S = kin["Phi"]
    pt = S[..., :, None, :3] + cross(S[..., :, None, 3:], c_w[..., None, :, :])
    dcom = torch.einsum("b,bj,...jbs->...js", m, kin["A"], pt) / m.sum()
    return dcom.mT


def com_velocity_jacobians(model, q: Tensor, v: Tensor):
    """Analytic (Jq, Jv), each (..., 3, nv), of the centre of mass's linear
    velocity v_com = Σ m_b (V_b,lin + ω_b × c_b) / Σ m_b."""
    t = velocity_tensors(model, q, v)
    kin, S, A, Vb, dV = t["kin"], t["S"], t["A"], t["Vb"], t["dV"]
    dt = q.dtype
    m = model.mass.to(dt)
    c_w = kin["p"] + (kin["R"] @ model.com.to(dt)[..., None])[..., 0]
    cb = c_w[..., None, :, :]
    dc = A.T[:, :, None] * (S[..., :, None, :3] + cross(S[..., :, None, 3:], cb))
    dterm = dV[..., :3] + cross(dV[..., 3:], cb) + cross(Vb[..., None, :, 3:], dc)
    Jq = (torch.einsum("b,...jbs->...js", m, dterm) / m.sum()).mT
    return Jq, com_jacobian(model, q, kin=kin)


def point_derivative_rows(tensors: dict, body: int, p_c: Tensor, dim: int,
                          kp: float, kd: float, has_prefs: bool):
    """Directional derivatives of the contact-acceleration rows ``J a + γ +
    corr`` of one contact (body, world point ``p_c (..., 3)``): returns
    rows_q, rows_v (..., dim, nv) and dp (..., nv, 3). The linear rows are
    the material-point classical acceleration α = Acc_lin + Acc_ang × p +
    ω × ṗ, the angular rows (6D) Acc_ang."""
    S, Vb, Accb, A = tensors["S"], tensors["Vb"], tensors["Accb"], tensors["A"]
    dV, dAcc = tensors["dV"][..., body, :], tensors["dAcc"][..., body, :]
    dVv, dAccv = tensors["dVv"][..., body, :], tensors["dAccv"][..., body, :]
    ab = A[body]
    omega, VL = Vb[..., body, 3:], Vb[..., body, :3]
    AccA = Accb[..., body, 3:]
    pdot = VL + cross(omega, p_c)
    pc = p_c[..., None, :]

    dp = ab[:, None] * (S[..., :3] + cross(S[..., 3:], pc))
    dom, dVL = dV[..., 3:], dV[..., :3]
    dAccL, dAccA = dAcc[..., :3], dAcc[..., 3:]
    dpdot = dVL + cross(dom, pc) + cross(omega[..., None, :], dp)
    dalpha_q = (dAccL + cross(dAccA, pc) + cross(AccA[..., None, :], dp)
                + cross(dom, pdot[..., None, :]) + cross(omega[..., None, :], dpdot))
    domv, dVLv = dVv[..., 3:], dVv[..., :3]
    dAccLv, dAccAv = dAccv[..., :3], dAccv[..., 3:]
    dpdotv = dVLv + cross(domv, pc)
    dalpha_v = (dAccLv + cross(dAccAv, pc) + cross(domv, pdot[..., None, :])
                + cross(omega[..., None, :], dpdotv))

    lin_q = dalpha_q + kd * dpdot
    if has_prefs:
        lin_q = lin_q + kp * dp
    lin_v = dalpha_v + kd * dpdotv
    if dim == 3:
        return lin_q.mT, lin_v.mT, dp
    rows_q = torch.cat([lin_q.mT, (dAccA + kd * dom).mT], -2)
    rows_v = torch.cat([lin_v.mT, (dAccAv + kd * domv).mT], -2)
    return rows_q, rows_v, dp


def fd_rows_inputs(model, q: Tensor, v: Tensor, a: Tensor, contact_frames,
                   kin=None) -> dict:
    """The per-instance primal pieces the derivative-rows kernel reads (the
    JAX ``_prep_lane_inputs``): S, Vpar, Vdof, Capar (..., nv, 6); Vb, Ca,
    Accb, h = I6 Vb, y = I6 Accb (..., nb, 6); I6 (..., nb, 6, 6); the
    contact points pc (..., ncont, 3)."""
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    A, S, Vb = kin["A"], kin["Phi"], kin["V"]
    Ca = torch.einsum("bk,...k,...ks->...bs", A, a, S)
    Vdof = Vb[..., rbd.tables(model, q)["dof_joint"], :]
    beta = motion_cross(Vdof, S * v[..., None])
    Accb = Ca + torch.einsum("bk,...ks->...bs", A, beta) + rbd.gravity_offset(model, q)
    m_w, c_w, I_w = rbd.world_inertia(model, kin["R"], kin["p"])
    pcs = torch.stack([rbd.frame_placement(model, q, f, kin=kin)[1]
                       for f in contact_frames], -2)
    return dict(S=S, Vb=Vb, Vpar=parent_velocity(model, Vb), Vdof=Vdof, Ca=Ca,
                Capar=parent_velocity(model, Ca), Accb=Accb,
                h=inertia_apply(m_w, c_w, I_w, Vb), y=inertia_apply(m_w, c_w, I_w, Accb),
                I6=spatial_inertia6(m_w, c_w, I_w), pcs=pcs)


def constrained_fd_tensors(model, q, v, tau, contact_frames, active, prox_mu=1e-8,
                           kp=0.0, kd=0.0, p_refs=None, contact_dims=None) -> dict:
    """Primal constrained solve (``contact.cfd_internals``) plus the
    derivative rows at fixed (a*, λ*): ra1_q, ra1_v (..., nv, nv) of
    ∂(RNEA + Jᵀλ)/∂(q, v) and r2_q, r2_v (..., nc, nv) of ∂(J a + γ)/∂(q,
    v), from :func:`.fd_rows.fd_rows` (K5 on the card, its plain version on
    the CPU)."""
    from . import contact, fd_rows

    if contact_dims is None:
        contact_dims = (3,) * len(contact_frames)
    out = contact.cfd_internals(model, q, v, tau, contact_frames, active,
                                prox_mu=prox_mu, kp=kp, kd=kd, p_refs=p_refs,
                                contact_dims=contact_dims)
    act = torch.broadcast_to(active.to(q.dtype), q.shape[:-1] + active.shape[-1:])
    rows = fd_rows.fd_rows(model, q, v, out["a"], out["lam"], act,
                           tuple(contact_frames), tuple(contact_dims), kd=float(kd),
                           kp=float(kp), has_prefs=p_refs is not None,
                           kin=out["kin"])
    out.update(zip(("ra1_q", "ra1_v", "r2_q", "r2_v"), rows))
    return out


def constrained_fd_derivatives(model, q, v, tau, contact_frames, active,
                               prox_mu=1e-8, kp=0.0, kd=0.0, p_refs=None,
                               contact_dims=None):
    """Analytic Jacobians of ``contact.constrained_fwd_dynamics``: returns
    ``(a, forces, da_dq, da_dv, da_dtau, df_dq, df_dv, df_dtau)`` with
    q-derivatives in local tangent coordinates. The 3nv tangent directions
    (q, v, τ) share one joint KKT solve: ``M X = R1`` and ``G dλ = J X − R2``
    through :func:`~aligator_tpu_torch.gar.spd_solve.spd_solve` (K2 on the
    card, n = nv and nc, r = 3 nv)."""
    out = constrained_fd_tensors(model, q, v, tau, contact_frames, active,
                                 prox_mu=prox_mu, kp=kp, kd=kd, p_refs=p_refs,
                                 contact_dims=contact_dims)
    Jc, MinvJt = out["Jc"], out["MinvJt"]
    nv = model.nv
    lead = q.shape[:-1]
    eye = torch.eye(nv, dtype=q.dtype, device=q.device).expand(lead + (nv, nv))
    R1 = torch.cat([-out["ra1_q"], -out["ra1_v"], eye], -1)
    R2 = torch.cat([-out["r2_q"], -out["r2_v"], torch.zeros_like(Jc)], -1)
    X = spd_solve.spd_solve(out["M"], R1)
    dlam = spd_solve.spd_solve(out["G"], Jc @ X - R2)
    Dm = X - MinvJt @ dlam
    return (out["a"], -out["lam"],
            Dm[..., :nv], Dm[..., nv:2 * nv], Dm[..., 2 * nv:],
            -dlam[..., :nv], -dlam[..., nv:2 * nv], -dlam[..., 2 * nv:])
