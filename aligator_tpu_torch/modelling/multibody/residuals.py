"""Multibody residuals (task-space errors).

PyTorch counterpart of the frame translation, placement and velocity
residuals, the centre-of-mass residuals and the gravity-compensation
residual of ``aligator_tpu/modelling/multibody/residuals.py``, on a
phase-space state x = (q, v), with analytic Jacobians.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from ...core.functions import StageFunction, stage_param
from ...core.manifolds import batched_jacfwd
from ..spaces.se3 import exp3_quat, quat_to_matrix, se3_log
from . import model as rbd
from .derivatives import (com_jacobian, com_velocity_jacobians, frame_velocity_jacobians,
                          rnea_derivatives)


def _zero_ju(x: Tensor, u: Tensor, nr: int) -> Tensor:
    lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
    return x.new_zeros(lead + (nr, u.shape[-1]))


@dataclass
class FrameTranslationResidual(StageFunction):
    """r(x) = p_frame(q) − p_ref ∈ R³; ``p_ref`` is ``(3,)``, or ``(N, 3)``
    for a target that varies over the stages, or with ``per_scenario``
    ``(B, 3)``, one target for each scenario of the batch (the leading axis
    of the state)."""

    model: rbd.RobotModel
    p_ref: Tensor
    frame_id: int = 0
    per_scenario: bool = False

    def dim(self, space, nu):
        return 3

    def value(self, space, x, u):
        _, p = rbd.frame_placement(self.model, x[..., :self.model.nq], self.frame_id)
        if self.per_scenario:
            ref = self.p_ref
            return p - ref.reshape(ref.shape[:1] + (1,) * (x.ndim - 2) + ref.shape[1:])
        return p - stage_param(self.p_ref, x, 1)

    def jacobians(self, space, x, u):
        """Analytic: the linear rows of the LOCAL_WORLD_ALIGNED frame
        Jacobian (∂p/∂dq); zero in (v, u)."""
        J = rbd.frame_jacobian_lwa(self.model, x[..., :self.model.nq], self.frame_id)
        Ju = _zero_ju(x, u, 3)
        Jx = x.new_zeros(Ju.shape[:-2] + (3, space.ndx))
        Jx[..., :self.model.nv] = J[..., :3, :]
        return Jx, Ju


def matrix_to_quat(R: Tensor) -> Tensor:
    """Rotation matrices (..., 3, 3) → quaternions (x, y, z, w) by
    Shepperd's method: the branch of the largest of (trace, m00, m11, m22),
    selected by a one-hot weight, so that no branch is data-dependent
    control flow and every branch stays finite."""
    m = R.flatten(-2)
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.unbind(-1)
    tr = m00 + m11 + m22

    def s_of(t):
        return torch.sqrt(torch.clamp(t, min=1e-12)) * 2

    sw, sx = s_of(tr + 1.0), s_of(1.0 + m00 - m11 - m22)
    sy, sz = s_of(1.0 + m11 - m00 - m22), s_of(1.0 + m22 - m00 - m11)
    cases = torch.stack([
        torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, 0.25 * sw], -1),
        torch.stack([0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx], -1),
        torch.stack([(m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy, (m02 - m20) / sy], -1),
        torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz, (m10 - m01) / sz], -1),
    ], -2)
    pick = torch.stack([tr, m00, m11, m22], -1).argmax(-1, keepdim=True)
    onehot = (torch.arange(4, device=R.device) == pick).to(R.dtype)
    return (onehot[..., None] * cases).sum(-2)


@dataclass
class FramePlacementResidual(StageFunction):
    """r(x) = log₆(M_ref⁻¹ · M_frame(q)) ∈ R⁶, the reference pose ``R_ref
    (3, 3)``, ``p_ref (3,)``."""

    model: rbd.RobotModel
    R_ref: Tensor
    p_ref: Tensor
    frame_id: int = 0

    def dim(self, space, nu):
        return 6

    def _log(self, R: Tensor, p: Tensor) -> Tensor:
        R_rel = self.R_ref.mT @ R
        p_rel = (self.R_ref.mT @ (p - self.p_ref)[..., None])[..., 0]
        return torch.cat(se3_log(p_rel, matrix_to_quat(R_rel)), -1)

    def value(self, space, x, u):
        return self._log(*rbd.frame_placement(self.model, x[..., :self.model.nq],
                                              self.frame_id))

    def jacobians(self, space, x, u):
        """The 6×6 Jacobian of the log map under a right perturbation M·exp(ξ)
        at the current pose (forward mode over 6 tangents through log₆
        only), chained with the LOCAL frame Jacobian."""
        q = x[..., :self.model.nq]
        kin = rbd.kinematics(self.model, q)
        R, p = rbd.frame_placement(self.model, q, self.frame_id, kin=kin)
        J6 = rbd.frame_jacobian_lwa(self.model, q, self.frame_id, kin=kin)
        J_loc = torch.cat([R.mT @ J6[..., :3, :], R.mT @ J6[..., 3:, :]], -2)

        def log_of_xi(xi, Rf, p):
            Rm = Rf.reshape(3, 3)
            Rp = Rm @ quat_to_matrix(exp3_quat(xi[3:]))
            return self._log(Rp, p + Rm @ xi[:3])

        Jlog = batched_jacfwd(log_of_xi, 6, R.flatten(-2), p)
        Ju = _zero_ju(x, u, 6)
        Jx = x.new_zeros(Ju.shape[:-2] + (6, space.ndx))
        Jx[..., :self.model.nv] = Jlog @ J_loc
        return Jx, Ju


@dataclass
class FrameVelocityResidual(StageFunction):
    """r(x) = v_frame(q, v) − v_ref ∈ R⁶, in the LOCAL frame."""

    model: rbd.RobotModel
    v_ref: Tensor
    frame_id: int = 0

    def dim(self, space, nu):
        return 6

    def value(self, space, x, u):
        nq = self.model.nq
        return rbd.frame_velocity(self.model, x[..., :nq], x[..., nq:],
                                  self.frame_id) - self.v_ref

    def jacobians(self, space, x, u):
        nq = self.model.nq
        Jq, Jv = frame_velocity_jacobians(self.model, x[..., :nq], x[..., nq:],
                                          self.frame_id)
        Ju = _zero_ju(x, u, 6)
        return torch.cat([Jq, Jv], -1).expand(Ju.shape[:-2] + (6, space.ndx)), Ju


def _pad_x(J: Tensor, Ju: Tensor, ndx: int) -> Tensor:
    """``J (..., nr, nv)`` as a state Jacobian (..., nr, ndx), zero in the
    velocity columns, broadcast to the leading dims of ``Ju``."""
    Jx = J.new_zeros(Ju.shape[:-1] + (ndx,))
    Jx[..., :J.shape[-1]] = J
    return Jx


@dataclass
class CenterOfMassTranslationResidual(StageFunction):
    """r(x) = com(q) − p_ref ∈ R³."""

    model: rbd.RobotModel
    p_ref: Tensor

    def dim(self, space, nu):
        return 3

    def value(self, space, x, u):
        return rbd.center_of_mass(self.model, x[..., :self.model.nq]) - self.p_ref

    def jacobians(self, space, x, u):
        J = com_jacobian(self.model, x[..., :self.model.nq])
        Ju = _zero_ju(x, u, 3)
        return _pad_x(J, Ju, space.ndx), Ju


@dataclass
class CenterOfMassVelocityResidual(StageFunction):
    """r(x) = d/dt com(q) − v_ref ∈ R³, the centre of mass's velocity along
    the tangent v (forward mode through the configuration chart)."""

    model: rbd.RobotModel
    v_ref: Tensor

    def dim(self, space, nu):
        return 3

    def value(self, space, x, u):
        nq = self.model.nq
        q, v = x[..., :nq], x[..., nq:]
        cs = self.model.configuration_space()
        vel = torch.func.jvp(lambda dq: rbd.center_of_mass(self.model, cs.integrate(q, dq)),
                             (torch.zeros_like(v),), (v,))[1]
        return vel - self.v_ref

    def jacobians(self, space, x, u):
        nq = self.model.nq
        Jq, Jv = com_velocity_jacobians(self.model, x[..., :nq], x[..., nq:])
        Ju = _zero_ju(x, u, 3)
        return torch.cat([Jq, Jv], -1).expand(Ju.shape[:-2] + (3, space.ndx)), Ju


@dataclass
class GravityCompensationResidual(StageFunction):
    """r(x, u) = B·u − g(q), g the generalized gravity (RNEA at zero
    velocity and acceleration)."""

    model: rbd.RobotModel
    actuation: Tensor  # (nv, nu)

    def dim(self, space, nu):
        return self.model.nv

    def value(self, space, x, u):
        q = x[..., :self.model.nq]
        zero = q.new_zeros(q.shape[:-1] + (self.model.nv,))
        return (self.actuation @ u[..., None])[..., 0] - rbd.rnea(self.model, q, zero, zero)

    def jacobians(self, space, x, u):
        """Analytic: −∂g/∂dq from the RNEA derivative pass at zero velocity
        and acceleration; Ju = B."""
        q = x[..., :self.model.nq]
        zero = q.new_zeros(q.shape[:-1] + (self.model.nv,))
        dg_dq, _ = rnea_derivatives(self.model, q, zero, zero)
        Ju = self.actuation.expand(_zero_ju(x, u, self.model.nv).shape)
        return _pad_x(-dg_dq, Ju, space.ndx), Ju
