"""The remaining multibody residuals.

PyTorch counterpart of ``aligator_tpu/modelling/multibody/extra_residuals.py``:
a frame point against a world capsule, capsule-capsule self-collision, the
fly-high residual, the divergent component of motion, the whole-body
centroidal momentum and its derivative, and the landing point of a
projectile released from a frame. Each takes states with any leading
(batch) dims; the Jacobians are the generic forward-mode ones of
:class:`~...core.functions.StageFunction`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from ..._linalg import dot, mv
from ...core.functions import StageFunction
from ..spaces.se3 import cross
from . import model as rbd


def _split_qv(model, x):
    return x[..., :model.nq], x[..., model.nq:]


@dataclass
class FrameCollisionResidual(StageFunction):
    """A frame point against the world capsule around the segment [seg_a,
    seg_b]: r(x) = radius² − d², d the distance to the segment, so that r ≤
    0 ⇔ clear (``radius`` is the capsule's radius plus the margin)."""

    model: rbd.RobotModel
    seg_a: Tensor
    seg_b: Tensor
    radius: Tensor
    frame_id: int = 0

    def dim(self, space, nu):
        return 1

    def value(self, space, x, u):
        _, p = rbd.frame_placement(self.model, x[..., :self.model.nq], self.frame_id)
        ab = self.seg_b - self.seg_a
        t = (dot(p - self.seg_a, ab) / dot(ab, ab).clamp(min=1e-12)).clamp(0.0, 1.0)
        d2 = ((p - (self.seg_a + t[..., None] * ab)) ** 2).sum(-1)
        return (self.radius ** 2 - d2)[..., None]


@dataclass
class FlyHighResidual(StageFunction):
    """r(x) = v_xy(frame) · exp(−z/δ), the frame's horizontal world velocity
    damped with its height (``slope`` = δ)."""

    model: rbd.RobotModel
    slope: Tensor
    frame_id: int = 0

    def dim(self, space, nu):
        return 2

    def value(self, space, x, u):
        q, v = _split_qv(self.model, x)
        kin = rbd.kinematics(self.model, q, v)
        R, p = rbd.frame_placement(self.model, q, self.frame_id, kin=kin)
        vel = rbd.frame_velocity(self.model, q, v, self.frame_id, kin=kin)
        v_w = mv(R, vel[..., :3])
        return v_w[..., :2] * torch.exp(-p[..., 2:3] / self.slope)


def _com_velocity(model, q: Tensor, v: Tensor) -> Tensor:
    cs = model.configuration_space()
    return torch.func.jvp(lambda dq: rbd.center_of_mass(model, cs.integrate(q, dq)),
                          (torch.zeros_like(v),), (v,))[1]


@dataclass
class DCMPositionResidual(StageFunction):
    """The divergent component of motion: r(x) = c + ċ/ω − ref
    (``omega_inv`` = 1/ω)."""

    model: rbd.RobotModel
    omega_inv: Tensor
    ref: Tensor

    def dim(self, space, nu):
        return 3

    def value(self, space, x, u):
        q, v = _split_qv(self.model, x)
        com = rbd.center_of_mass(self.model, q)
        return com + self.omega_inv * _com_velocity(self.model, q, v) - self.ref


def centroidal_momentum(model: rbd.RobotModel, q: Tensor, v: Tensor) -> Tensor:
    """Whole-body centroidal momentum (..., 6): linear, then angular about
    the centre of mass, in the world frame."""
    kin = rbd.kinematics(model, q, v)
    R, p, V = kin["R"], kin["p"], kin["V"]
    w_w = V[..., 3:]
    v_w = V[..., :3] + cross(w_w, p)  # each joint origin's velocity
    c_off = mv(R, model.com.to(q.dtype))
    pi = model.mass.to(q.dtype)[:, None] * (v_w + cross(w_w, c_off))
    I_w = R @ model.inertia.to(q.dtype) @ R.mT
    com = rbd.center_of_mass(model, q, kin=kin)
    L = mv(I_w, w_w) + cross(p + c_off - com[..., None, :], pi)
    return torch.cat([pi.sum(-2), L.sum(-2)], -1)


@dataclass
class CentroidalMomentumResidual(StageFunction):
    """r(x) = h(q, v) − h_ref."""

    model: rbd.RobotModel
    h_ref: Tensor

    def dim(self, space, nu):
        return 6

    def value(self, space, x, u):
        q, v = _split_qv(self.model, x)
        return centroidal_momentum(self.model, q, v) - self.h_ref


@dataclass
class CentroidalMomentumDerivativeResidual(StageFunction):
    """r(x, u) = ḣ(q, v, a) − ḣ_ref, a the free forward dynamics under the
    torque ``actuation @ u``: ḣ = ∂h/∂q·v + ∂h/∂v·a."""

    model: rbd.RobotModel
    actuation: Tensor
    h_ref: Tensor

    def dim(self, space, nu):
        return 6

    def value(self, space, x, u):
        q, v = _split_qv(self.model, x)
        a = rbd.aba(self.model, q, v, mv(self.actuation, u))
        cs = self.model.configuration_space()
        _, dh = torch.func.jvp(
            lambda dq, vv: centroidal_momentum(self.model, cs.integrate(q, dq), vv),
            (torch.zeros_like(v), v), (v, a))
        return dh - self.h_ref


def _segment_segment_sqdist(p1: Tensor, q1: Tensor, p2: Tensor, q2: Tensor,
                            eps=1e-12) -> Tensor:
    """Squared distance of the segments [p1, q1] and [p2, q2] (Ericson's
    clamped closest points; s = 0 for parallel segments)."""
    d1, d2, r = q1 - p1, q2 - p2, p1 - p2
    a, e, f = dot(d1, d1), dot(d2, d2), dot(d2, r)
    c, b = dot(d1, r), dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > eps,
                    ((b * f - c * e) / denom.clamp(min=eps)).clamp(0.0, 1.0),
                    torch.zeros_like(denom))
    t = (b * s + f) / e.clamp(min=eps)
    t_cl = t.clamp(0.0, 1.0)
    # s again for the clamped t (one Gauss-Seidel pass is exact here)
    s = torch.where((t - t_cl).abs() > 0.0,
                    ((t_cl * b - c) / a.clamp(min=eps)).clamp(0.0, 1.0), s)
    diff = (p1 + s[..., None] * d1) - (p2 + t_cl[..., None] * d2)
    return dot(diff, diff)


@dataclass
class LinkCollisionResidual(StageFunction):
    """Self-collision of two capsules on robot frames, each the segment
    ``frame ⊕ (offset ± half_len·axis)`` with its radius: r(x) = (r₁ + r₂ +
    margin)² − d²."""

    model: rbd.RobotModel
    axis1: Tensor
    half_len1: Tensor
    radius1: Tensor
    axis2: Tensor
    half_len2: Tensor
    radius2: Tensor
    offset1: Tensor
    offset2: Tensor
    margin: Tensor
    frame_id1: int = 0
    frame_id2: int = 0

    def dim(self, space, nu):
        return 1

    def value(self, space, x, u):
        q = x[..., :self.model.nq]
        kin = rbd.kinematics(self.model, q)
        R1, p1 = rbd.frame_placement(self.model, q, self.frame_id1, kin=kin)
        R2, p2 = rbd.frame_placement(self.model, q, self.frame_id2, kin=kin)
        c1, a1 = p1 + mv(R1, self.offset1), mv(R1, self.axis1 * self.half_len1)
        c2, a2 = p2 + mv(R2, self.offset2), mv(R2, self.axis2 * self.half_len2)
        d2 = _segment_segment_sqdist(c1 - a1, c1 + a1, c2 - a2, c2 + a2)
        rmin = self.radius1 + self.radius2 + self.margin
        return (rmin ** 2 - d2)[..., None]


@dataclass
class BallisticLandingResidual(StageFunction):
    """The landing point of a point released from a frame with the frame's
    world linear velocity, on the plane z = z_ground, against the target:
    r(x) = landing_xy(q, v) − target_xy, with the flight time t_f = (v_z +
    √(v_z² + 2 g (p_z − z_ground)))/g."""

    model: rbd.RobotModel
    target_xy: Tensor
    gravity: Tensor
    z_ground: Tensor
    frame_id: int = 0

    def dim(self, space, nu):
        return 2

    def value(self, space, x, u):
        q, v = _split_qv(self.model, x)
        kin = rbd.kinematics(self.model, q, v)
        R, p = rbd.frame_placement(self.model, q, self.frame_id, kin=kin)
        V = rbd.frame_velocity(self.model, q, v, self.frame_id, kin=kin)
        v_w = mv(R, V[..., :3])
        g, vz = self.gravity, v_w[..., 2]
        dz = (p[..., 2] - self.z_ground).clamp(min=0.0)
        disc = (vz ** 2 + 2.0 * g * dz).clamp(min=1e-12)
        tf = (vz + torch.sqrt(disc)) / g
        return p[..., :2] + v_w[..., :2] * tf[..., None] - self.target_xy
