"""SO(3) and SE(3) Lie groups (quaternion representation).

PyTorch counterpart of ``aligator_tpu/modelling/spaces/se3.py``.
Conventions follow pinocchio:

  SO(3): x = quaternion (qx, qy, qz, qw); tangent = ω (body frame);
         integrate(q, ω) = q ⊗ exp₃(ω); difference = log₃(q₀⁻¹ q₁).
  SE(3): x = (px, py, pz, qx, qy, qz, qw); tangent = (v, ω) body twist;
         integrate = x · exp₆(v, ω); difference = log₆(x₀⁻¹ x₁).

All maps use Taylor-guarded forms smooth at the identity, so their
forward-mode derivatives (the Jacobians of :func:`~...core.manifolds.
batched_jacfwd`) are finite there. As in ``se2.py``, components are slices
with a trailing dim of 1, never 0-dim tensors.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ...core.manifolds import Manifold, unit_vector

_EPS = 1e-8


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the last axis (size 3), broadcasting."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _q(q: Tensor):
    return q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]


def quat_mul(q1: Tensor, q2: Tensor) -> Tensor:
    x1, y1, z1, w1 = _q(q1)
    x2, y2, z2, w2 = _q(q2)
    return torch.cat([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], -1)


def quat_conj(q: Tensor) -> Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], -1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector v by quaternion q (R(q) @ v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def quat_to_matrix(q: Tensor) -> Tensor:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def exp3_quat(w: Tensor) -> Tensor:
    """exp: so(3) → unit quaternion, Taylor-safe."""
    t2 = (w * w).sum(-1, keepdim=True)
    t = torch.sqrt(torch.clamp(t2, min=_EPS ** 2))
    small = t2 < _EPS
    # sin(t/2)/t and cos(t/2)
    s = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * t) / t)
    c = torch.where(small, 1.0 - t2 / 8.0, torch.cos(0.5 * t))
    return torch.cat([s * w, c], -1)


def log3(q: Tensor) -> Tensor:
    """log: unit quaternion → so(3), Taylor-safe, range (-π, π]."""
    u = q[..., :3]
    w = q[..., 3:4]
    # shortest path (double cover)
    sgn = torch.where(w < 0.0, -torch.ones_like(w), torch.ones_like(w))
    u = u * sgn
    w = w * sgn
    un2 = (u * u).sum(-1, keepdim=True)
    un = torch.sqrt(torch.clamp(un2, min=_EPS ** 2))
    angle = 2.0 * torch.atan2(un, w)
    small = un2 < _EPS
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5), angle / un)
    return u * scale


def _hat(w: Tensor) -> Tensor:
    """(..., 3) → (..., 3, 3) skew matrix of ``w × ·``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def so3_jac_terms(w: Tensor):
    """Coefficients (a, b), each ``(..., 1)``, of V(w) = I + a·ŵ + b·ŵ² (the
    SE(3) exp translation map): a = (1−cos t)/t², b = (t − sin t)/t³,
    Taylor-safe."""
    t2 = (w * w).sum(-1, keepdim=True)
    t = torch.sqrt(torch.clamp(t2, min=_EPS ** 2))
    small = t2 < _EPS
    a = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.clamp(t2, min=_EPS ** 2))
    b = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (t - torch.sin(t)) / torch.clamp(t2 * t, min=_EPS ** 3))
    return a, b


def se3_exp(v: Tensor, w: Tensor):
    """exp₆: twist (v, ω) → (translation p, quaternion q)."""
    q = exp3_quat(w)
    a, b = so3_jac_terms(w)
    wv = cross(w, v)
    p = v + a * wv + b * cross(w, wv)
    return p, q


def se3_log(p: Tensor, q: Tensor):
    """log₆: (p, q) → twist (v, ω)."""
    w = log3(q)
    t2 = (w * w).sum(-1, keepdim=True)
    t = torch.sqrt(torch.clamp(t2, min=_EPS ** 2))
    small = t2 < _EPS
    # V⁻¹ = I − ŵ/2 + c ŵ², c = (1 − (t/2)·cot(t/2)) / t²
    half = 0.5 * t
    c = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / torch.clamp(t2, min=_EPS ** 2),
    )
    wp = cross(w, p)
    v = p - 0.5 * wp + c * cross(w, wp)
    return v, w


def _right_jac_blocks(xi: Tensor):
    """The blocks of the SE(3) right Jacobian J_r(ξ) = [[J, Q], [0, J]] of
    exp₆ at ξ = (v, ω) (exp₆(ξ + δ) ≈ exp₆(ξ)·exp₆(J_r δ)): J the SO(3)
    right Jacobian I − a ŵ + b ŵ², and Q Barfoot's coupling block at −ξ,
    −½ v̂ + c₁(ŵv̂ + v̂ŵ − ŵv̂ŵ) + c₂(3ŵv̂ŵ − ŵŵv̂ − v̂ŵŵ) + c₃(ŵv̂ŵŵ + ŵŵv̂ŵ)
    with c₁ = (t − sin t)/t³, c₂ = (t² + 2 cos t − 2)/(2t⁴), c₃ = (2t − 3 sin t
    + t cos t)/(2t⁵), Taylor series below t = 0.1 (c₂ and c₃ cancel there).
    Returns (J, Q, ŵ, v̂)."""
    v, w = xi[..., :3], xi[..., 3:]
    a, b = so3_jac_terms(w)
    t2 = (w * w).sum(-1, keepdim=True)[..., None]
    W, V = _hat(w), _hat(v)
    WW = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    J = eye - a[..., None] * W + b[..., None] * WW
    small = t2 < 1e-2
    ts = torch.where(small, torch.ones_like(t2), t2)  # keep the unused branch finite
    t = torch.sqrt(ts)
    c2 = torch.where(small, 1.0 / 24 - t2 / 720 + t2 * t2 / 40320,
                     (ts + 2 * torch.cos(t) - 2) / (2 * ts * ts))
    c3 = torch.where(small, 1.0 / 120 - t2 / 2520 + t2 * t2 / 120960,
                     (2 * t - 3 * torch.sin(t) + t * torch.cos(t)) / (2 * ts * ts * t))
    WV, VW = W @ V, V @ W
    WVW = WV @ W
    Q = (-0.5 * V + b[..., None] * (WV + VW - WVW) + c2 * (3 * WVW - W @ WV - VW @ W)
         + c3 * (WVW @ W + W @ WVW))
    return J, Q, W, V


def _blocks(A: Tensor, B: Tensor, D: Tensor) -> Tensor:
    """(..., 6, 6) block upper-triangular matrix [[A, B], [0, D]]."""
    return torch.cat([torch.cat([A, B], -1), torch.cat([torch.zeros_like(D), D], -1)], -2)


def se3_jexp(xi: Tensor) -> Tensor:
    """The right Jacobian (..., 6, 6) of exp₆ at the twist ξ = (v, ω)."""
    J, Q, _, _ = _right_jac_blocks(xi)
    return _blocks(J, Q, J)


def se3_jlog(xi: Tensor) -> Tensor:
    """The inverse (..., 6, 6) of :func:`se3_jexp`, the Jacobian of log₆
    under a right perturbation at exp₆(ξ): [[J⁻¹, −J⁻¹QJ⁻¹], [0, J⁻¹]] with
    J⁻¹ = I + ½ŵ + d ŵ², d = (1 − (t/2)·cot(t/2))/t² (as in :func:`se3_log`)."""
    _, Q, W, _ = _right_jac_blocks(xi)
    w = xi[..., 3:]
    t2 = (w * w).sum(-1, keepdim=True)
    t = torch.sqrt(torch.clamp(t2, min=_EPS ** 2))
    half = 0.5 * t
    d = torch.where(
        t2 < _EPS, 1.0 / 12.0 + t2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / torch.clamp(t2, min=_EPS ** 2))[..., None]
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    Ji = eye + 0.5 * W + d * (W @ W)
    return _blocks(Ji, -Ji @ Q @ Ji, Ji)


class SO3(Manifold):
    """3D rotations, quaternion chart."""

    nx = 4
    ndx = 3

    def neutral(self, dtype=None, device=None):
        return unit_vector(4, 3, dtype, device)

    def integrate(self, x, v):
        return quat_mul(x, exp3_quat(v))

    def difference(self, x0, x1):
        return log3(quat_mul(quat_conj(x0), x1))

    def __eq__(self, other):
        return type(other) is SO3

    def __hash__(self):
        return hash("SO3")


class SE3(Manifold):
    """Rigid transformations, (p, quaternion) chart."""

    nx = 7
    ndx = 6

    def neutral(self, dtype=None, device=None):
        return unit_vector(7, 6, dtype, device)

    def integrate(self, x, tangent):
        p0, q0 = x[..., :3], x[..., 3:]
        dp, dq = se3_exp(tangent[..., :3], tangent[..., 3:])
        return torch.cat([p0 + quat_rotate(q0, dp), quat_mul(q0, dq)], -1)

    def difference(self, x0, x1):
        p0, q0 = x0[..., :3], x0[..., 3:]
        p1, q1 = x1[..., :3], x1[..., 3:]
        q0c = quat_conj(q0)
        v, w = se3_log(quat_rotate(q0c, p1 - p0), quat_mul(q0c, q1))
        return torch.cat([v, w], -1)

    # closed-form chart Jacobians (those of the generic forward-mode default
    # cost ~60 small operations a direction under torch.func)

    def jintegrate(self, x, v, arg):
        """∂ integrate(x ⊕ dx, v + dv): Ad(exp₆(v)⁻¹) in x, J_r(v) in v."""
        v = v.expand(torch.broadcast_shapes(x.shape[:-1], v.shape[:-1]) + v.shape[-1:])
        if arg == 1:
            return se3_jexp(v)
        p, q = se3_exp(-v[..., :3], -v[..., 3:])
        R = quat_to_matrix(q)
        return _blocks(R, _hat(p) @ R, R)

    def jdifference(self, x0, x1, arg):
        """∂ difference(x0 ⊕ d0, x1 ⊕ d1) = Jlog₆(ξ) in x1 and −Jlog₆(−ξ) in
        x0, ξ = difference(x0, x1)."""
        xi = self.difference(x0, x1)
        return se3_jlog(xi) if arg == 1 else -se3_jlog(-xi)

    def __eq__(self, other):
        return type(other) is SE3

    def __hash__(self):
        return hash("SE3")
