"""Collision-geometry signed distances and frame-collision residuals.

PyTorch counterpart of ``aligator_tpu/modelling/multibody/geometry.py``:
closed-form distances between points, segments, halfspaces, boxes and
spheres; support functions of convex shapes and a fixed-iteration
convex-convex distance (24 steps, no data-dependent branch, no host read,
so that a line-search trial that evaluates it can be captured in a CUDA
graph); and the residuals that attach a sphere, capsule or convex hull to a
robot frame and keep it clear of a world obstacle or of another frame's
sphere.

Residual convention: ``r(x) ≤ 0 ⇔ collision-free`` (use with
:class:`~...core.sets.NegativeOrthant`); each returns the linear
penetration ``margin − separation``. Every function takes points with any
leading (batch) dims, ``(..., 3)``, and broadcasts them against its
parameters; the residuals' Jacobians are the generic forward-mode ones of
:class:`~...core.functions.StageFunction`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import Tensor

from ..._linalg import dot, mv
from ...core.functions import StageFunction
from . import model as rbd


# ---------------------------------------------------------------- primitives


def point_halfspace_distance(p: Tensor, normal: Tensor, offset) -> Tensor:
    """Signed distance of the point ``p`` to the plane ``{x : n·x =
    offset}`` (``n`` unit, positive on the free side)."""
    return dot(normal, p) - offset


def segment_halfspace_distance(a: Tensor, b: Tensor, normal: Tensor, offset) -> Tensor:
    """Signed distance of the segment [a, b] to a plane: its closer
    endpoint's."""
    return torch.minimum(point_halfspace_distance(a, normal, offset),
                         point_halfspace_distance(b, normal, offset))


def point_box_distance(p: Tensor, center: Tensor, rot: Tensor, half_extents: Tensor,
                       eps=1e-12) -> Tensor:
    """Signed distance of the point ``p`` to an oriented box (``rot``
    world←box), positive outside: ``‖max(q, 0)‖ + min(max_i q_i, 0)``, q =
    |p_local| − h."""
    q = mv(rot.mT, p - center).abs() - half_extents
    outside = torch.sqrt((q.clamp(min=0.0) ** 2).sum(-1) + eps) - math.sqrt(eps)
    return outside + q.amax(-1).clamp(max=0.0)


def point_segment_distance(p: Tensor, a: Tensor, b: Tensor, eps=1e-12) -> Tensor:
    """Distance of the point ``p`` to the segment [a, b]."""
    ab = b - a
    t = (dot(p - a, ab) / dot(ab, ab).clamp(min=eps)).clamp(0.0, 1.0)
    return torch.sqrt(((p - (a + t[..., None] * ab)) ** 2).sum(-1) + eps)


def sphere_sphere_distance(c1: Tensor, r1, c2: Tensor, r2, eps=1e-12) -> Tensor:
    """Separation of two spheres (negative where they overlap)."""
    return torch.sqrt(((c1 - c2) ** 2).sum(-1) + eps) - (r1 + r2)


# ---------------------------------------------------------------- support maps


def support_hull(verts: Tensor, d: Tensor) -> Tensor:
    """Support point of the convex hull of ``verts (..., K, 3)`` in the
    direction ``d (..., 3)``: the vertex of largest ``v·d``."""
    k = mv(verts, d).argmax(-1)
    return torch.take_along_dim(verts, k[..., None, None], -2)[..., 0, :]


def support_sphere(center: Tensor, radius, d: Tensor, eps=1e-12) -> Tensor:
    return center + radius * d / torch.sqrt(dot(d, d) + eps)[..., None]


def support_capsule(a: Tensor, b: Tensor, radius, d: Tensor, eps=1e-12) -> Tensor:
    """Support of the capsule [a, b] ⊕ ball(radius)."""
    seg = torch.where((dot(b - a, d) >= 0.0)[..., None], b, a)
    return seg + radius * d / torch.sqrt(dot(d, d) + eps)[..., None]


def support_box(center: Tensor, rot: Tensor, half_extents: Tensor, d: Tensor) -> Tensor:
    """Support of an oriented box (``rot`` world←box)."""
    return center + mv(rot, torch.sign(mv(rot.mT, d)) * half_extents)


def support_cylinder(center: Tensor, rot: Tensor, radius, half_len, d: Tensor,
                     eps=1e-12) -> Tensor:
    """Support of an oriented cylinder, its axis the box z of ``rot``."""
    dl = mv(rot.mT, d)
    perp = dl[..., :2]
    rim = radius * perp / torch.sqrt(dot(perp, perp) + eps)[..., None]
    cap = torch.sign(dl[..., 2:]) * half_len
    return center + mv(rot, torch.cat([rim, cap], -1))


def _min_norm_triangle(p0: Tensor, p1: Tensor, p2: Tensor, eps=1e-12) -> Tensor:
    """The point of least norm of the triangle conv{p0, p1, p2}: the
    interior (affine) candidate and the three edge projections, the valid
    one of least norm selected by ``where`` (no branch on the data)."""

    def seg_proj(a, b):
        ab = b - a
        t = (-dot(a, ab) / dot(ab, ab).clamp(min=eps)).clamp(0.0, 1.0)
        return a + t[..., None] * ab

    c01, c12, c02 = seg_proj(p0, p1), seg_proj(p1, p2), seg_proj(p0, p2)
    # the origin's projection onto the triangle's plane, by the 2 x 2
    # normal equations of its affine coordinates
    e1, e2 = p1 - p0, p2 - p0
    g11, g12, g22 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
    b1, b2 = -dot(p0, e1), -dot(p0, e2)
    det = g11 * g22 - g12 * g12
    safe = det.abs() > eps
    det_s = torch.where(safe, det, torch.ones_like(det))
    l1 = (g22 * b1 - g12 * b2) / det_s
    l2 = (g11 * b2 - g12 * b1) / det_s
    inside = safe & (l1 >= 0.0) & (l2 >= 0.0) & (l1 + l2 <= 1.0)
    c_in = p0 + l1[..., None] * e1 + l2[..., None] * e2

    best = c01
    best = torch.where((dot(c12, c12) < dot(best, best))[..., None], c12, best)
    best = torch.where((dot(c02, c02) < dot(best, best))[..., None], c02, best)
    return torch.where((inside & (dot(c_in, c_in) < dot(best, best)))[..., None],
                       c_in, best)


def convex_distance(support_a, support_b, x_init: Tensor | None = None, iters: int = 24,
                    eps=1e-12, dtype=torch.float64, device=None):
    """Distance between convex sets A and B given their support maps, in a
    fixed number of steps with no branch on the data: each step takes the
    support point s of the Minkowski difference A ⊖ B opposite the iterate
    and moves to the least-norm point of the triangle of the iterate, s
    and the previous step's s. Returns ``(dist, x)``, ``x`` the witness
    difference vector (‖x‖ = dist). Overlapping sets give ~0 (no
    penetration depth). Without ``x_init`` the iterate starts at the
    support point in the direction (1, 1, 1) (of ``dtype`` on ``device``)."""

    def sup_diff(d):
        return support_a(d) - support_b(-d)

    if x_init is None:
        x_init = sup_diff(torch.ones(3, dtype=dtype, device=device))
    x, s_prev = x_init, x_init
    for _ in range(iters):
        s = sup_diff(-x)
        x, s_prev = _min_norm_triangle(x, s, s_prev, eps), s
    return torch.sqrt(dot(x, x) + eps), x


def capsule_box_distance(a: Tensor, b: Tensor, radius, center: Tensor, rot: Tensor,
                         half_extents: Tensor, iters: int = 24) -> Tensor:
    """Separation of the capsule [a, b] ⊕ ball(radius) and an oriented box."""
    d, _ = convex_distance(
        lambda dd: support_capsule(a, b, 0.0, dd),
        lambda dd: support_box(center, rot, half_extents, dd),
        x_init=0.5 * (a + b) - center, iters=iters)
    return d - radius


def hull_halfspace_distance(verts: Tensor, normal: Tensor, offset) -> Tensor:
    """Signed distance of the convex hull of ``verts (..., K, 3)`` to a plane:
    its closest vertex's."""
    return mv(verts, normal).amin(-1) - offset


# ---------------------------------------------------------------- residuals


def _frame(model, x: Tensor, frame_id: int):
    return rbd.frame_placement(model, x[..., :model.nq], frame_id)


@dataclass
class FrameHalfspaceResidual(StageFunction):
    """A sphere (``half_len = 0``) or a capsule with endpoints ``frame ⊕
    (offset ± half_len·axis)`` on a robot frame must stay on the positive
    side of the plane ``{x : n·x = plane_offset}`` by ``margin``: r(x) =
    margin − (dist(shape(q), plane) − radius)."""

    model: rbd.RobotModel
    normal: Tensor
    plane_offset: Tensor
    offset: Tensor
    radius: Tensor
    axis: Tensor
    half_len: Tensor
    margin: Tensor
    frame_id: int = 0

    def dim(self, space, nu):
        return 1

    def value(self, space, x, u):
        R, p = _frame(self.model, x, self.frame_id)
        c = p + mv(R, self.offset)
        a_w = mv(R, self.axis * self.half_len)
        d = segment_halfspace_distance(c - a_w, c + a_w, self.normal, self.plane_offset)
        return (self.margin - (d - self.radius))[..., None]


@dataclass
class FrameSphereResidual(StageFunction):
    """A sphere on a robot frame against a world sphere: r(x) = margin −
    (‖c(q) − c_obs‖ − r − r_obs)."""

    model: rbd.RobotModel
    center_obs: Tensor
    radius_obs: Tensor
    offset: Tensor
    radius: Tensor
    margin: Tensor
    frame_id: int = 0

    def dim(self, space, nu):
        return 1

    def value(self, space, x, u):
        R, p = _frame(self.model, x, self.frame_id)
        c = p + mv(R, self.offset)
        d = sphere_sphere_distance(c, self.radius, self.center_obs, self.radius_obs)
        return (self.margin - d)[..., None]


@dataclass
class FrameBoxResidual(StageFunction):
    """A sphere on a robot frame against an oriented world box: r(x) =
    margin − (sdf_box(c(q)) − r)."""

    model: rbd.RobotModel
    box_center: Tensor
    box_rot: Tensor
    half_extents: Tensor
    offset: Tensor
    radius: Tensor
    margin: Tensor
    frame_id: int = 0

    def dim(self, space, nu):
        return 1

    def value(self, space, x, u):
        R, p = _frame(self.model, x, self.frame_id)
        c = p + mv(R, self.offset)
        d = point_box_distance(c, self.box_center, self.box_rot, self.half_extents)
        return (self.margin - (d - self.radius))[..., None]


@dataclass
class FrameSphereSphereResidual(StageFunction):
    """Self-collision of spheres on two robot frames: r(x) = margin −
    (‖c₁(q) − c₂(q)‖ − r₁ − r₂)."""

    model: rbd.RobotModel
    offset1: Tensor
    radius1: Tensor
    offset2: Tensor
    radius2: Tensor
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
        d = sphere_sphere_distance(p1 + mv(R1, self.offset1), self.radius1,
                                   p2 + mv(R2, self.offset2), self.radius2)
        return (self.margin - d)[..., None]


@dataclass
class FrameConvexHullObstacleResidual(StageFunction):
    """The convex hull of points on a robot frame (``local_verts (K, 3)`` in
    the frame) against a world box (``obstacle_kind="box"``: rot,
    half-extents) or cylinder (``"cylinder"``: rot's z the axis,
    half-extents (radius, radius, half_len)), by :func:`convex_distance`:
    r(x) = margin − dist(hull(q), obstacle)."""

    model: rbd.RobotModel
    local_verts: Tensor
    obs_center: Tensor
    obs_rot: Tensor
    obs_half_extents: Tensor
    margin: Tensor
    frame_id: int = 0
    obstacle_kind: str = "box"
    iters: int = 24

    def dim(self, space, nu):
        return 1

    def value(self, space, x, u):
        R, p = _frame(self.model, x, self.frame_id)
        verts_w = p[..., None, :] + self.local_verts @ R.mT
        c, rot, h = self.obs_center, self.obs_rot, self.obs_half_extents
        if self.obstacle_kind == "box":
            def sup_obs(d):
                return support_box(c, rot, h, d)
        elif self.obstacle_kind == "cylinder":
            def sup_obs(d):
                return support_cylinder(c, rot, h[..., 0], h[..., 2], d)
        else:
            raise ValueError(f"unknown obstacle kind {self.obstacle_kind}")
        d, _ = convex_distance(lambda dd: support_hull(verts_w, dd), sup_obs,
                               x_init=verts_w.mean(-2) - c, iters=self.iters)
        return (self.margin - d)[..., None]


@dataclass
class FrameCapsuleBoxResidual(StageFunction):
    """A capsule on a robot frame (centre ``offset``, axis, half-length,
    radius) against an oriented world box: r = margin − separation."""

    model: rbd.RobotModel
    offset: Tensor
    axis: Tensor
    half_len: Tensor
    radius: Tensor
    box_center: Tensor
    box_rot: Tensor
    half_extents: Tensor
    margin: Tensor
    frame_id: int = 0
    iters: int = 24

    def dim(self, space, nu):
        return 1

    def value(self, space, x, u):
        R, p = _frame(self.model, x, self.frame_id)
        c = p + mv(R, self.offset)
        a_w = mv(R, self.axis * self.half_len)
        d = capsule_box_distance(c - a_w, c + a_w, self.radius, self.box_center,
                                 self.box_rot, self.half_extents, iters=self.iters)
        return (self.margin - d)[..., None]
