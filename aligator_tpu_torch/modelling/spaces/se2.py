"""SO(2) and SE(2) Lie groups.

PyTorch counterpart of ``aligator_tpu/modelling/spaces/se2.py``.
Representations follow pinocchio:

  SO(2): x = (cosθ, sinθ), tangent = ω
  SE(2): x = (px, py, cosθ, sinθ), tangent = (vx, vy, ω), a *body* twist;
  integrate is the right-translated exp map p⁺ = p + R(θ)·V(ω)·v, θ⁺ = θ + ω.

The ratios sinω/ω and (1 − cosω)/ω use Taylor-guarded forms, so the maps
and their forward-mode derivatives are finite at ω = 0. Components are
taken as slices with a trailing dim of 1, never as 0-dim tensors: under
``torch.func.jacfwd``, arithmetic between a 0-dim float32 tensor and a
Python float yields a float64 tangent, which would promote the Jacobians.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ...core.manifolds import Manifold

_EPS = 1e-6


def _sinc(w: Tensor) -> Tensor:
    """sin(w)/w, smooth at 0."""
    small = w.abs() < _EPS
    safe = torch.where(small, torch.ones_like(w), w)
    return torch.where(small, 1.0 - w * w / 6.0, torch.sin(safe) / safe)


def _cosc(w: Tensor) -> Tensor:
    """(1 - cos(w))/w, smooth at 0."""
    small = w.abs() < _EPS
    safe = torch.where(small, torch.ones_like(w), w)
    return torch.where(
        small, w / 2.0 - w * (w * w) / 24.0, (1.0 - torch.cos(safe)) / safe
    )


class SO2(Manifold):
    """Unit circle; x = (cosθ, sinθ)."""

    nx = 2
    ndx = 1

    def neutral(self, dtype=None, device=None):
        return torch.tensor([1.0, 0.0], dtype=dtype, device=device)

    def integrate(self, x, v):
        c, s = x[..., 0:1], x[..., 1:2]
        cw, sw = torch.cos(v), torch.sin(v)
        return torch.cat([c * cw - s * sw, s * cw + c * sw], -1)

    def difference(self, x0, x1):
        c0, s0 = x0[..., 0:1], x0[..., 1:2]
        c1, s1 = x1[..., 0:1], x1[..., 1:2]
        # angle of R0^T R1
        return torch.atan2(s1 * c0 - c1 * s0, c1 * c0 + s1 * s0)

    def __eq__(self, other):
        return type(other) is SO2

    def __hash__(self):
        return hash("SO2")


class SE2(Manifold):
    """Planar rigid transformations; x = (px, py, cosθ, sinθ)."""

    nx = 4
    ndx = 3

    def neutral(self, dtype=None, device=None):
        return torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=dtype, device=device)

    def integrate(self, x, v):
        c, s = x[..., 2:3], x[..., 3:4]
        vx, vy, w = v[..., 0:1], v[..., 1:2], v[..., 2:3]
        a = _sinc(w)
        b = _cosc(w)
        # exp-map translation in the body frame: V(w) @ (vx, vy)
        tx = a * vx - b * vy
        ty = b * vx + a * vy
        # rotate into the world frame and translate
        px = x[..., 0:1] + c * tx - s * ty
        py = x[..., 1:2] + s * tx + c * ty
        cw, sw = torch.cos(w), torch.sin(w)
        return torch.cat([px, py, c * cw - s * sw, s * cw + c * sw], -1)

    def difference(self, x0, x1):
        # relative transform m = x0^{-1} x1, then log(m)
        c0, s0 = x0[..., 2:3], x0[..., 3:4]
        dpx = x1[..., 0:1] - x0[..., 0:1]
        dpy = x1[..., 1:2] - x0[..., 1:2]
        rx = c0 * dpx + s0 * dpy
        ry = -s0 * dpx + c0 * dpy
        c1, s1 = x1[..., 2:3], x1[..., 3:4]
        w = torch.atan2(s1 * c0 - c1 * s0, c1 * c0 + s1 * s0)
        a = _sinc(w)
        b = _cosc(w)
        den = a * a + b * b
        # V(w)^{-1} @ (rx, ry)
        vx = (a * rx + b * ry) / den
        vy = (-b * rx + a * ry) / den
        return torch.cat([vx, vy, w], -1)

    def __eq__(self, other):
        return type(other) is SE2

    def __hash__(self):
        return hash("SE2")
