"""Centroidal dynamics.

PyTorch counterpart of ``aligator_tpu/modelling/dynamics/centroidal.py``:
state x = (c, h, L) ∈ R⁹ (CoM position, linear momentum, angular momentum),
control u = stacked 3D contact forces at known contact points:

  ċ = h / m
  ḣ = m·g + Σᵢ fᵢ
  L̇ = Σᵢ (pᵢ − c) × fᵢ

A :class:`ContactMap`'s ``active`` ``(nk,)`` and ``points`` ``(nk, 3)`` may
carry a leading stage axis, ``(N, nk)`` and ``(N, nk, 3)``: a contact
schedule as stage parameters of one stage model (listed in
``STAGE_PARAMS``, read through :func:`~...core.functions.stage_param`; the
rollouts take one stage's row with :func:`~...core.dynamics.dynamics_at`),
where the JAX package stacks one model a stage. Each ODE gives its
Jacobians in closed form (:meth:`xdot_jacobians`, the functions being
linear or bilinear in (x, u)), which keep the ``(B, N)`` lead of the
inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from ...core.functions import stage_param
from ..spaces.se3 import cross
from .ode import ODE


def skew(a: Tensor) -> Tensor:
    """The cross-product matrix (..., 3, 3) of a (..., 3): skew(a) b = a × b."""
    z = torch.zeros_like(a[..., 0])
    x, y, w = a.unbind(-1)
    return torch.stack([torch.stack([z, -w, y], -1), torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


@dataclass
class ContactMap:
    """Contact points (world positions) and their 0/1 activity flags."""

    points: Tensor  # (nk, 3) or (N, nk, 3)
    active: Tensor  # (nk,) or (N, nk)

    STAGE_PARAMS = {"points": 2, "active": 1}

    @property
    def n_contacts(self) -> int:
        return self.points.shape[-2]

    def at(self, x: Tensor):
        """``(points, active)`` checked against the input ``x``."""
        return stage_param(self.points, x, 2), stage_param(self.active, x, 1)


def _momentum_rates(cmap: ContactMap, mass, gravity, x, forces):
    """ḣ and L̇ at the state ``x`` (its CoM c = x[:3]) from per-contact
    forces ``(..., nk, fs)`` (fs 3 or 6; the trailing 3 of a 6D entry are
    contact torques added to L̇)."""
    points, active = cmap.at(x)
    c = x[..., 0:3]
    act = active[..., None]
    f3 = forces[..., :3]
    f_tot = (act * f3).sum(-2)
    tau = (act * cross(points - c[..., None, :], f3)).sum(-2)
    if forces.shape[-1] == 6:
        tau = tau + (act * forces[..., 3:6]).sum(-2)
    return mass * gravity + f_tot, tau


def _rates_jacobians(cmap: ContactMap, x, forces, fs):
    """∂(ḣ, L̇)/∂c (..., 6, 3) and ∂(ḣ, L̇)/∂forces (..., 6, nk·fs)."""
    points, active = cmap.at(x)
    c = x[..., 0:3]
    lead = torch.broadcast_shapes(c.shape[:-1], active.shape[:-1], forces.shape[:-2])
    nk = forces.shape[-2]
    act = active.expand(lead + (nk,))[..., None, None]  # (..., nk, 1, 1)
    f3 = forces[..., :3].expand(lead + (nk, 3))
    r = (points - c[..., None, :]).expand(lead + (nk, 3))
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    # L̇ = Σ act (p − c) × f: ∂/∂c = Σ act skew(f), ∂/∂f_k = act skew(p_k − c)
    dL_dc = (act * skew(f3)).sum(-3)
    dh_df = (act * eye).movedim(-3, -2)  # (..., 3, nk, 3)
    dL_df = (act * skew(r)).movedim(-3, -2)
    if fs == 6:  # (f, τ) a contact: ∂ḣ/∂τ = 0, ∂L̇/∂τ = act·I
        dh_df, dL_df = torch.cat([dh_df, torch.zeros_like(dh_df)], -1), \
            torch.cat([dL_df, dh_df], -1)
    d_df = torch.cat([dh_df, dL_df], -3).reshape(lead + (6, nk * fs))
    d_dc = torch.cat([c.new_zeros(lead + (3, 3)), dL_dc], -2)
    return d_dc, d_df


@dataclass
class CentroidalFwdDynamics(ODE):
    """Counterpart of ``CentroidalFwdDynamicsTpl`` (reference
    ``modelling/dynamics/centroidal-fwd.hpp:24``): x = (c, h, L), u the
    stacked contact forces (``force_size`` 3 or 6 a contact)."""

    contact_map: ContactMap
    mass: Tensor
    gravity: Tensor  # (3,)
    force_size: int = 3

    def _forces(self, u):
        return u.reshape(u.shape[:-1] + (-1, self.force_size))

    def xdot(self, space, x, u):
        h = x[..., 3:6]
        hdot, Ldot = _momentum_rates(self.contact_map, self.mass, self.gravity, x,
                                     self._forces(u))
        return torch.cat([(h / self.mass).expand(hdot.shape), hdot, Ldot], -1)

    def xdot_jacobians(self, space, x, u):
        """``(∂ẋ/∂x (..., 9, 9), ∂ẋ/∂u (..., 9, nu))``."""
        d_dc, d_du = _rates_jacobians(self.contact_map, x, self._forces(u), self.force_size)
        lead = d_dc.shape[:-2]
        Jx = x.new_zeros(lead + (9, 9))
        Jx[..., 0:3, 3:6] = torch.eye(3, dtype=x.dtype, device=x.device) / self.mass
        Jx[..., 3:9, 0:3] = d_dc
        Ju = torch.cat([x.new_zeros(lead + (3, u.shape[-1])), d_du], -2)
        return Jx, Ju


@dataclass
class ContinuousCentroidalFwdDynamics(ODE):
    """Centroidal dynamics with the contact forces in the state and the
    control their rates (reference
    ``modelling/dynamics/continuous-centroidal-fwd.hpp:25``): x = (c, h, L,
    f₁ … f_nk) ∈ R^{9 + nk·fs}, u = ḟ; ċ = h/m, ḣ = m·g + Σ fᵢ, L̇ = Σ (pᵢ −
    c) × fᵢ [+ τᵢ], ḟ = u."""

    contact_map: ContactMap
    mass: Tensor
    gravity: Tensor  # (3,)
    force_size: int = 3

    def xdot(self, space, x, u):
        h = x[..., 3:6]
        forces = x[..., 9:].reshape(x.shape[:-1] + (-1, self.force_size))
        hdot, Ldot = _momentum_rates(self.contact_map, self.mass, self.gravity, x, forces)
        lead = hdot.shape[:-1]
        return torch.cat([(h / self.mass).expand(lead + (3,)), hdot, Ldot,
                          u.expand(lead + u.shape[-1:])], -1)

    def xdot_jacobians(self, space, x, u):
        forces = x[..., 9:].reshape(x.shape[:-1] + (-1, self.force_size))
        d_dc, d_df = _rates_jacobians(self.contact_map, x, forces, self.force_size)
        lead, nx, nu = d_dc.shape[:-2], x.shape[-1], u.shape[-1]
        Jx = x.new_zeros(lead + (nx, nx))
        Jx[..., 0:3, 3:6] = torch.eye(3, dtype=x.dtype, device=x.device) / self.mass
        Jx[..., 3:9, 0:3] = d_dc
        Jx[..., 3:9, 9:] = d_df
        Ju = x.new_zeros(lead + (nx, nu))
        Ju[..., 9:, :] = torch.eye(nu, dtype=x.dtype, device=x.device)
        return Jx, Ju


@dataclass
class KinodynamicsFwdDynamics(ODE):
    """Counterpart of ``KinodynamicsFwdDynamicsTpl`` (reference
    ``modelling/dynamics/kinodynamics-fwd.hpp:32``): x = (c, h, L, q_j, v_j)
    on R⁹ × R^{nj} × R^{nj}, u = (contact forces, joint accelerations).
    ``n_joints`` is metadata, not a tensor leaf."""

    contact_map: ContactMap
    mass: Tensor
    gravity: Tensor
    n_joints: int = 0

    def xdot(self, space, x, u):
        nj, nf = self.n_joints, 3 * self.contact_map.n_contacts
        h = x[..., 3:6]
        vj = x[..., 9 + nj:9 + 2 * nj]
        forces = u[..., :nf].reshape(u.shape[:-1] + (-1, 3))
        hdot, Ldot = _momentum_rates(self.contact_map, self.mass, self.gravity, x, forces)
        lead = hdot.shape[:-1]
        return torch.cat([(h / self.mass).expand(lead + (3,)), hdot, Ldot,
                          vj.expand(lead + (nj,)), u[..., nf:].expand(lead + (nj,))], -1)

    def xdot_jacobians(self, space, x, u):
        nj, nf = self.n_joints, 3 * self.contact_map.n_contacts
        forces = u[..., :nf].reshape(u.shape[:-1] + (-1, 3))
        d_dc, d_df = _rates_jacobians(self.contact_map, x, forces, 3)
        lead, nx, nu = d_dc.shape[:-2], x.shape[-1], u.shape[-1]
        eye = torch.eye(max(3, nj), dtype=x.dtype, device=x.device)
        Jx = x.new_zeros(lead + (nx, nx))
        Jx[..., 0:3, 3:6] = eye[:3, :3] / self.mass
        Jx[..., 3:9, 0:3] = d_dc
        Jx[..., 9:9 + nj, 9 + nj:] = eye[:nj, :nj]
        Ju = x.new_zeros(lead + (nx, nu))
        Ju[..., 3:9, :nf] = d_df
        Ju[..., 9 + nj:, nf:] = eye[:nj, :nj]
        return Jx, Ju


@dataclass
class WheeledInvertedPendulumDynamics(ODE):
    """Counterpart of ``modelling/dynamics/wheeled-inverted-pendulum.hpp:8``:
    planar segway, state (x, θ, ẋ, θ̇) with θ = 0 upright, control the wheel
    torque. Its Jacobians are the integrators' forward-mode ones."""

    mass_cart: Tensor
    mass_pole: Tensor
    length: Tensor
    wheel_radius: Tensor
    gravity: Tensor

    def xdot(self, space, x, u):
        th, xd, thd = x[..., 1], x[..., 2], x[..., 3]
        f = u[..., 0] / self.wheel_radius
        s, c = torch.sin(th), torch.cos(th)
        mt = self.mass_cart + self.mass_pole
        mp, l, g = self.mass_pole, self.length, self.gravity
        denom = mt - mp * c * c
        xdd = (f + mp * s * (l * thd ** 2 - g * c)) / denom
        thdd = (-f * c - mp * l * thd ** 2 * c * s + mt * g * s) / (l * denom)
        return torch.stack([xd, thd, xdd, thdd], -1)
