"""Centroidal residuals.

PyTorch counterpart of ``aligator_tpu/modelling/centroidal.py`` (the
reference's ``modelling/centroidal/`` residuals): CoM, linear and angular
momentum, centroidal and angular acceleration, friction cone, wrench cone,
and the wrapper that feeds the force tail of a continuous-centroidal state
to a residual written for forces as controls. State convention x = (c, h,
L, ...), u = stacked contact forces.

Stage-varying leaves (a :class:`~.dynamics.centroidal.ContactMap`'s
schedule, a cone's ``active`` gate, a reference) carry a leading stage
axis of size N and are listed in ``STAGE_PARAMS``. The Jacobians are in
closed form, each residual being linear or bilinear in (x, u), and keep the
``(B, N)`` lead of the inputs, so that a schedule meets its stages.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from ..core.functions import StageFunction, stage_param
from ..core.manifolds import VectorSpace
from .dynamics.centroidal import ContactMap, skew
from .spaces.se3 import cross


def _lead(x: Tensor, u: Tensor, *more: Tensor) -> tuple:
    return torch.broadcast_shapes(x.shape[:-1], u.shape[:-1], *more)


def _rows(x: Tensor, u: Tensor, nr: int, cols: slice, block: Tensor, on_u: bool,
          ndx: int):
    """``(Jx, Ju)`` zero but for ``block`` (..., nr, k) at ``cols`` of Jx (or
    of Ju with ``on_u``)."""
    lead = torch.broadcast_shapes(_lead(x, u), block.shape[:-2])
    Jx = x.new_zeros(lead + (nr, ndx))
    Ju = x.new_zeros(lead + (nr, u.shape[-1]))
    (Ju if on_u else Jx)[..., cols] = block
    return Jx, Ju


def _eye3(x: Tensor) -> Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


@dataclass
class _StateSliceResidual(StageFunction):
    """r(x) = x[k:k+3] − ref, ``ref`` ``(3,)`` or ``(N, 3)``."""

    START = 0

    def dim(self, space, nu):
        return 3

    def _ref(self) -> Tensor:
        raise NotImplementedError

    def value(self, space, x, u):
        k = self.START
        return x[..., k:k + 3] - stage_param(self._ref(), x, 1)

    def jacobians(self, space, x, u):
        k = self.START
        return _rows(x, u, 3, slice(k, k + 3), _eye3(x), False, space.ndx)


@dataclass
class CentroidalCoMResidual(_StateSliceResidual):
    """r(x) = c − c_ref."""

    c_ref: Tensor
    START = 0
    STAGE_PARAMS = {"c_ref": 1}

    def _ref(self):
        return self.c_ref


@dataclass
class LinearMomentumResidual(_StateSliceResidual):
    """r(x) = h − h_ref."""

    h_ref: Tensor
    START = 3
    STAGE_PARAMS = {"h_ref": 1}

    def _ref(self):
        return self.h_ref


@dataclass
class AngularMomentumResidual(_StateSliceResidual):
    """r(x) = L − L_ref."""

    L_ref: Tensor
    START = 6
    STAGE_PARAMS = {"L_ref": 1}

    def _ref(self):
        return self.L_ref


def _forces3(cmap: ContactMap, u: Tensor) -> Tensor:
    nk = cmap.n_contacts
    return u[..., :3 * nk].reshape(u.shape[:-1] + (nk, 3))


@dataclass
class CentroidalAccelerationResidual(StageFunction):
    """r(x, u) = ḣ/m − a_ref = g + (Σ act·fᵢ)/m − a_ref."""

    contact_map: ContactMap
    mass: Tensor
    gravity: Tensor
    a_ref: Tensor
    STAGE_PARAMS = {"a_ref": 1}

    def dim(self, space, nu):
        return 3

    def value(self, space, x, u):
        _, active = self.contact_map.at(x)
        f_tot = (active[..., None] * _forces3(self.contact_map, u)).sum(-2)
        return self.gravity + f_tot / self.mass - stage_param(self.a_ref, x, 1)

    def jacobians(self, space, x, u):
        _, active = self.contact_map.at(x)
        nk = self.contact_map.n_contacts
        lead = _lead(x, u, active.shape[:-1])
        # ∂/∂f_k = act_k I / m, stacked over the contacts
        blk = (active.expand(lead + (nk,))[..., None, :, None] * _eye3(x)[:, None, :]
               / self.mass).reshape(lead + (3, 3 * nk))
        return _rows(x, u, 3, slice(0, 3 * nk), blk, True, space.ndx)


@dataclass
class AngularAccelerationResidual(StageFunction):
    """r(x, u) = L̇ − ref = Σ act (pᵢ − c) × fᵢ − ref."""

    contact_map: ContactMap
    ref: Tensor
    STAGE_PARAMS = {"ref": 1}

    def dim(self, space, nu):
        return 3

    def value(self, space, x, u):
        points, active = self.contact_map.at(x)
        c = x[..., 0:3]
        f = _forces3(self.contact_map, u)
        tau = (active[..., None] * cross(points - c[..., None, :], f)).sum(-2)
        return tau - stage_param(self.ref, x, 1)

    def jacobians(self, space, x, u):
        points, active = self.contact_map.at(x)
        nk = self.contact_map.n_contacts
        c = x[..., 0:3]
        f = _forces3(self.contact_map, u)
        lead = _lead(x, u, active.shape[:-1], points.shape[:-2])
        act = active.expand(lead + (nk,))[..., None, None]
        Jx = x.new_zeros(lead + (3, space.ndx))
        Jx[..., 0:3] = (act * skew(f.expand(lead + (nk, 3)))).sum(-3)
        Ju = x.new_zeros(lead + (3, u.shape[-1]))
        r = (points - c[..., None, :]).expand(lead + (nk, 3))
        Ju[..., :3 * nk] = (act * skew(r)).movedim(-3, -2).reshape(lead + (3, 3 * nk))
        return Jx, Ju


@dataclass
class CentroidalFrictionConeResidual(StageFunction):
    """Linearized friction cone of contact ``contact_id``, r(u) ≤ 0 with
    r = (−fz + ε, fx − μ fz, −fx − μ fz, fy − μ fz, −fy − μ fz) (reference
    ``centroidal-friction-cone.hpp:22``). ``active`` (a scalar or ``(N,)``
    leaf) gates the rows: an inactive contact's rows are 0, trivially
    feasible."""

    mu: Tensor
    eps: Tensor
    active: Tensor | float = 1.0
    contact_id: int = 0
    STAGE_PARAMS = {"active": 0}

    def dim(self, space, nu):
        return 5

    def _gate(self, x):
        a = torch.as_tensor(self.active, dtype=x.dtype, device=x.device)
        return stage_param(a, x, 0)[..., None]

    def _matrix(self, x):
        """The rows' coefficients of (fx, fy, fz), (5, 3)."""
        mu = torch.as_tensor(self.mu, dtype=x.dtype, device=x.device)
        one, zero = torch.ones_like(mu), torch.zeros_like(mu)
        return torch.stack([torch.stack([zero, zero, -one]), torch.stack([one, zero, -mu]),
                            torch.stack([-one, zero, -mu]), torch.stack([zero, one, -mu]),
                            torch.stack([zero, -one, -mu])])

    def value(self, space, x, u):
        k = 3 * self.contact_id
        r = (self._matrix(x) * u[..., None, k:k + 3]).sum(-1)
        r = r + torch.cat([torch.as_tensor(self.eps, dtype=x.dtype, device=x.device)[None],
                           x.new_zeros(4)])
        return self._gate(x) * r

    def jacobians(self, space, x, u):
        k = 3 * self.contact_id
        blk = self._gate(x)[..., None] * self._matrix(x)
        return _rows(x, u, 5, slice(k, k + 3), blk, True, space.ndx)


@dataclass
class CentroidalWrenchConeResidual(StageFunction):
    """Contact wrench cone of a rectangular foot (half-lengths X, Y):
    friction pyramid and CoP-in-support rows on the wrench (f, τ) of
    contact ``contact_id`` (reference ``centroidal-wrench-cone.hpp:23``)."""

    mu: Tensor
    half_length_x: Tensor
    half_length_y: Tensor
    contact_id: int = 0

    def dim(self, space, nu):
        return 9

    def _matrix(self, x):
        """The rows' coefficients of (fx, fy, fz, τx, τy, τz), (9, 6)."""
        def t(a):
            return torch.as_tensor(a, dtype=x.dtype, device=x.device)

        mu, X, Y = t(self.mu), t(self.half_length_x), t(self.half_length_y)
        one, zero = torch.ones_like(mu), torch.zeros_like(mu)
        rows = [(zero, zero, -one, zero, zero), (one, zero, -mu, zero, zero),
                (-one, zero, -mu, zero, zero), (zero, one, -mu, zero, zero),
                (zero, -one, -mu, zero, zero), (zero, zero, -X, zero, one),
                (zero, zero, -X, zero, -one), (zero, zero, -Y, one, zero),
                (zero, zero, -Y, -one, zero)]
        return torch.stack([torch.stack(list(r) + [zero]) for r in rows])

    def value(self, space, x, u):
        k = 6 * self.contact_id
        return (self._matrix(x) * u[..., None, k:k + 6]).sum(-1)

    def jacobians(self, space, x, u):
        k = 6 * self.contact_id
        return _rows(x, u, 9, slice(k, k + 6), self._matrix(x), True, space.ndx)


@dataclass
class CentroidalWrapperResidual(StageFunction):
    """A centroidal residual on the force-in-state formulation of
    ``ContinuousCentroidalFwdDynamics`` (reference
    ``centroidal-wrapper.hpp:10-29``): the state x = (c, h, L, forces) is
    split at ``x_dim`` and the force tail fed to ``inner`` as its control."""

    inner: StageFunction
    x_dim: int = 9

    def dim(self, space, nu):
        return self.inner.dim(space, nu)

    def value(self, space, x, u):
        return self.inner.value(VectorSpace(self.x_dim), x[..., :self.x_dim],
                                x[..., self.x_dim:])

    def jacobians(self, space, x, u):
        Jx_in, Ju_in = self.inner.jacobians(VectorSpace(self.x_dim), x[..., :self.x_dim],
                                            x[..., self.x_dim:])
        lead = torch.broadcast_shapes(Jx_in.shape[:-2], u.shape[:-1])
        Jx = torch.cat([Jx_in.expand(lead + Jx_in.shape[-2:]),
                        Ju_in.expand(lead + Ju_in.shape[-2:])], -1)
        return Jx, x.new_zeros(lead + (Jx.shape[-2], u.shape[-1]))
