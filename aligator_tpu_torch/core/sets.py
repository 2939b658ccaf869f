"""Constraint sets and nonsmooth penalties.

PyTorch counterpart of ``aligator_tpu/core/sets.py``. The augmented
Lagrangian needs three elementwise operations per set:

  ``projection(z)``             — projection onto the set
  ``normal_cone_projection(z)`` — z minus its projection (the shifted-
                                  constraint image used for multipliers)
  ``active_mask(z)``            — rows where the normal-cone projection has a
                                  nonzero (0/1 diagonal) Jacobian; masks the
                                  constraint Jacobian rows of the LQ problem.

Bounds and prox parameters broadcast against ``z``: a per-scenario μ is
passed with trailing singleton dims.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import Tensor


class ConstraintSet:
    """Base class; defaults express a generic projection operator."""

    def evaluate(self, zproj: Tensor) -> Tensor:
        """Nonsmooth penalty value at the projected point (0 for indicators)."""
        return zproj.new_zeros(zproj.shape[:-1])

    def projection(self, z: Tensor) -> Tensor:
        raise NotImplementedError

    def normal_cone_projection(self, z: Tensor) -> Tensor:
        return z - self.projection(z)

    def active_mask(self, z: Tensor) -> Tensor:
        raise NotImplementedError

    def set_prox_parameter(self, mu) -> "ConstraintSet":
        """Copy parameterized by the prox scale μ (L1-type penalties)."""
        return self

    def moreau_envelope(self, z: Tensor, mu) -> Tensor:
        """Moreau envelope of the penalty at z with prox scale μ: penalty at
        the prox point plus the quadratic prox distance (for indicator sets,
        ``dist²(z, set)/(2μ)``)."""
        s = self.set_prox_parameter(mu)
        zprox = s.projection(z)
        zres = z - zprox
        return s.evaluate(zprox) + 0.5 / mu * (zres * zres).sum(-1)


@dataclass
class EqualityConstraint(ConstraintSet):
    """{0} singleton."""

    def projection(self, z):
        return torch.zeros_like(z)

    def normal_cone_projection(self, z):
        return z

    def active_mask(self, z):
        return torch.ones_like(z, dtype=torch.bool)


@dataclass
class NegativeOrthant(ConstraintSet):
    """h(x,u) ≤ 0."""

    def projection(self, z):
        return torch.clamp(z, max=0.0)

    def normal_cone_projection(self, z):
        return torch.clamp(z, min=0.0)

    def active_mask(self, z):
        return z > 0.0


@dataclass
class BoxConstraint(ConstraintSet):
    """lower ≤ z ≤ upper."""

    lower: Tensor
    upper: Tensor

    def projection(self, z):
        return torch.minimum(torch.maximum(z, self.lower), self.upper)

    def active_mask(self, z):
        return (z < self.lower) | (z > self.upper)


@dataclass
class L1Penalty(ConstraintSet):
    """Nonsmooth penalty λ‖z‖₁ through its prox: soft-thresholding with
    scale μ; the normal-cone projection is clip(z, −λμ, λμ)."""

    scale: float | Tensor = 1.0
    mu: float | Tensor = 0.01

    def evaluate(self, zproj):
        return self.scale * zproj.abs().sum(-1)

    def projection(self, z):
        thresh = self.scale * self.mu
        return torch.sign(z) * torch.clamp(z.abs() - thresh, min=0.0)

    def active_mask(self, z):
        return z.abs() > self.scale * self.mu

    def set_prox_parameter(self, mu):
        return dataclasses.replace(self, mu=mu)


@dataclass
class ConstraintSetProduct(ConstraintSet):
    """Cartesian product of sets over slices of the stacked residual."""

    sets: tuple = ()
    dims: tuple = ()

    def _map(self, z, op):
        if not self.sets:
            return z
        outs, i = [], 0
        for s, n in zip(self.sets, self.dims):
            outs.append(op(s, z[..., i:i + n]))
            i += n
        return torch.cat(outs, -1)

    def projection(self, z):
        return self._map(z, lambda s, zz: s.projection(zz))

    def normal_cone_projection(self, z):
        return self._map(z, lambda s, zz: s.normal_cone_projection(zz))

    def active_mask(self, z):
        if not self.sets:
            return torch.zeros_like(z, dtype=torch.bool)
        return self._map(z, lambda s, zz: s.active_mask(zz))

    def evaluate(self, zproj):
        val, i = zproj.new_zeros(zproj.shape[:-1]), 0
        for s, n in zip(self.sets, self.dims):
            val = val + s.evaluate(zproj[..., i:i + n])
            i += n
        return val

    def set_prox_parameter(self, mu):
        return dataclasses.replace(
            self, sets=tuple(s.set_prox_parameter(mu) for s in self.sets)
        )
