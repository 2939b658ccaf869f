"""Stage functions (residuals) with autodiff-default Jacobians.

PyTorch counterpart of ``aligator_tpu/core/functions.py``. A stage function
maps ``(x, u) → r ∈ R^nr``; inputs carry any leading (batch, stage) dims,
and Jacobians are taken in tangent coordinates of the state manifold.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from .manifolds import Manifold, batched_jacfwd


class StageFunction:
    """Residual r(x, u). Subclasses implement ``value`` and ``dim``;
    ``jacobians`` has an exact forward-mode autodiff default."""

    def dim(self, space: Manifold, nu: int) -> int:
        """Residual size nr."""
        raise NotImplementedError

    def value(self, space: Manifold, x: Tensor, u: Tensor) -> Tensor:
        raise NotImplementedError

    def jacobians(self, space: Manifold, x: Tensor, u: Tensor):
        """Returns (Jx, Ju) in tangent coordinates: ``(..., nr, ndx)`` and
        ``(..., nr, nu)``."""
        def f_dx(dx, x, u):
            return self.value(space, space.integrate(x, dx), u)

        def f_du(du, x, u):
            return self.value(space, x, u + du)

        Jx = batched_jacfwd(f_dx, space.ndx, x, u)
        Ju = batched_jacfwd(f_du, u.shape[-1], x, u)
        return Jx, Ju


@dataclass
class StateErrorResidual(StageFunction):
    """r(x) = x ⊖ target."""

    target: Tensor

    def dim(self, space, nu):
        return space.ndx

    def value(self, space, x, u):
        return space.difference(self.target, x)

    def jacobians(self, space, x, u):
        Jx = space.jdifference(self.target, x, 1)
        Ju = x.new_zeros(Jx.shape[:-1] + (u.shape[-1],))
        return Jx, Ju


@dataclass
class ControlErrorResidual(StageFunction):
    """r(u) = u − target."""

    target: Tensor

    def dim(self, space, nu):
        return self.target.shape[-1]

    def value(self, space, x, u):
        return u - self.target

    def jacobians(self, space, x, u):
        nu = u.shape[-1]
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        eye = torch.eye(nu, dtype=u.dtype, device=u.device)
        return u.new_zeros(lead + (nu, space.ndx)), eye.expand(lead + (nu, nu))
