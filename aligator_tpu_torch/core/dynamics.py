"""Discrete dynamics interface.

PyTorch counterpart of ``aligator_tpu/core/dynamics.py``. An explicit
dynamics is a map ``xnext = forward(x, u)``; the implicit residual used by
the solvers is ``value(x, u, y) = y ⊖ forward(x, u)`` with tangent-space
Jacobians ``A = ∂value/∂x``, ``B = ∂value/∂u``, ``E = ∂value/∂y``
(``E = −I`` on vector spaces).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from .._linalg import mv
from .manifolds import Manifold, batched_jacfwd


class ExplicitDynamics:
    """Explicit discrete dynamics x_{t+1} = forward(x_t, u_t)."""

    is_explicit = True

    def forward(self, space: Manifold, x: Tensor, u: Tensor) -> Tensor:
        raise NotImplementedError

    def residual(self, space, x, u, y):
        """Implicit residual value(x, u, y) = difference(y, forward(x, u))."""
        return space.difference(y, self.forward(space, x, u))

    def jacobians(self, space, x, u, y):
        """Tangent-space Jacobians (A, B, E) of the residual, exact
        forward-mode autodiff per sample."""
        def f_dx(dx, x, u, y):
            return self.residual(space, space.integrate(x, dx), u, y)

        def f_du(du, x, u, y):
            return self.residual(space, x, u + du, y)

        def f_dy(dy, x, u, y):
            return self.residual(space, x, u, space.integrate(y, dy))

        A = batched_jacfwd(f_dx, space.ndx, x, u, y)
        B = batched_jacfwd(f_du, u.shape[-1], x, u, y)
        E = batched_jacfwd(f_dy, space.ndx, x, u, y)
        return A, B, E


@dataclass
class LinearDiscreteDynamics(ExplicitDynamics):
    """x' = A x + B u + c on a vector space."""

    A: Tensor
    B: Tensor
    c: Tensor

    def forward(self, space, x, u):
        return mv(self.A, x) + mv(self.B, u) + self.c

    def jacobians(self, space, x, u, y):
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1], y.shape[:-1])
        n = self.A.shape[-1]
        E = -torch.eye(n, dtype=x.dtype, device=x.device)
        return (
            self.A.expand(lead + self.A.shape[-2:]),
            self.B.expand(lead + self.B.shape[-2:]),
            E.expand(lead + (n, n)),
        )
