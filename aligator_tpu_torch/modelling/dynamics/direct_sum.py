"""Direct sum of explicit dynamics.

PyTorch counterpart of ``aligator_tpu/modelling/dynamics/direct_sum.py``
(reference ``modelling/explicit-dynamics-direct-sum.hpp``): two dynamics on
the Cartesian product of their state spaces, the control split between
them. Its Jacobians are the generic forward-mode ones of
:class:`~...core.dynamics.ExplicitDynamics`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core.dynamics import ExplicitDynamics
from ...core.manifolds import CartesianProduct, Manifold


@dataclass
class DirectSumDynamics(ExplicitDynamics):
    """(x_f, x_g)⁺ = (f(x_f, u_f), g(x_g, u_g))."""

    f: ExplicitDynamics
    g: ExplicitDynamics
    space_f: Manifold = None
    space_g: Manifold = None
    nu_f: int = 0
    nu_g: int = 0

    def forward(self, space, x, u):
        nf = self.space_f.nx
        yf = self.f.forward(self.space_f, x[..., :nf], u[..., :self.nu_f])
        yg = self.g.forward(self.space_g, x[..., nf:], u[..., self.nu_f:])
        lead = torch.broadcast_shapes(yf.shape[:-1], yg.shape[:-1])
        return torch.cat([yf.expand(lead + yf.shape[-1:]), yg.expand(lead + yg.shape[-1:])],
                         -1)


def direct_sum(f, space_f, nu_f, g, space_g, nu_g):
    """``(dynamics, space, nu)`` of the direct sum of ``f`` on ``space_f``
    with ``nu_f`` controls and ``g`` on ``space_g`` with ``nu_g``."""
    return (DirectSumDynamics(f=f, g=g, space_f=space_f, space_g=space_g, nu_f=nu_f,
                              nu_g=nu_g),
            CartesianProduct(space_f, space_g), nu_f + nu_g)
