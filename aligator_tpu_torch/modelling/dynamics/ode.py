"""Continuous dynamics (ODEs) and the explicit Euler integrator.

PyTorch counterpart of ``ODE`` and ``IntegratorEuler`` in
``aligator_tpu/modelling/dynamics/ode.py``. An ODE provides
``xdot(space, x, u) ∈ T_x M`` in tangent coordinates; an integrator is an
:class:`~aligator_tpu_torch.core.dynamics.ExplicitDynamics` that advances
along the manifold with ``space.integrate``.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import Tensor

from ...core.dynamics import ExplicitDynamics
from ...core.manifolds import Manifold


class ODE:
    """Continuous dynamics ẋ = f(x, u) in tangent coordinates."""

    def xdot(self, space: Manifold, x: Tensor, u: Tensor) -> Tensor:
        raise NotImplementedError

    def residual(self, space, x, u, xdot):
        return xdot - self.xdot(space, x, u)


@dataclass
class IntegratorEuler(ExplicitDynamics):
    """x⁺ = x ⊕ (h·f(x, u))."""

    ode: ODE
    timestep: Tensor

    def forward(self, space, x, u):
        return space.integrate(x, self.timestep * self.ode.xdot(space, x, u))
