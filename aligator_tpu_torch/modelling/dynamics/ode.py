"""Continuous dynamics (ODEs) and the explicit and semi-implicit Euler
integrators.

PyTorch counterpart of ``ODE``, ``IntegratorEuler`` and
``IntegratorSemiImplEuler`` in ``aligator_tpu/modelling/dynamics/ode.py``.
An ODE provides ``xdot(space, x, u) ∈ T_x M`` in tangent coordinates; an
integrator is an :class:`~aligator_tpu_torch.core.dynamics.ExplicitDynamics`
that advances along the manifold with ``space.integrate``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from ...core.dynamics import ExplicitDynamics
from ...core.manifolds import Manifold, TangentBundle


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


@dataclass
class IntegratorSemiImplEuler(ExplicitDynamics):
    """Semi-implicit (symplectic) Euler on a tangent bundle (q, v):
    v⁺ = v + h·a(x, u); q⁺ = q ⊕ h·v⁺; the ODE's xdot is (v, a).

    When the ODE has ``acc_derivatives`` (the multibody contact dynamics),
    :meth:`jacobians` assembles (A, B, E) directly from the acceleration
    derivatives and the configuration space's chart Jacobians, as
    ``aligator_tpu/modelling/dynamics/ode.py:73-142`` does. E is not −I
    there: its configuration block is ``∂(q⁺ ⊖ y_q)/∂y_q``."""

    ode: ODE
    timestep: Tensor

    def forward(self, space, x, u):
        if not isinstance(space, TangentBundle):
            raise TypeError("semi-implicit Euler needs a TangentBundle state space")
        base = space.base
        acc = self.ode.xdot(space, x, u)[..., base.ndx:]
        v_next = x[..., base.nx:] + self.timestep * acc
        q_next = base.integrate(x[..., :base.nx], self.timestep * v_next)
        return torch.cat([q_next, v_next], -1)

    def jacobians(self, space, x, u, y):
        acc_fn = getattr(self.ode, "acc_derivatives", None)
        if acc_fn is None or not isinstance(space, TangentBundle):
            return ExplicitDynamics.jacobians(self, space, x, u, y)
        base = space.base
        nq, nv = base.nx, base.ndx
        h = self.timestep
        a, da_dq, da_dv, da_du = acc_fn(space, x, u)
        hv = h * (x[..., nq:] + h * a)
        q_x = x[..., :nq]
        q_next = base.integrate(q_x, hv)

        # chart Jacobians (tangent coordinates)
        J1 = base.jintegrate(q_x, hv, 0)  # ∂ξ_{q+}/∂dq_x
        J2 = base.jintegrate(q_x, hv, 1)  # ∂ξ_{q+}/∂(h v+)
        y_q = y[..., :nq]
        Jd0 = base.jdifference(y_q, q_next, 0)  # residual wrt dq_y
        Jd1 = base.jdifference(y_q, q_next, 1)  # residual wrt ξ_{q+}

        h2 = h * h
        eye = torch.eye(nv, dtype=x.dtype, device=x.device)
        Jd1J2 = Jd1 @ J2
        A = torch.cat([
            torch.cat([Jd1 @ J1 + h2 * (Jd1J2 @ da_dq),
                       Jd1J2 @ (h * eye + h2 * da_dv)], -1),
            torch.cat([h * da_dq, eye + h * da_dv], -1),
        ], -2)
        B = torch.cat([h2 * (Jd1J2 @ da_du), h * da_du], -2)
        zero = torch.zeros_like(Jd0)
        E = torch.cat([torch.cat([Jd0, zero], -1),
                       torch.cat([zero, -eye.expand(Jd0.shape)], -1)], -2)
        return A, B, E
