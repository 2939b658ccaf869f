"""Continuous dynamics (ODEs) and their integrators.

PyTorch counterpart of ``aligator_tpu/modelling/dynamics/ode.py``: the DAE
surface ``ContinuousDynamics``, ``ODE`` and ``LinearODE``; the explicit
Euler, semi-implicit Euler, RK2 and RK4 integrators, and the implicit
midpoint rule. An ODE provides ``xdot(space, x, u) ∈ T_x M`` in tangent
coordinates; an explicit integrator is an
:class:`~aligator_tpu_torch.core.dynamics.ExplicitDynamics` that advances
along the manifold with ``space.integrate``; the midpoint rule is an
:class:`~aligator_tpu_torch.core.dynamics.ImplicitDynamics`, solved for the
next state by Newton steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from ..._linalg import mv
from ...core.dynamics import ExplicitDynamics, ImplicitDynamics
from ...core.manifolds import Manifold, TangentBundle, VectorSpace


class ContinuousDynamics:
    """Implicit continuous dynamics (DAE) ``r(x, u, ẋ) = 0``; an ODE is the
    case ``r = ẋ − f(x, u)``."""

    def residual(self, space: Manifold, x: Tensor, u: Tensor, xdot: Tensor):
        raise NotImplementedError


class ODE(ContinuousDynamics):
    """Continuous dynamics ẋ = f(x, u) in tangent coordinates."""

    def xdot(self, space: Manifold, x: Tensor, u: Tensor) -> Tensor:
        raise NotImplementedError

    def residual(self, space, x, u, xdot):
        return xdot - self.xdot(space, x, u)


@dataclass
class LinearODE(ODE):
    """ẋ = A x + B u + c on a vector space."""

    A: Tensor
    B: Tensor
    c: Tensor

    def xdot(self, space, x, u):
        return mv(self.A, x) + mv(self.B, u) + self.c


@dataclass
class IntegratorEuler(ExplicitDynamics):
    """x⁺ = x ⊕ (h·f(x, u))."""

    ode: ODE
    timestep: Tensor

    def forward(self, space, x, u):
        return space.integrate(x, self.timestep * self.ode.xdot(space, x, u))

    def jacobians(self, space, x, u, y):
        """On a vector space, from the ODE's closed-form ``xdot_jacobians``
        where it has them (the centroidal ODEs, whose stage parameters meet
        the ``(B, N)`` lead of the inputs): A = I + h ∂ẋ/∂x, B = h ∂ẋ/∂u,
        E = −I; else the generic forward-mode Jacobians."""
        jac = getattr(self.ode, "xdot_jacobians", None)
        if jac is None or not isinstance(space, VectorSpace):
            return ExplicitDynamics.jacobians(self, space, x, u, y)
        Jx, Ju = jac(space, x, u)
        h = self.timestep
        eye = torch.eye(space.ndx, dtype=x.dtype, device=x.device)
        return eye + h * Jx, h * Ju, (-eye).expand(Jx.shape)


@dataclass
class IntegratorSemiImplEuler(ExplicitDynamics):
    """Semi-implicit (symplectic) Euler on a tangent bundle (q, v):
    v⁺ = v + h·a(x, u); q⁺ = q ⊕ h·v⁺; the ODE's xdot is (v, a).

    ``forward`` takes the ODE's ``acceleration`` where it has one (the free
    multibody dynamics: a kernel on the card, values only). When the ODE
    has ``acc_derivatives`` (the multibody dynamics),
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
        accel = getattr(self.ode, "acceleration", None)
        acc = accel(space, x, u) if accel else self.ode.xdot(space, x, u)[..., base.ndx:]
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


@dataclass
class IntegratorRK2(ExplicitDynamics):
    """Explicit midpoint RK2: x₁ = x ⊕ (h/2·f(x, u)); x⁺ = x ⊕ (h·f(x₁, u))."""

    ode: ODE
    timestep: Tensor

    def forward(self, space, x, u):
        h = self.timestep
        x1 = space.integrate(x, 0.5 * h * self.ode.xdot(space, x, u))
        return space.integrate(x, h * self.ode.xdot(space, x1, u))


@dataclass
class IntegratorRK4(ExplicitDynamics):
    """Classic RK4 on the manifold, the tangent increments composed with ⊕."""

    ode: ODE
    timestep: Tensor

    def forward(self, space, x, u):
        h = self.timestep
        k1 = self.ode.xdot(space, x, u)
        k2 = self.ode.xdot(space, space.integrate(x, 0.5 * h * k1), u)
        k3 = self.ode.xdot(space, space.integrate(x, 0.5 * h * k2), u)
        k4 = self.ode.xdot(space, space.integrate(x, h * k3), u)
        return space.integrate(x, (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4))


@dataclass
class IntegratorMidpoint(ImplicitDynamics):
    """Implicit midpoint rule: r(x, u, y) = (y ⊖ x) − h·f(mid(x, y), u) = 0,
    solved for y by ``newton_iters`` Newton steps in ``forward``. Its
    Jacobian ``E = ∂r/∂y`` is not −I, so its LQ subproblems take the
    general-E branch of the Riccati solvers."""

    ode: ODE
    timestep: Tensor
    newton_iters: int = 5

    def residual(self, space, x, u, y):
        mid = space.interpolate(x, y, 0.5)
        return space.difference(x, y) - self.timestep * self.ode.xdot(space, mid, u)
