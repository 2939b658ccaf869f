"""Free (unconstrained) multibody forward dynamics.

PyTorch counterpart of ``aligator_tpu/modelling/dynamics/multibody_free.py``:
the phase-space ODE ``(q̇, v̇) = (v, FD(q, v, τ))`` with the forward dynamics
of :func:`~..multibody.model.aba`. The free and flexible ODEs give their
acceleration derivatives analytically (``acc_derivatives``, the protocol
that :class:`~.ode.IntegratorSemiImplEuler` assembles (A, B, E) from); the
other integrators differentiate ``xdot`` by autograd. The free and
flexible ODEs' ``acceleration`` (semi-implicit Euler's forward step) runs
the free-dynamics kernel on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from ..._linalg import mv
from ..multibody import free_fd
from ..multibody import model as rbd
from ..multibody.derivatives import aba_derivatives
from .ode import ODE


def _split(model, x):
    nq = model.nq
    return x[..., :nq], x[..., nq:]


@dataclass
class MultibodyFreeFwdDynamics(ODE):
    """v̇ = FD(q, v, B·u) with the actuation matrix ``actuation`` (nv, nu)."""

    model: rbd.RobotModel
    actuation: Tensor  # (nv, nu)

    def xdot(self, space, x, u):
        q, v = _split(self.model, x)
        return torch.cat([v, rbd.aba(self.model, q, v, mv(self.actuation, u))], -1)

    def acceleration(self, space, x, u):
        """The acceleration alone, for a rollout (values only, no
        derivatives): the free-dynamics kernel on the card
        (:func:`..multibody.free_fd.free_fd`), :func:`..multibody.model.aba`
        on the CPU."""
        q, v = _split(self.model, x)
        return free_fd.free_fd(self.model, q, v, mv(self.actuation, u))

    def acc_derivatives(self, space, x, u):
        """Analytic ``(a, ∂a/∂dq, ∂a/∂dv, ∂a/∂u)`` in tangent coordinates."""
        q, v = _split(self.model, x)
        a, da_dq, da_dv, solve_M = aba_derivatives(self.model, q, v, mv(self.actuation, u))
        return a, da_dq, da_dv, solve_M(self.actuation)


@dataclass
class MultibodyGravityCompensatedDynamics(ODE):
    """Gravity-compensated variant: v̇ = FD(q, v, g(q) + B·u)."""

    model: rbd.RobotModel
    actuation: Tensor

    def xdot(self, space, x, u):
        q, v = _split(self.model, x)
        zero = torch.zeros_like(v)
        tau = rbd.rnea(self.model, q, zero, zero) + mv(self.actuation, u)
        return torch.cat([v, rbd.aba(self.model, q, v, tau)], -1)


@dataclass
class MultibodyFlexibleFwdDynamics(ODE):
    """Passive joint elasticity: v̇ = FD(q, v, B·u − K(q − q_rest) − D·v),
    K and D diagonal over the tangent space. Needs a fixed-base model with
    nq == nv (revolute and prismatic joints only)."""

    model: rbd.RobotModel
    actuation: Tensor  # (nv, nu)
    stiffness: Tensor  # (nv,)
    damping: Tensor  # (nv,)
    q_rest: Tensor  # (nq,)

    def __post_init__(self):
        if self.model.nq != self.model.nv:
            raise ValueError("flexible dynamics needs nq == nv (no free-flyer)")

    def _tau(self, q, v, u):
        return (mv(self.actuation, u) - self.stiffness * (q - self.q_rest)
                - self.damping * v)

    def xdot(self, space, x, u):
        q, v = _split(self.model, x)
        return torch.cat([v, rbd.aba(self.model, q, v, self._tau(q, v, u))], -1)

    def acceleration(self, space, x, u):
        """The acceleration alone, for a rollout: the free-dynamics kernel
        on the card under the spring-damper torque, as
        :meth:`MultibodyFreeFwdDynamics.acceleration`."""
        q, v = _split(self.model, x)
        return free_fd.free_fd(self.model, q, v, self._tau(q, v, u))

    def acc_derivatives(self, space, x, u):
        """Analytic acceleration derivatives; the spring-damper torque adds
        −M⁻¹K and −M⁻¹D through the τ channel (nq == nv, so the q tangent
        coordinates are q's)."""
        q, v = _split(self.model, x)
        a, da_dq, da_dv, solve_M = aba_derivatives(self.model, q, v, self._tau(q, v, u))
        nv = self.model.nv
        KDB = torch.cat([-torch.diag(self.stiffness), -torch.diag(self.damping),
                         self.actuation], -1)
        Minv = solve_M(KDB.to(q.dtype))
        return a, da_dq + Minv[..., :nv], da_dv + Minv[..., nv:2 * nv], Minv[..., 2 * nv:]
