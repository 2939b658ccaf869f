"""Continuous linear ODE integrated by explicit Euler.

Port of ``examples/linear_euler.py``: the unstable 2-state system
ẋ = A x + B u (``LinearODE``, A = [[1, −0.2], [10, 1]], B = I) driven to the
origin from x0 = (1, −0.5) through ``IntegratorEuler`` (dt = 0.001, N =
20), stage cost ``½·dt (0.1 x'x + 0.001 u'u)``, terminal cost ``½·0.1 x'x``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorEuler, LinearODE


def linear_euler_problem(A: Tensor, B: Tensor, c: Tensor, w_x: Tensor,
                         w_u: Tensor, timestep: Tensor, x0: Tensor,
                         nsteps: int) -> core.TrajOptProblem:
    """Build the problem from its leaves; ``x0`` is ``(B, nx)`` or ``(nx,)``."""
    nx, nu = B.shape
    space = core.VectorSpace(nx)
    dyn = IntegratorEuler(ode=LinearODE(A=A, B=B, c=c), timestep=timestep)
    rcost = core.QuadraticCost.create(w_x * timestep, w_u * timestep)
    term_cost = core.QuadraticCost.create(w_x, w_u.new_zeros((nu, nu)))
    stage = core.make_stage(rcost, dyn, space, nu)
    return core.make_problem(x0, stage, nsteps, term_cost)


def create_linear_euler_problem(nsteps: int = 20, timestep: float = 0.001,
                                dtype=torch.float64, device="cuda"):
    """The published problem with one scenario."""
    dev = resolve(device)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    eye = torch.eye(2, dtype=dtype, device=dev)
    return linear_euler_problem(t([[1.0, -0.2], [10.0, 1.0]]), eye, t([0.0, 0.0]),
                                0.1 * eye, 1e-3 * eye, t(timestep), t([1.0, -0.5]),
                                nsteps)
