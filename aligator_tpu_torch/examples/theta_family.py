"""A parametric problem family for the θ sensitivities.

The family of the JAX package's ``tests/test_sensitivity.py``: a double
integrator (dt = 0.1) from x0 = (1, 0) over N = 20 steps, stage cost
``½·0.01 (x'x + u'u)``, and θ ∈ R² the target of the terminal cost
``½‖x − θ‖²_{10 I}``; optionally the control box |u| <= u_bound. Solve it
with ``ProxDDPConfig(tol=1e-11, mu_init=1e-4, max_iters=40)`` and harvest
dV/dθ, d²V/dθ² with :func:`~..solvers.sensitivity.solve_with_sensitivities`.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .. import core
from .._device import resolve

SOLVE_OPTIONS = dict(tol=1e-11, mu_init=1e-4, max_iters=40)


def double_integrator_family(A: Tensor, B: Tensor, Q: Tensor, R: Tensor,
                             w_term: Tensor, x0: Tensor, nsteps: int,
                             u_bound=None):
    """``problem_of_theta``: θ ``(B, nx)`` ↦ the B problems with dynamics
    ``x' = A x + B u``, stage cost ``½x'Qx + ½u'Ru``, terminal cost
    ``½‖x − θ‖²_{w_term}``, initial state ``x0 (nx,)``; ``u_bound`` adds
    |u| <= u_bound."""
    nx, nu = B.shape
    space = core.VectorSpace(nx)
    dyn = core.LinearDiscreteDynamics(A=A, B=B, c=A.new_zeros(nx))
    cost = core.QuadraticCost.create(Q, R)
    constraints = ()
    if u_bound is not None:
        ones = R.new_ones(nu)
        constraints = ((
            core.ControlErrorResidual(target=R.new_zeros(nu)),
            core.BoxConstraint(lower=-u_bound * ones, upper=u_bound * ones),
        ),)
    stage = core.make_stage(cost, dyn, space, nu, constraints)

    def problem_of_theta(theta: Tensor) -> core.TrajOptProblem:
        term_cost = core.QuadraticStateCost(theta, w_term)
        return core.make_problem(x0.expand(theta.shape[0], nx), stage, nsteps,
                                 term_cost)

    return problem_of_theta


def make_double_integrator_family(nsteps: int = 20, dtype=torch.float64,
                                  device="cuda", u_bound=None):
    """The published family, on the card unless ``device="cpu"``."""
    dev = resolve(device)
    dt = 0.1

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    eye2 = torch.eye(2, dtype=dtype, device=dev)
    return double_integrator_family(
        t([[1.0, dt], [0.0, 1.0]]), t([[0.0], [dt]]), 0.01 * eye2, t([[0.01]]),
        10.0 * eye2, t([1.0, 0.0]), nsteps, u_bound=u_bound)
