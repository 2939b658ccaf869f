"""A partial initial condition.

Port of ``examples/partial_initial_condition.py``: only x0[1] = 0.1 is
pinned, the initial condition being a ``FunctionSlice`` of a
``StateErrorResidual`` instead of the full-state default, and the solver
runs with ``force_initial_condition=False`` so that x0[0] is optimized like
any other variable. Linear dynamics on R² (A = I + 0.1 e₀e₁', B = I, N =
100), control cost ``½·1e-3 u'u``, terminal cost ``½ x'x``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .. import core
from .._device import resolve

SOLVE_OPTIONS = dict(tol=1e-6, mu_init=1e-2, max_iters=40, max_al_iters=10,
                     force_initial_condition=False)


def partial_initial_condition_problem(A: Tensor, B: Tensor, w_u: Tensor,
                                      w_term: Tensor, x0: Tensor, pinned: tuple,
                                      nsteps: int) -> core.TrajOptProblem:
    """Build the problem from its leaves: ``x0 (B, nx)`` (or ``(nx,)``) holds
    the desired initial states, of which only the components ``pinned`` are
    constrained."""
    nx, nu = B.shape
    space = core.VectorSpace(nx)
    dyn = core.LinearDiscreteDynamics(A=A, B=B, c=A.new_zeros(nx))
    cost = core.QuadraticCost.create(A.new_zeros((nx, nx)), w_u)
    term_cost = core.QuadraticCost.create(w_term, w_u.new_zeros((nu, nu)))
    stage = core.make_stage(cost, dyn, space, nu)
    x0 = x0 if x0.ndim == 2 else x0[None]
    init = core.FunctionSlice(func=core.StateErrorResidual(target=x0),
                              indices=tuple(pinned))
    return core.make_problem(x0, stage, nsteps, term_cost, init_constraint=init)


def create_problem(nsteps: int = 100, dtype=torch.float64, device="cuda"):
    """The published problem with one scenario."""
    dev = resolve(device)
    A = torch.eye(2, dtype=dtype, device=dev)
    A[0, 1] = 0.1
    eye = torch.eye(2, dtype=dtype, device=dev)
    return partial_initial_condition_problem(
        A, eye, 1e-3 * eye, eye, torch.tensor([0.0, 0.1], dtype=dtype, device=dev),
        (1,), nsteps)
