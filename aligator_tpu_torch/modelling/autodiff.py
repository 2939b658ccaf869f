"""Central finite-difference derivatives, for checks.

PyTorch counterpart of ``aligator_tpu/modelling/autodiff.py``. The solvers
use exact autodiff or closed forms; these helpers let a test hold those
against finite differences on the manifold. Inputs carry any leading
(batch, stage) dims; each column is one central difference along a tangent
direction.
"""

from __future__ import annotations

import torch


def _dirs(n: int, like: torch.Tensor, eps: float):
    return eps * torch.eye(n, dtype=like.dtype, device=like.device)


def fd_stage_function_jacobians(func, space, x, u, eps=1e-6):
    """Central finite-difference ``(Jx (..., nr, ndx), Ju (..., nr, nu))``
    of a stage function."""
    Jx = [(func.value(space, space.integrate(x, d), u)
           - func.value(space, space.integrate(x, -d), u)) / (2 * eps)
          for d in _dirs(space.ndx, x, eps)]
    Ju = [(func.value(space, x, u + d) - func.value(space, x, u - d)) / (2 * eps)
          for d in _dirs(u.shape[-1], u, eps)]
    return torch.stack(Jx, -1), torch.stack(Ju, -1)


def fd_cost_gradients(cost, space, x, u, eps=1e-6):
    """Central finite-difference ``(Lx (..., ndx), Lu (..., nu))`` of a cost."""
    gx = [(cost.value(space, space.integrate(x, d), u)
           - cost.value(space, space.integrate(x, -d), u)) / (2 * eps)
          for d in _dirs(space.ndx, x, eps)]
    gu = [(cost.value(space, x, u + d) - cost.value(space, x, u - d)) / (2 * eps)
          for d in _dirs(u.shape[-1], u, eps)]
    return torch.stack(gx, -1), torch.stack(gu, -1)


def fd_dynamics_jacobians(dyn, space, x, u, eps=1e-6):
    """Central finite-difference ``(A, B, E)`` of a dynamics residual at
    ``y = forward(x, u)``."""
    y = dyn.forward(space, x, u)
    A, E = [], []
    for d in _dirs(space.ndx, x, eps):
        A.append((dyn.residual(space, space.integrate(x, d), u, y)
                  - dyn.residual(space, space.integrate(x, -d), u, y)) / (2 * eps))
        E.append((dyn.residual(space, x, u, space.integrate(y, d))
                  - dyn.residual(space, x, u, space.integrate(y, -d))) / (2 * eps))
    B = [(dyn.residual(space, x, u + d, y) - dyn.residual(space, x, u - d, y)) / (2 * eps)
         for d in _dirs(u.shape[-1], u, eps)]
    return torch.stack(A, -1), torch.stack(B, -1), torch.stack(E, -1)
