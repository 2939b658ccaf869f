"""Open- and closed-loop rollouts of discrete dynamics.

PyTorch counterpart of ``aligator_tpu/utils/rollout.py``: a loop over the
stages, each step the whole batch at once. ``dynamics`` is one dynamics
model applied at every stage (explicit, or implicit and solved by its
Newton steps); its stage-varying leaves (a contact schedule) are read a
stage at a time (:func:`~..core.dynamics.dynamics_at`).
"""

from __future__ import annotations

import torch
from torch import Tensor

from .._linalg import mv
from ..core.dynamics import dynamics_at


def rollout(dynamics, space, x0: Tensor, us: Tensor) -> Tensor:
    """Open-loop rollout from ``x0 (..., nx)`` under ``us (..., N, nu)``:
    returns ``xs (..., N + 1, nx)``."""
    xs = [x0.expand(us.shape[:-2] + x0.shape[-1:])]
    N = us.shape[-2]
    for t in range(N):
        xs.append(dynamics_at(dynamics, t, N).forward(space, xs[-1], us[..., t, :]))
    return torch.stack(xs, -2)


def closed_loop_rollout(dynamics, space, x0: Tensor, us_ref: Tensor, xs_ref: Tensor,
                        K: Tensor, kff=None):
    """Feedback rollout u_t = u_ref,t + kff_t + K_t (x_t ⊖ x_ref,t): returns
    ``(xs (..., N + 1, nx), us (..., N, nu))``."""
    xs, us = [x0.expand(us_ref.shape[:-2] + x0.shape[-1:])], []
    N = us_ref.shape[-2]
    for t in range(N):
        u = us_ref[..., t, :] + mv(K[..., t, :, :], space.difference(xs_ref[..., t, :], xs[-1]))
        if kff is not None:
            u = u + kff[..., t, :]
        us.append(u)
        xs.append(dynamics_at(dynamics, t, N).forward(space, xs[-1], u))
    return torch.stack(xs, -2), torch.stack(us, -2)
