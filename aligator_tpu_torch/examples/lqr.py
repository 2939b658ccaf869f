"""The double-integrator LQR of the JAX package's ``examples/lqr.py``.

A point mass on a line (x = position, velocity; dt = 0.1) driven to the
origin from ``x0 = (1, 0)``: stage cost ``½·0.01·dt (x'x + u'u)``, terminal
cost ``½·10 x'x``, optionally the control bound ``|u| <= u_bound``. Batched
over initial states: replace ``x0`` by a ``(B, 2)`` batch with
``dataclasses.replace``.
"""

from __future__ import annotations

import torch

from .. import core
from .._device import resolve
from .medium_dims import linear_problem


def make_lqr_problem(nsteps: int = 100, dtype=torch.float64, u_bound=None,
                     device="cuda") -> core.TrajOptProblem:
    """The LQR problem over ``nsteps`` stages, on the card unless
    ``device="cpu"``."""
    dev = resolve(device)
    dt = 0.1

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    u_box = None
    if u_bound is not None:
        u_box = (t([-u_bound]), t([u_bound]))
    return linear_problem(
        t([[1.0, dt], [0.0, 1.0]]), t([[0.0], [dt]]), t([0.0, 0.0]),
        0.01 * dt * torch.eye(2, dtype=dtype, device=dev), t([[0.01 * dt]]),
        10.0 * torch.eye(2, dtype=dtype, device=dev), t([1.0, 0.0]), nsteps,
        u_box=u_box,
    )
