"""Discrete dynamics interface.

PyTorch counterpart of ``aligator_tpu/core/dynamics.py``. An explicit
dynamics is a map ``xnext = forward(x, u)``; the implicit residual used by
the solvers is ``value(x, u, y) = y ⊖ forward(x, u)`` with tangent-space
Jacobians ``A = ∂value/∂x``, ``B = ∂value/∂u``, ``E = ∂value/∂y``
(``E = −I`` on vector spaces). An implicit dynamics
(:class:`ImplicitDynamics`) defines the residual itself and solves it for
``y`` by Newton steps.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import Tensor

from .._linalg import mv
from .manifolds import Manifold, batched_jacfwd


def _lead_shape(*ts: Tensor) -> tuple:
    """The broadcast of the tensors' shapes without their last dim (plain
    Python: ``torch.broadcast_shapes`` costs ~0.3 ms a call on the host)."""
    shapes = [tuple(t.shape[:-1]) for t in ts]
    n = max(len(s) for s in shapes)
    return tuple(0 if 0 in d else max(d)
                 for d in zip(*((1,) * (n - len(s)) + s for s in shapes)))


def dynamics_at(dynamics, t: int, N: int):
    """The dynamics of stage ``t`` of a model shared by N stages: each leaf
    that a dataclass of ``dynamics`` lists in its ``STAGE_PARAMS`` (name:
    per-stage ndim) and that carries a leading stage axis of size N (a
    contact schedule) is replaced by its row ``t``, in the model and in the
    models it holds (an integrator's ODE). What a per-stage loop (a rollout)
    applies to one stage's ``(B, nx)`` state."""
    if not dataclasses.is_dataclass(dynamics):
        return dynamics
    varying = getattr(dynamics, "STAGE_PARAMS", {})
    new = {}
    for f in dataclasses.fields(dynamics):
        val = getattr(dynamics, f.name)
        if f.name in varying and isinstance(val, Tensor):
            if val.ndim == varying[f.name] + 1 and val.shape[0] == N:
                new[f.name] = val[t]
        elif dataclasses.is_dataclass(val) and not isinstance(val, type):
            sub = dynamics_at(val, t, N)
            if sub is not val:
                new[f.name] = sub
    return dataclasses.replace(dynamics, **new) if new else dynamics


class ExplicitDynamics:
    """Explicit discrete dynamics x_{t+1} = forward(x_t, u_t)."""

    is_explicit = True

    def forward(self, space: Manifold, x: Tensor, u: Tensor) -> Tensor:
        raise NotImplementedError

    def residual(self, space, x, u, y):
        """Implicit residual value(x, u, y) = difference(y, forward(x, u))."""
        return space.difference(y, self.forward(space, x, u))

    def jacobians(self, space, x, u, y):
        """Tangent-space Jacobians (A, B, E) of the residual, exact
        forward-mode autodiff per sample."""
        def f_dx(dx, x, u, y):
            return self.residual(space, space.integrate(x, dx), u, y)

        def f_du(du, x, u, y):
            return self.residual(space, x, u + du, y)

        def f_dy(dy, x, u, y):
            return self.residual(space, x, u, space.integrate(y, dy))

        A = batched_jacfwd(f_dx, space.ndx, x, u, y)
        B = batched_jacfwd(f_du, u.shape[-1], x, u, y)
        E = batched_jacfwd(f_dy, space.ndx, x, u, y)
        return A, B, E


@dataclass
class LinearDiscreteDynamics(ExplicitDynamics):
    """x' = A x + B u + c on a vector space."""

    A: Tensor
    B: Tensor
    c: Tensor

    def forward(self, space, x, u):
        return mv(self.A, x) + mv(self.B, u) + self.c

    def jacobians(self, space, x, u, y):
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1], y.shape[:-1])
        n = self.A.shape[-1]
        E = -torch.eye(n, dtype=x.dtype, device=x.device)
        return (
            self.A.expand(lead + self.A.shape[-2:]),
            self.B.expand(lead + self.B.shape[-2:]),
            E.expand(lead + (n, n)),
        )


class ImplicitDynamics(ExplicitDynamics):
    """Implicit discrete dynamics r(x, u, y) = 0 (``aligator_tpu/core/
    dynamics.py:79-119``). Subclasses implement ``residual``; ``forward``
    solves it by a fixed number of Newton steps on the manifold seeded at
    ``x``, with no exit that depends on the data, so every scenario of a
    batch takes the same steps, as each does under the JAX package's
    ``lax.scan``."""

    is_explicit = False
    newton_iters: int = 5

    def residual(self, space, x, u, y):
        raise NotImplementedError

    def forward_with_gap(self, space: Manifold, x: Tensor, u: Tensor,
                         gap: Tensor | None = None, iters: int | None = None):
        """Solve ``r(x, u, y) + gap = 0`` for ``y`` by ``iters`` Newton steps
        (default ``newton_iters``), each a batched dense solve against the
        Jacobian ``∂r/∂y`` (:meth:`_residual_and_jacobian_y`). Nothing here
        waits on the host (``solve_ex`` does not check its pivots), so a
        CUDA graph can capture it."""
        iters = self.newton_iters if iters is None else iters
        y = x
        for _ in range(iters):
            r, E = self._residual_and_jacobian_y(space, x, u, y)
            if gap is not None:
                r = r + gap
            y = space.integrate(y, -torch.linalg.solve_ex(E, r)[0])
        return y

    def _residual_and_jacobian_y(self, space, x, u, y) -> tuple[Tensor, Tensor]:
        """``r(x, u, y)`` and ``∂r/∂y (..., ndx, ndx)`` in tangent
        coordinates at ``y``, by reverse-mode autograd in one backward
        pass: the batch is copied ``ndx`` times, copy ``i`` gives row ``i``
        and copy 0 the residual (a fraction of what :func:`batched_jacfwd`'s
        nested ``torch.func`` transforms cost at these sizes); the solvers
        never call ``forward`` inside a ``torch.func`` transform."""
        n = space.ndx
        lead = (n,) + _lead_shape(x, u, y)
        with torch.enable_grad():
            dy = y.new_zeros(lead + (n,), requires_grad=True)
            r = self.residual(space, x.detach().expand(lead + x.shape[-1:]),
                              u.detach().expand(lead + u.shape[-1:]),
                              space.integrate(y.detach().expand(lead + y.shape[-1:]), dy))
            (rows,) = torch.autograd.grad(r.diagonal(0, 0, -1).sum(), dy)
        return r[0].detach(), rows.movedim(0, -2)

    def forward(self, space, x, u):
        return self.forward_with_gap(space, x, u)
