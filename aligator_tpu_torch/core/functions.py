"""Stage functions (residuals) with autodiff-default Jacobians.

PyTorch counterpart of ``aligator_tpu/core/functions.py``. A stage function
maps ``(x, u) → r ∈ R^nr``; inputs carry any leading (batch, stage) dims,
and Jacobians are taken in tangent coordinates of the state manifold.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from .._linalg import mv
from .manifolds import Manifold, batched_jacfwd


def stage_param(leaf: Tensor, x: Tensor, ndim: int) -> Tensor:
    """A stage parameter of ``ndim`` dims per stage, checked against the
    input ``x`` it meets.

    A leaf with one more leading axis of size N varies over the N stages (a
    contact schedule, a swing-foot weight): it broadcasts against the ``(B,
    N, ·)`` blocks of the problem's evaluation. Any other input, such as
    one stage's ``(B, ·)`` state, raises rather than broadcast the stage
    axis against the batch axis."""
    if leaf.ndim <= ndim:
        return leaf
    if leaf.ndim == ndim + 1 and x.ndim >= 3 and x.shape[-2] == leaf.shape[0]:
        return leaf
    raise ValueError(
        f"a stage-varying parameter of shape {tuple(leaf.shape)} needs a (B, "
        f"{leaf.shape[0]}, ·) input over the whole horizon, got {tuple(x.shape)}"
    )


class StageFunction:
    """Residual r(x, u). Subclasses implement ``value`` and ``dim``;
    ``jacobians`` has an exact forward-mode autodiff default."""

    def dim(self, space: Manifold, nu: int) -> int:
        """Residual size nr."""
        raise NotImplementedError

    def value(self, space: Manifold, x: Tensor, u: Tensor) -> Tensor:
        raise NotImplementedError

    def jacobians(self, space: Manifold, x: Tensor, u: Tensor):
        """Returns (Jx, Ju) in tangent coordinates: ``(..., nr, ndx)`` and
        ``(..., nr, nu)``."""
        def f_dx(dx, x, u):
            return self.value(space, space.integrate(x, dx), u)

        def f_du(du, x, u):
            return self.value(space, x, u + du)

        Jx = batched_jacfwd(f_dx, space.ndx, x, u)
        Ju = batched_jacfwd(f_du, u.shape[-1], x, u)
        return Jx, Ju


@dataclass
class StateErrorResidual(StageFunction):
    """r(x) = x ⊖ target."""

    target: Tensor
    # the leaves that may vary over the stages, with their per-stage ndim
    # (utils.mpc.cycle_problem rotates them)
    STAGE_PARAMS = {"target": 1}

    def dim(self, space, nu):
        return space.ndx

    def value(self, space, x, u):
        return space.difference(self.target, x)

    def jacobians(self, space, x, u):
        Jx = space.jdifference(self.target, x, 1)
        Ju = x.new_zeros(Jx.shape[:-1] + (u.shape[-1],))
        return Jx, Ju


@dataclass
class ControlErrorResidual(StageFunction):
    """r(u) = u − target."""

    target: Tensor

    def dim(self, space, nu):
        return self.target.shape[-1]

    def value(self, space, x, u):
        return u - self.target

    def jacobians(self, space, x, u):
        nu = u.shape[-1]
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        eye = torch.eye(nu, dtype=u.dtype, device=u.device)
        return u.new_zeros(lead + (nu, space.ndx)), eye.expand(lead + (nu, nu))


def _lead(x: Tensor, u: Tensor):
    return torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])


@dataclass
class LinearFunction(StageFunction):
    """r(x, u) = A dx + B u + c, ``dx = x ⊖ neutral`` (x itself on a vector
    space)."""

    A: Tensor  # (nr, ndx)
    B: Tensor  # (nr, nu)
    c: Tensor  # (nr,)

    def dim(self, space, nu):
        return self.A.shape[-2]

    def value(self, space, x, u):
        dx = space.difference(space.neutral(x.dtype, x.device), x)
        return mv(self.A, dx) + mv(self.B, u) + self.c

    def jacobians(self, space, x, u):
        lead = _lead(x, u)
        return (self.A.expand(lead + self.A.shape[-2:]),
                self.B.expand(lead + self.B.shape[-2:]))


@dataclass
class ControlBoxFunction(StageFunction):
    """r(u) = [u − umax; umin − u] ≤ 0, control bounds for a
    :class:`~.sets.NegativeOrthant`."""

    umin: Tensor
    umax: Tensor

    def dim(self, space, nu):
        return 2 * nu

    def value(self, space, x, u):
        return torch.cat([u - self.umax, self.umin - u], -1)

    def jacobians(self, space, x, u):
        lead, nu = _lead(x, u), u.shape[-1]
        eye = torch.eye(nu, dtype=u.dtype, device=u.device)
        Ju = torch.cat([eye, -eye], 0)
        return u.new_zeros(lead + (2 * nu, space.ndx)), Ju.expand(lead + Ju.shape)


@dataclass
class FunctionSlice(StageFunction):
    """The rows ``indices`` of another function's residual."""

    func: StageFunction
    indices: tuple = ()

    def dim(self, space, nu):
        return len(self.indices)

    def _rows(self, r: Tensor, axis: int) -> Tensor:
        # a slice for a run of consecutive rows, else one pick a row: a
        # Python list as an index is copied to the device, which a CUDA
        # graph's capture (a line-search trial) refuses
        idx = tuple(self.indices)
        start = idx[0] if idx else 0
        if idx == tuple(range(start, start + len(idx))):
            return r.narrow(axis, start, len(idx))
        return torch.stack([r.select(axis, i) for i in idx], axis)

    def value(self, space, x, u):
        return self._rows(self.func.value(space, x, u), -1)

    def jacobians(self, space, x, u):
        Jx, Ju = self.func.jacobians(space, x, u)
        return self._rows(Jx, -2), self._rows(Ju, -2)


@dataclass
class GatedFunction(StageFunction):
    """r(x, u) = gate · f(x, u): a scalar gate, or one per stage (an ``(N,)``
    leaf), that switches a function's rows on (1) or off (0) stage by
    stage."""

    func: StageFunction
    gate: Tensor | float = 1.0
    STAGE_PARAMS = {"gate": 0}

    def dim(self, space, nu):
        return self.func.dim(space, nu)

    def _gate(self, x):
        g = stage_param(torch.as_tensor(self.gate, dtype=x.dtype, device=x.device),
                        x, 0)
        return g[..., None]

    def value(self, space, x, u):
        return self._gate(x) * self.func.value(space, x, u)

    def jacobians(self, space, x, u):
        Jx, Ju = self.func.jacobians(space, x, u)
        g = self._gate(x)[..., None]
        return g * Jx, g * Ju


@dataclass
class LinearFunctionComposition(StageFunction):
    """r(x, u) = A f(x, u) + b."""

    func: StageFunction
    A: Tensor
    b: Tensor

    def dim(self, space, nu):
        return self.A.shape[-2]

    def value(self, space, x, u):
        return mv(self.A, self.func.value(space, x, u)) + self.b

    def jacobians(self, space, x, u):
        Jx, Ju = self.func.jacobians(space, x, u)
        return self.A @ Jx, self.A @ Ju
