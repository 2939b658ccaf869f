"""Cost functions with autodiff or Gauss-Newton derivatives.

PyTorch counterpart of ``aligator_tpu/core/costs.py``. Costs take ``(..., nx)``
states and ``(..., nu)`` controls with any leading (batch, stage) dims and
return ``(...)`` values. Derivatives are in tangent coordinates; the default
is exact autodiff (gradient and full Hessian), residual costs override it
with Gauss-Newton.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from .._linalg import mv
from .functions import ControlErrorResidual, StageFunction, StateErrorResidual
from .manifolds import Manifold


def _flat(x: Tensor, u: Tensor):
    lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
    return (
        lead,
        x.expand(lead + x.shape[-1:]).reshape(-1, x.shape[-1]),
        u.expand(lead + u.shape[-1:]).reshape(-1, u.shape[-1]),
    )


class Cost:
    """Scalar stage cost ℓ(x, u)."""

    def value(self, space: Manifold, x: Tensor, u: Tensor) -> Tensor:
        raise NotImplementedError

    def _tangent_fn(self, space: Manifold):
        nd = space.ndx

        def f(dxu, x, u):
            return self.value(space, space.integrate(x, dxu[:nd]), u + dxu[nd:])

        return f

    def gradients(self, space, x, u):
        """Returns (Lx, Lu)."""
        lead, xf, uf = _flat(x, u)
        z = x.new_zeros(space.ndx + u.shape[-1])
        g = torch.func.vmap(
            torch.func.grad(self._tangent_fn(space)), in_dims=(None, 0, 0)
        )(z, xf, uf).reshape(lead + z.shape)
        return g[..., :space.ndx], g[..., space.ndx:]

    def hessians(self, space, x, u):
        """Returns (Lxx, Lxu, Luu)."""
        lead, xf, uf = _flat(x, u)
        z = x.new_zeros(space.ndx + u.shape[-1])
        H = torch.func.vmap(
            torch.func.hessian(self._tangent_fn(space)), in_dims=(None, 0, 0)
        )(z, xf, uf).reshape(lead + z.shape + z.shape)
        nd = space.ndx
        return H[..., :nd, :nd], H[..., :nd, nd:], H[..., nd:, nd:]


@dataclass
class QuadraticCost(Cost):
    """ℓ = ½ dx'Q dx + dx'N u + ½ u'R u + q'dx + r'u + c with dx = x ⊖ 0."""

    Q: Tensor
    R: Tensor
    N: Tensor  # (ndx, nu) cross term
    q: Tensor
    r: Tensor
    c: Tensor

    @staticmethod
    def create(Q, R, N=None, q=None, r=None, c=0.0):
        nd, nu = Q.shape[-1], R.shape[-1]
        return QuadraticCost(
            Q=Q, R=R,
            N=Q.new_zeros((nd, nu)) if N is None else N,
            q=Q.new_zeros(nd) if q is None else q,
            r=Q.new_zeros(nu) if r is None else r,
            c=torch.as_tensor(c, dtype=Q.dtype, device=Q.device),
        )

    def _dx(self, space, x):
        return space.difference(space.neutral(x.dtype, x.device), x)

    def value(self, space, x, u):
        dx = self._dx(space, x)
        return (
            0.5 * (dx * mv(self.Q, dx)).sum(-1)
            + (dx * mv(self.N, u)).sum(-1)
            + 0.5 * (u * mv(self.R, u)).sum(-1)
            + (self.q * dx).sum(-1)
            + (self.r * u).sum(-1)
            + self.c
        )

    def gradients(self, space, x, u):
        dx = self._dx(space, x)
        Lx = mv(self.Q, dx) + mv(self.N, u) + self.q
        Lu = mv(self.N.mT, dx) + mv(self.R, u) + self.r
        return Lx, Lu

    def hessians(self, space, x, u):
        return self.Q, self.N, self.R


@dataclass
class QuadraticResidualCost(Cost):
    """ℓ = ½ ‖r(x,u)‖²_W with Gauss-Newton derivatives; with
    ``gauss_newton=False`` the Hessian is the exact autodiff Hessian."""

    residual: StageFunction
    weights: Tensor  # (nr, nr)
    gauss_newton: bool = True

    def value(self, space, x, u):
        r = self.residual.value(space, x, u)
        return 0.5 * (r * mv(self.weights, r)).sum(-1)

    def gradients(self, space, x, u):
        r = self.residual.value(space, x, u)
        Jx, Ju = self.residual.jacobians(space, x, u)
        Wr = mv(self.weights, r)
        return mv(Jx.mT, Wr), mv(Ju.mT, Wr)

    def hessians(self, space, x, u):
        if not self.gauss_newton:
            return Cost.hessians(self, space, x, u)
        Jx, Ju = self.residual.jacobians(space, x, u)
        WJx = self.weights @ Jx
        WJu = self.weights @ Ju
        return Jx.mT @ WJx, Jx.mT @ WJu, Ju.mT @ WJu


def QuadraticStateCost(target: Tensor, weights: Tensor) -> QuadraticResidualCost:
    """½‖x ⊖ target‖²_W."""
    return QuadraticResidualCost(StateErrorResidual(target), weights)


def QuadraticControlCost(weights: Tensor, target=None) -> QuadraticResidualCost:
    """½‖u − target‖²_W."""
    if target is None:
        target = weights.new_zeros(weights.shape[-1])
    return QuadraticResidualCost(ControlErrorResidual(target), weights)


@dataclass
class CostStack(Cost):
    """Weighted sum of costs."""

    costs: tuple = ()
    weights: tuple = ()

    @staticmethod
    def create(*costs, weights=None):
        if weights is None:
            weights = (1.0,) * len(costs)
        return CostStack(costs=tuple(costs), weights=tuple(weights))

    def value(self, space, x, u):
        total = 0.0
        for w, c in zip(self.weights, self.costs):
            total = total + w * c.value(space, x, u)
        return total

    def gradients(self, space, x, u):
        Lx, Lu = 0.0, 0.0
        for w, c in zip(self.weights, self.costs):
            gx, gu = c.gradients(space, x, u)
            Lx = Lx + w * gx
            Lu = Lu + w * gu
        return Lx, Lu

    def hessians(self, space, x, u):
        Lxx, Lxu, Luu = 0.0, 0.0, 0.0
        for w, c in zip(self.weights, self.costs):
            hxx, hxu, huu = c.hessians(space, x, u)
            Lxx = Lxx + w * hxx
            Lxu = Lxu + w * hxu
            Luu = Luu + w * huu
        return Lxx, Lxu, Luu
