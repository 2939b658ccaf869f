"""Manifold (Lie-group) interface and Euclidean spaces.

PyTorch counterpart of ``aligator_tpu/core/manifolds.py``. Operations take
points ``(..., nx)`` and tangents ``(..., ndx)`` with any leading (batch,
stage) dims. Convention (as pinocchio):

  ``difference(x0, x1) = x1 ⊖ x0``,  ``integrate(x, v) = x ⊕ v``,
  ``jintegrate/jdifference(·, ·, arg)`` differentiate wrt argument ``arg``
  in tangent coordinates.

Jacobians default to exact forward-mode autodiff (:func:`batched_jacfwd`).
"""

from __future__ import annotations

import torch
from torch import Tensor


def batched_jacfwd(fn, n: int, *args: Tensor) -> Tensor:
    """Jacobian of ``fn(z, *args)`` wrt ``z ∈ R^n`` at ``z = 0``, for every
    sample of the leading dims of ``args``.

    ``fn`` is written for one sample: each ``args[i]`` has its last dim only.
    The leading dims of the args broadcast; they are flattened into one axis
    that ``torch.func.vmap`` maps over. Returns ``(..., m, n)``.
    """
    lead = torch.broadcast_shapes(*(a.shape[:-1] for a in args))
    flat = [a.expand(lead + a.shape[-1:]).reshape(-1, a.shape[-1]) for a in args]
    z = args[0].new_zeros(n)
    jac = torch.func.vmap(
        torch.func.jacfwd(fn), in_dims=(None,) + (0,) * len(args)
    )(z, *flat)
    return jac.reshape(lead + jac.shape[1:])


class Manifold:
    """Abstract manifold. Subclasses define nx/ndx/neutral/integrate/difference."""

    nx: int
    ndx: int

    def neutral(self, dtype=None, device=None) -> Tensor:
        raise NotImplementedError

    def integrate(self, x: Tensor, v: Tensor) -> Tensor:
        raise NotImplementedError

    def difference(self, x0: Tensor, x1: Tensor) -> Tensor:
        raise NotImplementedError

    def jintegrate(self, x: Tensor, v: Tensor, arg: int) -> Tensor:
        """d/d(arg) of ``integrate(x ⊕ dx, v + dv)`` in tangent coords at 0."""
        if arg == 0:
            def fn(dx, x, v):
                return self.difference(
                    self.integrate(x, v), self.integrate(self.integrate(x, dx), v)
                )
        else:
            def fn(dv, x, v):
                return self.difference(self.integrate(x, v), self.integrate(x, v + dv))
        return batched_jacfwd(fn, self.ndx, x, v)

    def jdifference(self, x0: Tensor, x1: Tensor, arg: int) -> Tensor:
        """d/d(arg) of ``difference(x0 ⊕ d0, x1 ⊕ d1)`` in tangent coords at 0."""
        if arg == 0:
            def fn(d0, x0, x1):
                return self.difference(self.integrate(x0, d0), x1)
        else:
            def fn(d1, x0, x1):
                return self.difference(x0, self.integrate(x1, d1))
        return batched_jacfwd(fn, self.ndx, x0, x1)

    def __repr__(self):
        return f"{type(self).__name__}(nx={self.nx}, ndx={self.ndx})"


class VectorSpace(Manifold):
    """Euclidean space R^n."""

    def __init__(self, n: int):
        self.nx = n
        self.ndx = n

    def neutral(self, dtype=None, device=None) -> Tensor:
        return torch.zeros(self.nx, dtype=dtype, device=device)

    def integrate(self, x, v):
        return x + v

    def difference(self, x0, x1):
        return x1 - x0

    def _eye(self, x: Tensor) -> Tensor:
        eye = torch.eye(self.ndx, dtype=x.dtype, device=x.device)
        return eye.expand(x.shape[:-1] + eye.shape)

    def jintegrate(self, x, v, arg):
        return self._eye(torch.broadcast_tensors(x, v)[0])

    def jdifference(self, x0, x1, arg):
        eye = self._eye(torch.broadcast_tensors(x0, x1)[0])
        return -eye if arg == 0 else eye

    def __eq__(self, other):
        return type(other) is VectorSpace and other.nx == self.nx

    def __hash__(self):
        return hash(("VectorSpace", self.nx))
