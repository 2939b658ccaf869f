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


def unit_vector(n: int, k: int, dtype=None, device=None) -> Tensor:
    """The n-vector with a one at k, filled on ``device``: a tensor built
    from a Python list would be copied from the host, which a CUDA graph's
    capture (a line-search trial that evaluates a neutral point) refuses."""
    e = torch.zeros(n, dtype=dtype, device=device)
    e.narrow(0, k, 1).fill_(1.0)  # a scalar argument, where e[k] = 1.0 copies one
    return e


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

    def interpolate(self, x0: Tensor, x1: Tensor, t) -> Tensor:
        """The point at fraction ``t`` of the geodesic from ``x0`` to ``x1``."""
        return self.integrate(x0, t * self.difference(x0, x1))

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


def _block_diag(blocks, lead, dtype, device) -> Tensor:
    """``(..., n, n)`` block-diagonal matrix of square ``blocks``, each
    ``(..., n_i, n_i)`` (broadcast to the leading dims ``lead``)."""
    n = sum(b.shape[-1] for b in blocks)
    out = torch.zeros(lead + (n, n), dtype=dtype, device=device)
    i = 0
    for b in blocks:
        k = b.shape[-1]
        out[..., i:i + k, i:i + k] = b
        i += k
    return out


class CartesianProduct(Manifold):
    """Product of manifolds (``aligator_tpu/core/manifolds.py:121``).

    Nested products are flattened and adjacent vector spaces merged into one
    block: a free-flyer robot's 1 + 22 components become SE(3) × R²², which
    computes the same maps with two blocks per chart Jacobian instead of 23.
    """

    def __init__(self, *components: Manifold):
        flat = []
        for c in components:
            for m in (c.components if isinstance(c, CartesianProduct) else (c,)):
                if (flat and type(m) is VectorSpace
                        and type(flat[-1]) is VectorSpace):
                    flat[-1] = VectorSpace(flat[-1].nx + m.nx)
                else:
                    flat.append(m)
        self.components = tuple(flat)
        self.nx = sum(c.nx for c in self.components)
        self.ndx = sum(c.ndx for c in self.components)

    def _split(self, x, attr):
        out, i = [], 0
        for c in self.components:
            n = getattr(c, attr)
            out.append(x[..., i:i + n])
            i += n
        return out

    def neutral(self, dtype=None, device=None):
        return torch.cat([c.neutral(dtype, device) for c in self.components], -1)

    def integrate(self, x, v):
        return torch.cat([
            c.integrate(xc, vc) for c, xc, vc in
            zip(self.components, self._split(x, "nx"), self._split(v, "ndx"))
        ], -1)

    def difference(self, x0, x1):
        return torch.cat([
            c.difference(a, b) for c, a, b in
            zip(self.components, self._split(x0, "nx"), self._split(x1, "nx"))
        ], -1)

    def jintegrate(self, x, v, arg):
        blocks = [c.jintegrate(xc, vc, arg) for c, xc, vc in
                  zip(self.components, self._split(x, "nx"), self._split(v, "ndx"))]
        lead = torch.broadcast_shapes(x.shape[:-1], v.shape[:-1])
        return _block_diag(blocks, lead, x.dtype, x.device)

    def jdifference(self, x0, x1, arg):
        blocks = [c.jdifference(a, b, arg) for c, a, b in
                  zip(self.components, self._split(x0, "nx"), self._split(x1, "nx"))]
        lead = torch.broadcast_shapes(x0.shape[:-1], x1.shape[:-1])
        return _block_diag(blocks, lead, x0.dtype, x0.device)

    def __eq__(self, other):
        return (type(other) is CartesianProduct
                and other.components == self.components)

    def __hash__(self):
        return hash(("CartesianProduct", self.components))


class TangentBundle(Manifold):
    """Phase space (q, v) over a base manifold
    (``aligator_tpu/core/manifolds.py:216``): configuration on ``base``,
    velocity in its tangent. The chart Jacobians are block-diagonal, the
    base's block and ±I for the velocity."""

    def __init__(self, base: Manifold):
        self.base = base
        self.nx = base.nx + base.ndx
        self.ndx = 2 * base.ndx

    def neutral(self, dtype=None, device=None):
        return torch.cat([self.base.neutral(dtype, device),
                          torch.zeros(self.base.ndx, dtype=dtype, device=device)])

    def integrate(self, x, v):
        nq, nv = self.base.nx, self.base.ndx
        q = self.base.integrate(x[..., :nq], v[..., :nv])
        return torch.cat([q, x[..., nq:] + v[..., nv:]], -1)

    def difference(self, x0, x1):
        nq, nv = self.base.nx, self.base.ndx
        dq = self.base.difference(x0[..., :nq], x1[..., :nq])
        return torch.cat([dq, x1[..., nq:] - x0[..., nq:]], -1)

    def _with_velocity_block(self, Jq, lead, sign, dtype, device):
        nv = self.base.ndx
        eye = sign * torch.eye(nv, dtype=dtype, device=device)
        return _block_diag([Jq, eye.expand(lead + (nv, nv))], lead, dtype, device)

    def jintegrate(self, x, v, arg):
        nq, nv = self.base.nx, self.base.ndx
        Jq = self.base.jintegrate(x[..., :nq], v[..., :nv], arg)
        lead = torch.broadcast_shapes(x.shape[:-1], v.shape[:-1])
        return self._with_velocity_block(Jq, lead, 1.0, x.dtype, x.device)

    def jdifference(self, x0, x1, arg):
        nq = self.base.nx
        Jq = self.base.jdifference(x0[..., :nq], x1[..., :nq], arg)
        lead = torch.broadcast_shapes(x0.shape[:-1], x1.shape[:-1])
        return self._with_velocity_block(Jq, lead, -1.0 if arg == 0 else 1.0,
                                         x0.dtype, x0.device)

    def __eq__(self, other):
        return type(other) is TangentBundle and other.base == self.base

    def __hash__(self):
        return hash(("TangentBundle", self.base))
