"""Batched small-matrix helpers shared by the port's modules."""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor


def chol_solve(M: Tensor, rhs: Tensor) -> Tensor:
    """Solve ``M X = rhs`` for a batch of SPD ``M`` by Cholesky (lower
    triangle read). A factorization that fails (M not positive definite)
    gives NaN for that system, as the kernels do, instead of raising for the
    whole batch."""
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info != 0)[..., None, None], torch.nan, L)
    return torch.cholesky_solve(rhs, L)


def cholesky(M: Tensor) -> Tensor:
    """Lower Cholesky factor of a batch of SPD ``M``; NaN for a system whose
    factorization fails, as :func:`chol_solve` gives."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def cholesky_solve_tri(L: Tensor, rhs: Tensor) -> Tensor:
    """``M X = rhs`` from the Cholesky factor ``L`` of ``M`` by two batched
    triangular solves. Unlike ``torch.cholesky_solve``, whose batched CUDA
    path (MAGMA) allocates device memory, this can be captured in a CUDA
    graph (the nonlinear rollout's forward dynamics)."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def lu_solve(M: Tensor, rhs: Tensor) -> Tensor:
    """Solve ``M X = rhs`` for a batch of small nonsymmetric ``M`` (the
    associative scan's combine matrices ``I + C J``): batched LU with
    partial pivoting, then one step of iterative refinement ``X += M⁻¹ (rhs
    - M X)`` on the same factors.

    The JAX package inverts these matrices in closed form and refines the
    inverse by three Newton steps, because the adjugate alone loses ~1e-1
    relative accuracy on the 1/μ-scaled matrices in float32. LU with
    partial pivoting is backward stable already; the one refinement step
    takes the residual from the factorization's error (cond·eps) down to
    rounding, and it is enough: on the card the float32 latency solve at
    μ = 1e-3 (N = 2048) lands within 1.8e-7 of the float64 serial solve.
    A singular ``M`` gives inf/NaN in its own system only."""
    LU, piv, _ = torch.linalg.lu_factor_ex(M)
    X = torch.linalg.lu_solve(LU, piv, rhs)
    return X + torch.linalg.lu_solve(LU, piv, rhs - M @ X)


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Inner product over the last dim, broadcast over leading dims."""
    return (a * b).sum(-1)


def mv(M: Tensor, x: Tensor) -> Tensor:
    """Batched matrix-vector product ``M @ x`` over leading dims."""
    return (M @ x[..., None])[..., 0]


def mtv(M: Tensor, x: Tensor) -> Tensor:
    """Batched transposed product ``M' @ x`` over leading dims."""
    return (M.mT @ x[..., None])[..., 0]


def infnorm(a: Tensor) -> Tensor:
    """Per-scenario max-abs over all but the leading (batch) axis; zero for
    an empty trailing shape."""
    if a[0].numel() == 0:
        return a.new_zeros(a.shape[0])
    return a.abs().flatten(1).amax(1)


def select(mask: Tensor, new, old):
    """Per-scenario select ``mask ? new : old`` of a tensor, a tuple of
    tensors or a dataclass of tensors; ``mask`` is ``(B,)``."""
    if dataclasses.is_dataclass(new):
        return type(new)(**{
            f.name: select(mask, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(new)
        })
    if isinstance(new, tuple):
        return tuple(select(mask, a, b) for a, b in zip(new, old))
    m = mask.reshape(mask.shape + (1,) * (new.ndim - 1))
    return torch.where(m, new, old)
