"""Batched symmetric block-tridiagonal solve.

PyTorch counterpart of ``aligator_tpu/gar/block_tridiag.py`` (the
reference's ``gar/block-tridiagonal.hpp:52-242``), one system per batch
entry. The condensed interface system of the parallel-in-time Riccati
solver is symmetric block-tridiagonal with uniform block size; it is
factorized by a downward block elimination.

Blocks are stacked batch first: ``diag (B, K, n, n)``, ``lower (B, K-1, n,
n)`` (the sub-diagonal), ``rhs (B, K, n)``. The matrix is ``[[D0, L0ᵀ, ...],
[L0, D1, L1ᵀ, ...], ...]``. Its diagonal blocks are indefinite (a saddle
point), so each block solve is an LU solve (``torch.linalg.solve_ex``,
which does not stop to check the factorization on the host); K is only
2·legs, so the elimination's sequential depth is short.

The factorization is separate from the solve so that iterative refinement
re-solves on the residual without eliminating again, and so that the
parallel solver can fold θ-feedback into the first stage's state feedback
with the recorded ``W`` factors (``∂x_{k+1}/∂x_k = -W_k`` along the chain).
"""

from __future__ import annotations

import torch
from torch import Tensor

from .._linalg import mtv, mv


def _lu_solve(A: Tensor, B: Tensor) -> Tensor:
    return torch.linalg.solve_ex(A, B)[0]


def factorize(diag: Tensor, lower: Tensor):
    """Downward block elimination from block K-1 to 0: ``D̃_{K-1} = D_{K-1}``,
    ``D̃_k = D_k - L_kᵀ D̃_{k+1}⁻¹ L_k``. Returns ``(Dt0, Dts, Ws)``: ``Dt0
    (B, n, n)``, ``Dts[:, k] = D̃_{k+1}`` and ``Ws[:, k] = D̃_{k+1}⁻¹ L_k``
    for k = 0..K-2 (``(B, K-1, n, n)`` each)."""
    K = diag.shape[1]
    Dt = diag[:, K - 1]
    Dts, Ws = [], []
    for k in range(K - 2, -1, -1):
        L_k = lower[:, k]
        W = _lu_solve(Dt, L_k)
        Dts.append(Dt)
        Ws.append(W)
        Dt = diag[:, k] - L_k.mT @ W
    if K == 1:
        empty = diag[:, :0]
        return Dt, empty, empty
    return Dt, torch.stack(Dts[::-1], 1), torch.stack(Ws[::-1], 1)


def solve_factored(factors, rhs: Tensor) -> Tensor:
    """Solve with a :func:`factorize` result. Returns ``x (B, K, n)``."""
    Dt0, Dts, Ws = factors
    K = rhs.shape[1]
    # b̃_{K-1} = b_{K-1}; b̃_k = b_k - W_kᵀ b̃_{k+1} (D̃ symmetric)
    bts = [None] * K
    bts[K - 1] = rhs[:, K - 1]
    for k in range(K - 2, -1, -1):
        bts[k] = rhs[:, k] - mtv(Ws[:, k], bts[k + 1])
    x = _lu_solve(Dt0, bts[0])
    xs = [x]
    for k in range(K - 1):
        x = _lu_solve(Dts[:, k], bts[k + 1]) - mv(Ws[:, k], x)
        xs.append(x)
    return torch.stack(xs, 1)


def matmul(diag: Tensor, lower: Tensor, x: Tensor) -> Tensor:
    """``y = T x`` for the symmetric block-tridiagonal ``T``."""
    y = mv(diag, x)
    y[:, 1:] += mv(lower, x[:, :-1])
    y[:, :-1] += mtv(lower, x[:, 1:])
    return y


def solve(diag: Tensor, lower: Tensor, rhs: Tensor,
          refine_steps: int = 0) -> Tensor:
    """Solve the symmetric block-tridiagonal systems; ``refine_steps``
    iterative-refinement passes reuse the factorization. Returns ``x (B, K,
    n)``."""
    factors = factorize(diag, lower)
    x = solve_factored(factors, rhs)
    for _ in range(refine_steps):
        x = x + solve_factored(factors, rhs - matmul(diag, lower, x))
    return x
