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
