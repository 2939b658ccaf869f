"""Batched small-matrix helpers shared by the port's modules."""

from __future__ import annotations

from torch import Tensor


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
