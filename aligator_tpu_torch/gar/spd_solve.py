"""Batched SPD solve: CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``aligator_tpu/gar/pallas_spd.py``
(``_spd_kernel``, entry point ``spd_solve_lanes``). :func:`spd_solve` solves
``A X = R`` for a batch of symmetric positive definite systems, ``A (..., n,
n)`` and ``R (..., n, r)``:

* CPU tensors take :func:`spd_solve_plain` (torch Cholesky);
* CUDA tensors take the kernel of ``csrc/spd_solve.cu`` (one thread block
  per system and group of at most 128 right-hand sides), for any ``n`` and
  ``r`` in float32 or float64; anything else raises. The kernel eliminates
  by block Cholesky with the tiles in registers up to n = 64, past that by
  scalar Cholesky in shared memory or, where [W | Y] does not fit there, in
  a global-memory workspace that :func:`launch` allocates; each backward
  stable on nearly singular systems (the Delassus matrix of redundant
  contacts) as a Cholesky solve is.

A system whose factorization fails (A not positive definite) gives NaN in
its own solution only. The callers are the Schur and reduced-KKT solves of
the per-stage Riccati loop (:mod:`.riccati`), the Quu solve of FDDP and the
contact-KKT solves of the multibody derivatives (mass matrix and Delassus
matrix against 3 nv right-hand sides, in one launch each so that each
matrix is factored once).

:func:`spd_solve_diff` is the differentiable solve (the JAX package's
``gar/riccati.py`` ``spd_solve_dispatch``, a ``lax.custom_linear_solve``):
a ``torch.autograd.Function`` whose forward is :func:`spd_solve` and whose
tangents are implicit, Ẋ = A⁻¹(Ṙ − Ȧ X) in forward mode and R̄ = A⁻¹ X̄,
Ā = −R̄ Xᵀ in reverse mode (A is symmetric: the transpose solve is the same
solve), each through :func:`spd_solve` again, so that on the card every
tangent solve is a K2 launch. Under ``vmap`` (``torch.func.jacfwd``) a
batch of tangents over one A is folded into the columns of R, one launch
for all directions. Launches count in ``_build.LAUNCHES["spd_solve"]``.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from .. import _build
from .._linalg import chol_solve

# keep in sync with kMaxR in csrc/spd_solve.cu: a block takes up to 128
# right-hand sides, a wider R is split over blocks
MAX_R = 128
_SOURCE = "spd_solve"
_C_FUNCS = {torch.float32: "spd_solve_f32", torch.float64: "spd_solve_f64"}


def spd_solve_plain(A: Tensor, R: Tensor) -> Tensor:
    """Plain PyTorch version: Cholesky of the lower triangle, NaN for a
    system whose factorization fails."""
    return chol_solve(A, R)


def spd_solve(A: Tensor, R: Tensor) -> Tensor:
    """Solve ``A X = R`` for SPD ``A``; CPU tensors take
    :func:`spd_solve_plain`, CUDA tensors the kernel."""
    dev = A.device
    if dev.type == "cpu":
        return spd_solve_plain(A, R)
    if dev.type != "cuda":
        raise ValueError(f"spd_solve: unsupported device {dev}")
    return launch(A, R)


def spd_solve_diff(A: Tensor, R: Tensor) -> Tensor:
    """:func:`spd_solve`, differentiable in ``A`` and ``R`` with implicit
    tangents; ``A (..., n, n)`` and ``R (..., n, r)`` broadcast over their
    leading dims."""
    return _SPDSolve.apply(A, R)


class _SPDSolve(torch.autograd.Function):
    """The values of :func:`spd_solve`; its tangents by the same solve."""

    @staticmethod
    def forward(A, R):
        lead = torch.broadcast_shapes(A.shape[:-2], R.shape[:-2])
        return spd_solve(A.expand(lead + A.shape[-2:]), R.expand(lead + R.shape[-2:]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, R = inputs
        ctx.save_for_backward(A, R, output)
        ctx.save_for_forward(A, output)

    @staticmethod
    def jvp(ctx, dA, dR):
        A, X = ctx.saved_tensors
        rhs = torch.zeros_like(X) if dR is None else dR
        if dA is not None:
            rhs = rhs - dA @ X
        return _SPDSolve.apply(A, rhs)

    @staticmethod
    def backward(ctx, gX):
        A, R, X = ctx.saved_tensors
        gR = _SPDSolve.apply(A, gX)
        gA = -gR @ X.mT
        return gA.sum_to_size(A.shape), gR.sum_to_size(R.shape)

    @staticmethod
    def vmap(info, in_dims, A, R):
        da, dr = in_dims
        if da is None:
            # one A for every tangent: the batch becomes more columns of R
            R = R.movedim(dr, -1)
            X = _SPDSolve.apply(A, R.reshape(R.shape[:-2] + (-1,)))
            return X.reshape(R.shape).movedim(-1, 0), 0
        A = A.movedim(da, 0)
        R = R.unsqueeze(0) if dr is None else R.movedim(dr, 0)
        rank = max(A.dim(), R.dim())

        def lift(x):
            return x.reshape(x.shape[:1] + (1,) * (rank - x.dim()) + x.shape[1:])

        return _SPDSolve.apply(lift(A), lift(R)), 0


def launch(A: Tensor, R: Tensor) -> Tensor:
    """Launch the kernel on ``A (..., n, n)``, ``R (..., n, r)`` (values
    only: :func:`spd_solve_diff` differentiates)."""
    n, r = R.shape[-2], R.shape[-1]
    lead = R.shape[:-2]
    if A.shape != lead + (n, n):
        raise ValueError(f"spd_solve: A {tuple(A.shape)} does not match R "
                         f"{tuple(R.shape)}")
    if A.device != R.device or A.dtype != R.dtype or A.dtype not in _C_FUNCS:
        raise ValueError(
            f"spd_solve kernel takes float32/float64 A and R on one device, "
            f"got {A.dtype} on {A.device} and {R.dtype} on {R.device}"
        )
    if n < 1:
        raise ValueError(f"spd_solve kernel takes n >= 1, got n={n}")
    if (torch.is_grad_enabled() and (A.requires_grad or R.requires_grad)) or \
            torch._C._functorch.is_functorch_wrapped_tensor(A) or \
            torch._C._functorch.is_functorch_wrapped_tensor(R):
        raise ValueError("spd_solve kernel computes values only: differentiate "
                         "spd_solve_diff instead")
    X = torch.empty_like(R, memory_format=torch.contiguous_format)
    M = X.numel() // (n * r) if r else 0
    if M == 0:
        return X
    A = A.contiguous()
    R = R.contiguous()
    size = _build.load(_SOURCE).spd_solve_workspace
    size.restype = ctypes.c_longlong
    size.argtypes = [ctypes.c_int] * 4
    nbytes = size(M, n, r, A.element_size())
    # the global-memory route's workspace, a slice of [W | Y] a block
    work = A.new_empty((nbytes // A.element_size(),)) if nbytes else None
    fn = _build.c_function(_SOURCE, _C_FUNCS[A.dtype], 3, 5)
    _build.run(fn, A.device, M, n, r, A.data_ptr(), R.data_ptr(), X.data_ptr(),
               0 if work is None else work.data_ptr(), kernel="spd_solve")
    return X
