"""Batched SPD solve: CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``aligator_tpu/gar/pallas_spd.py``
(``_spd_kernel``, entry point ``spd_solve_lanes``). :func:`spd_solve` solves
``A X = R`` for a batch of symmetric positive definite systems, ``A (..., n,
n)`` and ``R (..., n, r)``:

* CPU tensors take :func:`spd_solve_plain` (torch Cholesky);
* CUDA tensors take the kernel of ``csrc/spd_solve.cu`` (one thread block
  per system), for ``n, r <= MAX_DIM`` in float32 or float64; anything
  else raises.

A system whose factorization fails (A not positive definite) gives NaN in
its own solution only. The callers are the Schur and reduced-KKT solves of
the per-stage Riccati loop (:mod:`.riccati`) and the Quu solve of FDDP.
``LAUNCHES`` counts kernel launches made by :func:`spd_solve`.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .. import _build
from .._linalg import chol_solve

LAUNCHES = 0
MAX_DIM = 64  # keep in sync with kMaxDim in csrc/spd_solve.cu
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


def launch(A: Tensor, R: Tensor) -> Tensor:
    """Launch the kernel on ``A (..., n, n)``, ``R (..., n, r)``."""
    global LAUNCHES
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
    if not (1 <= n <= MAX_DIM and r <= MAX_DIM):
        raise ValueError(f"spd_solve kernel takes n, r <= {MAX_DIM}, got "
                         f"n={n}, r={r}")
    X = torch.empty_like(R, memory_format=torch.contiguous_format)
    M = X.numel() // (n * r) if r else 0
    if M == 0:
        return X
    A = A.contiguous()
    R = R.contiguous()
    fn = _build.c_function(_SOURCE, _C_FUNCS[A.dtype], 3, 4)
    _build.run(fn, A.device, M, n, r, A.data_ptr(), R.data_ptr(),
               X.data_ptr(), what="spd_solve")
    LAUNCHES += 1
    return X
