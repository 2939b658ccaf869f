"""Fused batched proximal-Riccati solve: CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``aligator_tpu/gar/pallas_riccati.py``
(``_kernel``, entry point ``solve``). :func:`solve` takes a batch of LQ
problems and returns the solution and the per-stage gains:

* for CUDA tensors it launches the kernel of ``csrc/fused_riccati.cu``
  once (:func:`launch`): the kernel reads each knot field where it lies, a
  contiguous ``(B, T, ·)`` tensor, and writes the solution and the gains
  into contiguous ``(B, T, ·)`` tensors. It is built for each shape
  ``(nx, nu, nc, explicit E)`` at the shape's first launch (a library a
  shape, :func:`variant`), so every problem of the domain
  (:func:`available`) launches it;
* for CPU tensors it runs :func:`solve_plain`, the plain PyTorch backward,
  initial and forward solve of :mod:`.riccati`, which computes the same
  function.

Launches count in ``_build.LAUNCHES["fused_riccati"]``.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from .. import _build
from . import riccati
from .lqr_problem import LQRProblem, batch_param

MAX_NX = MAX_NU = 8
# (nx, nu, nc, explicit E) that sample the domain: the examples' shapes
# (lqr.py with u_bound, linear_euler.py, cartpole with RK2 and with the
# implicit midpoint rule), the SE(2) car with and without control bounds,
# and the corners nx = nu = 8 with a state and control box (nc = 2 (nx +
# nu)); the card tests and chip_smoke.py build and check each
DOMAIN_SAMPLES = (
    (1, 1, 0, True), (2, 1, 1, True), (2, 2, 0, True), (4, 1, 1, True),
    (4, 1, 1, False), (3, 2, 0, False), (3, 2, 2, False), (4, 2, 2, False),
    (5, 3, 0, True), (8, 8, 16, False), (8, 8, 32, True),
)
# the kernel's pointer order: knots, initial condition and mu, then the
# solution and the gains
KNOT_FIELDS = ("Q", "S", "R", "q", "r", "A", "B", "f", "C", "D", "d", "E")
SOLUTION_FIELDS = ("xs", "us", "vs", "lams")
_SOURCE = "fused_riccati"
_C_FUNCS = {torch.float32: "fused_riccati_f32", torch.float64: "fused_riccati_f64"}


def available(problem: LQRProblem) -> bool:
    """Whether the problem lies in the fused solve's domain: a full-state
    initial condition, ``1 <= nx <= 8`` and ``1 <= nu <= 8``, any ``nc``,
    and no parametric θ blocks (``nth == 0``). This is the JAX gate
    ``pallas_riccati.available`` without its TPU terms."""
    return (problem.nc0 == problem.nx and 1 <= problem.nx <= MAX_NX
            and 1 <= problem.nu <= MAX_NU and problem.nth == 0)


def variant(nx: int, nu: int, nc: int, explicit: bool):
    """The build variant (``_build``) of the kernel for one shape."""
    return _SOURCE, (f"K1_NX={nx}", f"K1_NU={nu}", f"K1_NC={nc}",
                     f"K1_EXPLICIT={int(bool(explicit))}")


def solve_plain(problem: LQRProblem, mudyn, mueq,
                assume_explicit: bool = True):
    """Plain PyTorch version of the fused solve, on any device. Returns
    ``(xs, us, vs, lams, gains)`` like :func:`solve`."""
    factors = riccati.backward_plain(problem, mudyn, mueq, assume_explicit)
    return (*riccati.forward_plain(factors), factors.gains())


def solve(problem: LQRProblem, mudyn, mueq, assume_explicit: bool = True):
    """Fused solve of a batch of LQ problems.

    ``mudyn``/``mueq`` are floats or per-scenario ``(B,)`` tensors. Returns
    ``(xs, us, vs, lams, gains)``: ``(B, T, ·)`` solutions and the per-stage
    gains ``kff K zff Z lff L yff Afb`` (zero ``lff L yff Afb`` at index N).
    CPU tensors take :func:`solve_plain`; CUDA tensors take the kernel.
    """
    if problem.knots.Q.device.type == "cpu":
        return solve_plain(problem, mudyn, mueq, assume_explicit)
    return launch(problem, mudyn, mueq, assume_explicit)


def _check(problem: LQRProblem, assume_explicit: bool):
    kn = problem.knots
    if not available(problem):
        raise ValueError(
            f"fused_riccati kernel: (nx, nu, nc0) = ({kn.nx}, {kn.nu}, "
            f"{problem.nc0}) is outside its domain (nc0 == nx, 1 <= nx <= "
            f"{MAX_NX}, 1 <= nu <= {MAX_NU})"
        )
    dt, dev = kn.Q.dtype, kn.Q.device
    if dt not in _C_FUNCS:
        raise ValueError(f"fused_riccati kernel takes float32/float64, got {dt}")
    nx, nu, nc, bt = kn.nx, kn.nu, kn.nc, (kn.batch, kn.horizon + 1)
    shapes = dict(Q=bt + (nx, nx), S=bt + (nx, nu), R=bt + (nu, nu), q=bt + (nx,),
                  r=bt + (nu,), A=bt + (nx, nx), B=bt + (nx, nu), f=bt + (nx,),
                  C=bt + (nc, nx), D=bt + (nc, nu), d=bt + (nc,), E=bt + (nx, nx))
    if assume_explicit:
        del shapes["E"]
    tensors = {f: getattr(kn, f) for f in shapes}
    tensors.update(G0=problem.G0, g0=problem.g0)
    shapes.update(G0=(kn.batch, nx, nx), g0=(kn.batch, nx))
    for name, t in tensors.items():
        if t.dtype != dt or t.device != dev or tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"fused_riccati: {name} must be a {dt} tensor of shape "
                f"{shapes[name]} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def _copy(t: Tensor) -> Tensor:
    return t.contiguous()


def _contiguous(t: Tensor) -> Tensor:
    return t if t.is_contiguous() else _copy(t)


def kernel_io(problem: LQRProblem, mudyn, mueq, assume_explicit: bool = True):
    """The tensors one launch reads and writes, on the problem's device:
    ``(inputs, strides, outputs)``. The knots are passed as they are where
    contiguous (copied otherwise; E is not read with explicit dynamics),
    ``G0``, ``g0`` and the per-scenario mu as they are, with their strides;
    the outputs are views of one new buffer, each a contiguous
    ``(B, T, ·)`` tensor, solution first, then the gains."""
    _check(problem, assume_explicit)
    kn = problem.knots
    Bsz, T, nx, nu, nc = kn.batch, kn.horizon + 1, kn.nx, kn.nu, kn.nc
    knots = [getattr(kn, f) if f == "E" and assume_explicit
             else _contiguous(getattr(kn, f)) for f in KNOT_FIELDS]
    rows = [problem.G0, problem.g0, batch_param(mudyn, problem),
            batch_param(mueq, problem)]
    shapes = dict(xs=(nx,), us=(nu,), vs=(nc,), lams=(nx,), kff=(nu,),
                  K=(nu, nx), zff=(nc,), Z=(nc, nx), lff=(nx,), L=(nx, nx),
                  yff=(nx,), Afb=(nx, nx))
    sizes = [Bsz * T * torch.Size(s).numel() for s in shapes.values()]
    buf = kn.Q.new_empty(sum(sizes))
    outs = {k: v.view((Bsz, T) + s) for (k, s), v in
            zip(shapes.items(), buf.split(sizes))}
    return knots + rows, [s for t in rows for s in t.stride()], outs


def launch(problem: LQRProblem, mudyn, mueq, assume_explicit: bool = True):
    """One kernel launch on CUDA tensors, returning what :func:`solve`
    returns. Raises ``ValueError`` for a problem outside the kernel's
    domain, a type other than float32/float64 or tensors off the card."""
    ins, strides, outs = kernel_io(problem, mudyn, mueq, assume_explicit)
    kn = problem.knots
    dev = kn.Q.device
    if dev.type != "cuda":
        raise ValueError(f"fused_riccati kernel: tensors on {dev}, not a CUDA device")
    if kn.batch:
        name, defines = variant(kn.nx, kn.nu, kn.nc, assume_explicit)
        fn = _build.c_function(name, _C_FUNCS[kn.Q.dtype], 6, 3, defines)
        ptrs = (ctypes.c_void_p * 28)(*(t.data_ptr() for t in ins),
                                       *(t.data_ptr() for t in outs.values()))
        _build.run(fn, dev, kn.nx, kn.nu, kn.nc, int(bool(assume_explicit)),
                   kn.batch, kn.horizon + 1, ptrs, (ctypes.c_longlong * 7)(*strides),
                   kernel="fused_riccati")
    sol = tuple(outs.pop(k) for k in SOLUTION_FIELDS)
    return (*sol, outs)
