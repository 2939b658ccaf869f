"""Fused batched proximal-Riccati solve: CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``aligator_tpu/gar/pallas_riccati.py``
(``_kernel``, entry point ``solve``). :func:`solve` takes a batch of LQ
problems and returns the solution and the per-stage gains:

* for CUDA tensors it packs the knots batch-minor, launches the kernel of
  ``csrc/fused_riccati.cu`` (one thread per scenario, the whole solve in one
  launch) and unpacks the outputs; a shape the kernel is not instantiated
  for raises;
* for CPU tensors it runs :func:`solve_plain`, the plain PyTorch backward,
  initial and forward solve of :mod:`.riccati`, which computes the same
  function.

``LAUNCHES`` counts kernel launches made by :func:`solve`.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .. import _build
from . import riccati
from .lqr_problem import LQRProblem, batch_param

LAUNCHES = 0

# (nx, nu, nc, explicit E) the kernel is instantiated for; keep in sync with
# launch() in csrc/fused_riccati.cu
KERNEL_SHAPES = frozenset({
    (3, 2, 0, False),  # SE(2) car
    (3, 2, 2, False),  # SE(2) car with control bounds
    (3, 2, 1, True),
    (4, 2, 0, True),
    (4, 2, 2, False),
})
_SOURCE = "fused_riccati"
_C_FUNCS = {torch.float32: "fused_riccati_f32", torch.float64: "fused_riccati_f64"}


def available(problem: LQRProblem) -> bool:
    """Whether the problem lies in the fused solve's domain: a full-state
    initial condition and small dims (the JAX gate ``pallas_riccati.available``
    without its TPU, fp32 and 128-lane terms)."""
    return problem.nc0 == problem.nx and problem.nx <= 8 and problem.nu <= 8


def field_layout(nx: int, nu: int, nc: int, explicit: bool):
    """Offsets of the knot fields in the packed feature axis and its size."""
    sizes = dict(Q=nx * nx, S=nx * nu, R=nu * nu, q=nx, r=nu, A=nx * nx,
                 B=nx * nu, f=nx, C=nc * nx, D=nc * nu, d=nc)
    if not explicit:
        sizes["E"] = nx * nx
    return _offsets(sizes)


def gain_layout(nx: int, nu: int, nc: int):
    return _offsets(dict(kff=nu, K=nu * nx, zff=nc, Z=nc * nx, lff=nx,
                         L=nx * nx, yff=nx, Afb=nx * nx))


def out_layout(nx: int, nu: int, nc: int):
    return _offsets(dict(xs=nx, us=nu, vs=nc, lams=nx))


def _offsets(sizes: dict):
    offs, cur = {}, 0
    for k, v in sizes.items():
        offs[k] = (cur, v)
        cur += v
    return offs, cur


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
    dev = problem.knots.Q.device
    if dev.type == "cpu":
        return solve_plain(problem, mudyn, mueq, assume_explicit)
    if dev.type != "cuda":
        raise ValueError(f"fused_riccati.solve: unsupported device {dev}")
    packed = pack(problem, mudyn, mueq, assume_explicit)
    out, gains = launch(*packed, problem, assume_explicit)
    return unpack(problem, out, gains)


def _check(problem: LQRProblem, assume_explicit: bool):
    kn = problem.knots
    key = (kn.nx, kn.nu, kn.nc, bool(assume_explicit))
    if key not in KERNEL_SHAPES:
        raise ValueError(
            f"fused_riccati kernel has no instance for (nx, nu, nc, explicit) "
            f"= {key}; instantiated: {sorted(KERNEL_SHAPES)}"
        )
    if problem.nc0 != kn.nx:
        raise ValueError("fused_riccati kernel needs nc0 == nx")
    if kn.Q.dtype not in _C_FUNCS:
        raise ValueError(f"fused_riccati kernel takes float32/float64, got {kn.Q.dtype}")


def pack(problem: LQRProblem, mudyn, mueq, assume_explicit: bool = True):
    """Pack knots into a batch-minor ``(T, F, B)`` buffer, ``G0|g0`` into
    ``(nx*nx + nx, B)`` and ``mudyn|mueq`` into ``(2, B)``."""
    _check(problem, assume_explicit)
    kn = problem.knots
    Bsz, T, nx = kn.batch, kn.horizon + 1, kn.nx
    offs, F = field_layout(nx, kn.nu, kn.nc, assume_explicit)
    feats = kn.Q.new_empty((T, F, Bsz))
    for name, (o, n) in offs.items():
        feats[:, o:o + n].copy_(getattr(kn, name).reshape(Bsz, T, n).permute(1, 2, 0))
    g0f = kn.Q.new_empty((nx * nx + nx, Bsz))
    g0f[:nx * nx].copy_(problem.G0.reshape(Bsz, nx * nx).mT)
    g0f[nx * nx:].copy_(problem.g0.mT)
    mu = torch.stack([batch_param(mudyn, problem), batch_param(mueq, problem)])
    return feats, g0f, mu


def launch(feats: Tensor, g0f: Tensor, mu: Tensor, problem: LQRProblem,
           assume_explicit: bool = True):
    """Launch the kernel on packed inputs; returns the batch-minor solution
    ``(T, OF, B)`` and gains ``(T, G, B)``."""
    global LAUNCHES
    _check(problem, assume_explicit)
    kn = problem.knots
    Bsz, T, nx, nu, nc = kn.batch, kn.horizon + 1, kn.nx, kn.nu, kn.nc
    F = field_layout(nx, nu, nc, assume_explicit)[1]
    G = gain_layout(nx, nu, nc)[1]
    OF = out_layout(nx, nu, nc)[1]
    dt, dev = kn.Q.dtype, kn.Q.device
    for name, t, shape in (("feats", feats, (T, F, Bsz)),
                           ("g0", g0f, (nx * nx + nx, Bsz)), ("mu", mu, (2, Bsz))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"fused_riccati: {name} must be a contiguous {dt} tensor of "
                f"shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}"
            )
    out = torch.empty((T, OF, Bsz), dtype=dt, device=dev)
    gains = torch.empty((T, G, Bsz), dtype=dt, device=dev)
    if Bsz == 0:
        return out, gains
    fn = _build.c_function(_SOURCE, _C_FUNCS[dt], 6, 6)
    _build.run(fn, dev, nx, nu, nc, int(bool(assume_explicit)), Bsz, T,
               feats.data_ptr(), g0f.data_ptr(), mu.data_ptr(),
               out.data_ptr(), gains.data_ptr(), what="fused_riccati")
    LAUNCHES += 1
    return out, gains


def unpack(problem: LQRProblem, out: Tensor, gains: Tensor):
    """Views ``(B, T, ·)`` of the batch-minor kernel outputs; returns
    ``(xs, us, vs, lams, gains)`` as :func:`solve` does."""
    kn = problem.knots
    nx, nu, nc = kn.nx, kn.nu, kn.nc
    shapes = dict(K=(nu, nx), Z=(nc, nx), L=(nx, nx), Afb=(nx, nx))

    def field(buf, o, n, shape=None):
        v = buf[:, o:o + n].permute(2, 0, 1)
        return v if shape is None else v.unflatten(-1, shape)

    ooffs = out_layout(nx, nu, nc)[0]
    sol = tuple(field(out, *ooffs[k]) for k in ("xs", "us", "vs", "lams"))
    goffs = gain_layout(nx, nu, nc)[0]
    g = {k: field(gains, o, n, shapes.get(k)) for k, (o, n) in goffs.items()}
    return (*sol, g)
