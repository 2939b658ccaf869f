"""Medium-dim Riccati sweeps: CUDA kernels K3 and K4 and their plain versions.

Replaces two Pallas TPU kernels of ``aligator_tpu/gar/pallas_stage.py``:

* ``_stage_kernel`` (K3, entry point ``sweep_lanes``): one backward stage of
  the proximal Riccati recursion with explicit dynamics (E = -I) and
  per-scenario μ. :func:`stage` is one stage, :func:`sweep` the N stages of
  a horizon, in one launch that keeps the value function on chip;
* ``_fwd_kernel`` (K4, entry point ``forward_lanes``): the forward
  substitution ``u = kff + K x``, ``v = zff + Z x``, ``λ⁺ = lff + L x``,
  ``x⁺ = yff + A_fb x`` over the horizon (:func:`forward`).

K3 keeps the TPU kernel's own arithmetic, which differs from the loop of
:mod:`.riccati` by roundoff: Ŝᵀ is formed as ``Sᵀ + BᵀV·A`` apart from
``Ŝ = S + AᵀV·B``, nothing is symmetrized inside a stage, and the carried
value Hessian is symmetrized after each stage.

CPU tensors take the ``*_plain`` versions; CUDA tensors take the kernels of
``csrc/fused_stage.cu`` (float32 or float64) or raise. ``STAGE_LAUNCHES``
and ``FORWARD_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from .. import _build
from .._linalg import chol_solve, mv
from .lqr_problem import LQRKnots

STAGE_LAUNCHES = 0
FORWARD_LAUNCHES = 0
# the dimension bounds of pallas_stage.fused_stage_eligible /
# fwd_lanes_eligible, kept so that each shape runs the same kernel as in the
# JAX package
MIN_NX, MAX_NX = 12, 44
STAGE_FIELDS = ("Q", "S", "R", "q", "r", "A", "B", "f", "C", "D", "d")
FACTOR_FIELDS = ("kff", "K", "zff", "Z", "lff", "L", "yff", "Afb", "Pmat",
                 "pvec")
_SOURCE = "fused_stage"
_SWEEP = {torch.float32: "fused_sweep_f32", torch.float64: "fused_sweep_f64"}
_FORWARD = {torch.float32: "fused_forward_f32",
            torch.float64: "fused_forward_f64"}


def sweep_eligible(nx: int, nu: int, assume_explicit: bool) -> bool:
    """Whether the backward sweep goes to K3: explicit dynamics and
    ``MIN_NX <= nx <= MAX_NX``."""
    return bool(assume_explicit) and MIN_NX <= nx <= MAX_NX and nu >= 1


def forward_eligible(nx: int, nu: int) -> bool:
    """Whether the forward substitution goes to K4: ``nx >= MIN_NX``."""
    return nx >= MIN_NX and nu >= 1


# ---------------------------------------------------------------- K3


def stage_plain(knot: dict, P: Tensor, p: Tensor, mudyn: Tensor,
                mueq: Tensor) -> dict:
    """Plain version of one K3 stage. ``knot`` holds the stage's ``Q S R q r
    A B f C D d`` as ``(B, ...)`` tensors, ``P (B, nx, nx)`` and ``p (B,
    nx)`` the next stage's value function, ``mudyn``/``mueq`` ``(B,)``.
    Returns the stage's gains and its symmetrized value ``Pmat``, ``pvec``."""
    Q, S, R, q, r = (knot[k] for k in ("Q", "S", "R", "q", "r"))
    A, Bm, f = knot["A"], knot["B"], knot["f"]
    C, D, d = knot["C"], knot["D"], knot["d"]
    md, me = mudyn[:, None, None], mueq[:, None, None]
    nx = P.shape[-1]
    eye = torch.eye(nx, dtype=P.dtype, device=P.device)

    sol = chol_solve(eye + md * P, torch.cat([P, (p + mv(P, f))[..., None]], -1))
    Vxx = sol[..., :nx]
    AtVf = A.mT @ sol  # [AᵀV | Aᵀvx]
    BtVf = Bm.mT @ sol
    AtV, BtV = AtVf[..., :nx], BtVf[..., :nx]
    Qhat = Q + AtV @ A
    Rhat = R + BtV @ Bm
    Shat = S + AtV @ Bm
    ShatT = S.mT + BtV @ A
    qhat = q + AtVf[..., nx]
    rhat = r + BtVf[..., nx]

    W = Rhat + (D.mT @ D) / me
    rhs = torch.cat([(rhat + mv(D.mT, d) / me[..., 0])[..., None],
                     ShatT + (D.mT @ C) / me], -1)
    U = chol_solve(W, -rhs)  # [kff | K]
    Zc = (D @ U + torch.cat([d[..., None], C], -1)) / me  # [zff | Z]

    pan1 = Bm @ U
    pan2 = Vxx @ pan1
    lff = sol[..., nx] + pan2[..., 0]
    L = Vxx @ A + pan2[..., 1:]
    yff = f + pan1[..., 0] - md[..., 0] * lff
    Afb = A + pan1[..., 1:] - md * L

    pan1 = Shat @ U
    Pc = Qhat + pan1[..., 1:] + C.mT @ Zc[..., 1:]
    pc = qhat + pan1[..., 0] + mv(C.mT, Zc[..., 0])
    return dict(kff=U[..., 0], K=U[..., 1:], zff=Zc[..., 0], Z=Zc[..., 1:],
                lff=lff, L=L, yff=yff, Afb=Afb, Pmat=0.5 * (Pc + Pc.mT),
                pvec=pc)


def factor_buffers(Q: Tensor, n_stages: int, nu: int, nc: int) -> dict:
    """Factor tensors ``(B, T, ...)`` shaped after the knots' ``Q (B, T, nx,
    nx)``: uninitialized at the ``n_stages`` stages a sweep writes, zero
    after them."""
    Bsz, T, nx = Q.shape[:3]
    shapes = dict(kff=(nu,), K=(nu, nx), zff=(nc,), Z=(nc, nx), lff=(nx,),
                  L=(nx, nx), yff=(nx,), Afb=(nx, nx), Pmat=(nx, nx),
                  pvec=(nx,))
    out = {k: Q.new_empty((Bsz, T) + s) for k, s in shapes.items()}
    for v in out.values():
        v[:, n_stages:].zero_()
    return out


def sweep_plain(kn: LQRKnots, P: Tensor, p: Tensor, mudyn: Tensor,
                mueq: Tensor) -> dict:
    """Plain version of :func:`sweep`."""
    out = factor_buffers(kn.Q, kn.horizon, kn.nu, kn.nc)
    for t in range(kn.horizon - 1, -1, -1):
        st = stage_plain({k: getattr(kn, k)[:, t] for k in STAGE_FIELDS},
                         P, p, mudyn, mueq)
        for k in FACTOR_FIELDS:
            out[k][:, t] = st[k]
        P, p = st["Pmat"], st["pvec"]
    return out


def sweep(kn: LQRKnots, P: Tensor, p: Tensor, mudyn: Tensor,
          mueq: Tensor) -> dict:
    """Backward sweep over the stages ``N-1 .. 0`` of the knots (no terminal
    stage), from the value function ``P (B, nx, nx)``, ``p (B, nx)`` after
    the last stage; ``mudyn``/``mueq`` are ``(B,)``. Returns the factors
    ``kff K zff Z lff L yff Afb Pmat pvec`` as ``(B, T, ...)`` tensors, zero
    at index N. CPU tensors take :func:`sweep_plain`, CUDA tensors one K3
    launch."""
    dev = kn.Q.device
    if dev.type == "cpu":
        return sweep_plain(kn, P, p, mudyn, mueq)
    if dev.type != "cuda":
        raise ValueError(f"fused_stage.sweep: unsupported device {dev}")
    fields = {k: getattr(kn, k) for k in STAGE_FIELDS}
    out = factor_buffers(kn.Q, kn.horizon, kn.nu, kn.nc)
    _launch_sweep(fields, kn.horizon, P, p, mudyn, mueq, out)
    return out


def stage(knot: dict, P: Tensor, p: Tensor, mudyn: Tensor,
          mueq: Tensor) -> dict:
    """One K3 stage (arguments and result as :func:`stage_plain`); CUDA
    tensors take one launch of the sweep kernel over a one-stage horizon."""
    dev = P.device
    if dev.type == "cpu":
        return stage_plain(knot, P, p, mudyn, mueq)
    if dev.type != "cuda":
        raise ValueError(f"fused_stage.stage: unsupported device {dev}")
    fields = {k: knot[k][:, None] for k in STAGE_FIELDS}
    out = factor_buffers(fields["Q"], 1, knot["R"].shape[-1],
                          knot["C"].shape[-2])
    _launch_sweep(fields, 1, P, p, mudyn, mueq, out)
    return {k: v[:, 0] for k, v in out.items()}


def kernel_info(kernel: str, dtype, Bsz: int, T: int, nx: int, nu: int,
                nc: int, device="cuda") -> dict:
    """How a launch of ``kernel`` ("sweep": K3, "forward": K4) at these
    dimensions sits on the card: shared memory bytes a block, resident
    blocks per SM, registers a thread and threads a block (card only)."""
    if dtype not in _SWEEP:
        raise ValueError(f"fused_stage kernel takes float32/float64, got {dtype}")
    fn = _build.c_function(_SOURCE, "fused_stage_info", 7, 1)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = fn({"sweep": 0, "forward": 1}[kernel], int(dtype == torch.float64),
                 Bsz, T, nx, nu, nc, out)
    if err == -1:
        raise ValueError(f"fused_stage {kernel} kernel does not take these dimensions")
    if err != 0:
        raise RuntimeError(f"fused_stage_info failed: CUDA error {err}")
    return dict(zip(("smem_bytes", "blocks_per_sm", "registers", "threads"), out))


def _as_kernel_input(t: Tensor, dtype, device) -> Tensor:
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"fused_stage: expected {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    return t.contiguous()


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch_sweep(fields: dict, n_stages: int, P, p, mudyn, mueq,
                  out: dict) -> None:
    """One K3 launch over stages ``n_stages-1 .. 0`` of the knot ``fields``
    (``(B, T, ...)``), writing into the factor tensors ``out``."""
    global STAGE_LAUNCHES
    Q = fields["Q"]
    dt, dev = Q.dtype, Q.device
    Bsz, T, nx = Q.shape[:3]
    nu, nc = fields["R"].shape[-1], fields["C"].shape[-2]
    if dt not in _SWEEP:
        raise ValueError(f"fused_stage kernel takes float32/float64, got {dt}")
    if nu < 1:
        raise ValueError("fused_stage kernel needs nu >= 1")
    if Bsz == 0 or n_stages == 0:
        return
    ins = [_as_kernel_input(fields[k], dt, dev) for k in STAGE_FIELDS]
    ins += [_as_kernel_input(x, dt, dev) for x in (
        P, p, mudyn.expand(Bsz), mueq.expand(Bsz))]
    outs = [out[k] for k in FACTOR_FIELDS]
    fn = _build.c_function(_SOURCE, _SWEEP[dt], 6, 2)
    _build.run(fn, dev, Bsz, T, n_stages, nx, nu, nc, _pointers(ins + outs),
               what="fused_stage sweep")
    STAGE_LAUNCHES += 1


# ---------------------------------------------------------------- K4


def forward_plain(gains: dict, x0: Tensor, lam0: Tensor):
    """Plain version of :func:`forward`: :func:`forward_loop`."""
    return forward_loop(gains, x0, lam0)


def forward_loop(gains: dict, x0: Tensor, lam0: Tensor):
    """The forward substitution as a loop of batched PyTorch ops, on any
    device (arguments and result as :func:`forward`): K4's plain version,
    and the route of :func:`.riccati.forward` below K4's domain."""
    kff, K, zff, Z = gains["kff"], gains["K"], gains["zff"], gains["Z"]
    lff, L, yff, Afb = gains["lff"], gains["L"], gains["yff"], gains["Afb"]
    T = kff.shape[1]
    x = x0
    xs, us, vs, lams = [], [], [], [lam0]
    for t in range(T):
        xs.append(x)
        us.append(kff[:, t] + mv(K[:, t], x))
        vs.append(zff[:, t] + mv(Z[:, t], x))
        if t < T - 1:
            lams.append(lff[:, t] + mv(L[:, t], x))
            x = yff[:, t] + mv(Afb[:, t], x)
    return (torch.stack(xs, 1), torch.stack(us, 1), torch.stack(vs, 1),
            torch.stack(lams, 1))


def forward(gains: dict, x0: Tensor, lam0: Tensor):
    """Forward substitution over the horizon from ``x0 (B, nx)``, with the
    per-stage gains ``kff K zff Z lff L yff Afb`` (``(B, T, ...)``; the
    dynamics gains at index N are not read) and ``lam0 (B, nx)``. Returns
    ``(xs, us, vs, lams)``, each ``(B, T, ·)``. CPU tensors take
    :func:`forward_plain`, CUDA tensors one K4 launch."""
    dev = x0.device
    if dev.type == "cpu":
        return forward_plain(gains, x0, lam0)
    if dev.type != "cuda":
        raise ValueError(f"fused_stage.forward: unsupported device {dev}")
    global FORWARD_LAUNCHES
    dt = x0.dtype
    Bsz, T, nu, nx = gains["K"].shape
    nc = gains["Z"].shape[2]
    if dt not in _FORWARD:
        raise ValueError(f"fused_stage kernel takes float32/float64, got {dt}")
    if lam0.shape != (Bsz, nx):
        raise ValueError(f"fused_stage.forward: lam0 must be (B, nx), got "
                         f"{tuple(lam0.shape)}")
    names = ("kff", "K", "zff", "Z", "lff", "L", "yff", "Afb")
    ins = [_as_kernel_input(gains[k], dt, dev) for k in names]
    ins += [_as_kernel_input(x0, dt, dev), _as_kernel_input(lam0, dt, dev)]
    outs = [x0.new_empty((Bsz, T, k)) for k in (nx, nu, nc, nx)]
    if Bsz and T:
        fn = _build.c_function(_SOURCE, _FORWARD[dt], 5, 2)
        _build.run(fn, dev, Bsz, T, nx, nu, nc, _pointers(ins + outs),
                   what="fused_stage forward")
        FORWARD_LAUNCHES += 1
    return tuple(outs)
