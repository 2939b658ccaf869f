"""Batched serial proximal Riccati solver (no parametric θ blocks).

PyTorch counterpart of ``aligator_tpu/gar/riccati.py``, one scenario per
batch entry where the JAX package runs a ``lax.scan`` under ``vmap``:

* the per-stage reduced KKT ``[[R̂, D'], [D, -μ_eq I]]`` is solved by Schur
  elimination of the multiplier, ``(R̂ + D'D/μ_eq) u = ...``, which is SPD
  thanks to the proximal term, so a Cholesky factorization suffices;
* implicit dynamics ``E x' + A x + B u + f = 0`` go through the Schur matrix
  ``I + μ_dyn·P̃`` with ``P̃ = E^{-T} P E^{-1}``; with ``assume_explicit``
  ``E = -I`` and the E-factorization is skipped.

Routing by shape, as the JAX package routes its batches to its kernels
(``riccati.py:394-506`` there, without the TPU terms):

* :func:`solve_and_gains`: problems in the small-dim fused solve's domain go
  to :mod:`.fused_riccati` (K1) whole;
* :func:`sweep` (the backward sweep): explicit dynamics with
  ``12 <= nx <= 44`` and a K3 block within the card's shared memory go to
  :func:`.fused_stage.sweep` (K3), the others to
  the per-stage loop of this module, whose Schur and reduced-KKT solves go
  through :func:`.spd_solve.spd_solve` (K2);
* :func:`forward`: ``nx >= 12`` goes to :func:`.fused_stage.forward` (K4),
  smaller problems to the PyTorch loop :func:`.fused_stage.forward_loop`.

Each kernel wrapper takes its plain PyTorch version for CPU tensors; a CUDA
tensor never reaches a ``*_plain`` function on these routes. The terminal
and initial-stage solves are torch Cholesky on every device, as the JAX
package computes them outside any kernel. :func:`backward_plain` and
:func:`forward_plain` are the plain PyTorch solve on every device (the
plain version of K1).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from .._linalg import chol_solve, mv
from . import fused_stage, spd_solve
from .lqr_problem import LQRKnots, LQRProblem, batch_param

GAIN_FIELDS = ("kff", "K", "zff", "Z", "lff", "L", "yff", "Afb")


@dataclass
class RiccatiFactors:
    """Per-stage gains and value function, shapes ``(B, T, ...)``; the
    dynamics-propagation gains ``lff, L, yff, Afb`` are zero at index N."""

    kff: Tensor  # (B, T, nu)
    K: Tensor  # (B, T, nu, nx)
    zff: Tensor  # (B, T, nc)
    Z: Tensor  # (B, T, nc, nx)
    lff: Tensor  # (B, T, nx)
    L: Tensor  # (B, T, nx, nx)
    yff: Tensor  # (B, T, nx)
    Afb: Tensor  # (B, T, nx, nx)
    Pmat: Tensor  # (B, T, nx, nx)
    pvec: Tensor  # (B, T, nx)
    x0: Tensor  # (B, nx)
    lam0: Tensor  # (B, nc0)

    def gains(self) -> dict:
        return {k: getattr(self, k) for k in GAIN_FIELDS}


def _sym(M: Tensor) -> Tensor:
    return 0.5 * (M + M.mT)


def _reduced_kkt_solve(Rhat, D, mueq, rhs_u_vec, rhs_c_vec, rhs_u_mat,
                       rhs_c_mat, spd=chol_solve):
    """Feedforward and feedback solves of ``[[R̂, D'], [D, -μ_eq I]]`` against
    one factorization by ``spd``. ``mueq`` is ``(B, 1, 1)``.
    Returns (u_vec, ν_vec, U_mat, NU_mat)."""
    W = Rhat + (D.mT @ D) / mueq
    Bu = torch.cat([rhs_u_vec[..., None], rhs_u_mat], -1)
    Bc = torch.cat([rhs_c_vec[..., None], rhs_c_mat], -1)
    U = spd(_sym(W), Bu + (D.mT @ Bc) / mueq)
    NU = (D @ U - Bc) / mueq
    return U[..., 0], NU[..., 0], U[..., 1:], NU[..., 1:]


def _terminal_solve(kn: LQRKnots, mueq: Tensor) -> dict:
    """Terminal-stage factor (reference terminalSolve)."""
    Q, S, R = kn.Q[:, -1], kn.S[:, -1], kn.R[:, -1]
    q, r = kn.q[:, -1], kn.r[:, -1]
    C, D, d = kn.C[:, -1], kn.D[:, -1], kn.d[:, -1]
    kff, zff, K, Z = _reduced_kkt_solve(R, D, mueq, -r, -d, -S.mT, -C)
    P = _sym(Q + C.mT @ Z + S @ K)
    p = q + mv(C.mT, zff) + mv(S, kff)
    return dict(kff=kff, K=K, zff=zff, Z=Z, Pmat=P, pvec=p)


def _stage_kernel(kn: LQRKnots, t: int, P_n, p_n, mudyn, mueq,
                  assume_explicit: bool, spd) -> dict:
    """One backward Riccati stage at index ``t`` given the next stage's value
    function ``(P_n, p_n)``, with the SPD solves by ``spd``.
    ``mudyn``/``mueq`` are ``(B, 1, 1)``."""
    Q, S, R = kn.Q[:, t], kn.S[:, t], kn.R[:, t]
    q, r = kn.q[:, t], kn.r[:, t]
    A, Bm, f = kn.A[:, t], kn.B[:, t], kn.f[:, t]
    C, D, d = kn.C[:, t], kn.D[:, t], kn.d[:, t]
    nx = Q.shape[-1]
    eye = torch.eye(nx, dtype=Q.dtype, device=Q.device)

    if assume_explicit:
        # E = -I: E^{-1} = E^{-T} = -I
        Ptilde, ptilde, Einv = P_n, p_n, None
    else:
        Einv = torch.linalg.inv(kn.E[:, t])
        Ptilde = _sym(Einv.mT @ P_n @ Einv)
        ptilde = -mv(Einv.mT, p_n)

    schur = _sym(eye + mudyn * Ptilde)
    sol = spd(
        schur, torch.cat([Ptilde, (ptilde + mv(Ptilde, f))[..., None]], -1)
    )
    Vxx = _sym(sol[..., :nx])
    vx = sol[..., nx]

    AtV = A.mT @ Vxx
    BtV = Bm.mT @ Vxx
    Qhat = Q + AtV @ A
    Rhat = R + BtV @ Bm
    Shat = S + AtV @ Bm
    qhat = q + mv(A.mT, vx)
    rhat = r + mv(Bm.mT, vx)

    kff, zff, K, Z = _reduced_kkt_solve(
        Rhat, D, mueq, -rhat, -d, -Shat.mT, -C, spd
    )

    md = mudyn[..., 0]
    lff = vx + mv(Vxx, mv(Bm, kff))
    L = Vxx @ A + Vxx @ (Bm @ K)
    yff = f + mv(Bm, kff) - md * lff
    Afb = A + Bm @ K - mudyn * L
    if not assume_explicit:
        yff = -mv(Einv, yff)
        Afb = -(Einv @ Afb)

    P_c = _sym(Qhat + Shat @ K + C.mT @ Z)
    p_c = qhat + mv(Shat, kff) + mv(C.mT, zff)
    return dict(kff=kff, K=K, zff=zff, Z=Z, lff=lff, L=L, yff=yff, Afb=Afb,
                Pmat=P_c, pvec=p_c)


def _sweep_loop(kn: LQRKnots, P, p, mudyn, mueq, assume_explicit: bool,
                spd) -> dict:
    """Per-stage loop over stages ``N-1 .. 0`` from the terminal value
    ``(P, p)``, SPD solves by ``spd``; factors as :func:`fused_stage.sweep`
    returns them (zero at index N)."""
    md = mudyn[:, None, None]
    me = mueq[:, None, None]
    out = fused_stage.factor_buffers(kn.Q, kn.horizon, kn.nu, kn.nc)
    for t in range(kn.horizon - 1, -1, -1):
        st = _stage_kernel(kn, t, P, p, md, me, assume_explicit, spd)
        P, p = st["Pmat"], st["pvec"]
        for k, v in st.items():
            out[k][:, t] = v
    return out


def _sweep(kn: LQRKnots, mudyn: Tensor, mueq: Tensor, assume_explicit: bool,
           plain: bool) -> dict:
    term = _terminal_solve(kn, mueq[:, None, None])
    P, p = term["Pmat"], term["pvec"]
    if plain:
        out = _sweep_loop(kn, P, p, mudyn, mueq, assume_explicit, chol_solve)
    elif fused_stage.sweep_eligible(kn.nx, kn.nu, kn.nc, assume_explicit,
                                    kn.Q.element_size()):
        out = fused_stage.sweep(kn, P, p, mudyn, mueq)
    else:
        out = _sweep_loop(kn, P, p, mudyn, mueq, assume_explicit,
                          spd_solve.spd_solve)
    N = kn.horizon
    for k in ("kff", "K", "zff", "Z", "Pmat", "pvec"):
        out[k][:, N] = term[k]
    return out


def sweep(kn: LQRKnots, mudyn: Tensor, mueq: Tensor,
          assume_explicit: bool = False) -> dict:
    """Backward sweep over the knots (no initial-stage solve), routed by
    shape (module docstring). ``mudyn`` and ``mueq`` are ``(B,)``. Returns
    the stacked per-stage factors, T entries; the dynamics-propagation gains
    at the last index are zero."""
    return _sweep(kn, mudyn, mueq, assume_explicit, plain=False)


def sweep_plain(kn: LQRKnots, mudyn: Tensor, mueq: Tensor,
                assume_explicit: bool = False) -> dict:
    """:func:`sweep` as the per-stage loop with torch Cholesky solves, on
    every device."""
    return _sweep(kn, mudyn, mueq, assume_explicit, plain=True)


def _initial_solve(P0, p0, G0, g0, mudyn):
    """Solve the initial KKT ``[[P0, G0'], [G0, -μ_dyn I]] [x0; λ0] =
    [-p0; -g0]`` by Schur elimination of λ0. ``mudyn`` is ``(B,)``."""
    md = mudyn[:, None, None]
    W = _sym(P0 + (G0.mT @ G0) / md)
    rhs = -p0 - mv(G0.mT, g0) / md[..., 0]
    x0 = chol_solve(W, rhs[..., None])[..., 0]
    lam0 = (mv(G0, x0) + g0) / md[..., 0]
    return x0, lam0


def _backward(problem: LQRProblem, mudyn, mueq, assume_explicit: bool,
              plain: bool) -> RiccatiFactors:
    md = batch_param(mudyn, problem)
    me = batch_param(mueq, problem)
    stages = _sweep(problem.knots, md, me, assume_explicit, plain)
    x0, lam0 = _initial_solve(
        stages["Pmat"][:, 0], stages["pvec"][:, 0], problem.G0, problem.g0, md
    )
    return RiccatiFactors(**stages, x0=x0, lam0=lam0)


def backward(problem: LQRProblem, mudyn, mueq,
             assume_explicit: bool = False) -> RiccatiFactors:
    """Backward sweep over the full horizon (routed, :func:`sweep`) plus the
    initial-stage solve."""
    return _backward(problem, mudyn, mueq, assume_explicit, plain=False)


def backward_plain(problem: LQRProblem, mudyn, mueq,
                   assume_explicit: bool = False) -> RiccatiFactors:
    """:func:`backward` with :func:`sweep_plain`."""
    return _backward(problem, mudyn, mueq, assume_explicit, plain=True)


def forward_plain(factors: RiccatiFactors):
    """Forward substitution in plain PyTorch, on every device (with
    :func:`backward_plain`, the plain version of K1). Returns ``(xs, us,
    vs, lams)``, each ``(B, N+1, ·)``."""
    return fused_stage.forward_loop(factors.gains(), factors.x0, factors.lam0)


def forward(factors: RiccatiFactors):
    """Forward substitution: through :func:`fused_stage.forward` (K4) when
    ``nx >= 12``, else the PyTorch loop :func:`fused_stage.forward_loop`
    (as the JAX package scans it in XLA). Returns ``(xs, us, vs, lams)``,
    each ``(B, N+1, ·)``."""
    nu, nx = factors.K.shape[-2:]
    gains = factors.gains()
    if fused_stage.forward_eligible(nx, nu):
        return fused_stage.forward(gains, factors.x0, factors.lam0)
    return fused_stage.forward_loop(gains, factors.x0, factors.lam0)


def solve(problem: LQRProblem, mudyn, mueq, assume_explicit: bool = False):
    """Backward + forward in one call, routed. Returns (xs, us, vs, lams)."""
    return forward(backward(problem, mudyn, mueq, assume_explicit))


def solve_and_gains(problem: LQRProblem, mudyn, mueq,
                    assume_explicit: bool = True):
    """Solve and return ``(xs, us, vs, lams, gains)``, ``gains`` a dict of the
    per-stage ``kff K zff Z lff L yff Afb``.

    Problems inside the fused kernel's domain (:func:`fused_riccati.available`)
    go to :func:`fused_riccati.solve` (K1); the others take :func:`backward`
    and :func:`forward`, routed to K3, K2 and K4 by shape. Each kernel
    wrapper takes its plain version for CPU tensors.
    """
    from . import fused_riccati  # fused_riccati builds on this module

    if fused_riccati.available(problem):
        return fused_riccati.solve(problem, mudyn, mueq, assume_explicit)
    factors = backward(problem, mudyn, mueq, assume_explicit)
    return (*forward(factors), factors.gains())
