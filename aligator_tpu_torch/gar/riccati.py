"""Batched serial proximal Riccati solver.

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
  to :mod:`.fused_riccati` (K1) whole (never with θ blocks);
* :func:`sweep` (the backward sweep): explicit dynamics with
  ``12 <= nx <= 44``, no θ blocks and a K3 block within the card's shared
  memory go to :func:`.fused_stage.sweep` (K3), the others to the
  per-stage loop of this module, whose Schur and reduced-KKT solves go
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

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
from torch import Tensor

from .. import _build
from .._linalg import chol_solve, mv
from . import fused_stage, spd_solve
from .lqr_problem import LQRKnots, LQRProblem, batch_param

GAIN_FIELDS = ("kff", "K", "zff", "Z", "lff", "L", "yff", "Afb")


@dataclass
class RiccatiFactors:
    """Per-stage gains and value function, shapes ``(B, T, ...)``; the
    dynamics-propagation gains ``lff, L, yff, Afb`` (and ``Lth, Yth``) are
    zero at index N. The θ fields are None when ``nth == 0``."""

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
    Kth: Optional[Tensor] = None  # (B, T, nu, nth)
    Zth: Optional[Tensor] = None  # (B, T, nc, nth)
    Lth: Optional[Tensor] = None  # (B, T, nx, nth)
    Yth: Optional[Tensor] = None  # (B, T, nx, nth)
    Vxt: Optional[Tensor] = None  # (B, T, nx, nth)
    Vtt: Optional[Tensor] = None  # (B, T, nth, nth)
    vt: Optional[Tensor] = None  # (B, T, nth)
    x0_th: Optional[Tensor] = None  # (B, nx, nth)
    lam0_th: Optional[Tensor] = None  # (B, nc0, nth)
    th_grad: Optional[Tensor] = None  # (B, nth)
    th_hess: Optional[Tensor] = None  # (B, nth, nth)

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


def _theta_rhs(S_t, C, Gu):
    """The reduced-KKT matrix right-hand sides ``[-Sᵀ | -Gu]``, ``[-C | 0]``:
    the θ columns (``Gu`` None: none) ride the feedback solve."""
    if Gu is None:
        return -S_t, -C
    return (torch.cat([-S_t, -Gu], -1),
            torch.cat([-C, C.new_zeros(C.shape[:-1] + Gu.shape[-1:])], -1))


def _terminal_solve(kn: LQRKnots, mueq: Tensor) -> dict:
    """Terminal-stage factor (reference terminalSolve); with θ blocks also
    ``Kth, Zth`` and the terminal ``Vxt, Vtt, vt``."""
    Q, S, R = kn.Q[:, -1], kn.S[:, -1], kn.R[:, -1]
    q, r = kn.q[:, -1], kn.r[:, -1]
    C, D, d = kn.C[:, -1], kn.D[:, -1], kn.d[:, -1]
    nx = kn.nx
    Gu = None if kn.nth == 0 else kn.Gu[:, -1]
    kff, zff, KK, ZZ = _reduced_kkt_solve(R, D, mueq, -r, -d,
                                          *_theta_rhs(S.mT, C, Gu))
    K, Z = KK[..., :nx], ZZ[..., :nx]
    P = _sym(Q + C.mT @ Z + S @ K)
    p = q + mv(C.mT, zff) + mv(S, kff)
    out = dict(kff=kff, K=K, zff=zff, Z=Z, Pmat=P, pvec=p)
    if Gu is not None:
        Kth = KK[..., nx:]
        out.update(Kth=Kth, Zth=ZZ[..., nx:], Vxt=kn.Gx[:, -1] + K.mT @ Gu,
                   Vtt=kn.Gth[:, -1] + Gu.mT @ Kth,
                   vt=kn.gamma[:, -1] + mv(Gu.mT, kff))
    return out


def _inv(E: Tensor) -> Tensor:
    """Batched inverse without the host-side check of the factorization
    (which waits on the device); a singular E gives inf/NaN, as in JAX."""
    return torch.linalg.inv_ex(E)[0]


def _stage_kernel(knot: LQRKnots, P_n, p_n, mudyn, mueq,
                  assume_explicit: bool, spd, th_n=None, Einv=None) -> dict:
    """One backward Riccati stage given the next stage's value function
    ``(P_n, p_n)`` and, with θ blocks, ``th_n = (Vxt_n, Vtt_n, vt_n)``.
    ``knot`` holds one stage's fields as ``(M, ...)`` tensors over any flat
    batch ``M`` (no time axis); ``mudyn``/``mueq`` are ``(M, 1, 1)``; the
    SPD solves go through ``spd``; ``Einv``, E's inverse, is computed here
    unless given."""
    Q, S, R = knot.Q, knot.S, knot.R
    q, r = knot.q, knot.r
    A, Bm, f = knot.A, knot.B, knot.f
    C, D, d = knot.C, knot.D, knot.d
    nx = Q.shape[-1]
    eye = torch.eye(nx, dtype=Q.dtype, device=Q.device)

    if assume_explicit:
        # E = -I: E^{-1} = E^{-T} = -I
        Ptilde, ptilde, Einv = P_n, p_n, None
    else:
        if Einv is None:
            Einv = _inv(knot.E)
        Ptilde = _sym(Einv.mT @ P_n @ Einv)
        ptilde = -mv(Einv.mT, p_n)

    schur = _sym(eye + mudyn * Ptilde)
    cols = [Ptilde, (ptilde + mv(Ptilde, f))[..., None]]
    if th_n is not None:
        Vxt_n, Vtt_n, vt_n = th_n
        cols.append(Vxt_n if assume_explicit else -(Einv.mT @ Vxt_n))
    sol = spd(schur, torch.cat(cols, -1))
    Vxx = _sym(sol[..., :nx])
    vx = sol[..., nx]

    AtV = A.mT @ Vxx
    BtV = Bm.mT @ Vxx
    Qhat = Q + AtV @ A
    Rhat = R + BtV @ Bm
    Shat = S + AtV @ Bm
    qhat = q + mv(A.mT, vx)
    rhat = r + mv(Bm.mT, vx)

    Guhat = None
    if th_n is not None:
        Pxttilde = sol[..., nx + 1:]
        Guhat = knot.Gu + Bm.mT @ Pxttilde
    kff, zff, KK, ZZ = _reduced_kkt_solve(
        Rhat, D, mueq, -rhat, -d, *_theta_rhs(Shat.mT, C, Guhat), spd
    )
    K, Z = KK[..., :nx], ZZ[..., :nx]

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
    out = dict(kff=kff, K=K, zff=zff, Z=Z, lff=lff, L=L, yff=yff, Afb=Afb,
               Pmat=P_c, pvec=p_c)
    if th_n is not None:
        Gx, Gu, Gth, gamma = knot.Gx, knot.Gu, knot.Gth, knot.gamma
        Kth = KK[..., nx:]
        Lth = Pxttilde + Vxx @ (Bm @ Kth)
        Yth = Bm @ Kth - mudyn * Lth
        if not assume_explicit:
            Yth = -(Einv @ Yth)
        out.update(
            Kth=Kth, Zth=ZZ[..., nx:], Lth=Lth, Yth=Yth,
            Vxt=Gx + K.mT @ Gu + Afb.mT @ Vxt_n,
            Vtt=Gth + Vtt_n + Gu.mT @ Kth + Vxt_n.mT @ Yth,
            vt=vt_n + gamma + mv(Gu.mT, kff) + mv(Vxt_n.mT, yff),
        )
    return out


def _theta_buffers(kn: LQRKnots, n_stages: int) -> dict:
    """The θ factor tensors ``(B, T, ...)``, zero after ``n_stages``."""
    Bsz, T = kn.Q.shape[:2]
    nx, nu, nc, nth = kn.nx, kn.nu, kn.nc, kn.nth
    shapes = dict(Kth=(nu, nth), Zth=(nc, nth), Lth=(nx, nth), Yth=(nx, nth),
                  Vxt=(nx, nth), Vtt=(nth, nth), vt=(nth,))
    out = {k: kn.Q.new_empty((Bsz, T) + s) for k, s in shapes.items()}
    for v in out.values():
        v[:, n_stages:].zero_()
    return out


def _sweep_loop(kn: LQRKnots, term: dict, mudyn, mueq, assume_explicit: bool,
                spd, Einv=None) -> dict:
    """Per-stage loop over stages ``N-1 .. 0`` from the terminal factor
    ``term``, SPD solves by ``spd``; factors as :func:`fused_stage.sweep`
    returns them (zero at index N), with the θ factors when the knots have
    θ blocks. ``Einv (B, T, nx, nx)``, the inverses of E, may be given;
    else each stage inverts its own."""
    md = mudyn[:, None, None]
    me = mueq[:, None, None]
    N = kn.horizon
    out = fused_stage.factor_buffers(kn.Q, N, kn.nu, kn.nc)
    P, p, th = term["Pmat"], term["pvec"], None
    if kn.nth:
        out.update(_theta_buffers(kn, N))
        th = (term["Vxt"], term["Vtt"], term["vt"])
    for t in range(N - 1, -1, -1):
        st = _stage_kernel(kn.map(lambda a: a[:, t]), P, p, md, me,
                           assume_explicit, spd, th,
                           None if Einv is None else Einv[:, t])
        P, p = st["Pmat"], st["pvec"]
        if kn.nth:
            th = (st["Vxt"], st["Vtt"], st["vt"])
        for k, v in st.items():
            out[k][:, t] = v
    return out


class SweepGraph:
    """The per-stage loop (:func:`_sweep_loop` on K2) of one shape of knots
    on CUDA tensors, captured as a CUDA graph after its first, eager, call
    and replayed for the later ones, its inputs copied into the graph's
    static tensors: a stage is some 60 small operations, each a host
    launch, and a sweep N stages of them. The launches that the capture
    records (``_build.LAUNCHES``) are taken back and added again at every
    replay, so that the counts are those of eager sweeps. A sweep that
    cannot be captured runs eagerly from then on."""

    def __init__(self):
        self.graph = None
        self.eager = False
        self.replay_launches = None

    def __call__(self, kn: LQRKnots, term: dict, mudyn, mueq, assume_explicit: bool):
        # E's inverses for every stage at once, outside the graph: the
        # batched LU of larger matrices (nx > 32) is not captured safely
        ins = dict(kn=kn, term=term, mudyn=mudyn, mueq=mueq,
                   Einv=None if assume_explicit else _inv(kn.E[:, :kn.horizon]))

        def run(a):
            return _sweep_loop(a["kn"], a["term"], a["mudyn"], a["mueq"], assume_explicit,
                               spd_solve.spd_solve, a["Einv"])

        if self.eager or not kn.Q.is_cuda:
            return run(ins)
        if self.graph is None:
            out = run(ins)  # the first sweep, eager, also warms up the capture
            self.static = _tree_map(ins, lambda t: t.clone())
            before = _build.LAUNCHES.copy()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    self.out = run(self.static)
            except RuntimeError:
                _build.LAUNCHES.clear()
                _build.LAUNCHES.update(before)
                self.eager = True
                return out
            self.replay_launches = _build.LAUNCHES - before
            _build.LAUNCHES.subtract(self.replay_launches)
            self.graph = graph
            return out
        _tree_copy(self.static, ins)
        self.graph.replay()
        _build.LAUNCHES.update(self.replay_launches)
        return {k: v.clone() for k, v in self.out.items()}


def _tree_map(x, fn):
    if isinstance(x, Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(v, fn) for k, v in x.items()}
    if isinstance(x, LQRKnots):
        return x.map(lambda t: _tree_map(t, fn))
    return x


def _tree_copy(dst, src):
    if isinstance(dst, Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _tree_copy(dst[k], src[k])
    elif isinstance(dst, LQRKnots):
        for f in dataclasses.fields(dst):
            if getattr(dst, f.name) is not None:
                _tree_copy(getattr(dst, f.name), getattr(src, f.name))


def _sweep(kn: LQRKnots, mudyn: Tensor, mueq: Tensor, assume_explicit: bool,
           plain: bool, graphs: Optional[dict] = None) -> dict:
    term = _terminal_solve(kn, mueq[:, None, None])
    if plain:
        out = _sweep_loop(kn, term, mudyn, mueq, assume_explicit, chol_solve)
    elif fused_stage.sweep_eligible(kn.nx, kn.nu, kn.nc, assume_explicit,
                                    kn.Q.element_size(), kn.nth):
        out = fused_stage.sweep(kn, term["Pmat"], term["pvec"], mudyn, mueq)
    elif graphs is not None:
        key = (tuple(kn.Q.shape), tuple(kn.C.shape), kn.nth, kn.Q.dtype, assume_explicit)
        out = graphs.setdefault(key, SweepGraph())(kn, term, mudyn, mueq, assume_explicit)
    else:
        out = _sweep_loop(kn, term, mudyn, mueq, assume_explicit,
                          spd_solve.spd_solve)
    N = kn.horizon
    for k, v in term.items():
        out[k][:, N] = v
    return out


def sweep(kn: LQRKnots, mudyn: Tensor, mueq: Tensor,
          assume_explicit: bool = False) -> dict:
    """Backward sweep over the knots (no initial-stage solve), routed by
    shape (module docstring). ``mudyn`` and ``mueq`` are ``(B,)``. Returns
    the stacked per-stage factors, T entries; the dynamics-propagation gains
    at the last index are zero. Index 0 holds the value function at the
    head of the knots (``Pmat, pvec`` and, with θ, ``Vxt, Vtt, vt``), the
    carry the JAX ``sweep`` returns beside them."""
    return _sweep(kn, mudyn, mueq, assume_explicit, plain=False)


def sweep_plain(kn: LQRKnots, mudyn: Tensor, mueq: Tensor,
                assume_explicit: bool = False) -> dict:
    """:func:`sweep` as the per-stage loop with torch Cholesky solves, on
    every device."""
    return _sweep(kn, mudyn, mueq, assume_explicit, plain=True)


def _initial_solve(P0, p0, G0, g0, mudyn, Vxt0=None):
    """Solve the initial KKT ``[[P0, G0'], [G0, -μ_dyn I]] [x0; λ0] =
    [-p0; -g0]`` by Schur elimination of λ0. ``mudyn`` is ``(B,)``. With
    ``Vxt0`` also the θ sensitivities ``x0_th, lam0_th`` (right-hand sides
    ``[-Vxt0; 0]``); returns ``(x0, lam0, x0_th, lam0_th)``."""
    md = mudyn[:, None, None]
    W = _sym(P0 + (G0.mT @ G0) / md)
    rhs = (-p0 - mv(G0.mT, g0) / md[..., 0])[..., None]
    if Vxt0 is not None:
        rhs = torch.cat([rhs, -Vxt0], -1)
    X = chol_solve(W, rhs)
    x0 = X[..., 0]
    lam0 = (mv(G0, x0) + g0) / md[..., 0]
    if Vxt0 is None:
        return x0, lam0, None, None
    x0_th = X[..., 1:]
    return x0, lam0, x0_th, (G0 @ x0_th) / md


def _backward(problem: LQRProblem, mudyn, mueq, assume_explicit: bool,
              plain: bool, graphs: Optional[dict] = None) -> RiccatiFactors:
    md = batch_param(mudyn, problem)
    me = batch_param(mueq, problem)
    stages = _sweep(problem.knots, md, me, assume_explicit, plain, graphs)
    Vxt0 = stages["Vxt"][:, 0] if problem.nth else None
    x0, lam0, x0_th, lam0_th = _initial_solve(
        stages["Pmat"][:, 0], stages["pvec"][:, 0], problem.G0, problem.g0, md,
        Vxt0,
    )
    if Vxt0 is None:
        return RiccatiFactors(**stages, x0=x0, lam0=lam0)
    return RiccatiFactors(
        **stages, x0=x0, lam0=lam0, x0_th=x0_th, lam0_th=lam0_th,
        th_grad=stages["vt"][:, 0] + mv(Vxt0.mT, x0),
        th_hess=stages["Vtt"][:, 0] + Vxt0.mT @ x0_th,
    )


def backward(problem: LQRProblem, mudyn, mueq, assume_explicit: bool = False,
             graphs: Optional[dict] = None) -> RiccatiFactors:
    """Backward sweep over the full horizon (routed, :func:`sweep`) plus the
    initial-stage solve. ``graphs``, a dict the caller keeps between
    solves of knots of one shape, holds a :class:`SweepGraph` by shape for
    the per-stage loop on the card."""
    return _backward(problem, mudyn, mueq, assume_explicit, plain=False, graphs=graphs)


def backward_plain(problem: LQRProblem, mudyn, mueq,
                   assume_explicit: bool = False) -> RiccatiFactors:
    """:func:`backward` with :func:`sweep_plain`."""
    return _backward(problem, mudyn, mueq, assume_explicit, plain=True)


def forward_plain(factors: RiccatiFactors):
    """Forward substitution in plain PyTorch, on every device (with
    :func:`backward_plain`, the plain version of K1). Returns ``(xs, us,
    vs, lams)``, each ``(B, N+1, ·)``."""
    return fused_stage.forward_loop(factors.gains(), factors.x0, factors.lam0)


def forward(factors: RiccatiFactors, theta: Optional[Tensor] = None,
            x0: Optional[Tensor] = None, lam0: Optional[Tensor] = None):
    """Forward substitution: through :func:`fused_stage.forward` (K4) when
    ``nx >= 12``, else the PyTorch loop :func:`fused_stage.forward_loop`
    (as the JAX package scans it in XLA). Returns ``(xs, us, vs, lams)``,
    each ``(B, N+1, ·)``.

    ``theta (B, nth)`` solves the problem at that parameter: θ is constant
    over the horizon, so ``Kth θ, Zth θ, Lth θ, Yth θ`` are folded into the
    feedforwards once and the same substitution runs. ``x0``/``lam0``
    replace the initial-stage solution (the parallel solver seeds each leg
    from its condensed system); by default it is ``factors.x0`` (and
    ``lam0``) plus their θ sensitivities times θ."""
    gains = factors.gains()
    has_th = theta is not None and factors.Kth is not None
    if x0 is None:
        x0 = factors.x0
        if has_th:
            x0 = x0 + mv(factors.x0_th, theta)
    if lam0 is None:
        lam0 = factors.lam0
        if has_th:
            lam0 = lam0 + mv(factors.lam0_th, theta)
    if has_th:
        th = theta[:, None]
        for k, kth in (("kff", "Kth"), ("zff", "Zth"), ("lff", "Lth"),
                       ("yff", "Yth")):
            gains[k] = gains[k] + mv(getattr(factors, kth), th)
    nu, nx = factors.K.shape[-2:]
    if fused_stage.forward_eligible(nx, nu):
        return fused_stage.forward(gains, x0, lam0)
    return fused_stage.forward_loop(gains, x0, lam0)


def solve(problem: LQRProblem, mudyn, mueq, assume_explicit: bool = False,
          theta: Optional[Tensor] = None):
    """Backward + forward in one call, routed. Returns (xs, us, vs, lams)."""
    return forward(backward(problem, mudyn, mueq, assume_explicit), theta)


def solve_and_gains(problem: LQRProblem, mudyn, mueq,
                    assume_explicit: bool = True, graphs: Optional[dict] = None):
    """Solve and return ``(xs, us, vs, lams, gains)``, ``gains`` a dict of the
    per-stage ``kff K zff Z lff L yff Afb``.

    Problems inside the fused kernel's domain (:func:`fused_riccati.available`)
    go to :func:`fused_riccati.solve` (K1); the others take :func:`backward`
    (with ``graphs``) and :func:`forward`, routed to K3, K2 and K4 by shape.
    Each kernel wrapper takes its plain version for CPU tensors.
    """
    from . import fused_riccati  # fused_riccati builds on this module

    if fused_riccati.available(problem):
        return fused_riccati.solve(problem, mudyn, mueq, assume_explicit)
    factors = backward(problem, mudyn, mueq, assume_explicit, graphs)
    return (*forward(factors), factors.gains())
