"""Parallel-in-time proximal Riccati by associative scans, batched.

PyTorch counterpart of ``aligator_tpu/gar/associative.py``. The serial
backward sweep has O(N) sequential depth; here the same μ-regularized value
recursion is an associative operation on 5-tuples ``(A, b, C, η, J)`` (the
parallel LQT formulation of Särkkä & García-Fernández, 2020), so both
sweeps run in O(log N) depth:

* an element is the conditional cost-to-go map of a stage interval, with
  closed-loop state map ``x_s = A x_t + b`` and control reachability
  Gramian ``C``; the ALM penalty folds the constraints into an effective
  cost (``Q̄ = Q + CᵀC/μ_eq`` …), and the dual-proximal relaxation of the
  dynamics adds ``μ_dyn·I`` to each leaf's ``C``;
* the per-stage gains are recovered afterwards by one call of the serial
  stage kernel over all stages at once (each stage only needs the scanned
  value function of its successor), its SPD solves through
  :func:`.spd_solve.spd_solve` (K2 on the card), as are the leaves' R̄
  solves;
* the closed-loop forward rollout is a second associative scan, over
  affine maps.

:func:`associative_scan` pairs elements exactly as ``jax.lax.associative_scan``
does, so the float64 results agree with the JAX package's to rounding. The
combine's products and LU solves (:func:`.._linalg.lu_solve`) and the scans
are PyTorch, as the JAX package computes them outside any Pallas kernel.
Explicit dynamics (E = −I) and ``nth == 0`` only.

Conditioning: folding the ALM penalty into the leaf costs squares the 1/μ_eq
scale inside the element algebra, so below a dtype-dependent floor the
folded operator stops being a contraction and refinement diverges. The
measured domains (JAX package): **μ ≳ 1e-7 in float64, μ ≳ 1e-3 in
float32**; ProxDDP's ``associative_mu_floor`` takes the serial route below
them. ``refine_steps ≥ 1`` runs KKT-residual refinement (each step
re-solves on the residual, still O(log N) depth).
"""

from __future__ import annotations

import dataclasses

import torch

from .._linalg import lu_solve, mv
from . import riccati, spd_solve
from .lqr_problem import LQRProblem, batch_param, kkt_residual_vectors


def associative_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of ``fn`` over axis 1 (time) of a tuple of tensors
    ``(B, T, ...)``, with the pairing of ``jax.lax.associative_scan``:
    combine adjacent pairs, scan the half recursively, then fill in the even
    positions. ``fn(a, b)`` gets the earlier element of the (flipped, with
    ``reverse``) sequence first. Depth log₂ T."""
    if reverse:
        elems = tuple(e.flip(1) for e in elems)

    def scan(el):
        n = el[0].shape[1]
        if n < 2:
            return el
        odd = scan(fn(tuple(e[:, 0:n - 1:2] for e in el),
                      tuple(e[:, 1::2] for e in el)))
        if n % 2 == 0:
            even = fn(tuple(e[:, :-1] for e in odd),
                      tuple(e[:, 2::2] for e in el))
        else:
            even = fn(odd, tuple(e[:, 2::2] for e in el))
        out = []
        for e, ev, od in zip(el, even, odd):
            ev = torch.cat([e[:, :1], ev], 1)
            x = e.new_empty(e.shape)
            x[:, 0::2] = ev
            x[:, 1::2] = od
            out.append(x)
        return tuple(out)

    out = scan(tuple(elems))
    if reverse:
        out = tuple(e.flip(1) for e in out)
    return out


def _combine(later, earlier):
    """Compose two value-function elements ``(A, b, C, η, J)``; ``later`` is
    the interval closer to T (the reverse scan feeds it first)."""
    A1, b1, C1, eta1, J1 = earlier
    A2, b2, C2, eta2, J2 = later
    n = A1.shape[-1]
    eye = torch.eye(n, dtype=A1.dtype, device=A1.device)
    # one factorization of (I + C₁J₂) for [A₁ | C₁ | b₁ + C₁η₂], one of
    # (I + J₂C₁) for [η₂ - J₂b₁ | J₂]
    X = lu_solve(eye + C1 @ J2,
                 torch.cat([A1, C1, (b1 + mv(C1, eta2))[..., None]], -1))
    Y = lu_solve(eye + J2 @ C1,
                 torch.cat([(eta2 - mv(J2, b1))[..., None], J2], -1))
    C_c = A2 @ X[..., n:2 * n] @ A2.mT + C2
    J_c = A1.mT @ Y[..., 1:] @ A1 + J1
    return (A2 @ X[..., :n], mv(A2, X[..., 2 * n]) + b2, 0.5 * (C_c + C_c.mT),
            mv(A1.mT, Y[..., 0]) + eta1, 0.5 * (J_c + J_c.mT))


def _fold_constraints(kn, mueq):
    """Stage costs ``Q̄ S̄ R̄ q̄ r̄`` (stages 0..N-1) with the ALM constraint
    penalty folded in; ``mueq`` is ``(B, 1, 1)``."""
    N = kn.horizon
    C, D, d = kn.C[:, :N], kn.D[:, :N], kn.d[:, :N]
    me = mueq[..., None]
    return (kn.Q[:, :N] + (C.mT @ C) / me, kn.S[:, :N] + (C.mT @ D) / me,
            kn.R[:, :N] + (D.mT @ D) / me, kn.q[:, :N] + mv(C.mT, d) / mueq,
            kn.r[:, :N] + mv(D.mT, d) / mueq)


def backward_scan(problem: LQRProblem, mudyn, mueq):
    """Associative backward sweep. Returns the value functions ``P (B, T, nx,
    nx)`` and ``p (B, T, nx)`` of every knot."""
    kn = problem.knots
    Bsz, N, nx, nu = kn.batch, kn.horizon, kn.nx, kn.nu
    md = batch_param(mudyn, problem)[:, None, None]
    me = batch_param(mueq, problem)[:, None, None]
    eye = torch.eye(nx, dtype=kn.Q.dtype, device=kn.Q.device)

    # leaves, stages 0..N-1: one SPD solve R̄⁻¹ [S̄ᵀ | Bᵀ | r̄] for all stages
    Qb, Sb, Rb, qb, rb = _fold_constraints(kn, me)
    A, Bm, f = kn.A[:, :N], kn.B[:, :N], kn.f[:, :N]
    Rs = (0.5 * (Rb + Rb.mT)).reshape(Bsz * N, nu, nu)
    rhs = torch.cat([Sb.mT, Bm.mT, rb[..., None]], -1).reshape(Bsz * N, nu, -1)
    sol = spd_solve.spd_solve(Rs, rhs).reshape(Bsz, N, nu, -1)
    RiSt, RiBt, Rir = sol[..., :nx], sol[..., nx:2 * nx], sol[..., 2 * nx]
    J_e = Qb - Sb @ RiSt

    # the terminal element: the terminal knot's own reduced cost
    term = riccati._terminal_solve(kn, me)
    elems = (
        torch.cat([A - Bm @ RiSt, kn.Q.new_zeros((Bsz, 1, nx, nx))], 1),
        torch.cat([f - mv(Bm, Rir), kn.Q.new_zeros((Bsz, 1, nx))], 1),
        torch.cat([Bm @ RiBt + md[..., None] * eye,
                   kn.Q.new_zeros((Bsz, 1, nx, nx))], 1),
        torch.cat([-(qb - mv(Sb, Rir)), -term["pvec"][:, None]], 1),
        torch.cat([0.5 * (J_e + J_e.mT), term["Pmat"][:, None]], 1),
    )
    # suffix products: scanned[t] = elem_t ⊗ … ⊗ elem_N → (P_t, p_t)
    scanned = associative_scan(_combine, elems, reverse=True)
    return scanned[4], -scanned[3]


def _affine_combine(left, right):
    """Compose the affine maps ``x ↦ M x + v`` of two time intervals; the
    later one (``right``) is applied after the earlier."""
    return right[0] @ left[0], mv(right[0], left[1]) + right[1]


def solve(problem: LQRProblem, mudyn, mueq, return_gains: bool = False,
          refine_steps: int = 0):
    """Parallel-in-time solve: the O(log N)-depth backward value scan,
    stage-parallel gain recovery, the O(log N)-depth closed-loop forward
    scan, then ``refine_steps`` KKT-residual refinement steps.

    Returns ``(xs, us, vs, lams)`` (each ``(B, T, ·)``), and with
    ``return_gains`` a :class:`.riccati.RiccatiFactors` appended, matching
    ``riccati.solve(..., assume_explicit=True)``."""
    kn = problem.knots
    if kn.nth != 0:
        raise ValueError("associative solver supports nth == 0 only")
    Bsz, N = kn.batch, kn.horizon
    md = batch_param(mudyn, problem)
    me = batch_param(mueq, problem)

    P, p = backward_scan(problem, md, me)

    # stage t needs only (P_{t+1}, p_{t+1}): one stage-kernel call over the
    # flattened (B·N) stages, its SPD solves by K2 on the card
    def flat(a):
        return a.reshape((Bsz * N,) + a.shape[2:])

    st = riccati._stage_kernel(
        kn.map(lambda a: flat(a[:, :N])), flat(P[:, 1:]), flat(p[:, 1:]),
        md.repeat_interleave(N)[:, None, None],
        me.repeat_interleave(N)[:, None, None], True, spd_solve.spd_solve)
    term = riccati._terminal_solve(kn, me[:, None, None])

    def gain(name):
        g = st[name].reshape((Bsz, N) + st[name].shape[1:])
        last = term[name] if name in term else torch.zeros_like(g[:, 0])
        return torch.cat([g, last[:, None]], 1)

    g = {k: gain(k) for k in riccati.GAIN_FIELDS}
    x0, lam0, _, _ = riccati._initial_solve(P[:, 0], p[:, 0], problem.G0,
                                            problem.g0, md)

    # the forward rollout x_{t+1} = Afb_t x_t + yff_t as a scan of maps
    M, v = associative_scan(_affine_combine, (g["Afb"][:, :N], g["yff"][:, :N]))
    xs = torch.cat([x0[:, None], mv(M, x0[:, None]) + v], 1)
    us = g["kff"] + mv(g["K"], xs)
    vs = g["zff"] + mv(g["Z"], xs)
    lams = torch.cat([lam0[:, None],
                      g["lff"][:, :N] + mv(g["L"][:, :N], xs[:, :N])], 1)

    for _ in range(refine_steps):
        g0r, gx, gu, cstr, dyn = kkt_residual_vectors(
            problem, xs, us, vs, lams, md, me)
        kn_r = dataclasses.replace(
            kn, q=gx, r=gu, d=cstr, f=torch.cat([dyn, torch.zeros_like(dyn[:, :1])], 1))
        delta = solve(dataclasses.replace(problem, knots=kn_r, g0=g0r), md, me)
        xs, us, vs, lams = (a + b for a, b in zip((xs, us, vs, lams), delta))

    if not return_gains:
        return xs, us, vs, lams
    factors = riccati.RiccatiFactors(**g, Pmat=P, pvec=p, x0=x0, lam0=lam0)
    return xs, us, vs, lams, factors
