"""Parallel-in-time proximal Riccati solver (leg condensation), batched.

PyTorch counterpart of ``aligator_tpu/gar/parallel.py`` (the reference's
``ParallelRiccatiSolver``, ``gar/parallel-solver.hxx``). The horizon is
split into legs; each leg but the last is θ-parameterized by the costate at
its outgoing interface (``setupKnot``: ``Gx = Aᵀ``, ``Gu = Bᵀ``, ``Gth =
-μ_dyn I``, ``γ = f`` at the leg's last knot). Where the JAX package
``vmap``s the legs, here they become a batch axis: the legs of a group of
equal length are stacked into ``(B·legs, L, ·)`` knots and take one routed
backward sweep (:func:`.riccati.sweep`: the per-stage loop with the SPD
solve K2 on the card, since θ blocks keep K3 off) and one routed forward
(:func:`.riccati.forward`: K4 at ``nx >= 12``, θ folded into the
feedforwards). The legs' head value functions form a symmetric
block-tridiagonal condensed system in the interface variables, solved per
scenario (:mod:`.block_tridiag`) with ``refine_steps`` refinement passes.

Non-divisible horizons use the reference's balanced split (:func:`get_work`,
``gar/work.hpp:17-22``): leg lengths differ by at most one, realized as at
most two leg groups of uniform length.

Requirement: ``nc0 == nx``. Operating domain: stage-wise jointly convex
costs (what ProxDDP emits); on indefinite stage blocks a leg sweep can
produce an indefinite value function and NaN, as in the JAX package.

:func:`solve_sharded` runs the legs across devices instead, one leg a rank
of a :class:`..parallel.mesh.Mesh` axis, with one all-gather of the legs'
interface payload a solve.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import Tensor

from .._linalg import mv
from ..parallel import mesh as _mesh
from . import block_tridiag, riccati
from .lqr_problem import LQRProblem, add_parameterization, batch_param


def get_work(T: int, legs: int):
    """Balanced ``[start, start + len)`` leg ranges (reference
    ``gar/work.hpp:17-22``): the first ``T % legs`` legs get one extra knot.
    Returns ``(starts, lens)``."""
    base, rem = divmod(T, legs)
    lens = [base + (1 if i < rem else 0) for i in range(legs)]
    starts = [sum(lens[:i]) for i in range(legs)]
    return starts, lens


@dataclass
class ParallelGains:
    """Control gains recovered from the parallel-in-time solve.

    ``kff`` has the θ-feedback folded in with the solved interface costates
    (so ``u_t = kff_t + K_t x_t`` reproduces the solution's controls);
    ``K[:, 0]`` is the collapsed first-stage feedback (reference
    ``collapseFeedback``, ``parallel-solver.hpp:55-66``), which equals the
    serial solver's ``K[:, 0]``."""

    kff: Tensor  # (B, T, nu)
    K: Tensor  # (B, T, nu, nx)


def _legs(a: Tensor, starts, L: int) -> Tensor:
    """``(B, T, ...)`` → the legs ``[s, s + L)`` for s in ``starts`` as
    ``(B·len(starts), L, ...)``, scenario-major."""
    stacked = torch.stack([a[:, s:s + L] for s in starts], 1)
    return stacked.reshape((a.shape[0] * len(starts), L) + a.shape[2:])


def solve(problem: LQRProblem, mudyn, mueq, legs: int,
          assume_explicit: bool = False, refine_steps: int = 1,
          return_gains: bool = False):
    """Solve the proximal LQ problems with ``legs`` legs each.

    Returns ``(xs, us, vs, lams)`` (each ``(B, T, ·)``) equal to rounding to
    the serial solve, and with ``return_gains`` a :class:`ParallelGains`
    appended. ``mudyn``/``mueq`` are floats or ``(B,)`` tensors.

    The JAX function's ``time_sharding=`` hint has no counterpart here:
    without a single-controller compiler a placement hint has no meaning,
    and the legs already run as one batch on one device. Its counterpart is
    :func:`solve_sharded`, a leg a device."""
    kn = problem.knots
    Bsz, T = kn.Q.shape[:2]
    nx = kn.nx
    if legs > T:
        raise ValueError(f"legs={legs} exceeds horizon+1={T}")
    if problem.nc0 != nx:
        raise ValueError("parallel solver requires nc0 == nx (pad G0)")
    md = batch_param(mudyn, problem)
    me = batch_param(mueq, problem)
    eye = torch.eye(nx, dtype=kn.Q.dtype, device=kn.Q.device)

    # 1. every leg parameterized by θ of dimension nx; the last leg keeps
    #    zero blocks, so its θ terms vanish. 2. the interface knots (the last
    #    knot of each leg but the last) take the costate parameterization.
    starts, lens = get_work(T, legs)
    if kn.nth != nx:
        kn = add_parameterization(kn, nx)
    idx = [starts[i + 1] - 1 for i in range(legs - 1)]
    kn = dataclasses.replace(
        kn, Gx=kn.Gx.clone(), Gu=kn.Gu.clone(), Gth=kn.Gth.clone(),
        gamma=kn.gamma.clone(),
    )
    kn.Gx[:, idx] = kn.A[:, idx].mT
    kn.Gu[:, idx] = kn.B[:, idx].mT
    kn.Gth[:, idx] = -md[:, None, None, None] * eye
    kn.gamma[:, idx] = kn.f[:, idx]

    # leg groups of uniform length: (first leg, starts, length)
    rem = T % legs
    groups = [(0, starts, lens[0])] if rem == 0 else [
        (0, starts[:rem], lens[0]), (rem, starts[rem:], lens[rem])]

    # 3. the legs' backward sweeps, one routed sweep a group
    group_stages = []
    for _, g_starts, L in groups:
        n = len(g_starts)
        leg_kn = kn.map(lambda a: _legs(a, g_starts, L))
        group_stages.append(riccati.sweep(
            leg_kn, md.repeat_interleave(n), me.repeat_interleave(n),
            assume_explicit))

    def heads(name):
        """The legs' head values ``(B, legs, ...)`` in leg order."""
        return torch.cat([st[name][:, 0].reshape((Bsz, len(g[1])) + st[name].shape[2:])
                          for g, st in zip(groups, group_stages)], 1)

    P_leg, p_leg = heads("Pmat"), heads("pvec")
    Vxt_leg, Vtt_leg, vt_leg = heads("Vxt"), heads("Vtt"), heads("vt")

    # 4. the condensed system, solved per scenario
    lam_heads, x_heads, thetas, bt_factors = _condensed_solve(
        P_leg, Vxt_leg, Vtt_leg, kn.E[:, idx], p_leg, vt_leg, problem.G0, problem.g0,
        md, refine_steps)

    # 5. the legs' forward substitutions, one routed forward a group
    parts, gain_parts = [], []
    for (off, g_starts, L), stages in zip(groups, group_stages):
        n = len(g_starts)

        def per_leg(a):
            return a[:, off:off + n].reshape((Bsz * n,) + a.shape[2:])

        x0, lam0, th = per_leg(x_heads), per_leg(lam_heads), per_leg(thetas)
        facs = riccati.RiccatiFactors(x0=x0, lam0=lam0, **stages)
        out = riccati.forward(facs, theta=th, x0=x0, lam0=lam0)
        # (B·n, L, ·) → (B, n·L, ·); each leg's lams[0] is its head costate
        parts.append([a.reshape((Bsz, n * L) + a.shape[2:]) for a in out])
        if return_gains:
            kff = stages["kff"] + mv(stages["Kth"], th[:, None])
            gain_parts.append([a.reshape((Bsz, n * L) + a.shape[2:])
                               for a in (kff, stages["K"])])
    out = tuple(torch.cat([p[i] for p in parts], 1) for i in range(4))
    if not return_gains:
        return out

    kff = torch.cat([g[0] for g in gain_parts], 1)
    K_all = torch.cat([g[1] for g in gain_parts], 1)
    if legs > 1:
        # collapseFeedback: θ_0 is condensed variable 2, x_0 variable 1; the
        # elimination chain gives θ_0(x_0) = θ_0* + W_1 (x_0* - x_0), so Kth
        # folds into the state feedback at stage 0 (and the feedforward
        # shifts to keep u_0 = kff + K x_0 exact at the solution)
        W1 = bt_factors[2][:, 1]
        Kth0 = group_stages[0]["Kth"][::len(groups[0][1]), 0]
        K_all = K_all.clone()
        K_all[:, 0] = K_all[:, 0] - Kth0 @ W1
        kff = kff.clone()
        kff[:, 0] = kff[:, 0] + mv(Kth0, mv(W1, x_heads[:, 0]))
    return out + (ParallelGains(kff=kff, K=K_all),)


def _condensed_solve(P_leg, Vxt_leg, Vtt_leg, E_if, p_leg, vt_leg, G0, g0, md,
                     refine_steps):
    """The condensed block-tridiagonal system in the interface variables
    ``[λ0, x_0^(0), θ_0, x_0^(1), θ_1, ..., x_0^(L-1)]`` (reference
    ``assembleCondensedSystem``) from the legs' head values ``(B, legs, ·)``
    and the interface E blocks ``(B, legs - 1, nx, nx)``, solved with
    ``refine_steps`` refinement passes. Returns ``(lam_heads, x_heads,
    thetas)``, each ``(B, legs, nx)``, and the system's block factors."""
    Bsz, legs, nx = p_leg.shape
    eye = torch.eye(nx, dtype=p_leg.dtype, device=p_leg.device)
    K = 2 * legs
    diag = p_leg.new_zeros((Bsz, K, nx, nx))
    lower = p_leg.new_zeros((Bsz, K - 1, nx, nx))
    rhs = p_leg.new_zeros((Bsz, K, nx))
    diag[:, 0] = -md[:, None, None] * eye
    diag[:, 1::2] = P_leg
    diag[:, 2::2] = Vtt_leg[:, :legs - 1]
    lower[:, 0] = G0.mT
    lower[:, 1::2] = Vxt_leg[:, :legs - 1].mT
    lower[:, 2::2] = E_if.mT
    rhs[:, 0] = -g0
    rhs[:, 1::2] = -p_leg
    rhs[:, 2::2] = -vt_leg[:, :legs - 1]
    factors = block_tridiag.factorize(diag, lower)
    sol = block_tridiag.solve_factored(factors, rhs)
    for _ in range(refine_steps):
        resid = rhs - block_tridiag.matmul(diag, lower, sol)
        sol = sol + block_tridiag.solve_factored(factors, resid)
    lam_heads, x_heads = sol[:, 0::2], sol[:, 1::2]
    # θ_i is the costate at the head of leg i + 1; the last leg's is zero
    thetas = torch.cat([lam_heads[:, 1:], torch.zeros_like(lam_heads[:, :1])], 1)
    return lam_heads, x_heads, thetas, factors


def solve_sharded(problem: LQRProblem, mudyn, mueq, mesh, axis_name: str = "t",
                  assume_explicit: bool = False, refine_steps: int = 1):
    """Parallel-in-time solve with one leg a rank along the mesh axis
    ``axis_name`` (counterpart of the JAX package's ``shard_map`` variant).

    Each rank takes leg ``i`` (its coordinate on the axis), knots ``[i L,
    (i + 1) L)`` of the ``(B, T, ·)`` problems with ``L = T / legs``;
    parameterizes it by θ and sets its own interface knot (``setupKnot`` at
    ``L - 1``, zero on the last leg); runs the θ sweep on it
    (:func:`.riccati.sweep`: the per-stage loop with K2 on the card); then
    makes the one collective of the solve, an all-gather over the axis'
    group of its interface payload ``(B, 4 nx² + 2 nx)`` (P, Vxt, Vtt, the
    interface E block, p, vt); solves the small condensed system
    redundantly on every rank; and forward-substitutes its own leg from its
    head state, costate and θ (:func:`.riccati.forward`: K4 at ``nx >=
    12``).

    Requires ``T % legs == 0`` and ``nc0 == nx``. Returns this rank's leg
    ``(xs, us, vs, lams)``, each ``(B, L, ·)``; the JAX function returns the
    global arrays sharded by leg, and assembling the legs here would be a
    second collective, so a caller that wants the whole horizon gathers
    them. The problem's tensors should be on the rank's device."""
    legs, i = mesh.size(axis_name), mesh.index(axis_name)
    kn = problem.knots
    Bsz, T = kn.Q.shape[:2]
    nx = kn.nx
    if T % legs:
        raise ValueError(f"solve_sharded requires horizon+1 ({T}) divisible by the mesh "
                         f"axis ({legs})")
    if problem.nc0 != nx:
        raise ValueError("parallel solver requires nc0 == nx (pad G0)")
    L = T // legs
    md = batch_param(mudyn, problem)
    me = batch_param(mueq, problem)
    my = kn.map(lambda a: a[:, i * L:(i + 1) * L])
    if my.nth != nx:
        my = add_parameterization(my, nx)
    if i < legs - 1:
        # this leg's outgoing interface (reference setupKnot)
        eye = torch.eye(nx, dtype=kn.Q.dtype, device=kn.Q.device)
        my = dataclasses.replace(my, Gx=my.Gx.clone(), Gu=my.Gu.clone(),
                                 Gth=my.Gth.clone(), gamma=my.gamma.clone())
        my.Gx[:, L - 1] = my.A[:, L - 1].mT
        my.Gu[:, L - 1] = my.B[:, L - 1].mT
        my.Gth[:, L - 1] = -md[:, None, None] * eye
        my.gamma[:, L - 1] = my.f[:, L - 1]
    stages = riccati.sweep(my, md, me, assume_explicit)

    # the interface payload, 4 nx² + 2 nx numbers a scenario, gathered once
    heads = [stages[k][:, 0] for k in ("Pmat", "Vxt", "Vtt")] + [my.E[:, L - 1]]
    payload = torch.cat([h.flatten(1) for h in heads]
                        + [stages["pvec"][:, 0], stages["vt"][:, 0]], -1)
    gathered = _mesh.all_gather(mesh, axis_name, payload).transpose(0, 1)  # (B, legs, ·)
    n2 = nx * nx
    P_leg, Vxt_leg, Vtt_leg, E_leg = (
        gathered[..., k * n2:(k + 1) * n2].reshape(Bsz, legs, nx, nx) for k in range(4))
    p_leg, vt_leg = gathered[..., 4 * n2:4 * n2 + nx], gathered[..., 4 * n2 + nx:]
    lam_heads, x_heads, thetas, _ = _condensed_solve(
        P_leg, Vxt_leg, Vtt_leg, E_leg[:, :legs - 1], p_leg, vt_leg, problem.G0,
        problem.g0, md, refine_steps)

    x0, lam0 = x_heads[:, i], lam_heads[:, i]
    facs = riccati.RiccatiFactors(x0=x0, lam0=lam0, **stages)
    return riccati.forward(facs, theta=thetas[:, i], x0=x0, lam0=lam0)
