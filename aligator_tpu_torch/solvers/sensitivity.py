"""Parametric (θ) sensitivities of the optimal value, batched.

PyTorch counterpart of ``aligator_tpu/solvers/sensitivity.py``: given a
converged ProxDDP solve of a problem family ``θ ↦ problem(θ)``, attach the
parametric blocks of the final LQ subproblem and harvest ``th_grad = dV/dθ``
and ``th_hess = d²V/dθ²`` (the Gauss-Newton Hessian: the Schur complement
of the proximal LQ KKT system onto θ) into :class:`.proxddp.ProxDDPResults`.

θ is ``(B, nth)``, one row per scenario, and the family must build a batch
of B problems from it: a θ row may enter the leaves that meet ``(B, ·)``
blocks (the initial states, the terminal cost and terminal constraints), or
a stage leaf of shape ``(B, 1, ·)``. The θ cross-blocks ``Gx, Gu, gamma``
are nth forward-mode JVPs (``torch.func.jvp``) of the stacked Lagrangian
gradients, the tangent of direction j being ``e_j`` on every scenario: a
scenario depends on its own θ row only, so no B×B Jacobian is formed.
``Gth`` comes from nth² nested JVPs of the per-stage Lagrangian values. The
θ-aware LQ then goes through :func:`~..gar.riccati.backward` (with θ
blocks K1 and K3 are gated off, and the θ columns ride the per-stage loop's
SPD solves, K2 on the card).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable

import torch
from torch import Tensor

from ..core import problem as problem_mod
from ..core.manifolds import VectorSpace
from ..gar import riccati
from . import proxddp as P


def _lagrangian_values(data, vs, vs_term, lams) -> Tensor:
    """The per-stage Lagrangian ``(B, N+1)``: stage costs plus the costate
    and multiplier terms of each stage, the terminal cost and initial
    condition at index N."""
    s_stage = (data.stage_costs + (lams[:, 1:] * data.dyn_res).sum(-1)
               + (vs * data.cstr_vals).sum(-1))
    s_term = (data.term_cost + (lams[:, 0] * data.init_res).sum(-1)
              + (vs_term * data.term_cstr_vals).sum(-1))
    return torch.cat([s_stage, s_term[:, None]], 1)


def _directions(theta: Tensor):
    eye = torch.eye(theta.shape[-1], dtype=theta.dtype, device=theta.device)
    return [eye[j].expand_as(theta) for j in range(theta.shape[-1])]


def theta_sensitivities(problem_of_theta: Callable, theta: Tensor,
                        cfg: P.ProxDDPConfig, res: P.ProxDDPResults) -> P.ProxDDPResults:
    """``res`` with ``th_grad (B, nth)`` and ``th_hess (B, nth, nth)``
    filled; ``res`` is the converged solve of ``problem_of_theta(theta)``
    with ``cfg``, ``theta`` is ``(B, nth)``."""
    prob0 = problem_of_theta(theta)
    xs, us, vs, vs_term, lams = res.xs, res.us, res.vs, res.vs_term, res.lams
    mu = res.mu_final
    nu = prob0.nu

    def pieces(th):
        prob = problem_of_theta(th)
        data = problem_mod.compute_derivatives(prob, xs, us)
        Lxs, Lus = P._lagrangian_grads(prob, cfg, data, lams, vs, vs_term)
        return Lxs, Lus, _lagrangian_values(data, vs, vs_term, lams)

    def values(th):
        data = problem_mod.evaluate(problem_of_theta(th), xs, us)
        return _lagrangian_values(data, vs, vs_term, lams)

    dirs = _directions(theta)
    tangents = [torch.func.jvp(pieces, (theta,), (e,))[1] for e in dirs]
    Gx, Gu_s, gamma = (torch.stack(t, -1) for t in zip(*tangents))

    def d_values(e):
        return lambda th: torch.func.jvp(values, (th,), (e,))[1]

    Gth = torch.stack([
        torch.stack([torch.func.jvp(d_values(ej), (theta,), (ei,))[1] for ej in dirs], -1)
        for ei in dirs], -2)
    Gu = torch.cat([Gu_s, Gu_s.new_zeros(Gu_s.shape[:1] + (1, nu, Gu_s.shape[-1]))], 1)

    # the final LQ subproblem at the converged point
    data = problem_mod.compute_derivatives(prob0, xs, us)
    st_like = SimpleNamespace(mu=mu, prev_lams=lams, prev_vs=vs, prev_vs_term=vs_term)
    m = P._compute_multipliers(prob0, cfg, data, st_like, lams, vs, vs_term)
    Lxs, Lus = P._lagrangian_grads(prob0, cfg, data, lams, vs, vs_term)
    preg = torch.full_like(mu, max(cfg.reg_init, cfg.reg_min))
    lq = P._assemble_lq(prob0, cfg, data, m, Lxs, Lus, preg, mu)
    lq = dataclasses.replace(lq, knots=dataclasses.replace(
        lq.knots, Gx=Gx, Gu=Gu, Gth=Gth, gamma=gamma))
    assume_explicit = isinstance(prob0.space, VectorSpace) and getattr(
        prob0.stages.dynamics, "is_explicit", True)
    facs = riccati.backward(lq, cfg.dyn_al_scale * mu, mu, assume_explicit)
    return dataclasses.replace(res, th_grad=facs.th_grad, th_hess=facs.th_hess)


def solve_with_sensitivities(problem_of_theta: Callable, theta: Tensor,
                             cfg: P.ProxDDPConfig = P.ProxDDPConfig(),
                             **solve_kwargs) -> P.ProxDDPResults:
    """Solve ``problem_of_theta(theta)`` and attach the θ sensitivities."""
    res = P.solve(problem_of_theta(theta), cfg, **solve_kwargs)
    return theta_sensitivities(problem_of_theta, theta, cfg, res)
