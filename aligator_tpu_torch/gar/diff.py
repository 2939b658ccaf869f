"""Gradients through the LQ solve (implicit function theorem).

PyTorch counterpart of ``aligator_tpu/gar/diff.py``. The solution
z = (xs, us, vs, λs) of a proximal LQ problem solves the symmetric KKT
system ``M z + c = 0``; for a loss with cotangent z̄,

    w = M⁻¹ z̄              one adjoint solve: M is symmetric, so it is the
                           same Riccati solve with the right-hand-side
                           vectors replaced by the cotangents
    ∂L/∂c = −w             the vectors q, r, d, f, g0
    ∂L/∂M_blk = −(w ⊗ z)   the blocks Q, S, R, A, B, E, C, D, G0: outer
                           products of the adjoint and primal solutions at
                           each block's place (Q and R symmetrized)

:func:`solve` is a ``torch.autograd.Function`` whose forward and backward
both run :func:`.riccati.solve`, routed by shape as everywhere (on the card:
the per-stage loop's SPD solves on K2, or K3 at ``12 <= nx <= 44`` with
explicit dynamics, and K4 forward at ``nx >= 12``). μ and
``assume_explicit`` are not differentiable; the θ blocks get zero
gradients.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from . import riccati
from .lqr_problem import LQRKnots, LQRProblem

KNOT_FIELDS = ("Q", "S", "R", "q", "r", "A", "B", "E", "f", "C", "D", "d")
THETA_FIELDS = ("Gx", "Gu", "Gth", "gamma")


def _flatten(problem: LQRProblem) -> tuple:
    kn = problem.knots
    th = THETA_FIELDS if kn.nth else ()
    return (problem.G0, problem.g0) + tuple(getattr(kn, k) for k in KNOT_FIELDS + th)


def _unflatten(fields) -> LQRProblem:
    G0, g0, *rest = fields
    names = KNOT_FIELDS + (THETA_FIELDS if len(rest) > len(KNOT_FIELDS) else ())
    return LQRProblem(knots=LQRKnots(**dict(zip(names, rest))), G0=G0, g0=g0)


def _outer(a: Tensor, b: Tensor) -> Tensor:
    return torch.einsum("bti,btj->btij", a, b)


class _Solve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mudyn, mueq, assume_explicit, *fields):
        sol = riccati.solve(_unflatten(fields), mudyn, mueq, assume_explicit)
        ctx.mu = (mudyn, mueq, assume_explicit)
        ctx.save_for_backward(*fields, *sol)
        return sol

    @staticmethod
    def backward(ctx, xb, ub, vb, lb):
        *fields, xs, us, vs, lams = ctx.saved_tensors
        mudyn, mueq, assume_explicit = ctx.mu
        problem = _unflatten(fields)
        kn, N = problem.knots, problem.horizon

        # the adjoint problem: the same matrices, right-hand sides -z̄
        f_adj = torch.cat([-lb[:, 1:], torch.zeros_like(lb[:, :1])], 1)
        adj = dataclasses.replace(
            problem, g0=-lb[:, 0],
            knots=dataclasses.replace(kn, q=-xb, r=-ub, d=-vb, f=f_adj))
        wx, wu, wv, wl = riccati.solve(adj, mudyn, mueq, assume_explicit)

        def last_zero(g):
            return torch.cat([g, torch.zeros_like(g[:, :1])], 1)

        grads = dict(
            q=-wx, r=-wu, d=-wv, f=last_zero(-wl[:, 1:]),
            Q=-0.5 * (_outer(wx, xs) + _outer(xs, wx)),
            S=-(_outer(wx, us) + _outer(xs, wu)),
            R=-0.5 * (_outer(wu, us) + _outer(us, wu)),
            A=last_zero(-(_outer(wl[:, 1:], xs[:, :N]) + _outer(lams[:, 1:], wx[:, :N]))),
            B=last_zero(-(_outer(wl[:, 1:], us[:, :N]) + _outer(lams[:, 1:], wu[:, :N]))),
            E=last_zero(-(_outer(wl[:, 1:], xs[:, 1:]) + _outer(lams[:, 1:], wx[:, 1:]))),
            C=-(_outer(wv, xs) + _outer(vs, wx)),
            D=-(_outer(wv, us) + _outer(vs, wu)),
        )
        gG0 = -(torch.einsum("bi,bj->bij", wl[:, 0], xs[:, 0])
                + torch.einsum("bi,bj->bij", lams[:, 0], wx[:, 0]))
        knot_grads = [grads[k] for k in KNOT_FIELDS]
        theta = [torch.zeros_like(getattr(kn, k)) for k in THETA_FIELDS] if kn.nth else []
        return (None, None, None, gG0, -wl[:, 0], *knot_grads, *theta)


def solve(problem: LQRProblem, mudyn, mueq, assume_explicit: bool = False):
    """Differentiable :func:`.riccati.solve`: returns ``(xs, us, vs, lams)``,
    each ``(B, T, ·)``, with gradients wrt every knot field, ``G0`` and
    ``g0``. ``mudyn``/``mueq`` are floats or ``(B,)`` tensors."""
    return _Solve.apply(mudyn, mueq, assume_explicit, *_flatten(problem))
