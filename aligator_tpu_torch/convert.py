"""Carry problem parameters across from numpy.

The port's problems have no trained weights: their parameters are the
problem's leaves. These functions build the port's problems from numpy
copies of the leaves of the JAX package's problems, so that the same
instance can be handed to both (the dtype of the arrays is kept).
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve
from .examples.medium_dims import linear_problem
from .examples.se2_car import se2_problem
from .gar.lqr_problem import LQRKnots, LQRProblem

KNOT_FIELDS = ("Q", "S", "R", "q", "r", "A", "B", "E", "f", "C", "D", "d")


def lqr_problem_from_numpy(arrays, device="cuda") -> LQRProblem:
    """LQ problems from a mapping of the knot fields ``Q S R q r A B E f C D
    d`` (each ``(B, T, ...)``) and ``G0 (B, nc0, nx)``, ``g0 (B, nc0)``."""
    dev = resolve(device)

    def t(name):
        return torch.tensor(np.asarray(arrays[name]), device=dev)

    knots = LQRKnots(**{k: t(k) for k in KNOT_FIELDS})
    return LQRProblem(knots=knots, G0=t("G0"), g0=t("g0"))


def linear_problem_from_numpy(params, nsteps: int, device="cuda"):
    """A linear-quadratic problem (:func:`~.examples.medium_dims.linear_problem`)
    from its leaves: ``A (nx, nx)``, ``B (nx, nu)``, ``c (nx,)``, the stage
    weights ``Q``, ``R``, the terminal weight ``Q_term``, ``x0 (B, nx)`` (or
    ``(nx,)``) and, where the problem has a control box, ``u_lower`` and
    ``u_upper``."""
    dev = resolve(device)

    def t(name):
        return torch.tensor(np.asarray(params[name]), device=dev)

    u_box = None
    if "u_lower" in params:
        u_box = (t("u_lower"), t("u_upper"))
    return linear_problem(t("A"), t("B"), t("c"), t("Q"), t("R"),
                          t("Q_term"), t("x0"), nsteps, u_box=u_box)


def se2_problem_from_numpy(params, nsteps: int = 50, device="cuda",
                           u_bound=None):
    """The SE(2) car problem from its leaves: ``x0 (B, 4)`` (or ``(4,)``),
    ``w_x`` and ``w_u`` the stage state and control weights, ``w_term`` the
    terminal weight, ``target (4,)`` and the scalar ``timestep``."""
    dev = resolve(device)

    def t(name):
        return torch.tensor(np.asarray(params[name]), device=dev)

    return se2_problem(
        x0=t("x0"), w_x=t("w_x"), w_u=t("w_u"),
        w_term=t("w_term"), target=t("target"), timestep=t("timestep"),
        nsteps=nsteps, u_bound=u_bound,
    )
