"""The medium-dim problems of the benchmarks.

Ports of ``bench.py:make_humanoid_dims_problem`` (nx=36, nu=12, a control
box; N=100, batch 1024 in the bench) and ``bench_lqr.py:make_dense_lqr``
(the reference's dense random LQR, nx=56, nu=22, N=100, batch 256). Both
are linear dynamics on a vector space with quadratic costs, built by
:func:`linear_problem`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from .. import core
from .._device import resolve


def linear_problem(A: Tensor, B: Tensor, c: Tensor, Q: Tensor, R: Tensor,
                   Q_term: Tensor, x0: Tensor, nsteps: int,
                   u_box=None) -> core.TrajOptProblem:
    """Dynamics ``x' = A x + B u + c`` on R^nx, stage cost ``½x'Qx +
    ½u'Ru``, terminal cost ``½x'Q_term x``, initial states ``x0 (B, nx)``
    (or ``(nx,)``); ``u_box = (lower, upper)`` adds ``lower <= u <= upper``
    on every stage."""
    nx, nu = B.shape
    space = core.VectorSpace(nx)
    dyn = core.LinearDiscreteDynamics(A=A, B=B, c=c)
    cost = core.QuadraticCost.create(Q, R)
    term = core.QuadraticCost.create(Q_term, R.new_zeros((nu, nu)))
    constraints = ()
    if u_box is not None:
        constraints = ((
            core.ControlErrorResidual(target=R.new_zeros(nu)),
            core.BoxConstraint(lower=u_box[0], upper=u_box[1]),
        ),)
    stage = core.make_stage(cost, dyn, space, nu, constraints)
    return core.make_problem(x0, stage, nsteps, term)


def make_humanoid_dims_problem(nsteps: int = 100, dtype=torch.float32,
                               device="cuda") -> core.TrajOptProblem:
    """ProxDDP problem at humanoid dims (nx=36, nu=12): an 18-DoF
    double-integrator chain whose first 6 DoF are unactuated (a floating
    base), dt = 0.02, control bounds |u| <= 2, one scenario at the nominal
    initial state (replace ``x0`` by a ``(B, 36)`` batch)."""
    dev = resolve(device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    nq, nu, dt = 18, 12, 0.02
    nx = 2 * nq
    eye, zero = np.eye(nq), np.zeros((nq, nq))
    A = np.block([[eye, dt * eye], [zero, eye]])
    Bv = np.concatenate([np.zeros((6, nu)), np.eye(nu)])
    B = np.concatenate([np.zeros((nq, nu)), dt * Bv])
    x0 = np.zeros(nx)
    x0[0] = 0.5
    return linear_problem(
        t(A), t(B), t(np.zeros(nx)), t(0.01 * np.eye(nx)),
        t(0.001 * np.eye(nu)), t(10.0 * np.eye(nx)), t(x0), nsteps,
        u_box=(t(-2.0 * np.ones(nu)), t(2.0 * np.ones(nu))),
    )


def make_dense_lqr(nx: int = 56, nu: int = 22, nsteps: int = 100,
                   dtype=torch.float32, device="cuda",
                   rng: np.random.Generator | None = None
                   ) -> core.TrajOptProblem:
    """Random stable dense LQR (the reference's ``bench/lqr.cpp``): A with
    N(0, 1/nx) entries scaled to spectral radius 0.95, B with N(0, 1/nu)
    entries, ``Q = Qh Qh'/nx + 0.1 I``, ``R = Rh Rh'/nu + 0.1 I``, terminal
    cost 10 Q, x0 = 1; drawn from ``rng`` (default: seed 42)."""
    rng = np.random.default_rng(42) if rng is None else rng
    dev = resolve(device)
    A = rng.standard_normal((nx, nx)) / math.sqrt(nx)
    A *= 0.95 / np.abs(np.linalg.eigvals(A)).max()
    B = rng.standard_normal((nx, nu)) / math.sqrt(nu)
    Qh = rng.standard_normal((nx, nx))
    Q = Qh @ Qh.T / nx + 0.1 * np.eye(nx)
    Rh = rng.standard_normal((nu, nu))
    R = Rh @ Rh.T / nu + 0.1 * np.eye(nu)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return linear_problem(t(A), t(B), t(np.zeros(nx)), t(Q), t(R),
                          t(10.0 * Q), t(np.ones(nx)), nsteps)
