"""Cyclic (periodic) LQ problem through the θ parameterization.

Port of ``examples/gar_cyclic_lqr.py`` (the reference's
``examples/gar-cycle-lqr-1d.py`` / ``-2d.py``): periodicity x₀ = x_T is
enforced by taking its multiplier as the parameter θ (``Gx[0] = +I``,
``Gx[T] = −I`` put θᵀ(x₀ − x_T) into the Lagrangian); the backward sweep
(the per-stage loop, K2 on the card) gives the dual function's gradient
and Hessian and θ* = −H⁻¹g, by the SPD solve K2 on −H (the dual is
concave), recovers the periodic orbit. Mid-horizon targets pull the state
to +0.2 then −0.1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve
from ..gar import riccati
from ..gar.lqr_problem import LQRKnots, LQRProblem, add_parameterization
from ..gar.spd_solve import spd_solve


def create_cyclic_problem(T=30, nx=1, nu=1, dtype=torch.float64, seed=42,
                          device="cuda") -> LQRProblem:
    """The JAX example's chain (a batch of one): x' = 1.2 x + u + f, the
    drift f and control gradients r drawn uniformly (a numpy generator
    seeded ``seed``, where the JAX example draws with ``jax.random``),
    mid-horizon and terminal (x_f = 0.05) targets and no initial condition
    (the orbit is free)."""
    rng = np.random.default_rng(seed)
    Tk = T + 1

    def eye(n, m=None):
        return np.eye(n, m)

    Q = np.tile(0.01 * eye(nx), (Tk, 1, 1))
    q = np.zeros((Tk, nx))
    r = np.zeros((Tk, nu))
    r[:T] = 0.01 * (2.0 * rng.uniform(size=(T, nu)) - 1.0)
    f = np.zeros((Tk, nx))
    f[:T] = 0.1 * (2.0 * rng.uniform(size=(T, nx)) - 1.0)
    Q[T] = eye(nx)
    q[T] = -0.05 * np.ones(nx)
    for t0, v in ((T // 3, 0.2), (2 * T // 3, -0.1)):
        Q[t0] = 0.05 * eye(nx)
        q[t0] = -0.05 * v * np.ones(nx)
    arrays = dict(
        Q=Q, S=np.zeros((Tk, nx, nu)), R=np.tile(0.01 * eye(nu), (Tk, 1, 1)), q=q, r=r,
        A=np.tile(1.2 * eye(nx), (Tk, 1, 1)), B=np.tile(eye(nx, nu), (Tk, 1, 1)),
        E=np.tile(-eye(nx), (Tk, 1, 1)), f=f, C=np.zeros((Tk, 0, nx)),
        D=np.zeros((Tk, 0, nu)), d=np.zeros((Tk, 0)))
    dev = resolve(device)

    def t(a):
        return torch.tensor(np.asarray(a)[None], dtype=dtype, device=dev)

    # free initial state: zero G0 (relaxed 0·x = 0, multiplier 0)
    return LQRProblem(knots=LQRKnots(**{k: t(v) for k, v in arrays.items()}),
                      G0=t(np.zeros((nx, nx))), g0=t(np.zeros(nx)))


def solve_cyclic(problem: LQRProblem, mu=1e-9):
    """Solve with the periodicity constraint x₀ = x_T through θ; returns
    ``(xs, us, lams, theta)``."""
    kn = problem.knots
    nx = kn.nx
    eye = torch.eye(nx, dtype=kn.Q.dtype, device=kn.Q.device)
    if kn.nth != nx:
        kn = add_parameterization(kn, nx)
    Gx = kn.Gx.clone()
    Gx[:, 0], Gx[:, -1] = eye, -eye
    prob = dataclasses.replace(problem, knots=dataclasses.replace(kn, Gx=Gx))
    factors = riccati.backward(prob, mu, mu, assume_explicit=False)
    theta = spd_solve(-factors.th_hess, factors.th_grad[..., None])[..., 0]
    xs, us, vs, lams = riccati.forward(factors, theta=theta)
    return xs, us, lams, theta


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    xs, us, lams, theta = solve_cyclic(create_cyclic_problem(T=30, device=args.device))
    print("x0:", xs[0, 0].tolist(), " xT:", xs[0, -1].tolist())
    print("periodicity gap |x0 - xT|:", float((xs[0, 0] - xs[0, -1]).abs().max()))
    print("theta (periodicity multiplier):", theta[0].tolist())
