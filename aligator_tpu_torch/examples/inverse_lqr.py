"""Inverse LQR: recover cost weights from demonstrations by gradient descent
through the LQ solve.

Port of ``examples/inverse_lqr.py``. :func:`~..gar.diff.solve` gives the
gradients of the LQ solution wrt every problem matrix, so inverse optimal
control is plain autograd and ``torch.optim.Adam``. The expert's
trajectories come from hidden diagonal weights (Q*, R*) on a chain of two
double integrators (x ∈ R⁴, u ∈ R², dt = 0.1, N = 40); the learner starts
from identity weights and fits ‖xs − xs*‖² + ‖us − us*‖² over
log-parameterized diagonals, all demonstrations in one batch.

Run: ``python -m aligator_tpu_torch.examples.inverse_lqr [--device cpu]``
(16 demonstrations, 300 Adam steps at lr 0.1, as published).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .._device import resolve
from ..gar import diff
from ..gar.lqr_problem import LQRKnots, LQRProblem

MU = 1e-8
WQ_TRUE = (3.0, 0.5, 0.1, 2.0)
WR_TRUE = (0.3, 1.5)


def lqr_template(A: Tensor, B: Tensor, N: int) -> LQRProblem:
    """One LQ problem over N stages with dynamics ``x' = A x + B u``, unit
    weights and the initial condition ``-x0 + g0 = 0`` (``g0`` the initial
    state); the dynamics fields at index N are kept as the JAX package's
    template keeps them."""
    nx, nu = B.shape
    T = N + 1

    def tile(M):
        return M.expand((1, T) + M.shape).clone()

    eye_x = torch.eye(nx, dtype=A.dtype, device=A.device)
    eye_u = torch.eye(nu, dtype=A.dtype, device=A.device)
    z = A.new_zeros
    knots = LQRKnots(
        Q=tile(eye_x), S=z((1, T, nx, nu)), R=tile(eye_u), q=z((1, T, nx)),
        r=z((1, T, nu)), A=tile(A), B=tile(B), E=tile(-eye_x), f=z((1, T, nx)),
        C=z((1, T, 0, nx)), D=z((1, T, 0, nu)), d=z((1, T, 0)),
    )
    return LQRProblem(knots=knots, G0=-eye_x[None], g0=z((1, nx)))


def make_problem_template(N: int = 40, dtype=torch.float64, device="cuda") -> LQRProblem:
    """The published template: two unit masses, positions and velocities."""
    dev = resolve(device)
    dt = 0.1
    A = torch.eye(4, dtype=dtype, device=dev)
    A[0, 2] = A[1, 3] = dt
    B = torch.zeros((4, 2), dtype=dtype, device=dev)
    B[2, 0] = B[3, 1] = dt
    return lqr_template(A, B, N)


def set_weights(template: LQRProblem, log_wq: Tensor, log_wr: Tensor,
                x0s: Tensor) -> LQRProblem:
    """The template with diagonal weights ``exp(log_wq)``, ``exp(log_wr)``
    on every knot, one problem per initial state of ``x0s (B, nx)``."""
    Bsz = x0s.shape[0]
    kn = template.knots.map(lambda t: t.expand((Bsz,) + t.shape[1:]))
    T = kn.Q.shape[1]
    Q = torch.diag(torch.exp(log_wq)).expand(Bsz, T, -1, -1)
    R = torch.diag(torch.exp(log_wr)).expand(Bsz, T, -1, -1)
    return LQRProblem(knots=LQRKnots(**{**kn.__dict__, "Q": Q, "R": R}),
                      G0=template.G0.expand(Bsz, -1, -1), g0=x0s)


def solve_traj(template: LQRProblem, log_wq: Tensor, log_wr: Tensor, x0s: Tensor):
    """``(xs, us)`` of the weighted problems, differentiable in the weights."""
    xs, us, _, _ = diff.solve(set_weights(template, log_wq, log_wr, x0s), MU, MU, True)
    return xs, us


def expert(template: LQRProblem, x0s: Tensor):
    """The expert's trajectories ``(xs*, us*)``: the weights ``WQ_TRUE``,
    ``WR_TRUE``."""
    def log(w):
        return torch.log(torch.tensor(w, dtype=x0s.dtype, device=x0s.device))

    with torch.no_grad():
        return solve_traj(template, log(WQ_TRUE), log(WR_TRUE), x0s)


def loss(template: LQRProblem, x0s: Tensor, target, log_wq: Tensor,
         log_wr: Tensor) -> Tensor:
    """Mean squared distance of the weighted problems' trajectories to the
    ``target`` pair ``(xs*, us*)``."""
    xs, us = solve_traj(template, log_wq, log_wr, x0s)
    return ((xs - target[0]) ** 2).mean() + ((us - target[1]) ** 2).mean()


def fit(template: LQRProblem, x0s: Tensor, steps: int = 300, lr: float = 0.1,
        log_every: int = 0):
    """Adam on the log-weights from zero against the expert's trajectories.
    Returns ``(log_wq, log_wr, losses)``, ``losses[k]`` the loss at the
    start of step k and ``losses[steps]`` the final one."""
    target = expert(template, x0s)
    q = x0s.new_zeros(4, requires_grad=True)
    r = x0s.new_zeros(2, requires_grad=True)
    opt = torch.optim.Adam([q, r], lr=lr)
    losses = []
    for k in range(steps):
        opt.zero_grad()
        val = loss(template, x0s, target, q, r)
        val.backward()
        opt.step()
        losses.append(val.detach())
        if log_every and k % log_every == 0:
            print(f"iter {k:4d}  loss {float(val.detach()):.3e}")
    with torch.no_grad():
        losses.append(loss(template, x0s, target, q, r))
    return q.detach(), r.detach(), torch.stack(losses)


def main(n_demos: int = 16, steps: int = 300, device="cuda", seed: int = 0):
    dev = resolve(device)
    template = make_problem_template(device=dev)
    x0s = torch.tensor(np.random.default_rng(seed).standard_normal((n_demos, 4)),
                       dtype=torch.float64, device=dev)
    q, r, losses = fit(template, x0s, steps, log_every=50)
    print("loss final:", float(losses[-1]))
    # inverse optimal control is ill-posed: different weightings induce near
    # identical trajectories, so the trajectory match, not the weights, is
    # the measure of success
    ratio = torch.cat([torch.exp(q) / torch.tensor(WQ_TRUE, device=dev),
                       torch.exp(r) / torch.tensor(WR_TRUE, device=dev)])
    print("recovered/true weight ratios:", (ratio / ratio.mean()).tolist())
    return q, r, losses


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--demos", type=int, default=16)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()
    main(args.demos, args.steps, args.device)
