"""Join two successive LQ problems by maximizing over the common costate.

Port of ``examples/gar_lqr_join.py`` (the reference's
``examples/gar-lqr-join.py``): split a horizon at t0, θ-parameterize the
first half's tail knot by the interface costate (Gx = Aᵀ, Gu = Bᵀ, Gth =
−μ·I, γ = f, the parallel solver's ``setupKnot`` convention) and the
second half's head knot by the incoming dynamics (Gx = Eᵀ), then solve

    θ* = argmax_θ  V₁(θ) + V₂(θ)   ⇔   −(H₁ + H₂) θ* = g₁ + g₂

with the value functions' sensitivities ``th_grad``/``th_hess`` from each
half's backward sweep (the per-stage loop, K2 on the card) and the SPD
solve K2 (−H is positive definite: V is concave in the costate). The
fused trajectories equal the joint solve's: the 2-leg case of the
parallel-in-time solver through the public θ interface.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import gar
from ..gar import riccati
from ..gar.lqr_problem import LQRProblem, add_parameterization, random_convex_problem
from ..gar.spd_solve import spd_solve


def split_and_join(problem: LQRProblem, t0: int, mu: float = 1e-7):
    """Split ``problem`` (a batch, explicit dynamics) at knot ``t0``, solve
    the two θ-parameterized halves and fuse them at the optimal interface
    costate. Returns ``(xs, us, vs, lams, theta)``, the solutions indexed as
    :func:`~..gar.riccati.solve`'s on the joint problem (``lams[:, t0] =
    θ``)."""
    kn = problem.knots
    T, nx = kn.Q.shape[1], kn.nx
    eye = torch.eye(nx, dtype=kn.Q.dtype, device=kn.Q.device)

    kn1 = add_parameterization(kn.map(lambda a: a[:, :t0]), nx)
    Gx, Gu, Gth, gamma = (getattr(kn1, k).clone() for k in ("Gx", "Gu", "Gth", "gamma"))
    Gx[:, -1], Gu[:, -1] = kn1.A[:, -1].mT, kn1.B[:, -1].mT
    Gth[:, -1], gamma[:, -1] = -mu * eye, kn1.f[:, -1]
    kn1 = dataclasses.replace(kn1, Gx=Gx, Gu=Gu, Gth=Gth, gamma=gamma)
    prob1 = LQRProblem(knots=kn1, G0=problem.G0, g0=problem.g0)

    kn2 = add_parameterization(kn.map(lambda a: a[:, t0:T]), nx)
    Gx2 = kn2.Gx.clone()
    Gx2[:, 0] = kn2.E[:, 0].mT if kn2.E is not None else -eye
    kn2 = dataclasses.replace(kn2, Gx=Gx2)
    # zero G0: the relaxed 0·x = 0 initial "constraint" (multiplier 0)
    prob2 = LQRProblem(knots=kn2, G0=torch.zeros_like(problem.G0[:, :nx]),
                       g0=torch.zeros_like(problem.g0[:, :nx]))

    f1 = riccati.backward(prob1, mu, mu, assume_explicit=False)
    f2 = riccati.backward(prob2, mu, mu, assume_explicit=False)
    theta = spd_solve(-(f1.th_hess + f2.th_hess), (f1.th_grad + f2.th_grad)[..., None])[..., 0]

    xs1, us1, vs1, lams1 = riccati.forward(f1, theta=theta)
    xs2, us2, vs2, lams2 = riccati.forward(f2, theta=theta)
    # the interface costate is θ (prob2's initial multiplier slot is empty)
    lams = torch.cat([lams1, theta[:, None], lams2[:, 1:]], 1)
    return (torch.cat([xs1, xs2], 1), torch.cat([us1, us2], 1), torch.cat([vs1, vs2], 1),
            lams, theta)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    T, mu = 10, 1e-8
    problem = random_convex_problem(np.random.default_rng(42), 1, T - 1, 2, 1, 0,
                                    device=args.device)
    xs_j, us_j, _, lams_j = gar.solve(problem, mu, mu, assume_explicit=True)
    xs, us, vs, lams, theta = split_and_join(problem, t0=T // 2, mu=mu)
    print("theta (interface costate):", theta[0].tolist())
    print("lambda_t0 of joint solve: ", lams_j[0, T // 2].tolist())
    print("max |dx|:", float((xs - xs_j).abs().max()))
    print("max |du|:", float((us - us_j).abs().max()))
    print("max |dlam|:", float((lams - lams_j).abs().max()))
