"""Standalone gar usage: one proximal LQ problem solved three ways.

Port of ``examples/gar_lqr.py`` (the reference's ``examples/gar-elqr.py``):
the serial solve (:func:`~..gar.riccati.solve_and_gains`, the fused
Riccati kernel K1 on the card where its gate takes the shape, here (nx,
nu, nc) = (4, 2, 1) with explicit E), its KKT residuals, the
parallel-in-time solve with 4 legs (:func:`~..gar.parallel.solve`: its
legs' θ sweeps on the per-stage loop, K2) and the dense oracle against it,
and the θ sensitivities of a parameterized copy (θ in the cost gradients
through Gx; the θ backward on K2). Run ``python -m
aligator_tpu_torch.examples.gar_lqr --device cpu`` for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import gar
from ..gar import parallel, riccati
from ..gar.lqr_problem import LQRProblem, add_parameterization, random_convex_problem

SHAPE = dict(N=23, nx=4, nu=2, nc=1)  # the JAX example's problem
MUDYN, MUEQ = 1e-4, 1e-5
LEGS, NTH = 4, 3


def run(problem: LQRProblem, mudyn=MUDYN, mueq=MUEQ, legs=LEGS, nth=NTH) -> dict:
    """The example's outputs for a batch of LQ problems with explicit
    dynamics (E = −I): ``serial`` and ``parallel`` and ``dense`` solutions
    ``(xs, us, vs, lams)``, the serial solve's ``kkt`` errors, and the θ
    backward's ``th_grad (B, nth)`` and ``th_hess (B, nth, nth)`` with Gx =
    0.1 on every knot."""
    serial = riccati.solve_and_gains(problem, mudyn, mueq, assume_explicit=True)[:4]
    par = parallel.solve(problem, mudyn, mueq, legs=legs, assume_explicit=True)
    dense = gar.dense_solve(problem, mudyn, mueq)
    kn = add_parameterization(problem.knots, nth)
    kn = dataclasses.replace(kn, Gx=torch.full_like(kn.Gx, 0.1))
    facs = riccati.backward(dataclasses.replace(problem, knots=kn), mudyn, mueq,
                            assume_explicit=True)
    return dict(serial=serial, parallel=par, dense=dense,
                kkt=gar.kkt_error(problem, *serial, mudyn, mueq),
                th_grad=facs.th_grad, th_hess=facs.th_hess)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    prob = random_convex_problem(np.random.default_rng(0), 1, SHAPE["N"], SHAPE["nx"],
                                 SHAPE["nu"], SHAPE["nc"], device=args.device)
    out = run(prob)
    xs = out["serial"][0]
    print("serial   KKT:", [f"{float(e.max()):.2e}" for e in out["kkt"]])
    print("parallel vs serial:", float((out["parallel"][0] - xs).abs().max()))
    print("dense vs serial:", float((out["dense"][0] - xs).abs().max()))
    print("th_grad:", out["th_grad"][0].tolist())
    H = out["th_hess"][0]
    print("th_hess symmetric:", bool(torch.allclose(H, H.mT, atol=1e-8)))
