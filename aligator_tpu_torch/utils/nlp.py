"""Export a TrajOptProblem as a flat NLP.

PyTorch counterpart of ``aligator_tpu/utils/nlp.py`` (the reference's
``examples/convert_to_nlp.py``, which hands aligator problems to
proxsuite-nlp): the trajectory's decision variables flattened into one
vector z = [dx₀, u₀, dx₁, u₁, …, dx_N] of tangent-space coordinates around
a base trajectory, with objective and constraint callables and their exact
derivatives (``torch.func.grad`` and ``torch.func.jacrev`` where the JAX
module takes ``jax.grad`` and ``jax.jacrev``). :func:`solve_scipy` hands
them to scipy's SLSQP, an independent oracle for the ProxDDP and FDDP
solvers.

The problem is one scenario (a batch of one). Constraint sets:
EqualityConstraint → equality rows; NegativeOrthant → g(z) ≤ 0;
BoxConstraint → two inequality blocks. Other sets (L1Penalty) have no NLP
equivalent and raise ``TypeError``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..core.problem import TrajOptProblem, evaluate
from ..core.sets import BoxConstraint, EqualityConstraint, NegativeOrthant


def _unflatten(problem: TrajOptProblem, base_xs: Tensor, base_us: Tensor, z: Tensor):
    """z (tangent coordinates around ``(base_xs (N+1, nx), base_us (N,
    nu))``) → ``(xs, us)``."""
    N, ndx, nu = problem.nsteps, problem.space.ndx, problem.nu
    blk = ndx + nu
    dxs = torch.stack([z[i * blk:i * blk + ndx] for i in range(N + 1)])
    dus = torch.stack([z[i * blk + ndx:(i + 1) * blk] for i in range(N)])
    return problem.space.integrate(base_xs, dxs), base_us + dus


def _classify(constraints, dims, what):
    """The rows of a constraint stack by kind: ``(eq, le, box)``, each a
    list of row indices; ``box`` rows as ``(row, set, row in its set)``."""
    eq, le, box = [], [], []
    off = 0
    for (_, s), dim in zip(constraints, dims):
        if isinstance(s, EqualityConstraint):
            eq += range(off, off + dim)
        elif isinstance(s, NegativeOrthant):
            le += range(off, off + dim)
        elif isinstance(s, BoxConstraint):
            box += [(off + k, s, k) for k in range(dim)]
        else:
            raise TypeError(f"{what} set {type(s).__name__} has no NLP equivalent")
        off += dim
    return eq, le, box


def _row(bound: Tensor, k: int) -> Tensor:
    return bound[..., k] if bound.ndim else bound


def to_nlp(problem: TrajOptProblem, base_xs: Tensor, base_us: Tensor) -> dict:
    """NLP callables over the flat tangent variable z: ``objective``/``grad``
    (scalar, (nz,)), ``cons_eq``/``jac_eq`` (the initial condition, the
    dynamics and the equality rows), ``cons_ineq``/``jac_ineq`` (g(z) ≤ 0),
    and ``nz``. ``base_xs (N+1, nx)``, ``base_us (N, nu)``."""
    if problem.batch != 1:
        raise ValueError(f"to_nlp takes one scenario, got a batch of {problem.batch}")
    N, ndx = problem.nsteps, problem.space.ndx
    nz = (N + 1) * ndx + N * problem.nu
    stages = problem.stages
    eq, le, box = _classify(stages.constraints, stages.cstr_dims, "constraint")
    t_eq, t_le, t_box = _classify(problem.term_constraints, problem.term_cstr_dims,
                                  "terminal")
    if t_box:
        raise NotImplementedError("terminal box rows: use the negative-orthant form")
    ninit = ndx if problem.init_cstr_dim < 0 else problem.init_cstr_dim

    def data(z):
        xs, us = _unflatten(problem, base_xs, base_us, z)
        return evaluate(problem, xs[None], us[None])

    def objective(z):
        return data(z).cost[0]

    def cons_eq(z):
        d = data(z)
        parts = [d.init_res[0, :ninit], d.dyn_res[0].reshape(-1)]
        if eq:
            parts.append(d.cstr_vals[0][:, eq].reshape(-1))
        if t_eq:
            parts.append(d.term_cstr_vals[0, t_eq])
        return torch.cat(parts)

    def cons_ineq(z):
        d = data(z)
        parts = []
        if le:
            parts.append(d.cstr_vals[0][:, le].reshape(-1))
        for r, s, k in box:
            v = d.cstr_vals[0][:, r]
            parts += [v - _row(s.upper, k), _row(s.lower, k) - v]
        if t_le:
            parts.append(d.term_cstr_vals[0, t_le])
        if not parts:
            return z.new_zeros(0)
        return torch.cat(parts)

    return dict(objective=objective, grad=torch.func.grad(objective),
                cons_eq=cons_eq, jac_eq=torch.func.jacrev(cons_eq),
                cons_ineq=cons_ineq, jac_ineq=torch.func.jacrev(cons_ineq), nz=nz)


def solve_scipy(problem: TrajOptProblem, xs_init: Tensor, us_init: Tensor, tol=1e-9,
                max_iter=500):
    """Solve the flattened NLP with scipy's SLSQP from ``(xs_init, us_init)``;
    returns ``(xs, us, scipy result)``."""
    from scipy.optimize import minimize

    fns = to_nlp(problem, xs_init, us_init)
    like = xs_init

    def t(z):
        return torch.as_tensor(z, dtype=like.dtype, device=like.device)

    def n(x):
        return x.detach().cpu().numpy()

    cons = [dict(type="eq", fun=lambda z: n(fns["cons_eq"](t(z))),
                 jac=lambda z: n(fns["jac_eq"](t(z))))]
    if fns["cons_ineq"](t(np.zeros(fns["nz"]))).shape[0]:
        cons.append(dict(type="ineq",  # scipy: fun(z) >= 0
                         fun=lambda z: -n(fns["cons_ineq"](t(z))),
                         jac=lambda z: -n(fns["jac_ineq"](t(z)))))
    r = minimize(lambda z: float(fns["objective"](t(z))), np.zeros(fns["nz"]),
                 jac=lambda z: n(fns["grad"](t(z))), constraints=cons, method="SLSQP",
                 options=dict(maxiter=max_iter, ftol=tol))
    xs, us = _unflatten(problem, xs_init, us_init, t(r.x))
    return xs, us, r
