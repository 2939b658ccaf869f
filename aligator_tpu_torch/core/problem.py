"""Stage models, trajectory-optimization problems, evaluation and derivatives.

PyTorch counterpart of ``aligator_tpu/core/problem.py``. A
:class:`TrajOptProblem` holds ONE stage model shared by all N stages and a
batch of initial states ``x0 (B, nx)``: each batch entry is one scenario.
Trajectories are ``xs (B, N+1, nx)`` and ``us (B, N, nu)``; stage functions
evaluate on the whole ``(B, N)`` block at once, and autodiff Jacobians run
over the flattened (batch × stage) axis (:func:`~.manifolds.batched_jacfwd`),
where the JAX package ``vmap``s over stages inside a ``vmap`` over scenarios.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import Tensor

from .costs import Cost
from .dynamics import ExplicitDynamics
from .manifolds import Manifold
from .sets import ConstraintSetProduct


@dataclass
class StageModel:
    """One OCP node: cost + dynamics + constraint stack."""

    cost: Cost
    dynamics: ExplicitDynamics
    constraints: tuple = ()  # ((StageFunction, ConstraintSet), ...)
    space: Optional[Manifold] = None
    nu: int = 0
    cstr_dims: tuple = ()

    @property
    def nc(self) -> int:
        return sum(self.cstr_dims)

    def constraint_values(self, x: Tensor, u: Tensor) -> Tensor:
        if not self.constraints:
            return x.new_zeros(x.shape[:-1] + (0,))
        return torch.cat([f.value(self.space, x, u) for f, _ in self.constraints], -1)

    def constraint_jacobians(self, x: Tensor, u: Tensor):
        if not self.constraints:
            lead = x.shape[:-1]
            return (
                x.new_zeros(lead + (0, self.space.ndx)),
                x.new_zeros(lead + (0, self.nu)),
            )
        Jxs, Jus = zip(*(f.jacobians(self.space, x, u) for f, _ in self.constraints))
        return torch.cat(Jxs, -2), torch.cat(Jus, -2)

    def constraint_set(self) -> ConstraintSetProduct:
        return ConstraintSetProduct(
            sets=tuple(s for _, s in self.constraints), dims=self.cstr_dims
        )


def make_stage(cost: Cost, dynamics: ExplicitDynamics, space: Manifold,
               nu: int, constraints=()) -> StageModel:
    """Build a StageModel; constraint dims come from each function's ``dim``."""
    dims = tuple(f.dim(space, nu) for f, _ in constraints)
    return StageModel(cost=cost, dynamics=dynamics,
                      constraints=tuple(constraints), space=space, nu=nu,
                      cstr_dims=dims)


@dataclass
class TrajOptProblem:
    """Batched trajectory optimization problem over horizon N with the
    initial condition ``xs[:, 0] ⊖ x0 = 0``."""

    stages: StageModel
    term_cost: Cost
    x0: Tensor  # (B, nx)
    term_constraints: tuple = ()  # ((StageFunction, ConstraintSet), ...)
    nsteps: int = 0
    term_cstr_dims: tuple = ()

    @property
    def batch(self) -> int:
        return self.x0.shape[0]

    @property
    def space(self) -> Manifold:
        return self.stages.space

    @property
    def nu(self) -> int:
        return self.stages.nu

    @property
    def nc(self) -> int:
        return self.stages.nc

    @property
    def nc_term(self) -> int:
        return sum(self.term_cstr_dims)

    def term_constraint_values(self, x: Tensor) -> Tensor:
        if not self.term_constraints:
            return x.new_zeros(x.shape[:-1] + (0,))
        u0 = x.new_zeros(x.shape[:-1] + (self.nu,))
        return torch.cat(
            [f.value(self.space, x, u0) for f, _ in self.term_constraints], -1
        )

    def term_constraint_jacobians(self, x: Tensor) -> Tensor:
        if not self.term_constraints:
            return x.new_zeros(x.shape[:-1] + (0, self.space.ndx))
        u0 = x.new_zeros(x.shape[:-1] + (self.nu,))
        return torch.cat(
            [f.jacobians(self.space, x, u0)[0] for f, _ in self.term_constraints],
            -2,
        )

    def term_constraint_set(self) -> ConstraintSetProduct:
        return ConstraintSetProduct(
            sets=tuple(s for _, s in self.term_constraints),
            dims=self.term_cstr_dims,
        )

    def init_condition_residual(self, x: Tensor) -> Tensor:
        return self.space.difference(self.x0, x)

    def init_condition_jacobian(self, x: Tensor) -> Tensor:
        return self.space.jdifference(self.x0, x, 1)


def make_problem(x0: Tensor, stage: StageModel, nsteps: int, term_cost: Cost,
                 term_constraints=()) -> TrajOptProblem:
    """Build a TrajOptProblem; ``x0`` is ``(B, nx)`` (or ``(nx,)`` for one
    scenario)."""
    x0 = torch.as_tensor(x0)
    if x0.ndim == 1:
        x0 = x0[None]
    tdims = tuple(f.dim(stage.space, stage.nu) for f, _ in term_constraints)
    return TrajOptProblem(stages=stage, term_cost=term_cost, x0=x0,
                          term_constraints=tuple(term_constraints),
                          nsteps=nsteps, term_cstr_dims=tdims)


@dataclass
class ProblemData:
    """Evaluation (and optionally derivative) data, batch first."""

    cost: Tensor  # (B,) total trajectory cost
    stage_costs: Tensor  # (B, N)
    term_cost: Tensor  # (B,)
    init_res: Tensor  # (B, ndx)    xs[:, 0] ⊖ x0
    dyn_res: Tensor  # (B, N, ndx) dynamics residuals
    cstr_vals: Tensor  # (B, N, nc)
    term_cstr_vals: Tensor  # (B, nc_term)
    # --- derivatives (None unless compute_derivatives) ---
    Lx: Optional[Tensor] = None  # (B, N+1, ndx) cost gradients incl. terminal
    Lu: Optional[Tensor] = None  # (B, N, nu)
    Lxx: Optional[Tensor] = None  # (B, N+1, ndx, ndx)
    Lxu: Optional[Tensor] = None  # (B, N, ndx, nu)
    Luu: Optional[Tensor] = None  # (B, N, nu, nu)
    A: Optional[Tensor] = None  # (B, N, ndx, ndx) dynamics residual ∂x
    B: Optional[Tensor] = None  # (B, N, ndx, nu)
    E: Optional[Tensor] = None  # (B, N, ndx, ndx) dynamics residual ∂y
    cstr_Jx: Optional[Tensor] = None  # (B, N, nc, ndx)
    cstr_Ju: Optional[Tensor] = None  # (B, N, nc, nu)
    term_cstr_Jx: Optional[Tensor] = None  # (B, nc_term, ndx)
    init_Jx: Optional[Tensor] = None  # (B, ndx, ndx)


def _bcast(t, shape) -> Tensor:
    return torch.as_tensor(t).expand(shape)


def evaluate(problem: TrajOptProblem, xs: Tensor, us: Tensor) -> ProblemData:
    """Costs, dynamics residuals and constraint values along (xs, us)."""
    space, stage, N = problem.space, problem.stages, problem.nsteps
    x, y = xs[:, :N], xs[:, 1:]
    costs = stage.cost.value(space, x, us)
    dyn_res = stage.dynamics.residual(space, x, us, y)
    cstr_vals = stage.constraint_values(x, us)
    xN = xs[:, N]
    u0 = xs.new_zeros(xN.shape[:-1] + (problem.nu,))
    tc = problem.term_cost.value(space, xN, u0)
    return ProblemData(
        cost=costs.sum(1) + tc,
        stage_costs=costs,
        term_cost=tc,
        init_res=problem.init_condition_residual(xs[:, 0]),
        dyn_res=dyn_res,
        cstr_vals=cstr_vals,
        term_cstr_vals=problem.term_constraint_values(xN),
    )


def compute_derivatives(problem: TrajOptProblem, xs: Tensor,
                        us: Tensor) -> ProblemData:
    """Evaluation plus first- and second-order (Gauss-Newton) derivatives."""
    space, stage, N = problem.space, problem.stages, problem.nsteps
    Bsz, ndx, nu = xs.shape[0], space.ndx, problem.nu
    data = evaluate(problem, xs, us)
    x, y = xs[:, :N], xs[:, 1:]
    Lx, Lu = stage.cost.gradients(space, x, us)
    Lxx, Lxu, Luu = stage.cost.hessians(space, x, us)
    A, Bm, E = stage.dynamics.jacobians(space, x, us, y)
    cJx, cJu = stage.constraint_jacobians(x, us)

    xN = xs[:, N]
    u0 = xs.new_zeros(xN.shape[:-1] + (nu,))
    tLx, _ = problem.term_cost.gradients(space, xN, u0)
    tLxx, _, _ = problem.term_cost.hessians(space, xN, u0)

    data.Lx = torch.cat([_bcast(Lx, (Bsz, N, ndx)), _bcast(tLx, (Bsz, ndx))[:, None]], 1)
    data.Lu = _bcast(Lu, (Bsz, N, nu))
    data.Lxx = torch.cat(
        [_bcast(Lxx, (Bsz, N, ndx, ndx)), _bcast(tLxx, (Bsz, ndx, ndx))[:, None]], 1
    )
    data.Lxu = _bcast(Lxu, (Bsz, N, ndx, nu))
    data.Luu = _bcast(Luu, (Bsz, N, nu, nu))
    data.A, data.B, data.E = A, Bm, E
    data.cstr_Jx, data.cstr_Ju = cJx, cJu
    data.term_cstr_Jx = problem.term_constraint_jacobians(xN)
    data.init_Jx = problem.init_condition_jacobian(xs[:, 0])
    return data
