"""Stage models, trajectory-optimization problems, evaluation and derivatives.

PyTorch counterpart of ``aligator_tpu/core/problem.py``. A
:class:`TrajOptProblem` holds ONE stage model shared by all N stages and a
batch of initial states ``x0 (B, nx)``: each batch entry is one scenario.
A parameter that varies over the stages (a contact schedule, a swing-cost
weight) is a leaf with a leading N axis, checked by
:func:`~.functions.stage_param` against the ``(B, N, ·)`` block it meets.
Trajectories are ``xs (B, N+1, nx)`` and ``us (B, N, nu)``; stage functions
evaluate on the whole ``(B, N)`` block at once, and autodiff Jacobians run
over the flattened (batch × stage) axis (:func:`~.manifolds.batched_jacfwd`),
where the JAX package ``vmap``s over stages inside a ``vmap`` over scenarios.

:func:`replicate_stage` and :func:`stack_stages` give a stage model whose
tensor leaves carry a leading stage axis (``nstack`` stages), as the JAX
package stacks every problem's stages; such a model is evaluated one stage
at a time (:meth:`StageModel.at`), each over the whole batch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
from torch import Tensor

from .costs import Cost
from .dynamics import ExplicitDynamics
from .functions import StageFunction
from .manifolds import Manifold
from .sets import ConstraintSetProduct


def _map_leaves(obj, fn):
    """``obj`` with ``fn`` applied to every tensor leaf of its dataclasses
    and tuples (the manifold and the integer metadata are kept)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(_map_leaves(o, fn) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_leaves(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init
        })
    return obj


def _zip_leaves(objs, fn):
    """One object of the structure of ``objs[0]`` whose tensor leaves are
    ``fn`` of the matching leaves of all ``objs``."""
    first = objs[0]
    if isinstance(first, torch.Tensor):
        return fn(objs)
    if isinstance(first, tuple):
        return tuple(_zip_leaves(o, fn) for o in zip(*objs))
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _zip_leaves([getattr(o, f.name) for o in objs], fn)
            for f in dataclasses.fields(first) if f.init
        })
    return first


@dataclass
class StageModel:
    """One OCP node: cost + dynamics + constraint stack."""

    cost: Cost
    dynamics: ExplicitDynamics
    constraints: tuple = ()  # ((StageFunction, ConstraintSet), ...)
    space: Optional[Manifold] = None
    nu: int = 0
    cstr_dims: tuple = ()
    # stages stacked along a leading axis of the tensor leaves; 0: one
    # model shared by every stage
    nstack: int = 0

    @property
    def nc(self) -> int:
        return sum(self.cstr_dims)

    def at(self, t: int) -> "StageModel":
        """The model of stage ``t`` of a stacked model."""
        return dataclasses.replace(_map_leaves(self, lambda a: a[t]), nstack=0)

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


def replicate_stage(stage: StageModel, N: int) -> StageModel:
    """``stage`` with every tensor leaf broadcast to a leading stage axis of
    size N."""
    out = _map_leaves(stage, lambda a: a.expand((N,) + a.shape))
    return dataclasses.replace(out, nstack=N)


def stack_stages(stages: list) -> StageModel:
    """Stack stage models of one structure along a new leading axis."""
    out = _zip_leaves(list(stages), torch.stack)
    return dataclasses.replace(out, nstack=len(stages))


def _per_stage(stage: StageModel, fn, *args):
    """``fn(stage, *args)`` on ``(B, N, ·)`` blocks; a stacked model is
    evaluated one stage at a time and the results stacked on axis 1."""
    if not stage.nstack:
        return fn(stage, *args)
    outs = [fn(stage.at(t), *(a[:, t] for a in args)) for t in range(stage.nstack)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o, 1) for o in zip(*outs))
    return torch.stack(outs, 1)


@dataclass
class TrajOptProblem:
    """Batched trajectory optimization problem over horizon N.

    The default initial condition is ``xs[:, 0] ⊖ x0 = 0``. A general
    residual ``g(x_0) = 0`` of dimension ``init_cstr_dim <= ndx`` (a
    :class:`~.functions.FunctionSlice` of a state error pins part of the
    state) replaces it through ``init_constraint``; its value and Jacobian
    are padded with zero rows to ``ndx`` rows, which the initial KKT solve
    treats as inactive rows (zero multiplier), as the JAX package does."""

    stages: StageModel
    term_cost: Cost
    x0: Tensor  # (B, nx)
    term_constraints: tuple = ()  # ((StageFunction, ConstraintSet), ...)
    nsteps: int = 0
    term_cstr_dims: tuple = ()
    init_constraint: Optional[StageFunction] = None
    init_cstr_dim: int = -1  # -1: the full-state default

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
        """Initial-condition residual, zero-padded to ``(B, ndx)``."""
        if self.init_constraint is None:
            return self.space.difference(self.x0, x)
        r = self.init_constraint.value(self.space, x, x.new_zeros(x.shape[:-1] + (self.nu,)))
        pad = r.new_zeros(r.shape[:-1] + (self.space.ndx - r.shape[-1],))
        return torch.cat([r, pad], -1)

    def init_condition_jacobian(self, x: Tensor) -> Tensor:
        """∂(initial residual)/∂x, zero-padded to ``(B, ndx, ndx)``."""
        if self.init_constraint is None:
            return self.space.jdifference(self.x0, x, 1)
        J = self.init_constraint.jacobians(
            self.space, x, x.new_zeros(x.shape[:-1] + (self.nu,)))[0]
        pad = J.new_zeros(J.shape[:-2] + (self.space.ndx - J.shape[-2], J.shape[-1]))
        return torch.cat([J, pad], -2)


def make_problem(x0: Tensor, stage: StageModel, nsteps: int, term_cost: Cost,
                 term_constraints=(),
                 init_constraint: Optional[StageFunction] = None) -> TrajOptProblem:
    """Build a TrajOptProblem; ``x0`` is ``(B, nx)`` (or ``(nx,)`` for one
    scenario). ``stage`` is shared by every stage, or stacked
    (:func:`stack_stages`, one model a stage); ``init_constraint`` replaces
    the full-state initial condition by a residual ``g(x_0) = 0`` of
    dimension <= ndx."""
    x0 = torch.as_tensor(x0)
    if x0.ndim == 1:
        x0 = x0[None]
    if stage.nstack not in (0, nsteps):
        raise ValueError(f"{stage.nstack} stacked stages for {nsteps} steps")
    space, nu = stage.space, stage.nu
    tdims = tuple(f.dim(space, nu) for f, _ in term_constraints)
    init_dim = -1
    if init_constraint is not None:
        init_dim = init_constraint.dim(space, nu)
        if init_dim > space.ndx:
            raise ValueError(f"init_constraint dim {init_dim} exceeds ndx={space.ndx}")
    return TrajOptProblem(stages=stage, term_cost=term_cost, x0=x0,
                          term_constraints=tuple(term_constraints),
                          nsteps=nsteps, term_cstr_dims=tdims,
                          init_constraint=init_constraint, init_cstr_dim=init_dim)


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


def evaluate(problem: TrajOptProblem, xs: Tensor, us: Tensor,
             dynamics: bool = True) -> ProblemData:
    """Costs, dynamics residuals and constraint values along (xs, us); with
    ``dynamics=False`` the dynamics residuals are left zero (a nonlinear
    rollout knows them already)."""
    space, stage, N = problem.space, problem.stages, problem.nsteps
    x, y = xs[:, :N], xs[:, 1:]

    def values(st, x, u, y):
        res = (st.dynamics.residual(space, x, u, y) if dynamics
               else y.new_zeros(y.shape[:-1] + (space.ndx,)))
        return st.cost.value(space, x, u), res, st.constraint_values(x, u)

    costs, dyn_res, cstr_vals = _per_stage(stage, values, x, us, y)
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


def dynamics_vhp(problem: TrajOptProblem, xs: Tensor, us: Tensor,
                 lams_next: Tensor):
    """``(Hxx (B, N, ndx, ndx), Hxu (B, N, ndx, nu), Huu (B, N, nu, nu))``:
    the tangent-space Hessian blocks of ``λ_{t+1}ᵀ r_t(x, u, x_{t+1})`` wrt
    ``(x, u)`` for every stage, the terms ``hessian_approx='exact'`` adds to
    the LQ knots (the JAX package's ``ProblemData.Hxx, Hxu, Huu``).
    ``torch.func.hessian`` of the contracted residual under
    ``torch.func.vmap`` over the flattened batch × stage axis."""
    space, N, ndx = problem.space, problem.nsteps, problem.space.ndx

    def one(st, x, u, y, lam):
        def g(z, x, u, y, lam):
            r = st.dynamics.residual(space, space.integrate(x, z[:ndx]),
                                     u + z[ndx:], y)
            return (lam * r).sum(-1)

        lead = x.shape[:-1]
        flat = [a.reshape((-1, a.shape[-1])) for a in (x, u, y, lam)]
        z = x.new_zeros(ndx + u.shape[-1])
        H = torch.func.vmap(torch.func.hessian(g), in_dims=(None, 0, 0, 0, 0))(
            z, *flat).reshape(lead + z.shape + z.shape)
        return H[..., :ndx, :ndx], H[..., :ndx, ndx:], H[..., ndx:, ndx:]

    return _per_stage(problem.stages, one, xs[:, :N], us, xs[:, 1:], lams_next)


def compute_derivatives(problem: TrajOptProblem, xs: Tensor,
                        us: Tensor) -> ProblemData:
    """Evaluation plus first- and second-order (Gauss-Newton) derivatives."""
    space, stage, N = problem.space, problem.stages, problem.nsteps
    Bsz, ndx, nu = xs.shape[0], space.ndx, problem.nu
    data = evaluate(problem, xs, us)
    x, y = xs[:, :N], xs[:, 1:]

    def derivs(st, x, u, y):
        lead = x.shape[:-1]
        cost = [_bcast(a, lead + s) for a, s in zip(
            (*st.cost.gradients(space, x, u), *st.cost.hessians(space, x, u)),
            ((ndx,), (nu,), (ndx, ndx), (ndx, nu), (nu, nu)))]
        return (*cost, *st.dynamics.jacobians(space, x, u, y),
                *st.constraint_jacobians(x, u))

    Lx, Lu, Lxx, Lxu, Luu, A, Bm, E, cJx, cJu = _per_stage(
        stage, derivs, x, us, y)

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
