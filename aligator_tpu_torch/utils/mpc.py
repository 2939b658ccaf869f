"""Receding-horizon MPC utilities.

PyTorch counterpart of ``aligator_tpu/utils/mpc.py`` (the reference's
``TrajOptProblem::replaceStageCircular``, ``SolverProxDDP::cycleProblem``
and ``rotate_vec_left``). Trajectories are batch first, ``(B, N+1, ·)``, so
their time axis is 1; a stage-varying leaf of a stage model carries its
stage axis first, ``(N, ·)``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from ..core.dynamics import dynamics_at
from ..core.problem import TrajOptProblem, _map_leaves, _zip_leaves


def roll_left(a: Tensor, new_last=None, dim: int = 1) -> Tensor:
    """``a`` rotated one step left along ``dim`` (the time axis of a
    ``(B, T, ·)`` trajectory), ``new_last`` written into the freed last slot
    (else the old first entry wraps around)."""
    out = torch.roll(a, -1, dims=dim)
    if new_last is not None:
        out.select(dim, -1).copy_(new_last)
    return out


def _rotate_stage_params(obj, new, N: int):
    """``obj`` with every leaf that a dataclass of it lists in its
    ``STAGE_PARAMS`` and that carries a stage axis of size N rolled one
    stage left, ``new``'s matching leaf (one stage's value) or else the
    popped first row in the last slot."""
    if isinstance(obj, tuple):
        return tuple(_rotate_stage_params(o, None if new is None else n, N)
                     for o, n in zip(obj, new if new is not None else obj))
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return obj
    varying = getattr(obj, "STAGE_PARAMS", {})
    changes = {}
    for f in dataclasses.fields(obj):
        if not f.init:
            continue
        val = getattr(obj, f.name)
        nval = None if new is None else getattr(new, f.name)
        if f.name in varying and isinstance(val, Tensor):
            if val.ndim == varying[f.name] + 1 and val.shape[0] == N:
                changes[f.name] = roll_left(val, nval, dim=0)
        elif isinstance(val, tuple) or (dataclasses.is_dataclass(val)
                                        and not isinstance(val, type)):
            sub = _rotate_stage_params(val, nval, N)
            if sub is not val:
                changes[f.name] = sub
    return dataclasses.replace(obj, **changes) if changes else obj


def cycle_problem(problem: TrajOptProblem, new_stage=None,
                  new_x0: Tensor = None) -> TrajOptProblem:
    """The problem with its stages rotated one step left
    (replaceStageCircular). A stacked model (``nstack``) rolls every leaf;
    a model shared by the stages rolls its stage-varying leaves (a contact
    schedule, ``STAGE_PARAMS``). ``new_stage`` (a model of one stage: its
    leaves without the stage axis) is installed in the freed last slot,
    else the popped first stage wraps around; ``new_x0 (B, nx)`` replaces
    the initial states."""
    stages, N = problem.stages, problem.nsteps
    if stages.nstack:
        if new_stage is None:
            rolled = _map_leaves(stages, lambda a: roll_left(a, dim=0))
        else:
            rolled = _zip_leaves([stages, new_stage],
                                 lambda ab: roll_left(ab[0], ab[1], dim=0))
        rolled = dataclasses.replace(rolled, nstack=stages.nstack)
    else:
        rolled = _rotate_stage_params(stages, new_stage, N)
    out = dataclasses.replace(problem, stages=rolled)
    if new_x0 is not None:
        out = dataclasses.replace(out, x0=new_x0)
    return out


def stage_dynamics(problem: TrajOptProblem, t: int):
    """The dynamics of stage ``t`` (its row of a stacked model or of a
    schedule), to apply to one stage's ``(B, nx)`` state."""
    if problem.stages.nstack:
        return problem.stages.at(t).dynamics
    return dynamics_at(problem.stages.dynamics, t, problem.nsteps)


def cycle_warm_start(xs, us, vs=None, lams=None, space=None, problem=None):
    """A previous solution ``xs (B, N+1, nx)``, ``us (B, N, nu)`` (and
    ``vs``, ``lams``) rotated one step left to warm-start the next MPC
    solve; the last entries duplicate the previous last ones.

    With ``problem``, the shifted tail is repaired instead of duplicated:
    the new terminal state is rolled out through the last stage's dynamics
    (its schedule row, :func:`stage_dynamics`) and the terminal
    costate refreshed to the terminal-cost gradient there, as the JAX
    package does (a stale tail costs several Newton iterations at the small
    penalties of MPC)."""
    xs_w = roll_left(xs, xs[:, -1])
    us_w = roll_left(us, us[:, -1])
    x_tail = None
    if problem is not None:
        sp = problem.space if space is None else space
        x_tail = stage_dynamics(problem, problem.nsteps - 1).forward(sp, xs_w[:, -2],
                                                                    us_w[:, -1])
        xs_w[:, -1] = x_tail
    out = [xs_w, us_w]
    if vs is not None:
        out.append(roll_left(vs, vs[:, -1]))
    if lams is not None:
        lams_w = roll_left(lams, lams[:, -1])
        if x_tail is not None:
            sp = problem.space if space is None else space
            u0 = us_w.new_zeros(us_w[:, -1].shape)
            tLx, _ = problem.term_cost.gradients(sp, x_tail, u0)
            lams_w[:, -1] = tLx
        out.append(lams_w)
    return tuple(out)
