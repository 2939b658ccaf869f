"""ProxDDP: proximal augmented-Lagrangian trajectory optimization, batched.

PyTorch counterpart of ``aligator_tpu/solvers/proxddp.py``. The JAX solver
is written for one scenario and ``vmap``ped; this one carries an explicit
batch axis ``B`` through every tensor and keeps each scenario's semantics
with boolean masks:

* the outer loop runs while any scenario is still iterating; a scenario
  whose loop condition is false is frozen (its state is selected back);
* the Newton step is computed for the batch when any running scenario is
  neither converged nor failed, and kept only for those;
* the line searches and the BCL tolerance-tightening loop advance only the
  scenarios whose own loop condition still holds.

``iter``, ``al_iter``, μ, the tolerances, the regularization and the filter
pool are therefore per scenario and equal what the JAX solver computes for
that scenario alone. Each masked loop ends on ``mask.any()``, one host sync
per iteration.

What this port covers: the linear and the nonlinear rollout (a closed-loop
rollout through the dynamics, stage by stage over the whole batch, with
``forward_with_gap`` Newton steps for implicit dynamics); the four LQ
solvers of ``linear_solver``: ``'serial'``
(:func:`~aligator_tpu_torch.gar.riccati.solve_and_gains`, which routes by
shape: small-dim problems to the fused solve K1, explicit dynamics with
12 <= nx <= 44 to the fused backward sweep K3, the rest to the per-stage
loop with the SPD solve K2, and forward sweeps at nx >= 12 to K4),
``'serial_scan'`` (the routed ``backward``/``forward``, never K1),
``'parallel'`` (leg condensation, :mod:`~aligator_tpu_torch.gar.parallel`)
and ``'associative'`` (:mod:`~aligator_tpu_torch.gar.associative`, which
falls back per scenario to ``'serial_scan'``'s solve below its μ floor); the
three multiplier update modes, the three step-acceptance strategies, the
BCL schedule and the regularization schedule; Gauss-Newton or ``'exact'``
Hessians (:func:`~aligator_tpu_torch.core.problem.dynamics_vhp`); a general
``init_constraint``; history, verbose rows and callbacks. The JAX
configuration's ``lq_spd_lanes``, ``lq_stage_fused`` and ``lq_scan_unroll``
knobs have no counterpart, since the routing follows the shape alone.

Where the port differs in form from the JAX package: the history fields of
:class:`ProxDDPResults` are batch first (``history (B, max_iters, 8)``,
``history_xs (B, max_iters, N+1, nx)``, ...); ``verbose`` prints one row per
running scenario and iteration (the JAX package prints one per ``vmap``
element through ``jax.debug.callback``), each led by the scenario's index;
``callback`` is called once per iteration with the trace dict of the whole
batch, each value a ``(B,)`` tensor, and ``"running"`` the mask of the
scenarios that took this iteration.
"""

from __future__ import annotations

import collections
import dataclasses
import warnings
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Optional

import torch
from torch import Tensor

from .. import _build
from .._linalg import infnorm, mtv, mv
from .._linalg import select as _where
from ..core import problem as problem_mod
from ..core.dynamics import dynamics_at
from ..core.manifolds import VectorSpace
from ..core.problem import ProblemData, TrajOptProblem
from ..gar import associative as gar_associative
from ..gar import lqr_problem as lqr_mod
from ..gar import parallel as gar_parallel
from ..gar import riccati
from ..utils import logger as logger_mod

LINEAR_SOLVERS = ("serial", "serial_scan", "parallel", "associative")
# Newton steps taken on each LQ route, per scenario: each scenario whose
# Newton step is kept adds one to the route that solved its LQ subproblem
# ("associative_fallback": the serial solve an 'associative' scenario takes
# below the μ floor). The counts accumulate on the solve's device, without
# a host sync; read them with int()
ROUTE_STEPS = dict.fromkeys(LINEAR_SOLVERS + ("associative_fallback",), 0)
# line-search trials made, for launch accounting: nonlinear (each a
# rollout) and linear (each an evaluation of the problem)
NONLINEAR_TRIALS = 0
LINEAR_TRIALS = 0


def _count_steps(route: str, mask: Tensor) -> None:
    # out of place: a count held on one device takes a 0-dim sum from another
    ROUTE_STEPS[route] = mask.sum() + ROUTE_STEPS[route]


@dataclass(frozen=True)
class ProxDDPConfig:
    """Solver hyper-parameters; defaults follow the reference."""

    tol: float = 1e-6
    dual_tol: Optional[float] = None  # defaults to tol
    mu_init: float = 0.01
    max_iters: int = 100
    max_al_iters: int = 100
    # BCL parameters
    prim_alpha: float = 0.1
    prim_beta: float = 0.9
    dual_alpha: float = 1.0
    dual_beta: float = 1.0
    mu_update_factor: float = 0.01
    dyn_al_scale: float = 1e-3
    mu_lower_bound: float = 1e-8
    # regularization schedule
    reg_min: float = 1e-10
    reg_max: float = 1e9
    reg_init: float = 1e-9
    reg_inc_k: float = 10.0
    reg_inc_first_k: float = 100.0
    reg_dec_k: float = 1.0 / 3.0
    # line search
    ls_armijo_c1: float = 1e-4
    ls_alpha_min: float = 1e-6
    ls_max_steps: int = 20
    ls_contraction: float = 0.5
    # step-size interpolation for 'armijo'/'nonmonotone':
    # 'bisection' | 'quadratic' | 'cubic'; the interpolated minimizer is
    # clamped to [ls_contraction_min*α, ls_contraction_max*α]
    ls_interp: str = "cubic"
    ls_contraction_min: float = 0.5
    ls_contraction_max: float = 0.8
    # step acceptance: 'nonmonotone' (Zhang-Hager moving average),
    # 'armijo' (monotone backtracking) or 'filter' (merit/infeasibility
    # dominance filter)
    ls_strategy: str = "nonmonotone"
    ls_avg_eta: float = 0.85
    filter_beta: float = 0.0
    filter_size: int = 40
    # multiplier update on BCL success: 'newton' | 'primal' | 'primal_dual'
    multiplier_update_mode: str = "newton"
    # 'gauss_newton', or 'exact': adds the costate-contracted Hessians of
    # the dynamics residuals to the LQ knots
    hessian_approx: str = "gauss_newton"
    dphi_thresh: float = 1e-13
    # 'linear' or 'nonlinear' (closed-loop rollout through the dynamics)
    rollout: str = "linear"
    # Newton steps of an implicit dynamics inside the nonlinear rollout
    rollout_max_iters: int = 1
    # LQ subproblem solver: 'serial' (routed by shape, K1 where it applies),
    # 'serial_scan' (the routed backward/forward, never K1), 'parallel' (leg
    # condensation over parallel_legs legs; linear rollout only) or
    # 'associative' (O(log N)-depth scans; explicit dynamics only)
    linear_solver: str = "serial"
    parallel_legs: int = 2
    # 'associative': a scenario whose min(mu_dyn, mu) is below this floor
    # takes the serial solve for that Newton step (the scan's element
    # algebra stops contracting below it). None: 1e-3 in float32, 1e-7 in
    # float64, the domains measured in the JAX package
    associative_mu_floor: Optional[float] = None
    force_initial_condition: bool = True
    # per-iteration traces [prim, dual, inner_crit, cost, merit, mu,
    # al_iter, alpha]; with record_history_trajs also the iterates
    record_history: bool = False
    record_history_trajs: bool = False
    # one logger row per running scenario and iteration
    verbose: bool = False
    # called once per iteration with the batch's trace dict (module docstring)
    callback: Optional[Callable[[dict], None]] = None
    # initial BCL tolerances
    inner_tol0: float = 1.0
    prim_tol0: float = 1.0

    @property
    def target_dual_tol(self) -> float:
        return self.tol if self.dual_tol is None else self.dual_tol


@dataclass
class ProxDDPResults:
    """Solver results, batch first."""

    xs: Tensor  # (B, N+1, nx)
    us: Tensor  # (B, N, nu)
    vs: Tensor  # (B, N, nc)
    vs_term: Tensor  # (B, nc_term)
    lams: Tensor  # (B, N+1, ndx)
    conv: Tensor  # (B,) bool
    num_iters: Tensor  # (B,) int
    al_iter: Tensor  # (B,) int
    newton_steps: Tensor  # (B,) int: Newton steps (LQ solves) taken
    prim_infeas: Tensor  # (B,)
    dual_infeas: Tensor  # (B,)
    traj_cost: Tensor  # (B,)
    merit_value: Tensor  # (B,)
    K: Tensor  # (B, N, nu, ndx) feedback gains of the last LQ solve
    kff: Tensor  # (B, N, nu)
    mu_final: Tensor  # (B,)
    # per-iteration traces (record_history):
    # [prim, dual, inner_crit, cost, merit, mu, al_iter, alpha]
    history: Optional[Tensor] = None  # (B, max_iters, 8)
    # the iterates at the start of each iteration (record_history_trajs)
    history_xs: Optional[Tensor] = None  # (B, max_iters, N+1, nx)
    history_us: Optional[Tensor] = None  # (B, max_iters, N, nu)
    history_vs: Optional[Tensor] = None  # (B, max_iters, N, nc)
    history_lams: Optional[Tensor] = None  # (B, max_iters, N+1, ndx)
    # dV/dθ and d²V/dθ² of a parametric family (solvers.sensitivity)
    th_grad: Optional[Tensor] = None  # (B, nth)
    th_hess: Optional[Tensor] = None  # (B, nth, nth)


@dataclass
class _State:
    xs: Tensor
    us: Tensor
    vs: Tensor
    vs_term: Tensor
    lams: Tensor
    prev_vs: Tensor
    prev_vs_term: Tensor
    prev_lams: Tensor
    mu: Tensor
    preg: Tensor
    preg_last: Tensor
    inner_tol: Tensor
    prim_tol: Tensor
    iter: Tensor
    al_iter: Tensor
    newton_steps: Tensor
    merit: Tensor
    cost: Tensor
    prim_infeas: Tensor
    dual_infeas: Tensor
    inner_crit: Tensor
    conv: Tensor
    fail: Tensor
    ls_mov_avg: Tensor
    ls_avg_weight: Tensor
    filter_vals: Tensor  # (B, F, 2) (merit, infeas) pairs
    filter_valid: Tensor  # (B, F)
    K: Tensor
    kff: Tensor
    alpha_last: Tensor  # accepted step length of the last Newton step
    dphi_last: Tensor  # merit directional derivative of the last step


def _check_supported(cfg: ProxDDPConfig):
    if cfg.linear_solver not in LINEAR_SOLVERS:
        raise ValueError(f"unknown linear_solver {cfg.linear_solver!r}")
    if cfg.rollout not in ("linear", "nonlinear"):
        raise ValueError(f"unknown rollout {cfg.rollout!r}")
    if cfg.linear_solver == "parallel" and cfg.rollout != "linear":
        # as the reference requires (solver-proxddp.hxx:169-181)
        raise ValueError("parallel linear solver requires rollout='linear'")
    if cfg.hessian_approx not in ("gauss_newton", "exact"):
        raise ValueError(f"unknown hessian_approx {cfg.hessian_approx!r}")
    if cfg.ls_strategy not in ("filter", "armijo", "nonmonotone"):
        raise ValueError(f"unknown ls_strategy {cfg.ls_strategy!r}")
    if cfg.ls_interp not in ("bisection", "quadratic", "cubic"):
        raise ValueError(f"unknown ls_interp {cfg.ls_interp!r}")
    if cfg.multiplier_update_mode not in ("newton", "primal", "primal_dual"):
        raise ValueError(
            f"unknown multiplier_update_mode {cfg.multiplier_update_mode!r}"
        )


# ---------------------------------------------------------------------------
# Multiplier estimates, merit, Lagrangian gradients
# ---------------------------------------------------------------------------


def _compute_multipliers(problem, cfg, data: ProblemData, st: _State, lams,
                         vs, vs_term) -> dict:
    """First-order multiplier estimates and AL residuals."""
    mu = st.mu
    mudyn = (cfg.dyn_al_scale * mu)[:, None, None]
    mu3, mu2 = mu[:, None, None], mu[:, None]

    # dynamics / initial constraint ("equality" sets)
    dyn_vals = torch.cat([data.init_res[:, None], data.dyn_res], 1)
    lams_plus = st.prev_lams + dyn_vals / mudyn
    lams_pdal = 2.0 * lams_plus - lams
    Lds = mudyn * (lams_plus - lams)

    cset = problem.stages.constraint_set().set_prox_parameter(mu3)
    shifted = data.cstr_vals + mu3 * st.prev_vs
    vs_plus_raw = cset.normal_cone_projection(shifted)
    active = cset.active_mask(shifted)
    Lvs = vs_plus_raw - mu3 * vs
    vs_plus = vs_plus_raw / mu3
    vs_pdal = 2.0 * vs_plus - vs

    tset = problem.term_constraint_set().set_prox_parameter(mu2)
    shifted_t = data.term_cstr_vals + mu2 * st.prev_vs_term
    vs_plus_t_raw = tset.normal_cone_projection(shifted_t)
    active_t = tset.active_mask(shifted_t)
    Lvs_t = vs_plus_t_raw - mu2 * vs_term
    vs_plus_t = vs_plus_t_raw / mu2
    vs_pdal_t = 2.0 * vs_plus_t - vs_term

    if cfg.force_initial_condition:
        Lds = torch.cat([torch.zeros_like(Lds[:, :1]), Lds[:, 1:]], 1)

    return dict(
        lams_plus=lams_plus, lams_pdal=lams_pdal, Lds=Lds, dyn_slacks=dyn_vals,
        active=active, vs_plus=vs_plus, vs_pdal=vs_pdal, Lvs=Lvs,
        active_t=active_t, vs_plus_t=vs_plus_t, vs_pdal_t=vs_pdal_t,
        Lvs_t=Lvs_t,
    )


def _sumsq(a: Tensor) -> Tensor:
    return (a * a).flatten(1).sum(1)


def _merit_value(cfg, mu, cost, m) -> Tensor:
    """PDAL merit."""
    mudyn = cfg.dyn_al_scale * mu
    pen = 0.5 * mudyn * _sumsq(m["lams_plus"])
    pen = pen + 0.5 * mu * _sumsq(m["vs_plus"])
    pen = pen + 0.5 * mu * _sumsq(m["vs_plus_t"])
    return cost + pen


def _lagrangian_grads(problem, cfg, data: ProblemData, lams, vs, vs_term):
    """∇x, ∇u of the problem Lagrangian."""
    N = problem.nsteps
    Lxs = torch.zeros_like(data.Lx)
    Lxs[:, 0] += mtv(data.init_Jx, lams[:, 0])
    Lxs[:, :N] += (
        data.Lx[:, :N] + mtv(data.A, lams[:, 1:]) + mtv(data.cstr_Jx, vs)
    )
    Lxs[:, 1:] += mtv(data.E, lams[:, 1:])
    Lxs[:, N] += data.Lx[:, N] + mtv(data.term_cstr_Jx, vs_term)
    Lus = data.Lu + mtv(data.B, lams[:, 1:]) + mtv(data.cstr_Ju, vs)
    if cfg.force_initial_condition:
        Lxs[:, 0] = 0.0
    return Lxs, Lus


def _stage_infeas(st: _State, m) -> Tensor:
    mu = st.mu
    return torch.maximum(
        infnorm(mu[:, None, None] * (m["vs_plus"] - st.prev_vs)),
        infnorm(mu[:, None] * (m["vs_plus_t"] - st.prev_vs_term)),
    )


def _criteria(st: _State, m, Lxs, Lus):
    """Primal and dual infeasibilities and the inner criterion."""
    prim = torch.maximum(_stage_infeas(st, m), infnorm(m["dyn_slacks"]))
    dual = torch.maximum(infnorm(Lxs), infnorm(Lus))
    crit = torch.stack([
        infnorm(Lxs), infnorm(Lus), infnorm(m["Lds"]), infnorm(m["Lvs"]),
        infnorm(m["Lvs_t"]),
    ]).amax(0)
    return prim, dual, crit


# ---------------------------------------------------------------------------
# LQ subproblem assembly
# ---------------------------------------------------------------------------


def _assemble_lq(problem, cfg, data: ProblemData, m, Lxs, Lus, preg,
                 mu, vhp=None) -> lqr_mod.LQRProblem:
    """Fill the proximal LQ subproblems from stage data, with active-set
    projected constraint Jacobians; ``vhp``, the dynamics' Hessian terms of
    'exact' mode (:func:`~..core.problem.dynamics_vhp`), adds to the
    knots."""
    N = problem.nsteps
    ndx, nu = problem.space.ndx, problem.nu
    nc, nct = problem.nc, problem.nc_term
    ncmax = max(nc, nct)
    Bsz, T = Lxs.shape[0], N + 1
    eye_x = torch.eye(ndx, dtype=Lxs.dtype, device=Lxs.device)
    eye_u = torch.eye(nu, dtype=Lxs.dtype, device=Lxs.device)
    mu3, mu2 = mu[:, None, None], mu[:, None]
    preg4 = preg[:, None, None, None]

    Cp = torch.where(m["active"][..., None], data.cstr_Jx, 0.0)
    Dp = torch.where(m["active"][..., None], data.cstr_Ju, 0.0)
    Cp_t = torch.where(m["active_t"][..., None], data.term_cstr_Jx, 0.0)

    Lv_s = m["Lvs"] / mu3
    corr_x = mtv(data.cstr_Jx - Cp, Lv_s)
    corr_u = mtv(data.cstr_Ju - Dp, Lv_s)
    corr_xt = mtv(data.term_cstr_Jx - Cp_t, m["Lvs_t"] / mu2)

    Q = data.Lxx + preg4 * eye_x
    q = Lxs + torch.cat([corr_x, corr_xt[:, None]], 1)
    Lxu, Luu = data.Lxu, data.Luu
    if vhp is not None:
        Hxx, Hxu, Huu = vhp
        Q = torch.cat([Q[:, :N] + Hxx, Q[:, N:]], 1)
        Lxu = Lxu + Hxu
        Luu = Luu + Huu
    S = torch.cat([Lxu, Lxu.new_zeros((Bsz, 1, ndx, nu))], 1)
    R = torch.cat(
        [Luu + preg4 * eye_u, eye_u.expand(Bsz, 1, nu, nu)], 1
    )
    r = torch.cat([Lus + corr_u, Lus.new_zeros((Bsz, 1, nu))], 1)
    zx = data.A.new_zeros((Bsz, 1, ndx, ndx))
    A = torch.cat([data.A, zx], 1)
    B = torch.cat([data.B, data.B.new_zeros((Bsz, 1, ndx, nu))], 1)
    E = torch.cat([data.E, zx], 1)
    f = torch.cat([m["Lds"][:, 1:], Lxs.new_zeros((Bsz, 1, ndx))], 1)

    C = Lxs.new_zeros((Bsz, T, ncmax, ndx))
    D = Lxs.new_zeros((Bsz, T, ncmax, nu))
    d = Lxs.new_zeros((Bsz, T, ncmax))
    if nc > 0:
        C[:, :N, :nc] = Cp
        D[:, :N, :nc] = Dp
        d[:, :N, :nc] = m["Lvs"]
    if nct > 0:
        C[:, N, :nct] = Cp_t
        d[:, N, :nct] = m["Lvs_t"]

    knots = lqr_mod.LQRKnots(Q=Q, S=S, R=R, q=q, r=r, A=A, B=B, E=E, f=f,
                             C=C, D=D, d=d)
    g0 = m["Lds"][:, 0]
    if cfg.force_initial_condition:
        g0 = torch.zeros_like(g0)
    return lqr_mod.LQRProblem(knots=knots, G0=data.init_Jx, g0=g0)


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _nonlinear_rollout(problem, cfg, st: _State, gains: dict, dx0: Tensor,
                       dlam0: Tensor, alpha: Tensor):
    """Trial point of a closed-loop rollout of step length ``alpha (B,)``
    from the Newton step's ``dx0``, ``dlam0`` at the first stage: stage by
    stage over the whole batch, the LQ gains applied to the state
    deviation, the dynamics advanced (``forward`` then ``integrate`` by the
    slack; ``forward_with_gap`` for implicit dynamics). Returns the trial
    point and the slacks ``(B, N, ndx)``, whose negative is the dynamics
    gap of the trial point."""
    space, stage, N = problem.space, problem.stages, problem.nsteps
    nc, nct = problem.nc, problem.nc_term
    mudyn = (cfg.dyn_al_scale * st.mu)[:, None]
    a1 = alpha[:, None]
    dx = a1 * dx0
    x = space.integrate(st.xs[:, 0], dx)
    xs, us, vs, lams, slacks = [x], [], [], [st.lams[:, 0] + a1 * dlam0], []
    for t in range(N):
        g = {k: v[:, t] for k, v in gains.items()}
        u = st.us[:, t] + a1 * g["kff"] + mv(g["K"], dx)
        v = st.vs[:, t] + a1 * g["zff"][:, :nc] + mv(g["Z"][:, :nc], dx)
        lam = st.lams[:, t + 1] + a1 * g["lff"] + mv(g["L"], dx)
        slack = mudyn * (st.prev_lams[:, t + 1] - lam)
        dyn = stage.at(t).dynamics if stage.nstack else dynamics_at(stage.dynamics, t, N)
        if dyn.is_explicit:
            x = space.integrate(dyn.forward(space, x, u), slack)
        else:
            x = dyn.forward_with_gap(space, x, u, slack, iters=cfg.rollout_max_iters)
        dx = space.difference(st.xs[:, t + 1], x)
        for out, val in ((xs, x), (us, u), (vs, v), (lams, lam), (slacks, slack)):
            out.append(val)
    vt = (st.vs_term + a1 * gains["zff"][:, N, :nct]
          + mv(gains["Z"][:, N, :nct], dx))
    return (torch.stack(xs, 1), torch.stack(us, 1), torch.stack(vs, 1), vt,
            torch.stack(lams, 1)), torch.stack(slacks, 1)


def _trial_values(problem, cfg, st, data: ProblemData, trial):
    """``(trial, cost, merit, primal infeasibility)`` of a trial point."""
    _, _, tvs, tvt, tlams = trial
    m = _compute_multipliers(problem, cfg, data, st, tlams, tvs, tvt)
    phi = _merit_value(cfg, st.mu, data.cost, m)
    prim = torch.maximum(_stage_infeas(st, m), infnorm(m["dyn_slacks"]))
    return trial, data.cost, phi, prim


def _nonlinear_trial(problem, cfg, st, gains: dict, dx0, dlam0, alpha):
    trial, slacks = _nonlinear_rollout(problem, cfg, st, gains, dx0, dlam0, alpha)
    # by construction the rollout's dynamics gap is -slack
    data = dataclasses.replace(problem_mod.evaluate(problem, trial[0], trial[1],
                                                    dynamics=False), dyn_res=-slacks)
    return _trial_values(problem, cfg, st, data, trial)


def _linear_trial(problem, cfg, st, steps, alpha):
    dxs, dus, dvs, dvs_t, dlams = steps
    a3 = alpha[:, None, None]
    trial = (problem.space.integrate(st.xs, a3 * dxs), st.us + a3 * dus,
             st.vs + a3 * dvs, st.vs_term + alpha[:, None] * dvs_t,
             st.lams + a3 * dlams)
    return _trial_values(problem, cfg, st, problem_mod.evaluate(problem, *trial[:2]),
                         trial)


# what a trial reads: the state's fields, and the LQ gains (nonlinear) or the
# Newton step (linear)
_TRIAL_STATE = ("xs", "us", "vs", "vs_term", "lams", "prev_lams", "prev_vs",
                "prev_vs_term", "mu")
_TRIAL_GAINS = ("kff", "K", "zff", "Z", "lff", "L")
_TRIAL_STEP = ("dxs", "dus", "dvs", "dvs_t", "dlams")


def _trial_inputs(cfg, st, gains: dict, steps, alpha: Tensor) -> dict:
    ins = {k: getattr(st, k) for k in _TRIAL_STATE}
    if cfg.rollout == "nonlinear":
        ins.update({f"gain_{k}": gains[k] for k in _TRIAL_GAINS},
                   dx0=steps[0][:, 0], dlam0=steps[4][:, 0])
    else:
        ins.update(zip(_TRIAL_STEP, steps))
    ins["alpha"] = alpha
    return ins


def _trial(problem, cfg, ins: dict):
    """The trial point of :func:`_trial_inputs`' tensors, its cost, merit and
    primal infeasibility."""
    st = SimpleNamespace(**{k: ins[k] for k in _TRIAL_STATE})
    if cfg.rollout == "nonlinear":
        gains = {k: ins[f"gain_{k}"] for k in _TRIAL_GAINS}
        return _nonlinear_trial(problem, cfg, st, gains, ins["dx0"], ins["dlam0"],
                                ins["alpha"])
    return _linear_trial(problem, cfg, st, tuple(ins[k] for k in _TRIAL_STEP),
                         ins["alpha"])


class TrialGraphWarning(RuntimeWarning):
    """A line-search trial could not be captured as a CUDA graph and runs
    eagerly (several times slower)."""


class _TrialGraph:
    """The line-search trial (the nonlinear rollout or the linear step, the
    problem's evaluation, multipliers, merit) on CUDA tensors, captured as
    one CUDA graph at its first trial and replayed for every later trial
    (of the problem's later solves too, :func:`_trial_graph`), its inputs
    copied into the graph's static tensors. A trial is
    hundreds of small PyTorch operations (the nonlinear rollout some N·150,
    several times more with an implicit rule's Newton steps), each a host
    launch; the replay launches them as one. A trial that cannot be captured
    (an operation that waits on the host) runs eagerly, with a
    :class:`TrialGraphWarning`. The kernel launches that the capture records
    (``_build.LAUNCHES``) are taken back, since recording is not launching,
    and added again at every replay; those of the warm-up before the capture
    stay counted."""

    def __init__(self):
        self.graph = None
        self.eager = False
        self.replay_launches = collections.Counter()

    def __call__(self, problem, cfg, ins: dict):
        if self.eager:
            return _trial(problem, cfg, ins)
        if self.graph is None:
            self.static = {k: v.clone() for k, v in ins.items()}
            try:
                self._capture(problem, cfg)
            except RuntimeError as err:
                warnings.warn(f"the line-search trial runs eagerly: its capture "
                              f"as a CUDA graph failed ({err})", TrialGraphWarning)
                self.eager = True
                return _trial(problem, cfg, ins)
        for k, v in ins.items():
            self.static[k].copy_(v)
        self.graph.replay()
        _build.LAUNCHES.update(self.replay_launches)
        trial, *values = self.out
        return tuple(t.clone() for t in trial), *(v.clone() for v in values)

    def _capture(self, problem, cfg):
        # a warm-up on a side stream first, as torch.cuda.graph asks: the
        # lazy initializations (cuBLAS handles) stay out of the capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _trial(problem, cfg, self.static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _build.LAUNCHES.copy()
        with torch.cuda.graph(graph):
            self.out = _trial(problem, cfg, self.static)
        self.replay_launches = _build.LAUNCHES - before
        _build.LAUNCHES.subtract(self.replay_launches)
        self.graph = graph


def _trial_graph(problem, cfg) -> _TrialGraph:
    """The trial graph of ``problem`` under ``cfg``, kept on the problem
    object: later solves of the same problem replay the first one's capture
    (a capture and its warm-up cost about as much as a short solve)."""
    graphs = problem.__dict__.setdefault("_trial_graphs", {})
    try:
        return graphs.setdefault(cfg, _TrialGraph())
    except TypeError:  # a configuration that does not hash (a callback)
        return _TrialGraph()


def _forward_pass(problem, cfg, st: _State, gains: dict, steps, alpha: Tensor,
                  graph: Optional[_TrialGraph] = None):
    """Trial point of a step of length ``alpha (B,)`` (a linear step, or the
    nonlinear rollout along ``gains``; through ``graph`` where given), its
    cost, merit and primal infeasibility."""
    global NONLINEAR_TRIALS, LINEAR_TRIALS
    if cfg.rollout == "nonlinear":
        NONLINEAR_TRIALS += 1
    else:
        LINEAR_TRIALS += 1
    ins = _trial_inputs(cfg, st, gains, steps, alpha)
    if graph is not None:
        return graph(problem, cfg, ins)
    return _trial(problem, cfg, ins)


# ---------------------------------------------------------------------------
# BCL update, Newton step, main loop
# ---------------------------------------------------------------------------


def _bcl_update(cfg, st: _State, m, inner_done: Tensor) -> _State:
    """BCL outer update, applied to the scenarios with ``inner_done``."""
    prim_ok = st.prim_infeas <= st.prim_tol
    arg = torch.clamp(st.mu, max=0.99)

    def tighten(pt, it):
        return pt * arg ** cfg.prim_beta, it * arg ** cfg.dual_beta

    # success branch: tighten until inner_tol <= inner_crit; only the
    # scenarios whose result is used take part in the loop
    pt_s, it_s = tighten(st.prim_tol, st.inner_tol)
    used = inner_done & prim_ok
    while True:
        again = used & (st.inner_crit < it_s)
        if not bool(again.any()):
            break
        pt_s, it_s = _where(again, tighten(pt_s, it_s), (pt_s, it_s))

    if cfg.multiplier_update_mode == "newton":
        prev_s = (st.vs, st.vs_term, st.lams)
    elif cfg.multiplier_update_mode == "primal":
        prev_s = (m["vs_plus"], m["vs_plus_t"], m["lams_plus"])
    else:  # primal_dual
        prev_s = (m["vs_pdal"], m["vs_pdal_t"], m["lams_pdal"])

    # failure branch: increase the penalty, loosen the tolerances; reset to
    # mu_init when the floor is hit
    mu_reset = max(cfg.mu_init, cfg.mu_lower_bound)
    mu_f = torch.clamp(st.mu * cfg.mu_update_factor, min=cfg.mu_lower_bound)
    mu_f = torch.where(
        mu_f <= cfg.mu_lower_bound * (1.0 + 1e-12), torch.full_like(mu_f, mu_reset),
        mu_f,
    )
    arg_f = torch.clamp(mu_f, max=0.99)
    pt_f = cfg.prim_tol0 * arg_f ** cfg.prim_alpha
    it_f = cfg.inner_tol0 * arg_f ** cfg.dual_alpha

    new_mu = torch.where(prim_ok, st.mu, mu_f)
    new_pt = torch.clamp(torch.where(prim_ok, pt_s, pt_f), min=cfg.tol)
    new_it = torch.clamp(
        torch.where(prim_ok, it_s, it_f), min=0.01 * cfg.target_dual_tol
    )
    new_prev = _where(prim_ok, prev_s, (st.prev_vs, st.prev_vs_term, st.prev_lams))
    conv = prim_ok & (st.dual_infeas <= cfg.target_dual_tol) & (
        st.prim_infeas <= cfg.tol
    )
    applied = dataclasses.replace(
        st, mu=new_mu, prim_tol=new_pt, inner_tol=new_it,
        prev_vs=new_prev[0], prev_vs_term=new_prev[1], prev_lams=new_prev[2],
        al_iter=st.al_iter + 1, conv=st.conv | conv,
        ls_mov_avg=torch.zeros_like(st.ls_mov_avg),
        ls_avg_weight=torch.zeros_like(st.ls_avg_weight),
    )
    return _where(inner_done, applied, st)


def _filter_search(cfg, st: _State, try_alpha, first, step_mask):
    """Merit/infeasibility dominance filter: backtrack until no filter entry
    dominates the trial pair, then update the filter pool."""
    fv, fvalid = st.filter_vals, st.filter_valid

    def accepted(phi, prim):
        dominated = (
            (fv[..., 0] + cfg.filter_beta * fv[..., 1] <= phi[:, None])
            & (fv[..., 1] + cfg.filter_beta * fv[..., 1] <= prim[:, None])
        )
        bad = (dominated & fvalid).any(1)
        return torch.isfinite(phi) & ~bad

    trial, cost, phi, prim = first
    k = torch.zeros_like(st.iter)
    alpha = torch.ones_like(st.mu)
    while True:
        go = (~accepted(phi, prim) & (k < cfg.ls_max_steps)
              & (alpha > cfg.ls_alpha_min) & step_mask)
        if not bool(go.any()):
            break
        alpha2 = torch.clamp(alpha * cfg.ls_contraction, min=cfg.ls_alpha_min)
        trial2, cost2, phi2, prim2 = try_alpha(alpha2)
        k, alpha, trial, cost, phi, prim = _where(
            go, (k + 1, alpha2, trial2, cost2, phi2, prim2),
            (k, alpha, trial, cost, phi, prim),
        )

    # drop the entries the new pair dominates, insert it in the first free
    # slot; when the pool is full, evict the entry of largest merit
    dominated_by_new = (phi[:, None] <= fv[..., 0]) & (prim[:, None] <= fv[..., 1])
    valid = fvalid & ~dominated_by_new
    free_slot = torch.argmin(valid.to(torch.int8), 1)
    evict_slot = torch.argmax(
        torch.where(valid, fv[..., 0], torch.full_like(fv[..., 0], -torch.inf)), 1
    )
    slot = torch.where(valid.all(1), evict_slot, free_slot)
    rows = torch.arange(fv.shape[0], device=fv.device)
    new_fv = fv.clone()
    new_fv[rows, slot] = torch.stack([phi, prim], -1)
    new_valid = valid.clone()
    new_valid[rows, slot] = True
    st = dataclasses.replace(st, filter_vals=new_fv, filter_valid=new_valid)
    return st, alpha, trial, cost, phi


def _backtracking_search(cfg, st: _State, try_alpha, first, step_mask, phi0,
                         dphi0, phi_ref):
    """Armijo backtracking against ``phi_ref`` with safeguarded polynomial
    step proposals."""
    big = torch.finfo(phi0.dtype).max / 8

    def safe(p):
        # a non-finite merit sample would poison the interpolant
        return torch.where(torch.isfinite(p), p, torch.full_like(p, big))

    def interp(k, alpha, phi_a, alpha_p, phi_p):
        if cfg.ls_interp == "bisection":
            return alpha * cfg.ls_contraction
        qa = (safe(phi_a) - phi0 - alpha * dphi0) / (alpha * alpha)
        cand = -dphi0 / (2.0 * qa)
        if cfg.ls_interp == "cubic":
            a0, a1 = alpha, alpha_p
            r0 = safe(phi_a) - phi0 - dphi0 * a0
            r1 = safe(phi_p) - phi0 - dphi0 * a1
            det = a0 * a0 * a1 * a1 * (a0 - a1)
            c3 = (r0 * a1 * a1 - a0 * a0 * r1) / det
            c2 = (a0 * a0 * a0 * r1 - a1 * a1 * a1 * r0) / det
            disc = c2 * c2 - 3.0 * c3 * dphi0
            cand_cubic = (-c2 + torch.sqrt(torch.clamp(disc, min=0.0))) / (3.0 * c3)
            use_cubic = (k >= 1) & torch.isfinite(cand_cubic) & (c3.abs() > 1e-30)
            cand = torch.where(use_cubic, cand_cubic, cand)
        lo = cfg.ls_contraction_min * alpha
        cand = torch.where(torch.isfinite(cand), cand, lo)
        return torch.minimum(torch.maximum(cand, lo), cfg.ls_contraction_max * alpha)

    trial, cost, phi, prim = first
    k = torch.zeros_like(st.iter)
    alpha = torch.ones_like(st.mu)
    a_prev, phi_prev = alpha, phi
    while True:
        ok = phi <= phi_ref + cfg.ls_armijo_c1 * alpha * dphi0
        go = (~ok & (k < cfg.ls_max_steps) & (alpha > cfg.ls_alpha_min)
              & step_mask)
        if not bool(go.any()):
            break
        alpha2 = torch.clamp(
            interp(k, alpha, phi, a_prev, phi_prev), min=cfg.ls_alpha_min
        )
        trial2, cost2, phi2, prim2 = try_alpha(alpha2)
        k, alpha, trial, cost, phi, prim, a_prev, phi_prev = _where(
            go, (k + 1, alpha2, trial2, cost2, phi2, prim2, alpha, phi),
            (k, alpha, trial, cost, phi, prim, a_prev, phi_prev),
        )
    return st, alpha, trial, cost, phi


GAINS = riccati.GAIN_FIELDS


def _serial_scan(lq, mudyn, mu, assume_explicit):
    f = riccati.backward(lq, mudyn, mu, assume_explicit)
    return (*riccati.forward(f), *(getattr(f, k) for k in GAINS))


def _associative(cfg, lq, mudyn, mu, assume_explicit, step_mask):
    """The 'associative' route with its μ floor decided per scenario: a
    scenario with ``min(mudyn, mu) < floor`` takes the serial solve (the
    JAX package's ``lax.cond`` under ``vmap``); each route solves only its
    own scenarios."""
    floor = cfg.associative_mu_floor
    if floor is None:
        floor = 1e-3 if mu.dtype == torch.float32 else 1e-7
    ok = torch.minimum(mudyn, mu) >= floor
    _count_steps("associative", ok & step_mask)
    _count_steps("associative_fallback", ~ok & step_mask)

    def assoc(p, md, m):
        *sol, f = gar_associative.solve(p, md, m, return_gains=True,
                                        refine_steps=1)
        return (*sol, *(getattr(f, k) for k in GAINS))

    if bool(ok.all()):
        return assoc(lq, mudyn, mu)
    if not bool(ok.any()):
        return _serial_scan(lq, mudyn, mu, assume_explicit)
    i_ok, i_no = ok.nonzero()[:, 0], (~ok).nonzero()[:, 0]
    got = assoc(lq.map(lambda t: t[i_ok]), mudyn[i_ok], mu[i_ok])
    fell = _serial_scan(lq.map(lambda t: t[i_no]), mudyn[i_no], mu[i_no],
                        assume_explicit)
    out = []
    for a, b in zip(got, fell):
        t = a.new_empty((ok.shape[0],) + a.shape[1:])
        t[i_ok], t[i_no] = a, b
        out.append(t)
    return tuple(out)


def _lq_solve(cfg, lq, mudyn, mu, assume_explicit: bool, step_mask, graphs=None):
    """The Newton step's LQ solve on the route of ``cfg.linear_solver``.
    Returns ``(xs, us, vs, lams, gains)``, ``gains`` a dict of the per-stage
    ``kff K zff Z lff L yff Afb`` (``'parallel'``: ``kff K`` only; it takes
    no nonlinear rollout). ``graphs`` holds the serial route's sweep graphs
    (:class:`~..gar.riccati.SweepGraph`)."""
    route = cfg.linear_solver
    if route == "associative":
        sol = _associative(cfg, lq, mudyn, mu, assume_explicit, step_mask)
        return (*sol[:4], dict(zip(GAINS, sol[4:])))
    _count_steps(route, step_mask)
    if route == "parallel":
        *sol, gains = gar_parallel.solve(lq, mudyn, mu, cfg.parallel_legs,
                                         assume_explicit, return_gains=True)
        return (*sol, dict(K=gains.K, kff=gains.kff))
    if route == "serial_scan":
        sol = _serial_scan(lq, mudyn, mu, assume_explicit)
        return (*sol[:4], dict(zip(GAINS, sol[4:])))
    if graphs is None:
        return riccati.solve_and_gains(lq, mudyn, mu, assume_explicit)
    return riccati.solve_and_gains(lq, mudyn, mu, assume_explicit, graphs=graphs)


def _newton_step(problem, cfg, st: _State, data: ProblemData, step_mask,
                 assume_explicit: bool, graph=None) -> _State:
    """One Newton iteration for the batch; the caller keeps it only for the
    scenarios of ``step_mask``, and the line search loops only over those."""
    N, nc, nct = problem.nsteps, problem.nc, problem.nc_term
    # initializeRegularization: attempt a decrease from the last good value
    preg0 = torch.where(
        st.preg_last == 0.0,
        torch.full_like(st.preg, max(cfg.reg_init, cfg.reg_min)),
        torch.clamp(st.preg_last * cfg.reg_dec_k, min=cfg.reg_min),
    )
    st = dataclasses.replace(st, preg=preg0)
    vhp = None
    if cfg.hessian_approx == "exact":
        vhp = problem_mod.dynamics_vhp(problem, st.xs, st.us, st.lams[:, 1:])
    m = _compute_multipliers(problem, cfg, data, st, st.lams, st.vs, st.vs_term)
    phi0 = _merit_value(cfg, st.mu, data.cost, m)
    Lxs, Lus = _lagrangian_grads(problem, cfg, data, st.lams, st.vs, st.vs_term)

    mudyn = cfg.dyn_al_scale * st.mu
    lq = _assemble_lq(problem, cfg, data, m, Lxs, Lus, st.preg, st.mu, vhp)
    graphs = problem.__dict__.setdefault("_sweep_graphs", {}) if st.xs.is_cuda else None
    dxs, dus_p, dvs_p, dlams, gains = _lq_solve(
        cfg, lq, mudyn, st.mu, assume_explicit, step_mask, graphs
    )
    dus = dus_p[:, :N]
    dvs = dvs_p[:, :N, :nc]
    dvs_t = dvs_p[:, N, :nct]
    if cfg.force_initial_condition:
        dxs = torch.cat([torch.zeros_like(dxs[:, :1]), dxs[:, 1:]], 1)
        dlams = torch.cat([torch.zeros_like(dlams[:, :1]), dlams[:, 1:]], 1)
    steps = (dxs, dus, dvs, dvs_t, dlams)

    # directional derivative with the first-order multiplier estimates
    Lxs_p, Lus_p = _lagrangian_grads(
        problem, cfg, data, m["lams_plus"], m["vs_plus"], m["vs_plus_t"]
    )
    dphi0 = (Lxs_p * dxs).flatten(1).sum(1) + (Lus_p * dus).flatten(1).sum(1)

    def try_alpha(alpha):
        return _forward_pass(problem, cfg, st, gains, steps, alpha, graph)

    if cfg.ls_strategy == "nonmonotone":
        # Zhang-Hager moving-average reference value
        weight = cfg.ls_avg_eta * st.ls_avg_weight + 1.0
        mov_avg = (cfg.ls_avg_eta * st.ls_avg_weight * st.ls_mov_avg + phi0) / weight
        phi_ref = mov_avg
        st = dataclasses.replace(st, ls_mov_avg=mov_avg, ls_avg_weight=weight)
    else:
        phi_ref = phi0

    first = try_alpha(torch.ones_like(st.mu))
    if cfg.ls_strategy == "filter":
        st, alpha, trial, cost, phi = _filter_search(
            cfg, st, try_alpha, first, step_mask
        )
    else:
        st, alpha, trial, cost, phi = _backtracking_search(
            cfg, st, try_alpha, first, step_mask, phi0, dphi0, phi_ref
        )

    # a null directional derivative means the step is noise: keep the
    # iterate; a non-finite trial is rejected as a line-search failure
    tiny_dir = dphi0.abs() <= cfg.dphi_thresh
    trial_ok = torch.isfinite(phi) & ~tiny_dir
    prev = (st.xs, st.us, st.vs, st.vs_term, st.lams)
    xs, us, vs, vs_term, lams = _where(trial_ok, trial, prev)
    alpha = torch.where(trial_ok, alpha, torch.full_like(alpha, cfg.ls_alpha_min))

    # regularization schedule: escalate on line-search failure; the
    # escalated value carries into the next initializeRegularization
    ls_failed = (alpha <= cfg.ls_alpha_min) & ~tiny_dir
    preg_inc = torch.where(
        st.preg_last == 0.0, st.preg * cfg.reg_inc_first_k, st.preg * cfg.reg_inc_k
    )
    fail = ls_failed & (st.preg >= cfg.reg_max)
    new_preg = torch.where(ls_failed, torch.clamp(preg_inc, max=cfg.reg_max), st.preg)
    return dataclasses.replace(
        st, xs=xs, us=us, vs=vs, vs_term=vs_term, lams=lams,
        cost=torch.where(trial_ok, cost, st.cost),
        merit=torch.where(trial_ok, phi, st.merit),
        K=gains["K"], kff=gains["kff"], alpha_last=alpha, dphi_last=dphi0,
        preg=new_preg, preg_last=new_preg, fail=st.fail | fail,
        newton_steps=st.newton_steps + 1,
    )


def _running(cfg, st: _State) -> Tensor:
    return ((st.iter < cfg.max_iters) & ~st.conv & ~st.fail
            & (st.al_iter < cfg.max_al_iters))


HISTORY_COLUMNS = ("prim", "dual", "inner_crit", "cost", "merit", "mu",
                   "al_iter", "alpha")


def record_row(buf: Tensor, it: Tensor, run: Tensor, value: Tensor) -> None:
    """Write ``value[b]`` at ``buf[b, it[b]]`` for the scenarios of ``run``,
    in place and without a host sync (the other scenarios' rows are
    rewritten with what they held)."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    idx = it.clamp(max=buf.shape[1] - 1).long()
    keep = buf[rows, idx]
    m = run.reshape(run.shape + (1,) * (value.ndim - 1))
    buf[rows, idx] = torch.where(m, value.to(buf.dtype), keep)


def _history_buffers(cfg, st: _State, dtype) -> dict:
    """The zeroed history tensors the configuration asks for."""
    B, n = st.xs.shape[0], cfg.max_iters
    out = {}
    if cfg.record_history:
        out["history"] = st.xs.new_zeros((B, n, len(HISTORY_COLUMNS)), dtype=dtype)
    if cfg.record_history_trajs:
        for k in ("xs", "us", "vs", "lams"):
            t = getattr(st, k)
            out[f"history_{k}"] = t.new_zeros((B, n) + t.shape[1:])
    return out


def _trace(cfg, st: _State, run, hist: dict, prim, dual, crit, cost) -> None:
    """Record the iteration's history rows, print its verbose rows and call
    the callback, for the scenarios of ``run``; ``st`` is the state before
    the BCL update."""
    if "history" in hist:
        row = torch.stack([prim, dual, crit, cost, st.merit, st.mu,
                           st.al_iter.to(st.mu.dtype), st.alpha_last], -1)
        record_row(hist["history"], st.iter, run, row)
    if cfg.record_history_trajs:
        for k in ("xs", "us", "vs", "lams"):
            record_row(hist[f"history_{k}"], st.iter, run, getattr(st, k))
    if cfg.verbose or cfg.callback is not None:
        trace = dict(iter=st.iter + 1, al_iter=st.al_iter + 1,
                     alpha=st.alpha_last, prim_err=prim, dual_err=dual,
                     inner_crit=crit, preg=st.preg, dphi0=st.dphi_last,
                     cost=cost, merit=st.merit, mu=st.mu, running=run)
        if cfg.verbose:
            logger_mod.log_rows(trace)
        if cfg.callback is not None:
            cfg.callback(trace)


def _iteration(problem, cfg, st: _State, run: Tensor, assume_explicit: bool,
               hist: dict, graph=None) -> _State:
    """One outer iteration for the scenarios of ``run``."""
    data = problem_mod.compute_derivatives(problem, st.xs, st.us)
    m = _compute_multipliers(problem, cfg, data, st, st.lams, st.vs, st.vs_term)
    Lxs, Lus = _lagrangian_grads(problem, cfg, data, st.lams, st.vs, st.vs_term)
    prim, dual, crit = _criteria(st, m, Lxs, Lus)
    st = dataclasses.replace(st, prim_infeas=prim, dual_infeas=dual,
                             inner_crit=crit, cost=data.cost)
    _trace(cfg, st, run, hist, prim, dual, crit, data.cost)
    overall = (dual <= cfg.target_dual_tol) & (prim <= cfg.tol)
    inner_done = (crit <= st.inner_tol) | overall
    st = _bcl_update(cfg, st, m, inner_done & run)

    # Newton step unless converged or failed; the BCL update leaves xs/us
    # as they are, so the derivatives above are those of the step's iterate
    step = run & ~(st.conv | st.fail)
    if bool(step.any()):
        st = _where(step, _newton_step(problem, cfg, st, data, step,
                                       assume_explicit, graph), st)
    return dataclasses.replace(st, iter=st.iter + 1)


def solve(problem: TrajOptProblem, cfg: ProxDDPConfig = ProxDDPConfig(),
          xs_init: Optional[Tensor] = None, us_init: Optional[Tensor] = None,
          vs_init: Optional[Tensor] = None,
          lams_init: Optional[Tensor] = None) -> ProxDDPResults:
    """Run ProxDDP on every scenario of ``problem`` (one per row of
    ``problem.x0``), on the device the problem's tensors live on."""
    _check_supported(cfg)
    if problem.init_constraint is not None and cfg.force_initial_condition:
        raise ValueError("a general init_constraint requires "
                         "ProxDDPConfig(force_initial_condition=False)")
    space = problem.space
    N, B = problem.nsteps, problem.batch
    ndx, nu, nc, nct = space.ndx, problem.nu, problem.nc, problem.nc_term
    x0 = problem.x0
    dtype, device = x0.dtype, x0.device

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    if xs_init is None:
        xs_init = x0[:, None].expand(B, N + 1, x0.shape[-1]).clone()
    if us_init is None:
        us_init = full((B, N, nu), 0.0)
    if vs_init is None:
        vs_init = full((B, N, nc), 0.0)
    lams0 = full((B, N + 1, ndx), 0.0) if lams_init is None else lams_init
    vs_term0 = full((B, nct), 0.0)

    mu0 = full((B,), max(cfg.mu_init, cfg.mu_lower_bound))
    arg0 = torch.clamp(mu0, max=0.99)
    inner_tol = torch.clamp(cfg.inner_tol0 * arg0 ** cfg.dual_alpha,
                            min=cfg.target_dual_tol)
    prim_tol = torch.clamp(cfg.prim_tol0 * arg0 ** cfg.prim_alpha, min=cfg.tol)

    # E = -I fast path: explicit dynamics on a vector space only
    assume_explicit = isinstance(space, VectorSpace) and getattr(
        problem.stages.dynamics, "is_explicit", True
    )
    if cfg.linear_solver == "associative" and not assume_explicit:
        raise ValueError("associative linear solver requires explicit "
                         "dynamics on a vector space")

    zero_i = torch.zeros((B,), dtype=torch.int32, device=device)
    false_b = torch.zeros((B,), dtype=torch.bool, device=device)
    st = _State(
        xs=xs_init, us=us_init, vs=vs_init, vs_term=vs_term0, lams=lams0,
        prev_vs=vs_init, prev_vs_term=vs_term0, prev_lams=lams0,
        mu=mu0, preg=full((B,), max(cfg.reg_init, cfg.reg_min)),
        preg_last=full((B,), 0.0), inner_tol=inner_tol, prim_tol=prim_tol,
        iter=zero_i, al_iter=zero_i, newton_steps=zero_i,
        merit=full((B,), torch.inf), cost=full((B,), torch.inf),
        prim_infeas=full((B,), torch.inf), dual_infeas=full((B,), torch.inf),
        inner_crit=full((B,), torch.inf), conv=false_b, fail=false_b,
        ls_mov_avg=full((B,), 0.0), ls_avg_weight=full((B,), 0.0),
        filter_vals=full((B, cfg.filter_size, 2), 0.0),
        filter_valid=torch.zeros((B, cfg.filter_size), dtype=torch.bool,
                                 device=device),
        K=full((B, N + 1, nu, ndx), 0.0), kff=full((B, N + 1, nu), 0.0),
        alpha_last=full((B,), 0.0), dphi_last=full((B,), 0.0),
    )
    hist = _history_buffers(cfg, st, dtype)
    graph = _trial_graph(problem, cfg) if x0.is_cuda else None

    while True:
        run = _running(cfg, st)
        if not bool(run.any()):
            break
        st = _where(run, _iteration(problem, cfg, st, run, assume_explicit,
                                    hist, graph), st)

    # final criterion refresh
    data = problem_mod.compute_derivatives(problem, st.xs, st.us)
    m = _compute_multipliers(problem, cfg, data, st, st.lams, st.vs, st.vs_term)
    Lxs, Lus = _lagrangian_grads(problem, cfg, data, st.lams, st.vs, st.vs_term)
    prim, dual, _ = _criteria(st, m, Lxs, Lus)
    conv = st.conv | ((dual <= cfg.target_dual_tol) & (prim <= cfg.tol))

    return ProxDDPResults(
        xs=st.xs, us=st.us, vs=st.vs, vs_term=st.vs_term, lams=st.lams,
        conv=conv, num_iters=st.iter, al_iter=st.al_iter,
        newton_steps=st.newton_steps, prim_infeas=prim, dual_infeas=dual,
        traj_cost=data.cost, merit_value=st.merit, K=st.K[:, :N],
        kff=st.kff[:, :N], mu_final=st.mu, **hist,
    )
