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

What this port covers: linear rollout, the serial LQ solve
(:func:`~aligator_tpu_torch.gar.riccati.solve_and_gains`, which routes by
shape: small-dim problems to the fused solve K1, explicit dynamics with
12 <= nx <= 44 to the fused backward sweep K3, the rest to the per-stage
loop with the SPD solve K2, and forward sweeps at nx >= 12 to K4), the
three multiplier update modes, the three step-acceptance strategies, the
BCL schedule and the regularization schedule, with Gauss-Newton Hessians.
The other options of the JAX configuration raise ``NotImplementedError``;
its ``lq_spd_lanes``, ``lq_stage_fused`` and ``lq_scan_unroll`` knobs have
no counterpart, since the routing follows the shape alone.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import Tensor

from .._linalg import infnorm, mtv
from .._linalg import select as _where
from ..core import problem as problem_mod
from ..core.manifolds import VectorSpace
from ..core.problem import ProblemData, TrajOptProblem
from ..gar import lqr_problem as lqr_mod
from ..gar import riccati


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
    # not ported yet (raise NotImplementedError): 'exact' Hessians,
    # 'nonlinear' rollout, 'parallel'/'associative' LQ solvers, history and
    # callbacks
    hessian_approx: str = "gauss_newton"
    dphi_thresh: float = 1e-13
    rollout: str = "linear"
    linear_solver: str = "serial"
    force_initial_condition: bool = True
    record_history: bool = False
    record_history_trajs: bool = False
    verbose: bool = False
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


def _check_supported(cfg: ProxDDPConfig):
    unsupported = {
        "rollout": (cfg.rollout, "linear"),
        "linear_solver": (cfg.linear_solver, "serial"),
        "hessian_approx": (cfg.hessian_approx, "gauss_newton"),
        "record_history": (cfg.record_history, False),
        "record_history_trajs": (cfg.record_history_trajs, False),
        "verbose": (cfg.verbose, False),
        "callback": (cfg.callback, None),
    }
    for name, (got, ported) in unsupported.items():
        if got != ported:
            raise NotImplementedError(
                f"ProxDDPConfig.{name}={got!r} is not ported yet; the port "
                f"supports {name}={ported!r}"
            )
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
                 mu) -> lqr_mod.LQRProblem:
    """Fill the proximal LQ subproblems from stage data, with active-set
    projected constraint Jacobians."""
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
    S = torch.cat([data.Lxu, data.Lxu.new_zeros((Bsz, 1, ndx, nu))], 1)
    R = torch.cat(
        [data.Luu + preg4 * eye_u, eye_u.expand(Bsz, 1, nu, nu)], 1
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


def _forward_pass(problem, cfg, st: _State, steps, alpha: Tensor):
    """Trial point of a linear step of length ``alpha (B,)``, its cost, merit
    and primal infeasibility."""
    dxs, dus, dvs, dvs_t, dlams = steps
    a3 = alpha[:, None, None]
    txs = problem.space.integrate(st.xs, a3 * dxs)
    tus = st.us + a3 * dus
    tvs = st.vs + a3 * dvs
    tvt = st.vs_term + alpha[:, None] * dvs_t
    tlams = st.lams + a3 * dlams
    data = problem_mod.evaluate(problem, txs, tus)
    m = _compute_multipliers(problem, cfg, data, st, tlams, tvs, tvt)
    phi = _merit_value(cfg, st.mu, data.cost, m)
    prim = torch.maximum(_stage_infeas(st, m), infnorm(m["dyn_slacks"]))
    return (txs, tus, tvs, tvt, tlams), data.cost, phi, prim


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


def _newton_step(problem, cfg, st: _State, data: ProblemData, step_mask,
                 assume_explicit: bool) -> _State:
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
    m = _compute_multipliers(problem, cfg, data, st, st.lams, st.vs, st.vs_term)
    phi0 = _merit_value(cfg, st.mu, data.cost, m)
    Lxs, Lus = _lagrangian_grads(problem, cfg, data, st.lams, st.vs, st.vs_term)

    mudyn = cfg.dyn_al_scale * st.mu
    lq = _assemble_lq(problem, cfg, data, m, Lxs, Lus, st.preg, st.mu)
    dxs, dus_p, dvs_p, dlams, gains = riccati.solve_and_gains(
        lq, mudyn, st.mu, assume_explicit
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
        return _forward_pass(problem, cfg, st, steps, alpha)

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
        K=gains["K"], kff=gains["kff"],
        preg=new_preg, preg_last=new_preg, fail=st.fail | fail,
        newton_steps=st.newton_steps + 1,
    )


def _running(cfg, st: _State) -> Tensor:
    return ((st.iter < cfg.max_iters) & ~st.conv & ~st.fail
            & (st.al_iter < cfg.max_al_iters))


def _iteration(problem, cfg, st: _State, run: Tensor,
               assume_explicit: bool) -> _State:
    """One outer iteration for the scenarios of ``run``."""
    data = problem_mod.compute_derivatives(problem, st.xs, st.us)
    m = _compute_multipliers(problem, cfg, data, st, st.lams, st.vs, st.vs_term)
    Lxs, Lus = _lagrangian_grads(problem, cfg, data, st.lams, st.vs, st.vs_term)
    prim, dual, crit = _criteria(st, m, Lxs, Lus)
    st = dataclasses.replace(st, prim_infeas=prim, dual_infeas=dual,
                             inner_crit=crit, cost=data.cost)
    overall = (dual <= cfg.target_dual_tol) & (prim <= cfg.tol)
    inner_done = (crit <= st.inner_tol) | overall
    st = _bcl_update(cfg, st, m, inner_done & run)

    # Newton step unless converged or failed; the BCL update leaves xs/us
    # as they are, so the derivatives above are those of the step's iterate
    step = run & ~(st.conv | st.fail)
    if bool(step.any()):
        st = _where(step, _newton_step(problem, cfg, st, data, step,
                                       assume_explicit), st)
    return dataclasses.replace(st, iter=st.iter + 1)


def solve(problem: TrajOptProblem, cfg: ProxDDPConfig = ProxDDPConfig(),
          xs_init: Optional[Tensor] = None, us_init: Optional[Tensor] = None,
          vs_init: Optional[Tensor] = None,
          lams_init: Optional[Tensor] = None) -> ProxDDPResults:
    """Run ProxDDP on every scenario of ``problem`` (one per row of
    ``problem.x0``), on the device the problem's tensors live on."""
    _check_supported(cfg)
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
    )

    while True:
        run = _running(cfg, st)
        if not bool(run.any()):
            break
        st = _where(run, _iteration(problem, cfg, st, run, assume_explicit), st)

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
        kff=st.kff[:, :N], mu_final=st.mu,
    )
