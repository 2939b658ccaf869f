"""FDDP: feasible differential dynamic programming (Crocoddyl-style), batched.

PyTorch counterpart of ``aligator_tpu/solvers/fddp.py``: unconstrained DDP
with multiple-shooting gaps, a gap-contracting forward pass, Q-function
regularization and the Goldstein-like backtracking line search driven by an
expected-improvement model. Constraints are ignored, with a warning.

The JAX solver is written for one scenario and ``vmap``ped; this one carries
the batch axis through every tensor and keeps each scenario's semantics with
masks, as :mod:`.proxddp` does: the outer loop runs while any scenario
iterates and freezes the others, the line search advances only the
scenarios still searching. The backward pass solves each stage's
``Quu [kff | K] = [Qu | Qxu']`` through :func:`~..gar.spd_solve.spd_solve`
(the SPD kernel K2 on the card, one launch per stage); the transition
Jacobians ``-E^{-1}[A B]`` are a torch solve, as the JAX package computes
them outside any kernel.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import Tensor

from .._linalg import infnorm, mtv, mv
from .._linalg import select as _where
from ..core import problem as problem_mod
from ..core.problem import TrajOptProblem
from ..gar import spd_solve


@dataclass(frozen=True)
class FDDPConfig:
    """Solver hyper-parameters; defaults follow the reference."""

    tol: float = 1e-6
    max_iters: int = 200
    reg_init: float = 1e-9
    reg_min: float = 1e-9
    reg_max: float = 1e9
    reg_inc_factor: float = 10.0
    reg_dec_factor: float = 0.1
    th_grad: float = 1e-12
    th_step_dec: float = 0.5
    th_step_inc: float = 0.01
    th_accept_step: float = 0.1
    th_accept_neg_step: float = 2.0
    ls_alpha_min: float = 2.0**-9
    ls_beta: float = 0.5
    # not ported yet (raise NotImplementedError)
    record_history: bool = False
    record_history_trajs: bool = False
    verbose: bool = False
    callback: Optional[Callable[[dict], None]] = None


@dataclass
class FDDPResults:
    """Solver results, batch first."""

    xs: Tensor  # (B, N+1, nx)
    us: Tensor  # (B, N, nu)
    conv: Tensor  # (B,) bool
    num_iters: Tensor  # (B,) int
    prim_infeas: Tensor  # (B,)
    dual_infeas: Tensor  # (B,)
    traj_cost: Tensor  # (B,)
    K: Tensor  # (B, N, nu, ndx) feedback gains of the last backward pass
    kff: Tensor  # (B, N, nu)


@dataclass
class _State:
    xs: Tensor
    us: Tensor
    cost: Tensor
    preg: Tensor
    iter: Tensor
    conv: Tensor
    fail: Tensor
    prim: Tensor
    dual: Tensor
    K: Tensor
    kff: Tensor


def _check_supported(cfg: FDDPConfig):
    for name, ported in (("record_history", False),
                         ("record_history_trajs", False), ("verbose", False),
                         ("callback", None)):
        got = getattr(cfg, name)
        if got != ported:
            raise NotImplementedError(
                f"FDDPConfig.{name}={got!r} is not ported yet; the port "
                f"supports {name}={ported!r}"
            )


def _gaps(problem: TrajOptProblem, xs: Tensor, us: Tensor) -> Tensor:
    """Initial and dynamics gaps ``fs (B, N+1, ndx)``."""
    space, N = problem.space, problem.nsteps
    f0 = space.difference(xs[:, 0], problem.x0)
    xnext = problem.stages.dynamics.forward(space, xs[:, :N], us)
    return torch.cat([f0[:, None], space.difference(xs[:, 1:], xnext)], 1)


def _backward(problem: TrajOptProblem, data, fs: Tensor, preg: Tensor) -> dict:
    """Backward DDP sweep (reference backwardPass, solver-fddp.hxx:203):
    per-stage gains and the terms of the expected-improvement model."""
    N, ndx, nu = problem.nsteps, problem.space.ndx, problem.nu
    Bsz = fs.shape[0]
    eye_x = torch.eye(ndx, dtype=fs.dtype, device=fs.device)
    eye_u = torch.eye(nu, dtype=fs.dtype, device=fs.device)
    p3 = preg[:, None, None]
    Vxx = data.Lxx[:, N] + p3 * eye_x
    ftVxxN = mv(Vxx, fs[:, N])
    Vx = data.Lx[:, N] + ftVxxN

    # transition Jacobians (croco convention Fx dx = dy): -E^{-1}[A B]
    F = torch.linalg.solve(-data.E, torch.cat([data.A, data.B], -1))
    Fx, Fu = F[..., :ndx], F[..., ndx:]

    def buf(*shape):
        return fs.new_empty((Bsz, N) + shape)

    out = dict(kff=buf(nu), K=buf(nu, ndx), Qu=buf(nu), Quuk=buf(nu),
               Vx=buf(ndx), ftVxx=buf(ndx))
    for t in range(N - 1, -1, -1):
        Fx_t, Fu_t = Fx[:, t], Fu[:, t]
        Qx = data.Lx[:, t] + mtv(Fx_t, Vx)
        Qu = data.Lu[:, t] + mtv(Fu_t, Vx)
        FxV = Fx_t.mT @ Vxx
        FuV = Fu_t.mT @ Vxx
        Qxx = data.Lxx[:, t] + FxV @ Fx_t
        Qxu = data.Lxu[:, t] + FxV @ Fu_t
        Quu = data.Luu[:, t] + FuV @ Fu_t + p3 * eye_u
        # joint feedforward + feedback solve against one factorization
        sol = spd_solve.spd_solve(0.5 * (Quu + Quu.mT),
                                  torch.cat([Qu[..., None], Qxu.mT], -1))
        kff, K = -sol[..., 0], -sol[..., 1:]
        Vxx = Qxx + Qxu @ K
        Vxx = 0.5 * (Vxx + Vxx.mT) + p3 * eye_x
        ftVxx = mv(Vxx, fs[:, t])
        Vx = Qx + mtv(K, Qu) + ftVxx
        for k, v in (("kff", kff), ("K", K), ("Qu", Qu), ("Quuk", mv(Quu, kff)),
                     ("Vx", Vx), ("ftVxx", ftVxx)):
            out[k][:, t] = v
    out["ftVxxN"] = ftVxxN
    return out


def _rollout(problem: TrajOptProblem, xs, us, fs, bw, alpha: Tensor):
    """Gap-contracting rollout of step length ``alpha (B,)`` (reference
    forwardPass, solver-fddp.hxx:58). Returns the trial ``xs``, ``us``, the
    state deviations ``dxs (B, N+1, ndx)`` and the trial cost."""
    space, stage, N = problem.space, problem.stages, problem.nsteps
    a1 = alpha[:, None]
    dx = a1 * fs[:, 0]
    x = space.integrate(xs[:, 0], dx)
    xs_t, us_t, dxs = [x], [], [dx]
    for t in range(N):
        u = us[:, t] + a1 * bw["kff"][:, t] + mv(bw["K"][:, t], dx)
        xnext = stage.dynamics.forward(space, x, u)
        x = space.integrate(xnext, (a1 - 1.0) * fs[:, t + 1])
        dx = space.difference(xs[:, t + 1], x)
        xs_t.append(x)
        us_t.append(u)
        dxs.append(dx)
    xs_t, us_t, dxs = (torch.stack(v, 1) for v in (xs_t, us_t, dxs))
    u0 = us.new_zeros(us.shape[:1] + us.shape[2:])
    cost = (stage.cost.value(space, xs_t[:, :N], us_t).sum(1)
            + problem.term_cost.value(space, xs_t[:, N], u0))
    return xs_t, us_t, dxs, cost


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).flatten(1).sum(1)


def _step(problem, cfg: FDDPConfig, st: _State, data, fs, bw,
          step_mask: Tensor) -> _State:
    """Line search along the backward pass's gains and the regularization
    update, for the scenarios of ``step_mask``."""
    N = problem.nsteps
    phi0 = st.cost
    # expected improvement constants (updateExpectedImprovement,
    # solver-fddp.hxx:140); the terminal Vx is Lx[N] + ftVxxN
    dg = (_dot(bw["Qu"], bw["kff"]) + _dot(bw["Vx"], fs[:, :N])
          + _dot(bw["ftVxxN"], fs[:, N]) + _dot(data.Lx[:, N], fs[:, N]))
    dq = _dot(bw["kff"], bw["Quuk"]) - (
        _dot(fs[:, :N], bw["ftVxx"]) + _dot(fs[:, N], bw["ftVxxN"]))

    def try_alpha(alpha):
        xs_t, us_t, dxs, cost = _rollout(problem, st.xs, st.us, fs, bw, alpha)
        dv = -(_dot(dxs[:, :N], bw["ftVxx"]) + _dot(dxs[:, N], bw["ftVxxN"]))
        d1 = dg + dv
        d2 = dq - 2.0 * dv
        model = phi0 + alpha * (d1 + 0.5 * d2 * alpha)
        return (xs_t, us_t, cost, d1), model

    def accepted(cost, model, d1):
        dVreal = cost - phi0
        dVmodel = model - phi0
        acc_desc = (d1.abs() < cfg.th_grad) | (dVreal <= cfg.th_accept_step * dVmodel)
        acc_neg = dVreal <= cfg.th_accept_neg_step * dVmodel
        return torch.isfinite(cost) & torch.where(dVmodel < 0.0, acc_desc, acc_neg)

    alpha = torch.ones_like(phi0)
    trial, model = try_alpha(alpha)
    accept = accepted(trial[2], model, trial[3])
    while True:
        go = (~accept & (alpha > cfg.ls_alpha_min * (1 + 1e-10)) & step_mask)
        if not bool(go.any()):
            break
        alpha2 = torch.clamp(alpha * cfg.ls_beta, min=cfg.ls_alpha_min)
        trial2, model2 = try_alpha(alpha2)
        acc2 = accepted(trial2[2], model2, trial2[3])
        alpha, trial, accept = _where(go, (alpha2, trial2, acc2),
                                      (alpha, trial, accept))

    xs_t, us_t, cost, d1 = trial
    ok = torch.isfinite(cost)  # reject non-finite trials
    xs_t, us_t, cost = _where(ok, (xs_t, us_t, cost), (st.xs, st.us, st.cost))

    preg = torch.where(alpha > cfg.th_step_dec,
                       torch.clamp(st.preg * cfg.reg_dec_factor, min=cfg.reg_min),
                       st.preg)
    inc = alpha <= cfg.th_step_inc
    preg = torch.where(inc, torch.clamp(preg * cfg.reg_inc_factor, max=cfg.reg_max),
                       preg)
    return dataclasses.replace(
        st, xs=xs_t, us=us_t, cost=cost, preg=preg,
        conv=st.conv | (d1.abs() < cfg.th_grad),
        fail=st.fail | (inc & (preg >= cfg.reg_max)),
    )


def _iteration(problem, cfg: FDDPConfig, st: _State, run: Tensor) -> _State:
    """One FDDP iteration for the scenarios of ``run``."""
    data = problem_mod.compute_derivatives(problem, st.xs, st.us)
    fs = _gaps(problem, st.xs, st.us)
    bw = _backward(problem, data, fs, st.preg)
    prim, dual = infnorm(fs), infnorm(bw["Qu"])
    st = dataclasses.replace(st, prim=prim, dual=dual, K=bw["K"], kff=bw["kff"])
    converged = torch.maximum(prim, dual) < cfg.tol
    step = run & ~converged
    if bool(step.any()):
        st = _where(step, _step(problem, cfg, st, data, fs, bw, step), st)
    return dataclasses.replace(st, conv=st.conv | converged, iter=st.iter + 1)


def solve(problem: TrajOptProblem, cfg: FDDPConfig = FDDPConfig(),
          xs_init: Optional[Tensor] = None,
          us_init: Optional[Tensor] = None) -> FDDPResults:
    """Run FDDP on every scenario of ``problem`` (one per row of
    ``problem.x0``), on the device the problem's tensors live on."""
    _check_supported(cfg)
    if problem.nc > 0 or problem.nc_term > 0:
        warnings.warn(
            "FDDP cannot handle constraints; they will be IGNORED "
            "(reference solver-fddp.hxx:36-55). Use ProxDDP instead."
        )
    N, Bsz = problem.nsteps, problem.batch
    ndx, nu = problem.space.ndx, problem.nu
    x0 = problem.x0
    dtype, device = x0.dtype, x0.device
    if xs_init is None:
        xs_init = x0[:, None].expand(Bsz, N + 1, x0.shape[-1]).clone()
    if us_init is None:
        us_init = x0.new_zeros((Bsz, N, nu))

    def full(value, dt=dtype):
        return torch.full((Bsz,), value, dtype=dt, device=device)

    false_b = full(False, torch.bool)
    st = _State(
        xs=xs_init, us=us_init,
        cost=problem_mod.evaluate(problem, xs_init, us_init).cost,
        preg=full(cfg.reg_init), iter=full(0, torch.int32), conv=false_b,
        fail=false_b, prim=full(torch.inf), dual=full(torch.inf),
        K=x0.new_zeros((Bsz, N, nu, ndx)), kff=x0.new_zeros((Bsz, N, nu)),
    )
    while True:
        run = (st.iter < cfg.max_iters) & ~st.conv & ~st.fail
        if not bool(run.any()):
            break
        st = _where(run, _iteration(problem, cfg, st, run), st)

    # final metrics
    data = problem_mod.compute_derivatives(problem, st.xs, st.us)
    fs = _gaps(problem, st.xs, st.us)
    bw = _backward(problem, data, fs, st.preg)
    prim, dual = infnorm(fs), infnorm(bw["Qu"])
    return FDDPResults(
        xs=st.xs, us=st.us, conv=st.conv | (torch.maximum(prim, dual) < cfg.tol),
        num_iters=st.iter, prim_infeas=prim, dual_infeas=dual,
        traj_cost=data.cost, K=bw["K"], kff=bw["kff"],
    )
