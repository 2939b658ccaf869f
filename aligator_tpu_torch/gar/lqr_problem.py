"""Batched proximal LQ problems and their dense-KKT oracle.

PyTorch counterpart of ``aligator_tpu/gar/lqr_problem.py``. Every tensor
carries a leading batch axis ``B`` (one LQ problem per scenario) ahead of
the time axis ``T = N + 1``. One stage ``t`` of a problem:

  cost        1/2 x'Q x + x'S u + 1/2 u'R u + q'x + r'u
  dynamics    A x_t + B u_t + E x_{t+1} + f = 0        (dual-regularized, mudyn)
  constraint  C x_t + D u_t + d = 0                    (dual-regularized, mueq)

plus the initial condition ``G0 x_0 + g0 = 0`` and optional parametric
blocks ``(Gx, Gu, Gth, gamma)`` coupling a parameter vector θ of dimension
``nth`` into the cost: ``x'Gx θ + u'Gu θ + 1/2 θ'Gth θ + gamma'θ`` (the
parallel-in-time leg condensation parameterizes each leg by the costate at
its outgoing interface). The dynamics fields at index ``N`` are unused
(kept zero). ``mudyn``/``mueq`` are floats or ``(B,)`` tensors: each
scenario may carry its own proximal parameters.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from .._device import resolve
from .._linalg import infnorm, mtv, mv


@dataclass
class LQRKnots:
    """Stacked LQ stage data, shapes ``(B, T, ...)``."""

    Q: Tensor  # (B, T, nx, nx)
    S: Tensor  # (B, T, nx, nu)
    R: Tensor  # (B, T, nu, nu)
    q: Tensor  # (B, T, nx)
    r: Tensor  # (B, T, nu)
    A: Tensor  # (B, T, nx, nx)   [index N unused]
    B: Tensor  # (B, T, nx, nu)   [index N unused]
    E: Tensor  # (B, T, nx, nx)   [index N unused]
    f: Tensor  # (B, T, nx)       [index N unused]
    C: Tensor  # (B, T, nc, nx)
    D: Tensor  # (B, T, nc, nu)
    d: Tensor  # (B, T, nc)
    # parametric blocks (θ of dimension nth); None when nth == 0
    Gx: Optional[Tensor] = None  # (B, T, nx, nth)
    Gu: Optional[Tensor] = None  # (B, T, nu, nth)
    Gth: Optional[Tensor] = None  # (B, T, nth, nth)
    gamma: Optional[Tensor] = None  # (B, T, nth)

    @property
    def batch(self) -> int:
        return self.Q.shape[0]

    @property
    def horizon(self) -> int:
        return self.Q.shape[1] - 1

    @property
    def nx(self) -> int:
        return self.Q.shape[-1]

    @property
    def nu(self) -> int:
        return self.R.shape[-1]

    @property
    def nc(self) -> int:
        return self.C.shape[-2]

    @property
    def nth(self) -> int:
        return 0 if self.Gx is None else self.Gx.shape[-1]

    def map(self, fn) -> "LQRKnots":
        """The knots with ``fn`` applied to every field that is set."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None})


@dataclass
class LQRProblem:
    """Batched LQ problems over horizon N: knots plus the initial condition."""

    knots: LQRKnots
    G0: Tensor  # (B, nc0, nx)
    g0: Tensor  # (B, nc0)

    @property
    def batch(self) -> int:
        return self.knots.batch

    @property
    def horizon(self) -> int:
        return self.knots.horizon

    @property
    def nc0(self) -> int:
        return self.G0.shape[-2]

    @property
    def nx(self) -> int:
        return self.knots.nx

    @property
    def nu(self) -> int:
        return self.knots.nu

    @property
    def nc(self) -> int:
        return self.knots.nc

    @property
    def nth(self) -> int:
        return self.knots.nth

    def map(self, fn) -> "LQRProblem":
        """The problems with ``fn`` applied to every tensor (``G0``, ``g0``
        and each knot field that is set), e.g. a batch slice or a cast."""
        return LQRProblem(knots=self.knots.map(fn), G0=fn(self.G0), g0=fn(self.g0))


def add_parameterization(knots: LQRKnots, nth: int) -> LQRKnots:
    """The knots with zero parametric blocks of dimension ``nth`` (the
    reference's ``LqrKnotTpl::addParameterization``)."""
    Bsz, T = knots.Q.shape[:2]

    def zeros(*shape):
        return knots.Q.new_zeros((Bsz, T) + shape)

    return dataclasses.replace(
        knots, Gx=zeros(knots.nx, nth), Gu=zeros(knots.nu, nth),
        Gth=zeros(nth, nth), gamma=zeros(nth),
    )


def batch_param(mu, problem: LQRProblem) -> Tensor:
    """A proximal parameter (float or ``(B,)`` tensor) as a ``(B,)`` tensor
    of the problem's dtype and device."""
    Q = problem.knots.Q
    return torch.as_tensor(mu, dtype=Q.dtype, device=Q.device).expand(
        problem.batch
    )


def random_convex_problem(rng: np.random.Generator, B: int, N: int, nx: int,
                          nu: int, nc: int, general_E: bool = False,
                          dtype=torch.float64, device="cuda",
                          null_controls: int = 0) -> LQRProblem:
    """B random well-posed LQ problems with jointly convex stage costs (test
    utility): each ``[[Q, S], [S', R]]`` is one Wishart draw plus 0.1·I on R,
    the law of ``aligator_tpu.gar.random_convex_problem`` drawn with a numpy
    generator. ``E = -I``, or ``-I + 0.1·noise`` with ``general_E``; the
    terminal knot has ``R = I`` and zero ``S, r, D`` and dynamics. With
    ``null_controls = k`` k columns of B and D, spread evenly over the
    controls, are zero: k controls that neither the dynamics nor the
    constraints see, so that the reduced KKT matrix R̂ + DᵀD/μ has k
    eigenvalues of order R's beside ones of order 1/μ, nearly singular at
    small μ. The controls are then put in a random orthogonal basis of each
    knot (B, D, S ← ·U, R ← UᵀRU, r ← Uᵀr; drawn after every other draw), so
    that those directions mix into every block of pivots rather than lie
    along coordinate axes, where a diagonal scaling would hide them from the
    elimination."""
    T, n = N + 1, nx + nu
    root = rng.standard_normal((B, T, n, n + 2))
    joint = root @ root.swapaxes(-1, -2) / (n + 2)
    a = dict(
        Q=joint[..., :nx, :nx], S=joint[..., :nx, nx:],
        R=joint[..., nx:, nx:] + 0.1 * np.eye(nu),
        q=rng.standard_normal((B, T, nx)), r=rng.standard_normal((B, T, nu)),
        A=rng.standard_normal((B, T, nx, nx)) / np.sqrt(nx),
        B=rng.standard_normal((B, T, nx, nu)) / np.sqrt(nu),
        E=np.zeros((B, T, nx, nx)) - np.eye(nx),
        f=0.1 * rng.standard_normal((B, T, nx)),
        C=rng.standard_normal((B, T, nc, nx)),
        D=rng.standard_normal((B, T, nc, nu)),
        d=rng.standard_normal((B, T, nc)),
    )
    if general_E:
        a["E"] += 0.1 * rng.standard_normal((B, T, nx, nx))
    if null_controls:
        idx = np.round(np.linspace(0, nu - 1, null_controls)).astype(int)
        a["B"][..., idx] = 0.0
        a["D"][..., idx] = 0.0
    a["R"][:, N] = np.eye(nu)
    for k in ("S", "r", "D", "A", "B", "E", "f"):
        a[k][:, N] = 0.0
    g0 = rng.standard_normal((B, nx))
    if null_controls:
        # the controls in a random orthogonal basis of each knot (u = U v)
        U = np.linalg.qr(rng.standard_normal((B, T, nu, nu)))[0]
        Ut = U.swapaxes(-1, -2)
        for k in ("B", "D", "S"):
            a[k] = a[k] @ U
        a["R"] = Ut @ a["R"] @ U
        a["R"] = 0.5 * (a["R"] + a["R"].swapaxes(-1, -2))
        a["r"] = (Ut @ a["r"][..., None])[..., 0]
    dev = resolve(device)

    def t(x):
        return torch.tensor(x, dtype=dtype, device=dev)

    knots = LQRKnots(**{k: t(v) for k, v in a.items()})
    G0 = t(np.zeros((B, nx, nx)) + np.eye(nx))
    return LQRProblem(knots=knots, G0=G0, g0=t(g0))


def _num_rows(problem: LQRProblem) -> int:
    N = problem.horizon
    nx, nu, nc = problem.nx, problem.nu, problem.nc
    return problem.nc0 + (N + 1) * (nx + nu + nc) + N * nx


def dense_kkt(problem: LQRProblem, mudyn, mueq):
    """Assemble the dense symmetric proximal KKT systems ``M z + rhs = 0``.

    Variable layout per scenario: ``[λ0, (x0,u0,ν0), λ1, (x1,u1,ν1), ...,
    λN, (xN,uN,νN)]``. Returns ``M (B, n, n)`` and ``rhs (B, n)``.
    """
    kn = problem.knots
    N = problem.horizon
    nx, nu, nc, nc0 = problem.nx, problem.nu, problem.nc, problem.nc0
    Bsz = problem.batch
    n = nx + nu + nc
    nrows = _num_rows(problem)
    md = batch_param(mudyn, problem)[:, None, None]
    me = batch_param(mueq, problem)[:, None, None]
    M = kn.Q.new_zeros((Bsz, nrows, nrows))
    rhs = kn.Q.new_zeros((Bsz, nrows))
    eye0 = torch.eye(nc0, dtype=M.dtype, device=M.device)
    eyex = torch.eye(nx, dtype=M.dtype, device=M.device)
    eyec = torch.eye(nc, dtype=M.dtype, device=M.device)

    M[:, :nc0, :nc0] = -md * eye0
    M[:, :nc0, nc0:nc0 + nx] = problem.G0
    M[:, nc0:nc0 + nx, :nc0] = problem.G0.mT
    rhs[:, :nc0] = problem.g0

    idx = nc0
    for t in range(N + 1):
        ix, iu, ic = idx, idx + nx, idx + nx + nu
        M[:, ix:ix + nx, ix:ix + nx] += kn.Q[:, t]
        M[:, ix:ix + nx, iu:iu + nu] += kn.S[:, t]
        M[:, iu:iu + nu, ix:ix + nx] += kn.S[:, t].mT
        M[:, iu:iu + nu, iu:iu + nu] += kn.R[:, t]
        M[:, ic:ic + nc, ix:ix + nx] += kn.C[:, t]
        M[:, ix:ix + nx, ic:ic + nc] += kn.C[:, t].mT
        M[:, ic:ic + nc, iu:iu + nu] += kn.D[:, t]
        M[:, iu:iu + nu, ic:ic + nc] += kn.D[:, t].mT
        M[:, ic:ic + nc, ic:ic + nc] += -me * eyec
        rhs[:, ix:ix + nx] = kn.q[:, t]
        rhs[:, iu:iu + nu] = kn.r[:, t]
        rhs[:, ic:ic + nc] = kn.d[:, t]
        if t < N:
            il = idx + n  # costate λ_{t+1} row block
            iy = il + nx  # x_{t+1} column block
            M[:, il:il + nx, ix:ix + nx] = kn.A[:, t]
            M[:, ix:ix + nx, il:il + nx] = kn.A[:, t].mT
            M[:, il:il + nx, iu:iu + nu] = kn.B[:, t]
            M[:, iu:iu + nu, il:il + nx] = kn.B[:, t].mT
            M[:, il:il + nx, il:il + nx] = -md * eyex
            M[:, il:il + nx, iy:iy + nx] = kn.E[:, t]
            M[:, iy:iy + nx, il:il + nx] = kn.E[:, t].mT
            rhs[:, il:il + nx] = kn.f[:, t]
            idx += n + nx
    return M, rhs


def split_solution(problem: LQRProblem, z: Tensor):
    """Split stacked dense-KKT solutions ``(B, n)`` into (xs, us, vs, lams)."""
    N = problem.horizon
    nx, nu, nc, nc0 = problem.nx, problem.nu, problem.nc, problem.nc0
    n = nx + nu + nc
    xs, us, vs, lams = [], [], [], [z[:, :nc0]]
    idx = nc0
    for t in range(N + 1):
        xs.append(z[:, idx:idx + nx])
        us.append(z[:, idx + nx:idx + nx + nu])
        vs.append(z[:, idx + nx + nu:idx + n])
        if t < N:
            lams.append(z[:, idx + n:idx + n + nx])
            idx += n + nx
    return (
        torch.stack(xs, 1), torch.stack(us, 1), torch.stack(vs, 1),
        torch.stack(lams, 1),
    )


def dense_solve(problem: LQRProblem, mudyn, mueq):
    """Solve by dense LU factorization of the KKT matrix (test oracle).
    Returns (xs, us, vs, lams), each ``(B, T, ·)``."""
    M, rhs = dense_kkt(problem, mudyn, mueq)
    z = torch.linalg.solve(M, -rhs)
    return split_solution(problem, z)


def kkt_residual_vectors(problem: LQRProblem, xs, us, vs, lams, mudyn, mueq,
                         theta: Optional[Tensor] = None):
    """KKT residual vectors of candidate solutions: ``(g0_res (B, nc0), gx
    (B, T, nx), gu (B, T, nu), cstr (B, T, nc), dyn (B, N, nx))``. With
    ``theta (B, nth)`` the parametric blocks' terms ``Gx θ``, ``Gu θ`` enter
    the dual residuals. The iterative refinement of the parallel-in-time
    solvers re-solves on these."""
    kn = problem.knots
    N = problem.horizon
    md = batch_param(mudyn, problem)
    me = batch_param(mueq, problem)

    g0_res = problem.g0 + mv(problem.G0, xs[:, 0]) - md[:, None] * lams[:, 0]
    dyn = (
        mv(kn.A[:, :N], xs[:, :N]) + mv(kn.B[:, :N], us[:, :N])
        + kn.f[:, :N] + mv(kn.E[:, :N], xs[:, 1:])
        - md[:, None, None] * lams[:, 1:]
    )
    cstr = mv(kn.C, xs) + mv(kn.D, us) + kn.d - me[:, None, None] * vs
    gx = kn.q + mv(kn.Q, xs) + mv(kn.S, us) + mtv(kn.C, vs)
    gu = kn.r + mtv(kn.S, xs) + mv(kn.R, us) + mtv(kn.D, vs)
    gx[:, 0] += mtv(problem.G0, lams[:, 0])
    gx[:, 1:] += mtv(kn.E[:, :N], lams[:, 1:])
    gx[:, :N] += mtv(kn.A[:, :N], lams[:, 1:])
    gu[:, :N] += mtv(kn.B[:, :N], lams[:, 1:])
    if theta is not None and kn.nth > 0:
        gx = gx + mv(kn.Gx, theta[:, None])
        gu = gu + mv(kn.Gu, theta[:, None])
    return g0_res, gx, gu, cstr, dyn


def kkt_error(problem: LQRProblem, xs, us, vs, lams, mudyn, mueq,
              theta: Optional[Tensor] = None):
    """Max-norm KKT residuals ``(dyn, cstr, dual)``, each ``(B,)``, of
    candidate solutions plugged into the proximal stationarity conditions
    (with ``theta (B, nth)``, of the problem at that parameter)."""
    g0_res, gx, gu, cstr, dyn = kkt_residual_vectors(
        problem, xs, us, vs, lams, mudyn, mueq, theta)
    dyn_err = torch.maximum(infnorm(g0_res), infnorm(dyn))
    dual_err = torch.maximum(infnorm(gx), infnorm(gu))
    return dyn_err, infnorm(cstr), dual_err
