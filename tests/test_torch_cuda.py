"""The port's CUDA kernels against their plain versions, on the card, and
the slices that run them against the same solves on the CPU.

These tests import no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py

Each skips without a CUDA device (the kernels have no CPU mode).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import aligator_tpu_torch as at
from aligator_tpu_torch import _build, convert
from aligator_tpu_torch.examples import inverse_lqr, medium_dims, theta_family
from aligator_tpu_torch.examples.cartpole import create_cartpole_problem
from aligator_tpu_torch.examples.lqr import make_lqr_problem
from aligator_tpu_torch.examples.se2_car import create_se2_problem
from aligator_tpu_torch.gar import (diff, fused_riccati, fused_stage, lqr_problem,
                                    riccati, spd_solve)
from aligator_tpu_torch.modelling.multibody import fd_rows, free_fd, humanoid, quadruped
from aligator_tpu_torch.modelling.multibody import model as rbd


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return "cuda"


def _mus(B, seed, device):
    rng = np.random.default_rng(seed)
    return (torch.tensor(10 ** rng.uniform(-3, -1, B), device=device)
            for _ in range(2))


@pytest.fixture(scope="module")
def k1_built():
    """K1 built at every domain sample at once, an nvcc each in parallel,
    rather than one after another at each shape's first launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from aligator_tpu_torch import _build

    _build.build([fused_riccati.variant(*s) for s in fused_riccati.DOMAIN_SAMPLES])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 300])  # 300: the last block is ragged
@pytest.mark.parametrize("shape", fused_riccati.DOMAIN_SAMPLES)
def test_fused_riccati_matches_plain(cuda_device, k1_built, shape, B):
    nx, nu, nc, explicit = shape
    prob = lqr_problem.random_convex_problem(
        np.random.default_rng(6), B, 9, nx, nu, nc, not explicit,
        device=cuda_device,
    )
    md, me = _mus(B, 11, cuda_device)
    before = _build.LAUNCHES["fused_riccati"]
    got = fused_riccati.solve(prob, md, me, explicit)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_riccati"] == before + 1
    ref = fused_riccati.solve_plain(prob, md, me, explicit)
    for a, b in zip(got[:4], ref[:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-9)
    for k in ref[4]:
        torch.testing.assert_close(got[4][k], ref[4][k], rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_fused_riccati_launches_a_shape_outside_the_old_five(cuda_device):
    """(5, 2, 0, -I) had no instance before the kernel was built a shape at
    a time: it launches once and matches the plain version."""
    prob = lqr_problem.random_convex_problem(
        np.random.default_rng(0), 4, 3, 5, 2, 0, device=cuda_device
    )
    before = _build.LAUNCHES["fused_riccati"]
    got = riccati.solve_and_gains(prob, 1e-3, 1e-3, True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_riccati"] == before + 1
    ref = fused_riccati.solve_plain(prob, 1e-3, 1e-3, True)
    for a, b in zip(got[:4], ref[:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 2, 0, False), (4, 1, 1, True)])
def test_fused_riccati_nan_only_in_the_failing_scenario(cuda_device, shape):
    """A scenario whose reduced KKT is indefinite at one stage comes out NaN
    everywhere (the failure reaches every earlier stage and the forward
    sweep); its neighbours in the same block match the plain version."""
    nx, nu, nc, explicit = shape
    B, N = 70, 9
    prob = lqr_problem.random_convex_problem(
        np.random.default_rng(8), B, N, nx, nu, nc, not explicit, device=cuda_device
    )
    prob.knots.R[7, 4] = -1e4 * torch.eye(nu, dtype=torch.float64, device=cuda_device)
    md, me = _mus(B, 12, cuda_device)
    got = fused_riccati.solve(prob, md, me, explicit)
    ref = fused_riccati.solve_plain(prob, md, me, explicit)
    torch.cuda.synchronize()
    ok = torch.arange(B, device=cuda_device) != 7
    for a, b in zip(got[:4], ref[:4]):
        assert torch.isnan(a[7]).all()
        torch.testing.assert_close(a[ok], b[ok], rtol=0, atol=1e-9)
    for k in ("kff", "K"):
        assert torch.isnan(got[4][k][7, :5]).all()
        torch.testing.assert_close(got[4][k][ok], ref[4][k][ok], rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_fused_riccati_step_copies_no_input_on_the_se2_path(cuda_device, monkeypatch):
    """The SE(2) solver's K1 step reads the solver's tensors in place: with
    the wrapper's copy patched to raise, the card solve launches K1 once a
    Newton step."""
    monkeypatch.setattr(fused_riccati, "_copy",
                        lambda t: pytest.fail(f"K1 input copied: {tuple(t.stride())}"))
    prob = create_se2_problem(nsteps=10, dtype=torch.float32, device=cuda_device)
    x0s = prob.x0.expand(64, -1).clone()
    x0s[:, 0] += torch.linspace(-0.2, 0.2, 64, device=cuda_device)
    cfg = at.solvers.ProxDDPConfig(tol=1e-3, mu_init=1e-3, max_iters=2,
                                   max_al_iters=2, ls_strategy="filter")
    before = _build.LAUNCHES["fused_riccati"]
    res = at.solvers.solve(dataclasses.replace(prob, x0=x0s), cfg)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_riccati"] - before == int(res.newton_steps.max()) >= 1
    assert torch.isfinite(res.xs).all()


@pytest.mark.cuda
@pytest.mark.parametrize("u_bound", [None, 0.05])
def test_se2_proxddp_card_matches_cpu(cuda_device, u_bound):
    """The batched solve through the kernel on the card equals the plain
    path on the CPU, float64."""
    rng = np.random.default_rng(2)
    th = 0.15355 + 0.2 * rng.standard_normal(16)
    x0s = np.stack([0.7 + 0.2 * rng.standard_normal(16),
                    -0.1 + 0.2 * rng.standard_normal(16), np.cos(th), np.sin(th)], -1)
    cfg = at.solvers.ProxDDPConfig(tol=1e-3, mu_init=1e-3, max_iters=4,
                                   max_al_iters=4, ls_max_steps=6,
                                   ls_strategy="filter")
    out = {}
    for dev in ("cpu", cuda_device):
        prob = create_se2_problem(nsteps=20, dtype=torch.float64, device=dev,
                                  u_bound=u_bound)
        prob = dataclasses.replace(prob, x0=torch.tensor(x0s, device=dev))
        before = _build.LAUNCHES["fused_riccati"]
        out[dev] = at.solvers.solve(prob, cfg)
        launches = _build.LAUNCHES["fused_riccati"] - before
        assert launches == (0 if dev == "cpu" else int(out[dev].newton_steps.max()))
    cpu, gpu = out["cpu"], out[cuda_device]
    for name in ("num_iters", "al_iter", "conv"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    for name in ("xs", "us", "vs", "lams"):
        torch.testing.assert_close(getattr(gpu, name).cpu(), getattr(cpu, name),
                                   rtol=0, atol=1e-9)


# ---------------------------------------------------------------- K2, K3, K4

# max |kernel - plain| / max(1, max |plain|): float64 sums in another order;
# float32 on well-conditioned systems (eigenvalues of A in [0.1, ~5])
TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


def _rel(got, ref):
    if ref.numel() == 0:
        return 0.0
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()


def _spd_batch(rng, M, n, r, dtype, device):
    G = rng.standard_normal((M, n, n))
    A = G @ G.swapaxes(-1, -2) / n + 0.1 * np.eye(n)
    R = rng.standard_normal((M, n, r))
    return (torch.tensor(A, dtype=dtype, device=device),
            torch.tensor(R, dtype=dtype, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,r", [(56, 57), (22, 57), (12, 1), (64, 64), (28, 84),
                                 (12, 84), (64, 128), (64, 65), (1, 1),
                                 # the parallel-in-time paths: θ sweeps (36, 73),
                                 # (12, 73), (4, 9), (2, 9); the associative
                                 # leaves and gains (1, 5), (2, 3), (4, 5)
                                 (36, 73), (12, 73), (4, 9), (2, 9), (1, 5),
                                 (2, 3), (4, 5),
                                 # past 128 columns: R split over blocks,
                                 # (28, 192) in registers, (64, 257) in
                                 # shared memory
                                 (28, 192), (64, 257)])
def test_spd_solve_matches_plain(cuda_device, dtype, n, r):
    M = 130
    A, R = _spd_batch(np.random.default_rng(n), M, n, r, dtype, cuda_device)
    d = min(3, n - 1)
    A[7, d, d] = -1.0  # not positive definite: NaN in that system only
    before = _build.LAUNCHES["spd_solve"]
    X = spd_solve.spd_solve(A, R)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["spd_solve"] == before + 1
    ref = spd_solve.spd_solve_plain(A, R)
    ok = torch.arange(M, device=cuda_device) != 7
    assert torch.isnan(X[7]).all() and torch.isnan(ref[7]).all()
    assert torch.isfinite(X[ok]).all()
    assert _rel(X[ok], ref[ok]) <= TOL[dtype]


# the kernel's routes: 4 x 4 register tiles up to 256 of them ((28, 84): 196),
# else 4 x 8 ((56, 57): 210; (64, 64): exactly 256), else shared memory
# ((64, 65): 272 tiles of 4 x 8; (64, 128): 384)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,r", [(56, 57), (28, 84), (64, 64), (64, 65), (64, 128)])
def test_spd_solve_reads_only_the_lower_triangle(cuda_device, dtype, n, r):
    A, R = _spd_batch(np.random.default_rng(n + r), 33, n, r, dtype, cuda_device)
    upper = torch.ones(n, n, dtype=torch.bool, device=cuda_device).triu(1)
    garbage = A.masked_fill(upper, float("nan"))
    X = spd_solve.spd_solve(garbage, R)
    ref = spd_solve.spd_solve_plain(A, R)
    assert torch.isfinite(X).all()
    assert _rel(X, ref) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", [1, 16, 257])
@pytest.mark.parametrize("n,r", [(56, 57), (22, 57), (28, 84), (12, 84)])
def test_spd_solve_matches_plain_at_the_path_batches(cuda_device, dtype, M, n, r):
    A, R = _spd_batch(np.random.default_rng(M * n), M, n, r, dtype, cuda_device)
    X = spd_solve.spd_solve(A, R)
    ref = spd_solve.spd_solve_plain(A, R)
    assert X.shape == ref.shape and torch.isfinite(X).all()
    assert _rel(X, ref) <= TOL[dtype]


# below the SM count (56, 57) splits Y's columns over blocks that each
# eliminate W and decide on their own that it is not positive definite
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("n,r", [(56, 57), (22, 57), (28, 84), (12, 84)])
def test_spd_solve_not_positive_definite_at_the_path_batches(cuda_device, dtype, M,
                                                             n, r):
    A, R = _spd_batch(np.random.default_rng(M + n), M, n, r, dtype, cuda_device)
    k, d = min(7, M - 1), 3
    A[k, d, d] = -1.0  # not positive definite: NaN in that system only
    X = spd_solve.spd_solve(A, R)
    ref = spd_solve.spd_solve_plain(A, R)
    ok = torch.arange(M, device=cuda_device) != k
    assert torch.isnan(X[k]).all() and torch.isnan(ref[k]).all()
    assert torch.isfinite(X[ok]).all()
    assert _rel(X[ok], ref[ok]) <= TOL[dtype]


@pytest.mark.cuda
def test_spd_solve_rejects_oversized_systems(cuda_device):
    """No system is too large: n = 65 (past the register tiles, once the
    kernel's bound) and r = 129 (split over blocks) both solve."""
    A, R = _spd_batch(np.random.default_rng(0), 2, 65, 3, torch.float64, cuda_device)
    assert _rel(spd_solve.spd_solve(A, R), spd_solve.spd_solve_plain(A, R)) <= TOL[A.dtype]
    A, R = _spd_batch(np.random.default_rng(0), 2, 12, 129, torch.float64, cuda_device)
    assert _rel(spd_solve.spd_solve(A, R), spd_solve.spd_solve_plain(A, R)) <= TOL[A.dtype]


# past n = 64 K2 takes its memory routes: [W | Y] in shared memory, the
# column groups narrowed to fit (n = 65 .. 128 in fp64, .. 200 in fp32),
# else in a global workspace (n = 200 in fp64, 320); a failing system NaN
# alone; forward error to 1e-9 (fp64) or 1e-3 (fp32) and backward error
# within 10x the plain Cholesky solve's
LARGE_N = [65, 96, 128, 200, 320]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", LARGE_N)
@pytest.mark.parametrize("rk", ["1", "n+1", "3n"])
def test_spd_solve_past_n_64_matches_plain(cuda_device, dtype, n, rk):
    r = {"1": 1, "n+1": n + 1, "3n": 3 * n}[rk]
    M = 5
    A, R = _spd_batch(np.random.default_rng(n + r), M, n, r, dtype, cuda_device)
    A[2, 5, 5] = -1.0  # not positive definite: NaN in that system only
    before = _build.LAUNCHES["spd_solve"]
    X = spd_solve.spd_solve(A, R)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["spd_solve"] == before + 1
    ref = spd_solve.spd_solve_plain(A, R)
    ok = torch.arange(M, device=cuda_device) != 2
    assert torch.isnan(X[2]).all()
    assert torch.isfinite(X[ok]).all()
    assert _rel(X[ok], ref[ok]) <= {torch.float64: 1e-9, torch.float32: 1e-3}[dtype]
    e = _backward_errors(A[ok], X[ok], R[ok]).max().item()
    ep = _backward_errors(A[ok], ref[ok], R[ok]).max().item()
    assert e <= 10 * ep, (e, ep)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,digits", [(torch.float32, 5), (torch.float64, 10)])
@pytest.mark.parametrize("n", LARGE_N)
@pytest.mark.parametrize("rk", ["1", "n+1", "3n"])
def test_spd_solve_past_n_64_is_backward_stable(cuda_device, dtype, digits, n, rk):
    r = {"1": 1, "n+1": n + 1, "3n": 3 * n}[rk]
    _check_backward_stable(cuda_device, 4, n, r, dtype, digits)


@pytest.mark.cuda
def test_spd_solve_diff_past_n_64_matches_plain(cuda_device):
    """spd_solve_diff at n = 96 on the card: forward-mode tangents (one
    launch for all directions) and reverse mode against torch.func through
    the plain Cholesky solve, fp64, to 1e-10 relative."""
    from aligator_tpu_torch._linalg import chol_solve

    g = torch.Generator(device=cuda_device).manual_seed(35)
    K, n, r = 6, 96, 5
    P = torch.randn((K, n, n), generator=g, device=cuda_device, dtype=torch.float64)
    R = torch.randn((K, n, r), generator=g, device=cuda_device, dtype=torch.float64)
    d = torch.randn((8, n, n), generator=g, device=cuda_device, dtype=torch.float64)

    def f(solve):
        def fn(z):
            L = P + torch.einsum("i,ijk->jk", z, d)
            return solve(L @ L.mT + n * torch.eye(n, dtype=L.dtype, device=L.device),
                         R * (1 + z.sum()))
        return fn

    z = torch.zeros(8, dtype=torch.float64, device=cuda_device)
    before = _build.LAUNCHES["spd_solve"]
    J = torch.func.jacfwd(f(spd_solve.spd_solve_diff))(z)
    assert _build.LAUNCHES["spd_solve"] - before == 2
    J_ref = torch.func.jacfwd(f(chol_solve))(z)
    torch.testing.assert_close(J, J_ref, rtol=0, atol=1e-10 * J_ref.abs().max().item())
    grads = []
    for solve in (spd_solve.spd_solve_diff, chol_solve):
        Pg, Rg = P.clone().requires_grad_(), R.clone().requires_grad_()
        A = Pg @ Pg.mT + n * torch.eye(n, dtype=P.dtype, device=P.device)
        grads.append(torch.autograd.grad(solve(A, Rg).sin().sum(), (Pg, Rg)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10 * max(1.0, b.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("n,r", [(28, 192), (64, 257)])
def test_spd_solve_wide_right_hand_sides_at_small_batches(cuda_device, dtype, M, n, r):
    """Past 128 columns at fewer systems than SMs (the column split on top
    of the groups of 128), a failing system NaN alone."""
    A, R = _spd_batch(np.random.default_rng(M + r), M, n, r, dtype, cuda_device)
    A[M - 1, 3, 3] = -1.0
    X = spd_solve.spd_solve(A, R)
    ref = spd_solve.spd_solve_plain(A, R)
    assert torch.isnan(X[M - 1]).all()
    assert torch.isfinite(X[:M - 1]).all()
    assert _rel(X[:M - 1], ref[:M - 1]) <= TOL[dtype]


def _backward_errors(A, X, R):
    """Per system, in float64: max|A X − R| / (max|A| max|X| + max|R|)."""
    A, X, R = A.double(), X.double(), R.double()

    def nrm(t):
        return t.abs().flatten(1).amax(1)

    return nrm(A @ X - R) / (nrm(A) * nrm(X) + nrm(R))


# K2 in fp32 at condition 1e5: the LQR-56 loop's shapes (4 x 8 and 4 x 4
# register tiles), the Delassus shape (register route) and the shared-memory
# route; its backward error within 10x the plain Cholesky solve's
@pytest.mark.cuda
@pytest.mark.parametrize("M,n,r", [(256, 56, 57), (256, 22, 57), (4096, 12, 42),
                                   (256, 64, 65)])
def test_spd_solve_fp32_is_backward_stable_on_nearly_singular_systems(cuda_device, M, n, r):
    _check_backward_stable(cuda_device, M, n, r, torch.float32, 5)


# K2 in fp64 at condition 1e10 (a Delassus matrix of redundant contacts at
# mu = 1e-8), which it solves with no refinement step: the Solo's Delassus
# shape and the FFSR loop's Schur shape
@pytest.mark.cuda
@pytest.mark.parametrize("M,n,r", [(4096, 12, 42), (256, 40, 41)])
def test_spd_solve_fp64_is_backward_stable_on_nearly_singular_systems(cuda_device, M, n, r):
    _check_backward_stable(cuda_device, M, n, r, torch.float64, 10)


def _check_backward_stable(cuda_device, M, n, r, dtype, digits):
    """Systems with eigenvalues log-spaced from 1 down to 10^-digits in
    random orthogonal bases: the kernel's backward error within 10x the
    plain Cholesky solve's."""
    rng = np.random.default_rng(n + r)
    Q = np.linalg.qr(rng.standard_normal((M, n, n)))[0]
    A = (Q * np.logspace(0, -digits, n)) @ Q.swapaxes(-1, -2)
    A = torch.tensor(0.5 * (A + A.swapaxes(-1, -2)), dtype=dtype, device=cuda_device)
    R = torch.tensor(rng.standard_normal((M, n, r)), dtype=dtype, device=cuda_device)
    X, Xp = spd_solve.spd_solve(A, R), spd_solve.spd_solve_plain(A, R)
    assert torch.isfinite(X).all() and torch.isfinite(Xp).all()
    e, ep = _backward_errors(A, X, R).max().item(), _backward_errors(A, Xp, R).max().item()
    assert e <= 10 * ep, (e, ep)


def _sweep_inputs(rng, B, N, nx, nu, nc, dtype, device):
    kn = lqr_problem.random_convex_problem(rng, B, N, nx, nu, nc, dtype=dtype,
                                           device=device).knots
    G = rng.standard_normal((B, nx, nx))
    P = G @ G.swapaxes(-1, -2) / nx + np.eye(nx)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    mus = 10 ** rng.uniform(-3, -1, (2, B))
    return kn, t(P), t(rng.standard_normal((B, nx))), t(mus[0]), t(mus[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims", [(6, 13, 4, 3), (4, 16, 5, 0), (5, 36, 12, 12),
                                  (3, 44, 20, 0),
                                  # (N, nx, nu, nc, B): the edges of K3's domain,
                                  # a batch of 1 and one that no tiling divides
                                  (1, 12, 1, 0, 1), (2, 44, 1, 0, 1025),
                                  (3, 36, 12, 12, 1025)])
def test_fused_sweep_matches_plain(cuda_device, dtype, dims):
    _check_sweep(cuda_device, dtype, dims)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,mu", [(torch.float32, 1e-4), (torch.float32, 1e-5),
                                      (torch.float64, 1e-8)])
def test_fused_sweep_is_stable_on_nearly_singular_kkt_systems(cuda_device, dtype, mu):
    """K3 at the humanoid shape with 4 of 12 controls seen by neither the
    dynamics nor the constraints, the controls in a random orthogonal basis
    (a reduced KKT matrix of condition ~4e5, 4e6, 4e9 whose near-null
    directions mix into every pivot block; at mu = 1e-6 in fp32 the plain
    Cholesky itself fails): each stage's Schur and KKT
    backward errors within 10x the plain sweep's (Cholesky), and in fp32
    its gap to the fp64 plain sweep within 10x the fp32 plain sweep's."""
    B, N, nx, nu, nc = 256, 16, 36, 12, 12
    kn = lqr_problem.random_convex_problem(np.random.default_rng(5), B, N, nx, nu, nc,
                                           dtype=dtype, device=cuda_device,
                                           null_controls=4).knots
    P, p = kn.Q[:, N].contiguous(), kn.q[:, N].contiguous()
    m = torch.full((B,), mu, dtype=dtype, device=cuda_device)
    got = fused_stage.sweep(kn, P, p, m, m)
    ref = fused_stage.sweep_plain(kn, P, p, m, m)
    for k in fused_stage.FACTOR_FIELDS:
        assert torch.isfinite(got[k]).all() and torch.isfinite(ref[k]).all(), k
    eb = fused_stage.stage_backward_errors(kn, P, p, m, m, got)
    ebp = fused_stage.stage_backward_errors(kn, P, p, m, m, ref)
    for k in ("schur", "kkt"):
        assert eb[k].max() <= 10 * ebp[k].max(), (k, eb[k].max(), ebp[k].max())
    if dtype == torch.float32:
        ref64 = fused_stage.sweep_plain(kn.map(torch.Tensor.double), P.double(), p.double(),
                                        m.double(), m.double())
        gap = max(_rel(got[k].double(), ref64[k]) for k in fused_stage.FACTOR_FIELDS)
        gap_p = max(_rel(ref[k].double(), ref64[k]) for k in fused_stage.FACTOR_FIELDS)
        assert gap <= 10 * gap_p, (gap, gap_p)


@pytest.mark.cuda
def test_fused_sweep_matches_plain_at_its_most_shared_memory(cuda_device):
    """fp64 at 231,692 bytes of shared memory a block, of the 232,448 a
    block may have (fp32 there is conditioning-limited: the fp32 plain
    version itself is ~1e-3 from fp64)."""
    _check_sweep(cuda_device, torch.float64, (2, 44, 79, 6, 5))


def _check_sweep(cuda_device, dtype, dims):
    N, nx, nu, nc, *rest = dims
    B = rest[0] if rest else 100
    kn, P, p, md, me = _sweep_inputs(np.random.default_rng(nx), B, N, nx, nu,
                                     nc, dtype, cuda_device)
    if B > 3:
        P[3] = -1e4 * torch.eye(nx, dtype=dtype, device=cuda_device)  # Schur fails
    before = _build.LAUNCHES["fused_stage_sweep"]
    got = fused_stage.sweep(kn, P, p, md, me)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_stage_sweep"] == before + 1
    ref = fused_stage.sweep_plain(kn, P, p, md, me)
    ok = torch.arange(B, device=cuda_device) != 3
    for k in fused_stage.FACTOR_FIELDS:
        assert (got[k][:, N] == 0).all(), k
        if B > 3 and got[k][3].numel():
            assert torch.isnan(got[k][3, :N]).all(), k
        assert torch.isfinite(got[k][ok]).all(), k
        assert _rel(got[k][ok], ref[k][ok]) <= 10 * TOL[dtype], k
    one = fused_stage.stage({f: getattr(kn, f)[:, N - 1] for f in fused_stage.STAGE_FIELDS},
                            P, p, md, me)
    for k in fused_stage.FACTOR_FIELDS:
        assert _rel(one[k][ok], ref[k][ok, N - 1]) <= 10 * TOL[dtype], k


@pytest.mark.cuda
def test_fused_sweep_shared_memory_count_matches_the_kernels(cuda_device):
    """The route's count of K3's shared memory (Python) is the launcher's."""
    for nx, nu, nc in ((12, 1, 0), (36, 12, 12), (44, 79, 6), (44, 64, 64),
                       (44, 82, 0), (13, 4, 3)):
        for itemsize in (4, 8):
            assert fused_stage.stage_smem_bytes(nx, nu, nc, itemsize) == \
                fused_stage.stage_smem_bytes_on_card(nx, nu, nc, itemsize)


@pytest.mark.cuda
def test_sweep_past_k3s_shared_memory_takes_the_loop(cuda_device, plain_versions_raise):
    """(44, 64, 64) in fp64 needs more shared memory than a block may have:
    the routed sweep takes the per-stage loop (K2), not K3, and matches the
    plain sweep."""
    N, B = 2, 3
    kn, P, p, md, me = _sweep_inputs(np.random.default_rng(4), B, N, 44, 64, 64,
                                     torch.float64, cuda_device)
    assert not fused_stage.sweep_eligible(44, 64, 64, True, 8)
    ref = riccati.sweep_plain(kn, md, me, True)
    plain_versions_raise()
    before = _launches()
    got = riccati.sweep(kn, md, me, True)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    assert counts == dict(k2=2 * N, k3=0, k4=0, k1=0, k5=0)
    for k in fused_stage.FACTOR_FIELDS:
        assert _rel(got[k], ref[k]) <= TOL[torch.float64], k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,nu,nc", [(36, 12, 12), (56, 22, 0), (13, 4, 3),
                                      # (13, 4, 3) has slices that are not
                                      # 16-byte aligned; the walk's nc = 22;
                                      # nx = 160, a stage larger than K4's
                                      # ring, with nc given as (nc, T, B)
                                      (56, 22, 22), (160, 7, (2, 1, 1)),
                                      (160, 7, (2, 3, 2))])
def test_fused_forward_matches_plain(cuda_device, dtype, nx, nu, nc):
    nc, *rest = nc if isinstance(nc, tuple) else (nc,)
    T, B = rest if rest else (11, 100)
    rng = np.random.default_rng(nx)
    shapes = dict(kff=(nu,), K=(nu, nx), zff=(nc,), Z=(nc, nx), lff=(nx,),
                  L=(nx, nx), yff=(nx,), Afb=(nx, nx))

    def t(a):
        return torch.tensor(a, dtype=dtype, device=cuda_device)

    gains = {k: t(rng.standard_normal((B, T) + s) / np.sqrt(nx))
             for k, s in shapes.items()}
    x0, lam0 = t(rng.standard_normal((B, nx))), t(rng.standard_normal((B, nx)))
    before = _build.LAUNCHES["fused_stage_forward"]
    got = fused_stage.forward(gains, x0, lam0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_stage_forward"] == before + 1
    ref = fused_stage.forward_plain(gains, x0, lam0)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g, r) <= TOL[dtype]


# ---------------------------------------------------------------- K5


def _fd_rows_inputs(robot, K, dtype, device, seed):
    """A robot, its contact configuration and K random instances (q, v, a,
    λ, activity with one contact inactive in every third instance)."""
    rng = np.random.default_rng(seed)
    if robot == "humanoid":
        model = humanoid.make_humanoid(device="cpu")
        q0 = humanoid.half_sitting(model)
        frames, dims, kd = (model.frame_id("left_sole"), model.frame_id("right_sole")), (6, 6), 50.0
    else:
        model = quadruped.make_quadruped(device="cpu")
        q0 = quadruped.standing_configuration(model)
        frames, dims, kd = tuple(model.frame_id(f"foot{k}") for k in range(4)), (3,) * 4, 10.0
    nv = model.nv
    q = model.configuration_space().integrate(
        q0[None], torch.tensor(0.05 * rng.standard_normal((K, nv))))
    act = np.ones((K, len(frames)))
    act[::3, 0] = 0.0

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    ins = (t(q), t(0.2 * rng.standard_normal((K, nv))), t(rng.standard_normal((K, nv))),
           t(50.0 * rng.standard_normal((K, sum(dims)))), t(act))
    return model.to(dtype, device), ins, frames, dims, kd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("robot", ["humanoid", "quadruped"])
@pytest.mark.parametrize("kp", [0.0, 3.0])
def test_fd_rows_matches_plain(cuda_device, dtype, robot, kp):
    model, ins, frames, dims, kd = _fd_rows_inputs(robot, 37, dtype, cuda_device, 5)
    before = _build.LAUNCHES["fd_rows"]
    got = fd_rows.fd_rows(model, *ins, frames, dims, kd=kd, kp=kp, has_prefs=kp != 0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fd_rows"] == before + 1
    ref = fd_rows.fd_rows_plain(model, *ins, frames, dims, kd=kd, kp=kp,
                                has_prefs=kp != 0)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert torch.isfinite(g).all()
        assert _rel(g, r) <= {torch.float64: 1e-9, torch.float32: 1e-3}[dtype]
    # the inactive contact's rows are zero
    assert (got[2][::3, :dims[0]] == 0).all() and (got[3][::3, :dims[0]] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("robot", ["humanoid", "quadruped"])
@pytest.mark.parametrize("K", [1, 5])
def test_fd_rows_matches_plain_with_every_contact_inactive(cuda_device, dtype, robot, K):
    """K = 1, and instances whose contacts are all inactive: their contact
    rows come out zero, as the plain version's do."""
    model, ins, frames, dims, kd = _fd_rows_inputs(robot, K, dtype, cuda_device, 7)
    act = ins[4].clone()
    act[::2] = 0.0  # instances 0, 2, 4: no contact active
    got = fd_rows.fd_rows(model, *ins[:4], act, frames, dims, kd=kd)
    ref = fd_rows.fd_rows_plain(model, *ins[:4], act, frames, dims, kd=kd)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.isfinite(g).all()
        assert _rel(g, r) <= {torch.float64: 1e-9, torch.float32: 1e-3}[dtype]
    assert (got[2][::2] == 0).all() and (got[3][::2] == 0).all()


@pytest.mark.cuda
def test_fd_rows_rejects_what_it_does_not_take(cuda_device):
    model, ins, frames, dims, kd = _fd_rows_inputs("quadruped", 4, torch.float64,
                                                   cuda_device, 6)
    with pytest.raises(ValueError, match="of dim 3 or 6"):
        fd_rows.fd_rows(model, *ins[:3], ins[3][:, :8], ins[4][:, :2], frames[:2],
                        (4, 4), kd=kd)
    # 17 contacts, past the old cap of 16: taken, and equal to the plain rows
    lam, act = ins[3][:, :1].expand(4, 51), ins[4][:, :1].expand(4, 17)
    got = fd_rows.fd_rows(model, *ins[:3], lam, act, frames[:1] * 17, (3,) * 17, kd=kd)
    ref = fd_rows.fd_rows_plain(model, *ins[:3], lam, act, frames[:1] * 17, (3,) * 17, kd=kd)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-9


def _many_contact_chain(n_rev):
    """A free-flyer chain of ``n_rev`` revolute joints with a frame at the
    end of every body, and contacts on bodies 1..n_rev: all 3D but the
    last, which is 6D."""
    from aligator_tpu_torch.modelling.multibody import robots

    model = robots.make_chain(n_rev, True, device="cpu", frame_stride=1)
    return model, tuple(range(1, n_rev + 1)), (3,) * (n_rev - 1) + (6,)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ncont", [20, 40])
def test_fd_rows_past_sixteen_contacts_matches_plain(cuda_device, dtype, ncont):
    """K5 at 20 and 40 contacts (one 6D), past the old cap of 16: one
    launch, against the plain rows at the tolerances of
    test_fd_rows_matches_plain; an inactive contact's rows are zero."""
    model, frames, dims = _many_contact_chain(ncont)
    rng = np.random.default_rng(ncont)
    K, nv, nc = 33, model.nv, sum(dims)
    q = model.configuration_space().integrate(
        model.neutral()[None], torch.tensor(0.3 * rng.standard_normal((K, nv))))
    act = np.ones((K, ncont))
    act[::3, 5] = 0.0

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda_device)

    ins = (t(q), t(0.2 * rng.standard_normal((K, nv))), t(rng.standard_normal((K, nv))),
           t(5.0 * rng.standard_normal((K, nc))), t(act))
    model = model.to(dtype, cuda_device)
    before = _build.LAUNCHES["fd_rows"]
    got = fd_rows.fd_rows(model, *ins, frames, dims, kd=10.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fd_rows"] == before + 1
    ref = fd_rows.fd_rows_plain(model, *ins, frames, dims, kd=10.0)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert torch.isfinite(g).all()
        assert _rel(g, r) <= {torch.float64: 1e-9, torch.float32: 1e-3}[dtype]
    assert (got[2][::3, 15:18] == 0).all() and (got[3][::3, 15:18] == 0).all()


def _chain(n_rev, free_flyer, device):
    from aligator_tpu_torch.modelling.multibody import robots
    return robots.make_chain(n_rev, free_flyer, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fd_rows_past_the_old_caps_matches_plain(cuda_device, dtype):
    """K5 on a free-flyer chain with nv = 70 (nb = 65) and ten 3D contacts:
    its working set past shared memory takes the global workspace; against
    the plain rows at the tolerances of test_fd_rows_matches_plain."""
    model = _chain(64, True, "cpu")
    assert model.nv == 70 and model.njoints == 65
    rng = np.random.default_rng(8)
    K, nv = 9, model.nv
    frames = tuple(model.frame_id(f"f{b}") for b in range(3, 43, 4))
    assert len(frames) == 10
    q = model.configuration_space().integrate(
        model.neutral()[None], torch.tensor(0.1 * rng.standard_normal((K, nv))))
    act = np.ones((K, 10))
    act[::3, 0] = 0.0

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda_device)

    ins = (t(q), t(0.2 * rng.standard_normal((K, nv))), t(rng.standard_normal((K, nv))),
           t(10.0 * rng.standard_normal((K, 30))), t(act))
    model = model.to(dtype, cuda_device)
    before = _build.LAUNCHES["fd_rows"]
    got = fd_rows.fd_rows(model, *ins, frames, (3,) * 10, kd=10.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fd_rows"] == before + 1
    ref = fd_rows.fd_rows_plain(model, *ins, frames, (3,) * 10, kd=10.0)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert torch.isfinite(g).all()
        assert _rel(g, r) <= {torch.float64: 1e-9, torch.float32: 1e-3}[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 300])
def test_free_fd_past_the_old_caps_matches_plain(cuda_device, B):
    """The free-dynamics kernel on a fixed-base chain of 40 revolute joints
    (past the register route's 16 joints and 24 dofs: the global
    workspace), and on a free-flyer chain of 65 joints and 70 dofs, against
    model.aba to 1e-12 relative to the output's scale, the tolerance of
    test_free_fd_matches_plain, or to 100 times the distance between
    model.aba at q and at q·(1 ± 1e-15), whichever is larger: the long
    chains' mass matrices (condition ~1e6 and more) magnify the rounding
    of two orders of summation past 1e-12, as the free paths' solves are
    held to their one-ulp spread."""
    rng = np.random.default_rng(40)
    for m in (_chain(40, False, cuda_device), _chain(64, True, cuda_device)):
        dq, v, tau = (torch.tensor(rng.standard_normal((B, m.nv)), device=cuda_device)
                      for _ in range(3))
        q = m.configuration_space().integrate(m.neutral()[None], 0.5 * dq)
        before = _build.LAUNCHES["free_fd"]
        got = free_fd.free_fd(m, q, v, tau)
        assert _build.LAUNCHES["free_fd"] == before + 1
        ref = rbd.aba(m, q, v, tau)
        spread = max((rbd.aba(m, q * s, v, tau) - ref).abs().max().item()
                     for s in (1.0 + 1e-15, 1.0 - 1e-15))
        scale = max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() <= max(1e-12 * scale, 100 * spread)


@pytest.mark.cuda
def test_free_fd_far_from_the_origin_matches_plain(cuda_device):
    """The FFSR's exploding-trial states (the base at |q| ~ 5e9 m, where a
    line search's trial rollout took it): the kernel and its plain version,
    model.aba, both at the first joint, agree to 1e-9 relative (at the world
    origin the plain version's spatial inertias cancelled to garbage)."""
    from aligator_tpu_torch.modelling.multibody import robots

    m = robots.make_dual_arm_ffsr(device=cuda_device)
    rng = np.random.default_rng(41)
    B = 64
    dq, v, tau = (torch.tensor(rng.standard_normal((B, m.nv)), device=cuda_device)
                  for _ in range(3))
    q = m.configuration_space().integrate(m.neutral()[None], 0.5 * dq)
    q[:, :3] += torch.tensor(5e9 * rng.choice([-1.0, 1.0], (B, 3)), device=cuda_device)
    got, ref = free_fd.free_fd(m, q, v, tau), free_fd.free_fd_plain(m, q, v, tau)
    assert torch.isfinite(got).all() and torch.isfinite(ref).all()
    assert _rel(got, ref) <= 1e-9


# ---------------------------------------------------------------- slices


@pytest.fixture
def plain_versions_raise(monkeypatch):
    """Patch every plain version to raise: a card solve must not reach one."""
    def install():
        for mod, name in PLAIN_VERSIONS:
            def boom(*args, _name=name, **kwargs):
                raise AssertionError(f"{_name} reached on the card")
            monkeypatch.setattr(mod, name, boom)
    return install


PLAIN_VERSIONS = (
    (spd_solve, "spd_solve_plain"), (fused_stage, "sweep_plain"),
    (fused_stage, "stage_plain"), (fused_stage, "forward_plain"),
    (riccati, "backward_plain"), (riccati, "forward_plain"),
    (fused_riccati, "solve_plain"), (fd_rows, "fd_rows_plain"),
    (free_fd, "free_fd_plain"),
)


def _launches():
    return dict(k2=_build.LAUNCHES["spd_solve"], k3=_build.LAUNCHES["fused_stage_sweep"],
                k4=_build.LAUNCHES["fused_stage_forward"], k1=_build.LAUNCHES["fused_riccati"],
                k5=_build.LAUNCHES["fd_rows"])


def _card_and_cpu(make, solve, cuda_device, plain_versions_raise):
    cpu = solve(make("cpu"))
    plain_versions_raise()
    before = _launches()
    gpu = solve(make(cuda_device))
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    for name in ("num_iters", "conv"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    for name in ("xs", "us"):
        torch.testing.assert_close(getattr(gpu, name).cpu(), getattr(cpu, name),
                                   rtol=0, atol=1e-9)
    return gpu, counts


@pytest.mark.cuda
def test_humanoid_proxddp_card_matches_cpu(cuda_device, plain_versions_raise):
    rng = np.random.default_rng(3)
    x0s = rng.standard_normal((8, 36)) * 0.1
    x0s[:, 0] += 0.5

    def make(dev):
        prob = medium_dims.make_humanoid_dims_problem(12, torch.float64, dev)
        return dataclasses.replace(prob, x0=torch.tensor(x0s, device=dev))

    cfg = at.solvers.ProxDDPConfig(tol=1e-3, mu_init=1e-3, max_iters=4,
                                   max_al_iters=4, ls_max_steps=6)
    gpu, counts = _card_and_cpu(make, lambda p: at.solvers.solve(p, cfg),
                                cuda_device, plain_versions_raise)
    steps = int(gpu.newton_steps.max())
    assert counts == dict(k2=0, k3=steps, k4=steps, k1=0, k5=0)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["proxddp", "fddp"])
def test_dense_lqr_card_matches_cpu(cuda_device, plain_versions_raise, solver):
    N = 10
    x0s = 1.0 + 0.1 * np.random.default_rng(7).standard_normal((6, 56))

    def make(dev):
        prob = medium_dims.make_dense_lqr(56, 22, N, torch.float64, dev)
        return dataclasses.replace(prob, x0=torch.tensor(x0s, device=dev))

    if solver == "proxddp":
        cfg = at.solvers.ProxDDPConfig(tol=1e-7, mu_init=1e-9, max_iters=2)
        gpu, counts = _card_and_cpu(make, lambda p: at.solvers.solve(p, cfg),
                                    cuda_device, plain_versions_raise)
        steps = int(gpu.newton_steps.max())
        assert counts == dict(k2=2 * N * steps, k3=0, k4=steps, k1=0, k5=0)
    else:
        cfg = at.solvers.FDDPConfig(tol=1e-7, max_iters=2)
        gpu, counts = _card_and_cpu(make, lambda p: at.solvers.fddp.solve(p, cfg),
                                    cuda_device, plain_versions_raise)
        iters = int(gpu.num_iters.max())
        assert counts == dict(k2=N * (iters + 1), k3=0, k4=0, k1=0, k5=0)


@pytest.mark.cuda
def _theta_problem(rng, B, N, nx, nu, nc, device):
    """Random LQ problems with θ blocks of dimension nx, float64."""
    prob = lqr_problem.random_convex_problem(rng, B, N, nx, nu, nc, device=device)
    kn = lqr_problem.add_parameterization(prob.knots, nx)
    for k in ("Gx", "Gu", "gamma"):
        t = getattr(kn, k)
        t.copy_(torch.tensor(rng.standard_normal(t.shape), device=device))
    kn.Gth.copy_(torch.eye(nx, device=device, dtype=torch.float64).expand_as(kn.Gth))
    return dataclasses.replace(prob, knots=kn)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,nu,nc", [(36, 12, 12), (4, 2, 1)])
def test_theta_sweep_takes_k2_not_k1_or_k3(cuda_device, plain_versions_raise, nx, nu, nc):
    """With θ blocks, the shapes of K3 (36, 12, 12) and K1 (4, 2, 1) take the
    per-stage loop: 2 K2 launches a stage, the θ columns as wider
    right-hand sides, matching the CPU's backward and forward at θ."""
    N, B = 6, 5
    rng = np.random.default_rng(nx)
    prob = _theta_problem(rng, B, N, nx, nu, nc, "cpu")
    theta = torch.tensor(rng.standard_normal((B, nx)))
    cpu = riccati.backward(prob, 1e-3, 1e-2, True)
    cpu_sol = riccati.forward(cpu, theta)
    gprob = _theta_problem(np.random.default_rng(nx), B, N, nx, nu, nc, cuda_device)
    plain_versions_raise()
    before = _launches()
    gpu = riccati.backward(gprob, 1e-3, 1e-2, True)
    gpu_sol = riccati.forward(gpu, theta.to(cuda_device))
    _, *gains = riccati.solve_and_gains(gprob, 1e-3, 1e-2, True)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    k4 = 2 if nx >= 12 else 0
    assert counts == dict(k2=4 * N, k3=0, k4=k4, k1=0, k5=0)
    for k in ("kff", "K", "Kth", "Zth", "Lth", "Yth", "Vxt", "Vtt", "vt", "x0_th",
              "th_grad", "th_hess"):
        assert _rel(getattr(gpu, k).cpu(), getattr(cpu, k)) <= TOL[torch.float64], k
    for g, c in zip(gpu_sol, cpu_sol):
        assert _rel(g.cpu(), c) <= TOL[torch.float64]


@pytest.mark.cuda
@pytest.mark.parametrize("N,legs", [(11, 4), (12, 3)])  # T = 12: 3 each; T = 13: 5, 4, 4
def test_parallel_proxddp_card_matches_cpu(cuda_device, plain_versions_raise, N, legs):
    """linear_solver='parallel' at humanoid dims, float64: the legs' θ sweeps
    take K2 (2 launches a stage of a leg group), their forwards K4 (one a
    group), never K1 or K3; the card matches the CPU."""
    rng = np.random.default_rng(3)
    x0s = rng.standard_normal((8, 36)) * 0.1
    x0s[:, 0] += 0.5

    def make(dev):
        prob = medium_dims.make_humanoid_dims_problem(N, torch.float64, dev)
        return dataclasses.replace(prob, x0=torch.tensor(x0s, device=dev))

    cfg = at.solvers.ProxDDPConfig(tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4,
                                   ls_max_steps=6, linear_solver="parallel",
                                   parallel_legs=legs)
    gpu, counts = _card_and_cpu(make, lambda p: at.solvers.solve(p, cfg),
                                cuda_device, plain_versions_raise)
    steps = int(gpu.newton_steps.max())
    _, lens = at.gar.parallel.get_work(N + 1, legs)
    groups = sorted(set(lens))
    assert counts == dict(k2=steps * sum(2 * (L - 1) for L in groups), k3=0,
                          k4=steps * len(groups), k1=0, k5=0)


@pytest.mark.cuda
def test_associative_proxddp_card_matches_cpu(cuda_device, plain_versions_raise):
    """linear_solver='associative' on the LQR with a control bound, float64:
    every Newton step on the scan (μ above the floor), 3 K2 launches a solve
    (the leaves' R̄ solve, the gain recovery's two) and one refinement solve
    more; the card matches the CPU."""
    x0s = np.array([1.0, 0.0]) + 0.1 * np.random.default_rng(11).standard_normal((16, 2))

    def make(dev):
        prob = make_lqr_problem(24, torch.float64, u_bound=1.0, device=dev)
        return dataclasses.replace(prob, x0=torch.tensor(x0s, device=dev))

    cfg = at.solvers.ProxDDPConfig(tol=1e-6, mu_init=1e-2, max_iters=20,
                                   linear_solver="associative")
    steps_before = int(at.solvers.proxddp.ROUTE_STEPS["associative"])
    gpu, counts = _card_and_cpu(make, lambda p: at.solvers.solve(p, cfg),
                                cuda_device, plain_versions_raise)
    steps = int(gpu.newton_steps.max())
    assert counts == dict(k2=6 * steps, k3=0, k4=0, k1=0, k5=0)
    assert int(at.solvers.proxddp.ROUTE_STEPS["associative"]) > steps_before
    assert gpu.conv.all() and (gpu.vs != 0).any()


@pytest.mark.cuda
def test_talos_walk_card_matches_cpu_and_jax_fixture(cuda_device, plain_versions_raise):
    """The whole-body slice at N = 7, float64: the card solve (K5, K2 and K4,
    with every plain version patched to raise) against the CPU solve and the
    JAX package's solve stored in tests/data/torch_talos_ref.npz."""
    import json
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "data" / "torch_talos_ref.npz"
    with np.load(path) as f:
        fix = {k: f[k] for k in f.files}
    cfg = at.solvers.ProxDDPConfig(**json.loads(str(fix["config"])))
    cpu = at.solvers.solve(convert.talos_problem_from_numpy(fix, device="cpu"), cfg)
    plain_versions_raise()
    before = _launches()
    gpu = at.solvers.solve(convert.talos_problem_from_numpy(fix, device=cuda_device), cfg)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    N = int(fix["nsteps"])
    loops = int(gpu.num_iters.max())
    steps = int(gpu.newton_steps.max())
    # K5 and the two contact-KKT solves once per derivative evaluation (each
    # outer iteration and the final refresh), 2N K2 solves and one K4
    # forward sweep per Newton step
    assert counts == dict(k5=loops + 1, k2=2 * (loops + 1) + 2 * N * steps,
                          k4=steps, k1=0, k3=0)
    for k in ("num_iters", "al_iter", "conv"):
        assert np.array_equal(getattr(gpu, k).cpu().numpy(), fix[f"res_{k}"]), k
        assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)), k
    for k in ("xs", "us", "lams"):
        got = getattr(gpu, k).cpu()
        assert _rel(got, getattr(cpu, k)) < 1e-8, k
        assert _rel(got, torch.tensor(fix[f"res_{k}"])) < 1e-8, k


# ------------------------------------------- nonlinear rollout, gradients, θ


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rk2", "midpoint", "midpoint_conv", "exact"])
def test_cartpole_nonlinear_rollout_card_matches_cpu(cuda_device, plain_versions_raise,
                                                     case):
    """ProxDDP with rollout='nonlinear' on the cartpole (N = 20, 6 scenarios,
    float64): RK2 (K1 with E = -I) to convergence, the implicit midpoint
    rule (K1 with general E) for 4 iterations and, with two Newton steps a
    stage in the rollout, to convergence, and 'exact' Hessians; one K1
    launch a Newton step; every trial on the card a CUDA-graph replay."""
    from aligator_tpu_torch.solvers.proxddp import TrialGraphWarning

    x0s = 0.1 * np.random.default_rng(0).standard_normal((6, 4))
    integrator = "midpoint" if case.startswith("midpoint") else "rk2"
    opts = dict(tol=1e-5, mu_init=0.01, max_iters=300, rollout="nonlinear")
    opts.update({"midpoint": dict(max_iters=4),
                 "midpoint_conv": dict(rollout_max_iters=2),
                 "exact": dict(hessian_approx="exact", max_iters=12)}.get(case, {}))
    cfg = at.solvers.ProxDDPConfig(**opts)

    def make(dev):
        prob = create_cartpole_problem(nsteps=20, device=dev, integrator=integrator)
        return dataclasses.replace(prob, x0=torch.tensor(x0s, device=dev))

    with warnings.catch_warnings():
        warnings.simplefilter("error", TrialGraphWarning)
        gpu, counts = _card_and_cpu(make, lambda p: at.solvers.solve(p, cfg),
                                    cuda_device, plain_versions_raise)
    assert counts == dict(k2=0, k3=0, k4=0, k1=int(gpu.newton_steps.max()), k5=0)
    if case in ("rk2", "midpoint_conv"):
        assert bool(gpu.conv.all())


@pytest.mark.cuda
@pytest.mark.parametrize("nx,nu,nc", [(4, 2, 1), (16, 4, 2)])
def test_diff_solve_gradients_card_match_cpu(cuda_device, plain_versions_raise, nx, nu, nc):
    """The autograd Function's gradients on the card equal the CPU's: the
    forward and adjoint solves take the per-stage loop (2 K2 launches a
    stage each) at nx = 4, K3 and K4 (one launch each a solve) at nx = 16."""
    N, B = 7, 5
    grads = {}
    for dev in ("cpu", cuda_device):
        prob = lqr_problem.random_convex_problem(np.random.default_rng(nx), B, N, nx, nu,
                                                 nc, device=dev)
        leaves = [getattr(prob.knots, k) for k in diff.KNOT_FIELDS] + [prob.G0, prob.g0]
        for t in leaves:
            t.requires_grad_()
        if dev != "cpu":
            plain_versions_raise()
            before = _launches()
        xs, us, vs, lams = diff.solve(prob, 1e-3, 1e-2, True)
        ((us ** 2).sum() + (xs[:, -1] ** 2).sum() + (vs ** 2).sum()
         + (lams ** 3).sum()).backward()
        grads[dev] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    if nx >= 12:
        assert counts == dict(k2=0, k3=2, k4=2, k1=0, k5=0)
    else:
        assert counts == dict(k2=2 * 2 * N, k3=0, k4=0, k1=0, k5=0)
    for g, c in zip(grads[cuda_device], grads["cpu"]):
        assert _rel(g.cpu(), c) <= TOL[torch.float64]


@pytest.mark.cuda
def test_inverse_lqr_steps_card_match_cpu(cuda_device, plain_versions_raise):
    """Five Adam steps of the inverse-LQR example on the card and on the
    CPU (N = 10, 4 demonstrations); 4N K2 launches a step."""
    x0s = np.random.default_rng(5).standard_normal((4, 4))
    out = {}
    for dev in ("cpu", cuda_device):
        template = inverse_lqr.make_problem_template(N=10, device=dev)
        if dev != "cpu":
            plain_versions_raise()
            before = _launches()
        out[dev] = inverse_lqr.fit(template, torch.tensor(x0s, device=dev), steps=5)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    # the expert's solve, then per step the forward and adjoint solves, and
    # the final loss
    assert counts == dict(k2=2 * 10 * (1 + 2 * 5 + 1), k3=0, k4=0, k1=0, k5=0)
    for g, c in zip(out[cuda_device], out["cpu"]):
        assert _rel(g.cpu(), c) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("u_bound", [None, 0.12])
def test_theta_sensitivities_card_match_cpu(cuda_device, plain_versions_raise, u_bound):
    """solve_with_sensitivities on the θ family: the solve on K1, the θ
    backward on the per-stage loop (2 K2 launches a stage)."""
    thetas = np.random.default_rng(13).standard_normal((8, 2)) * 0.4
    opts = (theta_family.SOLVE_OPTIONS if u_bound is None
            else dict(tol=1e-8, mu_init=1e-2, max_iters=300))
    cfg = at.solvers.ProxDDPConfig(**opts)
    out = {}
    for dev in ("cpu", cuda_device):
        pf = theta_family.make_double_integrator_family(device=dev, u_bound=u_bound)
        if dev != "cpu":
            plain_versions_raise()
            before = _launches()
        out[dev] = at.solvers.solve_with_sensitivities(
            pf, torch.tensor(thetas, device=dev), cfg)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    gpu, cpu = out[cuda_device], out["cpu"]
    assert counts == dict(k2=2 * 20, k3=0, k4=0, k1=int(gpu.newton_steps.max()), k5=0)
    assert torch.equal(gpu.num_iters.cpu(), cpu.num_iters)
    for k in ("xs", "us", "th_grad", "th_hess"):
        assert _rel(getattr(gpu, k).cpu(), getattr(cpu, k)) <= TOL[torch.float64], k


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["rk2", "midpoint"])
def test_nonlinear_trial_graph_matches_eager(cuda_device, integrator):
    """The CUDA-graph replay of a nonlinear line-search trial equals the
    eager trial, for inputs and step lengths that change between replays,
    with explicit dynamics and with the implicit midpoint rule (two Newton
    steps a stage: autograd Jacobians and dense solves in the capture)."""
    from types import SimpleNamespace

    from aligator_tpu_torch.solvers import proxddp

    B, N = 5, 12
    prob = create_cartpole_problem(nsteps=N, device=cuda_device, integrator=integrator)
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), device=cuda_device)

    prob = dataclasses.replace(prob, x0=0.1 * t(B, 4))
    cfg = at.solvers.ProxDDPConfig(rollout="nonlinear", rollout_max_iters=2)
    graph = proxddp._TrialGraph()
    for _ in range(3):
        st = SimpleNamespace(xs=0.1 * t(B, N + 1, 4), us=t(B, N, 1), vs=t(B, N, 1),
                             vs_term=t(B, 0), lams=t(B, N + 1, 4),
                             prev_lams=t(B, N + 1, 4), prev_vs=t(B, N, 1),
                             prev_vs_term=t(B, 0), mu=0.01 + 0.01 * t(B).abs())
        gains = dict(kff=t(B, N + 1, 1), K=0.1 * t(B, N + 1, 1, 4), zff=t(B, N + 1, 1),
                     Z=t(B, N + 1, 1, 4), lff=t(B, N + 1, 4), L=0.1 * t(B, N + 1, 4, 4))
        args = (st, gains, 0.1 * t(B, 4), t(B, 4), torch.rand(B, device=cuda_device,
                                                              dtype=torch.float64))
        ins = {k: getattr(st, k) for k in proxddp._TRIAL_STATE}
        ins.update({f"gain_{k}": v for k, v in gains.items()}, dx0=args[2], dlam0=args[3],
                   alpha=args[4])
        got = graph(prob, cfg, ins)
        ref = proxddp._nonlinear_trial(prob, cfg, *args)
        for a, b in zip((*got[0], *got[1:]), (*ref[0], *ref[1:])):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    assert graph.graph is not None and not graph.eager


@pytest.mark.cuda
def test_linear_trial_graph_matches_eager(cuda_device):
    """The CUDA-graph replay of a linear line-search trial (the step, the
    problem's evaluation with its K2 launches, multipliers, merit) equals
    the eager trial on the UR10 throw, for inputs and step lengths that
    change between replays; each replay adds the launches its capture
    recorded."""
    from types import SimpleNamespace

    from aligator_tpu_torch.examples import ur10_ballistic
    from aligator_tpu_torch.solvers import proxddp

    B, N = 3, 6
    prob = ur10_ballistic.create_ur10_ballistic_problem(N, 0.025, device=cuda_device)[0]
    prob = dataclasses.replace(prob, x0=prob.x0.expand(B, -1).clone())
    xs, us = ur10_ballistic.warm_start(prob)
    rng = np.random.default_rng(2)
    nx, ndx, nu, nc = 25, 24, 6, prob.nc

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), device=cuda_device)

    cfg = at.solvers.ProxDDPConfig(**ur10_ballistic.SOLVE_OPTIONS)
    graph = proxddp._TrialGraph()
    for i in range(3):
        st = SimpleNamespace(xs=xs, us=us + 0.1 * t(B, N, nu), vs=t(B, N, nc),
                             vs_term=t(B, prob.nc_term), lams=t(B, N + 1, ndx),
                             prev_lams=t(B, N + 1, ndx), prev_vs=t(B, N, nc),
                             prev_vs_term=t(B, prob.nc_term), mu=0.01 + 0.01 * t(B).abs())
        steps = (0.01 * t(B, N + 1, ndx), t(B, N, nu), t(B, N, nc), t(B, prob.nc_term),
                 t(B, N + 1, ndx))
        alpha = torch.rand(B, device=cuda_device, dtype=torch.float64)
        before = _build.LAUNCHES["spd_solve"]
        got = graph(prob, cfg, proxddp._trial_inputs(cfg, st, {}, steps, alpha))
        # the evaluation's dynamics: two K2 launches (the warm-up's too at
        # the capture)
        assert _build.LAUNCHES["spd_solve"] - before == (4 if i == 0 else 2)
        ref = proxddp._linear_trial(prob, cfg, st, steps, alpha)
        for a, b in zip((*got[0], *got[1:]), (*ref[0], *ref[1:])):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-12 * max(1.0, b.abs().max().item()))
    assert graph.graph is not None and not graph.eager


@pytest.mark.cuda
@pytest.mark.parametrize("explicit", [True, False])
def test_sweep_graph_matches_eager(cuda_device, explicit):
    """The CUDA-graph replay of the per-stage Riccati loop (K2) equals the
    eager loop for knots that change between calls, with explicit and with
    general E; every call counts K2 twice a stage, replayed or not."""
    N, nx, nu, nc = 7, 14, 4, 3
    graph = riccati.SweepGraph()
    for i in range(3):
        prob = lqr_problem.random_convex_problem(np.random.default_rng(40 + i), 6, N, nx, nu,
                                                 nc, not explicit, torch.float64, cuda_device)
        kn = prob.knots
        mudyn, mueq = _mus(6, 41 + i, cuda_device)
        term = riccati._terminal_solve(kn, mueq[:, None, None])
        before = _build.LAUNCHES["spd_solve"]
        got = graph(kn, term, mudyn, mueq, explicit)
        assert _build.LAUNCHES["spd_solve"] - before == 2 * N
        ref = riccati._sweep_loop(kn, term, mudyn, mueq, explicit, spd_solve.spd_solve)
        for k in ref:
            torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)
    assert graph.graph is not None and not graph.eager


def _free_model(name, dev):
    from aligator_tpu_torch.modelling.multibody import robots
    return getattr(robots, name)(device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["make_ur5", "make_dual_arm_ffsr"])
def test_aba_and_derivatives_card_match_cpu(cuda_device, name):
    """aba (with external forces) and aba_derivatives on the card equal the
    CPU's to 1e-10 relative to each output's scale (torch Cholesky and
    triangular solves on both, no kernel)."""
    from aligator_tpu_torch.modelling.multibody import derivatives

    rng = np.random.default_rng(31)
    m = _free_model(name, "cpu")
    dq, v, tau = (rng.standard_normal((64, m.nv)) for _ in range(3))
    fx = rng.standard_normal((64, m.njoints, 6))
    out = {}
    for dev in ("cpu", cuda_device):
        m = _free_model(name, dev)
        dq_t, v_t, tau_t, fx_t = (torch.tensor(a, device=dev) for a in (dq, v, tau, fx))
        q = m.configuration_space().integrate(m.neutral()[None], 0.5 * dq_t)
        a, da_dq, da_dv, solve_M = derivatives.aba_derivatives(m, q, v_t, tau_t, fx_t)
        out[dev] = (rbd.aba(m, q, v_t, tau_t), rbd.aba(m, q, v_t, tau_t, fx_t), a, da_dq,
                    da_dv, solve_M(torch.eye(m.nv, dtype=torch.float64, device=dev)))
    for g, c in zip(out[cuda_device], out["cpu"]):
        scale = max(1.0, c.abs().max().item())
        torch.testing.assert_close(g.cpu(), c, rtol=0, atol=1e-10 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ur5", "ffsr"])
def test_free_reach_card_matches_cpu(cuda_device, plain_versions_raise, case):
    """The UR5 reach (N = 10) and the dual-arm FFSR reach (N = 8) with the
    published options, 4 scenarios, 4 iterations, on the card against the
    CPU, each output to 1e-9 relative or to 100 times the largest distance
    between the CPU solve and those from initial states one ulp away,
    x0·(1 ± 1e-15), whichever is larger (these solves magnify any
    difference of rounding; chip_smoke.py holds its free paths alike): K2
    twice a stage and K4 once a Newton step (the per-stage loop), the
    free-dynamics kernel once a stage of each rollout, every nonlinear trial
    a CUDA-graph replay."""
    from aligator_tpu_torch.examples import dual_ffsr_reach, ur5_reach
    from aligator_tpu_torch.solvers.proxddp import TrialGraphWarning

    ex, N = {"ur5": (ur5_reach, 10), "ffsr": (dual_ffsr_reach, 8)}[case]
    create = ex.create_ur5_problem if case == "ur5" else ex.create_ffsr_problem
    rng = np.random.default_rng(32)
    x0 = create(nsteps=N, device="cpu").x0.expand(4, -1).clone()
    arms = slice(0, 6) if case == "ur5" else slice(7, 21)
    x0[:, arms] += torch.tensor((0.1 if case == "ur5" else 0.05)
                                * rng.standard_normal((4, arms.stop - arms.start)))
    cfg = at.solvers.ProxDDPConfig(**{**ex.SOLVE_OPTIONS, "max_iters": 4})

    def make(dev):
        return dataclasses.replace(create(nsteps=N, device=dev), x0=x0.to(dev))

    from aligator_tpu_torch.solvers import proxddp

    cpu = at.solvers.solve(make("cpu"), cfg)
    spread = [at.solvers.solve(dataclasses.replace(make("cpu"), x0=x0 * s), cfg)
              for s in (1.0 + 1e-15, 1.0 - 1e-15)]
    plain_versions_raise()
    before = _launches()
    fd_before, trials_before = _build.LAUNCHES["free_fd"], proxddp.NONLINEAR_TRIALS
    with warnings.catch_warnings():
        warnings.simplefilter("error", TrialGraphWarning)
        gpu = at.solvers.solve(make(cuda_device), cfg)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    for name in ("num_iters", "conv"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    # relative to each output's scale (joint speeds reach ~10^3 on the way)
    for name in ("xs", "us", "lams", "prim_infeas", "dual_infeas"):
        ref = getattr(cpu, name)
        scale = max(1.0, ref.abs().max().item())
        apart = max((getattr(r, name) - ref).abs().max().item() for r in spread) / scale
        gap = (getattr(gpu, name).cpu() - ref).abs().max().item() / scale
        assert gap <= max(1e-9, 100 * apart), (name, gap, apart)
    steps = int(gpu.newton_steps.max())
    assert steps > 0
    assert counts == dict(k2=2 * N * steps, k3=0, k4=steps, k1=0, k5=0)
    # the free-dynamics kernel once a stage of every rollout (each trial and
    # the warm-up before the trial graph's capture) and once a derivative
    # evaluation (each iteration and the final refresh)
    trials = proxddp.NONLINEAR_TRIALS - trials_before
    iters = int(gpu.num_iters.max())
    assert _build.LAUNCHES["free_fd"] - fd_before == N * (trials + 1) + iters + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 300])  # 300: the last block is ragged
@pytest.mark.parametrize("name", ["make_pendulum", "make_double_pendulum", "make_ur5",
                                  "make_panda", "make_dual_arm_ffsr", "make_free_sphere",
                                  "make_ur10_with_payload"])
def test_free_fd_matches_plain(cuda_device, name, B):
    """The free-dynamics kernel against model.aba on the card, fp64, to 1e-12
    relative to the output's scale; leading dims kept; its derivatives
    (reverse mode, and forward mode under vmap) against model.aba's
    autograd to 1e-9; the raw launcher refuses a tensor that takes a
    gradient."""
    rng = np.random.default_rng(33)
    m = _free_model(name, cuda_device)
    dq, v, tau = (torch.tensor(rng.standard_normal((B, m.nv)), device=cuda_device)
                  for _ in range(3))
    q = m.configuration_space().integrate(m.neutral()[None], 0.5 * dq)
    before = _build.LAUNCHES["free_fd"]
    got = free_fd.free_fd(m, q.reshape(1, B, -1), v.reshape(1, B, -1), tau)
    assert _build.LAUNCHES["free_fd"] == before + 1 and got.shape == (1, B, m.nv)
    ref = rbd.aba(m, q, v, tau)
    torch.testing.assert_close(got[0], ref, rtol=0,
                               atol=1e-12 * max(1.0, ref.abs().max().item()))
    # derivatives in tangent coordinates: the analytic ones of the wrapper
    # against autograd through model.aba
    cs = m.configuration_space()
    w = torch.tensor(rng.standard_normal((B, m.nv)), device=cuda_device)
    grads = []
    for fn in (free_fd.free_fd, rbd.aba):
        dx, vv, tt = (t.clone().requires_grad_() for t in (torch.zeros_like(v), v, tau))
        grads.append(torch.autograd.grad((fn(m, cs.integrate(q, dx), vv, tt) * w).sum(),
                                         (dx, vv, tt)))
    jacs = [torch.func.vmap(torch.func.jacfwd(
        lambda d, qq, vv, tt, fn=fn: fn(m, cs.integrate(qq, d), vv, tt)))(
        torch.zeros_like(v), q, v, tau) for fn in (free_fd.free_fd, rbd.aba)]
    for got, ref in zip((*grads[0], jacs[0]), (*grads[1], jacs[1])):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-9 * max(1.0, ref.abs().max().item()))
    with pytest.raises(ValueError, match="values only"):
        free_fd.launch(m, q.requires_grad_(), v, tau)


# ---------------------------------------------------------------- contact dynamics


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
def test_spd_solve_diff_card_matches_autodiff(cuda_device, shared):
    """The differentiable SPD solve on the card: its values, its
    forward-mode tangents under jacfwd (the directions folded into one K2
    launch) and its reverse mode (one more launch) against torch.func
    through the plain Cholesky solve, fp64, to 1e-10 relative; per-system
    A and one A shared by every system."""
    from aligator_tpu_torch._linalg import chol_solve

    g = torch.Generator(device=cuda_device).manual_seed(34)
    K, n, r = 40, 12, 7
    P = torch.randn((1 if shared else K, n, n), generator=g, device=cuda_device,
                    dtype=torch.float64)
    R = torch.randn((K, n, r), generator=g, device=cuda_device, dtype=torch.float64)
    d = torch.randn((30, n, n), generator=g, device=cuda_device, dtype=torch.float64)

    def f(solve):
        def fn(z):
            L = P + torch.einsum("i,ijk->jk", z, d)
            return solve(L @ L.mT + n * torch.eye(n, dtype=L.dtype, device=L.device),
                         R * (1 + z.sum()))
        return fn

    z = torch.zeros(30, dtype=torch.float64, device=cuda_device)
    before = _build.LAUNCHES["spd_solve"]
    J = torch.func.jacfwd(f(spd_solve.spd_solve_diff))(z)
    assert _build.LAUNCHES["spd_solve"] - before == 2
    J_ref = torch.func.jacfwd(f(chol_solve))(z)
    torch.testing.assert_close(J, J_ref, rtol=0, atol=1e-10 * J_ref.abs().max().item())
    grads = []
    for solve in (spd_solve.spd_solve_diff, chol_solve):
        Pg, Rg = P.clone().requires_grad_(), R.clone().requires_grad_()
        A = Pg @ Pg.mT + n * torch.eye(n, dtype=P.dtype, device=P.device)
        before = _build.LAUNCHES["spd_solve"]
        grads.append(torch.autograd.grad(solve(A, Rg).sin().sum(), (Pg, Rg)))
        if solve is spd_solve.spd_solve_diff:
            assert _build.LAUNCHES["spd_solve"] - before == 2
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10 * max(1.0, b.abs().max().item()))
    with pytest.raises(ValueError, match="values only"):
        spd_solve.launch(P.expand(K, n, n).clone().requires_grad_(), R)


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["humanoid", "quadruped"])
def test_contact_residuals_card_match_cpu(cuda_device, robot):
    """The contact force, friction or wrench cone, centre-of-mass and
    gravity-compensation residuals and the loop constraint's
    acc_derivatives, values and Jacobians on CUDA tensors against the CPU,
    fp64, to 1e-9 relative."""
    from aligator_tpu_torch.modelling.multibody import contact, residuals

    rng = np.random.default_rng(35)
    outs = {}
    for dev in ("cpu", cuda_device):
        if robot == "humanoid":
            m = humanoid.make_humanoid(device=dev)
            q0 = humanoid.half_sitting(m)
            frames, dims = (m.frame_id("left_sole"), m.frame_id("right_sole")), (6, 6)
        else:
            m = quadruped.make_quadruped(device=dev)
            q0 = quadruped.standing_configuration(m)
            frames, dims = tuple(m.frame_id(f"foot{k}") for k in range(4)), (3,) * 4
        nu = m.nv - 6
        Bm = torch.zeros(m.nv, nu, dtype=torch.float64, device=dev)
        Bm[6:] = torch.eye(nu, dtype=torch.float64, device=dev)
        r = np.random.default_rng(35)
        dq = torch.tensor(0.1 * r.standard_normal((5, m.nv)), device=dev)
        x = torch.cat([m.configuration_space().integrate(q0[None], dq),
                       torch.tensor(r.standard_normal((5, m.nv)), device=dev)], -1)
        u = torch.tensor(r.standard_normal((5, nu)), device=dev)
        one = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        # the quadruped's 4 point feet make the Delassus matrix
        # rank-deficient: its forces are conditioning-limited at μ = 1e-8
        # (Cholesky orders part by ~1e-7), so it is compared at μ = 1e-5
        common = dict(model=m, actuation=Bm, active=one([1.0] * len(frames)),
                      contact_frames=frames, contact_dims=dims, contact_id=1,
                      prox_mu=1e-5 if robot == "quadruped" else 1e-8)
        fns = [contact.ContactForceResidual(f_ref=one(list(range(dims[1]))), **common),
               residuals.CenterOfMassTranslationResidual(model=m, p_ref=one([0.0, 0.1, 0.3])),
               residuals.CenterOfMassVelocityResidual(model=m, v_ref=one([0.1, 0.0, 0.0])),
               residuals.GravityCompensationResidual(model=m, actuation=Bm)]
        if dims[1] == 3:
            fns.append(contact.MultibodyFrictionConeResidual(mu_friction=one(0.7), **common))
        else:
            fns.append(contact.MultibodyWrenchConeResidual(
                mu_friction=one(0.7), half_length=one(0.1), half_width=one(0.05), **common))
        sp = m.phase_space()
        outs[dev] = [(f.value(sp, x, u), *f.jacobians(sp, x, u)) for f in fns]
    del rng
    for cpu, gpu in zip(outs["cpu"], outs[cuda_device]):
        for c, g in zip(cpu, gpu):
            torch.testing.assert_close(g.cpu(), c, rtol=0,
                                       atol=1e-9 * max(1.0, c.abs().max().item()))


def _contact_path(case, dev, x0_scale=1.0):
    """A small instance of a contact path: the UR10 throw at N = 10 with
    two targets (from its warm start) or the Solo jump at N = 8 with two
    initial states, and its solver options."""
    from aligator_tpu_torch.examples import solo_jump, ur10_ballistic

    rng = np.random.default_rng(36)
    if case == "ur10":
        targets = np.asarray(ur10_ballistic.TARGET_POS) + rng.uniform(-0.1, 0.1, (2, 3))
        prob = ur10_ballistic.create_ur10_ballistic_problem(10, 0.025, target_pos=targets,
                                                            device=dev)[0]
        prob = dataclasses.replace(prob, x0=prob.x0 * x0_scale)
        init = dict(zip(("xs_init", "us_init"), ur10_ballistic.warm_start(prob)))
        return prob, init, ur10_ballistic.SOLVE_OPTIONS
    prob = solo_jump.create_solo_jump_problem(3, 2, 3, device=dev)[0]
    x0 = prob.x0.expand(2, -1).clone()
    x0[:, -8:] += torch.tensor(0.1 * rng.standard_normal((2, 8)), device=dev)
    return dataclasses.replace(prob, x0=x0 * x0_scale), {}, solo_jump.SOLVE_OPTIONS


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ur10", "solo"])
def test_contact_path_card_matches_cpu(cuda_device, plain_versions_raise, case):
    """The UR10 payload throw (loop constraint, linear rollout) and the Solo
    jump (contact schedule, nonlinear rollout), 4 iterations of the
    published options, on the card against the CPU, each output to 1e-9
    relative or 100 times the CPU's one-ulp spread; the launch counts of
    the route (chip_smoke.py's contact_paths), the plain versions raising,
    every nonlinear trial a CUDA-graph replay."""
    from aligator_tpu_torch.solvers import proxddp
    from aligator_tpu_torch.solvers.proxddp import TrialGraphWarning

    def solve(path):
        prob, init, opts = path
        return at.solvers.solve(prob, at.solvers.ProxDDPConfig(
            **{**opts, "max_iters": 4}), **init)

    cpu = solve(_contact_path(case, "cpu"))
    spread = [solve(_contact_path(case, "cpu", s)) for s in (1.0 + 1e-15, 1.0 - 1e-15)]
    path = _contact_path(case, cuda_device)  # the warm start's rollout launches too
    prob = path[0]
    plain_versions_raise()
    before = _launches()
    proxddp.NONLINEAR_TRIALS = proxddp.LINEAR_TRIALS = 0
    with warnings.catch_warnings():
        warnings.simplefilter("error", TrialGraphWarning)
        gpu = solve(path)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    for name in ("num_iters", "conv"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    gaps = {}
    for name in ("xs", "us", "lams", "prim_infeas", "dual_infeas"):
        ref = getattr(cpu, name)
        scale = max(1.0, ref.abs().max().item())
        apart = max((getattr(r, name) - ref).abs().max().item() for r in spread) / scale
        gap = (getattr(gpu, name).cpu() - ref).abs().max().item() / scale
        gaps[name] = (gap, apart)
    print(case, {k: f"{g:.2e} (spread {a:.2e})" for k, (g, a) in gaps.items()})
    for name, (gap, apart) in gaps.items():
        assert gap <= max(1e-9, 100 * apart), (name, gap, apart)
    steps, iters, N = int(gpu.newton_steps.max()), int(gpu.num_iters.max()), prob.nsteps
    assert steps > 0
    if case == "ur10":  # the trials' dynamics, and the trial graph's warm-up
        want = dict(k2=2 * N * steps + 6 * (iters + 1) + 2 * (proxddp.LINEAR_TRIALS + 1),
                    k5=0)
    else:
        want = dict(k2=2 * N * steps + 2 * (iters + 1), k5=iters + 1)
    assert counts == dict(want, k3=0, k4=steps, k1=0)


# (module, builder, keyword arguments, N, the coordinates of x0 perturbed
# and by how much)
COLLISION_EXAMPLES = {
    "ur5_table": ("ur5_table", "create_ur5_table_problem", {}, 10, slice(0, 6), 0.1),
    "ur5_ballistic": ("ur5_ballistic", "create_ballistic_problem", {}, 10, slice(0, 6), 0.1),
    "panda": ("panda_reach", "create_panda_problem", {}, 10, slice(0, 7), 0.05),
    "quadrotor": ("quadrotor", "create_quadrotor_problem", {}, 10, slice(0, 3), 0.05),
    "quadrotor_term": ("quadrotor", "create_quadrotor_problem", dict(term_cstr=True), 10,
                       slice(0, 3), 0.05),
    "talos_arms": ("talos_arms", "create_talos_arms_problem", {}, 10, slice(0, 10), 0.05),
    "ffsr_collision": ("dual_ffsr_reach", "create_ffsr_problem",
                       dict(with_collision=True, with_self_collision=True), 8,
                       slice(7, 21), 0.05),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(COLLISION_EXAMPLES))
def test_collision_example_card_matches_cpu(cuda_device, plain_versions_raise, case):
    """The examples of the collision and extra residuals (the UR5 table
    reach, the UR5 throw, the Panda reach past its post, the quadrotor
    without and with its terminal constraint, the upper-body reach, the
    FFSR reach with both collision flags) with their published options, 4
    perturbed scenarios, 4 iterations, on the card against the CPU, as
    test_free_reach_card_matches_cpu holds the reaches: each output to 1e-9
    or to 100 times the distance of CPU solves from initial states one ulp
    away; K2 twice a stage and K4 once a Newton step; the free-dynamics
    kernel once for all stages of each linear trial (the table's linear
    rollout) or once a stage of each nonlinear rollout, and once a
    derivative evaluation; every trial a CUDA-graph replay."""
    import importlib

    from aligator_tpu_torch.solvers import proxddp
    from aligator_tpu_torch.solvers.proxddp import TrialGraphWarning

    mod, fn, kw, N, coords, scale = COLLISION_EXAMPLES[case]
    ex = importlib.import_module(f"aligator_tpu_torch.examples.{mod}")
    create = getattr(ex, fn)
    rng = np.random.default_rng(33)
    x0 = create(nsteps=N, device="cpu", **kw).x0.expand(4, -1).clone()
    x0[:, coords] += torch.tensor(scale * rng.standard_normal((4, coords.stop - coords.start)))
    cfg = at.solvers.ProxDDPConfig(**{**ex.SOLVE_OPTIONS, "max_iters": 4})

    def make(dev):
        return dataclasses.replace(create(nsteps=N, device=dev, **kw), x0=x0.to(dev))

    cpu = at.solvers.solve(make("cpu"), cfg)
    spread = [at.solvers.solve(dataclasses.replace(make("cpu"), x0=x0 * s), cfg)
              for s in (1.0 + 1e-15, 1.0 - 1e-15)]
    plain_versions_raise()
    before = _launches()
    fd_before = _build.LAUNCHES["free_fd"]
    trials_before = proxddp.NONLINEAR_TRIALS + proxddp.LINEAR_TRIALS
    with warnings.catch_warnings():
        warnings.simplefilter("error", TrialGraphWarning)
        gpu = at.solvers.solve(make(cuda_device), cfg)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    for name in ("num_iters", "conv"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    for name in ("xs", "us", "lams", "prim_infeas", "dual_infeas"):
        ref = getattr(cpu, name)
        scale = max(1.0, ref.abs().max().item())
        apart = max((getattr(r, name) - ref).abs().max().item() for r in spread) / scale
        gap = (getattr(gpu, name).cpu() - ref).abs().max().item() / scale
        assert gap <= max(1e-9, 100 * apart), (name, gap, apart)
    steps = int(gpu.newton_steps.max())
    assert steps > 0
    assert counts == dict(k2=2 * N * steps, k3=0, k4=steps, k1=0, k5=0)
    trials = proxddp.NONLINEAR_TRIALS + proxddp.LINEAR_TRIALS - trials_before
    iters = int(gpu.num_iters.max())
    per_trial = 1 if cfg.rollout == "linear" else N
    assert _build.LAUNCHES["free_fd"] - fd_before == per_trial * (trials + 1) + iters + 1


@pytest.mark.cuda
def test_convex_distance_is_captured_in_a_cuda_graph(cuda_device):
    """convex_distance's 24 steps and the residuals on it read nothing back
    to the host: a CUDA graph captures the hull-against-box residual, and
    its replay on new states gives the eager values."""
    from aligator_tpu_torch.modelling.multibody import geometry as geo
    from aligator_tpu_torch.modelling.multibody import robots

    model = robots.make_ur5(device=cuda_device)
    rng = np.random.default_rng(3)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), device=cuda_device)

    fn = geo.FrameConvexHullObstacleResidual(
        model=model, local_verts=t(0.05 * rng.standard_normal((6, 3))),
        obs_center=t([0.4, 0.0, 0.1]), obs_rot=torch.eye(3, dtype=torch.float64,
                                                          device=cuda_device),
        obs_half_extents=t([0.1, 0.15, 0.2]), margin=t(0.01), frame_id=model.frame_id("ee"))
    sp = model.phase_space()
    x = t(0.5 * rng.standard_normal((64, 12)))
    u = torch.zeros((64, 6), dtype=torch.float64, device=cuda_device)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn.value(sp, x, u)  # warm-up on a side stream, as capture asks
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn.value(sp, x, u)
    x.copy_(t(0.5 * rng.standard_normal((64, 12))))
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fn.value(sp, x, u), rtol=0, atol=1e-12)


# ---------------------------------------------------------------- MPC and centroidal


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["se2", "humanoid"])
def test_mpc_cycle_card_matches_cpu(cuda_device, plain_versions_raise, path):
    """One receding-horizon cycle (apply the first control, shift the warm
    start, re-solve at bench_mpc.py's warm budget) after a cold solve, B =
    4, float32, on the card against the CPU: iteration counts and flags
    equal, trajectories within 1e-3 (as the SE(2) path is held); K1 a Newton
    step on the SE(2) car, K3 and K4 at humanoid dims."""
    from aligator_tpu_torch.examples import medium_dims, mpc_se2

    def make(dev):
        if path == "se2":
            return mpc_se2.create_mpc_problem(4, 50, torch.float32, dev, seed=2)
        prob = medium_dims.make_humanoid_dims_problem(100, torch.float32, dev)
        rng = np.random.default_rng(2)
        x0 = prob.x0.cpu().numpy() + 0.05 * rng.standard_normal((4, prob.x0.shape[1]))
        return dataclasses.replace(prob, x0=torch.tensor(x0, dtype=torch.float32,
                                                         device=dev))

    cold_cfg = at.solvers.ProxDDPConfig(**mpc_se2.COLD)
    warm = at.solvers.ProxDDPConfig(**mpc_se2.WARM)
    out = {}
    for dev in ("cpu", cuda_device):
        if dev != "cpu":
            plain_versions_raise()
        prob = make(dev)
        cold = at.solvers.solve(prob, cold_cfg)
        before = _launches()
        x, res = mpc_se2.mpc_cycle(prob, warm, prob.x0, cold.xs, cold.us)
        counts = {k: v - before[k] for k, v in _launches().items()}
        out[dev] = (cold, x, res, counts)
    (ccold, cx, cres, _), (gcold, gx, gres, counts) = out["cpu"], out[cuda_device]
    for a, b in ((gcold, ccold), (gres, cres)):
        assert torch.equal(a.num_iters.cpu(), b.num_iters)
        assert torch.equal(a.conv.cpu(), b.conv)
        for name in ("xs", "us"):
            assert (getattr(a, name).cpu() - getattr(b, name)).abs().max() <= 1e-3, name
    assert (gx.cpu() - cx).abs().max() <= 1e-3
    steps = int(gres.newton_steps.max())
    want = dict(k1=steps, k2=0, k3=0, k4=0, k5=0) if path == "se2" else \
        dict(k1=0, k2=0, k3=steps, k4=steps, k5=0)
    assert counts == want


CENTROIDAL_PATHS = ("wip", "centroidal", "kinodynamics", "continuous")


def _centroidal_problem(path, x0s, dev):
    from aligator_tpu_torch.examples import (centroidal_locomotion, continuous_centroidal,
                                             solo_kinodynamics, wheeled_inverted_pendulum)

    mods = {"wip": wheeled_inverted_pendulum, "centroidal": centroidal_locomotion,
            "kinodynamics": solo_kinodynamics, "continuous": continuous_centroidal}
    mod = mods[path]
    x0 = torch.tensor(x0s, dtype=torch.float64, device=dev)
    if path == "continuous":
        prob = dataclasses.replace(mod.create_problem(device=dev)[0], x0=x0)
        return mod, prob, dict(xs_init=mod.warm_start(prob))
    make = {"wip": "create_wip_problem", "centroidal": "create_centroidal_problem",
            "kinodynamics": "create_kinodynamics_problem"}[path]
    return mod, dataclasses.replace(getattr(mod, make)(device=dev), x0=x0), {}


@pytest.mark.cuda
@pytest.mark.parametrize("path", CENTROIDAL_PATHS)
def test_centroidal_example_card_matches_cpu(cuda_device, plain_versions_raise, path):
    """Each centroidal example at its published size, B = 4, float64, 4
    iterations, on the card against the CPU, each output to 1e-9 relative or
    to 100 times the largest distance between the CPU solve and those from
    x0·(1 ± 1e-15), as the free and contact paths are held; the launches of
    the route: K1 a Newton step for the pendulum, K2 twice a stage a step
    for the centroidal gait (the per-stage loop, nx = 9 below K3 and K4),
    K3 and K4 a step for the kinodynamics and the continuous gait."""
    from aligator_tpu_torch.examples import (centroidal_locomotion, continuous_centroidal,
                                             solo_kinodynamics, wheeled_inverted_pendulum)

    mod = {"wip": wheeled_inverted_pendulum, "centroidal": centroidal_locomotion,
           "kinodynamics": solo_kinodynamics, "continuous": continuous_centroidal}[path]
    x0s = mod.initial_states(4, 12)
    cfg = at.solvers.ProxDDPConfig(**{**mod.SOLVE_OPTIONS, "max_iters": 4})

    def solve(dev, scale=1.0):
        _, prob, init = _centroidal_problem(path, x0s * scale, dev)
        return at.solvers.solve(prob, cfg, **init), prob

    cpu, _ = solve("cpu")
    spread = [solve("cpu", s)[0] for s in (1.0 + 1e-15, 1.0 - 1e-15)]
    plain_versions_raise()
    before = _launches()
    gpu, prob = solve(cuda_device)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    for name in ("num_iters", "conv"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    for name in ("xs", "us", "lams", "prim_infeas", "dual_infeas"):
        ref = getattr(cpu, name)
        scale = max(1.0, ref.abs().max().item())
        apart = max((getattr(r, name) - ref).abs().max().item() for r in spread) / scale
        gap = (getattr(gpu, name).cpu() - ref).abs().max().item() / scale
        assert gap <= max(1e-9, 100 * apart), (name, gap, apart)
    steps = int(gpu.newton_steps.max())
    assert steps > 0
    want = {"wip": dict(k1=steps, k2=0, k3=0, k4=0, k5=0),
            "centroidal": dict(k1=0, k2=2 * prob.nsteps * steps, k3=0, k4=0, k5=0),
            "kinodynamics": dict(k1=0, k2=0, k3=steps, k4=steps, k5=0),
            "continuous": dict(k1=0, k2=0, k3=steps, k4=steps, k5=0)}[path]
    assert counts == want


# ---------------------------------------------------------------- model ingestion, armature


def _armature_model(case, dev):
    """The free-dynamics kernel's armature cases: the armature Panda
    (Menagerie's 0.1 on each joint), the FFSR with 10 on its 14 arm dofs
    (as the fork's file), a fixed-base chain of 40 links with 0.05 (the
    global workspace)."""
    from aligator_tpu_torch.examples import panda_reach
    from aligator_tpu_torch.modelling.multibody import robots

    if case == "panda":
        return panda_reach.armature_panda(device=dev)
    m = robots.make_dual_arm_ffsr(device=dev) if case == "ffsr" else _chain(40, False, dev)
    arm = torch.full((m.nv,), 10.0 if case == "ffsr" else 0.05, dtype=torch.float64,
                     device=dev)
    if case == "ffsr":
        arm[:6] = 0.0
    return dataclasses.replace(m, armature=arm)


@pytest.mark.cuda
@pytest.mark.parametrize("case,B", [("panda", 1024), ("ffsr", 256), ("chain40", 256)])
def test_free_fd_with_armature_matches_plain(cuda_device, case, B):
    """The free-dynamics kernel's armature section (added to M's diagonal
    before its Cholesky factor) on the register route (the Panda, the
    FFSR) and on the global workspace (40 links) against model.aba, whose
    mass matrix adds it too: fp64 to 1e-12 relative to the output's scale,
    or 100 times the plain version's distance from itself one ulp away in
    q on the chain (test_free_fd_past_the_old_caps_matches_plain); fp32 on
    the register route to 1e-2 (chip_smoke.py's FREE_FD_FP32_TOL). Without
    the armature the result moves."""
    rng = np.random.default_rng(42)
    m = _armature_model(case, cuda_device)
    dq, v, tau = (torch.tensor(rng.standard_normal((B, m.nv)), device=cuda_device)
                  for _ in range(3))
    q = m.configuration_space().integrate(m.neutral()[None], 0.5 * dq)
    before = _build.LAUNCHES["free_fd"]
    got = free_fd.free_fd(m, q, v, tau)
    assert _build.LAUNCHES["free_fd"] == before + 1
    ref = rbd.aba(m, q, v, tau)
    spread = 0.0
    if case == "chain40":
        spread = max((rbd.aba(m, q * s, v, tau) - ref).abs().max().item()
                     for s in (1.0 + 1e-15, 1.0 - 1e-15))
    scale = max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= max(1e-12 * scale, 100 * spread)
    bare = free_fd.free_fd(dataclasses.replace(m, armature=None), q, v, tau)
    assert (bare - got).abs().max().item() > 1e-6 * scale
    if case != "chain40":  # fp32 on the register route, as chip_smoke.py checks it
        m32 = m.to(torch.float32)
        q32, v32, t32 = q.float(), v.float(), tau.float()
        got32, ref32 = free_fd.free_fd(m32, q32, v32, t32), rbd.aba(m32, q32, v32, t32)
        assert _rel(got32, ref32) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fd_rows_do_not_see_the_armature(cuda_device, dtype):
    """K5's rows, ∂(RNEA + Jᵀλ)/∂(q, v), do not depend on the armature
    (armature·a depends on neither): on the free-flyer chain (nv = 70, the
    global workspace) the kernel's rows with and without an armature are
    equal."""
    model = _chain(64, True, "cpu")
    rng = np.random.default_rng(9)
    K, nv = 9, model.nv
    frames = tuple(model.frame_id(f"f{b}") for b in range(3, 43, 4))
    q = model.configuration_space().integrate(
        model.neutral()[None], torch.tensor(0.1 * rng.standard_normal((K, nv))))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda_device)

    ins = (t(q), t(0.2 * rng.standard_normal((K, nv))), t(rng.standard_normal((K, nv))),
           t(10.0 * rng.standard_normal((K, 30))), t(np.ones((K, 10))))
    model = model.to(dtype, cuda_device)
    with_arm = dataclasses.replace(model, armature=t(np.linspace(0.01, 0.5, nv)))
    before = _build.LAUNCHES["fd_rows"]
    rows = fd_rows.fd_rows(with_arm, *ins, frames, (3,) * 10, kd=10.0)
    rows0 = fd_rows.fd_rows(model, *ins, frames, (3,) * 10, kd=10.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fd_rows"] == before + 2
    for r, r0 in zip(rows, rows0):
        assert torch.equal(r, r0)


@pytest.mark.cuda
def test_ingested_panda_reach_card_matches_cpu(cuda_device, plain_versions_raise, tmp_path,
                                               monkeypatch):
    """The reach on the Panda read back from the MJCF text that
    ``write_panda_mjcf`` writes (``make_panda_real``: armature, the
    ``attachment`` flange), 4 of chip_smoke.py's starts, N = 10, 4
    iterations, on the card against the CPU (1e-9 or 100 times the one-ulp
    spread, as test_collision_example_card_matches_cpu): K2 twice a stage,
    K4 once a Newton step, the free-dynamics kernel with its armature
    section once a stage of each rollout and once a derivative
    evaluation."""
    from aligator_tpu_torch.examples import panda_reach
    from aligator_tpu_torch.modelling.multibody import robots
    from aligator_tpu_torch.solvers import proxddp
    from aligator_tpu_torch.solvers.proxddp import TrialGraphWarning

    path = str(tmp_path / "panda.xml")
    panda_reach.write_panda_mjcf(path)
    monkeypatch.setattr(robots, "PANDA_MJCF_PATH", path)
    N = 10
    x0 = torch.tensor(panda_reach.initial_states(4, 0))
    cfg = at.solvers.ProxDDPConfig(**{**panda_reach.SOLVE_OPTIONS, "max_iters": 4})

    def make(dev):
        prob = panda_reach.create_panda_problem(nsteps=N, device=dev)
        model = prob.stages.dynamics.ode.model
        assert model.armature is not None and "attachment" in model.frame_names
        return dataclasses.replace(prob, x0=x0.to(dev))

    cpu = at.solvers.solve(make("cpu"), cfg)
    spread = [at.solvers.solve(dataclasses.replace(make("cpu"), x0=x0 * s), cfg)
              for s in (1.0 + 1e-15, 1.0 - 1e-15)]
    plain_versions_raise()
    before = _launches()
    fd_before, trials_before = _build.LAUNCHES["free_fd"], proxddp.NONLINEAR_TRIALS
    with warnings.catch_warnings():
        warnings.simplefilter("error", TrialGraphWarning)
        gpu = at.solvers.solve(make(cuda_device), cfg)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    for name in ("num_iters", "conv"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    for name in ("xs", "us", "lams", "prim_infeas", "dual_infeas"):
        ref = getattr(cpu, name)
        scale = max(1.0, ref.abs().max().item())
        apart = max((getattr(r, name) - ref).abs().max().item() for r in spread) / scale
        gap = (getattr(gpu, name).cpu() - ref).abs().max().item() / scale
        assert gap <= max(1e-9, 100 * apart), (name, gap, apart)
    steps, iters = int(gpu.newton_steps.max()), int(gpu.num_iters.max())
    assert steps > 0
    assert counts == dict(k2=2 * N * steps, k3=0, k4=steps, k1=0, k5=0)
    trials = proxddp.NONLINEAR_TRIALS - trials_before
    assert _build.LAUNCHES["free_fd"] - fd_before == N * (trials + 1) + iters + 1


@pytest.mark.cuda
def test_gar_examples_card_match_cpu(cuda_device, k1_built, plain_versions_raise):
    """The gar examples on the card against the CPU (fp64, 1e-9 relative):
    gar_lqr's serial solve on K1 (once, (4, 2, 1) with explicit E), its
    4-leg parallel solve and θ backward on K2; split_and_join's and
    solve_cyclic's θ backward sweeps and θ solves on K2."""
    from aligator_tpu_torch.examples import gar_cyclic_lqr, gar_lqr, gar_lqr_join

    def lqr(dev):
        return lqr_problem.random_convex_problem(np.random.default_rng(0), 2, 23, 4, 2, 1,
                                                 device=dev)

    def join(dev):
        return lqr_problem.random_convex_problem(np.random.default_rng(42), 2, 9, 2, 1, 0,
                                                 device=dev)

    cpu = (gar_lqr.run(lqr("cpu")), gar_lqr_join.split_and_join(join("cpu"), 5, 1e-8),
           gar_cyclic_lqr.solve_cyclic(gar_cyclic_lqr.create_cyclic_problem(device="cpu")))
    plain_versions_raise()
    before = _launches()
    out = gar_lqr.run(lqr(cuda_device))
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    assert counts["k1"] == 1 and counts["k2"] > 0 and counts["k3"] == 0
    for name in ("serial", "parallel", "dense"):
        for g, r in zip(out[name], cpu[0][name]):
            assert _rel(g.cpu(), r) <= 1e-9, name
    for name in ("th_grad", "th_hess"):
        assert _rel(out[name].cpu(), cpu[0][name]) <= 1e-9, name
    k2 = _build.LAUNCHES["spd_solve"]
    card = (gar_lqr_join.split_and_join(join(cuda_device), 5, 1e-8),
            gar_cyclic_lqr.solve_cyclic(gar_cyclic_lqr.create_cyclic_problem(device=cuda_device)))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["spd_solve"] > k2
    for got, ref in zip(card, cpu[1:]):
        for g, r in zip(got, ref):
            assert _rel(g.cpu(), r) <= 1e-9


# (module, problem constructor, keyword arguments, the coordinates of x0
# perturbed and by how much, the LQ route, whether the rollout's dynamics is the free-dynamics
# kernel (semi-implicit Euler on a free ODE; RK2 and the implicit midpoint
# rule differentiate model.aba)): the examples that ran on the CPU only before
EARLIER_EXAMPLES = {
    "pendulum": ("pendulum", "create_pendulum_problem", dict(nsteps=20), slice(0, 1), 0.05,
                 "k1", True),
    "double_pendulum": ("double_pendulum", "create_double_pendulum_problem", dict(nsteps=20),
                        slice(0, 2), 0.05, "k1", True),
    "flexible_double_pendulum": ("flexible_double_pendulum",
                                 "create_flexible_pendulum_problem", dict(nsteps=20),
                                 slice(0, 4), 0.05, "k1", False),
    "ur10_midpoint": ("ur10_midpoint", "create_ur10_midpoint_problem", dict(nsteps=10),
                      slice(0, 6), 0.1, "loop", False),
    "solo_bend": ("solo_bend", "create_solo_bend_problem", dict(nsteps=6), slice(7, 19),
                  0.02, "contact", False),
    "biped_walk": ("biped_walk", "create_biped_walk_problem", dict(n_ds=2, n_ss=2),
                   slice(7, 13), 0.02, "contact", False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EARLIER_EXAMPLES))
def test_earlier_example_card_matches_cpu(cuda_device, plain_versions_raise, case):
    """The pendulum, double pendulum, flexible double pendulum, UR10
    midpoint reach, Solo squat and biped walk, which earlier slices ran on
    the CPU only: 4 perturbed scenarios, 4 iterations of the published
    options, on the card against the CPU, each output to 1e-9 relative or
    100 times the CPU's one-ulp spread; the plain versions raising, every
    trial a CUDA-graph replay, and the route's launches: K1 once a Newton
    step for the pendulums, the free-dynamics kernel once a stage of every
    rollout and once a derivative evaluation where the rollout steps a free
    ODE by semi-implicit Euler (the pendulum and the double pendulum; the
    flexible pendulum's RK2 and the UR10's midpoint rule differentiate
    model.aba); the per-stage loop's K2 twice
    a stage and K4 once a step for the UR10 (general E at ndx = 12) and the
    legged models, whose contact dynamics add K5 once and K2 twice a
    derivative evaluation."""
    import importlib

    from aligator_tpu_torch.solvers import proxddp
    from aligator_tpu_torch.solvers.proxddp import TrialGraphWarning

    mod, fn, kw, coords, scale, route, fd_rollout = EARLIER_EXAMPLES[case]
    ex = importlib.import_module(f"aligator_tpu_torch.examples.{mod}")

    def create(dev):
        out = getattr(ex, fn)(device=dev, **kw)
        return out[0] if isinstance(out, tuple) else out

    rng = np.random.default_rng(14)
    x0 = create("cpu").x0.expand(4, -1).clone()
    x0[:, coords] += torch.tensor(scale * rng.standard_normal((4, coords.stop - coords.start)))
    cfg = at.solvers.ProxDDPConfig(**{**ex.SOLVE_OPTIONS, "max_iters": 4})

    def solve(dev, s=1.0):
        prob = dataclasses.replace(create(dev), x0=(x0 * s).to(dev))
        init = {}
        if hasattr(ex, "warm_start"):
            init = dict(zip(("xs_init", "us_init"), ex.warm_start(prob)))
        return prob, at.solvers.solve(prob, cfg, **init)

    _, cpu = solve("cpu")
    spread = [solve("cpu", s)[1] for s in (1.0 + 1e-15, 1.0 - 1e-15)]
    plain_versions_raise()
    before = _launches()
    fd_before = _build.LAUNCHES["free_fd"]
    trials_before = proxddp.NONLINEAR_TRIALS + proxddp.LINEAR_TRIALS
    with warnings.catch_warnings():
        warnings.simplefilter("error", TrialGraphWarning)
        prob, gpu = solve(cuda_device)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    counts["free_fd"] = _build.LAUNCHES["free_fd"] - fd_before
    trials = proxddp.NONLINEAR_TRIALS + proxddp.LINEAR_TRIALS - trials_before
    steps, iters, N = int(gpu.newton_steps.max()), int(gpu.num_iters.max()), prob.nsteps
    print(case, counts, dict(steps=steps, iters=iters, trials=trials, N=N))
    for name in ("num_iters", "conv"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    for name in ("xs", "us", "lams", "prim_infeas", "dual_infeas"):
        ref = getattr(cpu, name)
        s = max(1.0, ref.abs().max().item())
        apart = max((getattr(r, name) - ref).abs().max().item() for r in spread) / s
        gap = (getattr(gpu, name).cpu() - ref).abs().max().item() / s
        assert gap <= max(1e-9, 100 * apart), (name, gap, apart)
    assert steps > 0
    if route == "k1":
        want = dict(k1=steps, k2=0, k4=0, k5=0)
    elif route == "loop":
        want = dict(k1=0, k2=2 * N * steps, k4=steps, k5=0)
    else:
        want = dict(k1=0, k2=2 * N * steps + 2 * (iters + 1), k4=steps, k5=iters + 1)
    want["free_fd"] = N * (trials + 1) + iters + 1 if fd_rollout else 0
    assert counts == dict(want, k3=0)


@pytest.mark.cuda
def test_panda_mujoco_mpc_solver_half_card_matches_cpu(cuda_device, plain_versions_raise,
                                                       tmp_path, monkeypatch):
    """The solver half of examples/mpc_panda_mujoco.py on the card (the
    card machine has no MuJoCo): the first solve and 5 warm cycles from the
    simulator states of tests/data/torch_mujoco_ref.npz (the JAX package's
    closed loop on the stand-in Panda), against the CPU port's cycles from
    the same states, each cycle's first control and gain and its
    trajectories to 1e-9 relative or 100 times the CPU's one-ulp spread;
    the plain versions raising, every trial a CUDA-graph replay captured at
    the first solve and replayed by the cycles; the route: K2 twice a stage
    and K4 once a Newton step (ndx = 14, general E), the free-dynamics
    kernel once a stage of every rollout, once a derivative evaluation and
    once a warm start's tail."""
    import json
    import pathlib

    from aligator_tpu_torch.examples import mpc_panda_mujoco as ex
    from aligator_tpu_torch.modelling.multibody import robots
    from aligator_tpu_torch.solvers import proxddp
    from aligator_tpu_torch.solvers.proxddp import TrialGraphWarning

    path = str(tmp_path / "panda_nohand.xml")
    ex.write_mujoco_panda(path)
    monkeypatch.setattr(robots, "PANDA_MJCF_PATH", path)
    ref = np.load(pathlib.Path(__file__).resolve().parent / "data" / "torch_mujoco_ref.npz")
    pr = json.loads(str(ref["protocol"]))
    cfg_init, cfg = ex.solver_configs(pr["init_iters"], pr["cycle_iters"])
    N, cycles = pr["nsteps"], 6

    def run(dev, s=1.0):
        problem = ex.create_mpc_problem(nsteps=N, timestep=pr["timestep"],
                                        p_target=pr["p_target"], device=dev)[0]
        res = [ex.first_solve(problem, cfg_init, ref["states"][0] * s)]
        for c in range(1, cycles):
            res.append(ex.cycle_solve(problem, cfg, ref["states"][c] * s, res[-1]))
        return res

    cpu = run("cpu")
    spread = [run("cpu", s) for s in (1.0 + 1e-15, 1.0 - 1e-15)]
    plain_versions_raise()
    before = _launches()
    fd_before = _build.LAUNCHES["free_fd"]
    trials_before = proxddp.NONLINEAR_TRIALS
    with warnings.catch_warnings():
        warnings.simplefilter("error", TrialGraphWarning)
        gpu = run(cuda_device)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launches().items()}
    trials = proxddp.NONLINEAR_TRIALS - trials_before
    steps = sum(int(r.newton_steps.max()) for r in gpu)
    iters = sum(int(r.num_iters.max()) for r in gpu)
    fd = _build.LAUNCHES["free_fd"] - fd_before
    print("panda mpc", counts, dict(steps=steps, iters=iters, trials=trials, free_fd=fd))
    for c, (g, r) in enumerate(zip(gpu, cpu)):
        for name in ("num_iters", "conv"):
            assert torch.equal(getattr(g, name).cpu(), getattr(r, name)), (c, name)
        for name in ("xs", "us", "lams", "K", "prim_infeas"):
            want = getattr(r, name)
            s = max(1.0, want.abs().max().item())
            apart = max((getattr(sp[c], name) - want).abs().max().item()
                        for sp in spread) / s
            gap = (getattr(g, name).cpu() - want).abs().max().item() / s
            assert gap <= max(1e-9, 100 * apart), (c, name, gap, apart)
    assert steps > 0
    assert counts == dict(k1=0, k2=2 * N * steps, k3=0, k4=steps, k5=0)
    # a stage of every trial and of the warm-up of each configuration's trial
    # graph (two: the problem keeps one a configuration across the cycles);
    # one for every derivative evaluation (iterations + 1 a solve); one for
    # each warm start's rolled-out tail (cycle_warm_start)
    assert fd == N * (trials + 2) + iters + cycles + (cycles - 1)
