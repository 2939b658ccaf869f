"""The port's CUDA kernels against their plain versions, on the card, and
the slices that run them against the same solves on the CPU.

These tests import no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py

Each skips without a CUDA device (the kernels have no CPU mode).
"""

import dataclasses

import numpy as np
import pytest
import torch

import aligator_tpu_torch as at
from aligator_tpu_torch import convert
from aligator_tpu_torch.examples import medium_dims
from aligator_tpu_torch.examples.se2_car import create_se2_problem
from aligator_tpu_torch.gar import (fused_riccati, fused_stage, lqr_problem,
                                    riccati, spd_solve)
from aligator_tpu_torch.modelling.multibody import fd_rows, humanoid, quadruped
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(fused_riccati.KERNEL_SHAPES))
def test_fused_riccati_matches_plain(cuda_device, shape):
    nx, nu, nc, explicit = shape
    B = 300  # not a multiple of the block size: the last block is ragged
    prob = lqr_problem.random_convex_problem(
        np.random.default_rng(6), B, 9, nx, nu, nc, not explicit,
        device=cuda_device,
    )
    md, me = _mus(B, 11, cuda_device)
    before = fused_riccati.LAUNCHES
    got = fused_riccati.solve(prob, md, me, explicit)
    torch.cuda.synchronize()
    assert fused_riccati.LAUNCHES == before + 1
    ref = fused_riccati.solve_plain(prob, md, me, explicit)
    for a, b in zip(got[:4], ref[:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-9)
    for k in ref[4]:
        torch.testing.assert_close(got[4][k], ref[4][k], rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_fused_riccati_raises_on_uninstantiated_shape(cuda_device):
    prob = lqr_problem.random_convex_problem(
        np.random.default_rng(0), 4, 3, 5, 2, 0, device=cuda_device
    )
    with pytest.raises(ValueError, match="no instance"):
        fused_riccati.solve(prob, 1e-3, 1e-3, True)


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
        before = fused_riccati.LAUNCHES
        out[dev] = at.solvers.solve(prob, cfg)
        launches = fused_riccati.LAUNCHES - before
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
                                 (12, 84), (64, 128)])
def test_spd_solve_matches_plain(cuda_device, dtype, n, r):
    M = 130
    A, R = _spd_batch(np.random.default_rng(n), M, n, r, dtype, cuda_device)
    A[7, 3, 3] = -1.0  # not positive definite: NaN in that system only
    before = spd_solve.LAUNCHES
    X = spd_solve.spd_solve(A, R)
    torch.cuda.synchronize()
    assert spd_solve.LAUNCHES == before + 1
    ref = spd_solve.spd_solve_plain(A, R)
    ok = torch.arange(M, device=cuda_device) != 7
    assert torch.isnan(X[7]).all() and torch.isnan(ref[7]).all()
    assert torch.isfinite(X[ok]).all()
    assert _rel(X[ok], ref[ok]) <= TOL[dtype]


@pytest.mark.cuda
def test_spd_solve_rejects_oversized_systems(cuda_device):
    for n, r in ((65, 3), (12, 129)):
        A, R = _spd_batch(np.random.default_rng(0), 2, n, r, torch.float64,
                          cuda_device)
        with pytest.raises(ValueError, match="n <= 64 and r <= 128"):
            spd_solve.spd_solve(A, R)


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
    before = fused_stage.STAGE_LAUNCHES
    got = fused_stage.sweep(kn, P, p, md, me)
    torch.cuda.synchronize()
    assert fused_stage.STAGE_LAUNCHES == before + 1
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
    before = fused_stage.FORWARD_LAUNCHES
    got = fused_stage.forward(gains, x0, lam0)
    torch.cuda.synchronize()
    assert fused_stage.FORWARD_LAUNCHES == before + 1
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
    before = fd_rows.LAUNCHES
    got = fd_rows.fd_rows(model, *ins, frames, dims, kd=kd, kp=kp, has_prefs=kp != 0)
    torch.cuda.synchronize()
    assert fd_rows.LAUNCHES == before + 1
    ref = fd_rows.fd_rows_plain(model, *ins, frames, dims, kd=kd, kp=kp,
                                has_prefs=kp != 0)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert torch.isfinite(g).all()
        assert _rel(g, r) <= {torch.float64: 1e-9, torch.float32: 1e-3}[dtype]
    # the inactive contact's rows are zero
    assert (got[2][::3, :dims[0]] == 0).all() and (got[3][::3, :dims[0]] == 0).all()


@pytest.mark.cuda
def test_fd_rows_rejects_what_it_does_not_take(cuda_device):
    model, ins, frames, dims, kd = _fd_rows_inputs("quadruped", 4, torch.float64,
                                                   cuda_device, 6)
    with pytest.raises(ValueError, match="dim 3 or 6"):
        fd_rows.fd_rows(model, *ins[:3], ins[3][:, :8], ins[4][:, :2], frames[:2],
                        (4, 4), kd=kd)
    # a 65-joint chain: nv = nb = 65 is above the launcher's bound of 64
    chain = rbd.make_model(
        [dict(type=rbd.REVOLUTE, parent=i - 1, axis=(0.0, 1.0, 0.0),
              placement_p=(0.0, 0.0, -0.1), mass=1.0, com=(0.0, 0.0, -0.05),
              inertia=np.eye(3) * 1e-2) for i in range(65)],
        [dict(name="tip", parent=64)], device=cuda_device)
    z = torch.zeros((2, 65), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="does not take these dimensions"):
        fd_rows.fd_rows(chain, z, z, z, z[:, :3], z[:, :1] + 1, (0,), (3,), kd=1.0)


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
)


def _launches():
    return dict(k2=spd_solve.LAUNCHES, k3=fused_stage.STAGE_LAUNCHES,
                k4=fused_stage.FORWARD_LAUNCHES, k1=fused_riccati.LAUNCHES,
                k5=fd_rows.LAUNCHES)


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
