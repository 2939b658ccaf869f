"""The port's CUDA kernels against their plain versions, on the card.

These tests import no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py

Each skips without a CUDA device (the kernels have no CPU mode).
"""

import dataclasses

import numpy as np
import pytest
import torch

import aligator_tpu_torch as at
from aligator_tpu_torch.examples.se2_car import create_se2_problem
from aligator_tpu_torch.gar import fused_riccati, lqr_problem


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
