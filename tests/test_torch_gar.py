"""The port's LQ layer (aligator_tpu_torch.gar) against the JAX package.

Every instance is built by the JAX package in float64, carried to the port
through numpy, and solved by both. The CUDA kernel itself is checked on the
card by tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligator_tpu import gar as jgar
from aligator_tpu._pytree import replace
from aligator_tpu.gar import pallas_riccati
from aligator_tpu.native import riccati_solve_native

import aligator_tpu_torch as at
from aligator_tpu_torch import _build, _device, convert
from aligator_tpu_torch.examples.se2_car import create_se2_problem
from aligator_tpu_torch.gar import fused_riccati, lqr_problem, riccati

torch.set_num_threads(2)


def _jax_batch(N, nx, nu, nc, B, seed=0, general_E=False):
    probs = jax.jit(jax.vmap(
        lambda k: jgar.random_problem(k, N, nx, nu, nc, dtype=jnp.float64)
    ))(jax.random.split(jax.random.PRNGKey(seed), B))
    if general_E:
        dE = 0.1 * jax.random.normal(
            jax.random.PRNGKey(seed + 5), probs.knots.E.shape, jnp.float64
        )
        probs = replace(probs, knots=replace(probs.knots, E=probs.knots.E + dE))
    return probs


def _arrays(probs):
    a = {k: np.asarray(getattr(probs.knots, k)) for k in convert.KNOT_FIELDS}
    a["G0"] = np.asarray(probs.G0)
    a["g0"] = np.asarray(probs.g0)
    return a


def _one(probs, b):
    return jax.tree.map(lambda a: a[b], probs)


def _torch_batch(N, nx, nu, nc, B, seed=0):
    """A random batch made by the port, for tests that need no JAX reference."""
    return lqr_problem.random_convex_problem(
        np.random.default_rng(seed), B, N, nx, nu, nc, device="cpu"
    )


def _mus(B, seed, lo=-3.0, hi=-1.0):
    rng = np.random.default_rng(seed)
    return 10 ** rng.uniform(lo, hi, B), 10 ** rng.uniform(lo, hi, B)


def test_dense_solve_and_kkt_error_match_jax():
    B, mudyn, mueq = 3, 1e-3, 2e-3
    probs = _jax_batch(2, 3, 2, 1, B, seed=3, general_E=True)
    arrays = _arrays(probs)
    tp = convert.lqr_problem_from_numpy(arrays, device="cpu")
    M, rhs = lqr_problem.dense_kkt(tp, mudyn, mueq)
    got = lqr_problem.dense_solve(tp, mudyn, mueq)
    jM, jrhs = jax.jit(jax.vmap(lambda p: jgar.dense_kkt(p, mudyn, mueq)))(probs)
    np.testing.assert_array_equal(M.numpy(), np.asarray(jM))
    np.testing.assert_array_equal(rhs.numpy(), np.asarray(jrhs))
    ref = jax.jit(jax.vmap(lambda p: jgar.dense_solve(p, mudyn, mueq)))(probs)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-10)
    for e in lqr_problem.kkt_error(tp, *got, mudyn, mueq):
        assert e.max().item() < 1e-9
    # a perturbed candidate: the residual norms must match JAX's too
    cand = [np.asarray(r) + 1e-3 for r in ref]
    jerr = jax.jit(jax.vmap(lambda p, *c: jgar.kkt_error(p, *c, mudyn, mueq)))(
        probs, *cand
    )
    terr = lqr_problem.kkt_error(tp, *(torch.tensor(c) for c in cand), mudyn, mueq)
    for je, te in zip(jerr, terr):
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-12)


@pytest.mark.parametrize("general_E", [False, True])
def test_riccati_solve_matches_jax_and_native(general_E):
    N, nx, nu, nc, B = 7, 3, 2, 1, 4
    probs = _jax_batch(N, nx, nu, nc, B, seed=1, general_E=general_E)
    tp = convert.lqr_problem_from_numpy(_arrays(probs), device="cpu")
    md, me = _mus(B, 7)
    got = riccati.solve(tp, torch.tensor(md), torch.tensor(me),
                        assume_explicit=not general_E)
    ref = jax.jit(jax.vmap(
        lambda p, a, b: jgar.solve(p, a, b, assume_explicit=not general_E)
    ))(probs, jnp.asarray(md), jnp.asarray(me))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-9)
    # the JAX-free C++ oracle, one problem at a time (scalar μ)
    for b in range(B):
        nat = riccati_solve_native(_one(probs, b), float(md[b]), float(me[b]))
        for n, g in zip(nat, got):
            assert np.all(np.isfinite(n))
            np.testing.assert_allclose(g[b].numpy(), n, atol=1e-8)
    dyn, cstr, dual = lqr_problem.kkt_error(tp, *got, torch.tensor(md),
                                            torch.tensor(me))
    assert max(dyn.max(), cstr.max(), dual.max()).item() < 1e-9


@pytest.mark.parametrize(
    "dims",
    [
        (10, 3, 2, 1, True),
        (15, 4, 2, 0, True),
        (8, 4, 2, 2, False),
        (10, 3, 2, 0, False),  # the SE(2)-car LQ shape
        (10, 4, 1, 1, True),  # cartpole with a control bound
        (10, 2, 1, 1, True),  # examples/lqr.py with u_bound
    ],
)
def test_solve_plain_matches_jax_kernel_interpret(dims):
    """The fused solve's plain version against the JAX Pallas kernel in
    interpret mode, with per-scenario μ and all gains. At index N the JAX
    kernel leaves lff/L/yff/Afb unwritten; the port writes zeros there."""
    N, nx, nu, nc, explicit = dims
    B = 128
    probs = _jax_batch(N, nx, nu, nc, B, seed=0, general_E=not explicit)
    md, me = _mus(B, N)
    ref = jax.jit(lambda p, a, b: pallas_riccati.solve(
        p, a, b, interpret=True, return_gains=True, assume_explicit=explicit,
    ))(probs, jnp.asarray(md), jnp.asarray(me))
    tp = convert.lqr_problem_from_numpy(_arrays(probs), device="cpu")
    got = fused_riccati.solve_plain(tp, torch.tensor(md), torch.tensor(me),
                                    explicit)
    for r, g in zip(ref[:4], got[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-9)
    assert set(got[4]) == set(ref[4])
    for k, r in ref[4].items():
        g = got[4][k].numpy()
        r = np.asarray(r)
        if k in ("lff", "L", "yff", "Afb"):
            assert np.all(g[:, N] == 0.0), k
            g, r = g[:, :N], r[:, :N]
        np.testing.assert_allclose(g, r, atol=1e-9, err_msg=k)
    # on CPU tensors the wrapper is the plain version
    out = fused_riccati.solve(tp, torch.tensor(md), torch.tensor(me), explicit)
    for a, b in zip(out[:4], got[:4]):
        assert torch.equal(a, b)


def test_solve_and_gains_dispatch():
    """Inside the fused domain solve_and_gains is the fused solve; outside
    (nx > 8) it is the batched loop; both agree with riccati.solve."""
    tp = _torch_batch(5, 3, 2, 1, 4)
    assert fused_riccati.available(tp)
    xs, us, vs, lams, gains = riccati.solve_and_gains(tp, 1e-3, 1e-2, True)
    ref = riccati.solve(tp, 1e-3, 1e-2, True)
    for a, b in zip((xs, us, vs, lams), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    assert set(gains) == set(riccati.GAIN_FIELDS)
    big = _torch_batch(3, 9, 2, 0, 2)
    assert not fused_riccati.available(big)
    out = riccati.solve_and_gains(big, 1e-3, 1e-2, True)
    for a, b in zip(out[:4], riccati.solve(big, 1e-3, 1e-2, True)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_kernel_rejects_uninstantiated_shapes():
    """The launcher's checks refuse what no build of the kernel takes, before
    looking for a card: nx = 9, nc0 != nx and a type other than fp32/fp64."""
    tp = _torch_batch(3, 3, 2, 0, 2)
    partial = dataclasses.replace(tp, G0=tp.G0[:, :2], g0=tp.g0[:, :2])
    for prob in (_torch_batch(3, 9, 2, 0, 2), partial):
        with pytest.raises(ValueError, match="outside its domain"):
            fused_riccati.launch(prob, 1e-3, 1e-3, True)
    half = dataclasses.replace(tp, knots=tp.knots.map(torch.Tensor.half))
    with pytest.raises(ValueError, match="float32/float64"):
        fused_riccati.launch(half, 1e-3, 1e-3, True)


def test_build_variants_hash_their_defines():
    """A shape's library name hashes its defines (pure Python, no nvcc)."""
    lib = _build._library_path
    a = fused_riccati.variant(3, 2, 0, False)
    assert lib(a) == lib(fused_riccati.variant(3, 2, 0, False))
    names = {lib(fused_riccati.variant(*s)) for s in fused_riccati.DOMAIN_SAMPLES}
    assert len(names) == len(fused_riccati.DOMAIN_SAMPLES)
    assert lib(a) != lib(fused_riccati.variant(3, 2, 0, True))
    assert lib(a) != lib(("fused_riccati", ())) != lib("spd_solve")
    assert lib("spd_solve") == lib(("spd_solve", ()))
    assert _build.label(a) == "fused_riccati[K1_NX=3,K1_NU=2,K1_NC=0,K1_EXPLICIT=0]"


def test_kernel_reads_the_se2_solvers_knots_in_place(monkeypatch):
    """The fused solve's inputs on the SE(2) solver's path are the solver's
    own tensors (knots contiguous; G0, g0 and mu with their strides): the
    kernel needs no copy of them, and its outputs are contiguous views of
    one buffer. The same preparation runs before a launch on the card."""
    seen = []
    solve_and_gains = riccati.solve_and_gains

    def spy(lq, mudyn, mueq, assume_explicit=True):
        seen.append((lq, mudyn, mueq, assume_explicit))
        return solve_and_gains(lq, mudyn, mueq, assume_explicit)

    monkeypatch.setattr(riccati, "solve_and_gains", spy)
    monkeypatch.setattr(fused_riccati, "_copy", lambda t: pytest.fail("input copied"))
    prob = create_se2_problem(nsteps=6, dtype=torch.float64, device="cpu")
    cfg = at.solvers.ProxDDPConfig(tol=1e-3, mu_init=1e-3, max_iters=1,
                                   max_al_iters=1, ls_strategy="filter")
    at.solvers.solve(dataclasses.replace(prob, x0=prob.x0.expand(3, -1)), cfg)
    lq, mudyn, mueq, explicit = seen[0]
    assert fused_riccati.available(lq) and not explicit
    ins, strides, outs = fused_riccati.kernel_io(lq, mudyn, mueq, explicit)
    kn = lq.knots
    own = [getattr(kn, f) for f in fused_riccati.KNOT_FIELDS] + [
        lq.G0, lq.g0, mudyn, mueq]
    assert [t.data_ptr() for t in ins] == [t.data_ptr() for t in own]
    assert strides[:5] == [*lq.G0.stride(), *lq.g0.stride()]
    assert all(v.is_contiguous() and v.shape[:2] == kn.Q.shape[:2]
               for v in outs.values())
    assert len({v.untyped_storage().data_ptr() for v in outs.values()}) == 1


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _device.resolve("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lqr_problem.random_convex_problem(np.random.default_rng(0), 1, 2, 3, 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_se2_problem(nsteps=2)
    assert _device.resolve("cpu") == torch.device("cpu")
