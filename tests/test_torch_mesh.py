"""The port's mesh helpers and sharded parallel-in-time solve against the JAX
package, case for case with tests/test_mesh.py, in a world of 4 gloo
processes on the CPU.

One world serves the module: a fixture spawns 4 processes once
(``torch.multiprocessing``, start method ``spawn``, rendezvous through a
file under the test's temporary directory: no port, no network). The
workers (tests/torch_mesh_worker.py) import only the port and run every
case; this process draws the inputs from test_mesh.py's seeds, hands them
over as numpy, and holds the JAX references, computed under conftest's 8
virtual CPU devices on a mesh of ``jax.devices()[:4]`` while the workers
run. A worker's failure fails the tests with its traceback; the spawn has
a time limit of its own, so nothing hangs.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import Mesh as JMesh

from aligator_tpu import gar as jgar
from aligator_tpu import solvers as jsolvers
from aligator_tpu._pytree import replace
from aligator_tpu.gar import parallel as jparallel
from aligator_tpu.gar import riccati as jriccati
from aligator_tpu.parallel import mesh as jmesh

import torch_mesh_worker as worker
from aligator_tpu_torch.parallel import mesh as mesh_mod

WORLD = 4
SPAWN_TIMEOUT_S = 240
SOL = ("xs", "us", "vs", "lams")


def _np_problem(jp, prefix):
    """A JAX LQ problem as the port's inputs: numpy, a leading batch of 1."""
    out = {f"{prefix}G0": np.asarray(jp.G0)[None], f"{prefix}g0": np.asarray(jp.g0)[None]}
    for name in ("Q", "S", "R", "q", "r", "A", "B", "E", "f", "C", "D", "d"):
        out[prefix + name] = np.asarray(getattr(jp.knots, name))[None]
    return out


def _solve_one(problem):
    def one(x0g):
        p = replace(problem, g0=x0g)
        return jgar.solve(p, 1e-3, 1e-3, assume_explicit=True)[1]

    return one


def _jit_draw(draw, key, dims):
    """``draw(PRNGKey(key), *dims)`` in float64, jitted (op by op it takes
    seconds a problem)."""
    return jax.jit(lambda k: draw(k, *dims, dtype=jnp.float64))(jax.random.PRNGKey(key))


def _cases():
    """test_mesh.py's inputs, from the same seeds: the JAX objects by case,
    and the port's inputs as numpy."""
    from examples.lqr import make_lqr_problem

    cases, inputs = {}, {}
    # (a) and (b): gar.solve over a batch of g0
    for case, key, dims, g_key in (("a", 0, (10, 4, 2, 1), 1), ("b", 2, (8, 3, 2, 0), 3)):
        prob = _jit_draw(jgar.random_problem, key, dims)
        g0s = jax.random.normal(jax.random.PRNGKey(g_key), (16, dims[1]), jnp.float64)
        cases[case] = (prob, g0s)
        inputs.update(_np_problem(prob, f"{case}_"))
        inputs[f"{case}_g0s"] = np.asarray(g0s)
    # (c) and (e): parallel-in-time legs
    for case, key, dims in (("c", 5, (31, 36, 12)), ("e", 7, (31, 6, 3))):
        cases[case] = _jit_draw(jgar.random_convex_problem, key, dims + (0,))
        inputs.update(_np_problem(cases[case], f"{case}_"))
    # (d) the ProxDDP LQR over a batch of initial states
    problem = make_lqr_problem(nsteps=12)
    x0s = problem.x0 + 0.1 * jax.random.normal(jax.random.PRNGKey(4),
                                               (8, problem.x0.shape[0]))
    cases["d"] = (problem, x0s)
    inputs["d_x0s"] = np.asarray(x0s)
    return cases, inputs


def _references(cases):
    """The JAX results, on a mesh of ``jax.devices()[:4]``."""
    devs = jax.devices()[:WORLD]
    refs = {}
    for case in ("a", "b"):
        prob, g0s = cases[case]
        one = _solve_one(prob)
        mesh = (jmesh.make_mesh(devs) if case == "a"
                else jmesh.make_hybrid_mesh(n_slices=2))
        axis = "batch" if case == "a" else ("dcn", "batch")
        refs[f"{case}_sharded"] = np.asarray(jmesh.batched_solve(one, g0s, mesh=mesh,
                                                                 axis_name=axis))
        refs[f"{case}_vmap"] = np.asarray(jax.jit(jax.vmap(one))(g0s))
    for case in ("c", "e"):
        serial = jax.jit(lambda p: jriccati.solve(p, 1e-3, 1e-3, True))(cases[case])
        refs.update({f"{case}_serial_{n}": np.asarray(a) for n, a in zip(SOL, serial)})
    sharded = jparallel.solve_sharded(cases["e"], 1e-3, 1e-3,
                                      mesh=JMesh(np.array(devs), axis_names=("t",)),
                                      axis_name="t", assume_explicit=True)
    refs.update({f"e_sharded_{n}": np.asarray(a) for n, a in zip(SOL, sharded)})
    problem, x0s = cases["d"]
    cfg = jsolvers.ProxDDPConfig(**worker.LQR_CFG)
    refs["d_vmap"] = np.asarray(jax.jit(jax.vmap(
        lambda x0: jsolvers.solve(replace(problem, x0=x0), cfg).us))(x0s))
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the 4-process gloo world once; returns ``(refs, ranks)``: the
    JAX references and each rank's results."""
    d = tmp_path_factory.mktemp("mesh_world")
    # the workers start first (~10 s to import torch and the port), and wait
    # for the inputs
    ctx = tmp.start_processes(
        worker.run, args=(WORLD, str(d / "init"), str(d / "inputs.npz"), str(d)),
        nprocs=WORLD, join=False, start_method="spawn")
    try:
        cases, inputs = _cases()
        np.savez(d / "inputs.tmp.npz", **inputs)
        (d / "inputs.tmp.npz").rename(d / "inputs.npz")
        refs = _references(cases)  # while the workers run
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=1):  # a worker's exception raises, traceback and all
            if time.monotonic() > deadline:
                errs = [p.read_text() for p in sorted(d.glob("rank*.err"))]
                pytest.fail(f"the gloo world did not finish in {SPAWN_TIMEOUT_S} s\n"
                            + "\n".join(errs))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return refs, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= tol, err


def test_batched_solve_matches_local(world):
    """(a) ``batched_solve`` of ``gar.solve`` over 16 g0s on a flat mesh of 4
    ranks: every rank holds the whole batch, equal to the local solve and to
    the JAX package's sharded and vmapped solves, to 1e-10."""
    refs, ranks = world
    for out in ranks:
        assert tuple(out["a_shape"]) == (WORLD,)
        _close(out["a"], out["a_local"], 1e-10)
        _close(out["a"], refs["a_sharded"], 1e-10)
        _close(out["a"], refs["a_vmap"], 1e-10)


def test_hybrid_mesh_two_level(world):
    """(b) the 2 × 2 hybrid mesh sharding over ``("dcn", "batch")``: the
    same, to 1e-10 (the JAX package's on its 2 × 4 virtual mesh)."""
    refs, ranks = world
    for out in ranks:
        assert tuple(out["b_shape"]) == (2, 2)
        assert tuple(out["b_axes"]) == ("dcn", "batch")
        _close(out["b"], out["b_local"], 1e-10)
        _close(out["b"], refs["b_sharded"], 1e-10)
        _close(out["b"], refs["b_vmap"], 1e-10)


def _legs(ranks, case):
    """The ranks' legs put end to end: ``(T, ·)`` of the one scenario."""
    return {n: np.concatenate([out[f"{case}_{n}"][0] for out in ranks]) for n in SOL}


def test_time_sharded_parallel_riccati_medium_dims(world):
    """(c) ``solve_sharded`` at medium dims (N = 31, nx = 36, nu = 12), one
    leg a rank: the legs put end to end equal the JAX package's serial
    solve, to 1e-8."""
    refs, ranks = world
    legs = _legs(ranks, "c")
    for n in ("xs", "us", "lams"):
        _close(legs[n], refs[f"c_serial_{n}"], 1e-8)


def test_proxddp_sharded_solve(world):
    """(d) ProxDDP on the LQR (N = 12, tol 1e-8, μ₀ 1e-3, 6 iterations) over
    8 initial states: the sharded batch equals the local solve and the JAX
    package's vmap, to 1e-8."""
    refs, ranks = world
    for out in ranks:
        _close(out["d"], out["d_local"], 1e-8)
        _close(out["d"], refs["d_vmap"], 1e-8)


def test_shard_map_legs_match_serial_and_collectives(world):
    """(e) ``solve_sharded`` at T = 32, (nx, nu) = (6, 3), 4 legs: equal to
    the JAX package's ``solve_sharded`` and serial sweep, to 1e-8; and its
    census, the counterpart of the HLO census of test_mesh.py: each rank
    made exactly one collective, an all-gather over the 4 legs of its
    interface payload (1 scenario, 4·nx² + 2·nx numbers), with no host copy
    (gloo on CPU tensors)."""
    refs, ranks = world
    legs = _legs(ranks, "e")
    for n in SOL:
        _close(legs[n], refs[f"e_sharded_{n}"], 1e-8)
    for n in ("xs", "us", "lams"):
        _close(legs[n], refs[f"e_serial_{n}"], 1e-8)
    nx = 6
    want = repr([(("all_gather", WORLD, (WORLD, 1, 4 * nx * nx + 2 * nx)), 1)])
    for out in ranks:
        assert str(out["e_census"]) == want
        assert int(out["e_host_copies"]) == 0
        # the medium-dim solve likewise
        assert str(out["c_census"]) == repr(
            [(("all_gather", WORLD, (WORLD, 1, 4 * 36 * 36 + 2 * 36)), 1)])


def test_sharded_raises_as_jax(world):
    """(f) ``solve_sharded`` raises, as the JAX function does, on a horizon
    that the mesh axis does not divide and on ``nc0 != nx``."""
    _, ranks = world
    for out in ranks:
        horizon, nc0 = (str(m) for m in out["f_raises"])
        assert "divisible by the mesh axis (4)" in horizon
        assert "nc0 == nx" in nc0


def test_world_of_one_without_a_group():
    """(g) In this process, with no process group: ``make_mesh`` is a world
    of one, on the CPU only when asked for (CUDA is requested by default
    and raises here), ``batched_solve`` is the local solve with one
    (trivial) gather, and ``solve_sharded`` on it is the serial solve."""
    from aligator_tpu_torch.gar import lqr_problem, parallel, riccati

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_mesh()
    mesh = mesh_mod.make_mesh(device="cpu")
    assert (mesh.shape, mesh.coords, mesh.groups) == ((1,), (0,), {})
    prob = lqr_problem.random_convex_problem(np.random.default_rng(0), 1, 10, 4, 2, 1,
                                             device="cpu")
    fn = worker.g0_solver(prob)
    g0s = torch.tensor(np.random.default_rng(1).standard_normal((16, 4)))
    mesh_mod.COLLECTIVES.clear()
    got = mesh_mod.batched_solve(fn, g0s, mesh=mesh)
    assert torch.equal(got, fn(g0s))
    assert mesh_mod.COLLECTIVES == {("all_gather", 1, (1, 16, 11, 2)): 1}
    tp = lqr_problem.random_convex_problem(np.random.default_rng(2), 1, 31, 6, 3, 0,
                                           device="cpu")
    one = parallel.solve_sharded(tp, 1e-3, 1e-3, mesh_mod.make_mesh(("t",), device="cpu"),
                                 assume_explicit=True)
    for a, b in zip(one, riccati.solve(tp, 1e-3, 1e-3, True)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)
