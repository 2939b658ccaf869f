"""The port's whole-body Talos-walk slice against the JAX package, float64 on
the CPU, at N = 7 (t_ds = 1, t_ss = 2).

``tests/data/torch_talos_ref.npz`` holds the JAX problem's leaves and the
JAX package's batch-2 ProxDDP solve of it (written by
``tools/torch_talos_fixture.py``; compiling that solve takes about 4 minutes
here, so the tier-1 tests compare with the file and a slow test reruns it
live). The port's problem is built from the same leaves
(``convert.talos_problem_from_numpy``) and by the port's own builder.
``tests/data/torch_talos_fp32_ref.npz`` holds the JAX package's float32
solve of the bench problem (N = 32), step by step
(``tools/torch_talos_fp32_fixture.py``).
"""

import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligator_tpu._pytree import replace
from aligator_tpu.core import problem as jproblem
from examples.talos_walk import create_talos_walk_problem as jax_talos_problem

import aligator_tpu_torch as at
from aligator_tpu_torch import convert
from aligator_tpu_torch.core import problem as problem_mod
from aligator_tpu_torch.examples.talos_walk import create_talos_walk_problem
from aligator_tpu_torch.modelling.multibody import model as rbd

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "torch_talos_ref.npz"
FP32_FIXTURE = ROOT / "tests" / "data" / "torch_talos_fp32_ref.npz"
T_DS, T_SS = 1, 2
# float64 on both sides; the solve's tolerance leaves room for two Newton
# steps of roundoff through 56-dim Riccati sweeps
TOL = 1e-8


def _fixture(path=FIXTURE):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if ref.size == 0:
        return 0.0
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def _config(fix):
    return at.solvers.ProxDDPConfig(**json.loads(str(fix["config"])))


def test_builder_matches_the_jax_leaves():
    """The port's own builder gives the leaves the JAX package's gives."""
    fix = _fixture()
    problem, model, sched = create_talos_walk_problem(T_DS, T_SS, device="cpu")
    for k in rbd.LEAVES:
        assert _rel_err(getattr(model, k), fix[k]) < 1e-14, k
    assert model.joint_types == tuple(fix["joint_types"])
    assert model.parents == tuple(fix["parents"])
    assert model.frame_parents == tuple(fix["frame_parents"])
    stage = problem.stages
    costs = stage.cost.costs
    ode = stage.dynamics.ode
    box = stage.constraints[0][1]
    pairs = dict(
        x_ref=problem.x0[0], state_weights=costs[0].weights,
        control_weights=costs[1].weights, term_weights=problem.term_cost.weights,
        active=ode.active, actuation=ode.actuation, u_lower=box.lower,
        u_upper=box.upper, timestep=stage.dynamics.timestep,
        swing_weights=torch.stack([costs[2 + k].weights for k in range(2)]),
        swing_targets=torch.stack([costs[2 + k].residual.p_ref for k in range(2)]),
    )
    for k, v in pairs.items():
        assert _rel_err(v, fix[k]) < 1e-14, k
    assert torch.equal(sched, ode.active)
    assert ode.contact_frames == tuple(fix["contact_frames"])
    assert ode.contact_dims == tuple(fix["contact_dims"])
    assert (ode.kd, ode.prox_mu) == (float(fix["kd"]), float(fix["prox_mu"]))
    assert problem.nsteps == int(fix["nsteps"]) == 2 * T_SS + 3 * T_DS


def test_builder_defaults_to_cuda():
    if torch.cuda.is_available():
        problem, _, _ = create_talos_walk_problem(T_DS, T_SS)
        assert problem.x0.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            create_talos_walk_problem(T_DS, T_SS)


DERIVS = ROOT / "tests" / "data" / "torch_talos_derivs_ref.npz"


def jax_derivative_refs():
    """Every field of the JAX package's ``compute_derivatives`` along the
    fixture's JAX solution of the second scenario, jitted for that one
    scenario; numpy."""
    fix = _fixture()
    jprob, _, _ = jax_talos_problem(t_ds=T_DS, t_ss=T_SS, dtype=jnp.float64)
    xs, us, x0 = fix["res_xs"], fix["res_us"], fix["x0"]
    ref = jax.jit(lambda x0, xs, us: jproblem.compute_derivatives(
        replace(jprob, x0=x0), xs, us))(x0[1], xs[1], us[1])
    return {f.name: np.asarray(getattr(ref, f.name)) for f in dataclasses.fields(ref)
            if getattr(ref, f.name) is not None}


JAX_REFS = {"derivs": (jax_derivative_refs, ())}


def test_compute_derivatives_matches_jax():
    """Every field of ``compute_derivatives`` along the JAX solution of the
    second scenario: costs and their derivatives, the contact dynamics'
    residuals and (A, B, E) through ``IntegratorSemiImplEuler.jacobians``,
    the control box, against the JAX package's (jax_derivative_refs, in
    ``tests/data/torch_talos_derivs_ref.npz``, written by
    ``tools/torch_jax_refs_fixture.py --only talos``: its compile took most
    of this file's time; the ``slow`` test below reruns it)."""
    fix = _fixture()
    ref = _fixture(DERIVS)
    xs, us = fix["res_xs"], fix["res_us"]
    problem = convert.talos_problem_from_numpy(fix, device="cpu")
    got = problem_mod.compute_derivatives(problem, torch.tensor(xs), torch.tensor(us))
    names = [f.name for f in dataclasses.fields(got) if getattr(got, f.name) is not None]
    assert sorted(names) == sorted(ref)
    for name in names:
        assert _rel_err(getattr(got, name)[1], ref[name]) < TOL, name


@pytest.mark.slow
def test_derivative_fixture_matches_live_jax():
    live, ref = jax_derivative_refs(), _fixture(DERIVS)
    assert sorted(live) == sorted(ref)
    for k, v in live.items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-12, atol=1e-12, err_msg=k)


def _check_against(res, fix):
    for k in ("num_iters", "al_iter", "conv"):
        assert np.array_equal(getattr(res, k).numpy(), fix[f"res_{k}"]), k
    for k in ("xs", "us", "vs", "lams", "prim_infeas", "dual_infeas", "traj_cost"):
        assert _rel_err(getattr(res, k), fix[f"res_{k}"]) < TOL, k


def test_proxddp_matches_jax_fixture():
    fix = _fixture()
    problem = convert.talos_problem_from_numpy(fix, device="cpu")
    res = at.solvers.solve(problem, _config(fix))
    _check_against(res, fix)
    assert bool((res.newton_steps == res.num_iters).all())


def test_stage_varying_leaves_reject_a_one_stage_call():
    """The schedule and the swing costs vary over the stages: a one-stage
    call (FDDP's rollout shape) raises rather than broadcasting them."""
    fix = _fixture()
    problem = convert.talos_problem_from_numpy(fix, device="cpu")
    N = problem.nsteps
    x = problem.x0[:1].expand(N, -1)  # (B, nx) with B == N
    u = x.new_zeros(N, problem.nu)
    with pytest.raises(ValueError, match="stage-varying"):
        problem.stages.dynamics.forward(problem.space, x, u)
    with pytest.raises(ValueError, match="stage-varying"):
        problem.stages.cost.value(problem.space, x, u)


def test_fp32_initial_iterate_matches_jax_fixture():
    """The float32 bench problem (N = 32) of ``tests/data/
    torch_talos_fp32_ref.npz``: the port's infeasibilities at the initial
    iterate are the JAX package's float32 ones. (The fixture's later steps
    are held against the card's solve by ``chip_smoke.py``: in float32 the
    step a line search rejects depends on the order of the sums.)"""
    ref = _fixture(FP32_FIXTURE)
    problem, _, _ = create_talos_walk_problem(4, 10, dtype=torch.float32, device="cpu")
    assert problem.nsteps == int(ref["nsteps"])
    problem = dataclasses.replace(problem, x0=torch.tensor(ref["x0"]))
    cfg = dataclasses.replace(_config(ref), max_iters=0)
    res = at.solvers.solve(problem, cfg)
    for k in ("prim", "dual"):
        got = getattr(res, f"{k}_infeas").numpy()
        np.testing.assert_allclose(got, ref[k][:, 0], rtol=1e-5, err_msg=k)


@pytest.mark.slow
def test_fp32_fixture_matches_a_live_jax_solve(tmp_path):
    """Rerun the JAX float32 solve of the fixture (about 4 minutes of XLA
    compilation, in a process of its own: the tests run JAX with x64 on,
    the bench with it off) and check the committed file against it."""
    out = tmp_path / "ref32.npz"
    subprocess.run([sys.executable, str(ROOT / "tools" / "torch_talos_fp32_fixture.py"),
                    str(out)], check=True, cwd=ROOT, timeout=1800)
    live, fix = _fixture(out), _fixture(FP32_FIXTURE)
    assert set(live) == set(fix)
    for k, v in live.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(fix[k], v, rtol=1e-6, err_msg=k)
        else:
            assert np.array_equal(fix[k], v), k


@pytest.mark.slow
def test_fixture_matches_a_live_jax_solve(tmp_path):
    """Rerun the JAX solve (about 4 minutes of XLA compilation) and check the
    committed fixture and the port against it."""
    spec = importlib.util.spec_from_file_location(
        "torch_talos_fixture", ROOT / "tools" / "torch_talos_fixture.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "ref.npz"
    tool.main(str(out))
    live, fix = _fixture(out), _fixture()
    assert set(live) == set(fix)
    for k, v in live.items():
        if v.dtype.kind in "fc":
            assert _rel_err(fix[k], v) < 1e-12, k
        else:
            assert np.array_equal(fix[k], v), k
    problem = convert.talos_problem_from_numpy(live, device="cpu")
    _check_against(at.solvers.solve(problem, _config(live)), live)
