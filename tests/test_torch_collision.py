"""The port's remaining multibody residuals and the examples that the
collision residuals unlock, against the JAX package, float64 on the CPU.

The residuals of ``modelling/multibody/extra_residuals.py`` (frame and
link collision, fly-high, DCM, centroidal momentum and its derivative,
ballistic landing), the upper-body humanoid, and the examples
``ur5_ballistic``, ``panda_reach`` (nominal Panda), ``quadrotor`` (without
and with its terminal constraint), ``talos_arms`` and ``dual_ffsr_reach``
with its two collision flags: their problems' derivatives and, for the
Panda and the quadrotor, solves cut to 4 iterations, held against
``tests/data/torch_collision_ref.npz`` (``tools/torch_collision_fixture.py``;
the ``slow`` test reruns its problem and solve groups live). The card runs
are checked by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from aligator_tpu_torch import convert
from aligator_tpu_torch.core import problem as problem_mod
from aligator_tpu_torch.examples import (dual_ffsr_reach, panda_reach, quadrotor, talos_arms,
                                         ur5_ballistic)
from aligator_tpu_torch.modelling.multibody import humanoid
from test_torch_geometry import (FIXTURE, TOL, TOL_PROB, TOOL, _close, _fixture, _t,
                                 check_residual, small_solve_matches)

torch.set_num_threads(2)

EXTRA_RESIDUALS = [n for n, spec in TOOL.RESIDUALS.items() if spec[0] == "extra_residuals"]


@pytest.mark.parametrize("name", EXTRA_RESIDUALS)
def test_extra_residuals_match_jax(name):
    """Each residual of extra_residuals.py (on the UR5, the upper body and
    the free-flying humanoid): value and the generic forward-mode
    Jacobians, to 1e-10."""
    check_residual(name, TOL)


def test_upper_body_matches_jax():
    """make_humanoid_upper_body's leaves and topology and
    upper_body_effort_limits against the JAX package's."""
    TOOL._jax()
    from aligator_tpu.modelling.multibody import humanoid as jh

    ref = TOOL.model_leaves(jh.make_humanoid_upper_body())
    got = humanoid.make_humanoid_upper_body(device="cpu")
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(got, k).numpy(), v, err_msg=k)
        elif v is not None:
            assert tuple(getattr(got, k)) == tuple(v), k
    np.testing.assert_array_equal(humanoid.upper_body_effort_limits(device="cpu").numpy(),
                                  np.asarray(jh.upper_body_effort_limits()))


CONVERT = {
    "ur5_ballistic": (convert.ur5_ballistic_problem_from_numpy,
                      lambda n: ur5_ballistic.create_ballistic_problem(nsteps=n, device="cpu")),
    "panda": (convert.panda_reach_problem_from_numpy,
              lambda n: panda_reach.create_panda_problem(nsteps=n, device="cpu")),
    "quadrotor": (convert.quadrotor_problem_from_numpy,
                  lambda n: quadrotor.create_quadrotor_problem(nsteps=n, device="cpu")),
    "quadrotor-term": (lambda p, nsteps, device: convert.quadrotor_problem_from_numpy(
                           p, nsteps=nsteps, term_cstr=True, device=device),
                       lambda n: quadrotor.create_quadrotor_problem(
                           nsteps=n, term_cstr=True, device="cpu")),
    "talos_arms": (convert.talos_arms_problem_from_numpy,
                   lambda n: talos_arms.create_talos_arms_problem(nsteps=n, device="cpu")),
    "ffsr": (lambda p, nsteps, device: convert.ffsr_reach_problem_from_numpy(
                 p, nsteps=nsteps, with_collision=True, with_self_collision=True,
                 device=device),
             lambda n: dual_ffsr_reach.create_ffsr_problem(
                 nsteps=n, with_collision=True, with_self_collision=True, device="cpu")),
}


@pytest.mark.parametrize("case", list(CONVERT))
def test_problems_match_jax(case):
    """Each example's problem (a few stages), converted from the JAX
    problem's leaves and built by the port's own builder:
    compute_derivatives along a seeded trajectory (costs, dynamics and
    their derivatives, constraints, terminal constraints) against the JAX
    package's, to 1e-9."""
    ref = _fixture(f"prob_{case}_")
    n = TOOL.PROB_SIZES[case]
    conv, build = CONVERT[case]
    xs, us = _t(ref["xs"])[None], _t(ref["us"])[None]
    for label, prob in (("converted", conv(TOOL.params(case, n), nsteps=n, device="cpu")),
                        ("built", build(n))):
        got = problem_mod.compute_derivatives(prob, xs, us)
        for f, r in ref.items():
            if f not in ("xs", "us"):
                _close(getattr(got, f)[0], r, TOL_PROB, f"{label} {f}")


@pytest.mark.parametrize("case", ["panda", "quadrotor"])
def test_solves_match_jax(case):
    """ProxDDP (nonlinear rollout) on the Panda reach with its post and on
    the quadrotor (N = 10, two perturbed starts), cut to 4 iterations,
    against the JAX package's one-at-a-time solves
    (test_torch_geometry.small_solve_matches)."""
    np.testing.assert_array_equal(_fixture(f"{case}_")["x0s"], TOOL.small_x0s(case, 2))
    build = CONVERT[case][1]
    small_solve_matches(case, build)


@pytest.mark.slow
def test_fixture_matches_a_live_jax_solve():
    """The problems' derivatives and the small solves of the fixture
    computed live by the JAX package."""
    live = TOOL.references(("prob", "small"))
    with np.load(FIXTURE) as f:
        for k, v in live.items():
            np.testing.assert_allclose(f[k], v, rtol=1e-12, atol=1e-12, err_msg=k)
