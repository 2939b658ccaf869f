"""Gradients through the port's LQ solve (``gar.diff``), the inverse-LQR
example and the θ sensitivities, against the JAX package, float64 on the
CPU.

``gar.diff.solve`` is held against ``jax.grad`` through the JAX package's
``diff.solve`` (a ``jax.custom_vjp``) on the same numpy inputs; the θ
sensitivities against ``tests/data/torch_rollout_ref.npz``
(``tools/torch_rollout_fixture.py``) and against central finite
differences of converged values, to the tolerances of
``tests/test_sensitivity.py``. The card's launches are checked by
tests/test_torch_cuda.py.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from examples import inverse_lqr as jinv

import aligator_tpu_torch as at
from aligator_tpu_torch import convert
from aligator_tpu_torch.examples import inverse_lqr
from aligator_tpu_torch.gar import diff, lqr_problem, riccati

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_rollout_ref.npz"
MU = 1e-3
FIELDS = diff.KNOT_FIELDS + ("G0", "g0")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_rollout_fixture", ROOT / "tools" / "torch_rollout_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _torch_loss(sol):
    xs, us, vs, lams = sol
    return (us ** 2).sum() + (xs[:, -1] ** 2).sum() + (vs ** 2).sum() + (lams ** 3).sum()


def _to_port(arrays):
    return convert.lqr_problem_from_numpy({k: v[None] for k, v in arrays.items()},
                                          device="cpu")


def _port_grads(tp, explicit):
    leaves = {k: getattr(tp.knots, k) for k in diff.KNOT_FIELDS}
    leaves.update(G0=tp.G0, g0=tp.g0)
    for v in leaves.values():
        v.requires_grad_()
    sol = diff.solve(tp, MU, MU, explicit)
    _torch_loss(sol).backward()
    return {k: v.grad[0].numpy() for k, v in leaves.items()}, sol


def _fixture(prefix):
    with np.load(FIXTURE) as f:
        return {k[len(prefix):]: f[k] for k in f.files if k.startswith(prefix)}


@pytest.fixture(scope="module")
def grads():
    """The problems of ``tools/torch_rollout_fixture.py`` and the JAX
    package's gradients there: ``gar.random_problem(8, 3, 2, 1)`` as in
    tests/gar/test_diff.py, and a general-E convex problem (E = -I + 0.1
    N(0, 1))."""
    return {case: (_port_grads(_to_port(_fixture(f"diffin_{case}_")), explicit)[0],
                   _fixture(f"diff_{case}_"))
            for case, explicit in (("explicit", True), ("general_E", False))}


@pytest.mark.parametrize("case", ["explicit", "general_E"])
@pytest.mark.parametrize("field", FIELDS)
def test_diff_solve_grads_match_jax(grads, case, field):
    got, ref = grads[case]
    scale = max(1.0, np.abs(ref[field]).max())
    np.testing.assert_allclose(got[field], ref[field], rtol=0, atol=1e-8 * scale,
                               err_msg=f"{case} {field}")


def test_diff_solve_forward_is_the_routed_solve():
    """The Function's forward is riccati.solve; θ blocks get zero gradients."""
    tp = lqr_problem.random_convex_problem(np.random.default_rng(4), 3, 5, 2, 1, 1,
                                           device="cpu")
    tp = dataclasses.replace(tp, knots=lqr_problem.add_parameterization(tp.knots, 2))
    tp.knots.Gx.requires_grad_()
    tp.knots.Q.requires_grad_()
    sol = diff.solve(tp, MU, MU, True)
    ref = riccati.solve(tp, MU, MU, True)
    for a, b in zip(sol, ref):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    _torch_loss(sol).backward()
    assert tp.knots.Gx.grad.abs().max() == 0 and tp.knots.Q.grad.abs().max() > 0


def test_inverse_lqr_gradient_matches_jax():
    """The example's loss and its gradient at the starting weights, against
    the JAX package's vmapped solve (N = 10, 4 demonstrations)."""
    tool = _tool()
    ref = _fixture("inverse_lqr_")
    jt = jinv.make_problem_template(N=tool.INV_N)
    template = convert.inverse_lqr_template_from_numpy(
        dict(A=jt.knots.A[0], B=jt.knots.B[0]), nsteps=tool.INV_N, device="cpu")
    tx0 = torch.tensor(tool.inverse_lqr_x0s())
    with torch.no_grad():
        txe, tue = inverse_lqr.solve_traj(
            template, torch.log(torch.tensor(inverse_lqr.WQ_TRUE, dtype=torch.float64)),
            torch.log(torch.tensor(inverse_lqr.WR_TRUE, dtype=torch.float64)), tx0)
    np.testing.assert_allclose(txe.numpy(), ref["xs_e"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(tue.numpy(), ref["us_e"], rtol=0, atol=1e-10)
    q = torch.zeros(4, dtype=torch.float64, requires_grad=True)
    r = torch.zeros(2, dtype=torch.float64, requires_grad=True)
    xs, us = inverse_lqr.solve_traj(template, q, r, tx0)
    loss = ((xs - txe) ** 2).mean() + ((us - tue) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-10)
    for got, want in ((q.grad, ref["grad_q"]), (r.grad, ref["grad_r"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-8 * np.abs(want).max())


def test_inverse_lqr_loss_falls():
    template = inverse_lqr.make_problem_template(N=10, device="cpu")
    x0s = torch.tensor(np.random.default_rng(6).standard_normal((4, 4)))
    _, _, losses = inverse_lqr.fit(template, x0s, steps=40)
    assert losses[-1] < 0.05 * losses[0]


def _family(case):
    tool = _tool()
    u_bound, opts = tool.SENS_CASES[case]
    return (convert.theta_family_from_numpy(
        dict(A=[[1.0, 0.1], [0.0, 1.0]], B=[[0.0], [0.1]], Q=0.01 * np.eye(2),
             R=[[0.01]], w_term=10.0 * np.eye(2), x0=[1.0, 0.0]),
        nsteps=20, device="cpu", u_bound=u_bound), at.solvers.ProxDDPConfig(**opts))


@pytest.mark.parametrize("case", ["free", "box"])
def test_theta_sensitivities_match_jax(case):
    """th_grad and th_hess of 4 values of θ against the JAX package's
    solve_with_sensitivities, to 1e-8."""
    pf, cfg = _family(case)
    with np.load(FIXTURE) as f:
        thetas = f["thetas"]
        ref = {k[len(f"sens_{case}_"):]: f[k] for k in f.files
               if k.startswith(f"sens_{case}_")}
    got = at.solvers.solve_with_sensitivities(pf, torch.tensor(thetas), cfg)
    np.testing.assert_array_equal(got.num_iters.numpy(), ref["num_iters"])
    assert got.conv.all() and ref["conv"].all()
    if case == "box":
        assert got.us.abs().max() > 0.119  # the bound is active
    for k in ("xs", "us", "th_grad", "th_hess"):
        np.testing.assert_allclose(getattr(got, k).numpy(), ref[k], rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(ref[k]).max()), err_msg=k)


@pytest.mark.parametrize("case", ["free", "box"])
def test_th_grad_matches_finite_differences(case):
    """th_grad against central differences of converged values (the
    tolerances of tests/test_sensitivity.py), and th_hess unconstrained
    against central differences of th_grad."""
    pf, cfg = _family(case)
    th0 = torch.tensor([[0.3, -0.2], [0.5, 0.0]], dtype=torch.float64)
    res = at.solvers.solve_with_sensitivities(pf, th0, cfg)
    assert res.conv.all()
    eps, tol = 1e-5, (5e-5 if case == "free" else 1e-3)
    for j in range(2):
        e = torch.zeros(2, dtype=torch.float64)
        e[j] = eps
        both = at.solvers.solve(pf(torch.cat([th0 + e, th0 - e])), cfg).traj_cost
        fd = (both[:2] - both[2:]) / (2 * eps)
        assert ((res.th_grad[:, j] - fd).abs() <= tol * fd.abs().clamp(min=1.0)).all()
    if case == "free":
        assert (res.th_hess - res.th_hess.mT).abs().max() < 1e-8
        eps = 1e-4
        cols = []
        for j in range(2):
            e = torch.zeros(2, dtype=torch.float64)
            e[j] = eps
            g = at.solvers.solve_with_sensitivities(
                pf, torch.cat([th0 + e, th0 - e]), cfg).th_grad
            cols.append((g[:2] - g[2:]) / (2 * eps))
        H_fd = torch.stack(cols, -1)
        assert (res.th_hess - H_fd).abs().max() < 1e-4 * (1.0 + H_fd.abs().max())
