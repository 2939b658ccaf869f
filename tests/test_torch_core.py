"""The port's core layer (aligator_tpu_torch.core) against the JAX package:
constraint sets, autodiff-default derivatives, vector-space problems."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligator_tpu import core as jcore
from aligator_tpu._pytree import pytree_dataclass
from aligator_tpu.core import problem as jproblem

from aligator_tpu_torch import core as tcore
from aligator_tpu_torch.core import problem as tproblem

torch.set_num_threads(2)


def _set_pairs():
    lo, hi = np.array([-0.5, -1.0, 0.0]), np.array([0.5, 1.0, 2.0])
    return [
        (jcore.EqualityConstraint(), tcore.EqualityConstraint()),
        (jcore.NegativeOrthant(), tcore.NegativeOrthant()),
        (jcore.BoxConstraint(lower=jnp.asarray(lo), upper=jnp.asarray(hi)),
         tcore.BoxConstraint(lower=torch.tensor(lo), upper=torch.tensor(hi))),
        (jcore.L1Penalty(scale=0.7), tcore.L1Penalty(scale=0.7)),
    ]


@pytest.mark.parametrize("index", range(4))
def test_constraint_sets_match_jax(index):
    js, ts = _set_pairs()[index]
    z = np.random.default_rng(index).standard_normal((5, 3)) * 2.0
    mu = 0.3
    js, ts = js.set_prox_parameter(mu), ts.set_prox_parameter(mu)
    tz = torch.tensor(z)
    for op in ("projection", "normal_cone_projection", "active_mask"):
        np.testing.assert_array_equal(getattr(ts, op)(tz).numpy(),
                                      np.asarray(getattr(js, op)(jnp.asarray(z))))
    jenv = jax.vmap(lambda zz: js.moreau_envelope(zz, mu))(jnp.asarray(z))
    np.testing.assert_allclose(ts.moreau_envelope(tz, mu).numpy(), np.asarray(jenv),
                               rtol=1e-14)
    # a product set splits the stacked residual
    jp = jcore.ConstraintSetProduct(sets=(js, jcore.NegativeOrthant()), dims=(3, 2))
    tp = tcore.ConstraintSetProduct(sets=(ts, tcore.NegativeOrthant()), dims=(3, 2))
    z5 = np.concatenate([z, z[:, :2]], -1)
    np.testing.assert_array_equal(
        tp.normal_cone_projection(torch.tensor(z5)).numpy(),
        np.asarray(jp.normal_cone_projection(jnp.asarray(z5))),
    )


@pytree_dataclass
class _JaxCurvedCost(jcore.Cost):
    w: jax.Array

    def value(self, space, x, u):
        return jnp.sum(self.w * jnp.sin(x)) * jnp.sum(u * u) + jnp.cos(x[0] * u[1])


class _TorchCurvedCost(tcore.Cost):
    def __init__(self, w):
        self.w = w

    def value(self, space, x, u):
        return (self.w * torch.sin(x)).sum(-1) * (u * u).sum(-1) + torch.cos(
            x[..., 0] * u[..., 1]
        )


@pytree_dataclass
class _JaxCurvedResidual(jcore.functions.StageFunction):
    def value(self, space, x, u):
        return jnp.stack([x[0] * u[0], jnp.sin(x[1]) + u[1] ** 2])


class _TorchCurvedResidual(tcore.StageFunction):
    def dim(self, space, nu):
        return 2

    def value(self, space, x, u):
        return torch.stack([x[..., 0] * u[..., 0], torch.sin(x[..., 1]) + u[..., 1] ** 2], -1)


def test_autodiff_defaults_match_jax():
    """Cost gradients/Hessians and stage-function Jacobians by the default
    autodiff path, on a batch of points of a vector space."""
    rng = np.random.default_rng(3)
    x, u = rng.standard_normal((4, 5, 3)), rng.standard_normal((4, 5, 2))
    w = np.array([0.5, -1.0, 2.0])
    jspace, tspace = jcore.VectorSpace(3), tcore.VectorSpace(3)
    jc, tc = _JaxCurvedCost(w=jnp.asarray(w)), _TorchCurvedCost(torch.tensor(w))
    tx, tu = torch.tensor(x), torch.tensor(u)
    flat = lambda f: jax.jit(jax.vmap(jax.vmap(f)))  # noqa: E731
    jg = flat(lambda a, b: jc.gradients(jspace, a, b))(x, u)
    jh = flat(lambda a, b: jc.hessians(jspace, a, b))(x, u)
    for r, g in zip(jg + jh, tc.gradients(tspace, tx, tu) + tc.hessians(tspace, tx, tu)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-12)
    jr, tr = _JaxCurvedResidual(), _TorchCurvedResidual()
    jj = flat(lambda a, b: jr.jacobians(jspace, a, b))(x, u)
    for r, g in zip(jj, tr.jacobians(tspace, tx, tu)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-12)


def test_linear_vector_space_problem_derivatives_match_jax():
    """A vector-space problem with linear dynamics, a quadratic cost and a
    control box: evaluation and derivatives against the JAX package."""
    rng = np.random.default_rng(4)
    nx, nu, N, B = 3, 2, 4, 2
    A = np.eye(nx) + 0.1 * rng.standard_normal((nx, nx))
    Bm = rng.standard_normal((nx, nu))
    c = 0.1 * rng.standard_normal(nx)
    Q, R = np.diag([1.0, 2.0, 0.5]), 0.1 * np.eye(nu)
    Nc = 0.05 * rng.standard_normal((nx, nu))
    q, r = rng.standard_normal(nx), rng.standard_normal(nu)
    x0s = rng.standard_normal((B, nx))
    xs, us = rng.standard_normal((B, N + 1, nx)), 2 * rng.standard_normal((B, N, nu))

    def build(m, space, t):
        cost = m.QuadraticCost.create(t(Q), t(R), N=t(Nc), q=t(q), r=t(r), c=0.3)
        dyn = m.LinearDiscreteDynamics(A=t(A), B=t(Bm), c=t(c))
        cstr = ((m.ControlErrorResidual(target=t(np.zeros(nu))),
                 m.BoxConstraint(lower=t(-np.ones(nu)), upper=t(np.ones(nu)))),)
        stage = m.make_stage(cost, dyn, space, nu, cstr)
        term = m.QuadraticCost.create(t(10 * Q), t(np.zeros((nu, nu))))
        return stage, term

    jstage, jterm = build(jcore, jcore.VectorSpace(nx), jnp.asarray)
    tstage, tterm = build(tcore, tcore.VectorSpace(nx), torch.tensor)
    tprob = tcore.make_problem(torch.tensor(x0s), tstage, N, tterm)
    jprob = jcore.make_problem(jnp.asarray(x0s[0]), jstage, N, jterm)
    got = tproblem.compute_derivatives(tprob, torch.tensor(xs), torch.tensor(us))
    ref = jax.jit(jax.vmap(lambda x0, a, b: jproblem.compute_derivatives(
        jproblem.TrajOptProblem(
            stages=jprob.stages, term_cost=jprob.term_cost, x0=x0,
            nsteps=N, term_cstr_dims=(),
        ), a, b,
    )))(jnp.asarray(x0s), jnp.asarray(xs), jnp.asarray(us))
    assert tprob.nc == 2
    for f in ("cost", "init_res", "dyn_res", "cstr_vals", "Lx", "Lu", "Lxx",
              "Lxu", "Luu", "A", "B", "E", "cstr_Jx", "cstr_Ju", "init_Jx"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-12,
                                   err_msg=f)


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line."""
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(root / "chip_smoke.py")], cwd=root, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
