"""The port's plain multibody dynamics taken at the first joint, float64 on
the CPU.

``model.aba`` (the free-dynamics kernel's plain version) and the contact
dynamics (``contact.cfd_internals`` and the derivative pass) compute every
spatial quantity in a world frame translated to the first joint, as
``csrc/free_fd.cu`` does. On ordinary states they still match the JAX
package's, which works at the world origin, to 1e-10 relative
(``tests/test_torch_free.py::test_algorithms_match_jax`` on five models,
``tests/test_torch_contact.py::test_contact_kinematics_and_kkt_match_jax`` with
position references). Here: they no longer depend on where the robot is.
A free-flying base moved by 5e9 m (which an exploding line-search trial
reaches) gives the dynamics at the origin, to 1e-10 for ``model.aba`` and
to the bound that rounding the world position references at 5e9 allows
for the contact dynamics; at the world origin the spatial inertias' m ĉĉ
terms cancelled to garbage there.
"""

import numpy as np
import pytest
import torch

from aligator_tpu_torch.modelling.multibody import contact, derivatives, quadruped, robots
from aligator_tpu_torch.modelling.multibody import model as rbd

torch.set_num_threads(2)
TOL = 1e-10
FAR = 5e9  # m: where the FFSR's exploding line-search trials took its base


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def _far(model, q):
    """``q`` with the free-flyer base translated by FAR along (1, −1, 1)."""
    q = q.clone()
    q[..., :3] += FAR * torch.tensor([1.0, -1.0, 1.0], dtype=q.dtype)
    return q


@pytest.mark.parametrize("name", ["make_dual_arm_ffsr", "make_free_sphere"])
def test_aba_far_from_the_origin_matches_the_origin(name):
    """model.aba and its analytic derivatives with the base at 5e9 m equal
    those at the origin to 1e-10 relative (at the world origin the base's
    spatial inertia m ĉĉ ~ 1e21 cancels to garbage)."""
    m = getattr(robots, name)(device="cpu")
    rng = np.random.default_rng(21)
    B = 6
    q = m.configuration_space().integrate(
        m.neutral()[None], torch.tensor(0.5 * rng.standard_normal((B, m.nv))))
    v, tau = (torch.tensor(rng.standard_normal((B, m.nv))) for _ in range(2))
    near, far = rbd.aba(m, q, v, tau), rbd.aba(m, _far(m, q), v, tau)
    assert torch.isfinite(far).all()
    assert _rel(far, near) <= TOL
    d_near = derivatives.aba_derivatives(m, q, v, tau)
    d_far = derivatives.aba_derivatives(m, _far(m, q), v, tau)
    for a, b in zip(d_far[:3], d_near[:3]):
        assert _rel(a, b) <= TOL


def test_contact_dynamics_far_from_the_origin_matches_the_origin():
    """The quadruped's contact dynamics (four world point feet, position
    references at kp = 50) and the derivative pass, with the base and the
    references moved by 5e9 m, against those at the origin. The references
    are rounded at 5e9 to within 5e9·eps (about 1.1e-6 m); that error,
    kp·5e9·eps in the Baumgarte term γ, moves the acceleration and the
    forces by at most their sensitivities to γ times it: the bound here is
    4 times that product. With the base and the references the far problem
    actually holds (each rounded at 5e9, less 5e9, computed exactly) the two
    agree to 1e-10."""
    m = quadruped.make_quadruped(device="cpu")
    frames = tuple(m.frame_id(f"foot{k}") for k in range(4))
    rng = np.random.default_rng(22)
    B = 4
    q0 = quadruped.standing_configuration(m)
    q = m.configuration_space().integrate(q0[None],
                                          torch.tensor(0.05 * rng.standard_normal((B, m.nv))))
    v = torch.tensor(0.2 * rng.standard_normal((B, m.nv)))
    tau = torch.tensor(rng.standard_normal((B, m.nv)))
    act = torch.ones(B, 4, dtype=torch.float64)
    act[1, 2] = 0.0
    p_refs = torch.stack([rbd.frame_placement(m, q, f)[1] for f in frames], -2)
    p_refs = p_refs + torch.tensor(0.01 * rng.standard_normal((B, 4, 3)))
    shift = FAR * torch.tensor([1.0, -1.0, 1.0], dtype=torch.float64)
    kp, eps = 50.0, torch.finfo(torch.float64).eps
    kw = dict(prox_mu=1e-8, kp=kp, kd=10.0)

    near = contact.cfd_internals(m, q, v, tau, frames, act, p_refs=p_refs, **kw)
    q_far, far_refs = _far(m, q), p_refs + shift
    far = contact.cfd_internals(m, q_far, v, tau, frames, act, p_refs=far_refs, **kw)
    # what the far problem holds: its base and references rounded at 5e9,
    # taken back to the origin exactly
    q_held = q_far.clone()
    q_held[..., :3] -= shift
    held = contact.cfd_internals(m, q_held, v, tau, frames, act, p_refs=far_refs - shift,
                                 **kw)
    for k in ("a", "lam"):
        assert torch.isfinite(far[k]).all()
        assert _rel(far[k], held[k]) <= TOL, k
    # the sensitivities of (a, λ) to γ: λ = G⁻¹(J a_free + γ), a = a_free − M⁻¹Jᵀλ
    Ginv = torch.linalg.inv(near["G"])
    dlam = Ginv.abs().sum(-1).amax()
    da = (near["MinvJt"] @ Ginv).abs().sum(-1).amax()
    err = kp * FAR * eps
    assert (far["a"] - near["a"]).abs().max() <= 4 * da * err
    assert (far["lam"] - near["lam"]).abs().max() <= 4 * dlam * err
    # the derivative pass (K5's plain rows and the KKT solves) alike
    d_far = derivatives.constrained_fd_derivatives(m, q_far, v, tau, frames, act,
                                                   p_refs=far_refs, **kw)
    d_held = derivatives.constrained_fd_derivatives(m, q_held, v, tau, frames, act,
                                                    p_refs=far_refs - shift, **kw)
    for a, b in zip(d_far, d_held):
        assert torch.isfinite(a).all()
        assert _rel(a, b) <= 1e-8

