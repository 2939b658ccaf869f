"""Panda SE(3) reach with collision avoidance and torque limits.

Port of ``examples/panda_reach.py``: the flange reaches a full SE(3) pose
(placement and terminal velocity costs) past a vertical capsule post that
the flange and the elbow must clear
(:class:`~..modelling.multibody.extra_residuals.FrameCollisionResidual`),
under the Panda's torque limits, the free multibody dynamics and
semi-implicit Euler (N = 50, dt = 0.02). The published configuration
solves it with ``ProxDDPConfig(tol=1e-4, mu_init=1e-2, max_iters=300,
rollout="nonlinear")``. With ``real_model`` (the default, as in the JAX
example) the Panda is the real one read from its MJCF file
(:func:`~..modelling.multibody.robots.make_panda_real`: its inertials and
joint armature), and the nominal
:func:`~..modelling.multibody.robots.make_panda` where that file is absent.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from .. import core
from .._device import resolve
from ..modelling import IntegratorSemiImplEuler
from ..modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from ..modelling.multibody.extra_residuals import FrameCollisionResidual
from ..modelling.multibody.mjcf_export import model_to_mjcf
from ..modelling.multibody.model import RobotModel
from ..modelling.multibody.residuals import FramePlacementResidual, FrameVelocityResidual
from ..modelling.multibody.robots import (PANDA_EFFORT_LIMIT, PANDA_Q_HOME, make_panda,
                                          make_panda_real)

SOLVE_OPTIONS = dict(tol=1e-4, mu_init=1e-2, max_iters=300, rollout="nonlinear")
# the per-joint armature of MuJoCo Menagerie's franka_emika_panda/panda.xml
# (its "panda" default class), given to the Panda that write_panda_mjcf writes
MENAGERIE_ARMATURE = 0.1
START_SCALE = 0.05  # initial_states: the home posture + START_SCALE·N(0, 1) on q
P_TARGET = (0.35, 0.45, 0.35)
R_TARGET = ((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0))  # flange pointing down
POST = ((0.25, 0.25, 0.0), (0.25, 0.25, 0.9))  # the post's axis
POST_RADIUS = 0.12  # its radius and the margin


def panda_reach_problem(model: RobotModel, x0: Tensor, R_target: Tensor, p_target: Tensor,
                        w_pose: Tensor, w_u: Tensor, w_term_pose: Tensor, w_term_vel: Tensor,
                        effort: Tensor, timestep: Tensor, nsteps: int,
                        post: tuple | None = None) -> core.TrajOptProblem:
    """The reach from its leaves: stage cost dt·(½‖log₆(M_ref⁻¹ M_ee)‖²_{w_pose}
    + ½‖u‖²_{w_u}), terminal cost ½‖log₆‖²_{w_term_pose} +
    ½‖v_ee‖²_{w_term_vel}, |τ| <= effort, initial states ``x0 (B, 14)``;
    ``post = (seg_a, seg_b, radius)`` keeps the frames "ee" and "elbow"
    ``radius`` away from the segment."""
    nv = model.nv
    space = model.phase_space()
    ode = MultibodyFreeFwdDynamics(model=model, actuation=torch.eye(
        nv, dtype=x0.dtype, device=x0.device))
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=timestep)
    ee = model.frame_id("ee")
    pose = FramePlacementResidual(model=model, R_ref=R_target, p_ref=p_target, frame_id=ee)
    vel = FrameVelocityResidual(model=model, v_ref=x0.new_zeros(6), frame_id=ee)
    rcost = core.CostStack.create(
        core.QuadraticResidualCost(residual=pose, weights=w_pose * timestep),
        core.QuadraticControlCost(w_u * timestep))
    term_cost = core.CostStack.create(
        core.QuadraticResidualCost(residual=pose, weights=w_term_pose),
        core.QuadraticResidualCost(residual=vel, weights=w_term_vel))
    constraints = [(core.ControlErrorResidual(target=effort.new_zeros(nv)),
                    core.BoxConstraint(lower=-effort, upper=effort))]
    if post is not None:
        seg_a, seg_b, radius = post
        for fid in (ee, model.frame_id("elbow")):
            constraints.append((FrameCollisionResidual(
                model=model, seg_a=seg_a, seg_b=seg_b, radius=radius, frame_id=fid),
                core.NegativeOrthant()))
    stage = core.make_stage(rcost, dyn, space, nv, tuple(constraints))
    return core.make_problem(x0, stage, nsteps, term_cost)


def armature_panda(dtype=torch.float64, device="cuda") -> RobotModel:
    """The nominal :func:`make_panda` with the real file's flange name and
    Menagerie's armature: its flange frame renamed ``attachment`` (joint 6,
    z 0.107, as the ``attachment`` of ``panda_nohand.xml``) and
    ``MENAGERIE_ARMATURE`` on each of its 7 dofs."""
    model = make_panda(dtype=dtype, device=device)
    names = tuple("attachment" if n == "ee" else n for n in model.frame_names)
    return dataclasses.replace(model, frame_names=names, armature=torch.full(
        (model.nv,), MENAGERIE_ARMATURE, dtype=dtype, device=model.mass.device))


def write_panda_mjcf(path) -> str:
    """Write :func:`armature_panda` as MJCF text (:func:`model_to_mjcf`) to
    ``path``, for :func:`make_panda_real` to read back where the vendored
    file is absent; returns the text."""
    text = model_to_mjcf(armature_panda(device="cpu"), name="panda")
    with open(path, "w") as f:
        f.write(text)
    return text


def initial_states(batch: int, seed: int) -> np.ndarray:
    """``(batch, 14)`` starts: the home posture + START_SCALE·N(0, 1) on the
    joint angles (numpy, seeded), at rest. The first rows do not depend on
    ``batch``."""
    x = np.zeros((batch, 14))
    x[:, :7] = PANDA_Q_HOME + START_SCALE * np.random.default_rng(seed).standard_normal(
        (batch, 7))
    return x


def create_panda_problem(nsteps: int = 50, timestep: float = 0.02,
                         with_collision: bool = True, dtype=torch.float64,
                         real_model: bool = True, device="cuda") -> core.TrajOptProblem:
    """The published reach, one scenario from the home posture at rest;
    replace ``x0`` by a ``(B, 14)`` batch to solve B scenarios. The model is
    the real Panda (:func:`make_panda_real`) with ``real_model`` where its
    MJCF file exists, else the nominal one, as the JAX example chooses."""
    dev = resolve(device)
    model = None
    if real_model:
        try:
            model, _ = make_panda_real(dtype=dtype, device=dev)
        except FileNotFoundError:
            pass
    if model is None:
        model = make_panda(dtype=dtype, device=dev)
    nv = model.nv

    def t(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    x0 = torch.cat([t(PANDA_Q_HOME), torch.zeros(nv, dtype=dtype, device=dev)])
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    post = (t(POST[0]), t(POST[1]), t(POST_RADIUS)) if with_collision else None
    return panda_reach_problem(
        model, x0[None], t(R_TARGET), t(P_TARGET), 10.0 * eye6,
        1e-4 * torch.eye(nv, dtype=dtype, device=dev), 100.0 * eye6, 50.0 * eye6,
        t(PANDA_EFFORT_LIMIT), t(timestep), nsteps, post=post)


if __name__ == "__main__":
    import argparse

    from .. import solvers
    from ..modelling.multibody import model as rbd

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    problem = create_panda_problem(device=args.device)
    res = solvers.solve(problem, solvers.ProxDDPConfig(**SOLVE_OPTIONS))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    model = problem.stages.dynamics.ode.model
    R, p = rbd.frame_placement(model, res.xs[0, -1, :model.nq], model.frame_id("ee"))
    print("pos error:", float((p - torch.tensor(P_TARGET, dtype=p.dtype,
                                                device=p.device)).norm()))
