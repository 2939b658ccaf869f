"""Carry problem parameters across from numpy.

The port's problems have no trained weights: their parameters are the
problem's leaves. These functions build the port's problems from numpy
copies of the leaves of the JAX package's problems, so that the same
instance can be handed to both (the dtype of the arrays is kept).
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve
from .examples.cartpole import cartpole_problem
from .examples.centroidal_locomotion import centroidal_problem
from .examples.continuous_centroidal import continuous_problem
from .examples.dual_ffsr_reach import ffsr_reach_problem
from .examples.flexible_double_pendulum import flexible_pendulum_problem
from .examples.inverse_lqr import lqr_template
from .examples.linear_euler import linear_euler_problem
from .examples.medium_dims import linear_problem
from .examples.panda_reach import panda_reach_problem
from .examples.partial_initial_condition import partial_initial_condition_problem
from .examples.pendulum import swing_up_problem
from .examples.quadrotor import quadrotor_problem
from .examples.se2_car import se2_problem
from .examples.solo_jump import legged_problem
from .examples.solo_kinodynamics import kinodynamics_problem
from .examples.talos_arms import talos_arms_problem
from .examples.talos_walk import talos_walk_problem
from .examples.theta_family import double_integrator_family
from .examples.ur5_ballistic import ur5_ballistic_problem
from .examples.ur5_reach import ur5_reach_problem
from .examples.ur5_table import ur5_table_problem
from .examples.ur10_ballistic import ur10_ballistic_problem
from .examples.ur10_midpoint import ur10_midpoint_problem
from .examples.wheeled_inverted_pendulum import wip_problem
from .gar.lqr_problem import LQRKnots, LQRProblem
from .modelling.multibody import model as rbd

KNOT_FIELDS = ("Q", "S", "R", "q", "r", "A", "B", "E", "f", "C", "D", "d")
THETA_FIELDS = ("Gx", "Gu", "Gth", "gamma")


def _loader(params, device, dtype=None):
    dev = resolve(device)

    def t(name):
        return torch.tensor(np.asarray(params[name]), dtype=dtype, device=dev)

    return t


def lqr_problem_from_numpy(arrays, device="cuda") -> LQRProblem:
    """LQ problems from a mapping of the knot fields ``Q S R q r A B E f C D
    d`` (each ``(B, T, ...)``), ``G0 (B, nc0, nx)``, ``g0 (B, nc0)`` and,
    where the problems are parametric, the θ blocks ``Gx Gu Gth gamma``."""
    dev = resolve(device)

    def t(name):
        return torch.tensor(np.asarray(arrays[name]), device=dev)

    names = KNOT_FIELDS + tuple(k for k in THETA_FIELDS if k in arrays)
    knots = LQRKnots(**{k: t(k) for k in names})
    return LQRProblem(knots=knots, G0=t("G0"), g0=t("g0"))


def linear_problem_from_numpy(params, nsteps: int, device="cuda"):
    """A linear-quadratic problem (:func:`~.examples.medium_dims.linear_problem`)
    from its leaves: ``A (nx, nx)``, ``B (nx, nu)``, ``c (nx,)``, the stage
    weights ``Q``, ``R``, the terminal weight ``Q_term``, ``x0 (B, nx)`` (or
    ``(nx,)``) and, where the problem has a control box, ``u_lower`` and
    ``u_upper``."""
    dev = resolve(device)

    def t(name):
        return torch.tensor(np.asarray(params[name]), device=dev)

    u_box = None
    if "u_lower" in params:
        u_box = (t("u_lower"), t("u_upper"))
    return linear_problem(t("A"), t("B"), t("c"), t("Q"), t("R"),
                          t("Q_term"), t("x0"), nsteps, u_box=u_box)


def se2_problem_from_numpy(params, nsteps: int = 50, device="cuda",
                           u_bound=None):
    """The SE(2) car problem from its leaves: ``x0 (B, 4)`` (or ``(4,)``),
    ``w_x`` and ``w_u`` the stage state and control weights, ``w_term`` the
    terminal weight, ``target (4,)`` and the scalar ``timestep``."""
    dev = resolve(device)

    def t(name):
        return torch.tensor(np.asarray(params[name]), device=dev)

    return se2_problem(
        x0=t("x0"), w_x=t("w_x"), w_u=t("w_u"),
        w_term=t("w_term"), target=t("target"), timestep=t("timestep"),
        nsteps=nsteps, u_bound=u_bound,
    )


def robot_model_from_numpy(params, dtype=None, device="cuda") -> rbd.RobotModel:
    """A :class:`~.modelling.multibody.model.RobotModel` from its leaves
    ``jplac_p jplac_q axes mass com inertia gravity fplac_p fplac_q``, the
    optional per-dof ``armature`` (absent or None: none) and its topology
    ``joint_types parents frame_parents frame_names`` (sequences); ``dtype``
    defaults to the arrays' own."""
    dev = resolve(device)
    leaves = {k: torch.tensor(np.asarray(params[k]), dtype=dtype, device=dev)
              for k in rbd.LEAVES}
    arm = params.get("armature")
    return rbd.RobotModel(
        **leaves,
        armature=None if arm is None else torch.tensor(np.asarray(arm), dtype=dtype,
                                                       device=dev),
        joint_types=tuple(str(t) for t in params["joint_types"]),
        parents=tuple(int(i) for i in params["parents"]),
        frame_parents=tuple(int(i) for i in params["frame_parents"]),
        frame_names=tuple(str(n) for n in params["frame_names"]),
    )


def talos_problem_from_numpy(params, dtype=None, device="cuda"):
    """The Talos-walk problem (:func:`~.examples.talos_walk.talos_walk_problem`)
    from its leaves: the robot model's (:func:`robot_model_from_numpy`),
    ``x_ref (nx,)``, ``x0 (B, nx)``, ``state_weights``, ``control_weights``,
    ``term_weights``, the schedule ``active (N, 2)``, ``swing_weights (2,
    N, 3, 3)``, ``swing_targets (2, N, 3)``, ``swing_frames (2,)``,
    ``actuation (nv, nu)``, ``u_lower``, ``u_upper``, ``timestep``,
    ``contact_frames``, ``contact_dims``, ``kd`` and ``prox_mu``."""
    dev = resolve(device)

    def t(name):
        return torch.tensor(np.asarray(params[name]), dtype=dtype, device=dev)

    return talos_walk_problem(
        robot_model_from_numpy(params, dtype, dev), x_ref=t("x_ref"), x0=t("x0"),
        state_weights=t("state_weights"), control_weights=t("control_weights"),
        term_weights=t("term_weights"), active=t("active"),
        swing_weights=t("swing_weights"), swing_targets=t("swing_targets"),
        swing_frames=tuple(int(f) for f in params["swing_frames"]),
        actuation=t("actuation"), timestep=t("timestep"),
        contact_frames=tuple(int(f) for f in params["contact_frames"]),
        contact_dims=tuple(int(d) for d in params["contact_dims"]),
        kd=float(params["kd"]), prox_mu=float(params["prox_mu"]),
        u_box=(t("u_lower"), t("u_upper")),
    )


def cartpole_problem_from_numpy(params, nsteps: int = 100, device="cuda",
                                u_bound=None, integrator: str = "rk2"):
    """The cartpole problem (:func:`~.examples.cartpole.cartpole_problem`)
    from its leaves: ``x0 (B, 4)`` (or ``(4,)``), the scalars ``mc``,
    ``mp``, ``length``, ``gravity`` and ``timestep``, ``x_target (4,)`` and
    the weights ``w_x``, ``w_u``, ``w_term``."""
    t = _loader(params, device)
    return cartpole_problem(
        x0=t("x0"), mc=t("mc"), mp=t("mp"), length=t("length"),
        gravity=t("gravity"), timestep=t("timestep"), x_target=t("x_target"),
        w_x=t("w_x"), w_u=t("w_u"), w_term=t("w_term"), nsteps=nsteps,
        u_bound=u_bound, integrator=integrator,
    )


def linear_euler_problem_from_numpy(params, nsteps: int = 20, device="cuda"):
    """The linear-ODE Euler problem
    (:func:`~.examples.linear_euler.linear_euler_problem`) from its leaves
    ``A``, ``B``, ``c`` (the ODE), ``w_x``, ``w_u``, the scalar
    ``timestep`` and ``x0``."""
    t = _loader(params, device)
    return linear_euler_problem(t("A"), t("B"), t("c"), t("w_x"), t("w_u"),
                                t("timestep"), t("x0"), nsteps)


def partial_initial_condition_from_numpy(params, nsteps: int = 100,
                                         device="cuda"):
    """The partial-initial-condition problem
    (:func:`~.examples.partial_initial_condition.partial_initial_condition_problem`)
    from its leaves ``A``, ``B``, ``w_u``, ``w_term``, ``x0`` and the
    indices ``pinned`` of the constrained components."""
    t = _loader(params, device)
    return partial_initial_condition_problem(
        t("A"), t("B"), t("w_u"), t("w_term"), t("x0"),
        tuple(int(i) for i in params["pinned"]), nsteps)


def inverse_lqr_template_from_numpy(params, nsteps: int = 40, device="cuda"):
    """The inverse-LQR template (:func:`~.examples.inverse_lqr.lqr_template`)
    from the dynamics ``A (nx, nx)`` and ``B (nx, nu)``."""
    t = _loader(params, device)
    return lqr_template(t("A"), t("B"), nsteps)


def theta_family_from_numpy(params, nsteps: int = 20, device="cuda",
                            u_bound=None):
    """The θ family
    (:func:`~.examples.theta_family.double_integrator_family`) from its
    leaves ``A``, ``B``, ``Q``, ``R``, ``w_term`` and ``x0 (nx,)``; returns
    ``problem_of_theta``."""
    t = _loader(params, device)
    return double_integrator_family(t("A"), t("B"), t("Q"), t("R"), t("w_term"),
                                    t("x0"), nsteps, u_bound=u_bound)


def swing_up_problem_from_numpy(params, nsteps: int, u_bound=None, device="cuda"):
    """The swing-up of the pendulum, the double pendulum or the acrobot
    (:func:`~.examples.pendulum.swing_up_problem`) from the robot model's
    leaves (:func:`robot_model_from_numpy`), ``actuation (nv, nu)``, ``x0``,
    ``x_target``, the weights ``w_x``, ``w_u``, ``w_term`` and the scalar
    ``timestep``."""
    t = _loader(params, device)
    return swing_up_problem(robot_model_from_numpy(params, device=device), t("actuation"),
                            t("x0"), t("x_target"), t("w_x"), t("w_u"), t("w_term"),
                            t("timestep"), nsteps, u_bound=u_bound)


def ur5_reach_problem_from_numpy(params, nsteps: int = 40, tau_bound=80.0, device="cuda"):
    """The UR5 reach (:func:`~.examples.ur5_reach.ur5_reach_problem`) from the
    robot model's leaves, ``x0``, ``p_target``, the weights ``w_frame``,
    ``w_u``, ``w_v``, ``w_term`` and the scalar ``timestep``."""
    t = _loader(params, device)
    return ur5_reach_problem(robot_model_from_numpy(params, device=device), t("x0"),
                             t("p_target"), t("w_frame"), t("w_u"), t("w_v"), t("w_term"),
                             t("timestep"), nsteps, tau_bound=tau_bound)


def ffsr_reach_problem_from_numpy(params, nsteps: int = 60, with_collision: bool = False,
                                  with_self_collision: bool = False, device="cuda"):
    """The dual-arm FFSR reach
    (:func:`~.examples.dual_ffsr_reach.ffsr_reach_problem`, with its
    collision flags) from the robot model's leaves, ``x0``, the tool target
    poses ``R_targets (2, 3, 3)`` and ``p_targets (2, 3)`` (arm 1, arm 2),
    ``u_max (14,)`` and the scalar ``timestep``."""
    from .examples.dual_ffsr_reach import TOOLS

    t = _loader(params, device)
    targets = {n: (t("R_targets")[k], t("p_targets")[k]) for k, n in enumerate(TOOLS)}
    return ffsr_reach_problem(robot_model_from_numpy(params, device=device), t("x0"),
                              targets, t("u_max"), t("timestep"), nsteps,
                              with_collision=with_collision,
                              with_self_collision=with_self_collision)


TABLE_FIELDS = ("normal", "plane_offset", "offset", "radius", "axis", "half_len", "margin")
BOX_FIELDS = ("box_center", "box_rot", "half_extents", "offset", "radius", "margin")


def ur5_table_problem_from_numpy(params, nsteps: int = 30, device="cuda"):
    """The UR5 table reach (:func:`~.examples.ur5_table.ur5_table_problem`)
    from the robot model's leaves, ``x0``, ``p_target``, the weights
    ``w_frame``, ``w_u``, ``w_v``, ``w_term``, the scalars ``timestep`` and
    ``tau_bound``, the table keep-out's fields as ``table_<field>``
    (:data:`TABLE_FIELDS`) and, where the box is there, its fields
    (:data:`BOX_FIELDS`) under the keys ``box_center``, ``box_rot``,
    ``box_half_extents``, ``box_offset``, ``box_radius``, ``box_margin``."""
    t = _loader(params, device)

    def fields(prefix, names):
        return {n: t(prefix + n.removeprefix(prefix)) for n in names}

    box = fields("box_", BOX_FIELDS) if "box_center" in params else None
    return ur5_table_problem(
        robot_model_from_numpy(params, device=device), t("x0"), t("p_target"), t("w_frame"),
        t("w_u"), t("w_v"), t("w_term"), t("timestep"), nsteps, t("tau_bound"),
        fields("table_", TABLE_FIELDS), box)


def ur5_ballistic_problem_from_numpy(params, nsteps: int = 40, device="cuda"):
    """The UR5 throw (:func:`~.examples.ur5_ballistic.ur5_ballistic_problem`)
    from the robot model's leaves, ``x0``, ``target_xy``, the weights
    ``w_x``, ``w_u``, ``w_term`` (scaled as the stages use them) and the
    scalars ``tau_bound``, ``g`` (the landing's gravity), ``z_ground``,
    ``timestep``."""
    t = _loader(params, device)
    return ur5_ballistic_problem(
        robot_model_from_numpy(params, device=device), t("x0"), t("target_xy"), t("w_x"),
        t("w_u"), t("w_term"), t("tau_bound"), t("g"), t("z_ground"), t("timestep"),
        nsteps)


def panda_reach_problem_from_numpy(params, nsteps: int = 50, device="cuda"):
    """The Panda reach (:func:`~.examples.panda_reach.panda_reach_problem`)
    from the robot model's leaves, ``x0``, ``R_target``, ``p_target``, the
    weights ``w_pose``, ``w_u``, ``w_term_pose``, ``w_term_vel``,
    ``effort``, the scalar ``timestep`` and, with the post, ``post_a``,
    ``post_b`` and the scalar ``post_radius``."""
    t = _loader(params, device)
    post = ((t("post_a"), t("post_b"), t("post_radius")) if "post_a" in params else None)
    return panda_reach_problem(
        robot_model_from_numpy(params, device=device), t("x0"), t("R_target"), t("p_target"),
        t("w_pose"), t("w_u"), t("w_term_pose"), t("w_term_vel"), t("effort"), t("timestep"),
        nsteps, post=post)


def quadrotor_problem_from_numpy(params, nsteps: int = 60, term_cstr: bool = False,
                                 device="cuda"):
    """The quadrotor flight (:func:`~.examples.quadrotor.quadrotor_problem`)
    from the robot model's leaves, ``actuation (6, 4)``, ``x0``,
    ``x_target``, ``u_hover``, the weights ``w_x``, ``w_u``, ``w_term``,
    the columns' centres ``columns (k, 2)``, the scalar ``column_radius``,
    ``u_max`` and the scalar ``timestep``."""
    t = _loader(params, device)
    return quadrotor_problem(
        robot_model_from_numpy(params, device=device), t("actuation"), t("x0"),
        t("x_target"), t("u_hover"), t("w_x"), t("w_u"), t("w_term"), t("columns"),
        t("column_radius"), t("u_max"), t("timestep"), nsteps, term_cstr=term_cstr)


def talos_arms_problem_from_numpy(params, nsteps: int = 80, device="cuda"):
    """The upper-body reach (:func:`~.examples.talos_arms.talos_arms_problem`)
    from the robot model's leaves, ``x0``, ``x_ref``, ``p_target``, the
    weights ``w_x``, ``w_u``, ``w_frame``, ``w_term_x``, ``w_term_frame``,
    the scalar ``timestep`` and, with the torque bounds, ``effort``."""
    t = _loader(params, device)
    return talos_arms_problem(
        robot_model_from_numpy(params, device=device), t("x0"), t("x_ref"), t("p_target"),
        t("w_x"), t("w_u"), t("w_frame"), t("w_term_x"), t("w_term_frame"), t("timestep"),
        nsteps, effort=t("effort") if "effort" in params else None)


def flexible_pendulum_problem_from_numpy(params, nsteps: int = 120, u_bound=12.0,
                                         device="cuda"):
    """The flexible double pendulum
    (:func:`~.examples.flexible_double_pendulum.flexible_pendulum_problem`)
    from the robot model's leaves, ``actuation``, ``stiffness``,
    ``damping``, ``q_rest``, ``x0``, ``x_target``, the weights ``w_x``,
    ``w_u``, ``w_term`` and the scalar ``timestep``."""
    t = _loader(params, device)
    return flexible_pendulum_problem(
        robot_model_from_numpy(params, device=device), t("actuation"), t("stiffness"),
        t("damping"), t("q_rest"), t("x0"), t("x_target"), t("w_x"), t("w_u"),
        t("w_term"), t("timestep"), nsteps, u_bound=u_bound)


def ur10_midpoint_problem_from_numpy(params, nsteps: int = 50, device="cuda"):
    """The UR10 midpoint reach
    (:func:`~.examples.ur10_midpoint.ur10_midpoint_problem`) from the robot
    model's leaves, ``x0``, ``x_ref``, ``u0``, ``p_target``, the weights
    ``w_x``, ``w_u``, ``w_term``, ``effort`` and the scalar ``timestep``."""
    t = _loader(params, device)
    return ur10_midpoint_problem(
        robot_model_from_numpy(params, device=device), t("x0"), t("x_ref"), t("u0"),
        t("p_target"), t("w_x"), t("w_u"), t("w_term"), t("effort"), t("timestep"), nsteps)


def ur10_ballistic_problem_from_numpy(params, nsteps: int = 80, device="cuda"):
    """The UR10 payload throw
    (:func:`~.examples.ur10_ballistic.ur10_ballistic_problem`) from the robot
    model's leaves, ``x0 (B, nx)``, ``u0``, the grasp's schedule ``active
    (N, 1)``, the weights ``w_x``, ``w_u``, ``w_term``, ``effort``,
    ``vel_limits``, ``target_pos`` ((3,) or (B, 3)), the grasp's relative
    position reference ``p_refs (1, 3)``, the scalars ``timestep``, ``kp``,
    ``kd`` and ``prox_mu``."""
    t = _loader(params, device)
    return ur10_ballistic_problem(
        robot_model_from_numpy(params, device=device), t("x0"), t("u0"), t("active"),
        t("w_x"), t("w_u"), t("w_term"), t("effort"), t("vel_limits"), t("target_pos"),
        t("p_refs"), t("timestep"), nsteps, kp=float(params["kp"]),
        kd=float(params["kd"]), prox_mu=float(params["prox_mu"]))


def legged_problem_from_numpy(params, nsteps: int, device="cuda"):
    """The Solo jump and squat and the biped walk
    (:func:`~.examples.solo_jump.legged_problem`) from the robot model's
    leaves, ``actuation``, ``x0 (B, nx)``, the contact activity ``active``
    ((ncont,) or (N, ncont)), the state targets ``targets`` ((nx,) or (N,
    nx)), the weights ``w_x``, ``w_u``, ``term_target``, ``w_term``, the
    ``contact_frames`` and the scalars ``timestep``, ``kd`` and
    ``prox_mu``."""
    t = _loader(params, device)
    return legged_problem(
        robot_model_from_numpy(params, device=device), t("actuation"), t("x0"),
        t("active"), t("targets"), t("w_x"), t("w_u"), t("term_target"), t("w_term"),
        t("timestep"), nsteps, tuple(int(f) for f in params["contact_frames"]),
        kd=float(params["kd"]), prox_mu=float(params["prox_mu"]))


def wip_problem_from_numpy(params, nsteps: int = 100, device="cuda"):
    """The wheeled inverted pendulum
    (:func:`~.examples.wheeled_inverted_pendulum.wip_problem`) from its
    leaves: ``x0 (B, 4)``, the ODE's ``mass_cart``, ``mass_pole``,
    ``length``, ``wheel_radius``, ``gravity``, and ``timestep``,
    ``x_target``, ``w_x``, ``w_u``, ``w_term``, ``u_bound``."""
    t = _loader(params, device)
    ode = {k: t(k) for k in ("mass_cart", "mass_pole", "length", "wheel_radius", "gravity")}
    return wip_problem(t("x0"), ode, t("timestep"), t("x_target"), t("w_x"), t("w_u"),
                       t("w_term"), t("u_bound"), nsteps)


def centroidal_problem_from_numpy(params, device="cuda"):
    """Centroidal locomotion (:func:`~.examples.centroidal_locomotion.
    centroidal_problem`) from ``x0 (B, 9)``, the schedule ``active (N,
    nk)`` and ``points (N, nk, 3)`` (the JAX package's stacked leaves),
    ``mass``, ``gravity``, ``timestep``, ``com_final``, ``mu``."""
    t = _loader(params, device)
    return centroidal_problem(t("x0"), t("active"), t("points"), t("mass"), t("gravity"),
                              t("timestep"), t("com_final"), t("mu"))


def kinodynamics_problem_from_numpy(params, device="cuda"):
    """The Solo kinodynamics gait (:func:`~.examples.solo_kinodynamics.
    kinodynamics_problem`) from ``x0 (B, 25)``, the schedule ``active``,
    ``points``, ``q_ref (T, nj)``, ``q_nom``, ``mass``, ``gravity``,
    ``timestep``, ``com_final``, ``mu``."""
    t = _loader(params, device)
    return kinodynamics_problem(t("x0"), t("active"), t("points"), t("q_ref"), t("q_nom"),
                                t("mass"), t("gravity"), t("timestep"), t("com_final"),
                                t("mu"))


def continuous_centroidal_problem_from_numpy(params, device="cuda"):
    """The continuous-centroidal gait (:func:`~.examples.continuous_centroidal.
    continuous_problem`) from ``x0 (B, 21)``, the schedule ``active``,
    ``points``, ``w_force (T, nu)``, the gates ``g_first``, ``g_last``,
    ``mass``, ``gravity``, ``timestep``, ``com_final``, ``mu``."""
    t = _loader(params, device)
    return continuous_problem(t("x0"), t("active"), t("points"), t("w_force"), t("g_first"),
                              t("g_last"), t("mass"), t("gravity"), t("timestep"),
                              t("com_final"), t("mu"))
