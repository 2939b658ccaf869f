"""Built-in robot models (no external model files needed).

PyTorch counterpart of ``aligator_tpu/modelling/multibody/robots.py``: the
analytic pendulum and double pendulum, UR5-, UR10- and Panda-like arms from
their published nominal kinematic and inertial parameters, the dual-arm
free-floating space robot (FFSR), a free sphere and the UR10 with a
free-flying payload. Each builder returns a
:class:`~.model.RobotModel` in ``dtype`` on ``device`` (the card unless
``device="cpu"`` is asked for). :func:`make_panda_real` reads the real
Panda from its MJCF file (:mod:`.mjcf`).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..._device import resolve
from .mjcf import load_mjcf
from .model import FREEFLYER, REVOLUTE, RobotModel, make_model, with_frame

HALF_PI = math.pi / 2
Z_AXIS = (0.0, 0.0, 1.0)
Y_AXIS = (0.0, 1.0, 0.0)


def _rpy_quat(r, p, y):
    """Quaternion (x, y, z, w) from roll-pitch-yaw (URDF convention)."""
    cr, sr = math.cos(r / 2), math.sin(r / 2)
    cp, sp = math.cos(p / 2), math.sin(p / 2)
    cy, sy = math.cos(y / 2), math.sin(y / 2)
    return (sr * cp * cy - cr * sp * sy, cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy, cr * cp * cy + sr * sp * sy)


def _diag(*d):
    return np.diag(np.asarray(d, np.float64))


def _build(joints, frames, dtype, device, gravity=(0.0, 0.0, -9.81)) -> RobotModel:
    return make_model(joints, frames, gravity=gravity, dtype=dtype, device=device)


def make_double_pendulum(l1=1.0, l2=1.0, m1=1.0, m2=1.0, dtype=torch.float64,
                         device="cuda") -> RobotModel:
    """Planar double pendulum: two revolute joints about +y, point masses at
    the link tips, hanging along −z at q = 0."""
    eps = 1e-8  # a tiny rotational inertia keeps M(q) well conditioned
    joints = [
        dict(type=REVOLUTE, parent=-1, axis=Y_AXIS, mass=m1, com=(0.0, 0.0, -l1),
             inertia=eps * np.eye(3)),
        dict(type=REVOLUTE, parent=0, placement_p=(0.0, 0.0, -l1), axis=Y_AXIS,
             mass=m2, com=(0.0, 0.0, -l2), inertia=eps * np.eye(3)),
    ]
    frames = [dict(name="tip", parent=1, placement_p=(0.0, 0.0, -l2))]
    return _build(joints, frames, dtype, device)


def make_pendulum(l=1.0, m=1.0, dtype=torch.float64, device="cuda") -> RobotModel:
    joints = [dict(type=REVOLUTE, parent=-1, axis=Y_AXIS, mass=m, com=(0.0, 0.0, -l),
                   inertia=1e-8 * np.eye(3))]
    frames = [dict(name="tip", parent=0, placement_p=(0.0, 0.0, -l))]
    return _build(joints, frames, dtype, device)


def _arm6(d1, shoulder, upper, elbow, forearm, wrist1, wrist2, ee, links):
    """A UR-style 6-joint chain: joint offsets (ur_description URDF chain)
    and ``links`` = six (mass, com z, (Ixx, Iyy, Izz))."""
    place = [
        dict(placement_p=(0.0, 0.0, d1), axis=Z_AXIS),
        dict(placement_p=(0.0, shoulder, 0.0), placement_q=_rpy_quat(0.0, HALF_PI, 0.0),
             axis=Y_AXIS),
        dict(placement_p=(0.0, elbow, upper), axis=Y_AXIS),
        dict(placement_p=(0.0, 0.0, forearm), placement_q=_rpy_quat(0.0, HALF_PI, 0.0),
             axis=Y_AXIS),
        dict(placement_p=(0.0, wrist1, 0.0), axis=Z_AXIS),
        dict(placement_p=(0.0, 0.0, wrist2), axis=Y_AXIS),
    ]
    joints = [dict(type=REVOLUTE, parent=i - 1, mass=m, com=(0.0, 0.0, cz),
                   inertia=_diag(*I), **pl)
              for i, (pl, (m, cz, I)) in enumerate(zip(place, links))]
    frames = [dict(name="ee", parent=5, placement_p=(0.0, ee, 0.0),
                   placement_q=_rpy_quat(0.0, 0.0, HALF_PI))]
    return joints, frames


def _ur5_spec():
    return _arm6(0.089159, 0.13585, 0.425, -0.1197, 0.39225, 0.093, 0.09465, 0.0823, [
        (3.7, 0.0, (0.0103, 0.0103, 0.0067)),
        (8.393, 0.28, (0.2269, 0.2269, 0.0151)),
        (2.275, 0.25, (0.0494, 0.0494, 0.0041)),
        (1.219, 0.0, (0.0111, 0.0111, 0.0022)),
        (1.219, 0.0, (0.0111, 0.0111, 0.0022)),
        (0.1879, 0.0, (0.00033, 0.00033, 0.00021)),
    ])


def _ur10_spec():
    return _arm6(0.1273, 0.220941, 0.612, -0.1719, 0.5723, 0.1149, 0.1157, 0.0922, [
        (7.778, 0.0, (0.0315, 0.0315, 0.0219)),
        (12.93, 0.306, (0.4218, 0.4218, 0.0364)),
        (3.87, 0.28615, (0.1110, 0.1110, 0.0109)),
        (1.96, 0.0, (0.0051, 0.0051, 0.0055)),
        (1.96, 0.0, (0.0051, 0.0051, 0.0055)),
        (0.202, 0.0, (0.00053, 0.00053, 0.00069)),
    ])


def make_ur5(dtype=torch.float64, device="cuda") -> RobotModel:
    """UR5-like 6-DOF arm from the nominal public UR5 parameters (the UR5
    URDF chain, published link masses, standard CoM offsets)."""
    return _build(*_ur5_spec(), dtype, device)


def make_ur10(dtype=torch.float64, device="cuda") -> RobotModel:
    """UR10-like 6-DOF arm from the nominal public UR10 parameters
    (ur_description: d1 = 0.1273, upper arm 0.612 m, forearm 0.5723 m)."""
    return _build(*_ur10_spec(), dtype, device)


def ur10_effort_limits(dtype=torch.float64, device="cuda"):
    """Published UR10 per-joint torque limits (ur_description)."""
    return torch.tensor([330.0, 330.0, 150.0, 54.0, 54.0, 54.0], dtype=dtype,
                        device=resolve(device))


# the Panda chain (franka_description joint origins, all axes +z in the
# child frame; identified masses and CoMs of Gaz et al. 2019; rotational
# inertias of cylinder scale s): (placement_p, rpy, mass, com, s)
_PANDA_CHAIN = (
    ((0.0, 0.0, 0.333), (0.0, 0.0, 0.0), 4.970684, (0.003875, 0.002081, -0.04762), 0.08),
    ((0.0, 0.0, 0.0), (-HALF_PI, 0.0, 0.0), 0.646926, (-0.003141, -0.02872, 0.003495), 0.07),
    ((0.0, -0.316, 0.0), (HALF_PI, 0.0, 0.0), 3.228604, (0.027518, 0.039252, -0.066502), 0.07),
    ((0.0825, 0.0, 0.0), (HALF_PI, 0.0, 0.0), 3.587895, (-0.05317, 0.104419, 0.027454), 0.07),
    ((-0.0825, 0.384, 0.0), (-HALF_PI, 0.0, 0.0), 1.225946, (-0.011953, 0.041065, -0.038437),
     0.06),
    ((0.0, 0.0, 0.0), (HALF_PI, 0.0, 0.0), 1.666555, (0.060149, -0.014117, -0.010517), 0.06),
    ((0.088, 0.0, 0.0), (HALF_PI, 0.0, 0.0), 0.735522, (0.010517, -0.004252, 0.061597), 0.05),
)


def _panda_joint(i, parent, placement_p=None, placement_q=None):
    pp, rpy, mass, com, s = _PANDA_CHAIN[i]
    return dict(type=REVOLUTE, parent=parent, axis=Z_AXIS, mass=mass, com=com,
                inertia=mass * _diag(s * s, s * s, 0.5 * s * s),
                placement_p=pp if placement_p is None else placement_p,
                placement_q=_rpy_quat(*rpy) if placement_q is None else placement_q)


def make_panda(dtype=torch.float64, device="cuda") -> RobotModel:
    """Franka Emika Panda-like 7-DOF arm from its published nominal
    kinematics and identified link masses and CoMs; frames ``ee`` (the
    flange, 0.107 m past joint 7) and ``elbow`` (joint 4)."""
    joints = [_panda_joint(i, i - 1) for i in range(7)]
    frames = [dict(name="ee", parent=6, placement_p=(0.0, 0.0, 0.107)),
              dict(name="elbow", parent=3)]
    return _build(joints, frames, dtype, device)


# the vendored robot assets (MuJoCo Menagerie's Franka Panda, the FFSR
# fork's XML): a directory beside the package unless ALIGATOR_REFERENCE_DIR
# names another. Read at run time, not part of the repository.
REFERENCE_DIR = os.environ.get(
    "ALIGATOR_REFERENCE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "reference"))
PANDA_MJCF_PATH = os.path.join(REFERENCE_DIR, "franka_emika_panda", "panda_nohand.xml")


def make_panda_real(path: str = None, dtype=torch.float64, device="cuda"):
    """The real Franka Emika Panda (7 dofs, no hand) read from its MJCF
    file (``path``, by default :data:`PANDA_MJCF_PATH` read at call time)
    through :func:`.mjcf.load_mjcf`: its kinematic frames, identified
    masses, coms, full rotational inertias and per-joint armature. Frames:
    the file's bodies and sites, ``attachment`` (the flange) aliased as
    ``ee``, and ``elbow`` (joint 3's frame), the names the reach example's
    costs and collision pairs use. Returns ``(model, info)``; raises
    ``FileNotFoundError`` when the file is absent (callers then take
    :func:`make_panda`, the nominal model), as the JAX function does."""
    p = PANDA_MJCF_PATH if path is None else path
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    model, info = load_mjcf(p, dtype=dtype, device=device)
    att = model.frame_id("attachment")
    model = with_frame(model, "ee", model.frame_parents[att], placement_p=model.fplac_p[att],
                       placement_q=model.fplac_q[att])
    return with_frame(model, "elbow", 3), info


PANDA_Q_HOME = np.array([0.0, -0.785398, 0.0, -2.356194, 0.0, 1.570796, 0.785398])
PANDA_EFFORT_LIMIT = np.array([87.0, 87.0, 87.0, 87.0, 12.0, 12.0, 12.0])
PANDA_Q_LOWER = np.array([-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973])
PANDA_Q_UPPER = np.array([2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973])


def make_dual_arm_ffsr(base_mass=60.0, base_half=(0.35, 0.45, 0.25), mount_y=0.45,
                       mount_z=0.15, dtype=torch.float64, device="cuda") -> RobotModel:
    """Dual-arm free-floating space robot: a free-flyer base bus with two
    7-DOF Panda-kinematics arms on its ±y faces, zero gravity (nq = 7 + 14,
    nv = 6 + 14, the base unactuated by the examples). Each arm's base
    frame is rotated so that its first joint axis points along world ±y at
    the neutral base attitude. Frames ``arm1_tool``, ``arm2_tool`` and
    ``base``."""
    lx, ly, lz = base_half
    box = (base_mass / 3.0) * _diag(ly * ly + lz * lz, lx * lx + lz * lz, lx * lx + ly * ly)
    joints = [dict(type=FREEFLYER, parent=-1, mass=base_mass, com=(0.0, 0.0, 0.0),
                   inertia=box)]
    frames = []
    for name, sy in (("arm1", 1.0), ("arm2", -1.0)):
        parent = 0
        for i in range(7):
            mount = {} if i else dict(placement_p=(0.0, sy * mount_y, mount_z),
                                      placement_q=_rpy_quat(-sy * HALF_PI, 0.0, 0.0))
            joints.append(_panda_joint(i, parent, **mount))
            parent = len(joints) - 1
        frames.append(dict(name=f"{name}_tool", parent=parent, placement_p=(0.0, 0.0, 0.107)))
    frames.append(dict(name="base", parent=0))
    return _build(joints, frames, dtype, device, gravity=(0.0, 0.0, 0.0))


# nominal arm postures of the dual-arm space-robot application
# (dual-FFSR_ProxDDP/main3.py desired_qpos_arm1/arm2)
FFSR_Q_ARM1 = np.array([-1.6591, -0.8973, -0.2357, 1.1626, -1.9025, -0.5507, 0.8034])
FFSR_Q_ARM2 = np.array([-2.209, -0.5691, 0.3233, 1.1195, -2.0471, -0.0263, 0.7434])


def make_free_sphere(mass=1.0, radius=0.2, dtype=torch.float64, device="cuda") -> RobotModel:
    """A free-floating solid sphere (free-flyer dynamics checks)."""
    inertia = (2.0 / 5.0) * mass * radius ** 2 * np.eye(3)
    joints = [dict(type=FREEFLYER, parent=-1, mass=mass, com=(0.0, 0.0, 0.0),
                   inertia=inertia)]
    return _build(joints, [dict(name="center", parent=0)], dtype, device)


def make_ur10_with_payload(mass=0.5, radius=0.05, height=0.12, dtype=torch.float64,
                           device="cuda") -> RobotModel:
    """The UR10 and a free-flying solid-cylinder payload (axis z) as one
    model, a forest with two roots; the payload's frame is ``mug``."""
    joints, frames = _ur10_spec()
    ixx = mass * (3 * radius ** 2 + height ** 2) / 12.0
    izz = mass * radius ** 2 / 2.0
    joints = joints + [dict(type=FREEFLYER, parent=-1, mass=mass, com=(0.0, 0.0, 0.0),
                            inertia=_diag(ixx, ixx, izz))]
    frames = frames + [dict(name="mug", parent=len(joints) - 1)]
    return _build(joints, frames, dtype, device)


def make_chain(n_revolute: int, free_flyer: bool = False, dtype=torch.float64,
               device="cuda", frame_stride: int = 4) -> RobotModel:
    """A synthetic serial chain of ``n_revolute`` revolute joints (axes
    cycling x, y, z, links of 8 cm, masses 0.5 + 0.01 i kg), on a fixed or a
    free-flyer base, with a frame ``f<b>`` at the end of every
    ``frame_stride``-th body b = stride - 1, 2 stride - 1, ... (every fourth
    by default; every body with 1, as many contact frames as bodies): a
    model past the kernels' register routes (64 joints and 70 dofs with a
    free-flyer base and 63 links)."""
    joints = []
    if free_flyer:
        joints.append(dict(type=FREEFLYER, parent=-1, mass=5.0, com=(0.0, 0.0, 0.0),
                           inertia=_diag(0.1, 0.12, 0.08)))
    axes = ((1.0, 0.0, 0.0), Y_AXIS, Z_AXIS)
    for i in range(n_revolute):
        joints.append(dict(type=REVOLUTE, parent=len(joints) - 1, axis=axes[i % 3],
                           placement_p=(0.0, 0.02, -0.08), mass=0.5 + 0.01 * i,
                           com=(0.01, 0.0, -0.04), inertia=_diag(2e-3, 3e-3, 1e-3)))
    frames = [dict(name=f"f{b}", parent=b, placement_p=(0.0, 0.0, -0.08))
              for b in range(frame_stride - 1, len(joints), frame_stride)]
    return _build(joints, frames, dtype, resolve(device))
