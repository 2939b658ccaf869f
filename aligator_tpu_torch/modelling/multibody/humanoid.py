"""Talos-class humanoid model (free-flyer + 6-dof legs + torso + 4-dof arms).

PyTorch counterpart of ``aligator_tpu/modelling/multibody/humanoid.py``
(the same hand-authored nv = 28 humanoid: nq = 29, nu = 22, ≈ 92 kg).

Joint order: free-flyer pelvis, left leg (hip yaw z, hip roll x, hip pitch
y, knee y, ankle pitch y, ankle roll x), right leg (same), torso (yaw z,
pitch y), left arm (shoulder pitch y, shoulder roll x, shoulder yaw z,
elbow y), right arm (same). Operational frames: left_sole / right_sole
(flat feet), left_gripper / right_gripper. :func:`make_humanoid_upper_body`
is its fixed-base upper body (torso and both arms, nv = 10).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..._device import resolve
from .model import FREEFLYER, REVOLUTE, RobotModel, frame_placement, make_model

X = (1.0, 0.0, 0.0)
Y = (0.0, 1.0, 0.0)
Z = (0.0, 0.0, 1.0)


def _box_inertia(m, lx, ly, lz):
    return np.diag([m / 12.0 * (ly ** 2 + lz ** 2), m / 12.0 * (lx ** 2 + lz ** 2),
                    m / 12.0 * (lx ** 2 + ly ** 2)])


def make_humanoid(pelvis_mass=15.0, hip_y_off=0.085, thigh_len=0.38,
                  shin_len=0.325, ankle_height=0.107, torso_height=0.2,
                  shoulder_y_off=0.1575, shoulder_height=0.157,
                  upper_arm_len=0.27, forearm_len=0.25, dtype=torch.float64,
                  device="cuda") -> RobotModel:
    """Build the nv = 28 humanoid (float64, on the card unless
    ``device="cpu"`` is asked for)."""
    device = resolve(device)
    joints = [dict(type=FREEFLYER, parent=-1, mass=pelvis_mass,
                   com=(0.0, 0.0, 0.05),
                   inertia=_box_inertia(pelvis_mass, 0.25, 0.3, 0.2))]
    frames = []

    def add(parent, axis, placement, mass, com, inertia):
        joints.append(dict(type=REVOLUTE, parent=parent, axis=axis,
                           placement_p=placement, mass=mass, com=com,
                           inertia=inertia))
        return len(joints) - 1

    zero = (0.0, 0.0, 0.0)
    for side, sy in (("left", +1.0), ("right", -1.0)):
        hip_yaw = add(0, Z, (0.0, sy * hip_y_off, -0.075), 1.8, zero,
                      _box_inertia(1.8, 0.1, 0.1, 0.1))
        hip_roll = add(hip_yaw, X, zero, 2.2, zero, _box_inertia(2.2, 0.1, 0.1, 0.1))
        hip_pitch = add(hip_roll, Y, zero, 6.2, (0.0, 0.0, -thigh_len / 2),
                        _box_inertia(6.2, 0.12, 0.12, thigh_len))
        knee = add(hip_pitch, Y, (0.0, 0.0, -thigh_len), 3.6,
                   (0.0, 0.0, -shin_len / 2), _box_inertia(3.6, 0.1, 0.1, shin_len))
        ankle_pitch = add(knee, Y, (0.0, 0.0, -shin_len), 1.3, zero,
                          _box_inertia(1.3, 0.08, 0.08, 0.08))
        ankle_roll = add(ankle_pitch, X, zero, 1.5, (0.02, 0.0, -ankle_height / 2),
                         _box_inertia(1.5, 0.21, 0.13, ankle_height))
        frames.append(dict(name=f"{side}_sole", parent=ankle_roll,
                           placement_p=(0.0, 0.0, -ankle_height)))

    torso_yaw = add(0, Z, (0.0, 0.0, torso_height), 3.0, zero,
                    _box_inertia(3.0, 0.15, 0.2, 0.1))
    torso_pitch = add(torso_yaw, Y, zero, 17.0, (0.0, 0.0, 0.15),
                      _box_inertia(17.0, 0.25, 0.3, 0.35))

    for side, sy in (("left", +1.0), ("right", -1.0)):
        sh_pitch = add(torso_pitch, Y, (0.0, sy * shoulder_y_off, shoulder_height),
                       2.0, zero, _box_inertia(2.0, 0.1, 0.1, 0.1))
        sh_roll = add(sh_pitch, X, zero, 2.2, (0.0, 0.0, -upper_arm_len / 2),
                      _box_inertia(2.2, 0.08, 0.08, upper_arm_len))
        sh_yaw = add(sh_roll, Z, (0.0, 0.0, -upper_arm_len), 1.5, zero,
                     _box_inertia(1.5, 0.07, 0.07, 0.07))
        elbow = add(sh_yaw, Y, zero, 2.3, (0.0, 0.0, -forearm_len / 2),
                    _box_inertia(2.3, 0.06, 0.06, forearm_len))
        frames.append(dict(name=f"{side}_gripper", parent=elbow,
                           placement_p=(0.0, 0.0, -forearm_len)))

    return make_model(joints, frames, dtype=dtype, device=device)


def make_humanoid_upper_body(torso_height=0.2, shoulder_y_off=0.1575,
                             shoulder_height=0.157, upper_arm_len=0.27,
                             forearm_len=0.25, dtype=torch.float64,
                             device="cuda") -> RobotModel:
    """Fixed-base upper body: torso (yaw, pitch) and two 4-dof arms (nv =
    10, fully actuated), the arms of :func:`make_humanoid` with the pelvis
    welded to the world; frames left_gripper / right_gripper (float64, on
    the card unless ``device="cpu"`` is asked for)."""
    device = resolve(device)
    zero = (0.0, 0.0, 0.0)
    joints = [dict(type=REVOLUTE, parent=-1, axis=Z, placement_p=(0.0, 0.0, torso_height),
                   mass=3.0, com=zero, inertia=_box_inertia(3.0, 0.15, 0.2, 0.1))]
    frames = []

    def add(parent, axis, placement, mass, com, inertia):
        joints.append(dict(type=REVOLUTE, parent=parent, axis=axis,
                           placement_p=placement, mass=mass, com=com,
                           inertia=inertia))
        return len(joints) - 1

    torso_pitch = add(0, Y, zero, 17.0, (0.0, 0.0, 0.15),
                      _box_inertia(17.0, 0.25, 0.3, 0.35))
    for side, sy in (("left", +1.0), ("right", -1.0)):
        sh_pitch = add(torso_pitch, Y, (0.0, sy * shoulder_y_off, shoulder_height),
                       2.0, zero, _box_inertia(2.0, 0.1, 0.1, 0.1))
        sh_roll = add(sh_pitch, X, zero, 2.2, (0.0, 0.0, -upper_arm_len / 2),
                      _box_inertia(2.2, 0.08, 0.08, upper_arm_len))
        sh_yaw = add(sh_roll, Z, (0.0, 0.0, -upper_arm_len), 1.5, zero,
                     _box_inertia(1.5, 0.07, 0.07, 0.07))
        elbow = add(sh_yaw, Y, zero, 2.3, (0.0, 0.0, -forearm_len / 2),
                    _box_inertia(2.3, 0.06, 0.06, forearm_len))
        frames.append(dict(name=f"{side}_gripper", parent=elbow,
                           placement_p=(0.0, 0.0, -forearm_len)))
    return make_model(joints, frames, dtype=dtype, device=device)


def upper_body_effort_limits(dtype=torch.float64, device="cuda") -> Tensor:
    """Torque limits of :func:`make_humanoid_upper_body` (torso, then the
    two arms), on the card unless ``device="cpu"`` is asked for."""
    arm = [44.0, 44.0, 30.0, 30.0]
    return torch.tensor([78.0, 78.0] + arm + arm, dtype=dtype, device=resolve(device))


def half_sitting(model: RobotModel, hip_pitch=-0.411, knee=0.859,
                 ankle_pitch=-0.448) -> Tensor:
    """Talos-like half-sitting configuration with both soles flat at z = 0
    (the base height from this model's own forward kinematics), in the
    model's dtype and device."""
    q = model.neutral().clone()
    for leg in range(2):
        base = 7 + 6 * leg  # 7 base coords, then 6 per leg
        q[base + 2] = hip_pitch
        q[base + 3] = knee
        q[base + 4] = ankle_pitch
    arm0 = 7 + 12 + 2  # slight elbow bend
    for arm in range(2):
        q[arm0 + 4 * arm + 1] = 0.2 * (1 if arm == 0 else -1)
        q[arm0 + 4 * arm + 3] = -0.5
    _, p_sole = frame_placement(model, q, model.frame_id("left_sole"))
    q[2] = -p_sole[2]
    return q


def actuation_matrix(model: RobotModel) -> Tensor:
    """(nv, nu) selector: every joint actuated but the free-flyer."""
    nv = model.nv
    B = torch.zeros((nv, nv - 6), dtype=model.mass.dtype, device=model.mass.device)
    B[6:] = torch.eye(nv - 6, dtype=B.dtype, device=B.device)
    return B


def effort_limits(dtype=torch.float64, device="cuda") -> Tensor:
    """Per-actuator torque limits (Talos-class magnitudes), order = v[6:],
    on the card unless ``device="cpu"`` is asked for."""
    device = resolve(device)
    leg = [100.0, 160.0, 160.0, 300.0, 160.0, 100.0]
    torso = [78.0, 78.0]
    arm = [44.0, 44.0, 30.0, 30.0]
    return torch.tensor(leg + leg + torso + arm + arm, dtype=dtype, device=device)
