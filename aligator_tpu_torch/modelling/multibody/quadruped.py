"""Solo-like quadruped model (free-flyer base + 4 × 2-DOF legs).

PyTorch counterpart of ``aligator_tpu/modelling/multibody/quadruped.py``:
hip-pitch + knee joints per leg, point feet ``foot0..foot3`` as operational
frames (nq = 15, nv = 14).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..._device import resolve
from .model import FREEFLYER, REVOLUTE, RobotModel, make_model


def make_quadruped(base_mass=1.4, leg_mass=0.15, shank_mass=0.06, hip_x=0.19,
                   hip_y=0.1046, upper_len=0.16, lower_len=0.16,
                   dtype=torch.float64, device="cuda") -> RobotModel:
    """Build the nv = 14 quadruped (float64, on the card unless
    ``device="cpu"`` is asked for)."""
    device = resolve(device)
    joints = [dict(type=FREEFLYER, parent=-1, mass=base_mass, com=(0.0, 0.0, 0.0),
                   inertia=np.diag([0.0047, 0.0089, 0.0117]))]
    frames = []
    leg_id = 0
    for sx in (+1.0, -1.0):  # front/back
        for sy in (+1.0, -1.0):  # left/right
            joints.append(dict(type=REVOLUTE, parent=0,
                               placement_p=(sx * hip_x, sy * hip_y, 0.0),
                               axis=(0.0, 1.0, 0.0), mass=leg_mass,
                               com=(0.0, 0.0, -upper_len / 2),
                               inertia=np.diag([3e-4, 3e-4, 2e-5])))
            hip_idx = len(joints) - 1
            joints.append(dict(type=REVOLUTE, parent=hip_idx,
                               placement_p=(0.0, 0.0, -upper_len),
                               axis=(0.0, 1.0, 0.0), mass=shank_mass,
                               com=(0.0, 0.0, -lower_len / 2),
                               inertia=np.diag([1e-4, 1e-4, 1e-5])))
            frames.append(dict(name=f"foot{leg_id}", parent=len(joints) - 1,
                               placement_p=(0.0, 0.0, -lower_len)))
            leg_id += 1
    return make_model(joints, frames, dtype=dtype, device=device)


def standing_configuration(model: RobotModel, height=0.25, knee_bend=0.8) -> Tensor:
    """A crouched stance: base at ``height``, legs bent symmetrically."""
    q = model.neutral(model.mass.dtype, model.mass.device).clone()
    q[2] = height
    for leg in range(4):
        q[7 + 2 * leg] = knee_bend / 2
        q[7 + 2 * leg + 1] = -knee_bend
    return q
