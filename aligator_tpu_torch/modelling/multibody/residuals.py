"""Multibody residuals (task-space errors).

PyTorch counterpart of ``FrameTranslationResidual`` in
``aligator_tpu/modelling/multibody/residuals.py``, on a phase-space state
x = (q, v).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from ...core.functions import StageFunction, stage_param
from . import model as rbd


@dataclass
class FrameTranslationResidual(StageFunction):
    """r(x) = p_frame(q) − p_ref ∈ R³; ``p_ref`` is ``(3,)``, or ``(N, 3)``
    for a target that varies over the stages."""

    model: rbd.RobotModel
    p_ref: Tensor
    frame_id: int = 0

    def dim(self, space, nu):
        return 3

    def value(self, space, x, u):
        _, p = rbd.frame_placement(self.model, x[..., :self.model.nq], self.frame_id)
        return p - stage_param(self.p_ref, x, 1)

    def jacobians(self, space, x, u):
        """Analytic: the linear rows of the LOCAL_WORLD_ALIGNED frame
        Jacobian (∂p/∂dq); zero in (v, u)."""
        J = rbd.frame_jacobian_lwa(self.model, x[..., :self.model.nq], self.frame_id)
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        Jx = x.new_zeros(lead + (3, space.ndx))
        Jx[..., :self.model.nv] = J[..., :3, :]
        return Jx, x.new_zeros(lead + (3, u.shape[-1]))
