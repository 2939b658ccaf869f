"""MuJoCo simulation environment for closed-loop MPC validation.

Port of the JAX package's ``examples/mujoco_sim_env.py``, the same text and
steps (numpy and ``mujoco``, host only; ``mujoco`` is imported only by
:class:`MuJoCoSimEnv`, so the module imports where MuJoCo is absent). Role
of the reference's ``examples/mujoco_sim_env.py:6`` (the
``mujoco_sim_env`` class that steps MuJoCo physics under the solver's
torque commands) — the external ground-truth physics used to validate the
whole stack in closed loop.

The vendored Panda asset references mesh files that are not shipped, so
:func:`meshless_xml` strips ``<asset>``/geoms (every body carries an
explicit ``<inertial>``, so the *dynamics* are unchanged) and disables the
constraint solver (no contacts in the reach task; joint limits are handled
by the OCP, not the simulator).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np


def meshless_xml(path, disable_constraint=True):
    """MJCF source string with meshes/geoms stripped and (optionally) the
    constraint solver disabled — loadable by MuJoCo without the asset
    directory, dynamically identical for contact-free tasks."""
    tree = ET.parse(path)
    root = tree.getroot()
    for tag in ("asset", "equality", "tendon", "actuator", "contact",
                "keyframe"):
        for el in root.findall(tag):
            root.remove(el)

    def strip(el):
        for g in list(el.findall("geom")):
            el.remove(g)
        for child in el.findall("body"):
            strip(child)

    strip(root.find("worldbody"))
    if disable_constraint:
        opt = root.find("option")
        if opt is None:
            opt = ET.SubElement(root, "option")
        ET.SubElement(opt, "flag", {"constraint": "disable"})
    return ET.tostring(root, encoding="unicode")


class MuJoCoSimEnv:
    """Minimal torque-controlled simulation loop (reference
    ``mujoco_sim_env`` role): ``reset(q0)``, ``step(tau, n_substeps)``,
    ``state()`` → (qpos, qvel)."""

    def __init__(self, xml_string, timestep=None):
        import mujoco

        self._mujoco = mujoco
        self.model = mujoco.MjModel.from_xml_string(xml_string)
        if timestep is not None:
            self.model.opt.timestep = float(timestep)
        self.data = mujoco.MjData(self.model)

    @property
    def timestep(self):
        return float(self.model.opt.timestep)

    def reset(self, q0, v0=None):
        self.data.qpos[:] = np.asarray(q0)
        self.data.qvel[:] = 0.0 if v0 is None else np.asarray(v0)
        self.data.qacc[:] = 0.0
        self._mujoco.mj_forward(self.model, self.data)
        return self.state()

    def step(self, tau, n_substeps=1):
        """Apply joint torques (zero-order hold) for ``n_substeps`` physics
        steps; returns the new (qpos, qvel)."""
        self.data.qfrc_applied[:] = np.asarray(tau)
        for _ in range(n_substeps):
            self._mujoco.mj_step(self.model, self.data)
        return self.state()

    def state(self):
        return self.data.qpos.copy(), self.data.qvel.copy()

    def body_pos(self, name):
        bid = self._mujoco.mj_name2id(
            self.model, self._mujoco.mjtObj.mjOBJ_BODY, name
        )
        return self.data.xpos[bid].copy()
