"""RobotModel → MJCF export.

PyTorch counterpart of ``aligator_tpu/modelling/multibody/mjcf_export.py``:
:func:`model_to_mjcf` writes, for any :class:`~.model.RobotModel`, the
MJCF text that the JAX function writes for the same model, byte for byte
(the floats as their ``repr``). The text has no ``<geom>``: every body
carries an explicit ``<inertial>`` (mass, com, full rotational inertia
about the com), so the dynamics are fully specified, the per-dof armature
sits on the joints, the frames are massless sites, and the constraint
solver is disabled in ``<option>``. :func:`.mjcf.load_mjcf` reads it back
to the same model (the frames then follow the bodies' own).
"""

from __future__ import annotations

import numpy as np
import torch

from .model import FREEFLYER, REVOLUTE, RobotModel


def _np(t):
    """A tensor leaf as a float64 numpy array (on the host)."""
    return t.detach().to("cpu", torch.float64).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, float)


def _fmt(a):
    return " ".join(repr(float(x)) for x in np.atleast_1d(np.asarray(a)))


def _quat_wxyz(q_xyzw):
    q = np.asarray(q_xyzw, float)
    return np.array([q[3], q[0], q[1], q[2]])


def model_to_mjcf(model: RobotModel, name="robot") -> str:
    """Emit an MJCF string dynamically equivalent to ``model``.

    Joint i becomes a body at its parent placement with one joint
    (hinge/slide/freejoint) at the body origin and the body's inertial
    properties.  Per-dof armature is attached to the joints (MuJoCo's
    reflected-rotor convention matches ``model.armature``'s role in the
    mass matrix).  Frames are emitted as (massless) sites for FK checks.
    """
    jp = _np(model.jplac_p)
    jq = _np(model.jplac_q)
    axes = _np(model.axes)
    mass = _np(model.mass)
    com = _np(model.com)
    inertia = _np(model.inertia)
    grav = _np(model.gravity)
    arm = _np(model.armature) if model.armature is not None else None

    # per-joint armature value: dof offsets
    dof_of_joint = []
    off = 0
    for t in model.joint_types:
        dof_of_joint.append(off)
        off += 6 if t == FREEFLYER else 1

    children = {i: [] for i in range(-1, model.njoints)}
    for i, par in enumerate(model.parents):
        children[par].append(i)

    frames_of = {}
    for fid, par in enumerate(model.frame_parents):
        frames_of.setdefault(par, []).append(fid)

    lines = [
        f'<mujoco model="{name}">',
        '  <compiler angle="radian"/>',
        f'  <option gravity="{_fmt(grav)}">',
        '    <flag constraint="disable"/>',
        "  </option>",
        "  <worldbody>",
    ]

    def emit(i, depth):
        ind = "  " * (depth + 2)
        t = model.joint_types[i]
        q = _quat_wxyz(jq[i])
        lines.append(
            f'{ind}<body name="body{i}" pos="{_fmt(jp[i])}" '
            f'quat="{_fmt(q)}">'
        )
        if t == FREEFLYER:
            lines.append(f"{ind}  <freejoint/>")
        else:
            jtype = "hinge" if t == REVOLUTE else "slide"
            a = ""
            if arm is not None and arm[dof_of_joint[i]] != 0.0:
                a = f' armature="{float(arm[dof_of_joint[i]])!r}"'
            lines.append(
                f'{ind}  <joint type="{jtype}" axis="{_fmt(axes[i])}"'
                f"{a}/>"
            )
        I = inertia[i]
        full = " ".join(
            repr(float(v))
            for v in (I[0, 0], I[1, 1], I[2, 2], I[0, 1], I[0, 2], I[1, 2])
        )
        lines.append(
            f'{ind}  <inertial mass="{float(mass[i])!r}" pos="{_fmt(com[i])}" '
            f'fullinertia="{full}"/>'
        )
        for fid in frames_of.get(i, []):
            fq = _quat_wxyz(_np(model.fplac_q)[fid])
            lines.append(
                f'{ind}  <site name="{model.frame_names[fid]}" '
                f'pos="{_fmt(_np(model.fplac_p)[fid])}" '
                f'quat="{_fmt(fq)}"/>'
            )
        for c in children[i]:
            emit(c, depth + 1)
        lines.append(f"{ind}</body>")

    for root in children[-1]:
        emit(root, 0)
    lines.append("  </worldbody>")
    lines.append("</mujoco>")
    return "\n".join(lines)
