"""URDF → :class:`~.model.RobotModel` ingestion.

PyTorch counterpart of ``aligator_tpu/modelling/multibody/urdf.py`` (the
role of ``pinocchio.buildModelFromUrdf``): links and joints parsed with
``xml.etree`` and numpy into the same :class:`~.model.RobotModel` the
builders give, on the card unless ``device="cpu"`` is asked for.

Read: revolute and continuous joints (→ revolute), prismatic, fixed
(welded: the child's inertia fused into the parent moving link), floating
(→ free-flyer); ``root_joint='freeflyer'`` puts a free-flyer at the root
link. Each link becomes a named operational frame. Joint ``<dynamics
damping>`` and ``<limit lower/upper/effort/velocity>`` are returned in the
info dict. Mimic joints raise ``ValueError``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from .mjcf import _T, _euler_to_mat, _fuse
from .model import FREEFLYER, PRISMATIC, REVOLUTE, make_model


def _origin(elem):
    """<origin xyz rpy> → _T (URDF rpy = fixed-axis XYZ roll-pitch-yaw,
    i.e. R = Rz(y) Ry(p) Rx(r))."""
    if elem is None:
        return _T()
    xyz = np.array([float(t) for t in elem.get("xyz", "0 0 0").split()])
    rpy = np.array([float(t) for t in elem.get("rpy", "0 0 0").split()])
    R = (
        _euler_to_mat([0.0, 0.0, rpy[2]], "xyz")
        @ _euler_to_mat([0.0, rpy[1], 0.0], "xyz")
        @ _euler_to_mat([rpy[0], 0.0, 0.0], "xyz")
    )
    return _T(R, xyz)


def _link_inertial(link):
    """(mass, com, I_com) in the link frame, or None."""
    inr = link.find("inertial")
    if inr is None:
        return None
    T = _origin(inr.find("origin"))
    mass = float(inr.find("mass").get("value"))
    ie = inr.find("inertia")
    ixx = float(ie.get("ixx", 0)); iyy = float(ie.get("iyy", 0))
    izz = float(ie.get("izz", 0)); ixy = float(ie.get("ixy", 0))
    ixz = float(ie.get("ixz", 0)); iyz = float(ie.get("iyz", 0))
    I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    # inertia given in the inertial-origin frame; rotate to the link frame
    return mass, T.p, T.R @ I @ T.R.T


_JTYPE = {
    "revolute": REVOLUTE,
    "continuous": REVOLUTE,
    "prismatic": PRISMATIC,
    "floating": FREEFLYER,
}


def load_urdf(path_or_string, root_joint=None, dtype=torch.float64, device="cuda"):
    """Parse a URDF (file path or XML string) into ``(RobotModel, info)``,
    the model's tensors in ``dtype`` on ``device``."""
    if "<robot" in str(path_or_string):
        root = ET.fromstring(path_or_string)
    else:
        root = ET.parse(path_or_string).getroot()

    links = {l.get("name"): l for l in root.findall("link")}
    ujoints = root.findall("joint")
    for j in ujoints:
        if j.find("mimic") is not None:
            raise ValueError(f"mimic joint {j.get('name')!r} not supported")

    children = {}  # parent link name → [joint elements]
    child_links = set()
    for j in ujoints:
        pl = j.find("parent").get("link")
        cl = j.find("child").get("link")
        children.setdefault(pl, []).append(j)
        child_links.add(cl)
    roots = [n for n in links if n not in child_links]
    if len(roots) != 1:
        raise ValueError(f"expected one root link, found {roots}")

    joints = []
    joint_names = []
    joint_inertia = []
    frames = []
    dof_damping = []
    limits = {}

    def add_link_inertia(link_name, target_joint, X_to_target):
        gi = _link_inertial(links[link_name])
        if gi is not None and target_joint >= 0:
            m, c, I = gi
            joint_inertia[target_joint].append(
                (m, X_to_target.apply(c), X_to_target.R @ I @ X_to_target.R.T)
            )

    def add_frame(name, parent_joint, T):
        if parent_joint < 0:
            return
        frames.append(
            dict(name=name, parent=parent_joint, placement_p=T.p,
                 placement_q=T.quat())
        )

    def walk(link_name, parent_joint, X_acc, synth_root):
        """``X_acc``: transform from the parent joint frame to this link's
        frame. ``synth_root``: give this link a synthetic free-flyer."""
        if synth_root:
            jidx = len(joints)
            joints.append(
                dict(type=FREEFLYER, parent=parent_joint,
                     placement_p=X_acc.p, placement_q=X_acc.quat(),
                     axis=np.array([0.0, 0.0, 1.0]))
            )
            joint_names.append("root_joint")
            joint_inertia.append([])
            dof_damping.extend([0.0] * 6)
            parent_joint, X_acc = jidx, _T()

        add_link_inertia(link_name, parent_joint, X_acc)
        add_frame(link_name, parent_joint, X_acc)

        for j in children.get(link_name, []):
            jtype = j.get("type")
            X_pj_joint = X_acc * _origin(j.find("origin"))
            child = j.find("child").get("link")
            if jtype == "fixed":
                walk(child, parent_joint, X_pj_joint, False)
                continue
            if jtype not in _JTYPE:
                raise ValueError(f"joint type {jtype!r} not supported")
            axel = j.find("axis")
            axis = (
                np.array([float(t) for t in axel.get("xyz").split()])
                if axel is not None else np.array([1.0, 0.0, 0.0])
            )
            axis = axis / max(np.linalg.norm(axis), 1e-12)
            jidx = len(joints)
            joints.append(
                dict(type=_JTYPE[jtype], parent=parent_joint,
                     placement_p=X_pj_joint.p, placement_q=X_pj_joint.quat(),
                     axis=axis)
            )
            jname = j.get("name", f"joint{jidx}")
            joint_names.append(jname)
            joint_inertia.append([])
            nv_j = 6 if _JTYPE[jtype] == FREEFLYER else 1
            dyn = j.find("dynamics")
            dof_damping.extend(
                [float(dyn.get("damping", 0.0)) if dyn is not None else 0.0]
                * nv_j
            )
            lim = j.find("limit")
            if lim is not None:
                limits[jname] = {
                    k: float(lim.get(k)) for k in
                    ("lower", "upper", "effort", "velocity") if lim.get(k)
                }
            walk(child, jidx, _T(), False)

    walk(roots[0], -1, _T(), root_joint == "freeflyer")

    if not joints:
        raise ValueError("URDF has no movable joints (add root_joint?)")

    for jd, contribs in zip(joints, joint_inertia):
        m, com, I = _fuse(contribs)
        jd["mass"] = m
        jd["com"] = com
        jd["inertia"] = I

    model = make_model(joints, frames, dtype=dtype, device=device)
    info = dict(
        joint_names=tuple(joint_names),
        frame_names=model.frame_names,
        damping=np.asarray(dof_damping),
        limits=limits,
    )
    return model, info
