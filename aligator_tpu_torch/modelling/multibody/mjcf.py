"""MJCF (MuJoCo XML) → :class:`~.model.RobotModel` ingestion.

PyTorch counterpart of ``aligator_tpu/modelling/multibody/mjcf.py`` (the
role of ``pinocchio.buildModelsFromMJCF``): host code on ``xml.etree`` and
numpy, whose result is a plain :class:`~.model.RobotModel` on the card
unless ``device="cpu"`` is asked for, so that everything downstream (the
kinematics, RNEA, ``aba`` and the free-dynamics kernel, the residuals, the
solvers) takes it unchanged. It reads what the JAX parser reads and gives
the same model, table for table:

* ``<body>`` trees with ``pos`` and ``quat``/``euler``/``axisangle``
  frames, one ``<joint>`` a body: hinge → revolute, slide → prismatic,
  free (or ``<freejoint>``) → free-flyer;
* ``<inertial>`` (pos/quat/mass/diaginertia/fullinertia); a body without
  one takes the density inertia of its primitive geoms (sphere, box,
  cylinder, capsule: MuJoCo's rule);
* jointless bodies are welded: their inertia fused into the nearest
  jointed ancestor (dropped when welded to the world);
* ``<site>`` and body frames → operational frames;
* ``<default>`` classes (nested, ``class``/``childclass``) for joint and
  geom attributes, ``<include>`` splicing, ``<compiler angle>`` (degrees
  by default), ``<option gravity>``;
* per-dof ``armature`` (on the model: the mass matrix's diagonal and
  RNEA's armature·q̈) and ``damping`` (in the info dict only; like
  ``pin.aba``, the dynamics do not apply it), ``<actuator>`` elements with
  a ``joint`` → the actuated dof indices.

As in the JAX parser, ``xyaxes`` and ``zaxis`` frames are not read (such a
frame is the identity), and ball joints, several joints in one body and a
jointed body with neither ``<inertial>`` nor a primitive geom raise
``ValueError``.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from .model import FREEFLYER, PRISMATIC, REVOLUTE, make_model

_IDQ = np.array([0.0, 0.0, 0.0, 1.0])  # (x, y, z, w)


# ---------------------------------------------------------------------------
# small SO(3)/SE(3) helpers (numpy, host-side)
# ---------------------------------------------------------------------------


def _quat_wxyz_to_xyzw(q):
    q = np.asarray(q, float)
    q = q / np.linalg.norm(q)
    return np.array([q[1], q[2], q[3], q[0]])


def _quat_to_mat(q_xyzw):
    x, y, z, w = q_xyzw
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _mat_to_quat(R):
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-8:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        # w ≈ 0: 180° rotation; take the largest diagonal branch
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1e-12, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2.0
        axis = np.zeros(3)
        axis[i] = s / 4.0
        axis[j] = (R[j, i] + R[i, j]) / s
        axis[k] = (R[k, i] + R[i, k]) / s
        x, y, z = axis
        w = (R[k, j] - R[j, k]) / s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def _euler_to_mat(euler, seq="xyz", degrees=False):
    ang = np.asarray(euler, float)
    if degrees:
        ang = np.deg2rad(ang)

    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        if axis == "x":
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        if axis == "y":
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    R = np.eye(3)
    for axis, a in zip(seq, ang):
        R = R @ rot(axis, a)  # extrinsic xyz == intrinsic composition R_x R_y R_z reversed; MuJoCo eulerseq lowercase = extrinsic, applied left-to-right
    return R


class _T:
    """Rigid transform (R, p)."""

    __slots__ = ("R", "p")

    def __init__(self, R=None, p=None):
        self.R = np.eye(3) if R is None else np.asarray(R, float)
        self.p = np.zeros(3) if p is None else np.asarray(p, float)

    def __mul__(self, other):
        return _T(self.R @ other.R, self.p + self.R @ other.p)

    def apply(self, x):
        return self.R @ np.asarray(x, float) + self.p

    def quat(self):
        return _mat_to_quat(self.R)


# ---------------------------------------------------------------------------
# XML plumbing: includes, defaults, attribute parsing
# ---------------------------------------------------------------------------


def _splice_includes(elem, base_dir):
    """Replace ``<include file=…>`` elements by the included root's children
    (MuJoCo splicing semantics), recursively."""
    for i, child in enumerate(list(elem)):
        if child.tag == "include":
            path = os.path.join(base_dir, child.attrib["file"])
            sub = ET.parse(path).getroot()
            _splice_includes(sub, os.path.dirname(path))
            elem.remove(child)
            for j, sc in enumerate(list(sub)):
                elem.insert(i + j, sc)
        else:
            _splice_includes(child, base_dir)


def _collect_defaults(root):
    """class name → {tag → merged attribute dict}, honoring nesting."""
    out = {}

    def walk(delem, inherited):
        cls = delem.get("class", "main")
        merged = {tag: dict(attrs) for tag, attrs in inherited.items()}
        for child in delem:
            if child.tag == "default":
                continue
            merged.setdefault(child.tag, {}).update(child.attrib)
        out[cls] = merged
        for child in delem:
            if child.tag == "default":
                walk(child, merged)

    for delem in root.findall("default"):
        walk(delem, {})
    return out


def _resolved(elem, tag, defaults, childclass):
    """Element attributes with default-class fallbacks applied."""
    cls = elem.get("class", childclass)
    attrs = dict(defaults.get(cls, defaults.get("main", {})).get(tag, {}))
    attrs.update(elem.attrib)
    return attrs


def _floats(s, n=None):
    v = np.array([float(t) for t in s.split()])
    if n is not None and v.size != n:
        raise ValueError(f"expected {n} floats, got {s!r}")
    return v


def _frame_of(attrs, degrees):
    """(pos, quat/euler/xyaxes/zaxis) attributes → _T."""
    p = _floats(attrs["pos"], 3) if "pos" in attrs else np.zeros(3)
    if "quat" in attrs:
        R = _quat_to_mat(_quat_wxyz_to_xyzw(_floats(attrs["quat"], 4)))
    elif "euler" in attrs:
        R = _euler_to_mat(_floats(attrs["euler"], 3), degrees=degrees)
    elif "axisangle" in attrs:
        aa = _floats(attrs["axisangle"], 4)
        ax = aa[:3] / max(np.linalg.norm(aa[:3]), 1e-12)
        ang = np.deg2rad(aa[3]) if degrees else aa[3]
        c, s = np.cos(ang), np.sin(ang)
        K = np.array(
            [[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]]
        )
        R = np.eye(3) + s * K + (1 - c) * (K @ K)
    else:
        R = np.eye(3)
    return _T(R, p)


# ---------------------------------------------------------------------------
# inertia handling
# ---------------------------------------------------------------------------


def _inertial_of(elem, degrees):
    """<inertial> → (mass, com (3,), I_com (3,3)) in the body frame."""
    attrs = elem.attrib
    mass = float(attrs["mass"])
    com = _floats(attrs["pos"], 3) if "pos" in attrs else np.zeros(3)
    if "fullinertia" in attrs:
        ixx, iyy, izz, ixy, ixz, iyz = _floats(attrs["fullinertia"], 6)
        I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    else:
        diag = np.diag(_floats(attrs.get("diaginertia", "0 0 0"), 3))
        Tq = _frame_of({k: v for k, v in attrs.items() if k != "pos"}, degrees)
        I = Tq.R @ diag @ Tq.R.T
    return mass, com, I


def _geom_inertia(attrs, degrees):
    """Primitive-geom inertia (MuJoCo density rule) → (m, com, I) in body
    frame, or None for non-inertial geom types."""
    gtype = attrs.get("type", "sphere")
    density = float(attrs.get("density", 1000.0))
    T = _frame_of(attrs, degrees)
    size = _floats(attrs["size"]) if "size" in attrs else np.zeros(1)
    if "fromto" in attrs:
        ft = _floats(attrs["fromto"], 6)
        a, b = ft[:3], ft[3:]
        mid = 0.5 * (a + b)
        d = b - a
        L = np.linalg.norm(d)
        z = d / max(L, 1e-12)
        x = np.cross([0.0, 1.0, 0.0], z)
        if np.linalg.norm(x) < 1e-8:
            x = np.cross([1.0, 0.0, 0.0], z)
        x /= np.linalg.norm(x)
        T = _T(np.stack([x, np.cross(z, x), z], axis=1), mid)
        half = L / 2.0
    else:
        half = size[1] if size.size > 1 else 0.0

    if gtype == "sphere":
        r = size[0]
        m = density * 4.0 / 3.0 * np.pi * r**3
        I = np.eye(3) * (2.0 / 5.0 * m * r * r)
    elif gtype == "box":
        hx, hy, hz = size[:3]
        m = density * 8.0 * hx * hy * hz
        I = (
            np.diag([hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy])
            * m
            / 3.0
        )
    elif gtype == "cylinder":
        r, h = size[0], half
        m = density * np.pi * r * r * (2 * h)
        ixx = m * (3 * r * r + 4 * h * h) / 12.0
        I = np.diag([ixx, ixx, m * r * r / 2.0])
    elif gtype == "capsule":
        r, h = size[0], half
        mc = density * np.pi * r * r * (2 * h)
        ms = density * 4.0 / 3.0 * np.pi * r**3
        m = mc + ms
        izz = mc * r * r / 2.0 + ms * 2.0 / 5.0 * r * r
        ixx = (
            mc * (3 * r * r + 4 * h * h) / 12.0
            + ms * (2.0 / 5.0 * r * r + h * h + 3.0 / 8.0 * r * h)
        )
        I = np.diag([ixx, ixx, izz])
    else:  # plane, mesh, hfield… carry no density-inertia here
        return None
    I_body = T.R @ I @ T.R.T
    return m, T.p, I_body


def _fuse(contribs):
    """Combine (m, com, I_com) contributions expressed in one frame."""
    total_m = sum(c[0] for c in contribs)
    if total_m <= 0.0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    com = sum(c[0] * c[1] for c in contribs) / total_m
    I = np.zeros((3, 3))
    for m, c, Ic in contribs:
        d = c - com
        I = I + Ic + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return total_m, com, I


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------


def load_mjcf(path, root_joint=None, skip_bodies=(), dtype=torch.float64, device="cuda"):
    """Parse an MJCF file into ``(RobotModel, info)``, the model's tensors
    in ``dtype`` on ``device`` (the card unless ``"cpu"`` is asked for).

    ``root_joint='freeflyer'`` gives jointless top-level bodies a synthetic
    free-flyer (the reference app's *physical* free-floating base, which the
    MJCF expresses by welding the bus to the world and MuJoCo's zero-g
    option). ``skip_bodies``: body names (subtrees) to drop, e.g. the free
    grasp object when building the robot alone. ``info`` carries
    ``joint_names``, ``frame_names``, per-dof ``damping``/``armature``
    (armature also lives on the model and enters the mass matrix),
    ``actuated_dofs`` from ``<actuator>`` motors, and ``gravity``.
    """
    tree = ET.parse(path)
    root = tree.getroot()
    _splice_includes(root, os.path.dirname(os.path.abspath(path)))

    compiler = root.find("compiler")
    degrees = True  # MuJoCo default angle="degree"
    if compiler is not None and compiler.get("angle", "degree") == "radian":
        degrees = False

    option = root.find("option")
    gravity = np.array([0.0, 0.0, -9.81])
    if option is not None and option.get("gravity"):
        gravity = _floats(option.get("gravity"), 3)

    defaults = _collect_defaults(root)

    joints = []  # dicts for make_model (placement filled, inertia later)
    joint_names = []
    joint_inertia = []  # list of contrib lists, per joint
    frames = []  # dicts for make_model
    dof_damping = []
    dof_armature = []
    dof_names = []  # joint name per dof

    def add_frame(name, parent_joint, T):
        if parent_joint < 0:
            return  # fixed to world: no movable parent to attach to
        frames.append(
            dict(
                name=name,
                parent=parent_joint,
                placement_p=T.p,
                placement_q=T.quat(),
            )
        )

    def walk_body(body, parent_joint, X_acc, childclass, top_level=False):
        """``X_acc``: transform from the parent joint frame (or world) to
        the *parent body* frame."""
        cc = body.get("childclass", childclass)
        Xb = X_acc * _frame_of(body.attrib, degrees)
        name = body.get("name", f"body{len(frames)}")
        if name in skip_bodies:
            return

        jelems = body.findall("joint") + body.findall("freejoint")
        if len(jelems) > 1:
            raise ValueError(
                f"body {name!r}: multiple joints per body not supported"
            )

        if not jelems and top_level and root_joint == "freeflyer":
            synth = ET.Element("joint", {"type": "free"})
            jelems = [synth]

        if jelems:
            jel = jelems[0]
            attrs = _resolved(jel, "joint", defaults, cc)
            jtype = attrs.get("type", "hinge")
            if jel.tag == "freejoint":
                jtype = "free"
            if jtype == "ball":
                raise ValueError(f"body {name!r}: ball joints not supported")
            jpos = _floats(attrs["pos"], 3) if "pos" in attrs else np.zeros(3)
            if jtype == "free":
                jpos = np.zeros(3)
            axis = (
                _floats(attrs["axis"], 3) if "axis" in attrs
                else np.array([0.0, 0.0, 1.0])
            )
            axis = axis / max(np.linalg.norm(axis), 1e-12)
            X_pj_joint = Xb * _T(None, jpos)
            X_j_b = _T(None, -jpos)  # body frame seen from the joint frame

            jidx = len(joints)
            mtype = {
                "hinge": REVOLUTE, "slide": PRISMATIC, "free": FREEFLYER
            }[jtype]
            joints.append(
                dict(
                    type=mtype,
                    parent=parent_joint,
                    placement_p=X_pj_joint.p,
                    placement_q=X_pj_joint.quat(),
                    axis=axis,
                )
            )
            jname = attrs.get("name", f"joint_{name}")
            joint_names.append(jname)
            joint_inertia.append([])
            nv_j = 6 if mtype == FREEFLYER else 1
            dof_damping.extend([float(attrs.get("damping", 0.0))] * nv_j)
            dof_armature.extend([float(attrs.get("armature", 0.0))] * nv_j)
            dof_names.extend([jname] * nv_j)
            inertia_target, X_to_target = jidx, X_j_b
        else:
            # welded: fuse into the nearest jointed ancestor (or drop at
            # the world, as Pinocchio merges into the universe)
            inertia_target, X_to_target = parent_joint, Xb

        # inertial properties, expressed in the target joint frame
        inertial = body.find("inertial")
        contribs = []
        if inertial is not None:
            contribs.append(_inertial_of(inertial, degrees))
        else:
            for g in body.findall("geom"):
                gattrs = _resolved(g, "geom", defaults, cc)
                gi = _geom_inertia(gattrs, degrees)
                if gi is not None:
                    contribs.append(gi)
            if not contribs and jelems:
                raise ValueError(
                    f"body {name!r} has a joint but no <inertial> and no "
                    "primitive geoms to derive inertia from"
                )
        if inertia_target >= 0:
            for m, c, I in contribs:
                c_t = X_to_target.apply(c)
                I_t = X_to_target.R @ I @ X_to_target.R.T
                joint_inertia[inertia_target].append((m, c_t, I_t))

        # frames: the body itself + its sites
        add_frame(name, inertia_target, X_to_target)
        for s in body.findall("site"):
            Ts = X_to_target * _frame_of(s.attrib, degrees)
            add_frame(s.get("name", f"site{len(frames)}"), inertia_target, Ts)

        X_child = X_to_target if jelems or inertia_target < 0 else X_to_target
        for child in body.findall("body"):
            walk_body(child, inertia_target, X_child, cc)

    world = root.find("worldbody")
    if world is None:
        raise ValueError("no <worldbody>")
    for body in world.findall("body"):
        walk_body(body, -1, _T(), None, top_level=True)

    if not joints:
        raise ValueError("model has no joints")

    # finalize inertias
    for j, contribs in zip(joints, joint_inertia):
        m, com, I = _fuse(contribs)
        j["mass"] = m
        j["com"] = com
        j["inertia"] = I

    armature = np.asarray(dof_armature)
    model = make_model(
        joints, frames, gravity=tuple(gravity), dtype=dtype, device=device,
        armature=armature if np.any(armature != 0.0) else None,
    )

    # actuated dofs from <actuator> motors/general/position elements
    actuated = []
    act = root.find("actuator")
    if act is not None:
        name_to_dofs = {}
        for d, jn in enumerate(dof_names):
            name_to_dofs.setdefault(jn, []).append(d)
        for motor in act:
            jn = motor.get("joint")
            if jn is not None:
                actuated.extend(name_to_dofs.get(jn, []))

    info = dict(
        joint_names=tuple(joint_names),
        frame_names=model.frame_names,
        damping=np.asarray(dof_damping),
        armature=armature,
        actuated_dofs=tuple(actuated),
        gravity=gravity,
    )
    return model, info
