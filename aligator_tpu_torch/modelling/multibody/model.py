"""Rigid-body model and algorithms, batched (world-frame einsum form).

PyTorch counterpart of ``aligator_tpu/modelling/multibody/model.py``: a
kinematic tree of revolute, prismatic and free-flyer joints, forward
kinematics, RNEA, the mass matrix and frame placements and Jacobians. Every
function takes configurations ``q (..., nq)`` (and ``v``, ``a`` ``(...,
nv)``) with any leading dims and returns its results with the same leading
dims.

As in the JAX package, the topology is static (numpy tables built once per
model), every joint is evaluated for all three joint types and the right
branch selected by type code, and after forward kinematics everything is an
einsum over the static ancestor mask ``A (nbody, nv)``: world dof axes
``Phi``, body velocities ``V = (A ⊙ v) Φ``, accelerations, Newton-Euler
forces, ``τ = Σ Φ ⊙ (Aᵀ f)`` and ``M = Σ_b (A_b Φ)ᵀ I_b (A_b Φ)``. Forward
kinematics composes the tree level by level (7 levels for the humanoid),
where the JAX package scans over the 23 joints one by one, so the host
dispatches one small batched product per level.

Spatial vectors are (linear, angular) 6-vectors; free-flyer velocities are
body-frame coordinates (pinocchio's layout).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from ..._device import resolve
from ...core.manifolds import CartesianProduct, Manifold, TangentBundle, VectorSpace
from ..spaces.se3 import SE3, cross, exp3_quat, quat_to_matrix

REVOLUTE = "revolute"
PRISMATIC = "prismatic"
FREEFLYER = "freeflyer"

_JOINT_NQ = {REVOLUTE: 1, PRISMATIC: 1, FREEFLYER: 7}
_JOINT_NV = {REVOLUTE: 1, PRISMATIC: 1, FREEFLYER: 6}
_CODE = {REVOLUTE: 0, PRISMATIC: 1, FREEFLYER: 2}
LEAVES = ("jplac_p", "jplac_q", "axes", "mass", "com", "inertia", "gravity",
          "fplac_p", "fplac_q")


@dataclasses.dataclass
class RobotModel:
    """Kinematic tree. Joint i has parent ``parents[i] < i`` (root = -1)."""

    jplac_p: Tensor  # (nj, 3)   parent_T_joint translation
    jplac_q: Tensor  # (nj, 4)   parent_T_joint quaternion (x,y,z,w)
    axes: Tensor  # (nj, 3)   joint axis in joint frame (rev/prism)
    mass: Tensor  # (nj,)
    com: Tensor  # (nj, 3)   body com in joint frame
    inertia: Tensor  # (nj, 3, 3) rotational inertia about the com
    gravity: Tensor  # (3,)
    fplac_p: Tensor  # (nf, 3)
    fplac_q: Tensor  # (nf, 4)
    joint_types: tuple = ()
    parents: tuple = ()
    frame_parents: tuple = ()
    frame_names: tuple = ()

    @property
    def njoints(self) -> int:
        return len(self.joint_types)

    @property
    def nq(self) -> int:
        return sum(_JOINT_NQ[t] for t in self.joint_types)

    @property
    def nv(self) -> int:
        return sum(_JOINT_NV[t] for t in self.joint_types)

    def frame_id(self, name: str) -> int:
        return self.frame_names.index(name)

    def to(self, dtype=None, device=None) -> "RobotModel":
        """A copy with every leaf tensor cast to ``dtype`` on ``device``."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(dtype=dtype, device=device) for k in LEAVES})

    def configuration_space(self) -> Manifold:
        comps = [SE3() if t == FREEFLYER else VectorSpace(1)
                 for t in self.joint_types]
        return comps[0] if len(comps) == 1 else CartesianProduct(*comps)

    def phase_space(self) -> Manifold:
        return TangentBundle(self.configuration_space())

    def neutral(self, dtype=None, device=None) -> Tensor:
        return self.configuration_space().neutral(dtype, device)


def make_model(joints, frames=(), gravity=(0.0, 0.0, -9.81), dtype=torch.float64,
               device="cuda") -> RobotModel:
    """Build a RobotModel from joint descriptions (as the JAX ``make_model``):
    ``joints`` are dicts with keys type, parent, placement_p, placement_q
    (optional), axis (rev/prism), mass, com, inertia (about the com, in the
    joint frame); ``frames`` dicts with name, parent (joint index),
    placement_p, placement_q (optional). On the card unless ``device="cpu"``
    is asked for."""
    device = resolve(device)
    ident_q = (0.0, 0.0, 0.0, 1.0)

    def stack(rows, shape):
        arr = np.asarray([np.asarray(r, np.float64) for r in rows], np.float64)
        return torch.tensor(arr.reshape((len(rows),) + shape), dtype=dtype,
                            device=device)

    return RobotModel(
        jplac_p=stack([j.get("placement_p", (0.0, 0.0, 0.0)) for j in joints], (3,)),
        jplac_q=stack([j.get("placement_q", ident_q) for j in joints], (4,)),
        axes=stack([j.get("axis", (0.0, 0.0, 1.0)) for j in joints], (3,)),
        mass=stack([j["mass"] for j in joints], ()),
        com=stack([j["com"] for j in joints], (3,)),
        inertia=stack([j["inertia"] for j in joints], (3, 3)),
        gravity=torch.tensor(gravity, dtype=dtype, device=device),
        fplac_p=stack([f.get("placement_p", (0.0, 0.0, 0.0)) for f in frames], (3,)),
        fplac_q=stack([f.get("placement_q", ident_q) for f in frames], (4,)),
        joint_types=tuple(j["type"] for j in joints),
        parents=tuple(int(j.get("parent", i - 1)) for i, j in enumerate(joints)),
        frame_parents=tuple(int(f["parent"]) for f in frames),
        frame_names=tuple(str(f.get("name", f"frame{k}")) for k, f in enumerate(frames)),
    )


# ---------------------------------------------------------------------------
# spatial algebra ((linear, angular) 6-vectors, broadcasting over leading dims)
# ---------------------------------------------------------------------------


def motion_cross(m1: Tensor, m2: Tensor) -> Tensor:
    """m1 ×ₘ m2 (spatial motion cross product)."""
    v1, w1 = m1[..., :3], m1[..., 3:]
    v2, w2 = m2[..., :3], m2[..., 3:]
    return torch.cat([cross(w1, v2) + cross(v1, w2), cross(w1, w2)], -1)


def motion_cross_force(m: Tensor, f: Tensor) -> Tensor:
    """m ×* f (spatial force cross product)."""
    v, w = m[..., :3], m[..., 3:]
    fl, tau = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, fl), cross(w, tau) + cross(v, fl)], -1)


def inertia_apply(mass: Tensor, com: Tensor, I_com: Tensor, m: Tensor) -> Tensor:
    """Spatial momentum h = I·m of a body with (mass, com, I about the com),
    all in the frame of the motion vector ``m``. Broadcasts."""
    v, w = m[..., :3], m[..., 3:]
    p_lin = mass[..., None] * (v + cross(w, com))
    L = (I_com @ w[..., None])[..., 0] + cross(com, p_lin)
    return torch.cat([p_lin, L], -1)


# ---------------------------------------------------------------------------
# static topology tables (numpy, built once per topology)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def topology(joint_types: tuple, parents: tuple) -> dict:
    """Static index tables of the uniform-joint formulation (the JAX
    ``_topology``), plus the joints of each tree level for forward
    kinematics. Callers must not mutate the arrays."""
    nj = len(joint_types)
    codes = np.array([_CODE[t] for t in joint_types], dtype=np.int64)
    # padded q gather: every joint sees a 7-wide q (freeflyer layout); the
    # default fill (0,0,0, 0,0,0,1) keeps every branch finite
    q_idx = np.zeros((nj, 7), dtype=np.int64)
    q_mask = np.zeros((nj, 7))
    dof_joint, dof_col = [], []
    iq = 0
    for i, t in enumerate(joint_types):
        nq_i = _JOINT_NQ[t]
        q_idx[i, :nq_i] = np.arange(iq, iq + nq_i)
        q_mask[i, :nq_i] = 1.0
        dof_joint += [i] * _JOINT_NV[t]
        dof_col += list(range(_JOINT_NV[t]))
        iq += nq_i
    dof_joint = np.array(dof_joint, dtype=np.int64)
    anc = np.zeros((nj, nj))
    depth = np.zeros(nj, dtype=np.int64)
    for b in range(nj):
        j = b
        while j >= 0:
            anc[b, j] = 1.0
            j = parents[j]
        depth[b] = int(anc[b].sum()) - 1
    A = anc[:, dof_joint]  # (nj, nv) ancestor-or-self mask per dof
    levels = [np.nonzero(depth == d)[0] for d in range(int(depth.max()) + 1)]
    pb = np.array(parents, dtype=np.int64)[dof_joint]  # parent body of each dof
    return {
        "codes": codes,
        "parents": np.array(parents, dtype=np.int64),
        "q_idx": q_idx,
        "q_mask": q_mask,
        "q_default": np.tile([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], (nj, 1)),
        "dof_joint": dof_joint,
        "dof_col": np.array(dof_col, dtype=np.int64),
        "A": A,
        "D": A[dof_joint, :],  # (nv, nv) D[k, j] = 1 iff joint(j) ⪯ joint(k)
        "dof_parent": pb,
        "levels": levels,
    }


@functools.lru_cache(maxsize=None)
def _device_tables(joint_types: tuple, parents: tuple, dtype, device) -> dict:
    """The topology tables as tensors on ``device`` (float tables in
    ``dtype``), made once: a host-to-device copy per call would serialize
    the stream."""
    top = topology(joint_types, parents)
    # row-major: the CUDA kernels read A and D through raw pointers (numpy's
    # A = anc[:, dof_joint] comes out column-major)
    out = {k: torch.as_tensor(np.ascontiguousarray(top[k]), dtype=dtype, device=device)
           for k in ("q_mask", "q_default", "A", "D")}
    for k in ("codes", "q_idx", "dof_joint", "dof_col"):
        out[k] = torch.as_tensor(top[k], device=device)
    out["dof_codes"] = out["codes"][out["dof_joint"]]
    pb = top["dof_parent"]
    out["dof_parent"] = torch.as_tensor(pb.clip(min=0), device=device)
    out["has_parent"] = torch.as_tensor((pb >= 0)[:, None], dtype=dtype, device=device)
    out["levels"] = [(torch.as_tensor(idx, device=device),
                      torch.as_tensor(top["parents"][idx], device=device))
                     for idx in top["levels"]]
    return out


def tables(model: RobotModel, like: Tensor) -> dict:
    """:func:`_device_tables` for the dtype and device of ``like``."""
    return _device_tables(model.joint_types, model.parents, like.dtype, like.device)


def _local_transforms(model: RobotModel, q: Tensor):
    """(R, p) of every joint in its parent frame: ``(..., nj, 3, 3)``,
    ``(..., nj, 3)``; all three joint types evaluated, selected by code."""
    tab = tables(model, q)
    mask = tab["q_mask"]
    q_pad = q[..., tab["q_idx"]] * mask + tab["q_default"] * (1.0 - mask)
    codes = tab["codes"]
    R0 = quat_to_matrix(model.jplac_q.to(q.dtype))
    p0 = model.jplac_p.to(q.dtype)
    a = model.axes.to(q.dtype)
    R_rev = quat_to_matrix(exp3_quat(a * q_pad[..., 0:1]))
    p_prism = a * q_pad[..., 0:1]
    R_ff = quat_to_matrix(q_pad[..., 3:7])
    p_ff = q_pad[..., :3]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    is_rev = (codes == 0)[:, None, None]
    is_ff = (codes == 2)[:, None, None]
    R_j = torch.where(is_rev, R_rev, torch.where(is_ff, R_ff, eye))
    p_j = torch.where((codes == 1)[:, None], p_prism,
                      torch.where((codes == 2)[:, None], p_ff, torch.zeros_like(p_ff)))
    return R0 @ R_j, p0 + (R0 @ p_j[..., None])[..., 0]


def fk_world(model: RobotModel, q: Tensor):
    """World pose (R, p) of every joint, composed one tree level at a time."""
    R_loc, p_loc = _local_transforms(model, q)
    R = torch.empty_like(R_loc)
    p = torch.empty_like(p_loc)
    for lvl, (i, par) in enumerate(tables(model, q)["levels"]):
        if lvl == 0:
            R[..., i, :, :] = R_loc[..., i, :, :]
            p[..., i, :] = p_loc[..., i, :]
            continue
        Rp = R[..., par, :, :]
        R[..., i, :, :] = Rp @ R_loc[..., i, :, :]
        p[..., i, :] = p[..., par, :] + (Rp @ p_loc[..., i, :, None])[..., 0]
    return R, p


def _world_axes(model: RobotModel, R: Tensor, p: Tensor) -> Tensor:
    """Phi (..., nv, 6): world-frame motion axis of each dof at the world
    origin."""
    tab = tables(model, R)
    dj, codes = tab["dof_joint"], tab["dof_codes"]
    a = model.axes.to(R.dtype)[dj]  # (nv, 3)
    zero3 = torch.zeros_like(a)
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)[tab["dof_col"]]
    S_loc = torch.where((codes == 0)[:, None], torch.cat([zero3, a], 1),
                        torch.where((codes == 1)[:, None], torch.cat([a, zero3], 1), eye6))
    Rj, pj = R[..., dj, :, :], p[..., dj, :]
    w_ang = (Rj @ S_loc[:, 3:, None])[..., 0]
    w_lin = (Rj @ S_loc[:, :3, None])[..., 0] + cross(pj, w_ang)
    return torch.cat([w_lin, w_ang], -1)


def kinematics(model: RobotModel, q: Tensor, v: Optional[Tensor] = None) -> dict:
    """One-pass kinematic data: 'R' (..., nj, 3, 3), 'p' (..., nj, 3), 'Phi'
    (..., nv, 6), 'A' (nj, nv) [, 'V' (..., nj, 6) world-origin body
    velocities and 'v' if ``v`` is given]."""
    R, p = fk_world(model, q)
    Phi = _world_axes(model, R, p)
    A = tables(model, q)["A"]
    out = {"R": R, "p": p, "Phi": Phi, "A": A}
    if v is not None:
        out["V"] = torch.einsum("bk,...k,...ks->...bs", A, v, Phi)
        out["v"] = v
    return out


def world_inertia(model: RobotModel, R: Tensor, p: Tensor):
    """Per-body (mass, world com, world-rotated I_com)."""
    m = model.mass.to(R.dtype)
    c_w = p + (R @ model.com.to(R.dtype)[..., None])[..., 0]
    I_w = R @ model.inertia.to(R.dtype) @ R.mT
    return m, c_w, I_w


def _world_inertia_cached(model, kin):
    if "_world_inertia" not in kin:
        kin["_world_inertia"] = world_inertia(model, kin["R"], kin["p"])
    return kin["_world_inertia"]


def gravity_offset(model: RobotModel, like: Tensor) -> Tensor:
    g = model.gravity.to(like.dtype)
    return torch.cat([-g, torch.zeros_like(g)])


def body_accelerations(model: RobotModel, kin: dict, a: Tensor) -> Tensor:
    """World-origin spatial accelerations (..., nj, 6) incl. the gravity
    offset."""
    A, Phi, V, v = kin["A"], kin["Phi"], kin["V"], kin["v"]
    beta = motion_cross(V[..., tables(model, a)["dof_joint"], :], Phi * v[..., None])
    return (torch.einsum("bk,...k,...ks->...bs", A, a, Phi)
            + torch.einsum("bk,...ks->...bs", A, beta) + gravity_offset(model, a))


def rnea(model: RobotModel, q: Tensor, v: Tensor, a: Tensor,
         kin: Optional[dict] = None) -> Tensor:
    """Inverse dynamics τ = RNEA(q, v, a); pass ``kin`` (from
    ``kinematics(model, q, v)``) to share the kinematics pass."""
    if kin is None:
        kin = kinematics(model, q, v)
    Acc = body_accelerations(model, kin, a)
    m, c_w, I_w = _world_inertia_cached(model, kin)
    V = kin["V"]
    h = inertia_apply(m, c_w, I_w, V)
    f = inertia_apply(m, c_w, I_w, Acc) + motion_cross_force(V, h)
    return (kin["Phi"] * torch.einsum("bk,...bs->...ks", kin["A"], f)).sum(-1)


def mass_matrix(model: RobotModel, q: Tensor, kin: Optional[dict] = None) -> Tensor:
    """Joint-space inertia M(q) (..., nv, nv), one dense contraction."""
    if kin is None:
        kin = kinematics(model, q)
    A, Phi = kin["A"], kin["Phi"]
    m, c_w, I_w = _world_inertia_cached(model, kin)
    Psi = Phi[..., None, :, :] * A[:, :, None]  # (..., nj, nv, 6) masked axes
    IPsi = inertia_apply(m[:, None], c_w[..., None, :], I_w[..., None, :, :], Psi)
    M = torch.einsum("...bks,...bls->...kl", Psi, IPsi)
    return 0.5 * (M + M.mT)


def frame_placement(model: RobotModel, q: Tensor, frame_id: int,
                    kin: Optional[dict] = None):
    """World pose (R (..., 3, 3), p (..., 3)) of an operational frame."""
    if kin is None:
        kin = kinematics(model, q)
    par = model.frame_parents[frame_id]
    Rf = quat_to_matrix(model.fplac_q[frame_id].to(q.dtype))
    pf = model.fplac_p[frame_id].to(q.dtype)
    Rp = kin["R"][..., par, :, :]
    return Rp @ Rf, kin["p"][..., par, :] + (Rp @ pf[:, None])[..., 0]


def frame_jacobian_lwa(model: RobotModel, q: Tensor, frame_id: int,
                       kin: Optional[dict] = None) -> Tensor:
    """(..., 6, nv) LOCAL_WORLD_ALIGNED frame Jacobian (linear at the frame
    origin, world-aligned axes), from the world dof axes."""
    if kin is None:
        kin = kinematics(model, q)
    par = model.frame_parents[frame_id]
    _, pw = frame_placement(model, q, frame_id, kin=kin)
    Phi = kin["Phi"]
    mask = kin["A"][par][:, None]
    lin = (Phi[..., :3] + cross(Phi[..., 3:], pw[..., None, :])) * mask
    ang = Phi[..., 3:] * mask
    return torch.cat([lin.mT, ang.mT], -2)
