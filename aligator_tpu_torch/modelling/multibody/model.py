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
from ..._linalg import cholesky, cholesky_solve_tri
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
    # per-dof reflected rotor inertia (MJCF/URDF ``armature``), added to the
    # mass matrix's diagonal and to RNEA's τ as armature·q̈; None ⇔ zeros
    armature: Optional[Tensor] = None  # (nv,)
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

    @property
    def q_slices(self) -> list:
        """``(start, stop)`` of each joint's configuration coordinates."""
        return _slices(self.joint_types, _JOINT_NQ)

    @property
    def v_slices(self) -> list:
        """``(start, stop)`` of each joint's velocity coordinates."""
        return _slices(self.joint_types, _JOINT_NV)

    def frame_id(self, name: str) -> int:
        return self.frame_names.index(name)

    def to(self, dtype=None, device=None) -> "RobotModel":
        """A copy with every leaf tensor (the armature too) cast to ``dtype``
        on ``device``."""
        arm = self.armature
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(dtype=dtype, device=device) for k in LEAVES},
            armature=None if arm is None else arm.to(dtype=dtype, device=device))

    def configuration_space(self) -> Manifold:
        comps = [SE3() if t == FREEFLYER else VectorSpace(1)
                 for t in self.joint_types]
        return comps[0] if len(comps) == 1 else CartesianProduct(*comps)

    def phase_space(self) -> Manifold:
        return TangentBundle(self.configuration_space())

    def neutral(self, dtype=None, device=None) -> Tensor:
        """The neutral configuration, in the model's own dtype and on its
        device unless others are asked for."""
        return self.configuration_space().neutral(
            self.mass.dtype if dtype is None else dtype,
            self.mass.device if device is None else device)


def _slices(joint_types, width) -> list:
    out, i = [], 0
    for t in joint_types:
        out.append((i, i + width[t]))
        i += width[t]
    return out


def with_frame(model: RobotModel, name: str, parent: int, placement_p=None,
               placement_q=None) -> RobotModel:
    """A copy of ``model`` with one more operational frame on joint
    ``parent`` (identity placement unless given)."""
    like = model.fplac_p
    p = like.new_zeros(3) if placement_p is None else torch.as_tensor(
        placement_p, dtype=like.dtype, device=like.device)
    qq = like.new_tensor([0.0, 0.0, 0.0, 1.0]) if placement_q is None else \
        torch.as_tensor(placement_q, dtype=like.dtype, device=like.device)
    return dataclasses.replace(
        model,
        fplac_p=torch.cat([model.fplac_p, p[None]], 0),
        fplac_q=torch.cat([model.fplac_q, qq[None]], 0),
        frame_parents=model.frame_parents + (int(parent),),
        frame_names=model.frame_names + (str(name),),
    )


def make_model(joints, frames=(), gravity=(0.0, 0.0, -9.81), dtype=torch.float64,
               device="cuda", armature=None) -> RobotModel:
    """Build a RobotModel from joint descriptions (as the JAX ``make_model``):
    ``joints`` are dicts with keys type, parent, placement_p, placement_q
    (optional), axis (rev/prism), mass, com, inertia (about the com, in the
    joint frame); ``frames`` dicts with name, parent (joint index),
    placement_p, placement_q (optional); ``armature`` an optional (nv,)
    per-dof reflected rotor inertia. On the card unless ``device="cpu"`` is
    asked for."""
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
        armature=None if armature is None else torch.tensor(
            np.asarray(armature, np.float64), dtype=dtype, device=device),
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
    # row-major (numpy's A = anc[:, dof_joint] comes out column-major): the
    # sums over A and D keep the order, and the fp32 roundoff, that the
    # tests and fixtures were made with
    out = {k: torch.as_tensor(np.ascontiguousarray(top[k]), dtype=dtype, device=device)
           for k in ("q_mask", "q_default", "A", "D")}
    for k in ("codes", "q_idx", "dof_joint", "dof_col"):
        out[k] = torch.as_tensor(top[k], device=device)
    out["dof_codes"] = out["codes"][out["dof_joint"]]
    # the free-dynamics kernel's joint table: type, parent, first q and v index
    v_first = np.searchsorted(top["dof_joint"], np.arange(len(joint_types)))
    out["itab"] = torch.as_tensor(np.concatenate(
        [top["codes"], top["parents"], top["q_idx"][:, 0], v_first]).astype(np.int32),
        device=device)
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


def _placement_rotations(model: RobotModel, like: Tensor, frames: bool = False) -> Tensor:
    """The joints' placement rotations (nj, 3, 3), or with ``frames`` the
    operational frames' (nf, 3, 3), in ``like``'s dtype and device, made
    once a model: constant, they would otherwise cost ~45 small operations
    in every kinematics pass (or frame placement) of a rollout. Not kept
    when made while a CUDA graph is being captured (such a tensor holds its
    values only after a replay) or when the placements take gradients."""
    key = (like.dtype, like.device, frames)
    cache = model.__dict__.setdefault("_placement_rotations", {})
    R0 = cache.get(key)
    if R0 is None:
        quats = model.fplac_q if frames else model.jplac_q
        R0 = quat_to_matrix(quats.to(like.dtype))
        capturing = like.is_cuda and torch.cuda.is_current_stream_capturing()
        if not (capturing or quats.requires_grad):
            cache[key] = R0
    return R0


def _local_transforms(model: RobotModel, q: Tensor):
    """(R, p) of every joint in its parent frame: ``(..., nj, 3, 3)``,
    ``(..., nj, 3)``; each joint type the model has evaluated for every
    joint, selected by code."""
    tab = tables(model, q)
    types = set(model.joint_types)
    codes = tab["codes"]
    a = model.axes.to(q.dtype)
    if FREEFLYER in types:
        mask = tab["q_mask"]
        q_pad = q[..., tab["q_idx"]] * mask + tab["q_default"] * (1.0 - mask)
        th = q_pad[..., 0:1]
    else:  # one coordinate a joint
        th = q[..., tab["q_idx"][:, 0]][..., None]
    lead = th.shape[:-1]
    R_j = torch.eye(3, dtype=q.dtype, device=q.device)
    p_j = th.new_zeros(lead + (3,))
    if FREEFLYER in types:
        R_j = torch.where((codes == 2)[:, None, None], quat_to_matrix(q_pad[..., 3:7]), R_j)
        p_j = torch.where((codes == 2)[:, None], q_pad[..., :3], p_j)
    if PRISMATIC in types:
        p_j = torch.where((codes == 1)[:, None], a * th, p_j)
    if REVOLUTE in types:
        R_j = torch.where((codes == 0)[:, None, None], quat_to_matrix(exp3_quat(a * th)), R_j)
    R0 = _placement_rotations(model, q)
    p0 = model.jplac_p.to(q.dtype)
    return R0 @ R_j.expand(lead + (3, 3)), p0 + (R0 @ p_j[..., None])[..., 0]


def _fk(model: RobotModel, q: Tensor, at_first_joint: bool = False):
    """World pose (R, p) of every joint, composed one tree level at a time,
    and the point the positions are taken from: the world origin (None) or,
    with ``at_first_joint``, the first joint's world position (..., 3), its
    placement and, for a free-flyer, its translation (the roots' positions
    less it, the rest composed from them, as ``csrc/free_fd.cu`` does)."""
    R_loc, p_loc = _local_transforms(model, q)
    origin = p_loc[..., 0, :] if at_first_joint else None
    R = torch.empty_like(R_loc)
    p = torch.empty_like(p_loc)
    for lvl, (i, par) in enumerate(tables(model, q)["levels"]):
        if lvl == 0:
            R[..., i, :, :] = R_loc[..., i, :, :]
            p[..., i, :] = (p_loc[..., i, :] if origin is None
                            else p_loc[..., i, :] - origin[..., None, :])
            continue
        Rp = R[..., par, :, :]
        R[..., i, :, :] = Rp @ R_loc[..., i, :, :]
        p[..., i, :] = p[..., par, :] + (Rp @ p_loc[..., i, :, None])[..., 0]
    return R, p, origin


def fk_world(model: RobotModel, q: Tensor):
    """World pose (R, p) of every joint, composed one tree level at a time."""
    return _fk(model, q)[:2]


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


def kinematics(model: RobotModel, q: Tensor, v: Optional[Tensor] = None,
               at_first_joint: bool = False) -> dict:
    """One-pass kinematic data: 'R' (..., nj, 3, 3), 'p' (..., nj, 3), 'Phi'
    (..., nv, 6), 'A' (nj, nv) [, 'V' (..., nj, 6) body velocities and 'v'
    if ``v`` is given], every spatial quantity at the world origin or, with
    ``at_first_joint``, at the first joint's position 'origin' (..., 3):
    the positions are then relative to it, so that far from the world
    origin (a free-flying base at 5e9 m, which an exploding line-search
    trial reaches) the spatial inertias' m ĉĉ terms do not cancel to
    garbage. Joint-space results (RNEA, the mass matrix, the LWA
    Jacobians) are invariant under the shift, gravity being uniform; only
    their rounding changes."""
    R, p, origin = _fk(model, q, at_first_joint)
    Phi = _world_axes(model, R, p)
    A = tables(model, q)["A"]
    out = {"R": R, "p": p, "Phi": Phi, "A": A}
    if origin is not None:
        out["origin"] = origin
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


def ext_forces_world(kin: dict, ext: Tensor) -> Tensor:
    """External spatial forces ``(..., nj, 6)`` given in each joint's local
    frame, expressed at the world origin."""
    R, p = kin["R"], kin["p"]
    fl = (R @ ext[..., :3, None])[..., 0]
    return torch.cat([fl, (R @ ext[..., 3:, None])[..., 0] + cross(p, fl)], -1)


def rnea(model: RobotModel, q: Tensor, v: Tensor, a: Tensor,
         ext_forces: Optional[Tensor] = None, kin: Optional[dict] = None) -> Tensor:
    """Inverse dynamics τ = RNEA(q, v, a). ``ext_forces``: external spatial
    forces ``(..., nj, 6)`` in each joint's local frame (pinocchio's
    ``fext``). Pass ``kin`` (from ``kinematics(model, q, v)``) to share the
    kinematics pass."""
    if kin is None:
        kin = kinematics(model, q, v)
    Acc = body_accelerations(model, kin, a)
    m, c_w, I_w = _world_inertia_cached(model, kin)
    V = kin["V"]
    h = inertia_apply(m, c_w, I_w, V)
    f = inertia_apply(m, c_w, I_w, Acc) + motion_cross_force(V, h)
    if ext_forces is not None:
        f = f - ext_forces_world(kin, ext_forces)
    tau = (kin["Phi"] * torch.einsum("bk,...bs->...ks", kin["A"], f)).sum(-1)
    if model.armature is not None:
        tau = tau + model.armature.to(a.dtype) * a
    return tau


def nonlinear_effects(model: RobotModel, q: Tensor, v: Tensor) -> Tensor:
    """Coriolis, centrifugal and gravity torques b(q, v) = RNEA(q, v, 0)."""
    return rnea(model, q, v, torch.zeros_like(v))


def aba(model: RobotModel, q: Tensor, v: Tensor, tau: Tensor,
        ext_forces: Optional[Tensor] = None) -> Tensor:
    """Forward dynamics q̈ = M(q)⁻¹(τ − b(q, v)), M and b from one
    kinematics pass taken at the first joint (as ``csrc/free_fd.cu``; the
    JAX package's ``_aba_impl`` works at the world origin, the same
    function), M⁻¹ by a batched Cholesky (the JAX package solves it in XLA
    too, outside its kernels) and two triangular solves, which a CUDA graph
    can capture. Differentiable by plain autograd,
    forward and reverse; the solvers read the analytic
    :func:`.derivatives.aba_derivatives` where they can."""
    kin = kinematics(model, q, v, at_first_joint=True)
    b = rnea(model, q, v, torch.zeros_like(v), ext_forces, kin=kin)
    L = cholesky(mass_matrix(model, q, kin=kin))
    return cholesky_solve_tri(L, (tau - b)[..., None])[..., 0]


def mass_matrix(model: RobotModel, q: Tensor, kin: Optional[dict] = None) -> Tensor:
    """Joint-space inertia M(q) (..., nv, nv), one dense contraction."""
    if kin is None:
        kin = kinematics(model, q)
    A, Phi = kin["A"], kin["Phi"]
    m, c_w, I_w = _world_inertia_cached(model, kin)
    Psi = Phi[..., None, :, :] * A[:, :, None]  # (..., nj, nv, 6) masked axes
    IPsi = inertia_apply(m[:, None], c_w[..., None, :], I_w[..., None, :, :], Psi)
    M = torch.einsum("...bks,...bls->...kl", Psi, IPsi)
    M = 0.5 * (M + M.mT)
    if model.armature is not None:
        M = M + torch.diag(model.armature.to(M.dtype))
    return M


def frame_placement(model: RobotModel, q: Tensor, frame_id: int,
                    kin: Optional[dict] = None):
    """World pose (R (..., 3, 3), p (..., 3)) of an operational frame."""
    if kin is None:
        kin = kinematics(model, q)
    par = model.frame_parents[frame_id]
    Rf = _placement_rotations(model, q, frames=True)[frame_id]
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


def frame_velocity(model: RobotModel, q: Tensor, v: Tensor, frame_id: int,
                   kin: Optional[dict] = None) -> Tensor:
    """Spatial velocity (..., 6) of a frame in its LOCAL frame (linear,
    angular)."""
    if kin is None:
        kin = kinematics(model, q, v)
    Rw, pw = frame_placement(model, q, frame_id, kin=kin)
    V = kin["V"][..., model.frame_parents[frame_id], :]
    w = V[..., 3:]
    v_at_f = V[..., :3] + cross(w, pw)
    return torch.cat([(Rw.mT @ v_at_f[..., None])[..., 0],
                      (Rw.mT @ w[..., None])[..., 0]], -1)


def center_of_mass(model: RobotModel, q: Tensor, kin: Optional[dict] = None) -> Tensor:
    """World-frame centre of mass (..., 3) of the whole robot."""
    if kin is None:
        kin = kinematics(model, q)
    c_w = kin["p"] + (kin["R"] @ model.com.to(q.dtype)[..., None])[..., 0]
    m = model.mass.to(q.dtype)
    return torch.einsum("b,...bs->...s", m, c_w) / m.sum()
