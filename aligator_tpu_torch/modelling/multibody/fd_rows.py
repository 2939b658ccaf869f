"""Contact-dynamics derivative rows: CUDA kernel K5 and its plain version.

Replaces the Pallas TPU kernel ``make_fd_rows_kernel``
(``aligator_tpu/modelling/multibody/pallas_tensors.py:87``, entry point
``fd_rows_lanes``). For every instance (scenario × stage) it computes, at
the primal solution (a*, λ*) of the contact dynamics:

* ``ra1_q, ra1_v (nv, nv)``: ∂(RNEA + Jᵀλ)/∂(q, v);
* ``r2_q, r2_v (nc, nv)``: ∂(J a + γ)/∂(q, v), masked by contact activity.

:func:`fd_rows` routes by device: CPU tensors take :func:`fd_rows_plain`
(the batched port of ``derivatives._fd_rows_std``, which forms the
inertia-transport tensor dI₆ explicitly); CUDA tensors take the kernel of
``csrc/fd_rows.cu`` in float32 or float64 (any number of 3D/6D contacts,
any nv; an instance whose working set exceeds shared memory in a global
workspace allocated here), fed by :func:`.derivatives.fd_rows_inputs`, or
raise. The contact configuration is runtime data, so one build serves every
robot: the body, dim and offset of each contact end the device index lists
that the kernel walks (the nonzeros of the topology masks, from
:func:`support_lists`), built once per (model, contact list); kd and kp are
kernel parameters. Launches count in ``_build.LAUNCHES["fd_rows"]``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import Tensor

from ... import _build
from ..spaces.se3 import cross
from . import model as rbd
from .contact import contact_offsets
from .derivatives import fd_rows_inputs, point_derivative_rows, rnea_tensors

_SOURCE = "fd_rows"
_C_FUNCS = {torch.float32: "fd_rows_f32", torch.float64: "fd_rows_f64"}
INPUTS = ("S", "v", "Vb", "Vpar", "Vdof", "Ca", "Capar", "Accb", "h", "y", "I6",
          "lam", "pcs", "act")


@functools.lru_cache(maxsize=None)
def support_lists(joint_types: tuple, parents: tuple):
    """The kernel's index lists, from the topology masks ``A (nb, nv)`` (dof
    k moves body b) and ``D (nv, nv)`` (D[k, j]: joint(j) is joint(k) or its
    ancestor), as one int32 array laid out as ``Index`` in
    ``csrc/fd_rows.cu`` says, and their lengths ``(npair, nslot, nrel, nsp,
    neb)``:

    * the pairs (j, k) with D[k, j] = 1 (``pair_j``, ``pair_k``);
    * the slots (b, j) with A[b, j] = 1 (``slot_b``, ``slot_j``, and
      ``slot_of``, (nb, nv), -1 elsewhere); for each slot its pairs (j, k)
      over the k with A[b, k] = 1 (``sp_off``, ``sp``, k ascending);
    * for each dof k the bodies b with A[b, k] = 1 (``sub_off``, ``sub``);
    * the entries k nv + j of an (nv, nv) output (``ent``), those that
      some body's dofs include both k and j first (``nrel`` of them, the
      most such bodies first), each with its pair (j, k) or -1
      (``ent_pair``) and the slots (b, j) of those bodies (``eb_off``,
      ``eb``, b ascending).
    """
    top = rbd.topology(joint_types, parents)
    A, D = top["A"] != 0, top["D"] != 0
    nb, nv = A.shape
    pj, pk = np.nonzero(D.T)  # pairs (j, k) with D[k, j], ascending in (j, k)
    pair_of = np.full((nv, nv), -1)
    pair_of[pj, pk] = np.arange(len(pj))
    slot_b, slot_j = np.nonzero(A)  # ascending in (b, j)
    slot_of = np.full((nb, nv), -1)
    slot_of[slot_b, slot_j] = np.arange(len(slot_b))
    sp = [pair_of[j, np.nonzero(A[b] & D[:, j])[0]] for b, j in zip(slot_b, slot_j)]
    _, sub = np.nonzero(A.T)
    both = A[:, :, None] & A[:, None, :]  # (b, k, j)
    count = both.sum(0).ravel()
    ent = np.argsort(-count, kind="stable")
    nrel = int((count > 0).sum())
    k, j = np.divmod(ent[:nrel], nv)
    eb = [slot_of[np.nonzero(both[:, a, c])[0], c] for a, c in zip(k, j)]

    def offsets(lists):
        return np.concatenate([[0], np.cumsum([len(x) for x in lists])])

    parts = [pj, pk, slot_b, slot_j, slot_of.ravel(), offsets(sp), *sp,
             np.concatenate([[0], np.cumsum(A.sum(0))]), sub, ent, pair_of[j, k],
             offsets(eb), *eb]
    lens = (len(pj), len(slot_b), nrel, sum(map(len, sp)), sum(map(len, eb)))
    return np.concatenate(parts).astype(np.int32), lens


@functools.lru_cache(maxsize=None)
def _device_lists(joint_types: tuple, parents: tuple, bodies: tuple, dims: tuple,
                  device):
    """The index lists of :func:`support_lists` followed by the contacts'
    bodies, dims and offsets (``Index`` in ``csrc/fd_rows.cu``), on the
    device, and the lists' lengths."""
    lists, lens = support_lists(joint_types, parents)
    table = np.concatenate([lists, bodies, dims, contact_offsets(dims)])
    return torch.as_tensor(table.astype(np.int32), device=device), lens


def fd_rows_plain(model, q: Tensor, v: Tensor, a: Tensor, lam: Tensor,
                  active: Tensor, contact_frames, contact_dims, kd: float,
                  kp: float = 0.0, has_prefs: bool = False, kin=None):
    """Plain PyTorch version over leading dims: the tensor pass of
    :func:`.derivatives.rnea_tensors`, the per-contact acceleration rows and
    the Jᵀλ transport. ``active`` is ``(..., ncont)``. Returns ``(ra1_q,
    ra1_v, r2_q, r2_v)``."""
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    t = rnea_tensors(model, q, v, a, kin=kin)
    S, A, D, SxS = t["S"], t["A"], t["D"], t["SxS"]
    dJtl_q = torch.zeros_like(t["dtau_dq"])
    rows_q, rows_v = [], []
    for k, (fid, dim, off) in enumerate(zip(contact_frames, contact_dims,
                                            contact_offsets(contact_dims))):
        body = model.frame_parents[fid]
        _, p_c = rbd.frame_placement(model, q, fid, kin=kin)
        rq, rv, dp = point_derivative_rows(t, body, p_c, dim, kp, kd, has_prefs)
        act_k = active[..., k, None, None].to(q.dtype)
        rows_q.append(rq * act_k)
        rows_v.append(rv * act_k)
        # ∂q(Jᵀλ) at a fixed world wrench: axis transport plus the motion of
        # the application point
        w_f = lam[..., off:off + 3]
        w_tau = lam[..., off + 3:off + 6] if dim == 6 else torch.zeros_like(w_f)
        F_c = torch.cat([w_f, cross(p_c, w_f) + w_tau], -1)
        s1 = torch.einsum("...jks,...s->...jk", SxS, F_c)
        ab = A[body][:, None]
        dpxw = cross(dp, w_f[..., None, :])
        dJtl_q = dJtl_q + ab * (D * s1.mT) + ab * (S[..., 3:] @ dpxw.mT)
    return (t["dtau_dq"] + dJtl_q, t["dtau_dv"], torch.cat(rows_q, -2),
            torch.cat(rows_v, -2))


def fd_rows(model, q: Tensor, v: Tensor, a: Tensor, lam: Tensor, active: Tensor,
            contact_frames, contact_dims, kd: float, kp: float = 0.0,
            has_prefs: bool = False, kin=None):
    """The derivative rows; CPU tensors take :func:`fd_rows_plain`, CUDA
    tensors the kernel."""
    dev = q.device
    if dev.type == "cpu":
        return fd_rows_plain(model, q, v, a, lam, active, contact_frames,
                             contact_dims, kd, kp, has_prefs, kin)
    if dev.type != "cuda":
        raise ValueError(f"fd_rows: unsupported device {dev}")
    inputs = fd_rows_inputs(model, q, v, a, contact_frames, kin=kin)
    inputs.update(v=v, lam=lam, act=active)
    bodies = tuple(model.frame_parents[f] for f in contact_frames)
    return launch(model, inputs, bodies, contact_dims, kd, kp if has_prefs else 0.0)


def launch(model, inputs: dict, contact_bodies, contact_dims, kd: float, kp: float):
    """Launch the kernel on the inputs of :func:`.derivatives.fd_rows_inputs`
    plus ``v``, ``lam`` and ``act`` (each with the same leading dims);
    ``kp`` multiplies the position rows (0 without position references)."""
    S = inputs["S"]
    lead, (nv, six) = S.shape[:-2], S.shape[-2:]
    nb = inputs["Vb"].shape[-2]
    ncont, nc = len(contact_bodies), int(sum(contact_dims))
    dtype, dev = S.dtype, S.device
    if dtype not in _C_FUNCS or dev.type != "cuda":
        raise ValueError(f"fd_rows kernel takes float32/float64 CUDA tensors, got "
                         f"{dtype} on {dev}")
    if ncont < 1 or any(d not in (3, 6) for d in contact_dims):
        raise ValueError(f"fd_rows kernel takes one or more contacts of dim 3 or 6, "
                         f"got {tuple(contact_dims)}")
    want = dict(S=(nv, 6), v=(nv,), Vb=(nb, 6), Vpar=(nv, 6), Vdof=(nv, 6),
                Ca=(nb, 6), Capar=(nv, 6), Accb=(nb, 6), h=(nb, 6), y=(nb, 6),
                I6=(nb, 6, 6), lam=(nc,), pcs=(ncont, 3), act=(ncont,))
    K = int(np.prod(lead, dtype=np.int64))
    flat = []
    for name in INPUTS:
        x = inputs[name]
        if (x.shape != lead + want[name] or x.dtype != dtype or x.device != dev):
            raise ValueError(f"fd_rows: {name} is {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}, want {tuple(lead + want[name])} {dtype}")
        flat.append(x.reshape((K,) + want[name]).contiguous())
    if (model.njoints, model.nv) != (nb, nv) or six != 6:
        raise ValueError(f"fd_rows: the model's (nb, nv) = {(model.njoints, model.nv)} "
                         f"does not match nb={nb}, nv={nv}")
    bodies, dims = tuple(map(int, contact_bodies)), tuple(map(int, contact_dims))
    lists, lens = _device_lists(model.joint_types, model.parents, bodies, dims, dev)
    out = [S.new_empty((K, nv, nv)), S.new_empty((K, nv, nv)),
           S.new_empty((K, nc, nv)), S.new_empty((K, nc, nv))]
    if K:
        table = (ctypes.c_int * (1 + len(lens) + 2 * ncont))(ncont, *lens, *bodies, *dims)
        gains = (ctypes.c_double * 2)(float(kd), float(kp))
        size = _build.load(_SOURCE).fd_rows_workspace
        size.restype = ctypes.c_longlong
        size.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        words = size(nv, nb, ctypes.addressof(table), S.element_size())
        # an instance's working set past shared memory: a global slice each
        work = S.new_empty((K * words,)) if words > 0 else None
        # pointers: the two host tables, the inputs, the index lists and
        # contacts, the outputs, the workspace, the stream
        fn = _build.c_function(_SOURCE, _C_FUNCS[dtype], 3, 2 + len(flat) + 1 + 4 + 2)
        _build.run(fn, dev, K, nv, nb, ctypes.addressof(table), ctypes.addressof(gains),
                   *(x.data_ptr() for x in flat + [lists] + out),
                   0 if work is None else work.data_ptr(), kernel="fd_rows")
    return tuple(o.reshape(lead + o.shape[1:]) for o in out)
