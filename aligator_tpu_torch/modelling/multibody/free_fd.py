"""Free forward dynamics of a kinematic tree: CUDA kernel and its plain
version.

:func:`free_fd` computes ``a = M(q)⁻¹(τ − b(q, v))``, the function of
:func:`.model.aba`, for a batch of states:

* CPU tensors take :func:`free_fd_plain` (:func:`.model.aba`);
* CUDA tensors take the kernel of ``csrc/free_fd.cu`` (one thread a
  scenario) in float32 or float64, for a model of any size: up to 16
  joints and 24 dofs with its arrays in the thread, past that in a
  global-memory workspace that :func:`launch` allocates; anything else
  raises.

It replaces no Pallas kernel: the JAX package's ``model._aba_impl`` is
compiled by XLA. The nonlinear rollout calls the forward dynamics once a
stage for the whole batch, where the PyTorch version is 135 to 235 small
operations, each a kernel launch in the line-search trial's CUDA graph; the
kernel is one. On either device :func:`free_fd` is a
``torch.autograd.Function``: the values come from the kernel (or the plain
version), the derivatives, forward and reverse mode and under ``vmap``,
from the analytic ones of :func:`.derivatives.aba_derivatives`, as the JAX
package's ``aba_custom`` custom JVP gives them. Launches count in
``_build.LAUNCHES["free_fd"]``.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ... import _build
from ..._linalg import mtv, mv
from . import model as rbd
from .derivatives import aba_derivatives
from ..spaces.se3 import quat_to_matrix

_SOURCE = "free_fd"
_C_FUNCS = {torch.float32: "free_fd_f32", torch.float64: "free_fd_f64"}


def free_fd_plain(model: rbd.RobotModel, q: Tensor, v: Tensor, tau: Tensor) -> Tensor:
    """Plain PyTorch version: :func:`.model.aba`."""
    return rbd.aba(model, q, v, tau)


def free_fd(model: rbd.RobotModel, q: Tensor, v: Tensor, tau: Tensor) -> Tensor:
    """Forward dynamics ``(..., nv)``, differentiable; CPU tensors take
    :func:`free_fd_plain`, CUDA tensors the kernel."""
    return _FreeFD.apply(model, q, v, tau)


def _values(model, q, v, tau):
    dev = q.device
    if dev.type == "cpu":
        return free_fd_plain(model, q, v, tau)
    if dev.type != "cuda":
        raise ValueError(f"free_fd: unsupported device {dev}")
    return launch(model, q, v, tau)


def _to_local(model, q, dq):
    """A configuration-coordinate tangent ``dq (..., nq)`` in local tangent
    coordinates ``(..., nv)``: d/dε difference(q, q + ε·dq), exact for the
    tangents ``integrate`` generates (the JAX package's
    ``_coords_to_local``); the identity without a free-flyer."""
    if model.nq == model.nv:
        return dq
    cs = model.configuration_space()
    return torch.func.jvp(lambda y: cs.difference(q, y), (q,), (dq,))[1]


def _to_local_t(model, q, g):
    """The transpose of :func:`_to_local`: ``(..., nv)`` to ``(..., nq)``."""
    if model.nq == model.nv:
        return g
    cs = model.configuration_space()
    return torch.func.vjp(lambda y: cs.difference(q, y), q)[1](g)[0]


class _FreeFD(torch.autograd.Function):
    """The values of :func:`_values`; ∂a = ∂a/∂q·ξ(dq) + ∂a/∂v·dv + M⁻¹dτ
    from :func:`.derivatives.aba_derivatives` at the same point."""

    @staticmethod
    def forward(model, q, v, tau):
        return _values(model, q, v, tau)

    @staticmethod
    def setup_context(ctx, inputs, output):
        model, q, v, tau = inputs
        ctx.model = model
        ctx.save_for_backward(q, v, tau)
        ctx.save_for_forward(q, v, tau)

    @staticmethod
    def _derivatives(ctx):
        q, v, tau = ctx.saved_tensors
        lead = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1], tau.shape[:-1])
        q, v, tau = (t.expand(lead + t.shape[-1:]) for t in (q, v, tau))
        return q, aba_derivatives(ctx.model, q, v, tau)

    @staticmethod
    def jvp(ctx, _, dq, dv, dtau):
        q, (a, da_dq, da_dv, solve_M) = _FreeFD._derivatives(ctx)
        out = torch.zeros_like(a)
        if dq is not None:
            out = out + mv(da_dq, _to_local(ctx.model, q, dq.expand(q.shape)))
        if dv is not None:
            out = out + mv(da_dv, dv)
        if dtau is not None:
            out = out + solve_M(dtau.expand(a.shape)[..., None])[..., 0]
        return out

    @staticmethod
    def backward(ctx, g):
        q_in, v_in, tau_in = ctx.saved_tensors
        q, (a, da_dq, da_dv, solve_M) = _FreeFD._derivatives(ctx)
        g_tau = solve_M(g[..., None])[..., 0]  # M is symmetric
        g_q = _to_local_t(ctx.model, q, mtv(da_dq, g))
        return (None, g_q.sum_to_size(q_in.shape), mtv(da_dv, g).sum_to_size(v_in.shape),
                g_tau.sum_to_size(tau_in.shape))

    @staticmethod
    def vmap(info, in_dims, model, q, v, tau):
        # the batch axis in front of every batched input, padded to the
        # inputs' common leading dims: the kernel broadcasts leading dims
        xs, dims = (q, v, tau), in_dims[1:]
        lead = torch.broadcast_shapes(*(
            x.shape[:-1] if d is None else x.movedim(d, 0).shape[1:-1]
            for x, d in zip(xs, dims)))

        def lift(x, d):
            if d is None:
                return x
            x = x.movedim(d, 0)
            return x.reshape(x.shape[:1] + (1,) * (len(lead) + 2 - x.dim()) + x.shape[1:])

        return _FreeFD.apply(model, *(lift(x, d) for x, d in zip(xs, dims))), 0


def _model_table(model: rbd.RobotModel, like: Tensor) -> Tensor:
    """The kernel's float table of a model: placement rotations and
    translations, axes, masses, coms, inertias, gravity and the per-dof
    armature (zeros for a model without one), made once a model, dtype and
    device from its device tensors (not kept when made while a CUDA graph is
    being captured)."""
    key = (like.dtype, like.device)
    cache = model.__dict__.setdefault("_free_fd_table", {})
    tab = cache.get(key)
    if tab is None:
        dt = like.dtype
        arm = model.armature if model.armature is not None else \
            model.mass.new_zeros(model.nv)
        parts = [quat_to_matrix(model.jplac_q.to(dt)), model.jplac_p, model.axes,
                 model.mass, model.com, model.inertia, model.gravity, arm]
        tab = torch.cat([p.to(dt).reshape(-1) for p in parts])
        if not torch.cuda.is_current_stream_capturing():
            cache[key] = tab
    return tab


def launch(model: rbd.RobotModel, q: Tensor, v: Tensor, tau: Tensor) -> Tensor:
    """Launch the kernel on ``q (..., nq)``, ``v (..., nv)``, ``tau (..., nv)``
    (values only: :func:`free_fd` differentiates)."""
    nj, nq, nv = model.njoints, model.nq, model.nv
    if q.dtype not in _C_FUNCS or not (q.dtype == v.dtype == tau.dtype):
        raise ValueError(f"free_fd kernel takes float32/float64 q, v, tau of one dtype, "
                         f"got {q.dtype}, {v.dtype}, {tau.dtype}")
    if (torch.is_grad_enabled() and any(t.requires_grad for t in (q, v, tau))) or \
            torch._C._functorch.is_functorch_wrapped_tensor(q):
        raise ValueError("free_fd kernel computes values only: differentiate "
                         "free_fd instead")
    lead = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1], tau.shape[:-1])
    B = 1
    for d in lead:
        B *= d
    out = q.new_empty(lead + (nv,))
    if B == 0:
        return out
    qc, vc, tc = (t.expand(lead + t.shape[-1:]).contiguous() for t in (q, v, tau))
    itab = rbd.tables(model, q)["itab"]
    size = _build.load(_SOURCE).free_fd_workspace
    size.restype = ctypes.c_longlong
    size.argtypes = [ctypes.c_int] * 3
    words = size(B, nj, nv)
    work = q.new_empty((words,)) if words else None
    fn = _build.c_function(_SOURCE, _C_FUNCS[q.dtype], 4, 8)
    _build.run(fn, q.device, B, nj, nq, nv, itab.data_ptr(),
               _model_table(model, q).data_ptr(), qc.data_ptr(), vc.data_ptr(),
               tc.data_ptr(), out.data_ptr(), 0 if work is None else work.data_ptr(),
               kernel="free_fd")
    return out
