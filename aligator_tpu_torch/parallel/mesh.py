"""Device-mesh helpers for multi-GPU scaling, over ``torch.distributed``.

PyTorch counterpart of ``aligator_tpu/parallel/mesh.py``. The JAX package
drives every device from one controller through a ``jax.sharding.Mesh``;
here each device has a process of its own, as ``torchrun`` starts them (one
host thread driving several cards would serialise the host work that sets
the pace of the port's paths), and a :class:`Mesh` is this process's view
of the world: the mesh's axes and shape, this rank's coordinates and
device, and a process group for each axis. The two natural axes are those
of the JAX package:

* ``batch``: independent scenarios (MPC instances), data-parallel, no
  collective in the solve itself (:func:`batched_solve`);
* ``t``: the horizon, for parallel-in-time legs
  (:func:`..gar.parallel.solve_sharded`), one all-gather of the legs'
  interface payload a solve.

Every collective goes through :func:`all_gather`, which counts each call in
:data:`COLLECTIVES` (by op, group size and the gathered shape), so a test
can take the census the JAX package reads from the compiled HLO. On an
NCCL group the payload stays on the device; on a gloo group it is copied
to the host and back, explicitly, and those copies count in
:data:`HOST_COPIES`. The group's backend decides which; a failed NCCL
initialisation or collective raises, and nothing falls back to gloo or to
the CPU.

Without an initialised default process group a mesh is a world of one
(rank 0 on the caller's device), so one card runs the same code.
"""

from __future__ import annotations

import collections
import math
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .._device import resolve

# collectives by (op, group size, gathered shape), counted by all_gather
COLLECTIVES: collections.Counter = collections.Counter()
# explicit copies around a gloo collective, by (direction, shape)
HOST_COPIES: collections.Counter = collections.Counter()


@dataclass(eq=False)
class Mesh:
    """This rank's view of a device mesh: ``axis_names`` and ``shape``
    (rank r sits at ``np.unravel_index(r, shape)``), its ``coords``, its
    ``device``, and ``groups``, the process group of each axis (the ranks
    that share this rank's other coordinates) and of all the axes together;
    None in a world of one."""

    axis_names: tuple
    shape: tuple
    coords: tuple
    device: torch.device
    groups: dict = field(default_factory=dict)

    def _axes(self, axis) -> tuple:
        """``axis`` (a name or a tuple of names) as a tuple in the mesh's
        order of axes, the order a group's ranks take."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"mesh axes {self.axis_names} have no {unknown}")
        return tuple(sorted(axes, key=self.axis_names.index))

    def size(self, axis) -> int:
        """Devices along ``axis`` (a name, or a tuple of names)."""
        return math.prod(self.shape[self.axis_names.index(a)] for a in self._axes(axis))

    def index(self, axis) -> int:
        """This rank's position along ``axis``; along a tuple of axes, the
        row-major position over them (in the mesh's order: that of the
        group's ranks, which a gather follows)."""
        axes = self._axes(axis)
        dims = [self.shape[self.axis_names.index(a)] for a in axes]
        at = [self.coords[self.axis_names.index(a)] for a in axes]
        return int(np.ravel_multi_index(at, dims)) if axes else 0

    def group(self, axis):
        """The process group of ``axis`` (None in a world of one)."""
        return self.groups.get(self._axes(axis))


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _default_device():
    return resolve(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")


def make_mesh(axis_names=("batch",), shape=None, device=None) -> Mesh:
    """A mesh of ``shape`` (default: every rank on the one axis) over the
    default process group, which the caller initialised (as ``torchrun``
    users do); a world of one without it. ``device`` defaults to
    ``cuda:{LOCAL_RANK}``, which raises on a machine without CUDA unless
    the caller names the CPU. Every rank must call it, in the same order as
    any other process-group creation (``dist.new_group`` is collective)."""
    axis_names = tuple(axis_names)
    rank, world = _world()
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("give the shape of a mesh with more than one axis")
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does not hold "
                         f"a world of {world}")
    device = _default_device() if device is None else resolve(device)
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = {}
    if dist.is_available() and dist.is_initialized():
        ranks = np.arange(world).reshape(shape)
        subsets = [(a,) for a in axis_names]
        if len(axis_names) > 1:
            subsets.append(axis_names)
        for axes in subsets:
            # the ranks that vary along `axes`, one row per value of the
            # other coordinates (every rank creates every group, in order)
            at = [axis_names.index(a) for a in axes]
            rest = [d for d in range(len(shape)) if d not in at]
            rows = ranks.transpose(rest + at).reshape(-1, math.prod(shape[d] for d in at))
            for row in rows:
                g = dist.new_group(row.tolist())
                if rank in row:
                    groups[axes] = g
    return Mesh(axis_names, shape, coords, device, groups)


def make_hybrid_mesh(n_slices: Optional[int] = None, axis_names=("dcn", "batch"),
                     device=None) -> Mesh:
    """Two-level mesh: the outer axis over hosts, the inner over a host's
    cards (the JAX package's DCN and ICI axes). Shard only independent
    scenarios over the outer axis and keep collectives inside a host;
    ``batched_solve(axis_name=("dcn", "batch"))`` shards the batch over
    both at once. Without ``n_slices`` the ranks group by node through
    ``LOCAL_WORLD_SIZE`` (as ``torchrun`` sets it; one node without it);
    with it, the ranks are a flat reshape into ``n_slices`` rows, as the
    JAX package falls back to on its virtual mesh."""
    _, world = _world()
    if n_slices is None:
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if per_node < 1 or world % per_node:
            raise ValueError(f"LOCAL_WORLD_SIZE={per_node} does not divide a world of "
                             f"{world}")
        n_slices = world // per_node
    if world % n_slices:
        raise ValueError(f"{n_slices} slices do not divide a world of {world}")
    return make_mesh(axis_names, (n_slices, world // n_slices), device)


def _copy(t: torch.Tensor, device, direction: str) -> torch.Tensor:
    HOST_COPIES[direction, tuple(t.shape)] += 1
    return t.to(device)


def all_gather(mesh: Mesh, axis, t: torch.Tensor) -> torch.Tensor:
    """``t`` of every rank along ``axis``, stacked in the axis' order:
    ``(n,) + t.shape``. The one collective of the module (every call
    counts in :data:`COLLECTIVES`); on a gloo group a CUDA tensor goes
    through the host (counted in :data:`HOST_COPIES`)."""
    n = mesh.size(axis)
    COLLECTIVES["all_gather", n, (n,) + tuple(t.shape)] += 1
    group = mesh.group(axis)
    if group is None:
        if n != 1:
            raise RuntimeError(f"no process group for mesh axis {axis!r} of size {n}")
        return t.unsqueeze(0)
    t = t.contiguous()
    if dist.get_backend(group) == "nccl":
        out = t.new_empty((n,) + tuple(t.shape))
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    host = t if t.device.type == "cpu" else _copy(t, "cpu", "to_host")
    out = host.new_empty((n,) + tuple(t.shape))
    dist.all_gather(list(out.unbind(0)), host, group=group)
    return out if t.device.type == "cpu" else _copy(out, t.device, "to_device")


def shard_batch(mesh: Mesh, tree, axis_name="batch"):
    """This rank's contiguous slice of the leading batch axis of every
    tensor (or array) in ``tree``, on its device. Raises when a batch does
    not divide the axis."""
    n, i = mesh.size(axis_name), mesh.index(axis_name)

    def take(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not divide mesh axis "
                             f"{axis_name!r} of size {n}")
        c = x.shape[0] // n
        return x[i * c:(i + 1) * c].to(mesh.device)

    return pytree.tree_map(take, tree)


def batched_solve(solve_batch: Callable, batch_args, mesh: Optional[Mesh] = None,
                  axis_name="batch"):
    """Shard ``batch_args`` (leading batch axis) over the mesh, run
    ``solve_batch`` (which takes the leading batch: batch first, no vmap)
    on this rank's chunk on its device, then gather every output tensor
    along the batch over the axis' group. Every rank ends with the whole
    batch's results, equal to a local solve of the whole batch; the solve
    itself has no collective."""
    mesh = make_mesh() if mesh is None else mesh
    out = solve_batch(shard_batch(mesh, batch_args, axis_name))
    return pytree.tree_map(
        lambda t: all_gather(mesh, axis_name, t).flatten(0, 1), out)
