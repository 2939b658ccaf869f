"""Plotting helpers.

PyTorch counterpart of ``aligator_tpu/utils/plotting.py`` (the
reference's ``bindings/python/aligator/utils/plotting.py``). Matplotlib is
optional: it is imported inside each function. Tensors (on any device)
and arrays are accepted alike.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def plot_convergence(history, ax=None, num_iters=None):
    """Plot the primal and dual infeasibility of a recorded history
    ``(iterations, ≥ 2)`` (one scenario's ``res.history``)."""
    import matplotlib.pyplot as plt

    h = _np(history)
    if num_iters is not None:
        h = h[: int(num_iters)]
    if ax is None:
        _, ax = plt.subplots()
    it = np.arange(1, h.shape[0] + 1)
    ax.semilogy(it, np.maximum(h[:, 0], 1e-16), marker=".", label="prim. err")
    ax.semilogy(it, np.maximum(h[:, 1], 1e-16), marker=".", label="dual err")
    ax.set_xlabel("iteration")
    ax.legend()
    return ax


def plot_controls_traj(times, us, ax=None, labels=None):
    """Step plot of the controls ``us (N, nu)`` over ``times``."""
    import matplotlib.pyplot as plt

    us, times = _np(us), _np(times)
    if ax is None:
        _, ax = plt.subplots()
    for j in range(us.shape[1]):
        lbl = labels[j] if labels else f"u[{j}]"
        ax.step(times[: us.shape[0]], us[:, j], where="post", label=lbl)
    ax.set_xlabel("time")
    ax.legend()
    return ax


def plot_velocity_traj(times, vs, ax=None):
    """The velocities ``vs (T, nv)`` over ``times``."""
    import matplotlib.pyplot as plt

    vs, times = _np(vs), _np(times)
    if ax is None:
        _, ax = plt.subplots()
    for j in range(vs.shape[1]):
        ax.plot(times[: vs.shape[0]], vs[:, j], label=f"v[{j}]")
    ax.set_xlabel("time")
    ax.legend()
    return ax


def plot_se2_pose(q, ax, alpha=0.5, fc="tab:blue", width=1.0, height=0.4):
    """Draw an oriented box at an SE(2) state q = (x, y, cosθ, sinθ)."""
    import matplotlib.pyplot as plt
    from matplotlib import transforms

    q = _np(q)
    theta = np.arctan2(q[3], q[2])
    rect = plt.Rectangle((q[0] - 0.5 * width, q[1] - 0.5 * height), width, height,
                         fc=fc, alpha=alpha)
    rect.set_transform(transforms.Affine2D().rotate_around(q[0], q[1], theta) + ax.transData)
    ax.add_patch(rect)
    return rect
