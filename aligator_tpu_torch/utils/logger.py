"""Columnar solver-trace logger.

PyTorch counterpart of ``aligator_tpu/utils/logger.py``: the fixed-width
rows the solvers print with ``verbose=True``, and :func:`print_history` for
a recorded history (the JAX module's ``Logger`` table, which nothing there
uses, is not ported). The solvers here run a batch of scenarios, so a row of
:func:`log_rows` is led by its scenario's index.
"""

from __future__ import annotations

import re

# the solvers' row: iter/al_iter/alpha/prim_err/dual_err/inner_crit/preg/
# dphi0/cost/merit/mu, led by the scenario's index
_ROW_KEYS = (
    ("scenario", "{:>8d}"),
    ("iter", "{:>5d}"),
    ("al_iter", "{:>7d}"),
    ("alpha", "{:>9.2e}"),
    ("prim_err", "{:>10.3e}"),
    ("dual_err", "{:>10.3e}"),
    ("inner_crit", "{:>10.3e}"),
    ("preg", "{:>9.2e}"),
    ("dphi0", "{:>10.3e}"),
    ("cost", "{:>11.4e}"),
    ("merit", "{:>11.4e}"),
    ("mu", "{:>9.2e}"),
)
_INT_KEYS = ("scenario", "iter", "al_iter")


def _width(fmt: str) -> int:
    m = re.search(r">(\d+)", fmt)
    return int(m.group(1)) if m else 10


def log_row(trace: dict, header: bool = False):
    """Print one row of scalars (a missing key leaves its cell blank)."""
    if header:
        print(" | ".join(f"{name:>{_width(fmt)}s}" for name, fmt in _ROW_KEYS))
    cells = []
    for name, fmt in _ROW_KEYS:
        v = trace.get(name)
        cells.append(fmt.format(v) if v is not None else " " * _width(fmt))
    print(" | ".join(cells))


def log_rows(trace: dict):
    """Print one row per running scenario of a batched trace: each value a
    ``(B,)`` tensor, ``trace["running"]`` the mask of the scenarios to
    print. The header comes first when some printed scenario is at its
    first iteration."""
    run = trace["running"].tolist()
    cols = {k: v.tolist() for k, v in trace.items() if k != "running"}
    header = any(r and it == 1 for r, it in zip(run, cols["iter"]))
    for b, r in enumerate(run):
        if r:
            row = {k: (int(v[b]) if k in _INT_KEYS else float(v[b]))
                   for k, v in cols.items()}
            log_row(dict(row, scenario=b), header=header)
            header = False


def print_history(history, num_iters=None):
    """Print one scenario's ProxDDP history ``(max_iters, 8)``
    [prim, dual, inner_crit, cost, merit, mu, al_iter, alpha]."""
    h = [[float(v) for v in row] for row in history.tolist()]
    n = len(h) if num_iters is None else min(int(num_iters), len(h))
    for i in range(n):
        log_row(dict(iter=i + 1, al_iter=int(h[i][6]) + 1, alpha=h[i][7],
                     prim_err=h[i][0], dual_err=h[i][1], inner_crit=h[i][2],
                     cost=h[i][3], merit=h[i][4], mu=h[i][5]), header=(i == 0))
