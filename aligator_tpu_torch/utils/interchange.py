"""Problem interchange: a serialized problem format, its saver and loader.

PyTorch counterpart of ``aligator_tpu/utils/interchange.py``: the same
files, read and written the same way, so that a problem saved by either
package loads in the other. A problem is one ``.npz`` archive holding a
JSON manifest (under the key ``manifest``) and the arrays it refers to.

Format ``aligator-interchange-v1``:

* manifest: ``{"format", "nsteps", "nu", "space", "x0", "dynamics",
  "cost", "term_cost", "constraints", "term_constraints"}``;
* array references are strings ``"@name"`` resolved in the archive;
  scalars may be inlined;
* spaces: ``vector`` (n) | ``se2``;
* dynamics: ``linear_discrete`` (A, B, c) | ``se2_car_euler`` (timestep:
  the unicycle of :mod:`..examples.se2_car`, Euler-integrated);
* costs (lists; more than one entry becomes a :class:`~..core.CostStack`):
  ``quadratic`` (Q, R, N, q, r, c) | ``quad_state`` (target, weights) |
  ``quad_control`` (weights, target);
* constraint functions: ``control_error`` (target) | ``state_error``
  (target) | ``linear`` (A, B, c); sets: ``equality`` |
  ``negative_orthant`` | ``box`` (lower, upper).

A stage-cost array that differs over the stages is stored with a leading
axis of size ``nsteps`` and loads as a stacked stage model
(:func:`~..core.replicate_stage` with that leaf substituted). The port's
problems hold a batch of initial states: ``x0`` is stored as one state
``(nx,)`` for a batch of one (what the JAX package reads), else as the
``(B, nx)`` batch.

:func:`save_lqr` / :func:`load_lqr` store a gar
:class:`~..gar.LQRProblem`'s knot arrays (``aligator-lqr-v1``).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .._device import resolve
from ..core import (BoxConstraint, CostStack, EqualityConstraint, LinearFunction,
                    NegativeOrthant, QuadraticControlCost, QuadraticCost,
                    QuadraticResidualCost, QuadraticStateCost, make_problem, make_stage,
                    replicate_stage)
from ..core.dynamics import LinearDiscreteDynamics
from ..core.functions import ControlErrorResidual, StateErrorResidual
from ..core.manifolds import VectorSpace
from ..core.problem import TrajOptProblem
from ..gar.lqr_problem import LQRKnots, LQRProblem

FORMAT = "aligator-interchange-v1"
LQR_FORMAT = "aligator-lqr-v1"
# each cost field's number of dimensions in one stage
_QUAD_NDIM = {"Q": 2, "R": 2, "N": 2, "q": 1, "r": 1, "c": 0}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class _ArrayPool:
    def __init__(self):
        self.arrays = {}

    def put(self, a, hint):
        name = f"{hint}_{len(self.arrays)}"
        self.arrays[name] = _np(a)
        return "@" + name


def _space_spec(space):
    from ..modelling import SE2

    if isinstance(space, VectorSpace):
        return {"type": "vector", "n": int(space.nx)}
    if isinstance(space, SE2):
        return {"type": "se2"}
    raise NotImplementedError(f"interchange-v1 cannot serialize space {type(space).__name__}")


def _cost_entries(cost, put):
    """The manifest's entries of a cost; ``put(array, hint, ndim)`` stores
    one leaf whose single-stage value has ``ndim`` dimensions."""
    if isinstance(cost, CostStack):
        return [e for c in cost.costs for e in _cost_entries(c, put)]
    if isinstance(cost, QuadraticCost):
        return [{"type": "quadratic",
                 **{k: put(getattr(cost, k), k, n) for k, n in _QUAD_NDIM.items()}}]
    if isinstance(cost, QuadraticResidualCost):
        res = cost.residual
        for cls, kind, hints in ((StateErrorResidual, "quad_state", ("xtar", "wx")),
                                 (ControlErrorResidual, "quad_control", ("utar", "wu"))):
            if isinstance(res, cls):
                return [{"type": kind, "target": put(res.target, hints[0], 1),
                         "weights": put(cost.weights, hints[1], 2)}]
    raise NotImplementedError(f"interchange-v1 cannot serialize cost {type(cost).__name__}")


def _function_spec(fn, pool):
    if isinstance(fn, ControlErrorResidual):
        return {"type": "control_error", "target": pool.put(fn.target, "utar")}
    if isinstance(fn, StateErrorResidual):
        return {"type": "state_error", "target": pool.put(fn.target, "xtar")}
    if isinstance(fn, LinearFunction):
        return {"type": "linear", "A": pool.put(fn.A, "cA"), "B": pool.put(fn.B, "cB"),
                "c": pool.put(fn.c, "cc")}
    raise NotImplementedError(f"interchange-v1 cannot serialize function {type(fn).__name__}")


def _set_spec(cset, pool):
    if isinstance(cset, EqualityConstraint):
        return {"type": "equality"}
    if isinstance(cset, NegativeOrthant):
        return {"type": "negative_orthant"}
    if isinstance(cset, BoxConstraint):
        return {"type": "box", "lower": pool.put(cset.lower, "lo"),
                "upper": pool.put(cset.upper, "hi")}
    raise NotImplementedError(f"interchange-v1 cannot serialize set {type(cset).__name__}")


def _dynamics_spec(dyn, pool):
    from ..examples.se2_car import CarDynamics
    from ..modelling import IntegratorEuler

    if isinstance(dyn, LinearDiscreteDynamics):
        return {"type": "linear_discrete", "A": pool.put(dyn.A, "dynA"),
                "B": pool.put(dyn.B, "dynB"), "c": pool.put(dyn.c, "dync")}
    if isinstance(dyn, IntegratorEuler) and isinstance(dyn.ode, CarDynamics):
        return {"type": "se2_car_euler", "timestep": float(dyn.timestep)}
    raise NotImplementedError(f"interchange-v1 cannot serialize dynamics {type(dyn).__name__}")


def _constraint_specs(constraints, pool):
    return [{"function": _function_spec(f, pool), "set": _set_spec(s, pool)}
            for f, s in constraints]


def save_problem(path, problem: TrajOptProblem):
    """Serialize a :class:`~..core.problem.TrajOptProblem` to ``path``
    (.npz). Raises ``NotImplementedError`` on a component outside the v1
    registry (module docstring). A stage-cost leaf that varies over the
    stages (a stacked stage model's, or a leaf with a leading stage axis)
    is stored with that axis, a constant one as its single-stage value; the
    stage constraints are stage 0's."""
    pool = _ArrayPool()
    N, stages = problem.nsteps, problem.stages
    stage0 = stages.at(0) if stages.nstack else stages

    def put_stage(arr, hint, ndim):
        a = _np(arr)
        if stages.nstack or a.ndim == ndim + 1:
            a = np.broadcast_to(a, (N,) + a.shape[a.ndim - ndim:])
            return pool.put(a[0] if np.all(a == a[:1]) else a, hint)
        return pool.put(a, hint)

    x0 = _np(problem.x0)
    manifest = {
        "format": FORMAT,
        "nsteps": N,
        "nu": int(problem.nu),
        "space": _space_spec(problem.space),
        "x0": pool.put(x0[0] if x0.shape[0] == 1 else x0, "x0"),
        "dynamics": _dynamics_spec(stage0.dynamics, pool),
        "cost": _cost_entries(stages.cost, put_stage),
        "term_cost": _cost_entries(problem.term_cost, lambda a, h, n: pool.put(a, h)),
        "constraints": _constraint_specs(stage0.constraints, pool),
        "term_constraints": _constraint_specs(problem.term_constraints, pool),
    }
    np.savez(path, manifest=np.asarray(json.dumps(manifest)), **pool.arrays)


def _build_space(spec):
    from ..modelling import SE2

    if spec["type"] == "vector":
        return VectorSpace(spec["n"])
    if spec["type"] == "se2":
        return SE2()
    raise ValueError(f"unknown space type {spec['type']}")


def _build_cost(entries, get, nsteps):
    """``(cost, stacked)``: the stage-constant cost and the ``(cost index,
    field path, stacked array)`` of each leaf that varies over the stages."""
    costs, stacked = [], []

    def split(idx, path, a, ndim):
        if a.ndim == ndim + 1 and a.shape[0] == nsteps:
            stacked.append((idx, path, a))
            return a[0]
        return a

    for idx, e in enumerate(entries):
        t = e["type"]
        if t == "quadratic":
            costs.append(QuadraticCost(**{k: split(idx, (k,), get(e[k]), n)
                                          for k, n in _QUAD_NDIM.items()}))
        elif t in ("quad_state", "quad_control"):
            tgt = split(idx, ("residual", "target"), get(e["target"]), 1)
            w = split(idx, ("weights",), get(e["weights"]), 2)
            costs.append(QuadraticStateCost(tgt, w) if t == "quad_state"
                         else QuadraticControlCost(w, tgt))
        else:
            raise ValueError(f"unknown cost type {t}")
    if len(costs) == 1 and not stacked:
        return costs[0], []
    return CostStack.create(*costs), stacked


def _build_function(spec, get):
    t = spec["type"]
    if t == "control_error":
        return ControlErrorResidual(target=get(spec["target"]))
    if t == "state_error":
        return StateErrorResidual(target=get(spec["target"]))
    if t == "linear":
        return LinearFunction(A=get(spec["A"]), B=get(spec["B"]), c=get(spec["c"]))
    raise ValueError(f"unknown function type {t}")


def _build_set(spec, get):
    t = spec["type"]
    if t == "equality":
        return EqualityConstraint()
    if t == "negative_orthant":
        return NegativeOrthant()
    if t == "box":
        return BoxConstraint(lower=get(spec["lower"]), upper=get(spec["upper"]))
    raise ValueError(f"unknown set type {t}")


def _set_path(obj, path, value):
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    return dataclasses.replace(
        obj, **{path[0]: _set_path(getattr(obj, path[0]), path[1:], value)})


def _substitute_cost_leaf(stages, cost_idx, path, arr):
    """``stages`` with one stacked leaf of stage cost ``cost_idx`` set."""
    cost = stages.cost
    if isinstance(cost, CostStack):
        costs = tuple(_set_path(c, path, arr) if i == cost_idx else c
                      for i, c in enumerate(cost.costs))
        return dataclasses.replace(stages, cost=dataclasses.replace(cost, costs=costs))
    return dataclasses.replace(stages, cost=_set_path(cost, path, arr))


def load_problem(path, dtype=torch.float64, device="cuda") -> TrajOptProblem:
    """Load a serialized problem into a :class:`~..core.problem.TrajOptProblem`
    of ``dtype`` on ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve(device)
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(str(arrays.pop("manifest")))
    if manifest["format"] != FORMAT:
        raise ValueError(f"unknown format {manifest['format']}")

    def get(ref):
        a = arrays[ref[1:]] if isinstance(ref, str) and ref.startswith("@") else ref
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    N, nu = manifest["nsteps"], manifest["nu"]
    space = _build_space(manifest["space"])
    dspec = manifest["dynamics"]
    if dspec["type"] == "linear_discrete":
        dyn = LinearDiscreteDynamics(A=get(dspec["A"]), B=get(dspec["B"]), c=get(dspec["c"]))
    elif dspec["type"] == "se2_car_euler":
        from ..examples.se2_car import CarDynamics
        from ..modelling import IntegratorEuler

        dyn = IntegratorEuler(ode=CarDynamics(), timestep=get(dspec["timestep"]))
    else:
        raise ValueError(f"unknown dynamics type {dspec['type']}")
    cost, stacked = _build_cost(manifest["cost"], get, N)
    term_cost, t_stacked = _build_cost(manifest["term_cost"], get, N)
    if t_stacked:
        raise ValueError("terminal cost cannot be stage-stacked")

    def constraints(key):
        return tuple((_build_function(c["function"], get), _build_set(c["set"], get))
                     for c in manifest[key])

    stage = make_stage(cost, dyn, space, nu, constraints("constraints"))
    if stacked:
        stage = replicate_stage(stage, N)
        for idx, fpath, arr in stacked:
            stage = _substitute_cost_leaf(stage, idx, fpath, arr)
    return make_problem(get(manifest["x0"]), stage, N, term_cost,
                        term_constraints=constraints("term_constraints"))


# ---------------------------------------------------------------------------
# gar-level LQ interchange
# ---------------------------------------------------------------------------

_LQR_FIELDS = ("Q", "S", "R", "q", "r", "A", "B", "E", "f", "C", "D", "d")
_LQR_TH_FIELDS = ("Gx", "Gu", "Gth", "gamma")


def save_lqr(path, problem: LQRProblem):
    """Serialize a gar :class:`~..gar.LQRProblem` (knot arrays and G0/g0).
    The port's problems are batched: a batch of one is stored without its
    batch axis (what the JAX package reads), a larger one with it."""
    squeeze = problem.batch == 1

    def arr(t):
        a = _np(t)
        return a[0] if squeeze else a

    out = {k: arr(getattr(problem.knots, k)) for k in _LQR_FIELDS}
    for k in _LQR_TH_FIELDS:
        v = getattr(problem.knots, k)
        if v is not None:
            out[k] = arr(v)
    out["G0"], out["g0"] = arr(problem.G0), arr(problem.g0)
    np.savez(path, format=np.asarray(LQR_FORMAT), **out)


def load_lqr(path, dtype=torch.float64, device="cuda") -> LQRProblem:
    """Load a gar LQ problem; one stored without a batch axis (as the JAX
    package writes it) gets a batch of one."""
    dev = resolve(device)
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    if str(arrays.pop("format")) != LQR_FORMAT:
        raise ValueError(f"not an {LQR_FORMAT} archive")
    batched = arrays["g0"].ndim == 2

    def t(a):
        a = torch.tensor(a, dtype=dtype, device=dev)
        return a if batched else a[None]

    kn = {k: t(arrays[k]) for k in _LQR_FIELDS + _LQR_TH_FIELDS if k in arrays}
    return LQRProblem(knots=LQRKnots(**kn), G0=t(arrays["G0"]), g0=t(arrays["g0"]))
