#!/usr/bin/env python
"""Write the reference fixture of the port's centroidal and wheeled
inverted pendulum tests.

Every solve is the JAX package's, float64, one scenario at a time (its
``vmap`` takes other steps than its single-scenario solve on some
problems), from the initial states of the port's
``examples.<path>.initial_states`` (numpy):

* ``<path>_prob_*``: the JAX problem's leaves that
  ``convert.<path>_problem_from_numpy`` reads, and its evaluation and
  derivatives (``evaluate``, ``compute_derivatives``) at a random (xs, us)
  (numpy seed 7), for the CPU test that holds the port's one stage model
  with stage-varying leaves against the JAX package's stacked stages;
* ``<path>_small_*``: the paths at a small size (the continuous gait at
  ``T_ds=4, T_ss=8, T_tail=6``, the others at their published sizes), 2
  scenarios (seed 1): the iterate after 4 iterations, and the converged
  flag, iteration count, xs and us at the published budget;
* ``<path>_full_*``: the paths at the published sizes, the first 16
  scenarios of ``chip_smoke.py``'s centroidal phase (seed 0, as its
  ``SEED``): each one's converged flag and iteration count, and its flag
  from x0·(1 ± 1e-15) (``conv_up``, ``conv_down``). The card's floor is
  the least of the three converged counts less one: the centroidal gait
  at μ₀ = 1e-7 flips scenarios between converging in ~11 iterations and
  not within 200 on one ulp of x0.

XLA's CPU runtime here is not to be trusted with these solves: the
wheeled inverted pendulum's jitted solve can abort the compiler after
accumulated compiler state, and in one process that had compiled other
solves first, the jitted centroidal and pendulum solves took other steps
(40 and 60 iterations where a fresh process's took 11), and two op-by-op
pendulum solves in one process ended in a heap corruption. So each solve
runs in a child process of its own (``--jobs`` at a time), op by op
(unjitted), which agreed with a fresh process's jitted solve on the
centroidal gait. ``tests/test_torch_centroidal.py`` holds the port against the
archive; its ``slow`` test reruns the small group live.

Run from the repository root (several minutes on a CPU, most of it the
``full`` group)::

    python tools/torch_centroidal_fixture.py [--only prob small full] [--out PATH]
"""

import argparse
import os
import subprocess
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from aligator_tpu import solvers  # noqa: E402
from aligator_tpu._pytree import replace  # noqa: E402
from aligator_tpu.core import problem as jproblem  # noqa: E402
from aligator_tpu_torch.examples import centroidal_locomotion as t_cl  # noqa: E402
from aligator_tpu_torch.examples import continuous_centroidal as t_cc  # noqa: E402
from aligator_tpu_torch.examples import solo_kinodynamics as t_sk  # noqa: E402
from aligator_tpu_torch.examples import wheeled_inverted_pendulum as t_wip  # noqa: E402
from examples import centroidal_locomotion as j_cl  # noqa: E402
from examples import continuous_centroidal as j_cc  # noqa: E402
from examples import solo_kinodynamics as j_sk  # noqa: E402
from examples import wheeled_inverted_pendulum as j_wip  # noqa: E402

PATHS = ("wip", "centroidal", "kinodynamics", "continuous")
OPTIONS = {"wip": t_wip.SOLVE_OPTIONS, "centroidal": t_cl.SOLVE_OPTIONS,
           "kinodynamics": t_sk.SOLVE_OPTIONS, "continuous": t_cc.SOLVE_OPTIONS}
SMALL_CC = dict(T_ds=4, T_ss=8, T_tail=6)
SMALL_SEED, SMALL_N, FULL_SEED, FULL_N = 1, 2, 0, 16
SMALL_ITERS = 4
# the full group's solves again from x0·(1 ± 1e-15): the converged count's
# spread over one ulp (the centroidal gait flips 2 of 16 scenarios)
ULP_SCALES = {"up": 1.0 + 1e-15, "down": 1.0 - 1e-15}


def jax_problem(path, small):
    """``(problem, xs_init or None)`` of the JAX package, one scenario."""
    if path == "wip":
        return j_wip.create_wip_problem(), None
    if path == "centroidal":
        return j_cl.create_centroidal_problem(), None
    if path == "kinodynamics":
        return j_sk.create_kinodynamics_problem(), None
    problem, xs_init, _ = j_cc.create_problem(**(SMALL_CC if small else {}))
    return problem, xs_init


def initial_states(path, n, seed, small):
    if path == "wip":
        return t_wip.initial_states(n, seed)
    if path == "centroidal":
        return t_cl.initial_states(n, seed)
    if path == "kinodynamics":
        return t_sk.initial_states(n, seed)
    return t_cc.initial_states(n, seed, **(SMALL_CC if small else {}))


def leaves(path, problem):
    """The leaves ``convert.<path>_problem_from_numpy`` reads."""
    st = problem.stages
    if path == "wip":
        ode = st.dynamics.ode
        cost = st.cost.costs
        return dict(mass_cart=ode.mass_cart[0], mass_pole=ode.mass_pole[0],
                    length=ode.length[0], wheel_radius=ode.wheel_radius[0],
                    gravity=ode.gravity[0], timestep=st.dynamics.timestep[0],
                    x_target=cost[0].residual.target[0], w_x=cost[0].weights[0],
                    w_u=cost[1].weights[0], w_term=problem.term_cost.weights,
                    u_bound=st.constraints[0][1].upper[0, 0])
    ode = st.dynamics.ode
    out = dict(active=ode.contact_map.active, points=ode.contact_map.points,
               mass=ode.mass[0], gravity=ode.gravity[0], timestep=st.dynamics.timestep[0],
               com_final=problem.term_constraints[0][0].c_ref,
               mu=st.constraints[0][0].mu[0] if path != "continuous"
               else st.constraints[0][0].inner.mu[0])
    if path == "kinodynamics":
        out.update(q_ref=st.cost.costs[0].residual.target[:, 9:9 + t_sk.NJ],
                   q_nom=problem.x0[9:9 + t_sk.NJ])
    if path == "continuous":
        out.update(w_force=100.0 * jnp.diagonal(st.cost.costs[0].Q, axis1=-2, axis2=-1)[:, 9:],
                   g_first=st.constraints[t_cc.NK][0].gate,
                   g_last=st.constraints[t_cc.NK + 3][0].gate)
    return {k: np.asarray(v) for k, v in out.items()}


def prob_reference(path):
    problem, _ = jax_problem(path, small=True)
    rng = np.random.default_rng(7)
    N, nx, nu = problem.nsteps, problem.space.nx, problem.nu
    xs = np.asarray(problem.x0)[None] + 0.05 * rng.standard_normal((N + 1, nx))
    us = rng.standard_normal((N, nu))
    data = jax.jit(jproblem.compute_derivatives)(problem, jnp.asarray(xs), jnp.asarray(us))
    out = {f"prob_{k}": v for k, v in leaves(path, problem).items()}
    out.update(prob_x0=np.asarray(problem.x0)[None], prob_xs=xs, prob_us=us)
    for k in ("cost", "stage_costs", "dyn_res", "cstr_vals", "term_cstr_vals", "Lx", "Lu",
              "Lxx", "Lxu", "Luu", "A", "B", "E", "cstr_Jx", "cstr_Ju", "term_cstr_Jx"):
        out[f"prob_{k}"] = np.asarray(getattr(data, k))
    return out


def _solver(path, problem, cfg):
    """One scenario's solve, run op by op (see the module docstring)."""
    def one(x0, xs0):
        p = replace(problem, x0=x0)
        return solvers.solve(p, cfg, xs_init=xs0)
    return one


def _xs_init(path, problem, xs_init, x0):
    if xs_init is None:
        return jnp.broadcast_to(x0, (problem.nsteps + 1, x0.shape[0]))
    return xs_init.at[:, :9].set(jnp.broadcast_to(x0[:9], (problem.nsteps + 1, 9)))


def solve_one(path, group, i, budget):
    """One solve: scenario ``i`` of a path's ``small`` or ``full`` group, at
    the published budget (``full``) or ``SMALL_ITERS`` iterations
    (``short``)."""
    small = group == "small"
    problem, xs_init = jax_problem(path, small)
    n, seed = (SMALL_N, SMALL_SEED) if small else (FULL_N, FULL_SEED)
    x0 = jnp.asarray(initial_states(path, n, seed, small)[i] * ULP_SCALES.get(budget, 1.0))
    opts = OPTIONS[path] if budget != "short" else {**OPTIONS[path], "max_iters": SMALL_ITERS}
    r = _solver(path, problem, solvers.ProxDDPConfig(**opts))(
        x0, _xs_init(path, problem, xs_init, x0))
    if budget == "short":
        return dict(it4_xs=r.xs, it4_us=r.us, it4_lams=r.lams, it4_num_iters=r.num_iters)
    if budget in ULP_SCALES:
        return {f"conv_{budget}": r.conv}
    out = dict(conv=r.conv, num_iters=r.num_iters)
    if small:
        out.update(xs=r.xs, us=r.us)
    return out


def items(path, group):
    """The solves of a group, one child process each."""
    n = SMALL_N if group == "small" else FULL_N
    budgets = ("full", "short") if group == "small" else ("full", *ULP_SCALES)
    return [(path, group, i, b) for i in range(n) for b in budgets]


def gather(path, group, parts):
    """A group's records from its solves' parts, ``<path>_<group>_*``."""
    small = group == "small"
    n, seed = (SMALL_N, SMALL_SEED) if small else (FULL_N, FULL_SEED)
    rows = {}
    for i in range(n):
        for b in ("full", "short", *ULP_SCALES):
            for k, v in parts.get((path, group, i, b), {}).items():
                rows.setdefault(k, []).append(v)
    out = {f"{path}_{group}_{k}": np.stack(v) for k, v in rows.items()}
    out[f"{path}_{group}_x0"] = initial_states(path, n, seed, small)
    out[f"{path}_{group}_seed"] = np.asarray(seed)
    return out


def _run_children(todo, jobs):
    """Run each item's child process, ``jobs`` at a time; returns the parts
    by item."""
    parts, running = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        queue = list(todo)
        while queue or running:
            while queue and len(running) < jobs:
                item = queue.pop(0)
                part = os.path.join(tmp, "_".join(map(str, item)) + ".npz")
                cmd = [sys.executable, os.path.abspath(__file__), "--child", *map(str, item),
                       "--out", part]
                running.append((item, part, subprocess.Popen(cmd)))
            item, part, proc = running.pop(0)
            if proc.wait() != 0:
                raise RuntimeError(f"the JAX solve {item} failed (exit {proc.returncode})")
            with np.load(part) as f:
                parts[item] = {k: f[k] for k in f.files}
            print(" ".join(map(str, item)), {k: parts[item][k] for k in ("conv", "num_iters")
                                              if k in parts[item]}, flush=True)
    return parts


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=["prob", "small", "full"])
    ap.add_argument("--paths", nargs="*", default=list(PATHS))
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                  "torch_centroidal_ref.npz"))
    ap.add_argument("--child", nargs=4, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        path, group, i, budget = args.child
        if group == "prob":
            out = prob_reference(path)
        else:
            out = solve_one(path, group, int(i), budget)
        np.savez(args.out, **{k: np.asarray(v) for k, v in out.items()})
        return
    refs = {}
    if os.path.exists(args.out):
        with np.load(args.out) as old:
            refs.update({k: old[k] for k in old.files})
    todo = []
    for path in args.paths:
        if "prob" in args.only:
            todo.append((path, "prob", 0, "-"))
        for group in ("small", "full"):
            if group in args.only:
                todo += items(path, group)
    parts = _run_children(todo, args.jobs)
    for path in args.paths:
        if "prob" in args.only:
            refs.update({f"{path}_{k}": v for k, v in parts[(path, "prob", 0, "-")].items()})
        for group in ("small", "full"):
            if group in args.only:
                refs.update(gather(path, group, parts))
    np.savez_compressed(args.out, **refs)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
