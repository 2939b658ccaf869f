#!/usr/bin/env python
"""Write the reference fixture of the port's model-ingestion tests and of
``chip_smoke.py``'s ingested-Panda phase: ``tests/data/torch_ingest_ref.npz``.

The model is the armature Panda that the port's
``examples.panda_reach.write_panda_mjcf`` writes: the nominal Panda with its
flange frame named ``attachment`` and armature 0.1 on its 7 dofs, here
written by the JAX package's ``model_to_mjcf`` (the text is stored as
``mjcf_text``; the tests hold the port's text to it). Each JAX solve points
``aligator_tpu.modelling.multibody.robots.PANDA_MJCF_PATH`` at that file
in its own process and builds ``examples.panda_reach.create_panda_problem
(real_model=True)``, the published reach on the Panda read back from MJCF,
float64, from the starts of the port's ``panda_reach.initial_states(·,
0)`` (numpy, as ``chip_smoke.py``'s ``SEED``):

* ``full_*``: the first 16 starts at the phase's budget (``full_budget``
  iterations): each one's converged flag and iteration count, the card's
  floor (its count less one);
* ``small_*``: the first 2 starts after ``small_iters`` = 4 iterations:
  ``xs``, ``us``, ``lams`` and the iteration count;
* ``arm_*`` (group ``refs``): the quadruped with an armature on every dof
  (``ARM_RANGE``), 4 states about its standing configuration (numpy seed
  5, integrated on the port's configuration space) and the JAX package's
  jitted RNEA, mass matrix, ``aba``, ``aba_derivatives`` (M⁻¹ as a
  matrix) and contact KKT primal solve (its 4 feet, μ = ``CFD_MU``, one
  foot of one state inactive) there;
* ``eval_*`` (group ``refs``): the reach on the Panda read from the text
  (N = 3) evaluated by the JAX package at a random trajectory (numpy seed
  2): stage costs, dynamics residuals, constraint values, terminal cost;
* ``ffsr_*`` (group ``refs``): the tool targets of the JAX FFSR reach on
  the fork's file's stand-in (:func:`ffsr_mjcf_text`).

Each solve is jitted alone in a child process of its own (``--jobs`` at a
time): XLA's CPU runtime took other steps in processes that had compiled
other solves first (``tools/torch_centroidal_fixture.py``), and a fresh
process's jitted solve agreed with an op-by-op one there; op by op, one
4-iteration Panda solve took ~3 minutes on a CPU, jitted ~75 s whatever
the budget (the compile). The ``slow`` test of
``tests/test_torch_ingestion.py`` reruns the small group live.

Run from the repository root::

    python tools/torch_ingest_fixture.py [--only refs small full] [--jobs 4] [--out PATH]
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
from aligator_tpu_torch.examples import panda_reach as t_panda  # noqa: E402

FULL_N, FULL_BUDGET = 16, 60
SMALL_N, SMALL_ITERS = 2, 4
SEED = 0
ARM_RANGE = (0.02, 0.4)  # the quadruped's armature, linearly over its dofs
CFD_MU = 1e-3  # the contact KKT's proximal parameter
EVAL_N = 3


def jax_armature_panda():
    """The JAX package's nominal Panda, its flange renamed ``attachment``
    and ``MENAGERIE_ARMATURE`` on its dofs (the port's ``armature_panda``)."""
    from aligator_tpu.modelling.multibody import robots

    model = robots.make_panda()
    names = tuple("attachment" if n == "ee" else n for n in model.frame_names)
    return replace(model, frame_names=names,
                   armature=jnp.full((model.nv,), t_panda.MENAGERIE_ARMATURE))


def mjcf_text():
    from aligator_tpu.modelling.multibody.mjcf_export import model_to_mjcf

    return model_to_mjcf(jax_armature_panda(), name="panda")


def jax_problem(path):
    """The JAX reach on the Panda read from ``path``."""
    from aligator_tpu.modelling.multibody import robots
    from examples.panda_reach import create_panda_problem

    robots.PANDA_MJCF_PATH = path
    problem, model, _ = create_panda_problem(real_model=True)
    assert model.armature is not None and "attachment" in model.frame_names
    return problem


def armature_refs():
    """The ``arm_*`` group (module docstring)."""
    import torch

    from aligator_tpu.modelling.multibody import contact, derivatives, quadruped
    from aligator_tpu.modelling.multibody import model as rbd
    from aligator_tpu_torch.modelling.multibody import quadruped as t_quad

    jm = quadruped.make_quadruped()
    jm = replace(jm, armature=jnp.asarray(np.linspace(*ARM_RANGE, jm.nv)))
    rng = np.random.default_rng(5)
    q0 = torch.tensor(np.asarray(quadruped.standing_configuration(jm)))
    cs = t_quad.make_quadruped(device="cpu").configuration_space()
    qs = cs.integrate(q0[None], torch.tensor(0.05 * rng.standard_normal((4, jm.nv)))).numpy()
    vs, taus = 0.3 * rng.standard_normal((4, jm.nv)), rng.standard_normal((4, jm.nv))
    active = np.ones((4, 4))
    active[1, 2] = 0.0
    frames = tuple(jm.frame_id(f"foot{k}") for k in range(4))

    def one(q, v, t, act):
        a, da_dq, da_dv, solve_M = derivatives.aba_derivatives(jm, q, v, t)
        c = contact._cfd_internals(jm, q, v, t, frames, act, prox_mu=CFD_MU, kd=10.0)
        return dict(rnea=rbd.rnea(jm, q, v, t), M=rbd.mass_matrix(jm, q),
                    aba=rbd.aba(jm, q, v, t), a=a, da_dq=da_dq, da_dv=da_dv,
                    Minv=solve_M(jnp.eye(jm.nv)), cfd_a=c["a"], cfd_lam=c["lam"])

    out = jax.jit(jax.vmap(one))(qs, vs, taus, active)
    refs = {f"arm_{k}": np.asarray(v) for k, v in out.items()}
    refs.update(arm_qs=qs, arm_vs=vs, arm_taus=taus, arm_active=active)
    return refs


def eval_refs(path):
    """The ``eval_*`` group (module docstring)."""
    from aligator_tpu.core import problem as jproblem
    from aligator_tpu.modelling.multibody import robots
    from examples.panda_reach import create_panda_problem

    robots.PANDA_MJCF_PATH = path
    prob, _, _ = create_panda_problem(nsteps=EVAL_N, real_model=True)
    rng = np.random.default_rng(2)
    xs = np.asarray(prob.x0) + 0.1 * rng.standard_normal((EVAL_N + 1, 14))
    us = rng.standard_normal((EVAL_N, 7))
    d = jax.jit(jproblem.evaluate)(prob, jnp.asarray(xs), jnp.asarray(us))
    refs = {f"eval_{k}": np.asarray(getattr(d, k))
            for k in ("stage_costs", "dyn_res", "cstr_vals", "term_cost")}
    refs.update(eval_xs=xs, eval_us=us)
    return refs


def ffsr_mjcf_text():
    """The fork's FFSR file's stand-in: the nominal FFSR's MJCF with its
    tool sites named ``grip1``/``grip2``, armature 10 on the 14 arm dofs
    (as the fork's file has) and a free ``object`` body to skip."""
    from aligator_tpu.modelling.multibody import robots
    from aligator_tpu.modelling.multibody.mjcf_export import model_to_mjcf

    m = robots.make_dual_arm_ffsr()
    names = tuple({"arm1_tool": "grip1", "arm2_tool": "grip2"}.get(n, n)
                  for n in m.frame_names)
    arm = jnp.concatenate([jnp.zeros(6), jnp.full((14,), 10.0)])
    text = model_to_mjcf(replace(m, frame_names=names, armature=arm), name="ffsr")
    obj = ('    <body name="object" pos="1.0 0.0 0.0">\n      <freejoint/>\n'
           '      <inertial mass="2.0" pos="0 0 0" diaginertia="0.1 0.1 0.1"/>\n'
           '    </body>\n  </worldbody>')
    return text.replace("  </worldbody>", obj)


def ffsr_refs(tmp):
    """The ``ffsr_*`` group (module docstring)."""
    from examples import dual_ffsr_reach

    path = os.path.join(tmp, "ffsr.xml")
    with open(path, "w") as f:
        f.write(ffsr_mjcf_text())
    dual_ffsr_reach.FFSR_MJCF = path
    _, _, targets = dual_ffsr_reach.create_ffsr_problem(nsteps=2, use_mjcf=True)
    return {f"ffsr_{k}_{name}": np.asarray(v) for name, (R, p) in targets.items()
            for k, v in (("R", R), ("p", p))}


def solve_one(path, group, i):
    """Start ``i`` of a group, one jitted solve."""
    n, budget = (FULL_N, FULL_BUDGET) if group == "full" else (SMALL_N, SMALL_ITERS)
    x0 = jnp.asarray(t_panda.initial_states(n, SEED)[i])
    problem = replace(jax_problem(path), x0=x0)
    opts = {**t_panda.SOLVE_OPTIONS, "max_iters": budget}
    cfg = solvers.ProxDDPConfig(**opts)
    r = jax.jit(lambda p: solvers.solve(p, cfg))(problem)
    if group == "full":
        return dict(conv=r.conv, num_iters=r.num_iters)
    return dict(xs=r.xs, us=r.us, lams=r.lams, num_iters=r.num_iters)


def _run_children(todo, path, jobs):
    parts, running = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        queue = list(todo)
        while queue or running:
            while queue and len(running) < jobs:
                item = queue.pop(0)
                part = os.path.join(tmp, "_".join(map(str, item)) + ".npz")
                cmd = [sys.executable, os.path.abspath(__file__), "--child", *map(str, item),
                       "--mjcf", path, "--out", part]
                running.append((item, part, subprocess.Popen(cmd)))
            item, part, proc = running.pop(0)
            if proc.wait() != 0:
                raise RuntimeError(f"the JAX solve {item} failed (exit {proc.returncode})")
            with np.load(part) as f:
                parts[item] = {k: f[k] for k in f.files}
            print(*item, {k: parts[item][k] for k in ("conv", "num_iters")
                          if k in parts[item]}, flush=True)
    return parts


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=["refs", "small", "full"])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                  "torch_ingest_ref.npz"))
    ap.add_argument("--mjcf", help=argparse.SUPPRESS)
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        group, i = args.child
        out = solve_one(args.mjcf, group, int(i))
        np.savez(args.out, **{k: np.asarray(v) for k, v in out.items()})
        return
    refs = {}
    if os.path.exists(args.out):
        with np.load(args.out) as old:
            refs.update({k: old[k] for k in old.files})
    text = mjcf_text()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "panda.xml")
        with open(path, "w") as f:
            f.write(text)
        todo = [(g, i) for g in ("small", "full") if g in args.only
                for i in range(SMALL_N if g == "small" else FULL_N)]
        parts = _run_children(todo, path, args.jobs)
        if "refs" in args.only:
            refs.update(armature_refs())
            refs.update(eval_refs(path))
            refs.update(ffsr_refs(tmp))
    refs["mjcf_text"] = np.asarray(text)
    for g, n, budget in (("small", SMALL_N, SMALL_ITERS), ("full", FULL_N, FULL_BUDGET)):
        if g not in args.only:
            continue
        keys = parts[(g, 0)].keys()
        refs.update({f"{g}_{k}": np.stack([parts[(g, i)][k] for i in range(n)]) for k in keys})
        refs[f"{g}_x0s"] = t_panda.initial_states(n, SEED)
        refs[f"{g}_budget" if g == "full" else f"{g}_iters"] = np.asarray(budget)
    np.savez_compressed(args.out, **refs)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
