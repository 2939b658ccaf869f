"""Closed-loop MPC on the real Panda with MuJoCo physics in the loop.

Port of the JAX package's ``examples/mpc_panda_mujoco.py`` (the role of the
reference's ``examples/panda_mujoco_test.py``): the solver plans over its
own model (the MJCF-ingested real Panda, ``robots.make_panda_real``),
MuJoCo, an independent physics engine, integrates the commanded torques
(:mod:`.mujoco_sim_env`), and the receding-horizon loop
(``utils.mpc.cycle_warm_start``) re-solves from the simulator's state.

The planner's model matches MuJoCo's: the MJCF's joint damping goes
through ``MultibodyFlexibleFwdDynamics`` with zero stiffness, and its
armature sits in the mass matrix. The first solve converges; the warm
cycles take a few iterations from the shifted previous solution. The
Riccati gains ``K₀`` act at the physics rate between re-solves (u = u₀ +
K₀(x̂ ⊖ x_plan)), the re-solve at the control rate.

The solve runs on ``device``: on the card every nonlinear line-search
trial is a graph replay (``proxddp._TrialGraph``), the new state written
into ``problem.x0`` in place so that the graphs captured at the first
cycle are replayed by the later ones. The plant stays in MuJoCo on the
host, and the state crosses once a cycle. Without ``mujoco`` (the card
machine) :func:`create_mpc_problem`, :func:`first_solve` and
:func:`cycle_solve` still run.

The vendored Panda file is absent where the port is tested;
:func:`write_mujoco_panda` writes a stand-in, at which the caller points
``robots.PANDA_MJCF_PATH``.

Run: ``python -m aligator_tpu_torch.examples.mpc_panda_mujoco [ncycles]
[--device cpu] [--stand-in]``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from .. import core, solvers
from .._device import resolve
from ..modelling import IntegratorSemiImplEuler
from ..modelling.dynamics.multibody_free import MultibodyFlexibleFwdDynamics
from ..modelling.multibody import robots
from ..modelling.multibody.residuals import FramePlacementResidual, FrameVelocityResidual
from ..utils.mpc import cycle_warm_start
from .mujoco_sim_env import MuJoCoSimEnv, meshless_xml
from .panda_reach import write_panda_mjcf


def write_mujoco_panda(path) -> str:
    """Write a stand-in for the vendored ``panda_nohand.xml`` that both the
    planner (``robots.make_panda_real``) and MuJoCo (:func:`meshless_xml`)
    read: ``panda_reach.write_panda_mjcf``'s Panda (the nominal one with
    Menagerie's armature) with its flange ``attachment`` a jointless body,
    as in Menagerie's file (there a site, which ``MuJoCoSimEnv.body_pos``
    does not find), and without the file's ``<flag>`` (which
    :func:`meshless_xml` adds, and MuJoCo takes once). The planner's model
    is the same as from the file ``write_panda_mjcf`` writes. Returns the
    text."""
    root = ET.fromstring(write_panda_mjcf(path))
    opt = root.find("option")
    for flag in opt.findall("flag"):
        opt.remove(flag)
    for parent in root.iter():
        for i, site in enumerate(list(parent)):
            if site.tag == "site" and site.get("name") == "attachment":
                parent.remove(site)
                parent.insert(i, ET.Element("body", dict(site.attrib)))
    text = ET.tostring(root, encoding="unicode")
    with open(path, "w") as f:
        f.write(text)
    return text


def create_mpc_problem(nsteps=20, timestep=0.02, p_target=(0.4, 0.3, 0.5),
                       dtype=torch.float64, device="cuda"):
    """Short-horizon reach OCP on the real Panda, damping-consistent with
    the MuJoCo plant, one scenario from the home posture. Returns
    ``(problem, model, (R_target, p_target))``."""
    dev = resolve(device)
    model, info = robots.make_panda_real(dtype=dtype, device=dev)
    nv = model.nv
    space = model.phase_space()
    nu = nv

    def t(v):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    dyn_ode = MultibodyFlexibleFwdDynamics(
        model=model, actuation=torch.eye(nv, dtype=dtype, device=dev),
        stiffness=t(np.zeros(nv)), damping=t(info["damping"]), q_rest=t(np.zeros(nv)))
    dyn = IntegratorSemiImplEuler(ode=dyn_ode, timestep=t(timestep))

    ee = model.frame_id("ee")
    p_t = t(p_target)
    R_t = t([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]])
    pose_res = FramePlacementResidual(model=model, R_ref=R_t, p_ref=p_t, frame_id=ee)
    vel_res = FrameVelocityResidual(model=model, v_ref=t(np.zeros(6)), frame_id=ee)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    rcost = core.CostStack.create(
        core.QuadraticResidualCost(residual=pose_res, weights=10.0 * eye6 * timestep),
        core.QuadraticControlCost(1e-4 * torch.eye(nu, dtype=dtype, device=dev) * timestep))
    term_cost = core.CostStack.create(
        core.QuadraticResidualCost(residual=pose_res, weights=100.0 * eye6),
        core.QuadraticResidualCost(residual=vel_res, weights=20.0 * eye6))
    effort = t(robots.PANDA_EFFORT_LIMIT)
    constraints = ((core.ControlErrorResidual(target=t(np.zeros(nu))),
                    core.BoxConstraint(lower=-effort, upper=effort)),)
    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    x0 = torch.cat([t(robots.PANDA_Q_HOME), t(np.zeros(nv))])
    problem = core.make_problem(x0[None], stage, nsteps, term_cost)
    return problem, model, (R_t, p_t)


def solver_configs(init_iters=120, cycle_iters=10):
    """The converged first solve's options and the warm cycles'."""
    cfg_init = solvers.ProxDDPConfig(tol=1e-5, mu_init=1e-2, max_iters=init_iters,
                                     rollout="nonlinear")
    cfg = solvers.ProxDDPConfig(tol=1e-5, mu_init=1e-3, max_iters=cycle_iters,
                                max_al_iters=2, rollout="nonlinear", ls_max_steps=8)
    return cfg_init, cfg


def first_solve(problem, cfg_init, x):
    """The first solve, from the state ``x (nx,)`` (numpy or tensor),
    written into ``problem.x0`` in place."""
    problem.x0.copy_(torch.as_tensor(np.asarray(x), dtype=problem.x0.dtype)[None])
    return solvers.solve(problem, cfg_init)


def cycle_solve(problem, cfg, x, res):
    """One warm cycle from the state ``x (nx,)``: the previous results
    ``res`` shifted one stage (``cycle_warm_start`` with the tail rolled
    out), the state written into ``problem.x0`` in place, the re-solve."""
    xs, us, vs, lams = cycle_warm_start(res.xs, res.us, vs=res.vs, lams=res.lams,
                                        problem=problem)
    problem.x0.copy_(torch.as_tensor(np.asarray(x), dtype=problem.x0.dtype)[None])
    return solvers.solve(problem, cfg, xs_init=xs, us_init=us, vs_init=vs, lams_init=lams)


def run_closed_loop(ncycles=120, nsteps=40, timestep=0.01, p_target=(0.4, 0.3, 0.5),
                    cycle_iters=10, init_iters=120, verbose=False, device="cuda"):
    """Run the MPC loop; returns a dict of tracking diagnostics and, per
    cycle, the state solved from (``states``), the first control
    (``u0``), the first feedback gain (``K0``) and the primal
    infeasibility (``prim``)."""
    problem, model, (R_t, p_t) = create_mpc_problem(
        nsteps=nsteps, timestep=timestep, p_target=p_target, device=device)
    env = MuJoCoSimEnv(meshless_xml(robots.PANDA_MJCF_PATH))
    n_sub = max(1, round(timestep / env.timestep))
    cfg_init, cfg = solver_configs(init_iters, cycle_iters)

    q, v = env.reset(robots.PANDA_Q_HOME)
    x = np.concatenate([q, v])
    res = first_solve(problem, cfg_init, x)
    lim = np.asarray(robots.PANDA_EFFORT_LIMIT)
    p_target = p_t.cpu().numpy()

    errs, cmd_sat = [], 0
    rec = {k: [] for k in ("states", "u0", "K0", "prim")}
    for cyc in range(ncycles):
        if cyc > 0:
            res = cycle_solve(problem, cfg, x, res)
        # zero-order-hold torque + Riccati feedback at the physics rate
        # (x_plan linearly interpolated; exact tangent arithmetic here: a
        # fixed-base arm, nq == nv); the one host copy of the cycle
        u0, x0n, x1n, Kn, prim = (a.cpu().numpy() for a in (
            res.us[0, 0], res.xs[0, 0], res.xs[0, 1], res.K[0, 0], res.prim_infeas[0]))
        for name, val in zip(rec, (x, u0, Kn, prim)):
            rec[name].append(val)
        for j in range(n_sub):
            qj, vj = env.state()
            xref = x0n + (j / n_sub) * (x1n - x0n)
            uj = u0 + Kn @ (np.concatenate([qj, vj]) - xref)
            env.step(np.clip(uj, -lim, lim), 1)
        q, v = env.state()
        x = np.concatenate([q, v])
        p_ee = env.body_pos("attachment")
        errs.append(float(np.linalg.norm(p_ee - p_target)))
        cmd_sat += int(np.any(np.abs(u0) >= lim - 1e-9))
        if verbose and cyc % 10 == 0:
            print(f"cycle {cyc:4d}  |ee err| = {errs[-1]:.4f} m  prim = {float(prim):.2e}")

    out = {
        "final_err_m": errs[-1],
        "min_err_m": min(errs),
        "mean_tail_err_m": float(np.mean(errs[-10:])),
        "cycles": ncycles,
        "saturated_cycles": cmd_sat,
        "errs": errs,
    }
    out.update({k: np.stack(v) for k, v in rec.items()})
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ncycles", nargs="?", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stand-in", action="store_true",
                    help="run on write_mujoco_panda's stand-in, written to a temporary file")
    args = ap.parse_args()
    if args.stand_in:
        import tempfile

        robots.PANDA_MJCF_PATH = tempfile.mkstemp(suffix=".xml")[1]
        write_mujoco_panda(robots.PANDA_MJCF_PATH)
    out = run_closed_loop(ncycles=args.ncycles, verbose=True, device=args.device)
    print({k: v for k, v in out.items() if k in ("final_err_m", "min_err_m",
                                                  "mean_tail_err_m", "cycles",
                                                  "saturated_cycles")})
    assert out["final_err_m"] < 0.01, "closed-loop tracking failed"
    print(f"closed-loop MuJoCo MPC: tracked to {out['final_err_m'] * 1000:.1f} mm")
