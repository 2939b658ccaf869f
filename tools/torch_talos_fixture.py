#!/usr/bin/env python
"""Write the Talos-walk reference fixture of the PyTorch port's tests.

Builds the whole-body Talos-walk problem of the JAX package
(``examples/talos_walk.py``) at N = 7 (t_ds = 1, t_ss = 2) in float64,
perturbs the initial velocities of 2 scenarios by 0.01·N(0, 1) (numpy,
seed 0) and solves them with ``jax.vmap(solvers.solve)`` under a 2×2
budget (the ``bench_talos.py`` configuration otherwise). The archive holds
the problem's leaves (the robot model, the schedule, the weights, the
initial states), the solver configuration and the solver's results;
``tests/test_torch_talos.py`` builds the port's problem from the leaves
(``aligator_tpu_torch.convert.talos_problem_from_numpy``) and holds the
port's solve against the results.

Run from the repository root (about 4 minutes on a CPU, nearly all of it
XLA compilation)::

    python tools/torch_talos_fixture.py [tests/data/torch_talos_ref.npz]
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aligator_tpu import solvers  # noqa: E402
from aligator_tpu._pytree import replace  # noqa: E402
from examples.talos_walk import create_talos_walk_problem  # noqa: E402

T_DS, T_SS = 1, 2
BATCH = 2
SEED = 0
CONFIG = dict(tol=1e-3, mu_init=1e-3, max_iters=2, max_al_iters=2,
              rollout="linear", ls_max_steps=6, force_initial_condition=True)
MODEL_LEAVES = ("jplac_p", "jplac_q", "axes", "mass", "com", "inertia",
                "gravity", "fplac_p", "fplac_q")
RESULT_FIELDS = ("xs", "us", "vs", "vs_term", "lams", "conv", "num_iters",
                 "al_iter", "prim_infeas", "dual_infeas", "traj_cost")


def problem_leaves(problem, model):
    """Numpy copies of the leaves the port's problem is built from."""
    stages = problem.stages
    costs = stages.cost.costs
    ode = stages.dynamics.ode
    box = stages.constraints[0][1]
    out = {k: np.asarray(getattr(model, k)) for k in MODEL_LEAVES}
    out.update(
        joint_types=np.asarray(model.joint_types),
        parents=np.asarray(model.parents),
        frame_parents=np.asarray(model.frame_parents),
        frame_names=np.asarray(model.frame_names),
        x_ref=np.asarray(costs[0].residual.target[0]),
        state_weights=np.asarray(costs[0].weights[0]),
        control_weights=np.asarray(costs[1].weights[0]),
        swing_weights=np.stack([np.asarray(costs[2 + k].weights) for k in range(2)]),
        swing_targets=np.stack([np.asarray(costs[2 + k].residual.p_ref)
                                for k in range(2)]),
        swing_frames=np.asarray([costs[2 + k].residual.frame_id for k in range(2)]),
        term_weights=np.asarray(problem.term_cost.weights),
        active=np.asarray(ode.active),
        actuation=np.asarray(ode.actuation[0]),
        u_lower=np.asarray(box.lower[0]),
        u_upper=np.asarray(box.upper[0]),
        timestep=np.asarray(stages.dynamics.timestep[0]),
        contact_frames=np.asarray(ode.contact_frames),
        contact_dims=np.asarray(ode.contact_dims),
        kd=np.asarray(ode.kd),
        prox_mu=np.asarray(ode.prox_mu),
    )
    return out


def main(path):
    problem, model, sched = create_talos_walk_problem(
        t_ds=T_DS, t_ss=T_SS, dtype=jnp.float64
    )
    rng = np.random.default_rng(SEED)
    x0 = np.asarray(problem.x0)
    x0s = np.repeat(x0[None], BATCH, 0)
    x0s[:, model.nq:] += 0.01 * rng.standard_normal((BATCH, model.nv))
    cfg = solvers.ProxDDPConfig(**CONFIG)

    def one(x0i):
        return solvers.solve(replace(problem, x0=x0i), cfg)

    res = jax.jit(jax.vmap(one))(jnp.asarray(x0s))
    arrays = problem_leaves(problem, model)
    arrays.update(x0=x0s, nsteps=np.asarray(problem.nsteps),
                  config=np.asarray(json.dumps(CONFIG)))
    arrays.update({f"res_{k}": np.asarray(getattr(res, k)) for k in RESULT_FIELDS})
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: N={problem.nsteps} batch={BATCH} num_iters="
          f"{arrays['res_num_iters'].tolist()} conv={arrays['res_conv'].tolist()}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tests/data/torch_talos_ref.npz")
