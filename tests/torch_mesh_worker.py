"""The rank side of tests/test_torch_mesh.py: one process of a gloo world on
the CPU. It imports only the port (no JAX), runs every case of the test
module on the inputs the main process wrote, and saves its results, one
file a rank, for the main process to hold against the JAX package.

    run(rank, world, init_file, inputs_path, out_dir)

is the target of ``torch.multiprocessing.start_processes(..., start_method=
"spawn")``; the world meets through ``init_method="file://<init_file>"``
(no port, no network).
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from aligator_tpu_torch import convert, gar, solvers
from aligator_tpu_torch.examples.lqr import make_lqr_problem
from aligator_tpu_torch.gar import parallel
from aligator_tpu_torch.parallel import mesh as mesh_mod

MU = 1e-3
LQR_CFG = dict(tol=1e-8, mu_init=1e-3, max_iters=6)
INPUTS_TIMEOUT_S = 180


def lqr_from(data, prefix):
    """The LQ problem saved under ``prefix`` by the main process."""
    return convert.lqr_problem_from_numpy(
        {k[len(prefix):]: v for k, v in data.items() if k.startswith(prefix)}, device="cpu")


def g0_solver(problem):
    """``solve_batch`` of test_mesh.py's ``_solve_one``: the one problem with
    each row of ``g0s`` as its initial constraint's ``g0``, its controls."""
    def solve_batch(g0s):
        b = g0s.shape[0]
        p = problem.map(lambda t: t.expand((b,) + t.shape[1:]))
        p = dataclasses.replace(p, g0=g0s)
        return gar.solve(p, MU, MU, assume_explicit=True)[1]

    return solve_batch


def lqr_solver(problem, cfg):
    def solve_batch(x0s):
        return solvers.solve(dataclasses.replace(problem, x0=x0s), cfg).us

    return solve_batch


def cases(rank, data):
    out = {}
    # (a) batched_solve over a flat batch axis
    mesh = mesh_mod.make_mesh(device="cpu")
    out["a_shape"] = np.array(mesh.shape)
    fn = g0_solver(lqr_from(data, "a_"))
    out["a"] = mesh_mod.batched_solve(fn, torch.tensor(data["a_g0s"]), mesh=mesh).numpy()
    out["a_local"] = fn(torch.tensor(data["a_g0s"])).numpy()

    # (b) the 2 x 2 hybrid mesh, sharding over both axes
    hm = mesh_mod.make_hybrid_mesh(n_slices=2, device="cpu")
    out["b_shape"] = np.array(hm.shape)
    out["b_axes"] = np.array(hm.axis_names)
    fn = g0_solver(lqr_from(data, "b_"))
    out["b"] = mesh_mod.batched_solve(fn, torch.tensor(data["b_g0s"]), mesh=hm,
                                      axis_name=("dcn", "batch")).numpy()
    out["b_local"] = fn(torch.tensor(data["b_g0s"])).numpy()

    # (c) solve_sharded at medium dims, one leg a rank
    tm = mesh_mod.make_mesh(("t",), device="cpu")
    for case in ("c", "e"):
        mesh_mod.COLLECTIVES.clear()
        mesh_mod.HOST_COPIES.clear()
        legs = parallel.solve_sharded(lqr_from(data, f"{case}_"), MU, MU, tm,
                                      assume_explicit=True)
        for name, leg in zip(("xs", "us", "vs", "lams"), legs):
            out[f"{case}_{name}"] = leg.numpy()
        # (e) the census: every collective of the solve
        out[f"{case}_census"] = np.array(repr(sorted(mesh_mod.COLLECTIVES.items())))
        out[f"{case}_host_copies"] = np.array(sum(mesh_mod.HOST_COPIES.values()))

    # (d) the sharded ProxDDP
    problem = make_lqr_problem(nsteps=12, device="cpu")
    fn = lqr_solver(problem, solvers.ProxDDPConfig(**LQR_CFG))
    x0s = torch.tensor(data["d_x0s"])
    out["d"] = mesh_mod.batched_solve(fn, x0s, mesh=mesh).numpy()
    out["d_local"] = fn(x0s).numpy()

    # (f) the raises: T % legs, nc0 != nx
    prob = lqr_from(data, "e_")
    short = dataclasses.replace(prob, knots=prob.knots.map(lambda t: t[:, :30]))
    out["f_raises"] = []
    for bad in (short, dataclasses.replace(prob, G0=prob.G0[:, :5], g0=prob.g0[:, :5])):
        try:
            parallel.solve_sharded(bad, MU, MU, tm, assume_explicit=True)
            out["f_raises"].append("")
        except ValueError as err:
            out["f_raises"].append(str(err))
    out["f_raises"] = np.array(out["f_raises"])
    return out


def run(rank, world, init_file, inputs_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        t0 = time.monotonic()
        while not pathlib.Path(inputs_path).exists():
            if time.monotonic() - t0 > INPUTS_TIMEOUT_S:
                raise TimeoutError(f"no inputs at {inputs_path}")
            time.sleep(0.2)
        data = dict(np.load(inputs_path))
        out = cases(rank, data)
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    except BaseException:
        (pathlib.Path(out_dir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
