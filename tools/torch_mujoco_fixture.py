#!/usr/bin/env python
"""Write the reference fixture of the port's MuJoCo closed-loop tests:
``tests/data/torch_mujoco_ref.npz``.

It runs the JAX package's ``examples.mpc_panda_mujoco.run_closed_loop`` (its
solves jitted by the example itself) in a fresh process, with
``aligator_tpu.modelling.multibody.robots.PANDA_MJCF_PATH`` and the
example's own name for it pointed at the stand-in that the port's
``examples.mpc_panda_mujoco.write_mujoco_panda`` writes, at the protocol of
``tests/test_mpc_mujoco.py``'s mechanics test (``PROTOCOL``). Each jitted
solve's inputs and outputs are recorded on their way through ``jax.jit``,
which gives, per cycle: the simulator state the solve started from
(``states``), the first control (``u0``), the first feedback gain
(``K0``), the primal infeasibility (``prim``); and the loop's end-effector
errors (``errs``).

Run from the repository root (~1 min)::

    python tools/torch_mujoco_fixture.py [--out PATH] [--ncycles N]
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "torch_mujoco_ref.npz"
PROTOCOL = dict(ncycles=20, nsteps=12, timestep=0.01, p_target=(0.32, 0.08, 0.55),
                init_iters=40, cycle_iters=6)


def child(path, out, protocol):
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu.modelling.multibody import robots

    import examples.mpc_panda_mujoco as ex

    robots.PANDA_MJCF_PATH = ex.PANDA_MJCF_PATH = path
    calls = []
    jit = jax.jit

    def recording_jit(fn):
        compiled = jit(fn)

        def call(*args):
            res = compiled(*args)
            calls.append((np.asarray(args[0]), [np.asarray(r) for r in res]))
            return res

        return call

    jax.jit = recording_jit
    try:
        result = ex.run_closed_loop(**protocol)
    finally:
        jax.jit = jit
    states = np.stack([x for x, _ in calls])
    u0 = np.stack([r[1][0] for _, r in calls])
    K0 = np.stack([r[5] for _, r in calls])
    prim = np.stack([r[4] for _, r in calls])
    np.savez(out, states=states, u0=u0, K0=K0, prim=prim, errs=np.asarray(result["errs"]),
             protocol=json.dumps(protocol), jax_version=jax.__version__)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--ncycles", type=int, default=PROTOCOL["ncycles"])
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        path, out, protocol = args.child
        return child(path, out, json.loads(protocol))
    sys.path.insert(0, str(ROOT))
    from aligator_tpu_torch.examples.mpc_panda_mujoco import write_mujoco_panda

    protocol = dict(PROTOCOL, ncycles=args.ncycles)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "panda_nohand.xml")
        write_mujoco_panda(path)
        subprocess.run([sys.executable, __file__, "--child", path, args.out,
                        json.dumps(protocol)], check=True)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
