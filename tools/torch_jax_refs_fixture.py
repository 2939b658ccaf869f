#!/usr/bin/env python
"""Write the JAX references that three of the port's test files read from
fixtures instead of compiling them in every run:

* ``multibody`` → ``tests/data/torch_multibody_ref.npz``: the ``jax_*``
  functions of ``tests/test_torch_multibody.py`` (the rigid-body
  algorithms on the humanoid and the quadruped, the primal contact solve
  with K5's reference rows and the Pallas kernel's in interpret mode, the
  contact dynamics' (A, B, E));
* ``se2`` → ``tests/data/torch_se2_ref.npz``: ``jax_solve_refs`` of
  ``tests/test_torch_se2_proxddp.py`` (the batched SE(2) solves);
* ``talos`` → ``tests/data/torch_talos_derivs_ref.npz``:
  ``jax_derivative_refs`` of ``tests/test_torch_talos.py``.

Each array is stored under ``<group>_<name>`` of the test module's
``JAX_REFS`` (the talos file without a prefix). The functions are the test
modules' own, so the fixture and each file's ``slow`` test (which reruns
them live) compute the same thing. Run from the repository root (~2 min)::

    python tools/torch_jax_refs_fixture.py [--only multibody se2 talos]
"""

import argparse
import os
import pathlib
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tests"), str(ROOT)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

GROUPS = {
    "multibody": ("test_torch_multibody", "torch_multibody_ref.npz", True),
    "se2": ("test_torch_se2_proxddp", "torch_se2_ref.npz", True),
    "talos": ("test_torch_talos", "torch_talos_derivs_ref.npz", False),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=sorted(GROUPS), default=sorted(GROUPS))
    args = ap.parse_args()
    for group in args.only:
        module, name, prefixed = GROUPS[group]
        mod = __import__(module)
        arrays = {}
        for key, (fn, fn_args) in mod.JAX_REFS.items():
            for k, v in fn(*fn_args).items():
                arrays[f"{key}_{k}" if prefixed else k] = v
        out = ROOT / "tests" / "data" / name
        np.savez_compressed(out, **arrays)
        print(f"wrote {out} ({len(arrays)} arrays)")


if __name__ == "__main__":
    main()
