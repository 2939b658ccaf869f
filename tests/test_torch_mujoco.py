"""The port's MuJoCo examples against the JAX package's, on the CPU.

``aligator_tpu_torch.examples.mujoco_sim_env`` (``meshless_xml``,
``MuJoCoSimEnv``) against ``examples/mujoco_sim_env.py`` live, and the
closed-loop Panda MPC of ``aligator_tpu_torch.examples.mpc_panda_mujoco``
at the protocol of ``tests/test_mpc_mujoco.py``'s mechanics test against
``tests/data/torch_mujoco_ref.npz``, written by
``tools/torch_mujoco_fixture.py`` (the JAX package's jitted loop; the
``slow`` test reruns it live). The vendored Panda file is absent, so both
run on the stand-in that ``mpc_panda_mujoco.write_mujoco_panda`` writes,
at which ``robots.PANDA_MJCF_PATH`` is pointed.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("mujoco")

from examples import mujoco_sim_env as jenv  # noqa: E402

from aligator_tpu_torch.examples import mpc_panda_mujoco, mujoco_sim_env, panda_reach  # noqa: E402
from aligator_tpu_torch.modelling.multibody import robots  # noqa: E402

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_mujoco_ref.npz"
FIELDS = ("states", "u0", "K0", "prim", "errs")
TOL = 1e-9  # per cycle, relative to max(1, the field's scale); the loop does
# not magnify rounding: the port met the fixture within 7e-9 over all 20 cycles


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    path = str(tmp_path / "panda_nohand.xml")
    mpc_panda_mujoco.write_mujoco_panda(path)
    monkeypatch.setattr(robots, "PANDA_MJCF_PATH", path)
    return path


def test_meshless_xml_matches_jax(tmp_path, stand_in):
    """The same text, character for character, from the Panda that
    ``panda_reach.write_panda_mjcf`` writes and from the stand-in."""
    written = str(tmp_path / "written.xml")
    panda_reach.write_panda_mjcf(written)
    for path in (written, stand_in):
        for constraint in (True, False):
            assert (mujoco_sim_env.meshless_xml(path, constraint)
                    == jenv.meshless_xml(path, constraint))


def test_sim_env_steps_match_jax(stand_in):
    """Reset, torque steps and body positions of the port's environment
    equal the JAX package's, bit for bit."""
    xml = mujoco_sim_env.meshless_xml(stand_in)
    envs = (mujoco_sim_env.MuJoCoSimEnv(xml, timestep=0.002),
            jenv.MuJoCoSimEnv(xml, timestep=0.002))
    rng = np.random.default_rng(0)
    v0 = 0.1 * rng.standard_normal(7)
    states = [env.reset(robots.PANDA_Q_HOME, v0) for env in envs]
    for _ in range(4):
        tau = 5.0 * rng.standard_normal(7)
        states += [env.step(tau, 3) for env in envs]
    for a, b in zip(states[0::2], states[1::2]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert envs[0].timestep == envs[1].timestep == 0.002
    for name in ("attachment", "body3"):
        assert np.array_equal(envs[0].body_pos(name), envs[1].body_pos(name))


def _scaled_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def test_closed_loop_matches_jax_fixture(stand_in):
    """The protocol of test_mpc_mujoco.py's mechanics test (20 cycles, N =
    12, dt = 0.01, 40 iterations first, 6 a cycle) on the CPU: every cycle's
    simulator state, first control, first Riccati gain, primal
    infeasibility and end-effector error within TOL of the JAX package's
    loop; and the JAX test's mechanics checks on the port's loop (finite,
    errors bounded by five times the initial offset)."""
    ref = np.load(FIXTURE)
    protocol = json.loads(str(ref["protocol"]))
    out = mpc_panda_mujoco.run_closed_loop(device="cpu", **protocol)
    for name in FIELDS:
        got = np.asarray(out[name])
        assert got.shape[0] == protocol["ncycles"]
        for c in range(protocol["ncycles"]):
            assert _scaled_err(got[c], ref[name][c]) <= TOL, (name, c)
    errs = np.asarray(out["errs"])
    assert np.all(np.isfinite(errs))
    assert errs.max() < 5.0 * max(errs[0], 0.05)


@pytest.mark.slow
def test_closed_loop_tracking(stand_in):
    """The JAX test's full protocol on the port: 110 cycles bring the
    flange within 1 cm of the target."""
    out = mpc_panda_mujoco.run_closed_loop(ncycles=110, device="cpu")
    assert out["final_err_m"] < 0.01, out["final_err_m"]


@pytest.mark.slow
def test_fixture_matches_a_live_jax_run(tmp_path):
    out = tmp_path / "ref.npz"
    subprocess.run([sys.executable, str(ROOT / "tools" / "torch_mujoco_fixture.py"),
                    "--out", str(out)], check=True, cwd=ROOT)
    live, ref = np.load(out), np.load(FIXTURE)
    for name in FIELDS:
        np.testing.assert_allclose(live[name], ref[name], rtol=0, atol=1e-12)
