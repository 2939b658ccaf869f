"""The port's model ingestion (MJCF, URDF, MJCF export) and the joint
armature in its dynamics against the JAX package, float64 on the CPU.

The parsers are numpy host code in both packages, so the port's models
are held to the JAX package's to 1e-15; the MJCF text the port writes is
the JAX package's, byte for byte. The armature enters RNEA, the mass
matrix, ``aba``, its derivatives and the contact KKT (1e-12 relative
against the JAX package's jitted functions); the contact-dynamics
derivative rows (K5) do not see it. The Panda read back from MJCF
(``make_panda_real``) and its reach (``create_panda_problem(
real_model=True)``) are held against the JAX package's, and the reach's
first 2 starts over 4 iterations against its solves. The JAX package's
dynamics, evaluation and solves are read from
``tests/data/torch_ingest_ref.npz`` (``tools/torch_ingest_fixture.py``;
the ``slow`` test reruns it live).
"""

import dataclasses
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligator_tpu._pytree import replace as jreplace
from aligator_tpu.modelling.multibody import humanoid as jhum
from aligator_tpu.modelling.multibody import mjcf as jmjcf
from aligator_tpu.modelling.multibody import mjcf_export as jexport
from aligator_tpu.modelling.multibody import quadruped as jquad
from aligator_tpu.modelling.multibody import robots as jrobots
from aligator_tpu.modelling.multibody import urdf as jurdf

import aligator_tpu_torch as at
from aligator_tpu_torch.core import problem as tproblem
from aligator_tpu_torch.examples import dual_ffsr_reach, panda_reach
from aligator_tpu_torch.modelling.multibody import contact as tcontact
from aligator_tpu_torch.modelling.multibody import derivatives as tder
from aligator_tpu_torch.modelling.multibody import fd_rows
from aligator_tpu_torch.modelling.multibody import humanoid as thum
from aligator_tpu_torch.modelling.multibody import mjcf as tmjcf
from aligator_tpu_torch.modelling.multibody import mjcf_export as texport
from aligator_tpu_torch.modelling.multibody import model as rbd
from aligator_tpu_torch.modelling.multibody import quadruped as tquad
from aligator_tpu_torch.modelling.multibody import robots as trobots
from aligator_tpu_torch.modelling.multibody import urdf as turdf

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_ingest_ref.npz"
PARSE_TOL = 1e-15  # the same numpy parse in both packages
ARM_TOL = 1e-12  # the armature dynamics, float64, relative
SPREAD_EPS, SPREAD_FACTOR, SOLVE_TOL = 1e-15, 100, 1e-9
ROBOTS = {  # tests/test_mujoco_crosscheck.py's six
    "ur5": (jrobots.make_ur5, trobots.make_ur5),
    "panda_nominal": (jrobots.make_panda, trobots.make_panda),
    "double_pendulum": (jrobots.make_double_pendulum, trobots.make_double_pendulum),
    "humanoid": (jhum.make_humanoid, thum.make_humanoid),
    "quadruped": (jquad.make_quadruped, tquad.make_quadruped),
    "free_sphere": (jrobots.make_free_sphere, trobots.make_free_sphere),
}
TOPOLOGY = ("joint_types", "parents", "frame_parents", "frame_names")
# tests/test_ingestion.py's inline MJCF: default classes, childclass-free
# class reference, degrees, density inertia of box and sphere geoms
MINI_MJCF = """
<mujoco model="mini">
  <compiler angle="degree"/>
  <default>
    <joint damping="2.5" armature="0.1"/>
    <default class="stiff"><joint damping="7.0"/></default>
  </default>
  <worldbody>
    <body name="b1" pos="0 0 1" euler="0 0 90">
      <joint name="h1" axis="0 1 0"/>
      <geom type="box" size="0.1 0.2 0.3" density="500"/>
      <body name="b2" pos="0.5 0 0">
        <joint name="h2" class="stiff" axis="1 0 0"/>
        <geom type="sphere" size="0.2"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""
# a childclass, a capsule by fromto, axisangle and quat frames, an
# <inertial> with diaginertia and quat, a welded body and sites, radians
CHILDCLASS_MJCF = """
<mujoco model="childclass">
  <compiler angle="radian"/>
  <option gravity="0 0 -9.6"/>
  <default>
    <default class="arm"><joint armature="0.3" damping="1.0"/>
      <geom type="capsule" size="0.04" density="800"/></default>
  </default>
  <worldbody>
    <body name="base" pos="0.1 0 0.5" childclass="arm">
      <joint name="j1" type="hinge" axis="0 0 1"/>
      <geom fromto="0 0 0 0 0 0.3"/>
      <body name="upper" pos="0 0 0.3" axisangle="1 0 0 0.4">
        <joint name="j2" type="slide" axis="0 1 0"/>
        <inertial pos="0 0.02 0.1" quat="0.9 0.1 0.2 0.3" mass="1.2"
                  diaginertia="0.01 0.02 0.015"/>
        <site name="tip" pos="0 0 0.25" quat="0.7071068 0 0.7071068 0"/>
        <body name="welded" pos="0 0 0.25">
          <geom type="cylinder" size="0.03 0.05"/>
          <site name="tool" pos="0.05 0 0"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="j2"/><motor joint="j1"/></actuator>
</mujoco>
"""


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_ingest_fixture", ROOT / "tools" / "torch_ingest_fixture.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


TOOL = _load_tool()


def _fixture(prefix=""):
    with np.load(FIXTURE) as f:
        return {k[len(prefix):]: f[k] for k in f.files if k.startswith(prefix)}


def _jax_test_module(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max()) if got.size else 0.0


def _same_model(tm, jm, tol=PARSE_TOL):
    for k in rbd.LEAVES:
        assert _rel(getattr(tm, k), getattr(jm, k)) <= tol, k
    assert (tm.armature is None) == (jm.armature is None)
    if jm.armature is not None:
        assert _rel(tm.armature, jm.armature) <= tol
    for k in TOPOLOGY:
        assert getattr(tm, k) == getattr(jm, k), k


def _same_info(ti, ji):
    assert ti.keys() == ji.keys()
    for k, v in ji.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(ti[k], v, err_msg=k)
        else:
            assert ti[k] == v, k


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _jax_armature_panda():
    jm = jrobots.make_panda()
    names = tuple("attachment" if n == "ee" else n for n in jm.frame_names)
    return jreplace(jm, frame_names=names,
                    armature=jnp.full((jm.nv,), panda_reach.MENAGERIE_ARMATURE))


# ---------------------------------------------------------------- parsers


@pytest.mark.parametrize("root_joint", [None, "freeflyer"])
def test_urdf_matches_jax(root_joint):
    """tests/test_ingestion.py's two-link pendulum (continuous and revolute
    joints, a welded tool link, damping, limits), with and without a
    free-flyer root."""
    text = _jax_test_module("test_ingestion").URDF_2LINK
    jm, ji = jurdf.load_urdf(text, root_joint=root_joint)
    tm, ti = turdf.load_urdf(text, root_joint=root_joint, device="cpu")
    _same_model(tm, jm)
    _same_info(ti, ji)
    if root_joint:  # a free fall: the base accelerates at g
        q = tm.neutral()[None]
        a = rbd.aba(tm, q, torch.zeros_like(q[..., :tm.nv]), torch.zeros_like(q[..., :tm.nv]))
        assert _rel(a[0, :3], [0.0, 0.0, -9.81]) < 1e-12


@pytest.mark.parametrize("name", ["mini", "childclass"])
def test_mjcf_matches_jax(tmp_path, name):
    """Inline MJCF: default classes and childclass, degrees and radians,
    euler/axisangle/quat frames, density inertia of box, sphere, capsule
    (fromto) and cylinder geoms, ``<inertial>`` with diaginertia, a welded
    body, sites, actuators, gravity; the model on the card by default."""
    path = _write(tmp_path, f"{name}.xml", MINI_MJCF if name == "mini" else CHILDCLASS_MJCF)
    jm, ji = jmjcf.load_mjcf(path)
    tm, ti = tmjcf.load_mjcf(path, device="cpu")
    _same_model(tm, jm)
    _same_info(ti, ji)
    if name == "childclass":
        assert ti["actuated_dofs"] == (1, 0) and ti["armature"].tolist() == [0.3, 0.3]
        assert "welded" in tm.frame_names and "tool" in tm.frame_names


def test_mjcf_include_splices_the_file(tmp_path):
    """An ``<include>`` in the worldbody reads the same model as the text
    spliced in."""
    body = MINI_MJCF.split("<worldbody>")[1].split("</worldbody>")[0]
    _write(tmp_path, "bodies.xml", f"<mujoco>{body}</mujoco>")
    head = MINI_MJCF.split("<worldbody>")[0]
    path = _write(tmp_path, "main.xml", head + '<worldbody><include file="bodies.xml"/>'
                  "</worldbody></mujoco>")
    inline = _write(tmp_path, "inline.xml", MINI_MJCF)
    tm, _ = tmjcf.load_mjcf(path, device="cpu")
    _same_model(tm, tmjcf.load_mjcf(inline, device="cpu")[0], 0.0)
    _same_model(tm, jmjcf.load_mjcf(path)[0])


@pytest.mark.parametrize("name", list(ROBOTS) + ["panda_armature"])
def test_mjcf_export_matches_jax_and_reads_back(tmp_path, name):
    """model_to_mjcf writes the JAX package's text byte for byte; both
    parsers read it back to the same model (1e-15), and that model is the
    one written: its joints' tables (placements as rotations) to 1e-12, its
    armature equal, each written frame at its placement."""
    if name == "panda_armature":
        jm, tm = _jax_armature_panda(), panda_reach.armature_panda(device="cpu")
    else:
        jm, tm = ROBOTS[name][0](), ROBOTS[name][1](device="cpu")
    text = texport.model_to_mjcf(tm, name=name)
    assert text == jexport.model_to_mjcf(jm, name=name)
    path = _write(tmp_path, f"{name}.xml", text)
    jm2, ji = jmjcf.load_mjcf(path)
    tm2, ti = tmjcf.load_mjcf(path, device="cpu")
    _same_model(tm2, jm2)
    _same_info(ti, ji)
    for k in ("jplac_p", "axes", "mass", "com", "inertia", "gravity"):
        assert _rel(getattr(tm2, k), getattr(tm, k)) <= 1e-12, k
    assert _rel(rbd.quat_to_matrix(tm2.jplac_q), rbd.quat_to_matrix(tm.jplac_q)) <= 1e-12
    if tm.armature is None:
        assert tm2.armature is None
    else:
        assert torch.equal(tm2.armature, tm.armature)
    assert (tm2.joint_types, tm2.parents) == (tm.joint_types, tm.parents)
    q = tm.configuration_space().integrate(tm.neutral()[None],
                                           0.3 * torch.ones(1, tm.nv, dtype=torch.float64))
    for fid, fname in enumerate(tm.frame_names):
        R, p = rbd.frame_placement(tm, q, fid)
        R2, p2 = rbd.frame_placement(tm2, q, tm2.frame_id(fname))
        assert _rel(R2, R) <= 1e-12 and _rel(p2, p) <= 1e-12, fname


# ---------------------------------------------------------------- armature dynamics


def _armature_quadruped():
    """The port's quadruped (a free-flyer and 12 joints, the JAX package's
    model) with the fixture's armature on every dof, and the fixture's 4
    states about its standing configuration."""
    ref = _fixture()
    tm = tquad.make_quadruped(device="cpu")
    jm = jquad.make_quadruped()
    for k in rbd.LEAVES:
        assert _rel(getattr(tm, k), getattr(jm, k)) <= PARSE_TOL, k
    arm = np.linspace(*TOOL.ARM_RANGE, tm.nv)
    tm = dataclasses.replace(tm, armature=torch.tensor(arm))
    return tm, ref, *(torch.tensor(ref[f"arm_{k}"]) for k in ("qs", "vs", "taus", "active"))


def test_armature_dynamics_match_jax():
    """RNEA (armature·a), the mass matrix (its diagonal), aba, the analytic
    aba derivatives and the contact KKT's primal solve on the quadruped
    with armature against the JAX package's jitted functions (the
    fixture), to 1e-12 relative. The contact solve at μ = 1e-3: below it
    the two packages' Cholesky orders part by the KKT's conditioning, with
    or without an armature (at μ = 1e-5 2.1e-12 without, 4.4e-12 with; at
    1e-9 1.7e-8 and 9.3e-8)."""
    tm, ref, tq, tv, tt, tact = _armature_quadruped()
    frames = tuple(tm.frame_id(f"foot{k}") for k in range(4))
    a, da_dq, da_dv, solve_M = tder.aba_derivatives(tm, tq, tv, tt)
    c = tcontact.cfd_internals(tm, tq, tv, tt, frames, tact, prox_mu=TOOL.CFD_MU, kd=10.0)
    got = dict(rnea=rbd.rnea(tm, tq, tv, tt), M=rbd.mass_matrix(tm, tq),
               aba=rbd.aba(tm, tq, tv, tt), a=a, da_dq=da_dq, da_dv=da_dv,
               Minv=solve_M(torch.eye(tm.nv, dtype=tq.dtype).expand(4, -1, -1)),
               cfd_a=c["a"], cfd_lam=c["lam"])
    for k, g in got.items():
        assert _rel(g, ref[f"arm_{k}"]) <= ARM_TOL, k
    # the armature is in: the model without it gives another M and a
    bare = dataclasses.replace(tm, armature=None)
    assert _rel(rbd.mass_matrix(bare, tq), ref["arm_M"]) > 1e-3
    assert _rel(rbd.aba(bare, tq, tv, tt), ref["arm_aba"]) > 1e-3


def test_fd_rows_do_not_see_the_armature():
    """K5's rows are ∂(RNEA + Jᵀλ)/∂(q, v): armature·a depends on neither,
    so the plain rows with and without the armature are equal."""
    tm, _, tq, tv, tt, _ = _armature_quadruped()
    frames = tuple(tm.frame_id(f"foot{k}") for k in range(4))
    act = torch.ones(4, 4, dtype=tq.dtype)
    c = tcontact.cfd_internals(tm, tq, tv, tt, frames, act, prox_mu=1e-9, kd=10.0)
    bare = dataclasses.replace(tm, armature=None)
    rows = fd_rows.fd_rows(tm, tq, tv, c["a"], c["lam"], act, frames, (3,) * 4, kd=10.0)
    rows0 = fd_rows.fd_rows(bare, tq, tv, c["a"], c["lam"], act, frames, (3,) * 4, kd=10.0)
    for r, r0 in zip(rows, rows0):
        assert torch.equal(r, r0)


def test_armature_panda_matches_mujoco(tmp_path):
    """The port's mass matrix and RNEA (τ = M a + b, the armature in M) on
    the armature Panda against MuJoCo's ``mj_fullM`` and ``mj_inverse``
    on the text ``model_to_mjcf`` writes (where MuJoCo imports)."""
    mujoco = pytest.importorskip("mujoco")
    path = _write(tmp_path, "panda.xml", texport.model_to_mjcf(
        panda_reach.armature_panda(device="cpu")))
    tm, _ = trobots.make_panda_real(path, device="cpu")
    mj = mujoco.MjModel.from_xml_path(path)
    d = mujoco.MjData(mj)
    rng = np.random.default_rng(3)
    for _ in range(3):
        q, v, a = (rng.standard_normal(7) for _ in range(3))
        d.qpos[:], d.qvel[:], d.qacc[:] = q, v, a
        mujoco.mj_inverse(mj, d)
        M = np.zeros((7, 7))
        mujoco.mj_fullM(mj, d, M)
        tq, tv, ta = (torch.tensor(x)[None] for x in (q, v, a))
        assert _rel(rbd.mass_matrix(tm, tq)[0], M) < 1e-10
        assert _rel(rbd.rnea(tm, tq, tv, ta)[0], d.qfrc_inverse) < 1e-10


# ---------------------------------------------------------------- the real models


def test_make_panda_real_and_the_reach_match_jax(tmp_path, monkeypatch):
    """``make_panda_real`` with its constant pointed at a written file reads
    the JAX package's model (the ``ee`` alias of ``attachment``, the
    ``elbow`` frame, the armature); ``create_panda_problem(real_model=True)``
    builds the reach on it, evaluated as the JAX package's reach on the same
    file (the fixture); with no file both packages take the nominal Panda."""
    path = str(tmp_path / "panda.xml")
    panda_reach.write_panda_mjcf(path)
    for absent in (True, False):
        target = str(tmp_path / "absent.xml") if absent else path
        monkeypatch.setattr(trobots, "PANDA_MJCF_PATH", target)
        monkeypatch.setattr(jrobots, "PANDA_MJCF_PATH", target)
        if absent:
            with pytest.raises(FileNotFoundError):
                trobots.make_panda_real(device="cpu")
            with pytest.raises(FileNotFoundError):
                jrobots.make_panda_real()
            jm = jrobots.make_panda()
        else:
            tm, ti = trobots.make_panda_real(device="cpu")
            jm, ji = jrobots.make_panda_real()
            _same_model(tm, jm)
            _same_info(ti, ji)
            assert tm.frame_names[-2:] == ("ee", "elbow")
        tprob = panda_reach.create_panda_problem(nsteps=TOOL.EVAL_N, device="cpu")
        tm = tprob.stages.dynamics.ode.model
        assert (tm.armature is None) == absent
        _same_model(tm, jm)
    ref = _fixture("eval_")
    dt = tproblem.evaluate(tprob, torch.tensor(ref["xs"])[None], torch.tensor(ref["us"])[None])
    for k in ("stage_costs", "dyn_res", "cstr_vals", "term_cost"):
        assert _rel(getattr(dt, k)[0], ref[k]) <= 1e-12, k


def test_ffsr_mjcf_branch_matches_jax(tmp_path, monkeypatch):
    """``load_ffsr_model()`` where the file exists (the fixture tool's
    stand-in for the fork's file): the free-flyer root, the ``object`` body
    skipped, tools ``grip1``/``grip2``, |τ| <= 500, the JAX package's
    model; the reach built on it with the JAX example's targets (the
    fixture) and torque box."""
    text = TOOL.ffsr_mjcf_text()
    tm0 = trobots.make_dual_arm_ffsr(device="cpu")
    names = tuple({"arm1_tool": "grip1", "arm2_tool": "grip2"}.get(n, n)
                  for n in tm0.frame_names)
    arm = torch.cat([torch.zeros(6, dtype=torch.float64), torch.full((14,), 10.0)])
    port_text = texport.model_to_mjcf(dataclasses.replace(
        tm0, frame_names=names, armature=arm), name="ffsr")
    assert text.split('    <body name="object"')[0] == port_text.split("  </worldbody>")[0]
    path = _write(tmp_path, "ffsr.xml", text)
    from examples import dual_ffsr_reach as jffsr

    monkeypatch.setattr(dual_ffsr_reach, "FFSR_MJCF", path)
    monkeypatch.setattr(jffsr, "FFSR_MJCF", path)
    tm, tools, u_max = dual_ffsr_reach.load_ffsr_model(device="cpu")
    jm, jtools, ju = jffsr.load_ffsr_model()
    _same_model(tm, jm)
    assert tools == jtools == ("grip1", "grip2") and list(u_max) == ju
    assert "object" not in tm.frame_names and tm.nv == 20
    assert torch.equal(tm.armature[6:], torch.full((14,), 10.0, dtype=torch.float64))
    tprob = dual_ffsr_reach.create_ffsr_problem(nsteps=2, device="cpu")
    ref = _fixture("ffsr_")
    targets = dual_ffsr_reach.reach_targets(tm, tools)
    for name in tools:
        for k, g in zip("Rp", targets[name]):
            assert _rel(g, ref[f"{k}_{name}"]) <= 1e-12, name
    box = tprob.stages.constraints[0][1]
    assert torch.equal(box.upper, torch.full((14,), 500.0, dtype=torch.float64))
    assert tprob.stages.dynamics.ode.model.frame_names == tm.frame_names


# ---------------------------------------------------------------- the ingested reach


def test_panda_mjcf_text_is_the_fixtures():
    """The port writes the text the fixture's JAX solves read."""
    assert texport.model_to_mjcf(panda_reach.armature_panda(device="cpu"), name="panda") == \
        str(_fixture()["mjcf_text"])


def _ingested_problem(tmp_path, monkeypatch, x0s):
    path = _write(tmp_path, "panda.xml", str(_fixture()["mjcf_text"]))
    monkeypatch.setattr(trobots, "PANDA_MJCF_PATH", path)
    prob = panda_reach.create_panda_problem(real_model=True, device="cpu")
    return dataclasses.replace(prob, x0=torch.tensor(x0s))


def test_ingested_panda_reach_matches_the_fixture(tmp_path, monkeypatch):
    """The reach on the Panda read back from MJCF, its first 2 starts over
    4 iterations against the JAX package's solves (the fixture): the
    iterate within 1e-9 or 100 times the distance between the port's solves
    from x0 and from x0·(1 ± 1e-15), whichever is larger (these solves
    magnify rounding)."""
    ref = _fixture()
    n, k = len(ref["small_x0s"]), int(ref["small_iters"])
    np.testing.assert_array_equal(ref["small_x0s"], panda_reach.initial_states(n, 0))
    x0 = ref["small_x0s"]
    prob = _ingested_problem(tmp_path, monkeypatch, np.concatenate(
        [x0, x0 * (1 + SPREAD_EPS), x0 * (1 - SPREAD_EPS)]))
    cfg = at.solvers.ProxDDPConfig(**{**panda_reach.SOLVE_OPTIONS, "max_iters": k})
    res = at.solvers.solve(prob, cfg)
    assert res.num_iters[:n].tolist() == ref["small_num_iters"].tolist()
    spread = max(_rel(getattr(res, f)[s], getattr(res, f)[:n]) for f in ("xs", "us")
                 for s in (slice(n, 2 * n), slice(2 * n, 3 * n)))
    tol = max(SOLVE_TOL, SPREAD_FACTOR * spread)
    for f in ("xs", "us"):
        assert _rel(getattr(res, f)[:n], ref[f"small_{f}"]) <= tol, (f, spread)


@pytest.mark.slow
def test_fixture_matches_a_live_jax_solve(tmp_path):
    """The fixture's text, references and small group recomputed live by
    the JAX package."""
    ref = _fixture()
    assert TOOL.mjcf_text() == str(ref["mjcf_text"])
    path = _write(tmp_path, "panda.xml", TOOL.mjcf_text())
    live = {**TOOL.armature_refs(), **TOOL.eval_refs(path), **TOOL.ffsr_refs(str(tmp_path))}
    for k, v in live.items():
        assert _rel(np.asarray(v), ref[k]) <= 1e-12, k
    for i in range(len(ref["small_x0s"])):
        out = TOOL.solve_one(path, "small", i)
        for k, v in out.items():
            assert _rel(np.asarray(v), ref[f"small_{k}"][i]) <= 1e-12, k
