"""Compare K2 (``csrc/spd_solve.cu``) and K3 (``csrc/fused_stage.cu``
``sweep_kernel``) between source trees of the port on the card, in one call.

    python tools/torch_k2_k3_compare.py TREE [TREE ...]

Each TREE is the root of a checkout (e.g. the parent commit unpacked with
``git archive`` into a directory ``.gitignore`` lists, and ``.``); name the
trees in an order that alternates them (``_parent . . _parent``). This
tree draws the inputs once: K3's nearly singular reduced KKT systems
(``chip_smoke.K3_COND_DIMS``, 4 null controls in a rotated basis, fp32 at μ
= 1e-4, 1e-5 and 1e-6, fp64 at 1e-8) and K2's systems of condition 1e5
(fp32) and 1e10 (fp64). Each tree then runs in a process of its own,
building and launching its own kernels: its sweeps and solves of those
inputs and the kernel times of K3 at the humanoid shape (fp32, fp64) and
of K2 at the shapes the paths launch. This tree's code scores every result
the same way: the scenarios with a non-finite gain, and over the rest the
largest backward errors beside the plain version's (``fused_stage.
stage_backward_errors``, ``chip_smoke.spd_backward_errors``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
K3_CASES = ((torch.float32, 1e-4), (torch.float32, 1e-5), (torch.float32, 1e-6),
            (torch.float64, 1e-8))
K2_CASES = ((256, 56, 57, 1e-5, torch.float32), (256, 22, 57, 1e-5, torch.float32),
            (4096, 12, 42, 1e-5, torch.float32), (256, 64, 65, 1e-5, torch.float32),
            (4096, 12, 42, 1e-10, torch.float64))


def child(tree, work):
    """In ``tree``'s own package: the sweeps and solves of the inputs in
    ``work``, saved there, and the kernel times, printed as one line."""
    tree = str(pathlib.Path(tree).resolve())
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from aligator_tpu_torch.gar import fused_stage as fs
    from aligator_tpu_torch.gar import spd_solve as sp
    from aligator_tpu_torch.gar.lqr_problem import LQRKnots

    out = {"k3": [], "k2": []}
    for i in range(len(K3_CASES)):
        d = torch.load(work / f"k3_{i}.pt")
        kn = LQRKnots(**{k: v.cuda() for k, v in d["knots"].items()})
        args = (kn, d["P"].cuda(), d["p"].cuda(), d["mu"].cuda(), d["mu"].cuda())
        out["k3"].append({name: {k: v.cpu() for k, v in fn(*args).items()}
                          for name, fn in (("kernel", fs.sweep), ("plain", fs.sweep_plain))})
    for i in range(len(K2_CASES)):
        d = torch.load(work / f"k2_{i}.pt")
        A, R = d["A"].cuda(), d["R"].cuda()
        out["k2"].append({"kernel": sp.spd_solve(A, R).cpu(), "plain": sp.spd_solve_plain(A, R).cpu()})
    torch.save(out, work / f"out_{os.getpid()}.pt")

    times = {}
    B, N, nx, nu, nc = cs.HUMANOID_BATCH, cs.MEDIUM_NSTEPS, 36, 12, 12
    for dt in (torch.float32, torch.float64):
        kn, P, p, md, me = cs.convex_knots(B, N, nx, nu, nc, dt, cs.SEED + 20)
        times[f"K3 {str(dt)[6:]} ({B}, {N}, {nx}, {nu}, {nc})"] = cs.kernel_ms(
            lambda: fs.sweep(kn, P, p, md, me), 5, "sweep_kernel")
        del kn, P, p, md, me
    f32, f64 = torch.float32, torch.float64
    n_walk = 2 * cs.TALOS_T_SS + 3 * cs.TALOS_T_DS
    K_ur, K_solo = cs.UR10_BATCH * cs.UR10_NSTEPS, cs.SOLO_BATCH * sum(cs.SOLO_PHASES)
    shapes = [(M, n, 57, f32) for M in (cs.LQR_BATCH, cs.TALOS_BATCHES[0]) for n in (56, 22)]
    shapes += [(b * n_walk, n, 84, f32) for b in cs.TALOS_BATCHES for n in (28, 12)]
    shapes += [(cs.HUMANOID_BATCH, n, 73, f32) for n in (36, 12)]
    shapes += [(cs.FREE_BATCHES["ur5"], n, 13, f64) for n in (12, 6)]
    shapes += [(cs.FREE_BATCHES["ffsr"], n, 41, f64) for n in (40, 14)]
    shapes += [(K_ur, 12, 7, f64), (K_ur, 6, 1, f64), (K_ur, 12, 210, f64), (K_ur, 6, 30, f64)]
    shapes += [(cs.UR10_BATCH, n, 25, f64) for n in (24, 6)]
    shapes += [(K_solo, n, 42, f64) for n in (14, 12)]
    shapes += [(cs.SOLO_BATCH, n, 29, f64) for n in (28, 8)]
    for i, (M, n, r, dt) in enumerate(shapes):
        A, R = cs.spd_batch(M, n, r, dt, cs.SEED + 10 + i)
        times[f"K2 {str(dt)[6:]} ({M}, {n}, {r})"] = cs.kernel_ms(
            lambda: sp.launch(A, R), 200 if M <= 512 else 50, "spd_solve_kernel")
        del A, R
    print("RESULT " + json.dumps({"pid": os.getpid(), "times": times}), flush=True)


def main(trees):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from aligator_tpu_torch.gar import fused_stage as fs
    from aligator_tpu_torch.gar import lqr_problem

    print(cs.device_phase(), flush=True)
    work = ROOT / "aligator_tpu_torch" / "_build" / "compare"
    work.mkdir(parents=True, exist_ok=True)
    B, N, nx, nu, nc = cs.K3_COND_DIMS
    k3_inputs = []
    for i, (dtype, mu) in enumerate(K3_CASES):
        kn = lqr_problem.random_convex_problem(
            np.random.default_rng(cs.SEED + 97), B, N, nx, nu, nc, dtype=dtype,
            device="cpu", null_controls=4).knots
        d = dict(knots={f.name: getattr(kn, f.name) for f in dataclasses.fields(kn)
                        if getattr(kn, f.name) is not None},
                 P=kn.Q[:, N].contiguous(), p=kn.q[:, N].contiguous(),
                 mu=torch.full((B,), mu, dtype=dtype))
        torch.save(d, work / f"k3_{i}.pt")
        k3_inputs.append((kn, d))
    k2_inputs = []
    for i, (M, n, r, lam, dtype) in enumerate(K2_CASES):
        A, R = cs.conditioned_spd(M, n, r, lam, cs.SEED + 94 + i)
        A, R = A.to(dtype).cpu(), R.to(dtype).cpu()
        torch.save(dict(A=A, R=R), work / f"k2_{i}.pt")
        k2_inputs.append((A, R))

    summary = []
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--child", tree, str(work)],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(f"[compare] {tree}: failed (rc {proc.returncode})\n{proc.stdout[-3000:]}"
                  f"\n{proc.stderr[-3000:]}", flush=True)
            return 1
        res = json.loads(lines[-1][len("RESULT "):])
        out = torch.load(work / f"out_{res['pid']}.pt")
        row = {"tree": tree, "times": res["times"], "k3": {}, "k2": {}}
        for (dtype, mu), (kn, d), got in zip(K3_CASES, k3_inputs, out["k3"]):
            knc = kn.map(torch.Tensor.cuda)
            args = (knc, d["P"].cuda(), d["p"].cuda(), d["mu"].cuda(), d["mu"].cuda())
            case = {}
            for name in ("kernel", "plain"):
                o = {k: v.cuda() for k, v in got[name].items()}
                ok = torch.isfinite(o["kff"].flatten(1)).all(1) & torch.isfinite(
                    o["K"].flatten(1)).all(1)
                eb = fs.stage_backward_errors(*args, o)
                case[name] = dict(non_finite=int((~ok).sum()), **{
                    k: float(v[ok].max()) if bool(ok.any()) else None for k, v in eb.items()})
            row["k3"][f"{str(dtype)[6:]} mu={mu:g}"] = case
        for (M, n, r, lam, dtype), (A, R), got in zip(K2_CASES, k2_inputs, out["k2"]):
            row["k2"][f"{str(dtype)[6:]} ({M}, {n}, {r}) condition {1 / lam:g}"] = {
                name: float(cs.spd_backward_errors(A.cuda(), got[name].cuda(), R.cuda()).max())
                for name in ("kernel", "plain")}
        print("[compare] " + json.dumps(row), flush=True)
        summary.append(row)
    print("[compare] times by tree, ms (NVIDIA card as above):")
    for key in summary[0]["times"]:
        print(f"  {key}: " + ", ".join(f"{r['tree']} {r['times'][key]:.4f}" for r in summary))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        child(sys.argv[2], pathlib.Path(sys.argv[3]))
    elif len(sys.argv) >= 2:
        sys.exit(main(sys.argv[1:]))
    else:
        sys.exit(__doc__)
