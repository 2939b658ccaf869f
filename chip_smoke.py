#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (aligator_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order;
any failed check raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels of ``aligator_tpu_torch/csrc`` with nvcc;
3. kernels: each kernel held against its plain PyTorch version on the card,
   at the main path's shape (fp32) and at the test shapes (fp64), and timed
   beside its memory/compute bound;
4. the main path: batched SE(2)-car ProxDDP (N=50, batch 32768, fp32, the
   ``bench.py`` configuration) on the card, with the kernels' launch counts
   read around it, the converged fraction, solves/s, a device-time
   breakdown, and the first 256 scenarios solved again on the CPU;
5. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line last.

Without a CUDA device it exits non-zero before printing any result.
"""

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores

BATCH = 32768
NSTEPS = 50
SEED = 0
# max|kernel - plain| / max(1, max|plain|), float32: the plain version's own
# float32 error against float64 reaches 1e-4 on the multipliers at
# mu_dyn = 1e-4 (cancellation in lam0 = (g0 + G0 x0)/mu_dyn), so two float32
# evaluations in different orders may differ by twice that
FP32_TOL = 5e-4
FP64_TOL = 1e-9  # the same, float64
CPU_CHECK_SCENARIOS = 256
CPU_TRAJ_TOL = 1e-3  # fp32 card vs fp32 CPU solve, max abs over xs and us
MIN_FRAC_CONVERGED = 0.99


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- phase 1


def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


# ---------------------------------------------------------------- phase 2


def build_phase():
    from aligator_tpu_torch import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(names)
    dt = time.perf_counter() - t0
    print(f"[build] {names} in {dt:.1f} s")
    for name in names:
        log = _build.BUILD_LOG[name][1]
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    return dt


# ---------------------------------------------------------------- phase 3


def cast(problem, dtype):
    """The LQ problems with every tensor cast to ``dtype``."""
    from aligator_tpu_torch.gar.lqr_problem import LQRKnots, LQRProblem

    kn = problem.knots
    knots = LQRKnots(**{f.name: getattr(kn, f.name).to(dtype)
                        for f in dataclasses.fields(kn)})
    return LQRProblem(knots=knots, G0=problem.G0.to(dtype), g0=problem.g0.to(dtype))


def abs_err(got, ref):
    return (got - ref).abs().max().item() if ref.numel() else 0.0


def rel_err(got, ref):
    if ref.numel() == 0:
        return 0.0
    return abs_err(got, ref) / max(1.0, ref.abs().max().item())


def cuda_time_ms(fn, reps):
    """Median device time of ``fn`` over ``reps`` calls, CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_flops_per_stage(nx, nu, nc, explicit):
    """Approximate flop count of one backward stage plus its forward step."""
    n, m, c = nx, nu, nc
    f = 0
    if not explicit:
        f += 4 * n ** 3 + 4 * n ** 3 + 2 * n ** 2  # Gauss-Jordan, Ptilde, ptilde
        f += 2 * n ** 2 + 2 * n ** 3  # yff, Afb
    f += n ** 2 + n ** 3 // 3 + 2 * n ** 2 + (n + 1) * 2 * n ** 2  # Schur solve
    f += 2 * n ** 3 + 2 * m * n ** 2 + 2 * n ** 3 + 2 * m * m * n + 2 * m * n ** 2
    f += 2 * n ** 2 + 2 * m * n  # qhat, rhat
    f += m * m * (1 + 3 * c) + m ** 3 // 3 + m * (1 + 3 * c) + 2 * m * m
    f += n * (m * (1 + 3 * c) + 2 * m * m) + c * (2 * m + 1) * (n + 1)
    f += 2 * n * m + 2 * n ** 2 + 2 * n * n * m + 2 * n ** 3 + 3 * n + 2 * n ** 2
    f += (n * n + n) * (2 * m + 2 * c + 1) + n * n
    f += 2 * m * n + 2 * c * n + 4 * n ** 2  # forward step
    return f


def kernel_phase():
    from aligator_tpu_torch.gar import fused_riccati as fr
    from aligator_tpu_torch.gar.lqr_problem import random_convex_problem

    rng = np.random.default_rng(SEED)
    # the test shapes, fp64, odd batch for the ragged last block
    for (nx, nu, nc, expl) in sorted(fr.KERNEL_SHAPES):
        B, T = 1000, 11
        prob = random_convex_problem(rng, B, T - 1, nx, nu, nc, not expl,
                                     torch.float64, "cuda")
        mud = torch.tensor(10 ** rng.uniform(-3, -1, B), device="cuda")
        mue = torch.tensor(10 ** rng.uniform(-3, -1, B), device="cuda")
        got = fr.solve(prob, mud, mue, expl)
        ref = fr.solve_plain(prob, mud, mue, expl)
        torch.cuda.synchronize()
        errs = _compare(got, ref)
        worst = max(errs.values())
        print(f"[kernel] fused_riccati fp64 (nx,nu,nc,explicit)={(nx, nu, nc, expl)} "
              f"B={B} T={T}: max rel err {worst:.3e} (tol {FP64_TOL:g})")
        check(worst <= FP64_TOL, f"fp64 kernel vs plain {errs}")

    # the main path's shape: SE(2) car LQ subproblem, fp32, general E
    nx, nu, nc, expl = 3, 2, 0, False
    T, B = NSTEPS + 1, BATCH
    p64 = random_convex_problem(rng, B, T - 1, nx, nu, nc, True, torch.float64,
                                "cuda")
    prob = cast(p64, torch.float32)
    mud = torch.tensor(10 ** rng.uniform(-4, -1, B), dtype=torch.float32, device="cuda")
    mue = torch.tensor(10 ** rng.uniform(-4, -1, B), dtype=torch.float32, device="cuda")
    got = fr.solve(prob, mud, mue, expl)
    ref = fr.solve_plain(prob, mud, mue, expl)
    torch.cuda.synchronize()
    errs = _compare(got, ref)
    worst = max(errs.values())
    print("[kernel] fused_riccati fp32 se2car shape B=%d T=%d rel errs %s" % (
        B, T, {k: f"{v:.2e}" for k, v in errs.items()}))
    # context: both float32 results against the float64 plain solve on the
    # same (float32-rounded) data
    p64 = cast(prob, torch.float64)
    ref64 = fr.solve_plain(p64, mud.double(), mue.double(), expl)
    for name, res32 in (("kernel", got), ("plain", ref)):
        e = _compare(_to64(res32), ref64)
        print(f"[kernel] fused_riccati fp32 {name} vs fp64 plain: max rel err "
              f"{max(e.values()):.2e} ({max(e, key=e.get)})")
    del p64, ref64
    check(all(math.isfinite(v) for v in errs.values()), "non-finite kernel output")
    check(worst <= FP32_TOL, f"fp32 kernel vs plain: {worst:.3e} > {FP32_TOL}")
    max_abs = max(_compare(got, ref, abs_err).values())

    packed = fr.pack(prob, mud, mue, expl)
    out, gains = fr.launch(*packed, prob, expl)
    pack_ms = cuda_time_ms(lambda: fr.pack(prob, mud, mue, expl), 20)
    kernel_ms = cuda_time_ms(lambda: fr.launch(*packed, prob, expl), 25)
    unpack_ms = cuda_time_ms(
        lambda: [t.contiguous() for t in fr.unpack(prob, out, gains)[:4]], 20
    )
    plain_ms = cuda_time_ms(lambda: fr.solve_plain(prob, mud, mue, expl), 5)

    F = fr.field_layout(nx, nu, nc, expl)[1]
    G = fr.gain_layout(nx, nu, nc)[1]
    OF = fr.out_layout(nx, nu, nc)[1]
    nbytes = B * 4 * (T * F + nx * nx + nx + 2 + T * G + T * OF)
    flops = B * T * k1_flops_per_stage(nx, nu, nc, expl)
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP32_FLOP_PER_S * 1e3
    print(f"[kernel] fused_riccati fp32 B={B} T={T}: kernel {kernel_ms:.4f} ms, "
          f"pack {pack_ms:.4f} ms, unpack(xs,us,vs,lams) {unpack_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms; bound {max(bytes_ms, ops_ms):.4f} ms "
          f"(bytes {nbytes / 1e9:.3f} GB -> {bytes_ms:.4f} ms, "
          f"~{flops / 1e9:.2f} GFLOP -> {ops_ms:.4f} ms)")
    return dict(
        name="fused_riccati", route="cuda",
        source="aligator_tpu_torch/csrc/fused_riccati.cu",
        replaces="aligator_tpu/gar/pallas_riccati.py:171",
        max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None,
    ), dict(pack_ms=pack_ms, unpack_ms=unpack_ms)


def _to64(res):
    return (*(t.double() for t in res[:4]), {k: v.double() for k, v in res[4].items()})


def _compare(got, ref, err=rel_err):
    names = ("xs", "us", "vs", "lams")
    errs = {n: err(g, r) for n, g, r in zip(names, got[:4], ref[:4])}
    errs.update({k: err(got[4][k], ref[4][k]) for k in ref[4]})
    return errs


# ---------------------------------------------------------------- phase 4


def bench_x0s(batch):
    """Randomized parking scenarios around the nominal initial state, drawn
    as bench.py draws them (numpy in place of jax.random)."""
    rng = np.random.default_rng(SEED)
    d_p = 0.2 * rng.standard_normal((batch, 2))
    d_th = 0.2 * rng.standard_normal(batch)
    th = 0.15355 + d_th
    return np.stack(
        [0.7 + d_p[:, 0], -0.1 + d_p[:, 1], np.cos(th), np.sin(th)], -1
    ).astype(np.float32)


def slice_phase(kernel_names):
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples.se2_car import create_se2_problem
    from aligator_tpu_torch.gar import fused_riccati

    cfg = at.solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4, rollout="linear",
        ls_max_steps=6, ls_strategy="filter",
    )
    x0s = bench_x0s(BATCH)
    problem = create_se2_problem(nsteps=NSTEPS, dtype=torch.float32, device="cuda")
    problem = dataclasses.replace(problem, x0=torch.tensor(x0s, device="cuda"))

    # the counted run: launch counts read just around the main path
    fused_riccati.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = at.solvers.solve(problem, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"fused_riccati": fused_riccati.LAUNCHES}
    steps = int(res.newton_steps.max().item())
    print(f"[slice] first solve {first_s:.3f} s, launches {launches}, "
          f"iterations with a Newton step {steps}")
    for name in kernel_names:
        check(launches[name] >= 1, f"kernel {name} was not launched on the main path")
    check(launches["fused_riccati"] == steps,
          "fused_riccati launches differ from the Newton iterations")
    check(1 <= steps <= cfg.max_iters, f"Newton iterations {steps}")

    finite = torch.isfinite(res.us).flatten(1).all(1) & torch.isfinite(res.xs).flatten(1).all(1)
    conv = finite & (res.prim_infeas <= cfg.tol) & (res.dual_infeas <= cfg.tol)
    frac = conv.float().mean().item()
    check(bool(finite.all()), "non-finite solutions")
    print(f"[slice] frac_converged {frac:.6f}; num_iters histogram "
          f"{torch.bincount(res.num_iters.long()).tolist()}; "
          f"max prim {res.prim_infeas.max().item():.3e} "
          f"max dual {res.dual_infeas.max().item():.3e}")
    check(frac >= MIN_FRAC_CONVERGED, f"frac_converged {frac} < {MIN_FRAC_CONVERGED}")

    # solves/s as bench.py counts it: median of timed batches after one
    # warm-up, each ended by a host readback
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        r = at.solvers.solve(problem, cfg)
        float(r.us.sum() + r.prim_infeas.sum() + r.dual_infeas.sum())
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"[slice] batch times (s) {[round(t, 4) for t in times]}; "
          f"median {med:.4f} s -> {BATCH / med:.1f} solves/s")

    breakdown = profile_solve(problem, cfg)

    # the first scenarios again on the CPU, plain path
    n = CPU_CHECK_SCENARIOS
    cpu_problem = create_se2_problem(nsteps=NSTEPS, dtype=torch.float32, device="cpu")
    cpu_problem = dataclasses.replace(cpu_problem, x0=torch.tensor(x0s[:n]))
    t0 = time.perf_counter()
    rc = at.solvers.solve(cpu_problem, cfg)
    cpu_s = time.perf_counter() - t0
    same_iters = bool((rc.num_iters == res.num_iters[:n].cpu()).all())
    same_conv = bool((rc.conv == res.conv[:n].cpu()).all())
    dx = (rc.xs - res.xs[:n].cpu()).abs().max().item()
    du = (rc.us - res.us[:n].cpu()).abs().max().item()
    print(f"[slice] cpu check ({n} scenarios, {cpu_s:.1f} s): num_iters equal "
          f"{same_iters}, conv equal {same_conv}, max|dxs| {dx:.3e}, "
          f"max|dus| {du:.3e} (tol {CPU_TRAJ_TOL:g})")
    check(same_iters and same_conv, "card and CPU iteration counts differ")
    check(max(dx, du) <= CPU_TRAJ_TOL, "card and CPU trajectories differ")
    return launches, dict(frac_converged=frac, solves_per_sec=BATCH / med,
                          batch_s=med, breakdown=breakdown)


def profile_solve(problem, cfg):
    """Device time by kernel over one solve (torch.profiler), and the share
    of the solve's wall time the device was busy."""
    import aligator_tpu_torch as at
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        at.solvers.solve(problem, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops; their device time is their kernels'
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"[profile] one solve: wall {wall_ms:.1f} ms (profiled), device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(r[1] for r in rows)} kernel launches")
    for ms, count, key in rows[:12]:
        print(f"[profile]   {ms:9.3f} ms {count:6d}x  {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                top=[(round(ms, 3), c, k[:60]) for ms, c, k in rows[:5]])


# ---------------------------------------------------------------- main


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    import aligator_tpu_torch  # noqa: F401  (fails outside the repository)

    smi = device_phase()
    build_phase()
    kernel, layout_times = kernel_phase()
    launches, result = slice_phase(["fused_riccati"])
    kernel["launches"] = launches[kernel["name"]]
    print(json.dumps({"slice": result, "fused_riccati_layout": layout_times,
                      "card": smi}))
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
