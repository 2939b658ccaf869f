#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (aligator_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order;
any failed check raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels of ``aligator_tpu_torch/csrc`` with nvcc, one
   process per source, in parallel;
3. kernels: each kernel (K1 fused Riccati, K2 SPD solve, K3 fused backward
   sweep, K4 forward substitution, K5 contact-dynamics derivative rows) held
   against its plain PyTorch version on the card, at the main paths' shapes
   (fp32) and at the test shapes (fp64), and timed beside its memory/compute
   bound and, where one PyTorch call computes the same function, that call;
   K3 and K4 also print their shared memory, registers and resident blocks
   per SM at the main shapes, and K3 its time at batches of 132 to 1024
   (1 to 7.8 scenarios for each of the 132 SMs);
4. the SE(2)-car path: batched ProxDDP (N=50, batch 32768, fp32, the
   ``bench.py`` configuration) on the card, with the plain versions patched
   to raise and the kernels' launch counts read around it, the converged
   fraction, solves/s, a device-time
   breakdown, and the first 256 scenarios solved again on the CPU;
5. the medium-dim paths, fp32 at the bench configurations: humanoid-dims
   ProxDDP (nx=36, N=100, batch 1024; K3 and K4), dense LQR-56 ProxDDP
   (batch 256; K2 and K4) and LQR-56 FDDP (K2). Each runs with the plain
   versions patched to raise, its launch counts read around it and checked
   against the route, then prints its converged fraction and solves/s and
   solves its first 16 scenarios again on the CPU;
6. the whole-body Talos-walk path (``bench_talos.py`` protocol: N=32, fp32,
   ProxDDP 4x4 budget; K5, K2 and K4) at batch 16 and 256, with the plain
   versions patched to raise, launch counts checked per Newton step, solves/s
   and a breakdown; then 2 scenarios solved on the card and again on the
   CPU in fp64 and checked, and 2 scenarios solved on the card in fp32 step
   by step against the JAX package's fp32 solve of them (a committed
   reference: which Newton steps are rejected, infeasibilities per step);
7. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line last.

Without a CUDA device it exits non-zero before printing any result.
"""

import contextlib
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

# medium-dim paths (bench.py:156-213, bench_lqr.py:22-81)
HUMANOID_BATCH = 1024
LQR_BATCH = 256
MEDIUM_NSTEPS = 100
MEDIUM_CPU_SCENARIOS = 16
# fp32 card vs fp32 CPU solve of the same scenarios, max |Δ| over xs and us
# relative to max(1, max |xs|, max |us|): the K3/K2 sums run in another order
# than the CPU's, over 100 stages and up to 4 Newton steps
MEDIUM_CPU_TRAJ_TOL = 1e-3
# kernel vs plain version, max error relative to max(1, output scale)
K2_FP32_TOL = 1e-4  # well-conditioned SPD systems (eigenvalues >= 1)
# K3/K4 at the main shapes with random convex knots over 100 stages and
# mu_eq down to 1e-3: both float32 results are compared with the float64
# plain sweep for context
K3_FP32_TOL = 1e-3
K4_FP32_TOL = 1e-4
K5_FP32_TOL = 1e-3

# whole-body path (bench_talos.py:43-89)
TALOS_T_DS, TALOS_T_SS = 4, 10  # N = 32
TALOS_BATCHES = (16, 256)
TALOS_CPU_SCENARIOS = 2
# card vs CPU, both float64, max |Δ| over xs and us relative to their scale.
# In float32 the reduced KKT of a Newton step can come out indefinite (its
# condition number is above 1/eps of float32), so which step is rejected
# depends on the order of the sums: the card's float32 solve is held
# against the JAX package's float32 solve instead, step by step, its
# infeasibilities within this relative error
TALOS_CPU_TRAJ_TOL = 1e-6
TALOS_FP32_TOL = 1e-4


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


def avg_time_ms(fn, reps):
    """Mean device time per call of ``fn`` over ``reps`` back-to-back calls,
    CUDA events (host overhead shows where it starves the device)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps, kernel_name):
    """Device time per launch of the CUDA kernel named ``kernel_name`` over
    ``reps`` calls of ``fn`` (torch.profiler): the kernel alone, without
    the wrapper's host time, averaged over the launches the profiler
    recorded. The profiler's activity buffer can drop a record now and
    then, so up to a tenth of the launches may be missing; more than
    ``reps`` means the name matched another kernel. Falls back to CUDA
    events over the whole call if the profiler records no device time
    for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and kernel_name in ev.key:
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            total_us += dev_us
            count += ev.count
    if count == 0 or total_us == 0:
        print(f"[kernel] profiler saw no {kernel_name}: timing whole calls")
        return avg_time_ms(fn, reps)
    check(reps - max(1, reps // 10) <= count <= reps,
          f"{kernel_name}: {count} launches profiled, {reps} made")
    if count < reps:
        print(f"[kernel] {kernel_name}: the profiler recorded {count} of {reps} "
              "launches; time averaged over those")
    return total_us / count / 1e3


def bound(nbytes, flops):
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def spd_batch(M, n, r, dtype, seed):
    """SPD systems A = G G'/n + I and right-hand sides, drawn on the card."""
    g = _gen(seed)
    G = torch.randn((M, n, n), generator=g, device="cuda", dtype=torch.float64)
    A = G @ G.mT / n + torch.eye(n, device="cuda", dtype=torch.float64)
    R = torch.randn((M, n, r), generator=g, device="cuda", dtype=torch.float64)
    return A.to(dtype), R.to(dtype)


def convex_knots(B, N, nx, nu, nc, dtype, seed):
    """Random convex LQ knots with the law of
    ``lqr_problem.random_convex_problem`` (E = -I), drawn on the card (the
    main shapes are too large to draw on the host quickly), plus a random
    SPD terminal value and per-scenario mu (mu_eq log-uniform in [1e-3,
    1e-1], mu_dyn = 1e-3 mu_eq as the solver scales it)."""
    from aligator_tpu_torch.gar.lqr_problem import LQRKnots

    g = _gen(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)

    T, n = N + 1, nx + nu
    root = randn(B, T, n, n + 2)
    joint = root @ root.mT / (n + 2)
    del root
    eye = torch.eye(nx, device="cuda", dtype=torch.float64)
    a = dict(
        Q=joint[..., :nx, :nx], S=joint[..., :nx, nx:],
        R=joint[..., nx:, nx:] + 0.1 * torch.eye(nu, device="cuda", dtype=torch.float64),
        q=randn(B, T, nx), r=randn(B, T, nu), A=randn(B, T, nx, nx) / math.sqrt(nx),
        B=randn(B, T, nx, nu) / math.sqrt(nu), E=-eye.expand(B, T, nx, nx),
        f=0.1 * randn(B, T, nx), C=randn(B, T, nc, nx), D=randn(B, T, nc, nu),
        d=randn(B, T, nc),
    )
    kn = LQRKnots(**{k: v.to(dtype).contiguous() for k, v in a.items()})
    del a, joint
    G = randn(B, nx, nx)
    P = (G @ G.mT / nx + eye).to(dtype)
    p = randn(B, nx).to(dtype)
    mue = 10 ** (torch.rand(B, generator=g, device="cuda", dtype=torch.float64) * 2 - 3)
    return kn, P, p, (1e-3 * mue).to(dtype), mue.to(dtype)


def k2_phase():
    from aligator_tpu_torch.gar import spd_solve as sp

    for i, (n, r) in enumerate(((12, 1), (24, 13), (56, 57), (22, 57), (64, 64),
                                (28, 84), (12, 84), (64, 128))):
        A, R = spd_batch(130, n, r, torch.float64, SEED + i)
        err = rel_err(sp.spd_solve(A, R), sp.spd_solve_plain(A, R))
        print(f"[kernel] spd_solve fp64 M=130 n={n} r={r}: max rel err {err:.3e} "
              f"(tol {FP64_TOL:g})")
        check(err <= FP64_TOL, f"spd_solve fp64 n={n} r={r}: {err}")

    # the LQR-56 per-stage pair: the Schur solve and the reduced KKT
    tot = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0,
               flops=0.0, max_abs_err=0.0)
    for i, (M, n, r) in enumerate(((LQR_BATCH, 56, 57), (LQR_BATCH, 22, 57))):
        A, R = spd_batch(M, n, r, torch.float32, SEED + 10 + i)
        X = sp.spd_solve(A, R)
        ref = sp.spd_solve_plain(A, R)
        ref64 = sp.spd_solve_plain(A.double(), R.double())
        torch.cuda.synchronize()
        err = rel_err(X, ref)
        print(f"[kernel] spd_solve fp32 M={M} n={n} r={r}: vs plain {err:.2e} "
              f"(tol {K2_FP32_TOL:g}); vs fp64 plain: kernel "
              f"{rel_err(X.double(), ref64):.2e}, plain {rel_err(ref.double(), ref64):.2e}")
        check(torch.isfinite(X).all().item(), "non-finite spd_solve output")
        check(err <= K2_FP32_TOL, f"spd_solve fp32 n={n}: {err}")
        ms = kernel_ms(lambda: sp.launch(A, R), 200, "spd_solve_kernel")
        call_ms = avg_time_ms(lambda: sp.spd_solve(A, R), 200)
        plain_ms = avg_time_ms(lambda: sp.spd_solve_plain(A, R), 50)
        lib_ms = avg_time_ms(lambda: torch.linalg.solve(A, R), 50)
        nbytes = 4 * M * (n * n + 2 * n * r)
        flops = M * (n ** 3 / 3 + 2 * n * n * r)
        bms, by = bound(nbytes, flops)
        print(f"[kernel] spd_solve fp32 M={M} n={n} r={r}: kernel {ms:.4f} ms "
              f"(wrapper call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"torch.linalg.solve {lib_ms:.4f} ms; bound {bms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)")
        for k, v in (("ms", ms), ("call_ms", call_ms), ("plain_ms", plain_ms),
                     ("library_ms", lib_ms), ("nbytes", nbytes), ("flops", flops)):
            tot[k] += v
        tot["max_abs_err"] = max(tot["max_abs_err"], abs_err(X, ref))
    bms, by = bound(tot["nbytes"], tot["flops"])
    print(f"[kernel] spd_solve, one LQR-56 stage (both solves): kernel "
          f"{tot['ms']:.4f} ms, bound {bms:.4f} ms ({by})")
    contact = {}
    M = TALOS_BATCHES[0] * (2 * TALOS_T_SS + 3 * TALOS_T_DS)  # K = B N
    for i, (n, r) in enumerate(((28, 84), (12, 84))):
        A, R = spd_batch(M, n, r, torch.float32, SEED + 30 + i)
        X = sp.spd_solve(A, R)
        ref = sp.spd_solve_plain(A, R)
        err = rel_err(X, ref)
        check(err <= K2_FP32_TOL, f"spd_solve fp32 n={n} r={r}: {err}")
        ms = kernel_ms(lambda: sp.launch(A, R), 100, "spd_solve_kernel")
        plain_ms = avg_time_ms(lambda: sp.spd_solve_plain(A, R), 20)
        lib_ms = avg_time_ms(lambda: torch.linalg.solve(A, R), 20)
        nbytes = 4 * M * (n * n + 2 * n * r)
        bms_c, by_c = bound(nbytes, M * (n ** 3 / 3 + 2 * n * n * r))
        print(f"[kernel] spd_solve fp32 contact KKT M={M} n={n} r={r}: vs plain "
              f"{err:.2e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.linalg.solve {lib_ms:.4f} ms; bound {bms_c:.4f} ms ({by_c})")
        contact[f"n={n} r={r}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                       bound_ms=bms_c, max_abs_err=abs_err(X, ref))
    return dict(
        name="spd_solve", route="cuda", source="aligator_tpu_torch/csrc/spd_solve.cu",
        replaces="aligator_tpu/gar/pallas_spd.py:33", max_abs_err=tot["max_abs_err"],
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bms, bound_by=by,
        library_ms=tot["library_ms"],
    ), dict(wrapper_call_ms=tot["call_ms"], contact_kkt=contact)


def k3_flops_per_stage(n, m, c):
    """Flops of one K3 stage per scenario, counted from the kernel's loops
    (a multiply-add is 2)."""
    n1 = n + 1
    return (n ** 3 / 3 + 2 * n * n * n1  # Schur factor and solve
            + 2 * n * n * n1 + 2 * n * m * n1  # [A'V | A'vx], [B'V | B'vx]
            + 2 * n ** 3 + 2 * n * n * m  # Qhat, Shat
            + 2 * m * m * (n + c) + 2 * m * n * (n + c + 1)  # reduced KKT
            + m ** 3 / 3 + 2 * m * m * n1  # its factor and solve
            + 2 * c * m * n1 + 2 * n * m * n1 + 2 * n * n * n1  # Z, panels
            + 2 * n * n1 * (m + c)  # value update
            + 2 * n ** 3 + 6 * n * n)  # L, Afb, lff, yff


def k3_phase():
    from aligator_tpu_torch.gar import fused_stage as fs

    for i, (N, nx, nu, nc) in enumerate(((6, 13, 4, 3), (4, 16, 5, 0),
                                         (5, 36, 12, 12), (3, 44, 20, 0))):
        kn, P, p, md, me = convex_knots(100, N, nx, nu, nc, torch.float64, SEED + i)
        got = fs.sweep(kn, P, p, md, me)
        ref = fs.sweep_plain(kn, P, p, md, me)
        err = max(rel_err(got[k], ref[k]) for k in fs.FACTOR_FIELDS)
        print(f"[kernel] fused_stage sweep fp64 B=100 (N,nx,nu,nc)={(N, nx, nu, nc)}: "
              f"max rel err {err:.3e} (tol {FP64_TOL:g})")
        check(err <= FP64_TOL, f"fused_stage sweep fp64 {err}")
        one = fs.stage({k: getattr(kn, k)[:, N - 1] for k in fs.STAGE_FIELDS},
                       P, p, md, me)
        err = max(rel_err(one[k], ref[k][:, N - 1]) for k in fs.FACTOR_FIELDS)
        check(err <= FP64_TOL, f"fused_stage stage fp64 {err}")

    B, N, nx, nu, nc = HUMANOID_BATCH, MEDIUM_NSTEPS, 36, 12, 12
    kn, P, p, md, me = convex_knots(B, N, nx, nu, nc, torch.float32, SEED + 20)
    got = fs.sweep(kn, P, p, md, me)
    ref = fs.sweep_plain(kn, P, p, md, me)
    torch.cuda.synchronize()
    errs = {k: rel_err(got[k], ref[k]) for k in fs.FACTOR_FIELDS}
    worst = max(errs.values())
    print(f"[kernel] fused_stage sweep fp32 B={B} N={N} (nx,nu,nc)={(nx, nu, nc)}: "
          f"vs plain {worst:.2e} ({max(errs, key=errs.get)}; tol {K3_FP32_TOL:g})")
    kn64 = dataclasses.replace(kn, **{f.name: getattr(kn, f.name).double()
                                      for f in dataclasses.fields(kn)})
    ref64 = fs.sweep_plain(kn64, P.double(), p.double(), md.double(), me.double())
    for name, res in (("kernel", got), ("plain", ref)):
        e = max(rel_err(res[k].double(), ref64[k]) for k in fs.FACTOR_FIELDS)
        print(f"[kernel] fused_stage sweep fp32 {name} vs fp64 plain: {e:.2e}")
    del kn64, ref64
    check(all(torch.isfinite(v).all().item() for v in got.values()),
          "non-finite fused_stage output")
    check(worst <= K3_FP32_TOL, f"fused_stage sweep fp32 {worst}")
    max_abs = max(abs_err(got[k], ref[k]) for k in fs.FACTOR_FIELDS)
    del got, ref

    info = fs.kernel_info("sweep", torch.float32, B, N + 1, nx, nu, nc)
    print(f"[kernel] fused_stage sweep fp32 (nx,nu,nc)={(nx, nu, nc)}: "
          f"{info['smem_bytes']} B of shared memory and {info['threads']} threads a "
          f"block, {info['registers']} registers a thread, {info['blocks_per_sm']} "
          f"resident blocks per SM")

    def sweep_bound(Bs):
        stage_words = (2 * nx * nx + 2 * nx * nu + nu * nu + 2 * nx + nu
                       + nc * (nx + nu + 1))
        factor_words = (nu * (nx + 1) + nc * (nx + 1) + 2 * nx + 3 * nx * nx + nx)
        nbytes = 4 * Bs * (N * (stage_words + factor_words) + nx * nx + nx + 2)
        flops = Bs * N * k3_flops_per_stage(nx, nu, nc)
        return nbytes, flops, *bound(nbytes, flops)

    # by batch: 1, 2, 4 and 7.8 blocks for each of the 132 SMs
    by_batch = {}
    for Bs in (132, 264, 528, B):
        sub = dataclasses.replace(kn, **{f.name: getattr(kn, f.name)[:Bs]
                                         for f in dataclasses.fields(kn)})
        args = (sub, P[:Bs], p[:Bs], md[:Bs], me[:Bs])
        ms_b = kernel_ms(lambda: fs.sweep(*args), 5, "sweep_kernel")
        bms_b = sweep_bound(Bs)[2]
        by_batch[Bs] = dict(ms=ms_b, bound_ms=bms_b)
        print(f"[kernel] fused_stage sweep fp32 B={Bs} N={N}: kernel {ms_b:.4f} ms "
              f"({ms_b / N * 1e3:.2f} us per stage), bound {bms_b:.4f} ms "
              f"({ms_b / bms_b:.1f}x)")
    ms = by_batch[B]["ms"]
    plain_ms = avg_time_ms(lambda: fs.sweep_plain(kn, P, p, md, me), 2)
    nbytes, flops, bms, by = sweep_bound(B)
    print(f"[kernel] fused_stage sweep fp32 B={B} N={N}: kernel {ms:.4f} ms "
          f"({ms / N * 1e3:.2f} us per stage), plain {plain_ms:.3f} ms; bound "
          f"{bms:.4f} ms ({by}: {nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP)")
    return dict(
        name="fused_stage_sweep", route="cuda",
        source="aligator_tpu_torch/csrc/fused_stage.cu",
        replaces="aligator_tpu/gar/pallas_stage.py:140", max_abs_err=max_abs,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
    ), dict(occupancy=info, by_batch=by_batch)


def random_gains(B, T, nx, nu, nc, dtype, seed):
    g = _gen(seed)
    shapes = dict(kff=(nu,), K=(nu, nx), zff=(nc,), Z=(nc, nx), lff=(nx,),
                  L=(nx, nx), yff=(nx,), Afb=(nx, nx))
    gains = {k: (torch.randn((B, T) + s, generator=g, device="cuda",
                             dtype=torch.float64) / math.sqrt(nx)).to(dtype)
             for k, s in shapes.items()}
    x0 = torch.randn((B, nx), generator=g, device="cuda", dtype=torch.float64)
    lam0 = torch.randn((B, nx), generator=g, device="cuda", dtype=torch.float64)
    return gains, x0.to(dtype), lam0.to(dtype)


def k4_phase():
    from aligator_tpu_torch.gar import fused_stage as fs

    # the test shapes, fp64: 13 gives slices that are not 16-byte aligned,
    # (56, 22, 22) is the walk's, 160 a stage larger than the ring
    for i, (nx, nu, nc) in enumerate(((13, 4, 3), (13, 4, 0), (36, 12, 12), (56, 22, 0),
                                      (56, 22, 22), (160, 7, 2))):
        gains, x0, lam0 = random_gains(100, 11, nx, nu, nc, torch.float64, SEED + i)
        err = max(rel_err(a, b) for a, b in zip(fs.forward(gains, x0, lam0),
                                                fs.forward_plain(gains, x0, lam0)))
        print(f"[kernel] fused_stage forward fp64 B=100 T=11 (nx,nu,nc)="
              f"{(nx, nu, nc)}: max rel err {err:.3e} (tol {FP64_TOL:g})")
        check(err <= FP64_TOL, f"fused_stage forward fp64 {err}")

    out = {}
    T = MEDIUM_NSTEPS + 1
    for i, (B, nx, nu, nc) in enumerate(((HUMANOID_BATCH, 36, 12, 12),
                                         (LQR_BATCH, 56, 22, 0))):
        gains, x0, lam0 = random_gains(B, T, nx, nu, nc, torch.float32, SEED + 10 + i)
        got = fs.forward(gains, x0, lam0)
        ref = fs.forward_plain(gains, x0, lam0)
        g64 = {k: v.double() for k, v in gains.items()}
        ref64 = fs.forward_plain(g64, x0.double(), lam0.double())
        torch.cuda.synchronize()
        err = max(rel_err(a, b) for a, b in zip(got, ref))
        print(f"[kernel] fused_stage forward fp32 B={B} T={T} (nx,nu,nc)={(nx, nu, nc)}: "
              f"vs plain {err:.2e} (tol {K4_FP32_TOL:g}); vs fp64 plain: kernel "
              f"{max(rel_err(a.double(), b) for a, b in zip(got, ref64)):.2e}, plain "
              f"{max(rel_err(a.double(), b) for a, b in zip(ref, ref64)):.2e}")
        check(all(torch.isfinite(t).all().item() for t in got), "non-finite forward")
        check(err <= K4_FP32_TOL, f"fused_stage forward fp32 {err}")
        info = fs.kernel_info("forward", torch.float32, B, T, nx, nu, nc)
        print(f"[kernel] fused_stage forward fp32 B={B} (nx,nu,nc)={(nx, nu, nc)}: "
              f"{info['smem_bytes']} B of shared memory and {info['threads']} threads a "
              f"block, {info['registers']} registers a thread, {info['blocks_per_sm']} "
              f"resident blocks per SM")
        ms = kernel_ms(lambda: fs.forward(gains, x0, lam0), 20, "forward_kernel")
        plain_ms = avg_time_ms(lambda: fs.forward_plain(gains, x0, lam0), 3)
        # the library yardstick: one stage as one batched GEMM plus bias over
        # the stacked [K; Z; L; Afb], times the T stages
        W = torch.cat([gains["K"][:, 0], gains["Z"][:, 0], gains["L"][:, 0],
                       gains["Afb"][:, 0]], 1)
        bias = torch.cat([gains[k][:, 0] for k in ("kff", "zff", "lff", "yff")],
                         1)[..., None]
        xcol = x0[..., None]
        stage_lib_ms = avg_time_ms(lambda: torch.baddbmm(bias, W, xcol), 200)
        rows_t, rows_dyn = nu + nc, 2 * nx
        nbytes = 4 * B * (T * rows_t * (nx + 1) + (T - 1) * rows_dyn * (nx + 1)
                          + 2 * nx + T * (2 * nx + nu + nc))
        flops = 2 * B * nx * (T * rows_t + (T - 1) * rows_dyn)
        bms, by = bound(nbytes, flops)
        print(f"[kernel] fused_stage forward fp32 B={B} T={T}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, baddbmm {stage_lib_ms:.4f} ms per stage "
              f"({T * stage_lib_ms:.4f} ms for T stages); bound {bms:.4f} ms ({by}: "
              f"{nbytes / 1e9:.4f} GB; kernel {ms / bms:.1f}x)")
        out[(B, nx)] = dict(ms=ms, plain_ms=plain_ms, library_ms=T * stage_lib_ms,
                            bound_ms=bms, bound_by=by, occupancy=info, max_abs_err=max(
                                abs_err(a, b) for a, b in zip(got, ref)))
    main = out[(HUMANOID_BATCH, 36)]
    return dict(
        name="fused_stage_forward", route="cuda",
        source="aligator_tpu_torch/csrc/fused_stage.cu",
        replaces="aligator_tpu/gar/pallas_stage.py:440",
        max_abs_err=max(v["max_abs_err"] for v in out.values()),
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    ), {f"B={B} nx={nx}": {k: v[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "occupancy")}
        for (B, nx), v in out.items()}


def k5_flops(model, bodies, dims, active):
    """Flops that K5's function needs on these inputs, summed over the
    ``active.shape[0]`` instances: the kernel's
    arithmetic (a multiply-add is 2) counted only where it is not a product
    with zero, and no product with a 0/1 mask. A[b, k] marks the dofs that
    move body b, D[k, j] the dof pairs with joint(j) ⪯ joint(k): a pair
    table entry is needed where D is 1, a body's contraction over k, its
    per-direction algebra and its accumulator entries where A[b] (and D) are
    1. An inactive contact (``active`` (K, ncont) is 0) has zero rows and a
    zero force, so it costs nothing."""
    from aligator_tpu_torch.modelling.multibody import model as rbd

    top = rbd.topology(model.joint_types, model.parents)
    A, D = top["A"] != 0, top["D"] != 0
    nv = A.shape[1]
    pairs = int(D.sum())

    def support(b):
        a = A[b]
        dirs = a | D[a].any(0)  # directions j whose derivatives are nonzero
        na, nj, npair = int(a.sum()), int(dirs.sum()), int(D[a].sum())
        # dAG, dAvG: per (j, component) and pair, an add and a multiply-add
        return na, nj, 18 * npair + 6 * na, npair

    # pair tables SxS and G (144 a pair), CVS, and the subtree term
    flops = 144 * pairs + 30 * nv + 12 * pairs
    for b in range(A.shape[0]):
        na, nj, contraction, _ = support(b)
        # 798 a direction: the 6-vector algebra of df, dfv; f_b; the two
        # accumulators (a dot6 and an add each, per (k, j)); F
        flops += contraction + 798 * nj + 36 + 24 * na * nj + 6 * na
    total = float(flops) * active.shape[0]
    act = (active != 0).sum(0).tolist()  # instances with each contact active
    for c, (b, dim) in enumerate(zip(bodies, dims)):
        na, nj, contraction, npair = support(b)
        per_dir = 243 if dim == 6 else 231  # kp = 0: no kp·dp term
        # pdot and F_c; per (k, j) the J' lam transport (6) and, where D is
        # 1, the SxS . F_c term (12)
        one = contraction + per_dir * nj + 24 + 3 * (dim == 6) + 6 * na * nj + 12 * npair
        total += float(one) * act[c]
    return total


def k5_inputs(model, x0s, active, N, dq, dv, seed):
    """K = B N instances at the main path's shapes: the Talos states around
    the batch of initial states (q ⊕ dq, v + dv from a seed), the schedule's
    contact activity and random torques."""
    g = _gen(seed)
    B, nq, nv = x0s.shape[0], model.nq, model.nv
    dt = x0s.dtype

    def randn(*shape, scale):
        return scale * torch.randn(shape, generator=g, device="cuda",
                                   dtype=torch.float64).to(dt)

    q = model.configuration_space().integrate(
        x0s[:, None, :nq].expand(B, N, nq), randn(B, N, nv, scale=dq))
    v = x0s[:, None, nq:] + randn(B, N, nv, scale=dv)
    act = active.expand(B, N, active.shape[-1])
    tau = randn(B, N, nv, scale=5.0)
    return q, v, tau, act


def k5_phase():
    from aligator_tpu_torch.examples.talos_walk import create_talos_walk_problem
    from aligator_tpu_torch.modelling.multibody import contact, fd_rows, humanoid, quadruped

    def rows_check(model, q, v, tau, act, frames, dims, kd, dtype, tol, label):
        out = contact.cfd_internals(model, q, v, tau, frames, act, prox_mu=1e-9,
                                    kd=kd, contact_dims=dims)
        args = (model, q, v, out["a"], out["lam"], act, frames, dims)
        got = fd_rows.fd_rows(*args, kd=kd)
        ref = fd_rows.fd_rows_plain(*args, kd=kd)
        torch.cuda.synchronize()
        errs = [rel_err(g_, r_) for g_, r_ in zip(got, ref)]
        print(f"[kernel] fd_rows {label} K={q.shape[:-1].numel()}: max rel err "
              f"{max(errs):.3e} (tol {tol:g})")
        check(all(torch.isfinite(t).all().item() for t in got), f"fd_rows {label} non-finite")
        check(max(errs) <= tol, f"fd_rows {label}: {errs}")
        return args, got, ref

    # the test shapes, fp64: the humanoid's 2x6D and the quadruped's 4x3D
    # contacts, an inactive contact in every third instance
    rng = np.random.default_rng(SEED)
    for name in ("humanoid", "quadruped"):
        if name == "humanoid":
            m = humanoid.make_humanoid(device="cuda")
            q0 = humanoid.half_sitting(m)
            frames, dims, kd = (m.frame_id("left_sole"), m.frame_id("right_sole")), (6, 6), 50.0
        else:
            m = quadruped.make_quadruped(device="cuda")
            q0 = quadruped.standing_configuration(m)
            frames, dims, kd = tuple(m.frame_id(f"foot{k}") for k in range(4)), (3,) * 4, 10.0
        K, nv = 37, m.nv
        t = lambda a: torch.tensor(a, device="cuda")  # noqa: E731
        q = m.configuration_space().integrate(q0[None], t(0.05 * rng.standard_normal((K, nv))))
        act = np.ones((K, len(frames)))
        act[::3, 0] = 0.0
        rows_check(m, q, t(0.2 * rng.standard_normal((K, nv))),
                   t(2.0 * rng.standard_normal((K, nv))), t(act), frames, dims, kd,
                   torch.float64, FP64_TOL, f"fp64 {name} {len(dims)}x{dims[0]}D")

    # the main path's shape: Talos, K = B N = 512 instances, fp32
    B = TALOS_BATCHES[0]
    problem, model, sched = create_talos_walk_problem(TALOS_T_DS, TALOS_T_SS,
                                                      dtype=torch.float32, device="cuda")
    N = problem.nsteps
    x0s = torch.tensor(talos_x0s(problem.x0[0].cpu().numpy(), model.nq, B), device="cuda")
    q, v, tau, act = k5_inputs(model, x0s, sched, N, 0.05, 0.2, SEED + 40)
    ode = problem.stages.dynamics.ode
    args, got, ref = rows_check(model, q, v, tau, act, ode.contact_frames,
                                ode.contact_dims, ode.kd, torch.float32, K5_FP32_TOL,
                                f"fp32 talos B={B} N={N}")
    args64 = (model.to(torch.float64),) + tuple(a.double() for a in args[1:6]) + args[6:]
    ref64 = fd_rows.fd_rows_plain(*args64, kd=ode.kd)
    for label, res in (("kernel", got), ("plain", ref)):
        e = max(rel_err(a.double(), b) for a, b in zip(res, ref64))
        print(f"[kernel] fd_rows fp32 {label} vs fp64 plain: {e:.2e}")
    max_abs = max(abs_err(a, b) for a, b in zip(got, ref))
    del ref64

    from aligator_tpu_torch.modelling.multibody.derivatives import fd_rows_inputs

    inputs = fd_rows_inputs(model, q, v, args[3], ode.contact_frames)
    inputs.update(v=v, lam=args[4], act=act)
    bodies = tuple(model.frame_parents[f] for f in ode.contact_frames)
    launch = lambda: fd_rows.launch(model, inputs, bodies, ode.contact_dims,  # noqa: E731
                                    ode.kd, 0.0)
    ms = kernel_ms(launch, 20, "fd_rows_kernel")
    call_ms = avg_time_ms(lambda: fd_rows.fd_rows(*args, kd=ode.kd), 20)
    plain_ms = avg_time_ms(lambda: fd_rows.fd_rows_plain(*args, kd=ode.kd), 5)
    K, nv, nb = B * N, model.nv, model.njoints
    ncont, nc = len(bodies), sum(ode.contact_dims)
    in_words = 4 * nv * 6 + nv + 5 * nb * 6 + nb * 36 + nc + 4 * ncont
    out_words = 2 * nv * nv + 2 * nc * nv
    nbytes = 4 * (K * (in_words + out_words) + nb * nv + nv * nv)
    flops = k5_flops(model, bodies, ode.contact_dims, act.reshape(K, ncont).cpu())
    bms, by = bound(nbytes, flops)
    print(f"[kernel] fd_rows fp32 K={K}: kernel {ms:.4f} ms (wrapper call with its "
          f"input preparation {call_ms:.4f} ms), plain {plain_ms:.4f} ms; bound "
          f"{bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return dict(
        name="fd_rows", route="cuda", source="aligator_tpu_torch/csrc/fd_rows.cu",
        replaces="aligator_tpu/modelling/multibody/pallas_tensors.py:87",
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=None,
    ), dict(wrapper_call_ms=call_ms, K=K, flops_per_instance=flops / K)


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


def slice_phase():
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples.se2_car import create_se2_problem

    cfg = at.solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4, rollout="linear",
        ls_max_steps=6, ls_strategy="filter",
    )
    x0s = bench_x0s(BATCH)
    problem = create_se2_problem(nsteps=NSTEPS, dtype=torch.float32, device="cuda")
    problem = dataclasses.replace(problem, x0=torch.tensor(x0s, device="cuda"))

    # the counted run: launch counts read just around the main path, with
    # the plain versions patched to raise
    with plain_versions_raise():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = at.solvers.solve(problem, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = launch_counts()
    steps = int(res.newton_steps.max().item())
    print(f"[slice] first solve {first_s:.3f} s, launches {launches}, "
          f"iterations with a Newton step {steps}")
    # K1 once per Newton iteration, so at least once
    check(1 <= steps <= cfg.max_iters, f"Newton iterations {steps}")
    want = {"fused_riccati": steps, "spd_solve": 0, "fused_stage_sweep": 0,
            "fused_stage_forward": 0, "fd_rows": 0}
    check(launches == want, f"SE(2) launches {launches} != {want}")

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

    breakdown = profile_solve(lambda: at.solvers.solve(problem, cfg))

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


def profile_solve(run, tag="profile"):
    """Device time by kernel over one call of ``run`` (a solve;
    torch.profiler), and the share of its wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: host-side op events are not read, and at the
    # whole-body path's ~10^5 ops a solve their processing took minutes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"[{tag}] one solve: wall {wall_ms:.1f} ms (profiled), device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(r[1] for r in rows)} kernel launches")
    for ms, count, key in rows[:12]:
        print(f"[{tag}]   {ms:9.3f} ms {count:6d}x  {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                top=[(round(ms, 3), c, k[:60]) for ms, c, k in rows[:5]])


# ---------------------------------------------------------------- phase 5


PLAIN_VERSIONS = (
    ("gar.spd_solve", "spd_solve_plain"), ("gar.fused_stage", "sweep_plain"),
    ("gar.fused_stage", "stage_plain"), ("gar.fused_stage", "forward_plain"),
    ("gar.riccati", "backward_plain"), ("gar.riccati", "forward_plain"),
    ("gar.fused_riccati", "solve_plain"), ("modelling.multibody.fd_rows", "fd_rows_plain"),
)


@contextlib.contextmanager
def plain_versions_raise():
    """Replace every plain version by a function that raises: a card solve
    inside the block must not reach one."""
    import importlib

    saved = []
    for mod_name, fn_name in PLAIN_VERSIONS:
        mod = importlib.import_module(f"aligator_tpu_torch.{mod_name}")
        saved.append((mod, fn_name, getattr(mod, fn_name)))

        def boom(*args, _name=f"{mod_name}.{fn_name}", **kwargs):
            raise AssertionError(f"{_name} was reached on the card")

        setattr(mod, fn_name, boom)
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def launch_counts():
    from aligator_tpu_torch.gar import fused_riccati, fused_stage, spd_solve
    from aligator_tpu_torch.modelling.multibody import fd_rows

    return {"fused_riccati": fused_riccati.LAUNCHES,
            "spd_solve": spd_solve.LAUNCHES,
            "fused_stage_sweep": fused_stage.STAGE_LAUNCHES,
            "fused_stage_forward": fused_stage.FORWARD_LAUNCHES,
            "fd_rows": fd_rows.LAUNCHES}


def reset_counts():
    from aligator_tpu_torch.gar import fused_riccati, fused_stage, spd_solve
    from aligator_tpu_torch.modelling.multibody import fd_rows

    fused_riccati.LAUNCHES = spd_solve.LAUNCHES = fd_rows.LAUNCHES = 0
    fused_stage.STAGE_LAUNCHES = fused_stage.FORWARD_LAUNCHES = 0


def medium_path(label, make, x0s, solve, expected, min_frac=None,
                expect_iters=None, timed=5, cpu_scenarios=MEDIUM_CPU_SCENARIOS):
    """Drive one path on the card at full batch, then its first
    ``cpu_scenarios`` scenarios on the CPU. ``make(device, x0s)`` builds the
    problem, ``solve`` runs the solver, ``expected(result)`` gives the
    launch counts the route implies."""
    problem = make("cuda", x0s)
    with plain_versions_raise():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(problem)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = launch_counts()
        want = expected(res)
        print(f"[{label}] first solve {first_s:.3f} s, launches {launches}, "
              f"expected {want}")
        check(launches == want, f"{label}: launches {launches} != {want}")
        for name, n in want.items():
            check(n == 0 or launches[name] >= 1, f"{label}: {name} not launched")

        finite = (torch.isfinite(res.us).flatten(1).all(1)
                  & torch.isfinite(res.xs).flatten(1).all(1))
        check(bool(finite.all()), f"{label}: non-finite solutions")
        check(bool(torch.isfinite(res.prim_infeas).all() & torch.isfinite(res.dual_infeas).all()),
              f"{label}: non-finite infeasibilities")
        conv = finite & res.conv
        frac = conv.float().mean().item()
        hist = torch.bincount(res.num_iters.long()).tolist()
        print(f"[{label}] frac_converged {frac:.6f}; num_iters histogram {hist}; "
              f"max prim {res.prim_infeas.max().item():.3e} "
              f"max dual {res.dual_infeas.max().item():.3e}")
        if min_frac is not None:
            check(frac >= min_frac, f"{label}: frac_converged {frac} < {min_frac}")
        if expect_iters is not None:
            check(bool((res.num_iters == expect_iters).all()),
                  f"{label}: num_iters {hist}")

        # solves/s as bench.py counts it: median of timed batches after the
        # warm-up above, each ended by a host readback
        times = []
        for _ in range(timed):
            t0 = time.perf_counter()
            r = solve(problem)
            float(r.us.sum() + r.prim_infeas.sum() + r.dual_infeas.sum())
            times.append(time.perf_counter() - t0)
        breakdown = profile_solve(lambda: solve(problem), f"{label} profile")
    batch = x0s.shape[0]
    med = statistics.median(times)
    print(f"[{label}] batch times (s) {[round(t, 4) for t in times]}; median "
          f"{med:.4f} s -> {batch / med:.1f} solves/s")

    n = cpu_scenarios
    if n:
        t0 = time.perf_counter()
        rc = solve(make("cpu", x0s[:n]))
        cpu_s = time.perf_counter() - t0
        same_iters = bool((rc.num_iters == res.num_iters[:n].cpu()).all())
        same_conv = bool((rc.conv == res.conv[:n].cpu()).all())
        scale = max(1.0, rc.xs.abs().max().item(), rc.us.abs().max().item())
        dx = (rc.xs - res.xs[:n].cpu()).abs().max().item() / scale
        du = (rc.us - res.us[:n].cpu()).abs().max().item() / scale
        print(f"[{label}] cpu check ({n} scenarios, {cpu_s:.1f} s): num_iters equal "
              f"{same_iters}, conv equal {same_conv}, rel max|dxs| {dx:.3e}, "
              f"max|dus| {du:.3e} (tol {MEDIUM_CPU_TRAJ_TOL:g})")
        check(same_iters and same_conv, f"{label}: card and CPU iteration counts differ")
        check(max(dx, du) <= MEDIUM_CPU_TRAJ_TOL,
              f"{label}: card and CPU trajectories differ")
    return launches, dict(frac_converged=frac, solves_per_sec=batch / med,
                          batch_s=med, batch_times=times, num_iters_hist=hist,
                          max_prim=res.prim_infeas.max().item(),
                          max_dual=res.dual_infeas.max().item(),
                          first_solve_s=first_s, breakdown=breakdown)


def medium_phases():
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples import medium_dims

    N = MEDIUM_NSTEPS
    out, counts = {}, {}

    rng = np.random.default_rng(3)
    hx0 = np.zeros(36)
    hx0[0] = 0.5
    hx0s = (hx0 + 0.1 * rng.standard_normal((HUMANOID_BATCH, 36))).astype(np.float32)

    def make_humanoid(dev, x0s):
        prob = medium_dims.make_humanoid_dims_problem(N, torch.float32, dev)
        return dataclasses.replace(prob, x0=torch.tensor(x0s, device=dev))

    hcfg = at.solvers.ProxDDPConfig(tol=1e-3, mu_init=1e-3, max_iters=4,
                                    max_al_iters=4, rollout="linear", ls_max_steps=6)

    def humanoid_counts(res):
        steps = int(res.newton_steps.max().item())
        return {"fused_riccati": 0, "spd_solve": 0, "fused_stage_sweep": steps,
                "fused_stage_forward": steps, "fd_rows": 0}

    counts["humanoid"], out["humanoid"] = medium_path(
        "humanoid", make_humanoid, hx0s, lambda p: at.solvers.solve(p, hcfg),
        humanoid_counts, min_frac=MIN_FRAC_CONVERGED)

    rng = np.random.default_rng(7)
    lx0s = (1.0 + 0.1 * rng.standard_normal((LQR_BATCH, 56))).astype(np.float32)

    def make_lqr(dev, x0s):
        prob = medium_dims.make_dense_lqr(56, 22, N, torch.float32, dev)
        return dataclasses.replace(prob, x0=torch.tensor(x0s, device=dev))

    pcfg = at.solvers.ProxDDPConfig(tol=1e-7, mu_init=1e-9, max_iters=2,
                                    rollout="linear")

    def prox_counts(res):
        steps = int(res.newton_steps.max().item())
        return {"fused_riccati": 0, "spd_solve": 2 * N * steps,
                "fused_stage_sweep": 0, "fused_stage_forward": steps, "fd_rows": 0}

    counts["lqr56_proxddp"], out["lqr56_proxddp"] = medium_path(
        "lqr56_proxddp", make_lqr, lx0s, lambda p: at.solvers.solve(p, pcfg),
        prox_counts, expect_iters=2)

    fcfg = at.solvers.FDDPConfig(tol=1e-7, max_iters=2)

    def fddp_counts(res):
        iters = int(res.num_iters.max().item())
        return {"fused_riccati": 0, "spd_solve": N * (iters + 1),
                "fused_stage_sweep": 0, "fused_stage_forward": 0, "fd_rows": 0}

    counts["lqr56_fddp"], out["lqr56_fddp"] = medium_path(
        "lqr56_fddp", make_lqr, lx0s, lambda p: at.solvers.fddp.solve(p, fcfg),
        fddp_counts, expect_iters=2)
    return counts, out


# ---------------------------------------------------------------- phase 6


def talos_x0s(x0, nq, batch):
    """``batch`` copies of the nominal state ``x0`` with the velocities
    perturbed by 0.01 N(0, 1) (numpy, SEED), as bench_talos.py perturbs
    them; float32."""
    rng = np.random.default_rng(SEED)
    x0s = np.repeat(np.asarray(x0, np.float64)[None], batch, 0)
    x0s[:, nq:] += 0.01 * rng.standard_normal((batch, x0s.shape[1] - nq))
    return x0s.astype(np.float32)


def talos_phases():
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples.talos_walk import create_talos_walk_problem

    cfg = at.solvers.ProxDDPConfig(tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4,
                                   rollout="linear", ls_max_steps=6,
                                   force_initial_condition=True)
    nominal, model, _ = create_talos_walk_problem(TALOS_T_DS, TALOS_T_SS,
                                                  dtype=torch.float32, device="cpu")
    N = nominal.nsteps

    def make(dev, x0s, dtype=torch.float32):
        prob, _, _ = create_talos_walk_problem(TALOS_T_DS, TALOS_T_SS, dtype=dtype,
                                               device=dev)
        return dataclasses.replace(prob, x0=torch.tensor(x0s, dtype=dtype, device=dev))

    def counts(res):
        # per outer iteration and once more for the final refresh: one
        # derivative evaluation (K5 + the two contact-KKT K2 solves); per
        # Newton step: the 2N K2 solves of the Riccati loop and one K4 sweep
        loops = int(res.num_iters.max().item())
        steps = int(res.newton_steps.max().item())
        want = {"fused_riccati": 0, "spd_solve": 2 * (loops + 1) + 2 * N * steps,
                "fused_stage_sweep": 0, "fused_stage_forward": steps,
                "fd_rows": loops + 1}
        got = launch_counts()
        if steps:
            print(f"[talos] outer iterations {loops}, Newton steps {steps}; per "
                  f"Newton step, less the final refresh: K5 "
                  f"{(got['fd_rows'] - 1) / steps:g}, K2 {(got['spd_solve'] - 2) / steps:g}, "
                  f"K4 {got['fused_stage_forward'] / steps:g}, K1 "
                  f"{got['fused_riccati']}, K3 {got['fused_stage_sweep']}")
        return want

    out, cnt = {}, {}
    for batch in TALOS_BATCHES:
        x0s = talos_x0s(nominal.x0[0].numpy(), model.nq, batch)
        cnt[batch], out[batch] = medium_path(
            f"talos{batch}", make, x0s, lambda p: at.solvers.solve(p, cfg), counts,
            cpu_scenarios=0)
        check(cnt[batch]["fd_rows"] >= 1, "K5 was not launched on the Talos path")
    out["cpu_check"] = talos_cpu_check(make, x0s[:TALOS_CPU_SCENARIOS], cfg)
    out["fp32_check"] = talos_fp32_check(make, cfg)
    return cnt, out


def talos_cpu_check(make, x0s, cfg):
    """The first scenarios solved again on the CPU, float64 on both sides
    (the card with the plain versions patched to raise)."""
    import aligator_tpu_torch as at

    def rel(a, b, scale):
        return (a.cpu() - b.cpu()).abs().max().item() / scale

    with plain_versions_raise():
        gpu = at.solvers.solve(make("cuda", x0s, torch.float64), cfg)
    t0 = time.perf_counter()
    cpu = at.solvers.solve(make("cpu", x0s, torch.float64), cfg)
    cpu_s = time.perf_counter() - t0
    same = all(bool((getattr(cpu, k) == getattr(gpu, k).cpu()).all())
               for k in ("num_iters", "al_iter", "conv"))
    scale = max(1.0, cpu.xs.abs().max().item(), cpu.us.abs().max().item())
    dx, du = rel(gpu.xs, cpu.xs, scale), rel(gpu.us, cpu.us, scale)
    print(f"[talos] cpu check fp64 ({len(x0s)} scenarios, {cpu_s:.1f} s): "
          f"num_iters/al_iter/conv equal {same}, rel max|dxs| {dx:.3e}, max|dus| "
          f"{du:.3e} (tol {TALOS_CPU_TRAJ_TOL:g})")
    check(same, "talos: card and CPU iteration counts differ")
    check(max(dx, du) <= TALOS_CPU_TRAJ_TOL, "talos: card and CPU trajectories differ")
    return dict(same_iters=same, rel_dxs=dx, rel_dus=du)


def talos_fp32_check(make, cfg):
    """The float32 solve on the card, step by step, against the JAX
    package's float32 solve of the same 2 scenarios
    (``tests/data/torch_talos_fp32_ref.npz``, written by
    ``tools/torch_talos_fp32_fixture.py``): solved with 0..4 iterations, the
    infeasibilities after each step and which steps the line search
    rejected (iterate unchanged) must be the JAX package's."""
    import pathlib

    import aligator_tpu_torch as at

    path = pathlib.Path(__file__).resolve().parent / "tests/data/torch_talos_fp32_ref.npz"
    with np.load(path) as f:
        ref = {k: f[k] for k in f.files}
    prob = make("cuda", ref["x0"])
    prim, dual, rejected, prev = [], [], [], None
    with plain_versions_raise():
        for k in range(cfg.max_iters + 1):
            res = at.solvers.solve(prob, dataclasses.replace(cfg, max_iters=k))
            prim.append(res.prim_infeas.cpu().numpy())
            dual.append(res.dual_infeas.cpu().numpy())
            if prev is not None:
                rejected.append(((res.xs == prev.xs).flatten(1).all(1)
                                 & (res.us == prev.us).flatten(1).all(1)).cpu().numpy())
            prev = res
    prim, dual, rejected = (np.stack(a, 1) for a in (prim, dual, rejected))
    err = float(max(np.abs(prim - ref["prim"]).max() / np.abs(ref["prim"]).max(),
                    np.abs(dual - ref["dual"]).max() / np.abs(ref["dual"]).max()))
    same = (np.array_equal(res.num_iters.cpu().numpy(), ref["num_iters"])
            and np.array_equal(res.al_iter.cpu().numpy(), ref["al_iter"]))
    print(f"[talos] fp32 card vs JAX fp32 ({len(ref['x0'])} scenarios): rejected steps "
          f"{rejected.tolist()} (JAX {ref['rejected'].tolist()}), prim per step "
          f"{prim.tolist()}, rel err of prim/dual {err:.2e} (tol {TALOS_FP32_TOL:g}), "
          f"num_iters/al_iter equal {same}")
    check(same, "talos fp32: card and JAX iteration counts differ")
    check(np.array_equal(rejected, ref["rejected"]),
          "talos fp32: the card and JAX reject different Newton steps")
    check(err <= TALOS_FP32_TOL, f"talos fp32: infeasibilities differ from JAX's: {err}")
    return dict(rejected=rejected.tolist(), prim=prim.tolist(), rel_err=err)


# ---------------------------------------------------------------- main


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    import aligator_tpu_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        phase_s[name] = time.perf_counter() - t0
        print(f"[time] {name} {phase_s[name]:.1f} s (script {time.perf_counter() - t_start:.1f} s)")
        return out

    smi = timed("device", device_phase)
    timed("build", build_phase)
    k1, layout_times = timed("K1", kernel_phase)
    k2, k2_extra = timed("K2", k2_phase)
    k3, k3_extra = timed("K3", k3_phase)
    k4, k4_shapes = timed("K4", k4_phase)
    k5, k5_extra = timed("K5", k5_phase)
    se2_counts, result = timed("se2", slice_phase)
    medium_counts, medium = timed("medium", medium_phases)
    talos_counts, talos = timed("talos", talos_phases)
    # each kernel's launches: the sum over the paths' counted runs
    runs = [se2_counts, *medium_counts.values(), *talos_counts.values()]
    for k in (k1, k2, k3, k4, k5):
        k["launches"] = sum(c[k["name"]] for c in runs)
    print(json.dumps({"slice": result, "fused_riccati_layout": layout_times,
                      "medium": medium, "medium_launches": medium_counts,
                      "talos": talos, "talos_launches": talos_counts,
                      "spd_solve": k2_extra, "fused_stage_sweep": k3_extra,
                      "fused_stage_forward": k4_shapes,
                      "fd_rows": k5_extra, "phase_s": phase_s,
                      "script_s": time.perf_counter() - t_start,
                      "card": smi}))
    print(smi)
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
