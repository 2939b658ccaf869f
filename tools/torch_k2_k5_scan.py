#!/usr/bin/env python3
"""Time variants of the port's SPD solve (K2, csrc/spd_solve.cu) and
contact-dynamics derivative rows (K5, csrc/fd_rows.cu) on one CUDA card,
beside the shipped builds, at the shapes the paths launch.

Run from the repository root on a machine with a card and nvcc:

    python3 tools/torch_k2_k5_scan.py

It builds copies of the shipped sources with one knob changed into
``aligator_tpu_torch/_build/scan`` (ptxas's registers and spills are
printed), swaps each in under the wrapper (``spd_solve.launch``,
``fd_rows.launch``), checks it against the shipped build and times it
(torch.profiler, the kernel alone; fp32):

* K2: without the split of Y's columns over blocks at small M; 4 x 8
  tiles only (fewer, larger tiles: half the threads where the shipped
  launcher takes 4 x 4, and no split); a register cap of 128 or 85 (2 or 3
  blocks of 256 threads an SM); at every (M, n, r) of ``chip_smoke.py``;
* K5: 128 or 256 threads a block, with 1 to 6 blocks an SM asked of
  ``__launch_bounds__`` (a register cap; shipped: 128 threads, 4 blocks),
  at K = 512 and 8192 (the Talos walk at batch 16 and 256).

With ``--phases`` it instead builds the shipped K5 with ``clock64()``
stamped after each of its block barriers (block 0, thread 0) and prints
the cycles block 0 spends in each phase at K = 1, 512 and 8192.
"""

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from aligator_tpu_torch import _build  # noqa: E402
from aligator_tpu_torch.gar import spd_solve as sp  # noqa: E402
from aligator_tpu_torch.modelling.multibody import fd_rows  # noqa: E402

K2_SHAPES = [(M, n, 57) for M in (256, 16) for n in (56, 22)] + [
    (M, n, 84) for M in (512, 8192) for n in (28, 12)]
K2_SPLIT = (r"  const int rs = column_split\(M, n, r\);\n"
            r"  if \(rs < r\) return launch_regs<4>\(M, n, r, rs, A, R, X, stream\);\n")
K2_VARIANTS = {
    "no_split": [(K2_SPLIT, "")],
    "tiles4x8": [(K2_SPLIT, ""),
                 (r"  if \(aligator::reg_tiles<4>\(n, r\) <= kThreads\)\n"
                  r"    return launch_regs<4>\(M, n, r, r, A, R, X, stream\);\n", "")],
    "cap128": [(r"__launch_bounds__\(kThreads\)\nspd_solve_kernel_regs",
                "__launch_bounds__(kThreads, 2)\nspd_solve_kernel_regs")],
    "cap85": [(r"__launch_bounds__\(kThreads\)\nspd_solve_kernel_regs",
               "__launch_bounds__(kThreads, 3)\nspd_solve_kernel_regs")],
}
K5_VARIANTS = {
    f"t{t}b{b}": [(r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {t};"),
                  (r"constexpr int kMinBlocks = \d+;", f"constexpr int kMinBlocks = {b};")]
    for t, b in ((256, 1), (256, 2), (256, 3), (128, 2), (128, 6))
}


def build(source, variants):
    out = _build.BUILD_DIR / "scan"
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, subs in variants.items():
        src = text
        if callable(subs):
            src = subs(src)
        else:
            for pat, rep in subs:
                src, k = re.subn(pat, rep, src)
                assert k == 1, f"{name}: {pat!r} matched {k} times"
        cu = out / f"{source}_{name}.cu"
        cu.write_text(src)
        so = out / f"lib{source}_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
               str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"[scan] {source} {name}: build failed\n{log}")
            continue
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(f"[scan] {source} {name}: {regs}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


STAMP = r"""
__device__ unsigned long long g_phase[8];
#define PHASE() do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
  const long long now = clock64(); g_phase[ph_i++ & 7] += now - ph_t; ph_t = now; } } while (0)
"""
READ = r"""
extern "C" int read_phases(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long zero[8] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase, zero, sizeof(zero)));
}
"""


def with_phases(text):
    """K5 with a stamp after each block barrier and at its end."""
    a = text.index("fd_rows_kernel(const int nv")
    b = text.index("template <typename S>\nint launch(")
    body = text[a:b].replace("__syncthreads();", "__syncthreads(); PHASE();")
    start = "const S kd = static_cast<S>(tab.kd), kp = static_cast<S>(tab.kp);"
    assert start in body
    body = body.replace(start, start + "\n  long long ph_t = clock64();\n  int ph_i = 0;", 1)
    end = body.rindex("}")
    body = body[:end] + "  __syncthreads();\n  PHASE();\n" + body[end:]
    src = text[:a] + body + text[b:]
    return src.replace("namespace {", STAMP + "namespace {", 1) + READ


def swapped(source, lib, fn):
    """fn() with the wrapper of ``source`` launching from ``lib``."""
    key = _build.variant(source)
    _build.load(source)
    shipped = _build._loaded[key]
    if lib is not None:
        _build._loaded[key] = lib
    try:
        return fn()
    finally:
        _build._loaded[key] = shipped


def k2_scan():
    libs = {"shipped": None, **build("spd_solve", K2_VARIANTS)}
    for i, (M, n, r) in enumerate(K2_SHAPES):
        A, R = cs.spd_batch(M, n, r, torch.float32, cs.SEED + 10 + i)
        ref = sp.launch(A, R)
        line = []
        for name, lib in libs.items():
            X = swapped("spd_solve", lib, lambda: sp.launch(A, R))
            err = cs.rel_err(X, ref)
            ms = swapped("spd_solve", lib, lambda: cs.kernel_ms(
                lambda: sp.launch(A, R), 100, "spd_solve_kernel"))
            line.append(f"{name} {ms:.4f} ms ({err:.1e})")
        print(f"[scan] K2 M={M} n={n} r={r}: " + "; ".join(line))


def k5_scan(phases):
    from aligator_tpu_torch.examples.talos_walk import create_talos_walk_problem
    from aligator_tpu_torch.modelling.multibody import contact
    from aligator_tpu_torch.modelling.multibody.derivatives import fd_rows_inputs

    if phases:
        libs = build("fd_rows", {"phases": with_phases})
    else:
        libs = {"shipped": None, **build("fd_rows", K5_VARIANTS)}
    problem, model, sched = create_talos_walk_problem(cs.TALOS_T_DS, cs.TALOS_T_SS,
                                                      dtype=torch.float32, device="cuda")
    N, ode = problem.nsteps, problem.stages.dynamics.ode
    bodies = tuple(model.frame_parents[f] for f in ode.contact_frames)
    for B in cs.TALOS_BATCHES[-1:] if phases else cs.TALOS_BATCHES:
        x0s = torch.tensor(cs.talos_x0s(problem.x0[0].cpu().numpy(), model.nq, B),
                           device="cuda")
        q, v, tau, act = cs.k5_inputs(model, x0s, sched, N, 0.05, 0.2, cs.SEED + 40)
        out = contact.cfd_internals(model, q, v, tau, ode.contact_frames, act,
                                    prox_mu=1e-9, kd=ode.kd, contact_dims=ode.contact_dims)
        inputs = fd_rows_inputs(model, q, v, out["a"], ode.contact_frames)
        inputs.update(v=v, lam=out["lam"], act=act)

        def go():
            return fd_rows.launch(model, inputs, bodies, ode.contact_dims, ode.kd, 0.0)
        if phases:
            lib = libs["phases"]
            lib.read_phases.argtypes = [ctypes.c_void_p]
            buf = (ctypes.c_ulonglong * 8)()
            for k in sorted({1, 512, B * N}):
                sub = {name: x.reshape((B * N,) + x.shape[2:])[:k] for name, x in inputs.items()}

                def one():
                    return fd_rows.launch(model, sub, bodies, ode.contact_dims, ode.kd, 0.0)
                swapped("fd_rows", lib, one)
                torch.cuda.synchronize()
                lib.read_phases(buf)  # drop the warm-up's stamps
                swapped("fd_rows", lib, one)
                torch.cuda.synchronize()
                lib.read_phases(buf)
                print(f"[scan] K5 K={k}: cycles of block 0 in phases 1-4:", list(buf)[:4])
            continue
        ref = go()
        line = []
        for name, lib in libs.items():
            got = swapped("fd_rows", lib, go)
            err = max(cs.rel_err(a, b) for a, b in zip(got, ref))
            ms = swapped("fd_rows", lib, lambda: cs.kernel_ms(go, 20, "fd_rows_kernel"))
            line.append(f"{name} {ms:.4f} ms ({err:.1e})")
        print(f"[scan] K5 K={B * N}: " + "; ".join(line))


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not args.phases:
        k2_scan()
    k5_scan(args.phases)


if __name__ == "__main__":
    main()
