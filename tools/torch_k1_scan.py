#!/usr/bin/env python3
"""Time the port's fused Riccati solve (K1, csrc/fused_riccati.cu) on one
CUDA card by batch size and by build variant, and optionally where a
stage's time goes.

Run from the repository root on a machine with a card and nvcc:

    python3 tools/torch_k1_scan.py [--batches 4096 8192 32768 131072]
        [--variants K1_CHUNK=4 K1_CHUNK=16,K1_SCEN=16 ...] [--phases]
        [--shape 3 2 0 0] [--horizon 51] [--repo DIR]

At the main shape (nx=3, nu=2, nc=0, general E, T=51, fp32 unless
``--shape nx nu nc explicit`` and ``--horizon``) it prints, for each batch,
the kernel's own time (profiler), the whole K1 step's time (from the
``LQRProblem`` to the returned tensors, CUDA events over back-to-back
calls) and the byte bound. ``--repo DIR`` times the K1 of another checkout
of the repository instead (its package is imported from DIR; a checkout
whose wrapper still packs the knots batch-minor has its whole step timed as
pack + kernel + ``.contiguous()`` of every output), so that two trees can
be timed in turns within one call.

``--variants`` builds the shipped source with extra defines (each argument
a comma-separated list of ``K=V``; the knobs are the ``#ifndef`` constants
at the top of the source: ``K1_CHUNK`` stages a chunk, ``K1_SCEN``
scenarios a block at most, ``K1_COPY_THREADS`` threads a scenario; and
``K1_NO_COMPUTE=1`` or ``K1_NO_COPY=1`` to time the copies or the
arithmetic alone) and times each launch (CUDA events) beside the shipped
build, after comparing their outputs. ``--phases`` builds a variant with
``K1_PHASES=1``, whose block 0 stamps ``clock64()`` between the steps of a
stage, and prints the cycles a stage spends in each step.
"""

import argparse
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# step names of the K1_STAMP slots in csrc/fused_riccati.cu
PHASES = ("wait for the chunk's loads", "E^-1 and the Schur solve", "products",
          "reduced KKT and gains", "value update and stores to shared memory",
          "stores of the chunk", "forward step")


def packed_api(fr):
    return hasattr(fr, "pack")


def whole_step(fr, prob, mud, mue, expl):
    """The K1 step of ``riccati.solve_and_gains``: what the solver gets."""
    if not packed_api(fr):
        return lambda: fr.launch(prob, mud, mue, expl)
    launch = getattr(fr, "launch_packed", getattr(fr, "launch"))

    def step():
        out, gains = launch(*fr.pack(prob, mud, mue, expl), prob, expl)
        xs, us, vs, lams, g = fr.unpack(prob, out, gains)
        return [t.contiguous() for t in (xs, us, vs, lams, *g.values())]
    return step


def kernel_only(fr, prob, mud, mue, expl):
    if not packed_api(fr):
        return lambda: fr.launch(prob, mud, mue, expl)
    launch = getattr(fr, "launch_packed", getattr(fr, "launch"))
    packed = fr.pack(prob, mud, mue, expl)
    return lambda: launch(*packed, prob, expl)


def swapped(fr, shape, lib, fn):
    """fn() with the K1 wrapper launching from ``lib`` at ``shape``."""
    from aligator_tpu_torch import _build

    key = _build.variant(fr.variant(*shape))
    _build.load(*key)
    shipped = _build._loaded[key]
    _build._loaded[key] = lib
    try:
        return fn()
    finally:
        _build._loaded[key] = shipped


def build_variants(fr, shape, specs):
    from aligator_tpu_torch import _build

    name, defines = fr.variant(*shape)
    vs = {spec: (name, defines + tuple(spec.split(","))) for spec in specs}
    _build.build(list(vs.values()))
    libs = {}
    for spec, v in vs.items():
        log = _build.BUILD_LOG[_build.label(v)][1]
        print(f"[build] {spec}:", [ln.strip() for ln in log.splitlines()
                                   if "registers" in ln or "spill" in ln])
        libs[spec] = _build.load(*v)
    return libs


def read_phases(lib):
    import ctypes

    buf = (ctypes.c_ulonglong * 16)()
    lib.k1_read_phases.argtypes = [ctypes.c_void_p]
    lib.k1_read_phases(buf)
    return list(buf)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[4096, 8192, 32768, 131072])
    ap.add_argument("--variants", nargs="*", default=[])
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--shape", type=int, nargs=4, default=[3, 2, 0, 0])
    ap.add_argument("--horizon", type=int, default=cs.NSTEPS + 1)
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    ap.add_argument("--repo", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_k1_scan: needs a CUDA device")
    if args.repo is not None:
        sys.path.insert(0, str(args.repo.resolve()))
    from aligator_tpu_torch.gar import fused_riccati as fr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), "| K1 from", pathlib.Path(fr.__file__).resolve())
    nx, nu, nc, expl = args.shape
    expl = bool(expl)
    shape = (nx, nu, nc, expl)
    T, dt = args.horizon, getattr(torch, args.dtype)
    Bmax = max(args.batches)
    prob, mud, mue = cs.k1_problem(Bmax, T, nx, nu, nc, expl, dt, cs.SEED + 40)

    def sub(bs):
        return prob.map(lambda t: t[:bs]), mud[:bs], mue[:bs]

    for bs in args.batches:
        p, a, b = sub(bs)
        k_ms = cs.kernel_ms(kernel_only(fr, p, a, b, expl), 20, "fused_riccati_kernel")
        w_ms = cs.avg_time_ms(whole_step(fr, p, a, b, expl), 20)
        bnd, by = cs.k1_bound(bs, T, nx, nu, nc, expl, p.knots.Q.element_size())
        print(f"[scan] shipped {shape} T={T} {args.dtype} B={bs}: kernel "
              f"{k_ms:.4f} ms, whole step {w_ms:.4f} ms, bound {bnd:.4f} ms "
              f"({by}), kernel/bound {k_ms / bnd:.2f}")
    if args.repo is not None or not (args.variants or args.phases):
        return

    p, a, b = sub(min(Bmax, cs.BATCH))
    ref = fr.launch(p, a, b, expl)
    specs = list(args.variants) + (["K1_PHASES=1"] if args.phases else [])
    for spec, lib in build_variants(fr, shape, specs).items():
        got = swapped(fr, shape, lib, lambda: fr.launch(p, a, b, expl))
        err = max(cs._compare(got, ref).values())
        times = {bs: swapped(fr, shape, lib, lambda: cs.avg_time_ms(
            kernel_only(fr, *sub(bs), expl), 20)) for bs in args.batches}
        print(f"[scan] {spec}: vs shipped {err:.2e}; ms a launch (events) " +
              ", ".join(f"B={bs}: {ms:.4f}" for bs, ms in times.items()))
        if spec == "K1_PHASES=1":
            for bs in (1, 4096, min(Bmax, cs.BATCH)):
                go = kernel_only(fr, *sub(bs), expl)
                swapped(fr, shape, lib, go)
                torch.cuda.synchronize()
                read_phases(lib)  # drop the warm-up's stamps
                swapped(fr, shape, lib, go)
                torch.cuda.synchronize()
                cyc = read_phases(lib)
                print(f"  cycles a stage by step, block 0, B={bs}: " + "; ".join(
                    f"{n} {cyc[i] / T:.0f}" for i, n in enumerate(PHASES)))


if __name__ == "__main__":
    main()
