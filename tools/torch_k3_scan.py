#!/usr/bin/env python3
"""Time the port's fused backward sweep (K3, csrc/fused_stage.cu) on one
CUDA card by batch size and by the kernel's register cap, and optionally
where a stage's time goes.

Run from the repository root on a machine with a card and nvcc:

    python3 tools/torch_k3_scan.py [--caps 4 5] [--phases]

It builds copies of the shipped source with ``kStageMinBlocks`` set to each
cap (the resident blocks an SM that ``__launch_bounds__`` asks for, i.e. a
register cap of 65536 / (128 * cap)) into ``aligator_tpu_torch/_build/scan``
and times one sweep at the humanoid shape (nx=36, nu=12, nc=12, N=100, fp32)
at batches of 1, 132, 528 and 1024, each checked against the shipped build.
With ``--phases`` each copy also stamps ``clock64()`` after every block-wide
barrier of the stage loop (block 0, thread 0) and prints the cycles a stage
spends in each step, at batches of 1, 132 and 1024. ptxas's registers and
spills and each kernel's instruction count (cuobjdump) are printed too.
"""

import argparse
import ctypes
import dataclasses
import pathlib
import re
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from aligator_tpu_torch import _build  # noqa: E402
from aligator_tpu_torch.gar import fused_stage as fs  # noqa: E402

B, N, NX, NU, NC = 1024, 100, 36, 12, 12
BATCHES = (1, 132, 528, 1024)

STAMP = r"""
__device__ unsigned long long g_phase[16];
#define PHASE() do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
  const long long now = clock64(); g_phase[ph_i++ & 15] += now - ph_t; ph_t = now; } } while (0)
"""
READ = r"""
extern "C" int read_phases(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long zero[16] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase, zero, sizeof(zero)));
}
"""


def variant_source(cap, phases):
    src = (_build.CSRC / "fused_stage.cu").read_text()
    src, k = re.subn(r"constexpr int kStageMinBlocks = \d+;",
                     f"constexpr int kStageMinBlocks = {cap};", src)
    assert k == 1, "kStageMinBlocks not found"
    if phases:
        a = src.index("sweep_kernel(const int T")
        b = src.index("// ------------------------------------------------------------ K4")
        body = src[a:b]
        body = body.replace("const S nan = aligator::qnan<S>();",
                            "const S nan = aligator::qnan<S>();\n  long long ph_t = clock64();"
                            " int ph_i = 0;", 1)
        body = body.replace("for (int t = N - 1; t >= 0; --t) {",
                            "for (int t = N - 1; t >= 0; --t) {\n    ph_i = 0;", 1)
        body = body.replace("__syncthreads();", "__syncthreads(); PHASE();")
        src = src[:a] + body + src[b:]
        src = src.replace("namespace {", STAMP + "namespace {", 1) + READ
    return src


def build(caps, phases):
    out = _build.BUILD_DIR / "scan"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for cap in caps:
        name = f"cap{cap}" + ("_phases" if phases else "")
        cu = out / f"fused_stage_{name}.cu"
        cu.write_text(variant_source(cap, phases))
        so = out / f"libfused_stage_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: build failed\n{log}")
            continue
        print(f"{name}:", [line.strip() for line in log.splitlines()
                           if "sweep_kernel" not in line and ("registers" in line or "spill" in line)])
        if shutil.which("cuobjdump"):
            sass = subprocess.run(["cuobjdump", "-sass", str(so)], capture_output=True,
                                  text=True).stdout
            counts, cur = {}, None
            for line in sass.splitlines():
                if "Function :" in line:
                    cur = re.sub(r".*_kernelI([df])E.*", r"\1", line)
                    cur = ("sweep " if "sweep_kernel" in line else "forward ") + cur
                    counts[cur] = 0
                elif cur and line.strip().startswith("/*") and ";" in line:
                    counts[cur] += 1
            print(f"  instructions: {counts}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--caps", type=int, nargs="+", default=[4, 5])
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    libs = build(args.caps, args.phases)

    kn, P, p, md, me = cs.convex_knots(B, N, NX, NU, NC, torch.float32, cs.SEED + 20)
    ref = fs.sweep(kn, P, p, md, me)

    def runner(lib, bs):
        sub = dataclasses.replace(kn, **{f.name: getattr(kn, f.name)[:bs]
                                         for f in dataclasses.fields(kn)})
        out = fs.factor_buffers(sub.Q, N, NU, NC)
        ins = [getattr(sub, k).contiguous() for k in fs.STAGE_FIELDS] + [
            P[:bs], p[:bs], md[:bs], me[:bs]]
        ptrs = fs._pointers(ins + [out[k] for k in fs.FACTOR_FIELDS])
        fn = lib.fused_sweep_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2

        def go():
            err = fn(bs, N + 1, N, NX, NU, NC, ptrs, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        return go, out

    for name, lib in libs.items():
        go, out = runner(lib, B)
        go()
        torch.cuda.synchronize()
        err = max(cs.rel_err(out[k], ref[k]) for k in fs.FACTOR_FIELDS)
        times = {bs: cs.avg_time_ms(runner(lib, bs)[0], 3) for bs in BATCHES}
        print(f"{name}: vs shipped {err:.2e}; ms " +
              ", ".join(f"B={bs}: {ms:.3f}" for bs, ms in times.items()))
        if args.phases:
            rd = lib.read_phases
            rd.argtypes = [ctypes.c_void_p]
            buf = (ctypes.c_ulonglong * 16)()
            for bs in (1, 132, B):
                go, _ = runner(lib, bs)
                go()
                torch.cuda.synchronize()
                rd(buf)  # drop the warm-up's stamps
                go()
                torch.cuda.synchronize()
                rd(buf)
                # the stamp after the pre-loop barrier lands in slot 0 once
                print(f"  cycles a stage in steps 1-8, block 0, B={bs}:",
                      [round(v / N) for v in list(buf)[:8]])


if __name__ == "__main__":
    main()
