#!/usr/bin/env python3
"""Time the port's fused backward sweep (K3, csrc/fused_stage.cu) on one
CUDA card by batch size and by the kernel's register cap.

Run from the repository root on a machine with a card and nvcc:

    python3 tools/torch_k3_scan.py

It builds copies of the shipped source with ``kStageMinBlocks`` set to 1, 2,
3 and 4 (the minimum resident blocks an SM that ``__launch_bounds__`` asks
for, i.e. the register cap) into ``aligator_tpu_torch/_build/scan``, then
times one sweep at the humanoid shape (nx=36, nu=12, nc=12, N=100, fp32) at
batches of 1 to 8 blocks per SM, each against the plain version.
"""

import ctypes
import pathlib
import re
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from aligator_tpu_torch import _build  # noqa: E402
from aligator_tpu_torch.gar import fused_stage as fs  # noqa: E402

CAPS = (4, 3, 2, 1)
BATCHES = (1024, 528, 264, 132)


def build_variants():
    src = (_build.CSRC / "fused_stage.cu").read_text()
    out = _build.BUILD_DIR / "scan"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for cap in CAPS:
        cu = out / f"fused_stage_cap{cap}.cu"
        cu.write_text(re.sub(r"constexpr int kStageMinBlocks = \d+;",
                             f"constexpr int kStageMinBlocks = {cap};", src))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(out / f"libfused_stage_cap{cap}.so"), str(cu)]
        procs[cap] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for cap, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(log)
        print(f"cap {cap}:", [ln.strip() for ln in log.splitlines()
                              if "registers" in ln or "spill" in ln][:4])
        libs[cap] = ctypes.CDLL(str(out / f"libfused_stage_cap{cap}.so"))
    return libs


def main():
    if not torch.cuda.is_available():
        print("torch_k3_scan: no CUDA device", file=sys.stderr)
        return 1
    libs = build_variants()
    load = _build.load
    try:
        for B in BATCHES:
            kn, P, p, md, me = cs.convex_knots(B, 100, 36, 12, 12, torch.float32, 5)
            ref = fs.sweep_plain(kn, P, p, md, me)
            for cap, lib in libs.items():
                _build.load = lambda name, lib=lib: lib
                got = fs.sweep(kn, P, p, md, me)
                err = max(cs.rel_err(got[k], ref[k]) for k in fs.FACTOR_FIELDS)
                ms = cs.kernel_ms(lambda: fs.sweep(kn, P, p, md, me), 5, "sweep_kernel")
                print(f"B={B} kStageMinBlocks={cap}: {ms:.3f} ms per sweep, "
                      f"max rel err vs plain {err:.2e}", flush=True)
            del kn, ref
    finally:
        _build.load = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
