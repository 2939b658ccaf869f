"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, which is loaded with ``ctypes``.
A *variant* is a source and a tuple of preprocessor defines (``"K=V"``
strings, passed as ``-DK=V``): a source templated on its dimensions builds
one library per shape that is launched (``fused_riccati.cu``). The
library's file name carries a hash of the source, the headers, the flags
and the defines, so an edited source is rebuilt, an unchanged one is
reused and two shapes never share a library. Variants are built in
parallel, one ``nvcc`` process each, at their first launch; nothing is
built at import time. ``LAUNCHES`` counts every kernel's launches by name.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[tuple, ctypes.CDLL] = {}
# per-variant build record, by label(): seconds taken (0.0 when reused)
# and nvcc's log
BUILD_LOG: dict[str, tuple[float, str]] = {}
# launches by kernel name (the ``kernel`` of :func:`run`), counted where a
# launcher runs; a CUDA graph's replay adds what its capture recorded
# (``solvers.proxddp._TrialGraph``)
LAUNCHES: collections.Counter = collections.Counter()


def variant(v) -> tuple[str, tuple[str, ...]]:
    """``(name, defines)`` from a source name or a ``(name, defines)`` pair."""
    if isinstance(v, str):
        return v, ()
    name, defines = v
    return name, tuple(defines)


def label(v) -> str:
    """A variant's name in logs: ``name`` or ``name[K=V,...]``."""
    name, defines = variant(v)
    return f"{name}[{','.join(defines)}]" if defines else name


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of aligator_tpu_torch cannot be built"
    )


def _library_path(v) -> pathlib.Path:
    name, defines = variant(v)
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update("\0".join(defines).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(variants) -> None:
    """Compile the variants (source names or ``(name, defines)`` pairs) that
    have no current library, in parallel.

    Raises ``RuntimeError`` with nvcc's output if any compilation fails.
    """
    variants = list(dict.fromkeys(variant(v) for v in variants))
    with _lock:
        todo = [v for v in variants if not _library_path(v).exists()]
        for v in variants:
            if v not in todo:
                BUILD_LOG.setdefault(label(v), (0.0, ""))
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        t0 = time.perf_counter()
        for v in todo:
            out = _library_path(v)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in v[1]), "-o", str(tmp),
                   str(CSRC / f"{v[0]}.cu")]
            procs.append((v, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for v, out, tmp, p in procs:
            log, _ = p.communicate()
            BUILD_LOG[label(v)] = (time.perf_counter() - t0, log)
            if p.returncode != 0:
                failed.append(f"--- nvcc {label(v)} (exit {p.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str, defines=()) -> ctypes.CDLL:
    """Return the loaded library of the variant ``(name, defines)`` of
    ``csrc/<name>.cu``, building it first if it has none (a library that
    exists loads without the build lock, which a build of other variants in
    another thread may hold)."""
    v = variant((name, defines))
    lib = _loaded.get(v)
    if lib is None:
        path = _library_path(v)
        if not path.exists():
            build([v])
        lib = _loaded[v] = ctypes.CDLL(str(path))
    return lib


def c_function(name: str, symbol: str, n_int: int, n_ptr: int, defines=()):
    """The C function ``symbol`` of the variant ``(name, defines)`` of
    ``csrc/<name>.cu`` taking ``n_int`` ints then ``n_ptr`` pointers (the
    stream last) and returning a CUDA error code."""
    fn = getattr(load(name, defines), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * n_int + [ctypes.c_void_p] * n_ptr
    return fn


def run(fn, device, *args, kernel: str) -> None:
    """Call a C launcher with ``args`` and the current stream of ``device``,
    counting one launch of ``kernel`` in ``LAUNCHES``; raise if it refuses
    the dimensions (it returns -1) or returns a CUDA error."""
    import torch

    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err == -1:
        raise ValueError(f"{kernel} kernel does not take these dimensions")
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
