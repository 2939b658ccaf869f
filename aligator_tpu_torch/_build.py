"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, which is loaded with ``ctypes``.
The library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused. Sources are built
in parallel, one ``nvcc`` process each. Nothing is built at import time.
"""

from __future__ import annotations

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
_loaded: dict[str, ctypes.CDLL] = {}
# per-source build record: seconds taken (0.0 when reused) and nvcc's log
BUILD_LOG: dict[str, tuple[float, str]] = {}


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


def _library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile the named sources that have no current library, in parallel.

    Raises ``RuntimeError`` with nvcc's output if any compilation fails.
    """
    with _lock:
        todo = [n for n in names if not _library_path(n).exists()]
        for n in names:
            if n not in todo:
                BUILD_LOG.setdefault(n, (0.0, ""))
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        t0 = time.perf_counter()
        for n in todo:
            out = _library_path(n)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for n, out, tmp, p in procs:
            log, _ = p.communicate()
            BUILD_LOG[n] = (time.perf_counter() - t0, log)
            if p.returncode != 0:
                failed.append(f"--- nvcc {n}.cu (exit {p.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library of ``csrc/<name>.cu``, building it first."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(_library_path(name)))
    return lib


def c_function(name: str, symbol: str, n_int: int, n_ptr: int):
    """The C function ``symbol`` of ``csrc/<name>.cu`` taking ``n_int`` ints
    then ``n_ptr`` pointers (the stream last) and returning a CUDA error
    code."""
    fn = getattr(load(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * n_int + [ctypes.c_void_p] * n_ptr
    return fn


def run(fn, device, *args, what: str) -> None:
    """Call a C launcher with ``args`` and the current stream of ``device``;
    raise if it refuses the dimensions (it returns -1) or returns a CUDA
    error."""
    import torch

    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err == -1:
        raise ValueError(f"{what} kernel does not take these dimensions")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
