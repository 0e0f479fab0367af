"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/lib<name>_<hash>.so csrc/<name>.cu

Some sources add flags of their own (``SOURCE_FLAGS``).  The library's file
name carries a hash of its source, every header in ``csrc/`` and its flags,
so an edited source or header never loads a stale build.  Builds happen at first use (``load``), or
all at once and in parallel (``build_all``); nothing is built at import.
The build directory is ``build/kernels`` at the root of the checkout.

Several processes may load a kernel for the first time at once (the ranks
of a sharded solve): ``build_all`` holds an exclusive ``flock`` on
``build/kernels/.lock`` while it checks and compiles, so one process
compiles and the others find its library, and nvcc writes to a temporary
name that ``os.replace`` moves into place, so no process loads half a
library.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {
    "ell_spmv": "ell_spmv.cu",
    "fused_ell_sweep": "fused_ell_sweep.cu",
    "block_diag_matvec": "block_diag_matvec.cu",
    "edge_reweight": "edge_reweight.cu",
    "flash_fwd": "flash_fwd.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# flags of one source beyond NVCC_FLAGS: the attention kernel finds the
# driver's cuTensorMapEncodeTiled with dlopen
SOURCE_FLAGS = {"flash_fwd": ("-ldl",)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME/bin`` (default /usr/local/cuda), else PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def flags(name: str) -> tuple:
    """nvcc's flags for kernel ``name``: the common ones, then its own."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is built: the name hashes its source,
    every ``*.cuh`` in ``csrc/`` (a source may include any of them) and its
    flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _build_lock():
    """Exclusive lock on the build directory, across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel that has no current build, one nvcc per
    source, all started together, under the build directory's lock.
    Returns ``{name: {"seconds", "log"}}`` for the sources compiled
    (``log`` is nvcc's output: ptxas register and shared-memory use, kept
    beside the library for ``build_log``).  Raises with the compiler's
    output on a failure."""
    names = list(SOURCES if names is None else names)
    with _build_lock():
        return _compile(names)


def _compile(names) -> Dict[str, dict]:
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        # a source's own flags (libraries) after the source, for the linker
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name]), *SOURCE_FLAGS.get(name, ())]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def build_log(name: str) -> str:
    """nvcc's output for the current build of kernel ``name`` ("" if it was
    built before its log was kept, or not at all)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
