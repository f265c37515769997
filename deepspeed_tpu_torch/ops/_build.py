"""Build and load the port's CUDA kernels.

Each ``ops/csrc/*.cu`` source compiles with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, loaded with ``ctypes``. Builds happen at first use, from
the sources in the checkout only, into ``build/`` at the repository root,
named by a hash of the sources and the flags, so a changed source rebuilds
and an unchanged one is reused. A missing ``nvcc`` or a failed build raises:
nothing falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each source built by
#: this process, by source name
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "port's CUDA kernels are built from source at first "
                           "use and need the CUDA toolkit")
    return found


def _library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):           # the .cu and shared headers
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def _start(source: str, nvcc: str):
    out = _library_path(source)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                             str(CSRC / source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, (proc, tmp)


def build(sources: List[str]) -> Dict[str, Path]:
    """Compile ``sources`` (names under ``ops/csrc``) that are not built
    yet, all ``nvcc`` processes started together; returns each source's
    library path. Raises with the compiler's output on a failure."""
    nvcc = nvcc_path()
    started = {src: _start(src, nvcc) for src in sources}
    errors = []
    for src, (out, job) in started.items():
        if job is None:
            continue
        proc, tmp = job
        log, _ = proc.communicate()
        build_logs[src] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc {src} exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {src: out for src, (out, _) in started.items()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, building it on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build([source])[source]))
            _libs[source] = lib
        return lib
