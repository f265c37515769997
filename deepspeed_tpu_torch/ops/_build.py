"""Build and load the port's CUDA kernels.

Each ``ops/csrc/*.cu`` source compiles with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, loaded with ``ctypes``. Builds happen at first use, from
the sources in the checkout only, into ``build/`` at the repository root,
named by a hash of that source, the shared headers and the flags, so a
changed source rebuilds and an unchanged one is reused. A missing ``nvcc``
or a failed build raises: nothing falls back.

The host libraries of the offload tier (``csrc/host/*.cpp``: the host Adam
and the asynchronous file I/O) build the same way with ``g++``
(:func:`load_host`), into the same directory, named by a hash of their
source, the flags and the host CPU's instruction set (``-march=native``).
They sit in a directory of their own, so neither the ``nvcc`` build nor the
``.cu`` libraries' hashes see them. They are the only kernels of the port
that run on the CPU.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

HOST_CSRC = CSRC / "host"
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-march=native",
              "-ffp-contract=off"]

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
    """``build/<stem>-<hash>.so``: the hash covers the flags, this source and
    the shared headers only, so editing one kernel's source rebuilds that
    kernel and no other."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / source] + sorted(p for p in CSRC.iterdir()
                                      if p.suffix in (".cuh", ".h")):
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


def _cpu_features() -> str:
    """The host's CPU flags (``-march=native`` builds for them), so that a
    build directory copied to another machine does not hand it a library
    with instructions its CPU lacks."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.machine() + platform.processor()


def _host_library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(_cpu_features().encode())
    h.update((HOST_CSRC / source).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-host-{h.hexdigest()[:16]}.so"


def build_host(source: str) -> Path:
    """Compile ``source`` (a name under ``ops/csrc/host``) with ``g++`` unless
    it is built already; returns the library path. Concurrent builds each
    write a file of their own and rename it into place. Raises with the
    compiler's output on a failure."""
    out = _host_library_path(source)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the offload tier's host libraries "
                           "are built from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *HOST_FLAGS, str(HOST_CSRC / source), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ {source} exited {proc.returncode}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_host(source: str) -> ctypes.CDLL:
    """The loaded host library of ``source``, building it on first use."""
    key = f"host/{source}"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(source)))
            _libs[key] = lib
        return lib
