"""Builds the port's CUDA kernels from ``ops/csrc/*.cu`` at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``. Libraries land in
``ops/build/`` (listed in ``.gitignore``), named by a hash of the source,
the shared headers ``csrc/*.cuh`` and the flags, so an edited source or
header rebuilds and an unchanged one loads at once. Headers are never
compiled on their own. ``build()`` starts one ``nvcc`` per source, all
together.

Several processes may load the kernels at once (pods sharing a card).
A build holds an exclusive ``flock`` on ``build/lock`` (the kernel drops
it when the process ends, however it ends), and each library lands by an
atomic rename, so a process either finds a whole library or waits for
the one build of it.

There is no fallback: without ``nvcc`` or on a compile error the loader
raises, and the caller's CUDA tensors never reach a substitute.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Where nvcc is looked for after $PATH: $CUDA_HOME, then the toolkit's
# standard install prefix.
NVCC_PREFIXES = (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for prefix in NVCC_PREFIXES:
        if prefix and os.access(os.path.join(prefix, "bin", "nvcc"), os.X_OK):
            return os.path.join(prefix, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda: the "
        "CUDA kernels cannot be built"
    )


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu``, named by a hash of the
    source, every header in ``csrc`` (any source may include one) and the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named source (all of ``csrc`` by default) that has no
    library yet, one ``nvcc`` each, all started together. Returns the
    library paths; raises with the compiler's output on any failure."""
    names = sources() if names is None else names
    out = {n: _target(n) for n in names}
    if all(out[n].exists() for n in names):
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _compile(nvcc, [n for n in names if not out[n].exists()], out)
    return out


def _compile(nvcc: str, todo: list[str], out: dict[str, Path]) -> None:
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the last build of ``name``."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return _libs[name]
