"""Build-on-first-use loader for the CUDA C++ kernels.

Counterpart of apex_tpu/csrc/__init__.py's pattern (compile the
checkout's sources at first use, bind with ctypes), with one difference
that matters: there is NO pure-Python fallback.  A kernel that does not
build or load raises; the caller never silently runs something else.

Each `<name>.cu` in this directory exposes a plain C interface and is
compiled on its own into `build/lib<name>-<hash>.so` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -shared -Xcompiler -fPIC -Xptxas=-v

(sm_90a: Hopper with its architecture-specific features).  The file
name carries a hash of the source, of every header of this directory it
includes (its local `#include "..."` lines, followed through the headers
they include) and of the flags, so an edited kernel or shared header
(`hopper.cuh`) is rebuilt and a stale library is never loaded.  nvcc's output, including
ptxas' register and shared-memory report, is kept beside the library
as `<name>.log`.  `build()` starts one nvcc per source, all together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# a launcher's return code at or above this is hopper.cuh's
# kTensorMapError: cuTensorMapEncodeTiled refused a TMA tensor map, its
# CUresult added
TENSOR_MAP_ERROR = 100000

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use")


def source_path(name: str) -> str:
    return os.path.join(_DIR, f"{name}.cu")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def local_includes(path: str) -> list:
    """The files that `path` includes by `#include "..."`, directly or
    through another such file, as paths beside the including file, in
    the order first reached."""
    seen, todo = [], [path]
    while todo:
        cur = todo.pop(0)
        with open(cur, "rb") as f:
            text = f.read()
        for m in _LOCAL_INCLUDE.finditer(text):
            inc = os.path.normpath(os.path.join(
                os.path.dirname(cur), m.group(1).decode()))
            if inc not in seen:
                seen.append(inc)
                todo.append(inc)
    return seen


def _so_path(name: str) -> str:
    h = hashlib.sha1()
    for path in [source_path(name)] + local_includes(source_path(name)):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def log_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}.log")


def build(names: Iterable[str]) -> None:
    """Compile every named source whose library is not built yet, one
    nvcc process per source, all started together; raises
    `KernelBuildError` naming each source that failed."""
    todo = [n for n in names if not os.path.exists(_so_path(n))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = f"{_so_path(n)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(n)]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        with open(log_path(n), "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, _so_path(n))
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `<name>.cu`, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_so_path(name))
            _LIBS[name] = lib
        return lib
