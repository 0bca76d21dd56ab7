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

The host runtime (`host_runtime.cpp`, a copy of the JAX package's) is
not CUDA: `host_library()` builds it at first use with the host's

    g++ -O3 -shared -fPIC -std=c++17 -pthread

into `build/libhost_runtime-<hash>.so` (the hash of the source and the
flags), and `available`, `flat_layout`, `chunk_plan`, `shuffle_indices`
and `gather_rows` call it.  As with the kernels there is no fallback:
a library that does not build raises `HostBuildError`.  Several
processes may build at once (test workers): each writes its own
temporary file and renames it into place, so none loads a half-written
library.
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

import numpy as np

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


def _hashed_so(source: str, flags) -> str:
    """`build/lib<stem>-<hash>.so`, the hash over `source`, the files it
    includes by `#include "..."` and the compiler's `flags`."""
    h = hashlib.sha1()
    for path in [source] + local_includes(source):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:12]}.so")


def _so_path(name: str) -> str:
    return _hashed_so(source_path(name), NVCC_FLAGS)


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


# --- the host runtime ---------------------------------------------------------

HOST_SOURCE = os.path.join(_DIR, "host_runtime.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_HOST = None


class HostBuildError(RuntimeError):
    """g++ is missing or refused the host runtime."""


def host_so_path() -> str:
    return _hashed_so(HOST_SOURCE, GXX_FLAGS)


def build_host() -> str:
    """Compile the host runtime unless it is built; returns the
    library's path.  g++'s output is kept as `build/host_runtime.log`."""
    so = host_so_path()
    if os.path.exists(so):
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise HostBuildError("g++ not found on PATH: the host runtime is "
                             "built from source at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, HOST_SOURCE, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    log = os.path.join(BUILD_DIR, "host_runtime.log")
    with open(f"{log}.{os.getpid()}.tmp", "w") as f:
        f.write(proc.stdout)
    os.replace(f"{log}.{os.getpid()}.tmp", log)
    if proc.returncode != 0:
        raise HostBuildError(f"g++ failed for host_runtime.cpp (exit "
                             f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, so)
    return so


def host_library() -> ctypes.CDLL:
    """The loaded host runtime, built at first use."""
    global _HOST
    with _LOCK:
        if _HOST is None:
            lib = ctypes.CDLL(build_host())
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.flat_layout.restype = ctypes.c_int64
            lib.flat_layout.argtypes = [i64p, ctypes.c_int64,
                                        ctypes.c_int64, i64p]
            lib.chunk_plan.restype = ctypes.c_int64
            lib.chunk_plan.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                       i64p, ctypes.c_int64]
            lib.shuffle_indices.restype = None
            lib.shuffle_indices.argtypes = [ctypes.c_int64, ctypes.c_uint64,
                                            i64p]
            for name, ctype in (("gather_rows_f32", ctypes.c_float),
                                ("gather_rows_i32", ctypes.c_int32)):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [ctypes.POINTER(ctype), ctypes.c_int64, i64p,
                               ctypes.c_int64, ctypes.POINTER(ctype),
                               ctypes.c_int64]
            _HOST = lib
        return _HOST


def available() -> bool:
    """True when the host runtime builds and loads here."""
    try:
        host_library()
    except (HostBuildError, OSError):
        return False
    return True


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def flat_layout(sizes, align: int = 1):
    """(offsets, padded_total): each size's offset in a flat buffer whose
    entries are padded to multiples of `align` elements."""
    sizes = np.ascontiguousarray(sizes, np.int64)
    lib = host_library()
    out = np.empty(len(sizes), np.int64)
    total = lib.flat_layout(_i64p(sizes), len(sizes), align, _i64p(out))
    return out, int(total)


def chunk_plan(sizes, chunk_size: int):
    """(n, 3) int64 work items (tensor index, offset in it, length):
    each size cut into pieces of at most `chunk_size` (the chunk
    metadata of multi_tensor_apply)."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    sizes = np.ascontiguousarray(sizes, np.int64)
    max_items = int(sum(-(-int(s) // chunk_size) for s in sizes)) + 1
    lib = host_library()
    out = np.empty((max_items, 3), np.int64)
    n = lib.chunk_plan(_i64p(sizes), len(sizes), chunk_size, _i64p(out),
                       max_items)
    if n < 0:
        raise RuntimeError("chunk_plan: the work-item table overflowed")
    return out[:n]


def shuffle_indices(n: int, seed: int):
    """A deterministic Fisher-Yates permutation of [0, n) (xorshift128+
    from `seed`): the JAX package's C++ bits."""
    out = np.empty(n, np.int64)
    host_library().shuffle_indices(n, seed, _i64p(out))
    return out


def gather_rows(dataset: np.ndarray, indices, num_threads: int = 4):
    """batch[b] = dataset[indices[b]] for a float32 or int32 dataset, by
    `num_threads` threads (the host data loader's hot path)."""
    indices = np.ascontiguousarray(indices, np.int64)
    dataset = np.ascontiguousarray(dataset)
    if dataset.dtype not in (np.float32, np.int32):
        raise TypeError(f"gather_rows: a float32 or int32 dataset, got "
                        f"{dataset.dtype}")
    if dataset.ndim < 1 or indices.ndim != 1:
        raise ValueError(f"gather_rows: dataset of shape {dataset.shape}, "
                         f"indices of shape {indices.shape}")
    if len(indices) and (indices.min() < 0
                         or indices.max() >= dataset.shape[0]):
        raise IndexError(f"gather_rows: an index outside [0, "
                         f"{dataset.shape[0]})")
    lib = host_library()
    out = np.empty((len(indices),) + dataset.shape[1:], dataset.dtype)
    row_len = int(np.prod(dataset.shape[1:]))
    if dataset.dtype == np.float32:
        fn, ctype = lib.gather_rows_f32, ctypes.c_float
    else:
        fn, ctype = lib.gather_rows_i32, ctypes.c_int32
    fn(dataset.ctypes.data_as(ctypes.POINTER(ctype)), row_len,
       _i64p(indices), len(indices),
       out.ctypes.data_as(ctypes.POINTER(ctype)), num_threads)
    return out
