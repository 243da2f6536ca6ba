"""Build ``csrc/*.cu`` with ``nvcc`` into one shared library and bind it
with ``ctypes``.

The sources have a plain C interface (no PyTorch headers), so the build
takes seconds.  It runs at first use, from the sources in the package and
nothing else: one ``nvcc -c`` per source, all started together, then one
link.  The library lands in ``build/repro_torch/`` at the root of the
checkout, under a name that carries a hash of the sources and flags, so a
changed source is never served by a stale library.  A failed build raises;
nothing here falls back to another implementation.

Every C entry point takes raw pointers (``tensor.data_ptr()``), sizes as
``int`` and the CUDA stream last, launches its kernel on that stream
without synchronising, and returns ``cudaGetLastError()``; ``check`` turns
a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Optional, Sequence, Tuple

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3]
             / "build" / "repro_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_entries: Dict[str, ctypes._CFuncPtr] = {}
# Seconds the build took in this process (0.0 when the library was found
# already built, None before the first load).
build_seconds: Optional[float] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found (looked on PATH and under CUDA_HOME / "
        "/usr/local/cuda): the CUDA kernels cannot be built")


def sources() -> Tuple[pathlib.Path, ...]:
    return tuple(sorted(CSRC.glob("*.cu")))


def _digest(srcs: Sequence[pathlib.Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: Sequence[Sequence[str]]) -> None:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failures = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def build() -> pathlib.Path:
    """Compile the sources (if this exact set is not built yet) and return
    the path of the shared library."""
    global build_seconds
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    lib_path = BUILD_DIR / f"libranky_kernels_{_digest(srcs)}.so"
    if lib_path.exists():
        if build_seconds is None:
            build_seconds = 0.0
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    obj_dir = BUILD_DIR / f"obj_{lib_path.stem}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    try:
        objs = [obj_dir / (src.stem + ".o") for src in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(srcs, objs)])
        tmp = obj_dir / lib_path.name
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, lib_path)   # atomic: never a half-written library
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def entry(name: str, argtypes: Sequence[type]):
    """The C function ``name`` with its argument types declared.  Pointers
    and the stream MUST be ``ctypes.c_void_p``: an undeclared Python int
    is passed as a 32-bit int and the pointer is cut silently."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise when a launch was refused (``cudaGetLastError() != 0``)."""
    if code != 0:
        raise RuntimeError(
            f"{what}: the kernel launch failed with CUDA error {code}")
