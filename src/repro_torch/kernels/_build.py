"""Build the CUDA sources in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library,
``build/repro_torch_kernels/<name>-<hash>.so`` under the checkout root
(``build/`` is git-ignored). The hash covers the source and the flags, so
an edited kernel is rebuilt and a stale library is never loaded.
``build_all`` starts one ``nvcc`` per source, all at once, and waits for
every one of them. Nothing here runs at import: a host without ``nvcc``
imports this module and fails only when a kernel is asked for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("multpath_mm", "centpath_mm", "segment_relax", "child_count")
# No --use_fast_math: the kernels rely on exact IEEE inf arithmetic and on
# bitwise-equal weights. -Xptxas=-v reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")
    if not Path(nvcc).is_file():
        raise RuntimeError("nvcc not found (neither on PATH nor under "
                           "$CUDA_HOME/bin): the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source of ``names`` that is not built yet.

    One ``nvcc`` per source, all started together. Returns each compiled
    source's compiler output; raises if any build fails.
    """
    todo = [name for name in names if not library_path(name).is_file()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs: Dict[str, str] = {}
    failed = []
    try:
        for name in todo:
            tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp.so"
            procs[name] = (subprocess.Popen(
                nvcc_command(nvcc, name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp)
        for name, (proc, tmp) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(name)
            else:
                # Atomic: a concurrent loader sees the old state or the
                # whole library, never a half-written one.
                os.replace(tmp, library_path(name))
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[name] for name in failed))
    return logs


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<name>.cu``, built if needed,
    with its ``argtypes`` set and an int (cudaError_t) return."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
