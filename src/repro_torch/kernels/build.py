"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher.  At first
use, one ``nvcc`` per source (all started together) compiles it for
``sm_90a`` into a shared library under ``build/repro_torch_kernels/<hash>/``
at the repository root, keyed by a hash of the sources and flags, and
``ctypes`` loads it.  Nothing is built when the package is imported: the
CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["KERNELS", "NVCC_FLAGS", "build_dir", "build", "load", "bind"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
KERNELS = ("ell_spmv", "min_step", "pr_step", "graph_loop")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``<repo>/build/repro_torch_kernels/<hash of sources and flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return CSRC.parents[2] / "build" / "repro_torch_kernels" / h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build(names=KERNELS) -> dict[str, str]:
    """Compile every kernel of ``names`` not built yet, one ``nvcc`` each,
    all in parallel.  Returns ``{name: ptxas report}`` for those compiled
    now; raises with the compiler's output when one fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out / f"lib{n}.so").exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {n}.cu:\n{log}")
            continue
        os.replace(tmp, out / f"lib{n}.so")
        logs[n] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first
    if this one is not built yet."""
    lib = _LIBS.get(name)
    if lib is None:
        so = build_dir() / f"lib{name}.so"
        if not so.exists():
            build()
        lib = _LIBS[name] = ctypes.CDLL(str(so))
    return lib


def bind(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """Launcher ``symbol`` of kernel ``name`` with its C signature declared
    (``c_void_p`` for every pointer and the stream, so none is cut to 32
    bits); every launcher returns a ``cudaError_t`` as ``int``."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
