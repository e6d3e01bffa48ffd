"""Builds copies of the kernel sources with ``constexpr`` values set, for
the A/B tools (``tools/ab_lanes.py``, ``tools/ab_ppr_lanes.py``).

A job is ``(variant, source) -> (csrc_dir, edits)``: ``csrc_dir``'s
``.cu``/``.cuh`` files are copied into ``OUT/variant-source/``, each edit
``(file, name, value)`` rewrites the one ``constexpr ... name = ...;`` of
``file`` to ``value``, and ``source.cu`` is built with the package's nvcc
flags.  Every job's nvcc runs at once.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess


def set_constexpr(path: str, name: str, value: str) -> None:
    """Rewrites ``constexpr <type> name = ...;`` in ``path`` to ``value``;
    raises unless ``path`` defines ``name`` exactly once."""
    text = open(path).read()
    pat = rf"(constexpr \w+ {name} = )[^;]+;"
    if len(re.findall(pat, text)) != 1:
        raise RuntimeError(f"{os.path.basename(path)} no longer defines {name}")
    with open(path, "w") as f:
        f.write(re.sub(pat, rf"\g<1>{value};", text))


def build_variants(out: str, jobs: dict) -> dict:
    """``{variant: {source: CDLL}}`` of ``jobs`` (see the module's doc);
    raises with nvcc's output on a failure."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    procs = {}
    for (variant, src), (csrc, edits) in jobs.items():
        d = os.path.join(out, f"{variant}-{src}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in os.listdir(csrc):
            if f.endswith((".cu", ".cuh")):
                shutil.copy(os.path.join(csrc, f), d)
        for fname, name, value in edits:
            set_constexpr(os.path.join(d, fname), name, value)
        so = os.path.join(d, f"lib{src}.so")
        procs[variant, src] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", so, os.path.join(d, f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (variant, src), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant} {src}:\n{log}")
        libs.setdefault(variant, {})[src] = ctypes.CDLL(so)
    return libs
