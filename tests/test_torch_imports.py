"""The port stands alone: importing ``repro_torch`` and every module of the
slice loads neither ``jax`` nor any module of the reference package, and
builds no kernel."""

import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             or m.startswith("jax"))
print(len(mods), bad)
sys.exit(1 if bad or len(mods) < 25 else 0)
"""


def _run(code, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_neither_jax_nor_reference(tmp_path):
    r = _run(_PROBE, tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr


def test_import_builds_no_kernel(tmp_path):
    code = ("import subprocess\n"
            "calls = []\n"
            "subprocess.Popen = lambda *a, **k: calls.append(a)\n"
            "import repro_torch, repro_torch.kernels.ell_spmv, "
            "repro_torch.kernels.min_step, repro_torch.kernels.pr_step\n"
            "from repro_torch.kernels import build\n"
            "import sys; sys.exit(len(calls) + len(build._LIBS))")
    r = _run(code, tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
