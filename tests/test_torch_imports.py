"""The port stands alone: importing ``repro_torch`` and every module of the
slice loads neither ``jax`` nor any module of the reference package, and
builds no kernel."""

import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")

# the graph I/O, checkpoint, fault-tolerance, observability, serving,
# distributed and LM-substrate modules: each must be found by the walk
# below, and import clean like the rest
IO_FT_MODULES = (
    "repro_torch.obs", "repro_torch.obs.clock", "repro_torch.obs.metrics",
    "repro_torch.obs.export", "repro_torch.obs.trace",
    "repro_torch.obs.report", "repro_torch.serve",
    "repro_torch.serve.engine",
    "repro_torch.io", "repro_torch.io.readers", "repro_torch.io.format",
    "repro_torch.io.stage", "repro_torch.io.digest",
    "repro_torch.io.pipeline", "repro_torch.io.convert",
    "repro_torch.io.resize",
    "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
    "repro_torch.exec.checkpoint",
    "repro_torch.ft", "repro_torch.ft.heartbeat", "repro_torch.ft.inject",
    "repro_torch.ft.straggler", "repro_torch.ft.elastic",
    "repro_torch.ft.driver",
    "repro_torch.partition.quality", "repro_torch.core.distributed",
    "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.graphhp_paper", "repro_torch.configs.lm_smoke",
    "repro_torch.models", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.moe",
    "repro_torch.models.mamba", "repro_torch.models.stack",
    "repro_torch.models.transformer", "repro_torch.models.registry",
    "repro_torch.data.pipeline", "repro_torch.optim",
    "repro_torch.optim.schedule", "repro_torch.optim.adamw",
    "repro_torch.optim.compression", "repro_torch.train",
    "repro_torch.train.trainer", "repro_torch.core.hybrid_sync",
)

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
missing = sorted(set(%r) - set(mods) - {"repro_torch"})
print(len(mods), bad, missing)
sys.exit(1 if bad or missing or len(mods) < 25 else 0)
""" % (IO_FT_MODULES,)


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


def test_obs_package_loads_only_clock(tmp_path):
    """``import repro_torch.obs`` loads the clock and nothing else of
    ``obs``: tracing, metrics, export and the report load on first use."""
    code = ("import sys, repro_torch.obs as o\n"
            "loaded = sorted(m for m in sys.modules\n"
            "                if m.startswith('repro_torch.obs.'))\n"
            "assert loaded == ['repro_torch.obs.clock'], loaded\n"
            "o.trace.Tracer\n"
            "assert 'repro_torch.obs.trace' in sys.modules\n")
    r = _run(code, tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
