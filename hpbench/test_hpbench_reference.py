"""The plain references against answers worked out by hand, and the
benchmark's imports."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpbench.reference import wcc

HOME = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HOME)
PATH = np.array([[0, 1], [1, 2], [2, 3]])               # 0 -> 1 -> 2 -> 3
CYCLE = np.array([[0, 1], [1, 2], [2, 0]])
STAR = np.array([[0, 1], [0, 2], [0, 3], [1, 0], [2, 0], [3, 0]])


def test_wcc_path_cycle_and_star():
    np.testing.assert_array_equal(wcc.labels(PATH, 4).numpy(), [0] * 4)
    np.testing.assert_array_equal(wcc.labels(CYCLE, 3).numpy(), [0] * 3)
    np.testing.assert_array_equal(wcc.labels(STAR, 4).numpy(), [0] * 4)


def test_wcc_is_weak_and_keeps_components_apart():
    # arcs point away from the least id: 3 -> 2 -> 1 and 6 -> 5; 4 and 0
    # alone
    e = np.array([[3, 2], [2, 1], [6, 5]])
    np.testing.assert_array_equal(wcc.labels(e, 7).numpy(),
                                  [0, 1, 1, 1, 4, 5, 5])
    # a long path numbered against its arcs settles too
    n = 300
    path = np.stack([np.arange(n - 1, 0, -1), np.arange(n - 2, -1, -1)], 1)
    assert (wcc.labels(path, n + 1).numpy() == [0] * n + [n]).all()


def test_wcc_in_bfloat16_rounds_the_ids():
    # 257 is not a bfloat16 number: a component whose least id it is reads
    # 256 (round to even), the way the control reads it
    e = np.array([[257, 300], [300, 257]])
    lab = wcc.labels(e, 301, dtype=torch.bfloat16)
    assert lab.dtype == torch.bfloat16
    assert float(lab[300]) == 256.0 and float(lab[257]) == 256.0
    assert float(lab[3]) == 3.0


_PROBE = """
import importlib, importlib.util, json, pathlib, sys
sys.path[:0] = [{root!r}, {src!r}]
home = pathlib.Path({home!r})
names = []
for p in sorted(home.rglob("*.py")):
    rel = p.relative_to(home.parent)
    if p.name.startswith("test_") or p.name == "conftest.py":
        continue
    if p.parent.name == "metrics":
        sp = importlib.util.spec_from_file_location("m_" + p.stem.replace(".", "_"), p)
        sp.loader.exec_module(importlib.util.module_from_spec(sp))
    else:
        mod = ".".join(rel.with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))
    names.append(str(rel))
# what the harness imports inside its functions
for mod in ("repro_torch", "repro_torch.obs.trace",
            "repro_torch.kernels.build", "repro_torch.kernels.common",
            "repro_torch.kernels.ell_spmv", "repro_torch.kernels.min_step",
            "repro_torch.core.runtime", "torch.profiler"):
    importlib.import_module(mod)
print(json.dumps([names, sorted({{m.split(".")[0] for m in sys.modules}})]))
"""


def _probe(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_module_loads_jax_or_the_jax_package():
    """Every module under hpbench/, imported in a fresh process, loads none
    of jax, jaxlib, flax and repro (compared by whole top-level name)."""
    names, tops = _probe(_PROBE.format(root=ROOT, src=os.path.join(ROOT,
                                                                   "src"),
                                       home=HOME))
    assert "hpbench/harness.py" in names and len(names) > 20
    assert "repro_torch" in tops            # the port loads, not its JAX
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)


@pytest.mark.parametrize("name", ["wcc"])
def test_reference_loads_nothing_of_the_port(name):
    code = (f"import sys, json; sys.path[:0] = [{ROOT!r}]; "
            f"import hpbench.reference.{name}; "
            f"print(json.dumps([0, sorted({{m.split('.')[0] "
            f"for m in sys.modules}})]))")
    tops = set(_probe(code)[1])
    assert not {"repro_torch", "repro", "jax", "jaxlib"} & tops
