"""The port stands alone: importing ``repro_torch`` and every module of the
slice loads neither ``jax`` nor any module of the reference package, and
builds no kernel."""

import os
import subprocess
import sys

import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")

# the graph I/O, checkpoint, fault-tolerance, observability, serving,
# distributed, LM-substrate and sharding / launch modules: each must be
# found by the walk below, and import clean like the rest
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
    "repro_torch.sharding", "repro_torch.sharding.rules",
    "repro_torch.sharding.util", "repro_torch.sharding.fsdp",
    "repro_torch.launch", "repro_torch.launch.mesh",
    "repro_torch.launch.specs", "repro_torch.launch.dryrun",
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


def _nccl_train_rank(rank, world, group, device, cfg, state, batches):
    """The tiny sharded train step on a (2, world/2) mesh of cards."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import shard_module
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.sharding.fsdp import gather_full, sharding_of
    from repro_torch.sharding.rules import batch_spec, param_specs
    from repro_torch.sharding.util import named, place_tree, sanitize_specs
    from repro_torch.train.trainer import make_train_step
    mesh = make_host_mesh(2, world // 2, device_type="cuda")
    api = get_model(cfg)
    model = api.init(torch.Generator(), cfg, torch.float32, "cpu")
    model.load_state_dict(state)
    model = shard_module(model, named(sanitize_specs(
        param_specs(model), model, mesh), mesh), device)
    opt = adamw_init(model)
    step = make_train_step(cfg, api, peak_lr=1e-3, warmup=2, total_steps=10)
    for s, batch in enumerate(batches):
        shard = named(sanitize_specs(batch_spec(batch), batch, mesh), mesh)
        model, opt, m = step(model, opt, place_tree(batch, shard, device), s)
    return {k: gather_full(p._local_tensor, sharding_of(p)).cpu()
            for k, p in model.named_parameters()}


@pytest.mark.gpu
def test_sharded_train_over_nccl_one_rank_per_card():
    """Three steps of the tiny dense model sharded over (2, 2) cards, one
    rank per card over NCCL, against the one-process step on the first
    card (float32 reassociation of the data ranks' gradient sum)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices, one rank per card")
    from repro_torch.configs.lm_smoke import SMOKE_FAMILIES
    from repro_torch.core.distributed import spawn_ranks
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import make_train_step
    cfg = SMOKE_FAMILIES["dense_gqa"]
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(1)
    batches = [{k: torch.randint(0, cfg.vocab, (8, 16), generator=g)
                for k in ("tokens", "labels")} for _ in range(3)]
    got = spawn_ranks(_nccl_train_rank, 4, "nccl", "cuda",
                      args=(cfg, state, batches), deadline_s=300.0)
    model = model.to("cuda")
    opt = adamw_init(model)
    step = make_train_step(cfg, api, peak_lr=1e-3, warmup=2, total_steps=10)
    for s, batch in enumerate(batches):
        model, opt, _ = step(model, opt, {k: v.cuda() for k, v in
                                          batch.items()}, s)
    for k, p in model.named_parameters():
        for rank in got:
            torch.testing.assert_close(rank[k], p.detach().cpu(), atol=1e-5,
                                       rtol=0)
