"""The port's launch layer on the CPU: the dry run (``repro_torch.launch.
dryrun``) as rank 0 of a ``fake`` process group of the production meshes'
size (256 and 512 ranks) on ``meta`` tensors, and the mesh module.

* Every ``lm_smoke`` family (and its sub-quadratic variant where one
  exists: Mamba, hybrid) through the four shapes' cells on both meshes,
  at reduced sizes of the same kinds: status ``ok`` exactly where
  ``runnable`` says, ``skip`` with its reason elsewhere; per-rank FLOPs,
  argument bytes and collective bytes recorded.  One recorded exception:
  MoE serving cells on the multi-pod mesh fail, as they must — the
  batch's 32 ranks hold 16 dispatch blocks, and a rank does not dispatch
  part of a block (ROADMAP Queue 3).
* The CLI, the graph cell and the sync cell (int8 codes cross the pod
  group: a quarter of the float32 deltas' bytes, plus the scales).
* Sequence parallelism: the residual stream's gathers and a train
  cell's remat carry a unit; ``--seq-parallel``'s ``sp`` tag; a cell on
  a host mesh.
"""

import dataclasses
import json
import os

import pytest
import torch.distributed as dist

from repro_torch.configs.base import SHAPES
from repro_torch.configs.lm_smoke import SMOKE_FAMILIES
from repro_torch.launch import dryrun, mesh as mesh_mod
from repro_torch.launch.specs import runnable

# the four shapes' kinds at sizes that divide the production meshes
SMALL = {"train_4k": dict(seq_len=64, global_batch=32),
         "prefill_32k": dict(seq_len=128, global_batch=32),
         "decode_32k": dict(seq_len=128, global_batch=32),
         "long_500k": dict(seq_len=256, global_batch=1)}
CONFIGS = [*SMOKE_FAMILIES.values(),
           *(dataclasses.replace(SMOKE_FAMILIES[n], name=f"{n}-subq",
                                 sub_quadratic=True)
             for n in ("mamba", "hybrid"))]


@pytest.fixture(scope="module")
def fake():
    """The fake group is this process's default group for the module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi", [False, True])
def test_dryrun_cells_status_as_runnable(fake, multi, tmp_path):
    for cfg in CONFIGS:
        for name, small in SMALL.items():
            shape = dataclasses.replace(SHAPES[name], **small)
            rec = dryrun.run_cell(cfg, shape, multi, str(tmp_path),
                                  verbose=False)
            ok, why = runnable(cfg, shape)
            if not ok:
                assert rec["status"] == "skip" and rec["reason"] == why
                continue
            if multi and cfg.n_experts and shape.kind != "train":
                assert rec["status"] == "fail"
                assert "do not split over 32 batch shards" in rec["error"]
                continue
            assert rec["status"] == "ok", (cfg.name, name,
                                           rec.get("traceback"))
            assert rec["devices"] == (512 if multi else 256)
            assert rec["flops"] > 0 and rec["memory"]["argument_bytes"] > 0
            assert rec["collective_bytes"] > 0     # weights gathered at use
            assert rec["memory"]["peak_bytes"] > rec["memory"][
                "argument_bytes"]
            with open(tmp_path / f"{cfg.name}__{name}__"
                      f"{'multi' if multi else 'single'}.json") as f:
                assert json.load(f)["status"] == "ok"
    assert any(runnable(c, SHAPES["long_500k"])[0] for c in CONFIGS)


def test_multi_pod_train_reduces_inside_the_pod(fake, tmp_path):
    """The multi-pod train cell is the single-pod step with its batch over
    (pod, data): half the rows a rank, half the FLOPs, the same bytes of
    weights and moments a rank."""
    cfg = SMOKE_FAMILIES["dense_gqa"]
    shape = dataclasses.replace(SHAPES["train_4k"], **SMALL["train_4k"])
    one, two = (dryrun.run_cell(cfg, shape, m, str(tmp_path), verbose=False)
                for m in (False, True))
    for k in ("params", "moments"):
        assert one["memory"]["arguments"][k] == \
            two["memory"]["arguments"][k]
    assert two["memory"]["arguments"]["batch"] * 2 == \
        one["memory"]["arguments"]["batch"]
    assert 0.45 < two["flops"] / one["flops"] < 0.55


def test_cli_graph_and_sync_cells(fake, tmp_path):
    out = str(tmp_path / "d")
    assert dryrun.main(["--arch", "dense-gqa-smoke", "--shape",
                        "decode_32k", "--mesh", "single", "--graphhp",
                        "--out", out]) == 0
    recs = {f: json.load(open(os.path.join(out, f)))
            for f in os.listdir(out)}
    assert recs["dense-gqa-smoke__decode_32k__single.json"]["status"] == "ok"
    g = recs["graphhp-paper__hybrid_iteration__single.json"]
    assert g["status"] == "ok" and g["flops"] is None
    assert g["exchange_bytes"] > 0 and g["memory"]["graph_bytes"] > 0
    # --skip-done leaves a finished cell alone
    assert dryrun.main(["--arch", "dense-gqa-smoke", "--shape",
                        "decode_32k", "--mesh", "single", "--skip-done",
                        "--out", out]) == 0
    cfg = SMOKE_FAMILIES["dense_gqa"]
    int8, f32 = (dryrun.run_sync_cell(cfg, str(tmp_path), compress=c)
                 for c in (True, False))
    assert int8["status"] == f32["status"] == "ok"
    assert f32["collective_bytes"] == f32["f32_delta_gather_bytes"]
    # the codes, a quarter of the deltas; a float32 scale per reference
    # leaf from each of the 2 pods, and the leaves' maxima all-reduced
    from repro_torch.core.hybrid_sync import _reference_leaves
    from repro_torch.models.registry import param_shapes
    leaves = len(_reference_leaves(dict(
        param_shapes(cfg).named_parameters())))
    assert int8["collective_bytes"] == f32["collective_bytes"] // 4 \
        + (2 + 1) * 4 * leaves


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_seq_parallel_cells(fake, shape, tmp_path):
    """Sequence parallelism on: the same FLOPs; the residual stream
    gathered once a unit and once after the last (in training also in
    each unit's recompute, and its gradient in the backward of each
    slice); and in training a remat carry a unit that is its slice of the
    stream alone, so a rank's peak is lower.  A 1k sequence: two flash
    chunks, each recomputed in the backward."""
    from repro_torch.sharding.util import seq_parallel
    cfg = SMOKE_FAMILIES["dense_gqa"]
    s = dataclasses.replace(SHAPES[shape], seq_len=1024, global_batch=32)
    base = dryrun.run_cell(cfg, s, False, str(tmp_path), verbose=False)
    with seq_parallel():
        sp = dryrun.run_cell(cfg, s, False, str(tmp_path), verbose=False,
                             variant="sp")
    assert sp["mesh"] == "single-sp" and sp["status"] == "ok"
    assert sp["flops"] == base["flops"]
    stream = s.global_batch // 16 * s.seq_len * cfg.d_model * 2   # bf16
    n_units = cfg.n_layers
    gathers = 3 * n_units + 2 if s.kind == "train" else n_units + 1
    assert sp["collectives"] - base["collectives"] == gathers
    assert sp["collective_bytes"] - base["collective_bytes"] == \
        gathers * stream
    if s.kind == "train":
        carry, carry_sp = (r["memory"]["peak_bytes_per_unit"]
                           for r in (base, sp))
        assert carry - carry_sp == stream - stream // 16
        assert stream <= carry < stream * 1.01
        assert sp["memory"]["stack_peak_bytes"] < \
            base["memory"]["stack_peak_bytes"]


def test_cli_seq_parallel(fake, tmp_path):
    """``--seq-parallel`` runs the sweep with the switch on, tags the
    records ``sp`` unless ``--variant`` names another, and leaves the
    switch off after it."""
    from repro_torch.sharding.util import seq_axis
    out = str(tmp_path / "d")
    for flags, tag in ((["--seq-parallel"], "single-sp"),
                       (["--seq-parallel", "--variant", "x"], "single-x")):
        assert dryrun.main(["--arch", "dense-gqa-smoke", "--shape",
                            "decode_32k", "--mesh", "single", "--out", out]
                           + flags) == 0
        with open(os.path.join(out, f"dense-gqa-smoke__decode_32k__{tag}"
                               ".json")) as f:
            assert json.load(f)["status"] == "ok"
        assert seq_axis() is None


def test_host_mesh_cell(fake):
    """``chip_smoke.py``'s dry-run cell: a train cell's probes on a
    (data 2, model 2) host mesh of a fake group, float32 parameters as
    the smoke's ranks hold them (twice the bf16 cell's parameter bytes);
    with sequence parallelism on, the 3 n_units + 2 gathers of the stream
    the smoke counts on its ranks, and a smaller remat carry a unit."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import arg_bytes, build_cell
    from repro_torch.sharding.util import seq_parallel
    cfg = SMOKE_FAMILIES["dense_gqa"]
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=8)
    dryrun.fake_world(4)
    mesh = make_host_mesh(2, 2)
    f32, bf16 = (arg_bytes(build_cell(cfg, shape, mesh, False,
                                      param_dtype=dt))
                 for dt in (torch.float32, torch.bfloat16))
    assert f32["params"] == 2 * bf16["params"]
    off = dryrun._probe(cfg, shape, mesh, False, 1, torch.float32)
    with seq_parallel():
        on = dryrun._probe(cfg, shape, mesh, False, 1, torch.float32)
    stream = 8 // 2 * 64 * cfg.d_model * 4
    assert off["peak_bytes_per_unit"] >= stream
    assert on["peak_bytes_per_unit"] < off["peak_bytes_per_unit"]
    assert on["collectives"] - off["collectives"] == 3 * cfg.n_layers + 2
    assert on["flops"] == off["flops"]


def test_mesh_constants_are_the_h100s():
    assert mesh_mod.PEAK_FLOPS_BF16 == 989e12
    assert mesh_mod.PEAK_FLOPS_F32 == 67e12
    assert mesh_mod.HBM_BW == 3.35e12
    assert mesh_mod.SINGLE_POD == (16, 16) and mesh_mod.MULTI_POD == (2, 16,
                                                                      16)
