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


def test_cli_refuses_seq_parallel(tmp_path, capsys):
    """The port's activations are local tensors, which no sharding
    constraint moves: a sequence-parallel run would write records that
    claim a layout the step does not have, so the flag is refused."""
    out = tmp_path / "d"
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "dense-gqa-smoke", "--shape", "decode_32k",
                     "--mesh", "single", "--seq-parallel", "--out",
                     str(out)])
    assert exc.value.code == 2
    assert "--seq-parallel is not supported" in capsys.readouterr().err
    assert not out.exists()


def test_mesh_constants_are_the_h100s():
    assert mesh_mod.PEAK_FLOPS_BF16 == 989e12
    assert mesh_mod.PEAK_FLOPS_F32 == 67e12
    assert mesh_mod.HBM_BW == 3.35e12
    assert mesh_mod.SINGLE_POD == (16, 16) and mesh_mod.MULTI_POD == (2, 16,
                                                                      16)
