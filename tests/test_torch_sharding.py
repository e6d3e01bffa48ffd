"""The port's sharding (``repro_torch.sharding``, ``launch.mesh``) against
the reference on the CPU.

* The rules: every ``lm_smoke`` family and ``demo-100m`` on four mesh
  shapes, param / cache / batch specs leaf for leaf against the
  reference's sanitized specs (a stand-in mesh with ``.shape`` serves
  both packages: the rules read only the axis sizes); the reference's
  stacking ``None`` of a scanned unit's leaf is dropped.
* Per-rank bytes of ``demo-100m``'s dry-run cells on both production
  meshes, exactly the reference's specs' sum.
* Placements: ``named``'s errors, ``local_chunk`` / ``gather_full``.
* Worlds 2 and 4 of spawned ranks over gloo on CPU tensors: the sharded
  train step (dense, MoE) on (data 2, model 2) against the one-process
  step and the reference's; the sequence-sharded decode of four families
  against the unsharded port and the reference; ``global_sync(group=)``
  over 2-rank pod groups, bit for bit the one-process sync and within
  2e-7 of the reference; ``load_checkpoint(shardings=)`` of a one-process
  checkpoint onto a 4-rank mesh, bit for bit; ``maybe_constrain``.

The reference (JAX) is imported inside the tests: the spawned ranks import
this module to find their functions and stay on torch alone.
"""

import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.lm_smoke import DEMO_100M, SMOKE_FAMILIES
from repro_torch.core import distributed as D
from repro_torch.models.registry import get_model, param_shapes
from repro_torch.sharding import rules as R
from repro_torch.sharding import util as U

DEADLINE = 300.0
CPU = dict(backend="gloo", device="cpu", threads=1)
# the sharded step sums the data ranks' gradients where one process sums
# the whole batch's in its matmuls: float32 reassociation, grown by three
# AdamW steps at lr 1e-3 (a weight moves ~lr a step whatever its gradient)
TRAIN_ATOL = 1e-5
# decode: the flash partials of the shards merged against one softmax over
# the whole cache (float32 logits of magnitude ~1)
DECODE_ATOL = 2e-5
REF_ATOL = 1e-4             # the port against the reference (test_torch_lm)
SYNC_ATOL = 2e-7            # test_torch_train's bound on the global phase
DECODE_FAMILIES = ("dense_gqa", "window_softcap", "mla", "hybrid")
TRAIN_FAMILIES = ("dense_gqa", "moe")
MESHES = {"2x4": {"data": 2, "model": 4},
          "2x2x2": {"pod": 2, "data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class Mesh:
    """A stand-in mesh: axis name -> size (what the rules read)."""

    def __init__(self, shape):
        self.shape = dict(shape)


@functools.lru_cache(maxsize=None)
def jx():
    import types

    import jax
    import jax.numpy as jnp

    from repro.configs.base import ArchConfig as RefArch
    from repro.configs.base import LayerSpec as RefLayer
    from repro.core import hybrid_sync as sync
    from repro.models import registry
    from repro.optim import adamw, compression
    from repro.sharding import rules, util
    from repro.train import trainer
    return types.SimpleNamespace(jax=jax, jnp=jnp, RefArch=RefArch,
                                 RefLayer=RefLayer, registry=registry,
                                 rules=rules, util=util, trainer=trainer,
                                 sync=sync, adamw=adamw,
                                 compression=compression)


def ref_cfg(cfg):
    j = jx()
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["pattern"] = tuple(j.RefLayer(**dataclasses.asdict(s))
                              for s in cfg.pattern)
    return j.RefArch(**fields)


def ref_named(tree) -> dict:
    """The reference tree's leaves by dotted path."""
    j = jx()
    flat, _ = j.jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, j.jax.sharding.PartitionSpec))
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


_UNIT = re.compile(r"(?:^|\.)units\.(\d+)\.")


def ref_leaf(name: str) -> tuple[str, bool]:
    """A port name's reference leaf, and whether it is a unit's (stacked)."""
    m = _UNIT.search(name)
    if m is None:
        return name, False
    return name[:m.start(1)] + name[m.end(1) + 1:], True


def port_named(tree, prefix="") -> dict:
    if isinstance(tree, R.PartitionSpec) or isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(port_named(v, f"{prefix}{k}."))
    return out


def assert_specs_match(port: dict, ref: dict):
    assert {ref_leaf(k)[0] for k in port} == set(ref)
    for k, spec in port.items():
        leaf, stacked = ref_leaf(k)
        want = tuple(ref[leaf])
        if stacked:
            assert want[0] is None, (k, want)
            want = want[1:]
        assert tuple(spec) == want, (k, spec, want)


# ---------------------------------------------------------------------------
# the rules against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_specs_match_reference(mesh_name):
    """Params, caches (two batch/sequence sizes: one divides every mesh,
    one does not) and batches, every family and demo-100m."""
    j = jx()
    mesh = Mesh(MESHES[mesh_name])
    datas = ["data"] + ([("pod", "data")] if "pod" in mesh.shape else [])
    for cfg in (DEMO_100M, *SMOKE_FAMILIES.values()):
        rc, api = ref_cfg(cfg), get_model(cfg)
        rapi = j.registry.get_model(rc)
        model = param_shapes(cfg)
        rshapes = j.registry.param_shapes(rc)
        assert_specs_match(
            U.sanitize_specs(R.param_specs(model), model, mesh),
            ref_named(j.util.sanitize_specs(j.rules.param_specs(rshapes),
                                            rshapes, mesh)))
        for b, s in ((32, 64), (2, 24)):
            cache = api.init_cache(cfg, b, s, torch.float32, "meta")
            rcache = j.jax.eval_shape(
                lambda: rapi.init_cache(rc, b, s, j.jnp.float32))
            batch = {"tokens": torch.empty((b, s), device="meta"),
                     "labels": torch.empty((b, s), device="meta")}
            rbatch = {k: j.jax.ShapeDtypeStruct((b, s), j.jnp.int32)
                      for k in batch}
            for data in datas:
                assert_specs_match(
                    port_named(U.sanitize_specs(
                        R.cache_specs(cache, data=data), cache, mesh)),
                    ref_named(j.util.sanitize_specs(
                        j.rules.cache_specs(rcache, data=data), rcache,
                        mesh)))
                assert_specs_match(
                    U.sanitize_specs(R.batch_spec(batch, data=data), batch,
                                     mesh),
                    ref_named(j.util.sanitize_specs(
                        j.rules.batch_spec(rbatch, data=data), rbatch,
                        mesh)))
    specs = R.param_specs(param_shapes(SMOKE_FAMILIES["dense_gqa"]))
    assert R.prepend_axis(specs, "pod")["embed"] == ("pod", "model", "data")


def _ref_bytes(shapes, specs, mesh, dtype_bytes=None) -> int:
    """Sum over leaves of leaf bytes over the sizes of its sharded axes."""
    sizes = mesh.shape
    total = 0
    named_specs = ref_named(specs)
    for k, leaf in ref_named(shapes).items():
        n = int(np.prod(leaf.shape)) * (dtype_bytes or
                                        np.dtype(leaf.dtype).itemsize)
        for ax in named_specs[k]:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    n //= sizes[a]
        total += n
    return total


@pytest.mark.parametrize("multi", [False, True])
def test_bytes_per_rank_match_reference(multi):
    """The dry run's per-rank argument bytes of demo-100m's cells, part by
    part, against the reference's specs on the same production mesh."""
    from repro_torch.launch.specs import arg_bytes, build_cell
    j = jx()
    mesh = Mesh(MESHES["2x16x16" if multi else "16x16"])
    rc = ref_cfg(DEMO_100M)
    rapi = j.registry.get_model(rc)
    rshapes = j.registry.param_shapes(rc, j.jnp.bfloat16)
    pspecs = j.util.sanitize_specs(j.rules.param_specs(rshapes), rshapes,
                                   mesh)
    data = ("pod", "data") if multi else "data"
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = SHAPES[name]
        got = arg_bytes(build_cell(DEMO_100M, shape, mesh, multi))
        want = {"params": _ref_bytes(rshapes, pspecs, mesh)}
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            want["moments"] = 2 * _ref_bytes(rshapes, pspecs, mesh, 4)
            batch = {k: j.jax.ShapeDtypeStruct((b, s), j.jnp.int32)
                     for k in ("tokens", "labels")}
        else:
            batch = {"tokens": j.jax.ShapeDtypeStruct(
                (b, s if shape.kind == "prefill" else 1), j.jnp.int32)}
            cache = j.jax.eval_shape(
                lambda: rapi.init_cache(rc, b, s, j.jnp.bfloat16))
            want["cache"] = _ref_bytes(cache, j.util.sanitize_specs(
                j.rules.cache_specs(cache, data=data), cache, mesh), mesh)
        want["batch"] = _ref_bytes(batch, j.util.sanitize_specs(
            j.rules.batch_spec(batch, data=data), batch, mesh), mesh)
        assert got == want, (name, got, want)


def test_placements_and_errors():
    from torch.distributed.tensor import Replicate, Shard
    mesh = Mesh({"pod": 2, "data": 2, "model": 4})
    P = R.P
    assert U.placements_for(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert U.placements_for(P(None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    for bad, msg in ((P("data", None, "data"), "twice"),
                     (P(("data", "pod")), "mesh order"),
                     (P("expert"), "no axis")):
        with pytest.raises(ValueError, match=msg):
            U.placements_for(bad, mesh)
    assert U.sanitize_specs({"w": P("data", "model")},
                            {"w": torch.empty(3, 8, device="meta")},
                            mesh) == {"w": P(None, "model")}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

@torch.no_grad()
def _serve(cfg, model, tokens, start, max_len, n_dec, mesh=None):
    """Prefill then greedy decode steps; the logits of each and the
    tokens.  With a mesh: this rank's rows of the batch, the cache cut by
    the rules (``shard_cache``), decode over ``model``."""
    api, axis = get_model(cfg), None
    b = tokens.shape[0]
    cache = api.init_cache(cfg, b, max_len, torch.float32, "cpu")
    if mesh is not None:
        rows = b // mesh.size(0)
        d = mesh.get_coordinate()[0]
        tokens = tokens[d * rows:(d + 1) * rows]
        start = start[d * rows:(d + 1) * rows]
        cache, axis = U.shard_cache(cache, mesh)
        assert axis == "model"          # every smoke cache divides here
    logits, cache = api.prefill(model, {"tokens": tokens, "start": start},
                                cache, cfg, decode_axis=axis)
    outs, toks = [logits[:, -1]], []
    for j in range(n_dec):
        tok = outs[-1].argmax(-1)[:, None]
        toks.append(tok)
        logits, cache = api.decode_step(model, tok, cache,
                                        tokens.shape[1] + j, cfg,
                                        decode_axis=axis, kv_start=start)
        outs.append(logits[:, -1])
    return torch.stack(outs, 1), torch.cat(toks, 1)


def _place_model(model, mesh):
    from repro_torch.launch.specs import shard_module
    return shard_module(model, U.named(U.sanitize_specs(
        R.param_specs(model), model, mesh), mesh))


def _job_train(rank, world, make_mesh, set_mesh, cfg, state, batches):
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.sharding.fsdp import gather_full, sharding_of
    from repro_torch.train.trainer import make_train_step
    mesh = make_mesh(2, world // 2)
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    model.load_state_dict(state)
    model = _place_model(model, mesh)
    opt = adamw_init(model)
    step = make_train_step(cfg, api, peak_lr=1e-3, warmup=2, total_steps=10)
    metrics = []
    for s, batch in enumerate(batches):
        shard = U.named(U.sanitize_specs(R.batch_spec(batch), batch, mesh),
                        mesh)
        model, opt, m = step(model, opt, U.place_tree(batch, shard), s)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    full = {k: gather_full(p._local_tensor, sharding_of(p))
            for k, p in model.named_parameters()}
    mu = {k: gather_full(v._local_tensor, sharding_of(v))
          for k, v in opt.mu.items()}
    return (metrics, full, mu) if rank == 0 else None


def _job_decode(rank, world, make_mesh, set_mesh, data, cases):
    """Every rank's logits and tokens, with its (data, model) coordinate."""
    mesh = make_mesh(data, world // data)
    out = {}
    with set_mesh(mesh):
        for name, cfg, state, tokens, start in cases:
            model = get_model(cfg).init(torch.Generator(), cfg,
                                        torch.float32, "cpu")
            model.load_state_dict(state)
            out[name] = _serve(cfg, model, tokens, start, 24, 5, mesh)
    return tuple(mesh.get_coordinate()), out


def _rows(results: list, name: str):
    """The whole batch's logits and tokens from the ranks' rows (those
    of model coordinate 0, in data order)."""
    parts = sorted((c, out[name]) for c, out in results if c[1] == 0)
    return (torch.cat([p[1][0] for p in parts]),
            torch.cat([p[1][1] for p in parts]))


def _job_sync(rank, world, make_mesh, set_mesh, cfg, pod_states, outer0):
    """Pods 0 and 1 on ranks (0, 1) and again on (2, 3): two rounds each
    of the compressed and the plain exchange."""
    import torch.distributed as dist
    from repro_torch.core.hybrid_sync import OuterState, global_sync
    from repro_torch.optim.compression import ErrorFeedbackState
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    group, pod = groups[rank // 2], rank % 2
    out = {}
    for compress in (True, False):
        model = get_model(cfg).init(torch.Generator(), cfg, torch.float32,
                                    "cpu")
        model.load_state_dict(pod_states[pod])
        outer = OuterState(
            anchor={k: v.clone() for k, v in outer0["anchor"].items()},
            momentum={k: v.clone() for k, v in outer0["momentum"].items()},
            ef=ErrorFeedbackState(residual={
                k: v[pod:pod + 1].clone()
                for k, v in outer0["residual"].items()}))
        rounds = []
        for _ in range(2):
            (model,), outer = global_sync([model], outer, compress=compress,
                                          group=group)
            rounds.append((outer, {k: p.detach().clone()
                                   for k, p in model.named_parameters()}))
        out[compress] = rounds
    return out


def _job_attention(rank, world, make_mesh, set_mesh, q, k, v, kpos, cur,
                   kw):
    """``decode_attention`` on this rank's quarter of the cache, merged
    over the world."""
    import torch.distributed as dist
    from repro_torch.models.attention import decode_attention
    n = k.shape[1] // world
    cut = slice(rank * n, (rank + 1) * n)
    return decode_attention(q, k[:, cut], v[:, cut], kpos[cut], cur,
                            axis_name=dist.group.WORLD, **kw)


def _job_restore(rank, world, make_mesh, set_mesh, path, like):
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.sharding.fsdp import gather_full, sharding_of
    mesh = make_mesh(2, world // 2)
    specs = U.sanitize_specs(R.param_specs(like), like, mesh)
    tree, step = load_checkpoint(path, {"p": like},
                                 shardings={"p": U.named(specs, mesh)})
    placed = all(type(v).__name__ == "DTensor" for v in tree["p"].values())
    full = {k: gather_full(v._local_tensor, sharding_of(v))
            for k, v in tree["p"].items()}
    return (step, placed, full) if rank == 0 else None


def _job_constrain(rank, world, make_mesh, set_mesh):
    from torch.distributed.tensor import Shard
    from repro_torch.sharding.fsdp import gather_full, sharding_of
    mesh = make_mesh(2, world // 2)
    x = torch.arange(32.0).reshape(4, 8)
    d = U.place(x, U.named(R.P("data", None), mesh))
    same = U.maybe_constrain(d, "data", None) is d
    with set_mesh(mesh):
        y = U.maybe_constrain(d, None, "model")
        kept = U.maybe_constrain(d, "data", None) is d
    full = gather_full(y._local_tensor, sharding_of(y))
    return (same, tuple(y.placements)[1] == Shard(1), torch.equal(full, x),
            kept)


ATTN_CASES = (dict(cap=4.0), dict(window=6), dict(kv_start=True))


def _attention_inputs():
    """(q, k, v, kpos, cur, kw) per case: a 16-row cache (a ring of global
    positions for the window case), left padding for the kv_start one."""
    rng = np.random.RandomState(5)
    out = []
    for case in ATTN_CASES:
        q = torch.from_numpy(rng.randn(2, 1, 4, 8).astype(np.float32))
        k, v = (torch.from_numpy(rng.randn(2, 16, 2, 8).astype(np.float32))
                for _ in range(2))
        kw = dict(case)
        if "window" in kw:
            kpos, cur = torch.tensor([16, 17, 18, 19] + list(range(4, 16))), 20
        else:
            kpos, cur = torch.arange(16), 13
        if kw.pop("kv_start", False):
            kw["kv_start"] = torch.tensor([2, 0])
        out.append((q, k, v, kpos, cur, kw))
    return out


_SHARD_MAP = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.models.attention import decode_attention
q, k, v, kpos, cur, cap, window, start = np.load(sys.argv[1], allow_pickle=True)
mesh = Mesh(np.array(jax.devices()[:4]), ("model",))
smap = getattr(jax, "shard_map", None)
kw = dict(check_vma=False)
if smap is None:
    from jax.experimental.shard_map import shard_map as smap
    kw = dict(check_rep=False)
extra = {} if start is None else {"kv_start": jnp.asarray(start)}
f = smap(lambda q, k, v, p: decode_attention(q, k, v, p, cur, cap=cap,
                                             window=window, axis_name="model",
                                             **extra),
         mesh=mesh, in_specs=(P(), P(None, "model"), P(None, "model"),
                              P("model")), out_specs=P(), **kw)
np.save(sys.argv[2], np.asarray(jax.jit(f)(q, k, v, kpos)))
"""


def _decode_cases():
    g = torch.Generator().manual_seed(3)
    cases = []
    for name in DECODE_FAMILIES:
        cfg = SMOKE_FAMILIES[name]
        model = get_model(cfg).init(torch.Generator().manual_seed(4), cfg,
                                    torch.float32, "cpu")
        tokens = torch.randint(1, cfg.vocab, (4, 16), generator=g)
        start = torch.tensor([0, 3, 7, 1])
        cases.append((name, cfg, model.state_dict(), tokens, start))
    return cases


def _train_inputs(name):
    cfg = SMOKE_FAMILIES[name]
    model = get_model(cfg).init(torch.Generator().manual_seed(11), cfg,
                                torch.float32, "cpu")
    g = torch.Generator().manual_seed(12)
    batches = [{k: torch.randint(0, cfg.vocab, (8, 16), generator=g)
                for k in ("tokens", "labels")} for _ in range(3)]
    return cfg, model, batches


def _sync_inputs():
    """Two pods after two inner steps each on their own data (one
    process), and their outer state."""
    from repro_torch.core.hybrid_sync import (inner_steps, outer_init,
                                              stack_pods)
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import make_train_step
    cfg = SMOKE_FAMILIES["dense_gqa"]
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(6), cfg, torch.float32,
                     "cpu")
    pods, opts = stack_pods(model, 2), stack_pods(adamw_init(model), 2)
    step = make_train_step(cfg, api, peak_lr=1e-3, warmup=1)
    g = torch.Generator().manual_seed(7)
    for s in range(2):
        batch = {k: torch.randint(0, cfg.vocab, (2, 4, 16), generator=g)
                 for k in ("tokens", "labels")}
        pods, opts, _ = inner_steps(step, pods, opts, batch, s)
    return cfg, pods, outer_init(model, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Every 4-rank job in one spawn; each rank's results, in job order."""
    from repro_torch.checkpoint import save_checkpoint
    trains = {n: _train_inputs(n) for n in TRAIN_FAMILIES}
    cfg, pods, outer = _sync_inputs()
    ck = str(tmp_path_factory.mktemp("ck") / "step")
    like = get_model(cfg).init(torch.Generator().manual_seed(9), cfg,
                               torch.float32, "cpu")
    save_checkpoint(ck, {"p": dict(like.named_parameters())}, step=7)
    jobs = [("train", (c, m.state_dict(), b)) for c, m, b in trains.values()]
    jobs += [("decode", (2, _decode_cases())),
             ("sync", (cfg, [p.state_dict() for p in pods],
                       {"anchor": outer.anchor, "momentum": outer.momentum,
                        "residual": outer.ef.residual})),
             ("restore", (ck, {k: p.detach()
                               for k, p in like.named_parameters()})),
             ("constrain", ())]
    jobs += [("attention", a) for a in _attention_inputs()]
    res = D.spawn_ranks(_rank_jobs_list, 4, args=(jobs,),
                        deadline_s=DEADLINE, **CPU)
    n = len(trains)
    out = {f"train_{k}": res[0][i] for i, k in enumerate(trains)}
    out.update(decode=[r[n] for r in res], sync=(res[0][n + 1],
                                                 res[1][n + 1]),
               restore=res[0][n + 2], constrain=res[0][n + 3],
               attention=[[r[i] for r in res]
                          for i in range(n + 4, len(jobs))],
               trains=trains, sync_inputs=(cfg, pods, outer), like=like)
    return out


def _rank_jobs_list(rank, world, group, device, jobs):
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    return [globals()[f"_job_{name}"](rank, world, make_host_mesh, set_mesh,
                                      *args) for name, args in jobs]


@pytest.fixture(scope="module")
def world2():
    res = D.spawn_ranks(_rank_jobs_list, 2, args=([
        ("decode", (1, _decode_cases()))],), deadline_s=DEADLINE, **CPU)
    return [r[0] for r in res]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("name", TRAIN_FAMILIES)
def test_sharded_train_matches_one_process_and_reference(world4, name):
    """Three steps on (data 2, model 2): losses, clip norms, weights and
    first moments against the one-process step, and the weights against
    the reference's steps from the same weights and batches."""
    from repro_torch.convert import lm_params_to_numpy
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import make_train_step
    j = jx()
    cfg, model, batches = world4["trains"][name]
    api = get_model(cfg)
    metrics, full, mu = world4[f"train_{name}"]
    rc = ref_cfg(cfg)
    rp = j.jax.tree.map(j.jnp.asarray, lm_params_to_numpy(model, cfg))
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=10)
    rstep = j.jax.jit(j.trainer.make_train_step(
        rc, j.registry.get_model(rc), **kw))
    ropt = j.adamw.adamw_init(rp)
    step, opt = make_train_step(cfg, api, **kw), adamw_init(model)
    for s, batch in enumerate(batches):
        model, opt, m = step(model, opt, batch, s)
        rp, ropt, rm = rstep(rp, ropt, {k: j.jnp.asarray(v.numpy()) for k, v
                                        in batch.items()}, j.jnp.asarray(s))
        np.testing.assert_allclose(metrics[s], (float(m["loss"]),
                                                float(m["grad_norm"])),
                                   rtol=1e-5)
        np.testing.assert_allclose(metrics[s][0], float(rm["loss"]),
                                   rtol=1e-5)
    for k, p in model.named_parameters():
        _close(full[k], p.detach(), TRAIN_ATOL)
        _close(mu[k], opt.mu[k], TRAIN_ATOL)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(full[k])
    for a, b in zip(j.jax.tree_util.tree_leaves(lm_params_to_numpy(model,
                                                                   cfg)),
                    j.jax.tree_util.tree_leaves(rp)):
        _close(a, b, REF_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_seq_sharded_decode_matches_unsharded_and_reference(world, world2,
                                                            world4):
    """Left-padded prefill and 5 greedy steps over a cache cut over
    ``model`` (world 2: (1, 2); world 4: (2, 2), the batch over data):
    logits against the unsharded port and the reference's unsharded
    prefill / decode_step, tokens equal."""
    from repro_torch.convert import lm_params_to_numpy
    j = jx()
    results = world2 if world == 2 else world4["decode"]
    for name, cfg, state, tokens, start in _decode_cases():
        model = get_model(cfg).init(torch.Generator(), cfg, torch.float32,
                                    "cpu")
        model.load_state_dict(state)
        want, want_tok = _serve(cfg, model, tokens, start, 24, 5)
        logits, toks = _rows(results, name)
        _close(logits, want, DECODE_ATOL)
        assert torch.equal(toks, want_tok), name
        # the reference, unsharded, on the port's tokens
        rc = ref_cfg(cfg)
        rapi = j.registry.get_model(rc)
        rp = j.jax.tree.map(j.jnp.asarray, lm_params_to_numpy(model, cfg))
        cache = rapi.init_cache(rc, 4, 24, j.jnp.float32)
        st = j.jnp.asarray(start.numpy())
        rl, cache = j.jax.jit(lambda p, b, c: rapi.prefill(p, b, c, rc))(
            rp, {"tokens": j.jnp.asarray(tokens.numpy()), "start": st},
            cache)
        dec = j.jax.jit(lambda p, t, c, n: rapi.decode_step(
            p, t, c, n, rc, kv_start=st))
        outs = [np.asarray(rl)[:, -1]]
        for i in range(5):
            lg, cache = dec(rp, j.jnp.asarray(toks[:, i:i + 1].numpy()),
                            cache, 16 + i)
            outs.append(np.asarray(lg)[:, -1])
        _close(logits, np.stack(outs, 1), REF_ATOL)


def test_global_sync_over_pod_group(world4):
    """Two rounds over a 2-rank pod group (compressed and plain) bit for
    bit the one-process global_sync of the same pods, within 2e-7 of the
    reference's, and the pods equal after each round."""
    import copy
    from repro_torch.convert import (lm_params_to_numpy,
                                     outer_state_to_numpy)
    from repro_torch.core.hybrid_sync import global_sync
    j = jx()
    cfg, pods0, outer0 = world4["sync_inputs"]
    r0, r1 = world4["sync"]
    for compress in (True, False):
        pods, outer = copy.deepcopy(pods0), copy.deepcopy(outer0)
        rpods = j.jax.tree.map(lambda *x: j.jnp.stack(x), *[
            j.jax.tree.map(j.jnp.asarray, lm_params_to_numpy(p, cfg))
            for p in pods])
        o = j.jax.tree.map(j.jnp.asarray, outer_state_to_numpy(outer, cfg))
        routr = j.sync.OuterState(
            anchor=o["anchor"], momentum=o["momentum"],
            ef=j.compression.ErrorFeedbackState(
                residual=o["ef"]["residual"]))
        for rnd in range(2):
            pods, outer = global_sync(pods, outer, compress=compress)
            rpods, routr = j.jax.jit(lambda p, o: j.sync.global_sync(
                p, o, compress=compress))(rpods, routr)
            for pod, res in enumerate((r0, r1)):
                o, params = res[compress][rnd]
                for k, a in outer.anchor.items():
                    assert torch.equal(o.anchor[k], a), k
                    assert torch.equal(o.momentum[k], outer.momentum[k]), k
                    assert torch.equal(o.ef.residual[k][0],
                                       outer.ef.residual[k][pod]), k
                    assert torch.equal(params[k], a), k
            got = outer_state_to_numpy(outer, cfg)
            want = j.jax.tree.map(np.asarray, {
                "anchor": routr.anchor, "momentum": routr.momentum,
                "ef": {"residual": routr.ef.residual}})
            for a, b in zip(j.jax.tree_util.tree_leaves(got),
                            j.jax.tree_util.tree_leaves(want)):
                _close(a, b, SYNC_ATOL)


def test_decode_attention_axis_matches_reference(world4, tmp_path):
    """``decode_attention(axis_name=)`` over 4 ranks, each holding a
    quarter of the cache, against the reference's under ``shard_map`` on 4
    host devices (a ``jax.sharding.Mesh``, in a subprocess for its
    ``XLA_FLAGS``), and against the port's unsharded call; every rank
    gets the same merged output."""
    import os
    import subprocess
    import sys
    from repro_torch.models.attention import decode_attention
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    for (q, k, v, kpos, cur, kw), got in zip(_attention_inputs(),
                                             world4["attention"]):
        for g in got[1:]:
            assert torch.equal(g, got[0])
        _close(got[0], decode_attention(q, k, v, kpos, cur, **kw),
               DECODE_ATOL)
        start = kw.get("kv_start")
        np.save(tmp_path / "in.npy", np.array(
            [q.numpy(), k.numpy(), v.numpy(), kpos.numpy().astype(np.int32),
             cur, kw.get("cap", 0.0), kw.get("window", 0),
             None if start is None else start.numpy().astype(np.int32)],
            dtype=object), allow_pickle=True)
        r = subprocess.run([sys.executable, "-c", _SHARD_MAP,
                            str(tmp_path / "in.npy"),
                            str(tmp_path / "out.npy")],
                           env=dict(os.environ, PYTHONPATH=src,
                                    JAX_PLATFORMS="cpu"),
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        _close(got[0], np.load(tmp_path / "out.npy"), REF_ATOL)


def test_restore_onto_mesh(world4):
    """A one-process checkpoint restored onto a (2, 2) mesh as DTensors;
    gathered back, bit for bit."""
    step, placed, full = world4["restore"]
    assert step == 7 and placed
    for k, p in world4["like"].named_parameters():
        assert torch.equal(full[k], p.detach()), k


def test_maybe_constrain(world4):
    """The identity without a mesh and where the layout already holds;
    a redistribute otherwise (gloo, CPU tensors)."""
    assert all(world4["constrain"])
    x = torch.ones(3)
    assert U.maybe_constrain(x, "data") is x
