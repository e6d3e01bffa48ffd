"""The port's training substrate against the JAX reference on the CPU: the
data pipeline, LR schedules, AdamW, the train step (loss, microbatches),
int8 error-feedback compression and the hybrid (DiLoCo-style) sync.

Inputs come from a numpy seed; weights and optimizer states cross through
``repro_torch.convert``.  Both packages run float32; their sums fold in
different orders, so values agree to a few ulps (``ATOL`` / ``RTOL``)
unless a test states its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as RefArchConfig
from repro.configs.base import LayerSpec as RefLayerSpec
from repro.core import hybrid_sync as r_sync
from repro.data import pipeline as r_pipe
from repro.models.registry import get_model as r_get_model
from repro.optim import adamw as r_adamw
from repro.optim import compression as r_comp
from repro.optim import schedule as r_sched
from repro.train import trainer as r_trainer

from repro_torch.configs.lm_smoke import SMOKE_FAMILIES
from repro_torch.convert import (adamw_state_from_numpy, adamw_state_to_numpy,
                                 lm_params_from_numpy, lm_params_to_numpy,
                                 outer_state_from_numpy,
                                 outer_state_to_numpy, to_numpy)
from repro_torch.core import hybrid_sync as t_sync
from repro_torch.data import pipeline as t_pipe
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compression as t_comp
from repro_torch.optim import schedule as t_sched
from repro_torch.train import trainer as t_trainer

ATOL = 1e-5
RTOL = 1e-5


def ref_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["pattern"] = tuple(RefLayerSpec(**dataclasses.asdict(s))
                              for s in cfg.pattern)
    return RefArchConfig(**fields)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def close_tree(got, want, atol=ATOL, rtol=RTOL):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                                   rtol=rtol)


def port_weights(cfg, seed):
    model = get_model(cfg).init(torch.Generator().manual_seed(seed), cfg,
                                device="cpu")
    return model, jax.tree.map(jnp.asarray, lm_params_to_numpy(model, cfg))


# ---------------------------------------------------------------------------
# data pipeline: the same bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_shards", [(0, 1), (3, 2), (7, 4)])
def test_synthetic_tokens_byte_identical(seed, n_shards):
    cfg = dict(vocab=32_768, seq_len=64, global_batch=8, seed=seed)
    for shard in range(n_shards):
        got = t_pipe.SyntheticTokens(t_pipe.DataConfig(**cfg), n_shards,
                                     shard)
        want = r_pipe.SyntheticTokens(r_pipe.DataConfig(**cfg), n_shards,
                                      shard)
        for step in (0, 1, 99):
            g, w = got.batch(step), want.batch(step)
            assert sorted(g) == sorted(w)
            for k in g:
                assert g[k].dtype == w[k].dtype
                assert g[k].tobytes() == w[k].tobytes()


def test_file_dataset_and_prefetcher(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.RandomState(0).randint(0, 500, 10_000).astype(
        np.int32).tofile(path)
    cfg = dict(vocab=500, seq_len=31, global_batch=6)
    for shard in (0, 1):
        got = t_pipe.FileDataset(str(path), t_pipe.DataConfig(**cfg), 2,
                                 shard)
        want = r_pipe.FileDataset(str(path), r_pipe.DataConfig(**cfg), 2,
                                  shard)
        for step in (0, 5, 400):
            g, w = got.batch(step), want.batch(step)
            assert all(g[k].tobytes() == w[k].tobytes() for k in w)
    pf = t_pipe.Prefetcher(t_pipe.SyntheticTokens(t_pipe.DataConfig(
        vocab=100, seq_len=8, global_batch=2)), depth=2)
    try:
        b0, b1 = pf.next(), pf.next()
    finally:
        pf.close()
    want = r_pipe.SyntheticTokens(r_pipe.DataConfig(vocab=100, seq_len=8,
                                                    global_batch=2))
    assert b0["tokens"].tobytes() == want.batch(0)["tokens"].tobytes()
    assert b1["tokens"].tobytes() == want.batch(1)["tokens"].tobytes()


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def test_schedules():
    steps = np.arange(0, 130)
    for step in steps:
        np.testing.assert_allclose(
            float(t_sched.linear_warmup(int(step), 50, 3e-4)),
            float(r_sched.linear_warmup(jnp.asarray(step), 50, 3e-4)),
            rtol=1e-6)
    got = [float(t_sched.cosine_schedule(torch.tensor(s), 50, 100, 3e-4,
                                         1e-5)) for s in steps]
    want = np.asarray(jax.vmap(lambda s: r_sched.cosine_schedule(
        s, 50, 100, 3e-4, 1e-5))(jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert t_sched.cosine_schedule(3, 50, 100, 3e-4).dtype == torch.float32


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_adamw_matches_reference(clip_norm):
    """Five updates of a random tree, clipping active (norm ~10 > 1) and
    not; params, both moments and the step leaf by leaf."""
    rng = np.random.RandomState(1)
    shapes = {"a": (5, 7), "b": (11,), "c": (2, 3, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: T(v) for k, v in params.items()}
    rs, ts = r_adamw.adamw_init(rp), t_adamw.adamw_init(tp)
    for i in range(5):
        g = {k: rng.randn(*s).astype(np.float32) * 3 for k, s in
             shapes.items()}
        lr = 1e-2 * (i + 1)
        rp, rs = r_adamw.adamw_update(rp, {k: jnp.asarray(v) for k, v in
                                           g.items()}, rs, lr,
                                      clip_norm=clip_norm)
        tp, ts = t_adamw.adamw_update(tp, {k: T(v) for k, v in g.items()},
                                      ts, lr, clip_norm=clip_norm)
        close_tree(to_numpy(tp), to_numpy(rp))
        close_tree(to_numpy(ts), to_numpy(rs))
    assert int(ts.step) == 5 and ts.step.dtype == torch.int32
    close_tree(to_numpy(t_adamw.global_norm(tp)),
               to_numpy(r_adamw.global_norm(rp)))


def test_adamw_reduces_quadratic_and_bf16_moments():
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    opt = t_adamw.adamw_init(params)
    for _ in range(200):
        params, opt = t_adamw.adamw_update(params, {"w": 2 * params["w"]},
                                           opt, 0.05, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.1
    bf = t_adamw.adamw_init(params, torch.bfloat16)
    _, bf = t_adamw.adamw_update(params, {"w": params["w"]}, bf, 0.1)
    assert bf.mu["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def test_cross_entropy_masked_and_not():
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 5, 17).astype(np.float32) * 4
    labels = rng.randint(0, 17, (2, 5)).astype(np.int32)
    mask = (rng.rand(2, 5) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = r_trainer.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = t_trainer.cross_entropy(T(logits), T(labels),
                                      None if m is None else T(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _batch(cfg, b, s, seed):
    data = t_pipe.SyntheticTokens(t_pipe.DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b, seed=seed))
    batch = data.batch(0)
    rng = np.random.RandomState(seed)
    if cfg.family == "vlm":
        batch["vis_embed"] = rng.randn(b, cfg.vis_tokens,
                                       cfg.vis_dim).astype(np.float32)
    if cfg.family == "audio":
        batch["audio_embed"] = rng.randn(b, cfg.enc_frames,
                                         cfg.d_model).astype(np.float32)
    return batch


# train steps: AdamW's update divides by sqrt(v), so a gradient element
# near zero moves its weight by up to ~lr whatever its rounding; the
# params are held at 1e-4 (a tenth of the peak lr), the moments at 1e-5
STEP_ATOL = 1e-4
# the global phase on identical inputs: float32 rounding of anchors of
# magnitude up to ~1 (norm scales), against an int8 step of ~2e-5
SYNC_ATOL = 2e-7


@pytest.mark.parametrize("name,micro", [("dense_gqa", 1), ("dense_gqa", 4),
                                        ("moe", 1), ("vlm", 2)])
def test_train_steps_match_reference(name, micro):
    """Three train steps of the port against the reference's on the same
    weights and batches: params, AdamW state and metrics leaf by leaf."""
    cfg = SMOKE_FAMILIES[name]
    rc = ref_cfg(cfg)
    model, rp = port_weights(cfg, 11)
    kw = dict(microbatches=micro, peak_lr=1e-3, warmup=2, total_steps=10)
    rstep = jax.jit(r_trainer.make_train_step(rc, r_get_model(rc), **kw))
    tstep = t_trainer.make_train_step(cfg, get_model(cfg), **kw)
    ropt, topt = r_adamw.adamw_init(rp), t_adamw.adamw_init(model)
    for step in range(3):
        batch = _batch(cfg, 4, 16, seed=step)
        rp, ropt, rm = rstep(rp, ropt, {k: jnp.asarray(v) for k, v in
                                        batch.items()}, jnp.asarray(step))
        model, topt, tm = tstep(model, topt, {k: T(v) for k, v in
                                              batch.items()}, step)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-5)
    close_tree(lm_params_to_numpy(model, cfg), to_numpy(rp), atol=STEP_ATOL,
               rtol=0)
    got = adamw_state_to_numpy(topt, cfg)
    close_tree(got["mu"], to_numpy(ropt.mu))
    close_tree(got["nu"], to_numpy(ropt.nu))
    assert int(got["step"]) == int(ropt.step) == 3
    back = adamw_state_from_numpy(to_numpy(ropt), cfg, "cpu")
    assert set(back.mu) == set(topt.mu)


def test_microbatches_match_full_batch():
    cfg = SMOKE_FAMILIES["dense_gqa"]
    api = get_model(cfg)
    batch = {k: T(v) for k, v in _batch(cfg, 8, 16, 0).items()}
    out = []
    for micro in (1, 4):
        model, _ = port_weights(cfg, 0)
        opt = t_adamw.adamw_init(model)
        step = t_trainer.make_train_step(cfg, api, microbatches=micro)
        model, _, m = step(model, opt, batch, 0)
        out.append((model, m))
    np.testing.assert_allclose(float(out[0][1]["loss"]),
                               float(out[1][1]["loss"]), rtol=1e-5)
    a, b = (m.state_dict() for m, _ in out)
    assert max(float((a[k] - b[k]).abs().max()) for k in a) < 5e-5


def test_train_step_loss_decreases():
    cfg = SMOKE_FAMILIES["dense_gqa"]
    model, _ = port_weights(cfg, 0)
    step_fn = t_trainer.make_train_step(cfg, get_model(cfg), peak_lr=3e-3,
                                        warmup=5, total_steps=300)
    opt = t_adamw.adamw_init(model)
    data = t_pipe.SyntheticTokens(t_pipe.DataConfig(vocab=cfg.vocab,
                                                    seq_len=32,
                                                    global_batch=8))
    losses = []
    for step in range(60):
        batch = {k: T(v) for k, v in data.batch(step).items()}
        model, opt, m = step_fn(model, opt, batch, step)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses[::10]


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

def test_int8_codes_identical():
    """Codes, scales and residuals over two rounds; the pod-stacked leaf
    takes one scale over both pods, and the half-way values round to even
    in both packages."""
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(2, 16, 8).astype(np.float32) * 0.01,
            "b": (np.arange(-6, 7, dtype=np.float32) * 0.5)}   # k + 0.5 ties
    rt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: T(v) for k, v in tree.items()}
    ref, port = r_comp.ef_init(rt), t_comp.ef_init(tt)
    for _ in range(2):
        rq, rs, ref = r_comp.ef_int8_compress(rt, ref)
        tq, ts, port = t_comp.ef_int8_compress(tt, port)
        for k in tree:
            assert tq[k].dtype == torch.int8
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(rq[k]))
            assert ts[k].shape == ()
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(rs[k]))
            np.testing.assert_allclose(port.residual[k].numpy(),
                                       np.asarray(ref.residual[k]), atol=1e-9)
        close_tree(to_numpy(t_comp.ef_int8_decompress(tq, ts)),
                   to_numpy(r_comp.ef_int8_decompress(rq, rs)), atol=0,
                   rtol=0)
    assert np.abs(np.asarray(rq["b"])).max() == 127


# ---------------------------------------------------------------------------
# hybrid sync
# ---------------------------------------------------------------------------

def test_stack_pods_and_outer_init():
    model, rp = port_weights(SMOKE_FAMILIES["dense_gqa"], 1)
    pods = t_sync.stack_pods(model, 2)
    assert len(pods) == 2 and pods[0] is not model
    assert pods[0]["embed"].data_ptr() != pods[1]["embed"].data_ptr()
    stacked = t_sync.stack_pods({"w": torch.ones(3)}, 4)
    assert stacked["w"].shape == (4, 3)
    outer = t_sync.outer_init(model, 2)
    assert outer.ef.residual["embed"].shape == (2,) + model["embed"].shape
    cfg = SMOKE_FAMILIES["dense_gqa"]
    close_tree(outer_state_to_numpy(outer, cfg),
               to_numpy(r_sync.outer_init(rp, 2)), atol=0, rtol=0)
    # the reference's gathered_specs pins a GSPMD gather; the port's gather
    # is explicit (global_sync(group=), tests/test_torch_sharding.py)
    with pytest.raises(TypeError, match="gathered_specs"):
        t_sync.global_sync(pods, outer, gathered_specs={})


@pytest.mark.parametrize("compress", [True, False])
def test_inner_steps_and_global_sync_match_reference(compress):
    """Two pods on their own data: three inner steps, then one global
    phase; every pod's params, the per-pod metrics and the outer state
    (anchor, momentum, int8 residuals) leaf by leaf.  The pods diverge
    before the exchange and equal the anchor after it."""
    cfg = SMOKE_FAMILIES["dense_gqa"]
    rc = ref_cfg(cfg)
    model, rp = port_weights(cfg, 2)
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=100)
    rstep = r_trainer.make_train_step(rc, r_get_model(rc), **kw)
    tstep = t_trainer.make_train_step(cfg, get_model(cfg), **kw)
    r_pods = r_sync.stack_pods(rp, 2)
    r_opts = r_sync.stack_pods(r_adamw.adamw_init(rp), 2)
    r_outer = r_sync.outer_init(rp, 2)
    t_pods = t_sync.stack_pods(model, 2)
    t_opts = t_sync.stack_pods(t_adamw.adamw_init(model), 2)
    t_outer = t_sync.outer_init(model, 2)
    inner = jax.jit(lambda p, o, b, s: r_sync.inner_steps(rstep, p, o, b, s))
    for step in range(3):
        batch = {k: np.stack([_batch(cfg, 4, 16, seed=10 * pod + step)[k]
                              for pod in range(2)])
                 for k in ("tokens", "labels")}
        r_pods, r_opts, rm = inner(r_pods, r_opts,
                                   {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jnp.asarray(step))
        t_pods, t_opts, tm = t_sync.inner_steps(
            tstep, t_pods, t_opts, {k: T(v) for k, v in batch.items()},
            step)
        for k in rm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(rm[k]),
                                       rtol=1e-5)
    for i in range(2):
        close_tree(lm_params_to_numpy(t_pods[i], cfg),
                   jax.tree.map(lambda x: np.asarray(x[i]), r_pods),
                   atol=STEP_ATOL, rtol=0)
    a, b = (p.state_dict() for p in t_pods)
    assert max(float((a[k] - b[k]).abs().max()) for k in a) > 0

    # the exchange on identical inputs: the reference's pods and outer state
    # cross to the port, so the two differ only by float32 rounding, far
    # below the int8 step (~2e-5 here) by which compression moves the
    # anchor, the momentum and the residuals.  A second round with no inner
    # steps exchanges the first round's residuals alone: the anchor and the
    # momentum show that they were carried.
    t_pods = [lm_params_from_numpy(jax.tree.map(lambda x: np.asarray(x[i]),
                                                r_pods), cfg, "cpu")
              for i in range(2)]
    t_outer = outer_state_from_numpy(to_numpy(r_outer), cfg, "cpu")
    r_sync_fn = jax.jit(lambda p, o: r_sync.global_sync(p, o,
                                                        compress=compress))
    for rnd in range(2):
        r_pods, r_outer = r_sync_fn(r_pods, r_outer)
        t_pods, t_outer = t_sync.global_sync(t_pods, t_outer,
                                             compress=compress)
        got = outer_state_to_numpy(t_outer, cfg)
        want = to_numpy(r_outer)
        close_tree(got, want, atol=SYNC_ATOL, rtol=0)
        for pod in t_pods:
            assert all(torch.equal(p, t_outer.anchor[k])
                       for k, p in pod.named_parameters())
        if rnd == 0:        # residuals far above the tolerance, or none
            residual = max(float(np.abs(r).max())
                           for r in jax.tree_util.tree_leaves(got["ef"]))
            assert (residual > 10 * SYNC_ATOL) == compress
    back = outer_state_from_numpy(want, cfg, "cpu")
    close_tree(outer_state_to_numpy(back, cfg), want, atol=0, rtol=0)
