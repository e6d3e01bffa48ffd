"""The port's LM substrate models against the JAX reference on the CPU:
configs, layers, attention, MoE, Mamba, stacks, the three model families
and the registry.

Inputs come from a numpy seed; weights are drawn by the reference and
carried into the port through ``repro_torch.convert``.  Both packages run
float32, and sum in different orders (XLA's dot and reduction trees
against PyTorch's), so values agree to a few ulps of their magnitude:
``ATOL`` / ``RTOL`` below, unless a test states its own.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as RefArchConfig
from repro.configs.base import LayerSpec as RefLayerSpec
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import mamba as r_mamba
from repro.models import moe as r_moe
from repro.models import stack as r_stack
from repro.models.registry import count_params as r_count_params
from repro.models.registry import get_model as r_get_model

from repro_torch.configs import (SHAPES, ArchConfig, LayerSpec, get_config,
                                 list_archs)
from repro_torch.configs.lm_smoke import DEMO_100M, SMOKE_FAMILIES
from repro_torch.convert import (lm_cache_to_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy, to_numpy)
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import mamba as t_mamba
from repro_torch.models import moe as t_moe
from repro_torch.models import stack as t_stack
from repro_torch.models.layers import Params
from repro_torch.models.registry import count_params, get_model, param_shapes

ATOL = 1e-4     # float32 values of magnitude <= ~10
RTOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ref_cfg(cfg: ArchConfig) -> RefArchConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["pattern"] = tuple(RefLayerSpec(**dataclasses.asdict(s))
                              for s in cfg.pattern)
    return RefArchConfig(**fields)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def close_tree(got, want, atol=ATOL, rtol=RTOL):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                                   rtol=rtol)


def port_weights(cfg, seed):
    """The port's model for ``cfg`` from a seed, and the same weights in
    the reference's param tree."""
    model = get_model(cfg).init(torch.Generator().manual_seed(seed), cfg,
                                device="cpu")
    return model, jax.tree.map(jnp.asarray, lm_params_to_numpy(model, cfg))


def as_params(tree):
    """A reference param sub-tree as the port's ``Params`` node."""
    return Params({k: (as_params(v) if isinstance(v, dict) else T(v))
                   for k, v in to_numpy(tree).items()})


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------

def test_configs_are_the_reference_copy():
    from repro.configs import base as r_base
    from repro.configs import get_config as r_get, list_archs as r_list
    assert list_archs() == r_list()
    got, want = get_config("graphhp-paper"), r_get("graphhp-paper")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (dataclasses.asdict(get_config("graphhp-paper", smoke=True))
            == dataclasses.asdict(r_get("graphhp-paper", smoke=True)))
    assert ({k: dataclasses.asdict(v) for k, v in r_base.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in SHAPES.items()})
    for cfg in SMOKE_FAMILIES.values():
        assert cfg.layers() == tuple(
            LayerSpec(**dataclasses.asdict(s)) for s in ref_cfg(cfg).layers())
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_demo_100m_is_the_example_model():
    spec = importlib.util.spec_from_file_location(
        "train_lm_example", os.path.join(ROOT, "examples", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert dataclasses.asdict(mod.small_lm()) == dataclasses.asdict(DEMO_100M)


MOE_BIG = ArchConfig(
    name="moe-count", family="moe", n_layers=6, d_model=256, n_heads=4,
    n_kv_heads=2, head_dim=64, d_ff=512, vocab=1000,
    pattern=(LayerSpec(moe=True), LayerSpec()), n_experts=16, top_k=2,
    d_expert=128, n_shared_experts=2, first_k_dense=1)


@pytest.mark.parametrize("cfg", [DEMO_100M, MOE_BIG,
                                 *SMOKE_FAMILIES.values()],
                         ids=lambda c: c.name)
def test_count_params_equals_reference(cfg):
    for active in (False, True):
        assert count_params(cfg, active) == r_count_params(ref_cfg(cfg),
                                                           active)
    assert cfg.n_params() == count_params(cfg)
    if cfg is DEMO_100M:
        assert count_params(cfg) == 100_124_800


def test_param_shapes_on_meta_follow_the_reference_tree():
    cfg = SMOKE_FAMILIES["moe"]
    meta = param_shapes(cfg)
    assert all(p.device.type == "meta" for p in meta.parameters())
    names = {n for n, _ in meta.named_parameters()}
    assert "stack.head.0.ffn.wi" in names          # first_k_dense head
    assert "stack.units.1.layer_0.ffn.shared_wo" in names
    ref = jax.eval_shape(lambda k: r_get_model(ref_cfg(cfg)).init(
        k, ref_cfg(cfg), jnp.bfloat16), jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = jax.tree_util.tree_leaves(ref)
    got = jax.tree_util.tree_leaves(lm_params_to_numpy(
        get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                            device="cpu"), cfg))
    assert [w.shape for w in want] == [g.shape for g in got]


@pytest.mark.parametrize("name", ["moe", "encdec"])
def test_weights_cross_both_ways(name):
    """A reference param tree (stacked units) into the port's model and
    back, bit for bit; a tree of another config is refused."""
    cfg = SMOKE_FAMILIES[name]
    rc = ref_cfg(cfg)
    rp = to_numpy(jax.jit(r_get_model(rc).init, static_argnums=(1, 2))(
        jax.random.PRNGKey(8), rc, jnp.float32))
    model = lm_params_from_numpy(rp, cfg, "cpu")
    assert all(p.requires_grad and p.device.type == "cpu"
               for p in model.parameters())
    close_tree(lm_params_to_numpy(model, cfg), rp, atol=0, rtol=0)
    n_units = t_stack._unit_specs(cfg, cfg.layers())[2]
    some = next(n for n, _ in model.named_parameters() if ".units." in n)
    assert some.startswith("stack.units.") or some.startswith("enc_stack.")
    assert len(model["stack"]["units"]) == n_units
    with pytest.raises(ValueError, match="does not hold"):
        lm_params_from_numpy(rp, SMOKE_FAMILIES["dense_gqa"], "cpu")


def test_to_numpy_copies_host_tensors():
    """``to_numpy`` is a copy: a port model's weights handed to the
    reference do not follow the port's in-place updates."""
    model, rp = port_weights(SMOKE_FAMILIES["dense_gqa"], 0)
    before = np.array(rp["embed"])
    with torch.no_grad():
        model["embed"].add_(1.0)
    np.testing.assert_array_equal(np.asarray(rp["embed"]), before)
    t = torch.zeros(3)
    a = to_numpy({"x": t})["x"]
    t += 1
    assert a.tolist() == [0.0, 0.0, 0.0]


def test_init_is_seeded_and_device_explicit():
    cfg = SMOKE_FAMILIES["dense_gqa"]
    api = get_model(cfg)
    a = api.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = api.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    c = api.init(torch.Generator().manual_seed(4), cfg, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
    bf = api.init(torch.Generator().manual_seed(3), cfg, torch.bfloat16,
                  device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.init(torch.Generator(), cfg)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 24).astype(np.float32) * 3 + 1
    p = {"scale": rng.randn(24).astype(np.float32),
         "bias": rng.randn(24).astype(np.float32)}
    want = r_layers.norm_fwd({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), kind, 1e-5)
    close(t_layers.norm_fwd({k: T(v) for k, v in p.items()}, T(x), kind,
                            1e-5), want)


@pytest.mark.parametrize("batched", [False, True])
def test_rope_and_positions(batched):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = (rng.randint(0, 500, (2, 7)) if batched
           else np.arange(7) + 100).astype(np.int32)
    close(t_layers.apply_rope(T(x), T(pos), 10_000.0),
          r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
          atol=2e-5)     # angles up to ~500 rad: cos/sin of f32 arguments
    close(t_layers.sinusoidal_positions(40, 24),
          r_layers.sinusoidal_positions(40, 24), atol=2e-5)
    close(t_layers.sinusoidal_position_at(37, 24),
          r_layers.sinusoidal_position_at(37, 24), atol=2e-5)


@pytest.mark.parametrize("kind,act", [("gated", "silu"), ("plain", "gelu"),
                                      ("gated", "relu")])
def test_mlp_softcap_matmul(kind, act):
    rng = np.random.RandomState(2)
    f = 2 * 20 if kind == "gated" else 20
    p = {"wi": rng.randn(16, f).astype(np.float32) * 0.3,
         "wo": rng.randn(20, 16).astype(np.float32) * 0.3}
    x = rng.randn(2, 5, 16).astype(np.float32)
    close(t_layers.mlp_fwd({k: T(v) for k, v in p.items()}, T(x), kind, act),
          r_layers.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), kind, act))
    y = rng.randn(4, 9).astype(np.float32) * 40
    close(t_layers.softcap(T(y), 15.0), r_layers.softcap(jnp.asarray(y), 15.0))
    assert torch.equal(t_layers.softcap(T(y), 0.0), T(y))
    xb = T(x).to(torch.bfloat16)
    out = t_layers.matmul(xb, T(p["wo"][:16]))
    assert out.dtype == torch.bfloat16
    close(out.float(), r_layers.matmul(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(p["wo"][:16])).astype(
                                           jnp.float32), atol=3e-2, rtol=1e-2)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (kw, chunk_q, chunk_kv): several q and kv chunks, so the online
    # softmax rescales across kv chunks
    (dict(causal=True), 8, 8),
    (dict(causal=False, cap=5.0), 12, 8),
    (dict(causal=True, window=6), 8, 8),        # one band per q chunk
    (dict(causal=True, window=20), 8, 8),       # band clipped at the end
    (dict(causal=True, kv_len=19, q_offset=0), 16, 4),
    (dict(causal=True, kv_start=True), 8, 8),   # left-padded rows
    (dict(causal=True, window=5, kv_start=True, cap=3.0), 4, 8),
]


@pytest.mark.parametrize("kw,cq,ckv", FLASH_CASES)
def test_flash_attention_chunked(kw, cq, ckv):
    rng = np.random.RandomState(3)
    q = rng.randn(2, 24, 4, 8).astype(np.float32)
    k = rng.randn(2, 24, 2, 8).astype(np.float32)
    v = rng.randn(2, 24, 2, 8).astype(np.float32)
    kw = dict(kw)
    if kw.pop("kv_start", False):
        start = np.array([0, 5], np.int32)
        rk, tk = dict(kv_start=jnp.asarray(start)), dict(kv_start=T(start))
    else:
        rk, tk = {}, {}
    want = jax.jit(lambda q, k, v, rk: r_attn.flash_attention(
        q, k, v, chunk_q=cq, chunk_kv=ckv, **kw, **rk))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rk)
    close(t_attn.flash_attention(T(q), T(k), T(v), chunk_q=cq, chunk_kv=ckv,
                                 **kw, **tk), want)


def test_flash_attention_backward_recomputes_chunks():
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(1, 16, 2, 8).astype(np.float32) for _ in range(3))

    def rf(q, k, v):
        return jnp.sum(r_attn.flash_attention(q, k, v, chunk_q=4,
                                              chunk_kv=8) ** 2)
    want = jax.jit(jax.grad(rf, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (T(a).requires_grad_() for a in (q, k, v))
    loss = torch.sum(t_attn.flash_attention(tq, tk, tv, chunk_q=4,
                                            chunk_kv=8) ** 2)
    loss.backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        close(g, w)


@pytest.mark.parametrize("window,kv_start", [(0, False), (6, False),
                                             (0, True)])
def test_decode_attention(window, kv_start):
    rng = np.random.RandomState(5)
    q = rng.randn(2, 1, 4, 8).astype(np.float32)
    k = rng.randn(2, 10, 2, 8).astype(np.float32)
    v = rng.randn(2, 10, 2, 8).astype(np.float32)
    kpos = np.array([10, 11, 12, 3, 4, 5, 6, 7, 8, 9] if window else
                    np.arange(10), np.int32)
    cur = 13 if window else 7
    start = np.array([2, 0], np.int32)
    extra_r = dict(kv_start=jnp.asarray(start)) if kv_start else {}
    extra_t = dict(kv_start=T(start)) if kv_start else {}
    want = jax.jit(lambda *a, **kw: r_attn.decode_attention(
        *a, cap=4.0, window=window, **kw))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(kpos), cur, **extra_r)
    close(t_attn.decode_attention(T(q), T(k), T(v), T(kpos), cur, cap=4.0,
                                  window=window, **extra_t), want)
    with pytest.raises(NotImplementedError, match="sharding slice"):
        t_attn.decode_attention(T(q), T(k), T(v), T(kpos), cur,
                                axis_name="model")


def _attn_cfg(**kw):
    return ArchConfig(name="attn", family="dense", n_layers=1, d_model=32,
                      n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab=64,
                      kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4,
                      v_head_dim=6, **kw)


@pytest.mark.parametrize("spec", [LayerSpec(), LayerSpec(attn="window",
                                                         window=5),
                                  LayerSpec(attn="mla")],
                         ids=["full", "window_ring", "mla"])
def test_attention_layer_prefill_then_decode(spec):
    """gqa_fwd / mla_fwd: train path, prefill into a cache (the window's
    ring buffer wraps: 12 prompt tokens in 5 slots), then decode steps
    through the ring (slot = position % 5) with left-pad offsets."""
    cfg = _attn_cfg()
    rc, rspec = ref_cfg(cfg), RefLayerSpec(**dataclasses.asdict(spec))
    init = r_attn.mla_init if spec.attn == "mla" else r_attn.gqa_init
    rfwd = jax.jit(r_attn.mla_fwd if spec.attn == "mla" else r_attn.gqa_fwd,
                   static_argnums=(2, 3))
    tfwd = t_attn.mla_fwd if spec.attn == "mla" else t_attn.gqa_fwd
    rp = jax.jit(init, static_argnums=1)(jax.random.PRNGKey(1), rc)
    tp = as_params(rp)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 12, 32).astype(np.float32)
    start = np.array([0, 3], np.int32)
    pos = np.maximum(np.arange(12)[None] - start[:, None], 0).astype(np.int32)

    y, _ = rfwd(rp, jnp.asarray(x), rspec, rc, positions=jnp.arange(12))
    ty, _ = tfwd(tp, T(x), spec, cfg, positions=torch.arange(12))
    close(ty, y)

    if spec.attn == "mla":
        rcache = r_attn.mla_cache_init(rc, 2, 16, jnp.float32)
        tcache = t_attn.mla_cache_init(cfg, 2, 16, torch.float32, "cpu")
    else:
        rcache = r_attn.gqa_cache_init(rc, rspec, 2, 16, jnp.float32)
        tcache = t_attn.gqa_cache_init(cfg, spec, 2, 16, torch.float32, "cpu")
    y, rcache = rfwd(rp, jnp.asarray(x), rspec, rc, positions=jnp.asarray(pos),
                     cache=rcache, cur_len=0, kv_start=jnp.asarray(start))
    ty, tcache = tfwd(tp, T(x), spec, cfg, positions=T(pos), cache=tcache,
                      cur_len=0, kv_start=T(start))
    close(ty, y)
    close_tree(to_numpy(tcache), rcache)
    for cur in range(12, 16):
        xt = rng.randn(2, 1, 32).astype(np.float32)
        p1 = (cur - start)[:, None].astype(np.int32)
        y, rcache = rfwd(rp, jnp.asarray(xt), rspec, rc,
                         positions=jnp.asarray(p1), cache=rcache,
                         cur_len=cur, kv_start=jnp.asarray(start))
        ty, tcache = tfwd(tp, T(xt), spec, cfg, positions=T(p1),
                          cache=tcache, cur_len=cur, kv_start=T(start))
        close(ty, y)
        close_tree(to_numpy(tcache), rcache)
    if spec.attn != "window":            # the ring never runs out
        with pytest.raises(ValueError, match="cache holds 16"):
            tfwd(tp, T(xt), spec, cfg, positions=T(p1), cache=tcache,
                 cur_len=16)


def test_cross_attention():
    cfg = _attn_cfg()
    rp = jax.jit(r_attn.cross_attn_init, static_argnums=1)(
        jax.random.PRNGKey(2), ref_cfg(cfg))
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 32).astype(np.float32)
    enc = rng.randn(2, 9, 32).astype(np.float32)
    close(t_attn.cross_attn_fwd(as_params(rp), T(x), T(enc), cfg),
          jax.jit(r_attn.cross_attn_fwd, static_argnums=3)(
              rp, jnp.asarray(x), jnp.asarray(enc), ref_cfg(cfg)))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_cfg(top_k=2, shared=1):
    return ArchConfig(name="moe", family="moe", n_layers=1, d_model=16,
                      n_heads=2, n_kv_heads=1, head_dim=8, d_ff=32, vocab=64,
                      pattern=(LayerSpec(moe=True),), n_experts=4,
                      top_k=top_k, d_expert=12, n_shared_experts=shared)


@pytest.mark.parametrize("case", ["random", "overflow", "tied_k1",
                                  "tied_k3"])
def test_moe_matches_reference(case):
    """Dispatch, capacity overflow (every token prefers expert 0, past its
    capacity of 5 per block) and tied router logits (duplicate router
    columns: the lower expert must win the tie, as in ``lax.top_k``)."""
    top_k = {"tied_k1": 1, "tied_k3": 3}.get(case, 2)
    cfg = _moe_cfg(top_k=top_k, shared=0 if case == "tied_k3" else 1)
    rc = ref_cfg(cfg)
    rp = {k: np.array(v) for k, v in
          to_numpy(jax.jit(r_moe.moe_init, static_argnums=1)(
              jax.random.PRNGKey(3), rc)).items()}
    rng = np.random.RandomState(8)
    x = rng.randn(2, 16, 16).astype(np.float32)
    if case == "overflow":
        rp["router"][:, 0] = 0.0
        x[..., 0] = 0.0
        x[..., 0] += 0.5
        rp["router"][0, 0] = 40.0
    if case.startswith("tied"):
        rp["router"][:, 1] = rp["router"][:, 0]
        rp["router"][:, 3] = rp["router"][:, 2]
    rj = {k: jnp.asarray(v) for k, v in rp.items()}
    want = jax.jit(r_moe.moe_fwd, static_argnums=2)(rj, jnp.asarray(x), rc)
    tp = {k: T(v) for k, v in rp.items()}
    close(t_moe.moe_fwd(tp, T(x), cfg), want)
    close(t_moe.moe_aux_loss(tp, T(x), cfg),
          jax.jit(r_moe.moe_aux_loss, static_argnums=2)(rj, jnp.asarray(x),
                                                        rc))
    gates = torch.softmax(T(x).reshape(-1, 16) @ tp["router"], -1)
    if case == "overflow":     # the case really overflows
        tb = 32 // t_moe._n_blocks(32)
        cap = max(1, int(tb * top_k / 4 * 1.25))
        top = t_moe._top_k(gates, top_k)[1]
        assert int((top == 0).sum()) > 2 * cap
    if case.startswith("tied"):
        _, idx = t_moe._top_k(gates, top_k)
        _, ridx = jax.lax.top_k(jnp.asarray(gates.numpy()), top_k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        assert bool((gates[:, 0] == gates[:, 1]).all())


def test_moe_gradients():
    cfg = _moe_cfg()
    rc = ref_cfg(cfg)
    rp = jax.jit(r_moe.moe_init, static_argnums=1)(jax.random.PRNGKey(4), rc)
    x = np.random.RandomState(9).randn(2, 8, 16).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(
        r_moe.moe_fwd(p, jnp.asarray(x), rc) ** 2)))(rp)
    tp = {k: T(v).requires_grad_() for k, v in to_numpy(rp).items()}
    torch.sum(t_moe.moe_fwd(tp, T(x), cfg) ** 2).backward()
    close_tree({k: p.grad.numpy() for k, p in tp.items()}, to_numpy(want))


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _mamba_cfg():
    return ArchConfig(name="ssm", family="ssm", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=1, head_dim=16, d_ff=0, vocab=64,
                      pattern=(LayerSpec(mixer="mamba"),), ssm_state=8,
                      ssm_head_dim=16, ssm_chunk=4)


def test_mamba_chunked_ssd_cache_and_decode():
    """Six SSD chunks of 4 (the inter-chunk recurrence runs), a prefill
    that carries a cache in and out, and decode steps; random A, D and
    dt biases so the decays differ by head."""
    cfg = _mamba_cfg()
    rc = ref_cfg(cfg)
    rp = {k: np.array(v) for k, v in
          to_numpy(jax.jit(r_mamba.mamba_init, static_argnums=1)(
              jax.random.PRNGKey(5), rc)).items()}
    fwd = jax.jit(r_mamba.mamba_fwd, static_argnums=2)
    dec = jax.jit(r_mamba.mamba_decode, static_argnums=2)
    rng = np.random.RandomState(10)
    for k in ("A_log", "dt_bias", "D", "conv_b"):
        rp[k] = (rng.randn(*rp[k].shape) * 0.5).astype(np.float32)
    rj = {k: jnp.asarray(v) for k, v in rp.items()}
    tp = {k: T(v) for k, v in rp.items()}
    u = rng.randn(2, 24, 32).astype(np.float32)
    y, _ = fwd(rj, jnp.asarray(u), rc)
    ty, _ = t_mamba.mamba_fwd(tp, T(u), cfg)
    close(ty, y)

    rcache = r_mamba.mamba_cache_init(rc, 2, jnp.float32)
    tcache = t_mamba.mamba_cache_init(cfg, 2, torch.float32, "cpu")
    for sl in (slice(0, 8), slice(8, 20)):       # prefill, then continue
        y, rcache = fwd(rj, jnp.asarray(u[:, sl]), rc, cache=rcache)
        ty, tcache = t_mamba.mamba_fwd(tp, T(u[:, sl]), cfg, cache=tcache)
        close(ty, y)
        close_tree(to_numpy(tcache), rcache)
    for t in range(20, 24):
        y, rcache = dec(rj, jnp.asarray(u[:, t:t + 1]), rc, rcache)
        ty, tcache = t_mamba.mamba_decode(tp, T(u[:, t:t + 1]), cfg, tcache)
        close(ty, y)
        close_tree(to_numpy(tcache), rcache)


def test_causal_conv_is_sum_of_shifted_products():
    rng = np.random.RandomState(11)
    x = rng.randn(2, 9, 6).astype(np.float32)
    w = rng.randn(4, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    st = rng.randn(2, 3, 6).astype(np.float32)
    for state in (None, st):
        want = r_mamba._causal_conv(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if state is None else jnp.asarray(state))
        got = t_mamba._causal_conv(T(x), T(w), T(b),
                                   None if state is None else T(state))
        close(got[0], want[0], atol=1e-6)
        close(got[1], want[1], atol=0)


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------

def test_unit_specs_head_units_tail():
    for cfg in SMOKE_FAMILIES.values():
        got = t_stack._unit_specs(cfg, cfg.layers())
        want = r_stack._unit_specs(ref_cfg(cfg), ref_cfg(cfg).layers())
        assert (tuple(map(len, (got[0], got[3]))) + got[2:3]
                == tuple(map(len, (want[0], want[3]))) + want[2:3])
    moe, win = SMOKE_FAMILIES["moe"], SMOKE_FAMILIES["window_softcap"]
    assert [len(t_stack._unit_specs(moe, moe.layers())[0]),
            t_stack._unit_specs(moe, moe.layers())[2]] == [1, 2]
    assert len(t_stack._unit_specs(win, win.layers())[3]) == 1


def test_stack_remat_gradients_match():
    """``remat=True`` (torch.utils.checkpoint per unit) gives the gradients
    of the plain loop, and both the reference's."""
    cfg = SMOKE_FAMILIES["hybrid"]
    rc = ref_cfg(cfg)
    _, rp = port_weights(cfg, 6)
    x = np.random.RandomState(12).randn(2, 8, 64).astype(np.float32)

    def rloss(p):
        y, _ = r_stack.stack_fwd(p["stack"], jnp.asarray(x), rc, rc.layers(),
                                 positions=jnp.arange(8), remat=False)
        return jnp.sum(y ** 2)
    want = dict(lm_params_from_numpy(to_numpy(jax.jit(jax.grad(rloss))(rp)),
                                     cfg,
                                     "cpu").named_parameters())
    grads = []
    for remat in (True, False):
        model = lm_params_from_numpy(to_numpy(rp), cfg, "cpu")
        y, _ = t_stack.stack_fwd(model["stack"], T(x), cfg, cfg.layers(),
                                 positions=torch.arange(8), remat=remat)
        torch.sum(y ** 2).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None})
    assert set(grads[0]) == {n for n in want if n.startswith("stack.")}
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
        close(g, want[n].detach(), atol=2e-4)


# ---------------------------------------------------------------------------
# whole models: every family, forward / prefill / decode, reference weights
# ---------------------------------------------------------------------------

_JIT = {}


def _ref_fns(rc):
    if rc not in _JIT:
        api = r_get_model(rc)
        _JIT[rc] = (jax.jit(api.forward, static_argnums=2),
                    jax.jit(api.prefill, static_argnums=3),
                    jax.jit(api.decode_step, static_argnums=4),
                    jax.jit(lambda p, t, c, n, s: api.decode_step(
                        p, t, c, n, rc, kv_start=s)))
    return _JIT[rc]


def family_batch(cfg, b, s, seed):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        batch["audio_embed"] = rng.randn(b, cfg.enc_frames,
                                         cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        batch["vis_embed"] = rng.randn(b, cfg.vis_tokens,
                                       cfg.vis_dim).astype(np.float32)
    return batch


@pytest.mark.parametrize("name", list(SMOKE_FAMILIES))
def test_family_forward_prefill_decode(name):
    """Forward over 32 tokens; prefill (left-padded through ``start`` for
    the decoder LMs) into a cache of 48, then 4 greedy decode steps; the
    logits and every cache leaf against the reference on the same
    weights and tokens."""
    cfg = SMOKE_FAMILIES[name]
    rc = ref_cfg(cfg)
    rfwd, rpre, rdec, rdec_kv = _ref_fns(rc)
    api = get_model(cfg)
    model, rp = port_weights(cfg, 7)

    batch = family_batch(cfg, 2, 32, seed=13)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: T(v) for k, v in batch.items()}
    with torch.no_grad():
        close(api.forward(model, tb, cfg), rfwd(rp, jb, rc))

    padded = cfg.family not in ("audio", "vlm")
    if padded:
        start = np.array([0, 7], np.int32)
        jb["start"], tb["start"] = jnp.asarray(start), T(start)
    rcache = r_get_model(rc).init_cache(rc, 2, 48, jnp.float32)
    tcache = api.init_cache(cfg, 2, 48, torch.float32, "cpu")
    want, rcache = rpre(rp, jb, rcache, rc)
    with torch.no_grad():
        got, tcache = api.prefill(model, tb, tcache, cfg)
    close(got, want)
    close_tree(lm_cache_to_numpy(tcache), to_numpy(rcache))
    cur = 32 + (cfg.vis_tokens if cfg.family == "vlm" else 0)
    tok = np.argmax(np.asarray(want), -1).astype(np.int32)
    for j in range(4):
        if padded:
            want, rcache = rdec_kv(rp, jnp.asarray(tok), rcache, cur + j,
                                   jb["start"])
        else:
            want, rcache = rdec(rp, jnp.asarray(tok), rcache, cur + j, rc)
        kw = dict(kv_start=tb["start"]) if padded else {}
        with torch.no_grad():
            got, tcache = api.decode_step(model, T(tok), tcache, cur + j,
                                          cfg, **kw)
        close(got, want)
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)
    close_tree(lm_cache_to_numpy(tcache), to_numpy(rcache))
