"""Sequence parallelism in the port (``sharding.util.seq_parallel`` /
``seq_axis``, ``sharding.fsdp.shard_seq`` / ``gather_seq``, the stack's
sharded residual stream) on the CPU.

* The switch against the reference's ``set_seq_parallel`` / ``seq_axis``,
  both settings, and restored after the block.
* One spawn of 4 gloo ranks on CPU tensors, a (data 2, model 2) mesh:
  the sharded train step with sequence parallelism on (dense, and MoE
  with a head layer) against the one-process step from the same weights
  and batches, at the ``chip_smoke.py`` ``mesh`` bounds (each step's
  loss and clipping norm 1e-5 relative, each leaf's first moment 1e-4 of
  its largest, its weights 0.1 of its largest move); the remat carry a
  rank holds between units, (B / 2, S / 2, D); prefill logits over the
  sequence-sharded cache within 1e-4 of the one-process prefill; a
  sequence of odd length (zero-padded, cut back) likewise; and the
  gather's backward: a slice of the gradient, not a sum over the ranks.
* The same train steps and prefills against the reference's one-device
  ``train_step`` and ``prefill`` with its ``set_seq_parallel(True)`` (its
  ``layer_fwd`` constraint is the identity without a mesh, so it is the
  same computation), from the same weights and inputs: losses and norms
  1e-5 relative, weights, first moments and logits within ``REF_ATOL``
  (``test_torch_sharding``'s bound on the port against the reference).
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.lm_smoke import SMOKE_FAMILIES
from repro_torch.core import distributed as D
from repro_torch.models.registry import get_model
from repro_torch.models.stack import _unit_specs
from repro_torch.sharding import rules as R
from repro_torch.sharding import util as U
from test_torch_sharding import REF_ATOL, jx, ref_cfg

DEADLINE = 300.0
CPU = dict(backend="gloo", device="cpu", threads=1)
DATA, MODEL = 2, 2
# chip_smoke.py's mesh bounds (PERF.md section 2)
LOSS_RTOL = NORM_RTOL = 1e-5
MU_RTOL = 1e-4
UPDATE_RTOL = 0.1
LOGITS_ATOL = 1e-4
TRAIN_FAMILIES = ("dense_gqa", "moe")
PREFILL_FAMILIES = ("dense_gqa", "hybrid")
STEPS = 2
KW = dict(peak_lr=1e-3, warmup=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def ref_util():
    from repro.sharding import util
    return util


@pytest.mark.parametrize("enabled", [False, True])
def test_seq_axis_matches_reference(enabled):
    ref = ref_util()
    try:
        ref.set_seq_parallel(enabled)
        with U.seq_parallel(enabled):
            assert U.seq_axis() == ref.seq_axis()
        assert U.seq_axis() is None
        U.set_seq_parallel(enabled)
        assert U.seq_axis() == ref.seq_axis()
    finally:
        ref.set_seq_parallel(False)
        U.set_seq_parallel(False)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _model(cfg, state):
    model = get_model(cfg).init(torch.Generator(), cfg, torch.float32, "cpu")
    model.load_state_dict(state)
    return model


def _job_train(rank, mesh, cfg, state, batches):
    """``STEPS`` sharded steps with sequence parallelism on; the losses,
    norms, gathered weights and first moments, and the shape of every
    remat carry (the checkpointed units' input)."""
    from repro_torch.launch.specs import shard_module
    from repro_torch.models import stack
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.sharding.fsdp import gather_full, sharding_of
    from repro_torch.train.trainer import make_train_step
    model = _model(cfg, state)
    model = shard_module(model, U.named(U.sanitize_specs(
        R.param_specs(model), model, mesh), mesh))
    opt = adamw_init(model)
    step = make_train_step(cfg, get_model(cfg), **KW)
    carries, checkpoint = [], stack.checkpoint

    def spy(fn, x, *args, **kw):
        carries.append(tuple(x.shape))
        return checkpoint(fn, x, *args, **kw)
    metrics = []
    stack.checkpoint = spy
    try:
        with U.seq_parallel():
            for s, batch in enumerate(batches):
                shard = U.named(U.sanitize_specs(R.batch_spec(batch), batch,
                                                 mesh), mesh)
                model, opt, m = step(model, opt, U.place_tree(batch, shard),
                                     s)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        stack.checkpoint = checkpoint
    full = {k: gather_full(p._local_tensor, sharding_of(p))
            for k, p in model.named_parameters()}
    mu = {k: gather_full(v._local_tensor, sharding_of(v))
          for k, v in opt.mu.items()}
    return metrics, full, mu, carries


def _job_prefill(rank, mesh, cfg, state, tokens, start):
    """Prefill of this rank's rows over the sequence-sharded cache, with
    sequence parallelism on."""
    api = get_model(cfg)
    rows, d = tokens.shape[0] // DATA, mesh.get_coordinate()[0]
    cut = slice(d * rows, (d + 1) * rows)
    cache = api.init_cache(cfg, tokens.shape[0], tokens.shape[1] + 8,
                           torch.float32, "cpu")
    cache, axis = U.shard_cache(cache, mesh)
    with U.use_mesh(mesh), U.seq_parallel(), torch.no_grad():
        logits, _ = api.prefill(_model(cfg, state),
                                {"tokens": tokens[cut], "start": start[cut]},
                                cache, cfg, decode_axis=axis)
    return logits


def _job_grad(rank, mesh, x, w):
    """d/dx of sum(gather(shard(x)) * w) over the ``model`` group: each
    rank's whole ``x`` and its gradient, and its slice's shape."""
    from repro_torch.sharding.fsdp import gather_seq, shard_seq
    group = mesh.get_group("model")
    x = x.clone().requires_grad_()
    local = shard_seq(x, group)
    y = gather_seq(local, group, x.shape[1])
    (g,) = torch.autograd.grad(torch.sum(y * w), x)
    return torch.equal(y, x.detach()), g, tuple(local.shape)


def _rank_jobs(rank, world, group, device, jobs):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(DATA, MODEL)
    out = [globals()[f"_job_{name}"](rank, mesh, *args)
           for name, args in jobs]
    return tuple(mesh.get_coordinate()), out


def _train_inputs(name, seq):
    cfg = SMOKE_FAMILIES[name]
    model = get_model(cfg).init(torch.Generator().manual_seed(11), cfg,
                                torch.float32, "cpu")
    g = torch.Generator().manual_seed(12)
    batches = [{k: torch.randint(0, cfg.vocab, (8, seq), generator=g)
                for k in ("tokens", "labels")} for _ in range(STEPS)]
    return cfg, model.state_dict(), batches


def _prefill_inputs(name, seq):
    cfg = SMOKE_FAMILIES[name]
    model = get_model(cfg).init(torch.Generator().manual_seed(4), cfg,
                                torch.float32, "cpu")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, cfg.vocab, (4, seq), generator=g)
    return cfg, model.state_dict(), tokens, torch.tensor([0, 3, 7, 1])


# (family, sequence length): 16 divides over model 2; 15 does not
TRAIN_CASES = [(n, 16) for n in TRAIN_FAMILIES] + [("dense_gqa", 15)]
PREFILL_CASES = [(n, 16) for n in PREFILL_FAMILIES] + [("dense_gqa", 15)]
GRAD_SEQS = (8, 7)


def _grad_inputs(seq):
    rng = np.random.RandomState(seq)
    return tuple(torch.from_numpy(rng.randn(2, seq, 3).astype(np.float32))
                 for _ in range(2))


@pytest.fixture(scope="module")
def world4():
    jobs = [("train", _train_inputs(*c)) for c in TRAIN_CASES]
    jobs += [("prefill", _prefill_inputs(*c)) for c in PREFILL_CASES]
    jobs += [("grad", _grad_inputs(s)) for s in GRAD_SEQS]
    res = D.spawn_ranks(_rank_jobs, 4, args=(jobs,), deadline_s=DEADLINE,
                        **CPU)
    return res


def _one_process_train(cfg, state, batches):
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import make_train_step
    model = _model(cfg, state)
    opt, step = adamw_init(model), make_train_step(cfg, get_model(cfg), **KW)
    metrics = []
    with U.seq_parallel():          # no mesh: the switch changes nothing
        for s, batch in enumerate(batches):
            model, opt, m = step(model, opt, batch, s)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, {k: p.detach() for k, p in model.named_parameters()}, \
        opt.mu


def _rel(diff, scale):
    return diff / scale if scale > 0 else (0.0 if diff == 0 else np.inf)


def _reference_train(cfg, state, batches):
    """The reference's jitted one-device steps with its sequence-parallel
    switch on (read when the step is traced): each step's loss and norm,
    then its weights and first moments (stacked units)."""
    from repro_torch.convert import lm_params_to_numpy
    j = jx()
    rc = ref_cfg(cfg)
    rp = j.jax.tree.map(j.jnp.asarray,
                        lm_params_to_numpy(_model(cfg, state), cfg))
    ropt, metrics = j.adamw.adamw_init(rp), []
    j.util.set_seq_parallel(True)
    try:
        rstep = j.jax.jit(j.trainer.make_train_step(
            rc, j.registry.get_model(rc), **KW))
        for s, batch in enumerate(batches):
            rp, ropt, rm = rstep(rp, ropt, {k: j.jnp.asarray(v.numpy())
                                            for k, v in batch.items()},
                                 j.jnp.asarray(s))
            metrics.append((float(rm["loss"]), float(rm["grad_norm"])))
    finally:
        j.util.set_seq_parallel(False)
    return metrics, rp, ropt.mu


def _reference_prefill(cfg, state, tokens, start):
    """The reference's one-device prefill logits, its switch on."""
    from repro_torch.convert import lm_params_to_numpy
    j = jx()
    rc = ref_cfg(cfg)
    rapi = j.registry.get_model(rc)
    rp = j.jax.tree.map(j.jnp.asarray,
                        lm_params_to_numpy(_model(cfg, state), cfg))
    cache = rapi.init_cache(rc, tokens.shape[0], tokens.shape[1] + 8,
                            j.jnp.float32)
    j.util.set_seq_parallel(True)
    try:
        logits, _ = j.jax.jit(lambda p, b, c: rapi.prefill(p, b, c, rc))(
            rp, {"tokens": j.jnp.asarray(tokens.numpy()),
                 "start": j.jnp.asarray(start.numpy())}, cache)
    finally:
        j.util.set_seq_parallel(False)
    return np.asarray(logits)


def _tree_close(got: dict, cfg, want, atol):
    """A port name -> tensor dict (the parameters' names) against a
    reference tree, leaf for leaf."""
    from repro_torch.convert import lm_params_to_numpy
    j = jx()
    got = lm_params_to_numpy(_model(cfg, got), cfg)
    for a, b in zip(j.jax.tree_util.tree_leaves(got),
                    j.jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("case", range(len(TRAIN_CASES)))
def test_seq_parallel_train_matches_one_process(world4, case):
    """``STEPS`` steps on (data 2, model 2) with sequence parallelism on
    against the one-process steps, at the mesh bounds, and against the
    reference's steps with its switch on; every rank's remat carry is its
    slice of the sequence, (B / 2, ceil(S / 2), D)."""
    name, seq = TRAIN_CASES[case]
    cfg, state, batches = _train_inputs(name, seq)
    want_m, want_p, want_mu = _one_process_train(cfg, state, batches)
    ref_m, ref_p, ref_mu = _reference_train(cfg, state, batches)
    n_units = _unit_specs(cfg, cfg.layers())[2]
    for coord, out in world4:
        metrics, full, mu, carries = out[case]
        for (loss, norm), (wl, wn) in zip(metrics, want_m):
            assert abs(loss / wl - 1) <= LOSS_RTOL, (coord, loss, wl)
            assert abs(norm / wn - 1) <= NORM_RTOL, (coord, norm, wn)
        for k, p in want_p.items():
            move = float((p - state[k]).abs().max())
            assert _rel(float((full[k] - p).abs().max()), move) \
                <= UPDATE_RTOL, k
            assert _rel(float((mu[k] - want_mu[k]).abs().max()),
                        float(want_mu[k].abs().max())) <= MU_RTOL, k
        np.testing.assert_allclose(metrics, ref_m, rtol=LOSS_RTOL)
        _tree_close(full, cfg, ref_p, REF_ATOL)
        _tree_close(mu, cfg, ref_mu, REF_ATOL)
        # the forward's checkpoints (the recompute runs inside them)
        assert carries == [(8 // DATA, -(-seq // MODEL), cfg.d_model)] \
            * n_units * STEPS, (coord, carries)


@pytest.mark.parametrize("case", range(len(PREFILL_CASES)))
def test_seq_parallel_prefill_matches_one_process(world4, case):
    """The data ranks' rows of the prefill logits, with sequence
    parallelism on, against the one-process prefill and the reference's
    with its switch on."""
    name, seq = PREFILL_CASES[case]
    cfg, state, tokens, start = _prefill_inputs(name, seq)
    api = get_model(cfg)
    cache = api.init_cache(cfg, 4, seq + 8, torch.float32, "cpu")
    with torch.no_grad():
        want, _ = api.prefill(_model(cfg, state),
                              {"tokens": tokens, "start": start}, cache, cfg)
    k = len(TRAIN_CASES) + case
    rows = {}
    for coord, out in world4:
        rows.setdefault(coord[0], []).append(out[k])
    got = torch.cat([rows[d][0] for d in range(DATA)])
    for d in range(DATA):
        assert torch.equal(rows[d][0], rows[d][1])   # the model ranks agree
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGITS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), _reference_prefill(
        cfg, state, tokens, start), atol=REF_ATOL, rtol=0)


@pytest.mark.parametrize("case", range(len(GRAD_SEQS)))
def test_gather_backward_is_a_slice_not_a_sum(world4, case):
    """The gathered stream is the whole one, and its gradient reaches the
    whole input once: ``w``, where a reduce-scatter (a sum over the 2
    ranks) would give 2 ``w``."""
    seq = GRAD_SEQS[case]
    x, w = _grad_inputs(seq)
    k = len(TRAIN_CASES) + len(PREFILL_CASES) + case
    for coord, out in world4:
        same, g, shape = out[k]
        assert same
        assert torch.equal(g, w), coord
        assert shape == (2, -(-seq // MODEL), 3)
