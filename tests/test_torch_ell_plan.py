"""The wide (K > 128) ``ell_spmv`` bins' block plan, on the CPU.

The CUDA kernel of a wide bin reads only the fold blocks its plan lists
(``kernels/ell_spmv/plan.py``, ``csrc/ell_spmv.cu``).  Here:

* the plan lists exactly the 128-slot fold blocks that hold an occupied
  slot, in row-major order, on masks with ragged last blocks, empty rows,
  leading, middle and trailing all-padding blocks, and rows of more than
  256 occupied blocks (K > 32,768: more than one round of the lane path);
* a plain emulation of the planned fold (each listed block's partial over
  its occupied slots in slot order, then ⊕ e where the block skipped a
  slot; the row's partials left to right, each run of unlisted blocks as
  one ⊕ e) equals the plain version and the reference's ``ell_spmv``
  (Pallas interpret mode) bit for bit, NaN by position, for all five
  semirings at L = 0, 4 and 16, on the special values of
  ``test_torch_kernels``;
* the engines keep one plan per bin and graph, outside ``graph_digest``;
  copies and block views build their own; a lookup that misses under a
  (mocked) stream capture raises; a checkpoint key hashes its graph once
  per graph object, as the plans are kept;
* the hybrid engine on a graph with wide bins matches the reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import build_partitioned_graph as jax_build
from repro.core import run_hybrid as jax_run_hybrid
from repro.core.apps import SSSP as JaxSSSP
from repro.core.apps import IncrementalPageRank as JaxPageRank

from repro_torch import (SSSP, IncrementalPageRank, build_partitioned_graph,
                         run_hybrid)
from repro_torch.core import runtime
from repro_torch.core.apps import pagerank_edge_weights
from repro_torch.core.distributed import block_view
from repro_torch.core.runtime import build_ell_plans, ell_plans
from repro_torch.io.digest import graph_digest
from repro_torch.kernels.common import FOLD_SLICES, SEMIRINGS
from repro_torch.kernels.ell_spmv import ell_block_plan, ell_spmv, \
    ell_spmv_ref

from test_torch_engine import _snapshot
from test_torch_kernels import (ALL, SPECIAL, _bits_equal_nan,
                                _special_inputs, jax_ell_spmv)


# (name, R, K): masks of every shape the plan must get right
MASKS = (("ragged", 16, 300), ("ragged-136", 16, 136),
         ("empty-rows", 16, 300), ("leading-middle-trailing", 12, 1000),
         ("one-slot-blocks", 10, 700), ("rounds", 3, 33_000),
         ("rounds-gaps", 3, 66_000), ("all-padding", 4, 260))


def _mask(name, rows, k):
    rng = np.random.RandomState(rows * 7 + k)
    msk = rng.rand(rows, k) < 0.3
    nb = -(-k // FOLD_SLICES)
    blocks = np.arange(k) // FOLD_SLICES
    if name == "empty-rows":
        msk[::3] = False
    elif name == "leading-middle-trailing":
        # row r keeps blocks r % 3 .. nb - 1 - r % 2, minus every third
        for r in range(rows):
            keep = (blocks >= r % 3) & (blocks <= nb - 1 - r % 2) & \
                (blocks % 3 != 1)
            msk[r] &= keep
    elif name == "one-slot-blocks":
        msk[:] = False
        for r in range(rows):
            for b in range(r % 2, nb, 2):
                msk[r, min(k - 1, b * FOLD_SLICES + (r * 37 + b) % 128)] = True
    elif name == "rounds":
        msk[:] = rng.rand(rows, k) < 0.9
    elif name == "rounds-gaps":
        msk &= (blocks % 4 != 2)[None, :]
        msk[1, :5 * FOLD_SLICES] = False
        msk[2, -3 * FOLD_SLICES:] = False
    elif name == "all-padding":
        msk[:] = False
    return msk


@pytest.mark.parametrize("name,rows,k", MASKS, ids=[m[0] for m in MASKS])
def test_plan_lists_the_occupied_fold_blocks(name, rows, k):
    msk = _mask(name, rows, k)
    plan = ell_block_plan(torch.from_numpy(msk))
    want_rows, want_blocks = [], []
    for r in range(rows):
        for b in range(-(-k // FOLD_SLICES)):
            if msk[r, b * FOLD_SLICES:(b + 1) * FOLD_SLICES].any():
                want_rows.append(r)
                want_blocks.append(b)
    assert plan.shape == (rows, k) and plan.nnzb == len(want_blocks)
    assert plan.blk.dtype == plan.row.dtype == plan.ptr.dtype == torch.int32
    assert plan.blk.tolist() == want_blocks
    assert plan.row.tolist() == want_rows
    assert plan.ptr.tolist() == [0] + np.cumsum(
        np.bincount(want_rows, minlength=rows)).tolist()
    assert plan.nbytes == 4 * (rows + 1 + 6 * plan.nnzb)
    # each entry's occupancy bits: bit i of word q is slot 32q + i
    bits = plan.bits.numpy().view(np.uint32)
    for e, (r, b) in enumerate(zip(want_rows, want_blocks)):
        block = np.zeros(FOLD_SLICES, dtype=bool)
        seg = msk[r, b * FOLD_SLICES:(b + 1) * FOLD_SLICES]
        block[:len(seg)] = seg
        want = [int(sum(1 << i for i in range(32) if block[32 * q + i]))
                for q in range(4)]
        assert bits[e].tolist() == want, (e, r, b)
    if name == "rounds":
        assert (plan.ptr[1:] - plan.ptr[:-1]).max() > 256
    if name == "rounds-gaps":
        assert plan.blk[plan.ptr[1]] == 5          # leading empties
        assert plan.blk[plan.ptr[3] - 1] < -(-k // FOLD_SLICES) - 3


def test_plan_takes_only_wide_bool_masks():
    with pytest.raises(ValueError, match="only K > 128"):
        ell_block_plan(torch.ones((4, 128), dtype=torch.bool))
    with pytest.raises(ValueError, match="bool"):
        ell_block_plan(torch.ones((4, 300), dtype=torch.uint8))


def planned_fold(idx, val, msk, x, semiring, plan):
    """The K > 128 kernels' fold in plain torch: each listed block's
    partial over its occupied slots only, in slot order, then ⊕ e where
    the block skipped a slot (masked, or past K in a ragged last block);
    the row's partials left to right, each run of unlisted blocks one ⊕ e,
    a row of none e."""
    combine, times, ident = SEMIRINGS[semiring]
    rows, k = idx.shape
    nb = -(-k // FOLD_SLICES)
    lane = (lambda a: a[..., None]) if x.dim() == 2 else (lambda a: a)
    e = torch.full((rows,) + tuple(x.shape[1:]), ident)
    parts = []
    for b in range(nb):
        lo, hi = b * FOLD_SLICES, min(k, (b + 1) * FOLD_SLICES)
        part, started = e, torch.zeros(rows, dtype=torch.bool)
        for s in range(lo, hi):
            v = times(lane(val[:, s]), x[idx[:, s]])
            m = msk[:, s]
            part = torch.where(lane(m), torch.where(
                lane(started), combine(part, v), v), part)
            started = started | m
        skipped = msk[:, lo:hi].sum(1) < FOLD_SLICES
        parts.append(torch.where(lane(skipped), combine(part, e), part))
    out = []
    ptr, blk = plan.ptr.tolist(), plan.blk.tolist()
    for r in range(rows):
        acc, prev = e[r], -1
        for j in range(ptr[r], ptr[r + 1]):
            b = blk[j]
            if b > prev + 1:
                acc = e[r] if prev < 0 else combine(acc, e[r])
            acc = parts[b][r] if b == 0 else combine(acc, parts[b][r])
            prev = b
        if prev < nb - 1:
            acc = e[r] if prev < 0 else combine(acc, e[r])
        out.append(acc)
    return torch.stack(out)


def _signed_zero_runs(lanes, semiring):
    """K = 384 (three whole fold blocks), every occupied product -0.0
    (the zero that keeps the edge value's sign): rows of whole -0.0 blocks
    with leading, middle or trailing all-padding blocks, where only the
    runs of padding (one +0.0 each under add_mul) turn the sum into
    +0.0."""
    k, rows = 3 * FOLD_SLICES, 8
    idx = (np.arange(rows * k).reshape(rows, k) % rows).astype(np.int32)
    val = np.full((rows, k), -0.0, dtype=np.float32)
    x = np.full((rows, lanes) if lanes else (rows,),
                -0.0 if semiring.endswith("_add") else 0.0, dtype=np.float32)
    msk = np.ones((rows, k), dtype=bool)
    for r, empty in enumerate(((0,), (1,), (2,), (0, 2), (0, 1), (1, 2),
                               (0, 1, 2), ())):
        for b in empty:
            msk[r, b * FOLD_SLICES:(b + 1) * FOLD_SLICES] = False
    return idx, val, msk, x


@pytest.mark.parametrize("lanes", (0, 4, 16))
@pytest.mark.parametrize("case", SPECIAL + ("signed_zero_runs",))
@pytest.mark.parametrize("semiring", ALL)
def test_planned_fold_matches_plain_and_pallas(semiring, case, lanes):
    if case == "signed_zero_runs":
        idx, val, msk, x = _signed_zero_runs(lanes, semiring)
    else:
        idx, val, msk, x, _, _ = _special_inputs(1000 + lanes, 300, lanes,
                                                 case, semiring)
    if case == "empty_blocks":
        msk[2::4, :FOLD_SLICES] = False            # leading empties
        msk[3::4, 2 * FOLD_SLICES:] = False        # trailing empties
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (idx, val, msk, x)]
    plan = ell_block_plan(t[2])
    got = planned_fold(*t, semiring, plan)
    _bits_equal_nan(ell_spmv_ref(*t, semiring=semiring).numpy(), got)
    _bits_equal_nan(jax_ell_spmv(idx, val, msk, x, semiring=semiring), got)
    # the wrapper on CPU tensors: the plain version, the plan ignored
    _bits_equal_nan(got.numpy(), ell_spmv(*t, semiring=semiring, plan=plan))


# a graph whose high in-degree rows spill into bins wider than 128 slots,
# local (vertex 0, 349 in-edges inside partition 0) and remote (vertex 0,
# 400 in-edges from partition 1)
def _wide_edges():
    rng = np.random.RandomState(5)
    n = 800
    part = np.where(np.arange(n) < 350, 0, 1).astype(np.int32)
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n], 1)
    star = np.stack([np.arange(1, 750), np.zeros(749, np.int64)], 1)
    hub2 = np.stack([np.arange(360, 800), np.full(440, 360)], 1)
    extra = rng.randint(0, n, size=(1600, 2))
    edges = np.concatenate([ring, star, hub2, extra]).astype(np.int64)
    edges = edges[edges[:, 0] != edges[:, 1]]
    return edges, n, part


def _wide_graph(**kw):
    edges, n, part = _wide_edges()
    return build_partitioned_graph(
        edges, n, part, weights=pagerank_edge_weights(edges, n),
        device="cpu", ell_base_slices=16, **kw)


def test_wide_graph_has_wide_bins_on_both_sides():
    g = _wide_graph()
    for edges in ("local", "remote"):
        plans = ell_plans(g, edges)
        kbs = [s.kb for s in runtime.ell_slices(g, edges)]
        assert max(kbs) > FOLD_SLICES, (edges, kbs)
        for s, plan in zip(runtime.ell_slices(g, edges), plans):
            assert (plan is None) == (s.kb <= FOLD_SLICES)
            if plan is not None:
                assert plan.shape == tuple(s.msk.reshape(-1, s.kb).shape)


def test_plans_are_cached_once_per_graph_outside_the_digest(monkeypatch):
    built = []
    real = runtime.ell_block_plan
    monkeypatch.setattr(runtime, "ell_block_plan",
                        lambda m: built.append(m.shape) or real(m))
    g = _wide_graph()
    digest = graph_digest(g)
    prog = IncrementalPageRank(tolerance=1e-4)
    run_hybrid(g, prog, max_iters=3, device="cpu")
    n_wide = sum(s.kb > FOLD_SLICES for s in g.local_ell + g.remote_ell)
    assert len(built) == n_wide > 1
    local = ell_plans(g, "local")
    run_hybrid(g, prog, max_iters=3, device="cpu")
    build_ell_plans(g)
    assert len(built) == n_wide
    assert ell_plans(g, "local") is local
    assert graph_digest(g) == digest


def test_copies_and_block_views_build_their_own_plans():
    g = _wide_graph(edge_blocks=2)
    build_ell_plans(g)
    for copy in (block_view(g, 0, 1, device="cpu"),
                 block_view(g, 1, 2, device="cpu"),
                 dataclasses.replace(g)):
        assert "_ell_plans" not in copy.__dict__
        plans = ell_plans(copy, "remote")
        assert plans is not ell_plans(g, "remote")
        for s, plan in zip(copy.remote_ell, plans):
            if plan is not None:
                want = ell_block_plan(s.msk.reshape(-1, s.kb))
                assert plan.ptr.tolist() == want.ptr.tolist()
                assert plan.blk.tolist() == want.blk.tolist()


def test_a_miss_under_a_capture_raises(monkeypatch):
    g, built = _wide_graph(), _wide_graph()
    build_ell_plans(built)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="before this stream capture"):
        ell_plans(g, "local")
    assert "local" not in g.__dict__.get("_ell_plans", {})
    with pytest.raises(RuntimeError, match="stream capture"):
        ell_block_plan(g.local_ell[-1].msk.reshape(-1, g.local_ell[-1].kb))
    assert ell_plans(built, "local") is built.__dict__["_ell_plans"]["local"]


def test_checkpoint_key_hashes_a_graph_once(monkeypatch):
    from repro_torch.exec import checkpoint
    from repro_torch.io import digest as digest_mod
    calls = []
    real = digest_mod.graph_digest
    monkeypatch.setattr(digest_mod, "graph_digest",
                        lambda g: calls.append(1) or real(g))
    g = _wide_graph()
    prog = IncrementalPageRank(tolerance=1e-4)
    want = real(g)
    assert checkpoint.checkpoint_key(g, prog)["graph_digest"] == want
    assert checkpoint.checkpoint_key(g, prog)["graph_digest"] == want
    assert len(calls) == 1
    copy = dataclasses.replace(g)
    assert checkpoint.checkpoint_key(copy, prog)["graph_digest"] == want
    assert len(calls) == 2


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_hybrid_on_wide_bins_matches_reference(app):
    edges, n, part = _wide_edges()
    w = pagerank_edge_weights(edges, n)
    kw = dict(weights=w, ell_base_slices=16)
    make_jax, make_port = {
        "sssp": (lambda: JaxSSSP(source=1), lambda: SSSP(source=1)),
        "pagerank": (lambda: JaxPageRank(tolerance=1e-4),
                     lambda: IncrementalPageRank(tolerance=1e-4))}[app]
    want = _snapshot(*jax_run_hybrid(jax_build(edges, n, part, **kw),
                                     make_jax(), max_iters=500))
    got = _snapshot(*run_hybrid(build_partitioned_graph(
        edges, n, part, device="cpu", **kw), make_port(), max_iters=500,
        device="cpu"))
    assert got == want
