"""The port's kernel wrappers against the reference's Pallas kernels.

The same numpy-seeded inputs go through the JAX wrapper (Pallas interpret
mode, as ``tests/test_kernel_engine.py`` runs it) and through the port's
``ops.py`` on CPU tensors, which runs the plain PyTorch version.  Both fold
the slot axis in the same order, so the outputs must be bit-identical for
every semiring, for slot counts K of 8, 128, 136 and 300 (ragged last slot
blocks), and for an (N, L) lane frontier.  A second set of cases holds the
same pairs on the values the CUDA kernels treat specially: signed zeros
(the padding the wide ``ell_spmv`` path skips must still turn a -0.0 sum
into +0.0), ±inf ties and NaNs, and fold blocks that are all padding
between occupied ones.

One exception, and why: for the additive kernels (``ell_spmv`` add_mul,
``pr_step``) with a lane frontier, XLA:CPU contracts the reference's
``partial + val*x`` into fused multiply-adds for some lane widths, so the
reference's lane column j can differ in the last bit from its own
single-lane dispatch.  The port never contracts.  Those cases therefore
use inputs whose products are exact in float32 (a contraction cannot
change a bit), and a separate test holds each lane column of the port,
with arbitrary inputs, bit-equal to the reference's single-lane dispatch —
the lane contract the reference documents.

``ell_spmv``, ``min_step`` and ``pr_step`` are also held at L = 4 and 16,
the widths their lane-chunk CUDA paths take (the serving batches' K), and
the lane columns at L = 16 on the wide (K = 136) bins' lane path.

The CUDA kernels against their plain versions need a GPU: those tests are
marked ``gpu`` and skip here (``chip_smoke.py`` covers them on the card).
The reference is imported inside the tests, so the ``gpu`` cases collect
on a machine without JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import (BIN_LAUNCHES, LANE_LAUNCHES,
                                        LAUNCHES, SEMIRINGS)
from repro_torch.kernels.ell_spmv import ell_spmv, ell_spmv_ref, to_ell
from repro_torch.kernels.min_step import fused_min_step, fused_min_step_ref
from repro_torch.kernels.pr_step import fused_pr_step, fused_pr_step_ref

def jax_ell_spmv(*args, **kw):
    from repro.kernels.ell_spmv import ell_spmv as fn
    return fn(*args, **kw)


def jax_to_ell(*args, **kw):
    from repro.kernels.ell_spmv import to_ell as fn
    return fn(*args, **kw)


def jax_min_step(*args, **kw):
    from repro.kernels.min_step import fused_min_step as fn
    return fn(*args, **kw)


def jax_pr_step(*args, **kw):
    from repro.kernels.pr_step import fused_pr_step as fn
    return fn(*args, **kw)


ALL = ("add_mul", "min_add", "max_add", "min_mul", "max_min")
MONO = ("min_add", "max_add", "min_mul", "max_min")
KS = (8, 128, 136, 300)
LANES = (0, 3)
# the lane-chunk paths' widths
CHUNK_LANES = LANES + (4, 16)
R = 24          # rows; frontier N = R so the fused kernels' xrow defaults hold


def _bits_equal(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert want.shape == got.shape and want.dtype == got.dtype, \
        (want.shape, want.dtype, got.shape, got.dtype)
    assert np.array_equal(want.view(np.uint8), got.view(np.uint8)), \
        np.nonzero(want != got)


def _bits_equal_nan(want, got):
    """``_bits_equal`` outside NaNs, and NaN at the same positions.  A
    NaN's sign and payload are no part of the kernels' contract, and the
    two CPU frameworks differ in them: the reference gives +NaN where
    PyTorch's float32 ops give x86's default -NaN."""
    want, got = np.asarray(want), got.numpy()
    assert want.shape == got.shape and want.dtype == got.dtype
    if want.dtype != np.float32:
        return _bits_equal(want, torch.from_numpy(got))
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got)), np.nonzero(nan != np.isnan(got))
    _bits_equal(np.where(nan, 0.0, want).astype(np.float32),
                torch.from_numpy(np.where(nan, 0.0, got).astype(np.float32)))


def _inputs(seed, k, lanes, exact=False):
    """ELL tile + frontier.  ``exact``: dyadic values of few significant
    bits, whose products float32 holds exactly."""
    rng = np.random.RandomState(seed)
    shape = (R, lanes) if lanes else (R,)
    idx = rng.randint(0, R, size=(R, k)).astype(np.int32)
    msk = rng.rand(R, k) < 0.7
    if exact:
        val = (rng.randint(1, 16, size=(R, k)) / 8.0).astype(np.float32)
        x = (rng.randint(0, 64, size=shape) / 16.0).astype(np.float32)
    else:
        val = rng.uniform(0.05, 2.0, size=(R, k)).astype(np.float32)
        x = rng.uniform(0.0, 3.0, size=shape).astype(np.float32)
    send = rng.rand(*shape) < 0.6
    row = rng.uniform(0.0, 3.0, size=shape).astype(np.float32)
    return idx, val, msk, x, send, row


SPECIAL = ("signed_zeros", "inf_ties", "empty_blocks")
SPECIAL_KS = (8, 300)
PR_SPECIAL = SPECIAL + ("unsent_special_val",)


def _special_inputs(seed, k, lanes, case, semiring="add_mul"):
    """ELL tile + frontier on edge-case values, all dyadic so every
    product is exact (no contraction can change a bit, module doc).  Every
    third row is fully occupied.

    ``signed_zeros``: ±0 edge values (every fourth row all -0.0) against a
    frontier of the zero that keeps a product's sign, so sums and ties of
    ±0 decide the result.  ``inf_ties``: ±inf, ±0 and ±1 mixed in, giving
    ±inf ties and NaNs.  ``empty_blocks``: all-padding fold blocks between
    occupied ones (slots 128-255 at K = 300), half-empty rows with a gap
    and empty rows.  ``unsent_special_val`` (``pr_step``): every source's
    send flag the same in all lanes, and the occupied slots of unsent
    sources carry -0.0, -1, +inf or NaN, whose term (d·val)·0.0 is -0.0 or
    NaN; row 0's first slot is masked, and row 1 is fully occupied by
    unsent sources of -0.0 or -1 (a sum of -0.0 terms) with a -0.0
    ``extra`` (``row[-2]``, which the test reverses into ``extra``); +inf
    and NaN only in every fourth row."""
    rng = np.random.RandomState(seed)
    shape = (R, lanes) if lanes else (R,)
    dyadic = lambda size: (rng.randint(-16, 17, size=size) / 8.0) \
        .astype(np.float32)
    idx = rng.randint(0, R, size=(R, k)).astype(np.int32)
    msk = rng.rand(R, k) < 0.7
    msk[::3] = True
    val, x, row = dyadic((R, k)), dyadic(shape), dyadic(shape)
    if case == "signed_zeros":
        zeros = lambda size: np.where(rng.rand(*size) < 0.5, -0.0, 0.0) \
            .astype(np.float32)
        val, row = zeros((R, k)), zeros(shape)
        val[::4] = -0.0
        x = np.full(shape, -0.0 if semiring.endswith("_add") else 0.0,
                    dtype=np.float32)
    elif case == "inf_ties":
        pal = np.array([np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0],
                       dtype=np.float32)
        pick = lambda a: np.where(rng.rand(*a.shape) < 0.4,
                                  pal[rng.randint(0, len(pal), a.shape)], a)
        val, x, row = pick(val), pick(x), pick(row)
    elif case == "unsent_special_val":
        off = rng.rand(R) < 0.5
        off[:2] = (True, False)
        unsent = np.flatnonzero(off)
        idx[1] = unsent[rng.randint(0, len(unsent), size=k)]
        msk[0, 0] = False
        msk[1] = True
        pal = np.array([-0.0, -1.0, np.inf, np.nan], dtype=np.float32)
        # +inf and NaN only in every fourth row, so the others stay finite
        n_pal = np.where(np.arange(R) % 4 == 2, 4, 2)[:, None]
        pick = pal[(rng.rand(R, k) * n_pal).astype(np.int64)]
        val = np.where(off[idx], pick, val)
        val[1] = pal[rng.randint(0, 2, size=k)]
        row[R - 2] = -0.0
        send = np.broadcast_to((~off)[:, None] if lanes else ~off,
                               shape).copy()
        return idx, val, msk, x, send, row
    else:
        msk[:, 128:256] = False
        msk[1::2, k // 2:k // 2 + 2] = False
        msk[::5] = False
    send = rng.rand(*shape) < 0.6
    return idx, val, msk, x, send, row


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("lanes", CHUNK_LANES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("semiring", ALL)
def test_ell_spmv_matches_pallas(semiring, k, lanes):
    idx, val, msk, x, _, _ = _inputs(k + lanes, k, lanes,
                                     exact=lanes > 0 and semiring == "add_mul")
    want = jax_ell_spmv(idx, val, msk, x, semiring=semiring)
    got = ell_spmv(*_t(idx, val, msk, x), semiring=semiring)
    _bits_equal(want, got)


@pytest.mark.parametrize("lanes", CHUNK_LANES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("semiring", MONO)
def test_min_step_matches_pallas(semiring, k, lanes):
    idx, val, msk, x, send, row = _inputs(100 + k + lanes, k, lanes)
    # default xrow/extra for a single frontier, an explicit spill operand
    # with lanes (one reference compile per case keeps the file fast)
    extra = row if lanes else None
    want = jax_min_step(idx, val, msk, x, send, x, extra, semiring=semiring)
    got = fused_min_step(*_t(idx, val, msk, x, send), None,
                         None if extra is None else _t(extra)[0],
                         semiring=semiring)
    for w, g in zip(want, got):
        _bits_equal(w, g)


@pytest.mark.parametrize("lanes", CHUNK_LANES)
@pytest.mark.parametrize("k", KS)
def test_pr_step_matches_pallas(k, lanes):
    idx, val, msk, x, send, row = _inputs(200 + k + lanes, k, lanes,
                                          exact=lanes > 0)
    delta = (x / 64.0).astype(np.float32)
    extra = (row / 128.0).astype(np.float32) if lanes else row * 1e-3
    # a dyadic damping keeps the lane case's products exact (module doc)
    damping = 0.75 if lanes else 0.85
    # the default (zero) spill operand at K = 8, an explicit one otherwise
    ex = None if k == 8 else extra
    args = (idx, val, msk, delta, send, row)
    want = jax_pr_step(*args, ex, damping=damping, tol=1e-3)
    got = fused_pr_step(*_t(*args), None if ex is None else _t(ex)[0],
                        damping=damping, tol=1e-3)
    for w, g in zip(want, got):
        _bits_equal(w, g)


@pytest.mark.parametrize("kernel", ["ell_spmv", "pr_step"])
@pytest.mark.parametrize("k,lanes", [(8, 3), (136, 3), (136, 16)],
                         ids=["8", "136", "136-L16"])
def test_lane_columns_match_single_lane_pallas(kernel, k, lanes):
    """Arbitrary float inputs: each lane column of the port equals the
    reference's single-lane dispatch of that column, bit for bit (L = 16
    at K = 136: the wide bins' lane path)."""
    seed = 300 + k + (lanes if lanes > 3 else 0)
    idx, val, msk, x, send, row = _inputs(seed, k, lanes=lanes)
    if kernel == "ell_spmv":
        got = ell_spmv(*_t(idx, val, msk, x)).numpy()
    else:
        got = fused_pr_step(*_t(idx, val, msk, x, send, row),
                            damping=0.85, tol=1e-3)[1].numpy()
    for j in range(lanes):
        cols = [np.ascontiguousarray(a[:, j]) for a in (x, send, row)]
        if kernel == "ell_spmv":
            want = jax_ell_spmv(idx, val, msk, cols[0])
        else:
            want = jax_pr_step(idx, val, msk, *cols, damping=0.85,
                               tol=1e-3)[1]
        _bits_equal(want, torch.from_numpy(np.ascontiguousarray(got[:, j])))


@pytest.mark.parametrize("lanes", LANES + (16,))
@pytest.mark.parametrize("k", SPECIAL_KS)
@pytest.mark.parametrize("case", SPECIAL)
@pytest.mark.parametrize("semiring", ALL)
def test_ell_spmv_special_values_match_pallas(semiring, case, k, lanes):
    idx, val, msk, x, _, _ = _special_inputs(400 + k + lanes, k, lanes,
                                             case, semiring)
    want = jax_ell_spmv(idx, val, msk, x, semiring=semiring)
    got = ell_spmv(*_t(idx, val, msk, x), semiring=semiring)
    _bits_equal(want, got)


@pytest.mark.parametrize("lanes", LANES + (16,))
@pytest.mark.parametrize("k", SPECIAL_KS)
@pytest.mark.parametrize("case", SPECIAL)
@pytest.mark.parametrize("semiring", MONO)
def test_min_step_special_values_match_pallas(semiring, case, k, lanes):
    idx, val, msk, x, send, row = _special_inputs(500 + k + lanes, k, lanes,
                                                  case, semiring)
    extra = row[::-1].copy()
    want = jax_min_step(idx, val, msk, x, send, row, extra,
                        semiring=semiring)
    got = fused_min_step(*_t(idx, val, msk, x, send, row, extra),
                         semiring=semiring)
    for w, g in zip(want, got):
        _bits_equal(w, g)


@pytest.mark.parametrize("lanes", LANES + (16,))
@pytest.mark.parametrize("k", SPECIAL_KS)
@pytest.mark.parametrize("case", PR_SPECIAL)
def test_pr_step_special_values_match_pallas(case, k, lanes):
    idx, val, msk, x, send, row = _special_inputs(600 + k + lanes, k, lanes,
                                                  case)
    extra = row[::-1].copy()
    args = (idx, val, msk, x, send, row, extra)
    want = jax_pr_step(*args, damping=0.75, tol=1e-3)
    got = fused_pr_step(*_t(*args), damping=0.75, tol=1e-3)
    same = _bits_equal_nan if case == "unsent_special_val" else _bits_equal
    for w, g in zip(want, got):
        same(w, g)


def _edge_list(seed, n, e, hub):
    """``e`` random (src, dst) pairs over ``n`` vertices (duplicates kept),
    plus ``hub`` extra edges into vertex 1."""
    rng = np.random.RandomState(seed)
    edges = rng.randint(0, n, size=(e, 2))
    extra = np.stack([rng.randint(0, n, size=hub), np.ones(hub, int)], 1)
    edges = np.concatenate([edges, extra]).astype(np.int64)
    w = rng.uniform(-1.0, 2.0, size=len(edges)).astype(np.float32)
    return edges, w


# (n_rows, edges, hub in-degree, pad_rows, pad_slices): a ragged row count,
# an in-degree above pad_slices, a K of several slice widths, no edges
TO_ELL_CASES = ((37, 200, 0, 8, 128), (37, 200, 150, 8, 128),
                (61, 400, 70, 16, 32), (5, 0, 0, 8, 128))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", range(len(TO_ELL_CASES)))
def test_to_ell_matches_reference(case, weighted):
    """The port's COO -> ELL packer against the reference's, array for
    array (dtype, shape, bits), then ``ell_spmv`` over each package's own
    packing, bit for bit (the parity contract)."""
    n, e, hub, pad_rows, pad_slices = TO_ELL_CASES[case]
    edges, w = _edge_list(case, n, e, hub)
    kw = dict(weights=w if weighted else None, pad_rows=pad_rows,
              pad_slices=pad_slices)
    want = jax_to_ell(edges, n, **kw)
    got = to_ell(edges, n, device="cpu", **kw)
    rows = -(-n // pad_rows) * pad_rows
    assert got[0].shape[0] == rows and got[0].shape[1] % pad_slices == 0
    assert got[0].shape[1] >= max(pad_slices, hub)
    for a, b in zip(want, got):
        _bits_equal(a, b)
    x = np.random.RandomState(case).uniform(size=rows).astype(np.float32)
    for semiring in ("add_mul", "min_add"):
        _bits_equal(jax_ell_spmv(*want, x, semiring=semiring),
                    ell_spmv(*got, torch.from_numpy(x), semiring=semiring))


def test_to_ell_needs_a_device_without_a_gpu():
    """The default device is ``cuda``: without a GPU the packer raises
    rather than fall back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_ell(np.zeros((1, 2), np.int64), 4)


def test_plain_versions_do_not_count_launches():
    before = dict(LAUNCHES)
    idx, val, msk, x, send, row = _inputs(7, 8, 0)
    ell_spmv(*_t(idx, val, msk, x))
    fused_min_step(*_t(idx, val, msk, x, send))
    fused_pr_step(*_t(idx, val, msk, x, send, row))
    assert LAUNCHES == before


@pytest.mark.parametrize("bad", ["idx_dtype", "val_shape", "msk_dtype",
                                 "x_rank", "send_shape", "device"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    idx, val, msk, x, send, row = _t(*_inputs(8, 8, 0))
    if bad == "idx_dtype":
        idx = idx.long()
    elif bad == "val_shape":
        val = val[:, :4]
    elif bad == "msk_dtype":
        msk = msk.to(torch.uint8)
    elif bad == "x_rank":
        x = x[:, None, None]
    elif bad == "send_shape":
        send = send[:5]
    else:
        idx, val, msk, x, send, row = (t.to("meta") for t in
                                       (idx, val, msk, x, send, row))
    with pytest.raises(ValueError):
        if bad == "send_shape":
            fused_min_step(idx, val, msk, x, send)
        else:
            ell_spmv(idx, val, msk, x)


# the gpu test's frontier widths: (N,), the thread-per-(row, lane) paths
# (3, 6), the lane-chunk paths (4, 16, 64) and the wide bins' lane path
# (16, 64; 4 keeps the wide bins' 4-lane chunks)
GPU_LANES = (0, 3, 4, 6, 16, 64)


def _element_off(t, n=1):
    """``t`` copied into a buffer ``n`` elements larger, viewed from its
    element ``n``: contiguous, but its data 4n (or n) bytes off the
    allocation's alignment."""
    buf = torch.empty(t.numel() + n, dtype=t.dtype, device=t.device)
    buf[n:] = t.reshape(-1)
    return buf[n:].view(t.shape)


def _kernel_names(fn, want):
    """Names of the CUDA kernels ``fn()`` launched (``torch.profiler``),
    session after session until each name of ``want`` is a substring of
    one, over up to three sessions that return device records.  Now and
    then a session's device records are lost whole (only the host's
    runtime calls come back; H100, torch 2.11; three sessions in a row
    have been seen to lose them), which can hide a kernel but never show
    one that did not run: such a session is not one of the three, up to
    eight sessions in all.  Returns the names and the number of sessions
    (each called ``fn`` once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names, seen, n = set(), 0, 0
    while seen < 3 and n < 8:
        n += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got = {e.key for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
        seen += bool(got)
        names |= got
        if all(any(w in k for k in names) for w in want):
            break
    return names, n


def _expect_kernels(names, on, off, where):
    """Every name of ``on`` a substring of a launched kernel's, none of
    ``off``."""
    for kernel in on:
        assert any(kernel in n for n in names), (where, kernel, names)
    for kernel in off:
        assert not any(kernel in n for n in names), (where, kernel, names)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", ["none", "element"])
@pytest.mark.parametrize("lanes", GPU_LANES)
def test_cuda_kernels_match_plain_versions(lanes, offset):
    """On the card: each kernel bit-identical to its plain version on the
    same CUDA tensors, and each launch counted.  ``pr_step`` also on the
    unsent-special-val inputs at K = 8 and 16, whose fresh (aligned) tiles
    take the rows path with an (N,) frontier and a lane path with lanes
    (NaN by position, as on the CPU).  All three also at K = 7, 8 and 16,
    the narrow bins: with L % 4 == 0 and an aligned frontier they launch
    the lane-chunk kernels (``pr_step``'s walk kernel at K = 8 and 16;
    with the mask four bytes off alignment, its fold_row4 kernel), with
    any other L or a frontier one element off alignment (``offset``) the
    thread-per-(row, lane) kernels.  ``ell_spmv`` also at K = 128, 136
    and 300, the wide bins: with L % 4 == 0 beyond 4 lanes and an aligned
    frontier they take the lane path (the ``true`` instances), otherwise
    the scalar 4-lane chunks; with an (N,) frontier at K = 136 and 300 the
    planned kernel, a warp per occupied fold block (checked by kernel
    name, and each wide bin's launches counted under its shape, with
    lanes in ``LANE_LAUNCHES``, without in ``BIN_LAUNCHES``), also on a
    tile of no occupied slot (an empty block plan)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    front = _element_off if offset == "element" else (lambda t: t)
    calls = dict.fromkeys(LAUNCHES, 0)              # launches this test makes
    bins = {}                                       # wide ell_spmv calls by shape
    idx, val, msk, x, send, row = (t.cuda() for t in
                                   _t(*_inputs(9, 136, lanes)))
    x, send, row = front(x), front(send), front(row)
    before, lane_before = dict(LAUNCHES), dict(LANE_LAUNCHES)
    bin_before = dict(BIN_LAUNCHES)
    for sr in ALL:
        _bits_equal(ell_spmv_ref(idx, val, msk, x, semiring=sr).cpu().numpy(),
                    ell_spmv(idx, val, msk, x, semiring=sr).cpu())
    calls["ell_spmv"] += len(ALL)
    bins[f"{R}x136"] = len(ALL)
    for sr in MONO:
        ident = torch.full_like(x, SEMIRINGS[sr][2])
        want = fused_min_step_ref(idx, val, msk, x, send, x, ident,
                                  semiring=sr)
        got = fused_min_step(idx, val, msk, x, send, semiring=sr)
        for w, g in zip(want, got):
            _bits_equal(w.cpu().numpy(), g.cpu())
    calls["min_step"] += len(MONO)
    want = fused_pr_step_ref(idx, val, msk, x, send, row,
                             torch.zeros_like(row), tol=1e-3)
    got = fused_pr_step(idx, val, msk, x, send, row, tol=1e-3)
    for w, g in zip(want, got):
        _bits_equal(w.cpu().numpy(), g.cpu())
    calls["pr_step"] += 1
    for k in (8, 16):
        idx, val, msk, x, send, row = (t.cuda() for t in _t(
            *_special_inputs(700 + k, k, lanes, "unsent_special_val")))
        x, send, row = front(x), front(send), front(row)
        extra = front(row.flip(0).contiguous())
        want = fused_pr_step_ref(idx, val, msk, x, send, row, extra,
                                 damping=0.75, tol=1e-3)
        got = fused_pr_step(idx, val, msk, x, send, row, extra,
                            damping=0.75, tol=1e-3)
        for w, g in zip(want, got):
            _bits_equal_nan(w.cpu().numpy(), g.cpu())
        calls["pr_step"] += 1
    chunks = lanes % 4 == 0 and lanes > 0 and offset == "none"
    for k in (7, 8, 16):
        idx, val, msk, x, send, row = (t.cuda() for t in
                                       _t(*_inputs(800 + k, k, lanes)))
        x, send, row = front(x), front(send), front(row)
        extra = front(row.flip(0).contiguous())
        for sr in ALL:
            _bits_equal(
                ell_spmv_ref(idx, val, msk, x, semiring=sr).cpu().numpy(),
                ell_spmv(idx, val, msk, x, semiring=sr).cpu())
        for sr in MONO:
            want = fused_min_step_ref(idx, val, msk, x, send, row, extra,
                                      semiring=sr)
            got = fused_min_step(idx, val, msk, x, send, row, extra,
                                 semiring=sr)
            for w, g in zip(want, got):
                _bits_equal(w.cpu().numpy(), g.cpu())
        dl = x / 64.0
        want = fused_pr_step_ref(idx, val, msk, dl, send, row, extra,
                                 tol=1e-3)
        got = fused_pr_step(idx, val, msk, dl, send, row, extra, tol=1e-3)
        for w, g in zip(want, got):
            _bits_equal(w.cpu().numpy(), g.cpu())
        calls["ell_spmv"] += len(ALL)
        calls["min_step"] += len(MONO)
        calls["pr_step"] += 1
        if lanes > 1:
            pr_lane = "pr_step_walk_kernel" if k in (8, 16) else \
                "pr_step_lanes_kernel"
            lane_kernels = ("ell_lanes_kernel", "min_step_lanes_kernel",
                            pr_lane)
            thread_kernels = ("ell_narrow_kernel<", "min_step_kernel<",
                              "pr_step_kernel<")
            names, sessions = _kernel_names(
                lambda: (ell_spmv(idx, val, msk, x, semiring="min_add"),
                         fused_min_step(idx, val, msk, x, send, row, extra),
                         fused_pr_step(idx, val, msk, dl, send, row, extra)),
                lane_kernels if chunks else thread_kernels)
            for name in calls:
                calls[name] += sessions * (name != "graph_loop")
            _expect_kernels(names, *((lane_kernels, thread_kernels) if chunks
                                     else (thread_kernels, lane_kernels)), k)
        if chunks:
            # mask rows 4-byte but not K-aligned: fold_row4 from L1
            mw = _element_off(msk, 4)
            want = fused_pr_step_ref(idx, val, mw, dl, send, row, extra,
                                     tol=1e-3)
            got = fused_pr_step(idx, val, mw, dl, send, row, extra, tol=1e-3)
            for w, g in zip(want, got):
                _bits_equal(w.cpu().numpy(), g.cpu())
            names, sessions = _kernel_names(
                lambda: fused_pr_step(idx, val, mw, dl, send, row, extra),
                ("pr_step_lanes_kernel",))
            calls["pr_step"] += 1 + sessions
            _expect_kernels(names, ("pr_step_lanes_kernel",),
                            ("pr_step_walk_kernel",), (k, "mask+4"))
    vec = chunks and lanes > 4
    for k in (128, 136, 300):
        idx, val, msk, x, _, _ = (t.cuda() for t in
                                  _t(*_inputs(900 + k, k, lanes)))
        x = front(x)
        for sr in ALL:
            _bits_equal(
                ell_spmv_ref(idx, val, msk, x, semiring=sr).cpu().numpy(),
                ell_spmv(idx, val, msk, x, semiring=sr).cpu())
        calls["ell_spmv"] += len(ALL)
        shape = f"{R}x{k}"
        bins[shape] = bins.get(shape, 0) + len(ALL)
        if lanes > 1:
            kernel = "ell_warp_rows_kernel<1, 1, " if k == 128 else \
                "ell_block_rows_kernel<1, "
            on, off = kernel + ("true>" if vec else "false>"), \
                kernel + ("false>" if vec else "true>")
        elif k > 128:
            # an (N,) frontier on a wide bin: a warp per plan entry
            on, off = "ell_plan_blocks_kernel<1>", "ell_block_rows_kernel<"
        else:
            continue
        names, sessions = _kernel_names(
            lambda: ell_spmv(idx, val, msk, x, semiring="min_add"), (on,))
        calls["ell_spmv"] += sessions
        bins[shape] += sessions
        _expect_kernels(names, (on,), (off,), k)
    # a wide tile of no occupied slot: an empty block plan
    idx, val, msk, x, _, _ = (t.cuda() for t in _t(*_inputs(950, 300, lanes)))
    msk, x = torch.zeros_like(msk), front(x)
    for sr in ALL:
        _bits_equal(ell_spmv_ref(idx, val, msk, x, semiring=sr).cpu().numpy(),
                    ell_spmv(idx, val, msk, x, semiring=sr).cpu())
    calls["ell_spmv"] += len(ALL)
    bins[f"{R}x300"] += len(ALL)
    lanes_on = lanes > 1
    for name, n in calls.items():
        assert LAUNCHES[name] == before[name] + n, (name, n)
        if name != "graph_loop":
            assert LANE_LAUNCHES[name] == lane_before[name] + lanes_on * n
    for shape, n in bins.items():
        key = f"ell_spmv {shape}"
        assert LANE_LAUNCHES.get(key, 0) == \
            lane_before.get(key, 0) + lanes_on * n, (key, n)
        assert BIN_LAUNCHES.get(key, 0) == \
            bin_before.get(key, 0) + (not lanes_on) * n, (key, n)
