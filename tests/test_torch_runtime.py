"""The port's runtime combines against the reference's on edge values: the
spill-bin ⊕-scatter (``runtime._scatter`` against the reference's
``_SCATTER``, padded rows on the drop sentinel included) and the pairwise
inbox merge (``merge_inbox``), on signed zeros, ±inf ties and NaN.  min and
max follow ``jnp.minimum`` / ``jnp.maximum`` bit for bit: -0.0 below +0.0,
NaN propagates.  NaN compares by position only: payloads may differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.runtime import _SCATTER
from repro.core.runtime import merge_inbox as jax_merge_inbox
from repro.core.vertex_program import Channel as JaxChannel

from repro_torch.core.runtime import _scatter, merge_inbox
from repro_torch.core.vertex_program import Channel

PALETTE = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 2.5, np.nan],
                   dtype=np.float32)


def _values(rng, shape, nan):
    pal = PALETTE if nan else PALETTE[:-1]
    return rng.choice(pal, shape).astype(np.float32)


def _assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    gn, wn = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(got[~gn].view(np.int32),
                                  want[~wn].view(np.int32))


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("lanes", [0, 3])
@pytest.mark.parametrize("semiring", sorted(_SCATTER))
def test_spill_scatter_matches_reference(semiring, lanes, nan):
    rng = np.random.default_rng(7)
    n, nb = 96, 64
    tail = (lanes,) if lanes else ()
    y = _values(rng, (n,) + tail, nan)
    v = _values(rng, (nb,) + tail, nan)
    rows = rng.permutation(n)[:nb].astype(np.int32)
    rows[::5] = n                      # padded rows carry the sentinel
    want = _SCATTER[semiring](jnp.asarray(y), jnp.asarray(rows),
                              jnp.asarray(v))
    got = _scatter(semiring, torch.from_numpy(y), torch.from_numpy(rows),
                   torch.from_numpy(v))
    _assert_same(got.numpy(), want)


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("combiner", ["min", "max", "sum"])
def test_merge_inbox_matches_reference(combiner, nan):
    rng = np.random.default_rng(11)
    shape = (4, 50)
    pa, pb = _values(rng, shape, nan), _values(rng, shape, nan)
    ha, hb = rng.random(shape) < 0.5, rng.random(shape) < 0.5
    ident = {"min": np.inf, "max": -np.inf, "sum": 0.0}[combiner]
    jch = JaxChannel("m", combiner, ((jnp.float32, ident),))
    ch = Channel("m", combiner, ((torch.float32, ident),))
    (want,), want_has = jax_merge_inbox(
        jch, ((jnp.asarray(pa),), jnp.asarray(ha)),
        ((jnp.asarray(pb),), jnp.asarray(hb)))
    (got,), got_has = merge_inbox(
        ch, ((torch.from_numpy(pa),), torch.from_numpy(ha)),
        ((torch.from_numpy(pb),), torch.from_numpy(hb)))
    _assert_same(got.numpy(), want)
    np.testing.assert_array_equal(got_has.numpy(), np.asarray(want_has))
