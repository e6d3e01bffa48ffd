"""The port's other apps against the reference, on the CPU.

* K-lane programs: every lane column of a port ``MultiSourceMonotone``
  (each monotone semiring) or ``PersonalizedPageRank`` run, on each engine
  × {ell, dense}, bit-identical to the reference's *single-lane* run from
  that lane's source.  Not against the reference's own K-lane runs: for
  some lane widths XLA:CPU contracts its ``add_mul`` folds into FMAs
  (ROADMAP Queue 3), which the port never does.
* WidestPath, RandomWalk in both modes and WCC on the hub fixture against
  live reference runs, every engine × delivery (the golden suite holds the
  odds walk only).
* Oracles: WCC against scipy's connected components, bipartite matching
  a valid maximal matching; ``_hash2``, ``sources_digest`` and
  ``reachable`` against the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_partitioned_graph as jax_build
from repro.core import run_am as jax_run_am
from repro.core import run_bsp as jax_run_bsp
from repro.core import run_hybrid as jax_run_hybrid
from repro.core.apps import WCC as JaxWCC
from repro.core.apps import PersonalizedPageRank as JaxPPR
from repro.core.apps import RandomWalk as JaxRandomWalk
from repro.core.apps import SSSP as JaxSSSP
from repro.core.apps import WidestPath as JaxWidestPath
from repro.core.apps import reachable as jax_reachable
from repro.core.apps.bipartite_matching import _hash2 as jax_hash2
from repro.core.apps.multi import sources_digest as jax_sources_digest
from repro.core.graph import unpack_vertex as jax_unpack

from repro_torch import (WCC, BipartiteMatching, MultiSourceMonotone,
                         PersonalizedPageRank, RandomWalk, WidestPath,
                         build_partitioned_graph, pagerank_edge_weights,
                         random_walk_edge_weights, run_am, run_bsp,
                         run_hybrid, unpack_vertex)
from repro_torch.core.apps import reachable, sources_digest
from repro_torch.core.apps.bipartite_matching import _hash2
from repro_torch.data.graphs import bipartite_graph, rmat_graph, symmetrize
from repro_torch.partition import hash_partition

from test_torch_engine import _snapshot
from test_torch_graph import fixture

RUNNERS = {"bsp": run_bsp, "am": run_am, "hybrid": run_hybrid}
JAX_RUNNERS = {"bsp": jax_run_bsp, "am": jax_run_am,
               "hybrid": jax_run_hybrid}
CONFIGS = [(e, u) for e in ("bsp", "am", "hybrid") for u in (True, False)]
CONFIG_IDS = [f"{e}-{'ell' if u else 'dense'}" for e, u in CONFIGS]


def _pair(edges, n, part, w):
    return (jax_build(edges, n, part, weights=w),
            build_partitioned_graph(edges, n, part, weights=w, device="cpu"))


# ---------------------------------------------------------------------------
# K-lane programs against the reference's single-lane runs
# ---------------------------------------------------------------------------

# semiring -> (edge weights of its convention, the reference's scalar app
# from one source, its state key)
MONOTONE = {
    "min_add": ("sin", lambda s: JaxSSSP(source=s), "dist"),
    "max_min": ("sin", lambda s: JaxWidestPath(source=s), "cap"),
    "min_mul": ("odds", lambda s: JaxRandomWalk(s, "odds"), "mass"),
    "max_add": ("logprob", lambda s: JaxRandomWalk(s, "logprob"), "mass"),
}


def _lane_graph(weights: str):
    edges, n = rmat_graph(128, avg_degree=5, seed=3)
    if weights == "sin":
        w = (np.abs(np.sin(np.arange(len(edges)))) * 0.9 + 0.05).astype(
            np.float32)
    elif weights == "pagerank":
        w = pagerank_edge_weights(edges, n)
    else:
        w = random_walk_edge_weights(edges, n, weights)
    return _pair(edges, n, hash_partition(n, 4, seed=0), w) + (n,)


@pytest.fixture(scope="module")
def monotone_singles():
    """{semiring: (port graph, n, sources, reference single-source states
    (n, K))} — a monotone fixed point does not depend on the engine, so
    one reference run per source serves every port configuration."""
    out = {}
    for sr, (weights, make, key) in MONOTONE.items():
        jg, g, n = _lane_graph(weights)
        sources = [0, n - 1, 17]
        cols = [np.asarray(jax_unpack(jg, jax_run_hybrid(
            jg, make(s))[0].state[key])) for s in sources]
        out[sr] = (g, n, sources, np.stack(cols, axis=1))
    return out


@pytest.mark.parametrize("engine,use_ell", CONFIGS, ids=CONFIG_IDS)
@pytest.mark.parametrize("semiring", sorted(MONOTONE))
def test_multisource_lanes_match_single_runs(monotone_singles, semiring,
                                             engine, use_ell):
    g, n, sources, want = monotone_singles[semiring]
    prog = MultiSourceMonotone(lanes=len(sources), semiring=semiring)
    es, _ = RUNNERS[engine](g, prog, use_ell=use_ell, device="cpu",
                            vdata={"sources": np.asarray(sources)})
    got = unpack_vertex(g, es.state["val"])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


PPR_SEEDS = [7, 90]


@pytest.fixture(scope="module")
def ppr_graphs():
    return _lane_graph("pagerank")


@pytest.mark.parametrize("engine,use_ell", CONFIGS, ids=CONFIG_IDS)
def test_ppr_lanes_match_single_runs(ppr_graphs, engine, use_ell):
    """A sum program's result depends on the engine's schedule and fold
    order: each configuration against the reference's single-seed runs of
    the same configuration."""
    jg, g, n = ppr_graphs
    es, _ = RUNNERS[engine](g, PersonalizedPageRank(PPR_SEEDS),
                            use_ell=use_ell, device="cpu")
    got = unpack_vertex(g, es.state["rank"])
    for j, s in enumerate(PPR_SEEDS):
        es1, _ = JAX_RUNNERS[engine](jg, JaxPPR([s]), use_ell=use_ell)
        want = np.asarray(jax_unpack(jg, es1.state["rank"]))[:, 0]
        assert np.array_equal(got[:, j].view(np.int32), want.view(np.int32)), j
    assert got[PPR_SEEDS[0], 0] > 0 and got[PPR_SEEDS[1], 1] > 0


def test_lane_program_helpers():
    srcs = np.array([5, 0, 9])
    assert sources_digest(srcs) == jax_sources_digest(srcs)
    assert sources_digest(torch.from_numpy(srcs)) == jax_sources_digest(srcs)
    d = np.array([[0.0, np.inf], [1.5, 2.0]], np.float32)
    np.testing.assert_array_equal(reachable(torch.from_numpy(d)).numpy(),
                                  np.asarray(jax_reachable(jnp.asarray(d))))
    with pytest.raises(ValueError):
        MultiSourceMonotone([0], semiring="add_mul")
    with pytest.raises(ValueError):
        PersonalizedPageRank()
    assert MultiSourceMonotone(lanes=4).lanes == 4


# ---------------------------------------------------------------------------
# scalar apps on the hub fixture against live reference runs
# ---------------------------------------------------------------------------

def _hub_pair(app):
    edges, n, part, _, kw = fixture("hub")
    if app == "wcc":
        edges = symmetrize(edges)
        edges = edges[edges[:, 0] != edges[:, 1]]
        w = None
    elif app == "widest":
        w = (np.random.default_rng(19).uniform(0.5, 8.0, len(edges))
             .astype(np.float32))
    else:
        w = random_walk_edge_weights(edges, n, app.split("_")[1])
    return (jax_build(edges, n, part, weights=w, **kw),
            build_partitioned_graph(edges, n, part, weights=w, device="cpu",
                                    **kw))


HUB_APPS = {
    "wcc": (lambda: JaxWCC(), lambda: WCC()),
    "widest": (lambda: JaxWidestPath(source=0), lambda: WidestPath(source=0)),
    "walk_odds": (lambda: JaxRandomWalk(0, "odds"),
                  lambda: RandomWalk(0, "odds")),
    "walk_logprob": (lambda: JaxRandomWalk(0, "logprob"),
                     lambda: RandomWalk(0, "logprob")),
}


@pytest.mark.parametrize("engine,use_ell", CONFIGS, ids=CONFIG_IDS)
@pytest.mark.parametrize("app", sorted(HUB_APPS))
def test_hub_app_runs_match_reference(app, engine, use_ell):
    jg, g = _hub_pair(app)
    make_jax, make_port = HUB_APPS[app]
    want = _snapshot(*JAX_RUNNERS[engine](jg, make_jax(), max_iters=500,
                                          use_ell=use_ell))
    got = _snapshot(*RUNNERS[engine](g, make_port(), max_iters=500,
                                     use_ell=use_ell, device="cpu"))
    assert got == want


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["bsp", "hybrid"])
def test_wcc_matches_connected_components(engine):
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    rng = np.random.default_rng(2)
    n = 300
    edges = symmetrize(rng.integers(0, n, (260, 2)))
    edges = edges[edges[:, 0] != edges[:, 1]]
    g = build_partitioned_graph(edges, n, hash_partition(n, 6, seed=1),
                                device="cpu")
    es, _ = RUNNERS[engine](g, WCC(), device="cpu")
    got = unpack_vertex(g, es.state["label"])
    _, comp = connected_components(
        csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                   shape=(n, n)), directed=False)
    # HashMin's label is the smallest vertex id of each component
    want = np.array([np.flatnonzero(comp == c).min() for c in comp])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("engine,use_ell", CONFIGS, ids=CONFIG_IDS)
def test_bipartite_matching_is_maximal(engine, use_ell):
    edges, n_left, n = bipartite_graph(60, 50, avg_degree=3, seed=5)
    g = build_partitioned_graph(edges, n, hash_partition(n, 4, seed=2),
                                device="cpu")
    vdata = {"is_left": g.vertex_gid < n_left, "degree": g.out_degree}
    es, _ = RUNNERS[engine](g, BipartiteMatching(seed=3), vdata=vdata,
                            use_ell=use_ell, device="cpu")
    m = unpack_vertex(g, es.state["matched"])
    pairs = [(u, v) for u, v in enumerate(m) if v >= 0]
    assert pairs and all(m[v] == u for u, v in pairs)      # symmetric
    assert {(u, v) for u, v in pairs if u < n_left} <= \
        {tuple(e) for e in edges.tolist()}                 # along edges
    # maximal: no edge joins two unmatched vertices
    assert not any(m[u] < 0 and m[v] < 0 for u, v in edges.tolist())


def test_hash2_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.integers(-(2**31), 2**31 - 1, 4096).astype(np.int32)
    b = rng.integers(-(2**31), 2**31 - 1, 4096).astype(np.int32)
    a[:5] = [-1, 0, 2**31 - 1, -(2**31), 5]
    want = np.asarray(jax_hash2(jnp.asarray(a), jnp.asarray(b)))
    got = _hash2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
