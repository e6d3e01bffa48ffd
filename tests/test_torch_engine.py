"""The port's hybrid engine against the reference, end to end on the CPU.

``run_hybrid(device="cpu", use_ell=True)`` must reproduce the ``sssp`` and
``pagerank`` × ``hybrid`` × ``ell`` rows of ``tests/data/golden_executor.json``
— iterations and every paper counter exactly, and the state digest exactly
(the same ``_digest`` over numpy copies of the tensors).  PageRank is exact
too, with no tolerance: the plain versions fold in the reference kernels'
order and round float32 scalars as JAX does.  The same holds against a
live reference run on a hub graph whose high in-degree rows spill into
extra ELL bins, on a ``max_local_steps=1`` cutoff run, and on the generic
(unfused) local loop.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import build_partitioned_graph as jax_build
from repro.core import run_hybrid as jax_run_hybrid
from repro.core.apps import SSSP as JaxSSSP
from repro.core.apps import IncrementalPageRank as JaxPageRank
from repro.exec.iteration import hybrid_iteration as jax_hybrid_iteration
from repro.exec.iteration import init_hybrid as jax_init_hybrid

from repro_torch import (SSSP, IncrementalPageRank, build_partitioned_graph,
                         run_hybrid, unpack_vertex)
from repro_torch.convert import engine_state_from_numpy, to_numpy
from repro_torch.exec.iteration import hybrid_iteration
from repro_torch.exec.syncs import host_reads, reset_host_reads

from test_executor_parity import _digest, _load_golden
from test_torch_graph import assert_tree_equal, fixture

PROGRAMS = {
    "sssp": (lambda: JaxSSSP(source=0), lambda: SSSP(source=0)),
    "pagerank": (lambda: JaxPageRank(tolerance=1e-4),
                 lambda: IncrementalPageRank(tolerance=1e-4)),
}


def _graphs(name):
    edges, n, part, w, kw = fixture(name)
    return (jax_build(edges, n, part, weights=w, **kw),
            build_partitioned_graph(edges, n, part, weights=w, device="cpu",
                                    **kw))


def _snapshot(es, iters):
    """The golden suite's snapshot, over numpy copies of either package's
    state (``_digest`` reads ``.state``, ``.send`` and ``.active``)."""
    arrays = to_numpy({"state": es.state, "send": es.send,
                       "active": es.active})
    c = to_numpy(es.counters)
    return {
        "digest": _digest(type("S", (), arrays)),
        "iterations": iters,
        "counters": {
            "iterations": int(c["iterations"]),
            "pseudo_supersteps": np.asarray(c["pseudo_supersteps"]).tolist(),
            "net_messages": int(c["net_messages"]),
            "net_local_messages": int(c["net_local_messages"]),
            "mem_messages": int(c["mem_messages"]),
        },
    }


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_golden_rows(app):
    _, graph = _graphs(app)
    es, iters = run_hybrid(graph, PROGRAMS[app][1](), max_iters=500,
                           use_ell=True, device="cpu")
    assert _snapshot(es, iters) == _load_golden()[app]["hybrid"]["ell"]


@pytest.mark.parametrize("case", ["hub", "cutoff"])
@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_matches_reference_run(app, case):
    jax_graph, graph = _graphs("hub" if case == "hub" else app)
    if case == "hub":
        assert len(graph.local_ell) > 1     # spill bins feed `extra`
    kw = dict(max_iters=500, max_local_steps=1 if case == "cutoff"
              else 100_000)
    make_jax, make_port = PROGRAMS[app]
    want = _snapshot(*jax_run_hybrid(jax_graph, make_jax(), **kw))
    got = _snapshot(*run_hybrid(graph, make_port(), device="cpu", **kw))
    assert got == want


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_generic_local_loop_matches_reference(app):
    """Programs without a fused kernel take the apply -> ELL-deliver loop."""
    make_jax, make_port = PROGRAMS[app]
    jax_prog, prog = make_jax(), make_port()
    jax_prog.fused_kernel = prog.fused_kernel = None
    jax_graph, graph = _graphs(app)
    want = _snapshot(*jax_run_hybrid(jax_graph, jax_prog, max_iters=500))
    got = _snapshot(*run_hybrid(graph, prog, max_iters=500, device="cpu"))
    assert got == want


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_converted_state_steps_like_reference(app):
    """A reference engine state carried across by ``convert`` advances one
    global iteration to the reference's next state, leaf by leaf."""
    make_jax, make_port = PROGRAMS[app]
    jax_graph, graph = _graphs(app)
    es0 = jax_init_hybrid(jax_graph, make_jax(), None)
    port0 = engine_state_from_numpy(to_numpy(es0), device="cpu")
    assert_tree_equal(to_numpy(dataclasses.replace(
        port0, counters=None)), to_numpy(dataclasses.replace(
            es0, counters=None)), "state")
    want = jax_hybrid_iteration(jax_graph, make_jax(), es0, None)
    got = hybrid_iteration(graph, make_port(), port0, None)
    want, got = to_numpy(want), to_numpy(got)
    for k, v in want.pop("counters").items():
        assert np.array_equal(np.asarray(v, np.int64), got["counters"][k]), k
    got.pop("counters")
    assert_tree_equal(want, got, "state")


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_fused_step_matches_reference_step(app, plain):
    """One fused pseudo-superstep on the hub graph, whose spill bins feed
    the kernel's ``extra`` operand, equals the reference's step bit for
    bit — through the wrappers and through the plain-version build that
    ``chip_smoke.py`` holds the card's step against."""
    import jax.numpy as jnp
    from repro.exec.local_phase import fused_step_fn as jax_fused_step_fn

    from repro_torch.exec.local_phase import fused_step_fn

    jax_graph, graph = _graphs("hub")
    make_jax, make_port = PROGRAMS[app]
    kind, p = make_port().fused_kernel, graph.n_partitions
    rng = np.random.default_rng(3)
    x = rng.random((p, graph.vp), dtype=np.float32)
    send = rng.random((p, graph.vp)) < 0.5
    args = (x, send) if kind == "min_step" else (x + 1, x * 1e-2, send)
    jstep, _, _ = jax_fused_step_fn(jax_graph, make_jax(), kind, p)
    want = [np.asarray(a) for a in jstep(*map(jnp.asarray, args))]
    step, _, _ = fused_step_fn(graph, make_port(), kind, p, plain=plain)
    got = [a.numpy() for a in step(*map(torch.from_numpy, args))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_metrics_off_keeps_results_and_zero_counters(app):
    _, graph = _graphs(app)
    prog = PROGRAMS[app][1]
    on, it_on = run_hybrid(graph, prog(), device="cpu")
    off, it_off = run_hybrid(graph, prog(), device="cpu",
                             collect_metrics=False)
    assert it_on == it_off
    for k in on.state:
        assert torch.equal(on.state[k], off.state[k])
    assert torch.equal(on.counters.pseudo_supersteps,
                       off.counters.pseudo_supersteps)
    for f in ("net_messages", "net_local_messages", "mem_messages"):
        assert int(getattr(off.counters, f)) == 0


def test_sssp_matches_dijkstra():
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from repro_torch.data.graphs import grid_graph
    from repro_torch.partition import bfs_partition

    edges, w, n = grid_graph(12, 40, seed=5)
    graph = build_partitioned_graph(edges, n, bfs_partition(edges, n, 6),
                                    weights=w, device="cpu")
    es, _ = run_hybrid(graph, SSSP(source=7), device="cpu")
    got = unpack_vertex(graph, es.state["dist"])
    adj = csr_matrix((w.astype(np.float64), (edges[:, 0], edges[:, 1])),
                     shape=(n, n))
    want = dijkstra(adj, indices=7)
    # float32 sums over up to ~50 hops against a float64 oracle
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pagerank_matches_power_iteration():
    from repro_torch.core.apps import pagerank_edge_weights
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.partition import hash_partition

    edges, n = rmat_graph(400, avg_degree=6, seed=7)
    graph = build_partitioned_graph(edges, n, hash_partition(n, 8, seed=2),
                                    weights=pagerank_edge_weights(edges, n),
                                    device="cpu")
    es, _ = run_hybrid(graph, IncrementalPageRank(tolerance=1e-5),
                       device="cpu")
    got = unpack_vertex(graph, es.state["rank"])
    deg = np.maximum(np.bincount(edges[:, 0], minlength=n), 1)
    r = np.full(n, 0.15)
    for _ in range(300):
        contrib = np.zeros(n)
        np.add.at(contrib, edges[:, 1], 0.85 * r[edges[:, 0]]
                  / deg[edges[:, 0]])
        r = 0.15 + contrib
    # Algorithm 5 drops residuals <= tol at each receipt; the error scales
    # with rank mass (the envelope of tests/test_core_engines.py)
    np.testing.assert_allclose(got, r, rtol=2e-3, atol=5e-3)


def test_host_reads_are_counted():
    _, graph = _graphs("sssp")
    reset_host_reads()
    es, iters = run_hybrid(graph, SSSP(source=0), device="cpu")
    # one quiescent read per global iteration (plus the final one) and one
    # running.any() read per local trip (plus each loop's final one); each
    # trip runs at least one partition, so trips <= total pseudo-supersteps
    want = (iters + 1) + int(es.counters.pseudo_supersteps.sum()) + iters
    assert iters + 1 < host_reads() <= want


@pytest.mark.gpu
@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_cuda_run_matches_cpu_run(app):
    """On the card the kernels run; state and counters equal the CPU run's
    (the plain versions) bit for bit, on the hub graph's spill bins too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    edges, n, part, w, kw = fixture("hub")
    runs = []
    for device in ("cpu", "cuda"):
        graph = build_partitioned_graph(edges, n, part, weights=w,
                                        device=device, **kw)
        runs.append(_snapshot(*run_hybrid(graph, PROGRAMS[app][1](),
                                          device=device)))
    assert runs[0] == runs[1]


def test_unported_paths_raise():
    from repro_torch.core.distributed import block_view
    from repro_torch.core.runtime import slice_flat

    _, graph = _graphs("sssp")
    # per-block ELL views are the distributed step's (ported): on a half
    # block the rows are block-local, padded rows carry the sentinel p*Vp
    edges, n, part, w, _ = fixture("sssp")
    g2 = build_partitioned_graph(edges, n, part, weights=w, edge_blocks=2,
                                 device="cpu")
    half = block_view(g2, 1, 2, "cpu")
    p = g2.n_partitions // 2
    rows, idx, msk = slice_flat(half.local_ell[0], half, p)
    assert rows.shape[0] == idx.shape[0] == msk.shape[0]
    assert int(rows.max()) <= p * g2.vp
    np.testing.assert_array_equal(
        rows.numpy(), g2.local_ell[0].flat_rows.numpy()[-len(rows):]
        - p * g2.vp)
    with pytest.raises(ValueError, match="graph lives on"):
        run_hybrid(graph, SSSP(source=0), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_hybrid(graph, SSSP(source=0))
