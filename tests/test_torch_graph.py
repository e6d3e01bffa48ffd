"""The port's graph builder against the reference's, leaf by leaf.

The same edge lists go through ``repro.core.build_partitioned_graph`` and
``repro_torch.core.build_partitioned_graph(device="cpu")``; every tensor
leaf (int32 ids, float32 values, bool masks), every sliced-ELL bin and
every static field must agree exactly — and so must the port's graph made
from the reference's by ``repro_torch.convert``.  Also: the copied
partitioners give the reference's labels, and the copied packers its
arrays.
"""

import numpy as np
import pytest
import torch

from repro.core import build_partitioned_graph as jax_build
from repro.core.apps.pagerank import pagerank_edge_weights as jax_pr_weights
from repro.core.graph import unpack_vertex as jax_unpack
from repro.data import graphs as jax_graphs
from repro.kernels import common as jax_common
from repro.partition import make_partition as jax_make_partition

from repro_torch.convert import graph_from_numpy, to_numpy
from repro_torch.core.apps import pagerank_edge_weights
from repro_torch.core.graph import build_partitioned_graph, unpack_vertex
from repro_torch.data import graphs
from repro_torch.kernels import common
from repro_torch.partition import bfs_partition, hash_partition, \
    make_partition


def fixture(name):
    """(edges, n, part, weights, build kwargs) of the engine fixtures: the
    golden ``sssp`` and ``pagerank`` graphs of ``test_executor_parity`` and
    a hub-heavy R-MAT whose high in-degree rows spill past a 16-slot base
    bin."""
    if name == "sssp":
        edges, w, n = graphs.grid_graph(6, 30, seed=3)
        return edges, n, bfs_partition(edges, n, 4, seed=1), w, {}
    if name == "pagerank":
        edges, n = graphs.rmat_graph(200, avg_degree=5, seed=7)
        return (edges, n, hash_partition(n, 4, seed=2),
                pagerank_edge_weights(edges, n), {})
    if name == "hub":
        edges, n = graphs.rmat_graph(400, avg_degree=12, seed=5)
        return (edges, n, hash_partition(n, 4, seed=1),
                pagerank_edge_weights(edges, n), dict(ell_base_slices=16))
    raise KeyError(name)


def assert_tree_equal(want, got, path="graph"):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            assert_tree_equal(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_tree_equal(w, g, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert (want.dtype, want.shape) == (got.dtype, got.shape), \
            (path, want.dtype, want.shape, got.dtype, got.shape)
        assert np.array_equal(want.view(np.uint8), got.view(np.uint8)), path
    else:
        assert want == got, (path, want, got)


@pytest.mark.parametrize("name", ["sssp", "pagerank", "hub"])
def test_build_matches_reference(name):
    edges, n, part, w, kw = fixture(name)
    want = to_numpy(jax_build(edges, n, part, weights=w, **kw))
    got = build_partitioned_graph(edges, n, part, weights=w, device="cpu",
                                  **kw)
    assert_tree_equal(want, to_numpy(got))
    if name == "hub":
        assert len(got.local_ell) > 1 and not got.local_ell[1].dense
    # the converted reference graph is the same graph
    assert_tree_equal(to_numpy(got),
                      to_numpy(graph_from_numpy(want, device="cpu")))


@pytest.mark.parametrize("pad_multiple", [1, 8])
@pytest.mark.parametrize("edge_blocks", [1, 2, 4])
@pytest.mark.parametrize("partitioner", ["hash", "bfs", "fennel",
                                         "multilevel"])
def test_build_sweep_matches_reference(partitioner, edge_blocks,
                                       pad_multiple):
    edges, n = graphs.rmat_graph(150, avg_degree=6, seed=11)
    w = np.random.RandomState(3).uniform(0.5, 4.0, len(edges)) \
        .astype(np.float32)
    kw = dict(weights=w, n_partitions=4, partition_seed=2,
              edge_blocks=edge_blocks, pad_multiple=pad_multiple,
              ell_base_slices=8)
    want = to_numpy(jax_build(edges, n, partitioner, **kw))
    got = to_numpy(build_partitioned_graph(edges, n, partitioner,
                                           device="cpu", **kw))
    assert_tree_equal(want, got)


@pytest.mark.parametrize("partitioner", ["hash", "bfs", "fennel",
                                         "multilevel"])
def test_partitioners_match_reference(partitioner):
    edges, n = graphs.rmat_graph(300, avg_degree=5, seed=4)
    want = jax_make_partition(partitioner, edges, n, 6, seed=3)
    got = make_partition(partitioner, edges, n, 6, seed=3)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_generators_and_weights_match_reference():
    for make in (lambda m: m.grid_graph(7, 9, seed=2),
                 lambda m: m.rmat_graph(500, avg_degree=6, seed=8),
                 lambda m: m.geometric_graph(300, seed=1),
                 lambda m: m.bipartite_graph(20, 30, seed=6),
                 lambda m: (m.symmetrize(m.path_graph(12)[0]),),
                 lambda m: (m.ensure_no_dangling(m.cycle_graph(9)[0], 9),)):
        want, got = make(jax_graphs), make(graphs)
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    edges, n = graphs.rmat_graph(200, avg_degree=5, seed=7)
    assert np.array_equal(jax_pr_weights(edges, n),
                          pagerank_edge_weights(edges, n))


def test_packers_match_reference():
    rng = np.random.RandomState(0)
    src = rng.randint(0, 60, 400)
    dst = np.minimum(rng.zipf(1.6, 400), 59)
    w = rng.rand(400).astype(np.float32)
    grp = rng.randint(0, 9, 400)
    kmax = int(np.bincount(dst).max())
    for a, b in zip(jax_common.ell_pack_numpy(src, dst, w, 64, kmax),
                    common.ell_pack_numpy(src, dst, w, 64, kmax)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    for base, pad in ((4, 8), (16, 1), (128, 8)):
        widths = common.ell_bin_widths(kmax, base, pad)
        assert widths == jax_common.ell_bin_widths(kmax, base, pad)
        want = jax_common.sliced_ell_pack_numpy(src, dst, w, 64, widths,
                                                extras=(grp,))
        got = common.sliced_ell_pack_numpy(src, dst, w, 64, widths,
                                           extras=(grp,))
        assert_tree_equal(to_numpy(want), to_numpy(got), "bins")


def test_unpack_vertex_matches_reference():
    edges, n, part, w, kw = fixture("sssp")
    ref = jax_build(edges, n, part, weights=w)
    g = build_partitioned_graph(edges, n, part, weights=w, device="cpu")
    vals = np.arange(g.n_partitions * g.vp * 2, dtype=np.float32) \
        .reshape(g.n_partitions, g.vp, 2)
    assert np.array_equal(jax_unpack(ref, vals),
                          unpack_vertex(g, torch.from_numpy(vals)))


def test_build_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    edges, n, part, w, _ = fixture("sssp")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_partitioned_graph(edges, n, part, weights=w)
