"""The port's graph I/O against the reference's, on the same numpy inputs.

  * ``.ghp`` both ways: a directory written by ``repro.io`` loads in
    ``repro_torch.io`` and the reverse, and both packages write the same
    bytes (``meta.json``, ``part.npy``, every shard);
  * ``graph_digest`` of the port's graph equals the reference's on the
    same graph (the checked-in ``web_toy.tsv.gz`` fixture, the builder
    sweep graphs);
  * out-of-core equals in-memory, field by field, for every partitioner
    × ``pad_multiple`` × ``edge_blocks`` × chunk size, and equals the
    reference's out-of-core build;
  * every ``GraphFormatError`` and reader-error case of ``test_io.py``;
  * the convert CLI writes what the reference's writes, and the
    partition-quality report equals the reference's.
"""

import filecmp
import gzip
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.core import build_partitioned_graph as jax_build
from repro.io import build_partitioned_graph_from_path as jax_from_path
from repro.io import graph_digest as jax_digest
from repro.io import load_graph as jax_load_graph
from repro.io import save_graph as jax_save_graph
from repro.io.convert import main as jax_convert_main
from repro.partition.quality import partition_report as jax_report

from repro_torch.convert import to_numpy
from repro_torch.core import run_hybrid
from repro_torch.core.apps import SSSP
from repro_torch.core.graph import build_partitioned_graph, unpack_vertex
from repro_torch.data.graphs import grid_graph, materialize, rmat_graph
from repro_torch.io import (ArrayEdgeSource, GraphFormatError,
                            TextEdgeSource, build_from_sharded,
                            build_partitioned_graph_from_path, graph_digest,
                            load_graph, open_edge_source, save_graph)
from repro_torch.io.convert import main as convert_main
from repro_torch.io.pipeline import degree_pass, external_undirected_csr
from repro_torch.io.stage import stage_arrays, stage_edges
from repro_torch.partition import (PARTITIONERS, fennel_partition,
                                   fennel_partition_csr, make_partition,
                                   partition_report)

from test_torch_graph import assert_tree_equal

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "web_toy.tsv.gz")
CPU = dict(device="cpu")


def _random_graph(seed, weighted=True, dtype=np.int64):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(5, 40))
    m = int(rng.randint(n, 4 * n))
    edges = rng.randint(0, n, size=(m, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    if len(edges) == 0:
        edges = np.array([[0, 1]])
    edges = np.unique(edges, axis=0).astype(dtype)
    w = (rng.uniform(0.1, 5.0, len(edges)).astype(np.float32)
         if weighted else None)
    return edges, n, w


def _assert_same_files(a, b):
    """Two directories hold the same files with the same bytes."""
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only, (cmp.left_only,
                                                      cmp.right_only)
    for name in cmp.common_files:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    for sub in cmp.common_dirs:
        _assert_same_files(os.path.join(a, sub), os.path.join(b, sub))


# ---------------------------------------------------------------------------
# .ghp both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_ghp_same_bytes_and_loads_both_ways(tmp_path, dtype, seed):
    edges, n, w = _random_graph(seed, weighted=seed % 2 == 0, dtype=dtype)
    part = make_partition("hash", edges, n, 3 + seed % 3, seed=seed % 17)
    ref_dir, port_dir = str(tmp_path / "ref.ghp"), str(tmp_path / "port.ghp")
    jax_save_graph(ref_dir, edges, n, part, weights=w)
    save_graph(port_dir, edges, n, part, weights=w)
    _assert_same_files(ref_dir, port_dir)
    for load, path in ((load_graph, ref_dir), (jax_load_graph, port_dir)):
        lg = load(path)
        assert lg.n_vertices == n and lg.n_edges == len(edges)
        np.testing.assert_array_equal(lg.part, part)
        got_e, got_w = lg.edges()
        assert got_e.dtype == edges.dtype
        np.testing.assert_array_equal(got_e, edges)
        if w is None:
            assert got_w is None
        else:
            np.testing.assert_array_equal(got_w, w)
    # the port's own round trip: each shard its partition's in-edges, in
    # original order
    lg = load_graph(port_dir)
    for p in range(lg.n_partitions):
        se, _, pos = lg.shard(p)
        sel = part[edges[:, 1]] == p
        np.testing.assert_array_equal(np.asarray(se), edges[sel])
        np.testing.assert_array_equal(np.asarray(pos), np.nonzero(sel)[0])


def test_reference_ghp_builds_the_reference_graph(tmp_path):
    """A ``.ghp`` the reference wrote, built out-of-core by the port, is
    the reference's graph leaf for leaf."""
    edges, n = rmat_graph(150, avg_degree=4, seed=6)
    part = make_partition("multilevel", edges, n, 3, seed=0)
    ghp = str(tmp_path / "g.ghp")
    jax_save_graph(ghp, edges, n, part)
    want = jax_build(edges, n, part)
    got = build_partitioned_graph_from_path(ghp, **CPU)
    assert_tree_equal(to_numpy(want), to_numpy(got))
    assert graph_digest(got) == jax_digest(want)


# ---------------------------------------------------------------------------
# digest parity
# ---------------------------------------------------------------------------

def test_digest_matches_reference_on_fixture():
    src = open_edge_source(FIXTURE, 64)
    nv, ne, out_deg, in_deg = degree_pass(src)
    assert ne == 270 and nv == 94 and src.weighted
    assert int(out_deg.sum()) == ne == int(in_deg.sum())
    g = build_partitioned_graph_from_path(FIXTURE, "fennel", 4,
                                          chunk_edges=37, **CPU)
    want = jax_from_path(FIXTURE, "fennel", 4, chunk_edges=37)
    assert graph_digest(g) == jax_digest(want)
    e = np.concatenate([c for c, _ in src.chunks()])
    w = np.concatenate([x for _, x in src.chunks()])
    ref = build_partitioned_graph(e, nv, "fennel", weights=w,
                                  n_partitions=4, **CPU)
    assert graph_digest(g) == graph_digest(ref)


def test_digest_ignores_the_cached_dense_plan():
    from repro_torch.core.runtime import dense_plan
    edges, w, n = grid_graph(5, 7, seed=1)
    g = build_partitioned_graph(edges, n, "bfs", weights=w, n_partitions=3,
                                **CPU)
    before = graph_digest(g)
    dense_plan(g)
    assert "_dense_plan" in g.__dict__ and graph_digest(g) == before


# ---------------------------------------------------------------------------
# out-of-core == in-memory == the reference, field by field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pname", sorted(PARTITIONERS))
@pytest.mark.parametrize("pad_multiple", [8, 4])
@pytest.mark.parametrize("edge_blocks", [1, 4])
def test_from_path_bitexact_per_partitioner(tmp_path, pname, pad_multiple,
                                            edge_blocks):
    edges, n = rmat_graph(260, avg_degree=5, seed=2)
    w = np.random.RandomState(1).uniform(0.5, 2.0,
                                         len(edges)).astype(np.float32)
    staged = str(tmp_path / "staged")
    stage_arrays(staged, edges, weights=w, n_vertices=n)
    kw = dict(partition_seed=0, pad_multiple=pad_multiple,
              edge_blocks=edge_blocks)
    inmem = build_partitioned_graph(edges, n, pname, weights=w,
                                    n_partitions=4, **kw, **CPU)
    want = to_numpy(inmem)
    jax_graph = jax_from_path(staged, pname, 4, chunk_edges=97, **kw)
    assert_tree_equal(to_numpy(jax_graph), want)
    digest = jax_digest(jax_graph)
    assert graph_digest(inmem) == digest
    for chunk in (11, 97, 1 << 20):
        g = build_partitioned_graph_from_path(staged, pname, 4,
                                              chunk_edges=chunk, **kw,
                                              **CPU)
        assert_tree_equal(want, to_numpy(g), f"{pname} chunk={chunk}")
        assert graph_digest(g) == digest


def test_from_path_bitexact_with_spill_bins(tmp_path):
    rng = np.random.RandomState(4)
    hub = np.concatenate([
        np.stack([rng.randint(0, 150, 700), np.full(700, 3)], axis=1),
        rng.randint(0, 150, (350, 2))])
    hub = np.unique(hub[hub[:, 0] != hub[:, 1]].astype(np.int64), axis=0)
    staged = str(tmp_path / "staged")
    stage_arrays(staged, hub, n_vertices=150)
    ref = build_partitioned_graph(hub, 150, "fennel", n_partitions=3,
                                  ell_base_slices=8, **CPU)
    assert len(ref.local_ell) > 1
    g = build_partitioned_graph_from_path(staged, "fennel", 3,
                                          chunk_edges=64, ell_base_slices=8,
                                          **CPU)
    assert_tree_equal(to_numpy(ref), to_numpy(g))
    assert graph_digest(g) == jax_digest(
        jax_from_path(staged, "fennel", 3, chunk_edges=64,
                      ell_base_slices=8))


@pytest.mark.parametrize("pname", sorted(PARTITIONERS))
def test_ragged_and_padded_from_path(tmp_path, pname):
    """Hub-skewed graph with spill bins: both edge layouts, out-of-core at
    two chunk sizes, equal the in-memory builds and the reference's."""
    rng = np.random.RandomState(3)
    n = 170
    hubs = np.stack([rng.randint(0, n, 600), rng.randint(0, 4, 600)], 1)
    edges = np.concatenate([hubs, rng.randint(0, n, (300, 2))])
    edges = np.unique(edges[edges[:, 0] != edges[:, 1]].astype(np.int64),
                      axis=0)
    w = rng.uniform(0.5, 3.0, len(edges)).astype(np.float32)
    staged = str(tmp_path / "staged")
    stage_arrays(staged, edges, weights=w, n_vertices=n)
    for blocks in (1, 4):
        kw = dict(partition_seed=3, ell_base_slices=8, edge_blocks=blocks)
        ref = build_partitioned_graph(edges, n, pname, weights=w,
                                      n_partitions=4, **kw, **CPU)
        assert len(ref.local_ell) > 1 or len(ref.remote_ell) > 1
        digest = jax_digest(jax_build(edges, n, pname, weights=w,
                                      n_partitions=4, **kw))
        assert graph_digest(ref) == digest
        for chunk in (23, 1 << 20):
            g = build_partitioned_graph_from_path(
                staged, pname, 4, chunk_edges=chunk, **kw, **CPU)
            assert graph_digest(g) == digest, (blocks, chunk)


def test_from_path_runs_the_engine(tmp_path):
    edges, w, n = grid_graph(6, 18, seed=0)
    staged = str(tmp_path / "staged")
    stage_arrays(staged, edges, weights=w, n_vertices=n)
    g = build_partitioned_graph_from_path(staged, "bfs", 3, **CPU)
    g_ref = build_partitioned_graph(edges, n, "bfs", weights=w,
                                    n_partitions=3, **CPU)
    es, it = run_hybrid(g, SSSP(source=0), device="cpu")
    es_ref, it_ref = run_hybrid(g_ref, SSSP(source=0), device="cpu")
    assert it == it_ref
    np.testing.assert_array_equal(unpack_vertex(g, es.state["dist"]),
                                  unpack_vertex(g_ref,
                                                es_ref.state["dist"]))


def test_from_path_ghp_input_and_ghp_out(tmp_path):
    edges, n = rmat_graph(150, avg_degree=4, seed=6)
    part = make_partition("multilevel", edges, n, 3, seed=0)
    ghp = str(tmp_path / "g.ghp")
    save_graph(ghp, edges, n, part)
    ref = graph_digest(build_partitioned_graph(edges, n, part, **CPU))
    assert graph_digest(build_partitioned_graph_from_path(ghp, **CPU)) == ref
    with pytest.raises(ValueError):
        build_partitioned_graph_from_path(ghp, "hash", 3, **CPU)
    staged = str(tmp_path / "staged")
    stage_arrays(staged, edges, n_vertices=n)
    kept = str(tmp_path / "kept.ghp")
    g = build_partitioned_graph_from_path(staged, part, ghp_out=kept, **CPU)
    assert graph_digest(g) == ref
    assert graph_digest(build_partitioned_graph_from_path(kept, **CPU)) \
        == ref


def test_from_path_device_is_checked_first(tmp_path):
    """No silent fallback: without a GPU the default device raises before
    any file is read; the product is a fresh tensor, never a view of the
    scratch files."""
    edges, w, n = grid_graph(4, 5, seed=2)
    ghp = str(tmp_path / "g.ghp")
    save_graph(ghp, edges, n, make_partition("hash", edges, n, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_partitioned_graph_from_path(ghp)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_from_sharded(load_graph(ghp))
    g = build_partitioned_graph_from_path(ghp, **CPU)
    assert g.device == torch.device("cpu")
    # torch's own allocations, not views of the read-only scratch maps
    # (``torch.from_numpy`` storage cannot be resized)
    assert all(t.untyped_storage().resizable()
               for t in (g.edge_src, g.edge_w, g.local_ell[0].idx))


# ---------------------------------------------------------------------------
# corrupt / truncated metadata error paths
# ---------------------------------------------------------------------------

@pytest.fixture
def ghp_dir(tmp_path):
    edges, n = rmat_graph(80, avg_degree=4, seed=9)
    path = str(tmp_path / "g.ghp")
    save_graph(path, edges, n, make_partition("hash", edges, n, 3))
    return path


def _rewrite_meta(path, fn):
    mp = os.path.join(path, "meta.json")
    with open(mp) as f:
        meta = json.load(f)
    out = fn(meta)
    with open(mp, "w") as f:
        f.write(out if isinstance(out, str) else json.dumps(out))


def test_missing_meta(ghp_dir):
    os.remove(os.path.join(ghp_dir, "meta.json"))
    with pytest.raises(GraphFormatError, match="missing"):
        load_graph(ghp_dir)


def test_truncated_meta(ghp_dir):
    raw = open(os.path.join(ghp_dir, "meta.json")).read()
    _rewrite_meta(ghp_dir, lambda m: raw[: len(raw) // 2])
    with pytest.raises(GraphFormatError, match="corrupt or truncated"):
        load_graph(ghp_dir)


def test_wrong_format_tag(ghp_dir):
    _rewrite_meta(ghp_dir, lambda m: {**m, "format": "parquet"})
    with pytest.raises(GraphFormatError, match="format tag"):
        load_graph(ghp_dir)


def test_unsupported_version(ghp_dir):
    _rewrite_meta(ghp_dir, lambda m: {**m, "version": 99})
    with pytest.raises(GraphFormatError, match="version"):
        load_graph(ghp_dir)


def test_old_version_error_names_both_versions(ghp_dir):
    from repro_torch.io.format import GHP_VERSION
    assert GHP_VERSION == 2
    _rewrite_meta(ghp_dir, lambda m: {**m, "version": 1})
    with pytest.raises(GraphFormatError,
                       match=r"unsupported version 1 \(have 2\)"):
        load_graph(ghp_dir)


def test_missing_meta_keys(ghp_dir):
    _rewrite_meta(ghp_dir, lambda m: {k: v for k, v in m.items()
                                      if k != "n_edges"})
    with pytest.raises(GraphFormatError, match="missing keys"):
        load_graph(ghp_dir)


def test_shard_range_sum_mismatch(ghp_dir):
    def bump(m):
        m["shards"][0]["n_edges"] += 1
        return m
    _rewrite_meta(ghp_dir, bump)
    with pytest.raises(GraphFormatError, match="shard ranges sum"):
        load_graph(ghp_dir)


def test_missing_shard_file(ghp_dir):
    os.remove(os.path.join(ghp_dir, "shards", "part00001.edges.npy"))
    with pytest.raises(GraphFormatError, match="shard file missing"):
        load_graph(ghp_dir).shard(1)


def test_shard_shape_mismatch(ghp_dir):
    p = os.path.join(ghp_dir, "shards", "part00000.edges.npy")
    arr = np.load(p)
    np.save(p, arr[:-1])
    with pytest.raises(GraphFormatError, match="meta says"):
        load_graph(ghp_dir).shard(0)


def test_part_length_mismatch(ghp_dir):
    part = np.load(os.path.join(ghp_dir, "part.npy"))
    np.save(os.path.join(ghp_dir, "part.npy"), part[:-2])
    with pytest.raises(GraphFormatError, match="meta says"):
        load_graph(ghp_dir)


def test_out_of_range_ids_rejected(tmp_path):
    big = np.array([[0, 2**31 + 5], [1, 0]], dtype=np.int64)
    with pytest.raises(GraphFormatError, match="does not fit"):
        stage_arrays(str(tmp_path / "s"), big, dtype=np.int32)
    neg = np.array([[0, 1], [1, -3]], dtype=np.int64)
    with pytest.raises(GraphFormatError, match="negative vertex id"):
        save_graph(str(tmp_path / "g.ghp"), neg, 5, np.zeros(5, np.int32))


def test_staged_and_source_errors(tmp_path):
    """Staged directories validate against their json; a ``.ghp`` is not
    an edge source; a missing path is not found."""
    edges, n = rmat_graph(40, avg_degree=3, seed=1)
    st = str(tmp_path / "st")
    stage_arrays(st, edges, weights=np.ones(len(edges), np.float32))
    os.remove(os.path.join(st, "weights.bin"))
    with pytest.raises(GraphFormatError, match="missing"):
        open_edge_source(st)
    with open(os.path.join(st, "edges.bin"), "ab") as f:
        f.write(b"\0" * 8)
    with pytest.raises(GraphFormatError, match="bytes, json says"):
        open_edge_source(st)
    ghp = str(tmp_path / "g.ghp")
    save_graph(ghp, edges, n, np.zeros(n, np.int32))
    with pytest.raises(ValueError, match="sharded .ghp"):
        open_edge_source(ghp)
    with pytest.raises(FileNotFoundError):
        open_edge_source(str(tmp_path / "nope.tsv"))


# ---------------------------------------------------------------------------
# chunked text reader
# ---------------------------------------------------------------------------

def test_text_reader_chunks_and_comments(tmp_path):
    edges, n = rmat_graph(60, avg_degree=3, seed=5)
    p = str(tmp_path / "plain.tsv")
    with open(p, "w") as f:
        f.write("# header\n\n")
        for i, (a, b) in enumerate(edges):
            f.write(f"{a}\t{b}\n")
            if i % 17 == 0:
                f.write("# interleaved comment\n")
    for chunk in (3, 29, 10000):
        src = TextEdgeSource(p, chunk_edges=chunk)
        got = np.concatenate([c for c, w in src.chunks()])
        assert src.weighted is False
        np.testing.assert_array_equal(got, edges)


def test_text_reader_weights_and_gzip(tmp_path):
    p = str(tmp_path / "w.tsv.gz")
    with gzip.open(p, "wt") as f:
        f.write("0 1 0.5\n1 2 1.25\n2 0 3.0\n")
    src = open_edge_source(p, 2)
    chunks = list(src.chunks())
    assert src.weighted is True
    e = np.concatenate([c for c, _ in chunks])
    w = np.concatenate([x for _, x in chunks])
    np.testing.assert_array_equal(e, [[0, 1], [1, 2], [2, 0]])
    np.testing.assert_allclose(w, [0.5, 1.25, 3.0])


def test_text_reader_bad_columns(tmp_path):
    p = str(tmp_path / "bad.tsv")
    with open(p, "w") as f:
        f.write("0 1 2 3\n")
    with pytest.raises(ValueError, match="2 or 3 columns"):
        list(TextEdgeSource(p).chunks())


def test_text_reader_weight_column_changes(tmp_path):
    p = str(tmp_path / "mixed.tsv")
    with open(p, "w") as f:
        f.write("0 1\n1 2\n2 0 0.5\n")
    with pytest.raises(ValueError, match="weight column appeared"):
        list(TextEdgeSource(p, chunk_edges=2).chunks())
    with open(p, "w") as f:
        f.write("0 1 0.5\n1 2 1.0\n2 0\n")
    with pytest.raises(ValueError, match="weight column disappeared"):
        list(TextEdgeSource(p, chunk_edges=2).chunks())


# ---------------------------------------------------------------------------
# external CSR fennel, staging, materialize, the CLIs, partition quality
# ---------------------------------------------------------------------------

def test_external_csr_fennel_matches_inmemory(tmp_path):
    edges, n = rmat_graph(500, avg_degree=6, seed=3)
    src = ArrayEdgeSource(edges, n_vertices=n, chunk_edges=83)
    _, _, out_deg, in_deg = degree_pass(src)
    starts, adj = external_undirected_csr(src, n, out_deg + in_deg,
                                          str(tmp_path))
    for seed in (0, 5):
        a = fennel_partition(edges, n, 4, seed=seed)
        b = fennel_partition_csr(starts, adj, n, 4, n_edges=len(edges),
                                 seed=seed)
        np.testing.assert_array_equal(a, b)


def test_materialize_then_build(tmp_path):
    from repro.data.graphs import materialize as jax_materialize
    staged = materialize(str(tmp_path / "m"), "rmat", n=300, avg_degree=4,
                         seed=1)
    jax_materialize(str(tmp_path / "jm"), "rmat", n=300, avg_degree=4,
                    seed=1)
    _assert_same_files(str(tmp_path / "m"), str(tmp_path / "jm"))
    edges, n = rmat_graph(300, avg_degree=4, seed=1)
    assert staged.n_edges == len(edges) and staged.n_vertices == n
    got = np.concatenate([c for c, _ in staged.chunks()])
    np.testing.assert_array_equal(got, edges)
    g = build_partitioned_graph_from_path(str(tmp_path / "m"), "hash", 3,
                                          **CPU)
    ref = build_partitioned_graph(edges, n, "hash", n_partitions=3, **CPU)
    assert graph_digest(g) == graph_digest(ref)


def test_stage_edges_from_text(tmp_path):
    staged = stage_edges(open_edge_source(FIXTURE, 50),
                         str(tmp_path / "st"))
    src = open_edge_source(FIXTURE, 1 << 20)
    e = np.concatenate([c for c, _ in src.chunks()])
    w = np.concatenate([x for _, x in src.chunks()])
    got_e = np.concatenate([c for c, _ in staged.chunks()])
    got_w = np.concatenate([x for _, x in staged.chunks()])
    np.testing.assert_array_equal(got_e, e)
    np.testing.assert_array_equal(got_w, w)


def test_convert_cli_writes_the_reference_bytes(tmp_path, capsys):
    args = ["--partitioner", "fennel", "--n-partitions", "4",
            "--chunk-edges", "64"]
    assert convert_main([FIXTURE, str(tmp_path / "port.ghp")] + args) == 0
    assert jax_convert_main([FIXTURE, str(tmp_path / "ref.ghp")] + args) == 0
    assert "edge-cut" in capsys.readouterr().out
    _assert_same_files(str(tmp_path / "port.ghp"), str(tmp_path / "ref.ghp"))
    sg = load_graph(str(tmp_path / "port.ghp"))
    e, w = sg.edges()
    g = build_partitioned_graph_from_path(str(tmp_path / "port.ghp"), **CPU)
    ref = build_partitioned_graph(e, sg.n_vertices, sg.part, weights=w,
                                  **CPU)
    assert graph_digest(g) == graph_digest(ref)


def test_partition_report_matches_reference():
    edges, n = rmat_graph(300, avg_degree=5, seed=4)
    part = make_partition("fennel", edges, n, 5, seed=1)
    want = jax_report(edges, n, part, n_partitions=6).as_dict()
    assert partition_report(edges, n, part, n_partitions=6).as_dict() == want
    g = build_partitioned_graph(edges, n, part, **CPU)
    assert partition_report(edges, n, part, graph=g,
                            n_partitions=6).as_dict() == want


@pytest.mark.gpu
def test_cuda_from_path_equals_cpu(tmp_path):
    """On the card: the out-of-core build lands on the GPU with the same
    digest as on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    edges, n = rmat_graph(400, avg_degree=12, seed=5)
    staged = str(tmp_path / "staged")
    stage_arrays(staged, edges, n_vertices=n)
    kw = dict(chunk_edges=500, ell_base_slices=16)
    g = build_partitioned_graph_from_path(staged, "fennel", 4, **kw)
    assert g.device.type == "cuda"
    assert graph_digest(g) == graph_digest(
        build_partitioned_graph_from_path(staged, "fennel", 4, **kw, **CPU))
    shutil.rmtree(staged)
