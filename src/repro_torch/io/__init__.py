"""Graph I/O subsystem: chunked readers, the sharded ``.ghp`` on-disk
format, and the out-of-core partition/build pipeline.

The in-memory path (``repro_torch.data.graphs`` ->
``build_partitioned_graph``) caps the platform at one host's RAM; this
package is the disk-backed on-ramp for everything bigger:

  * :mod:`repro_torch.io.readers` — bounded ``(chunk, 2)`` int64 blocks from
    SNAP-style text (gzip-aware), staged binary, or in-memory arrays;
  * :mod:`repro_torch.io.stage`   — binary staging + ``materialize`` for
    putting synthetic graphs on disk;
  * :mod:`repro_torch.io.format`  — the ``.ghp`` sharded format:
    ``meta.json`` + per-partition mmap-loadable ``.npy`` edge shards,
    ``save_graph``/``load_graph`` round-trip, validated errors;
  * :mod:`repro_torch.io.pipeline` — streaming degree pass, external-CSR
    fennel, destination-partition spill, and the out-of-core builder
    behind :func:`build_partitioned_graph_from_path` (bit-identical to
    the in-memory builder, peak memory O(chunk + largest partition)),
    which puts the graph on the card (``device``, ``cuda`` by default);
  * :mod:`repro_torch.io.digest` — :func:`graph_digest`, equal to the
    reference's on the same graph;
  * ``python -m repro_torch.io.convert`` — edge list -> ``.ghp`` CLI;
  * ``python -m repro_torch.io.resize`` — k -> k' re-spill of a ``.ghp``
    (and of an engine checkpoint).

The on-disk formats are the reference's (``repro.io``), byte for byte.
"""

from repro_torch.io.digest import graph_digest
from repro_torch.io.format import (GraphFormatError, ShardedGraph,
                                   load_graph, save_graph)
from repro_torch.io.pipeline import (build_from_sharded,
                                     build_partitioned_graph_from_path,
                                     degree_pass, external_undirected_csr,
                                     spill_to_ghp)
from repro_torch.io.readers import (ArrayEdgeSource, EdgeSource,
                                    StagedEdgeSource, TextEdgeSource,
                                    open_edge_source)
from repro_torch.io.stage import materialize, stage_arrays, stage_edges

__all__ = [
    "GraphFormatError", "ShardedGraph", "save_graph", "load_graph",
    "graph_digest",
    "build_from_sharded", "build_partitioned_graph_from_path",
    "degree_pass", "external_undirected_csr", "spill_to_ghp",
    "EdgeSource", "ArrayEdgeSource", "TextEdgeSource", "StagedEdgeSource",
    "open_edge_source",
    "materialize", "stage_arrays", "stage_edges",
]
