"""Edge list -> sharded ``.ghp`` graph directory, out-of-core.

    python -m repro_torch.io.convert INPUT OUT.ghp --partitioner fennel \
        --n-partitions 8 [--seed 0] [--chunk-edges N] [--n-vertices N] \
        [--dtype int64|int32] [--no-positions] [--workdir DIR]

INPUT is a SNAP-style text edge list (``src dst [weight]`` per line, ``#``
comments, ``.gz``-aware) or a staged-edge directory.  The conversion runs
the same streaming prefix as ``build_partitioned_graph_from_path``
(:func:`repro_torch.io.pipeline.ingest_to_ghp`: degree pass, labeling,
destination-partition spill) in chunk-bounded memory, so a 10^9-edge file
needs no more RAM than its largest chunk plus the vertex tables.
Positions are stored by default so the original edge order is
reconstructible (``ShardedGraph.edges()``); drop them with
``--no-positions`` to save 8 bytes/edge.

The port's twin of ``python -m repro.io.convert`` (numpy only, no device):
the same input and options write the same bytes.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.io.convert",
        description="convert an edge list to a sharded .ghp graph "
                    "directory (streaming, chunk-bounded memory)")
    ap.add_argument("input", help="text edge list (.gz ok) or staged dir")
    ap.add_argument("output", help="output .ghp directory")
    ap.add_argument("--partitioner", default="fennel",
                    help="partitioner name "
                         "(repro_torch.partition.PARTITIONERS) [fennel]")
    ap.add_argument("--n-partitions", "-k", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-edges", type=int, default=1 << 20)
    ap.add_argument("--n-vertices", type=int, default=None,
                    help="vertex count (default: inferred as max id + 1 / "
                         "the staged metadata; larger values add isolated "
                         "tail vertices)")
    ap.add_argument("--dtype", default="int64", choices=("int64", "int32"),
                    help="on-disk edge id dtype [int64]")
    ap.add_argument("--no-positions", action="store_true",
                    help="skip the per-shard original-index arrays")
    ap.add_argument("--workdir", default=None,
                    help="where the staging temporaries live "
                         "(default: a TemporaryDirectory)")
    args = ap.parse_args(argv)

    from repro_torch.io.pipeline import ingest_to_ghp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=args.workdir) as wd:
        sg = ingest_to_ghp(args.input, args.partitioner, args.n_partitions,
                           args.output, wd, n_vertices=args.n_vertices,
                           chunk_edges=args.chunk_edges,
                           positions=not args.no_positions,
                           partition_seed=args.seed,
                           dtype=np.dtype(args.dtype))
        # streaming edge-cut fraction (one cheap pass over the shards)
        cut = sum(int((sg.part[np.asarray(
            sg.shard(p, weights=False, positions=False)[0][:, 0])]
            != p).sum()) for p in range(sg.n_partitions))
    sizes = [s["n_edges"] for s in sg.meta["shards"]]
    print(f"wrote {args.output}: V={sg.n_vertices} E={sg.n_edges}, "
          f"{sg.n_partitions} shards [{args.partitioner}] "
          f"(in-edges per shard: {sizes}), "
          f"edge-cut {cut}/{sg.n_edges} ({cut / max(sg.n_edges, 1):.3f}), "
          f"{time.perf_counter() - t0:.1f}s total")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))
    sys.exit(main())
