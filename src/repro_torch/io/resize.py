"""Elastic resize of a ``.ghp`` directory: re-spill from k to k' partitions
without a rebuild from edge lists.

``python -m repro_torch.io.resize src.ghp dst.ghp -k 12`` re-labels the
stored vertex assignment with :func:`repro_torch.ft.elastic.resize_labels`
(shrink merges contiguous partitions, grow splits each partition's vertex
run among its children) and re-buckets the edge shards out-of-core: each
new shard gathers its rows from the parent shards that contribute to it,
one new shard resident at a time — the full edge list never
materializes.

When the source carries ``pos`` columns (``positions=True`` at convert
time), each new shard is re-sorted into original edge-list order, so
building the resized directory is **bit-identical** to sharding the original
edge list under the new labeling directly — same ``graph_digest``, which is
what lets a re-sharded checkpoint be re-keyed trustworthily.

``--checkpoint ckpts/ --checkpoint-out ckpts-k12/`` additionally re-shards
the newest engine checkpoint onto the new partitioning
(:func:`repro_torch.ft.driver.reshard_checkpoint_arrays`: vertex state
remapped by global id, halo dropped — the next exchange refills it —
per-partition counters reset) and re-keys it to the *new* graph's digest,
which the tool computes by actually building the resized graph (on
``--device``: ``cuda`` unless ``cpu`` is passed); the written manifest is
marked ``elastic`` so the driver's restore path knows to apply the
monotone re-announce instead of a strict bit-exact restore.

A port of ``repro.io.resize``: the same ``.ghp`` bytes and the same
re-sharded leaves, by manifest name.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.io.format import (GraphFormatError, ShardWriter,
                                   ShardedGraph, load_graph)

__all__ = ["resize_ghp", "resize_checkpoint", "main"]


def resize_ghp(src: str, dst: str, new_partitions: int) -> ShardedGraph:
    """Re-spill ``src`` (a ``.ghp`` directory) to ``dst`` under
    ``new_partitions`` partitions.  Out-of-core: peak memory is one new
    shard (plus the vertex-scale labelings)."""
    sg = load_graph(src)
    old_part = sg.part
    from repro_torch.ft.elastic import resize_labels
    kp = int(new_partitions)
    new_part = resize_labels(old_part, kp)
    if len(np.unique(new_part)) != kp:
        raise GraphFormatError(
            f"{src}: cannot split {sg.n_partitions} partitions of "
            f"{sg.n_vertices} vertices into {kp} non-empty partitions")
    has_pos = bool(sg.meta.get("has_positions"))

    # pass 1: new shard sizes + which old shards feed which new ones.
    # An edge lives in the shard of its *destination*, so old shard p
    # contributes to new shard q iff some vertex moved p -> q.
    sizes = np.zeros(kp, dtype=np.int64)
    for p in range(sg.n_partitions):
        e, _, _ = sg.shard(p, mmap=True, weights=False, positions=False)
        if len(e):
            sizes += np.bincount(new_part[np.asarray(e[:, 1])],
                                 minlength=kp)
    pairs = np.unique(np.stack([old_part, new_part], axis=1), axis=0)
    parents = [pairs[pairs[:, 1] == q, 0] for q in range(kp)]

    wr = ShardWriter(dst, sg.n_vertices, new_part, sizes, dtype=sg.dtype,
                     weighted=sg.weighted, positions=has_pos,
                     partitioner=f"resize[{sg.meta.get('partitioner')}]",
                     partition_seed=sg.meta.get("partition_seed"))
    # pass 2: fill, one new shard at a time.  With positions, rows re-sort
    # into original edge-list order — a merge interleaves parents exactly
    # as a direct re-shard of the original edge list would.
    for q in range(kp):
        ce, cw, cp = [], [], []
        for p in parents[q]:
            e, w, pos = sg.shard(int(p), mmap=True)
            sel = new_part[np.asarray(e[:, 1])] == q
            ce.append(np.asarray(e[sel], dtype=np.int64))
            if w is not None:
                cw.append(np.asarray(w[sel], dtype=np.float32))
            if pos is not None:
                cp.append(np.asarray(pos[sel]))
        if not ce:
            continue
        e_all = np.concatenate(ce, axis=0)
        w_all = np.concatenate(cw) if cw else None
        pos_all = np.concatenate(cp) if cp else None
        if pos_all is not None and len(parents[q]) > 1:
            order = np.argsort(pos_all, kind="stable")
            e_all, pos_all = e_all[order], pos_all[order]
            if w_all is not None:
                w_all = w_all[order]
        wr.append(e_all, w_all, new_part, positions=pos_all)
    return wr.close()


def resize_checkpoint(ckpt: str, out_base: str, old_part: np.ndarray,
                      new_part: np.ndarray, new_digest: str,
                      pad_multiple: int = 8) -> str:
    """Re-shard one engine checkpoint (a ``step_*`` directory, or a base
    directory whose newest complete checkpoint is taken) onto
    ``new_part`` and re-key it to ``new_digest``.  Returns the written
    checkpoint path.  The manifest is marked ``elastic``: restoring it is
    only exact-to-the-fixed-point for monotone programs, which
    ``repro_torch.ft.driver.elastic_restore`` enforces."""
    from repro_torch.checkpoint.ckpt import (CheckpointError,
                                             latest_checkpoint,
                                             load_checkpoint_arrays,
                                             save_checkpoint)
    from repro_torch.ft.driver import reshard_checkpoint_arrays

    if not os.path.exists(os.path.join(ckpt, "manifest.json")):
        found = latest_checkpoint(ckpt)
        if found is None:
            raise CheckpointError(f"{ckpt}: no complete checkpoint found")
        ckpt = found
    arrs, manifest = load_checkpoint_arrays(ckpt)
    meta = dict(manifest.get("meta") or {})
    if meta.get("elastic"):
        raise CheckpointError(f"{ckpt}: already elastic-resharded once; "
                              f"reshard from the original checkpoint")
    new_arrs = reshard_checkpoint_arrays(arrs, old_part, new_part,
                                         pad_multiple=pad_multiple)
    step = int(manifest["step"])
    meta.update(elastic=True, elastic_from=meta.get("graph_digest"),
                graph_digest=new_digest,
                n_partitions=int(np.asarray(new_part).max()) + 1,
                pad_multiple=int(pad_multiple))
    out = os.path.join(out_base, f"step_{step:08d}")
    save_checkpoint(out, new_arrs, step, extra_meta=meta)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.io.resize",
        description="re-spill a .ghp directory from k to k' partitions "
                    "(and optionally re-shard + re-key a checkpoint)")
    ap.add_argument("src", help="source .ghp directory")
    ap.add_argument("dst", help="destination .ghp directory")
    ap.add_argument("-k", "--new-partitions", type=int, required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint to re-shard: a step_* directory or a "
                         "base directory (newest complete step taken)")
    ap.add_argument("--checkpoint-out", default=None,
                    help="base directory for the re-sharded checkpoint "
                         "(required with --checkpoint)")
    ap.add_argument("--pad-multiple", type=int, default=8,
                    help="vertex padding of the engine build the "
                         "checkpoint targets (default 8)")
    ap.add_argument("--edge-blocks", type=int, default=1,
                    help="edge layout of the digest-computing build "
                         "(default 1)")
    ap.add_argument("--device", default="cuda",
                    help="device of the digest-computing build "
                         "(default cuda)")
    args = ap.parse_args(argv)

    sg_new = resize_ghp(args.src, args.dst, args.new_partitions)
    print(f"resized {args.src} ({load_graph(args.src).n_partitions} parts) "
          f"-> {args.dst} ({sg_new.n_partitions} parts, "
          f"{sg_new.n_edges} edges)")

    if args.checkpoint is not None:
        if args.checkpoint_out is None:
            ap.error("--checkpoint needs --checkpoint-out")
        from repro_torch.io.digest import graph_digest
        from repro_torch.io.pipeline import build_from_sharded
        graph = build_from_sharded(sg_new, pad_multiple=args.pad_multiple,
                                   edge_blocks=args.edge_blocks,
                                   device=args.device)
        digest = graph_digest(graph)
        out = resize_checkpoint(args.checkpoint, args.checkpoint_out,
                                load_graph(args.src).part, sg_new.part,
                                digest, pad_multiple=args.pad_multiple)
        print(f"resharded checkpoint -> {out} (graph_digest {digest[:12]}…)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
