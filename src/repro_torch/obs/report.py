"""``python -m repro_torch.obs.report`` — the exchange-vs-compute profile.

The paper's headline claim is architectural: GraphHP pays one global
barrier + one exchange per *global iteration* and pushes the rest of the
work into barrier-free local pseudo-supersteps, where Hama pays a barrier
and an exchange per *superstep*.  This CLI measures that claim end to end
on one shared graph: it runs each requested engine through the phased
profiler (:func:`repro_torch.obs.trace.phased_run` — the superstep
decomposed into its composable phase functions, each timed to the card's
completion) and prints, per superstep, the exchange bytes put on the
wire, the global barrier count, and the fraction of wall time spent
computing rather than exchanging/delivering.

    PYTHONPATH=src python -m repro_torch.obs.report --engines bsp,hybrid
    PYTHONPATH=src python -m repro_torch.obs.report --device cpu

The summary cross-checks the two engines: same converged state (PageRank
fixed point to the run tolerance), hybrid strictly fewer global barriers.
``--profile`` / ``--trace`` persist the same data as a machine-readable
profile blob and a Perfetto-loadable Chrome trace.  ``--device`` is
``cuda`` unless ``cpu`` is asked for; without a GPU the default raises.

The port of ``repro.obs.report``: the same fixture, flags, printed lines
and exit code.
"""

from __future__ import annotations

import argparse
from typing import Sequence

__all__ = ["build_fixture", "run_report", "main"]

N_PARTITIONS = 8
AVG_DEGREE = 8


def build_fixture(n_vertices: int, tolerance: float, seed: int = 0,
                  device=None):
    """The shared bench graph: PageRank on an R-MAT graph, dense delivery
    (the reference's choice: its interpret-mode Pallas would profile the
    interpreter, not the engines), built onto ``device``."""
    from repro_torch.core.apps import IncrementalPageRank
    from repro_torch.core.apps.pagerank import pagerank_edge_weights
    from repro_torch.core.graph import build_partitioned_graph
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.partition import hash_partition

    edges, n = rmat_graph(n_vertices, avg_degree=AVG_DEGREE, seed=seed)
    part = hash_partition(n, N_PARTITIONS, seed=0)
    w = pagerank_edge_weights(edges, n)
    graph = build_partitioned_graph(edges, n, part, weights=w,
                                    build_ell=False, device=device)
    return graph, IncrementalPageRank(tolerance=tolerance), len(edges)


def _fmt_bytes(b: int) -> str:
    if b >= 2**20:
        return f"{b / 2**20:.2f}MiB"
    if b >= 2**10:
        return f"{b / 2**10:.1f}KiB"
    return f"{b}B"


def _print_engine(result) -> None:
    print(f"\n[{result.engine}] {result.iterations} supersteps, "
          f"{result.total_barriers} global barriers, "
          f"{_fmt_bytes(result.total_exchange_bytes)} exchanged, "
          f"mean local-compute fraction "
          f"{result.mean_local_compute_fraction:.3f}")
    hdr = (f"{'superstep':>9}  {'exch_bytes':>10}  {'barriers':>8}  "
           f"{'local_frac':>10}  {'pseudo':>6}  {'net_msgs':>9}  "
           f"{'wall_ms':>8}")
    print(hdr)
    print("-" * len(hdr))
    for r in result.records:
        print(f"{r.superstep:>9}  {r.exchange_bytes:>10}  {r.barriers:>8}  "
              f"{r.local_compute_fraction:>10.3f}  "
              f"{r.pseudo_supersteps:>6}  {r.net_messages:>9}  "
              f"{r.total_seconds * 1e3:>8.2f}")


def run_report(engines: Sequence[str], n_vertices: int = 2_000,
               tolerance: float = 1e-6, max_iters: int = 200,
               max_local_steps: int = 100_000, tracer=None,
               device=None) -> dict:
    """Run each engine through the phased profiler on the shared fixture;
    returns ``{engine: PhasedRunResult}`` plus cross-checks under the
    ``"checks"`` key."""
    import numpy as np

    from repro_torch.obs.trace import phased_run

    graph, prog, n_edges = build_fixture(n_vertices, tolerance,
                                         device=device)
    print(f"fixture: PageRank, {n_edges} edges / {n_vertices} vertices / "
          f"{N_PARTITIONS} partitions, tolerance {tolerance:g}")

    results = {}
    for tid, engine in enumerate(engines):
        if tracer is not None:
            tracer.name_track(tid, engine)
        results[engine] = phased_run(
            graph, prog, engine, None, tracer=tracer, tid=tid,
            use_ell=False, max_iters=max_iters,
            max_local_steps=max_local_steps)
        _print_engine(results[engine])

    checks = {}
    if "bsp" in results and "hybrid" in results:
        b, h = results["bsp"], results["hybrid"]
        # Both engines stop at the same residual-tolerance fixed point but
        # flush deltas on different schedules, so the converged ranks agree
        # to a small relative error, not bit-for-bit.
        mask = graph.vertex_mask.cpu().numpy()
        rb = b.es.state["rank"].cpu().numpy()[mask]
        rh = h.es.state["rank"].cpu().numpy()[mask]
        same = bool(np.allclose(rb, rh, rtol=1e-2, atol=10 * tolerance))
        checks["same_converged_state"] = same
        checks["hybrid_fewer_barriers"] = h.total_barriers < b.total_barriers
        checks["hybrid_fewer_exchange_bytes"] = (
            h.total_exchange_bytes < b.total_exchange_bytes)
        print(f"\nsame converged state (rank rtol 1%): {same}")
        print(f"global barriers: hybrid {h.total_barriers} vs "
              f"bsp {b.total_barriers} "
              f"({'fewer' if checks['hybrid_fewer_barriers'] else 'NOT fewer'})")
        print(f"exchange bytes:  hybrid "
              f"{_fmt_bytes(h.total_exchange_bytes)} vs "
              f"bsp {_fmt_bytes(b.total_exchange_bytes)}")
        print(f"local-compute fraction: hybrid "
              f"{h.mean_local_compute_fraction:.3f} vs "
              f"bsp {b.mean_local_compute_fraction:.3f}")
    results["checks"] = checks
    return results


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="BSP-vs-hybrid exchange/compute profile on one graph")
    ap.add_argument("--engines", default="bsp,hybrid",
                    help="comma-separated subset of {bsp,hybrid}")
    ap.add_argument("--vertices", type=int, default=2_000)
    ap.add_argument("--tolerance", type=float, default=1e-6)
    ap.add_argument("--max-iters", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="where the graph and the runs live (cuda | cpu)")
    ap.add_argument("--profile", default=None,
                    help="write the machine-readable profile blob here")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace-event JSON here")
    args = ap.parse_args(argv)

    engines = [e.strip() for e in args.engines.split(",") if e.strip()]
    tracer = None
    if args.trace or args.profile:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()

    results = run_report(engines, n_vertices=args.vertices,
                         tolerance=args.tolerance, max_iters=args.max_iters,
                         tracer=tracer, device=args.device)
    checks = results.pop("checks")

    if args.trace or args.profile:
        from repro_torch.obs.export import (profile_blob, write_chrome_trace,
                                            write_profile)
        if args.trace:
            write_chrome_trace(tracer, args.trace)
            print(f"wrote {args.trace}")
        if args.profile:
            meta = {"fixture": "pagerank_rmat", "vertices": args.vertices,
                    "tolerance": args.tolerance, "checks": checks}
            write_profile(profile_blob(tracer=tracer,
                                       runs=results.values(), meta=meta),
                          args.profile)
            print(f"wrote {args.profile}")

    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
