"""Graph-query serving: K-lane micro-batches of SSSP / widest-path /
reachability / personalized-PageRank queries on one resident graph."""

from repro_torch.serve.engine import (PROGRAMS, STATS_FILENAME, Query,
                                      ResumeEvent, ServeEngine)

__all__ = ["PROGRAMS", "Query", "ResumeEvent", "ServeEngine",
           "STATS_FILENAME"]
