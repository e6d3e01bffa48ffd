"""Input generators: the benchmark makes every graph it runs from ``--seed``.

The points and edges are drawn with a ``torch.Generator`` on the device the
run uses (the card, or the CPU in the tests), in a few large calls, and come
back to the host once, where the port's builder takes them.  The random
streams are the benchmark's own, so a change to the port's generators
cannot move them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["sub_seed", "generator", "rgg_radius", "rgg", "coordinate_tiles",
           "make_inputs"]

# the five cell offsets (dx, dy) that meet every pair of neighbouring cells
# once: the cell itself, then the cells after it in row-major order
_FORWARD = ((0, 0), (1, 0), (-1, 1), (0, 1), (1, 1))


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of a run's random streams (the graph, the
    jobs, the kernel probes), derived from ``--seed``: the streams never
    share draws."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), int(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def rgg_radius(n: int, coefficient: float) -> float:
    """The 10th DIMACS challenge's radius, ``coefficient * sqrt(ln n / n)``."""
    return coefficient * math.sqrt(math.log(n) / n)


def rgg(log2_n: int, coefficient: float, gen: torch.Generator, device
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """A random geometric graph: ``n = 2**log2_n`` points uniform in the
    unit square, an edge between two points closer than
    :func:`rgg_radius`.  Returns ``(edges, points)``: (E, 2) int64 arcs,
    both directions of every edge, sorted by (src, dst), and the (n, 2)
    float64 points (x, y) in vertex order.

    The points are binned into square cells of side at least the radius
    and numbered in row-major order of their cells (draw order within a
    cell), so vertex 0 lies in the cell at (0, 0).  Each pair of points in
    one cell or in two neighbouring cells is tested once."""
    n = 1 << log2_n
    r = rgg_radius(n, coefficient)
    pts = torch.rand((n, 2), generator=gen, device=device,
                     dtype=torch.float64)
    g = max(1, int(1.0 / r))
    cell = (pts * g).long().clamp_(max=g - 1)
    key, order = torch.sort(cell[:, 1] * g + cell[:, 0], stable=True)
    pts, cell = pts[order], cell[order]
    counts = torch.bincount(key, minlength=g * g)
    starts = torch.cumsum(counts, 0) - counts
    ids = torch.arange(n, device=device)
    found = []
    for dx, dy in _FORWARD:
        cx, cy = cell[:, 0] + dx, cell[:, 1] + dy
        ok = (cx >= 0) & (cx < g) & (cy < g)
        near = cy[ok] * g + cx[ok]
        cnt = counts[near]
        a = torch.repeat_interleave(ids[ok], cnt)
        first = torch.cumsum(cnt, 0) - cnt
        b = (torch.repeat_interleave(starts[near] - first, cnt)
             + torch.arange(a.numel(), device=device))
        hit = ((pts[a] - pts[b]) ** 2).sum(1) < r * r
        if dx == dy == 0:
            hit &= b > a
        found.append(a[hit] * n + b[hit])
        del a, b, hit
    und = torch.cat(found)
    del found
    arcs = torch.sort(torch.cat([und, (und % n) * n + und // n])).values
    return torch.stack([arcs // n, arcs % n], 1), pts


def coordinate_tiles(points: torch.Tensor, tiles: int) -> np.ndarray:
    """(n,) int32 partition labels: ``tiles`` x ``tiles`` square tiles of
    the unit square, numbered row-major."""
    t = (points * tiles).long().clamp_(max=tiles - 1)
    return (t[:, 1] * tiles + t[:, 0]).to(torch.int32).cpu().numpy()


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """The configuration's graph drawn from ``seed`` on ``device``:
    ``edges`` (E, 2) int64 as a host array, ``n``, and ``part``: the
    partition labels."""
    g, p = cfg["graph"], cfg["partition"]
    if g["generator"] != "rgg":
        raise ValueError(f"unknown generator {g['generator']!r}")
    edges, pts = rgg(g["log2_vertices"], g["radius_coefficient"],
                     generator(seed, 0, device), device)
    if p["kind"] != "coordinate_tiles":
        raise ValueError(f"unknown partition {p['kind']!r}")
    return {"edges": edges.cpu().numpy(), "n": pts.shape[0],
            "part": coordinate_tiles(pts, p["tiles"])}
