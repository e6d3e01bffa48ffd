"""The benchmark's generator: seeded, the challenge's graph exactly."""

import math

import numpy as np
import torch

from hpbench.graphs import (coordinate_tiles, generator, make_inputs, rgg,
                            rgg_radius, sub_seed)
from repro_torch.data.graphs import geometric_graph

CPU = torch.device("cpu")


def test_sub_seeds_differ_by_stream_and_take_large_seeds():
    big = 2**31 + 977
    assert sub_seed(big, 0) != sub_seed(big, 1)
    assert sub_seed(big, 0) == sub_seed(big, 0)
    assert 0 <= sub_seed(2**64 + 5, 3) < 2**63


def test_same_seed_same_graph():
    a, pa = rgg(10, 0.55, generator(5, 0, CPU), CPU)
    b, pb = rgg(10, 0.55, generator(5, 0, CPU), CPU)
    c, _ = rgg(10, 0.55, generator(6, 0, CPU), CPU)
    assert torch.equal(a, b) and torch.equal(pa, pb)
    assert not torch.equal(a, c)


def test_rgg_is_every_pair_below_the_radius():
    """Against all pairs of the same points: an arc both ways for each pair
    closer than 0.55 sqrt(ln n / n), no other, sorted and unique."""
    for seed in (3, 2**31 + 11):
        e, pts = rgg(9, 0.55, generator(seed, 0, CPU), CPU)
        n = pts.shape[0]
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        want = torch.nonzero(d2 < rgg_radius(n, 0.55) ** 2)
        want = want[want[:, 0] != want[:, 1]]
        assert torch.equal(e, want)          # nonzero is row-major sorted


def test_rgg_edge_count_matches_the_ports_generator():
    """At 2^14 points, the arc count within 3 % of
    ``repro_torch.data.graphs.geometric_graph`` at the same radius (two
    independent draws of one distribution) and of n^2 pi r^2 less the
    border's loss."""
    n = 1 << 14
    r = rgg_radius(n, 0.55)
    e, _ = rgg(14, 0.55, generator(11, 0, CPU), CPU)
    ref, _ = geometric_graph(n, radius=r, seed=1)
    assert abs(len(e) - len(ref)) <= 0.03 * len(ref)
    expect = n * n * math.pi * r * r * (1 - 8 * r / (3 * math.pi))
    assert abs(len(e) - expect) <= 0.03 * expect


def test_vertices_numbered_by_cell():
    e, pts = rgg(12, 0.55, generator(7, 0, CPU), CPU)
    g = int(1 / rgg_radius(pts.shape[0], 0.55))
    cell = (pts * g).long().clamp(max=g - 1)
    key = cell[:, 1] * g + cell[:, 0]
    assert (key[1:] >= key[:-1]).all() and key[0] == 0


def test_tiles_are_square_and_row_major():
    pts = torch.tensor([[0.1, 0.1], [0.9, 0.1], [0.1, 0.9], [0.99, 0.999],
                        [0.5, 0.49]], dtype=torch.float64)
    np.testing.assert_array_equal(coordinate_tiles(pts, 2), [0, 1, 2, 3, 1])


def test_make_inputs_host_arrays():
    cfg = {"graph": {"generator": "rgg", "log2_vertices": 8,
                     "radius_coefficient": 0.55},
           "partition": {"kind": "coordinate_tiles", "tiles": 2}}
    inp = make_inputs(cfg, 9, CPU)
    assert inp["n"] == 256 and inp["edges"].dtype == np.int64
    assert inp["part"].shape == (256,) and inp["part"].dtype == np.int32
    assert set(inp["part"]) == {0, 1, 2, 3}
