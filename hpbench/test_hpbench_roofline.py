"""The bytes-of-work reckoning against bytes counted by hand."""

import pytest
import torch

from hpbench.profiling import _union, is_port_kernel
from hpbench.roofline import (F32_OPS_PER_S, HBM_BYTES_PER_S, bound_ms,
                              launch_weighted_share, work_bytes)

# a 2 x 4 bin: occupied slots (0,0)->0, (0,1)->1, (1,0)->1, (1,3)->3
MSK = torch.tensor([[1, 1, 0, 0], [1, 0, 0, 1]], dtype=torch.bool)
IDX = torch.tensor([[0, 1, 0, 0], [1, 0, 0, 3]], dtype=torch.int32)


def test_narrow_bin_plain_product():
    # mask 8, idx + val 8 x 4 slots, a 4-byte output a row, 3 distinct
    # sources x 4 bytes
    assert work_bytes(MSK, IDX, 4) == 8 + 32 + 8 + 12
    # L = 16: outputs 64 bytes a row, sources 4 x 16 bytes
    assert work_bytes(MSK, IDX, 4 * 16, lanes=16) == 8 + 32 + 128 + 192


def test_narrow_bin_fused_steps():
    flag = torch.tensor([True, False, False, True])
    # min_step: 17 bytes a row, a flag byte per source, values are rows
    assert work_bytes(MSK, IDX, 17, flag=flag, x_is_row=True) == \
        8 + 32 + 34 + 3
    # pr_step: also the values of flagged sources (0 and 3)
    assert work_bytes(MSK, IDX, 17, flag=flag) == 8 + 32 + 34 + 3 + 8
    flag16 = torch.zeros((4, 16), dtype=torch.bool)
    flag16[0, :5] = True
    flag16[1, 0] = True
    flag16[2, :] = True                     # not a source of this bin
    assert work_bytes(MSK, IDX, 17 * 16, flag=flag16, lanes=16) == \
        8 + 32 + 34 * 16 + 3 * 16 + 4 * 6


def _wide(k):
    msk = torch.zeros((2, k), dtype=torch.bool)
    idx = torch.zeros((2, k), dtype=torch.int32)
    msk[0, 3] = msk[0, 200] = msk[1, 5] = True
    idx[0, 3] = idx[0, 200] = 7
    idx[1, 5] = 2
    return msk, idx


@pytest.mark.parametrize("k", [256, 250])
def test_wide_bin_reads_only_occupied_blocks(k):
    """Row 1's second fold block holds nothing and costs nothing: a row
    pointer a row (+1), and per occupied block (3 of 4) its index, 16
    bytes of bits and, at L = 1, its row."""
    msk, idx = _wide(k)
    assert work_bytes(msk, idx, 4) == 4 * 3 + 3 * 24 + 8 * 3 + 4 * 2 + 4 * 2
    assert work_bytes(msk, idx, 64, lanes=16) == \
        4 * 3 + 3 * 20 + 8 * 3 + 64 * 2 + 64 * 2


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert bound_ms(3.35e9, 0, 2) == pytest.approx(1.0)
    assert bound_ms(0, 67e9, 1) == pytest.approx(1.0)
    assert bound_ms(3.35e9, 67e9, 2, lanes=2) == pytest.approx(4.0)
    assert HBM_BYTES_PER_S == 3.35e12 and F32_OPS_PER_S == 67e12


def test_launch_weighting():
    rows = [{"launches": 3, "bound_ms": 1.0, "device_ms": 2.0},
            {"launches": 1, "bound_ms": 1.0, "device_ms": 4.0}]
    assert launch_weighted_share(rows) == pytest.approx(100 * 4 / 10)
    assert launch_weighted_share([]) is None
    assert launch_weighted_share([{"launches": 0, "bound_ms": 1.0,
                                   "device_ms": 1.0}]) is None


def test_profile_helpers():
    assert _union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]
    assert is_port_kernel("void graphhp::min_step_kernel<...>(...)")
    assert is_port_kernel("graphhp_set_condition")
    assert not is_port_kernel("Memcpy DtoD (Device -> Device)")
