"""K6's launch plan (``ops/spmv.py`` ``bsr_spmm_plan`` and
``bsr_stage_blocks``), on the CPU: the instantiation, the 16-byte loads,
the team width and the column slots the wrapper picks for the shapes the
card tests run, and the outputs they reach.  The kernel's map from a lane
to its columns (``csrc/spmv.cu`` ``bsr_row``) is written out here as
``_lane_columns``; every output (row, c) must be reached exactly once.
Exact integer checks, no tolerance.
"""

import numpy as np
import pytest

from nonlinearsolve_tpu_torch.ops import spmv

NRHS = [1, 2, 8, 31, 32, 33, 37, 64, 100]
ITEMSIZE = {"float32": 4, "float64": 8}


def _lane_columns(plan, nrhs, lane):
    """The columns lane ``lane`` of a team writes, as ``bsr_row`` walks
    them: passes of vec·cols_per_lane·T columns from lane·vec, slots
    vec·T apart, vec columns a slot, those below nrhs."""
    team = 1 << plan.team_shift
    step = plan.vec * plan.cols_per_lane * team
    out = []
    for c0 in range(lane * plan.vec, nrhs, step):
        for s in range(plan.cols_per_lane):
            c = c0 + s * plan.vec * team
            if c < nrhs:
                out.extend(range(c, c + plan.vec))
    return out


def _block_rows(plan, n_brows):
    """The block rows each thread block's teams take: consecutive runs of
    BSR_THREADS >> team_shift, over the launcher's grid."""
    rows = spmv.BSR_THREADS >> plan.team_shift
    grid = -(-n_brows // rows)
    return [i for g in range(grid) for i in range(g * rows, (g + 1) * rows)
            if i < n_brows]


@pytest.mark.parametrize("nrhs", NRHS)
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8])
def test_plan_reaches_every_output_once(b, nrhs):
    for dtype, item in ITEMSIZE.items():
        for x_addr in (0x7f0000000000, 0x7f0000000000 + item):
            plan = spmv.bsr_spmm_plan(b, nrhs, item, x_addr)
            assert plan.block == (b if b in spmv.BSR_BLOCK_SIZES else 0)
            assert plan.vec in (1, 2, 4) and plan.vec * item <= 16
            assert nrhs % plan.vec == 0 and x_addr % (plan.vec * item) == 0
            assert plan.block or (plan.vec, plan.cols_per_lane) == (1, 1)
            assert max(plan.block, 1) * plan.vec * plan.cols_per_lane \
                <= spmv.BSR_MAX_VALUES
            assert 0 <= plan.team_shift <= 5
            groups = -(-nrhs // plan.vec)
            team = 1 << plan.team_shift
            two = plan.block * plan.vec * 2 <= spmv.BSR_MAX_VALUES \
                and plan.block > 0
            if groups <= 8:             # one pass, the smallest team
                assert (team, plan.cols_per_lane) == (
                    1 << (groups - 1).bit_length(), 1)
            elif two:                   # teams of 8, two slots a lane
                assert (team, plan.cols_per_lane) == (8, 2)
            else:       # the smallest team up to 32 (and the generic b)
                assert (team, plan.cols_per_lane) == (
                    min(32, 1 << (groups - 1).bit_length()), 1)
            cols = sorted(c for lane in range(1 << plan.team_shift)
                          for c in _lane_columns(plan, nrhs, lane))
            assert cols == list(range(nrhs)), (dtype, x_addr, plan)
            assert _block_rows(plan, 1000) == list(range(1000))


@pytest.mark.parametrize("b,nrhs,dtype,aligned,expect", [
    (2, 8, "float64", True, (2, 2, 1, 2)),      # the Brusselator's K6
    (2, 8, "float32", True, (2, 4, 1, 1)),
    (2, 37, "float64", True, (2, 1, 2, 3)),     # 37 = 16 + 16 + 5
    (2, 37, "float32", True, (2, 1, 2, 3)),
    (2, 8, "float64", False, (2, 1, 1, 3)),     # X off 16 bytes: scalar
    (2, 8, "float32", False, (2, 1, 1, 3)),
    (1, 1, "float64", True, (1, 1, 1, 0)),
    (4, 100, "float32", True, (4, 2, 1, 5)),    # b·vec·2 over 8 values
    (8, 64, "float32", True, (8, 1, 1, 5)),     # b·vec at most 8 values
    (8, 100, "float64", True, (8, 1, 1, 5)),    # 100 columns in 4 passes
    (3, 33, "float64", True, (3, 1, 2, 3)),
    (5, 37, "float64", True, (0, 1, 1, 5)),     # the generic kernel
    (6, 100, "float32", True, (0, 1, 1, 5)),    # 100 columns in 4 passes
])
def test_plan_for_named_shapes(b, nrhs, dtype, aligned, expect):
    item = ITEMSIZE[dtype]
    addr = 0x7f0000000000 + (0 if aligned else item)
    assert tuple(spmv.bsr_spmm_plan(b, nrhs, item, addr)) == expect


def _chunks(indptr, rows, stage):
    """The chunks a thread block of ``rows`` block rows stages, as
    ``bsr_spmm_kernel`` walks them: [s0, s0 + stage) from its first block
    to its last."""
    n = len(indptr) - 1
    return [[(s0, min(s0 + stage, indptr[min(g + rows, n)]))
             for s0 in range(indptr[g], indptr[min(g + rows, n)], stage)]
            for g in range(0, n, rows)]


@pytest.mark.parametrize("team_shift", [0, 2, 5])
@pytest.mark.parametrize("b,item", [(1, 4), (2, 8), (5, 8), (8, 8)])
def test_stage_blocks_and_chunks_cover_each_block_once(b, item, team_shift):
    """The chunk is the largest thread block's segment where it fits in
    BSR_STAGE_BYTES, else the most that fits; a thread block's chunks
    cover each of its blocks once; the generic b stages nothing."""
    rng = np.random.default_rng(b * 10 + team_shift)
    counts = rng.integers(0, 9, 1000)
    counts[::50] = 0
    counts[700] = 70
    indptr = np.concatenate([[0], np.cumsum(counts)])
    got = spmv.bsr_stage_blocks(indptr, b, item, team_shift)
    if b not in spmv.BSR_BLOCK_SIZES:
        assert got == 0
        return
    rows = spmv.BSR_THREADS >> team_shift
    most = max(int(counts[g:g + rows].sum()) for g in range(0, 1000, rows))
    cap = spmv.BSR_STAGE_BYTES // (b * b * item + 4)
    assert got == min(most, cap)
    assert got * (b * b * item + 4) <= spmv.BSR_STAGE_BYTES
    staged = [k for cta in _chunks(indptr, rows, got) for s0, s1 in cta
              for k in range(s0, s1)]
    assert staged == list(range(indptr[-1]))
    assert all(s1 - s0 <= got for cta in _chunks(indptr, rows, got)
               for s0, s1 in cta)


def test_stage_blocks_of_the_brusselator_and_empty_patterns():
    """512² Brusselator as BSR (5 blocks a block row), f64 nrhs 8: teams of
    4, 64 block rows a thread block, 320 blocks (11.5 KB) staged; with no
    blocks, the kernel's least chunk of 1."""
    indptr = np.arange(0, 5 * (512 * 512 + 1), 5)
    plan = spmv.bsr_spmm_plan(2, 8, 8, 0)
    assert spmv.bsr_stage_blocks(indptr, 2, 8, plan.team_shift) == 320
    assert spmv.bsr_stage_blocks(np.array([0]), 2, 8, 0) == 1
    assert spmv.bsr_stage_blocks(np.zeros(9, np.int64), 2, 8, 3) == 1
