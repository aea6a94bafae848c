"""K2's tiles on the CPU: a replay of the kernel's (tile, row, group) loops
loads every element of ``w`` once and stores every (group, row) of the
planes once, padded groups included, at ragged M, shallow and deep k, both
element sizes, fewer persistent blocks than tiles, and through the fold=2
view ``[rows/2, 2*kp]``."""

import pytest

from sparsifyme_tpu_torch.ops.kernels import prune_kernel as pk


@pytest.mark.parametrize("k", [1, 9, 64, 147, 200, 576])
@pytest.mark.parametrize("rows", [1, 37, 1001])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_compress_walk_covers_each_group_once(k, rows, itemsize):
    plan = pk.compress_plan(rows, k, itemsize)
    kp = -(-k // 64) * 64
    assert plan.span == (k <= pk.COMPRESS_KMAX)
    assert plan.k_tile == (kp if plan.span else pk.COMPRESS_KTILE)
    assert plan.rows_per_tile % 8 == 0
    assert 8 <= plan.rows_per_tile <= pk.COMPRESS_MAX_ROWS
    assert plan.rows_per_tile * itemsize >= 128  # whole lines stored
    tiles = -(-rows // plan.rows_per_tile)
    assert plan.units == tiles * (kp // plan.k_tile)
    # one block a unit, and fewer persistent blocks than units
    for grid in {plan.units, max(1, plan.units // 3)}:
        loads, writes = pk.compress_walk(plan, rows, k, itemsize, grid)
        assert tuple(writes.shape) == (kp // 4, rows)
        assert (loads == 1).all() and (writes == 1).all()


@pytest.mark.parametrize("k", [147, 576])
def test_compress_walk_through_the_fold2_view(k):
    """fold=2 compresses ``[rows, kp]`` viewed as ``[rows/2, 2*kp]``."""
    rows = 2 * 1001
    kp = -(-k // 64) * 64
    plan = pk.compress_plan(rows // 2, 2 * kp, 2)
    assert plan.span == (2 * kp <= pk.COMPRESS_KMAX)
    loads, writes = pk.compress_walk(plan, rows // 2, 2 * kp, 2, 396)
    assert (loads == 1).all() and (writes == 1).all()


def test_compress_plan_tiles():
    """Whole rows up to k = 160 (k = 147 at 64 rows: one 128-byte line of a
    bf16 plane row), 64-column k-tiles of 128 bf16 rows (64 f32) beyond,
    the fold=2 view of k = 147 (384 columns) included."""
    assert pk.compress_plan(401408, 147, 2)[:3] == (64, 192, True)
    assert pk.compress_plan(401408, 64, 2)[:3] == (128, 64, True)
    assert pk.compress_plan(200704, 384, 2)[:3] == (128, 64, False)
    assert pk.compress_plan(100352, 1152, 2)[:3] == (128, 64, False)
    assert pk.compress_plan(100352, 1152, 4)[:3] == (64, 64, False)
    # 784 row tiles x 18 k-tiles
    assert pk.compress_plan(100352, 1152, 2).units == 784 * 18
