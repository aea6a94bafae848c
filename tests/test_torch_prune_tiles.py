"""K1's work units on the CPU: a replay of the kernel's loops
(``prune_kernel.prune_walk``: the stream route's chunks, the tiles' (tile,
row, group) loops) loads every element of ``w`` once, stores every
element of ``pruned`` and ``mask`` once and ranks every group once, never
across a row's end, at ragged row counts, shallow and deep k, both element
sizes, group sizes 1 to 32, with one block a unit (as launched) and
with fewer blocks than units (each takes units with the grid's stride)."""

import math

import pytest

from sparsifyme_tpu_torch.ops.kernels import prune_kernel as pk


@pytest.mark.parametrize("k", [1, 3, 9, 64, 147, 576, 4608, 5000])
@pytest.mark.parametrize("rows", [1, 37, 1001])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("m", [1, 4, 5, 8, 32])
def test_prune_walk_covers_each_group_once(k, rows, itemsize, m):
    plan = pk.prune_plan(rows, k, m, itemsize)
    unit = 16 // itemsize
    kt, rt = plan.k_tile, plan.rows_per_tile
    # a flat stream of 16-byte chunks where no group crosses a row and a
    # chunk holds whole groups; else tiles
    stream = k % m == 0 and m in (4, 8) and m * itemsize <= 16
    assert (plan.mode == "stream") == stream
    if stream:  # 256 chunks a unit
        assert (rt, kt) == (1, unit)
        assert plan.units == -(-rows * k // (256 * unit))
    else:
        assert rt * kt * itemsize <= pk.PRUNE_TILE_BYTES
        assert plan.units == -(-rows // rt) * -(-k // kt)
    if plan.mode == "rows":  # whole rows, one span of 16-byte chunks
        assert kt == k and rt * k % unit == 0
    if plan.mode == "cols":  # pieces that start at a multiple of 16 B
        assert kt < k or rt * k % unit != 0
        assert kt % math.lcm(m, unit) == 0
    # one block a unit, as launched; fewer blocks than units
    for grid in {plan.units, max(1, plan.units // 3)}:
        walk = pk.prune_walk(plan, rows, k, m, itemsize, grid)
        assert walk.crossing == 0
        assert (walk.loads == 1).all() and (walk.stores == 1).all()
        assert tuple(walk.ranked.shape) == (rows, -(-k // m))
        assert (walk.ranked == 1).all()


def test_prune_plan_tiles():
    """The main path's shapes (b=32, 2:4): conv1's k = 147 in 48 whole bf16
    rows a tile (24 f32), every k % 4 == 0 shape one stream of 16-byte
    chunks; whole rows where a chunk holds no whole group; an odd k too
    deep for 8 rows a tile, and a deep row that is no 16-byte multiple,
    in column pieces."""
    assert pk.prune_plan(401408, 147, 4, 2) == ("rows", 48, 147, 8363)
    assert pk.prune_plan(401408, 147, 4, 4) == ("rows", 24, 147, 16726)
    # 3136x1152 at b=32: 14450688 chunks of 8 bf16, 56448 units of 256
    assert pk.prune_plan(100352, 1152, 4, 2) == ("stream", 1, 8, 56448)
    assert pk.prune_plan(100352, 1152, 4, 4) == ("stream", 1, 4, 112896)
    assert pk.prune_plan(100352, 1152, 8, 2) == ("stream", 1, 8, 56448)
    # whole rows where a chunk holds no whole group
    assert pk.prune_plan(100352, 1152, 8, 4) == ("rows", 3, 1152, 33451)
    assert pk.prune_plan(6272, 4608, 32, 2) == ("rows", 1, 4608, 6272)
    # 8 rows of 1101 bf16 exceed a tile: whole-row pieces of 1120 columns
    # (1101 rounded up to lcm(5, 8) = 40), 7 a tile
    assert pk.prune_plan(10, 1101, 5, 2) == ("cols", 7, 1120, 2)
    assert pk.prune_plan(10, 5000, 32, 4) == ("cols", 1, 4096, 20)


def test_prune_walk_finds_a_bad_plan():
    """The walk is no tautology: column pieces that cut rows at no group
    boundary rank groups short of m, and a plan one unit short leaves
    elements unloaded."""
    bad = pk.PrunePlan("cols", 1, 74, 37 * 2)
    walk = pk.prune_walk(bad, 37, 147, 4, 2, bad.units)
    assert walk.crossing > 0 and not (walk.ranked == 1).all()
    plan = pk.prune_plan(37, 147, 4, 2)
    short = plan._replace(units=plan.units - 1)
    walk = pk.prune_walk(short, 37, 147, 4, 2, 1)
    assert (walk.loads == 0).any() and (walk.stores == 0).any()
