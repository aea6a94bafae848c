"""The Hopper designs of the units probe (``bench/units_probe.py``) on the
CPU: the operand of the ``wgmma_sp`` tile, its split-k plan, and the dense
slot of the ``fp1`` tile.

* :func:`units_probe.pack_wgmma_sp` round-trips the planes bit for bit
  (:func:`units_probe.unpack_wgmma_sp`), and a decoder written here from
  the 64-byte swizzle of the values (:func:`units_probe.sw64_offset`, TMA's
  pattern) and the thread -> (row, group) map of the sparse ``wgmma``
  metadata (CUTLASS's
  ``ELayout_64x32`` for 16-bit types: thread ``(warp, gid, tig)`` holds
  rows ``16 warp + gid`` and ``+ 8``, groups ``4 (tig & 1)..+3`` of its
  k32 half; ``tig & 2`` repeats) rebuilds ``expand_planes``'s dense A
  exactly, on codes that differ from group to group in every row;
* the metadata words are K3's: their XOR per 128-row block is
  ``meta_xor``'s, so the ``feed`` mode's side words need no other plain
  version;
* :func:`units_probe.wg_plan` and :func:`units_probe.wg_walk` cover every
  (m-tile, n-tile, k-step) exactly once at the five probe shapes;
* :func:`units_probe.expand_slot_offset` is a bijection on a slot and is
  the 128-byte TMA swizzle of the box that K5's values_km gives.

The kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""

import itertools

import numpy as np
import pytest
import torch

from sparsifyme_tpu_torch.bench import units_probe as up
from sparsifyme_tpu_torch.ops.kernels import spmm24_kernel as k3
from sparsifyme_tpu_torch.ops.kernels.prune_kernel import \
    prune_compress_24_plain

# the six codes i0 * 4 + i1 with i0 < i1
VALID = torch.tensor([1, 2, 3, 6, 7, 11], dtype=torch.int64)


def _varied_planes(rng, k4, m):
    """Random bf16 planes and codes whose code changes from each group to
    the next in every row."""
    idx = np.empty((k4, m), dtype=np.int64)
    idx[0] = rng.integers(0, 6, m)
    for g in range(1, k4):
        idx[g] = (idx[g - 1] + rng.integers(1, 6, m)) % 6
    codes = VALID[torch.from_numpy(idx)].to(torch.uint8)
    v = rng.standard_normal((2, k4, m)).astype(np.float32)
    v0, v1 = (torch.from_numpy(x).to(torch.bfloat16) for x in v)
    return v0, v1, codes


def _decode(packed, m):
    """Dense A^T ``[64 ktp, m]`` from the packed operand, one thread's
    word at a time as ``wgmma.sp`` reads it (selector 0: tig 0 and 1), each
    value read at its swizzled place."""
    ktp, mt_n, _ = packed.shape
    vals = packed[:, :, :2048].contiguous().view(torch.bfloat16)
    dense = torch.zeros((64 * ktp, m), dtype=torch.bfloat16)
    for mt, kt, wg, hf, warp, gid, tig in itertools.product(
            range(mt_n), range(ktp), range(2), range(2), range(4), range(8),
            range(2)):
        word = int(packed[kt, mt, 2048 + wg * 128 + hf * 64 + warp * 16
                          + gid * 2 + tig]) & 0xFFFFFFFF
        for half in range(2):
            r = wg * 64 + warp * 16 + gid + 8 * half
            for j in range(4):
                nib = (word >> (16 * half + 4 * j)) & 15
                gl = hf * 8 + 4 * tig + j
                g = kt * 16 + gl
                for q, plane in ((nib & 3, 0), (nib >> 2, 1)):
                    off = up.sw64_offset(r, 2 * gl + plane) // 2
                    dense[4 * g + q, mt * 128 + r] = vals[kt, mt, off]
    return dense


@pytest.mark.parametrize("k4,m", [(32, 128), (20, 256), (7, 128)])
def test_pack_round_trips_the_planes(rng, k4, m):
    v0, v1, codes = _varied_planes(rng, k4, m)
    packed = up.pack_wgmma_sp(v0, v1, codes)
    ktp = -(-k4 // 16)
    assert packed.shape == (ktp, m // 128, 2304)
    assert packed.dtype == torch.int32 and packed.is_contiguous()
    back = up.unpack_wgmma_sp(packed, k4)
    for got, want in zip(back, (v0, v1, codes)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # the padding past k4 is zero values
    assert not _decode(packed, m)[4 * k4:].float().any()


@pytest.mark.parametrize("k4,m", [(32, 128), (20, 256)])
def test_thread_map_decodes_to_the_dense_a(rng, k4, m):
    v0, v1, codes = _varied_planes(rng, k4, m)
    packed = up.pack_wgmma_sp(v0, v1, codes)
    dense = _decode(packed, m)
    assert torch.equal(dense[:4 * k4], k3.expand_planes(v0, v1, codes))
    # a swapped nibble in one word moves two values of one row
    bad = packed.clone()
    bad[0, 0, 2048 + 5] ^= 0x1
    assert not torch.equal(_decode(bad, m), dense)


def test_pack_of_compressed_planes(rng):
    """The planes K2's plain version writes, at the layout's edges: k a
    multiple of 64 and M of 128."""
    a = torch.from_numpy(rng.standard_normal((256, 192)).astype(np.float32))
    v0, v1, codes = prune_compress_24_plain(a.to(torch.bfloat16))
    packed = up.pack_wgmma_sp(v0, v1, codes)
    assert torch.equal(_decode(packed, 256), k3.expand_planes(v0, v1, codes))
    with pytest.raises(ValueError, match="128"):
        up.pack_wgmma_sp(v0[:, :200], v1[:, :200], codes[:, :200])


@pytest.mark.parametrize("k", [64, 192, 200])
def test_words_xor_to_the_feed_side_words(rng, k):
    """The packed words of a 128-row tile, XORed over its k-steps, are
    ``meta_xor``'s word for that block: K3's words in another order."""
    k4 = -(-k // 4)
    v0, v1, codes = _varied_planes(rng, k4, 256)
    packed = up.pack_wgmma_sp(v0, v1, codes)
    kt = -(-k // 64)
    w = packed[:kt, :, 2048:].to(torch.int64) & 0xFFFFFFFF
    w = w.permute(1, 0, 2).reshape(2, -1)  # [tile, every word of its steps]
    acc = torch.zeros(2, dtype=torch.int64)
    for i in range(w.shape[1]):
        acc ^= w[:, i]
    assert torch.equal(acc, up.meta_xor(codes, k, 128))


@pytest.mark.parametrize("m,n,k", up.SHAPES + [(1024, 128, 2048),
                                               (128, 64, 64)])
def test_wg_plan_covers_every_step_once(m, n, k):
    plan = up.wg_plan(m, n, k)
    assert plan.bn in (64, 128) and n % plan.bn == 0
    assert 1 <= plan.grid <= 132 and plan.units == \
        (m // 128) * (n // plan.bn) * plan.splits
    kt = -(-k // 64)
    assert (plan.splits - 1) * plan.kps < kt <= plan.splits * plan.kps
    seen = {}
    for walk in up.wg_walk(plan, m, n, k):
        for m_tile, n_tile, split, steps in walk:
            assert steps, "an empty split"
            for s in steps:
                key = (m_tile, n_tile, s)
                assert key not in seen
                seen[key] = split
    assert len(seen) == (m // 128) * (n // plan.bn) * kt


def test_wg_plan_splits_where_tiles_do_not_fill_the_card():
    """A shape of 8 tiles and 32 k-steps takes the most splits; the five
    probe shapes fill the card unsplit (at D, 196 tiles, two splits were
    slower on an H100: units_probe --plans)."""
    assert up.wg_plan(1024, 128, 2048).splits == 8
    assert up.wg_plan(1024, 128, 2048, sms=8).splits == 1
    for m, n, k in up.SHAPES:
        assert up.wg_plan(m, n, k).splits == 1
    with pytest.raises(ValueError, match="128"):
        up.wg_plan(200, 64, 64)
    with pytest.raises(ValueError, match="64"):
        up.wg_plan(256, 72, 64)


def test_slot_offset_is_the_tma_swizzle():
    """Every (k, m) of a 64 x 128 slot gets its own 2-byte place, and the
    place is TMA's 128-byte swizzle of the unswizzled box layout (64-row
    boxes of k-rows of 128 bytes): bits 4-6 XOR bits 7-9."""
    seen = set()
    for kk, m in itertools.product(range(64), range(128)):
        off = up.expand_slot_offset(kk, m)
        plain = (m // 64) * 64 * 128 + kk * 128 + (m % 64) * 2
        assert off == plain ^ (((plain >> 7) & 7) << 4)
        seen.add(off)
    assert seen == set(range(0, 64 * 128 * 2, 2))


def test_sw64_offset_is_the_64_byte_swizzle():
    """Every (row, compressed column) of a 128 x 32 tile gets its own
    2-byte place, TMA's 64-byte swizzle of the row-major tile (bits 4-5
    XOR bits 7-8), which leaves rows 0 and 1 in place."""
    seen = set()
    for r, c in itertools.product(range(128), range(32)):
        off = up.sw64_offset(r, c)
        plain = r * 64 + c * 2
        assert off == plain ^ (((plain >> 7) & 3) << 4)
        seen.add(off)
    assert seen == set(range(0, 128 * 64, 2))
    assert [up.sw64_offset(r, c) for r in (0, 1) for c in range(32)] == \
        list(range(0, 128, 2))


def test_wgmma_sp_wrapper_refuses_what_it_cannot_take(rng):
    v0, v1, codes = _varied_planes(rng, 16, 128)
    b = torch.zeros((64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        up.units_cuda(v0, v1, codes, b, mode="full", stages=4,
                      design="wgmma_sp")
    with pytest.raises(ValueError, match="design"):
        up.units_cuda(v0, v1, codes, b, mode="full", stages=4,
                      design="wmma")
    with pytest.raises(ValueError, match="CUDA"):
        up.fp1_cuda(v0, v1, codes, b)


@pytest.mark.parametrize("stages", [4, 2])
def test_feed_at_the_wgmma_sp_tile(rng, stages):
    """The feed mode's plain version at the new tile's 128 rows: each
    block's rows get the sum of its first row, its side word the XOR of its
    words."""
    v0, v1, codes = _varied_planes(rng, 32, 256)
    b = torch.zeros((128, 64), dtype=torch.bfloat16)
    out, side = up.units_plain(v0, v1, codes, b, mode="feed",
                               stages=stages, bm=128, bn=64)
    for blk in range(2):
        want = (v0[:, 128 * blk].float() + v1[:, 128 * blk].float()).sum()
        assert torch.allclose(out[128 * blk:128 * (blk + 1)].float(),
                              want.expand(128, 64), rtol=2e-2)
    assert side.shape == (1, 2)
    assert torch.equal(side[0].to(torch.int64) & 0xFFFFFFFF,
                       up.meta_xor(codes, 128, 128))


def test_rebuilds_find_their_code():
    """Each ``--ablate`` edit of the expand-then-dense tile and the
    ``--depths`` edit of the wgmma.sp tile name text their headers still
    hold (the probe's ctypes specs: ``tests/test_torch_package.py``)."""
    from sparsifyme_tpu_torch import _build

    head = (_build.CSRC / "sp24_expand_tile.cuh").read_text()
    for edits in up.FP1_ABLATIONS.values():
        for old, new in edits:
            assert head.count(old) == 1 and old != new
    wg = (_build.CSRC / "sp24_wg_tile.cuh").read_text()
    assert wg.count(up.WG_DEPTH_LINE) == 1


# --- K3's 256-row unit -------------------------------------------------------

# MiMo-V2-Flash's 2:4 products as one card of its TP8/EP8 deployment runs
# them (M x K, n): q, o, layer 0's gate_up and down at 32768 tokens, and an
# expert's gate_up and down at the routed rows of a compute-bound expert
MIMO_TALL = [(1536, 4096, 32768), (4096, 1024, 32768), (32768, 4096, 32768),
             (4096, 16384, 32768), (4096, 4096, 1024), (4096, 4096, 64 * 13),
             (4096, 4096, 64 * 17), (4096, 2048, 1024), (4096, 2048, 64 * 17)]


def _tall_walk_cases():
    """Shapes and split counts 1-3 that leave no split empty."""
    for m, n, k in [(256, 64, 64), (768, 192, 200), (2560, 1024, 4096),
                    (1280, 320, 4608), (3072, 128, 1000)]:
        kt = -(-k // 64)
        for splits in (1, 2, 3):
            if (splits - 1) * -(-kt // splits) < kt:
                yield m, n, k, splits


@pytest.mark.parametrize("m,n,k,splits", list(_tall_walk_cases()))
def test_wg_walk_of_the_tall_unit_covers_every_step_once(m, n, k, splits):
    """Every band the walk can take (one m-tile to all of them, and a last
    band that holds fewer), at each width and split count that leaves no
    split empty: each (256-row m-tile, n-tile, split) once, its k-steps the
    split's, and every k-step of every tile once."""
    kt = -(-k // 64)
    mt = m // 256
    for bn in (64, 128):
        if n % bn:
            continue
        base = k3.wg_forced_plan(m, n, k, bn, splits, rows=256)
        assert isinstance(base, k3.WgTallPlan) and base.rows == 256
        assert base.units == mt * (n // bn) * splits
        for band in sorted({1, 2, 3, mt, max(1, mt - 1), base.band}):
            plan = base._replace(band=band)
            units, steps = set(), set()
            for walk in k3.wg_walk(plan, m, n, k):
                for m_tile, n_tile, split, ks in walk:
                    assert 0 <= m_tile < mt and 0 <= n_tile < n // bn
                    assert (m_tile, n_tile, split) not in units
                    units.add((m_tile, n_tile, split))
                    k0 = split * plan.kps
                    assert ks == list(range(k0, min(kt, k0 + plan.kps)))
                    steps.update((m_tile, n_tile, s) for s in ks)
            assert len(units) == plan.units
            assert len(steps) == mt * (n // bn) * kt


def test_wg_walk_of_a_band_puts_the_m_tiles_first():
    """A band of 3 m-tiles of 8 at 4 n-tiles: units 0-11 are the band's
    three m-tiles at n-tile 0, 1, 2, 3 in turn, then the next band; the
    last band holds the 2 m-tiles left."""
    plan = k3.WgTallPlan(128, 1, 1, 32, 32, 3)
    order = [walk[0][:2] for walk in k3.wg_walk(plan, 8 * 256, 512, 64)]
    assert order[:7] == [(0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (2, 1),
                         (0, 2)]
    assert order[12:15] == [(3, 0), (4, 0), (5, 0)]
    assert order[24:] == [(6, 0), (7, 0), (6, 1), (7, 1), (6, 2), (7, 2),
                          (6, 3), (7, 3)]


@pytest.mark.parametrize("m,k,n", MIMO_TALL)
def test_wg_plan_takes_the_tall_unit_on_mimos_products(m, k, n):
    plan = k3.wg_plan(m, n, k)
    assert k3.wg_tall(m, n, k)
    assert isinstance(plan, k3.WgTallPlan), plan
    assert plan.units == (m // 256) * (n // plan.bn) * plan.splits
    assert 1 <= plan.band <= m // 256
    # K7's ring step has no tall unit
    assert isinstance(k3.wg_plan(m, n, k, tall=False), k3.WgPlan)


@pytest.mark.parametrize("model", ["resnet50", "resnet152"])
def test_wg_plan_keeps_the_128_row_unit_on_resnet(model):
    """No ResNet shape (b = 32 folded into M) is both compute-bound and a
    multiple of 256 rows; a byte-bound expert (few routed rows) and a
    compute-bound shape too narrow to fill a wave of 256-row units keep
    128 rows."""
    from sparsifyme_tpu_torch.models.resnet_shapes import resnet_conv_shapes

    for s in resnet_conv_shapes(model):
        m, n = s.m * s.b, s.n
        if m % 128 or n % 64:
            continue
        assert type(k3.wg_plan(m, n, s.k)) is k3.WgPlan, s
    assert not k3.wg_tall(4096, 64, 4096)
    assert type(k3.wg_plan(4096, 64, 4096)) is k3.WgPlan
    assert k3.wg_tall(4096, 512, 4096)
    assert type(k3.wg_plan(4096, 512, 4096)) is k3.WgPlan


def test_wg_band_is_eight_m_tiles_or_every_one():
    """A band is WG_BAND m-tiles of 256 rows, or all of them where there
    are fewer: MiMo's q (6 m-tiles) walks one band, gate_up 16 bands."""
    assert k3.wg_band(32768) == k3.WG_BAND == 8
    assert k3.wg_band(2048) == 8
    assert k3.wg_band(1536) == 6
    assert k3.wg_band(256) == 1
    assert k3.wg_plan(32768, 32768, 4096).band == 8
    assert k3.wg_plan(1536, 32768, 4096).band == 6


def test_forced_plans_keep_their_height():
    with pytest.raises(ValueError, match="256 rows"):
        k3.wg_forced_plan(384, 64, 64, 64, 1, rows=256)
    with pytest.raises(ValueError, match="rows"):
        k3.wg_forced_plan(512, 64, 64, 64, 1, rows=192)
    assert type(k3.wg_forced_plan(512, 64, 64, 64, 1)) is k3.WgPlan


@pytest.mark.parametrize("k4,m", [(16, 512), (40, 768)])
def test_pack_puts_a_tall_units_tiles_side_by_side(rng, k4, m):
    """The plain pack's 9 KB blocks of m-tiles 2j and 2j + 1 at a k-step are
    one contiguous 18 KB run, which is the pack of rows 256 j.. alone: one
    bulk copy a stage feeds the 256-row unit."""
    v0, v1, codes = _varied_planes(rng, k4, m)
    packed = up.pack_wgmma_sp(v0, v1, codes)
    ktp = packed.shape[0]
    runs = packed.reshape(-1)  # as the kernel addresses it, in words
    for j in range(m // 256):
        cols = slice(256 * j, 256 * (j + 1))
        alone = up.pack_wgmma_sp(v0[:, cols], v1[:, cols], codes[:, cols])
        for kt in range(ktp):
            start = (kt * (m // 128) + 2 * j) * 2304
            assert torch.equal(runs[start:start + 4608], alone[kt].reshape(-1))
