"""K6's layout and plan on the CPU: ``coo_layout`` is a stable permutation
within block-rows sorted by (k-chunk, row offset) with the right segment
starts; the plain version on that layout against the JAX Pallas kernel
(interpreted) on the JAX packer's planes; and a replay of the kernel's
(block-row, row group, n-tile, k-chunk range) loops that covers every kept
entry and every output column once, split or not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsifyme_tpu.ops import coo as jcoo
from sparsifyme_tpu.ops.kernels import coo_kernel as jkern
from sparsifyme_tpu_torch import convert
from sparsifyme_tpu_torch.ops import coo as tcoo
from sparsifyme_tpu_torch.ops.kernels import coo_kernel as tkern


def _planes(rng, mb, e, k, bm):
    """Hand-made planes: duplicates, out-of-range columns and row offsets,
    and a chunk with no entries (columns in [kc, 2 kc) never drawn)."""
    cols = rng.integers(0, k, (mb, e))
    cols[(cols >= 16) & (cols < 32)] = 0
    roff = rng.integers(0, bm, (mb, e))
    cols[:, 1], roff[:, 1] = cols[:, 0], roff[:, 0]  # a duplicate
    cols[0, 2], cols[-1, 3], roff[0, 4], roff[-1, 5] = k, -1, bm, -2
    vals = rng.normal(size=(mb, e)).astype(np.float32)
    # padding as the packer writes it (0 at row 0, column 0), and a repeated
    # zero elsewhere
    cols[:, -40:], roff[:, -40:], vals[:, -40:] = 0, 0, 0.0
    cols[:, 10:13], roff[:, 10:13], vals[:, 10:13] = 5, 3, 0.0
    return (torch.from_numpy(vals), torch.from_numpy(cols.astype(np.int32)),
            torch.from_numpy(roff.astype(np.int32)))


def _segments(lay, bm):
    """(k-chunk, row offset) of each slot of the layout, from the segment
    its position falls in; row offset ``bm`` (out of range: it adds
    nothing) for the dropped slots past ``starts[:, -1]``."""
    mb, e = lay.vals.shape
    pos = torch.arange(e).expand(mb, -1).contiguous()
    seg = torch.searchsorted(lay.starts.long(), pos, right=True) - 1
    kept = pos < lay.starts[:, -1:]
    return seg // bm, torch.where(kept, seg % bm, bm).int(), kept


@pytest.mark.parametrize("bm,kc", [(128, 16), (16, 64), (48, 32)])
def test_coo_layout_is_a_sorted_permutation(rng, bm, kc):
    k, mb, e = 150, 3, 256
    vals, cols, roff = _planes(rng, mb, e, k, bm)
    lay = tkern.coo_layout(vals, cols, roff, k=k, block_rows=bm, kc=kc)
    n_chunks = -(-k // kc)
    assert lay.kc == kc and lay.k == k
    assert tuple(lay.starts.shape) == (mb, n_chunks * bm + 1)
    assert lay.starts.dtype == torch.int32 and lay.vals.dtype == torch.float32
    valid = (cols >= 0) & (cols < k) & (roff >= 0) & (roff < bm)
    for i in range(mb):  # repeated zero-valued (row, column): dropped
        seen = set()
        for j in range(e):
            if valid[i, j] and vals[i, j] == 0:
                at = (int(roff[i, j]), int(cols[i, j]))
                valid[i, j] = at not in seen
                seen.add(at)
    assert lay.nnz == int(valid.sum())
    assert lay.peak == int(valid.sum(1).max())
    chunk, row, kept = _segments(lay, bm)
    for i in range(mb):
        key = [(int(c) // kc) * bm + int(r) if ok else n_chunks * bm
               for c, r, ok in zip(cols[i], roff[i], valid[i])]
        order = sorted(range(e), key=lambda s: key[s])  # stable
        assert torch.equal(lay.vals[i], vals[i, order])
        assert torch.equal(lay.cols[i], cols[i, order])
        # each kept slot's segment is its entry's (chunk, row offset)
        n = int(kept[i].sum())
        assert torch.equal(row[i, :n], roff[i, order][:n])
        assert torch.equal(chunk[i, :n], (cols[i, order][:n] // kc).long())
        skey = sorted(key)
        want = [sum(1 for x in skey if x < j)
                for j in range(n_chunks * bm + 1)]
        assert lay.starts[i].tolist() == want
        # the chunk of columns 16..31 is empty wherever kc divides it
        if kc == 16:
            assert lay.starts[i, bm] == lay.starts[i, 2 * bm]


@pytest.mark.parametrize("block_rows", [128, 16])
@pytest.mark.parametrize("density", [0.2, 0.02])
def test_plain_on_the_layout_matches_jax_pallas(rng, block_rows, density):
    """The layout's planes through the plain version against the TPU kernel
    (interpreted) on the JAX packer's planes, B batch-folded, 1e-5."""
    m, k, n, batch = 200, 130, 24, 3  # ragged m
    w = rng.normal(size=(m, k)).astype(np.float32)
    w *= rng.random((m, k)) < density
    w[7, 3] = 0.0
    j = jcoo.coo_from_dense(w, nnz=int((w != 0).sum()) + 5)  # zero padding
    planes = jcoo.pack_coo(j, block_rows)
    b = rng.normal(size=(batch, k, n)).astype(np.float32)
    want = np.asarray(jkern.spmm_coo_pallas(
        *planes, jnp.asarray(np.moveaxis(b, 0, 1).reshape(k, batch * n)),
        m=m, block_rows=block_rows, interpret=True))
    t = tuple(torch.from_numpy(np.array(p)) for p in planes)
    lay = tkern.coo_layout(*t, k=k, block_rows=block_rows)
    got = tkern.spmm_coo_plain(lay.vals, lay.cols,
                               _segments(lay, block_rows)[1],
                               torch.from_numpy(b), m=m,
                               block_rows=block_rows)
    got2 = np.moveaxis(convert.tensor_to_numpy(got), 0, 1).reshape(
        m, batch * n)
    np.testing.assert_allclose(got2, want, rtol=1e-5, atol=1e-5)
    # the CPU entry point takes a layout and reads the planes as they are
    a = convert.coo_from_numpy(np.asarray(j.rows), np.asarray(j.cols),
                               np.asarray(j.values), j.shape, device="cpu")
    out = tcoo.spmm_coo_segmented(a, torch.from_numpy(b), packed=t,
                                  layout=lay, block_rows=block_rows)
    assert torch.equal(out, tkern.spmm_coo_plain(*t, torch.from_numpy(b),
                                                 m=m, block_rows=block_rows))


@pytest.mark.parametrize("how", ["other A", "written in place",
                                 "other block_rows"])
def test_a_layout_is_held_to_its_planes(rng, how):
    """K6 reads the layout alone, so a layout that does not describe the
    planes passed beside it is refused, on the CPU as on the card: one
    built from another A of the same shape, from these planes before an
    in-place write, or for another block_rows."""
    m, k, bm = 40, 30, 16
    w = rng.normal(size=(m, k)).astype(np.float32)
    w *= rng.random((m, k)) < 0.3

    def coo(x):
        r, c = np.nonzero(x)
        return convert.coo_from_numpy(r, c, x[r, c], (m, k), device="cpu")

    a = coo(w)
    b = torch.from_numpy(rng.normal(size=(2, k, 8)).astype(np.float32))
    packed = tcoo.pack_coo(a, bm)
    lay = tkern.coo_layout(*packed, k=k, block_rows=bm)
    assert torch.equal(
        tcoo.spmm_coo_segmented(a, b, packed=packed, layout=lay,
                                block_rows=bm),
        tkern.spmm_coo_plain(*packed, b, m=m, block_rows=bm))
    kw = dict(packed=packed, layout=lay, block_rows=bm)
    if how == "other A":
        a = coo(w[::-1].copy())
        kw["packed"] = tcoo.pack_coo(a, bm)
    elif how == "written in place":
        packed[0].mul_(2)
    else:
        kw["block_rows"] = 8
        kw["packed"] = tcoo.pack_coo(a, 8)
        kw["layout"] = lay._replace(
            source=tkern._identity(*kw["packed"]))  # only the shape differs
    with pytest.raises(ValueError, match="layout"):
        tcoo.spmm_coo_segmented(a, b, **kw)


@pytest.mark.parametrize("bm,k,cols,splits", [
    (128, 150, 300, None), (128, 150, 300, 3), (48, 64, 96, 2),
    (256, 100, 128, None), (16, 40, 8, 1)])
def test_coo_plan_walk_covers_each_entry_and_column_once(rng, bm, k, cols,
                                                         splits):
    mb, e = 3, 512
    vals, c, r = _planes(rng, mb, e, k, bm)
    lay = tkern.coo_layout(vals, c, r, k=k, block_rows=bm, kc=16)
    plan = tkern.coo_plan(mb, bm, k, lay.kc, lay.nnz, cols,
                          split_counts=None if splits is None else (splits,))
    assert plan.splits == (splits or plan.splits)
    assert plan.grid == (plan.n_tiles, mb * plan.row_groups, plan.splits)
    entry, colv, chunkv = tkern.plan_walk(plan, lay, bm)
    kept = torch.arange(e)[None, :] < lay.starts[:, -1:]
    assert torch.equal(entry, kept.int() * plan.n_tiles)
    assert (colv == 1).all() and colv.shape[0] == plan.splits
    assert (chunkv == 1).all()


def test_coo_plan_picks_route_and_splits():
    """Gather where a staged B row would feed fewer than STAGE_MIN_REUSE
    entries of a row group (0.98 and sparser at bm 128) and k > 512,
    staged where it feeds more or k <= 512; splits where a unit alone
    would take long beside the work spread over the card."""
    n, b = 128, 32
    for m, k, sp, route in ((3136, 1152, 0.995, "gather"),
                            (3136, 1152, 0.98, "gather"),
                            (3136, 1152, 0.97, "staged"),
                            (3136, 1152, 0.9, "staged"),
                            (3136, 512, 0.995, "staged"),
                            (784, 256, 0.995, "staged")):
        mb = -(-m // 128)
        nnz = int(m * k * (1 - sp))
        kc = tkern.coo_kc(nnz, mb, 128, k)
        assert kc == (128 if route == "staged" else tkern.GATHER_KC)
        assert tkern.coo_plan(mb, 128, k, kc, nnz, b * n).route == route
    m, k = 3136, 1152
    mb = -(-m // 128)
    assert tkern.coo_kc(int(m * k * 0.5), mb, 128, k) == 32
    assert tkern.coo_kc(int(m * k * 0.1), mb, 128, k) == 128
    # two block-rows and 2 n-tiles fill few of the card's blocks: split
    plan = tkern.coo_plan(2, 128, 4608, 16, 451000, 256)
    assert plan.splits > 1 and plan.route == "staged"
