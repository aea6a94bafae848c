"""The Hopper kernels and routes against their plain versions on the card,
at small and ragged shapes the ResNet-50 sweep does not reach (group sizes
other than 4, n not a multiple of 64, M not a multiple of the tile, every
ELL tile geometry, mixed input types), through both the bf16 fast paths
(M and n multiples of 8) and the simple kernels: K1 prune, K2 compress and
its fused prune+compress route, K3 2:4 SpMM and its fold=2 route, K4 ELL
gather SpMM, K5 ELL expand SpMM, K6 segmented COO SpMM (ragged m, N
not a multiple of its 128-column tile, every value and B type, duplicate
and out-of-range entries) and K7, the ring step, with both rings on logical
ranks of one card (P = 1, 2, 3, 4, 8), the sharded SpMMs and the rings'
capacity credits under a delayed rank.

These tests need a CUDA card and skip without one. On the card:
``python -m pytest tests/test_torch_cuda.py -q``.
"""

import pytest
import torch

from sparsifyme_tpu_torch.ops.kernels import (ell_kernel, prune_kernel,
                                              spmm24_kernel)
from sparsifyme_tpu_torch.ops.sparse24 import pack_codes_fp

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("shape,n,m", [((3, 37, 147), 2, 4),
                                       ((3, 10, 64), 2, 4), ((4, 64), 2, 8),
                                       ((5, 70), 2, 8), ((4, 33), 3, 5),
                                       ((2, 8, 9), 1, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prune_kernel(gen, shape, n, m, dtype):
    w = torch.randn(shape, generator=gen, device="cuda")
    w = (torch.round(w * 2) / 2).to(dtype)  # many equal magnitudes
    got = prune_kernel.prune_nm_cuda(w, n, m)
    want = prune_kernel.prune_nm_plain(w, n, m)
    assert all(torch.equal(g, h) for g, h in zip(got, want))


@pytest.mark.parametrize("rows,k", [(1, 4), (37, 147), (130, 64),
                                    (65, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compress_kernel(gen, rows, k, dtype):
    w = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    w = prune_kernel.prune_nm_cuda(w)[0]
    got = prune_kernel.compress_24_cuda(w)
    want = prune_kernel.compress_24_plain(w)
    assert all(torch.equal(g, h) for g, h in zip(got, want))


@pytest.mark.parametrize("m,k,n", [(37, 147, 40), (136, 64, 64),
                                   (304, 1000, 136)])
@pytest.mark.parametrize("dtype,bdtype,odtype", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float32, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32),
])
@pytest.mark.parametrize("tout,packed", [(False, False), (True, True)])
def test_spmm24_kernel(gen, m, k, n, dtype, bdtype, odtype, tout, packed):
    w = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    v0, v1, codes = prune_kernel.compress_24_cuda(
        prune_kernel.prune_nm_cuda(w)[0])
    b = torch.randn((k, n), generator=gen, device="cuda").to(bdtype)
    c = torch.randn((n, m) if tout else (m, n), generator=gen,
                    device="cuda")
    kw = dict(k_logical=k, out_dtype=odtype, alpha=0.75, beta=-0.5, c=c,
              transpose_out=tout, packed_codes=packed)
    cc = pack_codes_fp(codes) if packed else codes
    got = spmm24_kernel.spmm24_cuda(v0, v1, cc, b, **kw)
    want = spmm24_kernel.spmm24_plain(v0, v1, cc, b, **kw)
    tol = TOL[torch.promote_types(dtype, bdtype)]
    assert _rel(got, want) < max(tol, TOL[odtype])


@pytest.mark.parametrize("bs,bk", [(16, 16), (48, 32), (64, 64),
                                   (128, 128), (256, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tout", [False, True])
def test_ell_kernel(gen, bs, bk, dtype, tout):
    mb, kblocks, ell, n = 3, 6, 3, 136
    vals = torch.randn((mb * bs, ell * bk), generator=gen,
                       device="cuda").to(dtype)
    cols = torch.stack([torch.randperm(kblocks, device="cuda")[:ell].sort()
                        .values for _ in range(mb)]).to(torch.int32)
    kb = kblocks * bk - 5  # rows past kb read as zero
    b = torch.randn((kb, n), generator=gen, device="cuda").to(dtype)
    kw = dict(block_size=bs, block_k=bk, out_dtype=dtype, transpose_out=tout)
    got = ell_kernel.ell_spmm_cuda(vals, cols, b, **kw)
    want = ell_kernel.ell_spmm_plain(vals, cols, b, **kw)
    assert _rel(got, want) < TOL[dtype]


def test_kernels_reject_what_they_do_not_tile(gen):
    v = torch.zeros((40, 64), device="cuda")
    cols = torch.zeros((5, 2), dtype=torch.int32, device="cuda")
    b = torch.zeros((64, 8), device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        ell_kernel.ell_spmm_cuda(v, cols, b, block_size=8, block_k=32,
                                 out_dtype=torch.float32)
    with pytest.raises(ValueError, match="block_k"):
        ell_kernel.ell_spmm_cuda(v, cols, b, block_size=16, block_k=24,
                                 out_dtype=torch.float32)
    with pytest.raises(TypeError):
        prune_kernel.prune_nm_cuda(torch.zeros(4, 8, device="cuda",
                                               dtype=torch.float16))


@pytest.mark.parametrize("rows,k,fold", [(37, 147, 1), (130, 64, 1),
                                         (38, 147, 2), (256, 576, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prune_compress_route(gen, rows, k, fold, dtype):
    """The fused route on dense (unpruned) input, with magnitude ties,
    through prune_compress_24: exactly the plain version, and exactly
    K2 on the pruned input."""
    from sparsifyme_tpu_torch.ops.sparse24 import prune_compress_24

    w = torch.randn((rows, k), generator=gen, device="cuda")
    w = (torch.round(w * 2) / 2).to(dtype)
    n0 = prune_kernel.prune_compress_24_cuda.launches
    got = prune_compress_24(w, fold=fold)
    assert prune_kernel.prune_compress_24_cuda.launches == n0 + 1
    want = prune_compress_24(w.cpu(), fold=fold)
    for g, h in zip((got.values0, got.values1, got.codes),
                    (want.values0, want.values1, want.codes)):
        assert torch.equal(g.cpu(), h)
    if fold == 1:
        pw = prune_kernel.prune_nm_cuda(w)[0]
        assert all(torch.equal(g, h) for g, h in zip(
            (got.values0, got.values1, got.codes),
            prune_kernel.compress_24_cuda(pw)))


@pytest.mark.parametrize("m,k,n", [(38, 147, 40), (136, 64, 64),
                                   (304, 1000, 136), (4000, 256, 128)])
@pytest.mark.parametrize("dtype,odtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("epi", [False, True])
def test_spmm24_fold_kernel(gen, m, k, n, dtype, odtype, epi):
    from sparsifyme_tpu_torch.ops.sparse24 import prune_compress_24

    w = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    s = prune_compress_24(w, fold=2)
    b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    kw = dict(k_logical=k, out_dtype=odtype)
    if epi:
        kw.update(alpha=0.75, beta=-0.5, c=torch.randn(
            (m, n), generator=gen, device="cuda"))
    n0 = spmm24_kernel.spmm24_fold_cuda.launches
    got = spmm24_kernel.spmm24_fold_cuda(s.values0, s.values1, s.codes, b,
                                         **kw)
    assert spmm24_kernel.spmm24_fold_cuda.launches == n0 + 1
    want = spmm24_kernel.spmm24_fold_plain(s.values0, s.values1, s.codes, b,
                                           **kw)
    assert tuple(got.shape) == (m, n)
    assert _rel(got, want) < max(TOL[dtype], TOL[odtype])
    u = prune_kernel.compress_24_cuda(prune_kernel.prune_nm_cuda(w)[0])
    flat = spmm24_kernel.spmm24_cuda(*u, b, **kw)
    assert _rel(got, flat) < max(TOL[dtype], TOL[odtype])


def test_spmm24_fold_kernel_refuses_what_jax_refuses(gen):
    z = torch.zeros((2 * 272, 8), device="cuda")
    c = torch.zeros((2 * 272, 8), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="single k-step"):
        spmm24_kernel.spmm24_fold_cuda(z, z, c, torch.zeros(
            (1088, 8), device="cuda"), k_logical=1088,
            out_dtype=torch.float32)
    with pytest.raises(ValueError, match="even row count"):
        spmm24_kernel.spmm24_fold_cuda(z[:31], z[:31], c[:31], torch.zeros(
            (64, 8), device="cuda"), k_logical=64, out_dtype=torch.float32)


@pytest.mark.parametrize("bs,bk", [(16, 16), (48, 32), (64, 64),
                                   (128, 128), (256, 32), (128, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tout", [False, True])
@pytest.mark.parametrize("n", [40, 136])
def test_ell_expand_kernel(gen, bs, bk, dtype, tout, n):
    """K5 against its plain version, with a repeated column (last slot
    wins) and an out-of-range column in one block-row."""
    mb, kblocks, ell = 3, 6, 3
    vals = torch.randn((ell * bk, mb * bs), generator=gen,
                       device="cuda").to(dtype)
    cols = torch.stack([torch.randperm(kblocks, device="cuda")[:ell].sort()
                        .values for _ in range(mb)]).to(torch.int32)
    cols[1] = torch.tensor([2, 4, 2], dtype=torch.int32)
    cols[2, 2] = kblocks + 3
    kb = kblocks * bk - 5  # rows past kb read as zero
    b = torch.randn((kb, n), generator=gen, device="cuda").to(dtype)
    kw = dict(block_size=bs, block_k=bk, out_dtype=dtype, transpose_out=tout)
    n0 = ell_kernel.ell_expand_spmm_cuda.launches
    got = ell_kernel.ell_expand_spmm_cuda(vals, cols, b, **kw)
    assert ell_kernel.ell_expand_spmm_cuda.launches == n0 + 1
    want = ell_kernel.ell_expand_spmm_plain(vals, cols, b, **kw)
    assert tuple(got.shape) == ((n, mb * bs) if tout else (mb * bs, n))
    assert _rel(got, want) < TOL[dtype]


def test_ell_expand_matches_gather_without_repeats(gen):
    """On ell_from_dense operands (distinct columns) the two formulations
    compute the same product."""
    from sparsifyme_tpu_torch.ops.ell import (ell_from_dense,
                                              spmm_ell, spmm_ell_expand)

    a = torch.randn((2, 256, 192), generator=gen, device="cuda").to(
        torch.bfloat16)
    b = torch.randn((192, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    e = ell_from_dense(a, 128, 3, 32)
    assert _rel(spmm_ell_expand(e, b), spmm_ell(e, b)) < TOL[torch.bfloat16]


def _coo_operand(gen, m, k, density, vdtype):
    w = torch.randn((m, k), generator=gen, device="cuda")
    keep = torch.rand((m, k), generator=gen, device="cuda") < density
    from sparsifyme_tpu_torch.ops.coo import coo_from_dense

    return coo_from_dense((w * keep).to(vdtype))


@pytest.mark.parametrize("m,k,n,batch,bm", [(200, 130, 40, 3, 128),
                                            (37, 64, 37, 5, 16),
                                            (300, 1000, 136, 2, 48),
                                            (128, 96, 128, 4, 128)])
@pytest.mark.parametrize("vdtype,bdtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("density", [0.5, 0.05])
def test_coo_spmm_kernel(gen, m, k, n, batch, bm, vdtype, bdtype, density):
    """K6 against its plain version: f32 sums in another order."""
    from sparsifyme_tpu_torch.ops.coo import pack_coo
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel

    a = _coo_operand(gen, m, k, density, vdtype)
    packed = pack_coo(a, bm)
    b = torch.randn((batch, k, n), generator=gen, device="cuda").to(bdtype)
    n0 = coo_kernel.spmm_coo_cuda.launches
    got = coo_kernel.spmm_coo_cuda(*packed, b, m=m, block_rows=bm)
    torch.cuda.synchronize()
    assert coo_kernel.spmm_coo_cuda.launches == n0 + 1
    want = coo_kernel.spmm_coo_plain(*packed, b, m=m, block_rows=bm)
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch, m, n)
    assert _rel(got, want) < TOL[torch.float32]


@pytest.mark.parametrize("bdtype", [torch.float32, torch.bfloat16])
def test_coo_spmm_kernel_sums_duplicates_exactly(gen, bdtype):
    from sparsifyme_tpu_torch.containers import Coo
    from sparsifyme_tpu_torch.ops.coo import spmm_coo_segmented

    i32 = dict(dtype=torch.int32, device="cuda")
    a = Coo(rows=torch.tensor([0, 0, 5, 5], **i32),
            cols=torch.tensor([1, 1, 2, 2], **i32),
            values=torch.tensor([1.0, 2.0, 3.0, 4.0], device="cuda"),
            shape=(8, 8))
    b = torch.eye(8, device="cuda").to(bdtype)
    got = spmm_coo_segmented(a, b, out_dtype=torch.float32).cpu()
    assert got[0, 1] == 3.0 and got[5, 2] == 7.0 and got.sum() == 10.0


def test_coo_spmm_kernel_drops_out_of_range_entries(gen):
    """Entries past k or past the block-row add nothing, on both sides;
    rows past m are not written."""
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel

    mb, e, bm, m, k = 2, 16, 16, 20, 8
    vals = torch.randn((mb, e), generator=gen, device="cuda")
    cols = torch.randint(1, k, (mb, e), generator=gen, device="cuda",
                         dtype=torch.int32)
    roff = torch.randint(0, bm, (mb, e), generator=gen, device="cuda",
                         dtype=torch.int32)
    cols[0, 3], cols[1, 5], roff[0, 7], roff[1, 2] = k, -1, bm, -2
    b = torch.randn((3, k, 24), generator=gen, device="cuda")
    b[:, 0] = float("inf")  # only a dropped entry could reach row 0
    got = coo_kernel.spmm_coo_cuda(vals, cols, roff, b, m=m, block_rows=bm)
    want = coo_kernel.spmm_coo_plain(vals, cols, roff, b, m=m, block_rows=bm)
    assert torch.isfinite(got).all()
    assert _rel(got, want) < TOL[torch.float32]


def test_coo_spmm_kernel_rejects_what_it_does_not_take(gen):
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel

    v = torch.zeros((1, 12), device="cuda")
    c = torch.zeros((1, 12), dtype=torch.int32, device="cuda")
    b = torch.zeros((1, 8, 8), device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        coo_kernel.spmm_coo_cuda(v, c, c, b, m=8, block_rows=16)
    with pytest.raises(ValueError, match="block_rows"):
        coo_kernel.spmm_coo_cuda(v[:, :8], c[:, :8], c[:, :8], b, m=8,
                                 block_rows=512)
    with pytest.raises(TypeError):
        coo_kernel.spmm_coo_cuda(v[:, :8].half(), c[:, :8], c[:, :8], b,
                                 m=8, block_rows=16)


def test_coo_path_on_the_card_matches_the_cpu(gen):
    """Packing on the card gives the CPU's planes bit for bit; the oracle,
    K6 and the ELL conversion agree with the same ops on the CPU."""
    from sparsifyme_tpu_torch.ops.coo import (coo_to_ell, pack_coo, spmm_coo,
                                              spmm_coo_segmented)
    from sparsifyme_tpu_torch.ops.ell import spmm_ell

    a = _coo_operand(gen, 256, 160, 0.1, torch.float32)
    ac = type(a)(a.rows.cpu(), a.cols.cpu(), a.values.cpu(), a.shape)
    for g, h in zip(pack_coo(a), pack_coo(ac)):
        assert torch.equal(g.cpu(), h)
    b = torch.randn((2, 160, 64), generator=gen, device="cuda")
    for fn in (spmm_coo, spmm_coo_segmented):
        assert _rel(fn(a, b).cpu(), fn(ac, b.cpu())) < TOL[torch.float32]
    e, ec = coo_to_ell(a, 32), coo_to_ell(ac, 32)
    assert torch.equal(e.col_indices.cpu(), ec.col_indices)
    assert _rel(spmm_ell(e, b[0]).cpu(), spmm_ell(ec, b[0].cpu())) < \
        TOL[torch.float32]


def _ring_operand(gen, rows, k, n, dtype):
    from sparsifyme_tpu_torch.ops.sparse24 import compress_24

    w = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    s = compress_24(prune_kernel.prune_nm_cuda(w)[0])
    b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    return s, b


@pytest.mark.parametrize("rows,p,r,k,n,c0,mt", [
    (400, 4, 1, 256, 40, 0, 100),     # ragged: simple tile
    (400, 4, 3, 256, 40, 36, 50),     # ragged window columns
    (1024, 4, 2, 512, 128, 0, 256),   # bf16 fast path, whole shard
    (1024, 2, 1, 256, 64, 128, 256),  # fast path, an m-tile
])
@pytest.mark.parametrize("dtype,odtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("first,last", [(True, False), (False, False),
                                        (False, True), (True, True)])
def test_ring_step_kernel(gen, rows, p, r, k, n, c0, mt, dtype, odtype,
                          first, last):
    """K7 on a window of the full planes (row stride = all rows) against
    its plain version: the accumulator on middle steps, C on the last."""
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    s, _ = _ring_operand(gen, rows, k, n, dtype)
    mloc, k4s = rows // p, s.values0.shape[0] // p
    planes = [x[:, r * mloc:(r + 1) * mloc]
              for x in (s.values0, s.values1, s.codes)]
    slot = torch.randn((4 * k4s, n), generator=gen, device="cuda").to(dtype)
    acc0 = torch.randn((mloc, n), generator=gen, device="cuda")
    src = (r + 1) % p
    outs = []
    for fn in (rk.ring_step_cuda, rk.ring_step_plain):
        acc = acc0.clone()
        out = torch.zeros((mloc, n), dtype=odtype, device="cuda")
        fn(*planes, slot, acc, out, src=src, c0=c0, mt=mt, first=first,
           last=last)
        outs.append((acc, out))
    (acc, out), (acc_p, out_p) = outs
    tol = max(TOL[dtype], TOL[odtype])
    if last:
        assert torch.equal(acc, acc0)
        assert _rel(out, out_p) < tol
        assert not out[:c0].any() and not out[c0 + mt:].any()
    else:
        assert _rel(acc, acc_p) < tol
        assert torch.equal(acc[:c0], acc0[:c0])
        assert not out.any()


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tiled", [False, True])
def test_rings_on_one_card(gen, p, dtype, tiled):
    """Both K7 routes with P logical ranks on one card against single-card
    spmm_24 (K3), batched A folded into rows, bf16 and f32 C."""
    import sparsifyme_tpu_torch as sp
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    batch, m, k, n = 2, 64 * p, 64 * p, 48
    s, b = _ring_operand(gen, batch * m, k, n, dtype)
    s = type(s)(s.values0, s.values1, s.codes, shape=(batch, m, k))
    mesh = sp.make_mesh((p,), ("model",), devices=["cuda:0"] * p)
    want = sp.spmm_24(s, b, out_dtype=torch.float32)
    counter = rk.ring_step_tiled_cuda if tiled else rk.ring_step_cuda
    n0 = counter.launches
    fn = sp.spmm_24_ring_tiled if tiled else sp.spmm_24_ring_explicit
    kw = dict(m_tile=32) if tiled else {}
    for odt in (dtype, torch.float32):
        got = fn(s, b, mesh, "model", out_dtype=odt, **kw)
        assert got.dtype == odt and tuple(got.shape) == (batch, m, n)
        assert _rel(got.float(), want) < TOL[dtype]
    n_mt = batch * m // p // 32 if tiled else 1
    assert counter.launches == n0 + 2 * p * p * n_mt
    oracle = sp.spmm_24_ring(s, b, mesh, "model", out_dtype=torch.float32)
    assert _rel(oracle, want) < TOL[dtype]


@pytest.mark.parametrize("tiled,p,t", [(False, 4, 1), (False, 3, 0),
                                       (True, 4, 3), (True, 3, 1),
                                       (True, 2, 1)])
def test_ring_credit_protocol(gen, monkeypatch, tiled, p, t):
    """A long sleep on rank 1's compute stream before its step t (the last
    read of a slot before the left neighbour's next send into it, within a
    tile or across tiles): without the capacity credit that send would
    overwrite the slot before the delayed contraction reads it."""
    import sparsifyme_tpu_torch as sp
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    name = "ring_step_tiled_cuda" if tiled else "ring_step_cuda"
    real = getattr(rk, name)
    calls = []

    def delayed(*a, **kw):
        if len(calls) == t * p + 1:  # queued step-major: rank 1, step t
            torch.cuda._sleep(200_000_000)
        calls.append(1)
        real(*a, **kw)

    delayed.launches = real.launches  # the wrapper counts under its name
    monkeypatch.setattr(rk, name, delayed)
    s, b = _ring_operand(gen, 256 * p, 128 * p, 64, torch.bfloat16)
    mesh = sp.make_mesh((p,), ("model",), devices=["cuda:0"] * p)
    fn = sp.spmm_24_ring_tiled if tiled else sp.spmm_24_ring_explicit
    got = fn(s, b, mesh, "model", out_dtype=torch.float32,
             **(dict(m_tile=128) if tiled else {}))
    want = sp.spmm_24(s, b, out_dtype=torch.float32)
    assert len(calls) == p * p * (2 if tiled else 1)
    assert _rel(got.cpu(), want.cpu()) < TOL[torch.bfloat16]


@pytest.mark.parametrize("p", [2, 4])
def test_sharded_spmms_on_one_card(gen, p):
    import sparsifyme_tpu_torch as sp

    batch, m, k, n = 8, 32, 128, 40
    s, b = _ring_operand(gen, batch * m, k, n, torch.bfloat16)
    s = type(s)(s.values0, s.values1, s.codes, shape=(batch, m, k))
    want = sp.spmm_24(s, b)
    mesh = sp.make_mesh((1, p), ("data", "model"), devices=["cuda:0"] * p)
    mesh_d = sp.make_mesh((p, 1), ("data", "model"), devices=["cuda:0"] * p)
    got = sp.spmm_24_batch_sharded(s, b, mesh_d, axis="data")
    assert _rel(got, want) < TOL[torch.bfloat16]
    got = sp.spmm_24_row_sharded(s, b, mesh, axis="model")
    assert _rel(got, want) < TOL[torch.bfloat16]
    got = sp.spmm_24_ring(s, b, mesh, axis="model")
    assert _rel(got, want) < TOL[torch.bfloat16]


def test_rings_across_cards(gen):
    """Ranks round-robin over every card (peer copies between them)."""
    import sparsifyme_tpu_torch as sp

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    p = 4
    s, b = _ring_operand(gen, 512, 512, 64, torch.bfloat16)
    mesh = sp.make_mesh((p,), ("model",),
                        devices=[f"cuda:{r % cards}" for r in range(p)])
    want = sp.spmm_24(s, b, out_dtype=torch.float32)
    for fn in (sp.spmm_24_ring, sp.spmm_24_ring_explicit,
               sp.spmm_24_ring_tiled):
        got = fn(s, b, mesh, "model", out_dtype=torch.float32)
        assert got.device == want.device
        assert _rel(got, want) < TOL[torch.bfloat16]


def test_ring_kernel_rejects_what_it_does_not_take(gen):
    import sparsifyme_tpu_torch as sp
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    z = torch.zeros((16, 64), dtype=torch.float16, device="cuda")
    c = torch.zeros((16, 64), dtype=torch.uint8, device="cuda")
    slot = torch.zeros((16, 8), dtype=torch.float16, device="cuda")
    acc = torch.zeros((64, 8), device="cuda")
    with pytest.raises(TypeError):
        rk.ring_step_cuda(z, z, c, slot, acc, acc, src=0, c0=0, mt=64,
                          first=True, last=False)
    f = z.float()
    with pytest.raises(ValueError, match="outside"):
        rk.ring_step_cuda(f, f, c, slot.float(), acc, acc, src=4, c0=0,
                          mt=64, first=True, last=False)
    with pytest.raises(ValueError, match="acc"):
        rk.ring_step_cuda(f, f, c, slot.float(), None, acc, src=0, c0=0,
                          mt=64, first=True, last=False)
    s, b = _ring_operand(gen, 128, 128, 8, torch.float32)
    s = type(s)(s.values0.half(), s.values1.half(), s.codes, shape=s.shape)
    mesh = sp.make_mesh((2,), ("model",), devices=["cuda:0"] * 2)
    with pytest.raises(TypeError):
        sp.spmm_24_ring_explicit(s, b.half(), mesh, "model")
