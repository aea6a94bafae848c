"""The Hopper kernels and routes against their plain versions on the card,
at small and ragged shapes the ResNet-50 sweep does not reach (group sizes
other than 4, n not a multiple of 64, M not a multiple of the tile, every
ELL tile geometry, mixed input types), through both the bf16 fast paths
(M and n multiples of 8) and the simple kernels: K1 prune, K2 compress and
its fused prune+compress route, K3 2:4 SpMM and its fold=2 route (the
sparse tensor-core tile at every tile size and at the six bench shapes,
and a sparse HMMA in the built libraries), K4 ELL gather SpMM, K5 ELL
expand SpMM, K6 segmented COO SpMM (ragged m, N not a multiple of its
128-column tile, every value and B type, duplicate and out-of-range
entries, every route and split count forced, bitwise repeatable, and on
two cards where there are two) and K7, the ring step, with both rings on
logical ranks of one
card (P = 1, 2, 3, 4, 8), the sharded SpMMs, the rings' capacity credits
under a delayed rank, and the rings' CUDA graphs (replay bitwise the eager
ring, operands read at replay time, launch counts, no capture across
cards); the model layer: both conv layers at a ragged shape, the ELL
layer's gradient, three dp x tp train steps and the entry points on the
card against the CPU; and the MoE transformer's combine and RMSNorm
kernels against their plain versions.

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


NM = [(2, 4), (1, 4), (3, 4), (0, 4), (4, 4), (2, 8), (3, 5), (7, 32)]
PRUNE_KS = [1, 2, 3, 4, 5, 7, 9, 31, 32, 63, 64, 100, 147, 255, 576, 999,
            1000, 4608, 5000]


def _same_prune(w, n, m):
    """K1 on the card against the plain version on the CPU, bit for bit
    (any NaN matching any NaN)."""
    got = prune_kernel.prune_nm_cuda(w, n, m)
    want = prune_kernel.prune_nm_plain(w.cpu(), n, m)
    torch.cuda.synchronize()
    return all(prune_kernel.same_bits(g.cpu(), h)
               for g, h in zip(got, want))


@pytest.mark.parametrize("n,m", NM)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prune_kernel(gen, n, m, dtype):
    """Both routes (the stream of 16-byte chunks where k % m == 0 and m =
    4 or 8; tiles of whole rows or row pieces) at k from 1 to 5000, 3-D
    input and ragged row counts, with many equal magnitudes."""
    for k in PRUNE_KS:
        for shape in ((3, 5, k), (37, k)):
            w = torch.randn(shape, generator=gen, device="cuda")
            w = (torch.round(w * 2) / 2).to(dtype)
            assert _same_prune(w, n, m), (shape, n, m)


@pytest.mark.parametrize("rows,k,m", [(100000, 147, 4), (3000, 5000, 5),
                                      (2000, 5000, 32), (10000, 1101, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prune_kernel_tiles(gen, rows, k, m, dtype):
    """Over a thousand tiles in each tile mode: whole rows (k = 147; k =
    5000 in bf16) and column pieces (k = 5000 in f32; odd k = 1101, too
    deep for a span of 8 or 4 rows, element-wide copies)."""
    plan = prune_kernel.prune_plan(rows, k, m, dtype.itemsize)
    assert plan.units > 1000
    w = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    assert _same_prune(w, 2, m)


@pytest.mark.parametrize("n,m", NM)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prune_kernel_special_values(gen, n, m, dtype):
    """NaN, +-Inf, +-0 and all-equal groups rank and prune as the plain
    version does: a NaN neither outranks nor is outranked, a dropped
    member is x * 0 (a zero of x's sign; NaN for an infinite x)."""
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0,
                            -0.0, 1.0, -1.0, 2.0], device="cuda")
    for k in (8, 147, 576):
        idx = torch.randint(0, len(special), (64, k), generator=gen,
                            device="cuda")
        w = special[idx]
        w[:8] = -1.5  # all-equal groups
        w[8:16] = -0.0
        assert _same_prune(w.to(dtype), n, m), (k, n, m)


@pytest.mark.parametrize("k,m", [(147, 4), (576, 4), (1000, 8), (99, 5),
                                 (5000, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prune_kernel_at_an_odd_offset(gen, k, m, dtype):
    """A contiguous view one element into a larger buffer (not 16-byte
    aligned): the same kernel with scalar copies, bit for bit."""
    rows = 300
    buf = torch.randn(rows * k + 1, generator=gen,
                      device="cuda").to(dtype)
    w = buf[1:].view(rows, k)
    assert w.is_contiguous() and w.data_ptr() % 16 != 0
    assert _same_prune(w, 2, m)


def test_prune_kernel_on_two_cards(gen):
    """K1 switches to its tensor's card in C and opts into its shared
    memory per card: the same call on cuda:0, then cuda:1, bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    w = torch.randn((3001, 147), generator=gen,
                    device="cuda").to(torch.bfloat16)
    for dev in ("cuda:0", "cuda:1"):
        x = w.to(dev)
        got = prune_kernel.prune_nm_cuda(x)
        torch.cuda.synchronize(dev)
        assert all(g.device == torch.device(dev) for g in got)
        assert all(prune_kernel.same_bits(g, h) for g, h in
                   zip(got, prune_kernel.prune_nm_plain(x)))


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


BENCH_SHAPES = [(12544, 64, 147), (12544, 64, 576), (12544, 256, 64),
                (3136, 128, 1152), (784, 256, 1024), (196, 512, 4608)]
SP_CASES = [dict(), dict(transpose_out=True, packed_codes=True),
            dict(alpha=0.75, beta=-0.5, c=True),
            dict(out_dtype=torch.float32, transpose_out=True)]


def _sp_check(gen, m, k, n, case, fold=1, batch=1):
    """K3's bf16 fast path (the sparse tile) against its plain version."""
    from sparsifyme_tpu_torch.ops.sparse24 import prune_compress_24

    w = torch.randn((batch * m, k), generator=gen,
                    device="cuda").to(torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    s = prune_compress_24(w, fold=fold)
    kw = dict(k_logical=k, out_dtype=torch.bfloat16)
    kw.update({key: v for key, v in case.items() if key != "c"})
    if case.get("c"):
        kw["c"] = torch.randn((batch * m, n), generator=gen, device="cuda")
    codes = pack_codes_fp(s.codes) if kw.get("packed_codes") else s.codes
    if fold == 2:
        got = spmm24_kernel.spmm24_fold_cuda(s.values0, s.values1, codes, b,
                                             **kw)
        want = spmm24_kernel.spmm24_fold_plain(s.values0, s.values1, codes,
                                               b, **kw)
    else:
        got = spmm24_kernel.spmm24_cuda(s.values0, s.values1, codes, b, **kw)
        want = spmm24_kernel.spmm24_plain(s.values0, s.values1, codes, b,
                                          **kw)
    assert got.dtype == kw["out_dtype"] and got.shape == want.shape
    assert _rel(got, want) < TOL[torch.bfloat16]


@pytest.mark.parametrize("m,n,k", BENCH_SHAPES)
@pytest.mark.parametrize("case", range(len(SP_CASES)))
def test_spmm24_sparse_tile_at_bench_shapes(gen, m, n, k, case):
    """At the six bench shapes (b=4 folded into rows)."""
    _sp_check(gen, m, k, n, SP_CASES[case], batch=4)


@pytest.mark.parametrize("m,n,k", [(m, n, k) for m, n, k in BENCH_SHAPES
                                   if k <= 1024])
@pytest.mark.parametrize("epi", [False, True])
def test_spmm24_sparse_tile_fold2(gen, m, n, k, epi):
    _sp_check(gen, m, k, n, SP_CASES[2] if epi else {}, fold=2, batch=4)


@pytest.mark.parametrize("tile", range(len(spmm24_kernel.SP_TILES)))
@pytest.mark.parametrize("m,n,k", [(208, 72, 100), (40, 8, 1000),
                                   (1040, 264, 147), (48, 136, 64)])
@pytest.mark.parametrize("case", range(len(SP_CASES)))
def test_spmm24_sparse_tile_ragged(gen, monkeypatch, tile, m, n, k, case):
    """Every tile size at ragged M, N and K (k not a multiple of 64, M and
    N not multiples of the tile), fold 1 and 2."""
    monkeypatch.setattr(spmm24_kernel, "card_tile", lambda *a, **kw: tile)
    _sp_check(gen, m, k, n, SP_CASES[case])
    if case in (0, 2):
        _sp_check(gen, m, k, n, SP_CASES[case], fold=2)


def test_sparse_kernels_run_on_the_sparse_tensor_cores(gen):
    """The built K3 and K7 libraries hold a sparse HMMA (its SASS opcode
    carries SP): cuobjdump --dump-sass lib{spmm24,ring24}.so."""
    import pathlib
    import subprocess

    from sparsifyme_tpu_torch import _build

    _build.build_all()
    tool = pathlib.Path(_build.find_nvcc()).parent / "cuobjdump"
    for name in ("spmm24", "ring24"):
        sass = subprocess.run(
            [str(tool), "--dump-sass", str(_build.build_dir() /
                                           f"lib{name}.so")],
            check=True, capture_output=True, text=True).stdout
        ops = [ln.split()[1] for ln in sass.splitlines()
               if "HMMA" in ln and len(ln.split()) > 1]
        assert any(op.startswith("HMMA.SP") for op in ops), (name, ops[:5])


@pytest.mark.parametrize("name", ["spmm24", "ring24_wg", "sp24_wg_units"])
def test_wgmma_sp_metadata_registers_outlive_their_groups(gen, name):
    """No kernel of K3's wgmma_sp route (kFull), K7's wgmma_sp step (kRing)
    or the units probe writes an HGMMA.SP's metadata register on any path
    before a WARPGROUP.DEPBAR has retired its group (``utils.sass``)."""
    from sparsifyme_tpu_torch import _build
    from sparsifyme_tpu_torch.utils import sass

    _build.build_all()
    found = sass.library_hazards(_build.build_dir() / f"lib{name}.so")
    assert found, f"lib{name}.so issues no HGMMA.SP"
    if name == "spmm24":  # the 256-row unit's kernels among them
        assert sum("wgsp256_kernel" in fn for fn in found) == 2, list(found)
    bad = {fn: [(hex(w), f"R{r}", hex(h)) for w, r, h in hz][:4]
           for fn, hz in found.items() if hz}
    assert not bad, bad


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
    # a layout describes the planes it was built from, as they were
    planes = (v[:, :8].contiguous(), c[:, :8].contiguous(),
              c[:, :8].contiguous())
    lay = coo_kernel.coo_layout(*planes, k=8, block_rows=16)
    coo_kernel.spmm_coo_cuda(*planes, b, m=8, block_rows=16, layout=lay)
    with pytest.raises(ValueError, match="other planes"):
        coo_kernel.spmm_coo_cuda(planes[0].clone(), *planes[1:], b, m=8,
                                 block_rows=16, layout=lay)
    planes[0].add_(1)
    with pytest.raises(ValueError, match="other planes"):
        coo_kernel.spmm_coo_cuda(*planes, b, m=8, block_rows=16, layout=lay)


def _coo_plans(layout, mb, bm, k, cols, routes=("staged", "gather"),
               splits=(1, 2, 3)):
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel

    out = []
    for route in routes:
        for s in splits:
            plan = coo_kernel.coo_plan(mb, bm, k, layout.kc, layout.nnz, cols,
                                       routes=(route,), split_counts=(s,),
                                       peak=layout.peak)
            if plan is not None:
                out.append(plan)
    return out


@pytest.mark.parametrize("m,k,n,batch,bm,density", [
    (200, 130, 40, 3, 128, 0.3),     # ragged m, n % 8 != 0 (scalar paths)
    (300, 1000, 136, 2, 48, 0.1),    # bm 48, N not a multiple of 128
    (520, 300, 64, 3, 256, 0.05),    # two row groups a block-row
    (136, 96, 128, 4, 128, 0.6)])    # chunks longer than a window
@pytest.mark.parametrize("bdtype", [torch.float32, torch.bfloat16])
def test_coo_spmm_kernel_under_every_plan(gen, monkeypatch, m, k, n, batch,
                                          bm, density, bdtype):
    """K6 on its layout, each route and split count forced, against the
    plain version; each plan's result bitwise the same on a second call."""
    from sparsifyme_tpu_torch.ops.coo import pack_coo
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel

    a = _coo_operand(gen, m, k, density, torch.float32)
    packed = pack_coo(a, bm)
    kc = 64 if density > 0.5 else None  # several windows a chunk at 0.6
    lay = coo_kernel.coo_layout(*packed, k=k, block_rows=bm, kc=kc)
    b = torch.randn((batch, k, n), generator=gen, device="cuda").to(bdtype)
    want = coo_kernel.spmm_coo_plain(*packed, b, m=m, block_rows=bm)
    plans = _coo_plans(lay, packed[0].shape[0], bm, k, batch * n)
    assert {p.route for p in plans} == {"staged", "gather"}
    for plan in plans:
        monkeypatch.setattr(coo_kernel, "card_plan", lambda *a_, p=plan: p)
        got = coo_kernel.spmm_coo_cuda(*packed, b, m=m, block_rows=bm,
                                       layout=lay)
        again = coo_kernel.spmm_coo_cuda(*packed, b, m=m, block_rows=bm,
                                         layout=lay)
        assert _rel(got, want) < TOL[torch.float32], plan
        assert torch.equal(got, again), plan


@pytest.mark.parametrize("batch,m,n", [(1, 37, 37), (3, 37, 13)])
@pytest.mark.parametrize("route", ["staged", "gather"])
def test_coo_spmm_kernel_splits_where_batch_m_n_is_odd(gen, monkeypatch,
                                                       batch, m, n, route):
    """Deep k cut in 63 chunks, split 2 to 8 ways, where batch * m * n is
    odd: each partial plane but the first starts off a 16-byte boundary,
    and the second pass must still sum them."""
    from sparsifyme_tpu_torch.ops.coo import pack_coo
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel

    k = 1000
    packed = pack_coo(_coo_operand(gen, m, k, 0.1, torch.float32))
    lay = coo_kernel.coo_layout(*packed, k=k, kc=16)
    b = torch.randn((batch, k, n), generator=gen, device="cuda")
    want = coo_kernel.spmm_coo_plain(*packed, b, m=m)
    plans = _coo_plans(lay, 1, 128, k, batch * n, routes=(route,),
                       splits=range(2, coo_kernel.MAX_SPLITS + 1))
    assert [p.splits for p in plans] == list(range(2, 9))
    for plan in plans:
        monkeypatch.setattr(coo_kernel, "card_plan", lambda *a_, p=plan: p)
        got = coo_kernel.spmm_coo_cuda(*packed, b, m=m, layout=lay)
        assert _rel(got, want) < TOL[torch.float32], plan
        assert torch.equal(got, coo_kernel.spmm_coo_cuda(
            *packed, b, m=m, layout=lay)), plan


@pytest.mark.parametrize("route,sparsity,splits", [
    ("staged", 0.5, 4),     # the split route at a 196-row shape
    ("gather", 0.995, 1),   # the direct-gather route where it is picked
    ("gather", 0.995, 3)])
def test_coo_spmm_kernel_routes_at_resnet_widths(gen, monkeypatch, route,
                                                  sparsity, splits):
    """196x512x4608 (b=2): the split route, and the gather route at 0.995,
    against the plain version; the plan picks gather at 0.995."""
    from sparsifyme_tpu_torch.ops.coo import coo_from_dense, pack_coo
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel
    from sparsifyme_tpu_torch.ops.prune import prune_threshold

    m, n, k, batch = 196, 512, 4608, 2
    w = torch.randn((m, k), generator=gen, device="cuda")
    thr = float(torch.quantile(w.abs().flatten(), sparsity))
    packed = pack_coo(coo_from_dense(prune_threshold(w, thr)[0]))
    lay = coo_kernel.coo_layout(*packed, k=k)
    if sparsity == 0.995:
        assert coo_kernel.card_plan(w.get_device(), 2, 128, k, lay.kc, lay.nnz,
                                    batch * n, lay.peak).route == "gather"
    plan = coo_kernel.coo_plan(2, 128, k, lay.kc, lay.nnz, batch * n,
                               routes=(route,), split_counts=(splits,),
                               peak=lay.peak)
    monkeypatch.setattr(coo_kernel, "card_plan", lambda *a_: plan)
    b = torch.randn((batch, k, n), generator=gen,
                    device="cuda").to(torch.bfloat16)
    got = coo_kernel.spmm_coo_cuda(*packed, b, m=m, layout=lay)
    want = coo_kernel.spmm_coo_plain(*packed, b, m=m)
    assert _rel(got, want) < TOL[torch.float32]
    assert torch.equal(got, coo_kernel.spmm_coo_cuda(*packed, b, m=m,
                                                     layout=lay))


def test_coo_spmm_kernel_on_two_cards(gen):
    """K6 needs more than 48 KB of shared memory, which a kernel is opted
    into per card: the same call on cuda:0, then cuda:1, each against the
    plain version (repaired fault C2)."""
    from sparsifyme_tpu_torch.ops.coo import pack_coo
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    a = _coo_operand(gen, 300, 512, 0.2, torch.float32)
    b = torch.randn((4, 512, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    for dev in ("cuda:0", "cuda:1"):
        packed = tuple(p.to(dev) for p in pack_coo(a))
        bd = b.to(dev)
        got = coo_kernel.spmm_coo_cuda(*packed, bd, m=300)
        torch.cuda.synchronize(dev)
        assert got.device == torch.device(dev)
        assert _rel(got, coo_kernel.spmm_coo_plain(*packed, bd, m=300)) < \
            TOL[torch.float32]


def test_compress_kernel_on_two_cards(gen):
    """K2 also takes more than 48 KB of shared memory and switches to its
    tensor's card in C: the same call on cuda:0, then cuda:1, exactly
    equal to the plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    w = torch.randn((1001, 147), generator=gen,
                    device="cuda").to(torch.bfloat16)
    for dev in ("cuda:0", "cuda:1"):
        x = w.to(dev)
        got = prune_kernel.compress_24_cuda(x)
        torch.cuda.synchronize(dev)
        assert all(g.device == torch.device(dev) for g in got)
        assert all(torch.equal(g, h) for g, h in
                   zip(got, prune_kernel.compress_24_plain(x)))


@pytest.mark.parametrize("rows", [8, 299, 1001])
@pytest.mark.parametrize("k", [1, 9, 147, 200, 576, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compress_kernel_tiles(gen, rows, k, dtype):
    """K2's whole-row and k-tile paths at ragged M, and the fused route on
    the dense rows, exactly equal to the plain versions; also on an input
    that is not 16-byte aligned (scalar loads)."""
    w = torch.randn((rows, k + 1), generator=gen, device="cuda").to(dtype)
    w = (torch.round(w * 2) / 2)  # many equal magnitudes
    for x in (w[:, :k].contiguous(), w.reshape(-1)[1:rows * k + 1].view(
            rows, k)):
        for fn, plain in ((prune_kernel.compress_24_cuda,
                           prune_kernel.compress_24_plain),
                          (prune_kernel.prune_compress_24_cuda,
                           prune_kernel.prune_compress_24_plain)):
            got, want = fn(x), plain(x)
            assert all(torch.equal(g, h) for g, h in zip(got, want))


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
    overwrite the slot before the delayed contraction reads it. The first
    call runs eagerly; the second captures the ring with the sleep in it
    and replays it; the third replays that graph."""
    import sparsifyme_tpu_torch as sp
    from sparsifyme_tpu_torch.parallel import ring_graph
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    name = "ring_step_tiled_cuda" if tiled else "ring_step_cuda"
    real = getattr(rk, name)
    per_ring = p * p * (2 if tiled else 1)
    calls = []

    def delayed(*a, **kw):
        if len(calls) % per_ring == t * p + 1:  # step-major: rank 1, step t
            torch.cuda._sleep(200_000_000)
        calls.append(1)
        real(*a, **kw)

    delayed.launches = real.launches  # the wrapper counts under its name
    monkeypatch.setattr(rk, name, delayed)
    s, b = _ring_operand(gen, 256 * p, 128 * p, 64, torch.bfloat16)
    mesh = sp.make_mesh((p,), ("model",), devices=["cuda:0"] * p)
    fn = sp.spmm_24_ring_tiled if tiled else sp.spmm_24_ring_explicit
    kw = dict(m_tile=128) if tiled else {}
    want = sp.spmm_24(s, b, out_dtype=torch.float32)
    n0 = delayed.launches
    ring_graph.clear()
    for call in range(3):
        got = fn(s, b, mesh, "model", out_dtype=torch.float32, **kw)
        assert _rel(got.cpu(), want.cpu()) < TOL[torch.bfloat16]
        # eager, then the capture; a replay calls no wrapper
        assert len(calls) == min(call + 1, 2) * per_ring
        assert delayed.launches == n0 + (call + 1) * per_ring
    ring_graph.clear()


def _ring_case(gen, p=4, rows=512, k=256, n=64):
    import sparsifyme_tpu_torch as sp

    s, b = _ring_operand(gen, rows * p // 4, k, n, torch.bfloat16)
    mesh = sp.make_mesh((p,), ("model",), devices=["cuda:0"] * p)
    return s, b, mesh


@pytest.mark.parametrize("tiled", [False, True])
def test_ring_replay_is_the_eager_ring(gen, monkeypatch, tiled):
    """The first call queues the ring eagerly and captures nothing; the
    second captures and replays; the third replays without capturing:
    bitwise the eager result, within tolerance of the same ring with the
    plain step, K7's counter still rising by the graph's launches."""
    import sparsifyme_tpu_torch as sp
    from sparsifyme_tpu_torch.parallel import ring_graph
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    ring_graph.clear()
    s, b, mesh = _ring_case(gen)
    fn = sp.spmm_24_ring_tiled if tiled else sp.spmm_24_ring_explicit
    kw = dict(m_tile=64) if tiled else {}
    counter = rk.ring_step_tiled_cuda if tiled else rk.ring_step_cuda
    per_ring = 16 * (2 if tiled else 1)
    n0 = counter.launches
    eager = fn(s, b, mesh, "model", **kw)
    assert not ring_graph._cache
    assert counter.launches == n0 + per_ring
    for call in (2, 3):
        replay = fn(s, b, mesh, "model", **kw)
        assert len(ring_graph._cache) == 1
        assert counter.launches == n0 + call * per_ring
        assert torch.equal(replay, eager)
    name = "ring_step_tiled_cuda" if tiled else "ring_step_cuda"
    monkeypatch.setattr(rk, name, rk.ring_step_plain)
    for call in (1, 2):
        plain = fn(s, b, mesh, "model", **kw)
        assert len(ring_graph._cache) == call  # another step, another graph
        assert _rel(replay, plain) < TOL[torch.bfloat16]
    ring_graph.clear()


def test_ring_replay_reads_the_operands_at_replay_time(gen):
    """B changed in place gives the new product; the first result survives
    the next call; a new operand runs eagerly, then captures a graph of its
    own."""
    import sparsifyme_tpu_torch as sp
    from sparsifyme_tpu_torch.parallel import ring_graph

    ring_graph.clear()
    s, b, mesh = _ring_case(gen)
    f = sp.spmm_24_ring_explicit
    f(s, b, mesh, "model")  # eager
    first = f(s, b, mesh, "model")  # captured and replayed
    kept = first.clone()
    b.mul_(-2.0)
    second = f(s, b, mesh, "model")  # replay on the new contents of b
    assert len(ring_graph._cache) == 1
    assert torch.equal(first, kept)
    assert _rel(second, sp.spmm_24(s, b)) < TOL[torch.bfloat16]
    assert _rel(second.float(), -2.0 * kept.float()) < TOL[torch.bfloat16]
    b2 = b.clone()
    fresh = f(s, b2, mesh, "model")  # eager
    assert len(ring_graph._cache) == 1
    assert torch.equal(fresh, second)
    f(s, b2, mesh, "model")
    assert len(ring_graph._cache) == 2
    ring_graph.clear()


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
    from sparsifyme_tpu_torch.parallel import ring_graph

    ring_graph.clear()
    assert not ring_graph.captures(mesh.axis_devices("model"))
    for fn in (sp.spmm_24_ring, sp.spmm_24_ring_explicit,
               sp.spmm_24_ring_tiled):
        for _ in range(2):  # meshes over several cards never capture
            got = fn(s, b, mesh, "model", out_dtype=torch.float32)
            assert got.device == want.device
            assert _rel(got, want) < TOL[torch.bfloat16]
    assert not ring_graph._cache


@pytest.mark.parametrize("tiled", [False, True])
def test_rings_across_cards_on_wgmma_sp(gen, tiled):
    """Both K7 routes on the wgmma_sp step with ranks round-robin over the
    cards: a rank on the packed operand's card reads its window in place
    (first m-tile r * mloc / 128), the others a copy of their slab on their
    own card (first m-tile 0); within 2e-2 of spmm_24, every launch
    counted."""
    import sparsifyme_tpu_torch as sp
    from sparsifyme_tpu_torch.parallel import ring_graph
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    p, rows, k, n = 4, 1024, 512, 64
    s, b = _packed_ring_operand(gen, rows, k, n)
    devices = [torch.device("cuda", r % cards) for r in range(p)]
    tiles = s.wg.packed.shape[1] // p
    slabs = rk._wg_slabs(s, p, devices)
    for r, (d, (a, t0)) in enumerate(zip(devices, slabs)):
        if d == s.wg.packed.device:
            assert a is s.wg.packed and t0 == r * tiles
        else:
            assert a.device == d and t0 == 0
            assert torch.equal(a.cpu(), s.wg.packed[:, r * tiles:
                                                    (r + 1) * tiles].cpu())
    mesh = sp.make_mesh((p,), ("model",), devices=devices)
    want = sp.spmm_24(s, b, out_dtype=torch.float32, design="mma_sp")
    fn = sp.spmm_24_ring_tiled if tiled else sp.spmm_24_ring_explicit
    kw = dict(m_tile=128) if tiled else {}
    counter = rk.ring_step_wg_tiled_cuda if tiled else rk.ring_step_wg_cuda
    n_mt = rows // p // 128 if tiled else 1
    ring_graph.clear()
    for odt in (torch.bfloat16, torch.float32):
        n0 = counter.launches
        got = fn(s, b, mesh, "model", out_dtype=odt, design="wgmma_sp",
                 **kw)
        assert got.device == want.device and got.dtype == odt
        assert _rel(got.float(), want) < TOL[torch.bfloat16]
        assert counter.launches == n0 + p * p * n_mt
    assert not ring_graph._cache


CAPTURE_ACROSS_CARDS = """
import torch
d0, d1 = torch.device("cuda:0"), torch.device("cuda:1")
x0 = torch.randn(1 << 20, device=d0)
y1 = torch.empty(1 << 20, device=d1)
out0 = torch.empty(1 << 20, device=d0)
s1 = torch.cuda.Stream(d1)
torch.cuda.synchronize(d0)
torch.cuda.synchronize(d1)
g = torch.cuda.CUDAGraph()
try:
    with torch.cuda.device(d0):
        with torch.cuda.graph(g, stream=torch.cuda.Stream(d0)):
            ev = torch.cuda.Event()
            ev.record()
            s1.wait_event(ev)
            with torch.cuda.stream(s1):
                y1.copy_(x0, non_blocking=True)
                y1.mul_(2)
            ev2 = torch.cuda.Event()
            ev2.record(s1)
            torch.cuda.current_stream(d0).wait_event(ev2)
            out0.copy_(y1, non_blocking=True)
    g.replay()
    torch.cuda.synchronize()
    print("captured", torch.equal(out0, x0 * 2))
except Exception as e:
    print("refused", type(e).__name__, e)
"""


def test_one_capture_cannot_span_cards(gen):
    """Why meshes over several cards queue their rings eagerly: a capture
    that forks to a stream of a second card (preallocated buffers, a peer
    copy and a kernel there, joined back) is refused on this stack. Run in
    a child process, so the refused capture leaves this one clean. If this
    starts to pass, ``ring_graph.captures`` may admit such meshes."""
    import subprocess
    import sys

    from sparsifyme_tpu_torch.parallel import ring_graph

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    assert not ring_graph.captures([torch.device("cuda", 0),
                                    torch.device("cuda", 1)])
    out = subprocess.run([sys.executable, "-c", CAPTURE_ACROSS_CARDS],
                         capture_output=True, text=True, timeout=300).stdout
    assert out.startswith("refused"), out


# --- K7's wgmma_sp step (csrc/ring24_wg.cu) ---------------------------------

def _packed_ring_operand(gen, rows, k, n):
    """A bf16 ring operand whose container carries ``pack_wg``'s operand."""
    from sparsifyme_tpu_torch.ops.sparse24 import pack_wg

    s, b = _ring_operand(gen, rows, k, n, torch.bfloat16)
    return pack_wg(s), b


WG_STEP_WINDOWS = [
    (25088, 4, 1, 1024, 256, 0, 6272),    # R: rank 1's whole shard
    (25088, 4, 1, 1024, 256, 2688, 896),  # R: the tiled route's 4th m-tile
    (1024, 2, 1, 256, 64, 128, 256),      # 64 columns, an m-tile
    (512, 1, 0, 128, 128, 0, 512),        # one rank: the whole operand
]


# each window under its plan, two splits, and each width its n takes
@pytest.mark.parametrize("rows,p,r,k,n,c0,mt,plan", [
    (*w, plan) for w in WG_STEP_WINDOWS
    for plan in (None, (None, 2), (64, None), (128, None))
    if plan is None or plan[0] is None or w[4] % plan[0] == 0])
@pytest.mark.parametrize("odtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("first,last", [(True, False), (False, False),
                                        (False, True), (True, True)])
def test_ring_step_wg_kernel(gen, rows, p, r, k, n, c0, mt, odtype, first,
                             last, plan):
    """K7's wgmma_sp step on rank r's window of the container's packed
    operand (the one-card mesh's addressing: the rank starts at m-tile
    r * mloc / 128 of it) against its plain version (the packed words
    decoded) and the mma_sp step's plain version on the planes: the
    accumulator on middle steps, C on the last, nothing outside the
    window; under the plan, with two splits (the second pass), at 64
    columns (at R's 6272 196 units on 132 persistent blocks: two a block)
    and at 128 (the tiled window's 14 units), each forced as
    ``bench/ring_probe.py`` forces it."""
    from sparsifyme_tpu_torch.bench.ring_probe import forced
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    s, _ = _packed_ring_operand(gen, rows, k, n)
    mloc, k4s = rows // p, s.values0.shape[0] // p
    planes = [x[:, r * mloc:(r + 1) * mloc]
              for x in (s.values0, s.values1, s.codes)]
    a_wg = (s.wg.packed, r * mloc // 128)
    slot = torch.randn((4 * k4s, n), generator=gen,
                       device="cuda").to(torch.bfloat16)
    acc0 = torch.randn((mloc, n), generator=gen, device="cuda")
    src = (r + 1) % p
    outs = []
    with forced(*(plan or ())):
        for fn, a in ((rk.ring_step_wg_cuda, a_wg),
                      (rk.ring_step_wg_plain, a_wg),
                      (rk.ring_step_plain, planes)):
            acc = acc0.clone()
            out = torch.zeros((mloc, n), dtype=odtype, device="cuda")
            fn(*a, slot, acc, out, src=src, c0=c0, mt=mt, first=first,
               last=last)
            outs.append((acc, out))
    (acc, out), (acc_p, out_p), (acc_q, out_q) = outs
    if last:
        assert torch.equal(acc, acc0)
        assert _rel(out, out_p) < TOL[odtype]
        assert _rel(out_p, out_q) < TOL[odtype]
        assert not out[:c0].any() and not out[c0 + mt:].any()
    else:
        assert _rel(acc, acc_p) < TOL[torch.float32]
        assert _rel(acc_p, acc_q) < TOL[torch.float32]
        assert torch.equal(acc[:c0], acc0[:c0])
        assert torch.equal(acc[c0 + mt:], acc0[c0 + mt:])
        assert not out.any()


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("tiled", [False, True])
def test_rings_on_one_card_on_wgmma_sp(gen, p, tiled):
    """Both K7 routes on a packed container with P logical ranks on one
    card take the wgmma_sp step: eager, then captured and replayed, the
    replays bitwise the eager ring, all within 2e-2 of single-card
    spmm_24, bf16 and f32 C; the wgmma_sp wrappers count every launch,
    replays included, and the mma_sp ones none."""
    import sparsifyme_tpu_torch as sp
    from sparsifyme_tpu_torch.parallel import ring_graph
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    batch, m, k, n = 2, 128 * p, 128 * p, 64
    s, b = _packed_ring_operand(gen, batch * m, k, n)
    s = type(s)(s.values0, s.values1, s.codes, shape=(batch, m, k), wg=s.wg)
    mesh = sp.make_mesh((p,), ("model",), devices=["cuda:0"] * p)
    want = sp.spmm_24(s, b, out_dtype=torch.float32, design="mma_sp")
    counter = rk.ring_step_wg_tiled_cuda if tiled else rk.ring_step_wg_cuda
    others = (rk.ring_step_cuda, rk.ring_step_tiled_cuda)
    fn = sp.spmm_24_ring_tiled if tiled else sp.spmm_24_ring_explicit
    kw = dict(m_tile=128) if tiled else {}
    n_mt = batch * m // p // 128 if tiled else 1
    for odt in (torch.bfloat16, torch.float32):
        ring_graph.clear()
        n0, o0 = counter.launches, [f.launches for f in others]
        got = [fn(s, b, mesh, "model", out_dtype=odt, **kw)
               for _ in range(3)]
        assert len(ring_graph._cache) == 1
        for g in got:
            assert g.dtype == odt and tuple(g.shape) == (batch, m, n)
            assert torch.equal(g, got[0])
        assert _rel(got[0].float(), want) < TOL[torch.bfloat16]
        assert counter.launches == n0 + 3 * p * p * n_mt
        assert [f.launches for f in others] == o0
    ring_graph.clear()


@pytest.mark.parametrize("tiled,p,t", [(False, 4, 1), (False, 3, 0),
                                       (True, 4, 3), (True, 3, 1),
                                       (True, 2, 1)])
def test_ring_credit_protocol_on_wgmma_sp(gen, monkeypatch, tiled, p, t):
    """test_ring_credit_protocol on the wgmma_sp step: rank 1's step t
    delayed by a long sleep, the ring eager, captured and replayed, each
    within 2e-2 of spmm_24."""
    import sparsifyme_tpu_torch as sp
    from sparsifyme_tpu_torch.parallel import ring_graph
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    name = "ring_step_wg_tiled_cuda" if tiled else "ring_step_wg_cuda"
    real = getattr(rk, name)
    per_ring = p * p * (2 if tiled else 1)
    calls = []

    def delayed(*a, **kw):
        if len(calls) % per_ring == t * p + 1:  # step-major: rank 1, step t
            torch.cuda._sleep(200_000_000)
        calls.append(1)
        real(*a, **kw)

    delayed.launches = real.launches
    monkeypatch.setattr(rk, name, delayed)
    s, b = _packed_ring_operand(gen, 256 * p, 128 * p, 64)
    mesh = sp.make_mesh((p,), ("model",), devices=["cuda:0"] * p)
    fn = sp.spmm_24_ring_tiled if tiled else sp.spmm_24_ring_explicit
    kw = dict(m_tile=128) if tiled else {}
    want = sp.spmm_24(s, b, out_dtype=torch.float32, design="mma_sp")
    n0 = delayed.launches
    ring_graph.clear()
    for call in range(3):
        got = fn(s, b, mesh, "model", out_dtype=torch.float32,
                 design="wgmma_sp", **kw)
        assert _rel(got.cpu(), want.cpu()) < TOL[torch.bfloat16]
        assert len(calls) == min(call + 1, 2) * per_ring
        assert delayed.launches == n0 + (call + 1) * per_ring
    ring_graph.clear()


@pytest.mark.parametrize("tiled", [False, True])
def test_ring_replay_is_the_eager_ring_on_wgmma_sp(gen, monkeypatch, tiled):
    """test_ring_replay_is_the_eager_ring on the wgmma_sp step, and the
    cache telling the designs apart: the same operands on the mma_sp step
    capture a graph of their own, as do the plain step's rings."""
    import sparsifyme_tpu_torch as sp
    from sparsifyme_tpu_torch.parallel import ring_graph
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    ring_graph.clear()
    s, b = _packed_ring_operand(gen, 1024, 256, 64)
    mesh = sp.make_mesh((4,), ("model",), devices=["cuda:0"] * 4)
    fn = sp.spmm_24_ring_tiled if tiled else sp.spmm_24_ring_explicit
    kw = dict(m_tile=128) if tiled else {}
    counter = rk.ring_step_wg_tiled_cuda if tiled else rk.ring_step_wg_cuda
    per_ring = 16 * (2 if tiled else 1)
    n0 = counter.launches
    eager = fn(s, b, mesh, "model", **kw)
    assert not ring_graph._cache
    assert counter.launches == n0 + per_ring
    for call in (2, 3):
        replay = fn(s, b, mesh, "model", **kw)
        assert len(ring_graph._cache) == 1
        assert counter.launches == n0 + call * per_ring
        assert torch.equal(replay, eager)
    for call in (1, 2):
        other = fn(s, b, mesh, "model", design="mma_sp", **kw)
        assert len(ring_graph._cache) == 1 + call // 2
        assert _rel(other, eager) < TOL[torch.bfloat16]
    name = "ring_step_wg_tiled_cuda" if tiled else "ring_step_wg_cuda"
    monkeypatch.setattr(rk, name, rk.ring_step_wg_plain)
    for call in (1, 2):
        plain = fn(s, b, mesh, "model", **kw)
        assert len(ring_graph._cache) == 2 + call // 2
        assert _rel(replay, plain) < TOL[torch.bfloat16]
    ring_graph.clear()


def test_ring_wg_refusals_on_the_card(gen):
    """The rings take the mma_sp step wherever ring_wg_refusal refuses the
    wgmma_sp one (f32, an m-tile off 128 rows, n % 64, no packed operand),
    and a forced wgmma_sp raises there before any launch; a stale operand
    raises whatever the design."""
    import sparsifyme_tpu_torch as sp
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    mesh = sp.make_mesh((2,), ("model",), devices=["cuda:0"] * 2)
    s, b = _packed_ring_operand(gen, 512, 256, 64)
    s48, b48 = _packed_ring_operand(gen, 512, 256, 48)
    plain, _ = _ring_operand(gen, 512, 256, 64, torch.bfloat16)
    cases = [(s, b.float(), {}, "bf16 in"),
             (s, b, dict(m_tile=64), "m-tile"),
             (s48, b48, {}, "n 48"),
             (plain, b, {}, "carries no wg")]
    for ss, bb, kw, match in cases:
        fn = sp.spmm_24_ring_tiled if kw else sp.spmm_24_ring_explicit
        n0 = (rk.ring_step_wg_cuda.launches
              + rk.ring_step_wg_tiled_cuda.launches)
        got = fn(ss, bb, mesh, "model", out_dtype=torch.float32, **kw)
        want = sp.spmm_24(ss, bb, out_dtype=torch.float32, design="mma_sp")
        assert _rel(got, want) < TOL[torch.bfloat16]
        with pytest.raises(ValueError, match=match):
            fn(ss, bb, mesh, "model", design="wgmma_sp", **kw)
        assert n0 == (rk.ring_step_wg_cuda.launches
                      + rk.ring_step_wg_tiled_cuda.launches)
    s.values0.mul_(1.0)  # an in-place write: the operand is stale
    for design in (None, "wgmma_sp", "mma_sp"):
        with pytest.raises(ValueError, match="stale"):
            sp.spmm_24_ring_explicit(s, b, mesh, "model", design=design)
    with pytest.raises(ValueError, match="design"):
        sp.spmm_24_ring_explicit(plain, b, mesh, "model", design="wgmma")


def test_ring_step_wg_rejects_what_it_does_not_take(gen):
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    s, _ = _packed_ring_operand(gen, 512, 256, 64)
    wg = s.wg.packed
    slot = torch.zeros((128, 64), dtype=torch.bfloat16, device="cuda")
    acc = torch.zeros((256, 64), device="cuda")
    kw = dict(c0=0, mt=256, first=True, last=False)
    with pytest.raises(ValueError, match="outside"):
        rk.ring_step_wg_cuda(wg, 0, slot, acc, acc, src=2, **kw)
    with pytest.raises(ValueError, match="outside"):
        rk.ring_step_wg_cuda(wg, 3, slot, acc, acc, src=0, **kw)
    with pytest.raises(ValueError, match="outside"):
        rk.ring_step_wg_cuda(wg, 0, slot, acc, acc, src=0, c0=64, mt=128,
                             first=True, last=False)
    with pytest.raises(TypeError):
        rk.ring_step_wg_cuda(wg, 0, slot.float(), acc, acc, src=0, **kw)
    with pytest.raises(ValueError, match="acc"):
        rk.ring_step_wg_cuda(wg, 0, slot, None, acc, src=0, **kw)
    with pytest.raises(ValueError, match="k %"):
        rk.ring_step_wg_cuda(wg, 0, slot[:96], acc, acc, src=0, **kw)


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


# --- the Hopper tile of K4 and K5 (csrc/ell_tile.cuh) -----------------------

@pytest.mark.parametrize("bk,n", [(32, 136), (64, 256), (128, 512),
                                  (64, 72)])
@pytest.mark.parametrize("tout", [False, True])
def test_ell_tile_under_every_plan(gen, monkeypatch, bk, n, tout):
    """K4 (with and without alpha/beta/c) and K5 (a repeated and an
    out-of-range column) against their plain versions under every tile
    width, split count and number of blocks per SM the plan can take, bf16
    and f32 C, rows of B past kb, ragged n."""
    mb, kblocks, ell = 3, 6, 4
    m, kb = mb * 128, kblocks * bk - 5
    vals = torch.randn((m, ell * bk), generator=gen,
                       device="cuda").to(torch.bfloat16)
    vkm = vals.T.contiguous()
    cols = torch.stack([torch.randperm(kblocks, device="cuda")[:ell]
                        for _ in range(mb)]).to(torch.int32)
    cols_x = cols.clone()
    cols_x[1, 3] = cols_x[1, 0]
    cols_x[2, 1] = kblocks + 2
    b = torch.randn((kb, n), generator=gen, device="cuda").to(torch.bfloat16)
    c = torch.randn((n, m) if tout else (m, n), generator=gen, device="cuda")
    plans = [ell_kernel.ell_plan(m, n, ell, bk, 128, widths=(bn,),
                                 split_counts=(s,), cta_counts=(c,))
             for bn in ell_kernel.TILE_NS for s in (1, 2, 4) for c in (1, 2)]
    plans = [p for p in plans if p is not None]
    assert {p.splits for p in plans} == {1, 2, 4}
    for plan in plans:
        monkeypatch.setattr(ell_kernel, "card_plan", lambda *a, p=plan: p)
        for odt in (torch.bfloat16, torch.float32):
            kw = dict(block_size=128, block_k=bk, out_dtype=odt,
                      transpose_out=tout)
            epi = dict(alpha=0.5, beta=-2.0, c=c)
            for fn, plain, v, cc, extra in (
                    (ell_kernel.ell_spmm_cuda, ell_kernel.ell_spmm_plain,
                     vals, cols, {}),
                    (ell_kernel.ell_spmm_cuda, ell_kernel.ell_spmm_plain,
                     vals, cols, epi),
                    (ell_kernel.ell_expand_spmm_cuda,
                     ell_kernel.ell_expand_spmm_plain, vkm, cols_x, {})):
                got = fn(v, cc, b, **extra, **kw)
                assert _rel(got, plain(v, cc, b, **extra, **kw)) < \
                    TOL[torch.bfloat16], (plan, odt, fn.__name__, extra)


def test_ell_kernels_run_on_wgmma_fed_by_tma(gen):
    """The built K4 and K5 libraries hold warpgroup MMAs (HGMMA) and TMA
    loads (UTMALDG): cuobjdump --dump-sass lib{ell_spmm,ell_expand}.so."""
    import pathlib
    import subprocess

    from sparsifyme_tpu_torch import _build

    _build.build_all()
    tool = pathlib.Path(_build.find_nvcc()).parent / "cuobjdump"
    for name in ("ell_spmm", "ell_expand"):
        sass = subprocess.run(
            [str(tool), "--dump-sass", str(_build.build_dir() /
                                           f"lib{name}.so")],
            check=True, capture_output=True, text=True).stdout
        assert "HGMMA" in sass and "UTMALDG" in sass, name


# --- gradients on the card (ROADMAP C1) --------------------------------------

def _grad_problem(op, dtype, tout):
    """CPU inputs of one differentiable op and a function running it on a
    device: ``(leaves, run(leaves_on_device, device))``."""
    from sparsifyme_tpu_torch.containers import BlockedEll, Sparse24
    from sparsifyme_tpu_torch.ops import ell as te
    from sparsifyme_tpu_torch.ops import sparse24 as ts

    g = torch.Generator().manual_seed(5)
    n = 72
    if op == "spmm_24":
        a = torch.randn((2, 128, 256), generator=g).to(dtype)
        s = ts.compress_24(prune_kernel.prune_nm_plain(a, 2, 4)[0])
        leaves = dict(v0=s.values0, v1=s.values1,
                      b=torch.randn((256, n), generator=g).to(dtype),
                      c=torch.randn((n, 256) if tout else (2, 128, n),
                                    generator=g))

        def run(t, dev):
            return ts.spmm_24(Sparse24(t["v0"], t["v1"], s.codes.to(dev),
                                       shape=s.shape), t["b"], c=t["c"],
                              alpha=0.5, beta=2.0, transpose_out=tout)
        return leaves, run
    a = torch.randn((1, 256, 256), generator=g).to(dtype)
    e = te.ell_from_dense(a, 128, 4, 32)
    b = torch.randn((256, n), generator=g).to(dtype)

    def ell(dev, values=None):
        return BlockedEll(e.values.to(dev) if values is None else values,
                          e.col_indices.to(dev), e.shape, 128, 32)
    if op == "spmm_ell":
        leaves = dict(values=e.values, b=b,
                      c=torch.randn((n, 256) if tout else (1, 256, n),
                                    generator=g))

        def run(t, dev):
            return te.spmm_ell(ell(dev, t["values"]), t["b"], c=t["c"],
                               alpha=-1.5, beta=0.5, transpose_out=tout)
        return leaves, run
    leaves = dict(values_km=te.ell_values_kmajor(e), b=b)

    def run(t, dev):
        return te.spmm_ell_expand(ell(dev), t["b"],
                                  values_km=t["values_km"],
                                  transpose_out=tout)
    return leaves, run


@pytest.mark.parametrize("op,wrapper", [
    ("spmm_24", spmm24_kernel.spmm24_cuda),
    ("spmm_ell", ell_kernel.ell_spmm_cuda),
    ("spmm_ell_expand", ell_kernel.ell_expand_spmm_cuda)])
@pytest.mark.parametrize("tout", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grads_on_the_card_match_the_cpu(gen, op, wrapper, tout, dtype):
    """The forward through the kernel, the backward through the JAX VJP's
    port: every input's gradient equals the one the plain versions give on
    the CPU."""
    base, run = _grad_problem(op, dtype, tout)
    got = {}
    for dev in ("cpu", "cuda"):
        t = {k: v.to(dev).requires_grad_() for k, v in base.items()}
        n0 = wrapper.launches
        out = run(t, dev)
        assert out.grad_fn is not None
        assert wrapper.launches == n0 + (dev == "cuda")
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            9)).to(out.dtype)
        got[dev] = torch.autograd.grad(out, list(t.values()), cot.to(dev))
    for name, h, w in zip(base, got["cuda"], got["cpu"]):
        assert _rel(h.cpu(), w) < TOL[dtype], name


@pytest.mark.parametrize("route", ["batch", "row", "ring"])
@pytest.mark.parametrize("p", [2, 4])
def test_sharded_grads_on_the_card_match_the_cpu(gen, route, p):
    """The sharded 2:4 SpMMs carry the gradient through their rank streams
    and copies: ranks on one card against ranks on the CPU."""
    import sparsifyme_tpu_torch as sp
    from sparsifyme_tpu_torch.containers import Sparse24

    fn = {"batch": sp.spmm_24_batch_sharded, "row": sp.spmm_24_row_sharded,
          "ring": sp.spmm_24_ring}[route]
    g = torch.Generator().manual_seed(7)
    a = torch.randn((4, 32, 128), generator=g)
    s = sp.compress_24(prune_kernel.prune_nm_plain(a, 2, 4)[0])
    b = torch.randn((128, 40), generator=g)
    cot = torch.randn((4, 32, 40), generator=g)
    got = {}
    for dev in ("cpu", "cuda"):
        mesh = sp.make_mesh((p,), ("model",),
                            devices=["cpu" if dev == "cpu" else "cuda:0"] * p)
        leaves = [x.to(dev).requires_grad_()
                  for x in (s.values0, s.values1, b)]
        out = fn(Sparse24(leaves[0], leaves[1], s.codes.to(dev),
                          shape=s.shape), leaves[2], mesh, "model")
        assert out.grad_fn is not None
        got[dev] = torch.autograd.grad(out, leaves, cot.to(dev))
    for h, w in zip(got["cuda"], got["cpu"]):
        assert _rel(h.cpu(), w) < TOL[torch.float32]


def test_routes_without_a_backward_raise_under_grad(gen):
    """The fold=2 route, K6 and K7's rings have no VJP in the JAX package:
    on the card they raise where autograd would record them, and run under
    torch.no_grad()."""
    import sparsifyme_tpu_torch as sp

    w = torch.randn((64, 128), generator=gen, device="cuda")
    b = torch.randn((128, 16), generator=gen, device="cuda",
                    requires_grad=True)
    folded = sp.prune_compress_24(w, fold=2)
    coo = sp.coo_from_dense(sp.prune_threshold(w, 1.0)[0])
    s = sp.compress_24(sp.prune_24(w)[0])
    mesh = sp.make_mesh((2,), ("model",), devices=["cuda:0"] * 2)
    calls = [lambda: sp.spmm_24(folded, b),
             lambda: sp.spmm_coo_segmented(coo, b[None]),
             lambda: sp.spmm_24_ring_explicit(s, b, mesh, "model"),
             lambda: sp.spmm_24_ring_tiled(s, b, mesh, "model")]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            assert call().grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_kernels_on_two_cards(gen, dtype):
    """K3 (and its fold route), K4 and K5 launch on their tensors' card
    whatever the current card is (ROADMAP C3): each op on cuda:1 tensors
    with cuda:0 current, right and on cuda:1, with the later work of
    cuda:1's stream ordered after it."""
    import sparsifyme_tpu_torch as sp

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    g = torch.Generator().manual_seed(4)
    a = torch.randn((2, 256, 576), generator=g).to(dtype)
    b = torch.randn((576, 136), generator=g).to(dtype)
    e = sp.ell_from_dense(a, 128, 4, 64)
    ops = [lambda d: sp.spmm_24(sp.compress_24(sp.prune_24(a.to(d))[0]),
                                b.to(d)),
           lambda d: sp.spmm_24(sp.prune_compress_24(a.to(d), fold=2),
                                b.to(d)),
           lambda d: sp.spmm_ell(e.__class__(e.values.to(d),
                                             e.col_indices.to(d), e.shape,
                                             128, 64), b.to(d)),
           lambda d: sp.spmm_ell_expand(e.__class__(
               e.values.to(d), e.col_indices.to(d), e.shape, 128, 64),
               b.to(d))]
    with torch.cuda.device(0):
        for op in ops:
            want = op("cpu")
            got = op("cuda:1")
            assert got.device == torch.device("cuda:1")
            got = (got * 1).cpu()  # a later kernel on cuda:1's stream
            assert _rel(got, want) < TOL[dtype]


# --------------------------------------------------------------------------
# The model layer: conv layers, the sparse MLP's train step, entry points
# --------------------------------------------------------------------------
# --------------------------------------------------------------------------
# The model layer: conv layers, the sparse MLP's train step, entry points
# --------------------------------------------------------------------------

def _launches():
    from sparsifyme_tpu_torch.parallel import ring_kernel
    return (prune_kernel.prune_nm_cuda.launches,
            prune_kernel.compress_24_cuda.launches,
            spmm24_kernel.spmm24_cuda.launches,
            ell_kernel.ell_spmm_cuda.launches,
            ring_kernel.ring_step_cuda.launches,
            ring_kernel.ring_step_tiled_cuda.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_layers_on_the_card(gen, dtype):
    """Both conv layers at a ragged shape (15x15 input, stride 2 with XLA's
    padding, k = 29 * 9 = 261: not a multiple of 64 nor of the ELL block):
    built with K1 and K2 (the 2:4 layer), run through K3 and K4, against
    their dense references on the card and the same layers on the CPU."""
    from sparsifyme_tpu_torch.models.sparse_conv import (EllConv2d,
                                                         SparseConv2d)

    w = torch.randn((128, 29, 3, 3), generator=gen, device="cuda").to(dtype)
    x = torch.randn((3, 15, 15, 29), generator=gen, device="cuda").to(dtype)
    n0 = _launches()
    layers = [SparseConv2d(w, stride=2), EllConv2d(w, stride=2)]
    cpu_layers = [SparseConv2d(w.cpu(), stride=2), EllConv2d(w.cpu(),
                                                             stride=2)]
    for t, c in zip((layers[0].values0, layers[0].values1, layers[0].codes,
                     layers[1].values, layers[1].col_indices),
                    (cpu_layers[0].values0, cpu_layers[0].values1,
                     cpu_layers[0].codes, cpu_layers[1].values,
                     cpu_layers[1].col_indices)):
        assert torch.equal(t.detach().cpu(), c.detach())
    with torch.no_grad():
        for layer, cpu_layer in zip(layers, cpu_layers):
            out = layer(x)
            assert tuple(out.shape) == (3, 8, 8, 128)
            assert _rel(out, layer.dense_reference(x)) < TOL[dtype]
            assert _rel(out.cpu(), cpu_layer(x.cpu())) < TOL[dtype]
    n1 = _launches()
    assert all(b > a for a, b in list(zip(n0, n1))[:4]), (n0, n1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_conv_grad_on_the_card_matches_the_cpu(gen, dtype):
    from sparsifyme_tpu_torch.models.sparse_conv import EllConv2d

    g = torch.Generator().manual_seed(5)
    w = torch.randn((128, 16, 3, 3), generator=g).to(dtype)
    x = torch.randn((2, 9, 9, 16), generator=g).to(dtype)
    y = torch.randn((2, 5, 5, 128), generator=g).to(dtype)
    grads = {}
    for dev in ("cpu", "cuda"):
        layer = EllConv2d(w.to(dev), stride=2)
        loss = torch.mean((layer(x.to(dev)).float() - y.to(dev).float())
                          ** 2)
        loss.backward()
        grads[dev] = layer.values.grad
    assert _rel(grads["cuda"].cpu(), grads["cpu"]) < TOL[dtype]


def _train_on(devices, dtype):
    """Three steps of the dp x tp train step on a 2 x 2 mesh of ranks on
    ``devices``, against the same steps on CPU ranks."""
    from sparsifyme_tpu_torch import make_mesh
    from sparsifyme_tpu_torch.models import sparse_mlp as tmlp

    config = tmlp.MlpConfig(dims=(64, 128, 64), dtype=dtype)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((16, 64), generator=g).to(config.torch_dtype)
    y = torch.randn((16, 64), generator=g).to(config.torch_dtype)
    runs = {}
    for devs in (["cpu"] * 4, devices):
        params = tmlp.init_params(config, torch.Generator().manual_seed(0),
                                  devs[0])
        step = tmlp.make_train_step(
            make_mesh((2, 2), ("data", "model"), devices=devs), config)
        losses = []
        for _ in range(3):
            loss, params = step(params, x.to(devs[0]), y.to(devs[0]))
            losses.append(float(loss))
        runs[devs[0]] = losses, params
    tol = TOL[config.torch_dtype]
    for a, b in zip(runs[devices[0]][0], runs["cpu"][0]):
        assert abs(a - b) <= tol * abs(b)
    for lc, lg in zip(runs["cpu"][1], runs[devices[0]][1]):
        assert torch.equal(lc[2], lg[2].cpu())
        for i in (0, 1, 3):
            assert lg[i].device == torch.device(devices[0])
            assert _rel(lg[i].cpu(), lc[i]) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_on_the_card_matches_the_cpu(gen, dtype):
    """Four ranks on one card."""
    _train_on(["cuda:0"] * 4, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_across_cards_matches_the_cpu(gen, dtype):
    """Ranks round-robin over the cards: the all-gather and its backward
    copy between cards."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    _train_on([f"cuda:{r % cards}" for r in range(4)], dtype)


def test_entry_points_on_the_card(gen, capsys):
    """The flagship forward on the card against the same forward on the
    CPU, and ``dryrun_multichip(4)`` on ranks of the card (its checks
    raise), which launches K7 on both routes."""
    from sparsifyme_tpu_torch import entry

    fn, (params, x) = entry.entry()
    out = fn(params, x)
    assert out.is_cuda and tuple(out.shape) == (128, 256)
    cpu = [tuple(t.cpu() for t in layer) for layer in params]
    assert _rel(out.cpu(), fn(cpu, x.cpu())) < TOL[torch.bfloat16]
    n0 = _launches()
    entry.dryrun_multichip(4)
    n1 = _launches()
    assert n1[4] > n0[4] and n1[5] > n0[5]
    assert "rdma-ring-tiled OK" in capsys.readouterr().out


# --- the tuner's knobs and the harness's tuned path --------------------------

TUNE_SHAPES = [(3136, 128, 1152), (12544, 256, 64), (196, 512, 4608),
               (12544, 64, 147)]  # N, E, D and the shape of the 16 edge


@pytest.mark.parametrize("m,n,k", TUNE_SHAPES)
@pytest.mark.parametrize("tile", range(len(spmm24_kernel.SP_TILES)))
@pytest.mark.parametrize("tout", [False, True])
def test_spmm_24_with_every_tile_forced(gen, m, n, k, tile, tout):
    """``spmm_24(tile=)`` launches K3 on that tile (b=4 folded into rows)
    and matches the plain version."""
    from sparsifyme_tpu_torch.ops import sparse24 as ts

    a = torch.randn((4, m, k), generator=gen,
                    device="cuda").to(torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    s = ts.prune_compress_24(a)
    n0 = spmm24_kernel.spmm24_cuda.launches
    got = ts.spmm_24(s, b, transpose_out=tout, tile=tile)
    assert spmm24_kernel.spmm24_cuda.launches == n0 + 1
    want = spmm24_kernel.spmm24_plain(
        s.values0, s.values1, s.codes, b, k_logical=k,
        out_dtype=torch.bfloat16, transpose_out=tout)
    assert _rel(got if tout else got.reshape(-1, n), want) < \
        TOL[torch.bfloat16]


@pytest.mark.parametrize("m,n,k", TUNE_SHAPES)
def test_spmm_ell_under_every_plan_the_tuner_races(gen, m, n, k):
    """Every ELL candidate of the tuner's full grid (each edge, layout and
    admitted plan, width x splits, forced through ``spmm_ell(block_n=,
    splits=)``; K5 on its edges) at b=4 against the plain versions."""
    import torch.nn.functional as F

    from sparsifyme_tpu_torch.bench import harness, tune

    b = 4
    a = torch.randn((b, m, k), generator=gen,
                    device="cuda").to(torch.bfloat16)
    bm = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    cands = tune.ell_candidates(m, n, k, b, full=True,
                                sms=spmm24_kernel.sm_count(0))
    for key in dict.fromkeys((c["block_k"], c["fold_first"]) for c in cands):
        e, kp = harness.build_ell_operand(a, block_size=128, block_k=key[0],
                                          fold_first=key[1])
        bp = F.pad(bm, (0, 0, 0, kp - k))
        values = e.values.reshape(-1, e.values.shape[-1])
        cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
        for cand in (c for c in cands
                     if (c["block_k"], c["fold_first"]) == key):
            fn, ops = harness.ell_call(cand, e, bp, torch.bfloat16)
            got = fn(*ops)
            kw = dict(block_size=128, block_k=key[0],
                      out_dtype=torch.bfloat16,
                      transpose_out=cand["transpose_out"])
            if cand["formulation"] == "gather":
                want = ell_kernel.ell_spmm_plain(values, cols, bp, **kw)
            else:
                want = ell_kernel.ell_expand_spmm_plain(values.T, cols, bp,
                                                        **kw)
            if not cand["transpose_out"]:
                got = got.reshape(want.shape)
            assert _rel(got, want) < TOL[torch.bfloat16], cand


def test_forced_infeasible_knobs_raise_before_any_launch(gen):
    from sparsifyme_tpu_torch.ops import ell as te
    from sparsifyme_tpu_torch.ops import sparse24 as ts

    a = torch.randn((256, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    b = torch.randn((128, 64), generator=gen, device="cuda").to(torch.bfloat16)
    e = te.ell_from_dense(a, 128, 2, 32)
    s = ts.prune_compress_24(a)
    n4 = ell_kernel.ell_spmm_cuda.launches
    n5 = ell_kernel.ell_expand_spmm_cuda.launches
    n3 = spmm24_kernel.spmm24_cuda.launches
    with pytest.raises(ValueError, match="no plan"):
        te.spmm_ell(e, b, block_n=256)  # wider than n = 64 needs
    with pytest.raises(ValueError, match="no plan"):
        te.spmm_ell(e, b, splits=3)  # 2 slots: a split would be empty
    with pytest.raises(ValueError, match="no plan"):
        te.spmm_ell(te.ell_from_dense(a.float(), 128, 2, 32), b.float(),
                    block_n=64)  # f32: the Hopper tile does not apply
    with pytest.raises(ValueError, match="tile 4"):
        ts.spmm_24(s, b, tile=4)
    torch.cuda.synchronize()
    assert (ell_kernel.ell_spmm_cuda.launches,
            ell_kernel.ell_expand_spmm_cuda.launches,
            spmm24_kernel.spmm24_cuda.launches) == (n4, n5, n3)


@pytest.mark.parametrize("expand", [False, True])
def test_bench_shape_on_a_one_entry_table_launches_the_tuned_routes(
        gen, monkeypatch, tmp_path, expand):
    """A tuned shape with k < 512, where the untuned race would launch K5:
    with a gather winner K5 never launches, nor the fold route; with an
    expand winner K5 launches beside K4 (the gather alternative)."""
    from sparsifyme_tpu_torch.bench import harness, tuning
    from sparsifyme_tpu_torch.utils.shapes import LayerShape

    shape = (784, 128, 256, 4)
    ell = {"formulation": "gather", "transpose_out": False,
           "block_size": 128, "block_k": 32, "fold_first": True,
           "block_n": 128, "splits": 1}
    if expand:
        ell.update(formulation="expand", block_n=None, splits=None)
    path = str(tmp_path / "table.json")
    tuning.save_table({tuning.shape_key(*shape): {
        "gemm": {"fold": True}, "fused": {"fold": 1},
        "spmm24": {"tile": 2, "transpose_out": False, "packed": False,
                   "fold": 1},
        "ell": ell, "card": "test"}}, path)
    monkeypatch.setattr(tuning, "TABLE_PATH", path)
    tuning._load.cache_clear()
    fns = (spmm24_kernel.spmm24_cuda, spmm24_kernel.spmm24_fold_cuda,
           ell_kernel.ell_spmm_cuda, ell_kernel.ell_expand_spmm_cuda,
           prune_kernel.prune_compress_24_cuda)
    before = [f.launches for f in fns]
    out = harness.bench_shape(LayerShape(*shape), iters=2, reps=1)
    tuning._load.cache_clear()
    d = [f.launches - n for f, n in zip(fns, before)]
    assert d[0] > 0 and d[1] == 0 and d[2] > 0 and d[4] > 0
    assert (d[3] > 0) == expand
    assert out["spmm24_ms"] > 0 and out["ell_ms"] > 0


# --- the probes of K3's tile and K2's fused route ----------------------------

UNITS_SHAPES = [(25088, 256, 1024),  # a probe shape of units_probe
                (208, 72, 200)]      # ragged: M and n past a tile, k % 64


def _units_operands(gen, m, n, k):
    from sparsifyme_tpu_torch.bench import units_probe as up

    return up.operands(m, n, k, gen)


@pytest.mark.parametrize("variant", [
    ("full", 4), ("full", 2), ("full", 1), ("feed", 4), ("feed", 2),
    ("mma", 4), ("mma", 2)])
@pytest.mark.parametrize("m,n,k", UNITS_SHAPES)
def test_units_variants_match_their_plain_versions(gen, variant, m, n, k):
    """Every mode of the sparse tile at 4 and 2 stages (and the serial
    ring) on the tile K3's rule picks: the output within 2e-2, kFeed's
    side words (the XOR of the metadata) exactly."""
    from sparsifyme_tpu_torch.bench import units_probe as up

    ops = _units_operands(gen, m, n, k)
    assert up.check(*ops, variant)[1] < TOL[torch.bfloat16]
    if variant[0] == "feed":
        _, side = up.units_cuda(*ops, mode="feed", stages=variant[1])
        assert side.any()


def _units_shape_for_tile(tile, sms):
    """A ragged ``(m, n, k)`` at which ``pick_tile`` gives ``tile`` on a card
    of ``sms`` SMs: half the SMs' worth of row blocks over two column
    blocks (the 256-row tile at 11 k-steps, which it needs; the others at
    3, more than two stages and fewer than four), or a grid too small for
    any larger tile."""
    half = sms // 2
    return [(256 * half - 8, 136, 704), (128 * half - 8, 136, 192),
            (128 * half - 8, 72, 192), (264, 72, 192)][tile]


@pytest.mark.parametrize("tile", range(len(spmm24_kernel.SP_TILES)))
@pytest.mark.parametrize("variant", [("full", 1), ("feed", 2), ("mma", 2),
                                     ("mma", 4)])
def test_units_variants_at_every_tile(gen, tile, variant):
    """The modes on every tile size, each reached through a shape at which
    K3's rule picks it, with a ragged M and n."""
    from sparsifyme_tpu_torch.bench import units_probe as up

    m, n, k = _units_shape_for_tile(tile, spmm24_kernel.sm_count(0))
    ops = _units_operands(gen, m, n, k)
    assert up.units_tile(ops[0], ops[3]) == spmm24_kernel.SP_TILES[tile]
    up.check(*ops, variant)


@pytest.mark.parametrize("m,n,k", [(25088, 256, 1024), (401408, 256, 64),
                                   (6272, 512, 4608)])
def test_units_full_is_k3(gen, m, n, k):
    """The full mode at four stages is K3's tile: bitwise K3's output on
    the same tile; at two stages and on the serial ring the same sums in
    the same order, so bitwise too."""
    from sparsifyme_tpu_torch.bench import units_probe as up

    ops = _units_operands(gen, m, n, k)
    k3 = spmm24_kernel.spmm24_cuda(*ops, k_logical=k,
                                   out_dtype=torch.bfloat16)
    for st in (4, 2, 1):
        out, _ = up.units_cuda(*ops, mode="full", stages=st)
        assert torch.equal(out, k3), st


@pytest.mark.parametrize("m,n,k", [(25088, 256, 1024), (6272, 512, 4608)])
def test_fp1_matches_its_plain_version(gen, m, n, k):
    """The expand-then-dense tile on the permuted b against the product in
    the JAX probe's row order, and far from the unpermuted product, at U
    and D."""
    from sparsifyme_tpu_torch.bench import units_probe as up

    v0, v1, codes, b = _units_operands(gen, m, n, k)
    up.check(v0, v1, codes, b, "fp1")
    out = up.fp1_cuda(v0, v1, codes, up.fp1_operand(b))
    plain = spmm24_kernel.spmm24_plain(v0, v1, codes, b, k_logical=k,
                                       out_dtype=torch.bfloat16)
    assert _rel(out, plain) > 0.5


WG_SHAPES = [(25088, 256, 1024),  # U, one split
             (1024, 128, 2048)]   # 8 tiles: split k 8 ways


@pytest.mark.parametrize("variant", [
    ("full", 4), ("full", 2), ("full", 1), ("feed", 4), ("feed", 2),
    ("mma", 4), ("mma", 2)])
@pytest.mark.parametrize("m,n,k", WG_SHAPES)
def test_wgmma_sp_variants_match_their_plain_versions(gen, variant, m, n,
                                                      k):
    """Every mode and depth of the wgmma.sp tile on A packed once: the
    output within 2e-2, kFeed's side words exactly (and not all zero);
    the second shape runs split-k and its second pass."""
    from sparsifyme_tpu_torch.bench import units_probe as up

    ops = _units_operands(gen, m, n, k)
    packed = up.pack_wgmma_sp(*ops[:3])
    assert (up.wg_plan(m, n, k, spmm24_kernel.sm_count(0)).splits > 1) == \
        (m == 1024)
    assert up.check(*ops, variant, "wgmma_sp", packed)[1] < \
        TOL[torch.bfloat16]
    if variant[0] == "feed":
        _, side = up.units_cuda(*ops, mode="feed", stages=variant[1],
                                design="wgmma_sp", packed=packed)
        assert side.any()


def test_wgmma_sp_full_at_d_is_the_product(gen):
    """At D (72 k-steps a unit) the wgmma.sp tile and K3 compute the same
    product within bf16 rounding."""
    from sparsifyme_tpu_torch.bench import units_probe as up

    ops = _units_operands(gen, 6272, 512, 4608)
    got, _ = up.units_cuda(*ops, mode="full", stages=4, design="wgmma_sp")
    k3 = spmm24_kernel.spmm24_cuda(*ops, k_logical=4608,
                                   out_dtype=torch.bfloat16)
    assert _rel(got, k3) < TOL[torch.bfloat16]


def test_hopper_probe_wrappers_raise_on_shapes_they_cannot_take(gen):
    """fp1 and the wgmma.sp tile need M % 128 == 0 and n % 64 == 0, and
    launch nothing else; CPU tensors are refused."""
    from sparsifyme_tpu_torch.bench import units_probe as up

    for m, n in ((264, 128), (256, 72)):
        v0, v1, codes, b = _units_operands(gen, m, n, 128)
        before = (up.fp1_cuda.launches, sum(up.units_cuda.launches.values()))
        with pytest.raises(ValueError):
            up.fp1_cuda(v0, v1, codes, up.fp1_operand(b))
        with pytest.raises(ValueError):
            up.units_cuda(v0, v1, codes, b, mode="full", stages=4,
                          design="wgmma_sp")
        assert before == (up.fp1_cuda.launches,
                          sum(up.units_cuda.launches.values()))
    v0, v1, codes, b = (t.cpu() for t in _units_operands(gen, 256, 128, 128))
    with pytest.raises(ValueError, match="CUDA"):
        up.units_cuda(v0, v1, codes, b, mode="full", stages=4,
                      design="wgmma_sp")
    with pytest.raises(ValueError, match="CUDA"):
        up.fp1_cuda(v0, v1, codes, up.fp1_operand(b))


@pytest.mark.parametrize("mode", ["io", "rank", "dot1", "rm"])
@pytest.mark.parametrize("rows,k", [(401408, 256), (1001, 147), (3000, 576),
                                    (8, 1), (77, 64)])
def test_fused_probe_modes_match_their_plain_versions(gen, mode, rows, k):
    """K2's body in each probe mode on K2's tiles (whole rows at k <= 160,
    64-column tiles above), ragged rows: io and rank within 2e-2 (codes
    exactly), dot1 and rm exactly."""
    from sparsifyme_tpu_torch.bench import fused_probe as fp

    x = torch.randn((rows, k), generator=gen, device="cuda")
    fp.check(x.to(torch.bfloat16), mode)


def test_fused_rm_is_k2_transposed(gen):
    """The row-major mode stores K2's planes, bit for bit."""
    from sparsifyme_tpu_torch.bench import fused_probe as fp

    x = torch.randn((4104, 576), generator=gen,
                    device="cuda").to(torch.bfloat16)
    want = prune_kernel.compress_24_cuda(x)
    got = fp.fused_cuda(x, "rm")
    assert all(torch.equal(g, w.T) for g, w in zip(got, want))


def _sass_functions(lib):
    """``{mangled name: SASS text}`` of a built library."""
    from sparsifyme_tpu_torch import _build
    from sparsifyme_tpu_torch.bench.check_parent import sass_functions

    _build.build_all()
    return sass_functions(_build.build_dir() / f"lib{lib}.so")


def test_units_modes_keep_their_work_in_sass(gen):
    """Each mode's kernel holds the work it names and no more: kFeed its
    cp.async loads (LDGSTS) and no HMMA; kMma and kFull their sparse HMMAs
    and ldmatrix (LDSM); kFull also LDGSTS."""
    import re

    funcs = _sass_functions("sp24_units")
    seen = set()
    for name, body in funcs.items():
        hit = re.search(r"units_kernelILi(\d+)ELi(\d+)ELi(\d)ELi(\d)E", name)
        if not hit:
            continue
        mode = int(hit.group(3))
        seen.add((mode, int(hit.group(4))))
        n_sp = body.count("HMMA.SP")
        if mode == 1:
            assert "HMMA" not in body and "LDGSTS" in body, name
        else:
            assert n_sp > 0 and "LDSM" in body, name
        if mode == 0:
            assert "LDGSTS" in body, name
    assert len(seen) == 7, seen


def test_hopper_probes_keep_their_work_in_sass(gen):
    """The wgmma.sp tile: kFeed its TMA loads (UTMALDG) and no HGMMA, kMma
    and kFull their sparse HGMMAs, kFull also TMA loads; every (mode,
    stages) pair built at both widths. The fp1 tile: TMA loads and dense
    HGMMAs, no warp-level HMMA (simple_tile's wmma is off its path)."""
    import re

    seen = set()
    for name, body in _sass_functions("sp24_wg_units").items():
        hit = re.search(r"wgsp_kernelILi(\d)ELi(\d)ELi(\d+)E", name)
        if not hit:
            continue
        mode = int(hit.group(1))
        seen.add((mode, int(hit.group(2)), int(hit.group(3))))
        if mode == 1:
            assert "HGMMA" not in body and "UTMALDG" in body, name
        else:
            assert "HGMMA" in body and ".SP" in body, name
        if mode == 0:
            assert "UTMALDG" in body, name
    assert len(seen) == 14, seen
    fp1 = [body for name, body in _sass_functions("sp24_units").items()
           if "expand_tma_kernel" in name]
    assert len(fp1) == 2
    for body in fp1:
        assert "HGMMA" in body and "UTMALDG" in body
        assert "HMMA" not in body.replace("HGMMA", "")


# --- K3's wgmma_sp route ------------------------------------------------------

def _resnet50_shapes():
    from sparsifyme_tpu_torch.models.resnet_shapes import resnet_conv_shapes

    return sorted(set(resnet_conv_shapes("resnet50")))


def _wg_operands(gen, rows, n, k):
    """K2's planes of a pruned random bf16 A ``[rows, k]`` and a random
    bf16 b, on the card."""
    a = torch.randn((rows, k), generator=gen, device="cuda").to(
        torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    return (*prune_kernel.prune_compress_24_cuda(a), b)


@pytest.mark.parametrize("shape", _resnet50_shapes(),
                         ids=lambda s: f"{s.m}x{s.n}x{s.k}x{s.b}")
def test_wgmma_sp_route_at_the_resnet50_shapes(gen, shape):
    """At each of the 17 unique ResNet-50 shapes (b = 32 folded into M):
    the pack kernel writes the plain pack's words bit for bit, and the
    route's product is its plain version's (the packed words decoded) and
    K3's plain version's (the planes) within 2e-2."""
    rows, k = shape.m * shape.b, shape.k
    v0, v1, codes, b = _wg_operands(gen, rows, shape.n, k)
    packed = spmm24_kernel.pack_wgmma_sp_cuda(v0, v1, codes)
    assert torch.equal(packed, spmm24_kernel.pack_wgmma_sp(v0, v1, codes))
    kw = dict(m=rows, k_logical=k, out_dtype=torch.bfloat16)
    got = spmm24_kernel.spmm24_wg_cuda(packed, b, **kw)
    assert _rel(got, spmm24_kernel.spmm24_wg_plain(packed, b, **kw)) < \
        TOL[torch.bfloat16]
    assert _rel(got, spmm24_kernel.spmm24_plain(
        v0, v1, codes, b, k_logical=k, out_dtype=torch.bfloat16)) < \
        TOL[torch.bfloat16]


@pytest.mark.parametrize("k4,m", [(1, 128), (7, 256), (20, 384),
                                  (16, 128), (1152, 128)])
def test_pack_kernel_bit_for_bit(gen, k4, m):
    """The pack kernel at group counts that are not a multiple of a k-step's
    16 (zero past the planes), on codes of every kind K2 writes and on
    sliced (non-contiguous) planes."""
    v0, v1, codes, _ = _wg_operands(gen, m, 64, 4 * k4)
    want = spmm24_kernel.pack_wgmma_sp(v0, v1, codes)
    assert torch.equal(spmm24_kernel.pack_wgmma_sp_cuda(v0, v1, codes), want)
    wide = [torch.cat([p, p], dim=1) for p in (v0, v1, codes)]
    got = spmm24_kernel.pack_wgmma_sp_cuda(*(p[:, :m] for p in wide))
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows,n,k", [(1024, 128, 2048), (6272, 512, 4608),
                                      (25088, 64, 147)])
def test_wgmma_sp_route_under_every_plan(gen, rows, n, k):
    """Every width and split count the tile takes (split-k's f32 partials
    and second pass included) against the plain version."""
    v0, v1, codes, b = _wg_operands(gen, rows, n, k)
    packed = spmm24_kernel.pack_wgmma_sp_cuda(v0, v1, codes)
    kw = dict(m=rows, k_logical=k, out_dtype=torch.bfloat16)
    want = spmm24_kernel.spmm24_wg_plain(packed, b, **kw)
    kt = -(-k // 64)
    for bn in (64, 128):
        for splits in range(1, min(kt, 8) + 1):
            if n % bn or (splits - 1) * -(-kt // splits) >= kt:
                continue
            got = spmm24_kernel.spmm24_wg_cuda(packed, b, block_n=bn,
                                               splits=splits, **kw)
            assert _rel(got, want) < TOL[torch.bfloat16], (bn, splits)


def test_wgmma_sp_route_refuses_on_the_card(gen):
    """Every call the route does not take raises when it is forced, and
    launches nothing; a stale operand raises whatever the design; design
    None keeps the mma_sp tile on such calls."""
    import dataclasses

    from sparsifyme_tpu_torch import pack_wg, prune_compress_24, spmm_24

    a = torch.randn((2, 128, 256), generator=gen, device="cuda").to(
        torch.bfloat16)
    b = torch.randn((256, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    s = prune_compress_24(a)
    sw = pack_wg(s)
    before = spmm24_kernel.spmm24_wg_cuda.launches
    for kw in (dict(transpose_out=True), dict(alpha=2.0),
               dict(beta=1.0, c=torch.ones((2, 128, 64), device="cuda")),
               dict(out_dtype=torch.float32), dict(packed_codes=True),
               dict(tile=1)):
        with pytest.raises(ValueError, match="wgmma_sp"):
            spmm_24(sw, b, design="wgmma_sp", **kw)
        spmm_24(sw, b, **kw)  # design None: the mma_sp tile
    with pytest.raises(ValueError, match="wgmma_sp"):
        spmm_24(s, b, design="wgmma_sp")  # no operand
    with pytest.raises(ValueError, match="wgmma_sp"):
        spmm_24(prune_compress_24(a, fold=2), b, design="wgmma_sp")
    b72 = torch.randn((256, 72), generator=gen, device="cuda").to(
        torch.bfloat16)
    with pytest.raises(ValueError, match="wgmma_sp"):
        spmm_24(sw, b72, design="wgmma_sp")  # n % 64
    for bad in (prune_compress_24(a, fold=2), prune_compress_24(a.float()),
                prune_compress_24(a[:, :100])):
        with pytest.raises(ValueError):
            pack_wg(bad)
    assert spmm24_kernel.spmm24_wg_cuda.launches == before
    stale = dataclasses.replace(sw, values0=sw.values0.clone())
    with pytest.raises(ValueError, match="stale"):
        spmm_24(stale, b)
    sw.values1.mul_(2)
    with pytest.raises(ValueError, match="stale"):
        spmm_24(sw, b, design="mma_sp")
    assert spmm24_kernel.spmm24_wg_cuda.launches == before
    got = spmm_24(pack_wg(s), b)
    assert spmm24_kernel.spmm24_wg_cuda.launches == before + 1
    assert _rel(got, spmm_24(s, b)) < TOL[torch.bfloat16]


def test_k3_library_holds_the_wgmma_sp_route(gen, tmp_path):
    """libspmm24.so holds the route's sparse warpgroup MMAs (HGMMA ... SP)
    fed by TMA (UTMALDG), on 128- and 256-row units, and the pack kernel,
    and the mma_sp kernels are
    those of spmm24.cu built without the route (its text above the route's
    marker line), instruction for instruction."""
    import collections
    import subprocess

    from sparsifyme_tpu_torch import _build
    from sparsifyme_tpu_torch.bench.check_parent import sass_functions

    funcs = _sass_functions("spmm24")
    wg = [body for name, body in funcs.items() if "wgsp_kernel" in name]
    assert len(wg) == 2  # kFull at 4 stages, 64 and 128 columns
    tall = [body for name, body in funcs.items() if "wgsp256_kernel" in name]
    assert len(tall) == 2  # the 256-row unit, 64 and 128 columns
    for body in wg + tall:
        assert "HGMMA" in body and ".SP" in body and "UTMALDG" in body
    assert any("wg_pack_kernel" in name for name in funcs)
    text = (_build.CSRC / "spmm24.cu").read_text()
    src = tmp_path / "spmm24.cu"  # the same name: kernels named alike
    src.write_text(text[:text.index("// --- the wgmma_sp route")])
    lib = tmp_path / "libspmm24.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    alone = collections.Counter(sass_functions(lib).values())
    assert alone and not alone - collections.Counter(funcs.values())


# MiMo-V2-Flash's 2:4 products (M, K, n): q, o, layer 0's gate_up and down
# at 4096 tokens, an expert's gate_up and down at ragged routed rows
MIMO_TALL = [(1536, 4096, 4096), (4096, 1024, 4096), (32768, 4096, 4096),
             (4096, 16384, 4096), (4096, 4096, 64 * 13),
             (4096, 4096, 64 * 17), (4096, 4096, 1024),
             (4096, 2048, 64 * 13), (4096, 2048, 64 * 17),
             (4096, 2048, 1024)]


def _forced_plan(monkeypatch, plan):
    monkeypatch.setattr(spmm24_kernel, "card_wg_plan",
                        lambda *a, **kw: plan)


@pytest.mark.parametrize("m,k,n", MIMO_TALL)
def test_wgmma_sp_tall_unit_at_mimos_products(gen, monkeypatch, m, k, n):
    """wg_plan takes the 256-row unit (its banded walk) at each shape; its
    product is the 128-row unit's bit for bit at the same width and split
    count, and the plain version's (the packed words decoded) within
    2e-2; the call counts as one of the wrapper's wg256 launches."""
    v0, v1, codes, b = _wg_operands(gen, m, n, k)
    packed = spmm24_kernel.pack_wgmma_sp_cuda(v0, v1, codes)
    del v0, v1, codes
    kw = dict(m=m, k_logical=k, out_dtype=torch.bfloat16)
    plan = spmm24_kernel.card_wg_plan(b.get_device(), m, n, k)
    assert isinstance(plan, spmm24_kernel.WgTallPlan), plan
    launches = (spmm24_kernel.spmm24_wg_cuda.launches,
                spmm24_kernel.spmm24_wg_cuda.wg256_launches)
    got = spmm24_kernel.spmm24_wg_cuda(packed, b, **kw)
    assert (spmm24_kernel.spmm24_wg_cuda.launches,
            spmm24_kernel.spmm24_wg_cuda.wg256_launches) == \
        (launches[0] + 1, launches[1] + 1)
    _forced_plan(monkeypatch, spmm24_kernel.wg_forced_plan(
        m, n, k, plan.bn, plan.splits))
    short = spmm24_kernel.spmm24_wg_cuda(packed, b, **kw)
    assert spmm24_kernel.spmm24_wg_cuda.wg256_launches == launches[1] + 1
    assert torch.equal(got, short)
    assert _rel(got, spmm24_kernel.spmm24_wg_plain(packed, b, **kw)) < \
        TOL[torch.bfloat16]


@pytest.mark.parametrize("bn,splits", [(128, 2), (64, 3), (128, 8)])
def test_wgmma_sp_tall_unit_under_split_k(gen, monkeypatch, bn, splits):
    """Split-k plans of the 256-row unit, bands of 1 to all 16 m-tiles:
    the f32 partials and the second pass give the 128-row unit's C at the
    same plan bit for bit, and the plain version's within 2e-2."""
    m, k, n = 4096, 4096, 1024
    v0, v1, codes, b = _wg_operands(gen, m, n, k)
    packed = spmm24_kernel.pack_wgmma_sp_cuda(v0, v1, codes)
    kw = dict(m=m, k_logical=k, out_dtype=torch.bfloat16)
    want = spmm24_kernel.spmm24_wg_plain(packed, b, **kw)
    _forced_plan(monkeypatch, spmm24_kernel.wg_forced_plan(
        m, n, k, bn, splits))
    short = spmm24_kernel.spmm24_wg_cuda(packed, b, **kw)
    tall = spmm24_kernel.wg_forced_plan(m, n, k, bn, splits, rows=256)
    for band in sorted({1, 3, 16, tall.band}):
        _forced_plan(monkeypatch, tall._replace(band=band))
        got = spmm24_kernel.spmm24_wg_cuda(packed, b, **kw)
        assert torch.equal(got, short), band
    assert _rel(short, want) < TOL[torch.bfloat16]


def test_wgmma_sp_tall_unit_refuses_on_the_card(gen, monkeypatch):
    """The 256-row entry refuses M % 256 != 0 and a band below 1 and
    writes nothing; the wrapper raises on its refusal; a forced plan of
    256 rows at M % 256 != 0 raises before any launch."""
    from sparsifyme_tpu_torch import _build

    m, k, n = 384, 256, 128
    v0, v1, codes, b = _wg_operands(gen, m, n, k)
    packed = spmm24_kernel.pack_wgmma_sp_cuda(v0, v1, codes)
    out = torch.full((m, n), 7.0, dtype=torch.bfloat16, device="cuda")
    entry = spmm24_kernel.SPMM24_WG256
    launch = _build.load(entry.lib, entry.name, entry.spec)
    index = b.get_device()
    for rows, band in ((m, 1), (256, 0), (256, -2)):
        assert launch(packed.data_ptr(), b.data_ptr(), out.data_ptr(), 0,
                      rows, n, k, packed.shape[0], 128, 1, 4, band, 1,
                      index, _build.raw_stream(index)) != 0, (rows, band)
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    kw = dict(m=m, k_logical=k, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="256 rows"):
        spmm24_kernel.wg_forced_plan(m, n, k, 128, 1, rows=256)
    before = spmm24_kernel.spmm24_wg_cuda.launches
    tall = spmm24_kernel.spmm24_wg_cuda.wg256_launches
    _forced_plan(monkeypatch, spmm24_kernel.WgTallPlan(128, 1, 4, 1, 1, 1))
    with pytest.raises(RuntimeError, match="spmm24_wg256_launch"):
        spmm24_kernel.spmm24_wg_cuda(packed, b, **kw)
    assert spmm24_kernel.spmm24_wg_cuda.launches == before
    assert spmm24_kernel.spmm24_wg_cuda.wg256_launches == tall


def test_wgmma_sp_enqueue_is_under_its_device_time(gen):
    """At U (784x256x1024, b = 32) the host queues a call of the route's
    wrapper in less time than the card runs it."""
    import time

    from sparsifyme_tpu_torch.utils.timing import time_graph

    rows, n, k = 25088, 256, 1024
    v0, v1, codes, b = _wg_operands(gen, rows, n, k)
    packed = spmm24_kernel.pack_wgmma_sp_cuda(v0, v1, codes)

    def call(pk, y):
        return spmm24_kernel.spmm24_wg_cuda(pk, y, m=rows, k_logical=k,
                                            out_dtype=torch.bfloat16)
    device_ms = time_graph(call, (packed, b), iters=20, reps=5).ms
    for _ in range(5):
        call(packed, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        call(packed, b)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 50
    torch.cuda.synchronize()
    assert enqueue_ms < device_ms, (enqueue_ms, device_ms)


# --- the MoE combine kernel (ops/kernels/moe_kernel.py) ----------------------

# tokens, hidden, experts, held, top, held experts no token chooses
COMBINE_SHAPES = [
    (32768, 4096, 256, 32, 8, ()),  # MiMo-V2-Flash, one card of EP8
    (100, 256, 16, 4, 4, (1,)),  # tokens off the tile, an empty group
    (1, 256, 8, 8, 8, ()),  # one token, all eight choices held
    (130, 264, 16, 3, 2, ()),  # hidden off the tile
    (200, 256, 16, 16, 12, (5,)),  # twelve held choices a token
]


def _combine_operands(shape):
    from sparsifyme_tpu_torch.bench import moe_combine as probe

    tokens, hidden, experts, held, top, empty = shape
    return probe.operands(tokens, hidden, experts, held, top, "cuda",
                          empty=empty)


@pytest.mark.parametrize("shape", COMBINE_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5])))
def test_moe_combine_kernel(gen, shape):
    """The kernel against the plain version: bit for bit on every token
    with at most one held choice, within 1e-6 of the largest value
    elsewhere (f32 sums in another order), the same on a second call; h
    left as it was and not the output."""
    from sparsifyme_tpu_torch.ops.kernels import moe_kernel

    h, d, y = _combine_operands(shape)
    keep = h.clone()
    got = moe_kernel.moe_combine_cuda(h, d.slot, d.weight, y)
    want = moe_kernel.moe_combine_plain(h, d.index, d.weight, y)
    again = moe_kernel.moe_combine_cuda(h, d.slot, d.weight, y)
    torch.cuda.synchronize()
    assert torch.equal(h, keep)
    assert got.shape == h.shape and got.dtype == torch.float32
    assert got.data_ptr() != h.data_ptr()
    assert got.untyped_storage().data_ptr() != h.untyped_storage().data_ptr()
    held = (d.slot >= 0).sum(1)
    one = held <= 1
    assert torch.equal(got[:, one], want[:, one])
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6
    assert torch.equal(got, again)
    for e in shape[5]:
        assert d.rows[e] == 0
    if shape[0] == 32768:  # tokens with no, one and several held choices
        assert {0, 1, 2} <= set(held.clamp(max=2).tolist())


def test_moe_combine_counts_its_launches(gen):
    """Each kernel call moves ``moe_combine_cuda.launches`` and the
    ``moe.combine_kernel`` counter by one; ``moe_combine`` takes the kernel
    on a card."""
    from sparsifyme_tpu_torch.models import moe_transformer as mt
    from sparsifyme_tpu_torch.ops.kernels import moe_kernel
    from sparsifyme_tpu_torch.utils import trace

    h, d, y = _combine_operands(COMBINE_SHAPES[1])
    before = moe_kernel.moe_combine_cuda.launches
    trace.reset()
    with trace.recording():
        got = mt.moe_combine(h, d, y)
        assert moe_kernel.moe_combine_cuda.launches == before + 1
        direct = moe_kernel.moe_combine_cuda(h, d.slot, d.weight, y)
    counters = trace.summary()["counters"]
    trace.reset()
    assert moe_kernel.moe_combine_cuda.launches == before + 2
    assert counters["moe.combine_kernel"] == 2
    assert torch.equal(got, direct)


def test_moe_combine_refuses_what_it_does_not_take(gen):
    """A non-contiguous or wrongly typed operand raises before any
    launch."""
    from sparsifyme_tpu_torch.ops.kernels import moe_kernel

    h, d, y = _combine_operands(COMBINE_SHAPES[1])
    call = moe_kernel.moe_combine_cuda
    before = call.launches
    with pytest.raises(ValueError, match="contiguous"):
        call(h, d.slot, d.weight, y.T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        call(h[:, :50], d.slot[:50], d.weight, y)
    with pytest.raises(TypeError, match="y must be"):
        call(h, d.slot, d.weight, y.float())
    with pytest.raises(TypeError, match="slot must be"):
        call(h, d.slot.long(), d.weight, y)
    with pytest.raises(ValueError, match="do not agree"):
        call(h, d.slot, d.weight[:-1], y)
    assert call.launches == before


# --- the RMSNorm kernel (ops/kernels/norm_kernel.py) -------------------------

# hidden and input dtype of the model cells' norms (bench/rms_norm.py)
NORM_WIDTHS = [(512, torch.bfloat16), (1536, torch.bfloat16),
               (4096, torch.float32), (7168, torch.float32)]
NORM_LAYOUTS = [(True, False), (False, True), (True, True)]


@pytest.mark.parametrize("hidden,dtype", NORM_WIDTHS + [
    (512, torch.float32), (7168, torch.bfloat16), (264, torch.float32)],
    ids=lambda v: str(v).replace("torch.", ""))
@pytest.mark.parametrize("tokens", [32768, 1000, 37])
@pytest.mark.parametrize("feature,token", NORM_LAYOUTS,
                         ids=["feature", "token", "both"])
def test_rms_norm_kernel(gen, hidden, dtype, tokens, feature, token):
    """The kernel against its plain version at the model's widths (and
    float32 at 512, bf16 at 7168, 264 off every block's width), at 32768
    tokens, at 1000 (no whole number of strips) and at 37 (no whole
    16-byte chunk: element by element): every element within one bf16 ulp
    (the f32 sum is taken in another order), the same bits on a second
    call, h left as it was, both layouts the same values."""
    from sparsifyme_tpu_torch.bench import rms_norm as probe
    from sparsifyme_tpu_torch.ops.kernels import norm_kernel

    h, w = probe.operands(hidden, tokens, dtype, "cuda")
    keep = h.clone()
    got = probe.outputs(h, feature, token)
    norm_kernel.rms_norm_cuda(h, w, probe.EPS, *got)
    again = probe.outputs(h, feature, token)
    norm_kernel.rms_norm_cuda(h, w, probe.EPS, *again)
    want = probe.plain(h, w, feature, token)
    torch.cuda.synchronize()
    assert torch.equal(h, keep)
    for g, a, p in zip(got, again, want):
        assert (g is None) == (p is None)
        if p is not None:
            assert probe.ulps(g, p) <= 1
            assert torch.equal(g, a)
    if feature and token:
        assert torch.equal(got[0].T, got[1])


def test_rms_norm_kernel_reads_an_unaligned_h(gen):
    """h at an odd storage offset (no 16-byte chunk aligned) is read
    element by element and gives the aligned h's bits."""
    from sparsifyme_tpu_torch.bench import rms_norm as probe
    from sparsifyme_tpu_torch.ops.kernels import norm_kernel

    h, w = probe.operands(512, 1024, torch.float32, "cuda")
    odd = torch.empty(h.numel() + 1, device="cuda")[1:].view(h.shape)
    odd.copy_(h)
    assert odd.data_ptr() % 16
    outs = [probe.outputs(h, True, True) for _ in range(2)]
    norm_kernel.rms_norm_cuda(h, w, probe.EPS, *outs[0])
    norm_kernel.rms_norm_cuda(odd, w, probe.EPS, *outs[1])
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_rms_norm_counts_its_launches(gen, monkeypatch):
    """Each kernel call moves ``rms_norm_cuda.launches`` and the
    ``norm.kernel`` counter by one, whatever its layouts; on a card the
    model's norms take the kernel and never the plain version, and
    ``rms_norm_layouts`` gives the kernel's bits in each layout."""
    from sparsifyme_tpu_torch.bench import rms_norm as probe
    from sparsifyme_tpu_torch.models import moe_transformer as mt
    from sparsifyme_tpu_torch.ops.kernels import norm_kernel
    from sparsifyme_tpu_torch.utils import trace

    def refuse(*args):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(norm_kernel, "rms_norm_plain", refuse)
    h, w = probe.operands(4096, 1000, torch.float32, "cuda")
    before = norm_kernel.rms_norm_cuda.launches
    trace.reset()
    with trace.recording():
        x = mt.rms_norm(h, w, probe.EPS)
        x2, x_t = mt.rms_norm_layouts(h, w, probe.EPS, True, True)
        y, y_t = mt.rms_norm_layouts(h, w, probe.EPS, False, True)
    counters = trace.summary()["counters"]
    trace.reset()
    assert norm_kernel.rms_norm_cuda.launches == before + 3
    assert counters["norm.kernel"] == 3
    assert y is None and torch.equal(x, x2)
    assert torch.equal(x_t, x.T) and torch.equal(y_t, x_t)


def test_rms_norm_refuses_what_it_does_not_take(gen):
    """A wrongly typed, non-contiguous or mis-shaped operand, hidden not a
    multiple of 8 or past the widest plan, and a call asking for no layout
    raise before any launch."""
    from sparsifyme_tpu_torch.bench import rms_norm as probe
    from sparsifyme_tpu_torch.ops.kernels import norm_kernel

    call = norm_kernel.rms_norm_cuda
    h, w = probe.operands(512, 64, torch.float32, "cuda")
    out, out_t = probe.outputs(h, True, True)
    before = call.launches
    with pytest.raises(TypeError, match="h must be"):
        call(h.half(), w, 1e-6, out)
    with pytest.raises(TypeError, match="w must be"):
        call(h, w.float(), 1e-6, out)
    with pytest.raises(ValueError, match="contiguous"):
        call(h.T.contiguous().T, w, 1e-6, out)
    with pytest.raises(ValueError, match="w must have shape"):
        call(h, w[:-8], 1e-6, out)
    with pytest.raises(ValueError, match="out_t must have shape"):
        call(h, w, 1e-6, None, out)
    with pytest.raises(ValueError, match="bf16"):
        call(h, w, 1e-6, out.float())
    with pytest.raises(ValueError, match="give out"):
        call(h, w, 1e-6)
    h12, _ = probe.operands(12, 64, torch.float32, "cuda")
    with pytest.raises(ValueError, match="hidden % 8"):
        call(h12, torch.ones(12, dtype=torch.bfloat16, device="cuda"),
             1e-6, torch.empty_like(h12, dtype=torch.bfloat16))
    wide, _ = probe.operands(9224, 8, torch.float32, "cuda")
    with pytest.raises(ValueError, match="9216"):
        call(wide, torch.ones(9224, dtype=torch.bfloat16, device="cuda"),
             1e-6, torch.empty_like(wide, dtype=torch.bfloat16))
    assert call.launches == before
