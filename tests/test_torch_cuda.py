"""The Hopper kernels and routes against their plain versions on the card,
at small and ragged shapes the ResNet-50 sweep does not reach (group sizes
other than 4, n not a multiple of 64, M not a multiple of the tile, every
ELL tile geometry, mixed input types), through both the bf16 fast paths
(M and n multiples of 8) and the simple kernels: K1 prune, K2 compress and
its fused prune+compress route, K3 2:4 SpMM and its fold=2 route, K4 ELL
gather SpMM and K5 ELL expand SpMM.

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
