"""The port against the native host library ``libsparsifyme.so`` (the C
ABI of ``cpp/src/sparsifyme/capi.h``), bound by the port's own
``sparsifyme_tpu_torch.native``: a third oracle, bit for bit in f32 at
ragged shapes (k not a multiple of the group, rows not a multiple of 8).

Two differences of the library from the JAX package, which the port
follows, are tested as such: a dropped element is +0.0 in the library and
``w * 0`` in the port (the sign of a negative ``w`` kept, as K1 is held
to), so pruned values are compared with their zeros made +0.0; and a short
last group is padded with zeros in the JAX op and the port, which win a tie
with a zero of the group, while the library ranks the short group alone.

The library is built once per test session into a temporary directory
(cmake + ninja, the ``sparsifyme`` target only), never into ``cpp/build``,
so that parallel test workers do not race on one build tree.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sparsifyme_tpu_torch import native
from sparsifyme_tpu_torch.ops import ell as te
from sparsifyme_tpu_torch.ops import prune as tprune
from sparsifyme_tpu_torch.ops import sparse24 as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def lib_path(tmp_path_factory):
    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        pytest.skip("cmake and ninja are needed to build libsparsifyme.so")
    build = tmp_path_factory.mktemp("native_build")
    for cmd in (["cmake", "-S", os.path.join(ROOT, "cpp"), "-B", str(build),
                 "-G", "Ninja"],
                ["cmake", "--build", str(build), "--target", "sparsifyme"]):
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    return str(build / "libsparsifyme.so")


@pytest.fixture(scope="session")
def lib(lib_path):
    return native.load(lib_path)


RAGGED = [(7, 13), (33, 30), (5, 147), (16, 64), (1, 3)]


def _w(rng, shape, m=4):
    w = rng.standard_normal(shape).astype(np.float32)
    if shape[1] >= m:
        w[0, :2] = 0.0  # zeros tie in a whole group: the later one wins
    return w


def _bits(x: np.ndarray) -> np.ndarray:
    """f32 bits with -0.0 made +0.0."""
    return (np.asarray(x, np.float32) + np.float32(0.0)).view(np.uint32)


def test_abi_and_clock(lib):
    assert lib.abi_version() == 1
    t0 = lib.now_ms()
    assert lib.now_ms() >= t0


def test_load_reads_the_environment(lib_path, monkeypatch, tmp_path):
    monkeypatch.setenv(native.ENV, lib_path)
    assert native.load().path == lib_path
    monkeypatch.setenv(native.ENV, str(tmp_path / "none.so"))
    with pytest.raises(FileNotFoundError, match="cmake"):
        native.load()


def test_read_shapes_matches_the_datasets(lib):
    from sparsifyme_tpu_torch.utils.shapes import read_shapes

    path = os.path.join(ROOT, "datasets", "resnet50.csv")
    assert lib.read_shapes(path) == [tuple(s) for s in read_shapes(path)]


@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (2, 8), (3, 5)])
def test_prune_nm_bit_for_bit(lib, rng, shape, n, m):
    w = _w(rng, shape, m)
    pn, mn = lib.prune_nm(w, n, m)
    pt, mt = tprune.prune_nm(torch.from_numpy(w), n, m)
    assert np.array_equal(_bits(pt.numpy()), pn.view(np.uint32))
    assert np.array_equal(mt.numpy().astype(np.uint8), mn)
    assert lib.prune_check_nm(pn, n, m)
    assert tprune.prune_check_nm(torch.from_numpy(pn), n, m)


def test_the_library_differs_from_jax_on_a_short_group_of_zeros(lib):
    """k = 3 with n = 2, m = 4: JAX and the port pad the group with a zero
    that outranks the zeros at positions 0 and 1, so only position 2 is
    kept; the library ranks the three alone and keeps positions 1 and 2.
    A negative dropped value keeps its sign in the port."""
    import jax.numpy as jnp
    from sparsifyme_tpu.ops import prune as jprune

    w = np.array([[0.0, 0.0, 1.5], [-1.0, 2.0, 3.0]], np.float32)
    pt, mt = tprune.prune_nm(torch.from_numpy(w), 2, 4)
    pj, mj = jprune.prune_nm(jnp.asarray(w), 2, 4)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    assert np.array_equal(pt.numpy().view(np.uint32),
                          np.asarray(pj).view(np.uint32))
    pn, mn = lib.prune_nm(w, 2, 4)
    assert mt.numpy().astype(np.uint8).tolist() == [[0, 0, 1], [0, 1, 1]]
    assert mn.tolist() == [[0, 1, 1], [0, 1, 1]]
    assert pt.numpy().view(np.uint32)[1, 0] == 0x80000000  # -0.0
    assert pn.view(np.uint32)[1, 0] == 0
    assert np.array_equal(pt.numpy(), pn)  # equal as values


@pytest.mark.parametrize("shape", RAGGED)
def test_compress_24_bit_for_bit(lib, rng, shape):
    pn, _ = lib.prune_nm(_w(rng, shape), 2, 4)
    v0, v1, codes = lib.compress_24(pn)
    s = ts.compress_24(torch.from_numpy(pn))
    k4 = v0.shape[1]
    for got, want in ((s.values0, v0), (s.values1, v1)):
        assert np.array_equal(got.numpy().T[:, :k4].view(np.uint32),
                              want.view(np.uint32))
    assert np.array_equal(s.codes.numpy().T[:, :k4], codes)
    assert np.array_equal(lib.decompress_24(v0, v1, codes, shape[1]), pn)
    assert np.array_equal(ts.decompress_24(s).numpy(), pn)


@pytest.mark.parametrize("shape", RAGGED)
def test_pack_codes_bit_for_bit(lib, rng, shape):
    """The port packs adjacent groups of each column (the k-major group
    axis); the library packs a flat array: the same bytes per column."""
    pn, _ = lib.prune_nm(_w(rng, shape), 2, 4)
    _, _, codes = lib.compress_24(pn)  # [rows, k4], a row per column
    k4 = codes.shape[1]
    packed = ts.pack_codes(torch.from_numpy(np.ascontiguousarray(codes.T)))
    for r in range(codes.shape[0]):
        want = lib.pack_codes(codes[r])
        assert np.array_equal(packed[:, r].numpy(), want)
        assert np.array_equal(lib.unpack_codes(want, k4), codes[r])
    unpacked = ts.unpack_codes(packed, k4)
    assert np.array_equal(unpacked.numpy().T, codes)


@pytest.mark.parametrize("rows,cols,bs,ell", [(24, 40, 8, 3), (48, 48, 16, 1),
                                              (32, 96, 32, 2)])
def test_ell_from_dense_bit_for_bit(lib, rng, rows, cols, bs, ell):
    w = rng.standard_normal((rows, cols)).astype(np.float32)
    values, col_indices = lib.ell_from_dense(w, bs, ell)
    e = te.ell_from_dense(torch.from_numpy(w), bs, ell)
    assert np.array_equal(e.col_indices.numpy(), col_indices)
    assert np.array_equal(e.values.numpy().view(np.uint32),
                          values.view(np.uint32))


def test_prune_block_matches(lib, rng):
    w = rng.standard_normal((16, 20)).astype(np.float32)
    pn, mn = lib.prune_block(w, block=(2, 2), sparsity=0.5)
    pt, mt = tprune.prune_block_magnitude(torch.from_numpy(w), (2, 2), 0.5)
    assert np.array_equal(pt.numpy(), pn)
    assert np.array_equal(mt.numpy().astype(np.uint8), mn)


def test_binding_validates_before_the_call(lib):
    with pytest.raises(ValueError, match="2-d"):
        lib.prune_nm(np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="blocks"):
        lib.ell_from_dense(np.zeros((10, 16), np.float32), 8, 1)
    with pytest.raises(ValueError, match="fewer"):
        lib.unpack_codes(np.zeros(1, np.uint8), 3)
