"""Port parity: the mesh, the sharded 2:4 SpMMs and both rings (K7's plain
version on CPU ranks) against the JAX package on the same numpy inputs.

JAX runs on the 8-device virtual CPU mesh that ``tests/conftest.py``
forces, its Pallas rings in interpret mode as its own tests run them; the
port runs on ``make_mesh(devices=["cpu"] * P)``. Both get the same
compressed planes (the JAX compress, converted bit for bit). Products
agree within 1e-4 relative in f32: the sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from sparsifyme_tpu.ops import prune as jprune
from sparsifyme_tpu.ops import sparse24 as js
from sparsifyme_tpu.parallel import mesh as jmesh
from sparsifyme_tpu.parallel import ring_kernel as jrk
from sparsifyme_tpu.parallel import spmm_sharded as jsh
from sparsifyme_tpu_torch.containers import Sparse24
from sparsifyme_tpu_torch.convert import (sparse24_from_numpy,
                                          tensor_from_numpy, tensor_to_numpy)
from sparsifyme_tpu_torch.parallel import mesh as tmesh
from sparsifyme_tpu_torch.parallel import ring_kernel as trk
from sparsifyme_tpu_torch.parallel import spmm_sharded as tsh

TOL = 1e-4


def _problem(rng, batch, m, k, n):
    """(JAX Sparse24, JAX B, port Sparse24, port B) of one pruned f32
    ``[batch, m, k]`` A and ``[k, n]`` B; batch 0 means unbatched."""
    shape = (batch, m, k) if batch else (m, k)
    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    s = js.compress_24(jprune.prune_24(jnp.asarray(a))[0])
    q = sparse24_from_numpy(np.asarray(s.values0), np.asarray(s.values1),
                            np.asarray(s.codes), s.shape, device="cpu")
    return s, jnp.asarray(b), q, tensor_from_numpy(b, "cpu")


def _jmesh(p):
    return JMesh(np.array(jax.devices()[:p]), ("model",))


def _tmesh(p, shape=None, axes=("model",)):
    return tmesh.make_mesh(shape or (p,), axes, devices=["cpu"] * p)


def _rel(j, t):
    ref = np.asarray(j, np.float32)
    got = tensor_to_numpy(t)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("shape,axes", [
    (None, ("data", "model")), (None, ("x",)), ((2, 4), ("data", "model")),
    ((4, 2), ("data", "model")), (None, ("a", "b", "c"))])
def test_make_mesh_shapes(shape, axes):
    want = jmesh.make_mesh(shape, axes)
    got = tmesh.make_mesh(shape, axes, devices=["cpu"] * 8)
    assert got.devices.shape == want.devices.shape
    assert got.shape == dict(want.shape)
    assert got.devices.size == want.devices.size == 8
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_make_mesh_refusals():
    with pytest.raises(ValueError, match="device count"):
        tmesh.make_mesh((3, 2), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="cuda devices or cpu"):
        tmesh.make_mesh((2,), ("x",), devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="cuda devices or cpu"):
        tmesh.make_mesh((1,), ("x",), devices=["meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()


def test_axis_devices_and_placement():
    mesh = tmesh.make_mesh((2, 4), devices=["cpu"] * 8)
    assert len(mesh.axis_devices("model")) == 4
    assert len(mesh.axis_devices("data")) == 2
    x = torch.arange(16.0).reshape(8, 2)
    shards = tmesh.shard_batch(x, mesh, axis="data")
    assert len(shards) == 8
    # ranks (i, j) hold batch rows of data index i, as P("data") places them
    for r, sh in enumerate(shards):
        assert torch.equal(sh, x[(r // 4) * 4:(r // 4 + 1) * 4])
    assert all(torch.equal(t, x) for t in tmesh.replicate(x, mesh))
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_batch(x[:7], mesh, axis="data")


def test_init_distributed_is_a_noop_for_one_process():
    tmesh.init_distributed()
    tmesh.init_distributed("localhost:1", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()


def test_batch_sharded_matches_jax(rng):
    s, b, q, tb = _problem(rng, 8, 16, 64, 24)
    want = jsh.spmm_24_batch_sharded(
        s, b, jmesh.make_mesh((2, 4), ("data", "model")), axis="data")
    got = tsh.spmm_24_batch_sharded(q, tb, _tmesh(8, (2, 4),
                                                  ("data", "model")),
                                    axis="data")
    assert got.shape == want.shape and _rel(want, got) < TOL
    s3, b3, q3, tb3 = _problem(rng, 3, 8, 64, 8)
    with pytest.raises(ValueError, match="not divisible"):
        jsh.spmm_24_batch_sharded(s3, b3, _jmesh(2), axis="model")
    with pytest.raises(ValueError, match="not divisible"):
        tsh.spmm_24_batch_sharded(q3, tb3, _tmesh(2), axis="model")


@pytest.mark.parametrize("batch", [0, 2])
def test_row_sharded_matches_jax(rng, batch):
    s, b, q, tb = _problem(rng, batch, 64, 32, 16)
    want = jsh.spmm_24_row_sharded(
        s, b, jmesh.make_mesh((2, 4), ("data", "model")), axis="model")
    got = tsh.spmm_24_row_sharded(q, tb, _tmesh(8, (2, 4),
                                                ("data", "model")),
                                  axis="model")
    assert got.shape == want.shape and _rel(want, got) < TOL


@pytest.mark.parametrize("batch,m,k,n", [(0, 32, 128, 16), (8, 16, 128, 24),
                                         (4, 16, 256, 8)])
def test_ring_matches_jax(rng, batch, m, k, n):
    """The ppermute ring on a 4-way axis of the 2 x 4 mesh."""
    s, b, q, tb = _problem(rng, batch, m, k, n)
    want = jsh.spmm_24_ring(s, b, jmesh.make_mesh((2, 4), ("data", "model")),
                            axis="model", out_dtype=jnp.float32)
    got = tsh.spmm_24_ring(q, tb, _tmesh(8, (2, 4), ("data", "model")),
                           axis="model", out_dtype=torch.float32)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(want, got) < TOL


def test_ring_uneven_fold_raises_in_both(rng):
    s, b, q, tb = _problem(rng, 3, 18, 128, 8)  # 54 folded rows, 4-way
    with pytest.raises(ValueError, match="not divisible"):
        jsh.spmm_24_ring(s, b, _jmesh(4), axis="model")
    with pytest.raises(ValueError, match="not divisible"):
        tsh.spmm_24_ring(q, tb, _tmesh(4), axis="model")


@pytest.mark.parametrize("k,p", [(64, 1), (128, 2), (256, 4), (96, 3)])
def test_ring_permute_b_bit_equal(rng, k, p):
    b = rng.normal(size=(k, 5)).astype(np.float32)
    want = np.asarray(jrk.ring_permute_b(jnp.asarray(b), p))
    got = tensor_to_numpy(trk.ring_permute_b(tensor_from_numpy(b, "cpu"), p))
    assert np.array_equal(want, got)
    with pytest.raises(ValueError, match="not divisible"):
        trk.ring_permute_b(tensor_from_numpy(b[:k - 4], "cpu"), 4 * p)


@pytest.mark.parametrize("mloc", [128, 256, 384, 896, 1000, 2048, 6272,
                                  4096, 100])
def test_pick_mt_matches_jax(mloc):
    assert trk._pick_mt(mloc) == jrk._pick_mt(mloc)
    assert trk._pick_mt(mloc, cap=512) == jrk._pick_mt(mloc, cap=512)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_ring_explicit_matches_pallas(rng, p):
    s, b, q, tb = _problem(rng, 2, 32, 128, 24)
    want = jrk.spmm_24_ring_pallas(s, b, _jmesh(p), "model",
                                   out_dtype=jnp.float32)
    got = trk.spmm_24_ring_explicit(q, tb, _tmesh(p), "model",
                                    out_dtype=torch.float32)
    assert got.shape == want.shape and _rel(want, got) < TOL


@pytest.mark.parametrize("p", [2, 4])
def test_ring_tiled_matches_pallas(rng, p):
    """Two m-tiles of 128 columns per rank."""
    s, b, q, tb = _problem(rng, 0, 256 * p, 64 * p, 24)
    want = jrk.spmm_24_ring_tiled_pallas(s, b, _jmesh(p), "model",
                                         out_dtype=jnp.float32, m_tile=128)
    got = trk.spmm_24_ring_tiled(q, tb, _tmesh(p), "model",
                                 out_dtype=torch.float32, m_tile=128)
    assert got.shape == want.shape and _rel(want, got) < TOL


@pytest.mark.parametrize("p", [3, 8])
@pytest.mark.parametrize("tiled", [False, True])
def test_rings_at_odd_and_full_width_match_jax_ring(rng, p, tiled):
    """P = 3 (the odd-P credit branch, ``last_odd = P - 2``) and P = 8
    against the JAX ppermute ring: JAX's interpreter starves with every
    host device in a Pallas ring."""
    s, b, q, tb = _problem(rng, 2, 128 * p, 64 * p, 16)
    want = jsh.spmm_24_ring(s, b, _jmesh(p), "model", out_dtype=jnp.float32)
    if tiled:
        got = trk.spmm_24_ring_tiled(q, tb, _tmesh(p), "model",
                                     out_dtype=torch.float32, m_tile=128)
    else:
        got = trk.spmm_24_ring_explicit(q, tb, _tmesh(p), "model",
                                        out_dtype=torch.float32)
    assert got.shape == want.shape and _rel(want, got) < TOL


@pytest.mark.parametrize("case", ["2d", "rows", "k4", "m_tile"])
def test_rings_refuse_what_pallas_refuses(rng, case):
    s, b, q, tb = _problem(rng, 0, 96, 128, 8)  # 96 rows, k4 = 32
    kw = {}
    jm, tm = _jmesh(4), _tmesh(4)
    if case == "2d":
        jm = jmesh.make_mesh((2, 4), ("data", "model"))
        tm, match = _tmesh(8, (2, 4), ("data", "model")), "1-D mesh"
    elif case == "rows":  # 96 rows over 5
        jm, tm, match = _jmesh(5), _tmesh(5), "rows 96 % P 5"
    elif case == "k4":  # 480 rows, k4 = 32 over 5
        s, b, q, tb = _problem(rng, 0, 96 * 5, 128, 8)
        jm, tm, match = _jmesh(5), _tmesh(5), "k4 32 % P 5"
    else:
        kw, match = dict(m_tile=64), "must divide mloc 24"
    with pytest.raises(ValueError, match=match):
        jrk.spmm_24_ring_tiled_pallas(s, b, jm, "model", **kw)
    with pytest.raises(ValueError, match=match):
        trk.spmm_24_ring_tiled(q, tb, tm, "model", **kw)
    if case != "m_tile":
        with pytest.raises(ValueError, match=match):
            jrk.spmm_24_ring_pallas(s, b, jm, "model")
        with pytest.raises(ValueError, match=match):
            trk.spmm_24_ring_explicit(q, tb, tm, "model")


def test_ring_step_window_offsets(rng):
    """The element offset K7's wrapper adds to a plane window's pointer
    addresses the same elements as the window slice."""
    base = torch.arange(64 * 40, dtype=torch.float32).reshape(64, 40)
    planes = base[:, 10:30]  # a rank's column slab: row stride 40
    for src, k4s, c0 in [(0, 16, 0), (2, 16, 5), (3, 16, 12), (1, 32, 7)]:
        off = trk.plane_window(planes, src, k4s, c0)
        win = torch.as_strided(base, (k4s, 20 - c0), (planes.stride(0), 1),
                               planes.storage_offset() + off)
        assert torch.equal(win, planes[src * k4s:(src + 1) * k4s, c0:])


@pytest.mark.parametrize("first,last", [(True, False), (False, False),
                                        (False, True), (True, True)])
def test_ring_step_plain_flags(rng, first, last):
    """K7's plain version: ``first`` writes, later steps add, ``last``
    writes acc + part to C's window in C's type and leaves acc alone."""
    _, _, q, _ = _problem(rng, 0, 48, 128, 8)
    slot = torch.randn(64, 8)  # k4s = 16: the ring's second k-slice of 2
    acc0 = torch.randn(48, 8)
    acc, out = acc0.clone(), torch.zeros(48, 8, dtype=torch.bfloat16)
    trk.ring_step_plain(q.values0, q.values1, q.codes, slot, acc, out,
                        src=1, c0=8, mt=32, first=first, last=last)
    a_t = Sparse24(q.values0[16:32, 8:40], q.values1[16:32, 8:40],
                   q.codes[16:32, 8:40], shape=(32, 64))
    from sparsifyme_tpu_torch.ops.sparse24 import decompress_24

    part = decompress_24(a_t) @ slot + (0 if first else acc0[8:40])
    if last:
        assert torch.equal(acc, acc0)
        assert torch.equal(out[8:40], part.to(torch.bfloat16))
        assert not out[:8].any() and not out[40:].any()
    else:
        assert torch.allclose(acc[8:40], part, rtol=1e-6, atol=1e-5)
        assert torch.equal(acc[:8], acc0[:8]) and not out.any()
