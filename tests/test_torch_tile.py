"""The sparse tensor-core tile of K3 and K7, and the rings' CUDA graphs, on
the CPU.

* The plain emulation of the tile's operand path
  (``spmm24_kernel.sparse_tile_dense``: interleaved plane rows, metadata
  words derived from the codes with the kernel's bit operations, the
  fragment indexing of ``ldmatrix.trans`` and ``mma.sp``) rebuilds exactly
  the dense A of the JAX ``decompress_24`` on the same numpy inputs: fold 1
  and 2, split-half packed codes, k in {64, 147, 1152}, all six 2:4
  patterns and padded groups.
* The one rule that sizes a launch's tile, at K7's ring windows and at the
  17 ResNet-50 shapes.
* The graph cache key of the rings, that CPU meshes never capture, and
  when a key is captured: not at its first call, at its second, and never
  inside a timing loop's timed calls.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsifyme_tpu.ops import prune as jprune
from sparsifyme_tpu.ops import sparse24 as js
from sparsifyme_tpu_torch.convert import sparse24_from_numpy
from sparsifyme_tpu_torch.models.resnet_shapes import resnet_conv_shapes
from sparsifyme_tpu_torch.ops.kernels import spmm24_kernel as k3
from sparsifyme_tpu_torch.ops.sparse24 import pack_codes_fp
from sparsifyme_tpu_torch.parallel import ring_graph, ring_kernel
from sparsifyme_tpu_torch.parallel.mesh import make_mesh
from sparsifyme_tpu_torch.utils import timing

PATTERNS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


@pytest.mark.parametrize("k", [64, 147, 1152])
@pytest.mark.parametrize("fold,packed", [(1, False), (1, True), (2, False)])
def test_sparse_tile_emulation_is_jax_decompress(rng, k, fold, packed):
    m = 96
    a = rng.normal(size=(m, k)).astype(np.float32)
    a = jprune.prune_24(jnp.asarray(a))[0]
    s = (js.compress_24(a) if fold == 1
         else js.prune_compress_24(a, fold=2))
    codes = np.asarray(s.codes)
    present = set(np.unique(codes).tolist())
    assert all(i0 * 4 + i1 in present for i0, i1 in PATTERNS)
    if k % 64:
        assert (codes[-1] == 11).all()  # padded groups: (2, 3), zeros
    v0 = torch.from_numpy(np.array(s.values0, np.float32))
    v1 = torch.from_numpy(np.array(s.values1, np.float32))
    c = torch.from_numpy(codes.copy())
    if packed:
        c = pack_codes_fp(c)
    dense = k3.sparse_tile_dense(v0, v1, c, packed=packed, fold=fold)
    want = np.asarray(js.decompress_24(s), np.float32)
    assert np.array_equal(dense[:, :k].numpy(), want)
    assert not dense[:, k:].any()


def test_nibbles16_swaps_each_code_and_orders_zero_fill():
    codes = [i0 * 4 + i1 for i0, i1 in PATTERNS[:4]]
    word = torch.tensor([sum(c << (8 * j) for j, c in enumerate(codes))])
    want = sum((i0 | i1 << 2) << (4 * j)
               for j, (i0, i1) in enumerate(PATTERNS[:4]))
    assert int(k3.nibbles16(word)) == want
    # a zero-filled byte (past the planes) becomes the ordered (0, 1)
    assert int(k3.nibbles16(torch.tensor([0]))) == 0x4444


def test_transpose4_is_a_byte_transpose():
    x = [torch.tensor([sum((16 * j + i) << (8 * i) for i in range(4))])
         for j in range(4)]
    r = k3.transpose4(x)
    for i in range(4):
        assert int(r[i]) == sum((16 * j + i) << (8 * j) for j in range(4))


@pytest.mark.parametrize("mt,tile,blocks", [(6272, (128, 64), 196),
                                            (896, (64, 64), 56)])
def test_pick_tile_at_the_ring_windows(mt, tile, blocks):
    """K7's steps at 25088 x 256 x 1024 on four ranks: the whole shard
    (6272 columns) gets one block per SM (98 blocks of 128 x 128 before);
    one m-tile (896) cannot, and takes the smallest tile."""
    t = k3.pick_tile(mt, 256, 256)
    bm, bn = k3.SP_TILES[t]
    assert (bm, bn) == tile
    assert -(-mt // bm) * -(-256 // bn) == blocks
    assert blocks >= k3.H100_SMS or t == len(k3.SP_TILES) - 1


@pytest.mark.parametrize(
    "shape", sorted(set(resnet_conv_shapes("resnet50")),
                    key=lambda s: (s.m, s.n, s.k)),
    ids=lambda s: f"{s.m}x{s.n}x{s.k}")
def test_pick_tile_at_the_resnet50_shapes(shape):
    """The largest tile whose grid gives each of the 132 SMs a block (a
    smaller one only when it must), never wider than n past 64, 256 rows
    only for k >= 512 with the last wave at least half full."""
    rows, sms = shape.b * shape.m, k3.H100_SMS

    def blocks(tile):
        bm, bn = k3.SP_TILES[tile]
        return -(-rows // bm) * -(-shape.n // bn)

    def allowed(tile):
        bm, bn = k3.SP_TILES[tile]
        full = blocks(tile) % sms == 0 or blocks(tile) % sms >= sms // 2
        return (bn <= max(shape.n, 64) and blocks(tile) >= sms
                and (bm < 256 or (shape.k >= 512 and full)))

    t = k3.pick_tile(rows, shape.n, shape.k)
    assert allowed(t) or t == len(k3.SP_TILES) - 1
    assert not any(allowed(bigger) for bigger in range(t))


def _key_args():
    g = torch.Generator().manual_seed(0)
    v0 = torch.randn((32, 64), generator=g)
    v1 = torch.randn((32, 64), generator=g)
    codes = torch.full((32, 64), 11, dtype=torch.uint8)
    b = torch.randn((128, 8), generator=g)
    return dict(v0=v0, v1=v1, codes=codes, b=b, shape=(64, 128),
                out_dtype=torch.float32, route="spmm_24_ring_tiled",
                m_tile=16, devices=(torch.device("cpu"),) * 4,
                step=ring_kernel.ring_step_plain)


def _key(kw):
    kw = dict(kw)
    return ring_graph.graph_key(kw.pop("v0"), kw.pop("v1"), kw.pop("codes"),
                                kw.pop("b"), **kw)


@pytest.mark.parametrize("what", ["pointer", "shape", "stride", "dtype",
                                  "out_dtype", "m_tile", "devices", "step",
                                  "route"])
def test_graph_key_tells_calls_apart(what):
    kw = _key_args()
    base = _key(kw)
    assert _key(dict(kw)) == base  # the same call replays
    b = kw["b"]
    if what == "pointer":
        kw["b"] = b.clone()
    elif what == "shape":
        kw["b"] = b[:64]
    elif what == "stride":
        kw["b"] = torch.as_strided(b, (64, 8), (16, 1))
        assert kw["b"].data_ptr() == b.data_ptr()
        kw2 = dict(kw, b=torch.as_strided(b, (64, 8), (8, 1)))
        assert _key(kw2) != _key(kw)
    elif what == "dtype":
        kw["b"] = b.view(torch.int32)
    elif what == "out_dtype":
        kw["out_dtype"] = torch.bfloat16
    elif what == "m_tile":
        kw["m_tile"] = 32
    elif what == "devices":
        kw["devices"] = (torch.device("cpu"),) * 2
    elif what == "step":
        kw["step"] = ring_kernel.ring_step_cuda
    else:
        kw["route"] = "spmm_24_ring_explicit"
    assert _key(kw) != base


def test_cpu_meshes_never_capture(rng):
    """CPU ranks run the schedule eagerly with the plain step; nothing is
    cached, call after call."""
    assert not ring_graph.captures([torch.device("cpu")] * 4)
    assert not ring_graph.captures([torch.device("cuda", 0)] * 2,
                                   torch.zeros(1))
    ring_graph.clear()
    a = rng.normal(size=(256, 256)).astype(np.float32)
    s = js.compress_24(jprune.prune_24(jnp.asarray(a))[0])
    q = sparse24_from_numpy(np.asarray(s.values0), np.asarray(s.values1),
                            np.asarray(s.codes), s.shape, device="cpu")
    b = torch.from_numpy(rng.normal(size=(256, 16)).astype(np.float32))
    mesh = make_mesh((4,), ("model",), devices=["cpu"] * 4)
    outs = [ring_kernel.spmm_24_ring_tiled(q, b, mesh, "model", m_tile=32)
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert not ring_graph._cache


class _FakeGraph:
    """Stands in for a captured ring: ``ring_graph._capture`` is the only
    part of :func:`ring_graph.run` that needs a card."""

    def __init__(self, log, key):
        self.log, self.key = log, key

    def replay(self):
        self.log.append(("replay", self.key))
        return "replayed"


@pytest.fixture
def fake_capture(monkeypatch):
    log = []

    def capture(queue, device, counters):
        log.append(("capture", queue.key))
        return _FakeGraph(log, queue.key)

    monkeypatch.setattr(ring_graph, "_capture", capture)
    ring_graph.clear()
    yield log
    ring_graph.clear()


def _queue(log, key):
    def queue():
        log.append(("eager", key))
        return "eager"
    queue.key = key
    return queue


def test_a_ring_captures_at_its_second_call(fake_capture):
    log = fake_capture
    run = lambda: ring_graph.run(("k",), _queue(log, "k"), None, ())
    assert run() == "eager"
    assert log == [("eager", "k")] and not ring_graph._cache
    assert run() == "replayed"
    assert log[1:] == [("capture", "k"), ("replay", "k")]
    assert run() == "replayed"
    assert log[3:] == [("replay", "k")]


def test_fresh_operands_never_capture(fake_capture):
    """A caller whose operands are at new addresses on every call pays the
    eager ring only; the keys seen once stay bounded."""
    log = fake_capture
    for i in range(ring_graph.SEEN_SIZE + 8):
        assert ring_graph.run(("k", i), _queue(log, i), None, ()) == "eager"
    assert all(what == "eager" for what, _ in log)
    assert not ring_graph._cache
    assert len(ring_graph._seen) == ring_graph.SEEN_SIZE


def test_the_graph_cache_is_a_bounded_lru(fake_capture):
    log = fake_capture
    n = ring_graph.CACHE_SIZE + 2
    for i in range(n):
        for _ in range(2):
            ring_graph.run(("k", i), _queue(log, i), None, ())
    assert list(ring_graph._cache) == [("k", i) for i in range(2, n)]
    ring_graph.run(("k", 2), _queue(log, 2), None, ())
    assert log[-1] == ("replay", 2)
    assert next(iter(ring_graph._cache)) == ("k", 3)


def test_timing_calls_only_replays(monkeypatch):
    """``time_kernel`` warms each operand replica twice, so none of its
    timed calls is a ring's first (eager) or second (capturing) call."""
    seen, timed = collections.Counter(), []
    run_ms = timing._run_ms

    def marked(fn, sets, iters):
        timed.append(True)
        return run_ms(fn, sets, iters)

    def fn(x):
        if timed:
            assert seen[x.data_ptr()] >= 2
        seen[x.data_ptr()] += 1

    monkeypatch.setattr(timing, "_run_ms", marked)
    timing.time_kernel(fn, (torch.zeros(16),), iters=8, reps=2)
    assert len(seen) == 6 and timed
