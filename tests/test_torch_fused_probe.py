"""The probes of K2's fused route (``sparsifyme_tpu_torch.bench.fused_probe``)
against ``experiments/tpu_fused_probe.py`` on the CPU.

The JAX script runs its sweep at import, so its source is read up to the
sweep (``t0 = time.time()``) and executed, with
``JAX_COMPILATION_CACHE_DIR`` (which it sets with ``setdefault``) pointed at
a temporary directory first; nothing in ``experiments/`` changes. Each of
its kernels runs through ``pl.pallas_call(..., interpret=True)`` on the
tile K2 takes for the same input (``prune_kernel.compress_plan``: 64 x 128
whole rows at k = 128, 128 x 64 at k = 256, narrower than the 128 columns
``kernel_io`` slices) and on the same numpy input, against the port's plain
version:

* ``io`` and ``rank`` (sums of bf16 values in another order) within 2e-2,
  codes exactly;
* ``dot1``: v0, v1 and the codes exactly (the codes wrap: -1 is 255);
* ``rm``: bit for bit, and the planes of ``compress_24`` transposed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsifyme_tpu_torch.bench import fused_probe as fp
from sparsifyme_tpu_torch.ops.kernels.prune_kernel import (compress_24_plain,
                                                           compress_plan)

KERNELS = {"io": "kernel_io", "rank": "kernel_rank", "dot1": "kernel_dot1",
           "rm": "kernel_rm"}


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """The JAX script's definitions, without its sweep."""
    path = "experiments/tpu_fused_probe.py"
    with open(path) as f:
        src = f.read()
    src = src[:src.index("t0 = time.time()")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR",
                  str(tmp_path_factory.mktemp("jax_cache")))
        mp.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
        names = {"__name__": "tpu_fused_probe"}
        exec(compile(src, path, "exec"), names)
    return names


def _jax_planes(probe, mode, x, r, kt):
    """The JAX kernel of ``mode`` on ``x [rows, kp]`` (bf16) in tiles of
    ``r`` rows by ``kt`` columns, interpreted."""
    pl = probe["pl"]
    rows, kp = x.shape
    if mode == "rm":
        spec = pl.BlockSpec((r, kt // 4), lambda i, j: (i, j))
        shape = (rows, kp // 4)
    else:
        spec = pl.BlockSpec((kt // 4, r), lambda i, j: (j, i))
        shape = (kp // 4, rows)
    out = pl.pallas_call(
        functools.partial(probe[KERNELS[mode]], bk=kt),
        grid=(rows // r, kp // kt),
        in_specs=[pl.BlockSpec((r, kt), lambda i, j: (i, j))],
        out_specs=[spec] * 3,
        out_shape=[jax.ShapeDtypeStruct(shape, jnp.bfloat16)] * 2
        + [jax.ShapeDtypeStruct(shape, jnp.uint8)],
        interpret=True)(jnp.asarray(x, jnp.bfloat16))
    v0, v1, codes = (np.array(o.astype(jnp.float32)) for o in out)
    return (torch.from_numpy(v0).to(torch.bfloat16),
            torch.from_numpy(v1).to(torch.bfloat16),
            torch.from_numpy(codes).to(torch.uint8))


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("mode", ["io", "rank", "dot1", "rm"])
@pytest.mark.parametrize("rows,k", [(256, 128), (256, 256), (384, 192)])
def test_fused_probe_is_the_jax_probe(probe, rng, mode, rows, k):
    x = rng.standard_normal((rows, k)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    plan = compress_plan(rows, k, 2)
    r, kt = plan.rows_per_tile, plan.k_tile
    want = _jax_planes(probe, mode, xt.float().numpy(), r, kt)
    got = fp.fused_plain(xt, mode)
    if mode in ("io", "rank"):
        for g, w in zip(got[:2], want[:2]):
            assert _rel(g, w) <= 2e-2
        assert torch.equal(got[2], want[2])
        assert (got[2] == 1).all()
    else:
        assert all(torch.equal(g, w) for g, w in zip(got, want)), mode
    if mode == "dot1":
        assert (got[2] == 255).any() and torch.equal(got[0], got[1])
    if mode == "rm":
        planes = compress_24_plain(xt)
        assert all(torch.equal(g, p.T) for g, p in zip(got, planes))


@pytest.mark.parametrize("rows,k", [(1001, 147), (77, 300), (8, 1)])
def test_fused_plain_on_ragged_shapes(rng, rows, k):
    """Rows past the last tile and columns past k read as zero: io's tile
    sums of the padded input, rank's of the planes, dot1 from v0."""
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32))
    x = x.to(torch.bfloat16)
    plan = compress_plan(rows, k, 2)
    r, kt = plan.rows_per_tile, plan.k_tile
    kp = -(-k // 64) * 64
    xp = torch.zeros((-(-rows // r) * r, kp))
    xp[:rows, :k] = x.float()
    v0, v1, codes = compress_24_plain(x)
    io = fp.fused_plain(x, "io")
    rank = fp.fused_plain(x, "rank")
    dot1 = fp.fused_plain(x, "dot1")
    for i, j in ((0, 0), (rows - 1, kp // 4 - 1)):  # column i, group j
        ti, tj = i // r, 4 * j // kt
        head = xp[ti * r:ti * r + 8, tj * kt:tj * kt + min(128, kt)].sum()
        assert io[0][j, i] == head.to(torch.bfloat16)
        g0 = v0.float()[tj * kt // 4:(tj + 1) * kt // 4, ti * r:(ti + 1) * r]
        assert rank[0][j, i] == g0.sum().to(torch.bfloat16)
    assert torch.equal(dot1[0], v0) and torch.equal(dot1[1], v0)
    assert torch.equal(dot1[2], v0.float().to(torch.int32).to(torch.uint8))
    assert io[0].shape == (kp // 4, rows) and (io[2] == 1).all()


def test_fused_wrappers_refuse_cpu_tensors(rng):
    """``fused_cuda`` launches its kernel or raises; both versions refuse a
    mode that is not one of the four."""
    x = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    x = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fp.fused_cuda(x, "io")
    with pytest.raises(ValueError, match="CUDA"):
        fp.check(x, "rm")
    with pytest.raises(ValueError, match="is not one of"):
        fp.fused_plain(x, "dot2")
    with pytest.raises(ValueError, match="is not one of"):
        fp.fused_cuda(x, "dot2")


def test_fused_probe_shapes_and_floor():
    """The JAX script's shapes; its floor, 3.25 bytes an element."""
    assert fp.SHAPES == [(12544 * 32, 256), (12544 * 32, 576)]
    assert fp.floor_ms(1000, 64, 3350.0) == pytest.approx(
        1000 * 64 * 3.25 / 3350e9 * 1e3)
