"""Port parity: N:M prune (K1's plain version) and block top-k prune.

The same numpy inputs go through the JAX package (on the CPU; the Pallas
kernel interpreted) and through ``sparsifyme_tpu_torch`` on the CPU.
Pruning is exact: masks and values must be bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsifyme_tpu.ops import prune as jprune
from sparsifyme_tpu.ops.kernels.prune_kernel import prune_nm_pallas
from sparsifyme_tpu_torch.convert import tensor_from_numpy, tensor_to_numpy
from sparsifyme_tpu_torch.ops import prune as tprune

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _both(arr, jdt):
    """One numpy array in the JAX dtype, as a JAX array and a CPU tensor."""
    x = np.asarray(jnp.asarray(arr, jdt))
    return jnp.asarray(x), tensor_from_numpy(x, "cpu")


def _eq(j, t):
    return np.array_equal(np.asarray(j, np.float32), tensor_to_numpy(t))


@pytest.mark.parametrize("shape,n,m", [
    ((2, 24, 147), 2, 4),
    ((64, 256), 2, 4),
    ((8, 66), 1, 4),
    ((3, 5, 24), 2, 8),
    ((4, 21), 2, 8),
])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_prune_nm_matches_jax(rng, shape, n, m, jdt, tdt):
    jw, tw = _both(rng.normal(size=shape), jdt)
    pw, pm = jprune.prune_nm(jw, n, m)
    gw, gm = prune_nm_pallas(jw, n, m, interpret=True)
    qw, qm = tprune.prune_nm(tw, n, m)
    assert qw.dtype == tdt and qm.dtype == tdt
    assert _eq(pw, qw) and _eq(pm, qm)
    assert _eq(gw, qw) and _eq(gm, qm)


@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (2, 8)])
def test_prune_nm_ties_match_jax(rng, n, m):
    # Magnitudes from {0, 1, 2}: nearly every group has ties, and the
    # later position must win them, including against the zero padding
    # of the ragged last group (k = 27).
    w = rng.integers(-2, 3, size=(16, 27)).astype(np.float32)
    jw, tw = _both(w, jnp.float32)
    pw, pm = jprune.prune_nm(jw, n, m)
    gw, gm = prune_nm_pallas(jw, n, m, interpret=True)
    qw, qm = tprune.prune_nm(tw, n, m)
    assert _eq(pw, qw) and _eq(pm, qm)
    assert _eq(gw, qw) and _eq(gm, qm)


def test_prune_nm_tie_rule_pinned():
    w = torch.tensor([[1.0, -1.0, 1.0, -1.0, 0.0, 0.0, 2.0, 2.0]])
    pw, _ = tprune.prune_nm(w, 2, 4)
    assert pw[0, :4].tolist() == [0.0, 0.0, 1.0, -1.0]
    assert pw[0, 4:].tolist() == [0.0, 0.0, 2.0, 2.0]


@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (3, 5), (0, 4)])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_prune_nm_special_values_match_jax(rng, n, m, jdt, tdt):
    """NaN, +-Inf and +-0, the values K1 is held to bit for bit against
    this plain version: the same mask as JAX's ``prune_nm``, and the same
    pruned values (``w * mask``: a dropped member is a zero of its sign,
    NaN for an infinite one), the sign of every zero included."""
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 2.0],
                       np.float32)
    jw, tw = _both(special[rng.integers(0, 8, size=(16, 27))], jdt)
    pw, pm = jprune.prune_nm(jw, n, m)
    qw, qm = tprune.prune_nm(tw, n, m)
    assert qw.dtype == tdt and _eq(pm, qm)
    a, b = np.asarray(pw, np.float32), tensor_to_numpy(qw)
    nan = np.isnan(a)
    assert nan.any() and np.array_equal(nan, np.isnan(b))
    assert np.array_equal(a[~nan], b[~nan])
    assert np.array_equal(np.signbit(a[~nan]), np.signbit(b[~nan]))


def test_prune_check_nm_matches_jax(rng):
    w = rng.normal(size=(6, 40)).astype(np.float32)
    jw, tw = _both(w, jnp.float32)
    pw, _ = tprune.prune_nm(tw, 2, 4)
    assert tprune.prune_check_24(pw)
    assert not tprune.prune_check_24(tw)
    assert tprune.prune_check_nm(tw, 4, 4)
    assert bool(jprune.prune_check_nm(jw, 2, 4)) == tprune.prune_check_nm(
        tw, 2, 4)


@pytest.mark.parametrize("shape,bs,ell,bk", [
    ((2, 32, 128), 16, 2, 32),
    ((256, 192), 128, 3, 32),
    ((64, 128), 16, 1, 0),
])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_prune_block_topk_matches_jax(rng, shape, bs, ell, bk, jdt, tdt):
    jw, tw = _both(rng.normal(size=shape), jdt)
    pw, pc = jprune.prune_block_topk(jw, bs, ell, bk)
    qw, qc = tprune.prune_block_topk(tw, bs, ell, bk)
    assert qc.dtype == torch.int32
    assert np.array_equal(np.asarray(pc), tensor_to_numpy(qc))
    assert _eq(pw, qw)


def test_prune_block_topk_ties_keep_lower_index():
    # Every block has the same norm: both keep the lowest block indices,
    # the order of jax.lax.top_k and of a stable descending sort.
    w = np.ones((2, 32, 96), np.float32)
    pw, pc = jprune.prune_block_topk(jnp.asarray(w), 16, 2, 16)
    qw, qc = tprune.prune_block_topk(tensor_from_numpy(w, "cpu"), 16, 2, 16)
    assert np.array_equal(np.asarray(pc), tensor_to_numpy(qc))
    assert tensor_to_numpy(qc)[0, 0].tolist() == [0, 1]
    assert _eq(pw, qw)


def test_prune_block_topk_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tprune.prune_block_topk(torch.zeros(30, 64), 16, 1, 32)
    with pytest.raises(ValueError):
        tprune.prune_block_topk(torch.zeros(32, 64), 16, 3, 32)


@pytest.mark.parametrize("threshold", [0.5, 1.0, 1.5])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_prune_threshold_matches_jax(rng, threshold, jdt, tdt):
    jw, tw = _both(rng.normal(size=(3, 24, 40)), jdt)
    pw, pm = jprune.prune_threshold(jw, threshold=threshold)
    qw, qm = tprune.prune_threshold(tw, threshold)
    assert qw.dtype == tdt and qm.dtype == tdt
    assert _eq(pw, qw) and _eq(pm, qm)


@pytest.mark.parametrize("shape,block,sparsity", [
    ((16, 24), (2, 2), 0.5),
    ((2, 16, 32), (4, 4), 0.75),
    ((8, 12), (1, 4), 0.5),
    ((3, 4, 16), (2, 8), 0.3),
    ((8, 8), (2, 2), 0.2),  # drops nothing
])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_prune_block_magnitude_matches_jax(rng, shape, block, sparsity,
                                           ties, jdt, tdt):
    w = (rng.integers(-2, 3, size=shape) if ties
         else rng.normal(size=shape)).astype(np.float32)
    jw, tw = _both(w, jdt)
    pw, pm = jprune.prune_block_magnitude(jw, block=block, sparsity=sparsity)
    qw, qm = tprune.prune_block_magnitude(tw, block, sparsity)
    assert qw.dtype == tdt and qm.dtype == tdt
    assert _eq(pw, qw) and _eq(pm, qm)


def test_prune_block_magnitude_tie_rule_pinned():
    """Later positions survive ties, as the JAX code ranks them (its
    docstring says earlier ones do)."""
    for w, block, keep in (([[1.0, 2.0, 2.0, 2.0]], (1, 4),
                            [[0.0, 0.0, 1.0, 1.0]]),
                           ([[1.0, -1.0], [1.0, 1.0]], (2, 2),
                            [[0.0, 0.0], [1.0, 1.0]])):
        w = np.asarray(w, np.float32)
        jw, tw = _both(w, jnp.float32)
        _, jm = jprune.prune_block_magnitude(jw, block=block, sparsity=0.5)
        _, qm = tprune.prune_block_magnitude(tw, block, 0.5)
        assert tensor_to_numpy(qm).tolist() == keep
        assert _eq(jm, qm)


def test_prune_block_magnitude_rejects_bad_shapes():
    with pytest.raises(ValueError, match="divisible"):
        tprune.prune_block_magnitude(torch.zeros(6, 5), (2, 2), 0.5)
