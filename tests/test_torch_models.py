"""Port parity of the model layer: the conv layers, the sparse MLP, its
dp x tp train step and the entry points, against the JAX package on the
same numpy inputs.

JAX runs on the 8-device virtual CPU mesh that ``tests/conftest.py``
forces (its ``shard_map`` train step on a ``(dp, tp)`` sub-mesh); the port
runs its plain versions on ``["cpu"] * P`` ranks. Weights go across bit
for bit: the conv layers are built from the same dense OIHW weight on both
sides (prune, compress and the ELL packing are exact), the MLP's
parameters are the JAX ``init_params`` output through
``convert.mlp_params_from_numpy``. Products agree within 1e-4 relative in
f32 and 2e-2 in bf16; the train step within 1e-5 in f32.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from sparsifyme_tpu.containers import BlockedEll as JEll
from sparsifyme_tpu.models import sparse_conv as jconv
from sparsifyme_tpu.models import sparse_mlp as jmlp
from sparsifyme_tpu_torch import entry as tentry
from sparsifyme_tpu_torch.convert import (mlp_params_from_numpy,
                                          mlp_params_to_numpy,
                                          tensor_from_numpy, tensor_to_numpy)
from sparsifyme_tpu_torch.models import sparse_conv as tconv
from sparsifyme_tpu_torch.models import sparse_mlp as tmlp
from sparsifyme_tpu_torch.ops import prune as tprune
from sparsifyme_tpu_torch.ops.sparse24 import decompress_24
from sparsifyme_tpu_torch.parallel import collectives
from sparsifyme_tpu_torch.parallel.mesh import make_mesh, shard

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MESHES = [(1, 1), (1, 2), (2, 2), (2, 4)]
CONFIG = dict(dims=(32, 64, 32))
LR = 1e-2
STEPS = 3


def _np(a):
    """A JAX array or a port tensor as f32 numpy (bf16 exactly)."""
    if isinstance(a, torch.Tensor):
        return tensor_to_numpy(a).astype(np.float32)
    return np.asarray(a, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _both(arr, dtype):
    """The same numpy values as a JAX array and a CPU tensor of ``dtype``."""
    j = jnp.asarray(arr, JDT[dtype])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


# --------------------------------------------------------------------------
# im2col and the conv layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(11, 11), (12, 12), (9, 14)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [(3, 3), (7, 7), (1, 1)])
def test_im2col_matches_jax(rng, hw, padding, stride, kernel):
    """Exactly XLA's patches, its asymmetric "SAME" padding at stride 2 on
    even sizes included, in ``(in_ch, kh, kw)`` feature order."""
    x = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    want = np.asarray(jconv.im2col(jnp.asarray(x), *kernel, stride, padding))
    got = tensor_to_numpy(tconv.im2col(torch.from_numpy(x), *kernel, stride,
                                       padding))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (2, "VALID")])
def test_patch_columns_equal_the_unfold_route(rng, stride, padding):
    """The layers' B, gathered from a strided view of the padded input,
    equals the route ``bench/conv_probe.py`` times beside it
    (``F.unfold``) and im2col's patches transposed."""
    from sparsifyme_tpu_torch.bench.conv_probe import unfold_columns

    x = torch.from_numpy(rng.normal(size=(3, 12, 11, 6)).astype(np.float32))
    got, oh, ow = tconv._patch_columns(x, 3, 3, stride, padding)
    assert torch.equal(got, unfold_columns(x, 3, 3, stride, padding))
    p = tconv.im2col(x, 3, 3, stride, padding)
    assert p.shape[1:3] == (oh, ow)
    assert torch.equal(got, p.reshape(-1, p.shape[-1]).T)


def test_xla_padding_is_not_symmetric_at_stride_2():
    assert tconv.xla_padding(8, 3, 2, "SAME") == (0, 1)
    assert tconv.xla_padding(224, 7, 2, "SAME") == (2, 3)
    assert tconv.xla_padding(9, 3, 2, "SAME") == (1, 1)
    assert tconv.xla_padding(9, 3, 2, "VALID") == (0, 0)
    with pytest.raises(ValueError, match="SAME"):
        tconv.xla_padding(9, 3, 1, "FULL")


def test_conv_weight_as_matrix(rng):
    w = rng.normal(size=(16, 3, 7, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tensor_to_numpy(tconv.conv_weight_as_matrix(torch.from_numpy(w))),
        np.asarray(jconv.conv_weight_as_matrix(jnp.asarray(w))))


CONV_CASES = [((32, 16, 3, 3), (2, 13, 13, 16), 2, "SAME"),
              ((32, 16, 3, 3), (2, 12, 12, 16), 2, "SAME"),
              ((16, 3, 7, 7), (2, 16, 16, 3), 2, "SAME"),
              ((32, 8, 3, 3), (2, 11, 9, 8), 1, "VALID"),
              ((16, 32, 1, 1), (2, 8, 8, 32), 1, "SAME")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wshape,xshape,stride,padding", CONV_CASES)
def test_sparse_conv_matches_jax(rng, dtype, wshape, xshape, stride,
                                 padding):
    jw, tw = _both(rng.normal(size=wshape), dtype)
    jx, tx = _both(rng.normal(size=xshape), dtype)
    jl = jconv.SparseConv2d(jw, stride=stride, padding=padding)
    tl = tconv.SparseConv2d(tw, stride=stride, padding=padding)
    for j, t in ((jl.weight.values0, tl.values0),
                 (jl.weight.values1, tl.values1),
                 (jl.weight.codes, tl.codes)):
        np.testing.assert_array_equal(_np(t), _np(j))
    assert tl.weight.shape == tuple(jl.weight.shape)
    with torch.no_grad():
        got, ref = tl(tx), tl.dense_reference(tx)
    want = jl(jx)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == want.shape
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(ref, jl.dense_reference(jx)) <= TOL[dtype]
    assert _rel(got, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wshape,xshape,stride,padding", CONV_CASES)
def test_ell_conv_matches_jax(rng, dtype, wshape, xshape, stride, padding):
    """Block size 16 (the port's blocks are multiples of 16), k padded to
    the block where in_ch*kh*kw is not a multiple of it (3*7*7 = 147)."""
    jw, tw = _both(rng.normal(size=wshape), dtype)
    jx, tx = _both(rng.normal(size=xshape), dtype)
    jl = jconv.EllConv2d(jw, block_size=16, stride=stride, padding=padding)
    tl = tconv.EllConv2d(tw, block_size=16, stride=stride, padding=padding)
    np.testing.assert_array_equal(_np(tl.values), _np(jl.weight.values))
    np.testing.assert_array_equal(tensor_to_numpy(tl.col_indices),
                                  np.asarray(jl.weight.col_indices))
    assert tl.k_padded == jl.k_padded
    assert tl.weight.shape == tuple(jl.weight.shape)
    with torch.no_grad():
        got, ref = tl(tx), tl.dense_reference(tx)
    want = jl(jx)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == want.shape
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(ref, jl.dense_reference(jx)) <= TOL[dtype]
    assert _rel(got, ref) <= TOL[dtype]


def test_ell_conv_refuses_a_ragged_out_ch(rng):
    w = torch.from_numpy(rng.normal(size=(24, 3, 3, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="multiple of block_size"):
        tconv.EllConv2d(w, block_size=16)


@pytest.mark.parametrize("block_k", [0, 32])
def test_ell_conv_grad_matches_jax(rng, block_k):
    """The gradient of a loss through the layer with respect to its ELL
    values, against ``jax.grad`` through the JAX layer (its VJP)."""
    w = rng.normal(size=(32, 8, 3, 3)).astype(np.float32)
    x = rng.normal(size=(2, 10, 10, 8)).astype(np.float32)
    y = rng.normal(size=(2, 5, 5, 32)).astype(np.float32)
    jl = jconv.EllConv2d(jnp.asarray(w), block_size=16, block_k=block_k,
                         stride=2)
    e = jl.weight

    def jloss(values):
        jl.weight = JEll(values=values, col_indices=e.col_indices,
                         shape=e.shape, block_size=e.block_size,
                         block_k=e.block_k)
        return jnp.mean((jl(jnp.asarray(x)) - jnp.asarray(y)) ** 2)

    jval, jgrad = jax.value_and_grad(jloss)(e.values)
    tl = tconv.EllConv2d(torch.from_numpy(w), block_size=16,
                         block_k=block_k, stride=2)
    loss = torch.mean((tl(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2)
    loss.backward()
    assert abs(loss.item() - float(jval)) <= 1e-5 * abs(float(jval))
    assert _rel(tl.values.grad, jgrad) <= 1e-5


def test_sparse_conv_trains_through_its_planes(rng):
    """The 2:4 layer's planes are parameters: a step of SGD lowers a loss
    and leaves the codes alone."""
    w = torch.from_numpy(rng.normal(size=(16, 8, 3, 3)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 8)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(2, 8, 8, 16)).astype(np.float32))
    layer = tconv.SparseConv2d(w)
    codes = layer.codes.clone()
    opt = torch.optim.SGD(layer.parameters(), lr=0.05)
    losses = []
    for _ in range(4):
        opt.zero_grad()
        loss = torch.mean((layer(x) - y) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    assert torch.equal(layer.codes, codes)


# --------------------------------------------------------------------------
# The sparse MLP
# --------------------------------------------------------------------------

def _jax_params(dtype, dims=CONFIG["dims"]):
    config = jmlp.MlpConfig(dims=dims, dtype=dtype)
    return config, jmlp.init_params(jax.random.PRNGKey(0), config)


def _carry(jparams):
    return mlp_params_from_numpy(
        [tuple(np.asarray(t) for t in layer) for layer in jparams], "cpu")


def test_mlp_config_matches_jax():
    j, t = jmlp.MlpConfig(), tmlp.MlpConfig()
    assert t.dims == j.dims == (256, 512, 512, 256)
    assert t.dtype == j.dtype == "bfloat16" and t.n_layers == j.n_layers
    assert t.torch_dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_the_jax_layout(dtype):
    """Shapes, dtypes and the 2:4 structure of the JAX ``init_params``;
    the same generator seed gives the same parameters."""
    config, jparams = _jax_params(dtype)
    tcfg = tmlp.MlpConfig(dims=config.dims, dtype=dtype)
    params = tmlp.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    again = tmlp.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for i, (jp, tp_, tq) in enumerate(zip(jparams, params, again)):
        for j, t, q in zip(jp, tp_, tq):
            assert tuple(t.shape) == j.shape
            assert str(t.dtype).split(".")[-1] == j.dtype.name
            assert torch.equal(t, q)
        v0, v1, codes, bias = tp_
        w = decompress_24(tmlp._weight(v0, v1, codes, config.dims[i]))
        assert tprune.prune_check_24(w)
        assert not torch.any(bias)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_jax(rng, dtype):
    config, jparams = _jax_params(dtype)
    tcfg = tmlp.MlpConfig(dims=config.dims, dtype=dtype)
    params = _carry(jparams)
    jx, tx = _both(rng.normal(size=(16, 32)), dtype)
    jy, ty = _both(rng.normal(size=(16, 32)), dtype)
    got = tmlp.forward(params, tx, tcfg)
    assert got.dtype == TDT[dtype]
    assert _rel(got, jmlp.forward(jparams, jx, config)) <= TOL[dtype]
    loss = tmlp.loss_fn(params, tx, ty, tcfg)
    want = float(jmlp.loss_fn(jparams, jx, jy, config))
    assert loss.dtype == torch.float32
    assert abs(float(loss) - want) <= TOL[dtype] * abs(want)


def test_param_specs_match_jax():
    config = tmlp.MlpConfig(dims=(32, 64, 64, 32))
    jspecs = jmlp.param_specs(jmlp.MlpConfig(dims=(32, 64, 64, 32)), "mdl")
    tspecs = tmlp.param_specs(config, "mdl")
    assert len(tspecs) == len(jspecs) == 3
    for jl, tl in zip(jspecs, tspecs):
        assert [tuple(s) for s in jl] == list(tl)


@pytest.fixture(scope="module")
def jax_steps():
    """Per mesh, the JAX step's losses and parameters after each of
    ``STEPS`` steps (f32), from the same start and data."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    y = rng.normal(size=(16, 32)).astype(np.float32)
    config, start = _jax_params("float32")
    out = {}
    for dp, tp in MESHES:
        mesh = JMesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                     ("data", "model"))
        step = jmlp.make_train_step(mesh, config, lr=LR)
        params, runs = start, []
        for _ in range(STEPS):
            loss, params = step(params, jnp.asarray(x), jnp.asarray(y))
            runs.append((float(loss),
                         [tuple(np.asarray(t) for t in layer)
                          for layer in params]))
        out[dp, tp] = runs
    return x, y, start, out


def _port_steps(x, y, start, dp, tp, steps=STEPS):
    mesh = make_mesh((dp, tp), ("data", "model"), devices=["cpu"] * dp * tp)
    step = tmlp.make_train_step(mesh, tmlp.MlpConfig(**CONFIG,
                                                     dtype="float32"), lr=LR)
    params, runs = _carry(start), []
    for _ in range(steps):
        loss, params = step(params, torch.from_numpy(x), torch.from_numpy(y))
        runs.append((loss, params))
    return runs


@pytest.mark.parametrize("after", [1, STEPS])
@pytest.mark.parametrize("dp,tp", MESHES)
def test_train_step_matches_jax(jax_steps, dp, tp, after):
    x, y, start, jruns = jax_steps
    runs = _port_steps(x, y, start, dp, tp, after)
    loss, params = runs[after - 1]
    jloss, jparams = jruns[dp, tp][after - 1]
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    for jl, tl in zip(jparams, params):
        for j, t in zip(jl, tl):
            assert t.dtype == (torch.uint8 if j.dtype == np.uint8
                               else torch.float32)
            assert _rel(t, j) <= 1e-5
        np.testing.assert_array_equal(tensor_to_numpy(tl[2]), jl[2])


def _applied_over_lr_g(before, after, grads):
    """The step applied to the float parameters, projected on ``lr * g``:
    ``<p0 - p1, g> / (lr <g, g>)``."""
    num = den = 0.0
    for p0, p1, g in zip(before, after, grads):
        d = np.asarray(p0, np.float64) - np.asarray(p1, np.float64)
        g = np.asarray(g, np.float64)
        num += float((d * g).sum())
        den += LR * float((g * g).sum())
    return num / den


@pytest.mark.parametrize("dp,tp", MESHES)
def test_train_step_scales_the_gradient_by_tp(jax_steps, dp, tp):
    """The JAX step moves each weight by ``tp * lr * dloss/dW``: the loss
    is computed after an all-gather over ``model``, whose transpose sums
    the tp ranks' equal cotangents. The port follows it on purpose."""
    x, y, start, jruns = jax_steps
    config = jmlp.MlpConfig(**CONFIG, dtype="float32")
    jgrads = jax.grad(jmlp.loss_fn, allow_int=True)(
        start, jnp.asarray(x), jnp.asarray(y), config)

    def floats(params):
        return [t for layer in params for i, t in enumerate(layer) if i != 2]

    jfactor = _applied_over_lr_g(floats(start), floats(jruns[dp, tp][0][1]),
                                 floats(jgrads))
    params = _carry(start)
    for layer in params:
        for i in (0, 1, 3):
            layer[i].requires_grad_()
    tmlp.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y),
                 tmlp.MlpConfig(**CONFIG, dtype="float32")).backward()
    tgrads = [t.grad.numpy() for t in floats(params)]
    after = _port_steps(x, y, start, dp, tp, 1)[0][1]
    tfactor = _applied_over_lr_g(
        [t.detach().numpy() for t in floats(params)],
        [t.numpy() for t in floats(after)], tgrads)
    assert jfactor == pytest.approx(tp, rel=1e-3)
    assert tfactor == pytest.approx(tp, rel=1e-3)


def test_train_step_lowers_the_loss_at_the_flagship_config():
    """Ten bf16 steps at the flagship widths (256-512-512-256, batch 128)
    on a 2 x 2 mesh of CPU ranks: the loss falls at every step, the codes
    stay."""
    config = tmlp.MlpConfig()
    gen = torch.Generator().manual_seed(3)
    params = tmlp.init_params(config, torch.Generator().manual_seed(0),
                              "cpu")
    codes = [layer[2].clone() for layer in params]
    x = torch.randn((128, 256), generator=gen)
    y = (x @ (0.1 * torch.randn((256, 256), generator=gen))).to(
        torch.bfloat16)
    x = x.to(torch.bfloat16)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    step = tmlp.make_train_step(mesh, config, lr=1e-2)
    losses = []
    for _ in range(10):
        loss, params = step(params, x, y)
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    for c, layer in zip(codes, params):
        assert torch.equal(c, layer[2])
        assert layer[0].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------

def _mesh24():
    return make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)


@pytest.mark.parametrize("spec", [(None, "model"), ("data", None),
                                  ("model", "data"), (None, None)])
def test_shard_and_unshard_round_trip(spec):
    mesh = _mesh24()
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    parts = shard(x, spec, mesh)
    assert len(parts) == 8
    assert torch.equal(collectives.unshard(parts, spec, mesh), x)
    # rank (1, 2): its data index 1 and model index 2
    sl = [slice(None) if n is None else
          slice(i * (x.shape[a] // mesh.shape[n]),
                (i + 1) * (x.shape[a] // mesh.shape[n]))
          for a, (n, i) in enumerate(zip(spec, [
              1 if n == "data" else 2 for n in spec]))]
    assert torch.equal(parts[1 * 4 + 2], x[tuple(sl)])


def test_shard_refusals():
    mesh = _mesh24()
    with pytest.raises(ValueError, match="not divisible"):
        shard(torch.zeros(6, 8), ("model", None), mesh)
    with pytest.raises(ValueError, match="does not fit"):
        shard(torch.zeros(8), ("model", None), mesh)


def test_all_gather_and_its_transpose():
    """Forward: each rank gets its model group's parts in order. Backward:
    each part's gradient is the sum over its group's ranks (JAX's
    ``psum_scatter``)."""
    mesh = _mesh24()
    parts = [torch.full((2, 3), float(r), requires_grad=True)
             for r in range(8)]
    full = collectives.all_gather(parts, mesh, "model")
    for r, t in enumerate(full):
        grp = range((r // 4) * 4, (r // 4) * 4 + 4)
        assert torch.equal(t, torch.cat([parts[q].detach() for q in grp]))
    weights = [float(r + 1) for r in range(8)]
    torch.autograd.backward([(w * t).sum() for w, t in zip(weights, full)])
    for r, p in enumerate(parts):
        grp = range((r // 4) * 4, (r // 4) * 4 + 4)
        assert torch.equal(p.grad, torch.full((2, 3), sum(
            weights[q] for q in grp)))
    full_d = collectives.all_gather([p.detach() for p in parts], mesh,
                                    "data", dim=1)
    assert tuple(full_d[5].shape) == (2, 6)
    assert torch.equal(full_d[5], torch.cat([parts[1], parts[5]], 1))


def test_pmean():
    mesh = _mesh24()
    vals = [torch.tensor(float(r)) for r in range(8)]
    got = collectives.pmean(vals, mesh, "data")
    assert [float(t) for t in got] == [2.0, 3.0, 4.0, 5.0] * 2


# --------------------------------------------------------------------------
# The weight converters and the entry points
# --------------------------------------------------------------------------

def test_mlp_params_cross_bit_for_bit():
    _, jparams = _jax_params("bfloat16")
    params = _carry(jparams)
    for jl, tl in zip(jparams, params):
        for j, t in zip(jl, tl):
            jn = np.asarray(j)
            if t.dtype == torch.bfloat16:
                assert np.array_equal(t.view(torch.int16).numpy(),
                                      jn.view(np.int16))
            else:
                assert np.array_equal(t.numpy(), jn)
    back = mlp_params_to_numpy(params)
    for jl, bl in zip(jparams, back):
        for j, b in zip(jl, bl):
            np.testing.assert_array_equal(b, _np(j))
            assert np.array_equal(np.asarray(jnp.asarray(b, j.dtype)),
                                  np.asarray(j))


def test_entry_forward_matches_jax():
    """The flagship forward (256-512-512-256, batch 128, bf16) against the
    JAX forward on the same parameters and input."""
    fn, (params, x) = tentry.entry("cpu")
    out = fn(params, x)
    assert tuple(out.shape) == (128, 256) and out.dtype == torch.bfloat16
    jparams = [tuple(jnp.asarray(a, jnp.uint8 if i == 2 else jnp.bfloat16)
                     for i, a in enumerate(layer))
               for layer in mlp_params_to_numpy(params)]
    want = jmlp.forward(jparams, jnp.asarray(_np(x), jnp.bfloat16),
                        jmlp.MlpConfig())
    assert _rel(out, want) <= 2e-2


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="3 devices for 4 ranks"):
        tentry.dryrun_multichip(4, ["cpu"] * 3)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_dryrun_multichip_on_cpu_ranks(capsys, n):
    """One dp x tp train step and the three rings at the JAX dry run's
    shapes, each ring held to a dense product at 1e-4."""
    loss = tentry.dryrun_multichip(n, ["cpu"] * n)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    dp = 2 if n % 2 == 0 and n > 1 else 1
    assert re.fullmatch(
        rf"dryrun_multichip\({n}\): mesh=\{{'data': {dp}, 'model': "
        rf"{n // dp}\}} loss=\d+\.\d{{4}} ring-batched OK rdma-ring OK "
        r"rdma-ring-tiled OK", line), line
    assert np.isfinite(loss) and loss > 0
