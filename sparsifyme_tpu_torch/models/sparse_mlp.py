"""Flagship model: an MLP with 2:4 structured-sparse weights.

Counterpart of ``sparsifyme_tpu.models.sparse_mlp``. Weights are stored
compressed (the planes of :class:`~..containers.Sparse24`), the forward
runs kernel K3 per layer and the backward the JAX package's VJP (both
through :func:`~..ops.sparse24.spmm_24`), and :func:`make_train_step`
trains over a ``("data", "model")`` mesh: the batch split over ``data``,
each weight's output rows over ``model`` with the activations
all-gathered after every layer, gradients averaged over ``data``.

Layer math: ``y = relu(x @ W^T + bias)`` with ``W [d_out, d_in]`` pruned
2:4 along d_in (the contraction axis), computed as
``spmm_24(W24, x^T)^T`` so the sparse operand is the kernel's A. One
layer's parameters are the tuple ``(values0, values1, codes, bias)``, the
planes k-major ``[k4, d_out]``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import torch

from .._build import resolve_device
from ..containers import Sparse24
from ..ops.prune import prune_nm
from ..ops.sparse24 import compress_24, spmm_24
from ..parallel import collectives
from ..parallel.mesh import Mesh, shard, shard_batch

LayerParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    dims: Tuple[int, ...] = (256, 512, 512, 256)
    dtype: str = "bfloat16"

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_params(config: MlpConfig, generator: torch.Generator,
                device=None) -> List[LayerParams]:
    """He-scaled normal weights drawn from ``generator`` (on its own
    device), moved to ``device`` (default: the card), pruned 2:4 (K1) and
    compressed (K2) there; zero biases. The JAX package draws from a key,
    so the two give other weights: carry them across with
    :func:`~..convert.mlp_params_from_numpy` to compare."""
    dev = resolve_device(device)
    dtype = config.torch_dtype
    params: List[LayerParams] = []
    for i in range(config.n_layers):
        d_in, d_out = config.dims[i], config.dims[i + 1]
        scale = (2.0 / d_in) ** 0.5
        w = torch.randn((d_out, d_in), generator=generator,
                        device=generator.device).to(dtype) * scale
        w24, _ = prune_nm(w.to(dev), 2, 4)
        s = compress_24(w24)
        bias = torch.zeros((d_out,), dtype=dtype, device=dev)
        params.append((s.values0, s.values1, s.codes, bias))
    return params


def _weight(v0, v1, codes, d_in: int) -> Sparse24:
    # Planes are k-major [k4, d_out]: d_out is the last plane axis.
    return Sparse24(v0, v1, codes, shape=(v0.shape[-1], d_in))


def _layer(p: LayerParams, x: torch.Tensor, d_in: int, *,
           act: bool) -> torch.Tensor:
    v0, v1, codes, bias = p
    y = spmm_24(_weight(v0, v1, codes, d_in), x.T, out_dtype=x.dtype).T
    y = y + bias
    return torch.relu(y) if act else y


def forward(params: Sequence[LayerParams], x: torch.Tensor,
            config: MlpConfig) -> torch.Tensor:
    """Single-device forward: x [batch, dims[0]] -> [batch, dims[-1]]."""
    for i, p in enumerate(params):
        x = _layer(p, x, config.dims[i], act=i < config.n_layers - 1)
    return x


def _mse(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.to(torch.float32)
                                   - y.to(torch.float32)))


def loss_fn(params, x, y, config: MlpConfig) -> torch.Tensor:
    return _mse(forward(params, x, config), y)


# --------------------------------------------------------------------------
# SPMD training step: data-parallel batch x tensor-parallel (row-sharded W)
# --------------------------------------------------------------------------

def _layer_specs(model_axis: str):
    return (
        (None, model_axis),  # values0
        (None, model_axis),  # values1
        (None, model_axis),  # codes
        (model_axis,),       # bias
    )


def param_specs(config: MlpConfig, model_axis: str = "model"):
    """Per layer, the spec of each parameter (see
    :func:`~..parallel.mesh.shard`): the planes' d_out axis (their last)
    and the bias split over ``model_axis``."""
    return tuple(_layer_specs(model_axis) for _ in range(config.n_layers))


def shard_params(params: Sequence[LayerParams], mesh: Mesh,
                 model_axis: str = "model") -> List[LayerParams]:
    """This rank's slabs of whole parameters on a process mesh (what the
    process-mesh train step takes): each tensor cut by
    :func:`param_specs`."""
    spec = _layer_specs(model_axis)
    return [tuple(shard(t, sp, mesh)[0] for t, sp in zip(p, spec))
            for p in params]


def unshard_params(params: Sequence[LayerParams], mesh: Mesh,
                   model_axis: str = "model") -> List[LayerParams]:
    """The whole parameters from this rank's slabs on a process mesh, on
    every process (the inverse of :func:`shard_params`)."""
    spec = _layer_specs(model_axis)
    return [tuple(collectives.unshard([t], sp, mesh)
                  for t, sp in zip(p, spec))
            for p in params]


def make_train_step(
    mesh: Mesh,
    config: MlpConfig,
    lr: float = 1e-2,
    data_axis: str = "data",
    model_axis: str = "model",
) -> Callable:
    """Build the SPMD train step ``(params, x, y) -> (loss, params')``.

    The step takes and returns the whole parameter list (on the device of
    the first parameter) and whole ``x``, ``y``. Inside, as in the JAX
    step's ``shard_map``: every rank holds its batch shard and its column
    slab of each layer's planes and bias; each layer's ``[d_out/tp, b]``
    result is all-gathered over ``model_axis`` (:func:`all_gather
    <..parallel.collectives.all_gather>`, which carries the gradient); every
    rank computes the loss of its data shard; the gradients (none for the
    codes) are averaged over ``data_axis`` and the SGD update is applied in
    f32 per slab and cast back. The loss is the mean over ``data_axis``.

    The gradient is that of the JAX step, which takes ``value_and_grad`` of
    each rank's loss: the all-gather's transpose sums the tp ranks' equal
    cotangents, so each weight moves by ``tp * lr * dloss/dW``
    (pinned by ``tests/test_torch_models.py::``
    ``test_train_step_scales_the_gradient_by_tp``).

    On a process mesh (one rank per process) the step takes and returns
    this rank's blocks (the process contract of :mod:`..parallel.mesh`):
    its slabs of the parameters (:func:`shard_params`) and its batch shard
    of ``x`` and ``y``, and gathers nothing but each layer's activations;
    the loss is the same mean on every process.
    """
    specs = param_specs(config, model_axis)
    n_layers = config.n_layers
    procs = mesh.is_process_mesh

    def train_step(params: Sequence[LayerParams], x: torch.Tensor,
                   y: torch.Tensor):
        home = params[0][0].device
        if procs:
            mesh.check("train_step", x, y, *params[0])
            xs, ys = [x], [y]
        else:
            xs = shard_batch(x, mesh, data_axis)
            ys = shard_batch(y, mesh, data_axis)
        # layers[i][j]: parameter j of layer i, one tensor per rank
        layers = []
        for p, spec in zip(params, specs):
            slabs = []
            for j, (t, sp) in enumerate(zip(p, spec)):
                parts = [t] if procs else shard(t, sp, mesh)
                if j != 2:  # codes are structural: no gradient
                    parts = [q.detach().requires_grad_() for q in parts]
                slabs.append(parts)
            layers.append(slabs)

        hs = xs
        for i, (v0, v1, codes, bias) in enumerate(layers):
            d_in = config.dims[i]
            local = [
                spmm_24(_weight(v0[r], v1[r], codes[r], d_in), hs[r].T,
                        out_dtype=hs[r].dtype) + bias[r][:, None]
                for r in range(len(hs))]  # [d_out/tp, b]
            full = collectives.all_gather(local, mesh, model_axis)
            hs = [h.T for h in full]
            if i < n_layers - 1:
                hs = [torch.relu(h) for h in hs]
        losses = [_mse(h, yr) for h, yr in zip(hs, ys)]
        torch.autograd.backward(losses)
        loss = collectives.pmean([t.detach() for t in losses], mesh,
                                 data_axis)[0].to(home)

        new_params = []
        with torch.no_grad():
            for slabs, spec in zip(layers, specs):
                new = []
                for j, (parts, sp) in enumerate(zip(slabs, spec)):
                    if j != 2:
                        grads = collectives.pmean([q.grad for q in parts],
                                                  mesh, data_axis)
                        parts = [(q.to(torch.float32)
                                  - lr * g.to(torch.float32)).to(q.dtype)
                                 for q, g in zip(parts, grads)]
                    new.append(parts[0] if procs else
                               collectives.unshard(parts, sp, mesh, home))
                new_params.append(tuple(new))
        return loss, new_params

    return train_step
