"""Route ``mlp24``: the port's 2:4 MLP (``models/sparse_mlp.forward``, K3
per layer through ``spmm_24``) on batches of tokens, sized from a model
configuration's keys (``hidden_size``, ``intermediate_size``,
``num_hidden_layers``).

The benchmark's tests add this file, its reference
(``model_refs/mlp24.py``) and its configuration to a copy of the
benchmark, as a model configuration adds its own; a pass returns one
output a batch.
"""

from __future__ import annotations

from pathlib import Path

from perfbench import data, reference, routes
from sparsifyme_tpu_torch.models import sparse_mlp
from sparsifyme_tpu_torch.ops import prune, sparse24

REF = routes.load_file(
    Path(__file__).resolve().parents[1] / "model_refs" / "mlp24.py",
    "perfbench_model_ref_mlp24")


def dims(config: dict) -> list:
    """The widths a token passes through, input to output."""
    inner = [config["intermediate_size"]] * (config["num_hidden_layers"] - 1)
    return [config["hidden_size"]] + inner + [config["hidden_size"]]


class Mlp24(routes.Route):
    """Weights and batches made from the seed in set-up, the weights
    pruned 2:4 and compressed by the program; the window runs the forward
    on each batch."""

    dense_baseline = False

    @staticmethod
    def kept_flops(config: dict, traffic: dict) -> float:
        """Products a pass's 2:4 weights keep: half of 2 * tokens * d_in *
        d_out a layer, over every batch."""
        d = dims(config)
        return float(traffic["batches"] * traffic["tokens"] * sum(
            a * b for a, b in zip(d, d[1:])))

    def _layers(self, ctx) -> list:
        """Each layer's dense ``(W [d_out, d_in], bias [d_out])``, bf16,
        W He-scaled."""
        d = dims(ctx.config)
        out = []
        for i, (d_in, d_out) in enumerate(zip(d, d[1:])):
            w = data.weight_b(d_out, d_in, ctx.seed, f"mlp24.w{i}",
                              ctx.device) * (2.0 / d_in) ** 0.5
            bias = data.weight_b(1, d_out, ctx.seed, f"mlp24.bias{i}",
                                 ctx.device)[0] * 0.1
            out.append((w, bias))
        return out

    def _batch(self, ctx, j: int):
        return data.dense_a(ctx.traffic["tokens"], ctx.config["hidden_size"],
                            ctx.seed, f"mlp24.x{j}", ctx.rank, ctx.device)

    def setup(self, ctx, layers):
        config = sparse_mlp.MlpConfig(dims=tuple(dims(ctx.config)),
                                      dtype=ctx.config["dtype"])
        params = []
        for w, bias in self._layers(ctx):
            s = sparse24.compress_24(prune.prune_nm(w)[0])
            params.append((s.values0, s.values1, s.codes, bias))
        xs = [self._batch(ctx, j) for j in range(ctx.traffic["batches"])]
        return params, xs, config

    def run_pass(self, state, traced):
        params, xs, config = state
        out = []
        for x in xs:
            with routes.span(traced, "mlp24"):
                out.append(sparse_mlp.forward(params, x, config))
        return out

    def outputs(self, ctx, layers):
        return ctx.traffic["batches"]

    def reference(self, ctx, layers, i, control):
        kept = [(reference.keep_24(w), bias) for w, bias in self._layers(ctx)]
        x = self._batch(ctx, i)
        return (REF.forward(x, kept),
                REF.control_forward(x, kept) if control else None)


ROUTE = Mlp24
