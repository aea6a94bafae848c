"""How often Kimi Linear's expert choices differ from its plain
reference's, per seed, from one pass of the program and forwards of the
reference: the readings of ``flips.py`` (the share of choices that differ
in the reference's own forward; on the program's own input to each layer,
the share of tokens whose choice is not a top-k of the reference's scores
and the largest ``violation`` of one, which the route's ``TIE`` must
exceed), read at Kimi's widths and with its configuration's names. The
benchmark's own runs never run this::

    python3 -m perfbench.flips_kimi --workload <cell> --seeds <n> ...

Prints one JSON line a seed. The route must keep its reference as ``REF``
and, after a pass, each MoE layer's ``(input, output, choices)`` in
``_moe`` (as ``model_routes/kimilinear24.py`` does).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

from . import harness, reference, routes
from .flips import choices_differ
from .run import CACHES, ROOT


def seed_flips(cell: harness.Cell, seed: int, device) -> dict:
    """One pass of the program and the reference's readings on ``seed``."""
    route_cls = routes.resolve(cell.traffic["route"], cell.root)
    mod = sys.modules[route_cls.__module__]
    ref_mod = mod.REF
    ctx = harness.Ctx(device, seed, cell.traffic, config=cell.config)
    route = route_cls()
    state = route.setup(ctx, [])
    ids = state[1]
    outs = route.run_pass(state, False)[:2]
    moe = route._moe
    del state
    spec = mod.ref_spec(cell.config)
    wf = functools.partial(mod.kept_weight, ctx)
    held = mod.held_experts(cell.config)
    hid, eps = cell.config["hidden_size"], cell.config["rms_norm_eps"]
    near_share, worst = [], []
    for (before, _, sel), layer in zip(moe, mod.moe_layers(cell.config)):
        x = ref_mod.rms_norm(before.T, wf(f"{layer}.ffn_norm", (hid,)), eps)
        _, biased = ref_mod.router_scores(x, spec, layer, wf)
        v = ref_mod.violation(biased, sel)
        near_share.append(float((v > 0).float().mean()))
        worst.append(float(v.max()))
        del x, biased
    got = [sel for _, _, sel in moe]
    route._moe = moe = None
    want = []
    real_route = ref_mod.route

    def ref_spy(*args, **kw):
        sel, w = real_route(*args, **kw)
        want.append(sel)
        return sel, w

    try:
        ref_mod.route = ref_spy
        refs = ref_mod.forward(ids, spec, wf)
    finally:
        ref_mod.route = real_route
    layers = [choices_differ(a, b, held) for a, b in zip(got, want)]
    return {"seed": seed,
            "flip_share": sum(f for f, _ in layers) / len(layers),
            "flip_share_held": sum(h for _, h in layers) / len(layers),
            "by_layer": [round(f, 5) for f, _ in layers],
            "same_input_share": sum(near_share) / len(near_share),
            "same_input_violation": max(worst),
            "same_input_by_layer": worst,
            "own_choice_readings": [reference.readings(o, r)
                                    for o, r in zip(outs, refs)]}


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".perfbench_cache" / sub)
    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        harness.log(f"{cell.name} needs a CUDA card")
        return 2
    for seed in args.seeds:
        print(json.dumps(seed_flips(cell, seed, torch.device("cuda"))),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
