#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``sparsifyme_tpu_torch``).

Usage: python3 chip_smoke.py        (needs one CUDA card; builds the
kernels from ``sparsifyme_tpu_torch/csrc`` with nvcc at first use)

Phases, each raising on failure:
  1. print the card (nvidia-smi name and power limit, torch's name);
  2. build the thirteen Hopper kernel sources (one nvcc each, in parallel);
  3. hold every kernel route against its plain PyTorch version on the card,
     at full ResNet-50 width (b=32) at the six bench shapes: K1 prune (bit
     for bit, also in f32 and as a view at an odd storage offset at
     12544x64x147, with NaN/+-Inf/+-0 and m = 4, 5, 8, 32, and in column
     pieces), K2 compress and the fused prune+compress route (K2 on dense
     input) exactly equal; K3 2:4 SpMM (the sparse tensor-core tile, plain,
     transposed, packed and alpha/beta/c), its fold=2 route, K4 Blocked-ELL
     gather SpMM and K5 Blocked-ELL expand
     SpMM within a relative error of 2e-2 in bf16 and 1e-4 in f32; K6
     segmented COO SpMM under every plan (route staged or gather, 1 to 8
     splits, forced) within 1e-4 (f32 sums in another order) at three
     ResNet-101 shapes (b=32) and sparsities 0.5 / 0.9 / 0.995 with bf16
     and f32 B and at a ragged m, each plan bitwise the same on two calls,
     and exactly on duplicate entries, with the COO planes and K6's layout
     built on the card equal to those built on the CPU; plus
     the 2:4, ELL, plan and COO pipelines on the card against the same
     pipelines on the CPU at a small size; K3's wgmma_sp route at the six
     bench shapes (bf16, so at k 64, 147, 576, 1024, 1152 and 4608): its
     pack kernel bit for bit against the plain pack, the route within 2e-2
     of its plain version (the packed words decoded) and of K3's plain
     version on the planes, and every call it does not take (transpose_out,
     alpha, beta/c, f32 out, packed codes, a tile, n % 64, no operand,
     fold=2, a stale operand; f32, fold=2 and ragged planes for the pack)
     raising when the route is forced, with no launch; K7's mma_sp step
     on windows
     of the ResNet-scale shard's planes, bf16 and f32, every first/last
     flag, whole shards and m-tiles, and at a ragged row count, within
     2e-2 / 1e-4 of its plain version; K7's wgmma_sp step on rank 1 of
     4's windows of the shard's packed operand (the whole shard, the
     tiled windows at columns 3 * 896 and 6 * 896), every flag, bf16 and
     f32 C, within 2e-2 (bf16 C) / 1e-4 (f32) of its plain version; at
     the ragged count a ring takes the mma_sp step and a forced wgmma_sp
     raises;
  3b. the gradients: ``spmm_24``, ``spmm_ell`` and ``spmm_ell_expand`` at
     3136x128x1152 (b=32, bf16) under autograd, the forward through the
     kernel and the backward of the op's ``autograd.Function``, against
     autograd through the plain version on the same card tensors: every
     input's gradient within a relative error of 2e-2;
  4. the bench path: ``run_model_sweep("resnet50")`` over all 49 layers,
     with every launch counter set to 0 just before and read just after;
     it reads the committed tuning table
     (``sparsifyme_tpu_torch/bench/tuning_table.json``) and prints ``tuned
     k/17`` (all 17 unique shapes must have an entry of every family) and
     each shape's winners; prints the sweep's JSON line and fails unless
     every route that the table's winners and the tuned path's
     alternatives name launched (K1, K2, the fused route, K3 and K4
     always; K3's wgmma_sp route and its pack wherever a shape can take
     the route, which the default races; K3's fold route where a 2:4
     winner folds; K5 where an ELL winner is the expand kernel, or a shape
     without an ELL entry has k < 512), that the wgmma_sp route launched
     within the run of every shape whose 2:4 winner it is, and that the
     speedup geomeans and ``fused_frac_sol_geomean`` are finite and
     positive; prints each shape's 2:4 winning design and ``pack_ms``;
  4b. the tune path: ``tune.tune_shape`` (gemm, spmm24, fused, ell) at
     full width, b=32, bf16, at 3136x128x1152, 12544x256x64 and
     196x512x4608, into a temporary table, counters set to 0 just before
     and read just after: every candidate's ms and each winner printed,
     the count of readings discarded under their bound, every sweep route,
     K3's fold route and its wgmma_sp route (within each shape's run)
     launched; then each family's winner held to its plain version at that
     shape (the fused planes exactly, the SpMMs within 2e-2);
  5. the plan path: ``spmma(a, b, timed=True)`` on each of the 17 unique
     ResNet-50 shapes (b=32, bf16), counters set to 0 just before and read
     just after; every phase time > 0, ``plan(a, b)`` exactly equal to
     ``plan.matmul(plan.compress(plan.prune(a)), b)``, a bf16-out plan
     (which packs K3's wgmma_sp operand in its compress step and takes
     the route where its table entry lets it: the route must launch
     there) within 2e-2 of ``spmm_24`` on the mma_sp tile, and the fold=2
     route
     ``spmm_24(prune_compress_24(a, fold=2), b)`` within 2e-2 of the fold=1
     route where ``k4 <= 256``;
  6. the COO path: ``config2_coo_resnet101()`` (BASELINE config 2) over all
     17 unique ResNet-101 shapes x 6 sparsities (102 points, b=32), counters
     set to 0 just before and read just after; one JSON line per point,
     then the summary line; fails unless K6 launched and every point's
     ``coo_seg_ms`` is finite and positive;
  7. the ring path: ``config4_row_partitioned_scaling()`` (BASELINE config
     4) at full size, 1, 2, 4 and 8 ranks round-robin over the cards,
     counters set to 0 just before and read just after; prints its JSON
     line and fails unless K7's mma_sp step launched on both routes (f32)
     and every ``ring_ms`` and ``ideal_ms`` is finite and positive; then
     both K7 rings at the ResNet-scale shard (784x256x1024 at b=32: 25088
     folded rows, P = 4, 6272 x 1024 per rank, 7 m-tiles of 896) against
     single-card ``spmm_24`` in bf16 (2e-2; the container packed once with
     ``pack_wg``, so both rings take K7's wgmma_sp step) and f32 (1e-4),
     each ring called three times from an empty graph cache (eager,
     capture and replay, replay), every result held to ``spmm_24`` and the
     replays bitwise equal to the eager ring; the counters are read after
     the rings, and the phase fails unless ``pack_wg`` and the wgmma_sp
     step of both routes launched;
  7b. the model path, counters set to 0 once before it and checked after
     each part: (1) ``SparseConv2d`` on ResNet-50's conv1 (7x7/2, 3->64,
     32x224x224x3 NHWC), ``SparseConv2d`` and ``EllConv2d`` on
     layer2.0.conv2 (3x3/2, XLA's (0, 1) padding, 32x56x56x128) and a
     layer3 conv2 (3x3/1, 32x14x14x256), bf16, built on the card (K1, K2)
     and run once (K3, K4); (2) the flagship MLP forward through
     ``entry()`` (256-512-512-256, batch 128, bf16); (3) ten SGD steps of
     the dp x tp train step on a 2 x 2 mesh (ranks on one card, or one a
     card on four); parts 1-3 run once inside ``profile_trace`` (again,
     up to three times in all, where the profiler reports no device time)
     and the device's busy share of that window is printed; (4)
     ``dryrun_multichip(4)`` (K7 on both routes). Then each conv layer's
     output is held to its ``dense_reference`` (``F.conv2d``) within 2e-2
     and timed against cuDNN on the dense pruned weight (paired), the
     forward against the same forward on the CPU, the parameters after
     three steps against three steps on CPU ranks within 2e-2 (codes
     exactly), and the loss must fall; the busy share of three more
     (warm) steps, traced, is printed too; prints ``{"model_path":
     {...}}`` (busy shares, per-layer ms / cudnn_ms / patch_ms, step_ms,
     forward_ms, losses);
  8. the drivers: each of the five (``sparsify gemm spmm spmma
     batched_coo``) once at a ResNet-50 shape, held to its stdout contract,
     and configs 1 and 3 with ``quick=True``; after the kernels line's
     measurements (step 9), ``torch_compare`` at three
     shapes (density 0.1, b=32: dense, sparse and conversion ms, the
     sparse product within 1e-2 of the dense); ``profiling_cli --limit
     2`` (one driver process per kernel and shape) on the first two
     layers of ``datasets/shapes.csv`` that the ``sparsify`` driver's 2x2
     blocks tile (its first, k = 147, is refused in both packages),
     whose ``compare.csv``
     must hold its eight columns, two rows and positive floats, while the
     kernels built under ``sparsifyme_tpu_torch/_build/`` stay as they
     were (the driver processes load them, none rebuilds);
  9. one ``{"kernels": [...]}`` line: each route's time at a main-path
     shape beside its plain version, a PyTorch library call computing the
     same function (where one exists) and its bound, with its launches on
     the five paths and its error against the plain version there (K1,
     K2 and its fused route have a second entry at their worst main-path
     shape, 12544x64x147; K3's wgmma_sp route, ``spmm_24_wg``, has
     three, at U, E and D (784x256x1024, 12544x256x64, 196x512x4608), and
     its pack, ``pack_wg``, one at U, and its 256-row unit,
     ``spmm_24_wg256``, six, at the MiMo path's shapes, each with
     ``graph_ms`` (device time,
     the calls replayed in a CUDA graph) and ``enqueue_ms``, the route's
     also with ``mma_sp_graph_ms`` and ``library_graph_ms`` (K3's mma_sp
     tile and ``torch.matmul`` on the same operands, replayed alike); K6
     has three, 3136x128x1152 at 0.9 and 0.995
     sparsity and 196x512x4608 at 0.5, each on a layout built outside the
     timed calls, whose build time is printed on a line of its own, and
     each with ``kernel_ms`` and ``enqueue_ms``; K4
     has a second entry at its worst main-path shape, 196x512x4608; K5's
     entry, at its worst, 12544x256x64, also times K4 on the same operand,
     ``gather_ms``; the ring
     entries (at R on a container packed once: ``ring_step_wg`` and
     ``ring_step_wg_tiled`` on K7's wgmma_sp step, ``ring_step`` and
     ``ring_step_tiled`` on the same calls with ``design="mma_sp"``; each
     with its ``design``, the wgmma_sp ones with ``mma_sp_ms``,
     ``mma_sp_kernel_ms`` and ``mma_sp_enqueue_ms`` beside their own; the
     bound counts A as the step reads it, packed or as planes) time a
     whole ring call, with the plain step in K7's
     place for ``plain_ms``, and add K7's own device time in that call,
     ``kernel_ms``, the host's time to queue one, ``enqueue_ms``, the
     time of one call with B at a new address, which misses the graph
     cache and runs the ring eagerly, ``fresh_ms``, of the next call,
     which captures the ring and replays it, ``capture_ms``, and the
     accumulator traffic K7's design adds to the bound's bytes,
     ``design_bytes``; the error is that of the replay after those two;
     on one card ``ms`` and ``enqueue_ms`` time replays of the captured
     ring, and ``kernel_ms`` is read from eager rings, because the profiler
     does not dependably report a replayed graph's kernels; the K4 and K5
     entries also carry ``kernel_ms``, all
     their kernels' device time per call (a profiler session with no
     device time is run again, three sessions at most), and
     ``enqueue_ms``);
  8b. the probe path: ``units_probe.probe_shape`` at 25088x256x1024 (b=32
     folded) and ``fused_probe.probe_shape`` at 401408x256 (bf16), counters
     set to 0 just before and read just after: every mode of the 2:4 tile
     in both designs (``mma_sp``, K3's tile; ``wgmma_sp``, the TMA-fed
     wgmma.sp tile on A packed once) (``feed`` and ``mma`` at 4 and 2
     stages, ``full`` at 4, 2 and the serial ring), the expand-then-dense
     tile (``fp1``, TMA and wgmma) and K2's body in each probe mode
     (``io``, ``rank``, ``dot1``, ``rm``) held to its plain version (the
     tile's outputs within 2e-2 and its side words exactly; io and rank
     within 2e-2, dot1 and rm exactly) and timed, with ``overlap_frac``
     per design printed; fails unless each of the fourteen probe kernels
     launched. The kernels line (step 9) gets their fourteen entries
     (``units_feed``, ``units_mma``, ``units_both_s2``, ``units_chain``,
     ``units_wg_feed``, ``units_wg_mma``, ``units_wg_full``,
     ``units_wg_full_s2``, ``units_wg_chain``, ``units_fp1``,
     ``fused_io``, ``fused_rank``, ``fused_dot1``, ``fused_rm``, the last
     with ``transposed_ms``: the planes transposed after it; the units
     entries with ``graph_ms``), launches on path ``probes``;
  8c. the MiMo path: K3's wgmma_sp route at MiMo-V2-Flash's 2:4 products
     as one card of its TP8/EP8 deployment runs them (``bench/wg_tall.py``'s
     six shapes: q 1536x4096, o 4096x1024, gate_up 32768x4096 and down
     4096x16384 at n 32768, an expert's gate_up 4096x4096 and down
     4096x2048 at n 1024), counters set to 0 just before and read just
     after: at each shape ``wg_plan``'s plan must be the 256-row unit, the
     call must move ``spmm24_wg_cuda.wg256_launches`` by one, and its
     output must be within 2e-2 of the plain
     version and bit for bit the 128-row unit's at the same width and
     split count; the kernels line (step 9) gets six ``spmm_24_wg256``
     entries, at those shapes, with ``graph_ms`` and ``library_graph_ms``,
     launches on path ``mimo``;
  8d. the MoE combine kernel at MiMo-V2-Flash's shape (32768 tokens, hidden
     4096, 8 of 256 experts chosen, 32 held; ``bench/moe_combine.py``): one
     call must move ``moe_combine_cuda.launches`` by one, leave h as it
     was, and equal the plain version bit for bit on the tokens with at
     most one held choice and within 1e-6 elsewhere; a ``{"moe_combine":
     ...}`` line with both device ms and the least time;
  8e. the DeepSeek-V3 path: K3 at DeepSeek-V3's 2:4 products as one card of
     its TP4/EP32 prefill runs them (``DSV3_SHAPES``: MLA's q_a 1536x7168,
     kv_a 576x7168, q_b 6144x1536, kv_b 8192x512 and o 7168x4096, the
     dense FFN's gate_up 36864x7168 and down 7168x18432, the shared
     expert's gate_up 4096x7168 and down 7168x2048, at n 32768; a routed
     expert's gate_up and down at n 1024 and 1088), each weight made by
     ``models.moe_transformer.sparse_weight`` and multiplied by its
     ``linear``, counters set to 0 just before: at each shape
     ``spmm24_design`` must give the shape's route (``mma_sp`` for kv_a,
     whose 576 rows are no whole 128-row tile; else ``wgmma_sp``), and
     ``wg_plan`` its unit (128 rows for kv_b, 256 elsewhere), the call must
     move that route's launch count by one and no other K3 count, and its
     output must be within 2e-2 of the route's plain version
     (``spmm24_plain`` on the planes, or ``spmm24_wg_plain`` on the packed
     words); launches on path ``dsv3``;
  8f. the RMSNorm kernel at the model cells' six norm calls at 32768
     tokens (``bench/rms_norm.py``: hidden 4096 and 7168 float32 in the
     layouts their callers ask for, the bf16 latents at 1536 and 512): each
     call must move ``rms_norm_cuda.launches`` by one, leave h as it was,
     repeat bit for bit and lie within one bf16 ulp of the plain version;
     one ``{"rms_norm": ...}`` line a shape with the kernel's and the plain
     version's device ms and the least time;
  9b. the process path, after the kernels line's measurements (like
     ``profiling_cli`` in step 8, it runs other processes on the card):
     ``python -m torch.distributed.run --standalone --nproc-per-node=P -m
     sparsifyme_tpu_torch.entry --processes`` with a time limit, one rank
     per process over NCCL, at P = 2 and then 4 where the machine has the
     cards, at P = 1 on one card (P >= 2 needs a card per rank; a line
     says so): ``dryrun_multichip``'s checks on the process mesh, config 4
     at full size (``ring_ms``, ``ideal_ms``, ``comm_efficiency``), ten
     steps of the flagship MLP's dp x tp step (``step_ms``, the losses,
     which must fall) and both K7 rings at 784x256x1024 (b=32) against
     single-card ``spmm_24`` (2e-2), each held to the one-process port on
     the same seeds (2e-2; codes exactly; each process's shard packed
     once with ``pack_wg``, so the bf16 rings take K7's wgmma_sp step),
     and both K7 rings and config
     4's ppermute ring to their plain version on CPU copies of each
     rank's blocks (bf16 2e-2, f32 1e-4); rank 0's ``{"processes":
     ...}`` line is printed, with every rank's launch counts, and the
     phase fails unless K3 and both K7 routes on both steps (mma_sp in
     the f32 rings, wgmma_sp in the bf16 ones) launched on every rank or
     the launcher exits non-zero; its launches join the kernels line's
     per-path counts (path ``procs``); then ``measure_machine()``'s rates
     (dense bf16, memory, f32) beside the data sheet's, with the card
     line, on a line of their own;
  10. the card line again, then ``{"ok": true, "device": {...}}`` last.
"""

import contextlib
import csv
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

# m, n, k: the six bench shapes of PERF.md, where K1, K2, the fused route,
# K3 (the sparse tile, every epilogue case) and K4 are held to their plain
# versions
SHAPES = [(12544, 64, 147), (12544, 64, 576), (12544, 256, 64),
          (3136, 128, 1152), (784, 256, 1024), (196, 512, 4608)]
EXPAND_SHAPES = SHAPES
FOLD_SHAPES = [(12544, 64, 147), (12544, 64, 576)]
ALL_SHAPES = list(dict.fromkeys(SHAPES + EXPAND_SHAPES + FOLD_SHAPES))
BATCH = 32
NAMED = (3136, 128, 1152)  # main-path shape of the kernels line
NAMED_ELL_DEEP = (196, 512, 4608)  # K4's worst main-path shape
NAMED_EXPAND = (12544, 256, 64)  # K5's worst main-path shape (k < 512)
NAMED_FOLD = (12544, 64, 576)  # fold needs k4 <= 256
COO_SHAPES = [(12544, 64, 576), (196, 512, 4608), (3136, 128, 1152)]
COO_SPARSITIES = (0.5, 0.9, 0.995)
COO_RAGGED = (784, 256, 2304)  # m = 784 is not a multiple of 128
NAMED_COMPRESS = (12544, 64, 147)  # K1 and K2: their worst main-path shape
# K6's kernels-line points: C (the named shape at 90%), its worst (the
# deep 196-row shape at 50%) and its sparsest (C at 99.5%, the gather route)
COO_POINTS = [((3136, 128, 1152), 0.9), ((196, 512, 4608), 0.5),
              ((3136, 128, 1152), 0.995)]
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# K3's wgmma_sp route in the kernels line: U, E and D (b = 32), where the
# mma_sp tile loses most to the dense product
WG_SHAPES = [(784, 256, 1024), (12544, 256, 64), (196, 512, 4608)]
RING = (784, 256, 1024)  # m, n, k: ResNet-50 layer of the ring's shard
RING_P = 4  # ranks: 25088 folded rows, 6272 x 1024 per rank, 7 m-tiles
REPLACES = {
    "prune_nm": "sparsifyme_tpu/ops/kernels/prune_kernel.py:81 "
                "prune_nm_pallas",
    "compress_24": "sparsifyme_tpu/ops/kernels/prune_kernel.py:285 "
                   "compress_24_pallas",
    "prune_compress_24": "sparsifyme_tpu/ops/kernels/prune_kernel.py:577 "
                         "prune_compress_24_pallas",
    "spmm_24": "sparsifyme_tpu/ops/kernels/spmm24_kernel.py:703 "
               "spmm24_pallas (+ :513 spmm24_pallas_fp)",
    "spmm_24_fold": "sparsifyme_tpu/ops/kernels/spmm24_kernel.py:925 "
                    "spmm24_fold_pallas",
    "spmm_24_wg": "sparsifyme_tpu/ops/kernels/spmm24_kernel.py:703 "
                  "spmm24_pallas (K3's wgmma_sp route)",
    "pack_wg": "sparsifyme_tpu/ops/kernels/spmm24_kernel.py:703 "
               "spmm24_pallas (the wgmma_sp route's operand, packed once "
               "after compress)",
    "spmm_24_wg256": "sparsifyme_tpu/ops/kernels/spmm24_kernel.py:703 "
                     "spmm24_pallas (K3's wgmma_sp route, 256-row unit)",
    "spmm_ell": "sparsifyme_tpu/ops/kernels/ell_kernel.py:206 "
                "ell_spmm_pallas",
    "spmm_ell_expand": "sparsifyme_tpu/ops/kernels/ell_kernel.py:448 "
                       "ell_expand_spmm_pallas",
    "spmm_coo": "sparsifyme_tpu/ops/kernels/coo_kernel.py:169 "
                "spmm_coo_pallas",
    "ring_step": "sparsifyme_tpu/parallel/ring_kernel.py:146 "
                 "spmm_24_ring_pallas",
    "ring_step_tiled": "sparsifyme_tpu/parallel/ring_kernel.py:377 "
                       "spmm_24_ring_tiled_pallas",
    "ring_step_wg": "sparsifyme_tpu/parallel/ring_kernel.py:146 "
                    "spmm_24_ring_pallas (K7's wgmma_sp step)",
    "ring_step_wg_tiled": "sparsifyme_tpu/parallel/ring_kernel.py:377 "
                          "spmm_24_ring_tiled_pallas (K7's wgmma_sp step)",
}
SOURCES = {
    "prune_nm": "sparsifyme_tpu_torch/csrc/prune_nm.cu",
    "compress_24": "sparsifyme_tpu_torch/csrc/compress24.cu",
    "prune_compress_24": "sparsifyme_tpu_torch/csrc/compress24.cu",
    "spmm_24": "sparsifyme_tpu_torch/csrc/spmm24.cu",
    "spmm_24_fold": "sparsifyme_tpu_torch/csrc/spmm24.cu",
    "spmm_24_wg": "sparsifyme_tpu_torch/csrc/spmm24.cu",
    "pack_wg": "sparsifyme_tpu_torch/csrc/spmm24.cu",
    "spmm_24_wg256": "sparsifyme_tpu_torch/csrc/spmm24.cu",
    "spmm_ell": "sparsifyme_tpu_torch/csrc/ell_spmm.cu",
    "spmm_ell_expand": "sparsifyme_tpu_torch/csrc/ell_expand.cu",
    "spmm_coo": "sparsifyme_tpu_torch/csrc/coo_spmm.cu",
    "ring_step": "sparsifyme_tpu_torch/csrc/ring24.cu",
    "ring_step_tiled": "sparsifyme_tpu_torch/csrc/ring24.cu",
    "ring_step_wg": "sparsifyme_tpu_torch/csrc/ring24_wg.cu",
    "ring_step_wg_tiled": "sparsifyme_tpu_torch/csrc/ring24_wg.cu",
}
SWEEP_ROUTES = ("prune_nm", "compress_24", "prune_compress_24", "spmm_24",
                "spmm_ell", "spmm_ell_expand")
PLAN_ROUTES = ("prune_nm", "compress_24", "prune_compress_24", "spmm_24",
               "spmm_24_fold")
COO_ROUTES = ("spmm_coo",)
# config 4 (f32: K7's mma_sp step, the simple tile) and dryrun_multichip
RING_MMA_ROUTES = ("prune_nm", "compress_24", "spmm_24", "ring_step",
                   "ring_step_tiled")
# the bf16 rings at R on a packed container: K7's wgmma_sp step
RING_WG_ROUTES = ("pack_wg", "ring_step_wg", "ring_step_wg_tiled")
MODEL_CONV_ROUTES = ("prune_nm", "compress_24", "spmm_24", "spmm_ell")
MODEL_MLP_ROUTES = ("prune_nm", "compress_24", "spmm_24")
PATHS = ("bench", "plan", "coo", "ring", "model", "tune", "probes",
         "mimo", "dsv3", "procs")
# K3's 256-row unit: no ResNet shape takes it, so only the MiMo and
# DeepSeek-V3 paths (and not the kernels phase) launch it
TALL_ROUTE = "spmm_24_wg256"
# DeepSeek-V3's 2:4 products on one card of its TP4/EP32 prefill (8 x 4096
# tokens; a held expert's rows at about 1024, padded to 64): (name, M, K,
# n, the K3 route spmm_24 takes)
DSV3_SHAPES = [
    ("q_a", 1536, 7168, 32768, TALL_ROUTE),
    ("kv_a", 576, 7168, 32768, "spmm_24"),
    ("q_b", 6144, 1536, 32768, TALL_ROUTE),
    ("kv_b", 8192, 512, 32768, "spmm_24_wg"),
    ("o", 7168, 4096, 32768, TALL_ROUTE),
    ("dense gate_up", 36864, 7168, 32768, TALL_ROUTE),
    ("dense down", 7168, 18432, 32768, TALL_ROUTE),
    ("shared gate_up", 4096, 7168, 32768, TALL_ROUTE),
    ("shared down", 7168, 2048, 32768, TALL_ROUTE),
    ("expert gate_up", 4096, 7168, 1024, TALL_ROUTE),
    ("expert down", 7168, 2048, 1088, TALL_ROUTE)]
# the process path's kernels that must launch on every rank (K1 and K2
# build its operands where a card prunes and compresses)
PROCESS_MUST = ("spmm_24", "ring_step", "ring_step_tiled", "ring_step_wg",
                "ring_step_wg_tiled")
PROCESS_TIMEOUT_S = 420  # one launcher run, all ranks
# N, E and D: the tune phase's shapes (b=32)
TUNE_SHAPES = [(3136, 128, 1152), (12544, 256, 64), (196, 512, 4608)]
TUNE_ROUTES = SWEEP_ROUTES + ("spmm_24_fold", "spmm_24_wg", "pack_wg")
WG_ROUTES = ("spmm_24_wg", "pack_wg")  # K3's wgmma_sp route and its pack
TUNE_FAMILIES = ("gemm", "spmm24", "fused", "ell")
COMPARE_SHAPES = [(12544, 64, 147), (3136, 128, 1152), (196, 512, 4608)]
MODEL_STEPS = 10
# the update of three f32 train steps, card against CPU ranks, relative to
# its largest element: the parameters are about 1000x the update, so their
# f32 rounding (an ulp or two a step) is about 1e-4 of it
UPDATE_TOL = 1e-3
# profiler sessions tried before a trace without device events fails
PROFILE_SESSIONS = 3
# the probe path's shapes: the JAX units probe's second (b = 32 folded) and
# the JAX fused probe's first
PROBE_UNITS = (25088, 256, 1024)
PROBE_FUSED = (401408, 256)
# the probes' kernels-line entries: (design, mode, stages) of units_cuda,
# "fp1", or a mode of fused_cuda; the TPU kernel each replaces
PROBES = {
    "units_feed": (("mma_sp", "feed", 4), "experiments/units.py:158 "
                   "run_probe (probe_kernel :25, mode expand)"),
    "units_mma": (("mma_sp", "mma", 4), "experiments/units.py:158 run_probe "
                  "(probe_kernel :25, mode dot)"),
    "units_both_s2": (("mma_sp", "full", 2), "experiments/units.py:158 "
                      "run_probe (probe_kernel :25, modes both and parity)"),
    "units_chain": (("mma_sp", "full", 1), "experiments/units.py:158 "
                    "run_probe (probe_kernel :25, mode chain)"),
    "units_wg_feed": (("wgmma_sp", "feed", 4), "experiments/units.py:158 "
                      "run_probe (probe_kernel :25, mode expand)"),
    "units_wg_mma": (("wgmma_sp", "mma", 4), "experiments/units.py:158 "
                     "run_probe (probe_kernel :25, mode dot)"),
    "units_wg_full": (("wgmma_sp", "full", 4), "experiments/units.py:158 "
                      "run_probe (probe_kernel :25, mode both)"),
    "units_wg_full_s2": (("wgmma_sp", "full", 2), "experiments/units.py:158 "
                         "run_probe (probe_kernel :25, mode parity)"),
    "units_wg_chain": (("wgmma_sp", "full", 1), "experiments/units.py:158 "
                       "run_probe (probe_kernel :25, mode chain)"),
    "units_fp1": ("fp1", "experiments/units.py:79 run_probe_fp1 "
                  "(kernel :93)"),
    "fused_io": ("io", "experiments/tpu_fused_probe.py:130 run_variant "
                 "(kernel_io :54)"),
    "fused_rank": ("rank", "experiments/tpu_fused_probe.py:130 run_variant "
                   "(kernel_rank :66)"),
    "fused_dot1": ("dot1", "experiments/tpu_fused_probe.py:130 run_variant "
                   "(kernel_dot1 :81)"),
    "fused_rm": ("rm", "experiments/tpu_fused_probe.py:130 run_variant "
                 "(kernel_rm :101)"),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def errors(out: torch.Tensor, ref: torch.Tensor):
    """``(max absolute error, max absolute error / max |ref|)``."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"bad output {tuple(out.shape)} vs "
                             f"{tuple(ref.shape)}")
    abs_err = float((out - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-30)


def close(name, out, ref, dtype, what, tol=None):
    a, e = errors(out, ref)
    tol = TOL[dtype] if tol is None else tol
    print(f"  {name:17s} {what:44s} rel_err={e:.3e} (tol {tol:g})",
          flush=True)
    if not e <= tol:
        raise AssertionError(f"{name} {what}: rel err {e} > {tol}")
    return a, e


def exact(name, outs, refs, what, same=torch.equal):
    """Every output equal to its reference: by value, or by ``same`` (K1:
    ``prune_kernel.same_bits``, bit for bit)."""
    for o, r in zip(outs, refs):
        if o.shape != r.shape or o.dtype != r.dtype or not same(o, r):
            raise AssertionError(f"{name} {what}: not exactly equal")
    print(f"  {name:17s} {what:44s} exactly equal", flush=True)


def harness_ell(a, k):
    """The harness's ELL operand for a batch ``a [b, m, k]``: block_k by
    k, fold_first by m; returns ``(e, kp, bkb, fold_first)``."""
    from sparsifyme_tpu_torch.bench import harness

    b_, m, _ = a.shape
    bkb = harness.heuristic_block_k(k)
    ff = harness.can_fold_first(m, b_)
    e, kp = harness.build_ell_operand(a, block_size=128, block_k=bkb,
                                      fold_first=ff)
    return e, kp, bkb, ff


def case_tag(case) -> str:
    return " ".join(f"{k}={v}" for k, v in case.items()) or "plain"


def phase_kernels() -> None:
    from sparsifyme_tpu_torch.ops.ell import ell_pack, ell_values_kmajor
    from sparsifyme_tpu_torch.ops.kernels import (ell_kernel, prune_kernel,
                                                  spmm24_kernel)
    from sparsifyme_tpu_torch.ops.sparse24 import (pack_codes_fp,
                                                   prune_compress_24)

    counts0 = launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for (m, n, k) in ALL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{m}x{n}x{k}x{BATCH} {str(dtype)[6:]}"
            a = torch.randn((BATCH, m, k), generator=gen,
                            device="cuda").to(dtype)
            b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
            cases = [dict(transpose_out=False), dict(transpose_out=True),
                     dict(transpose_out=False, alpha=0.5, beta=0.25,
                          c=True)]
            if (m, n, k) in SHAPES:
                pw, pm = prune_kernel.prune_nm_cuda(a, 2, 4)
                exact("prune_nm", (pw, pm),
                      prune_kernel.prune_nm_plain(a, 2, 4), tag,
                      prune_kernel.same_bits)
                w2 = pw.reshape(-1, k)
                planes = prune_kernel.compress_24_cuda(w2)
                exact("compress_24", planes,
                      prune_kernel.compress_24_plain(w2), tag)
                dense = a.reshape(-1, k)
                fused = prune_kernel.prune_compress_24_cuda(dense)
                exact("prune_compress_24", fused,
                      prune_kernel.prune_compress_24_plain(dense),
                      f"{tag} (dense in)")
                exact("prune_compress_24", fused, planes,
                      f"{tag} (= compress of pruned)")
                v0, v1, codes = planes
                sp_cases = list(cases)
                if codes.shape[0] * 4 <= 1024:  # where pack_codes_fp applies
                    sp_cases.append(dict(transpose_out=True,
                                         packed_codes=True))
                for case in sp_cases:
                    kw = dict(case)
                    if kw.pop("c", False):
                        kw["c"] = torch.randn((BATCH * m, n), generator=gen,
                                              device="cuda")
                    cc = (pack_codes_fp(codes) if kw.get("packed_codes")
                          else codes)
                    args = (v0, v1, cc, b)
                    kw.update(k_logical=k, out_dtype=dtype)
                    close("spmm_24", spmm24_kernel.spmm24_cuda(*args, **kw),
                          spmm24_kernel.spmm24_plain(*args, **kw), dtype,
                          f"{tag} {case_tag(case)}")
                if dtype == torch.bfloat16:
                    check_wg_route(v0, v1, codes, b, BATCH * m, k, tag)
                del pw, pm, planes, fused, v0, v1, codes
            if (m, n, k) in EXPAND_SHAPES:
                e, kp, bkb, ff = harness_ell(a, k)
                dense = torch.nn.functional.pad(
                    a.reshape(BATCH * m, k) if ff else a,
                    (0, kp - k, 0, (-(BATCH * m if ff else m)) % 128))
                exact("ell_pack", (e.values.cpu(),),
                      (ell_pack(dense.cpu(), e.col_indices.cpu(), 128,
                                bkb),), f"{tag} (card vs CPU)")
                bp = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
                vals = e.values.reshape(-1, e.values.shape[-1])
                cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
                kwe = dict(block_size=128, block_k=bkb, out_dtype=dtype)
                for case in cases if (m, n, k) in SHAPES else ():
                    kw = dict(case)
                    if kw.pop("c", False):
                        kw["c"] = torch.randn((vals.shape[0], n),
                                              generator=gen, device="cuda")
                    kw.update(kwe)
                    close("spmm_ell",
                          ell_kernel.ell_spmm_cuda(vals, cols, bp, **kw),
                          ell_kernel.ell_spmm_plain(vals, cols, bp, **kw),
                          dtype, f"{tag} bk={bkb} {case_tag(case)}")
                vkm = ell_values_kmajor(e)
                for tout in (False, True):
                    kw = dict(kwe, transpose_out=tout)
                    close("spmm_ell_expand",
                          ell_kernel.ell_expand_spmm_cuda(vkm, cols, bp,
                                                          **kw),
                          ell_kernel.ell_expand_spmm_plain(vkm, cols, bp,
                                                           **kw),
                          dtype, f"{tag} bk={bkb} transpose_out={tout}")
                del e, dense, vals, cols, vkm
            if (m, n, k) in FOLD_SHAPES:
                s = prune_compress_24(a, fold=2)
                for case in cases[::2]:  # row-major C only
                    kw = dict(case)
                    kw.pop("transpose_out")
                    if kw.pop("c", False):
                        kw["c"] = torch.randn((BATCH * m, n), generator=gen,
                                              device="cuda")
                    kw.update(k_logical=k, out_dtype=dtype)
                    args = (s.values0, s.values1, s.codes, b)
                    close("spmm_24_fold",
                          spmm24_kernel.spmm24_fold_cuda(*args, **kw),
                          spmm24_kernel.spmm24_fold_plain(*args, **kw),
                          dtype, f"{tag} {case_tag(case)}")
                del s
            del a, b
            torch.cuda.empty_cache()
    wg_refusals(gen)
    phase_kernels_prune(gen)
    phase_kernels_coo(gen)
    phase_kernels_ring(gen)
    counts = launch_counts()
    for name in REPLACES:
        if name != TALL_ROUTE and counts[name] <= counts0[name]:
            raise AssertionError(f"{name}: launch counter did not move")


def check_wg_route(v0, v1, codes, b, rows, k, tag) -> None:
    """K3's wgmma_sp route on K2's planes: the pack kernel bit for bit
    against the plain pack, the route within 2e-2 of its plain version (the
    packed words decoded) and of K3's (the planes)."""
    from sparsifyme_tpu_torch.ops.kernels import spmm24_kernel as k3

    packed = k3.pack_wgmma_sp_cuda(v0, v1, codes)
    exact("pack_wg", (packed,), (k3.pack_wgmma_sp(v0, v1, codes),), tag)
    kw = dict(m=rows, k_logical=k, out_dtype=torch.bfloat16)
    got = k3.spmm24_wg_cuda(packed, b, **kw)
    close("spmm_24_wg", got, k3.spmm24_wg_plain(packed, b, **kw),
          torch.bfloat16, f"{tag} (packed words decoded)")
    close("spmm_24_wg", got, k3.spmm24_plain(
        v0, v1, codes, b, k_logical=k, out_dtype=torch.bfloat16),
        torch.bfloat16, f"{tag} (planes)")


def wg_refusals(gen) -> None:
    """Every call K3's wgmma_sp route does not take raises on the card
    when the route is forced, and launches nothing; a stale operand
    raises."""
    import dataclasses

    from sparsifyme_tpu_torch import pack_wg, prune_compress_24, spmm_24
    from sparsifyme_tpu_torch.ops.kernels import spmm24_kernel as k3

    a = torch.randn((2, 128, 256), generator=gen, device="cuda").to(
        torch.bfloat16)
    b = torch.randn((256, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    s = prune_compress_24(a)
    sw = pack_wg(s)
    before = k3.spmm24_wg_cuda.launches
    cases = {"transpose_out": dict(transpose_out=True),
             "alpha": dict(alpha=2.0),
             "c": dict(beta=1.0, c=torch.ones((2, 128, 64), device="cuda")),
             "f32 out": dict(out_dtype=torch.float32),
             "packed codes": dict(packed_codes=True), "tile": dict(tile=1),
             "n % 64": dict(b=b[:, :48].contiguous())}
    calls = {f"{name}": (sw, kw) for name, kw in cases.items()}
    calls["no operand"] = (s, {})
    calls["fold=2"] = (prune_compress_24(a, fold=2), {})
    calls["stale (replaced plane)"] = (dataclasses.replace(
        sw, values0=sw.values0.clone()), {})
    for name, (ss, kw) in calls.items():
        kw = dict(kw)
        try:
            spmm_24(ss, kw.pop("b", b), design="wgmma_sp", **kw)
        except ValueError:
            continue
        raise AssertionError(f"spmm_24_wg: {name} did not raise")
    for bad in (prune_compress_24(a, fold=2), prune_compress_24(a.float()),
                prune_compress_24(a[:, :100])):
        try:
            pack_wg(bad)
        except ValueError:
            continue
        raise AssertionError("pack_wg took planes it cannot pack")
    if k3.spmm24_wg_cuda.launches != before:
        raise AssertionError("spmm_24_wg launched on a refused call")
    print(f"  {'spmm_24_wg':17s} {'refusals (card)':44s} "
          f"{len(calls) + 3} raised", flush=True)


def phase_kernels_prune(gen) -> None:
    """K1 beyond the bench shapes, bit for bit against its plain version on
    the card: its worst main-path shape (conv1, whole-row tiles) in f32
    and bf16, the same rows as a view one element into a larger buffer
    (not 16-byte aligned: scalar copies), other group sizes, NaN, +-Inf
    and +-0, and column pieces (f32 at k = 5000, m = 32)."""
    from sparsifyme_tpu_torch.ops.kernels import prune_kernel as pk

    m, _, k = NAMED_COMPRESS
    rows = BATCH * m
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
        cases.append((f"{rows}x{k} {str(dtype)[6:]}", a, 2, 4))
    buf = torch.randn(rows * k + 1, generator=gen,
                      device="cuda").to(torch.bfloat16)
    cases.append((f"{rows}x{k} bf16 at a 1-element offset",
                  buf[1:].view(rows, k), 2, 4))
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0,
                            -0.0, 1.0, -1.0, 2.0], device="cuda")
    w = special[torch.randint(0, 8, (4096, k), generator=gen,
                              device="cuda")].to(torch.bfloat16)
    for n, mm in ((2, 4), (3, 5), (2, 8), (7, 32)):
        cases.append((f"4096x{k} bf16 NaN/Inf/+-0 {n}:{mm}", w, n, mm))
    cases.append(("2000x5000 f32 7:32 (column pieces)",
                  torch.randn((2000, 5000), generator=gen, device="cuda"),
                  7, 32))
    for tag, x, n, mm in cases:
        exact("prune_nm", pk.prune_nm_cuda(x, n, mm),
              pk.prune_nm_plain(x, n, mm), tag, pk.same_bits)
    del cases, buf, w
    torch.cuda.empty_cache()


def coo_operand(m, k, sparsity, gen):
    """A ``[m, k]`` f32 matrix on the card, threshold-pruned to
    ``sparsity``, as a Coo (entries in row-major order)."""
    from sparsifyme_tpu_torch import coo_from_dense, prune_threshold

    a = torch.randn((m, k), generator=gen, device="cuda")
    thr = float(torch.quantile(a.abs().flatten(), sparsity))
    return coo_from_dense(prune_threshold(a, thr)[0])


def coo_plans(layout, mb, k, cols):
    """Every plan K6 can run for one launch: each route, each split count
    that leaves no split without chunks."""
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel as ck

    plans = (ck.coo_plan(mb, 128, k, layout.kc, layout.nnz, cols,
                         routes=(route,), split_counts=(s,),
                         peak=layout.peak)
             for route in ("staged", "gather")
             for s in range(1, ck.MAX_SPLITS + 1))
    return [p for p in plans if p is not None]


def phase_kernels_coo(gen) -> None:
    """K6 against its plain version at ResNet-101 widths under every plan
    (route and split count forced), each plan's result bitwise the same on a
    second call; the packer and K6's layout on the card against the same on
    the CPU."""
    from sparsifyme_tpu_torch.containers import Coo
    from sparsifyme_tpu_torch.ops.coo import pack_coo, spmm_coo_segmented
    from sparsifyme_tpu_torch.ops.kernels import coo_kernel

    cases = [(sh, sp) for sh in COO_SHAPES for sp in COO_SPARSITIES]
    cases.append((COO_RAGGED, 0.9))
    picked = coo_kernel.card_plan
    try:
        for (m, n, k), sp in cases:
            coo = coo_operand(m, k, sp, gen)
            packed = pack_coo(coo)
            cpu = Coo(coo.rows.cpu(), coo.cols.cpu(), coo.values.cpu(),
                      coo.shape)
            cpu_packed = pack_coo(cpu)
            tag = f"{m}x{k} sp={sp} E={packed[0].shape[1]}"
            exact("pack_coo", tuple(p.cpu() for p in packed), cpu_packed,
                  f"{tag} (card vs CPU)")
            lay = coo_kernel.coo_layout(*packed, k=k)
            lay_cpu = coo_kernel.coo_layout(*cpu_packed, k=k)
            exact("coo_layout", tuple(x.cpu() for x in lay[:3]), lay_cpu[:3],
                  f"{tag} kc={lay.kc} (card vs CPU)")
            for dtype in (torch.bfloat16, torch.float32):
                b = torch.randn((BATCH, k, n), generator=gen,
                                device="cuda").to(dtype)
                want = coo_kernel.spmm_coo_plain(*packed, b, m=m)
                pick = picked(b.device, packed[0].shape[0], 128, k, lay.kc,
                              lay.nnz, BATCH * n, lay.peak)
                worst, plans = 0.0, coo_plans(lay, packed[0].shape[0], k,
                                              BATCH * n)
                for plan in plans:
                    coo_kernel.card_plan = lambda *a, p=plan: p
                    outs = [coo_kernel.spmm_coo_cuda(*packed, b, m=m,
                                                     layout=lay)
                            for _ in range(2)]
                    coo_kernel.card_plan = picked
                    if not torch.equal(outs[0], outs[1]):
                        raise AssertionError(f"spmm_coo {tag} {plan}: two "
                                             "calls differ")
                    err = errors(outs[0], want)[1]
                    if not err <= TOL[torch.float32]:
                        raise AssertionError(f"spmm_coo {tag} {plan}: rel "
                                             f"err {err}")
                    worst = max(worst, err)
                    del outs
                close("spmm_coo", coo_kernel.spmm_coo_cuda(*packed, b, m=m),
                      want, torch.float32,
                      f"{m}x{n}x{k}x{BATCH} sp={sp} B {str(dtype)[6:]} "
                      f"picked {pick.route}/{pick.splits}")
                print(f"  {'spmm_coo':17s} {len(plans)} plans, each twice "
                      f"bitwise equal, worst rel_err={worst:.3e}", flush=True)
                del b, want
            del coo, packed, cpu, cpu_packed, lay, lay_cpu
            torch.cuda.empty_cache()
    finally:
        coo_kernel.card_plan = picked
    i32 = dict(dtype=torch.int32, device="cuda")
    dup = Coo(rows=torch.tensor([0, 0, 5, 5], **i32),
              cols=torch.tensor([1, 1, 2, 2], **i32),
              values=torch.tensor([1.0, 2.0, 3.0, 4.0], device="cuda"),
              shape=(8, 8))
    dup_packed = pack_coo(dup)
    dup_lay = coo_kernel.coo_layout(*dup_packed, k=8)
    try:
        for dtype in (torch.bfloat16, torch.float32):
            b = torch.eye(8, device="cuda").to(dtype)[None].repeat(BATCH, 1,
                                                                   1)
            want = torch.zeros((BATCH, 8, 8))
            want[:, 0, 1], want[:, 5, 2] = 3.0, 7.0
            for plan in coo_plans(dup_lay, 1, 8, BATCH * 8):
                coo_kernel.card_plan = lambda *a, p=plan: p
                got = spmm_coo_segmented(dup, b, out_dtype=torch.float32,
                                         packed=dup_packed, layout=dup_lay)
                exact("spmm_coo", (got.cpu(),), (want,),
                      f"duplicate entries, B {str(dtype)[6:]} "
                      f"{plan.route}/{plan.splits}")
        # split plans where batch * m * n is odd: every partial plane but
        # the first starts off a 16-byte boundary
        m, n, k = 37, 37, 1000
        odd_packed = pack_coo(coo_operand(m, k, 0.9, gen))
        odd_lay = coo_kernel.coo_layout(*odd_packed, k=k, kc=16)
        b = torch.randn((1, k, n), generator=gen, device="cuda")
        want = coo_kernel.spmm_coo_plain(*odd_packed, b, m=m)
        plans = [p for p in coo_plans(odd_lay, 1, k, n) if p.splits > 1]
        if sorted({p.splits for p in plans}) != list(range(2, 9)):
            raise AssertionError(f"spmm_coo {m}x{n}x{k}: splits "
                                 f"{[p.splits for p in plans]}")
        worst = 0.0
        for plan in plans:
            coo_kernel.card_plan = lambda *a, p=plan: p
            got = coo_kernel.spmm_coo_cuda(*odd_packed, b, m=m,
                                           layout=odd_lay)
            err = errors(got, want)[1]
            if not err <= TOL[torch.float32]:
                raise AssertionError(f"spmm_coo {m}x{n}x{k}x1 {plan}: rel "
                                     f"err {err}")
            worst = max(worst, err)
        print(f"  {'spmm_coo':17s} {m}x{n}x{k}x1 (odd b*m*n): {len(plans)} "
              f"split plans, worst rel_err={worst:.3e}", flush=True)
    finally:
        coo_kernel.card_plan = picked


def ring_devices(p):
    """Ranks round-robin over the cards, as config 4 places them."""
    cards = torch.cuda.device_count()
    return [f"cuda:{r % cards}" for r in range(p)]


def ring_operands(dtype, gen, batch=BATCH, m=RING[0]):
    """The ring's problem at the ResNet scale: A ``[batch, m, 1024]`` pruned
    and compressed on the card (K1, K2), B ``[1024, 256]``."""
    from sparsifyme_tpu_torch import compress_24, prune_nm

    _, n, k = RING
    a = torch.randn((batch, m, k), generator=gen, device="cuda").to(dtype)
    b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    return compress_24(prune_nm(a)[0]), b


def ring_calls(name, fn, want, dtype, what, captured):
    """``fn()``, a whole ring, three times from an empty graph cache: the
    first call runs eagerly, the second captures the ring and replays it,
    the third replays it (on a mesh that ``captured``; otherwise all three
    run eagerly). Each result is held against ``want``, and the replays
    must equal the eager ring bit for bit. Returns the third result's
    errors and the host times of the first two calls in ms."""
    from sparsifyme_tpu_torch.parallel import ring_graph

    ring_graph.clear()
    gc.collect()
    torch.cuda.empty_cache()
    outs, ms = [], []
    for call in ("eager", "capture", "replay"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        graphs = int(captured and call != "eager")
        if len(ring_graph._cache) != graphs:
            raise AssertionError(f"{name} {what} {call}: "
                                 f"{len(ring_graph._cache)} graphs, "
                                 f"expected {graphs}")
        err = close(name, outs[-1], want, dtype, f"{what} {call}")
    if not all(torch.equal(o, outs[0]) for o in outs[1:]):
        raise AssertionError(f"{name} {what}: a replay differs from the "
                             "eager ring")
    return err, ms[0], ms[1]


def phase_kernels_ring(gen) -> None:
    """K7's mma_sp step against its plain version on windows of the
    ResNet-scale shard's planes (rank 1 of 4: row stride 25088, 6272
    columns, m-tiles of 896), every first/last flag, and at a ragged row
    count (1001 per rank); then its wgmma_sp step
    (``phase_kernels_ring_wg``)."""
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    p = RING_P
    for dtype in (torch.bfloat16, torch.float32):
        for batch, m in ((BATCH, RING[0]), (1, 1001 * p)):
            s, _ = ring_operands(dtype, gen, batch, m)
            rows, k4 = s.values0.shape[1], s.values0.shape[0]
            mloc, k4s, n = rows // p, k4 // p, RING[1]
            mt = rk._pick_mt(mloc)
            r = 1
            planes = [x[:, r * mloc:(r + 1) * mloc]
                      for x in (s.values0, s.values1, s.codes)]
            slot = torch.randn((4 * k4s, n), generator=gen,
                               device="cuda").to(dtype)
            acc0 = torch.randn((mloc, n), generator=gen, device="cuda")
            cases = [(True, False, 0, mloc), (False, False, 0, mloc),
                     (False, True, 0, mloc), (True, True, 0, mloc)]
            if mt < mloc:
                cases += [(False, False, 3 * mt, mt), (False, True, 6 * mt,
                                                       mt)]
            for i, (first, last, c0, width) in enumerate(cases):
                kern = (rk.ring_step_tiled_cuda if width < mloc
                        else rk.ring_step_cuda)

                def run(fn):
                    acc = acc0.clone()
                    out = torch.zeros((mloc, n), dtype=dtype, device="cuda")
                    fn(*planes, slot, acc, out, src=(r - i) % p, c0=c0,
                       mt=width, first=first, last=last)
                    return out if last else acc

                close("ring_step" if width == mloc else "ring_step_tiled",
                      run(kern), run(rk.ring_step_plain), dtype,
                      f"{rows}x{n}x{4 * k4} rank {r}/{p} cols {c0}+{width} "
                      f"first={int(first)} last={int(last)} "
                      f"{str(dtype)[6:]}")
            del s, planes, slot, acc0
            torch.cuda.empty_cache()
    phase_kernels_ring_wg(gen)


def phase_kernels_ring_wg(gen) -> None:
    """K7's wgmma_sp step against its plain version (the packed words
    decoded) on rank 1 of 4's windows of the container's packed operand
    at the ResNet-scale shard (the one-card mesh's addressing: the rank's
    window starts at m-tile 49 of the 196): the whole shard and the tiled
    route's windows at columns 3 * 896 and 6 * 896, every first/last flag,
    bf16 and f32 C; the accumulator within 1e-4, C within 2e-2 (bf16) or
    1e-4 (f32). At the ragged row count (1001 a rank, which pack_wg
    cannot take) a ring takes the mma_sp step, and a forced wgmma_sp
    raises with no launch."""
    from sparsifyme_tpu_torch import make_mesh, spmm_24, spmm_24_ring_explicit
    from sparsifyme_tpu_torch.ops.sparse24 import pack_wg
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    p, r = RING_P, 1
    f32 = torch.float32
    s, _ = ring_operands(torch.bfloat16, gen)
    s = pack_wg(s)
    rows, k4 = s.values0.shape[1], s.values0.shape[0]
    mloc, k4s, n = rows // p, k4 // p, RING[1]
    mt = rk._pick_mt(mloc)
    a_wg = (s.wg.packed, r * mloc // 128)
    slot = torch.randn((4 * k4s, n), generator=gen,
                       device="cuda").to(torch.bfloat16)
    acc0 = torch.randn((mloc, n), generator=gen, device="cuda")
    flags = [(True, False), (False, False), (False, True), (True, True)]
    cases = ([(f, l, 0, mloc) for f, l in flags]
             + [(f, l, c0, mt) for f, l in flags for c0 in (3 * mt, 6 * mt)])
    for odt in (torch.bfloat16, f32):
        for i, (first, last, c0, width) in enumerate(cases):
            kern = (rk.ring_step_wg_tiled_cuda if width < mloc
                    else rk.ring_step_wg_cuda)

            def run(fn):
                acc = acc0.clone()
                out = torch.zeros((mloc, n), dtype=odt, device="cuda")
                fn(*a_wg, slot, acc, out, src=(r - i) % p, c0=c0, mt=width,
                   first=first, last=last)
                return out if last else acc

            close("ring_step_wg" if width == mloc else "ring_step_wg_tiled",
                  run(kern), run(rk.ring_step_wg_plain), odt if last else f32,
                  f"{rows}x{n}x{4 * k4} rank {r}/{p} cols {c0}+{width} "
                  f"first={int(first)} last={int(last)} {str(odt)[6:]}")
    del s, slot, acc0
    s, b = ring_operands(torch.bfloat16, gen, 1, 1001 * p)
    mesh = make_mesh((p,), ("model",), devices=ring_devices(p))
    wg0, mma0 = rk.ring_step_wg_cuda.launches, rk.ring_step_cuda.launches
    try:
        spmm_24_ring_explicit(s, b, mesh, "model", design="wgmma_sp")
    except ValueError as e:
        print(f"  ring_step_wg      1001 rows a rank, forced: raises ({e})",
              flush=True)
    else:
        raise AssertionError("a forced wgmma_sp ring took 1001 rows a rank")
    close("ring_step", spmm_24_ring_explicit(s, b, mesh, "model"),
          spmm_24(s, b), torch.bfloat16, f"{1001 * p}x{n}x1024 P={p} ring")
    if rk.ring_step_wg_cuda.launches != wg0 or \
            rk.ring_step_cuda.launches == mma0:
        raise AssertionError("the ragged ring did not take the mma_sp step")
    torch.cuda.empty_cache()


def phase_pipeline() -> None:
    """The public 2:4, ELL and plan pipelines on the card against the same
    pipelines on the CPU (plain versions), at a small size."""
    import sparsifyme_tpu_torch as sp

    gen = torch.Generator().manual_seed(7)
    a = torch.randn((2, 256, 147), generator=gen).to(torch.bfloat16)
    b = torch.randn((147, 64), generator=gen).to(torch.bfloat16)
    outs = {}
    for dev in ("cpu", "cuda"):
        ad, bd = a.to(dev), b.to(dev)
        s = sp.compress_24(sp.prune_24(ad)[0])
        e = sp.ell_from_dense(torch.nn.functional.pad(ad, (0, 13)), 128, 3,
                              32)
        bp = torch.nn.functional.pad(bd, (0, 0, 0, 13))
        outs[dev] = (sp.spmm_24(s, bd), sp.spmm_ell(e, bp),
                     sp.spmm_ell_expand(e, bp), sp.spmma(ad, bd),
                     sp.spmm_24(sp.prune_compress_24(ad, fold=2), bd))
    for what, o_gpu, o_cpu in zip(
            ("2:4 pipeline", "ELL pipeline", "ELL expand", "spmma",
             "2:4 fold=2"), outs["cuda"], outs["cpu"]):
        err = errors(o_gpu.cpu(), o_cpu)[1]
        print(f"  {what:17s} card vs CPU rel_err={err:.3e}", flush=True)
        if o_gpu.shape != (2, 256, 64) or not err <= 2e-2:
            raise AssertionError(f"{what}: card disagrees with CPU")

    # The COO path: threshold prune -> COO -> the oracle, K6 and the ELL
    # conversion (whose repeated padding column only spmm_ell sums right).
    w = torch.randn((256, 160), generator=gen)
    bb = torch.randn((2, 160, 64), generator=gen)
    coo_outs = {}
    for dev in ("cpu", "cuda"):
        coo = sp.coo_from_dense(sp.prune_threshold(w.to(dev), 1.5)[0])
        bd = bb.to(dev)
        coo_outs[dev] = (sp.spmm_coo_segmented(coo, bd), sp.spmm_coo(coo, bd),
                         sp.spmm_ell(sp.coo_to_ell(coo, 32), bd[0]))
    for what, o_gpu, o_cpu in zip(
            ("COO segmented", "COO oracle", "COO -> ELL"), coo_outs["cuda"],
            coo_outs["cpu"]):
        err = errors(o_gpu.cpu(), o_cpu)[1]
        print(f"  {what:17s} card vs CPU rel_err={err:.3e}", flush=True)
        if o_gpu.shape != o_cpu.shape or not err <= 1e-4:
            raise AssertionError(f"{what}: card disagrees with CPU")


def phase_grads() -> None:
    """The backwards of the three differentiable ops at a full-width bench
    shape (``NAMED``, b=32, bf16): the forward through the kernel and the
    backward of its ``autograd.Function`` (the JAX VJP's port) against
    autograd through the plain version on the same card tensors, every
    input's gradient within 2e-2."""
    from sparsifyme_tpu_torch.containers import BlockedEll, Sparse24
    from sparsifyme_tpu_torch.ops import ell as te
    from sparsifyme_tpu_torch.ops import sparse24 as ts
    from sparsifyme_tpu_torch.ops.kernels import ell_kernel, spmm24_kernel

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(21)
    m, n, k = NAMED
    a = torch.randn((BATCH, m, k), generator=gen, device="cuda").to(dt)
    b = torch.randn((k, n), generator=gen, device="cuda").to(dt)
    s = ts.compress_24(a)
    e, kp, bkb, _ = harness_ell(a, k)
    bp = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
    vals = e.values.reshape(-1, e.values.shape[-1])
    cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
    kwe = dict(block_size=128, block_k=bkb, out_dtype=dt)

    def ell(values):
        return BlockedEll(values, e.col_indices, e.shape, 128, bkb)

    cases = [
        ("spmm_24", spmm24_kernel.spmm24_cuda, (s.values0, s.values1, b),
         lambda v0, v1, y: ts.spmm_24(Sparse24(v0, v1, s.codes,
                                               shape=s.shape), y),
         lambda v0, v1, y: spmm24_kernel.spmm24_plain(
             v0, v1, s.codes, y, k_logical=k, out_dtype=dt).reshape(
                 BATCH, m, n)),
        ("spmm_ell", ell_kernel.ell_spmm_cuda, (e.values, bp),
         lambda v, y: te.spmm_ell(ell(v), y),
         lambda v, y: ell_kernel.ell_spmm_plain(
             v.reshape(vals.shape), cols, y, **kwe).reshape(e.shape[:-1]
                                                            + (n,))),
        ("spmm_ell_expand", ell_kernel.ell_expand_spmm_cuda,
         (vals.T.contiguous(), bp),
         lambda v, y: te.spmm_ell_expand(ell(e.values), y, values_km=v),
         lambda v, y: ell_kernel.ell_expand_spmm_plain(
             v, cols, y, **kwe).reshape(e.shape[:-1] + (n,))),
    ]
    for name, wrapper, inputs, route, plain in cases:
        grads, cot = [], None
        for fn in (route, plain):
            leaves = [x.detach().clone().requires_grad_() for x in inputs]
            n0 = wrapper.launches
            out = fn(*leaves)
            if cot is None:  # the kernel's route
                if out.grad_fn is None or wrapper.launches != n0 + 1:
                    raise AssertionError(f"{name}: the kernel did not run "
                                         "under autograd")
                cot = torch.randn(out.shape, generator=gen,
                                  device="cuda").to(out.dtype)
            grads.append(torch.autograd.grad(out, leaves, cot))
        for i, (got, want) in enumerate(zip(*grads)):
            close(name, got, want, dt,
                  f"{m}x{n}x{k}x{BATCH} bf16 grad of input {i}")
        del grads, out, cot
    del a, b, s, e, vals, cols, bp
    torch.cuda.empty_cache()


def _wrappers():
    from sparsifyme_tpu_torch.ops.kernels import (coo_kernel, ell_kernel,
                                                  prune_kernel, spmm24_kernel)
    from sparsifyme_tpu_torch.parallel import ring_kernel
    return {
        "prune_nm": prune_kernel.prune_nm_cuda,
        "compress_24": prune_kernel.compress_24_cuda,
        "prune_compress_24": prune_kernel.prune_compress_24_cuda,
        "spmm_24": spmm24_kernel.spmm24_cuda,
        "spmm_24_fold": spmm24_kernel.spmm24_fold_cuda,
        "spmm_24_wg": spmm24_kernel.spmm24_wg_cuda,
        "pack_wg": spmm24_kernel.pack_wgmma_sp_cuda,
        "spmm_ell": ell_kernel.ell_spmm_cuda,
        "spmm_ell_expand": ell_kernel.ell_expand_spmm_cuda,
        "spmm_coo": coo_kernel.spmm_coo_cuda,
        "ring_step": ring_kernel.ring_step_cuda,
        "ring_step_tiled": ring_kernel.ring_step_tiled_cuda,
        "ring_step_wg": ring_kernel.ring_step_wg_cuda,
        "ring_step_wg_tiled": ring_kernel.ring_step_wg_tiled_cuda,
    }


def probe_counts():
    """The probe kernels' launches, by kernels-line entry."""
    from sparsifyme_tpu_torch.bench import fused_probe, units_probe

    out = {}
    for name, (what, _) in PROBES.items():
        if name.startswith("fused_"):
            out[name] = fused_probe.fused_cuda.launches[what]
        elif what == "fp1":
            out[name] = units_probe.fp1_cuda.launches
        else:
            out[name] = units_probe.units_cuda.launches[what]
    return out


def launch_counts():
    from sparsifyme_tpu_torch.ops.kernels import spmm24_kernel

    return {**{name: fn.launches for name, fn in _wrappers().items()},
            TALL_ROUTE: spmm24_kernel.spmm24_wg_cuda.wg256_launches,
            **probe_counts()}


def reset_counts() -> None:
    from sparsifyme_tpu_torch.bench import fused_probe, units_probe

    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["spmm_24_wg"].wg256_launches = 0
    units_probe.fp1_cuda.launches = 0
    units_probe.units_cuda.launches.clear()
    fused_probe.fused_cuda.launches.clear()


def check_launched(counts, routes, path):
    for name in routes:
        if counts[name] <= 0:
            raise AssertionError(f"{name}: no launch on the {path} path")


def _winners(entry) -> str:
    """One line naming each family's tuned winner."""
    def knobs(family, keys):
        e = entry.get(family)
        if not e:
            return f"{family} untuned"
        return f"{family} " + " ".join(f"{k}={e.get(k)}" for k in keys)
    return " | ".join((
        knobs("gemm", ("fold",)), knobs("fused", ("fold",)),
        knobs("spmm24", ("design", "tile", "transpose_out", "packed",
                         "fold")),
        knobs("ell", ("formulation", "transpose_out", "block_k",
                      "fold_first", "block_n", "splits"))))


def bench_routes(shapes):
    """The routes the sweep must launch over ``shapes`` under the
    committed tuning table: K1, K2 and the fused route time every shape;
    K4 every ELL race (the untuned layouts, or the gather alternative);
    K3's wgmma_sp route and its pack where a shape can take the route
    (the untuned race and the tuned path's default take it there); K3's
    mma_sp tile where a race holds it (an untuned shape, a shape the
    wgmma_sp route cannot take, or a 2:4 winner that is not wgmma_sp);
    K3's fold route where a 2:4 winner folds; K5 where an ELL winner is
    the expand kernel, or an untuned ELL shape has k < 512."""
    from sparsifyme_tpu_torch.bench import tuning
    from sparsifyme_tpu_torch.ops.kernels.spmm24_kernel import wg_shape

    routes = {"prune_nm", "compress_24", "prune_compress_24", "spmm_ell"}
    for m, n, k, b in shapes:
        entry = tuning.lookup(m, n, k, b) or {}
        e24 = entry.get("spmm24") or {}
        wg = wg_shape(b * m, n, torch.bfloat16)
        if wg:
            routes.update(WG_ROUTES)
        if not (wg and e24.get("design") == "wgmma_sp"):
            routes.add("spmm_24")
        if int(e24.get("fold", 1) or 1) > 1:
            routes.add("spmm_24_fold")
        ell = entry.get("ell")
        if (ell and ell.get("formulation") == "expand") or \
                (not ell and k < 512):
            routes.add("spmm_ell_expand")
    return sorted(routes)


def phase_main_path():
    """The 49-layer sweep, on the committed tuning table."""
    from sparsifyme_tpu_torch.bench import harness, tuning
    from sparsifyme_tpu_torch.models.resnet_shapes import resnet_conv_shapes

    shapes = list(dict.fromkeys(resnet_conv_shapes("resnet50")))
    tuned = 0
    for sh in shapes:
        entry = tuning.lookup(*sh) or {}
        tuned += all(f in entry for f in TUNE_FAMILIES)
        print(f"  tuned {sh.m}x{sh.n}x{sh.k}x{sh.b} "
              f"({entry.get('card', 'no entry')}): {_winners(entry)}",
              flush=True)
    print(f"bench path: tuned {tuned}/{len(shapes)}", flush=True)
    if tuned != len(shapes):
        raise AssertionError(f"tuned {tuned}/{len(shapes)}: the committed "
                             "table must cover every family of every shape")
    routes = bench_routes(shapes)
    wg_by_shape = {}  # shape: (winning design, wgmma_sp launches so far)

    def on_shape(sh, res):
        wg_by_shape[sh] = (res.get("spmm24_design"),
                           launch_counts()["spmm_24_wg"])
    reset_counts()
    t0 = time.perf_counter()
    results, summary = harness.run_model_sweep("resnet50", iters=10, reps=3,
                                               verbose=True,
                                               on_shape=on_shape)
    counts = launch_counts()
    print(f"bench path: {len(results)} layers in "
          f"{time.perf_counter() - t0:.1f} s; launches {counts}; required "
          f"{routes}", flush=True)
    if len(results) != 49:
        raise AssertionError(f"expected 49 layers, got {len(results)}")
    check_launched(counts, routes, "bench")
    check_wg_winners(wg_by_shape, "bench")
    print("bench path: 2:4 winner by shape: " + ", ".join(
        f"{sh.m}x{sh.n}x{sh.k}x{sh.b} {d}"
        for sh, (d, _) in wg_by_shape.items()) + "; pack_ms: " + ", ".join(
        f"{r.pack_ms:.4f} (bound {r.pack_sol_ms:.4f})"
        for r in {(r.m, r.n, r.k, r.b): r for r in results}.values()),
        flush=True)
    print(json.dumps(harness.headline("resnet50", summary)), flush=True)
    for key in ("spmm24_speedup_geomean", "ell_speedup_geomean",
                "best_sparse_speedup_geomean", "fused_frac_sol_geomean"):
        v = summary[key]
        if not (math.isfinite(v) and v > 0):
            raise AssertionError(f"{key} = {v}")
    return counts


def check_wg_winners(wg_by_shape, path) -> None:
    """Each shape whose 2:4 winner is K3's wgmma_sp route launched it
    within that shape's run: ``{shape: (design, launches so far)}`` in the
    order the shapes ran."""
    before = 0
    for sh, (design, total) in wg_by_shape.items():
        if design == "wgmma_sp" and total <= before:
            raise AssertionError(f"{sh}: the 2:4 winner is wgmma_sp but "
                                 f"spmm_24_wg did not launch on the {path} "
                                 "path")
        before = total


def _hold_winners(m, n, k, entry, gen):
    """Each family's tuned winner at one shape against its plain version on
    the same card tensors: the fused planes exactly, the SpMMs within
    2e-2 (bf16)."""
    import torch.nn.functional as F

    from sparsifyme_tpu_torch.bench import harness
    from sparsifyme_tpu_torch.ops.kernels import (ell_kernel, prune_kernel,
                                                  spmm24_kernel)
    from sparsifyme_tpu_torch.ops.prune import prune_nm
    from sparsifyme_tpu_torch.ops.sparse24 import (compress_24,
                                                   pack_codes_fp, pack_wg,
                                                   prune_compress_24)

    dt = torch.bfloat16
    tag = f"{m}x{n}x{k}x{BATCH} winner"
    a = torch.randn((BATCH, m, k), generator=gen, device="cuda").to(dt)
    b = torch.randn((k, n), generator=gen, device="cuda").to(dt)
    fold = entry["fused"]["fold"]
    w2 = a.reshape(-1, k)
    if fold > 1:
        kp = -(-k // 64) * 64
        w2 = F.pad(w2, (0, kp - k)).reshape(-1, fold * kp)
    got = prune_compress_24(a, fold=fold)
    exact("prune_compress_24", (got.values0, got.values1, got.codes),
          prune_kernel.prune_compress_24_plain(w2), f"{tag} fold={fold}")
    del got, w2
    e24 = entry["spmm24"]
    pruned = prune_nm(a, 2, 4)[0]
    s = compress_24(pruned)
    s_fold = prune_compress_24(pruned, fold=2) if e24["fold"] > 1 else None
    s_wg = pack_wg(s) if spmm24_kernel.wg_shape(BATCH * m, n, dt) else None
    fn, ops = harness.spmm24_call(e24, s, s_fold, b, dt, s_wg)
    got = fn(*ops)
    kw = dict(k_logical=k, out_dtype=dt)
    if e24["fold"] > 1:
        want = spmm24_kernel.spmm24_fold_plain(
            s_fold.values0, s_fold.values1, s_fold.codes, b, **kw)
    else:
        codes = pack_codes_fp(s.codes) if e24["packed"] else s.codes
        want = spmm24_kernel.spmm24_plain(
            s.values0, s.values1, codes, b, transpose_out=e24[
                "transpose_out"], packed_codes=e24["packed"], **kw)
    close("spmm_24", got.reshape(want.shape), want, dt, f"{tag} {e24}")
    del pruned, s, s_fold, s_wg, got, want
    ee = entry["ell"]
    e, kp = harness.build_ell_operand(a, block_size=ee["block_size"],
                                      block_k=ee["block_k"],
                                      fold_first=ee["fold_first"])
    bp = F.pad(b, (0, 0, 0, kp - k))
    fn, ops = harness.ell_call(ee, e, bp, dt)
    got = fn(*ops)
    values = e.values.reshape(-1, e.values.shape[-1])
    cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
    kw = dict(block_size=ee["block_size"], block_k=ee["block_k"],
              out_dtype=dt, transpose_out=ee["transpose_out"])
    if ee["formulation"] == "gather":
        name = "spmm_ell"
        want = ell_kernel.ell_spmm_plain(values, cols, bp, **kw)
    else:
        name = "spmm_ell_expand"
        want = ell_kernel.ell_expand_spmm_plain(values.T, cols, bp, **kw)
    close(name, got.reshape(want.shape), want, dt, f"{tag} {ee}")
    del a, b, e, bp, got, want, values, cols
    torch.cuda.empty_cache()


def phase_tune_path():
    """The tuner at full width on three shapes, into a temporary table;
    then each winner against its plain version."""
    from sparsifyme_tpu_torch.bench import tune, tuning

    log = tune.TuneLog()
    entries = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tuning_table.json")
        reset_counts()
        t0 = time.perf_counter()
        for m, n, k in TUNE_SHAPES:
            print(f"  tune {m}x{n}x{k}x{BATCH}:", flush=True)
            wg0 = launch_counts()["spmm_24_wg"]
            entries[(m, n, k)] = tune.tune_shape(m, n, k, BATCH,
                                                 TUNE_FAMILIES, log=log)
            if launch_counts()["spmm_24_wg"] <= wg0:
                raise AssertionError(f"tune {m}x{n}x{k}: its wgmma_sp "
                                     "candidates launched no spmm_24_wg")
            tuning.save_table({tuning.shape_key(*sh, BATCH): e
                               for sh, e in entries.items()}, path)
        counts = launch_counts()
        seconds = time.perf_counter() - t0
        table = tuning.load_table(path)
    print(f"tune path: {len(TUNE_SHAPES)} shapes in {seconds:.1f} s; "
          f"candidates {log.candidates}; discarded under their bound "
          f"{len(log.discards)} {log.discards}; launches {counts}",
          flush=True)
    check_launched(counts, TUNE_ROUTES, "tune")
    for (m, n, k), entry in entries.items():
        key = tuning.shape_key(m, n, k, BATCH)
        if table.get(key) != entry or not all(f in entry
                                              for f in TUNE_FAMILIES):
            raise AssertionError(f"tune {key}: entry {entry}")
        print(f"  winners {key} ({entry['card']}): {_winners(entry)}",
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for (m, n, k), entry in entries.items():
        _hold_winners(m, n, k, entry, gen)
    return counts


def phase_plan_path():
    """spmma on the 17 unique ResNet-50 shapes, and the fold=2 route."""
    from sparsifyme_tpu_torch import (SpmmaConfig, get_plan,
                                      prune_compress_24, spmm_24, spmma)
    from sparsifyme_tpu_torch.models.resnet_shapes import resnet_conv_shapes

    shapes = list(dict.fromkeys(resnet_conv_shapes("resnet50")))
    if len(shapes) != 17:
        raise AssertionError(f"expected 17 unique shapes, got {len(shapes)}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    reset_counts()
    t0 = time.perf_counter()
    folds = wg_plans = 0
    for sh in shapes:
        a = torch.randn((sh.b, sh.m, sh.k), generator=gen,
                        device="cuda").to(torch.bfloat16)
        b = torch.randn((sh.k, sh.n), generator=gen,
                        device="cuda").to(torch.bfloat16)
        out, times = spmma(a, b, timed=True)
        if tuple(out.shape) != (sh.b, sh.m, sh.n) or not torch.isfinite(
                out).all():
            raise AssertionError(f"spmma {sh}: bad output")
        if not all(t.ms > 0 for t in times.values()):
            raise AssertionError(f"spmma {sh}: phase times {times}")
        plan = get_plan(SpmmaConfig(m=sh.m, n=sh.n, k=sh.k, batch=sh.b))
        fused = plan(a, b)
        phased = plan.matmul(plan.compress(plan.prune(a)), b)
        if not torch.equal(fused, phased):
            raise AssertionError(f"plan {sh}: fused != phased")
        line = " ".join(f"{k}={t.ms:.4f}" for k, t in times.items())
        # a bf16-out plan takes K3's wgmma_sp route where its table entry
        # lets it: packed in the compress step, launched by the matmul
        plan16 = get_plan(SpmmaConfig(m=sh.m, n=sh.n, k=sh.k, batch=sh.b,
                                      out_dtype="bfloat16"))
        wg0 = launch_counts()["spmm_24_wg"]
        out16 = plan16(a, b)
        if plan16._wg:
            wg_plans += 1
            if launch_counts()["spmm_24_wg"] <= wg0:
                raise AssertionError(f"plan {sh}: design {plan16.design} "
                                     "launched no spmm_24_wg")
        err = errors(out16, spmm_24(prune_compress_24(a), b,
                                    out_dtype=torch.bfloat16,
                                    design="mma_sp"))[1]
        if not err <= 2e-2:
            raise AssertionError(f"bf16 plan {sh}: rel err {err}")
        line += (f" bf16 plan {'wgmma_sp' if plan16._wg else 'mma_sp'} "
                 f"rel_err={err:.3e}")
        if -(-sh.k // 64) * 16 <= 256:
            ref = spmm_24(prune_compress_24(a), b)
            err = errors(spmm_24(prune_compress_24(a, fold=2), b), ref)[1]
            if not err <= 2e-2:
                raise AssertionError(f"fold=2 {sh}: rel err {err}")
            line += f" fold_rel_err={err:.3e}"
            folds += 1
        print(f"  plan {sh.m}x{sh.n}x{sh.k}x{sh.b}: {line} fused==phased",
              flush=True)
        del a, b, out, fused, phased
    counts = launch_counts()
    print(f"plan path: {len(shapes)} shapes ({folds} with fold=2, "
          f"{wg_plans} bf16 plans on wgmma_sp) in "
          f"{time.perf_counter() - t0:.1f} s; launches {counts}", flush=True)
    check_launched(counts, PLAN_ROUTES + (WG_ROUTES if wg_plans else ()),
                   "plan")
    return counts


def phase_coo_path():
    """BASELINE config 2 at full ResNet-101 width through its entry point;
    every point's K6 time must be finite and positive."""
    from sparsifyme_tpu_torch.bench.configs import config2_coo_resnet101

    reset_counts()
    t0 = time.perf_counter()
    result = config2_coo_resnet101()
    counts = launch_counts()
    seconds = time.perf_counter() - t0
    rows = result.pop("rows")
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps(result), flush=True)
    print(f"coo path: {len(rows)} points (shape stride "
          f"{result['shape_subset_stride']}) in {seconds:.1f} s; launches "
          f"{counts}", flush=True)
    if len(rows) != 102 or result["points"] != 102:
        raise AssertionError(f"expected 102 points, got {len(rows)}")
    bad = [r for r in rows if not (math.isfinite(r["coo_seg_ms"])
                                   and r["coo_seg_ms"] > 0)]
    if bad:
        raise AssertionError(f"coo_seg_ms not finite and positive: {bad}")
    check_launched(counts, COO_ROUTES, "coo")
    return counts


def phase_ring_path():
    """BASELINE config 4 at full size through its entry point (f32: K7's
    mma_sp step), then both K7 rings at the ResNet-scale shard against
    single-card ``spmm_24``: in bf16 on a container packed once
    (``pack_wg``: K7's wgmma_sp step) and in f32. Counters are set to 0
    before config 4 and read after the rings; config 4's routes are
    checked after it, the wgmma_sp step's after the rings."""
    from sparsifyme_tpu_torch import (make_mesh, spmm_24,
                                      spmm_24_ring_explicit,
                                      spmm_24_ring_tiled)
    from sparsifyme_tpu_torch.bench.configs import (
        RANKS, config4_row_partitioned_scaling)
    from sparsifyme_tpu_torch.ops.sparse24 import pack_wg
    from sparsifyme_tpu_torch.parallel import ring_graph
    from sparsifyme_tpu_torch.parallel.ring_kernel import _pick_mt

    print(f"ring path: torch.cuda.device_count() = "
          f"{torch.cuda.device_count()}; ranks -> cards: "
          + ", ".join(f"{r}->{d}" for r, d in enumerate(ring_devices(RANKS))),
          flush=True)
    reset_counts()
    t0 = time.perf_counter()
    result = config4_row_partitioned_scaling()
    counts = launch_counts()
    print(json.dumps(result), flush=True)
    print(f"ring path: config 4 in {time.perf_counter() - t0:.1f} s; "
          f"launches {counts}", flush=True)
    for pt in result["points"]:
        for key in ("ring_ms", "ideal_ms"):
            if not (math.isfinite(pt[key]) and pt[key] > 0):
                raise AssertionError(f"config 4 P={pt['devices']}: {key} = "
                                     f"{pt[key]}")
    for ring in ("explicit_overlap_ring", "tiled_ring"):
        if not result[ring]["max_rel_err_vs_ppermute"] <= 1e-4:
            raise AssertionError(f"config 4 {ring}: {result[ring]}")
    check_launched(counts, RING_MMA_ROUTES, "ring (config 4)")

    m, n, k = RING
    gen = torch.Generator(device="cuda").manual_seed(11)
    mesh = make_mesh((RING_P,), ("model",), devices=ring_devices(RING_P))
    for dtype in (torch.bfloat16, torch.float32):
        s, b = ring_operands(dtype, gen)
        mloc = s.values0.shape[1] // RING_P
        if (mloc, _pick_mt(mloc)) != (6272, 896):
            raise AssertionError(f"shard {mloc} rows, m-tile {_pick_mt(mloc)}")
        want = spmm_24(s, b, out_dtype=dtype)
        if dtype == torch.bfloat16:
            s = pack_wg(s)  # once, as a caller packs after compress
        captured = ring_graph.captures(mesh.axis_devices("model"),
                                       s.values0, b)
        for name, fn in (("ring_step", spmm_24_ring_explicit),
                         ("ring_step_tiled", spmm_24_ring_tiled)):
            ring_calls(name, lambda fn=fn: fn(s, b, mesh, "model",
                                              out_dtype=dtype),
                       want, dtype, f"{m}x{n}x{k}x{BATCH} P={RING_P} vs "
                       "spmm_24", captured)
        del s, b, want
    ring_graph.clear()
    counts = launch_counts()
    print(f"ring path: launches {counts}", flush=True)
    check_launched(counts, RING_WG_ROUTES, "ring")
    return counts


def conv_layers(gen):
    """The model path's conv layers at full ResNet-50 width (b=32, bf16,
    He-scaled weights): ``(name, layer, x, w)`` for each 2:4 layer, and an
    ELL layer where out_ch fills the 128-row block (``w``: the dense OIHW
    weight). Building them runs K1 and K2."""
    from sparsifyme_tpu_torch.bench.conv_probe import CONVS
    from sparsifyme_tpu_torch.models.sparse_conv import (EllConv2d,
                                                         SparseConv2d)

    out = []
    for name, cin, cout, ksz, stride, hw in CONVS:
        k = cin * ksz * ksz
        w = (torch.randn((cout, cin, ksz, ksz), generator=gen, device="cuda")
             * (2.0 / k) ** 0.5).to(torch.bfloat16)
        x = torch.randn((BATCH, hw, hw, cin), generator=gen,
                        device="cuda").to(torch.bfloat16)
        out.append((name, SparseConv2d(w, stride=stride), x, w))
        if cout % 128 == 0:
            out.append((name, EllConv2d(w, stride=stride), x, w))
    return out


def phase_model_path(trace_dir="traces/model_path"):
    """The model layer at full width, launch counters set to 0 once before
    it and each part required to launch its kernels: (1) the three conv
    layers, (2) the flagship MLP forward through ``entry()``, (3) ten SGD
    steps of the dp x tp train step on a 2 x 2 mesh, all three run once
    inside ``profile_trace`` (the busy share of that window is printed),
    then (4) ``dryrun_multichip(4)``. The oracles and the CPU runs they are
    held to come after the trace: K1 and K2 at the path's weight shapes
    against their plain versions, bit for bit; the layers against
    ``dense_reference``; the forward and three train steps (bf16, and the
    f32 update) against the CPU; then the timings, each layer against
    cuDNN."""
    import dataclasses

    import sparsifyme_tpu_torch.entry as tentry
    from sparsifyme_tpu_torch import make_mesh
    from sparsifyme_tpu_torch.bench.conv_probe import cudnn_conv
    from sparsifyme_tpu_torch.models import sparse_mlp as tmlp
    from sparsifyme_tpu_torch.models.sparse_conv import (
        SparseConv2d, _patch_columns, conv_weight_as_matrix)
    from sparsifyme_tpu_torch.ops.kernels.prune_kernel import (
        compress_24_plain, prune_nm_plain, same_bits)
    from sparsifyme_tpu_torch.utils.timing import time_kernel, \
        time_kernel_pair
    from sparsifyme_tpu_torch.utils.trace import busy_share, profile_trace

    def check_part(part, routes, before):
        """Every route in ``routes`` launched during the part (since the
        snapshot ``before``); returns the counts after it."""
        after = launch_counts()
        check_launched({k: after[k] - before[k] for k in after}, routes,
                       f"model ({part})")
        print(f"  model {part}: launches in the part "
              f"{ {k: after[k] - before[k] for k in routes} }", flush=True)
        return after

    def planes_exact(what, got, want):
        """``(values0, values1, codes)`` built on the card against the
        plain versions' on the CPU: the values bit for bit, the codes
        equal."""
        got = [t.detach().cpu() for t in got]
        exact("model_k1_k2", got[:2], want[:2], f"{what} values",
              same=same_bits)
        exact("model_k1_k2", got[2:], want[2:], f"{what} codes")

    def three_steps(step, params, x, y):
        for _ in range(3):
            _, params = step(params, x, y)
        return params

    gen = torch.Generator(device="cuda").manual_seed(31)
    cpu_gen = torch.Generator().manual_seed(32)
    x_mlp = torch.randn((tentry.ENTRY_BATCH, 256), generator=cpu_gen)
    y_mlp = (x_mlp @ (0.1 * torch.randn((256, 256), generator=cpu_gen)))
    x_mlp, y_mlp = (t.to(torch.bfloat16).cuda() for t in (x_mlp, y_mlp))
    config = tentry.ENTRY_CONFIG
    mesh = make_mesh((2, 2), ("data", "model"), devices=ring_devices(4))
    torch.cuda.synchronize()
    reset_counts()
    seen = launch_counts()
    # a profiler session can, rarely, come back without its device events:
    # parts 1-3 then run again in a new trace, and their launches count on
    for session in range(1, PROFILE_SESSIONS + 1):
        with profile_trace(trace_dir) as prof:
            t0 = time.perf_counter()
            layers = conv_layers(gen)
            with torch.no_grad():
                conv_outs = [layer(x) for _, layer, x, _ in layers]
            seen = check_part("1 conv layers", MODEL_CONV_ROUTES, seen)
            fn, (params0, x0) = tentry.entry()
            mlp_out = fn(params0, x0)
            seen = check_part("2 flagship forward", MODEL_MLP_ROUTES, seen)
            step = tmlp.make_train_step(mesh, config, lr=1e-2)
            params, losses = params0, []
            for i in range(MODEL_STEPS):
                loss, params = step(params, x_mlp, y_mlp)
                losses.append(loss)
                if i == 2:
                    params3 = params
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        seen = check_part("3 train steps", ("spmm_24",), seen)
        share = busy_share(prof)
        if share > 0:
            break
        print(f"  profiler session {session} of {PROFILE_SESSIONS} "
              "reported no device event", file=sys.stderr, flush=True)
    print(f"model path: device busy share {share:.4f} of the traced window "
          f"(parts 1-3, {traced_s:.3f} s, torch.profiler; trace in "
          f"{trace_dir})", flush=True)
    if not share > 0:
        raise AssertionError("the trace holds no device work")

    # part 4, and what parts 1-3 are held to
    tentry.dryrun_multichip(4)
    check_part("4 dryrun_multichip(4)", RING_MMA_ROUTES, seen)
    counts = launch_counts()
    print(f"  model path launches {counts}", flush=True)
    result = {"busy_share": share, "traced_s": traced_s, "convs": []}
    for (name, layer, x, w), out in zip(layers, conv_outs):
        if isinstance(layer, SparseConv2d):
            wm = conv_weight_as_matrix(w).cpu()
            planes_exact(f"{name} {tuple(wm.shape)}",
                         (layer.values0, layer.values1, layer.codes),
                         compress_24_plain(prune_nm_plain(wm, 2, 4)[0]))
        with torch.no_grad():
            err = close(type(layer).__name__, out, layer.dense_reference(x),
                        torch.bfloat16, f"{name} {tuple(x.shape)} vs F.conv2d")
            pair = time_kernel_pair(layer, (x,), cudnn_conv(layer), (x,),
                                    iters=10, reps=3)
            patch_ms = time_kernel(lambda t, lay=layer: _patch_columns(
                t, lay.kh, lay.kw, lay.stride, lay.padding), (x,),
                iters=10, reps=3).ms
        rows = out.shape[0] * out.shape[1] * out.shape[2]
        k = layer.in_ch * layer.kh * layer.kw
        result["convs"].append({
            "layer": name, "class": type(layer).__name__,
            "input": list(x.shape), "patches": [rows, k],
            "ms": pair.a.ms, "cudnn_ms": pair.b.ms, "ratio": pair.ratio,
            "patch_ms": patch_ms, "max_abs_err": err[0], "max_err": err[1]})
        del out
    # init_params on the CPU draws the same weights and runs the plain
    # prune and compress
    params_cpu = tmlp.init_params(config, torch.Generator().manual_seed(0),
                                  "cpu")
    for i, (lg, lc) in enumerate(zip(params0, params_cpu)):
        planes_exact(f"entry() layer {i} {tuple(lg[0].shape)}", lg[:3],
                     lc[:3])
        exact("model_mlp", (lg[3].cpu(),), (lc[3],), f"layer {i} bias")
    close("model_mlp", mlp_out.cpu(), fn(params_cpu, x0.cpu()),
          torch.bfloat16, "flagship forward 128x256 vs the CPU")
    cpu_mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    cpu_params = three_steps(tmlp.make_train_step(cpu_mesh, config, lr=1e-2),
                             params_cpu, x_mlp.cpu(), y_mlp.cpu())
    for i, (lc, lg) in enumerate(zip(cpu_params, params3)):
        exact("model_step", (lg[2].cpu(),), (lc[2],),
              f"layer {i} codes after 3 steps (card vs CPU)")
        for j in (0, 1, 3):
            close("model_step", lg[j].cpu(), lc[j], torch.bfloat16,
                  f"layer {i} param {j} after 3 steps (card vs CPU)")
    # bf16 rounding hides a small or missing update in the parameters: the
    # same three steps in f32, the update itself held to the CPU's
    config32 = dataclasses.replace(config, dtype="float32")
    runs = []
    for m, dev in ((mesh, "cuda"), (cpu_mesh, "cpu")):
        start = [tuple(t.to(dev).float() if t.is_floating_point()
                       else t.to(dev) for t in layer) for layer in params0]
        end = three_steps(tmlp.make_train_step(m, config32, lr=1e-2), start,
                          x_mlp.to(dev).float(), y_mlp.to(dev).float())
        runs.append([[e.cpu() - s.cpu() if j != 2 else e.cpu()
                      for j, (s, e) in enumerate(zip(ls, le))]
                     for ls, le in zip(start, end)])
    for i, (lg, lc) in enumerate(zip(*runs)):
        exact("model_step_f32", (lg[2],), (lc[2],),
              f"layer {i} codes after 3 f32 steps (card vs CPU)")
        for j in (0, 1, 3):
            close("model_step_f32", lg[j], lc[j], torch.float32,
                  f"layer {i} param {j} update, 3 f32 steps (card vs CPU)",
                  tol=UPDATE_TOL)
    losses = [float(t) for t in losses]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MODEL_STEPS):
        _, params = step(params, x_mlp, y_mlp)
    torch.cuda.synchronize()
    result["step_ms"] = (time.perf_counter() - t0) * 1e3 / MODEL_STEPS
    # the steady state: three more steps, traced (the profiler's own host
    # cost lowers this share)
    with profile_trace(trace_dir + "_steps") as prof:
        for _ in range(3):
            _, params = step(params, x_mlp, y_mlp)
    result["step_busy_share"] = busy_share(prof)
    print(f"model path: device busy share {result['step_busy_share']:.4f} "
          "over three warm train steps (torch.profiler)", flush=True)
    result["forward_ms"] = time_kernel(lambda t: fn(params0, t), (x0,),
                                       iters=20, reps=3).ms
    result["losses"] = losses
    print(json.dumps({"model_path": result}), flush=True)
    del layers, conv_outs
    torch.cuda.empty_cache()
    return counts


def phase_drivers() -> None:
    """Each driver once on the card at a ResNet-50 shape, held to its
    stdout contract; configs 1 and 3 in their quick form."""
    from sparsifyme_tpu_torch.bench import configs, drivers

    m, n, k = NAMED
    # batched_coo runs the unchunked oracle, whose [b, nnz, n] f32 gather
    # would take 30 GB at b=32: it runs at b=4.
    calls = [("sparsify", (m, k)), ("gemm", (m, n, k, BATCH)),
             ("spmm", (m, n, k, BATCH)), ("spmma", (m, n, k, BATCH)),
             ("batched_coo", (m, n, k, 4))]
    for kernel, args in calls:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            drivers.run(kernel, *args)
        lines = buf.getvalue().strip().splitlines()
        if kernel == "spmma":
            labels = [ln.split(":")[0] for ln in lines]
            vals = [float(ln.split(":")[1]) for ln in lines]
            ok = labels == ["Prune time", "Compress time", "Matmul time"]
        else:
            vals = [float(ln) for ln in lines]
            ok = len(lines) == 1
        if not ok or not all(math.isfinite(v) and v > 0 for v in vals):
            raise AssertionError(f"driver {kernel}: stdout {lines}")
        print(f"  driver {kernel} {' '.join(map(str, args))}: "
              + " | ".join(lines), flush=True)
    for cfg, key in ((1, "spmm24_speedup_geomean"), (3, "mul_ms_geomean")):
        out = configs.RUNNERS[cfg](quick=True)
        v = out[key]
        if out["backend"] != "cuda" or not (math.isfinite(v) and v > 0):
            raise AssertionError(f"config {cfg} quick: {out}")
        print(f"  config {cfg} quick: {out['layers']} layers, {key}={v:.4f}",
              flush=True)


def phase_torch_compare() -> None:
    """Dense ``torch.matmul`` against ``to_sparse`` + ``torch.sparse.mm``
    per batch, conversion timed apart, at three shapes (density 0.1)."""
    from sparsifyme_tpu_torch.bench.torch_compare import time_torch_pair

    for m, n, k in COMPARE_SHAPES:
        r = time_torch_pair(m, n, k, BATCH, 0.1)
        print(f"  torch_compare {m}x{n}x{k}x{BATCH} density 0.1: dense "
              f"{r['dense_ms']:.4f} ms, sparse {r['sparse_ms']:.4f} ms, "
              f"conversion {r['convert_ms']:.4f} ms, rel_err "
              f"{r['rel_err']:.3e} (tol 1e-2)", flush=True)
        if not (r["rel_err"] < 1e-2 and all(
                math.isfinite(r[key]) and r[key] > 0
                for key in ("dense_ms", "sparse_ms", "convert_ms"))):
            raise AssertionError(f"torch_compare {m}x{n}x{k}: {r}")


def phase_profiling_cli() -> None:
    """``profiling_cli --limit 2`` on the card: one driver process per
    kernel and shape, loading the kernels this run built. The shapes are
    the first two layers of ``datasets/shapes.csv`` whose weight (m x k)
    the ``sparsify`` driver's 2x2 blocks tile: its first layer, k = 147,
    is refused by ``prune_block_magnitude`` in both packages (dims must
    divide by the block, as the reference assumes)."""
    from sparsifyme_tpu_torch import _build
    from sparsifyme_tpu_torch.bench import profiling_cli
    from sparsifyme_tpu_torch.utils.shapes import read_shapes, write_shapes

    def built():
        return {p.name: p.stat().st_mtime_ns
                for p in _build.build_dir().iterdir()}

    shapes = [s for s in read_shapes(os.path.join(profiling_cli.REPO,
                                                  "datasets", "shapes.csv"))
              if s.m % 2 == 0 and s.k % 2 == 0][:2]
    before = built()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "compare.csv")
        src = os.path.join(tmp, "shapes.csv")
        write_shapes(src, shapes)
        rc = profiling_cli.main(["--limit", "2", "--shapes", src, "--out",
                                 out])
        with open(out) as f:
            rows = list(csv.reader(f))
    for row in rows:
        print(f"  compare.csv: {','.join(row)}", flush=True)
    print(f"profiling_cli: rc {rc}, {len(rows) - 1} rows in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 0 or rows[0] != ["layer", "m", "n", "k", "b", "gemm", "prune",
                              "spmm"] or len(rows) != 3:
        raise AssertionError(f"profiling_cli: rc {rc}, rows {rows}")
    vals = [float(x) for row in rows[1:] for x in row[5:]]
    if not all(math.isfinite(v) and v > 0 for v in vals):
        raise AssertionError(f"profiling_cli: times {vals}")
    if built() != before:
        raise AssertionError("a driver process rebuilt the kernels under "
                             f"{_build.build_dir()}")


def phase_probe_path() -> dict:
    """The probes of K3's tile and K2's fused route, once each at one shape
    (step 8b)."""
    from sparsifyme_tpu_torch.bench import fused_probe, units_probe

    gen = torch.Generator(device="cuda").manual_seed(12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_counts()
    u = units_probe.probe_shape(*PROBE_UNITS, gen, iters=10, reps=3)
    f = fused_probe.probe_shape(*PROBE_FUSED, gen, iters=5, reps=3)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"probe path: {time.perf_counter() - t0:.1f} s; launches "
          f"{ {k: counts[k] for k in PROBES} }", flush=True)
    check_launched(counts, list(PROBES), "probes")
    print(json.dumps({"probes": {"units": u, "fused": f}}), flush=True)
    return counts


def phase_mimo_path() -> dict:
    """K3's 256-row unit at MiMo-V2-Flash's 2:4 product shapes (step
    8c)."""
    from sparsifyme_tpu_torch.bench.wg_tall import SHAPES, forced
    from sparsifyme_tpu_torch.ops.kernels import spmm24_kernel as k3
    from sparsifyme_tpu_torch.ops.kernels.prune_kernel import (
        prune_compress_24_cuda)

    gen = torch.Generator(device="cuda").manual_seed(23)
    t0 = time.perf_counter()
    reset_counts()
    for name, m, k, n in SHAPES:
        tag = f"{name} {m}x{k} n {n} bf16"
        a = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        packed = k3.pack_wgmma_sp_cuda(*prune_compress_24_cuda(a))
        del a
        b = torch.randn((k, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        kw = dict(m=m, k_logical=k, out_dtype=torch.bfloat16)
        plan = k3.card_wg_plan(b.get_device(), m, n, k)
        if type(plan) is not k3.WgTallPlan:
            raise AssertionError(f"{TALL_ROUTE} {tag}: wg_plan gave {plan}")
        before = k3.spmm24_wg_cuda.wg256_launches
        got = k3.spmm24_wg_cuda(packed, b, **kw)
        if k3.spmm24_wg_cuda.wg256_launches != before + 1:
            raise AssertionError(f"{TALL_ROUTE} {tag}: the 256-row unit "
                                 f"did not launch")
        close(TALL_ROUTE, got, k3.spmm24_wg_plain(packed, b, **kw),
              torch.bfloat16, f"{tag} (packed words decoded)")
        with forced(k3.wg_forced_plan(m, n, k, plan.bn, plan.splits,
                                      k3.sm_count(b.get_device()))):
            short = k3.spmm24_wg_cuda(packed, b, **kw)
        exact(TALL_ROUTE, (got,), (short,),
              f"{tag} = the 128-row unit, {plan.splits} split(s)")
        del packed, b, got, short
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"mimo path: {time.perf_counter() - t0:.1f} s; launches "
          f"{ {k: counts[k] for k in ('spmm_24_wg', TALL_ROUTE)} }",
          flush=True)
    return counts


def phase_dsv3_path() -> dict:
    """K3 at DeepSeek-V3's 2:4 product shapes, through the model's own
    weights and products (step 8e)."""
    from sparsifyme_tpu_torch.models import moe_transformer as mt
    from sparsifyme_tpu_torch.ops.kernels import spmm24_kernel as k3
    from sparsifyme_tpu_torch.ops.sparse24 import spmm24_design

    k3_routes = ("spmm_24", "spmm_24_wg", TALL_ROUTE)
    gen = torch.Generator(device="cuda").manual_seed(26)
    t0 = time.perf_counter()
    reset_counts()
    for name, m, k, n, route in DSV3_SHAPES:
        tag = f"{name} {m}x{k} n {n} bf16"
        w = mt.sparse_weight(torch.randn((m, k), generator=gen,
                                         device="cuda").to(torch.bfloat16))
        b = torch.randn((k, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        design = spmm24_design(w, b, out_dtype=torch.bfloat16)
        if design != ("mma_sp" if route == "spmm_24" else "wgmma_sp"):
            raise AssertionError(f"{route} {tag}: spmm24_design gave "
                                 f"{design}")
        if design == "wgmma_sp":
            plan = k3.card_wg_plan(b.get_device(), m, n, k)
            if (type(plan) is k3.WgTallPlan) != (route == TALL_ROUTE):
                raise AssertionError(f"{route} {tag}: wg_plan gave {plan}")
        before = launch_counts()
        got = mt.linear(w, b)
        torch.cuda.synchronize()
        after = launch_counts()
        moved = {r: after[r] - before[r] for r in k3_routes}
        want = {"spmm_24": int(design == "mma_sp"),
                "spmm_24_wg": int(design == "wgmma_sp"),
                TALL_ROUTE: int(route == TALL_ROUTE)}
        if moved != want:
            raise AssertionError(f"{route} {tag}: launches {moved}, not "
                                 f"{want}")
        kw = dict(k_logical=k, out_dtype=torch.bfloat16)
        ref = (k3.spmm24_plain(w.values0, w.values1, w.codes, b, **kw)
               if design == "mma_sp" else
               k3.spmm24_wg_plain(w.wg.packed, b, m=m, **kw))
        close(route, got, ref, torch.bfloat16, f"{tag} ({design})")
        del w, b, got, ref
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"dsv3 path: {time.perf_counter() - t0:.1f} s; launches "
          f"{ {r: counts[r] for r in k3_routes} }", flush=True)
    return counts


def phase_moe_combine() -> dict:
    """The MoE combine kernel at MiMo-V2-Flash's shape against its plain
    version, and both device times (step 8d)."""
    from sparsifyme_tpu_torch.bench import moe_combine

    t0 = time.perf_counter()
    rec = moe_combine.measure()
    print(f"  moe_combine       MiMo 32768x4096 top 8 of 256, 32 held      "
          f"rel_err={rec['rel_err']:.3e} (tol 1e-06); bit for bit on "
          f"{rec['tokens_one_or_none']} tokens; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"moe_combine": rec}), flush=True)
    return rec


def phase_rms_norm() -> list:
    """The RMSNorm kernel at the model cells' norm shapes against its plain
    version, and both device times (step 8f)."""
    from sparsifyme_tpu_torch.bench import rms_norm

    recs = rms_norm.measure()
    for rec in recs:
        print(f"  rms_norm          {rec['hidden']}x{rec['tokens']} "
              f"{rec['dtype']:8s} {rec['layouts']:13s} "
              f"ulps={rec['max_ulps']} (tol 1); {rec['ms']:.4f} ms, "
              f"least {rec['least_ms']:.4f}, plain {rec['plain_ms']:.4f}",
              flush=True)
        print(json.dumps({"rms_norm": rec}), flush=True)
    return recs


def run_launcher(p: int) -> dict:
    """One ``torch.distributed.run`` job of ``p`` processes running the
    port's entry ``--processes``; rank 0's record. Its process group is
    killed at the time limit."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={p}", "-m", "sparsifyme_tpu_torch.entry",
           "--processes"]
    proc = subprocess.Popen(cmd, cwd=root, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=PROCESS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise AssertionError(f"process path P={p}: past "
                             f"{PROCESS_TIMEOUT_S} s")
    lines = [ln for ln in out.splitlines() if ln.startswith('{"processes"')]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(
            f"process path P={p}: launcher exit {proc.returncode}, "
            f"{len(lines)} result lines\n{out[-4000:]}\n{err[-8000:]}")
    for ln in out.splitlines():
        if ln.startswith("dryrun_processes"):
            print(f"  {ln}", flush=True)
    return json.loads(lines[0])["processes"]


def phase_process_path() -> dict:
    """The port's run with one rank per process (step 9b); the launch
    counts summed over every rank of every run."""
    cards = torch.cuda.device_count()
    sizes = [1] if cards < 2 else [p for p in (2, 4) if p <= cards]
    if cards < 2:
        print("process path: one card, so world size 1 only: P >= 2 needs "
              "one card per process (NCCL refuses two ranks on one card)",
              flush=True)
    counts = {name: 0 for name in _wrappers()}
    summary = []
    for p in sizes:
        t0 = time.perf_counter()
        rec = run_launcher(p)
        print(json.dumps({"processes": rec}), flush=True)
        for r, launches in enumerate(rec["launches_by_rank"]):
            for name in PROCESS_MUST:
                if launches[name] <= 0:
                    raise AssertionError(f"process path P={p}: {name} never "
                                         f"launched on rank {r}")
            for name, n in launches.items():
                counts[name] += n
        c4, train = rec["config4"], rec["train"]
        summary.append({
            "processes": p, "ring_ms": c4["ring_ms"],
            "ideal_ms": c4["ideal_ms"],
            "comm_efficiency": c4["comm_efficiency"],
            "step_ms": train["step_ms"], "losses": train["losses"],
            "busy_share": train["busy_share"],
            "launches_by_rank": rec["launches_by_rank"],
            "max_err_vs_one_process": rec["max_err_vs_one_process"],
            "launcher_s": time.perf_counter() - t0})
    print(json.dumps({"process_path": summary}), flush=True)
    return counts


def phase_machine(line: str) -> None:
    """``measure_machine()``'s rates beside the data sheet's."""
    from sparsifyme_tpu_torch.bench import roofline as rl

    report = rl.machine_report(rl.measure_machine())
    for key in ("dense_tflops", "hbm_gbps", "f32_tflops"):
        v = report[key]["measured"]
        if not (math.isfinite(v) and v > 0):
            raise AssertionError(f"measure_machine: {key} = {v}")
    print(json.dumps({"machine": report, "card": line}), flush=True)


def add_path_counts(kernels_line: dict, path: str, counts: dict) -> None:
    """Add one path's launches to the kernels line's entries."""
    for entry in kernels_line["kernels"]:
        n = counts.get(entry["name"], 0)
        entry["launches_by_path"][path] = n
        entry["launches"] += n


def _bound(flops, tflops, byts):
    from sparsifyme_tpu_torch.bench import roofline as rl
    ms = max(flops / (tflops * 1e12), byts / (rl.H100.hbm_gbps * 1e9)) * 1e3
    return ms, rl.bound_by(flops, tflops, byts)


def _coo_bound(nnz, slots, m, k, n):
    """K6: this run's nonzeros, f32 on the CUDA cores, bf16 B."""
    from sparsifyme_tpu_torch.bench import roofline as rl
    flops, byts = rl.coo_spmm_work(nnz, slots, m, k, n, BATCH)
    return _bound(flops, rl.H100.f32_tflops, byts)


def _ring_bytes(rows, n, k, p, tiles, design="mma_sp"):
    """What a whole ring must move in bf16: A as the ``design`` step reads
    it (``mma_sp``: the planes, 1.25 B a logical element; ``wgmma_sp``:
    the packed operand, 1.125), B and C once each, and the halo: each rank
    forwards its [k/P, n] shard P-1 times, once per m-tile."""
    a_bytes = 1.125 if design == "wgmma_sp" else 1.25
    return (a_bytes * rows * k + 2.0 * k * n + 2.0 * rows * n
            + 2.0 * p * (p - 1) * (k // p) * n * tiles)


def _ring_design_bytes(rows, n, p):
    """What K7's design adds to that: its f32 accumulator in device memory,
    written on the first step, read and written on the middle ones and read
    on the last ((P-1) * 8 B per C element). Outside the bound."""
    return 8.0 * (p - 1) * rows * n


def _device_ms(fn, ops, key="", calls=5, sessions=PROFILE_SESSIONS):
    """Device time per call of ``fn``: the durations of the kernels whose
    names hold ``key`` summed by ``torch.profiler`` (ranks' streams may
    overlap, so the sum can exceed the span they keep the card busy). A
    session that reports no device time at all is run again, up to
    ``sessions`` in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*ops)
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if sum(e.self_device_time_total for e in device) > 0:
            break
        print(f"  profiler session {session} of {sessions} reported no "
              "device time", file=sys.stderr, flush=True)
    us = sum(e.self_device_time_total for e in device if key in e.key)
    if not us > 0:
        raise AssertionError(f"the profiler saw no kernel named *{key}*")
    return us / 1e3 / calls


def _eager_ring(fn):
    """``fn`` with the ring-graph cache emptied before each call, so every
    call runs the ring eagerly. K7's device time is read from eager rings
    (the same kernels at the same shapes as a replay): the profiler does
    not dependably report the kernels that a replayed graph launches."""
    from sparsifyme_tpu_torch.parallel import ring_graph

    def run(*ops):
        ring_graph.clear()
        return fn(*ops)
    return run


def _enqueue_ms(fn, ops, calls=10):
    """The host's time to queue one call without waiting for the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*ops)
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def _plain_ring(fn, mesh, design):
    """``fn`` on ``mesh`` with the plain version of K7's ``design`` step in
    its place: the same ring, exchange and all, on the card."""
    from sparsifyme_tpu_torch.parallel import ring_kernel as rk

    names = ("ring_step_cuda", "ring_step_tiled_cuda", "ring_step_wg_cuda",
             "ring_step_wg_tiled_cuda")

    def run(s, b):
        saved = [getattr(rk, name) for name in names]
        rk.ring_step_cuda = rk.ring_step_tiled_cuda = rk.ring_step_plain
        rk.ring_step_wg_cuda = rk.ring_step_wg_tiled_cuda = \
            rk.ring_step_wg_plain
        try:
            return fn(s, b, mesh, "model", design=design)
        finally:
            for name, f in zip(names, saved):
                setattr(rk, name, f)
    return run


def phase_kernel_line(path_counts) -> dict:
    from sparsifyme_tpu_torch.bench import roofline as rl
    from sparsifyme_tpu_torch.bench import wg_tall
    from sparsifyme_tpu_torch.ops.coo import coo_layout, pack_coo
    from sparsifyme_tpu_torch.ops.ell import ell_to_dense, ell_values_kmajor
    from sparsifyme_tpu_torch.ops.kernels import (coo_kernel, ell_kernel,
                                                  prune_kernel, spmm24_kernel)
    from sparsifyme_tpu_torch.ops.sparse24 import (decompress_24,
                                                   prune_compress_24)
    from sparsifyme_tpu_torch.utils.timing import time_graph, time_kernel

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(99)
    specs = []

    def operands(m, n, k):
        a = torch.randn((BATCH, m, k), generator=gen, device="cuda").to(dt)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dt)
        return a, b

    # prune, compress, fused, 2:4 SpMM and ELL gather at the named shape
    m, n, k = NAMED
    rows = m * BATCH
    a, b = operands(m, n, k)
    pw = prune_kernel.prune_nm_cuda(a)[0]
    w2 = pw.reshape(-1, k)
    v0, v1, codes = prune_kernel.compress_24_cuda(w2)
    e, kp, bkb, _ = harness_ell(a, k)
    vals = e.values.reshape(-1, e.values.shape[-1])
    cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
    bp = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
    kw24 = dict(k_logical=k, out_dtype=dt)
    kwe = dict(block_size=128, block_k=bkb, out_dtype=dt)
    flops = 2.0 * rows * n * k
    tag = f"{m}x{n}x{k}x{BATCH} bf16"
    specs += [
        ("prune_nm", tag, prune_kernel.prune_nm_cuda,
         prune_kernel.prune_nm_plain, (a,), None,
         (rl.prune_sol_ms(m, k, BATCH), "bytes")),
        ("compress_24", tag, prune_kernel.compress_24_cuda,
         prune_kernel.compress_24_plain, (w2,), None,
         (rl.compress_sol_ms(m, k, BATCH), "bytes")),
        ("prune_compress_24", tag, prune_kernel.prune_compress_24_cuda,
         prune_kernel.prune_compress_24_plain, (a.reshape(-1, k),), None,
         (rl.fused_sol_ms(m, k, BATCH), "bytes")),
        ("spmm_24", tag,
         lambda *x: spmm24_kernel.spmm24_cuda(*x, **kw24),
         lambda *x: spmm24_kernel.spmm24_plain(*x, **kw24),
         (v0, v1, codes, b), (torch.matmul, (w2, b)),
         _bound(flops, rl.H100.sparse24_tflops,
                1.25 * rows * k + 2 * k * n + 2 * rows * n)),
        ("spmm_ell", f"{tag} bk={bkb}",
         lambda *x: ell_kernel.ell_spmm_cuda(*x, **kwe),
         lambda *x: ell_kernel.ell_spmm_plain(*x, **kwe),
         (vals, cols, bp),
         (torch.matmul, (ell_to_dense(e).reshape(-1, kp), bp)),
         _bound(flops / 2 * kp / k, rl.H100.dense_tflops,
                rows * kp + 2 * kp * n + 2 * rows * n)),
    ]

    # K1, K2 and K2's fused route also at their worst main-path shape
    m, n, k = NAMED_COMPRESS
    a, _ = operands(m, n, k)
    tag = f"{m}x{n}x{k}x{BATCH} bf16"
    specs += [
        ("prune_nm", tag, prune_kernel.prune_nm_cuda,
         prune_kernel.prune_nm_plain, (a,), None,
         (rl.prune_sol_ms(m, k, BATCH), "bytes")),
        ("compress_24", tag, prune_kernel.compress_24_cuda,
         prune_kernel.compress_24_plain,
         (prune_kernel.prune_nm_cuda(a)[0].reshape(-1, k),), None,
         (rl.compress_sol_ms(m, k, BATCH), "bytes")),
        ("prune_compress_24", tag, prune_kernel.prune_compress_24_cuda,
         prune_kernel.prune_compress_24_plain, (a.reshape(-1, k),), None,
         (rl.fused_sol_ms(m, k, BATCH), "bytes")),
    ]

    # K4 also at its worst main-path shape against torch.matmul
    m, n, k = NAMED_ELL_DEEP
    rows = m * BATCH
    a, b = operands(m, n, k)
    e, kp, bkd, _ = harness_ell(a, k)
    kwd = dict(block_size=128, block_k=bkd, out_dtype=dt)
    bpd = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
    specs.append((
        "spmm_ell", f"{m}x{n}x{k}x{BATCH} bf16 bk={bkd}",
        lambda *x: ell_kernel.ell_spmm_cuda(*x, **kwd),
        lambda *x: ell_kernel.ell_spmm_plain(*x, **kwd),
        (e.values.reshape(-1, e.values.shape[-1]),
         e.col_indices.reshape(-1, e.col_indices.shape[-1]), bpd),
        (torch.matmul, (ell_to_dense(e).reshape(-1, kp), bpd)),
        _bound(2.0 * rows * n * k / 2 * kp / k, rl.H100.dense_tflops,
               rows * kp + 2 * kp * n + 2 * rows * n)))

    # the fold=2 route at a main-path shape that fold accepts
    m, n, k = NAMED_FOLD
    rows = m * BATCH
    a, b = operands(m, n, k)
    s = prune_compress_24(a, fold=2)
    kwf = dict(k_logical=k, out_dtype=dt)
    specs.append((
        "spmm_24_fold", f"{m}x{n}x{k}x{BATCH} bf16",
        lambda *x: spmm24_kernel.spmm24_fold_cuda(*x, **kwf),
        lambda *x: spmm24_kernel.spmm24_fold_plain(*x, **kwf),
        (s.values0, s.values1, s.codes, b),
        (torch.matmul, (decompress_24(s).reshape(-1, k), b)),
        _bound(2.0 * rows * n * k, rl.H100.sparse24_tflops,
               1.25 * rows * k + 2 * k * n + 2 * rows * n)))

    # K3's wgmma_sp route at U, E and D against torch.matmul on the dense
    # A, on the operand packed once from K2's planes (its bound counts the
    # packed words, 1.125 B a logical element of the padded k); the pack at
    # U. Their extras: device time (graph_ms), queue time (enqueue_ms), and
    # K3's mma_sp tile and torch.matmul replayed in a graph on the same
    # operands (mma_sp_graph_ms, library_graph_ms).
    wg_ops = {}
    for m, n, k in WG_SHAPES:
        rows = m * BATCH
        a, b = operands(m, n, k)
        w2 = prune_kernel.prune_nm_cuda(a)[0].reshape(-1, k)
        v0, v1, codes = prune_kernel.compress_24_cuda(w2)
        packed = spmm24_kernel.pack_wgmma_sp_cuda(v0, v1, codes)
        kww = dict(m=rows, k_logical=k, out_dtype=dt)
        tag = f"{m}x{n}x{k}x{BATCH} bf16"
        wg_ops[tag] = ((v0, v1, codes, b), k, (w2, b))
        specs.append((
            "spmm_24_wg", tag,
            lambda pk, y, kw=kww: spmm24_kernel.spmm24_wg_cuda(pk, y, **kw),
            lambda pk, y, kw=kww: spmm24_kernel.spmm24_wg_plain(pk, y, **kw),
            (packed, b), (torch.matmul, (w2, b)),
            _bound(2.0 * rows * n * k, rl.H100.sparse24_tflops,
                   4.0 * packed.numel() + 2 * k * n + 2 * rows * n)))
        if (m, n, k) == WG_SHAPES[0]:
            specs.append((
                "pack_wg", tag, spmm24_kernel.pack_wgmma_sp_cuda,
                spmm24_kernel.pack_wgmma_sp, (v0, v1, codes), None,
                (rl.pack_wg_sol_ms(m, k, BATCH), "bytes")))

    # the same route on its 256-row unit at MiMo's six product shapes (the
    # MiMo path's), against torch.matmul on the dense pruned A
    for tall_name, m, k, n in wg_tall.SHAPES:
        a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        w2 = prune_kernel.prune_nm_cuda(a)[0]
        packed = spmm24_kernel.pack_wgmma_sp_cuda(
            *prune_kernel.compress_24_cuda(w2))
        b = torch.randn((k, n), generator=gen, device="cuda").to(dt)
        kww = dict(m=m, k_logical=k, out_dtype=dt)
        specs.append((
            TALL_ROUTE, f"{tall_name} {m}x{k} n {n} bf16",
            lambda pk, y, kw=kww: spmm24_kernel.spmm24_wg_cuda(pk, y, **kw),
            lambda pk, y, kw=kww: spmm24_kernel.spmm24_wg_plain(pk, y, **kw),
            (packed, b), (torch.matmul, (w2, b)),
            _bound(2.0 * m * n * k, rl.H100.sparse24_tflops,
                   4.0 * packed.numel() + 2 * k * n + 2 * m * n)))
        del a

    # K5 at its worst main-path shape against torch.matmul
    m, n, k = NAMED_EXPAND
    a, b = operands(m, n, k)
    e, kp, bkb, _ = harness_ell(a, k)
    vkm = ell_values_kmajor(e)
    cols = e.col_indices.reshape(-1, e.col_indices.shape[-1])
    bp = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
    live = int(ell_kernel.live_slots(cols, -(-kp // bkb)).sum())
    kwx = dict(block_size=128, block_k=bkb, out_dtype=dt)
    specs.append((
        "spmm_ell_expand", f"{m}x{n}x{k}x{BATCH} bf16 bk={bkb}",
        lambda *x: ell_kernel.ell_expand_spmm_cuda(*x, **kwx),
        lambda *x: ell_kernel.ell_expand_spmm_plain(*x, **kwx),
        (vkm, cols, bp),
        (torch.matmul, (ell_to_dense(e).reshape(-1, kp), bp)),
        _bound(2.0 * live * 128 * bkb * n, rl.H100.dense_tflops,
               2.0 * live * 128 * bkb + 4 * cols.numel() + 2 * kp * n
               + 2 * vkm.shape[1] * n)))

    # K6 at its kernels-line points, B bf16 as in config 2, on the layout
    # built beside the packing (outside every timed call). Its library
    # yardstick is cuSPARSE through torch.sparse.mm, in f32: the sparse
    # CUDA product refuses bf16 ("addmm_sparse_cuda" not implemented for
    # 'BFloat16'), so values and the folded [k, b*n] B are f32 there.
    for (m, n, k), sp in COO_POINTS:
        coo = coo_operand(m, k, sp, gen)
        packed = pack_coo(coo)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lay = coo_layout(*packed, k=k)
        torch.cuda.synchronize()
        print(f"coo layout {m}x{k} sp={sp}: kc={lay.kc}, built in "
              f"{(time.perf_counter() - t0) * 1e3:.4f} ms", flush=True)
        bb = torch.randn((BATCH, k, n), generator=gen, device="cuda").to(dt)
        a_sp = torch.sparse_coo_tensor(
            torch.stack([coo.rows.long(), coo.cols.long()]), coo.values,
            (m, k)).coalesce()
        b_fold = bb.float().permute(1, 0, 2).reshape(k, BATCH * n)
        # A (its planes and the layout built from them) is the format; the
        # timed operand is B, which the timer replicates
        specs.append((
            "spmm_coo", f"{m}x{n}x{k}x{BATCH} sp={sp} B bf16",
            lambda y, m=m, p=packed, lay=lay: coo_kernel.spmm_coo_cuda(
                *p, y, m=m, layout=lay),
            lambda y, m=m, p=packed: coo_kernel.spmm_coo_plain(*p, y, m=m),
            (bb,), (torch.sparse.mm, (a_sp, b_fold.contiguous())),
            _coo_bound(coo.nnz, packed[0].numel(), m, k, n)))

    # K7: a whole ring at the ResNet-scale shard, P = 4 ranks, on a
    # container packed once: each route on its wgmma_sp step, then on its
    # mma_sp step (the same call, the design forced)
    from sparsifyme_tpu_torch import (make_mesh, spmm_24_ring_explicit,
                                      spmm_24_ring_tiled)
    from sparsifyme_tpu_torch.ops.sparse24 import pack_wg
    from sparsifyme_tpu_torch.parallel import ring_graph
    from sparsifyme_tpu_torch.parallel.ring_kernel import _pick_mt

    m, n, k = RING
    rows = m * BATCH
    s, b = ring_operands(dt, gen)
    s = pack_wg(s)
    mesh = make_mesh((RING_P,), ("model",), devices=ring_devices(RING_P))
    mt = _pick_mt(rows // RING_P)
    dense_a = decompress_24(s).reshape(-1, k)
    design_bytes = _ring_design_bytes(rows, n, RING_P)
    ring_design = {}
    for name, fn, tiles, design in (
            ("ring_step_wg", spmm_24_ring_explicit, 1, "wgmma_sp"),
            ("ring_step_wg_tiled", spmm_24_ring_tiled, rows // RING_P // mt,
             "wgmma_sp"),
            ("ring_step", spmm_24_ring_explicit, 1, "mma_sp"),
            ("ring_step_tiled", spmm_24_ring_tiled, rows // RING_P // mt,
             "mma_sp")):
        ring_design[name] = design
        specs.append((
            name, f"{m}x{n}x{k}x{BATCH} P={RING_P}"
            + (f" m_tile={mt}" if tiles > 1 else "") + " bf16",
            lambda ss, y, fn=fn, design=design: fn(ss, y, mesh, "model",
                                                   design=design),
            _plain_ring(fn, mesh, design), (s, b),
            (torch.matmul, (dense_a, b)),
            _bound(2.0 * rows * n * k, rl.H100.sparse24_tflops,
                   _ring_bytes(rows, n, k, RING_P, tiles,
                               design=design))))

    captured = ring_graph.captures(mesh.axis_devices("model"), s.values0, b)
    out = []
    for name, shape, kern, plain, ops, lib, (bound, by) in specs:
        want = plain(*ops)
        extra = {}
        if name.startswith("ring_step"):
            # with B at a new address: one call that misses the graph cache
            # (the eager ring, what a caller with fresh operands pays), one
            # that captures and replays, then a replay, which is the result
            # held against the plain ring
            fresh = ops[1].clone()
            (abs_err, rel_err), extra["fresh_ms"], extra["capture_ms"] = \
                ring_calls(name, lambda: kern(ops[0], fresh), want, dt,
                           f"{shape} (kernels line)", captured)
            del fresh
        else:
            got = kern(*ops)
            if name in ("prune_nm", "compress_24", "prune_compress_24",
                        "pack_wg"):
                if name == "pack_wg":  # one tensor, not a tuple of them
                    got, want = (got,), (want,)
                exact(name, got, want, f"{shape} (kernels line)",
                      prune_kernel.same_bits if name == "prune_nm"
                      else torch.equal)
                abs_err = rel_err = 0.0
            else:
                abs_err, rel_err = close(
                    name, got, want,
                    torch.float32 if name == "spmm_coo" else dt,
                    f"{shape} (kernels line)")
            del got
        del want
        ms = time_kernel(kern, ops, iters=20, reps=5).ms
        plain_ms = time_kernel(plain, ops, iters=3, reps=3).ms
        lib_ms = (time_kernel(lib[0], lib[1], iters=20, reps=5).ms
                  if lib else None)
        by_path = {p: path_counts[p][name] for p in PATHS
                   if p in path_counts}
        if name.startswith(("ring_step", "spmm_ell", "spmm_coo")):
            # "ms" times calls as a caller sees them; the kernels' own
            # device time beside it, and the host's time to queue one call
            # without waiting for the card (near "ms", the host bounds it)
            if name.startswith("ring_step"):
                extra["kernel_ms"] = _device_ms(_eager_ring(kern), ops,
                                                "ring24")
                # the cache is empty again: an eager call and a capture, so
                # that enqueue_ms times replays
                kern(*ops)
                kern(*ops)
            else:
                extra["kernel_ms"] = _device_ms(kern, ops)
            extra["enqueue_ms"] = _enqueue_ms(kern, ops)
        if name.startswith("ring_step"):
            extra["design"] = ring_design[name]
            extra["design_bytes"] = design_bytes
        if name in WG_ROUTES + (TALL_ROUTE,):
            # device time with the calls replayed in a CUDA graph, and the
            # host's time to queue one (the wrapper must queue a call in
            # less than the kernel's time, or eager callers see the host)
            extra["graph_ms"] = time_graph(kern, ops, iters=20, reps=5).ms
            extra["enqueue_ms"] = _enqueue_ms(kern, ops)
        if name == "spmm_24_wg":
            planes, kk, dense_ops = wg_ops[shape]
            extra["mma_sp_graph_ms"] = time_graph(
                lambda *x, kk=kk: spmm24_kernel.spmm24_cuda(
                    *x, k_logical=kk, out_dtype=dt), planes, iters=20,
                reps=5).ms
            extra["library_graph_ms"] = time_graph(
                torch.matmul, dense_ops, iters=20, reps=5).ms
        if name == TALL_ROUTE:
            extra["library_graph_ms"] = time_graph(lib[0], lib[1], iters=20,
                                                   reps=5).ms
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "shape": shape,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": abs_err, "max_err": rel_err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            **extra,
        })
    # K4 on K5's operand: the two ELL formulations side by side
    gather_ms = time_kernel(
        lambda *x: ell_kernel.ell_spmm_cuda(*x, **kwx),
        (e.values.reshape(-1, e.values.shape[-1]), cols, bp), iters=20,
        reps=5).ms
    next(o for o in out if o["name"] == "spmm_ell_expand")["gather_ms"] = \
        gather_ms
    # each wgmma_sp ring beside the same call on the mma_sp step
    for wg_name, mma_name in (("ring_step_wg", "ring_step"),
                              ("ring_step_wg_tiled", "ring_step_tiled")):
        mma = next(o for o in out if o["name"] == mma_name)
        next(o for o in out if o["name"] == wg_name).update(
            mma_sp_ms=mma["ms"], mma_sp_kernel_ms=mma["kernel_ms"],
            mma_sp_enqueue_ms=mma["enqueue_ms"])
    out += probe_entries(path_counts, gen)
    return {"kernels": out}


def probe_entries(path_counts, gen) -> list:
    """The fourteen probe kernels' kernels-line entries, at the probe
    path's shapes: each held to its plain version on the same card tensors
    by the probe's own ``check``, then timed beside it; the units probes
    also carry ``graph_ms``, their device time with the calls replayed in a
    CUDA graph (``utils.timing.time_graph``: ``ms`` counts the host's time
    to queue a call where that is longer)."""
    from sparsifyme_tpu_torch.bench import fused_probe as fp
    from sparsifyme_tpu_torch.bench import units_probe as up
    from sparsifyme_tpu_torch.bench.roofline import H100
    from sparsifyme_tpu_torch.ops.kernels.spmm24_kernel import expand_planes
    from sparsifyme_tpu_torch.utils.timing import time_graph, time_kernel

    m, n, k = PROBE_UNITS
    ops = up.operands(m, n, k, gen)
    v0, v1, codes, b = ops
    packed = up.pack_wgmma_sp(v0, v1, codes)
    bq = up.fp1_operand(b)
    dense_a = expand_planes(v0, v1, codes).T.contiguous()
    bounds = up.bounds_ms(m, n, k)
    rows, kp = PROBE_FUSED
    x = torch.randn(PROBE_FUSED, generator=gen, device="cuda").to(
        torch.bfloat16)
    out = []
    for name, (what, replaces) in PROBES.items():
        extra = {}
        lib = None
        source = "sp24_units.cu"
        if name.startswith("fused_"):
            shape = f"{rows}x{kp} bf16"
            source = "compress_units.cu"
            kern = lambda y, md=what: fp.fused_cuda(y, md)  # noqa: E731
            plain = lambda y, md=what: fp.fused_plain(y, md)  # noqa: E731
            kops = pops = (x,)
            bound = (fp.floor_ms(rows, kp, H100.hbm_gbps), "bytes")
            abs_err, rel_err = fp.check(x, what)
            if what == "rm":
                extra["transposed_ms"] = time_kernel(
                    lambda y: [p.t().contiguous() for p in fp.fused_cuda(
                        y, "rm")], (x,), iters=10, reps=5).ms
        elif what == "fp1":
            shape = f"{m}x{n}x{k} tile 128x{128 if n % 128 == 0 else 64} bf16"
            abs_err, rel_err = up.check(*ops, what)
            kern, plain = up.fp1_cuda, up.fp1_plain
            kops, pops = (v0, v1, codes, bq), ops
            lib = (torch.matmul, (dense_a, bq))
            bound = bounds["fp1"]
        else:
            design, mode, st = what
            bm, bn = up.units_tile(v0, b, design)
            shape = f"{m}x{n}x{k} tile {bm}x{bn} bf16"
            abs_err, rel_err = up.check(*ops, (mode, st), design, packed)
            kw = dict(mode=mode, stages=st, design=design)
            if design == "wgmma_sp":
                source = "sp24_wg_units.cu"
                kern = lambda *y, kw=kw: up.units_cuda(  # noqa: E731
                    *y[:4], packed=y[4], **kw)
                kops = ops + (packed,)
            else:
                kern = lambda *y, kw=kw: up.units_cuda(*y, **kw)  # noqa
                kops = ops
            def plain(*y, md=mode, s=st, bm=bm, bn=bn):
                return up.units_plain(*y, mode=md, stages=s, bm=bm, bn=bn)
            pops = ops
            bound = bounds[mode]
            if mode == "full":
                lib = (torch.matmul, (dense_a, b))
        if name.startswith("units_"):
            extra["graph_ms"] = time_graph(kern, kops, iters=20, reps=5).ms
        print(f"  {name:17s} {shape + ' (kernels line)':44s} "
              f"rel_err={rel_err:.3e}", flush=True)
        by_path = {p: path_counts[p][name] for p in PATHS
                   if p in path_counts}
        out.append({
            "name": name, "route": "cuda",
            "source": "sparsifyme_tpu_torch/csrc/" + source,
            "replaces": replaces, "shape": shape,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": abs_err, "max_err": rel_err,
            "ms": time_kernel(kern, kops, iters=20, reps=5).ms,
            "plain_ms": time_kernel(plain, pops, iters=3, reps=3).ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": (time_kernel(lib[0], lib[1], iters=20, reps=5).ms
                           if lib else None),
            **extra,
        })
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    import sparsifyme_tpu_torch  # noqa: F401  (fails outside the repo)
    from sparsifyme_tpu_torch import _build

    line = card_line()
    print(f"card: {line} | torch: {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into "
          f"{_build.build_dir()}", flush=True)
    print("kernels against their plain versions:", flush=True)
    phase_kernels()
    phase_pipeline()
    print("gradients against the plain versions:", flush=True)
    phase_grads()
    counts = {}
    counts["bench"] = phase_main_path()
    print("tune path:", flush=True)
    counts["tune"] = phase_tune_path()
    counts["plan"] = phase_plan_path()
    counts["coo"] = phase_coo_path()
    counts["ring"] = phase_ring_path()
    print("model path:", flush=True)
    counts["model"] = phase_model_path()
    print("drivers and quick configs:", flush=True)
    phase_drivers()
    print("probe path:", flush=True)
    counts["probes"] = phase_probe_path()
    print("mimo path:", flush=True)
    counts["mimo"] = phase_mimo_path()
    print("moe combine:", flush=True)
    phase_moe_combine()
    print("dsv3 path:", flush=True)
    counts["dsv3"] = phase_dsv3_path()
    print("rms norm:", flush=True)
    phase_rms_norm()
    kernels_line = phase_kernel_line(counts)
    print("process path (one rank per process):", flush=True)
    add_path_counts(kernels_line, "procs", phase_process_path())
    phase_machine(line)
    # after the kernels line: once the driver processes of profiling_cli
    # had run, torch.profiler in this process missed kernel records (it
    # read a matmul under its bound on an H100), and _device_ms needs them
    # whole
    print("torch_compare and profiling_cli:", flush=True)
    phase_torch_compare()
    phase_profiling_cli()
    print(json.dumps(kernels_line), flush=True)
    print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
