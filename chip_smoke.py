#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py            # from the repository root

Drives the port's main paths through its hand-written kernels and checks
every result: the served path — lower -> compile_plan -> OptimisedServer —
through the five kernels a plan runs (matmul, implicit-GEMM conv, and the
Winograd point-GEMM with its input and inverse transforms), and the ``ops``
entry points of the four kernels no plan reaches (batched matmul,
single-image im2col conv, single-image Winograd point-GEMM, which runs the
two transforms too, flash attention), and the LM decode path, whose
prefill attention runs on the flash attention kernel, for the dense GQA
decoders and every other LM family, and the example scripts and the
matmul-site autotune, which times the matmul kernel at the LM GEMM sites.
Phases, each of which asserts:

1. The card (``nvidia-smi`` name and power limit), the torch / CUDA / nvcc
   versions, and the kernel build (one ``nvcc`` per source, in parallel,
   into ``build/kernels/``).
2. Each kernel against its plain PyTorch version on the card: at every call
   signature the served paths give it (recorded while the server binds and
   warms its per-bucket plans), and at the largest of them under every
   ``VARIANTS`` key and every epilogue combination, each call also against
   its own repeat, bit for bit (no kernel uses atomics, split plans
   included). Each kernel is then timed over one b=8 forward pass of every
   path that runs it (device time, launches replayed from a CUDA graph)
   beside its plain version, one library call computing the same function
   where there is one, and its bound.
3. edge_cnn served in bursts of 1, 3 and 8 under (a) the PBQP-selected tile
   assignment and (b) the kernel-mix assignment.
4. resnet18 at its published width (224x224 input, 64-512 channels) served
   in bursts of 8 under the kernel-mix assignment.
5. The entry points at full width, each path with the launch counters
   zeroed just before it and read just after: ``matmul_batch_op`` on
   resnet18's convolutions as per-image GEMMs at b=8 (weights broadcast
   over the batch, unfolded patches, bias and residual); ``conv_im2col_op``
   on each resnet18 conv of one 224x224 image; ``winograd_conv_op``
   (F(2x2)) and ``winograd_conv(m=4)`` on each 3x3 stride-1 resnet18 conv
   of one image; ``flash_attention_op`` on chatglm3_6b's attention (32 query
   heads over 2 KV heads, head dim 128) at the 4,096-token ``train_4k``
   length, batch cut to 1, causal and not, and on internvl2_1b's (14 over 2,
   head dim 64), causal. Each output is held to a kernel-free oracle
   (``F.conv2d``, or attention with the full score matrix); each kernel is
   then held to its plain version at every signature the paths gave it and
   under every ``VARIANTS`` key at the largest (flash attention: under
   every instantiated tile, causal and not), and timed as in phase 2.
   The kernels that take bf16 run bf16 paths too (named ``bf16``), on
   bf16 operands: ``matmul_batch_op`` on resnet18's convs at b=8 (all 20
   must run the wgmma route, ``csrc/matmul_wgmma.cu``: 3 with both operands
   by TMA, 17 with the patches gathered, conv0's weights too; the loaders
   per launch are printed, each layer's ms beside ``torch.matmul``'s),
   ``conv_im2col_op`` on each conv of one image and
   ``conv_im2col_batch_op`` on each conv at b=8 (bias and residual bf16,
   ReLU; every bf16 conv launch of at least 64 output channels, all 20 of
   resnet18's, must run the wgmma route, ``csrc/conv_wgmma.cu``, every
   other conv launch mma.sync), ``winograd_point_gemm`` and
   ``winograd_point_gemm_batch`` (b=8)
   on each 3x3 stride-1 conv's F(2x2) U and V (made by the weight and
   input transforms in fp32, then rounded once to bf16) under
   ``winograd/ops.plan`` (every bf16 point-GEMM launch the route rule
   gives wgmma must run it, ``csrc/winograd_wgmma.cu``, every other one
   mma.sync: 13 of resnet18's 13 at b=8, 11 on one image, whose last two
   convs have 4 and 1 columns), and
   ``flash_attention_op`` on the three attention shapes, each output
   (bf16) held to its fp32 oracle on the same values within one bf16
   rounding (``hold_bf16``; ``F.conv2d`` + the epilogue, the fp32 product)
   and each launch signature carrying bf16; their passes are timed against
   the bf16 bound (989 TFLOP/s, 2-byte traffic) and the bf16 library call
   (``torch.matmul``, ``F.conv2d``, a broadcast ``torch.matmul``, SDPA).
   The bf16 passes of the batched conv and point-GEMM join those kernels'
   fp32 served passes of phase 2.
   Flash attention's K and V keep their KV heads (``rep`` in the
   signature); every bf16 launch at d = 64 or 128 must run the wgmma route
   (``csrc/flash_wgmma.cu``), every other one mma.sync. The sweep of
   variants or tiles runs at the largest signature of each operand dtype
   (flash attention: both routes' tiles where a bf16 call takes both; the
   matmuls and the convs: both routes' plans of every variant). A
   bf16 output is held to the plain version's fp32 result on the same
   values within one bf16 rounding (``hold_bf16``), an fp32 output to the
   plain version at ``KERNEL_TOL``. Flash attention is also timed (and
   held) under every tile of each route on each of its paths, each bf16
   pass on both routes in turns (mma.sync / wgmma / wgmma / mma.sync,
   under ``AB_VARIANT``'s tiles) beside its bound and SDPA, and one head
   of its largest signature of each dtype is held to a float64 result on
   each route: the kernel no further from it than twice the plain
   version.
   The two Winograd transforms are held and timed over the served and the
   entry paths together.
6. The selection path, on a copy of ``artifacts/`` in a temporary
   directory (``optimise`` stores selections; the repository is never
   written): (a) the committed arm perf models (NN2 primitive model, linear
   DLT model) warm-loaded onto the card and onto the CPU, their predictions
   over the arm 60-triplet pool (1,014 x 49) and the DLT pool (161 x 6) held
   to each other at rtol=2e-5, and one forward of each timed on the card;
   (b) ``optimise("edge_cnn", "arm", executable=True)`` warm for models and
   selection, with the committed assignment, then a cold selection for every
   ``cnn_zoo.EXECUTABLE_NETS`` net on the card and on the CPU, required
   equal; (c) the selected edge_cnn (bursts of 1, 3, 8) and resnet18 (224x224,
   bursts of 8) plans registered in the phase-2 server and held to the
   oracle, launching no hand-written kernel (the committed models price the
   49 base primitives, which run plain torch); (d) ``reoptimise`` in factor
   mode twice from one fresh sample, deterministic and equal to the CPU's.
7. The paper's transfer onto the card (§4.4), everything trained into a
   temporary directory (the repository is never written): (a) a cold NN2
   pretrain in torch on the card for the simulated arm 60-triplet platform
   at the committed model's address (seed 0, 2,000 iterations, patience
   250), its test MdRAE beside the committed JAX-trained model's and held
   to ``ARM_MDRAE_LIMIT``, then the same for the simulated intel platform,
   the transfer source; (b) ``GpuPlatform`` profiled on the phase-7 pool
   (``transfer_pool``: every conv config of edge_cnn and resnet18, and a
   strided ``config_pool()`` subsample under a FLOP and an operand ceiling)
   over the 21 runnable primitives and the 55 tile columns, the tile
   columns timed through the hand-written kernels: the profiling seconds,
   the NaN share (NaN exactly where a column is inapplicable), each
   kernel's launches, wall and device medians of the fastest tile column
   of each base on named layers, and each tile column held to its base
   primitive at its largest pool config; (c) the transfer table, test
   MdRAE on the held-out card rows of the intel model unadapted, factor-,
   fine-tune- and scratch-calibrated on one ``TRANSFER_BUDGET``-row sample,
   and native; (d) ``optimise("edge_cnn", gpu, base=intel, mode="finetune",
   executable=True)``: its estimate and solver ms and selected columns, the
   measured per-image cost of its assignment against the measured-optimal
   assignment and the heuristic (and the seconds the measured selection
   took), and the selected plan served at b=8 against the oracle with its
   kernel launches.
8. The concurrent serving core (after the pump-mode img/s of phases 2-7),
   in phase 7's temporary directory: (a) ``OptimisedServer(workers=2)``
   with the three phase-2 paths, four client threads sending 64 requests to
   each path; each worker's stream not the default one, every response
   held to the oracle, no failed or degraded dispatch, both workers
   dispatching, the paths' kernels launched; img/s per path at b=8 with
   the three paths loaded at once (one client thread a path,
   ``SERVE_WINDOW_S`` windows), beside the pump mode's, and what those
   windows were made of: images per dispatch, host ms of one dispatch,
   queue wait, the share of the wall time in which one and both workers
   were executing, and the device's busy share of one profiled window; (b) the
   fault drill (Python's garbage collector off, after one collection): a
   persistent ``raise`` on one backend of edge_cnn / PBQP —
   its tickets served degraded by the safe plan on the card and held to
   the oracle, its breaker open after three failed dispatches, traffic
   spilling to the other backend, the breaker closed by a half-open probe
   once the faults end — then, after each worker has served the mix path
   once, a ``corrupt`` output caught and retried, and
   a ``hang`` abandoned at the execution deadline, rescued degraded, its
   worker replaced; (c) the drift drill: phase 7's transferred plan with a
   canary and ``make_recalibrator(mode="factor")``; a ``slowdown`` of three
   mean warm dispatch times (the first dispatch left out) sets off exactly
   one recalibration on the measured platform from the served
   observations, canaried and hot-swapped to generation 1, with its
   seconds, profiled and served rows and launches, every response before
   and after held to the oracle; (d) edge_cnn routed over four backends:
   ``arm`` (the committed models' plan), ``gpu`` (phase 7's), ``tpu`` (the
   simulated tile platform on the full 3,276-config pool, calibrated from
   phase 7's intel model: every conv on a tile column, so its plan runs the
   matmul kernel, and the Winograd point-GEMM with its transforms where it
   chose ``mm-*`` on a Winograd base) and ``host`` (``HostPlatform``
   measuring edge_cnn's 14 conv configs on the CPU, calibrated from the same
   model, its plan served on the card): the seconds the tpu and host
   preparation took, one burst pinned to each backend with the kernels it
   launched (exactly those its columns route to), 128 routed requests,
   each backend's columns, predicted per-image cost and requests, every
   response held to the oracle, then gpu unregistered; (e) the serving CLI
   on a copy of ``artifacts/``.
9. The process front end: ``OptimisedServer(workers=2, frontend_procs=2,
   max_batch=8)`` with edge_cnn / PBQP and resnet18 / mix, its slabs
   page-locked: (a) 64 requests a path through ``ingest`` (intake processes
   assemble the batches in shared memory), every response held to the
   oracle, the five served kernels launched; (b) 256 requests a path
   through ``drive``, the accounting adding up with nothing failed or
   rejected, img/s beside phase 8 (a)'s; (c) no intake process on the
   card (``nvidia-smi --query-compute-apps``) or with libcuda or libtorch
   mapped; (d) one resnet18 b=8 slab's upload (4.8 MB) timed with CUDA
   events from the page-locked slab and from a pageable copy, the same
   bytes arriving; (e) a ``raise`` and a ``hang`` schedule through the slab
   path on edge_cnn / mix: no ticket lost or duplicated, degraded rows
   delivered row by row, every response held to the oracle.
10. The LM decode path (``repro_torch.models.transformer``,
   ``launch.lm_decode``), chatglm3_6b (32 query heads over 2 KV heads, head
   dim 128), batch 2, weights from a seeded generator on the card: (a) at
   full width and depth in fp32, TF32 off: prefill a ragged 4,089-token
   prompt, decode 7 tokens teacher-forced from the cache, prefill all
   4,096, the last decode logits within 3e-3 of the full prefill's (the
   reference's bound), flash attention launched once a layer (28) in each
   prefill and no kernel in decode; (b) cut to 2 layers at full width:
   prefill (256 tokens) and two decode steps on the card within 1e-3 of
   the port on the CPU; (c) ``lm_decode.run`` on the registered bf16
   config, prompt 512, 32 tokens, twice: prefill ms, decode tok/s, peak
   memory; every flash launch of (c) carries bf16 q, k and v (the bf16
   kernel, no fp32 copy) and runs the wgmma route, of (a) and (b) fp32;
   every launch gets K and V at the config's 2 KV heads (rep 16). Flash attention is then held
   to its plain version at every signature the LM prefills launched, under
   every tile at the largest, and timed per prefill, at its dtype, beside
   its bound, plain version and SDPA.
11. The LM training path (``launch.steps``, ``launch.train``,
   ``models.transformer.loss_fn``, ``train.optim``, ``data.lm``,
   ``ckpt.manager``), chatglm3_6b at full width, data from
   ``data.lm.make_batch`` with seed 0, weights from a seeded generator on
   the card: (a) cut to 1 layer in fp32 (TF32 off), B=1, S=256, the card
   against the CPU port: the loss within 1e-3, each gradient leaf within
   1e-4 of its own max |g|, and each parameter's step (after minus before)
   in one AdamW (``optimizer_for``) and one Adafactor update from the CPU's
   gradients within 1e-2 lr; every attention gradient nonzero, no flash
   attention launch; (b) 8
   of 28 layers, bf16, remat, B=2, S=4,096: ten AdamW steps through
   ``train.train_loop``, every loss finite, step 1 near ln(vocab), step 10
   below step 1, no kernel launch; step ms (host clock to a device sync),
   tokens/s, model TFLOP/s (6 N T / step) beside the bf16 peak, the bound
   from the work the step needs (products 6 T per weight, causal attention
   forward and backward) and, apart, the remat re-forward and masked score
   blocks it also runs, peak memory, and one profiled step's device
   busy share and top device ops; (c) the 1-layer cut in bf16 with its
   AdamW state after one step, saved by ``CheckpointManager`` and restored
   onto the card bit for bit, GB written, save and restore s; (d) the CLI
   ``python -m repro_torch.launch.train`` on the reduced config, device
   defaulting to cuda: 4 steps, then 6 resuming from step 4, steps 5 and 6
   within 1e-5 of an uninterrupted run; (e) a 1-layer prefill launches
   flash attention once under ``torch.no_grad()`` and never with
   parameters that require grad, and the kernel refuses such operands.
12. The serving path of the other LM families (``models.{components,moe,
   ssm,transformer}``, ``launch.lm_decode``): minicpm3_4b (MLA),
   mixtral_8x7b and qwen3_moe_30b_a3b (MoE), mamba2_2_7b (SSM),
   zamba2_2_7b (hybrid) and whisper_medium (encoder-decoder over 1,500
   frames), at full width, B=2, weights and frames from a seeded generator
   on the card: (a) fp32, TF32 off, at the depths and lengths of
   ``FAMILY_HELD``: prefill, decode teacher-forced, prefill all of it, the
   last decode logits within 3e-3 of the full prefill's; MoE dropless
   (capacity E / K), with the (token, k) pairs the registered 1.25 would
   drop in that prefill printed; (b) each cut to 2 layers (zamba2 to 2
   groups): prefill (256 tokens) and two decode steps on the card within
   1e-3 of the port on the CPU, and for MoE the tokens whose top-k expert
   sets differ between the two printed; (c) ``lm_decode.run`` on the
   registered bf16 configs (mixtral cut to 16 of 32 layers), prompt 512,
   32 tokens, twice: prefill ms, decode tok/s, peak memory, every flash
   launch of (c) on bf16 q, k and v and on the wgmma route. Flash
   attention runs once a layer in a MoE prefill, 48 times in a Whisper
   prefill (its non-causal encoder and its causal decoder), never for MLA,
   SSM or zamba2 (head dim 80) and never in decode. Its new signatures are
   held to its plain version with phases 10 and 11's, and each prefill
   pass of (a) and (c)'s warm runs is timed beside its bound, plain
   version and SDPA.
13. The training path of the other LM families (``models.transformer.
   {forward,loss_fn}`` under autograd, ``models.{moe,ssm,components}``,
   ``launch.{steps,train}``), the six configs of phase 12 at full width,
   data from ``data.lm.make_batch`` with seed 0, weights from a seeded
   generator on the card: (a) each cut to one unit (a layer; zamba2 a group
   of 6 SSM blocks and the shared block; whisper an encoder and a decoder
   layer) in fp32 (TF32 off), B=1, S=256, MoE at the registered capacity
   1.25: the card against the CPU port, the loss within 1e-3, each
   gradient leaf within 1e-4 of its own max |g|, each parameter's step in
   one AdamW update from the CPU's gradients within 1e-2 lr, every leaf
   nonzero on the CPU nonzero on the card (the router, the SSM's A_log, D
   and dt_bias, MLA's latent projections, the shared block), for MoE the
   aux loss and 0 tokens whose top-k expert sets differ; (b)
   ``train.train_loop`` in bf16 with remat, B=2, S=4,096, at the depths of
   ``FAMILY_TRAIN_CUT`` (full width always), five AdamW steps a family and
   ten for MoE: every loss finite, step 1 near ln(vocab), step 5 below step
   1; for MoE the loss split into its language part and its aux loss each
   step and the language loss falling below step 1's within the ten (the
   total need not fall: AdamW's first steps move every router weight by
   ~lr, at full width the routing collapses and the aux loss climbs, and
   mixtral's loss spikes at steps 2-5); step ms (host clock to a device sync), tokens/s, model
   TFLOP/s (6 N T, N the cut's active parameters) beside the bf16 peak,
   peak memory, and one profiled step's device busy share and top device
   ops; (c) the CLI
   ``python -m repro_torch.launch.train`` on the reduced mixtral_8x7b and
   mamba2_2_7b, device defaulting to cuda: 4 steps, then 6 resuming from
   step 4, steps 5 and 6 within 1e-5 of an uninterrupted run. No path
   launches a kernel (the flash kernel has no backward).
14. The examples, the matmul-site autotune and the memory table: (a)
   ``examples/torch_quickstart.py`` and ``torch_transfer_learning.py`` at
   the reference's values (intel, 60 triplets, NN2 4,000 iterations, arm
   at 1%), the latter run again on its store and warm for all five models;
   ``torch_serve_optimized_cnn.py`` with two workers (``GpuPlatform``
   profiling the card), every sampled response held to the kernel-free
   oracle at 1e-3; ``torch_train_lm.py`` on the reduced mixtral_8x7b, 6
   steps, and 4 then 6 resumed, the resumed losses equal; (b)
   ``core.autotune``: ``build_dataset`` timing the 8 ``mm-*`` variants
   through the matmul kernel on bf16 operands (the 2-byte GEMMs the
   reference's surface prices) at the 39 distinct LM sites and a seeded
   sample (``MeasuredCost``), the NN2's held-out MdRAE, ``autotune_arch``
   for each config (predicted, default, oracle seconds), and per site the
   chosen variant's ms beside bf16 ``torch.matmul``'s on the same operands,
   the kernel held to its plain version at that shape (fp32 output, rtol
   1e-4 of the largest); the matmul kernel's bf16 row is then held and
   timed on one layer of chatglm3_6b's sites run through ``matmul_op``
   under the chosen variants, whose signatures must be among the
   autotune's own;
   (c) ``launch.dryrun --all``, the bytes of every cell against the card.
   The autotune must launch the matmul kernel, on bf16 operands only, and
   every launch at an LM site on the wgmma route (``csrc/matmul_wgmma.cu``;
   the route stands beside each site's ms, and the site pass's launches
   are counted per route); the other paths' launches are recorded.

Every served response is held at rtol=atol=1e-3 against the port's
interpreted executor on the card under the base (non-tile) columns — plain
torch, no hand-written kernel — so the oracle is independent of the kernels.
Launch counters are zeroed just before each served path and read just after
it. Each path's served img/s at b=8 follows, over several windows of
back-to-back bursts so the spread shows, with the device-busy time of one
burst under ``torch.profiler`` and the device ops that took most of it, by
device event and by the CPU op that launched it.
The selected paths of phase 6 are timed the same way.
The ``{"kernels": [...]}`` line has one row per kernel and operand dtype:
the seven TPU kernels and the two Winograd transforms in fp32, and the
seven TPU kernels again in bf16 (sixteen rows), each row's launches those
of the paths of its dtype. The routed kernels'
rows also count their launches per route (``launches_by_route`` over the
run, ``pass_launches_by_route`` over the timed pass: bf16 matmul operands
of at least 64 rows run ``csrc/matmul_wgmma.cu`` (each operand by TMA
or gathered, the loaders in the signature), the rest ``csrc/matmul.cu``; bf16 convs of at least 64 output channels run
``csrc/conv_wgmma.cu``, the rest ``csrc/im2col_gemm.cu``; bf16
point-GEMMs of at least 64 output channels, C % 8 == 0 and 8 or more
output columns run ``csrc/winograd_wgmma.cu``, the rest
``csrc/winograd.cu``; bf16 attention
at d = 64 or 128 runs ``csrc/flash_wgmma.cu``, the rest
``csrc/flash_attention.cu``) and name
the source of each route; a row's ``source`` is the route with most
launches in its timed pass. The bf16 flash row also carries its pass's
A/B of the two routes (``ab_ms``). Phase 5's matmul_batch passes
print their launches per route, and the bf16 sweep at the largest
signature covers the plans of both routes.
The last line of output is the ``{"ok": true, "device": ...}`` record.
The script fails (non-zero exit, no result) without a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import dataclasses
import math
import shutil
import subprocess
import sys
import tempfile
import time
from importlib import metadata
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): fp32 outside
# the tensor cores, TF32 on the tensor cores (a 3xTF32 product costs three),
# and HBM3 bandwidth
FP32_FLOPS = 67e12
TF32_FLOPS = 494.7e12
HBM_BYTES_S = 3.35e12

# BENCH_executor.json -> networks.edge_cnn.tile_variant.selected_assignment:
# the PBQP-selected tile column per edge_cnn conv node (joins take "chw")
EDGE_CNN_PBQP = {
    0: "im2col-copy-ab-ki@mm-256x256x256", 1: "im2col-scan-ab-ki@mm-256x256x256",
    2: "im2col-copy-ab-ki@mm-256x256x256", 3: "im2col-copy-ab-ki@mm-256x256x256",
    5: "im2col-scan-ab-ki@mm-256x256x256", 6: "im2col-scan-ab-ki@mm-256x256x256",
    7: "conv-1x1-gemm-ab-ki@mm-128x256x128", 9: "im2col-copy-ab-ki@mm-256x256x256",
    10: "im2col-scan-ab-ki@mm-256x256x256", 11: "im2col-copy-ab-ki@mm-256x256x256",
    12: "im2col-scan-ab-ki@mm-256x256x256", 14: "im2col-scan-ab-ki@mm-256x256x256",
    15: "im2col-scan-ab-ki@mm-256x256x256", 17: "im2col-scan-ab-ki@mm-256x256x256",
}

# the five kernels a served plan runs, and the four reached only through
# their ``ops`` entry points (phase 5); the two Winograd transforms run on
# both, around either point-GEMM
WINO_TRANSFORMS = ("winograd_input_transform", "winograd_inverse_transform")
SERVED_KERNELS = ("matmul", "conv_im2col_batch", "winograd_point_gemm_batch",
                  *WINO_TRANSFORMS)
ENTRY_KERNELS = ("matmul_batch", "conv_im2col", "winograd_point_gemm",
                 "flash_attention")

# Attention shapes (src/repro/configs/chatglm3_6b.py, internvl2_1b.py) at the
# train_4k sequence length (src/repro/launch/shapes.py); batch cut to 1.
ATTENTION = {
    "chatglm3_6b_causal": dict(heads=32, kv_heads=2, head_dim=128, seq=4096, causal=True),
    "chatglm3_6b_full": dict(heads=32, kv_heads=2, head_dim=128, seq=4096, causal=False),
    "internvl2_1b_causal": dict(heads=14, kv_heads=2, head_dim=64, seq=4096, causal=True),
}
ATTENTION_BF16 = tuple(ATTENTION)          # ... each also driven with bf16 q, k, v
AB_VARIANT = "fa-128x128"                  # flash_attention_op's default variant and
                                           # the LM prefill's (components.FLASH_VARIANT)
ENTRY_BATCH = 8                           # matmul_batch_op: images per call

# Phase 6: the committed arm model pair (artifacts/models/*/manifest.json) and
# the edge_cnn selection stored under it, read as data
ARTIFACTS = Path(__file__).resolve().parent / "artifacts"
EDGE_CNN_SELECTION = ARTIFACTS / "selections" / "cd7c5dc68f699685" / "data.json"
OPTIMISE_ARGS = dict(max_triplets=60, max_iters=2000, executable=True)
SELECT_BURSTS = {"edge_cnn": (1, 3, 8), "resnet18": (8,)}

# Phase 7: the committed arm NN2's training settings (its manifest), the
# test MdRAE a torch refit must reach, the card rows each transfer mode
# gets, and the profiling pool's cuts of config_pool() (3,276 configs)
TRANSFER_TRAIN = dict(seed=0, max_iters=2000, patience=250)
ARM_MDRAE_LIMIT = 0.10
TRANSFER_BUDGET = 28
PROFILE_STRIDE = 13                       # every 13th config_pool() config ...
PROFILE_MAX_FLOPS = 2e8                   # ... of at most 0.2 GFLOP
PROFILE_MAX_OPERANDS = 500_000            # ... and 5e5 image + weight elements
PROFILE_DLT_PAIRS = 24                    # dlt_pool(max_pairs=) beside the nets' tensors
PROFILE_REPEATS = 9
NAMED_LAYERS = {                          # (k, c, im, s, f) configs of the nets
    "edge_cnn 3x3 16->32 @30": (32, 16, 30, 1, 3),
    "edge_cnn 1x1 32->16 @28": (16, 32, 28, 1, 1),
    "resnet18 3x3 64->64 @56": (64, 64, 56, 1, 3),
    "resnet18 1x1 s2 128->256 @28": (256, 128, 28, 2, 1),
    "resnet18 3x3 256->256 @14": (256, 256, 14, 1, 3),
}

KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)   # fp32, unit-scale operands: sum order only
                                          # (also fp32 sums of bf16 operands: exact products)
BF16_RTOL = 2.0 ** -8                     # a bf16 output: one rounding of its fp32
                                          # result (half an ulp), plus the fp32
                                          # tolerance of the largest |result| (hold_bf16)
ORACLE_TOL = dict(rtol=1e-3, atol=1e-3)   # against F.conv2d / Winograd vs direct conv
SERVE_TOL = dict(rtol=1e-3, atol=1e-3)    # fp32 sum order compounding over ~20 layers
PRED_TOL = dict(rtol=2e-5, atol=0.0)      # perf-model forward, card vs CPU, plain fp32
LONG_CALL_MS, LONG_CALL_BUDGET_MS = 1.0, 200.0  # time_ms: eager above this
RATE_WINDOWS, RATE_WINDOW_S = 5, 2.0      # served img/s: windows per path, seconds each
TOP_DEVICE_OPS = 8                        # device ops listed per profiled burst
TOP_SIGNATURES = 4                        # costliest signatures listed per pass of a kernel
                                          # outside the tensor cores
SERVE_WINDOW_S = 1.0                      # phase 8 (a): seconds per img/s window
DRILL_HANG_S = 1.0                        # phase 8 (b): the injected hang ...
DRILL_DEADLINE_MS = 250.0                 # ... and the deadline that abandons it
DRILL_COOLDOWN_MS = 500.0                 # breaker hold before its half-open probe
DRILL_WARM_ROUNDS = 8                     # warm-up bursts allowed until both workers served
ROUTE_TPU_BUDGET = 0.05                   # phase 8 (d): the tile platform's calibration sample
ROUTE_HOST_REPEATS = 3                    # ... and the host CPU's timed calls a cell
ROUTE_PREP_S = 45.0                       # ... their preparation's target, seconds
DRIFT_CALIB_OBS = 8                       # phase 8 (c): dispatches that set the reference
DRIFT_ALPHA = 0.1                         # EWMA weight: one clamped 8x outlier moves it
                                          # 0.21 < log 1.5, a sustained 4x trips it in 4
DRIFT_MAX_BURSTS = 12                     # slowed bursts allowed to trip the monitor
FRONTEND_PROCS = 2                        # phase 9: intake processes ...
FRONTEND_SLOTS = 4                        # ... and slabs a bucket (resnet18's b=8
                                          # slab is 4.8 MB: 72 MB of shared memory)
FRONTEND_INGEST, FRONTEND_DRIVE = 64, 256  # requests a path: ingest, drive
UPLOAD_REPS = 20                          # timed uploads of one slab, each way
# Phase 10: the LM decode path, chatglm3_6b (src/repro/configs/chatglm3_6b.py)
# at full width and depth, batch 2
LM_ARCH, LM_BATCH = "chatglm3_6b", 2
LM_HELD_PROMPT, LM_HELD_STEPS = 4089, 7   # (a): a ragged prompt, then decode to 4,096
LM_DECODE_TOL = 3e-3                      # tests/test_models.py:102-103, the
                                          # reference's teacher-forced bound
LM_CPU_LAYERS, LM_CPU_PROMPT, LM_CPU_STEPS = 2, 256, 2   # (b): card vs the CPU port
LM_CPU_TOL = 1e-3                         # fp32 logits, sum order over 2 layers
LM_SERVED_PROMPT, LM_SERVED_TOKENS = 512, 32             # (c): the bf16 served run
# Phase 11: the LM training path, LM_ARCH at full width
TRAIN_CUT_LAYERS = 1                      # (a), (c), (e): cut to 1 layer ...
TRAIN_CUT_BATCH, TRAIN_CUT_SEQ = 1, 256   # ... at B=1, S=256
TRAIN_CPU_TOL = 1e-3                      # (a): card vs the CPU port, fp32 (TF32 off): loss
TRAIN_GRAD_RTOL = 1e-4                    # ... each gradient leaf, of its own max |g|
TRAIN_STEP_TOL = 1e-2                     # ... each parameter's step, in units of lr,
                                          # both sides updating from the CPU's gradients
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 8, 2, 4096   # (b): train_4k's length, its
TRAIN_STEPS = 10                                    # global batch of 256 cut to 2
TRAIN_FIRST_LOSS_SLACK = 1.5              # (b): step 1 within this of ln(vocab)
TRAIN_RESUME_TOL = 1e-5                   # (d): resumed vs uninterrupted losses
BF16_FLOPS = 989e12                       # H100 SXM dense bf16 (data sheet, 700 W)
# Phase 12: the LM families' serving path at full width, batch LM_BATCH.
# (a), fp32: layers (None: full depth), prompt, teacher-forced steps
FAMILY_HELD = {
    "minicpm3_4b": (None, 2040, 8),        # <= 2,048 tokens: one-shot attention
    "mixtral_8x7b": (4, 4089, 7),          # 5.8 GB a layer in fp32; the grown
                                           # 4,096 slots are its window: a ring
    "qwen3_moe_30b_a3b": (8, 4089, 7),
    "mamba2_2_7b": (16, 1792, 256),        # multiples of the 256-token chunk; 256
    "zamba2_2_7b": (2, 1792, 256),         # decode steps, host-bound, so a quarter
                                           # of the depth (16 of 64 layers, 2 of 9
                                           # groups) for the script's time limit
    "whisper_medium": (None, 440, 8),      # within the 448-token decoder context
}
WHISPER_FRAMES = 1500                      # 30 s of audio at 50 frames a second
FAMILY_SERVED_CUT = {                      # (c): depth cuts of the bf16 runs
    "mixtral_8x7b": (16, "its 32 layers' 93.1 GB of bf16 weights do not fit "
                         "one 80 GB card"),
}
# Phase 13: the LM families' training path at full width. (b): train_loop,
# bf16, remat, AdamW, B=TRAIN_BATCH at S=TRAIN_SEQ (train_4k's length, its
# global batch of 256 cut to 2). Units trained (layers; zamba2 groups of 6;
# whisper encoder and decoder layers each; None: full depth) and why. AdamW
# keeps bf16 weights and gradients and fp32 m and v (12 bytes a parameter);
# its update builds the new weights, m and v beside the old ones and makes
# fp32 temporaries of each stacked leaf, so a step peaks near 2 x (weights,
# m, v) + gradients + 16 bytes an element of the largest leaf.
FAMILY_TRAIN_CUT = {
    "minicpm3_4b": (16, "half of the 32 that fit (full depth is 41 GB of weights "
                        "and moments, ~106 GB at the update), for the script's "
                        "time limit"),
    "mixtral_8x7b": (1, "2 layers (~82 GB at the update) ran out of memory"),
    "qwen3_moe_30b_a3b": (3, "4 layers (~75 GB at the update) ran out of memory"),
    "mamba2_2_7b": (24, "half of the 48 that fit (64 and 56 layers, ~87 and ~77 "
                        "GB at the update, ran out of memory), for the script's "
                        "time limit"),
    "zamba2_2_7b": (3, "half of the 6 groups that fit (9 and 8 ran out of "
                       "memory), for the script's time limit"),
    "whisper_medium": (12, "half depth, for the script's time limit"),
}
FAMILY_TRAIN_STEPS = 5                    # (b): AdamW steps a family; MoE takes
                                          # TRAIN_STEPS (mixtral spikes at steps 2-5)
FAMILY_TRAIN_CLI = ("mixtral_8x7b", "mamba2_2_7b")   # (c): the CLI resumed
EXAMPLE_SERVE = dict(requests=16, batch=8, workers=2)  # phase 14 (a): the served example
EXAMPLE_TRAIN = ("mixtral_8x7b", 6, 4)    # (a): train_lm arch, steps, resumed from
EXAMPLE_TRAIN_TOL = 0.0                   # (a): resumed vs uninterrupted losses, bit for bit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20, help="timed launches per call")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import common
    from repro_torch.models import cnn_zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: card, toolchain, build ----------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = next(line.strip() for line in subprocess.run(
        [common.nvcc_path(), "--version"], capture_output=True, text=True,
        check=True).stdout.splitlines() if "release" in line)
    try:
        triton = metadata.version("triton")       # not used by the port
    except metadata.PackageNotFoundError:
        triton = "not installed"
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  nvcc: {nvcc}  triton {triton}")
    build_s = common.build_kernels()
    print(f"kernel build: {build_s:.1f} s ({len(common.LIBRARIES)} libraries, "
          f"parallel nvcc, sm_90a)", flush=True)

    # -- phase 2: register the served paths, hold each kernel to its plain
    # version at their shapes, time it -----------------------------------
    paths = {
        "edge_cnn_pbqp": (cnn_zoo.get("edge_cnn"), None),
        "edge_cnn_mix": (cnn_zoo.get("edge_cnn"), kernel_mix_assignment),
        "resnet18_mix": (cnn_zoo.get("resnet18"), kernel_mix_assignment),
    }
    server, nets, weights = make_server(torch, paths, args.seed)
    seen_all = {k: set(c) for k, c in common.SEEN.items()}   # warm-up signatures
    # one b=8 forward per path: each kernel's launches and signatures per pass
    rng = np.random.default_rng(args.seed + 1)
    assert set(SERVED_KERNELS) | set(ENTRY_KERNELS) == set(common.KERNELS)
    per_pass = {k: {} for k in SERVED_KERNELS}
    for name, opt in nets.items():
        common.reset_launches()
        server.serve(name, list(images(rng, opt.spec, 8)))
        for k in SERVED_KERNELS:
            if common.SEEN[k]:
                per_pass[k][name] = dict(common.SEEN[k])
    report = {k: check_and_time(torch, k, seen_all[k], per_pass[k], args.reps)
              for k in SERVED_KERNELS if k not in WINO_TRANSFORMS}
    torch.cuda.synchronize()

    # -- phases 3 and 4: serve and hold every response to the oracle ------
    bursts = {"edge_cnn_pbqp": (1, 3, 8), "edge_cnn_mix": (1, 3, 8),
              "resnet18_mix": (8,)}
    launches = {}
    serve_err = {}
    for name, sizes in bursts.items():
        opt = nets[name]
        reqs = [images(rng, opt.spec, b) for b in sizes]
        common.reset_launches()
        outs = [server.serve(name, list(r)) for r in reqs]
        torch.cuda.synchronize()
        launches[name] = took(name)
        want = routed_kernels(opt.assignment)
        assert all(launches[name][k] > 0 for k in want), (name, launches[name])
        assert all(launches[name][k] == 0 for k in common.KERNELS if k not in want)
        serve_err[name] = check_responses(opt, weights[name], reqs, outs)
        print(f"served {name}: bursts {sizes}, max |served - oracle| = "
              f"{serve_err[name]:.3g}, launches {launches[name]}", flush=True)
    for k in SERVED_KERNELS:
        assert sum(launches[p][k] for p in launches) > 0, k

    # -- phase 5: the entry points at full width --------------------------
    resnet18 = conv_layers(cnn_zoo.get("resnet18"))
    bf16_paths = bf16_entry_paths("resnet18", resnet18,
                                  {n: ATTENTION[n] for n in ATTENTION_BF16},
                                  ENTRY_BATCH)
    entry_paths = {**entry_point_paths("resnet18", resnet18, ATTENTION, ENTRY_BATCH),
                   **bf16_paths}
    entry_seen = {k: {} for k in common.KERNELS}
    oracle_err = {}
    for name, (kernel, drive, want) in entry_paths.items():
        common.reset_launches()
        oracle_err[name] = drive(torch, "cuda", np.random.default_rng(args.seed))
        torch.cuda.synchronize()
        launches[name] = took(name)
        check_path_dtype(name, "bfloat16" if name in bf16_paths else "float32")
        for k in want:
            entry_seen[k][name] = dict(common.SEEN[k])
            assert launches[name][k] > 0, (name, k, launches[name])
        assert all(n == 0 for k, n in launches[name].items() if k not in want)
        routes = {k: PATH_ROUTES[name][k] for k in ROUTED if k in want}
        if name in bf16_paths and kernel in WINOS:   # each on its route, above
            assert routes[kernel]["bfloat16"].get("wgmma", 0) > 0, (name, routes[kernel])
        if name in bf16_paths and kernel == "matmul_batch":   # every conv on wgmma
            assert routes[kernel] == {"bfloat16": {"wgmma": len(resnet18)}}, routes
        how = mm_loaders(name, kernel) if kernel == "matmul_batch" else {}
        print(f"entry {name}: max |out - oracle| = {oracle_err[name]:.3g}, "
              f"launches {({k: launches[name][k] for k in sorted(want)})}"
              + (f", by dtype and route {routes}" if routes else "")
              + (f", wgmma loaders (A/B) {how}" if how else ""),
              flush=True)
    for k in ENTRY_KERNELS:
        seen = set().union(*(set(c) for c in entry_seen[k].values()))
        report[k] = check_and_time(torch, k, seen, entry_seen[k], args.reps,
                                   ab=k == "flash_attention")
    # rows 2 and 3: their bf16 phase-5 passes join their fp32 served passes
    for k in ("conv_im2col_batch", "winograd_point_gemm_batch"):
        seen = set().union(*(set(c) for c in entry_seen[k].values()))
        join_passes(report[k], check_and_time(torch, k, seen, entry_seen[k],
                                              args.reps))
    for k in (*ENTRY_KERNELS, "conv_im2col_batch", "winograd_point_gemm_batch"):
        by_dtype = report[k]["oracle_max_abs_err_by_dtype"] = {}
        for p in entry_seen[k]:
            dt = "bfloat16" if p in bf16_paths else "float32"
            by_dtype[dt] = max(by_dtype.get(dt, 0.0), oracle_err[p])
    # the transforms: every signature of the served and the entry paths
    for k in WINO_TRANSFORMS:
        seen = seen_all[k].union(*(set(c) for c in entry_seen[k].values()))
        report[k] = check_and_time(torch, k, seen,
                                   {**per_pass[k], **entry_seen[k]}, args.reps)
    torch.cuda.synchronize()

    # -- phase 6: the selection path, served -------------------------------
    selection = selection_phase(torch, server, nets, weights, launches,
                                serve_err, args.seed, rng, smi)

    with tempfile.TemporaryDirectory(prefix="chip_smoke.") as td:
        # -- phase 7: the transfer onto the card, served -------------------
        transfer, transferred = transfer_phase(
            torch, server, nets, weights, launches, serve_err, args.seed,
            rng, smi, Path(td))

        rates = {name: images_per_s(server, nets[name], rng) for name in nets}
        busy = {name: device_busy(server, nets[name], rng) for name in nets}

        # -- phase 8: the concurrent serving core on the card --------------
        serving = serving_phase(torch, nets, weights, launches, transferred,
                                rates, rng, smi, Path(td))

    # -- phase 9: the process front end on the card ------------------------
    frontend = frontend_phase(torch, nets, weights, launches, serving, rng,
                              smi)

    # -- phase 10: the LM decode path on the card ---------------------------
    lm, lm_passes = lm_phase(torch, launches, args.seed, smi)

    # -- phase 11: the LM training path on the card -------------------------
    training, train_passes = train_phase(torch, launches, args.seed, smi)
    lm_passes.update(train_passes)

    # -- phase 12: the LM families' serving path on the card ---------------
    families, family_passes, family_seen = families_phase(
        torch, launches, args.seed, smi)
    lm_passes.update(family_passes)

    # -- phase 13: the LM families' training path on the card --------------
    families_train = families_train_phase(torch, launches, args.seed, smi)
    # -- phase 14: the examples, the matmul-site autotune, the memory table
    examples, site_pass = examples_phase(torch, launches, args.seed, smi)

    lm_seen = set().union(family_seen, *(set(c) for c in lm_passes.values()))
    lm_kernel = check_and_time(torch, "flash_attention", lm_seen, lm_passes,
                               args.reps)
    fa = report["flash_attention"]             # row 7 gains its LM passes
    fa["max_abs_err"] = max(fa["max_abs_err"], lm_kernel["max_abs_err"])
    for dt, err in lm_kernel["max_abs_err_by_dtype"].items():
        fa["max_abs_err_by_dtype"][dt] = max(fa["max_abs_err_by_dtype"].get(dt, 0.0), err)
    fa["lm_path"] = {
        "max_abs_err": lm_kernel["max_abs_err"],
        "max_abs_err_by_dtype": lm_kernel["max_abs_err_by_dtype"],
        "float64_err_by_dtype": lm_kernel["float64_err_by_dtype"],
        "passes": {p: {key: t[key] for key in (
            "launches", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_fp32_ms", "dtype", "routes")} for p, t in lm_kernel["passes"].items()}}
    # row 1's bf16 pass: the autotune's choice for one layer of LM_ARCH
    join_passes(report["matmul"], check_and_time(
        torch, "matmul", set(next(iter(site_pass.values()))), site_pass,
        args.reps))

    # -- report -----------------------------------------------------------
    summary = {k: {"launches": {p: launches[p][k] for p in launches},
                   "max_abs_err": r["max_abs_err"],
                   "passes": r["passes"],
                   **({"sources_by_route": ROUTE_SOURCES[k]} if k in ROUTED else {})}
               for k, r in report.items()}
    print("kernels: " + json.dumps(summary))
    for name, r in rates.items():
        med = float(np.median(r))
        print(f"served img/s {name} b=8: median {med!r} over {len(r)} windows "
              f"{[round(x, 1) for x in r]} (min {min(r)!r}, max {max(r)!r})"
              f"  ({smi})")
        busy_ms, wall_ms, top, by_op = busy[name]
        burst_ms = 8e3 / med
        if busy_ms is None:
            print(f"  one profiled burst {name}: wall {wall_ms!r} ms, device "
                  f"busy not measured (no device events recorded)")
            continue
        print(f"  one profiled burst {name}: wall {wall_ms!r} ms, device busy "
              f"{busy_ms!r} ms; busy share {busy_ms / wall_ms!r} of the "
              f"profiled burst, {busy_ms / burst_ms!r} of the median "
              f"unprofiled burst ({burst_ms!r} ms)")
        for op, ms in top:
            print(f"    device {ms:.4f} ms  {op}")
        print(f"  the same burst by launching op ({sum(ms for _, ms in by_op)!r} "
              f"ms in the {len(by_op)} listed):")
        for op, ms in by_op:
            print(f"    device {ms:.4f} ms  {op}")
    rows = kernel_rows(report, launches, entry_paths, smi)
    print(json.dumps({"kernels": rows}))
    print("selection: " + json.dumps(selection))
    print("transfer: " + json.dumps(transfer))
    print("serving: " + json.dumps(serving))
    print("frontend: " + json.dumps(frontend))
    print("lm: " + json.dumps(lm))
    print("train: " + json.dumps(training))
    print("families: " + json.dumps(families))
    print("families_train: " + json.dumps(families_train))
    print("examples: " + json.dumps(examples))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build included")
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def join_passes(r: dict, extra: dict) -> None:
    """Add the passes of ``extra``, a ``check_and_time`` of one kernel's
    passes of another dtype, to that kernel's report ``r``."""
    r["passes"].update(extra["passes"])
    r["max_abs_err_by_dtype"].update(extra["max_abs_err_by_dtype"])
    r["max_abs_err"] = max(r["max_abs_err"], extra["max_abs_err"])


def kernel_rows(report: dict, launches: dict, entry_paths, smi: str) -> list:
    """The rows of the ``{"kernels": [...]}`` line: one per kernel and
    operand dtype, timed on its headline pass (a served kernel's path where
    it does the most work; an entry kernel's first path; a bf16 pass where
    it is the only one of its dtype). A routed kernel's row names the source
    of the route that launched most on that pass."""
    rows = []
    for k, r in report.items():
        for dt, err in sorted(r["max_abs_err_by_dtype"].items(),
                              key=lambda de: de[0] != "float32"):
            passes = {p: t for p, t in r["passes"].items() if t["dtype"] == dt}
            served = {p: t for p, t in passes.items() if p not in entry_paths}
            path, t = (next(iter(passes.items())) if k in ENTRY_KERNELS or dt != "float32"
                       else max(served.items(), key=lambda pt: pt[1]["bound_ms"]))
            timed_on = (path if path in entry_paths or dt != "float32"
                        else f"{path} b=8 forward")
            extra = {}
            if dt in r.get("oracle_max_abs_err_by_dtype", {}):
                extra["oracle_max_abs_err"] = r["oracle_max_abs_err_by_dtype"][dt]
            if dt in r.get("float64_err_by_dtype", {}):
                extra["float64_err"], extra["plain_float64_err"] = (
                    r["float64_err_by_dtype"][dt])
            if "lm_path" in r:
                lm = r["lm_path"]
                extra["lm_path"] = {
                    "max_abs_err": lm["max_abs_err_by_dtype"].get(dt),
                    "float64_err": lm["float64_err_by_dtype"].get(dt),
                    "passes": {p: pt for p, pt in lm["passes"].items()
                               if pt["dtype"] == dt}}
            if k in ROUTED and "routes" in t:
                by_route = {}
                for p in launches:
                    for rt, n in PATH_ROUTES[p][k].get(dt, {}).items():
                        by_route[rt] = by_route.get(rt, 0) + n
                extra["launches_by_route"] = by_route
                extra["pass_launches_by_route"] = t["routes"]
                extra["sources_by_route"] = {rt: ROUTE_SOURCES[k][rt] for rt in by_route}
                source = ROUTE_SOURCES[k][max(t["routes"], key=t["routes"].get)]
            else:
                source = r["source"]
            if "ab" in t:                  # both routes in turns on this pass
                extra["ab_ms"] = t["ab"]
            if dt in r.get("float64_err_by_route", {}):
                extra["float64_err_by_route"] = r["float64_err_by_route"][dt]
            rows.append({"name": k, "dtype": dt, "route": "cuda", "source": source,
                         "replaces": r["replaces"],
                         "launches": sum(PATH_DTYPES[p][k].get(dt, 0)
                                         for p in launches),
                         "max_abs_err": err, "ms": t["ms"],
                         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                         "bound_fp32_ms": t["bound_fp32_ms"],
                         "launches_per_pass": t["launches"],
                         "timed_on": timed_on,
                         **extra, "card": smi})
    return rows


# ---------------------------------------------------------------------------
# Served paths
# ---------------------------------------------------------------------------

def make_server(torch, paths, seed):
    """One pump-mode server on the card holding every path (batch cap 8),
    with random weights from ``seed``. Registering binds and warms one plan
    per pow2 bucket, which records every kernel call signature."""
    from repro_torch.primitives.executor import make_weights
    from repro_torch.service.pipeline import OptimisedNetwork
    from repro_torch.service.serving.server import OptimisedServer
    server = OptimisedServer(max_batch=8, latency_budget_ms=float("inf"),
                             device="cuda")
    nets, weights = {}, {}
    for name, (spec, rule) in paths.items():
        asg = rule(spec) if rule is not None else {
            i: EDGE_CNN_PBQP.get(i, "chw") for i in range(len(spec.nodes))}
        nets[name] = OptimisedNetwork.from_assignment(spec, asg, net=name)
        weights[name] = make_weights(spec, seed, device="cuda")
        server.register(nets[name], weights=weights[name])
    torch.cuda.synchronize()
    return server, nets, weights


def images(rng, spec, n):
    node = spec.nodes[0]
    return rng.standard_normal((n, node.c, node.im, node.im)).astype(np.float32)


def routed_kernels(assignment):
    """Kernels an assignment's tile columns launch."""
    from repro_torch.primitives.conv import resolve, split_tile
    out = set()
    for col in assignment.values():
        variant = split_tile(col)[1]
        if variant is None:
            continue
        if variant.startswith("conv-bk"):
            out.add("conv_im2col_batch")
        elif variant.startswith("wino-") or resolve(col).family == "wino3":
            out |= {"winograd_point_gemm_batch", *WINO_TRANSFORMS}
        else:
            out.add("matmul")
    return out


def check_responses(opt, weights, reqs, outs) -> float:
    """Every response against the interpreted executor under the base
    columns (plain torch on the card, no kernel). Returns the max error."""
    from repro_torch.kernels import common
    from repro_torch.primitives.conv import split_tile
    from repro_torch.primitives.executor import execute
    from repro_torch.primitives.plan import sink_nodes
    base = {i: split_tile(c)[0] for i, c in opt.assignment.items()}
    sink = sink_nodes(opt.spec)[-1]
    before = dict(common.LAUNCHES)
    worst = 0.0
    for j, (xs, ys) in enumerate(zip(reqs, outs)):
        for i, (x, y) in enumerate(zip(xs, ys)):
            rep = execute(opt.spec, base, weights, x=x, compiled=False,
                          device="cuda")
            want = rep.outputs[sink].cpu().numpy()
            assert y.shape == want.shape and np.isfinite(y).all(), (
                opt.net, "burst", j, "item", i, y.shape, want.shape,
                int(np.isnan(y).sum()), int(np.isinf(y).sum()))
            np.testing.assert_allclose(y, want, **SERVE_TOL)
            worst = max(worst, float(np.abs(y - want).max()))
    assert common.LAUNCHES == before, "the oracle must not launch a kernel"
    return worst


def images_per_s(server, opt, rng) -> list:
    """Served img/s at b=8, once per window: back-to-back bursts on the
    host clock until ``RATE_WINDOW_S`` seconds have passed, each burst ending in
    a device sync (``serve`` copies the results back). One rate per
    window, so the run-to-run spread shows."""
    reqs = [list(images(rng, opt.spec, 8)) for _ in range(4)]
    server.serve(opt.net, reqs[0])
    rates = []
    for _ in range(RATE_WINDOWS):
        n, t0 = 0, time.perf_counter()
        while True:
            server.serve(opt.net, reqs[n % len(reqs)])
            n += 1
            dt = time.perf_counter() - t0
            if dt >= RATE_WINDOW_S:
                break
        rates.append(8 * n / dt)
    return rates


def device_busy(server, opt, rng):
    """One served b=8 burst under ``torch.profiler``: (device-busy ms, wall
    ms, the ``TOP_DEVICE_OPS`` device ops by time as (name, ms)). Busy time is the
    union of the device events' own intervals (kernels and copies). The
    CPU-side rows, which Kineto tags with their kernel's time, and user
    annotations are left out, so no device time counts twice. Busy ms is
    None when the profiler recorded no device event."""
    from torch.profiler import ProfilerActivity, profile
    reqs = list(images(rng, opt.spec, 8))
    server.serve(opt.net, reqs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.serve(opt.net, reqs)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top, launching = profile_summary(prof)
    return busy_ms, wall_ms, top, launching


def profile_summary(prof):
    """(device-busy ms, the ``TOP_DEVICE_OPS`` device ops by time as (name,
    ms), the same time by launching op) of one profile."""
    busy_ms, evs = device_events(prof)
    by_op = {}
    for e in evs:
        by_op[e.name[:90]] = by_op.get(e.name[:90], 0.0) + e.time_range.elapsed_us() * 1e-3
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP_DEVICE_OPS]
    return busy_ms, ranked, by_launching_op(prof, evs)


def device_events(prof):
    """(device-busy ms, device events) of one profile: the events are the
    device's own (kernels and copies, no user annotations), busy time the
    union of their intervals; None when it recorded no device event."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in evs):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return (busy_us * 1e-3 if evs else None), evs


def by_launching_op(prof, evs):
    """Device ms of one profiled run by the CPU op that launched each of
    its device events ``evs``, the ``TOP_DEVICE_OPS`` largest: (outermost
    op > op that launched it: device event name, ms). The profiler attaches
    each kernel and copy to the innermost op whose launch it correlates
    with; the outermost is that op's top ancestor, the call the Python code
    made (``aten::einsum`` for the GEMV an einsum runs). Device time that
    no torch op launched — the hand-written kernels, launched through
    ``ctypes`` — is listed under "no torch op"."""
    from torch.autograd import DeviceType
    by_op, seen, attributed = {}, set(), {}
    for e in prof.events():
        # the profiler can attach one launch's device events to two CPU
        # events of the same correlation id (a copy to its op and to the
        # tracer's own buffer request): count them once
        if e.device_type != DeviceType.CPU or not e.kernels or e.id in seen:
            continue
        seen.add(e.id)
        top = e
        while top.cpu_parent is not None and not top.cpu_parent.is_user_annotation:
            top = top.cpu_parent
        where = e.name if top is e else f"{top.name} > {e.name}"
        for k in e.kernels:
            key = f"{where}: {k.name[:60]}"
            by_op[key] = by_op.get(key, 0.0) + k.duration * 1e-3
            attributed[k.name] = attributed.get(k.name, 0.0) + k.duration * 1e-3
    total = {}
    for e in evs:
        total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-3
    for name, ms in total.items():
        if ms - attributed.get(name, 0.0) > 1e-6:
            by_op[f"no torch op: {name[:60]}"] = ms - attributed.get(name, 0.0)
    return sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP_DEVICE_OPS]


def kernel_mix_assignment(spec):
    """The kernel-mix tile assignment, which routes a net through the
    implicit-GEMM conv and the Winograd point-GEMM kernels, the latter
    under both a ``wino-*`` and an ``mm-*`` tiling (the matmul kernel is
    covered by the PBQP path's ``mm-*`` columns): 1x1 convs ->
    ``conv-1x1-gemm-ab-ki@conv-bk64``; the first 3x3 stride-1 conv in topo
    order where F(4x4, 3x3) applies -> ``winograd-4x4-3x3@mm-128x128x128``;
    every other 3x3 stride-1 conv -> ``winograd-2x2-3x3@wino-128x128``;
    every other conv -> ``im2col-copy-ab-ki@conv-bk128``; ``chw``
    elsewhere."""
    from repro_torch.models.cnn_zoo import ConvLayer
    from repro_torch.primitives.conv import REGISTRY
    from repro_torch.primitives.plan import topo_order
    asg = {}
    wino44 = REGISTRY["winograd-4x4-3x3"]
    first44 = True
    for i in topo_order(spec):
        node = spec.nodes[i]
        if not isinstance(node, ConvLayer):
            asg[i] = "chw"
        elif node.f == 1:
            asg[i] = "conv-1x1-gemm-ab-ki@conv-bk64"
        elif node.f == 3 and node.s == 1:
            if first44 and wino44.applicable(*node.config):
                asg[i] = "winograd-4x4-3x3@mm-128x128x128"
                first44 = False
            else:
                asg[i] = "winograd-2x2-3x3@wino-128x128"
        else:
            asg[i] = "im2col-copy-ab-ki@conv-bk128"
    return asg


# ---------------------------------------------------------------------------
# The selection path (phase 6)
# ---------------------------------------------------------------------------

def selection_phase(torch, server, nets, weights, launches, serve_err, seed,
                    rng, smi) -> dict:
    """Phase 6 on copies of ``artifacts/`` in a temporary directory: (a)
    predictions card vs CPU, (b) warm and cold selections card vs CPU, (c)
    the selected plans served from ``server`` (added to ``nets``,
    ``weights``, ``launches`` and ``serve_err``), (d) factor
    ``reoptimise``. Returns the numbers for the report."""
    from repro_torch.kernels import common
    from repro_torch.models import cnn_zoo
    from repro_torch.primitives.executor import make_weights
    from repro_torch.service import ArtifactStore, optimise, reoptimise
    out = {"card": smi}
    with tempfile.TemporaryDirectory(prefix="chip_smoke.") as td:
        stores = {}
        for name, parts in (("warm", ("models", "selections")),
                            ("cold_cuda", ("models",)), ("cold_cpu", ("models",))):
            for part in parts:
                shutil.copytree(ARTIFACTS / part, Path(td) / name / part)
            stores[name] = str(Path(td) / name)

        # (b) warm: the committed models and edge_cnn selection, card and CPU
        opt = {dev: optimise("edge_cnn", "arm", store=ArtifactStore(
                   stores["warm"], device=dev), **OPTIMISE_ARGS)
               for dev in ("cuda", "cpu")}
        committed = json.loads(EDGE_CNN_SELECTION.read_text())["assignment"]
        for dev, o in opt.items():
            assert o.warm_models and o.warm_selection, (dev, "not warm")
            assert {str(k): v for k, v in o.assignment.items()} == committed, dev
        models = {dev: o.models for dev, o in opt.items()}
        assert all(t.is_cuda for layer in models["cuda"].prim.params
                   for t in layer.values())
        out["models"] = models["cuda"].fingerprint()
        print(f"select: optimise(edge_cnn, arm) warm for models and selection "
              f"in {opt['cuda'].seconds * 1e3:.1f} ms, models "
              f"{out['models']}, the committed assignment", flush=True)

        # (a) predictions over the arm pools, card vs CPU, and one forward
        out["predict"] = predictions_card_vs_cpu(torch, models, smi)

        # (b) cold selections for every executable net, card vs CPU
        out["nets"] = {}
        cold = {}
        for net in cnn_zoo.EXECUTABLE_NETS:
            got, want = (optimise(net, "arm", store=ArtifactStore(
                             stores[f"cold_{dev}"], device=dev), **OPTIMISE_ARGS)
                         for dev in ("cuda", "cpu"))
            assert got.warm_models and not got.warm_selection, net
            assert got.assignment == want.assignment, (net, "card != CPU")
            assert abs(got.predicted_cost_s - want.predicted_cost_s) <= \
                1e-5 * want.predicted_cost_s, net
            sel = got.selection
            out["nets"][net] = {"estimate_ms": sel.estimate_seconds * 1e3,
                                "solver_ms": sel.solver_seconds * 1e3,
                                "optimal": sel.optimal,
                                "predicted_cost_ms": sel.solver_cost * 1e3}
            print(f"select {net}: estimate {sel.estimate_seconds * 1e3!r} ms, "
                  f"solver {sel.solver_seconds * 1e3!r} ms, optimal "
                  f"{sel.optimal}, predicted {sel.solver_cost * 1e3:.4f} ms/img "
                  f"(cold, card = CPU)  ({smi})", flush=True)
            cold[net] = got
        assert {str(k): v for k, v in cold["edge_cnn"].assignment.items()} == committed

        # (c) the selected plans, served from the phase-2 server
        for net, sizes in SELECT_BURSTS.items():
            sel_opt = dataclasses.replace(opt["cuda"] if net == "edge_cnn"
                                          else cold[net], net=f"{net}_select")
            assert not routed_kernels(sel_opt.assignment), sel_opt.assignment
            weights[sel_opt.net] = make_weights(sel_opt.spec, seed, device="cuda")
            server.register(sel_opt, weights=weights[sel_opt.net])
            nets[sel_opt.net] = sel_opt
            reqs = [images(rng, sel_opt.spec, b) for b in sizes]
            common.reset_launches()
            outs = [server.serve(sel_opt.net, list(r)) for r in reqs]
            torch.cuda.synchronize()
            launches[sel_opt.net] = took(sel_opt.net)
            assert not any(launches[sel_opt.net].values()), launches[sel_opt.net]
            serve_err[sel_opt.net] = check_responses(sel_opt, weights[sel_opt.net],
                                                     reqs, outs)
            print(f"served {sel_opt.net}: bursts {sizes}, max |served - oracle| "
                  f"= {serve_err[sel_opt.net]:.3g}, no kernel launched", flush=True)

        # (d) factor reoptimise from one fresh sample: twice on the card, once
        # on the CPU
        sample = opt["cuda"].platform.measure_sample(16)
        again = [reoptimise(opt["cuda"], sample=sample, mode="factor")
                 for _ in range(2)]
        host = reoptimise(opt["cpu"], sample=sample, mode="factor")
        assert again[0].models.fingerprint() == again[1].models.fingerprint()
        assert again[0].assignment == again[1].assignment == host.assignment
        changed = sum(again[0].assignment[i] != a
                      for i, a in opt["cuda"].assignment.items())
        out["reoptimise"] = {"models": again[0].models.fingerprint(),
                             "changed_nodes": changed,
                             "predicted_cost_ms": again[0].predicted_cost_s * 1e3}
        print(f"select: reoptimise(factor, 16-row sample) twice on the card: "
              f"models {out['reoptimise']['models']} both times, the same "
              f"assignment as the CPU's ({changed} nodes changed)", flush=True)
    return out


# ---------------------------------------------------------------------------
# The transfer onto the card (phase 7)
# ---------------------------------------------------------------------------

def transfer_pool():
    """(configs, DLT pairs) phase 7 profiles. Configs: every distinct conv
    config of edge_cnn and resnet18 (the layers selection prices), then
    every ``PROFILE_STRIDE``-th ``config_pool()`` config of at most
    ``PROFILE_MAX_FLOPS`` and ``PROFILE_MAX_OPERANDS`` image and weight
    elements (each profiled cell draws its operands from numpy, as the
    reference's profiler does, and those draws dominate the host time of
    larger configs). Pairs:
    every tensor an edge of the two nets carries, then
    ``dlt_pool(max_pairs=PROFILE_DLT_PAIRS)``."""
    from repro_torch.core.selection import _edge_tensor
    from repro_torch.models import cnn_zoo
    from repro_torch.models.cnn_zoo import ConvLayer
    from repro_torch.profiler.pools import config_pool, dlt_pool
    specs = [cnn_zoo.get(n) for n in ("edge_cnn", "resnet18")]
    configs = sorted({n.config for sp in specs for n in sp.nodes
                      if isinstance(n, ConvLayer)})

    def flops(k, c, im, s, f):
        o = (im - f) // s + 1
        return 2 * k * c * f * f * o * o

    configs += [cfg for cfg in config_pool()[::PROFILE_STRIDE]
                if cfg not in configs and flops(*cfg) <= PROFILE_MAX_FLOPS
                and cfg[1] * (cfg[2] ** 2 + cfg[0] * cfg[4] ** 2) <= PROFILE_MAX_OPERANDS]
    pairs = sorted({_edge_tensor(sp.nodes[u]) for sp in specs for u, _ in sp.edges})
    pairs += [p for p in dlt_pool(max_pairs=PROFILE_DLT_PAIRS) if p not in pairs]
    return configs, pairs


def transfer_phase(torch, server, nets, weights, launches, serve_err, seed,
                   rng, smi, td):
    """Phase 7 in the temporary directory ``td``: (a) cold NN2 pretrains on
    the card (sim arm against the committed model, sim intel as the
    source), (b) ``GpuPlatform`` profiled, (c) the transfer table, (d) the
    transferred edge_cnn selection against measured costs, served from ``server``
    (added to ``nets``, ``weights``, ``launches``, ``serve_err``). The
    launch counters and signatures are set aside around the phase and put
    back after it, so the phases before it report what they report; the
    phase's own launches are in ``launches`` under its paths. Returns the
    numbers for the report, and for phase 8 the measured platform, its
    transferred edge_cnn selection, the intel base models and the store
    (``{"gpu": ..., "opt": ..., "intel": ..., "store": ...}``)."""
    from collections import Counter
    from repro_torch.core import pbqp
    from repro_torch.core.selection import build_pbqp, network_cost
    from repro_torch.kernels import common
    from repro_torch.models.cnn_zoo import ConvLayer
    from repro_torch.primitives.conv import (compile_traits, run_primitive,
                                             split_tile)
    from repro_torch.primitives.executor import make_weights
    from repro_torch.primitives.plan import heuristic_assignment
    from repro_torch.profiler.device import applicable, column_callable
    from repro_torch.service import (ArtifactStore, GpuPlatform,
                                     SimulatedPlatform, digest, optimise)
    saved = (dict(common.LAUNCHES), {k: Counter(c) for k, c in common.SEEN.items()})
    out = {"card": smi}
    t_phase = time.perf_counter()
    shutil.copytree(ARTIFACTS / "models", Path(td) / "committed" / "models")
    committed_store = ArtifactStore(str(Path(td) / "committed"))
    store = ArtifactStore(str(Path(td) / "trained"))      # cold, on the card

    # (a) cold NN2 pretrains on the card
    out["pretrain"] = {}
    plats = {"arm": SimulatedPlatform("arm", max_triplets=60),
             "intel": SimulatedPlatform("intel")}
    for name, plat in plats.items():
        fields = plat._model_fields("prim", "nn2", mode="native", **TRANSFER_TRAIN)
        t0 = time.perf_counter()
        model, warm = plat.pretrain_prim("nn2", store=store, **TRANSFER_TRAIN)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        assert not warm and model.device.type == "cuda", name
        _, _, te = plat.primitive_dataset().split()
        err = model.mdrae(te.feats, te.times)
        row = {"address": digest(fields), "seconds": secs,
               "iterations": model.train_iterations, "test_mdrae": err,
               "test_rows": te.n}
        line = (f"transfer (a): cold nn2 pretrain sim {name}: "
                f"{model.train_iterations} iterations in {secs:.2f} s on the "
                f"card, test MdRAE {err:.4f} over {te.n} rows")
        if name == "arm":
            ref = committed_store.get_model(fields)
            assert ref is not None, "the committed arm NN2 is not at its address"
            row["committed_test_mdrae"] = ref.mdrae(te.feats, te.times)
            line += (f", committed JAX model {row['committed_test_mdrae']:.4f} "
                     f"(address {row['address']}); limit {ARM_MDRAE_LIMIT}")
            assert err <= ARM_MDRAE_LIMIT, (err, ARM_MDRAE_LIMIT)
        print(line + f"  ({smi})", flush=True)
        out["pretrain"][name] = row
    intel = plats["intel"].pretrain("nn2", store=store, **TRANSFER_TRAIN)
    assert intel.prim.fingerprint() == model.fingerprint()   # loaded, not retrained

    # (b) profile the card
    configs, pairs = transfer_pool()
    gpu = GpuPlatform(configs=configs, dlt_pairs=pairs,
                      repeats=PROFILE_REPEATS, store=store)
    common.reset_launches()
    t0 = time.perf_counter()
    ds = gpu.primitive_dataset()
    prim_s = time.perf_counter() - t0
    dlt = gpu.dlt_dataset()
    dlt_s = time.perf_counter() - t0 - prim_s
    launches["gpu_profile"] = took("gpu_profile")
    for k in SERVED_KERNELS:
        assert launches["gpu_profile"][k] > 0, (k, launches["gpu_profile"])
    assert not any(launches["gpu_profile"][k] for k in ENTRY_KERNELS)
    cfg = np.asarray(configs, np.int64)
    mask = compile_traits(tuple(gpu.columns)).applicable_mask(*cfg.T)
    assert np.array_equal(np.isfinite(ds.times), mask), "NaN only where inapplicable"
    assert (ds.times[mask] > 0).all() and np.isfinite(dlt.times).all()
    dev = gpu.device_dataset()
    assert np.array_equal(np.isfinite(dev.times), mask)
    out["profile"] = {"configs": len(configs), "dlt_pairs": len(pairs),
                      "columns": len(gpu.columns), "prim_seconds": prim_s,
                      "dlt_seconds": dlt_s, "nan_share": float(1 - mask.mean()),
                      "launches": launches["gpu_profile"]}
    print(f"transfer (b): profiled {len(configs)} configs x {len(gpu.columns)} "
          f"columns in {prim_s:.2f} s and {len(pairs)} DLT pairs x 6 in "
          f"{dlt_s:.2f} s ({PROFILE_REPEATS} repeats after 2 warm-ups); NaN "
          f"share {1 - mask.mean():.4f} (exactly the inapplicable cells); "
          f"launches {launches['gpu_profile']}  ({smi})", flush=True)
    out["named_layers"] = {}
    for label, layer in NAMED_LAYERS.items():
        i = configs.index(layer)
        fastest = {}
        for j, col in enumerate(gpu.columns):
            base, variant = split_tile(col)
            if variant is not None and np.isfinite(ds.times[i, j]) and (
                    base not in fastest or ds.times[i, j] < fastest[base][1]):
                fastest[base] = (col, ds.times[i, j], dev.times[i, j])
        out["named_layers"][label] = {
            b: {"column": c, "wall_ms": w * 1e3, "device_ms": d * 1e3}
            for b, (c, w, d) in fastest.items()}
        print(f"transfer (b): {label} {layer}, fastest tile column per base, "
              f"wall / device median ms: " + "; ".join(
                  f"{c} {w * 1e3:.4f} / {d * 1e3:.4f}"
                  for c, w, d in fastest.values()), flush=True)
    # each tile column against its base primitive (plain torch) at its
    # largest pool config: comparison launches, not the path's
    worst = 0.0
    g = torch.Generator().manual_seed(seed)
    for col in gpu.columns:
        if split_tile(col)[1] is None:
            continue
        k, c, im, s, f = max((tuple(map(int, x)) for x in configs
                              if applicable(col, *x)),
                             key=lambda x: x[0] * x[1] * x[4] ** 2 * x[2] ** 2 / x[3] ** 2)
        x = torch.randn(c, im, im, generator=g).cuda()
        w = (torch.randn(k, c, f, f, generator=g) * (c * f * f) ** -0.5).cuda()
        worst = max(worst, _hold(torch, column_callable(col, s)(x, w),
                                 run_primitive(split_tile(col)[0], x, w, s),
                                 ORACLE_TOL))
    out["profile"]["tile_vs_base_max_abs_err"] = worst
    n_tile = sum(split_tile(c)[1] is not None for c in gpu.columns)
    print(f"transfer (b): {n_tile} tile columns each within {ORACLE_TOL} "
          f"of their base primitive "
          f"at their largest pool config, max |err| {worst:.3g}", flush=True)

    # (c) the transfer table on the held-out card rows
    _, _, te = ds.split()
    table = {"intel-native unadapted": (intel.prim.subset_columns(
        gpu.columns, base_of=gpu.base_column), None)}
    for mode in ("factor", "finetune", "scratch"):
        m = gpu.calibrate(intel, TRANSFER_BUDGET, mode=mode, store=store)
        assert m.mode == mode and not m.warm, mode
        table[mode] = (m.prim, m.seconds)
    native = gpu.pretrain("nn2", store=store, **TRANSFER_TRAIN)
    table["native"] = (native.prim, native.seconds)
    n_train = ds.split()[0].n
    out["transfer"] = {}
    print(f"transfer (c): test MdRAE on {te.n} held-out card rows x "
          f"{len(gpu.columns)} columns (sample: {TRANSFER_BUDGET} of the "
          f"{n_train} training rows; native: all {n_train})  ({smi})")
    for name, (model, secs) in table.items():
        err = model.mdrae(te.feats, te.times)
        out["transfer"][name] = {"test_mdrae": err, "seconds": secs,
                                 "iterations": model.train_iterations}
        print(f"    {name:24s} {err:.4f}" + ("" if secs is None else
              f"  ({secs:.2f} s, {model.train_iterations} iterations)"), flush=True)

    # (d) the transferred selection, priced by measurement, served
    spec = nets["edge_cnn_pbqp"].spec
    opt = optimise("edge_cnn", gpu, base=intel, budget=TRANSFER_BUDGET,
                   mode="finetune", store=store, executable=True)
    assert opt.warm_models and not opt.warm_selection
    sel = opt.selection
    convs = [i for i, n in enumerate(spec.nodes) if isinstance(n, ConvLayer)]
    chosen = Counter(opt.assignment[i] for i in convs)
    common.reset_launches()
    t0 = time.perf_counter()
    graph = build_pbqp(spec, gpu.cost_provider())
    best = pbqp.solve(graph).labelled(graph)
    measured_s = time.perf_counter() - t0
    launches["gpu_measured_select"] = took("gpu_measured_select")
    cost = {name: network_cost(spec, asg, graph=graph) for name, asg in (
        ("selected", opt.assignment), ("measured_optimal", best),
        ("heuristic", heuristic_assignment(spec)))}
    out["select"] = {"estimate_ms": sel.estimate_seconds * 1e3,
                     "solver_ms": sel.solver_seconds * 1e3,
                     "columns": dict(chosen),
                     "measured_cost_ms": {k: v * 1e3 for k, v in cost.items()},
                     "measured_select_s": measured_s}
    print(f"transfer (d): optimise(edge_cnn, gpu, base=intel, finetune): "
          f"estimate {sel.estimate_seconds * 1e3!r} ms, solver "
          f"{sel.solver_seconds * 1e3!r} ms, columns {dict(chosen)}", flush=True)
    print(f"transfer (d): measured per-image cost (MeasuredProvider, wall "
          f"ms): selected {cost['selected'] * 1e3:.4f}, measured-optimal "
          f"{cost['measured_optimal'] * 1e3:.4f}, heuristic "
          f"{cost['heuristic'] * 1e3:.4f}; the measured selection took "
          f"{measured_s:.2f} s  ({smi})", flush=True)
    name = "edge_cnn_transfer"
    sel_opt = dataclasses.replace(opt, net=name)
    weights[name] = make_weights(spec, seed, device="cuda")
    server.register(sel_opt, weights=weights[name])
    nets[name] = sel_opt
    reqs = [images(rng, spec, 8)]
    common.reset_launches()
    outs = [server.serve(name, list(r)) for r in reqs]
    torch.cuda.synchronize()
    launches[name] = took(name)
    want = routed_kernels(sel_opt.assignment)
    assert all(launches[name][k] > 0 for k in want), (name, launches[name])
    assert all(launches[name][k] == 0 for k in common.KERNELS if k not in want)
    serve_err[name] = check_responses(sel_opt, weights[name], reqs, outs)
    assert serve_err[name] <= SERVE_TOL["atol"], serve_err[name]
    out["served"] = {"max_abs_err": serve_err[name], "launches": launches[name]}
    print(f"served {name}: b=8, max |served - oracle| = {serve_err[name]:.3g}, "
          f"launches {launches[name]}", flush=True)
    common.LAUNCHES.update(saved[0])
    for k, c in saved[1].items():
        common.SEEN[k] = c
    out["seconds"] = time.perf_counter() - t_phase
    phase7 = ("gpu_profile", "gpu_measured_select", "edge_cnn_transfer")
    print("phase 7 launches: " + json.dumps({p: launches[p] for p in phase7}))
    print(f"transfer: phase 7 took {out['seconds']:.1f} s  ({smi})", flush=True)
    return out, {"gpu": gpu, "opt": opt, "intel": intel, "store": store}


# ---------------------------------------------------------------------------
# The concurrent serving core on the card (phase 8)
# ---------------------------------------------------------------------------

def threaded_rates(server, nets, rng) -> dict:
    """Served img/s per path with every path loaded at once: one client
    thread per path sends back-to-back bursts of 8 (``serve``, which waits
    for its tickets) while the server's workers dispatch; one rate per path
    per window of ``SERVE_WINDOW_S`` seconds, ``RATE_WINDOWS`` windows, then
    one more window under ``torch.profiler``. Besides the rates, what the
    unprofiled windows were made of: per path the images per dispatch and
    the host ms of one dispatch (``execute``, claim to delivery), the share
    of their wall time in which at least one and both workers were inside
    ``execute``; and the device's busy share of the profiled window."""
    import threading
    from torch.profiler import ProfilerActivity, profile
    reqs = {name: [list(images(rng, nets[name].spec, 8)) for _ in range(2)]
            for name in nets}
    spans = []             # (net, images, start, end, queue waits) per dispatch
    real = server.execute

    def timed(batch):
        waits = [t.queue_wait_s for t in batch.tickets]
        t0 = time.perf_counter()
        try:
            real(batch)
        finally:
            spans.append((batch.net, len(batch.tickets), t0,
                          time.perf_counter(), waits))

    def window():
        counts = dict.fromkeys(nets, 0)
        stop = time.perf_counter() + SERVE_WINDOW_S

        def client(name):
            while time.perf_counter() < stop:
                server.serve(name, reqs[name][counts[name] % 2])
                counts[name] += 1
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(n,)) for n in nets]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        dt = time.perf_counter() - t0
        return {name: 8 * counts[name] / dt for name in nets}, (t0, dt)

    server.execute = timed
    try:
        rates = {name: [] for name in nets}
        walls = []
        for _ in range(RATE_WINDOWS):
            r, wall = window()
            walls.append(wall)
            for name in nets:
                rates[name].append(r[name])
        done = list(spans)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced, (_, traced_s) = window()
    finally:
        del server.execute
    busy_ms, _ = device_events(prof)
    # host time with k workers inside execute, over the unprofiled windows
    edges = sorted([(a, 1) for _, _, a, _, _ in done]
                   + [(b, -1) for _, _, _, b, _ in done])
    held = {1: 0.0, 2: 0.0}
    k, last = 0, None
    for t, step in edges:
        if last is not None:
            for n in held:
                if k >= n:
                    held[n] += t - last
        k, last = k + step, t
    wall = sum(dt for _, dt in walls)
    per_path = {}
    for name in nets:
        mine = [(n, b - a) for net, n, a, b, _ in done if net == name]
        waits = [w for net, *_, ws in done if net == name for w in ws]
        per_path[name] = {
            "dispatches": len(mine),
            "images_per_dispatch": sum(n for n, _ in mine) / max(len(mine), 1),
            "execute_ms_mean": 1e3 * sum(d for _, d in mine) / max(len(mine), 1),
            "burst_ms_median": 8e3 / float(np.median(rates[name])),
            "queue_wait_p50_ms": (1e3 * float(np.median(waits)) if waits
                                  else None)}
    return {"rates": rates, "paths": per_path,
            "workers_executing_share": {"at_least_1": held[1] / wall,
                                        "both": held[2] / wall},
            "profiled_window": {"images_per_s": traced, "wall_s": traced_s,
                                "device_busy_ms": busy_ms,
                                "device_busy_share": (None if busy_ms is None
                                                      else busy_ms * 1e-3 / traced_s)}}


def cpu_model() -> str:
    """The host CPU a host-CPU measurement ran on, from ``/proc/cpuinfo``:
    its model name, or where that is missing its vendor, family and model
    numbers; and the core count."""
    import os
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name", "")
    if not name or name == "unknown":
        name = (f"{fields.get('vendor_id', 'unknown vendor')} family "
                f"{fields.get('cpu family', '?')} model {fields.get('model', '?')}")
    return f"{name}, {os.cpu_count()} cores"


def until(pred, timeout: float = 60.0) -> None:
    """Poll ``pred`` until it holds; fail after ``timeout`` seconds."""
    deadline = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {pred}")
        time.sleep(0.005)


def serving_phase(torch, nets, weights, launches, transferred, pump_rates,
                  rng, smi, td) -> dict:
    """Phase 8 in the temporary directory ``td`` (a copy of ``artifacts/``
    where a store is needed): (a) two workers serving phase 2's three paths
    to four client threads, every response held to the oracle, each
    worker's dispatches, and img/s per path beside the pump mode's; (b) the
    fault drill — a persistent ``raise`` served degraded by the safe plan on
    the card while the backend's breaker opens and recovers through a
    half-open probe, a ``corrupt`` output detected and retried, a ``hang``
    abandoned at the execution deadline, rescued, its worker replaced; (c)
    the drift drill on phase 7's transferred plan — a 4x ``slowdown``
    sets off one recalibration on the measured platform from the served
    observations, canaried and hot-swapped; (d) edge_cnn routed over
    ``arm``, ``gpu``, ``tpu`` and ``host`` backends, then one unregistered;
    (e) the serving CLI. Launch counters and signatures are set aside around the phase and
    put back; its launches are in ``launches`` under its paths."""
    import threading
    from collections import Counter
    from repro_torch.kernels import common
    from repro_torch.models.cnn_zoo import ConvLayer
    from repro_torch.primitives.conv import split_tile
    from repro_torch.service import (ArtifactStore, Fault, FaultInjector,
                                     HostPlatform, OptimisedServer,
                                     get_platform, make_recalibrator,
                                     optimise)
    from repro_torch.service.server import main as serve_main
    saved = (dict(common.LAUNCHES), {k: Counter(c) for k, c in common.SEEN.items()})
    out = {"card": smi}
    t_phase = time.perf_counter()
    served = ("edge_cnn_pbqp", "edge_cnn_mix", "resnet18_mix")
    clean = ("failed_dispatches", "fallback_images", "rejected", "retries")

    # (a) two workers, three paths, four client threads
    server = OptimisedServer(workers=2, max_batch=8, max_wait_ms=2.0,
                             device="cuda")
    for name in served:
        server.register(nets[name], weights=weights[name])
    assert all(s.cuda_stream != torch.cuda.default_stream().cuda_stream
               for s in server._pool.streams)
    reqs = {name: images(rng, nets[name].spec, 64) for name in served}
    tickets = {name: [None] * 64 for name in served}

    def client(c):
        for i in range(16):
            for name in served:
                j = 16 * c + i
                tickets[name][j] = server.submit(name, reqs[name][j])
    common.reset_launches()
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(120.0)
    assert all(t.wait(120.0) for name in served for t in tickets[name])
    burst_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches["serve_workers"] = took("serve_workers")
    want = set().union(*(routed_kernels(nets[n].assignment) for n in served))
    assert all(launches["serve_workers"][k] > 0 for k in want), launches["serve_workers"]
    dispatched = server._pool.dispatches
    assert len(dispatched) == 2 and min(dispatched) > 0, dispatched
    out["workers"] = {"burst_s": burst_s, "worker_dispatches": dispatched,
                      "launches": launches["serve_workers"], "paths": {}}
    for name in served:
        assert all(t.error is None and not t.degraded for t in tickets[name])
        err = check_responses(nets[name], weights[name], [reqs[name]],
                              [[t.result for t in tickets[name]]])
        st = server.stats(name)
        assert not any(st[k] for k in clean), (name, st)
        assert st["images"] == 64
        out["workers"]["paths"][name] = {"max_abs_err": err,
                                         "dispatches": st["dispatches"],
                                         "padded": st["padded"]}
    print(f"serve (a): workers=2, 4 client threads x 16 requests to each of "
          f"{len(served)} paths in {burst_s:.3f} s; worker dispatches "
          f"{dispatched}; per path max |served - oracle| "
          + ", ".join(f"{n} {p['max_abs_err']:.3g}"
                      for n, p in out["workers"]["paths"].items())
          + f"; no failed or degraded dispatch; launches "
          f"{launches['serve_workers']}", flush=True)
    # img/s with every path loaded at once, and what its windows were made of
    made = threaded_rates(server, {n: nets[n] for n in served}, rng)
    out["workers"]["threaded"] = {k: v for k, v in made.items() if k != "rates"}
    for name in served:
        r, p, m = made["rates"][name], pump_rates[name], made["paths"][name]
        out["workers"]["paths"][name].update(
            images_per_s=r, images_per_s_pump_median=float(np.median(p)))
        print(f"serve (a): img/s {name} b=8 at workers=2 with the 3 paths "
              f"loaded at once, median over {len(r)} windows of "
              f"{SERVE_WINDOW_S} s: {float(np.median(r))!r} "
              f"{[round(x, 1) for x in r]}; pump mode alone (phase 2 server, "
              f"windows of {RATE_WINDOW_S} s): median {float(np.median(p))!r}; "
              f"in those windows {m['dispatches']} dispatches of "
              f"{m['images_per_dispatch']!r} images, execute "
              f"{m['execute_ms_mean']!r} ms each, burst {m['burst_ms_median']!r} "
              f"ms, queue wait p50 {m['queue_wait_p50_ms']!r} ms  ({smi})",
              flush=True)
    w, pw = made["workers_executing_share"], made["profiled_window"]
    traced = {n: round(v, 1) for n, v in pw["images_per_s"].items()}
    print(f"serve (a): share of the windows' wall time with at least one "
          f"worker executing {w['at_least_1']!r}, with both {w['both']!r}; one "
          f"profiled window of {pw['wall_s']!r} s: img/s {traced}, device "
          f"busy {pw['device_busy_ms']!r} ms, share {pw['device_busy_share']!r}"
          f"  ({smi})", flush=True)
    st = {n: server.stats(n) for n in served}
    assert not any(st[n][k] for n in served for k in clean), st
    server.stop()

    # (b) the fault drill. A full collection over the objects the phases
    # before leave pauses every thread for up to ~275 ms on the card's
    # host, past the 250 ms deadline: the drill runs with the collector
    # off, after one collection
    gc.collect()
    gc.disable()
    pbqp = nets["edge_cnn_pbqp"]
    inj = FaultInjector([Fault("raise", net="edge_cnn#a")])
    drill = OptimisedServer(workers=2, max_batch=8, max_wait_ms=2.0,
                            faults=inj, breaker_failures=3,
                            breaker_cooldown_ms=DRILL_COOLDOWN_MS,
                            exec_deadline_ms=DRILL_DEADLINE_MS, device="cuda")
    degraded_on = []
    real_forward = drill._fallback_forward

    def forward(*a):
        y = real_forward(*a)
        degraded_on.append(str(y.device))
        return y
    drill._fallback_forward = forward
    # backend a is predicted far cheaper, so it takes the traffic until its
    # breaker opens; the mix path dispatches only full batches of 8, one
    # fault-plan index per burst
    for backend, cost in (("a", 1e-6), ("b", 1.0)):
        drill.register(dataclasses.replace(pbqp, net="edge_cnn",
                                           predicted_cost_s=cost),
                       backend=backend, weights=weights["edge_cnn_pbqp"])
    drill.register(nets["edge_cnn_mix"], weights=weights["edge_cnn_mix"],
                   max_wait_ms=60e3)
    # each drill worker serves the mix path once before its faults are
    # armed, so no worker's first use of the plan falls inside the
    # deadline; two full batches at once, until both served
    mix = nets["edge_cnn_mix"]
    warm = images(rng, mix.spec, 16)
    for warm_rounds in range(1, DRILL_WARM_ROUNDS + 1):
        wt = [drill.submit("edge_cnn_mix", x) for x in warm]
        assert all(t.wait(60.0) for t in wt)
        if min(drill._pool.dispatches) > 0:
            break
    assert min(drill._pool.dispatches) > 0, drill._pool.dispatches
    warm_dispatches = list(drill._pool.dispatches)
    check_responses(mix, weights["edge_cnn_mix"], [warm], [[t.result for t in wt]])
    w0 = inj.count("edge_cnn_mix")
    warm_images = drill.stats("edge_cnn_mix")["images"]
    inj.faults += [Fault("corrupt", net="edge_cnn_mix", first=w0, last=w0 + 1),
                   Fault("hang", net="edge_cnn_mix", first=w0 + 2, last=w0 + 3,
                         seconds=DRILL_HANG_S)]
    common.reset_launches()
    raised = [images(rng, pbqp.spec, 8) for _ in range(4)]
    ts = []
    for r in raised[:3]:
        ts.append([drill.submit("edge_cnn", x) for x in r])
        assert all(t.wait(60.0) for t in ts[-1])
    st = drill.stats("edge_cnn")["backends"]
    on_a = [t for burst in ts for t in burst if t.net == "edge_cnn#a"]
    assert on_a and all(t.degraded and t.error is None for t in on_a)
    assert st["a"]["breaker"]["opens"] == 1, st["a"]["breaker"]
    assert set(degraded_on) == {"cuda:0"}, degraded_on
    spill = [drill.submit("edge_cnn", x) for x in raised[3]]
    assert all(t.wait(60.0) for t in spill)
    assert all(t.net == "edge_cnn#b" and not t.degraded and t.error is None
               for t in spill)
    err_raise = check_responses(pbqp, weights["edge_cnn_pbqp"],
                                [np.concatenate(raised)],
                                [[t.result for t in (*sum(ts, []), *spill)]])
    inj.faults = [f for f in inj.faults if f.net != "edge_cnn#a"]  # faults end
    time.sleep(DRILL_COOLDOWN_MS * 1e-3 * 1.5)
    probe = drill.submit("edge_cnn", raised[0][0])
    assert probe.wait(60.0) and probe.net == "edge_cnn#a" and not probe.degraded
    br = drill.stats("edge_cnn")["backends"]["a"]["breaker"]
    assert br["state"] == "closed" and br["closes"] == 1, br
    fa = drill.stats("edge_cnn")
    print(f"serve (b): persistent raise on edge_cnn#a: {len(on_a)} tickets "
          f"served degraded by the safe plan on {sorted(set(degraded_on))} "
          f"(max |err| vs oracle {err_raise:.3g}), breaker opened after "
          f"{fa['backends']['a']['failed_dispatches']} failed dispatches, "
          f"{len(spill)} spilled to edge_cnn#b, faults ended -> half-open "
          f"probe closed it (opens {br['opens']}, closes {br['closes']})",
          flush=True)
    corrupt = images(rng, mix.spec, 8)
    out_c = drill.serve("edge_cnn_mix", list(corrupt))
    sm = drill.stats("edge_cnn_mix")
    # the corrupt output failed validation and the retry served the batch
    assert ("edge_cnn_mix", 0, w0, "corrupt") in inj.injected
    assert sm["retries"] == 1 and not sm["failures"], (sm, drill._pool.restarts)
    assert sm["fallback_images"] == 0 and sm["images"] == warm_images + 8, sm
    hang = images(rng, mix.spec, 8)
    t0 = time.perf_counter()
    hung = [drill.submit("edge_cnn_mix", x) for x in hang]
    assert all(t.wait(60.0) for t in hung)
    rescue_s = time.perf_counter() - t0
    assert all(t.degraded and t.error is None for t in hung)
    until(lambda: drill._pool.restarts == 1)     # the rescue settles first
    zombies = drill._pool.zombies
    restarts = drill._pool.restarts
    assert restarts == 1 and zombies == 1, (restarts, zombies)
    # the shed worker runs its plan once the hang ends: let it finish before
    # the oracle runs, so its launches are not counted as the oracle's
    until(lambda: drill._pool.zombies == 0)
    err_mix = check_responses(mix, weights["edge_cnn_mix"], [corrupt, hang],
                              [out_c, [t.result for t in hung]])
    after = drill.serve("edge_cnn_mix", list(hang))
    np.testing.assert_allclose(np.stack(after), np.stack([t.result for t in hung]),
                               **SERVE_TOL)
    sm = drill.stats("edge_cnn_mix")
    assert sm["failures"] == {"deadline": 1}, sm["failures"]
    launches["serve_faults"] = took("serve_faults")
    out["faults"] = {"warm_rounds": warm_rounds,
                     "warm_worker_dispatches": warm_dispatches,
                     "degraded": len(on_a), "spilled": len(spill),
                     "breaker": br, "raise_max_abs_err": err_raise,
                     "mix_max_abs_err": err_mix, "rescue_s": rescue_s,
                     "zombies_after_rescue": zombies, "restarts": restarts,
                     "zombies_at_end": drill._pool.zombies,
                     "ledger": {"edge_cnn": fa["failures"],
                                "edge_cnn_mix": sm["failures"]},
                     "launches": launches["serve_faults"]}
    print(f"serve (b): mix path warmed on both workers first ({warm_rounds} "
          f"round(s) of 16, worker dispatches {warm_dispatches}); corrupt "
          f"output detected and served by the retry "
          f"(retries {sm['retries']}); hang of {DRILL_HANG_S} s abandoned at the "
          f"{DRILL_DEADLINE_MS:g} ms deadline and rescued degraded in "
          f"{rescue_s:.3f} s, worker replaced (restarts {restarts}, zombies "
          f"{zombies}, {drill._pool.zombies} once the hang ended); max |err| "
          f"{err_mix:.3g}", flush=True)
    drill.stop()
    gc.enable()

    # (c) the drift drill on the transferred plan
    gpu_opt = dataclasses.replace(transferred["opt"], net="edge_cnn_transfer")
    gpu_w = weights["edge_cnn_transfer"]
    recal_store = ArtifactStore(str(td / "recalibrated"), device="cuda")
    recal = make_recalibrator(store=recal_store, sample_n=12, mode="factor",
                              device="cuda")
    timing = {"calls": 0}

    def timed_recal(opt, served=None):
        # the drill sends nothing while this runs (it waits for the workers
        # to finish each burst's observation before it decides to send
        # another): every launch from here to the swap's end is the
        # recalibration's
        timing["calls"] += 1
        timing["launches"] = dict(common.LAUNCHES)
        t0 = time.perf_counter()
        new = recal(opt, served=served)
        timing["seconds"] = time.perf_counter() - t0
        return new
    slow = FaultInjector([])
    drift = OptimisedServer(workers=2, max_batch=8, max_wait_ms=2.0,
                            canary=True, drift_calib_obs=DRIFT_CALIB_OBS,
                            drift_alpha=DRIFT_ALPHA, recalibrate=timed_recal,
                            faults=slow, device="cuda")
    drift.register(gpu_opt, weights=gpu_w)
    key = gpu_opt.net
    common.reset_launches()
    sent, results, generations = [], [], []
    for j in range(DRIFT_CALIB_OBS + 4):                 # the reference ratio
        sent.append(images(rng, gpu_opt.spec, 8))
        results.append(drift.serve(key, list(sent[-1])))
        generations.append(drift.stats(key)["generation"])
        if j == 0:                                       # the cold dispatch
            until(lambda: drift._pool.busy == 0)
            cold = drift.stats(key)
    assert not drift._drift.stats(key).triggers and not timing["calls"]
    until(lambda: drift._pool.busy == 0)
    warm = drift.stats(key)
    # the slowdown is sized from the warm dispatches only: the first one
    # pays first-execution costs and would oversize it
    base_s = ((warm["busy_s"] - cold["busy_s"])
              / (warm["dispatches"] - cold["dispatches"]))
    slow.faults.append(Fault("slowdown", net=key, generation=0,
                             seconds=3.0 * base_s))       # 4x from here
    for i in range(DRIFT_MAX_BURSTS):
        sent.append(images(rng, gpu_opt.spec, 8))
        results.append(drift.serve(key, list(sent[-1])))
        generations.append(drift.stats(key)["generation"])
        # tickets finish before the dispatch's drift observation lands
        until(lambda: drift._pool.busy == 0)
        if drift._drift.stats(key).triggers or timing["calls"]:
            break

    def settled():
        st = drift.stats(key)
        return (st["recalibrations"] or st["canary_rejected"]
                or st["last_recal_error"] is not None)
    until(settled, 120.0)
    until(drift.recalibrations_idle, 120.0)
    torch.cuda.synchronize()
    recal_launches = {k: common.LAUNCHES[k] - timing["launches"][k]
                      for k in common.KERNELS}
    sd = drift.stats(key)
    assert timing["calls"] == 1, timing
    assert sd["last_recal_error"] is None, sd["last_recal_error"]
    assert sd["recalibrations"] == 1 and sd["generation"] == 1, sd
    assert sd["canary_rejected"] == 0, sd["last_canary"]
    for _ in range(4):                                   # after the swap
        sent.append(images(rng, gpu_opt.spec, 8))
        results.append(drift.serve(key, list(sent[-1])))
        generations.append(drift.stats(key)["generation"])
    sd = drift.stats(key)
    assert sd["recalibrations"] == 1 and sd["generation"] == 1, sd
    assert not any(sd[k] for k in clean), sd
    with drift._cond:
        new_opt = drift._nets[key].opt
    drift.stop()
    launches["serve_drift"] = took("serve_drift")
    print(f"serve (c): generation serving each burst {generations}", flush=True)
    err_drift = check_responses(gpu_opt, gpu_w, sent, results)
    sample = sd["recal_sample"] or {}
    changed = sum(new_opt.assignment[i] != a for i, a in gpu_opt.assignment.items())
    out["drift"] = {"recal_seconds": timing.get("seconds"),
                    "served_rows": sample.get("served_rows"),
                    "profiled_rows": sample.get("fresh_rows"),
                    "recal_launches": recal_launches,
                    "bursts_to_trigger": i + 1,
                    "predicted_ms": [gpu_opt.predicted_cost_s * 1e3,
                                     new_opt.predicted_cost_s * 1e3],
                    "changed_nodes": changed, "max_abs_err": err_drift,
                    "model": new_opt.models.prim.kind}
    print(f"serve (c): 4x slowdown ({3.0 * base_s * 1e3:.3f} ms added to a "
          f"{base_s * 1e3:.3f} ms mean warm dispatch) on {key} tripped the drift "
          f"monitor after {i + 1} bursts; one recalibration on "
          f"{gpu_opt.platform.fingerprint()} in {timing.get('seconds', float('nan')):.3f} s "
          f"from {sample.get('served_rows')} served rows and "
          f"{sample.get('fresh_rows')} profiled rows ({new_opt.models.prim.kind}, "
          f"predicted {gpu_opt.predicted_cost_s * 1e3:.4f} -> "
          f"{new_opt.predicted_cost_s * 1e3:.4f} ms/img, {changed} nodes "
          f"re-selected), canary passed, generation {sd['generation']}; "
          f"launches during it {recal_launches}; max |served - oracle| "
          f"{err_drift:.3g} over {len(sent)} bursts  ({smi})", flush=True)

    # (d) edge_cnn routed over arm, gpu, tpu and host backends
    shutil.copytree(ARTIFACTS / "models", td / "serve_store" / "models")
    shutil.copytree(ARTIFACTS / "selections", td / "serve_store" / "selections")
    arm = optimise("edge_cnn", "arm", store=ArtifactStore(
        str(td / "serve_store"), device="cuda"), **OPTIMISE_ARGS)
    spec = arm.spec
    convs = [i for i, n in enumerate(spec.nodes) if isinstance(n, ConvLayer)]
    intel, store = transferred["intel"], transferred["store"]
    prep = {}
    t0 = time.perf_counter()
    tpu = optimise("edge_cnn", get_platform("tpu"), base=intel,
                   budget=ROUTE_TPU_BUDGET, executable=True, store=store,
                   device="cuda")
    prep["tpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = HostPlatform(configs=sorted({spec.nodes[i].config for i in convs}),
                        repeats=ROUTE_HOST_REPEATS)
    host_opt = optimise("edge_cnn", host, base=intel, budget=TRANSFER_BUDGET,
                        executable=True, store=store, device="cuda")
    prep["host"] = time.perf_counter() - t0
    cpu = cpu_model()
    assert all(split_tile(tpu.assignment[i])[1] for i in convs), tpu.assignment
    assert not any(split_tile(host_opt.assignment[i])[1] for i in convs)
    print(f"serve (d): prepared tpu ({tpu.platform.fingerprint()}, "
          f"{len(tpu.platform.primitive_dataset().feats)} configs x "
          f"{len(tpu.columns)} tile columns, {tpu.models.mode} from phase 7's "
          f"intel model) in {prep['tpu']:.2f} s and host "
          f"({host.fingerprint()}, {len(host.primitive_dataset().feats)} "
          f"configs x {len(host.columns)} primitives measured on the CPU, "
          f"{cpu}, {host_opt.models.mode}) in {prep['host']:.2f} s: "
          f"{prep['tpu'] + prep['host']:.2f} s (target {ROUTE_PREP_S:g})",
          flush=True)
    opts = {"arm": arm, "gpu": transferred["opt"], "tpu": tpu, "host": host_opt}
    router = OptimisedServer(workers=2, max_batch=8, max_wait_ms=2.0,
                             device="cuda")
    edge_w = weights["edge_cnn_pbqp"]
    for b, o in opts.items():
        router.register(dataclasses.replace(o, net="edge_cnn"), backend=b,
                        weights=edge_w)
    predicted = {b: router.predict_per_image(f"edge_cnn#{b}") for b in opts}
    # one burst pinned to each backend, its launches read alone: a backend
    # launches exactly the kernels its tile columns route to
    by_backend = {b: ([], []) for b in opts}
    for b, o in opts.items():
        xs = images(rng, spec, 8)
        common.reset_launches()
        ts = [router.submit(f"edge_cnn#{b}", x) for x in xs]
        assert all(t.wait(120.0) for t in ts)
        torch.cuda.synchronize()
        launches[f"serve_routing_{b}"] = got = took(f"serve_routing_{b}")
        want = routed_kernels(o.assignment)
        assert all(got[k] > 0 for k in want), (b, got)
        assert all(got[k] == 0 for k in common.KERNELS if k not in want), (b, got)
        by_backend[b][0].extend(xs)
        by_backend[b][1].extend(ts)
    assert launches["serve_routing_tpu"]["matmul"] > 0
    common.reset_launches()
    routed = images(rng, spec, 128)
    rt = [router.submit("edge_cnn", x) for x in routed]
    assert all(t.wait(120.0) for t in rt)
    counts = Counter(t.net.split("#")[1] for t in rt)
    for x, t in zip(routed, rt):
        b = t.net.split("#")[1]
        by_backend[b][0].append(x)
        by_backend[b][1].append(t)
    assert router.unregister_backend("edge_cnn", "gpu")
    rest = [router.submit("edge_cnn", x) for x in routed[:16]]
    assert all(t.wait(60.0) for t in rest)
    assert "edge_cnn#gpu" not in {t.net for t in rest}
    for x, t in zip(routed[:16], rest):
        b = t.net.split("#")[1]
        by_backend[b][0].append(x)
        by_backend[b][1].append(t)
    sr = router.stats("edge_cnn")
    assert not any(sr[k] for k in clean), sr
    router.stop()
    torch.cuda.synchronize()
    launches["serve_routing"] = took("serve_routing")
    out["routing"] = {"prepare_s": prep, "host_cpu": cpu, "backends": {},
                      "routed_requests": dict(counts),
                      "after_unregister": dict(Counter(t.net.split("#")[1]
                                                       for t in rest))}
    for b, o in opts.items():
        xs, ts = by_backend[b]
        assert all(t.error is None and not t.degraded for t in ts), b
        err = check_responses(o, edge_w, [xs], [[t.result for t in ts]])
        row = {"columns": dict(Counter(o.assignment[i] for i in convs)),
               "routed_kernels": sorted(routed_kernels(o.assignment)),
               "predicted_ms": predicted[b] * 1e3, "requests": len(ts),
               "launches": launches[f"serve_routing_{b}"],
               "max_abs_err": err}
        out["routing"]["backends"][b] = row
        source = "measured" if b in ("gpu", "host") else "simulated"
        print(f"serve (d): backend {b} ({o.platform.fingerprint()}): "
              f"predicted {row['predicted_ms']:.4f} ms/img ({source} "
              f"costs), {len(ts)} "
              f"requests ({counts.get(b, 0)} routed), columns "
              f"{row['columns']}, routed kernels {row['routed_kernels']}, "
              f"launches of its pinned burst {row['launches']}, max "
              f"|served - oracle| {err:.3g}  ({smi})", flush=True)
    print(f"serve (d): 128 routed requests went {dict(counts)}; after "
          f"unregistering gpu 16 went {out['routing']['after_unregister']}",
          flush=True)

    # (e) the serving CLI on a store copy
    common.reset_launches()
    t0 = time.perf_counter()
    rc = serve_main(["--net", "edge_cnn", "--platform", "arm", "--workers",
                     "2", "--requests", "64", "--store",
                     str(td / "serve_store")])
    assert rc == 0, rc
    torch.cuda.synchronize()
    launches["serve_cli"] = took("serve_cli")
    out["cli"] = {"rc": rc, "seconds": time.perf_counter() - t0}
    print(f"serve (e): python -m repro_torch.service.server --net edge_cnn "
          f"--platform arm --workers 2 --requests 64 --store <copy>: exit "
          f"{rc} in {out['cli']['seconds']:.2f} s", flush=True)

    common.LAUNCHES.update(saved[0])
    for k, c in saved[1].items():
        common.SEEN[k] = c
    out["seconds"] = time.perf_counter() - t_phase
    phase8 = ("serve_workers", "serve_faults", "serve_drift",
              *(f"serve_routing_{b}" for b in ("arm", "gpu", "tpu", "host")),
              "serve_routing", "serve_cli")
    print("phase 8 launches: " + json.dumps({p: launches[p] for p in phase8}))
    print(f"serve: phase 8 took {out['seconds']:.1f} s  ({smi})", flush=True)
    return out


# ---------------------------------------------------------------------------
# The process front end on the card (phase 9)
# ---------------------------------------------------------------------------

def upload_ms(torch, src, non_blocking) -> float:
    """Device ms of one host-to-device copy of ``src``: CUDA events around
    ``UPLOAD_REPS`` back-to-back copies on the current stream, after two
    warm-ups."""
    x = torch.from_numpy(src)
    for _ in range(2):
        x.to("cuda", non_blocking=non_blocking)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(UPLOAD_REPS):
        x.to("cuda", non_blocking=non_blocking)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / UPLOAD_REPS


def intake_on_card(pids) -> dict:
    """What says whether an intake process touched the card: the card's
    compute processes (``nvidia-smi``; a container may list none) and any
    intake's mapped libcuda or libtorch (``/proc/<pid>/maps``)."""
    import os
    listed = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, check=True).stdout.split()
    on_card = {int(p) for p in listed if p.strip().isdigit()}
    mapped = {pid: sorted({lib for lib in ("libcuda", "libtorch")
                           if lib in Path(f"/proc/{pid}/maps").read_text()})
              for pid in pids}
    return {"compute_pids": sorted(on_card), "intake_pids": list(pids),
            "parent_listed": os.getpid() in on_card,
            "intake_listed": sorted(set(pids) & on_card),
            "intake_mapped": {str(p): m for p, m in mapped.items() if m}}


def frontend_phase(torch, nets, weights, launches, serving, rng, smi) -> dict:
    """Phase 9: (a) ``ingest`` on edge_cnn / PBQP and resnet18 / mix through
    ``FRONTEND_PROCS`` intake processes, every response held to the oracle,
    the served kernels launched; (b) ``drive`` accounting and img/s beside
    phase 8 (a)'s thread front end; (c) no intake process on the card; (d)
    one resnet18 b=8 slab's upload, page-locked against pageable; (e) a
    raise-plus-hang schedule through the slab path on edge_cnn / mix.
    Launch counters and signatures are set aside around the phase and put
    back; its launches are in ``launches`` under its paths."""
    from collections import Counter
    from repro_torch.kernels import common
    from repro_torch.service import Fault, FaultInjector, OptimisedServer
    saved = (dict(common.LAUNCHES), {k: Counter(c) for k, c in common.SEEN.items()})
    out = {"card": smi}
    t_phase = time.perf_counter()
    paths = ("edge_cnn_pbqp", "resnet18_mix")
    clean = ("failed_dispatches", "fallback_images", "rejected", "retries")

    def front_end(**kw):
        return OptimisedServer(workers=2, frontend_procs=FRONTEND_PROCS,
                               frontend_slots=FRONTEND_SLOTS, max_batch=8,
                               max_wait_ms=2.0, device="cuda", **kw)

    server = front_end()
    for name in paths:
        server.register(nets[name], weights=weights[name])
    try:
        fe = server.frontend()
        # (a) ingest: the intake processes assemble b=8 slab batches
        reqs = {name: images(rng, nets[name].spec, FRONTEND_INGEST)
                for name in paths}
        common.reset_launches()
        t0 = time.perf_counter()
        tickets = {name: fe.ingest(name, reqs[name]) for name in paths}
        assert all(t.wait(120.0) for ts in tickets.values() for t in ts)
        ingest_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches["frontend_ingest"] = took("frontend_ingest")
        want = set().union(*(routed_kernels(nets[n].assignment) for n in paths))
        assert want == set(SERVED_KERNELS), want
        assert all(launches["frontend_ingest"][k] > 0 for k in want), \
            launches["frontend_ingest"]
        out["ingest"] = {"seconds": ingest_s, "paths": {},
                         "launches": launches["frontend_ingest"]}
        for name in paths:
            ts = tickets[name]
            assert all(t.error is None and not t.degraded for t in ts)
            err = check_responses(nets[name], weights[name], [reqs[name]],
                                  [[t.result for t in ts]])
            st = server.stats(name)
            assert not any(st[k] for k in clean), (name, st)
            out["ingest"]["paths"][name] = {
                "max_abs_err": err, "dispatches": st["dispatches"],
                "images": st["images"], "padded": st["padded"]}
        print(f"frontend (a): {FRONTEND_PROCS} intake processes, "
              f"{FRONTEND_INGEST} requests a path ingested in {ingest_s:.3f} s; "
              + "; ".join(f"{n}: {p['dispatches']} dispatches, max |served - "
                          f"oracle| {p['max_abs_err']:.3g}"
                          for n, p in out["ingest"]["paths"].items())
              + f"; launches {launches['frontend_ingest']}", flush=True)

        # (b) drive: each intake generates its share of the load
        common.reset_launches()
        out["drive"] = {}
        for name in paths:
            agg = fe.drive(name, FRONTEND_DRIVE, seed=3)
            assert agg["requests"] == FRONTEND_DRIVE
            assert agg["served"] + agg["failed"] + agg["rejected"] == agg["requests"], agg
            assert agg["served"] == FRONTEND_DRIVE and not agg["degraded"], agg
            threaded = serving["workers"]["paths"][name]["images_per_s"]
            out["drive"][name] = {**agg, "threaded_images_per_s_median":
                                  float(np.median(threaded))}
            print(f"frontend (b): drive {name}: {agg['requests']} requests -> "
                  f"{agg['served']} served, {agg['failed']} failed, "
                  f"{agg['rejected']} rejected, {agg['images_per_s']!r} img/s, "
                  f"mean latency {agg['latency_mean_ms']!r} ms; phase 8 (a) "
                  f"threads, the 3 paths at once: median "
                  f"{float(np.median(threaded))!r} img/s  ({smi})", flush=True)
        torch.cuda.synchronize()
        launches["frontend_drive"] = took("frontend_drive")
        assert all(launches["frontend_drive"][k] > 0 for k in want)

        # (c) no intake process on the card
        card = intake_on_card([p.pid for p in fe._children])
        assert not card["intake_listed"] and not card["intake_mapped"], card
        out["intake_on_card"] = card
        print(f"frontend (c): intake pids {card['intake_pids']} not among the "
              f"card's compute processes {card['compute_pids']} (this process "
              f"listed: {card['parent_listed']}); none maps libcuda or "
              f"libtorch", flush=True)

        # (d) one resnet18 b=8 slab's upload, page-locked against pageable
        pool = fe._pools["resnet18_mix"]
        h = pool.alloc(8)
        assert h is not None
        slab = pool.view(h)
        slab[:] = reqs["resnet18_mix"][:8]
        pageable = np.array(slab)
        assert server._is_pinned(slab) and not server._is_pinned(pageable)
        got = torch.from_numpy(slab).to("cuda", non_blocking=True)
        assert torch.equal(got.cpu(), torch.from_numpy(pageable))
        ms = {"pinned": upload_ms(torch, slab, True),
              "pageable": upload_ms(torch, pageable, False)}
        pool.free(h)
        out["upload"] = {"bytes": slab.nbytes, "ms": ms,
                         "gb_s": {k: slab.nbytes / v * 1e-6 for k, v in ms.items()}}
        print(f"frontend (d): one resnet18 b=8 slab ({slab.nbytes} bytes): "
              f"page-locked {ms['pinned']!r} ms "
              f"({out['upload']['gb_s']['pinned']!r} GB/s), pageable "
              f"{ms['pageable']!r} ms ({out['upload']['gb_s']['pageable']!r} "
              f"GB/s), CUDA events over {UPLOAD_REPS} copies  ({smi})",
              flush=True)
    finally:
        server.stop()
    assert all(not p.is_alive() for p in fe._children)

    # (e) raise + hang through the slab path
    mix = nets["edge_cnn_mix"]
    inj = FaultInjector([Fault("raise", net="edge_cnn_mix", first=0, last=2),
                         Fault("hang", net="edge_cnn_mix", first=2, last=3,
                               seconds=DRILL_HANG_S)])
    chaos = front_end(faults=inj, exec_deadline_ms=DRILL_DEADLINE_MS)
    chaos.register(mix, weights=weights["edge_cnn_mix"])
    try:
        fe = chaos.frontend()
        xs = images(rng, mix.spec, FRONTEND_INGEST)
        common.reset_launches()
        ts = fe.ingest("edge_cnn_mix", xs)
        assert all(t.wait(120.0) for t in ts), "lost tickets"
        until(lambda: chaos._pool.zombies == 0)
        torch.cuda.synchronize()
        launches["frontend_chaos"] = took("frontend_chaos")
        st = chaos.stats("edge_cnn_mix")
    finally:
        chaos.stop()
    assert all(t.done and t.error is None and t.result is not None for t in ts)
    degraded = sum(t.degraded for t in ts)
    # exactly once: the served and the degraded images are the tickets
    assert st["images"] + st["fallback_images"] == len(ts), st
    # one batch in flight at a time: the first batch's attempt and retry
    # raise, the second hangs past the deadline; both served degraded, row
    # by row (a bulk reply carries no degraded row)
    assert degraded == st["fallback_images"] > 0, (degraded, st)
    assert st["fallback_dispatches"] == 2, st
    assert st["failures"] == {"fault": 1, "deadline": 1}, st
    assert chaos._pool.restarts == 1
    err = check_responses(mix, weights["edge_cnn_mix"], [xs],
                          [[t.result for t in ts]])
    out["chaos"] = {"tickets": len(ts), "degraded": degraded,
                    "images": st["images"], "failures": st["failures"],
                    "restarts": chaos._pool.restarts, "max_abs_err": err,
                    "launches": launches["frontend_chaos"]}
    print(f"frontend (e): raise + {DRILL_HANG_S} s hang on edge_cnn_mix through "
          f"the slab path: {len(ts)} tickets, {st['images']} served by the "
          f"plan, {degraded} degraded row by row, ledger {st['failures']}, "
          f"restarts {chaos._pool.restarts}; max |served - oracle| {err:.3g}",
          flush=True)

    common.LAUNCHES.update(saved[0])
    for k, c in saved[1].items():
        common.SEEN[k] = c
    out["seconds"] = time.perf_counter() - t_phase
    phase9 = ("frontend_ingest", "frontend_drive", "frontend_chaos")
    print("phase 9 launches: " + json.dumps({p: launches[p] for p in phase9}))
    print(f"frontend: phase 9 took {out['seconds']:.1f} s  ({smi})", flush=True)
    return out


# ---------------------------------------------------------------------------
# The LM decode path on the card (phase 10)
# ---------------------------------------------------------------------------

def lm_phase(torch, launches, seed, smi, device="cuda"):
    """Phase 10, LM_ARCH's decode path through ``repro_torch.models.
    transformer`` and ``launch.lm_decode``: (a) at full width and depth in
    fp32 (TF32 off), weights from a seeded generator on the card: prefill
    a ragged ``LM_HELD_PROMPT``-token prompt, decode ``LM_HELD_STEPS``
    tokens teacher-forced, prefill all of them, the last decode logits held
    to the full prefill's at ``LM_DECODE_TOL``, flash attention launched
    once a layer in each prefill and no kernel in decode; (b) the config
    cut to ``LM_CPU_LAYERS`` layers at full width: prefill and decode
    logits on the card held to the port on the CPU (plain versions) at
    ``LM_CPU_TOL``; (c) ``lm_decode.run`` on the registered bf16 config:
    prefill ms, decode tok/s and peak memory, run twice (the first call
    cold). Launch counters are zeroed before each prefill and decode and
    read after. Returns (summary, {prefill path: flash attention's
    signatures and launches}) for ``check_and_time``."""
    import dataclasses
    from repro_torch.configs import base as cb
    from repro_torch.kernels import common
    from repro_torch.launch import lm_decode
    from repro_torch.models import transformer as T
    from repro_torch.train.optim import tree_leaves

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    full = cb.get(LM_ARCH)
    B, L = LM_BATCH, full.n_layers
    out = {"card": smi, "arch": LM_ARCH, "batch": B, "layers": L}
    passes = {}

    def run(path, fn, kernel_launches, dtype="float32"):
        """fn() with the counters zeroed before and read after, its flash
        launches all on ``dtype``; ms on the host clock around a
        synchronised device."""
        common.reset_launches()
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        launches[path] = took(path)
        assert launches[path]["flash_attention"] == kernel_launches, (
            path, launches[path])
        assert all(n == 0 for k, n in launches[path].items()
                   if k != "flash_attention"), (path, launches[path])
        check_path_dtype(path, dtype)            # (c): bf16 q, k, v on the kernel
        if kernel_launches:
            passes[path] = dict(common.SEEN["flash_attention"])
        return result, ms

    # (a) full width and depth, fp32
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(full, param_dtype=torch.float32)
    params = T.init_params(torch.Generator(device=device).manual_seed(seed), cfg)
    P, N = LM_HELD_PROMPT, LM_HELD_STEPS
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, P + N))).to(device)
    (_, cache), prefill_ms = run(
        f"lm {LM_ARCH} fp32 prefill S={P} B={B}",
        lambda: T.prefill(params, cfg, tokens[:, :P]), L)
    cache = lm_decode.grow_cache(cache, N)

    def decode():
        for i in range(P, P + N):
            logits, _ = T.decode_step(params, cfg, cache, tokens[:, i:i + 1], i)
        return logits

    logits, decode_ms = run(f"lm {LM_ARCH} fp32 decode {N} steps B={B}", decode, 0)
    del cache
    (full_logits, _), full_ms = run(
        f"lm {LM_ARCH} fp32 prefill S={P + N} B={B}",
        lambda: T.prefill(params, cfg, tokens), L)
    assert logits.shape == full_logits.shape == (B, cfg.vocab)
    assert torch.isfinite(logits).all() and torch.isfinite(full_logits).all()
    err = float((logits - full_logits).abs().max())
    print(f"lm (a): {LM_ARCH} fp32, {L} layers, B={B}: prefill {P} tokens "
          f"{prefill_ms:.1f} ms, {N} teacher-forced decode steps {decode_ms:.1f} "
          f"ms, prefill {P + N} tokens {full_ms:.1f} ms; flash attention "
          f"{L} launches a prefill; max |last decode logits - full prefill "
          f"logits| {err:.3g} (tolerance {LM_DECODE_TOL}; |logits| up to "
          f"{float(full_logits.abs().max()):.3g})  ({smi})", flush=True)
    assert err <= LM_DECODE_TOL, err
    out["held"] = {"prompt": P, "steps": N, "prefill_ms": prefill_ms,
                   "decode_ms": decode_ms, "full_prefill_ms": full_ms,
                   "flash_launches_per_prefill": L, "max_abs_err": err,
                   "tol": LM_DECODE_TOL}
    del params, logits, full_logits
    torch.cuda.empty_cache()

    # (b) two layers at full width: the card against the port on the CPU
    cfg = dataclasses.replace(full, n_layers=LM_CPU_LAYERS, param_dtype=torch.float32)
    card = T.init_params(torch.Generator(device=device).manual_seed(seed), cfg)
    cpu = T.map_params(lambda a: a.to("cpu"), card)
    P, N = LM_CPU_PROMPT, LM_CPU_STEPS
    toks = tokens[:, :P + N]
    (got, gcache), _ = run(f"lm {LM_ARCH} {LM_CPU_LAYERS} layers prefill S={P} B={B}",
                           lambda: T.prefill(card, cfg, toks[:, :P]), LM_CPU_LAYERS)
    want, wcache = T.prefill(cpu, cfg, toks[:, :P].cpu())
    errs = [float((got.cpu() - want).abs().max())]
    gcache, wcache = lm_decode.grow_cache(gcache, N), lm_decode.grow_cache(wcache, N)
    for i in range(P, P + N):
        got, _ = T.decode_step(card, cfg, gcache, toks[:, i:i + 1], i)
        want, _ = T.decode_step(cpu, cfg, wcache, toks[:, i:i + 1].cpu(), i)
        errs.append(float((got.cpu() - want).abs().max()))
    print(f"lm (b): {LM_ARCH} cut to {LM_CPU_LAYERS} layers, fp32, B={B}: card "
          f"against the CPU port, prefill {P} tokens max |logits err| "
          f"{errs[0]:.3g}, {N} decode steps {max(errs[1:]):.3g} (tolerance "
          f"{LM_CPU_TOL})", flush=True)
    assert max(errs) <= LM_CPU_TOL, errs
    out["card_vs_cpu"] = {"layers": LM_CPU_LAYERS, "prompt": P, "steps": N,
                          "prefill_max_abs_err": errs[0],
                          "decode_max_abs_err": max(errs[1:]), "tol": LM_CPU_TOL}
    del card, cpu, gcache, wcache, tokens
    torch.cuda.empty_cache()

    # (c) the registered bf16 config, served through lm_decode.run
    out["peak_gb_a_b"] = torch.cuda.max_memory_allocated() / 1e9
    params = T.init_params(torch.Generator(device=device).manual_seed(seed), full)
    weight_gb = sum(a.numel() * a.element_size() for a in tree_leaves(params)) / 1e9
    torch.cuda.reset_peak_memory_stats()
    P, N = LM_SERVED_PROMPT, LM_SERVED_TOKENS
    served = []
    for r in range(2):
        res, _ = run(f"lm {LM_ARCH} bf16 run {r} P={P} N={N} B={B}",
                     lambda: lm_decode.run(full, B, P, N, device=device,
                                           params=params), L, dtype="bfloat16")
        assert res.tokens.shape == (B, N), res.tokens.shape
        assert ((res.tokens >= 0) & (res.tokens < full.vocab)).all()
        served.append(res)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert torch.equal(served[0].tokens, served[1].tokens)
    for r, res in zip(("cold", "warm"), served):
        print(f"lm (c): lm_decode.run {LM_ARCH} bf16, {L} layers, B={B}, "
              f"prompt {P}, {N} tokens ({r}): prefill {res.prefill_ms!r} ms, "
              f"decode {res.decode_tok_s!r} tok/s ({res.decode_ms!r} ms for "
              f"{N - 1} steps)  ({smi})", flush=True)
    print(f"lm (c): weights {weight_gb:.3f} GB bf16, peak device memory "
          f"{peak_gb:.3f} GB over both runs; (a) and (b) peaked at "
          f"{out['peak_gb_a_b']:.3f} GB  ({smi})", flush=True)
    out["served"] = {"prompt": P, "tokens": N, "weights_gb": weight_gb,
                     "peak_gb": peak_gb,
                     "runs": [{"prefill_ms": r.prefill_ms, "decode_ms": r.decode_ms,
                               "decode_tok_s": r.decode_tok_s} for r in served]}
    del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    lm_paths = [p for p in launches if p.startswith("lm ")]
    print("phase 10 launches: " + json.dumps(
        {p: launches[p]["flash_attention"] for p in lm_paths}))
    print(f"lm: phase 10 took {out['seconds']:.1f} s  ({smi})", flush=True)
    return out, passes


def train_phase(torch, launches, seed, smi, device="cuda"):
    """Phase 11, LM_ARCH's training path (see the module docstring, (a) to
    (e)). Launch counters are zeroed before each path and read after it;
    every path but (e)'s no-grad prefill launches no kernel. Returns
    (summary, {(e)'s no-grad prefill: flash attention's signatures}) for
    ``check_and_time``."""
    import contextlib
    import dataclasses
    import io
    import os
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import base as cb
    from repro_torch.data.lm import make_batch
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.train import optim
    from repro_torch.train.optim import tree_map, tree_named_leaves

    t_phase = time.perf_counter()
    full = cb.get(LM_ARCH)
    out = {"card": smi, "arch": LM_ARCH}
    passes = {}

    def run(path, fn, flash=0):
        """fn() with the counters zeroed before and read after."""
        common.reset_launches()
        torch.cuda.synchronize()
        result = fn()
        torch.cuda.synchronize()
        launches[path] = took(path)
        assert launches[path]["flash_attention"] == flash, (path, launches[path])
        assert all(n == 0 for k, n in launches[path].items()
                   if k != "flash_attention"), (path, launches[path])
        if flash:
            passes[path] = dict(common.SEEN["flash_attention"])
        return result

    def leaves(tree) -> dict:
        return dict(tree_named_leaves(tree))

    # (a) one layer at full width, fp32: the card against the CPU port
    cut = dataclasses.replace(full, n_layers=TRAIN_CUT_LAYERS, param_dtype=torch.float32)
    card = T.init_params(torch.Generator(device=device).manual_seed(seed), cut)
    cpu = T.map_params(lambda a: a.to("cpu"), card)
    B, S = TRAIN_CUT_BATCH, TRAIN_CUT_SEQ
    batch = make_batch(cut, B, S, 1, seed=0, device=device)
    hbatch = make_batch(cut, B, S, 1, seed=0, device="cpu")
    path = f"train {LM_ARCH} {TRAIN_CUT_LAYERS} layer fp32 grads B={B} S={S}"
    loss, grads = run(path, lambda: ST.value_and_grad(card, cut, batch))
    hloss, hgrads = ST.value_and_grad(cpu, cut, hbatch)
    loss_err, g_err = abs(float(loss) - float(hloss)), train_grad_err(grads, hgrads)
    attn = leaves(grads["layers"]["attn"])
    zero = [k for k, g in attn.items() if not bool((g != 0).any())]
    assert not zero, zero
    # Both sides step from the CPU's gradients: AdamW's first step divides
    # each gradient element by its own magnitude, so where |g| is near eps
    # the two sides' rounding turns into steps that part by up to ~lr. The
    # gradients are held above, the step's arithmetic here; the steps from
    # each side's own gradients are recorded only.
    lr = ST.DEFAULT_LR
    shared = tree_map(lambda g: g.to(device), hgrads)
    steps_err, own_err = {}, {}
    for name, opt in (("adamw", ST.optimizer_for(cut)[1]),
                      ("adafactor", optim.make_optimizer("adafactor", lr))):
        want, _ = opt.update(cpu, hgrads, opt.init(cpu))
        got, _ = opt.update(card, shared, opt.init(card))
        steps_err[name] = train_step_err(card, got, cpu, want, lr)
        got, _ = opt.update(card, grads, opt.init(card))
        own_err[name] = train_step_err(card, got, cpu, want, lr)
        del got, want
    del shared
    print(f"train (a): {LM_ARCH} cut to {TRAIN_CUT_LAYERS} layer, fp32, B={B}, "
          f"S={S}: loss {float(loss):.6f}; card against the CPU port: loss "
          f"|err| {loss_err:.3g} (tolerance {TRAIN_CPU_TOL}), gradients max "
          f"|err| / the leaf's max |g| {g_err:.3g} (tolerance {TRAIN_GRAD_RTOL}), "
          "parameter steps from the CPU's gradients max |err| / lr "
          + ", ".join(f"{k} {e:.3g}" for k, e in steps_err.items())
          + f" (tolerance {TRAIN_STEP_TOL}; from each side's own gradients, "
          "recorded only: "
          + ", ".join(f"{k} {e:.3g}" for k, e in own_err.items()) + "); "
          f"{len(attn)} attention gradients nonzero; flash attention launches "
          f"{launches[path]['flash_attention']}", flush=True)
    assert loss_err <= TRAIN_CPU_TOL, loss_err
    assert g_err <= TRAIN_GRAD_RTOL, g_err
    assert max(steps_err.values()) <= TRAIN_STEP_TOL, steps_err
    out["card_vs_cpu"] = {"layers": TRAIN_CUT_LAYERS, "batch": B, "seq": S,
                          "loss": float(loss), "loss_abs_err": loss_err,
                          "grad_rel_err": g_err, "step_err_over_lr": steps_err,
                          "own_grads_step_err_over_lr": own_err,
                          "tols": [TRAIN_CPU_TOL, TRAIN_GRAD_RTOL, TRAIN_STEP_TOL],
                          "attn_grads_nonzero": len(attn)}
    del grads, hgrads, attn

    # (e) the flash route on the LM path: one 1-layer prefill without grad
    # launches the kernel once; with parameters that require grad, never
    tokens = batch["tokens"]
    nograd = f"train (e) {LM_ARCH} {TRAIN_CUT_LAYERS} layer prefill no grad S={S}"
    with torch.no_grad():
        fast, _ = run(nograd, lambda: T.prefill(card, cut, tokens), flash=TRAIN_CUT_LAYERS)
    trainable = tree_map(lambda a: a.detach().requires_grad_(True), card)
    plain, _ = run(f"train (e) {LM_ARCH} {TRAIN_CUT_LAYERS} layer prefill grad S={S}",
                   lambda: T.prefill(trainable, cut, tokens))
    q = torch.zeros((4, 64, 128), device=device, requires_grad=True)
    try:
        flash_attention(q, q, q)
        raise AssertionError("flash_attention accepted operands that require grad")
    except common.KernelError as e:
        refused = str(e)
    route_err = float((fast - plain.detach()).abs().max())
    print(f"train (e): {TRAIN_CUT_LAYERS}-layer prefill S={S}: flash attention "
          f"launches {launches[nograd]['flash_attention']} without grad, 0 with "
          f"grad; max |logits kernel - plain| {route_err:.3g}; on operands that "
          f"require grad the kernel raises: {refused}", flush=True)
    assert route_err <= TRAIN_CPU_TOL, route_err
    out["flash_route"] = {"launches_no_grad": TRAIN_CUT_LAYERS, "launches_grad": 0,
                          "max_abs_err": route_err}
    del card, cpu, trainable, fast, plain, q
    torch.cuda.empty_cache()

    # (c) one checkpoint at full width: the 1-layer cut in bf16, AdamW state
    cut16 = dataclasses.replace(cut, param_dtype=torch.bfloat16)
    params = T.init_params(torch.Generator(device=device).manual_seed(seed), cut16)
    _, opt = ST.optimizer_for(cut16)
    path = f"train {LM_ARCH} {TRAIN_CUT_LAYERS} layer bf16 step B={B} S={S}"
    state = run(path, lambda: ST.make_train_step(cut16, opt)(
        params, opt.init(params), make_batch(cut16, B, S, 1, seed=0, device=device)))[:2]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt.") as td:
        mgr = CheckpointManager(td)
        t0 = time.perf_counter()
        final = mgr.save(1, state)
        save_s = time.perf_counter() - t0
        gb = sum(os.path.getsize(os.path.join(final, f)) for f in os.listdir(final)) / 1e9
        t0 = time.perf_counter()
        back = mgr.restore(1, state, device=device)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    want, got = leaves(state), leaves(back)
    assert sorted(want) == sorted(got)
    for k in want:
        if isinstance(want[k], int):
            assert got[k] == want[k], k
        else:
            assert got[k].device == want[k].device and got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
    print(f"train (c): {LM_ARCH} cut to {TRAIN_CUT_LAYERS} layer, bf16 + AdamW "
          f"state ({len(want)} leaves): {gb:.3f} GB written in {save_s:.2f} s, "
          f"restored onto the card bit for bit in {restore_s:.2f} s  ({smi})",
          flush=True)
    out["checkpoint"] = {"leaves": len(want), "gb": gb, "save_s": save_s,
                         "restore_s": restore_s}
    del params, state, back, want, got
    torch.cuda.empty_cache()

    # (b) the main run: 8 layers at full width, bf16, remat, ten AdamW steps
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    assert cfg.remat and cfg.param_dtype == torch.bfloat16
    B, S = TRAIN_BATCH, TRAIN_SEQ
    torch.cuda.reset_peak_memory_stats()
    lines = []
    path = f"train {LM_ARCH} {TRAIN_LAYERS} layers bf16 {TRAIN_STEPS} steps B={B} S={S}"
    res = run(path, lambda: TR.train_loop(cfg, B, S, TRAIN_STEPS, ckpt_dir=None,
                                          device=device, seed=seed,
                                          log=lines.append))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses, step_ms = res.losses, res.step_ms
    assert len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses), losses
    ln_v = math.log(cfg.vocab)
    assert abs(losses[0] - ln_v) <= TRAIN_FIRST_LOSS_SLACK, (losses[0], ln_v)
    assert losses[-1] < losses[0], losses
    med_s = float(np.median(step_ms)) / 1e3
    T_tok = B * S
    n = cfg.n_params()
    hd, H = cfg.hd, cfg.n_heads
    layer = (cfg.d_model * H * hd * 2 + 2 * cfg.d_model * cfg.n_kv_heads * hd
             + 3 * cfg.d_model * cfg.d_ff)
    head = cfg.d_model * cfg.vocab
    # the work a step needs: bf16 products forward 2, backward 4 a weight
    # and token; fp32 attention einsums (TF32 off) over the causal half of
    # the scores, 2 B H S^2 hd forward, twice that backward
    bf16_flops = 6 * T_tok * (cfg.n_layers * layer + head)
    fp32_flops = 3 * 2 * B * H * S * S * hd * cfg.n_layers
    bound_ms = (bf16_flops / BF16_FLOPS + fp32_flops / FP32_FLOPS) * 1e3
    # what the step runs beyond that: the remat re-forward of the layers
    # and of each CE chunk, and the einsums' masked half in forward,
    # backward and re-forward plus the re-forward's causal half
    extra_bf16 = 2 * T_tok * (cfg.n_layers * layer + head)
    extra_fp32 = 4 * 4 * B * H * S * S * hd * cfg.n_layers - fp32_flops
    extra_ms = (extra_bf16 / BF16_FLOPS + extra_fp32 / FP32_FLOPS) * 1e3
    model_tflops = 6 * n * T_tok / med_s / 1e12
    for line in lines:
        print(f"  {line}")
    print(f"train (b): {LM_ARCH} at full width, {TRAIN_LAYERS} of "
          f"{full.n_layers} layers, bf16, remat, AdamW, B={B}, S={S}: losses "
          f"{[round(x, 4) for x in losses]} (ln vocab {ln_v:.4f}); step ms "
          f"median {med_s * 1e3!r}, all {[round(x, 1) for x in step_ms]}; "
          f"{T_tok / med_s!r} tokens/s; model {model_tflops!r} TFLOP/s "
          f"(6 N T, N {n}) against the dense bf16 peak {BF16_FLOPS / 1e12:g}; "
          f"bound {bound_ms!r} ms ({bf16_flops / 1e12:.2f} TFLOP bf16 products, "
          f"{fp32_flops / 1e12:.2f} TFLOP fp32 causal attention einsums, "
          f"operations), step / bound {med_s * 1e3 / bound_ms!r}; remat "
          f"re-forward and masked score blocks add {extra_bf16 / 1e12:.2f} TFLOP "
          f"bf16 and {extra_fp32 / 1e12:.2f} TFLOP fp32 ({extra_ms!r} ms at the "
          f"peaks); "
          f"peak memory {peak_gb!r} GB; launches {launches[path]}  ({smi})",
          flush=True)

    # one more step under the profiler: device busy share and top device ops
    from torch.profiler import ProfilerActivity, profile
    step_fn = ST.make_train_step(cfg, ST.optimizer_for(cfg)[1])
    b = make_batch(cfg, B, S, TRAIN_STEPS + 1, seed=0, device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p2, s2, _ = step_fn(res.params, res.opt_state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del p2, s2, res
    busy_ms, top, launching = profile_summary(prof)
    del prof
    torch.cuda.empty_cache()
    if busy_ms is None:
        print(f"train (b): one profiled step: wall {wall_ms!r} ms, device busy not "
              f"measured (no device events recorded)")
    else:
        print(f"train (b): one profiled step: wall {wall_ms!r} ms, device busy "
              f"{busy_ms!r} ms, busy share {busy_ms / wall_ms!r}")
        for op, ms in top:
            print(f"    device {ms:.4f} ms  {op}")
        print("  by launching op:")
        for op, ms in launching:
            print(f"    device {ms:.4f} ms  {op}")
    out["main_run"] = {
        "layers": TRAIN_LAYERS, "batch": B, "seq": S, "steps": TRAIN_STEPS,
        "n_params": n, "losses": losses, "step_ms": step_ms,
        "step_ms_median": med_s * 1e3, "tokens_s": T_tok / med_s,
        "model_tflops": model_tflops, "peak_bf16_tflops": BF16_FLOPS / 1e12,
        "bound_ms": bound_ms, "bound_by": "operations",
        "bf16_tflop": bf16_flops / 1e12, "fp32_tflop": fp32_flops / 1e12,
        "extra_bf16_tflop": extra_bf16 / 1e12, "extra_fp32_tflop": extra_fp32 / 1e12,
        "extra_ms": extra_ms,
        "peak_gb": peak_gb, "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "busy_share": None if busy_ms is None else busy_ms / wall_ms,
        "top_device_ops": top}

    # (d) the CLI on the card (device by default), reduced config: 4 steps,
    # then 6 resuming from 4, against an uninterrupted 6-step run
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}

    def cli(ckpt_dir, n_steps, every):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
             "--steps", str(n_steps), "--ckpt-every", str(every), "--ckpt-dir",
             ckpt_dir], cwd=root, env=env, capture_output=True, text=True,
            timeout=600)
        assert r.returncode == 0, r.stderr[-4000:]
        return r.stdout

    small = cb.get(LM_ARCH).reduced()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train.") as td:
        first = cli(f"{td}/a", 4, 2)
        resumed = cli(f"{td}/a", 6, 1)
        assert "[train] resumed from step 4" in resumed, resumed
        whole = f"train (d) {LM_ARCH} reduced, uninterrupted 6 steps"
        with contextlib.redirect_stdout(io.StringIO()):
            run(whole, lambda: TR.main(["--arch", LM_ARCH, "--steps", "6",
                                        "--ckpt-every", "1", "--ckpt-dir", f"{td}/b"]))
        loss = {d: {s: CheckpointManager(f"{td}/{d}/{small.name}").manifest(s)["extra"]["loss"]
                    for s in (5, 6)} for d in ("a", "b")}
    err = max(abs(loss["a"][s] - loss["b"][s]) for s in (5, 6))
    print(f"train (d): python -m repro_torch.launch.train --arch {LM_ARCH} "
          f"(reduced, cuda by default): 4 steps, then resumed from step 4 to 6; "
          f"steps 5, 6 losses {[loss['a'][s] for s in (5, 6)]} against an "
          f"uninterrupted run's {[loss['b'][s] for s in (5, 6)]}, max |diff| "
          f"{err:.3g} (tolerance {TRAIN_RESUME_TOL})", flush=True)
    print("  " + "\n  ".join((first + resumed).strip().splitlines()))
    assert err <= TRAIN_RESUME_TOL, err
    out["cli_resume"] = {"losses_resumed": loss["a"], "losses_whole": loss["b"],
                         "max_abs_err": err, "tol": TRAIN_RESUME_TOL}

    out["seconds"] = time.perf_counter() - t_phase
    train_paths = [p for p in launches if p.startswith("train ")]
    print("phase 11 launches: " + json.dumps(
        {p: launches[p]["flash_attention"] for p in train_paths}))
    print(f"train: phase 11 took {out['seconds']:.1f} s  ({smi})", flush=True)
    return out, passes


def train_grad_err(got, want) -> float:
    """Max over the leaves of two gradient trees of max |got - want| over
    the leaf's max |want| (``want`` on the CPU)."""
    from repro_torch.train.optim import tree_named_leaves
    g, w = dict(tree_named_leaves(got)), dict(tree_named_leaves(want))
    assert sorted(g) == sorted(w)
    worst = 0.0
    for k in g:
        assert g[k].shape == w[k].shape and bool(g[k].isfinite().all()), k
        scale = float(w[k].abs().max())
        err = float((g[k].cpu() - w[k]).abs().max())
        assert scale > 0 or err == 0, (k, err)
        worst = max(worst, err / scale if scale > 0 else 0.0)
    return worst


def train_step_err(before, after, before_ref, after_ref, lr) -> float:
    """The max over every parameter element of |its step (after - before)
    minus the reference's (``*_ref``, on the CPU)| in units of ``lr``."""
    from repro_torch.train.optim import tree_named_leaves
    b, a, br, ar = (dict(tree_named_leaves(t))
                    for t in (before, after, before_ref, after_ref))
    assert sorted(b) == sorted(a) == sorted(br) == sorted(ar)
    return max(float(((a[k] - b[k]).cpu() - (ar[k] - br[k])).abs().max()) / lr
               for k in b)


# ---------------------------------------------------------------------------
# The LM families' serving path on the card (phase 12)
# ---------------------------------------------------------------------------

def family_config(arch, layers=None, dtype=None, dropless=False):
    """The registered config of ``arch`` cut to ``layers`` (a hybrid's in
    groups of its period), in ``dtype``; MoE ``dropless`` at capacity E / K
    (the reference's own remedy, ``configs/base.py``'s ``reduced``)."""
    import dataclasses
    from repro_torch.configs import base as cb
    cfg = cb.get(arch)
    kw = {}
    if layers is not None:
        kw["n_layers"] = layers * (cfg.hybrid_attn_every or 1)
        if cfg.kind == "encdec":
            kw["n_enc_layers"] = layers
    if dtype is not None:
        kw["param_dtype"] = dtype
    if dropless and cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    return dataclasses.replace(cfg, **kw)


def family_flash(cfg) -> int:
    """Flash attention launches a prefill of ``cfg`` takes: one per
    routed self-attention (causal MoE decoders at head dim 128, Whisper's
    non-causal encoder and causal decoder at 64); MLA (qk 96 against v 64),
    SSM and zamba2's head dim 80 run none."""
    if cfg.kind == "encdec":
        return cfg.n_enc_layers + cfg.n_layers
    return cfg.n_layers if cfg.moe is not None else 0


class RouteRecorder:
    """Records the expert ids (``calls``) and the aux loss (``aux``, detached)
    of every MoE routing (``moe._route``) while entered, in call order, to
    compare routings and count drops."""

    def __init__(self):
        self.calls, self.aux = [], []

    def __enter__(self):
        from repro_torch.models import moe as M
        self._route = route = M._route

        def recorded(params, x, cfg):
            out = route(params, x, cfg)
            self.calls.append(out[0])
            self.aux.append(out[2].detach())
            return out
        M._route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as M
        M._route = self._route


def dropped_pairs(torch, gate_idx, n_experts, cap) -> int:
    """(token, k) pairs a capacity of ``cap`` slots an expert and batch row
    drops from the routing ``gate_idx`` (B, S, K)."""
    B = gate_idx.shape[0]
    counts = torch.zeros((B, n_experts), dtype=torch.long, device=gate_idx.device)
    counts.scatter_add_(1, gate_idx.reshape(B, -1), torch.ones_like(gate_idx.reshape(B, -1)))
    return int(torch.clamp(counts - cap, min=0).sum())


def families_phase(torch, launches, seed, smi, device="cuda"):
    """Phase 12, the serving path of the MLA, MoE, SSM, hybrid and
    encoder-decoder families (see the module docstring, (a) to (c)). Launch
    counters are zeroed before each prefill, decode and run and read after:
    flash attention ``family_flash(cfg)`` times a prefill, never in decode,
    no other kernel. Returns (summary, {prefill path: flash attention's
    signatures}) for ``check_and_time``, and every prefill's signatures
    apart, to be held to the plain version."""
    from repro_torch.kernels import common
    from repro_torch.launch import lm_decode
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.train.optim import tree_leaves

    t_phase = time.perf_counter()
    out = {"card": smi, "batch": LM_BATCH, "held": {}, "card_vs_cpu": {}, "served": {}}
    timed, seen = {}, set()
    B = LM_BATCH

    def run(path, fn, flash, time_it=False, dtype="float32"):
        """fn() with the counters zeroed before and read after, its flash
        launches all on ``dtype``; ms on the host clock around a
        synchronised device."""
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[path] = took(path)
        assert launches[path]["flash_attention"] == flash, (path, launches[path])
        assert all(n == 0 for k, n in launches[path].items()
                   if k != "flash_attention"), (path, launches[path])
        check_path_dtype(path, dtype)            # (c): bf16 q, k, v on the kernel
        if flash:
            seen.update(common.SEEN["flash_attention"])
            if time_it:
                timed[path] = dict(common.SEEN["flash_attention"])
        return result, ms

    def frames(cfg, gen):
        """Whisper's encoder input: ``WHISPER_FRAMES`` unit-normal frame
        embeddings a row, from the seeded generator."""
        if cfg.kind != "encdec":
            return None
        return torch.randn((B, WHISPER_FRAMES, cfg.d_model), generator=gen,
                           device=device)

    # (a) teacher-forced decode against a full prefill, fp32
    for arch, (layers, P, N) in FAMILY_HELD.items():
        cfg = family_config(arch, layers, torch.float32, dropless=True)
        gen = torch.Generator(device=device).manual_seed(seed)
        params = T.init_params(gen, cfg)
        enc = frames(cfg, gen)
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (B, P + N))).to(device)
        flash = family_flash(cfg)
        with RouteRecorder() as routes:
            (_, cache), prefill_ms = run(
                f"lm {arch} fp32 prefill S={P} B={B}",
                lambda: T.prefill(params, cfg, tokens[:, :P], enc_embeds=enc),
                flash, time_it=True)
        cache = lm_decode.grow_cache(cache, N)

        def decode():
            for i in range(P, P + N):
                logits, _ = T.decode_step(params, cfg, cache, tokens[:, i:i + 1], i)
            return logits

        logits, decode_ms = run(f"lm {arch} fp32 decode {N} steps B={B}", decode, 0)
        del cache
        (full_logits, _), full_ms = run(
            f"lm {arch} fp32 prefill S={P + N} B={B}",
            lambda: T.prefill(params, cfg, tokens, enc_embeds=enc), flash)
        assert logits.shape == full_logits.shape == (B, cfg.vocab)
        assert torch.isfinite(logits).all() and torch.isfinite(full_logits).all()
        err = float((logits - full_logits).abs().max())
        held = {"layers": cfg.n_layers, "prompt": P, "steps": N,
                "prefill_ms": prefill_ms, "decode_ms": decode_ms,
                "full_prefill_ms": full_ms, "flash_launches_per_prefill": flash,
                "max_abs_err": err, "tol": LM_DECODE_TOL}
        drops = ""
        if cfg.moe is not None:
            cap = M.capacity(family_config(arch).moe, P)
            n = sum(dropped_pairs(torch, g, cfg.moe.n_experts, cap) for g in routes.calls)
            pairs = len(routes.calls) * B * P * cfg.moe.top_k
            held["dropped_at_registered_capacity"] = {"capacity": cap, "pairs": n,
                                                      "of": pairs}
            drops = (f"; at the registered capacity factor 1.25 ({cap} slots an "
                     f"expert) this prefill would drop {n} of {pairs} (token, k) "
                     f"pairs")
        out["held"][arch] = held
        print(f"lm families (a): {arch} fp32, {cfg.n_layers} of "
              f"{family_config(arch).n_layers} layers, B={B}"
              f"{', dropless' if cfg.moe is not None else ''}: prefill {P} tokens "
              f"{prefill_ms:.1f} ms, {N} teacher-forced decode steps {decode_ms:.1f} ms, "
              f"prefill {P + N} tokens {full_ms:.1f} ms; flash attention {flash} "
              f"launches a prefill; max |last decode logits - full prefill logits| "
              f"{err:.3g} (tolerance {LM_DECODE_TOL}; |logits| up to "
              f"{float(full_logits.abs().max()):.3g}){drops}  ({smi})", flush=True)
        assert err <= LM_DECODE_TOL, (arch, err)
        del params, logits, full_logits, enc
        torch.cuda.empty_cache()

    # (b) 2 layers (2 groups) at full width: the card against the CPU port
    P, N = LM_CPU_PROMPT, LM_CPU_STEPS
    for arch in FAMILY_HELD:
        cfg = family_config(arch, LM_CPU_LAYERS, torch.float32)
        gen = torch.Generator(device=device).manual_seed(seed)
        card = T.init_params(gen, cfg)
        enc = frames(cfg, gen)
        cpu = T.map_params(lambda a: a.to("cpu"), card)
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (B, P + N))).to(device)
        flash = family_flash(cfg)
        with RouteRecorder() as card_routes:
            (got, gcache), _ = run(
                f"lm {arch} {LM_CPU_LAYERS} layers prefill S={P} B={B}",
                lambda: T.prefill(card, cfg, toks[:, :P], enc_embeds=enc), flash)
            gcache = lm_decode.grow_cache(gcache, N)
            gots = [got]
            for i in range(P, P + N):
                got, _ = run(f"lm {arch} {LM_CPU_LAYERS} layers decode pos {i}",
                             lambda: T.decode_step(card, cfg, gcache, toks[:, i:i + 1], i),
                             0)[0]
                gots.append(got)
        hcpu = None if enc is None else enc.cpu()
        with RouteRecorder() as cpu_routes:
            want, wcache = T.prefill(cpu, cfg, toks[:, :P].cpu(), enc_embeds=hcpu)
            wcache = lm_decode.grow_cache(wcache, N)
            wants = [want]
            for i in range(P, P + N):
                wants.append(T.decode_step(cpu, cfg, wcache, toks[:, i:i + 1].cpu(), i)[0])
        errs = [float((g.cpu() - w).abs().max()) for g, w in zip(gots, wants)]
        res = {"layers": cfg.n_layers, "prompt": P, "steps": N,
               "prefill_max_abs_err": errs[0], "decode_max_abs_err": max(errs[1:]),
               "tol": LM_CPU_TOL, "flash_launches": flash}
        routing = ""
        if cfg.moe is not None:
            assert len(card_routes.calls) == len(cpu_routes.calls)
            differ = sum(int((torch.sort(g, -1).values.cpu()
                              != torch.sort(w, -1).values).any(-1).sum())
                         for g, w in zip(card_routes.calls, cpu_routes.calls))
            tokens_routed = sum(g.shape[0] * g.shape[1] for g in card_routes.calls)
            res["topk_sets_differ"] = {"tokens": differ, "of": tokens_routed}
            routing = (f"; top-k expert sets differ between card and CPU for {differ} "
                       f"of {tokens_routed} routed tokens")
        out["card_vs_cpu"][arch] = res
        print(f"lm families (b): {arch} cut to {cfg.n_layers} layers, fp32, B={B}: "
              f"card against the CPU port, prefill {P} tokens max |logits err| "
              f"{errs[0]:.3g}, {N} decode steps {max(errs[1:]):.3g} (tolerance "
              f"{LM_CPU_TOL}){routing}", flush=True)
        assert max(errs) <= LM_CPU_TOL, (arch, errs)
        del card, cpu, gcache, wcache, enc
        torch.cuda.empty_cache()

    # (c) the registered bf16 configs, served through lm_decode.run
    P, N = LM_SERVED_PROMPT, LM_SERVED_TOKENS
    for arch in FAMILY_HELD:
        layers, why = FAMILY_SERVED_CUT.get(arch, (None, ""))
        cfg = family_config(arch, layers)
        torch.cuda.empty_cache()
        held_gb = torch.cuda.memory_allocated() / 1e9     # what earlier phases hold
        params = T.init_params(torch.Generator(device=device).manual_seed(seed), cfg)
        weight_gb = sum(a.numel() * a.element_size() for a in tree_leaves(params)) / 1e9
        torch.cuda.reset_peak_memory_stats()
        flash = family_flash(cfg)
        served = []
        for r in range(2):
            res, _ = run(f"lm {arch} bf16 run {r} P={P} N={N} B={B}",
                         lambda: lm_decode.run(cfg, B, P, N, device=device,
                                               params=params), flash,
                         time_it=r == 1, dtype="bfloat16")
            assert res.tokens.shape == (B, N), res.tokens.shape
            assert ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()
            served.append(res)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        assert torch.equal(served[0].tokens, served[1].tokens)
        cut = (f", cut to {cfg.n_layers} of {family_config(arch).n_layers} "
               f"layers: {why}" if layers else "")
        for r, res in zip(("cold", "warm"), served):
            print(f"lm families (c): lm_decode.run {arch} bf16, {cfg.n_layers} layers"
                  f"{cut}, B={B}, prompt {P}, {N} tokens ({r}): prefill "
                  f"{res.prefill_ms!r} ms, decode {res.decode_tok_s!r} tok/s "
                  f"({res.decode_ms!r} ms for {N - 1} steps)  ({smi})", flush=True)
        print(f"lm families (c): {arch} weights {weight_gb:.3f} GB bf16, peak device "
              f"memory {peak_gb:.3f} GB over both runs, {held_gb:.3f} GB of it held "
              f"before the weights were made  ({smi})", flush=True)
        out["served"][arch] = {
            "layers": cfg.n_layers, "cut": why or None, "prompt": P, "tokens": N,
            "weights_gb": weight_gb, "peak_gb": peak_gb, "held_gb": held_gb,
            "flash_launches": flash,
            "runs": [{"prefill_ms": r.prefill_ms, "decode_ms": r.decode_ms,
                      "decode_tok_s": r.decode_tok_s} for r in served]}
        del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    lm_paths = [p for p in launches if p.startswith("lm ") and
                any(p.startswith(f"lm {a} ") for a in FAMILY_HELD)]
    print("phase 12 launches: " + json.dumps(
        {p: launches[p]["flash_attention"] for p in lm_paths}))
    print(f"lm families: phase 12 took {out['seconds']:.1f} s  ({smi})", flush=True)
    return out, timed, seen


# ---------------------------------------------------------------------------
# The LM families' training path on the card (phase 13)
# ---------------------------------------------------------------------------

def family_grad_check(torch, arch, seed, run, device="cuda") -> dict:
    """Phase 13 (a) for one family: ``arch`` at full width cut to one unit
    (``family_config(arch, 1)``: a layer, zamba2 a group, whisper an encoder
    and a decoder layer) in fp32 at its registered MoE capacity;
    ``steps.value_and_grad`` of one ``make_batch`` batch (seed 0, B=1,
    S=256) on the card, through ``run(path, fn)`` (which holds the launch
    counters), and on the CPU port. Returns the loss's |card - CPU|, the
    gradients' (``train_grad_err``), one AdamW (``optimizer_for``) step
    from the CPU's gradients on both sides in units of lr
    (``train_step_err``), the leaves nonzero on the CPU and zero on the
    card, and for MoE the aux loss and the tokens whose top-k expert sets
    differ. Asserts nothing; the caller holds the numbers."""
    from repro_torch.data.lm import make_batch
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.train.optim import tree_map, tree_named_leaves

    cut = family_config(arch, 1, torch.float32)
    card = T.init_params(torch.Generator(device=device).manual_seed(seed), cut)
    cpu = T.map_params(lambda a: a.to("cpu"), card)
    B, S = TRAIN_CUT_BATCH, TRAIN_CUT_SEQ
    batch = make_batch(cut, B, S, 1, seed=0, device=device)
    hbatch = make_batch(cut, B, S, 1, seed=0, device="cpu")
    with RouteRecorder() as card_routes:
        loss, grads = run(f"train {arch} 1 unit fp32 grads B={B} S={S}",
                          lambda: ST.value_and_grad(card, cut, batch))
    with RouteRecorder() as cpu_routes:
        hloss, hgrads = ST.value_and_grad(cpu, cut, hbatch)
    g, h = dict(tree_named_leaves(grads)), dict(tree_named_leaves(hgrads))
    nonzero = {k: bool((a != 0).any()) for k, a in h.items()}
    out = {"layers": cut.n_layers, "enc_layers": cut.n_enc_layers, "batch": B,
           "seq": S, "loss": float(loss),
           "loss_abs_err": abs(float(loss) - float(hloss)),
           "grad_rel_err": train_grad_err(grads, hgrads), "leaves": len(h),
           "nonzero_leaves": sum(nonzero.values()),
           "lost_on_card": sorted(k for k in h if nonzero[k]
                                  and not bool((g[k] != 0).any()))}
    del grads, g
    if cut.moe is not None:
        # remat re-runs each layer's routing in backward: the first
        # n_layers calls are the forward's
        assert len(card_routes.calls) == len(cpu_routes.calls)
        out["aux"] = float(sum(card_routes.aux[:cut.n_layers]))
        out["cpu_aux"] = float(sum(cpu_routes.aux[:cut.n_layers]))
        out["capacity"] = cut.moe.capacity_factor
        out["topk_sets_differ"] = {
            "tokens": sum(int((torch.sort(a, -1).values.cpu()
                               != torch.sort(b, -1).values).any(-1).sum())
                          for a, b in zip(card_routes.calls, cpu_routes.calls)),
            "of": sum(a.shape[0] * a.shape[1] for a in card_routes.calls)}
    _, opt = ST.optimizer_for(cut)
    shared = tree_map(lambda a: a.to(device), hgrads)
    want, _ = opt.update(cpu, hgrads, opt.init(cpu))
    got, _ = opt.update(card, shared, opt.init(card))
    out["step_err_over_lr"] = train_step_err(card, got, cpu, want, ST.DEFAULT_LR)
    return out


def families_train_phase(torch, launches, seed, smi, device="cuda") -> dict:
    """Phase 13, the training path of the MLA, MoE, SSM, hybrid and
    encoder-decoder families (see the module docstring, (a) to (c)). Launch
    counters are zeroed before each path and read after it: no path
    launches a kernel (the flash kernel has no backward)."""
    import contextlib
    import io
    import os
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import base as cb
    from repro_torch.data.lm import make_batch
    from repro_torch.kernels import common
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TR
    from repro_torch.train.optim import tree_leaves

    t_phase = time.perf_counter()
    out = {"card": smi, "unit_card_vs_cpu": {}, "trained": {}, "cli_resume": {}}

    def run(path, fn):
        """fn() with the counters zeroed before and read after: none may
        launch."""
        common.reset_launches()
        torch.cuda.synchronize()
        result = fn()
        torch.cuda.synchronize()
        launches[path] = took(path)
        assert not any(launches[path].values()), (path, launches[path])
        return result

    # (a) one unit at full width, fp32: the card against the CPU port
    for arch in FAMILY_HELD:
        r = family_grad_check(torch, arch, seed, run, device)
        moe = ""
        if "aux" in r:
            d = r["topk_sets_differ"]
            moe = (f"; aux loss {r['aux']!r} (CPU {r['cpu_aux']!r}) at capacity "
                   f"{r['capacity']}; top-k expert sets differ for {d['tokens']} of "
                   f"{d['of']} routed tokens")
        print(f"families train (a): {arch} cut to 1 unit ({r['layers']} layers"
              f"{' + ' + str(r['enc_layers']) + ' encoder' if r['enc_layers'] else ''}), "
              f"fp32, B={r['batch']}, S={r['seq']}: loss {r['loss']:.6f}; card "
              f"against the CPU port: loss |err| {r['loss_abs_err']:.3g} (tolerance "
              f"{TRAIN_CPU_TOL}), gradients max |err| / the leaf's max |g| "
              f"{r['grad_rel_err']:.3g} (tolerance {TRAIN_GRAD_RTOL}), AdamW step "
              f"from the CPU's gradients max |err| / lr {r['step_err_over_lr']:.3g} "
              f"(tolerance {TRAIN_STEP_TOL}); {r['nonzero_leaves']} of {r['leaves']} "
              f"gradient leaves nonzero on the CPU, {len(r['lost_on_card'])} of them "
              f"zero on the card{moe}; no kernel launched", flush=True)
        assert r["loss_abs_err"] <= TRAIN_CPU_TOL, (arch, r)
        assert r["grad_rel_err"] <= TRAIN_GRAD_RTOL, (arch, r)
        assert r["step_err_over_lr"] <= TRAIN_STEP_TOL, (arch, r)
        assert not r["lost_on_card"], (arch, r["lost_on_card"])
        assert r.get("topk_sets_differ", {"tokens": 0})["tokens"] == 0, (arch, r)
        out["unit_card_vs_cpu"][arch] = r
        torch.cuda.empty_cache()

    # (b) train_loop at full width, bf16, remat, at FAMILY_TRAIN_CUT's depths
    from torch.profiler import ProfilerActivity, profile
    B, S = TRAIN_BATCH, TRAIN_SEQ
    for arch, (units, why) in FAMILY_TRAIN_CUT.items():
        cfg = family_config(arch, units)
        n_steps = FAMILY_TRAIN_STEPS if cfg.moe is None else TRAIN_STEPS
        full = family_config(arch)
        assert cfg.remat and cfg.param_dtype == torch.bfloat16
        torch.cuda.empty_cache()
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        lines = []
        path = f"train {arch} {cfg.n_layers} layers bf16 {n_steps} steps B={B} S={S}"
        with RouteRecorder() as routes:
            res = run(path, lambda: TR.train_loop(cfg, B, S, n_steps, ckpt_dir=None,
                                                  device=device, seed=seed,
                                                  log=lines.append))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses, step_ms = res.losses, res.step_ms
        aux = None
        if cfg.moe is not None:
            # a step routes each layer twice (its forward, then remat's
            # recompute in backward); the first n_layers calls are the forward's
            per = len(routes.aux) // n_steps
            aux = [float(sum(routes.aux[k * per:k * per + cfg.n_layers]))
                   for k in range(n_steps)]
        del routes
        ln_v = math.log(cfg.vocab)
        med_s = float(np.median(step_ms)) / 1e3
        tokens = B * S
        n = cfg.n_active_params()
        n_tree = sum(a.numel() for a in tree_leaves(res.params))
        model_tflops = 6 * n * tokens / med_s / 1e12
        # one more step under the profiler: device busy share, top device ops
        step_fn = ST.make_train_step(cfg, ST.optimizer_for(cfg)[1])
        b = make_batch(cfg, B, S, n_steps + 1, seed=0, device=device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            p2, s2, _ = run(f"{path} profiled step",
                            lambda: step_fn(res.params, res.opt_state, b))
            wall_ms = (time.perf_counter() - t0) * 1e3
        del p2, s2, res, b
        busy_ms, top, _ = profile_summary(prof)
        del prof
        cut = (f"{cfg.n_layers} of {full.n_layers} layers"
               + (f" + {cfg.n_enc_layers} of {full.n_enc_layers} encoder layers"
                  if cfg.kind == "encdec" else "") + (f" ({why})" if why else ""))
        moe = (f", MoE at capacity {cfg.moe.capacity_factor} (the experts run "
               f"{cfg.moe.capacity_factor}x the routed slots)" if cfg.moe else "")
        split = ("" if aux is None else
                 f" = ce {[round(x - a, 4) for x, a in zip(losses, aux)]} + aux "
                 f"{[round(a, 4) for a in aux]}")
        for line in lines:
            print(f"  {line}")
        print(f"families train (b): {arch} at full width, {cut}, bf16, remat, AdamW"
              f"{moe}, B={B}, S={S}: losses {[round(x, 4) for x in losses]}{split} (ln vocab "
              f"{ln_v:.4f}); step ms median {med_s * 1e3!r}, all "
              f"{[round(x, 1) for x in step_ms]}; {tokens / med_s!r} tokens/s; model "
              f"{model_tflops!r} TFLOP/s (6 N T, N {n} {'active ' if cfg.moe else ''}"
              f"parameters by the config's formula, {n_tree} in the tree) against the "
              f"dense bf16 peak {BF16_FLOPS / 1e12:g}; peak memory {peak_gb!r} GB "
              f"({held_gb:.3f} GB of it held before); no kernel launched  ({smi})",
              flush=True)
        if busy_ms is None:
            print(f"  one profiled step: wall {wall_ms!r} ms, device busy not measured "
                  f"(no device events recorded)")
        else:
            print(f"  one profiled step: wall {wall_ms!r} ms, device busy {busy_ms!r} "
                  f"ms, busy share {busy_ms / wall_ms!r}")
            for op, ms in top:
                print(f"    device {ms:.4f} ms  {op}")
        assert len(losses) == n_steps and all(math.isfinite(x) for x in losses), losses
        assert abs(losses[0] - ln_v) <= TRAIN_FIRST_LOSS_SLACK, (arch, losses[0], ln_v)
        if aux is None:
            assert losses[-1] < losses[0], (arch, losses)
        else:
            # AdamW's first steps at the constant lr move every router weight
            # by ~lr: at full width the routing collapses, the aux loss
            # climbs and the total need not fall; the language loss must
            # fall below its start within the run
            ce = [x - a for x, a in zip(losses, aux)]
            assert min(ce[1:]) < ce[0], (arch, ce)
        out["trained"][arch] = {
            "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers, "cut": why or None,
            "batch": B, "seq": S, "steps": n_steps, "n_params": n, "n_tree": n_tree,
            "losses": losses, "aux": aux, "step_ms": step_ms,
            "step_ms_median": med_s * 1e3,
            "tokens_s": tokens / med_s, "model_tflops": model_tflops,
            "peak_bf16_tflops": BF16_FLOPS / 1e12, "peak_gb": peak_gb,
            "held_gb": held_gb, "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": None if busy_ms is None else busy_ms / wall_ms,
            "top_device_ops": top}
        torch.cuda.empty_cache()

    # (c) the CLI on the card (device by default), reduced configs: 4 steps,
    # then 6 resuming from 4, against an uninterrupted 6-step run; the two
    # archs' subprocesses run side by side
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}

    def cli(arch, ckpt_dir, n, every):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
             "--steps", str(n), "--ckpt-every", str(every), "--ckpt-dir", ckpt_dir],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def done(procs):
        outs = []
        for p in procs:
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-4000:]
            outs.append(stdout)
        return outs

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train.") as td:
        first = done([cli(a, f"{td}/{a}/a", 4, 2) for a in FAMILY_TRAIN_CLI])
        resumed = done([cli(a, f"{td}/{a}/a", 6, 1) for a in FAMILY_TRAIN_CLI])
        for arch, f, r in zip(FAMILY_TRAIN_CLI, first, resumed):
            assert "[train] resumed from step 4" in r, r
            with contextlib.redirect_stdout(io.StringIO()):
                run(f"train (c) {arch} reduced, uninterrupted 6 steps",
                    lambda: TR.main(["--arch", arch, "--steps", "6", "--ckpt-every", "1",
                                     "--ckpt-dir", f"{td}/{arch}/b"]))
            name = cb.get(arch).reduced().name
            loss = {d: {s: CheckpointManager(f"{td}/{arch}/{d}/{name}").manifest(s)
                        ["extra"]["loss"] for s in (5, 6)} for d in ("a", "b")}
            err = max(abs(loss["a"][s] - loss["b"][s]) for s in (5, 6))
            print(f"families train (c): python -m repro_torch.launch.train --arch {arch} "
                  f"(reduced, cuda by default): 4 steps, then resumed from step 4 to 6; "
                  f"steps 5, 6 losses {[loss['a'][s] for s in (5, 6)]} against an "
                  f"uninterrupted run's {[loss['b'][s] for s in (5, 6)]}, max |diff| "
                  f"{err:.3g} (tolerance {TRAIN_RESUME_TOL})", flush=True)
            print("  " + "\n  ".join((f + r).strip().splitlines()))
            assert err <= TRAIN_RESUME_TOL, (arch, err)
            out["cli_resume"][arch] = {"losses_resumed": loss["a"],
                                       "losses_whole": loss["b"], "max_abs_err": err,
                                       "tol": TRAIN_RESUME_TOL}

    out["seconds"] = time.perf_counter() - t_phase
    paths = [p for p in launches if p.startswith("train ") and
             any(p.startswith(f"train {a} ") or p.startswith(f"train (c) {a} ")
                 for a in FAMILY_HELD)]
    print("phase 13 launches: " + json.dumps({p: sum(launches[p].values()) for p in paths}))
    print(f"families train: phase 13 took {out['seconds']:.1f} s  ({smi})", flush=True)
    return out


# ---------------------------------------------------------------------------
# The examples, the matmul-site autotune and the memory table (phase 14)
# ---------------------------------------------------------------------------

def example(name):
    """``examples/torch_<name>.py`` as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(torch, launches, seed, smi, device="cuda"):
    """Phase 14 (see the module docstring): (a) the four torch examples on
    the card, (b) the matmul-site autotune on measured card costs, timed at
    bf16, (c) the single-card memory table. Launch counters are zeroed
    before each path and read after it; the autotune must launch the matmul
    kernel, on bf16 operands, and on the wgmma route at every LM site.
    Returns (summary, {one layer of LM_ARCH's
    sites under the chosen variants: the matmul kernel's signatures}) for
    ``check_and_time``."""
    from repro_torch.configs import base as cb
    from repro_torch.core import autotune as AT
    from repro_torch.kernels import common
    from repro_torch.kernels.common import dtype_name
    from repro_torch.kernels.matmul.matmul import matmul_plain
    from repro_torch.kernels.matmul.ops import matmul_op
    from repro_torch.launch import dryrun
    from repro_torch.profiler.device import time_callable

    t_phase = time.perf_counter()
    out = {"card": smi}

    def run(path, fn, kernels=()):
        """fn() with the counters zeroed before and read after; each kernel
        in ``kernels`` must have launched, and no other."""
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        launches[path] = took(path)
        assert all(launches[path][k] > 0 for k in kernels), (path, launches[path])
        return result, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip_smoke.examples.") as td:
        td = Path(td)
        # (a) the examples at the reference's values
        qs, s = run("example quickstart", lambda: example("quickstart").run(device=device))
        assert np.isfinite([qs["prim_mdrae"], qs["dlt_mdrae"]]).all()
        assert qs["model_selected_s"] >= qs["measured_optimal_s"] * (1 - 1e-9)
        out["quickstart"] = {k: qs[k] for k in (
            "n_configs", "prim_mdrae", "dlt_mdrae", "train_s", "select_ms",
            "model_selected_s", "measured_optimal_s")} | {"seconds": s}
        print(f"examples (a) quickstart: {s:.1f} s, MdRAE prim {qs['prim_mdrae']!r} "
              f"DLT {qs['dlt_mdrae']!r}, model-selected {qs['model_selected_s']!r} s "
              f"vs measured-optimal {qs['measured_optimal_s']!r} s  ({smi})", flush=True)

        transfer = example("transfer_learning")
        cold, s_cold = run("example transfer", lambda: transfer.run(str(td / "store"), device=device))
        warm, s_warm = run("example transfer warm", lambda: transfer.run(str(td / "store"), device=device))
        assert not cold["warm"] and warm["warm"] and warm["n_models"] == cold["n_models"]
        keys = ("intel", "direct", "factor", "finetune", "scratch", "native")
        out["transfer"] = {"mdrae": {k: cold[k]["mdrae"] for k in keys},
                           "train_s": {k: cold[k]["seconds"] for k in keys if k != "direct"},
                           "cold_s": s_cold, "warm_s": s_warm}
        print(f"examples (a) transfer_learning: cold {s_cold:.1f} s, warm rerun "
              f"{s_warm:.2f} s (all five models warm); MdRAE "
              f"{json.dumps(out['transfer']['mdrae'])}  ({smi})", flush=True)

        serve, s = run("example serve", lambda: example("serve_optimized_cnn").run(
            **EXAMPLE_SERVE, device=device))
        want = routed_kernels(serve["opt"].assignment)
        assert all(launches["example serve"][k] > 0 for k in want), launches["example serve"]
        err = max(check_responses(net, serve["weights"], [xs], [ys])
                  for net, xs, ys in serve["samples"])
        assert serve["concurrent"]["failed"] == 0
        out["serve"] = {"img_s": serve["img_s"], "speedup": serve["speedup"],
                        "concurrent": serve["concurrent"], "assignment": serve["assignment"],
                        "profile_optimise_s": serve["profile_optimise_s"],
                        "max_abs_err": err, "seconds": s}
        print(f"examples (a) serve_optimized_cnn --workers {EXAMPLE_SERVE['workers']}: "
              f"{s:.1f} s, img/s baseline {serve['img_s']['baseline']!r} optimised "
              f"{serve['img_s']['optimised']!r} concurrent "
              f"{serve['concurrent']['img_s']!r}; {len(serve['samples'])} sampled "
              f"bursts, max |served - oracle| {err:.3g} (tolerance "
              f"{SERVE_TOL['atol']}); kernels routed {sorted(want)}  ({smi})", flush=True)

        arch, steps, cut = EXAMPLE_TRAIN
        lm = example("train_lm")
        whole, s = run("example train_lm", lambda: lm.run(arch, steps, ckpt_dir=str(td / "a"),
                                                                device=device))
        lm.run(arch, cut, ckpt_dir=str(td / "b"), device=device)
        resumed = lm.run(arch, steps, ckpt_dir=str(td / "b"), device=device)
        assert resumed["start"] == cut and np.isfinite(whole["losses"]).all()
        err = float(np.abs(np.subtract(resumed["losses"], whole["losses"][cut:])).max())
        assert err <= EXAMPLE_TRAIN_TOL, err
        out["train_lm"] = {"arch": arch, "losses": whole["losses"],
                           "resumed_losses": resumed["losses"], "max_abs_err": err,
                           "seconds": s}
        print(f"examples (a) train_lm --arch {arch} (reduced): {steps} steps in {s:.1f} s, "
              f"losses {[round(x, 4) for x in whole['losses']]}; resumed from step "
              f"{cut}: max |diff| {err:.3g} against the uninterrupted run", flush=True)

    # (b) the matmul-site autotune on measured card costs, bf16 operands
    cost = AT.MeasuredCost(device, seed)
    assert cost.dtype == torch.bfloat16

    def autotune():
        data = AT.build_dataset(cost, seed=seed)
        model = AT.train_cost_model(data, seed=seed, device=device)
        tuned = {c.name: AT.autotune_arch(c, model, cost_fn=cost) for c in cb.all_assigned()}
        return data, model, tuned

    path = "autotune bf16"
    (data, model, tuned), s = run(path, autotune, kernels=("matmul",))
    check_path_dtype(path, "bfloat16")
    autotune_seen = set(common.SEEN["matmul"])
    # every launch at an LM site took the wgmma route, whatever the variant
    sites = set(AT.site_shapes(cb.all_assigned()))
    site_routes = {}
    for sig in autotune_seen:
        if tuple(sig[:3]) in sites:
            site_routes.setdefault(tuple(sig[:3]), set()).add(sig_route("matmul", sig))
    assert set(site_routes) == sites, sites - set(site_routes)
    assert all(r == {"wgmma"} for r in site_routes.values()), site_routes
    assert data.dtype == torch.bfloat16, data.dtype
    mdrae = AT.mdrae_held_out(model, data, seed)
    print(f"autotune (b): dataset {data.feats.shape[0]} GEMMs ({data.n_sites} sites, "
          f"{data.feats.shape[0] - data.n_sites} sampled) x {len(data.names)} variants, "
          f"timed at {dtype_name(data.dtype)}, "
          f"{data.seconds:.1f} s of timing; NN2 held-out MdRAE {mdrae!r} on "
          f"{len(data.split(seed)[2])} rows; phase (b) {s:.1f} s; "
          f"{launches[path]['matmul']} matmul launches, by route "
          f"{PATH_ROUTES[path]['matmul']}, wgmma loaders (A/B) "
          f"{mm_loaders(path, 'matmul')}; all {len(sites)} LM sites on wgmma  ({smi})",
          flush=True)
    out["autotune"] = {"rows": int(data.feats.shape[0]), "sites": data.n_sites,
                       "dtype": dtype_name(data.dtype),
                       "timing_s": data.seconds, "seconds": s, "mdrae_held_out": mdrae,
                       "archs": {}, "sites_ms": []}
    for name, r in tuned.items():
        print(f"autotune (b) {name}: predicted {r.predicted_s * 1e3:.4f} ms, default "
              f"{r.default_s * 1e3:.4f} ms, oracle {r.oracle_s * 1e3:.4f} ms; "
              f"{json.dumps(r.assignment)}")
        out["autotune"]["archs"][name] = dataclasses.asdict(r)
    # per site: the chosen variant's bf16 time beside torch.matmul's on the
    # same bf16 operands, and the kernel held to its plain version at that
    # shape (fp32 output: exact products, so sum order only)
    print("autotune (b) per site: arch site M K N | chosen variant route ms | "
          "torch.matmul ms (bf16) | max |kernel - plain| / max |plain|")
    seen = {}
    for c in cb.all_assigned():
        for site, m, k, n in AT.matmul_sites(c):
            v = tuned[c.name].assignment[site]
            if (m, k, n, v) not in seen:
                g = torch.Generator(device=device).manual_seed(seed)
                x = torch.randn(m, k, generator=g, device=device, dtype=cost.dtype)
                y = torch.randn(k, n, generator=g, device=device, dtype=cost.dtype)
                lib = time_callable(torch.matmul, x, y, repeats=AT.GEMM_REPEATS,
                                    warmup=AT.GEMM_WARMUP, device=device).device
                want = matmul_plain(x, y, out_dtype=torch.float32)
                got = matmul_op(x, y, v, out_dtype=torch.float32)
                rel = float((got - want).abs().max() / want.abs().max())
                assert rel <= KERNEL_TOL["rtol"], (c.name, site, v, rel)
                seen[(m, k, n, v)] = (lib, rel)
                del x, y, want, got
            lib, rel = seen[(m, k, n, v)]
            ms = cost(m, k, n, v) * 1e3
            route = "/".join(sorted(site_routes[(m, k, n)]))
            print(f"  {c.name} {site} {m} {k} {n} | {v} {route} {ms:.4f} | "
                  f"{lib * 1e3:.4f} | {rel:.3g}")
            out["autotune"]["sites_ms"].append(
                {"arch": c.name, "site": site, "M": m, "K": k, "N": n, "variant": v,
                 "route": route, "ms": ms, "torch_matmul_ms": lib * 1e3,
                 "rel_err": rel})
    torch.cuda.empty_cache()
    # row 1's bf16 pass: one layer of LM_ARCH's GEMM sites run through
    # matmul_op under the chosen variants, on bf16 operands as the autotune
    # timed them; each of its signatures is one the autotune launched
    lm_cfg = next(c for c in cb.all_assigned() if c.name == LM_ARCH)
    site_path = f"autotune bf16 {LM_ARCH} one layer's sites"

    def one_layer():
        g = torch.Generator(device=device).manual_seed(seed)
        for site, m, k, n in AT.matmul_sites(lm_cfg):
            x = torch.randn(m, k, generator=g, device=device, dtype=cost.dtype)
            y = torch.randn(k, n, generator=g, device=device, dtype=cost.dtype)
            matmul_op(x, y, tuned[LM_ARCH].assignment[site])

    run(site_path, one_layer, kernels=("matmul",))
    check_path_dtype(site_path, "bfloat16")
    site_pass = dict(common.SEEN["matmul"])
    assert set(site_pass) <= autotune_seen, set(site_pass) - autotune_seen
    print(f"autotune (b) {site_path}: {sum(site_pass.values())} launches, by "
          f"dtype and route {PATH_ROUTES[site_path]['matmul']}", flush=True)
    assert PATH_ROUTES[site_path]["matmul"] == {"bfloat16": {"wgmma": len(
        AT.matmul_sites(lm_cfg))}}, PATH_ROUTES[site_path]
    torch.cuda.empty_cache()

    # (c) the single-card memory table (meta tensors, no card work)
    with tempfile.TemporaryDirectory(prefix="chip_smoke.dryrun.") as td:
        (_, s) = run("dryrun", lambda: dryrun.main(["--all", "--out", td]))
        out["dryrun"] = {f.stem: json.loads(f.read_text())["memory"]
                         for f in sorted(Path(td).glob("*.json"))
                         if json.loads(f.read_text())["status"] == "ok"}
    assert not any(launches["dryrun"].values())
    print(f"dryrun (c): {len(out['dryrun'])} cells in {s:.1f} s", flush=True)

    out["seconds"] = time.perf_counter() - t_phase
    paths = ("example quickstart", "example transfer", "example transfer warm",
             "example serve", "example train_lm", "autotune bf16", site_path,
             "dryrun")
    print("phase 14 launches: " + json.dumps({p: launches[p] for p in paths}))
    print(f"examples: phase 14 took {out['seconds']:.1f} s  ({smi})", flush=True)
    return out, {site_path: site_pass}


def predictions_card_vs_cpu(torch, models, smi) -> dict:
    """The card's predictions against the CPU's over the arm 60-triplet
    primitive pool and the DLT pool (NaN pattern equal, rtol ``PRED_TOL``),
    and each model's forward on the card: device ms between CUDA events
    (the MLP on the pool's normalised features, mean of 20) and host ms of
    one whole ``predict`` (normalise, upload, forward, download)."""
    from repro_torch.core.perfmodel import mlp_apply, plain_fp32
    from repro_torch.profiler.dataset import (simulate_dlt_dataset,
                                              simulate_primitive_dataset)
    pools = {"prim": simulate_primitive_dataset("arm", max_triplets=60).feats,
             "dlt": simulate_dlt_dataset("arm").feats}
    out = {}
    for role, feats in pools.items():
        card, host = (getattr(models[d], role) for d in ("cuda", "cpu"))
        got, want = card.predict(feats), host.predict(feats)
        assert np.array_equal(np.isnan(got), np.isnan(want)), role
        np.testing.assert_allclose(got, want, **PRED_TOL)
        fin = np.isfinite(want)
        rel = float(np.max(np.abs(got[fin] - want[fin]) / want[fin]))
        xt = torch.from_numpy(card.in_norm.transform(feats)).cuda()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.no_grad(), plain_fp32():
            mlp_apply(card.params, xt)
            start.record()
            for _ in range(20):
                mlp_apply(card.params, xt)
            end.record()
            end.synchronize()
        t0 = time.perf_counter()
        card.predict(feats)
        host_ms = (time.perf_counter() - t0) * 1e3
        out[role] = {"shape": list(got.shape), "max_rel_err": rel,
                     "forward_ms": start.elapsed_time(end) / 20,
                     "predict_ms": host_ms}
        print(f"select: {role} model ({card.kind}) on {got.shape[0]}x"
              f"{got.shape[1]}: card vs CPU max rel err {rel:.3g}; forward "
              f"{out[role]['forward_ms']!r} ms on the card, whole predict "
              f"{host_ms!r} ms  ({smi})", flush=True)
    return out


# ---------------------------------------------------------------------------
# Entry points (phase 5)
# ---------------------------------------------------------------------------

def conv_layers(spec):
    """(name, C, H, K, f, s) of every conv of ``spec`` in topo order, H the
    actual size of its input in a forward pass at the declared input size
    (the zoo's valid convolutions shrink each stage below its declared size)."""
    from repro_torch.models.cnn_zoo import ConvLayer
    from repro_torch.primitives.plan import producers, spatial_sizes, topo_order
    size, prods = spatial_sizes(spec), producers(spec)
    out = []
    for i in topo_order(spec):
        node = spec.nodes[i]
        if isinstance(node, ConvLayer):
            im = size[prods[i][0]] if prods[i] else node.im
            out.append((node.name, node.c, im, node.k, node.f, node.s))
    return out


def entry_point_paths(net, layers, attention, batch):
    """{path: (kernel, drive, launched)} of phase 5 over ``net``'s conv
    ``layers`` and the ``attention`` shapes; ``drive(torch, device, rng)``
    runs one path through its ``ops`` entry point and returns the largest
    |output - oracle|, having asserted it within tolerance; ``kernel`` is
    the kernel the path is timed for, ``launched`` every kernel it must
    launch (and no other)."""
    wino = [l for l in layers if l[4] == 3 and l[5] == 1]
    winograd = {"winograd_point_gemm", *WINO_TRANSFORMS}
    paths = {
        f"{net} convs as GEMMs, b={batch}": (
            "matmul_batch", lambda t, d, r: drive_matmul_batch(t, d, r, layers, batch),
            {"matmul_batch"}),
        f"{net} convs, 1 image": (
            "conv_im2col", lambda t, d, r: drive_conv_im2col(t, d, r, layers),
            {"conv_im2col"}),
        f"{net} 3x3 s1, 1 image, F(2x2) winograd_conv_op": (
            "winograd_point_gemm", lambda t, d, r: drive_winograd(t, d, r, wino, 2),
            winograd),
        f"{net} 3x3 s1, 1 image, F(4x4) winograd_conv": (
            "winograd_point_gemm", lambda t, d, r: drive_winograd(t, d, r, wino, 4),
            winograd),
    }
    for name, cfg in attention.items():
        paths[f"{name} S={cfg['seq']} B=1"] = (
            "flash_attention", lambda t, d, r, cfg=cfg: drive_attention(t, d, r, **cfg),
            {"flash_attention"})
    return paths


def bf16_entry_paths(net, layers, attention, batch):
    """The bf16 passes of phase 5, as ``entry_point_paths`` gives them, every
    operand bf16: over ``net``'s conv ``layers`` the batched matmul, the
    implicit-GEMM conv on one image and on ``batch``, the Winograd
    point-GEMM of each 3x3 stride-1 layer on one image and on ``batch``
    (F(2x2), its U and V made by the weight and input transforms in fp32,
    then rounded once to bf16); flash attention on the ``attention``
    shapes."""
    wino = [l for l in layers if l[4] == 3 and l[5] == 1]
    paths = {
        f"{net} convs as GEMMs, b={batch} bf16": (
            "matmul_batch",
            lambda t, d, r: drive_matmul_batch(t, d, r, layers, batch, bf16=True),
            {"matmul_batch"}),
        f"{net} convs, 1 image bf16": (
            "conv_im2col",
            lambda t, d, r: drive_conv_im2col(t, d, r, layers, bf16=True),
            {"conv_im2col"}),
        f"{net} convs, b={batch} bf16": (
            "conv_im2col_batch",
            lambda t, d, r: drive_conv_im2col(t, d, r, layers, batch, bf16=True),
            {"conv_im2col_batch"}),
        f"{net} 3x3 s1 point-GEMMs, 1 image, F(2x2) bf16": (
            "winograd_point_gemm",
            lambda t, d, r: drive_point_gemm(t, d, r, wino),
            {"winograd_point_gemm", "winograd_input_transform"}),
        f"{net} 3x3 s1 point-GEMMs, b={batch}, F(2x2) bf16": (
            "winograd_point_gemm_batch",
            lambda t, d, r: drive_point_gemm(t, d, r, wino, batch),
            {"winograd_point_gemm_batch", "winograd_input_transform"}),
    }
    for name, cfg in attention.items():
        paths[f"{name} S={cfg['seq']} B=1 bf16"] = (
            "flash_attention",
            lambda t, d, r, cfg=cfg: drive_attention(t, d, r, bf16=True, **cfg),
            {"flash_attention"})
    return paths


# path -> {kernel: {operand dtype: launches}} of each path's run (``took``)
PATH_DTYPES: dict = {}
# path -> {routed kernel: {operand dtype: {route: launches}}} (``took``)
PATH_ROUTES: dict = {}
# path -> {(operand dtype, head dim, route): launches} of flash attention
PATH_FLASH: dict = {}
# path -> {(conv kernel, operand dtype, output channels, route): launches}
PATH_CONV: dict = {}
# path -> {(point-GEMM kernel, operand dtype, K, C, T, images, route): launches}
PATH_WINO: dict = {}
# path -> {(matmul kernel, operand dtype, M, route, loaders): launches}
PATH_MM: dict = {}
# the kernels with an mma.sync and a wgmma route, and each route's source
ROUTE_SOURCES = {
    "matmul": {"mma.sync": "src/repro_torch/csrc/matmul.cu",
               "wgmma": "src/repro_torch/csrc/matmul_wgmma.cu"},
    "conv_im2col": {"mma.sync": "src/repro_torch/csrc/im2col_gemm.cu",
                    "wgmma": "src/repro_torch/csrc/conv_wgmma.cu"},
    "winograd_point_gemm": {"mma.sync": "src/repro_torch/csrc/winograd.cu",
                            "wgmma": "src/repro_torch/csrc/winograd_wgmma.cu"},
    "flash_attention": {"mma.sync": "src/repro_torch/csrc/flash_attention.cu",
                        "wgmma": "src/repro_torch/csrc/flash_wgmma.cu"}}
ROUTE_SOURCES["matmul_batch"] = ROUTE_SOURCES["matmul"]
ROUTE_SOURCES["conv_im2col_batch"] = ROUTE_SOURCES["conv_im2col"]
ROUTE_SOURCES["winograd_point_gemm_batch"] = ROUTE_SOURCES["winograd_point_gemm"]
ROUTED = tuple(ROUTE_SOURCES)
CONVS = ("conv_im2col", "conv_im2col_batch")
WINOS = ("winograd_point_gemm", "winograd_point_gemm_batch")


def sig_dtype(kernel: str, sig) -> str:
    """The operand dtype of one launch signature of ``kernel``: the field
    before the output dtype for the matmul kernels, the last field for the
    other kernels that take bf16 (the convs, the point-GEMMs, flash
    attention), fp32 for the kernels that take nothing else (the Winograd
    transforms)."""
    from repro_torch.kernels.common import DTYPES
    if kernel not in DTYPES:
        return "float32"
    return sig[-2] if kernel in ("matmul", "matmul_batch") else sig[-1]


def sig_route(kernel: str, sig) -> str:
    """The route of a launch signature of a kernel in ``ROUTED``: for the
    matmul kernels the field before the stages, the loaders and the dtypes,
    for the convs and the point-GEMMs the field before the dtype, for flash
    attention the field before the scale and the dtype."""
    if kernel in ("matmul", "matmul_batch"):
        return sig[-5]
    return sig[-3] if kernel == "flash_attention" else sig[-2]


def sig_loaders(sig) -> str:
    """How a matmul launch loaded its operands (``matmul.loaders``: "a/b",
    each "tma" or "gather"), None on mma.sync: the field before the
    dtypes."""
    return sig[-3]


def mm_route_of(dtype: str, M: int) -> str:
    """The route every main-path matmul launch must take (``matmul/ops.
    route``): wgmma for bf16 with at least 64 rows of A, whatever the
    operands' alignment, else mma.sync."""
    return "wgmma" if dtype == "bfloat16" and M >= 64 else "mma.sync"


def conv_route_of(dtype: str, K: int) -> str:
    """The route every main-path conv launch must take (``im2col_gemm.ops.
    route``): wgmma for bf16 with at least ``WGMMA_MIN_K`` output channels,
    else mma.sync."""
    from repro_torch.kernels.im2col_gemm.im2col_gemm import WGMMA_MIN_K
    return "wgmma" if dtype == "bfloat16" and K >= WGMMA_MIN_K else "mma.sync"


def wino_takes(dtype: str, K: int, C: int) -> bool:
    """Whether the wgmma route can take a point-GEMM launch on the
    allocator-aligned U the paths give it (``winograd.takes_wgmma``): bf16
    with at least ``WGMMA_MIN_K`` output channels and C % 8 == 0."""
    from repro_torch.kernels.winograd.winograd import WGMMA_MIN_K
    return dtype == "bfloat16" and K >= WGMMA_MIN_K and C % 8 == 0


def wino_route_of(dtype: str, K: int, C: int, T: int, images: int) -> str:
    """The route every main-path point-GEMM launch of ``images`` images
    must take (``winograd/ops.route``): wgmma where ``wino_takes`` and the
    call has at least ``WGMMA_MIN_COLS`` output columns (``ops.columns``),
    else mma.sync."""
    from repro_torch.kernels.winograd.ops import columns
    from repro_torch.kernels.winograd.winograd import WGMMA_MIN_COLS
    wide = columns(T, images)[0] >= WGMMA_MIN_COLS
    return "wgmma" if wide and wino_takes(dtype, K, C) else "mma.sync"


def sig_conv_k(kernel: str, sig) -> int:
    """The output channels of a conv launch signature: (N,) C, H, W, K."""
    return sig[4] if kernel == "conv_im2col_batch" else sig[3]


def flash_route_of(dtype: str, d: int) -> str:
    """The route every main-path flash launch must take (``flash_attention.
    route`` on the contiguous, allocator-aligned operands the paths give
    it): wgmma for bf16 at the head dims it instantiates, else mma.sync."""
    from repro_torch.kernels.flash_attention.flash_attention import WGMMA_HEAD_DIMS
    return "wgmma" if dtype == "bfloat16" and d in WGMMA_HEAD_DIMS else "mma.sync"


def took(path: str) -> dict:
    """Read the launch counters after ``path`` ran (zeroed just before it):
    its launches per kernel, returned, and per kernel and operand dtype,
    from the launch signatures, kept in ``PATH_DTYPES[path]``; the routed
    kernels' launches per dtype and route in ``PATH_ROUTES[path]``, flash
    attention's per dtype, head dim and route in ``PATH_FLASH[path]``, the
    convs' per kernel, dtype, output channels and route in
    ``PATH_CONV[path]``, and the point-GEMMs' per kernel, dtype, K, C, T,
    images and route in ``PATH_WINO[path]``."""
    from repro_torch.kernels import common
    launches, seen = common.snapshot()
    by_dtype = {k: {} for k in common.KERNELS}
    by_route = {k: {} for k in ROUTED}
    flash, conv, wino, mm = {}, {}, {}, {}
    for k, counts in seen.items():
        for sig, n in counts.items():
            dt = sig_dtype(k, sig)
            by_dtype[k][dt] = by_dtype[k].get(dt, 0) + n
            if k in ROUTED:
                routes = by_route[k].setdefault(dt, {})
                routes[sig_route(k, sig)] = routes.get(sig_route(k, sig), 0) + n
            if k == "flash_attention":
                key = (dt, sig[3], sig_route(k, sig))
                flash[key] = flash.get(key, 0) + n
            if k in CONVS:
                key = (k, dt, sig_conv_k(k, sig), sig_route(k, sig))
                conv[key] = conv.get(key, 0) + n
            if k in WINOS:                     # (N,) P, K, C, T, ...
                images = sig[0] if k == "winograd_point_gemm_batch" else 1
                key = (k, dt, sig[-9], sig[-8], sig[-7], images, sig_route(k, sig))
                wino[key] = wino.get(key, 0) + n
            if k in ("matmul", "matmul_batch"):     # (B,) M, K, N, ...
                key = (k, dt, sig[1 if k == "matmul_batch" else 0],
                       sig_route(k, sig), sig_loaders(sig))
                mm[key] = mm.get(key, 0) + n
    PATH_DTYPES[path] = by_dtype
    PATH_ROUTES[path] = by_route
    PATH_FLASH[path] = flash
    PATH_CONV[path] = conv
    PATH_WINO[path] = wino
    PATH_MM[path] = mm
    return launches


def check_path_dtype(path: str, dtype: str) -> None:
    """Every launch of ``path`` (read by ``took``) ran on ``dtype`` operands
    where its kernel takes more than fp32, every flash attention launch on
    its route (``flash_route_of``): each bf16 launch at d = 64 or 128 on the
    wgmma kernel, every conv launch on its route (``conv_route_of``):
    each bf16 launch of at least 64 output channels on the wgmma kernel,
    every point-GEMM launch on its route (``wino_route_of``), and every
    matmul launch on its route (``mm_route_of``: each bf16 launch of at
    least 64 rows on the wgmma kernel, whatever its loaders)."""
    from repro_torch.kernels.common import DTYPES
    for k in DTYPES:
        got = set(PATH_DTYPES[path][k])
        assert got <= {dtype}, (path, k, got)
    wrong = {key: n for key, n in PATH_FLASH[path].items()
             if key[2] != flash_route_of(*key[:2])}
    assert not wrong, (path, "flash attention off its route", wrong)
    wrong = {key: n for key, n in PATH_CONV[path].items()
             if key[3] != conv_route_of(*key[1:3])}
    assert not wrong, (path, "conv off its route", wrong)
    wrong = {key: n for key, n in PATH_WINO[path].items()
             if key[6] != wino_route_of(*key[1:6])}
    assert not wrong, (path, "point-GEMM off its route", wrong)
    wrong = {key: n for key, n in PATH_MM[path].items()
             if key[3] != mm_route_of(*key[1:3])}
    assert not wrong, (path, "matmul off its route", wrong)


def mm_loaders(path: str, kernel: str) -> dict:
    """{loaders: launches} of ``kernel``'s wgmma launches on ``path``."""
    out = {}
    for (k, _, _, rt, how), n in PATH_MM[path].items():
        if k == kernel and rt == "wgmma":
            out[how] = out.get(how, 0) + n
    return out


def _rand(torch, rng, device, *shape, scale=1.0):
    """Seeded numpy normals on ``device``, as float32."""
    a = rng.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(a * np.float32(scale)).to(device)


def _hold(torch, got, want, tol) -> float:
    assert got.shape == want.shape and torch.isfinite(got).all(), got.shape
    torch.testing.assert_close(got, want, **tol)
    return float((got - want).abs().max())


def hold_bf16(torch, got, want32, atol, rows=False) -> float:
    """Hold a bf16 output ``got`` to ``want32``, the fp32 result on the same
    values: within one bf16 rounding of it (``BF16_RTOL`` of |want32|: half
    an ulp) plus ``atol`` of the largest |want32| (of its row, the last
    dim, with ``rows``: attention, whose rows' scales differ under a causal
    mask) for the order of the fp32 sums. A result off by more than its
    own rounding fails: P fed to P V as one bf16 part (2^-9 of each weight,
    about 2^-11 of the row's scale), a key block dropped, a row mis-masked.
    Returns the largest |got - want32|."""
    assert got.dtype == torch.bfloat16 and got.shape == want32.shape, (
        got.dtype, got.shape, want32.shape)
    assert torch.isfinite(got).all()
    mag = want32.abs()
    scale = mag.amax(-1, keepdim=True) if rows else mag.max()
    err = (got.float() - want32).abs()
    over = err - (BF16_RTOL * mag + atol * scale)
    worst = int(over.argmax())
    assert over.max() <= 0, (
        f"bf16 output off its fp32 result by more than one rounding: "
        f"{int((over > 0).sum())} of {over.numel()} elements, worst "
        f"|err| {float(err.flatten()[worst]):.3g} at |want| "
        f"{float(mag.flatten()[worst]):.3g}")
    return float(err.max())


def _epilogue(y, bias, residual, channel_axis):
    """bias -> residual -> ReLU, in the oracle."""
    shape = [1] * y.dim()
    shape[channel_axis] = -1
    return (y + bias.reshape(shape) + residual).clamp_min(0.0)


def drive_matmul_batch(torch, device, rng, layers, batch, bf16=False) -> float:
    """Each conv as ``batch`` per-image GEMMs through ``matmul_batch_op``:
    x = the (K, C*f*f) weights broadcast over the batch (stride 0), y = the
    unfolded (C*f*f, oh*ow) patches of each image, bias (K,) and residual
    (batch, K, oh*ow) fused, ReLU; with ``bf16`` every operand in bf16 and
    the output bf16 (the operands' dtype). Oracle: ``F.conv2d`` + the
    epilogue in fp32 on the same values, a bf16 output held by
    ``hold_bf16`` (``ORACLE_TOL`` for the fp32 part)."""
    import torch.nn.functional as F
    from repro_torch.kernels.matmul.ops import matmul_batch_op
    worst = 0.0
    for _, C, H, K, f, s in layers:
        oh = (H - f) // s + 1
        x = _rand(torch, rng, device, batch, C, H, H)
        w = _rand(torch, rng, device, K, C, f, f, scale=(C * f * f) ** -0.5)
        b, r = _rand(torch, rng, device, K), _rand(torch, rng, device, batch, K, oh * oh)
        if bf16:
            x, w, b, r = (t.bfloat16() for t in (x, w, b, r))
        cols = F.unfold(x, f, stride=s)                      # (batch, C*f*f, oh*ow)
        wm = w.reshape(K, -1)
        y = matmul_batch_op(wm.expand(batch, *wm.shape), cols, bias=b,
                            residual=r, relu=True)
        assert y.dtype == x.dtype
        want = _epilogue(F.conv2d(x.float(), w.float(), stride=s), b.float(),
                         r.float().reshape(batch, K, oh, oh), 1)
        y = y.reshape(want.shape)
        worst = max(worst, hold_bf16(torch, y, want, ORACLE_TOL["atol"]) if bf16
                    else _hold(torch, y, want, ORACLE_TOL))
    return worst


def drive_conv_im2col(torch, device, rng, layers, batch=None,
                      bf16=False) -> float:
    """Each conv on one image through ``conv_im2col_op`` or, with ``batch``,
    on ``batch`` images through ``conv_im2col_batch_op``, bias (K,) and
    residual fused, ReLU; with ``bf16`` every operand in bf16 and the output
    bf16 (x's dtype). Oracle: ``F.conv2d`` + the epilogue in fp32 on the
    same values, a bf16 output held by ``hold_bf16`` (``ORACLE_TOL`` for
    the fp32 part)."""
    import torch.nn.functional as F
    from repro_torch.kernels.im2col_gemm.ops import conv_im2col_batch_op, conv_im2col_op
    lead = () if batch is None else (batch,)
    op = conv_im2col_op if batch is None else conv_im2col_batch_op
    worst = 0.0
    for _, C, H, K, f, s in layers:
        oh = (H - f) // s + 1
        x = _rand(torch, rng, device, *lead, C, H, H)
        w = _rand(torch, rng, device, K, C, f, f, scale=(C * f * f) ** -0.5)
        b, r = _rand(torch, rng, device, K), _rand(torch, rng, device, *lead, K, oh, oh)
        if bf16:
            x, w, b, r = (t.bfloat16() for t in (x, w, b, r))
        y = op(x, w, s, bias=b, residual=r, relu=True)
        assert y.dtype == x.dtype
        xb = x.float() if batch else x.float()[None]
        want = F.conv2d(xb, w.float(), stride=s)
        want = _epilogue(want if batch else want[0], b.float(), r.float(), len(lead))
        worst = max(worst, hold_bf16(torch, y, want, ORACLE_TOL["atol"]) if bf16
                    else _hold(torch, y, want, ORACLE_TOL))
    return worst


def drive_point_gemm(torch, device, rng, layers, batch=None) -> float:
    """The F(2x2) point-GEMMs of each 3x3 stride-1 conv, in bf16, through
    ``winograd_point_gemm`` on one image or, with ``batch``,
    ``winograd_point_gemm_batch`` on ``batch`` images, under
    ``wino-128x128``'s bf16 plan for the call's route (``ops.plan``: 13 of
    resnet18's 13 on wgmma at b=8, 11 on one image): U and V from the
    port's weight transform
    and input transform kernel (fp32), rounded once to bf16. Oracle: the
    fp32 product of the same bf16 values, the output held by ``hold_bf16``
    (``KERNEL_TOL`` for the fp32 part)."""
    from repro_torch.kernels.winograd.ops import plan, weight_transform
    from repro_torch.kernels.winograd.winograd import (winograd_input_transform,
                                                       winograd_point_gemm,
                                                       winograd_point_gemm_batch)
    worst = 0.0
    for _, C, H, K, _, _ in layers:
        x = _rand(torch, rng, device, batch or 1, C, H, H)
        w = _rand(torch, rng, device, K, C, 3, 3, scale=(C * 9) ** -0.5)
        u = weight_transform(w, 2).bfloat16()                    # (16, K, C)
        v = winograd_input_transform(x, 2).bfloat16()            # (N, 16, C, T)
        if batch is None:
            v = v[0]
        fn = winograd_point_gemm if batch is None else winograd_point_gemm_batch
        y = fn(u, v, **plan(u, v, "wino-128x128"))
        worst = max(worst, hold_bf16(torch, y, torch.matmul(u.float(), v.float()),
                                     KERNEL_TOL["atol"]))
    return worst


def drive_winograd(torch, device, rng, layers, m) -> float:
    """Each 3x3 stride-1 conv on one image: ``winograd_conv_op`` (F(2x2),
    the reference op, no epilogue) at m = 2, ``winograd_conv(m=4)`` with
    bias, residual and ReLU at m = 4. Oracle: ``conv3x3_ref`` (+ epilogue)."""
    from repro_torch.kernels.winograd.ops import winograd_conv, winograd_conv_op
    from repro_torch.kernels.winograd.ref import conv3x3_ref
    worst = 0.0
    for _, C, H, K, _, _ in layers:
        x = _rand(torch, rng, device, C, H, H)
        w = _rand(torch, rng, device, K, C, 3, 3, scale=(C * 9) ** -0.5)
        if m == 2:
            y, want = winograd_conv_op(x, w), conv3x3_ref(x, w)
        else:
            b, r = _rand(torch, rng, device, K), _rand(torch, rng, device, K, H - 2, H - 2)
            y = winograd_conv(x, w, m=m, bias=b, residual=r, relu=True)
            want = _epilogue(conv3x3_ref(x, w), b, r, 0)
        worst = max(worst, _hold(torch, y, want, ORACLE_TOL))
    return worst


def drive_attention(torch, device, rng, *, heads, kv_heads, head_dim, seq,
                    causal, bf16=False) -> float:
    """One (1, seq, heads, head_dim) GQA attention through
    ``flash_attention_op``, with ``bf16`` on bf16 q, k, v (a bf16 output).
    Oracle: in fp32 on the same values, each query head against its KV head
    (h // (heads / kv_heads)) with the full score matrix, -inf above the
    diagonal when causal, softmax, times V; a bf16 output held by
    ``hold_bf16`` row by row (``KERNEL_TOL`` for the fp32 part)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    q = _rand(torch, rng, device, 1, seq, heads, head_dim)
    k = _rand(torch, rng, device, 1, seq, kv_heads, head_dim)
    v = _rand(torch, rng, device, 1, seq, kv_heads, head_dim)
    if bf16:
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out = flash_attention_op(q, k, v, causal=causal)
    assert out.dtype == q.dtype
    kv_of = torch.arange(heads, device=device) // (heads // kv_heads)
    qh, kh, vh = (t[0].transpose(0, 1).float() for t in (q, k, v))   # (H, S, d)
    s = torch.einsum("hqd,hkd->hqk", qh, kh[kv_of]) * head_dim ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(seq, seq, dtype=torch.bool,
                                     device=device).triu(1), float("-inf"))
    want = (torch.softmax(s, -1) @ vh[kv_of]).transpose(0, 1)[None]
    del s
    if bf16:
        return hold_bf16(torch, out, want, KERNEL_TOL["atol"], rows=True)
    return _hold(torch, out, want, KERNEL_TOL)


# ---------------------------------------------------------------------------
# Kernels against their plain versions, and their times
# ---------------------------------------------------------------------------

def kernel_table(torch):
    """Per kernel: source, replaced TPU kernel, the wrapper / plain / library
    callables over one signature's operands, and the signature's work."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        TILES as FA_TILES, WGMMA_TILES as FA_WGMMA_TILES, flash_attention,
        flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import cta_tile as fa_cta_tile
    from repro_torch.kernels.flash_attention.ops import wgmma_tile as fa_wgmma_tile
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.im2col_gemm.im2col_gemm import (
        conv_im2col, conv_im2col_batch, conv_im2col_batch_plain,
        conv_im2col_plain)
    from repro_torch.kernels.im2col_gemm.ops import VARIANTS as CONV_VARIANTS
    from repro_torch.kernels.im2col_gemm.ops import cta_plan as conv_plan
    from repro_torch.kernels.im2col_gemm.ops import wgmma_plan as conv_wgmma_plan
    from repro_torch.kernels.im2col_gemm.ref import conv_ref
    from repro_torch.kernels.matmul.matmul import (MMA_STAGES, loaders,
                                                   matmul, matmul_batch,
                                                   matmul_batch_plain,
                                                   matmul_plain, packs)
    from repro_torch.kernels.matmul.ops import VARIANTS as MM_VARIANTS
    from repro_torch.kernels.matmul.ops import cta_plan, wgmma_plan
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.winograd.ops import VARIANTS as WINO_VARIANTS
    from repro_torch.kernels.winograd.ops import cta_plan as wino_plan
    from repro_torch.kernels.winograd.ops import wgmma_plan as wino_wgmma_plan
    from repro_torch.kernels.winograd.ref import point_gemm_ref
    from repro_torch.kernels.winograd.winograd import (
        WGMMA_BK, tiles_of, winograd_input_transform, winograd_input_transform_plain,
        winograd_inverse_transform, winograd_inverse_transform_plain,
        winograd_point_gemm, winograd_point_gemm_batch,
        winograd_point_gemm_batch_plain, winograd_point_gemm_plain)
    from repro_torch.primitives.conv import _WINO_SETS

    def rnd(*shape, scale=1.0, dtype="float32"):
        return (torch.randn(*shape, device="cuda") * scale).to(getattr(torch, dtype))

    def isz(dtype):
        return getattr(torch, dtype).itemsize

    def tc_rate(dtype):
        """Peak rate of a tensor-core kernel on operands of ``dtype``: bf16
        mma, or fp32 as 3xTF32."""
        return BF16_FLOPS if dtype == "bfloat16" else TF32_FLOPS / 3

    def mm_loaders_of(M, K, N, batch, x_bcast):
        """(loaders, packed) of a wgmma call on the fresh, contiguous
        operands ``mm_ops`` / ``mmb_ops`` make: ``matmul.loaders`` and
        ``matmul.packs`` on meta tensors of their shapes (address 0, so
        16-byte aligned as an allocation is)."""
        meta = dict(dtype=torch.bfloat16, device="meta")
        lead = (batch,) if batch > 1 else ()
        x = (torch.empty(M, K, **meta).expand(batch, M, K) if x_bcast and lead
             else torch.empty(*lead, M, K, **meta))
        y = torch.empty(*lead, K, N, **meta)
        how = loaders(x, y)
        return how, packs(x, y, how)

    def mm_plans(M, K, N, batch, dtype, x_bcast=False):
        """(bm, bk, bn, split_k, route, stages, loaders) of every variant's
        plan at one shape on the mma.sync route and, where the shape takes
        it (bf16, M >= 64), on the wgmma route under the operands'
        loaders."""
        plans = [(bm, bk, bn, split, "mma.sync", MMA_STAGES, None) for bm, bn, bk, split
                 in (cta_plan(M, N, K, batch, v, getattr(torch, dtype))
                     for v in MM_VARIANTS)]
        if mm_route_of(dtype, M) == "wgmma":
            how, packed = mm_loaders_of(M, K, N, batch, x_bcast)
            plans += [(bm, bk, bn, split, "wgmma", st, how) for bm, bn, bk, st, split
                      in (wgmma_plan(M, N, K, batch, v, how, packed)
                          for v in MM_VARIANTS)]
        return list(dict.fromkeys(plans))

    def mm_eps(dt):
        """The epilogue combinations of a matmul signature: bias and
        residual absent (False) or of the operands' dtype, ReLU or not."""
        return list(itertools.product((False, dt), (False, dt), (False, True)))

    def mm_ops(sig):
        """(kernel, plain version, library call, plain version in fp32):
        the last is the fp32 result a bf16 output is held to."""
        M, K, N, bm, bk, bn, split, hb, hr, relu, route, stages, how, dt, odt = sig
        x, y = rnd(M, K, scale=K ** -0.5, dtype=dt), rnd(K, N, dtype=dt)
        assert route != "wgmma" or loaders(x, y) == how, (sig, loaders(x, y))
        ep = dict(bias=rnd(M, dtype=hb) if hb else None,
                  residual=rnd(M, N, dtype=hr) if hr else None, relu=relu)
        out = getattr(torch, odt)
        return (lambda: matmul(x, y, bm=bm, bk=bk, bn=bn, split_k=split,
                               out_dtype=out, route=route, stages=stages, **ep),
                lambda: matmul_plain(x, y, out_dtype=out, **ep),
                lambda: matmul_ref(x, y),
                lambda: matmul_plain(x, y, out_dtype=torch.float32, **ep))

    def ep_bytes(t, n):
        """Bytes of an epilogue tensor of ``n`` elements: ``t`` its dtype
        name, or False where the call has none."""
        return isz(t) * n if t else 0

    def mm_work(sig):
        (M, K, N), (hb, hr, relu), (dt, odt) = sig[:3], sig[7:10], sig[-2:]
        return (2 * M * K * N + M * N * (bool(hb) + bool(hr) + relu),
                isz(dt) * (M * K + K * N) + ep_bytes(hr, M * N) + ep_bytes(hb, M)
                + isz(odt) * M * N)

    def conv_plans(N, C, H, W, K, f, s, dtype):
        """(bm, bk, bn, split_k, route) of every variant's plan at one conv
        on operands of ``dtype`` on the mma.sync route and, where the conv
        takes it (bf16, K >= 64), on the wgmma route."""
        P, R = N * ((H - f) // s + 1) * ((W - f) // s + 1), C * f * f
        plans = [(bm, bk, bn, split, "mma.sync") for bm, bn, bk, split
                 in (conv_plan(K, P, R, v, getattr(torch, dtype))
                     for v in CONV_VARIANTS)]
        if conv_route_of(dtype, K) == "wgmma":
            plans += [(bm, bk, bn, split, "wgmma") for bm, bn, bk, split
                      in (conv_wgmma_plan(K, P, R, v) for v in CONV_VARIANTS)]
        return list(dict.fromkeys(plans))

    def f32(t):
        return None if t is None else t.float()

    def conv_ops(sig):
        """(kernel, plain version, library call, plain version in fp32) of a
        batched conv signature; one image (``conv_im2col``'s signature) where
        it has no N."""
        one = len(sig) == 15
        N, C, H, W, K, f, s, bm, bk, bn, split, hb, hr, relu, route, dt = (
            (1, *sig) if one else sig)
        oh, ow = (H - f) // s + 1, (W - f) // s + 1
        lead = () if one else (N,)
        x = rnd(*lead, C, H, W, dtype=dt)
        w = rnd(K, C, f, f, scale=(C * f * f) ** -0.5, dtype=dt)
        ep = dict(bias=rnd(K, dtype=hb) if hb else None,
                  residual=rnd(*lead, K, oh, ow, dtype=hr) if hr else None,
                  relu=relu)
        ep32 = dict(bias=f32(ep["bias"]), residual=f32(ep["residual"]), relu=relu)
        kern, plain = ((conv_im2col, conv_im2col_plain) if one
                       else (conv_im2col_batch, conv_im2col_batch_plain))
        return (lambda: kern(x, w, s, bm=bm, bk=bk, bn=bn, split_k=split,
                             route=route, **ep),
                lambda: plain(x, w, s, **ep),
                lambda: conv_ref(x[None] if one else x, w, s),
                lambda: plain(x.float(), w.float(), s, **ep32))

    def conv_work(sig):
        """FLOPs, and bytes at the signature's dtypes counting only the rows
        and columns of x that some window reads (a 1x1 s2 conv reads a
        quarter of x)."""
        N, C, H, W, K, f, s, *_, hb, hr, relu, _, dt = sig
        oh, ow = (H - f) // s + 1, (W - f) // s + 1
        rows, cols = ((o * f if f < s else (o - 1) * s + f) for o in (oh, ow))
        P = N * oh * ow
        return (2 * P * K * C * f * f + P * K * (bool(hb) + bool(hr) + relu),
                isz(dt) * (N * C * rows * cols + K * C * f * f + P * K)
                + ep_bytes(hr, P * K) + ep_bytes(hb, K))

    def wino_plans(K, C, T, batch, dtype, images=1):
        """(bm, bk, bn, split_k, route) of every wino-* and mm-* plan at
        one point-GEMM shape, ``batch`` = ``images`` x points, on operands
        of ``dtype`` on the mma.sync route, and the wgmma route's one plan
        where the shape can take it (``wino_takes``)."""
        plans = [(bm, bk, bn, split, "mma.sync") for bm, bn, bk, split in
                 (wino_plan(K, T, C, batch, v, getattr(torch, dtype))
                  for v in (*WINO_VARIANTS, *MM_VARIANTS))]
        if wino_takes(dtype, K, C):
            bm, bn = wino_wgmma_plan(K, T, batch, images)
            plans.append((bm, WGMMA_BK, bn, 1, "wgmma"))
        return list(dict.fromkeys(plans))

    def wino_ops(sig):
        """(kernel, plain version, library call, plain version in fp32) of a
        batched point-GEMM signature; one image (``winograd_point_gemm``'s
        signature) where it has no N."""
        one = len(sig) == 10
        N, P, K, C, T, bm, bk, bn, split, route, dt = (1, *sig) if one else sig
        u = rnd(P, K, C, scale=C ** -0.5, dtype=dt)
        v = rnd(P, C, T, dtype=dt) if one else rnd(N, P, C, T, dtype=dt)
        kern, plain = ((winograd_point_gemm, winograd_point_gemm_plain) if one
                       else (winograd_point_gemm_batch, winograd_point_gemm_batch_plain))
        return (lambda: kern(u, v, bm=bm, bk=bk, bn=bn, split_k=split,
                             route=route),
                lambda: plain(u, v),
                lambda: point_gemm_ref(u, v),
                lambda: plain(u.float(), v.float()))

    def wino_work(sig):
        N, P, K, C, T = sig[:5]
        return (2 * N * P * K * C * T,
                isz(sig[-1]) * (P * K * C + N * P * C * T + N * P * K * T))

    def mmb_ops(sig):
        (B, M, K, N, x_bcast, y_bcast, bm, bk, bn, split, hb, hr, relu, route,
         stages, how, dt, odt) = sig
        x = (rnd(M, K, scale=K ** -0.5, dtype=dt).expand(B, M, K) if x_bcast
             else rnd(B, M, K, scale=K ** -0.5, dtype=dt))
        y = rnd(K, N, dtype=dt).expand(B, K, N) if y_bcast else rnd(B, K, N, dtype=dt)
        assert route != "wgmma" or loaders(x, y) == how, (sig, loaders(x, y))
        ep = dict(bias=rnd(M, dtype=hb) if hb else None,
                  residual=rnd(B, M, N, dtype=hr) if hr else None, relu=relu)
        out = getattr(torch, odt)
        return (lambda: matmul_batch(x, y, bm=bm, bk=bk, bn=bn, split_k=split,
                                     out_dtype=out, route=route, stages=stages,
                                     **ep),
                lambda: matmul_batch_plain(x, y, out_dtype=out, **ep),
                lambda: matmul_ref(x, y),
                lambda: matmul_batch_plain(x, y, out_dtype=torch.float32, **ep))

    def mmb_work(sig):
        (B, M, K, N, x_bcast, y_bcast), (hb, hr, relu), (dt, odt) = (
            sig[:6], sig[10:13], sig[-2:])
        return (2 * B * M * K * N + B * M * N * (bool(hb) + bool(hr) + relu),
                isz(dt) * ((1 if x_bcast else B) * M * K + (1 if y_bcast else B) * K * N)
                + ep_bytes(hr, B * M * N) + ep_bytes(hb, M) + isz(odt) * B * M * N)

    def nnz(m, which):
        """Nonzero entries of F(mxm, 3x3)'s A^T (0) or B^T (2): the products
        a transform kernel computes per row or column it transforms."""
        return int(np.count_nonzero(_WINO_SETS[(m, 3)][which]))

    def win_ops(sig):
        N, C, H, W, m = sig
        x = rnd(N, C, H, W)
        return (lambda: winograd_input_transform(x, m),
                lambda: winograd_input_transform_plain(x, m), None)

    def win_work(sig):
        """B^T d B per (image, channel, tile): n columns then n rows, each a
        row of B^T's nonzeros; x read once, V written once."""
        N, C, H, W, m = sig
        n, T = m + 2, math.prod(tiles_of(H - 2, W - 2, m))
        return (N * C * T * 4 * n * nnz(m, 2),
                4 * (N * C * H * W + N * n * n * C * T))

    def wout_ops(sig):
        N, K, oh, ow, m, hb, hr, relu = sig
        M = rnd(N, (m + 2) ** 2, K, math.prod(tiles_of(oh, ow, m)))
        ep = dict(bias=rnd(K) if hb else None,
                  residual=rnd(N, K, oh, ow) if hr else None, relu=relu)
        return (lambda: winograd_inverse_transform(M, m, oh, ow, **ep),
                lambda: winograd_inverse_transform_plain(M, m, oh, ow, **ep),
                None)

    def wout_work(sig):
        """A^T M A per (image, channel, tile): n columns, then m rows, each a
        row of A^T's nonzeros, and the epilogue; M read once, y written
        once."""
        N, K, oh, ow, m, hb, hr, relu = sig
        n, T = m + 2, math.prod(tiles_of(oh, ow, m))
        return (N * K * T * 2 * (n + m) * nnz(m, 0)
                + N * K * oh * ow * (hb + hr + relu),
                4 * (N * n * n * K * T + N * K * oh * ow * (1 + hr) + K * hb))

    def fa_q(n, sq, d, scale, dtype):
        """Queries as the caller gives them: unit scores after ``scale``
        (the LM path pre-scales q by 1/sqrt(d) and runs at scale 1)."""
        return rnd(n, sq, d, scale=1.0 / (scale * math.sqrt(d)), dtype=dtype)

    def fa_args(sig):
        """q (bh rows), k and v (bh / rep rows) of a flash signature."""
        bh, sq, sk, d, causal, bq, bkv, r, route, scale, dt = sig
        return (fa_q(bh, sq, d, scale, dt), rnd(bh // r, sk, d, dtype=dt),
                rnd(bh // r, sk, d, dtype=dt))

    def fa_ops(sig):
        """The kernel on its route and tile, the plain version, SDPA (on K
        and V repeated to the query rows beforehand: the fused SDPA kernels
        take equal heads) and the plain version in fp32."""
        bh, sq, sk, d, causal, bq, bkv, r, route, scale, dt = sig
        q, k, v = fa_args(sig)
        kr, vr = (t.repeat_interleave(r, 0) for t in (k, v))
        return (lambda: flash_attention(q, k, v, causal=causal, scale=scale,
                                        bq=bq, bkv=bkv, rep=r, force_route=route),
                lambda: flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                              rep=r),
                lambda: attention_ref(q, kr, vr, causal=causal, scale=scale),
                lambda: flash_attention_plain(q.float(), k.float(), v.float(),
                                              causal=causal, scale=scale, rep=r))

    def fa_tiles(sig):
        """Every (bq, bkv, route) a call of ``sig``'s dtype and head dim can
        take: the mma.sync tiles, and the wgmma tiles at its head dim for
        bf16 at d = 64 or 128."""
        d, dt = sig[3], sig[-1]
        tiles = [(bq, bkv, "mma.sync") for bq, bkv in FA_TILES]
        if flash_route_of(dt, d) == "wgmma":
            tiles += [(bq, bkv, "wgmma") for bq, bkv, dd in FA_WGMMA_TILES if dd == d]
        return tiles

    def fa_routes(sig):
        """{route: signature} of ``sig`` on each route it can take, each
        under ``AB_VARIANT``'s tile for that route (the tile the entry
        point and the LM prefill run): the A/B of the two kernels."""
        d, dt = sig[3], sig[-1]
        tiles = {"mma.sync": fa_cta_tile(AB_VARIANT, d, getattr(torch, dt))}
        if flash_route_of(dt, d) == "wgmma":
            tiles["wgmma"] = fa_wgmma_tile(AB_VARIANT, d)
        return {route: (*sig[:5], *tile, sig[7], route, *sig[9:])
                for route, tile in tiles.items()}

    def fa_exact(sig):
        """One query head (and its KV head) of ``sig``: the kernel's and the
        plain version's largest distance from the float64 result."""
        _, sq, sk, d, causal, bq, bkv, _, route, scale, dt = sig
        q, k, v = fa_q(1, sq, d, scale, dt), rnd(1, sk, d, dtype=dt), rnd(1, sk, d, dtype=dt)
        exact = flash_attention_plain(q.double(), k.double(), v.double(),
                                      causal=causal, scale=scale)
        got = flash_attention(q, k, v, causal=causal, scale=scale, bq=bq, bkv=bkv,
                              force_route=route)
        plain = flash_attention_plain(q, k, v, causal=causal, scale=scale)
        return tuple(float((x.double() - exact).abs().max()) for x in (got, plain))

    def fa_work(sig):
        """Q K^T and P V over the (query, key) pairs the causal mask keeps,
        the work these inputs need (masked pairs need none); q and o of bh
        rows, k and v of bh / rep rows, each moved once."""
        bh, sq, sk, d, causal = sig[:5]
        n = min(sq, sk)
        pairs = n * (n + 1) // 2 + (sq - n) * sk if causal else sq * sk
        return (4 * d * pairs * bh,
                isz(sig[-1]) * d * 2 * (bh * sq + bh // sig[7] * sk))

    eps = list(itertools.product((False, True), repeat=3))
    return {
        "matmul": dict(
            source="src/repro_torch/csrc/matmul.cu",
            replaces="src/repro/kernels/matmul/matmul.py:140",
            ops=mm_ops, work=mm_work, flops_s=lambda s: tc_rate(s[-2]),
            sweep=lambda s: [(*s[:3], *p[:4], *e, *p[4:], *s[-2:])
                             for p in mm_plans(*s[:3], 1, s[-2])
                             for e in mm_eps(s[-2])]),
        "conv_im2col_batch": dict(
            source="src/repro_torch/csrc/im2col_gemm.cu",
            replaces="src/repro/kernels/im2col_gemm/im2col_gemm.py:155",
            ops=conv_ops, work=conv_work, flops_s=lambda s: tc_rate(s[-1]),
            sweep=lambda s: [(*s[:7], *p[:4], *e, *p[4:], s[-1])
                             for p in conv_plans(*s[:7], s[-1])
                             for e in mm_eps(s[-1])]),
        "winograd_point_gemm_batch": dict(
            source="src/repro_torch/csrc/winograd.cu",
            replaces="src/repro/kernels/winograd/winograd.py:77",
            ops=wino_ops, work=wino_work, flops_s=lambda s: tc_rate(s[-1]),
            sweep=lambda s: [(*s[:5], *p, s[-1]) for p in
                             wino_plans(*s[2:5], s[0] * s[1], s[-1], s[0])]),
        "winograd_input_transform": dict(
            source="src/repro_torch/csrc/winograd.cu",
            replaces="src/repro/kernels/winograd/ops.py:97",
            ops=win_ops, work=win_work,
            sweep=lambda s: [(*s[:4], m) for m in (2, 4)]),
        "winograd_inverse_transform": dict(
            source="src/repro_torch/csrc/winograd.cu",
            replaces="src/repro/kernels/winograd/ops.py:106",
            ops=wout_ops, work=wout_work,
            sweep=lambda s: [(*s[:4], m, *e) for m in (2, 4) for e in eps]),
        "matmul_batch": dict(
            source="src/repro_torch/csrc/matmul.cu",
            replaces="src/repro/kernels/matmul/matmul.py:87",
            ops=mmb_ops, work=mmb_work, flops_s=lambda s: tc_rate(s[-2]),
            sweep=lambda s: [(*s[:6], *p[:4], *e, *p[4:], *s[-2:])
                             for p in mm_plans(*s[1:4], s[0], s[-2], s[4])
                             for e in mm_eps(s[-2])]),
        "conv_im2col": dict(
            source="src/repro_torch/csrc/im2col_gemm.cu",
            replaces="src/repro/kernels/im2col_gemm/im2col_gemm.py:76",
            ops=conv_ops, flops_s=lambda s: tc_rate(s[-1]),
            work=lambda s: conv_work((1, *s)),
            sweep=lambda s: [(*s[:6], *p[:4], *e, *p[4:], s[-1])
                             for p in conv_plans(1, *s[:6], s[-1])
                             for e in mm_eps(s[-1])]),
        "winograd_point_gemm": dict(
            source="src/repro_torch/csrc/winograd.cu",
            replaces="src/repro/kernels/winograd/winograd.py:36",
            ops=wino_ops, work=lambda s: wino_work((1, *s)),
            flops_s=lambda s: tc_rate(s[-1]),
            sweep=lambda s: [(*s[:4], *p, s[-1])
                             for p in wino_plans(*s[1:4], s[0], s[-1])]),
        "flash_attention": dict(
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/flash_attention.py:62",
            ops=fa_ops, work=fa_work, flops_s=lambda s: tc_rate(s[-1]), rows=True,
            sweep=lambda s: [(*s[:4], c, bq, bkv, s[7], route, *s[9:])
                             for c in (True, False) for bq, bkv, route in fa_tiles(s)],
            tiles=lambda s: {f"{route} {bq}x{bkv}": (*s[:5], bq, bkv, s[7], route,
                                                    *s[9:])
                             for bq, bkv, route in fa_tiles(s)},
            routes=fa_routes, exact=fa_exact),
    }


def time_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds per call: ``reps`` back-to-back calls
    captured in one CUDA graph, replayed between CUDA events. The replay
    has no host work between launches, so a small kernel is timed by the
    device and not by the Python wrapper's overhead. A call of
    ``LONG_CALL_MS`` or more hides its own launch overhead: it is timed
    eagerly, back to back between CUDA events, as often as fits in
    ``LONG_CALL_BUDGET_MS`` (at least 3, at most ``reps`` times), and its
    large temporaries are never held by a graph's memory pool. Operands
    stay the same across calls (L2-warm where they fit in its 50 MB)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = start.elapsed_time(end)
    if once >= LONG_CALL_MS:
        n = max(3, min(reps, int(LONG_CALL_BUDGET_MS / once)))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up off the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _ms(v) -> str:
    """A time for the report: ``none`` where no library call computes the
    same function."""
    return "none" if v is None else f"{v:.4f}"


def check_and_time(torch, name, seen, passes, reps, ab=False):
    """Hold ``name`` to its plain version at every signature in ``seen`` and
    across the tile/epilogue sweep at the largest of them of each operand
    dtype, and each call to its own repeat, bit for bit (split plans
    included); then, for each path in ``passes`` ({path: {signature:
    launches}} of one run), time that pass's launches — kernel, plain
    version, library call (None where no single PyTorch call computes the
    function) and bound, each summed over the pass. The bound takes the
    operations at the peak rate of the kind the kernel runs at the
    signature's dtype (``flops_s``: 3xTF32 or bf16 on the tensor cores, else
    fp32 outside them) and the bytes at the dtype's size, and, as
    ``bound_fp32_ms``, the operations at the fp32 rate (the same for a
    kernel outside the tensor cores); a tensor-core kernel's pass lists
    every signature with both. An fp32 output is held at ``KERNEL_TOL``
    (from bf16 operands too: the products are exact), a bf16 output to the
    plain version's fp32 result by ``hold_bf16``; the largest |kernel -
    plain| is also kept per operand dtype (``max_abs_err_by_dtype``). For a
    routed kernel with a ``routes`` entry (flash attention): with ``ab``,
    each pass is also timed on both routes in turns (mma.sync, wgmma,
    wgmma, mma.sync) where its signatures take both; every per-tile time
    comes with the tile's output held as above; and the distance from
    float64 is printed for each route at the largest signature."""
    from repro_torch.kernels import common
    spec = kernel_table(torch)[name]
    rate = spec.get("flops_s", FP32_FLOPS)
    flops_s = rate if callable(rate) else (lambda sig: rate)
    tc = "flops_s" in spec
    assert seen, f"{name}: the served paths gave it no launch"
    largest = {}                     # operand dtype -> its largest signature
    for sig in seen:
        dt = sig_dtype(name, sig)
        if dt not in largest or spec["work"](sig)[0] > spec["work"](largest[dt])[0]:
            largest[dt] = sig
    swept = set(seen).union(*(spec["sweep"](sig) for sig in largest.values()))
    worst, by_dtype = 0.0, {}
    for sig in sorted(swept, key=repr):
        kern, plain, _, *wide = spec["ops"](sig)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), (name, sig)
        assert got.dtype == want.dtype, (name, sig, got.dtype, want.dtype)
        if got.dtype == torch.float32:
            torch.testing.assert_close(got, want, **KERNEL_TOL)
        else:
            hold_bf16(torch, got, wide[0](), KERNEL_TOL["atol"],
                      rows=spec.get("rows", False))
        # no atomics anywhere, split or not: a repeat is bit for bit
        assert torch.equal(kern(), got), (name, sig, "not deterministic")
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        dt = sig_dtype(name, sig)
        by_dtype[dt] = max(by_dtype.get(dt, 0.0), err)
    out = {}
    for path, counts in passes.items():
        t = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                           "bound_fp32_ms"), 0.0)
        flop_s = byte_s = 0.0
        per_sig = []
        for sig, n in counts.items():
            kern, plain, lib, *_ = spec["ops"](sig)
            ms = n * time_ms(torch, kern, reps)
            plain_ms = n * time_ms(torch, plain, reps)
            lib_ms = None if lib is None else n * time_ms(torch, lib, reps)
            t["ms"] += ms
            t["plain_ms"] += plain_ms
            if lib_ms is None:
                t["library_ms"] = None
            else:
                t["library_ms"] += lib_ms
            flops, nbytes = spec["work"](sig)
            bound = n * max(flops / flops_s(sig), nbytes / HBM_BYTES_S) * 1e3
            bound32 = n * max(flops / FP32_FLOPS, nbytes / HBM_BYTES_S) * 1e3
            t["bound_ms"] += bound
            t["bound_fp32_ms"] += bound32
            flop_s += n * flops / flops_s(sig)
            byte_s += n * nbytes / HBM_BYTES_S
            per_sig.append((ms, plain_ms, lib_ms, bound, bound32, n, sig))
        t["bound_by"] = "operations" if flop_s >= byte_s else "bytes"
        t["launches"] = sum(counts.values())
        t["dtype"] = "/".join(sorted({sig_dtype(name, sig) for sig in counts}))
        if name in ROUTED:                 # the pass's launches per route
            t["routes"] = {}
            for sig, n in counts.items():
                rt = sig_route(name, sig)
                t["routes"][rt] = t["routes"].get(rt, 0) + n
        out[path] = t
        fp32 = f", fp32 bound {t['bound_fp32_ms']:.4f}" if tc else ""
        print(f"{name}: one pass of {path}: {t['launches']} launches, "
              f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library "
              f"{_ms(t['library_ms'])}, bound {t['bound_ms']:.4f} by "
              f"{t['bound_by']}{fp32})", flush=True)
        assert t["ms"] >= t["bound_ms"], (name, path, "faster than its bound")
        listed = sorted(per_sig, key=lambda r: r[0], reverse=True)
        for ms, plain_ms, lib_ms, bound, bound32, n, sig in (
                listed if tc else listed[:TOP_SIGNATURES]):
            fp32 = f", fp32 bound {bound32:.4f}" if tc else ""
            print(f"    {ms:.4f} ms (plain {plain_ms:.4f}, library "
                  f"{_ms(lib_ms)}, bound {bound:.4f}{fp32}) x{n} at {sig}")
        if "tiles" in spec:          # every instantiated tile on this pass
            times = {}
            for sig, n in counts.items():
                for tile, tsig in spec["tiles"](sig).items():
                    kern, _, _, *wide = spec["ops"](tsig)
                    got = kern()
                    if got.dtype == torch.bfloat16:
                        hold_bf16(torch, got, wide[0](), KERNEL_TOL["atol"],
                                  rows=spec.get("rows", False))
                    del got
                    times[tile] = times.get(tile, 0.0) + n * time_ms(torch, kern, reps)
            t["tiles"] = times
            print(f"{name}: one pass of {path} per tile: " + ", ".join(
                f"{tile} {ms:.4f}" for tile, ms in times.items()) + " ms",
                  flush=True)
        if ab and "routes" in spec and all(
                len(spec["routes"](sig)) == 2 for sig in counts):
            # the two routes' kernels in turns, each summed over the pass
            kerns = [{rt: spec["ops"](rs)[0] for rt, rs in spec["routes"](sig).items()}
                     for sig in counts]
            order = ("mma.sync", "wgmma", "wgmma", "mma.sync")
            runs = [sum(n * time_ms(torch, k[rt], reps)
                        for k, n in zip(kerns, counts.values())) for rt in order]
            t["ab"] = {rt: [x for o, x in zip(order, runs) if o == rt] for rt in order[:2]}
            print(f"{name}: A/B of {path} (mma.sync / wgmma / wgmma / mma.sync, "
                  f"{AB_VARIANT} tiles): " + " / ".join(f"{x:.4f}" for x in runs)
                  + f" ms; bound {t['bound_ms']:.4f}, library "
                  f"{_ms(t['library_ms'])}", flush=True)
    extra = {}
    if "exact" in spec:              # distance from a float64 result
        extra["float64_err_by_dtype"], extra["float64_err_by_route"] = {}, {}
        for dt, sig in sorted(largest.items()):
            on = spec["routes"](sig) if "routes" in spec else {None: sig}
            if name in ROUTED:
                on[sig_route(name, sig)] = sig
            for rt, rsig in on.items():
                got_err, plain_err = spec["exact"](rsig)
                print(f"{name}: one head at {rsig}: max |kernel - float64| "
                      f"{got_err:.3g}, max |plain - float64| {plain_err:.3g} "
                      f"({got_err / plain_err:.2f}x)", flush=True)
                assert got_err <= 2 * plain_err, (name, rsig, got_err, plain_err)
                if rsig == sig:
                    extra["float64_err_by_dtype"][dt] = (got_err, plain_err)
                if rt is not None:
                    extra["float64_err_by_route"].setdefault(dt, {})[rt] = (
                        got_err, plain_err)
    common.reset_launches()          # the launches above were not the main path
    print(f"{name}: {len(seen)} main-path signatures + sweep at the largest of "
          f"each dtype ({', '.join(sorted(largest))}) hold to plain, max |err| "
          f"{worst:.3g}", flush=True)
    return {"source": spec["source"], "replaces": spec["replaces"],
            "max_abs_err": worst, "max_abs_err_by_dtype": by_dtype,
            "passes": out, **extra}


if __name__ == "__main__":
    raise SystemExit(main())
