#!/usr/bin/env python3
"""Drive the PyTorch port (the DVFS scheduler, and the serving and training
paths of the model stack) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases (each prints one line; any failed check makes the script exit 1
without the final result line):

1. build — ``nvcc`` compiles every CUDA kernel of the port from
   ``src/repro_torch/kernels/csrc/`` (one process per source, all at once);
   ptxas's registers, stack and spills of each attention backward kernel,
   none of the last two allowed at dh 64, 80 and 128, and of the SSD
   kernels (the forward with and without its chunk states, the backward's
   two) and of the causal conv's, none allowed;
2. kernel — the ``dvfs_opt`` CUDA kernel against its plain torch version
   on the card, on a 1,048,576-row fuzz matrix made from ``--seed`` plus the
   app-library rows, and on the rows of ``dvfs_opt.edge_rows`` (a NaN in
   each input column, infinite and just-feasible windows, gamma 0, delta 0
   and 1, a one-point box, an empty core range): every edge row bit-equal,
   NaN-aware, and every setting that is a number inside its row's box,
   except on the empty-box rows, where no setting can be; the same rows and
   a slice of the fuzz matrix bit-equal at the grids (16, 4), (8, 8) and
   (8192, 8192);
3. online — the main path: ``schedule_online`` on a 100k-task uniform day
   over the three-class fleet (l=4, theta=0.9, EDL, pipelined) with the
   kernel, checked against the same run through the torch grid+golden
   solvers on the card; the row count of every kernel launch is recorded
   and printed;
4. offline — ``schedule_offline`` on 20k tasks, the same checks and the
   same record; then the kernel and its plain version timed with CUDA
   events at the median launch of the online day, at 300k rows (the day's
   Algorithm-1 work, 100k tasks x 3 classes, as one batch) and at 1M rows,
   beside the least time the card could take;
5. attention kernel — ``flash_attention`` (CUDA) against its plain torch
   version in bf16 at h2o-danube-1.8b's serving shape (B 8, S 2048, H 32,
   KV 8, dh 80, causal, window 4096), at B 1, S 8192, where the window
   skips blocks, and on an input built to show a fault at the mask's edges,
   at dh 80 and again at dh 64 and dh 128 (each head dim is its own
   instantiation of the kernel); timed beside the plain version,
   ``scaled_dot_product_attention`` with the same mask (a yardstick the
   port never calls) and the bound;
6. ssd kernel — ``ssd_scan`` (CUDA) against its plain version at
   mamba2-370m's serving shape (B 8, S 2048, H 32, P 64, N 128) with dt and
   a from Mamba2's own ranges, y and the final state, and a 256-token
   segment that starts from a state; timed beside the plain version and
   the bound;
7. family attention — ``flash_attention`` (CUDA) against its plain version
   at the shapes the other served families give it: recurrentgemma-2b's
   (dh 256, window 2048, one kv head), whisper-base's encoder (non-causal)
   and cross-attention (Sq 2048 over Sk 1500), internvl2-2b's bidirectional
   image prefix of 256 tokens, and the head dims the wrapper zero-pads (16,
   every reduced config's, and 160, stablelm-12b's); q x4 so that plain
   renderings of faults (the diagonal dropped, the last key dropped, the
   causal mask where there is none, the prefix a key short) exceed the bar;
   each timed beside the plain version, ``scaled_dot_product_attention``
   on the same mask (the backend it took named) and the bound;
8. ssd padded — ``ssd_scan`` at (P, N) = (16, 16) and (16, 64), which the
   wrapper zero-pads to the kernel's (64, 128), against the plain version;
9. jobs — ``launch/energy_sched.py``'s day of LM jobs on the three-class
   fleet with the ``dvfs_opt`` kernel, against the same day through the
   torch grid+golden solvers on the card;
10. serve — ``Server.run`` at full width (random weights from ``--seed``)
   for h2o-danube-1.8b (dense), mamba2-370m (ssm), recurrentgemma-2b
   (hybrid), whisper-base (encdec), internvl2-2b (vlm) and
   moonshot-v1-16b-a3b (moe, 16 of its 48 layers: all 48 with their
   float32 master weights would need 168 GB): 8 requests of 2,048-token
   prompts, 64 new tokens each.  Checks the kernel launch counts (one per
   attention or SSD call of a prefill, none of the other), finite logits, the
   model's prefill through the kernels against the same prefill through
   the plain versions (each layer's call on its own inputs, then the logits
   and the whole decode cache; for moe on the kernel path's router
   decisions, replayed), and prefill against decode at full width on both
   paths (for moe under the JAX package's allowance for capacity routing,
   three times the bar); one prefill and a window of decode steps under
   ``torch.profiler``, the prefill's device time split between the
   family's kernel, the matmuls and the rest;
11. attention backward — ``flash_attention_bwd`` (CUDA) against its plain
   version (dq, dk, dv from the forward kernel's own output and row
   log-sum-exp) at h2o-danube-1.8b's training shape, recurrentgemma-2b's dh
   256 / MQA / window 2048, whisper-base's encoder and cross-attention,
   internvl2-2b's prefix of 256 at dh 128, the padded dh 16 and dh 160 and
   a ragged edge input, all with q x4; plain renderings of four faults the
   bar must catch (the delta term dropped, the causal mask one key off or
   the last key dropped, the GQA group sum over head 0 only, the scale
   applied twice to dK); two calls on the same inputs bit-equal; each
   timed beside the plain version, the backward of
   ``scaled_dot_product_attention`` and the bound;
12. ssd backward — ``ssd_scan_bwd`` (CUDA) against its plain version (dx,
   ddt, da, db, dc and dinit from the forward kernel's own chunk states,
   which are held against their plain version; the forward's y and final
   state with its states bit-equal to the serving forward's) at
   mamba2-370m's training shape (B 8, S 2048, H 32, P 64, N 128) with a
   zero and a random final-state cotangent, a 256-token segment from a
   state, a ragged S of 1,000 (the plain version on inputs padded with
   tokens of dt = 0 to the kernel's chunks) and the padded (P, N) = (16,
   16) and (16, 64); plain renderings of
   four faults the bar must catch (the state cotangent not carried across
   chunks, dB and dC from head 0 only, the off-chunk term dropped from d
   cum, ddt without d(dA) a); two calls bit-equal; the error again from
   chunk states rounded to bf16; each timed beside the plain version and
   the bound (the function's operands only; the bytes of chunk states and
   state cotangents the design moves besides are printed beside it), and
   the forward with and without writing its chunk states;
13. causal conv — ``csrc/causal_conv.cu`` (Mamba-2's depthwise causal conv
   with its bias and SiLU, forward and backward) against its plain version
   run in float32 at granite-4.0-h-micro's and mamba2-370m's training
   shapes (B 1 x S 16,384 x C 4,352 and B 8 x S 2,048 x C 2,304, each a
   strided view of an in_proj-shaped output), with and without a conv
   state: y, dx, dw, db and the state's gradient; two backward calls
   bit-equal; plain renderings of four faults the bar must catch (a window
   one step into the future, the oldest tap dropped, the bias left out,
   SiLU's derivative left out of the gradient); forward and backward timed
   beside their byte bounds, the plain version as the model ran it before
   the kernels (bf16; autograd's backward) and ``F.conv1d`` + ``F.silu``
   (a yardstick the port never calls);
14. adamw — ``csrc/adamw.cu`` (the multi-tensor AdamW update and its
   per-leaf norms) against the plain per-leaf loop on h2o-danube-1.8b's and
   mamba2-370m's parameter sets at full size and on a set of odd sizes
   (one element, three, none, 4,097, 2^20 + 5, a leaf 4 bytes past a
   16-byte boundary): three updates with the same injected scalars, p, m
   and v bit-equal, each leaf's sum of squares within 2e-6 of
   ``torch.sum``; ``AdamW.update`` through the public path, 3 launches and
   no gradient copied; at danube's 1.83B parameters the kernel's time
   beside its 32-bytes-an-element bound, the plain loop's and
   ``torch._fused_adamw_``'s (a yardstick the port never calls);
15. train danube — the training path: h2o-danube-1.8b at full width and
   depth (24 layers), B 8, S 2048, ``succ`` data, the reference launcher's
   AdamW and schedule, remat on: the first step's loss and gradient norm
   through the kernels against the same step through the plain versions;
   then ``run_loop`` for 8 steps with a checkpoint every 3 steps and a
   failure injected once at step 6 (it restores step 3 and replays; the
   replayed losses must equal the first run's bit for bit), the launch
   counts of the run checked exactly; step seconds, tokens/s, peak memory,
   and one profiled step's device idle share and the kernels' shares;
16. train mamba2 — the ssm family's training path: mamba2-370m at full
   width and depth (48 layers), B 8, S 2048, ``succ`` data, the same AdamW
   and remat: the first step's loss and gradient norm through the kernels
   against the plain versions, then 5 steps with their launch counts
   checked exactly (the SSD forward and the causal conv's twice a layer,
   their backwards once); step seconds, tokens/s, peak memory, one
   profiled step's idle share and the SSD and conv kernels' shares;
17. train families — one train step of the ``smoke`` preset of each other
   family on the card (moe, hybrid, encdec, vlm, ssm: finite loss and
   gradient norm, the family's backward kernel launched);
18. mesh — the multi-device layer on the one card: the online day's
   largest launch matrix (99,328 rows) and a 300k-row fuzz matrix through
   ``dvfs_solve_matrix`` split over ``[cuda:0, cuda:0]`` (``ops.solve_devices``
   listing the card twice; padding, two
   chunks of whole blocks, the gather), bit-equal to one launch, and the
   default device list making one launch on a one-card machine; then a
   one-rank NCCL ``(1, 1)`` ``DeviceMesh`` (``launch/mesh.py``):
   h2o-danube-1.8b served at full width and depth under ``serve_rules``
   (``DTensor`` weights gathered at their use, the decode cache through
   the sequence-sharded flash-decode's collectives) with the serve
   phase's requests, its tokens equal to the same server's without a mesh;
   the danube training step (B 8, S 2048) under ``fsdp_rules``, its loss
   and updated parameters equal to the step without a mesh, and the
   launch counts of that path read around it; the state checkpointed and
   restored with ``shardings=`` onto the mesh, every leaf equal; the
   serve and step times with and without the mesh, beside the card's name
   and power limit;
19. dryrun — the dry-run (``launch/dryrun.py``) against the card:
   ``torch.library.opcheck`` of the model kernels' custom ops on real
   inputs at danube's attention shape and mamba2-370m's SSD and conv
   shapes, and
   the host time the dispatcher adds to a call; the card's memory size;
   h2o-danube-1.8b's ``train_4k`` cell at B 4 (16,384 tokens) traced with
   fake CUDA tensors on a fake (1, 1) mesh, no kernel launched, and the
   same step run for real twice: under ``FlopCounterMode``, the FLOPs
   equal op by op, then without it, the transient peak within 25% of the
   trace's temporaries; the kernels' launches of each step exact; then the
   cell on the 256-rank fake production mesh with its probes (ok, FLOPs,
   collectives, live bytes, the reference's 4 microbatches), its record
   written to ``results/dryrun/``;
20. tp — the model axis split over ranks (``partition.py``'s tensor and
   expert parallelism): with two or more cards one rank a card over NCCL
   on a (1, n) mesh (n 2 or 4), with one card two processes on it over
   gloo (``DTensor``'s functional collectives routed through the process
   group's own calls, ``install_gloo_cuda_collectives``), after a probe
   of ``all_reduce``, ``all_gather`` and ``broadcast`` on CUDA tensors.
   h2o-danube-1.8b and mamba2-370m at full width and depth, each served
   under ``serve_rules`` with the serve phase's requests (the whole
   prefill's logits within the serve phase's 1e-1 of max of one rank's,
   the first decode position where the greedy tokens differ printed) and
   stepped once under ``fsdp_rules`` (danube on 4 rows, mamba2 on 8, of
   2,048 tokens: loss rel 2e-3, grad norm 2e-2, every gradient leaf at
   cosine >= 0.99 of rank 0's one-rank step); each rank's kernel launches
   exact, at H / n attention heads (KV / n kv heads) and H_ssm / n SSD
   heads; times beside the card's name and power limit.  Without a
   working two-rank transport, rank 0's share alone: the kernels at the
   local shapes of a (1, 2) and a (1, 4) split against their plain
   versions.

Each kernel check compares the normalised error, max |got - want| /
(|want| + rms(want)), with its bar, and shows that the bar would catch the
fault it is there for: the same measure between the plain version and a
plain rendering of that fault (a mask edge off by one key, the state
dropped at the kernel's chunk boundaries or at the start) must exceed it.

Before the last line it prints the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) and a JSON line of kernel measurements; the last line is
``{"ok": true, "device": {...}}``.  It needs one CUDA card and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The main path's Algorithm-1 batch (100k tasks x 3 classes) and the fuzz size.
MAIN_ROWS = 300_000
FUZZ_ROWS = 1 << 20
CLASSES = ("gtx-1080ti", "tpu-v5e", "v100-sxm2")
# dvfs_opt at grids other than the main path's DEFAULT_GRID, on the edge rows
# and 2 x GRID_ROWS fuzz rows.
OTHER_GRIDS = ((16, 4), (8, 8), (8192, 8192))
GRID_ROWS = 2048

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, and
# HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BF16_OPS = 989e12   # dense tensor-core rate
PEAK_BYTES = 3.35e12

# The serve phase: requests, prompt length, new tokens; and the
# prefill-against-decode check (requests, decode steps).
SERVE_REQUESTS, SERVE_PROMPT, SERVE_GEN = 8, 2048, 64
CONSIST_REQUESTS, CONSIST_STEPS = 2, 4
DECODE_PROFILE = 8   # decode steps under the profiler
# (arch, layers kept or None for all): moonshot-v1-16b-a3b keeps 16 of its
# 48 layers at full width, 9.8 B parameters, 59 GB as float32 master
# weights plus their bf16 serving copy.  Which kernels an arch launches,
# and how often, ``kernel_calls`` says (granite-4.0-h-micro runs both: 36
# SSD layers, 4 attention layers).
SERVE_ARCHS = (("h2o-danube-1.8b", None),
               ("mamba2-370m", None),
               ("recurrentgemma-2b", None),
               ("whisper-base", None),
               ("internvl2-2b", None),
               ("moonshot-v1-16b-a3b", 16),
               ("granite-4.0-h-micro", None))
# Archs with a plain float32 reference in the benchmark
# (``bench/reference/<family>.py``), whose served logits the serve phase
# holds to the reference's full forward: the family module's name.
REFERENCE_ARCHS = {"granite-4.0-h-micro": "ssm_hybrid"}
# Kernel phases: (B, S, H, KV, dh, window) causal attention at danube's
# serving shape and at a length where the window skips blocks; (B, S, H,
# P, N) of the SSD scan at mamba2-370m's serving shape.
ATTN_SHAPES = (("serve", (8, 2048, 32, 8, 80, 4096)),
               ("long", (1, 8192, 32, 8, 80, 4096)))
# An input that shows a fault at the mask's edges: a ragged length, a window
# that ends inside a 64-key tile, and q scaled so that the scores have std 4
# and a few keys carry most of each row.  One key too many or too few at the
# window's or the diagonal's edge then moves many rows by much of their size.
ATTN_EDGE = (2, 1000, 32, 8, 80, 100)
ATTN_EDGE_Q_SCALE = 4.0
# The same kind of input at the other head dims the kernel is compiled for:
# dh 64 with whisper-base's 8 heads over 8 kv heads (no grouping), and dh
# 128 (qwen2, nemotron, qwen3-moe, moonshot) with 4 query heads a kv head.
ATTN_HEAD_DIMS = (("dh64", (2, 1000, 8, 8, 64, 100)),
                  ("dh128", (2, 1000, 16, 4, 128, 100)))
# The shapes the other served families give the attention kernel: (B, Sq, Sk,
# H, KV, dh), causal, window, bidirectional prefix.  recurrentgemma-2b's
# local attention (dh 256, MQA), whisper-base's encoder and cross-attention
# over its 1,500 frames, internvl2-2b's image prefix, then a ragged input at
# dh 256 whose window ends inside a 64-key tile, and the padded head dims:
# every reduced config's 16 (ragged, window) and stablelm-12b's 160; last,
# granite-4.0-h-micro's training shape, full causal over 16,384 keys at dh
# 64 with its own scale (ATTN_SCALES).  All with q x ATTN_EDGE_Q_SCALE, so
# that a key too many or too few moves rows.
ATTN_FAMILY_SHAPES = (
    ("recurrentgemma", (8, 2048, 2048, 10, 1, 256), True, 2048, 0),
    ("dh256_edge", (2, 1000, 1000, 10, 1, 256), True, 100, 0),
    ("whisper_encoder", (8, 1500, 1500, 8, 8, 64), False, None, 0),
    ("whisper_cross", (8, 2048, 1500, 8, 8, 64), False, None, 0),
    ("internvl_prefix", (8, 2048, 2048, 16, 8, 128), True, None, 256),
    ("dh16_padded", (2, 1000, 1000, 8, 2, 16), True, 100, 0),
    ("dh160_padded", (8, 2048, 2048, 32, 8, 160), True, None, 0),
    ("granite", (1, 16384, 16384, 32, 8, 64), True, None, 0))
# The softmax scale of a shape whose model sets its own (else dh ** -0.5):
# granite-4.0-h-micro's attention_multiplier, 1/64 at dh 64 (an eighth of
# the default).  Its q is scaled up by the same factor, so that the scores
# keep ATTN_EDGE_Q_SCALE's spread and the mask faults still show; a kernel
# that ignored the scale would then see scores eight times too wide.
ATTN_SCALES = {"granite": 1 / 64}
SSD_SHAPE = (8, 2048, 32, 64, 128)
# granite-4.0-h-micro's training shape of the SSD scan: B 1, S 16,384, 64
# heads of 64 (d_inner 4,096), state 128; the 32 blocks of one batch row's
# heads, where mamba2-370m's shape gives 256.
SSD_HYBRID_SHAPE = (1, 16384, 64, 64, 128)
# (P, N) the SSD wrapper zero-pads to (64, 128): the reduced mamba2-370m's
# (16, 16) and the 100m preset's (16, 64), at B 8, S 2048 and the presets'
# head counts.
SSD_PAD_SHAPES = ((8, 2048, 8, 16, 16), (8, 2048, 64, 16, 64))
# Mamba2's initialisation ranges (arXiv:2405.21060 and its reference code):
# softplus(dt_bias) log-uniform in [1e-3, 0.1], A = -a uniform in [1, 16].
# At the small end a head's state decays by exp(-0.064) over a 64-token
# chunk, so what one chunk carries into the next shows in y and the final
# state; at the large end it is gone within a few tokens.
SSD_DT_RANGE, SSD_A_RANGE = (1e-3, 0.1), (1.0, 16.0)
SSD_INIT_LEN = 256   # tokens of the segment that starts from a state
# Kernel against plain version, bf16: the normalised error (norm_err).  The
# two versions tile the sums differently (128-key tiles and exp2 against
# 1,024-key blocks and exp, SSD chunks of 64 against 256), so the same bf16
# roundings land on other values; where an output is a cancelling sum its
# error shows against the RMS floor.  Readings on an H100 at 700 W
# (chip_smoke.py, one run): attention 1.6e-2 (serve), 1.4e-2 (long), 6.6e-3
# (edge), 5.9e-3 (dh 64 and dh 128), 1.1e-2 at the worst danube layer, 8.3e-3
# at granite-4.0-h-micro's 16,384 keys and scale 1/64; SSD 1.7e-2 (y),
# 1.2e-2 (final state), 1.7e-2 and 1.3e-2 at granite's B 1 x H 64 x S
# 16,384, 2.7e-2 at the worst mamba2 layer.  Each bar is three to four
# times the largest reading, and the plain renderings of the faults it
# guards against read 0.68-31 against it.
ATTN_BAR, SSD_BAR = 6e-2, 8e-2
# The model's whole prefill through the kernels against the same prefill
# through the plain versions, same weights and tokens: max |difference| over
# max |plain| of the logits and of every tensor of the decode cache (each
# layer's kernel call on its own inputs is held to ATTN_BAR or SSD_BAR; here
# the layers' differences compound through the depth).  Readings on an H100
# (chip_smoke.py, one run): 4.1e-2 (danube logits), 3.3e-2 (its k and v
# cache), 1.7-2.3e-2 (mamba2), the order of the plain path's own prefill-
# against-decode gap below; the bar is 2.5 times the largest.
PLAIN_PATH_BAR = 1e-1
# Prefill against decode at full width: max |decode - prefill| logits over
# max |prefill| logits.  The two sides round bf16 activations at different
# points (tiled prefill against one-token decode, other matmul shapes), and
# the gap grows with depth.  With no kernel at all, through the plain
# versions on the card, it reads 3.5e-2 (danube) and 4.8e-2 (mamba2) at full
# width (chip_smoke.py, one H100 run), so the bar is twice that; the JAX
# package's own check (tests/test_decode_consistency.py) allows 0.05
# absolute on reduced-config logits whose max is about 0.57, i.e. ~9%.
CONSIST_BAR = 1e-1
# Served logits (a prefill, then decode steps through the cache) against the
# plain float32 reference's full forward (``REFERENCE_ARCHS``): max |served -
# reference| over max |reference| of each step.  The served side rounds its
# weights and every activation, the residual stream included, to bf16 (a
# relative 2^-9 each), and the roundings compound through the depth as they
# do between prefill and decode above: ``tests/test_torch_hybrid.py`` reads
# 2.4e-3 to 3.6e-3 at reduced width (10 layers) on the CPU and allows 1.2e-2;
# at 40 layers of full width the bar is CONSIST_BAR's, the gap two bf16
# renderings of one model may show at full depth.
REFERENCE_BAR = CONSIST_BAR
# The moe family's prefill against decode: the same bar times the JAX
# package's own allowance for capacity routing (tests/test_decode_consistency
# .py allows 0.15 for moe against 0.05 for every other family).  A prefill
# routes groups of 256 tokens with a capacity of 30 slots an expert and drops
# the overflow, a decode step routes the batch's 2 tokens with 1 slot, so the
# two drop different expert calls.  The plain path reads the same gap
# (moonshot-v1-16b-a3b at 16 layers on an H100: 0.2379 through the kernels,
# 0.2420 through the plain versions, chip_smoke.py, one run).
MOE_CONSIST_BAR = 3e-1

# The attention backward phase: (name, (B, Sq, Sk, H, KV, dh), causal,
# window, prefix), all with q x ATTN_EDGE_Q_SCALE so that a key too many or
# too few moves rows: h2o-danube-1.8b's training shape (its window 4096 is
# longer than the sequence), the shapes the other families give the forward
# kernel, a ragged edge input at dh 80, and granite-4.0-h-micro's training
# shape (full causal over 16,384 keys at its scale, ATTN_SCALES).
ATTN_BWD_SHAPES = (
    ("danube", (8, 2048, 2048, 32, 8, 80), True, 4096, 0),
    ("recurrentgemma", (8, 2048, 2048, 10, 1, 256), True, 2048, 0),
    ("whisper_encoder", (8, 1500, 1500, 8, 8, 64), False, None, 0),
    ("whisper_cross", (8, 2048, 1500, 8, 8, 64), False, None, 0),
    ("internvl_prefix", (8, 2048, 2048, 16, 8, 128), True, None, 256),
    ("dh16_padded", (2, 1000, 1000, 8, 2, 16), True, 100, 0),
    ("dh160_padded", (8, 2048, 2048, 32, 8, 160), True, None, 0),
    ("edge", (2, 1000, 1000, 32, 8, 80), True, 100, 0),
    ("granite", (1, 16384, 16384, 32, 8, 64), True, None, 0))
# Backward kernel against its plain version, bf16, the normalised error of
# each of dq, dk, dv.  The two round P and dS to bf16 at the same places but
# take exp2 against exp and sum in other orders; dq sums over the most keys.
# Readings on an H100 at 700 W (chip_smoke.py, one run, these shapes): dq
# 5.3e-3 to 2.1e-2, dk 3.4e-3 to 2.0e-2, dv 2.7e-3 to 1.3e-2 (granite's:
# 1.9e-2, 1.2e-2, 1.1e-2).  The bar is four times the largest; the plain
# renderings of the faults read 0.67-48 against it.
ATTN_BWD_BAR = 8e-2

# The SSD backward phase: mamba2-370m's training shape (B 8, S 2048, H 32,
# P 64, N 128), from zero and with a final-state cotangent; a 256-token
# segment from a state; a ragged S; the padded (P, N) of the smoke and 100m
# presets; granite-4.0-h-micro's training shape (SSD_HYBRID_SHAPE, from
# zero, its final state unused).  (name, (B, S, H, P, N), initial state,
# final-state cotangent)
SSD_BWD_SHAPES = (
    ("train", (8, 2048, 32, 64, 128), False, False),
    ("train_dfinal", (8, 2048, 32, 64, 128), False, True),
    ("segment_from_state", (8, SSD_INIT_LEN, 32, 64, 128), True, True),
    ("ragged", (2, 1000, 32, 64, 128), True, True),
    ("pad_p16_n16", (8, 2048, 8, 16, 16), False, False),
    ("pad_p16_n64", (8, 2048, 64, 16, 64), True, True),
    ("granite", SSD_HYBRID_SHAPE, False, False))
# Backward kernel against ssd_scan_bwd_plain at KERNEL_CHUNK, bf16, the
# normalised error of each of dx, ddt, da, db, dc and dinit; a ragged S goes
# to the plain version padded with tokens of dt = 0 to whole chunks, so
# that both chunk at 64.  The two round the same operands to bf16 but sum
# in other orders (mma tiles against einsums, the heads' dB and dC sums in
# another order) and take exp2 against exp.  Readings on an H100 at 700 W
# (chip_smoke.py, these shapes): at most 2.33e-2 (dx at granite's shape in
# a whole run, 1.44e-2 on another draw; 1.31e-2 at mamba2's), 9.8e-3 at the
# ragged S (2.50e-2 there while the plain version shrank its chunk to 50
# tokens to divide S).  The bar was set at three times mamba2's largest and
# is 1.7 times granite's; the plain renderings of the faults
# (ssd_bwd_faults) read 0.36-8.8 against it.
SSD_BWD_BAR = 4e-2
# The backward's two launches, as the profiler names them.
SSD_BWD_KERNELS = ("ssd_bwd_state", "ssd_bwd_chunk")
# Mamba-2's causal conv (csrc/causal_conv.cu) at the training shapes of the
# two cells that run it, granite-4.0-h-micro's and mamba2-370m's: the (x, B,
# C) columns of an in_proj-shaped output [B, S, 2 d_inner + 2 N + H], the
# strided view the model hands the kernel.  (name, (B, S, d_inner, N, H))
CONV_SHAPES = (("granite", (1, 16384, 4096, 128, 64)),
               ("mamba2", (8, 2048, 2048, 128, 32)))
CONV_WIDTH = 4
# The conv's kernels against the plain version run in float32 on the same
# bf16 operands: the normalised error of y, dx, dw, db and the state's
# gradient.  The kernels compute in float32 and round each output to bf16
# once, so each reads at most half a bf16 ulp, 2^-8 of the value (3.9e-3);
# on an H100 at 700 W (this phase, both shapes) y 3.5e-3, dx 3.5e-3, dw
# 2.9e-3, db 2.9e-3, the state's gradient 1.0e-6.  The bar is 2.5 times
# the half ulp; the model's own bf16 conv reads 1.9-2.1e-2 against the same
# float32 answer, and the plain renderings of the faults 2.2-14.
CONV_BAR = 1e-2
# The conv's launches, as the profiler names them.
CONV_KERNELS = ("causal_conv1d_fwd", "causal_conv1d_bwd_dx",
                "causal_conv1d_bwd_dw")

# The training phases: h2o-danube-1.8b at full width and depth, the batch
# and length of the serving phase's prompts, the JAX launcher's defaults
# (lr 1e-3 on a cosine schedule with 20 warmup steps over the run, AdamW
# b1 0.9, b2 0.95, weight decay 0.1, clipping at 1.0), 8 steps with a
# checkpoint every 3 and a failure injected once before step 6.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "h2o-danube-1.8b", 8, 2048
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT, TRAIN_LR = 8, 3, 6, 1e-3
# The first step through the kernels against the same step through the plain
# versions: loss and global gradient norm, relative, the CPU tests' bars
# against the JAX package (tests/test_torch_train.py).  Readings on an H100
# at 700 W (chip_smoke.py, one run): 4.1e-6 and 1.3e-4.
TRAIN_LOSS_BAR, TRAIN_GNORM_BAR = 2e-3, 2e-2
# The ssm family's training phase: mamba2-370m at full width and depth (48
# layers), the same batch, length, data and optimizer as danube's, a few
# steps (no checkpoint loop: the danube phase drives the loop).
TRAIN_SSM_ARCH, TRAIN_SSM_STEPS = "mamba2-370m", 5
# One smoke-preset step of each other family on the card.
TRAIN_FAMILY_ARCHS = ("moonshot-v1-16b-a3b", "recurrentgemma-2b",
                      "whisper-base", "internvl2-2b", "mamba2-370m",
                      "granite-4.0-h-micro")
TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ = 4, 64
# The dry-run's estimate against the card: h2o-danube-1.8b's train_4k cell
# at B 4 (16,384 tokens a step, phase "train"'s count) traced on a fake
# (1, 1) mesh and run for real; the step's transient peak within this
# fraction of the trace's temporaries.
DRYRUN_ROWS, DRYRUN_PEAK_BAR = 4, 0.25
# The reference's microbatch count for h2o-danube-1.8b train_4k at 16 data
# ranks (its choose_microbatches; tests/test_torch_dryrun.py holds the
# port's equal to it cell by cell).
DRYRUN_MICROBATCHES = 4
# Calls a timing of the custom ops' dispatch makes back to back.
OP_CALLS = 500
# Phase "tp": (architecture, rows of its training step), served with the
# serve phase's requests; danube's step cut to 4 rows so that two ranks and
# rank 0's one-rank reference share one card's 80 GB.  Every gradient leaf
# at this cosine with the one-rank step's (tests/test_torch_train.py's bar),
# and the phase's deadline.
TP_TRAIN = (("h2o-danube-1.8b", 4), ("mamba2-370m", 8))
TP_LEAF_COS = 0.99
#: How many of the lowest leaf cosines phase "tp" prints, by name.
TP_LOWEST = 3
TP_TIMEOUT_S = 600

# Phase "adamw": the kernel against the plain per-leaf loop on danube's and
# mamba2-370m's parameter sets at full size and on a set of odd sizes (one
# element, three, none, 4,097, 2^20 + 5, and a leaf 4 bytes past a 16-byte
# boundary, which takes the scalar loop); three updates on injected scalars
# (t = 1, 2, 3 of the train phases' AdamW, the gradients clipped by half).
ADAMW_ODD = (1, 3, 0, 4097, (1 << 20) + 5)
ADAMW_MISALIGNED = 640
ADAMW_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
ADAMW_UPDATES = 3
# Per-leaf sums of squares against torch.sum(g.float() ** 2), relative.
ADAMW_NORM_BAR = 2e-6
# Bytes an element the two passes need: g read for the norm; g, p, m, v
# read and p, m, v written for the update.
ADAMW_BYTES = 32
# The kernel's three launches, as the profiler names them.
ADAMW_KERNELS = ("adamw_sq_partials", "adamw_leaf_sums",
                 "adamw_update_kernel")

# Float32 operations per task row of csrc/dvfs_opt.cu, counted from the
# source with every add, subtract, multiply, divide, square root, min/max,
# compare and select as one operation (a division is some ten instructions
# on the card, so this count gives a bound the kernel cannot reach).
OPS_UNC_EVAL = 40    # Unconstrained::at: 4 divisions, 1 sqrt
OPS_BND_EVAL = 41    # Boundary::at: 4 divisions
OPS_COARSE_POINT = 2  # i / (G0 - 1) and the running-min compare
OPS_FINE_POINT = 5    # j / (G1 - 1), the bracket lerp, the compare
OPS_BRACKET = 12      # f0_best, f_lo, f_hi, the guard
OPS_ROW = 41          # g1(v_max), t_min, feasibility, pick, p, t, e
BYTES_ROW = 16 * 4 + 8 * 4   # one [16] f32 row read, one [8] f32 row written

def ops_per_row(g0: int, g1: int) -> int:
    """Operations of one row: two hierarchical sweeps of g0 + g1 points plus
    the re-evaluation at each winner, then the decision rule."""
    sweep_extra = g0 * OPS_COARSE_POINT + g1 * OPS_FINE_POINT + OPS_BRACKET
    return ((g0 + g1 + 1) * (OPS_UNC_EVAL + OPS_BND_EVAL)
            + 2 * sweep_extra + OPS_ROW)


def bound_ms(rows: int, g0: int, g1: int) -> tuple:
    """The least time an H100 could take for ``rows`` rows: the larger of the
    operation time and the byte time, and which of the two it is."""
    t_ops = rows * ops_per_row(g0, g1) / PEAK_F32_OPS * 1e3
    t_bytes = rows * BYTES_ROW / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Checks:
    """Collects failed checks; a phase records what it compared."""

    def __init__(self):
        self.failed = []

    def expect(self, ok: bool, what: str):
        if not ok:
            self.failed.append(what)
            print(f"FAILED: {what}", flush=True)


def fuzz_matrix(np, dvfs, tasks, seed: int, n: int):
    """The ``[n, 16]`` fuzz rows of the kernel tests, vectorized: random
    params, mixed scaling boxes including a degenerate single-point one,
    30% readjust rows, windows from half of t_min up to 2 t*; followed by
    the app-library rows on each class box at eight windows each."""
    rng = np.random.default_rng(seed)
    p_star = rng.uniform(120, 260, n)
    gamma = p_star * rng.uniform(0.05, 0.25, n)
    p0 = p_star * rng.uniform(0.1, 0.5, n)
    c = p_star - gamma - p0
    big_d = rng.uniform(1.0, 50.0, n)
    delta = rng.uniform(0.0, 1.0, n)
    t0 = rng.uniform(0.05, 5.0, n)
    boxes = [dvfs.WIDE.bounds(), dvfs.NARROW.bounds(),
             dvfs.TPU_V5E_INTERVAL.bounds()]
    for _ in range(2):
        v_min = float(rng.uniform(0.5, 0.9))
        v_max = float(rng.uniform(v_min + 0.05, 1.24))
        fm_min = float(rng.uniform(0.5, 0.9))
        boxes.append((v_min, v_max, float(rng.uniform(0.5, 0.8)), fm_min,
                      float(rng.uniform(fm_min + 0.05, 1.2))))
    v = float(rng.uniform(0.7, 1.2))
    boxes.append((v, v, dvfs.g1_float(v), 1.0, 1.0))   # one point
    bounds = np.asarray(boxes, np.float64)[rng.integers(0, len(boxes), n)]
    fc_max = np.sqrt(np.maximum(bounds[:, 1] - 0.5, 0.0) / 2.0) + 0.5
    tmin = big_d * (delta / fc_max + (1.0 - delta) / bounds[:, 4]) + t0
    tstar = big_d + t0
    readj = (rng.random(n) < 0.3).astype(np.float64)
    lo = np.where(readj > 0.5, tmin, 0.5 * tmin)
    allowed = lo + (2.0 * tstar - lo) * rng.random(n)
    fuzz = np.concatenate(
        [np.stack([p0, gamma, c, big_d, delta, t0, allowed, readj], axis=1),
         bounds, np.zeros((n, 3))], axis=1)

    lib = tasks.app_library()
    lib_rows = []
    for box in (dvfs.WIDE, dvfs.TPU_V5E_INTERVAL,
                dvfs.ScalingInterval(0.75, 1.2, 0.55, 0.65, 1.1)):
        t_lib = np.asarray(lib.default_time())
        for k in np.linspace(0.6, 2.0, 8):
            m = np.stack([*lib.astuple(), t_lib * k,
                          np.zeros(lib.n)], axis=1)
            lib_rows.append(np.concatenate(
                [m, np.broadcast_to(box.bounds(), (lib.n, 5)),
                 np.zeros((lib.n, 3))], axis=1))
    return np.ascontiguousarray(np.concatenate([fuzz, *lib_rows]), np.float32)


def fc_max(np, mat):
    """g1(v_max) of each task row: the top of its core-frequency range."""
    return np.sqrt(np.maximum(mat[:, 9] - 0.5, 0.0) / 2.0) + 0.5


def outside_box(np, got, mat, tol: float = 1e-4):
    """Rows of ``got`` (the solutions of task rows ``mat``) with a setting
    that is a number outside its row's box by more than ``tol``: v in
    [v_min, v_max], fc in [fc_min, g1(v_max)], fm in [fm_min, fm_max].  A
    NaN setting or bound compares false."""
    lo = np.stack([mat[:, 8], mat[:, 10], mat[:, 11]], axis=1)
    hi = np.stack([mat[:, 9], fc_max(np, mat), mat[:, 12]], axis=1)
    with np.errstate(invalid="ignore"):
        return np.any((got[:, :3] < lo - tol) | (got[:, :3] > hi + tol),
                      axis=1)


def empty_core_range(np, mat):
    """Rows whose core-frequency range is empty, fc_min > g1(v_max): the
    solvers, the reference's too, then return fc = g1(v_max) < fc_min."""
    with np.errstate(invalid="ignore"):
        return mat[:, 10] > fc_max(np, mat)


@contextlib.contextmanager
def launch_rows(ops):
    """Records the row count of every ``dvfs_opt`` launch that the solver
    stack makes inside the block (``ops.dvfs_solve_matrix`` is the one
    caller of ``dvfs_solve_kernel``); yields the list."""
    rows = []
    inner = ops.dvfs_solve_kernel

    def recording(tasks, **kw):
        if tasks.device.type == "cuda" and tasks.shape[0]:
            rows.append(int(tasks.shape[0]))
        return inner(tasks, **kw)

    ops.dvfs_solve_kernel = recording
    try:
        yield rows
    finally:
        ops.dvfs_solve_kernel = inner


def event_ms(torch, fn, reps: int) -> float:
    """Device time of one call: ``reps`` calls back to back between two
    CUDA events, over the count; the median of three such runs, after
    two warm-up calls.  Back to back, the host's work to launch a call (a
    wrapper's checks, the ctypes call, a kernel's set-up) overlaps the
    device's work on the one before, so it stays out of the time wherever
    the device, not the host, is the slower of the two."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn, symbols, reps: int) -> dict:
    """Device time of one launch of each kernel in ``symbols``: ``reps``
    calls of ``fn`` under ``torch.profiler``, each kernel's device time
    over the launches the profiler saw of it.  The profiler can miss the
    first millisecond or so of a window (on an H100 it saw 3 of 5 calls of
    0.5 ms, and none of 5 of 0.2 ms), so a kernel it did not see is timed
    again with four times the calls, twice at most; None if it never saw
    one.  Unlike ``event_ms`` it leaves out the time the card waits for
    the host, which is the longer of the two at small launches."""
    from torch.profiler import ProfilerActivity, profile
    out = dict.fromkeys(symbols)
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        for symbol in symbols:
            ms, n = device_split(events, symbol)[0]["kernel"]
            if out[symbol] is None and n:
                out[symbol] = ms / n
        if all(v is not None for v in out.values()):
            break
        reps *= 4
    return out


def norm_err(got, want) -> float:
    """max |got - want| / (|want| + rms(want)): each element's error against
    its own size, with the RMS of ``want`` as the floor for elements near
    zero."""
    g, w = got.float(), want.float()
    rms = w.square().mean().sqrt()
    return ((g - w).abs() / (w.abs() + rms)).max().item()


def max_rel(got, want) -> float:
    """max |got - want| / max |want|."""
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / w.abs().max()).item()


def attention_bound(B, H, KV, S, dh, causal, window, sk=None,
                    prefix=0) -> tuple:
    """Least time for attention over these shapes (``sk`` keys, S of them
    if None; keys below ``prefix`` visible to every query): the larger of
    the operations of the live (unmasked) score entries, 4 B H dh per entry
    (``flash_attention.attention_flops``, whose count the kernel's FLOP
    formula uses too) at the bf16 peak, and the bytes of q, k, v and o once
    each (bf16)."""
    from repro_torch.kernels.flash_attention import attention_flops
    sk = S if sk is None else sk
    t_ops = (attention_flops(B, H, S, sk, dh, causal, window, prefix)
             / PEAK_BF16_OPS * 1e3)
    t_bytes = 2.0 * B * dh * (2 * H * S + 2 * KV * sk) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bwd_bound(B, H, KV, S, dh, causal, window, sk, prefix) -> tuple:
    """Least time for the attention backward: the larger of five products
    over the live score entries (S and dP recomputed, dV, dK, dQ: 10 B H dh
    per entry, ``flash_attention.attention_bwd_flops`` with
    ``BWD_PRODUCTS``; the kernel computes seven) at the bf16 peak, and the
    bytes of q, k, v, o, dO, dq, dk, dv (bf16) and lse (float32) once
    each."""
    from repro_torch.kernels import flash_attention as fa
    t_ops = (fa.attention_bwd_flops(B, H, S, sk, dh, causal, window, prefix,
                                    fa.BWD_PRODUCTS) / PEAK_BF16_OPS * 1e3)
    t_bytes = (2.0 * B * dh * (4 * H * S + 4 * KV * sk)
               + 4.0 * B * H * S) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ssd_bound(B, S, H, P, N, q) -> tuple:
    """Least time for the SSD scan: the larger of the chunked products'
    operations at the kernel's chunk q (``ssd_scan.ssd_flops``) at the bf16
    peak, and the bytes of x, dt, a, b, c in and y and the f32 final state
    out."""
    from repro_torch.kernels.ssd_scan import ssd_flops
    byts = (B * S * H * P * 2 * 2 + B * S * H * 4 + H * 4 + 2 * B * S * N * 2
            + B * H * P * N * 4)
    t_ops = ssd_flops(B, S, H, P, N, q) / PEAK_BF16_OPS * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ssd_bwd_bound(B, S, H, P, N, q, init, dfinal) -> tuple:
    """Least time for the SSD backward: the larger of the operations of its
    products at chunk q (``ssd_scan.ssd_bwd_flops``) at the bf16 peak, and
    the bytes of the function's own operands once each: x, dy, dt, a, b,
    c, the initial state and the final state's cotangent where given in,
    dx, ddt, da, db, dc and dinit (where there is an initial state) out.
    What the design moves besides (``ssd_bwd_design_bytes``) is not
    counted."""
    from repro_torch.kernels.ssd_scan import ssd_bwd_flops
    byts = (B * S * H * P * 2 * 3 + B * S * H * 4 * 2 + H * 4 * 2
            + B * S * N * 2 * 4
            + B * H * P * N * 4 * (2 * bool(init) + bool(dfinal)))
    t_ops = ssd_bwd_flops(B, S, H, P, N, q) / PEAK_BF16_OPS * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ssd_bwd_design_bytes(B, S, H, q, P, N) -> int:
    """Bytes the SSD backward's design moves beyond its operands, at the
    (P, N) it runs at: the forward's f32 state entering each chunk, read
    once, and the f32 state cotangent of each chunk, written by
    ``ssd_bwd_state`` and read back by ``ssd_bwd_chunk``."""
    return 3 * B * -(-S // q) * H * P * N * 4


def ssd_bwd_kernel_bytes(B, S, H, q, P, N, dfinal) -> dict:
    """Bytes each launch of the SSD backward moves at the (P, N) it runs
    at, each tensor it reads or writes once (b and c once per batch row,
    though every head reads them): ``ssd_bwd_state`` reads dy, c, dt, a
    and dfinal (where given) and writes the state cotangent G of every
    chunk and dinit; ``ssd_bwd_chunk`` reads x, dy, dt, a, b, c, the
    forward's f32 chunk states and G, and writes dx, ddt, db, dc and da's
    per-chunk partial sums."""
    nc = -(-S // q)
    tokens, heads = B * S * H, B * nc * H
    states = heads * P * N * 4
    return {"ssd_bwd_state": (tokens * P * 2 + B * S * N * 2 + tokens * 4
                              + H * 4 + B * H * P * N * 4 * (1 + bool(dfinal))
                              + states),
            "ssd_bwd_chunk": (tokens * P * 2 * 3 + tokens * 4 * 2 + H * 4
                              + B * S * N * 2 * 4 + 2 * states + heads * 4)}


def ssd_bwd_inputs(torch, gen, dev, B, S, H, P, N, with_init, with_dfinal):
    """The SSD backward's inputs at one shape, from ``gen``: x, b and c as
    slices of one bf16 activation (the model's strides), dt and a from
    Mamba2's ranges, dy bf16, the initial state and the final state's
    cotangent f32 where asked for (else None)."""
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen,
                      device=dev).to(torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt0 = torch.logspace(math.log10(SSD_DT_RANGE[0]),
                         math.log10(SSD_DT_RANGE[1]), H, device=dev)
    dt = torch.nn.functional.softplus(
        dt0 + torch.log(-torch.expm1(-dt0))
        + 0.5 * torch.randn((B, S, H), generator=gen, device=dev))
    a = -torch.linspace(*SSD_A_RANGE, H, device=dev)
    init = (torch.randn((B, H, P, N), generator=gen, device=dev)
            if with_init else None)
    dy = torch.randn((B, S, H, P), generator=gen,
                     device=dev).to(torch.bfloat16)
    dfinal = (torch.randn((B, H, P, N), generator=gen, device=dev)
              if with_dfinal else None)
    return x, dt, a, b, c, init, dy, dfinal


def ssd_bwd_faults(ss, x, dt, a, b, c, init, dy, dfinal, want) -> dict:
    """Plain renderings of the faults the SSD backward's bar must catch,
    each the largest normalised error of the gradients it changes against
    ``want`` (``ssd_scan_bwd_plain``'s at KERNEL_CHUNK): the state
    cotangent not carried across chunk boundaries (each chunk of
    KERNEL_CHUNK tokens on its own, from the state the forward hands it,
    with no cotangent from the chunks after it), dB and dC from head 0
    only, the off-chunk term dropped from d cum, and ddt without its
    d(dA) a term.  S is a multiple of KERNEL_CHUNK."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    q = ss.KERNEL_CHUNK
    dx_w, ddt_w, da_w, db_w, dc_w, _ = want

    def worst(got, keys):
        names = ("dx", "ddt", "da", "db", "dc")
        return max(norm_err(got[names.index(k)], want[names.index(k)])
                   for k in keys)

    if S % q:
        raise ValueError(f"S {S} is not a multiple of {q}: pad it with "
                         "ss.pad_tokens")
    faults = {}
    if S > q:
        nc = S // q
        st = ss.ssd_chunk_states_plain(x, dt, a, b, c, init)

        def chunks(t):
            return t.reshape(B * nc, q, *t.shape[2:])

        got = ss.ssd_scan_bwd_plain(
            chunks(x), chunks(dt), a, chunks(b), chunks(c), q,
            st.reshape(B * nc, H, P, N), chunks(dy), None)
        got = (got[0].reshape(B, S, H, P), got[1].reshape(B, S, H), got[2],
               got[3].reshape(B, S, N), got[4].reshape(B, S, N))
        faults["state cotangent not carried"] = worst(
            got, ("dx", "ddt", "db", "dc"))
    got = ss.ssd_scan_bwd_plain(
        x[:, :, :1], dt[:, :, :1], a[:1], b, c, q,
        None if init is None else init[:, :1], dy[:, :, :1],
        None if dfinal is None else dfinal[:, :1])
    faults["dB, dC from head 0"] = worst(got, ("db", "dc"))
    terms = ss.ssd_scan_bwd_terms(x, dt, a, b, c, q, init, dy, dfinal)
    off = terms["dcum_off"].reshape(B, S // q, q, H)   # its reverse cumsum
    off = off.flip(2).cumsum(2).flip(2).reshape(B, S, H)
    faults["off-chunk term dropped from d cum"] = max(
        norm_err(ddt_w - off * a, ddt_w),
        norm_err(da_w - (off * dt).sum(dim=(0, 1)), da_w))
    faults["ddt without d(dA) a"] = norm_err(ddt_w - terms["ddA"] * a, ddt_w)
    return faults


def sdpa_mask(torch, Sq, Sk, causal, window, prefix, device):
    """The boolean [Sq, Sk] mask of these bounds, or None where there is
    none or ``is_causal`` says it."""
    if not (window and window < Sk) and not prefix:
        return None
    pq = torch.arange(Sq, device=device)[:, None]
    pk = torch.arange(Sk, device=device)[None, :]
    mask = (pq - pk >= 0) if causal else torch.ones((Sq, Sk), dtype=torch.bool,
                                                   device=device)
    if window:
        mask = mask & (pq - pk < window)
    if prefix:
        mask = mask | (pk < prefix)
    return mask


def sdpa_ms(torch, q, k, v, causal, window, prefix=0, backend=False,
            scale=None):
    """Time of one ``scaled_dot_product_attention`` call on the same inputs,
    mask and scale (GQA through ``enable_gqa``), or None if this torch has
    no such call for them; with ``backend``, (time, the backend's operator
    that the
    dispatcher called, as ``torch.profiler`` shows it: flash, efficient,
    cudnn or math attention).  A yardstick only: the port never calls it."""
    import torch.nn.functional as F
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = sdpa_mask(torch, q.shape[1], k.shape[1], causal, window, prefix,
                     q.device)

    def call():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            scale=scale, enable_gqa=True)

    try:
        ms = event_ms(torch, call, 20)
    except (RuntimeError, TypeError) as exc:
        print(f"  sdpa yardstick unavailable: {exc}", flush=True)
        return (None, None) if backend else None
    if not backend:
        return ms
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
        torch.cuda.synchronize()
    ops = sorted({e.key for e in prof.key_averages()
                  if e.key.startswith("aten::_scaled_dot_product")})
    return ms, "+".join(ops) or "not seen by the profiler"


def sdpa_bwd_ms(torch, q, k, v, do, causal, window, prefix=0, scale=None):
    """Time of the backward alone of one ``scaled_dot_product_attention``
    call on the same inputs, mask and scale (GQA through ``enable_gqa``), or
    None if this torch has none for them.  A yardstick only."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    mask = sdpa_mask(torch, q.shape[1], k.shape[1], causal, window, prefix,
                     q.device)
    try:
        out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            scale=scale, enable_gqa=True)
        dot = do.transpose(1, 2)
        return event_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 10)
    except (RuntimeError, TypeError) as exc:
        print(f"  sdpa backward yardstick unavailable: {exc}", flush=True)
        return None


def check_schedule(checks, res, n: int, name: str):
    """Eq. 7 conservation, one live record per task, finite energies."""
    run = sum(a.energy for a in res.assignments)
    books = run + res.e_idle + res.e_overhead
    checks.expect(abs(res.e_total - books) <= 1e-9 * abs(res.e_total),
                  f"{name}: Eq. 7 conservation {res.e_total} vs {books}")
    live = [a.task for a in res.assignments if not a.failed]
    checks.expect(len(live) == n and len(set(live)) == n,
                  f"{name}: {len(live)} live records, {len(set(live))} "
                  f"distinct tasks, {n} tasks")
    checks.expect(all(math.isfinite(a.energy) and a.energy >= 0.0
                      for a in res.assignments) and res.e_total > 0,
                  f"{name}: energies finite and positive")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Build the port's CUDA kernels and drive the scheduler "
                    "on one CUDA card; exits non-zero on any failed check.")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the fuzz rows (default 0)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dvfs, online, scheduling, solver_cache, tasks
    from repro_torch.kernels import build, dvfs_opt, ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    checks = Checks()
    dev = torch.device("cuda")
    g0, g1 = dvfs_opt.DEFAULT_GRID

    # ---- phase 1: build.
    t = time.perf_counter()
    log = io.StringIO()
    try:
        with contextlib.redirect_stderr(log):
            build.build(verbose=True)
    finally:
        print(log.getvalue(), end="", file=sys.stderr, flush=True)
    print(f"phase build: {time.perf_counter() - t:.2f} s for "
          f"{len(build.KERNELS)} kernel(s) {build.KERNELS}", flush=True)
    bwd = [row for row in ptxas_table(log.getvalue())
           if row["kernel"].startswith("flash_bwd")]
    for row in bwd:
        print(f"phase build ptxas {row['kernel']}<{row['args']}>: "
              f"{row['registers']} registers, {row['stack']} bytes stack, "
              f"{row['spill_stores']} / {row['spill_loads']} bytes spill "
              "stores / loads", flush=True)
    # The backward's kernels (dQ and dK/dV, with and without a prefix, at
    # four head dims) run with no stack and no spills at the head dims the
    # models train at; dh 256 is held by its time.
    checks.expect(len(bwd) == 2 * 2 * 4,
                  f"build: ptxas lines of {len(bwd)} backward kernels, 16 "
                  "expected")
    spilled = [f"{row['kernel']}<{row['args']}>" for row in bwd
               if row["args"].split(",")[0] in ("64", "80", "128")
               and (row["stack"] or row["spill_stores"]
                    or row["spill_loads"])]
    checks.expect(not spilled, f"build: stack or spills in {spilled}")
    # The SSD kernels (the forward with and without its chunk states, the
    # backward's state cotangent with one and two heads a block, and its
    # chunk kernel) run with no stack and no spills.
    ssd = [row for row in ptxas_table(log.getvalue())
           if row["kernel"].startswith("ssd_")]
    for row in ssd:
        print(f"phase build ptxas {row['kernel']}<{row['args']}>: "
              f"{row['registers']} registers, {row['stack']} bytes stack, "
              f"{row['spill_stores']} / {row['spill_loads']} bytes spill "
              "stores / loads", flush=True)
    checks.expect(sorted(f"{r['kernel']}<{r['args']}>" for r in ssd) == [
        "ssd_bwd_chunk<>", "ssd_bwd_state<1>", "ssd_bwd_state<2>",
        "ssd_fwd<64, 128, no states>", "ssd_fwd<64, 128, states>"],
                  f"build: ptxas lines of the SSD "
                  f"kernels {[(r['kernel'], r['args']) for r in ssd]}")
    spilled = [f"{row['kernel']}<{row['args']}>" for row in ssd
               if row["stack"] or row["spill_stores"] or row["spill_loads"]]
    checks.expect(not spilled, f"build: stack or spills in {spilled}")
    # The causal conv's kernels (forward and backward at widths 1 to 4 and
    # 4, 2 or 1 channels a load, and the backward's sum) run with no stack
    # and no spills.
    conv_rows = [row for row in ptxas_table(log.getvalue())
                 if row["kernel"].startswith("causal_conv1d")]
    for row in conv_rows:
        if row["args"] in ("4, 4", ""):
            print(f"phase build ptxas {row['kernel']}<{row['args']}>: "
                  f"{row['registers']} registers, {row['stack']} bytes "
                  f"stack, {row['spill_stores']} / {row['spill_loads']} "
                  "bytes spill stores / loads", flush=True)
    checks.expect(len(conv_rows) == 2 * 4 * 3 + 1,
                  f"build: ptxas lines of {len(conv_rows)} causal conv "
                  "kernels, 25 expected")
    spilled = [f"{row['kernel']}<{row['args']}>" for row in conv_rows
               if row["stack"] or row["spill_stores"] or row["spill_loads"]]
    checks.expect(not spilled, f"build: stack or spills in {spilled}")

    # ---- phase 2: the kernel against its plain version on the card.
    mat = fuzz_matrix(np, dvfs, tasks, args.seed, FUZZ_ROWS)
    x = torch.from_numpy(mat).to(dev)
    got = dvfs_opt.dvfs_solve_cuda(x)
    want = dvfs_opt.dvfs_solve_plain(x)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    checks.expect(bool(np.isfinite(got).all()), "kernel: finite output")
    rel = np.abs(got[:, 5] - want[:, 5]) / np.abs(want[:, 5])
    max_rel, med_rel = float(rel.max()), float(np.median(rel))
    max_abs = float(np.abs(got - want).max())
    agree_dp = float(np.mean(got[:, 6] == want[:, 6]))
    agree_feas = float(np.mean(got[:, 7] == want[:, 7]))
    bit_equal = float(np.mean(np.all(got == want, axis=1)))
    checks.expect(max_rel <= 1e-5, f"kernel: energy max rel {max_rel} <= 1e-5")
    checks.expect(med_rel <= 1e-7, f"kernel: energy median rel {med_rel} <= 1e-7")
    checks.expect(agree_dp >= 0.999, f"kernel: deadline_prior agrees {agree_dp}")
    checks.expect(agree_feas >= 0.999, f"kernel: feasible agrees {agree_feas}")
    print(f"phase kernel: {mat.shape[0]} rows, energy max rel {max_rel:.3e}, "
          f"median {med_rel:.3e}, max abs err {max_abs:.3e}, rows bit-equal "
          f"{bit_equal:.6f}, deadline_prior agree {agree_dp:.6f}, feasible "
          f"agree {agree_feas:.6f}", flush=True)

    # The edge rows: NaN and inf inputs, the branches' ends, degenerate and
    # empty boxes.  Bit for bit, a NaN matching a NaN.
    edge = dvfs_opt.edge_rows()
    xe = torch.from_numpy(edge).to(dev)
    got_e = dvfs_opt.dvfs_solve_cuda(xe).cpu().numpy()
    want_e = dvfs_opt.dvfs_solve_plain(xe).cpu().numpy()
    same = (got_e == want_e) | (np.isnan(got_e) & np.isnan(want_e))
    edge_equal = float(np.mean(np.all(same, axis=1)))
    checks.expect(edge_equal == 1.0,
                  f"kernel: edge rows bit-equal {edge_equal}, rows "
                  f"{np.nonzero(~np.all(same, axis=1))[0].tolist()}")
    print(f"phase kernel edge rows: {edge.shape[0]} rows, rows bit-equal "
          f"(NaN-aware) {edge_equal:.6f}, outputs NaN "
          f"{int(np.isnan(got_e).sum())} (plain {int(np.isnan(want_e).sum())})",
          flush=True)

    # Every setting that is a number inside its row's box, on the fuzz and
    # the edge rows, except where the core range is empty.
    all_got, all_mat = np.concatenate([got, got_e]), np.concatenate([mat, edge])
    empty = empty_core_range(np, all_mat)
    out = outside_box(np, all_got, all_mat) & ~empty
    checks.expect(not out.any(), f"kernel: {int(out.sum())} rows with v, fc "
                  "or fm outside the row's box (1e-4)")
    print(f"phase kernel in box: {all_mat.shape[0] - int(empty.sum())} rows "
          f"checked, {int(out.sum())} outside; skipped only the "
          f"{int(empty.sum())} empty-box rows (fc_min > g1(v_max), where the "
          f"solvers return fc = g1(v_max) < fc_min)", flush=True)
    # Other grids than the main path's: at (16, 4) and (8, 8) some lanes of
    # a row have no sweep point, and (8192, 8192) needs more than 48 KB of
    # shared memory for the fractions.  The edge rows and the first and last
    # GRID_ROWS rows of the fuzz matrix (the last are app-library rows).
    xg = torch.cat([x[:GRID_ROWS], x[-GRID_ROWS:], xe])
    for grid in OTHER_GRIDS:
        got_g = dvfs_opt.dvfs_solve_cuda(xg, grid).cpu().numpy()
        want_g = dvfs_opt.dvfs_solve_plain(xg, grid).cpu().numpy()
        same_g = np.all((got_g == want_g) | (np.isnan(got_g)
                                             & np.isnan(want_g)), axis=1)
        checks.expect(bool(same_g.all()),
                      f"kernel: grid {grid}: {int((~same_g).sum())} rows "
                      "differ from the plain version")
        print(f"phase kernel grid {grid}: {xg.shape[0]} rows, rows "
              f"bit-equal (NaN-aware) {float(same_g.mean()):.6f}", flush=True)
    del xe, xg

    # ---- phase 3: the online main path (the kernel) and its grid+golden twin.
    day = tasks.generate_trace(100_000, "uniform", seed=0)
    runs = {}
    for use_kernel in (True, False):
        solver_cache.GLOBAL_CACHE.clear()
        dvfs_opt.dvfs_solve_cuda.launches = 0
        with launch_rows(ops) as rows:
            t = time.perf_counter()
            res = online.schedule_online(day, l=4, theta=0.9,
                                         algorithm="edl", classes=CLASSES,
                                         use_kernel=use_kernel, pipeline=True,
                                         device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        runs[use_kernel] = (res, wall, dvfs_opt.dvfs_solve_cuda.launches, rows)
        check_schedule(checks, res, len(day), f"online use_kernel={use_kernel}")
    (rk, wk, launches_online, rows_online), (rp, wp, launches_plain, _) = (
        runs[True], runs[False])
    checks.expect(len(rows_online) == launches_online,
                  f"online: {len(rows_online)} launches recorded, counter "
                  f"{launches_online}")
    print(f"phase online launches: rows a launch {rows_online}", flush=True)
    checks.expect(launches_online > 0,
                  f"online: kernel launched {launches_online} times")
    checks.expect(launches_plain == 0,
                  f"online grid+golden run launched the kernel {launches_plain} times")
    e_rel = abs(rk.e_total - rp.e_total) / rp.e_total
    checks.expect(e_rel <= 2e-3, f"online: e_total rel {e_rel} <= 2e-3")
    checks.expect(rk.violations == rp.violations,
                  f"online: violations {rk.violations} vs {rp.violations}")
    print(f"phase online: {len(day)} tasks, classes {CLASSES}, kernel "
          f"launches {launches_online}, e_total {rk.e_total:.6f} vs "
          f"grid+golden {rp.e_total:.6f} (rel {e_rel:.3e}), violations "
          f"{rk.violations}, pairs {rk.n_pairs}, {len(day) / wk:.1f} tasks/s "
          f"({wk:.3f} s) vs {len(day) / wp:.1f} tasks/s ({wp:.3f} s) "
          f"grid+golden", flush=True)

    # The kernel run once more under both profilers: the device's busy time
    # by kernel and its idle share of the wall (torch.profiler, device
    # activity only), and the host's time by layer (cProfile, which slows
    # Python-heavy layers more than numpy-heavy ones).
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    solver_cache.GLOBAL_CACHE.clear()
    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        host.enable()
        online.schedule_online(day, l=4, theta=0.9, algorithm="edl",
                               classes=CLASSES, use_kernel=True,
                               pipeline=True, device=dev)
        torch.cuda.synchronize()
        host.disable()
        wall = time.perf_counter() - t
    spans = sorted(device_events(prof),
                   key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in spans) / 1e3
    top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in spans[:6])
    day_dvfs_ms, day_dvfs_n = device_split(spans, "dvfs_opt_kernel")[0]["kernel"]
    print(f"phase online profile: wall {wall:.3f} s under the profilers, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / 1e3 / wall:.4f}; dvfs_opt_kernel "
          f"{day_dvfs_ms:.4f} ms x{day_dvfs_n}; device top: {top}", flush=True)
    layers = {  # (module file, function) -> layer; cumulative host seconds
        ("online.py", "place_group"): "placement",
        ("online.py", "dispatch"): "solve dispatch (config + readjust)",
        ("online.py", "consume_sync"): "config sync + assembly",
        ("online.py", "flush_sync"): "readjust sync + write-back",
        ("online.py", "_floors_sync"): "t_min floors",
        ("bounds.py", "theoretical_bound"): "e_bound solve",
        ("engine.py", "finalize"): "engine finalize",
        ("solver_cache.py", "get_many"): "  of which cache probe",
        ("solver_cache.py", "_materialize"): "  of which device -> host copy",
    }
    spent = dict.fromkeys(layers.values(), 0.0)
    for (path, _, func), (_, _, _, cum, _) in pstats.Stats(host).stats.items():
        layer = layers.get((Path(path).name, func))
        if layer is not None:
            spent[layer] += cum
    print("phase online host layers (cProfile, cumulative s): "
          + "; ".join(f"{k} {v:.3f}" for k, v in spent.items()), flush=True)

    # ---- phase 4: the offline batch.
    batch = tasks.generate_offline_n(20_000, seed=0)
    runs = {}
    for use_kernel in (True, False):
        solver_cache.GLOBAL_CACHE.clear()
        dvfs_opt.dvfs_solve_cuda.launches = 0
        with launch_rows(ops) as rows:
            t = time.perf_counter()
            res = scheduling.schedule_offline(batch, l=4, theta=0.9,
                                              algorithm="edl", classes=CLASSES,
                                              use_kernel=use_kernel, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        runs[use_kernel] = (res, wall, dvfs_opt.dvfs_solve_cuda.launches, rows)
        check_schedule(checks, res, len(batch), f"offline use_kernel={use_kernel}")
    (ok_, wk, launches_offline, rows_offline), (op_, wp, _, _) = (
        runs[True], runs[False])
    checks.expect(len(rows_offline) == launches_offline,
                  f"offline: {len(rows_offline)} launches recorded, counter "
                  f"{launches_offline}")
    print(f"phase offline launches: rows a launch {rows_offline}", flush=True)
    checks.expect(launches_offline > 0,
                  f"offline: kernel launched {launches_offline} times")
    e_rel = abs(ok_.e_total - op_.e_total) / op_.e_total
    checks.expect(e_rel <= 2e-3, f"offline: e_total rel {e_rel} <= 2e-3")
    checks.expect(ok_.violations == op_.violations,
                  f"offline: violations {ok_.violations} vs {op_.violations}")
    print(f"phase offline: {len(batch)} tasks, kernel launches "
          f"{launches_offline}, e_total {ok_.e_total:.6f} vs grid+golden "
          f"{op_.e_total:.6f} (rel {e_rel:.3e}), violations {ok_.violations}, "
          f"{len(batch) / wk:.1f} tasks/s ({wk:.3f} s) vs "
          f"{len(batch) / wp:.1f} tasks/s ({wp:.3f} s) grid+golden", flush=True)

    # The kernel's time at the online day's median launch, at the day's
    # Algorithm-1 work as one batch and at 1M rows, on the fuzz rows: by
    # CUDA events around calls back to back, and its device time alone by
    # the profiler (at a few hundred rows the host's launch work is longer
    # than the kernel, and the events time that).
    med_rows = statistics.median_low(rows_online or [MAIN_ROWS])
    timing = {}
    for rows in (med_rows, MAIN_ROWS, FUZZ_ROWS):
        xs = x[:rows].contiguous()
        k_ms = event_ms(torch, lambda: dvfs_opt.dvfs_solve_cuda(xs), 20)
        d_ms = device_ms(torch, lambda: dvfs_opt.dvfs_solve_cuda(xs),
                         ("dvfs_opt_kernel",), 20)["dvfs_opt_kernel"]
        p_ms = event_ms(torch, lambda: dvfs_opt.dvfs_solve_plain(xs), 5)
        b_ms, b_by = bound_ms(rows, g0, g1)
        timing[rows] = (k_ms, p_ms, b_ms, b_by, d_ms)
        d_txt = "not measured" if d_ms is None else f"{d_ms:.4f} ms"
        print(f"phase kernel timing: {rows} rows: kernel {k_ms:.4f} ms "
              f"(device {d_txt}), "
              f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{ops_per_row(g0, g1)} ops and {BYTES_ROW} bytes a row), "
              f"kernel at {b_ms / k_ms:.1%} of the bound", flush=True)
    del x, xs
    torch.cuda.empty_cache()

    attn = attention_phase(checks, torch, dev, args.seed)
    ssd = ssd_phase(checks, torch, dev, args.seed)
    ssd_hybrid = ssd_phase(checks, torch, dev, args.seed, "granite",
                           SSD_HYBRID_SHAPE)
    attn_family = family_attention_phase(checks, torch, dev, args.seed)
    ssd_pad = ssd_pad_phase(checks, torch, dev, args.seed)
    jobs = jobs_phase(checks, torch, dev)
    serve = {arch: serve_phase(checks, np, torch, dev, arch, layers,
                               args.seed)
             for arch, layers in SERVE_ARCHS}
    attn_bwd = attention_bwd_phase(checks, torch, dev, args.seed)
    ssd_bwd = ssd_bwd_phase(checks, torch, dev, args.seed)
    conv = causal_conv_phase(checks, torch, dev, args.seed)
    adamw = adamw_phase(checks, np, torch, dev, args.seed)
    train = train_danube_phase(checks, np, torch, dev, args.seed)
    train_ssm = train_mamba2_phase(checks, np, torch, dev, args.seed)
    train_families = train_families_phase(checks, torch, dev, args.seed)
    mesh = mesh_phase(checks, np, torch, dev, args.seed)
    dry = dryrun_phase(checks, np, torch, dev, args.seed)
    tp = tp_phase(checks, np, torch, dev, args.seed)

    if checks.failed:
        print(f"chip_smoke: {len(checks.failed)} check(s) failed",
              file=sys.stderr)
        return 1
    k_main, p_main, b_main, by_main, d_main = timing[MAIN_ROWS]
    k_1m, p_1m, b_1m, _, d_1m = timing[FUZZ_ROWS]
    k_med, p_med, b_med, _, d_med = timing[med_rows]
    print(json.dumps({"kernels": [{
        "name": "dvfs_opt", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dvfs_opt.cu",
        "replaces": "src/repro/kernels/dvfs_opt.py:116",
        "launches": launches_online, "launches_offline": launches_offline,
        "max_abs_err": max_abs, "max_rel": max_rel,
        "ms": k_main, "plain_ms": p_main, "bound_ms": b_main,
        "bound_by": by_main, "library_ms": None,
        "device_ms": d_main, "ms_300k": k_main,
        "ms_1m": k_1m, "device_ms_1m": d_1m, "plain_ms_1m": p_1m,
        "bound_ms_1m": b_1m,
        "median_online_rows": med_rows, "ms_median_online": k_med,
        "device_ms_median_online": d_med,
        "plain_ms_median_online": p_med, "bound_ms_median_online": b_med,
        "launch_rows_online": rows_online, "day_device_ms": day_dvfs_ms,
        "launch_rows_offline": rows_offline, **jobs,
        "mesh_split": mesh["split"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        **attn["serve"], **serve["h2o-danube-1.8b"],
        "long_8192": attn["long"], "edge": attn["edge"],
        **{key: attn[key] for key, _ in ATTN_HEAD_DIMS}, **attn_family,
        "serve": {arch: serve[arch] for arch, _ in SERVE_ARCHS
                  if "flash_attention" in serve[arch]["launches"]},
        "launches_train": train["launches"]["flash_attention"],
        "launches_mesh": mesh["launches"]["flash_attention"],
        "launches_dryrun": dry["launches"]["flash_attention"],
        "launches_tp": [r["flash_attention"] for r in tp.get("launches", [])],
        "tp": tp,
        "opcheck": dry["opcheck"]["flash_attention"],
        "dispatch_us": dry["opcheck"]["dispatch_us"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:96 (jax.grad of "
                    "blockwise_attention; no Pallas backward)",
        "launches": train["launches"]["flash_attention_bwd"],
        **attn_bwd["danube"], "shapes": attn_bwd, "train": train,
        "train_families": train_families,
        "launches_mesh": mesh["launches"]["flash_attention_bwd"],
        "launches_tp": [r["flash_attention_bwd"]
                        for r in tp.get("launches", [])],
        "mesh": {k: v for k, v in mesh.items() if k != "split"},
        "launches_dryrun": dry["launches"]["flash_attention_bwd"],
        "opcheck": dry["opcheck"]["flash_attention_bwd"],
        "dryrun": {k: v for k, v in dry.items()
                   if k not in ("launches", "opcheck")}}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:33",
        **ssd, **serve["mamba2-370m"], **ssd_pad, "granite": ssd_hybrid,
        "serve": {arch: serve[arch] for arch, _ in SERVE_ARCHS
                  if "ssd_scan" in serve[arch]["launches"]},
        "launches_train": train_ssm["launches"]["ssd_scan"],
        "launches_tp": [r["ssd_scan"] for r in tp.get("launches", [])],
        "fwd_states_ms": ssd_bwd["train"]["fwd_states_ms"],
        "opcheck": dry["opcheck"]["ssd_scan"]}, {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:79 (jax.grad of ssd_chunked; "
                    "no Pallas backward)",
        "launches": train_ssm["launches"]["ssd_scan_bwd"],
        "launches_tp": [r["ssd_scan_bwd"] for r in tp.get("launches", [])],
        **{k: v for k, v in ssd_bwd["train"].items()
           if k not in ("fwd_ms", "fwd_states_ms")},
        "max_abs_err": max(row["max_abs_err"] for row in ssd_bwd.values()),
        "shapes": ssd_bwd, "train": train_ssm,
        "opcheck": dry["opcheck"]["ssd_scan_bwd"]}, {
        "name": "adamw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": "none: the JAX package leaves AdamW to XLA",
        **adamw[TRAIN_ARCH], "sets": adamw,
        "launches_train": {"danube": {k: train["launches"][k] for k in (
            "adamw_sq_norms", "adamw_update")},
            "mamba2": {k: train_ssm["launches"][k] for k in (
                "adamw_sq_norms", "adamw_update")}}}, {
        "name": "causal_conv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/causal_conv.cu",
        "replaces": "none: the JAX package leaves Mamba-2's conv "
                    "(src/repro/models/ssm.py:53 _causal_conv) to XLA",
        **conv["granite"], "shapes": conv,
        "serve": {arch: serve[arch]["launches"]["causal_conv"]
                  for arch, _ in SERVE_ARCHS
                  if "causal_conv" in serve[arch]["launches"]},
        "launches_train": {k: train_ssm["launches"][k] for k in (
            "causal_conv", "causal_conv_bwd")},
        "launches_tp": [{k: r[k] for k in ("causal_conv", "causal_conv_bwd")}
                        for r in tp.get("launches", [])],
        "opcheck": {k: dry["opcheck"][k] for k in (
            "causal_conv", "causal_conv_bwd")}}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def attention_phase(checks, torch, dev, seed: int) -> dict:
    """The attention kernel against its plain version at two shapes, both
    timed beside the library call and the bound, and on the edge input;
    at each, plain renderings of mask faults show what the bar catches."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def inputs(B, S, H, KV, dh, q_scale=1.0):
        q, k, v = (torch.randn((B, S, n, dh), generator=gen, device=dev)
                   for n in (H, KV, KV))
        return ((q * q_scale).to(torch.bfloat16), k.to(torch.bfloat16),
                v.to(torch.bfloat16))

    def plain(q_, k_, v_, w):
        return fa.flash_attention_plain(q_, k_, v_, causal=True, window=w)

    def compare(key, q, k, v, window):
        got = fa.flash_attention_cuda(q, k, v, causal=True, window=window)
        want = plain(q, k, v, window)
        err = norm_err(got, want)
        abs_err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got.float()).all())
        checks.expect(finite and err <= ATTN_BAR,
                      f"attention {key}: finite {finite}, norm err {err} <= "
                      f"{ATTN_BAR}")
        # Plain renderings of mask faults, each against the right answer:
        # the diagonal key dropped (row i then sees keys i-W+1..i-1, which is
        # q[1:] over k[:-1] with window W-1, for the rows from 1 on); and
        # where the window binds, the window one key wider or narrower, and
        # one key past the diagonal taken (row i sees i-W+1..i+1: q[:-1]
        # over k[1:] with window W+1, exact for the rows from W on).
        faults = {"diagonal dropped": norm_err(
            plain(q[:, 1:], k[:, :-1], v[:, :-1], window - 1), want[:, 1:])}
        if window < q.shape[1] - 1:
            faults["key past diagonal"] = norm_err(
                plain(q[:, :-1], k[:, 1:], v[:, 1:], window + 1)[:, window:],
                want[:, window:-1])
            faults["window+1"] = norm_err(plain(q, k, v, window + 1), want)
            faults["window-1"] = norm_err(plain(q, k, v, window - 1), want)
        checks.expect(min(faults.values()) > ATTN_BAR,
                      f"attention {key}: every mask fault's norm err {faults} "
                      f"exceeds the bar {ATTN_BAR}")
        return err, abs_err, faults

    def faults_text(faults):
        return ("plain renderings of mask faults, norm err against the right "
                "answer: " + ", ".join(f"{name} {e:.3e}"
                                       for name, e in faults.items()))

    out = {}
    for key, (B, S, H, KV, dh, window) in ATTN_SHAPES:
        q, k, v = inputs(B, S, H, KV, dh)
        err, abs_err, faults = compare(key, q, k, v, window)
        k_ms = event_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, causal=True, window=window), 20)
        p_ms = event_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal=True, window=window), 20)
        lib_ms = sdpa_ms(torch, q, k, v, True, window)
        b_ms, b_by = attention_bound(B, H, KV, S, dh, True, window)
        out[key] = {"max_abs_err": abs_err, "norm_err": err, "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "fault_norm_errs": faults,
                    "shape": [B, S, H, KV, dh, "causal", window]}
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"phase attention kernel {key}: B {B} S {S} H {H} KV {KV} dh "
              f"{dh} causal window {window}: norm err {err:.3e}, max abs err "
              f"{abs_err:.3e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"sdpa {lib}, bound {b_ms:.4f} ms ({b_by}), kernel at "
              f"{b_ms / k_ms:.1%} of the bound; {faults_text(faults)}",
              flush=True)
        del q, k, v

    for key, (B, S, H, KV, dh, window) in (("edge", ATTN_EDGE),
                                           *ATTN_HEAD_DIMS):
        q, k, v = inputs(B, S, H, KV, dh, ATTN_EDGE_Q_SCALE)
        err, abs_err, faults = compare(key, q, k, v, window)
        k_ms = event_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, causal=True, window=window), 20)
        out[key] = {"max_abs_err": abs_err, "norm_err": err, "ms": k_ms,
                    "fault_norm_errs": faults,
                    "shape": [B, S, H, KV, dh, "causal", window,
                              f"q x{ATTN_EDGE_Q_SCALE}"]}
        print(f"phase attention kernel {key}: B {B} S {S} H {H} KV {KV} dh "
              f"{dh} causal window {window}, q x{ATTN_EDGE_Q_SCALE}: norm "
              f"err {err:.3e}, max abs err {abs_err:.3e}; kernel "
              f"{k_ms:.4f} ms; {faults_text(faults)}", flush=True)
        del q, k, v
    torch.cuda.empty_cache()
    return out


def family_attention_phase(checks, torch, dev, seed: int) -> dict:
    """The attention kernel against its plain version at the shapes of
    ``ATTN_FAMILY_SHAPES``, with plain renderings of the faults each shape
    can show, each timed beside the plain version, SDPA and the bound;
    at a shape of ``ATTN_SCALES``, with that scale throughout."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    out = {}
    for key, (B, Sq, Sk, H, KV, dh), causal, window, prefix in (
            ATTN_FAMILY_SHAPES):
        scale = ATTN_SCALES.get(key)
        q_scale = ATTN_EDGE_Q_SCALE * (1.0 if scale is None
                                       else dh ** -0.5 / scale)
        q = torch.randn((B, Sq, H, dh), generator=gen, device=dev)
        q = (q * q_scale).to(torch.bfloat16)
        k, v = (torch.randn((B, Sk, KV, dh), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))

        def plain(q_, k_, v_, causal_=causal, window_=window, prefix_=prefix,
                  scale_=scale):
            return fa.flash_attention_plain(q_, k_, v_, causal=causal_,
                                            window=window_,
                                            bidirectional_prefix=prefix_,
                                            scale=scale_)

        def kernel():
            return fa.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, prefix=prefix,
                                           scale=scale)

        got, want = kernel(), plain(q, k, v)
        err = norm_err(got, want)
        abs_err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got.float()).all())
        checks.expect(finite and err <= ATTN_BAR,
                      f"attention {key}: finite {finite}, norm err {err} <= "
                      f"{ATTN_BAR}")
        # Plain renderings of the faults the shape can show, each against
        # the right answer (see compare() in attention_phase for the shifted
        # ones): the diagonal dropped and the window's edges where causal,
        # the last key dropped and a causal mask where there is none, the
        # prefix a key short or long or ignored.
        faults = {}
        if prefix:
            for name, pre in (("prefix one key short", prefix - 1),
                              ("prefix one key long", prefix + 1),
                              ("prefix ignored", 0)):
                faults[name] = norm_err(plain(q, k, v, prefix_=pre), want)
        elif causal:
            w1 = None if window is None else window - 1
            faults["diagonal dropped"] = norm_err(
                plain(q[:, 1:], k[:, :-1], v[:, :-1], window_=w1),
                want[:, 1:])
            if window is not None and window < Sq - 1:
                faults["key past diagonal"] = norm_err(
                    plain(q[:, :-1], k[:, 1:], v[:, 1:],
                          window_=window + 1)[:, window:],
                    want[:, window:-1])
                faults["window+1"] = norm_err(plain(q, k, v,
                                                    window_=window + 1), want)
                faults["window-1"] = norm_err(plain(q, k, v,
                                                    window_=window - 1), want)
        else:
            faults["last key dropped"] = norm_err(
                plain(q, k[:, :-1], v[:, :-1]), want)
            faults["causal mask taken"] = norm_err(
                plain(q, k, v, causal_=True), want)
        if scale is not None:
            faults["default scale"] = norm_err(plain(q, k, v, scale_=None),
                                               want)
        checks.expect(min(faults.values()) > ATTN_BAR,
                      f"attention {key}: every fault's norm err {faults} "
                      f"exceeds the bar {ATTN_BAR}")
        del got, want
        k_ms = event_ms(torch, kernel, 20)
        p_ms = event_ms(torch, lambda: plain(q, k, v), 3)
        lib_ms, backend = sdpa_ms(torch, q, k, v, causal, window, prefix,
                                  backend=True, scale=scale)
        b_ms, b_by = attention_bound(B, H, KV, Sq, dh, causal, window, Sk,
                                     prefix)
        out[key] = {"max_abs_err": abs_err, "norm_err": err, "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "library_kernel": backend,
                    "fault_norm_errs": faults,
                    "shape": [B, Sq, Sk, H, KV, dh,
                              "causal" if causal else "non-causal", window,
                              prefix, f"q x{q_scale}"],
                    "scale": dh ** -0.5 if scale is None else scale,
                    "kernel_head_dim": fa.kernel_head_dim(dh)}
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms ({backend})"
        print(f"phase attention kernel {key}: B {B} Sq {Sq} Sk {Sk} H {H} KV "
              f"{KV} dh {dh} (kernel dh {fa.kernel_head_dim(dh)}) "
              f"{'causal' if causal else 'non-causal'} window {window} "
              f"prefix {prefix}, scale {out[key]['scale']}, q x{q_scale}: "
              f"norm err {err:.3e}, "
              f"max abs err {abs_err:.3e}; kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, sdpa {lib}, bound {b_ms:.4f} ms ({b_by}), "
              f"kernel at {b_ms / k_ms:.1%} of the bound; plain renderings "
              "of faults, norm err against the right answer: "
              + ", ".join(f"{name} {e:.3e}" for name, e in faults.items()),
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return out


def ssd_pad_phase(checks, torch, dev, seed: int) -> dict:
    """The SSD kernel at (P, N) it runs zero-padded, against the plain
    version (y and the final state), with the carry-dropped rendering; both
    timed beside the bound of the real shape."""
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    out = {}
    for B, S, H, P, N in SSD_PAD_SHAPES:
        x = torch.randn((B, S, H, P), generator=gen,
                        device=dev).to(torch.bfloat16)
        b, c = (torch.randn((B, S, N), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        dt0 = torch.logspace(math.log10(SSD_DT_RANGE[0]),
                             math.log10(SSD_DT_RANGE[1]), H, device=dev)
        dt = torch.nn.functional.softplus(
            dt0 + torch.log(-torch.expm1(-dt0))
            + 0.5 * torch.randn((B, S, H), generator=gen, device=dev))
        a = -torch.linspace(*SSD_A_RANGE, H, device=dev)
        y, fin = ss.ssd_scan_cuda(x, dt, a, b, c)
        y_ref, fin_ref = ss.ssd_scan_plain(x, dt, a, b, c, 256)
        errs = {"y": norm_err(y, y_ref), "final_state": norm_err(fin, fin_ref)}
        finite = bool(torch.isfinite(y.float()).all()
                      and torch.isfinite(fin).all())
        shapes_ok = (tuple(y.shape) == (B, S, H, P)
                     and tuple(fin.shape) == (B, H, P, N))
        checks.expect(finite and shapes_ok and max(errs.values()) <= SSD_BAR,
                      f"ssd ({P}, {N}): finite {finite}, shapes {shapes_ok}, "
                      f"norm errs {errs} <= {SSD_BAR}")
        q = ss.KERNEL_CHUNK
        nc = S // q

        def chunks(t):
            return t.reshape(B * nc, q, *t.shape[2:])

        y_drop, _ = ss.ssd_scan_plain(chunks(x), chunks(dt), a, chunks(b),
                                      chunks(c), q)
        fault = norm_err(y_drop.reshape(B, S, H, P), y_ref)
        checks.expect(fault > SSD_BAR, f"ssd ({P}, {N}): carry-dropped "
                      f"norm err {fault} exceeds the bar {SSD_BAR}")
        k_ms = event_ms(torch, lambda: ss.ssd_scan_cuda(x, dt, a, b, c), 20)
        p_ms = event_ms(torch, lambda: ss.ssd_scan_plain(x, dt, a, b, c,
                                                         256), 5)
        b_ms, b_by = ssd_bound(B, S, H, P, N, q)
        key = f"pad_p{P}_n{N}"
        out[key] = {"norm_err": errs["y"],
                    "final_state_norm_err": errs["final_state"],
                    "max_abs_err": (y.float() - y_ref.float()).abs().max()
                    .item(), "carry_dropped_norm_err": fault, "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None, "shape": [B, S, H, P, N]}
        print(f"phase ssd kernel padded: B {B} S {S} H {H} P {P} N {N} (run "
              f"at P {ss.KERNEL_P}, N {ss.KERNEL_N}): norm err y "
              f"{errs['y']:.3e}, final state {errs['final_state']:.3e}; carry "
              f"dropped {fault:.3e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}) of the real shape, kernel "
              f"at {b_ms / k_ms:.1%} of it", flush=True)
        del x, b, c, dt, y, fin, y_ref, fin_ref, y_drop
        torch.cuda.empty_cache()
    return out


def jobs_phase(checks, torch, dev) -> dict:
    """``launch/energy_sched.py``'s day on the three-class fleet through the
    ``dvfs_opt`` kernel against the same day through the torch grid+golden
    solvers on the card: e_total within 2e-3, the same violations, Eq. 7
    conservation and one live record per job on both."""
    from repro_torch.core import solver_cache
    from repro_torch.kernels import dvfs_opt
    from repro_torch.launch import energy_sched

    jobs, ts = energy_sched.day_jobs()
    runs = {}
    for use_kernel in (True, False):
        solver_cache.GLOBAL_CACHE.clear()
        dvfs_opt.dvfs_solve_cuda.launches = 0
        t = time.perf_counter()
        r_dvfs, r_base = energy_sched.schedule_day(
            ts, classes=CLASSES, use_kernel=use_kernel, device=dev)
        torch.cuda.synchronize()
        runs[use_kernel] = (r_dvfs, r_base, time.perf_counter() - t,
                            dvfs_opt.dvfs_solve_cuda.launches)
        for name, res in (("dvfs", r_dvfs), ("no-DVFS", r_base)):
            check_schedule(checks, res, len(jobs),
                           f"jobs {name} use_kernel={use_kernel}")
    (rk, bk, wk, launches), (rp, bp, wp, launches_plain) = runs[True], runs[False]
    checks.expect(launches > 0 and launches_plain == 0,
                  f"jobs: kernel launches {launches} (grid+golden run "
                  f"{launches_plain})")
    e_rel = abs(rk.e_total - rp.e_total) / rp.e_total
    checks.expect(e_rel <= 2e-3, f"jobs: e_total rel {e_rel} <= 2e-3")
    checks.expect(rk.violations == rp.violations,
                  f"jobs: violations {rk.violations} vs {rp.violations}")
    saving = 1.0 - rk.e_total / bk.e_total
    print(f"phase jobs: {len(jobs)} LM jobs, classes {CLASSES}, kernel "
          f"launches {launches}, e_total {rk.e_total:.6f} vs grid+golden "
          f"{rp.e_total:.6f} (rel {e_rel:.3e}), violations {rk.violations}, "
          f"total-energy saving against no DVFS {saving:.1%}, "
          f"{wk:.3f} s vs {wp:.3f} s grid+golden (both with the no-DVFS "
          f"baseline)", flush=True)
    return {"launches_jobs": launches, "jobs_e_rel": e_rel}


def ssd_phase(checks, torch, dev, seed: int, key: str = "mamba2",
              shape: tuple = SSD_SHAPE) -> dict:
    """The SSD kernel against its plain version at ``shape`` (B, S, H, P,
    N), mamba2-370m's serving shape by default, x/b/c as strided slices of
    one activation as the model passes them, without and with an initial
    state; plain renderings of carry faults show what the bar catches; both
    versions timed beside the bound."""
    from repro_torch.kernels import ssd_scan as ss

    B, S, H, P, N = shape
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen,
                      device=dev).to(torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    # One head at each point of Mamba2's ranges, spread evenly (head 0 the
    # longest-lived): dt = softplus(dt_bias + a token's own term), with
    # softplus(dt_bias) log-spaced over SSD_DT_RANGE.
    dt0 = torch.logspace(math.log10(SSD_DT_RANGE[0]),
                         math.log10(SSD_DT_RANGE[1]), H, device=dev)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))         # softplus^-1
    dt = torch.nn.functional.softplus(
        dt_bias + 0.5 * torch.randn((B, S, H), generator=gen, device=dev))
    a = -torch.linspace(*SSD_A_RANGE, H, device=dev)

    def compare(what, init, n=S):
        args = (x[:, :n], dt[:, :n], a, b[:, :n], c[:, :n])
        y, fin = ss.ssd_scan_cuda(*args, init)
        y_ref, fin_ref = ss.ssd_scan_plain(*args, 256, init)
        errs = {"y": norm_err(y, y_ref), "final_state": norm_err(fin, fin_ref)}
        finite = bool(torch.isfinite(y.float()).all()
                      and torch.isfinite(fin).all())
        checks.expect(finite and max(errs.values()) <= SSD_BAR,
                      f"ssd {key} {what}: finite {finite}, norm errs {errs} "
                      f"<= {SSD_BAR}")
        abs_err = (y.float() - y_ref.float()).abs().max().item()
        return y_ref, fin_ref, errs, abs_err

    y_ref, fin_ref, errs, abs_err = compare("zero initial state", None)
    # A continuation segment of SSD_INIT_LEN tokens from the state a previous
    # segment of the same stream would hand over (short enough that the
    # initial state still shows in the final one), and the same segment
    # from zero.
    n = SSD_INIT_LEN
    y_init, fin_init, errs_init, _ = compare("initial state", fin_ref, n)
    y_zero, fin_zero = ss.ssd_scan_plain(x[:, :n], dt[:, :n], a, b[:, :n],
                                         c[:, :n], 256)

    # Plain renderings of carry faults, each against the right answer: the
    # state dropped at every one of the kernel's chunk boundaries (each
    # KERNEL_CHUNK tokens scanned from zero), and the initial state ignored.
    q = ss.KERNEL_CHUNK
    nc = S // q

    def chunks(t):
        return t.reshape(B * nc, q, *t.shape[2:])

    y_drop, fin_drop = ss.ssd_scan_plain(chunks(x), chunks(dt), a, chunks(b),
                                         chunks(c), q)
    faults = {
        "carry dropped: y": norm_err(y_drop.reshape(B, S, H, P), y_ref),
        "carry dropped: final state": norm_err(
            fin_drop.reshape(B, nc, H, P, N)[:, -1], fin_ref),
        "initial state ignored: y": norm_err(y_zero, y_init),
        "initial state ignored: final state": norm_err(fin_zero, fin_init),
    }
    checks.expect(min(faults.values()) > SSD_BAR,
                  f"ssd {key}: every carry fault's norm err {faults} exceeds "
                  f"the bar {SSD_BAR}")
    k_ms = event_ms(torch, lambda: ss.ssd_scan_cuda(x, dt, a, b, c), 20)
    p_ms = event_ms(torch, lambda: ss.ssd_scan_plain(x, dt, a, b, c, 256), 20)
    b_ms, b_by = ssd_bound(B, S, H, P, N, q)
    print(f"phase ssd kernel {key}: B {B} S {S} H {H} P {P} N {N}, dt from "
          f"{SSD_DT_RANGE}, -a from {SSD_A_RANGE}: norm err y "
          f"{errs['y']:.3e}, final state {errs['final_state']:.3e} (max abs "
          f"err y {abs_err:.3e}); over {n} tokens from an initial state y "
          f"{errs_init['y']:.3e}, final state {errs_init['final_state']:.3e}; "
          f"plain renderings of carry faults, norm err against the right "
          f"answer: " + ", ".join(f"{name} {e:.3e}"
                                  for name, e in faults.items())
          + f"; kernel {k_ms:.4f} ms, plain (chunk 256) {p_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), kernel at {b_ms / k_ms:.1%} of the bound",
          flush=True)
    del xbc, x, b, c, dt, y_ref, fin_ref, y_init, fin_init, y_drop, fin_drop
    del y_zero, fin_zero
    torch.cuda.empty_cache()
    return {"max_abs_err": abs_err, "norm_err": errs["y"],
            "final_state_norm_err": errs["final_state"],
            "init_state_norm_errs": errs_init, "fault_norm_errs": faults,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": [B, S, H, P, N]}


@contextlib.contextmanager
def model_kernels(attn_fn, ssd_fn, conv_fn):
    """Put ``attn_fn``, ``ssd_fn`` and ``conv_fn`` where the model calls its
    three kernels (``blockwise_attention``, ``ssd_chunked`` and
    ``mamba2_block`` call them by these names), for comparisons on the same
    weights and tokens."""
    from repro_torch.models import attention, ssm

    saved = (attention.flash_attention_kernel, ssm.ssd_scan_kernel,
             ssm.causal_conv_kernel)
    (attention.flash_attention_kernel, ssm.ssd_scan_kernel,
     ssm.causal_conv_kernel) = attn_fn, ssd_fn, conv_fn
    try:
        yield
    finally:
        (attention.flash_attention_kernel, ssm.ssd_scan_kernel,
         ssm.causal_conv_kernel) = saved


@contextlib.contextmanager
def moe_routing_replay(routes: list, record: bool):
    """With ``record``, keep the router's decisions (gates, experts, buffer
    positions, kept slots) of every ``moe_routing`` call in ``routes``;
    without, hand the n-th call the n-th recorded decisions.  The router's
    choices are discrete: where the kernel path and the plain path round an
    activation differently, a token may take another expert or lose its
    capacity slot, and its later layers then differ entirely.  Replaying
    the kernel path's decisions on the plain path compares the two on the
    same routing.  Does nothing for a model without MoE layers."""
    from repro_torch.models import moe

    inner = moe.moe_routing
    replay = iter(routes)

    def routing(params, x, cfg, *, group=moe.DEFAULT_GROUP):
        gate, eidx, pos, keep, C, aux = inner(params, x, cfg, group=group)
        if record:
            routes.append((gate, eidx, pos, keep))
        else:
            gate, eidx, pos, keep = next(replay)
        return gate, eidx, pos, keep, C, aux

    moe.moe_routing = routing
    try:
        yield
    finally:
        moe.moe_routing = inner


def paired_kernels(errs: list):
    """``model_kernels`` arguments that run each call through the kernel and
    through its plain version on the same inputs, append (kernel name,
    normalised error) of each call to ``errs`` and go on with the kernel's
    result.  The conv's kernel is held to the plain version run in float32
    (its own arithmetic: the bf16 plain version rounds every product)."""
    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    def attn(q, k, v, *, causal, window=None, chunk=fa.DEFAULT_CHUNK,
             bidirectional_prefix=0, scale=None):
        kw = dict(causal=causal, window=window, chunk=chunk,
                  bidirectional_prefix=bidirectional_prefix, scale=scale)
        got = fa.flash_attention_kernel(q, k, v, **kw)
        errs.append(("flash_attention",
                     norm_err(got, fa.flash_attention_plain(q, k, v, **kw))))
        return got

    def ssd(x, dt, a, b, c, chunk, init_state=None):
        y, fin = ss.ssd_scan_kernel(x, dt, a, b, c, chunk, init_state)
        y_p, fin_p = ss.ssd_scan_plain(x, dt, a, b, c, chunk, init_state)
        errs.append(("ssd_scan", max(norm_err(y, y_p), norm_err(fin, fin_p))))
        return y, fin

    def conv(x, w, b, state=None):
        y = cc.causal_conv_kernel(x, w, b, state)
        y_p = cc.causal_conv_plain(x.float(), w.float(), b.float(),
                                   None if state is None else state.float())
        errs.append(("causal_conv", norm_err(y, y_p)))
        return y

    return attn, ssd, conv


def prefill_vs_decode(torch, model, params, toks, vocab: int):
    """prefill(toks[:, :s0]), then decode steps fed the known tokens, against
    the last logits of prefill(toks[:, :s0 + j]) for j = 1..CONSIST_STEPS
    (the JAX package's tests/test_decode_consistency.py).  Returns the first
    prefill's (logits, cache as {path: tensor}), the largest step error over
    max |logits|, each step's error, and whether every logit was finite."""
    from repro_torch.launch.serve import prompt_batch

    s0 = toks.shape[1] - CONSIST_STEPS
    max_seq = toks.shape[1] + 8
    logits, cache = model.prefill(
        params, prompt_batch(model.cfg, toks[:, :s0]), max_seq=max_seq)
    first = (logits, {name: t.clone() for name, t in _paths(cache)})
    errs, scale, finite = [], 0.0, bool(torch.isfinite(logits).all())
    for j in range(1, CONSIST_STEPS + 1):
        logits, cache = model.decode_step(params, cache, toks[:, s0 + j - 1],
                                          s0 + j - 1)
        want, _ = model.prefill(
            params, prompt_batch(model.cfg, toks[:, :s0 + j]),
            max_seq=max_seq)
        finite = finite and bool(torch.isfinite(logits).all()
                                 and torch.isfinite(want).all())
        real = want[:, :vocab]
        errs.append((logits[:, :vocab] - real).abs().max().item())
        scale = max(scale, real.abs().max().item())
    return first, max(errs) / scale, errs, finite


def reference_gaps(torch, model, params, seed: int, toks, vocab: int,
                   family: str) -> list:
    """A prefill of ``toks[:, :s0]``, then ``CONSIST_STEPS - 1`` decode
    steps fed the known tokens, through the model's cache; each step's
    logits against the plain float32 reference's forward
    (``bench/reference/<family>.py``, TF32 off) over the same tokens, on
    the model's float32 weights from ``seed``: max |served - reference|
    over max |reference|, a step each."""
    import dataclasses

    from bench.reference import follow
    from bench.reference.common import FP32, float32_highest
    from repro_torch.launch.serve import prompt_batch

    s0 = toks.shape[1] - CONSIST_STEPS
    logits, cache = model.prefill(params, prompt_batch(model.cfg, toks[:, :s0]),
                                  max_seq=toks.shape[1] + 8)
    served = [logits[:, :vocab]]
    for j in range(CONSIST_STEPS - 1):
        logits, cache = model.decode_step(params, cache, toks[:, s0 + j],
                                          s0 + j)
        served.append(logits[:, :vocab])
    del cache
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    float32_highest()
    try:
        fam = follow.family(family)
        m = dataclasses.asdict(model.cfg)
        ref_params = model.init(seed)
        with torch.no_grad():
            x = fam.hidden(ref_params, toks[:, :s0 + CONSIST_STEPS - 1], m,
                           FP32)
            want = x[:, s0 - 1:] @ fam.head(ref_params, m)
        del ref_params, x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
    torch.cuda.empty_cache()
    return [((got - want[:, j]).abs().max() / want[:, j].abs().max()).item()
            for j, got in enumerate(served)]


def kernel_calls(cfg, kernel: str) -> int:
    """Calls of ``kernel`` in one prefill: one per attention of an attention
    layer (whisper's decoder layers attend twice, to themselves and to the
    encoder), one per SSD layer of the SSD scan and of the causal conv
    before it; none of any other kernel."""
    if kernel == "causal_conv":
        kernel = "ssd_scan"
    if kernel not in ("flash_attention", "ssd_scan"):
        return 0
    if cfg.family == "hybrid":
        kind = "attn" if kernel == "flash_attention" else "mamba"
        return cfg.block_types().count(kind)
    if (kernel == "ssd_scan") != (cfg.family == "ssm"):
        return 0
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def serve_phase(checks, np, torch, dev, arch: str, layers,
                seed: int) -> dict:
    """``Server.run`` at full width (cut to ``layers`` layers if given)
    with the launch counts read around it; then, on the same weights, the
    prefill through the kernels against the prefill through the plain
    versions, prefill against decode on both paths, and a profiled window
    of decode steps.  Returns the model kernels' launches in the run and
    the kernels-against-plain errors."""
    import dataclasses

    from repro_torch.launch.serve import (Request, Server, preset_config,
                                          prompt_batch)
    from repro_torch.models.model import Model

    counters = kernel_counters()
    cfg = preset_config(arch, "full")
    cut = ""
    if layers is not None:
        cut = (f", cut to {layers} of its {cfg.n_layers} layers at full "
               "width")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    want = {name: kernel_calls(cfg, name) for name in counters}
    calls = sum(want.values())
    model = Model(cfg, device=dev)
    params = model.init(seed)
    n_params = sum(t.numel() for t in _tensors(params))
    srv = Server(model, params, SERVE_REQUESTS,
                 max_seq=SERVE_PROMPT + SERVE_GEN + 8, device=dev)
    del params
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT))

    def requests(gen):
        return [Request(rid=i, prompt=prompts[i], max_new=gen)
                for i in range(SERVE_REQUESTS)]

    srv.run(requests(2))                       # warm-up: first-call set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    stats = srv.run(requests(SERVE_GEN))
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    checks.expect(launches == want,
                  f"serve {arch}: launches {launches}, want {want}")
    checks.expect(stats["logits_finite"], f"serve {arch}: logits finite")
    checks.expect(stats["new_tokens"] == SERVE_REQUESTS * SERVE_GEN,
                  f"serve {arch}: {stats['new_tokens']} new tokens")

    # The kernels at the model's own inputs (prompt length s0 = 2044, not a
    # multiple of any tile): each layer's kernel call against its plain
    # version on the same activations, held to the kernel phase's bar; the
    # whole prefill through the kernels against the same prefill through
    # the plain versions, where the layers' differences compound; and
    # prefill against decode on each path.
    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    toks = torch.from_numpy(prompts[:CONSIST_REQUESTS]).to(dev)
    s0, V = SERVE_PROMPT - CONSIST_STEPS, cfg.vocab_size
    layer_errs = []
    with model_kernels(*paired_kernels(layer_errs)):
        model.prefill(srv.params, prompt_batch(cfg, toks[:, :s0]),
                      max_seq=SERVE_PROMPT + 8)
    bars = {"flash_attention": ATTN_BAR, "ssd_scan": SSD_BAR,
            "causal_conv": CONV_BAR}
    worst = max(range(len(layer_errs)),
                key=lambda i: layer_errs[i][1] / bars[layer_errs[i][0]])
    bar = bars[layer_errs[worst][0]]
    layer_errs = [err for _, err in layer_errs]
    checks.expect(len(layer_errs) == calls
                  and layer_errs[worst] <= bar,
                  f"serve {arch}: {len(layer_errs)} layer calls, kernel "
                  f"against plain at the model's inputs, worst norm err "
                  f"{layer_errs[worst]} (call {worst}) against its kernel's "
                  f"bar {bars}")
    routes = []
    with moe_routing_replay(routes, record=True):
        (k_logits, k_cache), rel, errs, finite = prefill_vs_decode(
            torch, model, srv.params, toks, V)
    before = {name: fn.launches for name, fn in counters.items()}
    with model_kernels(fa.flash_attention_plain, ss.ssd_scan_plain,
                       cc.causal_conv_plain), \
            moe_routing_replay(routes, record=False):
        (p_logits, p_cache), p_rel, p_errs, p_finite = prefill_vs_decode(
            torch, model, srv.params, toks, V)
    routed = bool(routes)
    del routes
    plain_launches = {name: fn.launches - before[name]
                      for name, fn in counters.items()}
    checks.expect(not any(plain_launches.values()),
                  f"serve {arch}: the plain path launched {plain_launches}")
    pairs = {"logits": (k_logits[:, :V], p_logits[:, :V]),
             **{f"cache {name}": (k_cache[name], p_cache[name])
                for name in k_cache}}
    vs_plain = {name: max_rel(*pair) for name, pair in pairs.items()}
    vs_plain_norm = {name: norm_err(*pair) for name, pair in pairs.items()}
    checks.expect(max(vs_plain.values()) <= PLAIN_PATH_BAR,
                  f"serve {arch}: prefill through the kernels against the "
                  f"plain versions, err/max {vs_plain} <= {PLAIN_PATH_BAR}")
    consist_bar = MOE_CONSIST_BAR if cfg.family == "moe" else CONSIST_BAR
    checks.expect(finite and p_finite and rel <= consist_bar,
                  f"serve {arch}: prefill vs decode err/max {rel} <= "
                  f"{consist_bar}, finite {finite} (plain path {p_finite})")
    del k_cache, p_cache
    ref_errs = None
    if arch in REFERENCE_ARCHS:
        ref_errs = reference_gaps(torch, model, srv.params, seed, toks, V,
                                  REFERENCE_ARCHS[arch])
        checks.expect(max(ref_errs) <= REFERENCE_BAR,
                      f"serve {arch}: served logits against the float32 "
                      f"reference's forward, err/max per step {ref_errs} "
                      f"<= {REFERENCE_BAR}")

    # Where prefill and decode time go, under torch.profiler (device
    # activity): one prefill of the serving batch, its device time split
    # between each model kernel it launches, the matmuls and the rest; then
    # DECODE_PROFILE steps, busy time against the wall.
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        logits, cache = model.prefill(
            srv.params, prompt_batch(cfg, torch.from_numpy(prompts).to(dev)),
            max_seq=SERVE_PROMPT + SERVE_GEN + 8)
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t
    split, p_top = device_split(device_events(prof), {
        name: KERNEL_SYMBOLS[name] for name, n in want.items() if n})
    p_busy = sum(ms for ms, _ in split.values())
    nxt = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for step in range(DECODE_PROFILE):
            logits, cache = model.decode_step(srv.params, cache, nxt,
                                              SERVE_PROMPT + step)
            nxt = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = sorted(device_events(prof), reverse=True,
                    key=lambda e: e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_kernels = sum(e.count for e in events if e.self_device_time_total > 0)
    top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in events[:5])
    print(f"phase serve {arch}{cut}: {n_params} parameters (config count "
          f"{cfg.param_count()}), {SERVE_REQUESTS} requests x "
          f"{SERVE_PROMPT} prompt + {SERVE_GEN} new: prefill "
          f"{stats['prefill_s']:.4f} s, decode {stats['decode_s']:.4f} s "
          f"({stats['tok_per_s']:.1f} tokens/s), peak memory "
          f"{peak / 2**30:.3f} GiB, launches {launches}; kernel against "
          f"plain at each layer's inputs, norm err worst "
          f"{layer_errs[worst]:.3e} (layer {worst}), median "
          f"{sorted(layer_errs)[len(layer_errs) // 2]:.3e}; "
          f"whole prefill through the kernels against the plain versions"
          f"{' (the kernel path routing replayed)' if routed else ''}, "
          f"err/max (norm err): "
          + ", ".join(f"{name} {e:.3e} ({vs_plain_norm[name]:.3e})"
                      for name, e in vs_plain.items())
          + (f"; served against the float32 reference err/max per step "
             f"{[f'{e:.3e}' for e in ref_errs]}" if ref_errs else "")
          + f"; prefill vs decode err/max {rel:.3e} (bar {consist_bar}; max "
          f"abs err "
          f"{max(errs):.4e}, per step {[f'{e:.3e}' for e in errs]}), plain "
          f"path {p_rel:.3e} (per step {[f'{e:.3e}' for e in p_errs]})",
          flush=True)
    print(f"phase serve {arch} prefill profile: {SERVE_REQUESTS} x "
          f"{SERVE_PROMPT} tokens, wall {p_wall * 1e3:.3f} ms, device busy "
          f"{p_busy:.3f} ms; "
          + "; ".join(f"{name} {ms:.3f} ms x{n} ({ms / p_busy:.1%})"
                      for name, (ms, n) in split.items())
          + f"; top of the rest: {p_top}", flush=True)
    print(f"phase serve {arch} decode profile: {DECODE_PROFILE} steps at "
          f"batch {SERVE_REQUESTS}, wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1.0 - busy_ms / 1e3 / wall:.4f}, "
          f"{n_kernels / DECODE_PROFILE:.0f} device kernels a step; device "
          f"top: {top}", flush=True)
    del srv, model, cache, logits
    torch.cuda.empty_cache()
    return {"launches": {name: n for name, n in launches.items() if n},
            "layers": cfg.n_layers,
            "layer_norm_err_worst": layer_errs[worst],
            "model_vs_plain_rel_errs": vs_plain,
            "model_vs_plain_norm_errs": vs_plain_norm,
            "prefill_vs_decode": rel, "prefill_vs_decode_plain": p_rel,
            "reference_errs": ref_errs, "decode_s": stats["decode_s"],
            "prefill_s": stats["prefill_s"],
            "prefill_profile_ms": {name: ms for name, (ms, _) in
                                   split.items()}}


def kernel_label(mangled: str) -> tuple:
    """(name, template arguments) of a kernel's mangled name:
    ("flash_bwd_dkdv", "80, prefix") for ``..._flash_bwd_dkdvILi80ELb1EEEv
    ...``; the attention kernels' flags are the prefix's and then the
    lse's, the SSD forward's the chunk states'."""
    k = re.search(r"\d+((?:flash|ssd|causal_conv1d)_\w+?)(?:I(.*?)E)?"
                  r"(?:E?v14|E?NS|Ev|EP)", mangled)
    if k is None:
        return mangled, ""
    found = re.findall(r"L([ib])(\d+)E", k.group(2) or "")
    flags = [v for kind, v in found if kind == "b"]
    names = ("states",) if k.group(1).startswith("ssd") else ("prefix", "lse")
    args = [v for kind, v in found if kind == "i"] + [
        name if v == "1" else f"no {name}" for name, v in zip(names, flags)]
    return k.group(1), ", ".join(args)


def ptxas_table(log: str) -> list:
    """Per kernel in ``ptxas -v`` output: its name and template arguments
    (``kernel_label``), registers, stack frame and spill bytes."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, row = m.group(1), {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            row = dict(zip(("stack", "spill_stores", "spill_loads"),
                           map(int, m.groups())))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernel, args = kernel_label(name)
            rows.append({"kernel": kernel, "args": args,
                         "registers": int(m.group(1)), **row})
            name = None
    return rows


def kernel_counters() -> dict:
    """The launch counter of every kernel wrapper, by kernel name."""
    from repro_torch.kernels import (adamw, causal_conv, dvfs_opt,
                                     flash_attention, ssd_scan)
    return {"dvfs_opt": dvfs_opt.dvfs_solve_cuda,
            "flash_attention": flash_attention.flash_attention_cuda,
            "flash_attention_bwd": flash_attention.flash_attention_bwd_cuda,
            "ssd_scan": ssd_scan.ssd_scan_cuda,
            "ssd_scan_bwd": ssd_scan.ssd_scan_bwd_cuda,
            "adamw_sq_norms": adamw.sq_norms_cuda,
            "adamw_update": adamw.update_cuda,
            "causal_conv": causal_conv.causal_conv_cuda,
            "causal_conv_bwd": causal_conv.causal_conv_bwd_cuda}


def attention_bwd_phase(checks, torch, dev, seed: int) -> dict:
    """The backward kernel against its plain version at
    ``ATTN_BWD_SHAPES``, from the forward kernel's own output and lse, with
    plain renderings of the faults the bar is there for; each shape timed
    beside the plain version, SDPA's backward and the bound; at a shape of
    ``ATTN_SCALES``, with that scale throughout."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    out = {}
    for key, (B, Sq, Sk, H, KV, dh), causal, window, prefix in (
            ATTN_BWD_SHAPES):
        g = H // KV
        scale = ATTN_SCALES.get(key)
        q_scale = ATTN_EDGE_Q_SCALE * (1.0 if scale is None
                                       else dh ** -0.5 / scale)
        q = torch.randn((B, Sq, H, dh), generator=gen, device=dev)
        q = (q * q_scale).to(torch.bfloat16)
        k, v = (torch.randn((B, Sk, KV, dh), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        do = torch.randn((B, Sq, H, dh), generator=gen,
                         device=dev).to(torch.bfloat16)
        kw = dict(causal=causal, window=window, scale=scale)
        o, lse = fa.flash_attention_cuda(q, k, v, prefix=prefix,
                                         return_lse=True, **kw)

        def plain(q_, k_, v_, o_, lse_, do_, window_=window):
            return fa.flash_attention_bwd_plain(
                q_, k_, v_, o_, lse_, do_, causal=causal, window=window_,
                bidirectional_prefix=prefix, scale=scale)

        def kernel():
            return fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                               prefix=prefix, **kw)

        got, again = kernel(), kernel()
        twice = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        checks.expect(twice, f"attention backward {key}: two calls on the "
                      "same inputs give dq, dk and dv bit-equal")
        want = plain(q, k, v, o, lse, do)
        errs = {n: norm_err(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                     got, want)}
        abs_err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
        checks.expect(finite and max(errs.values()) <= ATTN_BWD_BAR,
                      f"attention backward {key}: finite {finite}, norm errs "
                      f"{errs} <= {ATTN_BWD_BAR}")
        # Plain renderings of faults, each against the right answer: the
        # delta term dropped (o = 0 makes delta 0); the causal mask one key
        # off (the diagonal dropped: q[1:] over k[:-1], window one shorter,
        # against the rows from 1 on) or, without a causal mask, the last
        # key dropped; the GQA group sum over head 0 of each group only;
        # the scale applied twice to dK; where the shape has its own scale,
        # dQ and dK taken at the default dh ** -0.5 in its place.
        dq_w, dk_w, _ = want
        fq, fk, _ = plain(q, k, v, torch.zeros_like(o), lse, do)
        faults = {"delta dropped": max(norm_err(fq, dq_w),
                                       norm_err(fk, dk_w))}
        if causal:
            w1 = None if window is None else window - 1
            faults["causal mask one key off"] = norm_err(
                plain(q[:, 1:], k[:, :-1], v[:, :-1], o[:, 1:],
                      lse[:, :, 1:].contiguous(), do[:, 1:], w1)[0],
                dq_w[:, 1:])
        else:
            faults["last key dropped"] = norm_err(
                plain(q, k[:, :-1], v[:, :-1], o, lse, do)[0], dq_w)
        if g > 1:
            faults["group sum over head 0"] = norm_err(
                plain(q[:, :, ::g], k, v, o[:, :, ::g],
                      lse[:, ::g].contiguous(), do[:, :, ::g])[1], dk_w)
        sm = dh ** -0.5 if scale is None else scale
        faults["scale twice on dK"] = norm_err(dk_w * sm, dk_w)
        if scale is not None:
            faults["default scale on dQ, dK"] = max(
                norm_err(dq_w * dh ** -0.5 / scale, dq_w),
                norm_err(dk_w * dh ** -0.5 / scale, dk_w))
        checks.expect(min(faults.values()) > ATTN_BWD_BAR,
                      f"attention backward {key}: every fault's norm err "
                      f"{faults} exceeds the bar {ATTN_BWD_BAR}")
        del got, want, fq, fk, dq_w, dk_w
        k_ms = event_ms(torch, kernel, 10)
        p_ms = event_ms(torch, lambda: plain(q, k, v, o, lse, do), 2)
        lib_ms = sdpa_bwd_ms(torch, q, k, v, do, causal, window, prefix,
                             scale)
        b_ms, b_by = attention_bwd_bound(B, H, KV, Sq, dh, causal, window,
                                         Sk, prefix)
        out[key] = {"max_abs_err": abs_err, "norm_errs": errs, "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "fault_norm_errs": faults,
                    "bit_equal_twice": twice,
                    "shape": [B, Sq, Sk, H, KV, dh,
                              "causal" if causal else "non-causal", window,
                              prefix, f"q x{q_scale}"],
                    "scale": sm, "kernel_head_dim": fa.kernel_head_dim(dh)}
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"phase attention backward {key}: B {B} Sq {Sq} Sk {Sk} H {H} "
              f"KV {KV} dh {dh} (kernel dh {fa.kernel_head_dim(dh)}) "
              f"{'causal' if causal else 'non-causal'} window {window} "
              f"prefix {prefix}, scale {sm}, q x{q_scale}: norm err "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f", max abs err {abs_err:.3e}, two calls bit-equal {twice}"
              f"; kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, sdpa backward {lib}, bound {b_ms:.4f} ms "
              f"({b_by}), kernel at {b_ms / k_ms:.1%} of the bound; plain "
              "renderings of faults, norm err against the right answer: "
              + ", ".join(f"{n} {e:.3e}" for n, e in faults.items()),
              flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return out


def ssd_bwd_phase(checks, torch, dev, seed: int) -> dict:
    """The SSD backward kernel against ``ssd_scan_bwd_plain`` at
    ``SSD_BWD_SHAPES`` (a ragged S padded for the plain version with tokens
    of dt = 0, so that both chunk at KERNEL_CHUNK), from the forward
    kernel's own chunk states (held against ``ssd_chunk_states_plain``; its
    y and final state bit-equal to the serving forward's), with plain
    renderings of the
    faults the bar is there for, two calls bit-equal, and the gradient's
    error again from the chunk states rounded to bf16 (what storing them in
    bf16 would cost); each shape timed beside the plain version and the
    bound, the training shape's forward with and without its states."""
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    names = ("dx", "ddt", "da", "db", "dc", "dinit")
    out = {}
    for key, (B, S, H, P, N), with_init, with_dfinal in SSD_BWD_SHAPES:
        x, dt, a, b, c, init, dy, dfinal = ssd_bwd_inputs(
            torch, gen, dev, B, S, H, P, N, with_init, with_dfinal)
        y, final, states = ss.ssd_scan_cuda(x, dt, a, b, c, init,
                                            states=True)
        y0, final0 = ss.ssd_scan_cuda(x, dt, a, b, c, init)
        fwd_same = torch.equal(y, y0) and torch.equal(final, final0)
        checks.expect(fwd_same, f"ssd backward {key}: the forward writing "
                      "its chunk states gives y and the final state "
                      "bit-equal to the serving forward's")
        del y, final, y0, final0
        st_err = norm_err(states[..., :P, :N],
                          ss.ssd_chunk_states_plain(x, dt, a, b, c, init))

        def kernel(st=states):
            return ss.ssd_scan_bwd_cuda(x, dt, a, b, c, st, dy, dfinal)

        got, again = kernel(), kernel()
        twice = all(torch.equal(u, v) for u, v in zip(got, again))
        del again
        # The plain version chunks a ragged S at a divisor of S; padded
        # with tokens of dt = 0 it chunks at KERNEL_CHUNK, as the kernel.
        xp, dtp, bp, cp, dyp = (ss.pad_tokens(t) for t in (x, dt, b, c, dy))

        def plain_padded():
            return ss.ssd_scan_bwd_plain(xp, dtp, a, bp, cp, ss.KERNEL_CHUNK,
                                         init, dyp, dfinal)

        def real(g):
            return (g[0][:, :S], g[1][:, :S], g[2], g[3][:, :S],
                    g[4][:, :S], g[5])

        want_p = plain_padded()
        want = real(want_p)
        errs = {n: norm_err(g, w) for n, g, w in zip(names, got, want)
                if w is not None}
        abs_err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want) if w is not None)
        finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
        shapes_ok = all(tuple(g.shape) == tuple(w.shape)
                        for g, w in zip(got, want) if w is not None)
        checks.expect(twice, f"ssd backward {key}: two calls on the same "
                      "inputs give every gradient bit-equal")
        checks.expect(finite and shapes_ok and st_err <= SSD_BAR
                      and max(errs.values()) <= SSD_BWD_BAR,
                      f"ssd backward {key}: finite {finite}, shapes "
                      f"{shapes_ok}, chunk states norm err {st_err} <= "
                      f"{SSD_BAR}, norm errs {errs} <= {SSD_BWD_BAR}")
        low = ss.ssd_scan_bwd_cuda(x, dt, a, b, c,
                                   states.bfloat16().float(), dy, dfinal)
        errs_bf16 = {n: norm_err(g, w) for n, g, w in zip(names, low, want)
                     if w is not None}
        low = ss.ssd_scan_bwd_cuda(x, dt, a, b, c, states, dy, dfinal,
                                   round_g=True)
        errs_bf16_g = {n: norm_err(g, w) for n, g, w in zip(names, low, want)
                       if w is not None}
        del low, got
        faults = ssd_bwd_faults(ss, xp, dtp, a, bp, cp, init, dyp, dfinal,
                                want_p)
        checks.expect(min(faults.values()) > SSD_BWD_BAR,
                      f"ssd backward {key}: every fault's norm err {faults} "
                      f"exceeds the bar {SSD_BWD_BAR}")
        del want, want_p
        k_ms = event_ms(torch, kernel, 10)
        p_ms = event_ms(torch, lambda: real(plain_padded()), 2)
        del xp, dtp, bp, cp, dyp
        b_ms, b_by = ssd_bwd_bound(B, S, H, P, N, ss.KERNEL_CHUNK, with_init,
                                   with_dfinal)
        design = ssd_bwd_design_bytes(B, S, H, ss.KERNEL_CHUNK, ss.KERNEL_P,
                                      ss.KERNEL_N)
        # Each launch on its own: device time, its own traffic's floor at
        # the memory rate, the rate it reached.
        launch_ms = device_ms(torch, kernel, SSD_BWD_KERNELS, 10)
        launch_bytes = ssd_bwd_kernel_bytes(B, S, H, ss.KERNEL_CHUNK,
                                            ss.KERNEL_P, ss.KERNEL_N,
                                            with_dfinal)
        launches = {k: {"ms": launch_ms[k], "bytes": launch_bytes[k],
                        "floor_ms": launch_bytes[k] / PEAK_BYTES * 1e3,
                        "tb_per_s": (launch_bytes[k] / launch_ms[k] / 1e9
                                     if launch_ms[k] else None)}
                    for k in SSD_BWD_KERNELS}
        checks.expect(all(v["ms"] for v in launches.values()),
                      f"ssd backward {key}: the profiler saw each launch "
                      f"{launch_ms}")
        row = {"max_abs_err": abs_err, "norm_errs": errs,
               "states_norm_err": st_err, "norm_errs_bf16_states": errs_bf16,
               "norm_errs_bf16_g": errs_bf16_g, "launch_split": launches,
               "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None, "design_bytes": design,
               "fault_norm_errs": faults, "bit_equal_twice": twice,
               "fwd_states_bit_equal": fwd_same,
               "shape": [B, S, H, P, N, "init" if with_init else "no init",
                         "dfinal" if with_dfinal else "no dfinal"]}
        fwd = ""
        if key == "train":
            row["fwd_ms"] = event_ms(torch, lambda: ss.ssd_scan_cuda(
                x, dt, a, b, c), 20)
            row["fwd_states_ms"] = event_ms(torch, lambda: ss.ssd_scan_cuda(
                x, dt, a, b, c, states=True), 20)
            fwd = (f"; forward {row['fwd_ms']:.4f} ms, writing the chunk "
                   f"states {row['fwd_states_ms']:.4f} ms")
        out[key] = row
        print(f"phase ssd backward {key}: B {B} S {S} H {H} P {P} N {N} "
              f"(run at P {ss.KERNEL_P}, N {ss.KERNEL_N}), initial state "
              f"{with_init}, final-state cotangent {with_dfinal}: forward "
              f"with states bit-equal to the serving forward {fwd_same}, "
              f"chunk states norm err {st_err:.3e}; norm err "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f", max abs err {abs_err:.3e}, two calls bit-equal {twice}; "
              "from bf16-rounded chunk states "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs_bf16.items())
              + "; from bf16-rounded state cotangents (a probe) "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs_bf16_g.items())
              + f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), kernel at {b_ms / k_ms:.1%} of the "
              f"bound; the design's chunk states and state cotangents "
              f"{design} bytes more ({design / PEAK_BYTES * 1e3:.4f} ms at "
              "the memory rate)" + fwd + "; plain renderings of faults, norm err "
              "against the right answer: "
              + ", ".join(f"{n} {e:.3e}" for n, e in faults.items()),
              flush=True)
        for k, v in launches.items():
            print(f"phase ssd backward {key} launch {k}: device "
                  f"{v['ms']} ms, its own traffic {v['bytes']} bytes "
                  f"(floor {v['floor_ms']:.4f} ms at the memory rate), "
                  f"{v['tb_per_s']} TB/s", flush=True)
        del x, b, c, dt, a, init, dy, dfinal, states
        torch.cuda.empty_cache()
    return out


def conv_faults(cc, torch, x, w, b, state, dy, want, want_grads) -> dict:
    """Plain renderings (float32) of the faults the conv's bar is there
    for, each one's normalised error against the right answer ``want`` (y)
    and ``want_grads`` (dx, dw, db; the worst of the three): a window one
    step into the future (anti-causal), the oldest tap dropped, the bias
    left out, each in y and in the gradient of the faulty conv; and SiLU's
    derivative left out of the gradient (g = dy).  (y's error or None,
    the gradients' error) by fault."""
    B, S, C = x.shape
    W = w.shape[0]
    pad = x.new_zeros((B, W - 1, C)) if state is None else state
    full = torch.cat([pad, x, x.new_zeros((B, 1, C))], dim=1)[:, 1:]
    no_tap = w.clone()
    no_tap[0] = 0
    renders = {"anti-causal shift": (full[:, W - 1:], w, b, full[:, :W - 1]),
               "dropped tap": (x, no_tap, b, state),
               "missing bias": (x, w, torch.zeros_like(b), state)}

    def worst(grads):
        return max(norm_err(g, r) for g, r in zip(grads[:3], want_grads[:3]))

    out = {name: (norm_err(cc.causal_conv_plain(*args), want),
                  worst(cc.causal_conv_bwd_plain(*args, dy)))
           for name, args in renders.items()}
    out["silu derivative dropped"] = (
        None, worst(cc.conv_bwd_from_g(dy.float(), x, w, state)))
    return out


def conv_library(torch, x, w, b):
    """``F.conv1d(groups=C)`` + ``F.silu`` on x [B, S, C]: the conv as one
    PyTorch call computes it (channels first; a yardstick the port never
    calls)."""
    import torch.nn.functional as F
    W, S = w.shape[0], x.shape[1]
    u = F.conv1d(x.transpose(1, 2), w.t().unsqueeze(1), b, padding=W - 1,
                 groups=x.shape[2])
    return F.silu(u[..., :S]).transpose(1, 2)


def causal_conv_phase(checks, torch, dev, seed: int) -> dict:
    """The causal conv's kernels (``csrc/causal_conv.cu``) against the plain
    version run in float32 at ``CONV_SHAPES``, with and without a conv
    state: y, dx, dw, db and the state's gradient; two backward calls
    bit-equal; plain renderings of four faults above the bar
    (``conv_faults``).  Without a state (the training path) each timed
    beside its byte bound, the plain version as the model ran it before
    the kernels (bf16; its backward by autograd) and ``F.conv1d`` +
    ``F.silu`` (``conv_library``), forward and backward."""
    from repro_torch.kernels import causal_conv as cc

    gen = torch.Generator(device=dev).manual_seed(seed + 7)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen,
                                    device=dev)).to(torch.bfloat16)

    def f32(t):
        return None if t is None else t.float()

    names = ("dx", "dw", "db", "dstate")
    out = {}
    for key, (B, S, di, N, H) in CONV_SHAPES:
        C = di + 2 * N
        zxbcdt = rand(B, S, 2 * di + 2 * N + H)
        x = zxbcdt[..., di:di + C]
        w, b = rand(CONV_WIDTH, C, scale=0.5), rand(C, scale=0.5)
        dy, conv_state = rand(B, S, C), rand(B, CONV_WIDTH - 1, C)
        width = cc.vector_width(x, dy)
        for state in (None, conv_state):
            name = key if state is None else f"{key}_state"
            want = cc.causal_conv_plain(x.float(), w.float(), b.float(),
                                        f32(state))
            got = cc.causal_conv_cuda(x, w, b, state)
            wants = cc.causal_conv_bwd_plain(x.float(), w.float(), b.float(),
                                             f32(state), dy.float())
            grads = cc.causal_conv_bwd_cuda(x, w, b, state, dy)
            again = cc.causal_conv_bwd_cuda(x, w, b, state, dy)
            twice = all(torch.equal(u, v) for u, v in zip(grads, again))
            del again
            errs = {"y": norm_err(got, want)}
            errs.update({n: norm_err(g, r) for n, g, r in zip(names, grads,
                                                               wants)
                         if r is not None})
            finite = all(bool(torch.isfinite(t.float()).all())
                         for t in (got, *grads))
            plain_err = norm_err(cc.causal_conv_plain(x, w, b, state), want)
            faults = conv_faults(cc, torch, x.float(), w.float(), b.float(),
                                 f32(state), dy.float(), want, wants)
            low = min(e for pair in faults.values() for e in pair
                      if e is not None)
            checks.expect(finite and max(errs.values()) <= CONV_BAR,
                          f"causal conv {name}: finite {finite}, norm errs "
                          f"{errs} <= {CONV_BAR}")
            checks.expect(twice, f"causal conv {name}: two backward calls "
                          "on the same inputs give every gradient bit-equal")
            checks.expect(low > CONV_BAR,
                          f"causal conv {name}: every fault's norm err "
                          f"{faults} exceeds the bar {CONV_BAR}")
            row = {"norm_errs": errs, "plain_bf16_norm_err": plain_err,
                   "fault_norm_errs": faults, "bit_equal_twice": twice,
                   "vector_width": width,
                   "shape": [B, S, C, CONV_WIDTH, "state" if state is not None
                             else "no state"]}
            del want, got, wants, grads
            if state is None:
                row.update(conv_timing(torch, cc, x, w, b, dy))
            out[name] = row
            print(f"phase causal conv {name}: B {B} S {S} C {C} W "
                  f"{CONV_WIDTH} (x a view of [B, S, {zxbcdt.shape[-1]}] "
                  f"from column {di}, {width} channels a load), state "
                  f"{state is not None}: norm err "
                  + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                  + f" (the plain bf16 conv's y {plain_err:.3e}); two "
                  f"backward calls bit-equal {twice}; plain renderings of "
                  "faults, norm err of y / of the gradients: "
                  + ", ".join(f"{n} {'-' if e is None else f'{e:.3e}'} / "
                              f"{g:.3e}" for n, (e, g) in faults.items())
                  + "".join(f"; {k} {v}" for k, v in row.items()
                            if k.endswith("_ms")), flush=True)
        del zxbcdt, x, w, b, dy, conv_state
        torch.cuda.empty_cache()
    return out


def conv_timing(torch, cc, x, w, b, dy) -> dict:
    """The conv's forward and backward kernels timed (events, back to back;
    each launch's device time by the profiler) beside their byte bounds,
    the plain version as the model ran it before the kernels (bf16; the
    backward by autograd: forward and backward less the forward) and
    ``conv_library`` (the same way)."""
    B, S, C = x.shape
    xg, wg, bg = (t.detach().requires_grad_() for t in (x, w, b))

    def grad_of(fn):
        def run():
            torch.autograd.grad(fn(xg, wg, bg), (xg, wg, bg), dy)
        return run

    row = {"ms": event_ms(torch, lambda: cc.causal_conv_cuda(x, w, b), 20),
           "bwd_ms": event_ms(
               torch, lambda: cc.causal_conv_bwd_cuda(x, w, b, None, dy), 20),
           "plain_ms": event_ms(torch, lambda: cc.causal_conv_plain(x, w, b),
                                5)}
    row["plain_bwd_ms"] = (event_ms(torch, grad_of(cc.causal_conv_plain), 5)
                           - row["plain_ms"])
    try:
        row["library_ms"] = event_ms(torch, lambda: conv_library(
            torch, x, w, b), 10)
        row["library_bwd_ms"] = (event_ms(torch, grad_of(
            lambda *a: conv_library(torch, *a)), 5) - row["library_ms"])
    except (RuntimeError, TypeError) as err:
        row["library_ms"] = row["library_bwd_ms"] = None
        print(f"phase causal conv: F.conv1d not timed: {err}", flush=True)
    launch = device_ms(torch, lambda: (
        cc.causal_conv_cuda(x, w, b), cc.causal_conv_bwd_cuda(
            x, w, b, None, dy)), CONV_KERNELS, 10)
    row["device_ms"] = launch
    row["bound_ms"] = cc.conv_bytes(B, S, C) / PEAK_BYTES * 1e3
    row["bwd_bound_ms"] = (cc.conv_bytes(B, S, C, backward=True)
                           / PEAK_BYTES * 1e3)
    row["bound_by"] = "bytes"
    return row


def adamw_leaf_sets() -> dict:
    """Leaf sizes by set: danube's and mamba2-370m's parameters at full
    width and depth (their shapes, nothing allocated), and the odd set."""
    from repro_torch.launch.train import preset_config
    from repro_torch.models.model import Model
    out = {"odd": list(ADAMW_ODD) + [ADAMW_MISALIGNED]}
    for arch in (TRAIN_SSM_ARCH, TRAIN_ARCH):
        shapes = Model(preset_config(arch, "full"), device="meta").param_shapes()
        out[arch] = [t.numel() for t in _tensors(shapes)]
    return out


def adamw_leaves(torch, gen, dev, sizes, scale: float, misalign: bool):
    """Float32 leaves of ``sizes`` on the card, N(0, scale^2); with
    ``misalign`` the last one is a view 4 bytes past an aligned base."""
    out = [scale * torch.randn(n, generator=gen, device=dev)
           for n in (sizes[:-1] if misalign else sizes)]
    if misalign:
        base = torch.randn(sizes[-1] + 1, generator=gen, device=dev)
        out.append(base.mul_(scale)[1:])
    return out


def ulps(torch, a, b) -> int:
    """The most units in the last place between two float32 tensors of the
    same signs (their bit patterns as integers)."""
    if a.numel() == 0:
        return 0
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


def adamw_phase(checks, np, torch, dev, seed: int) -> dict:
    """AdamW's kernel (``csrc/adamw.cu``) against the plain per-leaf loop:
    on each leaf set three updates with injected scalars, p, m and v
    bit-equal, the per-leaf norms within ``ADAMW_NORM_BAR`` of
    ``torch.sum``; one ``AdamW.update`` on each set through the public
    path, its launches (3) and gradient copies (0) counted; at danube's
    1.83B parameters the kernel's time beside its bound, the plain loop's
    and ``torch._fused_adamw_``'s (a yardstick the port never calls)."""
    from repro_torch.kernels import adamw as ak
    from repro_torch.optim.adamw import AdamW

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, sizes in adamw_leaf_sets().items():
        odd = name == "odd"
        n = sum(sizes)
        p = adamw_leaves(torch, gen, dev, sizes, 0.02, odd)
        m = adamw_leaves(torch, gen, dev, sizes, 1e-2, odd)
        v = [t.square_() for t in adamw_leaves(torch, gen, dev, sizes, 1e-2,
                                               odd)]
        g = adamw_leaves(torch, gen, dev, sizes, 1e-3, odd)
        pp, mp, vp = ([t.clone() for t in ts] for ts in (p, m, v))
        before = ak.launches()
        for t in range(1, ADAMW_UPDATES + 1):
            b1, b2 = ADAMW_HYPER["b1"], ADAMW_HYPER["b2"]
            scalars = torch.tensor([0.5, 1e-3 * t / ADAMW_UPDATES,
                                    1 - b1 ** t, 1 - b2 ** t],
                                   dtype=torch.float32, device=dev)
            ak.update_cuda(g, p, m, v, scalars, **ADAMW_HYPER)
            ak.update_plain(g, pp, mp, vp, *scalars.unbind(), **ADAMW_HYPER)
        sq = ak.sq_norms_cuda(g)
        sq_again = ak.sq_norms_cuda(g)
        torch.cuda.synchronize()
        direct = ak.launches() - before
        unequal = [i for i, (a, b) in enumerate(zip(p + m + v, pp + mp + vp))
                   if not torch.equal(a, b)]
        worst = max((ulps(torch, a, b) for a, b in zip(p + m + v, pp + mp + vp)),
                    default=0)
        want = torch.stack(ak.sq_norms_plain(g))
        rel = float(((sq - want).abs() / want.clamp(min=1e-30)).max())
        repeat = bool(torch.equal(sq, sq_again))
        del pp, mp, vp
        checks.expect(not unequal and direct == ADAMW_UPDATES + 4,
                      f"adamw {name}: {len(unequal)} of {3 * len(sizes)} "
                      f"leaves differ from the plain loop (at most {worst} "
                      f"ulps), {direct} launches for {ADAMW_UPDATES} "
                      "updates and two norms")
        checks.expect(rel <= ADAMW_NORM_BAR and repeat,
                      f"adamw {name}: per-leaf norms rel {rel} <= "
                      f"{ADAMW_NORM_BAR}, repeated bit-equal {repeat}")

        # The public path: the norm, the prologue and the update.
        opt = AdamW(learning_rate=3e-4)
        state = opt.init(p)
        launches, copies = ak.launches(), ak.contiguous_grads.copies
        _, state, met = opt.update(g, state, p)
        torch.cuda.synchronize()
        launches, copies = (ak.launches() - launches,
                            ak.contiguous_grads.copies - copies)
        gnorm = float(met["grad_norm"])
        want_norm = float(torch.sqrt(want.sum()))
        checks.expect(launches == 3 and copies == 0
                      and abs(gnorm - want_norm) <= ADAMW_NORM_BAR * want_norm,
                      f"adamw {name}: AdamW.update launched {launches} "
                      f"(want 3), copied {copies} gradients (want 0), grad "
                      f"norm {gnorm} against {want_norm}")
        row = {"leaves": len(sizes), "elements": n, "bit_equal":
               not unequal, "max_ulps": worst, "norm_rel": rel,
               "launches_update": launches, "grad_copies": copies}
        if name == TRAIN_ARCH:
            scalars = torch.tensor([0.5, 1e-4, 0.1, 0.05],
                                   dtype=torch.float32, device=dev)

            def fused():
                ak.sq_norms_cuda(g)
                ak.update_cuda(g, p, m, v, scalars, **ADAMW_HYPER)

            def plain():
                ak.sq_norms_plain(g)
                ak.update_plain(g, p, m, v, *scalars.unbind(), **ADAMW_HYPER)

            steps = [torch.ones((), device=dev) for _ in p]

            def library():
                torch._fused_adamw_(
                    p, g, m, v, [], steps, lr=1e-4, beta1=0.9, beta2=0.95,
                    weight_decay=0.1, eps=1e-8, amsgrad=False,
                    maximize=False)

            row["ms"] = event_ms(torch, fused, 10)
            row["device_ms"] = device_ms(torch, fused, ADAMW_KERNELS, 5)
            row["update_ms"] = event_ms(
                torch, lambda: opt.update(g, state, p), 10)
            row["plain_ms"] = event_ms(torch, plain, 2)
            try:
                row["library_ms"] = event_ms(torch, library, 10)
            except (RuntimeError, TypeError) as err:
                row["library_ms"] = None
                print(f"phase adamw: torch._fused_adamw_ not timed: {err}",
                      flush=True)
            row["bound_ms"] = n * ADAMW_BYTES / PEAK_BYTES * 1e3
            row["bound_by"] = "bytes"
            checks.expect(row["ms"] <= 1.5 * row["bound_ms"],
                          f"adamw {name}: {row['ms']:.3f} ms, over 1.5x its "
                          f"bound {row['bound_ms']:.3f} ms")
        elif name == TRAIN_SSM_ARCH:
            row["update_ms"] = event_ms(
                torch, lambda: opt.update(g, state, p), 10)
        out[name] = row
        print(f"phase adamw {name}: {len(sizes)} leaves, {n} elements; "
              f"{ADAMW_UPDATES} updates bit-equal to the plain loop "
              f"{not unequal} (max {worst} ulps); per-leaf norms rel "
              f"{rel:.3e}, repeat bit-equal {repeat}; AdamW.update "
              f"{launches} launches, {copies} gradient copies"
              + "".join(f"; {k} {row[k]}" for k in (
                  "ms", "device_ms", "update_ms", "plain_ms", "library_ms",
                  "bound_ms") if k in row), flush=True)
        del p, m, v, g, state, sq, sq_again, want
        torch.cuda.empty_cache()
    return out


def _loss_and_grad_norm(torch, model, params, batch):
    """(loss, global gradient norm) of ``model.loss_fn`` at ``params``,
    leaving ``params`` untouched."""
    from torch.utils import _pytree as pytree
    leaves, spec = pytree.tree_flatten(params)
    live = [t.detach().requires_grad_() for t in leaves]
    loss, _ = model.loss_fn(pytree.tree_unflatten(live, spec), batch)
    grads = torch.autograd.grad(loss, live)
    norm = torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in grads))
    return loss.item(), norm.item()


def train_danube_phase(checks, np, torch, dev, seed: int) -> dict:
    """The training path at full width: the first step through the kernels
    against the plain versions, then ``run_loop`` with checkpoints and an
    injected failure, the launch counts read around it, and one profiled
    step."""
    import tempfile

    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import adamw
    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch.train import WARMUP, preset_config
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.loop import LoopConfig, run_loop
    from repro_torch.train.trainer import init_state, make_train_step

    counters = kernel_counters()
    cfg = preset_config(TRAIN_ARCH, "full")
    L, B, S = cfg.n_layers, TRAIN_BATCH, TRAIN_SEQ
    model = Model(cfg, device=dev)
    opt = AdamW(learning_rate=cosine_schedule(TRAIN_LR, WARMUP, TRAIN_STEPS))
    data = SyntheticLMData.for_config(cfg, S, B, seed=seed, mode="succ")
    state = init_state(model, opt, seed)
    n_params = sum(t.numel() for t in _tensors(state.params))

    def put(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    # The first step through the kernels, then through the plain versions
    # (no kernel may launch there), on the same parameters and batch.
    batch0 = put(data.batch(0))
    k_loss, k_norm = _loss_and_grad_norm(torch, model, state.params, batch0)
    before = {name: fn.launches for name, fn in counters.items()}
    with model_kernels(fa.flash_attention_plain, ss.ssd_scan_plain,
                       cc.causal_conv_plain):
        p_loss, p_norm = _loss_and_grad_norm(torch, model, state.params,
                                             batch0)
    plain_launches = {name: fn.launches - before[name]
                      for name, fn in counters.items()}
    checks.expect(not any(plain_launches.values()),
                  f"train: the plain path launched {plain_launches}")
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    norm_rel = abs(k_norm - p_norm) / p_norm
    checks.expect(math.isfinite(k_loss) and math.isfinite(k_norm)
                  and loss_rel <= TRAIN_LOSS_BAR
                  and norm_rel <= TRAIN_GNORM_BAR,
                  f"train: first step through the kernels, loss {k_loss} and "
                  f"grad norm {k_norm}, against the plain versions' {p_loss} "
                  f"and {p_norm}: rel {loss_rel} <= {TRAIN_LOSS_BAR}, "
                  f"{norm_rel} <= {TRAIN_GNORM_BAR}")
    del batch0
    torch.cuda.empty_cache()

    # The main path: the loop, its counts read around it.
    step = make_train_step(model, opt)
    step_s = []

    def timed_step(st, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, metrics = step(st, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return st, metrics

    armed = [True]

    def failure_hook(i):
        if i == TRAIN_FAIL_AT and armed[0]:
            armed[0] = False
            raise RuntimeError("injected device loss")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckdir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for fn in counters.values():
            fn.launches = 0
        copies = adamw.contiguous_grads.copies
        t = time.perf_counter()
        run = run_loop(timed_step, state, data, LoopConfig(
            total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_CKPT_EVERY,
            checkpoint_dir=ckdir, keep=1, log_every=0), put_batch=put,
            failure_hook=failure_hook,
            log=lambda msg: print(f"  {msg}", flush=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in counters.items()}
        grad_copies = adamw.contiguous_grads.copies - copies
    peak = torch.cuda.max_memory_allocated(dev)
    state = run["state"]
    steps_run = run["loss_steps"]
    n = len(steps_run)
    want = {"dvfs_opt": 0, "flash_attention": 2 * L * n,
            "flash_attention_bwd": L * n, "ssd_scan": 0, "ssd_scan_bwd": 0,
            "adamw_sq_norms": 2 * n, "adamw_update": n, "causal_conv": 0,
            "causal_conv_bwd": 0}
    checks.expect(launches == want,
                  f"train: launches {launches} over {n} steps, want {want} "
                  "(the forward kernel twice a layer with remat, the "
                  "backward once; AdamW's three a step)")
    checks.expect(grad_copies == 0,
                  f"train: {grad_copies} gradients copied to be contiguous")
    first, replay = {}, {}
    for i, loss in zip(steps_run, run["losses"]):
        (replay if i in first else first)[i] = loss
    checks.expect(run["recoveries"] == 1 and run["final_step"] == TRAIN_STEPS
                  and sorted(replay) == list(range(TRAIN_CKPT_EVERY + 1,
                                                   TRAIN_FAIL_AT)),
                  f"train: {run['recoveries']} recoveries, final step "
                  f"{run['final_step']}, steps run {steps_run}")
    checks.expect(all(math.isfinite(x) for x in run["losses"])
                  and all(replay[i] == first[i] for i in replay),
                  f"train: losses finite, replayed {replay} equal to the "
                  f"first run's {first}")
    checks.expect(first[TRAIN_STEPS - 1] < first[0],
                  f"train: loss falls, {first[0]} -> {first[TRAIN_STEPS - 1]}")

    # One more step under the profiler: device busy against the wall, the
    # two attention kernels' shares of the device time.
    from torch.profiler import ProfilerActivity, profile
    batch = put(data.batch(TRAIN_STEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t
    step_peak = torch.cuda.max_memory_allocated(dev)
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    split, top = device_split(events, "flash_")   # both attention kernels
    bwd_ms, n_bwd = device_split(events, "flash_bwd")[0]["kernel"]
    fwd_ms, n_fwd = device_split(events, "flash_fwd")[0]["kernel"]
    mm_ms = split["matmuls"][0]
    step_med = statistics.median(step_s[1:])   # the first step warms up
    result = {
        "params": n_params, "batch": B, "seq": S, "layers": L,
        "first_step": {"loss": k_loss, "plain_loss": p_loss,
                       "loss_rel": loss_rel, "grad_norm": k_norm,
                       "plain_grad_norm": p_norm, "grad_norm_rel": norm_rel},
        "launches": launches, "steps_run": steps_run,
        "losses_first": first, "losses_replayed": replay,
        "step_s": step_s, "step_s_median": step_med,
        "tokens_per_s": B * S / step_med, "loop_wall_s": wall,
        "peak_gib": peak / 2**30, "step_peak_gib": step_peak / 2**30,
        "profiled_step_wall_ms": p_wall * 1e3,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / 1e3 / p_wall,
        "bwd_kernel_ms": bwd_ms, "bwd_share": bwd_ms / busy,
        "fwd_kernel_ms": fwd_ms, "fwd_share": fwd_ms / busy,
        "matmul_ms": mm_ms, "matmul_share": mm_ms / busy}
    print(f"phase train {TRAIN_ARCH}: {n_params} parameters, {L} layers, "
          f"B {B} S {S} succ, AdamW lr {TRAIN_LR} cosine (warmup {WARMUP}), "
          f"remat; first step through the kernels: loss {k_loss:.6f}, grad "
          f"norm {k_norm:.6f}; plain versions: {p_loss:.6f}, {p_norm:.6f} "
          f"(rel {loss_rel:.3e}, {norm_rel:.3e}); loop: steps run "
          f"{steps_run}, recoveries {run['recoveries']}, launches "
          f"{launches}; losses "
          + ", ".join(f"{i}: {x:.6f}" for i, x in sorted(first.items()))
          + "; replayed after restoring step "
          f"{TRAIN_CKPT_EVERY}: "
          + ", ".join(f"{i}: {x:.6f} (first run {first[i]:.6f}, equal "
                      f"{x == first[i]})" for i, x in sorted(replay.items()))
          + f"; step {step_med:.4f} s (median of {len(step_s) - 1} after "
          f"the first; all {[round(x, 4) for x in step_s]}), "
          f"{B * S / step_med:.1f} tokens/s, loop wall {wall:.2f} s with "
          f"checkpoints, peak memory {peak / 2**30:.3f} GiB over the loop "
          "(a restore holds two states)", flush=True)
    print(f"phase train {TRAIN_ARCH} step profile: wall {p_wall * 1e3:.3f} "
          f"ms, peak memory of the step {step_peak / 2**30:.3f} GiB, device "
          f"busy {busy:.3f} ms, idle share "
          f"{1.0 - busy / 1e3 / p_wall:.4f}; flash_attention_bwd "
          f"{bwd_ms:.3f} ms x{n_bwd} ({bwd_ms / busy:.1%}), "
          f"flash_attention {fwd_ms:.3f} ms x{n_fwd} "
          f"({fwd_ms / busy:.1%}), matmuls {mm_ms:.3f} ms "
          f"({mm_ms / busy:.1%}); top of the rest: {top}", flush=True)
    del state, run, model, batch
    torch.cuda.empty_cache()
    return result


def train_mamba2_phase(checks, np, torch, dev, seed: int) -> dict:
    """The ssm family's training path at full width and depth: the first
    step through the kernels against the plain versions, then
    ``TRAIN_SSM_STEPS`` steps with the launch counts read around them, and
    one profiled step."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import adamw
    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch.train import WARMUP, preset_config
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import init_state, make_train_step

    counters = kernel_counters()
    cfg = preset_config(TRAIN_SSM_ARCH, "full")
    L, B, S = cfg.n_layers, TRAIN_BATCH, TRAIN_SEQ
    model = Model(cfg, device=dev)
    opt = AdamW(learning_rate=cosine_schedule(TRAIN_LR, WARMUP,
                                              TRAIN_SSM_STEPS))
    data = SyntheticLMData.for_config(cfg, S, B, seed=seed, mode="succ")
    state = init_state(model, opt, seed)
    n_params = sum(t.numel() for t in _tensors(state.params))

    def put(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    # The first step through the kernels, then through the plain versions
    # (no kernel may launch there), on the same parameters and batch.
    batch0 = put(data.batch(0))
    k_loss, k_norm = _loss_and_grad_norm(torch, model, state.params, batch0)
    before = {name: fn.launches for name, fn in counters.items()}
    with model_kernels(fa.flash_attention_plain, ss.ssd_scan_plain,
                       cc.causal_conv_plain):
        p_loss, p_norm = _loss_and_grad_norm(torch, model, state.params,
                                             batch0)
    plain_launches = {name: fn.launches - before[name]
                      for name, fn in counters.items()}
    checks.expect(not any(plain_launches.values()),
                  f"train {TRAIN_SSM_ARCH}: the plain path launched "
                  f"{plain_launches}")
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    norm_rel = abs(k_norm - p_norm) / p_norm
    checks.expect(math.isfinite(k_loss) and math.isfinite(k_norm)
                  and loss_rel <= TRAIN_LOSS_BAR
                  and norm_rel <= TRAIN_GNORM_BAR,
                  f"train {TRAIN_SSM_ARCH}: first step through the kernels, "
                  f"loss {k_loss} and grad norm {k_norm}, against the plain "
                  f"versions' {p_loss} and {p_norm}: rel {loss_rel} <= "
                  f"{TRAIN_LOSS_BAR}, {norm_rel} <= {TRAIN_GNORM_BAR}")
    del batch0
    torch.cuda.empty_cache()

    # The main path: the steps, their counts read around them.
    step = make_train_step(model, opt)
    step_s, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    copies = adamw.contiguous_grads.copies
    for i in range(TRAIN_SSM_STEPS):
        batch = put(data.batch(i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = {name: fn.launches for name, fn in counters.items()}
    grad_copies = adamw.contiguous_grads.copies - copies
    peak = torch.cuda.max_memory_allocated(dev)
    n = TRAIN_SSM_STEPS
    want = {name: 0 for name in counters}
    want.update(ssd_scan=2 * L * n, ssd_scan_bwd=L * n,
                adamw_sq_norms=2 * n, adamw_update=n,
                causal_conv=2 * L * n, causal_conv_bwd=L * n)
    checks.expect(launches == want,
                  f"train {TRAIN_SSM_ARCH}: launches {launches} over {n} "
                  f"steps, want {want} (the forward kernels twice a layer "
                  "with remat, the SSD scan each time writing its chunk "
                  "states, the backward ones once: two kernel launches a "
                  "call; AdamW's three a step)")
    checks.expect(grad_copies == 0,
                  f"train {TRAIN_SSM_ARCH}: {grad_copies} gradients copied "
                  "to be contiguous")
    checks.expect(all(math.isfinite(x) for x in losses),
                  f"train {TRAIN_SSM_ARCH}: losses {losses} finite")

    # One more step under the profiler: device busy against the wall, the
    # SSD kernels' shares of the device time.
    from torch.profiler import ProfilerActivity, profile
    batch = put(data.batch(n))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    split, top = device_split(events, "ssd_")   # the SSD kernels together
    fwd_ms, n_fwd = device_split(events, "ssd_fwd")[0]["kernel"]
    bwd_ms, n_bwd = device_split(events, "ssd_bwd")[0]["kernel"]
    state_ms, chunk_ms = (device_split(events, k)[0]["kernel"][0]
                          for k in SSD_BWD_KERNELS)
    conv_ms, n_conv = device_split(events, "causal_conv1d")[0]["kernel"]
    mm_ms = split["matmuls"][0]
    step_med = statistics.median(step_s[1:])   # the first step warms up
    result = {
        "params": n_params, "batch": B, "seq": S, "layers": L,
        "first_step": {"loss": k_loss, "plain_loss": p_loss,
                       "loss_rel": loss_rel, "grad_norm": k_norm,
                       "plain_grad_norm": p_norm, "grad_norm_rel": norm_rel},
        "launches": launches, "losses": losses, "step_s": step_s,
        "step_s_median": step_med, "tokens_per_s": B * S / step_med,
        "peak_gib": peak / 2**30, "profiled_step_wall_ms": p_wall * 1e3,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / 1e3 / p_wall,
        "ssd_fwd_ms": fwd_ms, "ssd_fwd_share": fwd_ms / busy,
        "ssd_bwd_ms": bwd_ms, "ssd_bwd_share": bwd_ms / busy,
        "ssd_bwd_state_ms": state_ms, "ssd_bwd_chunk_ms": chunk_ms,
        "causal_conv_ms": conv_ms, "causal_conv_launches": n_conv,
        "matmul_ms": mm_ms, "matmul_share": mm_ms / busy,
        "rest_ms": split["rest"][0], "rest_share": split["rest"][0] / busy}
    print(f"phase train {TRAIN_SSM_ARCH}: {n_params} parameters, {L} "
          f"layers, B {B} S {S} succ, AdamW lr {TRAIN_LR} cosine (warmup "
          f"{WARMUP}), remat; first step through the kernels: loss "
          f"{k_loss:.6f}, grad norm {k_norm:.6f}; plain versions: "
          f"{p_loss:.6f}, {p_norm:.6f} (rel {loss_rel:.3e}, {norm_rel:.3e}); "
          f"{n} steps, launches {launches}, losses "
          + ", ".join(f"{x:.6f}" for x in losses)
          + f"; step {step_med:.4f} s (median of {n - 1} after the first; "
          f"all {[round(x, 4) for x in step_s]}), {B * S / step_med:.1f} "
          f"tokens/s, peak memory {peak / 2**30:.3f} GiB", flush=True)
    print(f"phase train {TRAIN_SSM_ARCH} step profile: wall "
          f"{p_wall * 1e3:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1.0 - busy / 1e3 / p_wall:.4f}; ssd_scan_bwd {bwd_ms:.3f} ms "
          f"x{n_bwd} ({bwd_ms / busy:.1%}; ssd_bwd_state {state_ms:.3f} ms "
          f"and ssd_bwd_chunk {chunk_ms:.3f} ms of it), ssd_scan "
          f"{fwd_ms:.3f} ms "
          f"x{n_fwd} ({fwd_ms / busy:.1%}), the causal conv's kernels "
          f"{conv_ms:.3f} ms x{n_conv} ({conv_ms / busy:.1%}, in the "
          f"rest), matmuls {mm_ms:.3f} ms "
          f"({mm_ms / busy:.1%}), the rest {split['rest'][0]:.3f} ms "
          f"({split['rest'][0] / busy:.1%}); top of the rest: {top}",
          flush=True)
    del state, model, batch
    torch.cuda.empty_cache()
    return result


def train_families_phase(checks, torch, dev, seed: int) -> dict:
    """One train step of each other family's smoke preset on the card:
    finite loss and gradient norm with the backward kernel of every model
    kernel the arch's prefill calls (``kernel_calls``) launched: the SSD
    scan's for ssm, the attention's for the others, both for a hybrid with
    Mamba-2 layers."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.train import preset_config
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import init_state, make_train_step

    counters = kernel_counters()
    out = {}
    for arch in TRAIN_FAMILY_ARCHS:
        cfg = preset_config(arch, "smoke")
        model = Model(cfg, device=dev)
        opt = AdamW()
        state = init_state(model, opt, seed)
        step = make_train_step(model, opt)
        batch = SyntheticLMData.for_config(
            cfg, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_BATCH, seed=seed,
            mode="succ").batch(0)
        for fn in counters.values():
            fn.launches = 0
        state, m = step(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        launches = {name: fn.launches for name, fn in counters.items()}
        bwd = [f"{name}_bwd" for name in ("flash_attention", "ssd_scan",
                                          "causal_conv")
               if kernel_calls(cfg, name)]
        checks.expect(math.isfinite(loss) and math.isfinite(gnorm) and bwd
                      and all(launches[name] > 0 for name in bwd),
                      f"train {arch}: loss {loss}, grad norm {gnorm}, "
                      f"launches {launches}")
        out[arch] = {"family": cfg.family, "loss": loss, "grad_norm": gnorm,
                     "launches": launches}
        print(f"phase train family {arch} ({cfg.family}, smoke preset, B "
              f"{TRAIN_FAMILY_BATCH} S {TRAIN_FAMILY_SEQ}): loss {loss:.6f}, "
              f"grad norm {gnorm:.6f}, launches {launches}", flush=True)
        del state, model
    torch.cuda.empty_cache()
    return out


def mesh_phase(checks, np, torch, dev, seed: int) -> dict:
    """The multi-device layer on one card: ``dvfs_solve_matrix`` split over
    the card listed twice against one launch; then a one-rank NCCL (1, 1)
    mesh, danube served under ``serve_rules`` and trained one step under
    ``fsdp_rules``, each against the same run without a mesh (tokens; loss
    and updated parameters), the launch counts of the mesh path, a
    checkpoint restored onto the mesh, and the times with and without
    it."""
    import tempfile

    from torch.utils import _pytree as pytree

    from repro_torch import partition
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.core import dvfs, online, solver_cache, tasks
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh, process_group
    from repro_torch.launch.serve import Request, Server
    from repro_torch.launch.train import WARMUP, preset_config
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import (init_state, make_state_axes,
                                           make_train_step)

    # The split: the online day's largest launch matrix (recorded from a
    # rerun of phase 3's day) and a 300k-row fuzz matrix, over the card
    # listed twice, against one launch and against the default device list.
    kept = []
    inner = ops.dvfs_solve_kernel

    def keep_largest(t, **kw):
        if not kept or t.shape[0] > kept[0].shape[0]:
            kept[:] = [t.detach().cpu().numpy()]
        return inner(t, **kw)

    solver_cache.GLOBAL_CACHE.clear()
    ops.dvfs_solve_kernel = keep_largest
    try:
        online.schedule_online(tasks.generate_trace(100_000, "uniform",
                                                    seed=0),
                               l=4, theta=0.9, algorithm="edl",
                               classes=CLASSES, use_kernel=True,
                               pipeline=True, device=dev)
    finally:
        ops.dvfs_solve_kernel = inner
    twice = [torch.device(dev.type, 0)] * 2
    split = {}
    for name, mat in (("day", kept[0]),
                      ("fuzz", fuzz_matrix(np, dvfs, tasks, seed,
                                           MAIN_ROWS))):
        m = mat.shape[0]
        runs = {}
        visible = ops.solve_devices
        for label, kw, listed in (("split", {}, lambda d: twice),
                                  ("one", {"shard": False}, visible),
                                  ("default", {}, visible)):
            ops.solve_devices = listed
            try:
                with launch_rows(ops) as rows:
                    t = time.perf_counter()
                    got = ops.dvfs_solve_matrix(mat, device=dev, **kw)
                    runs[label] = (got, rows, time.perf_counter() - t)
            finally:
                ops.solve_devices = visible
        nd, chunk = ops.split_plan(m, 2)
        same = bool(np.array_equal(runs["split"][0], runs["one"][0]))
        want_default = [m] if torch.cuda.device_count() == 1 else None
        checks.expect(same and runs["split"][1] == [chunk] * nd
                      and runs["one"][1] == [m]
                      and want_default in (None, runs["default"][1])
                      and bool(np.array_equal(runs["default"][0],
                                              runs["one"][0])),
                      f"mesh: split of the {name} matrix ({m} rows): "
                      f"bit-equal {same}, launches {runs['split'][1]} (want "
                      f"{[chunk] * nd}), one launch {runs['one'][1]}, "
                      f"default list {runs['default'][1]}")
        split[name] = {"rows": m, "launch_rows": runs["split"][1],
                       "bit_equal": same,
                       "default_launch_rows": runs["default"][1],
                       "split_s": runs["split"][2], "one_s": runs["one"][2]}
        print(f"phase mesh split {name}: {m} rows over {twice}: launches of "
              f"{runs['split'][1]} rows (pads {nd * chunk - m}), bit-equal "
              f"to one launch {same}; the default device list launched "
              f"{runs['default'][1]} on {torch.cuda.device_count()} card(s); "
              f"host wall {runs['split'][2]:.4f} s split, "
              f"{runs['one'][2]:.4f} s one launch", flush=True)
    del kept

    counters = kernel_counters()
    cfg = preset_config(TRAIN_ARCH, "full")
    L = cfg.n_layers
    model = Model(cfg, device=dev)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT))
    max_seq = SERVE_PROMPT + SERVE_GEN + 8
    opt = AdamW(learning_rate=cosine_schedule(TRAIN_LR, WARMUP, TRAIN_STEPS))
    data = SyntheticLMData.for_config(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=seed,
                                      mode="succ")
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in data.batch(i).items()} for i in range(3)]

    def serve(place):
        params = place(model.init(seed))
        srv = Server(model, params, SERVE_REQUESTS, max_seq=max_seq,
                     device=dev)
        del params
        srv.run([Request(rid=i, prompt=prompts[i], max_new=2)
                 for i in range(SERVE_REQUESTS)])         # warm-up
        reqs = [Request(rid=i, prompt=prompts[i], max_new=SERVE_GEN)
                for i in range(SERVE_REQUESTS)]
        stats = srv.run(reqs)
        del srv
        return [r.out for r in reqs], stats

    def train(param_axes=None):
        """Three steps from the seed's state: the first step's loss and
        parameters, each step's time; then AdamW's update alone (zero
        gradients, the same operations), the faster of two."""
        state = init_state(model, opt, seed)
        step = make_train_step(model, opt, param_axes=param_axes)
        losses, step_s, after = [], [], None
        for batch in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            if after is None:
                after = [(x.to_local() if partition.is_dtensor(x) else x)
                         .clone() for x in pytree.tree_leaves(state.params)]
        zeros = pytree.tree_map(torch.zeros_like, state.params)
        update_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            opt.update(zeros, state.opt, state.params)
            torch.cuda.synchronize()
            update_s.append(time.perf_counter() - t)
        return state, losses, step_s, after, min(update_s)

    toks, plain = serve(lambda p: p)
    state, plain_losses, plain_step_s, plain_after, plain_update = train()
    del state
    torch.cuda.empty_cache()

    with process_group(dev):
        mesh = make_host_mesh(1, 1, device=dev)
        serve_rules = partition.serve_rules(mesh, SERVE_REQUESTS)
        fsdp_rules = partition.fsdp_rules(mesh, TRAIN_BATCH)
        for fn in counters.values():
            fn.launches = 0
        with partition.use_rules(serve_rules):
            mesh_toks, meshed = serve(lambda p: partition.place(
                p, partition.param_shardings(serve_rules,
                                             model.param_axes())))
        serve_launches = {name: fn.launches for name, fn in counters.items()}
        with partition.use_rules(fsdp_rules):
            state, mesh_losses, mesh_step_s, mesh_after, mesh_update = train(
                model.param_axes())
        launches = {name: fn.launches for name, fn in counters.items()}
        checks.expect(mesh_toks == toks,
                      f"mesh: danube's tokens under serve_rules on a (1, 1) "
                      f"mesh differ from the same server's without a mesh at "
                      f"{sum(a != b for x, y in zip(mesh_toks, toks) for a, b in zip(x, y))} "
                      "places")
        diff = [float((a.float() - b.float()).abs().max())
                for a, b in zip(mesh_after, plain_after)]
        equal = sum(torch.equal(a, b) for a, b in zip(mesh_after,
                                                      plain_after))
        del mesh_after, plain_after
        checks.expect(mesh_losses[0] == plain_losses[0]
                      and equal == len(diff),
                      f"mesh: first step under fsdp_rules, loss "
                      f"{mesh_losses[0]} against {plain_losses[0]} without a "
                      f"mesh, {equal} of {len(diff)} parameters equal (max "
                      f"abs diff {max(diff)})")
        # Two Server.run calls (the warm-up and the timed one), a prefill
        # each; the forward twice a layer a step with remat, the backward
        # once.
        # AdamW: each step's update and the two timed updates alone.
        steps = len(batches)
        want = {"dvfs_opt": 0, "flash_attention": 2 * L + 2 * L * steps,
                "flash_attention_bwd": L * steps, "ssd_scan": 0,
                "ssd_scan_bwd": 0, "adamw_sq_norms": 2 * (steps + 2),
                "adamw_update": steps + 2, "causal_conv": 0,
                "causal_conv_bwd": 0}
        checks.expect(launches == want,
                      f"mesh: launches {launches} on the mesh path (serve "
                      f"{serve_launches}), want {want}")

        # The state saved, then restored with the mesh's shardings.
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as ckdir:
            store = CheckpointStore(ckdir, keep=1)
            t = time.perf_counter()
            store.save(steps, state, blocking=True)
            save_s = time.perf_counter() - t
            sh = partition.param_shardings(
                fsdp_rules, make_state_axes(model.param_axes()))
            t = time.perf_counter()
            restored, at = store.restore(state, shardings=sh)
            restore_s = time.perf_counter() - t
        same = [torch.equal(a.to_local(), b.to_local())
                and a.placements == b.placements
                for a, b in zip(pytree.tree_leaves(restored),
                                pytree.tree_leaves(state))]
        checks.expect(at == steps and all(same),
                      f"mesh: checkpoint restored onto the mesh at step {at}, "
                      f"{sum(same)} of {len(same)} leaves equal with their "
                      "placements")
        del state, restored
    torch.cuda.empty_cache()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    p_step, m_step = (statistics.median(x[1:]) for x in (plain_step_s,
                                                        mesh_step_s))
    print(f"phase mesh: h2o-danube-1.8b on a one-rank NCCL (1, 1) mesh; "
          f"serve_rules: {SERVE_REQUESTS} requests x {SERVE_PROMPT} + "
          f"{SERVE_GEN} tokens equal to the server's without a mesh "
          f"{mesh_toks == toks}; fsdp_rules: step losses {mesh_losses} "
          f"(without a mesh {plain_losses}), {equal} of {len(diff)} "
          f"parameters bit-equal after the first step; launches {launches} "
          f"(serve {serve_launches}); checkpoint of {len(same)} leaves saved "
          f"in {save_s:.2f} s, restored onto the mesh in {restore_s:.2f} s, "
          f"equal {all(same)}", flush=True)
    print(f"phase mesh times ({smi}): serve prefill {plain['prefill_s']:.4f} "
          f"s without the mesh, {meshed['prefill_s']:.4f} s with it; decode "
          f"{plain['decode_s']:.4f} s, {meshed['decode_s']:.4f} s "
          f"({plain['tok_per_s']:.1f}, {meshed['tok_per_s']:.1f} tokens/s); "
          f"train step {p_step:.4f} s, {m_step:.4f} s (median of steps 2-3; "
          f"all {[round(x, 4) for x in plain_step_s]}, "
          f"{[round(x, 4) for x in mesh_step_s]}), of which AdamW's update "
          f"{plain_update:.4f} s, {mesh_update:.4f} s", flush=True)
    return {"split": split, "launches": launches,
            "serve_launches": serve_launches,
            "tokens_equal": mesh_toks == toks,
            "losses": mesh_losses, "plain_losses": plain_losses,
            "params_equal": equal, "params": len(diff),
            "checkpoint_equal": all(same), "save_s": save_s,
            "restore_s": restore_s, "card": smi,
            "serve_s": {"prefill": plain["prefill_s"],
                        "decode": plain["decode_s"]},
            "serve_mesh_s": {"prefill": meshed["prefill_s"],
                             "decode": meshed["decode_s"]},
            "step_s": p_step, "step_mesh_s": m_step,
            "adamw_s": plain_update, "adamw_mesh_s": mesh_update}


def opcheck_phase(checks, torch, dev, seed: int) -> dict:
    """``torch.library.opcheck`` of the model kernels' custom ops on real
    CUDA inputs: danube's attention shape (the forward with its lse, the
    backward from the forward's own output), mamba2-370m's SSD shape (the
    forward with its chunk states, the backward from them) and its causal
    conv's (a strided view of an in_proj row, with a state).  Each of
    opcheck's tests on its own: the schema, the autograd registration, the
    fake implementation against the launch (sizes, dtypes, strides) and an
    AOT-autograd trace with dynamic shapes."""
    B, S, H, KV, dh, _ = dict(ATTN_SHAPES)["serve"]
    Bs, Ss, Hs, P, N = SSD_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    q, k, v = rand(B, S, H, dh), rand(B, S, KV, dh), rand(B, S, KV, dh)
    o, lse = torch.ops.repro_torch.flash_attention(q, k, v, True, None, 0,
                                                   True)
    x, b, c = rand(Bs, Ss, Hs, P), rand(Bs, Ss, N), rand(Bs, Ss, N)
    dt = rand(Bs, Ss, Hs, dtype=torch.float32, scale=0.05).abs()
    a = -torch.rand((Hs,), generator=gen, device=dev) - 0.5
    states = torch.ops.repro_torch.ssd_scan(x, dt, a, b, c, None, True)[2]
    Bc, Sc, di, Nc, Hc = dict(CONV_SHAPES)["mamba2"]
    zxbcdt = rand(Bc, Sc, 2 * di + 2 * Nc + Hc)
    xc = zxbcdt[..., di:2 * di + 2 * Nc]
    wc, bc = rand(CONV_WIDTH, di + 2 * Nc), rand(di + 2 * Nc)
    sc = rand(Bc, CONV_WIDTH - 1, di + 2 * Nc)
    cases = {
        "flash_attention": (q, k, v, True, None, 0, True),
        "flash_attention_bwd": (q, k, v, o, lse, rand(B, S, H, dh), True,
                                None, 0),
        "ssd_scan": (x, dt, a, b, c, None, True),
        "ssd_scan_bwd": (x, dt, a, b, c, states, rand(Bs, Ss, Hs, P), None,
                         False),
        "causal_conv": (xc, wc, bc, sc),
        "causal_conv_bwd": (xc, wc, bc, sc, rand(Bc, Sc, di + 2 * Nc))}
    utils = ("test_schema", "test_autograd_registration", "test_faketensor",
             "test_aot_dispatch_dynamic")
    out = {}
    for name, args in cases.items():
        res = {}
        for util in utils:
            r = torch.library.opcheck(getattr(torch.ops.repro_torch, name),
                                      args, test_utils=util,
                                      raise_exception=False)[util]
            res[util] = r if r == "SUCCESS" else f"{type(r).__name__}: {r}"
        out[name] = res
        checks.expect(all(r == "SUCCESS" for r in res.values()),
                      f"dryrun: opcheck of repro_torch::{name}: {res}")
    torch.cuda.synchronize()
    print("phase dryrun opcheck (danube's attention shape B 8 S 2048 H 32 "
          "KV 8 dh 80, mamba2-370m's SSD shape B 8 S 2048 H 32 P 64 N 128 "
          "and its conv's, C 2,304 of an in_proj row of 4,384, with a "
          "state): "
          + "; ".join(f"{name} "
                      + ", ".join(f"{u.removeprefix('test_')} {r}"
                                  for u, r in res.items())
                      for name, res in out.items()), flush=True)
    del q, k, v, o, lse, x, b, c, dt, a, states, cases, zxbcdt, xc, wc, bc
    del sc

    # What the dispatcher adds to a call: the forward through the op and
    # through its CUDA implementation called directly, at a shape so small
    # that the host's work is the call's time; in turns.
    from repro_torch.kernels import flash_attention as fa
    q = rand(1, 64, 2, 64)
    args = (q, q, q, True, None, 0, False)
    times = {"op": [], "direct": []}
    for name in ("op", "direct", "direct", "op", "op", "direct"):
        fn = (torch.ops.repro_torch.flash_attention.default if name == "op"
              else fa._flash_attention_launch)
        fn(*args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(OP_CALLS):
            fn(*args)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t) / OP_CALLS * 1e6)
    op_us, direct_us = (min(v) for v in (times["op"], times["direct"]))
    out["dispatch_us"] = {"op": op_us, "direct": direct_us,
                          "added": op_us - direct_us}
    print(f"phase dryrun dispatch: the attention forward at B 1 S 64 H 2 "
          f"dh 64, {OP_CALLS} calls back to back, best of 3: through the "
          f"op {op_us:.2f} us a call, its implementation called directly "
          f"{direct_us:.2f} us; the dispatcher adds {op_us - direct_us:.2f} "
          "us a call", flush=True)
    del q, args
    torch.cuda.empty_cache()
    return out


def dryrun_phase(checks, np, torch, dev, seed: int) -> dict:
    """The dry-run (``launch/dryrun.py``) against the card: the custom ops
    checked (:func:`opcheck_phase`); h2o-danube-1.8b's ``train_4k`` cell at
    B 4 traced on a fake (1, 1) mesh and the same step run for real under
    ``FlopCounterMode`` (FLOPs equal) and once more without it (its
    transient peak within ``DRYRUN_PEAK_BAR`` of the trace's temporaries),
    the kernels' launches read around each real step and none during the
    trace; then the cell on the 256-rank fake production mesh with its
    probes."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import init_state, make_train_step

    opcheck = opcheck_phase(checks, torch, dev, seed)
    counters = kernel_counters()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    hbm = torch.cuda.get_device_properties(dev).total_memory
    print(f"phase dryrun card: {smi}; total_memory {hbm} bytes "
          f"({hbm / 2**30:.3f} GiB); dryrun.HBM_BYTES {dryrun.HBM_BYTES} "
          f"(equal {hbm == dryrun.HBM_BYTES})", flush=True)

    # The trace: nothing launched.
    arch, shape = TRAIN_ARCH, "train_4k"
    before = {name: fn.launches for name, fn in counters.items()}
    t = time.perf_counter()
    with fake_mesh((1, 1)) as mesh:
        tr, _ = dryrun.trace_cell(arch, shape, mesh, batch_rows=DRYRUN_ROWS,
                                  microbatches=1)
    trace_s = time.perf_counter() - t
    cap = dryrun.capture(tr)
    traced = {name: fn.launches - before[name]
              for name, fn in counters.items()}
    checks.expect(not any(traced.values()),
                  f"dryrun: the trace launched {traced}")

    # The same step for real, its kernels counted around it.
    cfg = registry.get_config(arch)
    S = registry.SHAPES[shape].seq_len
    model = Model(cfg, device=dev)
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 100, 10_000))
    state = init_state(model, opt, seed)
    step = make_train_step(model, opt, microbatches=1)
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (DRYRUN_ROWS, S)).astype(np.int32)).to(dev)
        for k in ("tokens", "labels")}
    def run(counter):
        """One step, its kernels counted around it: (the step's transient
        peak over what was allocated before it, seconds, launches, loss)."""
        nonlocal state
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        with counter:
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated(dev) - base,
                time.perf_counter() - t,
                {name: fn.launches for name, fn in counters.items()}, loss)

    # The FLOPs from a step under the counter; the transient peak from the
    # next step without it (under FlopCounterMode the card's step holds
    # more, which a step run without the counter does not).
    real = FlopCounterMode(display=False)
    counted, step_s, launches, loss = run(real)
    transient, plain_s, plain_launches, plain_loss = run(
        contextlib.nullcontext())
    base = torch.cuda.memory_allocated(dev)
    del state, batch, model, step
    torch.cuda.empty_cache()

    L = cfg.n_layers
    want = {"dvfs_opt": 0, "flash_attention": 2 * L,
            "flash_attention_bwd": L, "ssd_scan": 0, "ssd_scan_bwd": 0,
            "adamw_sq_norms": 2, "adamw_update": 1, "causal_conv": 0,
            "causal_conv_bwd": 0}
    checks.expect(launches == want == plain_launches
                  and math.isfinite(loss) and math.isfinite(plain_loss),
                  f"dryrun: the real steps launched {launches} and "
                  f"{plain_launches}, want {want}; losses {loss}, "
                  f"{plain_loss}")
    t_flops = tr.flops.get_flop_counts()["Global"]
    r_flops = real.get_flop_counts()["Global"]
    diff = {str(op): (t_flops.get(op, 0), r_flops.get(op, 0))
            for op in set(t_flops) | set(r_flops)
            if t_flops.get(op, 0) != r_flops.get(op, 0)}
    traced_flops, real_flops = cap["cost"]["flops"], real.get_total_flops()
    checks.expect(traced_flops == real_flops and not diff,
                  f"dryrun: traced FLOPs {traced_flops} against the real "
                  f"step's {real_flops}; op by op (trace, real) {diff}")
    temp = cap["memory"]["temp_size_in_bytes"]
    ratio = transient / temp
    checks.expect(abs(ratio - 1.0) <= DRYRUN_PEAK_BAR,
                  f"dryrun: the real step's transient peak {transient} bytes "
                  f"against the trace's temporaries {temp}: ratio {ratio} "
                  f"outside 1 +- {DRYRUN_PEAK_BAR}")
    print(f"phase dryrun {arch} {shape} B {DRYRUN_ROWS} S {S} ({smi}): "
          f"traced in {trace_s:.2f} s on a fake (1, 1) mesh, launches during "
          f"the trace {traced}; FLOPs traced {traced_flops:.0f}, real step "
          f"{real_flops:.0f} (equal {traced_flops == real_flops}; by op "
          + ", ".join(f"{op} {n}" for op, n in sorted(
              (str(k), v) for k, v in r_flops.items()))
          + f"); transient peak {transient} bytes ({transient / 2**30:.3f} "
          f"GiB) against the trace's temporaries {temp} ({temp / 2**30:.3f} "
          f"GiB), ratio {ratio:.4f} (under the FLOP counter {counted} bytes, "
          f"ratio {counted / temp:.4f}); arguments traced "
          f"{cap['memory']['argument_size_in_bytes']} bytes, allocated "
          f"after the steps {base}; real steps {step_s:.3f} s (counted), "
          f"{plain_s:.3f} s, losses {loss:.6f}, {plain_loss:.6f}, launches "
          f"{launches} each", flush=True)

    # One production cell at full width and depth, with its probes.
    t = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, "single",
                          out_dir=str(ROOT / "results" / "dryrun"))
    cell_s = time.perf_counter() - t
    ok = rec["ok"] and rec["microbatches"] == DRYRUN_MICROBATCHES
    full = rec.get("full", {})
    checks.expect(ok and full["cost"]["flops"] > 0
                  and full["collectives"]["n_collectives"] > 0
                  and full["memory"]["live_bytes"] > 0,
                  f"dryrun: {arch}/{shape}/single: ok {rec['ok']}, "
                  f"microbatches {rec.get('microbatches')} (want "
                  f"{DRYRUN_MICROBATCHES}), {rec.get('error')}")
    if rec["ok"]:
        mem = full["memory"]
        print(f"phase dryrun cell {arch}/{shape}/single (256 ranks, "
              f"{rec['device']} fake tensors): mb={rec['microbatches']} "
              f"mem/dev={mem['live_bytes'] / 2**30:.2f}GiB of "
              f"{hbm / 2**30:.2f} flops={full['cost']['flops']:.6g} "
              f"coll={full['collectives']['n_collectives']} "
              f"corrected flops {rec['corrected']['flops']:.6g}; traced in "
              f"{rec['trace_s']} s, {cell_s:.2f} s with the probes", flush=True)
    return {"opcheck": opcheck, "launches": launches, "card": smi,
            "total_memory": hbm, "trace_s": trace_s, "flops": traced_flops,
            "real_flops": real_flops, "transient_bytes": transient,
            "temp_bytes": temp, "peak_ratio": ratio,
            "counted_transient_bytes": counted, "real_step_s": plain_s,
            "cell": {k: rec.get(k) for k in ("ok", "microbatches", "trace_s",
                                             "full", "corrected", "error")},
            "cell_s": cell_s}


# Kernel names as the profiler shows them, per model kernel.
KERNEL_SYMBOLS = {"flash_attention": "flash_fwd", "ssd_scan": "ssd_fwd",
                  "causal_conv": "causal_conv1d_fwd"}
# Device kernels of a matrix product (cuBLAS and CUTLASS names).
MATMUL_SYMBOLS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")


def device_events(prof) -> list:
    """A profile's entries by name (``key_averages``) less the device's
    mirrors of host ranges (``record_function``, the port's spans among
    them), which are no operation of the card's."""
    return [e for e in prof.key_averages()
            if not getattr(e, "is_user_annotation", False)]


def device_split(events, symbol) -> tuple:
    """Device time (ms) and launches of a profile by group: the kernel whose
    name holds ``symbol`` (group "kernel"; or, for a dict {group: symbol},
    each such kernel in its own group), the matmuls, everything else; and
    the five largest entries of everything else."""
    kernels = {"kernel": symbol} if isinstance(symbol, str) else symbol
    split = {**{name: [0.0, 0] for name in kernels}, "matmuls": [0.0, 0],
             "rest": [0.0, 0]}
    rest = []
    for e in events:
        ms = e.self_device_time_total / 1e3
        if ms <= 0:
            continue
        name = e.key.lower()
        group = next((g for g, sym in kernels.items() if sym in e.key),
                     None) or ("matmuls" if any(m in name
                                                for m in MATMUL_SYMBOLS)
                               else "rest")
        split[group][0] += ms
        split[group][1] += e.count
        if group == "rest":
            rest.append((ms, e.count, e.key[:48]))
    top = "; ".join(f"{key} {ms:.3f} ms x{n}"
                    for ms, n, key in sorted(rest, reverse=True)[:5])
    return {name: tuple(v) for name, v in split.items()}, top


# ---------------------------------------------------------------------------
# Phase "tp": the model axis split over ranks.
# ---------------------------------------------------------------------------


def install_gloo_cuda_collectives(torch):
    """Route ``DTensor``'s functional collectives on CUDA tensors through
    the process group's own calls, for gloo ranks that share one card.
    Gloo runs ``all_reduce``, ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor`` on CUDA tensors, but the functional
    ``all_gather_into_tensor`` that ``DTensor`` issues ends its process
    with SIGSEGV there (torch 2.11, probed on an H100); NCCL, the backend
    of one rank a card, refuses two ranks on one card.  The replacements
    are synchronous and return the collective's result."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}

    def all_gather(x, group_size, group_name):
        out = x.new_empty((x.shape[0] * group_size,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    def reduce_scatter(x, op, group_size, group_name):
        out = x.new_empty((x.shape[0] // group_size,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), op=ops[op],
                                   group=_resolve_process_group(group_name))
        return out

    def all_reduce(x, op, group_name):
        out = x.clone()
        dist.all_reduce(out, op=ops[op],
                        group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather, "CUDA")
    lib.impl("reduce_scatter_tensor", reduce_scatter, "CUDA")
    lib.impl("all_reduce", all_reduce, "CUDA")
    return lib


def tp_probe(torch, dev, world: int) -> dict:
    """``all_reduce`` (sum, max, min), ``all_gather`` and ``broadcast`` of
    CUDA tensors over the default group, each checked."""
    import torch.distributed as dist
    rank = dist.get_rank()
    x = torch.full((1024,), float(rank + 1), device=dev)
    out = {}
    for name, op, want in (("all_reduce_sum", dist.ReduceOp.SUM,
                            world * (world + 1) / 2),
                           ("all_reduce_max", dist.ReduceOp.MAX, world),
                           ("all_reduce_min", dist.ReduceOp.MIN, 1)):
        y = x.clone()
        dist.all_reduce(y, op=op)
        out[name] = bool((y == want).all())
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    out["all_gather"] = [float(t[0]) for t in parts] == [
        float(r + 1) for r in range(world)]
    y = x.clone()
    dist.broadcast(y, 0)
    out["broadcast"] = bool((y == 1).all())
    _sync(torch, dev)
    return out


class _TPShapes:
    """Records the q shapes of the attention kernel's calls and the x
    shapes of the SSD kernel's while entered (host side, no launch)."""

    def __enter__(self):
        from repro_torch.models import attention, ssm
        self.attn, self.ssd = set(), set()
        self._saved = (attention.flash_attention_kernel, ssm.ssd_scan_kernel)
        attn_fn, ssd_fn = self._saved

        def attn(q, k, v, **kw):
            self.attn.add((tuple(q.shape), tuple(k.shape)))
            return attn_fn(q, k, v, **kw)

        def ssd(x, *args, **kw):
            self.ssd.add(tuple(x.shape))
            return ssd_fn(x, *args, **kw)

        attention.flash_attention_kernel = attn
        ssm.ssd_scan_kernel = ssd
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention, ssm
        attention.flash_attention_kernel, ssm.ssd_scan_kernel = self._saved


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tp_serve(torch, np, dev, arch: str, preset: str, seed: int,
              rules) -> dict:
    """``arch`` at full width served under ``rules`` (None: one rank):
    ``Server.run``'s tokens and times, and its prefill's logits of the
    real vocab (``Model.whole_logits``, read by wrapping the model's
    ``prefill``)."""
    from repro_torch import partition
    from repro_torch.launch.serve import Request, Server
    from repro_torch.launch.train import preset_config
    from repro_torch.models.model import Model
    cfg = preset_config(arch, preset)
    model = Model(cfg, device=dev)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT))
    max_seq = SERVE_PROMPT + SERVE_GEN + 8
    with partition.use_rules(rules):
        params = model.init(seed)
        if rules is not None:
            params = partition.place(params, partition.param_shardings(
                rules, model.param_axes()))
        srv = Server(model, params, SERVE_REQUESTS, max_seq=max_seq,
                     device=dev)
        del params
        seen = []
        prefill = model.prefill

        def recording(*args, **kw):
            logits, cache = prefill(*args, **kw)
            seen.append(model.whole_logits(logits)[:, :cfg.vocab_size]
                        .float().cpu())
            return logits, cache

        model.prefill = recording
        reqs = [Request(rid=i, prompt=prompts[i], max_new=SERVE_GEN)
                for i in range(SERVE_REQUESTS)]
        stats = srv.run(reqs)
        repeats = {} if rules is None else dict(rules.repeats)
    del srv
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"logits": seen[0], "tokens": [r.out for r in reqs],
            "repeats": repeats, **stats}


class _GradSpy:
    """An optimizer that hands every gradient leaf, whole, with its path
    in the tree, to ``see`` (every rank gathers each leaf in the same
    order), then updates as ``opt`` does."""

    def __init__(self, opt, see):
        self.opt, self.see = opt, see

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        from torch.utils import _pytree as pytree

        from repro_torch import partition
        for i, (path, g) in enumerate(pytree.tree_flatten_with_path(grads)[0]):
            self.see(i, pytree.keystr(path),
                     g.full_tensor() if partition.is_dtensor(g) else g)
        return self.opt.update(grads, state, params)


def _tp_train(torch, dev, arch: str, preset: str, rows: int, seed: int,
              rules, want=None, microbatches: int = 1) -> dict:
    """One step of ``arch`` at full width on ``rows`` x TRAIN_SEQ tokens
    under ``rules`` (None: one rank), in ``microbatches``: its loss, grad
    norm and time; with ``want`` (the one-rank step's gradients, on the
    host) each leaf's cosine with it by the leaf's path, and the
    ``TP_LOWEST`` lowest with the one-rank leaf's root mean square, else
    the gradients themselves."""
    from repro_torch import partition
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.train import WARMUP, preset_config
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import init_state, make_train_step
    cfg = preset_config(arch, preset)
    model = Model(cfg, device=dev)
    data = SyntheticLMData.for_config(cfg, TRAIN_SEQ, rows, seed=seed,
                                      mode="succ")
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch(0).items()}
    grads, cos, rms = [], {}, {}

    def see(i, name, g):
        if want is None:
            grads.append(g.float().cpu())
        else:
            w = want[i].to(dev)
            g = g.float()
            cos[name] = float((g * w).sum() / torch.clamp(
                g.norm() * w.norm(), min=1e-30))
            rms[name] = float(w.norm() / w.numel() ** 0.5)

    opt = _GradSpy(AdamW(learning_rate=cosine_schedule(
        TRAIN_LR, WARMUP, TRAIN_STEPS)), see)
    with partition.use_rules(rules):
        state = init_state(model, opt, seed)
        step = make_train_step(model, opt, microbatches=microbatches,
                               param_axes=(None if rules is None
                                           else model.param_axes()))
        _sync(torch, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        state, metrics = step(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        _sync(torch, dev)
        step_s = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else 0.0)
        repeats = {} if rules is None else dict(rules.repeats)
    del state, step, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"loss": loss, "grad_norm": gnorm, "step_s": step_s,
            "peak_gib": peak, "repeats": repeats,
            **({"grads": grads} if want is None else
               {"leaves": len(cos), "min_cos": min(cos.values()),
                "cos_below": sum(c < TP_LEAF_COS for c in cos.values()),
                "cos": cos, "lowest": [(name, cos[name], rms[name])
                                       for name in sorted(cos, key=cos.get)
                                       [:TP_LOWEST]],
                "median_rms": sorted(rms.values())[len(rms) // 2]})}


def tp_worker(rank: int, world: int, backend: str, store: str, out_dir: str,
              seed: int, device_type: str = "cuda", preset: str = "full"):
    """One rank of phase "tp": the probe of the collectives; on rank 0 the
    one-rank references (served logits and tokens, a step's gradients),
    while the others wait; then, on every rank, danube and mamba2-370m
    served under ``serve_rules`` and a step of each under ``fsdp_rules`` on
    a (1, world) mesh, with the kernels' launches and shapes.  Writes its
    results to ``out_dir/rank<r>.pt`` after each stage.  ``device_type``
    and ``preset`` rehearse it on the CPU (gloo, smaller models)."""
    import datetime
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    res = {"rank": rank}
    path = Path(out_dir) / f"rank{rank}.pt"

    def save():
        torch.save(res, path)

    try:
        dev = torch.device(device_type, rank if backend == "nccl" else 0)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(minutes=10))
        shim = (install_gloo_cuda_collectives(torch)
                if backend == "gloo" and dev.type == "cuda" else None)
        res["probe"] = tp_probe(torch, dev, world)
        save()
        from repro_torch import partition
        from repro_torch.launch.mesh import make_host_mesh
        want = {}
        if rank == 0:
            for arch, rows in TP_TRAIN:
                res[f"ref_serve_{arch}"] = _tp_serve(torch, np, dev, arch,
                                                     preset, seed, None)
                ref = _tp_train(torch, dev, arch, preset, rows, seed, None)
                want[arch] = ref.pop("grads")
                res[f"ref_train_{arch}"] = ref
                # The control: the same one-rank step in two microbatches,
                # the same sums in another order and no model axis.
                res[f"ctrl_train_{arch}"] = _tp_train(
                    torch, dev, arch, preset, rows, seed, None, want[arch],
                    microbatches=2)
                save()
        dist.barrier()
        mesh = make_host_mesh(1, world, device=dev)
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        with _TPShapes() as shapes:
            for arch, rows in TP_TRAIN:
                res[f"serve_{arch}"] = _tp_serve(
                    torch, np, dev, arch, preset, seed,
                    partition.serve_rules(mesh, SERVE_REQUESTS))
                res[f"train_{arch}"] = _tp_train(
                    torch, dev, arch, preset, rows, seed,
                    partition.fsdp_rules(mesh, rows), want.get(arch))
                save()
        res["launches"] = {name: fn.launches
                           for name, fn in counters.items()}
        res["attn_shapes"] = sorted(shapes.attn)
        res["ssd_shapes"] = sorted(shapes.ssd)
        del shim
    except Exception:  # noqa: BLE001 - the phase reports it and fails
        res["error"] = traceback.format_exc()[-4000:]
    finally:
        save()
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_local_shapes_phase(checks, torch, dev, seed: int) -> dict:
    """Rank 0's share of a (1, 2) and a (1, 4) split, alone: the attention
    kernel at danube's serving shape with H / m and KV / m heads and the
    SSD kernel at mamba2-370m's with H / m heads, against their plain
    versions."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for m in (2, 4):
        B, S, H, KV, dh, window = ATTN_SHAPES[0][1]
        q, k, v = (torch.randn((B, S, h, dh), generator=gen, device=dev,
                               dtype=torch.bfloat16)
                   for h in (H // m, KV // m, KV // m))
        got = fa.flash_attention_cuda(q, k, v, causal=True, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
        a_err = norm_err(got, want)
        B, S, H, P, N = SSD_SHAPE
        x = torch.randn((B, S, H // m, P), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        dt = torch.rand((B, S, H // m), generator=gen, device=dev) * 0.1
        a = -torch.rand((H // m,), generator=gen, device=dev) - 0.5
        b, c = (torch.randn((B, S, N), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        y, st = ss.ssd_scan_cuda(x, dt, a, b, c)
        wy, wst = ss.ssd_scan_plain(x, dt, a, b, c, 64)
        s_err = max(norm_err(y, wy), norm_err(st, wst))
        checks.expect(a_err <= ATTN_BAR and s_err <= SSD_BAR,
                      f"tp: rank 0's share of a (1, {m}) split: attention "
                      f"{a_err} <= {ATTN_BAR}, ssd {s_err} <= {SSD_BAR}")
        out[m] = {"attention_err": a_err, "ssd_err": s_err}
        print(f"phase tp alone (1, {m}): attention at H {H // m}, KV "
              f"{KV // m}: err {a_err:.3e}; ssd at H {H // m}: err "
              f"{s_err:.3e}", flush=True)
    return out


def tp_phase(checks, np, torch, dev, seed: int, preset: str = "full") -> dict:
    """The model axis split over ranks: one rank a card over NCCL on a
    (1, n) mesh with two or more cards (n 2 or 4), else two processes on
    the one card over gloo.  Danube and mamba2-370m at full width served
    under ``serve_rules`` (the whole prefill's logits against one rank's,
    the first decode position where the greedy tokens differ) and one
    step of each under ``fsdp_rules`` (loss, grad norm and every leaf's
    gradient against one rank's); each rank's kernel launches and the
    shapes they ran at.  Without a working two-rank transport, rank 0's
    share alone."""
    import gc
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.launch.train import preset_config
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    # A power of two, so that danube's and mamba2's 32 heads split (on
    # three cards, two ranks).
    backend, world = (("nccl", 4 if cards >= 4 else 2) if cards >= 2
                      else ("gloo", 2))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        t = time.perf_counter()
        ctx = mp.start_processes(tp_worker, args=(world, backend,
                                                  f"{tmp}/store", tmp, seed,
                                                  dev.type, preset),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + TP_TIMEOUT_S
        exit_note = None
        try:
            while not ctx.join(timeout=max(1.0, deadline
                                           - time.monotonic())):
                if time.monotonic() >= deadline:
                    exit_note = f"ranks still running after {TP_TIMEOUT_S} s"
                    break
        except mp.ProcessExitedException as e:
            exit_note = str(e)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        wall = time.perf_counter() - t
        ranks = []
        for r in range(world):
            f = Path(tmp) / f"rank{r}.pt"
            ranks.append(torch.load(f, weights_only=False) if f.exists()
                         else {"rank": r})
    probe_ok = all(r.get("probe") and all(r["probe"].values())
                   for r in ranks)
    if not probe_ok:
        why = exit_note or [r.get("error", r.get("probe")) for r in ranks]
        print(f"phase tp: no {world}-rank run was possible ({backend} on "
              f"{cards} card(s)): the probe of all_reduce, all_gather and "
              f"broadcast on CUDA tensors failed: {why}", flush=True)
        checks.expect(backend == "gloo",
                      f"tp: the {world}-rank NCCL probe failed: {why}")
        return {"backend": backend, "ranks": 0,
                "alone": tp_local_shapes_phase(checks, torch, dev, seed)}
    errors = [r["error"] for r in ranks if "error" in r]
    checks.expect(not errors and exit_note is None,
                  f"tp: {world} {backend} ranks failed: {exit_note} "
                  f"{errors}")
    if errors or exit_note is not None:
        return {"backend": backend, "ranks": world, "failed": True}
    out = {"backend": backend, "ranks": world, "card": smi,
           "wall_s": wall, "launches": [r["launches"] for r in ranks]}
    r0 = ranks[0]
    for arch, rows in TP_TRAIN:
        ref, got = r0[f"ref_serve_{arch}"], r0[f"serve_{arch}"]
        err = float((got["logits"] - ref["logits"]).abs().max()
                    / ref["logits"].abs().max())
        diff = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                     None) for x, y in zip(got["tokens"], ref["tokens"])]
        first = min((i for i in diff if i is not None), default=None)
        tr, tref = r0[f"train_{arch}"], r0[f"ref_train_{arch}"]
        ctrl = r0[f"ctrl_train_{arch}"]
        loss_rel = abs(tr["loss"] - tref["loss"]) / abs(tref["loss"])
        gn_rel = abs(tr["grad_norm"] - tref["grad_norm"]) / tref["grad_norm"]
        checks.expect(err <= PLAIN_PATH_BAR,
                      f"tp: {arch}'s prefill logits on {world} ranks, "
                      f"err/max {err} <= {PLAIN_PATH_BAR} of one rank's")
        checks.expect(loss_rel <= TRAIN_LOSS_BAR and gn_rel <= TRAIN_GNORM_BAR
                      and tr["cos_below"] == 0,
                      f"tp: {arch}'s step on {world} ranks: loss rel "
                      f"{loss_rel} <= {TRAIN_LOSS_BAR}, grad norm rel "
                      f"{gn_rel} <= {TRAIN_GNORM_BAR}, {tr['cos_below']} of "
                      f"{tr['leaves']} leaves below cosine {TP_LEAF_COS} "
                      f"(min {tr['min_cos']})")
        for r in ranks:
            checks.expect(r[f"serve_{arch}"]["repeats"] == {}
                          and r[f"train_{arch}"]["repeats"] == {},
                          f"tp: {arch} repeated blocks on rank {r['rank']}: "
                          f"{r[f'serve_{arch}']['repeats']} "
                          f"{r[f'train_{arch}']['repeats']}")
        out[arch] = {
            "prefill_err": err, "first_token_diff": first,
            "tokens_equal": got["tokens"] == ref["tokens"],
            "loss": tr["loss"], "ref_loss": tref["loss"],
            "loss_rel": loss_rel, "grad_norm_rel": gn_rel,
            "min_leaf_cos": tr["min_cos"], "train_rows": rows,
            "lowest_leaves": [
                {"leaf": name, "cos": c, "ctrl_cos": ctrl["cos"][name],
                 "rms_over_median": rms / tr["median_rms"]}
                for name, c, rms in tr["lowest"]],
            "ctrl_min_cos": ctrl["min_cos"], "ctrl_lowest": ctrl["lowest"],
            "ref": {k: ref[k] for k in ("prefill_s", "decode_s",
                                        "tok_per_s")},
            "tp": {k: got[k] for k in ("prefill_s", "decode_s",
                                       "tok_per_s")},
            "step_s": tr["step_s"], "ref_step_s": tref["step_s"],
            "peak_gib": [r[f"train_{arch}"]["peak_gib"] for r in ranks],
            "ref_peak_gib": tref["peak_gib"]}
        tokens = ("equal" if first is None
                  else f"first differ at decode position {first}")
        print(f"phase tp {arch}: {world} {backend} ranks on (1, {world}); "
              f"prefill logits err/max {err:.4e} against one rank; greedy "
              f"tokens {tokens}; "
              f"step on {rows} x {TRAIN_SEQ} tokens: loss {tr['loss']:.6f} "
              f"(one rank {tref['loss']:.6f}, rel {loss_rel:.3e}), grad "
              f"norm rel {gn_rel:.3e}, min leaf cosine {tr['min_cos']:.6f} "
              f"over {tr['leaves']} leaves", flush=True)
        print(f"phase tp {arch} lowest leaves on {world} ranks (cosine; "
              f"the one-rank step in two microbatches, the control; the "
              f"one-rank leaf's rms over the median leaf's): " + "; ".join(
                  f"{d['leaf']} {d['cos']:.6f} (control "
                  f"{d['ctrl_cos']:.6f}, rms {d['rms_over_median']:.3e})"
                  for d in out[arch]["lowest_leaves"])
              + f"; the control's min {ctrl['min_cos']:.6f} at "
              f"{ctrl['lowest'][0][0]}", flush=True)
        print(f"phase tp {arch} times ({smi}; {backend} between processes "
              f"is a correctness transport): prefill "
              f"{got['prefill_s']:.4f} s on {world} ranks, "
              f"{ref['prefill_s']:.4f} s on one; decode "
              f"{got['tok_per_s']:.1f} tokens/s, {ref['tok_per_s']:.1f}; "
              f"step {tr['step_s']:.4f} s, {tref['step_s']:.4f} s (first "
              f"calls); peak {out[arch]['peak_gib']} GiB a rank, one rank "
              f"{tref['peak_gib']:.3f}", flush=True)
    # Each rank: danube's attention layers once in Server.run's prefill,
    # twice in the step (remat) and the backward once; mamba2's SSD layers
    # and their convs likewise.
    dcfg = preset_config("h2o-danube-1.8b", preset)
    mcfg = preset_config("mamba2-370m", preset)
    L, Ls = dcfg.n_layers, mcfg.n_layers
    want = {"dvfs_opt": 0, "flash_attention": 3 * L,
            "flash_attention_bwd": L, "ssd_scan": 3 * Ls,
            "ssd_scan_bwd": Ls, "adamw_sq_norms": 2 * len(TP_TRAIN),
            "adamw_update": len(TP_TRAIN), "causal_conv": 3 * Ls,
            "causal_conv_bwd": Ls}
    for r in ranks:
        heads = {q[2] for q, _ in r["attn_shapes"]}
        kv = {k[2] for _, k in r["attn_shapes"]}
        ssd = {x[2] for x in r["ssd_shapes"]}
        checks.expect(r["launches"] == want
                      and heads == {dcfg.n_heads // world}
                      and kv == {dcfg.n_kv_heads // world}
                      and ssd == {mcfg.n_ssm_heads // world},
                      f"tp: rank {r['rank']} launched {r['launches']} (want "
                      f"{want}) at attention heads {heads} (kv {kv}) and SSD "
                      f"heads {ssd}")
        print(f"phase tp rank {r['rank']}: launches {r['launches']}; "
              f"attention q/k shapes {r['attn_shapes']}; SSD x shapes "
              f"{r['ssd_shapes']}", flush=True)
    out["attn_shapes"] = ranks[0]["attn_shapes"]
    out["ssd_shapes"] = ranks[0]["ssd_shapes"]
    print(f"phase tp: {world} ranks over {backend} in {wall:.1f} s "
          f"(spawn, one-rank references, both models served and stepped)",
          flush=True)
    return out


def _paths(tree, prefix=""):
    """(path, tensor) pairs of a nested cache (dicts and tuples)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
