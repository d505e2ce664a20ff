#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py

Phases, one line each (plus tables):

0. the device (``torch.cuda.get_device_name``, ``nvidia-smi`` name and
   power limit); TF32 off, so every comparison is float32 against float32;
1. build the kernels from the sources in this tree (nvcc for the CUDA
   source, Triton for the generated rows kernels at first launch), with
   ptxas's registers and spills of the tensor-core kernels and the float32
   flash kernel (an instance per head dim, 64, 80, 112, 128 and 256), the
   SSD kernel, the nhwc kernels forward and backward and the two decode
   kernels' 60 instances each (dtypes x splits x head dims 64, 112, 128
   and 256);
2. the nhwc CUDA kernel against its plain version (max |d| <= 1e-5); its
   fused path (batch norm, ReLU, a 2x2/s2 max pool) at VGG-16's five stage
   shapes at batch 8 and at two odd extents, bit for bit;
3. the rows Triton kernel against its plain version at deepseek-7b widths
   (d_model 4096, d_ff 11008, 4 x 2048 rows; <= 1e-5, rtol 1e-4 for norms
   and softmax);
4. the main paths: ``optimize_graph`` of VGG-16's widths at 224 x 224,
   batch 32, float32 (``brainslug`` against ``barrier`` within 1e-4), and
   the LM block's row chains through ``optimize_stack``; dispatch and
   launch counters are zeroed before each path and read after it;
5. per-kernel device times (profiler) and per-call times (CUDA events)
   beside the plain version, a library call where one computes the same
   function, and the bound, with each VGG stage's nhwc path (fused or
   generic), items and CTAs; a traced forward per mode gives the device
   time by kernel group and the idle share;
6. the forward kernels' agreement;
7. the nhwc backward CUDA kernel against its plain version
   (``autodiff.program_vjp`` on whole tensors): phase 2's cases, a chain
   at 70 channels (two channel blocks, no float4), VGG-16's five stages at
   batch 32 and ``block_net(8, 32)`` at (32, 56, 56, 32), with their
   training tiles; two runs must give equal bits;
8. the rows backward Triton kernel against its plain version at
   deepseek-7b widths, the same way;
9. the training paths: three SGD steps through ``optimize_graph`` of the
   VGG-16 widths and through ``optimize_stack`` of the LM row chains, with
   ``differentiable=True``, ``brainslug`` against ``barrier`` (gradients
   and losses); dispatch and launch counters per step;
10. per-backward-kernel times (as phase 5; the nhwc backward's with each
   stage's work items from ``nhwc_bwd.launch_plan``), the training step in
   turns per mode, and a traced step per mode;
11-13. the LM serving slice: the rmsnorm, swiglu, flash-attention and
   flash-decode kernels against their plain versions (flash decode at D 112
   and 128, at its plan's split and every split, one set of bits),
   deepseek-7b at full width through ``lm.prefill`` and
   ``Server.generate``, and their times; flash decode at (8, 32, 32768,
   128) also bit for bit against the paged kernel on the same cache seen
   as a pool (no copy; both times and plans), and at 4 slots of 101 keys
   in that cache at the plan of its length and at the plan of the Server's
   bound (``max_keys``), each beside its time before the redesign;
14. the paged flash-decode CUDA kernel against its plain version at (8,
   32, ragged lengths up to 32768, 128), block size 16, through a shuffled
   table with sentinel tails, GQA 40/8, q in bf16 and float32 over pools
   in q's dtype and in float32; bit for bit against the dense kernel on
   the gathered view, there and at one slot of 32768, blocks of 8 and 32,
   all eight slots full, every split of the launch plan and the engine
   tick's shape;
15. the continuous-batching engine (``Server.engine(kv_layout="paged")
   .run``) over a ragged, prefix-sharing queue of 12 requests at full
   width cut to 2 layers (``ENGINE_LAYERS``), paged ``brainslug`` against
   paged ``barrier`` and dense ``brainslug`` (counters per model
   evaluation, no ``kv.*`` finding, the
   free list whole), and a float32 4-layer run with identical tokens;
16. the paged kernel's time beside its bound, its plain version and the
   dense kernel on the gathered view (bit for bit; the dense kernel's
   plan, bound, SDPA and time before its redesign), and at one slot of
   32768 and the engine tick's shape beside their bounds, each with its
   launch plan and the kernel's time before its redesign; the engine runs' wall time,
   tokens/s, TTFT and ``ServeStats``; a traced decode-only tick per mode;
17. the fused vocab cross-entropy CUDA kernel against its plain version
   (TF32 off): (4096, 4096, 102400) and ragged (1000, 4000, 50257) in bf16
   (the wgmma instance; the ragged head staged to a pitch of 50264) and
   float32 (the CUDA-core instance), a tenth of the labels and one row
   block masked, lse and gold within 1e-4 x max(1, max|logits|), two
   launches bit for bit;
   ``fused_nll`` exactly 0 at T = 0 and fully masked, and its gradients
   against autograd of ``nll_ref`` at (1024, 4096, 102400) bf16;
18. LM training through ``launch/train.py`` (``build_trainer`` /
   ``Trainer.run``): deepseek-7b at full width cut to 8 layers, bf16, one
   sequence of 4096 tokens, three AdamW steps (lr 3e-4) in ``brainslug``
   and ``barrier`` from the same weights (counters per step: 1 fused_ce,
   17 rmsnorm, 8 swiglu, 8 flash-attention launches, plain 0; losses
   within 2e-5 / 1e-4 / 1e-4 and grad norms within 1e-3 of ``barrier``,
   relative), and two defective ``barrier`` runs (bf16 attention scores;
   one layer's attention dropped) that those limits must flag; a float32
   run at 2 layers (losses within 1e-4, step-1 gradients within rtol 1e-4
   and atol 1e-4 x max|g|); a run killed at step 2 and resumed from its
   step-1 checkpoint lands on the uninterrupted step-3 loss exactly; peak
   memory per run;
19. the CE kernel's device time beside its bound, its plain version and
   the two-call PyTorch forms (bf16 and float32), the bytes of w its
   launch order implies, the ragged head's time with its staging copy; the
   8-layer training step per mode in turns; a traced step per mode (device
   time by group, idle share);
20. the SSD intra-chunk CUDA kernel against its plain version (max|d| <=
   1e-5 x max(1, max|ref|)): mamba2-2.7b's prefill shape (1, 80, 32, 64,
   64) with N 128, decays that overflow float32 ``exp`` above the diagonal
   (the output finite), the training shape (64 chunks) and padded tiles,
   two launches bit for bit; ``ops.ssd`` at batch 2 over 1000 tokens
   (padded to whole chunks) against ``ssd_chunked``, and its gradients
   finite on the overflowing decays; the kernel's device time at the
   prefill and training shapes beside its bound (bytes, and the float32
   operations with G once a chunk), the old bound (G a cell), its plain
   version, "none" for a library call and its launch plan;
21. mamba2-2.7b at full width and depth (64 layers, d_model 2560, 80 heads
   of 64, N 128, vocab 50280, bf16): ``lm.prefill`` (1, 2048) brainslug
   against barrier within 5e-2 (and both against the float32 logits of
   the same weights), ``Server.generate`` (4 x 64 + 32 new) and
   ``Engine.run`` of 8 ragged requests, dense and paged, both at the first
   8 layers (MAMBA_SERVE_LAYERS, MAMBA_ENGINE), teacher-forced
   against barrier and a float32 run (SSM_F32_FACTOR); counters (64 SSD
   launches a prefill, 0 a decode step, plain 0); a float32 run at 4
   layers with identical tokens; wall, tokens/s and a traced idle share
   per mode; the gated norm's rows forward at (2048, 5120), (4096, 5120)
   and (4, 5120) bf16 timed beside its byte bound, plain version, launch
   plan, registers and spills;
22. mamba2-2.7b training through ``Trainer.run``: full width cut to 8
   of the 64 layers (``MAMBA_TRAIN``; every block's VJP alone too), bf16, remat "full", one 4096-token sequence, three AdamW steps (lr
   3e-4), brainslug held to barrier through a float32 run on the same
   weights (SSM_F32_FACTOR), counters per step, peak memory; kill at step
   2 and resume from the step-1
   checkpoint at 4 layers lands on the uninterrupted step-3 loss exactly;
   the step per mode in turns and a traced step per mode;
23. the traced frontend, ``repro_torch.api.optimize`` on the plain twins:
   (a) ``cnn.vgg_fn`` at phase 4's VGG-16 widths, within 1e-4 of the plain
   function, with phase 4's stacks and sequences, capture at least 0.9,
   every sequence on ``fused_nhwc``; (b) three SGD steps of it with
   ``differentiable=True`` and one step of ``cnn.block_fn`` at
   ``block_net(8, 32)``'s shape, held to autograd of the plain functions
   at phase 9's limits, every sequence's backward on ``fused_nhwc_bwd``;
   (c) ``lm.transformer_block_fn`` at deepseek-7b widths (1, 2048, 4096),
   float32 and bf16, the registry dispatching attention, both rmsnorms
   and swiglu to their kernels (float32 within 1e-4 and bf16 within 2e-2
   of ``barrier``, relative to max|y|, gradients too), the gradient pass
   counted (every sequence's backward on ``fused_rows_bwd``), and
   ``lm.ce_loss_fn`` at (4096, 4096, 102400) bf16 and float32 on one
   ``fused_ce`` launch (loss within 1e-4 relative; gradients within
   ``CE_GRAD_L2`` in relative L2 distance of ``barrier``'s, which runs
   the registry's plain entry, and the bf16 limit parts a sound twin from
   two with a wrong row logsumexp);
   (d) the traced VGG forward and training step against phase 4's and
   phase 9's ``optimize_graph`` and ``barrier``, the traced blocks against
   ``barrier``, in turns, and ``OptimizedFn.__call__``'s host time per
   call; the kernels these paths launch record it as ``traced_launches``;
24. the hybrid family, zamba2-7b at full width (d_model 3584, the shared
   attention's 32 heads of 112, mamba N 64 and 112 heads of 64, bf16):
   (a) flash attention at head dim 112, causal (1, 32, 2048) and (2, 32,
   1000) in bf16 and float32, flash decode and paged decode at (8, 32,
   ragged lengths up to 32768, 112), block 16, through a shuffled table
   with sentinel tails, each against its plain version at phases 11 and
   14's limits, paged bit for bit with dense on the gathered view at
   every split; the SSD kernel at (1, 112, 32, 64, 64) N 64 and the gated
   norm's rows kernels (forward and backward) and rmsnorm at zamba2's
   widths; their times beside bound, plain version and SDPA; (b)
   ``lm.prefill`` (1, 2048) at 15 of the 81 layers (a super-block of 13
   mamba blocks and the shared attention, a 1-layer tail): counters, every
   position held to barrier through a float32 run (SSM_F32_FACTOR), each
   block alone on barrier's inputs against its float32 twin (a dropped
   shared-attention application planted in barrier's run must be
   flagged), and a float32 run at the CPU tests' cut (attention every
   3rd layer, 8 layers) with identical tokens; (c) ``Server.generate`` (4
   x 64 + 32 new) at HYBRID's 15 layers, dense cache, teacher-forced
   against barrier and float32, flash decode 1 launch a step; (d)
   ``Engine.run``
   of 8 ragged requests, dense and paged, and (e) ``Trainer.run`` (remat
   full, 4096 tokens, three AdamW steps; the step-1 gradient against
   float32; kill at step 2 and resume at 4 layers), both at HYBRID's 15
   layers; (f)
   the prefill, a decode step and the training step per mode in turns,
   with a trace of each;
25. the MoE family, granite-moe-3b-a800m at full width (d_model 1536, 24
   heads of 64 over 8 KV heads, 40 experts of d_ff 512, top-8, bf16): (a)
   the three attention kernels at head dim 64 (phase 24a's checks at
   granite's 24 heads over 8); (b) ``lm.prefill`` (1, 2048) at all 32
   layers: counters, two prefills bit for bit, the share of (token,
   choice) routing decisions the modes agree on per layer and the drop
   fractions; brainslug held to barrier at phase 12's limits with
   barrier taking brainslug's routing decisions (MOE), every position
   held through float32 runs taking each mode's decisions, each block
   alone against its float32 twin; two planted defects (MOE_CONTROLS);
   a float32 run at 2 layers; (c) ``Server.generate`` (4 x 64 + 32 new)
   at 8 of the 32 layers, MoE dropless; (d) ``Engine.run`` of phase 15's 12
   requests (prefix sharing on) at 2 layers, paged brainslug, paged
   barrier and dense brainslug, and at float32, 2 layers, against
   ``Server.generate``; (e) ``Trainer.run`` at 8 layers (4096 tokens,
   three AdamW steps per mode, the MoE aux read), the step-1 gradient
   against float32 (and twice bit for bit), float32 at 2 layers, kill at
   step 2 and resume; (f) the prefill, a decode step and the training
   step per mode in turns, with a trace of each (the MoE ranges
   ``moe.routing`` / ``moe.experts`` / ``moe.combine`` as groups); (g)
   llama4-maverick-400b-a17b at full width cut to one super-block (2
   layers; 128 experts, top-1, the shared expert): ``lm.prefill`` and
   ``Server.generate`` at phase 12's limits on brainslug's routing;
26. Slice F: (a) ``mode="xla"`` (each stack's plain function under
   ``torch.compile``) on the VGG-16 cell against ``barrier``, forward
   within 1e-4 and three SGD steps (step-1 gradients held through a
   float64 run, ``XLA_F64_FLOOR``), compiled calls equal to the
   sequences, no graph break; the three modes in turns with traces; each
   VGG stage's inductor kernels beside ``fused_nhwc`` and
   ``fused_nhwc_bwd``; the LM row chains in bf16; deepseek-7b
   ``lm.prefill`` (1, 2048) bf16 at 8 layers (``XLA_LM``); (b)
   ``autotune=True`` on the VGG-16 cell, forward and differentiable
   (every decision with each candidate's ms, no candidate failure, a warm
   disk cache with no measure run, the chosen net within 1e-4 of
   barrier), the traced ``vgg_fn``'s function floor, the ``hopper`` /
   ``ref`` decisions of the deepseek-width block; (c) ``remat`` none,
   dots and full on deepseek-7b at 4 layers, 4096 tokens, bf16: peak
   memory full <= dots <= none, dots gradients equal none's bit for bit;
27. the multimodal frontends: (a) flash attention at head dim 80 (1, 16,
   2048) and (1, 16, 1000), causal and not, and at 256 (1, 8 over 1,
   2048) and (1, 8, 1000) causal, bf16 and float32, two launches bit for
   bit and bf16 within the P bound; both decode kernels at D 256, 8 heads
   over 1, phase 14's ragged lengths, paged bit for bit with dense at
   every split of every dtype pair; their times beside bound, plain and
   SDPA; (b) hubert-xlarge at full width (48 layers, 16 heads of 80,
   non-causal, layer norm, plain gelu MLP, bf16): ``lm.forward`` of 2048
   frames, float32 frames within 1e-4 and bf16 frames within 5e-2 of
   barrier (a dropped-layer control flagged), every flash launch
   non-causal; ``Trainer.run`` at 8 layers on the pipeline's float32
   frames (losses and grad norms at 18a's limits, the control flagged,
   the step-1 ``frontend_proj`` gradient within 1e-4 in relative L2);
   ``Server`` and ``Engine`` raising; (c) paligemma-3b at full width (18
   layers, 8 heads of 256 over 1, gated gelu, tied vocab 257216, 256
   patches of 1152, bf16): ``lm.prefill`` of 256 patches and 1792
   tokens within 5e-2 of barrier (a dropped-layer control flagged),
   ``Server.generate`` at 6 layers teacher-forced against barrier, the
   paged engine at 4 layers, float32 at 2 layers with identical tokens,
   ``Trainer.run``
   at 6 layers with the loss on the text positions (its step-1 embed
   gradient held through a float32 run);
28. the static verifier: (a) ``python -m repro_torch.lint --device
   h100`` exits 0 over every default arch; (b) ``optimize_graph`` of
   VGG-16 at (32, 224, 224, 3), forward and ``differentiable=True``, and
   ``api.optimize`` of ``vgg_fn``, of ``block_fn`` at (32, 56, 56, 32)
   (training), of ``transformer_block_fn`` at deepseek-7b widths (bf16)
   and of ``ce_loss_fn`` at CE_SHAPE (bf16), all under
   ``verify="strict"``: no error finding, every dispatch on a hand-written
   kernel, outputs held to ``barrier`` or the plain functions at phases 4
   and 23's limits, the verifier's host seconds beside each call's; (c)
   the write models of the four fused-stack kernels (``write_model``,
   from the launch plans on this card) against one launch each, every
   buffer the kernels write filled with NaN first: ``fused_nhwc`` at VGG
   stage 1 and a block_net chain, ``fused_nhwc_bwd`` on its fused path and
   on patch slots, ``fused_rows`` at deepseek's addnorm (2048 rows) and
   mamba2's gated norm (2048, 5120) bf16, ``fused_rows_bwd`` with
   parameter partials: every element inside the models' blocks written
   and finite, every other still NaN, results at phases 2-3 and 7-8's
   limits, and a model with a block dropped flagged by the verifier and by
   the buffers;
29. mesh execution (Slice G1), two ranks sharing ``cuda:0`` over a gloo
   group (NCCL refuses two ranks on one card; the collectives go through
   the host), spawned after ``torch.cuda.empty_cache()``: (a) VGG-16 at
   (32, 224, 224, 3) float32 under ``partition="data"``, the forward and
   step-1 gradients against the single-device ``optimize_graph`` of the
   whole batch at phase 9's limits, every rank's ``fwd_generated`` /
   ``bwd_generated`` equal to the sequences and no reference dispatch;
   (b) the traced deepseek-7b-width bf16 block under ``partition="tensor"``
   over (1, 2) within phase 23's 2e-2 of max|y|, every registry dispatch
   on its Hopper kernel; (c) deepseek-7b data-parallel training at full
   width, 2 layers bf16, the global batch of 2 x 4096 tokens split over
   the ranks, 3 steps uncompressed and 3 compressed: every uncompressed
   step's loss and grad norm against one device's run of the ranks' two
   halves (bit for bit expected), and its losses and step-1 grad norm
   against one device's whole batch at phase 18's limits, the compressed
   step 1 there too and its
   later losses within 5% of the uncompressed ones and not equal to them,
   both runs decreasing, each rank's peak memory, the collectives given
   CUDA tensors and the transport.  The times of ranks that share one
   card are no multi-card number;
30. the sharded step (Slice G2), its legs in phase 29's spawn: (a)
   ``Trainer(mesh_devices=2)`` without ``data_parallel`` at (data 2,
   model 1), 29c's model, weights, batches and lr: every step within
   1e-6 of 29c's one-device halves, each rank's parameter shard and
   AdamW moments the bytes the sharding rules give, launches as 29c's;
   (b) ``make_sharded_train_step`` at (data 1, model 2), deepseek-7b at
   full width, 2 layers bf16, one 4096-token sequence, 3 steps against
   one device's at phase 18's limits, flash on 16 of the 32 heads and
   swiglu on 5504 of the 11008 columns a rank (the launches' shapes),
   the all-reduce bytes a step; (c) ``pipeline_apply`` over a
   ``("stage",)`` mesh of 2, one deepseek-width block a stage, 4
   microbatches of (1, 2048), bit for bit against the blocks in turn;
31. mesh serving (Slice G3), its legs in phase 29's spawn:
   ``Server.engine(mesh=...)`` on qwen2.5-32b at full width (40 heads over
   8 of 128, qkv bias, d_ff 27648, vocab 152064), 2 of its 64 layers,
   float32, 10 requests (a 64-token prefix shared by half, tails of 1-64
   tokens, 2-16 new tokens), 8 slots, max_len 256, prefill chunk 8,
   greedy, each leg against the single-device engine on the same
   requests in the same rank, tokens identical and last-position logits
   within 1e-5 x max|logit| every tick: (a) dense at (data 2, model 1),
   the slots split (whether bit for bit printed, with which products
   over 4 rows part from the same rows of the product over 8); (b) dense
   at (1, 2), 20 of the 40 heads over 4 of the 8 KV heads a rank; (c) paged,
   block 16, prefix sharing on, at (1, 2); every rank's
   plan, cache bytes, decode / rmsnorm / swiglu launches (no plain or
   reference decode), collectives and ms a tick; each decode kernel at
   its rank-local shapes against its plain version, and the paged plan
   fencing ``data`` with a pool note on a (2, 2) skeleton;
then the ``kernels`` JSON line (each CUDA kernel with its instances, the
attention kernels' head-dim 112, 64, 80 and 256 entries, the SSD's zamba2
shape, the multimodal paths' launches, the fused-stack kernels' write
model checks and the per-rank launches under the mesh), the card line,
and the ``ok`` line last.

Exits non-zero, printing no result, without CUDA, outside this tree, or
when any phase fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

D_MODEL, D_FF, ROWS = 4096, 11008, (4, 2048)     # deepseek-7b widths
VGG16_STAGES = (64, 128, 256, 512, 512)
VGG_INPUT = (32, 224, 224, 3)
NHWC_TOL = dict(atol=1e-5, rtol=1e-5)
ROWS_TOL = dict(atol=1e-5, rtol=1e-5)
ROWS_NORM_TOL = dict(atol=1e-5, rtol=1e-4)
PATH_TOL = dict(atol=1e-4, rtol=1e-4)
# Backward kernels against their plain versions.  An input cotangent holds
# element by element; a parameter or broadcast-extra gradient is a sum over
# every position (1.6 M for VGG stage 1) taken in another order, so its atol
# is BWD_TOL's rtol times its largest entry (the training check's rule).
BWD_TOL = dict(atol=1e-5, rtol=1e-4)
BLOCK_INPUT = (32, 56, 56, 32)                  # block_net(8, 32)
# Training: step-1 gradients within rtol 1e-4 and atol 1e-4 * max|g| per
# parameter; losses within 1e-4 relative.
TRAIN_RTOL = 1e-4
TRAIN_STEPS = 3
TRAIN_LR = 1e-3

# The LM serving slice (phases 11-13): deepseek-7b at full width.
KERNELS = ("fused_nhwc", "fused_rows", "fused_nhwc_bwd", "fused_rows_bwd",
           "rmsnorm", "swiglu", "flash_attention", "flash_decode",
           "paged_flash_decode", "fused_ce", "ssd_intra_chunk")
# Kernel against plain version, per dtype.  float32: the same arithmetic
# summed in another order.  bfloat16: the two may round one output apart
# (one bf16 step is 2^-8 relative), so atol/rtol 1e-2.
LM_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
          "bfloat16": dict(atol=1e-2, rtol=1e-2)}
PREFILL = (1, 2048)
SERVE = dict(batch=4, prompt_len=64, new_tokens=32)
# brainslug against barrier on the served path, as max|d logits| over
# max|logits| per step.  float32 (4 layers): the same products summed in
# another order, 1e-4.  bfloat16 (30 layers): the modes round at other
# places (barrier rounds the normalised value before the scale multiply and
# the attention output of a full-score softmax; the kernels once), each a
# relative 2^-8 = 3.9e-3 step, carried through 30 residual layers: 5e-2.
PATH_F32_REL = 1e-4
PATH_BF16_REL = 5e-2
PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core rate (datasheet)
# The rows forward is also timed at the other count of programs an SM
# (rows.PROGRAMS_PER_SM gives the grid), beside the one it launches.
PROGRAMS_ALT = {2: 8, 8: 2}
SPIN_KERNELS = 16       # sacrificial launches at the start of a trace
# The engine slice (phases 14-16).
PAGED = dict(batch=8, heads=32, max_len=32768, block=16)
ENGINE = dict(slots=4, max_len=256, prefill_chunk=8, kv_block_size=16,
              kv_num_blocks=32)
ENGINE_RUNS = (("paged", "brainslug"), ("paged", "barrier"),
               ("dense", "brainslug"))
# The paged kernel before its redesign (commit a683f4a: one CTA a slot and
# head), device ms at phase 16's three shapes: tools/kernel_times.py on an
# H100 80GB HBM3 at 700.00 W, in turns with the redesigned kernel.
PAGED_PARENT_MS = {"table": 1.7126, "one_slot_32768": 1.6813,
                   "tick": 0.00578}
# The dense kernel before its redesign (commit 1589f1c: one CTA a slot and
# head, loads straight from device memory), device ms in bf16 at 32 heads:
# phase 16's lengths at D 128 and 112, phase 13's shape, and 4 slots of 101
# keys in a 32768-key cache; tools/kernel_times.py on an H100 80GB HBM3 at
# 700.00 W, in turns with the redesigned kernel.
DENSE_PARENT_MS = {"ragged_128": 0.9608, "ragged_112": 1.2134,
                   "long_128": 1.2780, "short_128": 0.00430}
# The engine phases run phase 12's deepseek-7b cut to ENGINE_LAYERS of its
# 30 layers: the engine is host-bound (a tick's launches grow with depth),
# and with the SSM, hybrid and MoE phases (20-25) the script has to stay
# inside its 1200 s limit on a slow host (phase 15 took 55.3 s at 8 layers
# on one, and 31.2 s at 4 on one H100 80GB HBM3 at 700 W in a leg timing
# of the whole script, where phase 30 needed room).
ENGINE_LAYERS = 2
# The LM training slice (phases 17-19): deepseek-7b at full width, depth cut
# to fit one 80 GB card with AdamW's float32 moments, one 4096-token
# sequence (train_4k's length), three steps.
TRAIN_LM = dict(layers=8, layers_f32=2, seq=4096, steps=3, lr=3e-4)
CE_SHAPE = (4096, 4096, 102400)         # (tokens, d_model, vocab)
# Phase 29 (Slice G1): two ranks sharing the card.  29c trains deepseek-7b
# at full width cut to 2 layers (each rank holds the whole model with
# AdamW's moments and, compressed, the error-feedback state), the global
# batch of 2 x 4096 tokens split over the ranks.  A compressed step's grad
# norm reads the dequantised gradients: each element within half a
# quantum, 1/254 of its block's largest, of the uncompressed one, which
# bounds the norm's relative change by 1/254.  One device runs the same
# steps twice: on the whole batch, and on the ranks' two halves in turn
# with the bf16 gradients summed and halved as the all-reduce does.
# Every uncompressed step's loss and grad norm is held against the
# halves run (the same kernels on the same slices: bit for bit expected,
# MESH_HALVES_REL allows float32 ulps), and against the whole batch at
# phase 18's limits on every loss and the step-1 grad norm.  The halves'
# rounding moves the later grad norms off the whole batch's: 1.0e-4 and
# 1.15e-3 at steps 2 and 3 (this phase on one H100 80GB HBM3 at 700 W),
# above phase 18's 1e-3, which was set at lr 3e-4 where the grad norm
# barely moves.  The compressed run's step 1 is held against the whole
# batch, and its later losses against the uncompressed run's at the JAX
# package's 5% (tests/test_mesh_parity.py), differing from them at step
# 2.  lr 1e-3 constant.  Falling losses are an extra check and hold only
# for these 3 steps: on one device the losses of random weights on fresh
# batches were 12.0271, 12.0238, 12.0077, then rose, 12.0551, 13.1345,
# 12.377 (6 steps); they did not fall at phase 18's 3e-4 (12.0271,
# 12.0287, 12.0334) nor at 3e-3 (12.0271, 12.0290, 13.2498; this phase on
# one H100 80GB HBM3 at 700 W).
MESH = dict(ranks=2, dp_layers=2, dp_batch=2, seq=4096, steps=3,
            lr=1e-3, seconds=90)
MESH_COMPRESSED_GNORM_REL = 1 / 254
MESH_COMPRESSED_LOSS_REL = 0.05
MESH_HALVES_REL = 1e-6
# Phase 30 (Slice G2): the sharded step, its legs in phase 29's spawn of
# two ranks sharing the card.  30a: Trainer(mesh_devices=2) without
# data_parallel, mesh (data 2, model 1), 29c's model, weights, batches and
# lr: every step within MESH_HALVES_REL of 29c's one-device halves run
# (the all-gathered bf16 weights are the weights, the reduce-scattered
# bf16 gradients the halves' sum halved; the grad norm sums its squares
# over shards, in another order).  30b: the sharded step at (data 1,
# model 2), deepseek-7b at full width, 2 layers, one 4096-token sequence,
# 3 steps at phase 18's lr and limits against one device's steps from the
# same weights and batches: attention on 16 of the 32 heads a rank and
# the MLP on 5504 of the 11008 columns, each layer's output
# projections' partial sums all-reduced in bf16.  30c: pipeline_apply of
# one deepseek-width block a stage over a ("stage",) mesh of 2, 4
# microbatches of (1, 2048), bit for bit against the two blocks in turn.
SHARDED = dict(layers=2, seq=4096, steps=3, lr=3e-4, model=2,
               pipe_seq=2048, pipe_microbatches=4)
# Phase 31 (Slice G3): mesh serving, its legs in phase 29's spawn of two
# ranks sharing the card.  qwen2.5-32b at full width cut to 2 of its 64
# layers, float32 (the JAX package's mesh-serving model), seed 31; 10
# requests of tests/test_serve_mesh.py's recipe scaled (a 64-token prefix
# on every odd request, tails of 1-64 tokens, 2-16 new tokens); 8 slots,
# max_len 256, prefill chunk 8, paged blocks of 16, greedy.  31a (data 2,
# model 1) has no collective in the step, but its products run over 4
# rows where one device's run over 8, and cuBLAS may pick another float32
# kernel for another row count (phase 31 shows which products part).
# 31b and 31c (data 1, model 2) add two partial sums of wo where one
# device adds once.  Every leg: logits within tp_rel x max|logit| at every
# tick (a flipped token passes only where the reference's top-2 gap is
# under the same bound), bit for bit or not printed.
SERVE_LEGS = (("a", "serve_data", "dense (data 2, model 1)"),
              ("b", "serve_tensor", "dense (data 1, model 2)"),
              ("c", "serve_paged", "paged (data 1, model 2)"))
SERVE_MESH = dict(arch="qwen2.5-32b", layers=2, requests=10, prefix=64,
                  tail=64, new=16, slots=8, max_len=256, chunk=8, block=16,
                  seed=31, tp_rel=1e-5)
CE_RAGGED = (1000, 4000, 50257)
# d_model not a multiple of 8: h's rows are staged to a padded pitch
CE_ODD_D = (1000, 4001, 102400)
CE_GRAD_ROWS = 1024
# Phase 23's traced CE tail: brainslug's gradients against barrier's, as a
# relative L2 distance.  float32 holds 1e-4.  In bf16 both modes sum each
# element in float32 (in another order: 512-column chunks against one
# product) and round it to bf16, so the elements that straddle a rounding
# boundary part by one bf16 step: dh read 1.556e-4 and dw 4.1e-5 on an
# H100.  The bf16 limit sits twice above dh's reading, and its controls,
# backwards that take the row logsumexp rounded to bf16 or 0.1% high,
# must fail it.
CE_GRAD_L2 = {"float32": 1e-4, "bfloat16": 3e-4}
# brainslug against barrier in bf16 (8 layers, three steps), relative: the
# modes round at other places (barrier's logits are bf16, the CE kernel's
# float32).  Each limit sits above the gaps of sound runs and, where one
# exists, below what a control reads (PERF.md section 2, on one H100):
# sound loss gaps 7.3e-6 / 2.1e-5 / 2.8e-5 and grad-norm gaps 2.5e-4 /
# 2.0e-4 / 4.4e-4; barrier with bf16 attention scores reads 4.6e-5 on the
# step-1 loss and 1.7e-3 on the step-3 grad norm; with one layer's
# attention dropped, 1.4e-3 / 5.1e-4 on the step-1/2 losses and 9e-2 or
# more on every grad norm
TRAIN_BF16_LOSS_REL = (2e-5, 1e-4, 1e-4)        # per step
TRAIN_BF16_GNORM_REL = 1e-3                     # every step
# profiler ranges of the port that a traced training step reads
TRAIN_RANGES = {"moe.routing": "moe_routing", "moe.experts": "moe_experts",
                "moe.combine": "moe_combine",
                "vocab_ce.backward": "ce_backward",
                "flash_attention.backward": "attention_backward",
                "ssd.backward": "ssd_backward", "adamw.update": "adamw"}
# The SSM slice (phases 20-22): mamba2-2.7b at full width and depth.
# (b, h, nc, L, P, N) of the SSD kernel at lm.prefill (1, 2048)
SSD_SHAPE = (1, 80, 32, 64, 64, 128)
SSD_TRAIN_SHAPE = (1, 80, 64, 64, 64, 128)     # a 4096-token training step
# kernel against plain version: max|d| <= SSD_TOL x max(1, max|ref|) per
# output (room for float32 products summed in another order, 1.3 M a
# cell; the kernel sums in the plain version's order and reads 0)
SSD_TOL = 1e-5
SSD_RAGGED = (2, 1000)                  # (batch, sequence) through ops.ssd
# The engine (21c) and serving (21b) legs run the first 8 of the 64 layers:
# both are host-bound (a step's launches grow with depth); at 64 layers on
# one H100 the engine's three runs took 91 s of wall and the serving leg
# with its three controls 76 s, room the MoE slice's phase needs (at 16
# layers 27.9 and 17.6 s, PR 25 run 5).  Prefill (21a) and training (22)
# keep all 64.
MAMBA_ENGINE = dict(requests=8, prompt=(16, 96), stops=(8, 32), layers=8)
MAMBA_SERVE_LAYERS = 8
# training: every block recomputed in the backward, at 8 of the 64 layers
# (22a, 22b, 22d, and 22e's every block alone; its checks are block by
# block, and the planted dropped mixer is layer 4's): the step is half
# idle on the host, and at 64 layers the three legs took 157 s of phase
# 22's 191 on one H100 (PERF.md section 4), room phase 26 needs.  At 16
# layers phase 22 took 64.7 s on one H100 80GB HBM3 at 700 W, and the whole
# script 1162.5 s of its 1200 s on a slow host, so the legs run 8.  The
# kill/resume leg is cut to 4 layers (a 64-layer checkpoint with its
# AdamW moments is 27 GB, written twice).
MAMBA_TRAIN = dict(remat="full", layers=8, layers_resume=4)
# mamba2-2.7b in bf16 over 64 random layers rounds far noisier than
# deepseek-7b: both modes' prefill logits lie 0.17 of max from the float32
# logits of the same weights, and the two modes' teacher-forced decode
# logits drift 0.31 apart (PERF.md section 2, on one H100).  Where phase
# 12's and phase 18's direct limits cannot hold, brainslug is held to
# barrier through a float32 run on the same weights: its distance to that
# run within SSM_F32_FACTOR times barrier's, worst and median over the
# served steps (21b, 21c), and for the step-1 gradient of every parameter
# as one relative L2 distance (22b).  Training's per-step losses and grad
# norms are read, not held: three scalars a mode, where a change of
# summation order alone moved a grad-norm ratio from 0.45x to 1.61x.
SSM_F32_FACTOR = 1.5
# Defects planted in barrier's run (``Smoke.ssm_control``): the SSD's
# arithmetic in bf16, layer 4's mixer output dropped, and the gated norm in
# bf16 throughout (its sum of squares in bf16 partials).  The block-by-block
# checks (21f, 22e) must flag all three.  The end-to-end checks against the
# float32 run (21b teacher-forced logits, 22b the step-1 gradient) must flag
# the wrong forward (SSM_END_TO_END); the precision defects are read there:
# on one H100 the bf16 gated norm reads 1.08x / 1.04x barrier's distance
# and the bf16 SSD 1.19x in serving, inside the noise of 64 random bf16
# layers (PERF.md section 2).
SSM_CONTROLS = ("SSD in bf16", "layer 4's mixer dropped", "bf16 gated norm")
SSM_END_TO_END = ("layer 4's mixer dropped",)
# Block by block, each block alone on barrier's inputs to it (nothing is
# amplified through the layers before it), brainslug's relative L2 distance
# to the float32 block within this factor of barrier's.  The statistic runs
# over 5 M (forward) to 100 M (VJP) values a block and sits at 1.000 /
# 1.010 in the sound run on one H100; the bf16 gated norm reads 1.11 /
# 1.28, the bf16 SSD 5.5 / 5.0, the dropped layer over 100.
SSM_BLOCK_FACTOR = 1.05
# The hybrid slice (phase 24): zamba2-7b at full width (d_model 3584, 32
# heads of 112, mamba N 64 and 112 heads of 64).  Prefill (24b) and its
# times and traces (24f) run 15 of the 81 layers: one super-block (the
# shared block, whose first application the control drops) and a
# 1-layer tail.  At 81 layers that leg took 58.4 s of phase 24's 184.1
# on one H100 80GB HBM3 at 700 W (a leg timing of the whole script), at
# 29 layers 34.0 s, most of it host work that grows with depth (31 s
# parsing its four profiler traces at 81), and the whole script took
# 1162.5 s of its 1200 s on a slow host; every check of the leg holds at
# any depth with both block kinds and the tail.  The engine and the
# trainer are cut
# to 15 layers: one super-block and a 1-layer tail, so both cache kinds,
# the shared block and the tail are present.  At 31 layers (two
# super-blocks) phase 24 took 371 s on one H100 and the script would have
# run past its 1050 s aim; 17 layers saved about 115 s, and 15 (for
# phase 27's room) about 8 s a layer more.  The CPU tests hold the
# shared block's gradient summed over two applications.  bf16 is held to
# barrier through a float32 run (SSM_F32_FACTOR).
# Serving (24c) runs at 15 layers too: it is host-bound (launches grow with
# depth), took 51 s at 81 layers on one H100, and its checks (counters,
# teacher forcing against barrier and float32) need one application of the
# shared block and the tail, not five.
# The kill/resume leg (24e) runs 4 layers (the tail's mamba blocks, as
# phases 22 and 25 do): at 15 it wrote two 13 GB checkpoints and took 63.9
# s of phase 24's 188.3 on one H100; the shared block's checkpoint round
# trip is held on the CPU (tests/test_torch_hybrid.py).
HYBRID = dict(arch="zamba2-7b", prefill_layers=15, engine_layers=15,
              train_layers=15, serve_layers=15, resume_layers=4,
              remat="full")
# The MoE slice (phase 25): granite-moe-3b-a800m at full width (d_model
# 1536, 24 heads of 64 over 8 KV heads, 40 experts of d_ff 512, top-8, vocab
# 49155, bf16).  Prefill and serving run all 32 layers; the trainer is cut
# to 8 (TRAIN_LM's precedent), the kill/resume leg to 4, the engine and
# the float32 runs to 2: the engine is host-bound (its three runs took 50
# s at 8 layers on one H100, each MoE layer some 5 ms of host time a model
# evaluation; at 4 layers the engine leg with its float32 runs took 55.6
# s and the float32 serving cut 8.4 in a leg timing of the whole script,
# where phase 30 needed room) and a checkpoint with AdamW's moments is 9 GB at 8 layers,
# written twice, where the script has to stay near 1050 s.  The engine's
# and the float32 runs' checks read no layer past the second.
# llama4-maverick-400b-a17b runs at full width cut to one super-block: a
# dense block, then an MoE block of 128 experts, top-1, with the shared
# expert (18.55 B parameters, 37 GB in bf16).
# Serving (25c) runs the first 8 of the 32 layers, and paligemma's (27c)
# 6 of 18 (MULTIMODAL["pali_serve_layers"]): both host-bound (a granite
# MoE layer launches some 86 kernels a step).  With all their layers this script took
# 1204.4 s in all (1223.4 s of command) and 1267.6 s on two hosts, one
# H100 80GB HBM3 at 700 W each, past the 1200 s limit; with these cuts
# 1033.6 s.
MOE = dict(arch="granite-moe-3b-a800m", engine_layers=2, train_layers=8,
           layers_resume=4, f32_layers=2, train_f32_layers=2, drop_layer=4,
           serve_layers=8, llama4="llama4-maverick-400b-a17b",
           llama4_layers=2)
# Routing is discrete: a near tie between two experts falls either way under
# the modes' different roundings of the router's input, and a flipped choice
# changes that token's output wholesale, at every later layer too.  So
# brainslug is held to barrier with barrier taking brainslug's (token,
# choice) decisions (``moe.route`` patched to replay them; each run keeps its
# own gate weights), at phase 12's direct limits, and to a float32 run of
# the same weights taking each mode's own decisions (SSM_F32_FACTOR) and
# block by block (SSM_BLOCK_FACTOR); the share of decisions the free modes
# agree on is printed per layer.  Defects planted in barrier's run: layer
# 4's MoE output dropped (the end-to-end checks must flag it) and the gate
# weights left unnormalised (the block checks must flag both).
MOE_CONTROLS = ("layer 4's MoE output dropped",
                "gate weights not renormalised")
MOE_END_TO_END = ("layer 4's MoE output dropped",)
# Slice F (phase 26): deepseek-7b at full width cut to 8 layers for the xla
# prefill (each layer's three stacks compile once, whatever the depth), and
# to 4 for the remat none / dots / full steps.
XLA_LM = dict(layers=8, remat_layers=4)
# xla's step-1 VGG gradients are held through a float64 run, not by phase
# 9's element-wise rule against barrier.  Inductor contracts a batch norm's
# x * scale + shift into one FMA, so pre-activations within a rounding of 0
# take the other side of the ReLU: conv0_w's gradient, a sum over 1.6 M
# positions that mostly cancel, lies 1.7e-4 (relative L2) from barrier's
# on one H100, and 2 of its elements miss phase 9's rule.  Against barrier's
# float64 gradient xla sits no farther than barrier in every parameter
# (conv0_w 2.68e-4 against 2.92e-4), and with the FMA turned off
# (inductor's emulate_precision_casts) it meets barrier within 2e-7
# (PERF.md section 6; tools/xla_grads.py).  So xla is held within
# SSM_F32_FACTOR of barrier's distance to float64, parameter by parameter,
# or within XLA_F64_FLOOR where both sit at float32's rounding (about 8 of
# its 1.19e-7 steps; there the ratio is noise: 4.7e-8 against 5.2e-8 for
# bn4_o, brainslug 9.9e-8, on that run).
XLA_F64_FLOOR = 1e-6
# The multimodal slice (phase 27): hubert-xlarge (48 layers, d_model 1280,
# 16 heads of 80, d_ff 5120 plain gelu MLP with biases, layer norm, vocab
# 504, frontend 512, bf16) and paligemma-3b (18 layers, d_model 2048, 8
# heads of 256 over 1, d_ff 16384 gated gelu, vocab 257216 tied, 256
# patches of 1152, bf16).  hubert's forward runs all 48 layers on 2048
# frames; its trainer is cut to 8 layers (4096 frames, three AdamW steps),
# paligemma's prefill and Server.generate run all 18, its engine 4, its
# trainer 6 (256 patches and 4096 tokens; the tied head takes the plain
# loss, its logits in chunks of 512 positions), float32 legs 2: for the
# script's time, every check kept.  A dropped-layer control (the block at
# drop_layer adds nothing) must be flagged by each bf16 limit it stands
# beside.  The step-1 gradients are bf16 (the weights' dtype), so two
# modes' float32 sums part by a bf16 step wherever they straddle a
# rounding boundary: hubert's frontend_proj gradient is held in relative
# L2 distance, paligemma's embed gradient through a float32 run
# (SSM_F32_FACTOR).
MULTIMODAL = dict(hubert="hubert-xlarge", paligemma="paligemma-3b",
                  frames=2048, text=1792, hubert_train_layers=8,
                  pali_train_layers=6, pali_engine_layers=4, f32_layers=2,
                  pali_serve_layers=6, loss_chunk=512, drop_layer=4,
                  grad_l2=1e-4)


class PhaseError(RuntimeError):
    pass


def w_stream_model(n_rows, d, vocab, n_split, resident):
    """Bytes of a bf16 ``w`` that the bf16 CE kernel's launch order implies
    are read from device memory, in a model: the CTAs run in windows of
    ``resident`` consecutive launches, the row tile on ``blockIdx.x``
    varying fastest, and a split's columns are read once for every window
    that holds one of its row tiles (``w`` is far larger than L2, ``h``
    stays there).  Printed by phase 19 beside w's size; not a reading."""
    from repro_torch.kernels.vocab_ce import ce
    row_tiles = -(-n_rows // ce.TC_BLOCK_ROWS)
    n_vtiles = -(-vocab // ce.TC_BLOCK_V)
    order = [s for s in range(n_split) for _ in range(row_tiles)]
    total = 0
    for w0 in range(0, len(order), resident):
        for s in set(order[w0:w0 + resident]):
            c0 = s * n_vtiles // n_split * ce.TC_BLOCK_V
            c1 = min((s + 1) * n_vtiles // n_split * ce.TC_BLOCK_V, vocab)
            total += 2 * d * (c1 - c0)
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels.fused_stack import nhwc  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})",
              file=sys.stderr)
        return 2
    try:
        Smoke(torch).run()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.err = {k: 0.0 for k in KERNELS + (
            "fused_rows_bf16", "fused_rows_bwd_bf16", "fused_ce_bwd",
            "ssd_ops", "mamba_rows", "mamba_rows_bwd", "mamba_rmsnorm")}
        self.vgg_stages: list = []      # (stack, input) of phase 5
        self.kernels: dict[str, dict] = {}

    # -- helpers ------------------------------------------------------------
    def randn(self, shape, seed, scale=1.0):
        g = self.torch.Generator(device=self.dev).manual_seed(seed)
        return scale * self.torch.randn(shape, generator=g, device=self.dev)

    def check(self, kernel, what, got, want, tol):
        torch = self.torch
        torch.cuda.synchronize()
        for k in want:
            g, w = got[k], want[k]
            if g.shape != w.shape:
                raise PhaseError(f"{kernel} {what}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
            if not bool(torch.isfinite(g).all()):
                raise PhaseError(f"{kernel} {what}: non-finite output {k}")
            err = float((g - w).abs().max())
            self.err[kernel] = max(self.err[kernel], err)
            if not torch.allclose(g, w, **tol):
                raise PhaseError(f"{kernel} {what}: output {k} max|d|={err:.3e}"
                                 f" outside {tol}")
        return max(float((got[k] - want[k]).abs().max()) for k in want)

    def cuda_ms(self, fn, reps=20, groups=5, warmup=3):
        """Milliseconds per call: CUDA events around ``reps`` back-to-back
        calls, divided by ``reps``; the median of ``groups`` such runs.
        Where the host enqueues slower than the card runs, this is the
        host's time per call."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(groups):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    # -- phases ---------------------------------------------------------------
    PHASES = ("phase0_device", "phase1_build", "phase2_nhwc", "phase3_rows",
              "phase4_paths", "phase5_timing", "phase7_nhwc_bwd",
              "phase8_rows_bwd", "phase9_train", "phase10_bwd_timing",
              "phase11_lm_kernels", "phase12_serving", "phase13_lm_timing",
              "phase14_paged_kernel", "phase15_engine",
              "phase16_engine_timing", "phase17_ce_kernel", "phase18_train",
              "phase19_train_timing", "phase20_ssd_kernel",
              "phase21_ssm_serving", "phase22_ssm_train", "phase23_traced",
              "phase24_hybrid", "phase25_moe", "phase26_slice_f",
              "phase27_multimodal", "phase28_verify", "phase29_mesh",
              "phase30_sharded", "phase31_serving")

    def run(self):
        t0 = time.perf_counter()
        spent = {}
        for name in self.PHASES:
            t = time.perf_counter()
            getattr(self, name)()
            spent[name.split("_")[0][5:]] = round(time.perf_counter() - t, 1)
        # the kernels line first: it runs to tens of kilobytes, and the
        # phase times stay readable in the end of the output
        print(json.dumps({"kernels": [self.kernels[k] for k in KERNELS]}))
        print(f"[phases] seconds each {json.dumps(spent)}")
        print(f"[total] {time.perf_counter() - t0:.1f} s")
        print(self.smi)
        torch = self.torch
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))

    def phase0_device(self):
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60, check=True)
        except (OSError, subprocess.SubprocessError) as e:
            raise PhaseError(f"nvidia-smi: {e}") from e
        self.smi = smi.stdout.strip().splitlines()[0]
        self.sm_count = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"[0 device] {torch.cuda.get_device_name(0)} | {self.smi} | "
              f"torch {torch.__version__} cuda {torch.version.cuda} | "
              f"tf32 off")

    def phase1_build(self):
        from repro_torch.kernels import _build
        from repro_torch.kernels.attention import decode, flash
        from repro_torch.kernels.fused_stack import nhwc, nhwc_bwd
        from repro_torch.kernels.ssd import ssd
        from repro_torch.kernels.vocab_ce import ce
        t = time.perf_counter()
        procs = [(src, _build.start_build(src)) for src in (
            nhwc.SOURCE, nhwc_bwd.SOURCE, flash.SOURCE, decode.SOURCE,
            decode.PAGED_SOURCE, ce.SOURCE, ssd.SOURCE)]
        try:
            libs = [_build.finish_build(src, p) for src, p in procs]
        except _build.BuildError as e:
            raise PhaseError(str(e)) from e
        for mod in (nhwc, nhwc_bwd, flash, decode, ce, ssd):
            mod._library()
        decode._library(decode.PAGED_SOURCE)
        import triton
        print(f"[1 build] nvcc {', '.join(p.name for p in libs)} in "
              f"parallel, {time.perf_counter() - t:.1f} s; triton "
              f"{triton.__version__} compiles each rows signature and the "
              f"rmsnorm / swiglu kernels at their first launch")
        self.flash_ptxas = self.ptxas_report(
            _build.build_log(flash.SOURCE),
            [f"flash_fwd_kernel_bf16_wgmma<{d}>" for d in flash.HEAD_DIMS]
            + [f"flash_fwd_kernel<float,{d}>" for d in flash.HEAD_DIMS])
        print("[1 build] flash_attention.cu (instances <head dim>), nvcc "
              "-Xptxas -v: " + "; ".join(self.flash_ptxas))
        self.ce_ptxas = self.ptxas_report(_build.build_log(ce.SOURCE),
                                          "ce_tc_kernel")
        print("[1 build] fused_ce.cu, nvcc -Xptxas -v: "
              + "; ".join(self.ce_ptxas))
        self.ssd_ptxas = self.ptxas_report(_build.build_log(ssd.SOURCE),
                                           "ssd_intra_chunk_kernel")
        print("[1 build] ssd_intra_chunk.cu, nvcc -Xptxas -v: "
              + "; ".join(self.ssd_ptxas))
        self.nhwc_bwd_ptxas = self.ptxas_report(
            _build.build_log(nhwc_bwd.SOURCE), "fused_nhwc_bwd_kernel")
        print("[1 build] fused_nhwc_bwd.cu, nvcc -Xptxas -v: "
              + "; ".join(self.nhwc_bwd_ptxas))
        self.nhwc_ptxas = self.ptxas_report(_build.build_log(nhwc.SOURCE),
                                            "fused_nhwc_kernel_fused")
        print("[1 build] fused_nhwc.cu, nvcc -Xptxas -v: "
              + "; ".join(self.nhwc_ptxas))
        self.paged_ptxas = self.ptxas_report(
            _build.build_log(decode.PAGED_SOURCE),
            [f"paged_flash_decode_kernel<{dts},{cps},{d}>"
             for _, dts in self.PAGED_DTYPES for cps in (1, 2, 4, 8, 16)
             for d in decode.HEAD_DIMS])
        print(f"[1 build] paged_flash_decode.cu ({len(self.paged_ptxas)} "
              f"instances <q, pool, chains a CTA, head dim>), nvcc -Xptxas "
              f"-v: " + "; ".join(self.paged_ptxas))
        self.dense_ptxas = self.ptxas_report(
            _build.build_log(decode.SOURCE),
            [f"flash_decode_kernel<{dts},{cps},{d}>"
             for _, dts in self.PAGED_DTYPES for cps in (1, 2, 4, 8, 16)
             for d in decode.HEAD_DIMS])
        print(f"[1 build] flash_decode.cu ({len(self.dense_ptxas)} instances "
              f"<q, cache, chains a CTA, head dim>), nvcc -Xptxas -v: "
              + "; ".join(self.dense_ptxas))

    #: Kernel names as the ptxas lines report them, by a fragment of the
    #: mangled name (first match wins).
    PTXAS_NAMES = (("ce_tc_kernel", "ce_tc_kernel"),
                   ("ce_split_kernel", "ce_split_kernel<float>"),
                   ("ce_merge_kernel", "ce_merge_kernel"),
                   ("ssd_intra_chunk_kernel", "ssd_intra_chunk_kernel"),
                   ("bwd_kernel_fused", "fused_nhwc_bwd_kernel_fused"),
                   ("fused_nhwc_bwd_kernel", "fused_nhwc_bwd_kernel"),
                   ("nhwc_overlap_add_kernel", "nhwc_overlap_add_kernel"),
                   ("nhwc_reduce_kernel", "nhwc_reduce_kernel"),
                   ("nhwc_kernel_fused", "fused_nhwc_kernel_fused"),
                   ("fused_nhwc_kernel", "fused_nhwc_kernel"))
    #: The decode kernels' instances: mangled template arguments (``<q,
    #: cache or pool, chains a CTA, head dim>``) by dtype pair.
    PAGED_DTYPES = (("13__nv_bfloat16f", "bf16,f32"),
                    ("13__nv_bfloat16S", "bf16,bf16"), ("ff", "f32,f32"))

    @classmethod
    def ptxas_report(cls, log, need):
        """Each kernel's registers and spills from ptxas's ``-v`` lines;
        fails unless the kernel ``need`` (a name, or a list of names) is
        among them.  Templated attention kernels are named with their
        instance's arguments (the head dim last)."""
        out, name = [], None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                ints = re.findall(r"Li(\d+)E", name)
                decode = next((k for k in ("paged_flash_decode_kernel",
                                           "flash_decode_kernel")
                               if k + "I" in name), None)
                if decode:
                    args = name.split(decode + "I")[1]
                    dts = next(n for frag, n in cls.PAGED_DTYPES
                               if args.startswith(frag))
                    name = f"{decode}<{dts},{ints[0]},{ints[1]}>"
                elif "bf16_wgmma" in name:
                    name = f"flash_fwd_kernel_bf16_wgmma<{ints[0]}>"
                elif "flash_fwd_kernelIf" in name:
                    name = f"flash_fwd_kernel<float,{ints[0]}>"
                name = next((n for frag, n in cls.PTXAS_NAMES if frag in name),
                            name)
            elif "spill stores" in line and name:
                spill = line.strip()
            elif "Used" in line and "registers" in line and name:
                regs = line.split("Used")[1].split(",")[0].strip()
                out.append(f"{name}: {regs}, {spill}")
                name = None
        for want in [need] if isinstance(need, str) else need:
            if not any(o.startswith(want + ":") for o in out):
                raise PhaseError(f"ptxas reported no {want}")
        return out

    def nhwc_cases(self):
        """(name, program, input shape, tile, extra shapes or "block") of
        phase 2, and the block_net parameters."""
        from repro_torch.core import analyzer, collapse, ir, resource
        from repro_torch.models import cnn
        K = ir.OpKind

        def pool(name, vin, vout, fn="max", w=(3, 3), s=(1, 1), p=(1, 1)):
            return ir.OpNode(K.POOL2D, name, (vin,), vout, fn=fn,
                             attrs={"window": w, "stride": s, "padding": p})

        def prog(name, ops, inputs=("x",)):
            return ir.StackProgram(name=name, inputs=inputs,
                                   outputs=(ops[-1].output,), ops=tuple(ops),
                                   layout="nhwc")

        affine = ir.OpNode(K.AFFINE, "bn", ("p",), "b", params=("s", "o"))
        relu = ir.OpNode(K.EW_UNARY, "relu", ("b",), "r", fn="relu")
        unary = ("tanh", "sigmoid", "relu", "relu6", "squared_relu", "gelu",
                 "gelu_exact", "silu", "exp", "abs", "square", "identity",
                 "neg", "softplus")
        chain = [ir.OpNode(K.EW_UNARY, f"u{i}", ("x" if i == 0 else
                                                 f"u{i - 1}",), f"u{i}", fn=f)
                 for i, f in enumerate(unary)]
        cases = [
            ("max_pool_padded", prog("maxpad", [pool("p", "x", "p"), affine,
                                                relu]), (8, 56, 56, 64), 8, {}),
            ("avg_pool_padded", prog("avgpad", [pool("p", "x", "y", "avg")]),
             (8, 56, 56, 64), 8, {}),
            ("stride_not_tiling", prog("strided", [
                pool("p0", "x", "a", "max", (3, 3), (2, 2), (1, 1)),
                pool("p1", "a", "y", "avg", (2, 2), (2, 2), (0, 0))]),
             (8, 57, 57, 32), 4, {}),
            ("image_not_tile_multiple", prog("untiled", [
                ir.OpNode(K.AFFINE, "bn", ("x",), "b", params=("s", "o")),
                ir.OpNode(K.EW_UNARY, "relu", ("b",), "r", fn="relu"),
                pool("p", "r", "y", "max", (2, 2), (2, 2), (0, 0))]),
             (8, 30, 30, 64), 8, {}),
            ("broadcast_extra", prog("extra", [
                ir.OpNode(K.EW_BINARY, "add", ("x", "e"), "a", fn="add"),
                ir.OpNode(K.EW_BINARY, "mul", ("e", "a"), "m", fn="mul"),
                pool("p", "m", "y", "max", (2, 2), (2, 2), (0, 0))],
                inputs=("x", "e")), (8, 28, 28, 64), 8, {"e": (1, 1, 1, 64)}),
            ("extra_only_op", prog("extra_only", [
                ir.OpNode(K.EW_BINARY, "t", ("e", "e"), "t", fn="mul"),
                ir.OpNode(K.EW_BINARY, "y", ("x", "t"), "y", fn="add")],
                inputs=("x", "e")), (8, 56, 56, 64), 8, {"e": (1, 1, 1, 64)}),
            ("every_unary_fn", prog("unary", chain + [
                pool("p", chain[-1].output, "y", "max", (3, 3), (2, 2),
                     (1, 1))]), (4, 28, 28, 32), 4, {}),
            ("row_norm_softmax_over_c", prog("rowops", [
                ir.OpNode(K.ROW_NORM, "ln", ("x",), "a", params=("s", "o"),
                          attrs={"norm": "layer", "eps": 1e-5}),
                pool("p", "a", "c", "max", (2, 2), (2, 2), (0, 0)),
                ir.OpNode(K.ROW_NORM, "rms", ("c",), "d", params=("s",),
                          attrs={"norm": "rms", "eps": 1e-6}),
                ir.OpNode(K.ROW_SOFTMAX, "sm", ("d",), "y")]),
             (4, 28, 28, 64), 4, {}),
        ]
        graph, bparams = cnn.block_net(8, channels=32, device=self.dev)
        seg, = analyzer.analyze(graph, keep=frozenset({graph.output}))
        plan = collapse.collapse(seg.stack, {"x": (8, 56, 56, 32)},
                                 resource.H100)
        for i, seq in enumerate(plan.sequences):
            cases.append((f"block_net8_seq{i}", plan.subprogram(i),
                          (8, 56, 56, 32), seq.tile_out_h, "block"))
        return cases, bparams

    def nhwc_operands(self, program, shape, extra_shapes, bparams, k):
        """Seeded ``(x, params, extras)`` of nhwc case ``k``."""
        x = self.randn(shape, 100 + k, 2.0)
        c = shape[-1]
        if extra_shapes == "block":
            return x, bparams, {}
        params = {p: self.randn((c,), 200 + j, 0.3)
                  + (1.0 if p == "s" else 0.0)
                  for j, p in enumerate(program.param_names)}
        extras = {e: self.randn(s, 300) for e, s in extra_shapes.items()}
        return x, params, extras

    def phase2_nhwc(self):
        from repro_torch.kernels.fused_stack import nhwc, ref
        cases, bparams = self.nhwc_cases()
        worst = 0.0
        for k, (name, program, shape, tile, extra_shapes) in enumerate(cases):
            x, params, extras = self.nhwc_operands(program, shape,
                                                   extra_shapes, bparams, k)
            got = nhwc.fused_nhwc(program, x, params, extras=extras,
                                  tile_out_h=tile, tile_out_w=tile)
            want = ref.fused_stack_ref(program, {program.inputs[0]: x,
                                                 **extras}, params)
            out = program.outputs[0]
            worst = max(worst, self.check("fused_nhwc", name, {out: got},
                                          want, NHWC_TOL))
        print(f"[2 nhwc] {len(cases)} cases ({', '.join(c[0] for c in cases)})"
              f" agree with the plain version: max|d| = {worst:.3e} "
              f"(tol {NHWC_TOL})")
        # the fused path (batch norm, ReLU, a 2x2/s2 max pool): bit for bit
        lines = []
        for k, (name, program, shape) in enumerate(self.nhwc_fused_cases()):
            if not nhwc.fused_chain(program):
                raise PhaseError(f"fused_nhwc {name}: not a fused chain")
            x, params, _ = self.nhwc_operands(program, shape, {}, bparams,
                                              60 + k)
            got = nhwc.fused_nhwc(program, x, params)
            want = ref.fused_stack_ref(program, {program.inputs[0]: x},
                                       params)
            out = program.outputs[0]
            err = self.check("fused_nhwc", name, {out: got}, want, NHWC_TOL)
            if not self.torch.equal(got, want[out]):
                raise PhaseError(f"fused_nhwc {name}: the fused path differs "
                                 f"from the plain version (max|d| "
                                 f"{err:.3e}); it must agree bit for bit")
            lines.append(f"{name} {shape}")
        print(f"[2 nhwc fused] {len(lines)} cases on the fused path, bit for "
              f"bit equal to the plain version (max|d| exactly 0): "
              + "; ".join(lines))

    def nhwc_fused_cases(self):
        """(name, program, input shape) of phase 2's fused-path cases:
        VGG-16's five stage chains at batch 8, stage 1's at odd extents
        (a row and a column no window reads), and with padded borders at
        odd extents and 72 channels (windows reach past the edge; two
        channel blocks, the second 8 wide)."""
        from repro_torch.core import analyzer, collapse, ir, resource
        from repro_torch.models import cnn
        graph, _ = cnn.vgg_net(VGG16_STAGES, device=self.dev)
        shape, cases = (8,) + VGG_INPUT[1:], []
        for seg in analyzer.analyze(graph, keep=frozenset({graph.output})):
            if not seg.is_stack:
                if seg.op.kind == ir.OpKind.CONV2D:
                    shape = shape[:3] + (seg.op.attrs["kernel_shape"][-1],)
                continue
            plan = collapse.collapse(seg.stack, {seg.stack.inputs[0]: shape},
                                     resource.H100)
            cases.append((f"vgg16_stage{len(cases) + 1}", plan.subprogram(0),
                          shape))
            shape = ir.infer_shapes(seg.stack, {seg.stack.inputs[0]: shape})[
                seg.stack.outputs[0]]
        stage1 = cases[0][1]
        cases.append(("vgg16_stage1_odd", stage1, (4, 57, 43, 64)))
        aff, relu, pool = stage1.ops
        padded = ir.StackProgram(
            name="padded", inputs=stage1.inputs, outputs=stage1.outputs,
            layout="nhwc", ops=(aff, relu, ir.OpNode(
                ir.OpKind.POOL2D, pool.name, pool.inputs, pool.output,
                fn="max", attrs={"window": (2, 2), "stride": (2, 2),
                                 "padding": (1, 1)})))
        cases.append(("padded_odd_c72", padded, (4, 29, 31, 72)))
        return cases

    def rows_cases(self):
        """(name, program, input shapes, param shapes, tol) of phase 3."""
        from repro_torch.core import ir
        from repro_torch.layers import stacks
        K = ir.OpKind
        unary = ("tanh", "sigmoid", "relu", "relu6", "squared_relu", "gelu",
                 "gelu_exact", "silu", "exp", "abs", "square", "identity",
                 "neg", "softplus")
        ops, v = [], "x"
        for i, f in enumerate(unary):
            ops.append(ir.OpNode(K.EW_UNARY, f"u{i}", (v,), f"u{i}", fn=f))
            v = f"u{i}"
        for i, f in enumerate(("add", "sub", "mul", "div", "max", "min")):
            ops.append(ir.OpNode(K.EW_BINARY, f"b{i}", (v, "z"), f"b{i}",
                                 fn=f))
            v = f"b{i}"
        ops.append(ir.OpNode(K.EW_BINARY, "bp", (v,), "bp", fn="mul",
                             params=("k",)))
        ops.append(ir.OpNode(K.AFFINE, "aff", ("bp",), "y",
                             params=("s", "o")))
        all_fns = ir.StackProgram(name="all_fns", inputs=("x", "z"),
                                  outputs=("y",), ops=tuple(ops))
        softmax = ir.StackProgram(name="softmax", inputs=("x",),
                                  outputs=("y",), ops=(
            ir.OpNode(K.ROW_SOFTMAX, "sm", ("x",), "y"),))
        # F-separable with width-1 operands, walked in F chunks by the
        # backward, whose width-1 gradients sum over the chunks
        scalar_chunks = ir.StackProgram(
            name="scalar_chunks", inputs=("x", "r"), outputs=("y", "u"),
            ops=(ir.OpNode(K.EW_BINARY, "k", ("x",), "a", fn="mul",
                           params=("k",)),
                 ir.OpNode(K.EW_BINARY, "t", ("r",), "u", fn="mul",
                           params=("t",)),
                 ir.OpNode(K.EW_BINARY, "b", ("a", "u"), "b", fn="add"),
                 ir.OpNode(K.AFFINE, "aff", ("b",), "y",
                           params=("s", "o"))))
        d, f = ROWS + (D_MODEL,), ROWS + (D_FF,)
        ragged = (ROWS[0] * ROWS[1] - 3, D_MODEL)
        vec = (D_MODEL,)
        return [
            ("every_fn_affine", all_fns, {"x": d, "z": d},
             {"k": vec, "s": vec, "o": vec}, ROWS_TOL),
            ("rms", stacks.norm_program("rms", 1e-6, False), {"x": d},
             {"scale": vec}, ROWS_NORM_TOL),
            ("rms_bias", stacks.norm_program("rms", 1e-6, True), {"x": d},
             {"scale": vec, "bias": vec}, ROWS_NORM_TOL),
            ("layer", stacks.norm_program("layer", 1e-5, False), {"x": d},
             {"scale": vec}, ROWS_NORM_TOL),
            ("layer_bias", stacks.norm_program("layer", 1e-5, True),
             {"x": d}, {"scale": vec, "bias": vec}, ROWS_NORM_TOL),
            ("softmax", softmax, {"x": d}, {}, ROWS_NORM_TOL),
            ("ragged_rows", stacks.addnorm_program("layer", 1e-5, True),
             {"x": ragged, "res": ragged}, {"scale": vec, "bias": vec},
             ROWS_NORM_TOL),
            ("addnorm_rms", stacks.addnorm_program("rms", 1e-6, False),
             {"x": d, "res": d}, {"scale": vec}, ROWS_NORM_TOL),
            ("glu_silu", stacks.glu_program("silu"), {"gate": f, "up": f},
             {}, ROWS_TOL),
            ("scalar_chunks", scalar_chunks, {"x": f, "r": ROWS + (1,)},
             {"k": (), "t": (1,), "s": (D_FF,), "o": (D_FF,)}, ROWS_TOL),
        ]

    def rows_inputs(self, name, in_shapes, p_shapes, seed):
        inputs = {k: self.randn(s, seed + i) for i, (k, s) in
                  enumerate(in_shapes.items())}
        if "z" in inputs:       # divisors away from zero
            z = inputs["z"]
            inputs["z"] = self.torch.where(z.abs() < 0.5, 1.0, z)
        params = {k: self.randn(s, seed + 50 + i) + (1.0 if k == "scale"
                                                     else 0.0)
                  for i, (k, s) in enumerate(p_shapes.items())}
        return inputs, params

    def phase3_rows(self):
        from repro_torch.core import api
        from repro_torch.kernels.fused_stack import ref
        cfg = api.OptimizeConfig(mode="brainslug")
        t = time.perf_counter()
        lines = []
        for k, (name, program, in_shapes, p_shapes, tol) in enumerate(
                self.rows_cases()):
            inputs, params = self.rows_inputs(name, in_shapes, p_shapes,
                                              400 + 100 * k)
            exe = api.optimize_stack(program, in_shapes, cfg)
            got = exe(inputs, params)
            want = ref.fused_stack_ref(program, inputs, params)
            err = self.check("fused_rows", name, got, want, tol)
            lines.append(f"{name}={err:.1e}")
        print(f"[3 rows] {len(lines)} cases through optimize_stack agree with "
              f"the plain version ({' '.join(lines)}); first launches "
              f"(Triton compiles) included: {time.perf_counter() - t:.1f} s")
        self.phase3_rows_bf16()

    def rows_bf16_cases(self):
        """(name, program, input shapes, param shapes) of the bf16 chains:
        a layer norm with bias, a residual add + rms norm, a gelu gate, at
        deepseek-7b widths, inputs and parameters in bfloat16."""
        from repro_torch.layers import stacks
        d, f = ROWS + (D_MODEL,), ROWS + (D_FF,)
        vec = (D_MODEL,)
        return [
            ("layer_bias", stacks.norm_program("layer", 1e-5, True),
             {"x": d}, {"scale": vec, "bias": vec}),
            ("addnorm_rms", stacks.addnorm_program("rms", 1e-6, False),
             {"x": d, "res": d}, {"scale": vec}),
            ("glu_gelu", stacks.glu_program("gelu"), {"gate": f, "up": f},
             {}),
        ]

    def phase3_rows_bf16(self):
        """The rows kernel on bf16 chains against its plain version at
        LM_TOL's bf16 tolerance: each output in the interpreter's dtype,
        rounded where the interpreter rounds."""
        torch = self.torch
        from repro_torch.core import collapse, resource
        from repro_torch.kernels.fused_stack import ref, rows
        self.rows_bf16 = {}
        lines = []
        for k, (name, program, in_shapes, p_shapes) in enumerate(
                self.rows_bf16_cases()):
            inputs, _ = self.rows_inputs(name, in_shapes, {},
                                         3000 + 100 * k)
            inputs = {n: v.to(torch.bfloat16) for n, v in inputs.items()}
            # norm parameters as an LM holds them (scale near 1, bias near
            # 0), as phase 11 draws them: a scale of ~4 would multiply a
            # one-step flip of the rounded normalised value (the float32
            # sums of mean and variance run in another order) into four
            # steps of a bias-cancelled output, past the one-step tolerance
            params = {n: ((1.0 if n == "scale" else 0.0) + 0.1 * self.randn(
                shp, 3050 + 100 * k + j)).to(torch.bfloat16)
                for j, (n, shp) in enumerate(p_shapes.items())}
            tile = collapse.collapse(program, in_shapes,
                                     resource.H100).sequences[0].tile_rows
            got = rows.fused_rows(program, inputs, params, tile_rows=tile)
            want = ref.fused_stack_ref(program, inputs, params)
            worst = 0.0
            for v in want:
                if got[v].dtype != want[v].dtype:
                    raise PhaseError(f"fused_rows bf16 {name}: output {v} is "
                                     f"{got[v].dtype}, the interpreter's "
                                     f"{want[v].dtype}")
                worst = max(worst, self.lm_check("fused_rows_bf16",
                                                 f"{name} {v}", got[v],
                                                 want[v]))
            self.rows_bf16[name] = (program, inputs, params, tile, got)
            lines.append(f"{name}={worst:.1e}")
        print(f"[3 rows bf16] {len(lines)} bf16 chains at deepseek-7b widths "
              f"against the plain version, outputs in bf16 (tol "
              f"{LM_TOL['bfloat16']}): {' '.join(lines)}")

    def phase4_paths(self):
        torch = self.torch
        from repro_torch.core import api
        from repro_torch.kernels.fused_stack import nhwc, ops, ref, rows
        from repro_torch.models import cnn
        graph, params = cnn.vgg_net(VGG16_STAGES, device=self.dev)
        x = self.randn(VGG_INPUT, 7)
        nets = {m: api.optimize_graph(graph, VGG_INPUT,
                                      api.OptimizeConfig(mode=m))
                for m in ("brainslug", "barrier")}
        with torch.no_grad():
            want = nets["barrier"](x, params)
            torch.cuda.synchronize()
            ops.STATS.reset()
            nhwc.fused_nhwc.launches = rows.fused_rows.launches = 0
            got = nets["brainslug"](x, params)
            torch.cuda.synchronize()
            stats = ops.STATS.snapshot()
            launches = {"fused_nhwc": nhwc.fused_nhwc.launches,
                        "fused_rows": rows.fused_rows.launches}
        if tuple(got.shape) != (VGG_INPUT[0], 10):
            raise PhaseError(f"VGG output shape {tuple(got.shape)}")
        if not bool(torch.isfinite(got).all()):
            raise PhaseError("VGG output is not finite")
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, **PATH_TOL):
            raise PhaseError(f"VGG brainslug vs barrier max|d|={err:.3e}")
        if stats["fwd_generated"] <= 0 or stats["fwd_reference"] != 0:
            raise PhaseError(f"VGG dispatch counters {stats}")
        if launches["fused_nhwc"] != nets["brainslug"].n_sequences:
            raise PhaseError(f"VGG launches {launches}")
        self.vgg_launches = launches["fused_nhwc"]
        print(f"[4a main path: optimize_graph VGG-16 widths {VGG_INPUT}] "
              f"brainslug vs barrier max|d|={err:.3e} (tol {PATH_TOL}); "
              f"counters {stats}; launches {launches}")
        print(nets["brainslug"].explain())
        # the plain twin, written as ordinary tensor code, on a small input
        small = api.optimize_graph(graph, (2,) + VGG_INPUT[1:],
                                   api.OptimizeConfig(mode="brainslug"))
        with torch.no_grad():
            err_small = float((small(x[:2], params)
                               - cnn.vgg_fn(x[:2], params)).abs().max())
        if not err_small <= PATH_TOL["atol"]:
            raise PhaseError(f"VGG brainslug vs vgg_fn on 2 images "
                             f"max|d|={err_small:.3e}")
        print(f"[4a twin] brainslug on 2 images vs the plain twin vgg_fn: "
              f"max|d|={err_small:.3e}")
        with torch.no_grad():
            ms = [(m, self.cuda_ms(lambda m=m: nets[m](x, params), reps=1,
                                   groups=20))
                  for m in ("barrier", "brainslug", "brainslug", "barrier")]
        print("[4a time] forward, median of 20 runs (CUDA events), in turns: "
              + "  ".join(f"{m}={v:.3f} ms" for m, v in ms))
        for m in ("barrier", "brainslug"):
            print(f"[4a trace {m}] " + self.trace(lambda m=m: nets[m](x, params)))

        # 4b: the LM block's row chains at deepseek-7b widths
        cases = {c[0]: c for c in self.rows_cases()}
        cfg = api.OptimizeConfig(mode="brainslug")
        block = []
        for k, name in enumerate(("rms", "addnorm_rms", "glu_silu")):
            _, program, in_shapes, p_shapes, tol = cases[name]
            inputs, params_ = self.rows_inputs(name, in_shapes, p_shapes,
                                               900 + 100 * k)
            block.append((name, api.optimize_stack(program, in_shapes, cfg),
                          inputs, params_, program, tol))
        torch.cuda.synchronize()
        ops.STATS.reset()
        nhwc.fused_nhwc.launches = rows.fused_rows.launches = 0
        outs = [exe(inputs, p) for _, exe, inputs, p, _, _ in block]
        torch.cuda.synchronize()
        stats = ops.STATS.snapshot()
        launches_b = {"fused_nhwc": nhwc.fused_nhwc.launches,
                      "fused_rows": rows.fused_rows.launches}
        if stats["fwd_generated"] != 3 or stats["fwd_reference"] != 0 \
                or launches_b["fused_rows"] != 3:
            raise PhaseError(f"LM row chains: counters {stats}, launches "
                             f"{launches_b}")
        for (name, _, inputs, p, program, tol), out in zip(block, outs):
            self.check("fused_rows", f"LM row chain {name}", out,
                       ref.fused_stack_ref(program, inputs, p), tol)
        self.rows_launches = launches_b["fused_rows"]
        print(f"[4b main path: optimize_stack LM row chains rms, addnorm_rms,"
              f" glu_silu at {ROWS} x {D_MODEL}/{D_FF}] counters {stats}; "
              f"launches {launches_b}")

    def device_spans(self, fn, reps=1, spins=SPIN_KERNELS, counted=None):
        """(kernel name, start us, end us) of every device kernel ``reps``
        calls of ``fn`` launch, from a torch.profiler trace (after one
        untraced call); empty when the profiler records no device events.
        The profiler loses the first few device events of a session (on
        an H100 under torch 2.11: 5 of 20 launches, 1 of a prefill's 61
        rmsnorm launches), so the session opens with spin kernels that
        absorb the loss and are left out of the spans."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(spins):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        if counted is not None:             # spin kernels the trace kept
            counted.append(sum(e.device_type == DeviceType.CUDA
                               and "spin_kernel" in e.name
                               for e in prof.events()))
        return sorted(((e.name, e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and "spin_kernel" not in e.name),
                      key=lambda s: s[1])

    def device_ms(self, fn, reps=20):
        """Device milliseconds per call: the summed durations of the
        kernels one call launches (profiler, mean of ``reps`` calls), free
        of the host's launch overhead.  A trace whose kernel count is not a
        multiple of ``reps`` lost launches past the spin kernels (the
        mean would fall short: 0.0652 ms against 0.0924 for rms at (8192,
        4096) float32 on an H100), so it is taken again, up to three times.
        Without a whole trace, the event-timed :meth:`cuda_ms` stands in,
        and the label says so."""
        for _ in range(3):
            spans = self.device_spans(fn, reps)
            if spans and len(spans) % reps == 0:
                return sum(t1 - t0 for _, t0, t1 in spans) / reps / 1e3, \
                    "device"
        return self.cuda_ms(fn), "events"

    def trace(self, fn, expect=None, classify=None, spans=None) -> str:
        """Device time of one call by kernel group, the share of the traced
        window in which no kernel ran, and the largest kernels outside the
        named groups.  ``expect`` maps a kernel name fragment to the launches
        one call makes; a trace that holds fewer is reported as incomplete
        and its split is not given.  ``classify`` maps a lower-case kernel
        name to its group (default: the CNN groups).  ``spans`` are
        :meth:`device_spans` taken already."""
        spans = spans if spans is not None else self.device_spans(fn)
        if not spans:
            return "not measured (the profiler recorded no device events)"
        for frag, n in (expect or {}).items():
            seen = sum(frag in name for name, _, _ in spans)
            if seen != n:
                return (f"incomplete: the trace holds {seen} of the {n} "
                        f"{frag} launches the call made ({len(spans)} "
                        f"kernels); its split is not used")
        groups: dict[str, float] = {}
        other: dict[str, float] = {}
        for name, t0, t1 in spans:
            low = name.lower()
            g = (classify(low) if classify is not None
                 else "fused_nhwc_bwd" if any(k in low for k in (
                     "nhwc_bwd", "nhwc_overlap_add", "nhwc_reduce"))
                 else "fused_nhwc" if "fused_nhwc" in low
                 else "fused_rows_bwd" if any(k in low for k in (
                     "fused_rows_bwd", "reduce_partials"))
                 else "fused_rows" if "fused_rows" in low
                 else "conv" if any(
                     k in low for k in ("conv", "cudnn", "xmma", "implicit",
                                        "fft", "_complex"))
                 else "gemm" if "gemm" in low else "other")
            groups[g] = groups.get(g, 0.0) + (t1 - t0) / 1e3
            if g == "other":
                other[name[:70]] = other.get(name[:70], 0.0) + (t1 - t0) / 1e3
        busy, end = 0.0, spans[0][1]
        for _, t0, t1 in spans:                    # union of kernel spans
            if t1 > end:
                busy += t1 - max(t0, end)
                end = t1
        window = max(t1 for _, _, t1 in spans) - spans[0][1]
        parts = "  ".join(f"{g}={v:.3f} ms" for g, v in sorted(groups.items()))
        top = "; ".join(f"{n} {v:.3f} ms" for n, v in sorted(
            other.items(), key=lambda kv: -kv[1])[:4])
        return (f"device {busy / 1e3:.3f} ms busy of a {window / 1e3:.3f} ms "
                f"window (idle {100 * (1 - busy / window):.1f}%); by kernel "
                f"group: {parts}; {len(spans)} kernels; largest other: {top}")

    def bound(self, program, in_bytes, out_bytes, out_elems, in_elems,
              op_factor=1):
        """Least time: bytes moved once over HBM, or the chain's float32
        operations over the float32 peak, whichever is larger (the H100
        spec's SXM5 datasheet rates).  ``op_factor`` 3 counts a backward:
        the recompute, and about twice the forward's operations for the
        reverse sweep."""
        from repro_torch.core import ir
        from repro_torch.core.resource import H100
        ops = 0
        for op in program.ops:
            if op.kind == ir.OpKind.POOL2D:
                kh, kw = op.attrs["window"]
                ops += kh * kw * out_elems
            elif op.kind == ir.OpKind.AFFINE:
                ops += 2 * in_elems
            elif op.kind in (ir.OpKind.ROW_NORM, ir.OpKind.ROW_SOFTMAX):
                ops += 5 * in_elems
            else:
                ops += in_elems
        t_bytes = (in_bytes + out_bytes) / H100.hbm_bandwidth * 1e3
        t_ops = op_factor * ops / H100.peak_flops_f32 * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    def nhwc_path(self, program, shape, seq):
        """The forward's path at ``shape`` as a phrase: the fused path's
        items (``nhwc.fused_plan``) and persistent CTAs, or the generic
        kernel's tile and one CTA an item."""
        from repro_torch.kernels.fused_stack import nhwc
        if nhwc.fused_chain(program):
            plan = nhwc.fused_plan(program, shape)
            per_sm = nhwc.fused_ctas_per_sm()
            ctas = nhwc.launch_programs(plan.spatial, plan.n_cb,
                                        self.sm_count, per_sm)
            return (f"fused path, tile {plan.tile[0]}x{plan.tile[1]} x "
                    f"{plan.cb} channels, {plan.items} items, {plan.lanes} "
                    f"position lanes x {plan.cb // 4} channel quads, "
                    f"{per_sm} CTAs an SM, {ctas} CTAs")
        _, blob = nhwc._template(program, shape, (), (1,) * len(
            program.param_names), seq.tile_out_h, seq.tile_out_w)
        d = nhwc.NhwcDesc.from_buffer_copy(blob)
        items = d.N * d.tiles_h * d.tiles_w * d.n_cb
        return (f"generic path, tile {d.th}x{d.tw} x {d.cb} channels, "
                f"{items} items, one CTA an item")

    def phase5_timing(self):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.core import analyzer, collapse, ir, resource
        from repro_torch.kernels.fused_stack import nhwc, ref, rows
        from repro_torch.models import cnn

        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)

        graph, params = cnn.vgg_net(VGG16_STAGES, device=self.dev)
        self.vgg_params = params
        x = self.randn(VGG_INPUT, 7)
        segments = analyzer.analyze(graph, keep=frozenset({graph.output}))
        env = {graph.input: x}
        entries = []
        with torch.no_grad():
            for seg in segments:
                if not seg.is_stack:
                    env[seg.op.output] = ir.apply_op(seg.op, env, params)
                    continue
                xs = env[seg.stack.inputs[0]]
                self.vgg_stages.append((seg.stack, xs))
                plan = collapse.collapse(seg.stack,
                                         {seg.stack.inputs[0]: tuple(xs.shape)},
                                         resource.H100)
                seq = plan.sequences[0]
                sub = plan.subprogram(0)
                run = lambda: nhwc.fused_nhwc(  # noqa: E731
                    sub, xs, params, tile_out_h=seq.tile_out_h,
                    tile_out_w=seq.tile_out_w)
                y = run()
                want = ref.fused_stack_ref(seg.stack,
                                           {seg.stack.inputs[0]: xs}, params)
                self.check("fused_nhwc", f"VGG {seg.stack.name}",
                           {sub.outputs[0]: y}, want, NHWC_TOL)
                env.update(want)
                k_ms, k_how = self.device_ms(run)
                k_call = self.cuda_ms(run)
                p_ms, _ = self.device_ms(lambda: ref.fused_stack_ref(
                    sub, {sub.inputs[0]: xs}, params))
                pv = [params[p] for p in sub.param_names]
                b_ms, b_by = self.bound(sub, nbytes([xs] + pv), nbytes([y]),
                                        y.numel(), xs.numel())
                entries.append((seg.stack.name, tuple(xs.shape),
                                tuple(y.shape),
                                self.nhwc_path(sub, tuple(xs.shape), seq),
                                k_ms, k_how, k_call, p_ms, b_ms, b_by))
        print("[5 nhwc] per launch on the main path's shapes, each checked "
              "against the plain version; device time (profiler, mean of 20 "
              "calls) and per call (CUDA events around 20 back-to-back calls,"
              " median of 5):")
        for (name, si, so, path, k_ms, k_how, k_call, p_ms, b_ms,
             b_by) in entries:
            print(f"  {name} {si}->{so} {path}: kernel {k_ms:.4f} ms "
                  f"{k_how} ({k_call:.4f} per call)  plain {p_ms:.4f} ms  "
                  f"bound {b_ms:.4f} ms ({b_by})  kernel/bound "
                  f"{k_ms / b_ms:.2f}  library none")
        name, si, so, _, k_ms, _, _, p_ms, b_ms, b_by = entries[0]
        self.kernels["fused_nhwc"] = {
            "name": "fused_nhwc", "route": "cuda",
            "source": "src/repro_torch/kernels/fused_stack/csrc/fused_nhwc.cu",
            "replaces": "src/repro/kernels/fused_stack/nhwc.py:282",
            "launches": self.vgg_launches,
            "max_abs_err": self.err["fused_nhwc"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": f"{name} {si}->{so}"}

        library = {
            "rms": lambda i, p: F.rms_norm(i["x"], (D_MODEL,), p["scale"],
                                           1e-6),
            "layer_bias": lambda i, p: F.layer_norm(
                i["x"], (D_MODEL,), p["scale"], p["bias"], 1e-5),
            "softmax": lambda i, p: F.softmax(i["x"], dim=-1),
        }
        print("[5 rows] per launch at deepseek-7b widths; device time and per "
              "call as above:")
        rows_entries = {}
        for k, (name, program, in_shapes, p_shapes, _) in enumerate(
                self.rows_cases()):
            inputs, params_ = self.rows_inputs(name, in_shapes, p_shapes,
                                               400 + 100 * k)
            plan = collapse.collapse(program, in_shapes, resource.H100)
            tile = plan.sequences[0].tile_rows
            run = lambda: rows.fused_rows(  # noqa: E731
                program, inputs, params_, tile_rows=tile)
            out = run()
            k_ms, k_how = self.device_ms(run)
            k_call = self.cuda_ms(run)
            alt = PROGRAMS_ALT[rows.PROGRAMS_PER_SM]
            a_ms = self.at_programs_per_sm(run, alt)
            p_ms, _ = self.device_ms(lambda: ref.fused_stack_ref(
                program, inputs, params_))
            lib = library.get(name)
            l_ms = (self.device_ms(lambda: lib(inputs, params_))[0]
                    if lib else None)
            first = next(iter(out.values()))
            b_ms, b_by = self.bound(
                program, nbytes(list(inputs.values()) + list(
                    params_.values())), nbytes(out.values()), first.numel(),
                first.numel())
            rows_entries[name] = (k_ms, p_ms, l_ms, b_ms, b_by, tile)
            lib_s = f"{l_ms:.4f} ms" if l_ms is not None else "none"
            print(f"  {name} rows={math.prod(in_shapes[program.inputs[0]][:-1])}"
                  f" F={in_shapes[program.inputs[0]][-1]} tile_rows={tile}: "
                  f"kernel {k_ms:.4f} ms {k_how} ({k_call:.4f} per call; "
                  f"{rows.PROGRAMS_PER_SM} programs an SM, at {alt}: "
                  f"{a_ms:.4f} ms)  plain {p_ms:.4f} ms  library {lib_s}"
                  f"  bound {b_ms:.4f} ms ({b_by})  kernel/bound "
                  f"{k_ms / b_ms:.2f}")
        k_ms, p_ms, l_ms, b_ms, b_by, tile = rows_entries["rms"]
        self.kernels["fused_rows"] = {
            "name": "fused_rows", "route": "triton",
            "source": "src/repro_torch/kernels/fused_stack/rows.py",
            "replaces": "src/repro/kernels/fused_stack/rows.py:111",
            "launches": self.rows_launches,
            "max_abs_err": self.err["fused_rows"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms,
            "shape": f"norm_program rms {ROWS} x {D_MODEL}"}
        print(f"[6 kernels] fused_nhwc max|d|={self.err['fused_nhwc']:.3e}  "
              f"fused_rows max|d|={self.err['fused_rows']:.3e}")

    # -- the training slice ---------------------------------------------------
    def check_bwd(self, kernel, what, got, want, reduced, tol=BWD_TOL):
        """Gradients ``got`` against ``want`` (name -> tensor) within
        ``tol``; names in ``reduced`` are sums over every position, whose
        atol scales with their largest entry.  Returns a summary: the
        largest |d| of the input cotangents, and of the reduced gradients
        with its share of their largest entry."""
        torch = self.torch
        torch.cuda.synchronize()
        worst = 0.0
        cot, red, red_rel = 0.0, 0.0, 0.0
        for k, w in want.items():
            g = got[k]
            if g.shape != w.shape:
                raise PhaseError(f"{kernel} {what}: {k} shape "
                                 f"{tuple(g.shape)} != {tuple(w.shape)}")
            if not bool(torch.isfinite(g).all()):
                raise PhaseError(f"{kernel} {what}: non-finite {k}")
            if not w.numel():
                continue
            if g.dtype != w.dtype:
                raise PhaseError(f"{kernel} {what}: {k} is {g.dtype}, the "
                                 f"plain version's {w.dtype}")
            g, w = g.float(), w.float()
            d = (g - w).abs()
            atol = tol["atol"]
            if k in reduced:
                atol = max(atol, tol["rtol"] * float(w.abs().max()))
            err = float(d.max())
            worst = max(worst, err)
            if k in reduced:
                red = max(red, err)
                red_rel = max(red_rel, err / max(float(w.abs().max()), 1e-30))
            else:
                cot = max(cot, err)
            if not bool((d <= atol + tol["rtol"] * w.abs()).all()):
                raise PhaseError(f"{kernel} {what}: {k} max|d|={err:.3e} "
                                 f"outside atol {atol:.1e} rtol "
                                 f"{tol['rtol']}")
        self.err[kernel] = max(self.err[kernel], worst)
        return (f"{cot:.1e}" + (f"/{red:.1e} ({red_rel:.1e} of max)"
                                if reduced else ""))

    def same_bits(self, kernel, what, a, b):
        for k in a:
            if not self.torch.equal(a[k], b[k]):
                raise PhaseError(f"{kernel} {what}: two runs differ in {k}")

    def nhwc_bwd_grads(self, program, x, params, extras, g, tile):
        from repro_torch.kernels.fused_stack import nhwc_bwd
        dx, dext, dpar = nhwc_bwd.fused_nhwc_bwd(
            program, x, extras, params, g, tile_out_h=tile[0],
            tile_out_w=tile[1])
        return {"dx": dx, **{f"d{k}": v for k, v in {**dext, **dpar}.items()}}

    def nhwc_bwd_items(self):
        """(name, program, x, params, extras, tile) of phase 7: phase 2's
        cases, exact ties, a chain at 70 channels, VGG-16's stages on phase
        5's stage inputs and block_net(8, 32), the last two with their
        training tiles."""
        torch = self.torch
        from repro_torch.core import analyzer, collapse, resource
        from repro_torch.models import cnn
        cases, bparams = self.nhwc_cases()
        items = []
        for k, (name, program, shape, tile, extra_shapes) in enumerate(cases):
            x, params, extras = self.nhwc_operands(program, shape,
                                                   extra_shapes, bparams, k)
            items.append((name, program, x, params, extras, (tile, tile)))
        name, program, shape, tile, _ = cases[0]
        x, params, _ = self.nhwc_operands(program, shape, {}, bparams, 0)
        items.append(("max_pool_ties", program, torch.round(x), params, {},
                      (tile, tile)))
        # 70 channels: two channel blocks, the second 6 wide (no float4)
        name, program, shape, tile, _ = next(c for c in cases if c[0] ==
                                             "image_not_tile_multiple")
        shape = shape[:3] + (70,)
        x, params, _ = self.nhwc_operands(program, shape, {}, bparams, 50)
        items.append(("channels_70", program, x, params, {}, (tile, tile)))
        items += self.vgg_bwd_items()
        graph, bp = cnn.block_net(8, channels=32, device=self.dev)
        seg, = analyzer.analyze(graph, keep=frozenset({graph.output}))
        plan = collapse.collapse(seg.stack, {"x": BLOCK_INPUT}, resource.H100,
                                 differentiable=True)
        x = self.randn(BLOCK_INPUT, 150, 2.0)
        for i, seq in enumerate(plan.sequences):
            items.append((f"block_net8_train_seq{i}", plan.subprogram(i), x,
                          bp, {}, (seq.tile_out_h, seq.tile_out_w)))
        return items

    def vgg_bwd_items(self):
        """Phase 7's items of VGG-16's five stages (one sequence each) on
        phase 5's stage inputs, with their training tiles."""
        from repro_torch.core import collapse, resource
        items = []
        for i, (stack, xs) in enumerate(self.vgg_stages):
            plan = collapse.collapse(stack, {stack.inputs[0]: tuple(xs.shape)},
                                     resource.H100, differentiable=True)
            for j, seq in enumerate(plan.sequences):
                items.append((f"vgg16_stage{i + 1}", plan.subprogram(j), xs,
                              self.vgg_params, {},
                              (seq.tile_out_h, seq.tile_out_w)))
        return items

    def nhwc_bwd_plan(self, program, x, tile):
        """The backward's work items at ``x``'s shape, as a line."""
        from repro_torch.kernels.fused_stack import nhwc_bwd
        plan = nhwc_bwd.launch_plan(program, tuple(x.shape), (), *tile)
        b = nhwc_bwd.NhwcBwdDesc.from_buffer_copy(nhwc_bwd.bwd_template(
            program, tuple(x.shape), (), (1,) * len(program.param_names),
            *tile))
        per_sm = nhwc_bwd._ctas_per_sm(nhwc_bwd._library(), b)
        programs = nhwc_bwd.launch_programs(plan.spatial, plan.n_cb,
                                            self.sm_count, per_sm)
        return (f"tile {plan.tile[0]}x{plan.tile[1]} (input "
                f"{plan.level0[0]}x{plan.level0[1]}) x {plan.cb} channels, "
                f"{plan.items} items, {plan.lanes} position lanes x "
                f"{plan.cb // 4} channel quads, {plan.smem} B shared, "
                f"{per_sm} CTAs an SM, {programs} CTAs")

    def phase7_nhwc_bwd(self):
        from repro_torch.core import ir
        from repro_torch.kernels.fused_stack import nhwc_bwd
        t = time.perf_counter()
        lines = []
        for k, (name, program, x, params, extras, tile) in enumerate(
                self.nhwc_bwd_items()):
            shapes = {program.inputs[0]: tuple(x.shape),
                      **{e: tuple(v.shape) for e, v in extras.items()}}
            out = ir.infer_shapes(program, shapes)[program.outputs[0]]
            g = self.randn(out, 1000 + k)
            got = self.nhwc_bwd_grads(program, x, params, extras, g, tile)
            again = self.nhwc_bwd_grads(program, x, params, extras, g, tile)
            dx, dext, dpar = nhwc_bwd.fused_nhwc_bwd_ref(program, x, extras,
                                                         params, g)
            want = {"dx": dx,
                    **{f"d{n}": v for n, v in {**dext, **dpar}.items()}}
            err = self.check_bwd("fused_nhwc_bwd", name, got, want,
                                 reduced=set(want) - {"dx"})
            self.same_bits("fused_nhwc_bwd", name, got, again)
            lines.append(f"{name}[{tile[0]}x{tile[1]}]={err}")
        print(f"[7 nhwc_bwd] {len(lines)} cases agree with the plain version "
              f"(tol {BWD_TOL}, reduced gradients atol rtol*max; max|d| of "
              f"dx / of the reduced gradients) and two runs give equal bits: "
              f"{' '.join(lines)}; "
              f"{time.perf_counter() - t:.1f} s")

    def rows_cotangents(self, program, inputs, params, seed):
        from repro_torch.kernels.fused_stack import ref
        out = ref.fused_stack_ref(program, inputs, params)
        return {v: self.randn(tuple(out[v].shape), seed + i)
                for i, v in enumerate(program.outputs)}

    def rows_bwd_grads(self, program, inputs, params, cot, tile):
        from repro_torch.kernels.fused_stack import rows_bwd
        dins, dpar = rows_bwd.fused_rows_bwd(program, inputs, params, cot,
                                             tile_rows=tile)
        return {f"d{k}": v for k, v in {**dins, **dpar}.items()}

    def train_tile(self, name, program, in_shapes):
        """The training plan's row tile.  ``every_fn_affine`` is a test
        chain, not a program of the slice: its 26 live values exceed the
        training budget at any tile (26 x 2048 x 4 B for one row), so it
        runs at one row per tile."""
        from repro_torch.core import collapse, resource
        if name == "every_fn_affine":
            return 1
        plan = collapse.collapse(program, in_shapes, resource.H100,
                                 differentiable=True)
        return plan.sequences[0].tile_rows

    def phase8_rows_bwd(self):
        from repro_torch.kernels.fused_stack import rows_bwd
        t = time.perf_counter()
        lines = []
        for k, (name, program, in_shapes, p_shapes, _) in enumerate(
                self.rows_cases()):
            inputs, params = self.rows_inputs(name, in_shapes, p_shapes,
                                              400 + 100 * k)
            tile = self.train_tile(name, program, in_shapes)
            cot = self.rows_cotangents(program, inputs, params, 2000 + 10 * k)
            got = self.rows_bwd_grads(program, inputs, params, cot, tile)
            again = self.rows_bwd_grads(program, inputs, params, cot, tile)
            dins, dpar = rows_bwd.fused_rows_bwd_ref(program, inputs, params,
                                                     cot)
            want = {f"d{n}": v for n, v in {**dins, **dpar}.items()}
            # parameter gradients and width-1 input cotangents are sums
            # over rows or over F
            reduced = {f"d{p}" for p in program.param_names} | {
                f"d{n}" for n, v in inputs.items() if v.shape[-1] == 1}
            err = self.check_bwd("fused_rows_bwd", name, got, want,
                                 reduced=reduced)
            self.same_bits("fused_rows_bwd", name, got, again)
            lines.append(f"{name}[rows {tile}]={err}")
        print(f"[8 rows_bwd] {len(lines)} cases at {ROWS} x {D_MODEL}/{D_FF} "
              f"agree with the plain version (tol {BWD_TOL}, reduced "
              f"gradients (parameters, width-1 inputs) atol rtol*max; max|d| "
              f"of the input cotangents / of the reduced gradients) and two "
              f"runs give equal bits: "
              f"{' '.join(lines)}; Triton compiles included: "
              f"{time.perf_counter() - t:.1f} s")
        self.phase8_rows_bwd_bf16()

    def phase8_rows_bwd_bf16(self):
        """The rows backward on bf16 chains at deepseek-7b widths against
        its plain version (``autodiff.program_vjp`` on the bf16 tensors)
        within LM_TOL's bf16 tolerance, each gradient in its primal's dtype;
        two runs give equal bits."""
        torch = self.torch
        from repro_torch.layers import stacks
        d, f = ROWS + (D_MODEL,), ROWS + (D_FF,)
        vec = (D_MODEL,)
        cases = [
            ("rms", stacks.norm_program("rms", 1e-6, False), {"x": d},
             {"scale": vec}),
            ("addnorm_layer_bias", stacks.addnorm_program("layer", 1e-5, True),
             {"x": d, "res": d}, {"scale": vec, "bias": vec}),
            ("glu_silu", stacks.glu_program("silu"), {"gate": f, "up": f},
             {}),
        ]
        t = time.perf_counter()
        lines = []
        for k, (name, program, in_shapes, p_shapes) in enumerate(cases):
            inputs, _ = self.rows_inputs(name, in_shapes, {}, 3400 + 100 * k)
            inputs = {n: v.to(torch.bfloat16) for n, v in inputs.items()}
            params = {n: ((1.0 if n == "scale" else 0.0) + 0.1 * self.randn(
                shp, 3450 + 100 * k + j)).to(torch.bfloat16)
                for j, (n, shp) in enumerate(p_shapes.items())}
            tile = self.train_tile(name, program, in_shapes)
            cot = {v: c.to(torch.bfloat16) for v, c in self.rows_cotangents(
                program, inputs, params, 3480 + 10 * k).items()}
            got = self.rows_bwd_grads(program, inputs, params, cot, tile)
            again = self.rows_bwd_grads(program, inputs, params, cot, tile)
            from repro_torch.kernels.fused_stack import rows_bwd
            dins, dpar = rows_bwd.fused_rows_bwd_ref(program, inputs, params,
                                                     cot)
            want = {f"d{n}": v for n, v in {**dins, **dpar}.items()}
            reduced = {f"d{p}" for p in program.param_names}
            err = self.check_bwd("fused_rows_bwd_bf16", f"bf16 {name}", got,
                                 want, reduced=reduced,
                                 tol=LM_TOL["bfloat16"])
            self.same_bits("fused_rows_bwd", f"bf16 {name}", got, again)
            lines.append(f"{name}[rows {tile}]={err}")
        print(f"[8 rows_bwd bf16] {len(lines)} bf16 chains at {ROWS} x "
              f"{D_MODEL}/{D_FF} agree with the plain version in bf16 (tol "
              f"{LM_TOL['bfloat16']}, parameter gradients atol rtol*max) and "
              f"two runs give equal bits: {' '.join(lines)}; "
              f"{time.perf_counter() - t:.1f} s")

    def launch_counts(self):
        from repro_torch.kernels.fused_stack import nhwc, nhwc_bwd, rows, \
            rows_bwd
        return {"fused_nhwc": nhwc.fused_nhwc.launches,
                "fused_rows": rows.fused_rows.launches,
                "fused_nhwc_bwd": nhwc_bwd.fused_nhwc_bwd.launches,
                "fused_rows_bwd": rows_bwd.fused_rows_bwd.launches}

    def zero_counts(self):
        from repro_torch.kernels.fused_stack import nhwc, nhwc_bwd, ops, \
            rows, rows_bwd
        ops.STATS.reset()
        nhwc.fused_nhwc.launches = rows.fused_rows.launches = 0
        nhwc_bwd.fused_nhwc_bwd.launches = rows_bwd.fused_rows_bwd.launches = 0

    def sgd(self, net, leaves, loss_fn):
        """TRAIN_STEPS plain SGD steps of ``loss_fn(net(leaves))`` over every
        leaf.  Returns the losses, the step-1 gradients, and the dispatch
        and launch counts of each step."""
        torch = self.torch
        from repro_torch.kernels.fused_stack import ops
        leaves = {k: v.detach().clone() for k, v in leaves.items()}
        losses, first, per_step = [], None, []
        for _ in range(TRAIN_STEPS):
            before, l0 = ops.STATS.snapshot(), self.launch_counts()
            with torch.enable_grad():
                req = {k: v.requires_grad_() for k, v in leaves.items()}
                loss = loss_fn(net(req))
                grads = torch.autograd.grad(loss, list(req.values()))
            with torch.no_grad():
                leaves = {k: v - TRAIN_LR * g
                          for (k, v), g in zip(req.items(), grads)}
            torch.cuda.synchronize()
            l1 = self.launch_counts()
            per_step.append((ops.STATS.delta(before),
                             {k: l1[k] - l0[k] for k in l1}))
            losses.append(float(loss.detach()))
            if first is None:
                first = dict(zip(req, grads))
        return losses, first, per_step

    def compare_training(self, what, runs, n_seq, bwd_kernel):
        """``runs[mode] = (losses, step-1 grads, per-step counts)``:
        brainslug against barrier, and brainslug's counters per step."""
        torch = self.torch
        (lb, gb, steps), (lr_, gr, _) = runs["brainslug"], runs["barrier"]
        worst = 0.0
        for k, w in gr.items():
            d = (gb[k] - w).abs()
            scale = float(w.abs().max())
            worst = max(worst, float(d.max()) / max(scale, 1e-30))
            if not bool(torch.isfinite(gb[k]).all()) or not bool(
                    (d <= TRAIN_RTOL * (w.abs() + scale)).all()):
                raise PhaseError(f"{what}: step-1 gradient of {k} max|d| "
                                 f"{float(d.max()):.3e} (max|g| {scale:.3e})")
        for a, b in zip(lb, lr_):
            if not math.isfinite(a) or abs(a - b) > TRAIN_RTOL * abs(b):
                raise PhaseError(f"{what}: losses {lb} vs barrier {lr_}")
        for i, (stats, launches) in enumerate(steps):
            if stats["bwd_generated"] != n_seq or stats["bwd_reference"] \
                    or stats["fwd_generated"] != n_seq \
                    or stats["fwd_reference"] or launches[bwd_kernel] != n_seq:
                raise PhaseError(f"{what} step {i + 1}: counters {stats}, "
                                 f"launches {launches}, {n_seq} sequences")
        return worst

    def phase9_train(self):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.core import api
        from repro_torch.models import cnn
        t = time.perf_counter()
        graph, params = cnn.vgg_net(VGG16_STAGES, device=self.dev)
        x = self.randn(VGG_INPUT, 7)
        labels = torch.randint(0, 10, (VGG_INPUT[0],), device=self.dev,
                               generator=torch.Generator(
                                   device=self.dev).manual_seed(8))
        nets = {m: api.optimize_graph(graph, VGG_INPUT, api.OptimizeConfig(
            mode=m, differentiable=True)) for m in ("brainslug", "barrier")}
        runs = {}
        for m in ("barrier", "brainslug"):
            self.zero_counts()
            runs[m] = self.sgd(lambda p, m=m: nets[m](x, p), params,
                               lambda y: F.cross_entropy(y, labels))
            total = self.launch_counts()
        n_seq = nets["brainslug"].n_sequences
        worst = self.compare_training("VGG training", runs, n_seq,
                                      "fused_nhwc_bwd")
        self.train_launches = {"fused_nhwc_bwd": total["fused_nhwc_bwd"]}
        print(f"[9a main path: training, optimize_graph VGG-16 widths "
              f"{VGG_INPUT}, differentiable=True, {TRAIN_STEPS} SGD steps lr "
              f"{TRAIN_LR}] losses brainslug {runs['brainslug'][0]} barrier "
              f"{runs['barrier'][0]}; step-1 gradients max|d|/max|g| = "
              f"{worst:.3e} (tol rtol {TRAIN_RTOL}, atol {TRAIN_RTOL}*max|g|);"
              f" counters per step {[s for s, _ in runs['brainslug'][2]]}; "
              f"launches over the run {total}")
        print(nets["brainslug"].explain())
        self.train_nets, self.train_data = nets, (x, labels, params)

        cases = {c[0]: c for c in self.rows_cases()}
        lines, total_rows = [], 0
        for k, name in enumerate(("rms", "addnorm_rms", "glu_silu")):
            _, program, in_shapes, p_shapes, _ = cases[name]
            inputs, p = self.rows_inputs(name, in_shapes, p_shapes,
                                         900 + 100 * k)
            target = self.rows_cotangents(program, inputs, p, 3000 + 10 * k)
            rows_n = math.prod(in_shapes[program.inputs[0]][:-1])
            exes = {m: api.optimize_stack(program, in_shapes,
                                          api.OptimizeConfig(
                                              mode=m, differentiable=True))
                    for m in ("brainslug", "barrier")}

            def loss_fn(out, program=program, target=target, rows_n=rows_n):
                return sum(0.5 * torch.square(out[v] - target[v]).sum()
                           / rows_n for v in program.outputs)

            runs = {}
            for m in ("barrier", "brainslug"):
                self.zero_counts()
                runs[m] = self.sgd(
                    lambda L, m=m, program=program: exes[m](
                        {n: L[n] for n in program.inputs},
                        {q: L[q] for q in program.param_names}),
                    {**inputs, **p}, loss_fn)
                launches = self.launch_counts()
            worst = self.compare_training(f"LM {name} training", runs, 1,
                                          "fused_rows_bwd")
            total_rows += launches["fused_rows_bwd"]
            lines.append(f"{name}: losses {runs['brainslug'][0]} (barrier "
                         f"{runs['barrier'][0]}), step-1 max|d|/max|g| "
                         f"{worst:.2e}, counters per step "
                         f"{runs['brainslug'][2][0][0]}, launches "
                         f"{launches}")
        self.train_launches["fused_rows_bwd"] = total_rows
        print(f"[9b main path: training, optimize_stack LM row chains at "
              f"{ROWS} x {D_MODEL}/{D_FF}, differentiable=True, "
              f"{TRAIN_STEPS} SGD steps] " + "; ".join(lines) +
              f" ({time.perf_counter() - t:.1f} s for 9a and 9b)")

    def phase10_bwd_timing(self):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.core import ir
        from repro_torch.kernels.fused_stack import nhwc_bwd, rows_bwd

        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)

        entries = []
        for k, (name, program, xs, params, _, tile) in enumerate(
                self.vgg_bwd_items()):
            out = ir.infer_shapes(program, {program.inputs[0]:
                                            tuple(xs.shape)})
            g = self.randn(out[program.outputs[0]], 1100 + k)
            run = lambda: nhwc_bwd.fused_nhwc_bwd(  # noqa: E731
                program, xs, {}, params, g, tile_out_h=tile[0],
                tile_out_w=tile[1])
            dx, _, dp = run()
            k_ms, k_how = self.device_ms(run)
            k_call = self.cuda_ms(run)
            p_ms, _ = self.device_ms(lambda: nhwc_bwd.fused_nhwc_bwd_ref(
                program, xs, {}, params, g))
            pv = [params[q] for q in program.param_names]
            b_ms, b_by = self.bound(program, nbytes([xs, g] + pv),
                                    nbytes([dx] + list(dp.values())),
                                    g.numel(), xs.numel(), op_factor=3)
            entries.append((name, tuple(xs.shape), tile, k_ms, k_how, k_call,
                            p_ms, b_ms, b_by,
                            self.nhwc_bwd_plan(program, xs, tile)))
        print(f"[10 nhwc_bwd] per launch on the training path's shapes "
              f"(VGG-16 stages, batch {VGG_INPUT[0]}, the planner's training "
              f"tiles; the items are the launch plan's); device time "
              f"(profiler, mean of 20 calls) and per call (CUDA events around "
              f"20 back-to-back calls, median of 5); bound: x and g read, dx "
              f"written once; {self.smi}:")
        for (name, si, tile, k_ms, k_how, k_call, p_ms, b_ms, b_by,
             plan) in entries:
            print(f"  {name} {si} planner tile {tile[0]}x{tile[1]}: kernel "
                  f"{k_ms:.4f} ms {k_how} ({k_call:.4f} per call)  plain "
                  f"{p_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
                  f"kernel/bound {k_ms / b_ms:.2f}  library none  items: "
                  f"{plan}")
        name, si, tile, k_ms, _, _, p_ms, b_ms, b_by, plan = entries[0]
        self.kernels["fused_nhwc_bwd"] = {
            "name": "fused_nhwc_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/fused_stack/csrc/"
                      "fused_nhwc_bwd.cu",
            "replaces": "src/repro/kernels/fused_stack/nhwc_bwd.py:168",
            "launches": self.train_launches["fused_nhwc_bwd"],
            "max_abs_err": self.err["fused_nhwc_bwd"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": f"{name} {si} tile {tile}",
            "launch_plan": plan, "registers": self.nhwc_bwd_ptxas}

        def lib_grad(fn, names):
            """Autograd of one PyTorch call: the backward alone, timed."""
            def make(inputs, params, cot):
                leaves = {n: t.detach().requires_grad_() for n, t in
                          {**inputs, **params}.items()}
                with torch.enable_grad():
                    y = fn(leaves)
                wrt = [leaves[n] for n in names]
                g = next(iter(cot.values()))
                return lambda: torch.autograd.grad(y, wrt, g,
                                                   retain_graph=True)
            return make

        library = {
            "rms": lib_grad(lambda L: F.rms_norm(L["x"], (D_MODEL,),
                                                 L["scale"], 1e-6),
                            ("x", "scale")),
            "layer": lib_grad(lambda L: F.layer_norm(L["x"], (D_MODEL,),
                                                     L["scale"], None, 1e-5),
                              ("x", "scale")),
            "layer_bias": lib_grad(lambda L: F.layer_norm(
                L["x"], (D_MODEL,), L["scale"], L["bias"], 1e-5),
                ("x", "scale", "bias")),
            "softmax": lib_grad(lambda L: F.softmax(L["x"], dim=-1), ("x",)),
        }
        print("[10 rows_bwd] per launch at deepseek-7b widths with the "
              "training tiles; device time and per call as above; library: "
              "autograd of one PyTorch call, the backward alone; bound: "
              "inputs and cotangents read, input cotangents written once:")
        rows_entries = {}
        for k, (name, program, in_shapes, p_shapes, _) in enumerate(
                self.rows_cases()):
            if name in ("ragged_rows", "scalar_chunks"):
                continue
            inputs, params = self.rows_inputs(name, in_shapes, p_shapes,
                                              400 + 100 * k)
            tile = self.train_tile(name, program, in_shapes)
            cot = self.rows_cotangents(program, inputs, params, 2000 + 10 * k)
            run = lambda: rows_bwd.fused_rows_bwd(  # noqa: E731
                program, inputs, params, cot, tile_rows=tile)
            dins, dpar = run()
            regs = self.triton_regs(self.rows_jit(bwd=True))
            k_ms, k_how = self.device_ms(run)
            k_call = self.cuda_ms(run)
            p_ms, _ = self.device_ms(lambda: rows_bwd.fused_rows_bwd_ref(
                program, inputs, params, cot))
            lib = library.get(name)
            l_ms = (self.device_ms(lib(inputs, params, cot))[0] if lib
                    else None)
            first = next(iter(inputs.values()))
            b_ms, b_by = self.bound(
                program, nbytes([*inputs.values(), *params.values(),
                                 *cot.values()]),
                nbytes([*dins.values(), *dpar.values()]), first.numel(),
                first.numel(), op_factor=3)
            rows_entries[name] = (k_ms, p_ms, l_ms, b_ms, b_by, tile, regs)
            lib_s = f"{l_ms:.4f} ms" if l_ms is not None else "none"
            print(f"  {name} rows={math.prod(in_shapes[program.inputs[0]][:-1])}"
                  f" F={in_shapes[program.inputs[0]][-1]} tile_rows={tile}: "
                  f"kernel {k_ms:.4f} ms {k_how} ({k_call:.4f} per call)  "
                  f"plain {p_ms:.4f} ms  library {lib_s}"
                  f"  bound {b_ms:.4f} ms ({b_by})  kernel/bound "
                  f"{k_ms / b_ms:.2f}  {regs}")
        self.gated_norm_bwd_timing(nbytes)
        k_ms, p_ms, l_ms, b_ms, b_by, tile, regs = rows_entries["rms"]
        self.kernels["fused_rows_bwd"] = {
            "name": "fused_rows_bwd", "route": "triton",
            "source": "src/repro_torch/kernels/fused_stack/rows_bwd.py",
            "replaces": "src/repro/kernels/fused_stack/rows_bwd.py:109",
            "launches": self.train_launches["fused_rows_bwd"],
            "max_abs_err": self.err["fused_rows_bwd"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms, "registers": regs,
            "shape": f"norm_program rms {ROWS} x {D_MODEL} tile {tile}",
            "gated_norm": self.gated_norm_bwd}

        nets = self.train_nets
        x, labels, params = self.train_data

        def step(m):
            with torch.enable_grad():
                req = {k: v.detach().requires_grad_()
                       for k, v in params.items()}
                loss = F.cross_entropy(nets[m](x, req), labels)
                grads = torch.autograd.grad(loss, list(req.values()))
            with torch.no_grad():
                return [v - TRAIN_LR * g for v, g in zip(req.values(), grads)]

        ms = [(m, self.cuda_ms(lambda m=m: step(m), reps=1, groups=10))
              for m in ("barrier", "brainslug", "brainslug", "barrier")]
        print(f"[10 train step] VGG-16 widths {VGG_INPUT}: forward + "
              f"backward + SGD update, median of 10 steps (CUDA events), in "
              f"turns: " + "  ".join(f"{m}={v:.3f} ms" for m, v in ms))
        n_seq = nets["brainslug"].n_sequences
        expect = {"brainslug": {"fused_nhwc_kernel": n_seq,
                                "fused_nhwc_bwd_kernel": n_seq},
                  "barrier": {}}
        for m in ("barrier", "brainslug"):
            print(f"[10 trace train step {m}] "
                  + self.trace(lambda m=m: step(m), expect[m]))
        print(f"[10 kernels] fused_nhwc_bwd max|d|="
              f"{self.err['fused_nhwc_bwd']:.3e}  fused_rows_bwd max|d|="
              f"{self.err['fused_rows_bwd']:.3e}")


    @staticmethod
    def triton_regs(jit_fn):
        """Registers a thread and bytes spilled of the kernels Triton has
        compiled from one JIT function (one for each specialization of its
        arguments), read from Triton's cache."""
        found = []
        for entry in getattr(jit_fn, "device_caches", {}).values():
            for cache in (c for c in entry if isinstance(c, dict)):
                found += [k for k in cache.values() if hasattr(k, "n_regs")]
        if not found:
            return "registers not read (no compiled kernel in Triton's cache)"
        regs = sorted({k.n_regs for k in found})
        spills = sorted({k.n_spills for k in found})
        text = (f"{'/'.join(map(str, regs))} registers, "
                f"{'/'.join(map(str, spills))} bytes spilled")
        return text if len(found) == 1 else (
            f"{text} ({len(found)} compiled specializations)")

    @staticmethod
    def rows_jit(bwd=False):
        """The JIT function of the rows kernel launched last (the wrappers'
        caches keep the one in use last)."""
        from repro_torch.kernels.fused_stack import rows, rows_bwd
        if bwd:
            return next(reversed(rows_bwd._MODULES.values())
                        ).fused_rows_bwd_kernel
        return next(reversed(rows._KERNELS.values()))

    def at_programs_per_sm(self, run, n):
        """Device time of a rows-forward call with its grid at ``n``
        programs an SM in place of ``rows.PROGRAMS_PER_SM``."""
        from repro_torch.kernels.fused_stack import rows
        keep = rows.PROGRAMS_PER_SM
        rows.PROGRAMS_PER_SM = n
        try:
            return self.device_ms(run)[0]
        finally:
            rows.PROGRAMS_PER_SM = keep

    def gated_norm_bwd_timing(self, nbytes):
        """The rows backward at mamba2's gated norm, one 4096-token
        training sequence over d_inner 5120 in bf16 (each launch of its
        training step): against its plain version, two runs bit for bit,
        its device time beside the byte bound, registers and spills."""
        torch = self.torch
        from repro_torch.kernels.fused_stack import rows_bwd
        from repro_torch.layers import mamba2
        bf = torch.bfloat16
        shape = (TRAIN_LM["seq"], 5120)
        program = mamba2._gated_norm_program(1e-6)
        inputs = {"y": self.randn(shape, 1180).to(bf),
                  "z": self.randn(shape, 1181).to(bf)}
        params = {"scale": (1.0 + 0.1 * self.randn(shape[-1:], 1182)).to(bf)}
        cot = {"o": self.randn(shape, 1183).to(bf)}
        run = lambda: rows_bwd.fused_rows_bwd(  # noqa: E731
            program, inputs, params, cot)
        dins, dpar = run()
        dins2, dpar2 = run()
        regs = self.triton_regs(self.rows_jit(bwd=True))
        want_in, want_p = rows_bwd.fused_rows_bwd_ref(program, inputs,
                                                      params, cot)
        got = {f"d{n}": v for n, v in {**dins, **dpar}.items()}
        err = self.check_bwd("mamba_rows_bwd", "gated norm bwd", got,
                             {f"d{n}": v for n, v in
                              {**want_in, **want_p}.items()},
                             reduced={"dscale"}, tol=LM_TOL["bfloat16"])
        self.same_bits("fused_rows_bwd", "gated norm bwd", got,
                       {f"d{n}": v for n, v in {**dins2, **dpar2}.items()})
        k_ms, k_how = self.device_ms(run)
        k_call = self.cuda_ms(run)
        p_ms, _ = self.device_ms(lambda: rows_bwd.fused_rows_bwd_ref(
            program, inputs, params, cot))
        from repro_torch.core.resource import H100
        b_ms = nbytes([*inputs.values(), *params.values(), *cot.values(),
                       *dins.values(), *dpar.values()]) \
            / H100.hbm_bandwidth * 1e3
        print(f"  gated_norm (mamba2) rows={shape[0]} F={shape[1]} bf16: "
              f"kernel {k_ms:.4f} ms {k_how} ({k_call:.4f} per call)  plain "
              f"{p_ms:.4f} ms  library none  bound {b_ms:.4f} ms (bytes)  "
              f"kernel/bound {k_ms / b_ms:.2f}  {regs}; max|d| {err}")
        self.gated_norm_bwd = {"shape": f"{shape} bf16", "ms": k_ms,
                               "plain_ms": p_ms, "bound_ms": b_ms,
                               "registers": regs}

    # -- the LM serving slice -------------------------------------------------
    def lm_check(self, kernel, what, got, want):
        """A new kernel's output against its plain version, at LM_TOL of
        the output's dtype; max|d| in float32."""
        tol = LM_TOL[str(want.dtype).split(".")[-1]]
        return self.check(kernel, what, {"out": got.float()},
                          {"out": want.float()}, tol)

    def lm_counters(self, zero=False):
        """Launch counts of the four LM kernels and the kernel / plain
        dispatch counts of their wrappers (``zero`` sets them to 0)."""
        from repro_torch.kernels.attention import decode, flash
        from repro_torch.kernels.attention import ops as aops
        from repro_torch.kernels.rmsnorm import ops as rops
        from repro_torch.kernels.rmsnorm import rmsnorm
        from repro_torch.kernels.swiglu import ops as sops
        from repro_torch.kernels.swiglu import swiglu
        fns = {"rmsnorm": rmsnorm.rmsnorm_fwd, "swiglu": swiglu.swiglu_fwd,
               "flash_attention": flash.flash_attention_fwd,
               "flash_decode": decode.flash_decode,
               "paged_flash_decode": decode.paged_flash_decode}
        if zero:
            for fn in fns.values():
                fn.launches = 0
            for st in (aops.STATS, rops.STATS, sops.STATS):
                st.reset()
        out = {k: fn.launches for k, fn in fns.items()}
        out.update({f"rmsnorm_{k}": v for k, v in rops.STATS.counts.items()})
        out.update({f"swiglu_{k}": v for k, v in sops.STATS.counts.items()})
        out.update(aops.STATS.snapshot())
        return out

    def expect_counters(self, what, got, launches):
        """Every LM dispatch of the run on a kernel: the launches as
        ``launches`` says, no plain dispatch."""
        launches = {"paged_flash_decode": 0, **launches}
        want = {**launches,
                "rmsnorm_kernel": launches["rmsnorm"], "rmsnorm_plain": 0,
                "swiglu_kernel": launches["swiglu"], "swiglu_plain": 0,
                "decode_kernel": launches["flash_decode"], "decode_plain": 0,
                "decode_ref": 0,
                "paged_decode_kernel": launches["paged_flash_decode"],
                "paged_decode_plain": 0, "paged_decode_ref": 0}
        if got != want:
            raise PhaseError(f"{what}: counters {got}, expected {want}")

    def phase11_lm_kernels(self):
        torch = self.torch
        from repro_torch.kernels.attention import decode, flash
        from repro_torch.kernels.rmsnorm import ref as rref
        from repro_torch.kernels.rmsnorm import rmsnorm
        from repro_torch.kernels.swiglu import ref as sref
        from repro_torch.kernels.swiglu import swiglu
        t = time.perf_counter()
        worst: dict[str, float] = {}

        flash_bound: list[str] = []

        def note(kernel, err):
            worst[kernel] = max(worst.get(kernel, 0.0), err)

        for dt in (torch.bfloat16, torch.float32):
            x = self.randn(ROWS + (D_MODEL,), 1300).to(dt)
            r = self.randn(ROWS + (D_MODEL,), 1301).to(dt)
            sc = (1.0 + 0.1 * self.randn((D_MODEL,), 1302)).to(dt)
            for res in (r, None):
                (y, h), (yw, hw) = (rmsnorm.rmsnorm_fwd(x, sc, res),
                                    rref.rmsnorm_ref(x, sc, res))
                what = f"{dt} {'with' if res is not None else 'no'} residual"
                note("rmsnorm", self.lm_check("rmsnorm", what, y, yw))
                note("rmsnorm", self.lm_check("rmsnorm", what + " h", h, hw))
            g = self.randn(ROWS + (D_FF,), 1310).to(dt)
            u = self.randn(ROWS + (D_FF,), 1311).to(dt)
            for act in ("silu", "gelu", "squared_relu"):
                note("swiglu", self.lm_check(
                    "swiglu", f"{dt} {act}", swiglu.swiglu_fwd(g, u, act=act),
                    sref.swiglu_ref(g, u, act=act)))
            for (b, h_, kv, s_), causals in (((1, 32, 32, 2048), (True,)),
                                             ((1, 40, 8, 1000),
                                              (True, False))):
                q = self.randn((b, h_, s_, 128), 1320).to(dt)
                k = self.randn((b, kv, s_, 128), 1321).to(dt)
                v = self.randn((b, kv, s_, 128), 1322).to(dt)
                for causal in causals:
                    what = f"{dt} {(b, h_, kv, s_)} causal={causal}"
                    got = flash.flash_attention_fwd(q, k, v, causal=causal)
                    again = flash.flash_attention_fwd(q, k, v, causal=causal)
                    err = self.lm_check("flash_attention", what, got,
                                        flash.flash_attention_plain(
                                            q, k, v, causal=causal))
                    note("flash_attention", err)
                    self.same_bits("flash_attention", what, {"o": got},
                                   {"o": again})
                    if dt == torch.bfloat16:
                        # P as hi + lo in bf16: |d| <= 2^-18 max|v| plus
                        # one bf16 step of o
                        top = max(float(got.float().abs().max()), 1e-30)
                        bound = (2.0 ** -18 * float(v.float().abs().max())
                                 + 2.0 ** (math.floor(math.log2(top)) - 7))
                        flash_bound.append(f"{(b, h_, kv, s_)} causal="
                                           f"{causal} {err:.3e} (bound "
                                           f"{bound:.3e})")
            b, h_, s_ = 8, 32, 8192
            lens = torch.tensor([0, 1, 17, 513, 4000, 8191, 8192, 8192],
                                dtype=torch.int32, device=self.dev)
            for d, kv_dt in itertools.product(
                    decode.HEAD_DIMS, (dt, torch.float32)
                    if dt == torch.bfloat16 else (dt,)):
                q = self.randn((b, h_, 1, d), 1330).to(dt)
                k = self.randn((b, h_, s_, d), 1331).to(kv_dt)
                v = self.randn((b, h_, s_, d), 1332).to(kv_dt)
                want = decode.flash_decode_plain(q, k, v, lens)
                first = None
                # the plan's split and every split: one set of bits
                for sp in (None,) + decode.SPLITS:
                    got = decode.flash_decode(q, k, v, lens, splits=sp)
                    what = f"D {d} q {dt} cache {kv_dt} splits {sp}"
                    note("flash_decode", self.lm_check("flash_decode", what,
                                                       got, want))
                    if not bool((got[0] == 0).all()):
                        raise PhaseError(f"flash_decode {what}: a length-0 "
                                         f"slot is not exactly zero")
                    first = got if first is None else first
                    self.same_bits("flash_decode", what, {"o": got},
                                   {"o": first})
                del k, v
        print(f"[11 lm kernels] against their plain versions in bf16 and "
              f"float32 (tol {LM_TOL}), TF32 off: rmsnorm and swiglu at "
              f"{ROWS} x {D_MODEL} / {D_FF} (with and without residual; "
              f"silu, gelu, squared_relu), flash attention at (1, 32, 2048, "
              f"128) causal and qwen2.5-14b's 40/8 heads at 1000, flash "
              f"decode at (8, 32, 8192, 112 and 128) with lengths 0, ragged "
              f"and full (a bf16 and a float32 cache under a bf16 query; "
              f"length 0 exactly zero) at its plan's split and at splits "
              f"{', '.join(map(str, decode.SPLITS))}, every split bit for bit "
              f"the plan's; max|d| "
              + " ".join(f"{k}={v:.2e}" for k, v in worst.items())
              + f"; {time.perf_counter() - t:.1f} s")
        print("[11 flash bf16] wgmma kernel, two launches bit for bit; "
              "max|d| against the plain version beside the bound of P as "
              "two bf16 terms (2^-18 max|v| + one bf16 step of o): "
              + "; ".join(flash_bound))

    def relative(self, got, want):
        want = want.float()
        return float((got.float() - want).abs().max()
                     / want.abs().max().clamp_min(1e-30))

    def forced_steps(self, server, prompts, tokens):
        """``server``'s logits per step, fed ``tokens`` (barrier's
        generations): the prefill's last logits, then each decode step."""
        torch = self.torch
        from repro_torch.models import lm
        with torch.inference_mode():
            cache, lo = server.prefill(prompts)
            out = [lo]
            for i in range(tokens.shape[1] - 1):
                tok = torch.as_tensor(tokens[:, i:i + 1], dtype=torch.int64,
                                      device=self.dev)
                lo, cache = lm.decode_step(server.params, cache, tok,
                                           server.cfg, server.rt)
                out.append(lo[:, 0])
        return out

    def teacher_forced(self, servers, prompts, tokens,
                       pairs=(("brainslug", "barrier"),), steps=None):
        """Per step, max|d logits| / max|logits| of ``servers[a]`` against
        ``servers[b]``, by pair ``(a, b)`` of ``pairs``, every server fed
        ``tokens`` (:meth:`forced_steps`); ``steps`` (a dict) receives each
        server's logits per step."""
        steps = {} if steps is None else steps
        for m, s in servers.items():
            steps[m] = self.forced_steps(s, prompts, tokens)
        return {(a, b): [self.relative(x, y) for x, y in zip(steps[a],
                                                             steps[b])]
                for a, b in pairs}

    def serve_pair(self, cfg, params, prompts, counters=None):
        """Greedy generations of both modes (barrier first), the counters
        of brainslug's run (``counters``, default :meth:`lm_counters`), and
        brainslug's ServeStats."""
        torch = self.torch
        from repro_torch.launch import serve
        servers = {m: serve.Server(serve.ServeConfig(
            arch=cfg.name, reduced=False, mode=m,
            max_len=SERVE["prompt_len"] + SERVE["new_tokens"] + 1, **SERVE),
            params=params, cfg=cfg) for m in ("barrier", "brainslug")}
        counters = counters or self.lm_counters
        gens = {"barrier": servers["barrier"].generate(prompts)}
        torch.cuda.synchronize()
        counters(zero=True)
        gens["brainslug"] = servers["brainslug"].generate(prompts)
        torch.cuda.synchronize()
        return servers, gens, counters()

    def phase12_serving(self):
        torch = self.torch
        import dataclasses

        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.layers import base
        from repro_torch.models import lm
        cfg = get_config("deepseek-7b")
        L = cfg.n_layers
        t = time.perf_counter()
        params = lm.init(0, cfg, device=self.dev)
        torch.cuda.synchronize()
        print(f"[12 model] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
              f"vocab {cfg.vocab_size}, {cfg.dtype}: "
              f"{base.param_count(params) / 1e9:.3f} B random parameters "
              f"(seed 0) on the card in {time.perf_counter() - t:.1f} s")
        self.lm_model = (cfg, params)
        self.lm_launches = {}

        # 12a: lm.prefill over (1, 2048) tokens
        g = torch.Generator(device=self.dev).manual_seed(1400)
        tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=g,
                               device=self.dev)
        self.lm_tokens = tokens
        with torch.inference_mode():
            want = lm.prefill(params, {"tokens": tokens}, cfg,
                              RuntimeConfig(mode="barrier"))
            torch.cuda.synchronize()
            self.lm_counters(zero=True)
            got = lm.prefill(params, {"tokens": tokens}, cfg,
                             RuntimeConfig(mode="brainslug"))
            torch.cuda.synchronize()
            counts = self.lm_counters()
        self.expect_counters("prefill", counts, {
            "rmsnorm": 2 * L + 1, "swiglu": L, "flash_attention": L,
            "flash_decode": 0})
        self.lm_launches["flash_attention"] = counts["flash_attention"]
        if tuple(got.shape) != (1, 1, cfg.vocab_size) or not bool(
                torch.isfinite(got).all()):
            raise PhaseError(f"prefill logits {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
        rel = self.relative(got, want)
        if not rel <= PATH_BF16_REL:
            raise PhaseError(f"prefill brainslug vs barrier: max|d|/max = "
                             f"{rel:.3e} > {PATH_BF16_REL}")
        print(f"[12a lm.prefill {PREFILL} bf16] brainslug vs barrier last-"
              f"position logits: max|d|/max|logits| = {rel:.3e} (tol "
              f"{PATH_BF16_REL}), argmax equal "
              f"{bool(got.argmax() == want.argmax())}; counters {counts}")

        # 12b: Server.generate, 4 requests, greedy
        prompts = np.random.default_rng(1401).integers(
            0, cfg.vocab_size, (SERVE["batch"], SERVE["prompt_len"])
        ).astype(np.int32)
        t = time.perf_counter()
        servers, gens, counts = self.serve_pair(cfg, params, prompts)
        steps = SERVE["prompt_len"] + SERVE["new_tokens"] - 1
        self.expect_counters("serving", counts, {
            "rmsnorm": steps * (2 * L + 1), "swiglu": steps * L,
            "flash_attention": 0, "flash_decode": steps * L})
        for k in ("rmsnorm", "swiglu", "flash_decode"):
            self.lm_launches[k] = counts[k]
        errs = self.teacher_forced(servers, prompts, gens["barrier"])[
            ("brainslug", "barrier")]
        agree = float((gens["brainslug"] == gens["barrier"]).mean())
        stats = servers["brainslug"].last_stats
        if not max(errs) <= PATH_BF16_REL:
            raise PhaseError(f"serving bf16: teacher-forced logits "
                             f"max|d|/max {max(errs):.3e} > {PATH_BF16_REL}")
        print(f"[12b Server.generate bf16] {SERVE['batch']} requests, prompt "
              f"{SERVE['prompt_len']}, {SERVE['new_tokens']} new tokens, "
              f"greedy: token agreement brainslug vs barrier {agree:.4f}; "
              f"logits teacher-forced on barrier's tokens, max|d|/max per "
              f"step: worst {max(errs):.3e}, median "
              f"{statistics.median(errs):.3e} (tol {PATH_BF16_REL}); "
              f"brainslug ServeStats generated {stats.generated_tokens}, "
              f"dispatches {stats.step_dispatches}, wall "
              f"{stats.wall_s:.3f} s; counters {counts}; "
              f"{time.perf_counter() - t:.1f} s")

        # 12c: float32, the same widths at 4 layers
        cfg32 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
        p32 = lm.init(1, cfg32, device=self.dev)
        servers, gens, counts = self.serve_pair(cfg32, p32, prompts)
        self.expect_counters("serving f32", counts, {
            "rmsnorm": steps * 9, "swiglu": steps * 4,
            "flash_attention": 0, "flash_decode": steps * 4})
        if not np.array_equal(gens["brainslug"], gens["barrier"]):
            raise PhaseError("serving f32: brainslug's tokens differ from "
                             "barrier's")
        errs = self.teacher_forced(servers, prompts, gens["barrier"])[
            ("brainslug", "barrier")]
        if not max(errs) <= PATH_F32_REL:
            raise PhaseError(f"serving f32: logits max|d|/max "
                             f"{max(errs):.3e} > {PATH_F32_REL}")
        print(f"[12c Server.generate float32, 4 layers] identical tokens; "
              f"logits max|d|/max per step worst {max(errs):.3e} (tol "
              f"{PATH_F32_REL}); counters {counts}")
        del servers, p32
        torch.cuda.empty_cache()

    def kernel_ms(self, fn, frag, reps=20):
        """Mean device duration of the launches whose name holds ``frag`` in
        a profiler trace of ``reps`` calls, and a note of how it was read.
        A mean over the launches held, so an event the profiler loses does
        not bias it.  A trace that holds none of them (the profiler can drop
        a whole trace's device events) is taken again, up to three times;
        without one, the event-timed :meth:`cuda_ms` per call stands in,
        and the note says so."""
        for _ in range(3):
            durs = [t1 - t0 for name, t0, t1 in self.device_spans(fn, reps)
                    if frag in name.lower()]
            if durs:
                return sum(durs) / len(durs) / 1e3, \
                    f"device, {len(durs)} of {reps} launches held"
        return self.cuda_ms(fn, reps), (f"events per call: 3 traces held no "
                                        f"{frag} launch")

    def complete_trace(self, fn, expect, tries=3, classify=None):
        """:meth:`trace` with the LM groups (or ``classify``'s), retried
        while the profiler loses launches; the last try is reported either
        way."""
        for _ in range(tries):
            out = self.trace(fn, expect, classify=classify or self.lm_group)
            if not out.startswith("incomplete"):
                return out
        return out

    def lm_group(self, low):
        for frag, group in (("rmsnorm_kernel", "rmsnorm"),
                            ("swiglu_kernel", "swiglu"),
                            ("flash_fwd_kernel", "flash_attention"),
                            ("paged_flash_decode_kernel",
                             "paged_flash_decode"),
                            ("flash_decode_kernel", "flash_decode")):
            if frag in low:
                return group
        if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
            return "matmul"
        return "other"

    def dense_plan_note(self, q, k, max_keys=None):
        """The dense decode kernel's launch plan at these operands."""
        from repro_torch.kernels.attention import decode
        plan = decode.dense_plan(q, k, max_keys)
        return (f"plan {plan.splits} CTAs a (slot, head) of {plan.chains} "
                f"chains, {plan.ctas} CTAs")

    def dense_decode_cases(self, qd, kd, vd, lens, rows):
        """Phase 13's dense decode beside its timing row, with no operand
        copied: the paged kernel on the same cache seen as a pool (bit for
        bit; its time and plan), and 4 slots of 101 keys in the same
        32768-key cache (the static Server's lock-step decode early in a
        long generation) at the plan of the cache's length and at the plan
        of the Server's bound (``max_keys``, bit for bit); each beside the
        dense kernel's time before its redesign.  Returns the notes for
        the kernels line."""
        torch = self.torch
        from repro_torch.kernels.attention import decode
        b, heads, sd, d = kd.shape
        bs = PAGED["block"]
        nb = sd // bs
        # head h of slot b as slot b * heads + h of one KV head, whose
        # blocks (b * heads + h) * nb + j are the cache's rows seen as a pool
        kp = kd.view(b * heads * nb, 1, bs, d)
        vp = vd.view(b * heads * nb, 1, bs, d)
        qp = qd.view(b * heads, 1, 1, d)
        table = torch.arange(b * heads * nb, dtype=torch.int32,
                             device=self.dev).view(b * heads, nb)
        lp = lens.repeat_interleave(heads)
        dense = decode.flash_decode(qd, kd, vd, lens)
        paged = decode.paged_flash_decode(qp, kp, vp, table, lp)
        torch.cuda.synchronize()
        if not torch.equal(dense, paged.view(dense.shape)):
            raise PhaseError(
                f"flash_decode at {tuple(kd.shape)}: differs from "
                f"paged_flash_decode on the cache seen as a pool (max|d| "
                f"{float((dense.float() - paged.view(dense.shape).float()).abs().max()):.3e})")
        pg_ms, _ = self.kernel_ms(lambda: decode.paged_flash_decode(
            qp, kp, vp, table, lp), "paged_flash_decode_kernel")
        k_ms, _, l_ms, b_ms, _, shape = rows["flash_decode"]
        print(f"  flash_decode {shape}: {self.dense_plan_note(qd, kd)}; "
              f"paged_flash_decode on the same cache seen as a pool of "
              f"{b * heads} one-head slots (block {bs}), bit for bit equal: "
              f"{pg_ms:.4f} ms, {self.paged_plan_note(qp, table, kp)}; "
              f"kernel/bound {k_ms / b_ms:.2f}, SDPA {l_ms:.4f} ms; before "
              f"the redesign {DENSE_PARENT_MS['long_128']} ms")
        del dense, paged, table
        # short slots in a long cache: the first 4 slots at 101 keys
        n_short = 101
        qs, ks, vs = qd[:4], kd[:4], vd[:4]
        ls = torch.full((4,), n_short, dtype=torch.int32, device=self.dev)
        at_s = decode.flash_decode(qs, ks, vs, ls)
        hinted = decode.flash_decode(qs, ks, vs, ls, max_keys=n_short)
        torch.cuda.synchronize()
        short = f"(4, {heads}, {sd}, {d}) bf16, lengths [{n_short}] x 4"
        if not torch.equal(at_s, hinted):
            raise PhaseError(f"flash_decode {short}: the plan of max_keys "
                             f"{n_short} changes the bits")
        s_ms, how = self.kernel_ms(lambda: decode.flash_decode(
            qs, ks, vs, ls), "flash_decode_kernel")
        h_ms, _ = self.kernel_ms(lambda: decode.flash_decode(
            qs, ks, vs, ls, max_keys=n_short), "flash_decode_kernel")
        sb_ms, sb_by = self.decode_bound(qs, ls)
        plan_s = self.dense_plan_note(qs, ks)
        plan_h = self.dense_plan_note(qs, ks, n_short)
        print(f"  flash_decode {short}: at the plan of S ({plan_s}) "
              f"{s_ms:.4f} ms ({how}); with the Server's bound max_keys "
              f"{n_short} ({plan_h}) {h_ms:.4f} ms, bit for bit equal; bound "
              f"{sb_ms:.4f} ms ({sb_by}); before the redesign "
              f"{DENSE_PARENT_MS['short_128']} ms")
        return {"plan": self.dense_plan_note(qd, kd),
                "paged_on_pooled_view_ms": pg_ms,
                "short_slots": {"shape": short, "ms": s_ms, "plan": plan_s,
                                "max_keys_ms": h_ms, "max_keys_plan": plan_h,
                                "bound_ms": sb_ms, "bound_by": sb_by}}

    def phase13_lm_timing(self):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.core.resource import H100
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.kernels.attention import decode, flash
        from repro_torch.kernels.rmsnorm import ref as rref
        from repro_torch.kernels.rmsnorm import rmsnorm
        from repro_torch.kernels.swiglu import ref as sref
        from repro_torch.kernels.swiglu import swiglu
        from repro_torch.models import lm
        bf = torch.bfloat16

        def nbytes(*ts):
            return sum(t.numel() * t.element_size() for t in ts)

        def bound(n_bytes, n_ops, peak):
            tb, to = n_bytes / H100.hbm_bandwidth * 1e3, n_ops / peak * 1e3
            return (tb, "bytes") if tb >= to else (to, "operations")

        x = self.randn(ROWS + (D_MODEL,), 1500).to(bf)
        r = self.randn(ROWS + (D_MODEL,), 1501).to(bf)
        sc = (1.0 + 0.1 * self.randn((D_MODEL,), 1502)).to(bf)
        gt = self.randn(ROWS + (D_FF,), 1503).to(bf)
        up = self.randn(ROWS + (D_FF,), 1504).to(bf)
        S = 4096
        q = self.randn((1, 32, S, 128), 1510).to(bf)
        k = self.randn((1, 32, S, 128), 1511).to(bf)
        v = self.randn((1, 32, S, 128), 1512).to(bf)
        S2 = PREFILL[1]                               # the prefill's length
        q2, k2, v2 = (t[:, :, :S2].contiguous() for t in (q, k, v))
        pairs2 = S2 * (S2 + 1) // 2
        B, Sd = 8, 32768
        qd = self.randn((B, 32, 1, 128), 1520).to(bf)
        kd = self.randn((B, 32, Sd, 128), 1521).to(bf)
        vd = self.randn((B, 32, Sd, 128), 1522).to(bf)
        g = torch.Generator(device=self.dev).manual_seed(1523)
        lens = torch.randint(Sd // 2, Sd + 1, (B,), generator=g,
                             device=self.dev, dtype=torch.int32)
        mask = (torch.arange(Sd, device=self.dev)[None, :]
                < lens[:, None])[:, None, None, :]
        valid_keys = int(lens.sum())
        pairs = S * (S + 1) // 2                      # causal (q, k) pairs
        y_rms = torch.empty_like(x)
        cases = [
            ("rmsnorm", f"{ROWS} x {D_MODEL} bf16, no residual",
             lambda: rmsnorm.rmsnorm_fwd(x, sc),
             lambda: rref.rmsnorm_ref(x, sc),
             lambda: F.rms_norm(x, (D_MODEL,), sc, 1e-6),
             bound(nbytes(x, sc, y_rms), 4 * x.numel(), H100.peak_flops_f32)),
            ("rmsnorm+residual", f"{ROWS} x {D_MODEL} bf16",
             lambda: rmsnorm.rmsnorm_fwd(x, sc, r),
             lambda: rref.rmsnorm_ref(x, sc, r), None,
             bound(nbytes(x, r, sc, x, x), 5 * x.numel(),
                   H100.peak_flops_f32)),
            ("swiglu", f"{ROWS} x {D_FF} bf16 silu",
             lambda: swiglu.swiglu_fwd(gt, up),
             lambda: sref.swiglu_ref(gt, up), None,
             bound(nbytes(gt, up, gt), 6 * gt.numel(), H100.peak_flops_f32)),
            ("flash_attention", f"(1, 32, {S}, 128) bf16 causal",
             lambda: flash.flash_attention_fwd(q, k, v, causal=True),
             lambda: flash.flash_attention_plain(q, k, v, causal=True),
             lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                    enable_gqa=True),
             bound(nbytes(q, k, v, q), 4 * 128 * 32 * pairs, PEAK_BF16)),
            ("flash_attention@prefill", f"(1, 32, {S2}, 128) bf16 causal",
             lambda: flash.flash_attention_fwd(q2, k2, v2, causal=True),
             lambda: flash.flash_attention_plain(q2, k2, v2, causal=True),
             lambda: F.scaled_dot_product_attention(q2, k2, v2,
                                                    is_causal=True,
                                                    enable_gqa=True),
             bound(nbytes(q2, k2, v2, q2), 4 * 128 * 32 * pairs2, PEAK_BF16)),
            ("flash_decode", f"({B}, 32, {Sd}, 128) bf16, lengths "
             f"{lens.tolist()}",
             lambda: decode.flash_decode(qd, kd, vd, lens),
             lambda: decode.flash_decode_plain(qd, kd, vd, lens),
             lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                    attn_mask=mask,
                                                    enable_gqa=True),
             bound(nbytes(qd, qd) + 2 * valid_keys * 32 * 128 * 2,
                   4 * 128 * 32 * valid_keys, PEAK_BF16)),
        ]
        print("[13 lm kernels] per launch: the kernel's device time (profiler, "
              "mean over its launches in a trace of 20 calls, with the count "
              "the trace held) and per call (CUDA events around 20 "
              "back-to-back calls, median of 5); the plain version (3 x 3 "
              "calls) and the library call per call (events); bound: each "
              "input read once, each output written once, or the operations "
              "at the type's peak:")
        frags = {"rmsnorm": "rmsnorm_kernel",
                 "rmsnorm+residual": "rmsnorm_kernel",
                 "swiglu": "swiglu_kernel",
                 "flash_attention": "flash_fwd_kernel",
                 "flash_attention@prefill": "flash_fwd_kernel",
                 "flash_decode": "flash_decode_kernel"}
        rows = {}
        with torch.inference_mode():
            for name, shape, run, plain, lib, (b_ms, b_by) in cases:
                k_ms, how = self.kernel_ms(run, frags[name])
                k_call = self.cuda_ms(run)
                p_ms = self.cuda_ms(plain, reps=3, groups=3, warmup=1)
                l_ms = self.cuda_ms(lib) if lib else None
                rows[name] = (k_ms, p_ms, l_ms, b_ms, b_by, shape)
                lib_s = f"{l_ms:.4f} ms" if l_ms is not None else "none"
                print(f"  {name} {shape}: kernel {k_ms:.4f} ms ({how}; "
                      f"{k_call:.4f} per call)  plain {p_ms:.4f} ms  library {lib_s}  bound "
                      f"{b_ms:.4f} ms ({b_by})  kernel/bound "
                      f"{k_ms / b_ms:.2f}")
            dense_notes = self.dense_decode_cases(qd, kd, vd, lens, rows)
        sources = {
            "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/"
                        "rmsnorm.py", "src/repro/kernels/rmsnorm/rmsnorm.py:33"),
            "swiglu": ("triton", "src/repro_torch/kernels/swiglu/swiglu.py",
                       "src/repro/kernels/swiglu/swiglu.py:29"),
            "flash_attention": ("cuda", "src/repro_torch/kernels/attention/"
                                "csrc/flash_attention.cu",
                                "src/repro/kernels/attention/flash.py:70"),
            "flash_decode": ("cuda", "src/repro_torch/kernels/attention/"
                             "csrc/flash_decode.cu",
                             "src/repro/kernels/attention/decode.py:182"),
        }
        for name, (route, src, rep) in sources.items():
            k_ms, p_ms, l_ms, b_ms, b_by, shape = rows[name]
            self.kernels[name] = {
                "name": name, "route": route, "source": src, "replaces": rep,
                "launches": self.lm_launches[name],
                "max_abs_err": self.err[name], "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
                "shape": shape}
        self.kernels["flash_decode"].update(dense_notes)
        k_ms, p_ms, l_ms, b_ms, _, shape = rows["flash_attention@prefill"]
        self.kernels["flash_attention"]["at_prefill"] = {
            "shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "library_ms": l_ms}
        del q, k, v, q2, k2, v2, qd, kd, vd, mask

        # the path: prefill and one decode step, per mode, in turns
        cfg, params = self.lm_model
        rts = {m: RuntimeConfig(mode=m) for m in ("barrier", "brainslug")}
        tokens = self.lm_tokens
        with torch.inference_mode():
            cache = lm.init_decode_cache(cfg, SERVE["batch"], 97,
                                         dtype=torch.float32, device=self.dev)
        tok = tokens[:, :SERVE["batch"]].reshape(SERVE["batch"], 1)
        pos = SERVE["prompt_len"]

        def prefill(m):
            return lm.prefill(params, {"tokens": tokens}, cfg, rts[m])

        def step(m):
            cache["blocks"]["sub0"].length.fill_(pos)
            return lm.decode_step(params, cache, tok, cfg, rts[m])

        with torch.inference_mode():
            pre = [(m, self.cuda_ms(lambda m=m: prefill(m), reps=1, groups=5))
                   for m in ("barrier", "brainslug", "brainslug", "barrier")]
            dec = [(m, self.cuda_ms(lambda m=m: step(m), reps=1, groups=20))
                   for m in ("barrier", "brainslug", "brainslug", "barrier")]
        print(f"[13 path] deepseek-7b bf16, 30 layers: lm.prefill {PREFILL}, "
              f"median of 5 (CUDA events), in turns: "
              + "  ".join(f"{m}={v:.3f} ms" for m, v in pre))
        print(f"[13 path] one decode step at batch {SERVE['batch']}, position "
              f"{pos} (float32 cache as Server builds it), median of 20, in "
              f"turns: " + "  ".join(f"{m}={v:.3f} ms" for m, v in dec))
        L = cfg.n_layers
        expect = {"prefill": {"flash_fwd_kernel": L, "rmsnorm_kernel": 2 * L + 1,
                              "swiglu_kernel": L},
                  "decode step": {"flash_decode_kernel": L,
                                  "rmsnorm_kernel": 2 * L + 1,
                                  "swiglu_kernel": L}}
        with torch.inference_mode():
            for what, fn in (("prefill", prefill), ("decode step", step)):
                for m in ("barrier", "brainslug"):
                    print(f"[13 trace {what} {m}] " + self.complete_trace(
                        lambda m=m: fn(m),
                        expect[what] if m == "brainslug" else None))
        print("[13 kernels] " + "  ".join(
            f"{k} max|d|={self.err[k]:.3e}" for k in sources))


    # -- the engine slice -----------------------------------------------------
    def paged_operands(self, dt, pool_dt, heads, kv_heads, seed,
                       lengths=None, bs=None, max_len=None, d=128):
        """Phase 14's operands: q, pools, a table that is a random
        permutation of the pool with the sentinel id N past each slot's
        blocks, and ragged lengths (by default one 0, one full) over a
        table of ``max_len // bs`` entries a slot."""
        torch = self.torch
        bs = bs or PAGED["block"]
        s_max = max_len or PAGED["max_len"]
        mb = s_max // bs
        if lengths is None:
            lengths = [0, 1, 17, 513, 4000, 8191, 20000, s_max][
                :PAGED["batch"]]
        b = len(lengths)
        lens = torch.tensor(lengths, dtype=torch.int32,
                            device=self.dev).clamp(max=s_max)
        n = int(((lens + bs - 1) // bs).sum()) + 8
        g = torch.Generator(device=self.dev).manual_seed(seed)
        perm = torch.randperm(n, generator=g, device=self.dev)
        table = torch.full((b, mb), n, dtype=torch.int32, device=self.dev)
        at = 0
        for i, ln in enumerate(lens.tolist()):
            used = -(-ln // bs)
            table[i, :used] = perm[at:at + used].int()
            at += used
        q = self.randn((b, heads, 1, d), seed + 1).to(dt)
        kp = self.randn((n, kv_heads, bs, d), seed + 2).to(pool_dt)
        vp = self.randn((n, kv_heads, bs, d), seed + 3).to(pool_dt)
        return q, kp, vp, table, lens

    def phase14_paged_kernel(self):
        torch = self.torch
        from repro_torch.kernels.attention import decode, ref
        t = time.perf_counter()
        lines = []
        for dt, pool_dt, heads, kv_heads in (
                (torch.bfloat16, torch.bfloat16, 32, 32),
                (torch.bfloat16, torch.float32, 32, 32),
                (torch.float32, torch.float32, 32, 32),
                (torch.bfloat16, torch.float32, 40, 8)):
            q, kp, vp, table, lens = self.paged_operands(
                dt, pool_dt, heads, kv_heads, 1700)
            got = decode.paged_flash_decode(q, kp, vp, table, lens)
            err = self.lm_check("paged_flash_decode",
                                f"q {dt} pool {pool_dt} {heads}/{kv_heads}",
                                got, decode.paged_flash_decode_plain(
                                    q, kp, vp, table, lens))
            if not bool((got[0] == 0).all()):
                raise PhaseError("paged_flash_decode: a length-0 slot is not "
                                 "exactly zero")
            clipped = table.clamp(0, kp.shape[0] - 1)
            dense = decode.flash_decode(q, ref.gather_paged(kp, clipped),
                                        ref.gather_paged(vp, clipped), lens)
            torch.cuda.synchronize()
            if not torch.equal(got, dense):
                raise PhaseError(
                    f"paged_flash_decode q {dt} pool {pool_dt}: differs from "
                    f"flash_decode on the gathered view (max|d| "
                    f"{float((got.float() - dense.float()).abs().max()):.3e})")
            lines.append(f"q {str(dt)[6:]} pool {str(pool_dt)[6:]} "
                         f"{heads}/{kv_heads} heads: max|d| {err:.2e}")
            del kp, vp, dense
        torch.cuda.empty_cache()
        print(f"[14 paged kernel] paged_flash_decode against its plain version "
              f"(tol {LM_TOL}) at ({PAGED['batch']}, heads, lengths "
              f"{lens.tolist()}, 128), block {PAGED['block']}, a shuffled "
              f"table with sentinel tails: " + "; ".join(lines)
              + "; length 0 exactly zero; bit for bit equal to flash_decode "
              f"on the gathered view; {time.perf_counter() - t:.1f} s")
        # where the launch plan splits widest, where chains and rows a block
        # differ, every slot full, and every split: bit for bit as above
        t = time.perf_counter()
        bf = torch.bfloat16
        full = PAGED["max_len"]
        lines = []
        for what, kw, splits in (
                ("one slot at 32768", dict(lengths=[full]), (None,)),
                ("block 8", dict(bs=8), (None,)),
                ("block 32", dict(bs=32), (None,)),
                ("all eight slots full", dict(lengths=[full] * 8), (None,)),
                ("every split", {}, decode.SPLITS),
                ("engine tick", dict(lengths=[101] * 4, max_len=256),
                 (None,) + decode.SPLITS)):
            q, kp, vp, table, lens = self.paged_operands(
                bf, bf, PAGED["heads"], PAGED["heads"], 1710, **kw)
            clipped = table.clamp(0, kp.shape[0] - 1)
            dense = decode.flash_decode(q, ref.gather_paged(kp, clipped),
                                        ref.gather_paged(vp, clipped), lens)
            for s in splits:
                got = decode.paged_flash_decode(q, kp, vp, table, lens,
                                                splits=s)
                torch.cuda.synchronize()
                if not torch.equal(got, dense):
                    raise PhaseError(
                        f"paged_flash_decode {what}, splits {s}: differs "
                        f"from flash_decode on the gathered view (max|d| "
                        f"{float((got.float() - dense.float()).abs().max()):.3e})")
            plan = decode.paged_plan(q, kp, table)
            lines.append(f"{what} (batch {q.shape[0]}, block {kp.shape[2]}, "
                         f"plan {plan.splits} CTAs a (slot, head)"
                         + (f"; splits {', '.join(str(x) for x in splits)}"
                            if len(splits) > 1 else "") + ")")
            del q, kp, vp, dense, clipped
            torch.cuda.empty_cache()
        print("[14 paged kernel] bf16, 32 heads, bit for bit equal to "
              "flash_decode on the gathered view: " + "; ".join(lines)
              + f"; {time.perf_counter() - t:.1f} s")

    def engine_queue(self, vocab):
        """12 requests from numpy seed 0: eight share a 64-token prefix with
        0-40-token tails, four have unrelated 16-96-token prompts;
        max_new_tokens 16-48, one 0, one sampled at temperature 0.8."""
        from repro_torch.launch.engine import Request
        rng = np.random.default_rng(0)
        common = rng.integers(1, vocab, 64).tolist()
        reqs = []
        for i in range(12):
            if i % 3 == 2:
                prompt = rng.integers(1, vocab,
                                      int(rng.integers(16, 97))).tolist()
            else:
                prompt = common + rng.integers(
                    1, vocab, int(rng.integers(0, 41))).tolist()
            reqs.append(Request(
                request_id=i, prompt=prompt,
                max_new_tokens=0 if i == 5 else int(rng.integers(16, 49)),
                temperature=0.8 if i == 7 else 0.0))
        return reqs

    def engine_run(self, cfg, params, layout, mode, reqs, verify="strict",
                   counters=None):
        """One ``Engine.run`` through ``Server.engine``; returns (engine,
        completions, launch counters of the run (``counters``, default
        :meth:`lm_counters`), wall seconds)."""
        torch = self.torch
        from repro_torch.launch import serve
        sc = serve.ServeConfig(arch=cfg.name, reduced=False, mode=mode,
                               batch=ENGINE["slots"],
                               max_len=ENGINE["max_len"],
                               torch_device=self.dev.type)
        eng = serve.Server(sc, params=params, cfg=cfg).engine(
            slots=ENGINE["slots"], prefill_chunk=ENGINE["prefill_chunk"],
            kv_layout=layout, kv_block_size=ENGINE["kv_block_size"],
            kv_num_blocks=ENGINE["kv_num_blocks"], verify_mode=verify)
        counters = counters or self.lm_counters
        torch.cuda.synchronize()
        counters(zero=True)
        t = time.perf_counter()
        comps = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = counters()
        if any(c.status != "ok" for c in comps):
            raise PhaseError(f"engine {layout} {mode}: statuses "
                             f"{[c.status for c in comps]}")
        for r, c in zip(reqs, comps):
            if len(c.tokens) != r.max_new_tokens:
                raise PhaseError(f"engine {layout} {mode}: request "
                                 f"{r.request_id} got {len(c.tokens)} of "
                                 f"{r.max_new_tokens} tokens")
        alloc = eng.last_allocator
        if alloc is not None and (alloc.n_free != alloc.num_blocks
                                  or alloc.stored):
            raise PhaseError(f"engine {layout} {mode}: {alloc.in_use} blocks "
                             f"still in use after the run")
        return eng, comps, counts, wall

    def engine_model(self):
        """Phase 12's model cut to ENGINE_LAYERS: its config and the first
        layers' slices of the stacked parameters (views, no copy)."""
        import dataclasses
        from repro_torch.layers import base
        cfg, params = self.lm_model
        blocks = base.tree_map(lambda a: a[:ENGINE_LAYERS],
                               params["blocks"])
        return (dataclasses.replace(cfg, n_layers=ENGINE_LAYERS),
                {**params, "blocks": blocks})

    @staticmethod
    def evaluations(stats):
        """Model evaluations of a run: every lane of every evaluation is
        one slot-unit of prefill, decode or idle work."""
        return (stats.prefill_tokens + stats.decode_slot_steps
                + stats.idle_slot_steps) // stats.n_slots

    def forced_logits(self, cfg, params, mode, seqs, starts):
        """Teacher forcing through the paged layout: ``seqs`` (token lists)
        rolled through ``lm.decode_step`` position by position in one
        batch, each slot on its own blocks; per position, the float32
        logits of the slots whose position lies in [start - 1, len - 1)
        (the positions whose logits chose a generated token)."""
        torch = self.torch
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.models import lm
        bs = ENGINE["kv_block_size"]
        b, longest = len(seqs), max(len(x) for x in seqs)
        mb = -(-longest // bs)
        rt = RuntimeConfig(mode=mode, kv_layout="paged", kv_block_size=bs)
        out = []
        with torch.inference_mode():
            cache = lm.init_decode_cache(
                cfg, b, longest, dtype=torch.float32, kv_layout="paged",
                kv_num_blocks=b * mb, kv_block_size=bs, device=self.dev)
            table = torch.arange(b * mb, dtype=torch.int32,
                                 device=self.dev).reshape(b, mb)
            toks = torch.zeros((b, longest), dtype=torch.int64,
                               device=self.dev)
            for i, x in enumerate(seqs):
                toks[i, :len(x)] = torch.tensor(x, device=self.dev)
            lens = [len(x) for x in seqs]
            for t in range(longest - 1):
                active = torch.tensor([t < n for n in lens], device=self.dev)
                logits, cache = lm.decode_step(params, cache,
                                               toks[:, t:t + 1], cfg, rt,
                                               active, block_tables=table)
                keep = [i for i in range(b) if starts[i] - 1 <= t < lens[i] - 1]
                if keep:
                    out.append(logits[keep, 0].float())
        return out

    def engine_float32(self, cfg32, p32, reqs, tag, counters=None):
        """The three ENGINE_RUNS of ``reqs`` at float32: identical greedy
        tokens in all three, and the paged brainslug engine equal to the
        static ``Server.generate`` on four equal-length prompts."""
        from repro_torch.launch import serve
        from repro_torch.launch.engine import Request
        greedy = [i for i, r in enumerate(reqs) if r.temperature <= 0.0]
        toks = {}
        for layout, mode in ENGINE_RUNS:
            _, comps, _, _ = self.engine_run(cfg32, p32, layout, mode, reqs,
                                             counters=counters)
            toks[(layout, mode)] = comps
        base = toks[ENGINE_RUNS[0]]
        for run, comps in toks.items():
            for i in greedy:
                if not np.array_equal(comps[i].tokens, base[i].tokens):
                    raise PhaseError(f"engine f32: {run} differs from "
                                     f"{ENGINE_RUNS[0]} on request {i}")
        # against the static Server on four equal-length prompts
        four = [list(reqs[i].prompt[:16]) for i in (2, 5, 8, 11)]
        new = 16
        static = serve.Server(serve.ServeConfig(
            arch=cfg32.name, reduced=False, mode="brainslug", batch=4,
            prompt_len=16, new_tokens=new, max_len=ENGINE["max_len"],
            torch_device=self.dev.type),
            params=p32, cfg=cfg32)
        want = static.generate(np.asarray(four, np.int32))
        _, comps, _, _ = self.engine_run(
            cfg32, p32, "paged", "brainslug",
            [Request(request_id=i, prompt=x, max_new_tokens=new)
             for i, x in enumerate(four)], counters=counters)
        for i, c in enumerate(comps):
            if not np.array_equal(c.tokens, want[i]):
                raise PhaseError(f"engine f32 vs static Server: request {i} "
                                 f"differs")
        print(f"[{tag} engine float32, {cfg32.n_layers} layers] identical "
              f"greedy tokens in the three runs; the paged brainslug engine "
              f"equals the static Server.generate on 4 prompts of 16 tokens "
              f"x {new} new")

    def phase15_engine(self):
        torch = self.torch
        import dataclasses
        from repro_torch.models import lm
        cfg, params = self.engine_model()
        L = cfg.n_layers
        reqs = self.engine_queue(cfg.vocab_size)
        t = time.perf_counter()
        self.engine_results = {}
        for layout, mode in ENGINE_RUNS:
            eng, comps, counts, wall = self.engine_run(cfg, params, layout,
                                                       mode, reqs)
            self.engine_results[(layout, mode)] = (eng, comps, wall)
            if mode != "brainslug":
                continue
            e = self.evaluations(eng.last_stats)
            paged = layout == "paged"
            self.expect_counters(f"engine {layout} {mode}", counts, {
                "rmsnorm": (2 * L + 1) * e, "swiglu": L * e,
                "flash_attention": 0, "flash_decode": 0 if paged else L * e,
                "paged_flash_decode": L * e if paged else 0})
            if paged:
                self.lm_launches["paged_flash_decode"] = counts[
                    "paged_flash_decode"]
                per_eval = {k: counts[k] / e for k in (
                    "paged_flash_decode", "rmsnorm", "swiglu")}
        greedy = [i for i, r in enumerate(reqs) if r.temperature <= 0.0]
        pb = self.engine_results[("paged", "brainslug")][1]
        db = self.engine_results[("dense", "brainslug")][1]
        pr = self.engine_results[("paged", "barrier")][1]
        for i in greedy:
            if not np.array_equal(pb[i].tokens, db[i].tokens):
                raise PhaseError(f"engine: paged and dense brainslug differ on "
                                 f"greedy request {i}")
        sampled_same = all(np.array_equal(pb[i].tokens, db[i].tokens)
                           for i in range(len(reqs)))
        n_tok = sum(len(pr[i].tokens) for i in greedy)
        agree = sum(int((pb[i].tokens == pr[i].tokens).sum())
                    for i in greedy) / max(n_tok, 1)
        # teacher-forced logits on barrier's tokens, four greedy requests
        pick = [i for i in greedy if reqs[i].max_new_tokens > 0][:4]
        seqs = [list(reqs[i].prompt) + pr[i].tokens.tolist() for i in pick]
        starts = [len(reqs[i].prompt) for i in pick]
        forced = {m: self.forced_logits(cfg, params, m, seqs, starts)
                  for m in ("brainslug", "barrier")}
        errs = [self.relative(a, b) for a, b in zip(forced["brainslug"],
                                                   forced["barrier"])]
        if not max(errs) <= PATH_BF16_REL:
            raise PhaseError(f"engine bf16: teacher-forced logits max|d|/max "
                             f"{max(errs):.3e} > {PATH_BF16_REL}")
        st = self.engine_results[("paged", "brainslug")][0].last_stats
        print(f"[15 engine] {cfg.name} {cfg.dtype}, {L} layers, Engine(slots "
              f"{ENGINE['slots']}, max_len {ENGINE['max_len']}, prefill_chunk "
              f"{ENGINE['prefill_chunk']}, paged blocks {ENGINE['kv_num_blocks']}"
              f" x {ENGINE['kv_block_size']}, verify strict), 12 requests "
              f"(8 share a 64-token prefix; one max_new_tokens 0, one "
              f"temperature 0.8): every request completed in all three runs "
              f"({', '.join(f'{l} {m}' for l, m in ENGINE_RUNS)}), no kv.* "
              f"finding, the free list whole after each; paged brainslug per "
              f"model evaluation: "
              + " ".join(f"{k} {v:g}" for k, v in per_eval.items())
              + f", plain and ref 0 ({self.evaluations(st)} evaluations); "
              f"paged == dense brainslug greedy tokens: identical (sampled "
              f"request too: {sampled_same}); vs paged barrier token "
              f"agreement {agree:.4f}, teacher-forced logits max|d|/max worst "
              f"{max(errs):.3e}, median {statistics.median(errs):.3e} (tol "
              f"{PATH_BF16_REL}); prefix hits {st.prefix_hit_tokens} tokens, "
              f"cow forks {st.cow_forks}, peak blocks {st.blocks_in_use}; "
              f"{time.perf_counter() - t:.1f} s")

        # float32 at 4 layers: identical greedy tokens everywhere
        cfg32 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
        p32 = lm.init(1, cfg32, device=self.dev)
        self.engine_float32(cfg32, p32, reqs, "15")
        del p32
        torch.cuda.empty_cache()

    def paged_bound(self, q, lens, kv_heads=None):
        """The paged kernel's bound: :meth:`decode_bound` with the table
        entries the keys use."""
        return self.decode_bound(q, lens, PAGED["block"], kv_heads)

    def decode_bound(self, q, lens, block=None, kv_heads=None):
        """A decode kernel's bound on bf16 operands: q read and o written,
        the valid keys' K and V rows of the ``kv_heads`` KV heads (by
        default one a query head), the table entries they use (paged,
        ``block`` rows a block) and the lengths, over HBM; or its operations
        (a multiply-add a K and a V element a query head) over the bf16
        tensor-core rate, whichever is larger."""
        from repro_torch.core.resource import H100
        heads, d = q.shape[1], q.shape[3]
        kv_heads = kv_heads or heads
        valid = int(lens.sum())
        used = int(((lens + block - 1) // block).sum()) if block else 0
        n_bytes = (2 * q.numel() * 2 + 2 * valid * kv_heads * d * 2
                   + used * 4 + lens.numel() * 4)
        t_bytes = n_bytes / H100.hbm_bandwidth * 1e3
        t_ops = 4 * d * heads * valid / PEAK_BF16 * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    def paged_plan_note(self, q, table, kp):
        """The paged kernel's launch plan at these operands, as a phrase."""
        from repro_torch.kernels.attention import decode
        plan = decode.paged_plan(q, kp, table)
        return (f"plan {plan.splits} CTAs a (slot, head) of {plan.chains} "
                f"chains, {plan.ctas} CTAs")

    def phase16_engine_timing(self):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.core.resource import H100
        from repro_torch.kernels.attention import decode, ref
        bf = torch.bfloat16
        heads = PAGED["heads"]
        q, kp, vp, table, lens = self.paged_operands(bf, bf, heads, heads,
                                                     1700)
        q32, kp32, vp32, _, _ = self.paged_operands(bf, torch.float32, heads,
                                                    heads, 1700)
        clipped = table.clamp(0, kp.shape[0] - 1)
        kd, vd = ref.gather_paged(kp, clipped), ref.gather_paged(vp, clipped)
        s_max = kd.shape[2]
        mask = (torch.arange(s_max, device=self.dev)[None, :]
                < lens[:, None])[:, None, None, :]
        b_ms, b_by = self.paged_bound(q, lens)
        with torch.inference_mode():
            run = lambda: decode.paged_flash_decode(q, kp, vp, table, lens)  # noqa: E731
            k_ms, how = self.kernel_ms(run, "paged_flash_decode_kernel")
            k_call = self.cuda_ms(run)
            k32_ms, _ = self.kernel_ms(
                lambda: decode.paged_flash_decode(q32, kp32, vp32, table,
                                                  lens),
                "paged_flash_decode_kernel")
            d_ms, _ = self.kernel_ms(
                lambda: decode.flash_decode(q, kd, vd, lens),
                "flash_decode_kernel")
            p_ms = self.cuda_ms(lambda: decode.paged_flash_decode_plain(
                q, kp, vp, table, lens), reps=1, groups=3, warmup=1)
            sdpa_ms = self.cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kd, vd, attn_mask=mask))
        shape = (f"({PAGED['batch']}, {heads}, lengths {lens.tolist()}, 128) "
                 f"bf16, block {PAGED['block']}")
        print(f"[16 paged kernel] {shape}: kernel {k_ms:.4f} ms ({how}; "
              f"{k_call:.4f} per call); over "
              f"a float32 pool {k32_ms:.4f} ms; dense flash_decode on the "
              f"gathered view {d_ms:.4f} ms (paging costs "
              f"{100 * (k_ms / d_ms - 1):+.1f}%); plain {p_ms:.4f} ms; "
              f"library none (SDPA on the gathered view, a note: "
              f"{sdpa_ms:.4f} ms); bound {b_ms:.4f} ms ({b_by}), kernel/bound "
              f"{k_ms / b_ms:.2f}; " + self.paged_plan_note(q, table, kp)
              + f"; before the redesign {PAGED_PARENT_MS['table']} ms")
        # the dense kernel on the gathered view: the paged kernel's bits
        dense = decode.flash_decode(q, kd, vd, lens)
        paged = decode.paged_flash_decode(q, kp, vp, table, lens)
        torch.cuda.synchronize()
        if not torch.equal(dense, paged):
            raise PhaseError(
                f"flash_decode {shape}: differs from paged_flash_decode on "
                f"the gathered view (max|d| "
                f"{float((dense.float() - paged.float()).abs().max()):.3e})")
        db_ms, db_by = self.decode_bound(q, lens)
        print(f"[16 flash_decode] ({PAGED['batch']}, {heads}, lengths "
              f"{lens.tolist()}, 128) bf16 on the gathered view, bit for bit "
              f"equal to paged_flash_decode: kernel {d_ms:.4f} ms, "
              f"{self.dense_plan_note(q, kd)}; bound {db_ms:.4f} ms "
              f"({db_by}), kernel/bound {d_ms / db_ms:.2f}; SDPA "
              f"{sdpa_ms:.4f} ms; paged {k_ms:.4f} ms; before the redesign "
              f"{DENSE_PARENT_MS['ragged_128']} ms")
        self.kernels["flash_decode"]["ragged"] = {
            "shape": f"({PAGED['batch']}, {heads}, lengths "
                     f"{lens.tolist()}, 128) bf16", "ms": d_ms,
            "bound_ms": db_ms, "bound_by": db_by, "library_ms": sdpa_ms,
            "paged_ms": k_ms, "plan": self.dense_plan_note(q, kd)}
        del dense, paged
        self.kernels["paged_flash_decode"] = {
            "name": "paged_flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/attention/csrc/"
                      "paged_flash_decode.cu",
            "replaces": "src/repro/kernels/attention/decode.py:116",
            "launches": self.lm_launches["paged_flash_decode"],
            "max_abs_err": self.err["paged_flash_decode"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": shape}
        del q, kp, vp, q32, kp32, vp32, kd, vd, mask
        torch.cuda.empty_cache()
        # where the plan splits widest, and the engine tick (launch-bound)
        for what, kw in (("one_slot_32768", dict(lengths=[PAGED["max_len"]])),
                         ("tick", dict(lengths=[101] * 4, max_len=256))):
            q, kp, vp, table, lens = self.paged_operands(bf, bf, heads, heads,
                                                         1700, **kw)
            with torch.inference_mode():
                ms, how = self.kernel_ms(
                    lambda: decode.paged_flash_decode(q, kp, vp, table, lens),
                    "paged_flash_decode_kernel")
            t_ms, t_by = self.paged_bound(q, lens)
            print(f"[16 paged kernel] {what} (batch {q.shape[0]}, lengths "
                  f"{lens.tolist()}, a table of {table.shape[1]} blocks): "
                  f"kernel {ms:.4f} ms ({how}); bound {t_ms:.4f} ms ({t_by}),"
                  f" kernel/bound {ms / t_ms:.2f}; "
                  + self.paged_plan_note(q, table, kp)
                  + f"; before the redesign {PAGED_PARENT_MS[what]} ms")
            del q, kp, vp
        torch.cuda.empty_cache()

        # the bf16 rows chains of phase 3: device time beside the plain
        # version and the bound
        for name, (program, inputs, params, tile, out) in \
                self.rows_bf16.items():
            from repro_torch.kernels.fused_stack import ref as fref
            from repro_torch.kernels.fused_stack import rows
            nb = sum(t.numel() * t.element_size() for t in
                     [*inputs.values(), *params.values(), *out.values()])
            run = lambda: rows.fused_rows(  # noqa: E731
                program, inputs, params, tile_rows=tile)
            r_ms, _ = self.device_ms(run)
            alt = PROGRAMS_ALT[rows.PROGRAMS_PER_SM]
            a_ms = self.at_programs_per_sm(run, alt)
            rp_ms, _ = self.device_ms(lambda: fref.fused_stack_ref(
                program, inputs, params))
            rb_ms = nb / H100.hbm_bandwidth * 1e3
            print(f"[16 rows bf16] {name} {ROWS} x "
                  f"{next(iter(inputs.values())).shape[-1]} tile_rows={tile}: "
                  f"kernel {r_ms:.4f} ms device ({rows.PROGRAMS_PER_SM} "
                  f"programs an SM, at {alt}: {a_ms:.4f} ms), plain "
                  f"{rp_ms:.4f} ms, bound "
                  f"{rb_ms:.4f} ms (bytes), kernel/bound {r_ms / rb_ms:.2f}")

        # the engine's runs of phase 15
        for (layout, mode), (eng, comps, wall) in self.engine_results.items():
            st = eng.last_stats
            print(f"[16 engine {layout} {mode}] wall {wall:.3f} s, "
                  f"{st.generated_tokens} tokens ({st.generated_tokens / wall:.2f}"
                  f" tok/s), TTFT p50 {st.ttft_p50_ms:.1f} ms p99 "
                  f"{st.ttft_p99_ms:.1f} ms, latency p50 "
                  f"{st.p50_latency_ms:.1f} ms p99 {st.p99_latency_ms:.1f} ms; "
                  f"ServeStats {json.dumps(st.as_dict())}")

        # one decode-only tick per run: four slots decoding at position 100
        cfg, params = self.engine_model()
        L = cfg.n_layers
        bs = ENGINE["kv_block_size"]
        slots = ENGINE["slots"]
        per = ENGINE["kv_num_blocks"] // slots
        tables = np.arange(slots * per, dtype=np.int32).reshape(slots, per)
        tables = np.pad(tables, ((0, 0), (0, ENGINE["max_len"] // bs - per)))
        tokens = np.zeros((slots, ENGINE["prefill_chunk"]), np.int32)
        tokens[:, 0] = np.arange(1, slots + 1)
        ones = np.ones(slots, np.int32)
        for layout, mode in ENGINE_RUNS:
            eng = self.engine_results[(layout, mode)][0]
            cache = eng._new_cache()
            paged = layout == "paged"

            def tick(eng=eng, cache=cache, paged=paged):
                with torch.inference_mode():
                    cache["blocks"]["sub0"].length.fill_(100)
                    return eng._step(cache, tables if paged else None,
                                     tokens, ones, np.arange(slots),
                                     np.zeros(slots, np.int32),
                                     np.zeros(slots, np.float32), 0)

            ms = self.cuda_ms(tick, reps=1, groups=10)
            expect = None
            if mode == "brainslug":
                expect = {"rmsnorm_kernel": 2 * L + 1, "swiglu_kernel": L,
                          ("paged_flash_decode_kernel" if paged
                           else "flash_decode_kernel"): L}
            print(f"[16 trace decode tick {layout} {mode}] {ms:.3f} ms a tick "
                  f"(median of 10, CUDA events); "
                  + self.complete_trace(tick, expect))
            del cache
        print("[16 kernels] paged_flash_decode max|d|="
              f"{self.err['paged_flash_decode']:.3e}  fused_rows bf16 max|d|="
              f"{self.err['fused_rows_bf16']:.3e}")


    # -- the LM training slice ------------------------------------------------
    def release_serving(self):
        """Phases 17-19 train at full width: drop what phases 2-16 hold
        (the 30-layer serving model among it)."""
        import gc
        for name in ("lm_model", "engine_results", "train_nets", "train_data",
                     "vgg_params", "rows_bf16"):
            setattr(self, name, None)
        self.vgg_stages = []
        gc.collect()
        self.torch.cuda.empty_cache()

    def ce_operands(self, t, d, v, dt, seed):
        """h (t, d), w (d, v) scaled as a head, int32 labels with about a
        tenth at -1 and the first row block (the kernel's 128 rows) fully
        masked."""
        torch = self.torch
        from repro_torch.kernels.vocab_ce import ce
        h = self.randn((t, d), seed).to(dt)
        w = (self.randn((d, v), seed + 1) / d ** 0.5).to(dt)
        g = torch.Generator(device=self.dev).manual_seed(seed + 2)
        labels = torch.randint(0, v, (t,), generator=g, device=self.dev,
                               dtype=torch.int32)
        drop = torch.rand((t,), generator=g, device=self.dev) < 0.1
        labels = torch.where(drop, -1, labels)
        labels[:ce.BLOCK_ROWS] = -1
        return h, w, labels

    def phase17_ce_kernel(self):
        torch = self.torch
        from repro_torch.kernels.vocab_ce import ce, ops, ref
        self.release_serving()
        t = time.perf_counter()
        lines = []
        for (tt, d, v), dt in ((CE_SHAPE, torch.bfloat16),
                               (CE_SHAPE, torch.float32),
                               (CE_RAGGED, torch.float32),
                               (CE_RAGGED, torch.bfloat16),
                               (CE_ODD_D, torch.bfloat16)):
            h, w, labels = self.ce_operands(tt, d, v, dt, 1700 + d % 97)
            lse, gold = ce.fused_ce_fwd(h, w, labels)
            lse2, gold2 = ce.fused_ce_fwd(h, w, labels)
            want_lse, want_gold = ref.ce_ref(h, w, labels)
            top = float((h.float() @ w.float()).abs().max())
            torch.cuda.synchronize()
            what = f"fused_ce {(tt, d, v)} {str(dt).split('.')[-1]}"
            if not (bool(torch.isfinite(lse).all())
                    and bool(torch.isfinite(gold).all())):
                raise PhaseError(f"{what}: non-finite output")
            tol = 1e-4 * max(1.0, top)
            err = max(float((lse - want_lse).abs().max()),
                      float((gold - want_gold).abs().max()))
            self.err["fused_ce"] = max(self.err["fused_ce"], err)
            if not err <= tol:
                raise PhaseError(f"{what}: max|d| {err:.3e} > {tol:.3e}")
            if not (torch.equal(lse, lse2) and torch.equal(gold, gold2)):
                raise PhaseError(f"{what}: two launches differ")
            if bool((gold[labels < 0] != 0).any()):
                raise PhaseError(f"{what}: a masked row's gold is not 0")
            if dt == torch.bfloat16:       # the tensor-core instance
                how = (f"wgmma, {ce.tc_split_plan(tt, v, self.sm_count)} "
                       f"splits" + "".join(
                           f", {n} staged to pitch {p}" for n, x in
                           (("h", h), ("w", w))
                           for p in [ce.staged(x)[1]] if p != x.shape[1]))
            else:
                how = f"CUDA cores, {ce.split_plan(tt, v, self.sm_count)} " \
                      f"splits"
            lines.append(f"{(tt, d, v)} {str(dt).split('.')[-1]} ({how}): "
                         f"max|d| {err:.2e} (tol {tol:.2e})")
            del h, w, lse, gold, lse2, gold2, want_lse, want_gold
        torch.cuda.empty_cache()

        # fused_nll at T = 0 and with every label masked: exactly 0
        h, w, labels = self.ce_operands(300, 512, 1000, torch.bfloat16, 1760)
        zero_t = float(ops.fused_nll(h[:0], w, labels[:0]))
        masked = float(ops.fused_nll(h, w, torch.full_like(labels, -1)))
        if zero_t != 0.0 or masked != 0.0:
            raise PhaseError(f"fused_nll: T=0 gives {zero_t}, fully masked "
                             f"{masked}, not 0")

        # gradients against autograd of the plain nll
        tt, d, v = CE_GRAD_ROWS, CE_SHAPE[1], CE_SHAPE[2]
        h, w, labels = self.ce_operands(tt, d, v, torch.bfloat16, 1770)
        with torch.enable_grad():
            hs = [x.clone().requires_grad_() for x in (h, w)]
            nll = ops.fused_nll(hs[0], hs[1], labels)
            got = dict(zip(("dh", "dw"), torch.autograd.grad(nll, hs)))
            rs = [x.clone().requires_grad_() for x in (h, w)]
            nll_r = ref.nll_ref(rs[0], rs[1], labels)
            want = dict(zip(("dh", "dw"), torch.autograd.grad(nll_r, rs)))
        nll, nll_r = float(nll.detach()), float(nll_r.detach())
        if abs(nll - nll_r) > 1e-4 * abs(nll_r):
            raise PhaseError(f"fused_nll {nll} vs nll_ref "
                             f"{nll_r}")
        grad_err = self.check_bwd("fused_ce_bwd",
                                  f"fused_nll grads {(tt, d, v)}",
                                  got, want, reduced={"dh", "dw"},
                                  tol=LM_TOL["bfloat16"])
        del h, w, hs, rs, got, want
        torch.cuda.empty_cache()
        print(f"[17 fused_ce] against the plain version (ce_ref), TF32 off, "
              f"labels a tenth and the first 128 rows masked, tol 1e-4 x "
              f"max(1, max|logits|), two launches bit for bit: "
              + "; ".join(lines)
              + f"; fused_nll at T=0 {zero_t} and fully masked {masked}; "
              f"fused_nll gradients at ({tt}, {d}, {v}) bf16 against autograd "
              f"of nll_ref (tol {LM_TOL['bfloat16']} x max|g|): max|d| "
              f"{grad_err}; {time.perf_counter() - t:.1f} s")

    def lm_train_counts(self, zero=False):
        """Launch counts of the kernels on the LM training path and the
        plain dispatches of their wrappers (``zero`` sets them to 0)."""
        from repro_torch.kernels.attention import flash
        from repro_torch.kernels.rmsnorm import ops as rops
        from repro_torch.kernels.rmsnorm import rmsnorm
        from repro_torch.kernels.swiglu import ops as sops
        from repro_torch.kernels.swiglu import swiglu
        from repro_torch.kernels.vocab_ce import ce
        from repro_torch.kernels.vocab_ce import ops as cops
        fns = {"fused_ce": ce.fused_ce_fwd, "rmsnorm": rmsnorm.rmsnorm_fwd,
               "swiglu": swiglu.swiglu_fwd,
               "flash_attention": flash.flash_attention_fwd}
        stats = (cops.STATS, rops.STATS, sops.STATS)
        if zero:
            for fn in fns.values():
                fn.launches = 0
            for st in stats:
                st.reset()
        out = {k: fn.launches for k, fn in fns.items()}
        out["plain"] = sum(st.counts["plain"] for st in stats)
        return out

    def lm_trainer(self, mode, layers, dtype, arch="deepseek-7b",
                   init_dtype=None, loss_chunk=0, **tc_kw):
        """``build_trainer`` of ``arch`` at full width cut to ``layers``,
        one 4096-token sequence, lr 3e-4 constant, weights from seed 0
        (drawn in ``init_dtype`` when given, then cast to ``dtype``);
        ``loss_chunk`` > 0 steps with ``RuntimeConfig.fused_loss_chunk``
        set to it (the plain loss's logits in chunks of that many
        positions)."""
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.launch import steps as steps_mod
        from repro_torch.launch import train as train_mod
        from repro_torch.models import lm
        from repro_torch.optim import adamw
        tc = train_mod.TrainerConfig(
            arch=arch, reduced=False, steps=TRAIN_LM["steps"],
            mode=mode, batch_override=1, seq_override=TRAIN_LM["seq"],
            config_overrides=(("n_layers", layers), ("dtype", dtype)),
            device="cuda", log_every=10 ** 9, **tc_kw)
        def init(cfg, dev):
            if init_dtype is None:
                return lm.init(0, cfg, device=dev)
            import dataclasses
            from repro_torch.layers import base
            drawn = lm.init(0, dataclasses.replace(cfg, dtype=init_dtype),
                            device=dev)
            return base.cast_tree(drawn, lm.DTYPES[dtype])

        opt_cfg = adamw.AdamWConfig(lr=TRAIN_LM["lr"])
        trainer = train_mod.build_trainer(tc, init_params=init,
                                          opt_cfg=opt_cfg)
        if loss_chunk:
            trainer.step_fn = steps_mod.make_train_step(
                trainer.cfg, RuntimeConfig(mode=mode, remat=tc.remat,
                                           fused_loss_chunk=loss_chunk),
                opt_cfg)
        return trainer

    def train_lm(self, mode, layers, dtype, failure=None, counters=None,
                 **tc_kw):
        """Train through ``Trainer.run``; the counters (``counters``,
        default :meth:`lm_train_counts`) are zeroed just before the run and
        read around each step.  Returns (history, per-step counters, peak
        GiB, wall s)."""
        torch = self.torch
        import gc
        counters = counters or self.lm_train_counts
        torch.cuda.reset_peak_memory_stats()
        trainer = self.lm_trainer(mode, layers, dtype, **tc_kw)
        per_step = []
        inner = trainer.step_fn

        def counted(params, opt_state, batch):
            torch.cuda.synchronize()
            before = counters()
            out = inner(params, opt_state, batch)
            torch.cuda.synchronize()
            after = counters()
            per_step.append({k: after[k] - before[k] for k in after})
            return out

        trainer.step_fn = counted
        counters(zero=True)
        t = time.perf_counter()
        try:
            history = trainer.run(failure)
        finally:
            if trainer.checkpointer is not None:
                trainer.checkpointer.close()
            wall = time.perf_counter() - t
            del trainer
            gc.collect()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.empty_cache()
        return history, per_step, peak, wall

    def expect_train_counts(self, what, per_step, mode, layers):
        want = ({"fused_ce": 1, "rmsnorm": 2 * layers + 1, "swiglu": layers,
                 "flash_attention": layers, "plain": 0}
                if mode == "brainslug" else
                {"fused_ce": 0, "rmsnorm": 0, "swiglu": 0,
                 "flash_attention": 0, "plain": 0})
        for i, got in enumerate(per_step):
            if got != want:
                raise PhaseError(f"{what} step {i + 1}: counters {got}, "
                                 f"expected {want}")

    def lm_step1_grads(self, mode, layers, dtype, names=None, loss_chunk=0,
                       **kw):
        """Step-1 gradients of the trainer's loss: ``lm.loss_fn`` on the
        seed-0 weights and the first batch, ``torch.autograd.grad`` over
        every leaf (what ``make_train_step`` hands AdamW); with ``names``,
        those top-level leaves' gradients alone, by name (``kw``: the
        trainer's, as :meth:`lm_trainer` takes)."""
        torch = self.torch
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.data import pipeline
        from repro_torch.layers import base
        from repro_torch.models import lm
        trainer = self.lm_trainer(mode, layers, dtype, **kw)
        params, cfg = trainer.params, trainer.cfg
        batch = {k: torch.from_numpy(x).to(self.dev) for k, x in
                 pipeline.synth_batch(cfg, trainer.shape, 0, 0).items()}
        del trainer
        rt = RuntimeConfig(mode=mode, fused_loss_chunk=loss_chunk)
        with torch.enable_grad():
            live = base.tree_map(lambda p: p.detach().requires_grad_(),
                                 params)
            loss, _ = lm.loss_fn(live, batch, cfg, rt)
            if names is not None:
                return dict(zip(names, torch.autograd.grad(
                    loss, [live[n] for n in names])))
            grads = torch.autograd.grad(loss, base.tree_leaves(live))
        return grads

    def train_controls(self, layers, losses, gnorms):
        """Two defective ``barrier`` runs against the sound one, held to
        phase 18a's limits, which must flag each of them: attention scores
        and softmax in bf16 (a lower-precision control), and one layer's
        attention output dropped (a wrong forward)."""
        torch = self.torch
        from repro_torch.layers import attention
        full, apply = attention._full_attention, attention.apply

        def bf16_scores(q, k, v, causal):
            b, h, sq, hd = q.shape
            g, sk = k.shape[1], k.shape[2]
            s = torch.einsum("bgrqd,bgkd->bgrqk",
                             q.reshape(b, g, h // g, sq, hd), k) * (
                                 1.0 / hd ** 0.5)
            if causal:
                keep = torch.ones((sq, sk), dtype=torch.bool,
                                  device=q.device).tril(diagonal=sk - sq)
                s = s.masked_fill(~keep, -1e30)
            o = torch.einsum("bgrqk,bgkd->bgrqd", torch.softmax(s, -1), v)
            return o.reshape(b, h, sq, hd)

        calls = [0]

        def drop_one(params, x, cfg, rt, **kw):
            calls[0] += 1
            out = apply(params, x, cfg, rt, **kw)
            return out * 0.0 if calls[0] % cfg.n_layers == 4 else out

        lines = []
        for name, fa, ap in (("bf16 attention scores", bf16_scores, apply),
                             ("layer 4's attention dropped", full, drop_one)):
            attention._full_attention, attention.apply = fa, ap
            try:
                hist = self.train_lm("barrier", layers, "bfloat16")[0]
            finally:
                attention._full_attention, attention.apply = full, apply
            gl = [abs(h["loss"] - b) / abs(b) for h, b in zip(hist, losses)]
            gg = [abs(h["grad_norm"] - b) / abs(b)
                  for h, b in zip(hist, gnorms)]
            flagged = [f"step-{i + 1} loss" for i, (g, lim) in enumerate(
                zip(gl, TRAIN_BF16_LOSS_REL)) if g > lim] + [
                f"step-{i + 1} grad_norm" for i, g in enumerate(gg)
                if g > TRAIN_BF16_GNORM_REL]
            if not flagged:
                raise PhaseError(f"train bf16 control ({name}): within every "
                                 f"limit of 18a (loss gaps {gl}, grad_norm "
                                 f"gaps {gg})")
            lines.append(f"{name}: loss gaps "
                         f"{[f'{g:.3e}' for g in gl]}, grad_norm gaps "
                         f"{[f'{g:.3e}' for g in gg]}, flagged by "
                         f"{', '.join(flagged)}")
        print("[18a controls] barrier bf16 against the sound barrier run, "
              "relative: " + "; ".join(lines))

    def phase18_train(self):
        torch = self.torch
        import shutil
        import tempfile
        from repro_torch.distributed import fault_tolerance as ft
        t = time.perf_counter()
        L, L32 = TRAIN_LM["layers"], TRAIN_LM["layers_f32"]
        runs = {}
        for mode in ("brainslug", "barrier"):
            hist, per_step, peak, wall = self.train_lm(mode, L, "bfloat16")
            self.expect_train_counts(f"train bf16 {mode}", per_step, mode, L)
            runs[mode] = (hist, per_step, peak, wall)
        self.ce_launches = sum(s["fused_ce"] for s in runs["brainslug"][1])
        sb = runs["brainslug"][1]
        losses = {m: [h["loss"] for h in r[0]] for m, r in runs.items()}
        gnorms = {m: [h["grad_norm"] for h in r[0]] for m, r in runs.items()}
        if not all(math.isfinite(x) for t in (losses, gnorms)
                   for v in t.values() for x in v):
            raise PhaseError(f"train bf16: losses {losses}, grad norms "
                             f"{gnorms}")
        gaps = {}
        for what, vals, limits in (
                ("loss", losses, TRAIN_BF16_LOSS_REL),
                ("grad_norm", gnorms,
                 (TRAIN_BF16_GNORM_REL,) * TRAIN_LM["steps"])):
            gaps[what] = [abs(a - b) / abs(b) for a, b in
                          zip(vals["brainslug"], vals["barrier"])]
            for i, (gap, lim) in enumerate(zip(gaps[what], limits)):
                if not gap <= lim:
                    raise PhaseError(
                        f"train bf16: step-{i + 1} {what} brainslug "
                        f"{vals['brainslug'][i]} vs barrier "
                        f"{vals['barrier'][i]} ({gap:.3e} > {lim})")
        print(f"[18a train bf16] deepseek-7b, d_model 4096, 32 heads, d_ff "
              f"11008, vocab 102400, {L} of 30 layers, bf16, 1 x "
              f"{TRAIN_LM['seq']} tokens, {TRAIN_LM['steps']} AdamW steps lr "
              f"{TRAIN_LM['lr']} through build_trainer / Trainer.run: "
              + "; ".join(
                  f"{m} losses {losses[m]} grad_norm {gnorms[m]} peak "
                  f"{runs[m][2]:.2f} GiB wall {runs[m][3]:.1f} s"
                  for m in runs)
              + f"; relative gaps per step: loss "
              f"{[f'{g:.3e}' for g in gaps['loss']]} (tol "
              f"{TRAIN_BF16_LOSS_REL}), grad_norm "
              f"{[f'{g:.3e}' for g in gaps['grad_norm']]} (tol "
              f"{TRAIN_BF16_GNORM_REL}); brainslug counters per step "
              f"{sb[0]}")
        self.train_controls(L, losses["barrier"], gnorms["barrier"])

        # float32 at 2 layers: losses and step-1 gradients
        runs32 = {}
        for mode in ("brainslug", "barrier"):
            hist, per_step, peak, wall = self.train_lm(mode, L32, "float32")
            self.expect_train_counts(f"train f32 {mode}", per_step, mode, L32)
            runs32[mode] = (hist, peak, wall)
        l32 = {m: [h["loss"] for h in r[0]] for m, r in runs32.items()}
        for a, b in zip(l32["brainslug"], l32["barrier"]):
            if not math.isfinite(a) or abs(a - b) > TRAIN_RTOL * abs(b):
                raise PhaseError(f"train f32: losses {l32}")
        g_r = self.lm_step1_grads("barrier", L32, "float32")
        g_b = self.lm_step1_grads("brainslug", L32, "float32")
        worst = 0.0
        for i, (gb, gr) in enumerate(zip(g_b, g_r)):
            d = (gb - gr).abs()
            scale = float(gr.abs().max())
            worst = max(worst, float(d.max()) / max(scale, 1e-30))
            if not bool(torch.isfinite(gb).all()) or not bool(
                    (d <= TRAIN_RTOL * (gr.abs() + scale)).all()):
                raise PhaseError(f"train f32: step-1 gradient of leaf {i} "
                                 f"max|d| {float(d.max()):.3e} (max|g| "
                                 f"{scale:.3e})")
        del g_b, g_r
        torch.cuda.empty_cache()
        print(f"[18b train f32] the same widths at {L32} layers, float32: "
              f"losses brainslug {l32['brainslug']} barrier {l32['barrier']}"
              f" (tol {TRAIN_RTOL} relative); step-1 gradients max|d|/max|g| "
              f"{worst:.2e} (tol rtol {TRAIN_RTOL}, atol {TRAIN_RTOL} x "
              f"max|g|); peak {runs32['brainslug'][1]:.2f} / "
              f"{runs32['barrier'][1]:.2f} GiB")

        # kill at step 2, resume from the step-1 checkpoint
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
            free = shutil.disk_usage(d).free / 2 ** 30
            try:
                self.train_lm("brainslug", L32, "float32",
                              failure=ft.failure_injector({2}), ckpt_dir=d,
                              ckpt_every=1)
            except ft.SimulatedFailure:
                pass
            else:
                raise PhaseError("kill/resume: the injected failure at step 2 "
                                 "did not happen")
            # the resumed run writes only its final checkpoint (15 GB at
            # 2 float32 layers with AdamW's moments)
            resumed, _, _, wall = self.train_lm(
                "brainslug", L32, "float32", ckpt_dir=d,
                ckpt_every=TRAIN_LM["steps"])
        full = runs32["brainslug"][0]
        if [h["step"] for h in resumed] != [2] or \
                resumed[-1]["loss"] != full[-1]["loss"]:
            raise PhaseError(f"kill/resume: resumed {resumed}, uninterrupted "
                             f"step 3 loss {full[-1]['loss']}")
        print(f"[18c kill/resume] f32 {L32} layers brainslug: killed at step "
              f"2, resumed from the step-1 checkpoint ({free:.0f} GiB free in "
              f"the temp dir): step-3 loss {resumed[-1]['loss']} equals the "
              f"uninterrupted run's bit for bit; resume run {wall:.1f} s; "
              f"phase {time.perf_counter() - t:.1f} s")

    def train_group(self, low):
        for frag, group in (("ce_split_kernel", "fused_ce"),
                            ("ce_tc_kernel", "fused_ce"),
                            ("ce_merge_kernel", "fused_ce"),
                            ("flash_fwd_kernel", "flash_attention"),
                            ("rmsnorm_kernel", "rmsnorm"),
                            ("swiglu_kernel", "swiglu")):
            if frag in low:
                return group
        return None

    def train_trace(self, fn, classify=None):
        """One call of ``fn`` under the profiler: device time by group and
        the idle share of the traced window.  Kernels of the port's named
        ranges (``TRAIN_RANGES``: the CE chunked backward, the attention
        backward's recompute, the SSD backward's recompute, AdamW) are found
        through the chrome trace's ``External id`` (kernel -> launching op)
        and the op's thread and time inside the range; the port's kernels by
        name (``classify``, default :meth:`train_group`); the rest are
        matmuls or other."""
        classify = classify or self.train_group
        torch = self.torch
        import os
        import tempfile
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(SPIN_KERNELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and "spin_kernel" not in e.get("name", "")]
        if not kernels:
            return "not measured (the profiler recorded no device events)"
        ops = {}
        for e in events:
            ext = (e.get("args") or {}).get("External id")
            if e.get("cat") == "cpu_op" and ext is not None:
                ops[ext] = e
        ranges = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") in TRAIN_RANGES]

        def in_range(k):
            op = ops.get((k.get("args") or {}).get("External id"))
            if op is None:
                return None
            for r in ranges:
                if (r.get("tid") == op.get("tid") and r["ts"] <= op["ts"]
                        <= r["ts"] + r.get("dur", 0)):
                    return TRAIN_RANGES[r["name"]]
            return None

        groups: dict[str, float] = {}
        attributed = 0
        for k in kernels:
            low = k["name"].lower()
            g = classify(low)
            if g is None:
                g = in_range(k)
                attributed += g is not None
            if g is None:
                g = ("matmul" if any(x in low for x in (
                    "gemm", "gemv", "nvjet", "xmma", "cutlass")) else "other")
            groups[g] = groups.get(g, 0.0) + k.get("dur", 0.0) / 1e3
        spans = sorted((k["ts"], k["ts"] + k.get("dur", 0.0)) for k in kernels)
        busy, end = 0.0, spans[0][0]
        for t0, t1 in spans:
            if t1 > end:
                busy += t1 - max(t0, end)
                end = t1
        window = max(t1 for _, t1 in spans) - spans[0][0]
        parts = "  ".join(f"{g}={v:.3f} ms" for g, v in sorted(
            groups.items()))
        note = ("" if ranges else "; the named ranges were not recorded, "
                "their kernels count as matmul / other")
        return (f"device {busy / 1e3:.3f} ms busy of a {window / 1e3:.3f} ms "
                f"window (idle {100 * (1 - busy / window):.1f}%); by group: "
                f"{parts}; {len(kernels)} kernels, {attributed} attributed to "
                f"a named range{note}")

    def phase19_train_timing(self):
        torch = self.torch
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.core.resource import H100
        from repro_torch.data import pipeline
        from repro_torch.kernels.vocab_ce import ce, ref
        from repro_torch.launch import steps as steps_mod
        from repro_torch.optim import adamw
        tt, d, v = CE_SHAPE
        h, w, labels = self.ce_operands(tt, d, v, torch.bfloat16, 1900)
        run = lambda: ce.fused_ce_fwd(h, w, labels)  # noqa: E731
        safe = torch.clamp_min(labels, 0).long()[:, None]

        def two_calls():
            logits = h.float() @ w.float()
            return torch.logsumexp(logits, -1), logits.gather(-1, safe)

        def two_calls_bf16():
            # cuBLAS in bf16 with float32 accumulation, then float32
            logits = (h @ w).float()
            return torch.logsumexp(logits, -1), logits.gather(-1, safe)

        # the profiler may drop some of these long kernels' events: its
        # time stands only when the trace holds every launch
        spans = [sp for sp in self.device_spans(run, reps=5)
                 if self.train_group(sp[0].lower()) == "fused_ce"]
        k_call = self.cuda_ms(run, reps=2, groups=3, warmup=1)
        if len(spans) == 2 * 5:                 # split + merge per call
            k_ms, how = sum(t1 - t0 for _, t0, t1 in spans) / 5 / 1e3, \
                "device, mean of 5"
        else:
            k_ms, how = k_call, (f"events; the trace held {len(spans)} of "
                                 f"the 10 kernel launches")
        p_ms = self.cuda_ms(lambda: ref.ce_ref(h, w, labels), reps=2,
                            groups=3, warmup=1)
        two_ms = self.cuda_ms(two_calls, reps=2, groups=3, warmup=1)
        two_bf16_ms = self.cuda_ms(two_calls_bf16, reps=2, groups=3,
                                   warmup=1)
        n_split = ce.tc_split_plan(tt, v, self.sm_count)
        w_gb = 2 * d * v / 1e9
        w_model = w_stream_model(tt, d, v, n_split, self.sm_count) / 1e9
        n_ops = 2 * tt * d * v
        n_bytes = (h.numel() + w.numel()) * 2 + labels.numel() * 4 + 2 * tt * 4
        t_ops, t_bytes = n_ops / PEAK_BF16 * 1e3, \
            n_bytes / H100.hbm_bandwidth * 1e3
        b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (
            t_bytes, "bytes")
        shape = f"({tt}, {d}, {v}) bf16"
        print(f"[19 fused_ce] {shape}: kernel {k_ms:.3f} ms (wgmma, "
              f"{n_split} splits, split + merge, {how}; {k_call:.3f} per "
              f"call, events) = {n_ops / k_ms / 1e9:.1f} TFLOP/s; plain "
              f"(ce_ref) {p_ms:.3f} ms; two calls (no single PyTorch call "
              f"computes the function): bf16 (h @ w with float32 "
              f"accumulation, then logsumexp and a gather in float32) "
              f"{two_bf16_ms:.3f} ms, float32 (h.float() @ w.float(), then "
              f"the same) {two_ms:.3f} ms; bound {b_ms:.3f} ms ({b_by}: "
              f"{n_ops:.3e} operations at {PEAK_BF16 / 1e12:.0f} TFLOP/s; "
              f"bytes alone {t_bytes:.3f} ms), kernel/bound "
              f"{k_ms / b_ms:.2f}; ptxas {self.ce_ptxas}")
        print(f"[19 fused_ce] w ({w_gb:.3f} GB) from device memory as the "
              f"launch order implies, a model, not a reading (CTAs in "
              f"windows of {self.sm_count}, each split's columns read once a "
              f"window that holds its row tiles): {w_model:.3f} GB")
        self.kernels["fused_ce"] = {
            "name": "fused_ce", "route": "cuda",
            "source": "src/repro_torch/kernels/vocab_ce/csrc/fused_ce.cu",
            "replaces": "src/repro/kernels/vocab_ce/ce.py:78",
            "launches": self.ce_launches, "max_abs_err": self.err["fused_ce"],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "two_call_bf16_ms": two_bf16_ms,
            "two_call_f32_ms": two_ms, "shape": shape,
            "ptxas": self.ce_ptxas}
        del h, w, labels, safe
        torch.cuda.empty_cache()

        # the ragged head: w staged to a pitch of a multiple of 8 inside
        # each call, the copy counted
        tt, d, v = CE_RAGGED
        h, w, labels = self.ce_operands(tt, d, v, torch.bfloat16, 1910)
        r_ms = self.cuda_ms(lambda: ce.fused_ce_fwd(h, w, labels), reps=3,
                            groups=3, warmup=1)
        stage_ms = self.cuda_ms(lambda: ce.staged(w), reps=3, groups=3,
                                warmup=1)
        r_bound = 2 * tt * d * v / PEAK_BF16 * 1e3
        print(f"[19 fused_ce] ragged {CE_RAGGED} bf16, w staged to pitch "
              f"{ce.staged(w)[1]} in each call: {r_ms:.3f} ms a call "
              f"(events; the staging copy alone {stage_ms:.3f} ms), bound "
              f"{r_bound:.3f} ms (operations), kernel/bound "
              f"{r_ms / r_bound:.2f}")
        self.kernels["fused_ce"]["ragged_ms"] = r_ms
        del h, w, labels
        torch.cuda.empty_cache()

        # the 8-layer bf16 step per mode, in turns, on one model and state
        L = TRAIN_LM["layers"]
        trainer = self.lm_trainer("brainslug", L, "bfloat16")
        opt_cfg = adamw.AdamWConfig(lr=TRAIN_LM["lr"])
        fns = {m: steps_mod.make_train_step(trainer.cfg,
                                            RuntimeConfig(mode=m), opt_cfg)
               for m in ("barrier", "brainslug")}
        batch = {k: torch.from_numpy(x).to(self.dev) for k, x in
                 pipeline.synth_batch(trainer.cfg, trainer.shape, 0,
                                      0).items()}

        def step(m):
            trainer.params, trainer.opt_state, _ = fns[m](
                trainer.params, trainer.opt_state, batch)

        def timed(m):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(m)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            return statistics.median(times)

        for m in fns:
            step(m)                                     # warm-up
        turns = [(m, timed(m)) for m in ("barrier", "brainslug", "brainslug",
                                         "barrier")]
        print(f"[19 train step] deepseek-7b {L} layers bf16, 1 x "
              f"{TRAIN_LM['seq']} tokens, forward + backward + AdamW, median "
              f"of 3 after a warm-up (host clock around synchronised steps), "
              f"in turns: " + "  ".join(f"{m}={ms:.1f} ms" for m, ms in turns))
        for m in ("barrier", "brainslug"):
            print(f"[19 trace train step {m}] "
                  + self.train_trace(lambda m=m: step(m)))
        del trainer, fns, batch
        torch.cuda.empty_cache()
        print("[19 kernels] fused_ce max|d|="
              f"{self.err['fused_ce']:.3e}  fused_rows_bwd bf16 max|d|="
              f"{self.err['fused_rows_bwd_bf16']:.3e}")

    # -- the SSM slice --------------------------------------------------------
    def ssd_operands(self, shape, seed, decay):
        """dtx (b,h,nc,L,P), a (b,h,nc,L,1), B and C (b,nc,L,N), float32.
        ``a`` is the within-chunk cumulative sum of per-step decays drawn in
        [-decay, -decay/10]; ``decay=None`` takes -2 every step (dt |A| = 2),
        so a_i - a_j reaches 126 above the diagonal, past float32 ``exp``'s
        88."""
        torch = self.torch
        b, h, nc, L, p, n = shape
        g = torch.Generator(device=self.dev).manual_seed(seed)
        dtx = torch.randn((b, h, nc, L, p), generator=g, device=self.dev)
        if decay is None:
            steps = torch.full((b, h, nc, L, 1), -2.0, device=self.dev)
        else:
            steps = -decay * (0.1 + 0.9 * torch.rand(
                (b, h, nc, L, 1), generator=g, device=self.dev))
        a = torch.cumsum(steps, dim=3)
        Bm = torch.randn((b, nc, L, n), generator=g, device=self.dev)
        Cm = torch.randn((b, nc, L, n), generator=g, device=self.dev)
        return dtx, a, Bm, Cm

    def ssd_check(self, what, got, want, key="ssd_intra_chunk"):
        """Finite outputs (dicts by name) within SSD_TOL x max(1,
        max|want|), the largest max|d| kept under ``key`` (the kernel
        against its plain version, or ``ssd_ops`` for the mixer against
        the plain chunked path); returns the worst max|d| / max(1,
        max|want|)."""
        torch = self.torch
        torch.cuda.synchronize()
        worst = 0.0
        for name, g, w in ((k, got[k], want[k]) for k in want):
            if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                raise PhaseError(f"ssd_intra_chunk {what}: {name} "
                                 f"{tuple(g.shape)} vs {tuple(w.shape)}, "
                                 f"finite {bool(torch.isfinite(g).all())}")
            scale = max(1.0, float(w.abs().max()))
            err = float((g - w).abs().max())
            self.err[key] = max(self.err[key], err)
            worst = max(worst, err / scale)
            if not err <= SSD_TOL * scale:
                raise PhaseError(f"ssd_intra_chunk {what}: {name} max|d| "
                                 f"{err:.3e} > {SSD_TOL} x {scale:.3e}")
        return worst

    def phase20_ssd_kernel(self):
        torch = self.torch
        from repro_torch.core.resource import H100
        from repro_torch.kernels.ssd import chunked, ops, ssd
        t = time.perf_counter()
        b, h, nc, L, p, n = SSD_SHAPE
        lines = []
        for what, decay, seed, shape_ in (
                ("prefill shape, decays up to 0.5 a step", 0.5, 2000,
                 SSD_SHAPE),
                ("overflowing decays, dt |A| = 2 a step", None, 2001,
                 SSD_SHAPE),
                ("training shape (20 heads a CTA)", 0.5, 2003,
                 SSD_TRAIN_SHAPE),
                ("padded tiles (2, 3, 3, 50, 9), N 5", 0.5, 2004,
                 (2, 3, 3, 50, 9, 5))):
            dtx, a, Bm, Cm = self.ssd_operands(shape_, seed, decay)
            span = float((a[..., 0, 0] - a[..., -1, 0]).max())
            got = ssd.ssd_intra_chunk(dtx, a, Bm, Cm)
            again = ssd.ssd_intra_chunk(dtx, a, Bm, Cm)
            want = ssd.ssd_intra_chunk_ref(dtx, a, Bm, Cm)
            rel = self.ssd_check(what, dict(zip("yS", got)),
                                 dict(zip("yS", want)))
            if not (torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])):
                raise PhaseError(f"ssd_intra_chunk {what}: two launches "
                                 f"differ")
            if decay is None and not span > 88:
                raise PhaseError(f"ssd_intra_chunk {what}: a_i - a_j reaches "
                                 f"only {span:.1f}")
            lines.append(f"{what} (a_i - a_j up to {span:.1f} above the "
                         f"diagonal): max|d|/max(1, max|ref|) {rel:.3e}, two "
                         f"launches bit for bit")
        # ops.ssd over a sequence that is not whole chunks, against the
        # plain chunked path; its backward on overflowing decays
        bb, s = SSD_RAGGED
        g = torch.Generator(device=self.dev).manual_seed(2002)
        x = torch.randn((bb, s, h, p), generator=g, device=self.dev)
        dt = 0.1 * torch.rand((bb, s, h), generator=g, device=self.dev)
        A = -1.0 - 15.0 * torch.rand((h,), generator=g, device=self.dev)
        Bs = torch.randn((bb, s, n), generator=g, device=self.dev)
        Cs = torch.randn((bb, s, n), generator=g, device=self.dev)
        D = torch.ones((h,), device=self.dev)
        before = ssd.ssd_intra_chunk.launches
        y = ops.ssd(x, dt, A, Bs, Cs, D, L)
        if ssd.ssd_intra_chunk.launches != before + 1:
            raise PhaseError("ops.ssd did not launch the kernel")
        y_ref = chunked.ssd_chunked(x, dt, A, Bs, Cs, D, chunk=L)
        rel = self.ssd_check(f"ops.ssd ({bb}, {s})", {"y": y}, {"y": y_ref},
                             key="ssd_ops")
        lines.append(f"ops.ssd at batch {bb} x {s} tokens (padded to "
                     f"{-(-s // L) * L}) vs ssd_chunked: max|d|/max(1, "
                     f"max|ref|) {rel:.3e}")
        leaves = [t_.detach()[:, :128].clone().requires_grad_()
                  if t_.dim() > 1 else t_.detach().clone().requires_grad_()
                  for t_ in (x, torch.full_like(dt, 2.0), -torch.ones_like(A),
                             Bs, Cs, D)]
        with torch.enable_grad():
            yo = ops.ssd(*leaves, L)
            grads = torch.autograd.grad(yo.float().square().sum(), leaves)
        if not all(bool(torch.isfinite(gr).all()) for gr in grads) or not \
                bool(torch.isfinite(yo).all()):
            raise PhaseError("ops.ssd: non-finite output or gradient on "
                             "overflowing decays")
        lines.append("ops.ssd gradients on overflowing decays (dt 2, A -1, "
                     "128 tokens): finite")
        del x, dt, Bs, Cs, y, y_ref, leaves, grads, yo

        # time, bounds, plain version and launch plan, at the prefill and
        # training shapes
        print(f"[20 ssd_intra_chunk] " + "; ".join(lines)
              + f" (tol {SSD_TOL} x max(1, max|ref|))")
        lib = ssd._library()
        entries = {}
        for label, shape_ in (("prefill", SSD_SHAPE), ("training",
                                                       SSD_TRAIN_SHAPE)):
            b, h, nc, L, p, n = shape_
            dtx, a, Bm, Cm = self.ssd_operands(shape_, 2000, 0.5)
            run = lambda: ssd.ssd_intra_chunk(dtx, a, Bm, Cm)  # noqa: E731
            k_ms, how = self.kernel_ms(run, "ssd_intra_chunk_kernel")
            k_call = self.cuda_ms(run)
            p_ms = self.cuda_ms(lambda: ssd.ssd_intra_chunk_ref(dtx, a, Bm,
                                                                Cm))
            per_sm = ssd._ctas_per_sm(lib, L, n, p)
            plan = ssd.launch_plan(b, h, nc, self.sm_count, per_sm)
            cells = b * h * nc
            # FMAs: G over the causal lower triangle (with its diagonal; the
            # rest of the tile is exactly 0) once a (batch, chunk), as the
            # kernel computes it (G does not depend on the head), Y over
            # the triangle and the state over L a cell; the old count took
            # G a cell
            tri = L * (L + 1) // 2
            n_ops = 2 * (tri * n * b * nc + (tri * p + n * L * p) * cells)
            n_ops_cell = 2 * (tri * (n + p) + n * L * p) * cells
            n_bytes = 4 * (dtx.numel() + a.numel() + Bm.numel() + Cm.numel()
                           + dtx.numel() + cells * n * p)
            t_ops = n_ops / H100.peak_flops_f32 * 1e3
            t_f32 = n_ops_cell / H100.peak_flops_f32 * 1e3
            t_bytes = n_bytes / H100.hbm_bandwidth * 1e3
            b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (
                t_bytes, "bytes")
            shape = f"({b}, {h}, {nc}, {L}, {p}), N {n}, float32"
            print(f"[20 ssd_intra_chunk time] {label} {shape}: kernel "
                  f"{k_ms:.4f} ms ({how}; {k_call:.4f} per call, events) = "
                  f"{n_ops / k_ms / 1e9:.1f} TFLOP/s of the causal work; "
                  f"plain (ssd_intra_chunk_ref) {p_ms:.4f} ms; library none "
                  f"(no single PyTorch call computes the masked chain); "
                  f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB at "
                  f"{H100.hbm_bandwidth / 1e12:.2f} TB/s = {t_bytes:.4f} ms; "
                  f"{n_ops:.3e} float32 operations, G once a chunk, at "
                  f"{H100.peak_flops_f32 / 1e12:.0f} TFLOP/s = {t_ops:.4f} "
                  f"ms), kernel/bound {k_ms / b_ms:.2f}; the old bound "
                  f"({n_ops_cell:.3e} float32 operations, G a cell) "
                  f"{t_f32:.4f} ms, kernel/that {k_ms / t_f32:.2f}; launch "
                  f"plan "
                  f"{plan.heads_per_cta} heads a CTA, {plan.groups} groups, "
                  f"{plan.ctas} CTAs, {per_sm} an SM x {self.sm_count} SMs, "
                  f"{plan.waves} wave(s); {self.smi}")
            entries[label] = (k_ms, p_ms, b_ms, b_by, t_f32, shape, plan)
            del dtx, a, Bm, Cm
        print(f"[20 ssd_intra_chunk] phase {time.perf_counter() - t:.1f} s")
        k_ms, p_ms, b_ms, b_by, t_f32, shape, plan = entries["prefill"]
        self.kernels["ssd_intra_chunk"] = {
            "name": "ssd_intra_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/ssd/csrc/ssd_intra_chunk.cu",
            "replaces": "src/repro/kernels/ssd/ssd.py:50",
            "launches": None, "max_abs_err": self.err["ssd_intra_chunk"],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": shape,
            "old_bound_ms": t_f32,
            "heads_per_cta": plan.heads_per_cta,
            "training_ms": entries["training"][0],
            "registers": self.ssd_ptxas}
        torch.cuda.empty_cache()

    def ssm_counters(self, zero=False):
        """Launch counts of the kernels on the mamba path (SSD, rmsnorm,
        the rows kernel of the gated norm and its backward) and the plain
        or reference dispatches of their wrappers (``zero`` sets them to
        0)."""
        from repro_torch.kernels.fused_stack import ops as fops
        from repro_torch.kernels.fused_stack import rows, rows_bwd
        from repro_torch.kernels.rmsnorm import ops as rops
        from repro_torch.kernels.rmsnorm import rmsnorm
        from repro_torch.kernels.ssd import ops as dops
        from repro_torch.kernels.ssd import ssd
        fns = {"ssd_intra_chunk": ssd.ssd_intra_chunk,
               "rmsnorm": rmsnorm.rmsnorm_fwd, "fused_rows": rows.fused_rows,
               "fused_rows_bwd": rows_bwd.fused_rows_bwd}
        if zero:
            for fn in fns.values():
                fn.launches = 0
            for st in (fops.STATS, rops.STATS, dops.STATS):
                st.reset()
        out = {k: fn.launches for k, fn in fns.items()}
        out["plain"] = (dops.STATS.counts["plain"] + rops.STATS.counts["plain"]
                        + fops.STATS.counts["fwd_reference"]
                        + fops.STATS.counts["bwd_reference"])
        return out

    def expect_ssm(self, what, got, ssd=0, rmsnorm=0, rows=0, rows_bwd=0):
        want = {"ssd_intra_chunk": ssd, "rmsnorm": rmsnorm,
                "fused_rows": rows, "fused_rows_bwd": rows_bwd, "plain": 0}
        if got != want:
            raise PhaseError(f"{what}: counters {got}, expected {want}")

    def held_to_f32(self, what, err_b, err_r):
        """brainslug's per-step distances to the float32 run (``err_b``)
        within SSM_F32_FACTOR times barrier's (``err_r``), worst and
        median; returns a summary."""
        for name, stat in (("worst", max), ("median", statistics.median)):
            if not stat(err_b) <= SSM_F32_FACTOR * stat(err_r):
                raise PhaseError(
                    f"{what}: brainslug's {name} distance to the float32 run "
                    f"{stat(err_b):.3e} > {SSM_F32_FACTOR} x barrier's "
                    f"{stat(err_r):.3e}")
        return (f"to the float32 run, brainslug worst {max(err_b):.3e} "
                f"median {statistics.median(err_b):.3e}, barrier worst "
                f"{max(err_r):.3e} median {statistics.median(err_r):.3e} "
                f"(brainslug within {SSM_F32_FACTOR}x barrier's)")

    @contextlib.contextmanager
    def ssm_control(self, name):
        """A defect planted in the mamba layer while the block runs, in
        every full-sequence and decode call: the SSD's arithmetic in bf16
        (the intra-chunk products of the chunked path, and the decode
        step's state update; the JAX kernel is float32 throughout), layer
        4's mixer output dropped (a wrong forward), or the gated RMSNorm in
        bf16 throughout, its sum of squares in bf16 partials of 128 added
        in bf16.  Yields a list whose length counts the calls the defect
        touched."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.ssd import chunked
        from repro_torch.layers import mamba2
        saved = (mamba2.apply, mamba2.decode, mamba2._gated_norm,
                 mamba2._ssd_dispatch, chunked.ssd_decode_step)
        apply, decode = saved[:2]
        touched = []
        bf = torch.bfloat16

        def bf16_intra(dtx, a, B, C):
            y, st = chunked.ssd_intra_chunk_ref(
                *(t.to(bf) for t in (dtx, a, B, C)))
            return y.float(), st.float()

        def bf16_ssd(xs, dt, A, B, C, D, rt):
            touched.append(1)
            return chunked.ssd_chunked(xs, dt, A, B, C, D, chunk=rt.ssd_chunk,
                                       intra=bf16_intra)

        def bf16_step(hstate, x_t, dt_t, A, B_t, C_t, D=None):
            touched.append(1)
            dA = torch.exp(dt_t.to(bf) * A.to(bf))
            dBx = torch.einsum("bn,bhp->bhnp", B_t.to(bf),
                               dt_t.to(bf)[..., None] * x_t.to(bf))
            hnew = hstate.to(bf) * dA[..., None, None] + dBx
            y = torch.einsum("bn,bhnp->bhp", C_t.to(bf), hnew)
            if D is not None:
                y = y + D.to(bf)[None, :, None] * x_t.to(bf)
            return hnew.float(), y.to(x_t.dtype)

        def bf16_norm(params, y, z, rt):
            touched.append(1)
            m = y * F.silu(z)
            part = (m * m).unflatten(-1, (-1, 128)).sum(-1)
            acc = part[..., 0]
            for k in range(1, part.shape[-1]):
                acc = acc + part[..., k]
            inv = torch.rsqrt(acc / m.shape[-1] + 1e-6)
            return m * inv[..., None] * params["norm_scale"]

        def layer(params):
            a = params["A_log"]
            return a.storage_offset() // a.shape[-1]

        def drop_apply(params, x, cfg, rt):
            out = apply(params, x, cfg, rt)
            if layer(params) != 4:
                return out
            touched.append(1)
            return out * 0.0

        def drop_decode(params, x_t, cache, cfg, rt, **kw):
            out, cache = decode(params, x_t, cache, cfg, rt, **kw)
            if layer(params) != 4:
                return out, cache
            touched.append(1)
            return out * 0.0, cache

        if name == "SSD in bf16":
            mamba2._ssd_dispatch, chunked.ssd_decode_step = bf16_ssd, bf16_step
        elif name == "bf16 gated norm":
            mamba2._gated_norm = bf16_norm
        else:
            mamba2.apply, mamba2.decode = drop_apply, drop_decode
        try:
            yield touched
        finally:
            (mamba2.apply, mamba2.decode, mamba2._gated_norm,
             mamba2._ssd_dispatch, chunked.ssd_decode_step) = saved

    def control_flagged(self, what, err_c, err_r):
        """Whether :meth:`held_to_f32` flags a control's distances
        ``err_c`` against barrier's ``err_r``; returns the ratios read."""
        try:
            self.held_to_f32(what, err_c, err_r)
            flagged = False
        except PhaseError:
            flagged = True
        return flagged, (f"worst {max(err_c):.3e} ({max(err_c) / max(err_r):.2f}"
                         f"x barrier's), median {statistics.median(err_c):.3e} "
                         f"({statistics.median(err_c) / statistics.median(err_r):.2f}"
                         f"x)")

    def rel_l2(self, got, want):
        """||got - want|| / ||want|| over lists of tensors, in float32."""
        num = sum(float((g.float() - w.float()).square().sum())
                  for g, w in zip(got, want))
        den = sum(float(w.float().square().sum()) for w in want)
        return math.sqrt(num / max(den, 1e-30))

    def ssm_blocks(self, params, cfg, tokens, vjp):
        """Every mamba block run alone on barrier's inputs to it, in
        brainslug, in barrier and in barrier with each control's defect,
        against the same block in float32 on the same inputs: the relative
        L2 distance of the mixer output (``vjp`` False), or of the block's
        VJP, the gradients of every input and parameter for a seeded
        cotangent on the mixer output (``vjp`` True).  The block is
        teacher-forced, so rounding is not amplified through the layers
        before it.  Returns {run: [distance per block]} and, per control,
        the calls its defect touched."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.layers import base
        from repro_torch.models import lm
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        rts = {m: RuntimeConfig(mode=m) for m in ("brainslug", "barrier")}
        dist = {r: [] for r in ("brainslug", "barrier") + SSM_CONTROLS}
        touched = {name: 0 for name in SSM_CONTROLS}
        g = torch.Generator(device=self.dev).manual_seed(2300)

        def run(p, c, rt, resid, pending, cot):
            if not vjp:
                with torch.no_grad():
                    return [lm._apply_sub("mamba", p, resid, pending, c,
                                          rt)[1]]
            with torch.enable_grad():
                live = base.tree_map(lambda t: t.detach().requires_grad_(),
                                     p)
                ins = [t.detach().requires_grad_() for t in (resid, pending)]
                out = lm._apply_sub("mamba", live, *ins, c, rt)[1]
                return list(torch.autograd.grad(
                    out, ins + base.tree_leaves(live), cot.to(out.dtype)))

        with torch.no_grad():
            resid = lm.embed_inputs(params, {"tokens": tokens}, cfg)
        pending = torch.zeros_like(resid)
        for p in lm._unstack(params["blocks"]["sub0"], cfg.n_layers):
            cot = torch.randn(resid.shape, generator=g, device=self.dev) \
                if vjp else None
            ref = run(base.cast_tree(p, torch.float32), cfg32,
                      rts["barrier"], resid.float(), pending.float(), cot)
            for m in ("brainslug", "barrier"):
                dist[m].append(self.rel_l2(
                    run(p, cfg, rts[m], resid, pending, cot), ref))
            for name in SSM_CONTROLS:
                with self.ssm_control(name) as hit:
                    dist[name].append(self.rel_l2(
                        run(p, cfg, rts["barrier"], resid, pending, cot),
                        ref))
                touched[name] += len(hit)
            del ref
            with torch.no_grad():
                resid, pending, _ = lm._apply_sub("mamba", p, resid,
                                                  pending, cfg,
                                                  rts["barrier"])
        return dist, touched

    def check_blocks(self, tag, what, dist, touched, controls=SSM_CONTROLS):
        """brainslug's distance to the float32 block within
        SSM_BLOCK_FACTOR x barrier's in every block; each control's
        defect touched a call and is flagged in some block.  Prints the
        readings."""
        ratio = {r: [a / b for a, b in zip(d, dist["barrier"])]
                 for r, d in dist.items()}
        line = "; ".join(
            f"{r}: distance median {statistics.median(d):.3e} worst "
            f"{max(d):.3e}, ratio to barrier's median "
            f"{statistics.median(ratio[r]):.3f} worst {max(ratio[r]):.3f} "
            f"(block {ratio[r].index(max(ratio[r]))})"
            for r, d in dist.items())
        print(f"[{tag} blocks] {what}, each of {len(dist['barrier'])} blocks "
              f"alone on barrier's inputs, relative L2 distance to the "
              f"float32 block; brainslug within {SSM_BLOCK_FACTOR}x "
              f"barrier's in every block, each control flagged past it: "
              + line)
        if not max(ratio["brainslug"]) <= SSM_BLOCK_FACTOR:
            raise PhaseError(f"{tag} blocks: brainslug at "
                             f"{max(ratio['brainslug']):.3f}x barrier's "
                             f"distance to the float32 block")
        for name in controls:
            if not touched[name]:
                raise PhaseError(f"{tag} blocks: the control {name} touched "
                                 f"no call")
            if not max(ratio[name]) > SSM_BLOCK_FACTOR:
                raise PhaseError(f"{tag} blocks: the control {name} is not "
                                 f"flagged (worst {max(ratio[name]):.3f}x)")

    def ssm_kernel(self, low):
        """The mamba path's kernel group of a kernel name, else None."""
        for frag, group in (("ssd_intra_chunk_kernel", "ssd_intra_chunk"),
                            ("rmsnorm_kernel", "rmsnorm"),
                            ("fused_rows_bwd", "fused_rows_bwd"),
                            ("reduce_partials", "fused_rows_bwd"),
                            ("fused_rows", "fused_rows")):
            if frag in low:
                return group
        return None

    def ssm_group(self, low):
        if self.ssm_kernel(low) is not None:
            return self.ssm_kernel(low)
        if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
            return "matmul"
        return "other"

    def ssm_queue(self, vocab):
        """MAMBA_ENGINE's ragged queue from numpy seed 2100: prompts of
        16-96 tokens, 8-32 new tokens each, greedy."""
        from repro_torch.launch.engine import Request
        rng = np.random.default_rng(2100)
        lo, hi = MAMBA_ENGINE["prompt"]
        s_lo, s_hi = MAMBA_ENGINE["stops"]
        return [Request(request_id=i,
                        prompt=rng.integers(1, vocab, int(rng.integers(
                            lo, hi + 1))).tolist(),
                        max_new_tokens=int(rng.integers(s_lo, s_hi + 1)))
                for i in range(MAMBA_ENGINE["requests"])]

    def ssm_path_kernels(self, cfg, tag="21", key="gated_norm"):
        """The kernels of the mamba path other than the SSD kernel, called
        as the path calls them, at its shapes, on bf16 tensors, against
        their plain versions at LM_TOL's bf16 tolerance: the gated RMSNorm
        (``mamba2._gated_norm``: ``fused_stack_apply`` in brainslug mode,
        the generated rows kernel) at prefill (1, 2048) and a decode step
        (4, 1) over d_inner, its backward through autograd (the rows
        backward kernel and its partial-sum reduction) at one 4096-token
        training sequence, and rmsnorm over d_model (its block masked past
        d_model, not a power of two) with the residual (each layer's
        add-norm) and without (the final norm).  Two runs of each give
        equal bits."""
        torch = self.torch
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.kernels.fused_stack import ref, rows, rows_bwd
        from repro_torch.kernels.rmsnorm import ref as rref
        from repro_torch.kernels.rmsnorm import rmsnorm
        from repro_torch.layers import mamba2
        t = time.perf_counter()
        bf = torch.bfloat16
        di, d = cfg.d_inner, cfg.d_model
        program = mamba2._gated_norm_program(1e-6)
        rt = RuntimeConfig(mode="brainslug")
        scale = (1.0 + 0.1 * self.randn((di,), 2210)).to(bf)
        lines = []
        for k, lead in enumerate((PREFILL, (SERVE["batch"], 1))):
            y = self.randn(lead + (di,), 2200 + 2 * k).to(bf)
            z = self.randn(lead + (di,), 2201 + 2 * k).to(bf)
            before = rows.fused_rows.launches
            got = mamba2._gated_norm({"norm_scale": scale}, y, z, rt)
            again = mamba2._gated_norm({"norm_scale": scale}, y, z, rt)
            if rows.fused_rows.launches != before + 2:
                raise PhaseError("gated norm: the rows kernel did not launch")
            want = ref.fused_stack_ref(program, {"y": y, "z": z},
                                       {"scale": scale})["o"]
            if got.dtype != want.dtype:
                raise PhaseError(f"gated norm {lead}: output {got.dtype}, the "
                                 f"plain version's {want.dtype}")
            err = self.lm_check("mamba_rows", f"gated norm {lead}", got, want)
            self.same_bits("fused_rows", f"gated norm {lead}", {"o": got},
                           {"o": again})
            lines.append(f"gated norm fwd {lead + (di,)} max|d| {err:.2e}")
        self.gated_norm_fwd_timing(program, scale, tag, key)
        # the backward at one training sequence
        seq = (1, TRAIN_LM["seq"])
        y = self.randn(seq + (di,), 2220).to(bf)
        z = self.randn(seq + (di,), 2221).to(bf)
        cot = self.randn(seq + (di,), 2222).to(bf)

        def grads():
            leaves = [v.detach().requires_grad_() for v in (y, z, scale)]
            with torch.enable_grad():
                o = mamba2._gated_norm({"norm_scale": leaves[2]}, leaves[0],
                                       leaves[1], rt)
                g = torch.autograd.grad(o, leaves, cot)
            return dict(zip(("dy", "dz", "dscale"), g))

        before = rows_bwd.fused_rows_bwd.launches
        got, again = grads(), grads()
        if rows_bwd.fused_rows_bwd.launches != before + 2:
            raise PhaseError("gated norm backward: the rows backward kernel "
                             "did not launch")
        dins, dpar = rows_bwd.fused_rows_bwd_ref(
            program, {"y": y, "z": z}, {"scale": scale}, {"o": cot})
        want = {f"d{n}": v for n, v in {**dins, **dpar}.items()}
        err = self.check_bwd("mamba_rows_bwd", f"gated norm bwd {seq}", got,
                             want, reduced={"dscale"}, tol=LM_TOL["bfloat16"])
        self.same_bits("fused_rows_bwd", "gated norm bwd", got, again)
        lines.append(f"gated norm bwd {seq + (di,)} max|d| {err}")
        # rmsnorm over d_model: the add-norms and the final norm
        sc = (1.0 + 0.1 * self.randn((d,), 2230)).to(bf)
        for k, (lead, residual) in enumerate(((PREFILL, True),
                                              (PREFILL, False),
                                              ((SERVE["batch"], 1), True))):
            x = self.randn(lead + (d,), 2231 + 2 * k).to(bf)
            r = self.randn(lead + (d,), 2232 + 2 * k).to(bf) \
                if residual else None
            before = rmsnorm.rmsnorm_fwd.launches
            (yk, hk), again = (rmsnorm.rmsnorm_fwd(x, sc, r),
                               rmsnorm.rmsnorm_fwd(x, sc, r))
            if rmsnorm.rmsnorm_fwd.launches != before + 2:
                raise PhaseError("rmsnorm did not launch")
            yw, hw = rref.rmsnorm_ref(x, sc, r)
            what = f"rmsnorm {lead + (d,)} {'with' if residual else 'no'} " \
                   f"residual"
            err = max(self.lm_check("mamba_rmsnorm", what, yk, yw),
                      self.lm_check("mamba_rmsnorm", what + " h", hk, hw))
            self.same_bits("rmsnorm", what, {"y": yk, "h": hk},
                           {"y": again[0], "h": again[1]})
            lines.append(f"{what} max|d| {err:.2e}")
        print(f"[{tag} path kernels] {cfg.name} bf16, against the plain "
              f"versions "
              f"(tol {LM_TOL['bfloat16']}; the backward's dscale atol rtol x "
              f"max), two runs bit for bit: " + "; ".join(lines)
              + f"; {time.perf_counter() - t:.1f} s")

    def gated_norm_fwd_timing(self, program, scale, tag="21",
                              key="gated_norm"):
        """The rows forward at mamba2's gated norm over d_inner in bf16:
        prefill (1, 2048), one training sequence (1, 4096) and a decode step
        (4, 1); each against its plain version (LM_TOL, two runs bit for
        bit), its device time (profiler, mean of 20, and at the other count
        of programs an SM) beside the byte bound (read y and z, write o),
        its plain version, the launch plan and the registers and
        spills."""
        torch = self.torch
        from repro_torch.core.resource import H100
        from repro_torch.kernels.fused_stack import ref, rows
        bf = torch.bfloat16
        di = scale.shape[0]
        out = {}
        for k, lead in enumerate((PREFILL, (1, TRAIN_LM["seq"]),
                                  (SERVE["batch"], 1))):
            y = self.randn(lead + (di,), 2240 + 2 * k).to(bf)
            z = self.randn(lead + (di,), 2241 + 2 * k).to(bf)
            inputs, params = {"y": y, "z": z}, {"scale": scale}
            run = lambda: rows.fused_rows(  # noqa: E731
                program, inputs, params)
            o = run()["o"]
            regs = self.triton_regs(self.rows_jit())
            n = math.prod(lead)
            what = f"gated norm fwd {lead + (di,)}"
            err = self.lm_check("mamba_rows", what, o, ref.fused_stack_ref(
                program, inputs, params)["o"])
            self.same_bits("fused_rows", what, {"o": o}, {"o": run()["o"]})
            plan = rows.launch_plan(n, di, di, self.sm_count, 4,
                                    programs_per_sm=rows.PROGRAMS_PER_SM)
            k_ms, k_how = self.device_ms(run)
            alt = PROGRAMS_ALT[rows.PROGRAMS_PER_SM]
            a_ms = self.at_programs_per_sm(run, alt)
            p_ms, _ = self.device_ms(lambda: ref.fused_stack_ref(
                program, inputs, params))
            nb = sum(t.numel() * t.element_size() for t in (y, z, scale, o))
            b_ms = nb / H100.hbm_bandwidth * 1e3
            print(f"[{tag} gated norm fwd] rows={n} F={di} bf16: max|d| "
                  f"{err:.2e} (tol {LM_TOL['bfloat16']}), two runs bit for "
                  f"bit; kernel {k_ms:.4f} ms {k_how} ({alt} programs an SM: "
                  f"{a_ms:.4f} ms)  plain {p_ms:.4f} ms  library none  "
                  f"bound {b_ms:.4f} ms (bytes)  kernel/bound "
                  f"{k_ms / b_ms:.2f}  {regs}; {plan.n_prog} programs, "
                  f"{plan.r_sub} row(s) a sub-block, {plan.num_warps} warps, "
                  f"{plan.loop_stages} stage(s)")
            out[str(n)] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                           "registers": regs, f"ms_at_{alt}_per_sm": a_ms}
        self.kernels["fused_rows"][key] = out

    def phase21_ssm_serving(self):
        torch = self.torch
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.launch import serve
        from repro_torch.layers import base
        from repro_torch.models import lm
        cfg = get_config("mamba2-2.7b")
        L = cfg.n_layers
        self.ssm_path_kernels(cfg)
        t = time.perf_counter()
        params = lm.init(0, cfg, device=self.dev)
        torch.cuda.synchronize()
        print(f"[21 model] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
              f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, N "
              f"{cfg.ssm_state}, vocab {cfg.vocab_size}, {cfg.dtype}: "
              f"{base.param_count(params) / 1e9:.3f} B random parameters "
              f"(seed 0) in {time.perf_counter() - t:.1f} s")
        rts = {m: RuntimeConfig(mode=m) for m in ("barrier", "brainslug")}

        # 21a: lm.prefill over (1, 2048) tokens
        g = torch.Generator(device=self.dev).manual_seed(2101)
        tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=g,
                               device=self.dev)
        with torch.inference_mode():
            want = lm.prefill(params, {"tokens": tokens}, cfg, rts["barrier"])
            torch.cuda.synchronize()
            self.ssm_counters(zero=True)
            got = lm.prefill(params, {"tokens": tokens}, cfg,
                             rts["brainslug"])
            torch.cuda.synchronize()
            counts = self.ssm_counters()
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            p32 = base.cast_tree(params, torch.float32)
            ref32 = lm.prefill(p32, {"tokens": tokens}, cfg32,
                               rts["barrier"])
        self.expect_ssm("mamba prefill", counts, ssd=L, rmsnorm=L + 1, rows=L)
        self.kernels["ssd_intra_chunk"]["launches"] = counts["ssd_intra_chunk"]
        if tuple(got.shape) != (1, 1, cfg.vocab_size) or not bool(
                torch.isfinite(got).all()):
            raise PhaseError(f"mamba prefill logits {tuple(got.shape)}")
        rel = self.relative(got, want)
        if not rel <= PATH_BF16_REL:
            raise PhaseError(f"mamba prefill brainslug vs barrier: "
                             f"max|d|/max {rel:.3e} > {PATH_BF16_REL}")
        print(f"[21a lm.prefill {PREFILL} bf16] brainslug vs barrier last-"
              f"position logits: max|d|/max|logits| = {rel:.3e} (tol "
              f"{PATH_BF16_REL}), argmax equal "
              f"{bool(got.argmax() == want.argmax())}; against the float32 "
              f"logits of the same weights: brainslug "
              f"{self.relative(got, ref32):.3e}, barrier "
              f"{self.relative(want, ref32):.3e}; counters {counts}")
        del ref32

        # 21b: Server.generate, 4 requests, greedy, at the first
        # MAMBA_SERVE_LAYERS layers (views of the weights)
        ls = MAMBA_SERVE_LAYERS
        cfg_s = dataclasses.replace(cfg, n_layers=ls)
        params_s, p32_s = ({**tree, "blocks": base.tree_map(
            lambda a: a[:ls], tree["blocks"])} for tree in (params, p32))
        prompts = np.random.default_rng(2102).integers(
            0, cfg.vocab_size, (SERVE["batch"], SERVE["prompt_len"])
        ).astype(np.int32)
        t = time.perf_counter()
        servers, gens, counts = self.serve_pair(cfg_s, params_s, prompts,
                                                self.ssm_counters)
        steps = SERVE["prompt_len"] + SERVE["new_tokens"] - 1
        self.expect_ssm("mamba serving", counts, rmsnorm=steps * (ls + 1),
                        rows=steps * ls)
        serve_wall = {m: s.last_stats.wall_s for m, s in servers.items()}
        servers["float32"] = serve.Server(serve.ServeConfig(
            arch=cfg.name, reduced=False, mode="barrier",
            max_len=SERVE["prompt_len"] + SERVE["new_tokens"] + 1, **SERVE),
            params=p32_s, cfg=dataclasses.replace(cfg32, n_layers=ls))
        pairs = (("brainslug", "barrier"), ("brainslug", "float32"),
                 ("barrier", "float32"))
        logits = {}
        errs = self.teacher_forced(servers, prompts, gens["barrier"], pairs,
                                   steps=logits)
        held = self.held_to_f32("mamba serving bf16", errs[pairs[1]],
                                errs[pairs[2]])
        controls = []
        for name in SSM_CONTROLS:
            with self.ssm_control(name) as hit:
                ctrl = self.forced_steps(servers["barrier"], prompts,
                                         gens["barrier"])
            err_c = [self.relative(x, y) for x, y in zip(ctrl,
                                                         logits["float32"])]
            flagged, read = self.control_flagged(
                f"mamba serving control ({name})", err_c, errs[pairs[2]])
            controls.append((name, flagged, read, len(hit)))
        del logits, ctrl
        agree = float((gens["brainslug"] == gens["barrier"]).mean())
        n_gen = servers["brainslug"].last_stats.generated_tokens
        d = errs[pairs[0]]
        print(f"[21b Server.generate bf16] {ls} of the {L} layers, "
              f"{SERVE['batch']} requests, prompt "
              f"{SERVE['prompt_len']}, {SERVE['new_tokens']} new tokens, "
              f"greedy: token agreement brainslug vs barrier {agree:.4f}; "
              f"teacher-forced logits max|d|/max per step, brainslug vs "
              f"barrier worst {max(d):.3e}, median "
              f"{statistics.median(d):.3e}; {held}; wall " + ", ".join(
                  f"{m} {w:.3f} s ({n_gen / w:.2f} tok/s)"
                  for m, w in serve_wall.items())
              + f"; brainslug counters {counts}; "
              f"{time.perf_counter() - t:.1f} s")
        self.report_controls("21b", "barrier bf16 with a defect, teacher-"
                             "forced logits to the float32 run", controls)
        del servers, params_s, p32_s

        # 21c: Engine.run over a ragged queue, dense and paged, at the
        # first MAMBA_ENGINE["layers"] layers (views of the weights)
        le = MAMBA_ENGINE["layers"]
        cfg_e = dataclasses.replace(cfg, n_layers=le)
        cfg32_e = dataclasses.replace(cfg32, n_layers=le)
        params_e, p32_e = ({**tree, "blocks": base.tree_map(
            lambda a: a[:le], tree["blocks"])} for tree in (params, p32))
        reqs = self.ssm_queue(cfg.vocab_size)
        t = time.perf_counter()
        results = {}
        for layout, mode in ENGINE_RUNS:
            eng, comps, counts, wall = self.engine_run(
                cfg_e, params_e, layout, mode, reqs,
                counters=self.ssm_counters)
            results[(layout, mode)] = (eng, comps, wall)
            if eng.report()["decode_path"] != "ssm-recurrent":
                raise PhaseError(f"engine {layout} {mode}: decode path "
                                 f"{eng.report()['decode_path']}")
            if mode == "brainslug":
                e = self.evaluations(eng.last_stats)
                self.expect_ssm(f"mamba engine {layout}", counts,
                                rmsnorm=(le + 1) * e, rows=le * e)
        pb = results[("paged", "brainslug")][1]
        db = results[("dense", "brainslug")][1]
        pr = results[("paged", "barrier")][1]
        for i in range(len(reqs)):
            if not np.array_equal(pb[i].tokens, db[i].tokens):
                raise PhaseError(f"mamba engine: paged and dense brainslug "
                                 f"differ on request {i}")
        n_tok = sum(len(c.tokens) for c in pr)
        agree = sum(int((a.tokens == c.tokens).sum())
                    for a, c in zip(pb, pr)) / max(n_tok, 1)
        pick = list(range(4))
        seqs = [list(reqs[i].prompt) + pr[i].tokens.tolist() for i in pick]
        starts = [len(reqs[i].prompt) for i in pick]
        forced = {m: self.forced_logits(cfg_e, params_e, m, seqs, starts)
                  for m in ("brainslug", "barrier")}
        forced["float32"] = self.forced_logits(cfg32_e, p32_e, "barrier",
                                               seqs, starts)
        errs = {(a, b): [self.relative(x, y) for x, y in zip(forced[a],
                                                             forced[b])]
                for a, b in pairs}
        held = self.held_to_f32("mamba engine bf16", errs[pairs[1]],
                                errs[pairs[2]])
        d = errs[pairs[0]]
        print(f"[21c engine] {cfg.name} bf16, {le} of its {L} layers, "
              f"Engine(slots "
              f"{ENGINE['slots']}, max_len {ENGINE['max_len']}, prefill_chunk "
              f"{ENGINE['prefill_chunk']}, verify strict), "
              f"{len(reqs)} requests (prompts {MAMBA_ENGINE['prompt']}, new "
              f"tokens {MAMBA_ENGINE['stops']}): every request completed in "
              f"all three runs, decode path ssm-recurrent, prefix sharing "
              f"off; paged == dense brainslug tokens; vs paged barrier token "
              f"agreement {agree:.4f}, teacher-forced logits max|d|/max vs "
              f"barrier worst {max(d):.3e}, median {statistics.median(d):.3e};"
              f" {held}; {time.perf_counter() - t:.1f} s")
        for (layout, mode), (eng, comps, wall) in results.items():
            st = eng.last_stats
            print(f"[21c engine {layout} {mode}] wall {wall:.3f} s, "
                  f"{st.generated_tokens} tokens "
                  f"({st.generated_tokens / wall:.2f} tok/s), "
                  f"{self.evaluations(st)} model evaluations, TTFT "
                  f"p50 {st.ttft_p50_ms:.1f} ms p99 {st.ttft_p99_ms:.1f} ms; "
                  f"ServeStats {json.dumps(st.as_dict())}")
        del results, forced, p32, params_e, p32_e

        # 21d: float32 at 4 layers, identical greedy tokens
        cfg4 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
        p4 = lm.init(1, cfg4, device=self.dev)
        servers, gens, counts = self.serve_pair(cfg4, p4, prompts,
                                                self.ssm_counters)
        self.expect_ssm("mamba serving f32", counts, rmsnorm=steps * 5,
                        rows=steps * 4)
        if not np.array_equal(gens["brainslug"], gens["barrier"]):
            raise PhaseError("mamba serving f32: brainslug's tokens differ "
                             "from barrier's")
        errs = self.teacher_forced(servers, prompts, gens["barrier"])[
            ("brainslug", "barrier")]
        if not max(errs) <= PATH_F32_REL:
            raise PhaseError(f"mamba serving f32: logits max|d|/max "
                             f"{max(errs):.3e} > {PATH_F32_REL}")
        toks = {}
        for layout, mode in ENGINE_RUNS:
            toks[(layout, mode)] = self.engine_run(
                cfg4, p4, layout, mode, reqs, counters=self.ssm_counters)[1]
        first = toks[ENGINE_RUNS[0]]
        for run, comps in toks.items():
            for i, c in enumerate(comps):
                if not np.array_equal(c.tokens, first[i].tokens):
                    raise PhaseError(f"mamba engine f32: {run} differs on "
                                     f"request {i}")
        print(f"[21d float32, 4 layers] Server.generate brainslug == barrier "
              f"tokens, logits max|d|/max worst {max(errs):.3e} (tol "
              f"{PATH_F32_REL}); the three engine runs' tokens identical")
        del servers, p4

        # 21e: the path per mode, in turns; a trace per mode
        with torch.inference_mode():
            cache = lm.init_decode_cache(cfg, SERVE["batch"], 97,
                                         dtype=torch.float32, device=self.dev)
        tok = tokens[:, :SERVE["batch"]].reshape(SERVE["batch"], 1)

        def prefill(m):
            return lm.prefill(params, {"tokens": tokens}, cfg, rts[m])

        def step(m):
            return lm.decode_step(params, cache, tok, cfg, rts[m])

        with torch.inference_mode():
            pre = [(m, self.cuda_ms(lambda m=m: prefill(m), reps=1, groups=5))
                   for m in ("barrier", "brainslug", "brainslug", "barrier")]
            dec = [(m, self.cuda_ms(lambda m=m: step(m), reps=1, groups=20))
                   for m in ("barrier", "brainslug", "brainslug", "barrier")]
        print(f"[21e path] mamba2-2.7b bf16, {L} layers: lm.prefill "
              f"{PREFILL}, median of 5 (CUDA events), in turns: "
              + "  ".join(f"{m}={v:.3f} ms ({PREFILL[1] / v:.1f} tok/ms)"
                          for m, v in pre))
        print(f"[21e path] one decode step at batch {SERVE['batch']} (float32 "
              f"state as Server builds it), median of 20, in turns: "
              + "  ".join(f"{m}={v:.3f} ms" for m, v in dec))
        expect = {"prefill": {"ssd_intra_chunk_kernel": L,
                              "rmsnorm_kernel": L + 1},
                  "decode step": {"rmsnorm_kernel": L + 1}}
        with torch.inference_mode():
            for what, fn in (("prefill", prefill), ("decode step", step)):
                for m in ("barrier", "brainslug"):
                    out = self.complete_trace(
                        lambda m=m: fn(m),
                        expect[what] if m == "brainslug" else None,
                        classify=self.ssm_group)
                    if out.startswith("incomplete"):
                        # the idle share stands without every launch
                        out += "; unchecked: " + self.trace(
                            lambda m=m: fn(m), classify=self.ssm_group)
                    print(f"[21e trace {what} {m}] {out}")

        # 21f: every block alone, teacher-forced, against float32
        dist, touched = self.ssm_blocks(params, cfg, tokens, vjp=False)
        self.check_blocks("21f", f"mamba2-2.7b bf16 prefill {PREFILL}, the "
                          f"mixer output", dist, touched)
        del params, cache, want, got
        import gc
        gc.collect()
        torch.cuda.empty_cache()

    def report_controls(self, tag, what, controls):
        """Print the controls' readings (name, flagged, reading, touched
        calls); raise if a defect touched no call, or if the check missed
        one of SSM_END_TO_END."""
        print(f"[{tag} controls] {what}: " + "; ".join(
            f"{name}: {read}, {'flagged' if flagged else 'not flagged'}"
            for name, flagged, read, _ in controls)
            + f" (flagged past {SSM_F32_FACTOR}x; must flag "
            f"{list(SSM_END_TO_END)})")
        for name, flagged, _, hit in controls:
            if not hit:
                raise PhaseError(f"{tag}: the control {name} touched no call")
            if name in SSM_END_TO_END and not flagged:
                raise PhaseError(f"{tag}: brainslug's check against the "
                                 f"float32 run passes the defective run "
                                 f"{name}")

    def ssm_grad_anchor(self, layers):
        """22b: the step-1 gradient of the trainer's loss over every
        parameter (the seed-0 weights drawn in bf16, the first batch) in
        brainslug, in barrier and in barrier with each control's defect;
        its relative L2 distance to the float32 gradient of the same
        weights.  brainslug's within SSM_F32_FACTOR x barrier's."""
        torch = self.torch
        import gc
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.data import pipeline
        from repro_torch.layers import base
        from repro_torch.models import lm
        t = time.perf_counter()

        def grads(mode, dtype):
            trainer = self.lm_trainer(mode, layers, dtype,
                                      arch="mamba2-2.7b",
                                      init_dtype="bfloat16",
                                      remat=MAMBA_TRAIN["remat"])
            params, cfg = trainer.params, trainer.cfg
            batch = {k: torch.from_numpy(x).to(self.dev) for k, x in
                     pipeline.synth_batch(cfg, trainer.shape, 0, 0).items()}
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            with torch.enable_grad():
                live = base.tree_map(lambda p: p.detach().requires_grad_(),
                                     params)
                loss, _ = lm.loss_fn(live, batch, cfg, RuntimeConfig(
                    mode=mode, remat=MAMBA_TRAIN["remat"]))
                out = torch.autograd.grad(loss, base.tree_leaves(live))
            return float(loss), out

        loss32, g32 = grads("barrier", "float32")
        dist, loss = {}, {}
        for m in ("brainslug", "barrier"):
            loss[m], g = grads(m, "bfloat16")
            dist[m] = self.rel_l2(g, g32)
            del g
        controls = []
        for name in SSM_CONTROLS:
            with self.ssm_control(name) as hit:
                loss[name], g = grads("barrier", "bfloat16")
            dist[name] = self.rel_l2(g, g32)
            del g
            ratio = dist[name] / dist["barrier"]
            controls.append((name, ratio > SSM_F32_FACTOR,
                             f"{dist[name]:.4e} ({ratio:.2f}x barrier's), "
                             f"loss {loss[name]}", len(hit)))
        del g32
        gc.collect()
        torch.cuda.empty_cache()
        ratio = dist["brainslug"] / dist["barrier"]
        print(f"[22b step-1 gradient] {layers} layers bf16, every parameter, "
              f"relative L2 distance to the float32 gradient of the same "
              f"weights (loss {loss32}): brainslug {dist['brainslug']:.4e} "
              f"(loss {loss['brainslug']}), barrier {dist['barrier']:.4e} "
              f"(loss {loss['barrier']}), brainslug at {ratio:.3f}x "
              f"barrier's (tol {SSM_F32_FACTOR}x); "
              f"{time.perf_counter() - t:.1f} s")
        self.report_controls("22b", "barrier bf16 with a defect, step-1 "
                             "gradient's distance to the float32 gradient",
                             controls)
        if not ratio <= SSM_F32_FACTOR:
            raise PhaseError(f"mamba step-1 gradient: brainslug's distance "
                             f"to float32 {dist['brainslug']:.4e} > "
                             f"{SSM_F32_FACTOR} x barrier's "
                             f"{dist['barrier']:.4e}")

    def phase22_ssm_train(self):
        torch = self.torch
        import shutil
        import tempfile
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.data import pipeline
        from repro_torch.distributed import fault_tolerance as ft
        from repro_torch.launch import steps as steps_mod
        from repro_torch.optim import adamw
        from repro_torch.configs import get_config
        from repro_torch.models import lm
        t = time.perf_counter()
        L = MAMBA_TRAIN["layers"]
        kw = dict(arch="mamba2-2.7b", remat=MAMBA_TRAIN["remat"],
                  counters=self.ssm_counters)
        runs = {}
        for mode in ("brainslug", "barrier"):
            hist, per_step, peak, wall = self.train_lm(mode, L, "bfloat16",
                                                       **kw)
            for i, got in enumerate(per_step):
                if mode == "brainslug":
                    # remat "full": every block runs twice, its backward once
                    self.expect_ssm(f"mamba train step {i + 1}", got,
                                    ssd=2 * L, rmsnorm=2 * L + 1, rows=2 * L,
                                    rows_bwd=L)
                else:
                    self.expect_ssm(f"mamba train barrier step {i + 1}", got)
            runs[mode] = (hist, per_step, peak, wall)
        # the float32 reference: the same bf16-drawn weights in float32
        runs["float32"] = self.train_lm("barrier", L, "float32",
                                        init_dtype="bfloat16", **kw)
        losses = {m: [h["loss"] for h in r[0]] for m, r in runs.items()}
        gnorms = {m: [h["grad_norm"] for h in r[0]] for m, r in runs.items()}
        if not all(math.isfinite(x) for d in (losses, gnorms)
                   for v in d.values() for x in v):
            raise PhaseError(f"mamba train: losses {losses}, grad norms "
                             f"{gnorms}")
        gaps, held = {}, {}
        for what, vals in (("loss", losses), ("grad_norm", gnorms)):
            gaps[what] = [abs(a - b) / abs(b) for a, b in
                          zip(vals["brainslug"], vals["barrier"])]
            held[what] = [(abs(a - c) / abs(c), abs(b - c) / abs(c))
                          for a, b, c in zip(vals["brainslug"],
                                             vals["barrier"],
                                             vals["float32"])]
        print(f"[22a train bf16] mamba2-2.7b, d_model 2560, 80 heads of 64, "
              f"N 128, vocab 50280, {L} layers, bf16, remat "
              f"{MAMBA_TRAIN['remat']}, 1 x {TRAIN_LM['seq']} tokens, "
              f"{TRAIN_LM['steps']} AdamW steps lr {TRAIN_LM['lr']} through "
              f"build_trainer / Trainer.run: " + "; ".join(
                  f"{m} losses {losses[m]} grad_norm {gnorms[m]} peak "
                  f"{runs[m][2]:.2f} GiB wall {runs[m][3]:.1f} s"
                  for m in runs)
              + f"; brainslug vs barrier relative gaps per step: loss "
              f"{[f'{g:.3e}' for g in gaps['loss']]}, grad_norm "
              f"{[f'{g:.3e}' for g in gaps['grad_norm']]}; distances to "
              f"the float32 run (brainslug, barrier): loss "
              f"{[(f'{a:.2e}', f'{b:.2e}') for a, b in held['loss']]}, "
              f"grad_norm "
              f"{[(f'{a:.2e}', f'{b:.2e}') for a, b in held['grad_norm']]} "
              f"(read, not held: agreement is held on the step-1 gradient, "
              f"22b, and block by block, 22e); brainslug counters per step "
              f"{runs['brainslug'][1][0]}")
        self.ssm_grad_anchor(L)

        # 22c: kill at step 2, resume from the step-1 checkpoint (at
        # MAMBA_TRAIN["layers_resume"] layers)
        Lr = MAMBA_TRAIN["layers_resume"]
        full = self.train_lm("brainslug", Lr, "bfloat16", **kw)[0]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
            free = shutil.disk_usage(d).free / 2 ** 30
            try:
                self.train_lm("brainslug", Lr, "bfloat16",
                              failure=ft.failure_injector({2}), ckpt_dir=d,
                              ckpt_every=1, **kw)
            except ft.SimulatedFailure:
                pass
            else:
                raise PhaseError("mamba kill/resume: the injected failure at "
                                 "step 2 did not happen")
            resumed, _, _, wall = self.train_lm("brainslug", Lr, "bfloat16",
                                                ckpt_dir=d, ckpt_every=1,
                                                **kw)
        if [h["step"] for h in resumed] != [2] or \
                resumed[-1]["loss"] != full[-1]["loss"]:
            raise PhaseError(f"mamba kill/resume: resumed {resumed}, "
                             f"uninterrupted step-3 loss {full[-1]['loss']}")
        print(f"[22c kill/resume] bf16 {Lr} layers brainslug: killed at step "
              f"2, resumed from the step-1 bf16 checkpoint ({free:.0f} GiB "
              f"free in the temp dir): step-3 loss {resumed[-1]['loss']} "
              f"equals the uninterrupted run's bit for bit; resume run "
              f"{wall:.1f} s; phase {time.perf_counter() - t:.1f} s")

        # 22d: the step per mode, in turns, on one model and state
        trainer = self.lm_trainer("brainslug", L, "bfloat16",
                                  arch="mamba2-2.7b",
                                  remat=MAMBA_TRAIN["remat"])
        opt_cfg = adamw.AdamWConfig(lr=TRAIN_LM["lr"])
        fns = {m: steps_mod.make_train_step(
            trainer.cfg, RuntimeConfig(mode=m, remat=MAMBA_TRAIN["remat"]),
            opt_cfg) for m in ("barrier", "brainslug")}
        batch = {k: torch.from_numpy(x).to(self.dev) for k, x in
                 pipeline.synth_batch(trainer.cfg, trainer.shape, 0,
                                      0).items()}

        def step(m):
            trainer.params, trainer.opt_state, _ = fns[m](
                trainer.params, trainer.opt_state, batch)

        def timed(m):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(m)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            return statistics.median(times)

        for m in fns:
            step(m)                                     # warm-up
        turns = [(m, timed(m)) for m in ("barrier", "brainslug", "brainslug",
                                         "barrier")]
        print(f"[22d train step] mamba2-2.7b {L} layers bf16 remat "
              f"{MAMBA_TRAIN['remat']}, 1 x {TRAIN_LM['seq']} tokens, forward "
              f"+ backward + AdamW, median of 3 after a warm-up (host clock "
              f"around synchronised steps), in turns: "
              + "  ".join(f"{m}={ms:.1f} ms ({TRAIN_LM['seq'] / ms:.2f} "
                          f"tok/ms)" for m, ms in turns))
        for m in ("barrier", "brainslug"):
            print(f"[22d trace train step {m}] " + self.train_trace(
                lambda m=m: step(m), classify=self.ssm_kernel))
        del trainer, fns, batch
        torch.cuda.empty_cache()

        # 22e: every block's VJP alone, teacher-forced, against float32
        cfg = dataclasses.replace(get_config("mamba2-2.7b"),
                                  n_layers=MAMBA_TRAIN["layers"])
        params = lm.init(0, cfg, device=self.dev)
        g = torch.Generator(device=self.dev).manual_seed(2301)
        tokens = torch.randint(0, cfg.vocab_size, (1, TRAIN_LM["seq"]),
                               generator=g, device=self.dev)
        dist, touched = self.ssm_blocks(params, cfg, tokens, vjp=True)
        self.check_blocks("22e", f"mamba2-2.7b bf16 at 1 x {TRAIN_LM['seq']} "
                          f"tokens, the VJP of every input and parameter",
                          dist, touched)
        del params
        torch.cuda.empty_cache()
        print(f"[22 kernels] ssd_intra_chunk max|d|="
              f"{self.err['ssd_intra_chunk']:.3e} (against its plain "
              f"version)  ops.ssd max|d|={self.err['ssd_ops']:.3e} (against "
              f"ssd_chunked)")


    # -- phase 23: the traced frontend (repro_torch.api.optimize) ------------
    def traced_counts(self, zero=False):
        """Dispatch and launch counts of the traced paths: the fused-stack
        counters, the four fused-stack kernels, the registry's dispatches
        and the LM kernels' launches (``zero`` sets them all to 0)."""
        from repro_torch.core import registry
        from repro_torch.kernels.fused_stack import ops
        from repro_torch.kernels.vocab_ce import ce
        if zero:
            self.zero_counts()
            self.lm_counters(zero=True)
            registry.STATS.reset()
            ce.fused_ce_fwd.launches = 0
        lm = self.lm_counters()
        return {**ops.STATS.snapshot(), **self.launch_counts(),
                **{k: lm[k] for k in ("rmsnorm", "swiglu",
                                      "flash_attention")},
                "fused_ce": ce.fused_ce_fwd.launches,
                "registry": {k: v for k, v in registry.STATS.counts.items()
                             if v}}

    def expect_traced(self, what, got, n_seq, **launches):
        """The counts of one traced run: every sequence on its generated
        kernels, the kernels launched as ``launches`` says, every registry
        dispatch on its Hopper kernel."""
        want = {"fwd_generated": n_seq, "fwd_reference": 0,
                "bwd_generated": 0, "bwd_reference": 0, "fused_nhwc": 0,
                "fused_rows": 0, "fused_nhwc_bwd": 0, "fused_rows_bwd": 0,
                "rmsnorm": 0, "swiglu": 0, "flash_attention": 0,
                "fused_ce": 0, **launches}
        reg = {"attention_hopper": launches.get("flash_attention", 0),
               "rmsnorm_hopper": launches.get("rmsnorm", 0),
               "swiglu_hopper": launches.get("swiglu", 0),
               "vocab_ce_hopper": launches.get("fused_ce", 0)}
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad or got["registry"] != {k: v for k, v in reg.items() if v}:
            raise PhaseError(f"{what}: counters {got}; (got, expected) "
                             f"{bad}; registry expected {reg}")

    def host_ms(self, fn, reps=20):
        """Host milliseconds per call (the enqueue, no synchronisation
        inside), median of ``reps`` calls each started on an idle card."""
        torch = self.torch
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        return statistics.median(times)

    def phase23_traced(self):
        torch = self.torch
        import gc

        import torch.nn.functional as F
        from repro_torch import api
        from repro_torch.core import api as core_api
        from repro_torch.models import cnn, lm
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()

        # 23a: the quickstart twin at VGG-16 widths
        graph, params = cnn.vgg_net(VGG16_STAGES, device=self.dev)
        x = self.randn(VGG_INPUT, 7)
        t_opt = time.perf_counter()
        net = api.optimize(cnn.vgg_fn, x, params,
                           config=api.OptimizeConfig(mode="brainslug"))
        t_opt = time.perf_counter() - t_opt
        gnet = core_api.optimize_graph(graph, VGG_INPUT, core_api.
                                       OptimizeConfig(mode="brainslug"))
        bnet = api.optimize(cnn.vgg_fn, x, params,
                            config=api.OptimizeConfig(mode="barrier"))
        with torch.no_grad():
            want = cnn.vgg_fn(x, params)
            torch.cuda.synchronize()
            self.traced_counts(zero=True)
            got = net(x, params)
            torch.cuda.synchronize()
            counts = self.traced_counts()
        n_seq = net.n_sequences
        if tuple(got.shape) != (VGG_INPUT[0], 10) \
                or not bool(torch.isfinite(got).all()):
            raise PhaseError(f"23a: output {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, **PATH_TOL):
            raise PhaseError(f"23a: traced VGG vs vgg_fn max|d|={err:.3e}")
        if (net.n_stacks, n_seq) != (gnet.n_stacks, gnet.n_sequences):
            raise PhaseError(f"23a: {net.n_stacks} stacks / {n_seq} "
                             f"sequences, optimize_graph {gnet.n_stacks} / "
                             f"{gnet.n_sequences}")
        self.expect_traced("23a", counts, n_seq, fused_nhwc=n_seq)
        report = net.report()
        if report.capture_ratio < 0.9:
            raise PhaseError(f"23a: capture ratio {report.capture_ratio}")
        self.kernels["fused_nhwc"]["traced_launches"] = counts["fused_nhwc"]
        print(f"[23a api.optimize(vgg_fn) VGG-16 widths {VGG_INPUT}, "
              f"brainslug] traced in {t_opt:.2f} s; vs the plain vgg_fn "
              f"max|d|={err:.3e} (tol {PATH_TOL}); {net.n_stacks} stacks, "
              f"{n_seq} sequences (optimize_graph: {gnet.n_stacks}, "
              f"{gnet.n_sequences}); capture ratio "
              f"{report.capture_ratio:.4f}; counters {counts}")
        print(net.explain())

        # 23b: training through optimize, against autograd of the plain fn
        labels = torch.randint(0, 10, (VGG_INPUT[0],), device=self.dev,
                               generator=torch.Generator(
                                   device=self.dev).manual_seed(8))
        tnets = {m: api.optimize(cnn.vgg_fn, x, params,
                                 config=api.OptimizeConfig(
                                     mode=m, differentiable=True))
                 for m in ("brainslug", "barrier")}
        tgnet = core_api.optimize_graph(graph, VGG_INPUT, core_api.
                                        OptimizeConfig(mode="brainslug",
                                                       differentiable=True))
        loss = lambda y: F.cross_entropy(y, labels)        # noqa: E731
        runs = {}
        self.traced_counts(zero=True)
        runs["brainslug"] = self.sgd(lambda p: tnets["brainslug"](x, p),
                                     params, loss)
        train_counts = self.traced_counts()
        runs["barrier"] = self.sgd(lambda p: cnn.vgg_fn(x, p), params, loss)
        n_tseq = tnets["brainslug"].n_sequences
        worst = self.compare_training("23b traced VGG training", runs,
                                      n_tseq, "fused_nhwc_bwd")
        self.kernels["fused_nhwc_bwd"]["traced_launches"] = \
            train_counts["fused_nhwc_bwd"]
        print(f"[23b api.optimize(vgg_fn, differentiable=True), "
              f"{TRAIN_STEPS} SGD steps lr {TRAIN_LR}] losses "
              f"{runs['brainslug'][0]} against autograd of the plain "
              f"vgg_fn {runs['barrier'][0]}; step-1 gradients max|d|/max|g| "
              f"{worst:.3e} (tol rtol {TRAIN_RTOL}, atol {TRAIN_RTOL}"
              f"*max|g|); counters per step "
              f"{[s for s, _ in runs['brainslug'][2]]}; launches over the "
              f"run {{'fused_nhwc': {train_counts['fused_nhwc']}, "
              f"'fused_nhwc_bwd': {train_counts['fused_nhwc_bwd']}}}")

        _, bparams = cnn.block_net(8, 32, device=self.dev)
        bx = self.randn(BLOCK_INPUT, 11)
        cot = self.randn(BLOCK_INPUT, 12)
        blk = {m: api.optimize(cnn.block_fn, bx, bparams,
                               config=api.OptimizeConfig(
                                   mode=m, differentiable=True))
               for m in ("brainslug", "barrier")}

        def block_grads(fn):
            with torch.enable_grad():
                leaves = {"x": bx.clone().requires_grad_(),
                          **{k: v.clone().requires_grad_()
                             for k, v in bparams.items()}}
                out = fn(leaves["x"], {k: leaves[k] for k in bparams})
                grads = torch.autograd.grad((out * cot).sum(),
                                            list(leaves.values()))
            return dict(zip(leaves, grads))

        self.traced_counts(zero=True)
        gb = block_grads(blk["brainslug"])
        torch.cuda.synchronize()
        bcounts = self.traced_counts()
        gp = block_grads(cnn.block_fn)
        b_seq = blk["brainslug"].n_sequences
        self.expect_traced("23b block_fn", bcounts, b_seq,
                           fused_nhwc=b_seq, bwd_generated=b_seq,
                           fused_nhwc_bwd=b_seq)
        bworst = 0.0
        for k, w in gp.items():
            d = (gb[k] - w).abs()
            scale = float(w.abs().max())
            bworst = max(bworst, float(d.max()) / max(scale, 1e-30))
            if not bool(torch.isfinite(gb[k]).all()) or not bool(
                    (d <= TRAIN_RTOL * (w.abs() + scale)).all()):
                raise PhaseError(f"23b block_fn: gradient of {k} max|d| "
                                 f"{float(d.max()):.3e} (max|g| {scale:.3e})")
        report = blk["brainslug"].report()
        if report.capture_ratio != 1.0 or report.n_opaque:
            raise PhaseError(f"23b block_fn: {report}")
        print(f"[23b api.optimize(block_fn, differentiable=True), block_net"
              f"(8, 32) at {BLOCK_INPUT}, one step] gradients of x and every "
              f"parameter against autograd of the plain block_fn: max|d|/"
              f"max|g| {bworst:.3e} (tol rtol {TRAIN_RTOL}, atol "
              f"{TRAIN_RTOL}*max|g|); capture 1.0, {b_seq} sequences; "
              f"counters {bcounts}")

        # 23d (CNN): times in turns, and the traced call's host cost
        with torch.no_grad():
            fwd = {"traced": lambda: net(x, params),
                   "optimize_graph": lambda: gnet(x, params),
                   "barrier": lambda: bnet(x, params)}
            order = ("traced", "optimize_graph", "barrier", "barrier",
                     "optimize_graph", "traced")
            ms = [(m, self.cuda_ms(fwd[m], reps=1, groups=20))
                  for m in order]
            host = {m: self.host_ms(fwd[m]) for m in
                    ("traced", "optimize_graph")}

        def step(f):
            with torch.enable_grad():
                req = {k: v.detach().requires_grad_()
                       for k, v in params.items()}
                grads = torch.autograd.grad(F.cross_entropy(f(req), labels),
                                            list(req.values()))
            with torch.no_grad():
                return [v - TRAIN_LR * g for v, g in zip(req.values(), grads)]

        steps = {"traced": lambda: step(lambda p: tnets["brainslug"](x, p)),
                 "optimize_graph": lambda: step(lambda p: tgnet(x, p)),
                 "barrier": lambda: step(lambda p: tnets["barrier"](x, p))}
        step_ms = [(m, self.cuda_ms(steps[m], reps=1, groups=10))
                   for m in order]
        block_ms = [(m, self.cuda_ms(lambda m=m: block_grads(blk[m]), reps=1,
                                     groups=10))
                    for m in ("barrier", "brainslug", "brainslug", "barrier")]
        self.traced_ms = {"vgg_forward": ms, "vgg_step": step_ms,
                          "block_fn_step": block_ms, "host": host}
        print("[23d time] VGG-16 widths forward, median of 20 (CUDA events), "
              "in turns: " + "  ".join(f"{m}={v:.3f} ms" for m, v in ms))
        print("[23d time] VGG-16 widths training step (forward + backward + "
              "SGD), median of 10, in turns: "
              + "  ".join(f"{m}={v:.3f} ms" for m, v in step_ms))
        print(f"[23d time] block_fn, block_net(8, 32) at {BLOCK_INPUT}: "
              f"forward + backward, median of 10, in turns: "
              + "  ".join(f"{m}={v:.3f} ms" for m, v in block_ms))
        print(f"[23d host] one forward call's host time (enqueue on an idle "
              f"card, median of 20): OptimizedFn.__call__ "
              f"{host['traced']:.3f} ms, OptimizedNet.__call__ "
              f"{host['optimize_graph']:.3f} ms")
        del net, gnet, bnet, tnets, tgnet, blk, params, x, bx, cot, gb, gp
        gc.collect()
        torch.cuda.empty_cache()

        # 23c: the registry at deepseek-7b widths
        self.phase23_registry()
        print(f"[23] phase {time.perf_counter() - t:.1f} s")

    def phase23_registry(self):
        torch = self.torch
        import gc

        from repro_torch import api
        from repro_torch.models import lm
        heads, seq = 32, PREFILL[1]

        def block(x, p):
            return lm.transformer_block_fn(x, p, n_heads=heads)

        lines, limits = [], {"float32": 1e-4, "bfloat16": 2e-2}
        for dt_name, lim in limits.items():
            dt = getattr(torch, dt_name)
            p = lm.transformer_block_params(
                D_MODEL, heads, D_FF, generator=torch.Generator(
                    device=self.dev).manual_seed(23), dtype=dt,
                device=self.dev)
            x = self.randn((1, seq, D_MODEL), 24).to(dt)
            cot = self.randn((1, seq, D_MODEL), 25).to(dt)
            nets = {m: api.optimize(block, x, p, config=api.OptimizeConfig(
                mode=m, differentiable=True)) for m in ("brainslug",
                                                        "barrier")}
            report = nets["brainslug"].report()
            if report.kernel_hits != {"attention": 1, "rmsnorm": 2,
                                      "swiglu": 1} \
                    or report.kernel_fallbacks:
                raise PhaseError(f"23c {dt_name}: registry {report}")
            n_seq = nets["brainslug"].n_sequences
            with torch.no_grad():
                self.traced_counts(zero=True)
                y = nets["brainslug"](x, p)
                torch.cuda.synchronize()
                counts = self.traced_counts()
                yb = nets["barrier"](x, p)
            self.expect_traced(f"23c {dt_name}", counts, n_seq,
                               fused_rows=n_seq, flash_attention=1,
                               rmsnorm=2, swiglu=1)
            rel = float((y.float() - yb.float()).abs().max()) / float(
                yb.float().abs().max())
            if not bool(torch.isfinite(y).all()) or rel > lim:
                raise PhaseError(f"23c {dt_name}: brainslug vs barrier "
                                 f"max|d|/max|y| {rel:.3e} (tol {lim})")
            grads = {}
            for m in ("brainslug", "barrier"):
                if m == "brainslug":
                    self.traced_counts(zero=True)
                with torch.enable_grad():
                    leaves = {"x": x.clone().requires_grad_(),
                              **{k: v.clone().requires_grad_()
                                 for k, v in p.items()}}
                    out = nets[m](leaves["x"], {k: leaves[k] for k in p})
                    grads[m] = dict(zip(leaves, torch.autograd.grad(
                        (out.float() * cot.float()).sum(),
                        list(leaves.values()))))
                if m == "brainslug":
                    torch.cuda.synchronize()
                    gcounts = self.traced_counts()
            # the gradient pass: the forward again, then every sequence's
            # backward on fused_rows_bwd
            self.expect_traced(f"23c {dt_name} gradients", gcounts, n_seq,
                               fused_rows=n_seq, flash_attention=1,
                               rmsnorm=2, swiglu=1, bwd_generated=n_seq,
                               fused_rows_bwd=n_seq)
            gworst = 0.0
            for k, w in grads["barrier"].items():
                g = grads["brainslug"][k]
                if not bool(torch.isfinite(g).all()):
                    raise PhaseError(f"23c {dt_name}: non-finite grad {k}")
                r = float((g.float() - w.float()).abs().max()) / max(
                    float(w.float().abs().max()), 1e-30)
                gworst = max(gworst, r)
                if r > lim:
                    raise PhaseError(f"23c {dt_name}: gradient of {k} "
                                     f"max|d|/max|g| {r:.3e} (tol {lim})")
            lines.append(f"{dt_name}: max|d|/max|y| {rel:.3e}, gradients "
                         f"max|d|/max|g| {gworst:.3e} (tol {lim}); counters "
                         f"{counts}; gradient pass {gcounts}")
            for k in ("rmsnorm", "swiglu", "flash_attention", "fused_rows"):
                self.kernels[k][f"traced_launches_{dt_name}"] = counts[k]
            if dt_name == "bfloat16":
                with torch.no_grad():
                    ms = [(m, self.cuda_ms(lambda m=m: nets[m](x, p),
                                           reps=1, groups=10))
                          for m in ("barrier", "brainslug", "brainslug",
                                    "barrier")]
                self.traced_ms["block_bf16"] = ms
            del nets, p, x, cot, grads, y, yb, gcounts
            gc.collect()
            torch.cuda.empty_cache()
        print(f"[23c api.optimize(transformer_block_fn) deepseek-7b widths "
              f"(1, {seq}, {D_MODEL}), {heads} heads of 128, d_ff {D_FF}, "
              f"differentiable=True] registry attention 1, rmsnorm 2, swiglu "
              f"1, all hopper; brainslug against barrier (attention through "
              f"its plain version): " + "; ".join(lines))
        print("[23d time] the traced block bf16 forward, median of 10 (CUDA "
              "events), in turns: " + "  ".join(
                  f"{m}={v:.3f} ms" for m, v in self.traced_ms["block_bf16"]))
        self.phase23_ce()

    def phase23_ce(self):
        """``lm.ce_loss_fn`` through ``optimize`` at CE_SHAPE, bf16 (the
        registry's ``vocab_ce`` on ``fused_ce``) and float32.  The loss
        within 1e-4 of ``barrier``'s (the registry's REF entry), relative;
        the gradients within CE_GRAD_L2 in relative L2 distance (float32
        also every element within 1e-4 x max|g|), and in bf16 the limit's
        controls (``ce_grad_controls``)."""
        torch = self.torch
        from repro_torch import api
        from repro_torch.models import lm
        t, d, v = CE_SHAPE
        g = torch.Generator(device=self.dev).manual_seed(2330)
        labels = torch.randint(0, v, (t,), generator=g, device=self.dev)
        labels[torch.rand(t, generator=g, device=self.dev) < 0.1] = -1
        lines = []
        for dt in (torch.bfloat16, torch.float32):
            dt_name = str(dt).split(".")[-1]
            lim = CE_GRAD_L2[dt_name]
            h = self.randn((t, d), 31).to(dt)
            w = (self.randn((d, v), 32) / d ** 0.5).to(dt)
            nets = {m: api.optimize(lm.ce_loss_fn, h, w, labels,
                                    config=api.OptimizeConfig(
                                        mode=m, differentiable=True))
                    for m in ("brainslug", "barrier")}
            out = {}
            for m in ("brainslug", "barrier"):
                rep = nets[m].report()
                if rep.kernel_hits != {"vocab_ce": 1}:
                    raise PhaseError(f"23c ce {m}: registry {rep}")
                self.traced_counts(zero=True)
                with torch.enable_grad():
                    hs = [z.clone().requires_grad_() for z in (h, w)]
                    loss = nets[m](hs[0], hs[1], labels)
                    grads = torch.autograd.grad(loss, hs)
                torch.cuda.synchronize()
                out[m] = (float(loss.detach()), grads, self.traced_counts())
            (lb, gb, counts), (lr_, gr, _) = out["brainslug"], out["barrier"]
            n_seq = nets["brainslug"].n_sequences
            what = f"23c ce {dt_name}"
            self.expect_traced(what, counts, n_seq, fused_ce=1,
                               fused_rows=n_seq, bwd_generated=n_seq,
                               fused_rows_bwd=n_seq)
            if not math.isfinite(lb) or abs(lb - lr_) > 1e-4 * abs(lr_):
                raise PhaseError(f"{what}: loss {lb} vs barrier {lr_}")
            rels = []
            for name, a, b in zip(("dh", "dw"), gb, gr):
                if not bool(torch.isfinite(a).all()):
                    raise PhaseError(f"{what}: non-finite {name}")
                a, b = a.float(), b.float()
                diff = (a - b).abs()
                l2 = float(diff.norm() / b.norm())
                worst = float(diff.max() / b.abs().max())
                rels.append(f"{name} relative L2 {l2:.3e} (tol {lim}), "
                            f"max|d|/max|g| {worst:.3e}")
                if not l2 <= lim or (dt == torch.float32 and not worst <= 1e-4):
                    raise PhaseError(f"{what}: {name} outside its tolerance "
                                     f"({rels[-1]})")
            if dt == torch.bfloat16:
                self.kernels["fused_ce"]["traced_launches"] = \
                    counts["fused_ce"]
                rels.append(self.ce_grad_controls(h, w, labels, gr, lim))
            lines.append(f"{dt_name}: fused_ce launches "
                         f"{counts['fused_ce']}, registry "
                         f"{counts['registry']}; loss {lb} vs barrier {lr_}; "
                         + "; ".join(rels))
            del nets, out, h, w, gb, gr
            torch.cuda.empty_cache()
        print(f"[23c api.optimize(ce_loss_fn) {CE_SHAPE}, a tenth of the "
              f"labels masked, differentiable=True, against barrier (the "
              f"plain version through the registry's REF entry), loss tol "
              f"1e-4 relative, gradients {CE_GRAD_L2} in relative L2 "
              f"(float32 also max|d| 1e-4 x max|g|)] " + " | ".join(lines))

    def ce_grad_controls(self, h, w, labels, want, lim):
        """The bf16 CE tail's gradient limit against three twins of the
        masked-mean CE's (dh, dw), computed by hand in float32 and cast to
        bf16 as autograd casts them: sound, which must pass, and two whose
        backward takes a wrong row logsumexp, which must fail: rounded to
        bf16 (a kernel that keeps it in bf16) and 0.1% high."""
        torch = self.torch
        hf, wf = h.float(), w.float()
        logits = hf @ wf
        lse = torch.logsumexp(logits, -1, keepdim=True)
        valid = labels >= 0
        rows = valid.nonzero()[:, 0]
        # the traced gold log-probabilities are bf16, so their cotangent,
        # mask / count, reaches the CE in bf16
        scale = (valid.float() / max(int(valid.sum()), 1)).bfloat16() \
            .float()[:, None]
        l2 = {}
        for twin, lse_t in (("sound", lse),
                            ("lse in bf16", lse.bfloat16().float()),
                            ("lse 0.1% high", lse * 1.001)):
            p = torch.exp(logits - lse_t)
            p[rows, labels[rows]] -= 1.0
            p.mul_(scale)
            got = ((p @ wf.T).bfloat16(), (hf.T @ p).bfloat16())
            del p
            l2[twin] = [float((a.float() - b.float()).norm()
                              / b.float().norm()) for a, b in zip(got, want)]
            del got
        del logits, lse, hf, wf
        torch.cuda.empty_cache()
        line = "controls (dh, dw) relative L2: " + "; ".join(
            f"{twin} {', '.join(f'{x:.3e}' for x in v)}"
            for twin, v in l2.items())
        if max(l2["sound"]) > lim or any(
                max(v) <= lim for twin, v in l2.items() if twin != "sound"):
            raise PhaseError(f"23c ce bfloat16: the limit {lim} does not "
                             f"part the controls ({line})")
        return line

    # -- phase 24: the hybrid family (zamba2-7b) ------------------------------
    def hybrid_counters(self, zero=False):
        """Launch counts of every kernel on the hybrid's paths (the LM
        kernels, the SSD and rows kernels, the rows backward and the CE
        kernel) and ``plain``: the plain or reference dispatches of their
        wrappers (``zero`` sets all of them to 0)."""
        from repro_torch.kernels.attention import ops as aops
        from repro_torch.kernels.vocab_ce import ce
        from repro_torch.kernels.vocab_ce import ops as cops
        lm_c = self.lm_counters(zero)
        ssm_c = self.ssm_counters(zero)
        if zero:
            ce.fused_ce_fwd.launches = 0
            cops.STATS.reset()
        out = {k: lm_c[k] for k in ("rmsnorm", "swiglu", "flash_attention",
                                    "flash_decode", "paged_flash_decode")}
        out.update({k: ssm_c[k] for k in ("ssd_intra_chunk", "fused_rows",
                                          "fused_rows_bwd")})
        out["fused_ce"] = ce.fused_ce_fwd.launches
        out["plain"] = (ssm_c["plain"] + lm_c["swiglu_plain"]
                        + cops.STATS.counts["plain"]
                        + sum(v for k, v in aops.STATS.counts.items()
                              if k != "decode_kernel"
                              and k != "paged_decode_kernel"))
        return out

    def expect_hybrid(self, what, got, **launches):
        want = {k: 0 for k in got}
        want.update(launches)
        if got != want:
            raise PhaseError(f"{what}: counters {got}, expected {want}")

    def hybrid_group(self, low):
        """The hybrid path's kernel group of a kernel name, else None."""
        g = self.ssm_kernel(low)
        if g is not None:
            return g
        for frag, group in (("swiglu_kernel", "swiglu"),
                            ("flash_fwd_kernel", "flash_attention"),
                            ("paged_flash_decode_kernel",
                             "paged_flash_decode"),
                            ("flash_decode_kernel", "flash_decode"),
                            ("ce_tc_kernel", "fused_ce"),
                            ("ce_split_kernel", "fused_ce"),
                            ("ce_merge_kernel", "fused_ce")):
            if frag in low:
                return group
        return None

    def hybrid_trace_group(self, low):
        g = self.hybrid_group(low)
        if g is not None:
            return g
        if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
            return "matmul"
        return "other"

    @contextlib.contextmanager
    def hybrid_drop(self, n_super):
        """The planted defect: the first of every ``n_super`` applications
        of the shared attention block (the first of each forward or decode
        step) dropped in every mode's run while the block runs: the block
        adds nothing to the residual stream.  Yields a list whose length
        counts the applications dropped."""
        from repro_torch.models import lm
        saved = (lm._apply_sub, lm._decode_sub)
        seen, dropped = [0, 0], []

        def skip(resid, pending):
            dropped.append(1)
            return resid + pending, self.torch.zeros_like(pending)

        def apply(kind, p, resid, pending, *a, **kw):
            if kind == "shared_attn":
                seen[0] += 1
                if seen[0] % n_super == 1 % n_super:
                    return (*skip(resid, pending), None)
            return saved[0](kind, p, resid, pending, *a, **kw)

        def decode(kind, p, cache, resid, pending, *a, **kw):
            if kind == "shared_attn":
                seen[1] += 1
                if seen[1] % n_super == 1 % n_super:
                    return skip(resid, pending)
            return saved[1](kind, p, cache, resid, pending, *a, **kw)

        lm._apply_sub, lm._decode_sub = apply, decode
        try:
            yield dropped
        finally:
            lm._apply_sub, lm._decode_sub = saved

    def per_position(self, got, want):
        """Per position, max|d| over the vocabulary / max|want| there."""
        want = want.float()
        d = (got.float() - want).abs().amax(-1) / want.abs().amax(
            -1).clamp_min(1e-30)
        return d.flatten().tolist()

    def attention_kernels(self, d, heads, kv_heads, tag, seed,
                          full_causal=(True,), ragged=(2, 1000),
                          ragged_causal=(True, False), with_decode=True,
                          timed_causal=True, every_split=False):
        """The attention kernels at head dim ``d`` against their plain
        versions in bf16 and float32 (flash at (1, ``heads``, 2048) with
        ``full_causal`` and at ``ragged`` (batch, length) with
        ``ragged_causal`` over ``kv_heads`` KV heads, two launches bit for
        bit and bf16 within its P bound; with ``with_decode``, dense and
        paged decode at phase 14's ragged lengths, paged bit for bit with
        dense at every split: of the bf16 pair, or of every dtype pair with
        ``every_split``); their times at those shapes (flash at 2048,
        ``timed_causal``) beside bound, plain version and SDPA, kept as the
        kernels' ``head_dim_{d}`` entries."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.core.resource import H100
        from repro_torch.kernels.attention import decode, flash, ref
        t = time.perf_counter()
        bf, f32 = torch.bfloat16, torch.float32
        lines, flash_bound, lens = [], [], None
        for dt in (bf, f32):
            for (b, s_), causals in (((1, 2048), full_causal),
                                     (ragged, ragged_causal)):
                q = self.randn((b, heads, s_, d), seed).to(dt)
                k = self.randn((b, kv_heads, s_, d), seed + 1).to(dt)
                v = self.randn((b, kv_heads, s_, d), seed + 2).to(dt)
                for causal in causals:
                    what = f"D {d} {dt} {(b, heads, s_)} causal={causal}"
                    got = flash.flash_attention_fwd(q, k, v, causal=causal)
                    again = flash.flash_attention_fwd(q, k, v, causal=causal)
                    err = self.lm_check("flash_attention", what, got,
                                        flash.flash_attention_plain(
                                            q, k, v, causal=causal))
                    self.same_bits("flash_attention", what, {"o": got},
                                   {"o": again})
                    lines.append(f"flash {str(dt)[6:]} {(b, heads, s_, d)} "
                                 f"causal={causal} max|d| {err:.2e}")
                    if dt == bf:
                        top = max(float(got.float().abs().max()), 1e-30)
                        bound = (2.0 ** -18 * float(v.float().abs().max())
                                 + 2.0 ** (math.floor(math.log2(top)) - 7))
                        if not err <= bound:
                            raise PhaseError(f"flash_attention {what}: max|d|"
                                             f" {err:.3e} past the P bound "
                                             f"{bound:.3e}")
                        flash_bound.append(f"{err:.3e} (bound {bound:.3e})")
                del q, k, v
        # dense and paged decode at (8, heads, ragged up to 32768, d)
        for dt, pool_dt in ((bf, bf), (bf, f32), (f32, f32)) \
                if with_decode else ():
            q, kp, vp, table, lens = self.paged_operands(
                dt, pool_dt, heads, kv_heads, seed + 10, d=d)
            clipped = table.clamp(0, kp.shape[0] - 1)
            kd = ref.gather_paged(kp, clipped)
            vd = ref.gather_paged(vp, clipped)
            dense = decode.flash_decode(q, kd, vd, lens)
            err_d = self.lm_check("flash_decode", f"D {d} q {dt} cache "
                                  f"{pool_dt}", dense,
                                  decode.flash_decode_plain(q, kd, vd, lens))
            got = decode.paged_flash_decode(q, kp, vp, table, lens)
            err_p = self.lm_check("paged_flash_decode", f"D {d} q {dt} pool "
                                  f"{pool_dt}", got,
                                  decode.paged_flash_decode_plain(
                                      q, kp, vp, table, lens))
            if not (bool((got[0] == 0).all()) and bool((dense[0] == 0).all())):
                raise PhaseError(f"decode at D {d}: a length-0 slot is not "
                                 f"exactly zero")
            all_splits = every_split or dt == bf == pool_dt
            for s in (None,) + (decode.SPLITS if all_splits else ()):
                other = decode.paged_flash_decode(q, kp, vp, table, lens,
                                                  splits=s)
                torch.cuda.synchronize()
                if not torch.equal(other, dense):
                    raise PhaseError(
                        f"paged_flash_decode D {d} q {dt} pool {pool_dt} "
                        f"splits {s}: differs from flash_decode on the "
                        f"gathered view (max|d| "
                        f"{float((other.float() - dense.float()).abs().max()):.3e})")
            lines.append(f"decode q {str(dt)[6:]} cache {str(pool_dt)[6:]} "
                         f"max|d| dense {err_d:.2e} paged {err_p:.2e}, paged "
                         f"== dense bit for bit"
                         + (" at every split" if all_splits else ""))
            del q, kp, vp, kd, vd, dense, got, clipped
        torch.cuda.empty_cache()
        print(f"[{tag} kernels D {d}] against their plain versions (tol "
              f"{LM_TOL}; bf16 flash two launches bit for bit and within the "
              f"P bound: {', '.join(flash_bound)})"
              + (f", decode at ({PAGED['batch']}, {heads} heads over "
                 f"{kv_heads}, lengths {lens.tolist()}, {d}), block "
                 f"{PAGED['block']}, a shuffled table with sentinel tails, "
                 f"length 0 exactly zero" if with_decode else "")
              + ": " + "; ".join(lines)
              + f"; {time.perf_counter() - t:.1f} s")

        # times beside bound, plain version and SDPA
        def nbytes(*ts):
            return sum(x.numel() * x.element_size() for x in ts)

        s2 = PREFILL[1]
        q = self.randn((1, heads, s2, d), seed + 20).to(bf)
        k = self.randn((1, kv_heads, s2, d), seed + 21).to(bf)
        v = self.randn((1, kv_heads, s2, d), seed + 22).to(bf)
        causal = timed_causal
        pairs = s2 * (s2 + 1) // 2 if causal else s2 * s2
        t_ops = 4 * d * heads * pairs / PEAK_BF16 * 1e3
        t_by = nbytes(q, k, v, q) / H100.hbm_bandwidth * 1e3
        rows = {}
        with torch.inference_mode():
            run = lambda: flash.flash_attention_fwd(q, k, v, causal=causal)  # noqa: E731
            k_ms, how = self.kernel_ms(run, "flash_fwd_kernel")
            rows["flash_attention"] = dict(
                shape=f"(1, {heads}, {s2}, {d}) bf16 "
                + ("causal" if causal else "non-causal")
                + (f", {kv_heads} KV heads" if kv_heads != heads else ""),
                ms=k_ms, how=how,
                plain_ms=self.cuda_ms(lambda: flash.flash_attention_plain(
                    q, k, v, causal=causal), reps=1, groups=3, warmup=1),
                library_ms=self.cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal,
                        enable_gqa=kv_heads != heads)),
                bound_ms=max(t_ops, t_by),
                bound_by="operations" if t_ops >= t_by else "bytes")
        del q, k, v
        if not with_decode:
            self.print_times(tag, d, rows)
            return
        q, kp, vp, table, lens = self.paged_operands(
            bf, bf, heads, kv_heads, seed + 30, d=d)
        clipped = table.clamp(0, kp.shape[0] - 1)
        kd, vd = ref.gather_paged(kp, clipped), ref.gather_paged(vp, clipped)
        mask = (torch.arange(kd.shape[2], device=self.dev)[None, :]
                < lens[:, None])[:, None, None, :]
        b_ms, b_by = self.paged_bound(q, lens, kv_heads)
        shape = (f"({PAGED['batch']}, {heads}"
                 + (f" over {kv_heads}" if kv_heads != heads else "")
                 + f", lengths {lens.tolist()}, {d}) bf16")
        with torch.inference_mode():
            sdpa = self.cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kd, vd, attn_mask=mask, enable_gqa=kv_heads != heads))
            run = lambda: decode.flash_decode(q, kd, vd, lens)  # noqa: E731
            k_ms, how = self.kernel_ms(run, "flash_decode_kernel")
            db_ms, db_by = self.decode_bound(q, lens, kv_heads=kv_heads)
            rows["flash_decode"] = dict(
                shape=shape, ms=k_ms, how=how,
                plain_ms=self.cuda_ms(lambda: decode.flash_decode_plain(
                    q, kd, vd, lens), reps=1, groups=3, warmup=1),
                library_ms=sdpa, bound_ms=db_ms, bound_by=db_by,
                plan=self.dense_plan_note(q, kd)
                + (f"; before the redesign {DENSE_PARENT_MS['ragged_112']} "
                   f"ms" if d == 112 else ""))
            run = lambda: decode.paged_flash_decode(  # noqa: E731
                q, kp, vp, table, lens)
            k_ms, how = self.kernel_ms(run, "paged_flash_decode_kernel")
            rows["paged_flash_decode"] = dict(
                shape=shape + f", block {PAGED['block']}", ms=k_ms, how=how,
                plain_ms=self.cuda_ms(lambda: decode.paged_flash_decode_plain(
                    q, kp, vp, table, lens), reps=1, groups=3, warmup=1),
                library_ms=None, sdpa_gathered_ms=sdpa, bound_ms=b_ms,
                bound_by=b_by, plan=self.paged_plan_note(q, table, kp))
        del q, kp, vp, kd, vd, mask, clipped
        torch.cuda.empty_cache()
        self.print_times(tag, d, rows)

    def print_times(self, tag, d, rows):
        """The ``[tag times D d]`` lines of :meth:`attention_kernels`, each
        row kept as its kernel's ``head_dim_{d}`` entry, and every CUDA
        kernel's ptxas instances."""
        print(f"[{tag} times D {d}] device time per launch (profiler), plain "
              f"version and library call per call (events), bound (bytes "
              f"each input once and each output once, or operations at the "
              f"bf16 tensor-core rate counting {d} columns); {self.smi}:")
        for name, r in rows.items():
            lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
                   else f"none (SDPA on the gathered view, a note: "
                        f"{r['sdpa_gathered_ms']:.4f} ms)")
            print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms "
                  f"({r['how']})  plain {r['plain_ms']:.4f} ms  library "
                  f"{lib}  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
                  f"kernel/bound {r['ms'] / r['bound_ms']:.2f}"
                  + (f"; {r['plan']}" if "plan" in r else ""))
            self.kernels.setdefault(name, {})[f"head_dim_{d}"] = {
                k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")}
        for name, inst in (("flash_attention", self.flash_ptxas),
                           ("flash_decode", self.dense_ptxas),
                           ("paged_flash_decode", self.paged_ptxas),
                           ("fused_nhwc", self.nhwc_ptxas),
                           ("fused_nhwc_bwd", self.nhwc_bwd_ptxas),
                           ("fused_ce", self.ce_ptxas),
                           ("ssd_intra_chunk", self.ssd_ptxas)):
            self.kernels.setdefault(name, {})["instances"] = inst

    def hybrid_kernels(self, cfg):
        """24a: the three attention kernels at zamba2-7b's head dim 112
        (:meth:`attention_kernels`), the SSD kernel at its (112 heads, N 64)
        and the gated norm's rows kernel (and its backward, and rmsnorm) at
        its widths, each against its plain version; their times beside
        bound, plain version and a library call."""
        torch = self.torch
        from repro_torch.core.resource import H100
        from repro_torch.kernels.ssd import ssd
        self.attention_kernels(cfg.head_dim, PAGED["heads"], PAGED["heads"],
                               "24a", 2400)
        # the SSD kernel at zamba2's (1, 112 heads, 32 chunks, 64, 64), N 64
        shape_ = (1, cfg.ssm_heads, PREFILL[1] // 64, 64, cfg.ssm_head_dim,
                  cfg.ssm_state)
        b, h, nc, L, p, n = shape_
        ssd_lines = []
        for what, decay, seed in (("decays up to 0.5 a step", 0.5, 2440),
                                  ("overflowing decays", None, 2441)):
            dtx, a, Bm, Cm = self.ssd_operands(shape_, seed, decay)
            got = ssd.ssd_intra_chunk(dtx, a, Bm, Cm)
            again = ssd.ssd_intra_chunk(dtx, a, Bm, Cm)
            rel = self.ssd_check(f"zamba2 {what}", dict(zip("yS", got)),
                                 dict(zip("yS", ssd.ssd_intra_chunk_ref(
                                     dtx, a, Bm, Cm))))
            if not (torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])):
                raise PhaseError(f"ssd_intra_chunk zamba2 {what}: two "
                                 f"launches differ")
            ssd_lines.append(f"{what} max|d|/max(1, max|ref|) {rel:.3e}")
        dtx, a, Bm, Cm = self.ssd_operands(shape_, 2440, 0.5)
        run = lambda: ssd.ssd_intra_chunk(dtx, a, Bm, Cm)  # noqa: E731
        k_ms, how = self.kernel_ms(run, "ssd_intra_chunk_kernel")
        p_ms = self.cuda_ms(lambda: ssd.ssd_intra_chunk_ref(dtx, a, Bm, Cm))
        per_sm = ssd._ctas_per_sm(ssd._library(), L, n, p)
        plan = ssd.launch_plan(b, h, nc, self.sm_count, per_sm)
        cells = b * h * nc
        tri = L * (L + 1) // 2
        n_ops = 2 * (tri * n * b * nc + (tri * p + n * L * p) * cells)
        n_bytes = 4 * (2 * dtx.numel() + a.numel() + Bm.numel() + Cm.numel()
                       + cells * n * p)
        t_ops = n_ops / H100.peak_flops_f32 * 1e3
        t_bytes = n_bytes / H100.hbm_bandwidth * 1e3
        sb_ms, sb_by = (t_ops, "operations") if t_ops >= t_bytes else (
            t_bytes, "bytes")
        del dtx, a, Bm, Cm
        shape = f"({b}, {h}, {nc}, {L}, {p}), N {n}, float32"
        print(f"[24a ssd_intra_chunk] zamba2 {shape}, two launches bit for "
              f"bit: " + "; ".join(ssd_lines) + f" (tol {SSD_TOL} x max(1, "
              f"max|ref|)); kernel {k_ms:.4f} ms ({how}), plain {p_ms:.4f} "
              f"ms, library none, bound {sb_ms:.4f} ms ({sb_by}: "
              f"{n_bytes / 1e6:.1f} MB = {t_bytes:.4f} ms; {n_ops:.3e} float32"
              f" operations = {t_ops:.4f} ms), kernel/bound "
              f"{k_ms / sb_ms:.2f}; launch plan {plan.heads_per_cta} heads a "
              f"CTA, {plan.groups} groups, {plan.ctas} CTAs, {plan.waves} "
              f"wave(s)")
        self.kernels["ssd_intra_chunk"]["zamba2"] = {
            "shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": sb_ms,
            "bound_by": sb_by, "heads_per_cta": plan.heads_per_cta}
        # the gated norm's rows kernel (forward and backward) over d_inner
        # and rmsnorm over d_model, at zamba2's widths
        self.ssm_path_kernels(cfg, tag="24a", key="gated_norm_zamba2")

    def hybrid_blocks(self, params, cfg, tokens):
        """24b blocks: every block of the plan (the shared attention at each
        application) run alone on barrier's inputs to it, in brainslug, in
        barrier and in barrier with the planted defect (the first
        shared-attention application dropped), against the same block in
        float32 on the same inputs: the relative L2 distance of the block's
        output (the mixer's, or the shared block's MLP output, which
        carries its attention through the second norm).  brainslug within
        SSM_BLOCK_FACTOR x barrier's in every block; the defect flagged."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.layers import base
        from repro_torch.models import lm
        t = time.perf_counter()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        rts = {m: RuntimeConfig(mode=m) for m in ("brainslug", "barrier")}
        plan = lm.layer_plan(cfg)
        apply = lm._apply_sub                   # the sound block
        shared = params["shared_attn"]
        shared32 = base.cast_tree(shared, torch.float32)
        blocks = [(kind, p) for blk in lm._superblocks(params, plan)
                  for kind, p in zip(plan.superblock, blk)]
        if plan.tail:
            blocks += [("mamba", p) for p in lm._unstack(
                params["tail"]["sub0"], len(plan.tail))]
        dist = {r: [] for r in ("brainslug", "barrier", "control")}
        with torch.inference_mode():
            resid = lm.embed_inputs(params, {"tokens": tokens}, cfg)
            pending = torch.zeros_like(resid)
            with self.hybrid_drop(plan.n_super) as hit:
                for kind, p in blocks:
                    p32 = None if p is None else base.cast_tree(
                        p, torch.float32)
                    ref = apply(kind, p32, resid.float(), pending.float(),
                                cfg32, rts["barrier"], shared32)[1]
                    out = apply(kind, p, resid, pending, cfg,
                                rts["brainslug"], shared)[1]
                    dist["brainslug"].append(self.rel_l2([out], [ref]))
                    # the patched block drops the first shared application
                    out = lm._apply_sub(kind, p, resid, pending, cfg,
                                        rts["barrier"], shared)[1]
                    dist["control"].append(self.rel_l2([out], [ref]))
                    resid, pending, _ = apply(kind, p, resid, pending, cfg,
                                              rts["barrier"], shared)
                    dist["barrier"].append(self.rel_l2([pending], [ref]))
                    del ref, out, p32
        kinds = [k for k, _ in blocks]
        ratio = {r: [a / b for a, b in zip(d, dist["barrier"])]
                 for r, d in dist.items()}

        def summary(r, kind):
            d = [x for x, k in zip(dist[r], kinds) if k == kind]
            q = [x for x, k in zip(ratio[r], kinds) if k == kind]
            return (f"{kind} distance median {statistics.median(d):.3e} "
                    f"worst {max(d):.3e}, ratio median "
                    f"{statistics.median(q):.3f} worst {max(q):.3f}")

        print(f"[24b blocks] {cfg.name} bf16 prefill {PREFILL}, each of "
              f"{len(blocks)} blocks alone on barrier's inputs, relative L2 "
              f"distance of its output to the float32 block; brainslug "
              f"within {SSM_BLOCK_FACTOR}x barrier's in every block, the "
              f"control flagged past it: " + "; ".join(
                  f"{r}: {summary(r, 'mamba')}, {summary(r, 'shared_attn')}"
                  for r in dist)
              + f"; the control dropped {len(hit)} application(s), worst "
              f"ratio {max(ratio['control']):.1f} (block "
              f"{ratio['control'].index(max(ratio['control']))}); "
              f"{time.perf_counter() - t:.1f} s")
        if not max(ratio["brainslug"]) <= SSM_BLOCK_FACTOR:
            worst = ratio["brainslug"].index(max(ratio["brainslug"]))
            raise PhaseError(f"24b blocks: brainslug at "
                             f"{max(ratio['brainslug']):.3f}x barrier's "
                             f"distance to the float32 block ({kinds[worst]} "
                             f"block {worst})")
        if not hit or not max(ratio["control"]) > SSM_BLOCK_FACTOR:
            raise PhaseError("24b blocks: the dropped shared-attention "
                             "application is not flagged")

    def hybrid_full_depth(self, cfg):
        """24b, 24c and their times (24f): ``lm.prefill`` at full width and
        the depth of ``cfg`` (HYBRID["prefill_layers"]),
        ``Server.generate`` at HYBRID["serve_layers"]."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.launch import serve
        from repro_torch.layers import base
        from repro_torch.models import lm
        plan = lm.layer_plan(cfg)
        n_attn = plan.n_super
        n_mamba = plan.n_super * (len(plan.superblock) - 1) + len(plan.tail)
        n_rms = n_mamba + 2 * n_attn + 1
        t = time.perf_counter()
        params = lm.init(0, cfg, device=self.dev)
        torch.cuda.synchronize()
        print(f"[24 model] {cfg.name}: {cfg.n_layers} layers ({plan.n_super} "
              f"super-blocks of {len(plan.superblock) - 1} mamba blocks and "
              f"the shared attention, then a {len(plan.tail)}-layer mamba "
              f"tail), d_model {cfg.d_model}, {cfg.n_heads} heads of "
              f"{cfg.head_dim}, d_ff {cfg.d_ff}, mamba {cfg.ssm_heads} heads "
              f"of {cfg.ssm_head_dim}, N {cfg.ssm_state}, vocab "
              f"{cfg.vocab_size}, {cfg.dtype}: "
              f"{base.param_count(params) / 1e9:.3f} B random parameters "
              f"(seed 0) in {time.perf_counter() - t:.1f} s")
        rts = {m: RuntimeConfig(mode=m) for m in ("barrier", "brainslug")}
        g = torch.Generator(device=self.dev).manual_seed(2450)
        tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=g,
                               device=self.dev)
        batch = {"tokens": tokens}
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = base.cast_tree(params, torch.float32)

        # 24b: lm.prefill, counted; every position held through lm.forward
        t = time.perf_counter()
        with torch.inference_mode():
            want = lm.prefill(params, batch, cfg, rts["barrier"])
            torch.cuda.synchronize()
            self.hybrid_counters(zero=True)
            got = lm.prefill(params, batch, cfg, rts["brainslug"])
            torch.cuda.synchronize()
            counts = self.hybrid_counters()
            ref32 = lm.prefill(p32, batch, cfg32, rts["barrier"])
        self.expect_hybrid("zamba2 prefill", counts,
                           ssd_intra_chunk=n_mamba, flash_attention=n_attn,
                           rmsnorm=n_rms, swiglu=n_attn, fused_rows=n_mamba)
        self.hybrid_launches["prefill"] = counts
        if tuple(got.shape) != (1, 1, cfg.vocab_size) or not bool(
                torch.isfinite(got).all()):
            raise PhaseError(f"zamba2 prefill logits {tuple(got.shape)}")
        with torch.inference_mode():
            full32 = lm.forward(p32, batch, cfg32, rts["barrier"])[0]
            dist = {m: self.per_position(lm.forward(params, batch, cfg,
                                                    rts[m])[0], full32)
                    for m in ("brainslug", "barrier")}
            with self.hybrid_drop(n_attn) as hit:
                ctrl = self.per_position(lm.forward(
                    params, batch, cfg, rts["barrier"])[0], full32)
        del full32
        held = self.held_to_f32("zamba2 prefill bf16", dist["brainslug"],
                                dist["barrier"])
        flagged, read = self.control_flagged("zamba2 prefill control", ctrl,
                                             dist["barrier"])
        print(f"[24b lm.prefill {PREFILL} bf16] last-position logits: "
              f"brainslug vs barrier max|d|/max {self.relative(got, want):.3e}"
              f", argmax equal {bool(got.argmax() == want.argmax())}; to the "
              f"float32 logits: brainslug {self.relative(got, ref32):.3e}, "
              f"barrier {self.relative(want, ref32):.3e}; every position "
              f"through lm.forward, per-position max|d|/max {held}; counters "
              f"{counts}; {time.perf_counter() - t:.1f} s")
        print(f"[24b control] barrier bf16 with the first shared-attention "
              f"application of the forward dropped ({len(hit)} dropped), "
              f"every position to the float32 run: {read}, "
              f"{'flagged' if flagged else 'not flagged'} past "
              f"{SSM_F32_FACTOR}x barrier's (read: {cfg.n_layers} random "
              f"bf16 layers carry barrier itself far from float32; the "
              f"block check below must flag it)")
        del ref32, got, want
        self.hybrid_blocks(params, cfg, tokens)

        # 24c: Server.generate, dense cache, teacher-forced, at
        # HYBRID["serve_layers"] (views of the first super-blocks and tail
        # layers of the weights)
        cfg_s = dataclasses.replace(cfg, n_layers=HYBRID["serve_layers"])
        plan_s = lm.layer_plan(cfg_s)
        s_attn = plan_s.n_super
        s_mamba = (plan_s.n_super * (len(plan_s.superblock) - 1)
                   + len(plan_s.tail))
        s_rms = s_mamba + 2 * s_attn + 1
        params_s, p32_s = ({
            **tree,
            "blocks": base.tree_map(lambda a: a[:plan_s.n_super],
                                    tree["blocks"]),
            "tail": base.tree_map(lambda a: a[:len(plan_s.tail)],
                                  tree["tail"])} for tree in (params, p32))
        prompts = np.random.default_rng(2451).integers(
            0, cfg.vocab_size, (SERVE["batch"], SERVE["prompt_len"])
        ).astype(np.int32)
        t = time.perf_counter()
        servers, gens, counts = self.serve_pair(cfg_s, params_s, prompts,
                                                self.hybrid_counters)
        steps = SERVE["prompt_len"] + SERVE["new_tokens"] - 1
        self.expect_hybrid("zamba2 serving", counts,
                           flash_decode=s_attn * steps,
                           rmsnorm=s_rms * steps, swiglu=s_attn * steps,
                           fused_rows=s_mamba * steps)
        self.hybrid_launches["decode_step"] = {k: v // steps
                                               for k, v in counts.items()}
        serve_wall = {m: s.last_stats.wall_s for m, s in servers.items()}
        servers["float32"] = serve.Server(serve.ServeConfig(
            arch=cfg.name, reduced=False, mode="barrier",
            max_len=SERVE["prompt_len"] + SERVE["new_tokens"] + 1, **SERVE),
            params=p32_s,
            cfg=dataclasses.replace(cfg32, n_layers=cfg_s.n_layers))
        pairs = (("brainslug", "barrier"), ("brainslug", "float32"),
                 ("barrier", "float32"))
        logits = {}
        errs = self.teacher_forced(servers, prompts, gens["barrier"], pairs,
                                   steps=logits)
        held = self.held_to_f32("zamba2 serving bf16", errs[pairs[1]],
                                errs[pairs[2]])
        del logits
        agree = float((gens["brainslug"] == gens["barrier"]).mean())
        n_gen = servers["brainslug"].last_stats.generated_tokens
        d = errs[pairs[0]]
        print(f"[24c Server.generate bf16] {cfg_s.n_layers} of the "
              f"{cfg.n_layers} layers ({plan_s.n_super} super-block(s), a "
              f"{len(plan_s.tail)}-layer tail), {SERVE['batch']} requests, "
              f"prompt "
              f"{SERVE['prompt_len']}, {SERVE['new_tokens']} new tokens, "
              f"greedy, dense cache: token agreement brainslug vs barrier "
              f"{agree:.4f}; teacher-forced logits max|d|/max per step, "
              f"brainslug vs barrier worst {max(d):.3e}, median "
              f"{statistics.median(d):.3e}; {held}; wall " + ", ".join(
                  f"{m} {w:.3f} s ({n_gen / w:.2f} tok/s)"
                  for m, w in serve_wall.items())
              + f"; brainslug counters {counts}; "
              f"{time.perf_counter() - t:.1f} s")
        del servers, p32, params_s, p32_s

        # 24f: prefill and a decode step per mode, in turns; a trace of each
        with torch.inference_mode():
            cache = lm.init_decode_cache(cfg, SERVE["batch"], 97,
                                         dtype=torch.float32, device=self.dev)
        tok = tokens[:, :SERVE["batch"]].reshape(SERVE["batch"], 1)
        pos = SERVE["prompt_len"]

        def prefill(m):
            return lm.prefill(params, batch, cfg, rts[m])

        def step(m):
            for c in lm._caches(cache):
                if hasattr(c, "length"):
                    c.length.fill_(pos)
            return lm.decode_step(params, cache, tok, cfg, rts[m])

        with torch.inference_mode():
            pre = [(m, self.cuda_ms(lambda m=m: prefill(m), reps=1, groups=3,
                                    warmup=1))
                   for m in ("barrier", "brainslug", "brainslug", "barrier")]
            dec = [(m, self.cuda_ms(lambda m=m: step(m), reps=1, groups=5,
                                    warmup=1))
                   for m in ("barrier", "brainslug", "brainslug", "barrier")]
        print(f"[24f path] zamba2-7b bf16, {cfg.n_layers} layers: lm.prefill "
              f"{PREFILL}, median of 3 (CUDA events), in turns: "
              + "  ".join(f"{m}={v:.3f} ms ({PREFILL[1] / v:.1f} tok/ms)"
                          for m, v in pre))
        print(f"[24f path] one decode step at batch {SERVE['batch']}, position "
              f"{pos} (float32 cache as Server builds it), median of 5, in "
              f"turns: " + "  ".join(f"{m}={v:.3f} ms "
                                     f"({SERVE['batch'] / v * 1e3:.1f} tok/s)"
                                     for m, v in dec))
        expect = {"prefill": {"ssd_intra_chunk_kernel": n_mamba,
                              "flash_fwd_kernel": n_attn,
                              "rmsnorm_kernel": n_rms},
                  "decode step": {"flash_decode_kernel": n_attn,
                                  "rmsnorm_kernel": n_rms}}
        with torch.inference_mode():
            for what, fn in (("prefill", prefill), ("decode step", step)):
                for m in ("barrier", "brainslug"):
                    out = self.complete_trace(
                        lambda m=m: fn(m),
                        expect[what] if m == "brainslug" else None,
                        classify=self.hybrid_trace_group)
                    if out.startswith("incomplete"):
                        out += "; unchecked: " + self.trace(
                            lambda m=m: fn(m),
                            classify=self.hybrid_trace_group)
                    print(f"[24f trace {what} {m}] {out}")
        del params, cache
        import gc
        gc.collect()
        torch.cuda.empty_cache()

    def hybrid_float32_cut(self, cfg):
        """24b/24c at float32: zamba2-7b at full width with the CPU tests'
        cut (the shared attention every 3rd layer, 8 layers: two
        super-blocks and a 2-layer tail): the prefill's logits and
        ``Server.generate``'s teacher-forced logits within PATH_F32_REL,
        identical greedy tokens in both modes."""
        import dataclasses
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.models import lm
        torch = self.torch
        t = time.perf_counter()
        cfg8 = dataclasses.replace(cfg, attn_layer_period=3, n_layers=8,
                                   dtype="float32")
        plan = lm.layer_plan(cfg8)
        n_attn = plan.n_super
        n_mamba = plan.n_super * (len(plan.superblock) - 1) + len(plan.tail)
        p8 = lm.init(1, cfg8, device=self.dev)
        g = torch.Generator(device=self.dev).manual_seed(2452)
        tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=g,
                               device=self.dev)
        with torch.inference_mode():
            want, got = (lm.prefill(p8, {"tokens": tokens}, cfg8,
                                    RuntimeConfig(mode=m))
                         for m in ("barrier", "brainslug"))
        pre = self.relative(got, want)
        prompts = np.random.default_rng(2453).integers(
            0, cfg.vocab_size, (SERVE["batch"], SERVE["prompt_len"])
        ).astype(np.int32)
        servers, gens, counts = self.serve_pair(cfg8, p8, prompts,
                                                self.hybrid_counters)
        steps = SERVE["prompt_len"] + SERVE["new_tokens"] - 1
        self.expect_hybrid("zamba2 f32 serving", counts,
                           flash_decode=n_attn * steps,
                           rmsnorm=(n_mamba + 2 * n_attn + 1) * steps,
                           swiglu=n_attn * steps,
                           fused_rows=n_mamba * steps)
        if not np.array_equal(gens["brainslug"], gens["barrier"]):
            raise PhaseError("zamba2 f32 serving: brainslug's tokens differ "
                             "from barrier's")
        errs = self.teacher_forced(servers, prompts, gens["barrier"])[
            ("brainslug", "barrier")]
        if not max(errs + [pre]) <= PATH_F32_REL:
            raise PhaseError(f"zamba2 f32: logits max|d|/max prefill "
                             f"{pre:.3e}, serving worst {max(errs):.3e} > "
                             f"{PATH_F32_REL}")
        print(f"[24b/c float32, the CPU tests' cut at full width] "
              f"{cfg8.n_layers} layers, shared attention every "
              f"{cfg8.attn_layer_period}rd ({n_attn} super-blocks, a "
              f"{len(plan.tail)}-layer tail): prefill logits max|d|/max "
              f"{pre:.3e}; Server.generate brainslug == barrier tokens, "
              f"teacher-forced logits worst {max(errs):.3e} (tol "
              f"{PATH_F32_REL}); {time.perf_counter() - t:.1f} s")
        del servers, p8

    def hybrid_engine(self, cfg):
        """24d: ``Engine.run`` of 8 ragged requests, dense and paged, at
        full width cut to HYBRID["engine_layers"]."""
        torch = self.torch
        import dataclasses
        from repro_torch.layers import base
        from repro_torch.models import lm
        t = time.perf_counter()
        full = dataclasses.replace(cfg, n_layers=HYBRID["engine_layers"])
        params = lm.init(0, full, device=self.dev)
        plan = lm.layer_plan(full)
        n_attn = plan.n_super
        n_mamba = plan.n_super * (len(plan.superblock) - 1) + len(plan.tail)
        reqs = self.ssm_queue(cfg.vocab_size)
        results = {}
        for layout, mode in ENGINE_RUNS:
            eng, comps, counts, wall = self.engine_run(
                full, params, layout, mode, reqs,
                counters=self.hybrid_counters)
            results[(layout, mode)] = (eng, comps, wall)
            path = eng.report()["decode_path"]
            want = ((f"{self.dev.type}-paged-decode" if layout == "paged"
                     else f"{self.dev.type}-flash-decode")
                    if mode == "brainslug"
                    else ("ref-paged-decode" if layout == "paged"
                          else "ref-decode"))
            if path != want:
                raise PhaseError(f"zamba2 engine {layout} {mode}: decode path "
                                 f"{path}, expected {want}")
            if eng.prefix_sharing:
                raise PhaseError("zamba2 engine: prefix sharing is on")
            if mode == "brainslug":
                e = self.evaluations(eng.last_stats)
                kw = {"paged_flash_decode" if layout == "paged"
                      else "flash_decode": n_attn * e}
                self.expect_hybrid(f"zamba2 engine {layout}", counts,
                                   rmsnorm=(n_mamba + 2 * n_attn + 1) * e,
                                   swiglu=n_attn * e,
                                   fused_rows=n_mamba * e, **kw)
                if layout == "paged":
                    self.hybrid_launches["engine_evaluation"] = {
                        k: v // e for k, v in counts.items()}
        pb = results[("paged", "brainslug")][1]
        db = results[("dense", "brainslug")][1]
        pr = results[("paged", "barrier")][1]
        for i in range(len(reqs)):
            if not np.array_equal(pb[i].tokens, db[i].tokens):
                raise PhaseError(f"zamba2 engine: paged and dense brainslug "
                                 f"differ on request {i}")
        n_tok = sum(len(c.tokens) for c in pr)
        agree = sum(int((a.tokens == c.tokens).sum())
                    for a, c in zip(pb, pr)) / max(n_tok, 1)
        pick = list(range(4))
        seqs = [list(reqs[i].prompt) + pr[i].tokens.tolist() for i in pick]
        starts = [len(reqs[i].prompt) for i in pick]
        forced = {m: self.forced_logits(full, params, m, seqs, starts)
                  for m in ("brainslug", "barrier")}
        forced["float32"] = self.forced_logits(
            dataclasses.replace(full, dtype="float32"),
            base.cast_tree(params, torch.float32), "barrier", seqs, starts)
        pairs = (("brainslug", "barrier"), ("brainslug", "float32"),
                 ("barrier", "float32"))
        errs = {(a, b): [self.relative(x, y) for x, y in zip(forced[a],
                                                             forced[b])]
                for a, b in pairs}
        held = self.held_to_f32("zamba2 engine bf16", errs[pairs[1]],
                                errs[pairs[2]])
        d = errs[pairs[0]]
        print(f"[24d engine] {cfg.name} bf16, {full.n_layers} layers "
              f"({plan.n_super} super-block(s), a {len(plan.tail)}-layer tail), "
              f"Engine(slots {ENGINE['slots']}, max_len {ENGINE['max_len']}, "
              f"prefill_chunk {ENGINE['prefill_chunk']}, verify strict), "
              f"{len(reqs)} requests (prompts {MAMBA_ENGINE['prompt']}, new "
              f"tokens {MAMBA_ENGINE['stops']}): every request completed in "
              f"all three runs, no kv.* finding, the free list whole, prefix "
              f"sharing off, decode paths cuda-paged-decode / "
              f"cuda-flash-decode; paged == dense brainslug tokens; vs paged "
              f"barrier token agreement {agree:.4f}, teacher-forced logits "
              f"max|d|/max vs barrier worst {max(d):.3e}, median "
              f"{statistics.median(d):.3e}; {held}; counters per model "
              f"evaluation {self.hybrid_launches['engine_evaluation']}; "
              f"{time.perf_counter() - t:.1f} s")
        for (layout, mode), (eng, comps, wall) in results.items():
            st = eng.last_stats
            print(f"[24d engine {layout} {mode}] wall {wall:.3f} s, "
                  f"{st.generated_tokens} tokens "
                  f"({st.generated_tokens / wall:.2f} tok/s), "
                  f"{self.evaluations(st)} model evaluations, TTFT "
                  f"p50 {st.ttft_p50_ms:.1f} ms p99 {st.ttft_p99_ms:.1f} ms; "
                  f"ServeStats {json.dumps(st.as_dict())}")
        del results, forced, params
        torch.cuda.empty_cache()

    def hybrid_grad_anchor(self, layers):
        """24e: the step-1 gradient of the trainer's loss over every
        parameter (the seed-0 weights drawn in bf16, the first batch) in
        brainslug and barrier, its relative L2 distance to the float32
        gradient of the same weights (all parameters, and ``shared_attn``'s
        alone); brainslug's within SSM_F32_FACTOR x barrier's."""
        torch = self.torch
        import gc
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.data import pipeline
        from repro_torch.layers import base
        from repro_torch.models import lm
        t = time.perf_counter()

        def grads(mode, dtype):
            trainer = self.lm_trainer(mode, layers, dtype,
                                      arch=HYBRID["arch"],
                                      init_dtype="bfloat16",
                                      remat=HYBRID["remat"])
            params, cfg = trainer.params, trainer.cfg
            batch = {k: torch.from_numpy(x).to(self.dev) for k, x in
                     pipeline.synth_batch(cfg, trainer.shape, 0, 0).items()}
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            with torch.enable_grad():
                live = base.tree_map(lambda p: p.detach().requires_grad_(),
                                     params)
                loss, _ = lm.loss_fn(live, batch, cfg, RuntimeConfig(
                    mode=mode, remat=HYBRID["remat"]))
                names = [k for k in sorted(live) for _ in
                         base.tree_leaves(live[k])]
                out = torch.autograd.grad(loss, base.tree_leaves(live))
            return float(loss.detach()), out, names

        loss32, g32, names = grads("barrier", "float32")
        shared = [i for i, n in enumerate(names) if n == "shared_attn"]
        dist, loss = {}, {}
        for m in ("brainslug", "barrier"):
            loss[m], g, _ = grads(m, "bfloat16")
            dist[m] = (self.rel_l2(g, g32),
                       self.rel_l2([g[i] for i in shared],
                                   [g32[i] for i in shared]))
            del g
        del g32
        gc.collect()
        torch.cuda.empty_cache()
        ratio = dist["brainslug"][0] / dist["barrier"][0]
        print(f"[24e step-1 gradient] {layers} layers bf16, every parameter, "
              f"relative L2 distance to the float32 gradient of the same "
              f"weights (loss {loss32}): brainslug {dist['brainslug'][0]:.4e} "
              f"(loss {loss['brainslug']}), barrier "
              f"{dist['barrier'][0]:.4e} (loss {loss['barrier']}), brainslug "
              f"at {ratio:.3f}x barrier's (tol {SSM_F32_FACTOR}x); "
              f"shared_attn's ({len(shared)} leaves, the sum over its "
              f"applications) brainslug {dist['brainslug'][1]:.4e}, barrier "
              f"{dist['barrier'][1]:.4e}; {time.perf_counter() - t:.1f} s")
        if not ratio <= SSM_F32_FACTOR:
            raise PhaseError(f"zamba2 step-1 gradient: brainslug's distance "
                             f"to float32 {dist['brainslug'][0]:.4e} > "
                             f"{SSM_F32_FACTOR} x barrier's "
                             f"{dist['barrier'][0]:.4e}")

    def hybrid_train(self, cfg):
        """24e and the training step's times (24f): ``Trainer.run`` at full
        width cut to HYBRID["train_layers"]."""
        torch = self.torch
        import shutil
        import tempfile
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.data import pipeline
        from repro_torch.distributed import fault_tolerance as ft
        from repro_torch.launch import steps as steps_mod
        from repro_torch.models import lm
        from repro_torch.optim import adamw
        import dataclasses
        t = time.perf_counter()
        L = HYBRID["train_layers"]
        plan = lm.layer_plan(dataclasses.replace(cfg, n_layers=L))
        n_attn = plan.n_super
        n_mamba = plan.n_super * (len(plan.superblock) - 1) + len(plan.tail)
        kw = dict(arch=HYBRID["arch"], remat=HYBRID["remat"],
                  counters=self.hybrid_counters)
        runs = {}
        for mode in ("brainslug", "barrier"):
            hist, per_step, peak, wall = self.train_lm(mode, L, "bfloat16",
                                                       **kw)
            for i, got in enumerate(per_step):
                if mode == "brainslug":
                    # remat "full": every block's forward runs twice (the
                    # final norm once), its backward once
                    self.expect_hybrid(
                        f"zamba2 train step {i + 1}", got,
                        ssd_intra_chunk=2 * n_mamba,
                        flash_attention=2 * n_attn,
                        rmsnorm=2 * (n_mamba + 2 * n_attn) + 1,
                        swiglu=2 * n_attn, fused_rows=2 * n_mamba,
                        fused_rows_bwd=n_mamba, fused_ce=1)
                else:
                    self.expect_hybrid(f"zamba2 train barrier step {i + 1}",
                                       got)
            runs[mode] = (hist, per_step, peak, wall)
        self.hybrid_launches["train_step"] = runs["brainslug"][1][0]
        runs["float32"] = self.train_lm("barrier", L, "float32",
                                        init_dtype="bfloat16", **kw)
        losses = {m: [h["loss"] for h in r[0]] for m, r in runs.items()}
        gnorms = {m: [h["grad_norm"] for h in r[0]] for m, r in runs.items()}
        if not all(math.isfinite(x) for dd in (losses, gnorms)
                   for v in dd.values() for x in v):
            raise PhaseError(f"zamba2 train: losses {losses}, grad norms "
                             f"{gnorms}")
        print(f"[24e train bf16] zamba2-7b at full width, {L} layers "
              f"({plan.n_super} super-block(s), a {len(plan.tail)}-layer tail), "
              f"remat {HYBRID['remat']}, 1 x {TRAIN_LM['seq']} tokens, "
              f"{TRAIN_LM['steps']} AdamW steps lr {TRAIN_LM['lr']} through "
              f"build_trainer / Trainer.run: " + "; ".join(
                  f"{m} losses {losses[m]} grad_norm {gnorms[m]} peak "
                  f"{runs[m][2]:.2f} GiB wall {runs[m][3]:.1f} s"
                  for m in runs)
              + f" (read, not held: agreement is held on the step-1 "
              f"gradient); brainslug counters per step "
              f"{runs['brainslug'][1][0]}")
        self.hybrid_grad_anchor(L)

        # kill at step 2, resume from the step-1 checkpoint, at
        # HYBRID["resume_layers"] (the resumed run writes only its final
        # checkpoint)
        Lr = HYBRID["resume_layers"]
        full = self.train_lm("brainslug", Lr, "bfloat16", **kw)[0]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
            free = shutil.disk_usage(d).free / 2 ** 30
            try:
                self.train_lm("brainslug", Lr, "bfloat16",
                              failure=ft.failure_injector({2}), ckpt_dir=d,
                              ckpt_every=1, **kw)
            except ft.SimulatedFailure:
                pass
            else:
                raise PhaseError("zamba2 kill/resume: the injected failure "
                                 "at step 2 did not happen")
            resumed, _, _, wall = self.train_lm(
                "brainslug", Lr, "bfloat16", ckpt_dir=d,
                ckpt_every=TRAIN_LM["steps"], **kw)
        if [h["step"] for h in resumed] != [2] or \
                resumed[-1]["loss"] != full[-1]["loss"]:
            raise PhaseError(f"zamba2 kill/resume: resumed {resumed}, "
                             f"uninterrupted step-3 loss {full[-1]['loss']}")
        print(f"[24e kill/resume] bf16 {Lr} layers brainslug: killed at step "
              f"2, resumed from the step-1 checkpoint ({free:.0f} GiB free in "
              f"the temp dir): step-3 loss {resumed[-1]['loss']} equals the "
              f"uninterrupted run's bit for bit; resume run {wall:.1f} s; "
              f"{time.perf_counter() - t:.1f} s")

        # 24f: the step per mode, in turns, on one model and state
        trainer = self.lm_trainer("brainslug", L, "bfloat16",
                                  arch=HYBRID["arch"], remat=HYBRID["remat"])
        opt_cfg = adamw.AdamWConfig(lr=TRAIN_LM["lr"])
        fns = {m: steps_mod.make_train_step(
            trainer.cfg, RuntimeConfig(mode=m, remat=HYBRID["remat"]),
            opt_cfg) for m in ("barrier", "brainslug")}
        batch = {k: torch.from_numpy(x).to(self.dev) for k, x in
                 pipeline.synth_batch(trainer.cfg, trainer.shape, 0,
                                      0).items()}

        def step(m):
            trainer.params, trainer.opt_state, _ = fns[m](
                trainer.params, trainer.opt_state, batch)

        def timed(m):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(m)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

        for m in fns:
            step(m)                                     # warm-up
        turns = [(m, timed(m)) for m in ("barrier", "brainslug", "brainslug",
                                         "barrier")]
        print(f"[24f train step] zamba2-7b {L} layers bf16 remat "
              f"{HYBRID['remat']}, 1 x {TRAIN_LM['seq']} tokens, forward + "
              f"backward + AdamW, one step each (host clock around "
              f"synchronised steps), in turns: "
              + "  ".join(f"{m}={ms:.1f} ms ({TRAIN_LM['seq'] / ms:.2f} "
                          f"tok/ms)" for m, ms in turns))
        for m in ("barrier", "brainslug"):
            print(f"[24f trace train step {m}] " + self.train_trace(
                lambda m=m: step(m), classify=self.hybrid_group))
        del trainer, fns, batch
        torch.cuda.empty_cache()

    def phase24_hybrid(self):
        from repro_torch.configs import get_config
        cfg = get_config(HYBRID["arch"])
        t = time.perf_counter()
        self.hybrid_launches = {}       # per prefill, step, evaluation
        self.hybrid_kernels(cfg)
        self.hybrid_full_depth(dataclasses.replace(
            cfg, n_layers=HYBRID["prefill_layers"]))
        self.hybrid_float32_cut(cfg)
        self.hybrid_engine(cfg)
        self.hybrid_train(cfg)
        la = self.hybrid_launches
        for name, where in (("flash_attention", ("prefill", "train_step")),
                            ("flash_decode", ("decode_step",)),
                            ("paged_flash_decode", ("engine_evaluation",)),
                            ("ssd_intra_chunk", ("prefill", "train_step"))):
            entry = self.kernels[name]["zamba2" if name == "ssd_intra_chunk"
                                       else "head_dim_112"]
            entry["launches"] = {w: la[w][name] for w in where}
            entry["max_abs_err"] = self.err[name]
        print(f"[24 launches] zamba2-7b per prefill {la['prefill']}; per "
              f"decode step {la['decode_step']}; per engine model evaluation "
              f"(paged, {HYBRID['engine_layers']} layers) "
              f"{la['engine_evaluation']}; per training step "
              f"({HYBRID['train_layers']} layers) {la['train_step']}; phase "
              f"{time.perf_counter() - t:.1f} s")

    # -- phase 25: the MoE family ---------------------------------------------
    @contextlib.contextmanager
    def moe_routing(self, replay=None, renorm=True):
        """Patches ``moe.route``: every call's (token, choice) expert ids are
        recorded in call order (the yielded list).  With ``replay`` (such a
        list) each call takes the ids recorded at its turn, its gate weights
        its own probabilities of them, renormalised: the run makes the
        recorded run's discrete decisions and its own arithmetic.
        ``renorm=False`` plants a defect: the gate weights are the raw
        top-k probabilities."""
        torch = self.torch
        from repro_torch.layers import moe
        saved = moe.route
        seen = []

        def route(router, xf, k):
            probs, gate_w, idx = saved(router, xf, k)
            if replay is not None:
                want = replay[len(seen)]
                if want.shape != idx.shape:
                    raise PhaseError(f"routing replay: call {len(seen)} "
                                     f"takes {tuple(idx.shape)}, the record "
                                     f"holds {tuple(want.shape)}")
                idx = want
            if replay is not None or not renorm:
                gate_w = torch.gather(probs, -1, idx)
                if renorm:
                    gate_w = gate_w / torch.clamp_min(
                        gate_w.sum(-1, keepdim=True), 1e-9)
            seen.append(idx)
            return probs, gate_w, idx

        moe.route = route
        try:
            yield seen
        finally:
            moe.route = saved

    @contextlib.contextmanager
    def moe_drop(self, layer, n_moe):
        """The planted defect: the output of MoE block ``layer`` of every
        forward or decode step (every ``n_moe`` calls of ``moe.apply``)
        dropped, so the block adds nothing to the residual stream.  Yields a
        list whose length counts the outputs dropped."""
        torch = self.torch
        from repro_torch.layers import moe
        saved = moe.apply
        calls, hit = [0], []

        def apply(params, x, cfg, rt, **kw):
            y, aux = saved(params, x, cfg, rt, **kw)
            calls[0] += 1
            if (calls[0] - 1) % n_moe == layer:
                hit.append(1)
                return torch.zeros_like(y), aux
            return y, aux

        moe.apply = apply
        try:
            yield hit
        finally:
            moe.apply = saved

    @contextlib.contextmanager
    def moe_control(self, name, n_moe, replay=None, layer=MOE["drop_layer"]):
        """One of MOE_CONTROLS planted in a run whose routing is recorded
        (or replayed from ``replay``); the dropped output is that of the
        ``layer``-th of every ``n_moe`` calls.  Yields (a list whose length
        counts the calls the defect touched, the routing record)."""
        if name == MOE_CONTROLS[0]:
            with self.moe_drop(layer, n_moe) as hit, \
                    self.moe_routing(replay=replay) as rec:
                yield hit, rec
        else:
            with self.moe_routing(replay=replay, renorm=False) as rec:
                yield rec, rec

    @contextlib.contextmanager
    def decode_logits(self):
        """Patches ``lm.decode_step``: every step's logits in float32, in
        call order (the yielded list)."""
        from repro_torch.models import lm
        saved = lm.decode_step
        seen = []

        def step(*a, **kw):
            logits, cache = saved(*a, **kw)
            seen.append(logits[:, 0].float())
            return logits, cache

        lm.decode_step = step
        try:
            yield seen
        finally:
            lm.decode_step = saved

    @staticmethod
    def routing_agreement(a, b):
        """Per call, the share of ``a``'s (token, choice) decisions that
        ``b`` made too (a token's choices compared as sets)."""
        return [float((x[..., :, None] == y[..., None, :]).any(-1).float()
                      .mean()) for x, y in zip(a, b)]

    @staticmethod
    def agreement_note(per_call, n_moe):
        """Per MoE layer (calls cycle over the layers), the mean share of
        decisions that agree, as a phrase."""
        layers = [statistics.mean(per_call[i::n_moe]) for i in range(n_moe)]
        return (f"min {min(layers):.4f}, mean {statistics.mean(layers):.4f} "
                f"over {n_moe} layers: "
                + " ".join(f"{x:.4f}" for x in layers))

    def moe_counts(self, cfg):
        """(MoE layers, attention layers, rms norms, swiglu launches) of one
        forward of ``cfg``: a swiglu for every dense MLP, every expert batch
        and every shared expert."""
        from repro_torch.models import lm
        plan = lm.layer_plan(cfg)
        n_moe = plan.n_super
        n_attn = cfg.n_layers
        n_swiglu = n_attn + (n_moe if cfg.shared_expert_ff else 0)
        return n_moe, n_attn, 2 * n_attn + 1, n_swiglu

    def moe_prefill(self, cfg, params, tag):
        """``lm.prefill`` (1, 2048) per mode: counters, two brainslug
        prefills bit for bit, the routing agreement per layer, drop
        fractions; brainslug held to barrier at phase 12's direct limits
        with barrier taking brainslug's routing decisions.  Returns the
        tokens, both modes' decisions and brainslug's counters."""
        torch = self.torch
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.models import lm
        n_moe, n_attn, n_rms, n_swiglu = self.moe_counts(cfg)
        rts = {m: RuntimeConfig(mode=m) for m in ("barrier", "brainslug")}
        g = torch.Generator(device=self.dev).manual_seed(2500)
        tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=g,
                               device=self.dev)
        batch = {"tokens": tokens}
        t = time.perf_counter()
        with torch.inference_mode():
            with self.moe_routing() as rec_r:
                want = lm.prefill(params, batch, cfg, rts["barrier"])
            torch.cuda.synchronize()
            self.hybrid_counters(zero=True)
            with self.moe_routing() as rec_b:
                got = lm.prefill(params, batch, cfg, rts["brainslug"])
            torch.cuda.synchronize()
            counts = self.hybrid_counters()
            again = lm.prefill(params, batch, cfg, rts["brainslug"])
            with self.moe_routing(replay=rec_b):
                forced = lm.prefill(params, batch, cfg, rts["barrier"])
            aux = {m: lm.hidden(params, batch, cfg, rts[m])[1]
                   for m in rts}
        self.expect_hybrid(f"{cfg.name} prefill", counts,
                           flash_attention=n_attn, rmsnorm=n_rms,
                           swiglu=n_swiglu)
        if tuple(got.shape) != (1, 1, cfg.vocab_size) or not bool(
                torch.isfinite(got).all()):
            raise PhaseError(f"{cfg.name} prefill logits {tuple(got.shape)}")
        if not torch.equal(got, again):
            raise PhaseError(f"{cfg.name} prefill: two brainslug prefills "
                             f"differ in bits")
        rel = self.relative(got, forced)
        same_top = bool(got.argmax() == forced.argmax())
        if not (rel <= PATH_BF16_REL and same_top):
            raise PhaseError(f"{cfg.name} prefill: brainslug vs barrier on "
                             f"brainslug's routing max|d|/max {rel:.3e} (tol "
                             f"{PATH_BF16_REL}), argmax equal {same_top}")
        agree = self.routing_agreement(rec_b, rec_r)
        drops = {m: float(a["drop_fraction"]) / n_moe for m, a in aux.items()}
        print(f"[{tag} lm.prefill {PREFILL} bf16] {cfg.name}, "
              f"{cfg.n_layers} layers: last-position logits brainslug vs "
              f"barrier on brainslug's routing max|d|/max {rel:.3e} (tol "
              f"{PATH_BF16_REL}), argmax equal {same_top}; on each mode's own "
              f"routing {self.relative(got, want):.3e}, argmax equal "
              f"{bool(got.argmax() == want.argmax())}; two brainslug "
              f"prefills bit for bit; (token, choice) decisions brainslug and "
              f"barrier share, per MoE layer: "
              f"{self.agreement_note(agree, n_moe)}; drop_fraction a layer "
              + ", ".join(f"{m} {v:.5f}" for m, v in drops.items())
              + f" (router_aux_loss summed over the layers "
              + ", ".join(f"{m} {float(a['router_aux_loss']):.4f}"
                          for m, a in aux.items())
              + f"); counters {counts}; {time.perf_counter() - t:.1f} s")
        return tokens, rec_b, rec_r, counts

    def moe_anchor(self, cfg, params, tokens, rec_b, rec_r):
        """25b through float32: every position's logits of brainslug and of
        barrier against the float32 run of the same weights taking that
        mode's routing decisions; brainslug within SSM_F32_FACTOR x
        barrier's distance, worst and median; the controls read the same
        way (the dropped layer must be flagged here and by the direct
        limit)."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.layers import base
        from repro_torch.models import lm
        t = time.perf_counter()
        n_moe = self.moe_counts(cfg)[0]
        rts = {m: RuntimeConfig(mode=m) for m in ("barrier", "brainslug")}
        batch = {"tokens": tokens}
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = base.cast_tree(params, torch.float32)
        dist, direct, notes = {}, {}, []
        with torch.inference_mode():
            got = lm.forward(params, batch, cfg, rts["brainslug"])[0]

            def anchored(logits, rec):
                with self.moe_routing(replay=rec):
                    ref = lm.forward(p32, batch, cfg32, rts["barrier"])[0]
                return self.per_position(logits, ref)

            dist["brainslug"] = anchored(got, rec_b)
            dist["barrier"] = anchored(lm.forward(params, batch, cfg,
                                                  rts["barrier"])[0], rec_r)
            with self.moe_routing(replay=rec_b):
                forced = lm.forward(params, batch, cfg, rts["barrier"])[0]
            direct["barrier"] = self.per_position(got, forced)
            for name in MOE_CONTROLS:
                with self.moe_control(name, n_moe) as (hit, rec_c):
                    ctrl = lm.forward(params, batch, cfg, rts["barrier"])[0]
                dist[name] = anchored(ctrl, rec_c)
                with self.moe_control(name, n_moe, replay=rec_b):
                    ctrl = lm.forward(params, batch, cfg,
                                      rts["barrier"])[0]
                direct[name] = self.per_position(got, ctrl)
                notes.append((name, len(hit)))
            del got, forced, ctrl
        del p32
        torch.cuda.empty_cache()
        held = self.held_to_f32(f"{cfg.name} prefill bf16", dist["brainslug"],
                                dist["barrier"])
        d = direct["barrier"]
        print(f"[25b through float32] every position of the (1, 2048) "
              f"forward, max|d|/max per position: brainslug vs barrier on "
              f"brainslug's routing worst {max(d):.3e} median "
              f"{statistics.median(d):.3e}; each mode against the float32 "
              f"run on its own routing decisions: {held}; "
              f"{time.perf_counter() - t:.1f} s")
        for name, n_hit in notes:
            flagged, read = self.control_flagged(name, dist[name],
                                                 dist["barrier"])
            last = direct[name][-1]
            print(f"[25b control] barrier with {name} ({n_hit} hit): to "
                  f"float32 {read}, {'flagged' if flagged else 'not flagged'}"
                  f" past {SSM_F32_FACTOR}x; to brainslug on brainslug's "
                  f"routing, last position {last:.3e}, worst "
                  f"{max(direct[name]):.3e}, "
                  f"{'flagged' if last > PATH_BF16_REL else 'not flagged'} "
                  f"past {PATH_BF16_REL}")
            if name in MOE_END_TO_END and not (flagged
                                               and last > PATH_BF16_REL):
                raise PhaseError(f"25b: the control '{name}' is not flagged "
                                 f"end to end")

    def moe_blocks(self, params, cfg, tokens):
        """25b blocks: every block alone on barrier's inputs to it, its
        routing decisions barrier's there, in brainslug, barrier and
        barrier with each planted defect, against the float32 block on the
        same inputs and decisions: the relative L2 distance of the block's
        MoE output (it carries the block's attention through the second
        norm); brainslug within SSM_BLOCK_FACTOR x barrier's in every
        block, each defect flagged past it."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.layers import base
        from repro_torch.models import lm
        t = time.perf_counter()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        rts = {m: RuntimeConfig(mode=m) for m in ("brainslug", "barrier")}
        plan = lm.layer_plan(cfg)
        blocks = [(kind, p) for blk in lm._superblocks(params, plan)
                  for kind, p in zip(plan.superblock, blk)]
        apply = lm._apply_sub
        dist = {r: [] for r in ("brainslug", "barrier") + MOE_CONTROLS}
        touched = {name: 0 for name in MOE_CONTROLS}
        with torch.inference_mode():
            resid = lm.embed_inputs(params, {"tokens": tokens}, cfg)
            pending = torch.zeros_like(resid)
            for i, (kind, p) in enumerate(blocks):
                with self.moe_routing() as rec:
                    nxt = apply(kind, p, resid, pending, cfg,
                                rts["barrier"])
                with self.moe_routing(replay=rec):
                    ref = apply(kind, base.cast_tree(p, torch.float32),
                                resid.float(), pending.float(), cfg32,
                                rts["barrier"])[1]
                with self.moe_routing(replay=rec):
                    out = apply(kind, p, resid, pending, cfg,
                                rts["brainslug"])[1]
                dist["brainslug"].append(self.rel_l2([out], [ref]))
                dist["barrier"].append(self.rel_l2([nxt[1]], [ref]))
                for name in MOE_CONTROLS:
                    # each block calls moe.apply once: the drop hits block
                    # MOE["drop_layer"] alone
                    with self.moe_control(
                            name, 1, replay=rec,
                            layer=0 if i == MOE["drop_layer"] else -1
                    ) as (hit, _):
                        out = apply(kind, p, resid, pending, cfg,
                                    rts["barrier"])[1]
                    dist[name].append(self.rel_l2([out], [ref]))
                    touched[name] += len(hit)
                resid, pending = nxt[0], nxt[1]
                del ref, out, nxt
        self.check_blocks("25b", f"{cfg.name} bf16 prefill {PREFILL}", dist,
                          touched, MOE_CONTROLS)
        print(f"[25b blocks] {len(blocks)} blocks; "
              f"{time.perf_counter() - t:.1f} s")

    def moe_float32_cut(self, cfg):
        """25b/25c at float32: the same widths at MOE["f32_layers"] layers,
        the prefill's logits and ``Server.generate``'s teacher-forced
        logits within PATH_F32_REL, identical greedy tokens."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.models import lm
        t = time.perf_counter()
        cfg4 = dataclasses.replace(cfg, n_layers=MOE["f32_layers"],
                                   dtype="float32")
        n_moe, n_attn, n_rms, n_swiglu = self.moe_counts(cfg4)
        p4 = lm.init(1, cfg4, device=self.dev)
        g = torch.Generator(device=self.dev).manual_seed(2502)
        tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=g,
                               device=self.dev)
        with torch.inference_mode():
            want, got = (lm.prefill(p4, {"tokens": tokens}, cfg4,
                                    RuntimeConfig(mode=m))
                         for m in ("barrier", "brainslug"))
        pre = self.relative(got, want)
        prompts = np.random.default_rng(2503).integers(
            0, cfg.vocab_size, (SERVE["batch"], SERVE["prompt_len"])
        ).astype(np.int32)
        servers, gens, counts = self.serve_pair(cfg4, p4, prompts,
                                                self.hybrid_counters)
        steps = SERVE["prompt_len"] + SERVE["new_tokens"] - 1
        self.expect_hybrid(f"{cfg.name} f32 serving", counts,
                           flash_decode=n_attn * steps, rmsnorm=n_rms * steps,
                           swiglu=n_swiglu * steps)
        if not np.array_equal(gens["brainslug"], gens["barrier"]):
            raise PhaseError(f"{cfg.name} f32 serving: brainslug's tokens "
                             f"differ from barrier's")
        errs = self.teacher_forced(servers, prompts, gens["barrier"])[
            ("brainslug", "barrier")]
        if not max(errs + [pre]) <= PATH_F32_REL:
            raise PhaseError(f"{cfg.name} f32: logits max|d|/max prefill "
                             f"{pre:.3e}, serving worst {max(errs):.3e} > "
                             f"{PATH_F32_REL}")
        print(f"[25b/c float32, {cfg4.n_layers} layers] prefill logits "
              f"max|d|/max {pre:.3e}; Server.generate brainslug == barrier "
              f"tokens, teacher-forced logits worst {max(errs):.3e} (tol "
              f"{PATH_F32_REL}); {time.perf_counter() - t:.1f} s")
        del servers, p4

    def moe_serving(self, cfg, params, tag, seed):
        """``Server.generate`` of 4 x 64 + 32 new, greedy, dense cache:
        counters a step; barrier teacher-forced on brainslug's tokens with
        brainslug's routing decisions, its logits held to brainslug's at
        every step (the prompts' positions too) at phase 12's direct
        limit; the decisions the free modes share on the prompts."""
        torch = self.torch
        n_moe, n_attn, n_rms, n_swiglu = self.moe_counts(cfg)
        prompts = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (SERVE["batch"], SERVE["prompt_len"])
        ).astype(np.int32)
        t = time.perf_counter()
        steps = SERVE["prompt_len"] + SERVE["new_tokens"] - 1
        n = steps * n_moe
        # barrier's run, then brainslug's: decisions and logits of each step
        with self.moe_routing() as rec, self.decode_logits() as lo:
            servers, gens, counts = self.serve_pair(cfg, params, prompts,
                                                    self.hybrid_counters)
        if len(rec) != 2 * n or len(lo) != 2 * steps:
            raise PhaseError(f"{cfg.name} serving: {len(rec)} routing calls "
                             f"and {len(lo)} steps, expected {2 * n} and "
                             f"{2 * steps}")
        self.expect_hybrid(f"{cfg.name} serving", counts,
                           flash_decode=n_attn * steps, rmsnorm=n_rms * steps,
                           swiglu=n_swiglu * steps)
        # barrier fed brainslug's tokens, taking brainslug's decisions
        with self.moe_routing(replay=rec[n:]), self.decode_logits() as lr:
            self.forced_steps(servers["barrier"], prompts, gens["brainslug"])
        errs = [self.relative(a, b) for a, b in zip(lo[steps:], lr)]
        p = SERVE["prompt_len"] * n_moe     # the prompts' positions
        agree = self.routing_agreement(rec[n:n + p], rec[:p])
        if not max(errs) <= PATH_BF16_REL:
            raise PhaseError(f"{cfg.name} serving bf16: teacher-forced "
                             f"logits on brainslug's routing max|d|/max "
                             f"{max(errs):.3e} > {PATH_BF16_REL}")
        wall = {m: s.last_stats.wall_s for m, s in servers.items()}
        n_gen = servers["brainslug"].last_stats.generated_tokens
        print(f"[{tag} Server.generate bf16] {cfg.name}, {cfg.n_layers} "
              f"layers, {SERVE['batch']} requests, prompt "
              f"{SERVE['prompt_len']}, {SERVE['new_tokens']} new tokens, "
              f"greedy, dense cache, MoE dropless: token agreement "
              f"brainslug vs barrier "
              f"{float((gens['brainslug'] == gens['barrier']).mean()):.4f}; "
              f"logits max|d|/max at each of the {steps} steps, barrier fed "
              f"brainslug's tokens on brainslug's routing: worst "
              f"{max(errs):.3e}, median {statistics.median(errs):.3e} (tol "
              f"{PATH_BF16_REL}); decisions the modes share on the prompts' "
              f"positions, per MoE layer: "
              f"{self.agreement_note(agree, n_moe)}; wall "
              + ", ".join(f"{m} {w:.3f} s ({n_gen / w:.2f} tok/s)"
                          for m, w in wall.items())
              + f"; brainslug counters {counts}; "
              f"{time.perf_counter() - t:.1f} s")
        del servers
        torch.cuda.empty_cache()
        return {k: v // steps for k, v in counts.items()}

    def moe_engine(self, cfg, params):
        """25d: ``Engine.run`` of phase 15's 12 requests (8 share a 64-token
        prefix) at full width cut to MOE["engine_layers"] (views of the
        first layers of the 32-layer weights): paged brainslug, paged
        barrier and dense brainslug, counters per model evaluation, prefix
        sharing on (paged), paged == dense brainslug greedy tokens,
        teacher-forced logits held to barrier on brainslug's routing;
        float32 at MOE["f32_layers"] layers with identical tokens across
        the three and against ``Server.generate``."""
        torch = self.torch
        import dataclasses
        from repro_torch.layers import base
        from repro_torch.models import lm
        t = time.perf_counter()
        n_layers = MOE["engine_layers"]
        full = dataclasses.replace(cfg, n_layers=n_layers)
        p8 = {**params, "blocks": base.tree_map(lambda a: a[:n_layers],
                                                params["blocks"])}
        n_moe, n_attn, n_rms, n_swiglu = self.moe_counts(full)
        reqs = self.engine_queue(cfg.vocab_size)
        greedy = [i for i, r in enumerate(reqs) if r.temperature <= 0.0]
        results = {}
        for layout, mode in ENGINE_RUNS:
            eng, comps, counts, wall = self.engine_run(
                full, p8, layout, mode, reqs, counters=self.hybrid_counters)
            results[(layout, mode)] = (eng, comps, wall)
            path = eng.report()["decode_path"]
            want = (("cuda-paged-decode" if layout == "paged"
                     else "cuda-flash-decode") if mode == "brainslug"
                    else ("ref-paged-decode" if layout == "paged"
                          else "ref-decode"))
            if path != want:
                raise PhaseError(f"{cfg.name} engine {layout} {mode}: decode "
                                 f"path {path}, expected {want}")
            if eng.prefix_sharing != (layout == "paged"):
                raise PhaseError(f"{cfg.name} engine {layout}: prefix "
                                 f"sharing {eng.prefix_sharing}")
            if mode == "brainslug":
                e = self.evaluations(eng.last_stats)
                kw = {"paged_flash_decode" if layout == "paged"
                      else "flash_decode": n_attn * e}
                self.expect_hybrid(f"{cfg.name} engine {layout}", counts,
                                   rmsnorm=n_rms * e, swiglu=n_swiglu * e,
                                   **kw)
                if layout == "paged":
                    self.moe_launches["engine_evaluation"] = {
                        k: v // e for k, v in counts.items()}
        pb = results[("paged", "brainslug")][1]
        db = results[("dense", "brainslug")][1]
        pr = results[("paged", "barrier")][1]
        for i in greedy:
            if not np.array_equal(pb[i].tokens, db[i].tokens):
                raise PhaseError(f"{cfg.name} engine: paged and dense "
                                 f"brainslug differ on greedy request {i}")
        n_tok = sum(len(pr[i].tokens) for i in greedy)
        agree = sum(int((pb[i].tokens == pr[i].tokens).sum())
                    for i in greedy) / max(n_tok, 1)
        pick = [i for i in greedy if reqs[i].max_new_tokens > 0][:4]
        seqs = [list(reqs[i].prompt) + pr[i].tokens.tolist() for i in pick]
        starts = [len(reqs[i].prompt) for i in pick]
        with self.moe_routing() as rec:
            fb = self.forced_logits(full, p8, "brainslug", seqs, starts)
        with self.moe_routing(replay=rec):
            fr = self.forced_logits(full, p8, "barrier", seqs, starts)
        errs = [self.relative(a, b) for a, b in zip(fb, fr)]
        if not max(errs) <= PATH_BF16_REL:
            raise PhaseError(f"{cfg.name} engine bf16: teacher-forced logits "
                             f"on brainslug's routing max|d|/max "
                             f"{max(errs):.3e} > {PATH_BF16_REL}")
        st = results[("paged", "brainslug")][0].last_stats
        print(f"[25d engine] {cfg.name} bf16, {n_layers} layers, Engine(slots "
              f"{ENGINE['slots']}, max_len {ENGINE['max_len']}, prefill_chunk "
              f"{ENGINE['prefill_chunk']}, paged blocks "
              f"{ENGINE['kv_num_blocks']} x {ENGINE['kv_block_size']}, "
              f"verify strict), 12 requests (8 share a 64-token prefix): "
              f"every request completed in the three runs, no kv.* finding, "
              f"the free list whole; prefix sharing on (paged): hits "
              f"{st.prefix_hit_tokens} tokens, cow forks {st.cow_forks}; "
              f"paged == dense brainslug greedy tokens; vs paged barrier "
              f"token agreement {agree:.4f}, teacher-forced logits on "
              f"brainslug's routing max|d|/max worst {max(errs):.3e}, median "
              f"{statistics.median(errs):.3e} (tol {PATH_BF16_REL}); "
              f"counters per model evaluation (paged brainslug) "
              f"{self.moe_launches['engine_evaluation']}; "
              f"{time.perf_counter() - t:.1f} s")
        for (layout, mode), (eng, comps, wall) in results.items():
            st = eng.last_stats
            print(f"[25d engine {layout} {mode}] wall {wall:.3f} s, "
                  f"{st.generated_tokens} tokens "
                  f"({st.generated_tokens / wall:.2f} tok/s), "
                  f"{self.evaluations(st)} model evaluations, TTFT p50 "
                  f"{st.ttft_p50_ms:.1f} ms p99 {st.ttft_p99_ms:.1f} ms; "
                  f"ServeStats {json.dumps(st.as_dict())}")
        del results, fb, fr
        cfg4 = dataclasses.replace(cfg, n_layers=MOE["f32_layers"],
                                   dtype="float32")
        self.engine_float32(cfg4, lm.init(1, cfg4, device=self.dev), reqs,
                            "25d", self.hybrid_counters)
        torch.cuda.empty_cache()

    def moe_step1(self, mode, cfg, params, batch, replay=None):
        """The step-1 loss and gradients of ``lm.loss_fn`` over every leaf,
        with the routing decisions recorded (or replayed from ``replay``)."""
        torch = self.torch
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.layers import base
        from repro_torch.models import lm
        with torch.enable_grad(), self.moe_routing(replay=replay) as rec:
            live = base.tree_map(lambda p: p.detach().requires_grad_(),
                                 params)
            loss, metrics = lm.loss_fn(live, batch, cfg,
                                       RuntimeConfig(mode=mode))
            grads = torch.autograd.grad(loss, base.tree_leaves(live))
        return float(loss.detach()), grads, rec, {
            k: float(v.detach()) for k, v in metrics.items()}

    def moe_grad_anchor(self, arch, layers):
        """25e: the step-1 gradient of the trainer's loss over every
        parameter (the seed-0 weights, the first batch) per mode, its
        relative L2 distance to the float32 gradient of the same weights
        taking that mode's routing decisions; brainslug within
        SSM_F32_FACTOR x barrier's.  brainslug's gradient twice from the
        same state: identical bits."""
        torch = self.torch
        import dataclasses
        import gc
        from repro_torch.configs import LM_SHAPES, get_config
        from repro_torch.data import pipeline
        from repro_torch.layers import base
        from repro_torch.models import lm
        t = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        shape = dataclasses.replace(LM_SHAPES["train_4k"], global_batch=1,
                                    seq_len=TRAIN_LM["seq"])
        batch = {k: torch.from_numpy(x).to(self.dev) for k, x in
                 pipeline.synth_batch(cfg, shape, 0, 0).items()}
        params = lm.init(0, cfg, device=self.dev)
        p32 = base.cast_tree(params, torch.float32)
        dist, loss = {}, {}
        for m in ("brainslug", "barrier"):
            loss[m], g, rec, metrics = self.moe_step1(m, cfg, params, batch)
            if m == "brainslug":
                again = self.moe_step1(m, cfg, params, batch)[1]
                if not all(torch.equal(a, b) for a, b in zip(g, again)):
                    raise PhaseError(f"{arch} step 1: two brainslug gradients "
                                     f"from the same state differ in bits")
                del again
            loss32, g32, _, _ = self.moe_step1("barrier", cfg32, p32, batch,
                                               replay=rec)
            dist[m] = (self.rel_l2(g, g32), loss32, metrics)
            del g, g32
            gc.collect()
            torch.cuda.empty_cache()
        del params, p32
        ratio = dist["brainslug"][0] / dist["barrier"][0]
        n_moe = lm.n_moe_layers(cfg)
        print(f"[25e step-1 gradient] {layers} layers bf16, every parameter, "
              f"relative L2 distance to the float32 gradient of the same "
              f"weights on the mode's routing decisions: " + "; ".join(
                  f"{m} {dist[m][0]:.4e} (loss {loss[m]}, float32 "
                  f"{dist[m][1]}, router_aux_loss "
                  f"{dist[m][2]['router_aux_loss']:.4f}, drop_fraction a "
                  f"MoE layer {dist[m][2]['drop_fraction'] / n_moe:.5f})"
                  for m in dist)
              + f"; brainslug at {ratio:.3f}x barrier's (tol "
              f"{SSM_F32_FACTOR}x); brainslug's gradient twice from one "
              f"state bit for bit; {time.perf_counter() - t:.1f} s")
        if not ratio <= SSM_F32_FACTOR:
            raise PhaseError(f"{arch} step-1 gradient: brainslug's distance "
                             f"to float32 {dist['brainslug'][0]:.4e} > "
                             f"{SSM_F32_FACTOR} x barrier's "
                             f"{dist['barrier'][0]:.4e}")

    def moe_train(self, cfg):
        """25e: ``Trainer.run`` at full width cut to MOE["train_layers"],
        4096 tokens, three AdamW steps per mode (losses, grad norms and the
        MoE aux read; counters per step); the step-1 gradient against
        float32; float32 at MOE["train_f32_layers"] (losses and step-1
        gradients within 1e-4); kill at step 2 and resume bit for bit at
        MOE["layers_resume"]."""
        torch = self.torch
        import dataclasses
        import shutil
        import tempfile
        from repro_torch.distributed import fault_tolerance as ft
        t = time.perf_counter()
        L = MOE["train_layers"]
        n_moe, n_attn, n_rms, n_swiglu = self.moe_counts(
            dataclasses.replace(cfg, n_layers=L))
        kw = dict(arch=MOE["arch"], counters=self.hybrid_counters)
        runs = {}
        for mode in ("brainslug", "barrier"):
            hist, per_step, peak, wall = self.train_lm(mode, L, "bfloat16",
                                                       **kw)
            for i, got in enumerate(per_step):
                if mode == "brainslug":
                    self.expect_hybrid(f"{cfg.name} train step {i + 1}", got,
                                       flash_attention=n_attn, rmsnorm=n_rms,
                                       swiglu=n_swiglu, fused_ce=1)
                else:
                    self.expect_hybrid(f"{cfg.name} train barrier step "
                                       f"{i + 1}", got)
            runs[mode] = (hist, per_step, peak, wall)
        self.moe_launches["train_step"] = runs["brainslug"][1][0]
        keys = ("loss", "grad_norm", "router_aux_loss",
                "drop_fraction_per_moe_layer")
        read = {m: {k: [h[k] for h in r[0]] for k in keys}
                for m, r in runs.items()}
        if not all(math.isfinite(x) for r in read.values()
                   for v in r.values() for x in v):
            raise PhaseError(f"{cfg.name} train: {read}")
        print(f"[25e train bf16] {cfg.name} at full width, {L} layers, 1 x "
              f"{TRAIN_LM['seq']} tokens, {TRAIN_LM['steps']} AdamW steps lr "
              f"{TRAIN_LM['lr']} through build_trainer / Trainer.run: "
              + "; ".join(f"{m} " + " ".join(f"{k} {v}" for k, v in r.items())
                          + f" peak {runs[m][2]:.2f} GiB wall "
                          f"{runs[m][3]:.1f} s" for m, r in read.items())
              + f" (read, not held: agreement is held on the step-1 "
              f"gradient); brainslug counters per step "
              f"{runs['brainslug'][1][0]}")
        self.moe_grad_anchor(MOE["arch"], L)

        # float32 at 2 layers: losses and step-1 gradients
        L2 = MOE["train_f32_layers"]
        f32 = {m: self.train_lm(m, L2, "float32", **kw)[0]
               for m in ("brainslug", "barrier")}
        losses = {m: [h["loss"] for h in hist] for m, hist in f32.items()}
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["brainslug"],
                                                      losses["barrier"]))
        if not rel <= TRAIN_RTOL:
            raise PhaseError(f"{cfg.name} train f32: losses {losses}")
        import gc
        from repro_torch.configs import LM_SHAPES, get_config
        from repro_torch.data import pipeline
        from repro_torch.models import lm
        cfg2 = dataclasses.replace(get_config(MOE["arch"]), n_layers=L2,
                                   dtype="float32")
        shape = dataclasses.replace(LM_SHAPES["train_4k"], global_batch=1,
                                    seq_len=TRAIN_LM["seq"])
        batch = {k: torch.from_numpy(x).to(self.dev) for k, x in
                 pipeline.synth_batch(cfg2, shape, 0, 0).items()}
        p2 = lm.init(0, cfg2, device=self.dev)
        gb = self.moe_step1("brainslug", cfg2, p2, batch)[1]
        gr = self.moe_step1("barrier", cfg2, p2, batch)[1]
        worst = 0.0
        for a, b in zip(gb, gr):
            lim = TRAIN_RTOL * float(b.abs().max())
            err = float((a - b).abs().max())
            if not bool(torch.allclose(a, b, rtol=TRAIN_RTOL, atol=lim)):
                raise PhaseError(f"{cfg.name} train f32 step-1 gradient: "
                                 f"max|d| {err:.3e} outside rtol "
                                 f"{TRAIN_RTOL}, atol {lim:.3e}")
            worst = max(worst, err / max(lim, 1e-30))
        del gb, gr, p2
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[25e train float32] {L2} layers: losses brainslug "
              f"{losses['brainslug']} barrier {losses['barrier']} (worst "
              f"relative {rel:.3e}, tol {TRAIN_RTOL}); step-1 gradients of "
              f"every parameter within rtol {TRAIN_RTOL} and atol "
              f"{TRAIN_RTOL} x max|g| (worst max|d| at {worst:.3f} of atol)")

        # kill at step 2, resume from the step-1 checkpoint, at
        # MOE["layers_resume"] layers (the resumed run writes only its final
        # checkpoint)
        lr_ = MOE["layers_resume"]
        full = self.train_lm("brainslug", lr_, "bfloat16", **kw)[0]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
            free = shutil.disk_usage(d).free / 2 ** 30
            try:
                self.train_lm("brainslug", lr_, "bfloat16",
                              failure=ft.failure_injector({2}), ckpt_dir=d,
                              ckpt_every=1, **kw)
            except ft.SimulatedFailure:
                pass
            else:
                raise PhaseError(f"{cfg.name} kill/resume: the injected "
                                 f"failure at step 2 did not happen")
            resumed, _, _, wall = self.train_lm(
                "brainslug", lr_, "bfloat16", ckpt_dir=d,
                ckpt_every=TRAIN_LM["steps"], **kw)
        if [h["step"] for h in resumed] != [2] or \
                resumed[-1]["loss"] != full[-1]["loss"]:
            raise PhaseError(f"{cfg.name} kill/resume: resumed {resumed}, "
                             f"uninterrupted step-3 loss {full[-1]['loss']}")
        print(f"[25e kill/resume] bf16 {lr_} layers brainslug: killed at step "
              f"2, resumed from the step-1 checkpoint ({free:.0f} GiB free in "
              f"the temp dir): step-3 loss {resumed[-1]['loss']} equals the "
              f"uninterrupted run's bit for bit; resume run {wall:.1f} s; "
              f"{time.perf_counter() - t:.1f} s")

    def moe_times(self, cfg, params, tokens):
        """25f: the prefill and a decode step per mode in turns at 32
        layers, the training step per mode in turns at
        MOE["train_layers"]; a trace of each per mode (device time by
        group, the MoE ranges among them, and the idle share)."""
        torch = self.torch
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.launch import steps as steps_mod
        from repro_torch.data import pipeline
        from repro_torch.models import lm
        from repro_torch.optim import adamw
        rts = {m: RuntimeConfig(mode=m) for m in ("barrier", "brainslug")}
        batch = {"tokens": tokens}
        with torch.inference_mode():
            cache = lm.init_decode_cache(cfg, SERVE["batch"], 97,
                                         dtype=torch.float32, device=self.dev)
        tok = tokens[:, :SERVE["batch"]].reshape(SERVE["batch"], 1)
        pos = SERVE["prompt_len"]

        def prefill(m):
            return lm.prefill(params, batch, cfg, rts[m])

        def step(m):
            for c in lm._caches(cache):
                c.length.fill_(pos)
            return lm.decode_step(params, cache, tok, cfg, rts[m])

        turns = ("barrier", "brainslug", "brainslug", "barrier")
        with torch.inference_mode():
            pre = [(m, self.cuda_ms(lambda m=m: prefill(m), reps=1, groups=3,
                                    warmup=1)) for m in turns]
            dec = [(m, self.cuda_ms(lambda m=m: step(m), reps=1, groups=5,
                                    warmup=1)) for m in turns]
        print(f"[25f path] {cfg.name} bf16, {cfg.n_layers} layers: "
              f"lm.prefill {PREFILL}, median of 3 (CUDA events), in turns: "
              + "  ".join(f"{m}={v:.3f} ms ({PREFILL[1] / v:.1f} tok/ms)"
                          for m, v in pre))
        print(f"[25f path] one decode step at batch {SERVE['batch']}, "
              f"position {pos} (float32 cache as Server builds it; MoE "
              f"dropless: a (1, {cfg.n_experts}, "
              f"{max(8, SERVE['batch'])}, {cfg.d_model}) expert batch for "
              f"{SERVE['batch'] * cfg.top_k} assignments), median of 5, in "
              f"turns: " + "  ".join(f"{m}={v:.3f} ms "
                                     f"({SERVE['batch'] / v * 1e3:.1f} tok/s)"
                                     for m, v in dec))
        with torch.inference_mode():
            for what, fn in (("prefill", prefill), ("decode step", step)):
                for m in ("barrier", "brainslug"):
                    print(f"[25f trace {what} {m}] " + self.train_trace(
                        lambda m=m: fn(m), classify=self.hybrid_group))
        del cache
        trainer = self.lm_trainer("brainslug", MOE["train_layers"],
                                  "bfloat16", arch=MOE["arch"])
        opt_cfg = adamw.AdamWConfig(lr=TRAIN_LM["lr"])
        fns = {m: steps_mod.make_train_step(trainer.cfg, RuntimeConfig(mode=m),
                                            opt_cfg)
               for m in ("barrier", "brainslug")}
        tbatch = {k: torch.from_numpy(x).to(self.dev) for k, x in
                  pipeline.synth_batch(trainer.cfg, trainer.shape, 0,
                                       0).items()}

        def train_step(m):
            trainer.params, trainer.opt_state, _ = fns[m](
                trainer.params, trainer.opt_state, tbatch)

        def timed(m):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(m)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

        for m in fns:
            train_step(m)                               # warm-up
        tt = [(m, timed(m)) for m in turns]
        print(f"[25f train step] {cfg.name} {MOE['train_layers']} layers "
              f"bf16, 1 x {TRAIN_LM['seq']} tokens, forward + backward + "
              f"AdamW, one step each (host clock around synchronised "
              f"steps), in turns: "
              + "  ".join(f"{m}={ms:.1f} ms ({TRAIN_LM['seq'] / ms:.2f} "
                          f"tok/ms)" for m, ms in tt))
        for m in ("barrier", "brainslug"):
            print(f"[25f trace train step {m}] " + self.train_trace(
                lambda m=m: train_step(m), classify=self.hybrid_group))
        del trainer, fns, tbatch
        torch.cuda.empty_cache()

    def moe_llama4(self):
        """25g: llama4-maverick-400b-a17b at full width cut to one
        super-block (a dense block, then an MoE block of 128 experts, top-1,
        with the shared expert): ``lm.prefill`` and ``Server.generate``,
        brainslug against barrier at phase 12's direct limits on
        brainslug's routing decisions."""
        torch = self.torch
        import dataclasses
        import gc
        from repro_torch.configs import get_config
        from repro_torch.layers import base
        from repro_torch.models import lm
        t = time.perf_counter()
        cfg = dataclasses.replace(get_config(MOE["llama4"]),
                                  n_layers=MOE["llama4_layers"])
        params = lm.init(0, cfg, device=self.dev)
        torch.cuda.synchronize()
        print(f"[25g model] {cfg.name} cut to {cfg.n_layers} layers "
              f"({lm.layer_plan(cfg).superblock}), d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads of {cfg.head_dim} over {cfg.n_kv_heads}, "
              f"d_ff {cfg.d_ff}, {cfg.n_experts} experts top-{cfg.top_k}, "
              f"shared expert {cfg.shared_expert_ff}, vocab "
              f"{cfg.vocab_size}, {cfg.dtype}: "
              f"{base.param_count(params) / 1e9:.3f} B random parameters "
              f"(seed 0) in {time.perf_counter() - t:.1f} s")
        self.moe_launches["llama4_prefill"] = self.moe_prefill(
            cfg, params, "25g")[3]
        self.moe_launches["llama4_decode_step"] = self.moe_serving(
            cfg, params, "25g", 2520)
        del params
        gc.collect()
        torch.cuda.empty_cache()

    def phase25_moe(self):
        torch = self.torch
        import dataclasses
        import gc
        from repro_torch.configs import get_config
        from repro_torch.layers import base
        from repro_torch.models import lm
        t0 = time.perf_counter()
        cfg = get_config(MOE["arch"])
        self.moe_launches = {}          # per prefill, step, evaluation
        self.attention_kernels(cfg.head_dim, cfg.n_heads, cfg.n_kv_heads,
                               "25a", 2500)
        t = time.perf_counter()
        params = lm.init(0, cfg, device=self.dev)
        torch.cuda.synchronize()
        n_moe, n_attn, n_rms, n_swiglu = self.moe_counts(cfg)
        print(f"[25 model] {cfg.name}: {cfg.n_layers} layers, all MoE, "
              f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} "
              f"over {cfg.n_kv_heads}, {cfg.n_experts} experts of d_ff "
              f"{cfg.d_ff}, top-{cfg.top_k}, capacity factor "
              f"{cfg.capacity_factor}, vocab {cfg.vocab_size}, {cfg.dtype}: "
              f"{base.param_count(params) / 1e9:.3f} B random parameters "
              f"(seed 0) in {time.perf_counter() - t:.1f} s")
        tokens, rec_b, rec_r, self.moe_launches["prefill"] = \
            self.moe_prefill(cfg, params, "25b")
        self.moe_anchor(cfg, params, tokens, rec_b, rec_r)
        self.moe_blocks(params, cfg, tokens)
        del rec_b, rec_r
        self.moe_float32_cut(cfg)
        n = MOE["serve_layers"]
        self.moe_launches["decode_step"] = self.moe_serving(
            dataclasses.replace(cfg, n_layers=n),
            {**params, "blocks": base.tree_map(lambda a: a[:n],
                                               params["blocks"])},
            "25c", 2501)
        self.moe_engine(cfg, params)
        self.moe_times(cfg, params, tokens)
        del params, tokens
        gc.collect()
        torch.cuda.empty_cache()
        self.moe_train(cfg)
        self.moe_llama4()
        la = self.moe_launches
        for name, where in (("flash_attention", ("prefill", "train_step")),
                            ("flash_decode", ("decode_step",)),
                            ("paged_flash_decode", ("engine_evaluation",))):
            entry = self.kernels[name]["head_dim_64"]
            entry["launches"] = {w: la[w][name] for w in where}
            entry["max_abs_err"] = self.err[name]
        print(f"[25 launches] {cfg.name} per prefill {la['prefill']}; per "
              f"decode step {la['decode_step']}; per engine model evaluation "
              f"(paged, {MOE['engine_layers']} layers) "
              f"{la['engine_evaluation']}; per training step "
              f"({MOE['train_layers']} layers) {la['train_step']}; "
              f"{MOE['llama4']} ({MOE['llama4_layers']} layers) per decode "
              f"step {la['llama4_decode_step']}; phase "
              f"{time.perf_counter() - t0:.1f} s")


    # -- phase 26: compiled xla, the autotuner and remat="dots" --------------
    def xla_counts(self):
        """The compiled-call counter and dynamo's graph and graph-break
        counts."""
        from torch._dynamo.utils import counters
        from repro_torch.kernels.fused_stack import ops
        return (ops.STATS.counts["fwd_xla_compiled"],
                counters["stats"]["unique_graphs"],
                sum(counters["graph_break"].values()))

    @staticmethod
    def xla_group(low):
        """Kernel groups of a trace with inductor's kernels in it."""
        if low.startswith("triton_") or "triton_" in low[:12]:
            return "inductor"
        return None

    def xla_trace(self, fn, expect=None):
        """:meth:`trace` with inductor's kernels as a group, taken again,
        with more spin kernels, while the profiler lost every spin kernel
        or a launch ``expect`` counts.  It loses the first events of a
        session: late in the script 55-58 of them on one H100, past the
        default spin kernels into a VGG forward's launches; a
        trace that kept a spin kernel kept every launch after it."""
        out = "incomplete: no trace"
        for spins in (SPIN_KERNELS, 8 * SPIN_KERNELS, 64 * SPIN_KERNELS):
            kept = []
            spans = self.device_spans(fn, spins=spins, counted=kept)
            if not kept or kept[0] == 0:
                out = (f"incomplete: the profiler kept none of {spins} "
                       f"spin kernels; not used")
                continue
            out = self.trace(fn, expect, spans=spans, classify=lambda low: (
                self.xla_group(low) or (
                    "fused_nhwc_bwd" if any(k in low for k in (
                        "nhwc_bwd", "nhwc_overlap_add", "nhwc_reduce"))
                    else "fused_nhwc" if "fused_nhwc" in low
                    else "fused_rows_bwd" if any(k in low for k in (
                        "fused_rows_bwd", "reduce_partials"))
                    else "fused_rows" if "fused_rows" in low
                    else "conv" if any(k in low for k in (
                        "conv", "cudnn", "xmma", "implicit", "fft",
                        "_complex"))
                    else "gemm" if "gemm" in low else "other")))
            if not out.startswith("incomplete"):
                break
        return out

    def phase26_slice_f(self):
        t = time.perf_counter()
        spent = {}
        for name, fn in (("26a", self.phase26_xla),
                         ("26b", self.phase26_autotune),
                         ("26c", self.phase26_remat)):
            t1 = time.perf_counter()
            fn()
            spent[name] = round(time.perf_counter() - t1, 1)
        print(f"[26 seconds] {json.dumps(spent)}; phase "
              f"{time.perf_counter() - t:.1f} s")

    def phase26_xla(self):
        """26a: ``mode="xla"`` (each stack's plain function under
        ``torch.compile``) on the main path, against ``barrier``."""
        torch = self.torch
        import gc

        import torch.nn.functional as F
        from repro_torch.configs import get_config
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.core import api, collapse, resource
        from repro_torch.models import cnn, lm
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        graph, params = cnn.vgg_net(VGG16_STAGES, device=self.dev)
        x = self.randn(VGG_INPUT, 7)
        nets = {m: api.optimize_graph(graph, VGG_INPUT,
                                      api.OptimizeConfig(mode=m))
                for m in ("xla", "barrier", "brainslug")}
        n_seq = nets["xla"].n_sequences
        with torch.no_grad():
            want = nets["barrier"](x, params)
            c0 = self.xla_counts()
            got = nets["xla"](x, params)
            torch.cuda.synchronize()
            first = time.perf_counter() - t
            c1 = self.xla_counts()
            again = nets["xla"](x, params)
            c2 = self.xla_counts()
        calls, graphs, breaks = (b - a for a, b in zip(c0, c1))
        if calls != n_seq or c2[0] - c1[0] != n_seq or breaks \
                or c2[1] != c1[1]:
            raise PhaseError(f"26a VGG xla: {calls} compiled calls for "
                             f"{n_seq} sequences, {breaks} graph breaks, "
                             f"{c2[1] - c1[1]} graphs on the second call")
        err = float((got - want).abs().max())
        if tuple(got.shape) != (VGG_INPUT[0], 10) or not bool(
                torch.isfinite(got).all()) or not torch.allclose(
                    got, want, **PATH_TOL) or not torch.equal(got, again):
            raise PhaseError(f"26a VGG xla vs barrier max|d|={err:.3e}")
        print(f"[26a VGG-16 xla] optimize_graph {VGG_INPUT} float32, "
              f"mode=xla (each sequence's plain function under torch.compile,"
              f" inductor, fullgraph): against barrier max|d|={err:.3e} (tol "
              f"{PATH_TOL}), a second call bit for bit; {calls} compiled "
              f"calls for {n_seq} sequences, {graphs} graphs compiled, "
              f"{breaks} graph breaks; first call {first:.1f} s (compile)")

        # training: three SGD steps through the differentiable plans
        labels = torch.randint(0, 10, (VGG_INPUT[0],), device=self.dev,
                               generator=torch.Generator(
                                   device=self.dev).manual_seed(8))
        tnets = {m: api.optimize_graph(graph, VGG_INPUT, api.OptimizeConfig(
            mode=m, differentiable=True)) for m in ("xla", "barrier",
                                                    "brainslug")}
        n_tseq = tnets["xla"].n_sequences
        runs = {}
        t1 = time.perf_counter()
        for m in ("barrier", "xla"):
            self.zero_counts()
            runs[m] = self.sgd(lambda p, m=m: tnets[m](x, p), params,
                               lambda y: F.cross_entropy(y, labels))
        compile_s = time.perf_counter() - t1
        (lx, gx, steps), (lb, gb, _) = runs["xla"], runs["barrier"]
        # the float64 anchor: barrier's step-1 gradient in float64
        with torch.enable_grad():
            p64 = {k: v.detach().double().requires_grad_() for k, v in
                   params.items()}
            loss64 = F.cross_entropy(tnets["barrier"](x.double(), p64),
                                     labels)
            g64 = dict(zip(p64, torch.autograd.grad(loss64,
                                                    list(p64.values()))))
        del p64, loss64

        def dist(a, b):
            return float(torch.linalg.vector_norm(a.double() - b)
                         / torch.linalg.vector_norm(b))

        worst, ratios, outside = 0.0, {}, {}
        for k, w in gb.items():
            d = (gx[k] - w).abs()
            scale = float(w.abs().max())
            worst = max(worst, float(d.max()) / max(scale, 1e-30))
            outside[k] = int((d > TRAIN_RTOL * (w.abs() + scale)).sum())
            ratios[k] = (dist(gx[k], g64[k]), dist(w, g64[k]))
            if not bool(torch.isfinite(gx[k]).all()) or not ratios[k][0] \
                    <= max(SSM_F32_FACTOR * ratios[k][1], XLA_F64_FLOOR):
                raise PhaseError(f"26a VGG xla training: step-1 gradient of "
                                 f"{k}: relative L2 to float64 xla "
                                 f"{ratios[k][0]:.3e}, barrier "
                                 f"{ratios[k][1]:.3e} (tol {SSM_F32_FACTOR}x"
                                 f" barrier's or {XLA_F64_FLOOR})")
        del g64
        for a, b in zip(lx, lb):
            if not math.isfinite(a) or abs(a - b) > TRAIN_RTOL * abs(b):
                raise PhaseError(f"26a VGG xla training: losses {lx} vs "
                                 f"barrier {lb}")
        for i, (stats, launches) in enumerate(steps):
            if stats["fwd_xla_compiled"] != n_tseq or any(
                    stats[k] for k in ("fwd_generated", "fwd_reference",
                                       "bwd_generated", "bwd_reference")) \
                    or any(launches.values()):
                raise PhaseError(f"26a VGG xla training step {i + 1}: "
                                 f"counters {stats}, launches {launches}")
        print(f"[26a VGG-16 xla training] differentiable=True, "
              f"{TRAIN_STEPS} SGD steps lr {TRAIN_LR}: losses xla {lx} "
              f"barrier {lb}; step-1 gradient of every parameter, relative "
              f"L2 to barrier's float64 gradient, xla within "
              f"{SSM_F32_FACTOR}x barrier's or {XLA_F64_FLOOR}: worst ratio "
              f"{max(a / b for a, b in ratios.values()):.3f} (conv0_w xla "
              f"{ratios['conv0_w'][0]:.3e}, barrier {ratios['conv0_w'][1]:.3e})"
              f"; against barrier max|d|/max|g| = {worst:.3e}, elements past "
              f"phase 9's rule (rtol {TRAIN_RTOL}, atol {TRAIN_RTOL}*max|g|) "
              f"{ {k: v for k, v in outside.items() if v} } of "
              f"{sum(w.numel() for w in gb.values())}; per step "
              f"{n_tseq} compiled calls, no hand kernel launched; "
              f"{compile_s:.1f} s with the compiles; graph breaks "
              f"{self.xla_counts()[2]}")

        # the three modes in turns, forward and training step, and traces
        def step(m):
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_() for k, v in
                          params.items()}
                loss = F.cross_entropy(tnets[m](x, leaves), labels)
                return torch.autograd.grad(loss, list(leaves.values()))

        turns = ("barrier", "xla", "brainslug", "brainslug", "xla",
                 "barrier")
        with torch.no_grad():
            fwd = [(m, self.cuda_ms(lambda m=m: nets[m](x, params), reps=1,
                                    groups=10)) for m in turns]
        trn = [(m, self.cuda_ms(lambda m=m: step(m), reps=1, groups=5,
                                warmup=1)) for m in turns]
        print(f"[26a VGG-16 times] {self.smi}; forward, median of 10 (CUDA "
              f"events), in turns: "
              + "  ".join(f"{m}={v:.3f} ms" for m, v in fwd)
              + "; training step (forward + backward), median of 5: "
              + "  ".join(f"{m}={v:.3f} ms" for m, v in trn))
        n_stage = len(VGG16_STAGES)
        expect = {"barrier": ({"max_pool_forward_nhwc": n_stage},
                              {"max_pool_backward_nhwc": n_stage}),
                  "xla": (None, None),
                  "brainslug": ({"fused_nhwc_kernel": n_stage},
                                {"fused_nhwc_bwd_kernel": n_stage})}
        for m in ("barrier", "xla", "brainslug"):
            print(f"[26a trace forward {m}] " + self.xla_trace(
                lambda m=m: nets[m](x, params), expect[m][0]))
            print(f"[26a trace step {m}] " + self.xla_trace(
                lambda m=m: step(m), expect[m][1]))

        # each VGG stage's stack: inductor's kernels against fused_nhwc and
        # fused_nhwc_bwd, forward and backward alone, on the stage's input
        from repro_torch.core import codegen, ir
        lines = []
        env = {graph.input: x}
        for seg in nets["barrier"].segments:
            if not seg.is_stack:
                if seg.op.kind == ir.OpKind.MATMUL:
                    break
                with torch.no_grad():
                    env[seg.op.output] = ir.apply_op(seg.op, env, params)
                continue
            h = env[seg.stack.inputs[0]]
            stack = seg.stack
            in_shapes = {stack.inputs[0]: tuple(h.shape)}
            plan = collapse.collapse(stack, in_shapes, resource.H100,
                                     differentiable=True)
            exes = {m: codegen.compile_plan(plan, mode=m)
                    for m in ("xla", "brainslug")}
            sp = {k: params[k] for k in stack.param_names}
            with torch.no_grad():
                ys = {m: e({stack.inputs[0]: h}, sp) for m, e in
                      exes.items()}
                fw = {m: self.device_ms(lambda m=m: exes[m](
                    {stack.inputs[0]: h}, sp))[0] for m in exes}

            def train_call(m, backward, h=h, sp=sp, exes=exes, stack=stack):
                with torch.enable_grad():
                    xi = h.detach().requires_grad_()
                    pi = {k: v.detach().requires_grad_() for k, v in
                          sp.items()}
                    y = exes[m]({stack.inputs[0]: xi}, pi)[stack.outputs[0]]
                    if backward:
                        torch.autograd.grad(y, [xi, *pi.values()],
                                            torch.ones_like(y))

            # the backward alone: forward + backward less the training
            # forward (the compiled backward takes no retained graph)
            bw = {m: self.device_ms(lambda m=m: train_call(m, True),
                                    reps=5)[0]
                  - self.device_ms(lambda m=m: train_call(m, False),
                                   reps=5)[0] for m in exes}
            d = float((ys["xla"][stack.outputs[0]]
                       - ys["brainslug"][stack.outputs[0]]).abs().max())
            ratio = {k: (f"{v['xla'] / v['brainslug']:.2f}x"
                         if v["brainslug"] > 0 else "n/a")
                     for k, v in (("fw", fw), ("bw", bw))}
            lines.append(f"  {stack.name} {tuple(h.shape)}: forward inductor "
                         f"{fw['xla']:.4f} ms, fused_nhwc {fw['brainslug']:.4f}"
                         f" ms ({ratio['fw']}); backward inductor "
                         f"{bw['xla']:.4f} ms, fused_nhwc_bwd "
                         f"{bw['brainslug']:.4f} ms ({ratio['bw']}); outputs "
                         f"max|d| {d:.2e}")
            env.update(ys["brainslug"])
        print("[26a VGG stages] each stage's stack (differentiable plan) "
              "alone on its input, device time (profiler) of the compiled "
              "plain function's inductor kernels against the hand kernel, "
              "forward and the backward alone (a training forward and "
              "backward over every input and parameter, less the training "
              "forward):\n" + "\n".join(lines))
        del nets, tnets, runs
        gc.collect()
        torch.cuda.empty_cache()

        # the LM block's row chains at deepseek-7b widths, in bf16 (the
        # prefill below reuses their compiled graphs: rows compile dynamic)
        cases = {c[0]: c for c in self.rows_cases()}
        row_lines = []
        tol = LM_TOL["bfloat16"]
        for k, name in enumerate(("rms", "addnorm_rms", "glu_silu")):
            _, program, in_shapes, p_shapes, _ = cases[name]
            inputs, p = self.rows_inputs(name, in_shapes, p_shapes,
                                         900 + 100 * k)
            inputs = {n: v.bfloat16() for n, v in inputs.items()}
            p = {n: v.bfloat16() for n, v in p.items()}
            exes = {m: api.optimize_stack(program, in_shapes,
                                          api.OptimizeConfig(mode=m))
                    for m in ("xla", "brainslug", "barrier")}
            with torch.no_grad():
                c0 = self.xla_counts()
                out = exes["xla"](inputs, p)
                c1 = self.xla_counts()
                want = exes["barrier"](inputs, p)
                ms = {m: self.device_ms(lambda m=m: exes[m](inputs, p))[0]
                      for m in exes}
            if c1[0] - c0[0] != 1 or c1[2] != c0[2]:
                raise PhaseError(f"26a {name} xla: counters {c0} -> {c1}")
            self.check("fused_rows_bf16", f"26a {name} xla vs barrier",
                       {v: out[v].float() for v in program.outputs},
                       {v: t.float() for v, t in want.items()}, tol)
            row_lines.append(f"{name} inductor {ms['xla']:.4f} ms, "
                             f"fused_rows {ms['brainslug']:.4f} ms, barrier "
                             f"{ms['barrier']:.4f} ms")
        print(f"[26a LM row chains] optimize_stack at {ROWS} x "
              f"{D_MODEL}/{D_FF} bf16, xla against barrier within {tol}, one "
              f"compiled call each; device time: "
              + "; ".join(row_lines))

        # deepseek-7b lm.prefill at a cut depth, bf16
        import dataclasses
        cfg = dataclasses.replace(get_config("deepseek-7b"),
                                  n_layers=XLA_LM["layers"])
        lp = lm.init(0, cfg, device=self.dev)
        g = torch.Generator(device=self.dev).manual_seed(2600)
        tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=g,
                               device=self.dev)
        out = {}
        with torch.inference_mode():
            for m in ("barrier", "xla"):
                c0 = self.xla_counts()
                t1 = time.perf_counter()
                out[m] = lm.prefill(lp, {"tokens": tokens}, cfg,
                                    RuntimeConfig(mode=m))
                torch.cuda.synchronize()
                first = time.perf_counter() - t1
                c1 = self.xla_counts()
            n_stacks = 3 * cfg.n_layers + 1
            if c1[0] - c0[0] != n_stacks or c1[2] != c0[2]:
                raise PhaseError(f"26a prefill xla: counters {c0} -> {c1}, "
                                 f"{n_stacks} stacks")
            rel = self.relative(out["xla"], out["barrier"])
            if not bool(torch.isfinite(out["xla"]).all()) or \
                    not rel <= PATH_BF16_REL:
                raise PhaseError(f"26a prefill xla vs barrier max|d|/max "
                                 f"{rel:.3e}")
            pms = [(m, self.cuda_ms(lambda m=m: lm.prefill(
                lp, {"tokens": tokens}, cfg, RuntimeConfig(mode=m)), reps=1,
                groups=5)) for m in ("barrier", "xla", "brainslug",
                                     "brainslug", "xla", "barrier")]
            # one decode step, host-bound: what xla's own host cost adds
            cache = lm.init_decode_cache(cfg, SERVE["batch"], 97,
                                         dtype=torch.float32, device=self.dev)
            tok = tokens[:, :SERVE["batch"]].reshape(SERVE["batch"], 1)

            def step(m):
                cache["blocks"]["sub0"].length.fill_(SERVE["prompt_len"])
                return lm.decode_step(lp, cache, tok, cfg,
                                      RuntimeConfig(mode=m))

            c0 = self.xla_counts()
            step("xla")
            c1 = self.xla_counts()
            if c1[0] - c0[0] != n_stacks or c1[2] != c0[2]:
                raise PhaseError(f"26a decode step xla: counters {c0} -> "
                                 f"{c1}, {n_stacks} stacks")
            dms = [(m, self.cuda_ms(lambda m=m: step(m), reps=1, groups=20))
                   for m in ("barrier", "xla", "brainslug", "brainslug",
                             "xla", "barrier")]
        print(f"[26a lm.prefill {PREFILL} bf16] deepseek-7b at full width cut "
              f"to {cfg.n_layers} layers: xla against barrier last-position "
              f"logits max|d|/max {rel:.3e} (tol {PATH_BF16_REL}), argmax "
              f"equal {bool(out['xla'].argmax() == out['barrier'].argmax())};"
              f" {n_stacks} compiled calls for {n_stacks} stacks, graph "
              f"breaks {c1[2]}; first xla call {first:.1f} s; median of 5 "
              f"(CUDA events), in turns: "
              + "  ".join(f"{m}={v:.3f} ms" for m, v in pms))
        print(f"[26a decode step] the same model, one lm.decode_step at batch "
              f"{SERVE['batch']}, position {SERVE['prompt_len']} (float32 "
              f"cache), {n_stacks} compiled calls a step in xla; median of 20 "
              f"(CUDA events), in turns: "
              + "  ".join(f"{m}={v:.3f} ms" for m, v in dms))
        del lp, out, cache

        # where a decode step's xla host time goes: one addnorm stack at the
        # step's shape, host time a call over 200 issued calls (one
        # synchronisation at the end), the compiled callable alone beside
        # run_xla around it, barrier's eager ops and the rmsnorm kernel
        from repro_torch.kernels.fused_stack import ops as fops
        from repro_torch.kernels.rmsnorm import ops as rms_ops
        from repro_torch.layers import stacks as lstacks
        shape = (SERVE["batch"], 1, cfg.d_model)
        hx, hr = (self.randn(shape, 31 + i).bfloat16() for i in range(2))
        hs = self.randn((cfg.d_model,), 33).bfloat16()
        an = lstacks.addnorm_program(cfg.norm, 1e-6, False)
        ins, ps = {"x": hx, "res": hr}, {"scale": hs}
        calls = {
            "run_xla": lambda: fops.fused_stack_apply(an, ins, ps,
                                                      mode="xla"),
            "compiled callable": lambda: xfn(hx, hr, hs),
            "barrier": lambda: fops.fused_stack_apply(an, ins, ps,
                                                      mode="barrier"),
            "brainslug rmsnorm": lambda: rms_ops.rmsnorm(hx, hs, hr, 1e-6)}

        def host_us(fn, n=200):
            fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t1) / n * 1e6

        with torch.inference_mode():
            calls["run_xla"]()
            xfn = fops.xla_callable(an, [hx, hr, hs])
            host = {k: [host_us(f) for _ in range(3)]
                    for k, f in calls.items()}
        print(f"[26a xla host cost] one addnorm stack at {shape} bf16, host "
              f"us a call over 200 issued calls, 3 times: "
              + "  ".join(f"{k}={'/'.join(f'{v:.1f}' for v in vs)}"
                          for k, vs in host.items()))

        # a recompile-limit hit raises on the card's torch too, never eager
        import torch._dynamo
        from repro_torch.core import ir as rir
        prog = rir.StackProgram(
            name="pool_relu", inputs=("x",), outputs=("y",), layout="nhwc",
            ops=(rir.OpNode(rir.OpKind.POOL2D, "p", ("x",), "h", fn="max",
                            attrs={"window": (2, 2), "stride": (2, 2),
                                   "padding": (0, 0)}),
                 rir.OpNode(rir.OpKind.EW_UNARY, "r", ("h",), "y",
                            fn="relu")))
        with torch.no_grad():
            fops.fused_stack_apply(prog, {"x": self.randn((1, 8, 8, 4), 5)},
                                   {}, mode="xla")
            c0 = self.xla_counts()
            try:
                with torch._dynamo.config.patch(recompile_limit=1):
                    fops.fused_stack_apply(
                        prog, {"x": self.randn((1, 12, 12, 4), 6)}, {},
                        mode="xla")
            except torch._dynamo.exc.FailOnRecompileLimitHit as e:
                hit = str(e)
            else:
                raise PhaseError("26a: a second shape past recompile_limit=1 "
                                 "ran without raising")
        if self.xla_counts()[0] != c0[0]:
            raise PhaseError("26a: a call past the recompile limit counted")
        print(f"[26a recompile limit] a second nhwc shape past "
              f"recompile_limit=1 raised FailOnRecompileLimitHit ({hit!r}); "
              f"no call counted")
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[26a xla] graph breaks over the phase {self.xla_counts()[2]};"
              f" {time.perf_counter() - t:.1f} s")

    def phase26_autotune(self):
        """26b: ``OptimizeConfig(autotune=True)`` on the main path."""
        torch = self.torch
        import dataclasses
        import gc
        import os
        import tempfile

        from repro_torch import api as tapi
        from repro_torch.core import api, autotune
        from repro_torch.models import cnn, lm
        t = time.perf_counter()
        graph, params = cnn.vgg_net(VGG16_STAGES, device=self.dev)
        x = self.randn(VGG_INPUT, 7)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_") as d:
            for diff in (False, True):
                cfg = api.OptimizeConfig(mode="brainslug", autotune=True,
                                         autotune_cache_dir=d,
                                         differentiable=diff)
                autotune.clear_memory_cache()
                before = autotune.STATS.snapshot()
                t1 = time.perf_counter()
                net = api.optimize_graph(graph, VGG_INPUT, cfg)
                tuned_s = time.perf_counter() - t1
                delta = autotune.STATS.delta(before)
                rep = net.report()
                if delta["candidate_failures"] or len(rep.autotune) != \
                        net.n_stacks:
                    raise PhaseError(f"26b VGG autotune: {delta}\n{rep}")
                lines = [f"  {a.name}: {a.requested} -> {a.chosen}"
                         f"{' (guardrail)' if a.guardrail_tripped else ''}; "
                         + "  ".join(f"{v}/{p}={ms:.3f} ms"
                                     for v, p, ms in a.measured_ms)
                         for a in rep.autotune]
                # the same search again, cold, into a cache of its own: how
                # far a choice holds from one measurement to the next
                autotune.clear_memory_cache()
                again = api.optimize_graph(graph, VGG_INPUT, dataclasses.replace(
                    cfg, autotune_cache_dir=os.path.join(d, f"again{diff}")))
                rep2 = again.report()
                if len(rep2.autotune) != len(rep.autotune):
                    raise PhaseError(f"26b second tune: {rep2}")
                agree = [(a.name, a.chosen, b.chosen) for a, b in
                         zip(rep.autotune, rep2.autotune)]
                del again
                autotune.clear_memory_cache()
                before = autotune.STATS.snapshot()
                warm = api.optimize_graph(graph, VGG_INPUT, cfg)
                wdelta = autotune.STATS.delta(before)
                if wdelta["cache_hit_disk"] != len(rep.autotune) or \
                        wdelta["measure_runs"] or wdelta["cache_miss"]:
                    raise PhaseError(f"26b warm cache: {wdelta}")
                plain = api.optimize_graph(graph, VGG_INPUT,
                                           api.OptimizeConfig(mode="barrier"))
                with torch.no_grad():
                    got, want = warm(x, params), plain(x, params)
                err = float((got - want).abs().max())
                if not torch.allclose(got, want, **PATH_TOL):
                    raise PhaseError(f"26b autotuned VGG vs barrier "
                                     f"max|d|={err:.3e}")
                print(f"[26b VGG-16 autotune{' differentiable' if diff else ''}"
                      f"] optimize_graph {VGG_INPUT} mode=brainslug "
                      f"autotune=True: {delta['decisions']} decisions, "
                      f"{delta['measure_runs']} measure runs, "
                      f"{delta['candidate_failures']} candidate failures, "
                      f"{delta['guardrail_trips']} guardrail trips, "
                      f"{tuned_s:.1f} s; again after clear_memory_cache(): "
                      f"cache_hit_disk {wdelta['cache_hit_disk']}, "
                      f"measure_runs {wdelta['measure_runs']}; the chosen "
                      f"net against barrier max|d|={err:.3e} (tol "
                      f"{PATH_TOL}); per stack, the choice and each "
                      f"candidate's median ms a call (CUDA events over "
                      f"back-to-back calls):\n" + "\n".join(lines)
                      + f"\n  a second cold tune agrees on "
                      f"{sum(a == b for _, a, b in agree)} of {len(agree)}: "
                      + "  ".join(f"{n} {a}/{b}" for n, a, b in agree))
                del net, warm, plain
            # the traced VGG: the function-level floor
            autotune.clear_memory_cache()
            before = autotune.STATS.snapshot()
            tnet = tapi.optimize(cnn.vgg_fn, x, params, config=tapi.
                                 OptimizeConfig(mode="brainslug",
                                                autotune=True,
                                                autotune_cache_dir=d))
            delta = autotune.STATS.delta(before)
            floor = tnet.autotune_decisions.get(-1)
            if floor is None or delta["candidate_failures"]:
                raise PhaseError(f"26b traced VGG autotune: {delta}, floor "
                                 f"{floor}")
            with torch.no_grad():
                got, want = tnet(x, params), cnn.vgg_fn(x, params)
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, **PATH_TOL):
                raise PhaseError(f"26b traced VGG vs vgg_fn max|d|={err:.3e}")
            print(f"[26b traced VGG-16 floor] api.optimize(vgg_fn) "
                  f"autotune=True: {len(tnet.autotune_decisions)} decisions; "
                  f"function floor {floor.requested} -> {floor.variant} "
                  f"({'passthrough to vgg_fn' if tnet.passthrough else 'the rewrite runs'}): "
                  + "  ".join(f"{v}={ms:.3f} ms"
                              for v, _, ms in floor.measured_ms)
                  + f"; against vgg_fn max|d|={err:.3e}")
            del tnet
            # the registry kernels: hopper against ref
            heads, seq = 32, PREFILL[1]
            dt = torch.bfloat16
            p = lm.transformer_block_params(
                D_MODEL, heads, D_FF, generator=torch.Generator(
                    device=self.dev).manual_seed(23), dtype=dt,
                device=self.dev)
            xb = self.randn((1, seq, D_MODEL), 24).to(dt)
            autotune.clear_memory_cache()
            before = autotune.STATS.snapshot()

            def block(x, p):
                return lm.transformer_block_fn(x, p, n_heads=heads)

            bnet = tapi.optimize(
                block, xb, p, config=tapi.OptimizeConfig(
                    mode="brainslug", autotune=True, autotune_cache_dir=d))
            delta = autotune.STATS.delta(before)
            kern = [a for a in bnet.report().autotune if a.kind == "kernel"]
            if len(kern) != 4 or delta["candidate_failures"]:
                raise PhaseError(f"26b block autotune: {delta}\n"
                                 f"{bnet.report()}")
            print(f"[26b registry kernels] transformer_block_fn (1, {seq}, "
                  f"{D_MODEL}) bf16, autotune=True: "
                  + "; ".join(f"{a.name} {a.requested} -> {a.chosen} ("
                              + "  ".join(f"{v}={ms:.4f} ms"
                                          for v, _, ms in a.measured_ms)
                              + ")" for a in kern)
                  + f"; {delta['decisions']} decisions in all, "
                  f"{delta['candidate_failures']} candidate failures; "
                  f"{time.perf_counter() - t:.1f} s")
            del bnet, p, xb
        gc.collect()
        torch.cuda.empty_cache()

    def phase26_remat(self):
        """26c: ``remat`` none / dots / full on one set of weights."""
        torch = self.torch
        import dataclasses
        import gc

        from repro_torch.configs import LM_SHAPES, get_config
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.data import pipeline
        from repro_torch.layers import base
        from repro_torch.models import lm
        cfg = dataclasses.replace(get_config("deepseek-7b"),
                                  n_layers=XLA_LM["remat_layers"])
        shape = dataclasses.replace(LM_SHAPES["train_4k"], global_batch=1,
                                    seq_len=TRAIN_LM["seq"])
        batch = {k: torch.from_numpy(a).to(self.dev) for k, a in
                 pipeline.synth_batch(cfg, shape, 0, 0).items()}
        params = lm.init(0, cfg, device=self.dev)
        res = {}
        for remat in ("none", "dots", "full", "dots", "none"):
            live = base.tree_map(lambda q: q.detach().requires_grad_(),
                                 params)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_gib = torch.cuda.memory_allocated() / 2 ** 30
            t1 = time.perf_counter()
            with torch.enable_grad():
                loss, _ = lm.loss_fn(live, batch, cfg, RuntimeConfig(
                    mode="brainslug", remat=remat))
                grads = torch.autograd.grad(loss, base.tree_leaves(live))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t1)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if remat in res:
                res[remat]["ms"].append(ms)
                if not all(torch.equal(a, b) for a, b in zip(
                        grads, res[remat]["grads"])):
                    raise PhaseError(f"26c remat={remat}: two steps from one "
                                     f"state differ in bits")
            else:
                res[remat] = dict(loss=float(loss.detach()), grads=grads,
                                  ms=[ms],
                                  peak=peak - base_gib, base=base_gib)
            del live, loss, grads
        same = all(torch.equal(a, b) for a, b in zip(res["dots"]["grads"],
                                                     res["none"]["grads"]))
        peaks = {r: v["peak"] for r, v in res.items()}
        if not peaks["full"] <= peaks["dots"] <= peaks["none"]:
            raise PhaseError(f"26c peak memory above the weights {peaks} GiB:"
                             f" not full <= dots <= none")
        if not same or res["dots"]["loss"] != res["none"]["loss"]:
            raise PhaseError("26c remat=dots: gradients differ from "
                             "remat=none's in bits")

        # which products the backward recomputes: aten's mm / addmm / bmm
        # counted while the backward runs (the hand kernels are no aten ops)
        from torch.utils._python_dispatch import TorchDispatchMode
        aten = torch.ops.aten
        products = {"mm": aten.mm.default, "addmm": aten.addmm.default,
                    "bmm": aten.bmm.default}

        class Products(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.counts = dict.fromkeys(products, 0)

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                for name, op in products.items():
                    if func is op:
                        self.counts[name] += 1
                return func(*args, **(kwargs or {}))

        counts = {}
        for remat in ("none", "dots", "full"):
            live = base.tree_map(lambda q: q.detach().requires_grad_(),
                                 params)
            with torch.enable_grad():
                loss, _ = lm.loss_fn(live, batch, cfg, RuntimeConfig(
                    mode="brainslug", remat=remat))
                with Products() as bwd:
                    torch.autograd.grad(loss, base.tree_leaves(live))
            counts[remat] = bwd.counts
            del live, loss
        mms = {r: c["mm"] + c["addmm"] for r, c in counts.items()}
        if mms["dots"] != mms["none"] or \
                mms["full"] < mms["none"] + cfg.n_layers:
            raise PhaseError(f"26c backward products {counts}: dots must "
                             f"recompute no mm/addmm, full at least one a "
                             f"layer")
        print(f"[26c remat] deepseek-7b at full width cut to {cfg.n_layers} "
              f"layers, bf16, 1 x {TRAIN_LM['seq']} tokens, brainslug, one "
              f"forward + backward from one set of weights each: peak memory "
              f"above the {res['none']['base']:.2f} GiB held before the step"
              f" (max_memory_allocated after reset_peak_memory_stats) "
              + "  ".join(f"{r}={v:.2f} GiB" for r, v in peaks.items())
              + " (full <= dots <= none holds); step wall (host clock around "
              f"synchronised steps, in turns none dots full dots none) "
              + "  ".join(f"{r}={'/'.join(f'{m:.1f}' for m in v['ms'])} ms"
                          for r, v in res.items())
              + f"; loss {res['none']['loss']}; dots gradients equal none's "
              f"bit for bit; aten products run in the backward "
              + "  ".join(f"{r}={c}" for r, c in counts.items())
              + f": dots recomputes {mms['dots'] - mms['none']} mm/addmm, "
              f"full {mms['full'] - mms['none']}")
        del params, res, batch
        gc.collect()
        torch.cuda.empty_cache()

    # -- phase 27: the multimodal frontends ---------------------------------
    @contextlib.contextmanager
    def flash_causal_flags(self):
        """Records the ``causal`` flag of every flash attention launch on a
        CUDA tensor while it is held.  The wrapper counts its launches on
        the module's name, so the count rides on the stand-in while it is
        held and goes back to the wrapper after: read the counters after
        leaving."""
        from repro_torch.kernels.attention import flash
        orig, flags = flash.flash_attention_fwd, []

        def recorded(q, k, v, *, causal=True, **kw):
            if q.is_cuda:
                flags.append(causal)
            return orig(q, k, v, causal=causal, **kw)

        recorded.launches = orig.launches
        flash.flash_attention_fwd = recorded
        try:
            yield flags
        finally:
            flash.flash_attention_fwd = orig
            orig.launches = recorded.launches

    @contextlib.contextmanager
    def block_drop(self, n_layers, layer):
        """The planted defect: the block at ``layer`` of every forward of
        ``n_layers`` blocks adds nothing to the residual stream (its
        attention and MLP outputs dropped).  Yields a list whose length
        counts the blocks dropped."""
        from repro_torch.models import lm
        saved, seen, dropped = lm._apply_sub, [0], []

        def apply(kind, p, resid, pending, *a, **kw):
            seen[0] += 1
            if seen[0] % n_layers == layer % n_layers:
                dropped.append(1)
                return resid + pending, self.torch.zeros_like(pending), None
            return saved(kind, p, resid, pending, *a, **kw)

        lm._apply_sub = apply
        try:
            yield dropped
        finally:
            lm._apply_sub = saved

    def mm_train(self, tag, arch, layers, per_step, control=True, **kw):
        """Three AdamW steps per mode through ``Trainer.run`` (brainslug's
        counters per step as ``per_step`` says, barrier's all 0), and with
        ``control`` a barrier run with one block dropped; returns {run:
        (losses, grad norms)} and the phrases of the peaks and walls."""
        kw = dict(arch=arch, counters=self.hybrid_counters, **kw)
        runs, notes = {}, []
        for mode in ("brainslug", "barrier"):
            hist, steps, peak, wall = self.train_lm(mode, layers, "bfloat16",
                                                    **kw)
            for i, got in enumerate(steps):
                self.expect_hybrid(f"{tag} {arch} train {mode} step {i + 1}",
                                   got, **(per_step if mode == "brainslug"
                                           else {}))
            runs[mode] = ([h["loss"] for h in hist],
                          [h["grad_norm"] for h in hist])
            notes.append(f"{mode} peak {peak:.2f} GiB wall {wall:.1f} s")
            if mode == "brainslug":
                self.mm_launches[f"{arch} train_step"] = steps[0]
        if control:
            with self.block_drop(layers,
                                 MULTIMODAL["drop_layer"]) as dropped:
                hist = self.train_lm("barrier", layers, "bfloat16", **kw)[0]
            if not dropped:
                raise PhaseError(f"{tag} control: no block was dropped")
            runs["dropped"] = ([h["loss"] for h in hist],
                               [h["grad_norm"] for h in hist])
        for run in runs.values():
            if not all(math.isfinite(x) for v in run for x in v):
                raise PhaseError(f"{tag} {arch} train: {runs}")
        return runs, notes

    def mm_gaps(self, runs, other):
        """Per step, brainslug's (or ``other``'s) relative loss and grad
        norm gaps to barrier, and the limits of 18a each breaks."""
        ref_l, ref_g = runs["barrier"]
        gl = [abs(a - b) / abs(b) for a, b in zip(runs[other][0], ref_l)]
        gg = [abs(a - b) / abs(b) for a, b in zip(runs[other][1], ref_g)]
        broken = [f"step-{i + 1} loss" for i, (g, lim) in enumerate(
            zip(gl, TRAIN_BF16_LOSS_REL)) if g > lim] + [
            f"step-{i + 1} grad_norm" for i, g in enumerate(gg)
            if g > TRAIN_BF16_GNORM_REL]
        return gl, gg, broken

    def hubert(self):
        """27b: hubert-xlarge at full width: the forward of 2048 frames at
        all 48 layers (float32 and bf16 frames), three training steps at
        MULTIMODAL's 8 layers, the Server and the Engine refusing it."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.launch import engine, serve
        from repro_torch.layers import base
        from repro_torch.models import lm
        t = time.perf_counter()
        cfg = get_config(MULTIMODAL["hubert"])
        L = cfg.n_layers
        params = lm.init(0, cfg, device=self.dev)
        torch.cuda.synchronize()
        print(f"[27 model] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads of {cfg.head_dim} (non-causal), d_ff "
              f"{cfg.d_ff} ({cfg.act}, biases), {cfg.norm} norm, vocab "
              f"{cfg.vocab_size}, frames of {cfg.frontend_dim}, {cfg.dtype}: "
              f"{base.param_count(params) / 1e9:.3f} B random parameters "
              f"(seed 0)")
        frames = self.randn((1, MULTIMODAL["frames"], cfg.frontend_dim), 2710)
        lines, logits = [], {}
        with torch.inference_mode():
            for name, batch, lim in (
                    ("float32", {"frames": frames}, PATH_F32_REL),
                    ("bfloat16", {"frames": frames.bfloat16()},
                     PATH_BF16_REL)):
                want = lm.forward(params, batch, cfg,
                                  RuntimeConfig(mode="barrier"))[0]
                torch.cuda.synchronize()
                self.hybrid_counters(zero=True)
                with self.flash_causal_flags() as flags:
                    got = lm.forward(params, batch, cfg,
                                     RuntimeConfig(mode="brainslug"))[0]
                    torch.cuda.synchronize()
                counts = self.hybrid_counters()
                self.expect_hybrid(f"27b hubert forward, {name} frames",
                                   counts, flash_attention=L,
                                   fused_rows=3 * L + 1)
                if flags != [False] * L:
                    raise PhaseError(f"27b hubert: flash launches' causal "
                                     f"flags {flags}, expected {L} False")
                shape = (1, MULTIMODAL["frames"], cfg.vocab_size)
                dt = getattr(torch, name)
                if tuple(got.shape) != shape or got.dtype != dt or \
                        want.dtype != dt or not bool(
                            torch.isfinite(got).all()):
                    raise PhaseError(f"27b hubert {name} frames: logits "
                                     f"{tuple(got.shape)} {got.dtype} "
                                     f"(barrier {want.dtype}), expected "
                                     f"{shape} {dt}, finite")
                rel = self.relative(got, want)
                if not rel <= lim:
                    raise PhaseError(f"27b hubert {name} frames: brainslug "
                                     f"vs barrier max|d|/max {rel:.3e} > "
                                     f"{lim}")
                logits[name] = want
                lines.append(f"{name} frames: {dt} logits {shape}, "
                             f"max|d|/max|logits| {rel:.3e} (tol {lim})")
            self.mm_launches["hubert forward"] = counts
            with self.block_drop(L, MULTIMODAL["drop_layer"]) as dropped:
                bad = lm.forward(params, {"frames": frames.bfloat16()}, cfg,
                                 RuntimeConfig(mode="barrier"))[0]
            rel_c = self.relative(bad, logits["bfloat16"])
            if len(dropped) != 1 or not rel_c > PATH_BF16_REL:
                raise PhaseError(f"27b hubert control: layer "
                                 f"{MULTIMODAL['drop_layer']} dropped "
                                 f"({len(dropped)} blocks) reads "
                                 f"{rel_c:.3e}, within {PATH_BF16_REL}")
        print(f"[27b hubert forward] lm.forward of (1, "
              f"{MULTIMODAL['frames']}) frames at all {L} layers, brainslug "
              f"vs barrier: " + "; ".join(lines) + f"; every flash launch "
              f"causal=False; counters (bf16 frames) {counts}; control: "
              f"barrier with layer {MULTIMODAL['drop_layer']}'s block "
              f"dropped reads {rel_c:.3e} against the sound barrier, "
              f"flagged by {PATH_BF16_REL}; {time.perf_counter() - t:.1f} s")
        del params, logits, want, got, bad, frames
        torch.cuda.empty_cache()

        # training: float32 frames from the pipeline over bf16 weights, so
        # the stream, flash attention and the CE kernel run in float32
        t = time.perf_counter()
        Lt = MULTIMODAL["hubert_train_layers"]
        rows = 3 * Lt + 1
        runs, notes = self.mm_train(
            "27b", cfg.name, Lt, dict(flash_attention=Lt, fused_rows=rows,
                                      fused_rows_bwd=rows, fused_ce=1))
        gl, gg, broken = self.mm_gaps(runs, "brainslug")
        if broken:
            raise PhaseError(f"27b hubert train: brainslug vs barrier loss "
                             f"gaps {gl}, grad_norm gaps {gg} break "
                             f"{broken}")
        cl, cg, flagged = self.mm_gaps(runs, "dropped")
        if not flagged:
            raise PhaseError(f"27b hubert train control (layer "
                             f"{MULTIMODAL['drop_layer']} dropped): loss gaps "
                             f"{cl}, grad_norm gaps {cg} within every limit")
        grads = {m: self.lm_step1_grads(m, Lt, "bfloat16",
                                        names=("frontend_proj",),
                                        arch=cfg.name)["frontend_proj"]
                 for m in ("brainslug", "barrier")}
        g_rel = self.rel_l2([grads["brainslug"]], [grads["barrier"]])
        g_max = float(grads["brainslug"].float().abs().max())
        if grads["brainslug"].dtype != torch.bfloat16 or not g_max > 0 or \
                not g_rel <= MULTIMODAL["grad_l2"]:
            raise PhaseError(f"27b hubert step-1 frontend_proj gradient: "
                             f"{grads['brainslug'].dtype}, max|g| {g_max}, "
                             f"relative L2 to barrier's {g_rel:.3e} (tol "
                             f"{MULTIMODAL['grad_l2']})")
        del grads
        for what, make in (
                ("Server", lambda: serve.Server(serve.ServeConfig(
                    arch=cfg.name, reduced=False, torch_device="cuda"))),
                ("Engine", lambda: engine.Engine(
                    cfg, {"embed": torch.zeros(1, device=self.dev)},
                    RuntimeConfig(), slots=1, max_len=8))):
            try:
                make()
            except ValueError as e:
                if "encoder-only" not in str(e):
                    raise PhaseError(f"27b hubert {what}: {e}") from e
            else:
                raise PhaseError(f"27b hubert: {what} took an encoder")
        print(f"[27b hubert train] {cfg.name} at full width cut to {Lt} "
              f"layers, bf16 weights, 1 x {TRAIN_LM['seq']} float32 frames "
              f"(the pipeline's), {TRAIN_LM['steps']} AdamW steps lr "
              f"{TRAIN_LM['lr']} through build_trainer / Trainer.run: "
              f"brainslug losses {runs['brainslug'][0]} grad_norm "
              f"{runs['brainslug'][1]}; barrier losses {runs['barrier'][0]} "
              f"grad_norm {runs['barrier'][1]}; gaps loss "
              f"{[f'{g:.2e}' for g in gl]} (tol {TRAIN_BF16_LOSS_REL}) "
              f"grad_norm {[f'{g:.2e}' for g in gg]} (tol "
              f"{TRAIN_BF16_GNORM_REL}); control (layer "
              f"{MULTIMODAL['drop_layer']}'s block dropped in barrier) gaps "
              f"loss {[f'{g:.2e}' for g in cl]} grad_norm "
              f"{[f'{g:.2e}' for g in cg]}, flagged by "
              f"{', '.join(flagged)}; brainslug counters per step "
              f"{self.mm_launches[cfg.name + ' train_step']}; step-1 "
              f"frontend_proj gradient (bf16) max|g| {g_max:.3e}, relative L2 "
              f"to barrier's {g_rel:.3e} (tol {MULTIMODAL['grad_l2']}); "
              + "; ".join(notes) + "; Server and Engine raise ValueError "
              f"(encoder-only); {time.perf_counter() - t:.1f} s")

    def paligemma(self):
        """27c: paligemma-3b at full width: lm.prefill of 256 patches and
        1792 tokens at all 18 layers, Server.generate at 6, the paged
        engine at 4, float32 serving at 2, three training steps at 6."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.layers import base
        from repro_torch.models import lm
        t = time.perf_counter()
        cfg = get_config(MULTIMODAL["paligemma"])
        L = cfg.n_layers
        params = lm.init(0, cfg, device=self.dev)
        torch.cuda.synchronize()
        print(f"[27 model] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads of {cfg.head_dim} over {cfg.n_kv_heads}, "
              f"d_ff {cfg.d_ff} (gated {cfg.act}), vocab {cfg.vocab_size} "
              f"tied, {cfg.n_prefix_tokens} patches of {cfg.frontend_dim}, "
              f"{cfg.dtype}: {base.param_count(params) / 1e9:.3f} B random "
              f"parameters (seed 0)")
        g = torch.Generator(device=self.dev).manual_seed(2720)
        batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                         (1, MULTIMODAL["text"]),
                                         generator=g, device=self.dev),
                 "patches": self.randn((1, cfg.n_prefix_tokens,
                                        cfg.frontend_dim), 2721)}
        with torch.inference_mode():
            want = lm.prefill(params, batch, cfg,
                              RuntimeConfig(mode="barrier"))
            torch.cuda.synchronize()
            self.hybrid_counters(zero=True)
            got = lm.prefill(params, batch, cfg,
                             RuntimeConfig(mode="brainslug"))
            torch.cuda.synchronize()
            counts = self.hybrid_counters()
            self.expect_hybrid("27c paligemma prefill", counts,
                               flash_attention=L, rmsnorm=2 * L + 1,
                               swiglu=L)
            self.mm_launches["paligemma prefill"] = counts
            if tuple(got.shape) != (1, 1, cfg.vocab_size) or \
                    got.dtype != torch.bfloat16 or not bool(
                        torch.isfinite(got).all()):
                raise PhaseError(f"27c paligemma prefill: logits "
                                 f"{tuple(got.shape)} {got.dtype}")
            rel = self.relative(got, want)
            if not rel <= PATH_BF16_REL:
                raise PhaseError(f"27c paligemma prefill: brainslug vs "
                                 f"barrier max|d|/max {rel:.3e} > "
                                 f"{PATH_BF16_REL}")
            with self.block_drop(L, MULTIMODAL["drop_layer"]) as dropped:
                bad = lm.prefill(params, batch, cfg,
                                 RuntimeConfig(mode="barrier"))
            rel_c = self.relative(bad, want)
            if len(dropped) != 1 or not rel_c > PATH_BF16_REL:
                raise PhaseError(f"27c paligemma control: layer "
                                 f"{MULTIMODAL['drop_layer']} dropped reads "
                                 f"{rel_c:.3e}, within {PATH_BF16_REL}")
        print(f"[27c paligemma prefill] lm.prefill of {cfg.n_prefix_tokens} "
              f"float32 patches and {MULTIMODAL['text']} tokens at all {L} "
              f"layers (causal over {cfg.n_prefix_tokens + MULTIMODAL['text']}"
              f" positions), brainslug vs barrier last-position logits: "
              f"max|d|/max|logits| {rel:.3e} (tol {PATH_BF16_REL}), argmax "
              f"equal {bool(got.argmax() == want.argmax())}; control: layer "
              f"{MULTIMODAL['drop_layer']}'s block dropped in barrier reads "
              f"{rel_c:.3e}, flagged; counters {counts}; "
              f"{time.perf_counter() - t:.1f} s")
        del want, got, bad, batch
        torch.cuda.empty_cache()

        # Server.generate: text only (the Server drops the frontend)
        t = time.perf_counter()
        prompts = np.random.default_rng(2722).integers(
            0, cfg.vocab_size, (SERVE["batch"], SERVE["prompt_len"])
        ).astype(np.int32)
        Ls = MULTIMODAL["pali_serve_layers"]
        servers, gens, counts = self.serve_pair(
            dataclasses.replace(cfg, n_layers=Ls),
            {**params, "blocks": base.tree_map(lambda a: a[:Ls],
                                               params["blocks"])}, prompts)
        steps = SERVE["prompt_len"] + SERVE["new_tokens"] - 1
        self.expect_counters("27c paligemma serving", counts, {
            "rmsnorm": steps * (2 * Ls + 1), "swiglu": steps * Ls,
            "flash_attention": 0, "flash_decode": steps * Ls})
        self.mm_launches["paligemma decode_step"] = {
            k: counts[k] // steps for k in ("rmsnorm", "swiglu",
                                            "flash_decode")}
        if servers["brainslug"].cfg.frontend is not None:
            raise PhaseError("27c paligemma Server kept its frontend")
        errs = self.teacher_forced(servers, prompts, gens["barrier"])[
            ("brainslug", "barrier")]
        if not max(errs) <= PATH_BF16_REL:
            raise PhaseError(f"27c paligemma serving: teacher-forced logits "
                             f"max|d|/max {max(errs):.3e} > {PATH_BF16_REL}")
        agree = float((gens["brainslug"] == gens["barrier"]).mean())
        print(f"[27c paligemma Server.generate] text only (the Server drops "
              f"the vision frontend), {Ls} of the {L} layers, "
              f"{SERVE['batch']} requests, "
              f"prompt {SERVE['prompt_len']}, {SERVE['new_tokens']} new, "
              f"greedy: token agreement {agree:.4f}; teacher-forced logits "
              f"max|d|/max worst {max(errs):.3e}, median "
              f"{statistics.median(errs):.3e} (tol {PATH_BF16_REL}); "
              f"counters {counts}; {time.perf_counter() - t:.1f} s")
        del servers

        # the paged engine at 4 layers, text only
        t = time.perf_counter()
        Le = MULTIMODAL["pali_engine_layers"]
        text = dataclasses.replace(cfg, n_layers=Le, frontend=None,
                                   n_prefix_tokens=0)
        p_e = {**params, "blocks": base.tree_map(lambda a: a[:Le],
                                                 params["blocks"])}
        reqs = self.engine_queue(cfg.vocab_size)
        res = {}
        for mode in ("brainslug", "barrier"):
            eng, comps, counts, wall = self.engine_run(text, p_e, "paged",
                                                       mode, reqs)
            res[mode] = (eng, comps, wall)
            if mode == "brainslug":
                e = self.evaluations(eng.last_stats)
                self.expect_counters("27c paligemma engine", counts, {
                    "rmsnorm": (2 * Le + 1) * e, "swiglu": Le * e,
                    "flash_attention": 0, "flash_decode": 0,
                    "paged_flash_decode": Le * e})
                self.mm_launches["paligemma engine_evaluation"] = {
                    k: counts[k] // e for k in ("rmsnorm", "swiglu",
                                                "paged_flash_decode")}
        greedy = [i for i, r in enumerate(reqs) if r.temperature <= 0.0]
        pb, pr = res["brainslug"][1], res["barrier"][1]
        n_tok = sum(len(pr[i].tokens) for i in greedy)
        agree = sum(int((pb[i].tokens == pr[i].tokens).sum())
                    for i in greedy) / max(n_tok, 1)
        pick = [i for i in greedy if reqs[i].max_new_tokens > 0][:4]
        seqs = [list(reqs[i].prompt) + pr[i].tokens.tolist() for i in pick]
        starts = [len(reqs[i].prompt) for i in pick]
        forced = {m: self.forced_logits(text, p_e, m, seqs, starts)
                  for m in ("brainslug", "barrier")}
        errs = [self.relative(a, b) for a, b in zip(forced["brainslug"],
                                                   forced["barrier"])]
        if not max(errs) <= PATH_BF16_REL:
            raise PhaseError(f"27c paligemma engine: teacher-forced logits "
                             f"max|d|/max {max(errs):.3e} > {PATH_BF16_REL}")
        st = res["brainslug"][0].last_stats
        print(f"[27c paligemma engine] Server.engine(kv_layout='paged').run "
              f"of phase 15's 12 requests at {Le} layers, text only: every "
              f"request completed in both modes, no kv.* finding, the free "
              f"list whole; per model evaluation "
              f"{self.mm_launches['paligemma engine_evaluation']}, plain 0; "
              f"greedy token agreement vs barrier {agree:.4f}; teacher-forced "
              f"logits max|d|/max worst {max(errs):.3e} (tol "
              f"{PATH_BF16_REL}); prefix hits {st.prefix_hit_tokens} tokens; "
              f"wall brainslug {res['brainslug'][2]:.1f} s, barrier "
              f"{res['barrier'][2]:.1f} s; {time.perf_counter() - t:.1f} s")
        del res, forced, p_e, params
        torch.cuda.empty_cache()

        # float32 at 2 layers: identical greedy tokens
        t = time.perf_counter()
        L32 = MULTIMODAL["f32_layers"]
        cfg32 = dataclasses.replace(cfg, n_layers=L32, dtype="float32")
        p32 = lm.init(1, cfg32, device=self.dev)
        servers, gens, counts = self.serve_pair(cfg32, p32, prompts)
        self.expect_counters("27c paligemma serving f32", counts, {
            "rmsnorm": steps * (2 * L32 + 1), "swiglu": steps * L32,
            "flash_attention": 0, "flash_decode": steps * L32})
        if not np.array_equal(gens["brainslug"], gens["barrier"]):
            raise PhaseError("27c paligemma serving f32: brainslug's tokens "
                             "differ from barrier's")
        errs = self.teacher_forced(servers, prompts, gens["barrier"])[
            ("brainslug", "barrier")]
        if not max(errs) <= PATH_F32_REL:
            raise PhaseError(f"27c paligemma serving f32: logits max|d|/max "
                             f"{max(errs):.3e} > {PATH_F32_REL}")
        print(f"[27c paligemma float32, {L32} layers] Server.generate: "
              f"identical tokens; logits max|d|/max worst {max(errs):.3e} "
              f"(tol {PATH_F32_REL}); {time.perf_counter() - t:.1f} s")
        del servers, p32
        torch.cuda.empty_cache()

        # training: patches in front, the loss on the text positions, the
        # tied head on the plain chunked loss in every mode
        t = time.perf_counter()
        Lt = MULTIMODAL["pali_train_layers"]
        chunk = MULTIMODAL["loss_chunk"]
        runs, notes = self.mm_train(
            "27c", cfg.name, Lt, dict(flash_attention=Lt, rmsnorm=2 * Lt + 1,
                                      swiglu=Lt), control=False,
            loss_chunk=chunk)
        gl, gg, _ = self.mm_gaps(runs, "brainslug")
        grads = {run: self.lm_step1_grads(m, Lt, dt, names=("embed",),
                                          loss_chunk=chunk, arch=cfg.name,
                                          **kw)["embed"]
                 for run, m, dt, kw in (
                     ("brainslug", "brainslug", "bfloat16", {}),
                     ("barrier", "barrier", "bfloat16", {}),
                     ("float32", "barrier", "float32",
                      dict(init_dtype="bfloat16")))}
        d_b = self.rel_l2([grads["brainslug"]], [grads["float32"]])
        d_r = self.rel_l2([grads["barrier"]], [grads["float32"]])
        if not (float(grads["brainslug"].float().abs().max()) > 0
                and d_b <= SSM_F32_FACTOR * d_r):
            raise PhaseError(f"27c paligemma step-1 embed gradient: relative "
                             f"L2 to the float32 run's brainslug {d_b:.3e}, "
                             f"barrier {d_r:.3e} (factor {SSM_F32_FACTOR})")
        del grads
        print(f"[27c paligemma train] {cfg.name} at full width cut to {Lt} "
              f"layers, bf16, 1 x {cfg.n_prefix_tokens} float32 patches + "
              f"{TRAIN_LM['seq']} tokens, the loss on the {TRAIN_LM['seq']} "
              f"text positions (fused_loss_chunk {chunk}), "
              f"{TRAIN_LM['steps']} AdamW steps lr {TRAIN_LM['lr']} through "
              f"Trainer.run: brainslug losses {runs['brainslug'][0]} "
              f"grad_norm {runs['brainslug'][1]}; barrier losses "
              f"{runs['barrier'][0]} grad_norm {runs['barrier'][1]} (read: "
              f"gaps loss {[f'{g:.2e}' for g in gl]} grad_norm "
              f"{[f'{g:.2e}' for g in gg]}); "
              f"counters per step "
              f"{self.mm_launches[cfg.name + ' train_step']} (fused_ce 0: "
              f"the head is tied); step-1 embed gradient (bf16) relative L2 "
              f"to the float32 run's: brainslug {d_b:.3e}, barrier "
              f"{d_r:.3e} (brainslug within {SSM_F32_FACTOR}x barrier's); "
              + "; ".join(notes) + f"; {time.perf_counter() - t:.1f} s")

    def phase27_multimodal(self):
        """27a the attention kernels at head dims 80 and 256, 27b
        hubert-xlarge, 27c paligemma-3b; the launches of each path folded
        into the kernels line."""
        t0 = time.perf_counter()
        self.mm_launches = {}
        self.attention_kernels(80, 16, 16, "27a", 2700,
                               full_causal=(True, False), ragged=(1, 1000),
                               ragged_causal=(True, False),
                               with_decode=False, timed_causal=False)
        self.attention_kernels(256, 8, 1, "27a", 2760, ragged=(1, 1000),
                               ragged_causal=(True,), every_split=True)
        self.hubert()
        self.paligemma()
        la = self.mm_launches
        hub, pali = MULTIMODAL["hubert"], MULTIMODAL["paligemma"]
        for name, d, where in (
                ("flash_attention", 80, {"hubert forward": la[
                    "hubert forward"], "hubert train_step": la[
                        hub + " train_step"]}),
                ("flash_attention", 256, {"paligemma prefill": la[
                    "paligemma prefill"], "paligemma train_step": la[
                        pali + " train_step"]}),
                ("flash_decode", 256, {"paligemma decode_step": la[
                    "paligemma decode_step"]}),
                ("paged_flash_decode", 256, {
                    "paligemma engine_evaluation": la[
                        "paligemma engine_evaluation"]})):
            entry = self.kernels[name][f"head_dim_{d}"]
            entry["launches"] = {w: c[name] for w, c in where.items()}
            entry["max_abs_err"] = self.err[name]
        for name, where in (
                ("fused_rows", ("hubert forward", hub + " train_step")),
                ("fused_rows_bwd", (hub + " train_step",)),
                ("rmsnorm", ("paligemma prefill", "paligemma decode_step",
                             pali + " train_step")),
                ("swiglu", ("paligemma prefill", "paligemma decode_step",
                            pali + " train_step")),
                ("fused_ce", (hub + " train_step", pali + " train_step"))):
            self.kernels.setdefault(name, {})["multimodal"] = {
                "launches": {w: la[w][name] for w in where}}
        print(f"[27 launches] " + "; ".join(f"{w} {c}" for w, c in la.items())
              + f"; phase {time.perf_counter() - t0:.1f} s")

    # -- phase 28: the static verifier ----------------------------------------
    def phase28_verify(self):
        """(a) the lint CLI on the H100 spec; (b) ``optimize`` at full width
        under ``verify="strict"``; (c) the four fused-stack kernels' write
        models against what the kernels write on the card."""
        t0 = time.perf_counter()
        from repro_torch import lint
        t = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rc = lint.main(["--device", "h100"])
        if rc != 0:
            print(log.getvalue())
            raise PhaseError(f"28a: python -m repro_torch.lint --device h100 "
                             f"exited {rc}")
        print(f"[28a lint] python -m repro_torch.lint --device h100: exit 0 "
              f"over every default arch in {time.perf_counter() - t:.2f} s")
        self.phase28_optimize()
        self.phase28_write_models()
        print(f"[28] phase {time.perf_counter() - t0:.1f} s")

    def strict_net(self, what, build):
        """``build(verify)`` under ``"strict"``: zero error findings (a
        strict compile raises on one), the verifier's host seconds and its
        share of the whole ``optimize`` call."""
        from repro_torch.core import verify
        t = time.perf_counter()
        net = build("strict")
        total = time.perf_counter() - t
        errs = verify.errors(net.verify_findings)
        if errs:
            raise PhaseError(f"28b {what}: {len(errs)} error findings under "
                             f"strict: {errs[0]}")
        rep = net.report()
        if rep.verify_errors or rep.kernel_fallbacks or any(
                k.backend != "hopper" for k in rep.kernels):
            raise PhaseError(f"28b {what}: {rep}")
        self.verify_seconds[what] = (net.verify_seconds, total,
                                     rep.verify_warnings)
        return net

    def phase28_optimize(self):
        """28b: the main paths' ``optimize`` calls of phases 4 and 23 at full
        width under ``verify="strict"``, each held to ``barrier`` at those
        phases' limits with every dispatch on a hand-written kernel."""
        torch = self.torch
        import gc

        from repro_torch import api
        from repro_torch.core import api as core_api
        from repro_torch.models import cnn, lm
        t = time.perf_counter()
        self.verify_seconds = {}
        lines = []

        def held(what, got, want, tol, n_seq, **launches):
            rel = float((got.float() - want.float()).abs().max()) / max(
                float(want.float().abs().max()), 1e-30)
            if not bool(torch.isfinite(got).all()) or got.shape != want.shape \
                    or not torch.allclose(got.float(), want.float(), **tol):
                raise PhaseError(f"28b {what}: max|d|/max|y| {rel:.3e} "
                                 f"outside {tol}")
            lines.append(f"{what} max|d|/max|y| {rel:.2e}")

        graph, params = cnn.vgg_net(VGG16_STAGES, device=self.dev)
        x = self.randn(VGG_INPUT, 7)
        with torch.no_grad():
            want = core_api.optimize_graph(
                graph, VGG_INPUT, core_api.OptimizeConfig(mode="barrier"))(
                    x, params)
            for diff in (False, True):
                what = f"optimize_graph VGG-16{' train' if diff else ''}"
                net = self.strict_net(what, lambda v: core_api.optimize_graph(
                    graph, VGG_INPUT, core_api.OptimizeConfig(
                        mode="brainslug", differentiable=diff, verify=v)))
                self.traced_counts(zero=True)
                got = net(x, params)
                torch.cuda.synchronize()
                self.expect_traced(what, self.traced_counts(),
                                   net.n_sequences,
                                   fused_nhwc=net.n_sequences)
                held(what, got, want, PATH_TOL, net.n_sequences)
            net = self.strict_net("optimize(vgg_fn)", lambda v: api.optimize(
                cnn.vgg_fn, x, params, config=api.OptimizeConfig(
                    mode="brainslug", verify=v)))
            self.traced_counts(zero=True)
            got = net(x, params)
            torch.cuda.synchronize()
            self.expect_traced("optimize(vgg_fn)", self.traced_counts(),
                               net.n_sequences, fused_nhwc=net.n_sequences)
            held("optimize(vgg_fn)", got, cnn.vgg_fn(x, params), PATH_TOL,
                 net.n_sequences)
        del graph, params, x, want, got, net
        _, bparams = cnn.block_net(8, 32, device=self.dev)
        bx = self.randn(BLOCK_INPUT, 11)
        net = self.strict_net("optimize(block_fn) train", lambda v:
                              api.optimize(cnn.block_fn, bx, bparams,
                                           config=api.OptimizeConfig(
                                               mode="brainslug",
                                               differentiable=True,
                                               verify=v)))
        with torch.no_grad():
            self.traced_counts(zero=True)
            got = net(bx, bparams)
            torch.cuda.synchronize()
            self.expect_traced("optimize(block_fn) train",
                               self.traced_counts(), net.n_sequences,
                               fused_nhwc=net.n_sequences)
            held("optimize(block_fn) train", got, cnn.block_fn(bx, bparams),
                 PATH_TOL, net.n_sequences)
        del bparams, bx, got, net
        heads, seq = 32, PREFILL[1]
        p = lm.transformer_block_params(
            D_MODEL, heads, D_FF, generator=torch.Generator(
                device=self.dev).manual_seed(23), dtype=torch.bfloat16,
            device=self.dev)
        xb = self.randn((1, seq, D_MODEL), 24).to(torch.bfloat16)

        def block(x, p):
            return lm.transformer_block_fn(x, p, n_heads=heads)

        net = self.strict_net("optimize(transformer_block_fn) bf16", lambda v:
                              api.optimize(block, xb, p,
                                           config=api.OptimizeConfig(
                                               mode="brainslug", verify=v)))
        with torch.no_grad():
            want = api.optimize(block, xb, p, config=api.OptimizeConfig(
                mode="barrier", verify="off"))(xb, p)
            self.traced_counts(zero=True)
            got = net(xb, p)
            torch.cuda.synchronize()
            self.expect_traced("transformer_block_fn", self.traced_counts(),
                               net.n_sequences, fused_rows=net.n_sequences,
                               flash_attention=1, rmsnorm=2, swiglu=1)
            rel = float((got.float() - want.float()).abs().max()) / float(
                want.float().abs().max())
            if not bool(torch.isfinite(got).all()) or rel > 2e-2:
                raise PhaseError(f"28b transformer_block_fn: max|d|/max|y| "
                                 f"{rel:.3e} (tol 2e-2)")
            lines.append(f"transformer_block_fn bf16 max|d|/max|y| "
                         f"{rel:.2e}")
        del p, xb, got, want, net
        gc.collect()
        torch.cuda.empty_cache()
        tt, d, v = CE_SHAPE
        g = torch.Generator(device=self.dev).manual_seed(2330)
        labels = torch.randint(0, v, (tt,), generator=g, device=self.dev)
        labels[torch.rand(tt, generator=g, device=self.dev) < 0.1] = -1
        h = self.randn((tt, d), 31).to(torch.bfloat16)
        w = (self.randn((d, v), 32) / d ** 0.5).to(torch.bfloat16)
        net = self.strict_net("optimize(ce_loss_fn) bf16", lambda v:
                              api.optimize(lm.ce_loss_fn, h, w, labels,
                                           config=api.OptimizeConfig(
                                               mode="brainslug", verify=v)))
        with torch.no_grad():
            self.traced_counts(zero=True)
            loss = float(net(h, w, labels))
            torch.cuda.synchronize()
            self.expect_traced("ce_loss_fn", self.traced_counts(),
                               net.n_sequences, fused_ce=1,
                               fused_rows=net.n_sequences)
            want = float(api.optimize(
                lm.ce_loss_fn, h, w, labels, config=api.OptimizeConfig(
                    mode="barrier", verify="off"))(h, w, labels))
        if not math.isfinite(loss) or abs(loss - want) > 1e-4 * abs(want):
            raise PhaseError(f"28b ce_loss_fn: loss {loss} vs barrier {want}"
                             f" (tol 1e-4 relative)")
        lines.append(f"ce_loss_fn bf16 loss {loss} (barrier {want})")
        del h, w, labels, net
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[28b optimize, verify='strict', full width] 0 error findings"
              f" on every net; every dispatch hopper; " + "; ".join(lines)
              + f"; {time.perf_counter() - t:.1f} s")
        print("[28b verifier host time] " + "; ".join(
            f"{what}: {s * 1e3:.1f} ms of {tot * 1e3:.1f} ms ({s / tot:.1%}),"
            f" {n} warning(s)"
            for what, (s, tot, n) in self.verify_seconds.items()))

    def write_model_check(self, kernel, what, models, buffers):
        """Each write model against the buffers one launch wrote, every one
        of them filled with NaN before it: every element inside the model's
        blocks written and finite, every element outside still NaN; the
        verifier finds nothing.  Then a planted model, one block dropped:
        the verifier and the buffers must both flag it.  Returns the
        counts of the kernel's entry."""
        torch = self.torch
        from repro_torch.core import verify
        findings, elements, checked = 0, 0, []
        planted = None
        # a buffer the wrapper fills itself (dx zeroed where the kernel's
        # regions leave gaps) holds that fill outside the kernel's blocks
        filled = {m["name"].split(":")[0] for m in models
                  if m["launch"].startswith("torch.")}
        for m in models:
            spec = verify.WriteSpec.from_model(kernel, m)
            findings += len(verify.errors(verify.check_write_spec(spec)))
            if m["launch"].startswith("torch."):
                continue            # the wrapper's own fill, not a launch
            buf = buffers[m["name"]].reshape(spec.array_shape)
            mask = torch.from_numpy(verify.write_mask(spec)).to(self.dev)
            inside = buf[mask]
            if not bool(torch.isfinite(inside).all()):
                raise PhaseError(f"28c {kernel} {what}: model {m['name']}: "
                                 f"{int((~torch.isfinite(inside)).sum())} "
                                 f"elements inside its blocks unwritten or "
                                 f"not finite")
            rest = buf[~mask]
            untouched = (rest == 0 if m["name"] in filled
                         else torch.isnan(rest))
            if not bool(untouched.all()):
                raise PhaseError(f"28c {kernel} {what}: model {m['name']}: "
                                 f"{int((~untouched).sum())} elements "
                                 f"outside its blocks written")
            elements += buf.numel()
            checked.append(m["name"])
            if planted is None and spec.covers and m["name"] not in filled \
                    and int(np.prod(spec.grid)) > 1:
                planted = (spec, buf)
        if findings:
            raise PhaseError(f"28c {kernel} {what}: {findings} error "
                             f"findings on its write models")
        spec, buf = planted
        live = spec.live

        def dropped(*p):
            keep = (np.ones(np.broadcast(*p).shape, bool) if live is None
                    else np.asarray(live(*p), bool))
            first = np.ones_like(keep)
            for c in p:
                first &= np.asarray(c) == 0
            return keep & ~first

        bad = dataclasses.replace(spec, live=dropped)
        flagged = [f.invariant for f in verify.check_write_spec(bad)]
        mask = torch.from_numpy(verify.write_mask(bad)).to(self.dev)
        written_outside = int((~torch.isnan(buf[~mask])).sum())
        if flagged != ["grid.coverage"] or not written_outside:
            raise PhaseError(f"28c {kernel} {what}: a model with a block "
                             f"dropped was not flagged ({flagged}, "
                             f"{written_outside} elements written outside)")
        return {"models": checked, "findings": findings,
                "elements": elements, "planted": {
                    "model": spec.name, "verifier": flagged,
                    "written_outside": written_outside}}

    def phase28_write_models(self):
        """28c: the write models of the four fused-stack kernels, built
        from the launch plans on this card (its SMs, the occupancy API's
        CTAs an SM), against what each kernel writes, and the results
        against the plain versions at phases 2-3 and 7-8's limits."""
        torch = self.torch
        from repro_torch.core import collapse, ir, resource
        from repro_torch.kernels.fused_stack import nhwc, nhwc_bwd, ref, rows
        from repro_torch.kernels.fused_stack import rows_bwd
        from repro_torch.layers import mamba2, stacks
        t = time.perf_counter()
        sm = self.sm_count
        out = {k: [] for k in ("fused_nhwc", "fused_nhwc_bwd", "fused_rows",
                               "fused_rows_bwd")}
        cases, bparams = self.nhwc_cases()
        fused_name, stage1, _ = self.nhwc_fused_cases()[0]
        block = next(c for c in cases if c[0] == "block_net8_seq0")
        # fused_nhwc: VGG stage 1 (the fused path), a generic chain
        for name, program, shape, tile in (
                (fused_name, stage1, (8,) + VGG_INPUT[1:3] + (64,), 8),
                (block[0], block[1], block[2], block[3])):
            x, params, _ = self.nhwc_operands(
                program, shape, "block" if program is block[1] else {},
                bparams, 70)
            bufs = {}
            got = nhwc.fused_nhwc(program, x, params, tile_out_h=tile,
                                  tile_out_w=tile, nan_buffers=bufs)
            torch.cuda.synchronize()
            models = nhwc.write_model(program, tuple(shape), (), tile, tile,
                                      sm, nhwc.fused_ctas_per_sm())
            entry = self.write_model_check("fused_nhwc", name, models, bufs)
            want = ref.fused_stack_ref(program, {program.inputs[0]: x},
                                       params)
            self.check("fused_nhwc", f"28c {name}",
                       {program.outputs[0]: got}, want, NHWC_TOL)
            out["fused_nhwc"].append((name, entry))
        # fused_nhwc_bwd: VGG stage 1's fused path, block_net's patch slots
        lib = nhwc_bwd._library()
        xb = self.randn(BLOCK_INPUT, 150, 2.0)
        train = collapse.collapse(block[1], {"x": BLOCK_INPUT}, resource.H100,
                                  differentiable=True)
        for name, program, x, params, tile in (
                (fused_name, stage1,
                 self.randn((8,) + VGG_INPUT[1:3] + (64,), 71, 2.0),
                 self.nhwc_operands(stage1, (1, 1, 1, 64), {}, bparams,
                                    72)[1], (8, 8)),
                ("block_net8_train_seq0", train.subprogram(0), xb, bparams,
                 (train.sequences[0].tile_out_h,
                  train.sequences[0].tile_out_w))):
            shapes = {program.inputs[0]: tuple(x.shape)}
            g = self.randn(ir.infer_shapes(program, shapes)[
                program.outputs[0]], 73)
            bufs = {}
            dx, dext, dpar = nhwc_bwd.fused_nhwc_bwd(
                program, x, {}, params, g, tile_out_h=tile[0],
                tile_out_w=tile[1], nan_buffers=bufs)
            torch.cuda.synchronize()
            b = nhwc_bwd.NhwcBwdDesc.from_buffer_copy(nhwc_bwd.bwd_template(
                program, tuple(x.shape), (), (1,) * len(program.param_names),
                *tile))
            models = nhwc_bwd.write_model(program, tuple(x.shape), (), *tile,
                                          sm, nhwc_bwd._ctas_per_sm(lib, b))
            entry = self.write_model_check("fused_nhwc_bwd", name, models,
                                           bufs)
            rdx, rext, rpar = nhwc_bwd.fused_nhwc_bwd_ref(program, x, {},
                                                          params, g)
            self.check_bwd("fused_nhwc_bwd", f"28c {name}",
                           {"dx": dx, **{f"d{k}": v for k, v in dpar.items()}},
                           {"dx": rdx, **{f"d{k}": v
                                          for k, v in rpar.items()}},
                           reduced={f"d{k}" for k in rpar})
            out["fused_nhwc_bwd"].append((name, entry))
        # fused_rows: deepseek's addnorm at 2048 rows, mamba2's gated norm
        di = 5120
        addnorm = stacks.addnorm_program("rms", 1e-6, False)
        gated = mamba2._gated_norm_program(1e-6)
        bf = torch.bfloat16
        for name, program, inputs, params, tol in (
                ("addnorm_rms_2048", addnorm,
                 {"x": self.randn((2048, D_MODEL), 80),
                  "res": self.randn((2048, D_MODEL), 81)},
                 {"scale": 1.0 + 0.1 * self.randn((D_MODEL,), 82)},
                 ROWS_NORM_TOL),
                ("mamba2_gated_norm_bf16", gated,
                 {"y": self.randn((2048, di), 83).to(bf),
                  "z": self.randn((2048, di), 84).to(bf)},
                 {"scale": (1.0 + 0.1 * self.randn((di,), 85)).to(bf)},
                 None)):
            bufs = {}
            got = rows.fused_rows(program, inputs, params, nan_buffers=bufs)
            torch.cuda.synchronize()
            in_w = {v: t_.shape[-1] for v, t_ in inputs.items()}
            feats = max([*in_w.values(), *(p.numel() for p in params.values())])
            widths = rows.value_widths(program, in_w, {
                p: params[p].numel() for p in program.param_names})
            row_bytes = sum(t_.element_size() for t_ in inputs.values())
            models = rows.write_model(program, widths, 2048,
                                      rows.forward_plan(2048, feats, sm,
                                                        row_bytes))
            entry = self.write_model_check("fused_rows", name, models, bufs)
            want = ref.fused_stack_ref(program, inputs, params)
            for v in program.outputs:
                if tol is None:
                    self.lm_check("fused_rows_bf16", f"28c {name}", got[v],
                                  want[v])
                else:
                    self.check("fused_rows", f"28c {name}", {v: got[v]},
                               {v: want[v]}, tol)
            out["fused_rows"].append((name, entry))
        # fused_rows_bwd: a layer norm with bias (two parameter partials)
        layer = stacks.addnorm_program("layer", 1e-5, True)
        inputs = {"x": self.randn((2048, D_MODEL), 86),
                  "res": self.randn((2048, D_MODEL), 87)}
        params = {"scale": 1.0 + 0.1 * self.randn((D_MODEL,), 88),
                  "bias": 0.1 * self.randn((D_MODEL,), 89)}
        cot = self.rows_cotangents(layer, inputs, params, 90)
        bufs = {}
        dins, dpar = rows_bwd.fused_rows_bwd(layer, inputs, params, cot,
                                             nan_buffers=bufs)
        torch.cuda.synchronize()
        in_w = {v: D_MODEL for v in inputs}
        pw = {p: D_MODEL for p in params}
        f_block = resource.feature_block(layer, D_MODEL,
                                         resource.H100.f_chunk)
        row_bytes = sum(4 for _ in [*inputs, *cot])
        models = rows_bwd.write_model(layer, in_w, pw, 2048,
                                      rows_bwd.launch_plan(
                                          2048, D_MODEL, f_block, sm,
                                          row_bytes))
        entry = self.write_model_check("fused_rows_bwd", "addnorm_layer_bias",
                                       models, bufs)
        rin, rpar = rows_bwd.fused_rows_bwd_ref(layer, inputs, params, cot)
        self.check_bwd("fused_rows_bwd", "28c addnorm_layer_bias",
                       {f"d{k}": v for k, v in {**dins, **dpar}.items()},
                       {f"d{k}": v for k, v in {**rin, **rpar}.items()},
                       reduced={f"d{p}" for p in params})
        out["fused_rows_bwd"].append(("addnorm_layer_bias", entry))
        for kernel, runs in out.items():
            self.kernels.setdefault(kernel, {})["write_model"] = {
                name: entry for name, entry in runs}
            print(f"[28c {kernel}] " + "; ".join(
                f"{name}: models {e['models']} held on {e['elements']} "
                f"elements (every element inside written and finite, every "
                f"other still NaN), {e['findings']} findings; planted "
                f"{e['planted']['model']} with a block dropped: "
                f"{e['planted']['verifier']}, "
                f"{e['planted']['written_outside']} elements written outside"
                for name, e in runs))
        print(f"[28c] write models on {sm} SMs against the kernels: "
              f"{time.perf_counter() - t:.1f} s")


    # -- phase 29: mesh execution (Slice G1) ---------------------------------
    def phase29_mesh(self):
        """Two ranks on this card over gloo: (a) VGG-16 under ``data``, (b)
        the deepseek-width bf16 block under ``tensor``, (c) the
        data-parallel trainer, and in the same spawn phase 30's legs (read
        by :meth:`phase30_sharded`); every rank's counters folded into the
        kernels line.  The single-device steps of 29c and 30b run here
        first."""
        torch = self.torch
        import gc

        from repro_torch.examples import mesh_checks
        from repro_torch.launch import mesh as mesh_mod
        t0 = time.perf_counter()
        # the two ranks need the card's memory (26.4 GiB each at 29c's
        # peak on one H100), and no phase after this one reads phase
        # 12's 30-layer model (its bf16 weights)
        self.lm_model = None
        gc.collect()
        ref = self.mesh_dp_reference()
        gc.collect()
        self.tp_ref = mesh_checks.one_device_steps(**self.tp_kw())
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 2 ** 30
        common = dict(arch="deepseek-7b", reduced=False, mode="brainslug",
                      batch_override=MESH["dp_batch"],
                      seq_override=MESH["seq"], steps=MESH["steps"],
                      config_overrides=(("n_layers", MESH["dp_layers"]),
                                        ("dtype", "bfloat16")),
                      device="cuda", log_every=10 ** 9,
                      mesh_devices=MESH["ranks"])
        checks = [
            ("vgg", "vgg_step", dict(device="cuda", stages=VGG16_STAGES,
                                     input_shape=VGG_INPUT,
                                     rtol=TRAIN_RTOL)),
            ("block", "block_forward", dict(
                device="cuda", widths=(PREFILL[1], D_MODEL, 32, D_FF),
                dtype="bfloat16", model_parallel=2)),
            ("dp", "dp_train", dict(
                runs=[dict(compress=False), dict(compress=True)],
                common=common, lr=MESH["lr"])),
            ("gspmd", "gspmd_train", dict(runs=[{}], common=common,
                                          lr=MESH["lr"])),
            ("tp", "sharded_steps", dict(model_parallel=SHARDED["model"],
                                         **self.tp_kw())),
            ("pipe", "pipeline_block", dict(
                device="cuda", seq=SHARDED["pipe_seq"],
                n_microbatches=SHARDED["pipe_microbatches"])),
            *self.serve_mesh_checks(),
        ]
        t = time.perf_counter()
        try:
            got = mesh_mod.spawn(mesh_checks.run_checks, MESH["ranks"],
                                 checks, device="cuda", timeout=600)
        except (mesh_mod.RankError, TimeoutError) as e:
            raise PhaseError(f"29: {e}") from e
        spawn_s = time.perf_counter() - t
        self.mesh_vgg(got["vgg"])
        self.mesh_block(got["block"])
        self.mesh_dp(got["dp"], ref)
        self.mesh_got, self.mesh_ref = got, ref
        launches = {"29a vgg_step": got["vgg"]["ranks"],
                    "29b block_forward": got["block"]["ranks"],
                    "29c dp_train": [
                        {k: sum(r["ranks"][i]["launches"][k]
                                for r in got["dp"]["runs"])
                         for k in KERNELS}
                        for i in range(MESH["ranks"])],
                    "30a gspmd_train": got["gspmd"]["runs"][0]["ranks"],
                    "30b sharded_steps": got["tp"]["ranks"],
                    "30c pipeline_block": got["pipe"]["ranks"],
                    **{f"31{leg} serve_engine {label}": got[key]["ranks"]
                       for leg, key, label in SERVE_LEGS}}
        for name in KERNELS:
            per = {w: [(c["launches"] if "launches" in c else c)[name]
                       for c in ranks] for w, ranks in launches.items()}
            if any(any(v) for v in per.values()):
                self.kernels.setdefault(name, {})["mesh"] = {
                    "launches_per_rank": per}
        total = time.perf_counter() - t0
        print(f"[29] ranks share {torch.cuda.get_device_name(0)} "
              f"({self.smi}): no time here is a multi-card number; "
              f"{held:.2f} GiB held by this process at the spawn; spawn "
              f"and legs {spawn_s:.1f} s (legs in the ranks "
              f"{got['seconds']}); phase {total:.1f} s (aim "
              f"<= {MESH['seconds']} s with phase 30's legs)")

    def serve_mesh_checks(self):
        """Phase 31's legs for phase 29's spawn: ``mesh_checks.
        serve_engine`` at (data 2, model 1) dense, (1, 2) dense and (1, 2)
        paged."""
        from repro_torch.configs import get_config
        from repro_torch.examples import mesh_checks
        sm = SERVE_MESH
        queue = mesh_checks.serve_queue(
            get_config(sm["arch"]).vocab_size, n=sm["requests"],
            prefix_len=sm["prefix"], max_tail=sm["tail"], max_new=sm["new"],
            seed=sm["seed"])
        common = dict(device="cuda", requests=queue, arch=sm["arch"],
                      reduced=False, overrides=(("n_layers", sm["layers"]),
                                                ("dtype", "float32")),
                      seed=sm["seed"], mode="brainslug", slots=sm["slots"],
                      max_len=sm["max_len"], prefill_chunk=sm["chunk"],
                      kv_block_size=sm["block"])
        return [(key, "serve_engine",
                 dict(common, model_parallel=m, kv_layout=layout))
                for key, m, layout in (("serve_data", 1, "dense"),
                                       ("serve_tensor", 2, "dense"),
                                       ("serve_paged", 2, "paged"))]

    def tp_kw(self):
        """30b's model, weights and batches (seed 0, synth_batch seed 7)
        for ``mesh_checks.sharded_steps`` and its one-device twin."""
        return dict(arch="deepseek-7b", device="cuda", reduced=False,
                    overrides=(("n_layers", SHARDED["layers"]),
                               ("dtype", "bfloat16")),
                    steps=SHARDED["steps"], lr=SHARDED["lr"],
                    seq=SHARDED["seq"], batch=1, mode="brainslug")

    # -- phase 30: the sharded step and the pipeline (Slice G2) --------------
    def phase30_sharded(self):
        """30a-c, run in phase 29's spawn: the sharded Trainer at (data 2,
        model 1) against 29c's one-device halves, the sharded step at
        (data 1, model 2) against one device, the pipeline bit for bit."""
        t = time.perf_counter()
        got = self.mesh_got
        self.sharded_trainer(got["gspmd"]["runs"][0], self.mesh_ref,
                             got["dp"]["runs"][0])
        self.sharded_tensor(got["tp"], self.tp_ref)
        self.sharded_pipeline(got["pipe"])
        print(f"[30] legs in phase 29's spawn (ranks sharing "
              f"{self.torch.cuda.get_device_name(0)}, {self.smi}: no time "
              f"here is a multi-card number): 30a "
              f"{got['seconds']['gspmd']} s, 30b {got['seconds']['tp']} s, "
              f"30c {got['seconds']['pipe']} s; checks "
              f"{time.perf_counter() - t:.1f} s")

    # -- phase 31: mesh serving (Slice G3) -----------------------------------
    def phase31_serving(self):
        """31a-c, run in phase 29's spawn: ``Server.engine(mesh=...)`` at
        (data 2, model 1) and (1, 2) dense and (1, 2) paged against the
        single-device engine in each rank; then each decode kernel at the
        ranks' shapes against its plain version, and the paged plan on a
        (2, 2) skeleton."""
        t = time.perf_counter()
        got = self.mesh_got
        for leg, key, label in SERVE_LEGS:
            self.serve_leg(leg, label, got[key])
        self.serve_kernels()
        print(f"[31] legs in phase 29's spawn (ranks sharing "
              f"{self.torch.cuda.get_device_name(0)}, {self.smi}: no time "
              f"here is a multi-card number): "
              + ", ".join(f"31{leg} {got['seconds'][key]} s"
                          for leg, key, _ in SERVE_LEGS)
              + f"; checks {time.perf_counter() - t:.1f} s")

    def serve_leg(self, leg, label, run):
        """One leg's checks and lines: the plan's splits, tokens and
        per-tick logits against the single-device engine, each rank's
        cache share, launches and collectives."""
        from repro_torch import configs
        sm = SERVE_MESH
        cfg = configs.get_config(sm["arch"])
        d = 2 if leg == "a" else 1
        m = 1 if leg == "a" else 2
        paged = leg == "c"
        plan = run["report"]["serve_partition"]
        problems = []
        if (plan.get("data"), plan.get("model")) != (d > 1, m > 1):
            problems.append(f"plan {plan}")
        if run["statuses"] != ["ok"] * sm["requests"]:
            problems.append(f"statuses {run['statuses']}")
        # the dense cache: k and v over data x model, lengths over data
        L, hd, B, S = sm["layers"], cfg.head_dim, sm["slots"], sm["max_len"]
        kv = 2 * L * B * cfg.n_kv_heads * S * hd * 4
        lines = []
        dec = "paged_flash_decode" if paged else "flash_decode"
        for r, c in enumerate(run["ranks"]):
            e = c["evaluations"]
            want = {dec: L * e, "rmsnorm": (2 * L + 1) * e, "swiglu": L * e}
            got_la = {k: c["launches"][k] for k in want}
            attn = c["attn_dispatch"]
            fallbacks = {k: v for k, v in attn.items()
                         if k.endswith(("plain", "_ref")) and v}
            g = c["gaps"]
            flips_ok = all(gap < sm["tp_rel"] for *_, gap in g["flips"])
            if got_la != want or c["plain"] or fallbacks:
                problems.append(f"rank {r} launches {got_la} (want {want}),"
                                f" plain {c['plain']}, {fallbacks}")
            if not (g["rel"] <= sm["tp_rel"] and (
                    c["tokens_equal"] and not g["flips"] or flips_ok)):
                problems.append(f"rank {r} logits {g}")
            if not paged and c["cache_bytes"] != (kv // (d * m)
                                                  + L * B * 4 // d):
                problems.append(f"rank {r} cache {c['cache_bytes']} B")
            if c["local_heads"] != (cfg.n_heads // m, cfg.n_kv_heads // m):
                problems.append(f"rank {r} heads {c['local_heads']}")
            coll = c["collectives"]
            lines.append(
                f"rank {r}: {c['local_slots']} slots, {c['local_heads'][0]}"
                f" heads over {c['local_heads'][1]}; cache "
                f"{c['cache_bytes']} B (one device {c['ref_cache_bytes']}"
                f" B); {e} model evaluations (one device "
                f"{c['ref_evaluations']}), launches {got_la}, plain "
                f"{c['plain']}, decode_plain {attn.get(('paged_' if paged else '') + 'decode_plain', 0)}"
                f" decode_ref {attn.get(('paged_' if paged else '') + 'decode_ref', 0)}; "
                f"collectives {coll['calls']} bytes {coll['bytes']}; "
                f"logits {'bit for bit' if g['bitwise'] else 'max|d|/max|ref| ' + format(g['rel'], '.3e')}"
                f" over {g['compared']} of {g['ticks']} ticks, flips "
                f"{g['flips']}; {c['tick_ms']:.1f} ms a tick (one device "
                f"{c['ref_tick_ms']:.1f} ms)")
        if problems:
            raise PhaseError(f"31{leg} {label}: " + "; ".join(problems))
        kv_note = ("" if paged else
                   f"; dense cache a rank = k, v / (data x model) + lengths"
                   f" / data = {kv // (d * m) + L * B * 4 // d} B of "
                   f"{kv + L * B * 4} B")
        print(f"[31{leg} Server.engine(mesh=...) {label}] {sm['arch']} full "
              f"width, {sm['layers']} layers float32, {sm['requests']} "
              f"requests, {sm['slots']} slots, max_len {sm['max_len']}, "
              f"chunk {sm['chunk']}{', paged block ' + str(sm['block']) + ', prefix sharing on' if paged else ''}"
              f": {run['mesh']}; serve_partition {plan}; tokens "
              f"{'identical to' if run['tokens'] == run['ref_tokens'] else 'differ from'}"
              f" the single-device engine's{kv_note}; " + "; ".join(lines)
              + " (ranks sharing one card)")

    def serve_kernels(self):
        """Each decode kernel once at the ranks' shapes of phase 31 against
        its plain version (float32 caches, as the engine's): dense at 31a's
        (4 slots, 40 heads over 8) and 31b's (8, 20 over 4), paged at
        31c's (20 over 4, blocks of 16); with the launch plans; and the
        paged cache's plan on a (data 2, model 2) skeleton: data fenced
        with a pool note, model kept."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.core import partition
        from repro_torch.kernels.attention import decode
        from repro_torch.models import lm
        sm = SERVE_MESH
        f32, s_max = torch.float32, sm["max_len"]
        lines = []
        for b, h, g in ((4, 40, 8), (8, 20, 4)):
            lens = torch.tensor([0, 1, 17, 64, 129, 200, 255, 256][:b],
                                dtype=torch.int32, device=self.dev)
            q = self.randn((b, h, 1, 128), 3101)
            k = self.randn((b, g, s_max, 128), 3102)
            v = self.randn((b, g, s_max, 128), 3103)
            got = decode.flash_decode(q, k, v, lens, max_keys=s_max)
            err = self.lm_check("flash_decode", f"31 ({b}, {h} over {g})",
                                got, decode.flash_decode_plain(q, k, v, lens))
            lines.append(f"flash_decode ({b}, {h} over {g}, {s_max}, 128) "
                         f"max|d| {err:.2e}, plan "
                         f"{decode.dense_plan(q, k, max_keys=s_max)}")
        q, kp, vp, table, lens = self.paged_operands(
            f32, f32, 20, 4, 3110, lengths=[0, 1, 17, 64, 129, 200, 255, 256],
            bs=sm["block"], max_len=s_max)
        got = decode.paged_flash_decode(q, kp, vp, table, lens)
        err = self.lm_check("paged_flash_decode", "31 (8, 20 over 4)", got,
                            decode.paged_flash_decode_plain(q, kp, vp, table,
                                                            lens))
        lines.append(f"paged_flash_decode (8, 20 over 4, pool "
                     f"{tuple(kp.shape)}) max|d| {err:.2e}, plan "
                     f"{decode.paged_plan(q, kp, table)}")
        # 31a's rows against one device's: the decode kernel's slots are
        # independent of the batch; a float32 product over a rank's 4
        # rows against the first 4 rows of one over all 8, at the
        # model's weight shapes, is where cuBLAS may pick another kernel
        cfg = get_config(sm["arch"])
        rows = {}
        for b, h, g in ((8, 40, 8),):
            q = self.randn((b, h, 1, 128), 3121)
            k = self.randn((b, g, s_max, 128), 3122)
            v = self.randn((b, g, s_max, 128), 3123)
            lens = torch.tensor([1, 17, 64, 129, 200, 255, 256, 3],
                                dtype=torch.int32, device=self.dev)
            half = decode.flash_decode(q[:4], k[:4], v[:4], lens[:4],
                                       max_keys=s_max)
            whole = decode.flash_decode(q, k, v, lens, max_keys=s_max)
            rows["flash_decode"] = bool(torch.equal(half, whole[:4]))
        d, hd = cfg.d_model, cfg.head_dim
        for name, (k_, n_) in {
                "wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
                "wo": (cfg.n_heads * hd, d), "wg": (d, cfg.d_ff),
                "wd": (cfg.d_ff, d), "head": (d, cfg.vocab_size)}.items():
            x = self.randn((sm["slots"], k_), 3130)
            w = self.randn((k_, n_), 3131, scale=k_ ** -0.5)
            rows[name] = bool(torch.equal(x[:4] @ w, (x @ w)[:4]))
            del x, w
        if not rows["flash_decode"]:
            raise PhaseError(f"31 flash_decode over 4 slots differs from "
                             f"the first 4 of 8: {rows}")
        lines.append(f"rows 0-3 of 8 equal bit for bit to the same rows "
                     f"computed alone: {rows}")
        shapes = lm.init_decode_cache(
            dataclasses.replace(cfg, n_layers=sm["layers"]), sm["slots"],
            s_max, dtype=f32, kv_layout="paged",
            kv_num_blocks=sm["slots"] * s_max // sm["block"],
            kv_block_size=sm["block"], device="meta")
        plan = partition.plan_decode_cache(
            shapes, "auto", partition.MeshAxes(("data", "model"), (2, 2)),
            slots=sm["slots"], head_extents=(cfg.n_heads, cfg.n_kv_heads))
        if plan.use_data or not plan.use_model or not any(
                "pool" in n for n in plan.notes):
            raise PhaseError(f"31 paged plan at (2, 2): {plan}")
        print(f"[31 decode kernels at the ranks' shapes, float32] "
              + "; ".join(lines) + f"; the paged cache planned at (data 2, "
              f"model 2): data {plan.use_data}, model {plan.use_model}, "
              f"notes {list(plan.notes)}")

    @staticmethod
    def sharded_param_numel(cfg, layers, data):
        """A dense config's parameter elements a rank holds under the
        default rules at (data, model 1): the embedding ("vocab", None) and
        head (None, "vocab") not split over data, every block projection
        ("fsdp" rows or columns) split, the norms replicated."""
        d, hd = cfg.d_model, cfg.head_dim
        attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
        blocks = layers * (attn + 3 * d * cfg.d_ff)
        return 2 * cfg.vocab_size * d + d + layers * 2 * d + blocks // data

    def sharded_trainer(self, run, ref, dp_run):
        steps = MESH["steps"]
        h = run["history"]
        losses = [x["loss"] for x in h]
        gnorms = [x["grad_norm"] for x in h]
        want_l = [x["loss"] for x in ref["halves"]]
        want_g = [x["grad_norm"] for x in ref["halves"]]
        rel = lambda a, b: abs(a - b) / abs(b)
        gaps = [max(rel(a, b), rel(c, d)) for a, b, c, d in
                zip(losses, want_l, gnorms, want_g)]
        bitwise = losses == want_l and gnorms == want_g
        want_la = {"fused_ce": steps, "rmsnorm": 5 * steps,
                   "swiglu": 2 * steps, "flash_attention": 2 * steps}
        bad = [(r, c["launches"], c["plain"]) for r, c in
               enumerate(run["ranks"])
               if {k: c["launches"][k] for k in want_la} != want_la
               or c["plain"]]
        from repro_torch import configs
        cfg = configs.get_config("deepseek-7b")
        numel = self.sharded_param_numel(cfg, MESH["dp_layers"],
                                         MESH["ranks"])
        expect = 2 * numel                  # bf16
        shard = [c["param_bytes"] for c in run["shard"]]
        opt = [c["opt_bytes"] for c in run["shard"]]
        whole = dp_run["wire_bytes"]
        if not (len(h) == steps and all(g <= MESH_HALVES_REL for g in gaps)
                and not bad
                and [c["param_numel"] for c in run["shard"]]
                == [numel] * MESH["ranks"]
                and opt == [8 * numel] * MESH["ranks"]
                and "data=2 x model=1" in run["mesh"]):
            raise PhaseError(
                f"30a Trainer(mesh_devices=2): losses {losses} grad norms "
                f"{gnorms}; 29c's halves {want_l} {want_g}; gaps {gaps} "
                f"(tol {MESH_HALVES_REL}); launches {bad}; shard bytes "
                f"{shard} (expected {expect}), moments {opt}; {run['mesh']}")
        peak = [round(c["peak_gib"], 2) for c in run["ranks"]]
        dp_peak = [round(c["peak_gib"], 2) for c in dp_run["ranks"]]
        print(f"[30a Trainer(mesh_devices=2) without data_parallel] "
              f"deepseek-7b full width, {MESH['dp_layers']} layers bf16, "
              f"global batch {MESH['dp_batch']} x {MESH['seq']}, {steps} "
              f"AdamW steps lr {MESH['lr']}: {run['mesh']}; losses {losses} "
              f"grad norms {gnorms}; against 29c's one-device halves "
              f"{'bit for bit' if bitwise else 'within'} (gaps "
              f"{[f'{g:.3e}' for g in gaps]}, tol {MESH_HALVES_REL}); bf16 "
              f"parameter shard {shard} B a rank (the rules give {expect}; "
              f"29c holds {whole}, {shard[0] / whole:.3f} of it), AdamW "
              f"moments {opt} B a rank; peak {peak} GiB a rank (29c "
              f"uncompressed {dp_peak}); launches per rank over {steps} "
              f"steps {[c['launches'] for c in run['ranks']]}, plain "
              f"dispatches {[c['plain'] for c in run['ranks']]}; "
              f"collectives per rank {[c['collectives']['calls'] for c in run['ranks']]}; "
              f"wall {run['wall_s']:.1f} s (ranks sharing one card)")

    def sharded_tensor(self, run, ref):
        steps, m = SHARDED["steps"], SHARDED["model"]
        losses, gnorms = run["losses"], run["grad_norms"]
        rel = lambda a, b: abs(a - b) / abs(b)
        loss_gaps = [rel(a, b) for a, b in zip(losses, ref["losses"])]
        gn_gaps = [rel(a, b) for a, b in zip(gnorms, ref["grad_norms"])]
        from repro_torch import configs
        cfg = configs.get_config("deepseek-7b")
        heads, cols = cfg.n_heads // m, cfg.d_ff // m
        want_shapes = {"flash_attention": [(1, heads, SHARDED["seq"],
                                            cfg.head_dim)],
                       "swiglu": [(1, SHARDED["seq"], cols)]}
        want_la = {"fused_ce": steps, "rmsnorm": 5 * steps,
                   "swiglu": 2 * steps, "flash_attention": 2 * steps}
        bad = [(r, c["launches"], c["plain"], c["shapes"]) for r, c in
               enumerate(run["ranks"])
               if {k: c["launches"][k] for k in want_la} != want_la
               or c["plain"] or {k: [tuple(x) for x in v] for k, v in
                                 c["shapes"].items()} != want_shapes]
        ar = [[b.get("all_reduce", 0) for b in c["bytes_per_step"]]
              for c in run["ranks"]]
        lims = list(zip(loss_gaps, TRAIN_BF16_LOSS_REL)) + [
            (g, TRAIN_BF16_GNORM_REL) for g in gn_gaps]
        if not (len(losses) == steps and run["shape"] == {"data": 1,
                                                          "model": m}
                and all(math.isfinite(x) for x in losses + gnorms)
                and all(g <= lim for g, lim in lims) and not bad):
            raise PhaseError(
                f"30b sharded step (1, {m}): losses {losses} grad norms "
                f"{gnorms}; one device {ref}; loss gaps {loss_gaps} (tol "
                f"{TRAIN_BF16_LOSS_REL}), grad norm gaps {gn_gaps} (tol "
                f"{TRAIN_BF16_GNORM_REL}); ranks {bad}")
        print(f"[30b make_sharded_train_step (data 1, model {m})] "
              f"deepseek-7b full width, {SHARDED['layers']} layers bf16, 1 x "
              f"{SHARDED['seq']} tokens, {steps} AdamW steps lr "
              f"{SHARDED['lr']}: {run['mesh']}; losses {losses} grad norms "
              f"{gnorms}; one device from the same weights and batches "
              f"{ref['losses']} {ref['grad_norms']}; loss gaps "
              f"{[f'{g:.3e}' for g in loss_gaps]} (tol "
              f"{TRAIN_BF16_LOSS_REL}), grad norm gaps "
              f"{[f'{g:.3e}' for g in gn_gaps]} (tol {TRAIN_BF16_GNORM_REL}"
              f"); {run['kept']} leaves kept split over model; launch "
              f"shapes per rank {run['ranks'][0]['shapes']} (flash on "
              f"{heads} of {cfg.n_heads} heads, swiglu on {cols} of "
              f"{cfg.d_ff} columns); "
              f"launches per rank {[c['launches'] for c in run['ranks']]}, "
              f"plain {[c['plain'] for c in run['ranks']]}; all-reduce "
              f"bytes a step per rank {ar}; all bytes a step "
              f"{run['ranks'][0]['bytes_per_step']}; bf16 parameter shard "
              f"{[c['param_bytes'] for c in run['ranks']]} B, moments "
              f"{[c['opt_bytes'] for c in run['ranks']]} B a rank; peak "
              f"{[round(c['peak_gib'], 2) for c in run['ranks']]} GiB; wall "
              f"{run['wall_s']:.1f} s (ranks sharing one card)")

    def sharded_pipeline(self, got):
        n_mb = SHARDED["pipe_microbatches"]
        want_la = {"rmsnorm": 2 * n_mb, "flash_attention": n_mb,
                   "swiglu": n_mb}
        bad = [(r, c["launches"], c["plain"]) for r, c in
               enumerate(got["ranks"])
               if {k: c["launches"][k] for k in want_la} != want_la
               or c["plain"]]
        if not (got["bitwise"] and got["finite"] and got["bubble"] == 0.2
                and len({c["y_sum"] for c in got["ranks"]}) == 1
                and not bad):
            raise PhaseError(f"30c pipeline: bit for bit {got['bitwise']} "
                             f"(max|d| {got['max_abs_err']}), bubble "
                             f"{got['bubble']}, ranks {got['ranks']}")
        print(f"[30c pipeline_apply] one deepseek-7b block a stage (d_model "
              f"{D_MODEL}, 32 heads, d_ff {D_FF}, bf16) over {got['mesh']}, "
              f"{n_mb} microbatches of (1, {SHARDED['pipe_seq']}): bit for "
              f"bit against the two blocks applied in turn on one rank; "
              f"bubble_fraction(2, {n_mb}) = {got['bubble']}; every stage "
              f"holds the whole output; launches per rank "
              f"{[c['launches'] for c in got['ranks']]}, plain "
              f"{[c['plain'] for c in got['ranks']]}; hops per rank "
              f"{[c['collectives']['calls'] for c in got['ranks']]}; wall "
              f"{got['wall_s']:.2f} s (ranks sharing one card)")

    def mesh_dp_reference(self):
        """29c's single-device runs of MESH["steps"] steps from the same
        seeded weights and batches, through ``build_trainer``: "whole",
        the whole global batch a step; "halves", each rank's slice of it
        in turn, the bf16 gradients summed and halved as the ranks'
        all-reduce does (written here from ``lm.loss_fn`` and
        ``adamw.update``, not from the data-parallel step)."""
        torch = self.torch
        import gc
        from repro_torch.configs.base import RuntimeConfig
        from repro_torch.launch import train as train_mod
        from repro_torch.layers import base
        from repro_torch.models import lm
        from repro_torch.optim import adamw
        tc = train_mod.TrainerConfig(
            arch="deepseek-7b", reduced=False, mode="brainslug",
            steps=MESH["steps"],
            batch_override=MESH["dp_batch"], seq_override=MESH["seq"],
            config_overrides=(("n_layers", MESH["dp_layers"]),
                              ("dtype", "bfloat16")),
            device="cuda", log_every=10 ** 9)
        opt_cfg = adamw.AdamWConfig(lr=MESH["lr"])
        out = {"whole": train_mod.train(tc, opt_cfg=opt_cfg)}
        gc.collect()
        trainer = train_mod.build_trainer(tc, opt_cfg=opt_cfg)
        rt = RuntimeConfig(mode=tc.mode, remat=tc.remat)
        n = MESH["ranks"]

        def halves_step(params, opt_state, batch):
            total, losses = None, []
            for r in range(n):
                size = next(iter(batch.values())).shape[0] // n
                part = {k: v[r * size:(r + 1) * size]
                        for k, v in batch.items()}
                with torch.enable_grad():
                    live = base.tree_map(
                        lambda q: q.detach().requires_grad_(), params)
                    loss, _ = lm.loss_fn(live, part, trainer.cfg, rt)
                    flat = base.tree_leaves(live)
                    grads = torch.autograd.grad(loss, flat,
                                                allow_unused=True)
                grads = [torch.zeros_like(q) if g is None else g
                         for q, g in zip(flat, grads)]
                total = grads if total is None else [
                    a + b for a, b in zip(total, grads)]
                losses.append(loss.detach().float())
                del live, flat, grads
            it = iter([g.div_(n) for g in total])
            mean = base.tree_map(lambda _: next(it), params)
            del total, it
            params, opt_state, m = adamw.update(opt_cfg, mean, opt_state,
                                                params)
            zero = torch.zeros((), device=trainer.device)
            return params, opt_state, {
                "loss": torch.stack(losses).sum() / n,
                "grad_norm": m["grad_norm"], "router_aux_loss": zero,
                "drop_fraction": zero}

        trainer.step_fn = halves_step
        out["halves"] = trainer.run()
        return out

    def mesh_vgg(self, got):
        n_seq = got["n_sequences"]
        bad = [(r, c) for r, c in enumerate(got["ranks"])
               if (c["fwd_generated"], c["bwd_generated"], c["fwd_reference"],
                   c["bwd_reference"]) != (n_seq, n_seq, 0, 0)
               or c["launches"]["fused_nhwc_bwd"] != n_seq]
        if not (got["forward_ok"] and got["grads_ok"]) or bad \
                or not all(a for _, _, a in got["dist"]):
            raise PhaseError(f"29a VGG-16 under data: forward "
                             f"{got['forward_rel']:.3e}, gradients "
                             f"{got['grad_rel']}, sharded {got['dist']}, "
                             f"counters {bad}")
        worst = max(got["grad_rel"].values())
        print(f"[29a VGG-16 {VGG_INPUT} float32, optimize_graph "
              f"differentiable=True, partition='data' over 2 ranks] "
              f"{got['mesh']}; loss {got['loss']} (one device "
              f"{got['loss_one']}); forward max|d|/max|y| "
              f"{got['forward_rel']:.3e}, step-1 gradients max|d|/max|g| "
              f"{worst:.3e} (tol rtol {TRAIN_RTOL}, atol {TRAIN_RTOL} x "
              f"max|g|); per rank fwd_generated = bwd_generated = "
              f"{n_seq} sequences, 0 reference; step wall "
              f"{got['wall_s']:.2f} s (ranks sharing one card); peak "
              f"{[round(c['peak_gib'], 2) for c in got['ranks']]} GiB; "
              f"collectives given CUDA tensors per rank "
              f"{[c['collectives']['cuda_calls'] for c in got['ranks']]}")

    def mesh_block(self, got):
        want = {"attention": 1, "rmsnorm": 2, "swiglu": 1}
        if (got["kernel_hits"] != want or got["kernel_fallbacks"]
                or not got["registry_all_kernels"] or not got["finite"]
                or got["rel"] > 2e-2
                or not any(a for k, _, a in got["dist"] if k == "kernel")):
            raise PhaseError(f"29b block under tensor: {got}")
        print(f"[29b api.optimize(transformer_block_fn) deepseek-7b widths "
              f"(1, {PREFILL[1]}, {D_MODEL}), 32 heads, d_ff {D_FF}, bf16, "
              f"partition='tensor' over (1, 2)] {got['mesh']}; against the "
              f"single-device compile max|d|/max|y| {got['rel']:.3e} (tol "
              f"2e-2); registry {got['kernel_hits']}, all hopper; sharded "
              f"segments {[(k, n) for k, n, a in got['dist'] if a]}; per "
              f"rank registry {[c['registry'] for c in got['ranks']]}; "
              f"forward wall {got['wall_s']:.3f} s (ranks sharing one card)")

    def mesh_dp(self, got, ref):
        plain, comp = got["runs"]
        want_l = [x["loss"] for x in ref["whole"]]
        want_g = [x["grad_norm"] for x in ref["whole"]]
        halves_l = [x["loss"] for x in ref["halves"]]
        halves_g = [x["grad_norm"] for x in ref["halves"]]
        rel = lambda a, b: abs(a - b) / abs(b)
        lines = []
        for tag, run in (("uncompressed", plain), ("compressed", comp)):
            h = run["history"]
            losses = [x["loss"] for x in h]
            gnorms = [x["grad_norm"] for x in h]
            for r, c in enumerate(run["ranks"]):
                la = c["launches"]
                if la["fused_ce"] != MESH["steps"] or la["flash_attention"] \
                        != MESH["steps"] * MESH["dp_layers"]:
                    raise PhaseError(f"29c {tag} rank {r}: launches {la}")
            loss_gaps = [rel(a, b) for a, b in zip(losses, want_l)]
            gn_gaps = [rel(a, b) for a, b in zip(gnorms, want_g)]
            if tag == "uncompressed":
                # every step against one device's run of the same two
                # halves; the whole batch's losses every step and grad
                # norm at step 1 at phase 18's limits
                half_gaps = [max(rel(a, b), rel(c, d)) for a, b, c, d in
                             zip(losses, halves_l, gnorms, halves_g)]
                lims = [(g, lim) for g, lim in zip(loss_gaps,
                                                   TRAIN_BF16_LOSS_REL)] \
                    + [(gn_gaps[0], TRAIN_BF16_GNORM_REL)] + [
                    (g, MESH_HALVES_REL) for g in half_gaps]
                held = (f"every step against one device's two halves: "
                        f"loss and grad norm gaps "
                        f"{[f'{g:.3e}' for g in half_gaps]} (tol "
                        f"{MESH_HALVES_REL}); against one device's whole "
                        f"batch: loss gaps {[f'{g:.3e}' for g in loss_gaps]}"
                        f" (tol {TRAIN_BF16_LOSS_REL}), grad norm gaps "
                        f"{[f'{g:.3e}' for g in gn_gaps]} (tol "
                        f"{TRAIN_BF16_GNORM_REL} at step 1)")
            else:
                # step 1 against one device (the error state starts at
                # zero); later steps track the uncompressed run, changed
                up = [x["loss"] for x in plain["history"]]
                track = [rel(a, b) for a, b in zip(losses[1:], up[1:])]
                lims = [(loss_gaps[0], TRAIN_BF16_LOSS_REL[0]),
                        (gn_gaps[0], MESH_COMPRESSED_GNORM_REL)] + [
                    (g, MESH_COMPRESSED_LOSS_REL) for g in track]
                if losses[1] == up[1]:
                    raise PhaseError(f"29c compressed: step-2 loss "
                                     f"{losses[1]} equals the uncompressed "
                                     f"run's: compression changed nothing")
                held = (f"step 1 against one device: loss gap "
                        f"{loss_gaps[0]:.3e} (tol {TRAIN_BF16_LOSS_REL[0]}),"
                        f" grad norm gap {gn_gaps[0]:.3e} (tol "
                        f"{MESH_COMPRESSED_GNORM_REL:.3e}); steps 2.. "
                        f"against uncompressed {[f'{g:.3e}' for g in track]}"
                        f" (tol {MESH_COMPRESSED_LOSS_REL}), step 2 "
                        f"{losses[1]} vs {up[1]}")
            if not (all(math.isfinite(x) for x in losses + gnorms)
                    and all(g <= lim for g, lim in lims)
                    and all(b < a for a, b in zip(losses, losses[1:]))):
                raise PhaseError(
                    f"29c {tag}: losses {losses} grad norms {gnorms}; one "
                    f"device, whole batch: losses {want_l} grad norms "
                    f"{want_g}; two halves: losses {halves_l} grad norms "
                    f"{halves_g}; {held}")
            wire = ("modelled (compressed_bytes): the all-reduce still "
                    "moves the dequantised bf16 gradients" if tag ==
                    "compressed" else "the bf16 gradients")
            lines.append(
                f"{tag}: losses {losses} grad norms {gnorms}; {held}; wall "
                f"{run['wall_s']:.1f} s; wire {run['wire_bytes']} B a rank a "
                f"step, {wire}; peak per rank "
                f"{[round(c['peak_gib'], 2) for c in run['ranks']]} GiB; "
                f"collectives given CUDA tensors per rank "
                f"{[c['collectives']['cuda_calls'] for c in run['ranks']]}")
        print(f"[29c Trainer(data_parallel=True) deepseek-7b full width, "
              f"{MESH['dp_layers']} layers bf16, global batch "
              f"{MESH['dp_batch']} x {MESH['seq']} over {MESH['ranks']} "
              f"ranks, {MESH['steps']} AdamW steps lr {MESH['lr']}] "
              f"transport: {plain['mesh']}; one device, whole batch: "
              f"losses {want_l} grad norms {want_g}; two halves: losses "
              f"{halves_l} grad norms {halves_g}; " + "; ".join(lines))

if __name__ == "__main__":
    sys.exit(main())
