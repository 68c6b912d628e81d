#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one line (or a few):

1. device — the card's name and power limit (``nvidia-smi``), torch/CUDA;
2. build  — compile every kernel from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, in parallel);
3. kernels — each kernel against its plain PyTorch version on the card,
   at its main path's shapes, with its time, the plain version's, one
   library call's, and the least time the card could take (its bound);
   the flash forward in bf16 (the tensor-core kernel, ``attention_tc.cu``)
   and fp32 (the FMA kernel, ``attention.cu``), each the kernel its route
   rule names, with a causal-mask-off control that must fail its limits,
   at the prefill and at a training micro-batch (B = 1), and in bf16 at
   the prefills of phase 17's four head layouts; at Nemotron-4's dh 192
   (phase 18) in bf16 at its prefill (B = 4, S = 2,048, H = 96, K = 8) and
   at B = 1, and in fp32 at one tile, each bit-identical on a rerun;
   ``ssd_intra`` at
   Mamba-2's prefill, its scores, y and state kernels timed apart,
   bit-identical on a rerun, with a control (two heads' decays swapped)
   that must fail y's limit, and at Jamba's smoke prefill;
4. serving — the port's serving plane end to end: 4 clients × 8 requests
   of flat-plate snapshots [4, 4096] through ``continuous_batch`` (max
   batch 8), served by the QuadConv encoder at the paper config's widths
   (channels 4, internal 16, latent 100, 2 blocks, pool 4, filter MLP
   64 × 5) with random seeded weights; the plan's predictions must equal
   ``stats()``, every kernel must have launched, and every response must
   match the plain-version encoder run on the card; then where a drained
   batch's device time goes (CUDA events), and the same session once more
   under ``torch.profiler`` (the device's busy share, each kernel's device
   time per launch);
5. three-step — the same requests through the ``three_step`` tier;
6. threaded — the continuous-batching session once more with one host
   thread per component (the default ``run()``), responses checked;
6a. chaos serve — the continuous-batching session under an empty armed
   ``FaultPlan`` and under a serving crash at batch 1 and a duplicated
   response chunk: every component's dispatches, retries and restarts
   and the server's fault counters equal to the plan's, the request and
   results tables and every response equal to the armed run's
   (``torch.equal``), the probe, gather and QuadConv launches equal;
7. grad — one training microstep of the autoencoder at the same widths
   and 2,048 points: the loss and every parameter gradient with the
   contraction kernel's forward against the plain einsum's (and, as a
   control that must fail the same limit, the einsum's with TF32
   matmuls), and where the microstep's device time goes;
8. train — the paper's in-situ workflow: a flat-plate producer (40
   steps, every 2nd emitted, ring of 24), the fused trainer (8 epochs,
   gather 6, batch 4, lr 1e-3) and 5 in-situ inference calls, first
   sequential then threaded; one line per epoch (losses, relative
   Frobenius error, device ms), the plan's dispatches against
   ``stats()``, the launch counts, the peak memory, and every inference
   output against the plain encoder with the trained weights;
8a. chaos train — phase 8's sequential session three ways: disarmed,
   under an empty armed ``FaultPlan``, and under a plan of every fault
   kind (an ``unavailable`` window on ``capture``, a dropped and a
   duplicated chunk, a producer and a trainer crash, a ``snapshot`` then
   a store ``restart``; a fast ``RetryPolicy``): the faulted run's table
   (slab, keys, version, ptr, count) and trained state equal to the armed
   run's (``torch.equal``), its predictions exact, its sample, gather and
   QuadConv launches equal to the armed run's; each run's epoch ms (CUDA
   events) and wall time; the restart (image copy + the log's tail) and a
   snapshot timed on the faulted run's server, beside the snapshot's
   bytes bound; and, as a control that must fail, a replay with the
   log's last entry cut must leave a different table;
9. launch — ``repro_torch.launch.insitu.run(points="medium", epochs=4,
   sim_steps=40)``, the launcher a user calls;
9a. spectral — the pseudo-spectral Navier-Stokes solver
   (``repro_torch.sim.spectral`` on cuFFT) alone at 512³, the grid a DNS
   user runs on one 80 GB card (ν = 1e-3, dt = 1e-3, forcing on, from
   ``random_turbulence``): ``step`` and ``snapshot`` by CUDA events
   beside their bytes bound (``spectral_bytes``), the peak memory,
   ``max_divergence`` and one profiled step; the 2-D Taylor-Green decay at 512³ within 1e-5 of
   E₀·e^{-4νt} (a viscosity-free control must fail it); the 3-D
   Taylor-Green vortex's divergence after 10 steps at 512³ under the
   reference test's 1e-10 (steps without the final projection must fail
   it), the reference's own 16³ case read beside it; one step and a
   snapshot at 32³ on the card within 1e-5
   of the CPU's (the card's step with the forcing off must fail it);
9b. insitu spectral — ``launch.insitu.run(producer="spectral",
   points="medium", epochs=8, sim_steps=40)``: plan == ``stats()``, the
   sample, gather and QuadConv launches equal to phase 8's session's,
   finite losses, the overhead table's ``equation_solution``, ``send``
   and ``retrieve`` means;
10. lm phi4 — LM serving at Phi-4-mini's full width (32 layers, d_model
   3072, GQA 24/8, vocab 200,064) in bf16 with random seeded weights:
   ``greedy_generate`` of 32 tokens after a 2,048-token prompt at B = 4
   with ``attn_impl="flash"`` (exactly 32 launches of the tensor-core
   flash forward, one prefill, and none of the FMA forward);
   the prefill's time, a decode step's, decode tokens/s, peak memory and
   where the device time goes (``torch.profiler``); then the kernel path
   against the port's plain attention (``attn_impl="xla"``): every
   layer's attention output on the same input within ``LAYER_LIMIT``, the
   prefill's last-position logits within ``LM_LIMIT`` — and, as a
   control that must FAIL both, the kernel path with its causal mask off;
11. lm mamba2 — the same at Mamba-2 1.3B's full width (48 layers,
   d_model 2048, 64 SSD heads of 64, state 128, chunk 256) with
   ``ssd_impl="kernel"`` (exactly 48 ``ssd_intra`` launches, its scores,
   y and state kernels on the tensor cores) against ``"xla"`` (the
   chunked scan);
12. serve_loop — ``repro_torch.launch.serve.run`` at Phi-4-mini's full
   width: 8 requests, B = 4, prompts of 8, 16 new tokens, every 8th
   step's logits captured into a ring table through ``send_step``;
13. lm train — LM training at Phi-4-mini's full width in bf16: (a) the
   flash-attention backward kernels (dq and dk/dv on the tensor cores in
   bf16, ``attention_bwd_tc.cu``, on FMA in fp32) against their plain
   version at the training shape (B = 1, S = 2,048, H = 24, K = 8,
   dh = 128, bf16) and at one reference tile in fp32, timed beside the
   backward of ``scaled_dot_product_attention``, dq, dk and dv
   bit-identical on a second run and a causal-mask-off control failing
   each one's limit; (b) on
   every layer, the
   attention mixer's input gradient and its ``wq/wk/wv/wo`` gradients
   through the kernels (``attn_impl="flash"``) against the plain path
   (``"xla"``) on the same input and cotangent, within
   ``LAYER_GRAD_LIMIT`` — and, as a control that must FAIL it, the
   backward kernels with their causal mask off under a causal forward;
   then the whole model's loss and ``grad_norm`` on one micro-batch
   through both paths; (c) the launcher a user calls,
   ``repro_torch.launch.train.run(arch="phi4_mini_3_8b", steps=4,
   batch=2, seq_len=2048, attn_impl="flash")``: exactly 128 tensor-core
   forward, 64 tensor-core dq and 64 tensor-core dk/dv launches per step
   (32 layers, 2 micro-batches, the forward run again by remat) and none
   of the FMA forward, dq or dk/dv, finite losses and gradient norms, bf16
   params in the reference's layout; its step time, tokens/s, peak memory
   and, from one profiled step, each attention kernel's share of the
   device time and the device's idle share; (d) ``[checkpoint full]``:
   that launcher's full-width train state through one
   ``Checkpointer.maybe_save`` (staged leaf by leaf into a pinned host
   arena, written in the background): the call, the copies and the write
   timed, the staging alone again beside its PCIe bound, the card's peak
   memory within the largest leaf of where it started and of the step's
   own peak, the files equal to the live state on the host; one more
   step, after which the state must differ from the files (the control);
   an in-place ``restore`` with a level peak, every leaf then equal to
   its file bit for bit;
14. sharded — the slab-sharded data plane: (a) the sharded gather kernel
   against its plain version, exactly, on the training table [24, 4,
   2048] fp32 split into D = 2 and D = 4 shards with slots on every shard;
   the shards' results must sum to the whole gather, and, as a control
   that must FAIL that sum, the same gathers with the ownership mask
   dropped; (b) the in-situ workflow of phase 8 with the trainer on a
   2-rank mesh on this one card (``data_mesh(2, devices=[cuda] * 2)``),
   tiers ``sharded_fused`` and ``slab_sharded``, each session profiled:
   the plan against ``stats()``, exactly 2 sharded-gather launches per
   trainer store op and warm-up, ``slab_sharded``'s final state and losses
   equal to ``sharded_fused``'s (``torch.equal``); then, as the
   reference's own test does, ONE epoch of each tier from the same state
   on the same table and draws: ``sharded_fused`` within params rtol
   2e-5 / atol 1e-6, train loss 1e-5, val loss 1e-4 (relative) of
   ``fused``, ``slab_sharded`` equal to it; the eight-epoch
   ``sharded_fused`` session within ``DRIFT_PARAM_ATOL`` (largest param
   difference) and ``DRIFT_LOSS_RTOL`` (each epoch's train and val loss)
   of phase 8's fused run, and, as a control that must FAIL the param
   limit, the same session with rank 1's gradients and loss dropped
   (rank 0's counted for both ranks); each tier's CUDA-event time per
   epoch, idle share and peak memory.  Two ranks on one card measure the
   mesh's overhead, not its scaling; (c) ``[collectives]``:
   ``plan(hlo=True)`` on the 2-rank mesh, each trainer tier's collective
   calls over one epoch held to its prediction (``fused`` none,
   ``sharded_fused`` an all-reduce on a whole table and an all-reduce and
   an all-gather on a split one, ``slab_sharded`` an all-reduce and no
   all-gather), and, as a control that must raise, ``slab_sharded``'s
   prediction against ``sharded_fused``'s counts on the split table;
15. reproducer — the paper's reproducer (``repro_torch.sim.reproducer``):
   ``run_transfer`` at the paper's default (24 ranks x 256 KB, 2 warm-up
   + 40 timed iterations), vectorized and per rank, every value read back
   equal to its payload row bit for bit, ``op_count`` 2 (vectorized) and
   2 x 24 (per rank) an iteration, the probe and gather kernels launched
   exactly once an iteration on the vectorized path and never on the
   per-rank one; then the vectorized loop at Fig. 4's 16 KB .. 16 MB a
   rank, each size's send and retrieve per op and MB/s beside the bytes
   bound; the probe at the reproducer's ring (48 slots, 24 keys) and the
   gather kernel at 24 rows of 256 KB and of 16 MB against their plain
   versions bit for bit (the gather with a moved-slot control that must
   fail), timed beside ``index_select`` and the bound; ``run_inference``
   with ResNet-50 (registered through ``fold_registry_axis``) at Fig. 7's
   batches 1, 4 and 16, three-step and fused, and the in-line
   ``apply_resnet50`` call, TF32 off (the in-line call also with TF32 on),
   three-step and fused within the registry tolerance of each other; the
   card's logits against the same function on the CPU within
   ``RESNET_CARD_RTOL``, a symmetric-padding stem failing it; and the
   model through ``InSituSession`` with ``InferenceConsumer`` tiers
   ``three_step`` and ``fused_registry`` (``examples/insitu_inference.py``'s
   path), each ``ok``;
15d. clustered fd — the ``[colocated fd]`` producer into a clustered
   ring (``make_clustered_1d(db_fraction=0.5)`` over 4 ranks of this
   card: 2 client ranks run the solver, 2 db ranks hold the ring cut
   on dim 1), overlap on, off, and on with a dropped transfer: staged
   transfers and op counts exact to the plan, a chunk's collectives the
   halo's alone, the ring bit for bit ``[colocated fd]``'s and the
   solver's, the three tables equal, a reordered-pipeline control that
   must fail; a staged chunk's ms against its bytes bound, the share of
   the staging the overlap hides, the idle share, peak memory;
15e. clustered train — phase 8's workflow with the trainer in tier
   ``slab_sharded_clustered`` (2 client ranks, the table slot-cut over 2
   db ranks): params and losses ``torch.equal`` to ``[sharded]``'s
   ``slab_sharded`` run, ``gather_stage`` == epochs, exact launches, an
   epoch's collectives as predicted, epoch ms beside ``slab_sharded``'s;
15f. clustered serve — phase 4's session on a 1 + 1 clustered store at
   both tiers: responses ``torch.equal`` to phase 4's, ``request_stage``
   32 and (three-step) ``response_stage`` 32, launches equal, requests/s
   in ABBA turns with the local run;
15g. fan-in — ``benchmarks/fig5_weak_scaling.py``'s clustered producer
   (256 KB a step, 256 steps in chunks of 16) at fan-in 1, 2 and 3 over
   8 ranks of this card, overlap on and off: counts exact, then the
   fitted ``ContentionModel``, its residual and ``autotune_chunk``;
16. checkpoint — a ``MemoryCheckpoint`` of a 4 MB state on the card,
   unchanged by an in-place update of the live state; then
   ``repro_torch.launch.train.run`` at the Phi-4-mini smoke config with
   ``attn_impl="flash"`` (fp32: the FMA forward, dq and dk/dv kernels):
   4 steps saving every 2 under a temporary directory, then resumed from
   step 2 (the step-4 checkpoint removed), steps 3–4 bit for bit the
   uninterrupted run's (losses, gradient norms, every state leaf), with
   the save and restore times;
17. lm zoo — the LM zoo's decoder-only families at full width in bf16,
   depth cut to fit the card (``ZOO_LAYERS``), each as phase 10 (greedy
   generation of 32 tokens after 4 × 2,048 with ``attn_impl="flash"``:
   exact tensor-core flash launches, one a layer, and none of the FMA
   forward; each layer and the logits against the plain path): (a)
   Qwen3-MoE, 8 of 94 layers; (b) ``[moe layer]``: each of its MoE
   layers on the plain path's hidden state, the bf16 ``moe_apply``
   against the same layer in fp32 (routing agreement, the dropped set
   against an independent count, the output on agreeing tokens, the aux
   term), with a k-major priority order and unnormalized gates as
   controls that must fail; (c) Llama-4 Scout, 8 of 48 (top-1, the
   shared expert); (d) StarCoder2-7B whole (gelu, layernorm); (e)
   LLaVA-NeXT-34B, 16 of 60, with 1,152 random patch embeddings in front
   of the prompt through ``make_prefill_step`` / ``make_decode_step``;
   (f) ``[hybrid jamba]``: Jamba's smoke config in fp32, the FMA flash
   forward once and ``ssd_intra`` 7 times a prefill, its logits and
   caches against the CPU's, and ``launch.serve.run(smoke=True)`` for
   Qwen3-MoE and Jamba;
18. nemotron — Nemotron-4 340B at full width in bf16 (d_model 18,432,
   96 heads of 192 over 8 kv heads, squared-ReLU MLP of 73,728, vocab
   256,000, untied), depth cut to fit the card: (a) ``[lm nemotron]``, 4
   of 96 layers (46.5 GB of weights) through ``lm_phase`` as phase 10
   (exactly 4 ``FLASH_TC`` launches a prefill, none of ``FLASH``; each
   layer and the logits against the plain path, a causal-mask-off
   control failing both); (b) ``[lm train nemotron]``, 1 layer (params
   and bf16 gradients 51.6 GB), grad_accum 1 (the config's 64), one
   sequence of 2,048 a step, Adafactor: the dq and dk/dv kernels at
   dh 192 against their plain version (bf16 at the step's shape, fp32 at
   one tile) beside SDPA's backward, every layer's attention gradients
   and the whole model's loss and ``grad_norm`` against the plain path
   (``grads_vs_plain``, phase 13's checks), 4 steps of
   ``make_train_step`` with exactly 2 / 1 / 1 tensor-core forward / dq /
   dk/dv launches a step and none of the FMA ones, the peak memory under
   the card's, one profiled step, and one Adafactor step of the card's
   state against float64 on the embedding and the MLP's ``w_up``
   (``adafactor_step_check``); then both smoke launchers
   (``launch.serve.run`` and ``launch.train.run`` with ``smoke=True``).

Kernel, plain and library times in the kernels line are device times per
call (``torch.profiler``: the summed device time of every kernel and copy
the call launched); ``wall_ms`` beside them is the CUDA-event time per
call over back-to-back calls, which a launch-bound kernel spends mostly
in host enqueue.  The profiler loses some records late in the script,
so a kernel's device time is its mean per record kept times its
launches a call (``timed_by`` counts the records lost).

Then one JSON line with every kernel's numbers (the probe's and the
gather's rows carry the reproducer's shapes, with their launches there,
under ``"reproducer"``; the store and QuadConv rows' ``launches_by_path``
add the faulted chaos runs and the spectral session; the flash row's
``"zoo"`` and the SSD row's ``"jamba"`` carry phase 17's shapes, the
attention rows' ``"nemotron"`` phase 18's, and
every attention and SSD row's ``launches_by_path`` its launches), the
``nvidia-smi`` line,
and as the last line ``{"ok": true, "device": {...}}``.  Any failure
raises and the script exits non-zero; without a CUDA device it exits 1
before doing anything.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32, outside the tensor cores
PEAK_BF16_FLOPS = 989e12        # H100 SXM bf16 tensor cores, dense
PCIE_BYTES_PER_S = 64e9         # PCIe 5.0 x16, one direction (host link)
SEED = 0
CLIENTS, REQUESTS, MAX_BATCH = 4, 8, 8
# the training slice (paper §4, reference launcher's "medium" grid)
SIM_STEPS, EMIT_EVERY, RING, EPOCHS, GATHER, BATCH, N_INF = \
    40, 2, 24, 8, 6, 4, 5
# LM serving: a batch of 4 prompts of 2,048 tokens, 32 new tokens each
LM_BATCH, PROMPT, NEW_TOKENS = 4, 2048, 32
# Kernel path against plain path, in bf16 (relative Frobenius; PERF.md):
# each layer's mixer output on the same input (the plain path's hidden
# state), where bf16 rounding is all that may differ; and the prefill's
# last-position logits, where that rounding has grown through every
# random-weight layer (~1.17x a layer: 0.15 after Mamba-2's 48 layers)
LAYER_LIMIT = 1e-2
LM_LIMIT = 0.4
# the LM zoo's decoder-only families at full width, depth cut to fit one
# card (bf16 params: Qwen3-MoE 8 of 94 layers 42.3 GB, Llama-4 Scout 8 of
# 48 39.4 GB, LLaVA-NeXT 16 of 60 19.7 GB; StarCoder2-7B whole 14.8 GB)
ZOO_LAYERS = {"qwen3_moe_235b_a22b": 8, "llama4_scout_17b_a16e": 8,
              "starcoder2_7b": 32, "llava_next_34b": 16}
# each Qwen3-MoE layer's bf16 moe_apply against the same layer in fp32,
# set from the readings of an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
# the share of routing pairs that agree (all of them: both route in fp32
# from the same bf16 values), the output on the tokens whose routing
# agrees (relative Frobenius; read 4.8e-3 in every layer, unnormalized
# gates 0.71), the aux term (relative)
MOE_ROUTING_FLOOR = 1.0
MOE_Y_LIMIT = 1e-2
MOE_AUX_RTOL = 1e-3
# Jamba's smoke config on the card against the CPU, fp32, each leaf of the
# prefill's logits and caches relative to its max|.|: the plain path
# (attention "xla", SSD "xla") within JAMBA_CPU_RTOL, the kernel path
# within JAMBA_KERNEL_RTOL: ssd_intra's two bf16 terms an operand (~1e-5
# of max a call) grow through the 7 mamba blocks to 1.7e-4 at the last
# state (NVIDIA H100 80GB HBM3 at 700 W; PERF.md)
JAMBA_BATCH, JAMBA_SEQ = 2, 128
JAMBA_CPU_RTOL, JAMBA_KERNEL_RTOL = 1e-4, 1e-3
# LM training at Phi-4-mini's full width: 4 steps of 2 x 2,048 tokens
# (grad_accum 2: micro-batches of 1 x 2,048).  Kernel path against plain
# path in bf16 (PERF.md): each layer's attention gradients (input, wq,
# wk, wv, wo; relative Frobenius) on the same input and cotangent, and the
# whole model's loss and grad_norm on one micro-batch (relative)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
# the slab-sharded data plane: D ranks on this one card; the reference's
# mesh-vs-single-device tolerances (tests/test_sharded_epoch.py)
SHARDS = 2
MESH_RTOL, MESH_ATOL, MESH_TRAIN_RTOL, MESH_VAL_RTOL = 2e-5, 1e-6, 1e-5, 1e-4
# the eight-epoch sessions' drift of sharded_fused from fused, set from the
# H100's readings (largest param difference 1.18e-6, val loss 7.0e-8
# relative, train loss equal; PERF.md): a control that drops one rank's
# gradients must exceed the param limit
DRIFT_PARAM_ATOL, DRIFT_LOSS_RTOL = 1e-5, 1e-6
# the int8 wire's first epoch at phase 8's width against psum's: the H100
# reads 4.0% (PERF.md), twice the reference's 2% at its narrower config,
# from the parameters whose int8 gradient rounds to 0 or flips its sign
# (int8_microstep_witness)
INT8_EPOCH_RTOL = 0.05
LAYER_GRAD_LIMIT = 2e-2
LOSS_LIMIT = 1e-3
GRAD_NORM_LIMIT = 5e-2
# Nemotron-4 at full width, depth cut to fit one card (bf16): serving 4 of
# 96 layers (23.25B params, 46.5 GB), training 1 layer (12.89B: params and
# bf16 gradients 51.6 GB) at grad_accum 1, one sequence of 2,048 tokens a
# step, Adafactor; one Adafactor step's moments against float64,
# elementwise relative (fp32 means over up to 256,000 rows)
NEMOTRON = "nemotron_4_340b"
NEMOTRON_SERVE_LAYERS, NEMOTRON_TRAIN_LAYERS, NEMOTRON_TRAIN_STEPS = 4, 1, 4
ADAFACTOR_RTOL = 1e-5
# the serving stack's logits against the plain path: LM_LIMIT is set for
# 48 random-weight layers, and at 4 a causal-mask-off control that moves
# every layer's mixer by 0.92 moves the last position's logits by only
# 0.30 (an H100 80GB HBM3 at 700 W, PERF.md), inside it: the cut stack
# is held at a quarter of it
NEMOTRON_LM_LIMIT = 0.1
# the paper's reproducer (paper §3): its default deployment (24 ranks x
# 256 KB, 2 warm-up + 40 timed iterations), Fig. 4's message sizes at 24
# ranks, Fig. 7's ResNet-50 batches; ResNet-50's logits on the card
# against the same port function on the CPU, TF32 off on both (relative to
# max|logits|; PERF.md); the in-situ inference session's batch and steps
# (examples/insitu_inference.py's)
FIG4_SIZES = (16 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20)
FIG7_BATCHES = (1, 4, 16)
RESNET_CARD_RTOL = 1e-4
INFER_BATCH, INFER_STEPS = 2, 5
# the spectral solver alone on the card: the grid a DNS user runs on one
# 80 GB card, with nu and dt inside explicit RK4's limit
# (nu * k2max * dt = 0.197 < 2.78 at k2max = 3 * 256**2)
SPECTRAL_N, SPECTRAL_NU, SPECTRAL_DT, SPECTRAL_STEPS = 512, 1e-3, 1e-3, 5
# the 2-D Taylor-Green decay at 512^3 (nu * k2max * dt = 1.97) within the
# reference test's 1e-5; the 3-D Taylor-Green vortex's divergence after 10
# steps at 512^3 within the reference test's 1e-10 (its own 16^3 case is
# read, not held: cuFFT leaves that float32 field at ~1.3e-10, PERF.md);
# one step on the card against the CPU's at 32^3 (cuFFT against
# pocketfft) within the port-vs-reference one-step limit
# (tests/test_torch_spectral.py)
TG_NU, TG_STEPS, TG_RTOL = 1e-2, 10, 1e-5
DIV_LIMIT, DIV_REFERENCE_CASE = 1e-10, dict(n=16, nu=0.05, dt=0.01)
CARD_CPU_N, CARD_CPU_RTOL = 32, 1e-5
# the co-located deployment: the distributed FD producer on a 4,096^2
# periodic box (16.8M points) cut over SHARDS space ranks on this card,
# nu and dt inside the explicit scheme's nu * dt / h^2 <= 1/4 (dt <= 2.9e-4
# here), the reference's 64 Jacobi sweeps; 48 steps in chunks of 16 into a
# co-located ring of 16 [2, 4096, 4096] fp32 snapshots (2.15 GB); the 2-rank
# step against the unsharded one, bit for bit where every op is elementwise
# or a copy, else within the reference test's 1e-5
FD_N, FD_NU, FD_DT, FD_ITERS = 4096, 2e-3, 1e-4, 64
FD_STEPS, FD_CHUNK, FD_CAP, FD_ATOL = 48, 16, 16, 1e-5


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, patterns: dict | None = None,
              info: dict | None = None):
    """Device time of one call of ``fn``: the device time of every kernel
    and copy its ``iters`` calls launched, under ``torch.profiler``, over
    ``iters``; with ``patterns`` (name → CUDA symbol, see ``kernel_hits``)
    instead a dict of each named kernel's device time per launch.  None
    when the profiler sees no device activity (or not every kernel).
    The profiler can lose records late in a long process (a sum over
    ``iters`` then reads low), so each kernel's mean per record counts as
    often as it ran a call (its records over ``iters``, rounded; one
    that ran on fewer calls than half counts its total over ``iters``);
    ``info`` receives the records kept and the records that a whole
    number a call implies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    if patterns is None:
        per_call, kept, implied = 0.0, 0, 0
        for e in events:
            if not e.count:
                continue
            runs = round(e.count / iters)
            per_call += (e.self_device_time_total / e.count * runs if runs
                         else e.self_device_time_total / iters)
            kept += e.count
            implied += max(runs * iters, e.count)
        if info is not None:
            info.update(profiler_records=kept, records_implied=implied)
        return per_call / 1e3 if per_call else None
    out = {}
    for name, pattern in patterns.items():
        hits = kernel_hits(events, pattern)
        if not hits:
            return None
        out[name] = sum(e.self_device_time_total for e in hits) \
            / sum(e.count for e in hits) / 1e3
    return out


def timed(fn, iters: int) -> dict:
    """``ms`` (device time per call, ``device_ms``; the CUDA-event time
    where the profiler saw nothing), ``wall_ms`` (CUDA events) and which
    was used, with the records the profiler lost."""
    wall = time_ms(fn, iters)
    info: dict = {}
    dev = device_ms(fn, iters, info=info)
    if dev is None:
        return {"ms": wall, "wall_ms": wall, "timed_by": "cuda_events"}
    lost = info["records_implied"] - info["profiler_records"]
    return {"ms": dev, "wall_ms": wall, "timed_by": "torch.profiler"
            if not lost else f"torch.profiler (mean a record; {lost} of "
            f"{info['records_implied']} records lost)"}


def bound(nbytes: float, flops: float = 0.0,
          peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / peak_flops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


WINDOW = "chip_smoke.window"


def profile(run, top: int = 0) -> str:
    """Run ``run()`` under ``torch.profiler``.  Every time comes from the
    profiler's one clock: the window is the span of ``run()`` through
    the final synchronize (a ``record_function`` range), the device time
    the sum of the kernels' and copies' intervals (one stream: they do
    not overlap), the device span from the first one's start to the last
    one's end.  Prints them, the idle share of the window and of the
    device span, whether the device time fits in the window, each port
    kernel's device time per launch and share of the device time, and
    with ``top`` the ``top`` largest entries by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from torch.profiler import record_function
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            run()
            torch.cuda.synchronize()
    window = [e.time_range for e in prof.events()
              if e.name == WINDOW and e.device_type == DeviceType.CPU]
    # the range's mirror on the device timeline is no kernel
    spans = [e.time_range for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.name != WINDOW]
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key != WINDOW]
    if not (kernels and spans and window):
        return "the profiler saw no device activity: not measured"
    window_s = window[0].elapsed_us() / 1e6
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    span_s = (max(r.end for r in spans) - min(r.start for r in spans)) / 1e6
    per_launch, share = {}, {}
    for name, pattern in KERNEL_SYMBOLS:
        hits = kernel_hits(kernels, pattern)
        if hits:
            total = sum(e.self_device_time_total for e in hits)
            per_launch[name] = round(
                total / sum(e.count for e in hits) / 1e3, 5)
            share[name] = round(total / 1e6 / device_s, 4)
    out = (f"window_s={window_s:.4f} device_s={device_s:.4f} "
           f"device_span_s={span_s:.4f} "
           f"device_within_window={device_s <= window_s} "
           f"idle_share={1 - device_s / window_s:.4f} "
           f"idle_share_in_span={1 - device_s / span_s:.4f} "
           f"device_ms_per_launch={per_launch} "
           f"share_of_device_time={share}")
    if top:
        largest = sorted(kernels, key=lambda e: -e.self_device_time_total)
        out += " largest=" + json.dumps([
            [e.key[:80], e.count, round(e.self_device_time_total / 1e6
                                        / device_s, 4)]
            for e in largest[:top]])
    return out


# the port's kernels by the name of their CUDA symbol
KERNEL_SYMBOLS = (("probe_slots", "probe_kernel"),
                  ("sample_slots", "sample_kernel"),
                  ("gather_rows", "gather_kernel"),
                  ("gather_rows_sharded", "gather_sharded_kernel"),
                  ("quadconv_contract", "quadconv_contract_kernel"),
                  ("flash_attention", "flash_fwd_kernel"),
                  ("flash_attention_tc", "flash_fwd_tc_kernel"),
                  ("flash_attention_bwd_dq", "flash_bwd_dq_kernel"),
                  ("flash_attention_bwd_dq_tc", "flash_bwd_dq_tc_kernel"),
                  ("flash_attention_bwd_dkv", "flash_bwd_dkv_kernel"),
                  ("flash_attention_bwd_dkv_tc", "flash_bwd_dkv_tc_kernel"),
                  ("ssd_intra", "ssd_"))


def kernel_hits(events, pattern: str) -> list:
    """Profiler events of one kernel: ``pattern`` not preceded by a letter
    or "_" (PyTorch's own ``vectorized_gather_kernel`` is not the port's
    ``gather_kernel``)."""
    return [e for e in events
            if re.search(rf"(?<![A-Za-z_]){pattern}", e.key)]


def check_probe(dev) -> dict:
    from repro_torch.kernels.store import ops, ref
    gen = torch.Generator().manual_seed(SEED)
    capacity, n = 32, 8
    keys = torch.randint(0, 2**31, (capacity,), generator=gen,
                         dtype=torch.int64)
    keys[5] = keys[17] = keys[29]          # duplicates: lowest live slot wins
    keys[3] = ref.EMPTY_KEY                # a never-written slot
    version = torch.randint(1, 100, (capacity,), generator=gen,
                            dtype=torch.int32)
    version[5] = 0                         # dead slot holding a live key
    query = torch.tensor([keys[29], keys[0], keys[31], ref.EMPTY_KEY, 12345,
                          keys[3], keys[10], keys[17]], dtype=torch.int64)
    keys, version, query = keys.to(dev), version.to(dev), query.to(dev)
    idx, found = ops.probe_slots(keys, version, query)
    idx_r, found_r = ref.probe_slots_ref(keys, version, query)
    err = int((idx - idx_r).abs().max())
    if err or not torch.equal(found, found_r):
        raise AssertionError(f"probe kernel disagrees: {idx} vs {idx_r}")
    kernel = timed(lambda: ops.probe_slots(keys, version, query), 200)
    plain = timed(lambda: ref.probe_slots_ref(keys, version, query), 200)
    b, by = bound(capacity * (8 + 4) + n * (8 + 4))
    return {"name": "probe_slots", "route": "cuda",
            "source": "src/repro_torch/kernels/store/csrc/store.cu",
            "replaces": "src/repro/kernels/store/kernel.py:48",
            "max_abs_err": err, **kernel, "plain_ms": plain["ms"],
            "plain_wall_ms": plain["wall_ms"], "library_ms": None,
            "bound_ms": b, "bound_by": by,
            "shape": f"capacity={capacity} n={n}"}


def check_sample(dev) -> dict:
    """The sample kernel against its plain version, exactly: at the
    trainer's shapes (C = 24, n = 6) and at C = 4096, n = 256, with dead
    slots, an empty table, and ranks below 0 and past the live count."""
    from repro_torch.kernels.store import ops, ref
    gen = torch.Generator().manual_seed(SEED)
    cases = []
    for capacity, n, live in ((RING, GATHER, 0.75), (4096, 256, 0.5),
                              (RING, GATHER, 0.0)):
        version = torch.randint(1, 100, (capacity,), generator=gen,
                                dtype=torch.int32)
        version[torch.rand(capacity, generator=gen) >= live] = 0
        nvalid = int((version > 0).sum())
        ranks = torch.randint(0, max(nvalid, 1), (n,), generator=gen,
                              dtype=torch.int32)
        ranks[:3] = torch.tensor([-1, nvalid, nvalid + 5])
        cases.append((version.to(dev), ranks.to(dev)))
    for version, ranks in cases:
        got = ops.sample_slots(version, ranks)
        want = ref.sample_slots_ref(version, ranks)
        if not torch.equal(got, want):
            raise AssertionError(f"sample kernel disagrees at C="
                                 f"{version.numel()}: {got} vs {want}")
    version, ranks = cases[0]
    kernel = timed(lambda: ops.sample_slots(version, ranks), 200)
    plain = timed(lambda: ref.sample_slots_ref(version, ranks), 200)
    b, by = bound((version.numel() + 2 * ranks.numel()) * 4)
    return {"name": "sample_slots", "route": "cuda",
            "source": "src/repro_torch/kernels/store/csrc/store.cu",
            "replaces": "src/repro/kernels/store/kernel.py:99",
            "max_abs_err": 0, **kernel, "plain_ms": plain["ms"],
            "plain_wall_ms": plain["wall_ms"], "library_ms": None,
            "bound_ms": b, "bound_by": by,
            "shape": f"capacity={version.numel()} n={ranks.numel()} "
                     "(also checked: C=4096 n=256, an empty table)"}


def check_gather(dev, capacity: int, n: int, row: tuple) -> dict:
    """The gather kernel against its plain version, bit for bit, on ``n``
    distinct random slots of a ``[capacity, *row]`` fp32 slab (so the bound
    reads each row once, as the paths' gathers do); a control with one slot
    moved must not be equal.  Timed beside ``index_select`` and the
    bound."""
    from repro_torch.kernels.store import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    slab = torch.randn((capacity, *row), generator=gen, device=dev)
    slots = torch.randperm(capacity, generator=gen, device=dev,
                           dtype=torch.int32)[:n]
    want = ref.gather_rows_ref(slab, slots)
    if not torch.equal(ops.gather_rows(slab, slots), want):
        raise AssertionError(f"gather kernel disagrees at {n} rows of "
                             f"{list(row)}")
    moved = slots.clone()
    moved[n // 2] = (moved[n // 2] + 1) % capacity
    if torch.equal(ops.gather_rows(slab, moved), want):
        raise AssertionError("gather control (one slot moved) passed")
    kernel = timed(lambda: ops.gather_rows(slab, slots), 200)
    plain = timed(lambda: ref.gather_rows_ref(slab, slots), 200)
    slots64 = slots.long()
    library = timed(lambda: torch.index_select(slab, 0, slots64), 200)
    b, by = bound(2 * n * slab[0].numel() * 4 + n * 4)
    return {"name": "gather_rows", "route": "cuda",
            "source": "src/repro_torch/kernels/store/csrc/store.cu",
            "replaces": "src/repro/kernels/store/kernel.py:142",
            "max_abs_err": 0, "moved_slot_control": "failed, as it must",
            **kernel, "plain_ms": plain["ms"],
            "plain_wall_ms": plain["wall_ms"], "library_ms": library["ms"],
            "bound_ms": b, "bound_by": by,
            "shape": f"capacity={capacity} n={n} rows of {list(row)} f32"}


def check_gather_sharded(dev) -> dict:
    """The sharded gather kernel against its plain version, bit for bit, on
    the training table [24, 4, 2048] fp32 split into D = 2 and D = 4
    shards, 6 slots on every shard; the shards' results must sum to the
    whole gather, and the same gathers without the ownership mask (each
    shard's clamped row) must not.  Timed on rank 0's shard at D = 2."""
    from repro_torch.kernels.store import ops, ref
    gen = torch.Generator().manual_seed(SEED)
    slab = torch.randn((RING, 4, 2048), generator=gen).to(dev)
    for d in (SHARDS, 4):
        cl = RING // d
        owned = [r * cl + int(torch.randint(cl, (), generator=gen))
                 for r in range(d)]
        extra = torch.randint(0, RING, (GATHER - d,), generator=gen)
        slots = torch.tensor(owned + extra.tolist(), dtype=torch.int32,
                             device=dev)
        shards = [slab[r * cl:(r + 1) * cl] for r in range(d)]
        total = control = None
        for r, shard in enumerate(shards):
            out = ops.gather_rows_sharded(shard, slots, r * cl)
            want = ref.gather_rows_sharded_ref(shard, slots, r * cl)
            if not torch.equal(out.view(torch.int32),
                               want.view(torch.int32)):
                raise AssertionError(f"sharded gather disagrees at D={d} "
                                     f"rank {r}")
            unmasked = ops.gather_rows(
                shard, (slots - r * cl).clamp(0, cl - 1).to(torch.int32))
            total = out if total is None else total + out
            control = unmasked if control is None else control + unmasked
        whole = ops.gather_rows(slab, slots)
        if not torch.equal(total, whole):
            raise AssertionError(f"D={d}: the shards' sum is not the gather")
        if torch.equal(control, whole):
            raise AssertionError(f"D={d}: the control without the ownership "
                                 f"mask passed the sum check")
        if d == SHARDS:
            timing = (shards[0], slots)
    shard, slots = timing
    cl = shard.shape[0]
    mine = slots[slots < cl].long()
    kernel = timed(lambda: ops.gather_rows_sharded(shard, slots, 0), 200)
    plain = timed(lambda: ref.gather_rows_sharded_ref(shard, slots, 0), 200)
    nearest = timed(lambda: torch.index_select(shard, 0, mine), 200)
    row_bytes = shard[0].numel() * 4
    b, by = bound((mine.numel() + slots.numel()) * row_bytes
                  + 4 * slots.numel())
    return {"name": "gather_rows_sharded", "route": "cuda",
            "source": "src/repro_torch/kernels/store/csrc/store.cu",
            "replaces": "src/repro/kernels/store/kernel.py:147",
            "max_abs_err": 0, **kernel, "plain_ms": plain["ms"],
            "plain_wall_ms": plain["wall_ms"], "library_ms": None,
            "nearest_library_ms": nearest["ms"],
            "nearest_library": "index_select of the owned rows",
            "bound_ms": b, "bound_by": by,
            "shape": f"rank 0 of {SHARDS}: local slab [{cl}, 4, 2048] f32, "
                     f"{slots.numel()} slots, {mine.numel()} owned (also "
                     f"checked: D=4, the shards' sum, a mask-off control)"}


def check_quadconv(dev, B: int, I: int, C: int, O: int,
                   rerun: bool = False) -> dict:
    """The split-I kernel at J = I against the plain einsum (1e-4 of the
    output's magnitude); with ``rerun``, also bit-identical on a second call
    and a control, w with the plan's middle chunk zeroed, that must miss the
    limit.  Times: the kernel, the einsum, and cuBLAS's product of (f ⊙ w)
    [B, I·C] by G laid out as Gm [I·C, J·O] beforehand (the transpose not
    timed; TF32 off)."""
    from repro_torch.kernels.quadconv import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f = torch.randn((B, I, C), generator=gen, device=dev)
    w = torch.rand((I,), generator=gen, device=dev) / I
    g = torch.randn((I, I, O, C), generator=gen, device=dev)
    plan = ops._split_plan(I, I, O, C,
                           ops._sm_count(torch.cuda.current_device()))
    out = ops.quadconv_contract(f, w, g)
    out_r = ref.quadconv_contract_ref(f, w, g)
    err = float((out - out_r).abs().max())
    # fp32 sums of I*C = 16384 terms in two orders: relative 1e-4 of the
    # output's magnitude
    tol = 1e-4 * float(out_r.abs().max())
    if not err <= tol:
        raise AssertionError(f"quadconv kernel disagrees at I={I}: max err "
                             f"{err} > {tol}")
    extra = {}
    if rerun:
        if not torch.equal(ops.quadconv_contract(f, w, g), out):
            raise AssertionError(f"quadconv kernel at I={I}: a rerun "
                                 "differs")
        i0, i1 = plan.chunks()[plan.splits // 2]
        dropped = w.clone()
        dropped[i0:i1] = 0
        ctrl = float((ops.quadconv_contract(f, dropped, g) - out_r)
                     .abs().max())
        if not ctrl > tol:
            raise AssertionError(f"quadconv control (chunk [{i0}, {i1}) "
                                 f"dropped) passed: {ctrl} <= {tol}")
        extra = {"rerun_identical": True, "dropped_chunk": [i0, i1],
                 "dropped_chunk_err": ctrl}
    kernel = timed(lambda: ops.quadconv_contract(f, w, g), 20)
    plain = timed(lambda: ref.quadconv_contract_ref(f, w, g), 10)
    library = timed(
        lambda: torch.einsum("i,jioc,bic->bjo", w, g, f), 10)
    gm = g.permute(1, 3, 0, 2).reshape(I * C, I * O).contiguous()
    del g
    torch.cuda.empty_cache()

    def matmul():
        return torch.matmul((f * w[:, None]).reshape(B, I * C), gm)

    mm_err = float((matmul().view(B, I, O) - out_r).abs().max())
    if not mm_err <= tol:
        raise AssertionError(f"cuBLAS yardstick disagrees: {mm_err} > {tol}")
    cublas = timed(matmul, 10)
    b, by = bound(4 * (gm.numel() + f.numel() + w.numel() + B * I * O),
                  2.0 * B * I * I * O * C)
    del gm
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "tol": tol, **extra, **kernel,
            "bound_share": b / kernel["ms"],
            "plain_ms": plain["ms"], "plain_wall_ms": plain["wall_ms"],
            "library_ms": library["ms"],
            "library_matmul_ms": cublas["ms"], "bound_ms": b, "bound_by": by,
            "plan": {"splits": plan.splits, "chunk": plan.chunk,
                     "stages": plan.stages, "items": plan.items},
            "shape": f"B={B} I=J={I} C={C} O={O}"}


def leaves(tree) -> list:
    """Tensor leaves of nested dicts/lists, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def grad_errors(got: list, want: list) -> tuple[float, float, bool]:
    """The largest gradient difference over the microstep's largest
    gradient entry and over the leaf's own largest entry, and whether
    every leaf is within the ``[grad]`` limit (1e-4 and 1e-3 of those)."""
    gmax = max(float(b.abs().max()) for b in want)
    worst_global = worst_own = 0.0
    within = True
    for a, b in zip(got, want):
        own = float(b.abs().max())
        err = float((a - b).abs().max())
        within &= (err <= 1e-4 * gmax and err <= 1e-3 * own
                   and bool(torch.isfinite(a).all()))
        worst_global = max(worst_global, err / gmax)
        worst_own = max(worst_own, err / own if own else 0.0)
    return worst_global, worst_own, within


def check_grad(cfg, levels, params, batch) -> dict:
    """One microstep's loss and parameter gradients with the contraction
    kernel's forward against the plain einsum's.

    Every leaf must agree within 1e-4 of the largest gradient entry of
    the microstep, and within 1e-3 of its own largest entry; the loss
    within 1e-4 relative.  (A bias leaf's gradient is a sum of B·N terms
    of both signs, so its own maximum can be far below the terms it
    sums, and fp32 summation order alone moves it by about 1e-4 of that
    maximum at 2,048 points; ``PERF.md`` has the measurement.)  As a
    control, the einsum microstep with TF32 matmuls (10-bit mantissas)
    is held to the same limit and must fail it.
    """
    from repro_torch.ml import autoencoder as ae
    from repro_torch.ml import trainer as tr
    out = {}
    for mode, tf32 in ((None, False), ("ref", False), ("ref", True)):
        mcfg = replace(cfg, mode=mode)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = tr.value_and_grad(
            lambda p: ae.loss_fn(p, mcfg, levels, batch), params)
        torch.cuda.synchronize()
        out[mode, tf32] = (float(loss), leaves(grads),
                           torch.cuda.max_memory_allocated() / 1e9)
    torch.backends.cuda.matmul.allow_tf32 = False
    (lk, gk, peak_k), (lr, gr, peak_r), (lt, gt, _) = out.values()
    worst_global, worst_own, within = grad_errors(gk, gr)
    if not within:
        raise AssertionError(f"a gradient leaf differs by {worst_global} "
                             f"of the microstep's largest gradient and "
                             f"{worst_own} of its own")
    if not abs(lk - lr) <= 1e-4 * abs(lr):
        raise AssertionError(f"loss {lk} (kernel) vs {lr} (einsum)")
    tf32_global, tf32_own, tf32_within = grad_errors(gt, gr)
    if tf32_within:
        raise AssertionError("the TF32 control passed the [grad] limit: "
                             "the limit no longer tells fp32 from TF32")
    return {"loss_kernel": lk, "loss_einsum": lr, "leaves": len(gk),
            "max_err_over_grad_max": worst_global,
            "max_err_over_leaf_max": worst_own,
            "grad_max": max(float(b.abs().max()) for b in gr),
            "tf32_loss_rel": abs(lt - lr) / abs(lr),
            "tf32_max_err_over_grad_max": tf32_global,
            "tf32_max_err_over_leaf_max": tf32_own,
            "peak_gb_kernel": peak_k, "peak_gb_einsum": peak_r}


def microstep_breakdown(cfg, levels, params, batch) -> dict:
    """Device time of one training microstep by part (CUDA events): the
    filter MLPs building the four kernel tensors G, the four contraction
    forwards, the rest of the forward, the backward, the Adam update; and
    of the backward, the four contractions' own (einsum) backward with
    the device memory it takes beyond its inputs."""
    from repro_torch.kernels.quadconv import ops as qops
    from repro_torch.ml import autoencoder as ae
    from repro_torch.ml import trainer as tr
    from repro_torch.ml.quadconv import QuadConv
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_map
    blocks = []
    for b in range(cfg.blocks):
        blocks.append((cfg.channels if b == 0 else cfg.internal,
                       params["enc"][b], levels[b]))
    for b in range(cfg.blocks):
        blocks.append((cfg.internal, params["dec"][b],
                       levels[cfg.blocks - b - 1]))
    convs = [(QuadConv(c_in=c, c_out=cfg.internal, mlp_width=cfg.mlp_width,
                       mlp_depth=cfg.mlp_depth, support=cfg.support), p, lv)
             for c, p, lv in blocks]
    t_g = time_ms(lambda: [conv.kernel_tensor(p, lv, lv)
                           for conv, p, lv in convs], 3, warmup=1)
    gs = [conv.kernel_tensor(p, lv, lv).requires_grad_(True)
          for conv, p, lv in convs]
    fs = [torch.randn((batch.shape[0], lv.shape[0], conv.c_in),
                      device=batch.device, requires_grad=True)
          for conv, _, lv in convs]
    ws = [p["quad_w"].detach().requires_grad_(True) for _, p, _ in convs]
    t_c = time_ms(lambda: [qops.quadconv_contract(f, w, g)
                           for f, w, g in zip(fs, ws, gs)], 5)
    # the contraction's backward alone: the reference's einsums
    outs = [qops.quadconv_contract(f, w, g) for f, w, g in zip(fs, ws, gs)]
    cts = [torch.randn_like(o) for o in outs]

    def contraction_backward():
        for o, ct, f, w, g in zip(outs, cts, fs, ws, gs):
            torch.autograd.grad(o, (f, w, g), ct, retain_graph=True)

    t_cb = time_ms(contraction_backward, 3, warmup=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    contraction_backward()
    torch.cuda.synchronize()
    cb_extra = (torch.cuda.max_memory_allocated() - base) / 1e9
    del gs, fs, ws, outs, cts

    def forward():
        tracked = tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
        with torch.enable_grad():
            return ae.loss_fn(tracked, cfg, levels, batch)

    def step():
        return tr.value_and_grad(
            lambda p: ae.loss_fn(p, cfg, levels, batch), params)

    t_f = time_ms(forward, 3, warmup=1)
    t_vg = time_ms(step, 3, warmup=1)
    _, grads = step()
    tx = opt.adam(1e-3)
    st = tx.init(params)
    t_o = time_ms(lambda: opt.apply_updates(
        params, tx.update(grads, st, params)[0]), 10)
    return {"total_ms": t_vg + t_o, "g_build_ms": t_g,
            "contraction_fwd_ms": t_c, "rest_fwd_ms": t_f - t_g - t_c,
            "backward_ms": t_vg - t_f, "optimizer_ms": t_o,
            "of_which_contraction_bwd_ms": t_cb,
            "contraction_bwd_extra_gb": cb_extra}


def train_session(dev, cfg, fcfg, sequential: bool, counters,
                  label: str | None = None, mesh=None,
                  slab_sharded: bool = False, faults=None,
                  deployment=None, hlo: bool = False, ddp: str = "psum",
                  ddp_error_feedback: bool = True) -> dict:
    """The paper's workflow as one session: flat-plate producer → fused
    trainer (over ``mesh`` if given, its gradients summed by ``ddp``) →
    in-situ inference, checked end to end; under ``faults`` (a
    ``FaultPlan``) every component's dispatches, retries and restarts and
    the server's fault counters are held to the plan's predictions.
    ``deployment`` places the store (default local); ``hlo`` plans with
    ``plan(hlo=True)``."""
    from repro_torch.core import TableSpec
    from repro_torch.core import store as S
    from repro_torch.insitu import (InferenceConsumer, InSituSession,
                                    Producer, TrainerConsumer)
    from repro_torch.ml import autoencoder as ae
    from repro_torch.ml import trainer as tr
    from repro_torch.sim import flatplate as fp
    gen = torch.Generator().manual_seed(SEED)
    modes = fp.draw_modes(fcfg, gen, dev)
    inf_modes = fp.draw_modes(fcfg, gen, dev)
    coords = fp.grid_coords(fcfg, dev)
    tcfg = tr.TrainerConfig(ae=cfg, epochs=EPOCHS, gather=GATHER,
                            batch_size=BATCH, lr=1e-3, seed=SEED, mesh=mesh,
                            slab_sharded=slab_sharded, ddp=ddp,
                            ddp_error_feedback=ddp_error_feedback)
    draws = tr.default_draws(tcfg, dev)
    starts, ends, history, inputs = [], [], [], {}

    def timed_epochs():
        for d in draws.epochs:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
            yield d

    def on_epoch(r):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        history.append(r)

    def step_fn(carry, rank, t):
        return carry, S.make_key(rank, t), fp.snapshot(fcfg, modes, t,
                                                       coords)

    def feed(client, step):
        mu, sd = client.get_metadata("norm_stats")
        x = (fp.snapshot(fcfg, inf_modes, SIM_STEPS + step, coords).T
             - mu) / sd
        inputs[step] = x
        return x

    sess = InSituSession(
        tables=[TableSpec("field", shape=(4, fcfg.n_points),
                          capacity=RING)],
        components=[
            Producer(step_fn, table="field", steps=SIM_STEPS,
                     carry=torch.zeros((), device=dev),
                     emit_every=EMIT_EVERY),
            TrainerConsumer(tcfg, coords, model_key="encoder",
                            on_epoch=on_epoch,
                            draws=tr.TrainDraws(draws.bootstrap,
                                                timed_epochs())),
            InferenceConsumer("encoder", feed, steps=N_INF)],
        faults=faults, deployment=deployment, device=dev)
    plan = sess.plan(hlo=hlo)
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sess.run(plan=plan, sequential=sequential, max_wall_s=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in counters}
    peak = torch.cuda.max_memory_allocated() / 1e9
    mode = label or ("sequential" if sequential else "threaded")
    if not res.ok:
        raise AssertionError({n: c.error for n, c in
                              res.run.components.items() if c.error})
    stats = res.server.stats()
    for r, a, b in zip(history, starts, ends):
        print(f"[train {mode}] epoch {r.epoch} train_loss={r.train_loss:.6f} "
              f"val_loss={r.val_loss:.6f} rel_frobenius="
              f"{r.val_rel_error:.6f} ms={a.elapsed_time(b):.3f} "
              f"watermark={r.watermark}", flush=True)
    losses = [x for r in history
              for x in (r.train_loss, r.val_loss, r.val_rel_error)]
    if len(history) != EPOCHS or not all(map(math.isfinite, losses)) \
            or not history[-1].train_loss < history[0].train_loss:
        raise AssertionError(f"{mode}: losses not finite and falling: "
                             f"{history}")
    if stats["op_count"] != plan.store_dispatches \
            or stats["staged_transfers"] != plan.staged_transfers:
        raise AssertionError(f"{mode}: plan {plan.explain()} != stats "
                             f"{stats}")
    if faults is not None:
        check_fault_predictions(mode, plan, res)
    microsteps = EPOCHS * -(-(GATHER - 1) // BATCH)
    ranks = 1 if mesh is None else mesh.size
    need = {"sample_slots": EPOCHS + 1,
            "gather_rows_sharded" if slab_sharded else "gather_rows":
            EPOCHS + 1, "quadconv_contract": 4 * microsteps * ranks}
    for sym, least in need.items():
        if launches[sym] < least:
            raise AssertionError(f"{mode}: {sym} launched {launches[sym]} "
                                 f"times, expected >= {least}")
    trainer = res.output("trainer")
    inf = res.output("inference")
    ref_cfg = replace(cfg, mode="ref")
    err, zmax = 0.0, 0.0
    for step, z in enumerate(inf.outputs):
        want = ae.encode(trainer.state.params, ref_cfg, trainer.levels,
                         inputs[step][None])[0]
        if z.shape != (cfg.latent,) or not bool(torch.isfinite(z).all()):
            raise AssertionError(f"inference output {step}: {z.shape}")
        err = max(err, float((z - want).abs().max()))
        zmax = max(zmax, float(want.abs().max()))
    tol = 1e-4 * (1.0 + zmax)
    if inf.steps != N_INF or not err <= tol:
        raise AssertionError(f"{mode}: {inf.steps} inference outputs, max "
                             f"err vs plain encoder {err} > {tol}")
    walls = {n: round(c.wall_s, 4) for n, c in res.run.components.items()}
    verbs = {n: round(t["mean_s"] * 1e3, 3)
             for n, t in res.run.timers.summary().items()}
    print(f"[train {mode}] predicted_dispatches={plan.store_dispatches} "
          f"op_count={stats['op_count']} "
          f"per_component={ {c.name: c.store_dispatches for c in plan.components} } "
          f"launches={launches} peak_mem_gb={peak:.2f} wall_s={wall:.4f} "
          f"component_wall_s={walls} verb_mean_ms={verbs} "
          f"inference_max_err_vs_plain={err:.3g} (tol {tol:.3g})",
          flush=True)
    return {"launches": launches, "peak_gb": peak, "wall_s": wall,
            "op_count": stats["op_count"], "state": trainer.state,
            "history": history, "tier": plan.component("trainer").tier,
            "cfg": tcfg, "table": res.server.checkout("field"),
            "spec": res.server.spec("field"), "levels": trainer.levels,
            "norm_stats": trainer.norm_stats,
            "trainer_ops": plan.component("trainer").store_dispatches,
            "epoch_ms": [a.elapsed_time(b) for a, b in zip(starts, ends)],
            "plan": plan, "stats": stats, "server": res.server,
            "staged_delta": {e.name: res.staged_delta(e.name)
                             for e in plan.components}}


def check_fault_predictions(mode: str, plan, res) -> None:
    """Every component's store ops, retries and restarts, and the
    server's op count and fault counters, equal to the plan's."""
    stats = res.server.stats()
    for entry in plan.components:
        comp = res.run.components[entry.name]
        got = (res.op_delta(entry.name), comp.retries, comp.restarts)
        want = (entry.store_dispatches, entry.retries, entry.restarts)
        if got != want:
            raise AssertionError(f"{mode}: {entry.name} ran (ops, retries, "
                                 f"restarts) {got}, planned {want}")
    if stats["op_count"] != plan.store_dispatches or any(
            stats[k] != v for k, v in plan.faults):
        raise AssertionError(f"{mode}: stats {stats} != plan "
                             f"{plan.store_dispatches} ops, {plan.faults}")


def equal_tables(a, b) -> bool:
    """Two ``TableState``s bit for bit (each shard of a sharded slab, the
    slabs' placements equal)."""
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    return len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))


def chaos_train_phase(dev, cfg, fcfg, counters) -> dict:
    """Phase 8's session three ways: disarmed, under an empty armed
    ``FaultPlan`` and under a plan of every fault kind (a capture window,
    a dropped and a duplicated chunk, producer and trainer crashes, a
    snapshot then a store restart).  The faulted run's table and trained
    state must equal the armed run's bit for bit, its predictions hold
    exactly (``train_session``), and its sample, gather and QuadConv
    launches equal the armed run's.  Then the restart's replay and a
    snapshot are timed on the faulted run's server, and, as a control
    that must fail, a replay with the log's tail cut by one entry must
    leave a different table."""
    from repro_torch.core import store as S
    from repro_torch.core.faults import FaultEvent, FaultPlan, RetryPolicy
    from repro_torch.train.checkpoint import MemoryCheckpoint
    from repro_torch.tree import tree_leaves
    retry = RetryPolicy(interval=1e-4, max_interval=1e-3)
    events = (FaultEvent("unavailable", verb="capture", at=1, count=2),
              FaultEvent("drop_chunk", table="field", at=0),
              FaultEvent("dup_chunk", table="field", at=2),
              FaultEvent("crash", component="producer", at=2),
              FaultEvent("crash", component="trainer", at=3),
              FaultEvent("snapshot", table="field", at=1),
              FaultEvent("restart", table="field", at=3))
    runs = {}
    for label, plan in (("disarmed", None),
                        ("armed", FaultPlan(retry=retry)),
                        ("faulted", FaultPlan(events=events, retry=retry))):
        runs[label] = train_session(dev, cfg, fcfg, True, counters,
                                    label=f"chaos {label}", faults=plan)
    armed, faulted = runs["armed"], runs["faulted"]
    if not equal_tables(armed["table"], faulted["table"]) \
            or not equal_tables(armed["table"], runs["disarmed"]["table"]):
        raise AssertionError("chaos: the faulted (or disarmed) table "
                             "differs from the armed run's")
    if not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(armed["state"]), tree_leaves(faulted["state"]))):
        raise AssertionError("chaos: the faulted run's trained state "
                             "differs from the armed run's")
    watched = ("sample_slots", "gather_rows", "quadconv_contract")
    if any(faulted["launches"][k] != armed["launches"][k] for k in watched):
        raise AssertionError(f"chaos: launches {faulted['launches']} under "
                             f"faults, {armed['launches']} armed")
    plan, stats = faulted["plan"], faulted["stats"]
    restarts = {c.name: c.restarts for c in plan.components}
    replays = sum(dict(c.dispatches).get("replay", 0)
                  for c in plan.components)
    if restarts["producer"] != 1 or restarts["trainer"] != 1 \
            or stats["recoveries"] != 1 or replays != 2:
        raise AssertionError(f"chaos: restarts {restarts}, replays "
                             f"{replays}, stats {stats}")
    # the recovery path timed on the faulted run's server: a restart
    # (copy of the image + the log's tail) and a snapshot of every table
    srv = faulted["server"]
    want = S.copy_state(srv.checkout("field"))
    tail = len(srv._wal["field"]) - srv._wal_base["field"]
    mem = MemoryCheckpoint(srv, key="timed")
    restart_ms, snapshot_ms, image_ms, memckpt_ms = [], [], [], []
    for _ in range(5):
        for times, work in (
                (restart_ms, srv._restart_and_recover),
                (snapshot_ms, srv.snapshot),
                (image_ms, lambda: S.copy_state(srv._recovery["field"])),
                (memckpt_ms, lambda: mem.save(0, {"state": armed["state"]}))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            work()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    if not equal_tables(want, srv.checkout("field")):
        raise AssertionError("chaos: a full replay changed the table")
    srv._wal["field"].pop()                    # the control: cut by one
    srv._restart_and_recover()
    if equal_tables(want, srv.checkout("field")):
        raise AssertionError("chaos control: a replay missing the log's "
                             "last entry left the same table")
    table_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(tuple(want)))
    line = {
        label: {"epoch_ms": run["epoch_ms"], "wall_s": run["wall_s"],
                "launches": run["launches"], "op_count": run["op_count"]}
        for label, run in runs.items()}
    line["faulted"].update(
        retries=stats["retries"], faults_injected=stats["faults_injected"],
        recoveries=stats["recoveries"], restarts=restarts,
        replayed_entries=replays)
    line["recovery"] = {
        "restart_ms": restart_ms, "replayed_entries": tail,
        "image_copy_ms": image_ms, "snapshot_ms": snapshot_ms,
        "memckpt_save_ms": memckpt_ms, "state_bytes": sum(
            t.numel() * t.element_size()
            for t in tree_leaves(armed["state"])),
        "table_bytes": table_bytes,
        "snapshot_bound_ms": 2 * table_bytes / PEAK_BYTES_PER_S * 1e3,
        "wal_cut_control": "differs"}
    return line


def collectives_phase(dev, cfg, fcfg) -> dict:
    """``plan(hlo=True)`` on a ``SHARDS``-rank mesh on this card: each
    trainer tier's collective calls over one epoch on a throwaway table
    placed like the live one, held to the plan's predictions
    (``check_collectives``) — ``fused`` none, ``sharded_fused`` an
    all-reduce on a whole table and an all-reduce and an all-gather on a
    split one, ``slab_sharded`` an all-reduce and no all-gather; and, as a
    control that must raise, ``slab_sharded``'s prediction against
    ``sharded_fused``'s counts on the split table."""
    import dataclasses
    from repro_torch.core import TableSpec
    from repro_torch.core import store as S
    from repro_torch.insitu import InSituSession, Producer, TrainerConsumer
    from repro_torch.ml import trainer as tr
    from repro_torch.parallel.sharding import data_mesh
    from repro_torch.sim import flatplate as fp
    mesh = data_mesh(SHARDS, devices=[dev] * SHARDS)
    coords = fp.grid_coords(fcfg, dev)
    sessions = {"replicated": (("sharded_fused", True, False),
                               ("fused", False, False)),
                "sharded": (("slab_sharded", True, True),
                            ("sharded_fused", True, False))}
    out = {}
    t0 = time.perf_counter()
    for name, trainers in sessions.items():
        comps = [Producer(lambda c, r, t: (c, S.make_key(r, t), torch.zeros(
            (4, fcfg.n_points), device=dev)), table="field", steps=4,
            carry=torch.zeros((), device=dev))]
        for tier, on_mesh, slab in trainers:
            comps.append(TrainerConsumer(tr.TrainerConfig(
                ae=cfg, epochs=1, gather=GATHER, batch_size=BATCH,
                mesh=mesh if on_mesh else None, slab_sharded=slab),
                coords, tier=tier, name=tier))
        plan = InSituSession(tables=[TableSpec(
            "field", shape=(4, fcfg.n_points), capacity=RING)],
            components=comps, device=dev).plan(hlo=True)
        for c in plan.components:
            if c.kind == "trainer":
                c.check_collectives()
                out[f"{name}/{c.tier}"] = {
                    "measured": {k: v for k, v in c.collectives if v},
                    "predicted": c.explain().get("predicted_collectives")}
        if name == "sharded":
            wrong = dataclasses.replace(
                plan.component("slab_sharded"),
                collectives=plan.component("sharded_fused").collectives)
            try:
                wrong.check_collectives()
            except AssertionError:
                pass
            else:
                raise AssertionError("collectives control: slab_sharded's "
                                     "prediction passed sharded_fused's "
                                     "counts")
    torch.cuda.synchronize()
    out["control"] = "raised"
    out["seconds"] = time.perf_counter() - t0
    return out


def checkpoint_phase(dev) -> dict:
    """(a) ``MemoryCheckpoint`` on the card: a saved train state survives
    an in-place update of the live one; (b) the training launcher at the
    Phi-4-mini smoke config with ``attn_impl="flash"``: 4 steps saving
    every 2 under a temporary directory, then, from step 2 (the step-4
    checkpoint removed), ``resume`` must give steps 3–4 bit for bit, and
    the flash kernels must have launched in the resumed run."""
    import shutil
    import tempfile
    from repro_torch.core import StoreServer
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import tree_leaves
    srv = StoreServer(device=dev)
    mem = ckpt.MemoryCheckpoint(srv, key="trainer")
    live = {"w": torch.randn(1 << 20, device=dev,
                             generator=torch.Generator(dev).manual_seed(SEED)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
    want = live["w"].clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mem.save(0, live)
    torch.cuda.synchronize()
    mem_ms = (time.perf_counter() - t0) * 1e3
    live["w"].mul_(2.0)
    step, got = mem.restore()
    if step != 0 or not torch.equal(got["w"], want) \
            or srv.stats()["op_count"]:
        raise AssertionError("MemoryCheckpoint on the card")
    kernels = (aops.FLASH, aops.FLASH_BWD_DQ, aops.FLASH_BWD_DKV)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        kw = dict(arch="phi4_mini_3_8b", steps=4, batch=2, seq_len=128,
                  smoke=True, device=dev, attn_impl="flash", log_every=100,
                  ckpt_every=2, ckpt_dir=str(root))
        t0 = time.perf_counter()
        full = launcher.run(**kw)
        full_s = time.perf_counter() - t0
        shutil.rmtree(root / "step_0000000004")
        for k in kernels:
            k.launches = 0
        resumed = launcher.run(resume=True, **kw)
        launches = {k.symbol: k.launches for k in kernels}
        t0 = time.perf_counter()
        ckpt.save(root / "timed", 4, resumed.state)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ckpt.restore(root / "timed", resumed.state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = resumed.start == 2 and resumed.losses == full.losses[2:] \
        and resumed.grad_norms == full.grad_norms[2:] and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(full.state),
                                              tree_leaves(resumed.state)))
    if not same or min(launches.values()) < 1:
        raise AssertionError(f"resume from step 2: losses {resumed.losses} "
                             f"vs {full.losses[2:]}, launches {launches}")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(full.state))
    return {"memckpt_save_ms": mem_ms, "memckpt_bytes": 4 << 20,
            "resume_bit_identical": True, "losses": full.losses,
            "resumed_losses": resumed.losses, "resumed_launches": launches,
            "smoke_state_bytes": state_bytes, "save_ms": save_ms,
            "restore_ms": restore_ms, "uninterrupted_run_s": full_s}


def spectral_bytes(n: int) -> tuple[int, int]:
    """Bytes one RK4 ``step`` and one ``snapshot`` of the spectral solver
    must move at ``n³``: each FFT's input read once and output written
    once, and each elementwise pass between them reading its inputs once
    and writing its output once (R: one real fp32 field, C: one complex64
    half-spectrum field).  One right-hand side: irfft û (3C → 3R), the
    curl (3C → 3C), irfft ω̂ (3C → 3R), u × ω (6R → 3R), rfft (3R → 3C),
    dealias + projection + viscous + forcing (6C → 3C): 24C + 18R.  A
    step: four of them, three stage inputs (6C → 3C each), the RK4 sum
    (15C → 3C) and the final projection (3C → 3C).  A snapshot: irfft û
    (3C → 3R), nine products uᵢuⱼ (2R → R each), nine rffts (R → C each),
    the sum of kᵢkⱼ ûᵢⱼ (9C → C), the Poisson solve (C → C), irfft p̂
    (C → R) and the [4, n³] stack (4R → 4R)."""
    r = 4 * n ** 3
    c = 8 * n * n * (n // 2 + 1)
    rhs = 24 * c + 18 * r
    step = 4 * rhs + 3 * 9 * c + 18 * c + 6 * c
    snap = (3 * c + 3 * r) + 27 * r + 9 * (r + c) + 10 * c + 2 * c \
        + (c + r) + 8 * r
    return step, snap


def unprojected_step(sp, cfg, state):
    """``spectral.step`` without its final Leray projection: the control
    the divergence limit must catch."""
    h = cfg.dt
    u0 = state.uhat
    k1 = sp._rhs(cfg, u0)
    k2 = sp._rhs(cfg, u0 + 0.5 * h * k1)
    k3 = sp._rhs(cfg, u0 + 0.5 * h * k2)
    k4 = sp._rhs(cfg, u0 + h * k3)
    return sp.NSState(u0 + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4),
                      state.t + h, state.step + 1)


def spectral_phase(dev) -> dict:
    """The pseudo-spectral solver alone on the card: (a) a forced box at
    ``SPECTRAL_N³`` from ``random_turbulence`` (noise from a seeded
    generator on the card), ``step`` and ``snapshot`` timed by CUDA events
    beside their bytes bound, the peak memory and ``max_divergence``; (b)
    the 2-D Taylor-Green vortex at the same grid decaying as
    E₀·e^{-4νt} within ``TG_RTOL``, and, as a control that must fail, the
    same steps with the viscosity dropped; (c) the 3-D Taylor-Green
    vortex's divergence after 10 steps at the same grid within the
    reference test's ``DIV_LIMIT``, and, as a control that must fail, the
    steps without their final projection (the reference test's own 16³
    case is read beside it); (d) one step and a
    snapshot on the card against the CPU's at ``CARD_CPU_N³`` within
    ``CARD_CPU_RTOL``, and, as a control that must fail, the card's step
    with the forcing off."""
    from repro_torch.sim import spectral as sp

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    # (a) the DNS grid
    cfg = sp.NSConfig(n=SPECTRAL_N, nu=SPECTRAL_NU, dt=SPECTRAL_DT,
                      forcing=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = sp.random_turbulence(cfg, sp.draw_noise(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev))
    e0 = float(sp.energy(cfg, state))
    state = sp.step(cfg, state)                 # warm-up: cuFFT plans
    snap = sp.snapshot(cfg, state)
    del snap
    start, end = events()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(SPECTRAL_STEPS):
        state = sp.step(cfg, state)
    end.record()
    torch.cuda.synchronize()
    step_wall_ms = (time.perf_counter() - t0) * 1e3 / SPECTRAL_STEPS
    step_ms = start.elapsed_time(end) / SPECTRAL_STEPS
    start, end = events()
    start.record()
    for _ in range(3):
        snap = sp.snapshot(cfg, state)
    end.record()
    torch.cuda.synchronize()
    snap_ms = start.elapsed_time(end) / 3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    e1 = float(sp.energy(cfg, state))
    div = float(sp.max_divergence(cfg, state))
    if snap.shape != (4, cfg.n_points) or not bool(
            torch.isfinite(snap).all()) or not (math.isfinite(e1) and e1 > 0):
        raise AssertionError(f"spectral {cfg.n}^3: snapshot {snap.shape}, "
                             f"energy {e0} -> {e1}")
    del snap
    step_profile = profile(lambda: sp.step(cfg, state), top=8)
    del state
    torch.cuda.empty_cache()
    step_bytes, snap_bytes = spectral_bytes(cfg.n)
    step_bound, _ = bound(step_bytes)
    snap_bound, _ = bound(snap_bytes)

    # (b) the exact 2-D Taylor-Green decay, and a viscosity-free control
    tg = replace(cfg, nu=TG_NU, forcing=False)

    def tg_error(step_cfg) -> float:
        st = sp.taylor_green_2d(tg, device=dev)
        first = float(sp.energy(tg, st))
        for _ in range(TG_STEPS):
            st = sp.step(step_cfg, st)
        want = first * math.exp(-4 * tg.nu * float(st.t))
        return abs(float(sp.energy(tg, st)) - want) / want

    tg_err, tg_control = tg_error(tg), tg_error(replace(tg, nu=0.0))
    torch.cuda.empty_cache()

    # (c) the reference test's divergence check at the DNS grid, and an
    # unprojected control; the reference's own 16^3 case read beside it
    def divergence(dcfg, step_fn) -> float:
        st = sp.taylor_green(dcfg, device=dev)
        for _ in range(10):
            st = step_fn(dcfg, st)
        return float(sp.max_divergence(dcfg, st))

    dcfg = replace(cfg, forcing=False)
    div_tg = divergence(dcfg, sp.step)
    div_control = divergence(dcfg,
                             lambda c, st: unprojected_step(sp, c, st))
    div_16 = divergence(sp.NSConfig(**DIV_REFERENCE_CASE), sp.step)
    torch.cuda.empty_cache()

    # (d) the card's step against the CPU's, and a forcing-off control
    ccfg = sp.NSConfig(n=CARD_CPU_N, nu=0.02, dt=0.01, forcing=True)
    noise = sp.draw_noise(ccfg, torch.Generator().manual_seed(SEED), "cpu")
    cpu0 = sp.random_turbulence(ccfg, noise)
    card0 = sp.random_turbulence(ccfg, noise.to(dev))
    cpu1, card1 = sp.step(ccfg, cpu0), sp.step(ccfg, card0)
    scale = float(cpu1.uhat.abs().max())
    card_err = float((card1.uhat.cpu() - cpu1.uhat).abs().max()) / scale
    snap_cpu = sp.snapshot(ccfg, cpu1)
    snap_err = float((sp.snapshot(ccfg, card1).cpu() - snap_cpu).abs().max()
                     ) / float(snap_cpu.abs().max())
    unforced = sp.step(replace(ccfg, forcing=False), card0)
    card_control = float((unforced.uhat.cpu() - cpu1.uhat).abs().max()) \
        / scale

    line = {"n": cfg.n, "nu": cfg.nu, "dt": cfg.dt, "forcing": cfg.forcing,
            "nu_k2max_dt": cfg.nu * 3 * (cfg.n // 2) ** 2 * cfg.dt,
            "step_ms": step_ms, "step_wall_ms": step_wall_ms,
            "step_bound_ms": step_bound, "step_bytes": step_bytes,
            "step_share_of_bound": step_bound / step_ms,
            "snapshot_ms": snap_ms, "snapshot_bound_ms": snap_bound,
            "snapshot_bytes": snap_bytes,
            "snapshot_share_of_bound": snap_bound / snap_ms,
            "bound_by": "bytes", "peak_mem_gb": peak_gb,
            "energy_start": e0, "energy_after": e1,
            "steps_run": SPECTRAL_STEPS + 1, "max_divergence": div,
            "step_profile": step_profile,
            "tg2d": {"nu": tg.nu, "steps": TG_STEPS, "rel_err": tg_err,
                     "limit": TG_RTOL, "control_nu0_rel_err": tg_control},
            "divergence": {"start": "taylor_green", "n": dcfg.n,
                           "steps": 10, "max_divergence": div_tg,
                           "limit": DIV_LIMIT,
                           "control_unprojected": div_control,
                           "reference_case": DIV_REFERENCE_CASE,
                           "reference_case_max_divergence": div_16},
            "card_vs_cpu": {"n": ccfg.n, "step_rel_err": card_err,
                            "snapshot_rel_err": snap_err,
                            "limit": CARD_CPU_RTOL,
                            "control_unforced_rel_err": card_control}}
    if not (tg_err <= TG_RTOL < tg_control):
        raise AssertionError(f"Taylor-Green decay: {line['tg2d']}")
    if not (div_tg < DIV_LIMIT <= div_control):
        raise AssertionError(f"divergence: {line['divergence']}")
    if not (max(card_err, snap_err) <= CARD_CPU_RTOL < card_control):
        raise AssertionError(f"card vs CPU: {line['card_vs_cpu']}")
    return line


def insitu_spectral_phase(dev, counters, want: dict) -> dict:
    """``launch.insitu.run(producer="spectral", points="medium",
    epochs=EPOCHS, sim_steps=SIM_STEPS)`` on the card: the plan's
    dispatches equal ``stats()``, the sample, gather and QuadConv launches
    equal phase 8's session's (``want``: the same trainer and inference
    schedule), the losses are finite; the overhead table's means."""
    from repro_torch.launch import insitu as launcher
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = launcher.run(producer="spectral", points="medium", epochs=EPOCHS,
                       sim_steps=SIM_STEPS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in counters}
    stats = res.server.stats()
    history = res.output("trainer").history
    losses = [x for r in history
              for x in (r.train_loss, r.val_loss, r.val_rel_error)]
    paths = ("sample_slots", "gather_rows", "quadconv_contract")
    if stats["op_count"] != res.plan.store_dispatches:
        raise AssertionError(f"spectral session: plan {res.plan.explain()}"
                             f" != stats {stats}")
    if any(launches[s] != want[s] for s in paths):
        raise AssertionError(f"spectral session launches {launches}, "
                             f"phase 8's {want}")
    if len(history) != EPOCHS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"spectral session losses {history}")
    timers = res.timers
    return {"producer": "spectral", "points": "medium", "epochs": EPOCHS,
            "sim_steps": SIM_STEPS, "wall_s": wall,
            "predicted_dispatches": res.plan.store_dispatches,
            "op_count": stats["op_count"], "launches": launches,
            "train_loss": [r.train_loss for r in history],
            "val_loss": [r.val_loss for r in history],
            "mean_ms": {k: (timers.mean(k) or 0.0) * 1e3 for k in
                        ("equation_solution", "send", "retrieve")},
            "count": {k: timers.summary()[k]["count"] for k in
                      ("equation_solution", "send", "retrieve")}}


_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers of its width (floats compared bit for
    bit: -0.0 and NaN payloads included)."""
    return t.view(_INT_OF_WIDTH[t.element_size()]) \
        if t.dtype.is_floating_point else t


def file_bits(path: Path) -> torch.Tensor:
    import numpy as np
    arr = np.load(path)
    if arr.dtype.kind not in "iub":
        arr = arr.view(f"<i{arr.dtype.itemsize}")
    return torch.from_numpy(arr)


def checkpoint_full(dev, state, one_step, step_peak: int) -> dict:
    """A durable checkpoint of the full-width Phi-4-mini train state the
    training phase holds (no second state is built): one
    ``Checkpointer.maybe_save(force=True)`` into a temporary directory,
    timed (the call, which pins the host arena on a first save; the
    copies' landing; the write), then the staging alone once more on the
    pinned arena (CUDA events, beside its PCIe bound); the card's peak
    memory through both, within the largest leaf of where it started and
    of the training step's own peak; the files equal to the live state
    leaf by leaf, compared on the host; one more training step, after
    which (the control) the state must differ from the files; an in-place
    ``restore``, whose peak must stay level, and the restored leaves
    equal to the files bit for bit."""
    import shutil
    import tempfile
    from repro_torch.train import checkpoint as ckpt
    leaves = [(k, t) for k, t in ckpt._flatten_with_paths(state)
              if isinstance(t, torch.Tensor)]
    sizes = [t.numel() * t.element_size() for _, t in leaves]
    state_bytes, largest = sum(sizes), max(sizes)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_full_"))
    with open("/proc/meminfo") as f:
        mem_avail = int(next(x for x in f if x.startswith("MemAvailable"))
                        .split()[1]) * 1024
    free_disk = shutil.disk_usage(root).free
    if free_disk < 1.05 * state_bytes or mem_avail < 1.2 * state_bytes:
        shutil.rmtree(root, ignore_errors=True)
        raise AssertionError(f"checkpoint full: {state_bytes} B of state, "
                             f"{free_disk} B of disk, {mem_avail} B of host "
                             f"memory free")
    try:
        ck = ckpt.Checkpointer(root, interval_steps=0, keep=1)
        step = int(state.step)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        ck.maybe_save(step, state, force=True)
        call_s = time.perf_counter() - t0
        ck._stage.wait()
        landed_s = time.perf_counter() - t0
        ck.wait()
        write_s = time.perf_counter() - t0 - call_s
        if ck.errors or ck.saves != 1:
            raise AssertionError(f"checkpoint full: {ck.errors}")
        # the staging alone, steady state: the arena pinned already
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        ck._stage.stage(state)
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        copy_ms = start.elapsed_time(end)
        save_peak = torch.cuda.max_memory_allocated()
        arena_bytes = ck._stage.nbytes
        ck.close()
        if not (save_peak - base <= largest
                and save_peak <= step_peak + largest):
            raise AssertionError(f"checkpoint full: peak {save_peak} from "
                                 f"{base} (step peak {step_peak}, largest "
                                 f"leaf {largest})")
        # the files against the live state, on the host
        path = root / f"step_{step:010d}"
        manifest = json.loads((path / "manifest.json").read_text())
        files = {m["key"]: path / m["file"] for m in manifest["leaves"]}
        t0 = time.perf_counter()
        for key, t in leaves:
            if not torch.equal(file_bits(files[key]), bits(t).cpu()):
                raise AssertionError(f"checkpoint full: leaf {key} differs "
                                     f"from the live state")
        verify_s = time.perf_counter() - t0
        # one more step: the state must now differ from the files
        one_step()
        torch.cuda.synchronize()
        probe = [next(k for k, _ in leaves if m in k.split("/"))
                 for m in ("mu", "nu")]
        live = dict(leaves)
        differ = [k for k in probe if not torch.equal(
            file_bits(files[k]).to(dev), bits(live[k]))]
        if differ != probe:
            raise AssertionError(f"checkpoint full control: {probe} should "
                                 f"differ from the files, {differ} do")
        # an in-place restore, then every leaf against its file
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        ckpt.restore(root, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restore_peak = torch.cuda.max_memory_allocated() - base
        for key, t in leaves:
            if not torch.equal(file_bits(files[key]).to(dev), bits(t)):
                raise AssertionError(f"checkpoint full: restored leaf {key} "
                                     f"differs from its file")
        if restore_peak > largest:
            raise AssertionError(f"restore raised the card's peak by "
                                 f"{restore_peak} B")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"state_bytes": state_bytes, "leaves": len(leaves),
            "largest_leaf_bytes": largest, "arena_bytes": arena_bytes,
            "first_save_call_s": call_s, "first_copies_landed_s": landed_s,
            "write_s": write_s, "write_gb_per_s": state_bytes / write_s / 1e9,
            "stage_enqueue_ms": enqueue_ms, "stage_copy_ms": copy_ms,
            "stage_bound_ms": state_bytes / PCIE_BYTES_PER_S * 1e3,
            "stage_gb_per_s": state_bytes / copy_ms / 1e6,
            "save_peak_gb": save_peak / 1e9,
            "save_peak_rise_bytes": save_peak - base,
            "step_peak_gb": step_peak / 1e9, "verify_host_s": verify_s,
            "control_differing_leaves": differ, "restore_s": restore_s,
            "restore_peak_rise_bytes": restore_peak,
            "restored_bit_identical": True, "free_disk_bytes": free_disk,
            "host_mem_available_bytes": mem_avail}


def check_flash(dev, B: int, S: int, H: int, K: int, dh: int, dtype,
                causal: bool = True, iters: int = 10,
                rerun: bool = False) -> dict:
    """The flash-attention forward against its plain version (output and
    log-sum-exp) and against ``scaled_dot_product_attention``, timed; the
    kernel the route rule picks (bf16: the tensor-core one, fp32: the FMA
    one) must be the one launched, and, as a control that must FAIL the
    same limits, the kernel without its causal mask; with ``rerun``, o
    and the LSE bit-identical on a second run."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).mul(0.5)
               .to(dtype) for shape in ((B, S, H, dh), (B, S, K, dh),
                                        (B, S, K, dh)))
    kern = ops.FLASH_TC if ops.tensor_core_route(dtype, dh) else ops.FLASH
    before = (ops.FLASH.launches, ops.FLASH_TC.launches)
    o, lse = ops.flash_attention(q, k, v, causal, return_lse=True)
    grown = (ops.FLASH.launches - before[0],
             ops.FLASH_TC.launches - before[1])
    if grown != ((0, 1) if kern is ops.FLASH_TC else (1, 0)):
        raise AssertionError(f"flash forward at {dtype} dh={dh} launched "
                             f"(FMA, tensor-core) {grown}, expected "
                             f"{kern.symbol}")
    identical = None
    if rerun:
        again = ops.flash_attention(q, k, v, causal, return_lse=True)
        identical = torch.equal(again[0], o) and torch.equal(again[1], lse)
        if not identical:
            raise AssertionError(f"flash forward differs between two runs "
                                 f"at {q.shape} {dtype}")
        del again
    o_r, lse_r = ref.flash_attention_ref(q, k, v, causal)
    err = float((o.float() - o_r.float()).abs().max())
    lse_err = float((lse - lse_r).abs().max())
    # fp32: sums in another order; bf16: one bf16 rounding of |o|
    tol = 2e-5 if dtype == torch.float32 else \
        2.0 ** -8 * float(o_r.float().abs().max())
    lse_tol = 2e-5 if dtype == torch.float32 else 1e-4
    if not (err <= tol and lse_err <= lse_tol):
        raise AssertionError(f"flash kernel disagrees at {q.shape} {dtype}: "
                             f"o {err} > {tol} or lse {lse_err} > {lse_tol}")
    o_c, lse_c = ops.flash_attention(q, k, v, not causal, return_lse=True)
    err_c = float((o_c.float() - o_r.float()).abs().max())
    lse_err_c = float((lse_c - lse_r).abs().max())
    if err_c <= tol or lse_err_c <= lse_tol:
        raise AssertionError(f"the flash mask-off control passed a limit at "
                             f"{q.shape} {dtype}: o {err_c}, lse {lse_err_c}")
    del o_r, lse_r, o_c, lse_c
    kernel = timed(lambda: ops.flash_attention(q, k, v, causal), iters)
    plain = timed(lambda: ref.flash_attention_ref(q, k, v, causal), 3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), iters)
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    flops = 4.0 * pairs * dh                     # q.k and p.v
    nbytes = (q.numel() * 2 + k.numel() * 2) * q.element_size() \
        + lse.numel() * 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    b, by = bound(nbytes, flops, peak)
    b32, _ = bound(nbytes, flops)
    return {"kernel": kern.symbol, "max_abs_err": err, "tol": tol,
            "lse_max_abs_err": lse_err, "lse_tol": lse_tol,
            "bit_identical_rerun": identical,
            "control_mask_off_max_abs_err": err_c,
            "control_mask_off_lse_max_abs_err": lse_err_c,
            **kernel,
            "plain_ms": plain["ms"],
            "plain_wall_ms": plain["wall_ms"], "library_ms": library["ms"],
            "library_wall_ms": library["wall_ms"], "bound_ms": b,
            "bound_by": by, "bound_ms_at_fp32_rate": b32,
            "shape": f"B={B} S=T={S} H={H} K={K} dh={dh} "
                     f"{str(dtype).split('.')[-1]} causal={causal}"}


def check_ssd(dev, BC: int, Q: int, H: int, P: int, N: int) -> dict:
    """The SSD intra-chunk kernel against its plain version, timed, and,
    as a control that must FAIL y's limit, the kernel given ``a`` with
    heads 0 and 1 swapped."""
    from repro_torch.kernels.ssd import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xdt = torch.randn((BC, Q, H, P), generator=gen, device=dev) * 0.5
    a = -torch.nn.functional.softplus(
        torch.randn((BC, Q, H), generator=gen, device=dev))
    b = torch.randn((BC, Q, N), generator=gen, device=dev) * 0.5
    c = torch.randn((BC, Q, N), generator=gen, device=dev) * 0.5
    got = ops.ssd_intra(xdt, a, b, c)
    want = ref.ssd_intra_ref(xdt, a, b, c)
    errs = {}
    for name, g, w, rel in zip(("y", "state", "cum"), got, want,
                               (1e-4, 1e-4, 3e-5)):
        err = float((g - w).abs().max())
        tol = rel * float(w.abs().max())
        if not (bool(torch.isfinite(g).all()) and err <= tol):
            raise AssertionError(f"ssd kernel disagrees on {name}: {err} > "
                                 f"{tol}")
        errs[name] = (err, tol)
    again = ops.ssd_intra(xdt, a, b, c)
    identical = all(torch.equal(x, z) for x, z in zip(got, again))
    if not identical:
        raise AssertionError("ssd_intra differs between two runs")
    swapped = a[:, :, [1, 0, *range(2, H)]].contiguous()
    control = float((ops.ssd_intra(xdt, swapped, b, c)[0] - want[0])
                    .abs().max())
    if control <= errs["y"][1]:
        raise AssertionError(f"the ssd head-swap control passed y's limit: "
                             f"{control}")
    del got, want, again
    kernel = timed(lambda: ops.ssd_intra(xdt, a, b, c), 10)
    split = device_ms(lambda: ops.ssd_intra(xdt, a, b, c), 10, {
        "scores": "ssd_scores_tc_kernel", "y": "ssd_y_tc_kernel",
        "state": "ssd_state_tc_kernel"})
    plain = timed(lambda: ref.ssd_intra_ref(xdt, a, b, c), 3)
    tri = Q * (Q + 1) // 2                       # pairs j <= i per chunk
    flops = 2.0 * BC * (tri * N + H * tri * P + H * Q * P * N)
    nbytes = 4 * (2 * xdt.numel() + 2 * a.numel() + b.numel() + c.numel()
                  + BC * H * P * N)
    # the route: every product as three bf16 products (hi and lo terms)
    bd, by = bound(nbytes, 3 * flops, PEAK_BF16_FLOPS)
    b32, by32 = bound(nbytes, flops)
    return {"max_abs_err": max(e for e, _ in errs.values()),
            "errors_and_tols": errs, "bit_identical_rerun": identical,
            "control_head_swap_y_max_abs_err": control,
            **kernel, "kernel_ms_by_kernel": split, "plain_ms": plain["ms"],
            "plain_wall_ms": plain["wall_ms"], "library_ms": None,
            "bound_ms": bd, "bound_by": by, "bound_ms_at_fp32_rate": b32,
            "bound_by_at_fp32_rate": by32,
            "shape": f"BC={BC} Q={Q} H={H} P={P} N={N} f32 (B=4, S=2048)",
            "notes": "bound_ms: the tensor-core route, each product as "
                     "three bf16 products at 989 TFLOP/s, or the bytes; "
                     "bound_ms_at_fp32_rate: the products at 67 TFLOP/s"}


def rel_frobenius(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


def layer_check(params, cfg_k, cfg_p, prompt, patches=None) -> list[float]:
    """Each layer's mixer output (attention or SSD, after its output
    projection) through the kernel path and the plain path on the same
    input — the plain path's hidden state — as relative Frobenius
    differences, layer by layer."""
    from repro_torch.models import layers, lm
    from repro_torch.models import ssd as ssd_mod
    diffs = []
    x, positions = lm._embed(params, cfg_p, prompt, patches)
    for bp in lm._periods(params["blocks"], cfg_p.n_periods):
        for i, (mixer, ffn) in enumerate(cfg_p.pattern):
            h = layers.apply_norm(bp[i]["norm1"], x, cfg_p.norm)
            if mixer == "attn":
                outs = [layers.attention(bp[i]["attn"], c, h, positions)
                        for c in (cfg_k, cfg_p)]
            else:
                outs = [ssd_mod.ssd_apply(bp[i]["mamba"], c, h)
                        for c in (cfg_k, cfg_p)]
            diffs.append(rel_frobenius(*outs))
            x = lm._apply_block(cfg_p, mixer, ffn, bp[i], x, positions)[0]
    return diffs


def greedy_with_prefix(params, cfg, prompt, patches, max_new: int):
    """Greedy generation through the serving steps a vision config takes
    (``launch.steps.make_prefill_step`` with ``batch["patches"]`` as the
    prefix, then ``make_decode_step`` from ``next_pos``): [B, max_new]
    ids."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    t_max = patches.shape[1] + prompt.shape[1] + max_new
    with torch.no_grad():
        logits, caches, pos = make_prefill_step(cfg, t_max)(
            params, {"tokens": prompt, "patches": patches})
        decode = make_decode_step(cfg)
        out = []
        token = logits.argmax(-1)[:, None]
        for i in range(max_new):
            out.append(token)
            logits, caches = decode(params, caches, token, pos + i)
            token = logits.argmax(-1)[:, None]
    return torch.cat(out, dim=1)


def lm_phase(dev, arch: str, kernel_impl: dict, plain_impl: dict, kernel,
             expect: int, control: bool = False, absent: tuple = (),
             n_layers: int | None = None, after=None,
             limit: float = LM_LIMIT) -> dict:
    """Greedy generation at the config's full width (depth cut to
    ``n_layers`` when given) through the kernel path (``kernel`` launched
    exactly ``expect`` times, each of ``absent`` never); its prefill
    against the plain path's, layer by layer and at the last-position
    logits (and, with ``control``, a causal-mask-off attention that must
    fail both limits); where a prefill's and a decode step's device time
    goes.  A vision config puts ``frontend_tokens`` random patch
    embeddings in front of the prompt and generates through the serving
    steps (``greedy_with_prefix``).  ``after(params, cfg, cfg_p, prompt)``
    runs on the same weights before they are freed; its result is
    ``out["after"]``.  ``limit`` is the logits' limit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import model_specs
    from repro_torch.models import layers, lm
    from repro_torch.parallel.sharding import init_params
    from repro_torch.serve.decode import greedy_generate
    base = get_config(arch)
    full_layers = base.n_layers
    if n_layers is not None:
        base = replace(base, n_layers=n_layers)
    cfg, cfg_p = replace(base, **kernel_impl), replace(base, **plain_impl)
    params = init_params(model_specs(cfg),
                         torch.Generator(device=dev).manual_seed(SEED),
                         cfg.dtype, dev)
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(SEED))
    prompt = prompt.to(dev)
    patches = None
    if cfg.frontend == "vision":
        patches = torch.randn(
            (LM_BATCH, cfg.frontend_tokens, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + 1)) \
            .mul(0.02).to(cfg.dtype)
    prefix = 0 if patches is None else patches.shape[1]
    with torch.no_grad():
        lm.prefill(params, cfg, prompt[:, :256], patches)  # cuBLAS warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in (kernel, *absent):
        kern.launches = 0
    t0 = time.perf_counter()
    if patches is None:
        ids = greedy_generate(params, cfg, prompt, NEW_TOKENS)
    else:
        ids = greedy_with_prefix(params, cfg, prompt, patches, NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != expect or any(kern.launches for kern in absent):
        raise AssertionError(f"{arch}: {kernel.symbol} launched {launches} "
                             f"times in one generation, expected "
                             f"{expect} (one prefill); "
                             f"{[(k.symbol, k.launches) for k in absent]}")
    if ids.shape != (LM_BATCH, NEW_TOKENS) or int(ids.min()) < 0 \
            or int(ids.max()) >= cfg.vocab:
        raise AssertionError(f"{arch}: generated ids {ids.shape}")
    with torch.no_grad():
        prefill_ms = time_ms(lambda: lm.prefill(params, cfg, prompt,
                                                patches), 2, warmup=0)
        logits_k, caches, pos = lm.prefill(
            params, cfg, prompt, patches,
            t_max=prefix + PROMPT + NEW_TOKENS)
        if pos != prefix + PROMPT:
            raise AssertionError(f"{arch}: next_pos {pos}, expected "
                                 f"{prefix + PROMPT}")
        token = logits_k.argmax(-1)[:, None]
        decode_ms = time_ms(lambda: lm.decode_step(params, cfg, caches,
                                                   token, pos), 8)
        prefill_profile = profile(lambda: lm.prefill(params, cfg, prompt,
                                                     patches), top=6)
        decode_profile = profile(lambda: [lm.decode_step(
            params, cfg, caches, token, pos) for _ in range(4)])
        del caches
        logits_p = lm.prefill(params, cfg_p, prompt, patches)[0]
        err = rel_frobenius(logits_k, logits_p)
        layer_errs = layer_check(params, cfg, cfg_p, prompt, patches)
        same_argmax = float((logits_k.argmax(-1) == logits_p.argmax(-1))
                            .float().mean())
        if not (bool(torch.isfinite(logits_k).all()) and err <= limit
                and max(layer_errs) <= LAYER_LIMIT):
            raise AssertionError(
                f"{arch}: kernel prefill differs from the plain path: "
                f"logits {err} (limit {limit}), worst layer "
                f"{max(layer_errs)} (limit {LAYER_LIMIT})")
        out = {"arch": arch, "impl": kernel_impl, "kernel": kernel.symbol,
               "launches": launches,
               "absent": {kern.symbol: kern.launches for kern in absent},
               "n_layers": cfg.n_layers, "full_n_layers": full_layers,
               "prefix_tokens": prefix,
               "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
               "generate_s": gen_s,
               "decode_tokens_per_s": LM_BATCH * NEW_TOKENS
               / (gen_s - prefill_ms / 1e3),
               "peak_mem_gb": peak, "logits_rel_frobenius_vs_plain": err,
               "limit": limit, "layer_rel_frobenius_max": max(layer_errs),
               "layer_rel_frobenius_median": sorted(layer_errs)[
                   len(layer_errs) // 2],
               "layer_limit": LAYER_LIMIT,
               "first_token_argmax_agreement": same_argmax,
               "params": cfg.param_count(),
               "active_params": cfg.active_param_count(),
               "prefill_profile": prefill_profile,
               "decode_4_steps_profile": decode_profile}
        if control:
            core = layers._attention_core

            def non_causal(q, k, v, causal, cfg_):
                # the kernel path only: the plain path stays the yardstick
                return core(q, k, v, cfg_.attn_impl != cfg.attn_impl, cfg_)

            layers._attention_core = non_causal
            try:
                logits_c = lm.prefill(params, cfg, prompt, patches)[0]
                layer_c = layer_check(params, cfg, cfg_p, prompt, patches)
            finally:
                layers._attention_core = core
            err_c = rel_frobenius(logits_c, logits_p)
            if err_c <= limit or max(layer_c) <= LAYER_LIMIT:
                raise AssertionError(f"{arch}: the causal-mask-off control "
                                     f"passed a limit (logits {err_c}, "
                                     f"worst layer {max(layer_c)})")
            out["control_non_causal_rel_frobenius"] = err_c
            out["control_layer_rel_frobenius_min"] = min(layer_c)
            out["control_layer_rel_frobenius_max"] = max(layer_c)
        if after is not None:
            out["after"] = after(params, cfg, cfg_p, prompt)
    del params
    torch.cuda.empty_cache()
    return out


def priority_keep(expert_idx: torch.Tensor, E: int, C: int,
                  k_major: bool = False) -> torch.Tensor:
    """The kept (token, choice) pairs [B, S·k] by an independent count:
    in each batch row, the pairs in priority order (token-major, the k
    choices inner, as the reference; ``k_major`` the other way round, a
    control), each expert keeping its first C.  A stable sort by expert
    ranks each pair within its expert, no cumulative one-hot."""
    B, S, k = expert_idx.shape
    order_idx = expert_idx.transpose(1, 2) if k_major else expert_idx
    flat = order_idx.reshape(B, S * k).cpu()
    keep = torch.zeros(flat.shape, dtype=torch.bool)
    for b in range(B):
        sorted_e, order = torch.sort(flat[b], stable=True)
        first = torch.searchsorted(sorted_e, sorted_e, side="left")
        rank = torch.arange(S * k) - first
        keep[b, order] = rank < C
    if k_major:
        keep = keep.reshape(B, k, S).transpose(1, 2).reshape(B, S * k)
    return keep


def moe_layer_check(params, cfg, cfg_p, prompt) -> dict:
    """Each MoE layer of the model on the plain path's hidden state: the
    bf16 ``moe_apply`` against the same layer recomputed in fp32 (the
    same bf16 input and weights, upcast).  Holds the share of (token,
    choice) routing pairs that agree, the bf16 run's dropped set against
    ``priority_keep``, the output on the tokens whose routing (experts
    and kept flags) agrees, and the aux term; and two controls that must
    fail: a k-major priority order (the dropped-set check) and gates left
    unnormalized (the output limit)."""
    from repro_torch.models import layers, lm, moe
    from repro_torch.tree import tree_map
    cfg32 = replace(cfg_p, dtype=torch.float32)
    rows, drops = [], 0
    with torch.no_grad():
        x, positions = lm._embed(params, cfg_p, prompt)
        for bp in lm._periods(params["blocks"], cfg_p.n_periods):
            for i, (mixer, ffn) in enumerate(cfg_p.pattern):
                p = bp[i]
                if ffn != "moe":
                    x = lm._apply_block(cfg_p, mixer, ffn, p, x,
                                        positions)[0]
                    continue
                h = layers.apply_norm(p["norm1"], x, cfg_p.norm)
                x = x + layers.attention(p["attn"], cfg_p, h, positions)
                h2 = layers.apply_norm(p["norm2"], x, cfg_p.norm)
                r16 = moe.route(p["ffn"], cfg_p, h2)
                y16, aux16 = moe.moe_apply(p["ffn"], cfg_p, h2, r16)
                p32 = tree_map(lambda a: a.float(), p["ffn"])
                r32 = moe.route(p32, cfg32, h2.float())
                y32, aux32 = moe.moe_apply(p32, cfg32, h2.float(), r32)
                del p32
                C = r16.capacity
                want = priority_keep(r16.expert_idx, cfg.n_experts, C)
                k_major = priority_keep(r16.expert_idx, cfg.n_experts, C,
                                        k_major=True)
                keep16 = r16.keep.cpu()
                pairs = r16.expert_idx == r32.expert_idx          # [B,S,k]
                B, S, k = pairs.shape
                same = (pairs & (r16.keep == r32.keep).view(B, S, k)) \
                    .all(-1)                                      # [B,S]
                err = rel_frobenius(y16[same], y32[same])
                # the control: gates left at their router probabilities
                r_nr = r16._replace(gates=torch.gather(r16.probs, -1,
                                                       r16.expert_idx))
                y_nr, _ = moe.moe_apply(p["ffn"], cfg_p, h2, r_nr)
                err_nr = rel_frobenius(y_nr[same], y32[same])
                rows.append({
                    "capacity": C,
                    "dropped_pairs": int((~keep16).sum()),
                    "dropped_pairs_fp32": int((~r32.keep).sum()),
                    "dropped_equal_independent_count": bool(
                        torch.equal(keep16, want)),
                    "control_k_major_equal": bool(
                        torch.equal(keep16, k_major)),
                    "control_k_major_pairs_differing": int(
                        (keep16 != k_major).sum()),
                    "routing_pair_agreement": float(
                        pairs.float().mean()),
                    "tokens_agreeing": float(same.float().mean()),
                    "y_rel_frobenius_agreeing": err,
                    "control_unnormalized_rel_frobenius": err_nr,
                    "aux_bf16": float(aux16), "aux_fp32": float(aux32),
                    "aux_rel": abs(float(aux16) - float(aux32))
                    / abs(float(aux32))})
                drops += rows[-1]["dropped_pairs"]
                x = x + y16
                del r16, r32, y16, y32, r_nr, y_nr, h2
    out = {"layers": rows, "dropped_pairs_total": drops,
           "routing_floor": MOE_ROUTING_FLOOR, "y_limit": MOE_Y_LIMIT,
           "aux_limit": MOE_AUX_RTOL,
           "routing_pair_agreement_min": min(
               r["routing_pair_agreement"] for r in rows),
           "y_rel_frobenius_max": max(
               r["y_rel_frobenius_agreeing"] for r in rows),
           "control_unnormalized_min": min(
               r["control_unnormalized_rel_frobenius"] for r in rows),
           "control_k_major_layers_differing": sum(
               not r["control_k_major_equal"] for r in rows)}
    bad = [i for i, r in enumerate(rows) if not (
        r["dropped_equal_independent_count"]
        and r["routing_pair_agreement"] >= MOE_ROUTING_FLOOR
        and r["y_rel_frobenius_agreeing"] <= MOE_Y_LIMIT
        and r["aux_rel"] <= MOE_AUX_RTOL)]
    if bad:
        raise AssertionError(f"moe layer: layers {bad} miss a limit: "
                             f"{json.dumps(out)}")
    # the controls: k-major must change the dropped set wherever a pair
    # drops, and the unnormalized gates must miss the output limit
    if any(r["dropped_pairs"] and r["control_k_major_equal"]
           for r in rows) or not drops \
            or out["control_unnormalized_min"] <= MOE_Y_LIMIT:
        raise AssertionError(f"moe layer: a control passed: "
                             f"{json.dumps(out)}")
    return out


def rel_leaf_errors(got, want) -> dict:
    """Each leaf of a prefill's (logits, caches) on the card against the
    CPU's, as max|difference| over the leaf's max|.|."""
    from repro_torch.tree import tree_leaves
    errs = {}
    for i, (g, w) in enumerate(zip(tree_leaves(list(got[:2])),
                                   tree_leaves(list(want[:2])))):
        g = g.cpu()
        if not (g.shape == w.shape and bool(torch.isfinite(g).all())):
            raise AssertionError(f"jamba: leaf {i} {tuple(g.shape)}")
        errs["logits" if i == 0 else f"cache{i - 1}"] = float(
            (g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    return errs


def jamba_phase(dev, flash, ssd) -> dict:
    """Jamba's smoke config (one period: 7 mamba blocks, 1 attention
    block, MoE every other block) in fp32 on the card, B = 2 × S = 128,
    from the same weights as the same config on the CPU (the plain
    versions there): through the kernels (``attn_impl="flash"``: the FMA
    forward at dh 16; ``ssd_impl="kernel"``) one prefill launches
    ``flash`` once and ``ssd`` 7 times, and its logits and every cache
    leaf lie within ``JAMBA_KERNEL_RTOL`` · max|·| of the CPU's; the
    card's plain path within ``JAMBA_CPU_RTOL``; then greedy generation
    on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import model_specs
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import init_params
    from repro_torch.serve.decode import greedy_generate
    from repro_torch.tree import tree_map
    cfg = replace(get_smoke_config("jamba_1_5_large_398b"),
                  attn_impl="flash", ssd_impl="kernel")
    cfg_p = replace(cfg, attn_impl="xla", ssd_impl="xla")
    cpu = init_params(model_specs(cfg), torch.Generator().manual_seed(SEED),
                      cfg.dtype, "cpu")
    params = tree_map(lambda a: a.to(dev), cpu)
    tokens = torch.randint(0, cfg.vocab, (JAMBA_BATCH, JAMBA_SEQ),
                           generator=torch.Generator().manual_seed(SEED))
    t_max = JAMBA_SEQ + 8
    with torch.no_grad():
        want = lm.prefill(cpu, cfg, tokens, t_max=t_max)
        for kern in (flash, ssd):
            kern.launches = 0
        got = lm.prefill(params, cfg, tokens.to(dev), t_max=t_max)
        torch.cuda.synchronize()
        launches = {flash.symbol: flash.launches, ssd.symbol: ssd.launches}
        errs = rel_leaf_errors(got, want)
        plain = rel_leaf_errors(
            lm.prefill(params, cfg_p, tokens.to(dev), t_max=t_max), want)
        ids = greedy_generate(params, cfg, tokens.to(dev), 8)
        torch.cuda.synchronize()
    n_attn = sum(m == "attn" for m, _ in cfg.pattern) * cfg.n_periods
    n_mamba = sum(m == "mamba" for m, _ in cfg.pattern) * cfg.n_periods
    if launches != {flash.symbol: n_attn, ssd.symbol: n_mamba} \
            or max(errs.values()) > JAMBA_KERNEL_RTOL \
            or max(plain.values()) > JAMBA_CPU_RTOL \
            or got[2] != JAMBA_SEQ or int(ids.min()) < 0 \
            or int(ids.max()) >= cfg.vocab:
        raise AssertionError(f"jamba: launches {launches} (want {n_attn} / "
                             f"{n_mamba}), kernel path {errs}, plain path "
                             f"{plain}, next_pos {got[2]}")
    worst = max(errs, key=errs.get)
    return {"config": cfg.name, "B": JAMBA_BATCH, "S": JAMBA_SEQ,
            "pattern": [list(p) for p in cfg.pattern],
            "launches": launches, "kernel_rel_err_vs_cpu": errs,
            "kernel_rel_err_max": errs[worst], "kernel_worst_leaf": worst,
            "kernel_limit": JAMBA_KERNEL_RTOL,
            "plain_rel_err_max": max(plain.values()),
            "plain_limit": JAMBA_CPU_RTOL, "generated": list(ids.shape)}


def serve_smoke(dev, arch: str) -> dict:
    """``launch.serve.run`` at ``arch``'s smoke config on the card: 8
    requests of 16 tokens, every id in range."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as serve_launcher
    res = serve_launcher.run(arch, smoke=True, device=dev)
    vocab = get_smoke_config(arch).vocab
    if len(res.completed) != 8 or any(
            len(r.tokens) != 16 or not all(0 <= t < vocab for t in r.tokens)
            for r in res.completed):
        raise AssertionError(f"serve {arch}: {len(res.completed)} requests")
    return {"arch": arch, "requests": len(res.completed),
            "steps": res.steps, "tokens_per_s": res.tokens_per_s,
            "wall_s": res.wall_s}


def train_smoke(dev, arch: str) -> dict:
    """``launch.train.run`` at ``arch``'s smoke config on the card with
    ``attn_impl="flash"`` (fp32: the FMA forward, dq and dk/dv): 4 steps
    of 4 x 64 tokens, finite losses and gradient norms."""
    from repro_torch.launch import train as train_launcher
    res = train_launcher.run(arch, steps=4, smoke=True, device=dev,
                             attn_impl="flash", log_every=4)
    if len(res.losses) != 4 or not all(map(math.isfinite,
                                           res.losses + res.grad_norms)):
        raise AssertionError(f"train {arch}: losses {res.losses}, norms "
                             f"{res.grad_norms}")
    return {"arch": arch, "losses": res.losses,
            "grad_norms": res.grad_norms, "step_s": res.step_s,
            "tokens_per_s": res.tokens_per_s}


def serve_loop_phase(dev) -> dict:
    """``launch.serve.run`` at Phi-4-mini's full width, capture on."""
    from repro_torch.launch import serve as serve_launcher
    torch.cuda.reset_peak_memory_stats()
    res = serve_launcher.run("phi4_mini_3_8b", capture=True, device=dev)
    torch.cuda.synchronize()
    table = res.server._state["serving"]
    stats = res.server.stats()
    if len(res.completed) != 8 \
            or any(len(r.tokens) != 16 for r in res.completed) \
            or int(table.count) != res.steps // 8 \
            or not bool(torch.isfinite(table.slab).all()):
        raise AssertionError(f"serve_loop: {len(res.completed)} requests, "
                             f"{res.steps} steps, capture count "
                             f"{int(table.count)}")
    return {"requests": len(res.completed), "steps": res.steps,
            "tokens_per_s": res.tokens_per_s, "wall_s": res.wall_s,
            "capture_puts": int(table.count),
            "capture_op_count": stats["op_count"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def check_flash_bwd(dev, B: int, S: int, H: int, K: int, dh: int, dtype,
                    iters: int = 10) -> tuple[dict, dict]:
    """The two flash-attention backward kernels against their plain
    version on the forward kernel's own o and LSE (causal), timed beside
    the backward of ``scaled_dot_product_attention``; dq and dk/dv on the
    kernels the route rule picks (bf16: tensor cores), each launched once;
    dq, dk and dv bit-identical on a second run; and, as a control that
    must FAIL each one's limit, the backward kernels with their causal
    mask off.  Returns the dq row and the dk/dv row."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).mul(0.5)
                   .to(dtype) for shape in ((B, S, H, dh), (B, S, K, dh),
                                            (B, S, K, dh), (B, S, H, dh)))
    o, lse = ops.flash_attention(q, k, v, True, return_lse=True)
    tc = ops.tensor_core_route(dtype, dh)
    kernels = (ops.FLASH_BWD_DQ, ops.FLASH_BWD_DQ_TC, ops.FLASH_BWD_DKV,
               ops.FLASH_BWD_DKV_TC)
    before = [kern.launches for kern in kernels]
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, True)
    grown = [kern.launches - b for kern, b in zip(kernels, before)]
    if grown != [int(not tc), int(tc)] * 2:
        raise AssertionError(f"flash backward at {dtype} launched (dq FMA, "
                             f"dq tensor-core, dk/dv FMA, dk/dv tensor-core)"
                             f" {grown}")
    dq_kernel, dkv_kernel = ops.bwd_kernels(dtype, dh)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, True)
    identical = [torch.equal(a, b) for a, b in zip(got, again)]
    if not all(identical):
        raise AssertionError(f"dq, dk, dv bit-identical between two runs "
                             f"at {dtype}: {identical}")
    del again
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    # fp32: sums in another order; bf16: one bf16 rounding of the output
    rel = 2e-5 if dtype == torch.float32 else 2.0 ** -8
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g.float() - w.float()).abs().max())
        tol = rel * float(w.float().abs().max())
        if not (bool(torch.isfinite(g).all()) and err <= tol):
            raise AssertionError(f"flash backward kernel disagrees on {name}"
                                 f" at {q.shape} {dtype}: {err} > {tol}")
        errs[name] = (err, tol)
    control = ops.flash_attention_bwd(q, k, v, o, do, lse, False)
    control_errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), control, want):
        control_errs[name] = float((g.float() - w.float()).abs().max())
        if control_errs[name] <= errs[name][1]:
            raise AssertionError(f"the mask-off backward control passed "
                                 f"{name}'s limit at {dtype}: "
                                 f"{control_errs[name]}")
    del got, want, control

    def both():
        return ops.flash_attention_bwd(q, k, v, o, do, lse, True)

    wall = time_ms(both, iters)
    dev_ms = device_ms(both, iters, {
        "dq": "flash_bwd_dq_tc_kernel" if tc else "flash_bwd_dq_kernel",
        "dkv": "flash_bwd_dkv_tc_kernel" if tc else "flash_bwd_dkv_kernel"})
    plain = timed(lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                      True), 3)
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=True)
    ct = do.transpose(1, 2)
    library = timed(lambda: torch.autograd.grad(out, leaves, ct,
                                                retain_graph=True), iters)
    pairs = B * H * S * (S + 1) // 2
    prod = 2.0 * pairs * dh                      # one causal product
    e = q.element_size()
    rows = B * S * H * dh * e
    kv = B * S * K * dh * e
    stats = 2 * B * S * H * 4                    # lse and D, fp32
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    shape = (f"B={B} S=T={S} H={H} K={K} dh={dh} "
             f"{str(dtype).split('.')[-1]} causal=True")
    out_rows = []
    for name, nbytes, flops, errs_of, kern in (
            ("dq", 3 * rows + 2 * kv + stats, 3 * prod, ("dq",), dq_kernel),
            ("dkv", 2 * rows + 4 * kv + stats, 4 * prod, ("dk", "dv"),
             dkv_kernel)):
        b, by = bound(nbytes, flops, peak)
        b32, _ = bound(nbytes, flops)
        out_rows.append({
            "kernel": kern.symbol,
            "max_abs_err": max(errs[n][0] for n in errs_of),
            "errors_and_tols": {n: errs[n] for n in errs_of},
            "ms": wall if dev_ms is None else dev_ms[name],
            "wall_ms": wall, "timed_by": "cuda_events (both kernels and D)"
            if dev_ms is None else "torch.profiler",
            "plain_ms": plain["ms"], "plain_wall_ms": plain["wall_ms"],
            "library_ms": library["ms"],
            "library_wall_ms": library["wall_ms"], "bound_ms": b,
            "bound_by": by, "bound_ms_at_fp32_rate": b32, "shape": shape,
            "bit_identical_rerun": all(
                identical[("dq", "dk", "dv").index(n)] for n in errs_of),
            "control_mask_off_max_abs_err": {n: control_errs[n]
                                             for n in errs_of},
            "notes": "wall_ms, plain_ms and library_ms are the whole "
                     "backward (dq, dk and dv; wall_ms with D = "
                     "rowsum(do*o)); library: the backward of "
                     "scaled_dot_product_attention (autograd.grad)"})
    return out_rows[0], out_rows[1]


def attention_grads(params, cfg, h, positions, ct) -> list:
    """Gradients of one attention mixer's output against ``ct``: the
    input's, then wq, wk, wv, wo."""
    from repro_torch.models import layers
    x = h.detach().requires_grad_(True)
    w = {n: params[n].detach().requires_grad_(True)
         for n in ("wq", "wk", "wv", "wo")}
    with torch.enable_grad():
        out = layers.attention(w, cfg, x, positions)
        return list(torch.autograd.grad(out, [x, *w.values()], ct))


def layer_grad_check(params, cfg_k, cfg_p, tokens) -> list[dict]:
    """On every layer, the attention mixer's gradients through the kernel
    path and the plain path on the same input — the plain path's hidden
    state — and the same random cotangent, as relative Frobenius
    differences by gradient."""
    from repro_torch.models import layers, lm
    gen = torch.Generator(device=tokens.device).manual_seed(SEED + 2)
    diffs = []
    with torch.no_grad():
        x, positions = lm._embed(params, cfg_p, tokens)
    for period in lm._periods(params["blocks"], cfg_p.n_periods):
        bp = period[0]
        with torch.no_grad():
            h = layers.apply_norm(bp["norm1"], x, cfg_p.norm)
        ct = torch.randn(h.shape, generator=gen, device=h.device) \
            .to(h.dtype)
        got, want = (attention_grads(bp["attn"], c, h, positions, ct)
                     for c in (cfg_k, cfg_p))
        diffs.append({n: rel_frobenius(a, b) for n, a, b in
                      zip(("x", "wq", "wk", "wv", "wo"), got, want)})
        with torch.no_grad():
            x = lm._apply_block(cfg_p, "attn", "mlp", bp, x, positions)[0]
    return diffs


def grads_vs_plain(dev, base, micro: int) -> dict:
    """One micro-batch of ``micro`` x ``TRAIN_SEQ`` tokens at ``base``'s
    width in bf16, the kernel path (``attn_impl="flash"``) against the
    plain path (``"xla"``): every layer's attention gradients within
    ``LAYER_GRAD_LIMIT`` (and, as a control that must FAIL it on every
    layer, the backward kernels with their causal mask off under a causal
    forward), then the whole model's loss and ``grad_norm`` within
    ``LOSS_LIMIT`` and ``GRAD_NORM_LIMIT`` with the tensor-core forward,
    dq and dk/dv launched 2, 1 and 1 times a layer (remat) and none of
    the FMA ones."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.launch import steps
    from repro_torch.parallel.sharding import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import value_and_grad
    cfg_k, cfg_p = (replace(base, attn_impl=a) for a in ("flash", "xla"))
    params = init_params(steps.model_specs(cfg_k),
                         torch.Generator(device=dev).manual_seed(SEED),
                         cfg_k.dtype, dev)
    stream = iter(TokenStream(base.vocab, micro, TRAIN_SEQ, seed=SEED))
    tokens = torch.from_numpy(next(stream)["tokens"]).to(dev)
    layer = layer_grad_check(params, cfg_k, cfg_p, tokens)
    worst = max(max(d.values()) for d in layer)
    orig_bwd = aops.flash_attention_bwd

    def non_causal_bwd(q, k, v, o, do, lse, causal=True):
        # the backward kernels only: the forward keeps its causal mask
        return orig_bwd(q, k, v, o, do, lse, False)

    aops.flash_attention_bwd = non_causal_bwd
    try:
        control = layer_grad_check(params, cfg_k, cfg_p, tokens)
    finally:
        aops.flash_attention_bwd = orig_bwd
    control_min = min(max(d.values()) for d in control)
    if not worst <= LAYER_GRAD_LIMIT:
        raise AssertionError(f"{base.name}: attention gradients differ from "
                             f"the plain path by {worst} (limit "
                             f"{LAYER_GRAD_LIMIT}): {layer}")
    if control_min <= LAYER_GRAD_LIMIT:
        raise AssertionError(f"{base.name}: the causal-mask-off backward "
                             f"passed the per-layer limit on some layer "
                             f"({control_min})")
    whole = {}
    batch = {"tokens": tokens, "labels": tokens}
    # bf16 at the config's dh: the tensor-core forward, dq and dk/dv; the
    # FMA forward, dq and dk/dv must not run
    kernels = (aops.FLASH_TC, aops.FLASH_BWD_DQ_TC, aops.FLASH_BWD_DKV_TC)
    fma_only = (aops.FLASH, aops.FLASH_BWD_DQ, aops.FLASH_BWD_DKV)
    for kern in fma_only:
        kern.launches = 0
    for name, c in (("kernel", cfg_k), ("plain", cfg_p)):
        for kern in kernels:
            kern.launches = 0
        loss_fn = steps._loss_fn(c)
        (loss, _), grads = value_and_grad(lambda p: loss_fn(p, batch),
                                          params, has_aux=True)
        torch.cuda.synchronize()
        whole[name] = (float(loss), float(opt.global_norm(grads)),
                       [kern.launches for kern in kernels])
        del grads
    (lk, nk, launch_k), (lp, np_, _) = whole["kernel"], whole["plain"]
    if launch_k != [2 * base.n_periods, base.n_periods, base.n_periods] \
            or any(kern.launches for kern in fma_only):
        raise AssertionError(f"{base.name}: one micro-batch's value_and_grad"
                             f" launched {launch_k} (forward, dq, dk/dv) and "
                             f"{[k.launches for k in fma_only]} (FMA forward,"
                             f" dq, dk/dv)")
    if not (math.isfinite(lk) and abs(lk - lp) <= LOSS_LIMIT * abs(lp)
            and abs(nk - np_) <= GRAD_NORM_LIMIT * abs(np_)):
        raise AssertionError(f"{base.name} whole model: loss {lk} vs {lp}, "
                             f"grad_norm {nk} vs {np_}")
    del params
    return {"layer_grad_rel_frobenius_max": worst,
            "layer_grad_rel_frobenius_median": sorted(
                max(d.values()) for d in layer)[len(layer) // 2],
            "layer_grad_worst_by_name": {n: max(d[n] for d in layer)
                                         for n in layer[0]},
            "layer_grad_limit": LAYER_GRAD_LIMIT,
            "control_non_causal_bwd_layer_min": control_min,
            "control_non_causal_bwd_layer_max": max(
                max(d.values()) for d in control),
            "whole_loss_kernel": lk, "whole_loss_plain": lp,
            "whole_loss_rel": abs(lk - lp) / abs(lp),
            "loss_limit": LOSS_LIMIT, "whole_grad_norm_kernel": nk,
            "whole_grad_norm_plain": np_,
            "whole_grad_norm_rel": abs(nk - np_) / abs(np_),
            "grad_norm_limit": GRAD_NORM_LIMIT,
            "whole_launches_per_micro_batch": launch_k}


def train_phase(dev) -> tuple[dict, dict, dict]:
    """LM training at Phi-4-mini's full width: the backward kernels, the
    per-layer gradients and the whole model's loss against the plain
    path, then the launcher.  Returns (dq row, dk/dv row, phase line)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_launcher
    from repro_torch.tree import tree_leaves
    arch = "phi4_mini_3_8b"
    micro = TRAIN_BATCH // get_config(arch).grad_accum
    # (a) the kernels at the training shape, and one tile in fp32
    dq, dkv = check_flash_bwd(dev, micro, TRAIN_SEQ, 24, 8, 128,
                              torch.bfloat16)
    dq32, dkv32 = check_flash_bwd(dev, 1, 128, 24, 8, 128, torch.float32)
    for row, edge in ((dq, dq32), (dkv, dkv32)):
        row["edge"] = {k: edge[k] for k in (
            "kernel", "shape", "max_abs_err", "ms", "wall_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}
    torch.cuda.empty_cache()

    # (b) kernel path against plain path, layer by layer, then whole
    base = get_config(arch)
    kernels = (aops.FLASH_TC, aops.FLASH_BWD_DQ_TC, aops.FLASH_BWD_DKV_TC)
    fma_only = (aops.FLASH, aops.FLASH_BWD_DQ, aops.FLASH_BWD_DKV)
    grads_line = grads_vs_plain(dev, base, micro)
    torch.cuda.empty_cache()

    # (c) the launcher, with each step's launches counted
    per_step = []
    make_step = train_launcher.make_train_step

    def counted(cfg):
        step = make_step(cfg)

        def run_step(state, batch_):
            before = [kern.launches for kern in kernels]
            out = step(state, batch_)
            per_step.append([kern.launches - b
                             for kern, b in zip(kernels, before)])
            return out
        return run_step

    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_launcher.make_train_step = counted
    try:
        res = train_launcher.run(arch, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                                 seq_len=TRAIN_SEQ, attn_impl="flash",
                                 device=dev, log_every=1)
    finally:
        train_launcher.make_train_step = make_step
    torch.cuda.synchronize()
    launches = {kern.symbol: kern.launches for kern in kernels + fma_only}
    peak_bytes = torch.cuda.max_memory_allocated()
    peak = peak_bytes / 1e9
    want = [2 * base.grad_accum * base.n_periods,
            base.grad_accum * base.n_periods,
            base.grad_accum * base.n_periods]
    if per_step != [want] * TRAIN_STEPS \
            or any(kern.launches for kern in fma_only):
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{want} (tensor-core forward, dq, dk/dv); FMA "
                             f"forward, dq, dk/dv: "
                             f"{[k.launches for k in fma_only]}")
    if not all(map(math.isfinite, res.losses + res.grad_norms)):
        raise AssertionError(f"losses {res.losses}, grad norms "
                             f"{res.grad_norms}")
    got_leaves = tree_leaves(res.state.params)
    if [tuple(p.shape) for p in got_leaves] != [
            s.shape for s in tree_leaves(steps.model_specs(base))] \
            or {p.dtype for p in got_leaves} != {torch.bfloat16}:
        raise AssertionError("the trained params left the reference's "
                             "layout or bf16")
    step_fn = steps.make_train_step(replace(base, attn_impl="flash"))
    raw = next(iter(TokenStream(base.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                seed=SEED + 1)))
    prof_batch = {k: torch.from_numpy(a).to(dev) for k, a in raw.items()}
    step_profile = profile(lambda: step_fn(res.state, prof_batch), top=12)
    # (d) a durable checkpoint of this full-width state, staged through
    # host memory, and an in-place restore
    torch.cuda.empty_cache()
    full_ckpt = checkpoint_full(dev, res.state,
                                lambda: step_fn(res.state, prof_batch),
                                peak_bytes)
    steady = res.step_s[1:]
    line = {"arch": arch, "impl": {"attn_impl": "flash"}, **grads_line,
            "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
            "grad_accum": base.grad_accum, "launches": launches,
            "launches_per_step": per_step[0], "losses": res.losses,
            "grad_norms": res.grad_norms, "step_s": res.step_s,
            "steady_step_s_mean": sum(steady) / len(steady),
            "tokens_per_s": res.tokens_per_s,
            "steady_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * len(steady)
            / sum(steady),
            "peak_mem_gb": peak, "params": base.param_count(),
            "step_profile": step_profile, "checkpoint_full": full_ckpt}
    del res, step_fn
    torch.cuda.empty_cache()
    return dq, dkv, line


def adafactor64(g, vr0, vc0, scale: float, step: int, lr: float,
                update, rows: int = 4096) -> tuple:
    """One Adafactor step of a factored leaf recomputed in float64 from its
    gradient ``g`` (as autograd gave it), the clip's ``scale``, the
    moments before the step and the optimizer's step count before it
    (``beta = 1 - (step + 2)^-0.8``), block by block over ``rows`` rows:
    the row and column moments after the step, and the largest
    difference of the card's ``update`` from ``-lr * u`` (the update
    clipped to RMS 1) with the largest ``|lr * u|``."""
    beta = 1.0 - (step + 2.0) ** -0.8
    R, C = g.shape[-2], g.shape[-1]
    M = g.numel() // (R * C)
    g3, upd = g.view(M, R, C), update.view(M, R, C)
    vr = vr0.double().reshape(M, R) * beta
    colsum = torch.zeros((M, C), dtype=torch.float64, device=g.device)
    blocks = [(m, slice(r, r + rows)) for m in range(M)
              for r in range(0, R, rows)]

    def g64(m, rs):
        return g3[m, rs].double() * scale

    for m, rs in blocks:
        g2 = torch.square(g64(m, rs)) + 1e-30
        vr[m, rs] += (1.0 - beta) * g2.mean(-1)
        colsum[m] += g2.sum(0)
        del g2
    vc = beta * vc0.double().reshape(M, C) + (1.0 - beta) * colsum / R
    rfac = torch.sqrt(vr.mean(-1) + 1e-30)

    def u_of(m, rs):
        return g64(m, rs) / torch.sqrt(vr[m, rs, None] + 1e-30) \
            / torch.sqrt(vc[m] + 1e-30) * rfac[m]

    sq = sum(float(torch.square(u_of(m, rs)).sum()) for m, rs in blocks)
    denom = max(1.0, math.sqrt(sq / g.numel() + 1e-12))
    err = top = 0.0
    for m, rs in blocks:
        want = -lr * u_of(m, rs) / denom
        err = max(err, float((upd[m, rs].double() - want).abs().max()))
        top = max(top, float(want.abs().max()))
    return vr.view(vr0.shape), vc.view(vc0.shape), err, top


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest elementwise relative difference."""
    return float(((got.double() - want) / want).abs().max())


def adafactor_step_check(dev, cfg, state, batch) -> dict:
    """One Adafactor step of the card's state (``make_tx(cfg)``, the train
    step's own) on the embedding and one stacked matrix (the MLP's
    ``w_up``) against ``adafactor64``: the row and column moments within
    ``ADAFACTOR_RTOL`` of float64 (elementwise relative), the update
    (written in bf16) within one bf16 ulp of the largest entry: its
    rounding is up to half of that, and an fp32 value a few 1e-7 from
    float64's can round to the other side; and, as a control that must
    FAIL the moments' limit, the float64 recomputation one step on
    (the next step's ``beta``)."""
    from repro_torch.launch import steps
    from repro_torch.train.train_state import make_tx
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad
    loss_fn = steps._loss_fn(cfg)
    (_, _), grads = value_and_grad(lambda p: loss_fn(p, batch),
                                   state.params, has_aux=True)
    it = iter(steps._owned(tree_leaves(grads)))
    grads = tree_map(lambda _: next(it), state.params)
    inner = state.opt_state[1]
    step = int(inner.step)
    # the clip's factor in float64 over every leaf
    sq = sum(float(torch.square(x.double()).sum())
             for g in tree_leaves(grads) for x in g.reshape(-1).split(1 << 25))
    scale = min(1.0, 1.0 / (math.sqrt(sq) + 1e-9))
    lr = 1e-2 * (step + 1) / min(2000, 100_000 // 10)   # the warmup
    picks = {"embed": lambda t: t["embed"],
             "blocks/0/ffn/w_up": lambda t: t["blocks"][0]["ffn"]["w_up"]}
    before = {n: (pick(grads).clone(), pick(inner.vr).clone(),
                  pick(inner.vc).clone()) for n, pick in picks.items()}
    updates, opt_state = make_tx(cfg).update(grads, state.opt_state,
                                             state.params)
    torch.cuda.synchronize()
    new = opt_state[1]
    out = {"step": step + 1, "clip_scale": scale, "lr": lr,
           "rtol": ADAFACTOR_RTOL}
    for n, pick in picks.items():
        g, vr0, vc0 = before[n]
        vr, vc, err, top = adafactor64(g, vr0, vc0, scale, step, lr,
                                       pick(updates))
        got = {"vr": rel_max(pick(new.vr), vr),
               "vc": rel_max(pick(new.vc), vc),
               "update_max_abs_err": err, "update_max": top,
               "update_limit": 2.0 ** -7 * top}
        c_vr, c_vc, _, _ = adafactor64(g, vr0, vc0, scale, step + 1, lr,
                                       pick(updates))
        got["control_next_beta"] = {"vr": rel_max(pick(new.vr), c_vr),
                                    "vc": rel_max(pick(new.vc), c_vc)}
        if not (got["vr"] <= ADAFACTOR_RTOL and got["vc"] <= ADAFACTOR_RTOL
                and err <= got["update_limit"]):
            raise AssertionError(f"adafactor step on {n} against float64: "
                                 f"{got}")
        if min(got["control_next_beta"].values()) <= ADAFACTOR_RTOL:
            raise AssertionError(f"the next-beta control passed the "
                                 f"moments' limit on {n}: {got}")
        out[n] = dict(got, shape=list(g.shape))
        del g, vr0, vc0, vr, vc, c_vr, c_vc
    del grads, updates, before
    return out


def nemotron_train_phase(dev) -> tuple[dict, dict, dict]:
    """Nemotron-4 training at full width, ``NEMOTRON_TRAIN_LAYERS`` of its
    96 layers, one sequence of ``TRAIN_SEQ`` tokens a step (grad_accum
    64 -> 1), bf16, ``attn_impl="flash"``, Adafactor: (a) the dq and dk/dv
    kernels at dh 192 against their plain version (``check_flash_bwd``,
    bf16 at the step's shape and fp32 at one tile); (b)
    ``grads_vs_plain``; (c) ``NEMOTRON_TRAIN_STEPS`` steps of
    ``launch.steps.make_train_step`` from ``init_train_state`` (the
    launcher's entry points): exactly 2 tensor-core forward, 1 dq and 1
    dk/dv launches a layer a step (remat) and none of the FMA ones, finite
    losses, the peak memory under the card's; one profiled step; (d)
    ``adafactor_step_check``.  Returns (dq row, dk/dv row, line)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.launch import steps
    from repro_torch.train.train_state import init_train_state, make_tx
    full = get_config(NEMOTRON)
    base = replace(full, n_layers=NEMOTRON_TRAIN_LAYERS, grad_accum=1)
    H, K, dh = base.n_heads, base.n_kv_heads, base.head_dim
    dq, dkv = check_flash_bwd(dev, 1, TRAIN_SEQ, H, K, dh, torch.bfloat16)
    dq32, dkv32 = check_flash_bwd(dev, 1, 128, H, K, dh, torch.float32)
    for row, edge in ((dq, dq32), (dkv, dkv32)):
        row["fp32"] = {k: edge[k] for k in (
            "kernel", "shape", "max_abs_err", "ms", "wall_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}
    torch.cuda.empty_cache()
    grads_line = grads_vs_plain(dev, base, 1)
    torch.cuda.empty_cache()

    cfg = replace(base, attn_impl="flash")
    kernels = (aops.FLASH_TC, aops.FLASH_BWD_DQ_TC, aops.FLASH_BWD_DKV_TC)
    fma_only = (aops.FLASH, aops.FLASH_BWD_DQ, aops.FLASH_BWD_DKV)
    state = init_train_state(torch.Generator(device=dev).manual_seed(SEED),
                             cfg, steps.model_specs(cfg),
                             make_tx(cfg, total_steps=NEMOTRON_TRAIN_STEPS),
                             device=dev)
    step_fn = steps.make_train_step(cfg)
    stream = iter(TokenStream(cfg.vocab, 1, TRAIN_SEQ, seed=SEED))
    batches = [{k: torch.from_numpy(a).to(dev) for k, a in next(
        stream).items()} for _ in range(NEMOTRON_TRAIN_STEPS + 2)]
    for kern in kernels + fma_only:
        kern.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_step, losses, norms, step_s = [], [], [], []
    for batch in batches[:NEMOTRON_TRAIN_STEPS]:
        before = [kern.launches for kern in kernels]
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        norms.append(float(metrics["grad_norm"]))
        per_step.append([kern.launches - b
                         for kern, b in zip(kernels, before)])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {kern.symbol: kern.launches for kern in kernels + fma_only}
    want = [2 * cfg.n_periods, cfg.n_periods, cfg.n_periods]
    if per_step != [want] * NEMOTRON_TRAIN_STEPS \
            or any(kern.launches for kern in fma_only):
        raise AssertionError(f"nemotron: launches per step {per_step}, "
                             f"expected {want}; FMA forward, dq, dk/dv: "
                             f"{[k.launches for k in fma_only]}")
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"nemotron: losses {losses}, norms {norms}")
    if int(state.opt_state[1].step) != NEMOTRON_TRAIN_STEPS:
        raise AssertionError("nemotron: the Adafactor state did not step")
    out = []
    step_profile = profile(lambda: out.append(step_fn(state, batches[-2])),
                           top=12)
    state = out.pop()[0]
    adafactor = adafactor_step_check(dev, cfg, state, batches[-1])
    steady = step_s[1:]
    weights = cfg.param_count() * 2 / 1e9
    line = {"arch": NEMOTRON, "impl": {"attn_impl": "flash"},
            "n_layers": cfg.n_layers, "full_n_layers": full.n_layers,
            # the reference's train_4k cell: 256 sequences of 4,096
            "reduced": {"n_layers": [full.n_layers, cfg.n_layers],
                        "tokens_per_step": [256 * 4096, TRAIN_SEQ],
                        "grad_accum": [full.grad_accum, 1]},
            **grads_line, "steps": NEMOTRON_TRAIN_STEPS, "batch": 1,
            "seq_len": TRAIN_SEQ, "optimizer": cfg.optimizer,
            "launches": launches, "launches_per_step": per_step[0],
            "losses": losses, "grad_norms": norms, "step_s": step_s,
            "steady_step_s_mean": sum(steady) / len(steady),
            "steady_tokens_per_s": TRAIN_SEQ * len(steady) / sum(steady),
            "peak_mem_gb": peak, "params": cfg.param_count(),
            "params_and_bf16_grads_gb": 2 * weights,
            "card_mem_gb": torch.cuda.get_device_properties(0).total_memory
            / 1e9, "step_profile": step_profile,
            "adafactor_vs_float64": adafactor}
    del state, step_fn
    torch.cuda.empty_cache()
    return dq, dkv, line


def sharded_phase(dev, cfg, fcfg, fused: dict) -> tuple[dict, dict]:
    """(a) the sharded gather kernel; (b) the in-situ workflow with the
    trainer on a ``SHARDS``-rank mesh on this card, tiers ``sharded_fused``
    and ``slab_sharded`` (each session profiled), held to each other
    exactly; one epoch of each against ``fused`` within the reference's
    tolerance (:func:`mesh_epoch_check`); the eight-epoch session's drift
    from ``fused`` (phase 8's sequential run) within the drift limits, and
    a control session with one rank's gradients dropped beyond them.
    Returns (the kernel's row, the phase line)."""
    from repro_torch.kernels.quadconv import ops as qops
    from repro_torch.kernels.store import ops as sops
    from repro_torch.parallel.sharding import data_mesh
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    row = check_gather_sharded(dev)
    print(f"[kernels] {json.dumps(row)}", flush=True)
    mesh = data_mesh(SHARDS, devices=[dev] * SHARDS)
    counters = [sops.PROBE, sops.SAMPLE, sops.GATHER, sops.GATHER_SHARDED,
                qops.QUADCONV]
    runs, line = {}, {}
    seconds = {"kernel": time.perf_counter() - t0}
    for tier in ("sharded_fused", "slab_sharded"):
        box = []
        t0 = time.perf_counter()
        prof = profile(lambda: box.append(train_session(
            dev, cfg, fcfg, True, counters, label=tier, mesh=mesh,
            slab_sharded=tier == "slab_sharded")))
        seconds[tier] = time.perf_counter() - t0
        print(f"[sharded {tier}] profile: {prof}", flush=True)
        runs[tier] = run = box[0]
        if run["tier"] != tier:
            raise AssertionError(f"planned tier {run['tier']} != {tier}")
        run["profile"] = prof
    for tier, run in (("fused", fused), *runs.items()):
        idle = re.search(r"idle_share=(-?[0-9.]+)", run["profile"])
        line[tier] = {"epoch_ms": run["epoch_ms"], "peak_gb": run["peak_gb"],
                      "wall_s": run["wall_s"], "launches": run["launches"],
                      "idle_share": float(idle.group(1)) if idle else None}
    # the ranks gather once each per trainer store op and at the warm-up
    want = SHARDS * (runs["slab_sharded"]["trainer_ops"] + 1)
    got = runs["slab_sharded"]["launches"]["gather_rows_sharded"]
    if got != want or runs["sharded_fused"]["launches"][
            "gather_rows_sharded"]:
        raise AssertionError(f"gather_rows_sharded launched {got} times on "
                             f"slab_sharded (plan: {want}), "
                             f"{runs['sharded_fused']['launches']} on "
                             f"sharded_fused")
    sf, sl = runs["sharded_fused"], runs["slab_sharded"]
    if not all(torch.equal(a, b) for a, b in
               zip(tree_leaves(sf["state"]), tree_leaves(sl["state"]))) \
            or [(h.train_loss, h.val_loss) for h in sf["history"]] \
            != [(h.train_loss, h.val_loss) for h in sl["history"]]:
        raise AssertionError("slab_sharded's state or losses differ from "
                             "sharded_fused's")
    t0 = time.perf_counter()
    eight = drift(sf, fused)
    if not drift_within(eight):
        raise AssertionError(f"eight epochs: sharded_fused vs fused {eight}")
    control = drift(ddp_control(dev, cfg, fcfg, counters, mesh), fused)
    if not control["max_abs_param_diff"] > DRIFT_PARAM_ATOL:
        raise AssertionError(f"the control with rank 1's gradients dropped "
                             f"passes the drift limit: {control}")
    coll = collectives_phase(dev, cfg, fcfg)
    print(f"[collectives] {json.dumps(coll)}", flush=True)
    line["collectives"] = coll
    line["checks"] = {
        "gather_rows_sharded_launches": got,
        "slab_equals_sharded_fused": True,
        "one_epoch": mesh_epoch_check(dev, fused, sf, sl),
        "eight_epochs": eight, "control_rank_1_dropped": control}
    seconds["checks"] = time.perf_counter() - t0
    line["seconds"] = seconds
    return row, line, runs["slab_sharded"]


def divergence(params, ref_params, losses, ref_losses) -> dict:
    """How far params and (train, val) losses lie from a reference run's:
    the largest absolute param difference, the largest by which it
    exceeds ``MESH_RTOL`` of the reference value, and the largest
    relative train and val loss differences."""
    from repro_torch.tree import tree_leaves
    diff = excess = 0.0
    for a, b in zip(tree_leaves(params), tree_leaves(ref_params)):
        d = (a - b).abs()
        diff = max(diff, float(d.max()))
        excess = max(excess, float((d - MESH_RTOL * b.abs()).max()))
    rel = [[abs(x - y) / abs(y) for x, y in zip(got, want)]
           for got, want in zip(losses, ref_losses)]
    return {"max_abs_param_diff": diff, "max_excess_over_rtol": excess,
            "max_rel_train_loss_diff": max(r[0] for r in rel),
            "max_rel_val_loss_diff": max(r[1] for r in rel)}


def drift(run: dict, fused: dict) -> dict:
    """:func:`divergence` of a session's final params and per-epoch losses
    from the fused session's."""
    return divergence(run["state"].params, fused["state"].params,
                      [(h.train_loss, h.val_loss) for h in run["history"]],
                      [(h.train_loss, h.val_loss) for h in fused["history"]])


def drift_within(got: dict) -> bool:
    return (got["max_abs_param_diff"] <= DRIFT_PARAM_ATOL
            and got["max_rel_train_loss_diff"] <= DRIFT_LOSS_RTOL
            and got["max_rel_val_loss_diff"] <= DRIFT_LOSS_RTOL)


def ddp_control(dev, cfg, fcfg, counters, mesh) -> dict:
    """The ``sharded_fused`` session with rank 1's gradients and loss
    dropped from every DDP sum (rank 0's counted for each rank): the
    control that the eight-epoch drift limit must catch."""
    from repro_torch.parallel import collectives as C
    real = C.psum
    C.psum = lambda per_rank, mesh: real([per_rank[0]] * mesh.size, mesh)
    try:
        return train_session(dev, cfg, fcfg, True, counters,
                             label="sharded control", mesh=mesh)
    finally:
        C.psum = real


def mesh_epoch_check(dev, fused: dict, sf: dict, sl: dict) -> dict:
    """The reference's own mesh-vs-single-device check
    (``tests/test_sharded_epoch.py``): ONE epoch of each tier from the
    same initial state on the same table and draws (the sessions' tables
    and norm stats, the run's first epoch draws); ``sharded_fused`` within
    params rtol 2e-5 / atol 1e-6, train loss 1e-5, val loss 1e-4 of
    ``fused``, and ``slab_sharded`` equal to ``sharded_fused``."""
    from repro_torch.ml import trainer as tr
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_leaves
    out = {}
    for name, run in (("fused", fused), ("sharded_fused", sf),
                      ("slab_sharded", sl)):
        cfg = run["cfg"]
        tx = opt.adam(cfg.scaled_lr)
        state = tr.init_state(cfg, torch.Generator().manual_seed(cfg.seed),
                              tx, dev)
        draws = next(iter(tr.default_draws(cfg, dev).epochs))
        epoch = tr.EPOCH_BUILDERS[run["tier"]](cfg, run["levels"], tx,
                                               run["spec"])
        state, m = epoch(run["table"], state, draws, *run["norm_stats"])
        out[name] = (state.params, [float(x) for x in m[:2]])
    (p1, m1), (p2, m2), (p3, m3) = out.values()
    if m2 != m3 or not all(torch.equal(a, b) for a, b in
                           zip(tree_leaves(p2), tree_leaves(p3))):
        raise AssertionError("one epoch: slab_sharded != sharded_fused")
    got = divergence(p2, p1, [m2], [m1])
    if not (got["max_excess_over_rtol"] <= MESH_ATOL
            and got["max_rel_train_loss_diff"] <= MESH_TRAIN_RTOL
            and got["max_rel_val_loss_diff"] <= MESH_VAL_RTOL):
        raise AssertionError(f"one epoch: sharded_fused vs fused {got}")
    return got


def transfer_run(dev, cfg, vectorized: bool, counters,
                 deployment=None) -> dict:
    """One ``run_transfer`` on a fresh server (on ``deployment``, default
    local) with a seeded payload: every value read back must equal its
    payload row bit for bit with every ``found`` true; ``op_count`` must be
    2 a step (vectorized) or ``2 · n_ranks`` (per rank), warm-up included;
    the probe kernel must launch exactly once a step on the vectorized path
    and never on the per-rank one, the gather kernel once a step per shard
    of the table on the vectorized path (a local table: one) and never on
    the per-rank one of a local table (``get`` is plain there, as in the
    reference).  Returns each component's mean and std per op, its MB/s
    and the bytes bound of one op (payload read once, written once)."""
    from repro_torch.core import StoreServer
    from repro_torch.sim import reproducer as rp
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = torch.randn((cfg.n_ranks, cfg.elems_per_rank), generator=gen,
                       device=dev)
    server = StoreServer(deployment=deployment, device=dev)
    shards = 1 if deployment is None else deployment.mesh.size
    bad = []

    def on_read(step, values, founds):
        if not (torch.equal(values, data) and bool(founds.all())):
            bad.append(step)

    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    timers = rp.run_transfer(cfg, server, vectorized=vectorized, data=data,
                             on_read=on_read)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in counters}
    steps = cfg.warmup + cfg.iterations
    ops = server.stats()["op_count"]
    mode = "vectorized" if vectorized else "per_rank"
    if bad:
        raise AssertionError(f"run_transfer {mode} at {cfg.bytes_per_rank} "
                             f"B: steps {bad} read back other values")
    if ops != (2 if vectorized else 2 * cfg.n_ranks) * steps:
        raise AssertionError(f"run_transfer {mode}: op_count {ops}")
    if launches != {"probe_slots": steps if vectorized else 0,
                    "gather_rows": shards * steps if vectorized else 0}:
        raise AssertionError(f"run_transfer {mode}: launches {launches}")
    op_bytes = cfg.bytes_per_rank * (cfg.n_ranks if vectorized else 1)
    out = {"mode": mode, "deployment": server.deployment.describe()
           if deployment is not None else "local", "n_ranks": cfg.n_ranks,
           "bytes_per_rank": cfg.bytes_per_rank,
           "iterations": cfg.iterations, "warmup": cfg.warmup,
           "op_count": ops, "launches": launches, "reads_bit_identical": True,
           "bound_ms_per_op": 2 * op_bytes / PEAK_BYTES_PER_S * 1e3}
    for comp, st in timers.summary().items():
        if comp in ("send", "retrieve"):
            out[f"{comp}_ms"] = st["mean_s"] * 1e3
            out[f"{comp}_std_ms"] = st["std_s"] * 1e3
            out[f"{comp}_mb_per_s"] = op_bytes / st["mean_s"] / 1e6
            out[f"{comp}_count"] = st["count"]
    del server, data
    return out


def check_probe_ring(dev, n_ranks: int) -> dict:
    """The probe kernel against its plain version at the reproducer's
    shape: a ring of ``2 · n_ranks`` slots holding two steps, queried for
    the newer step's ``n_ranks`` keys."""
    from repro_torch.core.store import make_key
    from repro_torch.kernels.store import ops, ref
    ranks = torch.arange(n_ranks)
    keys = torch.cat([make_key(ranks, 0), make_key(ranks, 1)]).to(dev)
    version = torch.arange(1, 2 * n_ranks + 1, dtype=torch.int32,
                           device=dev)
    query = make_key(ranks, 1).to(dev)
    idx, found = ops.probe_slots(keys, version, query)
    idx_r, found_r = ref.probe_slots_ref(keys, version, query)
    if not (torch.equal(idx, idx_r) and torch.equal(found, found_r)):
        raise AssertionError(f"probe kernel disagrees: {idx} vs {idx_r}")
    kernel = timed(lambda: ops.probe_slots(keys, version, query), 200)
    plain = timed(lambda: ref.probe_slots_ref(keys, version, query), 200)
    b, by = bound(2 * n_ranks * (8 + 4) + n_ranks * (8 + 4))
    return {"shape": f"capacity={2 * n_ranks} n={n_ranks} (run_transfer)",
            "max_abs_err": 0, **kernel, "plain_ms": plain["ms"],
            "plain_wall_ms": plain["wall_ms"], "library_ms": None,
            "bound_ms": b, "bound_by": by}


def inference_run(dev, params, b: int) -> dict:
    """``run_inference`` with ResNet-50 at batch ``b`` (paper defaults: 2
    warm-up + 40 timed iterations), three-step and fused, and the in-line
    ``apply_resnet50`` call (Fig. 7's three columns): each component's
    mean and std; three-step 4 store ops an iteration, fused none; the
    two paths' outputs within the registry tolerance of each other."""
    from repro_torch.core import StoreServer, Timers
    from repro_torch.core.store import name_key
    from repro_torch.ml.resnet import apply_resnet50
    from repro_torch.sim import reproducer as rp
    gen = torch.Generator(device=dev).manual_seed(SEED + b)
    x = torch.randn((b, 3, 224, 224), generator=gen, device=dev)
    cfg = rp.ReproducerConfig()
    server = StoreServer(device=dev)
    server.set_model("resnet50", rp.fold_registry_axis(apply_resnet50),
                     params)
    out = {"batch": b, "tf32": torch.backends.cudnn.allow_tf32}
    steps = cfg.warmup + cfg.iterations
    for fused in (False, True):
        timers = rp.run_inference(cfg, server, "resnet50", x, fused=fused)
        torch.cuda.synchronize()
        mode = "fused" if fused else "three_step"
        for comp, st in timers.summary().items():
            out[f"{mode}_{comp}_ms"] = st["mean_s"] * 1e3
            out[f"{mode}_{comp}_std_ms"] = st["std_s"] * 1e3
    if server.stats()["op_count"] != 4 * steps:
        raise AssertionError(f"run_inference: {server.stats()}")
    y3 = server.get("infer_out", name_key("y"))[0]
    yf = server.run_model("resnet50", x)
    tol = 1e-4 * (1.0 + float(yf.abs().max()))
    diff = float((y3 - yf).abs().max())
    if tuple(yf.shape) != (b, 1000) or not bool(torch.isfinite(yf).all()) \
            or not diff <= tol:
        raise AssertionError(f"three-step vs fused at b={b}: {diff} > {tol}")
    out["three_step_vs_fused_max_abs"] = diff
    inline = Timers()
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        name = "inline_tf32" if tf32 else "inline"
        for it in range(steps):
            with inline.time(name if it >= cfg.warmup else "warmup") as box:
                box[0] = apply_resnet50(params, x)
    torch.backends.cudnn.allow_tf32 = False
    for name in ("inline", "inline_tf32"):
        st = inline.summary()[name]
        out[f"{name}_ms"] = st["mean_s"] * 1e3
        out[f"{name}_std_ms"] = st["std_s"] * 1e3
    out["bound_ms_fp32"] = 2 * b * resnet50_macs(params, 224) \
        / PEAK_FP32_FLOPS * 1e3
    return out


def resnet50_macs(params, hw: int) -> int:
    """Multiply-adds of one ResNet-50 image of ``hw`` x ``hw`` (SAME
    convolutions: ceil(size / stride) outputs), from the params' shapes."""
    def conv(w, size, stride=1):
        out = -(-size // stride)
        kh, kw, cin, cout = w.shape
        return out * out * kh * kw * cin * cout, out

    macs, size = conv(params["stem"], hw, 2)
    size = -(-size // 2)                      # the max pool
    for s, stage in enumerate(params["stages"]):
        for b, block in enumerate(stage):
            stride = 2 if (b == 0 and s > 0) else 1
            m1, _ = conv(block["conv1"], size)
            m2, out = conv(block["conv2"], size, stride)
            m3, _ = conv(block["conv3"], out)
            mp = conv(block["proj"], size, stride)[0] if "proj" in block \
                else 0
            macs, size = macs + m1 + m2 + m3 + mp, out
    return macs + params["fc"]["w"].numel()


def resnet_card_check(dev, params) -> dict:
    """ResNet-50's logits on the card against the same port function on
    the CPU, TF32 off on both, within ``RESNET_CARD_RTOL`` of max|logits|;
    a stem padded symmetrically (as ``nn.Conv2d(padding=3)`` and
    ``MaxPool2d(3, 2, padding=1)`` pad) must fail it.  The TF32-on
    reading is reported beside it, unchecked."""
    import torch.nn.functional as F
    from repro_torch.ml import resnet
    from repro_torch.tree import tree_map
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 100)
    x = torch.randn((4, 3, 224, 224), generator=gen, device=dev)
    want = resnet.apply_resnet50(tree_map(lambda t: t.cpu(), params),
                                 x.cpu())
    scale = float(want.abs().max())

    def rel(y):
        return float((y.cpu() - want).abs().max()) / scale

    err = rel(resnet.apply_resnet50(params, x))
    h = F.conv2d(x, params["stem"].permute(3, 2, 0, 1), stride=2, padding=3)
    h = F.max_pool2d(F.relu(resnet._bn(h, params["bn_stem"])), 3, 2,
                     padding=1)
    control = rel(resnet._trunk(params, h))
    torch.backends.cudnn.allow_tf32 = True
    err_tf32 = rel(resnet.apply_resnet50(params, x))
    torch.backends.cudnn.allow_tf32 = False
    if not err <= RESNET_CARD_RTOL:
        raise AssertionError(f"ResNet-50 card vs CPU: {err} > "
                             f"{RESNET_CARD_RTOL}")
    if control <= RESNET_CARD_RTOL:
        raise AssertionError(f"symmetric-stem control passed: {control}")
    return {"batch": 4, "max_abs_logit": scale, "rel_err_vs_cpu": err,
            "limit": RESNET_CARD_RTOL, "symmetric_stem_control": control,
            "rel_err_vs_cpu_tf32_on": err_tf32}


def inference_sessions(dev, params) -> dict:
    """ResNet-50 through ``InSituSession`` with one ``InferenceConsumer``
    per tier, the model registered by ``preload``, as
    ``examples/insitu_inference.py`` runs it: each run ``ok``, op_count as
    planned, every output within the registry tolerance of the in-line
    call."""
    from repro_torch.insitu import InferenceConsumer, InSituSession
    from repro_torch.ml.resnet import apply_resnet50
    from repro_torch.sim import reproducer as rp
    gen = torch.Generator(device=dev).manual_seed(SEED + 200)
    x = torch.randn((INFER_BATCH, 3, 224, 224), generator=gen, device=dev)
    want = apply_resnet50(params, x)
    tol = 1e-4 * (1.0 + float(want.abs().max()))
    out = {}
    for tier in ("three_step", "fused_registry"):
        sess = InSituSession(device=dev, components=[InferenceConsumer(
            "resnet50", lambda client, step: x, steps=INFER_STEPS,
            wait_meta=None, tier=tier)])
        plan = sess.plan()
        t0 = time.perf_counter()
        res = sess.run(plan=plan, max_wall_s=600, sequential=True,
                       preload=lambda server: server.set_model(
                           "resnet50", rp.fold_registry_axis(apply_resnet50),
                           params))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not res.ok:
            raise AssertionError({n: c.error
                                  for n, c in res.run.components.items()})
        got = res.output("inference")
        diff = max(float((y - want).abs().max()) for y in got.outputs)
        ops = res.server.stats()["op_count"]
        if got.steps != INFER_STEPS or ops != plan.store_dispatches \
                or not diff <= tol:
            raise AssertionError(f"{tier}: steps {got.steps} op_count {ops} "
                                 f"(plan {plan.store_dispatches}) max err "
                                 f"{diff} > {tol}")
        out[tier] = {"ok": True, "steps": got.steps, "op_count": ops,
                     "max_abs_vs_inline": diff, "wall_s": wall,
                     "verb_mean_ms": {n: t["mean_s"] * 1e3 for n, t in
                                      res.run.timers.summary().items()}}
    return out


def reproducer_phase(dev) -> tuple[list, list, dict]:
    """Phase 15: the paper's reproducer.  Returns the probe's and the
    gather's rows at the reproducer's shapes, with their launches on its
    vectorized path (extra shapes of the kernels line's rows 1 and 3), and
    the default vectorized run's line."""
    from repro_torch.core import StoreServer
    from repro_torch.kernels.store import ops as sops
    from repro_torch.ml.resnet import apply_resnet50, init_resnet50
    from repro_torch.sim.reproducer import ReproducerConfig, run_transfer
    counters = [sops.PROBE, sops.GATHER]
    cfg = ReproducerConfig()
    runs = {"default": transfer_run(dev, cfg, True, counters),
            "default_per_rank": transfer_run(dev, cfg, False, counters)}
    for run in runs.values():
        print(f"[reproducer] transfer {json.dumps(run)}", flush=True)
    sweep = []
    for size in FIG4_SIZES:
        run = transfer_run(dev, replace(cfg, bytes_per_rank=size), True,
                           counters)
        sweep.append(run)
        print(f"[reproducer] fig4 {json.dumps(run)}", flush=True)
        torch.cuda.empty_cache()
    probes = [dict(check_probe_ring(dev, cfg.n_ranks),
                   launches=runs["default"]["launches"]["probe_slots"])]
    gathers = [dict(check_gather(dev, 2 * cfg.n_ranks, cfg.n_ranks,
                                 (size // 4,)),
                    launches=run["launches"]["gather_rows"])
               for size, run in ((cfg.bytes_per_rank, runs["default"]),
                                 (FIG4_SIZES[-1], sweep[-1]))]
    for row in (*probes, *gathers):
        print(f"[reproducer] kernel {json.dumps(row)}", flush=True)
    for size in (cfg.bytes_per_rank, FIG4_SIZES[-1]):
        sized = replace(cfg, bytes_per_rank=size)
        print(f"[reproducer] profile run_transfer at {size} B a rank "
              f"(fresh server and payload, 42 iterations): " + profile(
                  lambda: run_transfer(sized, StoreServer(device=dev)),
                  top=4), flush=True)
        torch.cuda.empty_cache()
    params = init_resnet50(SEED, device=dev)
    infer = []
    for b in FIG7_BATCHES:
        infer.append(inference_run(dev, params, b))
        print(f"[reproducer] fig7 {json.dumps(infer[-1])}", flush=True)
    card = resnet_card_check(dev, params)
    print(f"[reproducer] resnet50 card vs cpu {json.dumps(card)}",
          flush=True)
    sessions = inference_sessions(dev, params)
    print(f"[reproducer] insitu_inference {json.dumps(sessions)}",
          flush=True)
    for b in (1, FIG7_BATCHES[-1]):
        x = torch.randn((b, 3, 224, 224), device=dev)
        apply_resnet50(params, x)
        print(f"[reproducer] profile apply_resnet50 b={b} x10: " + profile(
            lambda: [apply_resnet50(params, x) for _ in range(10)], top=4),
              flush=True)
    del params
    torch.cuda.empty_cache()
    return probes, gathers, runs["default"]


def fd_step_bytes(n: int, iters: int) -> int:
    """The fp32 bytes one FD step must move at the least: u and v read,
    the provisional fields written, read back for the divergence and
    again for the correction, the right-hand side written; each Jacobi
    sweep reads phi and the right-hand side and writes phi; the last phi
    read, u and v written — (12 + 3 · iters) fields of n^2 floats."""
    return (12 + 3 * iters) * n * n * 4


def face_reversed_exchange(mesh):
    """The control's halo exchange: each rank's low face sent to its upper
    neighbour and its high face to its lower one (the faces' directions
    reversed), so every halo holds the wrong rows."""
    from repro_torch.parallel import collectives as C
    from repro_torch.sim import halo as H

    def exchange(blocks, width):
        lo = [b.narrow(0, 0, width) for b in blocks]
        hi = [b.narrow(0, b.shape[0] - width, width) for b in blocks]
        recv_lo = C.ppermute(lo, mesh, H._shift_perm(mesh.size, +1, True))
        recv_hi = C.ppermute(hi, mesh, H._shift_perm(mesh.size, -1, True))
        return [torch.cat([a, b, c]) for a, b, c in zip(recv_lo, blocks,
                                                         recv_hi)]
    return exchange


def colocated_fd_phase(dev, counters) -> tuple[dict, dict, torch.Tensor]:
    """15b. ``[colocated fd]``: the distributed FD producer
    (``sim.distributed``, decaying turbulence from a seeded numpy-free
    draw) at ``FD_N``^2 on ``SHARDS`` space ranks of this card, its
    ``capture_scan_sharded`` puts into a ``Colocated`` ring cut like its
    emission (element dim 1 over ``space``).  Checks, each hard: the
    chunk's counted collectives (``plan(hlo=True)``) equal
    ``sharded_producer_prediction`` (``collective_permute`` > 0, no
    all-gather or all-reduce); op_count == the plan's 3 dispatches, no
    staged transfer, and the run itself (profiled) makes no all-gather or
    all-reduce; a consumer's read of the whole ring (``get_many``, the
    probe once and the gather once per shard, exactly) returns every
    stored snapshot equal to an independent 2-rank re-run of the solver
    bit for bit; that re-run equal to the unsharded step (else within
    ``FD_ATOL``); and, as a control that must fail that limit, one step
    with the halo faces' directions reversed.  Also the gather kernel on a
    shard's rows against its plain version.  Returns the phase's line and
    the gather's row at the shard-local shape, and the ring as read
    (``[clustered fd]`` holds its own ring to it)."""
    from repro_torch.core import Colocated, TableSpec
    from repro_torch.core import store as S
    from repro_torch.insitu import InSituSession, Producer
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import space_mesh
    from repro_torch.sim import distributed as fd
    mesh = space_mesh(SHARDS, devices=[dev] * SHARDS)
    cfg = fd.FDConfig(n=FD_N, nu=FD_NU, dt=FD_DT, jacobi_iters=FD_ITERS)
    noise = fd.draw_noise(cfg, torch.Generator().manual_seed(SEED), dev)
    step_fn, s0, es = fd.make_producer(cfg, mesh,
                                       init="decaying_turbulence",
                                       noise=noise)
    sess = InSituSession(
        tables=[TableSpec("field", shape=(2, FD_N, FD_N), capacity=FD_CAP)],
        components=[Producer(step_fn, table="field", steps=FD_STEPS,
                             chunk=FD_CHUNK, carry=s0, elem_sharding=es)],
        deployment=Colocated(mesh=mesh, elem_spec=(None, "space", None)),
        device=dev)
    t0 = time.perf_counter()
    plan = sess.plan(hlo=True)
    plan_s = time.perf_counter() - t0
    entry = plan.component("producer")
    entry.check_collectives()
    chunk = dict(entry.collectives)
    if entry.tier != "capture_scan_sharded" \
            or not chunk["collective-permute"] > 0 \
            or chunk["all-gather"] or chunk["all-reduce"]:
        raise AssertionError(f"colocated fd: {entry.tier} {chunk}")
    torch.cuda.empty_cache()
    keys = torch.stack([S.make_key(0, t)
                        for t in range(FD_STEPS - FD_CAP, FD_STEPS)])
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the producer's run, then a consumer's read of the whole ring
    with C.counted() as calls:
        res = sess.run(plan=plan, sequential=True, max_wall_s=600)
        stats = res.server.stats()
        values, found = res.server.get_many("field", keys)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in counters}
    peak = torch.cuda.max_memory_allocated()
    if not res.ok:
        raise AssertionError({n: c.error
                              for n, c in res.run.components.items()})
    if not (stats["op_count"] == plan.store_dispatches == 3
            and stats["staged_transfers"] == 0):
        raise AssertionError(f"colocated fd: plan {plan.explain()} vs "
                             f"{stats}")
    # the run's puts and halos make no all-gather; the read makes one
    if calls["all_gather"] != 1 or calls["all_reduce"] != 0 \
            or not calls["collective_permute"] > 0:
        raise AssertionError(f"colocated fd: the run's collectives {calls}")
    if launches != {"probe_slots": 1, "gather_rows": SHARDS,
                    "sample_slots": 0, "quadconv_contract": 0}:
        raise AssertionError(f"colocated fd: launches {launches}")
    if not bool(found.all()):
        raise AssertionError("colocated fd: a stored snapshot is missing")
    # an independent re-run, 2 ranks and unsharded side by side
    sharded, whole = fd.make_step(cfg, mesh), fd.make_step(cfg)
    a, w = s0, fd.decaying_turbulence(cfg, noise)
    bad = []
    for t in range(FD_STEPS):
        a, w = sharded(a), whole(w)
        if t >= FD_STEPS - FD_CAP and not torch.equal(
                values[t - (FD_STEPS - FD_CAP)], fd.snapshot(a)):
            bad.append(t)
    if bad:
        raise AssertionError(f"colocated fd: stored snapshots {bad} differ "
                             f"from the solver's state")
    got = fd.unshard_state(a)
    gap = max(float((got.u - w.u).abs().max()),
              float((got.v - w.v).abs().max()))
    identical = torch.equal(got.u, w.u) and torch.equal(got.v, w.v)
    if not gap <= FD_ATOL:
        raise AssertionError(f"colocated fd: 2-rank vs unsharded {gap}")
    one = fd.unshard_state(sharded(s0))
    wrong_u, _ = fd._advance(cfg, list(s0.u), list(s0.v),
                             face_reversed_exchange(mesh))
    control = float((torch.cat(wrong_u) - one.u).abs().max())
    if not control > FD_ATOL:
        raise AssertionError(f"colocated fd: the reversed-face control "
                             f"passed ({control})")
    if not bool(torch.isfinite(got.u).all() & torch.isfinite(got.v).all()):
        raise AssertionError("colocated fd: the field is not finite")
    del got, w, one, wrong_u
    step_ms = time_ms(lambda: sharded(a), 5, warmup=1)
    wa = fd.unshard_state(a)
    whole_ms = time_ms(lambda: whole(wa), 5, warmup=1)
    del wa
    torch.cuda.synchronize()
    summary = res.run.timers.summary()
    del res
    torch.cuda.empty_cache()
    # the device's idle share over one chunk of the same session (its own
    # server; the profiler's host cost per op is in the window, so this
    # is an upper bound on the unprofiled run's idle share)
    one_chunk = InSituSession(
        tables=[TableSpec("field", shape=(2, FD_N, FD_N), capacity=FD_CAP)],
        components=[Producer(step_fn, table="field", steps=FD_CHUNK,
                             chunk=FD_CHUNK, carry=s0, elem_sharding=es,
                             warmup=False)],
        deployment=Colocated(mesh=mesh, elem_spec=(None, "space", None)),
        device=dev)
    prof = profile(lambda: one_chunk.run(sequential=True, max_wall_s=600))
    del one_chunk
    b, by = bound(fd_step_bytes(FD_N, FD_ITERS))
    row = check_gather(dev, FD_CAP, FD_CAP, (2, FD_N // SHARDS, FD_N))
    row["launches"] = launches["gather_rows"]
    line = {
        "grid": f"{FD_N}^2", "ranks": SHARDS, "nu": FD_NU, "dt": FD_DT,
        "jacobi_iters": FD_ITERS, "steps": FD_STEPS, "chunk": FD_CHUNK,
        "tier": entry.tier, "deployment": plan.deployment,
        "slab_bytes": stats["slab_bytes"]["field"],
        "op_count": stats["op_count"],
        "plan_store_dispatches": plan.store_dispatches,
        "staged_transfers": stats["staged_transfers"],
        "chunk_collectives": chunk,
        "predicted": entry.explain()["predicted_collectives"],
        "run_and_read_collectives": calls, "launches": launches,
        "snapshots_bit_identical": FD_CAP,
        "two_rank_vs_unsharded_max_abs": gap,
        "two_rank_equals_unsharded": identical,
        "reversed_face_control_max_abs": control,
        "step_ms": step_ms, "unsharded_step_ms": whole_ms,
        "step_bound_ms": b, "bound_by": by,
        "step_share_of_bound": b / step_ms,
        "equation_solution_ms_per_step":
            summary["equation_solution"]["total_s"] * 1e3 / FD_STEPS
            if "equation_solution" in summary else None,
        "plan_hlo_s": plan_s, "run_and_read_wall_s": wall,
        "peak_mem_gb": peak / 1e9, "one_chunk_profile": prof}
    del sess, plan, a, s0
    torch.cuda.empty_cache()
    return line, row, values


def colocated_serve_phase(dev, session, preload, local: dict,
                          kernels) -> dict:
    """15a. ``[colocated serve]``: phase 4's serving session (both tiers)
    on ``make_colocated_1d`` over ``SHARDS`` ranks of this card, the
    request [4, 4096] and response [100] elements cut on dim 0, run in
    turns with the local session (local, co-located, co-located, local).
    Every co-located response ``torch.equal`` to phase 4's local run at
    the same tier; plan == ``stats()``; the probe and QuadConv launches
    equal to phase 4's and the gather exactly once per shard per read
    (each drain's and each reader's); the drain's counted collectives
    (``plan(hlo=True)``) held to the port's prediction and printed beside
    the reference's claim; requests/s of every run."""
    from repro_torch.core import make_colocated_1d
    from repro_torch.parallel.sharding import data_mesh
    mesh = data_mesh(SHARDS, devices=[dev] * SHARDS)
    reads = CLIENTS * REQUESTS
    out = {}
    for tier, (want, local_launches) in local.items():
        rates = {"local": [], "colocated": []}
        for colocated in (False, True, True, False):
            sess = session(tier, deployment=make_colocated_1d(mesh=mesh)
                           if colocated else None)
            plan = sess.plan(hlo=colocated)
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sess.run(plan=plan, sequential=True, preload=preload,
                           max_wall_s=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.symbol: k.launches for k in kernels}
            if not res.ok:
                raise AssertionError({n: c.error
                                      for n, c in res.run.components.items()})
            resp = res.output("readers").responses
            rates["colocated" if colocated else "local"].append(
                len(resp) / wall)
            if not colocated:
                continue
            entry = plan.component("serving")
            entry.check_collectives()
            stats = res.server.stats()
            if (stats["op_count"], stats["model_swaps"],
                    stats["staged_transfers"]) != (plan.store_dispatches,
                                                   plan.model_swaps, 0):
                raise AssertionError(f"colocated serve {tier}: plan "
                                     f"{plan.explain()} != stats {stats}")
            if sorted(resp) != sorted(want) \
                    or not all(torch.equal(resp[k], want[k]) for k in want):
                raise AssertionError(f"colocated serve {tier}: responses "
                                     f"differ from the local run's")
            drains = res.output("serving").batches \
                if tier == "continuous_batch" else reads
            expect = {"probe_slots": local_launches["probe_slots"],
                      "gather_rows": SHARDS * (drains + reads),
                      "quadconv_contract":
                          local_launches["quadconv_contract"]}
            if launches != expect:
                raise AssertionError(f"colocated serve {tier}: launches "
                                     f"{launches}, expected {expect}")
            out[tier] = {
                "deployment": plan.deployment, "requests": len(resp),
                "responses_equal_local": True,
                "op_count": stats["op_count"],
                "predicted": plan.store_dispatches, "launches": launches,
                "local_launches": local_launches,
                "drain_collectives": {k: v for k, v in entry.collectives
                                      if v},
                "port_prediction": entry.explain()["predicted_collectives"],
                "reference_claim": "collective-free on every deployment",
                "slab_bytes": stats["slab_bytes"]}
            del res, sess
        out[tier]["requests_per_s"] = rates
    return out


def colocated_transfer_phase(dev, local_default: dict) -> dict:
    """15c. ``[colocated transfer]``: ``run_transfer`` at
    ``ReproducerConfig``'s defaults on ``make_colocated_1d`` over
    ``SHARDS`` ranks of this card (each rank's [32768] half of every
    256 KB row), in turns with the local server (local, co-located,
    co-located, local, three times over): every read bit for bit its
    payload row, as the local server's; the probe once and the gather
    once per shard a step, exactly; ``send`` / ``retrieve`` ms an op of
    every run, the ratio of the co-located runs' median to the local
    runs', and phase ``[reproducer]``'s local numbers beside them."""
    from repro_torch.core import make_colocated_1d
    from repro_torch.kernels.store import ops as sops
    from repro_torch.parallel.sharding import data_mesh
    from repro_torch.sim.reproducer import ReproducerConfig
    counters = [sops.PROBE, sops.GATHER]
    cfg = ReproducerConfig()
    mesh = data_mesh(SHARDS, devices=[dev] * SHARDS)
    runs = {False: [], True: []}
    for colocated in (False, True, True, False) * 3:
        runs[colocated].append(transfer_run(
            dev, cfg, True, counters,
            make_colocated_1d(mesh=mesh) if colocated else None))
    keys = ("send_ms", "retrieve_ms", "op_count", "launches")
    ratio = {f"{k}_median_ratio": statistics.median(r[k] for r in runs[True])
             / statistics.median(r[k] for r in runs[False])
             for k in ("send_ms", "retrieve_ms")}
    return {"colocated": [{k: r[k] for k in keys} for r in runs[True]],
            "local_in_turn": [{k: r[k] for k in keys} for r in runs[False]],
            **ratio,
            "reproducer_phase_local": {k: local_default[k] for k in keys},
            "reads_bit_identical": True,
            "deployment": runs[True][0]["deployment"]}


def clustered_fd_session(dev, overlap: bool, steps: int = FD_STEPS,
                         faults=None, warmup: bool = True):
    """The ``[colocated fd]`` producer into a CLUSTERED ring: 4 ranks on
    this card split 2 client (the producer's ``space`` mesh) + 2 db (the
    ring, each element cut on dim 1 over them, ``fan_in`` 1).  Returns
    the session and the producer's first state."""
    from repro_torch.core import TableSpec, make_clustered_1d
    from repro_torch.insitu import InSituSession, Producer
    from repro_torch.sim import distributed as fd
    d = make_clustered_1d(db_fraction=0.5, axis="space",
                          devices=[dev] * (2 * SHARDS),
                          elem_spec=(None, "space", None), overlap=overlap,
                          faults=faults)
    cfg = fd.FDConfig(n=FD_N, nu=FD_NU, dt=FD_DT, jacobi_iters=FD_ITERS)
    noise = fd.draw_noise(cfg, torch.Generator().manual_seed(SEED), dev)
    step_fn, s0, es = fd.make_producer(cfg, d.client_mesh,
                                       init="decaying_turbulence",
                                       noise=noise)
    sess = InSituSession(
        tables=[TableSpec("field", shape=(2, FD_N, FD_N), capacity=FD_CAP)],
        components=[Producer(step_fn, table="field", steps=steps,
                             chunk=FD_CHUNK, carry=s0, elem_sharding=es,
                             warmup=warmup)],
        deployment=d, device=dev)
    return sess, s0, cfg, d


def clustered_fd_phase(dev, counters, colocated_ring) -> dict:
    """``[clustered fd]``: the halo-exchanged FD producer of ``[colocated
    fd]`` (4,096², 48 steps in chunks of 16, tier
    ``capture_scan_sharded``) into a clustered ring of 16 [2, 4096, 4096]
    fp32 snapshots on 2 db ranks of this card: overlap on and off in ABBA
    turns, then overlap on under a ``FaultPlan`` that drops the second
    staged transfer.  Checks, each hard: staged transfers == the
    plan's (3 chunk stages, plus the simulator's one restage on the
    faulted run); op_count == the plan (the overlap's one drain, the
    faulted run's drain-on-restage); a chunk's counted collectives
    (``plan(hlo=True)``: collect, stage and insert) are the halo's
    ``collective_permute`` and nothing else; a read of the whole ring
    (probe once, the gather once per db shard) equals ``[colocated fd]``'s
    ring and a fresh 2-rank solver run bit for bit; the runs'
    tables ``torch.equal``; and, as a control that must fail, a staging
    pipeline that inserts each new chunk before the in-flight one leaves
    a different table.  Times: ms a step, a staged chunk (16 snapshots of
    128 MiB, 2.15 GB; CUDA events) against its bytes bound, the share of
    the staging that the overlap hides (the serial runs' mean producer
    wall less the overlapped runs', against the three staged copies'
    time), the device's idle share (a profiled 2-chunk run), peak
    memory."""
    from repro_torch.core import client as client_mod
    from repro_torch.core import store as S
    from repro_torch.core.deployment import StagingPipeline
    from repro_torch.core.faults import FaultEvent, FaultPlan, RetryPolicy
    from repro_torch.parallel import collectives as C
    from repro_torch.sim import distributed as fd
    keys = torch.stack([S.make_key(0, t)
                        for t in range(FD_STEPS - FD_CAP, FD_STEPS)])
    drop = FaultPlan(events=(FaultEvent("drop_chunk", table="field", at=1),),
                     retry=RetryPolicy(interval=1e-4, max_interval=1e-3))
    runs, first, line = {}, None, {}
    # overlap and serial in ABBA turns, then the faulted run
    for label, overlap, faults in (("overlap", True, None),
                                   ("serial", False, None),
                                   ("serial 2", False, None),
                                   ("overlap 2", True, None),
                                   ("overlap, dropped transfer", True, drop)):
        sess, s0, cfg, d = clustered_fd_session(dev, overlap, faults=faults)
        plan = sess.plan(hlo=label == "overlap")
        entry = plan.component("producer")
        for k in counters:
            k.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = sess.run(plan=plan, sequential=True, max_wall_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if not res.ok:
            raise AssertionError({n: c.error
                                  for n, c in res.run.components.items()})
        stats = res.server.stats()
        want_staged = 3 + (faults is not None)
        if not (stats["op_count"] == plan.store_dispatches
                and stats["staged_transfers"] == plan.staged_transfers
                == want_staged
                and dict(entry.staged).get("chunk_stage") == 3
                and dict(entry.dispatches).get("drain", 0) == int(overlap)):
            raise AssertionError(f"clustered fd {label}: plan "
                                 f"{plan.explain()} vs {stats}")
        if label == "overlap":
            chunk = dict(entry.collectives)
            if entry.tier != "capture_scan_sharded" \
                    or not chunk["collective-permute"] > 0 \
                    or any(v for k, v in chunk.items()
                           if k != "collective-permute"):
                raise AssertionError(f"clustered fd: a chunk's "
                                     f"collectives {chunk}")
            line["chunk_collectives"] = chunk
            line["reference_claim"] = entry.predicted_collectives
            for k in counters:
                k.launches = 0
            with C.counted() as calls:
                values, found = res.server.get_many("field", keys)
            torch.cuda.synchronize()
            launches = {k.symbol: k.launches for k in counters}
            if launches != {"probe_slots": 1, "gather_rows": SHARDS,
                            "sample_slots": 0, "quadconv_contract": 0} \
                    or calls["all_gather"] != 1 or not bool(found.all()):
                raise AssertionError(f"clustered fd: the read {launches} "
                                     f"{calls}")
            if not torch.equal(values, colocated_ring):
                raise AssertionError("clustered fd: the ring differs from "
                                     "[colocated fd]'s")
            sharded = fd.make_step(cfg, d.client_mesh)
            a, bad = s0, []
            for t in range(FD_STEPS):
                a = sharded(a)
                if t >= FD_STEPS - FD_CAP and not torch.equal(
                        values[t - (FD_STEPS - FD_CAP)], fd.snapshot(a)):
                    bad.append(t)
            if bad:
                raise AssertionError(f"clustered fd: snapshots {bad} differ "
                                     f"from the solver's state")
            del values, a
            line["read_launches"] = launches
            first = res.server.checkout("field")
        elif not equal_tables(first, res.server.checkout("field")):
            raise AssertionError(f"clustered fd {label}: the table differs "
                                 f"from the overlapped run's")
        summary = res.run.timers.summary()
        runs[label] = {
            "op_count": stats["op_count"],
            "plan_store_dispatches": plan.store_dispatches,
            "staged_transfers": stats["staged_transfers"],
            "plan_staged": dict(entry.staged),
            "dispatch_detail": dict(entry.dispatches),
            "retries": res.retries, "wall_s": wall,
            "producer_wall_s": res.run.components["producer"].wall_s,
            "ms_per_step": res.run.components["producer"].wall_s * 1e3
            / FD_STEPS,
            "send_ms_total": summary["send"]["total_s"] * 1e3
            if "send" in summary else None,
            "peak_mem_gb": peak / 1e9}
        del res, sess, plan
    del first
    torch.cuda.empty_cache()
    # the control: each new chunk inserted before the in-flight one
    class Reordered(StagingPipeline):
        def swap(self, staged):
            if self._in_flight is None:
                self._in_flight = staged
                return None
            return staged

    real = client_mod.StagingPipeline
    client_mod.StagingPipeline = Reordered
    try:
        sess, *_ = clustered_fd_session(dev, True, warmup=False)
        res = sess.run(sequential=True, max_wall_s=600)
    finally:
        client_mod.StagingPipeline = real
    if not res.ok:
        raise AssertionError("clustered fd control did not run")
    ctl_vals, ctl_found = res.server.get_many("field", keys)
    if bool(ctl_found.all()) and torch.equal(ctl_vals, colocated_ring):
        raise AssertionError("clustered fd: the reordered-pipeline control "
                             "passed")
    line["reordered_pipeline_control"] = {
        "newest_chunk_found": int(ctl_found.sum()), "of": FD_CAP,
        "failed": True}
    del res, sess, ctl_vals
    torch.cuda.empty_cache()
    # one staged chunk's copies, alone: serial (current stream) and on
    # the staging stream, against the bytes bound (read + write once)
    sess, s0, cfg, d = clustered_fd_session(dev, True)
    spec = sess.tables[0]
    from repro_torch.parallel.sharding import ElemSharding, ElemShards
    layout = ElemSharding(d.client_mesh, (None, "space", None))
    blocks = tuple(torch.randn(FD_CHUNK, 2, FD_N // SHARDS, FD_N,
                               device=dev) for _ in range(SHARDS))
    chunk_v = ElemShards(blocks, layout)
    k = torch.arange(FD_CHUNK, device=dev)
    m = torch.ones(FD_CHUNK, dtype=torch.bool, device=dev)
    nbytes = sum(b.numel() * 4 for b in blocks)
    staged = d.stage_chunk(k, chunk_v, m, spec)
    if not all(torch.equal(a, b) for a, b in zip(staged.values.blocks,
                                                 blocks)):
        raise AssertionError("clustered fd: a staged chunk differs")
    del staged
    serial_ms = time_ms(lambda: d.stage_chunk(k, chunk_v, m, spec), 10)

    def async_stage():
        d.stage_chunk(k, chunk_v, m, spec, donate=True).wait()

    stream_ms = time_ms(async_stage, 10)
    b, by = bound(2 * nbytes)
    del blocks, chunk_v
    torch.cuda.empty_cache()
    # the idle share: a 2-chunk overlapped run, profiled
    two, *_ = clustered_fd_session(dev, True, steps=2 * FD_CHUNK,
                                   warmup=False)
    prof = profile(lambda: two.run(sequential=True, max_wall_s=600))
    del two, sess
    torch.cuda.empty_cache()
    hidden = statistics.mean(runs[k]["producer_wall_s"]
                             for k in ("serial", "serial 2")) \
        - statistics.mean(runs[k]["producer_wall_s"]
                          for k in ("overlap", "overlap 2"))
    line.update({
        "grid": f"{FD_N}^2", "client_ranks": SHARDS, "db_ranks": SHARDS,
        "fan_in": d.fan_in, "deployment": d.describe(),
        "steps": FD_STEPS, "chunk": FD_CHUNK, "runs": runs,
        "snapshots_bit_identical": FD_CAP,
        "tables_equal_across_runs": True,
        "staged_chunk": {"bytes": nbytes, "serial_ms": serial_ms,
                         "staging_stream_ms": stream_ms, "bound_ms": b,
                         "bound_by": by,
                         "share_of_bound": b / serial_ms},
        "overlap_hidden_ms": hidden * 1e3,
        "staged_copies_ms": 3 * serial_ms,
        "overlap_hidden_share": hidden * 1e3 / (3 * serial_ms),
        "two_chunk_profile": prof})
    return line


def clustered_train_phase(dev, cfg, fcfg, counters, slab: dict) -> dict:
    """``[clustered train]``: phase 8's in-situ workflow with the trainer
    on a 2-rank client mesh and the table slot-partitioned on
    ``Clustered(slab_axis="data")``'s 2-rank db mesh (4 ranks on this
    card): tier ``slab_sharded_clustered``.  Checks, each hard: the
    trained params and every epoch's losses ``torch.equal`` to
    ``[sharded]``'s ``slab_sharded`` run (the same draws, the same rows);
    ``gather_stage`` == epochs, and the run's staged transfers and
    op_count == the plan; the sharded gather once per db shard per
    staged gather and the bootstrap (no warm-up gather), the sample
    kernel once per gather, QuadConv's launches equal to ``slab_sharded``'s;
    an epoch's counted collectives (``plan(hlo=True)``) as predicted.
    Prints the epoch ms beside ``slab_sharded``'s."""
    from repro_torch.core import make_clustered_1d
    from repro_torch.tree import tree_leaves
    d = make_clustered_1d(db_fraction=0.5, devices=[dev] * (2 * SHARDS),
                          slab_axis="data")
    run = train_session(dev, cfg, fcfg, True, counters, label="clustered",
                        mesh=d.client_mesh, slab_sharded=True, deployment=d,
                        hlo=True)
    plan, stats = run["plan"], run["stats"]
    trainer = plan.component("trainer")
    trainer.check_collectives()
    coll = dict(trainer.collectives)
    if run["tier"] != "slab_sharded_clustered" or coll["all-gather"] \
            or not coll["all-reduce"] > 0:
        raise AssertionError(f"clustered train: {run['tier']} {coll}")
    if dict(trainer.staged) != {"gather_stage": EPOCHS} \
            or stats["staged_transfers"] != plan.staged_transfers \
            or run["staged_delta"]["trainer"] != EPOCHS:
        raise AssertionError(f"clustered train: staged {stats} vs "
                             f"{plan.explain()}")
    gathers = run["trainer_ops"]          # the epochs and the bootstrap
    want = {"gather_rows_sharded": SHARDS * gathers,
            "sample_slots": gathers,
            "quadconv_contract": slab["launches"]["quadconv_contract"]}
    got = {k: run["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"clustered train: launches {got}, expected "
                             f"{want}")
    if not all(torch.equal(a, b) for a, b in
               zip(tree_leaves(run["state"]), tree_leaves(slab["state"]))) \
            or [(h.train_loss, h.val_loss) for h in run["history"]] \
            != [(h.train_loss, h.val_loss) for h in slab["history"]]:
        raise AssertionError("clustered train: params or losses differ "
                             "from slab_sharded's")
    return {"tier": run["tier"], "deployment": plan.deployment,
            "op_count": stats["op_count"],
            "plan_store_dispatches": plan.store_dispatches,
            "staged_transfers": stats["staged_transfers"],
            "plan_staged": {e.name: dict(e.staged)
                            for e in plan.components if e.staged},
            "launches": run["launches"], "epoch_collectives": coll,
            "equal_to_slab_sharded": True,
            "epoch_ms": run["epoch_ms"],
            "slab_sharded_epoch_ms": slab["epoch_ms"],
            "peak_gb": run["peak_gb"], "wall_s": run["wall_s"],
            "slab_sharded_wall_s": slab["wall_s"]}


def clustered_serve_phase(dev, session, preload, local: dict,
                          kernels) -> dict:
    """``[clustered serve]``: phase 4's serving session (both tiers) on
    ``make_clustered_1d(db_fraction=0.5)`` over 2 ranks of this card (one
    client, one db), in turns with the local session (local, clustered,
    clustered, local).  Every clustered response ``torch.equal`` to phase
    4's local run at the same tier; plan == ``stats()``; ``request_stage``
    32 at both tiers and ``response_stage`` 32 at ``three_step`` only; the
    probe, gather and QuadConv launches equal to phase 4's; requests/s
    of every run."""
    from repro_torch.core import make_clustered_1d
    out = {}
    for tier, (want, local_launches) in local.items():
        rates = {"local": [], "clustered": []}
        for clustered in (False, True, True, False):
            sess = session(tier, deployment=make_clustered_1d(
                db_fraction=0.5, devices=[dev] * 2) if clustered else None)
            plan = sess.plan()
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sess.run(plan=plan, sequential=True, preload=preload,
                           max_wall_s=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.symbol: k.launches for k in kernels}
            if not res.ok:
                raise AssertionError({n: c.error
                                      for n, c in res.run.components.items()})
            resp = res.output("readers").responses
            rates["clustered" if clustered else "local"].append(
                len(resp) / wall)
            if not clustered:
                continue
            stats = res.server.stats()
            staged = {e.name: dict(e.staged) for e in plan.components
                      if e.staged}
            want_staged = {"writers": {"request_stage": CLIENTS * REQUESTS}}
            if tier == "three_step":
                want_staged["serving"] = {
                    "response_stage": CLIENTS * REQUESTS}
            if (stats["op_count"], stats["model_swaps"],
                    stats["staged_transfers"]) != (
                        plan.store_dispatches, plan.model_swaps,
                        plan.staged_transfers) or staged != want_staged \
                    or any(res.staged_delta(e.name) != e.staged_transfers
                           for e in plan.components):
                raise AssertionError(f"clustered serve {tier}: plan "
                                     f"{plan.explain()} != stats {stats}")
            if sorted(resp) != sorted(want) \
                    or not all(torch.equal(resp[k], want[k]) for k in want):
                raise AssertionError(f"clustered serve {tier}: responses "
                                     f"differ from the local run's")
            if launches != local_launches:
                raise AssertionError(f"clustered serve {tier}: launches "
                                     f"{launches}, local {local_launches}")
            out[tier] = {
                "deployment": plan.deployment, "requests": len(resp),
                "responses_equal_local": True,
                "op_count": stats["op_count"],
                "predicted": plan.store_dispatches,
                "staged_transfers": stats["staged_transfers"],
                "plan_staged": staged, "launches": launches}
            del res, sess
        out[tier]["requests_per_s"] = rates
    return out


def fan_in_scenario(dev) -> dict:
    """The paper's fan-in scenario, ungated but for its counts: the fused
    256 KB-a-rank producer of ``benchmarks/fig5_weak_scaling.py``'s
    clustered child (capacity 16, ``emit_every`` 1, 256 steps in chunks
    of 16) at the ``db_fraction``s that give ``fan_in`` 1, 2 and 3 over 8
    ranks of this card, overlap on and off, best of two runs each; the
    staged and op counts held to the plan; the ``ContentionModel`` fitted
    over the overlapped cells, its residual, and ``autotune_chunk``'s
    choice."""
    from repro_torch.core import TableSpec, make_clustered_1d
    from repro_torch.core import store as S
    from repro_torch.insitu import InSituSession, Producer
    from repro_torch.insitu import plan as P
    steps, chunk, msg = 256, 16, 256 * 1024
    snap = torch.randn(msg // 4, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)

    def step(carry, rank, t):
        return carry + 1.0, S.make_key(rank, t), snap * carry

    cells = []
    for frac in (0.5, 0.375, 0.25):
        for overlap in (True, False):
            d = make_clustered_1d(db_fraction=frac, devices=[dev] * 8,
                                  overlap=overlap)
            walls = []
            for _ in range(2):
                sess = InSituSession(
                    tables=[TableSpec("field", shape=(msg // 4,),
                                      capacity=16)],
                    components=[Producer(step, table="field", steps=steps,
                                         carry=torch.zeros((), device=dev),
                                         chunk=chunk)],
                    deployment=d, device=dev)
                plan = sess.plan()
                res = sess.run(plan=plan, sequential=True, max_wall_s=600)
                torch.cuda.synchronize()
                if not res.ok:
                    raise AssertionError("fan-in scenario did not run")
                t = res.run.timers
                walls.append(t.total("equation_solution") + t.total("send"))
                stats = res.server.stats()
                if (stats["op_count"], stats["staged_transfers"]) != (
                        plan.store_dispatches, plan.staged_transfers) \
                        or plan.staged_transfers != steps // chunk:
                    raise AssertionError(f"fan-in {d.fan_in}: {stats} vs "
                                         f"{plan.explain()}")
            cells.append({"fan_in": d.fan_in, "overlap": overlap,
                          "clients": d.client_mesh.size,
                          "db": d.db_mesh.size,
                          "steps_per_s": steps / min(walls),
                          "step_bytes": msg,
                          "dispatch_s": t.total("send")
                          / max(1, stats["op_count"]),
                          "staged_transfers": stats["staged_transfers"],
                          "op_count": stats["op_count"]})
    fit_cells = [c for c in cells if c["overlap"]]
    model = P.ContentionModel.fit(fit_cells)
    model = P.ContentionModel(model.t_base, model.k_fanin, model.step_bytes,
                              t_dispatch=statistics.mean(
                                  c["dispatch_s"] for c in fit_cells))
    return {"cells": cells,
            "model": {"t_base_s": model.t_base, "k_fanin_s": model.k_fanin,
                      "t_dispatch_s": model.t_dispatch},
            "residual": model.residual(fit_cells),
            "autotune_chunk": {f: P.autotune_chunk(1, model, steps=steps,
                                                   fan_in=f)
                               for f in (1, 2, 3)}}


def clustered_2d_session(dev, overlap: bool = True, steps: int = FD_STEPS,
                         warmup: bool = True, deployment=None):
    """``[clustered fd]``'s producer into a ring on a 2-D ``(slab, space)``
    db grid (``fig_turbulence``'s deployment): 6 ranks on this card, 2
    client (the producer's ``space`` mesh) + 4 db as a 2 x 2 grid
    (``make_clustered_2d``: slots cut over ``slab``, each element's dim 1
    over ``space``).  Returns the session, the producer's first state, its
    config and the deployment."""
    from repro_torch.core import TableSpec, make_clustered_2d
    from repro_torch.insitu import InSituSession, Producer
    from repro_torch.sim import distributed as fd
    d = deployment or make_clustered_2d(
        (None, "space", None), db_fraction=2 / 3,
        devices=[dev] * (3 * SHARDS), overlap=overlap)
    cfg = fd.FDConfig(n=FD_N, nu=FD_NU, dt=FD_DT, jacobi_iters=FD_ITERS)
    noise = fd.draw_noise(cfg, torch.Generator().manual_seed(SEED), dev)
    step_fn, s0, es = fd.make_producer(cfg, d.client_mesh,
                                       init="decaying_turbulence",
                                       noise=noise)
    sess = InSituSession(
        tables=[TableSpec("field", shape=(2, FD_N, FD_N), capacity=FD_CAP)],
        components=[Producer(step_fn, table="field", steps=steps,
                             chunk=FD_CHUNK, carry=s0, elem_sharding=es,
                             warmup=warmup)],
        deployment=d, device=dev)
    return sess, s0, cfg, d


def clustered_2d_phase(dev, counters, colocated_ring) -> dict:
    """16a. ``[clustered2d fd]``: ``fig_turbulence``'s scenario at full
    size, ``[clustered fd]``'s producer (4,096², 2 client ``space`` ranks,
    48 steps in chunks of 16) into a ring of 16 [2, 4096, 4096] fp32
    snapshots on a 2 x 2 ``(slab, space)`` db grid, overlap on and off.
    Checks, each hard: staged transfers == the plan's, one a chunk;
    op_count == the plan; the put path makes no all-gather or all-reduce
    (the halo's ``collective_permute`` only); a read of the whole ring
    launches the probe once and the gather once a db shard (4), with one
    grouped all-gather and one grouped psum, and equals ``[colocated
    fd]``'s ring and the solver's own snapshots bit for bit; the two
    runs' tables equal; the gather kernel on a grid shard against its
    plain version.  Controls that must fail: a deployment that stages
    each db rank the block of its SLAB coordinate (the element layout's
    axes swapped) makes the insert all-gather; a read that skips one
    column's all-gather differs.  Times: ms a step, a staged chunk (each
    of the 4 db ranks copying its half of the 16 snapshots) against its
    bytes bound, peak memory."""
    from repro_torch.core import make_clustered_2d
    from repro_torch.core import store as S
    from repro_torch.core.deployment import Clustered
    from repro_torch.kernels.store import ops as sops
    from repro_torch.kernels.store import ref as sref
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import ElemSharding, ElemShards
    from repro_torch.sim import distributed as fd
    keys = torch.stack([S.make_key(0, t)
                        for t in range(FD_STEPS - FD_CAP, FD_STEPS)])
    db = 2 * SHARDS
    runs, line, first = {}, {}, None
    for label, overlap in (("overlap", True), ("serial", False)):
        sess, s0, cfg, d = clustered_2d_session(dev, overlap)
        plan = sess.plan(hlo=overlap)
        entry = plan.component("producer")
        for k in counters:
            k.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with C.counted() as put_calls:
            res = sess.run(plan=plan, sequential=True, max_wall_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if not res.ok:
            raise AssertionError({n: c.error
                                  for n, c in res.run.components.items()})
        stats = res.server.stats()
        chunks = -(-FD_STEPS // FD_CHUNK)
        if not (stats["op_count"] == plan.store_dispatches
                and stats["staged_transfers"] == plan.staged_transfers
                == chunks
                and dict(entry.staged).get("chunk_stage") == chunks
                and dict(entry.dispatches).get("drain", 0) == int(overlap)):
            raise AssertionError(f"clustered2d fd {label}: plan "
                                 f"{plan.explain()} vs {stats}")
        if put_calls["all_gather"] or put_calls["all_reduce"] \
                or not put_calls["collective_permute"]:
            raise AssertionError(f"clustered2d fd {label}: the put path's "
                                 f"collectives {put_calls}")
        table = res.server.checkout("field")
        if type(table.slab) is not S.GridSlab:
            raise AssertionError(f"clustered2d fd: a {type(table.slab)}")
        if overlap:
            chunk = dict(entry.collectives)
            if entry.tier != "capture_scan_sharded" \
                    or any(v for k, v in chunk.items()
                           if k != "collective-permute"):
                raise AssertionError(f"clustered2d fd: a chunk's "
                                     f"collectives {chunk}")
            line["chunk_collectives"] = chunk
            for k in counters:
                k.launches = 0
            with C.counted() as calls:
                values, found = res.server.get_many("field", keys)
            torch.cuda.synchronize()
            launches = {k.symbol: k.launches for k in counters}
            want = {k.symbol: 0 for k in counters}
            want.update({"probe_slots": 1, "gather_rows": db})
            if launches != want or calls["all_gather"] != 1 \
                    or calls["all_reduce"] != 1 or not bool(found.all()):
                raise AssertionError(f"clustered2d fd: the read {launches} "
                                     f"{calls}")
            if not torch.equal(values, colocated_ring):
                raise AssertionError("clustered2d fd: the ring differs from "
                                     "[colocated fd]'s")
            sharded = fd.make_step(cfg, d.client_mesh)
            a, bad = s0, []
            for t in range(FD_STEPS):
                a = sharded(a)
                if t >= FD_STEPS - FD_CAP and not torch.equal(
                        values[t - (FD_STEPS - FD_CAP)], fd.snapshot(a)):
                    bad.append(t)
            if bad:
                raise AssertionError(f"clustered2d fd: snapshots {bad} "
                                     f"differ from the solver's state")
            del a
            # the gather kernel on a grid shard, against its plain version
            shard = table.slab.shards[db - 1]
            local = torch.arange(shard.shape[0] - 1, -1, -1, dtype=torch.int32,
                                 device=dev)
            if not torch.equal(sops.gather_rows(shard, local),
                               sref.gather_rows_ref(shard, local)):
                raise AssertionError("clustered2d fd: the gather kernel "
                                     "differs from its plain version on a "
                                     "grid shard")
            # the control: a read that drops column 1's blocks
            real = C.all_gather

            def skip_one(blocks, mesh, dim=0, axis=None):
                if axis == "space":
                    blocks = [torch.zeros_like(b)
                              if mesh.coord(r, "space") == 1 else b
                              for r, b in enumerate(blocks)]
                return real(blocks, mesh, dim=dim, axis=axis)

            C.all_gather = skip_one
            try:
                broken, _ = res.server.get_many("field", keys)
            finally:
                C.all_gather = real
            if torch.equal(broken, colocated_ring):
                raise AssertionError("clustered2d fd: the read without one "
                                     "column's all-gather passed")
            del values, broken
            line["read_launches"] = launches
            line["read_collectives"] = {k: v for k, v in calls.items() if v}
            line["slab_bytes_per_rank"] = stats["slab_bytes"]["field"]
            first = table
        elif not equal_tables(first, table):
            raise AssertionError("clustered2d fd: the serial run's table "
                                 "differs from the overlapped run's")
        runs[label] = {
            "op_count": stats["op_count"],
            "plan_store_dispatches": plan.store_dispatches,
            "staged_transfers": stats["staged_transfers"],
            "plan_staged": dict(entry.staged),
            "dispatch_detail": dict(entry.dispatches),
            "put_path_collectives": {k: v for k, v in put_calls.items()
                                     if v},
            "wall_s": wall,
            "ms_per_step": res.run.components["producer"].wall_s * 1e3
            / FD_STEPS,
            "peak_mem_gb": peak / 1e9}
        del res, sess, plan, table
    del first
    torch.cuda.empty_cache()

    # the control: the element layout's axes swapped in the staging
    class Swapped(Clustered):
        def _place(self, x, layout, lead, copier):
            if layout.axis == "space":
                layout = ElemSharding(self.db_mesh, tuple(
                    "slab" if e == "space" else e for e in layout.spec))
            return super()._place(x, layout, lead, copier)

    d = make_clustered_2d((None, "space", None), db_fraction=2 / 3,
                          devices=[dev] * (3 * SHARDS))
    swapped = Swapped(client_mesh=d.client_mesh, db_mesh=d.db_mesh,
                      elem_spec=d.elem_spec, slab_axis=d.slab_axis)
    sess, *_ = clustered_2d_session(dev, steps=FD_CHUNK, warmup=False,
                                    deployment=swapped)
    with C.counted() as ctl_calls:
        res = sess.run(sequential=True, max_wall_s=600)
    if not res.ok or not ctl_calls["all_gather"]:
        raise AssertionError(f"clustered2d fd: the swapped-layout control "
                             f"kept the put path collective-free "
                             f"({ctl_calls}, ok={res.ok})")
    line["swapped_layout_control"] = {"put_path_all_gathers":
                                      ctl_calls["all_gather"],
                                      "failed": True}
    line["skipped_column_control"] = {"failed": True}
    del res, sess
    torch.cuda.empty_cache()
    # one staged chunk, alone: each db rank copies the half of the 16
    # snapshots its space coordinate names (read once a rank, written once)
    sess, s0, cfg, d = clustered_2d_session(dev)
    spec = sess.tables[0]
    layout = ElemSharding(d.client_mesh, (None, "space", None))
    blocks = tuple(torch.randn(FD_CHUNK, 2, FD_N // SHARDS, FD_N,
                               device=dev) for _ in range(SHARDS))
    chunk_v = ElemShards(blocks, layout)
    k = torch.arange(FD_CHUNK, device=dev)
    m = torch.ones(FD_CHUNK, dtype=torch.bool, device=dev)
    staged = d.stage_chunk(k, chunk_v, m, spec)
    grid = staged.values.placement
    if not all(torch.equal(b, blocks[grid.block_of(r)])
               for r, b in enumerate(staged.values.blocks)):
        raise AssertionError("clustered2d fd: a staged chunk differs")
    moved = sum(b.numel() * 4 for b in staged.values.blocks)
    del staged
    serial_ms = time_ms(lambda: d.stage_chunk(k, chunk_v, m, spec), 10)
    b, by = bound(2 * moved)
    del blocks, chunk_v, sess
    torch.cuda.empty_cache()
    line.update({
        "grid": f"{FD_N}^2", "client_ranks": SHARDS,
        "db_grid": d.db_mesh.shape, "deployment": d.describe(),
        "steps": FD_STEPS, "chunk": FD_CHUNK, "runs": runs,
        "ring_equal_to_colocated_fd": True,
        "snapshots_bit_identical": FD_CAP,
        "staged_chunk": {"bytes_copied": moved, "ms": serial_ms,
                         "bound_ms": b, "bound_by": by,
                         "share_of_bound": b / serial_ms}})
    return line


def consumers_phase(dev, cfg, fcfg, counters, sharded: dict,
                    fused: dict) -> dict:
    """16b. ``[consumers]``: phase 8's workflow with
    ``TrainerConsumer(count=2)`` on a pool of 4 ranks of this card
    (``devices=[card] * 4``): two ``sharded_fused`` replicas on disjoint
    2-rank meshes, seeds ``SEED`` and ``SEED + 1``.  Checks, each hard:
    the plan's names, tiers and mesh sizes; op_count == the plan and each
    entry's ``op_delta`` == its prediction; each replica's sample, gather
    and QuadConv launches exactly (epochs + the warm-up + replica 0's
    bootstrap; 4 QuadConv forwards a rank a microstep and 4 a
    validation); the replicas' params differ; replica 0 (seed and draws
    of ``[sharded]``'s run, the same mesh shape) ``torch.equal`` to that
    run.  Control: the replicas given replica 0's mesh (``cfg.mesh`` set
    with ``count=2``) raise, as the reference does.  Then the launcher
    with ``consumers=2`` on its default pool of one card: two ``fused``
    replicas, plan == ``stats()``.  Prints each replica's epoch ms beside
    phase 8's."""
    from repro_torch.core import TableSpec
    from repro_torch.core import store as S
    from repro_torch.insitu import (InferenceConsumer, InSituSession,
                                    Producer, TrainerConsumer)
    from repro_torch.launch import insitu as launcher
    from repro_torch.ml import trainer as tr
    from repro_torch.parallel.sharding import disjoint_data_meshes
    from repro_torch.sim import flatplate as fp
    from repro_torch.tree import tree_leaves
    gen = torch.Generator().manual_seed(SEED)
    modes = fp.draw_modes(fcfg, gen, dev)
    inf_modes = fp.draw_modes(fcfg, gen, dev)
    coords = fp.grid_coords(fcfg, dev)
    tcfg = tr.TrainerConfig(ae=cfg, epochs=EPOCHS, gather=GATHER,
                            batch_size=BATCH, lr=1e-3, seed=SEED)
    pool = [dev] * (2 * SHARDS)
    marks, events = [], []

    def timed(epochs):
        for d in epochs:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append([ev])
            yield d

    def on_epoch(r):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1].append(ev)
        marks.append({k.symbol: k.launches for k in counters})

    draws = []
    for i in range(2):
        d = tr.default_draws(replace(tcfg, seed=SEED + i), dev)
        draws.append(tr.TrainDraws(d.bootstrap, timed(d.epochs)))

    def step_fn(carry, rank, t):
        return carry, S.make_key(rank, t), fp.snapshot(fcfg, modes, t,
                                                       coords)

    def feed(client, step):
        mu, sd = client.get_metadata("norm_stats")
        return (fp.snapshot(fcfg, inf_modes, SIM_STEPS + step, coords).T
                - mu) / sd

    def build(mesh=None):
        return InSituSession(
            tables=[TableSpec("field", shape=(4, fcfg.n_points),
                              capacity=RING)],
            components=[
                Producer(step_fn, table="field", steps=SIM_STEPS,
                         carry=torch.zeros((), device=dev),
                         emit_every=EMIT_EVERY),
                TrainerConsumer(replace(tcfg, mesh=mesh), coords, count=2,
                                model_key="encoder", on_epoch=on_epoch,
                                draws=draws),
                InferenceConsumer("encoder", feed, steps=N_INF)],
            device=dev, devices=pool)

    sess = build()
    plan = sess.plan()
    got = [(c.name, c.tier, c.mesh_devices) for c in plan.components]
    if got != [("producer", "capture_scan", 1),
               ("trainer0", "sharded_fused", SHARDS),
               ("trainer1", "sharded_fused", SHARDS),
               ("inference", "fused_registry", 1)]:
        raise AssertionError(f"consumers: the plan {got}")
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sess.run(plan=plan, sequential=True, max_wall_s=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not res.ok:
        raise AssertionError({n: c.error for n, c in
                              res.run.components.items() if c.error})
    stats = res.server.stats()
    deltas = {e.name: res.op_delta(e.name) for e in plan.components}
    if stats["op_count"] != plan.store_dispatches or any(
            deltas[e.name] != e.store_dispatches for e in plan.components):
        raise AssertionError(f"consumers: op deltas {deltas} vs "
                             f"{plan.explain()}")
    micro = -(-(GATHER - 1) // BATCH)
    r0 = marks[EPOCHS - 1]
    per = {"trainer0": r0,
           "trainer1": {k: v - r0[k] for k, v in marks[2 * EPOCHS - 1]
                        .items()}}
    for i, (name, seen) in enumerate(per.items()):
        gathers = EPOCHS + 1 + (i == 0)         # epochs, warm-up, bootstrap
        want = {k.symbol: 0 for k in counters}
        want.update({"sample_slots": gathers, "gather_rows": gathers,
                     "quadconv_contract":
                         (EPOCHS + 1) * (4 * micro * SHARDS + 4)})
        if seen != want:
            raise AssertionError(f"consumers {name}: launches {seen}, "
                                 f"expected {want}")
    a = tree_leaves(res.output("trainer0").state.params)
    b = tree_leaves(res.output("trainer1").state.params)
    if all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("consumers: the replicas' params are equal")
    if not all(torch.equal(x, y) for x, y in
               zip(a, tree_leaves(sharded["state"].params))):
        raise AssertionError("consumers: replica 0 differs from [sharded]'s "
                             "run on the same seed, draws and mesh shape")
    epoch_ms = {name: [e[0].elapsed_time(e[1])
                       for e in events[i * EPOCHS:(i + 1) * EPOCHS]]
                for i, name in enumerate(("trainer0", "trainer1"))}
    meshes = disjoint_data_meshes(2, devices=pool)
    try:
        build(mesh=meshes[0])
    except ValueError as exc:
        control = str(exc)
    else:
        raise AssertionError("consumers: replicas given one mesh did not "
                             "raise")
    del res, sess
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lres = launcher.run(points="medium", epochs=4, sim_steps=40, consumers=2,
                        device=dev, verbose=False)
    torch.cuda.synchronize()
    lwall = time.perf_counter() - t0
    ltiers = [(c.name, c.tier) for c in lres.plan.components]
    if ltiers != [("producer", "capture_scan"), ("trainer0", "fused"),
                  ("trainer1", "fused"), ("inference", "fused_registry")] \
            or lres.server.stats()["op_count"] \
            != lres.plan.store_dispatches:
        raise AssertionError(f"consumers launcher: {ltiers} "
                             f"{lres.server.stats()} vs "
                             f"{lres.plan.explain()}")
    del lres
    return {"plan": got, "op_count": stats["op_count"],
            "predicted": plan.store_dispatches, "op_delta": deltas,
            "launches": per, "replicas_differ": True,
            "replica0_equal_to_sharded": True,
            "epoch_ms": epoch_ms,
            "phase8_fused_epoch_ms": fused["epoch_ms"],
            "sharded_fused_epoch_ms": sharded["epoch_ms"],
            "wall_s": wall,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "one_mesh_control": control,
            "launcher": {"consumers": 2, "tiers": ltiers, "wall_s": lwall}}


def int8_phase(dev, cfg, fcfg, counters, slab: dict) -> dict:
    """16c. ``[int8 ddp]``: phase 8's workflow in ``sharded_fused`` on 2
    ranks of this card with ``ddp="psum"``, ``"int8"`` without and with
    error feedback, and the last again.  Checks, each hard: the
    reference's own 2% check at its own config
    (:func:`int8_reference_check`); at this width every run's losses
    finite and falling, each int8 run's first-epoch train loss within
    ``INT8_EPOCH_RTOL`` of psum's and one microstep showing where that gap
    comes from (:func:`int8_microstep_witness`); feedback changes the params; the rerun is bit for bit; an epoch's
    counted all-reduce calls (``plan(hlo=True)``) equal
    ``plan.ddp_all_reduces`` (2 a microstep, 3 over the int8 wire);
    ``compression_ratio`` over the trained gradient tree > 3.5, and over
    each leaf of a block or more.  Then ``slab_sharded`` and
    ``slab_sharded_clustered`` (2 client + 2 db ranks) with ``ddp="int8"``
    (feedback on): ``torch.equal`` to each other and to ``sharded_fused``'s.
    Prints every mode's epoch ms in this one call (one card: no wire is
    saved, so the int8 wire adds its quantization)."""
    from repro_torch.core import make_clustered_1d
    from repro_torch.core import store as S
    from repro_torch.insitu import plan as P
    from repro_torch.ml import autoencoder as ae
    from repro_torch.parallel import compress as CP
    from repro_torch.parallel.sharding import data_mesh
    from repro_torch.tree import tree_leaves, value_and_grad
    mesh = data_mesh(SHARDS, devices=[dev] * SHARDS)
    micro = -(-(GATHER - 1) // BATCH)
    runs = {}
    for label, kw in (("psum", {"ddp": "psum"}),
                      ("int8", {"ddp": "int8", "ddp_error_feedback": False}),
                      ("int8 feedback", {"ddp": "int8"}),
                      ("int8 feedback rerun", {"ddp": "int8"})):
        run = train_session(dev, cfg, fcfg, True, counters,
                            label=f"int8 ddp {label}", mesh=mesh,
                            hlo="rerun" not in label, **kw)
        if "rerun" not in label:
            coll = dict(run["plan"].component("trainer").collectives)
            want = P.ddp_all_reduces(kw["ddp"], micro)
            if coll["all-reduce"] != want or coll["all-gather"]:
                raise AssertionError(f"int8 ddp {label}: an epoch's "
                                     f"collectives {coll}, expected "
                                     f"{want} all-reduce calls")
            run["epoch_collectives"] = coll
        runs[label] = run
    exact = [h.train_loss for h in runs["psum"]["history"]]
    deviation = {k: [(h.train_loss - e) / e
                     for h, e in zip(r["history"], exact)]
                 for k, r in runs.items() if k != "psum"}
    reference_config = int8_reference_check(dev)
    witness = int8_microstep_witness(cfg, runs["psum"], runs["int8"])
    if any(abs(d[0]) > INT8_EPOCH_RTOL for d in deviation.values()):
        raise AssertionError(f"int8 ddp: first-epoch train loss vs psum "
                             f"{deviation}, limit {INT8_EPOCH_RTOL}")
    fb = tree_leaves(runs["int8 feedback"]["state"].params)
    if all(torch.equal(a, b) for a, b in
           zip(fb, tree_leaves(runs["int8"]["state"].params))):
        raise AssertionError("int8 ddp: feedback left the params as they "
                             "were")
    if not all(torch.equal(a, b) for a, b in zip(
            fb, tree_leaves(runs["int8 feedback rerun"]["state"].params))):
        raise AssertionError("int8 ddp: the rerun is not bit-identical")
    # the wire's ratio on the trained model's gradient tree
    run = runs["int8 feedback"]
    mu, sd = run["norm_stats"]
    batch = (S.whole_slab(run["table"].slab)[:BATCH].transpose(1, 2)
             - mu) / sd
    _, grads = value_and_grad(
        lambda p: ae.loss_fn(p, cfg, run["levels"], batch),
        run["state"].params)
    leaves = tree_leaves(grads)
    raw = sum(g.numel() * 4 for g in leaves)
    wire = sum(g.numel() + (g.numel() // 256 + 1) * 4 for g in leaves)
    big = [CP.compression_ratio(g) for g in leaves if g.numel() >= 256]
    if not (raw / wire > 3.5 and min(big) > 3.5):
        raise AssertionError(f"int8 ddp: compression ratio {raw / wire}, "
                             f"leaves {big}")
    # the slab-sharded and clustered tiers over the int8 wire
    d = make_clustered_1d(db_fraction=0.5, devices=[dev] * (2 * SHARDS),
                          slab_axis="data")
    runs["slab_sharded int8"] = train_session(
        dev, cfg, fcfg, True, counters, label="int8 ddp slab_sharded",
        mesh=mesh, slab_sharded=True, ddp="int8")
    runs["slab_sharded_clustered int8"] = train_session(
        dev, cfg, fcfg, True, counters, label="int8 ddp clustered",
        mesh=d.client_mesh, slab_sharded=True, deployment=d, ddp="int8")
    for label in ("slab_sharded int8", "slab_sharded_clustered int8"):
        if not all(torch.equal(a, b) for a, b in zip(
                fb, tree_leaves(runs[label]["state"].params))):
            raise AssertionError(f"int8 ddp: {label}'s params differ from "
                                 f"sharded_fused's")
    return {"mesh": SHARDS,
            "train_loss": {k: [h.train_loss for h in r["history"]]
                           for k, r in runs.items()},
            "train_loss_rel_to_psum": deviation,
            "reference_config_first_epoch": reference_config,
            "first_microstep_witness": witness,
            "feedback_changes_params": True, "rerun_bit_identical": True,
            "slab_and_clustered_equal_to_sharded_fused": True,
            "epoch_collectives": {k: r["epoch_collectives"]
                                  for k, r in runs.items()
                                  if "epoch_collectives" in r},
            "compression_ratio": {"tree": raw / wire,
                                  "min_leaf_of_a_block_or_more": min(big),
                                  "leaves": len(leaves)},
            "epoch_ms": {k: r["epoch_ms"] for k, r in runs.items()},
            "wall_s": {k: r["wall_s"] for k, r in runs.items()},
            "launches": {k: r["launches"] for k, r in runs.items()}}


def int8_microstep_witness(cfg, psum: dict, int8: dict) -> dict:
    """Where the int8 wire's first-epoch loss gap comes from, at full
    width.  The first epoch of phase 8's ``sharded_fused`` trainer on 2
    ranks is two microsteps; the second one's loss is the first that the
    wire can move.  Rebuilt here from the sessions' own inputs (the
    trainer's initial state and first draws from its seed, ``psum``'s
    ring and norm stats): microstep 1's ranks' gradients, averaged
    exactly (psum / 2) and over the int8 wire; one Adam step with each;
    microstep 2's loss after each.  The int8 mean is 0 on some entries
    where the exact one is not ("zeroed") and has the other sign on some
    ("flipped"); a hybrid gradient takes the int8 mean there and the
    exact mean everywhere else.  Adam's first step moves an entry by
    ``lr * g / (|g| + eps)``: by its sign alone, up to ``eps``.  Held:
    the rebuilt first-epoch losses equal both sessions' (1e-5 relative);
    the int8 step leaves the zeroed entries exactly where they were and
    equals the hybrid's step on every entry within ``lr * eps * |g - q| /
    ((|g| + eps) (|q| + eps))`` and the fp32 rounding of the update; the
    int8 step's microstep-2 loss differs from the hybrid's by under 5% of
    its gap to psum's.  So the zeroed and flipped entries carry the first
    epoch's gap."""
    from repro_torch.ml import autoencoder as ae
    from repro_torch.ml import trainer as tr
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import compress as CP
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad
    tcfg = psum["cfg"]
    mesh, ndev = tcfg.mesh, tcfg.mesh.size
    dev = mesh.devices[0]
    tx = opt.adam(tcfg.scaled_lr)
    state = tr.init_state(tcfg, torch.Generator().manual_seed(tcfg.seed),
                          tx, dev)
    draws = next(iter(tr.default_draws(tcfg, dev).epochs))
    mu, sd = psum["norm_stats"]
    train, _, _ = tr._epoch_data(tcfg, psum["spec"], psum["table"], draws,
                                 mu, sd)
    bs, starts = tr._windows(tcfg)
    bl = bs // ndev

    def rank_loss(p, s, r):
        return ae.loss_fn(p, cfg, psum["levels"],
                          train[s + r * bl:s + (r + 1) * bl])

    def loss(p, s):
        with torch.no_grad():
            return float(torch.stack([rank_loss(p, s, r)
                                      for r in range(ndev)]).sum() / ndev)

    def flat(tree):
        return torch.cat([x.reshape(-1) for x in tree_leaves(tree)])

    local = [value_and_grad(lambda p, r=r: rank_loss(p, starts[0], r),
                            state.params)[1] for r in range(ndev)]
    exact = tree_map(lambda x: x / ndev, C.psum(local, mesh)[dev])
    wire = CP.compressed_psum_mean(local, mesh)[dev]
    g_e, g_q = flat(exact), flat(wire)
    zeroed = (g_q == 0) & (g_e != 0)
    flipped = g_q * g_e < 0

    def mix(e, q, zero=True, flip=True):
        take = (zero & (q == 0)) | (flip & (q * e < 0))
        return torch.where(take, q, e)

    def step(g):
        updates, _ = tx.update(g, state.opt_state, state.params)
        return opt.apply_updates(state.params, updates)

    after = {"psum": step(exact), "int8": step(wire),
             "hybrid": step(tree_map(mix, exact, wire)),
             "zeroed_only": step(tree_map(
                 lambda e, q: mix(e, q, flip=False), exact, wire)),
             "flipped_only": step(tree_map(
                 lambda e, q: mix(e, q, zero=False), exact, wire))}
    p0, pq, ph = flat(state.params), flat(after["int8"]), \
        flat(after["hybrid"])
    lr, eps = tcfg.scaled_lr, 1e-8
    e64, q64 = g_e.double().abs(), g_q.double().abs()
    bound = lr * (eps * (g_e - g_q).double().abs()
                  / ((e64 + eps) * (q64 + eps)) + 2.0 ** -20) \
        + 2.0 ** -22 * p0.double().abs()
    dev_qh = (pq - ph).double().abs()
    first = loss(state.params, starts[0])
    second = {k: loss(p, starts[1]) for k, p in after.items()}
    epoch = {k: (first + second[k]) / len(starts) for k in ("psum", "int8")}
    session = {"psum": psum["history"][0].train_loss,
               "int8": int8["history"][0].train_loss}
    out = {"entries": int(g_e.numel()), "zeroed": int(zeroed.sum()),
           "flipped": int(flipped.sum()),
           "max_int8_vs_hybrid_over_bound": float((dev_qh / bound).max()),
           "microstep1_loss": first, "microstep2_loss": second,
           "first_epoch_rebuilt": epoch, "first_epoch_session": session,
           "microstep2_int8_vs_psum_rel": (second["int8"] - second["psum"])
           / second["psum"],
           "hybrid_share_of_gap": (second["hybrid"] - second["psum"])
           / (second["int8"] - second["psum"])}
    if len(starts) != 2 or not out["zeroed"] \
            or any(abs(epoch[k] - session[k]) > 1e-5 * abs(session[k])
                   for k in epoch) \
            or not torch.equal(pq[zeroed], p0[zeroed]) \
            or not bool((dev_qh <= bound).all()) \
            or abs(second["int8"] - second["hybrid"]) \
            > 0.05 * abs(second["int8"] - second["psum"]):
        raise AssertionError(f"int8 ddp witness: {out}")
    return out


def int8_reference_check(dev) -> dict:
    """The reference's own int8 check (``tests/test_sharded_epoch.py:
    109-131``) at its own config on this card: ONE ``sharded_fused``
    epoch on 2 ranks from the same state, table (10 flat-plate snapshots
    of 256 points) and draws with ``ddp`` psum, int8 and int8 with
    feedback; each int8 train loss within 2% of psum's (the reference's
    limit for that config).  At phase 8's full width the first int8
    epoch reads ~4% below psum's (PERF.md), held by ``INT8_EPOCH_RTOL``
    and :func:`int8_microstep_witness`."""
    from repro_torch.core import TableSpec
    from repro_torch.core import store as S
    from repro_torch.ml import autoencoder as ae
    from repro_torch.ml import trainer as tr
    from repro_torch.parallel.sharding import data_mesh
    from repro_torch.sim import flatplate as fp
    from repro_torch.train import optimizer as opt
    fcfg = fp.FlatPlateConfig(nx=8, ny=8, nz=4)
    n = fcfg.n_points
    gen = torch.Generator().manual_seed(SEED)
    modes = fp.draw_modes(fcfg, gen, dev)
    coords = fp.grid_coords(fcfg, dev)
    spec = TableSpec("field", shape=(4, n), capacity=16)
    table = S.init_table(spec, device=dev)
    for i in range(10):
        table = S.put(spec, table, S.make_key(0, i),
                      fp.snapshot(fcfg, modes, i, coords))
    aecfg = ae.AEConfig(n_points=n, latent=16, mlp_width=16)
    levels = ae.coords_pyramid(aecfg, coords)
    tx = opt.adam(1e-3)
    mu = torch.zeros(4, device=dev)
    sd = torch.ones(4, device=dev)
    mesh = data_mesh(SHARDS, devices=[dev] * SHARDS)
    out = {}
    for ddp, ef in (("psum", False), ("int8", False), ("int8", True)):
        cfg = tr.TrainerConfig(ae=aecfg, gather=6, batch_size=4, lr=1e-3,
                               mesh=mesh, ddp=ddp, ddp_error_feedback=ef)
        state = tr.init_state(cfg, torch.Generator().manual_seed(SEED), tx,
                              dev)
        draws = tr.draw_epoch(cfg, torch.Generator(device=dev)
                              .manual_seed(7), dev)
        epoch = tr.make_sharded_fused_epoch(cfg, levels, tx, spec)
        _, m = epoch(table, state, draws, mu, sd)
        out[f"{ddp}{' feedback' if ef else ''}"] = float(m[0])
    exact = out["psum"]
    rel = {k: (v - exact) / exact for k, v in out.items() if k != "psum"}
    if not all(math.isfinite(v) for v in out.values()) \
            or max(abs(v) for v in rel.values()) > 0.02:
        raise AssertionError(f"int8 ddp at the reference's config: {out}")
    return {"train_loss": out, "rel_to_psum": rel}


def capacity_phase(dev, cfg, fcfg, counters, slab: dict, session, preload,
                   local: dict, kernels) -> dict:
    """16d. ``[colocated capacity]``: ``Colocated(data_mesh(2),
    elem_spec=(None, None), capacity_axis="data")``, the ring's slots cut
    over 2 ranks of this card.  Phase 8's ``sharded_fused`` trainer on it:
    the trainer predicted to all-gather the table and measured to
    (``plan(hlo=True)``), every entry's ``check_collectives`` passing,
    op_count == the plan, params ``torch.equal`` to ``[sharded]``'s run on
    a local table; a prediction with the all-gather removed must raise.
    Phase 4's serving on it (both tiers): predicted and measured to
    all-reduce its reads, responses ``torch.equal`` to phase 4's, the
    sharded gather once per rank per read and the probe and QuadConv
    launches phase 4's."""
    from repro_torch.core import Colocated
    from repro_torch.insitu import plan as P
    from repro_torch.parallel.sharding import data_mesh
    from repro_torch.tree import tree_leaves
    mesh = data_mesh(SHARDS, devices=[dev] * SHARDS)
    cap = Colocated(mesh, elem_spec=(None, None), capacity_axis="data")
    run = train_session(dev, cfg, fcfg, True, counters,
                        label="colocated capacity", mesh=mesh,
                        deployment=cap, hlo=True)
    plan = run["plan"]
    for e in plan.components:
        e.check_collectives()
    trainer = plan.component("trainer")
    pred, coll = dict(trainer.predicted_collectives), \
        dict(trainer.collectives)
    if trainer.tier != "sharded_fused" or pred["all-gather"] is not True \
            or not coll["all-gather"] > 0:
        raise AssertionError(f"colocated capacity: {trainer.tier} "
                             f"{pred} {coll}")
    try:
        replace(trainer, predicted_collectives=P._pred(
            all_reduce=True)).check_collectives()
    except AssertionError as exc:
        control = str(exc)
    else:
        raise AssertionError("colocated capacity: a prediction without the "
                             "all-gather passed")
    if not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(run["state"]), tree_leaves(slab["state"]))):
        raise AssertionError("colocated capacity: params differ from the "
                             "local table's run")
    reads = CLIENTS * REQUESTS
    serve = {}
    for tier, (want, local_launches) in local.items():
        sess = session(tier, deployment=cap)
        splan = sess.plan(hlo=True)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sess.run(plan=splan, sequential=True, preload=preload,
                       max_wall_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in kernels}
        if not res.ok:
            raise AssertionError({n: c.error
                                  for n, c in res.run.components.items()})
        entry = splan.component("serving")
        entry.check_collectives()
        scoll = dict(entry.collectives)
        stats = res.server.stats()
        resp = res.output("readers").responses
        if stats["op_count"] != splan.store_dispatches \
                or not scoll["all-reduce"] > 0 or scoll["all-gather"]:
            raise AssertionError(f"colocated capacity serve {tier}: "
                                 f"{stats} {scoll}")
        if sorted(resp) != sorted(want) \
                or not all(torch.equal(resp[k], want[k]) for k in want):
            raise AssertionError(f"colocated capacity serve {tier}: "
                                 f"responses differ from phase 4's")
        drains = res.output("serving").batches \
            if tier == "continuous_batch" else reads
        expect = {k.symbol: 0 for k in kernels}
        expect.update({"probe_slots": local_launches["probe_slots"],
                       "gather_rows_sharded": SHARDS * (drains + reads),
                       "quadconv_contract":
                           local_launches["quadconv_contract"]})
        if launches != expect:
            raise AssertionError(f"colocated capacity serve {tier}: "
                                 f"launches {launches}, expected {expect}")
        serve[tier] = {"launches": launches, "drain_collectives":
                       {k: v for k, v in scoll.items() if v},
                       "op_count": stats["op_count"],
                       "requests_per_s": len(resp) / wall,
                       "responses_equal_phase4": True}
        del res, sess
    return {"deployment": plan.deployment,
            "trainer_predicted": {k: v for k, v in pred.items() if v},
            "trainer_epoch_collectives": {k: v for k, v in coll.items() if v},
            "no_all_gather_prediction_control": control,
            "params_equal_local": True, "op_count": run["op_count"],
            "train_launches": run["launches"],
            "epoch_ms": run["epoch_ms"], "serve": serve}


def launch_floor(lib) -> dict:
    """``[launch floor]``: one empty kernel's device time per launch
    (``torch.profiler``) and its CUDA-event time over back-to-back
    launches — what the store kernels' 1.5–3 µs rows are read against."""
    import ctypes
    from repro_torch.kernels import _build
    kernel = _build.Kernel(lib, "launch_empty", [ctypes.c_void_p])

    def launch():
        kernel.launch(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    dev = device_ms(launch, 1000, {"empty_kernel": "empty_kernel"})
    return {"device_ms_per_launch": None if dev is None
            else dev["empty_kernel"], "wall_ms": time_ms(launch, 1000),
            "source": "tools/launch_floor.cu", "launches": kernel.launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import quadconv_ae
    from repro_torch.core import TableSpec
    from repro_torch.insitu import (InSituSession, ServingClients,
                                    ServingConsumer)
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.kernels.quadconv import ops as qops
    from repro_torch.kernels.ssd import ops as dops
    from repro_torch.kernels.store import ops as sops
    from repro_torch.ml import autoencoder as ae
    from repro_torch.ml.quadconv import QuadConv
    from repro_torch.sim import flatplate as fp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    # 2. build (with the empty kernel of the launch floor, tools/)
    floor_lib = _build.Library(
        "launch_floor",
        Path(__file__).resolve().parent / "tools" / "launch_floor.cu")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s (in parallel; each: "
          f"{ {lib.name: round(lib.build_s, 1) for lib in libs} })",
          flush=True)
    for lib in libs:
        for line in lib.build_log.splitlines():
            # ptxas names each kernel, then its registers and spills
            if any(w in line for w in ("Compiling entry", "Used", "spill")):
                print(f"[build] {lib.name}: {line.strip()}")

    # 3. kernels vs their plain versions, at their main paths' shapes:
    # the serving plane's (B = 8, 4,096 points) and the trainer's (B = 4,
    # 2,048 points; a ring of 24, 6 rows gathered per epoch)
    probe = check_probe(dev)
    sample = check_sample(dev)
    gather_serving = check_gather(dev, CLIENTS * REQUESTS, MAX_BATCH,
                                  (4, 4096))
    gather = check_gather(dev, RING, GATHER, (4, 2048))
    serve_blocks = [check_quadconv(dev, MAX_BATCH, 4096, 4, 16, rerun=True),
                    check_quadconv(dev, MAX_BATCH, 1024, 16, 16)]
    enc0, mid, dec1 = (check_quadconv(dev, BATCH, 2048, 4, 16, rerun=True),
                       check_quadconv(dev, BATCH, 512, 16, 16),
                       check_quadconv(dev, BATCH, 2048, 16, 16))
    train_blocks = [enc0, mid, mid, dec1]   # encoder 0, 1; decoder 0, 1
    # a rank's microstep on the 2-rank mesh: B = 2 at the training shapes
    mesh_blocks = [check_quadconv(dev, BATCH // SHARDS, 2048, 4, 16),
                   check_quadconv(dev, BATCH // SHARDS, 512, 16, 16)]
    # LM serving: Phi-4-mini's prefill (B = 4, S = 2,048) in bf16 and fp32,
    # one tile of the reference (S = 128), a training micro-batch (B = 1);
    # Mamba-2's prefill (32 chunks)
    flash = check_flash(dev, LM_BATCH, PROMPT, 24, 8, 128, torch.bfloat16)
    flash_micro = check_flash(dev, 1, TRAIN_SEQ, 24, 8, 128, torch.bfloat16)
    flash32 = check_flash(dev, LM_BATCH, PROMPT, 24, 8, 128, torch.float32,
                          iters=3)
    flash_edge = check_flash(dev, LM_BATCH, 128, 24, 8, 128, torch.bfloat16)
    ssd = check_ssd(dev, LM_BATCH * PROMPT // 256, 256, 64, 64, 128)
    # the LM zoo's prefills (phases 17a, c, d, e): the four head layouts,
    # LLaVA's 1,152 patches in front of the prompt; Jamba's smoke prefill
    # (17f: B = 2, S = 128, chunks of 16, 8 heads of 16, state 16)
    from repro_torch.configs import get_config
    flash_zoo = {}
    for arch in ZOO_LAYERS:
        zc = get_config(arch)
        torch.cuda.empty_cache()
        flash_zoo[arch] = check_flash(
            dev, LM_BATCH, PROMPT + zc.frontend_tokens, zc.n_heads,
            zc.n_kv_heads, zc.head_dim, torch.bfloat16)
    # Nemotron-4's dh 192 (phase 18): its prefill and a training
    # micro-batch in bf16, one tile in fp32 (the FMA kernel)
    nc = get_config(NEMOTRON)
    torch.cuda.empty_cache()
    flash_nemo = {
        "prefill": check_flash(dev, LM_BATCH, PROMPT, nc.n_heads,
                               nc.n_kv_heads, nc.head_dim, torch.bfloat16,
                               rerun=True),
        "train_micro_batch": check_flash(dev, 1, TRAIN_SEQ, nc.n_heads,
                                         nc.n_kv_heads, nc.head_dim,
                                         torch.bfloat16, rerun=True),
        "fp32": check_flash(dev, 1, 128, nc.n_heads, nc.n_kv_heads,
                            nc.head_dim, torch.float32, iters=3,
                            rerun=True)}
    torch.cuda.empty_cache()
    ssd_jamba = check_ssd(dev, JAMBA_BATCH * JAMBA_SEQ // 16, 16, 8, 16, 16)
    ssd_jamba["shape"] = ssd_jamba["shape"].replace(
        "B=4, S=2048", f"B={JAMBA_BATCH}, S={JAMBA_SEQ}")
    torch.cuda.empty_cache()
    for row in (probe, sample, gather_serving, gather, *serve_blocks,
                enc0, mid, dec1, *mesh_blocks, flash, flash32, flash_edge,
                flash_micro, *flash_zoo.values(), *flash_nemo.values(), ssd,
                ssd_jamba):
        print(f"[kernels] {json.dumps(row)}", flush=True)
    print(f"[launch floor] {smi} {json.dumps(launch_floor(floor_lib))}",
          flush=True)
    timing_keys = ("ms", "wall_ms", "plain_ms", "plain_wall_ms",
                   "library_ms", "bound_ms")
    quad = {"name": "quadconv_contract", "route": "cuda",
            "source": "src/repro_torch/kernels/quadconv/csrc/quadconv.cu",
            "replaces": "src/repro/kernels/quadconv/kernel.py:39",
            "max_abs_err": max(b["max_abs_err"] for b in train_blocks),
            "bound_by": "bytes",
            "timed_by": "+".join(sorted({b["timed_by"]
                                         for b in train_blocks})),
            "shape": "one training forward at B=4: encoder 0 (I=J=2048, "
                     "C=4), encoder 1 and decoder 0 (I=J=512, C=16), "
                     "decoder 1 (I=J=2048, C=16); times summed",
            **{k: sum(b[k] for b in train_blocks)
               for k in (*timing_keys, "library_matmul_ms")},
            "serving": {"shape": "encoder blocks 0 + 1 at B=8, 4,096 "
                                 "points (times summed)",
                        **{k: sum(b[k] for b in serve_blocks)
                           for k in (*timing_keys, "library_matmul_ms")}}}
    gather["serving"] = {k: gather_serving[k] for k in
                         ("shape", *timing_keys)}

    # 4. serving: continuous batching through the kernels
    fcfg = fp.FlatPlateConfig(nx=16, ny=16, nz=16)
    cfg = replace(quadconv_ae.config(), n_points=fcfg.n_points)
    gen = torch.Generator().manual_seed(SEED)
    params = ae.init_autoencoder(cfg, gen, dev)
    modes = fp.draw_modes(fcfg, gen, dev)
    coords = fp.grid_coords(fcfg, dev)
    levels = ae.coords_pyramid(cfg, coords)
    snaps = {(c, s): fp.snapshot(fcfg, modes, 100 * c + s, coords)
             for c in range(CLIENTS) for s in range(REQUESTS)}

    def model(p, xs):
        return ae.encode(p, cfg, levels, xs.transpose(1, 2))

    def preload(server):
        server.set_model("encoder", model, params)

    def session(tier, faults=None, deployment=None):
        tables = [TableSpec("sreq", shape=(4, fcfg.n_points),
                            capacity=CLIENTS * REQUESTS),
                  TableSpec("sres", shape=(cfg.latent,),
                            capacity=CLIENTS * REQUESTS)]
        return InSituSession(tables=tables, device=dev, faults=faults,
                             deployment=deployment, components=[
            ServingClients(lambda c, s: snaps[(c, s)], table="sreq",
                           clients=CLIENTS, requests=REQUESTS,
                           collect=False, name="writers"),
            ServingConsumer("encoder", table="sreq", results="sres",
                            clients=CLIENTS, requests=REQUESTS,
                            max_batch=MAX_BATCH, tier=tier),
            ServingClients(lambda c, s: snaps[(c, s)], table="sreq",
                           clients=CLIENTS, requests=REQUESTS,
                           submit=False, name="readers")])

    xs = torch.stack([snaps[k] for k in sorted(snaps)])
    model(params, xs[:MAX_BATCH])             # warm-up (cuBLAS, allocator)
    z_ref = ae.encode(params, replace(cfg, mode="ref"), levels,
                      xs.transpose(1, 2))
    torch.cuda.synchronize()
    tol = 1e-4 * (1.0 + float(z_ref.abs().max()))
    kernels = [sops.PROBE, sops.GATHER, qops.QUADCONV]

    def drive(tier, sequential=True):
        sess = session(tier)
        plan = sess.plan()
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = sess.run(plan=plan, sequential=sequential, preload=preload,
                       max_wall_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in kernels}
        if not res.ok:
            raise AssertionError({n: c.error
                                  for n, c in res.run.components.items()})
        stats = res.server.stats()
        out = res.output("serving")
        predicted = dict(plan.component("serving").dispatches).get("serve", 0)
        # threads drain whatever has arrived, so only a sequential run
        # drains the predicted batches; every other dispatch is exact
        if (sequential and out.batches != predicted) \
                or stats["op_count"] != (plan.store_dispatches - predicted
                                         + out.batches) \
                or stats["model_swaps"] != plan.model_swaps:
            raise AssertionError(f"plan {plan.explain()} != stats {stats}, "
                                 f"batches {out.batches}")
        resp = res.output("readers").responses
        err = 0.0
        for i, key in enumerate(sorted(snaps)):
            z = resp[key]
            if z.shape != (cfg.latent,) or not bool(torch.isfinite(z).all()):
                raise AssertionError(f"response {key}: {z.shape}")
            err = max(err, float((z - z_ref[i]).abs().max()))
        if not err <= tol:
            raise AssertionError(f"{tier}: responses differ from the plain "
                                 f"encoder by {err} > {tol}")
        walls = {n: round(c.wall_s, 4) for n, c in res.run.components.items()}
        verbs = {n: round(t["mean_s"] * 1e3, 3)
                 for n, t in res.run.timers.summary().items()}
        mode = tier if sequential else f"{tier} threaded"
        print(f"[{mode}] requests={len(resp)} batches={out.batches} "
              f"swaps={stats['model_swaps']} op_count={stats['op_count']} "
              f"predicted={plan.store_dispatches} launches={launches} "
              f"max_err_vs_plain={err:.3g} (tol {tol:.3g}) wall_s={wall:.4f} "
              f"requests_per_s={len(resp) / wall:.2f} component_wall_s="
              f"{walls} verb_mean_ms={verbs} peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
        return resp, launches

    batched, launches = drive("continuous_batch")
    n_batches = -(-CLIENTS * REQUESTS // MAX_BATCH)
    need = {"probe_slots": n_batches, "gather_rows": n_batches,
            "quadconv_contract": 2 * n_batches}
    for sym, least in need.items():
        if launches[sym] < least:
            raise AssertionError(f"{sym} launched {launches[sym]} times on "
                                 f"the serving path, expected >= {least}")

    # where a drained batch's time goes (device time, CUDA events)
    x8 = xs[:MAX_BATCH]
    t_enc = time_ms(lambda: model(params, x8), 5)
    t_g = []
    for b, c_in in enumerate((cfg.channels, cfg.internal)):
        conv = QuadConv(c_in=c_in, c_out=cfg.internal,
                        mlp_width=cfg.mlp_width, mlp_depth=cfg.mlp_depth,
                        support=cfg.support)
        t_g.append(time_ms(lambda: conv.kernel_tensor(
            params["enc"][b], levels[b], levels[b]), 5))
    t_contract = quad["serving"]["ms"]
    rest = t_enc - sum(t_g) - t_contract
    print(f"[breakdown] encode B={MAX_BATCH}: {t_enc:.3f} ms = filter-MLP "
          f"kernel tensor G block0 {t_g[0]:.3f} + block1 {t_g[1]:.3f} + "
          f"quadconv_contract {t_contract:.3f} + rest {rest:.3f} ms",
          flush=True)

    print("[profile] continuous_batch session: " + profile(
        lambda: session("continuous_batch").run(
            sequential=True, preload=preload, max_wall_s=600)), flush=True)

    # 5. three-step: the same requests one at a time
    single, single_launches = drive("three_step")
    diff = max(float((batched[k] - single[k]).abs().max()) for k in batched)
    if not diff <= tol:
        raise AssertionError(f"three-step differs from batched by {diff}")
    print(f"[three_step] max |three_step - continuous_batch| = {diff:.3g}")

    # 6. threaded: one host thread per component, as run() defaults to
    drive("continuous_batch", sequential=False)

    # 6a. chaos serve: the continuous-batching session armed, then with a
    # serving crash at batch 1 and a duplicated response chunk
    from repro_torch.core.faults import FaultEvent, FaultPlan, RetryPolicy
    retry = RetryPolicy(interval=1e-4, max_interval=1e-3)
    chaos_serve = {}
    for label, fplan in (("armed", FaultPlan(retry=retry)), (
            "faulted", FaultPlan(events=(
                FaultEvent("crash", component="serving", at=1),
                FaultEvent("dup_chunk", table="sres", at=0)), retry=retry))):
        sess = session("continuous_batch", fplan)
        plan = sess.plan()
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sess.run(plan=plan, sequential=True, preload=preload,
                       max_wall_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not res.ok:
            raise AssertionError({n: c.error
                                  for n, c in res.run.components.items()})
        check_fault_predictions(f"chaos serve {label}", plan, res)
        if res.server.stats()["model_swaps"] != plan.model_swaps:
            raise AssertionError(f"chaos serve {label}: model swaps")
        chaos_serve[label] = {
            "res": res, "wall_s": wall,
            "launches": {k.symbol: k.launches for k in kernels},
            "restarts": res.restarts,
            "faults_injected": res.server.stats()["faults_injected"]}
    armed, faulted = chaos_serve["armed"], chaos_serve["faulted"]
    aresp = armed["res"].output("readers").responses
    fresp = faulted["res"].output("readers").responses
    if sorted(aresp) != sorted(fresp) or not all(
            torch.equal(aresp[k], fresp[k]) for k in aresp) \
            or not all(equal_tables(armed["res"].server.checkout(t),
                                    faulted["res"].server.checkout(t))
                       for t in ("sreq", "sres")) \
            or faulted["launches"] != armed["launches"] \
            or (faulted["restarts"], faulted["faults_injected"]) != (1, 2) \
            or min(faulted["launches"].values()) < 1:
        raise AssertionError(f"chaos serve: responses, tables or launches "
                             f"differ from the armed run's: {faulted} vs "
                             f"{armed}")
    chaos_serve_line = {label: {k: v for k, v in run.items() if k != "res"}
                        for label, run in chaos_serve.items()}
    print(f"[chaos serve] {smi} {json.dumps(chaos_serve_line)} responses "
          f"and tables equal to the armed run's (torch.equal)", flush=True)
    del chaos_serve, armed, faulted

    # 7. grad: one training microstep at the paper's widths, 2,048 points
    tfcfg = fp.FlatPlateConfig(nx=16, ny=16, nz=8)
    tcfg = replace(cfg, n_points=tfcfg.n_points)
    tgen = torch.Generator().manual_seed(SEED + 1)
    tparams = ae.init_autoencoder(tcfg, tgen, dev)
    tmodes = fp.draw_modes(tfcfg, tgen, dev)
    tcoords = fp.grid_coords(tfcfg, dev)
    tlevels = ae.coords_pyramid(tcfg, tcoords)
    batch = torch.stack([fp.snapshot(tfcfg, tmodes, t, tcoords).T
                         for t in range(BATCH)])
    batch = (batch - batch.mean(dim=(0, 1))) / batch.std(dim=(0, 1))
    grad = check_grad(tcfg, tlevels, tparams, batch)
    print(f"[grad] B={BATCH} N={tcfg.n_points} {json.dumps(grad)}",
          flush=True)
    bd = microstep_breakdown(tcfg, tlevels, tparams, batch)
    print("[breakdown] training microstep: " + " ".join(
        f"{k}={v:.3f}" for k, v in bd.items()), flush=True)
    del tparams, batch
    torch.cuda.empty_cache()

    # 8. train: the paper's in-situ workflow, sequential then threaded
    counters = [sops.PROBE, sops.SAMPLE, sops.GATHER, qops.QUADCONV]
    trained = train_session(dev, tcfg, tfcfg, True, counters)
    train_session(dev, tcfg, tfcfg, False, counters)
    trained["profile"] = profile(
        lambda: train_session(dev, tcfg, tfcfg, True, counters,
                              label="profiled"))
    print("[profile] training session (sequential): " + trained["profile"],
          flush=True)

    # 8a. chaos train: the same session disarmed, armed and under faults
    chaos = chaos_train_phase(dev, tcfg, tfcfg, counters)
    print(f"[chaos train] {smi} {json.dumps(chaos)}", flush=True)

    # 9. launch: the launcher a user calls, at its own defaults
    from repro_torch.launch import insitu as launcher
    t0 = time.perf_counter()
    res = launcher.run(points="medium", epochs=4, sim_steps=40, device=dev)
    torch.cuda.synchronize()
    if res.server.stats()["op_count"] != res.plan.store_dispatches:
        raise AssertionError(f"launcher: {res.server.stats()} vs "
                             f"{res.plan.explain()}")
    print(f"[launch] run(points='medium', epochs=4, sim_steps=40) ok in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    del res
    torch.cuda.empty_cache()

    # 9a. spectral: the pseudo-spectral solver alone at 512^3
    print(f"[spectral] {smi} {json.dumps(spectral_phase(dev))}", flush=True)
    torch.cuda.empty_cache()

    # 9b. insitu spectral: the launcher with the spectral producer
    insitu_spectral = insitu_spectral_phase(dev, counters,
                                            trained["launches"])
    print(f"[insitu spectral] {smi} {json.dumps(insitu_spectral)}",
          flush=True)
    torch.cuda.empty_cache()

    # 10-12. LM serving at full width
    phi4 = lm_phase(dev, "phi4_mini_3_8b", {"attn_impl": "flash"},
                    {"attn_impl": "xla"}, aops.FLASH_TC, 32, control=True,
                    absent=(aops.FLASH,))
    print(f"[lm phi4] {json.dumps(phi4)}", flush=True)
    mamba = lm_phase(dev, "mamba2_1_3b", {"ssd_impl": "kernel"},
                     {"ssd_impl": "xla"}, dops.SSD_INTRA, 48)
    print(f"[lm mamba2] {json.dumps(mamba)}", flush=True)
    served = serve_loop_phase(dev)
    print(f"[serve_loop] {json.dumps(served)}", flush=True)

    # 13. LM training at full width
    torch.cuda.empty_cache()
    bwd_dq, bwd_dkv, trained_lm = train_phase(dev)
    for row in (bwd_dq, bwd_dkv):
        print(f"[kernels] {json.dumps(row)}", flush=True)
    print(f"[checkpoint full] {smi} "
          f"{json.dumps(trained_lm.pop('checkpoint_full'))}", flush=True)
    print(f"[lm train] {json.dumps(trained_lm)}", flush=True)

    # 14. the slab-sharded data plane on a 2-rank mesh on this card
    torch.cuda.empty_cache()
    sharded_row, sharded, slab_run = sharded_phase(dev, tcfg, tfcfg,
                                                   trained)
    print(f"[sharded] {json.dumps(sharded)}", flush=True)

    # 15. the paper's reproducer: transfer and ResNet-50 inference loops
    torch.cuda.empty_cache()
    probe["reproducer"], gather["reproducer"], repro_default = \
        reproducer_phase(dev)

    # 15a-c. the co-located deployment: SHARDS ranks on this card
    torch.cuda.empty_cache()
    colo_serve = colocated_serve_phase(
        dev, session, preload,
        {"continuous_batch": (batched, launches),
         "three_step": (single, single_launches)}, kernels)
    print(f"[colocated serve] {smi} {json.dumps(colo_serve)}", flush=True)
    colo_fd, gather["colocated"], colo_ring = colocated_fd_phase(
        dev, counters)
    print(f"[colocated fd] {smi} {json.dumps(colo_fd)}", flush=True)
    print(f"[kernels] {json.dumps(gather['colocated'])}", flush=True)
    colo_transfer = colocated_transfer_phase(dev, repro_default)
    print(f"[colocated transfer] {smi} {json.dumps(colo_transfer)}",
          flush=True)

    # 15d-g. the clustered deployment: client and db ranks on this card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    clu_fd = clustered_fd_phase(dev, counters, colo_ring)
    clu_fd["seconds"] = time.perf_counter() - t0
    print(f"[clustered fd] {smi} {json.dumps(clu_fd)}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    clu_train = clustered_train_phase(
        dev, tcfg, tfcfg, [sops.PROBE, sops.SAMPLE, sops.GATHER,
                           sops.GATHER_SHARDED, qops.QUADCONV], slab_run)
    clu_train["seconds"] = time.perf_counter() - t0
    print(f"[clustered train] {smi} {json.dumps(clu_train)}", flush=True)
    t0 = time.perf_counter()
    clu_serve = clustered_serve_phase(
        dev, session, preload,
        {"continuous_batch": (batched, launches),
         "three_step": (single, single_launches)}, kernels)
    clu_serve["seconds"] = time.perf_counter() - t0
    print(f"[clustered serve] {smi} {json.dumps(clu_serve)}", flush=True)
    t0 = time.perf_counter()
    fan_in = fan_in_scenario(dev)
    fan_in["seconds"] = time.perf_counter() - t0
    print(f"[fan-in] {smi} {json.dumps(fan_in)}", flush=True)

    # 16a-d. the rest of the multi-device tiers: ranks on this card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    c2d = clustered_2d_phase(dev, counters, colo_ring)
    del colo_ring
    c2d["seconds"] = time.perf_counter() - t0
    print(f"[clustered2d fd] {smi} {json.dumps(c2d)}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    consumers = consumers_phase(dev, tcfg, tfcfg, counters, slab_run,
                                trained)
    consumers["seconds"] = time.perf_counter() - t0
    print(f"[consumers] {smi} {json.dumps(consumers)}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    int8 = int8_phase(dev, tcfg, tfcfg, [
        sops.PROBE, sops.SAMPLE, sops.GATHER, sops.GATHER_SHARDED,
        qops.QUADCONV], slab_run)
    int8["seconds"] = time.perf_counter() - t0
    print(f"[int8 ddp] {smi} {json.dumps(int8)}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    capacity = capacity_phase(
        dev, tcfg, tfcfg, counters, slab_run, session, preload,
        {"continuous_batch": (batched, launches),
         "three_step": (single, single_launches)},
        [sops.PROBE, sops.GATHER, sops.GATHER_SHARDED, qops.QUADCONV])
    capacity["seconds"] = time.perf_counter() - t0
    print(f"[colocated capacity] {smi} {json.dumps(capacity)}", flush=True)

    # 16. checkpoints: in memory on the card, and the launcher's resume
    torch.cuda.empty_cache()
    print(f"[checkpoint] {smi} {json.dumps(checkpoint_phase(dev))}",
          flush=True)

    # 17. the LM zoo's decoder-only families at full width, depth cut
    torch.cuda.empty_cache()
    print(f"[lm zoo] device memory held before: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    zoo = {}
    for tag, arch in (("lm qwen3_moe", "qwen3_moe_235b_a22b"),
                      ("lm llama4_scout", "llama4_scout_17b_a16e"),
                      ("lm starcoder2", "starcoder2_7b"),
                      ("lm llava", "llava_next_34b")):
        t0 = time.perf_counter()
        zoo[arch] = lm_phase(
            dev, arch, {"attn_impl": "flash"}, {"attn_impl": "xla"},
            aops.FLASH_TC, ZOO_LAYERS[arch], absent=(aops.FLASH,),
            n_layers=ZOO_LAYERS[arch],
            after=moe_layer_check if arch == "qwen3_moe_235b_a22b" else None)
        zoo[arch]["seconds"] = time.perf_counter() - t0
        moe_layer = zoo[arch].pop("after", None)
        print(f"[{tag}] {smi} {json.dumps(zoo[arch])}", flush=True)
        if moe_layer is not None:
            print(f"[moe layer] {smi} {json.dumps(moe_layer)}", flush=True)
    t0 = time.perf_counter()
    jamba = jamba_phase(dev, aops.FLASH, dops.SSD_INTRA)
    jamba["serve"] = [serve_smoke(dev, arch) for arch in (
        "qwen3_moe_235b_a22b", "jamba_1_5_large_398b")]
    jamba["seconds"] = time.perf_counter() - t0
    print(f"[hybrid jamba] {smi} {json.dumps(jamba)}", flush=True)

    # 18. Nemotron-4 at full width, depth cut: serving, then training
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nemo = lm_phase(dev, NEMOTRON, {"attn_impl": "flash"},
                    {"attn_impl": "xla"}, aops.FLASH_TC,
                    NEMOTRON_SERVE_LAYERS, control=True,
                    absent=(aops.FLASH,), n_layers=NEMOTRON_SERVE_LAYERS,
                    limit=NEMOTRON_LM_LIMIT)
    nemo["weights_gb"] = nemo["params"] * 2 / 1e9
    nemo["reduced"] = {"n_layers": [nemo["full_n_layers"],
                                    NEMOTRON_SERVE_LAYERS]}
    nemo["seconds"] = time.perf_counter() - t0
    print(f"[lm nemotron] {smi} {json.dumps(nemo)}", flush=True)
    t0 = time.perf_counter()
    nemo_dq, nemo_dkv, nemo_train = nemotron_train_phase(dev)
    for row in (nemo_dq, nemo_dkv):
        print(f"[kernels] {json.dumps(row)}", flush=True)
    nemo_train["smoke_launchers"] = {"serve": serve_smoke(dev, NEMOTRON),
                                     "train": train_smoke(dev, NEMOTRON)}
    nemo_train["seconds"] = time.perf_counter() - t0
    print(f"[lm train nemotron] {smi} {json.dumps(nemo_train)}", flush=True)

    serving_launches = launches
    rows = []
    for row, path in ((probe, "serving"), (sample, "training"),
                      (gather, "training"), (quad, "training")):
        row = dict(row)
        name = row["name"]
        row["path"] = path
        row["launches"] = (serving_launches if path == "serving"
                           else trained["launches"])[name]
        row["launches_by_path"] = {
            "serving": serving_launches.get(name, 0),
            "training": trained["launches"][name],
            "chaos serve (faulted)": chaos_serve_line["faulted"][
                "launches"].get(name, 0),
            "chaos train (faulted)": chaos["faulted"]["launches"][name],
            "insitu spectral": insitu_spectral["launches"][name],
            "colocated serve": colo_serve["continuous_batch"][
                "launches"].get(name, 0),
            "colocated fd": colo_fd["launches"][name],
            "colocated transfer": colo_transfer["colocated"][0][
                "launches"].get(name, 0),
            "clustered fd (the ring's read)": clu_fd["read_launches"].get(
                name, 0),
            "clustered train": clu_train["launches"].get(name, 0),
            "clustered serve": clu_serve["continuous_batch"][
                "launches"].get(name, 0),
            "clustered2d fd (the ring's read)": c2d["read_launches"].get(
                name, 0),
            "consumers (2 replicas)": sum(
                r.get(name, 0) for r in consumers["launches"].values()),
            "int8 ddp (sharded_fused, feedback)": int8["launches"][
                "int8 feedback"].get(name, 0),
            "colocated capacity train": capacity["train_launches"].get(
                name, 0),
            "colocated capacity serve": capacity["serve"][
                "continuous_batch"]["launches"].get(name, 0)}
        if row["launches"] < 1:
            raise AssertionError(f"{name} never launched on its path")
        row["kernel_ms"] = row["ms"]
        rows.append(row)
    # the attention rows are the main path's bf16 tensor-core kernels; the
    # fp32 FMA kernels of the same TPU kernels sit under "fp32" (forward:
    # Jamba's fp32 smoke prefill runs it) and "edge" (dq and dk/dv at one
    # tile in fp32)
    fma_fwd = "src/repro_torch/kernels/attention/csrc/attention.cu"
    for row, name, src, tpu, lm_run in (
            (flash, "flash_attention", "attention/csrc/attention_tc.cu",
             "attention/kernel.py:39", phi4),
            (ssd, "ssd_intra", "ssd/csrc/ssd.cu", "ssd/kernel.py:30", mamba)):
        row = dict(row, name=name, route="cuda",
                   source=f"src/repro_torch/kernels/{src}",
                   replaces=f"src/repro/kernels/{tpu}",
                   path=f"lm {lm_run['arch']} prefill",
                   launches=lm_run["launches"], kernel_ms=row["ms"])
        if name == "flash_attention":
            row["fp32"] = {"source": fma_fwd, "kernel": flash32["kernel"],
                           **{k: flash32[k] for k in (
                               "shape", "max_abs_err", *timing_keys)}}
            row["edge"] = {k: flash_edge[k] for k in (
                "kernel", "shape", "max_abs_err", *timing_keys)}
            row["train_micro_batch"] = {k: flash_micro[k] for k in (
                "kernel", "shape", "max_abs_err", *timing_keys)}
            row["launches_by_path"] = {
                "lm phi4 prefill": lm_run["launches"],
                "lm phi4 train (4 steps)":
                    trained_lm["launches"]["flash_attention_fwd_tc"],
                **{f"lm {arch} prefill ({ZOO_LAYERS[arch]} layers)":
                   zoo[arch]["launches"] for arch in ZOO_LAYERS}}
            row["fp32"]["launches"] = jamba["launches"][aops.FLASH.symbol]
            row["fp32"]["launches_by_path"] = {
                "hybrid jamba prefill (smoke, dh 16)":
                    jamba["launches"][aops.FLASH.symbol]}
            row["zoo"] = {arch: {k: flash_zoo[arch][k] for k in (
                "kernel", "shape", "max_abs_err", "tol", *timing_keys,
                "bound_by")} for arch in ZOO_LAYERS}
            row["launches_by_path"].update({
                f"lm nemotron prefill ({NEMOTRON_SERVE_LAYERS} layers)":
                    nemo["launches"],
                f"lm train nemotron ({NEMOTRON_TRAIN_STEPS} steps)":
                    nemo_train["launches"]["flash_attention_fwd_tc"]})
            row["nemotron"] = {
                name: {k: r[k] for k in (
                    "kernel", "shape", "max_abs_err", "tol",
                    "bit_identical_rerun", *timing_keys, "bound_by")}
                for name, r in flash_nemo.items()}
            row["nemotron"]["prefill"]["launches"] = nemo["launches"]
        else:
            row["launches_by_path"] = {
                "lm mamba2 prefill": lm_run["launches"],
                "hybrid jamba prefill (smoke)":
                    jamba["launches"][dops.SSD_INTRA.symbol]}
            row["jamba"] = {k: ssd_jamba[k] for k in (
                "shape", "max_abs_err", *timing_keys, "bound_by")}
        rows.append(row)
    for row, nemo_row, name, src, tpu, symbol in (
            (bwd_dq, nemo_dq, "flash_attention_bwd_dq",
             "attention_bwd_tc.cu", "bwd.py:47", "flash_attention_bwd_dq_tc"),
            (bwd_dkv, nemo_dkv, "flash_attention_bwd_dkv",
             "attention_bwd_tc.cu", "bwd.py:74",
             "flash_attention_bwd_dkv_tc")):
        row = dict(row, name=name, route="cuda",
                   source=f"src/repro_torch/kernels/attention/csrc/{src}",
                   replaces=f"src/repro/kernels/attention/{tpu}",
                   path="lm phi4 train (launch.train.run, 4 steps)",
                   launches=trained_lm["launches"][symbol],
                   kernel_ms=row["ms"])
        row["nemotron"] = dict(
            {k: nemo_row[k] for k in (
                "kernel", "shape", "max_abs_err", "bit_identical_rerun",
                *timing_keys, "bound_by", "fp32")},
            launches=nemo_train["launches"][symbol])
        row["launches_by_path"] = {
            "lm phi4 train (4 steps)": row["launches"],
            f"lm train nemotron ({NEMOTRON_TRAIN_STEPS} steps)":
                nemo_train["launches"][symbol]}
        if row["launches"] < 1:
            raise AssertionError(f"{name} never launched on its path")
        rows.append(row)
    rows.insert(3, dict(
        sharded_row, path="insitu slab_sharded (2 ranks on one card)",
        launches=sharded["slab_sharded"]["launches"]["gather_rows_sharded"],
        launches_by_path={
            "slab_sharded": sharded["slab_sharded"]["launches"][
                "gather_rows_sharded"],
            "clustered train (2 db ranks)": clu_train["launches"][
                "gather_rows_sharded"],
            "int8 ddp slab_sharded": int8["launches"]["slab_sharded int8"][
                "gather_rows_sharded"],
            "int8 ddp slab_sharded_clustered": int8["launches"][
                "slab_sharded_clustered int8"]["gather_rows_sharded"],
            "colocated capacity serve": capacity["serve"][
                "continuous_batch"]["launches"]["gather_rows_sharded"]},
        kernel_ms=sharded_row["ms"]))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
