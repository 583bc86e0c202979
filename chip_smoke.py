"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build every kernel from src/repro_torch/csrc (one nvcc per source, in
     parallel; each kernel's registers and spills printed);
  2. hold each kernel against its plain PyTorch version on the card: the
     float and int8 layers at DeiT-T full width (batch 8) and ViT-B/16
     widths (batch 2), and windowed at Swin-T stage 1 (bucket 8, shifted
     mask); the int8 MSA at DeiT-T, and windowed with qkv_bias at Swin-T
     stage 1; the int8 matmul at the embed and head shapes, and the int8
     layer's products through the same kernel (Q/K/V per-head stacks, up
     with an int8 output, down with a residual), each exactly; the float
     MSA and the fused MLP at DeiT-T, Swin-T stages 1 and 4 and ViT-B/16
     widths, with qkv_bias and without the MLP biases once each; the
     float and int8 layer groups at DeiT-T (12 layers, batch 8), Swin-T
     stage 4 (2 layers, bucket 8, windowed) and a pruned width (DeiT-T,
     2 layers of 2 heads), also against L calls of the per-layer chain
     (float: `vita_layer_group.tile_chain`, the float layer on the
     group's GEMM tile, within 1e-6 of the scale, and bit for bit at
     ViT-B/16 widths, and `vita_layer` itself, whose fp32-weight products
     take the wgmma tile, within 1e-6 of the scale, the measured errors
     printed; int8: `vita_layer_int8`, exactly), and
     that chain of `vita_layer_int8` calls teacher-forced, each layer
     against the plain version fed the chain's own input to it, at the
     int8 layer's bound (the worst layer printed);
     kernel 1's fp32 GEMMs at DeiT-S's three products (bucket 32), a
     Swin-T stage-1 and a TNT-S inner product each print a `[gemm]` line:
     the wgmma tile (held to a float64 product within 1e-6 of the scale),
     the mma.sync tile, fp32 `torch.matmul` and the bound at 165 TFLOP/s;
     each timed shape of the float layer and the float MSA prints its
     plan (`[plan]`: the layer's launches, counted on one call, the
     operand types, and the fields of the MSA tile's plan: cluster, row
     slice, ring stages, shared memory), each float group its plan (grid,
     shared memory, and per stage the tiles and waves), each int8 group its
     plan (grid, blocks an SM, and per stage the tiles, k groups and
     waves), and each int8
     matmul shape its plan (tile, k groups, copy widths), and, after the
     timing phase, its device time at each k-group count the kernel is
     built for;
  3. serve DeiT-T (224 px, 12 layers) and Swin-T (224 px, depths
     2/2/6/2), and their head-pruned variants, random weights from a
     seed, through make_server on the card: DeiT-T fused float and int8,
     DeiT-T unfused (--no-fuse) float and int8, Swin-T fused float and
     int8, Swin-T unfused float, DeiT-T grouped by 4 and Swin-T grouped by
     2 (--fuse-group-size) in float and int8, DeiT-T-p fused float and
     int8, Swin-T-p fused float.  Each path's launch counts are set to 0
     just before it and read just after, and must equal what its schedule
     launches; its logits are checked against the same server on the CPU;
  4. time each kernel, its plain version and a library yardstick (and
     each int8 group beside its L `vita_layer_int8` calls), the
     served throughput of every path (grouped beside per-layer), and the
     device's busy share of a drain for DeiT-T and Swin-T in both modes
     and grouped DeiT-T, whose kernels must be one layer-group launch per
     group per micro-batch and no per-layer GEMM.

The LM slice adds, to phase 2, the flash, decode and RG-LRU scan kernels
and the gated / bf16 modes of the fused MLP against their plain versions
in fp32 and bf16 at RecurrentGemma-2B's and stablelm-3b's shapes (flash
at 13 and 4,096 tokens with the 2048 window; decode over caches of 128
and 2048 slots with ragged lengths, GQA 10:1 at Dh 256 and MHA at Dh 80;
the scan at T 13, 2,100 and 4,096, W 2560; the gated MLP at D 2560, M
7680 and 6912, N 13 and 4, and at N 4 with the plan asked for its fewest
hidden splits; every activation at a small shape), each output row within a
bound at its own scale, with each timed shape's launch plan printed
(`[plan]`: the fused MLP's regime and hidden splits, decode attention's
key splits, flash attention's path, tile, blocks, shared memory and keys
walked, and after the timing phase each flash shape's device time on
both tiles its plan chooses between); and, after phase 3:
  * RecurrentGemma-2B at full width and depth (26 layers, bf16, random
    weights from seed 0) served through `SlotServer` (6 requests, batch
    4, prompts of 4-16 tokens, 8 new tokens, cache 128): launch counts
    per prefill (8 flash, 18 scan, 26 MLP) and per decode step (8
    decode, 26 MLP), and its logits, teacher-forced with the card's
    tokens, against the same weights on the CPU through the plain
    versions in bf16 (within about twice the measured gap) and in float32
    (the control); then the same path in float32 on the card against the
    float32 twin (1e-3 of the logit scale: the wiring check);
  * the ring cache on the card: one 2,100-token prompt with cache 2048
    in fp32, 8 decode steps, each row against `forward` over all 2,108
    tokens;
  * stablelm-3b at full width and 4 layers (bf16, MHA with Dh 80,
    LayerNorm, gated SiLU), 4 requests, teacher-forced against the CPU
    the same way;
  * for both LM paths, decode tokens per second and prefill time per
    request, with the MLP's planned hidden splits and with its fewest,
    and the device's
    busy share of a drain under torch.profiler.

The bf16 slice (every weight bf16, `dataclasses.replace(cfg,
dtype="bfloat16")`) adds, to phase 2, kernels 1, 5 and 6 at DeiT-T full
width (batch 8) and Swin-T stages 1 (windowed) and 4, and kernel 7 at
DeiT-T (L 4) and Swin-T stage 3 (L 2), each on float32 activations
("mixed": held at 1e-5 of the output scale, the fp32 limit) and on bf16
ones (1e-2 of each output row's own scale), with their library
yardsticks; and, after phase 3:
  * bf16 DeiT-T and Swin-T at full width and depth served through a
    `VisionServer` built by hand on float32 images (mixed mode), fused,
    unfused and grouped (by 4 and by 2), float and int8 (calibrated on
    the card from the bf16 params): launch counts as their schedules
    launch, every launch of a kernel with dtype modes in its (float32,
    bfloat16) instantiation (`ops.MODE_LAUNCHES`), logits against the
    same server on the CPU under the fp32 / int8 contracts above;
  * `forward` on bf16 patches (bf16 throughout) for DeiT-T fused,
    unfused and grouped by 4 and Swin-T fused, 8 images each: every such
    launch in its (bfloat16, bfloat16) instantiation, the logits against
    the bf16 CPU twin (BF16_TWIN_REL) and the fp32 one (the control);
  * the served rates of the bf16 paths beside the fp32 ones, and one
    profiled bf16 drain.

The widened tiles (heads past 64, N past one cluster of the float MSA
tile) add, to phase 2, kernels 1, 2, 3 and 5 and the attention launch
alone at a ViT-B geometry of 6 heads of 128 (D 768, N 197) and at
ViT-B/16 at 384 px (N 576), batch 2, each against its plain version with
its plan printed (the paged MSA plan, the DP 128 attention tile), and
kernels 7 and 8 at the 6 x 128 geometry (L 2) against their plain
versions and, bit for bit, their chains of per-layer calls; and, after
the bf16 paths, those two configs (2 layers, random weights from seed 0)
served through a `VisionServer` built by hand in float and int8, each
against the same server on the CPU, their launches counted with the
served paths'.  The RG-LRU scan is checked and timed at T 13, 2,100 and
4,096 with its plan printed (`[plan] rglru_scan`: the walk up to one
32-step chunk, else the chunked scan's blocks and scratch), and past one
chunk timed beside the one-thread-per-channel walk it replaced.

The TNT slice adds, to phase 2, kernels 1, 2, 3, 5 and 6 at TNT-S's two
streams at bucket 8 (inner: 1,568 sequences of 16 pixel tokens, D 24, 4
heads of Dh 6, MLP 96; outer: N 196, D 384, 6 heads of 64, MLP 1,536),
kernels 1, 5 and 6 there with bf16 weights too, and kernel 4 at the
pixel-embed, fold and inner MLP products, each against its plain version
and timed; to phase 3, TNT-S (224 px, 12 layers) fused, unfused, in float
and int8, and grouped by 2 in float (the fused phase list, no
layer-group launch), TNT-S-p fused in float and int8, TNT-S with bf16
weights served fused (mixed mode) and its `forward` on bf16 patches; and
to phase 4, the profiled TNT-S float and int8 drains.

The open-stream and HUE slice adds phase 5, after phase 4's served
throughputs (whose closed-drain img/s sets the offered load):
  5a. DeiT-T fused at full width, float and int8 (phase 3's servers and
      frozen scales): `measure_bucket_latencies` for buckets 1-8, then one
      `poisson_trace` of 128 arrivals over the first 8 images of phase 3
      (seed 0) at 0.5x and 0.9x of the path's closed-drain img/s, SLA 3x
      the bucket-8 latency, through `run_open_stream` (ring of 2) and the
      same trace through `run_drain_stream`: every arrival served, no
      request on an infeasible bucket, launches = micro-batches x the
      schedule's, each request's logits against the CPU twin of its bank
      image (`check_twin`), every `dispatch` of a continuous run under
      ``torch.cuda.set_sync_debug_mode("error")`` (`strict_dispatch`: a
      host sync in it fails the run); each stats row printed, and the
      device's busy share of the 0.9x int8 stream, continuous beside drain
      (`profile_run`);
  5b. DeiT-T and Swin-T in float as two lanes of one admission layer, 64
      arrivals: ``per_model`` equal to the trace's counts, logits against
      the twins;
  5c. the live HUE profile (`VisionServer.profile_stats`) of DeiT-T float
      and int8 fused at buckets 1 and 8, unfused and grouped by 4 in both
      modes at bucket 8, Swin-T and TNT-S float fused at bucket 8: each
      table printed (HUEmeas% is a ViTA-clock equivalent), the replay's
      records the schedule's phases in order, every kind but the head
      modelled, its logits equal to `run_schedule`'s within 1e-6 of the
      logit scale, launches counted.
  Their launches join each kernel's count in the JSON line.

The sharding slice adds phase 6, the mesh on the card, last (after the
kernel and LM times, whose profiler sessions it would disturb):
ranks spawned on this one card (`launch.mesh.start_world`; gloo, since
they share the card, or NCCL with one rank per card; the `[mesh]` line
names the backend, ranks and cards):
  6a. `run_schedule_sharded` of a bucket of 8 at full width and depth,
      each against the single-device `run_schedule` on the card (float
      within 1e-4 of the logit scale, int8 within 0.02 with a differing
      argmax only at a near-tie): DeiT-T on "1x3" float and int8, fused
      and unfused, and float grouped by 4 (the split per-layer chain);
      Swin-T on "1x2" float and int8 fused (stage 1's 3 heads replicate,
      stages 2-4 split); TNT-S on "1x2" float; DeiT-T on "2x1" float, and
      grouped by 4 in float and int8 (the group kernels on a data mesh).
      Each rank's launch counts must be one micro-batch of the schedule's;
      then kernels 1-6 at one local DeiT-T shape of each rank of "1x3"
      against their plain versions on the same shards;
  6b. DeiT-T servers on "1x3" (11 requests) and "2x1" (5) in float and
      int8 against phase 3's single-device servers' logits, then img/s,
      p50 and the card's busy share (the ranks' kernel time summed) over
      32 requests;
  6c. `serve_stream(["deit_t"], latency_mesh="1x3")` at an SLA below the
      single-device bucket-1 latency: every arrival served, some routed to
      the latency mesh.
  A rank that fails or times out fails the script.  The phase's launches,
  summed over the ranks, join each kernel's count in the JSON line.

The slice that finishes the LM side adds, to phase 2, kernels 6, 9 and 10
at its paths' shapes (flash non-causal at HuBERT-XLarge's 4 clips of 500
frames, 16 heads of 80, and causal at InternVL2-26B's GQA prefill of
1,040 tokens, 48 over 8 heads of 128; decode at InternVL2's group of 6
over 1,088 slots; the fused MLP at HuBERT's 2,000 rows and InternVL2's
prefill and decode rows), each against its plain version and timed
beside its library yardstick; and phase 7, the rest of the LM side, run
after the LM times and before phase 6 (whose ranks' profiler sessions
leave this process's profiler dropping device events), each model freed
before the next:
  7a. OLMoE-1B-7B at full width and depth (16 layers, 64 experts, top 8)
      and Mixtral-8x7B at full width, 2 layers (top 2 of 8 experts of
      14,336), served in bf16 through `SlotServer` (6 requests at batch
      4), each against its bf16 CPU twin replaying the server's own calls
      (`replay`: each request's prefill, then decode steps fed the card's
      tokens), the (token, layer) routings that differ counted; then in
      float32 (OLMoE at full width, 4 layers) against the float32 twin,
      and the card's decode against its `forward` at a dropless capacity
      (Mixtral's after a 4,200-token prompt, past its 4,096-token window:
      the ring cache);
  7b. xLSTM-1.3B at full width and depth (6 sLSTM and 42 mLSTM blocks)
      served in bf16 and float32 against its twins' `forward` (the
      parallel mLSTM form, where the server runs the recurrent one), its
      decode against its forward;
  7c. HuBERT-XLarge at full width, 16 layers: `forward` on 4 clips of 500
      frames (numpy, seed 11), bf16 and float32, against its twins;
  7d. InternVL2-26B at full width, 2 layers, through `launch.steps`: one
      prefill of 1,024 patch embeddings + 16 tokens, 8 decode
      steps, bf16 and float32 against the twins replaying the same calls,
      its decode against its forward.
  Each path's launches equal `expected_lm_launches` (an MoE layer or an
  xLSTM block launches none of the port's kernels); decode tok/s,
  prefill ms, and one decode step's and one prefill's device events and
  busy shares are printed.  Their launches join each kernel's count
  in the JSON line.

The training slice adds, to phase 2, the gradient path of kernels 9, 6
and 11 (`ops._KernelGrad`: the kernel forward, the plain version's
autograd backward) at its paths' shapes: Danube-1.8B's attention (8 x
256 tokens, 32 over 8 heads of 80) and gated SiLU MLP (2,048 rows) in
bf16, RecurrentGemma-2B's attention (10 over 1 head of 256) and RG-LRU
scan (W 2,560, T 128) in fp32; every input's gradient against autograd
of the plain version, forward + backward timed beside the plain version
and the library yardstick (SDPA forward and backward; matmul + SiLU +
matmul forward and backward; none for the scan); phase 8, training, after
phase 7 and before phase 6, each model freed before the next:
  8a. Danube-1.8B at full width and depth in bf16, TRAIN_STEPS steps of
      `make_train_step` on TRAIN_BATCH x TRAIN_SEQ `SyntheticLM` tokens
      (`linear_warmup_cosine(1e-3, 2, 6)`): every loss and grad_norm
      finite, every parameter leaf a finite non-zero gradient, the
      launches of flash_attention and fused_mlp 24 a step each
      (`expected_lm_launches`); the loss history, step ms (CUDA events),
      tokens/s, peak device memory, one step's device events and busy
      share, and the model FLOPs (6 x active params x tokens) over the
      bf16 peak;
  8b. Danube-1.8B at full width, TWIN_LAYERS layers, float32, TWIN_STEPS
      steps, against its CPU twin (the same weights and batches, the
      twin replaying each step): the loss, every metric, every gradient
      leaf at the same params, every updated parameter and both moments
      (`train_twin`); with ``bf16_reduce`` off and on (the rms_mp norm,
      whose losses must agree with the rms run's in float32);
  8c. RecurrentGemma-2B at full width, pattern rec, rec, attn (3 layers),
      float32, one step against its CPU twin likewise (T 128: the chunked
      scan; rglru_scan launched twice);
  8d. `launch.train.main --reduced` on the card: 8 steps straight against
      4 steps, a checkpoint and ``--resume`` to 8; the last losses within
      1e-4.
  Their launches join each kernel's count in the JSON line.  Phase 6 adds
  6d: `pipeline_apply` (GPipe, one Danube-1.8B block a stage in bf16,
  PIPE_MICRO microbatches) over the world's ranks against the stages run
  one after another on rank 0, with its bubble fraction and ms.

The seventeenth slice adds phase 9, after phase 8 and before phase 6:
  9a. DeiT-S at full size (224 px, 12 layers, D 384, 6 heads of 64, 196
      tokens), random weights from seed 0, served fused in float and int8
      through `VisionServer` at bucket 8 with DEIT_S_REQUESTS images
      (`serve_user_path`: launches, CPU twin at phase 3's bounds), then
      img/s, p50 and the card's busy share of a drain;
  9b. `quantize_params` on Danube-1.8B's whole bf16 tree on the card (one
      scale a channel over a pattern position's layers), a percentile
      scale over its 17.7M-element up projection against the CPU's, and
      `quantized_linear` on kernel 4 at the up projection (2,048 x 2,560
      x 6,912): the int32 accumulators equal to the plain version's, the
      kernel timed beside the plain version and `torch._int_mm` (a new
      other shape of int8_matmul in the JSON line);
  9c. kernel 1's gradient path (`ops._KernelGrad`) at DeiT-S b8, every
      input's gradient against the plain version's autograd bit for bit,
      forward + backward timed (an other shape of vita_layer); one
      full-size DeiT-S training step at batch 8 against its CPU twin
      (1e-3 of each gradient leaf's scale); examples/
      serve_quantized_vit_torch.py in-process: VIT_EDGE_STEPS AdamW steps
      of vit_edge (the loss must fall), PTQ and float / int8 drains;
  9d. tools/hue_report_torch.py on DeiT-T and Swin-T in both modes at
      batch 8 with --json-out: exit 0, the modelled columns equal to
      `core.hue`'s for the same schedule;
  9e. the dry run (`launch.dryrun.lower_cell`, the meta device) for
      Danube-1.8B at the four shapes on the 16 x 16 pod and Qwen2.5-32B's
      train_4k on the 2 x 16 x 16 pods: flops_global over
      model_flops_global and each cell's time;
  9f. examples/quickstart_torch.py and examples/train_lm_torch.py --small
      as subprocesses (a non-zero exit fails the script).
  Its launches (9a-9d) join each kernel's count in the JSON line.

The line before the last is one JSON object with a record per kernel
(each time marked with how it was taken: "profiler" or "cuda_events");
the last line is {"ok": true, "device": {...}}.  Without a card, or without
the repository's sources beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense), used for bounds.
HBM_BYTES_PER_S = 3.35e12
# fp32-accurate products: split TF32 at the 495 TFLOP/s TF32 rate (the
# card's fastest fp32 route, which kernels 1 and 5 take; every fp32 row is
# held to it, against 67 TFLOP/s outside the tensor cores): three passes
# where both operands are fp32, two where one is bf16 (exact in TF32).
FP32_FLOP_PER_S = 495e12 / 3
MIXED_FLOP_PER_S = 495e12 / 2    # fp32 x bf16 products
INT8_OP_PER_S = 1979e12          # int8 tensor-core peak
BF16_FLOP_PER_S = 989e12         # bf16 dense tensor-core peak

B_MAIN = 8                       # the largest serving bucket
# torch._int_mm (the int8 matmul's library yardstick) takes more than 16
# rows only.
INT_MM_MIN_ROWS = 16
BUCKETS = (1, 2, 4, 8)
N_CAL = 4                        # calibration batches (8 images, 4 x 2)

# Served paths: (model, mode, fused, group size, requests).  19 = 8 + 8 +
# 3 and 11 = 8 + 3: a ragged tail padded to a bucket of 4; 9 = 8 + 1.
# DeiT-T grouped by 4 is 3 layer groups; Swin-T grouped by 2 is 1 group
# (stage 4) and 10 layers; DeiT-T-p keeps 3, 2 or 1 heads per layer; TNT-S
# grouped by 2 forms no group (a fold sits between every two layers of a
# stream), so it compiles the fused phase list; TNT-S-p prunes the outer
# stream only.
PATHS = (("deit_t", "float", True, 1, 19), ("deit_t", "int8", True, 1, 19),
         ("deit_t", "float", False, 1, 11), ("deit_t", "int8", False, 1, 11),
         ("swin_t", "float", True, 1, 11), ("swin_t", "int8", True, 1, 11),
         ("swin_t", "float", False, 1, 11),
         ("deit_t", "float", True, 4, 19), ("deit_t", "int8", True, 4, 19),
         ("swin_t", "float", True, 2, 11), ("swin_t", "int8", True, 2, 11),
         ("deit_t_p", "float", True, 1, 11), ("deit_t_p", "int8", True, 1, 11),
         ("swin_t_p", "float", True, 1, 11),
         ("tnt_s", "float", True, 1, 9), ("tnt_s", "int8", True, 1, 9),
         ("tnt_s", "float", False, 1, 9), ("tnt_s", "int8", False, 1, 9),
         ("tnt_s", "float", True, 2, 9),
         ("tnt_s_p", "float", True, 1, 9), ("tnt_s_p", "int8", True, 1, 9))
MODELS = ("deit_t", "swin_t", "deit_t_p", "swin_t_p", "tnt_s", "tnt_s_p")

# The bf16 configuration (`dataclasses.replace(cfg, dtype="bfloat16")`:
# every weight bf16), which the registry does not build: served through a
# `VisionServer` built by hand on float32 images (mixed mode: float32
# activations, bf16 weights), (model, mode, fused, group size, requests);
# 9 = 8 + 1, a ragged tail.  And `forward` on bf16 patches (bf16
# throughout), (model, fused, group size), 8 images each.
BF16_PATHS = (
    ("deit_t", "float", True, 1, 9), ("deit_t", "float", False, 1, 9),
    ("deit_t", "float", True, 4, 9), ("deit_t", "int8", True, 1, 9),
    ("deit_t", "int8", False, 1, 9), ("deit_t", "int8", True, 4, 9),
    ("swin_t", "float", True, 1, 9), ("swin_t", "float", False, 1, 9),
    ("swin_t", "float", True, 2, 9), ("swin_t", "int8", True, 1, 9),
    ("swin_t", "int8", False, 1, 9), ("swin_t", "int8", True, 2, 9),
    ("tnt_s", "float", True, 1, 9))
BF16_FORWARDS = (("deit_t", True, 1), ("deit_t", False, 1),
                 ("deit_t", True, 4), ("swin_t", True, 1), ("tnt_s", True, 1))
# Kernel checks in the bf16 modes: mixed mode is fp32 math on exactly
# upcast weights (the fp32 limit); bf16 a few bf16 ulps of each output
# row's own scale.
MIXED_TOL, BF16_TOL = 1e-5, 1e-2
# The bf16 forwards' logits against CPU twins of the same weights, as a
# share of the logit scale: the bf16 twin within about twice the gap
# measured on the card (bf16 rounding falls at other places in the kernels
# and in the plain versions, and compounds with depth: on an H100 80GB HBM3
# at 700 W, 0.44% at DeiT-T's 12 layers, 0.49% at Swin-T's and 0.43% at
# TNT-S's 24 (12 inner, 12 outer)), the fp32 twin (the weights' exact
# values) as the control (0.26-0.38% there).
BF16_TWIN_REL = {"deit_t": 0.01, "swin_t": 0.01, "tnt_s": 0.01}
BF16_CONTROL_REL = 0.01
# The kernels whose launches `ops.MODE_LAUNCHES` splits by dtype mode, and
# those counts summed over the run's bf16 paths.
MODE_KERNELS = ("vita_layer", "vita_layer_int8", "vita_msa_batched",
                "fused_mlp", "vita_layer_group", "vita_layer_group_int8")
MODE_TOTALS: dict = {}
# The int8 group cases' chains of L `vita_layer_int8` calls, (tag,
# callable), timed beside kernel 8.
I8_CHAINS: list = []
# The scan's shapes past one chunk with the walk forced, (tag, callable),
# timed beside the planned launch.
SCAN_WALKS: list = []

KERNELS = (  # name, TPU kernel it replaces, port wrapper
    ("vita_layer", "src/repro/kernels/vita_layer.py:174",
     "src/repro_torch/kernels/vita_layer.py"),
    ("vita_layer_int8", "src/repro/kernels/vita_layer.py:430",
     "src/repro_torch/kernels/vita_layer.py"),
    ("vita_msa_int8", "src/repro/kernels/vita_msa.py:241",
     "src/repro_torch/kernels/vita_msa.py"),
    ("int8_matmul", "src/repro/kernels/int8_matmul.py:98",
     "src/repro_torch/kernels/int8_matmul.py"),
    ("vita_msa_batched", "src/repro/kernels/vita_msa.py:138",
     "src/repro_torch/kernels/vita_msa.py"),
    ("fused_mlp", "src/repro/kernels/fused_mlp.py:121",
     "src/repro_torch/kernels/fused_mlp.py"),
    ("vita_layer_group", "src/repro/kernels/vita_layer.py:300",
     "src/repro_torch/kernels/vita_layer_group.py"),
    ("vita_layer_group_int8", "src/repro/kernels/vita_layer.py:572",
     "src/repro_torch/kernels/vita_layer_group.py"),
    ("flash_attention", "src/repro/kernels/head_attention.py:102",
     "src/repro_torch/kernels/head_attention.py"),
    ("decode_attention", "src/repro/kernels/head_attention.py:192",
     "src/repro_torch/kernels/head_attention.py"),
    ("rglru_scan", "src/repro/kernels/rglru_scan.py:75",
     "src/repro_torch/kernels/rglru_scan.py"))

# The widened tiles (heads past 64, N past one cluster of the float MSA
# tile): (tag, heads of ViT-B/16's D 768, N) of the kernel checks, batch
# 2: a ViT-B geometry of 6 heads of 128 at 197 tokens, and ViT-B/16 at 384
# px (576 patches).  The wide groups and the served wide configs take
# WIDE_LAYERS layers; the served ones WIDE_REQUESTS images.
WIDE = (("vit_b16 6x128", 6, 197), ("vit_b16 384px", 12, 576))
WIDE_LAYERS, WIDE_REQUESTS = 2, 3
# The tag of the kernel shapes TNT-S's two streams give (`tnt_kernel_phase`).
TNT_TAG = "tnt_s"

# The LM paths: RecurrentGemma-2B at full width and depth (bf16), its
# ring-cache check (fp32, a prompt past the 2048-token window) and
# stablelm-3b at full width, 4 layers (bf16).
LM_REQUESTS, LM_BATCH, LM_MAX_NEW, LM_PROMPT, LM_CACHE = 6, 4, 8, 16, 128
RING_PROMPT, RING_CACHE, RING_NEW = 2100, 2048, 8
LM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Phase 8: Danube-1.8B trained at full width and depth in bf16 (8a),
# TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens; the float32 twins
# (8b: Danube at TWIN_LAYERS layers, TWIN_STEPS steps; 8c:
# RecurrentGemma-2B's rec, rec, attn, one step) on TWIN_BATCH x
# TWIN_SEQ tokens.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 6
TWIN_BATCH, TWIN_SEQ, TWIN_LAYERS, TWIN_STEPS = 2, 128, 2, 2
# The served LM logits, teacher-forced, against CPU twins of the same
# weights through the plain versions, as a share of the logit scale.  Each
# LM path is served twice on the card.  In float32 (the wiring check) the
# paths differ by reassociation only: LM_FP32_REL, the vision float
# paths' and the ring check's bound.  In bf16 (the config's dtype, the
# slice) against a bf16 twin, bf16 rounding is on both sides, but where it
# falls differs (cuBLAS against the CPU's GEMMs, P rounded in the flash
# kernel) and the differences compound with depth: on an H100 80GB HBM3 at
# 700 W, 3.6% at RecurrentGemma-2B's 26 layers and 1.1% at stablelm-3b's
# 4, so LM_TWIN_REL is about twice that.  The fp32 twin of the bf16 path
# is the control (4.3% and 1.1% there): it must stay within
# LM_CONTROL_REL.
LM_FP32_REL = 1e-3
LM_TWIN_REL = {"recurrentgemma-2b": 0.07, "stablelm-3b": 0.02}
LM_CONTROL_REL = 0.1
# Phase 7: the rest of the LM side, random weights from seed 0.
# OLMoE-1B-7B at full width and depth (bf16) and at full width, 4 layers
# (float32, the wiring check); Mixtral-8x7B at full width, 2 layers;
# xLSTM-1.3B at full width and depth; each served through `SlotServer`
# (P7_REQUESTS requests at LM_BATCH); HuBERT-XLarge at full width,
# HUBERT_LAYERS of its 48 layers, `forward` on HUBERT_CLIPS clips of
# HUBERT_FRAMES frames;
# InternVL2-26B at full width, IVL_LAYERS layers, through `steps`: one
# prefill of IVL_BATCH sequences of IVL_IMAGE patch embeddings and
# IVL_PROMPT text tokens, then IVL_NEW - 1 decode steps, over IVL_CACHE
# cache slots.  Each decoder's card decode is held against its card
# `forward` in float32 (`decode_check`): Mixtral's over a prompt of
# MIXTRAL_RING_PROMPT tokens, past its 4,096-token window (the ring
# cache), the MoE models at a dropless capacity.
P7_REQUESTS = 6
# InternVL2 runs 2 layers and HuBERT 16 to keep the script's time: their
# CPU twins take 39 s at 4 layers and 41 s at 48 (H100 machine, 8 cores).
OLMOE_FP32_LAYERS, MIXTRAL_LAYERS, IVL_LAYERS = 4, 2, 2
HUBERT_CLIPS, HUBERT_FRAMES, HUBERT_LAYERS = 4, 500, 16
IVL_BATCH, IVL_IMAGE, IVL_PROMPT, IVL_NEW, IVL_CACHE = 1, 1024, 16, 9, 1088
MIXTRAL_RING_PROMPT, DECODE_CHECK_NEW = 4200, 9
# The phase-7 paths' bf16 logits against their bf16 CPU twins, about
# twice the gap measured on an H100 80GB HBM3 at 700 W (as LM_TWIN_REL;
# the runs are deterministic: two runs gave the same gaps): HuBERT-XLarge
# 1.7%, InternVL2-26B (4 layers) 1.1-1.3%; the MoE twins replay the
# server's own calls (`moe_twin`), and where bf16 rounding flips a
# routing the token's output moves by that expert's share: OLMoE 4.4%
# with 197 of 1,712 routings flipped, Mixtral (2 layers) 29% with 2 of
# 214 (each flip swaps half of a 14,336-wide feed-forward).  Random-weight
# xLSTM-1.3B in bf16 is chaotic: its mLSTM blocks amplify a perturbation
# one after another (in either package; see tests/test_torch_lm.py), so the
# card and a bf16 or fp32 CPU twin part by 80-88% of the logit scale and
# pick other tokens on 36-38 of 48; its bf16 bounds hold finiteness and
# shape only, and its float32 path is its check: against the fp32 twin's
# `forward` (the parallel form) 0.24%, the card's decode against its own
# forward 1.7e-4 (DECODE_REL).
LM_TWIN_REL.update({"olmoe-1b-7b": 0.1, "mixtral-8x7b": 0.6,
                    "xlstm-1.3b": 2.0, "hubert-xlarge": 0.04,
                    "internvl2-26b": 0.03})
DECODE_REL = {"xlstm-1.3b": 4e-4}
LM_CONTROL_REL_BY_ARCH = {"xlstm-1.3b": 2.0}
LM_FP32_REL_BY_ARCH = {"xlstm-1.3b": 5e-3}
# Phase 5: open streams on the card.  Each DeiT-T stream replays
# STREAM_ARRIVALS Poisson arrivals (seed 0) over the first STREAM_BANK
# images of phase 3, offered at each of STREAM_LOADS times the same path's
# closed-drain img/s from phase 4, with a latency budget of SLA_FACTOR
# times the measured bucket-8 latency, through the admission layer (ring
# of MAX_INFLIGHT) and, the same trace, through the drain baseline.  The
# two-lane stream (DeiT-T and Swin-T in float) offers LANE_ARRIVALS at
# LANE_LOAD times the slower lane's closed-drain rate.
STREAM_ARRIVALS, STREAM_BANK, LANE_ARRIVALS = 128, 8, 64
STREAM_LOADS, LANE_LOAD, SLA_FACTOR, MAX_INFLIGHT = (0.5, 0.9), 0.5, 3.0, 2
# The live HUE profiles: (model, mode, fused, group size, bucket), from
# phase 3's servers; a profile replays its schedule HUE_REPLAYS times (one
# warm-up, two timed).
HUE_CASES = (("deit_t", "float", True, 1, 1), ("deit_t", "float", True, 1, 8),
             ("deit_t", "int8", True, 1, 1), ("deit_t", "int8", True, 1, 8),
             ("deit_t", "float", False, 1, 8), ("deit_t", "int8", False, 1, 8),
             ("deit_t", "float", True, 4, 8), ("deit_t", "int8", True, 4, 8),
             ("swin_t", "float", True, 1, 8), ("tnt_s", "float", True, 1, 8))
HUE_REPLAYS = 3


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """(ms, timed_by): the mean device time of one call of ``fn``, the
    kernels and copies it runs on the card summed by torch.profiler over
    ``iters`` calls (3 where one call takes more than 5 ms, 1 where it
    takes more than 20 ms: the plain scan at T 4,096 is ~12,000 launches
    a call, and the profiler takes about 13 s a call to sum them), and
    "profiler".  Gaps in which the device waits for the host do not count.
    After many sessions in one process the profiler drops a few device
    events of a session now and then: a session whose count of device
    events is not a multiple of its calls is run again, twice at most, and
    then the time is taken with CUDA events instead, marked "cuda_events":
    device time where the card outruns the host's launches, else the
    host's launch rate, so it is no kernel time for a callable of many
    launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    if took > 20e-3:
        iters = 1
    elif took > 5e-3:
        iters = 3
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in rows)
        n = sum(e.count for e in rows)
        if us > 0 and n % iters == 0:
            return us / iters / 1e3, "profiler"
    print(f"[time] the profiler saw {n} device events over {iters} calls "
          f"({us:.1f} us), three times: timed with CUDA events instead")
    return time_ms(fn, iters, warmup), "cuda_events"


def ptxas_lines(log: str) -> list:
    """nvcc's wall time and, per kernel (demangled by c++filt where the
    machine has it), ptxas's registers and spills."""
    lines = log.splitlines()
    names = [ln.split("'")[1] for ln in lines
             if "Compiling entry function" in ln]
    try:
        demangled = subprocess.run(
            ["c++filt"], input="\n".join(names), capture_output=True,
            text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        demangled = names
    short = dict(zip(names, (d.replace("void ", "").replace(
        "repro_torch::", "").split("(")[0] for d in demangled)))
    out, current, spill = [lines[0]] if lines else [], None, ""
    for ln in lines:
        if "Compiling entry function" in ln:
            current = short.get(ln.split("'")[1], "?")
        elif "spill" in ln:
            spill = ", ".join(x.strip() for x in ln.split(",")[1:])
        elif "registers" in ln and current:
            out.append(f"{current}: {ln.split(':', 1)[1].strip()}; {spill}")
            current, spill = None, ""
    return out


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time per call of ``fn`` over ``iters`` calls between two CUDA
    events: device time where the card outruns the host's launches,
    otherwise the host's launch rate."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(flops_f32: float = 0.0, ops_i8: float = 0.0, nbytes: float = 0.0,
          flops_bf16: float = 0.0, flops_mixed: float = 0.0):
    """(bound_ms, bound_by): the larger of the compute time at peak for
    each pair of operand types and the bytes over the memory rate."""
    t_ops = flops_f32 / FP32_FLOP_PER_S + ops_i8 / INT8_OP_PER_S \
        + flops_bf16 / BF16_FLOP_PER_S + flops_mixed / MIXED_FLOP_PER_S
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                    else "bytes")


def argmax_check(got: np.ndarray, want: np.ndarray, err: float):
    """(rows whose argmax differs, whether each of them is a near-tie).

    A difference of at most ``err`` can move the argmax of a row only
    where the reference's top two values lie within 2 * err, so a differing
    argmax is allowed there and nowhere else."""
    got = got.reshape(-1, got.shape[-1])
    want = want.reshape(-1, want.shape[-1])
    differ = got.argmax(1) != want.argmax(1)
    top2 = np.sort(want, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) <= 2 * err
    return int(differ.sum()), bool(np.all(near_tie[differ]))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def check_close(name: str, got, want, tol: float = 1e-4) -> float:
    """Float kernel against its plain version: max|err| <= tol x max(1,
    output scale) (fp32 reassociation only)."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"[check] {name}: max|err| {err:.3e} (scale {scale:.3f}, bound "
          f"{tol:g} x max(1, scale))")
    check(got.dtype == want.dtype and bool(torch.isfinite(got).all())
          and err <= tol * max(1.0, scale),
          f"{name} disagrees with its plain version")
    return err


def check_int8_layer(name: str, got, want) -> float:
    """int8 layer against its plain version: an LSB flip at a requant
    boundary moves a value by about one activation scale times a weight,
    so max|err| <= 0.02 x scale, and a token whose argmax differs must be
    a near-tie."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    n_differ, ties = argmax_check(got.cpu().numpy(), want.cpu().numpy(), err)
    print(f"[check] {name}: max|err| {err:.3e} (scale {scale:.3f}, bound "
          f"0.02 x scale); per-token argmax differs on {n_differ} of "
          f"{got.shape[0] * got.shape[1]} tokens, each a near-tie: {ties}")
    check(err <= 0.02 * scale and ties, f"{name} disagrees")
    return err


def check_int8_teacher_forced(name: str, steps) -> float:
    """The card's chain of `vita_layer_int8` calls held layer by layer:
    ``steps`` is each layer's (card output, plain version's output on the
    chain's own input to that layer), each held as `check_int8_layer` holds
    a layer (max|err| <= 0.02 x scale, a differing argmax only at a
    near-tie), so requant flips cannot compound from one layer into the
    next.  Prints every layer's share of its bound and the worst layer;
    returns the worst max|err|."""
    torch.cuda.synchronize()
    worst, worst_ratio, errs = 0, -1.0, []
    for l, (got, want) in enumerate(steps):
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        n_differ, ties = argmax_check(got.cpu().numpy(), want.cpu().numpy(),
                                      err)
        ratio = err / (0.02 * scale)
        errs.append(err)
        print(f"[check] {name} teacher-forced layer {l}: max|err| {err:.3e} "
              f"(scale {scale:.3f}, {ratio:.3f} of the 0.02 x scale bound); "
              f"argmax differs on {n_differ} tokens, each a near-tie: "
              f"{ties}")
        check(err <= 0.02 * scale and ties,
              f"{name} layer {l} disagrees with its plain version")
        if ratio > worst_ratio:
            worst, worst_ratio = l, ratio
    print(f"[check] {name} teacher-forced: worst layer {worst} of "
          f"{len(steps)}, max|err| {errs[worst]:.3e} = {worst_ratio:.3f} of "
          f"its bound")
    return max(errs)


# ---------------------------------------------------------------------------
# Kernel inputs at the main paths' shapes
# ---------------------------------------------------------------------------


def perturbed(bp: dict, g: torch.Generator) -> dict:
    """A copy of block ``bp`` with non-zero LN and MLP biases, in the
    block's dtype."""
    bp = dict(bp)
    for k in ("ln1_b", "ln2_b", "b_up", "b_down"):
        bp[k] = (bp[k].float() + 0.1 * torch.randn(
            bp[k].shape, generator=g, device="cuda")).to(bp[k].dtype)
    return bp


def layer_args(bp: dict, x, bias=None, mask=None):
    """Float and int8 layer-kernel arguments for block ``bp`` on ``x``
    (B', N, D), act scales from max-abs statistics of the plain float
    layer on that input (windowed when ``bias``/``mask`` are given)."""
    from repro_torch.core.quant import INT8_MAX, quantize_vision_params
    from repro_torch.kernels import ref

    h, _, dh = bp["wq"].shape
    f_args = (x, bp["wq"], bp["wk"], bp["wv"], bp["w_msa"], bp["ln1_w"],
              bp["ln1_b"], bp["ln2_w"], bp["ln2_b"], bp["w_up"], bp["b_up"],
              bp["w_down"], bp["b_down"])
    z = ref.layer_norm_ref(x, bp["ln1_w"], bp["ln1_b"])
    qkv = torch.matmul(z, ref._merge_qkv(bp["wq"], bp["wk"], bp["wv"]))
    sa = ref._attend_heads(*ref._split_qkv(qkv, h, dh), dh, bias, mask)
    h1 = x + sa @ bp["w_msa"]
    z2 = ref.layer_norm_ref(h1, bp["ln2_w"], bp["ln2_b"])
    hid = ref.gelu(z2 @ bp["w_up"] + bp["b_up"])
    acts = torch.stack([t.abs().amax() for t in (z, sa, z2, hid)]) / INT8_MAX
    q = quantize_vision_params(
        {k: bp[k] for k in ("wq", "wk", "wv", "w_msa", "w_up", "w_down")})
    i_args = (x, q["wq"].values, q["wk"].values, q["wv"].values,
              q["w_msa"].values, q["w_up"].values, q["w_down"].values,
              acts.float().contiguous(),
              *[q[k].scale.reshape(h, dh) for k in ("wq", "wk", "wv")],
              *[q[k].scale.reshape(-1) for k in ("w_msa", "w_up", "w_down")],
              bp["ln1_w"], bp["ln1_b"], bp["ln2_w"], bp["ln2_b"], bp["b_up"],
              bp["b_down"])
    return f_args, i_args


def vit_block(cfg, seed: int, g):
    """Layer 0 of a one-layer ``cfg`` and an input of unit scale."""
    from repro_torch.models import vit

    one = dataclasses.replace(cfg, layers=1)
    bp = perturbed(vit.init_params(one, seed, "cuda")["layers"][0], g)
    return bp, torch.randn((B_MAIN if cfg.dim < 768 else 2, cfg.tokens,
                            cfg.dim), generator=g, device="cuda")


def swin_block(params, cfg, s_i: int, b_i: int, g):
    """Block ``b_i`` of Swin stage ``s_i`` (-1: the last) at bucket 8: a
    tag, the block, its window-folded unit-scale input (B * nW, 49, D),
    and its relative-position bias and shifted-window mask, as the
    executor forms them."""
    from repro_torch.core import schedule as sched

    s_i %= len(cfg.depths)
    side, dim = cfg.stage_side(s_i), cfg.stage_dim(s_i)
    n_w = (side // cfg.window) ** 2
    shift = cfg.window // 2 if b_i % 2 and n_w > 1 else 0
    ph = sched.Phase(kind="layer", path=(), site="", grid=(side, side),
                     window=cfg.window, shift=shift)
    bp = perturbed(params["stages"][s_i]["blocks"][b_i], g)
    x = torch.randn((B_MAIN, side * side, dim), generator=g, device="cuda")
    bias, mask = sched._window_terms(ph, bp, torch.device("cuda"))
    return (f"swin_t s{s_i}.b{b_i} windowed", bp, sched._fold(ph, x), bias,
            mask)


def layer_flops(b, n, d, h, dh, m):
    """(projection/MLP matmul ops, attention ops) of one layer call."""
    proj = 2 * b * n * d * (3 * h * dh) + 2 * b * n * (h * dh) * d \
        + 2 * 2 * b * n * d * m
    attn = 2 * 2 * b * h * n * n * dh
    return proj, attn


def sdpa_mask(bias, mask, b: int):
    """bias (H, n, n) + mask (nW, n, n) as one (B', H, n, n) additive
    attention mask for F.scaled_dot_product_attention."""
    if bias is None:
        return None
    n_w = mask.shape[0]
    return (bias[None] + mask[:, None]).repeat(b // n_w, 1, 1, 1)


def composed_layer(args, h: int, dh: int, bias=None, mask=None):
    """The float layer as a composition of library calls (cuBLAS matmuls,
    F.layer_norm, F.scaled_dot_product_attention, F.gelu), in the
    arguments' dtype — a yardstick the port never calls."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    (x, wq, wk, wv, w_msa, l1w, l1b, l2w, l2b, w_up, b_up, w_down,
     b_down) = args
    wqkv = ref._merge_qkv(wq, wk, wv)
    b, n, d = x.shape
    am = sdpa_mask(bias, mask, b)
    am = None if am is None else am.to(x.dtype)

    def run(xi=x):
        z = F.layer_norm(xi, (d,), l1w, l1b, 1e-5)
        q, k, v = ref._split_qkv(z @ wqkv, h, dh)
        sa = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
        h1 = xi + sa.permute(0, 2, 1, 3).reshape(b, n, h * dh) @ w_msa
        z2 = F.layer_norm(h1, (d,), l2w, l2b, 1e-5)
        return h1 + F.gelu(z2 @ w_up + b_up, approximate="tanh") @ w_down \
            + b_down
    return run


def composed_group(f_args, bias=None, mask=None):
    """The float layer group as L `composed_layer` yardsticks in a row."""
    n_l, h, _, dh = f_args[1].shape
    runs = [composed_layer((f_args[0],) + tuple(a[l] for a in f_args[1:]),
                           h, dh, None if bias is None else bias[l], mask)
            for l in range(n_l)]

    def run():
        y = f_args[0]
        for r in runs:
            y = r(y)
        return y
    return run


def composed_msa(z, wq, wk, wv, bias=None, mask=None):
    """The float per-head MSA as torch.matmul projections and
    F.scaled_dot_product_attention — a yardstick the port never calls."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    h, _, dh = wq.shape
    wqkv = ref._merge_qkv(wq, wk, wv)
    am = sdpa_mask(bias, mask, z.shape[0])
    am = None if am is None else am.to(z.dtype)

    def run():
        q, k, v = ref._split_qkv(z @ wqkv, h, dh)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=am)
    return run


def composed_mlp(x, w1, b1, w2, b2):
    """addmm + tanh-GELU + addmm — a yardstick the port never calls."""
    import torch.nn.functional as F
    x2 = x.reshape(-1, x.shape[-1])

    def run():
        return torch.addmm(b2, F.gelu(torch.addmm(b1, x2, w1),
                                      approximate="tanh"), w2)
    return run


def msa_bound(z, wq, bias=None, mask=None, qkv_bias=None, int8=False):
    """Bound of a per-head MSA call: the projections (int8, or at the rate
    of z's and the weights' types, `flops_at`) and the attention (fp32
    unless z is bf16), against z, the three weight stacks, the window
    terms and the (B, H, N, Dh) output (float32 for int8, else z's
    type)."""
    b, n, d = z.shape
    h, _, dh = wq.shape
    proj = 2 * b * n * d * 3 * h * dh
    attn = 2 * 2 * b * h * n * n * dh
    out_size = 4 if int8 else z.element_size()
    moved = nbytes(z, bias, mask, qkv_bias) + 3 * nbytes(wq) \
        + b * h * n * dh * out_size
    if int8:
        return bound(ops_i8=proj, flops_f32=attn, nbytes=moved)
    return bound(nbytes=moved, **flops_at(z.dtype, proj, wq.dtype, attn))


def mlp_bound(x, w1, b1, w2, b2):
    rows = x.numel() // x.shape[-1]
    d, m = w1.shape
    d_out = w2.shape[1]
    return bound(nbytes=nbytes(x, w1, b1, w2, b2)
                 + rows * d_out * x.element_size(),
                 **flops_at(x.dtype, 2 * rows * m * (d + d_out), w1.dtype))


def float_layer_bound(f_args, bias=None, mask=None):
    """Bound of a float layer call, or of a group call (stacked operands:
    L x the layer's operations): the operations at the rate of x's and the
    weights' types (`flops_at`) against the operands and the window terms
    read once and the output written once."""
    x = f_args[0]
    b, n, d = x.shape
    *lead, h, _, dh = f_args[1].shape
    proj, attn = layer_flops(b, n, d, h, dh, f_args[9].shape[-1])
    n_l = lead[0] if lead else 1
    return bound(nbytes=nbytes(*f_args) + nbytes(x) + nbytes(bias, mask),
                 **flops_at(x.dtype, n_l * proj, f_args[1].dtype,
                            n_l * attn))


def layer_bound(f_args, i_args, bias=None, mask=None):
    x = f_args[0]
    b, n, d = x.shape
    h, _, dh = f_args[1].shape
    proj, attn = layer_flops(b, n, d, h, dh, f_args[9].shape[1])
    return (float_layer_bound(f_args, bias, mask),
            bound(ops_i8=proj, flops_f32=attn,
                  nbytes=nbytes(*i_args) + nbytes(x) + nbytes(bias, mask)))


def group_args(blocks, x, biases=None, mask=None):
    """Stacked float and int8 layer-group arguments for ``blocks`` on x,
    each member's act scales from max-abs statistics of the plain float
    layers on that member's input (`layer_args`), and the stacked
    (L, H, n, n) bias in windowed mode."""
    from repro_torch.kernels import ref

    per, y = [], x
    for l, bp in enumerate(blocks):
        b_l = None if biases is None else biases[l]
        f, i = layer_args(bp, y, b_l, mask)
        per.append((f, i))
        y = ref.vita_layer_ref(*f, b_l, mask)
    f_args = (x,) + tuple(torch.stack([p[0][k] for p in per]).contiguous()
                          for k in range(1, len(per[0][0])))
    i_args = (x,) + tuple(torch.stack([p[1][k] for p in per]).contiguous()
                          for k in range(1, len(per[0][1])))
    return f_args, i_args, None if biases is None else torch.stack(biases)


def group_bound(f_args, i_args, bias=None, mask=None):
    """L x the per-layer bound: every member's operations against the
    stacked operands read once, x read and the output written once."""
    x = f_args[0]
    b, n, d = x.shape
    n_l, h, _, dh = f_args[1].shape
    proj, attn = layer_flops(b, n, d, h, dh, f_args[9].shape[2])
    return (float_layer_bound(f_args, bias, mask),
            bound(ops_i8=n_l * proj, flops_f32=n_l * attn,
                  nbytes=nbytes(*i_args) + nbytes(x) + nbytes(bias, mask)))


def int8_chain(i_args, bias=None, mask=None):
    """L calls of `vita_layer_int8` on the stacked int8 group arguments:
    what the int8 group equals bit for bit."""
    from repro_torch.kernels import vita_layer as vl

    y = i_args[0]
    for l in range(i_args[1].shape[0]):
        y = vl.vita_layer_int8(y, *[a[l] for a in i_args[1:]],
                               None if bias is None else bias[l], mask)
    return y


def check_chain(name: str, got, chain, exact: bool,
                chain_name: str = "the per-layer kernel") -> float:
    """A layer group against L calls of a per-layer chain: exactly where
    the chain runs the group's tiles in the same order (int8:
    `vita_layer_int8`; float: `vita_layer_group.tile_chain`), else within
    1e-6 x scale (the float layer itself, `vita_layer`, whose fp32-weight
    products take the wgmma tile; with bf16 weights its tiles are the
    group's, and the printed error says it is equal)."""
    torch.cuda.synchronize()
    err = float((got - chain).abs().max())
    scale = float(chain.abs().max())
    print(f"[check] {name} vs L calls of {chain_name}: max|err| "
          f"{err:.3e}, bit for bit: {err == 0.0} (scale {scale:.3f}, bound "
          f"{'0' if exact else '1e-6 x scale'})")
    check(err == 0.0 if exact else err <= 1e-6 * scale,
          f"{name} disagrees with the per-layer chain")
    return err


def group_cases(deit, swin_cfg, sw_params, g):
    """(tag, blocks, x, biases, mask) of the three group shapes: DeiT-T
    full width (12 layers, batch 8), Swin-T stage 4 (2 layers, bucket 8,
    one 7x7 window per image, shift 0), and a pruned width (DeiT-T, 2
    layers keeping heads 0 and 1: H*Dh = 128 < D = 192)."""
    from repro_torch.core import schedule as sched
    from repro_torch.core.quant import prune_block_heads
    from repro_torch.models import vit

    deit_blocks = [perturbed(bp, g) for bp in
                   vit.init_params(deit, 3, "cuda")["layers"]]
    x = torch.randn((B_MAIN, deit.tokens, deit.dim), generator=g,
                    device="cuda")
    cases = [(f"deit_t L{len(deit_blocks)}", deit_blocks, x, None, None)]
    last = len(swin_cfg.depths) - 1
    side, dim = swin_cfg.stage_side(last), swin_cfg.stage_dim(last)
    ph = sched.Phase(kind="layer", path=(), site="", grid=(side, side),
                     window=swin_cfg.window)
    blocks = [perturbed(bp, g) for bp in sw_params["stages"][last]["blocks"]]
    terms = [sched._window_terms(ph, bp, torch.device("cuda"))
             for bp in blocks]
    xs = torch.randn((B_MAIN, side * side, dim), generator=g, device="cuda")
    cases.append((f"swin_t stage {last + 1} L{len(blocks)} windowed", blocks,
                  sched._fold(ph, xs), [t[0] for t in terms], terms[0][1]))
    pruned = [prune_block_heads(bp, (1, 1, 0)) for bp in deit_blocks[:2]]
    cases.append(("deit_t pruned L2 H2", pruned, x, None, None))
    return cases


def add_record(records: dict, kname: str, tag: str, err: float, fn, plain,
               library, bnd) -> None:
    """The first record of a kernel is its main shape; later ones are its
    other shapes."""
    r = dict(tag=tag, err=err, fn=fn, plain=plain, library=library,
             bound=bnd)
    if "fn" in records[kname]:
        records[kname]["extra"].append(r)
    else:
        records[kname].update(r)


def kernel_phase(deit, vitb, swin_cfg):
    """Each kernel against its plain version.  Returns per kernel its main
    record (the main path's shape) and extra timed shapes."""
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import ref, vita_layer as vl, vita_msa as vm
    from repro_torch.kernels import vita_layer_group as vg
    from repro_torch.models import swin

    g = torch.Generator(device="cuda").manual_seed(1)
    records = {k[0]: {"extra": []} for k in KERNELS}

    def rec(*args):
        add_record(records, *args)

    # Float and int8 layers at DeiT-T (batch 8) and ViT-B/16 (batch 2),
    # then windowed at Swin-T stage 1 (block 1: shifted), bucket 8.
    sw_params = swin.init_params(swin_cfg, seed=1, device="cuda")
    layer_cases = []
    for cfg, tag in ((deit, "deit_t"), (vitb, "vit_b16")):
        bp, x = vit_block(cfg, 1, g)
        layer_cases.append((tag, bp, x, None, None))
    layer_cases.append(swin_block(sw_params, swin_cfg, 0, 1, g))
    for tag, bp, x, bias, mask in layer_cases:
        f_args, i_args = layer_args(bp, x, bias, mask)
        b = x.shape[0]
        err = check_close(f"vita_layer {tag} B={b}",
                          vl.vita_layer(*f_args, bias, mask),
                          ref.vita_layer_ref(*f_args, bias, mask))
        err_i = check_int8_layer(f"vita_layer_int8 {tag} B={b}",
                                 vl.vita_layer_int8(*i_args, bias, mask),
                                 ref.vita_layer_int8_ref(*i_args, bias, mask))
        fb, ib = layer_bound(f_args, i_args, bias, mask)
        h, dh = bp["wq"].shape[0], bp["wq"].shape[2]
        layer_plan(f"{tag} {tuple(x.shape)}",
                   lambda: vl.vita_layer(*f_args, bias, mask), x, bp["wq"])
        rec("vita_layer", tag, err,
            lambda a=f_args, bi=bias, ma=mask: vl.vita_layer(*a, bi, ma),
            lambda a=f_args, bi=bias, ma=mask: ref.vita_layer_ref(*a, bi, ma),
            composed_layer(f_args, h, dh, bias, mask), fb)
        if tag == "vit_b16":
            continue
        rec("vita_layer_int8", tag, err_i,
            lambda a=i_args, bi=bias, ma=mask: vl.vita_layer_int8(*a, bi, ma),
            lambda a=i_args, bi=bias, ma=mask: ref.vita_layer_int8_ref(
                *a, bi, ma), None, ib)
        # int8 MSA (the calibration pass's kernel) on the same block;
        # windowed with a qkv_bias at Swin-T.
        zq = torch.clamp(torch.round(x / 0.02), -127, 127).to(torch.int8)
        xs = torch.tensor(0.02, device="cuda")
        qb = None if bias is None else 0.1 * torch.randn(
            (3, h, dh), generator=g, device="cuda")
        m_args = (zq, *i_args[1:4], xs, *i_args[8:11], bias, mask, qb)
        err = check_close(f"vita_msa_int8 {tag} B={b}"
                          + (" qkv_bias" if qb is not None else ""),
                          vm.vita_msa_int8(*m_args),
                          ref.vita_msa_int8_ref(*m_args))
        rec("vita_msa_int8", tag, err,
            lambda a=m_args: vm.vita_msa_int8(*a),
            lambda a=m_args: ref.vita_msa_int8_ref(*a), None,
            msa_bound(zq, i_args[1], bias, mask, qb, int8=True))

    # The attention launch alone (csrc/attention.cu: the tile of kernels 2,
    # 3 and 8) at DeiT-T batch 8 and Swin-T stage 1 (shifted windows),
    # kernel 3's layout: merged fp32 Q, K, V in, (B, H, N, Dh) fp32 out;
    # SDPA in fp32 with the same additive mask as its yardstick.  These
    # inputs come from a generator of their own.
    import torch.nn.functional as F
    ga = torch.Generator(device="cuda").manual_seed(20)
    for tag, bp, x, bias, mask in (layer_cases[0], layer_cases[2]):
        b, n = x.shape[:2]
        h, _, dh = bp["wq"].shape
        qkv = [torch.randn((b * n, h * dh), generator=ga, device="cuda")
               for _ in range(3)]
        heads = [t.view(b, n, h, dh).transpose(1, 2) for t in qkv]
        out = torch.empty((b, h, n, dh), device="cuda")
        am = sdpa_mask(bias, mask, b)

        def alone(a=qkv, o=out, b=b, n=n, h=h, dh=dh, bi=bias, ma=mask):
            return vm.launch_attention(
                *a, o, b=b, h=h, n=n, dh=dh,
                in_strides=(n * h * dh, h * dh, dh),
                out_strides=(h * n * dh, dh, n * dh), bias=bi, mask=ma)

        def plain(a=heads, dh=dh, bi=bias, ma=mask):
            return ref.softmax_av(*a, scale=dh ** -0.5, bias=bi, mask=ma)

        err = check_close(f"attention launch alone {tag} B={b} H={h} N={n} "
                          f"Dh={dh}", alone(), plain())
        attention_plan_line(f"{tag} B={b} H={h}", b, h, n, dh)
        rec("vita_msa_int8", f"attention launch alone, {tag}", err, alone,
            plain, lambda a=heads, m=am: F.scaled_dot_product_attention(
                *a, attn_mask=m),
            bound(flops_f32=4 * b * h * n * n * dh,
                  nbytes=nbytes(*qkv, out, bias, mask)))

    # int8 matmul (kernel 4) at the embed and head shapes, exact int32 and
    # rescaled; then the int8 layer's products through the same kernel
    # (`launch_gemm_i8`, as kernels 2 and 3 compose it) at DeiT-T batch 8.
    n, d = deit.tokens, deit.dim
    rows, m_hid = B_MAIN * n, int(d * deit.mlp_ratio)

    def i8(*shape, gen=g):
        return torch.randint(-127, 128, shape, device="cuda", generator=gen,
                             dtype=torch.int8)

    for (mm, kk, nn), tag in (((rows, deit.patch_dim, d), "embed"),
                              ((B_MAIN, d, deit.n_classes), "head")):
        a, w = i8(mm, kk), i8(kk, nn)
        ws = torch.rand(nn, device="cuda", generator=g) * 1e-2
        xs = torch.tensor(0.02, device="cuda")
        exact = torch.equal(im.int8_matmul(a, w), ref.int8_matmul_ref(a, w))
        got = im.int8_matmul(a, w, xs, ws)
        want = ref.int8_matmul_ref(a, w, xs, ws)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"[check] int8_matmul {tag} ({mm}x{kk})x({kk}x{nn}): int32 "
              f"equal {exact}; rescaled max|err| {err:.3e} (bound 0)")
        check(exact and err == 0.0, f"int8_matmul {tag} disagrees")
        i8_plan_line(f"{tag} ({mm}x{kk})x({kk}x{nn})", a, w)
        rec("int8_matmul", f"{tag} ({mm}x{kk})x({kk}x{nn})", err,
            lambda a=a, w=w, xs=xs, ws=ws: im.int8_matmul(a, w, xs, ws),
            lambda a=a, w=w, xs=xs, ws=ws: ref.int8_matmul_ref(
                a, w, xs, ws),
            (lambda a=a, w=w: torch._int_mm(a, w)) if mm > INT_MM_MIN_ROWS
            else None,
            bound(ops_i8=2 * mm * kk * nn,
                  nbytes=nbytes(a, w, xs, ws) + mm * nn * 4))
    # These inputs come from a generator of their own, so that every other
    # check of this phase sees the inputs it saw before they were added.
    gl = torch.Generator(device="cuda").manual_seed(18)
    h, dh = deit.heads, deit.head_dim
    xs = torch.tensor([0.02], device="cuda")
    qs = torch.tensor([0.05], device="cuda")
    layer_i8 = (
        ("layer Q/K/V per-head stack", i8(rows, d, gen=gl),
         i8(h, d, dh, gen=gl), torch.float32, {}),
        ("layer up + GELU, int8 out", i8(rows, d, gen=gl),
         i8(d, m_hid, gen=gl), torch.int8,
         {"bias": torch.randn(m_hid, device="cuda", generator=gl),
          "gelu": True, "out_scale": qs}),
        ("layer down + residual", i8(rows, m_hid, gen=gl),
         i8(m_hid, d, gen=gl), torch.float32,
         {"bias": torch.randn(d, device="cuda", generator=gl),
          "res": torch.randn((rows, d), device="cuda", generator=gl)}))
    for tag, a, w, out_dtype, kw in layer_i8:
        k_in, n_out = im.b_layout(w)[:2]
        kw = dict(kw, x_scale=xs, w_scale=torch.rand(
            n_out, device="cuda", generator=gl) * 1e-2)
        out = torch.empty((rows, n_out), device="cuda", dtype=out_dtype)
        got = im.launch_gemm_i8(a, w, out, **kw)
        want = ref.gemm_i8_ref(a, w, out_dtype, **kw)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err, flips = float(diff.max()), int((diff > 0).sum())
        # Through GELU the tile's tanh and the plain version's round apart
        # by an ulp now and then; an int8 code may then flip by one.
        exact = "GELU" not in tag
        print(f"[check] int8_matmul {tag} ({rows}x{k_in})x({k_in}x"
              f"{n_out}): max|err| {err:.3e}, {flips} of {got.numel()} "
              f"outputs differ (bound {'0' if exact else '1 code'})")
        check(err == 0.0 if exact else err <= 1.0,
              f"int8_matmul {tag} disagrees")
        i8_plan_line(f"{tag} ({rows}x{k_in})x({k_in}x{n_out})", a, w)
        merged = w.permute(1, 0, 2).reshape(k_in, n_out).contiguous() \
            if w.dim() == 3 else w
        rec("int8_matmul", f"{tag} ({rows}x{k_in})x({k_in}x{n_out})", err,
            lambda a=a, w=w, o=out, kw=kw: im.launch_gemm_i8(a, w, o, **kw),
            lambda a=a, w=w, dt=out_dtype, kw=kw: ref.gemm_i8_ref(
                a, w, dt, **kw),
            lambda a=a, w=merged: torch._int_mm(a, w),
            bound(ops_i8=2 * rows * k_in * n_out,
                  nbytes=nbytes(a, w, *[t for t in kw.values()
                                        if isinstance(t, torch.Tensor)])
                  + out.numel() * out.element_size()))

    # Float MSA and fused MLP: DeiT-T batch 8 (the unfused main path),
    # Swin-T stage 1 (shifted) and stage 4 at bucket 8, ViT-B/16 batch 2.
    cases = []
    for cfg, tag in ((deit, "deit_t"), (vitb, "vit_b16")):
        bp, x = vit_block(cfg, 2, g)
        cases.append((tag, bp, x, None, None))
    cases[1:1] = [swin_block(sw_params, swin_cfg, 0, 1, g),
                  swin_block(sw_params, swin_cfg, -1, 0, g)]
    for tag, bp, x, bias, mask in cases:
        z = ref.layer_norm_ref(x, bp["ln1_w"], bp["ln1_b"])
        w = (bp["wq"], bp["wk"], bp["wv"])
        err = check_close(
            f"vita_msa_batched {tag} {tuple(z.shape)} H={w[0].shape[0]}",
            vm.vita_msa_batched(z, *w, bias, mask),
            ref.vita_msa_batched_ref(z, *w, bias, mask))
        msa_plan_line(f"{tag} {tuple(z.shape)}", z, w[0])
        rec("vita_msa_batched", tag, err,
            lambda z=z, w=w, bi=bias, ma=mask: vm.vita_msa_batched(
                z, *w, bi, ma),
            lambda z=z, w=w, bi=bias, ma=mask: ref.vita_msa_batched_ref(
                z, *w, bi, ma),
            composed_msa(z, *w, bias, mask),
            msa_bound(z, w[0], bias, mask))
        mlp = (bp["w_up"], bp["b_up"], bp["w_down"], bp["b_down"])
        err = check_close(
            f"fused_mlp {tag} {tuple(z.shape)} M={mlp[0].shape[1]}",
            fm.fused_mlp(z, mlp[0], mlp[2], mlp[1], mlp[3]),
            ref.fused_mlp_ref(z, *mlp))
        mlp_plan(f"{tag} {tuple(z.shape)} fp32", z, mlp[0], mlp[2])
        rec("fused_mlp", tag, err,
            lambda z=z, p=mlp: fm.fused_mlp(z, p[0], p[2], p[1], p[3]),
            lambda z=z, p=mlp: ref.fused_mlp_ref(z, *p),
            composed_mlp(z, *mlp), mlp_bound(z, *mlp))
        if tag == "deit_t":
            h, _, dh = w[0].shape
            qb = 0.1 * torch.randn((3, h, dh), generator=g, device="cuda")
            check_close(f"vita_msa_batched {tag} qkv_bias",
                        vm.vita_msa_batched(z, *w, qkv_bias=qb),
                        ref.vita_msa_batched_ref(z, *w, qkv_bias=qb))
            check_close(f"fused_mlp {tag} without b1/b2",
                        fm.fused_mlp(z, mlp[0], mlp[2]),
                        ref.fused_mlp_ref(z, mlp[0], None, mlp[2], None))

    # Layer groups: against the plain versions and the per-layer chain.
    for tag, blocks, x, biases, mask in group_cases(deit, swin_cfg,
                                                    sw_params, g):
        f_args, i_args, bias = group_args(blocks, x, biases, mask)
        n_l = len(blocks)
        err = check_close(f"vita_layer_group {tag}",
                          vg.vita_layer_group(*f_args, bias, mask),
                          ref.vita_layer_group_ref(*f_args, bias, mask))
        group_plan_line(tag, x, f_args[1], f_args[9].shape[2])
        chain = tiles = x
        for l in range(n_l):
            layer = ([a[l] for a in f_args[1:]],
                     None if bias is None else bias[l])
            chain = vl.vita_layer(chain, *layer[0], layer[1], mask)
            tiles = vg.tile_chain(tiles, *layer[0], layer[1], mask)
        got = vg.vita_layer_group(*f_args, bias, mask)
        check_chain(f"vita_layer_group {tag}", got, tiles, False,
                    "tile_chain")
        check_chain(f"vita_layer_group {tag}", got, chain, False,
                    "vita_layer")
        err_i = check_int8_layer(
            f"vita_layer_group_int8 {tag}",
            vg.vita_layer_group_int8(*i_args, bias, mask),
            ref.vita_layer_group_int8_ref(*i_args, bias, mask))
        chain, steps = x, []
        for l in range(n_l):
            layer = ([a[l] for a in i_args[1:]],
                     None if bias is None else bias[l])
            y = vl.vita_layer_int8(chain, *layer[0], layer[1], mask)
            steps.append((y, ref.vita_layer_int8_ref(chain, *layer[0],
                                                     layer[1], mask)))
            chain = y
        check_int8_teacher_forced(f"vita_layer_int8 chain {tag}", steps)
        check_chain(f"vita_layer_group_int8 {tag}",
                    vg.vita_layer_group_int8(*i_args, bias, mask), chain,
                    True)
        int8_group_plan_line(tag, i_args)
        I8_CHAINS.append((tag, lambda a=i_args, bi=bias, ma=mask:
                          int8_chain(a, bi, ma)))
        fb, ib = group_bound(f_args, i_args, bias, mask)
        rec("vita_layer_group", tag, err,
            lambda a=f_args, bi=bias, ma=mask: vg.vita_layer_group(*a, bi,
                                                                   ma),
            lambda a=f_args, bi=bias, ma=mask: ref.vita_layer_group_ref(
                *a, bi, ma),
            composed_group(f_args, bias, mask), fb)
        rec("vita_layer_group_int8", tag, err_i,
            lambda a=i_args, bi=bias, ma=mask: vg.vita_layer_group_int8(
                *a, bi, ma),
            lambda a=i_args, bi=bias, ma=mask: ref.vita_layer_group_int8_ref(
                *a, bi, ma), None, ib)
    torch.cuda.synchronize()
    return records


# ---------------------------------------------------------------------------
# The widened tiles: heads past 64 and N past one cluster
# ---------------------------------------------------------------------------


def wide_block(vitb, h: int, n: int, seed: int, g):
    """A ViT-B/16 block (D 768) of ``h`` heads with non-zero LN and MLP
    biases, and a unit-scale input (2, N, 768)."""
    from repro_torch.models import vit

    cfg = dataclasses.replace(vitb, heads=h, layers=1)
    bp = perturbed(vit.init_params(cfg, seed, "cuda")["layers"][0], g)
    return bp, torch.randn((2, n, cfg.dim), generator=g, device="cuda")


def layer_and_msa_checks(records: dict, tag: str, bp: dict, x,
                         qkv_bias=None):
    """Kernels 1 and 2 on block ``bp`` at x (B, N, D), and kernels 5 and 3
    on its LN1 output (3 on x quantised at 0.02, with ``qkv_bias`` where
    given), each against its plain version with its plan printed and
    recorded under ``tag``.  Returns the LN1 output."""
    from repro_torch.kernels import ref, vita_layer as vl, vita_msa as vm

    b, n, _ = x.shape
    h, _, dh = bp["wq"].shape
    f_args, i_args = layer_args(bp, x)
    err = check_close(f"vita_layer {tag}", vl.vita_layer(*f_args),
                      ref.vita_layer_ref(*f_args))
    err_i = check_int8_layer(f"vita_layer_int8 {tag}",
                             vl.vita_layer_int8(*i_args),
                             ref.vita_layer_int8_ref(*i_args))
    layer_plan(tag, lambda a=f_args: vl.vita_layer(*a), x, bp["wq"])
    fb, ib = layer_bound(f_args, i_args)
    add_record(records, "vita_layer", tag, err,
               lambda a=f_args: vl.vita_layer(*a),
               lambda a=f_args: ref.vita_layer_ref(*a),
               composed_layer(f_args, h, dh), fb)
    add_record(records, "vita_layer_int8", tag, err_i,
               lambda a=i_args: vl.vita_layer_int8(*a),
               lambda a=i_args: ref.vita_layer_int8_ref(*a), None, ib)
    z = ref.layer_norm_ref(x, bp["ln1_w"], bp["ln1_b"])
    w = (bp["wq"], bp["wk"], bp["wv"])
    err = check_close(f"vita_msa_batched {tag} H={h}",
                      vm.vita_msa_batched(z, *w),
                      ref.vita_msa_batched_ref(z, *w))
    msa_plan_line(tag, z, w[0])
    add_record(records, "vita_msa_batched", tag, err,
               lambda z=z, w=w: vm.vita_msa_batched(z, *w),
               lambda z=z, w=w: ref.vita_msa_batched_ref(z, *w),
               composed_msa(z, *w), msa_bound(z, w[0]))
    zq = torch.clamp(torch.round(x / 0.02), -127, 127).to(torch.int8)
    m_args = (zq, *i_args[1:4], torch.tensor(0.02, device="cuda"),
              *i_args[8:11], None, None, qkv_bias)
    err = check_close(f"vita_msa_int8 {tag}"
                      + (" qkv_bias" if qkv_bias is not None else ""),
                      vm.vita_msa_int8(*m_args),
                      ref.vita_msa_int8_ref(*m_args))
    attention_plan_line(tag, b, h, n, dh)
    add_record(records, "vita_msa_int8", tag, err,
               lambda a=m_args: vm.vita_msa_int8(*a),
               lambda a=m_args: ref.vita_msa_int8_ref(*a), None,
               msa_bound(zq, i_args[1], qkv_bias=qkv_bias, int8=True))
    return z


def wide_kernel_phase(records: dict, vitb) -> None:
    """Kernels 1, 2, 3 and 5 and the attention launch alone at the shapes
    the cluster tile and the DP 64 attention tile did not take (`WIDE`:
    the paged MSA plan, the DP 128 attention tile), each against its plain
    version with its plan printed (`layer_and_msa_checks`); then kernels 7
    and 8 at Dh 128 (L 2) against their plain versions and, bit for bit,
    their chains of L per-layer calls.  Inputs come from a generator of
    their own."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref, vita_layer as vl, vita_msa as vm
    from repro_torch.kernels import vita_layer_group as vg

    g = torch.Generator(device="cuda").manual_seed(21)

    def rec(*args):
        add_record(records, *args)

    for tag, h, n in WIDE:
        bp, x = wide_block(vitb, h, n, 21, g)
        b, d = x.shape[0], x.shape[2]
        dh = d // h
        qb = 0.1 * torch.randn((3, h, dh), generator=g, device="cuda")
        layer_and_msa_checks(records, tag, bp, x, qb)
        qkv = [torch.randn((b * n, h * dh), generator=g, device="cuda")
               for _ in range(3)]
        heads = [t.view(b, n, h, dh).transpose(1, 2) for t in qkv]
        out = torch.empty((b, h, n, dh), device="cuda")

        def alone(a=qkv, o=out, b=b, n=n, h=h, dh=dh):
            return vm.launch_attention(
                *a, o, b=b, h=h, n=n, dh=dh,
                in_strides=(n * h * dh, h * dh, dh),
                out_strides=(h * n * dh, dh, n * dh))

        def plain(a=heads, dh=dh):
            return ref.softmax_av(*a, scale=dh ** -0.5)

        err = check_close(f"attention launch alone {tag} B={b} H={h} N={n} "
                          f"Dh={dh}", alone(), plain())
        rec("vita_msa_int8", f"attention launch alone, {tag}", err, alone,
            plain, lambda a=heads: F.scaled_dot_product_attention(*a),
            bound(flops_f32=4 * b * h * n * n * dh,
                  nbytes=nbytes(*qkv, out)))

    tag, h, n = WIDE[0]
    blocks, x = [], None
    for l in range(WIDE_LAYERS):
        bp, x0 = wide_block(vitb, h, n, 22 + l, g)
        blocks.append(bp)
        x = x0 if x is None else x
    tag = f"{tag} L{WIDE_LAYERS}"
    f_args, i_args, _ = group_args(blocks, x)
    err = check_close(f"vita_layer_group {tag}", vg.vita_layer_group(*f_args),
                      ref.vita_layer_group_ref(*f_args))
    group_plan_line(tag, x, f_args[1], f_args[9].shape[2])
    chain = tiles = x
    for l in range(WIDE_LAYERS):
        chain = vl.vita_layer(chain, *[a[l] for a in f_args[1:]])
        tiles = vg.tile_chain(tiles, *[a[l] for a in f_args[1:]])
    got = vg.vita_layer_group(*f_args)
    check_chain(f"vita_layer_group {tag}", got, tiles, True, "tile_chain")
    check_chain(f"vita_layer_group {tag}", got, chain, False, "vita_layer")
    err_i = check_int8_layer(f"vita_layer_group_int8 {tag}",
                             vg.vita_layer_group_int8(*i_args),
                             ref.vita_layer_group_int8_ref(*i_args))
    check_chain(f"vita_layer_group_int8 {tag}",
                vg.vita_layer_group_int8(*i_args), int8_chain(i_args), True)
    int8_group_plan_line(tag, i_args)
    fb, ib = group_bound(f_args, i_args)
    rec("vita_layer_group", tag, err,
        lambda a=f_args: vg.vita_layer_group(*a),
        lambda a=f_args: ref.vita_layer_group_ref(*a),
        composed_group(f_args), fb)
    rec("vita_layer_group_int8", tag, err_i,
        lambda a=i_args: vg.vita_layer_group_int8(*a),
        lambda a=i_args: ref.vita_layer_group_int8_ref(*a), None, ib)
    torch.cuda.synchronize()


def tnt_kernel_phase(records: dict, tnt_cfg) -> None:
    """Kernels 1, 2, 3, 5 and 6 at TNT-S's two streams, bucket 8: the inner
    stream (1,568 sequences of 16 pixel tokens, D 24, 4 heads of Dh 6, MLP
    96: the scalar loads, partial k steps and masked output slices no
    other served shape reaches) and the outer one (8 images, N 196, D 384,
    6 heads of 64, MLP 1,536), each against its plain version with its
    plan printed; kernels 1, 5 and 6 with bf16 weights too (mixed and bf16
    activations, untimed); kernel 4 at the pixel-embed (25,088 x 48 x 24),
    fold (1,568 x 384 x 384) and inner MLP products.  All timed with the
    other shapes, their times printed on ``[kernel]`` lines (`TNT_TAG`
    marks them).  Inputs come from a generator of their own, the blocks
    from TNT-S's init (seed 1), LN and MLP biases perturbed."""
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import ops, ref, vita_layer as vl
    from repro_torch.kernels import vita_msa as vm
    from repro_torch.models import tnt

    g = torch.Generator(device="cuda").manual_seed(23)

    def rec(*args):
        add_record(records, *args)

    one = tnt.init_params(dataclasses.replace(tnt_cfg, layers=1), 1,
                          "cuda")["layers"][0]
    n_seq = B_MAIN * tnt_cfg.tokens
    streams = (
        ("inner", one["inner"], (n_seq, tnt_cfg.inner_tokens,
                                 tnt_cfg.inner_dim)),
        ("outer", one["outer"], (B_MAIN, tnt_cfg.tokens, tnt_cfg.dim)))
    for stream, bp, shape in streams:
        bp = perturbed(bp, g)
        x = torch.randn(shape, generator=g, device="cuda")
        tag = f"{TNT_TAG} {stream} {tuple(x.shape)}"
        z = layer_and_msa_checks(records, tag, bp, x)
        mlp = (bp["w_up"], bp["b_up"], bp["w_down"], bp["b_down"])
        err = check_close(f"fused_mlp {tag} M={mlp[0].shape[1]}",
                          fm.fused_mlp(z, mlp[0], mlp[2], mlp[1], mlp[3]),
                          ref.fused_mlp_ref(z, *mlp))
        mlp_plan(f"{tag} fp32", z, mlp[0], mlp[2])
        rec("fused_mlp", tag, err,
            lambda z=z, p=mlp: fm.fused_mlp(z, p[0], p[2], p[1], p[3]),
            lambda z=z, p=mlp: ref.fused_mlp_ref(z, *p),
            composed_mlp(z, *mlp), mlp_bound(z, *mlp))
        b16 = {k: v.to(torch.bfloat16) for k, v in bp.items()}
        for mode, act in (("mixed", torch.float32), ("bf16", torch.bfloat16)):
            xa = x.to(act)
            fa = (xa,) + tuple(b16[k] for k in (
                "wq", "wk", "wv", "w_msa", "ln1_w", "ln1_b", "ln2_w",
                "ln2_b", "w_up", "b_up", "w_down", "b_down"))
            label = f"{tag} bf16 weights"
            check_bf16_mode(f"vita_layer {label}", vl.vita_layer(*fa),
                            ref.vita_layer_ref(*fa), mode)
            za = ops.layer_norm(xa, b16["ln1_w"], b16["ln1_b"])
            wa = (b16["wq"], b16["wk"], b16["wv"])
            check_bf16_mode(f"vita_msa_batched {label}",
                            vm.vita_msa_batched(za, *wa),
                            ref.vita_msa_batched_ref(za, *wa), mode)
            ma = (b16["w_up"], b16["b_up"], b16["w_down"], b16["b_down"])
            check_bf16_mode(f"fused_mlp {label}",
                            fm.fused_mlp(za, ma[0], ma[2], ma[1], ma[3]),
                            ref.fused_mlp_ref(za, *ma), mode)

    def i8(*shape):
        return torch.randint(-127, 128, shape, device="cuda", generator=g,
                             dtype=torch.int8)

    n_pix = n_seq * tnt_cfg.inner_tokens
    c, m_in = tnt_cfg.inner_dim, tnt_cfg.inner_mlp_hidden
    for (mm, kk, nn), what in (
            ((n_pix, tnt_cfg.inner_patch_dim, c), "pixel embed"),
            ((n_seq, tnt_cfg.fold_dim, tnt_cfg.dim), "fold"),
            ((n_pix, c, m_in), "inner up"), ((n_pix, m_in, c), "inner down")):
        a, w = i8(mm, kk), i8(kk, nn)
        ws = torch.rand(nn, device="cuda", generator=g) * 1e-2
        xs = torch.tensor(0.02, device="cuda")
        exact = torch.equal(im.int8_matmul(a, w), ref.int8_matmul_ref(a, w))
        got = im.int8_matmul(a, w, xs, ws)
        want = ref.int8_matmul_ref(a, w, xs, ws)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tag = f"{TNT_TAG} {what} ({mm}x{kk})x({kk}x{nn})"
        print(f"[check] int8_matmul {tag}: int32 equal {exact}; rescaled "
              f"max|err| {err:.3e} (bound 0)")
        check(exact and err == 0.0, f"int8_matmul {tag} disagrees")
        i8_plan_line(tag, a, w)
        rec("int8_matmul", tag, err,
            lambda a=a, w=w, xs=xs, ws=ws: im.int8_matmul(a, w, xs, ws),
            lambda a=a, w=w, xs=xs, ws=ws: ref.int8_matmul_ref(a, w, xs, ws),
            lambda a=a, w=w: torch._int_mm(a, w),
            bound(ops_i8=2 * mm * kk * nn,
                  nbytes=nbytes(a, w, xs, ws) + mm * nn * 4))
    torch.cuda.synchronize()


# Kernel 1's fp32 products on the card (`gemm_phase`): DeiT-S's three at
# bucket 32, one Swin-T stage-1 product and one of TNT-S's inner stream,
# each with its layer's epilogue.  (tag, M, N, K, epilogue)
GEMM_SHAPES = (
    ("DeiT-S b32 concat", 6272, 384, 384, "res"),
    ("DeiT-S b32 up", 6272, 1536, 384, "bias_gelu"),
    ("DeiT-S b32 down", 6272, 384, 1536, "bias_res"),
    ("Swin-T stage 1 b32 up", 100352, 384, 96, "bias_gelu"),
    ("TNT-S inner b32 up", 100352, 96, 24, "bias_gelu"),
)


def gemm_phase() -> list:
    """Each of GEMM_SHAPES on the wgmma tile (`launch_layer_gemm`'s
    route, at `gemm_wgmma_plan`'s tile), on the mma.sync tile
    (`launch_mma_gemm`), and `torch.matmul` in full fp32 (TF32 off, no
    epilogue) as the library yardstick, beside the bound at split TF32's
    165 TFLOP/s; the wgmma result held to a float64 product within 1e-6 of
    its scale.  Prints a `[gemm]` line each and returns them as dicts."""
    from repro_torch.kernels import vita_layer as vl

    rows = []
    g = torch.Generator(device="cuda").manual_seed(35)
    for tag, m, n, k, epi in GEMM_SHAPES:
        a = torch.randn((m, k), generator=g, device="cuda")
        w = torch.randn((k, n), generator=g, device="cuda") * k ** -0.5
        kw = {"bias": 0.1 * torch.randn((n,), generator=g, device="cuda")
              if "bias" in epi else None,
              "res": torch.randn((m, n), generator=g, device="cuda")
              if "res" in epi else None,
              "gelu": "gelu" in epi}
        out = torch.empty((m, n), device="cuda")
        plan = vl.layer_gemm_plan(a, w)
        check(plan is not None, f"{tag}: fp32 rows off the wgmma route")
        vl.launch_layer_gemm(a, w, out, **kw)
        want = a.double() @ w.double()
        if kw["bias"] is not None:
            want = want + kw["bias"].double()
        if kw["gelu"]:
            want = torch.nn.functional.gelu(want, approximate="tanh")
        if kw["res"] is not None:
            want = kw["res"].double() + want
        err = float((out.double() - want).abs().max())
        scale = float(want.abs().max())
        del want
        check(err <= 1e-6 * scale, f"{tag}: wgmma GEMM error {err:.3e}")
        new, new_by = device_ms(lambda: vl.launch_layer_gemm(a, w, out, **kw))
        old, old_by = device_ms(lambda: vl.launch_mma_gemm(a, w, out, **kw))
        lib, lib_by = device_ms(lambda: torch.matmul(a, w, out=out))
        flop = 2 * m * n * k
        bound = flop / FP32_FLOP_PER_S * 1e3
        row = {"shape": tag, "m": m, "n": n, "k": k, "wgmma_ms": new,
               "mma_sync_ms": old, "library_ms": lib, "bound_ms": bound,
               "wgmma_tflops": flop / new / 1e9, "err": err / scale,
               "tile": f"{plan.bm}x{plan.bn}", "stages": plan.stages,
               "tiles": plan.tiles, "waves": plan.waves,
               "timed_by": {"wgmma": new_by, "mma_sync": old_by,
                            "library": lib_by}}
        rows.append(row)
        print(f"[gemm] {tag} {m}x{n}x{k} ({epi}): wgmma {new:.4f} ms "
              f"({row['wgmma_tflops']:.1f} TFLOP/s, {row['tile']} tiles, "
              f"{plan.stages} stages, {plan.tiles} tiles in {plan.waves} "
              f"waves), mma.sync {old:.4f} ms ({flop / old / 1e9:.1f}), "
              f"torch.matmul fp32 {lib:.4f} ms ({flop / lib / 1e9:.1f}), "
              f"bound {bound:.4f} ms at 165 TFLOP/s ({100 * bound / new:.1f}%"
              f" of it); error {err / scale:.2e} of the scale "
              f"[{new_by}]")
    return rows


def wide_configs(vitb) -> dict:
    """The widened tiles' user configs, which the registry does not build:
    ViT-B/16 widths with 6 heads of 128 at 224 px (N 196), and ViT-B/16 at
    384 px (N 576), both cut to `WIDE_LAYERS` layers."""
    return {"vit_b16 6x128 heads": dataclasses.replace(
                vitb, name="vit_b16_224_h6", image=224, heads=6,
                layers=WIDE_LAYERS),
            "vit_b16 384 px": dataclasses.replace(
                vitb, name="vit_b16_384", image=384, layers=WIDE_LAYERS)}


# ---------------------------------------------------------------------------
# The bf16 configuration: kernels 1, 5, 6 and 7 in their bf16 modes
# ---------------------------------------------------------------------------


def check_bf16_mode(name: str, got, want, mode: str) -> float:
    """A kernel in a bf16 mode against its plain version: "mixed" (float32
    activations, bf16 weights: fp32 math on exactly upcast weights) at the
    fp32 limit, max|err| <= 1e-5 x max(1, scale); "bf16" row by row at
    1e-2 of each row's own scale (a few bf16 ulps: kernel and plain
    version round at the same points, P and V or the hidden chunk and the
    output, but fp32 reassociation can move a value across a rounding
    boundary)."""
    if mode == "mixed":
        return check_close(f"{name} {mode}", got, want, tol=MIXED_TOL)
    return check_lm(f"{name} {mode}", got, want, tol=BF16_TOL)


def upcast_then(make, args, *rest):
    """The library yardstick of a mixed-mode call: the bf16 weights
    upcast to float32 inside the timed call, then the float32 composition
    ``make(args, *rest)`` builds and runs."""
    def run():
        return make(tuple(a.float() if a is not None else None
                          for a in args), *rest)()
    return run


def bf16_kernel_phase(records: dict, deit, swin_cfg) -> None:
    """Kernels 1, 5 and 6 at DeiT-T full width (batch 8) and Swin-T stages
    1 (windowed, shifted) and 4 (bucket 8), and kernel 7 at DeiT-T (L 4,
    batch 8) and Swin-T stage 3 (L 2, windowed), every weight bf16, on
    float32 activations ("mixed") and bf16 ones, against their plain
    versions on the card.  Kernels 5 and 6 take z = LN1(x) in x's dtype,
    as the schedule feeds them.  The DeiT-T shapes (the main path's) are
    timed, with library yardsticks: in bf16 the composition of cuBLAS bf16
    matmuls, F.layer_norm and SDPA in bf16; in mixed mode the weights
    upcast, then the fp32 composition."""
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import ops, ref, vita_layer as vl
    from repro_torch.kernels import vita_layer_group as vg
    from repro_torch.kernels import vita_msa as vm
    from repro_torch.models import swin, vit

    g = torch.Generator(device="cuda").manual_seed(15)
    deit16 = dataclasses.replace(deit, dtype="bfloat16")
    swin16 = dataclasses.replace(swin_cfg, dtype="bfloat16")
    sw_params = swin.init_params(swin16, seed=1, device="cuda")
    bp, x = vit_block(deit16, 1, g)
    cases = [("deit_t", bp, x, None, None),
             swin_block(sw_params, swin16, 0, 1, g),
             swin_block(sw_params, swin16, -1, 0, g)]
    for tag, bp, x, bias, mask in cases:
        h, _, dh = bp["wq"].shape
        rec = add_record if tag == "deit_t" else (lambda *a: None)
        for mode, act in (("mixed", torch.float32), ("bf16", torch.bfloat16)):
            xa = x.to(act)
            label = f"{tag} {tuple(xa.shape)} bf16 weights"
            f_args = (xa, bp["wq"], bp["wk"], bp["wv"], bp["w_msa"],
                      bp["ln1_w"], bp["ln1_b"], bp["ln2_w"], bp["ln2_b"],
                      bp["w_up"], bp["b_up"], bp["w_down"], bp["b_down"])
            lib = (upcast_then(composed_layer, f_args, h, dh, bias, mask)
                   if mode == "mixed"
                   else composed_layer(f_args, h, dh, bias, mask))
            err = check_bf16_mode(f"vita_layer {label}",
                                  vl.vita_layer(*f_args, bias, mask),
                                  ref.vita_layer_ref(*f_args, bias, mask),
                                  mode)
            layer_plan(f"{label}, {mode}",
                       lambda: vl.vita_layer(*f_args, bias, mask), xa,
                       bp["wq"])
            rec(records, "vita_layer", f"{label}, {mode}", err,
                lambda a=f_args, bi=bias, ma=mask: vl.vita_layer(*a, bi, ma),
                lambda a=f_args, bi=bias, ma=mask: ref.vita_layer_ref(
                    *a, bi, ma), lib, float_layer_bound(f_args, bias, mask))
            z = ops.layer_norm(xa, bp["ln1_w"], bp["ln1_b"])
            w = (bp["wq"], bp["wk"], bp["wv"])
            lib = (upcast_then(lambda a, bi, ma: composed_msa(*a, bi, ma),
                               (z,) + w, bias, mask) if mode == "mixed"
                   else composed_msa(z, *w, bias, mask))
            err = check_bf16_mode(f"vita_msa_batched {label}",
                                  vm.vita_msa_batched(z, *w, bias, mask),
                                  ref.vita_msa_batched_ref(z, *w, bias, mask),
                                  mode)
            msa_plan_line(f"{label}, {mode}", z, w[0])
            rec(records, "vita_msa_batched", f"{label}, {mode}", err,
                lambda z=z, w=w, bi=bias, ma=mask: vm.vita_msa_batched(
                    z, *w, bi, ma),
                lambda z=z, w=w, bi=bias, ma=mask: ref.vita_msa_batched_ref(
                    z, *w, bi, ma), lib, msa_bound(z, w[0], bias, mask))
            mlp = (bp["w_up"], bp["b_up"], bp["w_down"], bp["b_down"])
            lib = (upcast_then(lambda a: composed_mlp(*a), (z,) + mlp)
                   if mode == "mixed" else composed_mlp(z, *mlp))
            err = check_bf16_mode(f"fused_mlp {label}",
                                  fm.fused_mlp(z, mlp[0], mlp[2], mlp[1],
                                               mlp[3]),
                                  ref.fused_mlp_ref(z, *mlp), mode)
            if tag == "deit_t":
                mlp_plan(f"{label}, {mode}", z, mlp[0], mlp[2])
            rec(records, "fused_mlp", f"{label}, {mode}", err,
                lambda z=z, p=mlp: fm.fused_mlp(z, p[0], p[2], p[1], p[3]),
                lambda z=z, p=mlp: ref.fused_mlp_ref(z, *p), lib,
                mlp_bound(z, *mlp))

    # Kernel 7: DeiT-T L 4 (batch 8) and Swin-T stage 3 L 2 (bucket 8,
    # four 7x7 windows an image): blocks 0 and 1's weights under one
    # unshifted mask, as group members share theirs.
    from repro_torch.core import schedule as sched
    blocks = [perturbed(bp, g) for bp in vit.init_params(
        dataclasses.replace(deit16, layers=4), 3, "cuda")["layers"]]
    x = torch.randn((B_MAIN, deit.tokens, deit.dim), generator=g,
                    device="cuda")
    groups = [(f"deit_t L4 {tuple(x.shape)}", blocks, x, None, None)]
    side, dim = swin16.stage_side(2), swin16.stage_dim(2)
    ph = sched.Phase(kind="layer", path=(), site="", grid=(side, side),
                     window=swin16.window)
    blocks = [perturbed(bp, g) for bp in sw_params["stages"][2]["blocks"][:2]]
    terms = [sched._window_terms(ph, bp, torch.device("cuda"))
             for bp in blocks]
    xs = sched._fold(ph, torch.randn((B_MAIN, side * side, dim), generator=g,
                                     device="cuda"))
    groups.append((f"swin_t stage 3 L2 {tuple(xs.shape)} windowed", blocks,
                   xs, torch.stack([t[0] for t in terms]), terms[0][1]))
    keys = ("wq", "wk", "wv", "w_msa", "ln1_w", "ln1_b", "ln2_w", "ln2_b",
            "w_up", "b_up", "w_down", "b_down")
    for tag, blocks, x, bias, mask in groups:
        rec = add_record if tag.startswith("deit_t") else (lambda *a: None)
        stacks = tuple(torch.stack([bp[k] for bp in blocks]).contiguous()
                       for k in keys)
        for mode, act in (("mixed", torch.float32), ("bf16", torch.bfloat16)):
            f_args = (x.to(act),) + stacks
            got = vg.vita_layer_group(*f_args, bias, mask)
            err = check_bf16_mode(f"vita_layer_group {tag} bf16 weights",
                                  got, ref.vita_layer_group_ref(
                                      *f_args, bias, mask), mode)
            if mode == "mixed":
                chain = f_args[0]
                for l in range(len(blocks)):
                    chain = vl.vita_layer(
                        chain, *[a[l] for a in stacks],
                        None if bias is None else bias[l], mask)
                check_chain(f"vita_layer_group {tag} mixed", got, chain,
                            False)
            group_plan_line(f"{tag} bf16 weights, {mode}", f_args[0],
                            stacks[0], stacks[8].shape[2])
            lib = (upcast_then(lambda a, bi, ma: composed_group(a, bi, ma),
                               f_args, bias, mask) if mode == "mixed"
                   else composed_group(f_args, bias, mask))
            rec(records, "vita_layer_group", f"{tag} bf16 weights, {mode}",
                err, lambda a=f_args, bi=bias, ma=mask: vg.vita_layer_group(
                    *a, bi, ma),
                lambda a=f_args, bi=bias, ma=mask: ref.vita_layer_group_ref(
                    *a, bi, ma), lib, float_layer_bound(f_args, bias, mask))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def expected_launches(sched, mode: str, mb: int, n_cal: int) -> dict:
    """Kernel launches of ``mb`` micro-batches (plus ``n_cal`` calibration
    batches) of schedule ``sched`` on one served path: one launch per
    ``layer`` or ``layer_group`` phase of either stream (msa + mlp
    unfused; TNT's inner phases as its outer ones), and in int8 the embed
    (TNT's pixel and patch embeds), the head, Swin's patch merges and
    TNT's folds as int8 matmuls.  Calibration runs every block unfused (a
    group member by member)."""
    c = sched.counts()

    def both(kind):
        return c.get(kind, 0) + c.get("inner_" + kind, 0)
    groups = sum(len(p.members) for p in sched.phases
                 if p.kind.endswith("layer_group"))
    blocks = both("layer") + both("msa") + groups
    embeds = 2 if sched.phases[0].inner_tokens else 1
    outside = embeds + 1 + c.get("merge", 0) + c.get("fold", 0)
    out = {k[0]: 0 for k in KERNELS}
    if mode == "float":
        out["vita_layer"] = both("layer") * mb
        out["vita_layer_group"] = both("layer_group") * mb
        out["vita_msa_batched"] = out["fused_mlp"] = both("msa") * mb
        return out
    out["vita_msa_int8"] = blocks * n_cal + both("msa") * mb
    out["int8_matmul"] = (outside + 3 * blocks) * n_cal \
        + (outside + 3 * both("msa")) * mb       # + w_msa, w_up, w_down
    out["vita_layer_int8"] = both("layer") * mb
    out["vita_layer_group_int8"] = both("layer_group") * mb
    return out


def path_name(model: str, mode: str, fused: bool, group: int) -> str:
    kind = ("unfused" if not fused else "fused" if group == 1
            else f"grouped by {group}")
    return f"{model} {mode} {kind}"


def serve_path(model: str, mode: str, fused: bool, group: int, params,
               images, qparams=None, calibrator=None) -> dict:
    """Serve ``images`` on the card (launch counts reset just before,
    read just after) and on the CPU twin, and check both."""
    from repro_torch.kernels import ops
    from repro_torch.launch.vision_serve import ServeConfig, make_server
    from repro_torch.models import vision_registry, vit

    name = path_name(model, mode, fused, group)
    sc = ServeConfig(mode=mode, buckets=BUCKETS, full=True, fused=fused,
                     fuse_group=group)
    ops.reset_launches()
    calibrates = mode == "int8" and calibrator is None
    server = make_server(model, sc, params=params, qparams=qparams,
                         calibrator=calibrator)
    reqs = server.submit_many(images)
    stats = server.run()
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    gpu = np.stack([r.logits for r in reqs])
    mb = stats["batches"]
    want = expected_launches(vision_registry.make_schedule(server.cfg), mode,
                             mb, N_CAL if calibrates else 0)
    print(f"[serve] {name}: {len(images)} requests in {mb} micro-batches"
          f"{' + calibration' if calibrates else ''}; launches {counts}")
    check(counts == want, f"{name}: launch counts {counts}, expected {want}")
    twin = make_server(
        model, ServeConfig(mode=mode, buckets=BUCKETS, full=True,
                           fused=fused, fuse_group=group, device="cpu"),
        params=vit.to_device(params, "cpu"),
        qparams=None if mode == "float" else vit.to_device(server.qparams,
                                                           "cpu"),
        calibrator=server.calibrator)
    twin_reqs = twin.submit_many(images)
    twin.run()
    cpu = np.stack([r.logits for r in twin_reqs])
    check_twin(name, mode, gpu, cpu, server.cfg.n_classes)
    return dict(logits=gpu, counts=counts, server=server, twin=cpu)


def check_twin(name: str, mode: str, gpu, cpu, n_classes: int) -> None:
    """Served logits on the card against the CPU twin's: float within 1e-3
    of the logit scale (fp32 reassociation); int8 within 0.02 of it, every
    argmax difference a near-tie of the CPU logits (single-LSB requant
    flips)."""
    shape = (len(cpu), n_classes)
    check(gpu.shape == shape and np.isfinite(gpu).all(),
          f"{name}: logits not finite of shape {shape}")
    scale = float(np.abs(cpu).max())
    err = float(np.abs(gpu - cpu).max())
    if mode == "float":
        print(f"[serve] {name}: |cuda - cpu| max {err:.3e} (logit scale "
              f"{scale:.3f}, bound 1e-3 x scale)")
        check(err <= 1e-3 * scale, f"{name}: logits disagree with the CPU")
    else:
        n_differ, ties = argmax_check(gpu, cpu, err)
        print(f"[serve] {name}: |cuda - cpu| max {err:.3e} (scale "
              f"{scale:.3f}, bound 0.02 x scale); argmax differs on "
              f"{n_differ}/{len(cpu)} requests, each a near-tie of the "
              f"CPU logits: {ties}")
        check(err <= 0.02 * scale and ties,
              f"{name}: logits disagree with the CPU twin")


def check_modes(name: str, counts: dict, modes: dict, act: str) -> None:
    """Every launch of a kernel with dtype modes on a bf16 path ran its
    (``act``, bfloat16) instantiation: the float kernels with bf16
    weights, the int8 layers with bf16 LN vectors and biases.  Adds the
    path's modes to MODE_TOTALS."""
    n_mode = sum(counts[k] for k in MODE_KERNELS)
    print(f"[serve] {name}: launches by dtype mode {modes}")
    check(sum(modes.values()) == n_mode and all(
        k[0] in MODE_KERNELS and k[1:] == (act, "bfloat16") for k in modes),
        f"{name}: a launch of {MODE_KERNELS} did not run the ({act}, "
        f"bfloat16) instantiation: {modes}")
    for k, v in modes.items():
        MODE_TOTALS[k] = MODE_TOTALS.get(k, 0) + v


def serve_user_path(name: str, model: str, cfg, mode: str, params, images,
                    qparams=None, calibrator=None, act=None) -> dict:
    """A config the registry does not build brought to `VisionServer` on
    the card, as a user brings one, on float32 images.  int8 quantizes the
    params and, without a calibrator, calibrates on the card through
    `calibrate`.  Launch counts are reset just before (calibration
    included) and read just after, and must be what the config's schedule
    launches; ``act`` (bf16 weights): every launch of a kernel with dtype
    modes ran its (``act``, bfloat16) instantiation.  The logits are
    checked against the same server on the CPU."""
    from repro_torch.kernels import ops
    from repro_torch.launch.vision_serve import (ServeConfig, VisionServer,
                                                 calibrate)
    from repro_torch.models import vision_registry, vit

    sc = ServeConfig(mode=mode, buckets=BUCKETS)
    if mode == "int8" and qparams is None:
        qparams = vision_registry.quantize(params)
    calibrates = mode == "int8" and calibrator is None
    ops.reset_launches()
    if calibrates:
        bank = np.random.default_rng(0).standard_normal(
            (2 * N_CAL, cfg.image, cfg.image, 3)).astype(np.float32)
        calibrator = calibrate(qparams, cfg, bank, device="cuda",
                               n_batches=N_CAL)
    server = VisionServer(cfg, params, serve_cfg=sc, qparams=qparams,
                          calibrator=calibrator, model_name=model)
    reqs = server.submit_many(images)
    stats = server.run()
    torch.cuda.synchronize()
    counts, modes = dict(ops.LAUNCHES), dict(ops.MODE_LAUNCHES)
    mb = stats["batches"]
    want = expected_launches(vision_registry.make_schedule(cfg), mode, mb,
                             N_CAL if calibrates else 0)
    print(f"[serve] {name}: {len(images)} requests in {mb} micro-batches"
          f"{' + calibration' if calibrates else ''}; launches {counts}")
    check(counts == want, f"{name}: launch counts {counts}, expected {want}")
    if act is not None:
        check_modes(name, counts, modes, act)
    gpu = np.stack([r.logits for r in reqs])
    twin = VisionServer(cfg, vit.to_device(params, "cpu"),
                        serve_cfg=dataclasses.replace(sc, device="cpu"),
                        qparams=None if qparams is None
                        else vit.to_device(qparams, "cpu"),
                        calibrator=calibrator, model_name=model)
    twin_reqs = twin.submit_many(images)
    twin.run()
    check_twin(name, mode, gpu, np.stack([r.logits for r in twin_reqs]),
               cfg.n_classes)
    return dict(logits=gpu, counts=counts, server=server)


def bf16_forward(model: str, fused: bool, group: int, cfg16, params,
                 images) -> dict:
    """`forward` on bf16 patches on the card (bf16 throughout; launch
    counts reset just before, read just after), against the same weights
    and patches on the CPU through the plain versions in bf16 (within
    about twice the measured gap, BF16_TWIN_REL) and, as the control, in
    float32 (the weights' exact values, BF16_CONTROL_REL)."""
    from repro_torch.kernels import ops
    from repro_torch.models import vision_registry, vit
    from repro_torch.models.layers import cast_params

    name = f"{path_name(model, 'float', fused, group)} forward, all bf16"
    cfg = dataclasses.replace(cfg16, fused=fused, fuse_group=group)
    fwd = vision_registry.forward_fn(cfg)
    patches = vit.extract_patches(torch.from_numpy(images), cfg.patch
                                  ).to(torch.bfloat16)
    x = patches.to("cuda")
    ops.reset_launches()
    with torch.inference_mode():
        got = fwd(params, x, cfg)
    torch.cuda.synchronize()
    counts, modes = dict(ops.LAUNCHES), dict(ops.MODE_LAUNCHES)
    want = expected_launches(vision_registry.make_schedule(cfg), "float", 1,
                             0)
    print(f"[serve] {name}: {len(images)} images; launches {counts}")
    check(counts == want, f"{name}: launch counts {counts}, expected {want}")
    check_modes(name, counts, modes, "bfloat16")
    check(got.dtype == torch.bfloat16
          and tuple(got.shape) == (len(images), cfg.n_classes),
          f"{name}: logits are {got.dtype} {tuple(got.shape)}")
    cpu = vit.to_device(params, "cpu")
    with torch.inference_mode():
        twin16 = fwd(cpu, patches, cfg)
        twin32 = fwd(cast_params(cpu, torch.float32), patches.float(),
                     dataclasses.replace(cfg, dtype="float32"))
    card = got.float().cpu().numpy()
    check_teacher_forced(f"{name} vs the bf16 CPU twin", card,
                         twin16.float().numpy(), BF16_TWIN_REL[model])
    check_teacher_forced(f"{name} vs the fp32 CPU twin (control)", card,
                         twin32.numpy(), BF16_CONTROL_REL)
    return dict(counts=counts)


def profile_run(name: str, run, where: str, what: str,
                label: str = "served") -> list:
    """Device busy share of ``run()`` under torch.profiler (which adds
    host time of its own), the kernels that take the device time, and the
    host's top self time.  Returns (kernel, device us, count) rows (none
    when the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only (kernels and copies); a host op's own
    # device total repeats its kernels' time.
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    if busy_us == 0:
        print(f"[profile] {name}: the profiler saw no device time; busy "
              f"share not measured")
        return rows
    top = sorted(rows, key=lambda r: -r[1])[:6]
    print(f"[profile] {label} {name} on {where}, {what} under "
          f"torch.profiler: device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({100 * busy_us / wall_us:.1f}% "
          f"busy); top: " + "; ".join(
              f"{k[:40]} {t / 1e3:.3f} ms x{c}" for k, t, c in top))
    # Host side of the same run: self time of the torch ops and CUDA
    # runtime calls the profiler records; the rest of the wall is Python
    # and numpy outside them.
    host = [(e.key, e.self_cpu_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    host_us = sum(r[1] for r in host)
    print(f"[profile] {name} host: torch ops and CUDA runtime calls "
          f"{host_us / 1e3:.3f} ms self time of {wall_us / 1e3:.3f} ms wall; "
          f"top: " + "; ".join(
              f"{k[:32]} {t / 1e3:.3f} ms x{c}"
              for k, t, c in sorted(host, key=lambda r: -r[1])[:6]))
    return rows


def profile_drain(name: str, server, where: str) -> list:
    """`profile_run` over a 32-request vision drain at bucket 8."""
    side = server.cfg.image
    server.submit_many(np.zeros((32, side, side, 3), np.float32))
    return profile_run(name, server.run, where, "32 requests")


# The kernels of the per-layer paths, by the name the profiler gives
# them: none may run between embed and head in a grouped drain.
PER_LAYER_KERNELS = ("layer_norm_kernel", "vita_msa_kernel",
                     "mma_gemm_kernel", "attention_kernel",
                     "fused_mlp_rows_kernel", "fused_mlp_kernel")


def check_grouped_drain(mode: str, server, where: str) -> None:
    """The grouped DeiT-T drain's device kernels: one layer-group launch
    per group per micro-batch (32 requests = 4 micro-batches of 8), no
    per-layer kernel (`PER_LAYER_KERNELS`), and int8 GEMMs
    (`mma_gemm_i8_kernel`) only for embed and head in int8 (none in
    float).  The trace is read only when it is complete: when it holds as
    many layer-group kernels as the drain launched (`ops.LAUNCHES`); the
    profiler drops an event now and then, and the drain is then profiled
    again, twice at most."""
    from repro_torch.kernels import ops
    from repro_torch.models import vision_registry

    groups = vision_registry.make_schedule(server.cfg).counts()["layer_group"]
    name = "vita_layer_group_int8" if mode == "int8" else "vita_layer_group"
    kernel = name + "_kernel"
    for _ in range(3):
        ops.reset_launches()
        rows = profile_drain(f"deit_t {mode} grouped by 4", server, where)
        launched = ops.LAUNCHES[name]
        n_group = sum(c for k, _, c in rows if kernel in k)
        if n_group == launched:
            break
        print(f"[profile] deit_t {mode} grouped by 4: the trace holds "
              f"{n_group} of the {launched} {kernel} launched; profiled "
              f"again")
    per_layer = {nm: sum(c for k, _, c in rows
                         if k.split("<")[0].split("(")[0].endswith(nm))
                 for nm in PER_LAYER_KERNELS}
    n_i8 = sum(c for k, _, c in rows if "mma_gemm_i8_kernel" in k)
    print(f"[profile] deit_t {mode} grouped by 4: {kernel} x{n_group} in "
          f"the trace, {launched} launched (expected {groups} groups x 4 "
          f"micro-batches), per-layer kernels {per_layer}, "
          f"mma_gemm_i8_kernel x{n_i8}")
    check(n_group == launched == groups * 4 and not any(per_layer.values())
          and n_i8 == (8 if mode == "int8" else 0),
          f"grouped deit_t {mode}: the drain did not run one layer-group "
          f"kernel per group per micro-batch and no per-layer kernel")


# ---------------------------------------------------------------------------
# Phase 5: open-stream serving and the live HUE profile
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def strict_dispatch(servers):
    """Every `dispatch` of ``servers`` runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host sync inside it
    (the staging, the copy, the forward's launches) raises and fails the
    run.  Yields a list whose length counts the dispatches completed so."""
    calls = []

    def strict(inner):
        def dispatch(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = inner(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            calls.append(1)
            return out
        return dispatch
    for server in servers:
        server.dispatch = strict(server.dispatch)
    try:
        yield calls
    finally:
        for server in servers:
            del server.dispatch                  # the method again


def run_stream(name: str, servers: dict, serving: str, trace, banks: dict,
               tables: dict, twins: dict, mode: str, where: str,
               profiled: bool = False) -> dict:
    """Replay ``trace`` on the card through the admission layer
    (``serving`` "continuous", every dispatch under `strict_dispatch`) or
    the drain baseline ("drain", one server), launch counts reset just
    before and read just after.  Checks that every arrival was served,
    that the launches are the micro-batches times each schedule's, that
    no request rode an infeasible bucket, and each request's logits
    against the CPU twin of its bank image (`check_twin`).  ``profiled``
    runs it under `profile_run` (the device's busy share).  Returns the
    stats row and the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import admission as adm
    from repro_torch.models import vision_registry

    batches0 = {m: s.n_batches for m, s in servers.items()}
    out = {}
    if serving == "continuous":
        ctl = adm.AdmissionController(servers, latencies=tables,
                                      max_inflight=MAX_INFLIGHT)

        def go():
            with strict_dispatch(servers.values()) as calls:
                out["stats"] = adm.run_open_stream(ctl, trace, banks)
            out["calls"] = len(calls)
            out["reqs"] = sorted(ctl.completed, key=lambda r: r.rid)
    else:
        (server,) = servers.values()
        done0 = len(server.done)

        def go():
            out["stats"] = adm.run_drain_stream(server, trace, banks)
            out["reqs"] = sorted(server.done[done0:], key=lambda r: r.rid)
    ops.reset_launches()
    if profiled:
        profile_run(name, go, where, f"{len(trace)} arrivals")
    else:
        go()
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    stats, reqs = out["stats"], out["reqs"]
    mbs = {m: s.n_batches - batches0[m] for m, s in servers.items()}
    want = {k[0]: 0 for k in KERNELS}
    for m, s in servers.items():
        for k, v in expected_launches(vision_registry.make_schedule(s.cfg),
                                      mode, mbs[m], 0).items():
            want[k] += v
    check(counts == want, f"{name}: launch counts {counts}, expected {want}"
          f" for {mbs} micro-batches")
    check(len(reqs) == len(trace) == stats["requests"],
          f"{name}: {len(reqs)} of {len(trace)} arrivals served")
    if serving == "continuous":
        check(out["calls"] == sum(mbs.values()),
              f"{name}: {out['calls']} dispatches under sync debug mode "
              f"'error' for {sum(mbs.values())} micro-batches")
        check(stats["infeasible_served"] == 0,
              f"{name}: {stats['infeasible_served']} requests rode an "
              f"infeasible bucket")
        served = {m: sum(1 for a in trace if a.model == m) for m in servers}
        check(stats["per_model"] == served,
              f"{name}: per_model {stats['per_model']}, trace {served}")
    for m, s in servers.items():
        mine = [(a, r) for a, r in zip(trace, reqs) if a.model == m]
        check_twin(f"{name}, {m}", mode,
                   np.stack([r.logits for _, r in mine]),
                   twins[m][[a.image_idx for a, _ in mine]], s.cfg.n_classes)
    if not profiled:
        print(f"[stream] {name} on {where}: {stats['requests']} requests in "
              f"{stats['wall_s']:.3f} s, {sum(mbs.values())} micro-batches "
              f"{mbs}: sustained {stats['throughput_img_s']:.1f} img/s, "
              f"latency p50 {stats['latency_p50_ms']:.3f} / p95 "
              f"{stats['latency_p95_ms']:.3f} / p99 "
              f"{stats['latency_p99_ms']:.3f} ms, queue delay p50 "
              f"{stats['queue_delay_p50_ms']:.3f} ms, service p50 "
              f"{stats['service_p50_ms']:.3f} ms, SLA misses "
              f"{stats['sla_misses']}/{stats['requests']}"
              + (f", held partials {stats['held_partials']}"
                 if serving == "continuous" else "")
              + (f", dispatches under sync debug mode 'error' "
                 f"{out['calls']}" if serving == "continuous" else ""))
    return dict(stats=stats, counts=counts)


def latency_table(name: str, server, where: str) -> dict:
    """`measure_bucket_latencies` on the card, printed."""
    from repro_torch.launch import admission as adm

    table = adm.measure_bucket_latencies(server, repeats=3)
    print(f"[stream] {name} bucket latencies on {where} (dispatch + "
          f"complete, best of 3): " + ", ".join(
              f"{b}: {ms:.3f} ms" for b, ms in sorted(table.items())))
    return table


def stream_phase(served: dict, img_s: dict, images: dict, where: str,
                 t_start: float) -> dict:
    """5a: DeiT-T fused, float and int8, open streams at each load of
    STREAM_LOADS through the admission layer and the drain baseline, and
    the busy share of the int8 stream at the highest load, continuous
    beside drain; 5b: DeiT-T and Swin-T in float as two lanes of one
    admission layer.  Returns the launch counts summed over the runs."""
    from repro_torch.launch import admission as adm

    totals = {k[0]: 0 for k in KERNELS}

    def add(run):
        for k, v in run["counts"].items():
            totals[k] += v
    tables = {}
    for mode in ("float", "int8"):
        o = served[("deit_t", mode, True, 1)]
        server = o["server"]
        table = latency_table(f"deit_t {mode} fused", server, where)
        tables[("deit_t", mode)] = table
        sla = SLA_FACTOR * table[BUCKETS[-1]]
        bank = {"deit_t": images["deit_t"][:STREAM_BANK]}
        twin = {"deit_t": o["twin"][:STREAM_BANK]}
        closed = img_s[("deit_t", mode, True, 1)]
        for load in STREAM_LOADS:
            trace = adm.poisson_trace(load * closed, STREAM_ARRIVALS,
                                      "deit_t", sla_ms=sla, seed=0,
                                      n_images=STREAM_BANK)
            for serving in ("continuous", "drain"):
                name = (f"deit_t {mode} fused, {serving}, {load}x of "
                        f"{closed:.1f} img/s offered "
                        f"({load * closed:.1f}/s), SLA {sla:.3f} ms")
                add(run_stream(name, {"deit_t": server}, serving, trace,
                               bank, {"deit_t": table}, twin, mode, where))
            if mode == "int8" and load == STREAM_LOADS[-1]:
                for serving in ("continuous", "drain"):
                    add(run_stream(
                        f"deit_t int8 {serving} stream at {load}x",
                        {"deit_t": server}, serving, trace, bank,
                        {"deit_t": table}, twin, mode, where,
                        profiled=True))
    print(f"[phase] open streams served at "
          f"{time.perf_counter() - t_start:.0f} s")
    lanes = {m: served[(m, "float", True, 1)] for m in ("deit_t", "swin_t")}
    tables = {"deit_t": tables[("deit_t", "float")],
              "swin_t": latency_table("swin_t float fused",
                                      lanes["swin_t"]["server"], where)}
    rate = LANE_LOAD * min(img_s[(m, "float", True, 1)] for m in lanes)
    sla = SLA_FACTOR * max(t[BUCKETS[-1]] for t in tables.values())
    trace = adm.poisson_trace(rate, LANE_ARRIVALS, tuple(lanes), sla_ms=sla,
                              seed=0, n_images=STREAM_BANK)
    add(run_stream(f"deit_t + swin_t float fused, two lanes, "
                   f"{rate:.1f}/s offered, SLA {sla:.3f} ms",
                   {m: o["server"] for m, o in lanes.items()}, "continuous",
                   trace, {m: images[m][:STREAM_BANK] for m in lanes},
                   tables, {m: o["twin"][:STREAM_BANK]
                            for m, o in lanes.items()}, "float", where))
    print(f"[phase] two lanes served at "
          f"{time.perf_counter() - t_start:.0f} s")
    return totals


def hue_phase(served: dict, images: dict, where: str, t_start: float
              ) -> dict:
    """5c: `profile_stats` of each HUE_CASES server, its HUE table
    printed; then `profile_schedule` on the bucket's first images of
    phase 3, whose records must be the schedule's phases in order and
    whose logits must equal `run_schedule`'s within 1e-6 of the logit
    scale.  Every kind but the head must have a modelled row.  Launch
    counts are reset before each case and read after: 2 x HUE_REPLAYS
    replays of the schedule.  Returns their sum."""
    from repro_torch.core import schedule as sched_lib
    from repro_torch.kernels import ops
    from repro_torch.launch.vision_serve import hue_table
    from repro_torch.models import vision_registry, vit

    totals = {k[0]: 0 for k in KERNELS}
    for model, mode, fused, group, bucket in HUE_CASES:
        server = served[(model, mode, fused, group)]["server"]
        name = f"{path_name(model, mode, fused, group)} bucket {bucket}"
        cfg = server._bucket_cfg[bucket]
        sched = vision_registry.make_schedule(cfg)
        int8 = mode == "int8"
        params = server.qparams if int8 else server.params
        obs = server.calibrator if int8 else None
        ops.reset_launches()
        report = server.profile_stats(bucket, warmup=1,
                                      repeats=HUE_REPLAYS - 1)
        x = vit.extract_patches(
            torch.from_numpy(images[model][:bucket]).to(server.device),
            cfg.patch)
        logits, records = sched_lib.profile_schedule(
            sched, params, x, observer=obs, warmup=1,
            repeats=HUE_REPLAYS - 1)
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        want = expected_launches(sched, mode, 2 * HUE_REPLAYS, 0)
        check(counts == want,
              f"{name} profile: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            totals[k] += v
        print(hue_table(report, f"{name} on {where}"))
        got = [(r["index"], r["kind"], r["site"]) for r in records]
        check(got == [(i, p.kind, p.site)
                      for i, p in enumerate(sched.phases)],
              f"{name}: the profile's records are not the schedule's phases")
        kinds = list(dict.fromkeys(p.kind for p in sched.phases))
        rows = [(r["phase"], r["modelled_cycles"]) for r in report["rows"]]
        check([k for k, _ in rows] == kinds
              and all(c is not None for k, c in rows if k != "head"),
              f"{name}: a phase kind lacks a modelled row: {rows}")
        with torch.inference_mode():
            ref = sched_lib.run_schedule(sched, params, x, observer=obs)
        scale = float(ref.abs().max())
        err = float((logits - ref).abs().max())
        print(f"[hue] {name}: the replay's logits against run_schedule's: "
              f"max|err| {err:.3e} (logit scale {scale:.3f}, bound 1e-6 x "
              f"scale); measured / modelled share: " + "; ".join(
                  f"{r['phase']} {100 * r['measured_share']:.1f}% / "
                  + ("-" if r["modelled_share"] is None
                     else f"{100 * r['modelled_share']:.1f}%")
                  for r in report["rows"]))
        check(err <= 1e-6 * scale, f"{name}: the profile's logits disagree "
                                   f"with run_schedule's")
    print(f"[phase] live HUE profiled at "
          f"{time.perf_counter() - t_start:.0f} s")
    return totals


# ---------------------------------------------------------------------------
# The LM slice: kernels 9-11 and the gated / bf16 modes of kernel 6
# ---------------------------------------------------------------------------


def check_lm(name: str, got, want, tol=None) -> float:
    """An LM kernel against its plain version in the working dtype, row by
    row (a row is the last axis: one head's output, one step of the scan,
    one token of the MLP): each row's max|err| <= tol x max(that row's
    max|want|, 1e-2 x the largest), tol 1e-4 in fp32 (reassociation) and
    2e-2 in bf16 (a few bf16 ulps at the row's own scale: the kernels
    round P or the hidden chunk to bf16 where the plain versions keep
    fp32, and the output is rounded once).  A bound per row keeps the long
    rows of small outputs (attention over ~1,000 keys averages to ~0.05)
    from hiding under the scale of the short ones.  Returns the global
    max|err|."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    row_err = diff.reshape(-1, diff.shape[-1]).amax(1)
    row_scale = want.float().abs().reshape(-1, diff.shape[-1]).amax(1)
    scale = float(row_scale.max())
    tol = tol or LM_TOL[want.dtype]
    ratio = row_err / torch.clamp(row_scale, min=1e-2 * scale or 1e-30)
    worst = int(ratio.argmax())
    print(f"[check] {name}: max|err| {float(row_err.max()):.3e} (scale "
          f"{scale:.3f}); worst row {worst} of {len(ratio)}: max|err| "
          f"{float(row_err[worst]):.3e} at its scale "
          f"{float(row_scale[worst]):.3e} = {float(ratio[worst]):.2e} "
          f"(bound {tol:g} per row)")
    check(got.dtype == want.dtype and got.shape == want.shape
          and bool(torch.isfinite(got.float()).all())
          and float(ratio.max()) <= tol,
          f"{name} disagrees with its plain version")
    return float(row_err.max())


def rand(g, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def dname(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


def flops_at(dtype, flops, w_dtype=None, act=0.0):
    """Keywords for `bound`: ``flops`` of products of inputs of ``dtype``
    with weights of ``w_dtype`` (default ``dtype``), and ``act`` of
    products of two activations.  bf16 inputs run them all at the bf16
    tensor-core rate; fp32 inputs at the fp32 rate, but for the weight
    products with bf16 weights, at the fp32 x bf16 rate."""
    if dtype == torch.bfloat16:
        return {"flops_bf16": flops + act}
    if w_dtype == torch.bfloat16:
        return {"flops_mixed": flops, "flops_f32": act}
    return {"flops_f32": flops + act}


def unsplit(fn):
    """``fn`` run with the fused MLP's plan asked for one hidden split: the
    fewest the kernel takes (one block where it can hold every hidden
    chunk, else one per 8 chunks: 15 blocks at M 7680 in the few-rows
    regime), so what the split buys at a decode step's few rows is
    measured, not assumed."""
    from repro_torch.kernels import fused_mlp as fm

    def run():
        planned = fm.hidden_splits
        fm.hidden_splits = lambda *a: planned(*a, requested=1)
        try:
            return fn()
        finally:
            fm.hidden_splits = planned
    return run


def mlp_plan(tag: str, x, w1, w2) -> None:
    """Print the fused MLP's launch plan for x against (w1, w2): the
    regime (library) and the hidden splits, planned and fewest."""
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels.build import DTYPE_CODES

    d, (m, d_out) = x.shape[-1], w2.shape
    rows, code = x.numel() // d, DTYPE_CODES[x.dtype]
    print(f"[plan] fused_mlp {tag}: {rows} rows -> {fm._library(rows)} "
          f"regime, {fm.hidden_splits(rows, d, m, d_out, code)} hidden "
          f"splits (fewest "
          f"{fm.hidden_splits(rows, d, m, d_out, code, requested=1)})")


def plan_fields(p) -> str:
    """A tile's plan (`vita_msa.MsaPlan`, `vita_msa.AttentionPlan`) as its
    fields."""
    return ", ".join(f"{k} {v}" for k, v in p._asdict().items())


def msa_layout(b: int, h: int, n: int, dh: int, p) -> str:
    """The MSA tile's plan ``p`` for B images of H heads: its clusters
    and fields, or, paged, the projection's blocks and fields and the
    attention tile's layout."""
    from repro_torch.kernels import vita_msa as vm

    if not p.paged:
        return (f"{b * h} clusters ({b * h * p.cluster} blocks); "
                f"{plan_fields(p)}")
    return (f"paged: {b * h * p.cluster} projection blocks "
            f"({plan_fields(p)}), then the attention tile "
            f"({plan_fields(vm.attention_plan(n, dh))})")


def msa_plan_line(tag: str, z, wq) -> None:
    """Print the MSA tile's plan for z (B, N, D) against the (H, D, Dh)
    stack: the operand types, and the packed tile's blocks and layout or
    the cluster tile's clusters and layout."""
    from repro_torch.kernels import vita_msa as vm

    b, n, d = z.shape
    h, _, dh = wq.shape
    packed = vm.msa_packed_plan(n, d, h, dh, z.element_size(),
                                wq.element_size())
    if packed is not None:
        layout = (f"packed: {-(-b // packed.seqs)} blocks of "
                  f"{packed.seqs} sequences ({plan_fields(packed)})")
    else:
        layout = msa_layout(b, h, n, dh, vm.msa_plan(
            n, dh, z.element_size(), wq.element_size()))
    print(f"[plan] vita_msa_batched {tag}: z {dname(z.dtype)}, weights "
          f"{dname(wq.dtype)}; {layout}")


def attention_plan_line(tag: str, b: int, h: int, n: int, dh: int) -> None:
    """Print the attention tile's plan for B images of H heads of N
    tokens of Dh: the blocks, the blocks an SM holds and the layout."""
    from repro_torch.kernels import build
    from repro_torch.kernels import vita_msa as vm

    p = vm.attention_plan(n, dh)
    per_sm = build.blocks_per_sm("attention", "attention", p.dp, p.smem)
    blocks, sms = b * h * -(-n // p.rows), build.sm_count(0)
    print(f"[plan] attention {tag} N={n} Dh={dh}: {blocks} blocks of "
          f"{vm.ATT_THREADS} threads, {per_sm} blocks an SM "
          f"({blocks / (sms * per_sm):.2f} waves on {sms} SMs); "
          f"{plan_fields(p)}")


def launches(fn) -> int:
    """The kernel launches one call of ``fn`` makes (calls of
    `build.call`)."""
    from repro_torch.kernels import build

    real, count = build.call, [0]

    def counted(*args):
        count[0] += 1
        return real(*args)

    build.call = counted
    try:
        fn()
    finally:
        build.call = real
    return count[0]


def group_plan_line(tag: str, x, wq, m: int) -> None:
    """Print kernel 7's plan for x (B, N, D) against the (L, H, D, Dh)
    stack: the grid, the shared memory and each stage's tiles and
    waves."""
    from repro_torch.kernels import vita_layer_group as vg

    p = vg.plan_for(x, wq, m)
    print(f"[plan] vita_layer_group {tag}: x {dname(x.dtype)}, weights "
          f"{dname(wq.dtype)}; grid {p.grid} x {p.threads} threads, "
          f"{p.smem} bytes of shared memory a block; " + "; ".join(
              f"{st.name} {st.count} tiles of {st.rows}x{st.cols} in "
              f"{st.waves} wave{'s' if st.waves > 1 else ''}"
              for st in p.stages))


def int8_group_plan_line(tag: str, i_args) -> None:
    """Print kernel 8's plan for its stacked arguments: the grid, the
    blocks an SM holds, the shared memory, and per stage the tiles, the k
    groups (2: one tile a block; 1: two a block, one a half) and the
    waves."""
    from repro_torch.kernels import build
    from repro_torch.kernels import vita_layer_group as vg

    vt = build.DTYPE_CODES[i_args[-1].dtype]
    p = vg.int8_plan_for(*i_args[:7], vt)
    per_sm = build.blocks_per_sm("vita_layer_group", "vita_layer_group_int8",
                                 vt, p.smem)
    print(f"[plan] vita_layer_group_int8 {tag}: grid {p.grid} x {p.threads} "
          f"threads, {per_sm} blocks an SM, {p.smem} bytes of shared memory "
          f"a block; attention tile {plan_fields(p.att)}; " + "; ".join(
              f"{st.name} {st.count} tiles of {st.rows}x{st.cols}"
              + (f", {st.kgroups} k group{'s' if st.kgroups > 1 else ''} "
                 f"({st.per_block} a block), copies {st.a_chunk}/"
                 f"{st.b_chunk} B" if st.kgroups else "")
              + f" in {st.waves} wave{'s' if st.waves > 1 else ''}"
              for st in p.stages))


def flash_plan_line(tag: str, q, k, v, **kw) -> None:
    """Print kernel 9's plan for a call: the path, the tile rows and key
    tile, the blocks, the shared memory and the keys walked."""
    from repro_torch.kernels import head_attention as ha

    p = ha.plan_for(q, k, v, **kw)
    blocks = p.grid[0] * p.grid[1] * p.grid[2]
    print(f"[plan] flash_attention {tag}: path {p.path} (Dh {p.dp} padded, "
          f"kernel for Dh <= {p.dmax}), {p.rows} query rows ({p.rows // 16} "
          f"row group{'s' if p.rows > 16 else ''} x {p.nw} warp"
          f"{'s' if p.nw > 1 else ''}) x {p.bk}-key tiles, {blocks} "
          f"blocks (grid {p.grid}), {p.smem} bytes of shared memory a block, "
          f"{'cp.async' if p.vec else 'plain-load'} copies; {p.keys_walked()} "
          f"keys walked per (head, sequence) over {p.grid[1]} query tiles")


def i8_plan_line(tag: str, a, w) -> None:
    """Print kernel 4's plan for a against w: the tile, its k groups, the
    ring and the copy widths."""
    from repro_torch.kernels import int8_matmul as im

    p = im.plan_for(a, w)
    print(f"[plan] int8_matmul {tag}: tile {p.bm}x{p.bn}, {p.kgroups} k "
          f"group{'s' if p.kgroups > 1 else ''} ({p.threads} threads), "
          f"{p.stages} stages 128 deep, A in {p.a_chunk}-byte and B in "
          f"{p.b_chunk}-byte copies, {p.tiles} tiles ({p.waves} an SM at "
          f"most)")


def i8_kgroups_sweep(records: dict, where: str) -> None:
    """Kernel 4's device time per launch at each timed shape and each
    k-group count it is built for (`i8_kgroups_ms`), printed beside the
    count its plan picks."""
    r = records["int8_matmul"]
    for x in [r] + r["extra"]:
        times = i8_kgroups_ms(x["fn"])
        print(f"[plan] int8_matmul {x['tag']} on {where}: device ms a "
              f"launch by k groups (one profiler session): " + ", ".join(
                  f"{kg}: {ms:.4f}" for kg, ms in sorted(times.items())))


def flash_tiles_sweep(records: dict, where: str) -> None:
    """Kernel 9's device time per launch at each timed shape on both tiles
    its plan chooses between (16 query rows shared by four warps, and the
    wide 64- or 128-row tile; `flash_plan`'s ``few_rows``), from one
    torch.profiler session per shape, told apart by the kernel's row
    groups (retried where the profiler lost a tile's events)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import head_attention as ha

    planned = ha.plan_for

    def forced(few):
        def plan_for(q, k, v, causal=True, window=None, q_offset=0):
            b, hq, nq, dh = q.shape
            return ha.flash_plan(b, hq, nq, k.shape[2], dh, q.element_size(),
                                 causal, window, q_offset, True, few)
        return plan_for

    def session(fn):
        try:
            for few in (True, False):
                ha.plan_for = forced(few)
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for few in (True, False):
                    ha.plan_for = forced(few)
                    for _ in range(20):
                        fn()
                torch.cuda.synchronize()
        finally:
            ha.plan_for = planned
        out = {}
        for e in prof.key_averages():
            m = re.search(r"flash_attention_kernel<[^,]+, \d+, \d+, (\d+), "
                          r"\d+>", e.key)
            if e.device_type == DeviceType.CUDA and m and e.count:
                out[16 * int(m.group(1))] = (e.self_device_time_total
                                             / e.count / 1e3)
        return out

    r = records["flash_attention"]
    for x in [r] + r["extra"]:
        for _ in range(3):  # a session that lost a tile's events, again
            out = session(x["fn"])
            if len(out) == 2:
                break
        print(f"[plan] flash_attention {x['tag']} on {where}: device ms a "
              f"launch by query rows a tile (one profiler session): "
              + ", ".join(f"{rows}: {ms:.4f}" for rows, ms in
                          sorted(out.items())))


def scan_walk_sweep(records: dict, where: str) -> None:
    """The RG-LRU scan's device time at each shape past one chunk, chunked
    (its plan) and as the one-thread-per-channel walk the chunked scan
    replaced (`scan_plan`'s ``walk``), each from `device_ms`, one after
    the other."""
    r = records["rglru_scan"]
    timed = {x["tag"]: x for x in [r] + r["extra"]}
    for tag, walk in SCAN_WALKS:
        (ms, by), (walk_ms, walk_by) = (device_ms(timed[tag]["fn"]),
                                        device_ms(walk))
        print(f"[time] rglru_scan {tag} on {where}: chunked {ms:.4f} ms "
              f"[{by}], walk {walk_ms:.4f} ms [{walk_by}] "
              f"({walk_ms / ms:.2f}x), bound {timed[tag]['bound'][0]:.4f} "
              f"ms ({timed[tag]['bound'][1]})")


def group_chain_ms(group_fn, chain_fn, iters: int = 20):
    """(group ms, chain ms): the device time per call of an int8 layer
    group and of its L `vita_layer_int8` calls, from one torch.profiler
    session in which each runs ``iters`` times, told apart by kernel name
    (the group's own kernel and its barrier's memset against the chain's
    kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    group_fn()
    chain_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            group_fn()
        for _ in range(iters):
            chain_fn()
        torch.cuda.synchronize()
    g_us = c_us = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if "vita_layer_group_int8_kernel" in e.key or "emset" in e.key:
            g_us += e.self_device_time_total
        else:
            c_us += e.self_device_time_total
    return g_us / iters / 1e3, c_us / iters / 1e3


def i8_kgroups_ms(fn, iters: int = 20) -> dict:
    """Kernel 4's device time per launch in ``fn`` at each k-group count
    it is built for (`gemm_i8_plan`'s ``kgroups``), from one
    torch.profiler session in which each count runs ``iters`` calls,
    told apart by the kernel's name (a dropped event leaves the mean per
    launch unchanged): the measurement behind the plan's choice."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import int8_matmul as im

    planned = im.plan_for

    def forced(kg):
        def plan_for(a, w):
            k, n, ldb, grp, grp_stride = im.b_layout(w)
            return im.gemm_i8_plan(
                a.shape[0], n, k, ldb=ldb, grp=grp, grp_stride=grp_stride,
                a_align=a.data_ptr() % 16, b_align=w.data_ptr() % 16,
                kgroups=kg)
        return plan_for

    try:
        for kg in im.I8_KGROUPS:
            im.plan_for = forced(kg)
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for kg in im.I8_KGROUPS:
                im.plan_for = forced(kg)
                for _ in range(iters):
                    fn()
            torch.cuda.synchronize()
    finally:
        im.plan_for = planned
    out = {}
    for e in prof.key_averages():
        m = re.search(r"mma_gemm_i8_kernel<(\d+)", e.key)
        if e.device_type == DeviceType.CUDA and m and e.count:
            out[int(m.group(1))] = e.self_device_time_total / e.count / 1e3
    return out


def layer_plan(tag: str, run, x, wq) -> None:
    """Print kernel 1's plan for x (B, N, D): the launches one call of
    ``run`` makes and the MSA tile's plan on the fp32 LN1 output."""
    from repro_torch.kernels import vita_msa as vm

    b, n, _ = x.shape
    h, _, dh = wq.shape
    p = vm.msa_plan(n, dh, 4, wq.element_size())
    print(f"[plan] vita_layer {tag}: {launches(run)} launches; x "
          f"{dname(x.dtype)}, weights {dname(wq.dtype)}; MSA tile on fp32 "
          f"z, {msa_layout(b, h, n, dh, p)}")


def visible_pairs(nq: int, nk: int, causal: bool, window, q_offset=0):
    """The number of (query, key) pairs the masks leave (for the bound)
    and the boolean (nq, nk) mask itself (for the library yardstick)."""
    qpos = torch.arange(nq, device="cuda")[:, None] + q_offset
    kpos = torch.arange(nk, device="cuda")[None, :]
    m = torch.ones((nq, nk), dtype=torch.bool, device="cuda")
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return int(m.sum()), m


def lm_kernel_phase(records: dict) -> None:
    """Kernels 9-11 and the LM modes of kernel 6 against their plain
    versions on the card, fp32 and bf16, at the LM paths' shapes, with a
    library yardstick each (none for the scan)."""
    import torch.nn.functional as F
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import head_attention as ha
    from repro_torch.kernels import ref, rglru_scan as rs

    g = torch.Generator(device="cuda").manual_seed(14)
    bf, f32 = torch.bfloat16, torch.float32

    # Flash: RecurrentGemma's prefill (Hq 10 over 1 KV head, Dh 256,
    # window 2048) at 13 tokens and at 4,096 (the window binds), and
    # stablelm-3b's (MHA 32 heads, Dh 80, causal) at 13.
    for tag, hq, hkv, dh, n, window in (
            ("recurrentgemma-2b prefill 13", 10, 1, 256, 13, 2048),
            ("recurrentgemma-2b prefill 4096, window 2048", 10, 1, 256,
             4096, 2048),
            ("stablelm-3b prefill 13", 32, 32, 80, 13, None)):
        for dtype in (bf, f32):
            q = rand(g, (1, hq, n, dh), dtype)
            k, v = rand(g, (1, hkv, n, dh), dtype), rand(g, (1, hkv, n, dh),
                                                          dtype)
            kw = dict(causal=True, window=window)
            err = check_lm(f"flash_attention {tag} {dname(dtype)}",
                           ha.flash_attention(q, k, v, **kw),
                           ref.attention_ref(q, k, v, **kw))
            flash_plan_line(f"{tag} {dname(dtype)}", q, k, v, **kw)
            pairs, mask = visible_pairs(n, n, True, window)
            add_record(
                records, "flash_attention", f"{tag} {dname(dtype)}", err,
                lambda q=q, k=k, v=v, kw=kw: ha.flash_attention(q, k, v, **kw),
                lambda q=q, k=k, v=v, kw=kw: ref.attention_ref(q, k, v, **kw),
                lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=m, enable_gqa=True),
                bound(nbytes=2 * nbytes(q) + 2 * nbytes(k),
                      **flops_at(dtype, 4 * pairs * hq * dh)))

    # Decode: batch 4, RecurrentGemma's Hq 10 over 1 KV head of 256 over
    # caches of 128 (the served path) and 2048 slots, and stablelm-3b's 32
    # heads of 80 (MHA: one query row per block) over 128; ragged lengths
    # including 1.
    for tag, hq, hkv, dh, s_len in (
            ("recurrentgemma-2b", 10, 1, 256, LM_CACHE),
            ("recurrentgemma-2b", 10, 1, 256, 2048),
            ("stablelm-3b", 32, 32, 80, LM_CACHE)):
        for dtype in (bf, f32):
            q = rand(g, (4, hq, dh), dtype)
            kc, vc = (rand(g, (4, hkv, s_len, dh), dtype) for _ in range(2))
            lengths = torch.tensor([1, s_len // 2 + 5, s_len, s_len // 3],
                                   dtype=torch.int32, device="cuda")
            err = check_lm(f"decode_attention {tag} S {s_len} {dname(dtype)}",
                           ha.decode_attention(q, kc, vc, lengths),
                           ref.decode_attention_ref(q, kc, vc, lengths))
            valid = int(lengths.sum())
            splits = ha.decode_splits(4, hkv, s_len)
            print(f"[plan] decode_attention {tag} B 4, Hkv {hkv}, S {s_len}"
                  f" {dname(dtype)}: {splits} key splits of "
                  f"{-(-(-(-s_len // 32)) // splits) * 32} slots, "
                  f"{4 * hkv * splits} blocks")
            mask = (torch.arange(s_len, device="cuda")[None]
                    < lengths[:, None])[:, None, None]
            add_record(
                records, "decode_attention",
                f"{tag} B 4, Hq {hq} / Hkv {hkv}, Dh {dh}, S {s_len} "
                f"{dname(dtype)}", err,
                lambda a=(q, kc, vc, lengths): ha.decode_attention(*a),
                lambda a=(q, kc, vc, lengths): ref.decode_attention_ref(*a),
                lambda q=q, kc=kc, vc=vc, m=mask:
                    F.scaled_dot_product_attention(
                        q[:, :, None], kc, vc, attn_mask=m, enable_gqa=True),
                bound(nbytes=2 * nbytes(q) + nbytes(lengths)
                      + 2 * valid * hkv * dh * q.element_size(),
                      **flops_at(dtype, 4 * valid * hq * dh)))

    # The RG-LRU scan: one sequence, W 2560, T 13 (a prompt), 2,100 (the
    # ring check's prompt) and 4,096; past one chunk the walk it replaced
    # is timed beside it (`scan_walk_sweep`).
    for t_len in (13, RING_PROMPT, 4096):
        for dtype in (f32, bf):
            a = (0.5 + 0.499 * torch.rand((1, t_len, 2560), generator=g,
                                          device="cuda")).to(dtype)
            b = rand(g, (1, t_len, 2560), dtype)
            tag = f"B 1, T {t_len}, W 2560 {dname(dtype)}"
            err = check_lm(f"rglru_scan T {t_len} W 2560 {dname(dtype)}",
                           rs.rglru_scan(a, b),
                           ref.linear_recurrence_ref(a, b))
            p = rs.scan_plan(1, t_len, 2560, dtype)
            print(f"[plan] rglru_scan {tag}: "
                  f"{'walk' if p.chunks == 1 else 'chunked'}, "
                  f"{p.chunks * p.runs} blocks of {p.channels} threads; "
                  f"{plan_fields(p)}")
            add_record(records, "rglru_scan", tag, err,
                       lambda a=a, b=b: rs.rglru_scan(a, b),
                       lambda a=a, b=b: ref.linear_recurrence_ref(a, b),
                       None, bound(nbytes=3 * nbytes(a),
                                   flops_f32=2 * a.numel()))
            if p.chunks > 1:
                SCAN_WALKS.append((tag, lambda a=a, b=b: rs.rglru_scan(
                    a, b, walk=True)))

    # Fused MLP, gated: RecurrentGemma (GELU, D 2560, M 7680) and
    # stablelm-3b (SiLU, M 6912), each at a 13-token prefill and a decode
    # step of 4 (the few-rows regime); fp32 and bf16.  Timed in bf16 (the
    # paths' dtype) and, for RecurrentGemma's decode step, in fp32 (the
    # ring path's dtype).
    for tag, act, m, n in (("recurrentgemma-2b gated gelu", "gelu", 7680, 13),
                           ("recurrentgemma-2b gated gelu", "gelu", 7680, 4),
                           ("stablelm-3b gated silu", "silu", 6912, 13),
                           ("stablelm-3b gated silu", "silu", 6912, 4)):
        for dtype in (bf, f32):
            d = 2560
            x = rand(g, (n, d), dtype)
            w1, wg = rand(g, (d, m), dtype, d ** -0.5), rand(g, (d, m), dtype,
                                                              d ** -0.5)
            w2 = rand(g, (m, d), dtype, m ** -0.5)
            err = check_lm(f"fused_mlp {tag} N {n} {dname(dtype)}",
                           fm.fused_mlp(x, w1, w2, w_gate=wg, activation=act),
                           ref.fused_mlp_ref(x, w1, None, w2, None,
                                             activation=act, w_gate=wg))
            timed_f32 = n == 4 and act == "gelu"
            if dtype != bf and not timed_f32:
                continue
            mlp_plan(f"{tag} N {n} {dname(dtype)}", x, w1, w2)
            lib_act = (lambda u: F.gelu(u, approximate="tanh")) \
                if act == "gelu" else F.silu
            add_record(
                records, "fused_mlp",
                f"{tag} N {n} D {d} M {m} {dname(dtype)}", err,
                lambda a=(x, w1, w2, wg), act=act: fm.fused_mlp(
                    a[0], a[1], a[2], w_gate=a[3], activation=act),
                lambda a=(x, w1, w2, wg), act=act: ref.fused_mlp_ref(
                    a[0], a[1], None, a[2], None, activation=act,
                    w_gate=a[3]),
                lambda a=(x, w1, w2, wg), f=lib_act:
                    (f(a[0] @ a[3]) * (a[0] @ a[1])) @ a[2],
                bound(nbytes=nbytes(x, w1, wg, w2) + n * d * x.element_size(),
                      **flops_at(dtype, 2 * n * m * (2 * d + d))))
            if n == 4 and act == "gelu" and dtype == bf:
                # The same decode step at the plan's fewest hidden splits.
                run = unsplit(lambda a=(x, w1, w2, wg): fm.fused_mlp(
                    a[0], a[1], a[2], w_gate=a[3], activation="gelu"))
                err = check_lm(f"fused_mlp {tag} N {n} bf16, fewest hidden "
                               f"splits", run(), ref.fused_mlp_ref(
                                   x, w1, None, w2, None, activation=act,
                                   w_gate=wg))
                add_record(
                    records, "fused_mlp",
                    f"{tag} N {n} D {d} M {m} bf16, fewest hidden splits",
                    err,
                    run, records["fused_mlp"]["extra"][-1]["plain"],
                    records["fused_mlp"]["extra"][-1]["library"],
                    records["fused_mlp"]["extra"][-1]["bound"])
    # Every other activation, gated and not, with and without biases, at a
    # small ragged shape: 4 rows (the few-rows regime) and 37 (many rows:
    # two output slices).
    for act in ("relu", "relu2", "identity", "gelu", "silu"):
        for dtype in (f32, bf):
            d, m, d_out = 96, 200, 300
            w1, wg = rand(g, (d, m), dtype, 0.1), rand(g, (d, m), dtype, 0.1)
            w2 = rand(g, (m, d_out), dtype, 0.07)
            b1, b2 = rand(g, (m,), dtype, 0.1), rand(g, (d_out,), dtype, 0.1)
            for rows in (4, 37):
                x = rand(g, (rows, d), dtype)
                for gate in (None, wg):
                    check_lm(f"fused_mlp {act} {'gated' if gate is not None else 'ungated'}"
                             f" biases N {rows} {dname(dtype)}",
                             fm.fused_mlp(x, w1, w2, b1, b2, gate,
                                          activation=act),
                             ref.fused_mlp_ref(x, w1, b1, w2, b2,
                                               activation=act, w_gate=gate))
    torch.cuda.synchronize()


def lm_rest_kernel_phase(records: dict) -> None:
    """Kernels 6, 9 and 10 at the shapes phase 7's paths give them,
    against their plain versions in fp32 and bf16, each timed in bf16
    beside its library yardstick: flash non-causal at HuBERT-XLarge's
    (4 clips of 500 frames, 16 heads of 80) and causal at InternVL2-26B's
    GQA prefill (48 over 8 heads of 128, 1,040 tokens: 1,024 image and 16
    text); decode at InternVL2's group of 6 (Dh 128, batch 4 over
    IVL_CACHE slots, ragged); the fused MLP at HuBERT's 2,000 rows (GELU,
    D 1280, M 5120) and InternVL2's prefill and decode rows (gated SiLU,
    D 6144, M 16384)."""
    import torch.nn.functional as F
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import head_attention as ha
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(25)
    bf, f32 = torch.bfloat16, torch.float32
    n_ivl = IVL_IMAGE + IVL_PROMPT
    for tag, b, hq, hkv, dh, n, causal in (
            (f"hubert-xlarge {HUBERT_CLIPS} x {HUBERT_FRAMES} non-causal",
             HUBERT_CLIPS, 16, 16, 80, HUBERT_FRAMES, False),
            (f"internvl2-26b prefill {n_ivl}", 1, 48, 8, 128, n_ivl, True)):
        for dtype in (bf, f32):
            q = rand(g, (b, hq, n, dh), dtype)
            k, v = rand(g, (b, hkv, n, dh), dtype), rand(g, (b, hkv, n, dh),
                                                          dtype)
            err = check_lm(f"flash_attention {tag} {dname(dtype)}",
                           ha.flash_attention(q, k, v, causal=causal),
                           ref.attention_ref(q, k, v, causal=causal))
            if dtype != bf:
                continue
            flash_plan_line(f"{tag} {dname(dtype)}", q, k, v, causal=causal)
            pairs, mask = visible_pairs(n, n, causal, None)
            add_record(
                records, "flash_attention",
                f"{tag} B {b}, Hq {hq} / Hkv {hkv}, Dh {dh} {dname(dtype)}",
                err,
                lambda q=q, k=k, v=v, c=causal: ha.flash_attention(
                    q, k, v, causal=c),
                lambda q=q, k=k, v=v, c=causal: ref.attention_ref(
                    q, k, v, causal=c),
                lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=m, enable_gqa=True),
                bound(nbytes=2 * nbytes(q) + 2 * nbytes(k),
                      **flops_at(dtype, 4 * b * pairs * hq * dh)))

    hq, hkv, dh, s_len = 48, 8, 128, IVL_CACHE
    for dtype in (bf, f32):
        q = rand(g, (4, hq, dh), dtype)
        kc, vc = (rand(g, (4, hkv, s_len, dh), dtype) for _ in range(2))
        lengths = torch.tensor([n_ivl + 1, n_ivl + 8, s_len, 1],
                               dtype=torch.int32, device="cuda")
        err = check_lm(f"decode_attention internvl2-26b S {s_len} "
                       f"{dname(dtype)}",
                       ha.decode_attention(q, kc, vc, lengths),
                       ref.decode_attention_ref(q, kc, vc, lengths))
        if dtype != bf:
            continue
        valid = int(lengths.sum())
        mask = (torch.arange(s_len, device="cuda")[None]
                < lengths[:, None])[:, None, None]
        print(f"[plan] decode_attention internvl2-26b B 4, Hkv {hkv}, S "
              f"{s_len} bf16: {ha.decode_splits(4, hkv, s_len)} key splits")
        add_record(
            records, "decode_attention",
            f"internvl2-26b B 4, Hq {hq} / Hkv {hkv}, Dh {dh}, S {s_len} "
            f"bf16", err,
            lambda a=(q, kc, vc, lengths): ha.decode_attention(*a),
            lambda a=(q, kc, vc, lengths): ref.decode_attention_ref(*a),
            lambda q=q, kc=kc, vc=vc, m=mask: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=m, enable_gqa=True),
            bound(nbytes=2 * nbytes(q) + nbytes(lengths)
                  + 2 * valid * hkv * dh * q.element_size(),
                  **flops_at(dtype, 4 * valid * hq * dh)))

    for tag, act, gated, d, m, n in (
            ("hubert-xlarge gelu", "gelu", False, 1280, 5120,
             HUBERT_CLIPS * HUBERT_FRAMES),
            ("internvl2-26b gated silu", "silu", True, 6144, 16384,
             IVL_BATCH * n_ivl),
            ("internvl2-26b gated silu", "silu", True, 6144, 16384,
             IVL_BATCH)):
        for dtype in (bf, f32):
            x = rand(g, (n, d), dtype)
            w1 = rand(g, (d, m), dtype, d ** -0.5)
            wg = rand(g, (d, m), dtype, d ** -0.5) if gated else None
            w2 = rand(g, (m, d), dtype, m ** -0.5)
            err = check_lm(f"fused_mlp {tag} N {n} {dname(dtype)}",
                           fm.fused_mlp(x, w1, w2, w_gate=wg, activation=act),
                           ref.fused_mlp_ref(x, w1, None, w2, None,
                                             activation=act, w_gate=wg))
            if dtype != bf:
                continue
            mlp_plan(f"{tag} N {n} {dname(dtype)}", x, w1, w2)
            f_act = (lambda u: F.gelu(u, approximate="tanh")) \
                if act == "gelu" else F.silu
            lib = (lambda a=(x, w1, w2, wg), f=f_act:
                   (f(a[0] @ a[3]) * (a[0] @ a[1])) @ a[2]) if gated else \
                (lambda a=(x, w1, w2), f=f_act: f(a[0] @ a[1]) @ a[2])
            add_record(
                records, "fused_mlp",
                f"{tag} N {n} D {d} M {m} {dname(dtype)}", err,
                lambda a=(x, w1, w2, wg), act=act: fm.fused_mlp(
                    a[0], a[1], a[2], w_gate=a[3], activation=act),
                lambda a=(x, w1, w2, wg), act=act: ref.fused_mlp_ref(
                    a[0], a[1], None, a[2], None, activation=act,
                    w_gate=a[3]), lib,
                bound(nbytes=nbytes(x, w1, w2) + (nbytes(wg) if gated else 0)
                      + n * d * x.element_size(),
                      **flops_at(dtype, 2 * n * m * ((3 if gated else 2)
                                                     * d))))
    torch.cuda.synchronize()


def expected_lm_launches(cfg, prefills: int, steps: int) -> dict:
    """Kernel launches of ``prefills`` prefills (or `forward` calls) and
    ``steps`` decode steps: per prefill one flash_attention per attention
    layer, one rglru_scan per recurrent layer and one fused_mlp per dense
    feed-forward; per decode step one decode_attention per attention
    layer and one fused_mlp per dense feed-forward.  An MoE feed-forward's
    experts are batched products (no kernel), and xLSTM's blocks launch
    none of the port's kernels."""
    from repro_torch.models import transformer

    kinds = transformer.layer_kinds(cfg)
    n_attn, n_rec = kinds.count("attn"), kinds.count("rec")
    n_ff = len(kinds) if cfg.d_ff and cfg.moe is None else 0
    out = {k[0]: 0 for k in KERNELS}
    out.update(flash_attention=n_attn * prefills, rglru_scan=n_rec * prefills,
               decode_attention=n_attn * steps,
               fused_mlp=n_ff * (prefills + steps))
    return out


def teacher_forced(cfg, twin_params, done):
    """The CPU twin's logits for the card's tokens: one right-padded batch
    through `forward` (causal, so the padding never reaches a real
    position), at every position whose next token the card chose.  (An
    MoE model's twin replays the server's calls instead: `moe_twin`.)
    Returns (card logits, CPU logits), (tokens, vocab) each."""
    from repro_torch.models import transformer

    seqs = [list(r.prompt) + r.generated[:-1] for r in done]
    tokens = torch.zeros((len(seqs), max(map(len, seqs))), dtype=torch.int32)
    for i, sq in enumerate(seqs):
        tokens[i, :len(sq)] = torch.tensor(sq, dtype=torch.int32)
    with torch.no_grad():
        logits = transformer.forward(twin_params, {"tokens": tokens}, cfg)
    got, want = [], []
    for i, r in enumerate(done):
        p = len(r.prompt)
        got.append(np.stack(r.logits))
        want.append(logits[i, p - 1:p - 1 + len(r.generated),
                           :cfg.vocab].float().numpy())
    return np.concatenate(got), np.concatenate(want)


def replay(cfg, params, prompts, max_new: int, cache_len: int, feed=None):
    """Prefill each batch of ``prompts`` alone (numpy inputs; the slot
    server prefills each request alone), then ``max_new`` - 1 lock-step
    decode steps over all their sequences, through `launch.steps` on
    ``params``' device: greedy on the device's own tokens, or fed
    ``feed`` (sequences, max_new) (teacher forcing).  Returns the tokens
    (sequences, max_new) and the logits (sequences, max_new, vocab)
    float32, numpy."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    dev = transformer.param_device(params)
    prefill = steps.make_prefill_step(cfg, cache_len, with_logits=True)
    decode = steps.make_decode_step(cfg, with_logits=True)
    n = sum(len(next(iter(b.values()))) for b in prompts)
    caches = transformer.init_caches(cfg, n, cache_len, dev)
    toks, logits, pos, row = [], [], [], 0
    with torch.no_grad():
        for batch in prompts:
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            tok, one, lg = prefill(params, batch)
            m = tok.shape[0]
            for c, c1 in zip(caches, one):
                for key in c:
                    c[key][row:row + m] = c1[key]
            toks.append(tok)
            logits.append(lg)
            pos += [steps.next_position(cfg, batch)] * m
            row += m
        out_toks, out_logits = [torch.cat(toks)], [torch.cat(logits)]
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        for i in range(max_new - 1):
            cur = out_toks[-1] if feed is None else torch.as_tensor(
                feed[:, i], dtype=torch.int32, device=dev)
            tok, caches, lg = decode(params, cur, caches, pos + i)
            out_toks.append(tok)
            out_logits.append(lg)
    return (torch.stack(out_toks, 1).cpu().numpy(),
            torch.stack(out_logits, 1)[..., :cfg.vocab].float().cpu()
            .numpy())


def check_teacher_forced(name: str, got, want, rel: float) -> float:
    """The card's logits against a CPU twin's: max|err| <= rel x logit
    scale, and a token whose argmax differs must be a near-tie of the
    card's own logits: its top two within 2 x that token's own max|err|."""
    row_err = np.abs(got - want).max(1)
    err = float(row_err.max())
    scale = float(np.abs(want).max())
    differ = got.argmax(1) != want.argmax(1)
    top2 = np.sort(got, axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    ties = bool(np.all(gap[differ] <= 2 * row_err[differ]))
    print(f"[serve] {name}: |cuda - cpu| max {err:.3e} "
          f"({err / scale:.2%} of the logit scale {scale:.3f}, bound "
          f"{rel:g}), rms {float(np.sqrt(np.mean((got - want) ** 2))):.3e};"
          f" argmax differs on {int(differ.sum())} of {len(got)} tokens, "
          f"each a near-tie of the card's logits within its own error: "
          f"{ties}")
    check(np.isfinite(got).all() and err <= rel * scale and ties,
          f"{name}: logits disagree with the CPU twin")
    return err


def serve_lm(name: str, cfg, params, n_req: int, seed: int,
             twins: list) -> dict:
    """Serve ``n_req`` requests through `SlotServer` on the card (launch
    counts reset just before, read just after), check the counts, the
    outputs' shapes and the logits, teacher-forced, against each of
    ``twins``: (label, twin config, CPU params, bound as a share of the
    logit scale)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    queue = serve.make_requests(cfg, n_req, LM_PROMPT, LM_MAX_NEW, seed)
    t0 = time.perf_counter()
    ops.reset_launches()
    server = serve.SlotServer(cfg, params, LM_BATCH, LM_CACHE,
                              keep_logits=True)
    done = serve.drain(server, queue)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    want = expected_lm_launches(cfg, n_req, server.steps)
    print(f"[serve] {name}: {n_req} requests, {server.steps} decode steps "
          f"in {time.perf_counter() - t0:.1f} s; launches {counts}")
    check(counts == want, f"{name}: launch counts {counts}, expected {want}")
    check(len(done) == n_req and all(
        len(r.generated) == LM_MAX_NEW and len(r.logits) == LM_MAX_NEW
        and all(lg.shape == (cfg.vocab,) for lg in r.logits) for r in done),
        f"{name}: not every request got {LM_MAX_NEW} tokens and logits")
    for label, twin_cfg, twin_params, rel in twins:
        t0 = time.perf_counter()
        got, ref_logits = teacher_forced(twin_cfg, twin_params, done)
        check_teacher_forced(f"{name} vs {label} (its forward in "
                             f"{time.perf_counter() - t0:.1f} s)", got,
                             ref_logits, rel)
    return dict(counts=counts, server=server, done=done)


def serve_lm_both(name: str, cfg, params, n_req: int, seed: int):
    """An LM path served in bf16 (against the bf16 CPU twin, and the fp32
    one as the control) and in float32 (against the fp32 twin).  Returns
    the launch counts of each and the float32 params on the card."""
    from repro_torch.models.layers import cast_params, to_device

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = cast_params(params, torch.float32)
    t0 = time.perf_counter()
    twin16, twin32 = to_device(params, "cpu"), to_device(params32, "cpu")
    print(f"[serve] {name}: CPU twins of the same weights in bfloat16 and "
          f"in float32 ({time.perf_counter() - t0:.1f} s to copy)")
    arch = name.split()[0]
    bf = serve_lm(f"{name} bf16", cfg, params, n_req, seed, [
        ("the bf16 CPU twin", cfg, twin16, LM_TWIN_REL[arch]),
        ("the fp32 CPU twin (control)", cfg32, twin32,
         LM_CONTROL_REL_BY_ARCH.get(arch, LM_CONTROL_REL))])
    f32 = serve_lm(f"{name} fp32", cfg32, params32, n_req, seed, [
        ("the fp32 CPU twin", cfg32, twin32,
         LM_FP32_REL_BY_ARCH.get(arch, LM_FP32_REL))])
    return {f"{name} bf16": bf["counts"], f"{name} fp32": f32["counts"]}, \
        params32


def ring_check(cfg32, params32, where: str) -> None:
    """One request of 2,100 tokens with cache_len 2048 (prefill keeps the
    rolled ring; the 2048 window binds), then 8 decode steps, fp32: each
    logit row equals `forward` over the whole 2,108 tokens."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    rng = np.random.default_rng(5)
    req = serve.Request(0, rng.integers(0, cfg32.vocab, size=RING_PROMPT),
                        RING_NEW + 1)
    server = serve.SlotServer(cfg32, params32, 1, RING_CACHE,
                              keep_logits=True)
    t0 = time.perf_counter()
    done = serve.drain(server, [req])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r = done[0]
    seq = torch.tensor(list(r.prompt) + r.generated[:-1], dtype=torch.int32,
                       device="cuda")[None]
    with torch.no_grad():
        full = transformer.forward(params32, {"tokens": seq}, cfg32)
    want = full[0, RING_PROMPT - 1:, :cfg32.vocab].float().cpu().numpy()
    got = np.stack(r.logits)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    same = int((got.argmax(1) == want.argmax(1)).sum())
    print(f"[ring] recurrentgemma-2b fp32 on {where}: prompt {RING_PROMPT} "
          f"tokens, cache {RING_CACHE} (window {cfg32.window}), "
          f"{RING_NEW} decode steps in {dt:.2f} s; last logits vs forward "
          f"over {seq.shape[1]} tokens: max|err| {err:.3e} over "
          f"{len(got)} rows (scale {scale:.3f}, bound 1e-3 x scale), argmax "
          f"equal on {same}/{len(got)}")
    check(got.shape == want.shape and np.isfinite(got).all()
          and err <= 1e-3 * scale,
          "ring-cache decode disagrees with forward over the whole sequence")


def lm_times(name: str, cfg, params, where: str) -> None:
    """Decode tokens per second and prefill time per request of a drain of
    8 requests at batch 4 (16 new tokens each, no logits kept), with the
    MLP's planned hidden splits, with its fewest, and planned again; then
    the profile of a drain under torch.profiler."""
    from repro_torch.launch import serve

    for split in (True, False, True):
        server = serve.SlotServer(cfg, params, LM_BATCH, LM_CACHE)
        run = lambda s=server: serve.drain(s, serve.make_requests(
            cfg, 8, LM_PROMPT, 16, seed=3))
        (run if split else unsplit(run))()
        print(f"[time] served {name} on {where}"
              f"{'' if split else ', the MLP at its fewest hidden splits'}: "
              f"batch {LM_BATCH}, 8 requests of 16 new tokens: decode "
              f"{server.decoded / server.decode_s:.1f} tok/s ({server.steps} "
              f"steps, {1e3 * server.decode_s / server.steps:.2f} ms per "
              f"step), prefill {1e3 * float(np.mean(server.prefill_s)):.2f} "
              f"ms per request (prompts of 4-{LM_PROMPT} tokens; host wall, "
              f"each ending in a device sync)")
    server = serve.SlotServer(cfg, params, LM_BATCH, LM_CACHE)
    queue = serve.make_requests(cfg, LM_BATCH, LM_PROMPT, LM_MAX_NEW, seed=4)
    rows = profile_run(name, lambda: serve.drain(server, queue), where,
                       f"a drain of {LM_BATCH} requests ({LM_BATCH} "
                       f"prefills, {LM_MAX_NEW - 1} decode steps)")
    want = expected_lm_launches(cfg, LM_BATCH, server.steps)["fused_mlp"]
    seen = sum(c for k, _, c in rows if "fused_mlp_kernel" in k)
    print(f"[profile] {name}: fused_mlp_kernel x{seen} in the trace, "
          f"{want} launched (the trace is complete where they agree)")


def lm_paths(where: str):
    """The LM served paths: RecurrentGemma-2B full width and depth and
    stablelm-3b at full width and 4 layers, each in bf16 and in float32
    (`serve_lm_both`), with RecurrentGemma's fp32 ring-cache check between
    them.  Returns the launch counts of each served path and (name, cfg,
    params) of each bf16 path, for `lm_times`."""
    from repro_torch import configs
    from repro_torch.models import transformer

    rg = configs.get("recurrentgemma-2b")
    params = transformer.init_params(rg, seed=0, device="cuda")
    print(f"[serve] recurrentgemma-2b: {rg.n_layers} layers "
          f"({transformer.layer_kinds(rg).count('attn')} attention), "
          f"d_model {rg.d_model}, {transformer.param_count(params) / 1e9:.3f}"
          f" B parameters in {rg.dtype}, random from seed 0")
    counts, params32 = serve_lm_both("recurrentgemma-2b", rg, params,
                                     LM_REQUESTS, 0)
    ring_check(dataclasses.replace(rg, dtype="float32"), params32, where)
    del params32
    torch.cuda.empty_cache()

    sl = dataclasses.replace(configs.get("stablelm-3b"), n_layers=4)
    sl_params = transformer.init_params(sl, seed=0, device="cuda")
    more, _ = serve_lm_both("stablelm-3b (4 layers)", sl, sl_params, 4, 1)
    counts.update(more)
    return counts, [("recurrentgemma-2b bf16", rg, params),
                    ("stablelm-3b (4 layers) bf16", sl, sl_params)]


# ---------------------------------------------------------------------------
# Phase 7: the rest of the LM side (MoE, xLSTM, the embeds and tokens+image
# input modes)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def routing_log():
    """Record each MoE call's routing (its sorted top-k expert ids per
    token, (tokens, k), on the CPU) into the list yielded."""
    from repro_torch.models import layers, transformer

    log, plain = [], transformer.moe_forward

    def logged(p, x, cfg, return_aux=False):
        _, _, idx = layers.moe_route(p, x, cfg.top_k)
        log.append(torch.sort(idx, dim=-1).values.reshape(-1, cfg.top_k)
                   .cpu())
        return plain(p, x, cfg, return_aux)

    transformer.moe_forward = logged
    try:
        yield log
    finally:
        transformer.moe_forward = plain


def moe_twin(name: str, cfg, params, twin_params, done, rel: float) -> None:
    """An MoE path's CPU twin: the server's own calls (each request's
    prefill, then decode steps fed the card's tokens; `replay`), where
    `forward` over a padded batch would route under another capacity
    than the server's per-request prefill and dropless decode.  The
    card's served logits are held against the twin's
    (`check_teacher_forced`), and the same calls replayed on the card
    give the (token, layer) routings whose expert sets differ from the
    twin's (near-ties of the router's probabilities that rounding
    flips), printed."""
    prompts = [{"tokens": np.asarray(r.prompt)[None]} for r in done]
    feed = np.array([r.generated for r in done])
    t0 = time.perf_counter()
    with routing_log() as cpu_log:
        _, want = replay(cfg, twin_params, prompts, feed.shape[1], LM_CACHE,
                         feed)
    t1 = time.perf_counter()
    with routing_log() as card_log:
        replay(cfg, params, prompts, feed.shape[1], LM_CACHE, feed)
    got = np.concatenate([np.stack(r.logits) for r in done])
    check_teacher_forced(f"{name} vs its CPU twin (the server's calls "
                         f"replayed in {t1 - t0:.1f} s)", got,
                         want.reshape(-1, want.shape[-1]), rel)
    check(len(card_log) == len(cpu_log), f"{name}: routing calls differ")
    differ = sum(int((a != b).any(-1).sum())
                 for a, b in zip(card_log, cpu_log))
    print(f"[serve] {name}: {differ} of {sum(len(a) for a in cpu_log)} "
          f"(token, layer) routings differ between the card and the CPU "
          f"twin (top {cfg.moe.top_k} of {cfg.moe.n_experts}; the server's "
          f"calls replayed on both, fed the card's tokens)")


def decode_check(name: str, cfg, params, batch: dict, cache_len: int,
                 rel: float) -> None:
    """One prompt on the card: prefill then DECODE_CHECK_NEW - 1 greedy
    decode steps through `steps` (`replay`), each step's logits against
    `forward` over the whole sequence on the card (an MoE at a dropless
    capacity, n_experts / top_k, where the two route alike)."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    t0 = time.perf_counter()
    toks, got = replay(cfg, params, [batch], DECODE_CHECK_NEW, cache_len)
    full = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    full["tokens"] = torch.cat([full["tokens"], torch.as_tensor(
        toks[:, :-1]).to(full["tokens"])], dim=1)
    p = steps.next_position(cfg, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    with torch.no_grad():
        want = transformer.forward(params, full, cfg)[
            :, p - 1:p - 1 + DECODE_CHECK_NEW, :cfg.vocab].float().cpu()
    torch.cuda.synchronize()
    want = want.numpy()
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"[decode] {name}: prefill of {p} positions (cache {cache_len}) "
          f"and {DECODE_CHECK_NEW - 1} decode steps against forward over "
          f"{p + DECODE_CHECK_NEW - 1} on the card: max|err| {err:.3e} "
          f"({err / scale:.2e} of the logit scale {scale:.3f}, bound "
          f"{rel:g}), argmax equal on {same}/{got.shape[0] * got.shape[1]} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(got.shape == want.shape and np.isfinite(got).all()
          and err <= rel * scale,
          f"{name}: decode disagrees with forward over the whole sequence")


def steps_per_s(name: str, cfg, params, where: str) -> None:
    """Decode tokens per second and prefill time per request of a drain
    of 8 requests at batch 4 (16 new tokens each, no logits kept); then
    under torch.profiler one decode step and one request's prefill, their
    device events and busy shares (a whole drain is 2,500-76,000
    launches, which the profiler takes long to sum)."""
    from repro_torch.launch import serve

    server = serve.SlotServer(cfg, params, LM_BATCH, LM_CACHE)
    serve.drain(server, serve.make_requests(cfg, 8, LM_PROMPT, 16, seed=3))
    print(f"[time] served {name} on {where}: batch {LM_BATCH}, 8 requests "
          f"of 16 new tokens: decode {server.decoded / server.decode_s:.1f} "
          f"tok/s ({server.steps} steps, "
          f"{1e3 * server.decode_s / server.steps:.2f} ms per step), "
          f"prefill {1e3 * float(np.mean(server.prefill_s)):.2f} ms per "
          f"request (prompts of 4-{LM_PROMPT} tokens; host wall, each "
          f"ending in a device sync)")
    rows = profile_run(f"{name}, one decode step", server.step, where,
                       f"one step at batch {LM_BATCH}")
    print(f"[profile] {name}: {sum(c for _, _, c in rows)} device events "
          f"(kernels and copies) a decode step")
    req = serve.make_requests(cfg, 1, LM_PROMPT, LM_MAX_NEW, seed=4)[0]
    profile_run(f"{name}, one prefill", lambda: server._prefill_one(0, req),
                where, f"one prefill of {len(req.prompt)} tokens")


def release() -> None:
    """Hand the card's cached blocks back after a model is dropped."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def moe_paths(where: str) -> dict:
    """OLMoE-1B-7B at full width and depth and Mixtral-8x7B at full width,
    MIXTRAL_LAYERS layers, each served in bf16 against its bf16 CPU twin
    (routings counted) and timed; then in float32 (OLMoE at full width,
    OLMOE_FP32_LAYERS layers, weights of their own) against the float32
    twin (the wiring check), and its decode against its forward
    (Mixtral's after a prompt past its window).  Returns each served
    path's launch counts."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.models.layers import cast_params, to_device

    counts = {}
    for arch, layers, layers32 in (
            ("olmoe-1b-7b", None, OLMOE_FP32_LAYERS),
            ("mixtral-8x7b", MIXTRAL_LAYERS, MIXTRAL_LAYERS)):
        cfg = configs.get(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        t0 = time.perf_counter()
        params = transformer.init_params(cfg, seed=0, device="cuda")
        twin = to_device(params, "cpu")
        name = arch + (f" ({layers} layers)" if layers else "")
        print(f"[serve] {name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.moe.n_experts} experts of "
              f"{cfg.moe.d_ff}, top {cfg.moe.top_k}, capacity "
              f"{cfg.moe.capacity_factor}; "
              f"{transformer.param_count(params) / 1e9:.3f} B parameters in "
              f"{cfg.dtype}, random from seed 0, and its CPU twin "
              f"({time.perf_counter() - t0:.1f} s)")
        out = serve_lm(f"{name} bf16", cfg, params, P7_REQUESTS, 7, [])
        counts[f"{name} bf16"] = out["counts"]
        moe_twin(f"{name} bf16", cfg, params, twin, out["done"],
                 LM_TWIN_REL[arch])
        del twin
        steps_per_s(f"{name} bf16", cfg, params, where)

        cfg32 = dataclasses.replace(cfg, n_layers=layers32, dtype="float32")
        if layers32 == cfg.n_layers:
            params32 = cast_params(params, torch.float32)
            del params
        else:
            del params
            release()
            params32 = transformer.init_params(cfg32, seed=0, device="cuda")
        name = f"{arch} ({layers32} layers) fp32"
        twin32 = to_device(params32, "cpu")
        out = serve_lm(name, cfg32, params32, P7_REQUESTS, 7, [])
        counts[name] = out["counts"]
        moe_twin(name, cfg32, params32, twin32, out["done"], LM_FP32_REL)
        del twin32
        if cfg.window:
            prompt = np.random.default_rng(8).integers(
                0, cfg.vocab, size=(1, MIXTRAL_RING_PROMPT))
            decode_check(f"{name}, a {MIXTRAL_RING_PROMPT}-token prompt, "
                         f"window {cfg.window}", cfg32, params32,
                         {"tokens": prompt}, MIXTRAL_RING_PROMPT + 16,
                         LM_FP32_REL)
        else:
            prompt = np.random.default_rng(8).integers(
                0, cfg.vocab, size=(1, LM_PROMPT))
            decode_check(name, cfg32, params32, {"tokens": prompt},
                         LM_CACHE, LM_FP32_REL)
        del params32
        release()
    return counts


def xlstm_path(where: str) -> dict:
    """xLSTM-1.3B at full width and depth served in bf16 (against the bf16
    CPU twin, the fp32 one the control) and in float32 (against the fp32
    twin; `serve_lm_both`), its decode against its forward in float32,
    timed.  Returns the launch counts (none of the port's kernels)."""
    from repro_torch import configs
    from repro_torch.models import transformer, xlstm

    cfg = configs.get("xlstm-1.3b")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    kinds = transformer.layer_kinds(cfg)
    _, h, dh = xlstm._dims(cfg)
    print(f"[serve] xlstm-1.3b: {cfg.n_layers} layers ({kinds.count('slstm')}"
          f" sLSTM, {kinds.count('mlstm')} mLSTM of {h} heads of {dh}: C "
          f"{4 * h * dh * dh / 2 ** 20:.0f} MiB a sequence a layer in "
          f"float32), {transformer.param_count(params) / 1e9:.3f} B "
          f"parameters in {cfg.dtype}, random from seed 0")
    counts, params32 = serve_lm_both("xlstm-1.3b", cfg, params, P7_REQUESTS,
                                     9)
    prompt = np.random.default_rng(10).integers(0, cfg.vocab,
                                                size=(1, LM_PROMPT))
    decode_check("xlstm-1.3b fp32", dataclasses.replace(cfg, dtype="float32"),
                 params32, {"tokens": prompt}, LM_CACHE,
                 DECODE_REL["xlstm-1.3b"])
    del params32
    release()
    steps_per_s("xlstm-1.3b bf16", cfg, params, where)
    del params
    release()
    return counts


def hubert_path(where: str) -> dict:
    """HuBERT-XLarge at full width, HUBERT_LAYERS layers: `forward` (through
    `make_forward_step`) on HUBERT_CLIPS clips of HUBERT_FRAMES frames
    drawn from numpy (seed 11), in bf16 against the bf16 CPU twin (the
    fp32 one the control) and in float32 against the fp32 twin; launch
    counts; the forward's time and its profile."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.models.layers import cast_params, to_device

    cfg = dataclasses.replace(configs.get("hubert-xlarge"),
                              n_layers=HUBERT_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    print(f"[serve] hubert-xlarge: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, non-causal, {transformer.param_count(params) / 1e9:.3f}"
          f" B parameters in {cfg.dtype}, random from seed 0")
    emb = np.random.default_rng(11).standard_normal(
        (HUBERT_CLIPS, HUBERT_FRAMES, cfg.d_model)).astype(np.float32)
    counts = {}
    twin32 = to_device(cast_params(params, torch.float32), "cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        want32 = transformer.forward(twin32, {"embeds": torch.from_numpy(emb)},
                                     cfg32)[..., :cfg.vocab].numpy()
    print(f"[serve] hubert-xlarge: the fp32 CPU twin's forward in "
          f"{time.perf_counter() - t0:.1f} s")
    del twin32
    batch = {"embeds": torch.from_numpy(emb).cuda()}
    for label in ("bf16", "fp32"):
        c, p = (cfg, params) if label == "bf16" else (
            cfg32, cast_params(params, torch.float32))
        fwd = steps.make_forward_step(c)
        ops.reset_launches()
        with torch.no_grad():
            got = fwd(p, batch)
        torch.cuda.synchronize()
        counts[f"hubert-xlarge {label}"] = dict(ops.LAUNCHES)
        want = expected_lm_launches(c, 1, 0)
        print(f"[serve] hubert-xlarge {label}: forward on {HUBERT_CLIPS} x "
              f"{HUBERT_FRAMES} frames, logits {tuple(got.shape)}; launches "
              f"{dict(ops.LAUNCHES)}")
        check(dict(ops.LAUNCHES) == want,
              f"hubert-xlarge {label}: launch counts {dict(ops.LAUNCHES)}, "
              f"expected {want}")
        got = got[..., :cfg.vocab].float().cpu().numpy()
        check(got.shape == (HUBERT_CLIPS, HUBERT_FRAMES, cfg.vocab),
              "hubert-xlarge: logits of the wrong shape")
        twins = [("the fp32 CPU twin", want32, LM_FP32_REL)]
        if label == "bf16":
            twin16 = to_device(params, "cpu")
            t0 = time.perf_counter()
            with torch.no_grad():
                want16 = transformer.forward(
                    twin16, {"embeds": torch.from_numpy(emb)},
                    cfg)[..., :cfg.vocab].float().numpy()
            print(f"[serve] hubert-xlarge: the bf16 CPU twin's forward in "
                  f"{time.perf_counter() - t0:.1f} s")
            del twin16
            twins = [("the bf16 CPU twin", want16,
                      LM_TWIN_REL["hubert-xlarge"]),
                     ("the fp32 CPU twin (control)", want32, LM_CONTROL_REL)]
        for tlabel, want, rel in twins:
            check_teacher_forced(f"hubert-xlarge {label} vs {tlabel}",
                                 got.reshape(-1, cfg.vocab),
                                 want.reshape(-1, cfg.vocab), rel)
        if label == "bf16":
            def run():
                with torch.no_grad():
                    return fwd(params, batch)
            ms = time_ms(run, 5, 2)
            profile_run("hubert-xlarge bf16 forward", run, where,
                        f"one forward of {HUBERT_CLIPS} x {HUBERT_FRAMES} "
                        f"frames")
            print(f"[time] hubert-xlarge bf16 forward on {where}: "
                  f"{ms:.2f} ms for {HUBERT_CLIPS} x {HUBERT_FRAMES} frames "
                  f"({HUBERT_CLIPS * HUBERT_FRAMES / ms * 1e3:.0f} frames/s; "
                  f"CUDA events over 5 calls)")
        del p
    del params
    release()
    return counts


def internvl2_path(where: str) -> dict:
    """InternVL2-26B at full width, IVL_LAYERS layers, through `steps`:
    one prefill of IVL_BATCH sequences of IVL_IMAGE patch embeddings
    (numpy, seed 12) ahead of IVL_PROMPT text tokens, then IVL_NEW - 1
    greedy decode steps (positions from IVL_IMAGE + IVL_PROMPT) in bf16,
    and the same calls in float32 fed the bf16 path's tokens; each against
    the CPU twins replaying those calls (bf16 against the bf16 twin, the
    fp32 one the control; float32 against the fp32 twin); launch counts;
    the float32 decode against its forward; prefill and decode times."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.layers import cast_params, to_device

    cfg = dataclasses.replace(configs.get("internvl2-26b"),
                              n_layers=IVL_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    name = f"internvl2-26b ({IVL_LAYERS} layers)"
    print(f"[serve] {name}: d_model {cfg.d_model}, GQA {cfg.n_heads} / "
          f"{cfg.n_kv_heads} of {cfg.hd}, {transformer.param_count(params) / 1e9:.3f}"
          f" B parameters in {cfg.dtype}, random from seed 0")
    rng = np.random.default_rng(12)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(IVL_BATCH,
                                                       IVL_PROMPT)),
             "patch_embeds": rng.standard_normal(
                 (IVL_BATCH, IVL_IMAGE, cfg.d_model)).astype(np.float32)}
    counts, runs = {}, {}
    # The bf16 path greedy; the float32 path fed the bf16 path's tokens,
    # so that one float32 CPU replay is both paths' twin.
    for label in ("bf16", "fp32"):
        c, p = (cfg, params) if label == "bf16" else (
            cfg32, cast_params(params, torch.float32))
        ops.reset_launches()
        toks, got = replay(c, p, [batch], IVL_NEW, IVL_CACHE,
                           feed=runs["bf16"][0] if runs else None)
        torch.cuda.synchronize()
        runs[label] = (toks, got)
        counts[f"{name} {label}"] = dict(ops.LAUNCHES)
        want = expected_lm_launches(c, 1, IVL_NEW - 1)
        print(f"[serve] {name} {label}: prefill of {IVL_BATCH} x "
              f"({IVL_IMAGE} image + {IVL_PROMPT} text), {IVL_NEW - 1} "
              f"decode steps; launches {dict(ops.LAUNCHES)}")
        check(dict(ops.LAUNCHES) == want,
              f"{name} {label}: launch counts {dict(ops.LAUNCHES)}, "
              f"expected {want}")
        if label == "fp32":
            decode_check(f"{name} fp32", c, p, batch, IVL_CACHE,
                         LM_FP32_REL)
            del p
            continue
        run = lambda: replay(c, p, [batch], IVL_NEW, IVL_CACHE)
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        profile_run(f"{name} bf16", run, where,
                    f"a prefill of {IVL_BATCH} x {IVL_IMAGE + IVL_PROMPT} "
                    f"positions and {IVL_NEW - 1} decode steps")
        print(f"[time] {name} bf16 on {where}: a prefill of {IVL_BATCH} x "
              f"{IVL_IMAGE + IVL_PROMPT} positions and {IVL_NEW - 1} decode "
              f"steps in {1e3 * wall:.1f} ms (host wall, ending in a device "
              f"sync)")
    toks = runs["bf16"][0]
    for tlabel, tc, tp, checks in (
            ("the bf16 CPU twin", cfg, to_device(params, "cpu"),
             (("bf16", LM_TWIN_REL["internvl2-26b"]),)),
            ("the fp32 CPU twin", cfg32,
             to_device(cast_params(params, torch.float32), "cpu"),
             (("bf16", LM_CONTROL_REL), ("fp32", LM_FP32_REL)))):
        t0 = time.perf_counter()
        _, want = replay(tc, tp, [batch], IVL_NEW, IVL_CACHE, feed=toks)
        del tp
        for label, rel in checks:
            got = runs[label][1]
            check_teacher_forced(
                f"{name} {label} vs {tlabel}"
                + (" (control)" if (label, tc) == ("bf16", cfg32) else "")
                + f" (replayed in {time.perf_counter() - t0:.1f} s)",
                got.reshape(-1, got.shape[-1]),
                want.reshape(-1, got.shape[-1]), rel)
    del params
    release()
    return counts


def lm_rest_phase(where: str, t_start: float) -> dict:
    """Phase 7: every path above, each model freed before the next.
    Returns the launch counts of every path."""
    counts = {}
    for path in (moe_paths, xlstm_path, hubert_path, internvl2_path):
        t0 = time.perf_counter()
        counts.update(path(where))
        print(f"[phase] {path.__name__} in {time.perf_counter() - t0:.1f} s")
    print(f"[phase] the rest of the LM side served at "
          f"{time.perf_counter() - t_start:.0f} s")
    return counts


# ---------------------------------------------------------------------------
# The training slice: the gradient path of kernels 9, 6 and 11 (phase 2)
# and phase 8
# ---------------------------------------------------------------------------


def grad_kernel_phase(records: dict) -> None:
    """Kernels 9, 6 and 11 on their gradient path at the training paths'
    shapes: forward through the kernel, backward through the wrapper
    (`ops._KernelGrad`, the plain version's autograd), every input's
    gradient against `torch.autograd.grad` of the plain version on the
    same inputs and cotangent; forward + backward recorded (timed in the
    timing phase) beside the plain version's and the library
    yardstick's: Danube-1.8B's attention (batch 8 of 256 tokens, 32
    query heads over 8 KV heads of 80, causal, window 4,096) and gated
    SiLU MLP (2,048 rows, D 2,560, M 6,912) in bf16 (phase 8a), and
    RecurrentGemma-2B's attention (batch 2 of 128, 10 heads over 1 of
    256, window 2,048) and RG-LRU scan (B 2, T 128, W 2,560) in fp32
    (phase 8c)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(26)
    bf, f32 = torch.bfloat16, torch.float32

    def grads_of(out_fn, inputs, ct):
        return lambda: torch.autograd.grad(out_fn(*inputs), inputs, ct)

    cases = []
    for tag, b, hq, hkv, dh, n, window, dtype in (
            ("h2o-danube-1.8b train", 8, 32, 8, 80, 256, 4096, bf),
            ("recurrentgemma-2b train", 2, 10, 1, 256, 128, 2048, f32)):
        q = rand(g, (b, hq, n, dh), dtype).requires_grad_()
        k, v = (rand(g, (b, hkv, n, dh), dtype).requires_grad_()
                for _ in range(2))
        kw = dict(causal=True, window=window)
        pairs, _ = visible_pairs(n, n, True, window)
        cases.append((
            "flash_attention",
            f"{tag} B {b}, Hq {hq} / Hkv {hkv}, Dh {dh}, N {n} "
            f"{dname(dtype)}",
            lambda q, k, v, kw=kw: ops.attention(q, k, v, **kw),
            lambda q, k, v, kw=kw: ref.attention_ref(q, k, v, **kw),
            lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
            (q, k, v),
            # forward 2 products, backward 5, of 2 * pairs * hq * dh each
            bound(nbytes=4 * nbytes(q) + 4 * nbytes(k),
                  **flops_at(dtype, 14 * pairs * b * hq * dh))))
    n, d, m = TRAIN_BATCH * TRAIN_SEQ, 2560, 6912
    x = rand(g, (n, d), bf).requires_grad_()
    w1, wg = (rand(g, (d, m), bf, d ** -0.5).requires_grad_()
              for _ in range(2))
    w2 = rand(g, (m, d), bf, m ** -0.5).requires_grad_()
    cases.append((
        "fused_mlp", f"h2o-danube-1.8b train gated silu N {n} D {d} M {m} "
                     f"bf16",
        lambda x, w1, w2, wg: ops.mlp(x, w1, w2, w_gate=wg,
                                      activation="silu"),
        lambda x, w1, w2, wg: ref.fused_mlp_ref(
            x, w1, None, w2, None, activation="silu", w_gate=wg),
        lambda x, w1, w2, wg: (F.silu(x @ wg) * (x @ w1)) @ w2,
        (x, w1, w2, wg),
        # forward 3 products of 2nmd, backward 6
        bound(nbytes=2 * nbytes(x, w1, wg, w2) + 2 * nbytes(x),
              **flops_at(bf, 18 * n * m * d))))
    a = (0.5 + 0.499 * torch.rand((2, 128, 2560), generator=g,
                                  device="cuda")).requires_grad_()
    bb = rand(g, (2, 128, 2560), f32).requires_grad_()
    cases.append((
        "rglru_scan", "recurrentgemma-2b train B 2, T 128, W 2560 fp32",
        ops.linear_recurrence, ref.linear_recurrence_ref, None, (a, bb),
        bound(nbytes=6 * nbytes(a), flops_f32=6 * a.numel())))

    for kname, tag, fn, plain, library, inputs, bnd in cases:
        before = ops.LAUNCHES[kname]
        out = fn(*inputs)
        check(ops.LAUNCHES[kname] == before + 1
              and type(out.grad_fn).__name__ == "_KernelGradBackward",
              f"{kname}: the gradient path did not launch the kernel "
              f"through ops._KernelGrad")
        want = plain(*inputs)
        err = check_lm(f"{kname} {tag} forward", out.detach(), want.detach())
        ct = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
        got = torch.autograd.grad(out, inputs, ct)
        exp = torch.autograd.grad(want, inputs, ct)
        same = all(torch.equal(x, y) for x, y in zip(got, exp))
        for i, (x, y) in enumerate(zip(got, exp)):
            check_lm(f"{kname} {tag} grad of input {i}", x, y)
        print(f"[check] {kname} {tag}: the gradients of its "
              f"{len(inputs)} inputs equal the plain version's bit for "
              f"bit: {same}")
        add_record(records, kname, f"{tag} forward + backward", err,
                   grads_of(fn, inputs, ct), grads_of(plain, inputs, ct),
                   grads_of(library, inputs, ct) if library else None, bnd)
    torch.cuda.synchronize()


def launch_delta(fn):
    """(fn(), the kernel launches it made by `ops.LAUNCHES`)."""
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in ops.launch_counts().items()}


def card_batch(batch: dict, device="cuda") -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_danube(where: str) -> dict:
    """8a: Danube-1.8B at full width and depth in bf16, TRAIN_STEPS steps
    of `make_train_step` on batches of TRAIN_BATCH x TRAIN_SEQ tokens
    (`SyntheticLM`, seed 0).  Returns the steps' launches."""
    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import linear_warmup_cosine

    cfg = configs.get("h2o-danube-1.8b")
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(cfg, seed=0, device="cuda")
    data = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [card_batch(data.batch_at(i)) for i in range(TRAIN_STEPS + 1)]
    # Every parameter leaf gets a finite gradient that is not all zero.
    _, _, grads = steps.loss_and_grads(params, batches[0], cfg)
    leaves = tree_lib.leaves_with_path(grads)
    bad = [tree_lib.path_key(path) for path, gr in leaves
           if not bool(torch.isfinite(gr).all()) or not bool(gr.any())]
    print(f"[train] h2o-danube-1.8b: {len(leaves)} parameter leaves "
          f"({transformer.param_count(params) / 1e9:.3f}B params, "
          f"{cfg.param_dtype}), {len(leaves) - len(bad)} with a finite, "
          f"non-zero gradient")
    check(not bad, f"h2o-danube-1.8b: leaves without a finite non-zero "
                   f"gradient: {bad[:8]}")
    del grads, leaves
    step_fn = steps.make_train_step(
        cfg, lr_fn=linear_warmup_cosine(1e-3, 2, TRAIN_STEPS))
    state = steps.init_opt_state(params)

    def run():
        nonlocal params, state
        hist, ms = [], []
        for i in range(TRAIN_STEPS):
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            params, state, m = step_fn(params, state, batches[i], i)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            hist.append({k: float(v) for k, v in m.items()})
        return hist, ms

    (hist, ms), counts = launch_delta(run)
    want = expected_lm_launches(cfg, TRAIN_STEPS, 0)
    print(f"[train] h2o-danube-1.8b on {where}: {TRAIN_STEPS} steps, loss "
          + " ".join(f"{h['loss']:.4f}" for h in hist) + "; grad_norm "
          + " ".join(f"{h['grad_norm']:.3f}" for h in hist) + "; lr "
          + " ".join(f"{h['lr']:.2e}" for h in hist))
    print(f"[train] h2o-danube-1.8b launches over the {TRAIN_STEPS} steps: "
          f"{ {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in want.items() if v} })")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in hist), "h2o-danube-1.8b: a loss or grad_norm is not "
                              "finite")
    check(counts == want and counts["flash_attention"] == 24 * TRAIN_STEPS
          and counts["fused_mlp"] == 24 * TRAIN_STEPS,
          "h2o-danube-1.8b: the steps' launches differ from "
          "expected_lm_launches")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = float(np.mean(ms[1:]))
    flops = steps.model_flops(cfg, params, "train", tokens)
    bound_ms = flops / BF16_FLOP_PER_S * 1e3
    print(f"[time] trained h2o-danube-1.8b on {where}: step "
          f"{steady:.1f} ms (mean of steps 2-{TRAIN_STEPS}; the first "
          f"{ms[0]:.1f} ms; CUDA events), {tokens / steady * 1e3:.0f} "
          f"tokens/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; model "
          f"FLOPs {flops / 1e12:.2f} T a step (6 x active params x "
          f"tokens) over the bf16 peak {bound_ms:.2f} ms = "
          f"{100 * bound_ms / steady:.2f}% of the step")
    profile_run("h2o-danube-1.8b", lambda: step_fn(
        params, state, batches[TRAIN_STEPS], TRAIN_STEPS), where,
        "one train step", label="trained")
    del params, state, batches
    release()
    return counts


def close_leaves(what: str, got, want, rel: float, worst: dict,
                 spread=None) -> None:
    """Every leaf of ``got`` (card) against ``want`` (the CPU twin's), on
    the card: within ``rel`` of the leaf's scale, plus, where a
    ``spread`` tree is given, twice its element.  The largest ratio of
    error to bound goes into ``worst[what]``."""
    from repro_torch import tree as tree_lib

    for path, leaf in tree_lib.leaves_with_path(got):
        w = tree_lib.at(want, path).to(leaf.device).float()
        lim = rel * float(w.abs().max()) + 1e-30
        if spread is not None:
            lim = lim + 2 * tree_lib.at(spread, path).to(leaf.device)
        ratio = float(((leaf.float() - w).abs() / lim).max())
        worst[what] = max(worst.get(what, 0.0), ratio)
        check(ratio <= 1.0, f"{what} {tree_lib.path_key(path)}: the card "
                            f"parts from its CPU twin ({ratio:.2f} of the "
                            f"bound)")


def nest(path, leaf) -> dict:
    """``leaf`` in a tree of dicts along ``path`` (list indices as keys):
    a one-leaf tree the optimizer sees at the leaf's own path."""
    for k in reversed(path):
        leaf = {k: leaf}
    return leaf


def shadow_step(g_twin, prior: dict, lr, rel: float, keep: bool):
    """AdamW (`optim.adamw_update`, one leaf at a time on the card) on the
    twin's gradients moved up (+1) and down (-1) by ``rel`` of each
    leaf's scale, from ``prior`` (+1 / -1 -> (params, m, v, count)
    trees, the first step's the twin's own on the host).  Each leaf is
    clipped by its moved tree's global norm first, as
    `clip_by_global_norm` does, so the one-leaf calls run with no clip of
    their own.  One leaf at a time keeps the card's memory to a leaf's
    state (RecurrentGemma-2B's float32 trees are 19 GB).  Returns (the
    |param_up - param_down| tree, and the new priors where ``keep``),
    on the card."""
    from repro_torch import tree as tree_lib
    from repro_torch.optim import AdamWConfig, adamw_update

    opt = AdamWConfig()
    unclipped = dataclasses.replace(opt, grad_clip=float("inf"))
    taus = tree_lib.tree_map(lambda a: rel * float(a.abs().max()), g_twin)
    scale = {}
    for s in (1, -1):
        sq = sum(float(torch.sum(torch.square(a.to("cuda") + s * t)))
                 for a, t in zip(tree_lib.leaves(g_twin),
                                 tree_lib.leaves(taus)))
        scale[s] = min(1.0, opt.grad_clip / max(sq ** 0.5, 1e-9))
    spread, new = {}, {s: [] for s in (1, -1)}
    for path, g in tree_lib.leaves_with_path(g_twin):
        p_new, on_card = {}, {}
        for s in (1, -1):
            p, m, v, count = prior[s]
            for t in (p, m, v):          # one copy where the priors share
                if id(t) not in on_card:
                    on_card[id(t)] = tree_lib.at(t, path).to("cuda")
            moved = (g.to("cuda") + s * tree_lib.at(taus, path)) * scale[s]
            out_p, st, _ = adamw_update(
                nest(path, moved),
                {"m": nest(path, on_card[id(m)]),
                 "v": nest(path, on_card[id(v)]), "count": count},
                nest(path, on_card[id(p)]), lr, unclipped)
            p_new[s] = tree_lib.at(out_p, path)
            if keep:
                new[s].append((p_new[s], tree_lib.at(st["m"], path),
                               tree_lib.at(st["v"], path)))
        spread[path] = (p_new[1] - p_new[-1]).abs()
    like = prior[1][0]
    spread = tree_lib.map_with_path(lambda path, _: spread[path], like)
    if not keep:
        return spread, None
    return spread, {s: (*(tree_lib.unflatten(like, [x[k] for x in new[s]])
                          for k in range(3)),
                        prior[s][3] + 1) for s in (1, -1)}


def train_twin(name: str, cfg, n_steps: int, where: str):
    """8b / 8c: ``n_steps`` steps of ``cfg`` (float32) on the card against
    its CPU twin (the same weights, drawn on the card and copied; the
    same `SyntheticLM` batches of TWIN_BATCH x TWIN_SEQ, seed 1); the
    twin replays each step with the plain versions: the loss, every
    metric and, at the same (the twin's) params, every gradient leaf
    within LM_FP32_REL of the leaf's scale; both moments within that (v
    twice that); the updated params within that plus twice the spread of
    two shadow steps on the twin's gradients moved up and down by their
    tolerance (`shadow_step`: AdamW's step is ill-conditioned where a
    gradient is near 0).  Returns (the card steps' launches, the loss
    history)."""
    from repro_torch import tree as tree_lib
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.models.layers import to_device
    from repro_torch.optim import linear_warmup_cosine

    rel = LM_FP32_REL
    params = transformer.init_params(cfg, seed=0, device="cuda")
    twin = to_device(params, "cpu")
    data = SyntheticLM(cfg.vocab, TWIN_SEQ, TWIN_BATCH, seed=1,
                       n_image_tokens=cfg.n_image_tokens,
                       d_model=cfg.d_model, input_mode=cfg.input_mode)
    lr_fn = linear_warmup_cosine(1e-3, 0, n_steps)
    step_fn = steps.make_train_step(cfg, lr_fn=lr_fn)
    state, twin_state = steps.init_opt_state(params), \
        steps.init_opt_state(twin)
    adam = twin_state["adam"]
    shadows = {s: (twin, adam["m"], adam["v"], adam["count"])
               for s in (1, -1)}
    counts = {k[0]: 0 for k in KERNELS}
    worst, hist, took = {}, [], {"twin": 0.0, "card": 0.0, "checks": 0.0}
    t_all = time.perf_counter()
    for i in range(n_steps):
        batch = data.batch_at(i)
        cb, tb = card_batch(batch), card_batch(batch, "cpu")
        lr = lr_fn(i)
        t0 = time.perf_counter()
        loss, metrics, g_twin = steps.loss_and_grads(twin, tb, cfg)
        took["twin"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        _, _, g_card = steps.loss_and_grads(to_device(twin, "cuda"), cb, cfg)
        close_leaves("gradient", g_card, g_twin, rel, worst)
        del g_card
        took["checks"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        (params, state, m), c = launch_delta(
            lambda: step_fn(params, state, cb, i))
        took["card"] += time.perf_counter() - t0
        for k, v in c.items():
            counts[k] += v
        t0 = time.perf_counter()
        spread, shadows = shadow_step(g_twin, shadows, lr, rel,
                                      keep=i + 1 < n_steps)
        took["checks"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        twin, twin_state, om = steps.apply_grads(g_twin, twin, twin_state,
                                                 lr)
        del g_twin
        took["twin"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        tm = dict(metrics, **om, lr=lr)
        check(sorted(m) == sorted(tm), f"{name}: metrics {sorted(m)} "
                                       f"against {sorted(tm)}")
        for k in tm:
            close_leaves(f"metric {k}", {k: m[k]}, {k: tm[k]}, rel, worst)
        hist.append(float(m["loss"]))
        close_leaves("param", params, twin, rel, worst, spread)
        del spread
        for k in ("m", "v"):
            close_leaves(k, state["adam"][k], twin_state["adam"][k],
                         rel if k == "m" else 2 * rel, worst)
        took["checks"] += time.perf_counter() - t0
    print(f"[train] {name} float32 on {where}: {n_steps} steps against its "
          f"CPU twin in {time.perf_counter() - t_all:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in took.items())
          + "), losses " + " ".join(f"{x:.5f}" for x in hist)
          + "; the largest error over its bound (LM_FP32_REL "
          f"{rel:g} of each leaf's scale, v twice, the params plus twice "
          f"the shadow spread): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(worst.items()))
          + f"; launches {({k: v for k, v in counts.items() if v})}")
    del params, state, twin, twin_state
    release()
    return counts, hist


def train_phase(where: str, t_start: float) -> dict:
    """Phase 8 (module docstring).  Returns the launches of its main
    paths."""
    from repro_torch import configs
    from repro_torch.launch import train as train_cli

    totals = {k[0]: 0 for k in KERNELS}

    def add(c):
        for k, v in c.items():
            totals[k] += v

    t0 = time.perf_counter()
    add(train_danube(where))
    print(f"[phase] 8a Danube-1.8B trained in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    danube2 = dataclasses.replace(configs.get("h2o-danube-1.8b"),
                                  n_layers=TWIN_LAYERS, dtype="float32")
    hists = {}
    for reduce in (False, True):
        cfg = dataclasses.replace(danube2, bf16_reduce=reduce)
        c, hists[reduce] = train_twin(
            f"h2o-danube-1.8b {TWIN_LAYERS} layers"
            f"{', bf16_reduce (rms_mp)' if reduce else ''}", cfg,
            TWIN_STEPS, where)
        check(c == expected_lm_launches(cfg, TWIN_STEPS, 0),
              f"Danube {TWIN_LAYERS} layers: launches {c}")
        add(c)
    gap = max(abs(a - b) / abs(b) for a, b in zip(hists[True],
                                                  hists[False]))
    print(f"[train] the rms_mp run's losses against the rms run's: "
          f"{gap:.2e} (bound {LM_FP32_REL:g})")
    check(gap <= LM_FP32_REL, "the bf16_reduce (rms_mp) run parts from "
                              "the rms run in float32")
    print(f"[phase] 8b Danube {TWIN_LAYERS} layers against its twins in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rg = dataclasses.replace(configs.get("recurrentgemma-2b"),
                             pattern=("rec", "rec", "attn"), n_layers=3,
                             dtype="float32")
    c, _ = train_twin("recurrentgemma-2b 3 layers", rg, 1, where)
    check(c == expected_lm_launches(rg, 1, 0) and c["rglru_scan"] == 2,
          f"recurrentgemma-2b 3 layers: launches {c}")
    add(c)
    print(f"[phase] 8c RecurrentGemma-2B 3 layers against its twin in "
          f"{time.perf_counter() - t0:.1f} s")
    # 8d: the CLI on the card, straight and killed and resumed.
    t0 = time.perf_counter()
    common = ["--arch", "h2o-danube-1.8b", "--reduced", "--batch", "2",
              "--seq", "16", "--log-every", "1", "--lr", "1e-3"]

    def straight_and_resumed(ck):
        full = train_cli.main(common + ["--steps", "8"])
        train_cli.main(common + ["--steps", "4", "--ckpt-dir", ck,
                                 "--ckpt-every", "100"])
        return full, train_cli.main(common + ["--steps", "8", "--ckpt-dir",
                                              ck, "--resume"])

    with tempfile.TemporaryDirectory() as ck:
        (full, resumed), c = launch_delta(lambda: straight_and_resumed(ck))
    add(c)
    gap = abs(full[-1]["loss"] - resumed[-1]["loss"])
    print(f"[train] launch.train on {where}: 8 steps straight, last loss "
          f"{full[-1]['loss']:.6f}; 4 steps, a checkpoint and --resume to "
          f"8: {resumed[-1]['loss']:.6f} (|diff| {gap:.2e}, bound 1e-4; "
          f"resumed at step {resumed[0]['step']})")
    check(full[-1]["step"] == resumed[-1]["step"] == 7
          and resumed[0]["step"] == 4 and gap < 1e-4,
          "launch.train: the resumed run does not replay the straight one")
    print(f"[phase] 8d launch.train resume in "
          f"{time.perf_counter() - t0:.1f} s; training done at "
          f"{time.perf_counter() - t_start:.0f} s")
    return totals


# The GPipe check of phase 6: one Danube-1.8B block a stage at full width
# in bf16, PIPE_MICRO microbatches of PIPE_BATCH x PIPE_SEQ tokens.
PIPE_MICRO, PIPE_BATCH, PIPE_SEQ = 4, 2, 256


def pipe_rank(mesh, seed: int):
    """On every rank of ``mesh`` (1-D, along data): its Danube block
    (seed + stage) through `pipeline_apply`; rank 0 also runs the stages
    one after another on the same microbatches.  Returns (ms of the
    pipeline on this rank, and on rank 0 the max|err| against the
    sequential stages and their scale)."""
    from repro_torch import configs
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.models import transformer

    if mesh.rank is None:
        return None
    cfg = configs.get("h2o-danube-1.8b")

    def block(i):
        one = dataclasses.replace(cfg, n_layers=1)
        return transformer.init_params(one, seed + i, mesh.device)[
            "layers"][0]

    def stage(p, x):
        return transformer._block_forward("attn", p, x, cfg)

    g = torch.Generator(device=mesh.device).manual_seed(seed)
    mbs = (torch.randn((PIPE_MICRO, PIPE_BATCH, PIPE_SEQ, cfg.d_model),
                       generator=g, device=mesh.device)).to(torch.bfloat16)
    with torch.no_grad():
        mine = block(mesh.coord("data"))
        pipeline_apply(stage, mine, mbs, mesh)          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline_apply(stage, mine, mbs, mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if mesh.rank != 0:
            return ms, None
        ref = mbs
        for i in range(mesh.data):
            p = block(i)
            ref = torch.stack([stage(p, x) for x in ref])
        err = float((out.float() - ref.float()).abs().max())
        return ms, (err, float(ref.float().abs().max()),
                    bool(torch.equal(out, ref)))


def mesh_pipeline(where: str) -> None:
    """Phase 6d: `pipeline_apply` over every rank of the world (one stage
    a rank, gloo through the host on one card) against the sequential
    stages on rank 0."""
    from repro_torch.distributed.pipeline import bubble_fraction
    from repro_torch.launch import mesh as mesh_lib

    world = mesh_lib.current_world()
    mesh = mesh_lib.make_vision_mesh(world.size, 1, "cuda")
    res = mesh_lib.per_rank(mesh, pipe_rank, mesh, 7)
    err, scale, same = res[0][1]
    bubble = bubble_fraction(world.size, PIPE_MICRO)
    print(f"[mesh] GPipe over {world.size} ranks ({world.backend}) on "
          f"{where}: one h2o-danube-1.8b block a stage, bf16, "
          f"{PIPE_MICRO} microbatches of {PIPE_BATCH} x {PIPE_SEQ}: "
          f"{', '.join(f'{r[0]:.1f}' for r in res)} ms by rank (host wall, "
          f"activations through the host), bubble fraction {bubble:.3f}; "
          f"against the sequential stages max|err| {err:.3e} (scale "
          f"{scale:.3f}), bit for bit: {same}")
    check(err <= LM_TOL[torch.bfloat16] * scale,
          "GPipe parts from the sequential stages")


# ---------------------------------------------------------------------------
# Phase 6: the mesh on the card
# ---------------------------------------------------------------------------


def rank_kernel_checks(mesh) -> dict:
    """On every rank of a (1, 3) mesh: kernels 1-6 at this rank's local
    DeiT-T shapes (1 of 3 heads, concat 64, 256 of 768 MLP columns, batch
    8), each against its plain version on the same shards (the layers
    with their all-reduces over the model group): {kernel: (max|err|,
    scale)}."""
    from repro_torch.core.quant import amax_scale, quantize
    from repro_torch.kernels import ops, ref

    b, n, d, h, dh, m = B_MAIN, 197, 192, 3, 64, 768
    c, dev, axis = mesh.coord("model"), mesh.device, mesh.model_group
    g = torch.Generator().manual_seed(11)

    def r(*shape, s=0.05):
        return torch.randn(shape, generator=g) * s

    x = r(b, n, d, s=1.0)
    wq, wk, wv, w_msa = r(h, d, dh), r(h, d, dh), r(h, d, dh), r(h * dh, d)
    ln = [1.0 + r(d), r(d), 1.0 + r(d), r(d)]
    w_up, b_up, w_down, b_down = r(d, m), r(m), r(m, d), r(d)
    heads, rows = slice(c, c + 1), slice(c * dh, (c + 1) * dh)
    cols = slice(c * m // 3, (c + 1) * m // 3)

    def on(*ts):
        return [t.contiguous().to(dev) for t in ts]
    # Whole-matrix int8 quantisation, then this rank's slices: the
    # per-head and up scales split with their columns, the concat and
    # down scales (per output channel of the full width) replicate.
    q = {k: quantize(w, amax_scale(w, dim=(1,)))
         for k, w in (("wq", wq), ("wk", wk), ("wv", wv))}
    q.update({k: quantize(w, amax_scale(w, dim=(0,)))
              for k, w in (("w_msa", w_msa), ("w_up", w_up),
                           ("w_down", w_down))})
    xl, = on(x)
    f_args = on(wq[heads], wk[heads], wv[heads], w_msa[rows], *ln,
                w_up[:, cols], b_up[cols], w_down[cols], b_down)
    acts = torch.tensor([0.03, 0.05, 0.04, 0.02], device=dev)
    i_args = on(q["wq"].values[heads], q["wk"].values[heads],
                q["wv"].values[heads], q["w_msa"].values[rows],
                q["w_up"].values[:, cols], q["w_down"].values[cols]) \
        + [acts] + on(*(q[k].scale[heads].reshape(1, dh)
                        for k in ("wq", "wk", "wv")),
                      q["w_msa"].scale.reshape(d),
                      q["w_up"].scale.reshape(m)[cols],
                      q["w_down"].scale.reshape(d), *ln, b_up[cols], b_down)
    axes = {"msa_axis": axis, "mlp_axis": axis}
    out = {}

    def rec(name, got, want):
        torch.cuda.synchronize()
        out[name] = (float((got.float() - want.float()).abs().max()),
                     float(want.float().abs().max()))
    with torch.no_grad():          # gloo writes all-reduce results back
        rec("vita_layer", ops.vita_layer_fused(xl, *f_args, **axes),
            ref.vita_layer_ref(xl, *f_args, **axes))
        rec("vita_layer_int8", ops.vita_layer_int8(xl, *i_args, **axes),
            ref.vita_layer_int8_ref(xl, *i_args, **axes))
        z = ref.layer_norm_ref(xl, f_args[4], f_args[5])
        zq = ref.quant(z, acts[0])
        m_args = (zq, *i_args[:3], acts[0], *i_args[7:10])
        rec("vita_msa_int8", ops.vita_msa_int8(*m_args),
            ref.vita_msa_int8_ref(*m_args))
        saq = ref.quant(r(b * n, dh, s=1.0).to(dev), acts[1])
        rec("int8_matmul", ops.int8_matmul(saq, i_args[3]),
            ref.int8_matmul_ref(saq, i_args[3]))
        rec("vita_msa_batched", ops.vita_msa_batched(z, *f_args[:3]),
            ref.vita_msa_batched_ref(z, *f_args[:3]))
        mlp = (z, f_args[8], f_args[10], f_args[9], None)
        rec("fused_mlp", ops.mlp(*mlp),
            ref.fused_mlp_ref(z, f_args[8], f_args[9], f_args[10], None))
    return out


def local_shapes(tree, mesh) -> dict:
    """The shapes a rank of ``mesh`` holds of the first encoder block of
    ``tree`` (its heads, concat rows and MLP columns), from the spec
    tree."""
    from repro_torch.core.quant import QTensor
    from repro_torch.distributed import sharding as shd
    bp, sp = tree, shd.vision_param_specs(tree, mesh)
    while "wq" not in bp:
        key = next(k for k in ("layers", "stages", "blocks", "outer")
                   if k in bp)
        bp, sp = bp[key], sp[key]
        if isinstance(bp, list):
            bp, sp = bp[0], sp[0]
    out = {}
    for k in ("wq", "w_msa", "w_up"):
        leaf, spec = bp[k], sp[k]
        if isinstance(leaf, QTensor):
            leaf, spec = leaf.values, spec.values
        out[k] = tuple(n // shd.axis_size(mesh, a) if a else n
                       for n, a in zip(leaf.shape, spec))
    return out


def mesh_check(name: str, mode: str, got: np.ndarray,
               want: np.ndarray) -> None:
    """Mesh logits against the single device's on the card: float within
    1e-4 of the logit scale (the partial sums reassociate), int8 within
    0.02 of it with a differing argmax only at a near-tie."""
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    if mode == "float":
        ok, txt = err <= 1e-4 * max(1.0, scale), "1e-4 x max(1, scale)"
    else:
        n_differ, ties = argmax_check(got, want, err)
        ok = err <= 0.02 * scale and ties
        txt = (f"0.02 x scale; argmax differs on {n_differ}/{len(want)}, "
               f"each a near-tie: {ties}")
    print(f"[mesh] {name} against the single device on the card: max|err| "
          f"{err:.3e} (scale {scale:.3f}, bound {txt})")
    check(got.shape == want.shape and bool(np.isfinite(got).all()) and ok,
          f"{name}: logits disagree with the single device")


_RANK_PROFILES: list = []


def rank_profile_start() -> None:
    """Start a CUDA profiler session in this rank's process."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    _RANK_PROFILES.append(prof)


def rank_profile_stop() -> float:
    """Stop this rank's session: its kernels' device time in ms."""
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    prof = _RANK_PROFILES.pop()
    prof.__exit__(None, None, None)
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


# 6a: (model, mesh shape, mode, fused, group size) replays of a bucket of
# 8 images at full width and depth, each against the single-device
# `run_schedule` on the card.  DeiT-T's 3 heads split 1 a rank at model
# 3; Swin-T's stage 1 (3 heads) replicates its heads at model 2 and
# splits its MLP, stages 2-4 split both; TNT-S splits its 4-head inner
# and 6-head outer blocks; grouped by 4 under a model axis runs the split
# per-layer chain, on a data mesh the group kernels.
MESH_REPLAYS = (("deit_t", "1x3", "float", True, 1),
                ("deit_t", "1x3", "int8", True, 1),
                ("deit_t", "1x3", "float", False, 1),
                ("deit_t", "1x3", "int8", False, 1),
                ("deit_t", "1x3", "float", True, 4),
                ("swin_t", "1x2", "float", True, 1),
                ("swin_t", "1x2", "int8", True, 1),
                ("tnt_s", "1x2", "float", True, 1),
                ("deit_t", "2x1", "float", True, 1),
                ("deit_t", "2x1", "float", True, 4),
                ("deit_t", "2x1", "int8", True, 4))
# 6b: VisionServer drains, (mesh shape, requests); then MESH_TIMED
# requests of zeros timed after a warm drain.
MESH_DRAINS = (("1x3", 11), ("2x1", 5))
MESH_TIMED = 32
# 6c: the latency-mesh stream: arrivals, rate, and the SLA as a share of
# the single-device server's measured bucket-1 latency (below it, so no
# throughput bucket meets it and singles route to the latency mesh).
LAT_ARRIVALS, LAT_RATE, LAT_SLA_SHARE = 32, 50.0, 0.9


def mesh_expected(sched, mode: str, split: bool) -> dict:
    """One rank's launches for one micro-batch: `expected_launches`, with
    a layer group under a model axis run as its members' split layers."""
    want = expected_launches(sched, mode, 1, 0)
    if split:
        for g, one in (("vita_layer_group", "vita_layer"),
                       ("vita_layer_group_int8", "vita_layer_int8")):
            if want[g]:
                want[one] += sum(len(p.members) for p in sched.phases
                                 if p.kind == "layer_group")
                want[g] = 0
    return want


def mesh_phase(served: dict, params: dict, quant: dict, images: dict,
               where: str, t_start: float, replays=MESH_REPLAYS,
               drains=MESH_DRAINS, latency_mesh: str = "1x3") -> dict:
    """Phase 6 (module docstring): ``replays`` (6a), ``drains`` (6b) and
    the stream on ``latency_mesh`` (6c) on a world of as many ranks as
    the largest mesh needs.  Returns the launches of its main paths
    summed over the ranks."""
    from repro_torch.kernels import ops
    from repro_torch.launch import admission as adm
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.vision_serve import serve_stream

    totals = {k[0]: 0 for k in KERNELS}
    shapes = [r[1] for r in replays] + [d[0] for d in drains] \
        + [latency_mesh, "1x3"]
    ranks = max(int(np.prod(mesh_lib.parse_mesh_shape(s))) for s in shapes)
    t0 = time.perf_counter()
    world = mesh_lib.start_world(ranks, "cuda")
    print(f"[mesh] backend={world.backend} ranks={world.size} cards="
          f"{torch.cuda.device_count()} on {where}: ranks started in "
          f"{time.perf_counter() - t0:.1f} s")
    try:
        _mesh_replays(replays, params, quant, images, totals, where)
        _mesh_drains(drains, served, images, totals, where)
        # 6c: singles under a tight SLA route to the latency mesh.
        solo = served[("deit_t", "float", True, 1)]["server"]
        b1 = adm.measure_bucket_latencies(solo, repeats=3)[1]
        sla = LAT_SLA_SHARE * b1
        trace = adm.poisson_trace(LAT_RATE, LAT_ARRIVALS, "deit_t",
                                  sla_ms=sla, seed=0, n_images=B_MAIN)
        lat_mesh = mesh_lib.make_vision_mesh(
            *mesh_lib.parse_mesh_shape(latency_mesh), "cuda")
        mesh_lib.per_rank(lat_mesh, ops.reset_launches)
        (row,) = serve_stream(["deit_t"], modes=("float",), buckets=BUCKETS,
                              trace=trace, latency_mesh=latency_mesh,
                              full=True)
        counts = mesh_lib.per_rank(lat_mesh, ops.launch_counts)
        for c in counts:
            for k, v in c.items():
                totals[k] += v
        print(f"[mesh] deit_t float stream, latency mesh {latency_mesh}, SLA "
              f"{sla:.3f} ms (0.9 x the single-device bucket-1 latency "
              f"{b1:.3f} ms), {LAT_RATE}/s offered on {where}: "
              f"{row['requests']}/{row['offered']} served, "
              f"{row['routed_latency_path']} routed to the latency mesh, "
              f"p50 {row['latency_p50_ms']:.3f} ms, p99 "
              f"{row['latency_p99_ms']:.3f} ms; launches by rank "
              f"{[{k: v for k, v in c.items() if v} for c in counts]}")
        check(row["requests"] == row["offered"] == LAT_ARRIVALS
              and row["routed_latency_path"] > 0,
              "the latency-mesh stream did not serve every arrival or "
              "routed none")
        mesh_pipeline(where)
    finally:
        world.close()
    print(f"[phase] mesh served in {time.perf_counter() - t0:.1f} s, at "
          f"{time.perf_counter() - t_start:.0f} s")
    return totals


def _mesh_replays(replays, params, quant, images, totals, where) -> None:
    """6a, and each kernel at one local shape on each rank of (1, 3)."""
    from repro_torch.core import schedule as sched_lib
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import vision_registry, vit

    for model, shape, mode, fused, group in replays:
        d, m = mesh_lib.parse_mesh_shape(shape)
        mesh = mesh_lib.make_vision_mesh(d, m, "cuda")
        cfg = vision_registry.build_cfg(model, full=True, fused=fused,
                                        fuse_group=group)
        sched = vision_registry.make_schedule(cfg)
        x = vit.extract_patches(torch.from_numpy(images[model][:B_MAIN])
                                .cuda(), cfg.patch)
        if mode == "int8":
            tree, obs = quant[(model, 1)]
        else:
            tree, obs = params[model], None
        with torch.inference_mode():
            want = sched_lib.run_schedule(sched, tree, x, observer=obs)
        mesh_lib.per_rank(mesh, ops.reset_launches)
        t0 = time.perf_counter()
        got = sched_lib.run_schedule_sharded(sched, tree, x, mesh,
                                             observer=obs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = mesh_lib.per_rank(mesh, ops.launch_counts)
        for c in counts:
            for k, v in c.items():
                totals[k] += v
        split = m > 1 and group > 1
        want_counts = mesh_expected(sched, mode, split)
        name = f"{path_name(model, mode, fused, group)} on {shape}"
        print(f"[mesh] {name}: launches by rank "
              f"{[{k: v for k, v in c.items() if v} for c in counts]}; "
              f"a rank's first block {local_shapes(tree, mesh)}; one "
              f"replay {ms:.1f} ms on {where} (host clock, the whole batch "
              f"and tree sent to the ranks)")
        check(all(c == want_counts for c in counts),
              f"{name}: launches {counts}, expected {want_counts} a rank")
        mesh_check(f"{name}, run_schedule_sharded", mode,
                   got.float().cpu().numpy(), want.float().cpu().numpy())
    mesh = mesh_lib.make_vision_mesh(1, 3, "cuda")
    for rank, errs in enumerate(mesh_lib.per_rank(mesh, rank_kernel_checks,
                                                  mesh)):
        for kname, (err, scale) in errs.items():
            tol = (0.0 if kname == "int8_matmul" else
                   0.02 * scale if kname == "vita_layer_int8" else
                   1e-4 * max(1.0, scale))
            print(f"[mesh] rank {rank} {kname} at its local DeiT-T shape "
                  f"against its plain version: max|err| {err:.3e} (scale "
                  f"{scale:.3f}, bound {tol:.3e})")
            check(err <= tol, f"rank {rank}: {kname} disagrees at its local "
                              f"shape")


def _mesh_drains(drains, served, images, totals, where) -> None:
    """6b: DeiT-T servers on "1x3" and "2x1" against phase 3's single-
    device servers, then their img/s, p50 and the card's busy share."""
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.vision_serve import ServeConfig, VisionServer

    for shape, n in drains:
        d, m = mesh_lib.parse_mesh_shape(shape)
        mesh = mesh_lib.make_vision_mesh(d, m, "cuda")
        for mode in ("float", "int8"):
            o = served[("deit_t", mode, True, 1)]
            solo = o["server"]
            server = VisionServer(
                solo.cfg, solo.params, qparams=solo.qparams,
                calibrator=solo.calibrator, model_name="deit_t",
                serve_cfg=ServeConfig(mode=mode, buckets=BUCKETS,
                                      mesh_shape=shape))
            mesh_lib.per_rank(mesh, ops.reset_launches)
            reqs = server.submit_many(images["deit_t"][:n])
            stats = server.run()
            counts = mesh_lib.per_rank(mesh, ops.launch_counts)
            for c in counts:
                for k, v in c.items():
                    totals[k] += v
            name = f"deit_t {mode} fused server on {shape}"
            check(stats["requests"] == n and stats["mesh_shape"] == shape,
                  f"{name}: stats {stats}")
            mesh_check(f"{name}, {n} requests in {stats['batches']} "
                       f"micro-batches ({stats['padded']} padded)", mode,
                       np.stack([r.logits for r in reqs]), o["logits"][:n])
            zeros = np.zeros((MESH_TIMED, 224, 224, 3), np.float32)
            server.submit_many(zeros[:16])
            server.run()                                    # warm
            mesh_lib.per_rank(mesh, rank_profile_start)
            server.submit_many(zeros)
            stats = server.run()
            busy = mesh_lib.per_rank(mesh, rank_profile_stop)
            share = sum(busy) / (stats["wall_s"] * 1e3)
            cards = len({mesh_lib.rank_device(r, "cuda")
                         for r in range(mesh.size)})
            print(f"[time] mesh {shape} deit_t {mode} fused on {where}, "
                  f"{cards} card(s) through {mesh.backend}: "
                  f"{stats['requests']} requests in {stats['batches']} "
                  f"micro-batches of {BUCKETS[-1]}: "
                  f"{stats['throughput_img_s']:.1f} img/s, p50 latency "
                  f"{stats['latency_p50_ms']:.3f} ms (drain: queue "
                  f"included), p50 service {stats['service_p50_ms']:.3f} "
                  f"ms; kernel time by rank {[round(b, 3) for b in busy]} "
                  f"ms over {stats['wall_s'] * 1e3:.1f} ms of wall: busy "
                  f"{100 * share:.1f}% (the ranks' kernel time summed over "
                  f"the wall; on one card their contexts time-slice it)")


# ---------------------------------------------------------------------------
# Phase 9: the dry run, the HUE CLI, the generic PTQ on kernel 4, DeiT-S,
# kernel 1's gradient and the examples
# ---------------------------------------------------------------------------

DEIT_S_REQUESTS = 32
DANUBE_UP = (2048, 2560, 6912)   # rows, K, N: Danube-1.8B's up projection
VIT_EDGE_STEPS = 80              # the example's training steps
EXAMPLE_TIMEOUT_S = 240


def _load_file(name: str, *parts):
    """A repo script (a tool or an example) as a module, not run."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def deit_s_phase(where: str) -> dict:
    """9a: DeiT-S at full size (224 px, 12 layers, D 384, 6 heads of 64,
    196 tokens) served fused in float and int8 through `VisionServer` at
    bucket 8 (`serve_user_path`: launches as its schedule says, logits
    against the CPU twin at phase 3's bounds), then img/s and p50 over a
    drain and the card's busy share."""
    from repro_torch.models import vit

    cfg = vit.deit_s()
    params = vit.init_params(cfg, 0, "cuda")
    images = np.random.default_rng(0).standard_normal(
        (DEIT_S_REQUESTS, cfg.image, cfg.image, 3)).astype(np.float32)
    totals = {k[0]: 0 for k in KERNELS}
    for mode in ("float", "int8"):
        o = serve_user_path(f"deit_s {mode} fused", "deit_s", cfg, mode,
                            params, images)
        for k, v in o["counts"].items():
            totals[k] += v
        server = o["server"]
        server.submit_many(np.zeros((16,) + images.shape[1:], np.float32))
        server.run()                                       # warm
        server.submit_many(np.zeros((64,) + images.shape[1:], np.float32))
        stats = server.run()
        print(f"[time] served deit_s {mode} fused on {where}: bucket "
              f"{B_MAIN}, {stats['requests']} requests: "
              f"{stats['throughput_img_s']:.1f} img/s, p50 latency "
              f"{stats['latency_p50_ms']:.3f} ms, p50 device "
              f"{stats['device_p50_ms']:.3f} ms a micro-batch")
        profile_drain(f"deit_s {mode}", server, where)
    print(f"[serve] deit_s launches of kernels 1, 2 and 4: vita_layer "
          f"{totals['vita_layer']}, vita_layer_int8 "
          f"{totals['vita_layer_int8']}, int8_matmul "
          f"{totals['int8_matmul']}")
    check(min(totals[k] for k in ("vita_layer", "vita_layer_int8",
                                  "int8_matmul")) > 0,
          "deit_s: a kernel of kernels 1, 2 and 4 was never launched")
    return totals


def danube_ptq_phase(out: list, where: str) -> dict:
    """9b: `quantize_params` on Danube-1.8B's whole bf16 tree on the card
    (the stacked-leaf rule: one scale a channel over a pattern position's
    layers), a percentile scale over its 17.7M-element up projection
    against the CPU's, and `quantized_linear` on kernel 4 at the up
    projection (2,048 rows, K 2,560, N 6,912): the int32 accumulator
    equal to the plain version's, the output to the plain matmul's; the
    kernel timed beside the plain version and `torch._int_mm`."""
    from repro_torch import configs
    from repro_torch.core import quant
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tr

    cfg = configs.get("h2o-danube-1.8b")
    params = tr.init_params(cfg, 0, "cuda")
    t0 = time.perf_counter()
    qp = quant.quantize_params(params, pattern_len=len(cfg.pattern))
    torch.cuda.synchronize()
    n_q = sum(isinstance(v, quant.QTensor) for lp in qp["layers"]
              for part in lp.values() for v in part.values())
    ups = [lp["mlp"]["w_up"] for lp in params["layers"]]
    shared = quant.amax_scale(torch.stack(ups), dim=(0, 1))[0].float()
    same = all(torch.equal(lp["mlp"]["w_up"].scale, shared)
               for lp in qp["layers"])
    codes = torch.equal(qp["layers"][5]["mlp"]["w_up"].values,
                        quant.quantize(ups[5], shared.to(ups[5].dtype)
                                       ).values)
    print(f"[ptq] h2o-danube-1.8b bf16 on {where}: quantize_params in "
          f"{time.perf_counter() - t0:.2f} s, {n_q} layer leaves int8; "
          f"every layer's w_up shares its stack's scale: {same}; layer "
          f"5's codes at that scale: {codes}")
    check(same and codes and n_q > 0,
          "quantize_params: the stacked-leaf rule does not hold on the card")
    w = ups[0]
    pct = quant.quantize_per_tensor(w, percentile=99.99)
    pct_cpu = quant.quantize_per_tensor(w.cpu(), percentile=99.99)
    check(torch.equal(pct.values.cpu(), pct_cpu.values)
          and torch.equal(pct.scale.cpu(), pct_cpu.scale),
          "a percentile scale over 17.7M elements differs from the CPU's")
    print(f"[ptq] percentile 99.99 scale over {w.numel():,} elements on "
          f"the card {float(pct.scale):.6e}, equal to the CPU's (codes "
          f"too): True")

    m, k, n = DANUBE_UP
    wq = qp["layers"][0]["mlp"]["w_up"]
    g = torch.Generator(device="cuda").manual_seed(27)
    x = rand(g, (m, k), torch.bfloat16)
    act = quant.amax_scale(x.float())
    accs = {}

    def spy(xq, wv):
        accs["xq"] = xq
        accs["card"] = quant._kernel_matmul(xq, wv)
        return accs["card"]

    y, counts = launch_delta(lambda: quant.quantized_linear(
        x, wq, None, act, matmul=spy))
    check(counts["int8_matmul"] == 1, f"quantized_linear: {counts}")
    xq = accs["xq"]
    plain_acc = ref.int8_matmul_ref(xq, wq.values)
    y_plain = quant.quantized_linear(x, wq, None, act,
                                     matmul=quant.int8_matmul_ref)
    exact = torch.equal(accs["card"], plain_acc)
    print(f"[check] quantized_linear on kernel 4, h2o-danube-1.8b up "
          f"projection {m} x {k} x {n}: int32 accumulators equal the plain "
          f"version's: {exact}; outputs equal: {torch.equal(y, y_plain)}")
    check(exact and torch.equal(y, y_plain),
          "quantized_linear: kernel 4 disagrees with its plain version")
    bnd = bound(ops_i8=2 * m * k * n, nbytes=m * k + k * n + 4 * m * n)
    (ms, by), (plain_ms, plain_by) = (
        device_ms(lambda: ops.int8_matmul(xq, wq.values)),
        device_ms(lambda: ref.int8_matmul_ref(xq, wq.values)))
    lib_ms, lib_by = device_ms(lambda: torch._int_mm(xq, wq.values))
    tag = f"h2o-danube-1.8b up projection {m} x {k} x {n} (quantized_linear)"
    next(e for e in out if e["name"] == "int8_matmul")[
        "other_shapes"].append({
            "shape": tag, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "timed_by": {"ms": by, "plain_ms": plain_by,
                         "library_ms": lib_by}})
    print(f"[time] int8_matmul {tag} on {where}: device {ms:.4f} ms [{by}], "
          f"plain {plain_ms:.4f} ms [{plain_by}], library (torch._int_mm) "
          f"{lib_ms:.4f} ms [{lib_by}], bound {bnd[0]:.4f} ms ({bnd[1]})")
    del params, qp, ups, w, pct, accs, xq, plain_acc
    release()
    return counts


def _grads(loss_fn, params):
    """(loss, gradient leaves) of ``loss_fn(params)``."""
    from repro_torch import tree as tree_lib

    live = [p.detach().requires_grad_() for p in tree_lib.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_lib.unflatten(params, live))
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), grads


def vision_grad_phase(out: list, where: str) -> dict:
    """9c: kernel 1's gradient path (`ops._KernelGrad`) at DeiT-S b8
    against the plain version's autograd bit for bit, forward + backward
    timed; one full-size DeiT-S training step (batch 8) against its CPU
    twin, the loss and every gradient leaf within 1e-3 of its scale; the
    example's VIT_EDGE_STEPS AdamW steps of ``vit_edge`` (the loss must
    fall), then its PTQ and drains."""
    from repro_torch import tree as tree_lib
    from repro_torch.kernels import ops, ref
    from repro_torch.models import vit

    totals = {k[0]: 0 for k in KERNELS}
    cfg = vit.deit_s()
    g = torch.Generator(device="cuda").manual_seed(27)
    bp, x = vit_block(cfg, 0, g)
    f_args, _ = layer_args(bp, x)
    inputs = tuple(t.detach().requires_grad_() for t in f_args)
    before = ops.LAUNCHES["vita_layer"]
    y = ops.vita_layer_fused(*inputs)
    check(ops.LAUNCHES["vita_layer"] == before + 1
          and type(y.grad_fn).__name__ == "_KernelGradBackward",
          "vita_layer: the gradient path did not launch the kernel through "
          "ops._KernelGrad")
    totals["vita_layer"] += 1
    want = ref.vita_layer_ref(*inputs)
    err = check_close("vita_layer deit_s b8 forward (gradient path)",
                      y.detach(), want.detach())
    ct = torch.randn(y.shape, generator=g, device="cuda")
    got = torch.autograd.grad(y, inputs, ct)
    exp = torch.autograd.grad(want, inputs, ct)
    same = all(torch.equal(a, b) for a, b in zip(got, exp))
    print(f"[check] vita_layer deit_s b8: the gradients of its "
          f"{len(inputs)} inputs equal the plain version's bit for bit: "
          f"{same}")
    check(same, "vita_layer: a gradient differs from the plain version's")
    h, _, dh = bp["wq"].shape
    proj, attn = layer_flops(x.shape[0], cfg.tokens, cfg.dim, h, dh,
                             cfg.mlp_hidden)
    bnd = bound(flops_f32=3 * (proj + attn),
                nbytes=3 * nbytes(*f_args) + 2 * nbytes(x))

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(*inputs), inputs, ct)

    (ms, by), (plain_ms, plain_by) = (
        device_ms(fwd_bwd(ops.vita_layer_fused)),
        device_ms(fwd_bwd(ref.vita_layer_ref)))
    lib_ms, lib_by = device_ms(fwd_bwd(
        lambda *a: composed_layer(a, h, dh)()))
    tag = f"deit_s b{x.shape[0]} forward + backward"
    next(e for e in out if e["name"] == "vita_layer")[
        "other_shapes"].append({
            "shape": tag, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "timed_by": {"ms": by, "plain_ms": plain_by,
                         "library_ms": lib_by}})
    print(f"[time] vita_layer {tag} on {where}: device {ms:.4f} ms [{by}], "
          f"plain {plain_ms:.4f} ms [{plain_by}], library (cuBLAS + "
          f"F.layer_norm + SDPA + F.gelu, autograd) {lib_ms:.4f} ms "
          f"[{lib_by}], bound {bnd[0]:.4f} ms ({bnd[1]})")

    # One full-size training step against the CPU twin.
    ex = _load_file("serve_quantized_vit_torch", "examples",
                    "serve_quantized_vit_torch.py")
    params = vit.init_params(cfg, 1, "cuda")
    rng = np.random.default_rng(27)
    images = torch.from_numpy(rng.standard_normal(
        (B_MAIN, cfg.image, cfg.image, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.n_classes, B_MAIN))
    t0 = time.perf_counter()
    (loss, grads), c = launch_delta(lambda: _grads(
        lambda p: ex.loss_fn(p, images.cuda(), labels.cuda(), cfg), params))
    step_s = time.perf_counter() - t0
    check(c["vita_layer"] == cfg.layers, f"deit_s train step: {c}")
    for k2, v in c.items():
        totals[k2] += v
    loss_cpu, grads_cpu = _grads(lambda p: ex.loss_fn(p, images, labels,
                                                      cfg),
                                 vit.to_device(params, "cpu"))
    worst, where_worst = 0.0, ""
    for path_leaf, g_card, g_cpu in zip(tree_lib.leaves_with_path(params),
                                        grads, grads_cpu):
        scale = float(g_cpu.abs().max())
        rel = float((g_card.cpu() - g_cpu).abs().max()) / max(scale, 1e-30)
        if rel > worst:
            worst, where_worst = rel, tree_lib.path_key(path_leaf[0])
    lrel = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    print(f"[train] deit_s one step, batch {B_MAIN}, on {where}: loss "
          f"{float(loss):.6f} (CPU {float(loss_cpu):.6f}, rel {lrel:.2e}); "
          f"{len(grads)} gradient leaves, the worst {worst:.2e} of its "
          f"scale ({where_worst}; bound 1e-3); the card's step "
          f"{step_s * 1e3:.1f} ms with the host's first calls")
    check(lrel <= 1e-3 and worst <= 1e-3,
          "deit_s: the training step disagrees with its CPU twin")

    # The example: VIT_EDGE_STEPS AdamW steps of vit_edge, PTQ, drains.
    res, c = launch_delta(lambda: ex.main([], steps=VIT_EDGE_STEPS))
    for k2, v in c.items():
        totals[k2] += v
    losses = res["losses"]
    print(f"[train] examples/serve_quantized_vit_torch.py on {where}: "
          f"{VIT_EDGE_STEPS} vit_edge steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, step {np.median(res['step_ms']):.2f} ms "
          f"(median of {len(res['step_ms'])}, host clock), launches {c}")
    check(np.mean(losses[-10:]) < np.mean(losses[:10])
          and c["vita_layer"] > 0 and c["vita_layer_int8"] > 0,
          "the example's training did not lower the loss on the kernels")
    del params, grads
    release()
    return totals


def hue_cli_phase(where: str) -> dict:
    """9d: tools/hue_report_torch.py on DeiT-T and Swin-T in both modes at
    batch 8 with --json-out: exit 0, every report's modelled columns equal
    to `core.hue.live_hue_report` of the same schedule."""
    from repro_torch.core import hue as hue_lib
    from repro_torch.models import vision_registry

    tool = _load_file("hue_report_torch", "tools", "hue_report_torch.py")
    models, modes = ("deit_t", "swin_t"), ("float", "int8")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hue.json")
        rc, c = launch_delta(lambda: tool.main([
            "--models", ",".join(models), "--mode", "both", "--batch",
            str(B_MAIN), "--json-out", path]))
        with open(path) as f:
            record = json.load(f)
    check(rc == 0, f"hue_report_torch exited {rc}")
    cols = ("phase", "count", "modelled_cycles", "modelled_ms",
            "modelled_share", "hue_modelled")
    for (model, mode), report in zip(
            [(m, md) for m in models for md in modes], record["reports"]):
        cfg = vision_registry.build_cfg(model)
        sched = vision_registry.make_schedule(cfg)
        recs = [{"index": i, "kind": ph.kind, "site": ph.site, "ms": 1.0}
                for i, ph in enumerate(sched.phases)]
        want = hue_lib.live_hue_report(vision_registry.make_spec(cfg), recs,
                                       fused=bool(cfg.fused),
                                       group_size=int(cfg.fuse_group))
        same = [{k: r[k] for k in cols} for r in report["rows"]] == \
            [{k: r[k] for k in cols} for r in want["rows"]]
        print(f"[hue-cli] {model} {mode} b{report['batch']} on {where}: "
              f"{len(report['rows'])} rows, measured "
              f"{sum(r['measured_ms'] or 0 for r in report['rows']):.3f} "
              f"ms; modelled columns equal core.hue's: {same}")
        check(same and report["mode"] == mode and report["device"] == "cuda",
              f"hue_report_torch {model} {mode}: the modelled columns "
              f"differ from core.hue's")
    check(record["device_count"] == torch.cuda.device_count(),
          "hue_report_torch: device_count is not the card count")
    return c


def dryrun_phase(where: str) -> None:
    """9e: `launch.dryrun.lower_cell` on the installed torch: Danube-1.8B
    at the four shapes on the 16 x 16 pod and Qwen2.5-32B's train_4k on
    the 2 x 16 x 16 one, each traced on the meta device."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, mesh

    cells = [("h2o-danube-1.8b", s, "pod1") for s in configs.SHAPES] \
        + [("qwen2.5-32b", "train_4k", "pod2")]
    for arch, shape, mesh_name in cells:
        t0 = time.perf_counter()
        rec = dryrun.lower_cell(arch, shape, mesh.make_production_mesh(
            multi_pod=mesh_name == "pod2"))
        ratio = rec["flops_global"] / rec["model_flops_global"]
        print(f"[dryrun] {arch} x {shape} x {mesh_name} on torch "
              f"{torch.__version__}: flops_global / model_flops_global "
              f"{ratio:.4f}, state {rec['state_bytes_per_device_analytic']:,}"
              f" B a device, collectives "
              f"{rec['collectives']['bytes_total']:,} B; "
              f"{time.perf_counter() - t0:.2f} s")
        check(1.0 <= ratio <= 6.0 and rec["n_devices"] in (256, 512),
              f"dryrun {arch} x {shape}: flops ratio {ratio}")


def examples_phase(where: str) -> None:
    """9f: examples/quickstart_torch.py and examples/train_lm_torch.py
    --small as subprocesses on the card; a non-zero exit fails."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as tmp:
        for args in (["quickstart_torch.py"],
                     ["train_lm_torch.py", "--small", "--ckpt",
                      os.path.join(tmp, "ckpt")]):
            t0 = time.perf_counter()
            done = subprocess.run(
                [sys.executable, os.path.join(ROOT, "examples", args[0]),
                 *args[1:]], capture_output=True, text=True, env=env,
                cwd=ROOT, timeout=EXAMPLE_TIMEOUT_S)
            tail = done.stdout.strip().splitlines()[-2:]
            print(f"[example] {' '.join(args)} on {where}: exit "
                  f"{done.returncode} in {time.perf_counter() - t0:.1f} s; "
                  + " | ".join(tail))
            check(done.returncode == 0,
                  f"{args[0]} exited {done.returncode}: "
                  f"{done.stderr[-2000:]}")


def slice_phase(out: list, where: str, t_start: float) -> dict:
    """Phase 9 (module docstring).  Returns the launches of its main
    paths."""
    totals = {k[0]: 0 for k in KERNELS}

    def add(c):
        for k, v in c.items():
            totals[k] += v

    t9 = time.perf_counter()
    for step, run in (("9a DeiT-S served", lambda: deit_s_phase(where)),
                      ("9b the generic PTQ on kernel 4",
                       lambda: danube_ptq_phase(out, where)),
                      ("9c kernel 1's gradient",
                       lambda: vision_grad_phase(out, where)),
                      ("9d the HUE CLI", lambda: hue_cli_phase(where)),
                      ("9e the dry run", lambda: dryrun_phase(where)),
                      ("9f the examples", lambda: examples_phase(where))):
        t0 = time.perf_counter()
        c = run()
        if c:
            add(c)
        print(f"[phase] {step} in {time.perf_counter() - t0:.1f} s")
    print(f"[phase] 9 the slice's paths in {time.perf_counter() - t9:.1f} s, "
          f"at {time.perf_counter() - t_start:.0f} s")
    return totals


def main() -> None:
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device is available", file=sys.stderr)
        raise SystemExit(2)
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("[chip_smoke] src/repro_torch not found beside this script",
              file=sys.stderr)
        raise SystemExit(2)
    sys.path.insert(0, src)
    from repro_torch.core.quant import ptq_tolerance
    from repro_torch.kernels import build
    from repro_torch.models import vision_registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {name} ({card})")

    # 1. Build.
    t_start = t0 = time.perf_counter()
    logs = build.build_all()
    for lib, log in sorted(logs.items()):
        print(f"[build] {lib}: " + " | ".join(ptxas_lines(log)))
    print(f"[build] {len(build.LIBRARIES)} libraries ready in "
          f"{build.BUILD_DIR} ({time.perf_counter() - t0:.1f} s)")

    # 2. Each kernel against its plain version.
    cfgs = {m: vision_registry.build_cfg(m, full=True)
            for m in MODELS + ("vit_edge",)}
    records = kernel_phase(cfgs["deit_t"], cfgs["vit_edge"], cfgs["swin_t"])
    lm_kernel_phase(records)
    lm_rest_kernel_phase(records)
    grad_kernel_phase(records)
    bf16_kernel_phase(records, cfgs["deit_t"], cfgs["swin_t"])
    t_wide = time.perf_counter()
    wide_kernel_phase(records, cfgs["vit_edge"])
    print(f"[phase] wide kernels checked in "
          f"{time.perf_counter() - t_wide:.1f} s")
    t_tnt = time.perf_counter()
    tnt_kernel_phase(records, cfgs["tnt_s"])
    print(f"[phase] TNT-S kernel shapes checked in "
          f"{time.perf_counter() - t_tnt:.1f} s")
    t_gemm = time.perf_counter()
    gemm_phase()
    print(f"[phase] kernel 1's GEMMs timed in "
          f"{time.perf_counter() - t_gemm:.1f} s")
    print(f"[phase] kernels checked at {time.perf_counter() - t_start:.0f} s")

    # 3. Serve every path on the card against its CPU twin.
    images = {m: np.random.default_rng(0).standard_normal(
        (max(p[4] for p in PATHS), cfgs[m].image, cfgs[m].image, 3)
    ).astype(np.float32) for m in MODELS}
    params = {m: vision_registry.init_params(cfgs[m], seed=0, device="cuda")
              for m in MODELS}
    served, quant = {}, {}
    for model, mode, fused, group, n_req in PATHS:
        # The unfused int8 path reuses the fused path's frozen scales; a
        # grouped int8 path calibrates through its own group phases.
        q = quant.get((model, group), (None, None))
        out = serve_path(model, mode, fused, group, params[model],
                         images[model][:n_req],
                         qparams=q[0], calibrator=q[1])
        if mode == "int8":
            quant[(model, group)] = (out["server"].qparams,
                                     out["server"].calibrator)
        served[(model, mode, fused, group)] = out
    # TNT-S grouped by 2: the fused phase list, no layer-group launch.
    tnt_grouped = served[("tnt_s", "float", True, 2)]
    same = (vision_registry.make_schedule(tnt_grouped["server"].cfg).phases
            == vision_registry.make_schedule(
                served[("tnt_s", "float", True, 1)]["server"].cfg).phases)
    print(f"[serve] tnt_s float grouped by 2: the fused phase list {same}, "
          f"layer-group launches {tnt_grouped['counts']['vita_layer_group']}")
    check(same and tnt_grouped["counts"]["vita_layer_group"] == 0,
          "tnt_s grouped by 2 formed a layer group")
    for model, mode, fused, group, _ in PATHS:
        if mode != "int8" or not fused \
                or (model, "float", True, group) not in served:
            continue
        f_log = served[(model, "float", True, group)]["logits"]
        i_log = served[(model, "int8", True, group)]["logits"]
        n = min(len(f_log), len(i_log))
        tol = ptq_tolerance(float(np.abs(f_log[:n]).max()))
        perr = float(np.abs(i_log[:n] - f_log[:n]).max())
        print(f"[serve] {path_name(model, 'int8', True, group)} vs float on "
              f"the card: max|err| {perr:.4f} (ptq_tolerance {tol:.4f})")
        check(perr <= tol, f"{model}: int8 logits outside the PTQ tolerance")
    print(f"[phase] vision paths served at "
          f"{time.perf_counter() - t_start:.0f} s")

    # 3b. The bf16 configuration: served (mixed mode) and `forward` on bf16
    # patches, every weight bf16, random from seed 0.
    cfg16 = {m: dataclasses.replace(cfgs[m], dtype="bfloat16")
             for m in ("deit_t", "swin_t", "tnt_s")}
    params16 = {m: vision_registry.init_params(c, seed=0, device="cuda")
                for m, c in cfg16.items()}
    served16, quant16 = {}, {}
    for model, mode, fused, group, n_req in BF16_PATHS:
        q = quant16.get((model, group), (None, None))
        # float32 images on bf16 weights: the mixed mode
        out = serve_user_path(
            path_name(model, mode, fused, group) + ", bf16 weights", model,
            dataclasses.replace(cfg16[model], fused=fused, fuse_group=group),
            mode, params16[model], images[model][:n_req], qparams=q[0],
            calibrator=q[1], act="float32")
        if mode == "int8":
            quant16[(model, group)] = (out["server"].qparams,
                                       out["server"].calibrator)
        served16[(model, mode, fused, group)] = out
    for model, _, fused, group, _ in BF16_PATHS:
        if not fused or (model, "int8", fused, group) not in served16:
            continue
        f_log = served16[(model, "float", fused, group)]["logits"]
        i_log = served16[(model, "int8", fused, group)]["logits"]
        tol = ptq_tolerance(float(np.abs(f_log).max()))
        perr = float(np.abs(i_log - f_log).max())
        print(f"[serve] {path_name(model, 'int8', fused, group)}, bf16 "
              f"weights, vs float on the card: max|err| {perr:.4f} "
              f"(ptq_tolerance {tol:.4f})")
        check(perr <= tol, f"{model} bf16: int8 logits outside the PTQ "
                           f"tolerance")
    forwards = [bf16_forward(model, fused, group, cfg16[model],
                             params16[model], images[model][:B_MAIN])
                for model, fused, group in BF16_FORWARDS]
    print(f"[serve] launches by dtype mode over the bf16 paths: "
          f"{MODE_TOTALS}")
    print(f"[phase] bf16 paths served at "
          f"{time.perf_counter() - t_start:.0f} s")
    # 3c. The widened tiles' user configs, float and int8, random weights
    # from seed 0.
    t_wide = time.perf_counter()
    served_wide = []
    for tag, cfg in wide_configs(cfgs["vit_edge"]).items():
        wide_params = vision_registry.init_params(cfg, seed=0, device="cuda")
        wide_images = np.random.default_rng(1).standard_normal(
            (WIDE_REQUESTS, cfg.image, cfg.image, 3)).astype(np.float32)
        for mode in ("float", "int8"):
            served_wide.append(serve_user_path(
                f"{tag} {mode} fused, L{cfg.layers}", cfg.name, cfg, mode,
                wide_params, wide_images))
    print(f"[phase] wide configs served in "
          f"{time.perf_counter() - t_wide:.1f} s, at "
          f"{time.perf_counter() - t_start:.0f} s")
    lm_counts, lm_served = lm_paths(f"{name} ({card})")
    print(f"[phase] LM paths served at {time.perf_counter() - t_start:.0f} s")
    launches = {k[0]: sum(o["counts"][k[0]] for o in served.values())
                + sum(o["counts"][k[0]] for o in served16.values())
                + sum(o["counts"][k[0]] for o in forwards)
                + sum(o["counts"][k[0]] for o in served_wide)
                + sum(c[k[0]] for c in lm_counts.values()) for k in KERNELS}
    check(all(v > 0 for v in launches.values()),
          f"a kernel was never launched on a served path: {launches}")

    # 4. Times: the served throughput and the profiled drains first (their
    # kernel counts are checked, before the many profiler sessions below),
    # then every kernel, then the LM paths' tokens per second.
    img_s = {}
    for key, o in [*served.items(),
                   *(((*k, "bf16"), o) for k, o in served16.items())]:
        server = o["server"]
        shape = (server.cfg.image, server.cfg.image, 3)
        server.submit_many(np.zeros((16,) + shape, np.float32))
        server.run()                                    # warm
        server.submit_many(np.zeros((64,) + shape, np.float32))
        stats = server.run()
        img_s[key] = stats["throughput_img_s"]
        bf = ", bf16 weights" if len(key) > 4 else ""
        print(f"[time] served {path_name(*key[:4])}{bf} on {name} ({card}): "
              f"bucket {BUCKETS[-1]}, {stats['requests']} requests: "
              f"{stats['throughput_img_s']:.1f} img/s, p50 latency "
              f"{stats['latency_p50_ms']:.3f} ms (drain: queue included), "
              f"p50 service {stats['service_p50_ms']:.3f} ms (host launches "
              f"and device), p50 device {stats['device_p50_ms']:.3f} ms a "
              f"micro-batch (CUDA events)")
    for (model, mode, fused, group, *bf), v in img_s.items():
        if bf and (model, mode, fused, group) in img_s:
            print(f"[time] served {path_name(model, mode, fused, group)}: "
                  f"bf16 weights {v:.1f} img/s beside fp32 "
                  f"{img_s[(model, mode, fused, group)]:.1f} img/s (one run)")
        if group > 1 and not bf:
            print(f"[time] served {model} {mode}: grouped by {group} "
                  f"{v:.1f} img/s beside per-layer "
                  f"{img_s[(model, mode, True, 1)]:.1f} img/s (one run; "
                  f"the host's share varies between machines)")
    # 5. Open streams at loads set by the closed-drain rates above, two
    # lanes on one card, and the live HUE profiles.
    where = f"{name} ({card})"
    for counts in (stream_phase(served, img_s, images, where, t_start),
                   hue_phase(served, images, where, t_start)):
        for k, v in counts.items():
            launches[k] += v
    for model in ("deit_t", "swin_t", "tnt_s"):
        for mode in ("float", "int8"):
            profile_drain(f"{model} {mode}",
                          served[(model, mode, True, 1)]["server"],
                          f"{name} ({card})")
    for mode in ("float", "int8"):
        check_grouped_drain(mode, served[("deit_t", mode, True, 4)]["server"],
                            f"{name} ({card})")
    profile_drain("deit_t float, bf16 weights",
                  served16[("deit_t", "float", True, 1)]["server"],
                  f"{name} ({card})")
    print(f"[phase] drains profiled at {time.perf_counter() - t_start:.0f} s")
    # Every kernel's main shape first (the JSON line's numbers), then the
    # other shapes.
    out, walls = [], []
    for kname, replaces, source in KERNELS:
        r = records[kname]
        t_rec = time.perf_counter()
        (ms, by), (plain_ms, plain_by) = (device_ms(r["fn"]),
                                          device_ms(r["plain"]))
        lib_ms, lib_by = device_ms(r["library"]) if r["library"] \
            else (None, None)
        call_ms = time_ms(r["fn"])
        bound_ms, bound_by = r["bound"]
        out.append({"name": kname, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[kname],
                    "max_abs_err": r["err"], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms, "call_ms": call_ms,
                    "timed_by": {"ms": by, "plain_ms": plain_by,
                                 "library_ms": lib_by},
                    "shape": r["tag"], "other_shapes": []})
        print(f"[time] {kname} {r['tag']} on {name} ({card}): device "
              f"{ms:.4f} ms [{by}] (per call with the host in the loop "
              f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms [{plain_by}], "
              f"library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms [{lib_by}]'}"
              f", bound {bound_ms:.4f} ms ({bound_by})")
        walls.append((time.perf_counter() - t_rec, f"{kname} {r['tag']}"))
    for entry in out:
        kname = entry["name"]
        for x in records[kname]["extra"]:
            t_rec = time.perf_counter()
            (xms, by), (xplain, plain_by) = (device_ms(x["fn"]),
                                             device_ms(x["plain"]))
            xlib, lib_by = device_ms(x["library"]) if x["library"] \
                else (None, None)
            entry["other_shapes"].append({
                "shape": x["tag"], "max_abs_err": x["err"], "ms": xms,
                "plain_ms": xplain, "library_ms": xlib,
                "bound_ms": x["bound"][0], "bound_by": x["bound"][1],
                "timed_by": {"ms": by, "plain_ms": plain_by,
                             "library_ms": lib_by}})
            line = "[kernel]" if x["tag"].startswith(TNT_TAG) else "[time]"
            print(f"{line} {kname} {x['tag']} on {name} ({card}): device "
                  f"{xms:.4f} ms [{by}], plain {xplain:.4f} ms [{plain_by}], "
                  f"library "
                  f"{'n/a' if xlib is None else f'{xlib:.4f} ms [{lib_by}]'}"
                  f", bound {x['bound'][0]:.4f} ms ({x['bound'][1]})")
            walls.append((time.perf_counter() - t_rec, f"{kname} {x['tag']}"))
    print("[time] device, plain and library times are device time summed "
          "by torch.profiler over 20 calls (3 where a call takes over 5 "
          "ms, 1 over 20 ms), marked [profiler], or where the profiler "
          "dropped events, "
          "CUDA events around the calls, marked [cuda_events] (the host's "
          "launch rate for a callable of many launches); the per-call time "
          "is CUDA events around 50 back-to-back calls")
    print("[time] library yardsticks (never called by the port): "
          "vita_layer = cuBLAS matmuls + F.layer_norm + "
          "F.scaled_dot_product_attention + F.gelu (vita_layer_group: L "
          "of them in a row); vita_msa_batched = "
          "torch.matmul projections + F.scaled_dot_product_attention; "
          "fused_mlp = addmm + tanh-GELU + addmm; int8_matmul = "
          "torch._int_mm (int32 out, no rescale or epilogue; the per-head "
          "stack merged beforehand; none at the head's 8 rows: it takes "
          "more than 16); the attention launch alone (a sub-row of "
          "vita_msa_int8) = F.scaled_dot_product_attention in fp32 with "
          "the same additive mask; flash_attention = "
          "F.scaled_dot_product_attention (enable_gqa, boolean causal + "
          "window mask); decode_attention = the same with a length mask; "
          "the gated MLP = matmul + activation + multiply + matmul; none "
          "for the int8 layer, the int8 layer group, the int8 MSA and the "
          "RG-LRU scan")
    for tag, chain in I8_CHAINS:
        r = records["vita_layer_group_int8"]
        group = next(x for x in [r] + r["extra"] if x["tag"] == tag)
        g_ms, c_ms = group_chain_ms(group["fn"], chain)
        print(f"[time] vita_layer_group_int8 {tag} on {name} ({card}): "
              f"device {g_ms:.4f} ms against its L vita_layer_int8 calls "
              f"{c_ms:.4f} ms ({g_ms / c_ms:.3f}x; one profiler session)")
    for sweep in (i8_kgroups_sweep, flash_tiles_sweep, scan_walk_sweep):
        t_rec = time.perf_counter()
        sweep(records, f"{name} ({card})")
        walls.append((time.perf_counter() - t_rec, sweep.__name__))
    print(f"[phase] timing: {len(walls)} records and sweeps in "
          f"{sum(w for w, _ in walls):.1f} s; the slowest: " + "; ".join(
              f"{tag} {w:.1f} s" for w, tag in sorted(walls)[::-1][:8]))
    print(f"[phase] kernels timed at {time.perf_counter() - t_start:.0f} s")
    for lm_name, lm_cfg, lm_params in lm_served:
        lm_times(lm_name, lm_cfg, lm_params, f"{name} ({card})")
    del lm_served, lm_params
    release()
    # 7. The rest of the LM side: MoE, xLSTM, HuBERT's frames and
    # InternVL2's image tokens, each checked, counted and timed.  It runs
    # before phase 6, whose ranks' profiler sessions leave this process's
    # profiler dropping device events, and phase 7 profiles its paths.
    lm_rest = lm_rest_phase(where, t_start)
    for entry in out:
        entry["launches"] += sum(c[entry["name"]] for c in lm_rest.values())
    # 8. Training: Danube-1.8B at full size, the float32 twins, the CLI's
    # resume.  Before phase 6 too, which must stay last.
    train_counts = train_phase(where, t_start)
    for entry in out:
        entry["launches"] += train_counts[entry["name"]]
    # 9. The slice's paths: DeiT-S, the generic PTQ on kernel 4, kernel
    # 1's gradient, the HUE CLI, the dry run and the examples.  Before
    # phase 6 too.
    slice_counts = slice_phase(out, where, t_start)
    for entry in out:
        entry["launches"] += slice_counts[entry["name"]]
    # 6. The mesh on the card: ranks on this one card through gloo (NCCL
    # where every rank has a card of its own).  It runs last: after the
    # ranks' profiler sessions this process's profiler drops device
    # events, which would move every kernel time above onto CUDA events.
    mesh_counts = mesh_phase(served, params, quant, images, where, t_start)
    for entry in out:
        entry["launches"] += mesh_counts[entry["name"]]
    print(f"[phase] done at {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
