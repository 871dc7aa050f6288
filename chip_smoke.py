#!/usr/bin/env python3
"""Drive the PyTorch port's a2v-large serving paths (bf16 and the int8
modes), its finetune training path, its ViT-B/16 image serving path
(post-LN and pre-LN, bf16 and the int8 modes), its data2vec-2
pretraining paths (ViT-B/16 images and a2v-large audio), its training
entry point (train_cli: pretraining, finetuning from it, resume; then
infer_cli serving the finetuned checkpoint), its serving entry points
(convert_cli, export_cli, aot_cli bundles served without model code), data
parallelism and the recipes' training configuration (train_cli --config,
remat, the int8 teacher, dense-bias attention dropout, extra tokens),
and the rest of data2vec-2 pretraining (the probe, the shared decoder, the
target norms, the masking options, image reconstruction) once on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and exits non-zero:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build of the CUDA kernels from animal2vec_tpu_torch/csrc (nvcc, sm_90a);
3. the ALiBi serving kernel (#1) against its plain version at b4, T 2000,
   through the packed entry and through the model's (B, T, 3C) entry that
   it reads in place, with uniform positions and with per-row positions,
   sentinels and a padding mask that includes a fully padded row;
3b. the attention training kernels at b4, T 2000 with dropout 0.2 and one
   padded row: forward (out, lse), dq with the slope partials and dk/dv
   against their plain versions, and the training entry's gradients against
   autograd of the plain version; then, printed and not a gate, how many of
   8 seeded one-ulp moves of the lse push dk or dv past its tolerance
   (tools/bwd_check_margin.py);
3c. the dense-bias attention kernel against its plain version at b64, H 12,
   T 196: the batch-uniform 2-D ALiBi bias, a per-row bias, no bias, a key
   mask with one fully masked row; at b128 T 59 with a per-row bias and the
   lse; and at b8, T 1024;
3d. the dense-bias training kernels: the forward with lse, dq + dbias and
   dk/dv against their plain versions, and the autograd Function against
   autograd of the plain version, at the ViT-B/16 pretraining student's b128
   (64 x clone 2) x 59 kept patches with a per-row bias (there also the
   single backward launch for T <= 64, which the autograd Function takes,
   and each launch's device time), at b64 T 196 with the uniform 2-D ALiBi
   bias and with none, and at b8 T 1024 with a fully masked key row;
3e. the ALiBi training kernels (#2 with lse, #3, #4) at the a2v-large
   pretraining student's shape: b60 (5 x clone 12), 125 kept tokens at
   per-row keep-set positions, dropout 0.1 (with 3b's lse-move margin);
4. the fused post-LN block kernel against its plain version;
4b. the fused block with its three dropout sites at N = 4 x 2000: forward
   against the plain version, backward against autograd of the plain one;
4c. the int8 kernels against their plain versions, each with the count of
   elements that differ: the dense projection at N 8000 (K 1024 to 3072
   and 1024 outputs, K 768 to 2304 and 768), at N 64 000 (the first two)
   and at N 12 544 (the last two), with and without bias; the int8 block
   at N 8000; the int8 attention's quantization pass (equal to
   quantize_qkv_int8: 0 elements differ) and the attention at b4, T 2000
   (uniform; per-row positions, sentinels, mask), at T 4000 (two key
   spans) and at the int8_attn trunk's padded T 2048 with its padding
   mask;
4d. the plain fused MLP and its int8 twin at the image serving shape (N =
   64 x 196, C 768, M 3072; the int8 twin also with the count of elements
   that differ from its plain version, its time and the device time of each
   of its four launches), and the fused blocks of 4 and 4c at C 768;
5. the full a2v-large FinetuneModel (8 prenet + 16 trunk blocks, seeded
   random weights, bf16 serving cast): kernel path against plain path,
   launch counts per forward, no plain version called on a CUDA tensor;
6. the serving path: three synthetic recordings (25 s, 65 s, 130 s) served
   through infer_long_file in 10-s windows; then b32 throughput (with a
   sha256 of the b32 logits' bits, equal between trees whose serving
   outputs agree bit for bit); then 5
   and 6 again with the same weights served with matmul_impl int8 and
   int8_attn (logits also against the bf16 model's);
7. each kernel's time beside its plain version's, the PyTorch library
   call's (scaled_dot_product_attention with the ALiBi bias as a float
   mask; torch._int_mm for the int8 product) and the bound the card's peak
   rates set, at the serving shape and at the training shape, and the image
   kernels at the image serving shapes; the serving attention (#1, reading
   the (B, T, 3C) projection in place) and the training forward (#2 with
   lse and dropout, at b4) also by device time beside SDPA's, and the two
   GEMM launches of the fused block (#6, at b32, at the ViT-B/16 widths
   and, with dropout, at the training N 8000 and the pretraining student's
   N 7500) and of the plain fused MLP (#8, at the ViT-B/16 widths) by
   device time beside F.linear at the same shapes, all with achieved
   TFLOP/s; #1 (uniform in place, and per-row positions with a
   mask) and #6 are also held against their plain versions on the timed
   b32 inputs (N 64 000 for #6); the backward kernels (#3, #4) also
   beside SDPA's backward alone, at dropout 0 and at the a2v-large
   pretraining student's b60 T125, with achieved TFLOP/s, and the forward
   (#2 with lse and dropout) there beside SDPA's forward; the fused block
   at the a2v-large pretraining student's N 7500; the int8 dense
   projection also split by device time into its quantization and GEMM
   launches, the GEMM beside torch._int_mm's device time with TOP/s, also
   at the ViT-B/16 widths; the int8 block (#7) split by launch (LN1, fc1,
   the h quantization, fc2, LN2, with TOP/s) at b32 and at the ViT-B/16
   widths, and held against its plain version at N 64 000; the int8
   attention (#5) split into its quantization pass and kernel at b32 T
   2000 and at the int8_attn trunk's T 2048 with its padding mask, both
   held against the plain version (after the pass against
   quantize_qkv_int8); the int8 fused MLP (#9) split by launch (x
   quantization, fc1, h quantization, fc2, with TOP/s), also at a2v-large's
   widths (N 64 000, C 1024, M 4096: a pre-LN encoder's MLP in int8) beside
   torch._int_mm x 2 and held against its plain version; the dense-bias
   forward and SDPA also by device time; the dense-bias backward at the
   ViT-B/16 student's shape (dq + dbias, dk/dv and the single launch, each
   by device time) beside SDPA's backward alone;
8. the training path: the full a2v-large finetune model with the
   finetune_100.yaml recipe, three train steps on a b4 batch of 10-s
   windows with the freeze gate open, launch counts per step; then at b1
   with every rate at 0 the kernel path's gradients against the plain
   path's; ms per train step and b4 clips/s;
9. the image serving path: the ViT-B/16 image model (seeded random weights,
   bf16 serving cast, 2-D ALiBi bias) on b64 of 224 x 224 images through
   extract_features(imgs, "IMAGE"), with post-LN and pre-LN blocks, each in
   bf16, int8 and int8_attn: kernel path against plain path and the int8
   modes against bf16 (relative norm of the features), launch counts per
   forward, no plain version called on a CUDA tensor; images/s;
10. ViT-B/16 data2vec-2 pretraining (the image cell, ``PretrainConfig.
   vit_b16``: 4 prenet + 8 trunk blocks of 768, 196 patches, ``Decoder2d``
   384/5/16/5, post-LN): three steps on b64 images x clone 2 (finite loss
   and gradients, launch counts per step, no plain version on a CUDA
   tensor, the teacher subset of ``ema_param_label`` moved by exactly
   (1 - d)(s - t)), ms per step and images/s, peak memory; then at b2 with
   every rate at 0 the kernel path's gradients against the plain path's
   (the learned ALiBi scale included); then one pre-LN step (#8 in
   training);
11. a2v-large data2vec-2 pretraining with the a2v_large_pretrain.yaml
   recipe: three steps of update_freq 5 micro-batches of b5 10-s windows x
   clone 12 (the same checks; no dense-bias kernel), ms per step, clips/s
   and peak memory; then b1 x clone 2 gradients, kernel path against plain
   path;
12. the training entry point at a2v-large's width and depth on 24
   synthetic 10-s clips with .npz labels (18 train, 6 valid); first (12b)
   the batch loader over them at an 8-s crop and b5: ms per batch through
   the C++ decoder and the Python one, in training and evaluation, the
   native eval batches against the Python path's (source within 2e-4, the
   rest equal); then train_cli, whose loaders decode through the C++
   loader (its calls counted in every run):
   pretrains 2 steps (a2v_large_pretrain.yaml, update_freq 1: b5 x clone
   12), finetunes 3 steps from that checkpoint (finetune_100.yaml at b4,
   update_freq 1, gate open) with one validation at step 2 that writes
   best, and resumes to step 4; infer_cli --checkpoint best serves one 30-s
   recording. Checked: finite losses; each finetune step launches #2, #3,
   #4 and #6 once per block layerdrop kept (as phase 8), each pretraining
   step phase 11's launches, the validation and the serving forward #1
   and #6 once per block run; no plain version on a CUDA tensor; a fresh
   state restored from the step-3 checkpoint equal bit for bit to the live
   one; the resumed run starting at step 3 from the saved loader position;
   events served. Prints the seconds of each part, steps/s and clips/s;
13. the serving entry points at a2v-large's width and depth: a fairseq-named
   .pt made by the port's export_pretrain from a seeded pretraining model
   (a seeded head, a cfg entry of a class that cannot be imported) through
   convert_cli import --strict; export_cli over 24 synthetic 10-s clips at
   batch 12 with --data-parallel -1 and 1 (predictions and embeddings in
   npz: the card's machine has no h5py), the two outputs equal entry for
   entry, launches per run and clips/s; aot_cli to a bf16 and an int8_attn
   bundle at 16 x 10 s, each loaded by ServingBundle in a subprocess that
   must import no model code (load time, first call with the kernel
   library's load, launches of one forward counted by the custom ops:
   #1 and #6 24 each in bf16, #10 48, #5q, #5 and #7 24 each in int8_attn,
   no plain version on a CUDA tensor), its logits against the eager model's
   on the same batch (MODEL_TOL max abs in bf16, INT8_MODEL_REL relative
   norm in int8_attn; 0 expected) and its forward ms beside the eager one.
   Phase 12's train_cli runs each run in train_cli's default group: NCCL,
   one rank on the card (checked there);
14. data parallelism and ring attention:
   a. the in-process ring (ops/ring_attention.py) at b2, H 16, D 64, T 8000
      as 4 shards of 2000, the last 700 keys padded: 16 launches of #2 with
      its lse and the rotated key positions (counted), held against one #2
      launch over T 8000 and against the plain version (ATTN_TOL); the ring's
      ms against the one launch's; #2 with key positions timed at the shard
      shape beside its plain version, SDPA and its bound;
   b. two gloo ranks on the one card (tools/dryrun_multigpu.py): one
      a2v-large finetune step (finetune_100.yaml, every rate 0, mixup off,
      update_freq 2) at b4 per rank against one rank at b8 (each gradient
      leaf's relative gap, bound 0.1; parameter gap, bound 2.1 lr; loss;
      the ranks' parameter checksums equal; launches);
      one a2v-large post-LN block with hash dropout at every site on the
      same rows on both ranks (the masks differ) against the one-rank call
      on the stacked rows (each rank's output the slice of its global
      rows); then train_cli starting 2 workers with --dist-backend gloo at
      a2v-large's width, depth cut to 1 + 2 blocks: pretrain 2 steps,
      finetune 2 from it with a validation, resume to 3 (one checkpoint per
      save, every rank's loader state), infer_cli --checkpoint best; the
      2-rank validation's metrics against a 1-rank validation of the same
      checkpoint;
15. the recipes' training configuration:
   a. one a2v-large pretrain step at the v5e recipe's micro-batch (b8 x
      clone 12) from the same weights, draws and data under remat off,
      "mlp", "attn", "block" and remat_frontend + remat_decoder: loss and
      gradients against remat off (MODEL_GRAD_TOL per tensor; the tensors
      equal bit for bit counted), the recompute's extra launches, the
      median of three more steps' ms and their peak memory; then the b4
      finetune_100 step under "block" against the recipe's ("mlp"), equal;
   b. the EMA teacher with teacher_matmul_impl int8 and int8_attn on b2:
      its trunk output against the same teacher through the plain versions
      (INT8_MODEL_REL) and against the bf16 teacher (INT8_VS_BF16_REL), its
      launches a serving forward's (#7; #10, #5q, #5 and #7); after a step
      its targets equal bit for bit a model in that mode loaded from the
      merged weights;
   c. #11 and #11b with attention dropout 0.1 at b64 T 196 (the 2-D ALiBi
      bias) and b128 T 59 (per-row keep-set bias): every launch's keep mask
      read back through its outputs and equal to attention_keep's, out, lse,
      dq, dk, dv and dbias against the plain twin under that mask, the
      autograd Function against autograd of the plain twin, forward +
      backward ms beside the plain twin and SDPA with dropout_p 0.1 and the
      bound (phase 10's ViT-B/16 steps run at attention_dropout 0.1);
   d. one a2v-large pretrain step at b8 x clone 12 with an extra token,
      cls_loss 1 and per-layer ALiBi scales: finite losses, a cls term, the
      token's and every block's scale gradients non-zero;
   e. train_cli --config on a2v_large_pretrain_v5e.yaml at full width for
      2 steps and on the other five recipe copies at depth 1 + 2 for 1 step
      (JAX key names), on the 24 synthetic clips; each run's seconds;
16. the encoder's architecture and regularizer options at a2v-large width
   (phase_options): the changed kernels alone against their plain twins,
   #8 with its two hash-dropout sites at N 8000, C 1024, M 4096 (each
   site's keep mask read back and equal to hash_keep bit for bit), #6 with
   a drop-path branch scale at N 8000 (two samples at 0), #11 and #11b with
   no bias at b4 T 2000 (the dq and dk/dv routes against
   bias_attention_bwd_plain), then their times beside the library calls and
   bounds; variant P (PCEN after the windowed learnable sinc, the LayerNorm
   before the positional convs, pre-LN blocks without affine, one ALiBi
   scale for the heads) and variant N (no ALiBi, a plain first conv, the
   "default" extractor mode, post-LN): b2 serving logits kernel vs plain
   path, b32 serving clips/s, three b4 finetune_100 steps with drop-path
   0.1 (P: activation dropout 0.1 in #8) with their launches per block that
   ran and median ms, b2 gradients kernel vs plain path with drop-path and
   activation dropout on; both variants served in int8 and int8_attn (16i:
   b2 kernel vs plain path and against bf16, launches per block, b32
   clips/s; variant P's pre-LN blocks take #9 at a2v-large's widths, N
   takes #7 and #11 without bias, int8_attn adds #10 and, with ALiBi, #5
   on a trunk padded to 2048); one variant P pretrain step at b8 x clone 12 with
   the A.7 dropouts (ms, peak memory); the PCEN scan's ms and memory at b32
   serving and b4 training;
17. the rest of data2vec-2 pretraining (phase_a7): one a2v-large pretrain
   step at b8 x clone 12, remat "attn", with every audio option (the focal
   probe on frame labels with target mixup, a shared decoder 768/7/16/4
   with a 2-layer projection head, layer-normed target layers and targets
   at the blocks' ends, keep_masked_pct 0.1, mask_dropout 0.1,
   noise-filled student masks, local_grad_mult 0.5, a loss weight) beside
   the recipe's default step (losses, terms, launches, ms, peak memory); b1
   x clone 2 gradients kernel vs plain path with those options; one
   ViT-B/16 step with the reconstruction loss and the inverse mask (and
   its b2 gradients); train_cli --config pretraining with the probe and a
   shared decoder at depth 1 + 2, then finetuning from it with
   finetune.load_pretrain_weights (the head equal to the probe at step 0);
18. the bench/ tuning probes (animal2vec_tpu_torch/probes, phase_probes):
   each kernel against its plain twin, #12a (csrc/probe_attention.cu) in
   its four variants at both key tiles at b32 H16 T2048 with 48 padded
   positions and at a ragged b2 H3 T333 with 13, every row; #12b
   (csrc/probe_gemm.cu) at each shape and row tile; #12c
   (csrc/probe_mma.cu) at each shape by wgmma and by mma.sync; then the
   sweeps (probes.kernels, probes.pallas_mm, probes.attn_probe and
   probes.kernels2: ms, device ms, TFLOP/s, share of the bound, beside #1,
   #11, SDPA, cuBLAS and #6's and #8's GEMM launches), with the three
   wrappers' launches counted and no plain twin called on a CUDA tensor;
19. the sharded layouts (ROADMAP A.10, phase_a10): the tensor-parallel split
   of #6 (a2v_block_fc1, the fc2 partial, a2v_block_ln2) at N 8000, C 1024
   and a rank's 2048 hidden columns (col0 0 and 2048, with and without
   dropout) and #2-#4 on heads 8..15 of 16 (h0 8) at b4 T 2000 against
   their plain versions and, bit for bit, the whole calls' slices; their
   times beside the bound and F.linear / SDPA; then through
   tools/dryrun_multigpu.py at a2v-large's widths (prenet 2 + trunk 2, b4
   a data rank), each against one rank on the same global batch (2.1 lr on
   the parameters; each gradient leaf's relative gap within 0.1, FSDP2's
   against data parallelism on the same split):
   tensor parallelism and the GPipe trunk as 2 gloo ranks on the card in
   one launch with FSDP2 (the pipeline's boundary through host tensors;
   each rank's masks against the whole calls; gloo on the card takes CUDA
   tensors in FSDP2's all_gather_into_tensor and reduce_scatter_tensor);
   ms per step and peak memory per rank beside one rank;
20. every trunk width the JAX package runs (ROADMAP A.11, phase_widths):
   20k #6, its split #6s (with dropout) and #7 at N 64 000, C 1280, M 5120
   (the LayerNorm's wide instance past C 1024, its registers and spills
   from ptxas), #6 at N 8000 with dropout, #1 at H 20 and #10 at K 1280,
   each against its plain version, timed beside its bound and F.linear x 2
   / SDPA / torch._int_mm; W (a2v's finetune_100 model at the Whisper
   large-v3 encoder's widths, C 1280, H 20, 24 blocks) and T (DeiT-Ti's, C
   192, H 3, every width off 128: JAX's composed MLP and int8 routes, no
   launch of #6-#10) served in bf16, int8 and int8_attn (b2 kernel vs plain
   path, launches asserted, one timed b32 forward); T's pre-LN image model
   at b64 in bf16 and int8 (#11 only); W's and T's b4 finetune_100 steps
   and W's b4 gradients against the plain path;
21. the attention kernels' head dims (ROADMAP A.11, phase_head_dims): 21k
   #1-#5, #5q, #11 and #11b at D 32, 80, 96, 120, 128 and 36 against their
   plain versions (the training kernels at b4 T 2000, the serving ones at
   b32 T 2000, #11 / #11b at b64 T 196 and b128 T 59), timed at D 80 and
   128 beside their bounds at the true D and SDPA, the two-tile instances'
   registers and spills from ptxas; XLS-R 1B's widths (C 1280, H 16, D 80)
   served in the three modes and stepped at b4 with its b4 gradients
   against the plain path; XLS-R 2B's (C 1920, D 120, 12 blocks) served
   in bf16; a2v-large at 8 heads (D 128) served, its b4 gradients;
   ViT-H/14's widths (C 1280, H 16, D 80, patch 14) served at b64 pre-LN
   and pretrained post-LN (one b64 x clone 2 step, b2 gradients);
22. JAX's default compute dtype, fp32, on the card (ROADMAP A.13's first
   slice, phase_fp32): 22k the fp32 instances (each fp32 product three bf16
   products of the operands' hi and lo parts) of #1 at b32 T 2000 in place,
   #2-#4 at b4 T 2000 with dropout 0.2 and at the pretraining student's
   b60 T 125 keep-set positions, at D 64 and 128, and #6 at N 64 000 and N
   8000 with dropout 0.1, against their plain versions in fp32 at a tenth
   of each bf16 gate, each timed (CUDA events, device time) beside the
   bf16 instance on the same values, the plain version, the library call in
   fp32 with TF32 off (SDPA with the ALiBi bias as a float mask; F.linear
   x 2), the fp32 bound (TF32 peak) and the split design's floor, with the
   instances' registers, spills and shared memory; 22s (ROADMAP C.1) #3's
   slope partials of the bf16 and fp32 instances and the plain path's
   slope gradient in bf16 against float64 at 17b's shape; 22b train_cli
   --config finetune_100.yaml common.compute_dtype=float32 for 3 steps at
   full width (losses, ms, peak memory, launches) and the b1 fp32 gradients
   against the plain path (5e-3 per tensor); 22a the fp32 a2v-large model
   (build_finetune_model's default dtype) at b2 against the plain path
   (2e-3 max abs) and the bf16 model (printed), b32 clips/s, and
   export_cli --dtype float32 from 22b's checkpoint; 22c train_cli
   --config a2v_large_pretrain.yaml common.compute_dtype=float32 for 2
   steps (ms, peak memory, student and teacher launches).

The last two lines are a JSON object describing the kernels and
{"ok": true, "device": {...}}. Needs CUDA; exits 1 without it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
WAV_LEN = 80_000  # 10 s at 8 kHz
# bf16 outputs: one rounding to bf16 (2^-9 relative) on each side plus fp32
# sums in another order, and for the block a bf16 residual add that can
# round the other way; a few bf16 ulps of values up to ~8.
ATTN_TOL = (1e-2, 1e-2)   # atol, rtol vs the plain version in fp32
BLOCK_TOL = (3e-2, 2e-2)  # atol, rtol vs the plain version (bf16 storage)
# max abs logits, kernel path vs plain path: about 3x the gap measured on an
# H100 (6.6e-3 at random-init logits up to ~0.3), so that a broken block or
# attention kernel also fails the full-model comparison
MODEL_TOL = 2e-2
SERVE_SECONDS = (25, 65, 130)
TRAIN_BATCH, DROP_SEED, ATTN_DROP = 4, -123457, 0.2
# training kernels against their plain versions on the same bf16 inputs and
# the same lse and delta; lse is an fp32 sum of exponentials in another
# order. The backward reference rounds P * f, dS and dq, dk, dv to bf16 at
# the kernels' points, so what is left is fp32 summation order and the rare
# bf16 rounding it flips: one output ulp (2^-8 to 2^-7 relative, under the
# rtol) and a small atol for values near 0. Measured on an H100: max abs
# 7.8e-3 for each of dq, dk, dv at |values| up to 30, worst ratio to this
# tolerance 0.50; per-(b, h) relative norm at most 2.2e-4 (tolerance ~5x).
LSE_TOL = (1e-3, 1e-5)
BWD_TOL = (5e-3, 1e-2)
# the dense bias's gradient dS = P (dP - delta) is fp32 on both sides; what
# is left is the fp32 order of dP's sums. A typical |dS| is about 8 / T
# (8e-3 at T 1024), so the atol stays far below it: a dS that is mostly 0
# fails. Measured on an H100: max abs 4.3e-6.
DBIAS_TOL = (1e-5, 1e-2)
REL_HEAD = 1e-3
SLOPE_PART_TOL = (1e-2, 1e-3)  # fp32 sums of up to 64 x T terms
LSE_MOVES = 8  # seeded one-ulp moves of the lse behind the printed dk/dv margin
# relative norm of a gradient against autograd of the plain version in
# fp32 on the same bf16 inputs: bf16 rounding of P, dS and the outputs,
# 2^-9 each (about 2.5e-3 measured for dqkv, 3e-6 for the slopes)
REL_QKV, REL_SLOPES = 1e-2, 1e-3
REL_BLOCK = 1e-2  # fused block backward: bf16 GEMM recompute vs fp32 plain
# full-model gradients, kernel path against plain path at b1, relative norm
# per parameter tensor: about 5x the largest measured on an H100 (1.0e-2,
# the ALiBi scale's; median 1.3e-3), so that a wrong mask or a wrong
# backward product (errors of order 1) fails
MODEL_GRAD_TOL = 5e-2
# int8 kernels against their plain versions on the same inputs: the int32
# sums are exact on both sides and the quantizers the same torch code, so
# what is left is the fp32 order of the dequant and the sums, exp and erf
# (a value at an int8 rounding boundary lands one step apart and moves its
# row by a step of the next product) and the bf16 output rounding.
INT8_DENSE_TOL = (1e-2, 1e-2)
INT8_BLOCK_TOL = BLOCK_TOL
INT8_ATTN_TOL = (2e-2, 2e-2)
# full a2v-large int8 models at b2, relative norm of the logits: kernel path
# against plain path (int8 roundings that land apart compound over 24
# layers), and each int8 mode against the bf16 model on the same weights
INT8_MODEL_REL = 5e-2
INT8_VS_BF16_REL = 0.3
MODES = ("int8", "int8_attn")
# the image modality (ViT-B/16 data2vec-2 features, 2-D ALiBi bias): b64 of
# 224 x 224 images, 196 patches. The dense-bias attention is held as the
# ALiBi one (ATTN_TOL), the plain fused MLP as the fused block (BLOCK_TOL)
# and its int8 twin as the int8 block (INT8_BLOCK_TOL).
IMAGE_BATCH, IMAGE_T, IMAGE_HEADS = 64, 196, 12
# a ViT-B/16 pretraining student keeps 196 - int(196 * 0.7) = 59 patches
STUDENT_T = IMAGE_T - int(IMAGE_T * 0.7)
# the teacher's EMA step against torch.lerp(t, s, 1 - d) on the same fp32
# tensors: a few ulps of parameters below 1 in magnitude
EMA_TOL = 1e-6
# the full model's features x, kernel path against plain path, relative
# norm: bf16 roundings in another order through 12 blocks (measured on an
# H100: 8.1e-3 post-LN, 9.6e-3 pre-LN); int8 roundings that land apart
# compound until the two paths differ by about the int8 noise itself
# (measured: 1.7e-2 to 1.9e-2 post-LN; 3.9e-2 to 4.1e-2 pre-LN, whose
# blocks add no residual, against 3.8e-2 to 4.2e-2 from the bf16 model).
# About 3x and 2.5x those, so that a wrong mask, scale or product (an error
# of order 1) fails; each int8 mode also against the bf16 model on the same
# weights (INT8_VS_BF16_REL)
IMAGE_REL, IMAGE_INT8_REL = 3e-2, 0.1
# the same for the 24 pre-LN blocks of the encoder's variant P served in
# int8 (phase 16i): its kernel and plain paths lie about as far apart as
# the int8 noise itself (measured on an H100: 4.87e-2 int8 and 5.20e-2
# int8_attn, against 5.64e-2 and 6.78e-2 from the bf16 model; #9 at these
# widths equals its plain version in every element), so they are held at
# IMAGE_INT8_REL, and against the bf16 model at INT8_VS_BF16_REL
PRE_LN_INT8_REL = IMAGE_INT8_REL
IMAGE_MODES = ("bf16",) + MODES
# the H100 SXM data sheet's dense peaks (at 700 W)
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_BYTES = 989e12, 1979e12, 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(log: str):
    """One line per compiled kernel from nvcc's -Xptxas -v report: the
    kernel, its template arguments (bools and ints), registers, spills and
    shared memory."""
    name, spills = None, ""
    for line in log.splitlines():
        entry = re.search(
            r"Compiling entry function '[^']*?(\d+)([a-z][a-z_0-9]*_kernel)(I[^']*?E)?E", line)
        if entry:
            flags = re.findall(r"L[bi](\d+)E", entry.group(3) or "")
            if re.search(r"(^I|E)f[EL]", entry.group(3) or ""):
                flags.append("f32")  # a float type argument: an fp32 instance or output
            name = entry.group(2) + (f"<{','.join(flags)}>" if flags else "")
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and name:
            yield f"{name}: {line.split(':', 1)[1].strip()}; {spills}"
            name = None


def check_close(name, got, want, tol):
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    max_err = err.max().item()
    print(f"{name}: max_abs_err {max_err:.3e} (tolerance {atol} + {rtol}*|plain|), "
          f"worst ratio {(err / bound).max().item():.3f}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if not (err <= bound).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_err


# phase 21's backward checks at head dims other than 64: BWD_TOL for every
# element, save a share of at most BWD_FLIP_SHARE of them within
# BWD_FLIP_FACTOR of it, with every head's relative norm within REL_HEAD.
# The elementwise check is one rounding from failing at D 64 as well:
# seeded one-ulp moves of the lse put #4's dv at 1.045 of it at b4 T 2000
# on an H100 (tools/bwd_check_margin). A bf16 rounding of one dS term that
# lands a step apart moves one dk element by scale |q| 2^-8 |dS|, a few
# thousandths: at D 32 one element of 4 096 000 lay at 1.52 of it, while
# every head's relative norm was at most 3.9e-4 (the same card).
BWD_FLIP_SHARE, BWD_FLIP_FACTOR = 1e-5, 2.0


def check_close_flips(name, got, want, tol):
    """check_close, admitting roundings that land a step apart: at most
    BWD_FLIP_SHARE of the elements beyond the tolerance, none beyond
    BWD_FLIP_FACTOR of it."""
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    ratio = err / (atol + rtol * want.float().abs())
    over = (ratio > 1).sum().item()
    worst = ratio.max().item()
    print(f"{name}: max_abs_err {err.max().item():.3e} (tolerance {atol} + {rtol}*|plain|), "
          f"worst ratio {worst:.3f}, {over} of {ratio.numel()} elements over it (at most "
          f"{BWD_FLIP_SHARE:g} of them, within {BWD_FLIP_FACTOR} of it)")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if worst > BWD_FLIP_FACTOR or over > BWD_FLIP_SHARE * ratio.numel():
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err.max().item()


def rel_norm(got, want) -> float:
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def check_rel(name, got, want, tol):
    rel = rel_norm(got, want)
    print(f"{name}: relative norm error {rel:.3e} (tolerance {tol})")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite result")
    if not rel <= tol:
        raise AssertionError(f"{name}: disagrees with its reference")
    return rel


def check_heads(name, labels, gots, wants, tol, ulps=0):
    """Relative norm error per (b, h) of each (B, H, T, D) gradient, so that
    a fault confined to a few heads cannot hide in a global norm or under
    an atol sized for the largest values (norms below 1e-3 count as 1e-3).
    ``ulps`` admits that many bf16 steps (2^-8) of a head's largest value on
    top of ``tol``: in a head of a few thousand values one rounding that
    lands a step apart moves the relative norm by up to 2^-8 times the
    largest value over the norm (measured on an H100: 1.5e-3 at T 59)."""
    for label, got, want in zip(labels, gots, wants):
        want = want.float().flatten(2)
        norm = want.norm(dim=-1).clamp_min(1e-3)
        rel = (got.float().flatten(2) - want).norm(dim=-1) / norm
        allowed = tol + ulps * 2.0**-8 * want.abs().amax(dim=-1) / norm
        worst = rel.max().item()
        print(f"{name} {label}: relative norm error per (b, h) max {worst:.3e}, "
              f"median {rel.median().item():.3e} (tolerance {tol}"
              + (f" + {ulps} bf16 steps of the head's largest value; worst ratio "
                 f"{(rel / allowed).max().item():.3f})" if ulps else ")"))
        if not (rel <= allowed).all():
            raise AssertionError(f"{name} {label}: a head disagrees with its plain version")


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(bound ms, what bounds it): the larger of operations over the tensor
    peak of their type (bf16 unless given) and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bounds(b, h, t, d):
    """Bounds of the serving forward, the forward with lse, dq and dk/dv
    kernels: 2, 2, 3 and 4
    products of 2*T^2*D per (b, h); each input read once (bf16 q, k, v, dO;
    fp32 lse, delta), each output written once."""
    bhtd, bht = b * h * t * d, b * h * t
    flops = 2 * bhtd * t
    return {
        "serve": bound(2 * flops, 2 * 3 * bhtd + 2 * bhtd),
        "forward": bound(2 * flops, 2 * 3 * bhtd + 2 * bhtd + 4 * bht),
        "dq": bound(3 * flops, 2 * 4 * bhtd + 2 * 4 * bht + 2 * bhtd + 4 * b * h * -(-t // 64)),
        "dkv": bound(4 * flops, 2 * 4 * bhtd + 2 * 4 * bht + 2 * 2 * bhtd),
    }


def block_bound(n, c=1024, m=4096):
    """fc1 and fc2 (2*N*C*M each); x read, x_out and t written, bf16 weights
    and fp32 vectors read once."""
    return bound(4 * n * c * m, 2 * n * c * 3 + 2 * 2 * c * m + 4 * (5 * c + m))


def int8_dense_bound(n, k, m):
    """x (bf16) read, W (int8) and its fp32 scales read, y (bf16) written;
    2*N*K*M int8 operations."""
    return bound(2 * n * k * m, 2 * n * k + k * m + 4 * m + 2 * n * m, PEAK_INT8_OPS)


def int8_block_bound(n, c=1024, m=4096):
    """fc1 and fc2 in int8 (2*N*C*M each); x read, x_out and t written, int8
    weights and fp32 vectors read once."""
    return bound(4 * n * c * m, 2 * n * c * 3 + 2 * c * m + 4 * (6 * c + 2 * m), PEAK_INT8_OPS)


def int8_attention_bound(b, h, t, d):
    """Q.K^T and P.V in int8 (2*T^2*D each per (b, h)); bf16 q, k, v read and
    out written."""
    return bound(4 * b * h * t * t * d, 2 * 4 * b * h * t * d, PEAK_INT8_OPS)


def bias_attention_bound(b, h, t, d, bias_planes=1):
    """Q.K^T and P.V (2*T^2*D each per (b, h)); bf16 q, k, v read and out
    written, the fp32 bias planes read once."""
    return bound(4 * b * h * t * t * d, 2 * 4 * b * h * t * d + 4 * bias_planes * h * t * t)


def mlp_bound(n, c, m):
    """fc1 and fc2 (2*N*C*M each); x read and out written, bf16 weights and
    fp32 biases read once."""
    return bound(4 * n * c * m, 2 * n * c * 2 + 2 * 2 * c * m + 4 * (m + c))


def int8_mlp_bound(n, c, m):
    """fc1 and fc2 in int8 (2*N*C*M each); x read and out written, int8
    weights and their fp32 scales and biases read once."""
    return bound(4 * n * c * m, 2 * n * c * 2 + 2 * c * m + 4 * 2 * (m + c), PEAK_INT8_OPS)


def sdpa_args(qkv, slopes, t, requires_grad=False):
    """q, k, v (B, H, T, D) and the ALiBi bias as a (1, H, T, T) float mask
    in the inputs' dtype, for torch's scaled_dot_product_attention."""
    q, k, v = (x.detach().clone().requires_grad_(requires_grad) for x in qkv.unbind(0))
    pos = torch.arange(t, device=qkv.device, dtype=torch.float32)
    dist = (pos[:, None] - pos[None, :]).abs()
    bias = (-dist[None, None] * slopes.float()[None, :, None, None]).to(qkv.dtype)
    return q, k, v, bias


def cuda_ms(fn, iters=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(gen, b, h, t, dev, d=64):
    qkv = torch.randn((3, b, h, t, d), generator=gen, device=dev).to(torch.bfloat16)
    from animal2vec_tpu_torch.ops.alibi import alibi_slopes

    slopes = torch.from_numpy(alibi_slopes(h).copy()).to(dev)
    return qkv, slopes


def phase_attention(dev):
    """3. The serving kernel (#1) through the packed entry and through the
    model's (B, T, 3C) entry, which it reads in place: uniform positions,
    then per-row positions with sentinels and a mask."""
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_plain, alibi_flash_attention_btc, alibi_flash_attention_packed,
    )

    def in_place(qkv, slopes, pos, mask, sentinel):
        """The (B, T, 3C) projection layout through the model's entry, its
        (B, T, C) output as (B, H, T, D)."""
        _, b, h, t, d = qkv.shape
        qkv_btc = qkv.permute(1, 3, 0, 2, 4).reshape(b, t, 3 * h * d)
        with torch.inference_mode():
            out = alibi_flash_attention_btc(qkv_btc, h, slopes, pos, mask, sentinel)
        return out.reshape(b, t, h, d).transpose(1, 2)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, h, t = 4, 16, 2000
    qkv, slopes = attention_inputs(gen, b, h, t, dev)
    pos = torch.arange(t, dtype=torch.int32, device=dev)[None]
    got = alibi_flash_attention_packed(qkv, slopes, pos, None, False)
    want = alibi_attention_plain(qkv.float(), slopes, pos, None, False)
    torch.cuda.synchronize()
    err_uniform = check_close("attention uniform (4,16,2000,64)", got, want, ATTN_TOL)
    got = in_place(qkv, slopes, pos, None, False)
    torch.cuda.synchronize()
    err_uniform = max(err_uniform, check_close("attention uniform, (B, T, 3C) read in place",
                                               got, want, ATTN_TOL))

    # per-row positions: sorted random keep-sets of 0..2499, two sentinel
    # (extra-token) positions in front; row 2 pads its last 300 keys, row 3
    # pads every key
    rng = np.random.default_rng(SEED)
    rows = [np.sort(rng.choice(2500, t - 2, replace=False)) for _ in range(b)]
    pos_rows = np.stack([np.concatenate([[-1, -1], r]) for r in rows]).astype(np.int32)
    mask = np.zeros((b, t), bool)
    mask[2, -300:] = True
    mask[3] = True
    pos_rows = torch.from_numpy(pos_rows).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    got = alibi_flash_attention_packed(qkv, slopes, pos_rows, mask, True)
    want = alibi_attention_plain(qkv.float(), slopes, pos_rows, mask, True)
    torch.cuda.synchronize()
    err_rows = check_close("attention per-row + sentinel + mask", got, want, ATTN_TOL)
    got = in_place(qkv, slopes, pos_rows, mask, True)
    torch.cuda.synchronize()
    err_rows = max(err_rows, check_close("attention per-row + sentinel + mask, (B, T, 3C) read "
                                         "in place", got, want, ATTN_TOL))
    return max(err_uniform, err_rows)


def train_attention_inputs(dev):
    """b4 x T 2000 x 16 heads bf16 qkv, slopes, uniform positions, row 1
    padding its last 300 keys, and a seeded cotangent."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    b, h, t = TRAIN_BATCH, 16, 2000
    qkv, slopes = attention_inputs(gen, b, h, t, dev)
    pos = torch.arange(t, dtype=torch.int32, device=dev)[None]
    mask = torch.zeros((b, t), dtype=torch.bool, device=dev)
    mask[1, -300:] = True
    dout = torch.randn((b, h, t, 64), generator=gen, device=dev).to(torch.bfloat16)
    return qkv, slopes, pos, mask, dout


def phase_attention_train(dev):
    """3b. The training kernels at b4, T 2000, dropout 0.2, row 1 padded."""
    qkv, slopes, pos, mask, dout = train_attention_inputs(dev)
    b, h, t = qkv.shape[1:4]
    return check_attention_train(f"attention training (b{b}, T {t}, dropout {ATTN_DROP}, "
                                 f"row 1 padded)", qkv, slopes, pos, mask, dout,
                                 (ATTN_DROP, DROP_SEED))


def phase_student_attention(dev):
    """3e. The ALiBi training kernels at the a2v-large pretraining student's
    shape: b60 (5 clips x clone 12), 125 kept tokens per row at their own
    positions (sorted keep-sets of 0..1999), 16 heads, dropout 0.1."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    b, h, t = 60, 16, 125
    qkv, slopes = attention_inputs(gen, b, h, t, dev)
    rng = np.random.default_rng(SEED + 13)
    pos = torch.from_numpy(np.stack([np.sort(rng.choice(2000, t, replace=False))
                                     for _ in range(b)]).astype(np.int32)).to(dev)
    dout = torch.randn((b, h, t, 64), generator=gen, device=dev).to(torch.bfloat16)
    return check_attention_train(f"attention pretraining student (b{b}, T {t}, keep-set "
                                 f"positions, dropout 0.1)", qkv, slopes, pos, None, dout,
                                 (0.1, DROP_SEED + 1))


def check_attention_train(name, qkv, slopes, pos, mask, dout, drop, extras=True):
    """The forward with lse, dq with the slope partials and dk/dv against
    their plain versions, and (``extras``) the dk/dv check's lse-move margin
    and the training entry against autograd of the plain version; without
    ``extras`` (phase 21's head dims) dq, dk and dv by check_close_flips.
    Returns the forward, dq and dk/dv errors."""
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_plain, alibi_flash_attention_packed, attention_bwd_plain,
        attention_dkv, attention_dq,
    )

    b, h, t, d = qkv.shape[1:]
    out, lse = alibi_flash_attention_packed(qkv, slopes, pos, mask, False, *drop,
                                            return_lse=True)
    out_p, lse_p = alibi_attention_plain(qkv.float(), slopes, pos, mask, False, *drop,
                                         return_lse=True)
    torch.cuda.synchronize()
    err_fwd = check_close(f"{name} out", out, out_p, ATTN_TOL)
    check_close(f"{name} lse", lse, lse_p, LSE_TOL)
    del out_p, lse_p
    delta = (dout.float() * out.float()).sum(-1).reshape(b * h, t)
    args = (qkv, dout, lse, delta, slopes, pos, mask, False, *drop)
    dq, parts = attention_dq(*args)
    dk, dv = attention_dkv(*args)
    # the reference on the same bf16 qkv and dout rounds P * f, dS and its
    # outputs to bf16 where the kernels round them
    want, parts_p = attention_bwd_plain(*args)
    torch.cuda.synchronize()
    close = check_close if extras else check_close_flips
    err_dq = close(f"{name} dq", dq, want[0], BWD_TOL)
    err_dkv = max(close(f"{name} dk", dk, want[1], BWD_TOL),
                  close(f"{name} dv", dv, want[2], BWD_TOL))
    check_heads(name, ("dq", "dk", "dv"), (dq, dk, dv), want, REL_HEAD)
    check_close(f"{name} slope partials", parts, parts_p, SLOPE_PART_TOL)
    del want, parts_p
    if not extras:
        return err_fwd, err_dq, err_dkv
    # how far the dk/dv check sits from its tolerance when the lse moves by
    # one ulp (ROADMAP C): printed, not a gate
    from animal2vec_tpu_torch.tools.bwd_check_margin import lse_move_ratios

    moved = lse_move_ratios(args, LSE_MOVES)[1:]
    print(f"{name} dk/dv lse-move margin over {LSE_MOVES} seeded one-ulp moves of the lse: "
          + "; ".join(f"{what} worst ratio {max(r[i] for r in moved):.3f}, "
                      f"{sum(r[i] > 1 for r in moved)} of {LSE_MOVES} over 1"
                      for i, what in enumerate(("dk", "dv"))))
    # the autograd Function against autograd of the plain version: the same
    # seeded cotangent, the plain version in fp32 on the same bf16 inputs
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_btc_plain, alibi_flash_attention_btc,
    )

    qkv_btc = qkv.permute(1, 3, 0, 2, 4).reshape(b, t, 3 * h * d)
    g = dout.permute(0, 2, 1, 3).reshape(b, t, h * d)
    x, s = qkv_btc.clone().requires_grad_(), slopes.clone().requires_grad_()
    gx, gs = torch.autograd.grad(
        alibi_flash_attention_btc(x, h, s, pos, mask, False, *drop), (x, s), g)
    xf, sf = qkv_btc.float().requires_grad_(), slopes.clone().requires_grad_()
    gxf, gsf = torch.autograd.grad(
        alibi_attention_btc_plain(xf, h, sf, pos, mask, False, *drop), (xf, sf), g.float())
    check_rel(f"{name} d qkv vs autograd of plain", gx, gxf, REL_QKV)
    check_rel(f"{name} d slopes vs autograd of plain", gs, gsf, REL_SLOPES)
    return err_fwd, err_dq, err_dkv


def block_inputs(gen, n, c, m, dev):
    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    x = rnd(n, c).to(torch.bfloat16)
    w1 = rnd(c, m, scale=(2.0 / (c + m)) ** 0.5).to(torch.bfloat16)
    w2 = rnd(m, c, scale=(2.0 / (c + m)) ** 0.5).to(torch.bfloat16)
    return (x, rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1), w1, w2,
            rnd(m, scale=0.1), rnd(c, scale=0.1), rnd(c, scale=0.1, shift=1.0),
            rnd(c, scale=0.1), 1e-5)


def phase_block(dev):
    from animal2vec_tpu_torch.ops.fused_mlp import fused_block_mlp, fused_block_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    args = block_inputs(gen, 4 * 2000, 1024, 4096, dev)
    xo, t = fused_block_mlp(*args)
    xo_p, t_p = fused_block_plain(*args)
    torch.cuda.synchronize()
    err_t = check_close("fused block tap t (8000,1024,4096)", t, t_p, BLOCK_TOL)
    err_x = check_close("fused block x_out (8000,1024,4096)", xo, xo_p, BLOCK_TOL)
    return max(err_t, err_x)


def phase_block_train(dev):
    from animal2vec_tpu_torch.ops.fused_mlp import fused_block_mlp, fused_block_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    n = TRAIN_BATCH * 2000
    args = block_inputs(gen, n, 1024, 4096, dev)
    drop = ((11, -22, 2**31 - 5), 0.1, 0.1)
    xo, t = fused_block_mlp(*args, *drop)
    xo_p, t_p = fused_block_plain(*args, *drop)
    torch.cuda.synchronize()
    name = f"fused block training (N {n}, act and post dropout 0.1)"
    err = max(check_close(f"{name} tap t", t, t_p, BLOCK_TOL),
              check_close(f"{name} x_out", xo, xo_p, BLOCK_TOL))
    cot = tuple(torch.randn(xo.shape, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
    leaves = [a.clone().requires_grad_() if isinstance(a, torch.Tensor) else a for a in args]
    g1 = torch.autograd.grad(fused_block_mlp(*leaves, *drop), leaves[:9], cot)
    leaves_p = [a.clone().requires_grad_() if isinstance(a, torch.Tensor) else a for a in args]
    g2 = torch.autograd.grad(fused_block_plain(*leaves_p, *drop), leaves_p[:9], cot)
    for label, x, y in zip(("x", "ln1 scale", "ln1 bias", "w1", "w2", "b1", "b2", "ln2 scale",
                            "ln2 bias"), g1, g2):
        check_rel(f"{name} grad {label} vs autograd of plain", x, y, REL_BLOCK)
    return err


# the model's kernel entries, by the models/ module that looks each up, and
# their plain versions in ops/
PLAIN_OF = {
    ("attention", "alibi_flash_attention_btc"): ("attention", "alibi_attention_btc_plain"),
    ("attention", "bias_flash_attention"): ("bias_attention", "bias_attention_plain"),
    ("modules", "fused_block_mlp"): ("fused_mlp", "fused_block_plain"),
    ("modules", "fused_block_int8"): ("fused_mlp", "fused_block_int8_plain"),
    ("modules", "int8_dense"): ("int8_mm", "int8_dense_plain"),
    ("modules", "alibi_flash_attention_int8"): ("attention", "alibi_attention_int8_plain"),
    ("modules", "fused_mlp"): ("fused_mlp", "fused_mlp_plain"),
    ("modules", "fused_mlp_int8"): ("fused_mlp", "fused_mlp_int8_plain"),
}


# the probes' plain twins (phase 18), by their modules under the package
PROBE_PLAIN = (("probes.kernels", "attn_v2_plain"), ("probes.pallas_mm", "row_gemm_plain"),
               ("probes.attn_probe", "mma_probe_plain"))


def _swap(module, names):
    saved = {n: getattr(module, n) for n in names}
    for n, f in names.items():
        setattr(module, n, f)
    return saved


def int8_block_inputs(gen, n, dev, c=1024, m=4096):
    """block_inputs with its weights quantized, in the int8 entry's order."""
    from animal2vec_tpu_torch.ops.int8_mm import quantize_weight

    x, l1s, l1b, w1, w2, b1, b2, l2s, l2b, eps = block_inputs(gen, n, c, m, dev)
    w1_q, w1_s = quantize_weight(w1.t())  # (M, C): nn.Linear layout
    w2_q, w2_s = quantize_weight(w2.t())
    return x, l1s, l1b, w1_q, w1_s, b1, w2_q, w2_s, b2, l2s, l2b, eps


def int8_attention_inputs(gen, b, h, t, dev, d=64):
    """(B, T, H, D) bf16 q, k, v views of one (B, T, 3C) projection, as the
    model hands them over, and the ALiBi slopes."""
    from animal2vec_tpu_torch.ops.alibi import alibi_slopes

    qkv = torch.randn((b, t, 3, h, d), generator=gen, device=dev).to(torch.bfloat16)
    slopes = torch.from_numpy(alibi_slopes(h).copy()).to(dev)
    return (*qkv.unbind(2), slopes)


def check_int8_block(label, args):
    """#7 against its plain version on the same inputs (tap t and x_out),
    with the count of elements that differ; returns the larger error."""
    from animal2vec_tpu_torch.ops.fused_mlp import fused_block_int8, fused_block_int8_plain

    (xo, t), (xo_p, t_p) = fused_block_int8(*args), fused_block_int8_plain(*args)
    torch.cuda.synchronize()
    err = max(check_close(f"int8 block tap t {label}", t, t_p, INT8_BLOCK_TOL),
              check_close(f"int8 block x_out {label}", xo, xo_p, INT8_BLOCK_TOL))
    print(f"int8 block {label}: {(t != t_p).sum().item()} of {t.numel()} tap and "
          f"{(xo != xo_p).sum().item()} x_out elements differ from the plain version")
    return err


def check_int8_attention(label, q, k, v, slopes, pos, mask=None, sentinel=True):
    """#5 against its plain version on the same inputs, with the count of
    elements that differ, after its quantization pass against the pass's
    plain version (quantize_qkv_int8's values, which must be equal: 0
    elements differ); returns the error."""
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_int8_plain, alibi_flash_attention_int8, int8_spans,
        quantize_qkv_int8_pass, quantize_qkv_int8_pass_plain,
    )

    t_pad = int8_spans(q.shape[1])[1]
    got = quantize_qkv_int8_pass(q, k, v, t_pad)
    want = quantize_qkv_int8_pass_plain(q, k, v, t_pad)
    differ = sum((a != w).sum().item() for a, w in zip(got, want))
    print(f"int8 q, k, v quantization pass {label}: {differ} elements differ from "
          f"quantize_qkv_int8's")
    if differ:
        raise AssertionError(f"{label}: the quantization pass is not quantize_qkv_int8's")
    del got, want
    out = alibi_flash_attention_int8(q, k, v, slopes, pos, mask, sentinel)
    ref = alibi_attention_int8_plain(q, k, v, slopes, pos, mask, sentinel)
    torch.cuda.synchronize()
    err = check_close(f"int8 attention {label}", out, ref, INT8_ATTN_TOL)
    print(f"int8 attention {label}: {(out != ref).sum().item()} of {out.numel()} elements "
          f"differ from the plain version")
    return err


def padded_trunk_mask(b, t, dev, t_pad=2048):
    """The int8_attn model's trunk at T 2048: t frames padded to t_pad, the
    pad frames masked, and row 1 also masking its last 500 frames."""
    mask = torch.zeros((b, t_pad), dtype=torch.bool, device=dev)
    mask[:, t:] = True
    mask[1, t - 500:] = True
    return mask


def phase_int8_kernels(dev):
    """The int8 kernels against their plain versions: the dense projection
    for a2v-large's qkv (3072) and out (1024) shapes at N 8000 and 64 000 and
    ViT-B/16's (768 to 2304 and 768) at N 8000 and 12 544, with and without
    bias, the int8 block at N 8000, and the int8 attention (after its
    quantization pass, which must equal quantize_qkv_int8) at b4, T 2000
    (uniform positions; per-row positions with sentinels and a padding mask
    that includes a fully padded row), at T 4000 (two key spans) and at the
    int8_attn model's padded T 2048 with its padding mask. Each check prints
    the count of elements that differ from the plain version. The b32 grids
    are held in phase 7 on the inputs it times."""
    from animal2vec_tpu_torch.ops.int8_mm import int8_dense, int8_dense_plain, quantize_weight

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    errs = {"dense": 0.0}
    # the a2v-large qkv and out projections and the ViT-B/16 ones: at N 8000
    # (a partial row tile) and at the grids the main path launches, N 64 000
    # (a2v-large b32) and N 12 544 (ViT-B/16 b64). The int32 sums are exact
    # and the epilogue rounds as the plain version does, so the count of
    # elements that differ is printed beside the tolerance check.
    shapes = [(8000, k, m) for k, m in ((1024, 3072), (1024, 1024), (768, 2304), (768, 768))]
    shapes += [(64_000, 1024, 3072), (64_000, 1024, 1024), (12_544, 768, 2304), (12_544, 768, 768)]
    for n, k, m in shapes:
        x = torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((m, k), generator=gen, device=dev) * (2.0 / (k + m)) ** 0.5
        w_q, w_s = quantize_weight(w.to(torch.bfloat16))
        for bias in (None, torch.randn((m,), generator=gen, device=dev) * 0.1):
            got = int8_dense(x, w_q, w_s, bias)
            want = int8_dense_plain(x, w_q, w_s, bias)
            torch.cuda.synchronize()
            label = f"int8 dense ({n}, {k}) -> {m}{' + bias' if bias is not None else ''}"
            errs["dense"] = max(errs["dense"], check_close(label, got, want, INT8_DENSE_TOL))
            print(f"{label}: {(got != want).sum().item()} of {got.numel()} elements differ "
                  f"from the plain version")
    del x, got, want
    errs["block"] = check_int8_block("(8000,1024,4096)", int8_block_inputs(gen, 8000, dev))

    b, h = 4, 16
    q, k, v, slopes = int8_attention_inputs(gen, b, h, 2000, dev)
    pos = torch.arange(2000, dtype=torch.int32, device=dev)[None]
    errs["attention"] = check_int8_attention("uniform (4, 2000, 16, 64)", q, k, v, slopes, pos)
    rng = np.random.default_rng(SEED + 8)
    rows = [np.sort(rng.choice(2500, 1998, replace=False)) for _ in range(b)]
    pos_rows = torch.from_numpy(
        np.stack([np.concatenate([[-1, -1], r]) for r in rows]).astype(np.int32)).to(dev)
    mask = torch.zeros((b, 2000), dtype=torch.bool, device=dev)
    mask[2, -300:] = True
    mask[3] = True
    errs["attention"] = max(errs["attention"], check_int8_attention(
        "per-row + sentinel + mask", q, k, v, slopes, pos_rows, mask, True))
    q, k, v, slopes = int8_attention_inputs(gen, b, h, 4000, dev)
    pos = torch.arange(4000, dtype=torch.int32, device=dev)[None]
    mask = torch.zeros((b, 4000), dtype=torch.bool, device=dev)
    mask[1, -300:] = True
    errs["attention"] = max(errs["attention"], check_int8_attention(
        "T 4000 (two key spans), row 1 padded", q, k, v, slopes, pos, mask))
    q, k, v, slopes = int8_attention_inputs(gen, b, h, 2048, dev)
    pos = torch.arange(2048, dtype=torch.int32, device=dev)[None]
    errs["attention"] = max(errs["attention"], check_int8_attention(
        "the int8_attn trunk's T 2048, 48 pad frames masked (row 1: 548)", q, k, v, slopes, pos,
        padded_trunk_mask(b, 2000, dev), False))
    torch.cuda.synchronize()
    return errs


def bias_attention_inputs(gen, b, h, t, dev, d=64):
    """(B, T, H, D) bf16 q, k, v views of one (B, T, 3, H, D) projection, as
    the model hands them over."""
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device=dev).to(torch.bfloat16)
    return qkv.unbind(2)


def image_bias(h, t, dev):
    """The 2-D ALiBi bias of a square grid of t patches, (1, H, T, T) fp32."""
    from animal2vec_tpu_torch.ops.alibi import alibi_bias_2d

    return torch.from_numpy(alibi_bias_2d(t, h)[None]).to(dev)


def phase_bias_attention(dev):
    """3c. The dense-bias attention kernel against its plain version at b64,
    H 12, T 196 (not a multiple of 64): the batch-uniform 2-D ALiBi bias, a
    per-row bias, no bias, and the uniform bias with a per-batch key mask
    whose row 3 masks every key; at the ViT-B/16 student's b128 T 59 with a
    per-row bias and the lse the backward reads; then at b8, T 1024 (16 key
    tiles)."""
    from animal2vec_tpu_torch.ops.bias_attention import (
        bias_attention_forward, bias_attention_plain, bias_flash_attention,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    b, h, t = IMAGE_BATCH, IMAGE_HEADS, IMAGE_T
    q, k, v = bias_attention_inputs(gen, b, h, t, dev)
    bias = image_bias(h, t, dev)
    per_row = torch.randn((b, h, t, t), generator=gen, device=dev)
    mask = torch.zeros((b, t), dtype=torch.bool, device=dev)
    mask[1, -50:] = True
    mask[3] = True
    errs = []
    for label, bb, mm in (("2-D ALiBi, batch-uniform", bias, None), ("per-row bias", per_row, None),
                          ("no bias", None, None),
                          ("2-D ALiBi, key mask, row 3 fully masked", bias, mask)):
        got = bias_flash_attention(q, k, v, bb, mm)
        want = bias_attention_plain(q.float(), k.float(), v.float(), bb, mm)
        torch.cuda.synchronize()
        errs.append(check_close(f"bias attention b{b} T {t} {label}", got, want, ATTN_TOL))
    del per_row
    bs = 2 * IMAGE_BATCH
    q, k, v = bias_attention_inputs(gen, bs, h, STUDENT_T, dev)
    bias = torch.randn((bs, h, STUDENT_T, STUDENT_T), generator=gen, device=dev)
    got, lse = bias_attention_forward(q, k, v, bias, None, with_lse=True)
    want, lse_p = bias_attention_plain(q.float(), k.float(), v.float(), bias, return_lse=True)
    torch.cuda.synchronize()
    errs.append(check_close(f"bias attention b{bs} T {STUDENT_T} per-row bias", got, want,
                            ATTN_TOL))
    check_close(f"bias attention b{bs} T {STUDENT_T} per-row bias lse", lse, lse_p, LSE_TOL)
    q, k, v = bias_attention_inputs(gen, 8, h, 1024, dev)
    bias = image_bias(h, 1024, dev)
    got = bias_flash_attention(q, k, v, bias)
    want = bias_attention_plain(q.float(), k.float(), v.float(), bias)
    torch.cuda.synchronize()
    errs.append(check_close("bias attention b8 T 1024 2-D ALiBi", got, want, ATTN_TOL))
    return max(errs)


def phase_mlp(dev):
    """4d. The plain fused MLP (#8) and its int8 twin (#9) against their
    plain versions at the ViT-B/16 serving shape (N = 64 x 196 rows, C 768,
    M 3072: three hidden chunks), and the fused blocks #6 and #7 at C 768."""
    from animal2vec_tpu_torch.ops.fused_mlp import (
        fused_block_mlp, fused_block_plain, fused_mlp, fused_mlp_int8, fused_mlp_int8_plain,
        fused_mlp_plain,
    )
    from animal2vec_tpu_torch.ops.int8_mm import quantize_weight

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    n, c, m = IMAGE_BATCH * IMAGE_T, 768, 3072
    args = block_inputs(gen, n, c, m, dev)
    x, _, _, w1, w2, b1, b2 = args[:7]
    w1l, w2l = w1.t().contiguous(), w2.t().contiguous()  # nn.Linear layout
    errs = {"mlp": check_close(f"fused MLP ({n},{c},{m})", fused_mlp(x, w1l, w2l, b1, b2),
                               fused_mlp_plain(x, w1l, w2l, b1, b2), BLOCK_TOL)}
    w1_q, w1_s = quantize_weight(w1l)
    w2_q, w2_s = quantize_weight(w2l)
    int8_args = (x, w1_q, w1_s, b1, w2_q, w2_s, b2)
    got, want = fused_mlp_int8(*int8_args), fused_mlp_int8_plain(*int8_args)
    errs["int8_mlp"] = check_close(f"int8 fused MLP ({n},{c},{m})", got, want, INT8_BLOCK_TOL)
    print(f"  {(got != want).sum().item()} of {got.numel()} elements differ from the plain "
          f"version; kernel {cuda_ms(lambda: fused_mlp_int8(*int8_args)):.3f} ms")
    int8_mlp_splits(int8_args, f"int8 fused MLP ({n},{c},{m})")
    xo, t = fused_block_mlp(*args)
    xo_p, t_p = fused_block_plain(*args)
    errs["block"] = max(check_close(f"fused block tap t ({n},{c},{m})", t, t_p, BLOCK_TOL),
                        check_close(f"fused block x_out ({n},{c},{m})", xo, xo_p, BLOCK_TOL))
    errs["int8_block"] = check_int8_block(f"({n},{c},{m})", int8_block_inputs(gen, n, dev, c, m))
    return errs


def int8_model(model, cfg, mode, dev):
    """The bf16-cast model's weights served in an int8 mode (quantized at
    load), by a model of the same class (FinetuneModel or the image
    Data2VecMulti)."""
    out = type(model)(dataclasses.replace(cfg, matmul_impl=mode), torch.bfloat16)
    out.load_state_dict(model.state_dict(), strict=True, assign=True)
    return out.to(dev).eval()


class PlainOps:
    """Route the model's kernel ops to their plain versions, for the
    on-card comparison of the kernel path with the plain path."""

    def __enter__(self):
        import importlib

        self.saved = []
        for (user, name), (m, f) in PLAIN_OF.items():
            mod = importlib.import_module(f"animal2vec_tpu_torch.models.{user}")
            plain = getattr(importlib.import_module(f"animal2vec_tpu_torch.ops.{m}"), f)
            self.saved.append((mod, _swap(mod, {name: plain})))
        return self

    def __exit__(self, *exc):
        for mod, saved in reversed(self.saved):
            _swap(mod, saved)
        return False


class PlainSpy:
    """Count the calls of every plain version on a CUDA tensor (the kernel
    path must make none): each plain function is wrapped where its module
    looks it up."""

    def __enter__(self):
        import importlib

        self.cuda_calls = 0
        self.saved = []
        plain = {(m, f) for m, f in PLAIN_OF.values()} | {
            ("attention", "alibi_attention_plain"), ("attention", "attention_bwd_plain"),
            ("attention", "quantize_qkv_int8_pass_plain"),
            ("attention", "attention_int8_quantized_plain"),
            ("bias_attention", "bias_attention_bwd_plain")}
        for m, f in sorted({(f"ops.{m}", f) for m, f in plain} | set(PROBE_PLAIN)):
            mod = importlib.import_module(f"animal2vec_tpu_torch.{m}")
            self.saved.append((mod, _swap(mod, {f: self._spy(getattr(mod, f))})))
        return self

    def _spy(self, fn):
        def wrapped(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                self.cuda_calls += 1
            return fn(*args, **kwargs)
        return wrapped

    def __exit__(self, *exc):
        for mod, saved in self.saved:
            _swap(mod, saved)
        return False


def _counted():
    from animal2vec_tpu_torch.ops.attention import (
        alibi_flash_attention_int8, alibi_flash_attention_lse, alibi_flash_attention_packed,
        alibi_flash_attention_serve, attention_dkv, attention_dq, quantize_qkv_int8_pass,
    )
    from animal2vec_tpu_torch.ops.bias_attention import (
        bias_attention_bwd_single, bias_attention_dkv, bias_attention_dq, bias_flash_attention,
    )
    from animal2vec_tpu_torch.ops.fused_mlp import (
        fused_block_int8, fused_block_mlp, fused_mlp, fused_mlp_int8,
    )
    from animal2vec_tpu_torch.ops.int8_mm import int8_dense

    return {"serve_attention": alibi_flash_attention_serve,
            "attention": alibi_flash_attention_packed, "dq": attention_dq, "dkv": attention_dkv,
            "block": fused_block_mlp, "int8_dense": int8_dense, "int8_block": fused_block_int8,
            "int8_attention": alibi_flash_attention_int8, "int8_quant": quantize_qkv_int8_pass,
            "bias_attention": bias_flash_attention,
            "bias_dq": bias_attention_dq, "bias_dkv": bias_attention_dkv,
            "bias_single": bias_attention_bwd_single,
            "mlp": fused_mlp, "int8_mlp": fused_mlp_int8,
            "ring_attention": alibi_flash_attention_lse}


def counts():
    """Launches of each kernel entry since the last reset."""
    return {k: f.launches for k, f in _counted().items()}


def reset_counts():
    for f in _counted().values():
        f.launches = 0


def forward_launches(mode, n_blocks):
    """The launches of one forward of the model in a matmul_impl mode."""
    want = dict.fromkeys(_counted(), 0)
    if mode == "int8_attn":
        want.update(int8_dense=2 * n_blocks, int8_attention=n_blocks, int8_quant=n_blocks,
                    int8_block=n_blocks)
    else:
        want.update(serve_attention=n_blocks,
                    **{"block" if mode == "bf16" else "int8_block": n_blocks})
    return want


def launch_line(got):
    return ", ".join(f"{k} {v}" for k, v in got.items() if v)


def build_model(cfg, dev, dtype=torch.bfloat16):
    """The seeded serving model of ``cfg``: bf16 with the serving cast of its
    weights, or fp32 as built (JAX's default dtype, phase 23)."""
    from animal2vec_tpu_torch.models.finetune import build_finetune_model
    from animal2vec_tpu_torch.weights import serving_cast

    model = build_finetune_model(cfg, dtype=dtype, seed=SEED, device=dev)
    if dtype == torch.bfloat16:
        model.load_state_dict(serving_cast(model.state_dict()), strict=True, assign=True)
    return model


def phase_model(model, cfg, dev, mode="bf16", bf16_logits=None):
    """One b2 forward through the kernels (launch counts, no plain version
    on a CUDA tensor) against the plain path; the int8 modes also against
    the bf16 model's logits. Returns the logits."""
    n_blocks = cfg.prenet_depth + cfg.depth
    src = torch.from_numpy(
        np.random.default_rng(SEED).normal(size=(2, WAV_LEN)).astype(np.float32)
    ).to(dev)
    with torch.inference_mode():
        reset_counts()
        with PlainSpy() as spy:
            logits = model(src)["encoder_out"]
        got = counts()
        with PlainOps():
            logits_p = model(src)["encoder_out"]
        torch.cuda.synchronize()
    want = forward_launches(mode, n_blocks)
    print(f"{mode} model launches per forward: {launch_line(got)} (expected "
          f"{launch_line(want)}); plain-version calls on CUDA tensors {spy.cuda_calls}")
    if got != want:
        raise AssertionError("the model did not launch each kernel once per block")
    if spy.cuda_calls:
        raise AssertionError("the kernel path called a plain version on a CUDA tensor")
    frames = WAV_LEN // 40
    if tuple(logits.shape) != (2, frames, len(cfg.labels)) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    err = (logits.float() - logits_p.float()).abs().max().item()
    rel = rel_norm(logits, logits_p)
    print(f"{mode} model logits kernel vs plain path: max_abs_err {err:.3e}, relative norm "
          f"{rel:.3e}, |logits| max {logits.float().abs().max().item():.3f}")
    if mode == "bf16":
        print(f"  (tolerance {MODEL_TOL} max abs)")
        if not err <= MODEL_TOL:
            raise AssertionError("full-model kernel path disagrees with the plain path")
        return logits
    print(f"  (tolerance {INT8_MODEL_REL} relative norm)")
    if not rel <= INT8_MODEL_REL:
        raise AssertionError(f"{mode} full-model kernel path disagrees with the plain path")
    rel_bf16 = rel_norm(logits, bf16_logits)
    print(f"{mode} model logits against the bf16 model's: relative norm {rel_bf16:.3e}, max abs "
          f"{(logits.float() - bf16_logits.float()).abs().max().item():.3e} "
          f"(bound {INT8_VS_BF16_REL} relative norm)")
    if not rel_bf16 <= INT8_VS_BF16_REL:
        raise AssertionError(f"{mode} logits stray from the bf16 model's")
    return logits


def phase_serve(model, cfg, dev, mode="bf16"):
    from animal2vec_tpu_torch.data.wavio import write_wav
    from animal2vec_tpu_torch.tools.infer_cli import infer_long_file

    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for seconds in SERVE_SECONDS:
            n = seconds * cfg.sample_rate
            t = np.arange(n) / cfg.sample_rate
            # noise with 0.3-s tone bursts every 2 s
            wav = 0.05 * rng.normal(size=n)
            burst = (t % 2.0) < 0.3
            wav[burst] += 0.5 * np.sin(2 * np.pi * 1200 * t[burst])
            path = os.path.join(tmp, f"rec_{seconds}s.wav")
            write_wav(path, wav.astype(np.float32), cfg.sample_rate)
            paths.append(path)
        reset_counts()
        t0 = time.perf_counter()
        with PlainSpy() as spy:
            results = [
                infer_long_file(p, model, cfg, max_batch_size=32, segment_length=10.0,
                                device=dev)
                for p in paths
            ]
        torch.cuda.synchronize()
        seconds_taken = time.perf_counter() - t0
        launches = counts()
    n_forwards = len(SERVE_SECONDS)  # each recording fits one batch of <= 32 windows
    n_blocks = cfg.prenet_depth + cfg.depth
    for seconds, events in zip(SERVE_SECONDS, results):
        n_events = sum(len(v) for v in events.values())
        for ev in (e for v in events.values() for e in v):
            if not (0 <= ev["onset_s"] <= ev["offset_s"] <= seconds + 10.0
                    and 0.0 <= ev["likelihood"] <= 1.0):
                raise AssertionError(f"malformed event {ev}")
        print(f"served {seconds}-s recording ({-(-seconds // 10)} windows): {n_events} events")
    want = {k: n_forwards * v for k, v in forward_launches(mode, n_blocks).items()}
    print(f"{mode}: served 3 recordings in {seconds_taken:.3f} s; launches "
          f"{launch_line(launches)}; plain-version calls on CUDA tensors {spy.cuda_calls}")
    if launches != want or spy.cuda_calls:
        raise AssertionError(f"main path launch counts {launches} != {want}, or a plain call")
    return launches


def logits_digest(logits: torch.Tensor) -> str:
    """sha256 of a tensor's bits (equal in two trees whose outputs agree bit
    for bit), the first 16 hex digits."""
    return hashlib.sha256(logits.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def phase_throughput(model, card, dev, mode="bf16"):
    src = torch.from_numpy(
        np.random.default_rng(SEED + 2).normal(size=(32, WAV_LEN)).astype(np.float32)
    ).to(dev)
    with torch.inference_mode():
        logits = model(src)["encoder_out"]
        model(src)
        torch.cuda.synchronize()
        iters = 5
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(src)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        launched = counts()
    print(f"{mode} throughput b32: {32 / dt:.2f} 10-s clips/s ({dt * 1e3:.1f} ms per batch) on "
          f"{card}; launches per b32 forward: {launch_line(launched)} over {iters}; b32 logits "
          f"sha256 {logits_digest(logits)}")
    want = forward_launches(mode, model.cfg.n_blocks)
    if launched != {k: iters * v for k, v in want.items()}:
        raise AssertionError(f"b32 launches {launched} != {iters} x {want}")


def image_forward_launches(mode, layer_norm_first, n_blocks):
    """The launches of one image forward in a matmul_impl mode and layout:
    one dense-bias attention and one MLP kernel per block, and in int8_attn
    the qkv and out projections."""
    want = dict.fromkeys(_counted(), 0)
    if layer_norm_first:
        want["mlp" if mode == "bf16" else "int8_mlp"] = n_blocks
    else:
        want["block" if mode == "bf16" else "int8_block"] = n_blocks
    want["bias_attention"] = n_blocks
    if mode == "int8_attn":
        want["int8_dense"] = 2 * n_blocks
    return want


def phase_image(card, dev, dtype=torch.bfloat16):
    """9. The image modality's serving path: the ViT-B/16 image model (the
    repo's image defaults, 4 prenet + 8 trunk blocks of 768, the 2-D ALiBi
    bias on) on b64 of 224 x 224 images, with post-LN and pre-LN blocks, each
    in bf16, int8 and int8_attn on the same seeded weights: one forward
    through the kernels (launch counts, no plain version on a CUDA tensor)
    against the plain path, the int8 modes also against the bf16 model's
    features; then images/s (host clock over 5 forwards after 2). With
    ``dtype`` fp32 (phase 23c) the fp32 model alone, bf16 matmuls (the
    fp32 instances), against the plain path at FP32_IMAGE_REL. Returns the
    launches of the checked forwards."""
    from animal2vec_tpu_torch.config import ImageConfig
    from animal2vec_tpu_torch.models.finetune import build_image_model
    from animal2vec_tpu_torch.weights import serving_cast

    imgs = torch.from_numpy(np.random.default_rng(SEED + 11).normal(
        size=(IMAGE_BATCH, 224, 224, 3)).astype(np.float32)).to(dev)
    launches = dict.fromkeys(_counted(), 0)
    fp32 = dtype == torch.float32
    for pre_ln in (False, True):
        cfg = dataclasses.replace(ImageConfig(), use_alibi_encoder=True, layer_norm_first=pre_ln)
        base = build_image_model(cfg, dtype=dtype, seed=SEED, device=dev)
        if not fp32:
            base.load_state_dict(serving_cast(base.state_dict()), strict=True, assign=True)
        layout = "pre-LN" if pre_ln else "post-LN"
        x_bf16 = None
        for mode in ("bf16",) if fp32 else IMAGE_MODES:
            model = base if mode == "bf16" else int8_model(base, cfg, mode, dev)
            name = f"23c fp32 image {layout}" if fp32 else f"image {layout} {mode}"
            with torch.inference_mode():
                reset_counts()
                with PlainSpy() as spy:
                    x = model.extract_features(imgs, "IMAGE")["x"]
                torch.cuda.synchronize()
                got = counts()
                with PlainOps():
                    x_p = model.extract_features(imgs, "IMAGE")["x"]
                for _ in range(2):
                    model.extract_features(imgs, "IMAGE")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    model.extract_features(imgs, "IMAGE")
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) / 5
            want = image_forward_launches(mode, pre_ln, cfg.n_blocks)
            print(f"{name} launches per forward: {launch_line(got)} (expected "
                  f"{launch_line(want)}); plain-version calls on CUDA tensors {spy.cuda_calls}")
            if got != want or spy.cuda_calls:
                raise AssertionError(f"{name}: launch counts {got} != {want}, or a plain call")
            launches = {k: launches[k] + v for k, v in got.items()}
            if tuple(x.shape) != (IMAGE_BATCH, IMAGE_T, cfg.embed_dim):
                raise AssertionError(f"{name}: features of shape {tuple(x.shape)}")
            tol = FP32_IMAGE_REL if fp32 else IMAGE_REL if mode == "bf16" else IMAGE_INT8_REL
            if fp32 and x.dtype != torch.float32:
                raise AssertionError(f"{name}: features in {x.dtype}")
            check_rel(f"{name} features x, kernel vs plain path", x, x_p, tol)
            if mode == "bf16":
                x_bf16 = x
            else:
                check_rel(f"{name} features x against the bf16 model's", x, x_bf16,
                          INT8_VS_BF16_REL)
            print(f"{name} throughput b{IMAGE_BATCH}: {IMAGE_BATCH / dt:.1f} images/s "
                  f"({dt * 1e3:.2f} ms per forward) on {card}")
            del model, x_p
        del base, x_bf16
        torch.cuda.empty_cache()
    return launches


def train_batch(cfg, dev, batch=TRAIN_BATCH, seed=SEED + 6):
    """One micro-batch (leading axis 1) of 10-s windows and frame labels at
    10 % ones, as bench.py's finetune step makes them."""
    rng = np.random.default_rng(seed)
    frames = WAV_LEN // 40
    return {
        "source": torch.from_numpy(
            rng.normal(size=(1, batch, WAV_LEN)).astype(np.float32)).to(dev),
        "target": torch.from_numpy(
            (rng.random((1, batch, frames, len(cfg.labels))) < 0.1).astype(np.float32)).to(dev),
    }


def phase_train(cfg, card, dev, fused_block=True, stats=None):
    """The training path: finetune_100.yaml's recipe (mixup, span and
    channel masks with the noise fill, dropout 0.1 / attention 0.2,
    layerdrop 0.1, focal loss, Adam with warmup and cosine) at update_freq 1.
    The state starts at step 10 000, the first update after the freeze gate
    opens, so that every backward kernel runs and the learning rate is the
    schedule's, not the warmup's 1e-10. ``fused_block`` False: the blocks'
    widths take JAX's composed MLP route, and #6 must not launch. ``stats``:
    a dict that takes the timed step's ms and the checked steps' peak
    memory."""
    from animal2vec_tpu_torch.config import FinetuneTrainConfig
    from animal2vec_tpu_torch.models.finetune import build_finetune_model
    from animal2vec_tpu_torch.models.modules import AltBlock
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.finetune_step import make_finetune_train_step
    from animal2vec_tpu_torch.train.state import FinetuneState

    base = FinetuneTrainConfig()
    tcfg = dataclasses.replace(base, optimization=dataclasses.replace(base.optimization,
                                                                       update_freq=1))
    model = build_finetune_model(cfg, dtype=torch.bfloat16, seed=SEED, device=dev, train=tcfg)
    state = FinetuneState.create(model, tcfg)
    state.step = tcfg.freeze_finetune_updates
    step_fn = make_finetune_train_step(tcfg)
    batch = train_batch(cfg, dev)
    rngs = Rngs.from_seed(SEED, dev)
    ran = [0]  # blocks run in this step (layerdrop skips the others)
    blocks = {}  # runs per block over the checked steps

    def counter(name):
        def hook(module, args):
            ran[0] += 1
            blocks[name] += 1
        return hook

    for name, mod in model.named_modules():
        if isinstance(mod, AltBlock):
            blocks[name] = 0
            mod.register_forward_pre_hook(counter(name))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    n_blocks = cfg.n_blocks
    totals = [0, 0, 0, 0]
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        ran[0] = 0
        reset_counts()
        metrics = step_fn(state, batch, rngs)
        torch.cuda.synchronize()
        launched = counts()
        got = tuple(launched[k] for k in ("attention", "dq", "dkv", "block"))
        want = (ran[0],) * 3 + (ran[0] if fused_block else 0,)
        loss = float(metrics["loss"])
        print(f"train step {i + 1}: loss {loss:.5f}; launches attention forward {got[0]}, "
              f"dq {got[1]}, dk/dv {got[2]}, fused block {got[3]} (expected {want}: "
              f"{n_blocks} blocks less {n_blocks - ran[0]} dropped by layerdrop)")
        if not np.isfinite(loss):
            raise AssertionError("non-finite training loss")
        if got != want or ran[0] == 0 or sum(launched.values()) != sum(want):
            raise AssertionError(f"train step launch counts {launched} != {ran[0]} each")
        for n, p in model.named_parameters():
            if p.grad is None or not torch.isfinite(p.grad).all():
                raise AssertionError(f"missing or non-finite gradient: {n}")
        totals = [a + b for a, b in zip(totals, got)]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    after = dict(model.named_parameters())
    frontend = [n for n in before if ".local_encoder." in n]
    if any(not torch.equal(before[n], after[n]) for n in frontend):
        raise AssertionError("feature_grad_mult 0: the conv frontend must not change")
    # the last trunk block's norm2 feeds no loss term (the head reads the MLP
    # taps), so its gradient is 0 and Adam leaves it; every other parameter
    # of a block that ran in some step moves
    last = f"encoder.blocks.layers.{cfg.depth - 1}.norm2."
    for bname, runs in blocks.items():
        names = [n for n in before if n.startswith(bname + ".")]
        moved = {n: not torch.equal(before[n], after[n]) for n in names}
        want = {n: runs > 0 and not n.startswith(last) for n in names}
        if moved != want:
            raise AssertionError(f"block {bname} (ran {runs} times): moved {moved}")
    print(f"train steps: every block that ran changed ({sum(v > 0 for v in blocks.values())} "
          f"of {len(blocks)}), frontend ({len(frontend)} tensors) unchanged; "
          f"peak memory {peak_gb:.2f} GiB")

    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn(state, batch, rngs)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    print(f"train step b{TRAIN_BATCH} (finetune_100 recipe, update_freq 1): "
          f"{dt * 1e3:.1f} ms per step, {TRAIN_BATCH / dt:.2f} 10-s clips/s on {card}")
    if stats is not None:
        stats.update(step_ms=dt * 1e3, peak_gib=peak_gb)
    del state, model
    torch.cuda.empty_cache()
    return tuple(totals)


def phase_train_grads(cfg, dev, batch=1, dtype=torch.bfloat16, tol=MODEL_GRAD_TOL):
    """At b1 (or ``batch``) with every rate at 0 (no mixup, masks, dropout
    or layerdrop), the full model's gradients through the kernels against
    those through the plain versions, one relative norm per parameter
    tensor, in the compute ``dtype`` (within ``tol``)."""
    from animal2vec_tpu_torch.config import FinetuneTrainConfig
    from animal2vec_tpu_torch.models.finetune import build_finetune_model
    from animal2vec_tpu_torch.train.finetune_step import finetune_loss

    tcfg = dataclasses.replace(
        FinetuneTrainConfig(), freeze_finetune_updates=0, apply_mask=False,
        mask_channel_prob=0.0, dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
        layerdrop=0.0, source_mixup=-1.0)
    model = build_finetune_model(cfg, dtype=dtype, seed=SEED, device=dev, train=tcfg)
    mb = {k: v[0] for k, v in train_batch(cfg, dev, batch=batch, seed=SEED + 7).items()}

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = finetune_loss(model, mb, None, 0, tcfg, train=True)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float().clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    loss_k, g_k = grads()
    with PlainOps():
        loss_p, g_p = grads()
    torch.cuda.synchronize()
    rels = {n: rel_norm(g_k[n], g_p[n]) for n in g_p if g_p[n].norm() > 0}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    print(f"model gradients b{batch}, kernel vs plain path: loss {loss_k:.6f} vs {loss_p:.6f}; "
          f"relative norm per tensor: max {worst[0][1]:.3e}, median "
          f"{float(np.median(list(rels.values()))):.3e} over {len(rels)} tensors "
          f"(tolerance {tol}); worst {[(n, f'{r:.2e}') for n, r in worst]}")
    if set(rels) != set(n for n in g_k if g_k[n].norm() > 0):
        raise AssertionError("the two paths give gradients to different parameters")
    if not max(rels.values()) <= tol:
        raise AssertionError("full-model kernel-path gradients disagree with the plain path")
    del model, g_k, g_p
    torch.cuda.empty_cache()
    return max(rels.values())


def phase_kernel_times(dev):
    """Each kernel beside its plain version, the library call and its
    bound: the serving shape (b32) and the training shape (b4, dropout).
    Returns the rows and the b32 serving grids' max_abs_err of #1, #6, #7
    and #5, each held against its plain version on the timed inputs."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_plain, alibi_flash_attention_btc, alibi_flash_attention_packed,
        attention_bwd_plain, attention_dkv, attention_dq,
    )
    from animal2vec_tpu_torch.ops.fused_mlp import fused_block_mlp, fused_block_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows, errs = {}, {}

    def row(key, ms, plain_ms, library_ms, bnd):
        rows[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1]}
        lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
        print(f"{key}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib}, "
              f"bound {bnd[0]:.3f} ms ({bnd[1]})")

    with torch.inference_mode():
        qkv, slopes = attention_inputs(gen, 32, 16, 2000, dev)
        pos = torch.arange(2000, dtype=torch.int32, device=dev)[None]
        q, k, v, bias = sdpa_args(qkv, slopes, 2000)
        # the serving kernel as the model calls it: the (B, T, 3C) projection
        # read in place, the (B, T, C) output written in place
        qkv_btc = qkv.permute(1, 3, 0, 2, 4).reshape(32, 2000, 3 * 16 * 64)
        serve = lambda: alibi_flash_attention_btc(qkv_btc, 16, slopes, pos)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        key = "attention forward, b32 serving"
        row(key, cuda_ms(serve),
            cuda_ms(lambda: alibi_attention_plain(qkv, slopes, pos, None, False), iters=3),
            cuda_ms(sdpa), attention_bounds(32, 16, 2000, 64)["serve"])
        flops = 4 * 32 * 16 * 2000**2 * 64
        split = {"device_ms": device_ms(serve, "alibi_fwd_kernel"),
                 "library_device_ms": device_ms(sdpa, "")}
        split["tflops"] = per_ms(flops, split["device_ms"])
        split["library_tflops"] = per_ms(flops, split["library_device_ms"])
        rows[key].update(split)
        print(f"  device time: kernel {ms_text(split['device_ms'])}"
              f"{rate_text(split['tflops'], 'TFLOP/s')}, SDPA "
              f"{ms_text(split['library_device_ms'])}"
              f"{rate_text(split['library_tflops'], 'TFLOP/s')}")
        del q, k, v, bias
        # the timed grid held against the plain version on the same inputs
        got = serve().reshape(32, 2000, 16, 64).transpose(1, 2)
        want = alibi_attention_plain(qkv.float(), slopes, pos, None, False)
        torch.cuda.synchronize()
        errs["attention"] = check_close("attention b32 serving, (B, T, 3C) read in place",
                                        got, want, ATTN_TOL)
        del got, want, qkv_btc
        torch.cuda.empty_cache()
        # the per-row template: sorted keep-sets of 0..2499, every other row
        # padding its last 300 keys
        rng = np.random.default_rng(SEED + 3)
        pos_rows = torch.from_numpy(np.stack(
            [np.sort(rng.choice(2500, 2000, replace=False)) for _ in range(32)]
        ).astype(np.int32)).to(dev)
        mask = torch.zeros((32, 2000), dtype=torch.bool, device=dev)
        mask[::2, -300:] = True
        ms = cuda_ms(lambda: alibi_flash_attention_packed(qkv, slopes, pos_rows, mask, False))
        plain_ms = cuda_ms(lambda: alibi_attention_plain(qkv, slopes, pos_rows, mask, False),
                           iters=3)
        print(f"attention forward, b32 per-row positions + mask: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms")
        got = alibi_flash_attention_packed(qkv, slopes, pos_rows, mask, False)
        want = alibi_attention_plain(qkv.float(), slopes, pos_rows, mask, False)
        torch.cuda.synchronize()
        errs["attention"] = max(errs["attention"], check_close(
            "attention b32 per-row positions + mask", got, want, ATTN_TOL))
        del got, want, qkv
        torch.cuda.empty_cache()
        args = block_inputs(gen, 32 * 2000, 1024, 4096, dev)
        row("fused block, b32 serving", cuda_ms(lambda: fused_block_mlp(*args)),
            cuda_ms(lambda: fused_block_plain(*args), iters=3), None, block_bound(32 * 2000))
        rows["fused block, b32 serving"].update(block_gemm_splits(args))
        (xo, t), (xo_p, t_p) = fused_block_mlp(*args), fused_block_plain(*args)
        torch.cuda.synchronize()
        errs["block"] = max(check_close("fused block tap t, b32 serving (64000,1024,4096)",
                                        t, t_p, BLOCK_TOL),
                            check_close("fused block x_out, b32 serving (64000,1024,4096)",
                                        xo, xo_p, BLOCK_TOL))
        del args, xo, t, xo_p, t_p
        torch.cuda.empty_cache()

        # training shape: b4, T 2000, dropout 0.2, row 1 padded
        qkv, slopes, pos, mask, dout = train_attention_inputs(dev)
        b, h, t = qkv.shape[1:4]
        drop = (ATTN_DROP, DROP_SEED)
        bounds = attention_bounds(b, h, t, 64)
        out, lse = alibi_flash_attention_packed(qkv, slopes, pos, mask, False, *drop,
                                                return_lse=True)
        delta = (dout.float() * out.float()).sum(-1).reshape(b * h, t)
        bwd = (qkv, dout, lse, delta, slopes, pos, mask, False, *drop)
        q, k, v, bias = sdpa_args(qkv, slopes, t)
        fwd = lambda: alibi_flash_attention_packed(qkv, slopes, pos, mask, False, *drop,
                                                   return_lse=True)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                      dropout_p=ATTN_DROP)
        key = f"attention forward + lse + dropout, b{b} training"
        row(key, cuda_ms(fwd),
            cuda_ms(lambda: alibi_attention_plain(qkv, slopes, pos, mask, False, *drop,
                                                  return_lse=True), iters=3),
            cuda_ms(sdpa), bounds["forward"])
        rows[key].update({"device_ms": device_ms(fwd, "alibi_fwd_kernel"),
                          "library_device_ms": device_ms(sdpa, "")})
        rows[key]["tflops"] = per_ms(4 * b * h * t * t * 64, rows[key]["device_ms"])
        print(f"  device time: kernel {ms_text(rows[key]['device_ms'])}"
              f"{rate_text(rows[key]['tflops'], 'TFLOP/s')}, SDPA "
              f"{ms_text(rows[key]['library_device_ms'])}")
        plain_bwd = cuda_ms(lambda: attention_bwd_plain(*bwd), iters=3)
    # the library yardsticks of the backward: SDPA forward and backward
    # through autograd with the float bias, at the same shape and dropout,
    # and SDPA's backward alone (its forward once, outside the timed loop)
    q, k, v, bias = sdpa_args(qkv, slopes, t, requires_grad=True)
    g = dout.clone()

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, dropout_p=ATTN_DROP)
        torch.autograd.grad(o, (q, k, v), g)

    lib_fwd_bwd = cuda_ms(sdpa_fwd_bwd)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, dropout_p=ATTN_DROP)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True))
    del o
    dq_ms, dkv_ms = cuda_ms(lambda: attention_dq(*bwd)), cuda_ms(lambda: attention_dkv(*bwd))
    row(f"attention dq + slope partials, b{b} training", dq_ms, plain_bwd, lib_fwd_bwd,
        bounds["dq"])
    row(f"attention dk/dv, b{b} training", dkv_ms, plain_bwd, lib_fwd_bwd, bounds["dkv"])
    print(f"  (plain: attention_bwd_plain computes dq, dk, dv and the partials in one call; "
          f"library: SDPA forward + backward with the float ALiBi mask, dropout {ATTN_DROP}; "
          f"SDPA's backward alone {lib_bwd:.3f} ms; dq + dk/dv {dq_ms + dkv_ms:.3f} ms)")
    extra = {"dq": {"library_bwd_ms": lib_bwd}, "dkv": {"library_bwd_ms": lib_bwd}}
    bwd_splits(extra, f"b{b} T {t} dropout 0", b, h, t, (*bwd[:8], 0.0, None), "dropout0")
    extra["dq"]["tflops"] = tflops("dq", b, h, t, dq_ms, 64)
    extra["dkv"]["tflops"] = tflops("dkv", b, h, t, dkv_ms, 64)
    # the a2v-large pretraining student: b60 (5 x clone 12), 125 kept tokens
    # at per-row keep-set positions, dropout 0.1
    rng = np.random.default_rng(SEED + 19)
    bs, ts = 60, 125
    qkv_s, slopes_s = attention_inputs(gen, bs, h, ts, dev)
    pos_s = torch.from_numpy(np.stack([np.sort(rng.choice(2000, ts, replace=False))
                                       for _ in range(bs)]).astype(np.int32)).to(dev)
    dout_s = torch.randn((bs, h, ts, 64), generator=gen, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        out_s, lse_s = alibi_flash_attention_packed(qkv_s, slopes_s, pos_s, None, False, 0.1,
                                                    DROP_SEED, return_lse=True)
    delta_s = (dout_s.float() * out_s.float()).sum(-1).reshape(bs * h, ts)
    bwd_s = (qkv_s, dout_s, lse_s, delta_s, slopes_s, pos_s, None, False, 0.1, DROP_SEED)
    bwd_splits(extra, f"b{bs} T {ts} keep-set positions, dropout 0.1", bs, h, ts, bwd_s,
               "student")
    student_plain = cuda_ms(lambda: attention_bwd_plain(*bwd_s), iters=3)
    extra["dq"]["student_plain_ms"] = extra["dkv"]["student_plain_ms"] = student_plain
    print(f"  plain backward (dq, dk, dv and the partials in one call) at b{bs} T {ts}: "
          f"{student_plain:.3f} ms")
    # SDPA's backward alone at the student's shape: the per-row ALiBi bias as
    # a (B, H, T, T) bf16 float mask, dropout 0.1 (its forward once, outside
    # the timed loop)
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in qkv_s.unbind(0))
    ps = pos_s.float()
    mask_s = (-(ps[:, None, :, None] - ps[:, None, None, :]).abs()
              * slopes_s.float()[None, :, None, None]).to(torch.bfloat16)
    # the forward (#2 with lse) at the student's shape beside SDPA's forward
    # with the same bf16 mask and dropout
    with torch.no_grad():
        fwd_s = lambda: alibi_flash_attention_packed(qkv_s, slopes_s, pos_s, None, False, 0.1,
                                                     DROP_SEED, return_lse=True)
        sdpa_s = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask_s,
                                                        dropout_p=0.1)
        key = f"attention forward + lse + dropout, b{bs} T {ts} pretrain student"
        row(key, cuda_ms(fwd_s),
            cuda_ms(lambda: alibi_attention_plain(qkv_s, slopes_s, pos_s, None, False, 0.1,
                                                  DROP_SEED, return_lse=True), iters=3),
            cuda_ms(sdpa_s), attention_bounds(bs, h, ts, 64)["forward"])
        rows[key].update({"device_ms": device_ms(fwd_s, "alibi_fwd_kernel"),
                          "library_device_ms": device_ms(sdpa_s, "")})
        print(f"  device time: kernel {ms_text(rows[key]['device_ms'])}, SDPA "
              f"{ms_text(rows[key]['library_device_ms'])}")
    o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask_s, dropout_p=0.1)
    student_bwd = lambda: torch.autograd.grad(o, (qs, ks, vs), dout_s, retain_graph=True)
    lib_student = {"student_library_bwd_ms": cuda_ms(student_bwd),
                   "student_library_bwd_device_ms": device_ms(student_bwd, "")}
    extra["dq"].update(lib_student)
    extra["dkv"].update(lib_student)
    print(f"  SDPA's backward alone at b{bs} T {ts} (per-row bias as a bf16 mask, dropout "
          f"0.1): {lib_student['student_library_bwd_ms']:.3f} ms "
          f"(device {ms_text(lib_student['student_library_bwd_device_ms'])})")
    del o, qs, ks, vs, mask_s
    rows[f"attention dq + slope partials, b{b} training"].update(extra["dq"])
    rows[f"attention dk/dv, b{b} training"].update(extra["dkv"])
    print(f"attention dq / dk/dv at b{b} T {t}: {extra['dq']['tflops']:.1f} / "
          f"{extra['dkv']['tflops']:.1f} TFLOP/s (bounds {bounds['dq'][0]:.3f} / "
          f"{bounds['dkv'][0]:.3f} ms)")
    del q, k, v, bias, qkv, dout, qkv_s, dout_s
    torch.cuda.empty_cache()
    with torch.inference_mode():
        n = TRAIN_BATCH * 2000
        args = block_inputs(gen, n, 1024, 4096, dev)
        drop_b = ((11, -22, 2**31 - 5), 0.1, 0.1)
        row(f"fused block + dropout, N {n} training",
            cuda_ms(lambda: fused_block_mlp(*args, *drop_b)),
            cuda_ms(lambda: fused_block_plain(*args, *drop_b), iters=3), None, block_bound(n))
        rows[f"fused block + dropout, N {n} training"].update(
            block_gemm_splits(args, drop_b))
        # the a2v-large pretraining student's blocks: 60 x 125 kept tokens,
        # dropout 0.1
        ns = 60 * 125
        args = block_inputs(gen, ns, 1024, 4096, dev)
        row(f"fused block + dropout, N {ns} pretrain student",
            cuda_ms(lambda: fused_block_mlp(*args, *drop_b)),
            cuda_ms(lambda: fused_block_plain(*args, *drop_b), iters=3), None, block_bound(ns))
        rows[f"fused block + dropout, N {ns} pretrain student"].update(
            block_gemm_splits(args, drop_b))
        del args
        torch.cuda.empty_cache()
        errs.update(int8_kernel_times(gen, dev, row, rows))
        errs["int8_mlp"] = int8_mlp_a2v_times(gen, dev, row, rows)
        image_kernel_times(gen, dev, row, rows)
    pretrain_kernel_times(gen, dev, row, rows)
    return rows, errs


def int8_mlp_a2v_times(gen, dev, row, rows):
    """#9 at a2v-large's widths (N 64 000 = b32 x T 2000, C 1024, M 4096: the
    MLP of a pre-LN audio encoder served in int8): the wrapper beside its
    plain version and torch._int_mm x 2 (fc1 and fc2's int8 products alone
    on pre-quantized operands), both also by device time, split by launch;
    held against the plain version on the timed inputs. Returns the max abs
    error."""
    from animal2vec_tpu_torch.ops.fused_mlp import fused_mlp_int8, fused_mlp_int8_plain
    from animal2vec_tpu_torch.ops.int8_mm import quantize_rows, quantize_weight

    n, c, m = 32 * 2000, 1024, 4096
    key = "int8 fused MLP, b32 a2v-large widths"
    x, _, _, w1, w2, b1, b2 = block_inputs(gen, n, c, m, dev)[:7]
    w1_q, w1_s = quantize_weight(w1.t().contiguous())  # nn.Linear layout
    w2_q, w2_s = quantize_weight(w2.t().contiguous())
    args = (x, w1_q, w1_s, b1, w2_q, w2_s, b2)
    x_q, _ = quantize_rows(x)
    h_q = torch.randint(-127, 128, (n, m), generator=gen, device=dev, dtype=torch.int8)
    lib = lambda: (torch._int_mm(x_q, w1_q.t()), torch._int_mm(h_q, w2_q.t()))  # noqa: E731
    call = lambda: fused_mlp_int8(*args)  # noqa: E731
    row(key, cuda_ms(call), cuda_ms(lambda: fused_mlp_int8_plain(*args), iters=1, warmup=1),
        cuda_ms(lib), int8_mlp_bound(n, c, m))
    rows[key].update(int8_mlp_splits(args, key))
    rows[key].update(device_ms=device_ms(call, ""), library_device_ms=device_ms(lib, ""))
    print(f"  device time: the four launches {ms_text(rows[key]['device_ms'])}, torch._int_mm x 2 "
          f"{ms_text(rows[key]['library_device_ms'])} (library: the two int8 products alone)")
    got, want = call(), fused_mlp_int8_plain(*args)
    err = check_close(f"int8 fused MLP, b32 a2v-large widths ({n},{c},{m})", got, want,
                      INT8_BLOCK_TOL)
    print(f"  {(got != want).sum().item()} of {got.numel()} elements differ from the plain "
          f"version")
    del x, x_q, h_q, args, got, want
    torch.cuda.empty_cache()
    return err


def tflops(kernel, b, h, t, ms, d):
    """Achieved TFLOP/s of the dq (3 products of 2*T^2*D per (b, h)) or
    dk/dv (4) kernel in ``ms`` (None where ``ms`` is)."""
    return per_ms((3 if kernel == "dq" else 4) * 2 * b * h * t * t * d, ms)


def per_ms(work, ms):
    """``work`` done in ``ms`` of device time, in 1e12 a second (TFLOP/s or
    TOP/s); None where the time was not measured."""
    return None if ms is None else work / (ms * 1e-3) / 1e12


def ms_text(ms):
    """A device time for a log line."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def rate_text(rate, unit):
    """An achieved rate for a log line, in brackets; empty where the time it
    comes from was not measured."""
    return "" if rate is None else f" ({rate:.1f} {unit})"


def device_ms(fn, kernel):
    """Device time per call of fn's kernels whose name holds ``kernel``, from
    a profiled window that kept every kernel record; None (not measured)
    where none did (tools/device_time.py)."""
    from animal2vec_tpu_torch.tools.device_time import device_ms as profiled_ms

    return profiled_ms(fn, kernel)


def gemm_splits(call, x, w1l, w2l, b1, b2):
    """Device time of the two GEMM launches (fc1 with GELU, fc2) of
    ``call`` (the fused block or the plain fused MLP on bf16 x (N, C) and
    nn.Linear-layout weights w1l (M, C), w2l (C, M)) beside F.linear at the
    same shapes (every kernel of one call), with achieved TFLOP/s."""
    import torch.nn.functional as F

    (n, c), m = x.shape, w1l.shape[0]
    hid = torch.randn((n, m), device=x.device).to(torch.bfloat16)
    split = {}
    for name, kernel, lib in (
            ("fc1", "gemm_bf16_sm90_kernel<true", lambda: F.linear(x, w1l, b1.to(x.dtype))),
            ("fc2", "gemm_bf16_sm90_kernel<false", lambda: F.linear(hid, w2l, b2.to(x.dtype)))):
        ms = device_ms(call, kernel)
        lib_ms = device_ms(lib, "")
        split.update({f"{name}_device_ms": ms, f"{name}_tflops": per_ms(2 * n * c * m, ms),
                      f"{name}_library_device_ms": lib_ms,
                      f"{name}_library_tflops": per_ms(2 * n * c * m, lib_ms)})
        print(f"  {name} (N {n}, {c if name == 'fc1' else m} -> {m if name == 'fc1' else c}): "
              f"GEMM launch {ms_text(ms)} device"
              f"{rate_text(split[f'{name}_tflops'], 'TFLOP/s')}, F.linear {ms_text(lib_ms)} "
              f"device{rate_text(split[f'{name}_library_tflops'], 'TFLOP/s')}")
    return split


def block_gemm_splits(args, drop=()):
    """``gemm_splits`` of the fused block; ``args`` are fused_block_mlp's
    (bf16 x, weights in the JAX layout), ``drop`` its dropout arguments
    (seeds, rates) where the block trains."""
    from animal2vec_tpu_torch.ops.fused_mlp import fused_block_mlp

    x, w1, w2, b1, b2 = args[0], args[3], args[4], args[5], args[6]
    return gemm_splits(lambda: fused_block_mlp(*args, *drop), x, w1.t().contiguous(),
                       w2.t().contiguous(), b1, b2)


def bwd_splits(extra, label, b, h, t, args, prefix):
    """Times of the dq and dk/dv kernels on ``args`` (CUDA events around the
    wrapper, and device time) beside their bounds and achieved TFLOP/s (of
    the device time), into extra["dq"] and extra["dkv"] under ``prefix``."""
    from animal2vec_tpu_torch.ops.attention import attention_dkv, attention_dq

    bounds = attention_bounds(b, h, t, 64)
    for kernel, fn in (("dq", attention_dq), ("dkv", attention_dkv)):
        ms = cuda_ms(lambda: fn(*args))
        dev_ms = device_ms(lambda: fn(*args), f"alibi_attention_{kernel}_kernel")
        rate = tflops(kernel, b, h, t, dev_ms, 64)
        extra[kernel].update({f"{prefix}_ms": ms, f"{prefix}_device_ms": dev_ms,
                              f"{prefix}_bound_ms": bounds[kernel][0],
                              f"{prefix}_tflops": rate})
        print(f"attention {kernel}, {label}: kernel {ms:.3f} ms (device {ms_text(dev_ms)})"
              f"{rate_text(rate, 'TFLOP/s')}, bound {bounds[kernel][0]:.3f} ms "
              f"({bounds[kernel][1]})")


def int8_block_splits(args, label):
    """Device time of each of the int8 block's five launches with the
    GEMMs' TOP/s; ``args`` are fused_block_int8's."""
    from animal2vec_tpu_torch.ops.fused_mlp import fused_block_int8

    (n, c), m = args[0].shape, args[3].shape[0]
    call = lambda: fused_block_int8(*args)
    split = {f"{name}_device_ms": device_ms(call, kernel) for name, kernel in (
        ("ln1", "ln_rows_kernel<false, false, true, false, "), ("fc1", "gemm_s8_sm90_kernel<1>"),
        ("quantize", "quantize_chunks_kernel"), ("fc2", "gemm_s8_sm90_kernel<2>"),
        ("ln2", "ln_rows_kernel<true, false, false, false, "))}
    for gemm in ("fc1", "fc2"):
        split[f"{gemm}_tops"] = per_ms(2 * n * c * m, split[f"{gemm}_device_ms"])
    print(f"  {label} by launch, device time: LN1 {ms_text(split['ln1_device_ms'])}, fc1 "
          f"{ms_text(split['fc1_device_ms'])}{rate_text(split['fc1_tops'], 'TOP/s')}, h "
          f"quantization {ms_text(split['quantize_device_ms'])}, fc2 "
          f"{ms_text(split['fc2_device_ms'])}{rate_text(split['fc2_tops'], 'TOP/s')}, LN2 "
          f"{ms_text(split['ln2_device_ms'])}")
    return split


def int8_mlp_splits(args, label):
    """Device time of each of the int8 MLP's four launches (x quantization,
    fc1, h quantization, fc2) with the GEMMs' TOP/s; ``args`` are
    fused_mlp_int8's."""
    from animal2vec_tpu_torch.ops.fused_mlp import fused_mlp_int8

    (n, c), m = args[0].shape, args[1].shape[0]
    call = lambda: fused_mlp_int8(*args)
    split = {f"{name}_device_ms": device_ms(call, kernel) for name, kernel in (
        ("quantize_x", "quantize_segments_kernel"), ("fc1", "gemm_s8_sm90_kernel<1>"),
        ("quantize_h", "quantize_chunks_kernel"), ("fc2", "gemm_s8_sm90_kernel<2>"))}
    for gemm in ("fc1", "fc2"):
        split[f"{gemm}_tops"] = per_ms(2 * n * c * m, split[f"{gemm}_device_ms"])
    print(f"  {label} by launch, device time: x quantization "
          f"{ms_text(split['quantize_x_device_ms'])}, fc1 {ms_text(split['fc1_device_ms'])}"
          f"{rate_text(split['fc1_tops'], 'TOP/s')}, h quantization "
          f"{ms_text(split['quantize_h_device_ms'])}, fc2 {ms_text(split['fc2_device_ms'])}"
          f"{rate_text(split['fc2_tops'], 'TOP/s')}")
    return split


def int8_qkv_pass_bound(b, h, t, t_pad, d):
    """bf16 q, k, v read; q8, k8, v8^T and the scales written: no tensor
    work."""
    return bound(0, 2 * 3 * b * t * h * d + 2 * b * t * h * d + b * h * d * t_pad
                 + 4 * (2 * b * h * t + b * h * d))


def int8_kernel_times(gen, dev, row, rows):
    """The int8 kernels at the b32 serving shapes (N = 64 000 rows, T 2000):
    the wrapper as the model calls it (quantization included) beside its
    plain version; the dense projection also beside torch._int_mm, the int8
    product alone on the same quantized operands, and split by device time
    into its quantization and GEMM launches; the int8 block split by launch,
    also at the ViT-B/16 widths; the int8 attention split into its
    quantization pass and kernel, also at the int8_attn trunk's padded T
    2048 with its padding mask. The timed b32 grids of the block and the
    attention are held against their plain versions on the same inputs:
    returns those errors."""
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_int8_plain, alibi_flash_attention_int8, int8_spans,
        quantize_qkv_int8_pass, quantize_qkv_int8_pass_plain,
    )
    from animal2vec_tpu_torch.ops.fused_mlp import fused_block_int8, fused_block_int8_plain
    from animal2vec_tpu_torch.ops.int8_mm import (
        int8_dense, int8_dense_plain, quantize_rows, quantize_weight,
    )

    n = 32 * 2000
    x = torch.randn((n, 1024), generator=gen, device=dev).to(torch.bfloat16)
    x_q, _ = quantize_rows(x)
    for m, what in ((3072, "qkv"), (1024, "out")):
        w = torch.randn((m, 1024), generator=gen, device=dev) * (2.0 / (1024 + m)) ** 0.5
        w_q, w_s = quantize_weight(w.to(torch.bfloat16))
        key = f"int8 dense {what} projection, b32 serving"
        row(key, cuda_ms(lambda: int8_dense(x, w_q, w_s)),
            cuda_ms(lambda: int8_dense_plain(x, w_q, w_s), iters=3),
            cuda_ms(lambda: torch._int_mm(x_q, w_q.t())), int8_dense_bound(n, 1024, m))
        # device time of each launch: the GEMM alone beside torch._int_mm on
        # the same quantized operands, like for like
        split = {"gemm_device_ms": device_ms(lambda: int8_dense(x, w_q, w_s), "gemm_s8_sm90"),
                 "quantize_device_ms": device_ms(lambda: int8_dense(x, w_q, w_s),
                                                 "quantize_segments"),
                 "library_device_ms": device_ms(lambda: torch._int_mm(x_q, w_q.t()), "")}
        split["gemm_tops"] = per_ms(2 * n * 1024 * m, split["gemm_device_ms"])
        split["library_tops"] = per_ms(2 * n * 1024 * m, split["library_device_ms"])
        rows[key].update(split)
        print(f"  {what}: GEMM launch {ms_text(split['gemm_device_ms'])} device"
              f"{rate_text(split['gemm_tops'], 'TOP/s')}, quantization launch "
              f"{ms_text(split['quantize_device_ms'])}; torch._int_mm "
              f"{ms_text(split['library_device_ms'])} device"
              f"{rate_text(split['library_tops'], 'TOP/s')}")
    print("  (library: torch._int_mm, the int8 product alone on pre-quantized operands)")
    del x, x_q
    errs = {}
    for key, (nb, c, m) in (("int8 fused block, b32 serving", (n, 1024, 4096)),
                            ("int8 fused block, b64 ViT-B serving",
                             (IMAGE_BATCH * IMAGE_T, 768, 3072))):
        args = int8_block_inputs(gen, nb, dev, c, m)
        row(key, cuda_ms(lambda: fused_block_int8(*args)),
            cuda_ms(lambda: fused_block_int8_plain(*args), iters=3), None,
            int8_block_bound(nb, c, m))
        rows[key].update(int8_block_splits(args, key))
        if nb == n:  # the timed b32 grid against the plain version
            errs["int8_block"] = check_int8_block(f"b32 serving ({nb},{c},{m})", args)
        del args
        torch.cuda.empty_cache()

    # the attention: b32 T 2000 with uniform positions (the timed row), and
    # the int8_attn trunk as the model calls it, T 2048 with the padding mask
    # over its pad frames
    key = "int8 attention, b32 serving"
    q, k, v, slopes = int8_attention_inputs(gen, 32, 16, 2000, dev)
    pos = torch.arange(2000, dtype=torch.int32, device=dev)[None]
    call = lambda: alibi_flash_attention_int8(q, k, v, slopes, pos)
    row(key, cuda_ms(call),
        cuda_ms(lambda: alibi_attention_int8_plain(q, k, v, slopes, pos), iters=1, warmup=1),
        None, int8_attention_bound(32, 16, 2000, 64))
    t_pad = int8_spans(2000)[1]
    qkey = "int8 q, k, v quantization pass, b32 serving"
    row(qkey, cuda_ms(lambda: quantize_qkv_int8_pass(q, k, v, t_pad)),
        cuda_ms(lambda: quantize_qkv_int8_pass_plain(q, k, v, t_pad), iters=3), None,
        int8_qkv_pass_bound(32, 16, 2000, t_pad, 64))
    rows[qkey]["device_ms"] = device_ms(call, "quantize_")
    rows[key].update({"kernel_device_ms": device_ms(call, "alibi_int8_kernel"),
                      "quantize_device_ms": rows[qkey]["device_ms"],
                      "bound_three_products_ms": bound(6 * 32 * 16 * 2000**2 * 64, 0,
                                                       PEAK_INT8_OPS)[0]})
    print(f"  device time: kernel {ms_text(rows[key]['kernel_device_ms'])}, quantization pass "
          f"{ms_text(rows[key]['quantize_device_ms'])} (two launches); the three products' "
          f"bound {rows[key]['bound_three_products_ms']:.3f} ms")
    errs["int8_attention"] = check_int8_attention("b32 serving (32, 2000, 16, 64)", q, k, v,
                                                  slopes, pos)
    del q, k, v
    torch.cuda.empty_cache()
    q, k, v, slopes = int8_attention_inputs(gen, 32, 16, 2048, dev)
    pos = torch.arange(2048, dtype=torch.int32, device=dev)[None]
    mask = padded_trunk_mask(32, 2000, dev)
    call = lambda: alibi_flash_attention_int8(q, k, v, slopes, pos, mask, False)
    trunk = {"trunk_ms": cuda_ms(call),
             "trunk_plain_ms": cuda_ms(lambda: alibi_attention_int8_plain(
                 q, k, v, slopes, pos, mask, False), iters=1, warmup=1),
             "trunk_kernel_device_ms": device_ms(call, "alibi_int8_kernel"),
             "trunk_quantize_device_ms": device_ms(call, "quantize_"),
             "trunk_bound_ms": int8_attention_bound(32, 16, 2048, 64)[0]}
    rows[key].update(trunk)
    print(f"int8 attention, b32 int8_attn trunk (T 2048, padding mask): {trunk['trunk_ms']:.3f} "
          f"ms, plain {trunk['trunk_plain_ms']:.3f} ms; device time: kernel "
          f"{ms_text(trunk['trunk_kernel_device_ms'])}, quantization pass "
          f"{ms_text(trunk['trunk_quantize_device_ms'])}")
    errs["int8_attention"] = max(errs["int8_attention"], check_int8_attention(
        "b32 int8_attn trunk (32, 2048, 16, 64) + padding mask", q, k, v, slopes, pos, mask,
        False))
    del q, k, v
    torch.cuda.empty_cache()
    return errs


def attention_device_ms(kernel_fn, library_fn):
    """Device time (torch.profiler) of the dense-bias forward kernel and of
    every kernel one library call launches."""
    return {"device_ms": device_ms(kernel_fn, "bias_attention_kernel"),
            "library_device_ms": device_ms(library_fn, "")}


def image_kernel_times(gen, dev, row, rows):
    """The image modality's kernels at the ViT-B/16 b64 serving shapes (N =
    64 x 196 rows, C 768, M 3072; H 12, T 196 with the 2-D ALiBi bias): the
    fused block with its GEMM launches beside F.linear (device times), the
    fused MLP and its int8 twin (with x's quantization) beside their plain
    versions and the int8 products alone (torch._int_mm), the int8 dense
    projection's GEMM launch at the qkv and out widths beside
    torch._int_mm (device times), the dense-bias attention beside SDPA with
    the bias as a bf16 float mask, both also by device time."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.bias_attention import bias_attention_plain, bias_flash_attention
    from animal2vec_tpu_torch.ops.fused_mlp import (
        fused_block_mlp, fused_block_plain, fused_mlp, fused_mlp_int8, fused_mlp_int8_plain,
        fused_mlp_plain,
    )
    from animal2vec_tpu_torch.ops.int8_mm import (
        int8_dense, int8_dense_plain, quantize_rows, quantize_weight,
    )

    n, c, m = IMAGE_BATCH * IMAGE_T, 768, 3072
    block_args = block_inputs(gen, n, c, m, dev)
    x, _, _, w1, w2, b1, b2 = block_args[:7]
    row("fused block, b64 ViT-B serving", cuda_ms(lambda: fused_block_mlp(*block_args)),
        cuda_ms(lambda: fused_block_plain(*block_args), iters=3), None, block_bound(n, c, m))
    rows["fused block, b64 ViT-B serving"].update(block_gemm_splits(block_args))
    w1l, w2l = w1.t().contiguous(), w2.t().contiguous()
    row("fused MLP, b64 ViT-B serving", cuda_ms(lambda: fused_mlp(x, w1l, w2l, b1, b2)),
        cuda_ms(lambda: fused_mlp_plain(x, w1l, w2l, b1, b2), iters=3), None, mlp_bound(n, c, m))
    rows["fused MLP, b64 ViT-B serving"].update(
        gemm_splits(lambda: fused_mlp(x, w1l, w2l, b1, b2), x, w1l, w2l, b1, b2))
    w1_q, w1_s = quantize_weight(w1l)
    w2_q, w2_s = quantize_weight(w2l)
    args = (x, w1_q, w1_s, b1, w2_q, w2_s, b2)
    row("int8 fused MLP, b64 ViT-B serving", cuda_ms(lambda: fused_mlp_int8(*args)),
        cuda_ms(lambda: fused_mlp_int8_plain(*args), iters=3), None, int8_mlp_bound(n, c, m))
    rows["int8 fused MLP, b64 ViT-B serving"].update(
        int8_mlp_splits(args, "int8 fused MLP, b64 ViT-B serving"))
    x_q, _ = quantize_rows(x)
    # #10 at the ViT-B/16 qkv (768 -> 2304) and out (768 -> 768) widths:
    # its GEMM launch beside torch._int_mm, device times
    dense_row = rows["int8 dense qkv projection, b32 serving"]
    for what, width in (("qkv", 3 * c), ("out", c)):
        wd_q, wd_s = quantize_weight(w1l[:width])
        gemm = device_ms(lambda: int8_dense(x, wd_q, wd_s), "gemm_s8_sm90")
        lib = device_ms(lambda: torch._int_mm(x_q, wd_q.t()), "")
        bnd = int8_dense_bound(n, c, width)
        dense_row.update({f"image_{what}_ms": cuda_ms(lambda: int8_dense(x, wd_q, wd_s)),
                          f"image_{what}_plain_ms": cuda_ms(
                              lambda: int8_dense_plain(x, wd_q, wd_s), iters=3),
                          f"image_{what}_gemm_device_ms": gemm,
                          f"image_{what}_library_device_ms": lib,
                          f"image_{what}_bound_ms": bnd[0], f"image_{what}_bound_by": bnd[1]})
        print(f"  int8 dense {what} projection, b64 ViT-B (N {n}, K {c} -> {width}): kernel "
              f"{dense_row[f'image_{what}_ms']:.3f} ms, plain "
              f"{dense_row[f'image_{what}_plain_ms']:.3f} ms; GEMM launch {ms_text(gemm)} device, "
              f"torch._int_mm {ms_text(lib)} device, bound {bnd[0]:.4f} ms ({bnd[1]})")
    h_q = torch.randint(-127, 128, (n, m), generator=gen, device=dev, dtype=torch.int8)
    print(f"  (the int8 products alone, torch._int_mm on pre-quantized operands: fc1 "
          f"{cuda_ms(lambda: torch._int_mm(x_q, w1_q.t())):.3f} ms, fc2 "
          f"{cuda_ms(lambda: torch._int_mm(h_q, w2_q.t())):.3f} ms)")
    del x, x_q, h_q, args, block_args
    q, k, v = bias_attention_inputs(gen, IMAGE_BATCH, IMAGE_HEADS, IMAGE_T, dev)
    bias = image_bias(IMAGE_HEADS, IMAGE_T, dev)
    qs, ks, vs = (a.transpose(1, 2) for a in (q, k, v))  # (B, H, T, D) views
    mask = bias.to(torch.bfloat16)
    key = "bias attention, b64 ViT-B serving"
    row(key, cuda_ms(lambda: bias_flash_attention(q, k, v, bias)),
        cuda_ms(lambda: bias_attention_plain(q, k, v, bias), iters=3),
        cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)),
        bias_attention_bound(IMAGE_BATCH, IMAGE_HEADS, IMAGE_T, 64))
    rows[key].update(attention_device_ms(lambda: bias_flash_attention(q, k, v, bias),
                                         lambda: F.scaled_dot_product_attention(
                                             qs, ks, vs, attn_mask=mask)))
    rows[key]["no_bias_device_ms"] = device_ms(lambda: bias_flash_attention(q, k, v),
                                               "bias_attention_kernel")
    print(f"  device time: kernel {ms_text(rows[key]['device_ms'])} (no bias "
          f"{ms_text(rows[key]['no_bias_device_ms'])}), SDPA "
          f"{ms_text(rows[key]['library_device_ms'])}")
    print("  (library: SDPA with the 2-D ALiBi bias as a (1, H, T, T) bf16 float mask)")


def bias_attention_bwd_bounds(b, h, t, d, bias_rows=1, dbias=True):
    """Bounds of the dense-bias forward with lse, dq + dbias, dk/dv and the
    single backward launch: 2, 3, 4 and 5 products of 2*T^2*D per (b, h);
    bf16 q, k, v, dO and fp32 lse, delta read once, the fp32 bias planes
    (``bias_rows`` of them) read once, the outputs written once (dbias: B
    planes of fp32)."""
    bhtd, bht, plane = b * h * t * d, b * h * t, 4 * h * t * t
    flops = 2 * bhtd * t
    inputs = 2 * 4 * bhtd + 2 * 4 * bht + bias_rows * plane
    dbias_out = b * plane if dbias else 0
    return {
        "forward": bound(2 * flops, 2 * 4 * bhtd + 4 * bht + bias_rows * plane),
        "dq": bound(3 * flops, inputs + 2 * bhtd + dbias_out),
        "dkv": bound(4 * flops, inputs + 2 * 2 * bhtd),
        "single": bound(5 * flops, inputs + 2 * 3 * bhtd + dbias_out),
    }


def keep_set_bias(rng, b, h, keep, dev, scale=0.7):
    """The per-row (B, H, K, K) fp32 bias a ViT-B/16 pretraining student
    takes: the 196-patch grid's 2-D ALiBi bias at each row's sorted random
    keep-set of ``keep`` patches, times a learned scale."""
    from animal2vec_tpu_torch.ops.masking import MaskInfo, masked_alibi

    ids = torch.from_numpy(np.stack([np.sort(rng.choice(IMAGE_T, keep, replace=False))
                                     for _ in range(b)])).to(dev)
    return masked_alibi(image_bias(h, IMAGE_T, dev), MaskInfo(None, None, None, ids)) * scale


def phase_bias_attention_train(dev):
    """3d. The dense-bias training kernels: the forward with lse, dq + dbias
    and dk/dv against their plain versions on the same bf16 inputs, lse and
    delta; then the autograd Function against autograd of the plain version
    in fp32. Shapes: the ViT-B/16 pretraining student (b128 = 64 x clone 2,
    H 12, 59 kept patches, per-row keep-set bias), the teacher's b64 T 196
    with the batch-uniform 2-D ALiBi bias and with none, and b8 T 1024 with
    a key mask whose row 3 masks every key. At T <= 64 also the single
    backward launch against the same plain version, and the device time of
    each launch."""
    from animal2vec_tpu_torch.ops.bias_attention import (
        SINGLE_T, bias_attention_bwd_plain, bias_attention_bwd_single, bias_attention_dkv,
        bias_attention_dq, bias_attention_forward, bias_attention_plain, bias_flash_attention,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    rng = np.random.default_rng(SEED + 12)
    h = IMAGE_HEADS
    mask = torch.zeros((8, 1024), dtype=torch.bool, device=dev)
    mask[1, -100:] = True
    mask[3] = True
    cases = (
        ("per-row keep-set bias", 2 * IMAGE_BATCH, STUDENT_T,
         keep_set_bias(rng, 2 * IMAGE_BATCH, h, STUDENT_T, dev), None),
        ("2-D ALiBi, batch-uniform", IMAGE_BATCH, IMAGE_T, image_bias(h, IMAGE_T, dev), None),
        ("no bias", IMAGE_BATCH, IMAGE_T, None, None),
        ("2-D ALiBi x 0.1, key mask, row 3 fully masked", 8, 1024,
         image_bias(h, 1024, dev) * 0.1, mask),
    )
    errs = {"forward": 0.0, "dq": 0.0, "dkv": 0.0, "single": 0.0}
    for label, b, t, bias, pad in cases:
        name = f"bias attention training b{b} T {t} {label}"
        q, k, v = bias_attention_inputs(gen, b, h, t, dev)
        out, lse = bias_attention_forward(q, k, v, bias, pad, with_lse=True)
        out_p, lse_p = bias_attention_plain(q.float(), k.float(), v.float(), bias, pad,
                                            return_lse=True)
        torch.cuda.synchronize()
        errs["forward"] = max(errs["forward"], check_close(f"{name} out", out, out_p, ATTN_TOL))
        check_close(f"{name} lse", lse, lse_p, LSE_TOL)
        dout = torch.randn((b, t, h, 64), generator=gen, device=dev).to(torch.bfloat16)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, t)
        args = (q, k, v, dout, lse, delta, bias, pad)
        dq, dbias = bias_attention_dq(*args)
        dk, dv = bias_attention_dkv(*args)
        want = bias_attention_bwd_plain(*args)
        torch.cuda.synchronize()
        errs["dq"] = max(errs["dq"], check_close(f"{name} dq", dq, want[0], BWD_TOL))
        errs["dkv"] = max(errs["dkv"], check_close(f"{name} dk", dk, want[1], BWD_TOL),
                          check_close(f"{name} dv", dv, want[2], BWD_TOL))
        check_heads(name, ("dq", "dk", "dv"), [x.transpose(1, 2) for x in (dq, dk, dv)],
                    [x.transpose(1, 2) for x in want[:3]], REL_HEAD, ulps=2)
        if bias is not None:
            errs["dq"] = max(errs["dq"],
                             check_close(f"{name} dbias", dbias, want[3], DBIAS_TOL))
        if t <= SINGLE_T:
            # the single launch the autograd Function takes at T <= 64, and
            # each launch's device time
            got1 = bias_attention_bwd_single(*args)
            torch.cuda.synchronize()
            for i, what in enumerate(("dq", "dk", "dv")):
                errs["single"] = max(errs["single"], check_close(
                    f"{name} single launch {what}", got1[i], want[i], BWD_TOL))
            check_heads(f"{name} single launch", ("dq", "dk", "dv"),
                        [x.transpose(1, 2) for x in got1[:3]],
                        [x.transpose(1, 2) for x in want[:3]], REL_HEAD, ulps=2)
            if bias is not None:
                errs["single"] = max(errs["single"], check_close(
                    f"{name} single launch dbias", got1[3], want[3], DBIAS_TOL))
            split = {what: device_ms(lambda: fn(*args), kernel) for what, fn, kernel in (
                ("dq + dbias", bias_attention_dq, "bias_attention_dq"),
                ("dk/dv", bias_attention_dkv, "bias_attention_dkv"),
                ("single launch", bias_attention_bwd_single, "bias_attention_bwd_single"))}
            print(f"{name} device time a launch: "
                  + ", ".join(f"{what} {ms_text(ms)}" for what, ms in split.items()))
            del got1
        del want, out_p, lse_p
        # the autograd Function (the model's entry) on the views of one
        # (B, T, 3, H, D) projection against autograd of the plain version
        qkv = torch.stack((q, k, v), dim=2)
        leaves = [qkv.clone().requires_grad_()]
        leaves_p = [qkv.float().requires_grad_()]
        if bias is not None:
            leaves.append(bias.clone().requires_grad_())
            leaves_p.append(bias.clone().requires_grad_())
        got = torch.autograd.grad(
            bias_flash_attention(*leaves[0].unbind(2), *leaves[1:], pad), leaves, dout)
        ref = torch.autograd.grad(
            bias_attention_plain(*leaves_p[0].unbind(2), *leaves_p[1:], pad), leaves_p,
            dout.float())
        check_rel(f"{name} d qkv vs autograd of plain", got[0], ref[0], REL_QKV)
        if bias is not None:
            check_rel(f"{name} d bias vs autograd of plain", got[1], ref[1], REL_QKV)
        del qkv, leaves, leaves_p, got, ref
    torch.cuda.empty_cache()
    return errs


BIAS_DROP, BIAS_DROP_SEED = 0.1, 20261017  # phase 15c: JAX's image attention_dropout


def _onehot_chunk(b, t, h, c, dev):
    """(B, T, H, 64) bf16: row 64 c + d is the unit vector e_d (other rows 0)."""
    x = torch.zeros((b, t, h, 64), dtype=torch.bfloat16, device=dev)
    rows = torch.arange(64 * c, min(64 * c + 64, t), device=dev)
    x[:, rows, :, rows - 64 * c] = 1.0
    return x


def kernel_keep_masks(b, h, t, bias, rate, seed, dev):
    """The (B, H, T, T) keep masks that #11's forward and #11b's dq, dk/dv and
    single launches apply, read back through their outputs: with q = k = 0
    (uniform weights 1/T) and the layout's bias set to 0, out = P f V with
    V the unit vectors of one chunk of 64 keys gives f at those keys; dv =
    (P f)^T dO with dO the unit vectors of 64 queries gives f at those
    queries; dq = dS K / sqrt(D) with dP = 1 everywhere (V = dO = e_0) and K
    the unit vectors of 64 keys gives dS = (f - delta) / T, which is >= 0
    where kept and -delta / T < 0 where dropped."""
    from animal2vec_tpu_torch.ops.bias_attention import (
        SINGLE_T, bias_attention_bwd_single, bias_attention_dkv, bias_attention_dq,
        bias_attention_forward,
    )

    zero = torch.zeros((b, t, h, 64), dtype=torch.bfloat16, device=dev)
    bias0 = None if bias is None else torch.zeros_like(bias)
    e0 = zero.clone()
    e0[..., 0] = 1.0
    drop = dict(rate=rate, seed=seed)
    masks = {what: torch.zeros((b, h, t, t), dtype=torch.bool, device=dev)
             for what in ("forward", "dq", "dkv") + (("single dq", "single dv")
                                                       if t <= SINGLE_T else ())}
    _, lse = bias_attention_forward(zero, zero, zero, bias0, None, True, **drop)
    out_e0 = bias_attention_forward(zero, zero, e0, bias0, None, False, **drop)
    delta = out_e0.float()[..., 0].transpose(1, 2).reshape(b * h, t)
    for c in range(-(-t // 64)):
        n = min(64, t - 64 * c)
        unit = _onehot_chunk(b, t, h, c, dev)
        out = bias_attention_forward(zero, zero, unit, bias0, None, False, **drop)
        masks["forward"][..., 64 * c:64 * c + n] = out[..., :n].transpose(1, 2) > 0
        zdelta = torch.zeros((b * h, t), dtype=torch.float32, device=dev)
        _, dv = bias_attention_dkv(zero, zero, zero, unit, lse, zdelta, bias0, None, **drop)
        # dv[b, j, h, d] = f(query 64 c + d, key j) / T
        masks["dkv"][:, :, 64 * c:64 * c + n, :] = dv[..., :n].permute(0, 2, 3, 1) > 0
        dq, _ = bias_attention_dq(zero, unit, e0, e0, lse, delta, bias0, None,
                                  want_dbias=False, **drop)
        ds = dq[..., :n].float().transpose(1, 2) * (8.0 * t)  # dS * T: (f - delta)
        masks["dq"][..., 64 * c:64 * c + n] = ds > -0.5 * delta.reshape(b, h, t, 1)
        if t <= SINGLE_T:
            got = bias_attention_bwd_single(zero, zero, zero, unit, lse, zdelta, bias0, None,
                                            want_dbias=False, **drop)
            masks["single dv"][..., :n, :] = got[2][..., :n].permute(0, 2, 3, 1) > 0
            got = bias_attention_bwd_single(zero, unit, e0, e0, lse, delta, bias0, None,
                                            want_dbias=False, **drop)
            ds = got[0][..., :n].float().transpose(1, 2) * (8.0 * t)
            masks["single dq"][..., :n] = ds > -0.5 * delta.reshape(b, h, t, 1)
    torch.cuda.synchronize()
    return masks


def phase_bias_dropout(dev):
    """15c. The hash-dropout site of #11 and #11b at JAX's image
    attention_dropout 0.1, at the ViT-B/16 teacher's b64 H12 T196 with the
    batch-uniform 2-D ALiBi bias and at the pretraining student's b128 T59
    with its per-row keep-set bias: each launch's keep mask read back through
    its outputs (``kernel_keep_masks``) equal bit for bit to
    ``attention_keep``'s (the plain twin's); out, lse, dq, dk, dv and dbias
    (and the single launch's at T 59) against the plain twin under that
    mask; the autograd Function against autograd of the plain twin; times
    beside the plain twin, SDPA with the bias as a float mask and dropout_p
    0.1, and the bound. Returns (errors, rows)."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.bias_attention import (
        SINGLE_T, attention_keep, bias_attention_bwd_plain, bias_attention_bwd_single,
        bias_attention_dkv, bias_attention_dq, bias_attention_forward, bias_attention_plain,
        bias_flash_attention,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    rng = np.random.default_rng(SEED + 40)
    h, rate = IMAGE_HEADS, BIAS_DROP
    cases = (("ViT-B/16 teacher, 2-D ALiBi batch-uniform", IMAGE_BATCH, IMAGE_T,
              image_bias(h, IMAGE_T, dev)),
             ("ViT-B/16 student, per-row keep-set bias", 2 * IMAGE_BATCH, STUDENT_T,
              keep_set_bias(rng, 2 * IMAGE_BATCH, h, STUDENT_T, dev)))
    errs = {"forward": 0.0, "dq": 0.0, "dkv": 0.0, "single": 0.0}
    rows = {}
    for label, b, t, bias in cases:
        name = f"15c bias attention dropout {rate} b{b} T {t} {label}"
        seed = BIAS_DROP_SEED + t
        keep = attention_keep(b, h, t, rate, seed, dev).bool()
        got = kernel_keep_masks(b, h, t, bias, rate, seed, dev)
        for what, m in got.items():
            bad = int((m != keep).sum())
            print(f"{name}: {what} keep mask against attention_keep: {bad} of {keep.numel()} "
                  f"differ; keep rate {m.float().mean().item():.5f}")
            if bad:
                raise AssertionError(f"{name}: the {what} kernel's dropout mask differs")
        del got
        drop = dict(rate=rate, seed=seed)
        q, k, v = bias_attention_inputs(gen, b, h, t, dev)
        out, lse = bias_attention_forward(q, k, v, bias, None, True, **drop)
        out_p, lse_p = bias_attention_plain(q.float(), k.float(), v.float(), bias, None, True,
                                            keep, rate)
        torch.cuda.synchronize()
        errs["forward"] = max(errs["forward"], check_close(f"{name} out", out, out_p, ATTN_TOL))
        check_close(f"{name} lse", lse, lse_p, LSE_TOL)
        dout = torch.randn((b, t, h, 64), generator=gen, device=dev).to(torch.bfloat16)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, t)
        args = (q, k, v, dout, lse, delta, bias, None)
        dq, dbias = bias_attention_dq(*args, **drop)
        dk, dv = bias_attention_dkv(*args, **drop)
        want = bias_attention_bwd_plain(*args, keep, rate)
        torch.cuda.synchronize()
        errs["dq"] = max(errs["dq"], check_close(f"{name} dq", dq, want[0], BWD_TOL),
                         check_close(f"{name} dbias", dbias, want[3], DBIAS_TOL))
        errs["dkv"] = max(errs["dkv"], check_close(f"{name} dk", dk, want[1], BWD_TOL),
                          check_close(f"{name} dv", dv, want[2], BWD_TOL))
        check_heads(name, ("dq", "dk", "dv"), [x.transpose(1, 2) for x in (dq, dk, dv)],
                    [x.transpose(1, 2) for x in want[:3]], REL_HEAD, ulps=2)
        if t <= SINGLE_T:
            got1 = bias_attention_bwd_single(*args, **drop)
            torch.cuda.synchronize()
            for i, what in enumerate(("dq", "dk", "dv")):
                errs["single"] = max(errs["single"], check_close(
                    f"{name} single launch {what}", got1[i], want[i], BWD_TOL))
            errs["single"] = max(errs["single"], check_close(
                f"{name} single launch dbias", got1[3], want[3], DBIAS_TOL))
            del got1
        # the autograd Function against autograd of the plain twin
        qkv = torch.stack((q, k, v), dim=2)
        leaves = [qkv.clone().requires_grad_(), bias.clone().requires_grad_()]
        leaves_p = [qkv.float().requires_grad_(), bias.clone().requires_grad_()]
        g_k = torch.autograd.grad(bias_flash_attention(*leaves[0].unbind(2), leaves[1], None,
                                                       rate, seed), leaves, dout)
        g_p = torch.autograd.grad(bias_attention_plain(*leaves_p[0].unbind(2), leaves_p[1], None,
                                                       False, keep, rate), leaves_p, dout.float())
        check_rel(f"{name} d qkv vs autograd of plain", g_k[0], g_p[0], REL_QKV)
        check_rel(f"{name} d bias vs autograd of plain", g_k[1], g_p[1], REL_QKV)
        del qkv, leaves, leaves_p, g_k, g_p, want
        # times: the kernels' forward + backward through the autograd Function
        # beside the plain twin's and SDPA's with dropout_p (its own mask)
        bounds = bias_attention_bwd_bounds(b, h, t, 64, bias_rows=1 if bias.shape[0] == 1 else b)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
        leaves_p = [x.detach().float().clone().requires_grad_() for x in (q, k, v, bias)]
        qs, ks, vs = (x.detach().transpose(1, 2).clone().requires_grad_() for x in (q, k, v))
        mask = bias.to(torch.bfloat16).expand(b, h, t, t).clone().requires_grad_()

        def kernel_fb():
            torch.autograd.grad(bias_flash_attention(*leaves[:3], leaves[3], None, rate, seed),
                                leaves, dout)

        def plain_fb():
            torch.autograd.grad(bias_attention_plain(*leaves_p[:3], leaves_p[3], None, False,
                                                     keep, rate), leaves_p, dout.float())

        def sdpa_fb():
            o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, dropout_p=rate)
            torch.autograd.grad(o, (qs, ks, vs, mask), dout.transpose(1, 2))

        fwd_b, dq_b, dkv_b, single_b = (bounds[x] for x in ("forward", "dq", "dkv", "single"))
        bwd_b = single_b if t <= SINGLE_T else (dq_b[0] + dkv_b[0], "bytes"
                                                if dq_b[1] == dkv_b[1] == "bytes" else "operations")
        key = f"bias attention forward + backward, dropout {rate}, b{b} T {t}"
        rows[key] = {"ms": cuda_ms(kernel_fb), "plain_ms": cuda_ms(plain_fb, iters=3),
                     "library_ms": cuda_ms(sdpa_fb), "bound_ms": fwd_b[0] + bwd_b[0],
                     "bound_by": fwd_b[1] if fwd_b[1] == bwd_b[1] else "bytes"}
        with torch.no_grad():
            fwd_only = {"ms": cuda_ms(lambda: bias_attention_forward(q, k, v, bias, None, True,
                                                                     **drop)),
                        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                            qs, ks, vs, attn_mask=mask, dropout_p=rate)),
                        "bound_ms": fwd_b[0]}
        rows[key]["forward"] = fwd_only
        r = rows[key]
        print(f"{name}: forward + backward kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"SDPA dropout_p {rate} {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms; "
              f"forward alone kernel {fwd_only['ms']:.3f} ms, SDPA {fwd_only['library_ms']:.3f} "
              f"ms, bound {fwd_only['bound_ms']:.3f} ms")
        del q, k, v, dout, leaves, leaves_p, qs, ks, vs, mask, keep, out, out_p
        torch.cuda.empty_cache()
    return errs, rows


def pretrain_launches(cfg, pre_ln=False):
    """The launches of one pretraining step (``update_freq`` micro-batches):
    the student's blocks with their backward, the teacher's forward only."""
    from animal2vec_tpu_torch.ops.bias_attention import SINGLE_T
    from animal2vec_tpu_torch.train.pretrain import mask_tokens

    n = cfg.model.n_blocks
    want = dict.fromkeys(_counted(), 0)
    if cfg.modality == "IMAGE":
        # the student's kept patches (ViT-B/16: 59) take the single backward
        # launch at T <= 64, else dq + dbias and dk/dv
        t = cfg.model.num_patches
        backward = ({"bias_single": n} if t - mask_tokens(cfg, t) <= SINGLE_T else
                    {"bias_dq": n, "bias_dkv": n})
        want.update({"bias_attention": 2 * n, ("mlp" if pre_ln else "block"): 2 * n},
                    **backward)
    else:
        # the student's attention with lse and dropout, the teacher's serving
        want.update(attention=n, serve_attention=n, dq=n, dkv=n, block=2 * n)
    return {k: v * cfg.optimization.update_freq for k, v in want.items()}


def pretrain_batch(cfg, dev, batch, seed, accum=None):
    """``accum`` micro-batches (the config's update_freq by default) of
    ``batch`` 10-s windows or images (224 x 224 for ViT-B/16)."""
    rng = np.random.default_rng(seed)
    side = None if cfg.modality == "AUDIO" else cfg.model.input_size
    one = (WAV_LEN,) if side is None else (side, side, cfg.model.in_chans)
    shape = (accum or cfg.optimization.update_freq, batch) + one
    return {"source": torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)}


def phase_pretrain(cfg, card, dev, batch, label, unit, pre_ln=False, steps=3,
                   dtype=torch.bfloat16):
    """Pretraining steps of the full-width model ``cfg`` at ``batch`` x
    ``clone_batch`` in the compute ``dtype``, from the last warmup step:
    ``steps`` checked steps (finite loss and gradients, the launch counts,
    no plain version on a CUDA tensor, the teacher subset of
    ``ema_param_label`` and its EMA step of exactly (1 - d)(s - t)), then 3
    timed ones. Returns the launches of the checked steps."""
    from animal2vec_tpu_torch.models.data2vec2 import ema_param_label
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.pretrain import make_pretrain_train_step
    from animal2vec_tpu_torch.train.state import PretrainState, ema_decay_at

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_pretrain_model(cfg, dtype=dtype, seed=SEED, device=dev)
    state = PretrainState.create(model, cfg)
    # start at the end of the warmup: its first learning rate is 0, which
    # would leave student and teacher where they are
    state.step = cfg.optimization.warmup_updates
    params = dict(model.named_parameters())
    subset = {n for n in params if ema_param_label(n, cfg.ema_encoder_only)}
    frontend = ("local_encoder", "project_", "patch_embed", "decoder")
    if set(state.ema) != subset or any(f in n for n in subset for f in frontend):
        raise AssertionError(f"{label}: the teacher subset is not ema_param_label's")
    print(f"{label}: teacher subset {len(subset)} of {len(params)} tensors "
          f"(ema_encoder_only {cfg.ema_encoder_only}), no frontend or decoder tensor")
    step_fn = make_pretrain_train_step(cfg)
    data = pretrain_batch(cfg, dev, batch, SEED + 14)
    rngs = Rngs.from_seed(SEED, dev)
    want = pretrain_launches(cfg, pre_ln)
    totals = dict.fromkeys(_counted(), 0)
    for i in range(steps):
        before = {n: t.clone() for n, t in state.ema.items()}
        reset_counts()
        with PlainSpy() as spy:
            metrics = step_fn(state, data, rngs)
        torch.cuda.synchronize()
        got = counts()
        loss = float(metrics["loss"])
        d = ema_decay_at(cfg, state.step)
        ema_err = max((state.ema[n] - torch.lerp(before[n], params[n].detach().float(), 1.0 - d))
                      .abs().max().item() for n in subset)
        moved = sum(not torch.equal(before[n], state.ema[n]) for n in subset)
        print(f"{label} step {i + 1}: loss {loss:.5f}, target_var "
              f"{float(metrics['target_var']):.4f}; launches {launch_line(got)} (expected "
              f"{launch_line(want)}); plain-version calls on CUDA tensors {spy.cuda_calls}; "
              f"EMA d {d:.6f}: {moved} of {len(subset)} teacher tensors moved, max "
              f"|t' - lerp(t, s, 1 - d)| {ema_err:.2e}")
        if not np.isfinite(loss):
            raise AssertionError(f"{label}: non-finite loss")
        for n, p in params.items():
            if p.grad is None or not torch.isfinite(p.grad).all():
                raise AssertionError(f"{label}: missing or non-finite gradient {n}")
        if got != want or spy.cuda_calls:
            raise AssertionError(f"{label}: launch counts {got} != {want}, or a plain call")
        if not ema_err <= EMA_TOL or moved == 0:
            raise AssertionError(f"{label}: the teacher did not take the EMA step")
        totals = {k: totals[k] + v for k, v in got.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn(state, data, rngs)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    n = batch * cfg.optimization.update_freq
    print(f"{label} b{batch} x clone {cfg.clone_batch} x update_freq {n // batch}: "
          f"{dt * 1e3:.1f} ms per step, {n / dt:.2f} {unit}/s, peak memory {peak_gb:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) on {card}")
    del state, model, params, data
    torch.cuda.empty_cache()
    return totals


def phase_pretrain_grads(cfg, dev, batch, label, dtype=torch.bfloat16, tol=MODEL_GRAD_TOL):
    """At ``batch`` x clone 2 with every rate at 0 (no mixup, dropout, noise
    fills or decoder input dropout), the biases moved off 0, and one mask
    drawn once, the loss's gradients through the kernels against those
    through the plain versions in the compute ``dtype``, one relative norm
    per parameter tensor (the learned ALiBi scale included), within
    ``tol``."""
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.pretrain import draw_pretrain_mask, pretrain_loss
    from animal2vec_tpu_torch.train.state import ema_subset

    cfg = dataclasses.replace(
        cfg, clone_batch=2, encoder_dropout=0.0, attention_dropout=0.0,
        post_mlp_drop=0.0, prenet_dropout=0.0, mask_noise_std=0.0,
        source_mixup=-1.0, decoder=dataclasses.replace(cfg.decoder, input_dropout=0.0))
    model = build_pretrain_model(cfg, dtype=dtype, seed=SEED, device=dev)
    # At init the decoder's biases are 0 and, with the noise fill off, so
    # are its mask tokens: at a masked frame whose receptive field holds no
    # kept token the decoder's LayerNorm normalizes a zero vector, and its
    # backward scales by rsqrt(1e-5) = 316, so the bias gradients amplify
    # any rounding the two paths take apart. Seeded biases away from 0, as
    # the CPU tests jitter theirs, make the comparison well-conditioned.
    gen = torch.Generator().manual_seed(SEED + 18)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".bias"):
                p.add_((0.05 * torch.randn(p.shape, generator=gen)).to(p.device))
    ema = ema_subset(model, cfg.ema_encoder_only)
    mb = {k: v[0] for k, v in pretrain_batch(cfg, dev, batch, SEED + 15).items()}
    masks = {}

    def draw(rows, t, rngs):
        if (rows, t) not in masks:
            masks[rows, t] = draw_pretrain_mask(cfg, rows, t, Rngs.from_seed(SEED + 16, "cpu"))
        return masks[rows, t]

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = pretrain_loss(model, ema, mb, Rngs.from_seed(SEED, dev), cfg, True, draw)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float().clone()
                                      for n, p in model.named_parameters()}

    loss_k, g_k = grads()
    with PlainOps():
        loss_p, g_p = grads()
    torch.cuda.synchronize()
    rels = {n: rel_norm(g_k[n], g_p[n]) for n in g_p if g_p[n].norm() > 0}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    scale = [n for n in rels if n.endswith("alibi_scale")]
    print(f"{label} gradients b{batch} x clone 2, kernel vs plain path: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}; relative norm per tensor: max {worst[0][1]:.3e}, median "
          f"{float(np.median(list(rels.values()))):.3e} over {len(rels)} tensors (tolerance "
          f"{tol}); ALiBi scale {[f'{rels[n]:.2e}' for n in scale]}; worst "
          f"{[(n, f'{r:.2e}') for n, r in worst]}")
    if not scale or set(rels) != set(n for n in g_k if g_k[n].norm() > 0):
        raise AssertionError(f"{label}: the paths give gradients to different parameters")
    if not max(rels.values()) <= tol:
        raise AssertionError(f"{label}: kernel-path gradients disagree with the plain path")
    del model, g_k, g_p
    torch.cuda.empty_cache()
    return max(rels.values())


def pretrain_kernel_times(gen, dev, row, rows):
    """The dense-bias training kernels at the ViT-B/16 pretraining student's
    shape (b128, H 12, 59 kept patches, per-row bias): the forward with lse,
    dq + dbias, dk/dv and the single backward launch beside their plain
    versions, each also by device time, and the library call: SDPA with the
    bias as a bf16 float mask, forward alone and forward + backward with the
    mask requiring grad, and its backward alone (also by device time)."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.bias_attention import (
        bias_attention_bwd_plain, bias_attention_bwd_single, bias_attention_dkv,
        bias_attention_dq, bias_attention_forward, bias_attention_plain,
    )

    b, h, t = 2 * IMAGE_BATCH, IMAGE_HEADS, STUDENT_T
    bias = keep_set_bias(np.random.default_rng(SEED + 17), b, h, t, dev)
    q, k, v = bias_attention_inputs(gen, b, h, t, dev)
    dout = torch.randn((b, t, h, 64), generator=gen, device=dev).to(torch.bfloat16)
    bounds = bias_attention_bwd_bounds(b, h, t, 64, bias_rows=b)
    with torch.inference_mode():
        out, lse = bias_attention_forward(q, k, v, bias, None, True)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, t)
        args = (q, k, v, dout, lse, delta, bias)
        qs, ks, vs = (a.transpose(1, 2) for a in (q, k, v))
        mask = bias.to(torch.bfloat16)
        key = "bias attention forward + lse, b128 ViT-B pretraining student"
        row(key, cuda_ms(lambda: bias_attention_forward(q, k, v, bias, None, True)),
            cuda_ms(lambda: bias_attention_plain(q, k, v, bias, return_lse=True), iters=3),
            cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)),
            bounds["forward"])
        rows[key].update(attention_device_ms(
            lambda: bias_attention_forward(q, k, v, bias, None, True),
            lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)))
        print(f"  device time: kernel {ms_text(rows[key]['device_ms'])}, SDPA "
              f"{ms_text(rows[key]['library_device_ms'])}")
        plain_bwd = cuda_ms(lambda: bias_attention_bwd_plain(*args), iters=3)
    leaves = [a.detach().clone().requires_grad_() for a in (qs, ks, vs, mask)]
    g = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
        torch.autograd.grad(o, leaves, g)

    lib_fwd_bwd = cuda_ms(sdpa_fwd_bwd)
    o = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
    sdpa_bwd = lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)
    lib = {"library_bwd_ms": cuda_ms(sdpa_bwd), "library_bwd_device_ms": device_ms(sdpa_bwd, "")}
    for key, fn, kernel, bnd in (
            ("bias attention dq + dbias", bias_attention_dq, "bias_attention_dq", bounds["dq"]),
            ("bias attention dk/dv", bias_attention_dkv, "bias_attention_dkv", bounds["dkv"]),
            ("bias attention single backward launch", bias_attention_bwd_single,
             "bias_attention_bwd_single", bounds["single"])):
        key = f"{key}, b128 ViT-B pretraining student"
        row(key, cuda_ms(lambda: fn(*args)), plain_bwd, lib_fwd_bwd, bnd)
        rows[key].update(lib, device_ms=device_ms(lambda: fn(*args), kernel))
        print(f"  device time: kernel {ms_text(rows[key]['device_ms'])}")
    print(f"  (plain: bias_attention_bwd_plain computes dq, dk, dv and dbias in one call; "
          f"library: SDPA forward + backward with the per-row bias as a bf16 mask requiring "
          f"grad; SDPA's backward alone {lib['library_bwd_ms']:.3f} ms, device "
          f"{ms_text(lib['library_bwd_device_ms'])})")
    del q, k, v, dout, leaves, bias, o
    torch.cuda.empty_cache()


ENTRY_CLIPS, ENTRY_SERVE_SECONDS = 24, 30
# the phase's overrides of the two recipes (printed by the phase): one
# micro-batch a step, 10-s clips, the synthetic labels' .npz files, no
# tensorboard directory, two checkpoints kept (and best)
ENTRY_COMMON = ("task.max_sample_size=80000", "task.label_ext=npz", "common.tensorboard_logdir=",
                "dataset.num_workers=8", "checkpoint.keep_last=2")
ENTRY_PRETRAIN = ENTRY_COMMON + ("pretrain.optimization.update_freq=1",)
ENTRY_FINETUNE = ENTRY_COMMON + (
    "finetune.optimization.update_freq=1", "dataset.batch_size=4",
    "finetune.freeze_finetune_updates=0", "task.min_label_size=0",
    "dataset.validate_interval_updates=2", "dataset.validate_after_updates=0")


class EntryWatch:
    """Wrap the training loop's step makers, validation and train loader
    while the entry points run: each step's loss, launches, blocks run and
    host time (ending in the loss's read-back), each validation's launches
    and blocks run, the loader state a run starts from, and the live state."""

    def __enter__(self):
        import animal2vec_tpu_torch.train.loop as loop
        from animal2vec_tpu_torch.models.modules import AltBlock

        self.loop = loop
        self.steps, self.validations, self.loaders = [], [], []
        self.state = None
        self.ran = [0]

        def hook(module, args):
            if isinstance(module, AltBlock):
                self.ran[0] += 1

        self.handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
        self.saved = {n: getattr(loop, n) for n in (
            "make_finetune_train_step", "make_pretrain_train_step", "validate_finetune",
            "_train_loader")}

        def watched_maker(make):
            def maker(cfg, *args, **kwargs):
                step_fn = make(cfg, *args, **kwargs)

                def step(state, batch, rngs):
                    self.state, start = state, state.step
                    self.ran[0] = 0
                    before = counts()
                    t0 = time.perf_counter()
                    metrics = step_fn(state, batch, rngs)
                    loss = float(metrics["loss"])
                    dt = time.perf_counter() - t0
                    after = counts()
                    self.steps.append(dict(start=start, loss=loss, seconds=dt, ran=self.ran[0],
                                           launched={k: after[k] - before[k] for k in after}))
                    return metrics
                return step
            return maker

        def validate(*args, **kwargs):
            self.ran[0] = 0
            before = counts()
            out = self.saved["validate_finetune"](*args, **kwargs)
            after = counts()
            self.validations.append(dict(ran=self.ran[0], out=out,
                                         launched={k: after[k] - before[k] for k in after}))
            return out

        def train_loader(*args, **kwargs):
            loader = self.saved["_train_loader"](*args, **kwargs)
            self.loaders.append(loader.state_dict())
            return loader

        from animal2vec_tpu_torch.parallel import mesh

        self.mesh, self.groups = mesh, []
        self.saved_init = mesh.init_data_parallel

        def init(*args, **kwargs):
            dp = self.saved_init(*args, **kwargs)
            self.groups.append((dist_backend(), dp.world))
            return dp

        mesh.init_data_parallel = init
        loop.make_finetune_train_step = watched_maker(self.saved["make_finetune_train_step"])
        loop.make_pretrain_train_step = watched_maker(self.saved["make_pretrain_train_step"])
        loop.validate_finetune = validate
        loop._train_loader = train_loader
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.loop, n, f)
        self.mesh.init_data_parallel = self.saved_init
        self.handle.remove()
        return False


def dist_backend() -> str:
    import torch.distributed as dist

    return dist.get_backend()


def _same_train_state(a, b) -> bool:
    """Model, Adam moments and count, and step bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k]) for k in sa):
        return False
    ma = {g["name"]: a.optimizer.state.get(g["params"][0]) for g in a.optimizer.param_groups}
    mb = {g["name"]: b.optimizer.state.get(g["params"][0]) for g in b.optimizer.param_groups}
    return (a.step == b.step and a.optimizer.count == b.optimizer.count and ma.keys() == mb.keys()
            and all((ma[k] is None) == (mb[k] is None) and (ma[k] is None or (
                torch.equal(ma[k]["mu"], mb[k]["mu"]) and torch.equal(ma[k]["nu"], mb[k]["nu"])))
                    for k in ma))


class NativeWatch:
    """Count the C++ batch loader's decode calls (``runtime.native.
    decode_batch``, which the loader looks up on its module) and the items
    they decoded."""

    def __enter__(self):
        from animal2vec_tpu_torch.runtime import native

        self.native, self.real = native, native.decode_batch
        self.calls = self.items = 0

        def counted(paths, *args, **kwargs):
            self.calls += 1
            self.items += len(paths)
            return self.real(paths, *args, **kwargs)

        native.decode_batch = counted
        return self

    def __exit__(self, *exc):
        self.native.decode_batch = self.real
        return False


# 12b: the loader at a crop shorter than the corpus's 10-s clips, at the
# a2v_large_pretrain.yaml recipe's batch (max_tokens 408 000 over its 10-s
# windows: 5 clips)
LOADER_CROP, LOADER_BATCH = 64_000, 5
NORMALIZE_TOL = 2e-4  # the native normalization's float64 statistics against the Python path's


def phase_loader(data, card):
    """12b. The batch loader over the phase's corpus (24 synthetic 10-s clips
    with labels) at an 8-s crop and b5: the ms per batch of an epoch through
    the C++ decoder (the default) and through the Python one, in training
    (seeded random crops) and in evaluation (center crops); the native eval
    batches against the Python path's: normalized source within
    NORMALIZE_TOL, ids, valid lengths, padding masks and targets equal.
    Returns the ms per batch."""
    from animal2vec_tpu_torch.config import FinetuneConfig
    from animal2vec_tpu_torch.data.dataset import AudioLabelDataset, BatchLoader
    from animal2vec_tpu_torch.data.synthetic import DEFAULT_LABELS

    ds = AudioLabelDataset(os.path.join(data, "pretrain.tsv"), return_labels=True,
                           unique_labels=DEFAULT_LABELS,
                           conv_layers=FinetuneConfig().conv_layers, label_ext="npz")
    if not (ds.sizes > LOADER_CROP).all():
        raise AssertionError(f"12b: the corpus's clips are not all longer than {LOADER_CROP}")
    rows, batches = {}, {}
    for train in (True, False):
        for native in (True, False):
            loader = BatchLoader(ds, target_len=LOADER_CROP, batch_size=LOADER_BATCH,
                                 shuffle=train, seed=SEED, drop_last=train, num_workers=8,
                                 train=train, use_native=native)
            list(loader)  # warm: the files in the page cache, the threads started once
            with NativeWatch() as watch:
                t0 = time.perf_counter()
                got = list(loader)
                dt = time.perf_counter() - t0
            key = f"{'train' if train else 'eval'} {'native' if native else 'python'}"
            rows[key] = dt * 1e3 / len(got)
            batches[key] = got
            print(f"12b loader, {key}: {rows[key]:.2f} ms per b{LOADER_BATCH} batch of "
                  f"{LOADER_CROP}-sample crops ({len(got)} batches, {watch.calls} native decode "
                  f"calls) on the host of {card} (warm page cache)")
            if native != (watch.calls == len(got)):
                raise AssertionError(f"12b {key}: {watch.calls} native decode calls")
    for a, b in zip(batches["eval native"], batches["eval python"], strict=True):
        if a.keys() != b.keys():
            raise AssertionError(f"12b: eval batch keys {sorted(a)} != {sorted(b)}")
        err = (a["source"] - b["source"]).abs().max().item()
        same = all(torch.equal(a[k], b[k]) for k in a if k != "source")
        if not err <= NORMALIZE_TOL or not same:
            raise AssertionError(f"12b: native eval batch against the Python path: source "
                                 f"{err:.3e} (tolerance {NORMALIZE_TOL}), the rest equal {same}")
    print(f"12b native eval batches against the Python path: source within {NORMALIZE_TOL}, "
          f"ids, targets and masks equal ({len(batches['eval native'])} batches); train crops "
          f"differ by design (the C++ loader's own seeded offsets, as JAX's default loader)")
    return rows


def phase_entry(card, dev):
    """12. The training entry point: synthetic data (24 clips of 10 s with
    .npz labels, generate's 18/6 split), train_cli pretraining 2 steps
    (a2v_large_pretrain), train_cli finetuning 3 steps from that checkpoint
    (finetune_100 at b4, gate open) with one validation at step 2 (which
    writes best), a fresh state restored from the step-3 checkpoint against
    the live one, a resumed run to step 4, and infer_cli --checkpoint best on
    one 30-s recording. Returns the launches of the four runs."""
    from animal2vec_tpu_torch.config import RECIPES, FinetuneConfig, apply_overrides
    from animal2vec_tpu_torch.data.synthetic import generate
    from animal2vec_tpu_torch.data.wavio import write_wav
    from animal2vec_tpu_torch.tools import infer_cli, train_cli
    from animal2vec_tpu_torch.train.build import init_finetune
    from animal2vec_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint_dir

    totals = dict.fromkeys(_counted(), 0)
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = generate(os.path.join(tmp, "data"), n_clips=ENTRY_CLIPS, clip_seconds=10.0,
                        seed=SEED, label_ext="npz")
        seconds["data"] = time.perf_counter() - t0
        loader_ms = phase_loader(data, card)
        pre_dir, ft_dir = os.path.join(tmp, "pretrain"), os.path.join(tmp, "finetune")
        free = shutil.disk_usage(tmp).free / 2**30
        print(f"entry: {ENTRY_CLIPS} synthetic 10-s clips in {seconds['data']:.2f} s "
              f"({free:.0f} GiB free there); pretrain overrides {' '.join(ENTRY_PRETRAIN)}; "
              f"finetune overrides {' '.join(ENTRY_FINETUNE)}")

        def drive(part, argv, want_steps):
            reset_counts()
            t0 = time.perf_counter()
            with EntryWatch() as watch, PlainSpy() as spy, NativeWatch() as native:
                out = train_cli.main(argv)
            torch.cuda.synchronize()
            seconds[part] = time.perf_counter() - t0
            got = counts()
            for k, v in got.items():
                totals[k] += v
            steps = watch.steps
            if watch.groups != [("nccl", 1)]:
                raise AssertionError(f"entry {part}: train_cli's group {watch.groups}, want NCCL "
                                     "with one rank")
            print(f"entry {part}: train_cli's default group {watch.groups[0][0]} x "
                  f"{watch.groups[0][1]} rank; {len(steps)} steps in {seconds[part]:.2f} s (steps "
                  f"{[round(s['seconds'], 3) for s in steps]} s each); losses "
                  f"{[round(s['loss'], 5) for s in steps]}; launches {launch_line(got)}; "
                  f"plain-version calls on CUDA tensors {spy.cuda_calls}; batches through the "
                  f"C++ loader {native.calls} ({native.items} clips)")
            if len(steps) != want_steps or spy.cuda_calls or not native.calls:
                raise AssertionError(f"entry {part}: {len(steps)} steps (want {want_steps}), "
                                     f"a plain call or no native decode")
            if not all(np.isfinite(s["loss"]) for s in steps):
                raise AssertionError(f"entry {part}: a non-finite loss")
            return watch, got, out

        # pretraining
        pre_run = apply_overrides(RECIPES["a2v_large_pretrain"](), list(ENTRY_PRETRAIN))
        watch, got, _ = drive("pretrain", [
            "--recipe", "a2v_large_pretrain", "--data", data, "--save-dir", pre_dir,
            "--max-steps", "2", "--device", dev.type, *ENTRY_PRETRAIN], 2)
        want = pretrain_launches(pre_run.pretrain)
        if any(s["launched"] != want for s in watch.steps) or got != {
                k: 2 * v for k, v in want.items()}:
            raise AssertionError(f"entry pretrain: launches per step "
                                 f"{[s['launched'] for s in watch.steps]} != {want}")
        if load_checkpoint_dir(pre_dir)["step"] != 2:
            raise AssertionError("entry pretrain: no step-2 checkpoint")
        del watch
        torch.cuda.empty_cache()

        # finetuning from the pretraining checkpoint
        ft_args = ["--recipe", "finetune_100", "--data", data, "--save-dir", ft_dir,
                   "--device", dev.type, *ENTRY_FINETUNE]
        watch, got, _ = drive("finetune", ft_args + ["--pretrained", pre_dir, "--max-steps", "3"],
                              3)
        names = ("attention", "dq", "dkv", "block")
        for i, s in enumerate(watch.steps):
            step_want = {k: (s["ran"] if k in names else 0) for k in _counted()}
            print(f"entry finetune step {i + 1}: launches attention forward "
                  f"{s['launched']['attention']}, dq {s['launched']['dq']}, dk/dv "
                  f"{s['launched']['dkv']}, fused block {s['launched']['block']} (expected "
                  f"{s['ran']} each, as phase 8: the blocks layerdrop kept)")
            if s["launched"] != step_want or s["ran"] == 0:
                raise AssertionError(f"entry finetune step {i + 1}: launches {s['launched']}")
        (val,) = watch.validations
        val_want = {k: (val["ran"] if k in ("serve_attention", "block") else 0) for k in _counted()}
        print(f"entry validation at step 2: launches {launch_line(val['launched'])} ({val['ran']} "
              f"blocks run); f1 {val['out'].get('metrics/finetune/f1')}, mAP "
              f"{val['out'].get('valid/mAP')}")
        if val["launched"] != val_want or val["ran"] == 0:
            raise AssertionError(f"entry validation: launches {val['launched']} != {val_want}")
        ft_mgr = CheckpointManager(ft_dir)
        best = os.path.join(ft_dir, "best")
        if ft_mgr.all_steps() != [2, 3] or load_checkpoint_dir(best)["step"] != 2:
            raise AssertionError(f"entry finetune: checkpoints {ft_mgr.all_steps()}, best not 2")
        live = watch.state
        ft_run = apply_overrides(RECIPES["finetune_100"](), ENTRY_FINETUNE + (
            f"task.data={data}", f"checkpoint.save_dir={ft_dir}"))
        _, fresh = init_finetune(ft_run, dev)
        saved_loader = ft_mgr.restore(fresh, step=3)["loader"]
        same = _same_train_state(fresh, live)
        print(f"entry checkpoint: a fresh state restored from step 3 is the live one bit for bit "
              f"(model, Adam moments and count, step): {same}; saved loader {saved_loader}")
        if not same:
            raise AssertionError("entry: the restored state differs from the live one")
        del live, fresh, watch
        shutil.rmtree(pre_dir)
        torch.cuda.empty_cache()

        # resume to step 4
        watch, _, _ = drive("resume", ft_args + ["--max-steps", "4"], 1)
        start = watch.steps[0]["start"]
        print(f"entry resume: started at step {start} from loader state {watch.loaders[0]}")
        if start != 3 or watch.loaders[0] != saved_loader or ft_mgr.latest_step() != 4:
            raise AssertionError("entry resume: not from step 3 and its loader position")
        del watch
        torch.cuda.empty_cache()

        # serving the best checkpoint
        rng = np.random.default_rng(SEED + 20)
        rec = os.path.join(tmp, "rec.wav")
        write_wav(rec, (0.05 * rng.normal(size=ENTRY_SERVE_SECONDS * 8000)).astype(np.float32),
                  8000)
        reset_counts()
        t0 = time.perf_counter()
        with PlainSpy() as spy:
            events = infer_cli.main(["--wav", rec, "--checkpoint", best, "--device", dev.type,
                                     "--out", os.path.join(tmp, "events.json"),
                                     "max_sample_size=80000"])
        torch.cuda.synchronize()
        seconds["serve"] = time.perf_counter() - t0
        got = counts()
        for k, v in got.items():
            totals[k] += v
        n_blocks = FinetuneConfig().n_blocks
        want = forward_launches("bf16", n_blocks)  # three 10-s windows: one forward
        n_events = sum(len(v) for v in events.values())
        print(f"entry serve: infer_cli --checkpoint best on a {ENTRY_SERVE_SECONDS}-s recording in "
              f"{seconds['serve']:.2f} s: {n_events} events; launches {launch_line(got)}; "
              f"plain-version calls on CUDA tensors {spy.cuda_calls}")
        if got != want or spy.cuda_calls or n_events == 0:
            raise AssertionError(f"entry serve: launches {got} != {want}, a plain call or no event")
    ft_steps = 3 + 1
    print(f"entry on {card}: seconds per part "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"; pretrain {2 / seconds['pretrain']:.3f} steps/s, "
          f"{2 * 5 / seconds['pretrain']:.2f} clips/s; finetune and resume "
          f"{ft_steps / (seconds['finetune'] + seconds['resume']):.3f} steps/s, "
          f"{ft_steps * 4 / (seconds['finetune'] + seconds['resume']):.2f} clips/s (each part "
          f"from the CLI call to its return: build, load, steps, validation, checkpoints)")
    return totals


# phase 13: the serving entry points
SERVE_CLIPS, SERVE_EXPORT_BATCH, BUNDLE_BATCH = 24, 12, 16
SERVE_OVERRIDES = ("max_sample_size=80000",)
# the serving ops' launches of one a2v-large forward (24 blocks) in each mode
BUNDLE_LAUNCHES = {
    "bf16": {"a2v::alibi_attention_serve": 24, "a2v::fused_block": 24},
    "int8_attn": {"a2v::int8_dense": 48, "a2v::quantize_qkv_int8": 24,
                  "a2v::alibi_attention_int8": 24, "a2v::fused_block_int8": 24},
}
# op name -> the kernels line's launch key
OP_KEYS = {"a2v::alibi_attention_serve": "serve_attention", "a2v::fused_block": "block",
           "a2v::int8_dense": "int8_dense", "a2v::quantize_qkv_int8": "int8_quant",
           "a2v::alibi_attention_int8": "int8_attention", "a2v::fused_block_int8": "int8_block"}


def save_unimportable(path, state):
    """torch.save ``state`` with a ``cfg`` entry of a class that is gone when
    the file is read, as fairseq pickles its config dataclasses."""
    import types

    mod = types.ModuleType("fairseq_cfg_stub")

    class FairseqConfig:
        def __init__(self):
            self.task = {"sample_rate": 8000}

    FairseqConfig.__module__, FairseqConfig.__qualname__ = mod.__name__, "FairseqConfig"
    mod.FairseqConfig = FairseqConfig
    sys.modules[mod.__name__] = mod
    try:
        torch.save({**state, "cfg": FairseqConfig()}, path)
    finally:
        del sys.modules[mod.__name__]


def bundle_worker(bundle_dir: str, src_path: str, out_path: str) -> None:
    """The bundle's serving process (run by phase 13 in a subprocess): load
    the bundle with ServingBundle, time the load and the first call (which
    loads the kernel library), run one counted forward on the batch in
    ``src_path`` (logits to ``out_path``), time 5 more, and print one JSON
    line with the times, the ops' launches, the plain-version calls on CUDA
    tensors and every loaded module of the model code."""
    from animal2vec_tpu_torch.kernels import ops as kernel_ops
    from animal2vec_tpu_torch.serve import ServingBundle

    t0 = time.perf_counter()
    bundle = ServingBundle(bundle_dir)
    load_s = time.perf_counter() - t0
    src = torch.from_numpy(np.load(src_path)).cuda()
    t0 = time.perf_counter()
    bundle.forward(src)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    kernel_ops.reset_launches()
    with PlainSpy() as spy:
        logits = bundle.forward(src)
        torch.cuda.synchronize()
    launched = kernel_ops.launches()
    np.save(out_path, logits.float().cpu().numpy())
    ms = cuda_ms(lambda: bundle.forward(src), iters=5, warmup=1)
    print(json.dumps({
        "load_s": load_s, "load_split_s": bundle.load_seconds, "first_call_s": first_s,
        "forward_ms": ms, "launches": launched,
        "plain_cuda_calls": spy.cuda_calls,
        "model_modules": sorted(m for m in sys.modules
                                if m.startswith("animal2vec_tpu_torch.models")),
    }))


def phase_serving_entry(card, dev):
    """13. The serving entry points at a2v-large's width and depth: a
    fairseq-named .pt from a seeded pretraining model (the port's
    export_pretrain, a seeded head, an unimportable cfg) through convert_cli
    import; export_cli over 24 synthetic 10-s clips at batch 12 with
    --data-parallel -1 and 1 (predictions and embeddings as npz: the card's
    machine has no h5py), equal files; aot_cli to a bf16 and an int8_attn
    bundle at 16 x 10 s, each loaded by ServingBundle in a subprocess that
    imports no model code, its logits against the eager model's on the same
    batch. Returns the launches of the phase's runs by kernels-line key."""
    from animal2vec_tpu_torch.config import FinetuneConfig, PretrainConfig, apply_overrides
    from animal2vec_tpu_torch.data.synthetic import generate
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model
    from animal2vec_tpu_torch.tools import aot_cli, convert_cli, export_cli
    from animal2vec_tpu_torch.tools.infer_cli import load_finetuned
    from animal2vec_tpu_torch.train.convert import export_pretrain

    totals = dict.fromkeys(_counted(), 0)
    seconds = {}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        # the fairseq .pt and its conversion
        t0 = time.perf_counter()
        pcfg = PretrainConfig()
        pre = build_pretrain_model(pcfg, seed=SEED + 30, device="cpu")
        sd = {f"w2v_encoder.w2v_model.{k}": torch.from_numpy(v)
              for k, v in export_pretrain(pre.state_dict(), pcfg.model).items()}
        del pre
        gen = torch.Generator().manual_seed(SEED + 31)
        c, n_cls = pcfg.model.embed_dim, len(pcfg.model.labels)
        bound = (6.0 / (c + n_cls)) ** 0.5
        sd["w2v_encoder.proj.weight"] = (torch.rand((n_cls, c), generator=gen) * 2 - 1) * bound
        sd["w2v_encoder.proj.bias"] = torch.zeros(n_cls)
        pt = os.path.join(tmp, "a2v_large_finetuned.pt")
        save_unimportable(pt, {"model": sd})
        del sd
        seconds["make_pt"] = time.perf_counter() - t0
        ckpt = os.path.join(tmp, "converted")
        t0 = time.perf_counter()
        if convert_cli.main(["import", "--pt", pt, "--out", ckpt, "--strict"]) != 0:
            raise AssertionError("serving entry: convert_cli import --strict failed")
        seconds["convert"] = time.perf_counter() - t0
        print(f"serving entry: fairseq .pt ({os.path.getsize(pt) / 2**30:.2f} GiB) made in "
              f"{seconds['make_pt']:.2f} s, converted to {ckpt} in {seconds['convert']:.2f} s")

        # export_cli over a synthetic manifest, on all visible cards and on one
        data = generate(os.path.join(tmp, "data"), n_clips=SERVE_CLIPS, clip_seconds=10.0,
                        seed=SEED + 32, label_ext="npz")
        outs, rates = {}, {}
        n_blocks = FinetuneConfig().n_blocks
        for dp in ("-1", "1"):
            out = os.path.join(tmp, f"export_dp{dp}")
            reset_counts()
            t0 = time.perf_counter()
            with PlainSpy() as spy:
                line = export_cli.main([
                    "--manifest-path", data, "--split", "pretrain", "--checkpoint", ckpt,
                    "--out-path", out, "--batch-size", str(SERVE_EXPORT_BATCH),
                    "--export-predictions", "--export-embeddings", "--data-parallel", dp,
                    "--label-ext", "npz", "--output-format", "npz", "--device", dev.type,
                    *SERVE_OVERRIDES])
            torch.cuda.synchronize()
            seconds[f"export_cli dp {dp}"] = time.perf_counter() - t0
            got = counts()
            for k, v in got.items():
                totals[k] += v
            n_fwd = SERVE_CLIPS // SERVE_EXPORT_BATCH
            want = {k: n_fwd * v for k, v in forward_launches("bf16", n_blocks).items()}
            rates[dp] = line["clips_per_sec"]
            print(f"serving entry: export_cli --data-parallel {dp}: {line['clips_per_sec']} "
                  f"clips/s over {line['devices']} device(s) ({line['clips_timed']} clips "
                  f"timed) on {card}; {seconds[f'export_cli dp {dp}']:.2f} s from the call; "
                  f"launches {launch_line(got)}; plain-version calls on CUDA tensors "
                  f"{spy.cuda_calls}")
            if got != want or spy.cuda_calls or \
                    line["clips_timed"] != SERVE_CLIPS - SERVE_EXPORT_BATCH:
                raise AssertionError(f"serving entry: export_cli launches {got} != {want}, a "
                                     f"plain call or {line['clips_timed']} clips timed")
            outs[dp] = {}
            for name in sorted(os.listdir(out)):
                with np.load(os.path.join(out, name)) as z:
                    outs[dp][name] = {k: z[k] for k in z.files}
        same = outs["-1"].keys() == outs["1"].keys() and all(
            a.keys() == outs["1"][name].keys()
            and all(np.array_equal(a[k], outs["1"][name][k]) for k in a)
            for name, a in outs["-1"].items())
        n_groups = {name: len({k.split("/")[0] for k in a}) for name, a in outs["1"].items()}
        print(f"serving entry: export_cli files {n_groups} (clips per file); --data-parallel -1 "
              f"and 1 equal in every entry: {same}")
        if not same or set(n_groups.values()) != {SERVE_CLIPS}:
            raise AssertionError("serving entry: the -1 and 1 exports differ or miss clips")
        del outs

        # aot_cli bundles, each loaded in a serving process without model code
        src = np.random.default_rng(SEED + 33).normal(size=(BUNDLE_BATCH, WAV_LEN)).astype(
            np.float32)
        src_path = os.path.join(tmp, "src.npy")
        np.save(src_path, src)
        bundles = {}
        for mode in ("bf16", "int8_attn"):
            bundle = os.path.join(tmp, f"bundle_{mode}")
            over = [*SERVE_OVERRIDES, f"matmul_impl={mode}"]
            t0 = time.perf_counter()
            aot_cli.main(["--checkpoint", ckpt, "--out", bundle, "--batch", str(BUNDLE_BATCH),
                          "--seconds", "10", "--device", dev.type, *over])
            seconds[f"aot_cli {mode}"] = time.perf_counter() - t0
            out_path = os.path.join(tmp, f"logits_{mode}.npy")
            t0 = time.perf_counter()
            worker_code = "import sys, chip_smoke; chip_smoke.bundle_worker(*sys.argv[1:])"
            res = subprocess.run([sys.executable, "-c", worker_code, bundle, src_path, out_path],
                                 cwd=tmp, capture_output=True, text=True,
                                 env=dict(os.environ, PYTHONPATH=root))
            seconds[f"bundle process {mode}"] = time.perf_counter() - t0
            if res.returncode != 0:
                raise AssertionError(f"serving entry: the {mode} bundle process failed:\n"
                                     f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
            worker = json.loads(res.stdout.strip().splitlines()[-1])
            got_logits = torch.from_numpy(np.load(out_path))
            model = load_finetuned(ckpt, apply_overrides(FinetuneConfig(), over), dev,
                                   checkpoint=True)
            x = torch.from_numpy(src).to(dev)
            with torch.inference_mode():
                want_logits = model(x)["encoder_out"].float().cpu()
                eager_ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
            del model
            torch.cuda.empty_cache()
            gap = (got_logits - want_logits).abs().max().item()
            rel = rel_norm(got_logits, want_logits)
            launched = {k: v for k, v in worker["launches"].items() if v}
            for name, v in worker["launches"].items():
                totals[OP_KEYS[name]] += v
            print(f"serving entry: {mode} bundle b{BUNDLE_BATCH} x 10 s: aot_cli "
                  f"{seconds[f'aot_cli {mode}']:.2f} s; serving process "
                  f"{seconds[f'bundle process {mode}']:.2f} s (ServingBundle load "
                  f"{worker['load_s']:.2f} s: programs {worker['load_split_s']['programs']:.2f}, "
                  f"weights {worker['load_split_s']['params']:.2f}; first call with the kernel "
                  f"library's load "
                  f"{worker['first_call_s']:.2f} s); forward {worker['forward_ms']:.1f} ms "
                  f"against the eager model's {eager_ms:.1f} ms on {card}; launches per bundle "
                  f"forward {launched}; plain-version calls on CUDA tensors "
                  f"{worker['plain_cuda_calls']}; model modules loaded {worker['model_modules']}")
            print(f"serving entry: {mode} bundle logits against the eager model's: max abs "
                  f"{gap:.3e}, relative norm {rel:.3e} (0 expected; tolerance "
                  + (f"{MODEL_TOL} max abs)" if mode == "bf16" else f"{INT8_MODEL_REL} "
                     "relative norm)"))
            if (launched != BUNDLE_LAUNCHES[mode] or worker["plain_cuda_calls"]
                    or worker["model_modules"]):
                raise AssertionError(f"serving entry: {mode} bundle launches {launched}, a plain "
                                     f"call or model code in the serving process")
            if not (gap <= MODEL_TOL if mode == "bf16" else rel <= INT8_MODEL_REL):
                raise AssertionError(f"serving entry: the {mode} bundle's logits stray")
            bundles[mode] = dict(worker, eager_ms=eager_ms, gap=gap)
            shutil.rmtree(bundle)
    print(f"serving entry on {card}: seconds per part "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"; export_cli clips/s -1 {rates['-1']}, 1 {rates['1']}")
    return totals


# phase 14: data parallelism and ring attention
RING_B, RING_H, RING_T, RING_SHARDS, RING_PAD = 2, 16, 8000, 4, 700
DP_BATCH = 4  # rows per rank of 14b's a2v-large finetune step (one rank: 8)
DP_CLIPS = 12
# 14b's train_cli chain: two gloo workers on the one card, a2v-large's width
# with the depth cut to 1 prenet + 2 trunk blocks, b2 per rank
DP_DEPTH = ("model.depth=2", "model.prenet_depth=1", "model.average_top_k_layers=2")
DP_COMMON = ENTRY_COMMON + ("distributed.data_parallel=2",)
DP_PRETRAIN = DP_COMMON + ("pretrain.optimization.update_freq=1", "dataset.batch_size=2",
                           "pretrain.average_top_k_layers=2") + tuple(
    f"pretrain.{o}" for o in DP_DEPTH)
DP_FINETUNE = ENTRY_FINETUNE + ("distributed.data_parallel=2", "dataset.batch_size=2") + DP_DEPTH
# the 2-rank and the 1-rank validation of one checkpoint read the same rows
# through the same kernels; what may differ is the split of the valid items
# into batches (the frontend's cuDNN convolutions see other batches)
DP_VALID_REL = 1e-3
# loss of the 2-rank step against the 1-rank step on the same global batch:
# the same rows through the same kernels, fp32 sums over the ranks
DP_LOSS_REL = 1e-4


def phase_ring(dev):
    """14a. The in-process ring at b2 H16 T 8000 in 4 shards of 2000, the
    last 700 keys padded: 16 launches of #2 with key positions, against one
    launch over the whole T and the plain version; #2 with key positions
    timed at the shard shape. Returns (kernel-line row, launches, err)."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.alibi import alibi_slopes
    from animal2vec_tpu_torch.ops.attention import alibi_attention_plain, alibi_flash_attention_lse
    from animal2vec_tpu_torch.ops.ring_attention import ring_attention_local

    b, h, t, n = RING_B, RING_H, RING_T, RING_SHARDS
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    q, k, v = (torch.randn((b, t, h, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    slopes = torch.from_numpy(alibi_slopes(h).copy()).to(dev)
    pos = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t).contiguous()
    mask = torch.zeros((b, t), dtype=torch.bool, device=dev)
    mask[:, -RING_PAD:] = True
    reset_counts()
    with torch.inference_mode(), PlainSpy() as spy:
        out = ring_attention_local(q, k, v, slopes, pos, mask, n)
    torch.cuda.synchronize()
    got = counts()
    print(f"ring b{b} H{h} T {t} in {n} shards (keys {t - RING_PAD}.. padded): launches "
          f"{launch_line(got)}; plain-version calls on CUDA tensors {spy.cuda_calls}")
    if got["ring_attention"] != n * n or sum(got.values()) != n * n or spy.cuda_calls:
        raise AssertionError(f"ring: launches {got} != {n * n} of #2 with key positions")
    with torch.inference_mode():
        one, _ = alibi_flash_attention_lse(q, k, v, slopes, pos, mask)
        plain = torch.cat([alibi_attention_plain(
            torch.stack([q[i:i + 1], k[i:i + 1], v[i:i + 1]]).transpose(2, 3).float(), slopes,
            pos[i:i + 1], mask[i:i + 1], True).transpose(1, 2) for i in range(b)])
    torch.cuda.synchronize()
    err = check_close("ring (4 x 2000) against the plain version over T 8000", out, plain,
                      ATTN_TOL)
    check_close("one #2 launch over T 8000 against the plain version", one, plain, ATTN_TOL)
    check_close("ring against one #2 launch over T 8000", out, one.float(), ATTN_TOL)
    del plain
    torch.cuda.empty_cache()
    with torch.inference_mode():
        ring_ms = cuda_ms(lambda: ring_attention_local(q, k, v, slopes, pos, mask, n))
        one_ms = cuda_ms(lambda: alibi_flash_attention_lse(q, k, v, slopes, pos, mask))
        # #2 with key positions at the shard shape: shard 0's queries against
        # shard 3's keys (the padded ones), as the ring's last step holds them
        ts = t // n
        qs, ps = q[:, :ts].contiguous(), pos[:, :ts].contiguous()
        ks, vs, pks, ms_ = (x[:, -ts:].contiguous() for x in (k, v, pos, mask))
        shard = lambda: alibi_flash_attention_lse(qs, ks, vs, slopes, ps, ms_, True, pks)
        shard_ms = cuda_ms(shard)
        packed = torch.stack([qs, ks, vs]).transpose(2, 3)
        plain_fn = lambda: alibi_attention_plain(packed, slopes, ps, ms_, True, return_lse=True,
                                                 positions_k=pks)
        plain_ms = cuda_ms(plain_fn, iters=3)
        s_out, s_lse = shard()
        p_out, p_lse = alibi_attention_plain(packed.float(), slopes, ps, ms_, True,
                                             return_lse=True, positions_k=pks)
        shard_err = check_close("#2 with key positions at the shard shape against the plain "
                                "version", s_out.transpose(1, 2), p_out, ATTN_TOL)
        check_close("its lse", s_lse, p_lse, LSE_TOL)
        qt, kt, vt = (x.transpose(1, 2) for x in (qs, ks, vs))
        dist = (ps[:, None, :, None].float() - pks[:, None, None, :].float()).abs()
        bias = (-dist * slopes[None, :, None, None]).masked_fill(
            ms_[:, None, None, :], -1e9).to(torch.bfloat16)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias))
    bnd = attention_bounds(b, h, ts, 64)["forward"]
    print(f"ring: {n * n} launches {ring_ms:.3f} ms against one #2 launch over T {t} "
          f"{one_ms:.3f} ms; #2 with key positions at b{b} H{h} T {ts}: kernel {shard_ms:.3f} "
          f"ms, plain {plain_ms:.3f} ms, SDPA {sdpa_ms:.3f} ms, bound {bnd[0]:.3f} ms "
          f"({bnd[1]})")
    row = {"ms": shard_ms, "plain_ms": plain_ms, "library_ms": sdpa_ms, "bound_ms": bnd[0],
           "bound_by": bnd[1], "ring_ms": ring_ms, "one_launch_ms": one_ms}
    return row, got["ring_attention"], max(err, shard_err)


def phase_dp_step(card, dev):
    """14b, the step: two gloo ranks on the one card
    (tools/dryrun_multigpu.py). Returns its result."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dp.json")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "animal2vec_tpu_torch.tools.dryrun_multigpu",
                        "--ranks", "2", "--device", "cuda", "--dist-backend", "gloo",
                        "--width", "a2v-large", "--batch", str(DP_BATCH),
                        "--parts", "finetune,masks", "--out", out], check=True, timeout=900)
        seconds = time.perf_counter() - t0
        with open(out) as f:
            res = json.load(f)
    ft, masks = res["finetune"], res["masks"]
    n_blocks = 24  # a2v-large: 8 prenet + 16 trunk blocks, update_freq 2
    want = {"alibi_train": 2 * n_blocks, "alibi_serve": 0, "fused_block": 2 * n_blocks}
    print(f"dp step on {card}: 2 gloo ranks x b{DP_BATCH} against 1 rank x b{2 * DP_BATCH} "
          f"(a2v-large finetune step, every rate 0, update_freq 2; {seconds:.1f} s): "
          f"gradients' relative gap {ft['grad_gap']:.3e} at worst ({ft['grad_gap_leaf']}), "
          f"{ft['grad_gap_whole']:.3e} over all, global norm relative {ft['grad_norm_gap']:.2e} "
          f"(bound {ft['grad_bound']}); "
          f"parameter gap {ft['param_gap']:.3e} (bound {ft['bound']:.1e}: 2.1 lr), loss "
          f"{ft['loss']:.6f} against {ft['ref_loss']:.6f} (relative {ft['loss_rel_gap']:.2e}, "
          f"bound {DP_LOSS_REL}), checksums equal {ft['checksums_equal']}; rank 0's launches "
          f"{ft['launches']}; second step {ft['step_ms']:.1f} ms on 2 ranks (its gradient "
          f"all-reduce {ft['all_reduce_ms']:.1f} ms) against {ft['one_rank_step_ms']:.1f} ms on "
          "one rank (host clock, synchronized; the two ranks share the card)")
    print(f"dp masks: one a2v-large block with hash dropout on the same rows: ranks differ "
          f"{masks['ranks_differ']}; each rank against its rows of the one-rank call: max abs "
          f"{masks['slice_gap']:.3e} (tolerance {BLOCK_TOL[0]} + {BLOCK_TOL[1]}*|x|, 0 "
          "expected)")
    # the split #6's entries run under tensor parallelism only (phase 19)
    got = {k: ft["launches"][k] for k in want}
    split = [ft["launches"][k] for k in ("block_fc1", "block_fc2_partial", "block_ln2")]
    if not (ft["checksums_equal"] and ft["param_gap"] <= ft["bound"]
            and ft["grad_gap"] <= ft["grad_bound"] and ft["grad_norm_gap"] <= ft["grad_bound"]
            and ft["loss_rel_gap"] <= DP_LOSS_REL and got == want and not any(split)):
        raise AssertionError(f"dp step: {ft}")
    if not masks["ranks_differ"] or masks["slice_gap"] > BLOCK_TOL[0]:
        raise AssertionError(f"dp masks: {masks}")
    return {"seconds": seconds, **res}


def phase_dp_entry(card, dev):
    """14b, the entry point: train_cli with two gloo workers on the one
    card (pretrain, finetune from it with a validation, resume),
    infer_cli --checkpoint best, and a 1-rank validation of the validated
    checkpoint against the 2-rank one. Returns the seconds per part."""
    from animal2vec_tpu_torch.config import RECIPES, apply_overrides
    from animal2vec_tpu_torch.data.synthetic import generate
    from animal2vec_tpu_torch.data.wavio import write_wav
    from animal2vec_tpu_torch.tools import infer_cli, train_cli
    from animal2vec_tpu_torch.train import loop
    from animal2vec_tpu_torch.train.build import init_finetune
    from animal2vec_tpu_torch.train.checkpoint import CheckpointManager
    from animal2vec_tpu_torch.train.finetune_step import make_finetune_eval_step

    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = generate(os.path.join(tmp, "data"), n_clips=DP_CLIPS, clip_seconds=10.0,
                        seed=SEED + 1, label_ext="npz")
        pre_dir, ft_dir = os.path.join(tmp, "pretrain"), os.path.join(tmp, "finetune")

        def cli(part, argv):
            t0 = time.perf_counter()
            train_cli.main(argv)
            seconds[part] = time.perf_counter() - t0

        cli("pretrain", ["--recipe", "a2v_large_pretrain", "--data", data, "--save-dir", pre_dir,
                         "--max-steps", "2", "--device", "cuda", "--dist-backend", "gloo",
                         *DP_PRETRAIN])
        ft_args = ["--recipe", "finetune_100", "--data", data, "--save-dir", ft_dir,
                   "--device", "cuda", "--dist-backend", "gloo"]
        cli("finetune", ft_args[:6] + ["--pretrained", pre_dir, "--max-steps", "2"]
            + ft_args[6:] + list(DP_FINETUNE))
        cli("resume", ft_args[:6] + ["--max-steps", "3"] + ft_args[6:] + list(DP_FINETUNE))
        pre, ft = CheckpointManager(pre_dir), CheckpointManager(ft_dir)
        saved = ft.load(2)["extra"]
        last = ft.load(3)["extra"]
        print(f"dp entry: train_cli, 2 gloo workers on the one card: pretrain steps "
              f"{pre.all_steps()}, finetune and resume steps {ft.all_steps()}, best "
              f"{os.path.basename(os.path.realpath(os.path.join(ft_dir, 'best')))}; world size "
              f"{last['world_size']}, loader states {last['loaders']}")
        if pre.all_steps() != [2] or ft.all_steps() != [2, 3] or last["world_size"] != 2 \
                or len(last["loaders"]) != 2 or "valid" not in saved:
            raise AssertionError("dp entry: not one checkpoint per save with every rank's state")
        rng = np.random.default_rng(SEED + 21)
        rec = os.path.join(tmp, "rec.wav")
        write_wav(rec, (0.05 * rng.normal(size=ENTRY_SERVE_SECONDS * 8000)).astype(np.float32),
                  8000)
        t0 = time.perf_counter()
        events = infer_cli.main(["--wav", rec, "--checkpoint", os.path.join(ft_dir, "best"),
                                 "--device", "cuda", "--out", os.path.join(tmp, "events.json"),
                                 "max_sample_size=80000", "depth=2", "prenet_depth=1",
                                 "average_top_k_layers=2"])
        seconds["serve"] = time.perf_counter() - t0
        n_events = sum(len(v) for v in events.values())
        # the 2-rank validation at step 2 against one rank's of the same weights
        run = apply_overrides(RECIPES["finetune_100"](), list(DP_FINETUNE) + [
            f"task.data={data}", f"checkpoint.save_dir={ft_dir}"])
        _, state = init_finetune(run, dev)
        ft.restore(state, step=2)
        one = loop.validate_finetune(run, state, make_finetune_eval_step(run.finetune),
                                     loop._NullSink(), 2, dev)
        two = saved["valid"]
        keys = sorted(k for k in one if k not in ("ups", "loss") and np.isfinite(one[k]))
        worst = max(abs(two[k] - one[k]) / max(abs(one[k]), 1e-12) for k in keys)
        print(f"dp validation at step 2, 2 ranks against 1 rank on the same checkpoint: "
              f"{len(keys)} metrics, worst relative gap {worst:.2e} (tolerance {DP_VALID_REL}); "
              f"f1 {two.get('metrics/finetune/f1')} against {one.get('metrics/finetune/f1')}, "
              f"mAP {two.get('valid/mAP')} against {one.get('valid/mAP')}; loss "
              f"{two['loss']:.6f} against {one['loss']:.6f} (a mean over differing batches)")
        print(f"dp serve: infer_cli --checkpoint best (written by 2 ranks): {n_events} events")
        if worst > DP_VALID_REL or set(two) != set(one) - {"ups"} or n_events == 0:
            raise AssertionError("dp validation: 2 ranks and 1 rank disagree, or no event")
    print(f"dp entry on {card}: seconds per part "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + " (each from the CLI call to its return: 2 worker processes, build, load, steps, "
          "validation, checkpoints)")
    return seconds


# phase 15: the v5e recipe's micro-batch (max_tokens 640 000 / 80 000 samples)
V5E_BATCH = 8
REMAT_TIMED = 3  # 15a's timed steps after the checked one (a step's host time spreads)
REMAT_VARIANTS = (
    ("remat off", dict(remat=False)),
    ("remat mlp", dict(remat=True, remat_scope="mlp")),
    ("remat attn", dict(remat=True, remat_scope="attn")),
    ("remat block", dict(remat=True, remat_scope="block")),
    ("remat_frontend + remat_decoder", dict(remat=False, remat_frontend=True,
                                            remat_decoder=True)),
)
# 15b: the int8 teachers are held by their trunk output x, kernel path
# against plain path (INT8_MODEL_REL) and against the bf16 teacher
# (INT8_VS_BF16_REL), as the int8 serving models' logits are in phase 5.
# Their targets' relative norms are printed, not held: each layer's tap is
# normalized per channel over time, and at seeded random weights channels
# that barely vary over time amplify any rounding (measured on an H100: the
# int8 teacher's targets 0.33 from the bf16 teacher's and 0.40 from its own
# plain path; on the CPU JAX's int8_attn teacher moves its targets by 6e-2
# for a one-ulp change of its input, tests/test_torch_pretrain_step.py)


def _set_remat(model, cfg_model):
    """Point a built pretraining model's blocks, frontend and decoder at
    ``cfg_model``'s remat fields (the other fields unchanged)."""
    from animal2vec_tpu_torch.models.modules import AltBlock

    scope = cfg_model.remat_scope if cfg_model.remat else None
    for mod in model.modules():
        if isinstance(mod, AltBlock):
            mod.remat_scope = scope
    model.audio_encoder.remat_frontend = cfg_model.remat_frontend
    model.cfg = cfg_model


def _pretrain_v5e(**kw):
    """The a2v-large pretraining recipe at one micro-batch a step
    (``update_freq`` 1), with ``kw`` changes."""
    from animal2vec_tpu_torch.config import PretrainConfig

    base = PretrainConfig()
    return dataclasses.replace(base, optimization=dataclasses.replace(base.optimization,
                                                                      update_freq=1), **kw)


def phase_remat(card, dev):
    """15a. One a2v-large pretrain step at the v5e recipe's micro-batch (b8 x
    clone 12, update_freq 1), from the same weights, draws and data, under
    remat off, "mlp", "attn", "block" and with remat_frontend and
    remat_decoder: the loss and every gradient against remat off (relative
    norm per tensor within MODEL_GRAD_TOL, the phase's step tolerance; the
    number of tensors equal bit for bit printed), the launches (the
    recompute launches #2 once more per block under "attn" and "block", #6
    once more under "block"), then three more steps' host ms (their
    median) and their peak memory. Then one b4 finetune_100 step with the recipe's remat and with
    "block", whose loss and gradients must equal. Returns the rows."""
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.pretrain import make_pretrain_train_step
    from animal2vec_tpu_torch.train.state import PretrainState

    cfg = _pretrain_v5e()
    torch.cuda.empty_cache()
    model = build_pretrain_model(cfg, dtype=torch.bfloat16, seed=SEED, device=dev)
    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    data = pretrain_batch(cfg, dev, V5E_BATCH, SEED + 41)
    n = cfg.model.n_blocks
    rows, ref, base = {}, None, None
    for label, kw in REMAT_VARIANTS:
        mcfg = dataclasses.replace(cfg.model, **kw)
        _set_remat(model, mcfg)
        model.load_state_dict(init)
        pcfg = dataclasses.replace(cfg, model=mcfg)
        state = PretrainState.create(model, pcfg)
        state.step = pcfg.optimization.warmup_updates
        step_fn = make_pretrain_train_step(pcfg)
        torch.cuda.empty_cache()
        reset_counts()
        metrics = step_fn(state, data, Rngs.from_seed(SEED, dev))
        torch.cuda.synchronize()
        got = counts()
        loss = float(metrics["loss"])
        grads = {k: p.grad.detach().float().clone() for k, p in model.named_parameters()}
        if not np.isfinite(loss) or not all(torch.isfinite(g).all() for g in grads.values()):
            raise AssertionError(f"15a {label}: non-finite loss or gradient")
        extra = {"attention": n if kw.get("remat_scope") in ("attn", "block") else 0,
                 "block": n if kw.get("remat_scope") == "block" else 0}
        if ref is None:
            ref, base = (loss, grads), got
            line = "the reference"
        else:
            want = {k: v + extra.get(k, 0) for k, v in base.items()}
            if got != want:
                raise AssertionError(f"15a {label}: launches {got} != {want}")
            rels = {k: rel_norm(g, ref[1][k]) for k, g in grads.items() if ref[1][k].norm() > 0}
            worst = max(rels.values())
            same = sum(torch.equal(g, ref[1][k]) for k, g in grads.items())
            line = (f"against remat off: loss {loss - ref[0]:+.3e}, gradients max abs "
                    f"{max((g - ref[1][k]).abs().max().item() for k, g in grads.items()):.3e}, "
                    f"relative norm per tensor max {worst:.3e} (tolerance {MODEL_GRAD_TOL}), "
                    f"{same} of {len(grads)} tensors bit for bit")
            if not worst <= MODEL_GRAD_TOL:
                raise AssertionError(f"15a {label}: gradients disagree with remat off")
        del grads
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(REMAT_TIMED):
            t0 = time.perf_counter()
            step_fn(state, data, Rngs.from_seed(SEED + 1 + i, dev))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times))
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows[label] = {"ms": ms, "peak_gib": peak, "loss": loss}
        print(f"15a a2v-large pretrain b{V5E_BATCH} x clone {cfg.clone_batch}, {label}: loss "
              f"{loss:.6f}, {line}; launches {launch_line(got)}; steps 2-{REMAT_TIMED + 1} "
              f"{[round(t, 1) for t in times]} ms (median {ms:.1f}), peak memory {peak:.2f} GiB "
              f"(torch.cuda.max_memory_allocated) on {card}")
        del state, step_fn
    del model, init, ref, data
    torch.cuda.empty_cache()
    rows["finetune"] = phase_remat_finetune(card, dev)
    return rows


def phase_remat_finetune(card, dev):
    """15a's finetune step: finetune_100's model and recipe (remat on, scope
    "mlp") at b4, update_freq 1, gate open, against the same step under
    "block": equal loss and gradients (every finetune draw is made before a
    region), and each step's ms."""
    from animal2vec_tpu_torch.config import RunConfig
    from animal2vec_tpu_torch.models.finetune import build_finetune_model
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.finetune_step import make_finetune_train_step
    from animal2vec_tpu_torch.train.state import FinetuneState

    run = RunConfig.finetune_100()
    tcfg = dataclasses.replace(run.finetune, optimization=dataclasses.replace(
        run.finetune.optimization, update_freq=1))
    batch = train_batch(run.model, dev)
    out = {}
    for scope in ("mlp", "block"):
        cfg = dataclasses.replace(run.model, remat_scope=scope)
        model = build_finetune_model(cfg, dtype=torch.bfloat16, seed=SEED, device=dev,
                                     train=tcfg)
        state = FinetuneState.create(model, tcfg)
        state.step = tcfg.freeze_finetune_updates
        step_fn = make_finetune_train_step(tcfg)
        metrics = step_fn(state, batch, Rngs.from_seed(SEED, dev))
        torch.cuda.synchronize()
        grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
                 if p.grad is not None}
        t0 = time.perf_counter()
        step_fn(state, batch, Rngs.from_seed(SEED + 1, dev))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[scope] = (float(metrics["loss"]), grads, ms)
        print(f"15a finetune_100 b{TRAIN_BATCH} step, remat scope {scope}: loss "
              f"{out[scope][0]:.6f}, second step {ms:.1f} ms on {card}")
        del model, state, step_fn
        torch.cuda.empty_cache()
    (l0, g0, ms0), (l1, g1, ms1) = out["mlp"], out["block"]
    same = sum(torch.equal(g1[k], g0[k]) for k in g0)
    rels = max(rel_norm(g1[k], g0[k]) for k in g0 if g0[k].norm() > 0)
    print(f"15a finetune block against mlp: loss {l1 - l0:+.3e}, {same} of {len(g0)} gradient "
          f"tensors bit for bit, relative norm max {rels:.3e} (tolerance {MODEL_GRAD_TOL})")
    if not (np.isfinite(l0) and rels <= MODEL_GRAD_TOL and g0.keys() == g1.keys()):
        raise AssertionError("15a finetune: remat block disagrees with the recipe's step")
    return {"mlp_ms": ms0, "block_ms": ms1}


def phase_teacher(card, dev):
    """15b. The EMA teacher in the int8 serving modes (model.
    teacher_matmul_impl): on b2 of 10-s local features of the a2v-large
    recipe's model, the int8 and int8_attn teachers' targets against the
    same teacher through the plain versions and against the bf16 teacher's
    (the trunk output x held, the targets' relative norms printed), with
    their launches counted; then one pretrain step with each int8 teacher (b2 x clone 12),
    after which the teacher's targets must equal bit for bit those of a
    model in that mode freshly loaded from the merged student + EMA weights
    (no stale int8 weights), and must have moved. Returns the launches."""
    from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.pretrain import (
        make_pretrain_train_step, teacher_encode, teacher_targets,
    )
    from animal2vec_tpu_torch.train.state import PretrainState, merge_params

    cfg = _pretrain_v5e()
    model = build_pretrain_model(cfg, dtype=torch.bfloat16, seed=SEED, device=dev)
    state = PretrainState.create(model, cfg)
    state.step = cfg.optimization.warmup_updates
    data = pretrain_batch(cfg, dev, 2, SEED + 42)
    with torch.no_grad():
        local = model.local_features(data["source"][0])
    x_bf16, t_bf16 = teacher_encode(model, state.ema, local)
    launches = {}
    for impl in MODES:
        reset_counts()
        with PlainSpy() as spy:
            x, t_sum = teacher_encode(model, state.ema, local, impl)
        torch.cuda.synchronize()
        got = counts()
        launches[impl] = got
        with PlainOps():
            x_plain, t_plain = teacher_encode(model, state.ema, local, impl)
        check_rel(f"15b {impl} teacher output x, kernel path against plain path", x, x_plain,
                  INT8_MODEL_REL)
        check_rel(f"15b {impl} teacher output x against the bf16 teacher's", x, x_bf16,
                  INT8_VS_BF16_REL)
        if not torch.isfinite(t_sum).all():
            raise AssertionError(f"15b {impl}: non-finite targets")
        want = forward_launches(impl, cfg.model.n_blocks)
        print(f"15b {impl} teacher: launches {launch_line(got)} (a serving forward's: "
              f"{launch_line(want)}); plain-version calls on CUDA tensors {spy.cuda_calls}; "
              f"targets' relative norm against the plain path {rel_norm(t_sum, t_plain):.3e}, "
              f"against the bf16 teacher {rel_norm(t_sum, t_bf16):.3e} (printed)")
        if got != want or spy.cuda_calls:
            raise AssertionError(f"15b {impl}: the teacher did not run the int8 kernels")
    for impl in MODES:
        pcfg = dataclasses.replace(cfg, teacher_matmul_impl=impl)
        before = teacher_targets(model, state.ema, local, impl)
        make_pretrain_train_step(pcfg)(state, data, Rngs.from_seed(SEED, dev))
        after = teacher_targets(model, state.ema, local, impl)
        fresh = Data2VecMulti(dataclasses.replace(model.cfg, matmul_impl=impl),
                              torch.bfloat16, pretrain=pcfg).to(dev).eval()
        fresh.load_state_dict(merge_params(model, state.ema), strict=True)  # quantizes
        with torch.no_grad():
            _, _, _, _, t_sum = fresh.encode(local, reduce_targets=True)
        torch.cuda.synchronize()
        equal = torch.equal(after, t_sum / pcfg.average_top_k_layers)
        moved = rel_norm(after, before)
        print(f"15b {impl} teacher after a step (to step {state.step}): targets equal to a "
              f"model loaded from the merged weights bit for bit: {equal}; moved by relative "
              f"norm {moved:.3e}")
        if not equal or moved == 0.0:
            raise AssertionError(f"15b {impl}: the teacher's int8 weights are stale")
        del fresh
    del model, state
    torch.cuda.empty_cache()
    return launches


def phase_tokens(card, dev):
    """15d. One a2v-large pretrain step at b8 x clone 12 with an extra (CLS)
    token, cls_loss 1 and per-layer ALiBi scales: finite losses, a cls term,
    non-zero gradients of the extra token and of every block's scales; ms
    of a second step."""
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.pretrain import make_pretrain_train_step
    from animal2vec_tpu_torch.train.state import PretrainState

    base = _pretrain_v5e()
    cfg = dataclasses.replace(base, cls_loss=1.0, model=dataclasses.replace(
        base.model, num_extra_tokens=1, learned_alibi_scale_per_layer=True))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_pretrain_model(cfg, dtype=torch.bfloat16, seed=SEED, device=dev)
    state = PretrainState.create(model, cfg)
    state.step = cfg.optimization.warmup_updates
    step_fn = make_pretrain_train_step(cfg)
    data = pretrain_batch(cfg, dev, V5E_BATCH, SEED + 41)
    metrics = step_fn(state, data, Rngs.from_seed(SEED, dev))
    torch.cuda.synchronize()
    losses = {k: float(v) for k, v in metrics.items() if k.startswith("loss")}
    tok = model.audio_encoder.extra_tokens.grad
    scales = model.audio_encoder.alibi_scale.grad
    print(f"15d extra token + cls_loss 1 + per-layer scales: losses {losses}; extra token "
          f"gradient norm {tok.float().norm().item():.3e}; ALiBi scales {tuple(scales.shape)}, "
          f"blocks with a non-zero scale gradient "
          f"{int((scales.flatten(1).abs().sum(1) > 0).sum())} of {scales.shape[0]}")
    if not all(np.isfinite(v) for v in losses.values()) or "loss_cls" not in losses:
        raise AssertionError("15d: a non-finite loss or no cls term")
    if not tok.abs().sum() > 0 or not (scales.flatten(1).abs().sum(1) > 0).all():
        raise AssertionError("15d: no gradient for the extra token or a block's scales")
    t0 = time.perf_counter()
    step_fn(state, data, Rngs.from_seed(SEED + 1, dev))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    print(f"15d second step {ms:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    del model, state, step_fn
    torch.cuda.empty_cache()
    return {"ms": ms}


# 15e: train_cli --config, JAX key names; the five other copies at depth 1 + 2
CONFIG_COMMON = ("task.max_sample_size=80000", "task.label_ext=npz", "common.tensorboard_logdir=",
                 "dataset.num_workers=8", "checkpoint.keep_last=1", "optimization.update_freq=1")
CONFIG_CUT = ("model.depth=2", "model.modalities.audio.prenet_depth=1",
              "model.average_top_k_layers=2")
CONFIG_FINETUNE = ("dataset.train_subset=train_0", "dataset.batch_size=4",
                   "finetune.freeze_finetune_updates=0", "finetune.average_top_k_layers=2",
                   "task.min_label_size=0", "dataset.bucket_lengths=")


def phase_config_cli(card, dev):
    """15e. train_cli --config on the port's recipe copies, on 24 synthetic
    10-s clips with .npz labels: a2v_large_pretrain_v5e.yaml at full width
    for 2 steps (b8 x clone 12, remat scope attn, update_freq 1), then each
    of the other five for 1 step at depth 1 + 2 (finetune at b4 from
    scratch, the meerkat labels in nips4bplus's place). Checked: finite
    losses, the steps taken, no plain version on a CUDA tensor. Prints each
    run's seconds. Returns the launches."""
    from animal2vec_tpu_torch.data.synthetic import generate
    from animal2vec_tpu_torch.recipes import RECIPES
    from animal2vec_tpu_torch.tools import train_cli

    totals = dict.fromkeys(_counted(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        data = generate(os.path.join(tmp, "data"), n_clips=ENTRY_CLIPS, clip_seconds=10.0,
                        seed=SEED, label_ext="npz")
        order = ["a2v_large_pretrain_v5e"] + [r for r in RECIPES if r != "a2v_large_pretrain_v5e"]
        for name in order:
            steps = 2 if name == "a2v_large_pretrain_v5e" else 1
            extra = list(CONFIG_COMMON)
            if name != "a2v_large_pretrain_v5e":
                extra += CONFIG_CUT
            if "finetune" in name:
                extra += CONFIG_FINETUNE
            if name == "nips4bplus_finetune":
                extra.append("task.unique_labels=\"['beep', 'synch', 'sn', 'cc', 'ld', 'oth', "
                             "'mo', 'al', 'soc', 'agg', 'eating', 'focal']\"")
            reset_counts()
            t0 = time.perf_counter()
            with EntryWatch() as watch, PlainSpy() as spy:
                out = train_cli.main(["--config", str(RECIPES[name]), "--data", data,
                                      "--save-dir", os.path.join(tmp, name), "--max-steps",
                                      str(steps), "--device", dev.type, *extra])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = counts()
            for k, v in got.items():
                totals[k] += v
            losses = [round(s["loss"], 5) for s in watch.steps]
            print(f"15e train_cli --config {name}.yaml ({'full width' if steps == 2 else 'depth 1 + 2'}"
                  f"; {' '.join(extra)}): {len(watch.steps)} steps in {seconds:.2f} s (steps "
                  f"{[round(s['seconds'], 3) for s in watch.steps]} s), losses {losses}; "
                  f"launches {launch_line(got)}; plain-version calls on CUDA tensors "
                  f"{spy.cuda_calls} on {card}")
            if len(watch.steps) != steps or spy.cuda_calls or out is None:
                raise AssertionError(f"15e {name}: {len(watch.steps)} steps or a plain call")
            if not all(np.isfinite(s["loss"]) for s in watch.steps):
                raise AssertionError(f"15e {name}: a non-finite loss")
            del watch
            torch.cuda.empty_cache()
    return totals


# phase 16: the encoder's architecture and regularizer options at a2v-large
# width (finetune_100.yaml's: C 1024, H 16, 8 prenet + 16 trunk blocks).
# Variant P: PCEN after the windowed learnable-kernel sinc, the LayerNorm
# before the positional convs, pre-LN blocks without affine norms, one ALiBi
# scale shared by the heads; trained with drop-path 0.1 and activation
# dropout 0.1. Variant N: no ALiBi, a plain first conv, the "default"
# extractor mode, post-LN; trained with drop-path 0.1.
OPTION_VARIANTS = {
    "P": dict(sinc_norm="pcen", apply_window_to_root=True, conv_pos_pre_ln=True,
              layer_norm_first=True, norm_affine=False, learned_alibi_scale_per_head=False),
    "N": dict(use_alibi_encoder=False, sinc_input=False, extractor_mode="default"),
}
OPTION_DROP_PATH, OPTION_ACT_DROP = 0.1, 0.1
# the launches one block makes, by variant: a serving forward's and a
# training step's (the backward kernels; the fused MLPs' backward is torch)
OPTION_SERVE_KEYS = {"P": ("serve_attention", "mlp"), "N": ("bias_attention", "block")}
OPTION_TRAIN_KEYS = {"P": ("attention", "dq", "dkv", "mlp"),
                     "N": ("bias_attention", "bias_dq", "bias_dkv", "block")}


def phase_option_kernels(dev):
    """16k. The changed kernels alone against their plain twins: #8 with its
    two hash-dropout sites at N 8000, C 1024, M 4096 (each site's keep mask,
    read back through the kernel's h and output, against ops/dropout.hash_keep
    where the undropped value is not 0: the differing elements printed, 0
    allowed; values at BLOCK_TOL; the autograd Function's gradients against
    autograd of the plain twin); #6 with a drop-path branch scale at N 8000
    (b4 x 2000, two samples at 0) with and without its dropout sites (values,
    gradients); #11 and #11b with no bias at b4 T 2000 (forward, the dq and
    dk/dv routes against bias_attention_bwd_plain, the autograd Function).
    Returns the max abs errors."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.kernels.build import check, library
    from animal2vec_tpu_torch.ops.bias_attention import (
        bias_attention_bwd_plain, bias_attention_dkv, bias_attention_dq, bias_attention_forward,
        bias_attention_plain, bias_flash_attention,
    )
    from animal2vec_tpu_torch.ops.dropout import hash_keep, keep_scale, keep_threshold
    from animal2vec_tpu_torch.ops.fused_mlp import (
        fused_block_mlp, fused_block_plain, fused_mlp, fused_mlp_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    errs = {}
    n, c, m = TRAIN_BATCH * 2000, 1024, 4096
    args = block_inputs(gen, n, c, m, dev)
    x, w1l, w2l, b1, b2 = args[0], args[3].t().contiguous(), args[4].t().contiguous(), \
        args[5], args[6]
    seeds, rate, row0 = (20261018, -77123), OPTION_ACT_DROP, 3 * n
    name = f"fused MLP + dropout {rate} (N {n}, C {c}, M {m}, row0 {row0})"
    # the kernel's h and output through its C entry, for the masks
    h = torch.empty((n, m), dtype=torch.bfloat16, device=dev)
    out = torch.empty((n, c), dtype=torch.bfloat16, device=dev)
    err = library().a2v_fused_mlp(
        x.data_ptr(), w1l.data_ptr(), b1.data_ptr(), w2l.data_ptr(), b2.data_ptr(),
        h.data_ptr(), out.data_ptr(), n, c, m, c, seeds[0], seeds[1], keep_threshold(rate),
        keep_scale(rate), row0, torch.cuda.current_stream().cuda_stream)
    check(err, "fused MLP kernel")
    rows = row0 + torch.arange(n, device=dev)[:, None]
    h_pre = F.gelu(x.float() @ w1l.float().t() + b1)
    h_ref = h_pre * (hash_keep(seeds[0], rows, torch.arange(m, device=dev)[None], rate) /
                     (1.0 - rate))
    y_pre = h_ref.to(torch.bfloat16).float() @ w2l.float().t() + b2
    keep_b = hash_keep(seeds[1], rows, torch.arange(c, device=dev)[None], rate)
    torch.cuda.synchronize()
    for site, got, pre, keep in (("after GELU", h, h_pre, (h_ref != 0).float()),
                                 ("after fc2", out, y_pre, keep_b)):
        live = pre.to(torch.bfloat16) != 0
        differ = int(((got != 0).float() != keep)[live].sum())
        print(f"{name} site {site}: keep mask read back, {differ} of {int(live.sum())} "
              f"elements differ from hash_keep (kept share {float(keep[live].mean()):.4f})")
        if differ:
            raise AssertionError(f"{name}: the kernel's mask at {site} is not hash_keep's")
    del h, h_pre, h_ref, y_pre, keep_b
    drop = (seeds, rate, row0)
    errs["mlp"] = check_close(name, fused_mlp(x, w1l, w2l, b1, b2, *drop),
                              fused_mlp_plain(x, w1l, w2l, b1, b2, *drop), BLOCK_TOL)
    g = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
    vals = (x, w1l, w2l, b1, b2)
    leaves = [a.clone().requires_grad_() for a in vals]
    got = torch.autograd.grad(fused_mlp(*leaves, *drop), leaves, g)
    leaves_p = [a.float().requires_grad_() for a in vals]
    ref = torch.autograd.grad(fused_mlp_plain(*leaves_p, *drop), leaves_p, g.float())
    for label, a, b in zip(("x", "w1", "w2", "b1", "b2"), got, ref):
        check_rel(f"{name} grad {label} vs autograd of plain", a, b, REL_BLOCK)
    del leaves, leaves_p, got, ref
    # #6 with a drop-path branch scale: samples 0 and 3 dropped
    scale = torch.tensor([0.0, keep_scale(0.1), keep_scale(0.1), 0.0], device=dev)
    xb = x.reshape(TRAIN_BATCH, 2000, c)
    bargs = (xb,) + args[1:]
    errs["block"] = 0.0
    for label, dk in (("drop-path", (None, 0.0, 0.0)),
                      ("drop-path + dropout 0.1", ((11, -22, 2**31 - 5), 0.1, 0.1))):
        bname = f"fused block with a {label} branch scale (b4 x 2000, samples 0 and 3 at 0)"
        kw = dict(row0=0, branch_scale=scale)
        xo, t = fused_block_mlp(*bargs, *dk, **kw)
        xo_p, t_p = fused_block_plain(*bargs, *dk, **kw)
        torch.cuda.synchronize()
        errs["block"] = max(errs["block"], check_close(f"{bname} tap t", t, t_p, BLOCK_TOL),
                            check_close(f"{bname} x_out", xo, xo_p, BLOCK_TOL))
        cot = tuple(torch.randn(xo.shape, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
        leaves = [a.clone().requires_grad_() if isinstance(a, torch.Tensor) else a
                  for a in bargs]
        g1 = torch.autograd.grad(fused_block_mlp(*leaves, *dk, **kw), leaves[:9], cot)
        leaves_p = [a.clone().requires_grad_() if isinstance(a, torch.Tensor) else a
                    for a in bargs]
        g2 = torch.autograd.grad(fused_block_plain(*leaves_p, *dk, **kw), leaves_p[:9], cot)
        check_rel(f"{bname} grad x vs autograd of plain", g1[0], g2[0], REL_BLOCK)
        check_rel(f"{bname} grad w1 vs autograd of plain", g1[3], g2[3], REL_BLOCK)
        del leaves, leaves_p, g1, g2
    del args, bargs
    # #11 and #11b with no bias at b4 T 2000 (an ALiBi-free finetune step)
    b, t, hh = TRAIN_BATCH, 2000, 16
    bname = f"bias attention, no bias, b{b} T {t}"
    q, k, v = bias_attention_inputs(gen, b, hh, t, dev)
    out, lse = bias_attention_forward(q, k, v, None, None, with_lse=True)
    out_p = bias_attention_plain(q.float(), k.float(), v.float(), None, None)
    torch.cuda.synchronize()
    errs["bias_attention"] = check_close(f"{bname} out", out, out_p, ATTN_TOL)
    dout = torch.randn((b, t, hh, 64), generator=gen, device=dev).to(torch.bfloat16)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * hh, t)
    bwd = (q, k, v, dout, lse, delta, None, None)
    dq, _ = bias_attention_dq(*bwd)
    dk_, dv = bias_attention_dkv(*bwd)
    want = bias_attention_bwd_plain(*bwd)
    torch.cuda.synchronize()
    errs["bias_dq"] = check_close(f"{bname} dq", dq, want[0], BWD_TOL)
    errs["bias_dkv"] = max(check_close(f"{bname} dk", dk_, want[1], BWD_TOL),
                           check_close(f"{bname} dv", dv, want[2], BWD_TOL))
    check_heads(bname, ("dq", "dk", "dv"), [a.transpose(1, 2) for a in (dq, dk_, dv)],
                [a.transpose(1, 2) for a in want[:3]], REL_HEAD, ulps=2)
    qkv = torch.stack((q, k, v), dim=2)
    leaves, leaves_p = [qkv.clone().requires_grad_()], [qkv.float().requires_grad_()]
    got = torch.autograd.grad(bias_flash_attention(*leaves[0].unbind(2)), leaves, dout)
    ref = torch.autograd.grad(bias_attention_plain(*leaves_p[0].unbind(2)), leaves_p,
                              dout.float())
    check_rel(f"{bname} d qkv vs autograd of plain", got[0], ref[0], REL_QKV)
    del q, k, v, qkv, leaves, leaves_p, got, ref, want, dq, dk_, dv
    torch.cuda.empty_cache()
    return errs


def option_kernel_times(dev):
    """16t. #8 with and without dropout at N 8000, C 1024, M 4096 beside
    F.linear x 2; #6 with the drop-path scale at N 8000; #11 with no bias
    at b32 T 2000 beside #1 at the same shape and SDPA without a mask (also
    by device time); #11b's dq and dk/dv routes at b4 T 2000 beside SDPA's
    backward alone. Returns the rows."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.attention import alibi_flash_attention_btc
    from animal2vec_tpu_torch.ops.bias_attention import (
        bias_attention_bwd_plain, bias_attention_dkv, bias_attention_dq, bias_attention_forward,
        bias_attention_plain,
    )
    from animal2vec_tpu_torch.ops.dropout import keep_scale
    from animal2vec_tpu_torch.ops.fused_mlp import (
        fused_block_mlp, fused_block_plain, fused_mlp, fused_mlp_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    rows = {}

    def row(key, ms, plain_ms, library_ms, bnd, **extra):
        rows[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1], **extra}
        lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
        print(f"{key}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib}, "
              f"bound {bnd[0]:.3f} ms ({bnd[1]})"
              + "".join(f", {k} {ms_text(v)}" for k, v in extra.items()))

    n, c, m = TRAIN_BATCH * 2000, 1024, 4096
    args = block_inputs(gen, n, c, m, dev)
    x, w1l, w2l, b1, b2 = args[0], args[3].t().contiguous(), args[4].t().contiguous(), \
        args[5], args[6]
    lib = lambda: F.linear(F.gelu(F.linear(x, w1l, b1.to(x.dtype))), w2l, b2.to(x.dtype))  # noqa
    for label, drop in (("", ()), (f" + dropout {OPTION_ACT_DROP}",
                                   ((5, 6), OPTION_ACT_DROP, 0))):
        call = lambda: fused_mlp(x, w1l, w2l, b1, b2, *drop)  # noqa: E731
        row(f"fused MLP{label}, N {n} a2v-large widths", cuda_ms(call),
            cuda_ms(lambda: fused_mlp_plain(x, w1l, w2l, b1, b2, *drop), iters=3), cuda_ms(lib),
            mlp_bound(n, c, m), device_ms=device_ms(call, "gemm_bf16_sm90_kernel"),
            library_device_ms=device_ms(lib, ""))
    xb = x.reshape(TRAIN_BATCH, 2000, c)
    scale = torch.tensor([0.0, keep_scale(0.1), keep_scale(0.1), 0.0], device=dev)
    call = lambda: fused_block_mlp(xb, *args[1:], branch_scale=scale)  # noqa: E731
    row(f"fused block + drop-path scale, N {n}", cuda_ms(call),
        cuda_ms(lambda: fused_block_plain(xb, *args[1:], branch_scale=scale), iters=3), None,
        block_bound(n))
    del args, x, xb
    torch.cuda.empty_cache()
    with torch.inference_mode():
        b, hh, t = 32, 16, 2000
        q, k, v = bias_attention_inputs(gen, b, hh, t, dev)
        qkv_btc = torch.stack((q, k, v), dim=2).reshape(b, t, 3 * hh * 64)
        from animal2vec_tpu_torch.ops.alibi import alibi_slopes

        slopes = torch.from_numpy(alibi_slopes(hh).copy()).to(dev)
        pos = torch.arange(t, dtype=torch.int32, device=dev)[None]
        qs, ks, vs = (a.transpose(1, 2) for a in (q, k, v))
        call = lambda: bias_attention_forward(q, k, v)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs)  # noqa: E731
        alibi = lambda: alibi_flash_attention_btc(qkv_btc, hh, slopes, pos)  # noqa: E731
        flops = 4 * b * hh * t * t * 64
        dev_ms = device_ms(call, "bias_attention_kernel")
        row(f"bias attention, no bias, b{b} T {t}", cuda_ms(call),
            cuda_ms(lambda: bias_attention_plain(q[:4], k[:4], v[:4]), iters=3) * b / 4,
            cuda_ms(sdpa), bias_attention_bound(b, hh, t, 64, bias_planes=0),
            device_ms=dev_ms, library_device_ms=device_ms(sdpa, ""),
            alibi_serve_ms=cuda_ms(alibi))
        rows[f"bias attention, no bias, b{b} T {t}"]["tflops"] = per_ms(flops, dev_ms)
        del q, k, v, qs, ks, vs, qkv_btc
    torch.cuda.empty_cache()
    b = TRAIN_BATCH
    q, k, v = bias_attention_inputs(gen, b, hh, t, dev)
    out, lse = bias_attention_forward(q, k, v, None, None, with_lse=True)
    dout = torch.randn((b, t, hh, 64), generator=gen, device=dev).to(torch.bfloat16)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * hh, t)
    bwd = (q, k, v, dout, lse, delta, None, None)
    plain = cuda_ms(lambda: bias_attention_bwd_plain(*bwd), iters=3)
    qs, ks, vs = (a.transpose(1, 2).detach().clone().requires_grad_() for a in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs)
    g = dout.transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(o, (qs, ks, vs), g, retain_graph=True))
    bounds = attention_bounds(b, hh, t, 64)
    for what, fn, kernel in (("dq", bias_attention_dq, "bias_attention_dq"),
                             ("dkv", bias_attention_dkv, "bias_attention_dkv")):
        call = lambda: fn(*bwd)  # noqa: E731
        dev_ms = device_ms(call, kernel)
        row(f"bias attention {what}, no bias, b{b} T {t}", cuda_ms(call), plain, lib_bwd,
            bounds[what], device_ms=dev_ms)
        rows[f"bias attention {what}, no bias, b{b} T {t}"]["tflops"] = tflops(
            what, b, hh, t, dev_ms, 64)
    print(f"  (plain: bias_attention_bwd_plain computes dq, dk, dv in one call; library: "
          f"SDPA's backward alone without a mask, {lib_bwd:.3f} ms)")
    del q, k, v, qs, ks, vs, o, out, lse, dout, bwd
    torch.cuda.empty_cache()
    return rows


def option_cfg(variant):
    from animal2vec_tpu_torch.config import FinetuneConfig

    return dataclasses.replace(FinetuneConfig(), **OPTION_VARIANTS[variant])


# the b2 serving logits of each variant's bf16 model (phase 16a), which
# phase 23a's fp32 models are held beside (printed, not gated)
OPTION_BF16_LOGITS = {}


def phase_option_model(variant, card, dev, dtype=torch.bfloat16):
    """16a. One variant at a2v-large width: the bf16 serving model (seeded
    weights, serving cast) at b2 kernel path against plain path (MODEL_TOL)
    with one serving launch set per block and no plain version on a CUDA
    tensor; the b32 forward's clips/s and launches; then three b4 finetune
    steps of the finetune_100 recipe with drop-path 0.1 (and activation
    dropout 0.1) from the first step after the freeze gate: finite loss and
    gradients, one training launch set per block that layerdrop kept, the
    median ms and peak memory; then at b2 with the rates of the phase's
    comparison (drop-path and activation dropout on, the others 0) the
    kernel path's gradients against the plain path's (MODEL_GRAD_TOL per
    tensor). With ``dtype`` fp32 (23a): every model in fp32 (the kernels'
    fp32 instances), the logits within FP32_MODEL_TOL and also against the
    bf16 model's (printed), the gradients within FP32_GRAD_TOL. Returns the
    launches of the serving and training runs and the run's figures."""
    from animal2vec_tpu_torch.config import FinetuneTrainConfig
    from animal2vec_tpu_torch.models.finetune import build_finetune_model
    from animal2vec_tpu_torch.models.modules import AltBlock
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.finetune_step import finetune_loss, make_finetune_train_step
    from animal2vec_tpu_torch.train.state import FinetuneState

    cfg = option_cfg(variant)
    fp32 = dtype == torch.float32
    label = f"23a fp32 variant {variant}" if fp32 else f"16 variant {variant}"
    model_tol, grad_tol = (FP32_MODEL_TOL, FP32_GRAD_TOL) if fp32 else (MODEL_TOL, MODEL_GRAD_TOL)
    total = dict.fromkeys(_counted(), 0)
    src = torch.from_numpy(np.random.default_rng(SEED + 60).normal(
        size=(2, WAV_LEN)).astype(np.float32)).to(dev)
    if fp32 and variant not in OPTION_BF16_LOGITS:  # phase 23 run alone
        with torch.inference_mode():
            OPTION_BF16_LOGITS[variant] = build_model(cfg, dev)(src)["encoder_out"]
        torch.cuda.empty_cache()
    model = build_model(cfg, dev, dtype)
    with torch.inference_mode():
        reset_counts()
        with PlainSpy() as spy:
            got = model(src)["encoder_out"]
        launched = counts()
        with PlainOps():
            want = model(src)["encoder_out"]
    want_launches = dict.fromkeys(_counted(), 0)
    want_launches.update({k: cfg.n_blocks for k in OPTION_SERVE_KEYS[variant]})
    err = (got.float() - want.float()).abs().max().item()
    print(f"{label} serving b2: logits {tuple(got.shape)} {got.dtype}, kernel vs plain path max "
          f"abs {err:.3e} (tolerance {model_tol}); launches {launch_line(launched)}; plain "
          f"versions called on CUDA tensors: {spy.cuda_calls}")
    if not torch.isfinite(got).all() or not err <= model_tol or got.dtype != dtype:
        raise AssertionError(f"{label}: serving logits disagree with the plain path")
    if fp32:
        ref = OPTION_BF16_LOGITS[variant]
        print(f"{label} serving b2 logits against the bf16 model's (not gated): max abs "
              f"{(got - ref.float()).abs().max().item():.3e}, relative norm "
              f"{rel_norm(got, ref):.3e}")
    else:
        OPTION_BF16_LOGITS[variant] = got
    if launched != want_launches or spy.cuda_calls:
        raise AssertionError(f"{label}: serving launches {launched} != {want_launches}")
    total = {k: total[k] + launched[k] for k in total}
    b32 = torch.from_numpy(np.random.default_rng(SEED + 2).normal(
        size=(32, WAV_LEN)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        model(b32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        iters = 3
        for _ in range(iters):
            model(b32)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} serving b32: {32 / dt:.2f} 10-s clips/s ({dt * 1e3:.1f} ms per batch), peak "
          f"memory {peak:.2f} GiB on {card}; launches {launch_line(launched)} over {iters}")
    if launched != {k: iters * v for k, v in want_launches.items()}:
        raise AssertionError(f"{label}: b32 launches {launched}")
    total = {k: total[k] + launched[k] for k in total}
    serve_ms = dt * 1e3
    del model, b32, got, want
    torch.cuda.empty_cache()

    base = FinetuneTrainConfig()
    tcfg = dataclasses.replace(base, drop_path=OPTION_DROP_PATH,
                               activation_dropout=OPTION_ACT_DROP,
                               optimization=dataclasses.replace(base.optimization,
                                                                update_freq=1))
    model = build_finetune_model(cfg, dtype=dtype, seed=SEED, device=dev, train=tcfg)
    state = FinetuneState.create(model, tcfg)
    state.step = tcfg.freeze_finetune_updates
    step_fn = make_finetune_train_step(tcfg)
    batch = train_batch(cfg, dev)
    rngs = Rngs.from_seed(SEED, dev)
    ran = [0]
    for mod in model.modules():
        if isinstance(mod, AltBlock):
            mod.register_forward_pre_hook(lambda module, a: ran.__setitem__(0, ran[0] + 1))
    keys = OPTION_TRAIN_KEYS[variant]
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        ran[0] = 0
        reset_counts()
        t0 = time.perf_counter()
        with PlainSpy() as spy:
            metrics = step_fn(state, batch, rngs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launched = counts()
        loss = float(metrics["loss"])
        want_step = dict.fromkeys(_counted(), 0)
        want_step.update({k: ran[0] for k in keys})
        print(f"{label} train step {i + 1}: loss {loss:.5f}, {times[-1]:.1f} ms; launches "
              f"{launch_line(launched)} (expected {ran[0]} each of {', '.join(keys)}: "
              f"{cfg.n_blocks} blocks less {cfg.n_blocks - ran[0]} dropped by layerdrop)")
        if not np.isfinite(loss) or launched != want_step or ran[0] == 0 or spy.cuda_calls:
            raise AssertionError(f"{label}: train step {launched} != {want_step}, loss {loss}")
        for n, p in model.named_parameters():
            if p.grad is None or not torch.isfinite(p.grad).all():
                raise AssertionError(f"{label}: missing or non-finite gradient {n}")
        total = {k: total[k] + launched[k] for k in total}
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    train_ms = float(np.median(times))
    print(f"{label} train step b{TRAIN_BATCH} (finetune_100, drop_path {OPTION_DROP_PATH}, "
          f"activation_dropout {OPTION_ACT_DROP}): median {train_ms:.1f} ms of "
          f"{[round(t, 1) for t in times]}, peak memory {train_peak:.2f} GiB on {card}")
    del state, model, step_fn
    torch.cuda.empty_cache()

    gcfg = dataclasses.replace(
        tcfg, freeze_finetune_updates=0, apply_mask=False, mask_channel_prob=0.0, dropout=0.0,
        attention_dropout=0.0, layerdrop=0.0, source_mixup=-1.0)
    model = build_finetune_model(cfg, dtype=dtype, seed=SEED, device=dev, train=gcfg)
    mb = {k: v[0] for k, v in train_batch(cfg, dev, batch=2, seed=SEED + 61).items()}

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = finetune_loss(model, mb, Rngs.from_seed(SEED + 62, dev), 0, gcfg, train=True)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float().clone()
                                      for n, p in model.named_parameters()
                                      if p.grad is not None}

    loss_k, g_k = grads()
    with PlainOps():
        loss_p, g_p = grads()
    torch.cuda.synchronize()
    rels = {n: rel_norm(g_k[n], g_p[n]) for n in g_p if g_p[n].norm() > 0}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    print(f"{label} gradients b2 (drop-path {OPTION_DROP_PATH}, activation dropout "
          f"{OPTION_ACT_DROP}, the same draws), kernel vs plain path: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}; relative norm per tensor max {worst[0][1]:.3e}, median "
          f"{float(np.median(list(rels.values()))):.3e} over {len(rels)} tensors (tolerance "
          f"{grad_tol}); worst {[(n, f'{r:.2e}') for n, r in worst]}")
    if set(rels) != set(n for n in g_k if g_k[n].norm() > 0):
        raise AssertionError(f"{label}: the two paths give gradients to different parameters")
    if not max(rels.values()) <= grad_tol:
        raise AssertionError(f"{label}: kernel-path gradients disagree with the plain path")
    del model, g_k, g_p
    torch.cuda.empty_cache()
    return total, {"serve_b32_ms": serve_ms, "train_b4_ms": train_ms, "serve_peak_gib": peak,
                   "train_peak_gib": train_peak, "logits_max_abs_err": err,
                   "grad_rel_max": max(rels.values())}


# the launches of one int8 block by variant and mode (ROADMAP A.12): pre-LN
# blocks take the int8 MLP (#9), post-LN ones the int8 block (#7); int8_attn
# adds the two int8 projections (#10) and, with ALiBi, the int8 attention
# with its quantization pass (#5, #5q); else the bf16 attention stays (#1
# with ALiBi, #11 without)
OPTION_INT8_KEYS = {
    ("P", "int8"): {"serve_attention": 1, "int8_mlp": 1},
    ("P", "int8_attn"): {"int8_dense": 2, "int8_quant": 1, "int8_attention": 1, "int8_mlp": 1},
    ("N", "int8"): {"bias_attention": 1, "int8_block": 1},
    ("N", "int8_attn"): {"int8_dense": 2, "bias_attention": 1, "int8_block": 1},
}


def phase_option_int8(variant, card, dev):
    """16i. One variant at a2v-large width served in int8 and int8_attn
    (seeded weights, serving cast, quantized at load): for each mode the b2
    kernel path against the plain path (INT8_MODEL_REL relative norm,
    PRE_LN_INT8_REL for pre-LN blocks) and against the bf16 model's logits
    (INT8_VS_BF16_REL), its launches per block (OPTION_INT8_KEYS) with no
    plain version on a CUDA tensor; then the b32 forward's clips/s and
    launches. Returns the launches and the b32 rows."""
    cfg = option_cfg(variant)
    tol = PRE_LN_INT8_REL if cfg.layer_norm_first else INT8_MODEL_REL
    model = build_model(cfg, dev)
    src = torch.from_numpy(np.random.default_rng(SEED + 64).normal(
        size=(2, WAV_LEN)).astype(np.float32)).to(dev)
    b32 = torch.from_numpy(np.random.default_rng(SEED + 2).normal(
        size=(32, WAV_LEN)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        bf16_logits = model(src)["encoder_out"]
    total = dict.fromkeys(_counted(), 0)
    rows = {}
    for mode in MODES:
        label = f"16i variant {variant} {mode}"
        served = int8_model(model, cfg, mode, dev)
        want = dict.fromkeys(_counted(), 0)
        want.update({k: n * cfg.n_blocks for k, n in OPTION_INT8_KEYS[variant, mode].items()})
        with torch.inference_mode():
            reset_counts()
            with PlainSpy() as spy:
                got = served(src)["encoder_out"]
            launched = counts()
            with PlainOps():
                plain = served(src)["encoder_out"]
        rel, rel_bf16 = rel_norm(got, plain), rel_norm(got, bf16_logits)
        print(f"{label} serving b2: logits {tuple(got.shape)}, kernel vs plain path relative norm "
              f"{rel:.3e} (tolerance {tol}), max abs "
              f"{(got.float() - plain.float()).abs().max().item():.3e}; against the bf16 model "
              f"{rel_bf16:.3e} (bound {INT8_VS_BF16_REL}); launches {launch_line(launched)}; "
              f"plain versions called on CUDA tensors: {spy.cuda_calls}")
        if not torch.isfinite(got).all() or not rel <= tol:
            raise AssertionError(f"{label}: serving logits disagree with the plain path")
        if not rel_bf16 <= INT8_VS_BF16_REL:
            raise AssertionError(f"{label}: logits stray from the bf16 model's")
        if launched != want or spy.cuda_calls:
            raise AssertionError(f"{label}: serving launches {launched} != {want}")
        total = {k: total[k] + launched[k] for k in total}
        with torch.inference_mode():
            served(b32)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            iters = 3
            for _ in range(iters):
                served(b32)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / iters
            launched = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{label} serving b32: {32 / dt:.2f} 10-s clips/s ({dt * 1e3:.1f} ms per batch), "
              f"peak memory {peak:.2f} GiB on {card}; launches {launch_line(launched)} over "
              f"{iters}")
        if launched != {k: iters * v for k, v in want.items()}:
            raise AssertionError(f"{label}: b32 launches {launched}")
        total = {k: total[k] + launched[k] for k in total}
        rows[mode] = {"serve_b32_ms": dt * 1e3, "clips_per_s": 32 / dt, "rel_plain": rel,
                      "rel_bf16": rel_bf16, "peak_gib": peak}
        del served, got, plain
        torch.cuda.empty_cache()
    del model, b32
    torch.cuda.empty_cache()
    return total, rows


def phase_option_pretrain(card, dev, dtype=torch.bfloat16):
    """16b. One a2v-large pretrain step of variant P at the v5e micro-batch
    (b8 x clone 12, update_freq 1) with the A.7 dropouts (activation 0.1,
    input 0.1, layerdrop 0.05, prenet layerdrop 0.05) and drop-path 0.1:
    finite loss and gradients, the launches, the ms of a second step and the
    peak memory; in the compute ``dtype`` (fp32: 23a). Returns the
    launches."""
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.pretrain import make_pretrain_train_step
    from animal2vec_tpu_torch.train.state import PretrainState

    base = _pretrain_v5e()
    mcfg = dataclasses.replace(base.model, **OPTION_VARIANTS["P"],
                               start_drop_path_rate=OPTION_DROP_PATH,
                               end_drop_path_rate=OPTION_DROP_PATH)
    cfg = dataclasses.replace(base, model=mcfg, activation_dropout=0.1, dropout_input=0.1,
                              layerdrop=0.05, prenet_layerdrop=0.05)
    torch.cuda.empty_cache()
    model = build_pretrain_model(cfg, dtype=dtype, seed=SEED, device=dev)
    state = PretrainState.create(model, cfg)
    state.step = cfg.optimization.warmup_updates
    step_fn = make_pretrain_train_step(cfg)
    data = pretrain_batch(cfg, dev, V5E_BATCH, SEED + 63)
    tag = "23a fp32" if dtype == torch.float32 else "16b"
    total = dict.fromkeys(_counted(), 0)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2):
        reset_counts()
        t0 = time.perf_counter()
        with PlainSpy() as spy:
            metrics = step_fn(state, data, Rngs.from_seed(SEED + i, dev))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launched = counts()
        loss = float(metrics["loss"])
        print(f"{tag} a2v-large pretrain step {i + 1}, variant P, b{V5E_BATCH} x clone "
              f"{cfg.clone_batch} (activation 0.1, input 0.1, layerdrop 0.05, prenet layerdrop "
              f"0.05, drop-path {OPTION_DROP_PATH}): loss {loss:.6f}, {times[-1]:.1f} ms; "
              f"launches {launch_line(launched)}")
        bad = [n for n, p in model.named_parameters()
               if p.grad is not None and not torch.isfinite(p.grad).all()]
        if not np.isfinite(loss) or bad or spy.cuda_calls or not launched["mlp"]:
            raise AssertionError(f"{tag}: loss {loss}, non-finite gradients {bad[:3]}, plain "
                                 f"calls {spy.cuda_calls}, launches {launched}")
        total = {k: total[k] + launched[k] for k in total}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} variant P pretrain step: {times[-1]:.1f} ms (second step), peak memory "
          f"{peak:.2f} GiB (torch.cuda.max_memory_allocated) on {card}")
    del state, model, step_fn, data
    torch.cuda.empty_cache()
    return total, {"pretrain_ms": times[-1], "pretrain_peak_gib": peak}


def phase_pcen(card, dev):
    """16c. The PCEN scan (the smoother and PCEN at a2v-large's layer 0: 127
    channels, T 80 000 a 10-s clip) at b32 serving (forward, no gradient)
    and b4 training (forward + backward): ms and the peak memory above the
    input's. Not a kernel: torch ops."""
    from animal2vec_tpu_torch.models.frontend import PCEN

    pcen = PCEN(127).to(dev)
    rows = {}
    for label, b, train in (("b32 serving", 32, False), ("b4 training", 4, True)):
        x = torch.rand((b, WAV_LEN, 127), generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev).to(torch.bfloat16)
        g = torch.ones_like(x)

        def call():
            if train:
                xx = x.detach().requires_grad_()
                torch.autograd.grad(pcen(xx), [xx] + list(pcen.parameters()), g)
            else:
                with torch.no_grad():
                    pcen(x)

        call()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        ms = cuda_ms(call, iters=3, warmup=0)
        rows[label] = {"ms": ms, "peak_gib": peak}
        print(f"16c PCEN (smoother scan + norm) {label}, (B, T, C) = ({b}, {WAV_LEN}, 127): "
              f"{ms:.2f} ms{' forward + backward' if train else ''}, peak memory {peak:.2f} GiB "
              f"above its input on {card}")
        del x, g
        torch.cuda.empty_cache()
    return rows


def phase_options(card, dev):
    """16. The encoder's options: the changed kernels alone, their times,
    variants P and N at a2v-large width (serving, finetuning, gradients),
    both served in int8 and int8_attn, the variant P pretrain step and the
    PCEN scan. Returns (launches by kernel key, the int8 serving runs'
    launches, the max abs errors, the time rows)."""
    errs = phase_option_kernels(dev)
    rows = option_kernel_times(dev)
    launches = dict.fromkeys(_counted(), 0)
    e2e = {}
    for variant in OPTION_VARIANTS:
        got, e2e[variant] = phase_option_model(variant, card, dev)
        launches = {k: launches[k] + got[k] for k in launches}
    int8_launches = dict.fromkeys(_counted(), 0)
    for variant in OPTION_VARIANTS:
        got, e2e[f"{variant}_int8"] = phase_option_int8(variant, card, dev)
        int8_launches = {k: int8_launches[k] + got[k] for k in int8_launches}
    print(f"16i launches over the int8 serving runs: {launch_line(int8_launches)}")
    got, e2e["pretrain"] = phase_option_pretrain(card, dev)
    launches = {k: launches[k] + got[k] for k in launches}
    e2e["pcen"] = phase_pcen(card, dev)
    print(f"16 launches over the phase's main-path runs: {launch_line(launches)}")
    print(json.dumps({"phase16": e2e}))
    return launches, int8_launches, errs, rows


# phase 17: the rest of data2vec-2 pretraining (ROADMAP A.7) at a2v-large
# width: every audio option at the v5e recipe's micro-batch (b8 x clone 12,
# remat "attn"), the kernel-vs-plain gradients with every rate at 0, the
# ViT-B/16 reconstruction step, and train_cli --config pretraining with the
# probe, then finetuning from it.
A7_STEPS = 3  # timed steps after the checked one, as 15a
A7_LOSS_WEIGHTS = (("linear_eval_loss", 0.5),)


def a7_cfg(options=True, shared=True):
    """The a2v-large pretraining recipe at the v5e micro-batch with remat
    "attn", and with ``options`` every audio option of A.7 on: the focal
    probe with target mixup, a shared decoder 768/7/16/4 with a 2-layer
    projection head (unless not ``shared``), layer-normed target layers and
    targets at the blocks' ends, keep_masked_pct 0.1, mask_dropout 0.1,
    noise-filled student masks, local_grad_mult 0.5, a weight on the
    probe's loss."""
    from animal2vec_tpu_torch.config import DecoderConfig

    base = _pretrain_v5e()
    model = dataclasses.replace(base.model, remat=True, remat_scope="attn",
                                end_of_block_targets=options)
    if not options:
        return dataclasses.replace(base, model=model)
    return dataclasses.replace(
        base, model=model, with_labels=True, target_mixup=True,
        shared_decoder=DecoderConfig(768, 16, 7, 4, 0.1, projection_layers=2) if shared else None,
        layer_norm_target_layer=True, layer_norm_targets=True, keep_masked_pct=0.1,
        mask_dropout=0.1, encoder_zero_mask=False, local_grad_mult=0.5,
        loss_weights=A7_LOSS_WEIGHTS)


def a7_batch(cfg, dev, batch, seed, accum=1):
    """``pretrain_batch`` with (B, T, n) 0/1 frame labels for the probe."""
    from animal2vec_tpu_torch.ops.conv_arith import label_frame_length

    data = pretrain_batch(cfg, dev, batch, seed, accum)
    if cfg.with_labels:
        t = label_frame_length(WAV_LEN, cfg.model.conv_layers)
        gen = torch.Generator(device=dev).manual_seed(seed)
        data["target"] = (torch.rand((accum, batch, t, len(cfg.model.labels)), generator=gen,
                                     device=dev) < 0.2).float()
    return data


def phase_a7_step(card, dev):
    """17a. One a2v-large pretrain step with every audio option on, the
    same without the shared decoder (its cost is the difference) and the
    recipe's default step, each at b8 x clone 12 with remat "attn" from the
    same seed: finite losses, every loss term (the regressions, the probe),
    the launches per block (the student's #2 twice under remat, #3, #4, #6;
    the teacher's #1 and #6), no plain version on a CUDA tensor, the kept
    token count, then the median of three more steps' ms and their peak
    memory. Returns (launches of the checked steps, rows)."""
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model
    from animal2vec_tpu_torch.ops.conv_arith import label_frame_length
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.pretrain import make_pretrain_train_step, mask_tokens
    from animal2vec_tpu_torch.train.state import PretrainState

    total = dict.fromkeys(_counted(), 0)
    rows = {}
    for label, options, shared in (("every option", True, True),
                                   ("every option but the shared decoder", True, False),
                                   ("recipe default", False, False)):
        cfg = a7_cfg(options, shared)
        torch.cuda.empty_cache()
        model = build_pretrain_model(cfg, dtype=torch.bfloat16, seed=SEED, device=dev)
        state = PretrainState.create(model, cfg)
        state.step = cfg.optimization.warmup_updates
        step_fn = make_pretrain_train_step(cfg)
        data = a7_batch(cfg, dev, V5E_BATCH, SEED + 71)
        n = cfg.model.n_blocks
        want = dict(pretrain_launches(cfg), attention=2 * n)  # remat "attn" recomputes #2
        reset_counts()
        with PlainSpy() as spy:
            metrics = step_fn(state, data, Rngs.from_seed(SEED, dev))
        torch.cuda.synchronize()
        got = counts()
        losses = {k: float(v) for k, v in metrics.items() if k.startswith("loss")}
        t = label_frame_length(WAV_LEN, cfg.model.conv_layers)  # 2000 frames of 10 s
        m = mask_tokens(cfg, t)
        kept = t - m + round(m * cfg.keep_masked_pct)
        terms = ["loss_AUDIO_regression_0", "loss_AUDIO_regression_1"] if shared else [
            "loss_AUDIO_regression"]
        terms += ["loss_linear_eval_loss"] if options else []
        print(f"17a a2v-large pretrain b{V5E_BATCH} x clone {cfg.clone_batch}, remat attn, "
              f"{label}: losses {losses}; student tokens {kept} of {t} ({m} masked, "
              f"{t - kept} regressed); launches {launch_line(got)} (expected "
              f"{launch_line(want)}); plain-version calls on CUDA tensors {spy.cuda_calls}")
        bad = [k for k, p in model.named_parameters()
               if p.grad is not None and not torch.isfinite(p.grad).all()]
        if not all(np.isfinite(v) for v in losses.values()) or bad:
            raise AssertionError(f"17a {label}: a non-finite loss or gradient {bad[:3]}")
        if sorted(k for k in losses if k != "loss") != sorted(terms):
            raise AssertionError(f"17a {label}: loss terms {sorted(losses)} != {terms}")
        if got != want or spy.cuda_calls:
            raise AssertionError(f"17a {label}: launches {got} != {want}, or a plain call")
        if shared:
            probe = metrics["pretrain/total"]
            print(f"17a probe: {int(probe)} (row, frame, class) predictions at threshold "
                  f"{cfg.metric_threshold}, tp {float(metrics['pretrain/tp']):.0f}, fp "
                  f"{float(metrics['pretrain/fp']):.0f}; shared decoder and probe gradients "
                  f"{model.shared_decoder.proj_1.weight.grad.float().norm().item():.3e}, "
                  f"{model.linear_eval_projection.weight.grad.float().norm().item():.3e}")
            if not (model.linear_eval_projection.weight.grad.abs().sum() > 0
                    and model.shared_decoder.blocks[0].weight.grad.abs().sum() > 0):
                raise AssertionError("17a: no gradient for the probe or the shared decoder")
        total = {k: total[k] + got[k] for k in total}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(A7_STEPS):
            t0 = time.perf_counter()
            step_fn(state, data, Rngs.from_seed(SEED + 1 + i, dev))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times))
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows[label] = {"ms": ms, "peak_gib": peak, "student_tokens": kept}
        print(f"17a {label}: steps 2-{A7_STEPS + 1} {[round(x, 1) for x in times]} ms (median "
              f"{ms:.1f}), peak memory {peak:.2f} GiB (torch.cuda.max_memory_allocated) on {card}")
        del state, model, step_fn, data
    torch.cuda.empty_cache()
    with_shared, without = rows["every option"], rows["every option but the shared decoder"]
    print(f"17a the shared decoder's cost: "
          f"{with_shared['ms'] - without['ms']:+.1f} ms, "
          f"{with_shared['peak_gib'] - without['peak_gib']:+.2f} GiB peak on {card}")
    return total, rows


def a7_grads(cfg, dev, batch, label, must):
    """At ``batch`` x clone 2 with every rate at 0 (no mixup, dropout or
    decoder input dropout; the noise fills drawn alike on both paths from
    one seed), the biases moved off 0 and one mask drawn once: the loss's
    gradients through the kernels against those through the plain versions,
    one relative norm per parameter tensor; the tensors named in ``must``
    (the new parameters) among them. Returns the worst relative norm."""
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.pretrain import draw_pretrain_mask, pretrain_loss
    from animal2vec_tpu_torch.train.state import ema_subset

    no_drop = {d: dataclasses.replace(getattr(cfg, d), input_dropout=0.0)
               for d in ("decoder", "shared_decoder") if getattr(cfg, d) is not None}
    cfg = dataclasses.replace(
        cfg, clone_batch=2, encoder_dropout=0.0, attention_dropout=0.0, post_mlp_drop=0.0,
        prenet_dropout=0.0, activation_dropout=0.0, final_dropout=0.0, source_mixup=-1.0,
        **no_drop)
    model = build_pretrain_model(cfg, dtype=torch.bfloat16, seed=SEED, device=dev)
    gen = torch.Generator().manual_seed(SEED + 18)
    with torch.no_grad():  # as phase_pretrain_grads: biases off 0
        for n, p in model.named_parameters():
            if n.endswith(".bias"):
                p.add_((0.05 * torch.randn(p.shape, generator=gen)).to(p.device))
    ema = ema_subset(model, cfg.ema_encoder_only)
    mb = {k: v[0] for k, v in a7_batch(cfg, dev, batch, SEED + 15).items()}
    masks = {}

    def draw(rows, t, rngs):
        if (rows, t) not in masks:
            masks[rows, t] = draw_pretrain_mask(cfg, rows, t, Rngs.from_seed(SEED + 16, "cpu"))
        return masks[rows, t]

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = pretrain_loss(model, ema, mb, Rngs.from_seed(SEED, dev), cfg, True, draw)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float().clone()
                                      for n, p in model.named_parameters() if p.grad is not None}

    loss_k, g_k = grads()
    with PlainOps():
        loss_p, g_p = grads()
    torch.cuda.synchronize()
    rels = {n: rel_norm(g_k[n], g_p[n]) for n in g_p if g_p[n].norm() > 0}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    print(f"{label} gradients b{batch} x clone 2, kernel vs plain path: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}; relative norm per tensor: max {worst[0][1]:.3e}, median "
          f"{float(np.median(list(rels.values()))):.3e} over {len(rels)} tensors (tolerance "
          f"{MODEL_GRAD_TOL}); {', '.join(f'{n} {rels[n]:.2e}' for n in must)}; worst "
          f"{[(n, f'{r:.2e}') for n, r in worst]}")
    if set(rels) != {n for n in g_k if g_k[n].norm() > 0} or not set(must) <= set(rels):
        raise AssertionError(f"{label}: the paths give gradients to different parameters")
    if not max(rels.values()) <= MODEL_GRAD_TOL:
        raise AssertionError(f"{label}: kernel-path gradients disagree with the plain path")
    del model, g_k, g_p
    torch.cuda.empty_cache()
    return worst[0][1]


def phase_a7_image(card, dev):
    """17c. One ViT-B/16 pretrain step (``vit_b16``) with the reconstruction
    loss 1, the inverse block mask and mask_prob_adjust 0.05 at b64 x clone
    2: finite losses with the recon term, #11's launches (student and
    teacher), the student's backward route for its kept patches (#11b's
    single launch up to 64, dq and dk/dv beyond), #6's; then b2 gradients
    kernel vs plain path (recon_proj among them). Returns (launches, rows)."""
    from animal2vec_tpu_torch.config import PretrainConfig
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.pretrain import make_pretrain_train_step, mask_tokens
    from animal2vec_tpu_torch.train.state import PretrainState

    cfg = PretrainConfig.vit_b16(recon_loss=1.0, inverse_mask=True, mask_prob_adjust=0.05)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_pretrain_model(cfg, dtype=torch.bfloat16, seed=SEED, device=dev)
    state = PretrainState.create(model, cfg)
    state.step = cfg.optimization.warmup_updates
    step_fn = make_pretrain_train_step(cfg)
    data = pretrain_batch(cfg, dev, IMAGE_BATCH, SEED + 73)
    n = cfg.model.n_blocks
    kept = IMAGE_T - mask_tokens(cfg, IMAGE_T)
    want = dict.fromkeys(_counted(), 0)
    want.update(bias_attention=2 * n, block=2 * n,
                **({"bias_single": n} if kept <= 64 else {"bias_dq": n, "bias_dkv": n}))
    reset_counts()
    with PlainSpy() as spy:
        metrics = step_fn(state, data, Rngs.from_seed(SEED, dev))
    torch.cuda.synchronize()
    got = counts()
    losses = {k: float(v) for k, v in metrics.items() if k.startswith("loss")}
    t0 = time.perf_counter()
    step_fn(state, data, Rngs.from_seed(SEED + 1, dev))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"17c ViT-B/16 pretrain b{IMAGE_BATCH} x clone 2, recon 1, inverse mask, "
          f"mask_prob_adjust 0.05: {kept} of {IMAGE_T} patches kept; losses {losses}; launches "
          f"{launch_line(got)} (expected {launch_line(want)}); plain-version calls on CUDA "
          f"tensors {spy.cuda_calls}; second step {ms:.1f} ms, peak memory {peak:.2f} GiB on "
          f"{card}")
    if not all(np.isfinite(v) for v in losses.values()) or "loss_recon" not in losses:
        raise AssertionError("17c: a non-finite loss or no recon term")
    if got != want or spy.cuda_calls:
        raise AssertionError(f"17c: launches {got} != {want}, or a plain call")
    del state, model, step_fn, data
    torch.cuda.empty_cache()
    worst = a7_grads(cfg, dev, 2, "17c ViT-B/16 recon", ["recon_proj.weight"])
    return got, {"ms": ms, "peak_gib": peak, "kept": kept, "grad_rel_max": worst}


# 17d: train_cli --config on a copy of a2v_large_pretrain.yaml, depth 1 + 2
A7_CLI = ("task.with_labels=true", "model.shared_decoder.decoder_dim=768",
          "model.shared_decoder.decoder_kernel=7", "model.shared_decoder.decoder_layers=4",
          "model.shared_decoder.projection_layers=2", "model.layer_norm_targets=true")


def phase_a7_cli(card, dev):
    """17d. train_cli --config on a copy of a2v_large_pretrain.yaml at
    a2v-large width, depth 1 + 2, on 24 synthetic 10-s clips with .npz
    labels: 2 pretraining steps with the probe (task.with_labels), a shared
    decoder and layer-normed targets; then finetune_100.yaml 1 step from
    that checkpoint with finetune.load_pretrain_weights: its head at step 0
    equals the probe bit for bit. Returns the launches."""
    from animal2vec_tpu_torch.config import load_config
    from animal2vec_tpu_torch.data.synthetic import generate
    from animal2vec_tpu_torch.recipes import RECIPES
    from animal2vec_tpu_torch.tools import train_cli
    from animal2vec_tpu_torch.train.build import init_finetune
    from animal2vec_tpu_torch.train.checkpoint import load_checkpoint_dir

    totals = dict.fromkeys(_counted(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        data = generate(os.path.join(tmp, "data"), n_clips=ENTRY_CLIPS, clip_seconds=10.0,
                        seed=SEED, label_ext="npz")
        recipe = os.path.join(tmp, "a2v_large_pretrain.yaml")
        shutil.copy(RECIPES["a2v_large_pretrain"], recipe)
        ft_args = [*CONFIG_COMMON, *CONFIG_CUT, *CONFIG_FINETUNE,
                   "finetune.load_pretrain_weights=true"]
        runs = (("pretrain", recipe, 2, [*CONFIG_COMMON, *CONFIG_CUT, *A7_CLI], []),
                ("finetune", str(RECIPES["finetune_100"]), 1, ft_args,
                 ["--pretrained", os.path.join(tmp, "pretrain")]))
        for name, path, steps, extra, more in runs:
            if name == "finetune":
                pre = load_checkpoint_dir(os.path.join(tmp, "pretrain"))["model"]
                run = load_config(path, extra + [f"task.data={data}"])
                model, _ = init_finetune(run, dev, pre)
                same = all(torch.equal(getattr(model.proj, leaf).detach().cpu(),
                                       pre[f"linear_eval_projection.{leaf}"].cpu())
                           for leaf in ("weight", "bias"))
                print(f"17d finetune head at step 0 (load_pretrain_weights): equal to the "
                      f"pretraining probe bit for bit: {same}")
                if not same:
                    raise AssertionError("17d: the finetune head is not the probe")
                del model
                torch.cuda.empty_cache()
            reset_counts()
            t0 = time.perf_counter()
            with EntryWatch() as watch, PlainSpy() as spy:
                out = train_cli.main(["--config", path, "--data", data, "--save-dir",
                                      os.path.join(tmp, name), "--max-steps", str(steps),
                                      "--device", dev.type, *more, *extra])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = counts()
            totals = {k: totals[k] + got[k] for k in totals}
            losses = [round(s["loss"], 5) for s in watch.steps]
            print(f"17d train_cli --config {os.path.basename(path)} ({name}, depth 1 + 2; "
                  f"{' '.join(extra)}): {len(watch.steps)} steps in {seconds:.2f} s, losses "
                  f"{losses}; logged {({k: round(v, 4) for k, v in (out or {}).items() if 'linear_eval' in k or 'pretrain/' in k})}; "
                  f"launches {launch_line(got)}; plain-version calls on CUDA tensors "
                  f"{spy.cuda_calls} on {card}")
            if len(watch.steps) != steps or spy.cuda_calls or out is None:
                raise AssertionError(f"17d {name}: {len(watch.steps)} steps or a plain call")
            if not all(np.isfinite(s["loss"]) for s in watch.steps):
                raise AssertionError(f"17d {name}: a non-finite loss")
            if name == "pretrain" and not out.get("train/loss_linear_eval_loss", 0) > 0:
                raise AssertionError("17d: the pretraining run has no probe loss")
            del watch
            torch.cuda.empty_cache()
    return totals


def phase_a7(card, dev):
    """17. The rest of data2vec-2 pretraining: 17a-17d. Returns (launches
    by kernel key over the phase's main-path runs, the rows)."""
    t0 = time.perf_counter()
    launches, rows = phase_a7_step(card, dev)
    rows["grad_rel_max"] = a7_grads(
        a7_cfg(), dev, 1, "17b a2v-large every option",
        ["linear_eval_projection.weight", "shared_decoder.proj_0.weight",
         "shared_decoder.proj_1.weight", "shared_decoder.blocks.0.weight"])
    got, rows["image"] = phase_a7_image(card, dev)
    launches = {k: launches[k] + got[k] for k in launches}
    got = phase_a7_cli(card, dev)
    launches = {k: launches[k] + got[k] for k in launches}
    rows["seconds"] = time.perf_counter() - t0
    print(f"17 launches over the phase's main-path runs: {launch_line(launches)}; phase "
          f"{rows['seconds']:.1f} s")
    print(json.dumps({"phase17": rows}))
    return launches, rows


# phase 18: the bench/ tuning probes (#12a-c) and bench/kernels2.py's side
# by side runs; #12a is held at the sweep's shape and at a ragged one
PROBE_ATTN_SHAPES = ((32, 16, 2048, 64, 2000), (2, 3, 333, 64, 320))


def _probe_wrappers():
    from animal2vec_tpu_torch.probes import attn_probe, kernels, pallas_mm

    return {"probe_attention": kernels.attn_v2, "probe_gemm": pallas_mm.row_gemm,
            "probe_mma": attn_probe.mma_probe}


def phase_probes(card, dev):
    """18. The probes: each kernel against its plain twin, then the sweeps,
    their launches counted. Returns (launches by kernel key, the check
    results, the sweep rows)."""
    from animal2vec_tpu_torch.probes import attn_probe, kernels, kernels2, pallas_mm

    t0 = time.perf_counter()
    print(f"18 the bench/ probes on {card}")
    checks = {"probe_attention": kernels.check(dev, PROBE_ATTN_SHAPES),
              "probe_gemm": pallas_mm.check(dev), "probe_mma": attn_probe.check(dev)}
    torch.cuda.empty_cache()
    wrappers = _probe_wrappers()
    for w in wrappers.values():
        w.launches = 0
    with PlainSpy() as spy:
        rows = {"probe_attention": kernels.sweep(dev), "probe_gemm": pallas_mm.sweep(dev),
                "probe_mma": attn_probe.sweep(dev), "kernels2": kernels2.sweep(dev)}
        torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    rows["seconds"] = time.perf_counter() - t0
    print(f"18 launches over the sweeps: {launch_line(launches)}; plain twins on a CUDA tensor "
          f"{spy.cuda_calls}; phase {rows['seconds']:.1f} s")
    if spy.cuda_calls:
        raise AssertionError("18: a plain twin ran on a CUDA tensor")
    if not all(launches.values()):
        raise AssertionError(f"18: a probe kernel was never launched: {launches}")
    print(json.dumps({"phase18": rows, "phase18_checks": checks}))
    return launches, checks, rows


# phase 19: the sharded layouts (ROADMAP A.10). Their steps run at
# a2v-large's widths with the trunk cut to A10_DEPTH blocks (prenet 2) at
# A10_BATCH rows a data rank; the split #6 at the b4 step's N with a 2-rank
# "model" group's A10_MS hidden columns; #2-#4 on 8 of the 16 heads.
A10_DEPTH, A10_BATCH, A10_MS, A10_DROP = 2, 4, 2048, 0.1
PARTIAL_TOL = (1e-3, 1e-4)  # the fc2 partial: fp32 sums of exact bf16 products, another order


def a10_block_rows(dev, row):
    """19k, the split #6 at N 8000, C 1024, Ms 2048 (col0 0 and 2048, with and
    without dropout) against the plain math and the whole calls: fc1's h on
    a rank's columns is the whole call's columns bit for bit (its drop_a
    mask their slice), the two partials summed through ln2 equal the fused
    block. Returns (max abs error of each entry, the mask checks)."""
    import torch.nn.functional as F

    from animal2vec_tpu_torch.ops.fused_mlp import (
        _fc1_math, _fp32_matmul, _ln2_math, block_fc1, block_fc2_partial, block_ln2,
        fused_block_mlp,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    n, c, m, ms = TRAIN_BATCH * 2000, 1024, 4096, A10_MS
    x, l1s, l1b, w1, w2, b1, b2, l2s, l2b, eps = block_inputs(gen, n, c, m, dev)
    errs = {"fc1": 0.0, "partial": 0.0, "ln2": 0.0}
    masks = {}
    for rate in (0.0, A10_DROP):
        seeds = (11, -22, 2**31 - 5) if rate else None
        s1 = seeds[0] if rate else None
        _, h_whole = block_fc1(x, l1s, l1b, w1, b1, eps, s1, rate)
        parts, r = [], None
        for col0 in (0, ms):
            cols = slice(col0, col0 + ms)
            w1s, b1s, w2s = w1[:, cols].contiguous(), b1[cols].contiguous(), w2[cols].contiguous()
            r, h = block_fc1(x, l1s, l1b, w1s, b1s, eps, s1, rate, 0, col0)
            r_p, h_p = _fc1_math(x, l1s, l1b, w1s, b1s, eps, s1, rate, _fp32_matmul, 0, col0)
            torch.cuda.synchronize()
            label = f"split #6 fc1 (N {n}, Ms {ms}, col0 {col0}, dropout {rate})"
            errs["fc1"] = max(errs["fc1"], check_close(f"{label} h", h, h_p, BLOCK_TOL),
                              check_close(f"{label} r", r, r_p, BLOCK_TOL))
            key = f"col0 {col0}, dropout {rate}"
            masks[key] = {"h_equal_whole_slice": bool(torch.equal(h, h_whole[:, cols])),
                          "drop_a_equal_plain": bool(torch.equal(h == 0, h_p == 0))}
            print(f"{label}: h equals the whole call's columns bit for bit "
                  f"{masks[key]['h_equal_whole_slice']}; its zeros are the plain version's "
                  f"{masks[key]['drop_a_equal_plain']}")
            part = block_fc2_partial(h, w2s)
            part_p = _fp32_matmul(h, w2s)
            torch.cuda.synchronize()
            errs["partial"] = max(errs["partial"], check_close(
                f"split #6 fc2 partial (N {n}, Ms {ms}, col0 {col0})", part, part_p,
                PARTIAL_TOL))
            parts.append(part)
        s_sum = parts[0] + parts[1]
        ln2 = (b2, r, l2s, l2b, eps, None if seeds is None else seeds[1:], rate, rate)
        xo, t = block_ln2(s_sum, *ln2)
        xo_p, t_p = _ln2_math(s_sum, *ln2)
        xo_w, t_w = fused_block_mlp(x, l1s, l1b, w1, w2, b1, b2, l2s, l2b, eps, seeds, rate,
                                    rate)
        torch.cuda.synchronize()
        label = f"split #6 ln2 (N {n}, dropout {rate})"
        errs["ln2"] = max(errs["ln2"], check_close(f"{label} x_out", xo, xo_p, BLOCK_TOL),
                          check_close(f"{label} t", t, t_p, BLOCK_TOL))
        check_close(f"{label} x_out against the fused block", xo, xo_w, BLOCK_TOL)
        check_close(f"{label} t against the fused block", t, t_w, BLOCK_TOL)
    if not all(all(v.values()) for v in masks.values()):
        raise AssertionError(f"19k: a split fc1's mask is not the whole call's slice: {masks}")
    # times at the training shape with dropout, as a tensor-parallel step runs them
    w1s, b1s, w2s = w1[:, :ms].contiguous(), b1[:ms].contiguous(), w2[:ms].contiguous()
    seeds = (11, -22, 2**31 - 5)
    r, h = block_fc1(x, l1s, l1b, w1s, b1s, eps, seeds[0], A10_DROP)
    s_sum = block_fc2_partial(h, w2s)
    w1l, w2l = w1s.t().contiguous(), w2s.t().contiguous()
    b1b = b1s.to(torch.bfloat16)
    row(f"split #6 fc1 + dropout, N {n}, Ms {ms}",
        cuda_ms(lambda: block_fc1(x, l1s, l1b, w1s, b1s, eps, seeds[0], A10_DROP)),
        cuda_ms(lambda: _fc1_math(x, l1s, l1b, w1s, b1s, eps, seeds[0], A10_DROP, _fp32_matmul),
                iters=3),
        cuda_ms(lambda: F.linear(r, w1l, b1b)),
        bound(2 * n * c * ms, 2 * n * c * 2 + 2 * c * ms + 4 * (ms + 2 * c) + 2 * n * ms))
    row(f"split #6 fc2 partial, N {n}, Ms {ms}",
        cuda_ms(lambda: block_fc2_partial(h, w2s)),
        cuda_ms(lambda: _fp32_matmul(h, w2s), iters=3),
        cuda_ms(lambda: F.linear(h, w2l)),
        bound(2 * n * ms * c, 2 * n * ms + 2 * ms * c + 4 * n * c))
    ln2 = (b2, r, l2s, l2b, eps, seeds[1:], A10_DROP, A10_DROP)
    row(f"split #6 ln2 + dropout, N {n}",
        cuda_ms(lambda: block_ln2(s_sum, *ln2)),
        cuda_ms(lambda: _ln2_math(s_sum, *ln2), iters=3), None,
        bound(12 * n * c, 4 * n * c + 2 * n * c + 4 * 3 * c + 2 * 2 * n * c))
    return errs, masks


def a10_attention_rows(dev, row):
    """19k, #2-#4 on heads 8..15 of 16 (``h0`` 8) at b4 T 2000 with dropout
    0.2: against their plain versions with the same head offset, and bit for
    bit the whole launch's heads (so their dropout masks are its slices).
    Returns (max abs error of the forward, dq and dk/dv, the equalities)."""
    import torch.nn.functional as F

    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_plain, alibi_flash_attention_packed, attention_bwd_plain,
        attention_dkv, attention_dq,
    )

    qkv, slopes, pos, mask, dout = train_attention_inputs(dev)
    b, h, t = qkv.shape[1:4]
    hs = slice(8, 16)
    drop = (ATTN_DROP, DROP_SEED)
    out_w, lse_w = alibi_flash_attention_packed(qkv, slopes, pos, mask, False, *drop,
                                                return_lse=True)
    delta_w = (dout.float() * out_w.float()).sum(-1).reshape(b * h, t)
    bwd_w = (qkv, dout, lse_w, delta_w, slopes, pos, mask, False, *drop)
    dq_w, parts_w = attention_dq(*bwd_w)
    dk_w, dv_w = attention_dkv(*bwd_w)
    sub, sl, do = qkv[:, :, hs].contiguous(), slopes[hs].contiguous(), dout[:, hs].contiguous()
    heads = dict(h0=8, hash_heads=h)
    out, lse = alibi_flash_attention_packed(sub, sl, pos, mask, False, *drop, return_lse=True,
                                            **heads)
    out_p = alibi_attention_plain(sub.float(), sl, pos, mask, False, *drop, **heads)
    delta = (do.float() * out.float()).sum(-1).reshape(b * 8, t)
    bwd = (sub, do, lse, delta, sl, pos, mask, False, *drop)
    dq, parts = attention_dq(*bwd, **heads)
    dk, dv = attention_dkv(*bwd, **heads)
    want, parts_p = attention_bwd_plain(*bwd, **heads)
    torch.cuda.synchronize()
    name = f"head-offset attention (heads 8..15 of {h}, b{b}, T {t}, dropout {ATTN_DROP})"
    errs = {"forward": check_close(f"{name} out", out, out_p, ATTN_TOL),
            "dq": check_close(f"{name} dq", dq, want[0], BWD_TOL),
            "dkv": max(check_close(f"{name} dk", dk, want[1], BWD_TOL),
                       check_close(f"{name} dv", dv, want[2], BWD_TOL))}
    check_close(f"{name} slope partials", parts, parts_p, SLOPE_PART_TOL)
    lse_rows = lse_w.reshape(b, h, t)[:, hs].reshape(b * 8, t)
    equal = {"forward": bool(torch.equal(out, out_w[:, hs]) and torch.equal(lse, lse_rows)),
             "dq": bool(torch.equal(dq, dq_w[:, hs]) and torch.equal(parts, parts_w[:, hs])),
             "dkv": bool(torch.equal(dk, dk_w[:, hs]) and torch.equal(dv, dv_w[:, hs]))}
    print(f"{name}: bit for bit the whole launch's heads 8..15 (its masks' slices): {equal}")
    if not all(equal.values()):
        raise AssertionError(f"19k: a head-offset launch differs from the whole one: {equal}")
    bounds = attention_bounds(b, 8, t, 64)
    q, k, v, bias = sdpa_args(sub, sl, t)
    row(f"head-offset attention forward + lse + dropout, b{b} H 8 of {h}",
        cuda_ms(lambda: alibi_flash_attention_packed(sub, sl, pos, mask, False, *drop,
                                                     return_lse=True, **heads)),
        cuda_ms(lambda: alibi_attention_plain(sub, sl, pos, mask, False, *drop,
                                              return_lse=True, **heads), iters=3),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                       dropout_p=ATTN_DROP)),
        bounds["forward"])
    qg, kg, vg, biasg = sdpa_args(sub, sl, t, requires_grad=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=biasg, dropout_p=ATTN_DROP)
        torch.autograd.grad(o, (qg, kg, vg), do)

    lib = cuda_ms(sdpa_fwd_bwd)
    plain = cuda_ms(lambda: attention_bwd_plain(*bwd, **heads), iters=3)
    row(f"head-offset attention dq + slope partials, b{b} H 8 of {h}",
        cuda_ms(lambda: attention_dq(*bwd, **heads)), plain, lib, bounds["dq"])
    row(f"head-offset attention dk/dv, b{b} H 8 of {h}",
        cuda_ms(lambda: attention_dkv(*bwd, **heads)), plain, lib, bounds["dkv"])
    return errs, equal


def _dryrun(out, *args):
    """tools/dryrun_multigpu.py as 2 gloo ranks on the card at a2v-large's
    widths, the trunk cut to A10_DEPTH blocks; returns its result and
    seconds."""
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "animal2vec_tpu_torch.tools.dryrun_multigpu",
                    "--ranks", "2", "--device", "cuda", "--dist-backend", "gloo",
                    "--width", "a2v-large", "--depth", str(A10_DEPTH), "--batch",
                    str(A10_BATCH), *args, "--out", out], check=True, timeout=600)
    seconds = time.perf_counter() - t0
    with open(out) as f:
        return json.load(f), seconds


def _check_steps(label, res, card):
    """Print and check a layout's finetune and pretrain steps against one rank
    (phase 14b's 2.1 lr bound on the parameters, each gradient leaf's and the
    global norm's relative gap within the dry run's GRAD_BOUND, FSDP2's
    against data parallelism on the same split, DP_LOSS_REL, equal
    checksums)."""
    for part in ("finetune", "pretrain"):
        r = res[part]
        extra = f", EMA gap {r['ema_gap']:.3e}" if "ema_gap" in r else ""
        print(f"19 {label} {part} step on {card}: gradients' relative gap {r['grad_gap']:.3e} "
              f"at worst ({r['grad_gap_leaf']}), {r['grad_gap_whole']:.3e} over all, global "
              f"norm {r['grad_norm']:.6e} against {r['ref_grad_norm']:.6e} (relative "
              f"{r['grad_norm_gap']:.2e}; bound {r['grad_bound']}); parameter gap "
              f"{r['param_gap']:.3e} (bound {r['bound']:.1e}: 2.1 lr){extra}, loss "
              f"{r['loss']:.6f} against {r['ref_loss']:.6f} (relative {r['loss_rel_gap']:.2e}, "
              f"bound {DP_LOSS_REL}), checksums equal {r['checksums_equal']}; rank 0's "
              f"launches {launch_line(r['launches'])}; second step {r['step_ms']:.1f} ms "
              f"against {r['one_rank_step_ms']:.1f} ms on one rank (host clock, synchronized); "
              f"peak memory per rank {', '.join(f'{v:.0f}' for v in r['peak_mb'])} MiB against "
              f"{r['one_rank_peak_mb']:.0f} MiB on one rank")
        if not (r["checksums_equal"] and r["param_gap"] <= r["bound"]
                and r.get("ema_gap", 0.0) <= r["bound"] and r["loss_rel_gap"] <= DP_LOSS_REL
                and r["grad_gap"] <= r["grad_bound"] and r["grad_norm_gap"] <= r["grad_bound"]):
            raise AssertionError(f"19 {label} {part}: {r}")


def phase_a10(card, dev):
    """19. The sharded layouts (ROADMAP A.10): the split #6 and head-offset
    #2-#4 against their plain versions (19k), then on the card, each against
    one rank on the same global batch through tools/dryrun_multigpu.py at
    a2v-large's widths (trunk A10_DEPTH, prenet 2, b4 a data rank): tensor
    parallelism as 2 gloo ranks (model 2; the masks of each rank against the
    whole calls), the GPipe trunk as 2 gloo ranks (stage 2, the boundary
    through host tensors) and FSDP2 over 2 gloo ranks, in one launch.
    Returns (the tensor-parallel step's rank-0 launches, errors, rows)."""
    t0 = time.perf_counter()
    print(f"19 the sharded layouts (ROADMAP A.10) on {card}")
    rows = {}

    def row(key, ms, plain_ms, library_ms, bnd):
        rows[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1]}
        print(f"  {key}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]})")

    block_errs, block_masks = a10_block_rows(dev, row)
    attn_errs, attn_equal = a10_attention_rows(dev, row)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        layouts = ["model=2", "stage=2", "fsdp"]
        runs, runs_s = _dryrun(os.path.join(tmp, "layouts.json"),
                               *[a for spec in layouts for a in ("--layout", spec)],
                               "--parts", "finetune,pretrain,tp_masks")
        tp, pp, fsdp = runs["model=2"], runs["stage=2"], runs["fsdp"]
        print(f"19 {', '.join(layouts)}: one launch of 2 gloo ranks, {runs_s:.1f} s")
        _check_steps("tensor parallelism (2 gloo ranks, model 2)", tp, card)
        masks = tp["tp_masks"]
        print(f"19 tensor-parallel masks: each rank's attention on its heads and fc1 on its "
              f"columns equal the whole calls' {masks['ranks_equal']} (attention, fc1), fc1's "
              f"drop_a zeros {masks['fc1_masks_equal']}")
        if not all(all(v) for v in masks["ranks_equal"]):
            raise AssertionError(f"19 tensor-parallel masks: {masks}")
        for part in ("finetune", "pretrain"):
            got = tp[part]["launches"]
            if not all(got[k] for k in ("alibi_train", "alibi_dq", "alibi_dkv", "block_fc1",
                                         "block_fc2_partial", "block_ln2")) or got["fused_block"]:
                raise AssertionError(f"19 tensor parallelism {part}: launches {got}")
        _check_steps("pipeline (2 gloo ranks, stage 2, host transport)", pp, card)
        _check_steps("FSDP2 (2 gloo ranks)", fsdp, card)
        results = {"tp": tp, "pp": pp, "fsdp": fsdp, "seconds": {"layouts": runs_s}}
    results["phase_seconds"] = time.perf_counter() - t0
    print(json.dumps({"phase19": {"rows": rows, "block_masks": block_masks,
                                  "attention_equal": attn_equal, **results}}))
    print(f"19 phase {results['phase_seconds']:.1f} s")
    launches = {"tp_finetune": tp["finetune"]["launches"],
                "tp_pretrain": tp["pretrain"]["launches"]}
    return launches, {**block_errs, **attn_errs}, rows


def a10_entries(launches, errs, rows):
    """The kernels line's entries of the split #6 and the head-offset
    launches: launches of rank 0's tensor-parallel finetune and pretrain
    steps (phase 19), errors and times of 19k."""
    pa = "animal2vec_tpu/ops/pallas_attention.py"
    fb = "animal2vec_tpu/ops/fused_mlp.py:175 (_kernel_bf16_block, split at fc2)"
    n = TRAIN_BATCH * 2000

    def entry(name, source, replaces, key, err, row_key):
        return {"name": name, "route": "cuda", "source": f"animal2vec_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(launches[p][key] for p in ("tp_finetune", "tp_pretrain")),
                "launches_tp_finetune_rank0": launches["tp_finetune"][key],
                "launches_tp_pretrain_rank0": launches["tp_pretrain"][key],
                "max_abs_err": err, **rows[row_key]}

    return [
        entry("block_fc1", "fused_block.cu", fb, "block_fc1", errs["fc1"],
              f"split #6 fc1 + dropout, N {n}, Ms {A10_MS}"),
        entry("block_fc2_partial", "fused_block.cu", fb, "block_fc2_partial", errs["partial"],
              f"split #6 fc2 partial, N {n}, Ms {A10_MS}"),
        entry("block_ln2", "fused_block.cu", fb, "block_ln2", errs["ln2"],
              f"split #6 ln2 + dropout, N {n}"),
        entry("alibi_flash_attention_head_offset", "alibi_attention_fwd.cu",
              f"{pa}:113 (bh_id = b * H + h0 + h, :82)", "alibi_train", errs["forward"],
              f"head-offset attention forward + lse + dropout, b{TRAIN_BATCH} H 8 of 16"),
        entry("alibi_attention_dq_head_offset", "alibi_attention_bwd.cu", f"{pa}:330",
              "alibi_dq", errs["dq"],
              f"head-offset attention dq + slope partials, b{TRAIN_BATCH} H 8 of 16"),
        entry("alibi_attention_dkv_head_offset", "alibi_attention_bwd.cu", f"{pa}:390",
              "alibi_dkv", errs["dkv"],
              f"head-offset attention dk/dv, b{TRAIN_BATCH} H 8 of 16"),
    ]


def probe_entries(launches, checks, rows):
    """The kernels line's entries of #12a-c: the times of one
    representative row each (#12a full at the 64-key tile, #12b #6's fc1 at
    the core's 128-row tile, #12c QK^T at D 64 by wgmma) and every sweep
    row under "sweep"."""
    attn = rows["probe_attention"]
    full = attn["attn_v2 full, key tile 64"]
    soft = [checks["probe_attention"][v][bk]["max_abs_err"] for v in ("mm_only", "exp_bf16",
                                                                       "full") for bk in (64, 128)]
    gemm = rows["probe_gemm"]["#6 fc1 b32, block_m 128"]
    mma = rows["probe_mma"]["QKt D64, wgmma"]

    def times(row, plain_ms, library_ms):
        return {"ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": plain_ms,
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": library_ms}

    return [
        {"name": "attn_v2", "route": "cuda",
         "source": "animal2vec_tpu_torch/csrc/probe_attention.cu",
         "replaces": "bench/kernels.py:27 (_kernel_v2; attn_v2 :96, pallas_call :103)",
         "launches": launches["probe_attention"], "max_abs_err": max(soft),
         "max_abs_err_no_softmax": max(checks["probe_attention"]["no_softmax"][bk]["max_abs_err"]
                                       for bk in (64, 128)),
         **times(full, checks["probe_attention"]["full"][64]["plain_ms"],
                 attn["SDPA, the bias as a float mask"]["ms"]),
         "sweep": attn},
        {"name": "row_gemm", "route": "cuda", "source": "animal2vec_tpu_torch/csrc/probe_gemm.cu",
         "headers": ["animal2vec_tpu_torch/csrc/bf16_gemm_sm90.cuh"],
         "replaces": "bench/pallas_mm.py:18 (pallas_mm; pallas_call :28)",
         "launches": launches["probe_gemm"],
         "max_abs_err": max(c["max_abs_err"] for c in checks["probe_gemm"].values()),
         **times(gemm, checks["probe_gemm"]["#6 fc1 b32"]["plain_ms"], gemm["library_ms"]),
         "sweep": rows["probe_gemm"]},
        {"name": "mma_probe", "route": "cuda", "source": "animal2vec_tpu_torch/csrc/probe_mma.cu",
         "replaces": "bench/attn_probe.py:25 (probe; kernel :29, pallas_call :49)",
         "launches": launches["probe_mma"],
         "max_abs_err": max(c["max_abs_err"] for c in checks["probe_mma"].values()),
         **times(mma, checks["probe_mma"]["QKt D64"]["plain_ms"], mma["library_ms"]),
         "sweep": rows["probe_mma"]},
    ]


# phase 20: every trunk width the JAX package runs (ROADMAP A.11). W: a2v's
# finetune_100 model at the Whisper large-v3 encoder's widths (openai/whisper
# model.py ModelDimensions, large-v3: n_audio_state 1280, n_audio_head 20; MLP
# 4 x 1280), 8 prenet + 16 trunk post-LN ALiBi blocks, where every width is a
# multiple of 128 and the kernels run past C 1024 (the LayerNorm's wide
# instance). T: DeiT-Ti's widths (facebookresearch/deit models.py
# deit_tiny_patch16_224: C 192, 3 heads of 64, MLP 768), every one off 128:
# the MLP sub-blocks and the int8 products take JAX's composed route there,
# the attention its kernels (#1-#5 on the audio model, #11 on the image one).
WIDTH_DIMS = {"W": dict(embed_dim=1280, num_heads=20), "T": dict(embed_dim=192, num_heads=3)}
WIDE_C, WIDE_M = 1280, 5120


def width_launches(name, mode, n_blocks):
    """The launches of one forward of model ``name`` in a mode: W's as
    a2v-large's; T's attention kernels only (#1, or #5 with its
    quantization pass in int8_attn), its MLPs and int8 products composed."""
    if name == "W":
        return forward_launches(mode, n_blocks)
    want = dict.fromkeys(_counted(), 0)
    if mode == "int8_attn":
        want.update(int8_attention=n_blocks, int8_quant=n_blocks)
    else:
        want.update(serve_attention=n_blocks)
    return want


def width_kernel_rows(dev, row):
    """20k. #6, its split #6s and #7 at N 64 000 (b32 x T 2000), C 1280, M
    5120, #6 also at N 8000 with its three dropout sites, each held against
    its plain version; #1 at H 20 and #10 at K 1280 (W's b32 shapes). Times
    by CUDA events and device time beside the bound and the library call:
    F.linear x 2 for #6 and #7 (the two GEMMs alone with their biases), SDPA
    for #1, torch._int_mm for #10. Returns the errors."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_plain, alibi_flash_attention_btc,
    )
    from animal2vec_tpu_torch.ops.fused_mlp import (
        block_fc1, block_fc2_partial, block_ln2, fused_block_int8, fused_block_int8_plain,
        fused_block_mlp, fused_block_plain,
    )
    from animal2vec_tpu_torch.ops.int8_mm import (
        int8_dense, int8_dense_plain, quantize_rows, quantize_weight,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 200)
    n, c, m = 32 * 2000, WIDE_C, WIDE_M
    errs = {}

    def linear2(args, rows_n):
        x, w1, w2, b1, b2 = args[0], args[3], args[4], args[5], args[6]
        w1l, w2l = w1.t().contiguous(), w2.t().contiguous()
        hid = torch.randn((rows_n, m), generator=gen, device=dev).to(torch.bfloat16)
        return lambda: (F.linear(x, w1l, b1.to(x.dtype)), F.linear(hid, w2l, b2.to(x.dtype)))

    def times(key, call, plain, lib, bnd, plain_iters=2):
        row(key, cuda_ms(call), cuda_ms(plain, iters=plain_iters, warmup=1), cuda_ms(lib), bnd)
        split = {"device_ms": device_ms(call, ""), "library_device_ms": device_ms(lib, "")}
        rows[key].update(split)
        print(f"    device time: kernel {ms_text(split['device_ms'])}, library "
              f"{ms_text(split['library_device_ms'])}")

    rows = row.rows
    with torch.inference_mode():
        args = block_inputs(gen, n, c, m, dev)
        key = f"fused block C {c}, b32 serving"
        times(key, lambda: fused_block_mlp(*args), lambda: fused_block_plain(*args),
              linear2(args, n), block_bound(n, c, m))
        (xo, t), (xo_p, t_p) = fused_block_mlp(*args), fused_block_plain(*args)
        torch.cuda.synchronize()
        errs["block"] = max(check_close(f"20k {key} tap t", t, t_p, BLOCK_TOL),
                            check_close(f"20k {key} x_out", xo, xo_p, BLOCK_TOL))
        del xo, t, xo_p, t_p
        # the split (one rank: Ms = M), drop_a, drop_b and drop_c at 0.1
        drop = (11, -22, 2**31 - 5)
        x, l1s, l1b, w1, w2, b1, b2, l2s, l2b, eps = args

        def split():
            r, h = block_fc1(x, l1s, l1b, w1, b1, eps, drop[0], 0.1)
            return block_ln2(block_fc2_partial(h, w2), b2, r, l2s, l2b, eps, drop[1:], 0.1, 0.1)

        key = f"split #6 (fc1, fc2 partial, ln2) C {c}, N {n}, dropout 0.1"
        row(key, cuda_ms(split), cuda_ms(lambda: fused_block_plain(*args, drop, 0.1, 0.1),
                                         iters=1, warmup=0), None, block_bound(n, c, m))
        (xo, t), (xo_p, t_p) = split(), fused_block_plain(*args, drop, 0.1, 0.1)
        torch.cuda.synchronize()
        errs["split"] = max(check_close(f"20k {key} tap t", t, t_p, BLOCK_TOL),
                            check_close(f"20k {key} x_out", xo, xo_p, BLOCK_TOL))
        del xo, t, xo_p, t_p, args
        torch.cuda.empty_cache()
        n8 = TRAIN_BATCH * 2000
        args = block_inputs(gen, n8, c, m, dev)
        key = f"fused block + dropout C {c}, N {n8} training"
        times(key, lambda: fused_block_mlp(*args, drop, 0.1, 0.1),
              lambda: fused_block_plain(*args, drop, 0.1, 0.1), linear2(args, n8),
              block_bound(n8, c, m), plain_iters=3)
        (xo, t), (xo_p, t_p) = (fused_block_mlp(*args, drop, 0.1, 0.1),
                                fused_block_plain(*args, drop, 0.1, 0.1))
        torch.cuda.synchronize()
        errs["block"] = max(errs["block"],
                            check_close(f"20k {key} tap t", t, t_p, BLOCK_TOL),
                            check_close(f"20k {key} x_out", xo, xo_p, BLOCK_TOL))
        del xo, t, xo_p, t_p
        args8 = int8_block_inputs(gen, n, dev, c, m)
        key = f"int8 fused block C {c}, b32 serving"
        times(key, lambda: fused_block_int8(*args8), lambda: fused_block_int8_plain(*args8),
              linear2(block_inputs(gen, n, c, m, dev), n), int8_block_bound(n, c, m))
        errs["int8_block"] = check_int8_block(f"20k {key}", args8)
        del args8
        torch.cuda.empty_cache()
        # #1 at W's 20 heads, the (B, T, 3C) projection read in place
        qkv, slopes = attention_inputs(gen, 32, 20, 2000, dev)
        pos = torch.arange(2000, dtype=torch.int32, device=dev)[None]
        qkv_btc = qkv.permute(1, 3, 0, 2, 4).reshape(32, 2000, 3 * c)
        q, k, v, bias = sdpa_args(qkv, slopes, 2000)
        key = "attention forward H 20, b32 serving"
        times(key, lambda: alibi_flash_attention_btc(qkv_btc, 20, slopes, pos),
              lambda: alibi_attention_plain(qkv, slopes, pos, None, False),
              lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
              attention_bounds(32, 20, 2000, 64)["serve"], plain_iters=1)
        del q, k, v, bias
        got = alibi_flash_attention_btc(qkv_btc[:4], 20, slopes, pos)
        want = alibi_attention_plain(qkv[:, :4].float(), slopes, pos, None, False)
        torch.cuda.synchronize()
        errs["attention"] = check_close("20k attention H 20, b4 of the b32 grid",
                                        got.reshape(4, 2000, 20, 64).transpose(1, 2), want,
                                        ATTN_TOL)
        del qkv, qkv_btc, got, want
        torch.cuda.empty_cache()
        # #10 at K 1280: W's qkv (-> 3840) and out (-> 1280) projections
        xd = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
        x_q, _ = quantize_rows(xd)
        errs["dense"] = 0.0
        for mo, what in ((3 * c, "qkv"), (c, "out")):
            w = torch.randn((mo, c), generator=gen, device=dev) * (2.0 / (c + mo)) ** 0.5
            w_q, w_s = quantize_weight(w.to(torch.bfloat16))
            key = f"int8 dense {what} projection K {c}, b32 serving"
            times(key, lambda: int8_dense(xd, w_q, w_s), lambda: int8_dense_plain(xd, w_q, w_s),
                  lambda: torch._int_mm(x_q, w_q.t()), int8_dense_bound(n, c, mo))
            got, want = int8_dense(xd, w_q, w_s), int8_dense_plain(xd, w_q, w_s)
            torch.cuda.synchronize()
            off = int((got != want).sum())
            print(f"20k #10 {what} K {c} -> {mo}: {off} of {got.numel()} elements differ from "
                  f"the plain version")
            errs["dense"] = max(errs["dense"], check_close(f"20k #10 {what} K {c}", got, want,
                                                           INT8_DENSE_TOL))
        del xd, x_q, got, want
        torch.cuda.empty_cache()
    return errs


def width_serving(name, card, dev):
    """20a/20b. Model ``name`` (24 blocks, seeded weights, serving cast) in
    bf16, int8 and int8_attn (``serve_checked``). Returns (launches,
    rows)."""
    from animal2vec_tpu_torch.config import FinetuneConfig

    cfg = dataclasses.replace(FinetuneConfig(), **WIDTH_DIMS[name])
    modes = ("bf16",) + MODES
    return serve_checked(f"20 {name} (C {cfg.embed_dim}, H {cfg.num_heads})", cfg, card, dev,
                         modes, modes, lambda mode: width_launches(name, mode, cfg.n_blocks))


def serve_checked(label, cfg, card, dev, modes, timed, want_of):
    """The finetune model ``cfg`` (seeded weights, serving cast) in each of
    ``modes``: the b2 forward through the kernels (launches ``want_of(mode)``
    asserted, no plain version on a CUDA tensor) against the plain path
    (MODEL_TOL max abs in bf16, INT8_MODEL_REL relative in the int8 modes,
    and INT8_VS_BF16_REL from the bf16 model); then, in the ``timed``
    modes, one timed b32 forward after a warm-up, clips/s and its launches
    asserted. Returns (launches, rows)."""
    model = build_model(cfg, dev)
    src = torch.from_numpy(np.random.default_rng(SEED + 71).normal(
        size=(2, WAV_LEN)).astype(np.float32)).to(dev)
    b32 = torch.from_numpy(np.random.default_rng(SEED + 2).normal(
        size=(32, WAV_LEN)).astype(np.float32)).to(dev)
    total, rows, bf16_logits = dict.fromkeys(_counted(), 0), {}, None
    for mode in modes:
        mode_label = f"{label} {mode}"
        served = model if mode == "bf16" else int8_model(model, cfg, mode, dev)
        want = want_of(mode)
        with torch.inference_mode():
            reset_counts()
            with PlainSpy() as spy:
                got = served(src)["encoder_out"]
            launched = counts()
            with PlainOps():
                plain = served(src)["encoder_out"]
            torch.cuda.synchronize()
        err, rel = (got.float() - plain.float()).abs().max().item(), rel_norm(got, plain)
        line = (f"{mode_label} b2: logits {tuple(got.shape)}, kernel vs plain path max abs "
                f"{err:.3e}, relative norm {rel:.3e}")
        if mode == "bf16":
            bf16_logits = got
            print(f"{line} (tolerance {MODEL_TOL} max abs)")
            ok = err <= MODEL_TOL
        else:
            rel_bf16 = rel_norm(got, bf16_logits)
            print(f"{line} (tolerance {INT8_MODEL_REL}); against the bf16 model {rel_bf16:.3e} "
                  f"(bound {INT8_VS_BF16_REL})")
            ok = rel <= INT8_MODEL_REL and rel_bf16 <= INT8_VS_BF16_REL
        print(f"{mode_label} launches per b2 forward: {launch_line(launched)} (expected "
              f"{launch_line(want)}); plain-version calls on CUDA tensors {spy.cuda_calls}")
        if tuple(got.shape) != (2, WAV_LEN // 40, len(cfg.labels)) or \
                not torch.isfinite(got).all() or not ok:
            raise AssertionError(f"{mode_label}: logits disagree with the plain path")
        if launched != want or spy.cuda_calls:
            raise AssertionError(f"{mode_label}: launches {launched} != {want}, or a plain call")
        total = {k: total[k] + launched[k] for k in total}
        rows[mode] = {"max_abs_plain": err, "rel_plain": rel}
        if mode in timed:
            with torch.inference_mode():
                served(b32)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.perf_counter()
                served(b32)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                launched = counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"{mode_label} b32: {32 / dt:.2f} 10-s clips/s ({dt * 1e3:.1f} ms per batch), "
                  f"peak memory {peak:.2f} GiB on {card}; launches {launch_line(launched)}")
            if launched != want:
                raise AssertionError(f"{mode_label}: b32 launches {launched} != {want}")
            total = {k: total[k] + launched[k] for k in total}
            rows[mode].update(b32_ms=dt * 1e3, clips_per_s=32 / dt, peak_gib=peak)
        if served is not model:
            del served
        del got, plain
        torch.cuda.empty_cache()
    del model, b32, bf16_logits
    torch.cuda.empty_cache()
    return total, rows


def width_image(card, dev):
    """20c. T's image model: the ViT-B/16 image defaults (4 prenet + 8
    trunk blocks, 196 patches, the 2-D ALiBi bias) at DeiT-Ti's widths,
    pre-LN as vit_b16 is, b64 in bf16 and int8: the forward through the
    kernels (#11 once a block, nothing else) against the plain path
    (IMAGE_REL, IMAGE_INT8_REL and INT8_VS_BF16_REL), then one timed
    forward after a warm-up. Returns (launches, rows)."""
    from animal2vec_tpu_torch.config import ImageConfig
    from animal2vec_tpu_torch.models.finetune import build_image_model
    from animal2vec_tpu_torch.weights import serving_cast

    cfg = dataclasses.replace(ImageConfig(), use_alibi_encoder=True, layer_norm_first=True,
                              patch_embed_dim=192, **WIDTH_DIMS["T"])
    base = build_image_model(cfg, dtype=torch.bfloat16, seed=SEED, device=dev)
    base.load_state_dict(serving_cast(base.state_dict()), strict=True, assign=True)
    imgs = torch.from_numpy(np.random.default_rng(SEED + 72).normal(
        size=(IMAGE_BATCH, 224, 224, 3)).astype(np.float32)).to(dev)
    total, rows, x_bf16 = dict.fromkeys(_counted(), 0), {}, None
    want = dict.fromkeys(_counted(), 0)
    want["bias_attention"] = cfg.n_blocks
    for mode in ("bf16", "int8"):
        label = f"20c T image (C 192, H 3, pre-LN) {mode}"
        model = base if mode == "bf16" else int8_model(base, cfg, mode, dev)
        with torch.inference_mode():
            reset_counts()
            with PlainSpy() as spy:
                x = model.extract_features(imgs, "IMAGE")["x"]
            launched = counts()
            with PlainOps():
                x_p = model.extract_features(imgs, "IMAGE")["x"]
            model.extract_features(imgs, "IMAGE")
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            model.extract_features(imgs, "IMAGE")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            timed = counts()
        print(f"{label} launches per forward: {launch_line(launched)} (expected "
              f"{launch_line(want)}); plain-version calls on CUDA tensors {spy.cuda_calls}")
        if launched != want or timed != want or spy.cuda_calls:
            raise AssertionError(f"{label}: launches {launched} / {timed} != {want}")
        if tuple(x.shape) != (IMAGE_BATCH, IMAGE_T, 192):
            raise AssertionError(f"{label}: features of shape {tuple(x.shape)}")
        rel = check_rel(f"{label} features x, kernel vs plain path", x, x_p,
                        IMAGE_REL if mode == "bf16" else IMAGE_INT8_REL)
        if mode == "bf16":
            x_bf16 = x
        else:
            check_rel(f"{label} features x against the bf16 model's", x, x_bf16,
                      INT8_VS_BF16_REL)
        print(f"{label} b{IMAGE_BATCH}: {IMAGE_BATCH / dt:.1f} images/s ({dt * 1e3:.2f} ms per "
              f"forward) on {card}")
        total = {k: total[k] + 2 * launched[k] for k in total}
        rows[mode] = {"b64_ms": dt * 1e3, "images_per_s": IMAGE_BATCH / dt, "rel_plain": rel}
        del model, x_p
    del base, x_bf16
    torch.cuda.empty_cache()
    return total, rows


def phase_widths(card, dev, lib_path):
    """20. Every trunk width the JAX package runs (ROADMAP A.11): 20k the
    kernels at W's widths; 20a W served in the three modes; 20b T served in
    the three modes (no launch of #6-#10: its MLPs and int8 products are
    JAX's composed route); 20c T's image model; 20d W's and T's b4
    finetune_100 steps (launches, ms per step, peak memory) and W's b4
    gradients against the plain path. ``lib_path``: the built kernels'
    library, beside whose build.log the wide LayerNorm's registers and
    spills are read. Returns (launches by kernel key, errors, rows)."""
    from animal2vec_tpu_torch.config import FinetuneConfig

    t0 = time.perf_counter()
    print(f"20 every trunk width (ROADMAP A.11) on {card}")
    rows = {}

    def row(key, ms, plain_ms, library_ms, bnd):
        rows[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1]}
        print(f"  20k {key}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]})")

    row.rows = rows
    for line in ptxas_summary((lib_path.parent / "build.log").read_text()):
        if "ln_rows_wide" in line:
            print("  20k ptxas:", line)
    errs = width_kernel_rows(dev, row)
    launches = dict.fromkeys(_counted(), 0)
    serving = {}
    for name in ("W", "T"):
        got, serving[name] = width_serving(name, card, dev)
        launches = {k: launches[k] + got[k] for k in launches}
    got, image_rows = width_image(card, dev)
    launches = {k: launches[k] + got[k] for k in launches}
    for name in ("W", "T"):
        cfg = dataclasses.replace(FinetuneConfig(), **WIDTH_DIMS[name])
        print(f"20d {name} (C {cfg.embed_dim}, H {cfg.num_heads}) b{TRAIN_BATCH} finetune_100 "
              f"steps")
        got = phase_train(cfg, card, dev, fused_block=name == "W")
        for k, v in zip(("attention", "dq", "dkv", "block"), got):
            launches[k] += v
        if name == "W":
            phase_train_grads(cfg, dev, batch=TRAIN_BATCH)
    seconds = time.perf_counter() - t0
    print(json.dumps({"phase20": {"rows": rows, "serving": serving, "image": image_rows,
                                  "launches": launches, "seconds": seconds}}))
    print(f"20 phase {seconds:.1f} s")
    return launches, errs, rows


# phase 21: the attention kernels' head dims (ROADMAP A.11)
HEAD_DIMS = (32, 80, 96, 120, 128, 36)  # the tiles' edges, XLS-R's 80 and 120, one off 8
HEAD_DIMS_TIMED = (80, 128)
# published encoders whose heads are not 64 wide, at their widths: wav2vec2
# XLS-R 1B (facebook/wav2vec2-xls-r-1b: hidden 1280, 16 heads, FFN 5120) on
# finetune_100.yaml's a2v model (8 prenet + 16 trunk blocks) and 2B
# (facebook/wav2vec2-xls-r-2b: hidden 1920, 16 heads, FFN 7680) on 4 + 8 of
# them (its depth cut for the script's time), a2v-large itself at 8 heads,
# and ViT-H/14 (hidden 1280, 16 heads, MLP 5120, patch 14 at 224: 256
# patches) on the ViT-B/16 image cell's 4 + 8 blocks
HEAD_DIM_AUDIO = {"XLS-R 1B": dict(embed_dim=1280, num_heads=16),
                  "XLS-R 2B": dict(embed_dim=1920, num_heads=16, prenet_depth=4, depth=8,
                                   average_top_k_layers=8),
                  "a2v-large H 8": dict(num_heads=8)}
VIT_H14 = dict(input_size=224, patch_size=14, patch_embed_dim=1280, embed_dim=1280,
               num_heads=16, use_alibi_encoder=True)
# the kernel keys of the head-dim rows and errors
HEAD_DIM_KEYS = ("serve_attention", "attention", "dq", "dkv", "int8_attention", "int8_quant",
                 "bias_attention", "bias_single", "bias_dq", "bias_dkv")


def head_dim_kernels(dev, row):
    """21k. Each of #1-#5, #5q, #11 and #11b at the head dims HEAD_DIMS
    against its plain version on the same bf16 inputs, at the tolerances
    of the D 64 checks: #2 with lse and dropout 0.2, #3 and #4 at b4 H 16
    T 2000 with row 1 padded; #1, #5q (bit for bit) and #5 at b32 H 16 T
    2000 on the thirds of one projection; #11 with and without lse at b64
    T 196 with the 2-D ALiBi bias and with none, and at b128 T 59 with a
    keep-set bias, #11b's dq + dbias and dk/dv at T 196 and its single
    launch at T 59. At HEAD_DIMS_TIMED each kernel is timed (``row``).
    Returns the largest error of each kernel key."""
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_plain, alibi_flash_attention_serve,
    )
    from animal2vec_tpu_torch.ops.bias_attention import (
        SINGLE_T, bias_attention_bwd_plain, bias_attention_bwd_single, bias_attention_dkv,
        bias_attention_dq, bias_attention_forward, bias_attention_plain,
    )

    errs = dict.fromkeys(HEAD_DIM_KEYS, 0.0)

    def err(key, e):
        errs[key] = max(errs[key], e)

    rng = np.random.default_rng(SEED + 21)
    h = 16
    for d in HEAD_DIMS:
        gen = torch.Generator(device=dev).manual_seed(SEED + 2100 + d)
        tag = f"21k D {d}"
        b, t = TRAIN_BATCH, 2000
        qkv, slopes = attention_inputs(gen, b, h, t, dev, d)
        pos = torch.arange(t, dtype=torch.int32, device=dev)[None]
        mask = torch.zeros((b, t), dtype=torch.bool, device=dev)
        mask[1, -300:] = True
        dout = torch.randn((b, h, t, d), generator=gen, device=dev).to(torch.bfloat16)
        for key, e in zip(("attention", "dq", "dkv"), check_attention_train(
                f"{tag} attention training (b{b}, T {t}, dropout {ATTN_DROP}, row 1 padded)",
                qkv, slopes, pos, mask, dout, (ATTN_DROP, DROP_SEED), extras=False)):
            err(key, e)
        if d in HEAD_DIMS_TIMED:
            head_dim_train_rows(row, d, qkv, slopes, pos, mask, dout)
        del qkv, dout
        q, k, v, slopes = int8_attention_inputs(gen, 32, h, t, dev, d)
        with torch.inference_mode():
            got = alibi_flash_attention_serve(q, k, v, slopes, pos).transpose(1, 2)
            want = alibi_attention_plain(torch.stack((q, k, v)).transpose(2, 3).float(), slopes,
                                         pos)
            torch.cuda.synchronize()
            err("serve_attention", check_close(f"{tag} attention b32 serving, q, k, v read in "
                                               "place", got, want, ATTN_TOL))
            del got, want
            torch.cuda.empty_cache()
            err("int8_attention", check_int8_attention(f"{tag} b32 T {t}", q, k, v, slopes, pos))
            if d in HEAD_DIMS_TIMED:
                head_dim_serve_rows(row, d, q, k, v, slopes, pos)
        del q, k, v
        torch.cuda.empty_cache()
        cases = ((IMAGE_BATCH, IMAGE_T, image_bias(h, IMAGE_T, dev), "2-D ALiBi"),
                 (IMAGE_BATCH, IMAGE_T, None, "no bias"),
                 (2 * IMAGE_BATCH, STUDENT_T,
                  keep_set_bias(rng, 2 * IMAGE_BATCH, h, STUDENT_T, dev), "keep-set bias"))
        for b, t, bias, label in cases:
            name = f"{tag} bias attention b{b} T {t} {label}"
            q, k, v = bias_attention_inputs(gen, b, h, t, dev, d)
            out = bias_attention_forward(q, k, v, bias)
            out_p, lse_p = bias_attention_plain(q.float(), k.float(), v.float(), bias,
                                                return_lse=True)
            out_l, lse = bias_attention_forward(q, k, v, bias, with_lse=True)
            torch.cuda.synchronize()
            err("bias_attention", max(check_close(f"{name} out", out, out_p, ATTN_TOL),
                                      check_close(f"{name} out with lse", out_l, out_p,
                                                  ATTN_TOL)))
            check_close(f"{name} lse", lse, lse_p, LSE_TOL)
            dout = torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
            delta = (dout.float() * out_l.float()).sum(-1).transpose(1, 2).reshape(b * h, t)
            args = (q, k, v, dout, lse, delta, bias, None)
            want = bias_attention_bwd_plain(*args)
            if t <= SINGLE_T:
                got, keys = bias_attention_bwd_single(*args), ("bias_single",) * 4
            else:
                (dq, dbias), (dk, dv) = bias_attention_dq(*args), bias_attention_dkv(*args)
                got, keys = (dq, dk, dv, dbias), ("bias_dq", "bias_dkv", "bias_dkv", "bias_dq")
            torch.cuda.synchronize()
            for i, what in enumerate(("dq", "dk", "dv")):
                err(keys[i], check_close_flips(f"{name} {what}", got[i], want[i], BWD_TOL))
            check_heads(name, ("dq", "dk", "dv"), [x.transpose(1, 2) for x in got[:3]],
                        [x.transpose(1, 2) for x in want[:3]], REL_HEAD, ulps=2)
            if bias is not None:
                err(keys[3], check_close(f"{name} dbias", got[3], want[3], DBIAS_TOL))
            if d in HEAD_DIMS_TIMED and label != "no bias":
                head_dim_bias_rows(row, d, args, label)
            del q, k, v, out, out_p, out_l, lse, lse_p, dout, delta, args, want, got
        torch.cuda.empty_cache()
    return errs


def _sdpa_views(q, k, v, slopes, t):
    """(B, H, T, D) contiguous copies of (B, T, H, D) q, k, v and the ALiBi
    bias as a (1, H, T, T) float mask, for torch's SDPA."""
    qkv = torch.stack([x.transpose(1, 2) for x in (q, k, v)])
    return sdpa_args(qkv, slopes, t)


def head_dim_serve_rows(row, d, q, k, v, slopes, pos):
    """21k's b32 serving rows at head dim ``d``: #1 reading the projection's
    thirds in place, #5 with its quantization pass, and #5q alone, beside
    their plain versions, SDPA with the float ALiBi mask at the same D, and
    their bounds at the true D."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_int8_plain, alibi_attention_plain, alibi_flash_attention_int8,
        alibi_flash_attention_serve, int8_spans, quantize_qkv_int8_pass,
        quantize_qkv_int8_pass_plain,
    )

    b, t, h, _ = q.shape
    qs, ks, vs, bias = _sdpa_views(q, k, v, slopes, t)
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias)  # noqa: E731
    lib = cuda_ms(sdpa)
    packed = torch.stack((q, k, v)).transpose(2, 3)
    serve = lambda: alibi_flash_attention_serve(q, k, v, slopes, pos)  # noqa: E731
    int8 = lambda: alibi_flash_attention_int8(q, k, v, slopes, pos)  # noqa: E731
    t_pad = int8_spans(t)[1]
    quant = lambda: quantize_qkv_int8_pass(q, k, v, t_pad)  # noqa: E731
    flops = 4 * b * h * t * t * d
    for key, fn, plain, library, bnd, kernel, peak in (
            ("serve_attention", serve, lambda: alibi_attention_plain(packed, slopes, pos), lib,
             attention_bounds(b, h, t, d)["serve"], "alibi_fwd_kernel", PEAK_BF16_FLOPS),
            ("int8_attention", int8, lambda: alibi_attention_int8_plain(q, k, v, slopes, pos),
             lib, int8_attention_bound(b, h, t, d), "alibi_int8_kernel", PEAK_INT8_OPS),
            ("int8_quant", quant, lambda: quantize_qkv_int8_pass_plain(q, k, v, t_pad), None,
             int8_qkv_pass_bound(b, h, t, t_pad, d), "quantize_", None)):
        dev_ms = device_ms(fn, kernel)
        row(key, d, f"b{b} H {h} T {t} serving", cuda_ms(fn), dev_ms,
            cuda_ms(plain, iters=1, warmup=1), library, bnd,
            None if peak is None else per_ms(flops, dev_ms))
    del qs, ks, vs, bias, packed


def head_dim_train_rows(row, d, qkv, slopes, pos, mask, dout):
    """21k's b4 training rows at head dim ``d``: #2 with lse and dropout
    0.2, #3 and #4 beside their plain versions, SDPA (forward with the
    float ALiBi mask and the dropout; forward and backward through
    autograd for #3 and #4) and their bounds at the true D."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_plain, alibi_flash_attention_packed, attention_bwd_plain,
        attention_dkv, attention_dq,
    )

    b, h, t = qkv.shape[1:4]
    drop = (ATTN_DROP, DROP_SEED)
    bounds = attention_bounds(b, h, t, d)
    fwd = lambda: alibi_flash_attention_packed(qkv, slopes, pos, mask, False, *drop,  # noqa
                                               return_lse=True)
    out, lse = fwd()
    delta = (dout.float() * out.float()).sum(-1).reshape(b * h, t)
    bwd = (qkv, dout, lse, delta, slopes, pos, mask, False, *drop)
    q, k, v, bias = sdpa_args(qkv, slopes, t, requires_grad=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, dropout_p=ATTN_DROP)
        torch.autograd.grad(o, (q, k, v), dout)

    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                                 dropout_p=ATTN_DROP))
    lib_fwd_bwd = cuda_ms(sdpa_fwd_bwd)
    plain_bwd = cuda_ms(lambda: attention_bwd_plain(*bwd), iters=1, warmup=1)
    for key, fn, plain, library, kernel, mult in (
            ("attention", fwd, lambda: alibi_attention_plain(qkv, slopes, pos, mask, False,
                                                             *drop, return_lse=True),
             lib_fwd, "alibi_fwd_kernel", 2),
            ("dq", lambda: attention_dq(*bwd), None, lib_fwd_bwd, "alibi_attention_dq_kernel",
             3),
            ("dkv", lambda: attention_dkv(*bwd), None, lib_fwd_bwd,
             "alibi_attention_dkv_kernel", 4)):
        dev_ms = device_ms(fn, kernel)
        row(key, d, f"b{b} H {h} T {t} training, dropout {ATTN_DROP}", cuda_ms(fn), dev_ms,
            plain_bwd if plain is None else cuda_ms(plain, iters=1, warmup=1), library,
            bounds["forward" if key == "attention" else key],
            per_ms(mult * 2 * b * h * t * t * d, dev_ms))
    del q, k, v, bias, out, lse, bwd


def head_dim_bias_rows(row, d, args, label):
    """21k's dense-bias rows at head dim ``d``: #11 with lse and #11b (the
    single launch at T <= 64, else dq + dbias and dk/dv) beside the plain
    versions, SDPA with the bias as a float mask at the same D (forward;
    forward and backward through autograd for #11b) and their bounds at the
    true D."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.bias_attention import (
        SINGLE_T, bias_attention_bwd_plain, bias_attention_bwd_single, bias_attention_dkv,
        bias_attention_dq, bias_attention_forward, bias_attention_plain,
    )

    q, k, v, dout, lse, delta, bias, _ = args
    b, t, h, _ = q.shape
    rows_of_bias = bias.shape[0]
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    mask = bias.to(torch.bfloat16).expand(b, h, t, t)
    g = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        torch.autograd.grad(o, (qs, ks, vs), g)

    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
    lib_bwd = cuda_ms(sdpa_fwd_bwd)
    bounds = bias_attention_bwd_bounds(b, h, t, d, bias_rows=rows_of_bias)
    plain_bwd = cuda_ms(lambda: bias_attention_bwd_plain(*args), iters=1, warmup=1)
    shape = f"b{b} H {h} T {t} {label}"
    if t <= SINGLE_T:  # the student: the single backward launch
        kernels = [("bias_single", lambda: bias_attention_bwd_single(*args), plain_bwd,
                    lib_bwd, bounds["single"], "bias_attention_bwd_single", 5)]
    else:  # the teacher's and serving's T: the forward with lse, dq + dbias, dk/dv
        fwd = lambda: bias_attention_forward(q, k, v, bias, with_lse=True)  # noqa: E731
        kernels = [("bias_attention", fwd, cuda_ms(lambda: bias_attention_plain(
            q, k, v, bias, return_lse=True), iters=1, warmup=1), lib_fwd, bounds["forward"],
            "bias_attention_kernel", 2),
                   ("bias_dq", lambda: bias_attention_dq(*args), plain_bwd, lib_bwd,
                    bounds["dq"], "bias_attention_dq_kernel", 3),
                   ("bias_dkv", lambda: bias_attention_dkv(*args), plain_bwd, lib_bwd,
                    bounds["dkv"], "bias_attention_dkv_kernel", 4)]
    for key, fn, plain_ms, library, bnd, kernel, mult in kernels:
        dev_ms = device_ms(fn, kernel)
        row(key, d, shape, cuda_ms(fn), dev_ms, plain_ms, library, bnd,
            per_ms(mult * 2 * b * h * t * t * d, dev_ms))
    del qs, ks, vs, mask


def head_dim_audio(name, card, dev, modes, timed, train):
    """21a-21c. The finetune model at HEAD_DIM_AUDIO[name]'s widths served
    (``serve_checked``: b2 against the plain path, launches asserted, b32
    timed in ``timed``); with ``train`` "steps" three b4 finetune_100 steps
    (launches, ms, peak memory) and the b4 gradients against the plain
    path, with "grads" the gradients alone. Returns (launches, rows)."""
    from animal2vec_tpu_torch.config import FinetuneConfig

    cfg = dataclasses.replace(FinetuneConfig(), **HEAD_DIM_AUDIO[name])
    d = cfg.embed_dim // cfg.num_heads
    label = f"21 {name} (C {cfg.embed_dim}, H {cfg.num_heads}, D {d}, {cfg.n_blocks} blocks)"
    launches, rows = serve_checked(label, cfg, card, dev, modes, timed,
                                   lambda mode: forward_launches(mode, cfg.n_blocks))
    if train == "steps":
        print(f"{label} b{TRAIN_BATCH} finetune_100 steps")
        stats = {}
        got = phase_train(cfg, card, dev, stats=stats)
        for key, n in zip(("attention", "dq", "dkv", "block"), got):
            launches[key] += n
        rows["train"] = stats
    if train:
        print(f"{label} gradients")
        phase_train_grads(cfg, dev, batch=TRAIN_BATCH)
    return launches, rows


def head_dim_image(card, dev):
    """21d. ViT-H/14's widths on the pre-LN image model (VIT_H14 on the
    ViT-B/16 cell's 4 + 8 blocks): the b64 forward in bf16 through the
    kernels (#11 once a block at D 80, #8 once a block) against the plain
    path, then timed; one b64 x clone 2 pretraining step (the post-LN
    ViT-B/16 recipe at these widths: #11 with lse, #11b's dq + dbias and
    dk/dv at the student's 77 kept patches, #6) and the b2 pretraining
    gradients against the plain path. Returns (launches, rows)."""
    from animal2vec_tpu_torch.config import ImageConfig, PretrainConfig
    from animal2vec_tpu_torch.models.finetune import build_image_model
    from animal2vec_tpu_torch.weights import serving_cast

    cfg = dataclasses.replace(ImageConfig(), layer_norm_first=True, **VIT_H14)
    label = (f"21d ViT-H/14 widths (C {cfg.embed_dim}, H {cfg.num_heads}, D "
             f"{cfg.embed_dim // cfg.num_heads}, patch {cfg.patch_size}, {cfg.num_patches} "
             f"patches, pre-LN)")
    model = build_image_model(cfg, dtype=torch.bfloat16, seed=SEED, device=dev)
    model.load_state_dict(serving_cast(model.state_dict()), strict=True, assign=True)
    imgs = torch.from_numpy(np.random.default_rng(SEED + 73).normal(
        size=(IMAGE_BATCH, cfg.input_size, cfg.input_size, 3)).astype(np.float32)).to(dev)
    want = dict.fromkeys(_counted(), 0)
    want.update(bias_attention=cfg.n_blocks, mlp=cfg.n_blocks)
    with torch.inference_mode():
        reset_counts()
        with PlainSpy() as spy:
            x = model.extract_features(imgs, "IMAGE")["x"]
        launched = counts()
        with PlainOps():
            x_p = model.extract_features(imgs, "IMAGE")["x"]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        model.extract_features(imgs, "IMAGE")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        timed = counts()
    print(f"{label} launches per forward: {launch_line(launched)} (expected "
          f"{launch_line(want)}); plain-version calls on CUDA tensors {spy.cuda_calls}")
    if launched != want or timed != want or spy.cuda_calls:
        raise AssertionError(f"{label}: launches {launched} / {timed} != {want}")
    if tuple(x.shape) != (IMAGE_BATCH, cfg.num_patches, cfg.embed_dim):
        raise AssertionError(f"{label}: features of shape {tuple(x.shape)}")
    rel = check_rel(f"{label} features x, kernel vs plain path", x, x_p, IMAGE_REL)
    print(f"{label} b{IMAGE_BATCH}: {IMAGE_BATCH / dt:.1f} images/s ({dt * 1e3:.2f} ms per "
          f"forward) on {card}")
    total = {k: 2 * launched[k] for k in launched}
    rows = {"bf16": {"b64_ms": dt * 1e3, "images_per_s": IMAGE_BATCH / dt, "rel_plain": rel}}
    del model, x, x_p, imgs
    torch.cuda.empty_cache()
    vit_h = PretrainConfig.vit_b16(model=ImageConfig(**VIT_H14))
    plabel = label.replace("pre-LN", "post-LN") + " pretrain"
    got = phase_pretrain(vit_h, card, dev, IMAGE_BATCH, plabel, "images", steps=1)
    total = {k: total[k] + got[k] for k in total}
    phase_pretrain_grads(vit_h, dev, 2, plabel)
    return total, rows


def phase_head_dims(card, dev, lib_path):
    """21. The attention kernels' head dims (ROADMAP A.11): 21k the kernels
    at HEAD_DIMS against their plain versions, timed at HEAD_DIMS_TIMED;
    21a XLS-R 1B's widths (D 80) served in the three modes and stepped;
    21b XLS-R 2B's (D 120, 12 blocks) served in bf16; 21c a2v-large at 8 heads (D
    128) served and its b4 gradients; 21d ViT-H/14's widths on the image
    model (D 80) served and pretrained. ``lib_path``: the built kernels'
    library, beside whose build.log the registers and spills of the
    two-tile instances are read. Returns (launches by kernel key, errors,
    rows)."""
    t0 = time.perf_counter()
    print(f"21 the attention kernels' head dims (ROADMAP A.11) on {card}")
    rows = {}

    def row(key, d, shape, ms, dev_ms, plain_ms, library_ms, bnd, rate):
        rows[f"{key} D {d}"] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                                "library_ms": library_ms, "bound_ms": bnd[0],
                                "bound_by": bnd[1], "rate": rate, "shape": shape}
        print(f"  21k {key} D {d}, {shape}: kernel {ms:.4f} ms (device {ms_text(dev_ms)})"
              f"{rate_text(rate, 'TFLOP/s' if 'int8' not in key else 'TOP/s')}, plain "
              f"{plain_ms:.3f} ms, SDPA "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]})")

    ptxas = [line for line in ptxas_summary((lib_path.parent / "build.log").read_text())
             if ("<2," in line or "<2>" in line)
             and any(k in line for k in ("alibi", "bias_attention", "quantize_qk", "quantize_v"))]
    for line in ptxas:
        print("  21k ptxas:", line)
    errs = head_dim_kernels(dev, row)
    parts = {"21k": time.perf_counter() - t0}
    launches = dict.fromkeys(_counted(), 0)
    models = {}
    for name, modes, timed, train in (("XLS-R 1B", ("bf16",) + MODES, ("bf16",) + MODES,
                                       "steps"),
                                      ("XLS-R 2B", ("bf16",), ("bf16",), None),
                                      ("a2v-large H 8", ("bf16",), (), "grads")):
        t1 = time.perf_counter()
        got, models[name] = head_dim_audio(name, card, dev, modes, timed, train)
        launches = {k: launches[k] + got[k] for k in launches}
        torch.cuda.empty_cache()
        parts[name] = time.perf_counter() - t1
    t1 = time.perf_counter()
    got, models["ViT-H/14"] = head_dim_image(card, dev)
    launches = {k: launches[k] + got[k] for k in launches}
    parts["ViT-H/14"] = time.perf_counter() - t1
    for key in ("serve_attention", "attention", "dq", "dkv", "int8_attention", "int8_quant",
                "bias_attention"):
        if not launches[key]:
            raise AssertionError(f"21: the main paths launched no {key}")
    if not launches["bias_dq"] or not launches["bias_dkv"]:
        raise AssertionError("21: the main paths launched no #11b")
    seconds = time.perf_counter() - t0
    print(json.dumps({"phase21": {"rows": rows, "models": models, "launches": launches,
                                  "errors": errs, "ptxas": ptxas, "seconds": seconds,
                                  "parts": parts}}))
    print(f"21 phase {seconds:.1f} s: " + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    return launches, errs, rows


# phase 22: JAX's default compute dtype, fp32, on the card (ROADMAP A.13's
# first slice). #1-#4 and #6 have fp32 instances whose every fp32 product is
# three bf16 products of the operands' split parts, a_hi b_hi + a_hi b_lo +
# a_lo b_hi into one fp32 accumulator (csrc/sm90.cuh split_pair). Their
# gates are a tenth of each bf16 gate above; tests/test_torch_fp32_kernels.py
# holds that arithmetic against JAX's kernels in fp32 on the CPU within them.
FP32_ATTN_TOL = (1e-3, 1e-3)
FP32_LSE_TOL = (1e-4, 1e-6)
FP32_BWD_TOL = (5e-4, 1e-3)
# the slope partials, held against float64 (slope_partials_fp64): with fp32
# inputs each P carries its row's rounding of lse and of logits far from 0,
# which the partial's cancelling difference multiplies by D sum P dist; the
# plain version's partials in fp32 lie 16.4x a tenth of SLOPE_PART_TOL from
# float64 at b4 T 2000 with row 1's tail padded, those of the fp32 dq
# kernel's arithmetic (P normalized by its row sum) 3.7-4.3x in its CPU
# emulation (tests/test_torch_fp32_kernels.py); 4x that is wider than the
# bf16 gate, so the gate is the bf16 gate
FP32_SLOPE_PART_TOL = SLOPE_PART_TOL
FP32_BLOCK_TOL = (3e-3, 2e-3)
FP32_MODEL_TOL = 2e-3  # max abs logits, kernel vs plain path: a tenth of MODEL_TOL
FP32_GRAD_TOL = 5e-3  # per parameter tensor, kernel vs plain path: a tenth of MODEL_GRAD_TOL
PEAK_TF32_FLOPS = 494.7e12  # the H100 SXM data sheet's dense TF32 peak (at 700 W)
FP32_KEYS = ("serve_attention", "attention", "dq", "dkv", "block")
FP32_HEAD_DIMS = (64, 128)  # one tile and two (stage_head)
# 22b and 22c: train_cli on the recipes with JAX's default dtype, at full
# width and depth, on 24 synthetic 10-s clips; update_freq 1 (the recipes'
# accumulation cut for the script's time; the micro-batch is the recipe's)
FP32_COMMON = CONFIG_COMMON + ("common.compute_dtype=float32",)
FP32_FINETUNE = ("dataset.train_subset=train_0", "dataset.batch_size=4",
                 "finetune.freeze_finetune_updates=0", "task.min_label_size=0",
                 "dataset.bucket_lengths=")
FP32_STEPS = {"finetune_100": 3, "a2v_large_pretrain": 2}


def fp32_bound(flops, nbytes):
    """(bound ms, what bounds it, the split design's floor ms): fp32
    operations over the TF32 dense peak against fp32 bytes over the memory
    rate; the floor is the three bf16 products of each fp32 one over the
    bf16 peak."""
    ms, by = bound(flops, nbytes, PEAK_TF32_FLOPS)
    return ms, by, 3 * flops / PEAK_BF16_FLOPS * 1e3


def fp32_attention_bounds(b, h, t, d):
    """attention_bounds' work in fp32 bytes (q, k, v, dO, out, dq, dk, dv
    four bytes an element)."""
    bhtd, bht = b * h * t * d, b * h * t
    flops = 2 * bhtd * t
    return {
        "serve_attention": fp32_bound(2 * flops, 4 * 4 * bhtd),
        "attention": fp32_bound(2 * flops, 4 * 4 * bhtd + 4 * bht),
        "dq": fp32_bound(3 * flops, 4 * 5 * bhtd + 2 * 4 * bht + 4 * b * h * -(-t // 64)),
        "dkv": fp32_bound(4 * flops, 4 * 6 * bhtd + 2 * 4 * bht),
    }


def fp32_block_bound(n, c=1024, m=4096):
    """fc1 and fc2 (2*N*C*M each); fp32 x read, x_out and t written, fp32
    weights and vectors read once."""
    return fp32_bound(4 * n * c * m, 4 * n * c * 3 + 4 * 2 * c * m + 4 * (5 * c + m))


def fp32_row_printer(tag):
    """(rows, row): ``row(key, d, shape, ms, dev_ms, bf16_ms, plain_ms,
    library_ms, bound, rate, gemm_ms=None)`` prints one fp32 instance's
    times (``bound`` = fp32_bound's triple) and keeps them in ``rows``."""
    rows = {}

    def row(key, d, shape, ms, dev_ms, bf16_ms, plain_ms, library_ms, bnd, rate, gemm_ms=None):
        rows[f"{key}{'' if d is None else f' D {d}'}, {shape}"] = {
            "ms": ms, "device_ms": dev_ms, "bf16_ms": bf16_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "split_floor_ms": bnd[2], "rate": rate, "gemm_device_ms": gemm_ms, "shape": shape}
        print(f"  {tag} fp32 {key}{'' if d is None else f' D {d}'}, {shape}: kernel {ms:.4f} ms "
              f"(device {ms_text(dev_ms)}){rate_text(rate, 'TFLOP/s')}"
              + ("" if gemm_ms is None else f", the two GEMM launches {ms_text(gemm_ms)}")
              + f"; bf16 instance {bf16_ms:.4f} ms; plain {plain_ms:.3f} ms; library (fp32, TF32 "
              f"off) {library_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}; TF32 peak), split "
              f"floor {bnd[2]:.4f} ms")

    return rows, row


def fp32_smem_line():
    """The dynamic shared memory of each instance, bf16 against fp32 (whose
    staged heads and rings hold a hi and a lo tile each), from the sources'
    formulas: alibi_attention_fwd.cu kSmem, alibi_attention_bwd.cu kDqSmem
    and kDkvSmem, bf16_gemm_sm90.cuh g16_smem (a 64 x 64 bf16 tile is 8192
    bytes)."""
    tile, parts = 8192, []
    for nc in (1, 2):
        for name, side in (("alibi_fwd", 2 * 64 * 8), ("dq", 2 * 64 * 16), ("dk/dv", 2 * 64 * 20)):
            heads = 6  # the forward: 2 Q heads + 2 x 2 ring; the backward: 2 + 2 x 2
            b16, f32 = (tile * nc * p * heads + side + 1024 for p in (1, 2))
            parts.append(f"{name} NC {nc} {b16} / {f32} B")
    parts.append(f"#6 GEMM {3 * 256 * 64 * 2 + 1024} B (both)")
    return "22k dynamic shared memory, bf16 / fp32: " + ", ".join(parts)


def fp32_attention_inputs(gen, b, h, t, d, dev):
    """fp32 (3, B, H, T, D) qkv and the ALiBi slopes."""
    from animal2vec_tpu_torch.ops.alibi import alibi_slopes

    qkv = torch.randn((3, b, h, t, d), generator=gen, device=dev)
    return qkv, torch.from_numpy(alibi_slopes(h).copy()).to(dev)


def check_fp32_attention_train(name, qkv, slopes, pos, mask, dout, drop):
    """#2 with lse, #3 and #4 on fp32 inputs against their plain versions in
    fp32 at the fp32 gates, the slope partials against float64 (the plain
    version's own distance from float64 and the kernel's from it printed);
    returns the forward, dq and dk/dv errors."""
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_plain, alibi_flash_attention_packed, attention_bwd_plain,
        attention_dkv, attention_dq,
    )

    b, h, t, _ = qkv.shape[1:]
    out, lse = alibi_flash_attention_packed(qkv, slopes, pos, mask, False, *drop,
                                            return_lse=True)
    out_p, lse_p = alibi_attention_plain(qkv, slopes, pos, mask, False, *drop, return_lse=True)
    torch.cuda.synchronize()
    if out.dtype != torch.float32:
        raise AssertionError(f"{name}: out is {out.dtype}")
    err_fwd = check_close(f"{name} out", out, out_p, FP32_ATTN_TOL)
    check_close(f"{name} lse", lse, lse_p, FP32_LSE_TOL)
    del out_p, lse_p
    delta = (dout * out).sum(-1).reshape(b * h, t)
    args = (qkv, dout, lse, delta, slopes, pos, mask, False, *drop)
    dq, parts = attention_dq(*args)
    dk, dv = attention_dkv(*args)
    want, parts_p = attention_bwd_plain(*args)
    torch.cuda.synchronize()
    err_dq = check_close(f"{name} dq", dq, want[0], FP32_BWD_TOL)
    err_dkv = max(check_close(f"{name} dk", dk, want[1], FP32_BWD_TOL),
                  check_close(f"{name} dv", dv, want[2], FP32_BWD_TOL))
    del want
    ref = slope_partials_fp64(qkv, dout, slopes, pos, mask, *drop)
    ratio = lambda x: ((x.double() - ref).abs()  # noqa: E731
                       / (1e-3 + 1e-4 * ref.abs())).max().item()
    print(f"{name} slope partials, worst ratio to a tenth of SLOPE_PART_TOL against float64: "
          f"plain version in fp32 {ratio(parts_p):.3f}, kernel {ratio(parts):.3f}; kernel "
          f"against the plain version {(parts - parts_p).abs().max().item():.3e} max abs")
    check_close(f"{name} slope partials against float64", parts, ref, FP32_SLOPE_PART_TOL)
    return err_fwd, err_dq, err_dkv


def fp32_train_rows(row, d, qkv, slopes, pos, mask, dout, drop, shape):
    """22k's training rows: #2 with lse and dropout, #3 and #4 in fp32, each
    beside the bf16 instance on the same values, the plain versions, SDPA in
    fp32 with the float ALiBi mask (TF32 off: forward with the dropout; its
    forward and backward for #3 and #4) and the fp32 bounds."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_plain, alibi_flash_attention_packed, attention_bwd_plain,
        attention_dkv, attention_dq,
    )

    b, h, t = qkv.shape[1:4]
    bounds = fp32_attention_bounds(b, h, t, d)
    inputs = {}
    for dt in (torch.float32, torch.bfloat16):
        x, g = qkv.to(dt), dout.to(dt)
        out, lse = alibi_flash_attention_packed(x, slopes, pos, mask, False, *drop,
                                                return_lse=True)
        delta = (g.float() * out.float()).sum(-1).reshape(b * h, t)
        inputs[dt] = (x, g, lse, delta, slopes, pos, mask, False, *drop)
    q, k, v, bias = sdpa_args(qkv, slopes, t, requires_grad=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, dropout_p=drop[0])
        torch.autograd.grad(o, (q, k, v), dout)

    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                                 dropout_p=drop[0]))
    lib_bwd = cuda_ms(sdpa_fwd_bwd)
    plain_bwd = cuda_ms(lambda: attention_bwd_plain(*inputs[torch.float32]), iters=1, warmup=1)
    fwd = lambda a: lambda: alibi_flash_attention_packed(  # noqa: E731
        a[0], slopes, pos, mask, False, *drop, return_lse=True)
    for key, fn, plain, library, kernel, mult in (
            ("attention", fwd, cuda_ms(lambda: alibi_attention_plain(
                qkv, slopes, pos, mask, False, *drop, return_lse=True), iters=1, warmup=1),
             lib_fwd, "alibi_fwd_kernel", 2),
            ("dq", lambda a: lambda: attention_dq(*a), plain_bwd, lib_bwd,
             "alibi_attention_dq_kernel", 3),
            ("dkv", lambda a: lambda: attention_dkv(*a), plain_bwd, lib_bwd,
             "alibi_attention_dkv_kernel", 4)):
        run32 = fn(inputs[torch.float32])
        dev_ms = device_ms(run32, kernel)
        row(key, d, shape, cuda_ms(run32), dev_ms, cuda_ms(fn(inputs[torch.bfloat16])), plain,
            library, bounds[key], per_ms(mult * 2 * b * h * t * t * d, dev_ms))
    del q, k, v, bias, inputs


def fp32_kernel_rows(dev, row):
    """22k. Each fp32 instance against its plain version in fp32 at the main
    paths' shapes and the fp32 gates, then timed (``row``): #2 with lse and
    dropout 0.2, #3 and #4 at b4 H 16 T 2000 with row 1's last 300 keys
    padded, and #1 at b32 T 2000 on the thirds of one (B, T, 3C)
    projection, at D 64 and 128 (one tile, two); #2-#4 at the a2v-large
    pretraining student's b60 T 125 keep-set positions, dropout 0.1; #6 at
    N 64 000 (b32 serving) and N 8000 with its three dropout sites at 0.1.
    Returns the largest error of each kernel key."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_plain, alibi_flash_attention_serve,
    )
    from animal2vec_tpu_torch.ops.fused_mlp import fused_block_mlp, fused_block_plain

    errs = dict.fromkeys(FP32_KEYS, 0.0)

    def err(key, e):
        errs[key] = max(errs[key], e)

    h = 16
    for d in FP32_HEAD_DIMS:
        gen = torch.Generator(device=dev).manual_seed(SEED + 2200 + d)
        b, t = TRAIN_BATCH, 2000
        qkv, slopes = fp32_attention_inputs(gen, b, h, t, d, dev)
        pos = torch.arange(t, dtype=torch.int32, device=dev)[None]
        mask = torch.zeros((b, t), dtype=torch.bool, device=dev)
        mask[1, -300:] = True
        dout = torch.randn((b, h, t, d), generator=gen, device=dev)
        shape = f"b{b} H {h} T {t} training, dropout {ATTN_DROP}"
        for key, e in zip(("attention", "dq", "dkv"), check_fp32_attention_train(
                f"22k D {d} fp32 attention training (b{b}, T {t}, dropout {ATTN_DROP}, row 1 "
                "padded)", qkv, slopes, pos, mask, dout, (ATTN_DROP, DROP_SEED))):
            err(key, e)
        fp32_train_rows(row, d, qkv, slopes, pos, mask, dout, (ATTN_DROP, DROP_SEED), shape)
        del qkv, dout
        torch.cuda.empty_cache()
        b = 32
        proj = torch.randn((b, t, 3, h, d), generator=gen, device=dev)
        q, k, v = proj.unbind(2)
        with torch.inference_mode():
            got = alibi_flash_attention_serve(q, k, v, slopes, pos).transpose(1, 2)
            packed = torch.stack((q, k, v)).transpose(2, 3)
            want = alibi_attention_plain(packed, slopes, pos)
            torch.cuda.synchronize()
            if got.dtype != torch.float32:
                raise AssertionError(f"22k #1 fp32: out is {got.dtype}")
            err("serve_attention", check_close(f"22k D {d} fp32 attention b32 serving, q, k, v "
                                               "read in place", got, want, FP32_ATTN_TOL))
            del got, want
            torch.cuda.empty_cache()
            serve = lambda x: lambda: alibi_flash_attention_serve(  # noqa: E731
                *x.unbind(2), slopes, pos)
            qs, ks, vs, bias = sdpa_args(packed, slopes, t)
            library = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias))
            dev_ms = device_ms(serve(proj), "alibi_fwd_kernel")
            row("serve_attention", d, f"b{b} H {h} T {t} serving, in place", cuda_ms(serve(proj)),
                dev_ms, cuda_ms(serve(proj.to(torch.bfloat16))),
                cuda_ms(lambda: alibi_attention_plain(packed, slopes, pos), iters=1, warmup=1),
                library, fp32_attention_bounds(b, h, t, d)["serve_attention"],
                per_ms(4 * b * h * t * t * d, dev_ms))
        del proj, q, k, v, packed, qs, ks, vs, bias
        torch.cuda.empty_cache()
    # the a2v-large pretraining student's shape (D 64)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2213)
    b, t = 60, 125
    qkv, slopes = fp32_attention_inputs(gen, b, h, t, 64, dev)
    rng = np.random.default_rng(SEED + 2213)
    pos = torch.from_numpy(np.stack([np.sort(rng.choice(2000, t, replace=False))
                                     for _ in range(b)]).astype(np.int32)).to(dev)
    dout = torch.randn((b, h, t, 64), generator=gen, device=dev)
    drop = (0.1, DROP_SEED + 1)
    for key, e in zip(("attention", "dq", "dkv"), check_fp32_attention_train(
            f"22k fp32 attention pretraining student (b{b}, T {t}, keep-set positions, "
            "dropout 0.1)", qkv, slopes, pos, None, dout, drop)):
        err(key, e)
    fp32_train_rows(row, 64, qkv, slopes, pos, None, dout, drop,
                    f"b{b} H {h} T {t} pretrain student, dropout 0.1")
    del qkv, dout
    # #6, serving and training shapes; the weights as the model hands them
    # over (Linear.weight.t() views)
    for n, drop in ((32 * 2000, ()), (TRAIN_BATCH * 2000, ((11, -22, 2**31 - 5), 0.1, 0.1))):
        gen = torch.Generator(device=dev).manual_seed(SEED + 2206 + n)
        c, m = 1024, 4096
        args = list(block_inputs(gen, n, c, m, dev))
        args[0] = torch.randn((n, c), generator=gen, device=dev)
        args[3] = (torch.randn((m, c), generator=gen, device=dev) * (2 / (c + m)) ** 0.5).t()
        args[4] = (torch.randn((c, m), generator=gen, device=dev) * (2 / (c + m)) ** 0.5).t()
        label = f"22k fp32 fused block N {n}" + (", dropout 0.1" if drop else "")
        with torch.no_grad():
            xo, tap = fused_block_mlp(*args, *drop)
            xo_p, tap_p = fused_block_plain(*args, *drop)
            torch.cuda.synchronize()
            if xo.dtype != torch.float32 or tap.dtype != torch.float32:
                raise AssertionError(f"{label}: outputs {xo.dtype}, {tap.dtype}")
            err("block", max(check_close(f"{label} tap t", tap, tap_p, FP32_BLOCK_TOL),
                             check_close(f"{label} x_out", xo, xo_p, FP32_BLOCK_TOL)))
            del xo, tap, xo_p, tap_p
            run = lambda a: lambda: fused_block_mlp(*a, *drop)  # noqa: E731
            bf16_args = [a.to(torch.bfloat16) if i in (0, 3, 4) else a
                         for i, a in enumerate(args)]
            w1, w2, b1, b2 = args[3], args[4], args[5], args[6]
            lib = cuda_ms(lambda: F.linear(F.gelu(F.linear(args[0], w1.t(), b1)), w2.t(), b2))
            dev_ms = device_ms(run(args), "")
            gemm_ms = device_ms(run(args), "gemm_bf16_sm90")
            row("block", None, f"N {n}, C {c}, M {m}" + (", dropout 0.1" if drop else ""),
                cuda_ms(run(args)), dev_ms, cuda_ms(run(bf16_args)),
                cuda_ms(lambda: fused_block_plain(*args, *drop), iters=1, warmup=1), lib,
                fp32_block_bound(n, c, m), per_ms(4 * n * c * m, dev_ms), gemm_ms=gemm_ms)
        print(f"  22k fp32 fused block N {n}: bf16 scratch of the split planes "
              f"{2 * 3 * (n * c + n * m + 2 * m * c) / 1e9:.3f} GB a launch (h's three planes "
              f"{2 * 3 * n * m / 1e9:.3f} GB)")
        del args, bf16_args
        torch.cuda.empty_cache()
    return errs


def slope_partials_fp64(qkv, dout, slopes, pos, mask, rate, seed):
    """The dq kernel's slope partials (B, H, ceil(T / 64)) in float64 from
    the values of qkv and dout: P from the float64 softmax, dP and the
    row's delta sum P f dP in float64 (attention_bwd_plain's rule)."""
    from animal2vec_tpu_torch.ops.attention import NEG_INF, Q_TILE, _keep_factor

    q, k, v = (x.double() for x in qkv.unbind(0))
    b, h, t, d = q.shape
    p64 = pos.double()
    dist = (p64[:, :, None] - p64[:, None, :]).abs()[:, None]
    logits = q @ k.transpose(-1, -2) * d**-0.5 - dist * slopes.double()[None, :, None, None]
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :], NEG_INF)
    p = torch.softmax(logits, -1)
    if mask is not None:
        p = p.masked_fill(mask[:, None, None, :], 0.0)
    f = _keep_factor(b, h, t, rate, seed, q.device).double() if rate else 1.0
    pdp = p * (dout.double() @ v.transpose(-1, -2)) * f
    per_row = -((pdp * dist).sum(-1) - pdp.sum(-1) * (p * dist).sum(-1))
    n_qt = -(-t // Q_TILE)
    per_row = torch.nn.functional.pad(per_row, (0, n_qt * Q_TILE - t))
    return per_row.reshape(b, h, n_qt, Q_TILE).sum(-1)


def fp32_slope_check(dev):
    """22s (ROADMAP C.1): at 17b's shape (the a2v-large pretraining student
    of b1 x clone 2: b2, H 16, T 125 keep-set positions, dropout 0.1), #3's
    slope partials from the bf16 instance and from the fp32 instance, and
    the slope gradient of the plain path in bf16 (autograd through
    alibi_attention_btc_plain on the bf16 values), each against the float64
    reference on the same values, over three seeded inputs. Returns the
    errors (relative norm of the per-head gradient; largest partial error
    over the largest partial)."""
    from animal2vec_tpu_torch.ops.attention import (
        alibi_attention_btc_plain, alibi_flash_attention_packed, attention_dq,
    )

    b, h, t, d = 2, 16, 125, 64
    drop = (0.1, DROP_SEED + 2)
    out = {"bf16 kernel": [], "fp32 kernel": [], "bf16 plain path": []}
    part_err = {"bf16 kernel": [], "fp32 kernel": []}
    for i in range(3):
        gen = torch.Generator(device=dev).manual_seed(SEED + 2219 + i)
        qkv, slopes = fp32_attention_inputs(gen, b, h, t, d, dev)
        qkv = qkv.to(torch.bfloat16)  # the values all three take
        rng = np.random.default_rng(SEED + 2219 + i)
        pos = torch.from_numpy(np.stack([np.sort(rng.choice(2000, t, replace=False))
                                         for _ in range(b)]).astype(np.int32)).to(dev)
        dout = torch.randn((b, h, t, d), generator=gen, device=dev).to(torch.bfloat16)
        ref = slope_partials_fp64(qkv, dout, slopes, pos, None, *drop)
        ref_g = ref.sum(dim=(0, 2))
        for label, dt in (("bf16 kernel", torch.bfloat16), ("fp32 kernel", torch.float32)):
            x, g = qkv.to(dt), dout.to(dt)
            o, lse = alibi_flash_attention_packed(x, slopes, pos, None, False, *drop,
                                                  return_lse=True)
            delta = (g.float() * o.float()).sum(-1).reshape(b * h, t)
            _, parts = attention_dq(x, g, lse, delta, slopes, pos, None, False, *drop)
            out[label].append(rel_norm(parts.double().sum(dim=(0, 2)), ref_g))
            part_err[label].append(((parts.double() - ref).abs().max()
                                    / ref.abs().max()).item())
        qkv_btc = qkv.permute(1, 3, 0, 2, 4).reshape(b, t, 3 * h * d)
        s = slopes.clone().requires_grad_()
        o = alibi_attention_btc_plain(qkv_btc, h, s, pos, None, False, *drop)
        (gs,) = torch.autograd.grad(o, (s,), dout.permute(0, 2, 1, 3).reshape(b, t, h * d))
        out["bf16 plain path"].append(rel_norm(gs.double(), ref_g))
    torch.cuda.synchronize()
    for label, rels in out.items():
        print(f"22s slope gradient at b{b} H {h} T {t} (17b's student shape, keep-set "
              f"positions, dropout 0.1) against float64, {label}: relative norm per head "
              + ", ".join(f"{r:.3e}" for r in rels)
              + ("" if label not in part_err else "; largest partial error / largest partial "
                 + ", ".join(f"{r:.3e}" for r in part_err[label])))
    worst = {k: max(v) for k, v in out.items()}
    print(f"22s worst relative norms: bf16 kernel {worst['bf16 kernel']:.3e}, bf16 plain path "
          f"{worst['bf16 plain path']:.3e} (kernel / plain path "
          f"{worst['bf16 kernel'] / worst['bf16 plain path']:.3e}), fp32 kernel "
          f"{worst['fp32 kernel']:.3e}")
    return {"rel": out, "partials": part_err}


def fp32_model_check(card, dev, bf16_logits):
    """22a. The a2v-large FinetuneModel (finetune_100's widths, 8 + 16
    blocks) at its fp32 default of build_finetune_model: a b2 forward
    through the kernels (#1 and #6 once a block, no plain version on a CUDA
    tensor) against the plain path at FP32_MODEL_TOL, against the bf16
    model's logits (printed), then b32 clips/s. Returns (launches, rows)."""
    from animal2vec_tpu_torch.config import FinetuneConfig
    from animal2vec_tpu_torch.models.finetune import build_finetune_model

    cfg = FinetuneConfig()
    model = build_finetune_model(cfg, seed=SEED, device=dev)
    if next(model.parameters()).dtype != torch.float32 or model.encoder.dtype != torch.float32:
        raise AssertionError("22a: build_finetune_model's default is not fp32")
    src = torch.from_numpy(
        np.random.default_rng(SEED).normal(size=(2, WAV_LEN)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        reset_counts()
        with PlainSpy() as spy:
            logits = model(src)["encoder_out"]
        got = counts()
        with PlainOps():
            logits_p = model(src)["encoder_out"]
        torch.cuda.synchronize()
    want = forward_launches("bf16", cfg.n_blocks)
    print(f"22a fp32 model launches per forward: {launch_line(got)} (expected "
          f"{launch_line(want)}); plain-version calls on CUDA tensors {spy.cuda_calls}")
    if got != want or spy.cuda_calls:
        raise AssertionError("22a: the fp32 model did not launch #1 and #6 once per block")
    if logits.dtype != torch.float32 or tuple(logits.shape) != tuple(bf16_logits.shape) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"22a: bad logits {logits.dtype} {tuple(logits.shape)}")
    err = (logits - logits_p).abs().max().item()
    print(f"22a fp32 model logits kernel vs plain path: max_abs_err {err:.3e} (tolerance "
          f"{FP32_MODEL_TOL}), relative norm {rel_norm(logits, logits_p):.3e}; against the bf16 "
          f"model's (not gated): max abs {(logits - bf16_logits.float()).abs().max().item():.3e}, "
          f"relative norm {rel_norm(logits, bf16_logits):.3e}")
    if not err <= FP32_MODEL_TOL:
        raise AssertionError("22a: the fp32 kernel path disagrees with the plain path")
    src = torch.from_numpy(
        np.random.default_rng(SEED + 2).normal(size=(32, WAV_LEN)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        model(src)
        torch.cuda.synchronize()
        iters = 3
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(src)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        timed = counts()
    print(f"22a fp32 throughput b32: {32 / dt:.2f} 10-s clips/s ({dt * 1e3:.1f} ms per batch) on "
          f"{card}; launches over {iters} b32 forwards: {launch_line(timed)}")
    if timed != {k: iters * v for k, v in want.items()}:
        raise AssertionError("22a: the timed forwards' launches")
    del model
    torch.cuda.empty_cache()
    return ({k: got[k] + timed[k] for k in got},
            {"b32_ms": dt * 1e3, "clips_per_s": 32 / dt, "logits_max_abs_err": err})


def fp32_train_cli(name, data, save_dir, card):
    """train_cli --config <name>.yaml common.compute_dtype=float32 at full
    width for FP32_STEPS[name] steps: each step's loss, ms and launches
    (attention forward, dq and dk/dv once for each student block that ran;
    pretraining: the teacher's serving attention once a block; #6 once for
    every block), peak memory, no plain version on a CUDA tensor. Returns
    (launches, stats)."""
    from animal2vec_tpu_torch.recipes import RECIPES
    from animal2vec_tpu_torch.tools import train_cli

    steps = FP32_STEPS[name]
    extra = list(FP32_COMMON) + (list(FP32_FINETUNE) if "finetune" in name else [])
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with EntryWatch() as watch, PlainSpy() as spy:
        out = train_cli.main(["--config", str(RECIPES[name]), "--data", data, "--save-dir",
                              save_dir, "--max-steps", str(steps), "--device", "cuda", *extra])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = counts()
    label = f"22{'b' if 'finetune' in name else 'c'} train_cli --config {name}.yaml"
    for i, s in enumerate(watch.steps):
        n = s["launched"]
        student = n["attention"]
        print(f"{label} step {i + 1}: loss {s['loss']:.5f}, {s['seconds'] * 1e3:.1f} ms; "
              f"launches: student attention {student}, dq {n['dq']}, dk/dv {n['dkv']}, "
              f"teacher attention {n['serve_attention']}, fused block {n['block']} "
              f"({s['ran']} blocks ran)")
        if not np.isfinite(s["loss"]) or not student or n["dq"] != student \
                or n["dkv"] != student or n["block"] != s["ran"] \
                or student + n["serve_attention"] != s["ran"] \
                or ("finetune" in name) == bool(n["serve_attention"]):
            raise AssertionError(f"{label} step {i + 1}: loss or launches {n}")
        if sum(n.values()) != student * 3 + n["serve_attention"] + n["block"]:
            raise AssertionError(f"{label} step {i + 1}: another kernel launched: {n}")
    ms = [round(s["seconds"] * 1e3, 1) for s in watch.steps]
    print(f"{label} ({' '.join(extra)}): {len(watch.steps)} steps in {seconds:.2f} s, ms per "
          f"step {ms}, peak memory {peak:.2f} GiB; launches {launch_line(got)}; plain-version "
          f"calls on CUDA tensors {spy.cuda_calls} on {card}")
    if len(watch.steps) != steps or spy.cuda_calls or out is None:
        raise AssertionError(f"{label}: {len(watch.steps)} steps or a plain call")
    return got, {"step_ms": ms, "peak_gib": peak, "losses": [s["loss"] for s in watch.steps]}


def fp32_export(data, ckpt, card, dev):
    """22a, the serving entry: export_cli --dtype float32 over the 24
    synthetic clips at batch 12 from 22b's checkpoint (predictions and
    embeddings as npz): #1 and #6 once a block a forward, finite outputs.
    Returns the launches."""
    from animal2vec_tpu_torch.config import FinetuneConfig
    from animal2vec_tpu_torch.tools import export_cli

    out = os.path.join(os.path.dirname(ckpt), "export_fp32")
    reset_counts()
    with PlainSpy() as spy:
        line = export_cli.main([
            "--manifest-path", data, "--split", "pretrain", "--checkpoint", ckpt, "--out-path",
            out, "--batch-size", str(SERVE_EXPORT_BATCH), "--export-predictions",
            "--export-embeddings", "--data-parallel", "1", "--label-ext", "npz",
            "--output-format", "npz", "--dtype", "float32", "--device", dev.type,
            *SERVE_OVERRIDES])
    torch.cuda.synchronize()
    got = counts()
    want = {k: SERVE_CLIPS // SERVE_EXPORT_BATCH * v
            for k, v in forward_launches("bf16", FinetuneConfig().n_blocks).items()}
    finite = all(np.isfinite(z[k]).all() for name in os.listdir(out)
                 for z in [np.load(os.path.join(out, name))] for k in z.files
                 if z[k].dtype.kind == "f")
    print(f"22a export_cli --dtype float32: {line['clips_per_sec']} clips/s ({line['clips_timed']}"
          f" clips timed) on {card}; launches {launch_line(got)}; outputs finite {finite}; "
          f"plain-version calls on CUDA tensors {spy.cuda_calls}")
    if got != want or spy.cuda_calls or not finite:
        raise AssertionError(f"22a export_cli: launches {got} != {want}, a plain call or a "
                             "non-finite output")
    return got


def phase_fp32(card, dev, lib_path, bf16_logits):
    """22. JAX's default compute dtype on the card (ROADMAP A.13, first
    slice): 22k the fp32 instances of #1-#4 and #6 against their plain
    versions in fp32, timed beside the bf16 instances; 22s the slope
    partials against float64 (ROADMAP C.1); 22b train_cli --config
    finetune_100.yaml common.compute_dtype=float32 (3 steps) and the b1
    gradients against the plain path; 22a the fp32 model served (b2 against
    the plain path, b32 timed) and export_cli --dtype float32 from 22b's
    checkpoint; 22c train_cli --config a2v_large_pretrain.yaml
    common.compute_dtype=float32 (2 steps). Returns (launches by kernel key
    of the main paths, errors, rows)."""
    from animal2vec_tpu_torch.config import FinetuneConfig
    from animal2vec_tpu_torch.data.synthetic import generate

    t0 = time.perf_counter()
    print(f"22 JAX's default compute dtype, fp32, on the card (ROADMAP A.13) on {card}")
    rows, row = fp32_row_printer("22k")
    ptxas = [line for line in ptxas_summary((lib_path.parent / "build.log").read_text())
             if "f32>" in line and ("alibi" in line or "gemm_bf16" in line or "ln_rows" in line
                                    or "split_weights" in line)]
    for line in ptxas:
        print("  22k ptxas:", line)
    print("  " + fp32_smem_line())
    errs = fp32_kernel_rows(dev, row)
    parts = {"22k": time.perf_counter() - t0}
    t1 = time.perf_counter()
    slope = fp32_slope_check(dev)
    parts["22s"] = time.perf_counter() - t1
    launches = dict.fromkeys(_counted(), 0)
    models = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = generate(os.path.join(tmp, "data"), n_clips=ENTRY_CLIPS, clip_seconds=10.0,
                        seed=SEED, label_ext="npz")
        t1 = time.perf_counter()
        save = os.path.join(tmp, "finetune_100")
        got, models["finetune"] = fp32_train_cli("finetune_100", data, save, card)
        launches = {k: launches[k] + got[k] for k in launches}
        torch.cuda.empty_cache()
        print("22b fp32 gradients, kernel vs plain path")
        models["finetune"]["grad_rel_max"] = phase_train_grads(
            FinetuneConfig(), dev, dtype=torch.float32, tol=FP32_GRAD_TOL)
        parts["22b"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        got, models["serving"] = fp32_model_check(card, dev, bf16_logits)
        launches = {k: launches[k] + got[k] for k in launches}
        ckpt = sorted(p for p in os.listdir(save) if p.startswith("step_"))[-1]
        got = fp32_export(data, os.path.join(save, ckpt), card, dev)
        launches = {k: launches[k] + got[k] for k in launches}
        parts["22a"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        got, models["pretrain"] = fp32_train_cli("a2v_large_pretrain", data,
                                                 os.path.join(tmp, "pretrain"), card)
        launches = {k: launches[k] + got[k] for k in launches}
        parts["22c"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    for key in FP32_KEYS:
        if not launches[key]:
            raise AssertionError(f"22: the fp32 main paths launched no {key}")
    seconds = time.perf_counter() - t0
    print(json.dumps({"phase22": {"rows": rows, "models": models, "launches": launches,
                                  "errors": errs, "slope": slope, "ptxas": ptxas,
                                  "seconds": seconds, "parts": parts}}))
    print(f"22 phase {seconds:.1f} s: " + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    return launches, errs, rows


# phase 23: the fp32 instances of #8, #11 and #11b (ROADMAP A.13, second
# slice) and the families they open in JAX's default dtype: variants N and
# P (ALiBi-free post-LN, PCEN pre-LN) and the ViT-B/16 image model. Gates
# as phase 22's, a tenth of each bf16 gate (tests/test_torch_fp32_dense_bias
# holds the arithmetic against JAX on the CPU within them), save dbias's:
# dS = P (dP - delta) cancels where dP is near delta, and there the split
# products' 2^-17 of dP, times P, outgrows a tenth of DBIAS_TOL (10.7x in
# the CPU emulation at the card's b128 T 59 shape) and at a few elements
# DBIAS_TOL itself (1 of 5 346 816 at 1.069x there; 1 of 167 088 at 2.127x
# in the test's draw), so 4x the emulation lies past the bf16 gate, the
# rule's cap: dbias is held at DBIAS_TOL for all but FP32_DBIAS_FLIP_SHARE
# of the elements, none beyond FP32_DBIAS_FLIP_FACTOR (4x 2.127, rounded
# up) of it, with every (b, h) plane's relative norm within a tenth of
# REL_HEAD (the emulation: 1.4e-5).
FP32_DBIAS_TOL = DBIAS_TOL
FP32_DBIAS_FLIP_SHARE, FP32_DBIAS_FLIP_FACTOR = 1e-5, 9.0
FP32_REL_HEAD = REL_HEAD / 10
FP32_IMAGE_REL = IMAGE_REL / 10
FP32_DENSE_KEYS = ("mlp", "bias_attention", "bias_dq", "bias_dkv", "bias_single")
FP32_DENSE_HEAD_DIMS = (64, 128)  # one tile and two (stage_head)


def fp32_mlp_bound(n, c, m, c2):
    """fc1 and fc2 (2*N*C*M + 2*N*M*C2); fp32 x read and out written, fp32
    weights and biases read once."""
    return fp32_bound(2 * n * m * (c + c2), 4 * n * (c + c2) + 4 * m * (c + c2) + 4 * (m + c2))


def fp32_bias_bounds(b, h, t, d, bias_rows=0, dbias=False):
    """bias_attention_bwd_bounds' work in fp32 bytes: q, k, v, dO, out, dq,
    dk, dv four bytes an element; the fp32 bias planes (``bias_rows`` of
    them) read once, dbias (B planes) written once."""
    bhtd, bht, plane = b * h * t * d, b * h * t, 4 * h * t * t
    flops = 2 * bhtd * t
    inputs = 4 * 4 * bhtd + 2 * 4 * bht + bias_rows * plane
    dbias_out = b * plane if dbias else 0
    return {
        "bias_attention": fp32_bound(2 * flops, 4 * 4 * bhtd + 4 * bht + bias_rows * plane),
        "bias_dq": fp32_bound(3 * flops, inputs + 4 * bhtd + dbias_out),
        "bias_dkv": fp32_bound(4 * flops, inputs + 2 * 4 * bhtd),
        "bias_single": fp32_bound(5 * flops, inputs + 3 * 4 * bhtd + dbias_out),
    }


def check_fp32_dbias(name, got, want):
    """dbias in fp32 against its plain version: FP32_DBIAS_TOL for all but
    FP32_DBIAS_FLIP_SHARE of the elements, none beyond
    FP32_DBIAS_FLIP_FACTOR of it, every (b, h) plane within FP32_REL_HEAD
    relative norm (planes of norm below 1e-3 count as 1e-3). Returns the
    max abs error."""
    atol, rtol = FP32_DBIAS_TOL
    err = (got - want).abs()
    ratio = err / (atol + rtol * want.abs())
    over, worst = (ratio > 1).sum().item(), ratio.max().item()
    rel = ((got - want).flatten(2).norm(dim=-1)
           / want.flatten(2).norm(dim=-1).clamp_min(1e-3)).max().item()
    print(f"{name}: max_abs_err {err.max().item():.3e} (tolerance {atol} + {rtol}*|plain| for all "
          f"but {FP32_DBIAS_FLIP_SHARE:g} of the elements, within {FP32_DBIAS_FLIP_FACTOR} of it), "
          f"worst ratio {worst:.3f}, {over} of {ratio.numel()} over; per (b, h) relative norm "
          f"max {rel:.3e} (tolerance {FP32_REL_HEAD})")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if worst > FP32_DBIAS_FLIP_FACTOR or over > FP32_DBIAS_FLIP_SHARE * ratio.numel() \
            or rel > FP32_REL_HEAD:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err.max().item()


def fp32_dense_smem_line():
    """The dynamic shared memory of #11's and #11b's instances with a bias,
    bf16 against fp32 (whose staged heads hold a hi and a lo tile each, and
    the single launch's dS and P f too), from the sources' formulas:
    bias_attention.cu smem_bytes, bias_attention_bwd.cu dq_smem, dkv_smem
    and single_smem (a 64 x 64 bf16 tile is 8192 bytes, an fp32 one 16
    384); #8's GEMM takes #6's."""
    tile, f32_tile, parts = 8192, 16384, []
    for nc in (1, 2):
        for name, tiles, side in (("#11", lambda p: nc * p * 5, 2 * f32_tile + 2 * 64 * 4),
                                  ("#11b dq", lambda p: nc * p * 6, 2 * f32_tile + 2 * 64 * 4),
                                  ("#11b dk/dv", lambda p: nc * p * 6, 2 * f32_tile + 2 * 64 * 16),
                                  ("#11b single", lambda p: (4 * nc + 2) * p, f32_tile + 64 * 4)):
            b16, f32 = (tile * tiles(p) + side + 1024 for p in (1, 2))
            parts.append(f"{name} NC {nc} {b16} / {f32} B")
    return "23k dynamic shared memory with a bias, bf16 / fp32: " + ", ".join(parts)


def fp32_dense_inputs(gen, b, h, t, d, dev):
    """fp32 (B, T, H, D) q, k, v views of one (B, T, 3, H, D) projection."""
    return torch.randn((b, t, 3, h, d), generator=gen, device=dev).unbind(2)


def fp32_mlp_rows(dev, row, err):
    """23k's #8: the fp32 instance at variant P's b32 serving shape (N 64
    000, C 1024, M 4096), its b4 step's (N 8000) with both dropout sites at
    0.1, and the ViT-B/16 pre-LN b64 shape (N 12 544, C 768, M 3072), the
    weights in nn.Linear layout, against the plain version in fp32 at
    FP32_BLOCK_TOL; timed beside the bf16 instance on the same values, the
    plain version, F.linear -> GELU -> F.linear in fp32 (TF32 off)."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain

    for n, c, m, drop in ((32 * 2000, 1024, 4096, ()), (TRAIN_BATCH * 2000, 1024, 4096,
                                                        ((21, -22), OPTION_ACT_DROP)),
                          (IMAGE_BATCH * IMAGE_T, 768, 3072, ())):
        gen = torch.Generator(device=dev).manual_seed(SEED + 2300 + n)
        x = torch.randn((n, c), generator=gen, device=dev)
        w1 = torch.randn((m, c), generator=gen, device=dev) * (2 / (c + m)) ** 0.5
        w2 = torch.randn((c, m), generator=gen, device=dev) * (2 / (c + m)) ** 0.5
        b1 = torch.randn((m,), generator=gen, device=dev) * 0.1
        b2 = torch.randn((c,), generator=gen, device=dev) * 0.1
        shape = f"N {n}, C {c}, M {m}" + (f", dropout {drop[1]}" if drop else "")
        with torch.no_grad():
            got = fused_mlp(x, w1, w2, b1, b2, *drop)
            want = fused_mlp_plain(x, w1, w2, b1, b2, *drop)
            torch.cuda.synchronize()
            if got.dtype != torch.float32:
                raise AssertionError(f"23k #8 fp32: out is {got.dtype}")
            err("mlp", check_close(f"23k fp32 fused MLP {shape}", got, want, FP32_BLOCK_TOL))
            del got, want
            run = lambda a: lambda: fused_mlp(*a, *drop)  # noqa: E731
            args = (x, w1, w2, b1, b2)
            bf16_args = tuple(a.to(torch.bfloat16) if i < 3 else a for i, a in enumerate(args))
            dev_ms = device_ms(run(args), "")
            row("mlp", None, shape, cuda_ms(run(args)), dev_ms, cuda_ms(run(bf16_args)),
                cuda_ms(lambda: fused_mlp_plain(*args, *drop), iters=1, warmup=1),
                cuda_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)),
                fp32_mlp_bound(n, c, m, c), per_ms(4 * n * c * m, dev_ms),
                gemm_ms=device_ms(run(args), "gemm_bf16_sm90"))
        print(f"  23k fp32 fused MLP {shape}: bf16 scratch of the split planes "
              f"{2 * 3 * (n * c + n * m + 2 * m * c) / 1e9:.3f} GB a launch")
        del x, w1, w2, b1, b2, args, bf16_args
        torch.cuda.empty_cache()


def fp32_bias_forward_rows(dev, row, err):
    """23k's #11: the fp32 instance at variant N's b32 serving (H 16, T
    2000, no bias), the ViT-B/16 b64 serving (H 12, T 196, the 2-D ALiBi
    bias; also at D 128) and its pretraining student (b128, T 59, per-row
    keep-set bias, lse, dropout 0.1), against the plain version in fp32
    (FP32_ATTN_TOL, FP32_LSE_TOL; the dropout's mask drawn alike); timed
    beside the bf16 instance, the plain version and SDPA in fp32 with the
    bias as an fp32 float mask (TF32 off; its own dropout_p)."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.bias_attention import (
        attention_keep, bias_attention_forward, bias_attention_plain,
    )

    rng = np.random.default_rng(SEED + 2310)
    cases = (("b32 H 16 T 2000 serving, no bias", 32, 16, 2000, 64, None, 0.0),
             ("b64 H 12 T 196 serving, 2-D ALiBi", IMAGE_BATCH, IMAGE_HEADS, IMAGE_T, 64,
              image_bias(IMAGE_HEADS, IMAGE_T, dev), 0.0),
             ("b64 H 12 T 196 serving, 2-D ALiBi", IMAGE_BATCH, IMAGE_HEADS, IMAGE_T, 128,
              image_bias(IMAGE_HEADS, IMAGE_T, dev), 0.0),
             (f"b128 H 12 T {STUDENT_T} student, per-row bias, lse, dropout {BIAS_DROP}",
              2 * IMAGE_BATCH, IMAGE_HEADS, STUDENT_T, 64,
              keep_set_bias(rng, 2 * IMAGE_BATCH, IMAGE_HEADS, STUDENT_T, dev), BIAS_DROP))
    for shape, b, h, t, d, bias, rate in cases:
        gen = torch.Generator(device=dev).manual_seed(SEED + 2311 + t + d)
        q, k, v = fp32_dense_inputs(gen, b, h, t, d, dev)
        train = rate > 0.0
        keep = attention_keep(b, h, t, rate, BIAS_DROP_SEED, dev) if train else None
        label = f"23k D {d} fp32 bias attention {shape}"
        with torch.no_grad():
            got = bias_attention_forward(q, k, v, bias, None, train, rate, BIAS_DROP_SEED)
            want = bias_attention_plain(q, k, v, bias, None, train, keep, rate)
            torch.cuda.synchronize()
            out, out_p = (got[0], want[0]) if train else (got, want)
            if out.dtype != torch.float32:
                raise AssertionError(f"{label}: out is {out.dtype}")
            err("bias_attention", check_close(f"{label} out", out, out_p, FP32_ATTN_TOL))
            if train:
                check_close(f"{label} lse", got[1], want[1], FP32_LSE_TOL)
            del got, want, out, out_p
            run = lambda a: lambda: bias_attention_forward(  # noqa: E731
                *a, bias, None, train, rate, BIAS_DROP_SEED)
            args = (q, k, v)
            bf16_args = tuple(x.to(torch.bfloat16) for x in args)
            qs, ks, vs = (x.transpose(1, 2) for x in args)
            dev_ms = device_ms(run(args), "bias_attention_kernel")
            row("bias_attention", d, shape, cuda_ms(run(args)), dev_ms, cuda_ms(run(bf16_args)),
                cuda_ms(lambda: bias_attention_plain(*args, bias, None, train, keep, rate),
                        iters=1, warmup=1),
                cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias,
                                                               dropout_p=rate)),
                fp32_bias_bounds(b, h, t, d, 0 if bias is None else bias.shape[0])
                ["bias_attention"], per_ms(4 * b * h * t * t * d, dev_ms))
        del q, k, v, args, bf16_args, qs, ks, vs, keep
        torch.cuda.empty_cache()


def fp32_bias_backward_rows(dev, row, err):
    """23k's #11b: the fp32 dq and dk/dv instances at variant N's b4 step
    (H 16, T 2000, no bias, dropout 0.1) and the single launch at the
    ViT-B/16 student's b128 T 59 (per-row keep-set bias, dropout 0.1), at D
    64 and 128, on the fp32 forward's lse and delta, against the plain
    version in fp32 (FP32_BWD_TOL; dbias check_fp32_dbias); timed at D 64
    beside the bf16 instances on the same values, the plain version and
    SDPA's forward + backward in fp32 (TF32 off; the bias as an fp32 mask
    that requires grad)."""
    from animal2vec_tpu_torch.ops.bias_attention import (
        attention_keep, bias_attention_bwd_plain, bias_attention_bwd_single, bias_attention_dkv,
        bias_attention_dq, bias_attention_forward,
    )

    rng = np.random.default_rng(SEED + 2320)
    for d in FP32_DENSE_HEAD_DIMS:
        for shape, b, h, t, bias in (
                (f"b{TRAIN_BATCH} H 16 T 2000, no bias, dropout {BIAS_DROP}", TRAIN_BATCH, 16,
                 2000, None),
                (f"b128 H 12 T {STUDENT_T} student, per-row bias, dropout {BIAS_DROP}",
                 2 * IMAGE_BATCH, IMAGE_HEADS, STUDENT_T,
                 keep_set_bias(rng, 2 * IMAGE_BATCH, IMAGE_HEADS, STUDENT_T, dev))):
            gen = torch.Generator(device=dev).manual_seed(SEED + 2321 + t + d)
            label = f"23k D {d} fp32 bias attention backward {shape}"
            drop = (BIAS_DROP, BIAS_DROP_SEED)
            keep = attention_keep(b, h, t, BIAS_DROP, BIAS_DROP_SEED, dev)
            # the fp32 values, and their bf16 roundings for the bf16 instance,
            # each with its own forward's lse and delta
            qkvg = (*fp32_dense_inputs(gen, b, h, t, d, dev),
                    torch.randn((b, t, h, d), generator=gen, device=dev))
            inputs = {}
            for dt in (torch.float32, torch.bfloat16):
                q, k, v, dout = (x.to(dt) for x in qkvg)
                out, lse = bias_attention_forward(q, k, v, bias, None, True, *drop)
                delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, t)
                inputs[dt] = (q, k, v, dout, lse, delta.contiguous(), bias, None)
            args = inputs[torch.float32]
            want = bias_attention_bwd_plain(*args, keep, BIAS_DROP)
            single = t <= 64
            if single:
                got = bias_attention_bwd_single(*args, rate=BIAS_DROP, seed=BIAS_DROP_SEED)
            else:
                dq, dbias = bias_attention_dq(*args, rate=BIAS_DROP, seed=BIAS_DROP_SEED)
                got = (dq, *bias_attention_dkv(*args, rate=BIAS_DROP, seed=BIAS_DROP_SEED), dbias)
            torch.cuda.synchronize()
            for i, what in enumerate(("dq", "dk", "dv")):
                if got[i].dtype != torch.float32:
                    raise AssertionError(f"{label}: {what} is {got[i].dtype}")
                e = check_close(f"{label} {what}", got[i], want[i], FP32_BWD_TOL)
                err("bias_single" if single else ("bias_dq" if i == 0 else "bias_dkv"), e)
            check_heads(label, ("dq", "dk", "dv"), [x.transpose(1, 2) for x in got[:3]],
                        [x.transpose(1, 2) for x in want[:3]], FP32_REL_HEAD)
            if bias is not None:
                err("bias_single" if single else "bias_dq",
                    check_fp32_dbias(f"{label} dbias", got[3], want[3]))
            del got, want
            if d == 64:
                fp32_bias_backward_times(row, shape, inputs, keep, single)
            del inputs, args, keep, qkvg
            torch.cuda.empty_cache()


def fp32_bias_backward_times(row, shape, inputs, keep, single):
    """23k's #11b rows at D 64: the fp32 launches (inputs[fp32], the
    forward's lse and delta) by CUDA events and device time, beside the
    bf16 instances on the bf16 values (inputs[bf16]), the plain version and
    SDPA's forward + backward in fp32 with the bias as an fp32 mask that
    requires grad (its own dropout_p)."""
    import torch.nn.functional as F
    from animal2vec_tpu_torch.ops.bias_attention import (
        bias_attention_bwd_plain, bias_attention_bwd_single, bias_attention_dkv,
        bias_attention_dq,
    )

    args = inputs[torch.float32]
    bias = args[6]
    b, t, h, d = args[0].shape
    q, k, v = (x.detach().clone().transpose(1, 2).requires_grad_() for x in args[:3])
    mask = None if bias is None else bias.detach().clone().requires_grad_()
    g = args[3].transpose(1, 2)

    def sdpa():
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=BIAS_DROP)
        torch.autograd.grad(o, [q, k, v] + ([] if mask is None else [mask]), g)

    library = cuda_ms(sdpa)
    plain = cuda_ms(lambda: bias_attention_bwd_plain(*args, keep, BIAS_DROP), iters=1, warmup=1)
    bounds = fp32_bias_bounds(b, h, t, d, 0 if bias is None else b, bias is not None)
    kw = dict(rate=BIAS_DROP, seed=BIAS_DROP_SEED)
    for key, fn, kernel, mult in (
            (("bias_single", bias_attention_bwd_single, "bias_attention_bwd_single", 5),)
            if single else
            (("bias_dq", bias_attention_dq, "bias_attention_dq", 3),
             ("bias_dkv", bias_attention_dkv, "bias_attention_dkv", 4))):
        run = lambda a, _fn=fn: lambda: _fn(*a, **kw)  # noqa: E731
        dev_ms = device_ms(run(args), kernel)
        row(key, d, shape, cuda_ms(run(args)), dev_ms, cuda_ms(run(inputs[torch.bfloat16])),
            plain, library, bounds[key], per_ms(mult * 2 * b * h * t * t * d, dev_ms))


def fp32_dense_kernel_rows(dev, row):
    """23k. The fp32 instances of #8, #11 and #11b against their plain
    versions in fp32 at the paths' shapes, timed (fp32_mlp_rows,
    fp32_bias_forward_rows, fp32_bias_backward_rows). Returns the largest
    error of each kernel key."""
    errs = dict.fromkeys(FP32_DENSE_KEYS, 0.0)

    def err(key, e):
        errs[key] = max(errs[key], e)

    fp32_mlp_rows(dev, row, err)
    fp32_bias_forward_rows(dev, row, err)
    fp32_bias_backward_rows(dev, row, err)
    return errs


def phase_fp32_dense(card, dev, lib_path):
    """23. JAX's default compute dtype for pre-LN, ALiBi-free and image
    encoders on the card (ROADMAP A.13, second slice): 23k the fp32
    instances of #8, #11 and #11b against their plain versions, timed; 23a
    variants N and P in fp32 (phase 16a's runs: b2 logits against the plain
    path and the bf16 model's, b32 clips/s, three b4 finetune steps, b2
    gradients; one variant P pretrain step at b8 x clone 12); 23c the
    ViT-B/16 image model in fp32 (b64 served post-LN and pre-LN, two
    PretrainConfig.vit_b16 steps at b64 x clone 2, b2 gradients). Returns
    (launches by kernel key of the main paths, errors, rows)."""
    from animal2vec_tpu_torch.config import PretrainConfig

    t0 = time.perf_counter()
    print(f"23 fp32 for pre-LN, ALiBi-free and image encoders (ROADMAP A.13) on {card}")
    rows, row = fp32_row_printer("23k")
    ptxas = [line for line in ptxas_summary((lib_path.parent / "build.log").read_text())
             if "f32>" in line and ("bias_attention" in line or "split_planes" in line)]
    for line in ptxas:
        print("  23k ptxas:", line)
    print("  " + fp32_dense_smem_line())
    errs = fp32_dense_kernel_rows(dev, row)
    parts = {"23k": time.perf_counter() - t0}
    t1 = time.perf_counter()
    launches = dict.fromkeys(_counted(), 0)
    models = {}
    for variant in OPTION_VARIANTS:
        got, models[variant] = phase_option_model(variant, card, dev, torch.float32)
        launches = {k: launches[k] + got[k] for k in launches}
    got, models["P_pretrain"] = phase_option_pretrain(card, dev, torch.float32)
    launches = {k: launches[k] + got[k] for k in launches}
    parts["23a"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    got = phase_image(card, dev, torch.float32)
    launches = {k: launches[k] + got[k] for k in launches}
    vit = PretrainConfig.vit_b16()
    label = "23c fp32 image pretrain (ViT-B/16 post-LN)"
    got = phase_pretrain(vit, card, dev, IMAGE_BATCH, label, "images", steps=2,
                         dtype=torch.float32)
    launches = {k: launches[k] + got[k] for k in launches}
    models["vit_grad_rel_max"] = phase_pretrain_grads(vit, dev, 2, label, torch.float32,
                                                      FP32_GRAD_TOL)
    parts["23c"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    for key in FP32_DENSE_KEYS:
        if key != "bias_single" and not launches[key]:
            raise AssertionError(f"23: the fp32 main paths launched no {key}")
    if not launches["bias_single"]:
        raise AssertionError("23: the fp32 image pretrain steps launched no single backward")
    seconds = time.perf_counter() - t0
    print(f"23 launches over the phase's main-path runs: {launch_line(launches)}")
    print(json.dumps({"phase23": {"rows": rows, "models": models, "launches": launches,
                                  "errors": errs, "ptxas": ptxas, "seconds": seconds,
                                  "parts": parts}}))
    print(f"23 phase {seconds:.1f} s: " + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    return launches, errs, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from animal2vec_tpu_torch.config import FinetuneConfig
    from animal2vec_tpu_torch.kernels.build import build, library

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start = time.perf_counter()

    def lap(what):
        # the script's own clock after each group of phases (its time limit
        # counts the build too)
        print(f"chip_smoke at {time.perf_counter() - start:.1f} s: {what} done", flush=True)

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    lib_path = build()
    library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")
    for line in ptxas_summary((lib_path.parent / "build.log").read_text()):
        print("  ptxas:", line)

    attn_err = phase_attention(dev)
    fwd_err, dq_err, dkv_err = phase_attention_train(dev)
    bias_err = phase_bias_attention(dev)
    bias_train = phase_bias_attention_train(dev)
    student = phase_student_attention(dev)
    fwd_err, dq_err, dkv_err = (max(a, b) for a, b in zip((fwd_err, dq_err, dkv_err), student))
    block_err = max(phase_block(dev), phase_block_train(dev))
    int8_errs = phase_int8_kernels(dev)
    mlp_errs = phase_mlp(dev)
    lap("phases 1-4")

    cfg = FinetuneConfig()
    model = build_model(cfg, dev)
    bf16_logits = phase_model(model, cfg, dev)
    serving = {"bf16": phase_serve(model, cfg, dev)}
    phase_throughput(model, card, dev)
    for mode in MODES:
        served = int8_model(model, cfg, mode, dev)
        phase_model(served, cfg, dev, mode, bf16_logits)
        serving[mode] = phase_serve(served, cfg, dev, mode)
        phase_throughput(served, card, dev, mode)
        del served
    del model
    torch.cuda.empty_cache()
    times, b32_errs = phase_kernel_times(dev)
    attn_err = max(attn_err, b32_errs["attention"])
    block_err = max(block_err, b32_errs["block"])
    training = phase_train(cfg, card, dev)
    phase_train_grads(cfg, dev)
    lap("phases 5-8")
    image = phase_image(card, dev)
    lap("phase 9")

    from animal2vec_tpu_torch.config import ImageConfig, PretrainConfig

    vit = PretrainConfig.vit_b16()
    pre_image = phase_pretrain(vit, card, dev, IMAGE_BATCH, "image pretrain (ViT-B/16 post-LN)",
                               "images")
    phase_pretrain_grads(vit, dev, 2, "image pretrain (ViT-B/16 post-LN)")
    vit_pre_ln = PretrainConfig.vit_b16(
        model=ImageConfig(use_alibi_encoder=True, layer_norm_first=True))
    pre_image_ln = phase_pretrain(vit_pre_ln, card, dev, IMAGE_BATCH,
                                  "image pretrain (ViT-B/16 pre-LN)", "images", pre_ln=True,
                                  steps=1)
    a2v = PretrainConfig()
    pre_audio = phase_pretrain(a2v, card, dev, 5, "audio pretrain (a2v-large, "
                               "a2v_large_pretrain.yaml)", "10-s clips")
    phase_pretrain_grads(a2v, dev, 1, "audio pretrain (a2v-large)")
    lap("phases 10-11")
    pretrain = {k: pre_image[k] + pre_image_ln[k] + pre_audio[k] for k in pre_image}
    entry_launches = phase_entry(card, dev)
    lap("phase 12")
    torch.cuda.empty_cache()
    serving_entry = phase_serving_entry(card, dev)
    lap("phase 13")
    torch.cuda.empty_cache()
    ring_row, ring_launches, ring_err = phase_ring(dev)
    torch.cuda.empty_cache()
    dp_step = phase_dp_step(card, dev)
    phase_dp_entry(card, dev)
    lap("phase 14")
    print("dp: train_cli's default group on the card is NCCL with one rank (phase 12's four "
          "train_cli runs, checked there)")
    torch.cuda.empty_cache()
    remat_rows = phase_remat(card, dev)
    teacher_launches = phase_teacher(card, dev)
    drop_errs, drop_rows = phase_bias_dropout(dev)
    print(f"15c the ViT-B/16 pretrain steps of phase 10 ran with attention_dropout "
          f"{vit.attention_dropout} (the dense-bias kernels' hash dropout)")
    tokens = phase_tokens(card, dev)
    config_launches = phase_config_cli(card, dev)
    print(json.dumps({"phase15": {"remat": remat_rows, "tokens": tokens}}))
    lap("phase 15")
    torch.cuda.empty_cache()
    option_launches, option_int8_launches, option_errs, option_rows = phase_options(card, dev)
    lap("phase 16")
    torch.cuda.empty_cache()
    a7_launches, _ = phase_a7(card, dev)
    lap("phase 17")
    torch.cuda.empty_cache()
    probe_launches, probe_checks, probe_rows = phase_probes(card, dev)
    lap("phase 18")
    torch.cuda.empty_cache()
    a10_launches, a10_errs, a10_rows = phase_a10(card, dev)
    lap("phase 19")
    torch.cuda.empty_cache()
    widths_launched, width_errs, width_rows = phase_widths(card, dev, lib_path)
    lap("phase 20")
    torch.cuda.empty_cache()
    head_launched, head_errs, head_rows = phase_head_dims(card, dev, lib_path)
    lap("phase 21")
    torch.cuda.empty_cache()
    fp32_launched, fp32_errs, fp32_rows = phase_fp32(card, dev, lib_path, bf16_logits)
    lap("phase 22")
    torch.cuda.empty_cache()
    dense_launched, dense_errs, dense_rows = phase_fp32_dense(card, dev, lib_path)
    lap("phase 23")

    def entry(name, source, replaces, launches, serving_launches, err, key, serving_key=None):
        # source: the .cu file, then the csrc headers its kernels are built on
        cu, *headers = source.split(" + ")
        e = {"name": name, "route": "cuda", "source": f"animal2vec_tpu_torch/csrc/{cu}",
             "replaces": replaces, "launches": launches, "launches_serving": serving_launches,
             "max_abs_err": err, **times[key]}
        if headers:
            e["headers"] = [f"animal2vec_tpu_torch/csrc/{h}" for h in headers]
        if serving_key:
            e.update({f"serving_{k}": v for k, v in times[serving_key].items()})
        return e

    def int8_entry(name, source, replaces, counted, err, key, extra_key=None):
        # launches: the int8 serving runs (three recordings in each int8 mode)
        per_mode = {f"launches_{m}": serving[m][counted] for m in MODES}
        e = entry(name, source, replaces, sum(per_mode.values()), serving["bf16"][counted], err,
                  key)
        e.update(per_mode)
        if extra_key:
            e.update({f"out_proj_{k}": v for k, v in times[extra_key].items()})
        return e

    pa = "animal2vec_tpu/ops/pallas_attention.py"
    fa = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    kernels = [
        # the serving kernel: the bf16 and int8 serving runs' launches and the
        # pretraining teacher's ("launches_pretrain" below)
        dict(entry("alibi_flash_attention_serve", "alibi_attention_fwd.cu", f"{pa}:891",
                   serving["bf16"]["serve_attention"] + serving["int8"]["serve_attention"],
                   serving["bf16"]["serve_attention"], attn_err,
                   "attention forward, b32 serving"),
             launches_int8=serving["int8"]["serve_attention"]),
        dict(entry("alibi_flash_attention", "alibi_attention_fwd.cu", f"{pa}:113", training[0], 0,
                   fwd_err, f"attention forward + lse + dropout, b{TRAIN_BATCH} training"),
             **{f"student_{k}": v for k, v in times[
                 "attention forward + lse + dropout, b60 T 125 pretrain student"].items()}),
        entry("alibi_attention_dq", "alibi_attention_bwd.cu", f"{pa}:330", training[1], 0,
              dq_err, f"attention dq + slope partials, b{TRAIN_BATCH} training"),
        entry("alibi_attention_dkv", "alibi_attention_bwd.cu", f"{pa}:390", training[2], 0,
              dkv_err, f"attention dk/dv, b{TRAIN_BATCH} training"),
        dict(entry("fused_block", "fused_block.cu", "animal2vec_tpu/ops/fused_mlp.py:175",
                   training[3], serving["bf16"]["block"], max(block_err, mlp_errs["block"]),
                   f"fused block + dropout, N {TRAIN_BATCH * 2000} training",
                   "fused block, b32 serving"), launches_image=image["block"],
             **{f"image_{k}": v for k, v in times["fused block, b64 ViT-B serving"].items()},
             **{f"student_{k}": v for k, v in times[
                 "fused block + dropout, N 7500 pretrain student"].items()}),
        int8_entry("int8_dense", "int8_dense.cu", "animal2vec_tpu/ops/int8_mm.py:60",
                   "int8_dense", int8_errs["dense"],
                   "int8 dense qkv projection, b32 serving",
                   "int8 dense out projection, b32 serving"),
        dict(int8_entry("fused_block_int8", "fused_block_int8.cu",
                        "animal2vec_tpu/ops/fused_mlp.py:273", "int8_block",
                        max(int8_errs["block"], mlp_errs["int8_block"], b32_errs["int8_block"]),
                        "int8 fused block, b32 serving"), launches_image=image["int8_block"],
             **{f"image_{k}": v for k, v in times["int8 fused block, b64 ViT-B serving"].items()}),
        int8_entry("alibi_flash_attention_int8", "alibi_attention_int8.cu", f"{pa}:715",
                   "int8_attention", max(int8_errs["attention"], b32_errs["int8_attention"]),
                   "int8 attention, b32 serving"),
        # its quantization pass, bit for bit quantize_qkv_int8 (checked in
        # phases 4c and 7: a disagreement fails there)
        int8_entry("quantize_qkv_int8_pass", "alibi_attention_int8.cu",
                   f"{pa}:816 (alibi_flash_attention_int8's quantization of q, k, v)",
                   "int8_quant", 0.0, "int8 q, k, v quantization pass, b32 serving"),
        # the image kernels: launches of phase 9's six checked b64 forwards (whose
        # post-LN runs also launch #6 and #7: "launches_image" below)
        entry("fused_mlp", "fused_mlp.cu", "animal2vec_tpu/ops/fused_mlp.py:112", image["mlp"],
              image["mlp"], mlp_errs["mlp"], "fused MLP, b64 ViT-B serving"),
        entry("fused_mlp_int8", "fused_mlp_int8.cu + int8_gemm_sm90.cuh + int8_quant.cuh",
              "animal2vec_tpu/ops/fused_mlp.py:66", image["int8_mlp"], image["int8_mlp"],
              mlp_errs["int8_mlp"], "int8 fused MLP, b64 ViT-B serving"),
        dict(entry("bias_flash_attention", "bias_attention.cu",
                   "animal2vec_tpu/models/attention.py:115 (jax.experimental.pallas.ops.tpu."
                   "flash_attention)", image["bias_attention"] + pretrain["bias_attention"],
                   image["bias_attention"], max(bias_err, bias_train["forward"]),
                   "bias attention, b64 ViT-B serving"),
             launches_pretrain=pretrain["bias_attention"],
             **{f"training_{k}": v for k, v in times[
                 "bias attention forward + lse, b128 ViT-B pretraining student"].items()}),
        # the image student's backward (#11b): at its T 59 one launch computes
        # what the TPU's two kernels do; the dq + dbias and dk/dv launches,
        # the route for T > 64 that no main path takes, are held in phase 3d
        # and timed at the same shape ("two_launch_*")
        dict(entry("bias_attention_bwd_single", "bias_attention_bwd.cu + sm90.cuh",
                   f"{fa}:1287 (_flash_attention_bwd_dq, with ds) and {fa}:941 "
                   f"(_flash_attention_bwd_dkv), via {fa}:254-315 _flash_attention_bwd",
                   pretrain["bias_single"], 0,
                   max(bias_train["single"], bias_train["dq"], bias_train["dkv"]),
                   "bias attention single backward launch, b128 ViT-B pretraining student"),
             **{f"two_launch_{part}_{k}": v for part, key in (
                 ("dq", "bias attention dq + dbias"), ("dkv", "bias attention dk/dv"))
                for k, v in times[f"{key}, b128 ViT-B pretraining student"].items()}),
    ]
    # the pretraining paths' launches (phases 10 and 11) and the training
    # entry point's (phase 12) of the kernels that earlier paths launch too
    for e, key in zip(kernels, ("serve_attention", "attention", "dq", "dkv", "block", None, None,
                                None, None, "mlp")):
        if key:
            e["launches_pretrain"] = pretrain[key]
            e["launches_entry"] = entry_launches[key]
            e["launches"] += pretrain[key] + entry_launches[key]
    # #2 with key positions: phase 14a's ring
    kernels.append({
        "name": "alibi_flash_attention_lse", "route": "cuda",
        "source": "animal2vec_tpu_torch/csrc/alibi_attention_fwd.cu",
        "replaces": f"{pa}:113 (with positions_k, via animal2vec_tpu/ops/ring_attention.py:63-75)",
        "launches": ring_launches, "max_abs_err": ring_err, **ring_row})
    # phase 14b's two-rank step (rank 0's launches)
    kernels[1]["launches_dp_step_rank0"] = dp_step["finetune"]["launches"]["alibi_train"]
    kernels[4]["launches_dp_step_rank0"] = dp_step["finetune"]["launches"]["fused_block"]
    # the serving entry points' (phase 13: export_cli twice, one forward of
    # each bundle in its serving process)
    for e, key in zip(kernels, ("serve_attention", None, None, None, "block", "int8_dense",
                                "int8_block", "int8_attention", "int8_quant")):
        if key:
            e["launches_serving_entry"] = serving_entry[key]
            e["launches"] += serving_entry[key]
    # phase 15: the int8 teachers' launches (15b), train_cli --config (15e),
    # the dense-bias kernels with dropout (15c)
    by_name = {e["name"]: e for e in kernels}
    for name, key in (("int8_dense", "int8_dense"), ("fused_block_int8", "int8_block"),
                      ("alibi_flash_attention_int8", "int8_attention"),
                      ("quantize_qkv_int8_pass", "int8_quant"),
                      ("alibi_flash_attention_serve", "serve_attention")):
        n = sum(teacher_launches[m][key] for m in MODES)
        by_name[name]["launches_teacher"] = n
        by_name[name]["launches"] += n
    for e, key in zip(kernels, ("serve_attention", "attention", "dq", "dkv", "block", None, None,
                                None, None, "mlp")):
        if key:
            e["launches_config_cli"] = config_launches[key]
            e["launches"] += config_launches[key]
    for name, t in (("bias_flash_attention", IMAGE_T), ("bias_attention_bwd_single", STUDENT_T)):
        b = IMAGE_BATCH if t == IMAGE_T else 2 * IMAGE_BATCH
        row = drop_rows[f"bias attention forward + backward, dropout {BIAS_DROP}, b{b} T {t}"]
        by_name[name].update({f"dropout_{k}": v for k, v in row.items() if k != "forward"})
        by_name[name].update({f"dropout_forward_{k}": v for k, v in row["forward"].items()})
    by_name["bias_flash_attention"]["max_abs_err"] = max(
        by_name["bias_flash_attention"]["max_abs_err"], drop_errs["forward"])
    by_name["bias_attention_bwd_single"]["max_abs_err"] = max(
        by_name["bias_attention_bwd_single"]["max_abs_err"], drop_errs["single"],
        drop_errs["dq"], drop_errs["dkv"])
    # phase 16: the encoder options' main-path runs (variants P and N serving
    # and finetuning, the variant P pretrain step) and the changed kernels'
    # rows; #11b's dq and dk/dv routes get their first main-path launches
    # (the ALiBi-free finetune step at T 2000)
    for name, key in (("alibi_flash_attention_serve", "serve_attention"),
                      ("alibi_flash_attention", "attention"), ("alibi_attention_dq", "dq"),
                      ("alibi_attention_dkv", "dkv"), ("fused_block", "block"),
                      ("fused_mlp", "mlp"), ("bias_flash_attention", "bias_attention")):
        by_name[name]["launches_options"] = option_launches[key]
        by_name[name]["launches"] += option_launches[key]
    n16 = TRAIN_BATCH * 2000
    for name, key, prefix in (
            ("fused_mlp", f"fused MLP, N {n16} a2v-large widths", "a2v"),
            ("fused_mlp", f"fused MLP + dropout {OPTION_ACT_DROP}, N {n16} a2v-large widths",
             "a2v_dropout"),
            ("fused_block", f"fused block + drop-path scale, N {n16}", "drop_path"),
            ("bias_flash_attention", "bias attention, no bias, b32 T 2000", "no_bias_b32")):
        by_name[name].update({f"{prefix}_{k}": v for k, v in option_rows[key].items()})
    for name, key in (("fused_mlp", "mlp"), ("fused_block", "block"),
                      ("bias_flash_attention", "bias_attention")):
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], option_errs[key])
    # phase 16i: variants P and N served in int8 and int8_attn (ROADMAP A.12)
    for name, key in (("alibi_flash_attention_serve", "serve_attention"),
                      ("alibi_flash_attention_int8", "int8_attention"),
                      ("quantize_qkv_int8_pass", "int8_quant"),
                      ("fused_block_int8", "int8_block"), ("fused_mlp_int8", "int8_mlp"),
                      ("int8_dense", "int8_dense"), ("bias_flash_attention", "bias_attention")):
        by_name[name]["launches_options_int8"] = option_int8_launches[key]
        by_name[name]["launches"] += option_int8_launches[key]
    # phase 7: #9 at a2v-large's widths
    by_name["fused_mlp_int8"].update(
        {f"a2v_{k}": v for k, v in times["int8 fused MLP, b32 a2v-large widths"].items()})
    by_name["fused_mlp_int8"]["max_abs_err"] = max(by_name["fused_mlp_int8"]["max_abs_err"],
                                                   b32_errs["int8_mlp"])
    # phase 17: the rest of pretraining's main-path runs (the option step and
    # the recipe's default step, the ViT-B/16 recon step, train_cli --config)
    for name, key in (("alibi_flash_attention_serve", "serve_attention"),
                      ("alibi_flash_attention", "attention"), ("alibi_attention_dq", "dq"),
                      ("alibi_attention_dkv", "dkv"), ("fused_block", "block"),
                      ("bias_flash_attention", "bias_attention"),
                      ("bias_attention_bwd_single", "bias_single")):
        by_name[name]["launches_a7"] = a7_launches[key]
        by_name[name]["launches"] += a7_launches[key]
    for what, line in (("dq", 1287), ("dkv", 941)):
        kernels.append(dict(
            {"name": f"bias_attention_{what}", "route": "cuda",
             "source": "animal2vec_tpu_torch/csrc/bias_attention_bwd.cu",
             "replaces": f"{fa}:{line} (_flash_attention_bwd_{what})",
             "launches": option_launches[f"bias_{what}"] + a7_launches[f"bias_{what}"],
             "launches_a7": a7_launches[f"bias_{what}"],
             "max_abs_err": max(option_errs[f"bias_{what}"], bias_train[what])},
            **option_rows[f"bias attention {what}, no bias, b{TRAIN_BATCH} T 2000"]))
    # phase 18: the probes
    kernels += probe_entries(probe_launches, probe_checks, probe_rows)
    # phase 19: the tensor-parallel split of #6 and the head-offset launches
    kernels += a10_entries(a10_launches, a10_errs, a10_rows)
    # phase 20: W and T served and stepped, and the kernels at W's widths
    for name, key in (("alibi_flash_attention_serve", "serve_attention"),
                      ("alibi_flash_attention", "attention"), ("alibi_attention_dq", "dq"),
                      ("alibi_attention_dkv", "dkv"), ("fused_block", "block"),
                      ("int8_dense", "int8_dense"), ("fused_block_int8", "int8_block"),
                      ("alibi_flash_attention_int8", "int8_attention"),
                      ("quantize_qkv_int8_pass", "int8_quant"),
                      ("bias_flash_attention", "bias_attention")):
        by_name[name]["launches_widths"] = widths_launched[key]
        by_name[name]["launches"] += widths_launched[key]
    for name, prefix, key in (
            ("fused_block", "wide", f"fused block C {WIDE_C}, b32 serving"),
            ("fused_block", "wide_training", f"fused block + dropout C {WIDE_C}, "
                                             f"N {TRAIN_BATCH * 2000} training"),
            ("fused_block_int8", "wide", f"int8 fused block C {WIDE_C}, b32 serving"),
            ("alibi_flash_attention_serve", "h20", "attention forward H 20, b32 serving"),
            ("int8_dense", "k1280_qkv", f"int8 dense qkv projection K {WIDE_C}, b32 serving"),
            ("int8_dense", "k1280_out", f"int8 dense out projection K {WIDE_C}, b32 serving")):
        by_name[name].update({f"{prefix}_{k}": v for k, v in width_rows[key].items()})
    for name, key in (("fused_block", "block"), ("fused_block_int8", "int8_block"),
                      ("alibi_flash_attention_serve", "attention"), ("int8_dense", "dense")):
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], width_errs[key])
    split = width_rows[f"split #6 (fc1, fc2 partial, ln2) C {WIDE_C}, N {32 * 2000}, "
                       "dropout 0.1"]
    for e in kernels:
        if e["name"] in ("block_fc1", "block_fc2_partial", "block_ln2"):
            e["max_abs_err"] = max(e["max_abs_err"], width_errs["split"])
            e.update({f"wide_chain_{k}": v for k, v in split.items()})
    # phase 21: the head dims' main-path runs (21a-21d) and each attention
    # kernel's rows and errors at the new head dims (21k)
    by_name = {e["name"]: e for e in kernels}
    for name, key in (("alibi_flash_attention_serve", "serve_attention"),
                      ("alibi_flash_attention", "attention"), ("alibi_attention_dq", "dq"),
                      ("alibi_attention_dkv", "dkv"),
                      ("alibi_flash_attention_int8", "int8_attention"),
                      ("quantize_qkv_int8_pass", "int8_quant"),
                      ("bias_flash_attention", "bias_attention"),
                      ("bias_attention_bwd_single", "bias_single"),
                      ("bias_attention_dq", "bias_dq"), ("bias_attention_dkv", "bias_dkv"),
                      ("fused_block", "block"), ("fused_mlp", "mlp"), ("int8_dense", "int8_dense"),
                      ("fused_block_int8", "int8_block")):
        e = by_name[name]
        e["launches_head_dims"] = head_launched[key]
        e["launches"] += head_launched[key]
        if key in HEAD_DIM_KEYS:
            e["max_abs_err_head_dims"] = head_errs[key]
            e["max_abs_err"] = max(e["max_abs_err"], head_errs[key])
            e["head_dims"] = {f"D {d}": head_rows[f"{key} D {d}"] for d in HEAD_DIMS_TIMED
                              if f"{key} D {d}" in head_rows}
    # phase 22: the fp32 instances of #1-#4 and #6 (ROADMAP A.13): their
    # launches on the fp32 main paths (22a-22c), their errors and 22k's rows
    # at the main paths' shapes (fp32_*; the bf16 instance's ms on the same
    # values beside them), every 22k row under fp32_rows
    for name, key, shape in (
            ("alibi_flash_attention_serve", "serve_attention",
             "D 64, b32 H 16 T 2000 serving, in place"),
            ("alibi_flash_attention", "attention", f"D 64, b{TRAIN_BATCH} H 16 T 2000 training, "
                                                   f"dropout {ATTN_DROP}"),
            ("alibi_attention_dq", "dq", f"D 64, b{TRAIN_BATCH} H 16 T 2000 training, "
                                         f"dropout {ATTN_DROP}"),
            ("alibi_attention_dkv", "dkv", f"D 64, b{TRAIN_BATCH} H 16 T 2000 training, "
                                           f"dropout {ATTN_DROP}"),
            ("fused_block", "block", ", N 64000, C 1024, M 4096")):
        e = by_name[name]
        e["fp32_launches"] = fp32_launched[key]
        e["launches"] += fp32_launched[key]
        e["fp32_max_abs_err"] = fp32_errs[key]
        e.update({f"fp32_{k}": v for k, v in fp32_rows[f"{key} {shape}".replace(" ,", ",")].items()
                  if k != "shape"})
        e["fp32_rows"] = {k: v for k, v in fp32_rows.items()
                          if k.startswith(f"{key} ") or k.startswith(f"{key},")}
    # phase 23: the fp32 instances of #8, #11 and #11b (ROADMAP A.13, second
    # slice): their errors and 23k's rows (fp32_*, the main path's shape
    # first; every row under fp32_rows), and every kernel's launches on the
    # fp32 paths of variants N and P and the ViT-B/16 model (23a, 23c)
    for name, key, shape in (
            ("fused_mlp", "mlp", ", N 64000, C 1024, M 4096"),
            ("bias_flash_attention", "bias_attention", "D 64, b32 H 16 T 2000 serving, no bias"),
            ("bias_attention_dq", "bias_dq", f"D 64, b{TRAIN_BATCH} H 16 T 2000, no bias, "
                                             f"dropout {BIAS_DROP}"),
            ("bias_attention_dkv", "bias_dkv", f"D 64, b{TRAIN_BATCH} H 16 T 2000, no bias, "
                                               f"dropout {BIAS_DROP}"),
            ("bias_attention_bwd_single", "bias_single",
             f"D 64, b128 H 12 T {STUDENT_T} student, per-row bias, dropout {BIAS_DROP}")):
        e = by_name[name]
        e["fp32_max_abs_err"] = dense_errs[key]
        e.update({f"fp32_{k}": v for k, v in
                  dense_rows[f"{key} {shape}".replace(" ,", ",")].items() if k != "shape"})
        e["fp32_rows"] = {k: v for k, v in dense_rows.items()
                          if k.startswith(f"{key} ") or k.startswith(f"{key},")}
    for name, key in (("alibi_flash_attention_serve", "serve_attention"),
                      ("alibi_flash_attention", "attention"), ("alibi_attention_dq", "dq"),
                      ("alibi_attention_dkv", "dkv"), ("fused_block", "block"),
                      ("fused_mlp", "mlp"), ("bias_flash_attention", "bias_attention"),
                      ("bias_attention_dq", "bias_dq"), ("bias_attention_dkv", "bias_dkv"),
                      ("bias_attention_bwd_single", "bias_single")):
        by_name[name]["launches_fp32_families"] = dense_launched[key]
        by_name[name]["launches"] += dense_launched[key]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
