#!/usr/bin/env python3
"""Run the PyTorch port (stablemtl_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py             # all phases
    python3 chip_smoke.py --profile   # all phases, plus device time by
                                      # kernel over one inference step, one
                                      # training micro-step and one serving
                                      # step

Phases (any failure exits non-zero before the result line):
1. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch version at the main paths'
   shapes, ragged sequences (S=1672, 1100) and the other presets' head
   dims, bf16 and f32, fast softmax on and off, and time it beside its
   bound, the plain version and torch's scaled_dot_product_attention (a
   yardstick the port never calls); K6 (fused GEGLU) at the serving step's
   four feed-forward shapes, timed beside F.linear of its whole
   projection, at ragged row counts with the small and tiny presets'
   C (160, 32), and at phase 11c's local F of a model-2 rank, both gelus;
   then the JAX package's variants of K1, K2 and K3, each instance of
   STABLEMTL_FLASH_POLY_EXP (3, 4) and STABLEMTL_FLASH_MXU_LSUM (K1, K3;
   alone and with degree 3) at K1's main, ragged and small-head shapes,
   K3's training and ragged shapes and K2's decode and small-preset
   shapes, bf16 and f32, both softmax modes: against the plain variant on
   the kernel's key tiles, and, where the variant moves the result past
   the kernels' rounding (f32, and K3's lse), VARIANT_FACTOR times closer
   to it than to the plain default; every bf16 instance also on crafted
   inputs where each variant moves the bf16 output (CRAFT_ULPS), at each
   head dim, VARIANT_FACTOR times closer to its plain variant than to the
   plain default and every other variant; each variant timed at the main
   shapes beside the default in turns;
3. fused all-task inference at full SD2 width, 512x512, bf16, fast math,
   with launch counters reset before and read after; a second bf16 step
   holds every kernel call against the plain version on that call's own
   inputs; the output is held against the same pipeline with
   STABLEMTL_DISABLE_FLASH=1 (plain attention on the card) and against both
   paths on the same weights in f32, then timed at batch 1 and 2; then the
   batch-1 step with STABLEMTL_FLASH_POLY_EXP=3 and
   STABLEMTL_FLASH_MXU_LSUM=1 (the default's launches, every kernel call
   against its plain variant, no further from f32 than the bf16 plain
   path, ms beside the default in turns) and with STABLEMTL_NO_FUSED_QKV=1
   (the default's launches, the same ratio test);
4. the multi-stream training step at full SD2 width (create_train_state,
   make_train_step) with the flagship trainer settings: 288x384, micro-batch
   2, accumulation 2, bf16 compute over f32 master weights, Adam at lr 1e-4
   under IterExponential, clip 5.0, task masking attn_prob at 0.4. Four
   micro-steps with counters reset before and read after; finite losses and
   gradients; parameters unchanged by the first update (lr(0) = 0 under
   warmup) and changed by the second; every kernel call of a bf16
   micro-step held against its plain version on its own inputs; in f32 at
   batch 1, the loss and every main-UNet gradient with flash against
   STABLEMTL_DISABLE_FLASH=1 on the same weights, batch and generator; a
   bf16 micro-step under STABLEMTL_FLASH_POLY_EXP=3 and _MXU_LSUM=1 with
   every kernel call against its plain variant, and in f32 at batch 1 its
   loss and gradients within TRAIN_VARIANT_* of the default's and not equal
   to them; then ms per micro-step, train images/s and peak memory;
5. serving at full SD2 width, 512x512, with STABLEMTL_FUSED_GEGLU=1 (K6 on
   every feed-forward): the flagship config (train_stablemtl.yaml merged:
   bf16, exact softmax, erf gelu) written as a run directory; the serve
   CLI on 2 PNGs (--batch 2 --save_npz, 7 PNGs and one npz per image);
   ServingSession(batch=2) under a burst of 5 requests from 2 threads with
   counters reset before (K6 launches = 32 per step, K1 and K2 > 0, K3-K5
   0), each result bit-equal to infer_all_tasks of the batch its step ran
   and to itself beside a copy of itself at the same row, every K6 call of
   a bf16 step against its plain version, images/s and single-request
   latency; in f32 with cuDNN's deterministic algorithms, K6 against the
   plain GEGLU on the same weights at batch 1, and at batch 2 a request
   bit-equal whatever its mate and its row;
6. the training and evaluation entry points at full SD2 width: a synthetic
   tree written from a seed (vkitti frames at 375x1242 with depth, normal
   and semantic labels, hypersim at 288x384, one KITTI flow 2015 pair), and
   the flagship recipe (config/train_stablemtl.yaml, bf16) overlaid with a
   two-entry mixture (vkitti depth at its 187x621 resize, hypersim normal),
   micro-batch 2, accumulation 2, max_iter 2, save_period 2. cli.train
   (2 loader worker processes) runs 4 micro-steps and one save; cli.train
   again with --max_iter 3 resumes at micro-step 4 and runs micro-steps 5
   and 6 and the final save; cli.eval on the run directory (a vkitti depth
   set and the multi-task KITTI flow set, both at the KITTI validation
   geometry 176x608) restores the parameters only,
   bit-equal to the trainer's; cli.serve --checkpoint on one PNG. K3-K5
   must launch in training, K1 and K2 in eval; losses and metrics finite;
   the bytes and seconds of each save and restore, and the host ms per
   micro-step inside the CLI beside phase 4's, are printed;
7. weights without JAX, activation recompute and the single-chip recipe,
   at full SD2 width: a synthetic SD2 directory written from a seed
   (tools/torch_make_synthetic_sd2.py: UNet as .safetensors, VAE and text
   encoder as .bin, a BPE tokenizer) and a reference-style multi-stream
   .pth; `python -m stablemtl_tpu_torch.cli.convert_sd2` run in processes
   of their own on it, plain and with --unet_pth; the f32 flagship pipeline
   built from the output, every parameter bit-equal to its source (SD2's
   conv_in inflated 4 -> 12 for the child, the reference banks stacked for
   the main UNet), then one batch-1 512x512 infer_all_tasks, finite, K1
   and K2 launched. Phase 4's recipe under remat off, remat + full and
   remat + dots (ms per micro-step, peak memory, K3-K5 launches per
   micro-step: K3 10 under recompute), and in f32 at batch 1 with
   deterministic cuDNN the loss and every main-UNet gradient under full
   and dots against off (relative L2 <= 1e-6, the generator's state after
   the step equal). Adafactor + remat full + bf16 at micro-batch 2 (the
   JAX package's single-chip recipe), then the flagship's micro-batch 16
   (accumulation 2) with it: peak memory and ms; Adam with mu_dtype
   bfloat16; skip_nonfinite_updates 3 with a NaN planted in one
   accumulated gradient: skipped, nothing moves, optax's counters;
8. the serving artifact at full SD2 width, 512x512, in phase 5's
   configuration (K6 on): `python -m stablemtl_tpu_torch.cli.serve
   --export` in processes of their own, single frame at batch 2 and
   --pair at batch 1 (each JSON line checked, each artifact below 1 % of
   the bundle's bytes); meanwhile the same seeded pipeline here, exported
   once more with every counter at 0 (exporting launches nothing, its
   seconds printed), and its weight bundle and seeded inputs written to a
   temporary file. A fresh process reads them, loads each artifact with
   `serving.load_exported` and runs it: no JAX imported, no model module
   built; launches of one step with the counters at 0, load seconds, ms
   per step. Here eager `infer_all_tasks` on the same weights and inputs:
   the artifact's output finite and within relative L2 1e-3 (max|diff|
   printed), its launches equal to eager's (at batch 2 K1 and K2 > 0, K6
   32, K3-K5 0), and ms per step beside eager's;
9. data parallelism across processes (`stablemtl_tpu_torch/parallel/`),
   after a check that the card's compute mode lets processes share it:
   (a) a process group of one rank on NCCL through the env contract here,
   `make_sharded_train_step(zero1=True)` against `make_train_step` on the
   same weights and phase 4's recipe and micro-batches: losses and
   parameters bit-equal, ms per micro-step beside the plain step's, K1-K5
   launches, peak memory, bytes all-reduced; (b) `cli.train` as 2 ranks
   in processes of their own sharing the card over gloo (phase 6's tree
   and recipe, ZeRO-1, 1 row a rank, accumulation 2, max_iter 1): both
   ranks finish on the same parameters (digests), rank 0 alone writes the
   run files and the one save, K3-K5 launch on each rank, ms per
   micro-step, peak memory, bytes all-reduced and staged through the
   host; then `cli.train --max_iter 2` here on one process resumes the
   2-rank checkpoint (its ZeRO-1 slices gathered over gloo) and runs
   micro-steps 3-4 without saving, each loss within 5e-3 of phase 6's;
   (c) 2 gloo ranks in f32
   with deterministic cuDNN, 1 row a rank, `highest` masking at ratio 1
   and unequal valid masks: the loss (1e-6 relative) and the all-reduced
   main-UNet gradients (1e-5 relative L2) against one process on the
   global batch of 2; then phase 4's bf16 recipe at 1 row a rank, peak
   memory with ZeRO-1 off and on;
10. serving over replicas (`ServingSession(mesh=)`, `export_pipeline(
   mesh=)`), in phase 3's configuration with K6 on, as 2 replicas sharing
   cuda:0 (`host_local_mesh(devices=...)`; `host_local_mesh(2)` must
   raise on a one-card machine, a batch of 3 too): (a) 4 requests into
   ServingSession(batch=2) with every counter at 0, each result bit-equal
   to infer_all_tasks of its image at batch 1, K1 40, K2 4 and K6 64
   launches per session step; (b) the mesh artifact at batch 2, loaded,
   `nr_devices` 2, called on one bundle per replica: its rows bit-equal to
   (a), each replica's program holding its tensors on its device; (c) ms
   per session step, 2 replicas against one replica at batch 2, in turns;
   (d) meanwhile, in processes of their own, `python -m
   stablemtl_tpu_torch.preprocess.flyingthings3d` on a raw split at
   540x960 and `...vkitti` on a split file (and `...hypersim` where h5py
   imports), none importing JAX; every FT3D sample read back through the
   port's datasets equal to `preprocess_ft3d_sample` of the raw files; the
   vKITTI lists; `depth_to_normal` on a plane; (e) `utils.profiling.trace`
   around one 2-replica session step: the trace file, the top kernels,
   K1's and K2's launches in it;
11. tensor parallelism (`parallel/tensor_parallel.py`): 2 ranks in
   processes of their own sharing the card over gloo as the model axis of
   a 1 x 2 mesh, the flagship training recipe at 512x512, micro-batch 1,
   accumulation 2 (stage 0's 5 heads gathered, stage 1's 10 split 5 a
   rank). Here, one process first: the no-grad main-UNet forward in bf16
   with K6 and in f32, and 4 micro-steps of `make_train_step` (losses, ms,
   peak). Then the ranks: (c) the same forward on the sliced weights with
   K6 (K6 at the local F, K1 at 5 local heads), no further from the f32
   one than the one process's bf16 forward (phase 3's ratio); (a)
   `make_sharded_train_step(zero1=True)` at model 2 on the same weights and
   micro-batches: each loss within 5e-3 of the one process's, K3-K5 at
   [5, 1024, 64] and [5, 4096, 64], ms, peak memory and model-axis bytes a
   micro-step, the whole parameters bit-equal on both ranks after; (b) in
   f32 at 288x384, micro-batch 1, deterministic cuDNN: the loss (1e-5
   relative) and the gradients gathered whole (1e-4 relative L2) against
   one process; (d) `cli.train` with `parallel: {model: 2}` as 2 ranks on
   phase 6's tree (2 micro-steps, one save recording model 2), then one
   process resuming it, saving nothing: each loss within 5e-3 of phase
   6's.

It prints the card's name and power limit from nvidia-smi, a JSON line
{"kernels": [...]}, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, FP32
# outside them, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 instructions a second outside the tensor cores: the data sheet's
# FP32 rate counts an FMA as 2 FLOPs (128 lanes an SM, 132 SMs, at the
# 1.98 GHz boost clock that rate implies). The special-function units'
# exp2 runs at 16 a clock an SM, an eighth of it.
PEAK_FP32_INSTR = PEAK_F32_FLOPS / 2
PEAK_EXP2 = PEAK_FP32_INSTR / 8
# The FP32 instructions exp2_poly (csrc/flash_common.cuh) takes a score, by
# degree: max, add in round-down mode, two subtracts, 3 or 4 FMAs and the
# multiply by 2^n (its two integer operations run beside them)
POLY_FP32_OPS = {3: 8, 4: 9}
# (max |err|, relative L2 ||err|| / ||ref||) by which a kernel may differ
# from its plain version. In bf16 both round p and o at the same points, so
# they differ by summation order and single output ulps: on the H100,
# max|err| <= 1.95e-3 (one ulp at |o| in [0.25, 0.5)) and relative L2
# <= 2.4e-3 on N(0, 1) inputs, whose outputs are ~0.026 (RMS). A kernel
# that skips one 64-key tile of 4096 measured 0.127 relative L2, one that
# drops the 8-key ragged tail at S=1672 0.071.
TOL = {"bfloat16": (4e-3, 5e-3), "float32": (2e-5, 1e-5)}
# (max |err|, relative L2) of K3's o and lse and of K4/K5's gradients
# against their plain versions, by dtype. Measured on the H100 over every
# phase-2 case (N(0, 1) inputs, gradients up to ~1.2 in magnitude): lse
# max|err| <= 1.9e-6 and relative L2 <= 4.1e-8 in both dtypes; gradients
# in bf16 max|err| <= 1.95e-3 (one ulp at |g| in [0.25, 0.5)) and relative
# L2 <= 2.0e-4, in f32 <= 4.2e-7 and <= 3.1e-7. A K3 that writes each lse
# row tile at the next tile's rows measured lse relative L2 1.45e-2-3.40e-2;
# a K5 that skips its last q tile dk/dv 0.093-0.251, a K4 that drops the
# ragged key tail dq 0.105-0.155 (S = 1100, 1700).
GRAD_TOL = {"bfloat16": (4e-3, 2e-3), "float32": (2e-6, 2e-6)}
TRAIN_TOL = {"o": TOL, "lse": {"bfloat16": (2e-5, 1e-6),
                               "float32": (2e-5, 1e-6)},
             "dq": GRAD_TOL, "dk": GRAD_TOL, "dv": GRAD_TOL}
# Each flash call of a bf16 fast-softmax step, held against the plain
# version on its own inputs, in relative L2 (the path's activations have no
# fixed scale): measured <= 2.2e-4 per call; with one key tile skipped the
# calls measured 6.1e-3 to 5.5e-2.
PATH_CALL_REL_L2 = 2e-3
# The JAX package's variants of the forward kernels (name, poly, lsum):
# STABLEMTL_FLASH_POLY_EXP (3, 4) and STABLEMTL_FLASH_MXU_LSUM; kernel B
# takes the polynomial only.
VARIANTS = (("poly3", 3, False), ("poly4", 4, False), ("lsum", 0, True),
            ("poly3_lsum", 3, True))
# A variant's kernel is held against the plain variant (on the kernel's key
# tiles, fa.KEY_TILE) at TOL / TRAIN_TOL. The polynomial's error (7.7e-5
# relative at degree 3, 2.7e-6 at 4) hides under bf16's output rounding
# (relative L2 up to 2.4e-3), so where the variant moves the result past
# the kernels' own rounding the kernel must also be VARIANT_FACTOR times
# closer, in relative L2, to the plain variant than to the plain default:
# the output of every f32 instance of a polynomial variant, and K3's lse
# (f32) under every variant that moves it (in f32 the row sum of lsum is
# the default's; degree 4 in the fast softmax moves it by less than the
# kernels' rounding, with no tile rescale to add drift). A kernel that
# ignores a flag computes the default, at distance ~0 from it, and fails.
# On random inputs a bf16 output shows nothing: the plain default rounds p
# against the row's final max, the kernels against each tile's running max,
# which moves o by 2.4e-3 relative L2 whatever the variant. The bf16
# instances are told apart on crafted inputs instead (`crafted_inputs`).
VARIANT_FACTOR = 2.0
# The crafted bf16 inputs. A variant shows in bf16 only where it moves a
# rounding: of p to bf16 before the p.v product (the polynomial), or of o
# (the row sum of lsum, l = sum of bf16 p, against the f32 sum of p). Each
# query row puts its weight on the last two keys, after which no rescale
# follows: key B at score 0 (p = 1, bf16 1 under every variant) and key A
# at a score s_A in (-1, 0), one of the values q.k takes exactly for q =
# (a, b, 64, 0, ...) and k_A = (1, 2^-12, 0, ...) with a and b bf16; the
# other keys score -4096*scale (p under 2^-110, v = 0). Rows in turns: s_A
# where exp2 and the degree-3 polynomial round p_A to different bf16
# values; the same for degree 4; and s_A where p_A, 5e-6 to 3e-5 above the
# midpoint 1 - 2^-9, rounds up to 1 (lsum's largest move of l). Every p_A,
# exact and by either polynomial (FMAs as the kernels, or a multiply and an
# add as the plain version), lies at least CRAFT_ULPS f32 ulps from a bf16
# rounding midpoint (twice that for exp2, whose kernel and plain values
# may differ by an ulp or two), so kernel and plain version round it
# alike. Columns in turns: v_A = 1, v_B = -1 (o = (P_A - 1) / l, where a
# flip of P_A moves o by tens of its ulps) and v_A = 2, v_B = 7 * 2^-10
# (o = 1 + 2^-8 - 2^-11, which rounds to 1, over lsum's l = 2; over the f32
# l = 2 - 2^-9 it is 4.9e-4 past the midpoint and rounds to 1 + 2^-7). On
# the CPU the plain versions of the default and the four variants lay
# 3.5e-4 (poly3 and poly3_lsum) to 7.5e-3 apart in relative L2, at every
# head dim, and the check fails if two lie under CRAFT_MIN_REL apart; a
# kernel must be within TOL of its plain variant and VARIANT_FACTOR times
# closer to it than to the plain version of the default and of every other
# variant, so a kernel that ignores a flag, or runs another variant's
# instance, fails.
CRAFT_ULPS = 4
CRAFT_MIN_REL = 2e-4
# (kernel, head dims) of the crafted checks: every bf16 head dim of each
CRAFT_CASES = (("flash_fwd_resident", (16, 32, 64)),
               ("flash_fwd_resident_lse", (16, 32, 64)),
               ("flash_fwd_stream", (256, 512)))
# The lse's max |err| bar under lsum in bf16, where the ones column sums p
# after its rounding to bf16: the kernel's scores and the plain variant's
# differ in f32 summation order, so a p at a rounding boundary may round to
# the neighbouring bf16 value, one ulp (2^-8 to 2^-7 of p), which moves
# the lse by up to 2^-7 p / (l ln 2) for each such p. Measured on the H100
# at the K3 shapes: <= 1.13e-4 (relative L2 <= 1.8e-7, under TRAIN_TOL's
# 1e-6, which holds).
LSUM_LSE_MAX_ABS = 5e-4
# (kernel, shape, timed) of the variants' checks: K1 at its main shapes,
# the ragged eval shape and the small and tiny presets' head dims; K3 at
# the training shape and ragged in q and keys; K2 at the VAE decode and
# the small preset
VARIANT_CASES = [
    ("flash_fwd_resident", (35, 4096, 64), True),
    ("flash_fwd_resident", (70, 1024, 64), True),
    ("flash_fwd_resident", (10, 1672, 64), False),
    ("flash_fwd_resident", (4, 1100, 32), False),
    ("flash_fwd_resident", (4, 1100, 16), False),
    ("flash_fwd_resident_lse", (10, 1728, 64), True),
    ("flash_fwd_resident_lse", (10, 1700, 64), False),
    ("flash_fwd_stream", (7, 4096, 512), True),
    ("flash_fwd_stream", (2, 1100, 256), False),
]
# Whole-path agreement. The flash path is held against plain attention on
# the same weights in f32, where both are exact up to f32 rounding: each
# kernel call differs from the plain math by <= 6e-7 (phase 2), and 22
# attention calls feeding residual streams amplify that; 5e-4 on outputs in
# [-1, 1] leaves several times the 8.1e-5 measured on the H100. In bf16
# with fast math, this random-weight network amplifies rounding to ~9 %
# relative L2 from f32 whichever attention runs, so the bf16 flash path is
# held to be no further from the f32 plain result than the bf16 plain path
# is (measured ratio 1.016), with 25 % of room. This ratio only catches a
# gross fault (with one key tile skipped it read 1.010);
# PATH_CALL_REL_L2 holds each kernel call on the bf16 path.
PATH_F32_MAX_ABS = 5e-4
PATH_BF16_RATIO = 1.25
# Each kernel call of a bf16 training micro-step (exact softmax), held
# against its plain version on its own inputs, in relative L2 by output:
# phase 2 measured exact-softmax outputs at <= 2.4e-3 (the online max
# rounds p to bf16 against another max than the plain version's), lse at
# <= 4.1e-8 and gradients at <= 2.0e-4.
TRAIN_CALL_REL_L2 = {"o": 5e-3, "lse": 1e-6, "dq": 2e-3, "dk": 2e-3,
                     "dv": 2e-3}
# The training path in f32 at batch 1, flash against plain attention on the
# same weights, batch and generator: the relative L2 distance of the loss
# and of all main-UNet gradients concatenated.
TRAIN_F32_LOSS_REL = 1e-5
TRAIN_F32_GRAD_REL_L2 = 1e-4
# Phase 4's micro-step under STABLEMTL_FLASH_POLY_EXP=3 and
# STABLEMTL_FLASH_MXU_LSUM=1 (in f32 the latter is the default's sum)
# against the same step with the flags off, f32 at batch 1: the loss's
# relative change and the main-UNet gradients' relative L2 distance. Each
# attention call moves by the polynomial's error (7.7e-5 relative in p)
# and by its rescales: every 64-key tile of the f32 kernels multiplies the
# running sums by the polynomial's value at the max's change, 1 - 7.7e-5
# when it does not change, so at the 288x384 stage-0 sequence (1728 keys,
# 27 tiles) o moves by up to ~6e-4 relative and the logsumexp, which the
# exact backward reads, by up to ~3e-3 (~2e-3 relative in the backward's
# p). The loss and the gradients sum over every call: the bars hold them
# to 5e-3, a little over the largest shift of one call; the change must
# not be 0 (the flags took effect). Measured on the H100: 2.5e-6 and
# 9.0e-5.
TRAIN_VARIANT_LOSS_REL = 5e-3
TRAIN_VARIANT_GRAD_REL_L2 = 5e-3
# The flagship trainer settings (config/train_stablemtl.yaml:8-16,
# config/train_base_config.yaml:21-22,50-57, the 288x384 resize of
# config/dataset/dataset_train.yaml:12), micro-batch 2 with accumulation 2.
TRAINER = dict(multi_stream=True, attn_mask_ratio=0.4,
               attn_mask_type="attn_prob", n_attns=4,
               apply_task_attn_to_layers="all",
               exclude_mainstream_output_type=True,
               return_feature="afterSelfAttn_residual")
TRAIN_HW = (288, 384)
TRAIN_BATCH = 2
# K6's (R, C, F) at a batch-2 serving step at 512x512 (the 7 streams of
# both images fold into the rows), each timed: the three stage shapes and
# the mid block; then, checked only, ragged row counts (1100: 8 tiles of
# 128 rows + 76, 17 of 64 + 12; 1050: 8 of 128 + 26, so the last tile's
# second 64 rows lie wholly past R) at SD2's stage 0 and at the small and
# tiny presets' stage 0, whose C = 160 and 32 end in a part of the kernel's
# 64-wide C chunk that TMA fills with zeros, and at F = 192, whose last
# 128-feature tile is half past F (the gate takes F % 64); then, checked
# only, the main UNet's local (R, C, F) on a rank of phase 11c's
# tensor-parallel forward (model 2, 512x512, one row: F halved at stages
# 0-2 and the mid block)
GEGLU_SHAPES = [((57344, 320, 1280), True), ((14336, 640, 2560), True),
                ((3584, 1280, 5120), True), ((896, 1280, 5120), True),
                ((1100, 320, 1280), False), ((1100, 160, 640), False),
                ((1050, 32, 128), False), ((1050, 64, 192), False),
                ((4096, 320, 640), False), ((1024, 640, 1280), False),
                ((256, 1280, 2560), False), ((64, 1280, 2560), False)]
# (max |err|, relative L2) of K6 against its plain version in f32 on the
# same inputs, rounded to the input dtype once. On the H100 (x ~ N(0, 1),
# both projections ~N(0, 1), outputs up to ~8 in magnitude): bf16 max|err|
# <= 6.25e-2 (one ulp at |y| in [4, 8)) and relative L2 <= 1.31e-4; f32
# <= 9.5e-7 and <= 8.2e-9 (erf: bit-equal to the f32 matmul). A kernel
# that drops its last 64-wide C chunk measured 0.32-0.60 relative L2.
GEGLU_TOL = {"bfloat16": (0.125, 1e-3), "float32": (1e-5, 1e-6)}

# Phase 5, serving: the flagship configuration (config/train_stablemtl.yaml
# with its bases merged; tests/test_torch_port_serving.py holds this literal
# against the port's recursive_load_config of the YAML), written as a run
# directory's config_resolved.json. Served at 512x512 with
# STABLEMTL_FUSED_GEGLU=1, batch 2.
FLAGSHIP_CONFIG = {'dataset': {'val': [{'name': 'cityscapes',
                          'disp_name': 'cityscapes_val_full',
                          'dir': 'cityscapes',
                          'filenames': 'data_split/cityscapes/cityscapes_val_full.txt',
                          'output_type': ['semantic'],
                          'resize_to_hw': [256, 512]},
                         {'name': 'kitti_flow',
                          'disp_name': 'kitti_flow_2015',
                          'dir': 'kitti/flow_2015',
                          'filenames': 'data_split/kitti_flow/training.txt',
                          'kitti_bm_crop': True,
                          'output_type': ['optical_flow', 'scene_flow'],
                          'resize_to_hw': [176, 608]},
                         {'name': 'kitti',
                          'disp_name': 'kitti_val_from_train_sub_100',
                          'dir': 'kitti/kitti_sampled_val_800',
                          'filenames': 'data_split/kitti/eigen_val_from_train_sub_100.txt',
                          'kitti_bm_crop': True,
                          'valid_mask_crop': 'eigen',
                          'output_type': ['depth'],
                          'resize_to_hw': [176, 608]},
                         {'name': 'diode',
                          'disp_name': 'diode_val_all',
                          'dir': 'diode/diode_val',
                          'filenames': 'data_split/diode/diode_val_sub100_filename_list.txt',
                          'output_type': ['normal', 'depth'],
                          'resize_to_hw': [384, 512]},
                         {'name': 'mid_intrinsic',
                          'disp_name': 'mid_intrinsic_val',
                          'dir': 'mid_intrinsics',
                          'filenames': 'data_split/mid_intrinsics/test_lite_300.txt',
                          'output_type': ['albedo', 'shading'],
                          'resize_to_hw': [256, 384]}],
                 'vis': [{'name': 'kitti',
                          'disp_name': 'kitti_val_from_train_sub_100',
                          'dir': 'kitti/kitti_sampled_val_800',
                          'filenames': 'data_split/kitti/eigen_val_from_train_vis.txt',
                          'kitti_bm_crop': True,
                          'valid_mask_crop': 'eigen',
                          'output_type': ['depth']},
                         {'name': 'diode',
                          'disp_name': 'diode_val_all',
                          'dir': 'diode/diode_val',
                          'filenames': 'data_split/diode/diode_val_vis.txt',
                          'output_type': ['normal', 'depth']},
                         {'name': 'cityscapes',
                          'disp_name': 'cityscapes_val_full',
                          'dir': 'cityscapes',
                          'filenames': 'data_split/cityscapes/cityscapes_vis_from_val.txt',
                          'output_type': ['semantic']},
                         {'name': 'kitti_flow',
                          'disp_name': 'kitti_flow_2015',
                          'dir': 'kitti/flow_2015',
                          'filenames': 'data_split/kitti_flow/vis.txt',
                          'kitti_bm_crop': True,
                          'output_type': ['optical_flow']},
                         {'name': 'kitti_flow',
                          'disp_name': 'kitti_flow_2015',
                          'dir': 'kitti/flow_2015',
                          'filenames': 'data_split/kitti_flow/vis.txt',
                          'kitti_bm_crop': True,
                          'output_type': ['scene_flow']},
                         {'name': 'mid_intrinsic',
                          'disp_name': 'mid_intrinsic_vis',
                          'dir': 'mid_intrinsics',
                          'filenames': 'data_split/mid_intrinsics/test_vis_20.txt',
                          'resize_to_hw': [384, 576],
                          'output_type': ['albedo', 'shading']}],
                 'test': [{'name': 'cityscapes',
                           'disp_name': 'cityscapes_val_full',
                           'dir': 'cityscapes',
                           'filenames': 'data_split/cityscapes/cityscapes_val_full.txt',
                           'output_type': ['semantic'],
                           'resize_to_hw': [256, 512]},
                          {'name': 'kitti',
                           'disp_name': 'kitti_eigen_test',
                           'dir': 'kitti/kitti_eigen_split_test',
                           'filenames': 'data_split/kitti/eigen_test_files_with_gt.txt',
                           'kitti_bm_crop': True,
                           'valid_mask_crop': 'eigen',
                           'output_type': ['depth'],
                           'resize_to_hw': [176, 608]},
                          {'name': 'kitti_flow',
                           'disp_name': 'kitti_flow_2015',
                           'dir': 'kitti/flow_2015',
                           'filenames': 'data_split/kitti_flow/training.txt',
                           'kitti_bm_crop': True,
                           'output_type': ['optical_flow', 'scene_flow'],
                           'resize_to_hw': [176, 608]},
                          {'name': 'diode',
                           'disp_name': 'diode_val_all',
                           'dir': 'diode/diode_val',
                           'filenames': 'data_split/diode/diode_val_all_filename_list.txt',
                           'output_type': ['normal', 'depth'],
                           'resize_to_hw': [384, 512]},
                          {'name': 'mid_intrinsic',
                           'disp_name': 'mid_intrinsic_val',
                           'dir': 'mid_intrinsics',
                           'filenames': 'data_split/mid_intrinsics/test.txt',
                           'output_type': ['albedo', 'shading'],
                           'resize_to_hw': [256, 384]}],
                 'train': {'name': 'mixed',
                           'prob_ls': [1.0,
                                       1.0,
                                       0.9,
                                       0.1,
                                       0.9,
                                       0.1,
                                       1.0,
                                       0.5,
                                       0.5,
                                       0.5,
                                       0.5],
                           'dataset_list': [{'name': 'hypersim_albedo',
                                             'disp_name': 'hypersim_albedo_train',
                                             'dir': 'hypersim/train',
                                             'filenames': 'data_split/hypersim/filename_list_train_no_nandepth.txt',
                                             'resize_to_hw': [288, 384]},
                                            {'name': 'hypersim_shading',
                                             'disp_name': 'hypersim_shading_train',
                                             'dir': 'hypersim/train',
                                             'filenames': 'data_split/hypersim/filename_list_train_no_nandepth.txt',
                                             'resize_to_hw': [288, 384]},
                                            {'name': 'hypersim_depth',
                                             'disp_name': 'hypersim_depth_train',
                                             'dir': 'hypersim/train',
                                             'filenames': 'data_split/hypersim/filename_list_train_no_nandepth.txt',
                                             'resize_to_hw': [288, 384]},
                                            {'name': 'vkitti_depth',
                                             'disp_name': 'vkitti_depth_train',
                                             'dir': 'vkitti_v2',
                                             'filenames': 'data_split/vkitti/vkitti_depth_train.txt',
                                             'kitti_bm_crop': True,
                                             'valid_mask_crop': None,
                                             'resize_to_hw': [187, 621]},
                                            {'name': 'hypersim_normal',
                                             'disp_name': 'hypersim_normal_train',
                                             'dir': 'hypersim/train',
                                             'filenames': 'data_split/hypersim/filename_list_train_normal.txt',
                                             'resize_to_hw': [288, 384]},
                                            {'name': 'vkitti_normal',
                                             'disp_name': 'vkitti_normal_train',
                                             'dir': 'vkitti_v2',
                                             'filenames': 'data_split/vkitti/vkitti_normal_train.txt',
                                             'kitti_bm_crop': True,
                                             'valid_mask_crop': None,
                                             'resize_to_hw': [187, 621]},
                                            {'name': 'vkitti_semantic',
                                             'disp_name': 'vkitti_semantic_train',
                                             'dir': 'vkitti_v2',
                                             'filenames': 'data_split/vkitti/vkitti_semantic_train.txt',
                                             'kitti_bm_crop': True,
                                             'valid_mask_crop': None,
                                             'resize_to_hw': [187, 621]},
                                            {'name': 'vkitti_optical_flow',
                                             'disp_name': 'vkitti_optical_flow_train',
                                             'dir': 'vkitti_v2',
                                             'filenames': 'data_split/vkitti/vkitti_optical_flow_train.txt',
                                             'kitti_bm_crop': True,
                                             'valid_mask_crop': None,
                                             'resize_to_hw': [187, 621]},
                                            {'name': 'flying_things_3D_optical_flow',
                                             'disp_name': 'flying_things_3D_optical_flow',
                                             'dir': 'FlyingThings3D_preprocessed',
                                             'filenames': 'data_split/flying_things_3D/train.txt',
                                             'resize_to_hw': [268, 480]},
                                            {'name': 'vkitti_scene_flow',
                                             'disp_name': 'vkitti_scene_flow_train',
                                             'dir': 'vkitti_v2',
                                             'filenames': 'data_split/vkitti/vkitti_scene_flow_train.txt',
                                             'kitti_bm_crop': True,
                                             'valid_mask_crop': None,
                                             'resize_to_hw': [187, 621]},
                                            {'name': 'flying_things_3D_scene_flow',
                                             'disp_name': 'flying_things_3D_scene_flow',
                                             'dir': 'FlyingThings3D_preprocessed',
                                             'filenames': 'data_split/flying_things_3D/train.txt',
                                             'resize_to_hw': [268, 480]}]}},
     'logging': {'filename': 'logging.log', 'console_level': 20, 'file_level': 10},
     'model': {'pretrained_path': 'scratch',
               'size_preset': 'full',
               'latent_scale_factor': 0.18215,
               'prediction_type': 'sample',
               'compute_dtype': 'bfloat16',
               'remat': False},
     'pipeline': {'input_noise': 'deterministic', 'encode_rgb_model': 'duplicate'},
     'trainer': {'init_seed': 2024,
                 'save_period': 500,
                 'backup_period': 1000,
                 'validation_period': 1000,
                 'log_period': 50,
                 'output_types': ['normal',
                                  'depth',
                                  'semantic',
                                  'optical_flow',
                                  'scene_flow',
                                  'albedo',
                                  'shading'],
                 'multi_stream': True,
                 'attn_mask_ratio': 0.4,
                 'attn_mask_type': 'attn_prob',
                 'return_feature': 'afterSelfAttn_residual',
                 'exclude_mainstream_output_type': True,
                 'n_attns': 4,
                 'apply_task_attn_to_layers': 'all',
                 'unet_weight_path': None},
     'lr': 0.0001,
     'max_iter': 11000,
     'lr_scheduler': {'name': 'IterExponential',
                      'kwargs': {'total_iter': 25000,
                                 'final_ratio': 0.01,
                                 'warmup_steps': 100}},
     'dataloader': {'iterative_sampling': True,
                    'effective_batch_size': 32,
                    'max_train_batch_size': 16,
                    'seed': 2024,
                    'num_workers': 0},
     'depth_normalization': {'type': 'scale_shift_depth',
                             'clip': True,
                             'norm_min': -1.0,
                             'norm_max': 1.0,
                             'min_max_quantile': 0.02},
     'optical_flow_normalization': {'type': 'scale_shift_optical_flow',
                                    'clip': True,
                                    'norm_min': -1.0,
                                    'norm_max': 1.0,
                                    'min_max_quantile': 0.0},
     'eval': {'alignment': 'least_square', 'align_max_res': None},
     'validation': {'init_seed': 2024,
                    'denoising_steps': 1,
                    'ensemble_size': 1,
                    'processing_res': 0,
                    'match_input_res': True,
                    'resample_method': 'bilinear'},
     'augmentation': {'default': {'enabled': True,
                                  'color_jitter': {'enabled': True,
                                                   'brightness': 0.4,
                                                   'contrast': 0.4,
                                                   'saturation': 0.4,
                                                   'hue': 0.159},
                                  'random_horizontal_flip': {'enabled': True},
                                  'random_vertical_flip': {'enabled': False}}}}
SERVE_RES = 512
SERVE_BATCH = 2
SERVE_REQUESTS = 5
# K6 launches per serving step, counted from the code: every transformer
# block runs one feed-forward (the shared prefix stops before it), 16 in
# the main UNet's one pass over the 7 folded streams and 16 in the child's
# one pass over the 7 folded tasks.
GEGLU_LAUNCHES_PER_STEP = 32
# Each served result against infer_all_tasks, on the main thread, of the
# batch its step ran, max |diff|: bit-equal on the H100 (0.0, and 0.0 for
# the same batch run twice).
SERVE_MAX_ABS = 0.0
# Each served result against the same request beside a copy of itself, at
# the same place in the batch: bit-equal, the batch mate's content reaches
# no other row. The place itself is not free in bf16: cuDNN's bf16 conv2d
# rounds a few outputs of row 1 otherwise than the same values at row 0,
# and a request at row 1 differs from itself at row 0 by up to 0.27 on the
# H100 (printed, not held; PERF.md), while in f32 with deterministic cuDNN
# every row reads bit-equal (SERVE_F32_MATE_MAX_ABS).
SERVE_MATE_MAX_ABS = 0.0
# Each K6 call of a bf16 serving step against its plain version in f32 on
# its own inputs, relative L2.
SERVE_CALL_REL_L2 = 2e-3
# The f32 serving path at batch 1, K6 against the plain GEGLU, max |diff|
# on outputs in [-1, 1], with cuDNN's deterministic algorithms: bit-equal
# on the H100, as each f32 erf K6 call is at every serving shape (phase
# 2). The limit leaves room for the per-call rounding phase 2 allows:
# rounding-level differences in single ops reach ~1e-4 at the output
# (cuDNN's default f32 conv_transpose2d, which is not deterministic, moved
# outputs by up to 7.3e-5 between two runs of one batch).
SERVE_F32_MAX_ABS = 5e-4
# In f32 with deterministic cuDNN and K6: a request beside another image
# against beside a copy of itself, at row 1 against row 0, and one batch
# run twice, max |diff|: all bit-equal on the H100.
SERVE_F32_MATE_MAX_ABS = 0.0
# Phase 6: the synthetic tree's raw vkitti frames (the dataset's own
# 375x1242), the training resizes of config/dataset/dataset_train.yaml
# (vkitti 187x621, hypersim 288x384; neither a multiple of 64) and the
# KITTI validation resize of config/dataset/dataset_val.yaml (176x608, a
# multiple of 8 as every eval geometry: the VAE maps 187x621 to 184x616)
P6_VKITTI_RAW = (375, 1242)
P6_VKITTI_HW = (187, 621)
P6_HYPERSIM_HW = (288, 384)
P6_EVAL_HW = (176, 608)
P6_FRAMES = 4
# Phase 8, the serving artifact: each run (path name, batch, pair). Its
# output against eager infer_all_tasks on the same weights and inputs,
# relative L2: the same ops run in the same order, so 0 is expected; the
# limit leaves room for cuDNN's choice of algorithm between two bf16 runs.
ART_RUNS = (("artifact b2", SERVE_BATCH, False), ("artifact pair b1", 1,
                                                  True))
ART_REL_L2 = 1e-3
# the artifact's bytes over the bundle's: the weights are inputs
ART_MAX_SHARE = 0.01
ART_STEPS = 3


def full_config(dtype: str, fast_math: bool = False, trainer=None) -> dict:
    """A config for `build_pipeline`: the multi-stream pipeline at the
    full preset (SD2 widths, not cut in depth), random weights."""
    return {"model": {"size_preset": "full", "compute_dtype": dtype,
                      "fast_math": fast_math},
            "trainer": {"multi_stream": True, **(trainer or {})}}


def all_kernels():
    """Every kernel wrapper, K1-K5 (flash) then K6 (GEGLU)."""
    from stablemtl_tpu_torch.ops import flash_attention as fa
    from stablemtl_tpu_torch.ops import geglu

    return fa.KERNELS + geglu.KERNELS


def reset_counts():
    for kernel in all_kernels():
        kernel.launches = 0


def read_counts() -> dict:
    return {k: k.launches for k in all_kernels()}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_time(fn, iters: int, warmup: int = 1) -> float:
    """ms per call from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(bh: int, s: int, d: int, dtype, flops: int = 4,
                       tensors: int = 4, rows: int = 0,
                       poly: int = 0) -> tuple:
    """Least time for a flash kernel on [bh, s, d]: the larger of the bytes
    (`tensors` [bh, s, d] tensors and `rows` [bh, s] f32 vectors, each read
    or written once) over HBM bandwidth and the operations (flops*s*s*d
    FLOPs and s*s exp2 per head) over their peaks. The forward is 4 FLOPs
    and 4 tensors; K3 adds the lse row; K4 is 6 FLOPs, 5 tensors (q, k, v,
    dO, dQ) and 2 rows (lse, delta); K5 8 FLOPs, 6 tensors and 2 rows. A
    polynomial variant: its FP32 operations a score (POLY_FP32_OPS) over
    the FP32 rate in place of the exp2. lsum computes the same function as
    the default and has its bound: the row sum, one add a score, hides
    behind the products there as here."""
    import torch

    item = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (tensors * bh * s * d * item + rows * bh * s * 4) / PEAK_BYTES
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_exp = (bh * s * s * POLY_FP32_OPS[poly] / PEAK_FP32_INSTR if poly
             else bh * s * s / PEAK_EXP2)
    t_ops = max(flops * d * bh * s * s / peak, t_exp)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def phase_build():
    from stablemtl_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    report = cuda_build.build()
    print(f"[build] {len(report)} source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (secs, log) in report.items():
        print(f"[build] {name}: nvcc {secs:.1f} s", flush=True)
        for line in log.splitlines():
            # each kernel's (mangled) name, its register count and spills,
            # and wgmma chains ptxas serialized
            if any(w in line for w in ("entry function", "Used", "spill",
                                       "serialized")):
                print(f"[ptxas] {line.strip()}", flush=True)


def phase_kernels():
    """Check both kernels; return {kernel: measured stats at its main-path
    shape}."""
    import torch
    import torch.nn.functional as F

    from stablemtl_tpu_torch.ops.flash_attention import (flash_fwd_resident,
                                                         flash_fwd_stream,
                                                         flash_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    # (kernel, shape, timed): the main path's shapes are timed, and the
    # first of each kernel is the one reported; the ragged eval geometry
    # and the other presets' head dims are checked only
    cases = [
        (flash_fwd_resident, (35, 4096, 64), True),   # stage 0: 7 x 5 heads
        (flash_fwd_resident, (70, 1024, 64), True),   # stage 1: 7 x 10 heads
        (flash_fwd_resident, (10, 1672, 64), False),  # ragged: 26 tiles + 8
        (flash_fwd_resident, (4, 1100, 32), False),   # small preset UNet
        (flash_fwd_resident, (4, 1100, 16), False),   # tiny preset UNet
        (flash_fwd_stream, (7, 4096, 512), True),     # VAE decode, 7 streams
        (flash_fwd_stream, (1, 4096, 512), True),     # VAE encode
        (flash_fwd_stream, (2, 1100, 256), False),    # small preset VAE
    ]
    stats = {}
    for kernel, shape, timed in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            tol_abs, tol_rel = TOL[str(dtype).split(".")[1]]
            for fast in (False, True):
                out = kernel(q, k, v, fast_softmax=fast)
                ref = flash_reference(q, k, v, fast_softmax=fast)
                err, rel = compare(out, ref)
                rms = ref.float().square().mean().sqrt().item()
                print(f"[check] {kernel.__name__} {shape} "
                      f"{str(dtype)[6:]} fast={int(fast)} "
                      f"max_abs={err:.3e} rel_l2={rel:.3e} "
                      f"(tol {tol_abs:g}, {tol_rel:g}; ref rms {rms:.3e})",
                      flush=True)
                if not (err <= tol_abs and rel <= tol_rel):
                    fail(f"{kernel.__name__} {shape} {dtype} fast={fast}"
                         f": max_abs {err:.3e}, rel_l2 {rel:.3e} over "
                         f"{tol_abs:g}, {tol_rel:g}")
            if dtype != torch.bfloat16 or not timed:
                continue
            # timing in both softmax modes (inference runs fast, serving
            # exact); the library call takes [1, BH, S, d], the 4-D layout
            # its fused back ends need
            lib_ms = cuda_time(
                lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None]), 10)
            bound, bound_by = attention_bound_ms(*shape, dtype)
            for fast in (True, False):
                mode = "fast" if fast else "exact"
                ms = cuda_time(lambda: kernel(q, k, v, fast_softmax=fast), 10)
                plain_ms = cuda_time(
                    lambda: flash_reference(q, k, v, fast_softmax=fast), 3)
                print(f"[time] {kernel.__name__} {shape} bf16 {mode}: "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms "
                      f"({bound_by})", flush=True)
                timing = dict(shape=list(shape), softmax=mode, ms=ms,
                              plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound, bound_by=bound_by)
                # the first timed shape in fast softmax (the inference
                # path's mode, whose check ran last: err) heads the
                # kernel's entry
                if kernel not in stats:
                    stats[kernel] = dict(timing, max_abs_err=err,
                                         timings=[])
                    del stats[kernel]["softmax"]
                stats[kernel]["timings"].append(timing)
        del q, k, v
        torch.cuda.empty_cache()
    return stats


def phase_variant_kernels():
    """Check every variant instance of K1, K2 and K3 against its plain
    variant in bf16 and f32, both softmax modes, and against the plain
    default where a variant must show (VARIANT_FACTOR), the bf16 instances
    also on crafted inputs (`check_crafted`); time each variant at the
    main paths' shapes beside the default, in the order default,
    variants, variants reversed, default. Returns {kernel: {"variants":
    [...]}}, each entry a variant's checks and timings."""
    import torch

    from stablemtl_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(11)
    op = {fa.flash_fwd_resident: "flash_fwd_a",
          fa.flash_fwd_resident_lse: "flash_fwd_lse",
          fa.flash_fwd_stream: "flash_fwd_b"}
    cases = [(getattr(fa, name), shape, timed)
             for name, shape, timed in VARIANT_CASES]
    out = {k: {"variants": [dict(variant=name, poly=poly, lsum=lsum,
                                 checks=[], timings=[])
                            for name, poly, lsum in VARIANTS
                            if k is not fa.flash_fwd_stream or not lsum]}
           for k in op}
    bad = []
    check_crafted(op, out, bad)
    for kernel, shape, timed in cases:
        lse_out = kernel is fa.flash_fwd_resident_lse
        entries = out[kernel]["variants"]
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).split(".")[1]
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            tile = fa.KEY_TILE[(op[kernel], dtype)]
            for fast in (False, True):
                default = fa.flash_forward_lse_reference(q, k, v, fast)
                for entry in entries:
                    poly, lsum = entry["poly"], entry["lsum"]
                    args = (poly,) if kernel is fa.flash_fwd_stream \
                        else (poly, lsum)
                    got = kernel(q, k, v, fast, *args)
                    want = fa.flash_forward_lse_reference(
                        q, k, v, fast, poly, lsum, tile)
                    got = got if lse_out else (got,)
                    for name, g, w, w0 in zip(("o", "lse"), got, want,
                                              default):
                        err, rel = compare(g, w)
                        rel0 = compare(g, w0)[1]
                        tol_abs, tol_rel = TRAIN_TOL[name][dt]
                        if name == "lse" and lsum and \
                                dtype == torch.bfloat16:
                            tol_abs = LSUM_LSE_MAX_ABS
                        if name == "o":
                            shows = bool(poly) and dtype == torch.float32
                        else:
                            shows = (poly, fast) != (4, True) and bool(
                                poly or dtype == torch.bfloat16)
                        ok = err <= tol_abs and rel <= tol_rel and (
                            not shows or rel0 >= VARIANT_FACTOR * rel)
                        print(f"[variant] {kernel.__name__} {entry['variant']}"
                              f" {name} {shape} {dt} fast={int(fast)} "
                              f"max_abs={err:.3e} rel_l2={rel:.3e} (tol "
                              f"{tol_abs:g}, {tol_rel:g}); vs default "
                              f"rel_l2={rel0:.3e}"
                              + (f" (>= {VARIANT_FACTOR:g}x)" if shows
                                 else "") + ("" if ok else " FAIL"),
                              flush=True)
                        entry["checks"].append(dict(
                            shape=list(shape), dtype=dt,
                            softmax="fast" if fast else "exact",
                            output=name, max_abs_err=err, rel_l2=rel,
                            rel_l2_default=rel0, must_show=bool(shows)))
                        if not ok:
                            bad.append(f"{kernel.__name__} "
                                       f"{entry['variant']} {name} {shape} "
                                       f"{dt} fast={fast}")
                    del got, want
                del default
            if timed and dtype == torch.bfloat16:
                modes = (False,) if lse_out else (True, False)
                for fast in modes:
                    time_variants(kernel, entries, shape, q, k, v, fast)
            del q, k, v
            torch.cuda.empty_cache()
    if bad:
        fail(f"{len(bad)} variant check(s) failed: {bad[:6]}")
    return out


def _exp2_poly_np(x, degree: int, fma: bool):
    """fa.exp2_poly on a float32 array, its Horner steps as FMAs (as the
    kernels' fmaf) or as a multiply and an add (as the plain version)."""
    import numpy as np

    from stablemtl_tpu_torch.ops import flash_attention as fa

    x = np.maximum(x, np.float32(-126))
    xi = np.floor(x)
    f = (x - xi).astype(np.float32)
    coeffs = [np.float32(c) for c in fa.EXP2_POLY_COEFFS[degree]]
    p = np.full_like(f, coeffs[0])
    for c in coeffs[1:]:
        p = ((p.astype(np.float64) * f + c).astype(np.float32) if fma
             else (p * f).astype(np.float32) + c)
    return p * ((xi.astype(np.int32) + 127) << 23).view(np.float32)


def crafted_inputs(d: int, heads: int = 2, s: int = 256):
    """bf16 q, k, v [heads, s, d] on the card on which every variant moves
    the bf16 output (see CRAFT_ULPS)."""
    import numpy as np
    import torch

    from stablemtl_tpu_torch.ops import flash_attention as fa

    def to_boundary(x):  # f32 ulps from the nearest bf16 rounding midpoint
        return np.abs((x.view(np.uint32) & 0xFFFF).astype(np.int64) - 0x8000)

    def bf16(x):
        return torch.from_numpy(x).bfloat16().float().numpy()

    scale2 = np.float32(d ** -0.5 * fa.LOG2E)
    grid = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    a = grid[(grid < -2.0 ** -12) & (grid > -1 / scale2)]
    b = grid[(np.abs(grid) >= 0.5) & (np.abs(grid) < 1)]
    a, b = (x.ravel() for x in np.meshgrid(a, b, indexing="ij"))
    raw = a.astype(np.float64) + b.astype(np.float64) * 2.0 ** -12
    exact = raw.astype(np.float32).astype(np.float64) == raw
    a, b, raw = a[exact], b[exact], raw[exact].astype(np.float32)
    score = raw * scale2
    keep = (score > -1) & (score < 0)
    a, b, score = a[keep], b[keep], score[keep]
    p = np.exp2(score.astype(np.float64)).astype(np.float32)
    polys = {n: [_exp2_poly_np(score, n, fma) for fma in (True, False)]
             for n in (3, 4)}
    ok = to_boundary(p) >= 2 * CRAFT_ULPS
    for pair in polys.values():
        for pn in pair:
            ok &= to_boundary(pn) >= CRAFT_ULPS
    above = p.astype(np.float64) / (1 - 2.0 ** -9) - 1
    kinds = [np.nonzero(ok & (bf16(polys[n][0]) != bf16(p)))[0]
             for n in (3, 4)]
    kinds.append(np.nonzero(ok & (above > 5e-6) & (above < 3e-5))[0])
    if any(len(rows) == 0 for rows in kinds):
        fail(f"crafted inputs at d={d}: no score for a row kind")
    q = np.zeros((heads * s, d), np.float32)
    for r in range(heads * s):
        rows = kinds[r % 3]
        i = rows[(r // 3) % len(rows)]
        q[r, :3] = (a[i], b[i], 64)
    k = np.zeros((heads, s, d), np.float32)
    v = np.zeros((heads, s, d), np.float32)
    k[:, :s - 2, 2] = -64
    k[:, s - 2, :2] = (1, 2.0 ** -12)
    v[:, s - 2, 0::2], v[:, s - 1, 0::2] = 1, -1
    v[:, s - 2, 1::2], v[:, s - 1, 1::2] = 2, 7 * 2.0 ** -10
    return [torch.from_numpy(x).reshape(heads, s, d).to("cuda",
                                                         torch.bfloat16)
            for x in (q, k, v)]


def check_crafted(op: dict, out: dict, bad: list):
    """Hold every bf16 variant instance of K1, K2 and K3 on the crafted
    inputs (CRAFT_CASES), both softmax modes: within TOL of the plain
    variant and VARIANT_FACTOR times closer to it than to the plain
    version of the default and of every other variant, which lie at least
    CRAFT_MIN_REL from each other. Appends each check to its entry in
    `out` and each failure to `bad`."""
    import itertools

    import torch

    from stablemtl_tpu_torch.ops import flash_attention as fa

    for name, dims in CRAFT_CASES:
        kernel = getattr(fa, name)
        tile = fa.KEY_TILE[(op[kernel], torch.bfloat16)]
        entries = out[kernel]["variants"]
        for d in dims:
            q, k, v = crafted_inputs(d)
            shape = list(q.shape)
            for fast in (False, True):
                plain = {"default": fa.flash_reference(q, k, v, fast)}
                for entry in entries:
                    plain[entry["variant"]] = fa.flash_reference(
                        q, k, v, fast, entry["poly"], entry["lsum"], tile)
                apart = min(compare(a, b)[1] for a, b in
                            itertools.combinations(plain.values(), 2))
                if apart < CRAFT_MIN_REL:
                    fail(f"crafted inputs at d={d} fast={fast}: two plain "
                         f"variants only {apart:.3e} apart")
                for entry in entries:
                    poly, lsum = entry["poly"], entry["lsum"]
                    args = (poly,) if kernel is fa.flash_fwd_stream \
                        else (poly, lsum)
                    got = kernel(q, k, v, fast, *args)
                    got = got[0] if isinstance(got, tuple) else got
                    err, rel = compare(got, plain[entry["variant"]])
                    others = {other: compare(got, o)[1]
                              for other, o in plain.items()
                              if other != entry["variant"]}
                    nearest = min(others, key=others.get)
                    tol_abs, tol_rel = TOL["bfloat16"]
                    ok = (err <= tol_abs and rel <= tol_rel
                          and others[nearest] >= VARIANT_FACTOR * rel)
                    print(f"[variant] {name} {entry['variant']} o crafted "
                          f"{shape} bf16 fast={int(fast)} max_abs={err:.3e}"
                          f" rel_l2={rel:.3e}; nearest other {nearest} "
                          f"rel_l2={others[nearest]:.3e} "
                          f"(>= {VARIANT_FACTOR:g}x), default "
                          f"{others['default']:.3e}"
                          + ("" if ok else " FAIL"), flush=True)
                    entry["checks"].append(dict(
                        shape=shape, dtype="bfloat16", inputs="crafted",
                        softmax="fast" if fast else "exact", output="o",
                        max_abs_err=err, rel_l2=rel,
                        rel_l2_default=others["default"],
                        rel_l2_nearest_other=others[nearest],
                        must_show=True))
                    if not ok:
                        bad.append(f"{name} {entry['variant']} o crafted "
                                   f"d={d} fast={fast}")


def time_variants(kernel, entries, shape, q, k, v, fast: bool):
    """ms of the default and of each variant in `entries` on the same
    inputs: one reading each in the order default, variants, variants
    reversed, default (CUDA events, 10 calls a reading); each entry gains
    its timing beside the default's and its bound."""
    from stablemtl_tpu_torch.ops import flash_attention as fa

    lse_out = kernel is fa.flash_fwd_resident_lse
    work = dict(flops=4, tensors=4, rows=1 if lse_out else 0)

    def call(entry):
        if entry is None:
            return lambda: kernel(q, k, v, fast)
        args = ((entry["poly"],) if kernel is fa.flash_fwd_stream
                else (entry["poly"], entry["lsum"]))
        return lambda: kernel(q, k, v, fast, *args)

    order = [None, *entries, *reversed(entries), None]
    readings = {}
    for entry in order:
        readings.setdefault(id(entry), []).append(
            cuda_time(call(entry), 10))
    default = readings[id(None)]
    mode = "fast" if fast else "exact"
    for entry in entries:
        ms = readings[id(entry)]
        bound, bound_by = attention_bound_ms(*shape, q.dtype, **work,
                                             poly=entry["poly"])
        print(f"[time] {kernel.__name__} {entry['variant']} {shape} bf16 "
              f"{mode}: kernel {ms[0]:.4f}, {ms[1]:.4f} ms; default "
              f"{default[0]:.4f}, {default[1]:.4f} ms; bound {bound:.4f} ms"
              f" ({bound_by})", flush=True)
        entry["timings"].append(dict(
            shape=list(shape), softmax=mode, ms=sum(ms) / 2, ms_readings=ms,
            default_ms=sum(default) / 2, default_ms_readings=default,
            bound_ms=bound, bound_by=bound_by))


def phase_train_kernels():
    """Check K3, K4 and K5 against their plain versions; return {kernel:
    measured stats at the training path's shape}. The backward kernels read
    the plain forward's lse and delta, so each kernel is held on its own."""
    import torch

    from stablemtl_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [
        ((10, 1728, 64), True),    # training stage 0 at 288x384: 2 x 5 heads
        ((35, 4096, 64), False),   # 512x512 training shapes: stage 0
        ((70, 1024, 64), False),   # and stage 1
        ((4, 1100, 64), False),    # ragged: 17 tiles + 12
        ((4, 1100, 32), False),    # small preset UNet
        ((4, 1100, 16), False),    # tiny preset UNet
        # the training shape's grid of 90 K3 CTAs (192 rows each), ragged in
        # q (8 tiles + 164) and keys
        ((10, 1700, 64), False),
        ((10, 1700, 32), False),
        ((10, 1700, 16), False),
    ]
    stats = {}
    for shape, timed in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                           .to(dtype) for _ in range(4))
            dt = str(dtype).split(".")[1]
            for fast in (False, True):
                o_ref, lse_ref = fa.flash_forward_lse_reference(q, k, v, fast)
                o, lse = fa.flash_fwd_resident_lse(q, k, v, fast)
                delta = fa.row_delta(do, o_ref)
                dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta)
                dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta)
                dq_ref = fa.flash_bwd_dq_reference(q, k, v, do, lse_ref,
                                                   delta)
                dk_ref, dv_ref = fa.flash_bwd_dkv_reference(
                    q, k, v, do, lse_ref, delta)
                torch.cuda.synchronize()
                for kernel, name, got, want in (
                        (fa.flash_fwd_resident_lse, "o", o, o_ref),
                        (fa.flash_fwd_resident_lse, "lse", lse, lse_ref),
                        (fa.flash_bwd_dq, "dq", dq, dq_ref),
                        (fa.flash_bwd_dkv, "dk", dk, dk_ref),
                        (fa.flash_bwd_dkv, "dv", dv, dv_ref)):
                    err, rel = compare(got, want)
                    tol_abs, tol_rel = TRAIN_TOL[name][dt]
                    print(f"[check] {kernel.__name__} {name} {shape} {dt} "
                          f"fast={int(fast)} max_abs={err:.3e} "
                          f"rel_l2={rel:.3e} (tol {tol_abs:g}, {tol_rel:g};"
                          f" ref max {want.float().abs().max().item():.3e})",
                          flush=True)
                    if not (err <= tol_abs and rel <= tol_rel):
                        fail(f"{kernel.__name__} {name} {shape} {dt} "
                             f"fast={fast}: max_abs {err:.3e}, rel_l2 "
                             f"{rel:.3e} over {tol_abs:g}, {tol_rel:g}")
                    if timed and dtype == torch.bfloat16 and not fast:
                        errs = stats.setdefault(kernel, {"max_abs_err": 0.0})
                        errs["max_abs_err"] = max(errs["max_abs_err"], err)
            if timed and dtype == torch.bfloat16:
                time_train_kernels(stats, shape, q, k, v, do)
            del q, k, v, do
            torch.cuda.empty_cache()
    return stats


def time_rounds(fn, rounds: int = 3, iters: int = 20) -> list:
    """ms per call of `fn`, one reading per round of `iters` calls (CUDA
    events), after one warm-up call."""
    fn()
    return [cuda_time(fn, iters, warmup=0) for _ in range(rounds)]


def sdpa_backward(q, k, v, do):
    """A call of SDPA's flash backward alone on [BH, S, d] tensors, dQ, dK
    and dV together: one aten op (its forward run once here), without
    autograd's engine, whose host time made the same kernels read 0.18 ms
    in one run and 0.72 ms in another at [10, 1728, 64]."""
    import torch

    aten = torch.ops.aten
    q4, k4, v4, do4 = (x[None] for x in (q, k, v, do))  # [1, BH, S, d]
    fwd = aten._scaled_dot_product_flash_attention(q4, k4, v4)
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, *fwd[:6], 0.0, False, fwd[6], fwd[7])


def time_train_kernels(stats, shape, q, k, v, do):
    """Time K3, K4 and K5 in the training path's mode (bf16, exact softmax)
    beside their bounds, plain versions and the library yardsticks:
    F.scaled_dot_product_attention's forward for K3; for K4 and K5 its
    flash backward alone (the forward run once, outside the timed calls),
    as the aten op and through torch.autograd.grad, beside the port's whole
    backward, row_delta + K4 + K5. K3-K5 and the backwards: median and
    range of 3 rounds of 20 calls."""
    import statistics

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from stablemtl_tpu_torch.ops import flash_attention as fa

    o_ref, lse = fa.flash_forward_lse_reference(q, k, v, False)
    delta = fa.row_delta(do, o_ref)
    args = (q, k, v, do, lse, delta)
    q4, k4, v4, do4 = (x[None] for x in (q, k, v, do))  # [1, BH, S, d]

    # the library's flash back end, which has a fused backward at bf16 d=64
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        with torch.no_grad():
            sdpa_fwd = cuda_time(
                lambda: F.scaled_dot_product_attention(q4, k4, v4), 10)
        qr, kr, vr = (x.detach().requires_grad_() for x in (q4, k4, v4))
        out = F.scaled_dot_product_attention(qr, kr, vr)
        sdpa_grad = time_rounds(lambda: torch.autograd.grad(
            out, (qr, kr, vr), do4, retain_graph=True))
    del out
    sdpa_op = time_rounds(sdpa_backward(q, k, v, do))

    def port_backward():
        d = fa.row_delta(do, o_ref)
        fa.flash_bwd_dq(q, k, v, do, lse, d)
        fa.flash_bwd_dkv(q, k, v, do, lse, d)

    port_bwd = time_rounds(port_backward)

    def med_range(xs):
        return statistics.median(xs), [min(xs), max(xs)]

    backward = {}
    backward["library_ms"], backward["library_range_ms"] = med_range(sdpa_op)
    (backward["library_autograd_ms"],
     backward["library_autograd_range_ms"]) = med_range(sdpa_grad)
    (backward["port_backward_ms"],
     backward["port_backward_range_ms"]) = med_range(port_bwd)
    rows = {
        fa.flash_fwd_resident_lse: (
            lambda: fa.flash_fwd_resident_lse(q, k, v, False),
            lambda: fa.flash_forward_lse_reference(q, k, v, False),
            sdpa_fwd, dict(flops=4, tensors=4, rows=1)),
        fa.flash_bwd_dq: (
            lambda: fa.flash_bwd_dq(*args),
            lambda: fa.flash_bwd_dq_reference(*args),
            backward["library_ms"], dict(flops=6, tensors=5, rows=2)),
        fa.flash_bwd_dkv: (
            lambda: fa.flash_bwd_dkv(*args),
            lambda: fa.flash_bwd_dkv_reference(*args),
            backward["library_ms"], dict(flops=8, tensors=6, rows=2)),
    }
    for kernel, (fn, plain, lib_ms, work) in rows.items():
        ms, ms_range = med_range(time_rounds(fn))
        plain_ms = cuda_time(plain, 3)
        bound, bound_by = attention_bound_ms(*shape, q.dtype, **work)
        print(f"[time] {kernel.__name__} {shape} bf16 exact: kernel "
              f"{ms:.4f} ms (range {ms_range[0]:.4f}-{ms_range[1]:.4f}), "
              f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({bound_by})", flush=True)
        stats[kernel].update(
            shape=list(shape), ms=ms, ms_range=ms_range, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by, library_ms=lib_ms)
    print(f"[time] backward {shape} bf16 exact, median (range) of 3 rounds "
          f"of 20 calls: sdpa flash backward op "
          f"{backward['library_ms']:.4f} ms ({min(sdpa_op):.4f}-"
          f"{max(sdpa_op):.4f}), through autograd.grad "
          f"{backward['library_autograd_ms']:.4f} ms ({min(sdpa_grad):.4f}-"
          f"{max(sdpa_grad):.4f}); row_delta + K4 + K5 "
          f"{backward['port_backward_ms']:.4f} ms ({min(port_bwd):.4f}-"
          f"{max(port_bwd):.4f}); K4 {stats[fa.flash_bwd_dq]['ms']:.4f}, K5 "
          f"{stats[fa.flash_bwd_dkv]['ms']:.4f} ms alone", flush=True)
    stats[fa.flash_fwd_resident_lse]["library_covers"] = (
        "the forward alone (sdpa's flash back end, no lse)")
    for kernel in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        stats[kernel].update(
            backward, library_covers=(
                "dQ, dK and dV together, the work of row_delta + K4 + K5 "
                "(port_backward_ms): sdpa's flash backward alone, its forward "
                "run once outside the timed calls; library_ms the aten op "
                "_scaled_dot_product_flash_attention_backward, "
                "library_autograd_ms the same through torch.autograd.grad; "
                "medians of 3 rounds of 20 calls"))


def geglu_inputs(shape, dtype, gen):
    """x [R, C] ~ N(0, 1), W [2F, C] ~ N(0, 1/C) (so both projections are
    ~N(0, 1)), b [2F] ~ 0.1 N(0, 1), in `dtype` on the card."""
    import torch

    r, c, f = shape
    x = torch.randn((r, c), generator=gen, device="cuda")
    w = torch.randn((2 * f, c), generator=gen, device="cuda") * c ** -0.5
    b = torch.randn((2 * f,), generator=gen, device="cuda") * 0.1
    return x.to(dtype), w.to(dtype), b.to(dtype)


def geglu_exact(x, w, b, fast: bool):
    """K6's arithmetic in f32 on the same (rounded) inputs, rounded to the
    input dtype once at the end, as the kernel writes it."""
    from stablemtl_tpu_torch.ops.geglu import geglu_reference

    return geglu_reference(x.float(), w.float(), b.float(), fast).to(x.dtype)


def geglu_bound_ms(shape, dtype) -> tuple:
    """Least time for K6 on (R, C, F): the larger of the bytes (x, W, b
    read once, y written once) over HBM bandwidth and 4*R*C*F FLOPs over
    the dtype's peak."""
    import torch

    r, c, f = shape
    item = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (r * c + 2 * f * c + 2 * f + r * f) * item / PEAK_BYTES
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops = 4 * r * c * f / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def phase_geglu_kernel():
    """Check K6 against geglu_reference at the SD2 feed-forward shapes of a
    batch-2 serving step and a ragged row count, both dtypes and both
    gelus; time it at each serving shape. Returns its stats, headed by the
    stage-0 shape (the step's largest K6 call)."""
    import torch
    import torch.nn.functional as F

    from stablemtl_tpu_torch.ops.geglu import geglu_fused, geglu_reference

    gen = torch.Generator(device="cuda").manual_seed(7)
    stats = {"max_abs_err": 0.0, "timings": []}
    for shape, timed in GEGLU_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, w, b = geglu_inputs(shape, dtype, gen)
            dt = str(dtype).split(".")[1]
            tol_abs, tol_rel = GEGLU_TOL[dt]
            for fast in (False, True):
                out = geglu_fused(x, w, b, fast)
                err, rel = compare(out, geglu_exact(x, w, b, fast))
                print(f"[check] geglu_fused {shape} {dt} tanh={int(fast)} "
                      f"max_abs={err:.3e} rel_l2={rel:.3e} (tol "
                      f"{tol_abs:g}, {tol_rel:g})", flush=True)
                if not (err <= tol_abs and rel <= tol_rel):
                    fail(f"geglu_fused {shape} {dt} tanh={fast}: max_abs "
                         f"{err:.3e}, rel_l2 {rel:.3e} over {tol_abs:g}, "
                         f"{tol_rel:g}")
                if timed and dtype == torch.bfloat16 and not fast:
                    stats["max_abs_err"] = max(stats["max_abs_err"], err)
            if timed and dtype == torch.bfloat16:
                # the serving path's mode: bf16, exact erf gelu
                ms = cuda_time(lambda: geglu_fused(x, w, b, False), 10)
                plain_ms = cuda_time(
                    lambda: geglu_reference(x, w, b, False), 10)
                lib_ms = cuda_time(lambda: F.linear(x, w, b), 10)
                bound, bound_by = geglu_bound_ms(shape, dtype)
                print(f"[time] geglu_fused {shape} bf16 erf: kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.linear "
                      f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})",
                      flush=True)
                stats["timings"].append(dict(
                    shape=list(shape), ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound, bound_by=bound_by))
            del x, w, b
            torch.cuda.empty_cache()
    stats.update(stats["timings"][0],
                 library_covers="the [2F, C] projection alone (F.linear, "
                                "no epilogue)")
    return {geglu_fused: stats}


def phase_main_path(batch: int, profile: bool = False):
    """Returns {kernel: launches} of one step at `batch`, every kernel's
    counter set to 0 just before it; then times steps at `batch` and twice
    that."""
    os.environ["STABLEMTL_FAST_MATH"] = "1"  # the benchmarked workload
    try:
        return _main_path(batch, profile)
    finally:
        del os.environ["STABLEMTL_FAST_MATH"]


def _main_path(batch: int, profile: bool):
    import torch

    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    pipe = build_pipeline(full_config("bfloat16", fast_math=True), seed=0,
                          image_hw=(512, 512))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.vae, pipe.unet, pipe.unet_child)
                   for p in m.parameters())
    print(f"[path] full pipeline built in {time.perf_counter() - t0:.1f} s,"
          f" {n_params / 1e9:.3f} B parameters", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rgb = torch.rand((batch, 512, 512, 3), generator=gen,
                     device="cuda") * 2 - 1

    reset_counts()
    t0 = time.perf_counter()
    out = pipe.infer_all_tasks(rgb, None)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"[path] first infer_all_tasks {first_s:.2f} s; launches: "
          + " ".join(f"{k.__name__}={n}" for k, n in counts.items()),
          flush=True)
    want_shape = (7, batch, 512, 512, 3)
    if tuple(out.shape) != want_shape:
        fail(f"output shape {tuple(out.shape)} != {want_shape}")
    if not torch.isfinite(out).all():
        fail("non-finite output")
    # inference runs the flash forward kernels only: the training kernels
    # (K3-K5) launching here would mean a frozen weight asked for a
    # gradient, and K6 runs only under STABLEMTL_FUSED_GEGLU (phase 5)
    forward = (fa.flash_fwd_resident, fa.flash_fwd_stream)
    for kernel, n in counts.items():
        if kernel in forward and n == 0:
            fail(f"{kernel.__name__} never launched on the main path")
        if kernel not in forward and n != 0:
            fail(f"{kernel.__name__} launched {n} times on the inference "
                 f"path")

    calls = run_checked_calls(pipe, rgb)
    for name, shape, max_abs, rel_l2 in calls:
        print(f"[path] bf16 call {name} {shape}: max_abs={max_abs:.4e} "
              f"rel_l2={rel_l2:.4e} (tol rel_l2 {PATH_CALL_REL_L2})",
              flush=True)
    plain = run_plain_attention(pipe, rgb)
    # the same weights in f32 (init draws in f32 before the bf16 cast):
    # flash and plain attention there, the kernels' f32 instances
    pipe32 = build_pipeline(full_config("float32", fast_math=True), seed=0,
                            image_hw=(512, 512))
    out32 = pipe32.infer_all_tasks(rgb, None)
    plain32 = run_plain_attention(pipe32, rgb)
    del pipe32
    torch.cuda.empty_cache()
    checks = [
        ("f32 flash vs f32 plain", compare(out32, plain32), PATH_F32_MAX_ABS),
        ("bf16 flash vs f32 plain", compare(out, plain32), None),
        ("bf16 plain vs f32 plain", compare(plain, plain32), None),
        ("bf16 flash vs bf16 plain", compare(out, plain), None),
    ]
    for name, (max_abs, rel_l2), tol in checks:
        print(f"[path] {name}: max_abs={max_abs:.4e} rel_l2={rel_l2:.4e}"
              + (f" (tol max_abs {tol})" if tol else ""), flush=True)
    print(f"[path] output mean={out.float().mean().item():.4e} "
          f"std={out.float().std().item():.4e}", flush=True)
    ratio = checks[1][1][1] / checks[2][1][1]
    print(f"[path] bf16 error ratio, flash over plain (against f32 plain): "
          f"{ratio:.4f} (tol {PATH_BF16_RATIO})", flush=True)

    for b in (batch, 2 * batch):
        time_steps(pipe, b)
    if profile:
        profile_step(lambda: pipe.infer_all_tasks(rgb, None),
                     "infer_all_tasks step")
    launched = sum(counts[k] for k in forward)
    if len(calls) != launched:
        fail(f"{len(calls)} flash calls checked, {launched} launched on the "
             f"main path")
    if not all(c[3] <= PATH_CALL_REL_L2 for c in calls):
        fail("a kernel call on the bf16 path disagrees with its plain "
             "version")
    if not checks[0][1][0] <= PATH_F32_MAX_ABS:
        fail("f32 flash path disagrees with f32 plain attention")
    if not ratio <= PATH_BF16_RATIO:
        fail("bf16 flash path is further from f32 than bf16 plain attention")
    main_path_variants(pipe, rgb, counts, checks[2][1][1], plain32)
    return counts


@contextlib.contextmanager
def env_flags(flags: dict):
    """The environment flags `flags` set for the block, then restored."""
    saved = {name: os.environ.get(name) for name in flags}
    os.environ.update(flags)
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                del os.environ[name]
            else:
                os.environ[name] = value


# phase 3's step under the JAX package's switches that the port follows
PATH_VARIANTS = (
    ("poly3+lsum", {"STABLEMTL_FLASH_POLY_EXP": "3",
                    "STABLEMTL_FLASH_MXU_LSUM": "1"}),
    ("no_fused_qkv", {"STABLEMTL_NO_FUSED_QKV": "1"}),
)


def main_path_variants(pipe, rgb, counts, plain_rel, plain32):
    """Phase 3's batch-1 step (bf16, fast math) under PATH_VARIANTS: each
    with the default's launches from counters at 0, finite, and no further
    from the f32 plain result than the bf16 plain path is
    (PATH_BF16_RATIO over `plain_rel`); under the kernels' variants every
    flash call also against its plain variant on its own inputs
    (PATH_CALL_REL_L2), and ms per step beside the default's in turns
    (default, variant, variant, default)."""
    import torch

    for name, flags in PATH_VARIANTS:
        with env_flags(flags):
            reset_counts()
            out = pipe.infer_all_tasks(rgb, None)
            torch.cuda.synchronize()
            got = read_counts()
            ratio = compare(out, plain32)[1] / plain_rel
            calls = (run_checked_calls(pipe, rgb)
                     if "STABLEMTL_FLASH_POLY_EXP" in flags else [])
        print(f"[path] {name}: launches "
              + " ".join(f"{k.__name__}={n}" for k, n in got.items())
              + f"; bf16 error ratio against f32 plain {ratio:.4f} (tol "
              f"{PATH_BF16_RATIO})", flush=True)
        worst = max((c[3] for c in calls), default=0.0)
        if calls:
            print(f"[path] {name}: {len(calls)} flash calls against their "
                  f"plain variant, worst rel_l2 {worst:.4e} (tol "
                  f"{PATH_CALL_REL_L2})", flush=True)
        if got != counts:
            fail(f"{name}: launches {got} differ from the default's")
        if not torch.isfinite(out).all():
            fail(f"{name}: non-finite output")
        if not ratio <= PATH_BF16_RATIO:
            fail(f"{name}: further from f32 than bf16 plain attention")
        if calls and (len(calls) != sum(counts.values())
                      or worst > PATH_CALL_REL_L2):
            fail(f"{name}: a kernel call disagrees with its plain variant "
                 f"({len(calls)} checked)")
    flags = dict(PATH_VARIANTS)["poly3+lsum"]
    ms = {"default": [], "poly3+lsum": []}
    for which in ("default", "poly3+lsum", "poly3+lsum", "default"):
        with env_flags(flags if which != "default" else {}):
            ms[which].append(time_steps(pipe, 1, what=f" ({which})"))
    print(f"[path] batch 1 in turns: default {ms['default']} ms, poly3+lsum "
          f"{ms['poly3+lsum']} ms", flush=True)


def run_checked_calls(pipe, rgb):
    """infer_all_tasks with every flash call also run through the plain
    version (of the variant the flags select) on its own inputs. Returns
    [(kernel, q shape, max |err|, relative L2)] per call."""
    from stablemtl_tpu_torch.ops import attention
    from stablemtl_tpu_torch.ops import flash_attention as fa

    launch = attention.flash_attention
    calls = []

    def checked(q, k, v):
        out = launch(q, k, v)
        b, s, h, d = q.shape

        def fold(x):
            return x.permute(0, 2, 1, 3).reshape(b * h, s, d)

        resident = d <= fa.RESIDENT_MAX_HEAD_DIM
        tile = fa.KEY_TILE[("flash_fwd_a" if resident else "flash_fwd_b",
                            q.dtype)]
        ref = fa.flash_reference(fold(q), fold(k), fold(v),
                                 fa.fast_softmax(), *fa.variant(d), tile)
        name = "flash_fwd_resident" if resident else "flash_fwd_stream"
        calls.append((name, tuple(q.shape),
                      *compare(fold(out), ref)))
        return out

    attention.flash_attention = checked
    try:
        pipe.infer_all_tasks(rgb, None)
    finally:
        attention.flash_attention = launch
    return calls


def run_plain_attention(pipe, rgb):
    """infer_all_tasks with STABLEMTL_DISABLE_FLASH=1: plain attention on
    the card."""
    os.environ["STABLEMTL_DISABLE_FLASH"] = "1"
    try:
        return pipe.infer_all_tasks(rgb, None)
    finally:
        del os.environ["STABLEMTL_DISABLE_FLASH"]


def compare(a, b) -> tuple:
    """(max |a - b|, ||a - b|| / ||b||) in f32."""
    diff = a.float() - b.float()
    return (diff.abs().max().item(),
            (diff.norm() / b.float().norm()).item())


def profile_step(fn, what: str, top: int = 25):
    """Device time by kernel over one call of `fn` (torch.profiler) and the
    device's idle share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    print(f"[profile] {what}: wall {wall_ms:.2f} ms (profiled), device "
          f"busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{n_kernels} device kernels", flush=True)
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"[profile] host {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:80]}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:100]}", flush=True)


def time_steps(pipe, batch: int, iters: int = 3, what: str = "") -> float:
    """ms per infer_all_tasks step at `batch` (host clock around
    synchronized steps, after one warm-up step); `what` labels the line."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    rgb = torch.rand((batch, 512, 512, 3), generator=gen,
                     device="cuda") * 2 - 1
    out = pipe.infer_all_tasks(rgb, None)
    if tuple(out.shape) != (7, batch, 512, 512, 3) or \
            not torch.isfinite(out).all():
        fail(f"batch {batch}: output {tuple(out.shape)} not finite "
             f"[7, {batch}, 512, 512, 3]")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        pipe.infer_all_tasks(rgb, None)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    print(f"[path] infer_all_tasks{what} batch {batch}: {step_ms:.2f} "
          f"ms/step, "
          f"{batch / step_ms * 1e3:.4f} images/s (all 7 tasks), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return step_ms


def train_batches(n: int, batch: int, seed: int, device, hw=None):
    """n micro-batches at `hw` (TRAIN_HW by default) made on the card:
    frames in [-1, 1] (the next frame a shifted copy), a GT image, a valid
    mask with an invalid band, and one task per effective batch of 2
    micro-steps (a single-frame task, then a two-frame one)."""
    import torch

    hw = tuple(hw or TRAIN_HW)
    gen = torch.Generator(device=device).manual_seed(seed)
    tasks = (1, 1, 3, 3)  # depth, depth, optical_flow, optical_flow
    out = []
    for i in range(n):
        def img():
            return torch.rand((batch, *hw, 3), generator=gen,
                              device=device) * 2 - 1
        rgb, gt = img(), img()
        valid = torch.ones((batch, *hw, 1), dtype=torch.bool,
                           device=device)
        valid[:, :12] = False
        out.append({"rgb_norm": rgb,
                    "rgb_next_norm": torch.roll(rgb, 8, dims=2),
                    "target_3ch": gt, "valid_mask": valid,
                    "task_idx": tasks[i % len(tasks)]})
    return out


def phase_train_path(profile: bool = False):
    """Phase 4. Returns ({kernel: launches in the four counted
    micro-steps}, [ms per micro-step of each timed round])."""
    import torch

    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.ops import flash_attention as fa
    from stablemtl_tpu_torch.train_state import (OptimizerConfig,
                                                 create_train_state,
                                                 make_train_step)

    t0 = time.perf_counter()
    pipe = build_pipeline(full_config("bfloat16", trainer=TRAINER), seed=0,
                          image_hw=TRAIN_HW, trainable=True)
    cfg = OptimizerConfig(lr=1e-4, max_grad_norm=5.0, total_iters=25_000,
                          final_ratio=0.01, warmup_steps=100,
                          accumulation_steps=2)
    state = create_train_state(pipe.unet, cfg)
    step = make_train_step(pipe, base_seed=2024, compute_grad_stats=True)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in state.params.values())
    print(f"[train] full pipeline built in {time.perf_counter() - t0:.1f} s,"
          f" {n_train / 1e9:.3f} B trainable f32 parameters", flush=True)
    batches = train_batches(4, TRAIN_BATCH, seed=4, device=pipe.device)
    initial = {n: p.detach().clone() for n, p in state.params.items()}

    reset_counts()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        torch.cuda.synchronize()
        values = {k: float(v) for k, v in m.items()}
        print(f"[train] micro-step {i + 1} task {batch['task_idx']}: "
              + " ".join(f"{k}={v:.6g}" for k, v in values.items()),
              flush=True)
        if not all(math.isfinite(v) for v in values.values()) or \
                values["nan_pred"]:
            fail(f"micro-step {i + 1}: non-finite loss or gradients")
        if i == 1:
            same = sum(torch.equal(p, initial[n])
                       for n, p in state.params.items())
            print(f"[train] after update 1 (lr(0) = 0): {same} of "
                  f"{len(initial)} leaves unchanged", flush=True)
            if same != len(initial):
                fail("the first update (lr 0 under warmup) moved parameters")
    first_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"[train] 4 micro-steps (2 updates) in {first_s:.2f} s; launches: "
          + " ".join(f"{k.__name__}={n}" for k, n in counts.items()),
          flush=True)
    changed = sum(not torch.equal(p, initial[n])
                  for n, p in state.params.items())
    print(f"[train] after update 2 (lr {state.opt.learning_rate(1):.3g}): "
          f"{changed} of {len(initial)} leaves changed", flush=True)
    del initial
    if state.opt.count != 2 or changed == 0:
        fail(f"{state.opt.count} updates, {changed} leaves changed")
    for kernel, n in counts.items():
        # K6 runs only under STABLEMTL_FUSED_GEGLU, which training leaves
        # off (with it on, the frozen child would run K6)
        if (n == 0) == (kernel in fa.KERNELS):
            fail(f"{kernel.__name__} launched {n} times on the training "
                 f"path")

    calls = run_checked_train_calls(step, state, batches[0])
    for name, out, shape, rel in calls:
        print(f"[train] bf16 call {name} {out} {shape}: rel_l2={rel:.4e} "
              f"(tol {TRAIN_CALL_REL_L2[out]:g})", flush=True)
    per_step = {k.__name__: counts[k] // len(batches) for k in fa.KERNELS}
    checked = {}
    for name, out, _, _ in calls:
        if out in ("o", "dq", "dk"):  # one entry per call
            checked[name] = checked.get(name, 0) + 1
    if checked != per_step:
        fail(f"checked calls {checked} != launches per micro-step "
             f"{per_step}")
    if not all(rel <= TRAIN_CALL_REL_L2[out] for _, out, _, rel in calls):
        fail("a kernel call on the bf16 training path disagrees with its "
             "plain version")
    # the same micro-step under the forward kernels' variants: every call
    # against its plain variant (K4 and K5 read the variant's logsumexp)
    with env_flags(dict(PATH_VARIANTS)["poly3+lsum"]):
        calls = run_checked_train_calls(step, state, batches[0])
    worst = {}
    for name, out, _, rel in calls:
        worst[(name, out)] = max(worst.get((name, out), 0.0), rel)
    print("[train] poly3+lsum bf16 calls against their plain variant, worst "
          "rel_l2: " + " ".join(f"{n} {o} {r:.4e} (tol "
                                f"{TRAIN_CALL_REL_L2[o]:g})"
                                for (n, o), r in worst.items()), flush=True)
    checked_v = {}
    for name, out, _, _ in calls:
        if out in ("o", "dq", "dk"):
            checked_v[name] = checked_v.get(name, 0) + 1
    if checked_v != per_step:
        fail(f"poly3+lsum: checked calls {checked_v} != launches per "
             f"micro-step {per_step}")
    if not all(rel <= TRAIN_CALL_REL_L2[out] for _, out, _, rel in calls):
        fail("poly3+lsum: a kernel call on the bf16 training path disagrees "
             "with its plain variant")

    # timed as a trainer runs it: without the gradient-norm statistics; two
    # rounds of one warm-up and 4 timed micro-steps (2 optimizer updates)
    step = make_train_step(pipe, base_seed=2024)
    ms = [time_train_steps(step, state, train_batches(
        5, TRAIN_BATCH, seed=seed, device=pipe.device)) for seed in (5, 6)]
    if profile:
        for batch in batches[2:]:  # a micro-step without, then with update
            profile_step(lambda: step(state, batch),
                         f"training micro-step (update: "
                         f"{state.opt.mini_step == 1})")
    del pipe, state, step
    torch.cuda.empty_cache()
    check_train_f32()
    return counts, ms


def run_checked_train_calls(step, state, batch):
    """One bf16 micro-step (loss and grads, no update) with every flash
    kernel call also run through its plain version on its own inputs.
    Returns [(kernel, output, input shape, relative L2)]."""
    from stablemtl_tpu_torch.ops import flash_attention as fa

    calls = []
    originals = {k.__name__: k for k in fa.KERNELS}

    def checked(name, plain, outs):
        kernel = originals[name]

        def run(*args, **kwargs):
            got = kernel(*args, **kwargs)
            want = plain(*args, **kwargs)
            got_t = got if isinstance(got, tuple) else (got,)
            want_t = want if isinstance(want, tuple) else (want,)
            for out, g, w in zip(outs, got_t, want_t):
                calls.append((name, out, tuple(args[0].shape),
                              compare(g, w)[1]))
            return got

        # the kernel counts its launch on whatever its module name holds:
        # this shim, whose count nobody reads (checking launches don't count)
        run.launches = 0
        return run

    def on_tiles(plain, op):
        # the plain version on the kernel's key tiles (a variant's result
        # depends on them under the exact softmax)
        return lambda *args, **kwargs: plain(
            *args, block_k=fa.KEY_TILE[(op, args[0].dtype)], **kwargs)

    wrappers = {
        "flash_fwd_resident": checked(
            "flash_fwd_resident", on_tiles(fa.flash_reference,
                                           "flash_fwd_a"), ("o",)),
        "flash_fwd_stream": checked(
            "flash_fwd_stream", on_tiles(fa.flash_reference, "flash_fwd_b"),
            ("o",)),
        "flash_fwd_resident_lse": checked(
            "flash_fwd_resident_lse",
            on_tiles(fa.flash_forward_lse_reference, "flash_fwd_lse"),
            ("o", "lse")),
        "flash_bwd_dq": checked("flash_bwd_dq", fa.flash_bwd_dq_reference,
                                ("dq",)),
        "flash_bwd_dkv": checked("flash_bwd_dkv", fa.flash_bwd_dkv_reference,
                                 ("dk", "dv")),
    }
    for name, fn in wrappers.items():
        setattr(fa, name, fn)
    try:
        step.loss_and_grads(state, batch)
    finally:
        for name, kernel in originals.items():
            setattr(fa, name, kernel)
    return calls


def time_train_steps(step, state, batches):
    """ms per training micro-step (host clock around synchronized
    micro-steps, after one warm-up), train images/s and peak memory."""
    import torch

    step(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in batches[1:]:
        step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (len(batches) - 1) * 1e3
    print(f"[train] micro-batch {TRAIN_BATCH} at {TRAIN_HW[0]}x{TRAIN_HW[1]}"
          f": {ms:.2f} ms per micro-step ({len(batches) - 1} timed, "
          f"{state.opt.count} updates so far), "
          f"{TRAIN_BATCH / ms * 1e3:.4f} train images/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return ms


def check_train_f32():
    """The f32 training path at batch 1: loss and every main-UNet gradient
    with flash (K3, K4, K5, and K1/K2 in the frozen modules) against
    STABLEMTL_DISABLE_FLASH=1, on the same weights, batch and generator."""
    import torch

    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.train_state import eval_state, make_train_step

    pipe = build_pipeline(full_config("float32", trainer=TRAINER), seed=0,
                          image_hw=TRAIN_HW, trainable=True)
    state = eval_state(pipe.unet)
    step = make_train_step(pipe, base_seed=2024)
    batch = {k: (v[:1] if hasattr(v, "shape") else v)
             for k, v in train_batches(1, TRAIN_BATCH, seed=6,
                                       device=pipe.device)[0].items()}
    batch["task_idx"] = 3  # a two-frame task
    loss_f, _, grads_f = step.loss_and_grads(state, batch)
    with env_flags(dict(PATH_VARIANTS)["poly3+lsum"]):
        loss_v, _, grads_v = step.loss_and_grads(state, batch)
    os.environ["STABLEMTL_DISABLE_FLASH"] = "1"
    try:
        loss_p, _, grads_p = step.loss_and_grads(state, batch)
    finally:
        del os.environ["STABLEMTL_DISABLE_FLASH"]
    v_loss = abs(float(loss_v) - float(loss_f)) / abs(float(loss_f))
    v_grad = math.sqrt(sum((g - f).double().square().sum().item()
                           for g, f in zip(grads_v, grads_f))) / math.sqrt(
        sum(f.double().square().sum().item() for f in grads_f))
    print(f"[train] f32 batch 1, poly3+lsum vs the default (flash both): "
          f"loss {float(loss_v):.8g} vs {float(loss_f):.8g} (rel "
          f"{v_loss:.3e}, tol {TRAIN_VARIANT_LOSS_REL:g}, > 0); grads "
          f"rel_l2 {v_grad:.4e} (tol {TRAIN_VARIANT_GRAD_REL_L2:g}, > 0)",
          flush=True)
    del grads_v
    if not (0 < v_loss <= TRAIN_VARIANT_LOSS_REL
            and 0 < v_grad <= TRAIN_VARIANT_GRAD_REL_L2):
        fail("the f32 training path under poly3+lsum is not within its bars "
             "of the default, or equal to it")
    loss_rel = abs(float(loss_f) - float(loss_p)) / abs(float(loss_p))
    diff = math.sqrt(sum((f - p).double().square().sum().item()
                         for f, p in zip(grads_f, grads_p)))
    norm = math.sqrt(sum(p.double().square().sum().item() for p in grads_p))
    worst = max(((f - p).norm().item() / p.norm().item(), n)
                for n, f, p in zip(state.params, grads_f, grads_p)
                if p.norm().item() > 0)
    print(f"[train] f32 batch 1, flash vs plain attention: loss "
          f"{float(loss_f):.8g} vs {float(loss_p):.8g} (rel {loss_rel:.3e},"
          f" tol {TRAIN_F32_LOSS_REL:g}); grads rel_l2 {diff / norm:.4e} "
          f"(tol {TRAIN_F32_GRAD_REL_L2:g}); worst leaf {worst[1]} "
          f"{worst[0]:.4e}", flush=True)
    del pipe, state, grads_f, grads_p
    torch.cuda.empty_cache()
    if not (loss_rel <= TRAIN_F32_LOSS_REL
            and diff / norm <= TRAIN_F32_GRAD_REL_L2):
        fail("the f32 training path with flash disagrees with plain "
             "attention")


# ---------------------------------------------------------------------------
# Phase 5: serving
# ---------------------------------------------------------------------------

def write_run_dir(path: str):
    """A training run directory holding the flagship config as
    config_resolved.json (the serve CLI reads it with json alone)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config_resolved.json"), "w") as f:
        json.dump(FLAGSHIP_CONFIG, f, indent=1)


def serving_requests(n: int, seed: int):
    """n uint8 RGB images [512, 512, 3] (smooth gradients plus noise, so
    the PNG codec sees every row filter's structure), from numpy."""
    import numpy as np

    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[:SERVE_RES, :SERVE_RES] / SERVE_RES
    out = []
    for _ in range(n):
        base = np.stack([yy, xx, (yy + xx) / 2], -1) * r.uniform(80, 200, 3)
        noise = r.normal(0, 20, (SERVE_RES, SERVE_RES, 3))
        out.append(np.clip(base + noise + r.uniform(0, 50, 3), 0, 255)
                   .astype(np.uint8))
    return out


def phase_serving(profile: bool = False):
    """Phase 5. Returns {path: {kernel: launches}} of the serve CLI's run
    and of the ServingSession burst, each counted from 0."""
    os.environ["STABLEMTL_FUSED_GEGLU"] = "1"
    try:
        return _serving(profile)
    finally:
        del os.environ["STABLEMTL_FUSED_GEGLU"]


def _serving(profile: bool):
    import tempfile

    import torch

    from stablemtl_tpu_torch import TASKS
    from stablemtl_tpu_torch.cli import serve
    from stablemtl_tpu_torch.config import resolve_config_arg
    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.ops import flash_attention as fa
    from stablemtl_tpu_torch.ops import geglu
    from stablemtl_tpu_torch.utils.png import read_png, write_png

    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        write_run_dir(run_dir)
        images = []
        for i, img in enumerate(serving_requests(2, seed=11)):
            images.append(os.path.join(tmp, f"req{i}.png"))
            write_png(images[-1], img)
        out_dir = os.path.join(tmp, "served")
        reset_counts()
        t0 = time.perf_counter()
        serve.main(["--config", run_dir, "--images", *images,
                    "--output_dir", out_dir, "--res", str(SERVE_RES),
                    "--batch", str(SERVE_BATCH), "--save_npz",
                    "--seed", "0"])
        torch.cuda.synchronize()
        paths["cli.serve"] = read_counts()
        print(f"[serve] cli.serve of {len(images)} images in "
              f"{time.perf_counter() - t0:.1f} s (pipeline build included);"
              f" launches: " + " ".join(
                  f"{k.__name__}={n}" for k, n in paths["cli.serve"].items()),
              flush=True)
        for i in range(len(images)):
            pngs = [os.path.join(out_dir, f"req{i}_{t}.png") for t in TASKS]
            npz = os.path.join(out_dir, f"req{i}.npz")
            missing = [f for f in pngs + [npz] if not os.path.exists(f)]
            if missing:
                fail(f"cli.serve did not write {missing}")
            shapes = {read_png(f).shape for f in pngs}
            if shapes != {(SERVE_RES, SERVE_RES, 3)}:
                fail(f"cli.serve wrote PNGs of shapes {shapes}")
        print(f"[serve] cli.serve wrote {len(TASKS)} PNGs and one npz per "
              f"image", flush=True)
        cfg, _ = resolve_config_arg(run_dir)
    torch.cuda.empty_cache()

    pipe = build_pipeline(cfg, seed=0, image_hw=(SERVE_RES, SERVE_RES))
    per_step = GEGLU_LAUNCHES_PER_STEP
    got = pipe.unet.config.num_attn_layers * (1 + pipe.is_multi_stream)
    if got != per_step:
        fail(f"the pipeline has {got} feed-forwards per step, the "
             f"prediction {per_step}")
    counts, results, timing = serve_burst(pipe)
    paths["ServingSession"] = counts
    steps = timing["steps"]
    want = {fa.flash_fwd_resident: None, fa.flash_fwd_stream: None,
            fa.flash_fwd_resident_lse: 0, fa.flash_bwd_dq: 0,
            fa.flash_bwd_dkv: 0, geglu.geglu_fused: per_step * len(steps)}
    for kernel, n in counts.items():
        if (want[kernel] is None and n == 0) or \
                (want[kernel] is not None and n != want[kernel]):
            fail(f"{kernel.__name__} launched {n} times in "
                 f"{len(steps)} serving steps (want "
                 f"{want[kernel] if want[kernel] is not None else '> 0'})")

    check_served_results(pipe, results, steps)

    calls = run_checked_geglu_calls(pipe, results[0][0])
    rels = [rel for _, rel in calls]
    print(f"[serve] bf16 step: {len(calls)} K6 calls held against their "
          f"plain version, rel_l2 max {max(rels, default=0.0):.4e} (tol "
          f"{SERVE_CALL_REL_L2:g}); shapes "
          f"{sorted(set(shape for shape, _ in calls))}", flush=True)
    if len(calls) != per_step:
        fail(f"{len(calls)} K6 calls checked, {per_step} predicted")
    if not max(rels, default=0.0) <= SERVE_CALL_REL_L2:
        fail("a K6 call on the bf16 serving step disagrees with its plain "
             "version")
    if profile:
        x = torch.from_numpy(results[0][0]).to(pipe.device)
        batch = torch.stack([x] * SERVE_BATCH)
        profile_step(lambda: pipe.infer_all_tasks(batch, None),
                     f"serving step (batch {SERVE_BATCH}, K6 on)")
    del pipe
    torch.cuda.empty_cache()
    check_serving_f32(cfg, results[0][0], results[1][0])
    return paths


def serve_burst(pipe):
    """A warmed ServingSession(batch=2), then a burst of SERVE_REQUESTS
    requests from 2 client threads with every counter at 0, then single
    requests one at a time. Returns ({kernel: launches} of the burst,
    [(request, result)], timing)."""
    import threading

    import numpy as np
    import torch

    from stablemtl_tpu_torch.predict import _to_norm
    from stablemtl_tpu_torch.serving import ServingSession

    reqs = [_to_norm(img) for img in serving_requests(SERVE_REQUESTS, 12)]
    steps = []
    with ServingSession(pipe, batch=SERVE_BATCH, max_delay_s=0.005) as sess:
        sess.warmup((SERVE_RES, SERVE_RES))
        step = sess._step

        def counted(group):
            steps.append([g[0] for g in group])  # the requests, in order
            return step(group)

        sess._step = counted
        futures = [None] * len(reqs)

        def client(first):
            for i in range(first, len(reqs), 2):
                futures[i] = sess.submit(reqs[i])

        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(j,))
                   for j in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [(r, f.result(timeout=600)) for r, f in zip(reqs, futures)]
        burst_s = time.perf_counter() - t0
        counts = read_counts()
        burst_steps = list(steps)  # single requests follow
        print(f"[serve] burst of {len(reqs)} requests from 2 threads: "
              f"{len(burst_steps)} steps of "
              f"{[len(g) for g in burst_steps]}, "
              f"{burst_s * 1e3:.2f} ms, "
              f"{len(reqs) / burst_s:.4f} images/s (all 7 tasks); "
              f"launches: " + " ".join(f"{k.__name__}={n}"
                                       for k, n in counts.items()),
              flush=True)
        latency = []
        for r in reqs[:3]:
            t1 = time.perf_counter()
            sess.infer(r)
            latency.append((time.perf_counter() - t1) * 1e3)
        print(f"[serve] single requests (batch {SERVE_BATCH}, padded): "
              f"latency {' '.join(f'{t:.2f}' for t in latency)} ms, "
              f"median {float(np.median(latency)):.2f} ms", flush=True)
    return counts, results, dict(steps=burst_steps, burst_s=burst_s,
                                 latency_ms=latency)


def check_served_results(pipe, results, steps):
    """Each served result against infer_all_tasks, on this thread, of the
    batch its step ran (the group's requests in order, the tail padded by
    repeating the last), at the result's row; and against a batch of copies
    of itself at the same row (the mate's content reaches no other row).
    Also printed: the same batches run twice (run-to-run determinism), and
    row 1 against row 0 of a batch of copies (the effect of the place)."""
    import numpy as np
    import torch

    served = {id(r): out for r, out in results}

    def run(images):
        images = images + [images[-1]] * (SERVE_BATCH - len(images))
        x = torch.from_numpy(np.stack(images)).to(pipe.device)
        return pipe.infer_all_tasks(x, None).float().cpu().numpy()

    same, again, mates, place = [], [], [], []
    for group in steps:
        ref = run(group)
        again.append(compare_np(run(group), ref))
        for i, r in enumerate(group):
            same.append(compare_np(served[id(r)], ref[:, i]))
            copies = run([r])
            mates.append(compare_np(served[id(r)], copies[:, i]))
            place.append(compare_np(copies[:, 1], copies[:, 0]))
    for name, vals in (("the batch its step ran", same),
                       ("that batch run again", again),
                       ("copies of itself, the same row", mates),
                       ("copies of itself, row 1 vs row 0", place)):
        print(f"[serve] served results vs infer_all_tasks of {name}: max|diff|"
              f" {max(v[0] for v in vals):.4e}, rel_l2 "
              f"{max(v[1] for v in vals):.4e}", flush=True)
    if len(same) != len(results):
        fail(f"{len(same)} of {len(results)} served results found in the "
             f"burst's steps")
    if not max(v[0] for v in same) <= SERVE_MAX_ABS:
        fail(f"a served result disagrees with infer_all_tasks of its batch "
             f"(tol max|diff| {SERVE_MAX_ABS:g})")
    if not max(v[0] for v in mates) <= SERVE_MATE_MAX_ABS:
        fail(f"a served result depends on its batch mate (tol max|diff| "
             f"{SERVE_MATE_MAX_ABS:g})")


def compare_np(a, b) -> tuple:
    """(max |a - b|, ||a - b|| / ||b||) of two float32 host arrays."""
    import numpy as np

    d = a.astype(np.float64) - b
    return float(np.abs(d).max()), float(np.linalg.norm(d) / np.linalg.norm(b))


def run_checked_geglu_calls(pipe, rgb):
    """One bf16 all-task step with every K6 call also run through its plain
    version in f32 on its own inputs. Returns [(x shape, relative L2)]."""
    import torch

    from stablemtl_tpu_torch.ops import geglu

    kernel = geglu.geglu_fused
    calls = []

    def checked(x, w, b, fast):
        got = kernel(x, w, b, fast)
        calls.append((tuple(x.shape), compare(got, geglu_exact(x, w, b,
                                                               fast))[1]))
        return got

    # the kernel counts its launch on whatever its module name holds: this
    # shim, whose count nobody reads (checking launches don't count)
    checked.launches = 0
    geglu.geglu_fused = checked
    try:
        x = torch.from_numpy(rgb).to(pipe.device)
        pipe.infer_all_tasks(torch.stack([x] * SERVE_BATCH), None)
    finally:
        geglu.geglu_fused = kernel
    return calls


def check_serving_f32(cfg, rgb, mate):
    """The serving configuration in f32 with cuDNN's deterministic
    algorithms: at batch 1, K6 (its f32 instance) against the plain GEGLU
    on the same weights; at batch 2, request `rgb` beside `mate` against
    beside a copy of itself, `rgb` at row 1 against row 0, and one batch
    run twice."""
    import torch

    from stablemtl_tpu_torch.factory import build_pipeline

    cfg = json.loads(json.dumps(cfg.to_dict()))
    cfg["model"]["compute_dtype"] = "float32"
    pipe = build_pipeline(cfg, seed=0, image_hw=(SERVE_RES, SERVE_RES))
    x, y = (torch.from_numpy(a).to(pipe.device) for a in (rgb, mate))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fused = pipe.infer_all_tasks(x[None], None)
        os.environ["STABLEMTL_FUSED_GEGLU"] = "0"
        try:
            plain = pipe.infer_all_tasks(x[None], None)
        finally:
            os.environ["STABLEMTL_FUSED_GEGLU"] = "1"
        xy, xx, yx, xy2 = (pipe.infer_all_tasks(torch.stack(b), None)
                           for b in ([x, y], [x, x], [y, x], [x, y]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    max_abs, rel = compare(fused, plain)
    rows = {"another mate vs a copy": compare(xy[:, 0], xx[:, 0]),
            "row 1 vs row 0": compare(yx[:, 1], xx[:, 0]),
            "run twice": compare(xy2, xy)}
    print(f"[serve] f32 (deterministic cuDNN) batch 1, K6 vs plain GEGLU: "
          f"max|diff| {max_abs:.4e} rel_l2 {rel:.4e} (tol max|diff| "
          f"{SERVE_F32_MAX_ABS:g}); batch 2, max|diff| "
          + ", ".join(f"{k} {v[0]:.4e}" for k, v in rows.items())
          + f" (tol {SERVE_F32_MATE_MAX_ABS:g})", flush=True)
    del pipe
    torch.cuda.empty_cache()
    if not max_abs <= SERVE_F32_MAX_ABS:
        fail("the f32 serving path with K6 disagrees with the plain GEGLU")
    for k, (diff, _) in rows.items():
        if not diff <= SERVE_F32_MATE_MAX_ABS:
            fail(f"in f32 a request's output depends on its batch ({k}: "
                 f"{diff:.4e})")


def write_phase6_tree(root: str, seed: int):
    """The synthetic dataset tree of phase 6 under root, from numpy: vkitti
    (rgb jpg frames 0..P6_FRAMES, depth / class-segmentation PNGs and
    normal npys at 375x1242), hypersim (rgb and depth PNGs, normal npys and
    masks at 288x384) and one KITTI flow 2015 pair with disparities and
    calibration. Returns the filename lists by name."""
    import cv2
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    lists = {k: [] for k in ("vkitti_depth", "vkitti_normal",
                             "vkitti_semantic", "hypersim", "kitti_flow")}

    def image(hw):
        """Smooth gradients plus noise, uint8."""
        y, x = np.mgrid[:hw[0], :hw[1]] / np.reshape(hw, (2, 1, 1))
        base = np.stack([y, x, (y + x) / 2], -1)
        return np.clip(base * rng.uniform(80, 200, 3)
                       + rng.normal(0, 20, hw + (3,)), 0, 255) \
            .astype(np.uint8)

    vk = os.path.join(root, "vkitti", "Scene01/clone/frames")
    for sub in ("rgb", "depth", "classSegmentation", "normal"):
        os.makedirs(os.path.join(vk, sub, "Camera_0"), exist_ok=True)
    h, w = P6_VKITTI_RAW
    for i in range(P6_FRAMES + 1):
        Image.fromarray(image(P6_VKITTI_RAW)).save(
            os.path.join(vk, f"rgb/Camera_0/rgb_{i:05d}.jpg"), quality=95)
    for i in range(P6_FRAMES):
        rel = f"Scene01/clone/frames/depth/Camera_0/depth_{i:05d}.png"
        depth = (300 + 7000 * np.mgrid[:h, :w][0] / h
                 + 500 * rng.random((h, w))).astype(
            np.uint16)  # 3-78 m in centimeters, growing towards the bottom
        cv2.imwrite(os.path.join(root, "vkitti", rel), depth)
        lists["vkitti_depth"].append(rel)
        sem = np.zeros((h, w, 3), np.uint8)
        sem[:] = (100, 60, 100)               # Road
        sem[: h // 3] = (90, 200, 255)        # Sky
        sem[h // 3: h // 2, : w // 4] = (140, 140, 140)  # Building
        rel = f"Scene01/clone/frames/classSegmentation/Camera_0/" \
              f"classgt_{i:05d}.png"
        Image.fromarray(sem).save(os.path.join(root, "vkitti", rel))
        lists["vkitti_semantic"].append(rel)
        normal = rng.standard_normal((h, w, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        rel = f"Scene01/clone/frames/normal/Camera_0/normal_{i:05d}.npy"
        np.save(os.path.join(root, "vkitti", rel), normal)
        lists["vkitti_normal"].append(rel)

    hs = os.path.join(root, "hypersim", "scene")
    for sub in ("rgb", "depth", "normal"):
        os.makedirs(os.path.join(hs, sub), exist_ok=True)
    h, w = P6_HYPERSIM_HW
    for i in range(P6_FRAMES):
        Image.fromarray(image(P6_HYPERSIM_HW)).save(
            os.path.join(hs, f"rgb/frame_{i}.png"))
        cv2.imwrite(os.path.join(hs, f"depth/frame_{i}.png"),
                    rng.uniform(500, 30000, (h, w)).astype(np.uint16))
        normal = rng.standard_normal((h, w, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        np.save(os.path.join(hs, f"normal/frame_{i}.npy"), normal)
        mask = np.ones((h, w), bool)
        mask[:24] = False  # an invalid band: three latent rows
        np.save(os.path.join(hs, f"normal/mask_{i}.npy"), mask)
        lists["hypersim"].append(
            f"scene/rgb/frame_{i}.png scene/depth/frame_{i}.png "
            f"scene/normal/frame_{i}.npy _ scene/normal/mask_{i}.npy")

    kf = os.path.join(root, "kitti_flow")
    for sub in ("flow_occ", "image_2", "disp_occ_0", "disp_occ_1",
                "calib_cam_to_cam"):
        os.makedirs(os.path.join(kf, sub), exist_ok=True)
    h, w = P6_VKITTI_RAW
    frame = image(P6_VKITTI_RAW)
    Image.fromarray(frame).save(os.path.join(kf, "image_2/000000_10.png"))
    Image.fromarray(np.roll(frame, 2, axis=1)).save(
        os.path.join(kf, "image_2/000000_11.png"))
    flow = np.zeros((h, w, 3), np.uint16)  # (u, v) = (2, 0) px, all valid
    flow[..., 2] = 2 * 64 + 32768
    flow[..., 1] = 32768
    flow[..., 0] = 1
    cv2.imwrite(os.path.join(kf, "flow_occ/000000_10.png"), flow)
    cv2.imwrite(os.path.join(kf, "disp_occ_0/000000_10.png"),
                np.full((h, w), 40 * 256, np.uint16))
    cv2.imwrite(os.path.join(kf, "disp_occ_1/000000_10.png"),
                np.full((h, w), 38 * 256, np.uint16))
    with open(os.path.join(kf, "calib_cam_to_cam/000000.txt"), "w") as f:
        f.write("P_rect_02: 721.5377 0.0 609.5593 44.857 0.0 721.5377 "
                "172.854 0.216 0.0 0.0 1.0 0.0027\n")
    lists["kitti_flow"].append("flow_occ/000000_10.png")

    out = {}
    for name, lines in lists.items():
        out[name] = os.path.join(root, f"{name}.txt")
        with open(out[name], "w") as f:
            f.write("\n".join(lines))
    return out


def phase6_config(path: str, lists: dict):
    """The flagship recipe (config/train_stablemtl.yaml with its bases)
    overlaid with the synthetic mixture and phase 6's cadence, as YAML."""
    import yaml

    vkitti = {"dir": "vkitti", "kitti_bm_crop": True,
              "valid_mask_crop": None, "resize_to_hw": list(P6_VKITTI_HW)}
    evals = [dict(vkitti, name="vkitti_depth", disp_name="vkitti_depth_eval",
                  filenames=lists["vkitti_depth"], valid_mask_crop="eigen",
                  resize_to_hw=list(P6_EVAL_HW)),
             {"name": "kitti_flow", "disp_name": "kitti_flow_2015",
              "dir": "kitti_flow", "filenames": lists["kitti_flow"],
              "kitti_bm_crop": True,
              "output_type": ["optical_flow", "scene_flow"],
              "resize_to_hw": list(P6_EVAL_HW)}]
    overlay = {
        "base_config": [os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "config", "train_stablemtl.yaml")],
        "max_iter": 2,
        "dataloader": {"effective_batch_size": 4,
                       "max_train_batch_size": 2},
        "trainer": {"save_period": 2, "backup_period": 1000,
                    "validation_period": 1000, "log_period": 1},
        "dataset": {
            "train": {"name": "mixed", "prob_ls": [1.0, 1.0],
                      "dataset_list": [
                          dict(vkitti, name="vkitti_depth",
                               disp_name="vkitti_depth_train",
                               filenames=lists["vkitti_depth"]),
                          {"name": "hypersim_normal",
                           "disp_name": "hypersim_normal_train",
                           "dir": "hypersim", "filenames": lists["hypersim"],
                           "resize_to_hw": list(P6_HYPERSIM_HW)}]},
            "val": evals, "test": evals, "vis": []},
    }
    with open(path, "w") as f:
        yaml.safe_dump(overlay, f)


def print_step_times(trainer, phase4_ms):
    """The host ms of each micro-step's loop iteration inside the CLI,
    beside phase 4's ms per micro-step at the same shape."""
    for step, task, hw, secs in trainer.step_times:
        beside = (f" (phase 4 at {hw[0]}x{hw[1]}: " + ", ".join(
            f"{ms:.2f}" for ms in phase4_ms) + " ms)"
            if tuple(hw) == TRAIN_HW else "")
        print(f"[entry] micro-step {step} {task} {hw[0]}x{hw[1]}: "
              f"{secs * 1e3:.2f} ms{beside}", flush=True)


def print_checkpoint_io(what: str, ckpt):
    for kind, rows in (("save", ckpt.saves), ("restore", ckpt.restores)):
        for name, nbytes, secs in rows:
            print(f"[entry] {what} {kind} {name}: {nbytes} bytes in "
                  f"{secs:.2f} s ({nbytes / secs / 1e9:.2f} GB/s)",
                  flush=True)


def phase_entry_points(phase4_ms) -> tuple:
    """Phase 6. Returns {path: {kernel: launches}} of the two training runs
    and the eval run, each counted from 0, and {micro-step: loss} of the
    two training runs (one process on phase 6's tree, the reference of
    phase 9b)."""
    import shutil
    import tempfile

    import torch

    from stablemtl_tpu_torch import TASKS
    from stablemtl_tpu_torch.cli import eval as eval_cli
    from stablemtl_tpu_torch.cli import serve
    from stablemtl_tpu_torch.cli import train as train_cli
    from stablemtl_tpu_torch.config import recursive_load_config
    from stablemtl_tpu_torch.factory import model_configs_from
    from stablemtl_tpu_torch.models.unet import UNet2DConditionModel
    from stablemtl_tpu_torch.ops import flash_attention as fa
    from stablemtl_tpu_torch.utils.png import read_png, write_png

    t_phase = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        lists = write_phase6_tree(os.path.join(tmp, "data"), seed=6)
        cfg_path = os.path.join(tmp, "phase6.yaml")
        phase6_config(cfg_path, lists)
        run = os.path.join(tmp, "run")
        argv = ["--config", cfg_path, "--base_data_dir",
                os.path.join(tmp, "data"), "--output_dir", run]
        print(f"[entry] tree and config written in "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        # `latest` holds the parameters, Adam's mu and nu and the
        # accumulated gradient, f32; a save keeps the old slot until the
        # new one is in place: two slots at the peak
        with torch.device("meta"):
            n = sum(p.numel() for p in UNet2DConditionModel(
                model_configs_from(recursive_load_config(cfg_path))[0])
                .parameters())
        need, free = 2 * 4 * 4 * n, shutil.disk_usage(tmp).free
        print(f"[entry] {n / 1e9:.3f} B trainable parameters: two "
              f"checkpoint slots need {need} bytes, {tmp} has {free} free",
              flush=True)
        if free < need:
            fail(f"phase 6 needs {need} bytes of disk for its checkpoints, "
                 f"{tmp} has {free} free")

        reset_counts()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv + ["--num_workers", "2"])
        torch.cuda.synchronize()
        paths["cli.train"] = read_counts()
        print(f"[entry] cli.train: {len(trainer.step_times)} micro-steps in "
              f"{time.perf_counter() - t0:.1f} s (pipeline build included);"
              f" launches: " + " ".join(
                  f"{k.__name__}={v}" for k, v in paths["cli.train"].items()),
              flush=True)
        print_step_times(trainer, phase4_ms)
        print_checkpoint_io("cli.train", trainer.ckpt)
        losses = [loss for _, _, loss in trainer.losses]
        step_losses = {s: loss for s, _, loss in trainer.losses}
        print(f"[entry] losses {losses}, loss EMA {trainer.loss_ema}",
              flush=True)
        if [s for s, *_ in trainer.step_times] != [1, 2, 3, 4] or \
                trainer.state.step != 4 or trainer.state.opt.count != 2:
            fail(f"cli.train ran micro-steps "
                 f"{[s for s, *_ in trainer.step_times]}, step "
                 f"{trainer.state.step}, {trainer.state.opt.count} updates")
        if [name for name, *_ in trainer.ckpt.saves] != ["latest"]:
            fail(f"cli.train saved {trainer.ckpt.saves}, one save wanted")
        if not all(math.isfinite(v) for v in losses + list(
                trainer.loss_ema.values())):
            fail("a non-finite training loss")
        hws = {hw for _, _, hw, _ in trainer.step_times}
        if hws != {P6_VKITTI_HW, P6_HYPERSIM_HW}:
            fail(f"micro-steps ran at {hws}")
        del trainer
        torch.cuda.empty_cache()

        reset_counts()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv + ["--max_iter", "3"])
        torch.cuda.synchronize()
        paths["cli.train resumed"] = read_counts()
        steps = [s for s, *_ in trainer.step_times]
        print(f"[entry] cli.train --max_iter 3: resumed, micro-steps "
              f"{steps} in {time.perf_counter() - t0:.1f} s; launches: "
              + " ".join(f"{k.__name__}={v}" for k, v in
                         paths["cli.train resumed"].items()), flush=True)
        print_step_times(trainer, phase4_ms)
        print_checkpoint_io("cli.train resumed", trainer.ckpt)
        losses = [loss for _, _, loss in trainer.losses]
        step_losses.update({s: loss for s, _, loss in trainer.losses})
        print(f"[entry] losses {losses}, loss EMA {trainer.loss_ema}",
              flush=True)
        if steps != [5, 6] or trainer.state.step != 6 or \
                trainer.state.opt.count != 3:
            fail(f"the resumed run ran micro-steps {steps} to step "
                 f"{trainer.state.step} ({trainer.state.opt.count} "
                 f"updates); 5 and 6 to step 6 (3 updates) wanted")
        if not all(math.isfinite(v) for v in losses + list(
                trainer.loss_ema.values())):
            fail("a non-finite loss after the resume")
        for path in ("cli.train", "cli.train resumed"):
            for kernel in (fa.flash_fwd_resident_lse, fa.flash_bwd_dq,
                           fa.flash_bwd_dkv):
                if paths[path][kernel] == 0:
                    fail(f"{kernel.__name__} launched 0 times in {path}")
        final = {k: p.detach().cpu() for k, p in trainer.state.params.items()}
        del trainer
        torch.cuda.empty_cache()

        reset_counts()
        t0 = time.perf_counter()
        results, ev = eval_cli.main([
            "--config", run, "--base_data_dir", os.path.join(tmp, "data"),
            "--split", "test", "--output_dir", os.path.join(tmp, "eval"),
            "--max_samples", "2", "--eval_batch_size", "2"])
        torch.cuda.synchronize()
        paths["cli.eval"] = read_counts()
        print(f"[entry] cli.eval in {time.perf_counter() - t0:.1f} s "
              f"(pipeline build included); launches: " + " ".join(
                  f"{k.__name__}={v}" for k, v in paths["cli.eval"].items())
              + f"; results {json.dumps(results)}", flush=True)
        print_checkpoint_io("cli.eval", ev.ckpt)
        same = sum(torch.equal(ev.state.params[k].cpu(), v)
                   for k, v in final.items())
        print(f"[entry] cli.eval restored step {ev.state.step}: {same} of "
              f"{len(final)} parameters bit-equal to the trainer's",
              flush=True)
        if ev.state.step != 6 or same != len(final) or \
                set(ev.state.params) != set(final):
            fail("the params-only restore is not the trainer's parameters")
        values = [v for per in results.values() for row in per.values()
                  for v in row.values()]
        if set(results) != {"vkitti_depth_eval", "kitti_flow_2015"} or \
                not all(math.isfinite(v) for v in values):
            fail(f"eval results {results}")
        for kernel in (fa.flash_fwd_resident, fa.flash_fwd_stream):
            if paths["cli.eval"][kernel] == 0:
                fail(f"{kernel.__name__} launched 0 times in cli.eval")
        del ev, final
        torch.cuda.empty_cache()

        image = os.path.join(tmp, "req.png")
        write_png(image, serving_requests(1, seed=13)[0])
        out_dir = os.path.join(tmp, "served")
        t0 = time.perf_counter()
        serve.main(["--config", run, "--checkpoint",
                    os.path.join(run, "checkpoint"), "--images", image,
                    "--output_dir", out_dir, "--res", str(SERVE_RES),
                    "--batch", "1"])
        torch.cuda.synchronize()
        shapes = {read_png(os.path.join(out_dir, f"req_{t}.png")).shape
                  for t in TASKS}
        print(f"[entry] cli.serve --checkpoint of 1 image in "
              f"{time.perf_counter() - t0:.1f} s (pipeline build and "
              f"restore included): {len(TASKS)} PNGs of {shapes}",
              flush=True)
        if shapes != {(SERVE_RES, SERVE_RES, 3)}:
            fail(f"cli.serve --checkpoint wrote PNGs of shapes {shapes}")
    torch.cuda.empty_cache()
    print(f"[entry] phase 6 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths, step_losses


# ---------------------------------------------------------------------------
# Phase 7: weights without JAX, activation recompute, the single-chip recipe
# ---------------------------------------------------------------------------

# the flagship's micro-batch (config/train_stablemtl.yaml,
# dataloader.max_train_batch_size) with accumulation 2
P7_MB16 = 16
# the training path in f32 at batch 1 under each recompute policy against
# none, on the same weights, batch and generator: relative L2 of the loss
# and of all main-UNet gradients concatenated (predicted bit-equal)
P7_REMAT_REL_L2 = 1e-6
P7_REMAT = (("none", False, "none"), ("full", True, "full"),
            ("dots", True, "dots"))


def _tools_module(name: str):
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import importlib

    return importlib.import_module(name)


def _nbytes_of(*modules) -> int:
    return sum(4 * p.numel() for m in modules for p in m.parameters())


def run_converter(argv, what: str) -> float:
    """python -m stablemtl_tpu_torch.cli.convert_sd2 in a process of its
    own (no JAX on this machine); returns its wall seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "stablemtl_tpu_torch.cli.convert_sd2", *argv],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    for line in res.stdout.strip().splitlines():
        print(f"[p7] {what}: {line}", flush=True)
    if res.returncode != 0:
        print(res.stderr[-4000:], flush=True)
        fail(f"cli.convert_sd2 ({what}) exited {res.returncode}")
    print(f"[p7] {what}: {secs:.1f} s", flush=True)
    return secs


def phase7_ingest() -> dict:
    """Synthetic SD2 and reference weights -> cli.convert_sd2 -> the
    flagship pipeline: every parameter bit-equal to its source, then one
    batch-1 512x512 infer_all_tasks. Returns its launches."""
    import shutil
    import tempfile

    import torch

    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.models.clip import (CLIPTextConfig,
                                                 CLIPTextModel)
    from stablemtl_tpu_torch.models.unet import (UNet2DConditionModel,
                                                 UNetConfig, inflate_conv_in)
    from stablemtl_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from stablemtl_tpu_torch.ops import flash_attention as fa

    synth = _tools_module("torch_make_synthetic_sd2")
    with torch.device("meta"):
        sd2 = _nbytes_of(UNet2DConditionModel(UNetConfig(in_channels=4)),
                         AutoencoderKL(VAEConfig()),
                         CLIPTextModel(CLIPTextConfig()))
        ms = _nbytes_of(UNet2DConditionModel(UNetConfig(
            use_task_attention=True)))
        unet4 = _nbytes_of(UNet2DConditionModel(UNetConfig(in_channels=4)))
    with tempfile.TemporaryDirectory() as tmp:
        # the SD2 directory and the reference .pth, then unet_child.npz
        # (SD2's UNet), unet.npz (the reference's) and vae.npz
        need = sd2 + ms + unet4 + ms + (sd2 - unet4)
        free = shutil.disk_usage(tmp).free
        print(f"[p7] ingestion needs ~{need} bytes of disk, {tmp} has "
              f"{free} free", flush=True)
        if free < need:
            fail(f"phase 7 needs {need} bytes of disk, {tmp} has {free}")
        src, out = os.path.join(tmp, "sd2"), os.path.join(tmp, "out")
        pth = os.path.join(tmp, "reference_unet.pth")
        t0 = time.perf_counter()
        made = synth.make_synthetic_sd2(
            src, seed=7, unet_safetensors=True, multistream_pth=pth,
            device="cuda", log=lambda m: print(f"[p7] {m}", flush=True))
        print(f"[p7] synthetic SD2 and reference weights in "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{sum(b for _, b, _ in made['files'].values())} bytes",
              flush=True)
        run_converter(["--sd2_dir", src, "--out_dir", out], "SD2")
        os.replace(os.path.join(out, "unet.npz"),
                   os.path.join(out, "unet_child.npz"))
        run_converter(["--sd2_dir", src, "--out_dir", out, "--unet_pth",
                       pth], "--unet_pth")
        for name in sorted(os.listdir(out)):
            print(f"[p7] {name}: {os.path.getsize(os.path.join(out, name))}"
                  f" bytes", flush=True)

        cfg = full_config("float32")
        cfg["model"]["pretrained_path"] = out
        t0 = time.perf_counter()
        pipe = build_pipeline(cfg, seed=0, image_hw=(512, 512))
        torch.cuda.synchronize()
        print(f"[p7] f32 flagship pipeline built from {out} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        child = dict(made["unet"])
        child["conv_in.weight"] = inflate_conv_in(child["conv_in.weight"], 3)
        for module, want, what, banks in (
                (pipe.vae, made["vae"], "vae", False),
                (pipe.unet, made["unet_ms"], "unet (reference .pth)", True),
                (pipe.unet_child, child, "unet_child (SD2)", False)):
            state = module.state_dict()
            expect = {n for n in state if banks or "task_attn" not in n}
            same = sum(torch.equal(state[n].cpu(), want[n]) for n in expect
                       if n in want)
            print(f"[p7] {what}: {same} of {len(expect)} parameters "
                  f"bit-equal to the synthetic source", flush=True)
            if set(want) & set(state) != expect or same != len(expect):
                fail(f"{what}: loaded parameters differ from the source")
        del made, child
        table = pipe.text_embed_table
        print(f"[p7] text table {tuple(table.shape)} from the converted "
              f"CLIP tower", flush=True)

        gen = torch.Generator(device="cuda").manual_seed(1)
        rgb = torch.rand((1, 512, 512, 3), generator=gen,
                         device="cuda") * 2 - 1
        reset_counts()
        t0 = time.perf_counter()
        result = pipe.infer_all_tasks(rgb, None)
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"[p7] infer_all_tasks (f32, converted weights) in "
              f"{time.perf_counter() - t0:.2f} s: {tuple(result.shape)}, "
              f"finite {bool(torch.isfinite(result).all())}; launches: "
              + " ".join(f"{k.__name__}={n}" for k, n in counts.items()),
              flush=True)
        if tuple(result.shape) != (7, 1, 512, 512, 3) or \
                not torch.isfinite(result).all():
            fail("inference from converted weights is not finite")
        for kernel in (fa.flash_fwd_resident, fa.flash_fwd_stream):
            if counts[kernel] == 0:
                fail(f"{kernel.__name__} launched 0 times on converted "
                     f"weights")
        del pipe, result
    torch.cuda.empty_cache()
    return counts


def _train_rounds(step, state, batches, what: str):
    """One warm-up micro-step, then the rest counted from 0: (ms per
    micro-step, {kernel: launches}). Peak memory is read per micro-step
    (the allocator's own count, no wait for the card): the largest over
    the micro-steps without an update and over those with one (the
    optimizer's temporaries on top). Then the forward and backward alone
    (`loss_and_grads` on the first timed batch): its peak above what was
    allocated before it, the activations and the gradients."""
    import torch

    step(state, batches[0])
    torch.cuda.synchronize()
    reset_counts()
    losses, peaks = [], {False: 0.0, True: 0.0}
    t0 = time.perf_counter()
    for batch in batches[1:]:
        torch.cuda.reset_peak_memory_stats()
        _, m = step(state, batch)
        losses.append(m["loss"])
        update = state.opt.mini_step == 0
        peaks[update] = max(peaks[update],
                            torch.cuda.max_memory_allocated() / 2**30)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (len(batches) - 1) * 1e3
    counts = read_counts()
    kept, above, before = forward_memory(step, state, batches[1])
    losses = [float(x) for x in losses]
    n = len(batches) - 1
    print(f"[p7] {what}: {ms:.2f} ms per micro-step ({n} timed), peak "
          f"{peaks[False]:.2f} GiB without an update, {peaks[True]:.2f} "
          f"GiB with one; above the {before:.2f} GiB held, the forward "
          f"keeps {kept:.2f} GiB for the backward, forward and backward "
          f"peak at {above:.2f} GiB (the f32 gradients "
          f"{sum(4 * p.numel() for p in state.params.values()) / 2**30:.2f}"
          f" GiB among them); per micro-step "
          + " ".join(f"{k.__name__}={v / n:g}" for k, v in counts.items())
          + f"; losses {losses}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: a non-finite loss")
    return ms, counts


def forward_memory(step, state, batch):
    """GiB above what is allocated before `loss_and_grads`: (what its
    forward keeps for the backward, read as the backward starts; its peak
    over forward and backward; what was allocated before)."""
    import torch

    before = torch.cuda.memory_allocated()
    at_backward = []
    grad = torch.autograd.grad

    def spy(*args, **kwargs):
        at_backward.append(torch.cuda.memory_allocated())
        return grad(*args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad = spy
    try:
        grads = step.loss_and_grads(state, batch)[2]
    finally:
        torch.autograd.grad = grad
    peak = torch.cuda.max_memory_allocated()
    del grads
    return ((at_backward[0] - before) / 2**30, (peak - before) / 2**30,
            before / 2**30)


def phase7_remat() -> dict:
    """Phase 4's recipe under each recompute policy, then the f32 check.
    Returns {path: launches} of the full and dots runs."""
    import dataclasses

    import torch

    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.ops import flash_attention as fa
    from stablemtl_tpu_torch.train_state import (OptimizerConfig,
                                                 create_train_state,
                                                 eval_state, make_train_step)
    from stablemtl_tpu_torch.utils.seeding import step_generator

    paths = {}
    pipe = build_pipeline(full_config("bfloat16", trainer=TRAINER), seed=0,
                          image_hw=TRAIN_HW, trainable=True)
    base = pipe.unet.config
    adam = OptimizerConfig(lr=1e-4, max_grad_norm=5.0, total_iters=25_000,
                           final_ratio=0.01, warmup_steps=100,
                           accumulation_steps=2)
    # two rounds a policy, in turns: none, full, dots, dots, full, none
    ms = {}
    for name, remat, policy in P7_REMAT + P7_REMAT[::-1]:
        pipe.unet.config = dataclasses.replace(base, remat=remat,
                                               remat_transformer=policy)
        state = create_train_state(pipe.unet, adam)
        step = make_train_step(pipe, base_seed=2024)
        round_ms, counts = _train_rounds(
            step, state, train_batches(5, TRAIN_BATCH, seed=7,
                                       device=pipe.device),
            f"remat {remat}, remat_transformer {policy}, micro-batch "
            f"{TRAIN_BATCH}, Adam")
        ms.setdefault(name, []).append(round_ms)
        if name != "none":
            paths.setdefault(f"train remat {name}", counts)
        per = {k: counts[k] / 4 for k in fa.KERNELS}
        k3 = 10 if name != "none" else 5
        if (per[fa.flash_fwd_resident_lse], per[fa.flash_bwd_dq],
                per[fa.flash_bwd_dkv]) != (k3, 5, 5):
            fail(f"remat {name}: K3-K5 launched {per} per micro-step")
        del state, step
        torch.cuda.empty_cache()
    print("[p7] ms per micro-step by policy, in turns: " + "; ".join(
        f"{name} " + ", ".join(f"{x:.2f}" for x in xs)
        for name, xs in ms.items()), flush=True)
    pipe.unet.config = base
    del pipe
    torch.cuda.empty_cache()

    # f32, batch 1, deterministic cuDNN: loss, grads and generator state
    torch.backends.cudnn.deterministic = True
    try:
        pipe = build_pipeline(full_config("float32", trainer=TRAINER),
                              seed=0, image_hw=TRAIN_HW, trainable=True)
        state = eval_state(pipe.unet)
        state.params = {n: p for n, p in state.params.items()
                        if p.requires_grad}
        step = make_train_step(pipe, base_seed=2024)
        batch = {k: (v[:1] if hasattr(v, "shape") else v)
                 for k, v in train_batches(1, TRAIN_BATCH, seed=6,
                                           device=pipe.device)[0].items()}
        batch["task_idx"] = 3
        base = pipe.unet.config
        ref = None
        # "none" twice: the step's own run-to-run spread, for scale
        for name, remat, policy in (P7_REMAT[:1] + (
                ("none (again)", False, "none"),) + P7_REMAT[1:]):
            pipe.unet.config = dataclasses.replace(
                base, remat=remat, remat_transformer=policy)
            gen = step_generator(2024, 0, pipe.device)
            loss, _, grads = step.loss_and_grads(state, batch,
                                                 generator=gen)
            if ref is None:
                ref = (loss, grads, gen.get_state())
                continue
            loss_rel = abs(float(loss) - float(ref[0])) / abs(float(ref[0]))
            diff = math.sqrt(sum((g - r).double().square().sum().item()
                                 for g, r in zip(grads, ref[1])))
            norm = math.sqrt(sum(r.double().square().sum().item()
                                 for r in ref[1]))
            same = sum(torch.equal(g, r) for g, r in zip(grads, ref[1]))
            gen_same = torch.equal(gen.get_state(), ref[2])
            print(f"[p7] f32 batch 1, remat {name} vs none: loss "
                  f"{float(loss):.8g} vs {float(ref[0]):.8g} (rel "
                  f"{loss_rel:.3e}); grads rel_l2 {diff / norm:.3e} (tol "
                  f"{P7_REMAT_REL_L2:g}), {same} of {len(grads)} leaves "
                  f"bit-equal; generator state equal: {gen_same}",
                  flush=True)
            del grads
            if name != "none (again)" and not (
                    loss_rel <= P7_REMAT_REL_L2
                    and diff / norm <= P7_REMAT_REL_L2 and gen_same):
                fail(f"remat {name} changes the f32 training step")
        del pipe, state, step, ref
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    return paths


def phase7_recipes() -> dict:
    """The JAX package's single-chip recipe (Adafactor, remat, bf16), then
    the flagship micro-batch, Adam with a bf16 first moment and
    apply_if_finite. Returns {path: launches} of the micro-batch-16 run."""
    import dataclasses

    import torch

    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.train_state import (OptimizerConfig,
                                                 create_train_state,
                                                 make_train_step)

    pipe = build_pipeline(full_config("bfloat16", trainer=TRAINER), seed=0,
                          image_hw=TRAIN_HW, trainable=True)
    pipe.unet.config = dataclasses.replace(pipe.unet.config, remat=True,
                                           remat_transformer="full")
    sched = dict(lr=1e-4, max_grad_norm=5.0, total_iters=25_000,
                 final_ratio=0.01, warmup_steps=100, accumulation_steps=2)
    step = make_train_step(pipe, base_seed=2024)

    # Adafactor + remat full + bf16 at micro-batch 2: lr(0) = 0 moves
    # nothing, the second update moves the parameters
    state = create_train_state(pipe.unet, OptimizerConfig(
        optimizer="adafactor", **sched))
    n_factored = sum(d is not None for d in state.opt.dims)
    initial = {n: p.detach().clone() for n, p in state.params.items()}
    t0 = time.perf_counter()
    for i, batch in enumerate(train_batches(4, TRAIN_BATCH, seed=8,
                                            device=pipe.device)):
        _, m = step(state, batch)
        if not math.isfinite(float(m["loss"])):
            fail(f"adafactor micro-step {i + 1}: non-finite loss")
        if i == 1 and any(not torch.equal(p, initial[n])
                          for n, p in state.params.items()):
            fail("adafactor: the first update (lr 0) moved parameters")
    torch.cuda.synchronize()
    moved = sum(not torch.equal(p, initial[n])
                for n, p in state.params.items())
    finite = all(bool(torch.isfinite(p).all())
                 for p in state.params.values())
    print(f"[p7] adafactor + remat full + bf16, micro-batch {TRAIN_BATCH}: "
          f"4 micro-steps in {time.perf_counter() - t0:.2f} s, "
          f"{n_factored} of {len(initial)} leaves factored, {moved} leaves "
          f"moved by update 2, parameters finite {finite}", flush=True)
    if state.opt.count != 2 or moved == 0 or not finite:
        fail("adafactor: the second update did not move finite parameters")
    del initial

    # the flagship's micro-batch 16, accumulation 2: one update
    torch.cuda.empty_cache()
    reset_counts()
    peaks, times = [], []
    try:
        for batch in train_batches(2, P7_MB16, seed=9, device=pipe.device):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, m = step(state, batch)
            loss = float(m["loss"])  # waits for the card
            times.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            if not math.isfinite(loss):
                fail("micro-batch 16: non-finite loss")
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        fail(f"micro-batch {P7_MB16} with adafactor + remat full does not "
             f"fit: {str(e).splitlines()[0]}")
    counts = read_counts()
    kept, above, before = forward_memory(step, state, batch)
    print(f"[p7] micro-batch {P7_MB16}, remat full: above the {before:.2f} "
          f"GiB held, the forward keeps {kept:.2f} GiB, forward and "
          f"backward peak at {above:.2f} GiB", flush=True)
    # the same micro-batch without recompute: does it fit?
    pipe.unet.config = dataclasses.replace(pipe.unet.config, remat=False,
                                           remat_transformer="none")
    torch.cuda.empty_cache()
    try:
        kept, above, before = forward_memory(step, state, batch)
        print(f"[p7] micro-batch {P7_MB16} without recompute: above the "
              f"{before:.2f} GiB held, the forward keeps {kept:.2f} GiB, "
              f"forward and backward peak at {above:.2f} GiB", flush=True)
    except torch.cuda.OutOfMemoryError as e:
        print(f"[p7] micro-batch {P7_MB16} without recompute does not fit: "
              f"{str(e).splitlines()[0]}", flush=True)
    pipe.unet.config = dataclasses.replace(pipe.unet.config, remat=True,
                                           remat_transformer="full")
    torch.cuda.empty_cache()
    print(f"[p7] micro-batch {P7_MB16} (accumulation 2), adafactor + remat "
          f"full, bf16 at {TRAIN_HW[0]}x{TRAIN_HW[1]}: micro-steps "
          f"{times[0]:.2f} ms (without an update, the first at this batch)"
          f" and {times[1]:.2f} ms (with one), "
          f"{P7_MB16 / times[1] * 1e3:.4f} train images/s at the second; "
          f"peak {peaks[0]:.2f} and {peaks[1]:.2f} GiB; launches "
          + " ".join(f"{k.__name__}={v}" for k, v in counts.items()),
          flush=True)
    if state.opt.count != 3:
        fail(f"micro-batch 16: {state.opt.count} updates, 3 wanted")
    del state
    torch.cuda.empty_cache()

    # Adam with its first moment in bf16: one update
    state = create_train_state(pipe.unet, OptimizerConfig(
        lr=1e-4, use_schedule=False, mu_dtype="bfloat16"))
    before = {n: p.detach().clone() for n, p in state.params.items()}
    step(state, train_batches(1, TRAIN_BATCH, seed=10,
                              device=pipe.device)[0])
    torch.cuda.synchronize()
    dtypes = {m.dtype for m in state.opt.mu}
    moved = sum(not torch.equal(p, before[n])
                for n, p in state.params.items())
    finite = all(bool(torch.isfinite(p).all())
                 for p in state.params.values()) and all(
        bool(torch.isfinite(m).all()) for m in state.opt.mu)
    print(f"[p7] Adam, mu_dtype bfloat16: 1 update, mu dtypes {dtypes}, "
          f"{moved} leaves moved, finite {finite}", flush=True)
    if dtypes != {torch.bfloat16} or not moved or not finite:
        fail("Adam with mu_dtype bfloat16")
    del state, before
    torch.cuda.empty_cache()

    # apply_if_finite: a NaN in the second micro-step's gradient of an
    # accumulation; the update is skipped and nothing moves
    state = create_train_state(pipe.unet, OptimizerConfig(
        lr=1e-4, use_schedule=False, accumulation_steps=2,
        skip_nonfinite_updates=3))
    batches = train_batches(2, TRAIN_BATCH, seed=11, device=pipe.device)
    _, _, g1 = step.loss_and_grads(state, batches[0])
    state.opt.update(g1)
    del g1
    _, _, g2 = step.loss_and_grads(state, batches[1])
    g2[0].view(-1)[0] = float("nan")
    before = {n: p.detach().clone() for n, p in state.params.items()}
    changed = state.opt.update(g2)
    same = sum(torch.equal(p, before[n]) for n, p in state.params.items())
    opt = state.opt
    counters = (opt.notfinite_count, opt.last_finite, opt.total_notfinite,
                opt.count)
    print(f"[p7] skip_nonfinite_updates 3, NaN planted in micro-step 2 of "
          f"2: update applied {changed}, {same} of {len(before)} leaves "
          f"bit-equal; (notfinite_count, last_finite, total_notfinite, "
          f"count) = {counters}", flush=True)
    if changed or same != len(before) or counters != (1, False, 1, 0):
        fail("apply_if_finite did not skip the non-finite update")
    del state, before, g2, pipe, step
    torch.cuda.empty_cache()
    return {"train adafactor mb16": counts}


def phase_artifact() -> dict:
    """Phase 8. Returns {path: {kernel: launches}} of the two artifact
    runs, each counted from 0 in the process that loaded the artifact."""
    os.environ["STABLEMTL_FUSED_GEGLU"] = "1"
    try:
        return _artifact()
    finally:
        del os.environ["STABLEMTL_FUSED_GEGLU"]


def _export_cli(run_dir: str, path: str, batch: int, pair: bool):
    """`python -m stablemtl_tpu_torch.cli.serve --export` in a process of
    its own, started (not waited for)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "stablemtl_tpu_torch.cli.serve",
           "--config", run_dir, "--export", path, "--res", str(SERVE_RES),
           "--batch", str(batch), "--seed", "0"] + (["--pair"] if pair
                                                    else [])
    return subprocess.Popen(cmd, cwd=root, env=dict(os.environ,
                                                    PYTHONPATH=root),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _artifact():
    import tempfile

    import numpy as np
    import torch

    from stablemtl_tpu_torch.config import resolve_config_arg
    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.predict import _to_norm
    from stablemtl_tpu_torch.serving import export_pipeline, params_bundle

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        write_run_dir(run_dir)
        files = {name: os.path.join(tmp, f"{name.replace(' ', '_')}.pt2")
                 for name, _, _ in ART_RUNS}
        procs = {name: _export_cli(run_dir, files[name], batch, pair)
                 for name, batch, pair in ART_RUNS}

        # meanwhile, the same configuration here: an export with every
        # counter at 0, timed, then the bundle and the inputs for the
        # process that loads the artifacts
        cfg, _ = resolve_config_arg(run_dir)
        pipe = build_pipeline(cfg, seed=0, image_hw=(SERVE_RES, SERVE_RES))
        reset_counts()
        t0 = time.perf_counter()
        blob = export_pipeline(pipe, batch=SERVE_BATCH,
                               res_hw=(SERVE_RES, SERVE_RES))
        export_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if any(read_counts().values()):
            fail(f"exporting launched kernels: {read_counts()}")
        bundle = params_bundle(pipe)
        bundle_bytes = sum(t.numel() * t.element_size() for t in
                           _bundle_tensors(bundle))
        imgs = [torch.from_numpy(_to_norm(im)).to(pipe.device)
                for im in serving_requests(3, seed=13)]
        inputs = {"artifact b2": [torch.stack(imgs[:2])],
                  "artifact pair b1": [imgs[0][None], imgs[2][None]]}
        data = os.path.join(tmp, "bundle.pt")
        torch.save({"bundle": bundle, "inputs": inputs}, data)
        print(f"[art] export here (batch {SERVE_BATCH}, single frame): "
              f"{export_s:.2f} s, {len(blob)} bytes, no launch; bundle "
              f"{bundle_bytes} bytes", flush=True)

        for name, batch, pair in ART_RUNS:
            out, err = procs[name].communicate(timeout=900)
            if procs[name].returncode != 0:
                print(err[-4000:], flush=True)
                fail(f"cli.serve --export ({name}) exited "
                     f"{procs[name].returncode}")
            line = json.loads(out.strip().splitlines()[-1])
            size = os.path.getsize(files[name])
            print(f"[art] cli.serve --export ({name}): {line}", flush=True)
            if line != {"artifact": files[name], "bytes": size,
                        "batch": batch, "res": SERVE_RES, "pair": pair}:
                fail(f"cli.serve --export printed {line}")
            if not size < ART_MAX_SHARE * bundle_bytes:
                fail(f"the artifact holds {size} bytes, the bundle "
                     f"{bundle_bytes}")
        print(f"[art] both exports done {time.perf_counter() - t_phase:.1f}"
              f" s into the phase", flush=True)

        # a fresh process: the bundle and the artifacts, no pipeline
        root = os.path.dirname(os.path.abspath(__file__))
        res = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.run_artifacts(sys.argv[1])", tmp],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], flush=True)
            fail(f"the process that loads the artifacts exited "
                 f"{res.returncode}")
        child = json.loads(res.stdout.strip().splitlines()[-1])
        if child["foreign_modules"] or child["model_objects"]:
            fail(f"the artifacts' process imported {child['foreign_modules']}"
                 f" and built {child['model_objects']}")

        paths = {}
        for name, batch, pair in ART_RUNS:
            got = torch.load(os.path.join(tmp, f"out_{batch}_{pair}.pt"))
            run = child["runs"][name]
            x = inputs[name]
            step = (lambda: pipe.infer_all_tasks(x[0], x[1] if pair
                                                 else None))
            step()
            reset_counts()
            want = step()
            torch.cuda.synchronize()
            eager = {k.__name__: n for k, n in read_counts().items()}
            eager_ms = _step_ms(step)
            max_abs, rel = compare(got.to(want.device), want)
            print(f"[art] {name}: load {run['load_s']:.2f} s; ms/step "
                  f"artifact {run['ms']:.2f}, eager {eager_ms:.2f} "
                  f"(ratio {run['ms'] / eager_ms:.4f}); vs eager "
                  f"max|diff| {max_abs:.4e} rel_l2 {rel:.4e} (tol "
                  f"{ART_REL_L2:g}); launches artifact {run['launches']}, "
                  f"eager {eager}", flush=True)
            if tuple(got.shape) != (7, batch, SERVE_RES, SERVE_RES, 3) or \
                    not torch.isfinite(got).all():
                fail(f"{name}: output {tuple(got.shape)} not finite [7, "
                     f"{batch}, {SERVE_RES}, {SERVE_RES}, 3]")
            if not rel <= ART_REL_L2:
                fail(f"{name} disagrees with eager infer_all_tasks")
            if run["launches"] != eager:
                fail(f"{name} launched {run['launches']}, eager {eager}")
            paths[name] = {k: run["launches"][k.__name__]
                           for k in all_kernels()}
        want = {"flash_fwd_resident_lse": 0, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0, "geglu_fused": GEGLU_LAUNCHES_PER_STEP}
        b2 = child["runs"]["artifact b2"]["launches"]
        if any(b2[k] != n for k, n in want.items()) or \
                not (b2["flash_fwd_resident"] and b2["flash_fwd_stream"]):
            fail(f"the batch-2 artifact launched {b2} (want {want}, K1 and "
                 f"K2 > 0)")
    del pipe
    torch.cuda.empty_cache()
    print(f"[art] phase 8 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def _bundle_tensors(bundle):
    for v in bundle.values():
        yield from (v.values() if isinstance(v, dict) else (v,))


def _step_ms(step) -> float:
    """ms per step: host clock around ART_STEPS synchronized steps, after
    a warm-up step."""
    import torch

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ART_STEPS):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ART_STEPS * 1e3


def run_artifacts(tmp: str):
    """Phase 8's fresh process: read the bundle and the inputs phase 8
    wrote to `tmp`, load each artifact and run it: launches of one step
    with every counter at 0, load seconds, ms per step. Builds no pipeline;
    prints one JSON line last."""
    import gc

    import torch

    from stablemtl_tpu_torch.serving import load_exported

    # the tensors come back on the device they were saved from
    data = torch.load(os.path.join(tmp, "bundle.pt"), weights_only=True)
    runs = {}
    for name, batch, pair in ART_RUNS:
        t0 = time.perf_counter()
        exported = load_exported(os.path.join(
            tmp, f"{name.replace(' ', '_')}.pt2"))
        load_s = time.perf_counter() - t0
        x = data["inputs"][name]

        def step():
            return exported.call(data["bundle"], *x)

        step()
        reset_counts()
        out = step()
        torch.cuda.synchronize()
        launches = {k.__name__: n for k, n in read_counts().items()}
        torch.save(out.cpu(), os.path.join(tmp, f"out_{batch}_{pair}.pt"))
        runs[name] = dict(load_s=load_s, ms=_step_ms(step),
                          launches=launches)
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "stablemtl_tpu"))
    models = sorted({type(o).__name__ for o in gc.get_objects()
                     if isinstance(o, torch.nn.Module) and
                     type(o).__module__.startswith("stablemtl_tpu_torch")})
    print(json.dumps({"runs": runs, "foreign_modules": foreign,
                      "model_objects": models}), flush=True)


def phase_ingest_and_recipes() -> dict:
    """Phase 7. Returns {path: {kernel: launches}}."""
    t0 = time.perf_counter()
    paths = {"convert+infer": phase7_ingest()}
    print(f"[p7] ingestion in {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    paths.update(phase7_remat())
    print(f"[p7] remat in {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    paths.update(phase7_recipes())
    print(f"[p7] recipes in {time.perf_counter() - t1:.1f} s; phase 7 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# ---------------------------------------------------------------------------
# Phase 9: data parallelism across processes
# ---------------------------------------------------------------------------

# relative bars of the f32 cross-rank check (2 ranks of batch 1 against one
# process of batch 2): the loss, and the main UNet's gradients (relative L2)
P9_LOSS_REL = 1e-6
P9_GRAD_REL_L2 = 1e-5
P9_TRAINER_F32 = dict(multi_stream=True, attn_mask_ratio=1.0,
                      attn_mask_type="highest")
# 9b's bar: each micro-step's loss of cli.train over 2 ranks (and 11d's:
# the tensor-parallel ranks and the 1-process run resumed from their
# checkpoint) against phase 6's one process on the same tree, recipe and
# global micro-batch, relative. bf16
# convolutions round differently at batch 1 and 2 (ROADMAP C); another
# row, or a row left out, moves a loss by far more.
P9_BF16_LOSS_REL = 5e-3
P9_WORLD = 2
P9_TIMEOUT_S = 900


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_env(rank: int, port: int) -> dict:
    """The env contract of one of P9_WORLD ranks sharing card 0 over gloo."""
    root = os.path.dirname(os.path.abspath(__file__))
    # two processes share the card's memory: segments that grow in place
    # keep each one's reserve close to what it holds
    return dict(os.environ, PYTHONPATH=root,
                PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
                STABLEMTL_COORDINATOR=f"127.0.0.1:{port}",
                STABLEMTL_NUM_PROCESSES=str(P9_WORLD),
                STABLEMTL_PROCESS_ID=str(rank), LOCAL_RANK="0",
                STABLEMTL_DIST_BACKEND="gloo")


def _dp_ranks(call: str, args, tmp: str, what: str) -> list:
    """Runs `chip_smoke.<call>(out, *args)` in P9_WORLD processes of their
    own (the env contract, gloo, all on card 0); returns each rank's JSON
    result. Every process is waited for or killed."""
    root = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    procs = []
    try:
        for r in range(P9_WORLD):
            out = os.path.join(tmp, f"{what}_rank{r}.json")
            log = open(os.path.join(tmp, f"{what}_rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", f"import sys, chip_smoke; "
                 f"chip_smoke.{call}(sys.argv[1], *sys.argv[2:])", out,
                 *args], cwd=root, env=_dp_env(r, port), stdout=log,
                stderr=subprocess.STDOUT), log, out))
        results = []
        for proc, log, out in procs:
            rc = proc.wait(timeout=P9_TIMEOUT_S)
            log.close()
            if rc != 0:
                with open(log.name) as f:
                    print(f.read()[-6000:], flush=True)
                fail(f"{what}: rank process exited {rc}")
            with open(out) as f:
                results.append(json.load(f))
        return results
    finally:
        for proc, log, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def _digest(tensors) -> str:
    from stablemtl_tpu_torch.parallel.sharded_train import param_digest

    return param_digest(list(tensors))


def phase_data_parallel(phase4_ms, p6_losses) -> dict:
    """Phase 9. Returns {path: {kernel: launches}} of the counted runs.
    p6_losses: phase 6's {micro-step: loss}, 9b's reference."""
    import tempfile

    t_phase = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[dp] compute mode {mode}", flush=True)
    if "Exclusive_Process" in mode:
        fail(f"compute mode {mode}: two processes cannot share the card, "
             f"so phase 9 cannot run its ranks")
    paths = {"dp nccl 1-rank": dp_one_rank_nccl(phase4_ms)}
    print(f"[dp] 9a in {time.perf_counter() - t_phase:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths.update(dp_cli_two_ranks(tmp, phase4_ms, p6_losses))
        print(f"[dp] 9b in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        dp_check_f32_and_memory(tmp)
        print(f"[dp] 9c in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[dp] phase 9 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def dp_one_rank_nccl(phase4_ms) -> dict:
    """9a: a process group of one rank on NCCL (the port's env contract),
    `make_sharded_train_step(zero1=True)` against `make_train_step` on the
    same weights and phase 4's recipe and 4 micro-batches: losses and
    parameters bit-equal. Returns the sharded run's launches."""
    import torch

    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.ops import flash_attention as fa
    from stablemtl_tpu_torch.parallel import make_mesh
    from stablemtl_tpu_torch.parallel.distributed import (maybe_initialize,
                                                          shutdown)
    from stablemtl_tpu_torch.parallel.sharded_train import (
        create_sharded_train_state, make_sharded_train_step)
    from stablemtl_tpu_torch.train_state import (OptimizerConfig,
                                                 create_train_state,
                                                 make_train_step)

    env = {"STABLEMTL_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "STABLEMTL_NUM_PROCESSES": "1", "STABLEMTL_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        if not maybe_initialize(device="cuda"):
            fail("maybe_initialize opened no process group")
    finally:
        for k in env:
            del os.environ[k]
    try:
        mesh = make_mesh()
        backend = torch.distributed.get_backend()
        print(f"[dp] 9a: process group of {mesh.data} on {backend}",
              flush=True)
        if backend != "nccl":
            fail(f"9a runs on {backend}, not nccl")
        pipe = build_pipeline(full_config("bfloat16", trainer=TRAINER),
                              seed=0, image_hw=TRAIN_HW, trainable=True)
        cfg = OptimizerConfig(lr=1e-4, max_grad_norm=5.0, total_iters=25_000,
                              final_ratio=0.01, warmup_steps=100,
                              accumulation_steps=2)
        batches = train_batches(4, TRAIN_BATCH, seed=4, device=pipe.device)
        initial = [p.detach().to("cpu", copy=True)
                   for p in pipe.unet.parameters() if p.requires_grad]
        # in turns, each run from the same weights: plain, sharded,
        # sharded, plain
        runs = {"plain": [], "sharded": []}
        for name in ("plain", "sharded", "sharded", "plain"):
            with torch.no_grad():
                for p, p0 in zip((p for p in pipe.unet.parameters()
                                  if p.requires_grad), initial):
                    p.copy_(p0)
            if name == "plain":
                state = create_train_state(pipe.unet, cfg)
                step = make_train_step(pipe, base_seed=2024)
            else:
                state = create_sharded_train_state(pipe.unet, cfg, mesh,
                                                   zero1=True)
                step = make_sharded_train_step(pipe, mesh, base_seed=2024,
                                               zero1=True)
                mesh.reduced_bytes = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            losses, secs = [], []
            for batch in batches:
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
            run = dict(losses=losses, counts=read_counts(),
                       ms=sum(secs[1:]) / len(secs[1:]) * 1e3,
                       peak=torch.cuda.max_memory_allocated() / 2**30)
            if not runs[name]:
                run["params"] = [p.detach().to("cpu", copy=True)
                                 for p in state.params.values()]
            runs[name].append(run)
            print(f"[dp] 9a {name}: losses {losses}, ms per micro-step "
                  f"{run['ms']:.2f} (micro-steps 2-4; phase 4: "
                  + ", ".join(f"{x:.2f}" for x in phase4_ms)
                  + f"), peak memory {run['peak']:.2f} GiB, launches per "
                  f"micro-step " + " ".join(
                      f"{k.__name__}={n / len(batches):g}"
                      for k, n in run["counts"].items()), flush=True)
            del state, step
        print(f"[dp] 9a sharded: {mesh.reduced_bytes / len(batches):.0f} "
              f"bytes all-reduced per micro-step, {mesh.staged_bytes} "
              f"staged through the host", flush=True)
        plain, sharded = runs["plain"][0], runs["sharded"][0]
        same = sum(torch.equal(a, b) for a, b in zip(plain["params"],
                                                     sharded["params"]))
        equal = all(r["losses"] == plain["losses"]
                    for r in runs["plain"] + runs["sharded"])
        ms = {k: [r["ms"] for r in v] for k, v in runs.items()}
        print(f"[dp] 9a: {same} of {len(initial)} parameters bit-equal, "
              f"losses of all 4 runs equal: {equal}; ms per micro-step "
              f"plain {ms['plain']}, sharded {ms['sharded']} (sharded / "
              f"plain {sum(ms['sharded']) / sum(ms['plain']):.4f})",
              flush=True)
        if same != len(initial) or not equal:
            fail("the 1-rank data-parallel step is not bit-equal to the "
                 "plain step")
        if mesh.staged_bytes:
            fail("the NCCL path staged bytes through the host")
        counts = sharded["counts"]
        for kernel in fa.KERNELS:
            if counts[kernel] == 0:
                fail(f"{kernel.__name__} launched 0 times in 9a")
        del pipe, runs, initial
        torch.cuda.empty_cache()
        return counts
    finally:
        shutdown()


@contextlib.contextmanager
def no_final_save():
    """cli.train without its end-of-run save, for the one-process resumes
    of 9b and 11d: the checkpoint is read back and trained on, and a
    second 20 GB write would be read by nothing."""
    from stablemtl_tpu_torch.trainer import StableMTLTrainer

    save_final = StableMTLTrainer.save_final
    StableMTLTrainer.save_final = lambda self, meta: None
    try:
        yield
    finally:
        StableMTLTrainer.save_final = save_final


def dp_cli_two_ranks(tmp: str, phase4_ms, p6_losses) -> dict:
    """9b: `cli.train` as 2 ranks sharing the card over gloo (phase 6's tree
    and recipe, full width, ZeRO-1, global micro-batch 2 = 1 row a rank,
    accumulation 2, max_iter 1: 2 micro-steps and one save), then
    `cli.train --max_iter 2` here on one process (micro-batch 2), resuming
    the 2-rank checkpoint, its ZeRO-1 slices gathered over gloo, and
    saving nothing. Each micro-step's loss is held against phase 6's (one
    process, the same micro-steps). The refusal of another schedule is
    checked in the CPU tests. Returns the launches of the three runs."""
    import gc

    import torch

    from stablemtl_tpu_torch.cli import train as train_cli
    from stablemtl_tpu_torch.ops import flash_attention as fa

    def check_losses(what, losses):
        rel = {s: abs(loss - p6_losses[s]) / abs(p6_losses[s])
               for s, loss in losses.items()}
        print(f"[dp] 9b {what} losses {losses} vs phase 6's "
              f"{ {s: p6_losses[s] for s in losses} }: relative "
              f"{rel} (bar {P9_BF16_LOSS_REL:g})", flush=True)
        if not all(r <= P9_BF16_LOSS_REL for r in rel.values()):
            fail(f"9b {what}: losses off phase 6's one process")

    lists = write_phase6_tree(os.path.join(tmp, "data"), seed=6)
    base = os.path.join(tmp, "phase6.yaml")
    phase6_config(base, lists)
    cfg2 = os.path.join(tmp, "dp2.yaml")
    with open(cfg2, "w") as f:
        json.dump({"base_config": [base], "parallel": {"zero1": True},
                   "dataloader": {"max_train_batch_size": 1}}, f)
    run = os.path.join(tmp, "dp_run")
    common = ["--base_data_dir", os.path.join(tmp, "data"), "--output_dir",
              run, "--num_workers", "0"]
    t0 = time.perf_counter()
    ranks = _dp_ranks("dp_cli_rank", ["--config", cfg2, "--max_iter", "1"]
                      + common, tmp, "cli")
    print(f"[dp] 9b: 2 ranks of cli.train in {time.perf_counter() - t0:.1f}"
          f" s (process start and pipeline build included)", flush=True)
    paths = {}
    for r, res in enumerate(ranks):
        counts = res["launches"]
        paths[f"dp cli rank {r}"] = {k: counts[k.__name__]
                                     for k in all_kernels()}
        print(f"[dp] 9b rank {r}: micro-steps {res['steps']} ms "
              + ", ".join(f"{x:.1f}" for x in res["ms"])
              + f" (phase 4 at micro-batch 2: "
              + ", ".join(f"{x:.2f}" for x in phase4_ms)
              + f"); peak {res['peak_gib']:.2f} GiB; all-reduced "
              f"{res['reduced_bytes'] / len(res['steps']):.0f} and gathered "
              f"{res['gathered_bytes']} bytes; staged through the host "
              f"{res['staged_bytes']}; saves {res['saves']}; digest "
              f"{res['digest']}; launches " + " ".join(
                  f"{k}={n}" for k, n in counts.items()), flush=True)
        if res["steps"] != [1, 2]:
            fail(f"9b rank {r} ran micro-steps {res['steps']}")
        for kernel in (fa.flash_fwd_resident_lse, fa.flash_bwd_dq,
                       fa.flash_bwd_dkv):
            if counts[kernel.__name__] == 0:
                fail(f"9b rank {r}: {kernel.__name__} launched 0 times")
    if ranks[0]["digest"] != ranks[1]["digest"] or \
            ranks[0]["losses"] != ranks[1]["losses"]:
        fail("the ranks ended on different parameters or losses")
    check_losses("2 ranks", {int(s): x for s, x in ranks[0]["losses"]})
    files = sorted(os.listdir(run))
    ckpts = sorted(os.listdir(os.path.join(run, "checkpoint")))
    print(f"[dp] 9b run files {files}; checkpoint {ckpts}", flush=True)
    if not {"config_resolved.json", "code_snapshot.tar.gz", "tensorboard",
            "logging.log.rank1"} <= set(files) or \
            ckpts != ["latest", "latest.meta.json"]:
        fail(f"9b wrote {files}, checkpoint {ckpts}")
    if any([s for s, *_ in res["saves"]] != ["latest"] for res in ranks):
        fail(f"9b saved {ranks[0]['saves']} / {ranks[1]['saves']}")

    # one process resumes the 2-rank checkpoint: the same global
    # micro-batch; it saves nothing
    cfg1 = os.path.join(tmp, "dp1.yaml")
    with open(cfg1, "w") as f:
        json.dump({"base_config": [base], "trainer": {"save_period": 1000}},
                  f)
    reset_counts()
    t0 = time.perf_counter()
    with no_final_save():
        trainer = train_cli.main(["--config", cfg1, "--max_iter", "2"]
                                 + common)
    torch.cuda.synchronize()
    paths["dp cli resumed 1-rank"] = read_counts()
    steps = [s for s, *_ in trainer.step_times]
    print(f"[dp] 9b resumed on 1 process: micro-steps {steps} in "
          f"{time.perf_counter() - t0:.1f} s; restores "
          f"{trainer.ckpt.restores}; saves {trainer.ckpt.saves}", flush=True)
    if steps != [3, 4] or trainer.state.opt.count != 2:
        fail(f"the 1-process resume ran {steps}, "
             f"{trainer.state.opt.count} updates")
    if len(trainer.ckpt.restores) != 1 or trainer.ckpt.saves:
        fail(f"the 1-process resume restored {trainer.ckpt.restores}, "
             f"saved {trainer.ckpt.saves}")
    check_losses("resumed", {s: x for s, _, x in trainer.losses})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def dp_cli_rank(out: str, *argv):
    """A 9b rank: cli.train with its counters at 0; writes its launches,
    peak memory, micro-steps, losses, collective bytes, saves and a digest
    of its final parameters to `out`."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stablemtl_tpu_torch.cli import train as train_cli

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer = train_cli.main(list(argv))
    torch.cuda.synchronize()
    mesh = trainer.mesh
    with open(out, "w") as f:
        json.dump(dict(
            launches={k.__name__: n for k, n in read_counts().items()},
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            steps=[s for s, *_ in trainer.step_times],
            ms=[secs * 1e3 for *_, secs in trainer.step_times],
            reduced_bytes=mesh.reduced_bytes,
            gathered_bytes=mesh.gathered_bytes,
            model_bytes=mesh.model_bytes,
            staged_bytes=mesh.staged_bytes, saves=trainer.ckpt.saves,
            losses=[(s, loss) for s, _, loss in trainer.losses],
            digest=_digest(trainer.state.params.values())), f)


def dp_check_f32_and_memory(tmp: str):
    """9c: 2 ranks sharing the card over gloo. In f32 with deterministic
    cuDNN, batch 1 a rank, `highest` masking at ratio 1 and unequal valid
    masks: the loss and the all-reduced main-UNet gradients against one
    process on the global batch of 2. Then phase 4's bf16 recipe at 1 row
    a rank: peak memory with ZeRO-1 off and on."""
    ranks = _dp_ranks("dp_check_rank", [], tmp, "check")
    r0 = ranks[0]
    print(f"[dp] 9c f32, 2 ranks of batch 1 vs 1 process of batch 2: loss "
          f"{r0['loss']:.9g} vs {r0['loss_1rank']:.9g} (rel "
          f"{r0['loss_rel']:.3e}, tol {P9_LOSS_REL:g}); grads rel_l2 "
          f"{r0['grad_rel_l2']:.4e} (tol {P9_GRAD_REL_L2:g}), max|diff| "
          f"{r0['grad_max_abs']:.4e}; valid latent cells per rank "
          f"{r0['counts']}; masks picked by the global statistic differ "
          f"from a local one in {r0['local_pick_diff']} layers", flush=True)
    for r, res in enumerate(ranks):
        mem = res["memory"]
        print(f"[dp] 9c rank {r} bf16, 1 row a rank: peak memory ZeRO-1 off "
              f"{mem['off']['peak_gib']:.2f} GiB, on "
              f"{mem['on']['peak_gib']:.2f} GiB (difference "
              f"{mem['off']['peak_gib'] - mem['on']['peak_gib']:.2f}); "
              f"ms per micro-step off {mem['off']['ms']}, on "
              f"{mem['on']['ms']}; all-reduced per micro-step "
              f"{mem['on']['reduced_per_step']:.0f} bytes, gathered per "
              f"update {mem['on']['gathered_per_update']:.0f}, staged "
              f"through the host per micro-step "
              f"{mem['on']['staged_per_step']:.0f}; launches "
              f"{mem['on']['launches']}", flush=True)
    if ranks[0]["grads_digest"] != ranks[1]["grads_digest"]:
        fail("9c: the ranks hold different all-reduced gradients")
    if not (r0["loss_rel"] <= P9_LOSS_REL
            and r0["grad_rel_l2"] <= P9_GRAD_REL_L2):
        fail("9c: 2 ranks disagree with one process on the global batch")


def dp_check_rank(out: str):
    """A 9c rank (see dp_check_f32_and_memory); rank 0 also runs the
    one-process reference and compares."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.parallel import make_mesh, shard_batch
    from stablemtl_tpu_torch.parallel.distributed import (maybe_initialize,
                                                          shutdown)
    from stablemtl_tpu_torch.parallel.sharded_train import (
        create_sharded_train_state, make_sharded_train_step)
    from stablemtl_tpu_torch.train_state import (OptimizerConfig,
                                                 downsample_valid_mask,
                                                 eval_state, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize(device="cuda")
    mesh = make_mesh()
    res = {}
    torch.backends.cudnn.deterministic = True
    pipe = build_pipeline(full_config("float32", trainer=P9_TRAINER_F32),
                          seed=0, image_hw=TRAIN_HW, trainable=True)
    batch = train_batches(1, P9_WORLD, seed=9, device=pipe.device)[0]
    batch["valid_mask"][0, :, TRAIN_HW[1] // 2:] = False  # rank 0: half
    batch["task_idx"] = 3  # a two-frame task
    res["counts"] = [int(downsample_valid_mask(batch["valid_mask"][r:r + 1])
                         .sum()) for r in range(P9_WORLD)]
    state = eval_state(pipe.unet)
    step = make_sharded_train_step(pipe, mesh, base_seed=2024)
    with _mask_picks(pipe) as picks:
        loss, _, grads = step.loss_and_grads(state, shard_batch(batch, mesh))
    res["loss"] = float(loss)
    res["grads_digest"] = _digest(grads)
    if mesh.rank == 0:
        grads = [g.cpu() for g in grads]
        torch.cuda.empty_cache()
        plain = make_train_step(pipe, base_seed=2024)
        loss1, _, grads1 = plain.loss_and_grads(state, batch)
        with _mask_picks(pipe) as local:
            plain.loss_and_grads(state, {k: v[:1] if hasattr(v, "shape")
                                         else v for k, v in batch.items()})
        res["local_pick_diff"] = sum(a != b for a, b in zip(picks, local))
        res["loss_1rank"] = float(loss1)
        res["loss_rel"] = abs(res["loss"] - res["loss_1rank"]) / abs(
            res["loss_1rank"])
        diff = sum(float((g.to(g1.device) - g1).double().square().sum())
                   for g, g1 in zip(grads, grads1))
        norm = sum(float(g1.double().square().sum()) for g1 in grads1)
        res["grad_rel_l2"] = (diff / norm) ** 0.5
        res["grad_max_abs"] = max(float((g.to(g1.device) - g1).abs().max())
                                  for g, g1 in zip(grads, grads1))
        del grads1, plain
    del state, step, grads, pipe
    torch.cuda.empty_cache()
    mesh.barrier()

    torch.backends.cudnn.deterministic = False
    pipe = build_pipeline(full_config("bfloat16", trainer=TRAINER), seed=0,
                          image_hw=TRAIN_HW, trainable=True)
    cfg = OptimizerConfig(lr=1e-4, max_grad_norm=5.0, total_iters=25_000,
                          final_ratio=0.01, warmup_steps=100,
                          accumulation_steps=2)
    batches = train_batches(2, P9_WORLD, seed=4, device=pipe.device)
    res["memory"] = {}
    for zero1 in (False, True):
        state = create_sharded_train_state(pipe.unet, cfg, mesh, zero1=zero1)
        step = make_sharded_train_step(pipe, mesh, base_seed=2024,
                                       zero1=zero1)
        mesh.reduced_bytes = mesh.gathered_bytes = mesh.staged_bytes = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ms = []
        for b in batches:
            t0 = time.perf_counter()
            state, _ = step(state, shard_batch(b, mesh))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        res["memory"]["on" if zero1 else "off"] = dict(
            peak_gib=torch.cuda.max_memory_allocated() / 2**30, ms=ms,
            reduced_per_step=mesh.reduced_bytes / len(batches),
            gathered_per_update=mesh.gathered_bytes,
            staged_per_step=mesh.staged_bytes / len(batches),
            launches={k.__name__: n for k, n in read_counts().items()})
        del state, step
        torch.cuda.empty_cache()
    shutdown()
    with open(out, "w") as f:
        json.dump(res, f)


# Phase 10: serving over replicas, preprocessing without JAX, the profiler.
# Two replicas share the one card: the check's numbers and launches, not
# several cards' pace.
P10_DEVICES = ("cuda:0", "cuda:0")
P10_REQUESTS = 4
# each replica runs one row: a step at batch 1 (phase 3's counts K1 20, K2
# 2; K6 32 under STABLEMTL_FUSED_GEGLU), twice over per session step
P10_REPLICA_LAUNCHES = {"flash_fwd_resident": 20, "flash_fwd_stream": 2,
                        "geglu_fused": GEGLU_LAUNCHES_PER_STEP}
# each served result against infer_all_tasks of its own image at batch 1
# on the main thread, and the mesh artifact's rows against the served
# results: max |diff|, bit-equal expected (the same kernels on the same
# shapes; phase 5 found a bf16 result depends on its row, never its mate,
# and every replica runs row 0)
P10_MAX_ABS = 0.0
P10_TIMED_STEPS = 3
# FlyingThings3D's frames (the dataset's 536x960 center crop needs them)
FT3D_HW = (540, 960)
FT3D_FRAMES = (6, 7)
# the preprocessing jobs must not import these
JAX_MODULES = ("jax", "jaxlib", "flax", "stablemtl_tpu")


def _write_pfm(path: str, arr):
    import numpy as np

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"Pf\n" + f"{arr.shape[1]} {arr.shape[0]}\n".encode()
                + b"-1.0\n" + np.flipud(arr).astype("<f4").tobytes())


def _write_flo(path: str, flow):
    import struct

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("f", 202021.25)
                + struct.pack("ii", flow.shape[1], flow.shape[0])
                + flow.astype("<f4").tobytes())


def write_ft3d_raw(root: str, hw, seed: int, frames=FT3D_FRAMES):
    """A raw FlyingThings3D split under root/train, from numpy, as
    tests/test_preprocess_drivers.py builds one: per frame the left
    disparity and its change into the future as PFM (stored negated: the
    job negates them back), the forward flow as .flo (multiples of
    1/64, which the 16-bit flow PNG holds exactly; a few above the 500 px
    clamp), and the left frames as image_clean PNGs (the frame after the
    last too: the dataset reads each frame's successor)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = hw
    split = os.path.join(root, "train")
    for idx in frames:
        _write_pfm(os.path.join(split, "disparity/left", f"{idx:07d}.pfm"),
                   -rng.uniform(40, 80, hw).astype(np.float32))
        _write_pfm(os.path.join(split, "disparity_change/left/into_future",
                                f"{idx:07d}.pfm"),
                   -rng.uniform(-2, 2, hw).astype(np.float32))
        flow = np.round(rng.uniform(-5, 5, (h, w, 2)) * 64) / 64
        flow[0, 0] = (600.0, 0.0)
        _write_flo(os.path.join(split, "flow/left/into_future",
                                f"{idx:07d}.flo"), flow.astype(np.float32))
    for idx in tuple(frames) + (frames[-1] + 1,):
        path = os.path.join(split, "image_clean", f"{idx:07d}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(path, rng.integers(0, 256, (h, w, 3), np.uint8))


def write_vkitti_split(root: str):
    """A vKITTI split file of 2 rows and a dataset tree holding the rgb of
    both, the depth and semantic maps of row 0 and the flow of row 1.
    Returns (split file, dataset dir, {task: rows the lists must hold})."""
    from stablemtl_tpu_torch.preprocess.vkitti import derive_task_paths

    rows = [(f"Scene01/clone/frames/rgb/Camera_0/rgb_{i:05d}.jpg",
             f"Scene01/clone/frames/depth/Camera_0/depth_{i:05d}.png")
            for i in (1, 2)]
    os.makedirs(root, exist_ok=True)
    split = os.path.join(root, "vkitti_val.txt")
    with open(split, "w") as f:
        f.write("".join(f"{a} {b}\n" for a, b in rows))
    paths = [derive_task_paths(*row) for row in rows]
    present = [p["rgb"] for p in paths] + [paths[0]["depth"],
                                           paths[0]["semantic"],
                                           paths[1]["optical_flow"]]
    ds = os.path.join(root, "vkitti")
    for rel in present:
        os.makedirs(os.path.dirname(os.path.join(ds, rel)), exist_ok=True)
        with open(os.path.join(ds, rel), "wb") as f:
            f.write(b"x")
    want = {t: [p[t] for p in paths if p[t] in present]
            for t in ("semantic", "normal", "depth", "optical_flow")}
    return split, ds, want


def _preprocess_job(module: str, *argv):
    """`python -X importtime -m stablemtl_tpu_torch.preprocess.<module>` in
    a process of its own, started (not waited for): its stderr lists every
    module it imported."""
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m",
         f"stablemtl_tpu_torch.preprocess.{module}", *argv], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _imported(stderr: str) -> set:
    """The modules an `-X importtime` run imported."""
    return {line.rsplit("|", 1)[1].strip() for line in stderr.splitlines()
            if line.startswith("import time:") and line.count("|") == 2}


def p10_preprocess_start(tmp: str) -> dict:
    """10d's jobs, started: the FlyingThings3D job on a raw split at
    FT3D_HW (writing beside it, where the dataset finds the frames), the
    vKITTI lists, and the Hypersim job where h5py imports here.
    Returns {job: (process, what to check)}."""
    ft3d = os.path.join(tmp, "ft3d")
    write_ft3d_raw(ft3d, FT3D_HW, seed=10)
    split, ds, want = write_vkitti_split(os.path.join(tmp, "vk"))
    jobs = {
        "flyingthings3d": (_preprocess_job(
            "flyingthings3d", "--input_dir", ft3d, "--output_dir", ft3d,
            "--split", "train"), ft3d),
        "vkitti": (_preprocess_job(
            "vkitti", "--split", "val", "--split_file", split,
            "--dataset_dir", ds, "--out_dir", os.path.join(tmp, "lists")),
            (os.path.join(tmp, "lists"), want)),
    }
    try:
        import h5py  # noqa: F401
    except ImportError:
        return jobs
    raw = os.path.join(tmp, "hypersim_raw")
    write_hypersim_raw(raw, seed=0)
    jobs["hypersim"] = (_preprocess_job(
        "hypersim", "frames", "--dataset_dir", raw, "--output_dir",
        os.path.join(tmp, "hypersim")), os.path.join(tmp, "hypersim"))
    return jobs


def write_hypersim_raw(root: str, seed: int, hw=(12, 16)):
    """One raw Hypersim scene of 2 frames (HDF5, h5py), as
    tests/test_preprocess_drivers.py builds it."""
    import h5py
    import numpy as np

    def h5(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with h5py.File(path, "w") as f:
            f.create_dataset("dataset", data=arr)

    rng = np.random.default_rng(seed)
    scene = os.path.join(root, "ai_001_001")
    geo = os.path.join(scene, "images/scene_cam_00_geometry_hdf5")
    fin = os.path.join(scene, "images/scene_cam_00_final_hdf5")
    for fid in (0, 1):
        frame = f"frame.{fid:04d}"
        h5(os.path.join(fin, f"{frame}.color.hdf5"),
           rng.uniform(0, 2, hw + (3,)))
        h5(os.path.join(fin, f"{frame}.diffuse_reflectance.hdf5"),
           rng.uniform(0.1, 1, hw + (3,)))
        h5(os.path.join(geo, f"{frame}.depth_meters.hdf5"),
           rng.uniform(1, 10, hw))
        h5(os.path.join(geo, f"{frame}.render_entity_id.hdf5"),
           np.where(rng.random(hw) > 0.1, 5, -1))
        n = rng.standard_normal(hw + (3,))
        h5(os.path.join(geo, f"{frame}.normal_cam.hdf5"), n)
        h5(os.path.join(geo, f"{frame}.normal_world.hdf5"), n)
        h5(os.path.join(geo, f"{frame}.position.hdf5"),
           rng.uniform(-5, 5, hw + (3,)))
    h5(os.path.join(scene, "_detail/cam_00/camera_keyframe_positions.hdf5"),
       np.asarray([[0.0, 0.0, 20.0], [1.0, 0.0, 20.0]]))


def p10_preprocess_check(jobs: dict):
    """10d: each job exited 0 and imported nothing of JAX; every written
    FlyingThings3D sample read back through the port's datasets equals
    the port's `preprocess_ft3d_sample` of the raw files; the vKITTI lists
    hold the rows whose files exist; `depth_to_normal` on a plane at the
    vKITTI geometry gives unit normals."""
    import numpy as np

    from stablemtl_tpu_torch.data.base import DatasetMode
    from stablemtl_tpu_torch.data.datasets import (
        FlyingThings3DOpticalFlowDataset, FlyingThings3DSceneFlowDataset)
    from stablemtl_tpu_torch.data.io import read_pfm
    from stablemtl_tpu_torch.preprocess import (depth_to_normal,
                                                preprocess_ft3d_sample)
    from stablemtl_tpu_torch.preprocess.flyingthings3d import load_flo

    for name, (proc, _) in jobs.items():
        out, err = proc.communicate(timeout=600)
        imported = _imported(err)
        foreign = sorted(m for m in imported
                         if m.split(".")[0] in JAX_MODULES)
        print(f"[p10] python -m stablemtl_tpu_torch.preprocess.{name}: exit "
              f"{proc.returncode}, {len(imported)} modules imported, of JAX "
              f"{foreign}", flush=True)
        if proc.returncode != 0:
            print(out[-2000:], err[-4000:], flush=True)
            fail(f"preprocess.{name} exited {proc.returncode}")
        if foreign or "numpy" not in imported:
            fail(f"preprocess.{name} imported {foreign} (numpy "
                 f"{'in' if 'numpy' in imported else 'missing'})")
    print(f"[p10] hypersim job: "
          f"{'ran' if 'hypersim' in jobs else 'not run, h5py not importable'}",
          flush=True)
    if "hypersim" in jobs:
        with open(os.path.join(jobs["hypersim"][1],
                               "filename_list_train.txt")) as f:
            rows = f.read().splitlines()
        if len(rows) != 2:  # the raw scene's two frames
            fail(f"the Hypersim list holds {rows}")

    root = jobs["flyingthings3d"][1]
    flows = FlyingThings3DOpticalFlowDataset(
        DatasetMode.EVAL, os.path.join(root, "train.txt"), root)
    scenes = FlyingThings3DSceneFlowDataset(
        DatasetMode.EVAL, os.path.join(root, "train.txt"), root)
    if len(flows.filenames) != len(FT3D_FRAMES):
        fail(f"the FT3D list holds {flows.filenames}")
    for i, idx in enumerate(FT3D_FRAMES):
        def raw(sub):
            with open(os.path.join(root, "train", sub), "rb") as f:
                return f.read()
        pc1, flow_3d, flow_2d, mask = preprocess_ft3d_sample(
            -read_pfm(raw(f"disparity/left/{idx:07d}.pfm")),
            -read_pfm(raw(f"disparity_change/left/into_future/"
                          f"{idx:07d}.pfm")),
            load_flo(raw(f"flow/left/into_future/{idx:07d}.flo")))
        flow, scene = flows[i], scenes[i]
        h, w = scene["scene_flow"].shape[:2]
        want_sf, want_sf_mask = scenes.project_flow_3d_to_2d(flow_3d, pc1,
                                                             h, w)
        same = {
            "flow": np.array_equal(flow["optical_flow_raw"],
                                   flows._center_crop(flow_2d)),
            "flow mask": np.array_equal(flow["valid_mask"][..., 0],
                                        flows._center_crop(mask)),
            "scene flow": np.array_equal(scene["scene_flow"], want_sf),
            "scene flow mask": np.array_equal(scene["valid_mask"],
                                              want_sf_mask)}
        print(f"[p10] FT3D sample {idx:07d} through the datasets vs "
              f"preprocess_ft3d_sample: {same}; {len(pc1)} points, "
              f"{int(mask.sum())} valid flow pixels of {mask.size}",
              flush=True)
        if not all(same.values()):
            fail(f"FT3D sample {idx} read back differs: {same}")

    lists, want = jobs["vkitti"][1]
    for task, rows in want.items():
        with open(os.path.join(lists, f"vkitti_val_{task}.txt")) as f:
            got = f.read().split()
        if got != rows:
            fail(f"vkitti_val_{task}.txt holds {got}, want {rows}")
    print(f"[p10] vkitti lists: " + ", ".join(
        f"{t} {len(r)}" for t, r in want.items()), flush=True)

    yy, xx = np.mgrid[:P6_VKITTI_RAW[0], :P6_VKITTI_RAW[1]]
    t0 = time.perf_counter()
    normal = depth_to_normal(5.0 + 0.01 * xx + 0.02 * yy)
    err = float(np.abs(np.linalg.norm(normal[4:-4, 4:-4], axis=-1)
                       - 1).max())
    print(f"[p10] depth_to_normal d2nt_v3 on a {P6_VKITTI_RAW} plane: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, max ||n| - 1| "
          f"{err:.3e}", flush=True)
    if normal.shape != P6_VKITTI_RAW + (3,) or not err < 1e-5:
        fail("depth_to_normal gave no unit normals on a plane")


def phase_replicas() -> dict:
    """Phase 10. Returns {path: {kernel: launches}} of the 2-replica
    session's burst and of the mesh artifact's call, each counted from
    0."""
    os.environ["STABLEMTL_FAST_MATH"] = "1"
    os.environ["STABLEMTL_FUSED_GEGLU"] = "1"
    try:
        return _replicas()
    finally:
        del os.environ["STABLEMTL_FAST_MATH"]
        del os.environ["STABLEMTL_FUSED_GEGLU"]


def _replicas():
    import tempfile

    import torch

    from stablemtl_tpu_torch.factory import build_pipeline
    from stablemtl_tpu_torch.parallel import host_local_mesh

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = p10_preprocess_start(tmp)  # host work, meanwhile
        pipe = build_pipeline(full_config("bfloat16", fast_math=True),
                              seed=0, image_hw=(SERVE_RES, SERVE_RES))
        mesh = host_local_mesh(devices=P10_DEVICES)
        try:
            host_local_mesh(2)
        except RuntimeError as e:
            print(f"[p10] host_local_mesh(2) raises: {e}", flush=True)
        else:
            fail("host_local_mesh(2) did not raise on a one-card machine")
        paths, results, reqs = p10_session(pipe, mesh)
        paths.update(p10_artifact(pipe, mesh, reqs, results))
        p10_times(pipe, mesh, reqs)
        p10_trace(pipe, mesh, reqs, os.path.join(tmp, "trace"))
        del pipe
        torch.cuda.empty_cache()
        p10_preprocess_check(jobs)
    print(f"[p10] phase 10 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def p10_session(pipe, mesh):
    """10a: a warmed ServingSession(batch=2) over the two replicas, then
    P10_REQUESTS requests with every counter at 0. Returns ({path:
    launches}, results, requests)."""
    import numpy as np
    import torch

    from stablemtl_tpu_torch.predict import _to_norm
    from stablemtl_tpu_torch.serving import ServingSession, _infer_on_host

    reqs = [_to_norm(img) for img in serving_requests(P10_REQUESTS, 14)]
    try:
        ServingSession(pipe, batch=3, mesh=mesh)
    except ValueError as e:
        print(f"[p10] batch 3 over 2 replicas raises: {e}", flush=True)
    else:
        fail("ServingSession(batch=3) over 2 replicas did not raise")
    steps = []
    with ServingSession(pipe, batch=SERVE_BATCH, max_delay_s=0.05,
                        mesh=mesh) as sess:
        sess.warmup((SERVE_RES, SERVE_RES))
        step = sess._step

        def counted(group):
            steps.append(len(group))
            return step(group)

        sess._step = counted
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results = [f.result(timeout=600)
                   for f in [sess.submit(r) for r in reqs]]
        torch.cuda.synchronize()
        burst_s = time.perf_counter() - t0
        counts = read_counts()
    print(f"[p10] 2 replicas on {[str(d) for d in mesh.devices]}: "
          f"{len(reqs)} requests in {len(steps)} session steps of {steps}, "
          f"{burst_s * 1e3:.2f} ms; launches: " + " ".join(
              f"{k.__name__}={n}" for k, n in counts.items()), flush=True)
    for kernel, n in counts.items():
        want = P10_REPLICA_LAUNCHES.get(kernel.__name__, 0) * mesh.data \
            * len(steps)
        if n != want:
            fail(f"{kernel.__name__} launched {n} times in {len(steps)} "
                 f"session steps of {mesh.data} replicas (want {want})")
    diffs = [compare_np(out, _infer_on_host(pipe, [np.stack([r])])[:, 0])
             for r, out in zip(reqs, results)]
    print(f"[p10] each result vs infer_all_tasks of its image at batch 1: "
          f"max|diff| {max(d[0] for d in diffs):.4e}, rel_l2 "
          f"{max(d[1] for d in diffs):.4e} (tol max|diff| "
          f"{P10_MAX_ABS:g})", flush=True)
    if not all(np.isfinite(out).all() for out in results):
        fail("a replica's result is not finite")
    if not max(d[0] for d in diffs) <= P10_MAX_ABS:
        fail("a served result differs from the one-device step at batch 1")
    return {"ServingSession 2 replicas": counts}, results, reqs


def p10_artifact(pipe, mesh, reqs, results) -> dict:
    """10b: export_pipeline(mesh=) at batch 2, loaded from its bytes,
    called on the first two requests with one bundle per replica, every
    counter at 0: nr_devices 2, each row bit-equal to 10a's result, each
    replica's program holding its tensors and naming only its device."""
    import numpy as np
    import torch

    from stablemtl_tpu_torch.serving import (export_pipeline, load_exported,
                                             program_tensors_and_devices,
                                             replicated_bundles)

    t0 = time.perf_counter()
    blob = export_pipeline(pipe, batch=SERVE_BATCH,
                           res_hw=(SERVE_RES, SERVE_RES), mesh=mesh)
    t1 = time.perf_counter()
    exported = load_exported(blob)
    t2 = time.perf_counter()
    bundles = replicated_bundles(pipe, mesh)
    x = torch.from_numpy(np.stack(reqs[:SERVE_BATCH]))
    exported.call(bundles, x)
    torch.cuda.synchronize()
    reset_counts()
    out = exported.call(bundles, x).float().cpu().numpy()
    counts = read_counts()
    diffs = [compare_np(out[:, i], results[i]) for i in range(SERVE_BATCH)]
    placed = {}
    for device in set(mesh.devices):
        tensors, devices = program_tensors_and_devices(
            exported.module_on(device))
        placed[str(device)] = (
            len(tensors), sorted({str(t.device) for t in tensors}),
            sorted({str(d) for d in devices}))
    exported.close()
    print(f"[p10] mesh artifact: export {t1 - t0:.2f} s, {len(blob)} bytes, "
          f"load {t2 - t1:.2f} s, nr_devices {exported.nr_devices}, bundles "
          f"shared {bundles[0] is bundles[1]}; rows vs 10a max|diff| "
          f"{max(d[0] for d in diffs):.4e}; (tensors, their devices, "
          f"devices named) per replica device {placed}; launches: "
          + " ".join(f"{k.__name__}={n}" for k, n in counts.items()),
          flush=True)
    if exported.nr_devices != mesh.data:
        fail(f"the mesh artifact says nr_devices {exported.nr_devices}")
    if not max(d[0] for d in diffs) <= P10_MAX_ABS:
        fail("the mesh artifact's rows differ from the session's results")
    for device, (_, held, named) in placed.items():
        if any(d != device for d in held + named):
            fail(f"the program placed on {device} holds tensors on {held} "
                 f"and names {named}")
    for kernel, n in counts.items():
        want = P10_REPLICA_LAUNCHES.get(kernel.__name__, 0) * mesh.data
        if n != want:
            fail(f"the mesh artifact launched {kernel.__name__} {n} times "
                 f"(want {want})")
    return {"artifact 2 replicas": counts}


def _session_step_ms(pipe, reqs, mesh) -> float:
    """ms per session step of 2 requests (host clock, submit to the last
    result), over P10_TIMED_STEPS steps after a warm-up step."""
    from stablemtl_tpu_torch.serving import ServingSession

    with ServingSession(pipe, batch=SERVE_BATCH, max_delay_s=0.05,
                        mesh=mesh) as sess:
        for i in range(P10_TIMED_STEPS + 1):
            if i == 1:
                t0 = time.perf_counter()
            [f.result(timeout=600)
             for f in [sess.submit(r) for r in reqs[:SERVE_BATCH]]]
    return (time.perf_counter() - t0) / P10_TIMED_STEPS * 1e3


def p10_times(pipe, mesh, reqs):
    """10c: ms per session step, 2 replicas sharing the card against one
    replica at batch 2, in turns (one, two, two, one)."""
    ms = {"1 replica, batch 2": [], "2 replicas, 1 row each": []}
    for m in (None, mesh, mesh, None):
        key = "1 replica, batch 2" if m is None else "2 replicas, 1 row each"
        ms[key].append(_session_step_ms(pipe, reqs, m))
    print("[p10] ms per session step (2 requests; 2 replicas sharing one "
          "card, the check's pace, not several cards'): " + "; ".join(
              f"{k} {', '.join(f'{v:.2f}' for v in vals)}"
              for k, vals in ms.items()), flush=True)


def p10_trace(pipe, mesh, reqs, log_dir: str):
    """10e: `utils.profiling.trace` around one 2-replica session step: the
    trace file written, the top kernels by device time, and K1's and K2's
    launches (kernels flash_fwd_a_sm90 and flash_fwd_b_sm90) in it."""
    import glob

    import torch

    from stablemtl_tpu_torch.serving import ServingSession
    from stablemtl_tpu_torch.utils.profiling import trace

    with ServingSession(pipe, batch=SERVE_BATCH, max_delay_s=0.05,
                        mesh=mesh) as sess:
        sess.infer(reqs[0])
        with trace(log_dir) as prof:
            [f.result(timeout=600)
             for f in [sess.submit(r) for r in reqs[:SERVE_BATCH]]]
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"[p10] trace: {[os.path.getsize(f) for f in files]} bytes, "
          f"{sum(e.count for e in events)} device kernels, busy "
          f"{sum(e.self_device_time_total for e in events) / 1e3:.2f} ms",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[p10] trace {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:100]}", flush=True)
    seen = {name: sum(e.count for e in events if name in e.key)
            for name in ("flash_fwd_a_sm90", "flash_fwd_b_sm90")}
    want = {"flash_fwd_a_sm90": P10_REPLICA_LAUNCHES["flash_fwd_resident"]
            * mesh.data, "flash_fwd_b_sm90":
            P10_REPLICA_LAUNCHES["flash_fwd_stream"] * mesh.data}
    print(f"[p10] trace launches {seen} (want {want})", flush=True)
    if len(files) != 1 or seen != want:
        fail(f"the trace holds {files} and launches {seen}")


@contextlib.contextmanager
def _mask_picks(pipe):
    """Within it, the key each task bank masks is appended, layer by layer,
    to the list it yields."""
    from stablemtl_tpu_torch.models.transformer import TaskAttentionBank

    picks = []
    banks = [m for m in pipe.unet.modules()
             if isinstance(m, TaskAttentionBank)]
    for bank in banks:
        def wrapped(*a, _orig=bank._mask_bias, **k):
            m = _orig(*a, **k)
            if m is not None:
                picks.append(m.argmin(-1).tolist())
            return m

        bank._mask_bias = wrapped
    try:
        yield picks
    finally:
        for bank in banks:
            del bank._mask_bias


# Phase 11: tensor parallelism. Two gloo ranks share cuda:0 as the model
# axis of a 1 x 2 mesh (one H100, and NCCL refuses two ranks on one card).
# The flagship training recipe at 512x512, micro-batch 1, accumulation 2:
# stage 0 (4096 tokens, 5 heads: gathered, all heads on each rank) and
# stage 1 (1024 tokens, 10 heads: 5 local heads a rank) both reach K3-K5.
P11_HW = (512, 512)
P11_STEPS = 4
# 11b, f32 at TRAIN_HW, micro-batch 1, deterministic cuDNN: the TP loss and
# the gradients gathered whole against one process on the same weights,
# batch and generator. Set before the first run: the ranks' partial sums
# round in another order than the one process's whole products.
P11_F32_LOSS_REL = 1e-5
P11_F32_GRAD_REL_L2 = 1e-4
# 11c: the no-grad TP forward with K6 held to the one-process bf16 forward
# as phase 3 holds its bf16 path: no further from the f32 one-process
# forward than the bf16 one-process forward is, with 25 % of room
P11_FWD_RATIO = PATH_BF16_RATIO
P11_TASK = 3  # optical flow: a two-frame task
# the full preset's main UNet under the policy at model 2 (the CPU test
# test_tp_policy_matches_jax[full] holds the same counts against JAX)
P11_SPLIT = (416, 650_746_880)


def phase_tensor_parallel(p6_losses) -> dict:
    """Phase 11. Returns {path: {kernel: launches}} of the counted runs.
    p6_losses: phase 6's {micro-step: loss}, 11d's reference."""
    import tempfile

    t_phase = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref = tp_one_process(tmp)
        print(f"[tp] one process (11a, 11c references) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        ranks = _dp_ranks("tp_check_rank", [tmp], tmp, "tp")
        print(f"[tp] 2 ranks (11a-11c) in {time.perf_counter() - t0:.1f} s "
              f"(process start and pipeline builds included)", flush=True)
        paths.update(tp_report(ref, ranks))
        t0 = time.perf_counter()
        paths.update(tp_cli_two_ranks(tmp, p6_losses))
        print(f"[tp] 11d in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[tp] phase 11 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def _p11_pipeline(dtype: str, trainer=None, hw=P11_HW):
    from stablemtl_tpu_torch.factory import build_pipeline

    return build_pipeline(full_config(dtype, trainer=trainer or TRAINER),
                          seed=0, image_hw=hw, trainable=True)


def _p11_optimizer():
    from stablemtl_tpu_torch.train_state import OptimizerConfig

    return OptimizerConfig(lr=1e-4, max_grad_norm=5.0, total_iters=25_000,
                           final_ratio=0.01, warmup_steps=100,
                           accumulation_steps=2)


def _p11_forward(pipe):
    """The no-grad main-UNet forward of 11c on a seeded 512x512 frame pair
    (the VAE encode included), on the host as f32."""
    import torch

    gen = torch.Generator(device=pipe.device).manual_seed(11)
    rgb = torch.rand((2, *P11_HW, 3), generator=gen,
                     device=pipe.device) * 2 - 1
    with torch.no_grad():
        lat = pipe.encode_rgb(rgb)
        out = pipe.unet_forward(lat[:1], lat[1:], P11_TASK,
                                generator=torch.Generator(
                                    device=pipe.device).manual_seed(12))
    return out.float().cpu()


@contextlib.contextmanager
def _fused_geglu(on: bool = True):
    old = os.environ.get("STABLEMTL_FUSED_GEGLU")
    os.environ["STABLEMTL_FUSED_GEGLU"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["STABLEMTL_FUSED_GEGLU"]
        else:
            os.environ["STABLEMTL_FUSED_GEGLU"] = old


@contextlib.contextmanager
def _launch_shapes():
    """Records (kernel, shape) of every kernel launch on the card inside:
    q's [BH, S, d] for K1-K5, (rows, C, F) for K6."""
    from collections import Counter

    from stablemtl_tpu_torch.ops import flash_attention as fa
    from stablemtl_tpu_torch.ops import geglu

    seen = Counter()
    names = {"flash_fwd_a": "flash_fwd_resident",
             "flash_fwd_lse": "flash_fwd_resident_lse",
             "flash_fwd_b": "flash_fwd_stream",
             "flash_bwd_dq": "flash_bwd_dq", "flash_bwd_dkv": "flash_bwd_dkv"}
    ops, op = dict(fa.OPS), geglu.OP

    def flash(name, fn):
        def call(*args):
            if args[0].is_cuda:
                seen[(names[name], tuple(args[0].shape))] += 1
            return fn(*args)
        return call

    def geglu_call(x, w, b, fast):
        if x.is_cuda:
            seen[("geglu_fused", (x.numel() // x.shape[-1], x.shape[-1],
                                  w.shape[0] // 2))] += 1
        return op(x, w, b, fast)

    fa.OPS.update({k: flash(k, v) for k, v in ops.items()})
    geglu.OP = geglu_call
    try:
        yield seen
    finally:
        fa.OPS.update(ops)
        geglu.OP = op


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def tp_one_process(tmp: str) -> dict:
    """The one-process references, here: the no-grad forward of 11c in
    bf16 with K6 and in f32 (plain GEGLU) on the same seeded weights,
    written to `tmp`; then 11a's 4 micro-steps of `make_train_step` on the
    fresh bf16 weights: losses, ms, peak memory, launches. The card is
    emptied after."""
    import gc

    import torch

    from stablemtl_tpu_torch.train_state import (create_train_state,
                                                 make_train_step)

    res = {}
    pipe = _p11_pipeline("float32")
    with _fused_geglu(False):
        torch.save(_p11_forward(pipe), os.path.join(tmp, "fwd_f32.pt"))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    pipe = _p11_pipeline("bfloat16")
    with _fused_geglu():
        torch.save(_p11_forward(pipe), os.path.join(tmp, "fwd_bf16.pt"))
    state = create_train_state(pipe.unet, _p11_optimizer())
    step = make_train_step(pipe, base_seed=2024)
    batches = train_batches(P11_STEPS, 1, seed=11, device=pipe.device,
                            hw=P11_HW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res["losses"], res["ms"] = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        res["losses"].append(float(m["loss"]))
        torch.cuda.synchronize()
        res["ms"].append((time.perf_counter() - t0) * 1e3)
    res["counts"] = {k.__name__: n for k, n in read_counts().items()}
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["leaves"] = len(state.params)
    res["params"] = sum(p.numel() for p in state.params.values())
    del state, step, pipe, batches
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[tp] 11a one process: losses {res['losses']}; ms "
          + ", ".join(f"{x:.1f}" for x in res["ms"])
          + f"; peak {res['peak_gib']:.2f} GiB; launches per micro-step "
          + " ".join(f"{k}={n / P11_STEPS:g}"
                     for k, n in res["counts"].items()), flush=True)
    return res


def tp_check_rank(out: str, tmp: str):
    """A rank of 11a-11c on the 1 x 2 mesh (see phase_tensor_parallel);
    writes what it measured to `out`, rank 0 also the comparisons."""
    import gc

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stablemtl_tpu_torch.parallel import MeshConfig, make_mesh
    from stablemtl_tpu_torch.parallel.distributed import (maybe_initialize,
                                                          shutdown)
    from stablemtl_tpu_torch.parallel.sharded_train import (
        check_replicated, create_sharded_train_state,
        make_sharded_train_step)
    from stablemtl_tpu_torch.parallel.tensor_parallel import shard_unet
    from stablemtl_tpu_torch.train_state import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize(device="cuda")
    mesh = make_mesh(MeshConfig(model=2))
    res = {"process": mesh.process_rank}
    main = mesh.process_rank == 0

    def shapes_of(seen, *kernels):
        return sorted([k, list(s), n] for (k, s), n in seen.items()
                      if k in kernels)

    # -- 11c: the no-grad forward on the fresh sliced weights, K6 on --------
    pipe = _p11_pipeline("bfloat16")
    layout = shard_unet(pipe.unet, mesh)
    res["split"] = [len(layout.specs), sum(
        math.prod(layout.shapes[n]) for n in layout.specs)]
    res["leaves"] = len(layout.shapes)
    reset_counts()
    mesh.model_bytes = 0
    with _fused_geglu(), _launch_shapes() as seen:
        fwd = _p11_forward(pipe)
    torch.cuda.synchronize()
    res["fwd_counts"] = {k.__name__: n for k, n in read_counts().items()}
    res["fwd_shapes"] = shapes_of(seen, "flash_fwd_resident", "geglu_fused")
    res["fwd_model_bytes"] = mesh.model_bytes
    if main:
        one = torch.load(os.path.join(tmp, "fwd_bf16.pt"))
        f32 = torch.load(os.path.join(tmp, "fwd_f32.pt"))
        res["fwd_finite"] = bool(torch.isfinite(fwd).all())
        res["fwd_rel_l2_vs_one"] = _rel_l2(fwd, one)
        res["fwd_rel_l2_vs_f32"] = _rel_l2(fwd, f32)
        res["one_rel_l2_vs_f32"] = _rel_l2(one, f32)
    del fwd

    # -- 11a: 4 micro-steps of the TP step, ZeRO-1 on ----------------------
    state = create_sharded_train_state(pipe.unet, _p11_optimizer(), mesh,
                                       zero1=True)
    step = make_sharded_train_step(pipe, mesh, base_seed=2024, zero1=True)
    batches = train_batches(P11_STEPS, 1, seed=11, device=pipe.device,
                            hw=P11_HW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    mesh.model_bytes = mesh.staged_bytes = 0
    res["losses"], res["ms"], res["model_bytes"] = [], [], []
    with _launch_shapes() as seen:
        for batch in batches:
            before = mesh.model_bytes
            t0 = time.perf_counter()
            state, m = step(state, batch)
            res["losses"].append(float(m["loss"]))
            torch.cuda.synchronize()
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["model_bytes"].append(mesh.model_bytes - before)
    res["counts"] = {k.__name__: n for k, n in read_counts().items()}
    res["train_shapes"] = shapes_of(seen, "flash_fwd_resident_lse",
                                    "flash_bwd_dq", "flash_bwd_dkv")
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["staged_bytes"] = mesh.staged_bytes
    # model peers computed the whole parameters' updates each on their own:
    # they must hold them bit-equal (the report fails on anything else)
    try:
        res["digest"] = check_replicated(
            mesh, list(state.params.values()), state.split())
    except ValueError as e:
        res["digest"] = None
        res["replicated_error"] = str(e)
    del state, step, pipe, batches
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11b: f32, micro-batch 1, deterministic cuDNN: loss and gradients --
    torch.backends.cudnn.deterministic = True
    pipe = _p11_pipeline("float32", P9_TRAINER_F32, TRAIN_HW)
    layout = shard_unet(pipe.unet, mesh)
    batch = train_batches(1, 1, seed=9, device=pipe.device)[0]
    batch["task_idx"] = P11_TASK
    state = TrainState(step=0, params=dict(pipe.unet.named_parameters()),
                       layout=layout)
    step = make_sharded_train_step(pipe, mesh, base_seed=2024)
    loss, _, grads = step.loss_and_grads(state, batch)
    res["f32_loss"] = float(loss)
    names = list(state.params)
    whole = []
    for n, g in zip(names, grads):
        w = layout.whole(n, g)
        if main:
            whole.append(w.cpu())
    del state, step, pipe, grads
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()
    if main:
        pipe = _p11_pipeline("float32", P9_TRAINER_F32, TRAIN_HW)
        state = TrainState(step=0,
                           params=dict(pipe.unet.named_parameters()))
        loss1, _, grads1 = make_train_step(pipe, base_seed=2024
                                           ).loss_and_grads(state, batch)
        res["f32_loss_1proc"] = float(loss1)
        res["f32_loss_rel"] = abs(res["f32_loss"] - float(loss1)) / abs(
            float(loss1))
        diff = sum(float((g.to(g1.device) - g1).double().square().sum())
                   for g, g1 in zip(whole, grads1))
        norm = sum(float(g1.double().square().sum()) for g1 in grads1)
        res["f32_grad_rel_l2"] = (diff / norm) ** 0.5
        res["f32_grad_max_abs"] = max(
            float((g.to(g1.device) - g1).abs().max())
            for g, g1 in zip(whole, grads1))
        del pipe, state, grads1
    del whole
    torch.backends.cudnn.deterministic = False
    mesh.barrier()
    shutdown()
    with open(out, "w") as f:
        json.dump(res, f)


def tp_report(ref: dict, ranks: list) -> dict:
    """Prints 11a-11c beside the one process and fails on a check; returns
    the ranks' launches by path."""
    r0 = ranks[0]
    paths = {}
    split_leaves, split_params = r0["split"]
    print(f"[tp] split over the model axis: {split_leaves} of "
          f"{r0['leaves']} main-UNet leaves, {split_params} of "
          f"{ref['params']} trainable parameters (want {P11_SPLIT})",
          flush=True)
    if tuple(r0["split"]) != P11_SPLIT:
        fail(f"the policy split {r0['split']}, not {P11_SPLIT}")
    # 11a
    rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["losses"])]
    print(f"[tp] 11a losses {r0['losses']} vs one process's "
          f"{ref['losses']}: relative {rel} (bar {P9_BF16_LOSS_REL:g})",
          flush=True)
    for r, res in enumerate(ranks):
        paths[f"tp 11a rank {r}"] = _by_kernel(res["counts"])
        paths[f"tp 11c rank {r}"] = _by_kernel(res["fwd_counts"])
        print(f"[tp] 11a rank {r}: ms " + ", ".join(
            f"{x:.1f}" for x in res["ms"]) + " (one process " + ", ".join(
            f"{x:.1f}" for x in ref["ms"]) + f"); peak {res['peak_gib']:.2f}"
            f" GiB (one process {ref['peak_gib']:.2f}); model-axis bytes a "
            f"micro-step {res['model_bytes']}; staged through the host "
            f"{res['staged_bytes']}; launches per micro-step " + " ".join(
                f"{k}={n / P11_STEPS:g}" for k, n in res["counts"].items())
            + f"; K3-K5 shapes {res['train_shapes']}; digest "
            f"{res['digest']}", flush=True)
        print(f"[tp] 11c rank {r}: launches {res['fwd_counts']}; K1 and K6 "
              f"shapes {res['fwd_shapes']}; model-axis bytes "
              f"{res['fwd_model_bytes']}", flush=True)
        if res["losses"] != r0["losses"]:
            fail("11a: the ranks disagree on the losses")
        if res["digest"] is None:
            fail(f"11a rank {r}: {res['replicated_error']}")
        for kernel in ("flash_fwd_resident_lse", "flash_bwd_dq",
                       "flash_bwd_dkv"):
            got = {tuple(s) for k, s, _ in res["train_shapes"]
                   if k == kernel}
            if not {(5, 1024, 64), (5, 4096, 64)} <= got:
                fail(f"11a rank {r}: {kernel} ran at {sorted(got)}, not at "
                     f"5 local heads of stage 1 and the 5 gathered heads of "
                     f"stage 0")
        # (C, F) of the main UNet's feed-forwards on F / 2 (the child's
        # whole ones are (320, 1280), (640, 2560), (1280, 5120))
        k6 = {(s[1], s[2]) for k, s, _ in res["fwd_shapes"]
              if k == "geglu_fused"}
        k1 = {tuple(s) for k, s, _ in res["fwd_shapes"]
              if k == "flash_fwd_resident"}
        if not {(320, 640), (640, 1280), (1280, 2560)} <= k6 or \
                (5, 1024, 64) not in k1:
            fail(f"11c rank {r}: K6 at (C, F) {sorted(k6)}, K1 at "
                 f"{sorted(k1)}: not the local shards")
        # phase 2 held K6 to geglu_reference at each (C, F) it ran at here
        unchecked = k6 - {(c, f) for (_, c, f), _ in GEGLU_SHAPES}
        if unchecked:
            fail(f"11c rank {r}: K6 ran at (C, F) {sorted(unchecked)}, "
                 f"which phase 2 does not check")
    if not all(x <= P9_BF16_LOSS_REL for x in rel):
        fail("11a: the TP losses are off the one process's")
    # 11b
    print(f"[tp] 11b f32, TP vs one process at micro-batch 1: loss "
          f"{r0['f32_loss']:.9g} vs {r0['f32_loss_1proc']:.9g} (rel "
          f"{r0['f32_loss_rel']:.3e}, bar {P11_F32_LOSS_REL:g}); gradients "
          f"rel_l2 {r0['f32_grad_rel_l2']:.4e} (bar {P11_F32_GRAD_REL_L2:g}),"
          f" max|diff| {r0['f32_grad_max_abs']:.4e}", flush=True)
    if ranks[1]["f32_loss"] != r0["f32_loss"]:
        fail("11b: the ranks disagree on the loss")
    if not (r0["f32_loss_rel"] <= P11_F32_LOSS_REL
            and r0["f32_grad_rel_l2"] <= P11_F32_GRAD_REL_L2):
        fail("11b: TP disagrees with one process in f32")
    # 11c
    ratio = r0["fwd_rel_l2_vs_f32"] / r0["one_rel_l2_vs_f32"]
    print(f"[tp] 11c bf16 forward with K6: TP vs one process rel_l2 "
          f"{r0['fwd_rel_l2_vs_one']:.4e}; against the f32 forward TP "
          f"{r0['fwd_rel_l2_vs_f32']:.4e}, one process "
          f"{r0['one_rel_l2_vs_f32']:.4e}: ratio {ratio:.4f} (bar "
          f"{P11_FWD_RATIO})", flush=True)
    if not r0["fwd_finite"] or not ratio <= P11_FWD_RATIO:
        fail("11c: the TP forward is further from f32 than one process's")
    return paths


def _by_kernel(counts: dict) -> dict:
    return {k: counts[k.__name__] for k in all_kernels()}


def tp_cli_two_ranks(tmp: str, p6_losses) -> dict:
    """11d: `cli.train` with `parallel: {model: 2}` as 2 ranks sharing the
    card over gloo (phase 6's tree and recipe, global micro-batch 2 on both
    ranks, accumulation 2, max_iter 1: 2 micro-steps and one save), then
    `cli.train --max_iter 2` here on one process resuming that checkpoint
    (micro-steps 3 and 4). Each micro-step's loss against phase 6's.
    Returns the launches of the three runs."""
    import gc

    import torch

    from stablemtl_tpu_torch.cli import train as train_cli
    from stablemtl_tpu_torch.ops import flash_attention as fa

    def check_losses(what, losses):
        rel = {s: abs(loss - p6_losses[s]) / abs(p6_losses[s])
               for s, loss in losses.items()}
        print(f"[tp] 11d {what} losses {losses} vs phase 6's "
              f"{ {s: p6_losses[s] for s in losses} }: relative {rel} "
              f"(bar {P9_BF16_LOSS_REL:g})", flush=True)
        if not all(r <= P9_BF16_LOSS_REL for r in rel.values()):
            fail(f"11d {what}: losses off phase 6's one process")

    lists = write_phase6_tree(os.path.join(tmp, "data"), seed=6)
    base = os.path.join(tmp, "phase6.yaml")
    phase6_config(base, lists)
    cfg2 = os.path.join(tmp, "tp2.yaml")
    with open(cfg2, "w") as f:
        json.dump({"base_config": [base],
                   "parallel": {"model": 2, "zero1": True}}, f)
    run = os.path.join(tmp, "tp_run")
    common = ["--base_data_dir", os.path.join(tmp, "data"), "--output_dir",
              run, "--num_workers", "0"]
    ranks = _dp_ranks("dp_cli_rank", ["--config", cfg2, "--max_iter", "1"]
                      + common, tmp, "tpcli")
    paths = {}
    for r, res in enumerate(ranks):
        paths[f"tp cli rank {r}"] = {k: res["launches"][k.__name__]
                                     for k in all_kernels()}
        print(f"[tp] 11d rank {r}: micro-steps {res['steps']} ms "
              + ", ".join(f"{x:.1f}" for x in res["ms"])
              + f"; peak {res['peak_gib']:.2f} GiB; model-axis bytes "
              f"{res['model_bytes']}; staged through the host "
              f"{res['staged_bytes']}; saves {res['saves']}; launches "
              + " ".join(f"{k}={n}" for k, n in res["launches"].items()),
              flush=True)
        if res["steps"] != [1, 2]:
            fail(f"11d rank {r} ran micro-steps {res['steps']}")
        for kernel in (fa.flash_fwd_resident_lse, fa.flash_bwd_dq,
                       fa.flash_bwd_dkv):
            if res["launches"][kernel.__name__] == 0:
                fail(f"11d rank {r}: {kernel.__name__} launched 0 times")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        fail("11d: the ranks logged different losses")
    check_losses("2 TP ranks", {int(s): x for s, x in ranks[0]["losses"]})
    with open(os.path.join(run, "checkpoint", "latest", "state.json")) as f:
        saved = json.load(f)
    print(f"[tp] 11d saved {saved}; run files {sorted(os.listdir(run))}",
          flush=True)
    if saved.get("model") != 2:
        fail(f"11d: the checkpoint records {saved}")

    cfg1 = os.path.join(tmp, "tp1.yaml")
    with open(cfg1, "w") as f:
        json.dump({"base_config": [base], "trainer": {"save_period": 1000}},
                  f)
    reset_counts()
    t0 = time.perf_counter()
    with no_final_save():
        trainer = train_cli.main(["--config", cfg1, "--max_iter", "2"]
                                 + common)
    torch.cuda.synchronize()
    paths["tp cli resumed 1-rank"] = read_counts()
    steps = [s for s, *_ in trainer.step_times]
    print(f"[tp] 11d resumed on 1 process: micro-steps {steps} in "
          f"{time.perf_counter() - t0:.1f} s; restores "
          f"{trainer.ckpt.restores}; saves {trainer.ckpt.saves}", flush=True)
    if steps != [3, 4] or trainer.state.opt.count != 2:
        fail(f"the 1-process resume ran {steps}, "
             f"{trainer.state.opt.count} updates")
    if len(trainer.ckpt.restores) != 1 or trainer.ckpt.saves:
        fail(f"the 1-process resume restored {trainer.ckpt.restores}, "
             f"saved {trainer.ckpt.saves}")
    check_losses("resumed", {s: x for s, _, x in trainer.losses})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print device time by kernel for one "
                             "step (torch.profiler)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import stablemtl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    # f32 references in full f32 (the kernels' f32 path has no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from stablemtl_tpu_torch.ops import flash_attention as fa
    from stablemtl_tpu_torch.ops import geglu

    phase_build()
    stats = phase_kernels()
    stats.update(phase_train_kernels())
    for kernel, variants in phase_variant_kernels().items():
        stats[kernel].update(variants)
    stats.update(phase_geglu_kernel())
    # each path's launches, counted from 0 over its own run
    paths = {"infer_all_tasks": phase_main_path(batch=1,
                                                profile=args.profile)}
    paths["train_step"], train_ms = phase_train_path(profile=args.profile)
    paths.update(phase_serving(profile=args.profile))
    entry_paths, p6_losses = phase_entry_points(train_ms)
    paths.update(entry_paths)
    paths.update(phase_ingest_and_recipes())
    paths.update(phase_artifact())
    paths.update(phase_data_parallel(train_ms, p6_losses))
    paths.update(phase_replicas())
    paths.update(phase_tensor_parallel(p6_losses))

    # (source, the TPU kernel it replaces)
    meta = {
        fa.flash_fwd_resident: ("stablemtl_tpu_torch/csrc/flash_fwd_a.cu",
                                "stablemtl_tpu/ops/flash_attention.py:258"),
        fa.flash_fwd_stream: ("stablemtl_tpu_torch/csrc/flash_fwd_b.cu",
                              "stablemtl_tpu/ops/flash_attention.py:501"),
        fa.flash_fwd_resident_lse: (
            "stablemtl_tpu_torch/csrc/flash_fwd_lse.cu",
            "stablemtl_tpu/ops/flash_attention.py:181"),
        fa.flash_bwd_dq: ("stablemtl_tpu_torch/csrc/flash_bwd_dq.cu",
                          "stablemtl_tpu/ops/flash_attention.py:266"),
        fa.flash_bwd_dkv: ("stablemtl_tpu_torch/csrc/flash_bwd_dkv.cu",
                           "stablemtl_tpu/ops/flash_attention.py:301"),
        geglu.geglu_fused: ("stablemtl_tpu_torch/csrc/geglu.cu",
                            "stablemtl_tpu/ops/geglu.py:62"),
    }
    # launches: the sum over the counted runs named in launches_over, each
    # counted from 0 for every kernel; launches_by_path holds each run's own
    # count
    kernels = []
    for kernel in all_kernels():
        s = stats[kernel]
        by_path = {path: counts[kernel] for path, counts in paths.items()}
        kernels.append(dict(
            name=kernel.__name__, route="cuda", source=meta[kernel][0],
            replaces=meta[kernel][1], launches=sum(by_path.values()),
            launches_over=list(paths),
            max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
            shape=s["shape"], launches_by_path=by_path,
            **{k: s[k] for k in (
                "ms_range", "library_covers", "library_range_ms",
                "library_autograd_ms", "library_autograd_range_ms",
                "port_backward_ms", "port_backward_range_ms", "timings",
                "variants")
               if k in s}))
    print(json.dumps({"kernels": kernels}), flush=True)
    if any(not math.isfinite(k["ms"]) for k in kernels):
        fail("non-finite timing")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
