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
   projection, and at ragged row counts with the small and tiny presets'
   C (160, 32), both gelus;
3. fused all-task inference at full SD2 width, 512x512, bf16, fast math,
   with launch counters reset before and read after; a second bf16 step
   holds every kernel call against the plain version on that call's own
   inputs; the output is held against the same pipeline with
   STABLEMTL_DISABLE_FLASH=1 (plain attention on the card) and against both
   paths on the same weights in f32, then timed at batch 1 and 2;
4. the multi-stream training step at full SD2 width (create_train_state,
   make_train_step) with the flagship trainer settings: 288x384, micro-batch
   2, accumulation 2, bf16 compute over f32 master weights, Adam at lr 1e-4
   under IterExponential, clip 5.0, task masking attn_prob at 0.4. Four
   micro-steps with counters reset before and read after; finite losses and
   gradients; parameters unchanged by the first update (lr(0) = 0 under
   warmup) and changed by the second; every kernel call of a bf16
   micro-step held against its plain version on its own inputs; in f32 at
   batch 1, the loss and every main-UNet gradient with flash against
   STABLEMTL_DISABLE_FLASH=1 on the same weights, batch and generator; then
   ms per micro-step, train images/s and peak memory;
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
   accumulated gradient: skipped, nothing moves, optax's counters.

It prints the card's name and power limit from nvidia-smi, a JSON line
{"kernels": [...]}, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3, and
# the special-function units' exp2 rate (4 SFU ops/clk per SM quadrant,
# 132 SMs, 1.83 GHz boost).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXP2 = 132 * 16 * 1.83e9
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
# 128-feature tile is half past F (the gate takes F % 64)
GEGLU_SHAPES = [((57344, 320, 1280), True), ((14336, 640, 2560), True),
                ((3584, 1280, 5120), True), ((896, 1280, 5120), True),
                ((1100, 320, 1280), False), ((1100, 160, 640), False),
                ((1050, 32, 128), False), ((1050, 64, 192), False)]
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
                       tensors: int = 4, rows: int = 0) -> tuple:
    """Least time for a flash kernel on [bh, s, d]: the larger of the bytes
    (`tensors` [bh, s, d] tensors and `rows` [bh, s] f32 vectors, each read
    or written once) over HBM bandwidth and the operations (flops*s*s*d
    FLOPs and s*s exp2 per head) over their peaks. The forward is 4 FLOPs
    and 4 tensors; K3 adds the lse row; K4 is 6 FLOPs, 5 tensors (q, k, v,
    dO, dQ) and 2 rows (lse, delta); K5 8 FLOPs, 6 tensors and 2 rows."""
    import torch

    item = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (tensors * bh * s * d * item + rows * bh * s * 4) / PEAK_BYTES
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops = max(flops * bh * s * s * d / peak, bh * s * s / PEAK_EXP2)
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
    return counts


def run_checked_calls(pipe, rgb):
    """infer_all_tasks with every flash call also run through the plain
    version on its own inputs. Returns [(kernel, q shape, max |err|,
    relative L2)] per call."""
    from stablemtl_tpu_torch.ops import attention
    from stablemtl_tpu_torch.ops import flash_attention as fa

    launch = attention.flash_attention
    calls = []

    def checked(q, k, v):
        out = launch(q, k, v)
        b, s, h, d = q.shape

        def fold(x):
            return x.permute(0, 2, 1, 3).reshape(b * h, s, d)

        ref = fa.flash_reference(fold(q), fold(k), fold(v),
                                 fa.fast_softmax())
        name = ("flash_fwd_resident" if d <= fa.RESIDENT_MAX_HEAD_DIM
                else "flash_fwd_stream")
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


def time_steps(pipe, batch: int, iters: int = 3) -> float:
    """ms per infer_all_tasks step at `batch` (host clock around
    synchronized steps, after one warm-up step)."""
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
    print(f"[path] infer_all_tasks batch {batch}: {step_ms:.2f} ms/step, "
          f"{batch / step_ms * 1e3:.4f} images/s (all 7 tasks), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return step_ms


def train_batches(n: int, batch: int, seed: int, device):
    """n micro-batches at TRAIN_HW made on the card: frames in [-1, 1] (the
    next frame a shifted copy), a GT image, a valid mask with an invalid
    band, and one task per effective batch of 2 micro-steps (a single-frame
    task, then a two-frame one)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    tasks = (1, 1, 3, 3)  # depth, depth, optical_flow, optical_flow
    out = []
    for i in range(n):
        def img():
            return torch.rand((batch, *TRAIN_HW, 3), generator=gen,
                              device=device) * 2 - 1
        rgb, gt = img(), img()
        valid = torch.ones((batch, *TRAIN_HW, 1), dtype=torch.bool,
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

        def run(*args):
            got = kernel(*args)
            want = plain(*args)
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

    wrappers = {
        "flash_fwd_resident": checked("flash_fwd_resident",
                                      fa.flash_reference, ("o",)),
        "flash_fwd_stream": checked("flash_fwd_stream", fa.flash_reference,
                                    ("o",)),
        "flash_fwd_resident_lse": checked(
            "flash_fwd_resident_lse", fa.flash_forward_lse_reference,
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
    os.environ["STABLEMTL_DISABLE_FLASH"] = "1"
    try:
        loss_p, _, grads_p = step.loss_and_grads(state, batch)
    finally:
        del os.environ["STABLEMTL_DISABLE_FLASH"]
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


def phase_entry_points(phase4_ms) -> dict:
    """Phase 6. Returns {path: {kernel: launches}} of the two training runs
    and the eval run, each counted from 0."""
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
    return paths


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
    stats.update(phase_geglu_kernel())
    # each path's launches, counted from 0 over its own run
    paths = {"infer_all_tasks": phase_main_path(batch=1,
                                                profile=args.profile)}
    paths["train_step"], train_ms = phase_train_path(profile=args.profile)
    paths.update(phase_serving(profile=args.profile))
    paths.update(phase_entry_points(train_ms))
    paths.update(phase_ingest_and_recipes())

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
                "port_backward_ms", "port_backward_range_ms", "timings")
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
