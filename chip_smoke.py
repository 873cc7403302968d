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
   bit-equal whatever its mate and its row.

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
    """Phase 4. Returns {kernel: launches in the four counted
    micro-steps}."""
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
    for seed in (5, 6):
        time_train_steps(step, state, train_batches(
            5, TRAIN_BATCH, seed=seed, device=pipe.device))
    if profile:
        for batch in batches[2:]:  # a micro-step without, then with update
            profile_step(lambda: step(state, batch),
                         f"training micro-step (update: "
                         f"{state.opt.mini_step == 1})")
    del pipe, state, step
    torch.cuda.empty_cache()
    check_train_f32()
    return counts


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
                                                profile=args.profile),
             "train_step": phase_train_path(profile=args.profile)}
    paths.update(phase_serving(profile=args.profile))

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
