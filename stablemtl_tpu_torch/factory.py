"""Config -> pipeline: model configs by preset, `build_pipeline`, and the
loader of converted weights.

Counterpart of `stablemtl_tpu/factory.py` (`model_configs`,
`build_pipeline`, `load_pretrained`, `class_colors`, and the training
builders `build_train_loader`, `build_val_datasets`,
`accumulation_steps_of`, `build_optimizer_config`). Random weights are
made on the target device from an explicit torch.Generator (scale leaves
1, bias leaves 0, every other leaf N(0, 0.02)); converted SD2 or reference
StableMTL weights load from the .npz trees `cli/convert_sd2.py` writes (as
the JAX package's `tools/convert_sd2.py` does). The data layer (OpenCV,
PIL) is imported only by the data builders.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Tuple

import numpy as np
import torch

from .data.semantic import VKitti2Encoder
from .models.clip import CLIPTextConfig, CLIPTextModel, tiny_clip_config
from .models.convert import flax_leaf_to_port
from .models.unet import (UNet2DConditionModel, UNetConfig, inflate_conv_in,
                          tiny_unet_config)
from .models.vae import AutoencoderKL, VAEConfig, tiny_vae_config
from .pipeline import N_TASKS, StableMTLPipeline, build_text_embed_table
from .train_state import OptimizerConfig

log = logging.getLogger(__name__)


def model_configs(preset: str, multi_stream: bool, trainer_cfg=None,
                  dtype: str = "float32", fast_math: bool = False,
                  remat: bool = False, remat_transformer: str = "none"
                  ) -> Tuple[UNetConfig, UNetConfig, VAEConfig, int]:
    """(main unet cfg, child unet cfg, vae cfg, text_dim). `remat` and
    `remat_transformer` are the `model` section's keys of a training config;
    the main UNet raises for any value but off (not ported yet)."""
    t = trainer_cfg or {}
    task_kw = dict(
        use_task_attention=multi_stream,
        n_attns=int(t.get("n_attns", 4)),
        attn_mask_ratio=float(t.get("attn_mask_ratio", 0.0)),
        attn_mask_type=str(t.get("attn_mask_type", "attn_prob")),
        task_attn_layers=str(t.get("apply_task_attn_to_layers", "all")),
        dtype=dtype, fast_math=fast_math, remat=remat,
        remat_transformer=remat_transformer)
    fm = dict(dtype=dtype, fast_math=fast_math)
    if preset == "nano":
        nano = dict(block_out_channels=(32, 64), attention_heads=(2, 2))
        return (tiny_unet_config(**nano, **task_kw),
                tiny_unet_config(**nano, **fm), tiny_vae_config(**fm),
                tiny_unet_config().cross_attention_dim)
    if preset == "tiny":
        return (tiny_unet_config(**task_kw), tiny_unet_config(**fm),
                tiny_vae_config(**fm), tiny_unet_config().cross_attention_dim)
    if preset == "small":
        base = dict(block_out_channels=(160, 320, 640, 640),
                    attention_heads=(5, 10, 20, 20))
        return (UNetConfig(**base, **task_kw), UNetConfig(**base, **fm),
                VAEConfig(block_out_channels=(64, 128, 256, 256), **fm),
                1024)
    if preset == "full":
        return (UNetConfig(**task_kw), UNetConfig(**fm), VAEConfig(**fm),
                1024)
    raise ValueError(preset)


def model_configs_from(cfg) -> Tuple[UNetConfig, UNetConfig, VAEConfig,
                                     int]:
    """`model_configs` of a config: model.size_preset, compute_dtype,
    fast_math, remat, remat_transformer and the trainer section; the
    'avg' second-frame mode (pipeline.encode_rgb_model) has one 4-channel
    rgb group, so both UNets' conv_in take 8 channels."""
    trainer = cfg.get("trainer") or {}
    model = cfg.get("model") or {}
    ucfg, ccfg, vcfg, text_dim = model_configs(
        model.get("size_preset", "full"),
        bool(trainer.get("multi_stream", False)), trainer,
        dtype=model.get("compute_dtype", "float32"),
        fast_math=bool(model.get("fast_math", False)),
        remat=bool(model.get("remat", False)),
        remat_transformer=str(model.get("remat_transformer", "none")))
    pipe_cfg = cfg.get("pipeline") or {}
    if pipe_cfg.get("encode_rgb_model", "duplicate") == "avg":
        ucfg = dataclasses.replace(ucfg, in_channels=8)
        ccfg = dataclasses.replace(ccfg, in_channels=8)
    return ucfg, ccfg, vcfg, text_dim


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA must be present when it is
    asked for: nothing silently continues on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return device


@torch.no_grad()
def init_weights_(module: torch.nn.Module, generator: torch.Generator):
    """Scale-like leaves (norm weights, bank `*_scale`) 1, bias leaves 0,
    the rest N(0, 0.02), in the order of `named_parameters`."""
    norm_weights = {id(m.weight) for m in module.modules()
                    if isinstance(m, (torch.nn.GroupNorm,
                                      torch.nn.LayerNorm))}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if id(p) in norm_weights or "scale" in leaf:
            p.fill_(1.0)
        elif "bias" in leaf:
            p.zero_()
        else:
            p.normal_(0.0, 0.02, generator=generator)


@torch.no_grad()
def cast_params_for_inference(pipe, dtype=torch.bfloat16, keep=None):
    """Cast the pipeline's matmul/conv weights (every parameter of rank >=
    2, the [T, C] bank norm leaves too, as in the Flax layout) to `dtype` in
    place; 1-D norm and bias vectors stay f32. `keep`: a module left as it
    is (the trainable UNet keeps f32 master weights). Returns the
    pipeline."""
    for m in (pipe.vae, pipe.unet, pipe.unet_child):
        if m is not None and m is not keep:
            for p in m.parameters():
                if p.dim() >= 2:
                    p.data = p.data.to(dtype)
    return pipe


def build_pipeline(cfg, seed: int = 0, device="cuda", image_hw=None,
                   trainable: bool = False) -> StableMTLPipeline:
    """The pipeline a config describes, built on `device`.

    cfg: a `config.Config` or nested dict. Read: model.size_preset
    (nano | tiny | small | full), model.compute_dtype, model.fast_math,
    model.remat, model.remat_transformer, model.pretrained_path ('scratch'
    or a directory of converted weights, see `load_pretrained`);
    trainer.multi_stream and the task-attention keys (attn_mask_ratio,
    attn_mask_type, n_attns, apply_task_attn_to_layers,
    exclude_mainstream_output_type, return_feature); pipeline.input_noise,
    pipeline.encode_rgb_model ('avg' builds an 8-channel conv_in),
    pipeline.decode_chunk.
    Without pretrained weights every leaf is drawn from `seed`, and the
    text table is random at the tiny preset, else the task prompts through
    a seeded random CLIP text tower (SD2's at full, a 2-layer one at the
    other presets). image_hw: the input (H, W) the pipeline checks, or
    None. A bfloat16 compute dtype also casts the frozen modules' weights
    (`cast_params_for_inference`). trainable=True keeps the main UNet's
    weights in f32 with requires_grad (it still computes in the compute
    dtype); the child and the VAE stay frozen."""
    device = resolve_device(device)
    trainer = cfg.get("trainer") or {}
    model = cfg.get("model") or {}
    pipe_cfg = cfg.get("pipeline") or {}
    multi_stream = bool(trainer.get("multi_stream", False))
    preset = model.get("size_preset", "full")
    dtype = model.get("compute_dtype", "float32")
    ucfg, ccfg, vcfg, text_dim = model_configs_from(cfg)
    encode_rgb_mode = pipe_cfg.get("encode_rgb_model", "duplicate")
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        vae = AutoencoderKL(vcfg)
        unet = UNet2DConditionModel(ucfg)
        child = UNet2DConditionModel(ccfg) if multi_stream else None
        for m in (vae, unet, child):
            if m is not None:
                init_weights_(m, gen)
        pretrained = model.get("pretrained_path", "scratch")
        if pretrained and pretrained != "scratch":
            table = torch.as_tensor(
                load_pretrained(pretrained, vae, unet, child, text_dim),
                device=device)
        elif preset == "tiny":
            table = torch.randn((N_TASKS, 5, text_dim), generator=gen) * 0.02
        else:
            clip = CLIPTextModel(
                CLIPTextConfig(dtype=dtype) if preset == "full"
                else tiny_clip_config(hidden_size=text_dim, num_heads=8,
                                      intermediate_size=2048))
            init_weights_(clip, gen)
            table = build_text_embed_table(clip.eval())
            del clip
    for m in (vae, unet, child):
        if m is not None:
            train_this = trainable and m is unet
            m.train(train_this).requires_grad_(train_this)
    pipe = StableMTLPipeline(
        vae=vae, unet=unet, text_embed_table=table, unet_child=child,
        input_noise=pipe_cfg.get("input_noise", "deterministic"),
        encode_rgb_mode=encode_rgb_mode,
        decode_chunk=int(pipe_cfg.get("decode_chunk", 0)),
        exclude_main_task=bool(trainer.get("exclude_mainstream_output_type",
                                           True)),
        child_tap=str(trainer.get("return_feature",
                                  "afterSelfAttn_residual")),
        image_hw=None if image_hw is None else tuple(image_hw))
    if dtype == "bfloat16":
        cast_params_for_inference(pipe, keep=unet if trainable else None)
    return pipe


def _flax_path(key: str) -> tuple:
    """An npz key ('/'-joined Flax path) -> its path below the 'params'
    collection, which the converters' trees may or may not carry."""
    path = tuple(key.split("/"))
    return path[1:] if path[0] == "params" and len(path) > 1 else path


@torch.no_grad()
def _load_over(module, npz_path: str, what: str, strict: bool):
    """Load the converted .npz tree at npz_path (keys are '/'-joined Flax
    paths, with or without the leading 'params') over `module` in place,
    through the same rules as `state_dict_from_flax`. A conv_in with fewer input channels than the
    module's is inflated (`inflate_conv_in`); any other missing or
    mismatched leaf keeps its init and is reported (raised with strict)."""
    if not os.path.exists(npz_path):
        log.warning("pretrained file missing: %s (keeping init)", npz_path)
        return
    with np.load(npz_path) as stored:
        ported = dict(flax_leaf_to_port(_flax_path(k), stored[k])
                      for k in stored.files)
    expected = module.state_dict()
    state, problems = {}, []
    for name, want in expected.items():
        if name not in ported:
            # the task-attention banks are not in SD2: their absence is
            # expected, they keep their init
            if "task_attn" not in name:
                problems.append(f"{name}: missing (init kept, shape "
                                f"{tuple(want.shape)})")
            continue
        got = ported[name]
        if got.shape == want.shape:
            state[name] = got
        elif (name.endswith("conv_in.weight") and got.dim() == 4
              and got.shape[0] == want.shape[0]
              and got.shape[2:] == want.shape[2:]
              and want.shape[1] % got.shape[1] == 0):
            repeat = want.shape[1] // got.shape[1]
            log.info("%s: inflating conv_in %d->%d input channels (repeat="
                     "%d, scale 1/%d)", what, got.shape[1], want.shape[1],
                     repeat, repeat)
            state[name] = inflate_conv_in(got, repeat)
        else:
            problems.append(f"{name}: shape {tuple(got.shape)} != expected "
                            f"{tuple(want.shape)} (init kept)")
    if problems:
        msg = (f"{what}: {len(problems)} parameter(s) NOT loaded from "
               f"{npz_path}:\n  " + "\n  ".join(problems[:20]))
        if len(problems) > 20:
            msg += f"\n  ... and {len(problems) - 20} more"
        if strict:
            raise ValueError(msg)
        log.warning(msg)
    unused = set(ported) - set(expected)
    if unused:
        log.warning("%s: %d stored array(s) unused (e.g. %s)", what,
                    len(unused), sorted(unused)[:5])
    module.load_state_dict(state, strict=False)


def load_pretrained(path: str, vae, unet, child, text_dim: int,
                    strict: bool = False) -> np.ndarray:
    """Load converted weights from directory `path` over the modules in
    place: vae.npz, unet.npz, and unet_child.npz for the child (unet.npz
    when absent). Returns the text table from text_table.npy, or an
    all-zero [n_tasks, 5, text_dim] table with a loud warning when that
    file is absent (every task's conditioning is then meaningless)."""
    _load_over(vae, os.path.join(path, "vae.npz"), "vae", strict)
    _load_over(unet, os.path.join(path, "unet.npz"), "unet", strict)
    if child is not None:
        child_npz = os.path.join(path, "unet_child.npz")
        if not os.path.exists(child_npz):
            child_npz = os.path.join(path, "unet.npz")
        _load_over(child, child_npz, "unet_child", strict)
    table_path = os.path.join(path, "text_table.npy")
    if os.path.exists(table_path):
        return np.load(table_path)
    log.warning("%s missing: text conditioning falls back to an ALL-ZERO "
                "task-embedding table; predictions are meaningless until a "
                "real table is provided (cli/convert_sd2.py writes it)",
                table_path)
    return np.zeros((N_TASKS, 5, text_dim), np.float32)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def build_train_loader(cfg, base_data_dir: str, accumulation_steps: int,
                       batch_size: int, seed: int, shard=None,
                       num_workers=None):
    """The mixed-task training loader of `cfg['dataset']['train']`.
    num_workers: overrides cfg dataloader.num_workers when not None (the
    CLI's --num_workers)."""
    from .data.augmentation import AugmentationConfig
    from .data.base import DatasetMode
    from .data.datasets import get_dataset
    from .data.loader import MixedTaskLoader
    from .utils.normalizers import get_depth_normalizer

    depth_norm = get_depth_normalizer(cfg.get("depth_normalization", {}))
    aug_cfg_tree = cfg.get("augmentation", {})
    train_cfg = cfg["dataset"]["train"]
    datasets = []
    for entry in train_cfg["dataset_list"]:
        entry = dict(entry)
        aug_key = entry.get("augmentation_key", "default")
        entry["augmentation"] = AugmentationConfig.from_dict(
            aug_cfg_tree.get(aug_key) or aug_cfg_tree.get("default"))
        entry["depth_normalizer"] = depth_norm
        datasets.append(get_dataset(entry, base_data_dir, DatasetMode.TRAIN))
    prob = list(train_cfg.get("prob_ls")) if "prob_ls" in train_cfg else None
    return MixedTaskLoader(
        datasets, batch_size=batch_size,
        accumulation_steps=accumulation_steps, seed=seed, prob=prob,
        iterative_sampling=bool(cfg["dataloader"].get(
            "iterative_sampling", True)),
        prefetch=int(cfg["dataloader"].get("prefetch", 2)),
        num_workers=int(num_workers if num_workers is not None
                        else cfg["dataloader"].get("num_workers", 0)),
        shard=shard)


def build_val_datasets(cfg, base_data_dir: str, split: str = "val"):
    """The eval datasets of `cfg['dataset'][split]` (val, test or vis)."""
    from .data.base import DatasetMode
    from .data.datasets import get_dataset

    return [get_dataset(dict(entry), base_data_dir, DatasetMode.EVAL)
            for entry in cfg["dataset"].get(split, []) or []]


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def accumulation_steps_of(cfg, n_devices: int) -> Tuple[int, int]:
    """(accumulation_steps, per-step batch) from the effective batch
    (reference train_stablemtl.py:165-168)."""
    dl = cfg["dataloader"]
    eff = int(dl.get("effective_batch_size", 32))
    max_bs = int(dl.get("max_train_batch_size", 4))
    n = max(n_devices, 1)
    # at least one sample per device
    per_dev = max(1, min(max_bs, eff // n))
    per_step = per_dev * n
    accum = max(1, eff // per_step)
    if accum * per_step != eff:
        log.warning(
            "effective_batch_size %d is not divisible by per-step batch %d "
            "(%d devices x %d): training with effective batch %d instead",
            eff, per_step, n, per_dev, accum * per_step)
    return accum, per_step


def build_optimizer_config(cfg, accumulation_steps: int) -> OptimizerConfig:
    """The config's lr, lr_scheduler and optimizer sections: optimizer.name
    (adam | adamw | adafactor), optimizer.mu_dtype (Adam's first moment,
    e.g. bfloat16) and optimizer.skip_nonfinite_updates (apply_if_finite's
    N; the JAX package's factory leaves that field at its default 0)."""
    sched = cfg.get("lr_scheduler") or {}
    kw = sched.get("kwargs") or {}
    opt = cfg.get("optimizer") or {}
    return OptimizerConfig(
        lr=float(cfg.get("lr", 1e-4)),
        total_iters=int(kw.get("total_iter", cfg.get("max_iter", 25000))),
        final_ratio=float(kw.get("final_ratio", 0.01)),
        warmup_steps=int(kw.get("warmup_steps", 100)),
        accumulation_steps=accumulation_steps,
        use_schedule=bool(sched),
        optimizer=str(opt.get("name", "adam")),
        mu_dtype=opt.get("mu_dtype", None),
        skip_nonfinite_updates=int(opt.get("skip_nonfinite_updates", 0)),
    )


def class_colors() -> np.ndarray:
    """The 8-class semantic palette [8, 3] (0..255, float32)."""
    return VKitti2Encoder(n_classes=8).class_color_embeddings
