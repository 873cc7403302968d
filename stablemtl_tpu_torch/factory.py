"""Model configs by preset, and `build_pipeline`.

Counterpart of `stablemtl_tpu/factory.py::model_configs` and of the
random-weight pipeline the JAX package benchmarks (`__graft_entry__.py`):
weights are made on the target device from an explicit torch.Generator
(scale leaves 1, bias leaves 0, every other leaf N(0, 0.02)).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .models.unet import UNet2DConditionModel, UNetConfig, tiny_unet_config
from .models.vae import AutoencoderKL, VAEConfig, tiny_vae_config
from .pipeline import N_TASKS, StableMTLPipeline


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
def cast_for_inference_(module: torch.nn.Module, dtype=torch.bfloat16):
    """Cast every parameter of rank >= 2 (matmul/conv weights and the [T, C]
    bank norm leaves, as in the Flax layout) to `dtype`; 1-D norm and bias
    vectors stay f32."""
    for p in module.parameters():
        if p.dim() >= 2:
            p.data = p.data.to(dtype)


def build_pipeline(preset: str = "full", multi_stream: bool = True,
                   image_hw=(512, 512), dtype: str = "float32",
                   fast_math: bool = False, seed: int = 0,
                   device="cuda", trainer_cfg=None,
                   trainable: bool = False, remat: bool = False,
                   remat_transformer: str = "none") -> StableMTLPipeline:
    """A pipeline with random weights from `seed`, built on `device`.

    trainer_cfg: the `trainer` section of a training config
    (attn_mask_ratio, attn_mask_type, n_attns, apply_task_attn_to_layers,
    exclude_mainstream_output_type, return_feature). remat,
    remat_transformer: as in `model_configs`.
    dtype 'bfloat16' also casts the frozen modules' weights as
    `cast_for_inference_` does. trainable=True keeps the main UNet's weights
    in f32 with requires_grad (it still computes in `dtype`); the child and
    the VAE stay frozen. The text table is a random [n_tasks, 5, text_dim]
    (the CLIP tower is not ported yet)."""
    device = resolve_device(device)
    t = trainer_cfg or {}
    ucfg, ccfg, vcfg, text_dim = model_configs(
        preset, multi_stream, t, dtype=dtype, fast_math=fast_math,
        remat=remat, remat_transformer=remat_transformer)
    gen = torch.Generator(device=device).manual_seed(seed)
    modules = []
    with torch.device(device):
        for build, cfg in ((AutoencoderKL, vcfg),
                           (UNet2DConditionModel, ucfg),
                           (UNet2DConditionModel,
                            ccfg if multi_stream else None)):
            if cfg is None:
                modules.append(None)
                continue
            train_this = trainable and cfg is ucfg
            m = build(cfg).train(train_this).requires_grad_(train_this)
            init_weights_(m, gen)
            if dtype == "bfloat16" and not train_this:
                cast_for_inference_(m)
            modules.append(m)
        table = torch.randn((N_TASKS, 5, text_dim), generator=gen) * 0.02
    vae, unet, child = modules
    return StableMTLPipeline(
        vae=vae, unet=unet, text_embed_table=table, unet_child=child,
        exclude_main_task=bool(t.get("exclude_mainstream_output_type", True)),
        child_tap=str(t.get("return_feature", "afterSelfAttn_residual")),
        image_hw=tuple(image_hw))
