"""Convert Stable Diffusion 2 weights (diffusers layout), or a reference
StableMTL UNet checkpoint, into the npz trees `factory.load_pretrained`
reads. Counterpart of the JAX package's `tools/convert_sd2.py`, with the
same flags and outputs, and no JAX.

    python -m stablemtl_tpu_torch.cli.convert_sd2 --sd2_dir DIR \
        --out_dir OUT [--unet_pth reference_unet.pth] [--inflate_conv_in 3] \
        [--device cpu]

Reads <sd2_dir>/{unet,vae,text_encoder}/ weights (.safetensors through
`utils/safetensors_io`, .bin/.pth through `torch.load(weights_only=True)`,
a top-level `state_dict` unwrapped), converts layouts
(`models/torch_convert`), embeds the 7 task prompts with the CLIP text tower
on `--device` and the tokenizer in <sd2_dir>/tokenizer, and writes
unet.npz, vae.npz (keys: '/'-joined Flax paths under 'params') and
text_table.npy [7, L, 1024] f32. bf16 weights are stored as f32 (numpy has
no bf16; the widening is exact).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..factory import resolve_device
from ..models.clip import CLIPTextConfig, CLIPTextModel, get_tokenizer
from ..models.convert import state_dict_from_flax
from ..models.torch_convert import (convert_clip_text_state_dict,
                                    convert_unet_state_dict,
                                    convert_vae_state_dict, flatten_tree)
from ..pipeline import build_text_embed_table
from ..utils import safetensors_io

WEIGHT_FILES = ("diffusion_pytorch_model.safetensors",
                "diffusion_pytorch_model.bin", "model.safetensors",
                "pytorch_model.bin")


def find_weights(model_dir: str) -> str:
    for name in WEIGHT_FILES:
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no weights found in {model_dir} (looked for "
                            f"{', '.join(WEIGHT_FILES)})")


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """{key: numpy array} of a .safetensors, .bin or .pth state dict."""
    if path.endswith(".safetensors"):
        sd = safetensors_io.load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: _numpy(v) for k, v in sd.items()}


def save_tree(tree: dict, path: str) -> tuple:
    """Write a Flax-named tree as npz ('/'-joined keys). Returns (arrays,
    bytes)."""
    flat = {k.replace(".", "/"): v for k, v in flatten_tree(tree).items()}
    np.savez(path, **flat)
    return len(flat), os.path.getsize(path)


def inflate_conv_in_kernel(kernel: np.ndarray, repeat: int) -> np.ndarray:
    """HWIO conv_in kernel tiled `repeat` times along its input channels and
    scaled by 1/repeat (the JAX package's `inflate_conv_in`)."""
    return np.tile(kernel, (1, 1, repeat, 1)) / np.float32(repeat)


def convert(sd2_dir: str, out_dir: str, unet_pth: Optional[str] = None,
            inflate_conv_in: int = 0,
            clip_config: Optional[CLIPTextConfig] = None,
            device="cuda") -> dict:
    """Write vae.npz, unet.npz and text_table.npy into out_dir. clip_config:
    the text tower's config (SD2's by default). Returns {output file:
    (arrays, bytes, seconds)}."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    report = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        n, nbytes = fn()
        report[name] = (n, nbytes, time.perf_counter() - t0)
        print(f"wrote {os.path.join(out_dir, name)}: {n} arrays, {nbytes} "
              f"bytes in {report[name][2]:.1f} s", flush=True)

    def vae():
        sd = load_state_dict(find_weights(os.path.join(sd2_dir, "vae")))
        return save_tree({"params": convert_vae_state_dict(sd)},
                         os.path.join(out_dir, "vae.npz"))

    def unet():
        sd = load_state_dict(unet_pth or find_weights(
            os.path.join(sd2_dir, "unet")))
        tree = convert_unet_state_dict(sd)
        if inflate_conv_in > 1:
            conv_in = tree["conv_in"]
            conv_in["kernel"] = inflate_conv_in_kernel(conv_in["kernel"],
                                                       inflate_conv_in)
            print(f"inflated conv_in to {conv_in['kernel'].shape}")
        return save_tree({"params": tree}, os.path.join(out_dir, "unet.npz"))

    def table():
        sd = load_state_dict(find_weights(
            os.path.join(sd2_dir, "text_encoder")))
        state = state_dict_from_flax(convert_clip_text_state_dict(sd))
        with torch.device("meta"):
            clip = CLIPTextModel(clip_config or CLIPTextConfig())
        clip.load_state_dict(state, strict=True, assign=True)
        clip = clip.to(device).eval()
        with torch.no_grad():
            emb = build_text_embed_table(clip, tokenizer=get_tokenizer(
                os.path.join(sd2_dir, "tokenizer")))
        path = os.path.join(out_dir, "text_table.npy")
        np.save(path, emb.float().cpu().numpy())
        print(f"text table {tuple(emb.shape)}")
        return 1, os.path.getsize(path)

    timed("vae.npz", vae)
    timed("unet.npz", unet)
    timed("text_table.npy", table)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sd2_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--unet_pth", default=None,
                    help="a reference StableMTL unet .pth to convert instead "
                         "of the SD2 unet (per-task banks are stacked)")
    ap.add_argument("--inflate_conv_in", type=int, default=0,
                    help="pre-inflate the UNet conv_in input channels by this "
                         "repeat factor (3 for the 12-channel model, 2 for "
                         "'avg' mode). 0 stores the kernel as it is: "
                         "factory.load_pretrained inflates on a shape "
                         "mismatch")
    ap.add_argument("--device", default="cuda",
                    help="where the CLIP text tower embeds the task prompts")
    args = ap.parse_args(argv)
    return convert(args.sd2_dir, args.out_dir, unet_pth=args.unet_pth,
                   inflate_conv_in=args.inflate_conv_in, device=args.device)


if __name__ == "__main__":
    main()
