#!/usr/bin/env python3
"""Write a synthetic Stable Diffusion 2 directory in the diffusers layout
(unet/, vae/, text_encoder/, a small BPE tokenizer/) at full size, with the
PyTorch port alone: the counterpart of `tools/make_synthetic_sd2.py`.

    python3 tools/torch_make_synthetic_sd2.py --out_dir DIR [--seed 0] \
        [--unet_safetensors] [--multistream_pth ref_unet.pth] [--device cpu]

The torch key names come from the port's own modules, built on the meta
device (nothing allocated), by inverting the converters' mapping
(`stablemtl_tpu_torch/models/torch_convert.py`); every generated state dict
is run back through those converters and must give the module's parameter
names and shapes (with `check_values`, also its values). Values are drawn
from a seeded torch.Generator on `--device`: norm scales 1 + 0.02 N, every
other leaf (biases too) 0.02 N, so a leaf that is not loaded cannot pass
for one that is. `--multistream_pth` also writes a reference-style
multi-stream UNet checkpoint (12-channel conv_in, per-task bank keys
`...attn1.task_to_k.<task>.fc1.weight`), as `cli/convert_sd2.py --unet_pth`
reads it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from stablemtl_tpu_torch import TASKS  # noqa: E402
from stablemtl_tpu_torch.models.clip import (CLIPTextConfig,  # noqa: E402
                                             CLIPTextModel, _bytes_to_unicode)
from stablemtl_tpu_torch.models.convert import \
    state_dict_from_flax  # noqa: E402
from stablemtl_tpu_torch.models.torch_convert import (  # noqa: E402
    convert_clip_text_state_dict, convert_unet_state_dict,
    convert_vae_state_dict)
from stablemtl_tpu_torch.models.unet import (  # noqa: E402
    UNet2DConditionModel, UNetConfig)
from stablemtl_tpu_torch.models.vae import (  # noqa: E402
    AutoencoderKL, VAEConfig)
from stablemtl_tpu_torch.utils import safetensors_io  # noqa: E402

_GENERIC = re.compile(r"(down_blocks|up_blocks|attentions|resnets|"
                      r"downsamplers|upsamplers|transformer_blocks|layers)"
                      r"_(\d+)")
_BANK = re.compile(r"(.*)\.task_attn\.(.*)")


def diffusers_module_path(path: str) -> str:
    """A port module path -> the diffusers one (the inverse of
    torch_convert's `_flatten_module_path` and its naming quirks)."""
    path = re.sub(r"(downsamplers|upsamplers)_(\d+)_conv$", r"\1_\2.conv",
                  path)
    prev = None
    while prev != path:
        prev = path
        path = _GENERIC.sub(lambda m: f"{m.group(1)}.{m.group(2)}", path)
    path = path.replace("mid_block_resnets.", "mid_block.resnets.")
    path = path.replace("mid_block_attentions.", "mid_block.attentions.")
    path = re.sub(r"(down_blocks|up_blocks)\.(\d+)_"
                  r"(resnets|attentions|downsamplers|upsamplers)\.",
                  r"\1.\2.\3.", path)
    path = re.sub(r"\.to_out_0$", ".to_out.0", path)
    path = re.sub(r"\.ff\.net_0\.proj$", ".ff.net.0.proj", path)
    return re.sub(r"\.ff\.net_2$", ".ff.net.2", path)


def _bank_entries(prefix: str, leaf: str, value: torch.Tensor):
    """A stacked bank leaf of the port -> the reference's per-task keys."""
    attn1 = diffusers_module_path(prefix) + ".attn1"
    if leaf == "to_out_task_kernel":
        return [(f"{attn1}.to_out_task.weight", value.t())]
    if leaf == "to_out_task_bias":
        return [(f"{attn1}.to_out_task.bias", value)]
    m = (re.fullmatch(r"(task_norm_[kvq])_(scale|bias)", leaf)
         or re.fullmatch(r"(task_to_[kv])_(fc[12])_(kernel|bias)", leaf)
         or re.fullmatch(r"(task_to_q)_net_(\d+)_(kernel|bias)", leaf))
    if m is None:
        raise KeyError(leaf)
    bank, *sub, kind = m.groups()
    if bank == "task_to_q":
        sub = [f"net.{sub[0]}"]
    kernel = kind == "kernel"
    name = "weight" if kind in ("kernel", "scale") else "bias"
    return [(".".join([attn1, bank, task, *sub, name]),
             value[t].t() if kernel else value[t])
            for t, task in enumerate(TASKS)]


def model_entries(name: str, value: torch.Tensor):
    """One UNet or VAE parameter of the port -> [(torch key, tensor)]; the
    port's Dense and Conv weights already have torch's layout."""
    bank = _BANK.fullmatch(name)
    if bank:
        return _bank_entries(bank.group(1), bank.group(2), value)
    path, leaf = name.rsplit(".", 1)
    return [(f"{diffusers_module_path(path)}.{leaf}", value)]


def clip_entries(name: str, value: torch.Tensor):
    """One CLIP text-tower parameter of the port -> [(transformers key,
    tensor)]."""
    if name in ("token_embedding", "position_embedding"):
        return [(f"text_model.embeddings.{name}.weight", value)]
    path, leaf = name.rsplit(".", 1)
    if path == "final_layer_norm":
        return [(f"text_model.final_layer_norm.{leaf}", value)]
    i, sub = re.fullmatch(r"layers_(\d+)_(.*)", path).groups()
    if sub in ("q_proj", "k_proj", "v_proj", "out_proj"):
        sub = f"self_attn.{sub}"
    elif sub in ("fc1", "fc2"):
        sub = f"mlp.{sub}"
    return [(f"text_model.encoder.layers.{i}.{sub}.{leaf}", value)]


def draw(module, gen: torch.Generator, device) -> dict:
    """{name: CPU tensor} of a meta-device module's parameters: norm and
    bank scales 1 + 0.02 N, every other leaf 0.02 N."""
    norms = {f"{n}.weight" for n, m in module.named_modules()
             if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm))}
    out = {}
    for name, p in module.named_parameters():
        v = torch.randn(p.shape, generator=gen, device=device) * 0.02
        if name in norms or name.endswith("_scale"):
            v += 1.0
        out[name] = v.cpu()
    return out


def self_check(what: str, converted: dict, module, want: dict = None):
    """The converted tree must give the module's parameter names and shapes
    (and, with `want`, those values bit for bit)."""
    got = state_dict_from_flax(converted)
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    missing = sorted(set(shapes) - set(got))
    extra = sorted(set(got) - set(shapes))
    bad = sorted(n for n in set(got) & set(shapes)
                 if tuple(got[n].shape) != shapes[n])
    if missing or extra or bad:
        raise ValueError(f"{what} round trip: missing {missing[:8]}, extra "
                         f"{extra[:8]}, shapes {bad[:8]}")
    if want is not None:
        diff = [n for n in shapes if not torch.equal(got[n], want[n])]
        if diff:
            raise ValueError(f"{what} round trip: values differ at "
                             f"{diff[:8]}")
    return len(shapes)


def write_tokenizer(path: str):
    """A tiny byte-level BPE vocabulary: every byte symbol alone and with
    '</w>', a few merges, and the two specials."""
    os.makedirs(path, exist_ok=True)
    byte_syms = list(_bytes_to_unicode().values())
    merges = [("d", "e"), ("de", "p"), ("dep", "t"), ("dept", "h</w>"),
              ("f", "l"), ("fl", "o"), ("flo", "w</w>"), ("n", "o"),
              ("no", "r"), ("s", "e"), ("se", "m")]
    vocab = byte_syms + [s + "</w>" for s in byte_syms]
    vocab += ["".join(m) for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(dict.fromkeys(vocab))}, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges)
                + "\n")


def _save(sd: dict, path: str) -> int:
    if path.endswith(".safetensors"):
        return safetensors_io.save_file(sd, path, {"format": "pt"})
    torch.save(sd, path)
    return os.path.getsize(path)


def make_synthetic_sd2(out_dir: str, seed: int = 0,
                       unet_safetensors: bool = False,
                       multistream_pth: str = None, device="cuda",
                       unet_config: UNetConfig = None,
                       vae_config: VAEConfig = None,
                       clip_config: CLIPTextConfig = None,
                       check_values: bool = False, log=print) -> dict:
    """Write the directory; return {"unet", "vae", "text_encoder" and, with
    multistream_pth, "unet_ms": {port parameter name: CPU tensor}} (the
    values each module must hold once converted and loaded; conv_in of
    "unet" has SD2's 4 input channels) and "files": {path: (tensors,
    bytes, seconds)}. The configs default to the full SD2 ones (a UNet
    without task banks, 4-channel conv_in); the multi-stream UNet is
    `unet_config` with 12 input channels and task attention on every
    layer."""
    from stablemtl_tpu_torch.factory import resolve_device

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    ucfg = unet_config or UNetConfig()
    builds = [("unet", UNet2DConditionModel, dataclasses.replace(
                  ucfg, in_channels=4, use_task_attention=False),
               model_entries, convert_unet_state_dict),
              ("vae", AutoencoderKL, vae_config or VAEConfig(),
               model_entries, convert_vae_state_dict),
              ("text_encoder", CLIPTextModel, clip_config or CLIPTextConfig(),
               clip_entries, convert_clip_text_state_dict)]
    if multistream_pth:
        builds.append(("unet_ms", UNet2DConditionModel, dataclasses.replace(
            ucfg, in_channels=12, use_task_attention=True,
            task_attn_layers="all"), model_entries, convert_unet_state_dict))
    out, files = {}, {}
    for what, cls, cfg, entries, converter in builds:
        t0 = time.perf_counter()
        with torch.device("meta"):
            module = cls(cfg)
        values = draw(module, gen, device)
        sd = dict(kv for name, v in values.items()
                  for kv in entries(name, v))
        if what == "text_encoder":  # a buffer real checkpoints carry
            sd["text_model.embeddings.position_ids"] = torch.arange(
                cfg.max_position_embeddings)[None]
        n = self_check(what, converter({k: v.numpy() for k, v in
                                        sd.items()}), module,
                       values if check_values else None)
        if what == "unet_ms":
            path = multistream_pth
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
        else:
            sub = os.path.join(out_dir, what)
            os.makedirs(sub, exist_ok=True)
            name = ("pytorch_model.bin" if what == "text_encoder"
                    else "diffusion_pytorch_model." + (
                        "safetensors" if what == "unet" and unet_safetensors
                        else "bin"))
            path = os.path.join(sub, name)
        nbytes = _save(sd, path)
        files[path] = (len(sd), nbytes, time.perf_counter() - t0)
        log(f"{what}: {n} parameters round-trip; wrote {path}: {len(sd)} "
            f"tensors, {nbytes} bytes in {files[path][2]:.1f} s")
        out[what] = values
    write_tokenizer(os.path.join(out_dir, "tokenizer"))
    out["files"] = files
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--unet_safetensors", action="store_true",
                    help="write the UNet as diffusion_pytorch_model."
                         "safetensors instead of .bin")
    ap.add_argument("--multistream_pth", default=None,
                    help="also write a reference-style multi-stream UNet "
                         "checkpoint here")
    ap.add_argument("--device", default="cuda",
                    help="where the values are drawn")
    args = ap.parse_args(argv)
    make_synthetic_sd2(args.out_dir, seed=args.seed,
                       unet_safetensors=args.unet_safetensors,
                       multistream_pth=args.multistream_pth,
                       device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
