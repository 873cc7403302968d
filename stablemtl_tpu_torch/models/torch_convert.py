"""Torch (diffusers/transformers) state_dict -> Flax-named parameter tree.

The port's own copy of `stablemtl_tpu/models/torch_convert.py` (numpy only;
the task order is the port's `TASKS`). It ingests (a) Stable Diffusion 2
weights (unet / vae / text_encoder state dicts saved by diffusers) and (b)
the reference StableMTL checkpoints (single_stream_unet.pth etc., README
anhquancao/StableMTL), including the per-task QKV MLP banks, which torch
stores as ModuleDict entries per task and the Flax layout as stacked
[n_tasks, ...] banks.

Tensor layout transforms:
  Conv2d   [O, I, kh, kw] -> NHWC kernel [kh, kw, I, O]
  Linear   [O, I]         -> [I, O]
  Norm     weight/bias    -> scale/bias

The output is the Flax-named numpy tree the JAX package stores
(`cli/convert_sd2.py` writes it as npz); `models/convert.py` carries such a
tree into the port's modules. Only numpy arrays are handled: call
`{k: v.numpy() for k, v in sd.items()}` on a torch state_dict first.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from .. import TASKS


def _set(tree: dict, path: list, value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _linear_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


_MODULE_JOIN = re.compile(
    r"(down_blocks|up_blocks|attentions|resnets|downsamplers|upsamplers|"
    r"transformer_blocks|layers|mid_block)\.(\d+)")


def _flatten_module_path(key: str) -> str:
    """'down_blocks.0.resnets.1.norm1.weight' ->
       'down_blocks_0_resnets_1.norm1.weight' (our flat module names)."""
    prev = None
    while prev != key:
        prev = key
        key = _MODULE_JOIN.sub(lambda m: f"{m.group(1)}_{m.group(2)}", key)
    # module-name groups that stay glued together
    key = key.replace("mid_block.resnets_", "mid_block_resnets_")
    key = key.replace("mid_block.attentions_", "mid_block_attentions_")
    for blk in ("down_blocks", "up_blocks"):
        key = re.sub(rf"({blk}_\d+)\.(resnets_|attentions_|downsamplers_|"
                     rf"upsamplers_)", r"\1_\2", key)
    key = re.sub(r"(attentions_\d+)\.(transformer_blocks_\d+)", r"\1.\2", key)
    return key


def _leaf(name: str, w: np.ndarray, is_conv: bool):
    """Map a torch parameter leaf to (flax_leaf_name, transformed array)."""
    if name == "weight":
        if is_conv:
            return "kernel", _conv_kernel(w)
        if w.ndim == 2:
            return "kernel", _linear_kernel(w)
        return "scale", w  # norm weight
    if name == "bias":
        return "bias", w
    raise KeyError(name)



def _is_conv(torch_key: str, w: np.ndarray) -> bool:
    return w.ndim == 4


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

def convert_unet_state_dict(sd: Dict[str, np.ndarray],
                            n_tasks: int = len(TASKS),
                            tasks=TASKS) -> dict:
    """diffusers UNet2DConditionModel (+StableMTL task-QKV surgery) -> pytree."""
    tree: dict = {}
    task_bank: dict = {}  # (module_path, bank_name, task) -> array

    for key, w in sd.items():
        w = np.asarray(w)
        # --- per-task ModuleDict params -> collect into banks --------------
        m = re.search(
            r"(.*attn1)\.(task_to_[kvq]|task_norm_[kvq]|to_out_task)"
            r"(?:\.([a-z_]+))?\.(.*)", key)
        if m:
            prefix, bank, task, rest = m.groups()
            task_bank.setdefault((prefix, bank, task), {})[rest] = w
            continue

        key2 = _flatten_module_path(key)
        parts = key2.split(".")
        name = parts[-1]

        # diffusers naming quirks -> our names
        joined = ".".join(parts)
        joined = joined.replace(".to_out.0.", ".to_out_0.")
        joined = joined.replace(".ff.net.0.proj.", ".ff.net_0.proj.")
        joined = joined.replace(".ff.net.2.", ".ff.net_2.")
        parts = joined.split(".")
        name = parts[-1]
        path = parts[:-1]

        # time embedding: diffusers 'time_embedding.linear_1'
        leaf_name, arr = _leaf(name, w, _is_conv(key, w))
        _set(tree, path + [leaf_name], arr)

    # --- assemble task banks -------------------------------------------------
    banks: dict = {}
    for (prefix, bank, task), leaves in task_bank.items():
        banks.setdefault(prefix, {}).setdefault(bank, {}).setdefault(task, leaves)

    for prefix, bankmap in banks.items():
        mod_path = _flatten_module_path(prefix).split(".")
        # attn1 path -> task_attn module lives alongside attn1
        ta_path = mod_path[:-1] + ["task_attn"]
        for bank, taskmap in bankmap.items():
            if bank == "to_out_task":
                leaves = taskmap[None]
                _set(tree, ta_path + ["to_out_task_kernel"],
                     _linear_kernel(leaves["weight"]))
                _set(tree, ta_path + ["to_out_task_bias"], leaves["bias"])
                continue
            # stack per-task leaves in canonical order; tasks absent from
            # the checkpoint's ModuleDict get identity-ish fills (LN scale
            # -> 1, everything else -> 0) and a LOUD warning — silent
            # zero-scale LayerNorms would make those tasks produce garbage
            # without any error
            missing = [t for t in tasks if t not in taskmap]
            if missing:
                import sys

                print(f"WARNING: checkpoint has no '{bank}' weights for "
                      f"tasks {missing} at {prefix}; filling identity-ish "
                      f"(these tasks were not trained in this checkpoint)",
                      file=sys.stderr)
            sample = taskmap[tasks[0] if tasks[0] in taskmap else
                             next(iter(taskmap))]
            for rest in sample:
                is_ln_scale = (bank.startswith("task_norm")
                               and rest == "weight")
                fill = (np.ones_like(sample[rest]) if is_ln_scale
                        else np.zeros_like(sample[rest]))
                stacked = np.stack([
                    taskmap[t][rest] if t in taskmap else fill
                    for t in tasks])
                _set_bank_leaf(tree, ta_path, bank, rest, stacked)
    return tree


def _set_bank_leaf(tree, ta_path, bank, rest, stacked):
    """Map torch per-task leaf names to our bank param names."""
    # rest examples: 'fc1.weight', 'net.0.weight', 'weight' (LayerNorm)
    if bank.startswith("task_norm"):
        leaf = "scale" if rest == "weight" else "bias"
        _set(tree, ta_path + [f"{bank}_{leaf}"], stacked)
        return
    if bank in ("task_to_k", "task_to_v"):
        m = re.match(r"(fc[12])\.(weight|bias)", rest)
        which, wb = m.groups()
        if wb == "weight":
            stacked = np.transpose(stacked, (0, 2, 1))
            _set(tree, ta_path + [f"{bank}_{which}_kernel"], stacked)
        else:
            _set(tree, ta_path + [f"{bank}_{which}_bias"], stacked)
        return
    if bank == "task_to_q":
        m = re.match(r"net\.(\d+)\.(weight|bias)", rest)
        idx, wb = m.groups()
        if wb == "weight":
            stacked = np.transpose(stacked, (0, 2, 1))
            _set(tree, ta_path + [f"{bank}_net_{idx}_kernel"], stacked)
        else:
            _set(tree, ta_path + [f"{bank}_net_{idx}_bias"], stacked)
        return
    raise KeyError(bank)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def convert_vae_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """diffusers AutoencoderKL state_dict -> our pytree."""
    tree: dict = {}
    for key, w in sd.items():
        w = np.asarray(w)
        key2 = _flatten_module_path(key)
        # downsamplers/upsamplers conv glued into module name in our VAE
        key2 = re.sub(r"(downsamplers_\d+)\.conv\.", r"\1_conv.", key2)
        key2 = re.sub(r"(upsamplers_\d+)\.conv\.", r"\1_conv.", key2)
        key2 = key2.replace(".to_out.0.", ".to_out_0.")
        # older diffusers VAE attention naming -> to_q/k/v/out_0
        key2 = (key2.replace(".query.", ".to_q.").replace(".key.", ".to_k.")
                .replace(".value.", ".to_v.").replace(".proj_attn.", ".to_out_0."))
        parts = key2.split(".")
        name = parts[-1]
        is_conv = w.ndim == 4
        if is_conv and w.shape[-1] == 1 and w.shape[-2] == 1 and (
                "to_q" in key2 or "to_k" in key2 or "to_v" in key2
                or "to_out_0" in key2):
            # 1x1 conv attention projections in old checkpoints -> linear
            w = w[:, :, 0, 0]
            is_conv = False
        leaf_name, arr = _leaf(name, w, is_conv)
        _set(tree, parts[:-1] + [leaf_name], arr)
    return tree


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------

def convert_clip_text_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """transformers CLIPTextModel state_dict -> our pytree."""
    tree: dict = {}
    for key, w in sd.items():
        w = np.asarray(w)
        key = key.replace("text_model.", "")
        if key == "embeddings.token_embedding.weight":
            tree["token_embedding"] = w
            continue
        if key == "embeddings.position_embedding.weight":
            tree["position_embedding"] = w
            continue
        if key.startswith("embeddings.position_ids"):
            continue
        m = re.match(r"encoder\.layers\.(\d+)\.(.*)", key)
        if m:
            i, rest = m.groups()
            rest = (rest.replace("self_attn.", "").replace("mlp.", ""))
            sub, name = rest.rsplit(".", 1)
            leaf_name, arr = _leaf(name, w, False)
            _set(tree, [f"layers_{i}_{sub}", leaf_name], arr)
            continue
        if key.startswith("final_layer_norm."):
            name = key.split(".")[-1]
            leaf_name, arr = _leaf(name, w, False)
            _set(tree, ["final_layer_norm", leaf_name], arr)
            continue
        raise KeyError(key)
    return tree


# ---------------------------------------------------------------------------
# Export: our pytree -> torch-style keys (for parity checks / interchange)
# ---------------------------------------------------------------------------

def flatten_tree(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, p))
        else:
            out[p] = np.asarray(v)
    return out
