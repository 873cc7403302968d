"""The work of a cell's step, counted on the plain reference at the
cell's shapes on the meta device (no memory, no arithmetic): FLOPs from
`torch.utils.flop_counter.FlopCounterMode`, and the shape of every
attention call. Nothing of the program is read, so the count is the same
whatever implements the step."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.pipeline import N_TASKS, TWO_FRAME, Reference, build
from ..reference.precision import recording


def meta_reference(config: dict) -> Reference:
    mods = build(config, "meta")
    m = config["model"]
    text = torch.empty((N_TASKS, config["text_tokens"],
                        m["cross_attention_dim"]), device="meta")
    return Reference(vae=mods["vae"], unet=mods["unet"], text=text,
                     child=mods.get("child"))


def infer_work(config: dict, batch: int, hw, pair: bool = False) -> dict:
    """{"flops": of one all-task step at `batch` images of `hw`,
    "attention": [(bh, sq, sk, d), ...] its attention calls}."""
    ref = meta_reference(config)
    rgb = torch.empty((batch, *hw, 3), device="meta")
    calls = []
    with FlopCounterMode(display=False) as counter, recording(calls):
        ref.infer_all_tasks(rgb, rgb if pair else None, block=batch)
    return {"flops": int(counter.get_total_flops()), "attention": calls}


def train_work(config: dict, batch: int, hw, task: int = 0) -> dict:
    """{"flops", "attention"} of one training micro-step at `batch`
    images of `hw` and the main task `task`: the VAE encode of rgb,
    rgb_next and target and the child's taps of the 6 other tasks
    without gradients, the main UNet's forward and its backward to the
    parameters (no recompute). The banks' masking adds no product and is
    left out."""
    ref = meta_reference(config)
    ref.unet.requires_grad_(True)
    images = torch.empty((3 * batch, *hw, 3), device="meta")
    aux = [t for t in range(N_TASKS) if t != task]
    calls = []
    with FlopCounterMode(display=False) as counter, recording(calls):
        with torch.no_grad():
            lat, lat_next, gt = ref.vae.encode(images).chunk(3)
            zeros = torch.zeros_like(lat)
            xv = torch.stack([torch.cat([lat, lat, zeros], -1),
                              torch.cat([lat, lat_next, zeros], -1)])
            _, taps = ref.child(xv, [int(TWO_FRAME[a]) for a in aux],
                                ref.text[aux].repeat_interleave(batch, 0),
                                tap="afterSelfAttn_residual")
            taps = [t.unflatten(0, (len(aux), batch)) for t in taps]
        aux_t = torch.tensor(aux, device="meta")
        banks = ref.unet.banks()

        def bank_args(li):
            return dict(k_all=banks[li].kv(taps[li], aux_t, "k"),
                        v_all=banks[li].kv(taps[li], aux_t, "v"),
                        main_idx=torch.tensor([task], device="meta"),
                        key_bias=torch.zeros((1, len(aux)), device="meta"))

        pred, _ = ref.unet(xv[[int(TWO_FRAME[task])]], [0],
                           ref.text[[task]].repeat_interleave(batch, 0),
                           bank_args=bank_args)
        ((pred - gt) ** 2).sum().backward()
    return {"flops": int(counter.get_total_flops()), "attention": calls}
