"""StableMTL pipeline: VAE codec, task conditioning, single-step fused
all-task inference and the training-side forward (`unet_forward`).
Counterpart of `stablemtl_tpu/pipeline.py`.

- The 7 task prompts are embedded once into a [n_tasks, L, D] table;
  conditioning is a gather by task index.
- The timestep is the constant 999.
- Child features for ALL tasks come from ONE child-UNet forward with the
  task axis folded into the batch (B-major: rows b*T + t), and the
  task-independent UNet prefix is computed once per distinct input.
- The K main streams run as ONE main-UNet forward with the streams folded
  into the batch task-major (rows k*B + b): each stream gathers its own
  Q-bank weights, text embedding and -1e9 key bias, while the all-task K/V
  tables are shared across the streams.
- One main task (`unet_forward`, the training forward): the frozen child
  runs under no_grad over the auxiliary tasks only, and the main UNet's
  banks project their K/V from those features.

All tensors at the public methods are NHWC; images are in [-1, 1].
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import FIXED_TIMESTEP, TASKS, TWO_FRAME_TASKS
from .models import AutoencoderKL, UNet2DConditionModel
from .models.transformer import TaskAttentionBank
from .models.unet import task_kv_tables
from .utils.env import env_flag, reject_tpu_only_flags
from .utils.profiling import span

N_TASKS = len(TASKS)
TASK_INDEX = {name: i for i, name in enumerate(TASKS)}
# each task's text prompt: its name with '_' -> ' '
TASK_PROMPTS = tuple(t.replace("_", " ") for t in TASKS)
TWO_FRAME_TABLE = tuple(t in TWO_FRAME_TASKS for t in TASKS)
# representatives of the two UNet-input groups (prefix sharing)
_SINGLE_FRAME_IDX = TWO_FRAME_TABLE.index(False)
_TWO_FRAME_IDX = TWO_FRAME_TABLE.index(True)


def pack_gt_to_3ch(gt, task: str):
    """Task GT [..., H, W, C] -> the 3-channel image the VAE encodes; a
    numpy array (the loader's batches) or a tensor."""
    cat = (np.concatenate if isinstance(gt, np.ndarray)
           else lambda xs, axis: torch.cat(xs, dim=axis))
    c = gt.shape[-1]
    if task in ("depth", "shading"):
        if c != 1:
            raise ValueError(f"{task} GT must be 1-channel, got {c}")
        return cat([gt, gt, gt], axis=-1)
    if task == "optical_flow":
        if c != 2:
            raise ValueError(f"optical_flow GT must be 2-channel, got {c}")
        return cat([gt, gt[..., :1]], axis=-1)
    if task in ("normal", "semantic", "albedo", "scene_flow"):
        if c != 3:
            raise ValueError(f"{task} GT must be 3-channel, got {c}")
        return gt
    raise ValueError(f"Unknown output type: {task}")


def decode_3ch_to_task(img3, task: str):
    """Decoded 3-channel output [..., H, W, 3] -> task-shaped map."""
    if task in ("depth", "shading"):
        return img3.mean(dim=-1, keepdim=True)
    if task == "optical_flow":
        return img3[..., :2]
    if task in ("normal", "semantic", "rgb", "scene_flow", "albedo"):
        return img3
    raise ValueError(f"Unknown output type: {task}")


def semantic_rgb_to_class(img3, class_colors):
    """Decoded RGB [-1, 1] [..., H, W, 3] -> class ids by nearest palette
    color; class_colors [n_cls, 3] in 0..255."""
    colors = torch.as_tensor(class_colors, dtype=torch.float32,
                             device=img3.device) / 255.0 * 2.0 - 1.0
    d2 = ((img3.float()[..., None, :] - colors) ** 2).sum(-1)
    return d2.argmin(dim=-1)


def _task_tensor(task_idx, device):
    return torch.as_tensor(task_idx, dtype=torch.long, device=device)


def _task_list(task_indices) -> list:
    """Task indices (a sequence of ints, a numpy array or a tensor) as a
    Python list: the two-frame flags are read from it, never from a tensor,
    so a trace at fixed shapes reads no data."""
    if isinstance(task_indices, torch.Tensor):
        return task_indices.tolist()
    return [int(i) for i in task_indices]


@dataclasses.dataclass
class StableMTLPipeline:
    """Frozen codecs, the task-embedding table and the UNets.

    vae / unet / unet_child: modules (child is None in single-stream mode).
    text_embed_table: [n_tasks, L, text_dim].
    input_noise: 'deterministic' (zeros) | 'random' (needs a generator).
    encode_rgb_mode: 'duplicate' | 'zero' | 'avg' second-frame handling for
        single-frame tasks.
    exclude_main_task: drop the main task from each stream's key set.
    child_tap: the child's feature tap.
    decode_chunk: decode the [K*B] latents in chunks of this size (0 = one
        batched decode); caps the decode's activation memory.
    image_hw: the (H, W) the pipeline was built for; inputs must match.
    data_group: the data-parallel mesh (`parallel.mesh.Mesh`) while
        `data_parallel` holds it, else None.
    """

    vae: AutoencoderKL
    unet: UNet2DConditionModel
    text_embed_table: torch.Tensor
    unet_child: Optional[UNet2DConditionModel] = None
    input_noise: str = "deterministic"
    encode_rgb_mode: str = "duplicate"
    exclude_main_task: bool = True
    child_tap: str = "afterSelfAttn_residual"
    decode_chunk: int = 0
    image_hw: Optional[tuple] = None
    data_group: Optional[object] = None

    @property
    def is_multi_stream(self) -> bool:
        return self.unet_child is not None

    @property
    def device(self) -> torch.device:
        return self.text_embed_table.device

    # ---- encoding -------------------------------------------------------

    def encode_rgb(self, rgb_norm):
        """[-1, 1] NHWC image -> scaled latent mean."""
        return self.vae.encode(rgb_norm)

    def encode_rgb_pair(self, rgb_norm, rgb_next_norm):
        """Both frames in ONE VAE forward; rgb_next_norm of None (or the same
        object as rgb_norm) encodes once and reuses the latent."""
        if rgb_next_norm is None or rgb_next_norm is rgb_norm:
            lat = self.encode_rgb(rgb_norm)
            return lat, lat
        lat = self.encode_rgb(torch.cat([rgb_norm, rgb_next_norm]))
        return lat.chunk(2)

    def rgb_latent_for_task(self, lat, lat_next, task_idx):
        """Per-task conditioning latent [B, h, w, {4|8}]; for a 1-D task_idx
        the output gains a leading task axis."""
        task_idx = _task_tensor(task_idx, lat.device)
        two = torch.tensor(TWO_FRAME_TABLE, device=lat.device)[task_idx]
        two = two.reshape(two.shape + (1,) * lat.dim())
        if self.encode_rgb_mode == "avg":
            return torch.where(two, (lat + lat_next) / 2.0, lat)
        if self.encode_rgb_mode == "duplicate":
            second = lat
        elif self.encode_rgb_mode == "zero":
            second = torch.zeros_like(lat)
        else:
            raise ValueError(self.encode_rgb_mode)
        nxt = torch.where(two, lat_next, second)
        return torch.cat([lat.expand_as(nxt), nxt], dim=-1)

    def text_embed(self, task_idx, batch_size: int):
        """[B, L, D] text conditioning of one task."""
        emb = self.text_embed_table[task_idx]
        return emb[None].expand((batch_size,) + emb.shape)

    def noise_latent(self, lat, generator: Optional[torch.Generator] = None,
                     batch_dim: int = 0):
        """The third 4-channel group: zeros, or gaussian under 'random'.
        Under `data_parallel`, the noise is drawn at the global batch's
        shape and this rank's rows (along `batch_dim`) are kept, so the
        draws, and the generator's later ones, are the global batch's."""
        if self.input_noise == "deterministic":
            return torch.zeros_like(lat)
        if self.input_noise == "random":
            if generator is None:
                raise ValueError("input_noise='random' needs a generator")
            group = self.data_group
            if group is None or group.data == 1:
                return torch.randn(lat.shape, generator=generator,
                                   device=lat.device, dtype=lat.dtype)
            shape = list(lat.shape)
            b = shape[batch_dim]
            shape[batch_dim] = b * group.data
            return torch.randn(shape, generator=generator, device=lat.device,
                               dtype=lat.dtype).narrow(batch_dim,
                                                       group.rank * b, b)
        raise ValueError(f"Unknown input noise: {self.input_noise}")

    @contextlib.contextmanager
    def data_parallel(self, mesh):
        """Within it, the training forward runs one rank's rows of a global
        batch on `mesh` (a `parallel.mesh.Mesh`; None: nothing changes): the
        main UNet's task banks average their masking statistic over the
        ranks, and `noise_latent` draws at the global shape."""
        if mesh is None:
            yield
            return
        banks = [m for m in self.unet.modules()
                 if isinstance(m, TaskAttentionBank)]
        self.data_group = mesh
        for bank in banks:
            bank.data_group = mesh
        try:
            yield
        finally:
            self.data_group = None
            for bank in banks:
                bank.data_group = None

    # ---- shared UNet prefix -------------------------------------------

    def _prefix_share_ok(self) -> bool:
        """The conv_in -> first-self-attn prefix is task-independent only
        under deterministic noise, and needs an attention layer in down
        block 0. STABLEMTL_DISABLE_PREFIX_SHARE turns it off."""
        if self.input_noise != "deterministic":
            return False
        for m in (self.unet, self.unet_child):
            if m is not None and (len(m.config.block_out_channels) < 2
                                  or m.config.layers_per_block < 1):
                return False
        return not env_flag("STABLEMTL_DISABLE_PREFIX_SHARE")

    def _prefix_variants(self, unet, lat, lat_next):
        """The <= 2 distinct prefix states of `unet`: single-frame tasks and
        two-frame tasks; the same object twice when they coincide."""
        B = lat.shape[0]
        t = torch.full((B,), FIXED_TIMESTEP, dtype=torch.long,
                       device=lat.device)
        # the prefix never reads the text conditioning
        text0 = self.text_embed_table.new_zeros(
            (B,) + self.text_embed_table.shape[1:])

        def state_for(task_idx: int):
            rgb_lat = self.rgb_latent_for_task(lat, lat_next, task_idx)
            x = torch.cat([rgb_lat, torch.zeros_like(rgb_lat[..., :4])], -1)
            return unet(x, t, text0, prefix_only=True)

        single = state_for(_SINGLE_FRAME_IDX)
        if lat_next is lat and self.encode_rgb_mode in ("duplicate", "avg"):
            return single, single
        return single, state_for(_TWO_FRAME_IDX)

    @staticmethod
    def _prefix_stack(state_single, state_two, flags):
        """[B*K, ...] prefix state for K task slots folded B-major (rows
        b*K + k); flags: per-slot two-frame bools."""
        parts = [state_two if f else state_single for f in flags]

        def stack(key):
            leaves = [p[key] for p in parts]
            if isinstance(leaves[0], tuple):
                return tuple(torch.stack(xs, 1).flatten(0, 1)
                             for xs in zip(*leaves))
            return torch.stack(leaves, 1).flatten(0, 1)

        return {key: stack(key) for key in state_single}

    # ---- child features (multi-stream) ---------------------------------

    def _aux_tasks(self, main_idx) -> list:
        """The auxiliary tasks of main task `main_idx`: the canonical
        order, without the main task under exclude_main_task."""
        return [i for i in range(N_TASKS)
                if not (self.exclude_main_task and i == int(main_idx))]

    @torch.no_grad()
    def _child_taps(self, lat, lat_next, tasks: Sequence[int],
                    generator: Optional[torch.Generator] = None):
        """Frozen-child features of the T tasks `tasks` (Python ints) in one
        forward, the tasks folded B-major (rows b*T + t): 16 x
        [T, B, N, C]."""
        B, T = lat.shape[0], len(tasks)
        task_idx = _task_tensor(tasks, lat.device)
        text = self.text_embed_table[task_idx]
        text = text[None].expand((B,) + text.shape).flatten(0, 1)
        t = torch.full((B * T,), FIXED_TIMESTEP, dtype=torch.long,
                       device=lat.device)
        if self._prefix_share_ok():
            s1, s2 = self._prefix_variants(self.unet_child, lat, lat_next)
            flags = [TWO_FRAME_TABLE[i] for i in tasks]
            state = self._prefix_stack(s1, s2, flags)
            _, taps = self.unet_child(None, t, text, tap=self.child_tap,
                                      prefix_state=state)
        else:
            rgb_lat = self.rgb_latent_for_task(lat, lat_next, task_idx)
            # rgb_lat is [T, B, ...]: the batch is its second axis
            noise = self.noise_latent(rgb_lat[..., :4], generator,
                                      batch_dim=1)
            x = torch.cat([rgb_lat, noise], dim=-1).transpose(0, 1)
            _, taps = self.unet_child(x.flatten(0, 1), t, text,
                                      tap=self.child_tap)
        return [tp.unflatten(0, (B, T)).transpose(0, 1) for tp in taps]

    def child_taps_all_tasks(self, lat, lat_next,
                             generator: Optional[torch.Generator] = None):
        """Child features for ALL tasks in one forward: 16 x [T, B, N, C]."""
        if not self.is_multi_stream:
            return None
        return self._child_taps(lat, lat_next, list(range(N_TASKS)),
                                generator)

    def create_task_feats(self, lat, lat_next, main_idx,
                          generator: Optional[torch.Generator] = None):
        """Frozen-child features of main task `main_idx`'s auxiliary tasks,
        in one forward under no_grad: (aux_idx [T_aux], 16 x
        [T_aux, B, N, C]); (None, None) in single-stream mode."""
        if not self.is_multi_stream:
            return None, None
        tasks = self._aux_tasks(main_idx)
        return (torch.tensor(tasks, device=self.device),
                self._child_taps(lat, lat_next, tasks, generator))

    # ---- inference ------------------------------------------------------

    def main_streams(self, lat, lat_next, taps_all, task_indices,
                     generator: Optional[torch.Generator] = None,
                     with_task_attention: bool = True):
        """The K main-UNet streams in one forward, given the child taps.
        task_indices: [K]. Returns [K, B, h, w, 4] latent predictions."""
        tasks = _task_list(task_indices)
        task_indices = _task_tensor(tasks, lat.device)
        K, B = len(tasks), lat.shape[0]
        flags = [TWO_FRAME_TABLE[i] for i in tasks]
        text = self.text_embed_table[task_indices]            # [K, L, D]
        text = text[:, None].expand(K, B, *text.shape[1:]).flatten(0, 1)
        t = torch.full((K * B,), FIXED_TIMESTEP, dtype=torch.long,
                       device=lat.device)
        if self._prefix_share_ok():
            s1, s2 = self._prefix_variants(self.unet, lat, lat_next)
            parts = [s2 if f else s1 for f in flags]       # task-major
            state = {key: (tuple(torch.cat(xs) for xs in
                                 zip(*[p[key] for p in parts]))
                           if isinstance(s1[key], tuple)
                           else torch.cat([p[key] for p in parts]))
                     for key in s1}
            extra, x = dict(prefix_state=state), None
        else:
            rgb_lat = self.rgb_latent_for_task(lat, lat_next, task_indices)
            noise = self.noise_latent(rgb_lat[..., :4], generator)
            x = torch.cat([rgb_lat, noise], dim=-1).flatten(0, 1)
            extra = {}
        if self.is_multi_stream and with_task_attention:
            excluded = (torch.arange(N_TASKS, device=lat.device)[None]
                        == task_indices[:, None]) & self.exclude_main_task
            key_bias = torch.where(excluded, -1e9, 0.0)
            pred, _ = self.unet(x, t, text,
                                task_kv=task_kv_tables(self.unet, taps_all),
                                main_idx=task_indices,
                                task_key_bias=key_bias, **extra)
        else:
            pred, _ = self.unet(x, t, text, **extra)
        return pred.unflatten(0, (K, B))

    def unet_forward(self, lat, lat_next, task_idx,
                     generator: Optional[torch.Generator] = None,
                     train: bool = False):
        """Main-UNet single step for one task: conditioning latents -> x0
        latent prediction [B, h, w, 4]. Differentiable in the main UNet's
        parameters; the child runs under no_grad. `generator` feeds, in this
        order, the main noise group and the child's (input_noise 'random')
        and, with train, the banks' task masking."""
        B = lat.shape[0]
        rgb_lat = self.rgb_latent_for_task(lat, lat_next, task_idx)
        # concat order is load-bearing: [rgb_latent(8) | output_noise(4)]
        x = torch.cat([rgb_lat, self.noise_latent(rgb_lat[..., :4],
                                                  generator)], dim=-1)
        text = self.text_embed(task_idx, B)
        aux_idx, task_feats = self.create_task_feats(lat, lat_next, task_idx,
                                                     generator)
        t = torch.full((B,), FIXED_TIMESTEP, dtype=torch.long,
                       device=lat.device)
        main_idx = task_idx if self.is_multi_stream else None
        pred, _ = self.unet(x, t, text, task_feats=task_feats,
                            main_idx=main_idx, aux_idx=aux_idx, train=train,
                            generator=generator)
        return pred

    def decode_latent(self, latent):
        """Scaled latent -> 3-channel image (clipped by callers)."""
        return self.vae.decode(latent)

    def _check_input(self, rgb_norm):
        if self.image_hw is not None and \
                tuple(rgb_norm.shape[1:3]) != tuple(self.image_hw):
            raise ValueError(f"input is {tuple(rgb_norm.shape[1:3])}, the "
                             f"pipeline was built for {self.image_hw}")
        if rgb_norm.device.type == "cuda":
            reject_tpu_only_flags()

    @torch.inference_mode()
    def infer(self, rgb_norm, rgb_next_norm, task_idx,
              generator: Optional[torch.Generator] = None):
        """Single-task inference: images -> decoded 3-channel map [B, H, W,
        3] in [-1, 1]; the caller applies `decode_3ch_to_task`."""
        self._check_input(rgb_norm)
        lat, lat_next = self.encode_rgb_pair(rgb_norm, rgb_next_norm)
        pred = self.unet_forward(lat, lat_next, int(task_idx), generator)
        return self.decode_latent(pred).clamp(-1.0, 1.0)

    @torch.inference_mode()
    def infer_tasks(self, rgb_norm, rgb_next_norm, task_indices,
                    generator: Optional[torch.Generator] = None):
        """Fused inference for a subset of tasks: [K] indices ->
        [K, B, H, W, 3] decoded maps in [-1, 1]. The VAE encode and the child
        taps are computed once and shared by the K streams."""
        return self.infer_tasks_body(rgb_norm, rgb_next_norm, task_indices,
                                     generator)

    def infer_tasks_body(self, rgb_norm, rgb_next_norm, task_indices,
                         generator: Optional[torch.Generator] = None):
        """`infer_tasks` without its inference mode: the body that
        `serving.export_pipeline` traces under no_grad. Its four parts
        are the spans (`utils.profiling`, with device events)
        `stablemtl.infer.encode`, `.child`, `.main` and `.decode`."""
        self._check_input(rgb_norm)
        task_indices = _task_list(task_indices)
        dev = rgb_norm.device
        with span("stablemtl.infer.encode", device=dev):
            lat, lat_next = self.encode_rgb_pair(rgb_norm, rgb_next_norm)
        with span("stablemtl.infer.child", device=dev):
            taps_all = self.child_taps_all_tasks(lat, lat_next, generator)
        with span("stablemtl.infer.main", device=dev):
            preds = self.main_streams(lat, lat_next, taps_all, task_indices,
                                      generator=generator)
        flat = preds.flatten(0, 1)
        n, c = flat.shape[0], self.decode_chunk
        with span("stablemtl.infer.decode", device=dev):
            if c and c < n and n % c == 0:
                imgs = torch.cat([self.decode_latent(chunk)
                                  for chunk in flat.split(c)])
            else:
                imgs = self.decode_latent(flat)
        imgs = imgs.unflatten(0, (len(task_indices), lat.shape[0]))
        return imgs.clamp(-1.0, 1.0)

    def infer_all_tasks(self, rgb_norm, rgb_next_norm,
                        generator: Optional[torch.Generator] = None):
        """One input -> predictions for ALL tasks, [n_tasks, B, H, W, 3] in
        canonical task order."""
        return self.infer_tasks(rgb_norm, rgb_next_norm,
                                list(range(N_TASKS)), generator=generator)


@torch.no_grad()
def build_text_embed_table(clip_model, tokenizer=None,
                           prompts: Sequence[str] = TASK_PROMPTS):
    """Embed the task prompts once with the CLIP text tower -> [n_tasks, L,
    D] table on the tower's device, in its compute dtype. Under no_grad,
    not inference_mode: the training step feeds the table to the trainable
    UNet, and autograd cannot save an inference tensor."""
    from .models.clip import get_tokenizer, tokenize_batch

    if tokenizer is None:
        tokenizer = get_tokenizer()
    ids = tokenize_batch(tokenizer, list(prompts))
    device = clip_model.token_embedding.device
    return clip_model(torch.as_tensor(ids, dtype=torch.long, device=device))
