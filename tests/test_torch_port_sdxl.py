"""PyTorch port, the SDXL layout: StableMTL over the SDXL base UNet
(`factory` preset "sdxl"), at its small test preset "sdxl_tiny" on the
CPU in float32 (one stage without attention, stacks of 2 and 3 transformer
blocks, the text-time added conditioning), against the benchmark's plain
reference `bench_port/reference/sdxl.py`; and the full preset's layout on
the meta device."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from bench_port.harness import program
from bench_port.harness.check import worst_rel_l2
from bench_port.harness.refcheck import plain_reference
from bench_port.tests.bench_helpers import tiny_config
from stablemtl_tpu_torch.factory import build_pipeline, model_configs
from stablemtl_tpu_torch.models.transformer import TaskAttentionBank
from stablemtl_tpu_torch.models.unet import (UNet2DConditionModel,
                                             task_feat_shapes)
from stablemtl_tpu_torch.utils import profiling
from torch_port_helpers import one_torch_thread  # noqa: F401

SEED = 2**31 + 19
HW = (32, 32)
# the published SDXL base UNet's parameters (diffusers' UNet2DConditionModel
# of unet/config.json), and what StableMTL's 12-channel conv_in adds: 320
# outputs x 8 more input channels x 3 x 3
SDXL_UNET_PARAMS = 2_567_463_684
CONV_IN_INFLATION = 320 * 8 * 9


def _config(multi_stream: bool) -> dict:
    cfg = tiny_config("stablemtl-ms-sdxl")
    cfg["program_config"]["trainer"]["multi_stream"] = multi_stream
    cfg["model"]["multi_stream"] = multi_stream
    return cfg


@functools.cache
def _built(multi_stream: bool):
    """(config, the port's pipeline with the seed's weights and
    conditioning, the two images): built once a variant."""
    cfg = _config(multi_stream)
    pipe = program.build_program(cfg, "cpu", HW)
    program.load_program(pipe, cfg, SEED, "cpu")
    images = torch.from_numpy(program.draw_images(SEED, 2, HW, "cpu"))
    return cfg, pipe, images


@functools.cache
def _maps(multi_stream: bool) -> torch.Tensor:
    _, pipe, images = _built(multi_stream)
    return pipe.infer_all_tasks(images, None)


@pytest.mark.parametrize("multi_stream", [True, False], ids=["ms", "s"])
def test_sdxl_maps_match_the_plain_reference(multi_stream):
    cfg, _, images = _built(multi_stream)
    out = _maps(multi_stream)
    want = plain_reference(cfg, SEED, "cpu").infer_all_tasks(images, None)
    assert out.shape == want.shape == (7, 2, *HW, 3)
    assert worst_rel_l2(out.numpy(), want.numpy()) < 1e-4
    # the maps are not flat: every task and image carries signal
    assert float(want.std(dim=(2, 3, 4)).min()) > 1e-2


@pytest.mark.parametrize("multi_stream", [True, False], ids=["ms", "s"])
def test_the_pooled_embedding_reaches_its_task(multi_stream):
    """A change to one task's pooled row changes that task's maps; in the
    single-stream variant no other task's (in multi-stream the child's
    taps and the banks carry it to the others)."""
    _, pipe, images = _built(multi_stream)
    base, task = _maps(multi_stream), 2
    pooled = pipe.text_pooled_table.clone()
    pooled[task] += 1.0
    out = dataclasses.replace(pipe, text_pooled_table=pooled
                              ).infer_all_tasks(images, None)
    gaps = [worst_rel_l2(out[t].numpy(), base[t].numpy()) for t in range(7)]
    assert gaps[task] > 1e-3
    if not multi_stream:
        assert max(g for t, g in enumerate(gaps) if t != task) == 0.0


def test_prefix_sharing_is_off_for_sdxl_and_on_for_sd2():
    _, sdxl, _ = _built(True)
    assert not sdxl._prefix_share_ok()
    assert not sdxl.unet.config.prefix_shareable
    sd2 = build_pipeline({"model": {"size_preset": "tiny"},
                          "trainer": {"multi_stream": True}}, device="cpu")
    assert sd2._prefix_share_ok() and sd2.text_pooled_table is None


def test_converted_tables_load_beside_each_other(tmp_path):
    """A directory of converted weights brings the pooled table beside
    the text table (`factory.load_pretrained`)."""
    r = np.random.RandomState(19)
    text = r.standard_normal((7, 5, 32)).astype(np.float32)
    pooled = r.standard_normal((7, 16)).astype(np.float32)
    np.save(tmp_path / "text_table.npy", text)
    np.save(tmp_path / "text_pooled_table.npy", pooled)
    pipe = build_pipeline({"model": {"size_preset": "sdxl_tiny",
                                     "pretrained_path": str(tmp_path)},
                           "trainer": {"multi_stream": True}}, device="cpu")
    assert np.array_equal(pipe.text_embed_table.numpy(), text)
    assert np.array_equal(pipe.text_pooled_table.numpy(), pooled)


def test_a_step_counts_its_banks_tables_and_task_bytes():
    """One all-task step of the tiny layout under the recorder: a bank
    span a transformer block (28), one K/V-table span, and the counter of
    the child taps' and the tables' bytes."""
    _, pipe, images = _built(True)
    cfg = pipe.unet.config
    with profiling.recording() as rec:
        pipe.infer_all_tasks(images, None)
    names = [s.name for s in rec.spans]
    assert names.count("stablemtl.bank") == cfg.num_attn_layers == 28
    assert names.count("stablemtl.infer.kv_tables") == 1
    # taps [7, B, N, C] f32, and a K and a V table of each
    per = sum(n * c for n, c in task_feat_shapes(cfg, 4, 4))
    assert rec.counters == {"stablemtl.infer.task_bytes":
                            3 * 7 * 2 * per * 4}


def test_the_full_sdxl_layout_on_the_meta_device():
    ucfg, ccfg, vcfg, text_dim = model_configs("sdxl", True, {})
    with torch.device("meta"):
        unet = UNet2DConditionModel(ucfg)
        child = UNet2DConditionModel(ccfg)
    banks = [m for m in unet.modules() if isinstance(m, TaskAttentionBank)]
    assert len(banks) == ucfg.num_attn_layers == 70
    shapes = task_feat_shapes(ucfg, 128, 128)
    assert shapes == [(4096, 640)] * 4 + [(1024, 1280)] * 60 \
        + [(4096, 640)] * 6
    params = dict(unet.named_parameters())
    assert params["add_embedding.linear_1.weight"].shape == (1280, 2816)
    assert params["down_blocks_2_attentions_1.transformer_blocks_9"
                  ".attn2.to_k.weight"].shape == (1280, 2048)
    assert params["mid_block_attentions_0.transformer_blocks_9.attn1"
                  ".to_q.weight"].shape == (1280, 1280)
    assert params["conv_in.weight"].shape == (320, 12, 3, 3)
    assert "down_blocks_0_attentions_0.proj_in.weight" not in params
    assert "up_blocks_2_attentions_0.proj_in.weight" not in params
    assert "up_blocks_1_attentions_2.transformer_blocks_1.norm1.weight" \
        in params
    assert text_dim == 2048 and vcfg.scaling_factor == 0.13025
    no_banks = sum(p.numel() for n, p in unet.named_parameters()
                   if ".task_attn." not in n)
    assert no_banks == sum(p.numel() for p in child.parameters()) \
        == SDXL_UNET_PARAMS + CONV_IN_INFLATION == 2_567_486_724
