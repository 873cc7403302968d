"""PyTorch port, weight ingestion without JAX: the port's converters
(`models/torch_convert.py`) against the JAX package's on the same synthetic
state dicts, bit for bit; the synthetic SD2 writer
(`tools/torch_make_synthetic_sd2.py`) inverting them at the full preset's
structure; `utils/safetensors_io` against the `safetensors` package; and
`cli/convert_sd2.py` end to end on a tiny diffusers directory, its npz trees
against the JAX converters' output, its text table against the JAX
package's, and the result loaded by `factory.build_pipeline`. Nothing is
jitted; no full-size tensor is made (the full preset's structure travels as
zero-stride one-byte arrays into meta-device modules).
"""

import importlib.util
import json
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablemtl_tpu.models import clip as jclip
from stablemtl_tpu.models import torch_convert as jconvert
from stablemtl_tpu.models.unet import inflate_conv_in as jax_inflate
from stablemtl_tpu.pipeline import build_text_embed_table as jax_table
from stablemtl_tpu_torch import TASKS
from stablemtl_tpu_torch.cli import convert_sd2
from stablemtl_tpu_torch.factory import build_pipeline
from stablemtl_tpu_torch.models import torch_convert as tconvert
from stablemtl_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel,
                                             tiny_clip_config)
from stablemtl_tpu_torch.models.convert import state_dict_from_flax
from stablemtl_tpu_torch.models.unet import (UNet2DConditionModel,
                                             UNetConfig, inflate_conv_in,
                                             tiny_unet_config)
from stablemtl_tpu_torch.models.vae import (AutoencoderKL, VAEConfig,
                                            tiny_vae_config)
from stablemtl_tpu_torch.utils import safetensors_io
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_make_synthetic_sd2",
    os.path.join(REPO, "tools", "torch_make_synthetic_sd2.py"))
synth = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(synth)

# a CLIP tower for the tiny presets (text dim 32) whose vocabulary holds
# the synthetic BPE tokenizer's ids and whose positions the prompts
CLIP = dict(vocab_size=1000, max_position_embeddings=77)
NANO = dict(block_out_channels=(32, 64), attention_heads=(2, 2))


def _state_dict(module_cls, cfg, entries, seed):
    """(torch-layout state dict of numpy arrays, the port's values) of a
    module drawn as the synthetic writer draws it."""
    with torch.device("meta"):
        module = module_cls(cfg)
    values = synth.draw(module, torch.Generator().manual_seed(seed), "cpu")
    sd = {k: v.numpy() for name, t in values.items()
          for k, v in entries(name, t)}
    return sd, values


def _legacy_vae(sd):
    """The older diffusers VAE attention naming: query/key/value/proj_attn
    as 1x1 convolutions."""
    out = {}
    for k, v in sd.items():
        for new, old in ((".to_q.", ".query."), (".to_k.", ".key."),
                         (".to_v.", ".value."), (".to_out.0.",
                                                 ".proj_attn.")):
            if new in k:
                k = k.replace(new, old)
                v = v[:, :, None, None] if v.ndim == 2 else v
        out[k] = v
    return out


def _without_task(sd, task):
    return {k: v for k, v in sd.items() if f".{task}." not in k}


CONVERTER_CASES = {
    "unet_sd2": lambda: (_state_dict(
        UNet2DConditionModel, tiny_unet_config(in_channels=4),
        synth.model_entries, 1)[0], "convert_unet_state_dict"),
    "unet_reference_banks": lambda: (_state_dict(
        UNet2DConditionModel, tiny_unet_config(
            **NANO, use_task_attention=True), synth.model_entries, 2)[0],
        "convert_unet_state_dict"),
    # a reference checkpoint trained without one task: its banks are
    # filled (LayerNorm scales 1, the rest 0) with a warning
    "unet_reference_banks_task_missing": lambda: (_without_task(
        _state_dict(UNet2DConditionModel, tiny_unet_config(
            **NANO, use_task_attention=True), synth.model_entries, 3)[0],
        "albedo"), "convert_unet_state_dict"),
    "vae": lambda: (_state_dict(AutoencoderKL, tiny_vae_config(),
                                synth.model_entries, 4)[0],
                    "convert_vae_state_dict"),
    "vae_legacy_attention": lambda: (_legacy_vae(_state_dict(
        AutoencoderKL, tiny_vae_config(), synth.model_entries, 5)[0]),
        "convert_vae_state_dict"),
    "clip_text": lambda: (dict(_state_dict(
        CLIPTextModel, tiny_clip_config(**CLIP), synth.clip_entries, 6)[0],
        **{"text_model.embeddings.position_ids": np.arange(77)[None]}),
        "convert_clip_text_state_dict"),
}


@pytest.mark.parametrize("case", list(CONVERTER_CASES))
def test_converters_match_jax(case, capfd):
    """Leaf for leaf, the same keys, dtypes and values as the JAX package's
    converter on the same state dict, including the per-task banks stacked
    in the task order."""
    sd, fn = CONVERTER_CASES[case]()
    got = tconvert.flatten_tree(getattr(tconvert, fn)(sd))
    want = jconvert.flatten_tree(getattr(jconvert, fn)(sd))
    assert set(got) == set(want) and len(got) > 30
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    if "banks" in case:
        assert any("task_to_q_net_6_kernel" in k for k in got)
        stacked = [v for k, v in got.items() if k.endswith(
            "task_norm_k_scale")]
        assert stacked and all(v.shape[0] == len(TASKS) for v in stacked)
    if "missing" in case:
        assert "no 'task_to_k' weights for tasks ['albedo']" in \
            capfd.readouterr().err
        bank = [v for k, v in got.items() if k.endswith(
            "task_norm_k_scale")][0]
        assert (bank[TASKS.index("albedo")] == 1).all()
    assert tconvert.TASKS == TASKS


FULL_CASES = {
    "unet_sd2": (UNet2DConditionModel, UNetConfig(in_channels=4),
                 synth.model_entries, "convert_unet_state_dict"),
    "unet_multistream": (UNet2DConditionModel, UNetConfig(
        use_task_attention=True), synth.model_entries,
        "convert_unet_state_dict"),
    "vae": (AutoencoderKL, VAEConfig(), synth.model_entries,
            "convert_vae_state_dict"),
    "text_encoder": (CLIPTextModel, CLIPTextConfig(), synth.clip_entries,
                     "convert_clip_text_state_dict"),
}


@pytest.mark.parametrize("case", list(FULL_CASES))
def test_full_preset_structure_round_trips(case):
    """At SD2's full widths: the synthetic writer's keys for every
    parameter of a meta-device module, through the port's converter and
    state_dict_from_flax, load into the module with strict=True. The
    values are zero-stride one-byte arrays (shapes only)."""
    cls, cfg, entries, fn = FULL_CASES[case]
    with torch.device("meta"):
        module = cls(cfg)
    sd = {k: np.broadcast_to(np.uint8(0), tuple(t.shape))
          for name, p in module.named_parameters()
          for k, t in entries(name, p)}
    port = state_dict_from_flax(getattr(tconvert, fn)(sd))
    with pytest.warns(UserWarning, match="meta"):  # copies into meta: no-op
        module.load_state_dict(port, strict=True)
    n = len(dict(module.named_parameters()))
    assert len(port) == n
    assert n == {"unet_sd2": 686, "unet_multistream": 1070, "vae": 248,
                 "text_encoder": 372}[case]
    if case == "unet_multistream":
        # per layer, 24 stacked bank leaves are 22 x 7 per-task keys and
        # the 2 of to_out_task; the rest are SD2's 686
        assert n - 16 * 24 == 686
        assert len(sd) == 686 + 16 * (22 * 7 + 2)


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"f32": torch.randn(3, 5, generator=g),
            "f16": torch.randn(7, generator=g).half(),
            "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
            "i64": torch.arange(-3, 6),
            "i32": torch.arange(11, dtype=torch.int32).reshape(1, 11),
            "empty": torch.empty(0, 4),
            "scalar": torch.tensor(2.5)}


@pytest.mark.parametrize("direction", ["port_writes", "package_writes"])
def test_safetensors_io_matches_the_package(tmp_path, direction):
    """Every dtype, a 0-element and a 0-d tensor, and __metadata__, written
    by one and read by the other (and by itself)."""
    from safetensors import safe_open
    from safetensors.torch import load_file, save_file

    tensors, meta = _tensors(), {"format": "pt", "note": "synthetic"}
    path = str(tmp_path / "x.safetensors")
    if direction == "port_writes":
        n = safetensors_io.save_file(tensors, path, meta)
        assert n == os.path.getsize(path)
    else:
        save_file(tensors, path, metadata=meta)
    for read in (load_file, safetensors_io.load_file):
        got = read(path)
        assert set(got) == set(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
            assert torch.equal(got[k], t), k
    with safe_open(path, "pt") as f:
        assert f.metadata() == meta
    assert safetensors_io.read_header(path)[1] == meta


def test_safetensors_io_reads_unaligned_offsets(tmp_path):
    """A tensor whose offset is not a multiple of its element size (the
    format allows it) is read through a copy; a span that does not fit its
    shape raises."""
    a = torch.tensor([1.0, -2.0, 3.0], dtype=torch.float16)  # 6 bytes
    b = torch.tensor([[0.5, 7.0]], dtype=torch.float32)      # at offset 6
    header = {"a": {"dtype": "F16", "shape": [3], "data_offsets": [0, 6]},
              "b": {"dtype": "F32", "shape": [1, 2],
                    "data_offsets": [6, 14]}}
    text = json.dumps(header).encode()
    path = tmp_path / "u.safetensors"
    path.write_bytes(struct.pack("<Q", len(text)) + text
                     + a.numpy().tobytes() + b.numpy().tobytes())
    got = safetensors_io.load_file(str(path))
    assert torch.equal(got["a"], a) and torch.equal(got["b"], b)
    header["b"]["shape"] = [1, 3]
    text = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(text)) + text
                     + a.numpy().tobytes() + b.numpy().tobytes())
    with pytest.raises(ValueError, match="spans 8 bytes"):
        safetensors_io.load_file(str(path))


# ---------------------------------------------------------------------------
# cli.convert_sd2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sd2_dir(tmp_path_factory):
    """A tiny diffusers directory (UNet as .safetensors, VAE and text
    encoder as .bin, a BPE tokenizer) and a reference-style multi-stream
    .pth of the tiny preset's main UNet."""
    root = tmp_path_factory.mktemp("sd2")
    made = synth.make_synthetic_sd2(
        str(root / "sd2"), seed=7, unet_safetensors=True,
        multistream_pth=str(root / "reference_unet.pth"), device="cpu",
        unet_config=tiny_unet_config(), vae_config=tiny_vae_config(),
        clip_config=tiny_clip_config(**CLIP), check_values=True,
        log=lambda *_: None)
    return root, made


def _jax_reference(src, unet_src):
    """The JAX converters' trees of the same files."""
    load = convert_sd2.load_state_dict
    return ({"params": jconvert.convert_vae_state_dict(load(
                os.path.join(src, "vae", "diffusion_pytorch_model.bin")))},
            {"params": jconvert.convert_unet_state_dict(load(unet_src))},
            {"params": jconvert.convert_clip_text_state_dict(load(
                os.path.join(src, "text_encoder", "pytorch_model.bin")))})


@pytest.mark.parametrize("route", ["sd2_safetensors", "sd2_bin_inflated",
                                   "reference_pth"])
def test_convert_sd2_cli_end_to_end(sd2_dir, tmp_path, monkeypatch, route):
    """`cli.convert_sd2.main` (the tiny CLIP config in place of SD2's):
    unet.npz and vae.npz hold the JAX converters' trees of the same files
    (keys under 'params', arrays equal), text_table.npy is within 1e-5 of
    the JAX package's table from the same tiny CLIP tree and tokenizer, and
    build_pipeline(pretrained_path=...) loads every parameter bit-equal to
    its synthetic source: SD2's 4-channel conv_in inflated to 12 and scaled
    1/3 (by the loader, or by --inflate_conv_in 3), the reference
    checkpoint's banks stacked. Without --device cpu it asks for the card
    and raises here, before writing anything."""
    root, made = sd2_dir
    src = str(root / "sd2")
    if route == "sd2_bin_inflated":  # the UNet as .bin: the writer's other
        src = str(tmp_path / "sd2")  # format, beside the same other files
        os.makedirs(os.path.join(src, "unet"))
        for sub in ("vae", "text_encoder", "tokenizer"):
            os.symlink(os.path.join(root, "sd2", sub),
                       os.path.join(src, sub))
        torch.save(safetensors_io.load_file(os.path.join(
            root, "sd2", "unet", "diffusion_pytorch_model.safetensors")),
            os.path.join(src, "unet", "diffusion_pytorch_model.bin"))
    out = str(tmp_path / "out")
    argv = ["--sd2_dir", src, "--out_dir", out]
    unet_src = convert_sd2.find_weights(os.path.join(src, "unet"))
    if route == "reference_pth":
        unet_src = str(root / "reference_unet.pth")
        argv += ["--unet_pth", unet_src]
    if route == "sd2_bin_inflated":
        argv += ["--inflate_conv_in", "3"]
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_sd2.main(argv)
    assert not os.path.exists(out)
    monkeypatch.setattr(convert_sd2, "CLIPTextConfig",
                        lambda: tiny_clip_config(**CLIP))
    report = convert_sd2.main(argv + ["--device", "cpu"])
    assert set(report) == {"vae.npz", "unet.npz", "text_table.npy"}
    vae_t, unet_t, clip_t = _jax_reference(src, unet_src)
    if route == "sd2_bin_inflated":
        conv = unet_t["params"]["conv_in"]
        conv["kernel"] = np.asarray(jax_inflate(
            {"kernel": jnp.asarray(conv["kernel"]), "bias": None},
            repeat=3)["kernel"])
    for name, tree in (("vae.npz", vae_t), ("unet.npz", unet_t)):
        want = {k.replace(".", "/"): v for k, v in
                jconvert.flatten_tree(tree).items()}
        with np.load(os.path.join(out, name)) as got:
            assert set(got.files) == set(want)
            assert all(k.startswith("params/") for k in got.files)
            for k, w in want.items():
                assert np.array_equal(got[k], w), (name, k)

    jm = jclip.CLIPTextModel(jclip.tiny_clip_config(**CLIP))
    want = jax_table(jm, clip_t, tokenizer=jclip.get_tokenizer(
        os.path.join(src, "tokenizer")))
    got = np.load(os.path.join(out, "text_table.npy"))
    assert got.shape == want.shape == (7, got.shape[1], 32)
    assert isinstance(jclip.get_tokenizer(os.path.join(src, "tokenizer")),
                      jclip.CLIPTokenizer)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)

    pipe = build_pipeline({"model": {"size_preset": "tiny",
                                     "pretrained_path": out},
                           "trainer": {"multi_stream": True}}, device="cpu")
    assert np.array_equal(pipe.text_embed_table.numpy(), got)
    sd2 = dict(made["unet"])
    sd2["conv_in.weight"] = inflate_conv_in(sd2["conv_in.weight"], 3)
    main = made["unet_ms"] if route == "reference_pth" else sd2
    assert main["conv_in.weight"].shape[1] == 12
    for module, want, what in ((pipe.vae, made["vae"], "vae"),
                               (pipe.unet, main, "unet"),
                               (pipe.unet_child, main, "child")):
        state = module.state_dict()
        # the task banks are not in SD2: they keep their init
        expect = (set(state) if what == "unet" and route == "reference_pth"
                  else {n for n in state if "task_attn" not in n})
        assert set(want) & set(state) == expect, what
        for name in expect:
            assert torch.equal(state[name], want[name]), (what, name)


def test_convert_sd2_finds_weights_and_unwraps_state_dict(tmp_path):
    """The weight files are looked for in the JAX tool's order, and a
    checkpoint holding {'state_dict': ...} is unwrapped; bf16 is widened to
    f32 (numpy has no bf16)."""
    d = tmp_path / "unet"
    d.mkdir()
    with pytest.raises(FileNotFoundError):
        convert_sd2.find_weights(str(d))
    w = {"a.weight": torch.randn(3, 2).bfloat16(), "b": torch.arange(3)}
    torch.save({"state_dict": w}, d / "pytorch_model.bin")
    assert convert_sd2.find_weights(str(d)).endswith("pytorch_model.bin")
    safetensors_io.save_file(w, str(d / "diffusion_pytorch_model"
                                    ".safetensors"))
    path = convert_sd2.find_weights(str(d))
    assert path.endswith(".safetensors")
    for p in (path, str(d / "pytorch_model.bin")):
        got = convert_sd2.load_state_dict(p)
        assert got["a.weight"].dtype == np.float32
        assert np.array_equal(got["a.weight"], w["a.weight"].float().numpy())
        assert np.array_equal(got["b"], np.arange(3))
