"""PyTorch port, text conditioning: the CLIP text tower, both tokenizers,
and the task-embedding table, against the JAX package at tiny sizes in
f32 (inputs and parameters from numpy; nothing is jitted)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablemtl_tpu.models import clip as jclip
from stablemtl_tpu.pipeline import TASK_PROMPTS as JAX_PROMPTS
from stablemtl_tpu.pipeline import build_text_embed_table as jax_table
from stablemtl_tpu_torch.models import clip as tclip
from stablemtl_tpu_torch.pipeline import TASK_PROMPTS, build_text_embed_table
from torch_port_helpers import assert_close, load_port, random_params
from torch_port_helpers import one_torch_thread  # noqa: F401

ATOL = 2e-5
TEXTS = ["depth", "optical flow", "Scene_Flow 42!", "it's a car's",
         "<|startoftext|>normal<|endoftext|>", "a1b2 ..;; x_y", "  albedo "]


def _clip_pair(act: str, seed: int, vocab_size: int = 300):
    cfg = dict(hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=2, vocab_size=vocab_size, max_position_embeddings=12,
               hidden_act=act)
    jm = jclip.CLIPTextModel(jclip.tiny_clip_config(**cfg))
    ids = np.zeros((1, 6), np.int32)
    params = random_params(jm.init, ids, seed=seed)
    tm = load_port(tclip.CLIPTextModel(tclip.tiny_clip_config(**cfg)),
                   params)
    return jm, params, tm


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_model_matches_jax(act):
    jm, params, tm = _clip_pair(act, seed=21)
    ids = np.random.RandomState(3).randint(0, 300, (3, 7)).astype(np.int32)
    want = jm.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long())
    assert got.shape == (3, 7, 32) and got.dtype == torch.float32
    assert_close(got, want, atol=ATOL, rtol=ATOL)


@pytest.fixture
def vocab_dir(tmp_path):
    """A tiny byte-level BPE vocabulary: every byte symbol alone and with
    '</w>', plus a few merges."""
    byte_syms = list(tclip._bytes_to_unicode().values())
    merges = [("d", "e"), ("de", "p"), ("dep", "t"), ("dept", "h</w>"),
              ("f", "l"), ("fl", "o"), ("flo", "w</w>"), ("o", "p"),
              ("c", "a"), ("ca", "r</w>")]
    vocab = byte_syms + [s + "</w>" for s in byte_syms]
    vocab += ["".join(m) for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (tmp_path / "vocab.json").write_text(
        json.dumps({t: i for i, t in enumerate(dict.fromkeys(vocab))}))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    return tmp_path


def test_tokenizers_match_jax(vocab_dir):
    assert TASK_PROMPTS == JAX_PROMPTS
    assert tclip.PRETOKEN_PAT.pattern == jclip.PRETOKEN_PAT.pattern
    pairs = [(tclip.get_tokenizer(str(vocab_dir)),
              jclip.get_tokenizer(str(vocab_dir))),
             (tclip.get_tokenizer(None), jclip.get_tokenizer(None))]
    assert isinstance(pairs[0][0], tclip.CLIPTokenizer)
    assert isinstance(pairs[1][0], tclip.HashTokenizer)
    for ours, theirs in pairs:
        for text in TEXTS:
            assert ours.encode(text) == theirs.encode(text), text
        for prompts in (TASK_PROMPTS, TEXTS):
            got = tclip.tokenize_batch(ours, prompts)
            want = jclip.tokenize_batch(theirs, prompts)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        got = tclip.tokenize_batch(ours, TEXTS, max_length=6,
                                   padding="max_length")
        assert np.array_equal(got, jclip.tokenize_batch(
            theirs, TEXTS, max_length=6, padding="max_length"))


def test_text_embed_table_matches_jax(vocab_dir):
    # the hash tokenizer's BOS/EOS ids need SD2's vocabulary size
    jm, params, tm = _clip_pair("gelu", seed=22, vocab_size=49408)
    for vocab in (None, str(vocab_dir)):
        want = jax_table(jm, params, tokenizer=jclip.get_tokenizer(vocab))
        got = build_text_embed_table(tm, tokenizer=tclip.get_tokenizer(vocab))
        assert got.shape == want.shape and got.shape[0] == 7
        assert_close(got, want, atol=ATOL, rtol=ATOL)


def test_built_table_feeds_autograd():
    """build_pipeline's CLIP table is an ordinary tensor: the training step
    saves it for the backward of the trainable cross-attention."""
    from stablemtl_tpu_torch.factory import build_pipeline

    pipe = build_pipeline({"model": {"size_preset": "nano"},
                           "trainer": {"multi_stream": True}}, device="cpu",
                          trainable=True)
    table = pipe.text_embed_table
    assert table.shape == (7, 4, 32) and not table.is_inference()
    to_k = pipe.unet.down_blocks_0_attentions_0.transformer_blocks_0.attn2.to_k
    to_k(table).square().sum().backward()
    assert to_k.weight.grad is not None
