"""CLIP text encoder (the Stable Diffusion 2 text tower) and its
tokenizers, counterpart of `stablemtl_tpu/models/clip.py`.

The 7 task prompts are fixed and the encoder is frozen, so the tower runs
once at setup (`pipeline.build_text_embed_table`) and never in a step.
SD2's text config: vocab 49408, width 1024, 23 layers, 16 heads, MLP 4096,
exact gelu, causal mask, final LayerNorm; the output is the last hidden
state. Parameter names are the Flax paths (`token_embedding`,
`position_embedding`, `layers_{i}_q_proj.weight`, ...), so
`models.convert.state_dict_from_flax` maps a Flax tree onto this module.

Tokenization: the byte-level BPE `CLIPTokenizer` (vocab.json and
merges.txt), or a deterministic `HashTokenizer` where the vocab files are
absent.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import hashlib
import json
import os
import re
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import plain_attention
from .layers import Dense, LayerNorm

BOS_ID = 49406
EOS_ID = 49407

# CLIP's pre-tokenization pattern (openai simple_tokenizer):
#   <specials>|contractions|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+
# letters group, digits split one by one, everything else (with '_') groups
# in runs. Python's re has no \p classes: [^\W\d_]+ is a run of unicode
# letters, \d one digit, (?:[^\s\w]|_)+ a run of other non-space
# characters.
PRETOKEN_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 23
    num_heads: int = 16
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"  # exact erf gelu; or "quick_gelu"
    dtype: str = "float32"

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)


def tiny_clip_config(**kw) -> CLIPTextConfig:
    base = dict(hidden_size=32, intermediate_size=64, num_layers=2,
                num_heads=2)
    base.update(kw)
    return CLIPTextConfig(**base)


class CLIPTextModel(nn.Module):
    """Token ids [B, L] -> last hidden state [B, L, hidden] in the compute
    dtype. LayerNorms compute in f32; Dense layers and attention products
    in the compute dtype with f32 logits and softmax."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        d = config.hidden_size
        self.token_embedding = nn.Parameter(
            torch.empty(config.vocab_size, d))
        self.position_embedding = nn.Parameter(
            torch.empty(config.max_position_embeddings, d))
        eps = config.layer_norm_eps
        for i in range(config.num_layers):
            pre = f"layers_{i}"
            setattr(self, f"{pre}_layer_norm1", LayerNorm(d, eps=eps))
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                setattr(self, f"{pre}_{name}", Dense(d, d))
            setattr(self, f"{pre}_layer_norm2", LayerNorm(d, eps=eps))
            setattr(self, f"{pre}_fc1", Dense(d, config.intermediate_size))
            setattr(self, f"{pre}_fc2", Dense(config.intermediate_size, d))
        self.final_layer_norm = LayerNorm(d, eps=eps)

    def _act(self, x):
        if self.config.hidden_act == "gelu":
            return F.gelu(x)
        return x * torch.sigmoid(1.702 * x)  # quick_gelu

    def forward(self, input_ids):
        cfg = self.config
        dtype = cfg.torch_dtype
        b, length = input_ids.shape
        heads = cfg.num_heads
        head_dim = cfg.hidden_size // heads
        h = (self.token_embedding[input_ids]
             + self.position_embedding[None, :length]).to(dtype)
        causal = torch.triu(torch.full((length, length), float("-inf"),
                                       device=h.device), diagonal=1)
        for i in range(cfg.num_layers):
            def sub(name, i=i):
                return getattr(self, f"layers_{i}_{name}")

            r = h
            h = sub("layer_norm1")(h).to(dtype)
            q, k, v = (sub(n)(h).reshape(b, length, heads, head_dim)
                       for n in ("q_proj", "k_proj", "v_proj"))
            attn = plain_attention(q, k, v, causal).reshape(
                b, length, cfg.hidden_size)
            h = r + sub("out_proj")(attn)
            r = h
            h = sub("layer_norm2")(h).to(dtype)
            h = r + sub("fc2")(self._act(sub("fc1")(h)))
        return self.final_layer_norm(h).to(dtype)


# ---------------------------------------------------------------------------
# Tokenization
# ---------------------------------------------------------------------------

@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2/CLIP reversible byte<->unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPTokenizer:
    """Byte-level BPE tokenizer (CLIP flavor: every word ends with '</w>')."""

    def __init__(self, vocab_path: str, merges_path: str):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            merges = f.read().split("\n")
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [tuple(m.split()) for m in merges
                  if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.cache = {}
        self.bos_id = self.encoder.get("<|startoftext|>", BOS_ID)
        self.eos_id = self.encoder.get("<|endoftext|>", EOS_ID)

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e10))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and \
                        word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        specials = {"<|startoftext|>": self.bos_id,
                    "<|endoftext|>": self.eos_id}
        ids = []
        for token in PRETOKEN_PAT.findall(text.lower().strip()):
            if token in specials:  # atomic: never byte-BPE'd
                ids.append(specials[token])
                continue
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token))
        return ids


class HashTokenizer:
    """Deterministic stand-in when the CLIP vocab files are absent: each
    whitespace word maps to a stable id in [1000, vocab). Distinct and
    reproducible prompts, but not the ids pretrained CLIP weights expect."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.bos_id = BOS_ID
        self.eos_id = EOS_ID

    def encode(self, text: str) -> List[int]:
        out = []
        for word in text.lower().strip().split():
            h = int(hashlib.sha256(word.encode()).hexdigest(), 16)
            out.append(1000 + h % (self.vocab_size - 2000))
        return out


def get_tokenizer(vocab_dir: str | None = None):
    """CLIPTokenizer if vocab files exist under vocab_dir, else
    HashTokenizer."""
    if vocab_dir:
        vp = os.path.join(vocab_dir, "vocab.json")
        mp = os.path.join(vocab_dir, "merges.txt")
        if os.path.exists(vp) and os.path.exists(mp):
            return CLIPTokenizer(vp, mp)
    return HashTokenizer()


def tokenize_batch(tokenizer, prompts: Sequence[str], max_length: int = 77,
                   padding: str = "longest") -> np.ndarray:
    """BOS + tokens + EOS, padded with EOS to the longest sequence (or to
    max_length): int32 [n_prompts, L]."""
    seqs = []
    for p in prompts:
        ids = [tokenizer.bos_id] + tokenizer.encode(p)[: max_length - 2] + \
            [tokenizer.eos_id]
        seqs.append(ids)
    length = max(len(s) for s in seqs) if padding == "longest" \
        else max_length
    out = np.full((len(seqs), length), tokenizer.eos_id, dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out
