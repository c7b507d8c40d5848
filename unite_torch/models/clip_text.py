"""CLIP text tower and the zero-shot teacher of stage 3.

Counterpart of unite_tpu/models/clip_text.py: the class-name tables and
prompt, the causal text transformer (plain PyTorch: it runs once per class
list, and the JAX package has no kernel there), CLIP's byte-pair tokenizer
over a user-supplied merges file, text features from a ``.npy`` or from
text-tower weights and merges, and ``build_zero_shot_fn``, which turns the
teacher's image-encoder mode into ``videos -> [B, C]`` similarities.

Parameter names are the OpenAI CLIP model's text-tower names
(``token_embedding.weight``, ``transformer.resblocks.N.attn.in_proj_weight``,
``ln_final``, ``text_projection``), so a full CLIP state dict loads its text
tower unchanged.
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unite_torch.engines.pretrain_umt import resize_for_teacher
from unite_torch.engines.selftrain import clip_zero_shot_similarities
from unite_torch.models.clip import CLIPBlock
from unite_torch.models.layers import LayerNorm
from unite_torch.ops.attention import _merge_heads, _split_heads
from unite_torch.ops.normalize import normalize_videos

CLASS_NAMES = {
    8: ["drink", "jump", "pick", "pour", "push", "run", "walk", "wave"],
    12: ["climb", "fencing", "golf", "soccer", "pullup", "boxing", "pushup",
         "riding bike", "horse riding", "basketball", "archery", "walking"],
    23: ["archery", "baseball", "basketball", "biking", "bowling", "swimming",
         "diving", "fencing", "field hockey", "gymnastics", "golf",
         "horse riding", "kayaking", "rock climbing", "climbing rope",
         "skateboarding", "skiing", "sumo wrestling", "surfing", "tai chi",
         "tennis", "trampoline jumping", "volleyball"],
}

PROMPT = "a video of a person {}"


def get_class_names(nb_classes: int) -> List[str]:
    if nb_classes not in CLASS_NAMES:
        raise NotImplementedError(f"no class-name table for {nb_classes} classes")
    return CLASS_NAMES[nb_classes]


# ------------------------------------------------------------ text tower


class CLIPTextBlock(CLIPBlock):
    """The CLIP residual block with a causal mask: the attention is plain,
    fp32 scores and softmax with -1e30 above the diagonal, p cast to the
    working type for p.v."""

    def forward(self, x, causal):
        a = self.attn
        dt = a.dtype
        h = self.ln_1(x)
        qkv = F.linear(h.to(dt), a.in_proj_weight.to(dt),
                       a.in_proj_bias.to(dt))
        q, k, v = _split_heads(qkv, a.num_heads)
        scale = (x.shape[-1] // a.num_heads) ** -0.5
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
        probs = torch.softmax(scores.masked_fill(~causal, -1e30), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                           v.float()).to(x.dtype)
        x = x + a.out_proj(_merge_heads(out))
        return x + self.mlp(self.ln_2(x))


class CLIPTextTransformer(nn.Module):
    """OpenAI CLIP text encoder (the ViT-B/16 text tower by default)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, layers: int = 12, heads: int = 8,
                 embed_dim: int = 512, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        self.positional_embedding = nn.Parameter(
            torch.randn(context_length, width) * 0.01)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            CLIPTextBlock(width, heads, dtype) for _ in range(layers))
        self.ln_final = LayerNorm(width, 1e-5)
        self.text_projection = nn.Parameter(
            torch.randn(width, embed_dim) * width ** -0.5)

    def forward(self, tokens):
        """tokens int [B, context_length] -> fp32 [B, embed_dim], not
        L2-normed (the caller normalizes, as the reference does)."""
        x = (self.token_embedding.weight[tokens.long()].to(self.dtype)
             + self.positional_embedding.to(self.dtype))
        n = tokens.shape[-1]
        causal = torch.ones((n, n), dtype=torch.bool,
                            device=x.device).tril()
        for blk in self.transformer.resblocks:
            x = blk(x, causal)
        x = self.ln_final(x)
        # the end-of-text token has the highest id of each sequence
        feats = x[torch.arange(x.shape[0], device=x.device),
                  tokens.long().argmax(-1)]
        return feats.float() @ self.text_projection.to(feats.dtype).float()


# -------------------------------------------------------------- tokenizer


@lru_cache()
def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class SimpleTokenizer:
    """CLIP's lowercase BPE tokenizer (the merges file is an external
    artifact, like the weights). Needs the ``regex`` package."""

    def __init__(self, bpe_path: str):
        import regex as re_mod

        self.re = re_mod
        self.byte_encoder = bytes_to_unicode()
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.pat = self.re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            self.re.IGNORECASE,
        )

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text)).strip().lower()
        text = self.re.sub(r"\s+", " ", text)
        ids = []
        for token in self.re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def tokenize(self, texts: Sequence[str], context_length: int = 77
                 ) -> np.ndarray:
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [sot] + self.encode(text) + [eot]
            if len(ids) > context_length:
                ids = ids[: context_length - 1] + [eot]
            out[i, : len(ids)] = ids
        return out


# --------------------------------------------------------------- zero-shot


def _text_state(path: str) -> dict:
    """A torch checkpoint's state dict, unwrapped from "state_dict" or
    "model" where it is nested."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(state, dict) and isinstance(state.get(key), dict):
            state = state[key]
    return state


def compute_text_features(args) -> Optional[np.ndarray]:
    """[C, D] fp32 text features of the class prompts: a precomputed
    ``--clip_text_features`` .npy, or ``--clip_text_init`` weights with the
    ``--clip_bpe_path`` merges through the text tower on the CPU. None when
    neither is there."""
    feats_path = getattr(args, "clip_text_features", "") or ""
    if feats_path and os.path.exists(feats_path):
        return np.load(feats_path).astype(np.float32)
    text_init = getattr(args, "clip_text_init", "") or ""
    bpe_path = getattr(args, "clip_bpe_path", "") or ""
    if not (text_init and os.path.exists(text_init)
            and bpe_path and os.path.exists(bpe_path)):
        return None
    tokenizer = SimpleTokenizer(bpe_path)
    names = get_class_names(args.nb_classes)
    tokens = tokenizer.tokenize([PROMPT.format(c) for c in names])
    model = CLIPTextTransformer()
    state = _text_state(text_init)
    want = model.state_dict()
    missing = [k for k in want if k not in state]
    if missing:
        # a random text tower would hand stage 3 a meaningless teacher
        raise ValueError(
            f"--clip_text_init {text_init}: {len(missing)} text-tower params "
            f"absent from the checkpoint (e.g. {missing[:3]}); not a full "
            "CLIP state_dict?")
    # strict: a geometry mismatch (an L/14 text tower) raises here
    model.load_state_dict({k: state[k] for k in want}, strict=True)
    with torch.no_grad():
        feats = model(torch.from_numpy(tokens))
    return feats.numpy().astype(np.float32)


def build_zero_shot_fn(args, teacher: nn.Module, teacher_params=None):
    """``call(videos, tp=teacher_params) -> [B, nb_classes]`` softmaxed
    similarities averaged over frames (utils.py clip_infer), from the
    teacher's ``cls_features`` mode over the normalized clip resized to
    ``args.clip_input_resolution``; None when there are no text features.
    ``tp``, a state dict of the teacher's parameters, runs the teacher
    with them (``torch.func.functional_call``); None runs its own."""
    text_features = compute_text_features(args)
    if text_features is None:
        print("zero-shot teacher: no text features available "
              "(pass --clip_text_features or --clip_text_init + "
              "--clip_bpe_path)")
        return None
    tf = torch.from_numpy(
        text_features / np.linalg.norm(text_features, axis=-1, keepdims=True))
    res = getattr(args, "clip_input_resolution", None)
    on_device = {}  # the normed text features, moved once per device

    @torch.no_grad()
    def call(videos, tp=teacher_params):
        dev = next(teacher.parameters()).device
        x = normalize_videos(videos.to(dev, non_blocking=True))
        if res:
            x = resize_for_teacher(x, int(res))
        if tp is None:
            feats = teacher(x, cls_features=True)
        else:
            feats = torch.func.functional_call(teacher, tp, (x,),
                                               {"cls_features": True})
        feats = feats.reshape(videos.shape[0], -1, feats.shape[-1])
        if dev not in on_device:
            on_device[dev] = tf.to(dev)
        return clip_zero_shot_similarities(feats, on_device[dev])

    return call
