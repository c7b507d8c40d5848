"""Carry weights from a flax param tree (nested dict of numpy arrays) into
the port's ``state_dict`` names.

Students (ViTs, adaptation and UMT students, VideoMAE) take the keys of
unite_tpu/utils/torch_export.py (``blocks_N`` -> ``blocks.N``, LayerNorm
``scale`` -> ``weight``, Dense ``kernel`` [in, out] -> ``weight``
[out, in], the patch-embed kernel [kt*kh*kw*C, D] -> Conv3d ``weight``
[D, C, kt, kh, kw]); an adaptation student's ``cls_token`` and learnable
``pos_embed`` keep their names (``encoder.cls_token``), as does VideoMAE's
``mask_token``; a leaf outside that layout raises. CLIP takes the OpenAI
visual tower's keys, the inverse of
unite_tpu/utils/torch_import.py::clip_key_to_flax, and the text tower's
(``token_embedding.weight``, ``ln_final``, ``attn.in_proj_*``), the
inverse of unite_tpu/models/clip_text.py::text_state_to_flax_params. An
int8 CLIP tree (unite_tpu ``quantize_clip_params``) maps its dense layers'
``kernel_q`` [in, out] int8 to the int8 ``weight`` [out, in] and
``kernel_scale`` to ``weight_scale`` (``in_proj_weight`` and
``in_proj_weight_scale`` for the packed qkv), the keys of
``CLIPVisionTransformer(quantize=True)``; int8 leaves keep their type.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_INDEXED = re.compile(r"^(blocks|clip_decoder|resblocks)_(\d+)$")


def flatten(tree: dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten(v, prefix + (k,)))
        else:
            arr = np.asarray(v)
            flat[prefix + (k,)] = (arr if arr.dtype == np.int8
                                   else np.asarray(arr, np.float32))
    return flat


def conv3d_weight(kernel: np.ndarray, patch_size: int,
                  in_chans: int = 3) -> np.ndarray:
    """[kt*kh*kw*C, D] matmul kernel -> [D, C, kt, kh, kw] Conv3d weight."""
    k, d = kernel.shape
    kt = k // (patch_size * patch_size * in_chans)
    if kt * patch_size * patch_size * in_chans != k:
        raise ValueError(f"patch-embed kernel rows {k} not divisible by "
                         f"{patch_size}x{patch_size}x{in_chans}")
    w = kernel.reshape(kt, patch_size, patch_size, in_chans, d)
    return w.transpose(4, 3, 0, 1, 2)


# the reference students' module and leaf names: ViTs, adaptation and UMT
# students (``encoder``, ``clip_decoder.N``), VideoMAE (``decoder``,
# ``encoder_to_decoder``, ``mask_token``)
STUDENT_MODULES = frozenset((
    "encoder", "decoder", "encoder_to_decoder", "patch_embed", "proj",
    "blocks", "norm1", "norm2", "attn", "qkv", "mlp", "fc1", "fc2", "norm",
    "fc_norm", "head", "clip_decoder"))
STUDENT_LEAVES = frozenset((
    "weight", "bias", "cls_token", "pos_embed", "q_bias", "v_bias",
    "gamma_1", "gamma_2", "mask_token"))
_FLAX_LEAVES = {"scale": "weight", "kernel": "weight"}


def student_key_ok(key: str) -> bool:
    """Whether a dotted key is a reference student's parameter name: known
    module names (an index only after ``blocks`` or ``clip_decoder``) and a
    known leaf."""
    parts = key.split(".")
    if parts[-1] not in STUDENT_LEAVES:
        return False
    prev = None
    for p in parts[:-1]:
        if p.isdigit():
            if prev not in ("blocks", "clip_decoder"):
                return False
        elif p not in STUDENT_MODULES:
            return False
        prev = p
    return True


def student_key(path: Tuple[str, ...], arr: np.ndarray, patch_size: int,
                in_chans: int = 3) -> Tuple[str, np.ndarray]:
    """A student's flax (path, array) -> (port key, array); a path outside
    the reference layout raises."""
    parts = []
    for p in path:
        m = _INDEXED.match(p)
        parts.extend(m.groups() if m else (p,))
    leaf = parts[-1]
    if not student_key_ok(".".join(parts[:-1] + [_FLAX_LEAVES.get(leaf,
                                                                  leaf)])):
        raise ValueError(f"unhandled student param: {'/'.join(path)}")
    if leaf == "scale":
        parts[-1] = "weight"
    elif leaf == "kernel":
        parts[-1] = "weight"
        if path[-3:-1] == ("patch_embed", "proj"):
            return ".".join(parts), conv3d_weight(arr, patch_size, in_chans)
        return ".".join(parts), arr.T
    return ".".join(parts), arr


def _dense_leaf(stem: str, path: Tuple[str, ...],
                arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """A CLIP dense layer's leaf: fp32 ``kernel`` or int8 ``kernel_q``
    [in, out] -> ``weight`` [out, in]; ``kernel_scale`` -> ``weight_scale``;
    ``bias``. Anything else raises, so no leaf lands on another's key."""
    leaf = path[-1]
    if leaf in ("kernel", "kernel_q"):
        return stem + "weight", arr.T
    if leaf == "kernel_scale":
        return stem + "weight_scale", arr
    if leaf == "bias":
        return stem + "bias", arr
    raise ValueError(f"unhandled CLIP param: {'/'.join(path)}")


def clip_key(path: Tuple[str, ...], arr: np.ndarray,
             patch_size: int) -> Tuple[str, np.ndarray]:
    if path == ("conv1", "proj", "kernel"):
        return "conv1.weight", conv3d_weight(arr, patch_size)
    if path == ("token_embedding",):
        return "token_embedding.weight", arr
    if len(path) == 1:  # embeddings, proj, text_projection
        return path[0], arr
    if path[0] in ("ln_pre", "ln_post", "ln_final"):
        return f"{path[0]}.{'weight' if path[1] == 'scale' else 'bias'}", arr
    m = _INDEXED.match(path[0])
    if not m or m.group(1) != "resblocks":
        raise ValueError(f"unhandled CLIP param: {'/'.join(path)}")
    base = f"transformer.resblocks.{m.group(2)}."
    rest = path[1:]
    if rest[0] in ("attn_in_proj", "attn_out_proj"):  # the text tower
        rest = ("attn", rest[0][len("attn_"):]) + rest[1:]
    if rest[0] == "attn" and rest[1] == "in_proj":
        return _dense_leaf(base + "attn.in_proj_", path, arr)
    if rest[0] == "attn" and rest[1] == "out_proj":
        return _dense_leaf(base + "attn.out_proj.", path, arr)
    if rest[0] in ("ln_1", "ln_2"):
        return base + f"{rest[0]}.{'weight' if rest[1] == 'scale' else 'bias'}", arr
    if rest[0] in ("mlp_c_fc", "mlp_c_proj"):
        return _dense_leaf(base + f"mlp.{rest[0][len('mlp_'):]}.", path, arr)
    raise ValueError(f"unhandled CLIP param: {'/'.join(path)}")


def flax_to_state_dict(params: dict, *, kind: str = "student",
                       patch_size: int = 16) -> Dict[str, torch.Tensor]:
    """Nested flax params -> flat state dict of fp32 (int8 for quantized
    weights) CPU tensors in the port's names. ``kind`` is "student"
    (adaptation and UMT students, ViTs, VideoMAE) or "clip" (the visual
    and the text tower)."""
    if kind not in ("student", "clip"):
        raise ValueError(f"kind must be 'student' or 'clip', got {kind!r}")
    state = {}
    for path, arr in flatten(params).items():
        key, out = (student_key(path, arr, patch_size) if kind == "student"
                    else clip_key(path, arr, patch_size))
        state[key] = torch.from_numpy(np.ascontiguousarray(out).copy())
    return state
