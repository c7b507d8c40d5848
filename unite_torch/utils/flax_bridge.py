"""Carry weights from a flax param tree (nested dict of numpy arrays) into
the port's ``state_dict`` names.

Students and ViTs take the keys of unite_tpu/utils/torch_export.py
(``blocks_N`` -> ``blocks.N``, LayerNorm ``scale`` -> ``weight``, Dense
``kernel`` [in, out] -> ``weight`` [out, in], the patch-embed kernel
[kt*kh*kw*C, D] -> Conv3d ``weight`` [D, C, kt, kh, kw]); an adaptation
student's ``cls_token`` and learnable ``pos_embed`` keep their names
(``encoder.cls_token``). CLIP takes the OpenAI visual tower's keys, the
inverse of unite_tpu/utils/torch_import.py::clip_key_to_flax, and the text
tower's (``token_embedding.weight``, ``ln_final``, ``attn.in_proj_*``), the
inverse of unite_tpu/models/clip_text.py::text_state_to_flax_params.
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
            flat[prefix + (k,)] = np.asarray(v, np.float32)
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


def student_key(path: Tuple[str, ...], arr: np.ndarray, patch_size: int,
                in_chans: int = 3) -> Tuple[str, np.ndarray]:
    parts = []
    for p in path:
        m = _INDEXED.match(p)
        parts.extend(m.groups() if m else (p,))
    leaf = parts[-1]
    if leaf == "scale":
        parts[-1] = "weight"
    elif leaf == "kernel":
        parts[-1] = "weight"
        if path[-3:-1] == ("patch_embed", "proj"):
            return ".".join(parts), conv3d_weight(arr, patch_size, in_chans)
        return ".".join(parts), arr.T
    return ".".join(parts), arr


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
        return (base + "attn.in_proj_" + ("weight" if rest[2] == "kernel"
                                          else "bias"),
                arr.T if rest[2] == "kernel" else arr)
    if rest[0] == "attn" and rest[1] == "out_proj":
        return (base + "attn.out_proj." + ("weight" if rest[2] == "kernel"
                                           else "bias"),
                arr.T if rest[2] == "kernel" else arr)
    if rest[0] in ("ln_1", "ln_2"):
        return base + f"{rest[0]}.{'weight' if rest[1] == 'scale' else 'bias'}", arr
    if rest[0] in ("mlp_c_fc", "mlp_c_proj"):
        name = rest[0][len("mlp_"):]
        if rest[1] == "kernel":
            return base + f"mlp.{name}.weight", arr.T
        return base + f"mlp.{name}.bias", arr
    raise ValueError(f"unhandled CLIP param: {'/'.join(path)}")


def flax_to_state_dict(params: dict, *, kind: str = "student",
                       patch_size: int = 16) -> Dict[str, torch.Tensor]:
    """Nested flax params -> flat state dict of fp32 CPU tensors in the
    port's names. ``kind`` is "student" (adaptation students, ViTs) or
    "clip" (the visual and the text tower)."""
    if kind not in ("student", "clip"):
        raise ValueError(f"kind must be 'student' or 'clip', got {kind!r}")
    state = {}
    for path, arr in flatten(params).items():
        key, out = (student_key(path, arr, patch_size) if kind == "student"
                    else clip_key(path, arr, patch_size))
        state[key] = torch.from_numpy(np.ascontiguousarray(out).copy())
    return state
