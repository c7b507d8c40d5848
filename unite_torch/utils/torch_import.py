"""Key surgery for published PyTorch checkpoints (unite_tpu/utils/
torch_import.py): the UMT K710 student (``--student_init``, its
``--clip_decoder_init``) and extracted OpenAI CLIP visual weights
(``--clip_init``).

The port's models use the reference's parameter names, so a surgered state
dict loads into them directly (``merge_state``); what remains of the JAX
package's importer is the key surgery itself:

* model-key search over 'model|module' (run_stage1.py:522-533);
* stage-1 wrap-in-``encoder.`` + ``backbone.`` strip (run_stage1.py:525-542);
* stage 2's classifier-head surgery: delete, slice or remap a K710 head
  (run_stage2.py:366-382);
* temporal (linear) + spatial (bicubic) positional-embedding interpolation
  (run_stage2.py:395-435), with the CLS rows split off first;
* CLIP 2D->3D patch-conv inflation and positional interpolation
  (clip.py:191-229).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch


def load_torch_state(path: str, model_key: str = "model|module") -> Dict[str, torch.Tensor]:
    """torch.load + model-key search; values stay torch tensors (CPU)."""
    return select_state(torch.load(path, map_location="cpu",
                                   weights_only=False), model_key)


def select_state(ckpt, model_key: str = "model|module") -> Dict[str, torch.Tensor]:
    """The state dict of a loaded checkpoint: the first of the '|'-separated
    ``model_key`` entries that it holds, else the checkpoint itself."""
    if isinstance(ckpt, dict):
        for key in model_key.split("|"):
            if key in ckpt:
                print(f"Load state_dict by model_key = {key}")
                return dict(ckpt[key])
    return dict(ckpt)


def strip_prefixes(state: dict, strip=("backbone.",)) -> dict:
    """Remove leading prefixes (run_stage1.py:536-542 / run_stage2.py:384-393)."""
    out = {}
    for k, v in state.items():
        for p in strip:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def wrap_encoder_prefix(state: dict) -> dict:
    """Prefix every key with ``encoder.`` (stage-1 semantics when the ckpt
    came from a bare-encoder model, run_stage1.py:525-527)."""
    return {f"encoder.{k}": v for k, v in state.items()}


def surgery_head(state: dict, nb_classes: int, delete_head: bool = False,
                 label_map_path: str = None) -> dict:
    """Delete, slice, or remap the classifier head (run_stage2.py:366-382).

    K710 checkpoints: nb_classes=400 takes the first 400 rows; 600/700 remap
    rows through a label-map json (the reference reads
    ``k710/label_mixto{n}.json``, a user-downloaded file it does not ship —
    ``label_map_path`` overrides the default location). When the map file is
    absent the head is left as-is with a loud warning (merge_state will then
    skip it on shape mismatch) instead of silently training a fresh head."""
    state = dict(state)
    if "head.weight" in state:
        if delete_head:
            print("Removing head from pretrained checkpoint")
            state.pop("head.weight")
            state.pop("head.bias", None)
        elif state["head.weight"].shape[0] == 710:
            if nb_classes == 400:
                state["head.weight"] = state["head.weight"][:nb_classes]
                state["head.bias"] = state["head.bias"][:nb_classes]
            elif nb_classes in (600, 700):
                import json
                import os as _os
                import warnings as _warnings

                path = label_map_path or f"k710/label_mixto{nb_classes}.json"
                if _os.path.exists(path):
                    print(f"Load label map from {path}")
                    with open(path) as f:
                        label_map = json.load(f)
                    state["head.weight"] = state["head.weight"][label_map]
                    state["head.bias"] = state["head.bias"][label_map]
                else:
                    _warnings.warn(
                        f"K710 head with nb_classes={nb_classes} needs the "
                        f"label map {path} (run_stage2.py:376-382); not "
                        "found — the pretrained head will be DROPPED on "
                        "shape mismatch. Pass --label_map_path or place "
                        "the file there.")
    return state


def interpolate_pos_embed(
    state: dict,
    num_patches: int,
    num_extra_tokens: int,
    new_frames: int,
    tubelet_size: int,
    orig_frames: int = 8,
    key: str = "pos_embed",
) -> dict:
    """Temporal linear + spatial bicubic resample (run_stage2.py:395-435)."""
    if key not in state:
        return state
    state = dict(state)
    pe = torch.as_tensor(state[key])
    c = pe.shape[-1]
    orig_t = orig_frames // tubelet_size
    new_t = new_frames // tubelet_size
    orig_size = int(((pe.shape[-2] - num_extra_tokens) // orig_t) ** 0.5)
    new_size = int((num_patches // new_t) ** 0.5)

    if orig_t != new_t:
        print(f"Temporal interpolate from {orig_t} to {new_t}")
        # split the extra (cls) rows BEFORE the temporal view: folding them
        # into the [T, S*S] grid either breaks the view (rows not divisible
        # by T) or silently blends the cls row into patch embeddings. The
        # reference's own temporal branch has this latent defect
        # (run_stage2.py:412 ignores its extra tokens); policy here is to
        # fix, not replicate (the spatial branch below already does).
        extra_t = pe[:, :num_extra_tokens] if pe.dim() == 3 else \
            pe[None, :num_extra_tokens]
        pe3 = pe if pe.dim() == 3 else pe[None]
        body = pe3[:, num_extra_tokens:]
        tmp = body.reshape(1, orig_t, -1, c).permute(0, 2, 3, 1).reshape(
            -1, c, orig_t)
        tmp = torch.nn.functional.interpolate(tmp, size=new_t, mode="linear")
        tmp = tmp.view(1, -1, c, new_t).permute(0, 3, 1, 2).reshape(1, -1, c)
        pe = torch.cat((extra_t, tmp), dim=1)

    if orig_size != new_size:
        print(f"Position interpolate from {orig_size}x{orig_size} to {new_size}x{new_size}")
        extra = pe[:, :num_extra_tokens]
        pos = pe[:, num_extra_tokens:]
        pos = pos.reshape(-1, new_t, orig_size, orig_size, c)
        pos = pos.reshape(-1, orig_size, orig_size, c).permute(0, 3, 1, 2)
        pos = torch.nn.functional.interpolate(
            pos, size=(new_size, new_size), mode="bicubic", align_corners=False
        )
        pos = pos.permute(0, 2, 3, 1).reshape(-1, new_t, new_size, new_size, c)
        pos = pos.flatten(1, 3)
        pe = torch.cat((extra, pos), dim=1)

    state[key] = pe
    return state


def inflate_conv_weight(weight_2d, time_dim: int, center: bool = True):
    """2D conv weight → 3D by center init or mean-preserving tile (clip.py:191-201)."""
    w = torch.as_tensor(weight_2d)
    if center:
        w3 = torch.zeros(*w.shape).unsqueeze(2).repeat(1, 1, time_dim, 1, 1)
        w3[:, :, time_dim // 2] = w
    else:
        w3 = w.unsqueeze(2).repeat(1, 1, time_dim, 1, 1) / time_dim
    return w3


def interpolate_clip_pos_embed(state: dict, input_resolution: int, patch_size: int) -> dict:
    """CLIP [HW+1, C] positional embedding bicubic resample (clip.py:215-229)."""
    state = dict(state)
    pe = torch.as_tensor(state["positional_embedding"])
    c = pe.shape[-1]
    num_patches = (input_resolution // patch_size) ** 2
    orig_size = int((pe.shape[-2] - 1) ** 0.5)
    new_size = int(num_patches**0.5)
    if orig_size != new_size:
        print(f"Pos_emb from {orig_size} to {new_size}")
        extra = pe[:1]
        pos = pe[1:].reshape(-1, orig_size, orig_size, c).permute(0, 3, 1, 2)
        pos = torch.nn.functional.interpolate(
            pos, size=(new_size, new_size), mode="bicubic", align_corners=False
        )
        pos = pos.permute(0, 2, 3, 1).flatten(0, 2)
        state["positional_embedding"] = torch.cat((extra, pos), dim=0)
    return state


def clip_state_for_model(state: dict, input_resolution: int = 224,
                         patch_size: int = 16) -> dict:
    """An OpenAI CLIP visual state dict as the port's CLIP tower names it:
    2-D patch weights inflated to the tower's one frame (clip.py:204-213,
    centre init), the positional
    embedding resampled to ``input_resolution``, and block keys under
    ``transformer.`` (the JAX importer's ``clip_key_to_flax`` accepts them
    with or without it)."""
    state = dict(state)
    w = torch.as_tensor(state["conv1.weight"])
    if w.ndim == 4:
        state["conv1.weight"] = inflate_conv_weight(w, 1)
    state = interpolate_clip_pos_embed(state, input_resolution, patch_size)
    return {re.sub(r"^resblocks\.", "transformer.resblocks.", k): v
            for k, v in state.items()}


def merge_state(model: torch.nn.Module, state: dict
                ) -> Tuple[List[str], List[str]]:
    """Load the parameters that match into ``model`` (the reference's
    load_state_dict: load what matches, report missing and unexpected
    keys). As in the JAX importer, buffers (the fixed sinusoid tables) are
    never loaded and a key whose shape differs is skipped and reported.
    Returns (missing, unexpected)."""
    own = dict(model.named_parameters())
    unexpected = []
    with torch.no_grad():
        for k, v in state.items():
            if k not in own:
                unexpected.append(k)
            elif tuple(v.shape) != tuple(own[k].shape):
                print(f"Skip: shape mismatch for {k}: ckpt {tuple(v.shape)} "
                      f"vs model {tuple(own[k].shape)}")
                unexpected.append(k)
            else:
                own[k].copy_(torch.as_tensor(v))
    missing = sorted(k for k in own if k not in state or k in unexpected)
    if missing:
        print("Missing keys:", missing)
    if unexpected:
        print("Unexpected keys:", sorted(unexpected))
    return missing, unexpected
