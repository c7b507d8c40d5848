"""Extract CLIP tower weights from an OpenAI CLIP checkpoint.

Counterpart of tools/extract_clip.py (the reference's
extract_clip/extract.ipynb): the ``visual.`` tower with its prefix taken
off (``vit_b16.pth`` and the like, which ``--clip_init`` reads), the text
tower on request, and the stage-3 zero-shot text features of a class list
(``--clip_text_features``), so training hosts need no tokenizer::

    python -m unite_torch.tools.extract_clip ViT-B-16.pt out_dir \\
        [--text] [--features-for 12 --bpe bpe_simple_vocab_16e6.txt.gz]

The text tower's geometry (width, heads of 64, output width, layers) is
read from the state, so an L/14 checkpoint loads too. It runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from unite_torch.models.clip_text import (PROMPT, CLIPTextTransformer,
                                          SimpleTokenizer, get_class_names)

TEXT_KEYS = ("positional_embedding", "text_projection",
             "token_embedding.weight", "ln_final.weight", "ln_final.bias")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoint", help="OpenAI CLIP .pt/.pth (full model)")
    ap.add_argument("out_dir")
    ap.add_argument("--visual-name", default="vit_b16.pth")
    ap.add_argument("--text", action="store_true",
                    help="also write the text tower (text_<visual-name>)")
    ap.add_argument("--features-for", type=int, default=0,
                    help="precompute zero-shot text features for this class "
                         "count (8/12/23) into text_features_<n>.npy")
    ap.add_argument("--bpe", default="",
                    help="CLIP BPE merges file (needed for --features-for)")
    return ap


def load_state(path: str) -> dict:
    """The full state dict of an OpenAI CLIP checkpoint."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(ckpt, "state_dict"):
        return ckpt.state_dict()
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt


def text_tower(text: dict) -> CLIPTextTransformer:
    """The text transformer of the geometry ``text`` holds, with its
    weights (fp32, strict)."""
    width = text["ln_final.weight"].shape[0]
    model = CLIPTextTransformer(
        width=width, heads=width // 64,
        embed_dim=text["text_projection"].shape[1],
        layers=len({k.split(".")[2] for k in text
                    if k.startswith("transformer.resblocks.")}))
    model.load_state_dict(text, strict=True)
    return model


def text_features(text: dict, bpe: str, nb_classes: int) -> np.ndarray:
    """fp32 [nb_classes, embed_dim] features of the class prompts."""
    names = get_class_names(nb_classes)
    tokens = SimpleTokenizer(bpe).tokenize([PROMPT.format(c) for c in names])
    with torch.no_grad():
        return text_tower(text)(torch.from_numpy(tokens)).numpy()


def main(argv=None) -> list:
    """Write the files; return the lines printed. The text tower runs on
    the CPU, as in the JAX tool."""
    a = parser().parse_args(argv)
    state = load_state(a.checkpoint)
    os.makedirs(a.out_dir, exist_ok=True)
    lines = []
    visual = {k[len("visual."):]: v for k, v in state.items()
              if k.startswith("visual.")}
    if not visual:
        raise SystemExit("no visual.* keys found — is this a full CLIP ckpt?")
    torch.save(visual, os.path.join(a.out_dir, a.visual_name))
    lines.append(f"wrote visual tower: {len(visual)} tensors -> "
                 f"{a.visual_name}")
    print(lines[-1])

    if a.text or a.features_for:
        text = {k: v for k, v in state.items()
                if k in TEXT_KEYS or k.startswith("transformer.")}
        name = f"text_{a.visual_name}"
        torch.save(text, os.path.join(a.out_dir, name))
        lines.append(f"wrote text tower: {len(text)} tensors -> {name}")
        print(lines[-1])

    if a.features_for:
        feats = text_features(text, a.bpe, a.features_for)
        out = os.path.join(a.out_dir, f"text_features_{a.features_for}.npy")
        np.save(out, feats.astype(np.float32))
        lines.append(f"wrote zero-shot text features {feats.shape} -> {out}")
        print(lines[-1])
    return lines


if __name__ == "__main__":
    main()
