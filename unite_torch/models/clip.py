"""Frozen CLIP visual teacher, run per frame on video.

Counterpart of unite_tpu/models/clip.py: a per-frame patch projection with
no bias, a class token and 2-D positional embedding, ``ln_pre``, residual
blocks with QuickGELU and a full qkv bias, taps at ``return_index`` layers
and, on request, the last layer's head-averaged CLS->patch attention row.
With ``cls_features`` it is the image encoder of the stage-3 zero-shot
teacher: the per-frame L2-normed ``ln_post(cls) @ proj``.

Parameter names are the OpenAI CLIP visual tower's (``conv1.weight`` in
Conv3d shape, ``transformer.resblocks.N.attn.in_proj_weight``,
``mlp.c_fc.weight``, ``ln_post``, ``proj``, ...), the names
unite_tpu/utils/torch_import.py::clip_key_to_flax reads.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from unite_torch.models.layers import (
    LayerNorm,
    Linear,
    TubeletProjection,
    layer_norm,
    patchify,
)
from unite_torch.ops.attention import self_attention
from unite_torch.utils.registry import register_model


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """Self-attention with packed qkv and a full bias (torch MHA layout)."""

    def __init__(self, width: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width, dtype=dtype)

    def forward(self, x, cls_probs: bool = False):
        """With ``cls_probs`` also returns the head-averaged CLS-query
        attention row [B, N]: one fp32 [B, H, N] product and softmax beside
        the attention kernel, never the full [B, H, N, N] matrix. The
        attention takes ``self_attention``'s forward-only route with no
        width, as JAX's CLIP does (models/clip.py:82): K1 at 197 tokens, K6
        at 577 (L/14 at 336^2)."""
        b, n, c = x.shape
        d = c // self.num_heads
        scale = d ** -0.5
        qkv = F.linear(x.to(self.dtype), self.in_proj_weight.to(self.dtype),
                       self.in_proj_bias.to(self.dtype))
        out = self.out_proj(self_attention(qkv, self.num_heads, scale,
                                           fwd_only=True))
        if not cls_probs:
            return out
        qh = qkv[:, 0, :c].reshape(b, self.num_heads, d).float()
        kh = qkv[:, :, c:2 * c].reshape(b, n, self.num_heads, d).float()
        scores = torch.einsum("bhd,bnhd->bhn", qh, kh) * scale
        return out, torch.softmax(scores, dim=-1).mean(dim=1)


class CLIPMlp(nn.Module):
    def __init__(self, width: int, dtype=torch.float32):
        super().__init__()
        self.c_fc = Linear(width, 4 * width, dtype=dtype)
        self.c_proj = Linear(4 * width, width, dtype=dtype)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class CLIPBlock(nn.Module):
    """Pre-norm residual attention block with a QuickGELU MLP (eps 1e-5)."""

    def __init__(self, width: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.attn = CLIPAttention(width, num_heads, dtype)
        self.ln_1 = LayerNorm(width, 1e-5)
        self.mlp = CLIPMlp(width, dtype)
        self.ln_2 = LayerNorm(width, 1e-5)

    def forward(self, x, cls_probs: bool = False):
        probs = None
        h = self.attn(self.ln_1(x), cls_probs=cls_probs)
        if cls_probs:
            h, probs = h
        x = x + h
        x = x + self.mlp(self.ln_2(x))
        return (x, probs) if cls_probs else x


class CLIPTransformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 dtype=torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(
            CLIPBlock(width, heads, dtype) for _ in range(layers))


class CLIPVisionTransformer(nn.Module):
    """CLIP visual encoder over video, folding time into the batch."""

    def __init__(self, input_resolution: int = 224, patch_size: int = 16,
                 width: int = 768, layers: int = 12, heads: int = 12,
                 output_dim: int = 512, clip_norm_type: str = "l2",
                 kernel_size: int = 1, return_attn: bool = False,
                 return_index: Sequence[int] = (6, 7, 8, 9, 10, 11),
                 dtype=torch.float32):
        super().__init__()
        if clip_norm_type not in ("l2", "none"):
            raise NotImplementedError(clip_norm_type)
        self.input_resolution, self.patch_size = input_resolution, patch_size
        self.width, self.kernel_size = width, kernel_size
        self.clip_norm_type, self.return_attn = clip_norm_type, return_attn
        self.return_index = tuple(int(i) for i in return_index)
        self.dtype = dtype
        hw = (input_resolution // patch_size) ** 2
        std = width ** -0.5
        self.conv1 = TubeletProjection(3, width, kernel_size, patch_size,
                                       bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.randn(width) * std)
        self.positional_embedding = nn.Parameter(torch.randn(hw + 1, width) * std)
        self.ln_pre = LayerNorm(width, 1e-5)
        self.transformer = CLIPTransformer(width, layers, heads, dtype)
        self.ln_post = LayerNorm(width, 1e-5)
        self.proj = nn.Parameter(torch.randn(width, output_dim) * std)

    def forward(self, x, raw_taps: bool = False, cls_features: bool = False):
        """x [B, T, H, W, 3] -> z, or (z, attn) when ``return_attn``.

        ``cls_features``: the image-encoder mode (unite_tpu ``cls_features``,
        OpenAI ``encode_image``): only the per-frame L2-normed
        ``ln_post(cls) @ proj``, fp32 [B*T', output_dim], from all layers,
        with no taps and no attention row.

        z: [K, B, T'*HW, output_dim] L2-normed features, or with
        ``raw_taps`` the tap stack before ln_post/proj/L2 [K, B, T'*HW, width]
        (CLS stripped), for ``project_clip_taps`` after a visible gather.
        attn: [B*T', HW] last-layer head-averaged CLS->patch probabilities.
        """
        r = self.input_resolution
        if tuple(x.shape[-3:-1]) != (r, r):
            raise ValueError(
                f"teacher expects {r}x{r} frames, got {x.shape[-3]}x"
                f"{x.shape[-2]}: resize the clip (clip_input_resolution) or "
                f"build the teacher with input_resolution matching the input")
        b = x.shape[0]
        x = self.conv1(patchify(x.to(self.dtype), self.patch_size,
                                self.kernel_size))
        hw = (r // self.patch_size) ** 2
        t = x.shape[1] // hw
        x = x.reshape(b * t, hw, self.width)
        cls = self.class_embedding.to(x.dtype).expand(b * t, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)

        taps, attn = [], None
        blocks = self.transformer.resblocks
        for i, blk in enumerate(blocks):
            if self.return_attn and i == len(blocks) - 1 and not cls_features:
                x, probs = blk(x, cls_probs=True)
                attn = probs[:, 1:]
            else:
                x = blk(x)
            if i in self.return_index:
                taps.append(x)

        if cls_features:
            return project_clip_taps(self, x[:, 0], "l2", torch.float32)
        z = torch.stack(taps)[:, :, 1:, :]  # strip CLS
        z = z.reshape(z.shape[0], b, t * hw, self.width)
        if not raw_taps:
            z = project_clip_taps(self, z, self.clip_norm_type, self.dtype)
        return (z, attn) if self.return_attn else z


def project_clip_taps(teacher: CLIPVisionTransformer, taps,
                      clip_norm_type: str = "l2", dtype=torch.float32):
    """ln_post + proj + L2-norm on a (gathered) tap stack [..., N, width]:
    per-token ops, so applying them after the visible gather equals
    gathering the projected output."""
    y = layer_norm(taps, teacher.ln_post.weight, teacher.ln_post.bias, 1e-5)
    z = torch.einsum("...nc,cd->...nd", y.float(),
                     teacher.proj.to(y.dtype).float())
    if clip_norm_type == "l2":
        z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    elif clip_norm_type != "none":
        raise NotImplementedError(clip_norm_type)
    return z.to(dtype)


@register_model
def clip_b16(**kwargs):
    """CLIP ViT-B/16 teacher."""
    return CLIPVisionTransformer(patch_size=16, width=768, layers=12,
                                 heads=12, output_dim=512, **kwargs)
