"""Adaptation video ViT, the student of stages 1 and 3.

Counterpart of unite_tpu/models/adaptation.py: a masked ViT encoder that
keeps only the visible tokens ``vis_idx`` [B, N_vis], taps K intermediate
layers and projects each tap to CLIP space through its own linear decoder,
with the fixed sinusoid table added at the visible positions. Without a CLS
token the gather comes before the patch projection (row-wise identical, a
fifth of the work at mask 0.8); with ``use_cls_token`` the CLS row is
prepended, the positional table spans N + 1, the gather follows the
embedding and keeps CLS outside the mask, and the taps drop CLS before the
decoders. At 8 frames of 224^2 the CLS student's full passes run 1569
tokens, which have no divisor query block, so they take K6. ``remat``
recomputes the blocks in the backward (``remat_num`` >= 0: only the first
``remat_num``), replaying their dropout and drop-path draws
(``layers.remat_block``); ``drop_rate`` and ``attn_drop_rate`` are the
blocks' dropout rates, as in JAX.

Parameter names follow the reference checkpoints (``encoder.blocks.N...``,
``clip_decoder.N.head.weight``), the names
unite_tpu/utils/torch_export.py::flax_path_to_torch produces.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from unite_torch.models.layers import (
    Block,
    LayerNorm,
    LinearDecoder,
    PatchEmbed,
    gather_tokens,
    get_sinusoid_encoding_table,
    num_patches,
    remat_block,
    remat_blocks,
    trunc_normal_,
)
from unite_torch.utils.registry import register_model


class AdaptationEncoder(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path_rate: float = 0.0,
                 init_values: Optional[float] = None, num_frames: int = 16,
                 tubelet_size: int = 2,
                 return_index: Sequence[int] = (6, 7, 8, 9, 10, 11),
                 norm_eps: float = 1e-6, use_learnable_pos_emb: bool = False,
                 use_cls_token: bool = False, dtype=torch.float32,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 remat: bool = False, remat_num: int = -1):
        super().__init__()
        self.return_index = tuple(int(i) for i in return_index)
        self.use_cls_token = use_cls_token
        self.patch_embed = PatchEmbed(embed_dim, patch_size, tubelet_size,
                                      dtype=dtype)
        seq = num_patches(img_size, patch_size, num_frames, tubelet_size)
        if use_cls_token:
            self.cls_token = nn.Parameter(
                trunc_normal_(torch.empty(1, 1, embed_dim)))
            seq += 1
        if use_learnable_pos_emb:
            self.pos_embed = nn.Parameter(
                trunc_normal_(torch.empty(1, seq, embed_dim)))
        else:
            self.register_buffer(
                "pos_embed",
                torch.from_numpy(get_sinusoid_encoding_table(seq, embed_dim)),
                persistent=False)
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale,
                  float(dpr[i]), init_values, norm_eps, dtype,
                  drop=drop_rate, attn_drop=attn_drop_rate)
            for i in range(depth))
        self.remat = remat_blocks(depth, remat, remat_num)
        self.norm = LayerNorm(embed_dim, norm_eps)
        self.dtype = dtype

    def forward(self, x, vis_idx=None, clip_only: bool = False,
                generator: Optional[torch.Generator] = None):
        gather_early = vis_idx is not None and not self.use_cls_token
        x = self.patch_embed(x.to(self.dtype),
                             vis_idx if gather_early else None)
        b = x.shape[0]
        if self.use_cls_token:
            cls = self.cls_token.to(x.dtype).expand(b, -1, -1)
            x = torch.cat([cls, x], dim=1)
        pos = self.pos_embed.to(x.dtype).expand(b, -1, -1)
        if gather_early:
            pos = gather_tokens(pos, vis_idx)
        x = x + pos
        if vis_idx is not None and not gather_early:
            # the CLS row stays outside the mask
            x = torch.cat([x[:, :1], gather_tokens(x[:, 1:], vis_idx)], dim=1)

        max_ret = max(self.return_index)
        taps = []
        for i, blk in enumerate(self.blocks):
            if clip_only and i > max_ret:
                break  # early exit: these blocks get no gradient
            if self.remat[i] and torch.is_grad_enabled():
                x = remat_block(blk, x, generator)
            else:
                x = blk(x, generator)
            if i in self.return_index:
                taps.append(x)
        x_clip_vis = self.norm(torch.stack(taps))  # [K, B, N_vis, C]
        if clip_only:
            return None, x_clip_vis
        return self.norm(x), x_clip_vis


class AdaptationVisionTransformer(nn.Module):
    """Encoder + K CLIP-alignment linear decoders."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 encoder_embed_dim: int = 768, encoder_depth: int = 12,
                 encoder_num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_path_rate: float = 0.0, init_values: float = 0.0,
                 num_frames: int = 16, tubelet_size: int = 2,
                 clip_decoder_embed_dim: int = 768, clip_output_dim: int = 512,
                 clip_norm_type: str = "l2",
                 clip_return_layers: Sequence[int] = (6, 7, 8, 9, 10, 11),
                 norm_eps: float = 1e-6, use_learnable_pos_emb: bool = False,
                 use_cls_token: bool = False, dtype=torch.float32,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 remat: bool = False, remat_num: int = -1):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.use_cls_token = use_cls_token
        self.encoder = AdaptationEncoder(
            img_size, patch_size, encoder_embed_dim, encoder_depth,
            encoder_num_heads, mlp_ratio, qkv_bias, qk_scale, drop_path_rate,
            init_values, num_frames, tubelet_size, clip_return_layers,
            norm_eps, use_learnable_pos_emb, use_cls_token, dtype,
            drop_rate, attn_drop_rate, remat, remat_num)
        n = num_patches(img_size, patch_size, num_frames, tubelet_size)
        self.register_buffer(
            "clip_pos_embed",
            torch.from_numpy(get_sinusoid_encoding_table(
                n, clip_decoder_embed_dim)),
            persistent=False)
        self.clip_decoder = nn.ModuleList(
            LinearDecoder(clip_decoder_embed_dim, clip_output_dim,
                          clip_norm_type, norm_eps, dtype)
            for _ in clip_return_layers)

    def forward(self, x, vis_idx=None, clip_only: bool = False,
                generator: Optional[torch.Generator] = None):
        """x_clip [K, B, N_vis, clip_output_dim] if clip_only, else
        (x_vis, x_clip)."""
        x_vis, taps = self.encoder(x, vis_idx, clip_only, generator)
        if self.use_cls_token:
            taps = taps[:, :, 1:]  # CLS takes no part in the alignment
        pos = self.clip_pos_embed.expand(taps.shape[1], -1, -1)
        if vis_idx is not None:
            pos = gather_tokens(pos, vis_idx)
        taps = taps + pos[None].to(taps.dtype)
        x_clip = torch.stack([dec(taps[i])
                              for i, dec in enumerate(self.clip_decoder)])
        return x_clip if clip_only else (x_vis, x_clip)


@register_model
def adaptation_umt_base_patch16_224(**kwargs):
    return AdaptationVisionTransformer(
        img_size=224, patch_size=16, encoder_embed_dim=768, encoder_depth=12,
        encoder_num_heads=12, mlp_ratio=4, qkv_bias=True, norm_eps=1e-6,
        **kwargs)


@register_model
def adaptation_umt_large_patch16_224(**kwargs):
    return AdaptationVisionTransformer(
        img_size=224, patch_size=16, encoder_embed_dim=1024, encoder_depth=24,
        encoder_num_heads=16, mlp_ratio=4, qkv_bias=True, norm_eps=1e-6,
        **kwargs)
