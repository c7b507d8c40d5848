"""VideoMAE pixel-reconstruction pretraining model.

Counterpart of unite_tpu/models/pretrain_videomae.py: an encoder over the
visible tokens only, a linear map to the decoder's width, and a decoder
that sees the visible tokens and one mask token per masked position, each
with the fixed sinusoid table added at its position, and predicts the
pixels of the masked patches (``decoder_num_classes = 3 * tubelet *
patch**2``) through an fp32 head.

Masking is by index: the caller passes ``vis_idx`` [B, N_vis] and
``mask_idx`` [B, N_mask]. Unlike the adaptation and UMT students, the
encoder embeds every patch and adds the positional table before it
gathers the visible tokens. At ViT-B width over 16 frames of 224^2 with
tubelet 2 at mask 0.9 the encoder runs 160 tokens (K1/K2) and the 384-wide,
6-head decoder 1568 (K3/K4 on the packed lanes).

Parameter names are the reference checkpoints' (``encoder.blocks.N...``,
``encoder_to_decoder.weight``, ``mask_token``, ``decoder.head.weight``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from unite_torch.models.layers import (
    Block,
    LayerNorm,
    Linear,
    PatchEmbed,
    gather_tokens,
    get_sinusoid_encoding_table,
    num_patches,
    trunc_normal_,
)
from unite_torch.utils.registry import register_model


def _blocks(dim, depth, num_heads, mlp_ratio, qkv_bias, qk_scale,
            drop_path_rate, init_values, norm_eps, dtype, drop_rate,
            attn_drop_rate):
    dpr = np.linspace(0, drop_path_rate, depth)
    return nn.ModuleList(
        Block(dim, num_heads, mlp_ratio, qkv_bias, qk_scale, float(dpr[i]),
              init_values, norm_eps, dtype, drop=drop_rate,
              attn_drop=attn_drop_rate)
        for i in range(depth))


def _sinusoid(n: int, dim: int) -> torch.Tensor:
    return torch.from_numpy(get_sinusoid_encoding_table(n, dim))


class MAEEncoder(nn.Module):
    """ViT encoder over the visible tokens; returns the last layer, normed."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 init_values: Optional[float] = None, num_frames: int = 16,
                 tubelet_size: int = 2, use_learnable_pos_emb: bool = False,
                 norm_eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = PatchEmbed(embed_dim, patch_size, tubelet_size,
                                      dtype=dtype)
        n = num_patches(img_size, patch_size, num_frames, tubelet_size)
        if use_learnable_pos_emb:
            self.pos_embed = nn.Parameter(
                trunc_normal_(torch.empty(1, n, embed_dim)))
        else:
            self.register_buffer("pos_embed", _sinusoid(n, embed_dim),
                                 persistent=False)
        self.blocks = _blocks(embed_dim, depth, num_heads, mlp_ratio,
                              qkv_bias, qk_scale, drop_path_rate, init_values,
                              norm_eps, dtype, drop_rate, attn_drop_rate)
        self.norm = LayerNorm(embed_dim, norm_eps)

    def forward(self, x, vis_idx=None,
                generator: Optional[torch.Generator] = None):
        # embed every patch, add the table, then keep the visible tokens
        x = self.patch_embed(x.to(self.dtype))
        x = x + self.pos_embed.to(x.dtype)
        if vis_idx is not None:
            x = gather_tokens(x, vis_idx)
        for blk in self.blocks:
            x = blk(x, generator)
        return self.norm(x)


class MAEDecoder(nn.Module):
    """Transformer decoder predicting the pixels of the trailing
    ``return_token_num`` tokens (the mask tokens) through an fp32 head."""

    def __init__(self, num_classes: int = 1536, embed_dim: int = 512,
                 depth: int = 8, num_heads: int = 8, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 init_values: Optional[float] = None, norm_eps: float = 1e-6,
                 dtype=torch.float32):
        super().__init__()
        self.blocks = _blocks(embed_dim, depth, num_heads, mlp_ratio,
                              qkv_bias, qk_scale, drop_path_rate, init_values,
                              norm_eps, dtype, drop_rate, attn_drop_rate)
        self.norm = LayerNorm(embed_dim, norm_eps)
        # flax Dense(dtype=float32): the input is cast up, fp32 out
        self.head = Linear(embed_dim, num_classes, dtype=torch.float32)

    def forward(self, x, return_token_num: int,
                generator: Optional[torch.Generator] = None):
        for blk in self.blocks:
            x = blk(x, generator)
        if return_token_num > 0:
            x = x[:, -return_token_num:]
        return self.head(self.norm(x))


class PretrainVideoMAE(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 encoder_embed_dim: int = 768, encoder_depth: int = 12,
                 encoder_num_heads: int = 12, decoder_num_classes: int = 1536,
                 decoder_embed_dim: int = 512, decoder_depth: int = 8,
                 decoder_num_heads: int = 8, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, init_values: float = 0.0,
                 use_learnable_pos_emb: bool = False, num_frames: int = 16,
                 tubelet_size: int = 2, norm_eps: float = 1e-6,
                 dtype=torch.float32):
        super().__init__()
        self.encoder = MAEEncoder(
            img_size, patch_size, encoder_embed_dim, encoder_depth,
            encoder_num_heads, mlp_ratio, qkv_bias, qk_scale, drop_rate,
            attn_drop_rate, drop_path_rate, init_values, num_frames,
            tubelet_size, use_learnable_pos_emb, norm_eps, dtype)
        self.encoder_to_decoder = Linear(encoder_embed_dim, decoder_embed_dim,
                                         bias=False, dtype=dtype)
        self.mask_token = nn.Parameter(
            trunc_normal_(torch.empty(1, 1, decoder_embed_dim)))
        n = num_patches(img_size, patch_size, num_frames, tubelet_size)
        self.register_buffer("pos_embed", _sinusoid(n, decoder_embed_dim),
                             persistent=False)
        self.decoder = MAEDecoder(
            decoder_num_classes, decoder_embed_dim, decoder_depth,
            decoder_num_heads, mlp_ratio, qkv_bias, qk_scale, drop_rate,
            attn_drop_rate, drop_path_rate, init_values, norm_eps, dtype)

    def forward(self, x, vis_idx, mask_idx,
                generator: Optional[torch.Generator] = None):
        """[B, N_mask, decoder_num_classes] fp32 pixel predictions."""
        x_vis = self.encoder_to_decoder(self.encoder(x, vis_idx, generator))
        pos = self.pos_embed.expand(x_vis.shape[0], -1, -1)
        pos_vis = gather_tokens(pos, vis_idx).to(x_vis.dtype)
        pos_mask = gather_tokens(pos, mask_idx).to(x_vis.dtype)
        x_full = torch.cat([x_vis + pos_vis,
                            self.mask_token.to(x_vis.dtype) + pos_mask], dim=1)
        return self.decoder(x_full, mask_idx.shape[1], generator)


@register_model
def pretrain_videomae_base_patch16_224(**kwargs):
    return PretrainVideoMAE(
        img_size=224, patch_size=16, encoder_embed_dim=768, encoder_depth=12,
        encoder_num_heads=12, decoder_num_classes=1536, decoder_embed_dim=384,
        decoder_num_heads=6, mlp_ratio=4, qkv_bias=True, norm_eps=1e-6,
        **kwargs)


@register_model
def pretrain_videomae_large_patch16_224(**kwargs):
    return PretrainVideoMAE(
        img_size=224, patch_size=16, encoder_embed_dim=1024, encoder_depth=24,
        encoder_num_heads=16, decoder_num_classes=1536, decoder_embed_dim=512,
        decoder_num_heads=8, mlp_ratio=4, qkv_bias=True, norm_eps=1e-6,
        **kwargs)


@register_model
def pretrain_videomae_huge_patch16_224(**kwargs):
    return PretrainVideoMAE(
        img_size=224, patch_size=16, encoder_embed_dim=1280, encoder_depth=32,
        encoder_num_heads=16, decoder_num_classes=1536, decoder_embed_dim=640,
        decoder_num_heads=8, mlp_ratio=4, qkv_bias=True, norm_eps=1e-6,
        **kwargs)
