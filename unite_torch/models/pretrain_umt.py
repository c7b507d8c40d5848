"""UMT masked-pretraining student: an encoder and one linear CLIP-alignment
decoder per tapped layer.

Counterpart of unite_tpu/models/pretrain_umt.py. It is the adaptation
student's encoder (``adaptation.AdaptationEncoder``: the visible tokens
gathered before the patch projection, the sinusoid table gathered by
``vis_idx``, taps appended in ascending layer order and normed by one
shared ``norm``, ``remat`` / ``remat_num`` through ``layers.remat_block``)
without a CLS token and without its final normed output, with the taps
counted from the top: ``top_down_return_index``. The forward returns the
taps in CLIP space only, [K, B, N_vis, clip_output_dim]; nothing stops
early, since the top tap is the last layer.

Parameter names are the reference checkpoints' (``encoder.blocks.N...``,
``clip_decoder.N.head.weight``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from unite_torch.models.adaptation import AdaptationEncoder
from unite_torch.models.layers import (
    LinearDecoder,
    gather_tokens,
    get_sinusoid_encoding_table,
    num_patches,
)
from unite_torch.utils.registry import register_model


def top_down_return_index(depth: int, n_layers: int, interval: int = 1):
    """[depth - i*interval - 1 for i in range(n_layers)], ascending."""
    return tuple(sorted(depth - i * interval - 1 for i in range(n_layers)))


class PretrainEncoder(AdaptationEncoder):
    """The masked encoder; returns the normed taps [K, B, N_vis, C]."""

    def forward(self, x, vis_idx=None,
                generator: Optional[torch.Generator] = None):
        return super().forward(x, vis_idx, clip_only=True,
                               generator=generator)[1]


class PretrainUMT(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 encoder_embed_dim: int = 768, encoder_depth: int = 12,
                 encoder_num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, init_values: float = 0.0,
                 use_learnable_pos_emb: bool = False, num_frames: int = 16,
                 tubelet_size: int = 2, clip_decoder_embed_dim: int = 768,
                 clip_output_dim: int = 512, clip_norm_type: str = "l2",
                 clip_return_layer: int = 1,
                 clip_student_return_interval: int = 1,
                 norm_eps: float = 1e-6, dtype=torch.float32,
                 remat: bool = False, remat_num: int = -1):
        super().__init__()
        self.return_index = top_down_return_index(
            encoder_depth, clip_return_layer, clip_student_return_interval)
        self.encoder = PretrainEncoder(
            img_size=img_size, patch_size=patch_size,
            embed_dim=encoder_embed_dim, depth=encoder_depth,
            num_heads=encoder_num_heads, mlp_ratio=mlp_ratio,
            qkv_bias=qkv_bias, qk_scale=qk_scale,
            drop_path_rate=drop_path_rate, init_values=init_values,
            num_frames=num_frames, tubelet_size=tubelet_size,
            return_index=self.return_index, norm_eps=norm_eps,
            use_learnable_pos_emb=use_learnable_pos_emb, dtype=dtype,
            drop_rate=drop_rate, attn_drop_rate=attn_drop_rate, remat=remat,
            remat_num=remat_num)
        n = num_patches(img_size, patch_size, num_frames, tubelet_size)
        self.register_buffer(
            "clip_pos_embed",
            torch.from_numpy(get_sinusoid_encoding_table(
                n, clip_decoder_embed_dim)),
            persistent=False)
        self.clip_decoder = nn.ModuleList(
            LinearDecoder(clip_decoder_embed_dim, clip_output_dim,
                          clip_norm_type, norm_eps, dtype)
            for _ in range(clip_return_layer))

    def forward(self, x, vis_idx=None,
                generator: Optional[torch.Generator] = None):
        """x_clip [K, B, N_vis, clip_output_dim]."""
        taps = self.encoder(x, vis_idx, generator)
        pos = self.clip_pos_embed.expand(taps.shape[1], -1, -1)
        if vis_idx is not None:
            pos = gather_tokens(pos, vis_idx)
        taps = taps + pos[None].to(taps.dtype)
        return torch.stack([dec(taps[i])
                            for i, dec in enumerate(self.clip_decoder)])


@register_model
def pretrain_umt_base_patch16_224(**kwargs):
    return PretrainUMT(
        img_size=224, patch_size=16, encoder_embed_dim=768, encoder_depth=12,
        encoder_num_heads=12, mlp_ratio=4, qkv_bias=True, norm_eps=1e-6,
        **kwargs)


@register_model
def pretrain_umt_large_patch16_224(**kwargs):
    return PretrainUMT(
        img_size=224, patch_size=16, encoder_embed_dim=1024, encoder_depth=24,
        encoder_num_heads=16, mlp_ratio=4, qkv_bias=True, norm_eps=1e-6,
        **kwargs)
