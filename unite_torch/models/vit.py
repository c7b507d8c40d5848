"""Classification video ViT, the stage-2 finetune model.

Counterpart of unite_tpu/models/vit.py: tubelet patch embedding, the fixed
sinusoid (or a learnable) positional table, pre-norm blocks with the
``linspace(0, drop_path_rate, depth)`` stochastic-depth schedule, and either
``fc_norm`` over the token mean or a CLS token read out after ``norm``. The
classifier head (linear, or the two-layer ``mlp`` with no activation)
computes in fp32; its output layer's init is scaled by ``init_scale``.

At 8 frames of 224^2 with tubelet 1 the sequence is 1568 tokens, so the
blocks' attention takes the packed flash kernels K3/K4; with a CLS token
(``use_mean_pooling=False``) it is 1569, which has no divisor query block,
and takes K6.

Parameter names are the reference torch names (``patch_embed.proj.weight``
in Conv3d shape, ``blocks.N.attn.q_bias``, ``fc_norm.weight``,
``head.weight``), the names unite_tpu/utils/torch_export.py produces.
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
    Mlp,
    PatchEmbed,
    get_sinusoid_encoding_table,
    num_patches,
    trunc_normal_,
)
from unite_torch.utils.registry import register_model

class VisionTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 num_classes: int = 1000, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 fc_drop_rate: float = 0.0, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 init_values: float = 0.0, use_learnable_pos_emb: bool = False,
                 init_scale: float = 0.0, all_frames: int = 16,
                 tubelet_size: int = 2, use_mean_pooling: bool = True,
                 classifier_type: str = "linear",
                 classifier_hidden_dim: int = 256, norm_eps: float = 1e-6,
                 dtype=torch.float32):
        super().__init__()
        rates = dict(drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                     fc_drop_rate=fc_drop_rate)
        if any(r > 0.0 for r in rates.values()):
            raise NotImplementedError(
                f"dropout {rates} is not ported yet (ROADMAP queue 1, item "
                "4); the stage-2 config keeps every dropout rate at 0")
        if classifier_type not in ("linear", "mlp"):
            raise NotImplementedError(classifier_type)
        self.depth, self.dtype = depth, dtype
        self.use_mean_pooling = use_mean_pooling
        self.num_classes = num_classes
        self.patch_embed = PatchEmbed(embed_dim, patch_size, tubelet_size,
                                      dtype=dtype)
        seq = num_patches(img_size, patch_size, all_frames, tubelet_size)
        if not use_mean_pooling:
            self.cls_token = nn.Parameter(torch.randn(1, 1, embed_dim))
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
                  float(dpr[i]), init_values, norm_eps, dtype)
            for i in range(depth))
        if use_mean_pooling:
            self.fc_norm = LayerNorm(embed_dim, norm_eps)
        else:
            self.norm = LayerNorm(embed_dim, norm_eps)
        if num_classes > 0:
            if classifier_type == "linear":
                self.head = Linear(embed_dim, num_classes, dtype=torch.float32)
                out_layer = self.head
            else:
                self.head = Mlp(embed_dim, classifier_hidden_dim,
                                torch.float32, out_features=num_classes,
                                act=nn.Identity())
                out_layer = self.head.fc2
        # trunc_normal(0.02) on every matmul kernel (the JAX package's
        # kernel_init); the classifier's output layer scaled by init_scale
        for m in self.modules():
            if isinstance(m, Linear):
                trunc_normal_(m.weight)
        trunc_normal_(self.patch_embed.proj.weight)
        if num_classes > 0:
            trunc_normal_(out_layer.weight, scale=init_scale)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x [B, T, H, W, C] video -> [B, num_classes] fp32 logits (the
        pooled features when num_classes <= 0)."""
        x = self.patch_embed(x.to(self.dtype))
        if not self.use_mean_pooling:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x, generator)
        if self.use_mean_pooling:
            # jnp.mean on bf16: an fp32 sum, rounded once
            feat = self.fc_norm(x.float().mean(dim=1).to(x.dtype))
        else:
            feat = self.norm(x)[:, 0]
        if self.num_classes <= 0:
            return feat
        return self.head(feat.float())


@register_model
def vit_base_patch16_224(**kwargs):
    return VisionTransformer(patch_size=16, embed_dim=768, depth=12,
                             num_heads=12, mlp_ratio=4, qkv_bias=True,
                             norm_eps=1e-6, **kwargs)


@register_model
def vit_base_patch16_384(**kwargs):
    return VisionTransformer(img_size=384, patch_size=16, embed_dim=768,
                             depth=12, num_heads=12, mlp_ratio=4,
                             qkv_bias=True, norm_eps=1e-6, **kwargs)


@register_model
def vit_large_patch16_224(**kwargs):
    return VisionTransformer(patch_size=16, embed_dim=1024, depth=24,
                             num_heads=16, mlp_ratio=4, qkv_bias=True,
                             norm_eps=1e-6, **kwargs)


@register_model
def vit_large_patch16_384(**kwargs):
    return VisionTransformer(img_size=384, patch_size=16, embed_dim=1024,
                             depth=24, num_heads=16, mlp_ratio=4,
                             qkv_bias=True, norm_eps=1e-6, **kwargs)
