"""Int8 quantization for the frozen CLIP teacher's matmuls.

Counterpart of unite_tpu/ops/quant.py in torch's [out, in] weight layout.
The stage-1 teacher is frozen and forward-only, so the four dense layers
of each block (``CLIP_QUANT_DENSE_NAMES``: the qkv ``in_proj``,
``out_proj``, ``mlp.c_fc`` and ``mlp.c_proj``) can run int8 with

* per-output-channel symmetric weight scales, computed once from the fp32
  weights (``quantize_weight``), and
* per-token dynamic symmetric activation scales, one abs-max pass a call
  (``int8_dense``).

The int8 product is K7a (``ops.matmul.int8_matmul``,
csrc/blocked_matmul_wgmma.cu) on the card and its exact plain version on
the CPU; the quantize and dequantize passes around it are eager PyTorch. Every step repeats the JAX
package's arithmetic in the same order, so on the CPU the port's int8
product equals JAX's bit for bit in fp32 and in bf16.

The int8 weight and its fp32 scale are buffers, not Parameters: an int8
tensor cannot require a gradient, and the frozen teacher's
``requires_grad_(False)`` walks every Parameter. The bias stays an fp32
Parameter, added in fp32 before the cast to the output type, as in
``QuantDense``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from unite_torch.ops.matmul import int8_matmul

# The dense layers of a CLIP block that carry most of the teacher's
# operations; conv1 (the patch projection), the LayerNorms and the tap
# projection ``proj`` keep their fp32 weights.
CLIP_QUANT_DENSE_NAMES = ("in_proj", "out_proj", "mlp_c_fc", "mlp_c_proj")


def quantize_weight(w):
    """Symmetric per-output-channel int8 quantization of a [out, in] weight:
    (w_q int8 [out, in], scale fp32 [out]) with w ~ w_q * scale[:, None]."""
    w32 = w.float()
    # a true division on every device: CUDA divides by a Python scalar
    # through its reciprocal, which rounds some scales differently
    scale = w32.abs().amax(dim=1).clamp_min(1e-8) / w32.new_tensor(127.0)
    w_q = torch.round(w32 / scale[:, None]).clamp(-127, 127)
    return w_q.to(torch.int8), scale


def int8_dense(x, w_q, w_scale, bias=None,
               out_dtype: Optional[torch.dtype] = None):
    """y = x . (w_q * w_scale)^T + bias with per-token dynamic int8
    activations. x [..., in]; w_q int8 [out, in]; w_scale fp32 [out];
    bias fp32 [out] or None. Returns ``out_dtype`` (x's by default)."""
    out_dtype = out_dtype or x.dtype
    x32 = x.float()
    s_x = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    x_q = torch.round(x32 / s_x).to(torch.int8)
    acc = int8_matmul(x_q.reshape(-1, x.shape[-1]), w_q)
    y = acc.reshape(*x.shape[:-1], -1).float() * s_x * w_scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


class QuantLinear(nn.Module):
    """Drop-in for ``layers.Linear`` holding a pre-quantized weight: buffers
    ``weight`` int8 [out, in] and ``weight_scale`` fp32 [out], an fp32
    ``bias`` Parameter. Real weights come from ``from_linear`` or a state
    dict; the constructor only fixes shapes and types."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight", torch.zeros(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    @classmethod
    def from_linear(cls, lin) -> "QuantLinear":
        """The int8 form of a ``layers.Linear``, on its device."""
        out_f, in_f = lin.weight.shape
        q = cls(in_f, out_f, lin.bias is not None, lin.dtype).to(
            lin.weight.device)
        q.weight, q.weight_scale = quantize_weight(lin.weight.detach())
        if lin.bias is not None:
            q.bias = nn.Parameter(lin.bias.detach().clone(),
                                  requires_grad=lin.bias.requires_grad)
        return q

    def forward(self, x):
        return int8_dense(x, self.weight, self.weight_scale, self.bias,
                          out_dtype=self.dtype)


def quantize_clip_(model):
    """Turn a CLIP visual tower with fp32 weights into its int8 form, in
    place (unite_tpu ``quantize_clip_params``): in every block the packed
    ``attn.in_proj_weight`` becomes an int8 buffer with
    ``attn.in_proj_weight_scale`` beside it, and ``attn.out_proj``,
    ``mlp.c_fc`` and ``mlp.c_proj`` become ``QuantLinear``s. The state dict
    then has the keys of ``CLIPVisionTransformer(quantize=True)``. Returns
    the model."""
    if model.quantize:
        raise ValueError("the CLIP tower is already int8")
    for blk in model.transformer.resblocks:
        attn, mlp = blk.attn, blk.mlp
        w_q, scale = quantize_weight(attn.in_proj_weight.detach())
        del attn.in_proj_weight
        attn.register_buffer("in_proj_weight", w_q)
        attn.register_buffer("in_proj_weight_scale", scale)
        attn.out_proj = QuantLinear.from_linear(attn.out_proj)
        mlp.c_fc = QuantLinear.from_linear(mlp.c_fc)
        mlp.c_proj = QuantLinear.from_linear(mlp.c_proj)
        attn.quantize = True
    model.quantize = True
    return model
