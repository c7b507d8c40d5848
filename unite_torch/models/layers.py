"""Transformer primitives shared by the port's models.

Counterpart of unite_tpu/models/layers.py, with the same conventions:

* channels-last video [B, T, H, W, C]; tubelet patch embedding as a reshape
  plus one matmul, patch vectors ordered (kt, kh, kw, c); the weight itself
  keeps the Conv3d shape [D, C, kt, p, p] of the reference checkpoints;
* parameters in fp32, compute in ``dtype``: a ``Linear`` casts its input,
  weight and bias to ``dtype`` and returns ``dtype`` (flax
  ``Dense(dtype=..., param_dtype=float32)``), with explicit casts rather
  than autocast so LayerNorm and the loss stay in fp32 where the JAX
  package keeps them;
* LayerNorm statistics in fp32, output in the input dtype;
* attention through ``ops.attention.self_attention``, the JAX package's
  dispatch (K1/K2, K3/K4 or K6; dropout on the probabilities in training
  takes the plain attention, as in JAX);
* dropout and stochastic depth draw from an explicit ``torch.Generator``
  (flax's ``dropout`` rng), in JAX's order within a block: attention
  probabilities, the projection's output, drop path, the MLP's output,
  drop path; ``remat_block`` recomputes a block in the backward with the
  same draws (flax ``nn.remat``).

Parameter names are the reference torch names (``blocks.N.attn.qkv.weight``,
``q_bias``, ``mlp.fc1``, ...), so published checkpoints load unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from unite_torch.ops.attention import keep_mask, self_attention


# flax truncated_normal(stddev): a standard normal cut at +-2, rescaled so
# the cut distribution has the given stddev
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(w: torch.Tensor, stddev: float = 0.02, scale: float = 1.0):
    s = stddev / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=s, a=-2.0 * s, b=2.0 * s)
        w.mul_(scale)
    return w


def get_sinusoid_encoding_table(n_position: int, d_hid: int) -> np.ndarray:
    """Fixed sin/cos positional table, [1, n_position, d_hid] fp32."""
    pos = np.arange(n_position)[:, None]
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None].astype(np.float32)


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm from raw fp32 params; output in x's dtype. Statistics and
    affine in fp32 with one rounding at the output (the JAX package's
    math), through the fused ``F.layer_norm`` kernels. CUDA's layer_norm
    refuses a bf16 input with fp32 params, so x goes in as fp32."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps
                        ).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class Linear(nn.Module):
    """y = x.W^T + b with x, W and b cast to ``dtype`` (fp32 params).

    Under tensor parallelism (``parallel.mesh.tensor_parallel_``) ``tp`` is
    the model axis and ``tp_mode`` "col" (the weight holds this rank's
    output rows; the bias, replicated, is sliced to them) or "row" (the
    weight holds this rank's input columns; the partial products are summed
    over the model group before the bias)."""

    tp = None
    tp_mode = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        nn.init.xavier_uniform_(self.weight)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        tp = self.tp
        w = self.weight.to(self.dtype)
        if tp is not None and self.tp_mode == "row":
            y = tp.reduce_out(F.linear(x.to(self.dtype), w))
            return y if self.bias is None else y + self.bias.to(self.dtype)
        b = self.bias
        if tp is not None:  # column-parallel
            x = tp.copy_in(x)
            b = None if b is None else tp.part(tp.copy_in(b))
        b = b.to(self.dtype) if b is not None else None
        return F.linear(x.to(self.dtype), w, b)


class DropPath(nn.Module):
    """Per-sample stochastic depth on residual branches (timm semantics)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = keep_mask(shape, keep, generator, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), the mask drawn from
    ``generator`` (``F.dropout`` would draw from the global generator);
    nothing is drawn at rate 0 or in evaluation."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not self.training:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = keep_mask(x.shape, keep, generator, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def gelu_for(dtype):
    """tanh GELU under bf16, exact erf GELU otherwise (unite_tpu gelu_for)."""
    if dtype == torch.bfloat16:
        return lambda x: F.gelu(x, approximate="tanh")
    return F.gelu


class Mlp(nn.Module):
    """fc1 -> act -> fc2 -> dropout (JAX's one dropout, after fc2);
    ``act`` defaults to ``gelu_for(dtype)`` and ``out_features`` to
    ``dim``."""

    def __init__(self, dim: int, hidden_features: int, dtype=torch.float32,
                 out_features: Optional[int] = None, act=None,
                 drop: float = 0.0):
        super().__init__()
        self.fc1 = Linear(dim, hidden_features, dtype=dtype)
        self.fc2 = Linear(hidden_features, out_features or dim, dtype=dtype)
        self.act = act or gelu_for(dtype)
        self.drop = Dropout(drop)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.drop(self.fc2(self.act(self.fc1(x))), generator)


class Attention(nn.Module):
    """Multi-head self-attention with the reference's q/v-only bias: the qkv
    bias is cat(q_bias, 0, v_bias). ``attn_drop`` drops attention
    probabilities in training (the plain attention, not a kernel: JAX's
    routing), ``proj_drop`` the projection's output. Under tensor
    parallelism ``tp`` is the model axis: ``qkv`` holds this rank's heads in
    the packed layout, so the kernels run on those heads, and ``proj`` is
    row-parallel."""

    tp = None

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, dtype=torch.float32,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.proj_drop = Dropout(proj_drop)
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim, bias=False, dtype=dtype)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_bias = self.v_bias = None
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        dt = self.qkv.dtype
        heads, q_bias, v_bias = self.num_heads, self.q_bias, self.v_bias
        if self.tp is not None:
            tp = self.tp
            x, heads = tp.copy_in(x), heads // tp.ways
            if q_bias is not None:
                q_bias, v_bias = (tp.part(tp.copy_in(b))
                                  for b in (q_bias, v_bias))
        bias = None
        if q_bias is not None:
            bias = torch.cat([q_bias, torch.zeros_like(q_bias),
                              v_bias]).to(dt)
        qkv = F.linear(x.to(dt), self.qkv.weight.to(dt), bias)
        # fwd_only is JAX's deterministic (models/layers.py:174-175): the
        # training route takes K5 at 385-512 tokens even under no_grad
        out = self_attention(qkv, heads, self.scale,
                             dim=qkv.shape[-1] // 3,
                             fwd_only=not self.training,
                             dropout_rate=self.attn_drop, generator=generator)
        return self.proj_drop(self.proj(out), generator)


class Block(nn.Module):
    """Pre-norm transformer block with optional layer-scale gammas."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 drop_path: float = 0.0, init_values: Optional[float] = None,
                 norm_eps: float = 1e-6, dtype=torch.float32,
                 drop: float = 0.0, attn_drop: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, dtype,
                              attn_drop=attn_drop, proj_drop=drop)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, drop=drop)
        if init_values is not None and init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x, generator: Optional[torch.Generator] = None):
        a = self.attn(self.norm1(x), generator)
        if self.gamma_1 is not None:
            a = a * self.gamma_1.to(a.dtype)
        x = x + self.drop_path(a, generator)
        m = self.mlp(self.norm2(x), generator)
        if self.gamma_2 is not None:
            m = m * self.gamma_2.to(m.dtype)
        return x + self.drop_path(m, generator)


def remat_block(block: nn.Module, x,
                generator: Optional[torch.Generator] = None):
    """``block(x, generator)`` with its activations recomputed in the
    backward instead of kept (non-reentrant ``torch.utils.checkpoint``),
    with flax ``nn.remat``'s semantics: the recompute replays the forward's
    random draws. ``checkpoint``'s ``preserve_rng_state`` saves only the
    global CPU and CUDA generators, and a recompute from the explicit
    ``generator`` as it stands after the forward would draw other masks
    and give wrong gradients without an error; so the generator's state is
    saved before the block, and the recompute draws from a copy of it. The
    caller's generator moves once, in the forward, as without
    checkpointing. The block's kernels run forward twice (their launch
    counters count both)."""
    if generator is None:
        return checkpoint(block, x, None, use_reentrant=False)
    saved = generator.get_state()
    calls = []

    def run(inp):
        gen = generator
        if calls:  # the recompute
            gen = torch.Generator(device=generator.device)
            gen.set_state(saved)
        calls.append(1)
        return block(inp, gen)

    return checkpoint(run, x, use_reentrant=False)


def remat_blocks(depth: int, remat: bool, remat_num: int) -> tuple:
    """Whether each block is recomputed: all under ``remat`` with
    ``remat_num`` < 0, else the first ``remat_num`` (JAX's rule, the
    reference's ``use_checkpoint and idx < checkpoint_num``)."""
    return tuple(remat and (remat_num < 0 or i < remat_num)
                 for i in range(depth))


class TubeletProjection(nn.Module):
    """The patch projection's parameters in Conv3d shape [D, C, kt, p, p]
    (reference checkpoints), applied as one matmul to (kt, kh, kw, c)-ordered
    patch vectors."""

    def __init__(self, in_chans: int, embed_dim: int, tubelet_size: int,
                 patch_size: int, bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(embed_dim, in_chans, tubelet_size, patch_size,
                        patch_size))
        fan_in = in_chans * tubelet_size * patch_size * patch_size
        bound = math.sqrt(6.0 / (fan_in + embed_dim))  # xavier uniform
        nn.init.uniform_(self.weight, -bound, bound)
        self.bias = nn.Parameter(torch.zeros(embed_dim)) if bias else None

    def forward(self, patches):
        d = self.weight.shape[0]
        w = self.weight.permute(0, 2, 3, 4, 1).reshape(d, -1).to(self.dtype)
        b = self.bias.to(self.dtype) if self.bias is not None else None
        return F.linear(patches.to(self.dtype), w, b)


def patchify(x, patch_size: int, tubelet_size: int):
    """[B, T, H, W, C] -> [B, N, ts*p*p*C] patch vectors, N in (t, h, w)
    order, each vector in (kt, kh, kw, c) order."""
    b, t, h, w, c = x.shape
    p, ts = patch_size, tubelet_size
    if t % ts or h % p or w % p:
        raise ValueError(f"video dims ({t},{h},{w}) not divisible by "
                         f"tubelet/patch ({ts},{p})")
    x = x.reshape(b, t // ts, ts, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, (t // ts) * (h // p) * (w // p), ts * p * p * c)


def gather_tokens(x, vis_idx):
    """x [B, N, C], vis_idx [B, N_vis] -> [B, N_vis, C] (order-preserving)."""
    return torch.gather(x, 1, vis_idx[..., None].expand(-1, -1, x.shape[-1]))


class PatchEmbed(nn.Module):
    """Tubelet patch embedding; ``vis_idx`` gathers the raw patch vectors
    before the projection (row-wise identical to gathering after)."""

    def __init__(self, embed_dim: int = 768, patch_size: int = 16,
                 tubelet_size: int = 2, in_chans: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.patch_size, self.tubelet_size = patch_size, tubelet_size
        self.proj = TubeletProjection(in_chans, embed_dim, tubelet_size,
                                      patch_size, bias=True, dtype=dtype)

    def forward(self, x, vis_idx=None):
        x = patchify(x, self.patch_size, self.tubelet_size)
        if vis_idx is not None:
            x = gather_tokens(x, vis_idx)
        return self.proj(x)


def num_patches(img_size: int, patch_size: int, num_frames: int,
                tubelet_size: int) -> int:
    return (img_size // patch_size) ** 2 * (num_frames // tubelet_size)


class LinearDecoder(nn.Module):
    """Linear projection + LayerNorm + optional L2-norm to CLIP space."""

    def __init__(self, in_dim: int, out_dim: int = 512,
                 clip_norm_type: str = "l2", norm_eps: float = 1e-6,
                 dtype=torch.float32):
        super().__init__()
        if clip_norm_type not in ("l2", "none"):
            raise NotImplementedError(clip_norm_type)
        self.clip_norm_type = clip_norm_type
        self.head = Linear(in_dim, out_dim, dtype=dtype)
        self.norm = LayerNorm(out_dim, norm_eps)

    def forward(self, x):
        x = self.norm(self.head(x))
        if self.clip_norm_type == "l2":
            x32 = x.float()
            x = (x32 / torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
                 ).to(x.dtype)
        return x
