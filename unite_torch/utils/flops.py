"""FLOP counting for the ViT families (unite_tpu/utils/flops.py).

Closed-form matmul counts (``vit_block_flops``, ``vit_flops``), and
``count_flops``, which counts what a callable runs through
``torch.utils.flop_counter.FlopCounterMode`` (JAX's XLA cost analysis).
That mode sees the aten ops a call dispatches (matrix products,
convolutions, PyTorch's attention); on the card the attention kernels run
outside the dispatcher (``ops.attention``), so a count there leaves them
out, and on the CPU their plain versions are counted.
"""

from __future__ import annotations

from typing import Callable, Optional


def vit_block_flops(tokens: int, dim: int, mlp_ratio: float = 4.0) -> int:
    """Matmul FLOPs of one pre-norm transformer block (fwd)."""
    qkv = 2 * tokens * dim * 3 * dim
    attn = 2 * 2 * tokens * tokens * dim
    proj = 2 * tokens * dim * dim
    mlp = 2 * 2 * tokens * dim * int(dim * mlp_ratio)
    return qkv + attn + proj + mlp


def vit_flops(tokens: int, dim: int = 768, depth: int = 12,
              mlp_ratio: float = 4.0, patch_dim: int = 16 * 16 * 3,
              num_classes: int = 0) -> int:
    """Forward FLOPs of a full ViT on ``tokens`` tokens (one clip)."""
    total = 2 * tokens * patch_dim * dim  # patch embed
    total += depth * vit_block_flops(tokens, dim, mlp_ratio)
    if num_classes:
        total += 2 * dim * num_classes
    return total


def count_flops(fn: Callable, *args, **kwargs) -> Optional[float]:
    """FLOPs that ``fn(*args, **kwargs)`` dispatches, counted by
    ``FlopCounterMode`` (a backward inside ``fn`` counts too), or None
    where the count cannot be taken."""
    try:
        from torch.utils.flop_counter import FlopCounterMode

        mode = FlopCounterMode(display=False)
        with mode:
            fn(*args, **kwargs)
        return float(mode.get_total_flops())
    except Exception:
        return None
