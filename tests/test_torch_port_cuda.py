"""unite_torch CUDA kernels against their plain versions, on the card.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py sets JAX up). Without a CUDA device
every test here skips.
"""

import pytest
import torch

import unite_torch.ops.attention as TA

HEADS, SCALE = 2, 64 ** -0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [37, 197, 320])
def test_kernels_match_plain_on_card(cuda, s):
    gen = torch.Generator(device=cuda).manual_seed(s)
    x = torch.randn((3, s, 3 * HEADS * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    out, lse = TA.fused_qkv_fwd(x, HEADS, SCALE, with_lse=True)
    ref, ref_lse = TA.qkv_attention_reference(x, HEADS, SCALE)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    do = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dqkv = TA.fused_qkv_bwd(x, out, lse, do, HEADS, SCALE)
    dref = TA.qkv_attention_reference_bwd(x, do, HEADS, SCALE).float()
    tol = 2e-2 * dref.abs().max().item()
    assert (dqkv.float() - dref).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((1, 8, 3 * HEADS * 64), device=cuda)
    with pytest.raises(TypeError):
        TA.fused_qkv_attention(x, HEADS, SCALE)  # fp32: no silent fallback
    x = torch.zeros((1, TA.FUSED_QKV_MAX_SEQ + 1, 3 * HEADS * 64),
                    device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K3"):
        TA.fused_qkv_attention(x, HEADS, SCALE)


@pytest.mark.cuda
def test_autograd_through_the_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((2, 197, 3 * HEADS * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16).requires_grad_(True)
    f0, b0 = TA.fused_qkv_fwd.launches, TA.fused_qkv_bwd.launches
    out = TA.fused_qkv_attention(x, HEADS, SCALE)
    out.float().square().sum().backward()
    assert (TA.fused_qkv_fwd.launches - f0, TA.fused_qkv_bwd.launches - b0) \
        == (1, 1)
    ref = TA.qkv_attention_reference_bwd(
        x.detach(), (2 * out.float()).to(torch.bfloat16), HEADS, SCALE).float()
    assert (x.grad.float() - ref).abs().max().item() <= \
        2e-2 * ref.abs().max().item()
