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
    for s in (8, 600):  # both routes
        x = torch.zeros((1, s, 3 * HEADS * 64), device=cuda)
        with pytest.raises(TypeError):
            TA.fused_qkv_attention(x, HEADS, SCALE)  # fp32: no silent fallback
    # K1 keeps its shared-memory guard; the route sends such lengths to K3
    x = torch.zeros((1, TA.FUSED_QKV_MAX_SEQ + 1, 3 * HEADS * 64),
                    device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K3"):
        TA.fused_qkv_fwd(x, HEADS, SCALE)
    # a statistic of the wrong shape never reaches a kernel
    x = torch.zeros((1, 600, 3 * HEADS * 64), device=cuda, dtype=torch.bfloat16)
    out, lse = TA.packed_flash_fwd(x, HEADS, SCALE, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        TA.packed_flash_bwd(x, out, lse[:, :, :-1].contiguous(), out, HEADS,
                            SCALE)


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


@pytest.mark.cuda
@pytest.mark.parametrize("s", [784, 1000, 1568])
def test_packed_kernels_match_plain_on_card(cuda, s):
    # 1000 and 1568 leave a partial key tile and a partial query tile
    gen = torch.Generator(device=cuda).manual_seed(s)
    x = torch.randn((3, s, 3 * HEADS * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    out, lse = TA.packed_flash_fwd(x, HEADS, SCALE, with_lse=True)
    ref, ref_lse = TA.packed_flash_reference(x, HEADS, SCALE)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    out_nl, none = TA.packed_flash_fwd(x, HEADS, SCALE)
    assert none is None and torch.equal(out_nl, out)
    do = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dqkv = TA.packed_flash_bwd(x, out, lse, do, HEADS, SCALE)
    dref = TA.packed_flash_reference_bwd(x, out, lse, do, HEADS, SCALE).float()
    for part in range(3):  # dq, dk, dv
        sl = slice(part * HEADS * 64, (part + 1) * HEADS * 64)
        tol = 2e-2 * dref[..., sl].abs().max().item()
        assert (dqkv[..., sl].float() - dref[..., sl]).abs().max().item() \
            <= tol, part


@pytest.mark.cuda
def test_autograd_through_the_packed_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 600, 3 * HEADS * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16).requires_grad_(True)
    before = (TA.packed_flash_fwd.launches, TA.packed_flash_dq.launches,
              TA.packed_flash_dkv.launches, TA.fused_qkv_fwd.launches)
    out = TA.fused_qkv_attention(x, HEADS, SCALE)
    out.float().square().sum().backward()
    after = (TA.packed_flash_fwd.launches, TA.packed_flash_dq.launches,
             TA.packed_flash_dkv.launches, TA.fused_qkv_fwd.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 0]
    _, lse = TA.packed_flash_reference(x.detach(), HEADS, SCALE)
    ref = TA.packed_flash_reference_bwd(
        x.detach(), out.detach(), lse, (2 * out.float()).to(torch.bfloat16),
        HEADS, SCALE).float()
    assert (x.grad.float() - ref).abs().max().item() <= \
        2e-2 * ref.abs().max().item()
