"""unite_torch CUDA kernels against their plain versions, on the card.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py sets JAX up). Without a CUDA device
every test here skips.
"""

import pytest
import torch

import unite_torch.ops.attention as TA
import unite_torch.ops.matmul as MM
import unite_torch.ops.quant as Q

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
        x = torch.zeros((1, s, 3 * HEADS * 64), device=cuda,
                        dtype=torch.float16)
        with pytest.raises(TypeError):
            TA.fused_qkv_attention(x, HEADS, SCALE)  # fp16: no kernel takes it
    # K1 keeps its shared-memory guard; the route sends such lengths to
    # K3/K4 or K6
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
    s0 = TA.fused_qkv_fwd.by_shape[(2, 197)]
    out = TA.fused_qkv_attention(x, HEADS, SCALE)
    out.float().square().sum().backward()
    assert (TA.fused_qkv_fwd.launches - f0, TA.fused_qkv_bwd.launches - b0) \
        == (1, 1)
    assert TA.fused_qkv_fwd.by_shape[(2, 197)] - s0 == 1
    ref = TA.qkv_attention_reference_bwd(
        x.detach(), (2 * out.float()).to(torch.bfloat16), HEADS, SCALE).float()
    assert (x.grad.float() - ref).abs().max().item() <= \
        2e-2 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [784, 1000, 1568, 4608])
def test_packed_kernels_match_plain_on_card(cuda, s):
    # 1000 and 1568 leave a partial key tile and a partial query tile;
    # 4608 is the 384 ViTs' 8 frames of 24^2 patches
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
def test_packed_kernels_at_6_heads_on_card(cuda):
    """K3 with lse, K4a and K4b on the VideoMAE decoder's lanes: 6 heads,
    [B, 1568, 1152] (a 2304-byte row), each repeat of the backward equal
    to the first."""
    heads, s = 6, 1568
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((2, s, 3 * heads * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    out, lse = TA.packed_flash_fwd(x, heads, SCALE, with_lse=True)
    ref, ref_lse = TA.packed_flash_reference(x, heads, SCALE)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    do = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dqkv = TA.packed_flash_bwd(x, out, lse, do, heads, SCALE)
    dref = TA.packed_flash_reference_bwd(x, out, lse, do, heads,
                                         SCALE).float()
    for part in range(3):  # dq, dk, dv
        sl = slice(part * heads * 64, (part + 1) * heads * 64)
        tol = 2e-2 * dref[..., sl].abs().max().item()
        assert (dqkv[..., sl].float() - dref[..., sl]).abs().max().item() \
            <= tol, part
    for _ in range(3):
        assert torch.equal(TA.packed_flash_bwd(x, out, lse, do, heads, SCALE),
                           dqkv)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1568, 4608])
def test_packed_kernels_at_16_heads_on_card(cuda, s):
    """K3 with lse, K4a and K4b on the ViT-L/16 finetunes' lanes: 16
    heads, [B, S, 3072] (a 6144-byte row) at 224^2 and at 384^2, within
    the 6-head test's tolerances, each repeat of the backward equal to
    the first."""
    heads = 16
    gen = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn((2, s, 3 * heads * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    out, lse = TA.packed_flash_fwd(x, heads, SCALE, with_lse=True)
    ref, ref_lse = TA.packed_flash_reference(x, heads, SCALE)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    do = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dqkv = TA.packed_flash_bwd(x, out, lse, do, heads, SCALE)
    dref = TA.packed_flash_reference_bwd(x, out, lse, do, heads,
                                         SCALE).float()
    for part in range(3):  # dq, dk, dv
        sl = slice(part * heads * 64, (part + 1) * heads * 64)
        tol = 2e-2 * dref[..., sl].abs().max().item()
        assert (dqkv[..., sl].float() - dref[..., sl]).abs().max().item() \
            <= tol, part
    for _ in range(3):
        assert torch.equal(TA.packed_flash_bwd(x, out, lse, do, heads, SCALE),
                           dqkv)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(32, 160), (64, 320)])
def test_fused_qkv_kernels_at_the_large_pretraining_shapes(cuda, b, s):
    """K1 with lse and K2 at the VideoMAE-L encoder's [32, 160, 3072] (tube
    mask 0.9) and the UMT-L student's [64, 320, 3072] (mask 0.8): 16 heads
    of 64 at the cells' batches."""
    heads = 16
    gen = torch.Generator(device=cuda).manual_seed(b + s)
    x = torch.randn((b, s, 3 * heads * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    out, lse = TA.fused_qkv_fwd(x, heads, SCALE, with_lse=True)
    ref, ref_lse = TA.qkv_attention_reference(x, heads, SCALE)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    do = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dqkv = TA.fused_qkv_bwd(x, out, lse, do, heads, SCALE)
    dref = TA.qkv_attention_reference_bwd(x, do, heads, SCALE).float()
    assert (dqkv.float() - dref).abs().max().item() <= \
        2e-2 * dref.abs().max().item()
    assert torch.equal(TA.fused_qkv_bwd(x, out, lse, do, heads, SCALE), dqkv)


@pytest.mark.cuda
def test_packed_kernels_at_the_videomae_l_decoder_on_card(cuda):
    """K3 with lse, K4a and K4b at the VideoMAE-L decoder's [32, 1568, 1536]
    (8 heads of 64, a 3072-byte row), within the 6-head test's tolerances,
    each repeat of the backward equal to the first."""
    heads, b, s = 8, 32, 1568
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn((b, s, 3 * heads * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    out, lse = TA.packed_flash_fwd(x, heads, SCALE, with_lse=True)
    ref, ref_lse = TA.packed_flash_reference(x, heads, SCALE)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    del ref, ref_lse
    do = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dqkv = TA.packed_flash_bwd(x, out, lse, do, heads, SCALE)
    dref = TA.packed_flash_reference_bwd(x, out, lse, do, heads,
                                         SCALE).float()
    for part in range(3):  # dq, dk, dv
        sl = slice(part * heads * 64, (part + 1) * heads * 64)
        tol = 2e-2 * dref[..., sl].abs().max().item()
        assert (dqkv[..., sl].float() - dref[..., sl]).abs().max().item() \
            <= tol, part
    for _ in range(3):
        assert torch.equal(TA.packed_flash_bwd(x, out, lse, do, heads, SCALE),
                           dqkv)


def _flash_inputs(cuda, b, s, seed, strided):
    """q, k, v [B, H, S, 64] bf16: contiguous, or the strided views of a
    qkv projection output that the models pass."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if strided:
        qkv = torch.randn((b, s, 3 * HEADS * 64), generator=gen, device=cuda
                          ).to(torch.bfloat16)
        return TA._split_heads(qkv, HEADS), gen
    return [torch.randn((b, HEADS, s, 64), generator=gen, device=cuda
                        ).to(torch.bfloat16) for _ in range(3)], gen


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("s", [577, 785, 1569, 4609])
def test_flash_kernels_match_plain_on_card(cuda, s, strided):
    # none of these lengths has a divisor query block: partial tiles
    # (4609: the 384 ViTs' CLS readout)
    (q, k, v), gen = _flash_inputs(cuda, 3, s, s, strided)
    out, lse = TA.flash_fwd(q, k, v, SCALE, with_lse=True)
    ref, ref_lse = TA.flash_reference(q, k, v, scale=SCALE)
    assert out.stride() == TA._empty_like_rows(q).stride()
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    out_nl, none = TA.flash_fwd(q, k, v, SCALE)
    assert none is None and torch.equal(out_nl, out)
    do = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    got = TA.flash_bwd(q, k, v, out, lse, do, SCALE)
    refs = TA.flash_reference_bwd(q, k, v, out, lse, do, scale=SCALE)
    for name, a, r in zip("qkv", got, refs):
        tol = 2e-2 * r.float().abs().max().item()
        assert (a.float() - r.float()).abs().max().item() <= tol, name


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [2, 12])
@pytest.mark.parametrize("s", [1, 7, 64, 127, 128, 129, 577, 1568, 1569, 2048])
def test_flash_forward_lengths_on_card(cuda, s, heads):
    # csrc/flash_fwd_wgmma.cu (K3 and K6) around its 128-row q and k/v
    # tiles, on contiguous tensors, strided qkv views and the packed lanes;
    # each call counts one launch, the lse only when asked for, and repeats
    # bit for bit
    gen = torch.Generator(device=cuda).manual_seed(s * heads)
    qkv = torch.randn((2, s, 3 * heads * 64), generator=gen, device=cuda
                      ).to(torch.bfloat16)
    views = TA._split_heads(qkv, heads)
    dense = [t.contiguous() for t in views]
    ref, ref_lse = TA.flash_reference(*dense, scale=SCALE)

    def counts(fn):
        return fn.launches, fn.lse_launches

    for layout, (q, k, v) in (("contiguous", dense), ("views", views)):
        c0 = counts(TA.flash_fwd)
        out, lse = TA.flash_fwd(q, k, v, SCALE, with_lse=True)
        assert counts(TA.flash_fwd) == (c0[0] + 1, c0[1] + 1)
        again, _ = TA.flash_fwd(q, k, v, SCALE, with_lse=True)
        out_nl, none = TA.flash_fwd(q, k, v, SCALE)
        assert counts(TA.flash_fwd) == (c0[0] + 3, c0[1] + 2)
        assert out.stride() == TA._empty_like_rows(q).stride()
        assert _max_err(out, ref) <= 1e-2, layout
        assert _max_err(lse, ref_lse) <= 1e-3, layout
        assert torch.equal(again, out) and torch.equal(out_nl, out), layout
        assert none is None

    pref, plse = TA.packed_flash_reference(qkv, heads, SCALE)
    c0 = counts(TA.packed_flash_fwd)
    out, lse = TA.packed_flash_fwd(qkv, heads, SCALE, with_lse=True)
    assert counts(TA.packed_flash_fwd) == (c0[0] + 1, c0[1] + 1)
    again, _ = TA.packed_flash_fwd(qkv, heads, SCALE, with_lse=True)
    out_nl, none = TA.packed_flash_fwd(qkv, heads, SCALE)
    assert counts(TA.packed_flash_fwd) == (c0[0] + 3, c0[1] + 2)
    assert _max_err(out, pref) <= 1e-2 and _max_err(lse, plse) <= 1e-3
    assert torch.equal(again, out) and torch.equal(out_nl, out)
    assert none is None


def _bwd_within(got, refs, what):
    """Each gradient within 2e-2 of the largest |dq|, |dk| or |dv| of the
    plain version (at S = 1, dq and dk are 0 up to rounding noise)."""
    tol = 2e-2 * max(r.float().abs().max().item() for r in refs)
    for name, a, r in zip(("dq", "dk", "dv"), got, refs):
        assert bool(torch.isfinite(a).all()), (what, name)
        assert _max_err(a, r) <= tol, (what, name, _max_err(a, r), tol)


def _bwd_inputs(cuda, b, s, heads, seed):
    """qkv, its strided views and their contiguous copies, with the plain
    forward's o and lse2 and a cotangent do."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * heads * 64), generator=gen, device=cuda
                      ).to(torch.bfloat16)
    views = TA._split_heads(qkv, heads)
    dense = [t.contiguous() for t in views]
    o, lse = TA.flash_reference(*dense, scale=SCALE)
    do = torch.randn(o.shape, generator=gen, device=cuda).to(torch.bfloat16)
    return qkv, views, dense, o, lse, do


def _flash_bwd_layouts(views, dense, o, lse, do):
    """K6's backward on contiguous tensors and on strided qkv views (o and
    do laid out as the models lay them out): the counters move by one dq
    and one dk/dv launch a call, and a repeat is equal bit for bit."""
    o_rows, do_rows = (TA._empty_like_rows(views[0]).copy_(x)
                       for x in (o, do))
    results = {}
    for layout, args in (("contiguous", (*dense, o, lse, do)),
                         ("views", (*views, o_rows, lse, do_rows))):
        c0 = (TA.flash_dq.launches, TA.flash_dkv.launches)
        got = TA.flash_bwd(*args, SCALE)
        again = TA.flash_bwd(*args, SCALE)
        assert (TA.flash_dq.launches, TA.flash_dkv.launches) == (
            c0[0] + 2, c0[1] + 2)
        for a, b in zip(got, again):
            assert torch.equal(a, b), layout
        results[layout] = got
    return results


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [2, 12])
@pytest.mark.parametrize("s", [1, 7, 64, 127, 128, 129, 577, 1568, 1569, 2048])
def test_flash_backward_lengths_on_card(cuda, s, heads):
    # csrc/flash_bwd_wgmma.cu (K4a/K4b and K6's dq and dk/dv) around its
    # 128-row resident and 64-row streamed tiles, on contiguous tensors,
    # strided qkv views and the packed lanes, from the plain forward's o
    # and lse2; no atomics, so repeats are equal bit for bit
    qkv, views, dense, o, lse, do = _bwd_inputs(cuda, 2, s, heads,
                                                200 + s * heads)
    refs = TA.flash_reference_bwd(*dense, o, lse, do, scale=SCALE)
    for layout, got in _flash_bwd_layouts(views, dense, o, lse, do).items():
        _bwd_within(got, refs, layout)
    out, g = TA._merge_heads(o), TA._merge_heads(do)
    c0 = (TA.packed_flash_dq.launches, TA.packed_flash_dkv.launches)
    dqkv = TA.packed_flash_bwd(qkv, out, lse, g, heads, SCALE)
    again = TA.packed_flash_bwd(qkv, out, lse, g, heads, SCALE)
    assert (TA.packed_flash_dq.launches, TA.packed_flash_dkv.launches) == (
        c0[0] + 2, c0[1] + 2)
    assert torch.equal(dqkv, again)
    _bwd_within([TA._heads_of(x, heads) for x in dqkv.chunk(3, dim=-1)],
                refs, "packed")


@pytest.mark.cuda
def test_flash_backward_at_16_heads_on_card(cuda):
    # the clip_l14_336 teacher's [40, 16, 577, 64] (577 = 4*128 + 65)
    _, views, dense, o, lse, do = _bwd_inputs(cuda, 40, 577, 16, 577)
    refs = TA.flash_reference_bwd(*dense, o, lse, do, scale=SCALE)
    for layout, got in _flash_bwd_layouts(views, dense, o, lse, do).items():
        _bwd_within(got, refs, layout)


@pytest.mark.cuda
def test_autograd_through_multi_head_attention(cuda):
    (q, k, v), _ = _flash_inputs(cuda, 2, 600, 2, strided=False)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    before = [getattr(TA, n).launches for n in ("flash_fwd", "flash_dq",
                                                "flash_dkv")]
    out = TA.multi_head_attention(*leaves, scale=SCALE)
    out.float().square().sum().backward()
    after = [getattr(TA, n).launches for n in ("flash_fwd", "flash_dq",
                                               "flash_dkv")]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    o, lse = TA.flash_reference(q, k, v, scale=SCALE)
    refs = TA.flash_reference_bwd(q, k, v, out.detach(), lse,
                                  (2 * out.float()).to(torch.bfloat16),
                                  scale=SCALE)
    for leaf, r in zip(leaves, refs):
        tol = 2e-2 * r.float().abs().max().item()
        assert (leaf.grad.float() - r.float()).abs().max().item() <= tol
    with pytest.raises(TypeError):
        TA.multi_head_attention(q.half(), k.half(), v.half())


@pytest.mark.cuda
def test_model_route_takes_k6_on_strided_views(cuda):
    # 1569 = 1568 + CLS has no divisor block: the route runs K6 on views of
    # qkv, and the gradient reaches qkv
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 1569, 3 * HEADS * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16).requires_grad_(True)
    f0, p0 = TA.flash_fwd.launches, TA.packed_flash_fwd.launches
    out = TA.self_attention(x, HEADS, SCALE)
    out.float().square().sum().backward()
    assert (TA.flash_fwd.launches - f0, TA.packed_flash_fwd.launches - p0) \
        == (1, 0)
    _, lse = TA.packed_flash_reference(x.detach(), HEADS, SCALE)
    ref = TA.packed_flash_reference_bwd(
        x.detach(), out.detach(), lse, (2 * out.float()).to(torch.bfloat16),
        HEADS, SCALE).float()
    assert (x.grad.float() - ref).abs().max().item() <= \
        2e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_autograd_through_the_packed_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 600, 3 * HEADS * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16).requires_grad_(True)
    before = (TA.packed_flash_fwd.launches, TA.packed_flash_dq.launches,
              TA.packed_flash_dkv.launches, TA.fused_qkv_fwd.launches,
              TA.packed_flash_fwd.by_shape[(2, 600)])
    out = TA.fused_qkv_attention(x, HEADS, SCALE)
    out.float().square().sum().backward()
    after = (TA.packed_flash_fwd.launches, TA.packed_flash_dq.launches,
             TA.packed_flash_dkv.launches, TA.fused_qkv_fwd.launches,
             TA.packed_flash_fwd.by_shape[(2, 600)])
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 0, 1]
    _, lse = TA.packed_flash_reference(x.detach(), HEADS, SCALE)
    ref = TA.packed_flash_reference_bwd(
        x.detach(), out.detach(), lse, (2 * out.float()).to(torch.bfloat16),
        HEADS, SCALE).float()
    assert (x.grad.float() - ref).abs().max().item() <= \
        2e-2 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("s", [100, 392, 393, 512])
def test_grouped_kernels_match_plain_on_card(cuda, s, strided):
    # K5: 392 is stage 1 at mask 0.75, 393 a ragged key tile, 512 the
    # route's edge
    (q, k, v), gen = _flash_inputs(cuda, 3, s, s + 1, strided)
    out, (m, l) = TA.grouped_fwd(q, k, v, SCALE, with_stats=True)
    ref, ref_m, ref_l = TA.grouped_reference(q, k, v, scale=SCALE)
    assert out.stride() == TA._empty_like_rows(q).stride()
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert (m - ref_m).abs().max().item() <= 1e-3  # raw scores, fp32 sums
    assert ((l - ref_l).abs() / ref_l).max().item() <= 1e-4
    out_ns, none = TA.grouped_fwd(q, k, v, SCALE)
    assert none is None and torch.equal(out_ns, out)
    do = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    got = TA.grouped_bwd(q, k, v, do, m, l, SCALE)
    refs = TA.grouped_reference_bwd(q, k, v, do, scale=SCALE)
    for name, a, r in zip("qkv", got, refs):
        tol = 2e-2 * r.float().abs().max().item()
        assert (a.float() - r.float()).abs().max().item() <= tol, name


@pytest.mark.cuda
def test_model_route_takes_k5_in_training_at_392(cuda):
    # stage 1 at mask 0.75: 392 tokens in training take K5 on views of qkv
    # (no K2 above 384); forward-only they take K1
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2, 392, 3 * HEADS * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16).requires_grad_(True)
    names = ("grouped_fwd", "grouped_dq", "grouped_dkv", "fused_qkv_fwd",
             "fused_qkv_bwd")
    before = [getattr(TA, n).launches for n in names]
    out = TA.self_attention(x, HEADS, SCALE, dim=768)
    out.float().square().sum().backward()
    TA.self_attention(x.detach(), HEADS, SCALE, dim=768, fwd_only=True)
    after = [getattr(TA, n).launches for n in names]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1, 0]
    q, k, v = (t.contiguous() for t in TA._split_heads(x.detach(), HEADS))
    refs = TA.grouped_reference_bwd(
        q, k, v, TA._heads_of((2 * out.float()).to(torch.bfloat16), HEADS),
        scale=SCALE)
    ref = torch.cat([TA._merge_heads(r) for r in refs], dim=-1).float()
    assert (x.grad.float() - ref).abs().max().item() <= \
        2e-2 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [197, 320])
def test_fused_qkv_kernels_at_16_heads(cuda, s):
    # ViT-L/14 widths: 16 heads of 64 (qkv 3072 wide); 197 is the clip_l14
    # teacher at 196^2, 320 the large student at mask 0.8
    gen = torch.Generator(device=cuda).manual_seed(s + 16)
    x = torch.randn((3, s, 3 * 16 * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    out, lse = TA.fused_qkv_fwd(x, 16, SCALE, with_lse=True)
    ref, ref_lse = TA.qkv_attention_reference(x, 16, SCALE)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    do = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dqkv = TA.fused_qkv_bwd(x, out, lse, do, 16, SCALE)
    dref = TA.qkv_attention_reference_bwd(x, do, 16, SCALE).float()
    assert (dqkv.float() - dref).abs().max().item() <= \
        2e-2 * dref.abs().max().item()


# the short backward's lengths (csrc/short_bwd_wgmma.cu, K2 and K5's
# backward): around its 64-row tiles and chunks, the paths' own (320, 392)
# and, for K2, its shared-memory guard FUSED_QKV_MAX_SEQ
SHORT_LENGTHS = [1, 7, 8, 9, 63, 64, 65, 127, 128, 129, 196, 197, 208, 255,
                 256, 257, 314, 320, 384, 385, 392, 511, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [2, 12, 16])
@pytest.mark.parametrize("s", SHORT_LENGTHS + [768])
def test_short_backward_k2_lengths_on_card(cuda, s, heads):
    # K2 on the packed lanes, from K1's out and lse2; no atomics, so a
    # repeat is equal bit for bit
    gen = torch.Generator(device=cuda).manual_seed(300 + s * heads)
    x = torch.randn((2, s, 3 * heads * 64), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    out, lse = TA.fused_qkv_fwd(x, heads, SCALE, with_lse=True)
    do = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    b0 = TA.fused_qkv_bwd.launches
    dqkv = TA.fused_qkv_bwd(x, out, lse, do, heads, SCALE)
    again = TA.fused_qkv_bwd(x, out, lse, do, heads, SCALE)
    assert TA.fused_qkv_bwd.launches == b0 + 2
    assert torch.equal(dqkv, again)
    dref = TA.qkv_attention_reference_bwd(x, do, heads, SCALE)
    _bwd_within([TA._heads_of(t, heads) for t in dqkv.chunk(3, dim=-1)],
                [TA._heads_of(t, heads) for t in dref.chunk(3, dim=-1)],
                "packed")


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [2, 12])
@pytest.mark.parametrize("s", SHORT_LENGTHS)
def test_short_backward_k5_lengths_on_card(cuda, s, heads):
    # K5's backward on strided qkv views (do laid out as the models lay it
    # out) and on contiguous tensors, from the K5 forward's m and l
    qkv, views, dense, _, _, do = _bwd_inputs(cuda, 2, s, heads,
                                              400 + s * heads)
    refs = TA.grouped_reference_bwd(*dense, do, scale=SCALE)
    do_rows = TA._empty_like_rows(views[0]).copy_(do)
    for layout, (q, k, v), g in (("views", views, do_rows),
                                 ("contiguous", dense, do)):
        _, (m, l) = TA.grouped_fwd(q, k, v, SCALE, with_stats=True)
        c0 = (TA.grouped_dq.launches, TA.grouped_dkv.launches)
        got = TA.grouped_bwd(q, k, v, g, m, l, SCALE)
        again = TA.grouped_bwd(q, k, v, g, m, l, SCALE)
        assert (TA.grouped_dq.launches, TA.grouped_dkv.launches) == (
            c0[0] + 2, c0[1] + 2)
        for a, b in zip(got, again):
            assert torch.equal(a, b), layout
        _bwd_within(got, refs, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k2", "k5_views", "k5_contiguous"])
def test_short_backward_repeats_at_main_path_batch_on_card(cuda, kernel):
    # at the main path's B=64 and 12 heads the persistent blocks walk many
    # tiles across heads, where a race between a ring slot's reads and its
    # next TMA write shows (at B=2 it need not): five repeats equal the first
    heads = 12
    if kernel == "k2":
        qkv, _, _, _, _, _ = _bwd_inputs(cuda, 64, 320, heads, 500)
        out, lse = TA.fused_qkv_fwd(qkv, heads, SCALE, with_lse=True)
        do = torch.randn(out.shape, device=cuda).to(torch.bfloat16)

        def run():
            return (TA.fused_qkv_bwd(qkv, out, lse, do, heads, SCALE),)
    else:
        _, views, dense, _, _, do = _bwd_inputs(cuda, 64, 392, heads, 501)
        x = views if kernel == "k5_views" else dense
        if kernel == "k5_views":  # do laid out as the models lay it out
            do = TA._empty_like_rows(views[0]).copy_(do)
        _, (m, l) = TA.grouped_fwd(*x, SCALE, with_stats=True)

        def run():
            return TA.grouped_bwd(*x, do, m, l, SCALE)
    first = run()
    for _ in range(5):
        assert all(torch.equal(a, b) for a, b in zip(run(), first)), kernel


# head dim 80 (pretrain_videomae_huge_patch16_224: the encoder's 16 heads
# of 80 lanes, [B, S, 3840], and the decoder's 8, [B, 1568, 1920]): K1 at
# the short lengths up to its route's 512, K2 up to its 384
D80 = 80
SCALE80 = D80 ** -0.5


@pytest.mark.cuda
@pytest.mark.parametrize("s", SHORT_LENGTHS)
def test_head_dim80_short_kernels_on_card(cuda, s):
    heads = 16
    gen = torch.Generator(device=cuda).manual_seed(600 + s)
    x = torch.randn((2, s, 3 * heads * D80), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    out, lse = TA.fused_qkv_fwd(x, heads, SCALE80, with_lse=True)
    ref, ref_lse = TA.qkv_attention_reference(x, heads, SCALE80)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    out_nl, none = TA.fused_qkv_fwd(x, heads, SCALE80)
    assert none is None and torch.equal(out_nl, out)
    if s > TA.FUSED_QKV_TRAIN_MAX_SEQ:
        return
    do = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dqkv = TA.fused_qkv_bwd(x, out, lse, do, heads, SCALE80)
    assert torch.equal(TA.fused_qkv_bwd(x, out, lse, do, heads, SCALE80),
                       dqkv)
    dref = TA.qkv_attention_reference_bwd(x, do, heads, SCALE80)
    _bwd_within([TA._heads_of(t, heads) for t in dqkv.chunk(3, dim=-1)],
                [TA._heads_of(t, heads) for t in dref.chunk(3, dim=-1)],
                "packed")


@pytest.mark.cuda
def test_head_dim80_packed_kernels_on_card(cuda):
    """K3 with lse, K4a and K4b on the huge decoder's lanes: 8 heads of 80,
    [2, 1568, 1920], each repeat of the backward equal to the first."""
    heads, s = 8, 1568
    gen = torch.Generator(device=cuda).manual_seed(80)
    x = torch.randn((2, s, 3 * heads * D80), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    out, lse = TA.packed_flash_fwd(x, heads, SCALE80, with_lse=True)
    ref, ref_lse = TA.packed_flash_reference(x, heads, SCALE80)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    do = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dqkv = TA.packed_flash_bwd(x, out, lse, do, heads, SCALE80)
    dref = TA.packed_flash_reference_bwd(x, out, lse, do, heads,
                                         SCALE80).float()
    for part in range(3):  # dq, dk, dv
        sl = slice(part * heads * D80, (part + 1) * heads * D80)
        tol = 2e-2 * dref[..., sl].abs().max().item()
        assert (dqkv[..., sl].float() - dref[..., sl]).abs().max().item() \
            <= tol, part
    for _ in range(3):
        assert torch.equal(TA.packed_flash_bwd(x, out, lse, do, heads,
                                               SCALE80), dqkv)


@pytest.mark.cuda
def test_head_dim80_refusals_on_card(cuda):
    # every kernel takes head dims 64 and 80 and nothing else: no plain
    # fallback
    x = torch.zeros((1, 160, 3 * 2 * 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"head dims \(64, 80\)"):
        TA.fused_qkv_fwd(x, 2, 96 ** -0.5)
    for s in (392, 632):  # K5, K6
        q = torch.zeros((1, 2, s, 96), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=r"head dims \(64, 80\)"):
            TA.multi_head_attention(q, q, q, scale=96 ** -0.5)
    x = torch.zeros((1, 513, 3 * 2 * D80), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K3"):
        TA.fused_qkv_fwd(x, 2, SCALE80)


def _d80_inputs(cuda, b, s, heads, seed):
    """qkv [B, S, 3*H*80], its strided views and their contiguous copies,
    and a cotangent in each layout (laid out as the models lay it out for
    the views)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * heads * D80), generator=gen, device=cuda
                      ).to(torch.bfloat16)
    views = TA._split_heads(qkv, heads)
    dense = [t.contiguous() for t in views]
    do = torch.randn(dense[0].shape, generator=gen, device=cuda
                     ).to(torch.bfloat16)
    do_rows = TA._empty_like_rows(views[0]).copy_(do)
    return (("views", views, do_rows), ("contiguous", dense, do))


def _d80_grouped(layouts, repeats=1):
    """K5 at head dim 80 on each layout against its plain version: o, m
    and l, then dq, dk and dv from the kernel's m and l; each of
    ``repeats`` backwards equal to the first bit for bit."""
    for layout, x, do in layouts:
        out, (m, l) = TA.grouped_fwd(*x, SCALE80, with_stats=True)
        ref, ref_m, ref_l = TA.grouped_reference(*x, scale=SCALE80)
        assert out.stride() == TA._empty_like_rows(x[0]).stride()
        assert _max_err(out, ref) <= 1e-2, layout
        assert _max_err(m, ref_m) <= 1e-3, layout
        assert ((l - ref_l).abs() / ref_l).max().item() <= 1e-4, layout
        out_ns, none = TA.grouped_fwd(*x, SCALE80)
        assert none is None and torch.equal(out_ns, out), layout
        got = TA.grouped_bwd(*x, do, m, l, SCALE80)
        _bwd_within(got, TA.grouped_reference_bwd(*x, do, scale=SCALE80),
                    layout)
        for _ in range(repeats):
            again = TA.grouped_bwd(*x, do, m, l, SCALE80)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), layout


def _d80_flash(layouts, repeats=1):
    """K6 at head dim 80 on each layout against its plain version: o and
    lse2 (and o without the lse), then dq, dk and dv from the kernel's o
    and lse2; each of ``repeats`` backwards equal to the first."""
    for layout, x, do in layouts:
        out, lse = TA.flash_fwd(*x, SCALE80, with_lse=True)
        ref, ref_lse = TA.flash_reference(*x, scale=SCALE80)
        assert out.stride() == TA._empty_like_rows(x[0]).stride()
        assert _max_err(out, ref) <= 1e-2, layout
        assert _max_err(lse, ref_lse) <= 1e-3, layout
        out_nl, none = TA.flash_fwd(*x, SCALE80)
        assert none is None and torch.equal(out_nl, out), layout
        got = TA.flash_bwd(*x, out, lse, do, SCALE80)
        _bwd_within(got, TA.flash_reference_bwd(*x, out, lse, do,
                                                scale=SCALE80), layout)
        for _ in range(repeats):
            again = TA.flash_bwd(*x, out, lse, do, SCALE80)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), layout


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [2, 8])
@pytest.mark.parametrize("s", SHORT_LENGTHS)
def test_head_dim80_grouped_lengths_on_card(cuda, s, heads):
    # K5 at head dim 80 (csrc/short_attn_wgmma.cu's forward, the dq and
    # dk/dv kernels of csrc/short_bwd_wgmma.cu) on views and contiguous
    # tensors, up to the route's 512
    _d80_grouped(_d80_inputs(cuda, 2, s, heads, 700 + s * heads))


@pytest.mark.cuda
def test_head_dim80_grouped_at_the_encoder_shape_on_card(cuda):
    # the huge VideoMAE's encoder at mask 0.75: [16, 16, 392, 80], where the
    # persistent blocks walk many tiles across heads; five repeats
    _d80_grouped(_d80_inputs(cuda, 16, 392, 16, 780), repeats=5)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [2, 8])
@pytest.mark.parametrize("s", [1, 7, 64, 127, 128, 129, 577, 632, 1568, 1569,
                               2048])
def test_head_dim80_flash_lengths_on_card(cuda, s, heads):
    # K6 at head dim 80 (csrc/flash_fwd_wgmma.cu, csrc/flash_bwd_wgmma.cu)
    # on views and contiguous tensors
    _d80_flash(_d80_inputs(cuda, 2, s, heads, 800 + s * heads))


@pytest.mark.cuda
def test_head_dim80_flash_at_the_encoder_shape_on_card(cuda):
    # the huge encoder at mask 0.6 (632 tokens) and with a CLS token (1569)
    _d80_flash(_d80_inputs(cuda, 2, 632, 16, 881), repeats=5)
    _d80_flash(_d80_inputs(cuda, 2, 1569, 16, 882), repeats=2)


@pytest.mark.cuda
@pytest.mark.parametrize("s,kernel", [(392, "grouped"), (472, "grouped"),
                                      (632, "flash")])
def test_head_dim80_model_route_takes_k5_k6_on_card(cuda, s, kernel):
    # the huge encoder's route in training at masks 0.75, 0.7 and 0.6: a
    # width of 1280 over 16 heads, views of qkv, one launch of each kernel
    heads = 16
    gen = torch.Generator(device=cuda).manual_seed(s)
    x = torch.randn((2, s, 3 * heads * D80), generator=gen, device=cuda
                    ).to(torch.bfloat16).requires_grad_(True)
    names = [f"{kernel}_{n}" for n in ("fwd", "dq", "dkv")] + [
        "fused_qkv_fwd", "fused_qkv_bwd", "packed_flash_fwd"]
    before = [getattr(TA, n).launches for n in names]
    out = TA.self_attention(x, heads, SCALE80, dim=heads * D80)
    out.float().square().sum().backward()
    assert [getattr(TA, n).launches - b for n, b in zip(names, before)] == [
        1, 1, 1, 0, 0, 0]
    dense = [t.contiguous() for t in TA._split_heads(x.detach(), heads)]
    do = TA._heads_of((2 * out.float()).to(torch.bfloat16), heads)
    ref = (TA.grouped_reference_bwd(*dense, do, scale=SCALE80)
           if kernel == "grouped" else TA.flash_reference_bwd(
               *dense, *TA.flash_reference(*dense, scale=SCALE80), do,
               scale=SCALE80))
    ref = torch.cat([TA._merge_heads(r) for r in ref], dim=-1).float()
    assert _max_err(x.grad, ref) <= 2e-2 * ref.abs().max().item()


# K7's card shapes: ragged M and N (N % 4 != 0 and N % 8 != 0 take the
# direct store, the others the TMA store), K not a multiple of the kernel's
# 128-byte box (32, 96, 800 elements), one row, M below and above one wave
# of 128-row tiles on 132 SMs (N = 256: two tiles a band), and the int8
# clip_l14 teacher's four dense layers at a small M; K = 0, an empty sum
MATMUL_SHAPES = [(1, 32, 8), (130, 96, 257), (394, 768, 2304),
                 (300, 4096, 1024), (129, 32, 7), (257, 96, 12),
                 (200, 800, 20), (1, 800, 4), (1, 1024, 1),
                 (128 * 60, 64, 256), (128 * 70 + 3, 64, 256),
                 (200, 1024, 3072), (200, 1024, 1024), (200, 1024, 4096),
                 (200, 4096, 1024), (3, 0, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_int8_matmul_matches_plain_bitwise_on_card(cuda, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    x8 = torch.randint(-128, 128, (m, k), generator=gen, device=cuda,
                       dtype=torch.int8)
    w8 = torch.randint(-128, 128, (n, k), generator=gen, device=cuda,
                       dtype=torch.int8)
    before = MM.int8_matmul.launches
    out = MM.int8_matmul(x8, w8)
    assert MM.int8_matmul.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (m, n)
    assert torch.equal(out, MM.int8_matmul_reference(x8, w8))
    assert torch.equal(out.cpu(), MM.int8_matmul_reference(x8.cpu(), w8.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 16, 8)] + MATMUL_SHAPES)
def test_bf16_matmul_matches_plain_on_card(cuda, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn((n, k), generator=gen, device=cuda).to(torch.bfloat16)
    out = MM.bf16_matmul(x, w)
    ref = MM.bf16_matmul_reference(x, w)
    # one fp32 sum rounded once on both sides: one bf16 ulp of |ref|, plus
    # the fp32 summation-order term near zero
    assert ((out.float() - ref.float()).abs()
            <= MM.bf16_tolerance(x, w, ref)).all()
    # small integers: every partial sum is exact in fp32, so the one
    # rounding at the end is the only one, and the results are equal
    xi = torch.randint(-8, 9, (m, k), generator=gen, device=cuda).to(
        torch.bfloat16)
    wi = torch.randint(-8, 9, (n, k), generator=gen, device=cuda).to(
        torch.bfloat16)
    assert torch.equal(MM.bf16_matmul(xi, wi), MM.bf16_matmul_reference(xi, wi))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", MM.TILES)
@pytest.mark.parametrize("m,k,n", [(394, 768, 2304), (130, 96, 257),
                                   (300, 4096, 1024)])
def test_matmul_tiles_match_plain_on_card(cuda, tile, m, k, n):
    # every tile shape of the kernel, bit for bit (K7a) and on small
    # integers (K7b, whose fp32 partial sums are then exact)
    gen = torch.Generator(device=cuda).manual_seed(m * k)
    x8 = torch.randint(-128, 128, (m, k), generator=gen, device=cuda,
                       dtype=torch.int8)
    w8 = torch.randint(-128, 128, (n, k), generator=gen, device=cuda,
                       dtype=torch.int8)
    assert torch.equal(MM.int8_matmul(x8, w8, tile=tile),
                       MM.int8_matmul_reference(x8, w8))
    # small integers in [-8, 7]: every fp32 partial sum is exact
    xi, wi = ((t.to(torch.int32) // 16).to(torch.bfloat16) for t in (x8, w8))
    assert torch.equal(MM.bf16_matmul(xi, wi, tile=tile),
                       MM.bf16_matmul_reference(xi, wi))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [12, 5])
def test_int8_matmul_exact_at_the_largest_k_on_card(cuda, n):
    # -128 everywhere at the largest K the card takes: every sum is
    # 131040 * 2^14 = 2146959360, just below 2^31 (both store routes)
    k = MM.INT8_MAX_K // 32 * 32
    assert k == 131040
    x8 = torch.full((3, k), -128, dtype=torch.int8, device=cuda)
    w8 = torch.full((n, k), -128, dtype=torch.int8, device=cuda)
    out = MM.int8_matmul(x8, w8)
    assert torch.equal(out, MM.int8_matmul_reference(x8, w8))
    assert out.eq(k * 128 * 128).all()


@pytest.mark.cuda
def test_matmul_repeats_are_equal_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x8 = torch.randint(-128, 128, (394, 768), generator=gen, device=cuda,
                       dtype=torch.int8)
    w8 = torch.randint(-128, 128, (2304, 768), generator=gen, device=cuda,
                       dtype=torch.int8)
    assert torch.equal(MM.int8_matmul(x8, w8), MM.int8_matmul(x8, w8))
    x, w = x8.to(torch.bfloat16), w8.to(torch.bfloat16)
    assert torch.equal(MM.bf16_matmul(x, w), MM.bf16_matmul(x, w))


@pytest.mark.cuda
def test_matmul_kernels_refuse_what_they_do_not_take(cuda):
    x8 = torch.zeros((4, 48), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        MM.int8_matmul(x8, x8)  # K = 48: no fallback on the card
    xb = torch.zeros((4, 24), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        MM.bf16_matmul(xb, xb)
    x8 = torch.zeros((64, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        MM.int8_matmul(x8[:, :32], x8[:8, :32])
    with pytest.raises(TypeError):
        MM.int8_matmul(x8.float(), x8.float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_dense_on_card_equals_the_cpu(cuda, dtype):
    # the quantizers and the dequantize pass are exactly rounded ops (the
    # weight scale a true division) and K7a is exact, so the card's int8
    # weights and dense layer equal the CPU's bit for bit
    gen = torch.Generator().manual_seed(7)
    w = torch.randn((192, 128), generator=gen)
    x = (3 * torch.randn((2, 37, 128), generator=gen)).to(dtype)
    b = torch.randn(192, generator=gen)
    w_q, scale = Q.quantize_weight(w)
    w_q_card, scale_card = Q.quantize_weight(w.to(cuda))
    assert torch.equal(w_q_card.cpu(), w_q) and torch.equal(scale_card.cpu(),
                                                            scale)
    ref = Q.int8_dense(x, w_q, scale, b)
    before = MM.int8_matmul.launches
    out = Q.int8_dense(x.to(cuda), w_q_card, scale_card, b.to(cuda))
    assert MM.int8_matmul.launches == before + 1
    assert out.dtype == dtype and torch.equal(out.cpu(), ref)


@pytest.mark.cuda
def test_stage2_entry_runs_on_card_through_k3_k4(cuda, tmp_path):
    # run_stage2.main on the card at a tiny width: a ViT of depth 2, width
    # 128 and 2 heads over 4 frames of 224^2 (784 tokens: K3 forward, K4
    # backward), 2 train steps of 2, one validation call, one test call
    import json

    from unite_torch.config import parse_with_config
    from unite_torch.models.vit import VisionTransformer
    from unite_torch.train import run_stage2
    from unite_torch.train.args import stage2_parser
    from unite_torch.utils.registry import _MODEL_REGISTRY, register_model

    if "vit_card_tiny" not in _MODEL_REGISTRY:
        @register_model
        def vit_card_tiny(**kwargs):
            return VisionTransformer(embed_dim=128, depth=2, num_heads=2,
                                     mlp_ratio=2, **kwargs)

    for name, n in (("train", 4), ("val", 3), ("test", 2)):
        (tmp_path / f"{name}.csv").write_text("".join(
            f"{name}/v{i}.mp4,{i % 3}\n" for i in range(n)))
    args = parse_with_config(stage2_parser(), [
        "--model", "vit_card_tiny", "--nb_classes", "3", "--num_frames", "4",
        "--tubelet_size", "1", "--input_size", "224",
        "--short_side_size", "224", "--batch_size", "2",
        "--batch_size_val", "4", "--epochs", "1", "--warmup_epochs", "0",
        "--test_num_segment", "1", "--test_num_crop", "1", "--split", ",",
        "--synthetic_data", "true", "--device_normalize", "true",
        "--num_workers", "2", "--output_dir", str(tmp_path / "run"),
        "--ann_file_train", str(tmp_path / "train.csv"),
        "--ann_file_val", str(tmp_path / "val.csv"),
        "--ann_file_test", str(tmp_path / "test.csv")])
    kernels = (TA.packed_flash_fwd, TA.packed_flash_dq, TA.packed_flash_dkv)
    before = [k.launches for k in kernels]
    lse_before = TA.packed_flash_fwd.lse_launches
    run_stage2.main(args)
    launched = [k.launches - b for k, b in zip(kernels, before)]
    # 2 blocks: 2 steps forward and backward, 1 val and 1 test call forward
    assert launched == [2 * (2 + 1 + 1), 2 * 2, 2 * 2]
    assert TA.packed_flash_fwd.lse_launches - lse_before == 2 * 2
    logs = [json.loads(x) for x in
            (tmp_path / "run" / "log.txt").read_text().splitlines()]
    assert [r["epoch"] for r in logs] == [0, 1]
    assert torch.isfinite(torch.tensor(logs[0]["train_loss"]))
    assert 0.0 <= logs[1]["test_acc1"] <= 100.0


@pytest.mark.cuda
def test_stage3_entry_runs_on_card(cuda, tmp_path):
    # run_stage3.main on the card at a tiny width, chained from a stage-2
    # checkpoint of the port: a student of depth 2, width 128 and 2 heads
    # over 4 frames of 224^2 (784 tokens: K3 forward, K4 backward; the
    # committee's 156 visible tokens: K1, K2), a CLIP teacher of the same
    # width (197 tokens: K1), 2 train steps of 2 + 2 clips, the initial and
    # the epoch's validation and one test call
    import json

    import numpy as np

    from unite_torch.config import parse_with_config
    from unite_torch.models.adaptation import AdaptationVisionTransformer
    from unite_torch.models.clip import CLIPVisionTransformer
    from unite_torch.models.vit import VisionTransformer
    from unite_torch.train import run_stage3
    from unite_torch.train.args import stage3_parser
    from unite_torch.utils import checkpoint as ck
    from unite_torch.utils.registry import _MODEL_REGISTRY, register_model

    if "adaptation_card_tiny" not in _MODEL_REGISTRY:
        @register_model
        def adaptation_card_tiny(**kwargs):
            for k in ("clip_decoder_embed_dim", "clip_output_dim"):
                kwargs.pop(k, None)
            return AdaptationVisionTransformer(
                encoder_embed_dim=128, encoder_depth=2, encoder_num_heads=2,
                mlp_ratio=2, clip_decoder_embed_dim=128, clip_output_dim=64,
                **kwargs)

        @register_model
        def clip_b16_card_tiny(**kwargs):
            return CLIPVisionTransformer(patch_size=16, width=128, layers=2,
                                         heads=2, output_dim=64, **kwargs)

    vit = VisionTransformer(embed_dim=128, depth=2, num_heads=2, mlp_ratio=2,
                            num_classes=3, all_frames=4, tubelet_size=1)
    ck.save_checkpoint(str(tmp_path / "s2"), 0, vit.state_dict(),
                       optimizer={"count": 0, "moments": {}}, tags=("best",))
    np.save(tmp_path / "text.npy", np.random.default_rng(0).standard_normal(
        (3, 64)).astype(np.float32))
    for name, n in (("src", 4), ("tgt", 4), ("val", 3), ("test", 2)):
        (tmp_path / f"{name}.csv").write_text("".join(
            f"{name}/v{i}.mp4,{i % 3}\n" for i in range(n)))
    args = parse_with_config(stage3_parser(), [
        "--model", "adaptation_card_tiny", "--clip_teacher",
        "clip_b16_card_tiny", "--clip_return_layers", "1", "--nb_classes", "3",
        "--num_frames", "4", "--tubelet_size", "1", "--input_size", "224",
        "--short_side_size", "224", "--clip_input_resolution", "224",
        "--mask_ratio", "0.8", "--batch_size", "2", "--batch_size_val", "4",
        "--epochs", "1", "--warmup_epochs", "0", "--test_num_segment", "1",
        "--test_num_crop", "1", "--split", ",", "--synthetic_data", "true",
        "--device_normalize", "true", "--num_workers", "2",
        "--initial_validation", "true", "--checkpoints_enabled", "true",
        "--output_dir", str(tmp_path / "run"),
        "--student_init", str(tmp_path / "s2" / "checkpoint-best.pth"),
        "--clip_text_features", str(tmp_path / "text.npy"),
        "--ann_file_train", str(tmp_path / "src.csv"),
        "--ann_file_train_target", str(tmp_path / "tgt.csv"),
        "--ann_file_val", str(tmp_path / "val.csv"),
        "--ann_file_test", str(tmp_path / "test.csv")])
    kernels = (TA.fused_qkv_fwd, TA.fused_qkv_bwd, TA.packed_flash_fwd,
               TA.packed_flash_dq, TA.packed_flash_dkv)
    before = [k.launches for k in kernels]
    run_stage3.main(args)
    launched = [k.launches - b for k, b in zip(kernels, before)]
    # 2 blocks: a step's teacher, grad member and zero-shot forwards (K1),
    # the grad member's backward (K2), the source and target full passes
    # (K3) and the source backward (K4); 3 eval calls (K3)
    assert launched == [2 * 3 * 2, 2 * 2, 2 * (2 * 2 + 3), 2 * 2, 2 * 2]
    logs = [json.loads(x) for x in
            (tmp_path / "run" / "log.txt").read_text().splitlines()]
    assert [r["epoch"] for r in logs] == [0, 1]
    assert torch.isfinite(torch.tensor(logs[0]["train_loss"]))
    assert "cmp_student_acc" in logs[0] and "train_sel_ratio" in logs[0]
    assert 0.0 <= logs[1]["test_acc1"] <= 100.0
    saved = ck.load_checkpoint(str(tmp_path / "run" / "checkpoint-latest.pth"))
    head = vit.state_dict()
    assert torch.equal(saved["model"]["classifier.weight"].cpu(),
                       head["head.weight"])


@pytest.mark.cuda
def test_clip_l14_336_zero_shot_runs_k6_on_card(cuda, tmp_path):
    # the stage-3 zero-shot teacher clip_l14_336 at its native 336^2, cut
    # to 2 blocks at full width (1024, 16 heads of 64), on 5 clips of 8
    # frames of 224^2: each block's 40 frames of 577 tokens take K6's
    # forward without lse on the strided qkv views, 2 launches at (40, 577)
    # and nothing else; the same call on the plain route (the plain K6 in
    # place of the kernel) gives the same similarities within 2e-2
    from types import SimpleNamespace

    import numpy as np

    from unite_torch.models.clip import CLIPVisionTransformer
    from unite_torch.models.clip_text import build_zero_shot_fn

    np.save(tmp_path / "text.npy", np.random.default_rng(0).standard_normal(
        (12, 768)).astype(np.float32))
    torch.manual_seed(0)
    teacher = CLIPVisionTransformer(
        input_resolution=336, patch_size=14, width=1024, layers=2, heads=16,
        output_dim=768, return_attn=True, return_index=(1,),
        dtype=torch.bfloat16).to(cuda)
    zero_shot = build_zero_shot_fn(SimpleNamespace(
        clip_text_features=str(tmp_path / "text.npy"),
        clip_input_resolution=336), teacher)
    videos = torch.randint(0, 256, (5, 8, 224, 224, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    wrappers = ("fused_qkv_fwd", "packed_flash_fwd", "grouped_fwd",
                "flash_fwd")
    before = [getattr(TA, n).launches for n in wrappers]
    shape0 = TA.flash_fwd.by_shape[(40, 577)]
    lse0 = TA.flash_fwd.lse_launches
    sim = zero_shot(videos)
    torch.cuda.synchronize()
    assert [getattr(TA, n).launches - b for n, b in zip(wrappers, before)] \
        == [0, 0, 0, 2]
    assert TA.flash_fwd.by_shape[(40, 577)] - shape0 == 2
    assert TA.flash_fwd.lse_launches == lse0

    def plain(q, k, v, *, scale=None, **_):
        return TA.flash_reference(q, k, v, scale=scale)[0]

    mha, TA.multi_head_attention = TA.multi_head_attention, plain
    try:
        ref = zero_shot(videos)
    finally:
        TA.multi_head_attention = mha
    assert TA.flash_fwd.launches - before[-1] == 2
    assert sim.shape == (5, 12) and bool(torch.isfinite(sim).all())
    assert (sim - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_remat_is_bit_equal_on_card_through_k1_k2(cuda):
    # an adaptation student of width 128 (2 heads) over 4 frames of 64^2
    # (64 tokens: K1 forward, K2 backward) at drop path 0.1 and dropout
    # 0.1, bf16: with every block recomputed the output and the gradients
    # are the plain step's bit for bit, and K1 runs twice per block
    from unite_torch.models.adaptation import AdaptationVisionTransformer

    kw = dict(img_size=64, patch_size=16, encoder_embed_dim=128,
              encoder_depth=2, encoder_num_heads=2, num_frames=4,
              tubelet_size=1, clip_decoder_embed_dim=128,
              clip_output_dim=64, clip_return_layers=(0, 1),
              drop_path_rate=0.1, drop_rate=0.1, dtype=torch.bfloat16)
    torch.manual_seed(0)
    sd = AdaptationVisionTransformer(**kw).state_dict()
    x = torch.randn(3, 4, 64, 64, 3, device=cuda)
    w = torch.randn(2, 3, 64, 64, device=cuda)
    results = []
    for remat in (False, True):
        m = AdaptationVisionTransformer(**kw, remat=remat).to(cuda).train()
        m.load_state_dict(sd)
        g = torch.Generator(device="cuda").manual_seed(5)
        k1, k2 = TA.fused_qkv_fwd.launches, TA.fused_qkv_bwd.launches
        out = m(x, clip_only=True, generator=g)
        (out.float() * w).sum().backward()
        torch.cuda.synchronize()
        results.append((out, {n: p.grad for n, p in m.named_parameters()},
                        TA.fused_qkv_fwd.launches - k1,
                        TA.fused_qkv_bwd.launches - k2))
    (o0, g0, k1_0, k2_0), (o1, g1, k1_1, k2_1) = results
    assert (k1_0, k2_0, k1_1, k2_1) == (2, 2, 4, 2)
    assert torch.equal(o0, o1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


@pytest.mark.cuda
def test_attention_dropout_skips_the_kernels_in_training_on_card(cuda):
    # JAX's routing: attention dropout in training takes the plain
    # attention; evaluation keeps K3 (784 tokens)
    from unite_torch.models.vit import VisionTransformer

    m = VisionTransformer(embed_dim=128, depth=2, num_heads=2, mlp_ratio=2,
                          num_classes=3, all_frames=4, tubelet_size=1,
                          attn_drop_rate=0.1, dtype=torch.bfloat16).to(cuda)
    x = torch.randn(2, 4, 224, 224, 3, device=cuda)
    g = torch.Generator(device="cuda").manual_seed(1)
    before = TA.packed_flash_fwd.launches
    m.train()(x, g).float().sum().backward()
    torch.cuda.synchronize()
    assert TA.packed_flash_fwd.launches == before
    with torch.no_grad():
        m.eval()(x)
    torch.cuda.synchronize()
    assert TA.packed_flash_fwd.launches == before + 2


@pytest.mark.cuda
def test_stage2_recipe_entry_runs_on_card(cuda, tmp_path):
    # run_stage2.main on the card at a tiny width with the finetune recipe:
    # mixup and cutmix, dropout, every block recomputed (K3 twice per block
    # and step), a bf16 first moment; 2 train steps of 2, one validation
    # and one test call
    import json

    from unite_torch.config import parse_with_config
    from unite_torch.models.vit import VisionTransformer
    from unite_torch.train import run_stage2
    from unite_torch.train.args import stage2_parser
    from unite_torch.utils import checkpoint as ck
    from unite_torch.utils.registry import _MODEL_REGISTRY, register_model

    if "vit_card_tiny" not in _MODEL_REGISTRY:
        @register_model
        def vit_card_tiny(**kwargs):
            return VisionTransformer(embed_dim=128, depth=2, num_heads=2,
                                     mlp_ratio=2, **kwargs)

    for name, n in (("train", 4), ("val", 3), ("test", 2)):
        (tmp_path / f"{name}.csv").write_text("".join(
            f"{name}/v{i}.mp4,{i % 3}\n" for i in range(n)))
    args = parse_with_config(stage2_parser(), [
        "--model", "vit_card_tiny", "--nb_classes", "3", "--num_frames", "4",
        "--tubelet_size", "1", "--input_size", "224",
        "--short_side_size", "224", "--batch_size", "2",
        "--batch_size_val", "4", "--epochs", "1", "--warmup_epochs", "0",
        "--test_num_segment", "1", "--test_num_crop", "1", "--split", ",",
        "--synthetic_data", "true", "--device_normalize", "true",
        "--num_workers", "2", "--output_dir", str(tmp_path / "run"),
        "--mixup", "0.8", "--cutmix", "1.0", "--mixup_prob", "1.0",
        "--smoothing", "0.1", "--drop", "0.1", "--fc_drop_rate", "0.5",
        "--use_checkpoint", "true", "--mu_dtype", "bfloat16",
        "--ann_file_train", str(tmp_path / "train.csv"),
        "--ann_file_val", str(tmp_path / "val.csv"),
        "--ann_file_test", str(tmp_path / "test.csv")])
    kernels = (TA.packed_flash_fwd, TA.packed_flash_dq, TA.packed_flash_dkv)
    before = [k.launches for k in kernels]
    lse_before = TA.packed_flash_fwd.lse_launches
    run_stage2.main(args)
    launched = [k.launches - b for k, b in zip(kernels, before)]
    # 2 blocks: 2 steps forward twice (remat) and backward once, 1 val and
    # 1 test call forward
    assert launched == [2 * (2 * 2 + 1 + 1), 2 * 2, 2 * 2]
    assert TA.packed_flash_fwd.lse_launches - lse_before == 2 * 2 * 2
    logs = [json.loads(x) for x in
            (tmp_path / "run" / "log.txt").read_text().splitlines()]
    assert [r["epoch"] for r in logs] == [0, 1]
    assert torch.isfinite(torch.tensor(logs[0]["train_loss"]))
    assert "train_class_acc" not in logs[0]
    saved = ck.load_checkpoint(str(tmp_path / "run" / "checkpoint-latest.pth"))
    assert {m["mu"].dtype for m in saved["optimizer"]["moments"].values()} \
        == {torch.bfloat16}


# ------------------------------------------------ the fp32 kernels

# around the forward's 32- and 64-query tiles, dQ's 64-, 80- and 112-query
# tiles, dK/dV's 64- to 128-key tiles and the streamed 64-row tiles, and
# the paths' own lengths
FP32_LENGTHS = [1, 7, 31, 32, 33, 63, 64, 65, 79, 80, 81, 111, 112, 113, 127,
                128, 129, 197, 320, 392, 577, 1568, 1569, 2048]
# enough clips for the entries' wider tiles at their edges (each takes the
# tile whose grid costs least: here the forward's 64 query rows at 33-64
# and 97-128 keys, dQ's 80 queries at 65-80, 129-160 and 225-240 and 112
# at 81-112 and 193-224, dK/dV's 64 keys up to 64, then 80, 96, 112, 128)
FP32_WIDE_B = 132
FP32_EDGES = [31, 32, 33, 63, 64, 65, 79, 80, 81, 95, 96, 97, 111, 112, 113,
              127, 128, 129, 159, 160, 161, 223, 224, 225]


def _fp32_within(got, refs, what, fwd_tol=1e-5, bwd_rtol=1e-4):
    """o within ``fwd_tol`` max abs, each gradient within ``bwd_rtol`` of
    its largest value (csrc/attn_fp32.cu against attention_fp32_reference:
    fp32 throughout, the sums in another order); at one key, where dq and
    dk vanish and hold rounding noise, of dv's."""
    one_key = refs[0].shape[2] == 1
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, refs):
        r_max = (refs[-1] if one_key else r).abs().max().item()
        tol = fwd_tol if name == "o" else bwd_rtol * r_max
        err = (a - r).abs().max().item()
        assert err <= tol, f"{what} {name}: {err} > {tol}"


def _fp32_check(cuda, b, s, d, packed):
    """The three fp32 entries against the plain version on [b, 3, s, d]:
    contiguous tensors, or views of a packed qkv [b, s, 3*3*d] (the packed
    routes' layout) with the gradients laid out as the views."""
    gen = torch.Generator(device=cuda).manual_seed(s + d + b)
    if packed:
        qkv = torch.randn((b, s, 9 * d), generator=gen, device=cuda)
        q, k, v = TA._split_heads(qkv, 3)
    else:
        q, k, v = (torch.randn((b, 3, s, d), generator=gen, device=cuda)
                   for _ in range(3))
    g = torch.randn((b, 3, s, d), generator=gen, device=cuda)
    scale = d ** -0.5
    o, lse = TA.attention_fp32_reference(q, k, v, scale)
    refs = (o,) + TA.attention_fp32_reference_bwd(q, k, v, o, lse, g, scale)
    got, got_lse = TA.fp32_attn_fwd(q, k, v, scale, with_lse=True)
    assert (got_lse - lse).abs().max().item() <= 1e-5
    dq, dk, dv = (TA._empty_like_rows(x) for x in (q, k, v))
    delta = torch.empty((b, 3, s), device=cuda)
    TA.fp32_attn_dq(q, k, v, o, g, lse, dq, delta, scale)
    TA.fp32_attn_dkv(q, k, v, g, lse, delta, dk, dv, scale)
    _fp32_within((got, dq, dk, dv), refs,
                 f"B={b} S={s} D={d} packed={packed}")


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("s", FP32_LENGTHS)
def test_fp32_kernels_match_plain_on_card(cuda, s, d, packed):
    _fp32_check(cuda, 2, s, d, packed)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("s", FP32_EDGES)
def test_fp32_wide_tiles_match_plain_on_card(cuda, s, d):
    _fp32_check(cuda, FP32_WIDE_B, s, d, True)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [197, 392, 1568, 1569])
def test_fp32_route_launches_the_fp32_kernels_on_card(cuda, s):
    # the models' route at fp32: K1/K2, K5, K3/K4 or K6 by length, each on
    # the fp32 kernels and none of the bf16 ones
    gen = torch.Generator(device=cuda).manual_seed(s)
    heads, d = 2, 64
    qkv = torch.randn((2, s, 3 * heads * d), generator=gen, device=cuda)
    route = {197: "K1", 392: "K5", 1568: "K3", 1569: "K6"}[s]
    wrappers = ("fused_qkv_fwd", "fused_qkv_bwd", "packed_flash_fwd",
                "packed_flash_dq", "packed_flash_dkv", "flash_fwd",
                "flash_dq", "flash_dkv", "grouped_fwd", "grouped_dq",
                "grouped_dkv")
    before = [getattr(TA, n).launches for n in wrappers]
    by_route = TA.fp32_attn_fwd.by_route[route]
    x = qkv.clone().requires_grad_(True)
    out = TA.self_attention(x, heads, SCALE, dim=heads * d)
    out.square().sum().backward()
    assert [getattr(TA, n).launches for n in wrappers] == before
    assert TA.fp32_attn_fwd.by_route[route] == by_route + 1
    ref = TA._merge_heads(TA.attention_fp32_reference(
        *TA._split_heads(qkv, heads), SCALE)[0])
    assert (out - ref).abs().max().item() <= 1e-5
    y = qkv.clone().requires_grad_(True)
    TA._merge_heads(TA.attention_reference(*TA._split_heads(y, heads),
                                           scale=SCALE)).square().sum(
                                               ).backward()
    tol = 1e-4 * y.grad.abs().max().item()
    assert (x.grad - y.grad).abs().max().item() <= tol
