"""unite_torch ``utils.flops`` and ``utils.torch_export`` against unite_tpu on
the CPU.

Export: the port's state of bridged weights is the reference layout
already, so ``export_state`` must equal unite_tpu's
``flax_params_to_state`` of the same flax tree bit for bit, key for key,
for a ViT, an adaptation student, VideoMAE and a UMT student; a port
stage-3 checkpoint exports like the JAX one, its head as
``src_classifier``. FLOPs: the closed forms are JAX's; ``count_flops``
(FlopCounterMode) agrees with them on a tiny ViT.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unite_tpu.models import adaptation as jad
from unite_tpu.models import pretrain_umt as jumt
from unite_tpu.models import pretrain_videomae as jmae
from unite_tpu.models import vit as jvit
from unite_tpu.utils import checkpoint as jck
from unite_tpu.utils import flops as jflops
from unite_tpu.utils import torch_export as jexport
from unite_torch.models import adaptation as tad
from unite_torch.models import layers as tl
from unite_torch.models import pretrain_umt as tumt
from unite_torch.models import pretrain_videomae as tmae
from unite_torch.models import vit as tvit
from unite_torch.train.run_stage3 import combine
from unite_torch.utils import checkpoint as tck
from unite_torch.utils import flops as tflops
from unite_torch.utils import torch_export as texport
from unite_torch.utils.flax_bridge import flax_to_state_dict

VIDEO = (1, 4, 32, 32, 3)
ADAPT = dict(img_size=32, patch_size=16, encoder_embed_dim=128,
             encoder_depth=2, encoder_num_heads=2, num_frames=4,
             tubelet_size=1, clip_decoder_embed_dim=128, clip_output_dim=64,
             clip_return_layers=(0, 1))
MODELS = {
    "vit": (jvit.VisionTransformer, tvit.VisionTransformer,
            dict(img_size=32, patch_size=16, num_classes=10, embed_dim=128,
                 depth=2, num_heads=2, all_frames=4, tubelet_size=1,
                 init_values=0.1, classifier_type="mlp"), 1),
    "adaptation": (jad.AdaptationVisionTransformer,
                   tad.AdaptationVisionTransformer,
                   dict(ADAPT, use_cls_token=True,
                        use_learnable_pos_emb=True), 2),
    "videomae": (jmae.PretrainVideoMAE, tmae.PretrainVideoMAE,
                 dict(img_size=32, patch_size=16, encoder_embed_dim=128,
                      encoder_depth=2, encoder_num_heads=2,
                      decoder_num_classes=768, decoder_embed_dim=64,
                      decoder_depth=1, decoder_num_heads=1, num_frames=4,
                      tubelet_size=1), 3),
    "umt": (jumt.PretrainUMT, tumt.PretrainUMT,
            dict(img_size=32, patch_size=16, encoder_embed_dim=128,
                 encoder_depth=3, encoder_num_heads=2, num_frames=4,
                 tubelet_size=1, clip_decoder_embed_dim=128,
                 clip_output_dim=64, clip_return_layer=2), 1),
}


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def flax_params(kind):
    jcls, _, cfg, n_args = MODELS[kind]
    x = jnp.zeros(VIDEO)
    args = {1: (x,), 2: (x, jnp.tile(jnp.arange(8)[None], (1, 1))),
            3: (x, jnp.arange(10)[None], jnp.arange(10, 16)[None])}[n_args]
    p = jcls(**cfg).init(jax.random.PRNGKey(0), *args)["params"]
    return perturb(p, 4)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_export_state_is_the_reference_export(kind):
    p = flax_params(kind)
    tm = MODELS[kind][1](**MODELS[kind][2])
    tm.load_state_dict(flax_to_state_dict(p), strict=True)
    got = texport.export_state(tm)
    ref = jexport.flax_params_to_state(p)
    assert list(got) == list(tm.state_dict())
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        assert torch.equal(got[k], ref[k]), k
    got[next(iter(got))].add_(1.0)  # a copy, not the model's tensor
    assert not torch.equal(tm.state_dict()[next(iter(got))],
                           got[next(iter(got))])


def test_keys_outside_the_reference_layout_raise():
    with pytest.raises(ValueError, match="reference layout"):
        texport.export_state({"blocks.0.attn.qkv.weight": torch.zeros(1),
                              "transformer.resblocks.0.ln_1.weight":
                                  torch.zeros(1)})
    with pytest.raises(ValueError, match="reference layout"):
        texport.export_state({"norm.weight_scale": torch.zeros(1)})
    with pytest.raises(ValueError, match="unhandled student param"):
        flax_to_state_dict({"encoder": {"adapter": {"kernel": np.zeros(2)}}})
    with pytest.raises(ValueError, match="unhandled student param"):
        flax_to_state_dict({"decoder": {"head": {"kernel_q": np.zeros(2)}}})


def test_export_checkpoint_stage3_matches_jax(tmp_path):
    """A combined stage-3 checkpoint: the student under ``model``, the
    head under ``src_classifier``, the epoch; equal to JAX's export of the
    same weights."""
    sp = flax_params("adaptation")
    rng = np.random.default_rng(5)
    head = {"kernel": rng.standard_normal((128, 12)).astype(np.float32),
            "bias": rng.standard_normal(12).astype(np.float32)}
    student = tad.AdaptationVisionTransformer(**MODELS["adaptation"][2])
    student.load_state_dict(flax_to_state_dict(sp))
    classifier = tl.Linear(128, 12)
    classifier.load_state_dict({"weight": torch.from_numpy(head["kernel"].T),
                                "bias": torch.from_numpy(head["bias"])})
    tck.save_checkpoint(str(tmp_path / "port"), 3,
                        combine(student, classifier).state_dict())
    got = torch.load(texport.export_checkpoint(
        str(tmp_path / "port" / "checkpoint-latest.pth"),
        str(tmp_path / "port.pth")), weights_only=False)
    jck.save_checkpoint(str(tmp_path / "jax"), 3,
                        {"model": sp, "classifier": head})
    ref = torch.load(jexport.export_checkpoint(
        str(tmp_path / "jax" / "checkpoint-latest.msgpack"),
        str(tmp_path / "jax.pth")), weights_only=False)
    assert set(got) == set(ref) == {"model", "epoch", "src_classifier"}
    assert got["epoch"] == ref["epoch"] == 3
    for part in ("model", "src_classifier"):
        assert set(got[part]) == set(ref[part])
        for k in ref[part]:
            assert torch.equal(got[part][k], ref[part][k]), (part, k)


def test_export_checkpoint_plain_student(tmp_path):
    p = flax_params("umt")
    tm = tumt.PretrainUMT(**MODELS["umt"][2])
    tm.load_state_dict(flax_to_state_dict(p))
    tck.save_checkpoint(str(tmp_path), 7, tm.state_dict())
    out = torch.load(texport.export_checkpoint(
        str(tmp_path / "checkpoint-latest.pth"), str(tmp_path / "out.pth")),
        weights_only=False)
    assert set(out) == {"model", "epoch"} and out["epoch"] == 7
    ref = jexport.flax_params_to_state(p)
    assert all(torch.equal(out["model"][k], ref[k]) for k in ref)


@pytest.mark.parametrize("tokens,dim,depth,ratio,patch_dim,classes", [
    (1568, 768, 12, 4.0, 768, 0), (160, 768, 12, 4.0, 1536, 400),
    (197, 1024, 24, 4.0, 588, 0), (320, 384, 8, 2.5, 768, 12)])
def test_closed_forms_equal_jax(tokens, dim, depth, ratio, patch_dim,
                                classes):
    assert tflops.vit_block_flops(tokens, dim, ratio) == \
        jflops.vit_block_flops(tokens, dim, ratio)
    assert tflops.vit_flops(tokens, dim, depth, ratio, patch_dim, classes) \
        == jflops.vit_flops(tokens, dim, depth, ratio, patch_dim, classes)


def test_flop_counter_agrees_with_the_closed_form():
    """A tiny ViT's forward (one clip, 4 frames of 64^2 with tubelet 1: 64
    tokens; width 128, 3 blocks, 10 classes) counted by FlopCounterMode
    within 1% of ``vit_flops``."""
    m = tvit.VisionTransformer(img_size=64, patch_size=16, num_classes=10,
                               embed_dim=128, depth=3, num_heads=2,
                               all_frames=4, tubelet_size=1).eval()
    x = torch.randn(1, 4, 64, 64, 3)
    counted = tflops.count_flops(lambda: m(x))
    closed = tflops.vit_flops(64, 128, 3, 4.0, 16 * 16 * 3, 10)
    assert counted is not None
    assert abs(counted - closed) <= 0.01 * closed, (counted, closed)
    assert tflops.count_flops(lambda: 1 / 0) is None
