"""unite_torch's ViT-L/14 stage-1 configuration against unite_tpu's, on the CPU.

The full-size models are compared by their parameter names, shapes and
counts only: the port builds them on the ``meta`` device and JAX traces its
``init`` with ``jax.eval_shape``, so nothing full-size is allocated. The
numbers are held by the fp32 stage-1 step gate over two steps at a narrow
width with a patch-14 teacher run int8 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unite_tpu import create_model as jax_create_model
from unite_tpu.engines.pretrain_umt import (
    make_pretrain_train_step as jax_step_builder,
)
from unite_tpu.models import adaptation as jad
from unite_tpu.models import clip as jclip
from unite_tpu.ops import quant as jq
from unite_tpu.optim import factory as jfactory
from unite_tpu.train.run_stage1 import unused_block_mask
from unite_tpu.train.train_state import TrainState as JaxTrainState
from unite_tpu.utils import schedules as jsched
from unite_torch import create_model
from unite_torch.config import parse_with_config
from unite_torch.engines.pretrain_umt import make_pretrain_train_step
from unite_torch.models import adaptation as tad
from unite_torch.models import clip as tclip
from unite_torch.ops import matmul as tmm
from unite_torch.optim import factory as tfactory
from unite_torch.train import run_stage1
from unite_torch.train.args import stage1_parser
from unite_torch.train.train_state import TrainState
from unite_torch.utils.flax_bridge import clip_key, flax_to_state_dict, student_key

RET = (18, 19, 20, 21, 22, 23)  # bench.py::bench_large's taps
# name -> (extra kwargs on both sides, JAX init inputs); the student at
# bench_large's geometry (8 frames, tubelet 1, 320 visible tokens)
LARGE = {
    "clip_l14": (dict(return_index=RET), [(1, 1, 224, 224, 3)]),
    "clip_l14_336": (dict(return_index=RET), [(1, 1, 336, 336, 3)]),
    "adaptation_umt_large_patch16_224": (
        dict(num_frames=8, tubelet_size=1, clip_return_layers=RET,
             clip_decoder_embed_dim=1024, clip_output_dim=768),
        [(1, 8, 224, 224, 3), (1, 320)]),
}


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("name", sorted(LARGE))
def test_large_models_match_jax_names_and_shapes(name):
    kw, inputs = LARGE[name]
    jm = jax_create_model(name, **kw)
    args = [jax.ShapeDtypeStruct(s, jnp.float32 if len(s) == 5 else jnp.int32)
            for s in inputs]
    # a student's clip_only=False builds every block and the final norm
    extra = (False,) if name.startswith("adaptation") else ()
    shapes = jax.eval_shape(
        lambda *a: jm.init(jax.random.PRNGKey(0), *a, *extra), *args)["params"]
    tm = create_model(name, device="meta", **kw)
    state = tm.state_dict()
    assert all(v.device.type == "meta" for v in state.values())
    clip = name.startswith("clip")
    mapped = {}
    for path, sds in _paths(shapes):
        # a zero-stride stand-in: the bridge's transposes and the patch
        # embedding's reshape are views, so nothing is allocated
        arr = np.broadcast_to(np.float32(0), sds.shape)
        key, out = (clip_key(path, arr, 14) if clip
                    else student_key(path, arr, 16))
        mapped[key] = out.shape
    assert set(mapped) == set(state)
    for key, shape in mapped.items():
        assert tuple(state[key].shape) == tuple(shape), key
    n_jax = sum(int(np.prod(s.shape)) for _, s in _paths(shapes))
    assert n_jax == sum(v.numel() for v in state.values())
    assert n_jax > 3e8  # full size: ~304M (clip_l14*), ~305M (student)


def test_run_stage1_builds_the_vit_l_geometry_on_meta():
    args = parse_with_config(stage1_parser(), [
        "--model", "adaptation_umt_large_patch16_224",
        "--clip_teacher", "clip_l14", "--clip_input_resolution", "196",
        "--num_frames", "8", "--tubelet_size", "1",
        "--clip_decoder_embed_dim", "1024", "--clip_output_dim", "768",
        "--clip_return_layers", *map(str, RET), "--compute_dtype",
        "bfloat16"])
    student = run_stage1.build_student(args, device="meta")
    teacher = run_stage1.build_teacher(args, device="meta")
    enc = student.encoder
    assert len(enc.blocks) == 24 and enc.blocks[0].attn.num_heads == 16
    assert enc.patch_embed.proj.weight.shape == (1024, 3, 1, 16, 16)
    assert len(student.clip_decoder) == 6
    assert student.clip_decoder[0].head.weight.shape == (768, 1024)
    assert teacher.input_resolution == 196 and teacher.patch_size == 14
    assert teacher.return_index == RET and teacher.return_attn
    assert teacher.positional_embedding.shape == (197, 1024)
    assert teacher.proj.shape == (1024, 768)
    assert len(teacher.transformer.resblocks) == 24
    assert teacher.dtype == torch.bfloat16
    # teacher grid == student grid: 14x14 patches a frame on both sides
    assert (196 // 14) ** 2 == (224 // 16) ** 2


# ------------------------------------------------------------------ gate

STUDENT = dict(img_size=32, patch_size=16, encoder_embed_dim=128,
               encoder_depth=3, encoder_num_heads=2, num_frames=4,
               tubelet_size=1, clip_decoder_embed_dim=128, clip_output_dim=64,
               clip_return_layers=(0, 1))  # block 2 never runs: frozen
# a patch-14 teacher at 28^2: its 2x2 grid matches the /16 student's at 32^2
TEACHER = dict(input_resolution=28, patch_size=14, width=128, layers=3,
               heads=2, output_dim=64, return_attn=True, return_index=(0, 1))
GEOM = dict(num_patches=16, frames=4, mask_ratio=0.5)


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def batch_np(b=2, seed=0):
    rng = np.random.default_rng(seed)
    vids = rng.integers(0, 256, (b, 4, 32, 32, 3), dtype=np.uint8)
    idx = np.stack([np.sort(np.concatenate(
        [f * 4 + rng.choice(4, 2, replace=False) for f in range(4)]))
        for _ in range(b)]).astype(np.int32)
    return vids, idx


def test_step_gate_with_the_int8_patch14_teacher_matches_jax():
    sj = jad.AdaptationVisionTransformer(**STUDENT)
    vids, idx = batch_np()
    sp = perturb(sj.init(jax.random.PRNGKey(0), jnp.asarray(vids[:1],
                                                            jnp.float32),
                         jnp.asarray(idx[:1]), False)["params"], 1)
    tp = perturb(jclip.CLIPVisionTransformer(**TEACHER).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, 28, 28, 3)))["params"], 2)
    tq_params = jq.quantize_clip_params(tp)
    tj = jclip.CLIPVisionTransformer(quantize=True, **TEACHER)
    lr_tab = jsched.cosine_scheduler(5e-4, 2.5e-5, 1, 3, warmup_steps=1,
                                     start_warmup_value=2.5e-4)
    wd_tab = jsched.cosine_scheduler(0.05, 0.2, 1, 3)
    eps = 1e-6  # as the other gates (tests/test_torch_port_step.py)
    geom = dict(GEOM, source_batch_size=0, clip_loss_data="target",
                clip_grad=None, clip_input_resolution=28)
    tx, _ = jfactory.create_optimizer(
        "adamw", lr=lr_tab, params=sp, weight_decay=wd_tab,
        betas=(0.9, 0.95), eps=eps, trainable_mask=unused_block_mask(sp, 1))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, sp), tx)
    jstep = jax.jit(jax_step_builder(sj, tj, **geom))

    sm = tad.AdaptationVisionTransformer(**STUDENT)
    sm.load_state_dict(flax_to_state_dict(sp))
    tm = tclip.CLIPVisionTransformer(quantize=True, **TEACHER)
    tm.load_state_dict(flax_to_state_dict(tq_params, kind="clip",
                                          patch_size=14))
    opt, _ = tfactory.create_optimizer("adamw", lr_tab, sm,
                                       weight_decay=wd_tab, betas=(0.9, 0.95),
                                       eps=eps, device="cpu")
    state = TrainState(sm, opt)
    step = make_pretrain_train_step(sm, tm, device="cpu", **geom)
    assert not any(p.requires_grad for p in tm.parameters())
    int8_before = tmm.int8_matmul.launches  # CPU: the plain version, no count

    prev = {k: v.clone() for k, v in sm.state_dict().items()}
    for i in range(2):
        vids, idx = batch_np(seed=20 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, tq_params),
                           {"videos": jnp.asarray(vids),
                            "vis_idx": jnp.asarray(idx)},
                           jax.random.PRNGKey(0))
        m = step(state, {"videos": torch.from_numpy(vids),
                         "vis_idx": torch.from_numpy(idx)})
        for k in ("loss", "loss_clip", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5)
        ref = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))
        got = sm.state_dict()
        assert set(ref) == set(got)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            d_got, d_ref = got[k] - prev[k], ref[k] - prev[k]
            assert (d_got - d_ref).norm() <= 1e-3 * d_ref.norm() + 1e-12, k
        prev = {k: v.clone() for k, v in got.items()}
    assert state.step == 2
    assert tmm.int8_matmul.launches == int8_before
    assert tm.transformer.resblocks[0].attn.in_proj_weight.dtype == torch.int8
