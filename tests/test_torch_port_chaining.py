"""Stage chaining into the port's stage-1 student (``--student_init``), on
the CPU, mirroring tests/test_cli.py::test_msgpack_stage_chaining.

The port's own checkpoints (``utils/checkpoint.py::save_checkpoint``) and
published UMT weights both end in .pth; ``run_stage1.load_student`` tells
them apart by the payload. Its own load as unite_tpu loads its .msgpack
files: a stage-1 student as it is, a bare stage-2 ViT nested under
``encoder.``, a stage-3 tree unwrapped. Published weights keep the import
chain of the reference (keys wrapped in ``encoder.``, then ``backbone.``
stripped, the positional embedding resampled).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from unite_torch.models.adaptation import AdaptationVisionTransformer
from unite_torch.models.vit import VisionTransformer
from unite_torch.train import run_stage1
from unite_torch.utils import checkpoint as ck
from unite_torch.utils import torch_import as ti

GEOM = dict(img_size=32, patch_size=8, num_frames=4, tubelet_size=1)
TINY = dict(GEOM, encoder_embed_dim=32, encoder_depth=2, encoder_num_heads=2,
            clip_decoder_embed_dim=32, clip_output_dim=16,
            clip_return_layers=(0, 1))


def _student(seed):
    torch.manual_seed(seed)
    return AdaptationVisionTransformer(**TINY)


def _args(path, **kw):
    return SimpleNamespace(**dict(
        student_init=str(path), model_key="model|module",
        clip_decoder_init="", input_size=32, patch_size=8, num_frames=4,
        tubelet_size=1, use_cls_token=False), **kw)


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def test_stage1_checkpoint_chains_into_stage1_bitwise(tmp_path):
    src = _student(0)
    ck.save_checkpoint(str(tmp_path), 3, src.state_dict(),
                       optimizer={"count": 7, "moments": {}})
    dst = _student(1)
    want = _params(src)
    before = _params(dst)
    assert any(not torch.equal(before[k], want[k]) for k in want)
    run_stage1.load_student(_args(tmp_path / "checkpoint-latest.pth"), dst)
    got = _params(dst)
    assert set(got) == set(want) and len(got) == 38
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_stage2_vit_nests_under_encoder(tmp_path):
    torch.manual_seed(2)
    vit = VisionTransformer(num_classes=5, embed_dim=32, depth=2, num_heads=2,
                            all_frames=4, patch_size=8, img_size=32,
                            tubelet_size=1)
    ck.save_checkpoint(str(tmp_path), 0, vit.state_dict())
    dst = _student(3)
    dec = {k: v.clone() for k, v in _params(dst).items()
           if k.startswith("clip_decoder.")}
    run_stage1.load_student(_args(tmp_path / "checkpoint-latest.pth"), dst)
    got = _params(dst)
    shared = [k for k in _params(vit) if f"encoder.{k}" in got]
    assert any(k.startswith("blocks.") for k in shared) and \
        "patch_embed.proj.weight" in shared
    for k in shared:
        assert torch.equal(got[f"encoder.{k}"], _params(vit)[k]), k
    for k, v in dec.items():  # a ViT carries no decoders: they keep their init
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("layout", ["nested", "module_dict"])
def test_stage3_tree_is_unwrapped(tmp_path, layout):
    # stage 3 keeps {"model": student, "classifier": head}: a nested tree, or
    # the flat state dict of run_stage3's nn.ModuleDict
    src = _student(4)
    head = {"weight": torch.ones(5, 32), "bias": torch.zeros(5)}
    if layout == "nested":
        model = {"model": src.state_dict(), "classifier": head}
    else:
        model = {**{f"model.{k}": v for k, v in src.state_dict().items()},
                 **{f"classifier.{k}": v for k, v in head.items()}}
    torch.save({"model": model, "epoch": 19, "optimizer": None},
               tmp_path / "s3.pth")
    dst = _student(5)
    run_stage1.load_student(_args(tmp_path / "s3.pth"), dst)
    got, want = _params(dst), _params(src)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_published_weights_keep_the_reference_chain(tmp_path, monkeypatch):
    # a published bare encoder ({"model": ...}, no epoch or optimizer): keys
    # wrapped in encoder. first, so a backbone. key is never stripped (the
    # reference's order, kept by unite_tpu), and the positional embedding
    # resampled from 8 frames to this geometry's 4
    rng = np.random.default_rng(6)
    enc = {k[len("encoder."):]: torch.from_numpy(
               rng.standard_normal(v.shape).astype(np.float32))
           for k, v in _params(_student(6)).items()
           if k.startswith("encoder.")}
    enc["backbone.extra"] = torch.ones(3)
    enc["pos_embed"] = torch.from_numpy(
        rng.standard_normal((1, 8 * 16, 32)).astype(np.float32))
    torch.save({"model": enc}, tmp_path / "umt.pth")
    seen = {}
    merge = ti.merge_state
    monkeypatch.setattr(ti, "merge_state",
                        lambda m, s: seen.update(s) or merge(m, s))
    dst = _student(7)
    run_stage1.load_student(_args(tmp_path / "umt.pth"), dst)
    assert set(seen) == {f"encoder.{k}" for k in enc}
    assert seen["encoder.pos_embed"].shape == (1, 4 * 16, 32)
    ref = ti.interpolate_pos_embed(
        {"encoder.pos_embed": enc["pos_embed"]}, 4 * 16, 0, new_frames=4,
        tubelet_size=1, key="encoder.pos_embed")["encoder.pos_embed"]
    assert torch.equal(seen["encoder.pos_embed"], ref)
    got = _params(dst)
    for k, v in enc.items():
        if f"encoder.{k}" in got:
            assert torch.equal(got[f"encoder.{k}"], v), k


def test_import_helpers_are_defined_once():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(ti))
    names = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)]
    assert len(names) == len(set(names)), sorted(names)
