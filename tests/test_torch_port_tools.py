"""unite_torch.tools against the JAX package's tools/, on the CPU.

Each tool of the port and its counterpart under tools/ run in this process
on the same numpy-seeded inputs, with weights carried between the two by
``utils/flax_bridge.flax_to_state_dict``:

* export_torch: the same keys and bit-equal fp32 tensors as JAX's export
  of the same weights, for a stage-2 checkpoint and a stage-3 combined one
  (``src_classifier`` included);
* classify: ``vit_base_patch16_224`` at 32^2 and 2 frames, bf16 on both
  sides, on the synthetic reader: the same top five in the same order,
  probabilities within 1e-2 (the head's bias spreads the top five further
  apart than that), for a stage-2 and a stage-3 combined checkpoint;
* record_losses: both tools' ``create_model`` patched to the same tiny
  fp32 student and teacher: the dumped videos and masks bit-equal, loss and
  grad norm per step within the stage-1 step's fp32 rtol of 1e-5;
* extract_clip: a synthetic OpenAI-layout state: the split files bit-equal,
  the 12 classes' text features within 1e-5 (fp32 summation order).

The flops tool's parity is in tests/test_torch_port_tools_flops.py.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unite_tpu
from unite_tpu.models import adaptation as jad
from unite_tpu.models import clip as jclip
from unite_tpu.models import vit as jvit
from unite_tpu.utils import checkpoint as jck
from unite_tpu.utils.registry import create_model as jax_create_model
from unite_torch.models import adaptation as tad
from unite_torch.models import clip as tclip
from unite_torch.models import clip_text as ttext
from unite_torch.tools import classify, export_torch, extract_clip
from unite_torch.tools import record_losses
from unite_torch.utils import checkpoint as tck
from unite_torch.utils.flax_bridge import flax_to_state_dict
from unite_torch.utils.registry import create_model as port_create_model

ROOT = Path(__file__).resolve().parents[1]
CLASSES = 12
VIT = dict(num_classes=CLASSES, img_size=32, all_frames=2, tubelet_size=1)
CLASSIFY_ARGS = ["fake.mp4", "--synthetic", "--num-frames", "2",
                 "--input-size", "32", "--short-side-size", "32"]
STUDENT = dict(img_size=224, patch_size=16, encoder_embed_dim=128,
               encoder_depth=2, encoder_num_heads=2, num_frames=2,
               tubelet_size=1, clip_decoder_embed_dim=128, clip_output_dim=64,
               clip_return_layers=(0, 1))
TEACHER = dict(input_resolution=224, patch_size=16, width=128, layers=2,
               heads=2, output_dim=64, return_attn=True, return_index=(0, 1))
MERGES = ["#version: 0.2", "h e", "l l", "he ll", "p e", "pe r",
          "per son</w>", "v i", "vi deo</w>", "o f</w>", "c l", "cl i",
          "cli m", "clim b</w>", "w a", "wa l", "wal k"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's side: its tensors are small, and
    the suite runs several workers at once, whose thread pools contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool(name: str):
    """tools/<name>.py loaded as a module (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_tool(monkeypatch, name: str, argv):
    """The JAX tool's ``main`` with ``argv`` as its command line."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, argv)])
    jax_tool(name).main()


def seeded_params(shapes, seed: int):
    """Seeded values for a tree of shapes: weights ~0.02, LayerNorm scales
    ~1."""
    rng = np.random.default_rng(seed)

    def value(path, s):
        x = 0.02 * rng.standard_normal(s.shape, dtype=np.float32)
        return x + 1.0 if path[-1].key == "scale" else x

    return jax.tree_util.tree_map_with_path(value, shapes)


def vit_params():
    """``vit_base_patch16_224`` at ``VIT``'s geometry, seeded, its head's
    bias 0.7 apart from class to class in a seeded order (top-five
    probabilities about 0.5, 0.25, 0.12, 0.06 and 0.03) and its kernel at
    a quarter of the rest, so the clip still moves each logit."""
    model = jax_create_model("vit_base_patch16_224", **VIT)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, 32, 32, 3)))["params"]
    p = seeded_params(shapes, 0)
    order = np.random.default_rng(1).permutation(CLASSES)
    p["head"]["bias"] = (0.7 * order).astype(np.float32)
    p["head"]["kernel"] = p["head"]["kernel"] * 0.25
    return p


# ------------------------------------------------------------ export


def test_export_matches_the_jax_tool(tmp_path, monkeypatch):
    """A small ViT (width 128, 2 blocks, 12 classes) and its stage-3
    combined tree."""
    model = jvit.VisionTransformer(img_size=32, patch_size=16,
                                   num_classes=CLASSES, embed_dim=128,
                                   depth=2, num_heads=2, all_frames=2,
                                   tubelet_size=1)
    p = seeded_params(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 2, 32, 32, 3)))["params"],
                      2)
    head = {"kernel": np.asarray(p["head"]["kernel"]),
            "bias": np.asarray(p["head"]["bias"])}
    body = {k: v for k, v in p.items() if k != "head"}
    jax_trees = {"stage2": p,
                 "stage3": {"model": {"encoder": body}, "classifier": head}}
    state3 = {f"model.encoder.{k}": v
              for k, v in flax_to_state_dict(body).items()}
    state3.update({"classifier.weight": torch.from_numpy(head["kernel"].T),
                   "classifier.bias": torch.from_numpy(head["bias"])})
    port_states = {"stage2": flax_to_state_dict(p), "stage3": state3}
    for kind, epoch in (("stage2", 4), ("stage3", 7)):
        jck.save_checkpoint(str(tmp_path / f"jax_{kind}"), epoch,
                            jax_trees[kind])
        tck.save_checkpoint(str(tmp_path / f"port_{kind}"), epoch,
                            port_states[kind])
        run_jax_tool(monkeypatch, "export_torch", [
            tmp_path / f"jax_{kind}" / "checkpoint-latest.msgpack",
            tmp_path / f"jax_{kind}.pth"])
        export_torch.main([str(tmp_path / f"port_{kind}" /
                               "checkpoint-latest.pth"),
                           str(tmp_path / f"port_{kind}.pth")])
        ref = torch.load(tmp_path / f"jax_{kind}.pth", weights_only=False)
        got = torch.load(tmp_path / f"port_{kind}.pth", weights_only=False)
        parts = {"stage2": {"model"},
                 "stage3": {"model", "src_classifier"}}[kind]
        assert set(got) == set(ref) == parts | {"epoch"}
        assert got["epoch"] == ref["epoch"] == epoch
        for part in parts:
            assert list(got[part]) and set(got[part]) == set(ref[part])
            for k, v in ref[part].items():
                assert got[part][k].dtype == torch.float32
                assert torch.equal(got[part][k], v), (kind, part, k)


# ----------------------------------------------------------- classify


def jax_top5(monkeypatch, capsys, ckpt):
    capsys.readouterr()
    run_jax_tool(monkeypatch, "classify", [ckpt, *CLASSIFY_ARGS, "--cpu"])
    # the last five lines: the importer's reports come before them
    rows = [l.split(None, 1)
            for l in capsys.readouterr().out.splitlines()[-5:]]
    return [float(r[0]) for r in rows], [r[1] for r in rows]


def test_classify_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    p = vit_params()
    head = {"kernel": np.asarray(p["head"]["kernel"]),
            "bias": np.asarray(p["head"]["bias"])}
    jck.save_checkpoint(str(tmp_path / "jax2"), 0, p)
    state = flax_to_state_dict(p)
    tck.save_checkpoint(str(tmp_path / "port2"), 0, state)
    combined = {f"model.encoder.{k}": v for k, v in state.items()
                if not k.startswith("head.")}
    combined.update({"classifier.weight": torch.from_numpy(head["kernel"].T),
                     "classifier.bias": torch.from_numpy(head["bias"])})
    tck.save_checkpoint(str(tmp_path / "port3"), 0, combined)

    ref_p, ref_names = jax_top5(
        monkeypatch, capsys, tmp_path / "jax2" / "checkpoint-latest.msgpack")
    # the order is meaningful: each of the top five above the next by more
    # than the tolerance
    assert all(a - b > 1e-2 for a, b in zip(ref_p, ref_p[1:]))
    names = ttext.CLASS_NAMES[CLASSES]
    built = {}

    def create_once(*a, **k):
        """One ViT-B for both calls (one thread takes seconds to initialize
        it); the second call gets it with every parameter zeroed, so its
        checkpoint must bring back each weight itself."""
        if "vit" in built:
            with torch.no_grad():
                for q in built["vit"].parameters():
                    q.zero_()
        else:
            built["vit"] = port_create_model(*a, **k)
        return built["vit"]

    monkeypatch.setattr(classify, "create_model", create_once)
    capsys.readouterr()
    probs = classify.main([str(tmp_path / "port2" / "checkpoint-latest.pth"),
                           *CLASSIFY_ARGS, "--cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out == classify.top_lines(probs) and len(out) == 5
    top = np.argsort(probs)[::-1][:5]
    assert [names[i] for i in top] == ref_names
    np.testing.assert_allclose(probs[top], ref_p, rtol=0, atol=1e-2)
    assert probs.dtype == np.float32 and probs.shape == (CLASSES,)
    np.testing.assert_allclose(probs.sum(), 1.0, rtol=1e-5)
    # the stage-3 combined checkpoint holds the same weights: its student
    # encoder and classifier land where the ViT keeps them, so the same
    # probabilities come out bit for bit (JAX's tool takes the same keys,
    # tools/classify.py:81-90)
    probs3 = classify.main([str(tmp_path / "port3" /
                                "checkpoint-latest.pth"),
                            *CLASSIFY_ARGS, "--cpu"])
    np.testing.assert_array_equal(probs3, probs)


def test_classify_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classify.main(["missing.pth", *CLASSIFY_ARGS])


# ------------------------------------------------------- record_losses


class Drawn:
    """A flax module that keeps a copy of the parameters its ``init`` drew
    (the tool's step donates the arrays themselves)."""

    def __init__(self, module):
        self.module, self.params = module, None

    def init(self, *args, **kwargs):
        out = self.module.init(*args, **kwargs)
        self.params = jax.tree.map(np.array, out["params"])
        return out

    def __getattr__(self, name):
        return getattr(self.module, name)


def test_record_losses_matches_the_jax_tool(tmp_path, monkeypatch):
    """Both tools at ``--steps 3 --batch 2 --frames 2`` (392 patches, 79
    visible) with their models replaced by the same tiny fp32 student and
    teacher: the JAX tool initializes them from its seeds, and the port
    gets the weights it drew through the bridge."""
    seed, frames = 3, 2
    n_vis = frames * 196 - int(frames * 196 * 0.8)
    jax_models = {"student": Drawn(jad.AdaptationVisionTransformer(**STUDENT)),
                  "clip_b16": Drawn(jclip.CLIPVisionTransformer(**TEACHER))}

    def port_model(name, **_):
        if name == "clip_b16":
            m = tclip.CLIPVisionTransformer(**TEACHER)
            m.load_state_dict(flax_to_state_dict(
                jax_models[name].params, kind="clip"))
        else:
            m = tad.AdaptationVisionTransformer(**STUDENT)
            m.load_state_dict(flax_to_state_dict(
                jax_models["student"].params))
        return m

    monkeypatch.setattr(unite_tpu, "create_model", lambda name, **_:
                        jax_models.get(name, jax_models["student"]))
    monkeypatch.setattr(record_losses, "create_model", port_model)
    common = ["--steps", "3", "--batch", "2", "--frames", str(frames),
              "--seed", str(seed)]
    run_jax_tool(monkeypatch, "record_losses", [
        tmp_path / "jax.jsonl", *common, "--dump-masks",
        tmp_path / "jax.npz"])
    got = record_losses.main([str(tmp_path / "port.jsonl"), *common,
                              "--dump-masks", str(tmp_path / "port.npz")],
                             device="cpu")

    ref_masks, masks = (np.load(tmp_path / f) for f in ("jax.npz",
                                                          "port.npz"))
    for k in ("videos", "vis_idx"):
        assert masks[k].dtype == ref_masks[k].dtype
        np.testing.assert_array_equal(masks[k], ref_masks[k])
    assert masks["vis_idx"].shape == (3, 2, n_vis)
    ref = [json.loads(l) for l in (tmp_path / "jax.jsonl").read_text()
           .splitlines()]
    lines = [json.loads(l) for l in (tmp_path / "port.jsonl").read_text()
             .splitlines()]
    assert lines == got and [r["step"] for r in got] == [0, 1, 2]
    for r, q in zip(got, ref):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r[k], q[k], rtol=1e-5, err_msg=k)
    # the steps trained: the loss moved
    assert got[0]["loss"] != got[2]["loss"]


# -------------------------------------------------------- extract_clip


def clip_state(width: int, layers: int, seed: int) -> dict:
    """A seeded OpenAI-layout state: a text tower of ``width`` (heads of
    64) with an output width of 32, a few visual tensors, ``logit_scale``."""
    tower = ttext.CLIPTextTransformer(width=width, layers=layers,
                                      heads=width // 64, embed_dim=32)
    rng = np.random.default_rng(seed)
    state = {k: torch.from_numpy(
        (0.02 * rng.standard_normal(tuple(v.shape))
         + (1.0 if "ln_" in k and k.endswith("weight") else 0.0))
        .astype(np.float32)) for k, v in tower.state_dict().items()}
    state.update({"visual.conv1.weight": torch.randn(8, 3, 16, 16),
                  "visual.proj": torch.randn(8, 4),
                  "logit_scale": torch.tensor(4.6)})
    return state


def test_extract_clip_matches_the_jax_tool(tmp_path, monkeypatch):
    """Text width 64 (one head), 2 layers."""
    torch.save(clip_state(64, 2, 0), tmp_path / "clip.pt")
    merges = tmp_path / "merges.txt"
    merges.write_text("\n".join(MERGES) + "\n")
    argv = ["--text", "--features-for", "12", "--bpe", merges]
    run_jax_tool(monkeypatch, "extract_clip",
                 [tmp_path / "clip.pt", tmp_path / "jax", *argv])
    lines = extract_clip.main([str(tmp_path / "clip.pt"),
                               str(tmp_path / "port"), *map(str, argv)])
    assert len(lines) == 3
    for name in ("vit_b16.pth", "text_vit_b16.pth"):
        ref = torch.load(tmp_path / "jax" / name, weights_only=True)
        got = torch.load(tmp_path / "port" / name, weights_only=True)
        assert list(got) == list(ref) and got
        assert all(torch.equal(got[k], ref[k]) for k in ref), name
    assert set(torch.load(tmp_path / "port" / "vit_b16.pth")) == {
        "conv1.weight", "proj"}
    ref = np.load(tmp_path / "jax" / "text_features_12.npy")
    got = np.load(tmp_path / "port" / "text_features_12.npy")
    assert got.shape == (12, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_extract_clip_reads_the_geometry_from_the_state(tmp_path):
    """Width 128 and 3 layers: two heads of 64, three blocks and an output
    width of 32 read from the state, every weight loaded (strict)."""
    state = clip_state(128, 3, 1)
    text = {k: v for k, v in state.items() if not k.startswith("visual.")
            and k != "logit_scale"}
    tower = extract_clip.text_tower(text)
    assert len(tower.transformer.resblocks) == 3
    assert tower.transformer.resblocks[0].attn.num_heads == 2
    assert tower.text_projection.shape == (128, 32)
    got = tower.state_dict()
    assert set(got) == set(text)
    assert all(torch.equal(got[k], text[k]) for k in text)
    with pytest.raises(RuntimeError, match="Missing key"):
        extract_clip.text_tower({k: v for k, v in text.items()
                                 if k != "ln_final.bias"})
