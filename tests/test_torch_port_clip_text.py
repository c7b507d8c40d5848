"""unite_torch zero-shot teacher pieces against unite_tpu, fp32 on the CPU:
the causal text tower with bridged weights, the BPE tokenizer on a synthetic
merges file (no vocabulary ships with the repository), text features from a
``.npy`` or from text-tower weights plus merges, the zero-shot similarity
function over a small CLIP teacher, and the kNN probe and ECE.

Tolerances: 1e-5 for fp32 features (summation order); the zero-shot
similarities are softmax(100 * cos), which multiplies those differences by
100, so 1e-4 there; token ids, kNN accuracies and the ECE exactly.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unite_tpu.models import clip as jclip
from unite_tpu.models import clip_text as jtext
from unite_tpu.utils import knn as jknn
from unite_tpu.utils import metrics as jmetrics
from unite_torch.models import clip as tclip
from unite_torch.models import clip_text as ttext
from unite_torch.utils import knn as tknn
from unite_torch.utils import metrics as tmetrics
from unite_torch.utils.flax_bridge import flax_to_state_dict

MERGES = [
    "#version: 0.2", "h e", "l l", "he ll", "hell o</w>", "a</w>",
    "p e", "pe r", "per son</w>", "s o", "so n</w>", "v i", "vi deo</w>",
    "d e", "de o</w>", "o f</w>", "c l", "cl i", "cli m", "clim b</w>",
]
TEXT = dict(vocab_size=600, context_length=16, width=128, layers=2, heads=2,
            embed_dim=64)


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.fixture
def merges_path(tmp_path):
    p = tmp_path / "merges.txt"
    p.write_text("\n".join(MERGES) + "\n")
    return str(p)


def test_tokenizer_matches_jax(merges_path):
    ours, theirs = ttext.SimpleTokenizer(merges_path), \
        jtext.SimpleTokenizer(merges_path)
    assert ours.encoder == theirs.encoder
    texts = ["a video of a person climb", "hello person", "A PERSON!!",
             "person, hello; 42 videos", "  spaced   out  ", "café person",
             "a video of a person " + "x " * 30]  # cut at the context
    for t in texts:
        assert ours.encode(t) == theirs.encode(t), t
    np.testing.assert_array_equal(ours.tokenize(texts, 16),
                                  theirs.tokenize(texts, 16))
    assert ttext.bytes_to_unicode() == jtext.bytes_to_unicode()
    assert ttext.get_pairs(("a", "b", "c")) == jtext.get_pairs(("a", "b", "c"))
    for c in (8, 12, 23):
        assert ttext.get_class_names(c) == jtext.get_class_names(c)
    assert ttext.PROMPT == jtext.PROMPT
    with pytest.raises(NotImplementedError):
        ttext.get_class_names(5)


def test_text_tower_matches_jax_with_bridged_weights(merges_path):
    tok = ttext.SimpleTokenizer(merges_path)
    tokens = tok.tokenize([ttext.PROMPT.format(c) for c in
                           ttext.get_class_names(8)], 16)
    jm = jtext.CLIPTextTransformer(**TEXT)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"],
                1)
    tm = ttext.CLIPTextTransformer(**TEXT)
    tm.load_state_dict(flax_to_state_dict(p, kind="clip"), strict=True)
    ref = jm.apply({"params": p}, jnp.asarray(tokens))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    assert got.shape == (8, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-5)
    # the causal mask: tokens after the end-of-text token change nothing
    later = tokens.copy()
    later[:, -1] = 7
    with torch.no_grad():
        torch.testing.assert_close(tm(torch.from_numpy(later)), got)


def test_text_features_from_weights_and_merges(tmp_path, merges_path):
    # a full-geometry text tower saved under the OpenAI names: both packages
    # read the same file, tokenize the 12 prompts and encode them
    tm = ttext.CLIPTextTransformer()
    torch.manual_seed(0)
    state = {k: torch.randn_like(v) * 0.02
             for k, v in tm.state_dict().items()}
    state["visual.proj"] = torch.zeros(3)  # the image tower is skipped
    path = tmp_path / "clip.pth"
    torch.save({"state_dict": state}, path)
    args = SimpleNamespace(clip_text_features="", clip_text_init=str(path),
                           clip_bpe_path=merges_path, nb_classes=12)
    got = ttext.compute_text_features(args)
    ref = jtext.compute_text_features(args)
    assert got.shape == (12, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    npy = tmp_path / "feats.npy"
    np.save(npy, got)
    args.clip_text_features = str(npy)
    np.testing.assert_array_equal(ttext.compute_text_features(args), got)
    del state["ln_final.weight"]
    torch.save(state, path)
    args.clip_text_features = ""
    with pytest.raises(ValueError, match="absent from the checkpoint"):
        ttext.compute_text_features(args)
    args.clip_text_init = ""
    assert ttext.compute_text_features(args) is None
    assert ttext.build_zero_shot_fn(args, tclip.CLIPVisionTransformer()) \
        is None


def test_zero_shot_fn_matches_jax(tmp_path):
    cfg = dict(input_resolution=32, patch_size=16, width=128, layers=2,
               heads=2, output_dim=64, return_attn=True, return_index=(1,))
    tj = jclip.CLIPVisionTransformer(**cfg)
    rng = np.random.default_rng(5)
    vids = rng.integers(0, 256, (2, 3, 48, 48, 3), dtype=np.uint8)
    tp = perturb(tj.init(jax.random.PRNGKey(1),
                         jnp.zeros((1, 3, 32, 32, 3)))["params"], 2)
    tm = tclip.CLIPVisionTransformer(**cfg)
    state = flax_to_state_dict(tp, kind="clip")
    tm.load_state_dict(state, strict=True)
    npy = tmp_path / "feats.npy"
    np.save(npy, rng.standard_normal((12, 64)).astype(np.float32))
    # 48^2 clips resized to the teacher's 32^2, as the train step does
    args = SimpleNamespace(clip_text_features=str(npy), nb_classes=12,
                           clip_input_resolution=32)
    ref = _np(jtext.build_zero_shot_fn(args, tj, tp)(jnp.asarray(vids)))
    fn = ttext.build_zero_shot_fn(args, tm)
    got = fn(torch.from_numpy(vids))
    assert got.shape == (2, 12)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)
    # other parameters as an argument, the teacher's own untouched
    other = {k: v * 1.5 for k, v in state.items()}
    moved = fn(torch.from_numpy(vids), tp=other)
    assert not torch.allclose(moved, got)
    torch.testing.assert_close(fn(torch.from_numpy(vids)), got)


@pytest.mark.parametrize("k,classes", [(5, 0), (20, 7), (200, 0)])
def test_knn_classifier_matches_jax(k, classes):
    rng = np.random.default_rng(k)
    train = rng.standard_normal((300, 32)).astype(np.float32)
    train_labels = rng.integers(0, 7, 300)
    test = train[:90] + 0.3 * rng.standard_normal((90, 32)).astype(
        np.float32)
    test_labels = np.where(rng.random(90) < 0.8, train_labels[:90],
                           rng.integers(0, 7, 90))
    got = tknn.knn_classifier(train, train_labels, test, test_labels, k=k,
                              num_classes=classes)
    assert got == jknn.knn_classifier(train, train_labels, test, test_labels,
                                      k=k, num_classes=classes)
    assert 0.0 < got[0] <= got[1] <= 100.0


@pytest.mark.parametrize("bins", [5, 15])
def test_compute_ece_matches_jax(bins):
    rng = np.random.default_rng(bins)
    logits = rng.standard_normal((500, 12)) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, 12, 500)
    assert tmetrics.compute_ece(probs, labels, bins) == \
        jmetrics.compute_ece(probs, labels, bins)
    assert tknn.compute_ece is tmetrics.compute_ece
    # a perfectly calibrated, always-right predictor
    assert tmetrics.compute_ece(np.eye(12)[labels], labels, bins) == 0.0
