"""unite_torch's finetune data path against unite_tpu.data, on the CPU.

Inputs come from numpy seeds; each case runs the JAX package's function and
the port's on the same inputs with the same ``np.random.Generator`` seed:

* the finetune samplers, the clip transforms, the PIL group ops, the
  functionals, every RandAugment op and the two shipped policies, and
  ``RandomErasing``: equal outputs (the resizes are ``cv2.resize`` in both
  packages, so bit for bit) and equal generator states afterwards (the same
  draws in the same order);
* ``VideoClsDatasetSparse`` items in train, validation and test mode (host
  and uint8 paths, ``return_aug_for_val``, ``num_sample``, the skip
  strategy, ``device_eval_transforms``, the retry on a bad clip),
  ``VideoClsDatasetDense``, ``SSVideoClsDataset`` over the synthetic reader
  and ``SSRawFrameClsDataset`` over a JPEG frame folder, for the same
  (seed, epoch, index): bit for bit;
* ``build_dataset``'s dispatch and its ``nb_classes`` errors;
* ``device_val_transform`` in fp32 to 1e-5.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unite_tpu.data import build as jbuild
from unite_tpu.data import datasets as jds
from unite_tpu.data import datasets_extra as jdx
from unite_tpu.data import functional as jfn
from unite_tpu.data import rand_augment as jra
from unite_tpu.data import random_erasing as jre
from unite_tpu.data import samplers as jsm
from unite_tpu.data import transforms as jtr
from unite_tpu.data import video_reader as jreader
from unite_tpu.ops import eval_transforms as jev
from unite_torch.data import build as tbuild
from unite_torch.data import datasets as tds
from unite_torch.data import datasets_extra as tdx
from unite_torch.data import functional as tfn
from unite_torch.data import rand_augment as tra
from unite_torch.data import random_erasing as tre
from unite_torch.data import samplers as tsm
from unite_torch.data import transforms as ttr
from unite_torch.data import video_reader as treader
from unite_torch.ops import eval_transforms as tev


def _gen(seed):
    return np.random.default_rng(seed)


def _same(got, ref):
    """Equal values, dtypes and shapes, recursively."""
    if isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r)
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    elif isinstance(ref, Image.Image):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    else:
        assert got == ref


def _clip(seed, shape=(4, 40, 56, 3), dtype=np.uint8):
    x = _gen(seed).integers(0, 256, shape, dtype=np.uint8)
    return x if dtype == np.uint8 else x.astype(np.float32) / 255.0


# ---------------------------------------------------------------- samplers

SAMPLER_CASES = [
    ("sparse_frame_indices", (301, 8), dict(clip_idx=-1)),
    ("sparse_frame_indices", (5, 8), dict(clip_idx=-1)),
    ("sparse_frame_indices", (100, 8), dict(clip_idx=0)),
    ("sparse_frame_indices", (100, 8), dict(clip_idx=3, test_num_segment=4)),
    ("dense_frame_indices", (100, 8, 4), {}),
    ("dense_frame_indices", (10, 8, 4), dict(start=0)),
    ("dense_segment_indices", (300, 8, 2, "train"), dict(num_segment=2)),
    ("dense_segment_indices", (300, 8, 2, "validation"), {}),
    ("dense_segment_indices", (300, 8, 4, "test"),
     dict(chunk_nb=3, test_num_segment=5)),
    ("dense_segment_indices", (12, 8, 2, "train"), {}),
    ("ssv2_segment_indices", (50, 8, "train"), {}),
    ("ssv2_segment_indices", (6, 8, "train"), {}),
    ("ssv2_segment_indices", (50, 8, "validation"), {}),
    ("ssv2_segment_indices", (50, 8, "test"), {}),
    ("ssv2_raw_frame_indices", (50, 8, "train"), {}),
    ("ssv2_raw_frame_indices", (50, 8, "validation"), {}),
    ("ssv2_raw_frame_indices", (50, 8, "test"), dict(test_num_segment=3)),
    ("ssv2_raw_frame_indices", (5, 8, "validation"), {}),
    ("enumerate_test_views", (3, 4, 3), {}),
]


@pytest.mark.parametrize("name,args,kw", SAMPLER_CASES)
def test_samplers_match_jax(name, args, kw):
    stochastic = name != "enumerate_test_views"
    g_t, g_j = _gen(1), _gen(1)
    extra_t = dict(rng=g_t) if stochastic else {}
    extra_j = dict(rng=g_j) if stochastic else {}
    got = getattr(tsm, name)(*args, **kw, **extra_t)
    ref = getattr(jsm, name)(*args, **kw, **extra_j)
    assert got == ref and len(got) > 0
    assert g_t.random() == g_j.random()


def test_samplers_refuse_an_ambient_generator():
    with pytest.raises(ValueError, match="Generator"):
        tsm.sparse_frame_indices(100, 8, clip_idx=-1)
    with pytest.raises(ValueError, match="Generator"):
        tsm.ssv2_raw_frame_indices(50, 8, "train")


# -------------------------------------------------------------- transforms

TRANSFORM_CASES = [
    ("resize_clip", (32,), {}, False),
    ("resize_clip", ((24, 30),), dict(interpolation="bicubic"), False),
    ("resize_clip", (48,), {}, True),  # float clips resize too
    ("random_short_side_scale_jitter", (32, 48), {}, False),
    ("random_crop", (24,), {}, False),
    ("uniform_crop", (24, 0), {}, False),
    ("uniform_crop", (24, 2), {}, False),
    ("horizontal_flip", (), dict(prob=0.9), False),
    ("center_crop", (24,), {}, False),
    ("tensor_normalize", (), {}, False),
    ("tensor_normalize", (), {}, True),
    ("random_resized_crop", (24, 24), {}, False),
    ("random_resized_crop", (24, 24), dict(scale=(0.99, 1.0),
                                           ratio=(5.0, 6.0)), True),
    ("random_resized_crop_with_shift", (24, 24), {}, False),
    ("spatial_sampling", (), dict(spatial_idx=-1, crop_size=24,
                                  scale=(0.08, 1.0),
                                  aspect_ratio=(0.75, 4 / 3)), False),
    ("spatial_sampling", (), dict(spatial_idx=-1, min_scale=40,
                                  max_scale=48, crop_size=24), True),
    ("spatial_sampling", (), dict(spatial_idx=-1, crop_size=24,
                                  scale=(0.3, 1.0), aspect_ratio=(0.75, 1.3),
                                  motion_shift=True), False),
    ("spatial_sampling", (), dict(spatial_idx=2, min_scale=32,
                                  crop_size=24), False),
    ("val_transform", (32, 24), {}, False),
    ("val_transform", (32, 24), dict(normalize=False), False),
]
RANDOM = {"random_short_side_scale_jitter", "random_crop", "horizontal_flip",
          "random_resized_crop", "random_resized_crop_with_shift",
          "spatial_sampling"}


@pytest.mark.parametrize("name,args,kw,as_float", TRANSFORM_CASES)
def test_clip_transforms_match_jax(name, args, kw, as_float):
    clip = _clip(2, dtype=np.float32 if as_float else np.uint8)
    g_t, g_j = _gen(3), _gen(3)
    extra_t = dict(rng=g_t) if name in RANDOM else {}
    extra_j = dict(rng=g_j) if name in RANDOM else {}
    got = getattr(ttr, name)(clip.copy(), *args, **kw, **extra_t)
    ref = getattr(jtr, name)(clip.copy(), *args, **kw, **extra_j)
    _same(np.asarray(got), np.asarray(ref))
    assert g_t.random() == g_j.random()


@pytest.mark.parametrize("op,args,random", [
    ("GroupScale", (32,), False), ("GroupScale", (40,), False),
    ("GroupRandomCrop", (24,), True), ("GroupCenterCrop", (24,), False)])
def test_group_ops_match_jax(op, args, random):
    frames = [Image.fromarray(f) for f in _clip(4)]
    g_t, g_j = _gen(5), _gen(5)
    got = getattr(ttr, op)(*args)(frames, **(dict(rng=g_t) if random else {}))
    ref = getattr(jtr, op)(*args)(frames, **(dict(rng=g_j) if random else {}))
    _same(got, ref)
    assert g_t.random() == g_j.random()


def test_functionals_match_jax():
    clip = _clip(6)
    _same(tfn.crop_clip(clip, 3, 5, 20, 22), jfn.crop_clip(clip, 3, 5, 20, 22))
    assert tfn.get_resize_sizes(40, 56, 32) == jfn.get_resize_sizes(40, 56, 32)
    _same(tfn.resize_clip(clip, 32), jfn.resize_clip(clip, 32))
    _same(tfn.normalize(clip, (0.4, 0.5, 0.6), (0.2, 0.3, 0.1)),
          jfn.normalize(clip, (0.4, 0.5, 0.6), (0.2, 0.3, 0.1)))


# ------------------------------------------------------------ RandAugment

OPS = sorted(jra.NAME_TO_OP)


@pytest.mark.parametrize("name", OPS)
def test_rand_augment_ops_match_jax(name):
    # every op at a jittered magnitude, applied with probability 1, on the
    # same frames and generator: equal draws and pixels
    frames = [Image.fromarray(f) for f in _clip(7, (3, 40, 56, 3))]
    hp = {"translate_pct": 0.45, "img_mean": (124, 116, 104),
          "interpolation": (tra.BILINEAR, tra.BICUBIC),
          "magnitude_std": 0.5}
    for seed in range(3):
        g_t, g_j = _gen(seed), _gen(seed)
        got = tra.AugmentOp(name, prob=1.0, magnitude=7, hparams=hp)(frames,
                                                                     g_t)
        ref = jra.AugmentOp(name, prob=1.0, magnitude=7, hparams=hp)(frames,
                                                                     g_j)
        _same(got, ref)
        assert g_t.random() == g_j.random()


@pytest.mark.parametrize("policy,interp", [
    ("rand-m7-n4-mstd0.5-inc1", 3), ("rand-m3-n2-mstd0.5-inc1", 3),
    ("rand-m9-n2-mstd0", (2, 3))])
def test_rand_augment_policies_match_jax(policy, interp):
    hp = {"translate_pct": 0.45, "img_mean": (124, 116, 104),
          "interpolation": interp}
    port, ref = (tra.rand_augment_transform(policy, hp),
                 jra.rand_augment_transform(policy, hp))
    assert [o.name for o in port.ops] == [o.name for o in ref.ops]
    assert port.num_layers == ref.num_layers
    frames = [Image.fromarray(f) for f in _clip(8, (3, 40, 56, 3))]
    for seed in range(6):
        g_t, g_j = _gen(seed), _gen(seed)
        _same(port(frames, g_t), ref(frames, g_j))
        assert g_t.random() == g_j.random()


# ---------------------------------------------------------- RandomErasing


@pytest.mark.parametrize("mode,uint8,count", [
    ("pixel", False, 1), ("pixel", True, 1), ("rand", False, 3),
    ("const", True, 2)])
def test_random_erasing_matches_jax(mode, uint8, count):
    clip = _clip(9, dtype=np.uint8 if uint8 else np.float32)
    for seed in range(4):
        g_t, g_j = _gen(seed), _gen(seed)
        got = tre.RandomErasing(0.9, mode=mode, max_count=count)(clip, g_t)
        ref = jre.RandomErasing(0.9, mode=mode, max_count=count)(clip, g_j)
        _same(got, ref)
        assert g_t.random() == g_j.random()


# ---------------------------------------------------------------- datasets


def _ann(tmp_path, name, n, sep=",", counts=False):
    p = tmp_path / name
    p.write_text("".join(
        f"video_{name}_{i:03d}.mp4{sep}{(37 + i) if counts else ''}"
        f"{sep if counts else ''}{i % 5}\n" for i in range(n)))
    return str(p)


def _pair(cls_t, cls_j, anno, **kw):
    reader = kw.pop("reader", "synthetic")
    if reader == "synthetic":
        return (cls_t(anno, reader=treader.SyntheticVideoReader(64, 80), **kw),
                cls_j(anno, reader=jreader.SyntheticVideoReader(64, 80), **kw))
    return cls_t(anno, **kw), cls_j(anno, **kw)


def _items_equal(port, ref, epochs=(0, 1), indices=None):
    assert len(port) == len(ref)
    for epoch in epochs:
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in (range(len(ref)) if indices is None else indices):
            _same(port[i], ref[i])


SPARSE = dict(sep=",", clip_len=4, crop_size=32, short_side_size=40,
              test_num_segment=2, test_num_crop=3, seed=3)


@pytest.mark.parametrize("mode,kw", [
    ("train", {}),
    ("train", dict(device_normalize=True)),
    ("train", dict(num_sample=2, aa="rand-m3-n2-mstd0.5-inc1", reprob=0.0)),
    ("train", dict(frame_sample_rate=3, train_interpolation="random",
                   remode="rand", recount=2)),
    ("train", dict(train_fraction=0.5)),
    ("validation", {}),
    ("validation", dict(device_normalize=True, return_aug_for_val=True)),
    ("validation", dict(device_eval_transforms=True, short_side_size=64)),
    ("test", {}),
    ("test", dict(device_normalize=True, test_num_crop=1)),
])
def test_sparse_dataset_items_match_jax(tmp_path, mode, kw):
    anno = _ann(tmp_path, "a.csv", 6)
    port, ref = _pair(tds.VideoClsDatasetSparse, jds.VideoClsDatasetSparse,
                      anno, mode=mode, **dict(SPARSE, **kw))
    _items_equal(port, ref)


class _Flaky(jreader.SyntheticVideoReader):
    """Fails on every path that holds ``bad``."""

    def get_batch(self, path, indices):
        if "bad" in path:
            raise RuntimeError("corrupt")
        return super().get_batch(path, indices)


class _FlakyPort(treader.SyntheticVideoReader):
    def get_batch(self, path, indices):
        if "bad" in path:
            raise RuntimeError("corrupt")
        return super().get_batch(path, indices)


def test_sparse_dataset_retries_and_checks_the_canvas(tmp_path):
    p = tmp_path / "r.csv"
    p.write_text("bad_0.mp4,1\nok_1.mp4,2\nbad_2.mp4,3\nok_3.mp4,4\n")
    port = tds.VideoClsDatasetSparse(str(p), reader=_FlakyPort(64, 80),
                                     **SPARSE)
    ref = jds.VideoClsDatasetSparse(str(p), reader=_Flaky(64, 80), **SPARSE)
    with pytest.warns(UserWarning, match="not correctly loaded"):
        _items_equal(port, ref, epochs=(0,))
    val = tds.VideoClsDatasetSparse(str(p), mode="validation",
                                    reader=_FlakyPort(64, 80),
                                    device_eval_transforms=True,
                                    **dict(SPARSE, short_side_size=64))
    val._check_canvas(np.zeros((4, 64, 80, 3), np.uint8), "a")
    with pytest.raises(RuntimeError, match="fixed decode raster"):
        val._check_canvas(np.zeros((4, 64, 96, 3), np.uint8), "b")


@pytest.mark.parametrize("mode", ["train", "validation", "test"])
def test_dense_and_ssv2_video_datasets_match_jax(tmp_path, mode):
    anno = _ann(tmp_path, "d.csv", 4)
    port, ref = _pair(tdx.VideoClsDatasetDense, jdx.VideoClsDatasetDense,
                      anno, mode=mode, frame_sample_rate=2, **SPARSE)
    _items_equal(port, ref)
    port, ref = _pair(tdx.SSVideoClsDataset, jdx.SSVideoClsDataset, anno,
                      mode=mode, num_segment=4,
                      **dict(SPARSE, clip_len=1, test_num_segment=2))
    _items_equal(port, ref)


def _frame_folders(tmp_path, n_videos=3):
    import cv2

    rng = _gen(11)
    root = tmp_path / "frames"
    lines = []
    for v in range(n_videos):
        d = root / f"vid{v}"
        d.mkdir(parents=True)
        n = 9 + 3 * v
        for i in range(n):
            img = rng.integers(0, 256, (36, 48, 3), dtype=np.uint8)
            cv2.imwrite(str(d / f"img_{i + 1:05d}.jpg"), img)
        # the middle column (frame count) is given for all but one
        lines.append(f"{d} {n if v else 0} {v % 2}")
    anno = tmp_path / "raw.txt"
    anno.write_text("\n".join(lines) + "\n")
    return str(anno)


@pytest.mark.parametrize("mode", ["train", "validation", "test"])
def test_ssv2_raw_frame_dataset_matches_jax(tmp_path, mode):
    anno = _frame_folders(tmp_path)
    kw = dict(mode=mode, clip_len=4, crop_size=24, short_side_size=32,
              test_num_segment=2, test_num_crop=2, seed=5)
    port = tdx.SSRawFrameClsDataset(anno, **kw)
    ref = jdx.SSRawFrameClsDataset(anno, **kw)
    assert isinstance(port.reader, tdx.RawFrameReader)
    _items_equal(port, ref)


def test_raw_frame_reader_refuses_the_native_decoder(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        tdx.RawFrameReader(use_native=True)
    reader = tdx.RawFrameReader()
    with pytest.raises(FileNotFoundError):
        reader.num_frames(str(tmp_path / "none"))
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="item 6"):
        reader.get_batch(str(tmp_path), [0])


# ------------------------------------------------------------ build_dataset


def _build_args(**kw):
    args = SimpleNamespace(
        data_set="Kinetics_sparse", nb_classes=5, num_frames=4,
        input_size=32, short_side_size=40, test_num_segment=2,
        test_num_crop=3, split=",", seed=3, sampling_rate=0,
        aa="rand-m7-n4-mstd0.5-inc1", train_interpolation="bicubic",
        reprob=0.25, remode="pixel", recount=1, num_sample=1,
        train_fraction=1.0, return_aug_for_val=False, device_normalize=True,
        device_eval_transforms=False, use_raw_frames=False)
    args.__dict__.update(kw)
    return args


@pytest.mark.parametrize("data_set,nb,kw", [
    ("Kinetics_sparse", 5, {}), ("mitv1_sparse", 7, {}),
    ("UCF101", 101, {}), ("HMDB51", 0, {}),
    ("Kinetics", 5, dict(sampling_rate=3)),
    ("SSV2", 174, {}), ("Kinetics_sparse", 5, dict(sampling_rate=2))])
def test_build_dataset_dispatch_matches_jax(tmp_path, data_set, nb, kw):
    anno = _ann(tmp_path, "b.csv", 5)
    args = _build_args(data_set=data_set, nb_classes=nb, **kw)
    for mode in ("train", "test"):
        port, n = tbuild.build_dataset(
            mode, args, anno, reader=treader.SyntheticVideoReader(64, 80))
        ref, jn = jbuild.build_dataset(
            mode, args, anno, reader=jreader.SyntheticVideoReader(64, 80))
        assert n == jn and type(port).__name__ == type(ref).__name__
        assert port.no_horizontal_flip == ref.no_horizontal_flip
        assert port.frame_sample_rate == ref.frame_sample_rate
        _items_equal(port, ref, epochs=(1,), indices=[0, len(ref) - 1])
    assert tbuild.DATASET_NB_CLASSES == jbuild.DATASET_NB_CLASSES


@pytest.mark.parametrize("data_set,nb,err", [
    ("UCF101", 12, ValueError), ("NotADataset", 0, NotImplementedError)])
def test_build_dataset_errors_match_jax(tmp_path, data_set, nb, err):
    anno = _ann(tmp_path, "e.csv", 2)
    args = _build_args(data_set=data_set, nb_classes=nb)
    with pytest.raises(err) as got:
        tbuild.build_dataset("train", args, anno,
                             reader=treader.SyntheticVideoReader(64, 80))
    with pytest.raises(err) as ref:
        jbuild.build_dataset("train", args, anno,
                             reader=jreader.SyntheticVideoReader(64, 80))
    assert str(got.value) == str(ref.value)


# ------------------------------------------------- the device val transform


@pytest.mark.parametrize("shape,short,crop", [
    ((2, 3, 40, 56, 3), 32, 24), ((1, 2, 64, 48, 3), 32, 24),
    ((2, 2, 24, 24, 3), 32, 24), ((1, 1, 100, 300, 3), 32, 24),
    ((2, 4, 32, 40, 3), 32, 32)])
def test_device_val_transform_matches_jax(shape, short, crop):
    v = _gen(12).integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(jev.device_val_transform(jnp.asarray(v), short, crop,
                                              jnp.float32))
    got = tev.make_device_val_transform(short, crop, torch.float32)(
        torch.from_numpy(v))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    x = torch.from_numpy(ref.copy())  # float input: cast only, as in JAX
    assert torch.equal(tev.device_val_transform(x, short, crop,
                                                torch.float32), x)
    raw = torch.from_numpy(v)  # the short side already there: no resize
    assert tev.resize_short_side(raw, min(shape[-3], shape[-2])) is raw


def test_cv2_reader_resizes_after_decode(tmp_path):
    import cv2

    path = str(tmp_path / "v.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (48, 36))
    for i in range(6):
        w.write(_gen(i).integers(0, 256, (36, 48, 3), dtype=np.uint8))
    w.release()
    for kw in ({}, dict(short_side=24)):
        got = treader.CV2VideoReader(**kw)
        ref = jreader.CV2VideoReader(**kw)
        assert got.num_frames(path) == ref.num_frames(path) == 6
        _same(got.get_batch(path, [4, 0, 2]), ref.get_batch(path, [4, 0, 2]))
    reader = treader.default_reader(short_side=24)
    assert isinstance(reader, treader.CV2VideoReader)
    assert reader.short_side == 24
