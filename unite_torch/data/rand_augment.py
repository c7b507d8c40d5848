"""RandAugment over lists of PIL frames (unite_tpu/data/rand_augment.py):
the timm-style RandAugment of the reference's finetune pipeline
(rand_augment.py there; policy strings like ``rand-m7-n4-mstd0.5-inc1``,
parsed at kinetics_sparse.py:231-238 by
video_transforms.create_random_augment).
Semantics preserved: same op set, magnitude-to-parameter mappings
(_MAX_LEVEL=10), gaussian magnitude jitter (``mstd``), 'inc1' increasing
severity variants, per-clip consistent ops (every frame of the clip gets the
same transform draw), fixed fill color from the normalization mean. Every
draw comes from the caller's ``np.random.Generator``, in the JAX package's
order, so the ops, magnitudes and pixels equal its own.

Pillow is imported where an op runs, never when the module is imported:
resampling filters are named by their PIL values.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING, List, Optional

import numpy as np

from unite_torch.data.samplers import _require_rng

if TYPE_CHECKING:
    from PIL import Image

BILINEAR, BICUBIC = 2, 3  # PIL.Image.Resampling values
_AFFINE = 0  # PIL.Image.Transform.AFFINE
_MAX_LEVEL = 10.0
_FILL = (124, 116, 104)  # round(255 * imagenet mean)


def _interpolation(kwargs, rng: Optional[np.random.Generator] = None):
    interp = kwargs.pop("resample", BILINEAR)
    if isinstance(interp, (list, tuple)):
        rng = _require_rng(rng)
        return interp[int(rng.integers(len(interp)))]
    return interp


# --- op implementations (single PIL image) ---------------------------------


def auto_contrast(img, **__):
    from PIL import ImageOps

    return ImageOps.autocontrast(img)


def equalize(img, **__):
    from PIL import ImageOps

    return ImageOps.equalize(img)


def invert(img, **__):
    from PIL import ImageOps

    return ImageOps.invert(img)


def rotate(img, degrees, **kwargs):
    return img.rotate(degrees, fillcolor=kwargs.get("fillcolor", _FILL),
                      resample=_interpolation(dict(kwargs)))


def posterize(img, bits, **__):
    from PIL import ImageOps

    return ImageOps.posterize(img, max(1, int(bits)))


def solarize(img, thresh, **__):
    from PIL import ImageOps

    return ImageOps.solarize(img, int(thresh))


def solarize_add(img, add, thresh=128, **__):
    arr = np.asarray(img).astype(np.int32)
    arr = np.where(arr < thresh, np.clip(arr + add, 0, 255), arr)
    from PIL import Image

    return Image.fromarray(arr.astype(np.uint8), img.mode)


def color(img, factor, **__):
    from PIL import ImageEnhance

    return ImageEnhance.Color(img).enhance(factor)


def contrast(img, factor, **__):
    from PIL import ImageEnhance

    return ImageEnhance.Contrast(img).enhance(factor)


def brightness(img, factor, **__):
    from PIL import ImageEnhance

    return ImageEnhance.Brightness(img).enhance(factor)


def sharpness(img, factor, **__):
    from PIL import ImageEnhance

    return ImageEnhance.Sharpness(img).enhance(factor)


def shear_x(img, factor, **kwargs):
    # resample flows into every affine warp (reference rand_augment.py:
    # 84-111 via _check_args_tf) — dropping it would silently warp with
    # PIL's default NEAREST instead of the configured interpolation
    return img.transform(img.size, _AFFINE, (1, factor, 0, 0, 1, 0),
                         resample=_interpolation(dict(kwargs)),
                         fillcolor=kwargs.get("fillcolor", _FILL))


def shear_y(img, factor, **kwargs):
    return img.transform(img.size, _AFFINE, (1, 0, 0, factor, 1, 0),
                         resample=_interpolation(dict(kwargs)),
                         fillcolor=kwargs.get("fillcolor", _FILL))


def translate_x_rel(img, pct, **kwargs):
    pixels = pct * img.size[0]
    return img.transform(img.size, _AFFINE, (1, 0, pixels, 0, 1, 0),
                         resample=_interpolation(dict(kwargs)),
                         fillcolor=kwargs.get("fillcolor", _FILL))


def translate_y_rel(img, pct, **kwargs):
    pixels = pct * img.size[1]
    return img.transform(img.size, _AFFINE, (1, 0, 0, 0, 1, pixels),
                         resample=_interpolation(dict(kwargs)),
                         fillcolor=kwargs.get("fillcolor", _FILL))


# --- magnitude → parameter mappings -----------------------------------------


def _randomly_negate(v, rng: np.random.Generator):
    return -v if rng.random() > 0.5 else v


def _rotate_level(level, _hparams, rng):
    return (_randomly_negate((level / _MAX_LEVEL) * 30.0, rng),)


def _enhance_level(level, _hparams, _rng):
    return ((level / _MAX_LEVEL) * 1.8 + 0.1,)


def _enhance_increasing_level(level, _hparams, rng):
    return (1.0 + _randomly_negate((level / _MAX_LEVEL) * 0.9, rng),)


def _shear_level(level, _hparams, rng):
    return (_randomly_negate((level / _MAX_LEVEL) * 0.3, rng),)


def _translate_rel_level(level, hparams, rng):
    return (_randomly_negate((level / _MAX_LEVEL) * hparams.get(
        "translate_pct", 0.45), rng),)


def _posterize_level(level, _hparams, _rng=None):
    return (int((level / _MAX_LEVEL) * 4),)


def _posterize_increasing_level(level, hparams, _rng=None):
    return (4 - _posterize_level(level, hparams)[0],)


def _solarize_level(level, _hparams, _rng=None):
    return (min(256, int((level / _MAX_LEVEL) * 256)),)


def _solarize_increasing_level(level, hparams, _rng=None):
    return (256 - _solarize_level(level, hparams)[0],)


def _solarize_add_level(level, _hparams, _rng=None):
    return (min(128, int((level / _MAX_LEVEL) * 110)),)


def _none_level(_level, _hparams, _rng=None):
    return ()


NAME_TO_OP = {
    "AutoContrast": auto_contrast,
    "Equalize": equalize,
    "Invert": invert,
    "Rotate": rotate,
    "Posterize": posterize,
    "PosterizeIncreasing": posterize,
    "Solarize": solarize,
    "SolarizeIncreasing": solarize,
    "SolarizeAdd": solarize_add,
    "Color": color,
    "ColorIncreasing": color,
    "Contrast": contrast,
    "ContrastIncreasing": contrast,
    "Brightness": brightness,
    "BrightnessIncreasing": brightness,
    "Sharpness": sharpness,
    "SharpnessIncreasing": sharpness,
    "ShearX": shear_x,
    "ShearY": shear_y,
    "TranslateXRel": translate_x_rel,
    "TranslateYRel": translate_y_rel,
}

LEVEL_TO_ARG = {
    "AutoContrast": _none_level,
    "Equalize": _none_level,
    "Invert": _none_level,
    "Rotate": _rotate_level,
    "Posterize": _posterize_level,
    "PosterizeIncreasing": _posterize_increasing_level,
    "Solarize": _solarize_level,
    "SolarizeIncreasing": _solarize_increasing_level,
    "SolarizeAdd": _solarize_add_level,
    "Color": _enhance_level,
    "ColorIncreasing": _enhance_increasing_level,
    "Contrast": _enhance_level,
    "ContrastIncreasing": _enhance_increasing_level,
    "Brightness": _enhance_level,
    "BrightnessIncreasing": _enhance_increasing_level,
    "Sharpness": _enhance_level,
    "SharpnessIncreasing": _enhance_increasing_level,
    "ShearX": _shear_level,
    "ShearY": _shear_level,
    "TranslateXRel": _translate_rel_level,
    "TranslateYRel": _translate_rel_level,
}

_RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]

_RAND_INCREASING_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing",
    "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]


class AugmentOp:
    """One weighted op applied (with prob) at a jittered magnitude to every
    frame of a clip with the same draw."""

    def __init__(self, name: str, prob: float = 0.5, magnitude: float = 10,
                 hparams: Optional[dict] = None):
        hparams = hparams or {}
        self.name = name
        self.aug_fn = NAME_TO_OP[name]
        self.level_fn = LEVEL_TO_ARG[name]
        self.prob = prob
        self.magnitude = magnitude
        self.hparams = hparams
        self.kwargs = {
            "fillcolor": hparams.get("img_mean", _FILL),
            "resample": hparams.get("interpolation", BILINEAR),
        }
        self.magnitude_std = hparams.get("magnitude_std", 0)

    def __call__(self, frames: List["Image.Image"],
                 rng: Optional[np.random.Generator] = None
                 ) -> List["Image.Image"]:
        rng = _require_rng(rng)
        if self.prob < 1.0 and rng.random() > self.prob:
            return frames
        magnitude = self.magnitude
        if self.magnitude_std:
            if self.magnitude_std == float("inf"):
                magnitude = rng.uniform(0, magnitude)
            else:
                magnitude = rng.normal(magnitude, self.magnitude_std)
        magnitude = min(_MAX_LEVEL, max(0.0, magnitude))
        args = self.level_fn(magnitude, self.hparams, rng)
        kwargs = dict(self.kwargs)
        # resolve a tuple of candidate resampling filters to one draw here so
        # the per-image aug fns stay rng-free
        kwargs["resample"] = _interpolation(kwargs, rng)
        return [self.aug_fn(f, *args, **kwargs) for f in frames]


class RandAugment:
    def __init__(self, ops: List[AugmentOp], num_layers: int = 2):
        self.ops = ops
        self.num_layers = num_layers

    def __call__(self, frames: List["Image.Image"],
                 rng: Optional[np.random.Generator] = None
                 ) -> List["Image.Image"]:
        rng = _require_rng(rng)
        for i in rng.integers(0, len(self.ops), size=self.num_layers):
            frames = self.ops[int(i)](frames, rng)
        return frames


def rand_augment_transform(config_str: str, hparams: Optional[dict] = None
                           ) -> RandAugment:
    """Parse ``rand-m7-n4-mstd0.5-inc1`` style policies (timm grammar)."""
    hparams = dict(hparams or {})
    magnitude = _MAX_LEVEL
    num_layers = 2
    increasing = False
    config = config_str.split("-")
    assert config[0] == "rand", f"not a rand policy: {config_str}"
    for c in config[1:]:
        m = re.match(r"([a-z]+)([0-9.]+)", c)
        if not m:
            continue
        key, val = m.group(1), m.group(2)
        if key == "mstd":
            hparams["magnitude_std"] = float(val)
        elif key == "m":
            magnitude = float(val)
        elif key == "n":
            num_layers = int(val)
        elif key == "inc":
            increasing = bool(int(val))
        elif key == "w":
            pass  # weighted op sets not used by the reference configs
    names = _RAND_INCREASING_TRANSFORMS if increasing else _RAND_TRANSFORMS
    ops = [AugmentOp(n, prob=0.5, magnitude=magnitude, hparams=hparams)
           for n in names]
    return RandAugment(ops, num_layers)
