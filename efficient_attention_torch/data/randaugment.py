"""RandAugment and colour jitter on the host (PIL, timm's policy).

Counterpart of ``efficient_attention_tpu/data/randaugment.py``: the DeiT
recipe trains with ``--aa rand-m9-mstd0.5-inc1 --color-jitter 0.4``
(``vit/main.py:105-118``, timm ``create_transform``).

* config ``rand-m{M}-mstd{S}[-inc1][-n{N}][-p{P}]``: ``N`` ops an image
  (default 2), each drawn uniformly from the pool and applied with
  probability ``P`` (default 0.5), at magnitude ``~ N(M, S)`` clamped to
  [0, 10];
* the 15-op ``inc1`` pool, where strength grows with the magnitude;
  geometric ops fill with the ImageNet mean colour;
* ``build_train_augment``: auto-augment wins and disables colour jitter, as
  in timm.

With the same ``np.random.Generator`` every op and policy returns the JAX
package's image bit for bit.  Unlike JAX's, the ops are module-level
functions and the augment callables are objects, so they pickle: the
loader's process backend takes them.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

FILL = (124, 116, 104)  # ImageNet mean color
LEVEL_DENOM = 10.0


def _randsign(rng) -> float:
    return 1.0 if rng.random() < 0.5 else -1.0


def _affine(img, coeffs):
    return img.transform(img.size, Image.AFFINE, coeffs, Image.BICUBIC,
                         fillcolor=FILL)


def _solarize_add(img, add, thresh=128):
    arr = np.asarray(img, np.int32)
    arr = np.where(arr < thresh, np.clip(arr + add, 0, 255), arr)
    return Image.fromarray(arr.astype(np.uint8))


# the pool: fn(img, magnitude, rng) -> img, in JAX's order
def auto_contrast(img, m, rng):
    return ImageOps.autocontrast(img)


def equalize(img, m, rng):
    return ImageOps.equalize(img)


def invert(img, m, rng):
    return ImageOps.invert(img)


def rotate(img, m, rng):
    return img.rotate(_randsign(rng) * (m / LEVEL_DENOM) * 30.0,
                      resample=Image.BICUBIC, fillcolor=FILL)


def posterize_increasing(img, m, rng):
    return ImageOps.posterize(img, max(4 - int((m / LEVEL_DENOM) * 4), 1))


def solarize_increasing(img, m, rng):
    return ImageOps.solarize(img, 256 - int((m / LEVEL_DENOM) * 256))


def solarize_add(img, m, rng):
    return _solarize_add(img, int((m / LEVEL_DENOM) * 110))


def _enhance(cls_name, img, m, rng):
    # strength grows with m, direction random
    f = 1.0 + _randsign(rng) * (m / LEVEL_DENOM) * 0.9
    return getattr(ImageEnhance, cls_name)(img).enhance(max(f, 0.1))


def shear_x(img, m, rng):
    return _affine(img, (1, _randsign(rng) * (m / LEVEL_DENOM) * 0.3, 0,
                         0, 1, 0))


def shear_y(img, m, rng):
    return _affine(img, (1, 0, 0,
                         _randsign(rng) * (m / LEVEL_DENOM) * 0.3, 1, 0))


def translate_x_rel(img, m, rng):
    v = int(_randsign(rng) * (m / LEVEL_DENOM) * 0.45 * img.size[0])
    return _affine(img, (1, 0, v, 0, 1, 0))


def translate_y_rel(img, m, rng):
    v = int(_randsign(rng) * (m / LEVEL_DENOM) * 0.45 * img.size[1])
    return _affine(img, (1, 0, 0, 0, 1, v))


OPS = (
    ("AutoContrast", auto_contrast),
    ("Equalize", equalize),
    ("Invert", invert),
    ("Rotate", rotate),
    ("PosterizeIncreasing", posterize_increasing),
    ("SolarizeIncreasing", solarize_increasing),
    ("SolarizeAdd", solarize_add),
    ("ColorIncreasing", functools.partial(_enhance, "Color")),
    ("ContrastIncreasing", functools.partial(_enhance, "Contrast")),
    ("BrightnessIncreasing", functools.partial(_enhance, "Brightness")),
    ("SharpnessIncreasing", functools.partial(_enhance, "Sharpness")),
    ("ShearX", shear_x),
    ("ShearY", shear_y),
    ("TranslateXRel", translate_x_rel),
    ("TranslateYRel", translate_y_rel),
)


class RandAugment:
    """The ``rand-m{M}-mstd{S}[-inc1][-n{N}][-p{P}]`` policy; called as
    ``fn(img, rng)``."""

    def __init__(self, magnitude: float = 9.0, mstd: float = 0.5,
                 num_layers: int = 2, prob: float = 0.5):
        self.magnitude = magnitude
        self.mstd = mstd
        self.num_layers = num_layers
        self.prob = prob
        self.ops = OPS

    @classmethod
    def from_config(cls, config: str) -> "RandAugment":
        parts = config.split("-")
        assert parts[0] == "rand", f"unsupported auto-augment '{config}'"
        kw = dict(magnitude=9.0, mstd=0.5, num_layers=2, prob=0.5)
        for p in parts[1:]:
            if p.startswith("mstd"):
                kw["mstd"] = float(p[4:])
            elif p.startswith("inc"):
                pass  # the pool above is the increasing pool
            elif p.startswith("m"):
                kw["magnitude"] = float(p[1:])
            elif p.startswith("n"):
                kw["num_layers"] = int(p[1:])
            elif p.startswith("p"):
                kw["prob"] = float(p[1:])
        return cls(**kw)

    def __call__(self, img: Image.Image, rng: np.random.Generator):
        for _ in range(self.num_layers):
            if rng.random() > self.prob:
                continue
            _, fn = self.ops[int(rng.integers(len(self.ops)))]
            m = self.magnitude
            if self.mstd > 0:
                m = float(np.clip(rng.normal(m, self.mstd), 0, LEVEL_DENOM))
            img = fn(img, m, rng)
        return img


def color_jitter(img: Image.Image, rng: np.random.Generator,
                 strength: float = 0.4) -> Image.Image:
    """Brightness, contrast and saturation, each by a factor
    ``U[1 - s, 1 + s]``, in a random order (``transforms.ColorJitter(s, s,
    s)``)."""
    ops = [ImageEnhance.Brightness, ImageEnhance.Contrast,
           ImageEnhance.Color]
    order = rng.permutation(len(ops))
    for i in order:
        f = float(rng.uniform(max(0.0, 1 - strength), 1 + strength))
        img = ops[i](img).enhance(f)
    return img


def build_train_augment(
    auto_augment: Optional[str],
    color_jitter_strength: Optional[float],
) -> Optional[Callable]:
    """timm ``transforms_imagenet_train``'s dispatch: an auto-augment policy
    wins and disables colour jitter; without one, colour jitter applies
    where its strength is set; else None."""
    if auto_augment:
        return RandAugment.from_config(auto_augment)
    if color_jitter_strength:
        return functools.partial(color_jitter,
                                 strength=color_jitter_strength)
    return None
