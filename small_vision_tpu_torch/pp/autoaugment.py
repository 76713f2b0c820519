"""RandAugment and AutoAugment: host-stage pp ops on PIL.

Counterpart of small_vision_tpu/pp/autoaugment.py: the EfficientNet policy
set's ops with its magnitude semantics (_MAX_LEVEL = 10, additive
translate and shear scaling, cutout), as the `randaug(num_layers,
magnitude)` and `autoaugment(policy)` ops. Their draws come from the
example's `_rng`. PIL is imported when an op runs, not with this module.
"""

import numpy as np

from small_vision_tpu_torch.pp.registry import Registry
from small_vision_tpu_torch.pp.utils import InKeyOutKey

_MAX_LEVEL = 10.0
_REPLACE = (128, 128, 128)


def _mag(level, maxval):
  return level / _MAX_LEVEL * maxval


def _rand_negate(rng, v):
  return -v if rng.random() < 0.5 else v


def _autocontrast(im, level, rng):
  from PIL import ImageOps
  return ImageOps.autocontrast(im)


def _equalize(im, level, rng):
  from PIL import ImageOps
  return ImageOps.equalize(im)


def _invert(im, level, rng):
  from PIL import ImageOps
  return ImageOps.invert(im)


def _rotate(im, level, rng):
  deg = _rand_negate(rng, _mag(level, 30.0))
  return im.rotate(deg, fillcolor=_REPLACE)


def _posterize(im, level, rng):
  from PIL import ImageOps
  bits = 8 - int(_mag(level, 4))
  return ImageOps.posterize(im, max(bits, 1))


def _solarize(im, level, rng):
  from PIL import ImageOps
  return ImageOps.solarize(im, 256 - int(_mag(level, 256)))


def _solarize_add(im, level, rng, threshold=128):
  add = int(_mag(level, 110))
  arr = np.asarray(im, np.int32)
  out = np.where(arr < threshold, np.clip(arr + add, 0, 255), arr)
  from PIL import Image
  return Image.fromarray(out.astype(np.uint8))


def _enhance(name):
  """The ImageEnhance class `name` at the level's factor."""
  def op(im, level, rng):
    from PIL import ImageEnhance
    factor = _mag(level, 1.8) + 0.1
    return getattr(ImageEnhance, name)(im).enhance(factor)
  return op


def _shear_x(im, level, rng):
  v = _rand_negate(rng, _mag(level, 0.3))
  from PIL import Image
  return im.transform(im.size, Image.AFFINE, (1, v, 0, 0, 1, 0),
                      fillcolor=_REPLACE)


def _shear_y(im, level, rng):
  v = _rand_negate(rng, _mag(level, 0.3))
  from PIL import Image
  return im.transform(im.size, Image.AFFINE, (1, 0, 0, v, 1, 0),
                      fillcolor=_REPLACE)


def _translate_x(im, level, rng, translate_const=100.0):
  # Pixel translate scaled to `translate_const` at max level, relative to
  # EfficientNet's 331 px resolution. RandAugment uses 100, AutoAugment's
  # policies 250.
  v = _rand_negate(rng, _mag(level, translate_const)) * im.size[0] / 331.0
  from PIL import Image
  return im.transform(im.size, Image.AFFINE, (1, 0, v, 0, 1, 0),
                      fillcolor=_REPLACE)


def _translate_y(im, level, rng, translate_const=100.0):
  v = _rand_negate(rng, _mag(level, translate_const)) * im.size[1] / 331.0
  from PIL import Image
  return im.transform(im.size, Image.AFFINE, (1, 0, 0, 0, 1, v),
                      fillcolor=_REPLACE)


def _cutout(im, level, rng, cutout_const=40):
  # cutout_const: 40 for randaug, 100 for AutoAugment.
  size = int(_mag(level, cutout_const)) * im.size[0] // 331
  if size <= 0:
    return im
  arr = np.array(im)
  h, w = arr.shape[:2]
  cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
  y0, y1 = max(cy - size // 2, 0), min(cy + size // 2, h)
  x0, x1 = max(cx - size // 2, 0), min(cx + size // 2, w)
  arr[y0:y1, x0:x1] = _REPLACE
  from PIL import Image
  return Image.fromarray(arr)


NAME_TO_FUNC = {
    "AutoContrast": _autocontrast,
    "Equalize": _equalize,
    "Invert": _invert,
    "Rotate": _rotate,
    "Posterize": _posterize,
    "Solarize": _solarize,
    "SolarizeAdd": _solarize_add,
    "Color": _enhance("Color"),
    "Contrast": _enhance("Contrast"),
    "Brightness": _enhance("Brightness"),
    "Sharpness": _enhance("Sharpness"),
    "ShearX": _shear_x,
    "ShearY": _shear_y,
    "TranslateX": _translate_x,
    "TranslateY": _translate_y,
    "Cutout": _cutout,
}

# The ops RandAugment draws from.
RANDAUG_OPS = list(NAME_TO_FUNC)


def distort_image_with_randaugment(image: np.ndarray, num_layers: int,
                                   magnitude: int,
                                   rng: np.random.Generator) -> np.ndarray:
  """Applies `num_layers` randomly chosen ops at the given magnitude."""
  from PIL import Image
  im = Image.fromarray(np.asarray(image, np.uint8))
  for _ in range(num_layers):
    op_name = RANDAUG_OPS[int(rng.integers(0, len(RANDAUG_OPS)))]
    im = NAME_TO_FUNC[op_name](im, float(magnitude), rng)
  return np.asarray(im.convert("RGB"))


@Registry.register("randaug")
@InKeyOutKey()
def get_randaug(num_layers: int = 2, magnitude: int = 10):
  """The `randaug(2, 10)` pp op."""

  def _randaug(image, data):
    rng = data.get("_rng") or np.random.default_rng()
    return distort_image_with_randaugment(
        np.asarray(image), num_layers, magnitude, rng)
  return _randaug


# AutoAugment's learned policies: (operation, probability, magnitude)
# pairs; each sub-policy applies its ops in sequence, and one sub-policy is
# drawn uniformly per image. The values are the published AutoAugment
# ImageNet policy.
POLICY_V0 = [
    [("Equalize", 0.8, 1), ("ShearY", 0.8, 4)],
    [("Color", 0.4, 9), ("Equalize", 0.6, 3)],
    [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
    [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
    [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
    [("Color", 0.2, 0), ("Equalize", 0.8, 8)],
    [("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)],
    [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
    [("Color", 0.6, 1), ("Equalize", 1.0, 2)],
    [("Invert", 0.4, 9), ("Rotate", 0.6, 0)],
    [("Equalize", 1.0, 9), ("ShearY", 0.6, 3)],
    [("Color", 0.4, 7), ("Equalize", 0.6, 0)],
    [("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)],
    [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
    [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
    [("Rotate", 1.0, 7), ("TranslateY", 0.8, 9)],
    [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
    [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
    [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
    [("Equalize", 0.8, 4), ("Equalize", 0.0, 8)],
    [("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)],
    [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
    [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
    [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
    [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
]

POLICY_VTEST = [
    [("TranslateX", 1.0, 4), ("Equalize", 1.0, 10)],
]

AVAILABLE_POLICIES = {"v0": POLICY_V0, "test": POLICY_VTEST}


def distort_image_with_autoaugment(image: np.ndarray, policy_name: str,
                                   rng: np.random.Generator) -> np.ndarray:
  """One uniformly drawn sub-policy; each op fires with its probability."""
  if policy_name not in AVAILABLE_POLICIES:
    raise ValueError(f"Invalid augmentation_name: {policy_name}")
  policy = AVAILABLE_POLICIES[policy_name]
  sub = policy[int(rng.integers(0, len(policy)))]
  from PIL import Image
  im = Image.fromarray(np.asarray(image, np.uint8))
  # AutoAugment's translate_const=250 and cutout_const=100, stronger than
  # randaug's 100 and 40.
  hparams = {
      "TranslateX": {"translate_const": 250.0},
      "TranslateY": {"translate_const": 250.0},
      "Cutout": {"cutout_const": 100},
  }
  for name, prob, magnitude in sub:
    if rng.random() < prob:
      im = NAME_TO_FUNC[name](im, float(magnitude), rng, **hparams.get(name, {}))
  return np.asarray(im.convert("RGB"))


@Registry.register("autoaugment")
@InKeyOutKey()
def get_autoaugment(policy: str = "v0"):
  """`autoaugment("v0")` pp op applying the learned ImageNet policy."""

  def _autoaugment(image, data):
    rng = data.get("_rng") or np.random.default_rng()
    return distort_image_with_autoaugment(np.asarray(image), policy, rng)
  return _autoaugment
