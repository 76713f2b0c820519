"""Image preprocessing ops.

Counterpart of small_vision_tpu/pp/ops_image.py:

  host stage (numpy, per example): decode, decode_jpeg_and_inception_crop
    (the training hot path on JPEGs), inception_crop, resize,
    resize_small, resize_long, central_crop, random_crop, grayscale;
  device stage (batches of tensors): flip_lr, vgg_value_range,
    clip_value_range (value_range is in ops_general).

Host ops draw randomness from `data["_rng"]`, a numpy Generator the input
pipeline seeds per example. PIL is imported only by the ops that need it:
`decode`, the PIL path of `decode_jpeg_and_inception_crop`, and the
`bicubic` and `area` resizes. The bilinear and nearest resizes are
TensorFlow's (`tf.image.resize`: half-pixel centres, no antialias), which
the JAX package calls where TensorFlow is installed, here in numpy.
"""

import io

import numpy as np
import torch

from small_vision_tpu_torch.pp.registry import Registry
from small_vision_tpu_torch.pp.utils import InKeyOutKey, maybe_repeat


def _rng_of(data) -> np.random.Generator:
  rng = data.get("_rng")
  return rng if rng is not None else np.random.default_rng()


def _decode_bytes(value) -> np.ndarray:
  """JPEG/PNG bytes -> uint8 HWC RGB array, by PIL."""
  if isinstance(value, np.ndarray) and value.dtype != object:
    return value  # Already decoded.
  from PIL import Image
  raw = bytes(value) if not isinstance(value, bytes) else value
  with Image.open(io.BytesIO(raw)) as im:
    return np.asarray(im.convert("RGB"))


@Registry.register("decode")
def get_decode(channels: int = 3):
  """Decodes compressed image bytes to uint8 RGB."""
  del channels

  def decode(data):
    data["image"] = _decode_bytes(data["image"])
    return data
  return decode


def _half_pixel(in_size: int, out_size: int, nearest: bool):
  """TensorFlow's source coordinates of `out_size` outputs over `in_size`
  inputs (half-pixel centres), in f32 as its kernels compute them:
  (lower, upper, lerp) for bilinear, the index for nearest."""
  scale = np.float32(in_size) / np.float32(out_size)
  i = np.arange(out_size, dtype=np.float32)
  if nearest:
    src = np.floor((i + np.float32(0.5)) * scale).astype(np.int64)
    return np.clip(src, 0, in_size - 1)
  src = (i + np.float32(0.5)) * scale - np.float32(0.5)
  floor = np.floor(src)
  lower = np.maximum(floor.astype(np.int64), 0)
  upper = np.minimum(np.ceil(src).astype(np.int64), in_size - 1)
  return lower, upper, (src - floor).astype(np.float32)


def _tf_resize(img: np.ndarray, size, method: str) -> np.ndarray:
  """tf.image.resize(img, size, method) for "bilinear" (f32 out) and
  "nearest" (the input's dtype), on an (H, W) or (H, W, C) array."""
  h, w = size
  if h <= 0 or w <= 0:
    raise ValueError(f"resize to {size}: output dimensions must be positive")
  if method == "nearest":
    ys = _half_pixel(img.shape[0], h, True)
    xs = _half_pixel(img.shape[1], w, True)
    return img[ys][:, xs]
  y0, y1, ly = _half_pixel(img.shape[0], h, False)
  x0, x1, lx = _half_pixel(img.shape[1], w, False)
  x = img.astype(np.float32)
  extra = (None,) * (x.ndim - 2)
  lx = lx[(None, slice(None)) + extra]
  ly = ly[(slice(None), None) + extra]
  top, bottom = x[y0], x[y1]
  top = top[:, x0] + (top[:, x1] - top[:, x0]) * lx
  bottom = bottom[:, x0] + (bottom[:, x1] - bottom[:, x0]) * lx
  return top + (bottom - top) * ly


def _resize_np(img: np.ndarray, size, method="bilinear") -> np.ndarray:
  img = np.asarray(img)
  if method in ("bilinear", "nearest"):
    out = _tf_resize(img, tuple(size), method)
    # As tf.cast(clip(x, 0, 255), uint8): the cast truncates toward zero.
    return np.clip(out, 0, 255).astype(np.uint8) if (
        img.dtype == np.uint8) else out
  from PIL import Image
  resample = {"bicubic": Image.BICUBIC, "area": Image.BOX}[method]
  arr = img if img.dtype == np.uint8 else np.clip(img, 0, 255).astype(
      np.uint8)
  return np.asarray(Image.fromarray(arr).resize((size[1], size[0]), resample))


@Registry.register("resize")
@InKeyOutKey()
def get_resize(size, method: str = "bilinear"):
  """Resizes to (h, w); an int means square."""
  size = maybe_repeat(size, 2)

  def resize(image, data):
    del data
    return _resize_np(np.asarray(image), size, method)
  return resize


@Registry.register("resize_small")
@InKeyOutKey()
def get_resize_small(smaller_size: int, method: str = "bilinear"):
  """Scales so the shorter side equals `smaller_size`, keeping the aspect."""

  def resize_small(image, data):
    del data
    image = np.asarray(image)
    h, w = image.shape[:2]
    ratio = smaller_size / min(h, w)
    nh = smaller_size if h <= w else int(round(h * ratio))
    nw = smaller_size if w <= h else int(round(w * ratio))
    return _resize_np(image, (nh, nw), method)
  return resize_small


@Registry.register("resize_long")
@InKeyOutKey()
def get_resize_long(longer_size: int, method: str = "bilinear"):
  """Scales so the longer side equals `longer_size`."""

  def resize_long(image, data):
    del data
    image = np.asarray(image)
    h, w = image.shape[:2]
    ratio = longer_size / max(h, w)
    nh = longer_size if h >= w else int(round(h * ratio))
    nw = longer_size if w >= h else int(round(w * ratio))
    return _resize_np(image, (nh, nw), method)
  return resize_long


def _sample_inception_box(rng, h, w, area_min, area_max=100,
                          aspect_ratio_range=(0.75, 1.33), max_attempts=100):
  """tf.image.sample_distorted_bounding_box's sampler: the aspect ratio
  linear-uniform in the range, then an integer height uniform between the
  heights the area bounds allow; (y0, x0, h, w), or the whole image after
  `max_attempts` misses. Draw for draw the JAX package's."""
  min_area = area_min / 100 * h * w
  max_area = area_max / 100 * h * w
  for _ in range(max_attempts):
    ar = float(rng.uniform(*aspect_ratio_range))
    height = int(np.rint(np.sqrt(min_area / ar)))
    max_height = int(np.rint(np.sqrt(max_area / ar)))
    if np.rint(max_height * ar) > w:
      max_height = int((w + 0.5 - 1e-7) / ar)
      if np.rint(max_height * ar) > w:
        max_height -= 1
    max_height = min(max_height, h)
    height = min(height, max_height)
    if height < max_height:
      height += int(rng.integers(0, max_height - height + 1))
    width = int(np.rint(height * ar))
    if width * height < min_area:
      height += 1
      width = int(np.rint(height * ar))
    if width * height > max_area:
      height -= 1
      width = int(np.rint(height * ar))
    area = width * height
    if (area < min_area or area > max_area or width > w or height > h
        or width <= 0 or height <= 0):
      continue
    # TensorFlow's offset draw is Uniform(H - h), which leaves out the
    # placement flush with the far edge.
    y0 = int(rng.integers(0, h - height)) if height < h else 0
    x0 = int(rng.integers(0, w - width)) if width < w else 0
    return y0, x0, height, width
  return 0, 0, h, w


@Registry.register("inception_crop")
@InKeyOutKey()
def get_inception_crop(size=None, area_min: int = 5, area_max: int = 100,
                       method: str = "bilinear"):
  """Random distorted crop (and a resize to `size`) of a decoded image."""
  size = maybe_repeat(size, 2) if size else None

  def inception_crop(image, data):
    image = np.asarray(image)
    y0, x0, ch, cw = _sample_inception_box(
        _rng_of(data), image.shape[0], image.shape[1], area_min, area_max)
    crop = image[y0:y0 + ch, x0:x0 + cw]
    if size is not None:
      crop = _resize_np(crop, size, method)
    return crop
  return inception_crop


@Registry.register("decode_jpeg_and_inception_crop")
@InKeyOutKey()
def get_decode_jpeg_and_inception_crop(size=None, area_min: int = 5,
                                       area_max: int = 100,
                                       method: str = "bilinear"):
  """The training hot path on JPEGs: decode, random distorted crop, resize.

  With `size`, the native decoder (data/native_jpeg.py) decodes only as
  much as the crop needs, at a reduced libjpeg scale, from one seed drawn
  from the example's rng; where it is unavailable, or rejects a file, PIL
  decodes the whole image and the box is drawn from the rng itself, in
  the JAX package's order. A chunk of examples goes through the native
  decoder in one call (`batch`), bit-equal to the per-example path.
  """
  size = maybe_repeat(size, 2) if size else None

  def pil_path(raw, rng):
    from PIL import Image
    with Image.open(io.BytesIO(raw)) as im:
      w, h = im.size
      y0, x0, ch, cw = _sample_inception_box(rng, h, w, area_min, area_max)
      img = np.asarray(im.convert("RGB").crop((x0, y0, x0 + cw, y0 + ch)))
      if size is not None:
        img = _resize_np(img, size, method)
      return img

  def op(image, data):
    rng = _rng_of(data)
    if isinstance(image, np.ndarray) and image.dtype == np.uint8:
      # Already decoded (e.g. the synthetic source): crop and resize only.
      y0, x0, ch, cw = _sample_inception_box(
          rng, image.shape[0], image.shape[1], area_min, area_max)
      img = image[y0:y0 + ch, x0:x0 + cw]
      return _resize_np(img, size, method) if size is not None else img
    raw = bytes(image) if not isinstance(image, bytes) else image
    if size is not None:
      from small_vision_tpu_torch.data import native_jpeg
      if native_jpeg.available():
        try:
          return native_jpeg.decode_inception_crop(
              raw, size[0], size[1], area_min / 100, area_max / 100,
              seed=int(rng.integers(0, 2**63)))
        except ValueError:
          pass  # A file the native decoder rejects: PIL, same rng.
    return pil_path(raw, rng)

  def batch(images, datas):
    """The chunk in one native call, or None where the native decoder is
    unavailable (the caller then maps `op`)."""
    if size is None:
      return None
    from small_vision_tpu_torch.data import native_jpeg
    if not native_jpeg.available():
      return None
    outs = [None] * len(images)
    raws, seeds, idxs = [], [], []
    for i, (image, d) in enumerate(zip(images, datas)):
      if isinstance(image, np.ndarray) and image.dtype == np.uint8:
        outs[i] = op(image, d)
      else:
        raws.append(bytes(image) if not isinstance(image, bytes) else image)
        seeds.append(int(_rng_of(d).integers(0, 2**63)))
        idxs.append(i)
    if raws:
      arr, rcs = native_jpeg.decode_inception_crop_batch(
          raws, size[0], size[1], area_min / 100, area_max / 100, seeds)
      for j, i in enumerate(idxs):
        # A rejected file goes to PIL with the rng as the per-example path
        # leaves it: one seed drawn, no second native attempt.
        outs[i] = arr[j] if rcs[j] == 0 else pil_path(raws[j],
                                                      _rng_of(datas[i]))
    return outs

  op.batch = batch
  return op


@Registry.register("central_crop")
@InKeyOutKey()
def get_central_crop(size=None):
  """Centre crop to (h, w); pads with zeros where the image is smaller."""
  size = maybe_repeat(size, 2)

  def central_crop(image, data):
    del data
    image = np.asarray(image)
    h, w = image.shape[:2]
    th, tw = size
    if th > h or tw > w:
      py, px = max(th - h, 0), max(tw - w, 0)
      image = np.pad(image, ((py // 2, py - py // 2),
                             (px // 2, px - px // 2), (0, 0)))
      h, w = image.shape[:2]
    y0, x0 = (h - th) // 2, (w - tw) // 2
    return image[y0:y0 + th, x0:x0 + tw]
  return central_crop


@Registry.register("random_crop")
@InKeyOutKey()
def get_random_crop(size):
  size = maybe_repeat(size, 2)

  def random_crop(image, data):
    image = np.asarray(image)
    rng = _rng_of(data)
    h, w = image.shape[:2]
    th, tw = size
    y0 = int(rng.integers(0, h - th + 1))
    x0 = int(rng.integers(0, w - tw + 1))
    return image[y0:y0 + th, x0:x0 + tw]
  return random_crop


@Registry.register("grayscale")
@InKeyOutKey()
def get_grayscale(keep_channels: bool = True):

  def grayscale(image, data):
    del data
    image = np.asarray(image).astype(np.float32)
    gray = (0.2989 * image[..., 0] + 0.587 * image[..., 1]
            + 0.114 * image[..., 2])
    gray = gray[..., None]
    if keep_channels:
      gray = np.repeat(gray, 3, axis=-1)
    return gray.astype(np.uint8)
  return grayscale


# Device-stage ops: (apply, draw) on batches of tensors.


@Registry.register("flip_lr", stage="device")
def get_flip_lr():
  """Random horizontal flip per example: a (B,) bool draw `flip` (Bernoulli
  0.5), a reversed view and a select."""

  def draw(n, generator, device):
    return {"flip": torch.rand(n, generator=generator, device=device) < 0.5}

  def flip_lr(batch, draws):
    img = batch["image"]
    batch["image"] = torch.where(draws["flip"][:, None, None, None],
                                 img.flip(2), img)
    return batch
  return flip_lr, draw


def _normalize(mean, std):
  mean = torch.tensor(mean, dtype=torch.float32)
  std = torch.tensor(std, dtype=torch.float32)

  def normalize(batch, draws):
    del draws
    img = batch["image"].to(torch.float32)
    batch["image"] = (img - mean.to(img.device)) / std.to(img.device)
    return batch
  return normalize, None


@Registry.register("vgg_value_range", stage="device")
def get_vgg_value_range(
    mean=(0.485 * 255, 0.456 * 255, 0.406 * 255),
    std=(0.229 * 255, 0.224 * 255, 0.225 * 255)):
  """The torchvision (ImageNet) normalisation."""
  return _normalize(mean, std)


@Registry.register("clip_value_range", stage="device")
def get_clip_value_range(
    mean=(0.48145466 * 255, 0.4578275 * 255, 0.40821073 * 255),
    std=(0.26862954 * 255, 0.26130258 * 255, 0.27577711 * 255)):
  """CLIP's normalisation."""
  return _normalize(mean, std)
