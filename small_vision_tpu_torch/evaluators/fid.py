"""FID and Inception Score, with the moments summed on the device.

Counterpart of small_vision_tpu/evaluators/fid.py:
`create_fid_score_fn(batch_size, ref_stats_path)` -> fn(uint8 samples) ->
(fid, inception_score). Each batch is resized to 299² on the device,
goes through InceptionV3 (`evaluators/inception.py`, cuDNN convolutions in
full f32: TF32 is switched off around the call), and adds its masked
n, Σx, Σxxᵀ in f32 there; only the (2048,) and (2048, 2048) sums and the
(B, 1008) probabilities reach the host, where they accumulate in f64.
The Fréchet distance takes scipy's `sqrtm` on the host; the Inception
Score averages exp KL(p(y|x) ‖ p(y)) over 10 splits.

`_resize_299` is `jax.image.resize(..., "bilinear")`'s computation: for
each spatial axis a (in, 299) matrix of triangle-kernel weights at
half-pixel centres, normalised per output pixel, applied as two f32
products. At the border an output pixel's weights on the pixel past the
edge are dropped and the rest renormalised, which leaves it the edge
pixel's value.
"""

import contextlib
from typing import Optional, Tuple

import numpy as np
import scipy.linalg
import torch

from small_vision_tpu_torch.evaluators import inception

FEATURE_DIM = inception.FEATURE_DIM
SIZE = 299


def _weight_mat(in_size: int, out_size: int, device) -> torch.Tensor:
  """(in, out) f32 bilinear weights of jax.image.resize (no translation)."""
  inv_scale = torch.tensor(in_size / out_size, dtype=torch.float32)
  kernel_scale = torch.clamp(inv_scale, min=1.0)  # antialias when shrinking
  sample = ((torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale
            - 0.5)
  x = torch.abs(sample[None, :] - torch.arange(
      in_size, dtype=torch.float32)[:, None]) / kernel_scale
  w = torch.clamp(1.0 - torch.abs(x), min=0.0)
  total = w.sum(dim=0, keepdim=True)
  w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                  w / torch.where(total != 0, total, 1.0), 0.0)
  inside = (sample >= -0.5) & (sample <= in_size - 0.5)
  return torch.where(inside[None, :], w, 0.0).to(device)


def _resize_299(images_uint8: torch.Tensor) -> torch.Tensor:
  """uint8 (B, H, W, C) -> f32 (B, 3, 299, 299) in [-1, 1], bilinear; one
  channel is repeated to three."""
  x = images_uint8.float().permute(0, 3, 1, 2) / 255.0  # (B, C, H, W)
  h, w = x.shape[2:]
  if w != SIZE:
    x = x @ _weight_mat(w, SIZE, x.device)
  if h != SIZE:
    x = _weight_mat(h, SIZE, x.device).T @ x
  if x.shape[1] == 1:
    x = x.expand(-1, 3, -1, -1)
  return 2.0 * x - 1.0


@contextlib.contextmanager
def _full_f32():
  """cuDNN convolutions and cuBLAS products in f32, not TF32."""
  with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
      yield
    finally:
      torch.backends.cuda.matmul.allow_tf32 = old


def make_activation_fn(model):
  """fn(uint8 images (B, H, W, C), mask (B,)) -> (probs, Σx, Σxxᵀ) on the
  images' device; `mask` zeroes padded rows out of the moment sums."""

  @torch.inference_mode()
  def activation_fn(images_uint8, mask):
    with _full_f32():
      pool3, logits = model(_resize_299(images_uint8))
      probs = torch.softmax(logits, dim=-1)
      pool3 = pool3 * mask[:, None]
      return probs, pool3.sum(dim=0), pool3.T @ pool3
  return activation_fn


class StreamingMoments:
  """Accumulates n, Σx, Σxxᵀ in f64; (mu, sigma) with numpy.cov's unbiased
  (n - 1) normalisation."""

  def __init__(self, dim=FEATURE_DIM):
    self.n = 0
    self.s = np.zeros((dim,), np.float64)
    self.outer = np.zeros((dim, dim), np.float64)

  def update(self, n, s, outer):
    self.n += int(n)
    self.s += np.asarray(s, np.float64)
    self.outer += np.asarray(outer, np.float64)

  def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
    if self.n <= 1:
      raise ValueError(f"need more than 1 sample for a covariance, got "
                       f"{self.n}")
    mu = self.s / self.n
    sigma = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
    return mu, sigma


def compute_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
  """|mu1 - mu2|² + tr(S1 + S2 - 2 (S1 S2)^½), sqrtm by scipy on the host.
  (`sqrtm` is called without `disp`, which scipy has deprecated: the
  default returns the matrix alone in every version.)"""
  mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
  sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
  diff = mu1 - mu2
  covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
  if not np.isfinite(covmean).all():
    offset = np.eye(sigma1.shape[0]) * eps
    covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
  if np.iscomplexobj(covmean):
    covmean = covmean.real
  return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
          - 2 * np.trace(covmean))


def compute_inception_score(probs, splits=10):
  """Mean over `splits` chunks of exp of the mean KL(p(y|x) ‖ p(y))."""
  probs = np.asarray(probs, np.float64)
  scores = []
  n = probs.shape[0]
  for i in range(splits):
    part = probs[i * n // splits:(i + 1) * n // splits]
    if part.shape[0] == 0:
      continue
    py = np.mean(part, axis=0, keepdims=True)
    kl = np.sum(part * (np.log(part + 1e-16) - np.log(py + 1e-16)), axis=1)
    scores.append(np.exp(np.mean(kl)))
  return float(np.mean(scores))


def _accumulate(images_uint8, activation_fn, batch_size, device, moments):
  """Streams uint8 images through `activation_fn` in batches of
  `batch_size`, the last zero-padded and masked; adds to `moments`;
  returns the real rows' probabilities."""
  all_probs = []
  for i in range(0, images_uint8.shape[0], batch_size):
    chunk = torch.as_tensor(np.asarray(images_uint8[i:i + batch_size]))
    real = chunk.shape[0]
    mask = torch.zeros((batch_size,), dtype=torch.float32)
    mask[:real] = 1.0
    if real < batch_size:
      chunk = torch.cat([chunk, chunk.new_zeros(
          (batch_size - real,) + tuple(chunk.shape[1:]))])
    probs, s, outer = activation_fn(chunk.to(device), mask.to(device))
    moments.update(real, s.double().cpu().numpy(),
                   outer.double().cpu().numpy())
    all_probs.append(probs[:real].cpu().numpy())
  return all_probs


def compute_statistics(images_uint8, activation_fn, batch_size=256,
                       device="cuda"):
  """(mu, sigma, probs) of uint8 images (N, H, W, C)."""
  moments = StreamingMoments()
  probs = _accumulate(images_uint8, activation_fn, batch_size, device,
                      moments)
  mu, sigma = moments.finalize()
  return mu, sigma, np.concatenate(probs)


def load_reference_stats(path):
  """(mu, sigma) from an .npz (keys mu, sigma) or a stacked .npy."""
  if path.endswith(".npz"):
    with np.load(path) as d:
      return d["mu"], d["sigma"]
  arr = np.load(path, allow_pickle=True)
  if isinstance(arr, np.ndarray) and arr.dtype == object:
    d = arr.item()
    return d["mu"], d["sigma"]
  return arr[0], arr[1]


def create_fid_score_fn(batch_size: int, reference_stats_path: str,
                        weights_path: Optional[str] = None, device="cuda"):
  """fn(uint8 samples) -> (fid, inception_score) against the reference
  statistics, with InceptionV3 from `weights_path` (seeded without)."""
  activation_fn = make_activation_fn(
      inception.init_params(weights_path, device=device))
  ref_mu, ref_sigma = load_reference_stats(reference_stats_path)

  def fid_fn(samples_uint8):
    mu, sigma, probs = compute_statistics(samples_uint8, activation_fn,
                                          batch_size, device)
    fid = compute_frechet_distance(mu, sigma, ref_mu, ref_sigma)
    return float(fid), float(compute_inception_score(probs))
  return fid_fn


def compute_reference_stats(source_iter, out_path, batch_size=256,
                            weights_path=None, max_examples=None,
                            device="cuda"):
  """Writes the reference (mu, sigma) of an iterator of uint8 image chunks
  (N, H, W, C) to `out_path` (.npz) and returns them. The moments are the
  sums over every chunk (the JAX function finalises each chunk and
  re-expands its sums, the same numbers up to f64 rounding)."""
  activation_fn = make_activation_fn(
      inception.init_params(weights_path, device=device))
  moments = StreamingMoments()
  seen = 0
  for chunk in source_iter:
    chunk = np.asarray(chunk)
    if max_examples and seen + chunk.shape[0] > max_examples:
      chunk = chunk[:max_examples - seen]
    if chunk.shape[0] == 0:
      break
    _accumulate(chunk, activation_fn, batch_size, device, moments)
    seen += chunk.shape[0]
    if max_examples and seen >= max_examples:
      break
  mu, sigma = moments.finalize()
  np.savez(out_path, mu=mu, sigma=sigma)
  return mu, sigma
