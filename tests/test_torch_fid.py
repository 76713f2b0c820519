"""Port parity: FID's InceptionV3, resize, moments, Fréchet distance and
Inception Score (`evaluators/{inception,fid}.py`) against the JAX
package's.

The repository has no Inception weights: both networks run on the port's
seeded weights, which reach the flax module through
`convert.inception_to_jax` (and, for the score functions, through the npz
layout of `scripts/convert_inception.py`, which both packages load). The
numpy parts (moments, Fréchet distance, IS) are the same arithmetic and
are held to 1e-12; the networks and the resize to f32 summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.evaluators import fid as jfid
from small_vision_tpu.evaluators import inception as jinception
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.evaluators import fid as tfid
from small_vision_tpu_torch.evaluators import inception as tinception
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

# Relative to max |want|: the same f32 network in other summation orders
# (cuDNN/oneDNN against XLA's convolutions), through 94 convolutions,
# BatchNorms and relus with activations of order 1.
NET_TOL = 1e-4


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
  """(port model on the CPU, flax variables, path of their npz)."""
  model = tinception.init_params(device="cpu", seed=3)
  variables = convert.inception_to_jax(model.state_dict())
  path = str(tmp_path_factory.mktemp("inception") / "inception.npz")
  np.savez(path, **dict(tree_flatten_with_names(variables)))
  return model, jax.tree.map(jnp.asarray, variables), path


def _uint8(shape, seed):
  return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (2, 32, 32, 3),
                                   (1, 17, 40, 3), (2, 16, 16, 1)])
def test_resize_299_matches_jax(shape):
  """jax.image.resize's bilinear weights, applied as two f32 products.
  XLA's CPU product of the weights is itself up to ~2e-6 from the f64
  resize on [-1, 1] (the port's ~2e-7), so the two agree within 5e-6.
  The corner pixels, where the weights past the border are dropped and
  renormalised, equal the edge pixel's value exactly on both sides."""
  images = _uint8(shape, seed=shape[1])
  want = np.asarray(jfid._resize_299(jnp.asarray(images)))
  got = tfid._resize_299(torch.from_numpy(images))
  assert got.shape == (shape[0], 3, 299, 299) and got.dtype == torch.float32
  got = got.permute(0, 2, 3, 1).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
  edge = 2.0 * (images.astype(np.float32) / 255.0) - 1.0
  if shape[-1] == 1:
    edge = np.repeat(edge, 3, axis=-1)
  for y, x in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
    np.testing.assert_array_equal(got[:, y, x], want[:, y, x])
    np.testing.assert_array_equal(got[:, y, x], edge[:, y, x])


def test_inception_matches_flax(seeded):
  """pool3 and the 1008 logits of a batch of 2 at 299, bridged weights."""
  model, variables, _ = seeded
  x = np.random.default_rng(1).uniform(-1, 1, (2, 299, 299, 3)).astype(
      np.float32)
  jpool3, jlogits = jax.jit(jinception.InceptionV3().apply)(
      variables, jnp.asarray(x))
  with torch.inference_mode():
    pool3, logits = model(torch.from_numpy(x).permute(0, 3, 1, 2))
  assert pool3.shape == (2, 2048) and logits.shape == (2, 1008)
  for got, want in ((pool3, jpool3), (logits, jlogits)):
    want = np.asarray(want)
    err = np.max(np.abs(got.numpy() - want))
    assert err <= NET_TOL * np.max(np.abs(want)), err


def test_the_bridge_round_trips_and_loads_the_npz(seeded):
  """flax variables -> state_dict -> flax variables is the identity; the
  npz of `scripts/convert_inception.py`'s layout loads into both packages
  with the same leaves."""
  model, variables, path = seeded
  state = convert.inception_state_dict(jax.device_get(variables), model)
  for k, v in model.state_dict().items():
    assert torch.equal(state[k], v), k
  loaded = tinception.init_params(path, device="cpu")
  for k, v in model.state_dict().items():
    assert torch.equal(loaded.state_dict()[k], v), k
  _, jvars = jinception.init_params(weights_path=path)
  want = dict(tree_flatten_with_names(jax.device_get(variables)))
  got = dict(tree_flatten_with_names(jax.device_get(jvars)))
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  bad = dict(want)
  bad.pop("params/fc/bias")
  with pytest.raises(KeyError, match="params/fc/bias"):
    convert.inception_state_dict(bad, model)


def test_streaming_moments_match_jax():
  rng = np.random.default_rng(2)
  tm, jm = tfid.StreamingMoments(dim=16), jfid.StreamingMoments(dim=16)
  for n in (5, 1, 9):
    feats = rng.standard_normal((n, 16)).astype(np.float32)
    for m in (tm, jm):
      m.update(n, feats.sum(0), feats.T @ feats)
  for got, want in zip(tm.finalize(), jm.finalize()):
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
  with pytest.raises(ValueError, match="more than 1 sample"):
    tfid.StreamingMoments(dim=4).finalize()


def _psd(rng, d):
  a = rng.standard_normal((d, 2 * d))
  return a @ a.T / (2 * d)


@pytest.mark.parametrize("same", [False, True])
def test_frechet_distance_matches_jax(same):
  """scipy's sqrtm on both sides (the JAX package's call passes `disp`,
  the port's does not): the same value within 1e-12; a distribution
  against itself is at 0 within 1e-9 of its trace."""
  rng = np.random.default_rng(3)
  mu1, s1 = rng.standard_normal(32), _psd(rng, 32)
  mu2, s2 = (mu1, s1) if same else (rng.standard_normal(32), _psd(rng, 32))
  got = tfid.compute_frechet_distance(mu1, s1, mu2, s2)
  want = jfid.compute_frechet_distance(mu1, s1, mu2, s2)
  assert got == pytest.approx(want, rel=1e-12, abs=1e-12 * np.trace(s1))
  if same:
    assert abs(got) <= 1e-9 * np.trace(s1)


@pytest.mark.parametrize("n", [50, 7])
def test_inception_score_matches_jax(n):
  logits = np.random.default_rng(n).standard_normal((n, 1008)) * 3.0
  probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
  assert tfid.compute_inception_score(probs) == pytest.approx(
      jfid.compute_inception_score(probs), rel=1e-12)


def _moments_close(mu, sigma, jmu, jsigma):
  scale = np.max(np.abs(jmu))
  assert np.max(np.abs(mu - jmu)) <= NET_TOL * scale
  assert np.max(np.abs(sigma - jsigma)) <= NET_TOL * scale ** 2


def test_statistics_and_scores_match_jax(seeded, tmp_path):
  """The activation functions on 7 uint8 images in batches of 4 (the last
  padded and masked): mu within NET_TOL of its largest magnitude, sigma
  within NET_TOL of max|mu|² (sigma = (Σxxᵀ - n mu muᵀ) / (n - 1) from f32
  sums on both sides: its error is that of the terms that cancel), the
  probabilities within 1e-5, the IS through `create_fid_score_fn` within
  1e-4; `compute_reference_stats` writes the same moments."""
  _, variables, path = seeded
  images = _uint8((7, 16, 16, 3), seed=4)
  jact = jfid.make_activation_fn(jinception.InceptionV3(), variables)
  jmu, jsigma, jprobs = jfid.compute_statistics(images, jact, batch_size=4)
  tact = tfid.make_activation_fn(tinception.init_params(path, device="cpu"))
  mu, sigma, probs = tfid.compute_statistics(images, tact, batch_size=4,
                                             device="cpu")
  assert probs.shape == (7, 1008)
  _moments_close(mu, sigma, jmu, jsigma)
  np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)

  ref = str(tmp_path / "ref.npz")
  chunks = [images[:3], images[3:]]
  tmu, tsigma = tfid.compute_reference_stats(iter(chunks), ref, batch_size=4,
                                             weights_path=path, device="cpu")
  jmu2, jsigma2 = jfid.compute_reference_stats(
      iter(chunks), str(tmp_path / "jref.npz"), batch_size=4,
      weights_path=path)
  with np.load(ref) as d:
    np.testing.assert_array_equal(d["mu"], tmu)
    np.testing.assert_array_equal(d["sigma"], tsigma)
  _moments_close(tmu, tsigma, jmu2, jsigma2)

  tscore = tfid.create_fid_score_fn(4, ref, path, device="cpu")
  jscore = jfid.create_fid_score_fn(4, ref, path)
  (tf, ti), (jf, ji) = tscore(images), jscore(images)
  assert np.isfinite(tf) and np.isfinite(jf)
  assert ti == pytest.approx(ji, rel=1e-4)
  assert 1.0 <= ti <= 1008.0
