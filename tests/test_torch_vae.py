"""Port parity: the Stable Diffusion VAE (`small_vision_tpu_torch/models/
vae.py`) against the JAX package's flax AutoencoderKL.

Each block (`ResnetBlock` with and without its 1x1 shortcut, `AttnBlock`,
`Downsample`, `Upsample`) and the whole `AutoencoderKL` at channels (32,
32, 32, 32) on 32x32 images: `encode_moments`, `encode` with injected
noise, and `decode`. Inputs are drawn with numpy from a seed; the weights
cross by `convert.vae_state_dict` (flax → port) and `convert.vae_to_jax`
(port → flax). Both sides compute in f32 (the JAX side at HIGHEST matmul
precision); they differ in summation order and in the GroupNorm variance
(flax 0.12 takes E[x²] − E[x]², `F.group_norm` two passes), which the
tolerances below state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.models import vae as jvae
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.models import vae as tvae
from small_vision_tpu_torch.utils.trees import (recover_tree,
                                                tree_flatten_with_names)

TINY = (32, 32, 32, 32)


def _x(shape, seed, scale=1.0, offset=0.0):
  rng = np.random.default_rng(seed)
  return (rng.standard_normal(shape) * scale + offset).astype(np.float32)


def _jax_apply(module, params, *args, method=None):
  fn = jax.jit(lambda p, *a: module.apply({"params": p}, *a, method=method))
  with jax.default_matmul_precision("highest"):
    return jax.tree.map(np.asarray, fn(params, *args))


def _flax_params(module, *inputs, seed=0):
  """A flax param tree for `module` with its names and shapes (from
  `jax.eval_shape` of its init) drawn with numpy: kernels of std
  1/sqrt(fan_in), biases N(0, 0.1²), GroupNorm scales 1 + N(0, 0.1²)."""
  shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                              *inputs))["params"]
  rng = np.random.default_rng(seed)
  names, values = [], []
  for name, s in tree_flatten_with_names(shapes):
    a = rng.standard_normal(s.shape).astype(np.float32)
    if name.endswith("kernel"):
      a *= np.float32(1 / np.sqrt(np.prod(s.shape[:-1])))
    elif name.endswith("scale"):
      a = 1 + 0.1 * a
    else:
      a *= np.float32(0.1)
    names.append(name)
    values.append(a)
  return recover_tree(names, values)


def _port_block(block, flax_params):
  block.load_state_dict(convert.vae_state_dict(flax_params, block))
  return block.eval().requires_grad_(False)


def _nchw(a):
  return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
  return t.permute(0, 2, 3, 1).numpy()


def _rel_err(got, want):
  return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# (flax block, port block, input channels, input (H, W)).
BLOCKS = {
    "resnet": (lambda: jvae.ResnetBlock(32), lambda: tvae.ResnetBlock(32, 32),
               32, 8),
    "resnet_shortcut": (lambda: jvae.ResnetBlock(64),
                        lambda: tvae.ResnetBlock(32, 64), 32, 8),
    "attn": (lambda: jvae.AttnBlock(), lambda: tvae.AttnBlock(64), 64, 6),
    "downsample": (lambda: jvae.Downsample(32), lambda: tvae.Downsample(32),
                   32, 9),
    "upsample": (lambda: jvae.Upsample(32), lambda: tvae.Upsample(32), 32, 5),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_flax(name):
  make_j, make_t, c, hw = BLOCKS[name]
  # Non-zero mean, so the two GroupNorm variance forms round differently.
  x = _x((2, hw, hw, c), seed=len(name), offset=0.5)
  jblock = make_j()
  params = _flax_params(jblock, jnp.asarray(x), seed=3)
  want = _jax_apply(jblock, params, jnp.asarray(x))
  tblock = _port_block(make_t(), params)
  with torch.no_grad():
    got = _nhwc(tblock(_nchw(x)))
  assert got.shape == want.shape
  # f32 sums of at most 9·64 products in another order, and the variance
  # forms: a few f32 ulps of the largest output.
  assert _rel_err(got, want) <= 2e-6, (name, _rel_err(got, want))


def test_upsample_resize_picks_as_jax():
  """F.interpolate(scale_factor=2, "nearest") picks the same pixels as
  jax.image.resize(..., "nearest") at exactly 2x: equal bits."""
  x = _x((2, 5, 7, 3), seed=4)
  want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3),
                                     "nearest"))
  got = _nhwc(torch.nn.functional.interpolate(_nchw(x), scale_factor=2.0,
                                              mode="nearest"))
  np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tiny():
  """The tiny AutoencoderKL, a seeded flax param tree, the port's model
  with those weights, and 32x32 images in [-1, 1]."""
  jmodel = jvae.AutoencoderKL(block_out_channels=TINY)
  images = np.clip(_x((2, 32, 32, 3), seed=5, scale=0.5), -1, 1)
  params = _flax_params(jmodel, jnp.asarray(images), seed=1)
  tmodel = tvae.AutoencoderKL(TINY)
  tmodel.load_state_dict(convert.vae_state_dict(params, tmodel))
  return jmodel, params, tmodel.eval().requires_grad_(False), images


# Through the whole encoder (conv_in, 8 ResNet blocks, 3 downsamples, the
# mid attention, conv_out, quant_conv) the per-layer f32 differences above
# compound; a relative 1e-5 of each output's largest value bounds them with
# room (seen: ~1e-6).
FULL_TOL = 1e-5


def test_encode_moments_matches_flax(tiny):
  jmodel, params, tmodel, images = tiny
  jmean, jlogvar = _jax_apply(jmodel, params, jnp.asarray(images),
                              method=jvae.AutoencoderKL.encode_moments)
  with torch.no_grad():
    mean, logvar = tmodel.encode_moments(torch.from_numpy(images))
  assert mean.shape == (2, 4, 4, 4)
  assert _rel_err(mean.numpy(), np.asarray(jmean)) <= FULL_TOL
  assert _rel_err(logvar.numpy(), np.asarray(jlogvar)) <= FULL_TOL


def test_encode_with_injected_noise_matches_flax(tiny):
  """encode(x, noise) = (mean + exp(logvar / 2) noise) * 0.18215, the noise
  being what jax.random.normal draws under the JAX call's key."""
  jmodel, params, tmodel, images = tiny
  key = jax.random.PRNGKey(9)
  want = _jax_apply(jmodel, params, jnp.asarray(images), key,
                    method=jvae.AutoencoderKL.encode)
  noise = np.asarray(jax.random.normal(key, (2, 4, 4, 4), jnp.float32))
  with torch.no_grad():
    got = tmodel.encode(torch.from_numpy(images),
                        torch.from_numpy(noise.copy())).numpy()
    mean = tmodel.encode(torch.from_numpy(images), None).numpy()
  assert _rel_err(got, want) <= FULL_TOL
  assert not np.allclose(got, mean)  # the noise was applied


def test_decode_matches_flax(tiny):
  jmodel, params, tmodel, _ = tiny
  z = _x((2, 4, 4, 4), seed=6)
  want = _jax_apply(jmodel, params, jnp.asarray(z),
                    method=jvae.AutoencoderKL.decode)
  with torch.no_grad():
    got = tmodel.decode(torch.from_numpy(z)).numpy()
  assert got.shape == (2, 32, 32, 3)
  # The decoder adds 12 ResNet blocks and 3 upsamples to the chain.
  assert _rel_err(got, want) <= FULL_TOL


def test_port_weights_run_in_flax():
  """The other direction: the port's seeded weights, through `vae_to_jax`,
  give the flax model the port's outputs."""
  params, enc, dec = tvae.load_vae(device="cpu", seed=4,
                                   block_out_channels=TINY)
  jparams = convert.vae_to_jax(params)
  jmodel = jvae.AutoencoderKL(block_out_channels=TINY)
  images = np.clip(_x((2, 32, 32, 3), seed=7, scale=0.5), -1, 1)
  noise = _x((2, 4, 4, 4), seed=8)
  z = enc(params, torch.from_numpy(noise), torch.from_numpy(images)).numpy()
  mean, logvar = _jax_apply(jmodel, jparams, jnp.asarray(images),
                            method=jvae.AutoencoderKL.encode_moments)
  want_z = (mean + np.exp(0.5 * logvar) * noise) * tvae.SCALING_FACTOR
  want_x = _jax_apply(jmodel, jparams, jnp.asarray(z),
                      method=jvae.AutoencoderKL.decode)
  assert _rel_err(z, want_z) <= FULL_TOL
  got_x = dec(params, torch.from_numpy(z)).numpy()
  assert _rel_err(got_x, want_x) <= FULL_TOL


def test_bridge_round_trip_is_exact(tiny):
  """flax → port → flax gives the flax tree back, leaf for leaf."""
  _, params, tmodel, _ = tiny
  back = dict(tree_flatten_with_names(convert.vae_to_jax(
      tmodel.state_dict())))
  want = dict(tree_flatten_with_names(jax.device_get(params)))
  assert sorted(back) == sorted(want)
  for name, leaf in want.items():
    np.testing.assert_array_equal(back[name], np.asarray(leaf), name)


def _write_convert_vae_npz(path, params):
  """An npz in `scripts/convert_vae.py`'s key format: `params/<flax path>`."""
  flat = {f"params/{n}": np.asarray(v) for n, v in
          tree_flatten_with_names(jax.device_get(params))}
  np.savez(path, **flat)
  return flat


def test_npz_route_loads_convert_vae_keys(tiny, tmp_path):
  """`load_vae(weights_path)` reads the converter's npz into the weights
  the flax tree holds; at SD widths the same npz does not fit."""
  _, params, tmodel, images = tiny
  path = str(tmp_path / "vae.npz")
  flat = _write_convert_vae_npz(path, params)
  assert "params/encoder/conv_in/kernel" in flat
  vparams, enc, _ = tvae.load_vae(path, device="cpu",
                                  block_out_channels=TINY)
  for name, t in tmodel.state_dict().items():
    np.testing.assert_array_equal(vparams[name].numpy(), t.numpy(), name)
  x = torch.from_numpy(images)
  with torch.no_grad():
    np.testing.assert_array_equal(enc(vparams, None, x).numpy(),
                                  tmodel.encode(x).numpy())
  with pytest.raises((KeyError, ValueError)):
    tvae.load_vae(path, device="cpu")


def test_jax_load_vae_keeps_the_npz_params_level(tiny, tmp_path):
  """A difference from the JAX package, kept in ROADMAP.md Queue C: its
  `load_vae(weights_path)` rebuilds the converter's `params/...` keys into
  a tree with a top `params` level and applies it as the params, so the
  encode finds no `encoder`; the port takes that level off."""
  jmodel, params, _, images = tiny
  path = str(tmp_path / "vae.npz")
  _write_convert_vae_npz(path, params)
  jparams, jenc, _ = jvae.load_vae(path)
  assert sorted(jparams) == ["params"]
  with pytest.raises(Exception):
    jenc(jparams, None, jnp.asarray(images))


def test_seeded_sd_vae_has_the_flax_names_and_shapes():
  """`load_vae()` at SD widths: the flax tree's names and shapes (JAX side
  by `jax.eval_shape`, no 256 px init), flax's initialisers' statistics."""
  jmodel = jvae.AutoencoderKL()
  want = jax.eval_shape(lambda: jmodel.init(
      jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3))))["params"]
  want = {n: tuple(s.shape) for n, s in tree_flatten_with_names(want)}
  params, _, _ = tvae.load_vae(device="cpu")
  got = {n: tuple(a.shape) for n, a in tree_flatten_with_names(
      convert.vae_to_jax(params))}
  assert got == want
  assert len(got) == 248
  # lecun-normal kernels (std 1/sqrt(fan_in)), zero biases, GN ones.
  k = params["encoder.down_2_res_0.conv1.weight"]  # 256 → 512, 3x3
  assert abs(float(k.std()) * np.sqrt(256 * 9) - 1.0) < 0.01
  assert float(k.abs().max()) <= 2.0 / np.sqrt(256 * 9) / 0.8796 + 1e-6
  assert not params["encoder.conv_in.bias"].any()
  assert bool((params["decoder.mid_attn.group_norm.weight"] == 1).all())


def test_load_vae_functions_run_in_chunks(monkeypatch):
  """`load_vae`'s functions run CHUNK images at a time: the same latents
  (a generator's noise drawn for the whole batch first) and images as one
  call over the batch, to f32 round-off of the convolutions' batching."""
  params, enc, dec = tvae.load_vae(device="cpu", seed=5,
                                   block_out_channels=TINY)
  images = torch.from_numpy(np.clip(_x((5, 32, 32, 3), seed=9), -1, 1))
  z = torch.from_numpy(_x((5, 4, 4, 4), seed=10))
  whole = (enc(params, torch.Generator().manual_seed(3), images),
           enc(params, None, images), dec(params, z))
  monkeypatch.setattr(tvae, "CHUNK", 2)
  chunked = (enc(params, torch.Generator().manual_seed(3), images),
             enc(params, None, images), dec(params, z))
  for c, w in zip(chunked, whole):
    assert c.shape == w.shape
    assert _rel_err(c.numpy(), w.numpy()) <= 1e-6
