"""Port parity: packed bidirectional attention, plain version and kernel.

The port's plain `attention_packed` is held against the JAX package's
packed Pallas kernel run in interpret mode and against `xla_attention` (the
max-shifted softmax), on packed (B, L, H*64) inputs drawn with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.ops import attention as jattn
from small_vision_tpu_torch.ops import attention as tattn

B, H, D = 2, 2, 64  # D = 64: the head dim the kernel takes.


def _qkv(l, seed, b=B):
  rng = np.random.default_rng(seed)
  return [rng.standard_normal((b, l, H * D)).astype(np.float32)
          for _ in range(3)]


def _jax_both(q, k, v, dtype):
  """(interpreted Pallas kernel, XLA einsum attention) as f32 numpy."""
  q, k, v = (jnp.asarray(a, dtype) for a in (q, k, v))
  l = q.shape[1]
  kernel = jattn.pallas_attention_packed(q, k, v, H, interpret=True)
  unpack = lambda a: a.reshape(B, l, H, D)
  xla = jattn.xla_attention(unpack(q), unpack(k), unpack(v)).reshape(
      B, l, H * D)
  return (np.asarray(kernel.astype(jnp.float32)),
          np.asarray(xla.astype(jnp.float32)))


def _torch_plain(q, k, v, dtype):
  out = tattn.attention_packed(*(torch.from_numpy(a).to(dtype)
                                 for a in (q, k, v)), H)
  assert out.dtype == dtype and out.shape == q.shape
  return out.float().numpy()


@pytest.mark.parametrize("l", [20, 257])
def test_plain_matches_jax_f32(l):
  q, k, v = _qkv(l, seed=0)
  got = _torch_plain(q, k, v, torch.float32)
  kernel, xla = _jax_both(q, k, v, jnp.float32)
  # Same clamp-exp2 softmax in f32; dot products summed in another order.
  np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)
  # Max shift against clamp: both exact in f32 at these logits.
  np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("l", [20, 257])
def test_plain_matches_jax_bf16(l):
  q, k, v = _qkv(l, seed=1)
  got = _torch_plain(q, k, v, torch.bfloat16)
  kernel, xla = _jax_both(q, k, v, jnp.bfloat16)
  # Outputs are convex mixes of N(0,1) values rounded to bf16 (ulp 2^-7 at
  # unit magnitude). The same rounding of e happens on both sides; scores
  # summed in another order may flip an e by one bf16 ulp: allow 2 ulps.
  np.testing.assert_allclose(got, kernel, rtol=2**-7, atol=2**-7)
  # XLA rounds the normalised probabilities instead of e, so the two
  # differ by bf16 rounding of the weights: a few ulps at unit magnitude.
  np.testing.assert_allclose(got, xla, rtol=2**-6, atol=2**-5)


def test_plain_clamps_large_logits():
  """Past the ±80 log2 clamp the softmax saturates as the kernel's does
  (uniform over the clamped keys) and stays finite."""
  q, k, v = _qkv(20, seed=2)
  q, k = 40.0 * q, 40.0 * k
  got = _torch_plain(q, k, v, torch.float32)
  kernel, _ = _jax_both(q, k, v, jnp.float32)
  assert np.all(np.isfinite(got))
  np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)


def test_scale_log2_is_the_kernels():
  want = np.float32(1.0 / np.sqrt(64)) * np.float32(np.log2(np.e))
  assert tattn.scale_log2(64) == float(want)
