"""Port parity: the plain LayerNorm(+AdaLN modulate) forward.

The port's plain `ln_modulate` is held against the JAX package's Pallas
kernel run in interpret mode (`_ln_fwd(..., interpret=True)`, as
tests/test_layernorm.py runs it) and against `ln_modulate_reference`.
Inputs come from numpy with a seed and go to both frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.ops import layernorm as jln
from small_vision_tpu_torch.ops import layernorm as tln

D = 256  # Small; the plain version takes any width.


def _inputs(l, modulate, seed=0, b=3, d=D):
  rng = np.random.default_rng(seed)
  x = (2.0 * rng.standard_normal((b, l, d)) + 0.5).astype(np.float32)
  gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
  beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
  shift = scale = None
  if modulate:
    shift = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
    scale = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
  return x, gamma, beta, shift, scale


def _jax_both(x, gamma, beta, shift, scale, dtype):
  """(interpreted Pallas kernel, XLA reference) outputs as f32 numpy."""
  cast = lambda a: None if a is None else jnp.asarray(a, dtype)
  args = (cast(x), jnp.asarray(gamma), jnp.asarray(beta), cast(shift),
          cast(scale))
  kernel, _, _ = jln._ln_fwd(*args, 1e-6, interpret=True)
  ref = jln.ln_modulate_reference(*args)
  return (np.asarray(kernel.astype(jnp.float32)),
          np.asarray(ref.astype(jnp.float32)))


def _torch_plain(x, gamma, beta, shift, scale, dtype):
  cast = lambda a: None if a is None else torch.from_numpy(a).to(dtype)
  y = tln.ln_modulate(cast(x), torch.from_numpy(gamma),
                      torch.from_numpy(beta), cast(shift), cast(scale))
  assert y.dtype == dtype
  return y.float().numpy()


@pytest.mark.parametrize("l", [20, 257])
@pytest.mark.parametrize("modulate", [False, True])
def test_plain_matches_jax_f32(l, modulate):
  args = _inputs(l, modulate)
  got = _torch_plain(*args, torch.float32)
  for want in _jax_both(*args, jnp.float32):
    # f32 throughout; only the order of the row sums differs.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("l", [20, 257])
@pytest.mark.parametrize("modulate", [False, True])
def test_plain_matches_jax_bf16(l, modulate):
  args = _inputs(l, modulate, seed=1)
  got = _torch_plain(*args, torch.bfloat16)
  for want in _jax_both(*args, jnp.bfloat16):
    # Statistics in f32 on both sides, one rounding to bf16 at the end: a
    # sum taken in another order may tip a value across a bf16 rounding
    # boundary, so allow one bf16 ulp (2^-7 of the value's binade).
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want))



# The widths K1 now takes beside 768 and 1,024: the quick configs' 32 and
# 64, UMD-S's 384, ViT-G's 1,664.
@pytest.mark.parametrize("d", [32, 64, 384, 1664])
@pytest.mark.parametrize("modulate", [False, True])
def test_plain_matches_jax_at_variant_widths(d, modulate):
  """The plain forward at width d against the interpreted JAX kernel,
  with the bounds of the width-256 tests above (f32 and bf16)."""
  args = _inputs(33, modulate, seed=d, d=d)
  got = _torch_plain(*args, torch.float32)
  for want in _jax_both(*args, jnp.float32):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
  got = _torch_plain(*args, torch.bfloat16)
  for want in _jax_both(*args, jnp.bfloat16):
    # One bf16 ulp, as above, plus the f32 noise of values that cancel to
    # near 0 (x-hat * gamma + beta about 0 at width 1,664 left a -7e-6
    # where the two sides' f32 sums differ by 1e-7): 1e-5 of the largest,
    # as tests/test_torch_ln_bwd.py allows.
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    tol = ulp + 1e-5 * np.max(np.abs(want))
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want))
