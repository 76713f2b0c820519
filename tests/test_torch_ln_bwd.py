"""Port parity: the LayerNorm(+AdaLN modulate) backward (K2's plain
version) through `LNModulate`.

The port's gradients on the CPU are held against `jax.vjp` of the JAX
package's `fused_ln_modulate` with its Pallas kernels in interpret mode
(the custom VJP whose backward is `_ln_bwd_kernel`), with and without
modulation, at the training lengths 68 and 257. Inputs come from numpy
with a seed. A float64 gradcheck holds the plain backward against the
numerical derivative of the plain forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.ops import layernorm as jln
from small_vision_tpu_torch.ops import layernorm as tln

D = 256  # Small; the plain versions take any width.


def _inputs(l, modulate, seed, b=3, d=D):
  rng = np.random.default_rng(seed)
  f = lambda *s, sc=1.0, sh=0.0: (sc * rng.standard_normal(s) + sh).astype(
      np.float32)
  x = f(b, l, d, sc=2.0, sh=0.5)
  gamma, beta = f(d, sc=0.1, sh=1.0), f(d, sc=0.1)
  shift = scale = None
  if modulate:
    shift, scale = f(b, d, sc=0.3), f(b, d, sc=0.3)
  dy = f(b, l, d)
  return x, gamma, beta, shift, scale, dy


def _jax_grads(x, gamma, beta, shift, scale, dy, dtype):
  cast = lambda a: jnp.asarray(a, dtype)
  if shift is None:
    fn = lambda x, g, b: jln.fused_ln_modulate(x, g, b, None, None, 1e-6,
                                               True)
    args = (cast(x), jnp.asarray(gamma), jnp.asarray(beta))
  else:
    fn = lambda x, g, b, sh, sc: jln.fused_ln_modulate(x, g, b, sh, sc, 1e-6,
                                                       True)
    args = (cast(x), jnp.asarray(gamma), jnp.asarray(beta), cast(shift),
            cast(scale))
  y, vjp = jax.vjp(fn, *args)
  grads = vjp(cast(dy))
  return ([np.asarray(g.astype(jnp.float32)) for g in grads],
          [g.dtype for g in grads], np.asarray(y.astype(jnp.float32)))


def _torch_grads(x, gamma, beta, shift, scale, dy, dtype):
  leaf = lambda a, dt: torch.from_numpy(a).to(dt).requires_grad_()
  args = [leaf(x, dtype), leaf(gamma, torch.float32),
          leaf(beta, torch.float32)]
  if shift is not None:
    args += [leaf(shift, dtype), leaf(scale, dtype)]
  y = tln.ln_modulate(*args)
  y.backward(torch.from_numpy(dy).to(dtype))
  return ([a.grad.float().numpy() for a in args], [a.grad.dtype for a in args],
          y.detach().float().numpy())


def _ulp_bf16(a):
  """One bf16 ulp (2^-7 of the binade) of each value."""
  return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


@pytest.mark.parametrize("l", [68, 257])
@pytest.mark.parametrize("modulate", [False, True])
def test_backward_matches_jax_f32(l, modulate):
  args = _inputs(l, modulate, seed=l)
  got, got_dtypes, _ = _torch_grads(*args, torch.float32)
  want, want_dtypes, _ = _jax_grads(*args, jnp.float32)
  assert len(got) == len(want) == (5 if modulate else 3)
  assert all(g == torch.float32 for g in got_dtypes)
  assert all(w == jnp.float32 for w in want_dtypes)
  for g, w in zip(got, want):
    # The same f32 formulas; only the summation order of the row means and
    # of the sums over rows (up to 3 * 257 terms) differs.
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.max(np.abs(w)))


@pytest.mark.parametrize("l", [68, 257])
@pytest.mark.parametrize("modulate", [False, True])
def test_backward_matches_jax_bf16(l, modulate):
  args = _inputs(l, modulate, seed=l + 1)
  got, got_dtypes, _ = _torch_grads(*args, torch.bfloat16)
  want, want_dtypes, _ = _jax_grads(*args, jnp.bfloat16)
  # dx, dshift, dscale in the inputs' dtype; dgamma, dbeta f32 (the
  # parameter dtype), as the JAX custom VJP returns them.
  assert got_dtypes[0] == torch.bfloat16 and want_dtypes[0] == jnp.bfloat16
  assert got_dtypes[1:3] == [torch.float32] * 2
  if modulate:
    assert got_dtypes[3:] == [torch.bfloat16] * 2
  for i, (g, w) in enumerate(zip(got, want)):
    if i in (1, 2):
      # f32 sums of f32 products of the same bf16 inputs, in another order.
      np.testing.assert_allclose(g, w, rtol=0,
                                 atol=1e-5 * np.max(np.abs(w)))
    else:
      # f32 math rounded once to bf16: a sum in another order may tip a
      # value across a rounding boundary, so one bf16 ulp, plus the f32
      # noise of values that cancel to near 0.
      tol = _ulp_bf16(w) + 1e-5 * np.max(np.abs(w))
      assert np.all(np.abs(g - w) <= tol), np.max(np.abs(g - w))


@pytest.mark.parametrize("modulate", [False, True])
def test_plain_backward_gradcheck_f64(modulate):
  """The plain backward (a formula of its own, not autograd) is the
  derivative of the plain forward."""
  rng = np.random.default_rng(5)
  t = lambda *s: torch.from_numpy(rng.standard_normal(s)).requires_grad_()
  args = [t(2, 3, 8), t(8), t(8)]
  if modulate:
    args += [t(2, 8), t(2, 8)]
  else:
    args += [None, None]
  fn = lambda *a: tln.LNModulate.apply(*a, 1e-6)
  assert torch.autograd.gradcheck(fn, tuple(args), eps=1e-6, atol=1e-6)


def test_no_grad_takes_the_forward_only():
  """Without a gradient wanted, `ln_modulate` is the plain forward itself
  (on the card: K1 without statistics), not the autograd Function."""
  x, gamma, beta, shift, scale, _ = _inputs(20, True, seed=0)
  args = [torch.from_numpy(a).requires_grad_() for a in
          (x, gamma, beta, shift, scale)]
  with torch.no_grad():
    y = tln.ln_modulate(*args)
  assert y.grad_fn is None
  y = tln.ln_modulate(*args)
  assert type(y.grad_fn).__name__ == "LNModulateBackward"


@pytest.mark.parametrize("d", [32, 64, 384, 1664])
@pytest.mark.parametrize("modulate", [False, True])
def test_backward_matches_jax_at_variant_widths(d, modulate):
  """The plain backward (K2's) at width d against the interpreted JAX
  kernel's VJP, in f32, with the bound of test_backward_matches_jax_f32."""
  args = _inputs(33, modulate, seed=d, d=d)
  got, _, _ = _torch_grads(*args, torch.float32)
  want, _, _ = _jax_grads(*args, jnp.float32)
  assert len(got) == len(want) == (5 if modulate else 3)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.max(np.abs(w)))
