"""Port parity: the packed attention backward (K4's plain version) through
`AttentionPacked`.

The port's gradients on the CPU are held against `jax.vjp` of the JAX
package's `fused_attention_packed` with its Pallas kernels in interpret
mode (the custom VJP whose backward is `_attn_bwd_kernel_packed`), on
packed (B, L, H*64) inputs drawn with numpy. A clamped case shows the
identity-through-clamp gradient of the JAX backward, which autograd of the
plain forward would not give; a float64 gradcheck holds the plain backward
against the numerical derivative of the plain forward where the clamp does
not bite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.ops import attention as jattn
from small_vision_tpu_torch.ops import attention as tattn

B, H, D = 2, 2, 64


def _inputs(l, seed, qk_scale=1.0):
  rng = np.random.default_rng(seed)
  q, k, v, do = (rng.standard_normal((B, l, H * D)).astype(np.float32)
                 for _ in range(4))
  return q * qk_scale, k * qk_scale, v, do


def _jax_grads(q, k, v, do, dtype):
  cast = lambda a: jnp.asarray(a, dtype)
  fn = lambda q, k, v: jattn.fused_attention_packed(q, k, v, H, True)
  _, vjp = jax.vjp(fn, cast(q), cast(k), cast(v))
  return [np.asarray(g.astype(jnp.float32)) for g in vjp(cast(do))]


def _torch_grads(q, k, v, do, dtype):
  args = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
  out = tattn.attention_packed(*args, H)
  out.backward(torch.from_numpy(do).to(dtype))
  assert all(a.grad.dtype == dtype for a in args)
  return [a.grad.float().numpy() for a in args]


@pytest.mark.parametrize("l", [20, 164])
def test_backward_matches_jax_f32(l):
  args = _inputs(l, seed=l)
  for g, w in zip(_torch_grads(*args, torch.float32),
                  _jax_grads(*args, jnp.float32)):
    # The same f32 formulas; the products and row sums run in another
    # order.
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.max(np.abs(w)))


@pytest.mark.parametrize("l", [20, 164])
def test_backward_matches_jax_bf16(l):
  args = _inputs(l, seed=l + 1)
  for g, w in zip(_torch_grads(*args, torch.bfloat16),
                  _jax_grads(*args, jnp.bfloat16)):
    # Both round e, dO*r, dS and Q*r*scale to bf16 before their products,
    # and the outputs; f32 sums in another order may flip one such
    # rounding, which moves an output by a few bf16 ulps (2^-8 relative)
    # of the largest terms: 2^-6 of the leaf's max.
    np.testing.assert_allclose(g, w, rtol=0, atol=2**-6 * np.max(np.abs(w)))


def test_backward_through_the_clamp_is_the_identity():
  """Logits far past the ±80 log2 clamp: the JAX backward uses the clamped
  e as if the clamp were not there, and so does the port. Autograd of the
  plain forward would zero the clamped entries instead."""
  args = _inputs(20, seed=3, qk_scale=40.0)
  got = _torch_grads(*args, torch.float32)
  want = _jax_grads(*args, jnp.float32)
  for g, w in zip(got, want):
    assert np.all(np.isfinite(g))
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.max(np.abs(w)))

  q, k, v = (torch.from_numpy(a).requires_grad_() for a in args[:3])
  tattn.attention_packed_plain(q, k, v, H).backward(torch.from_numpy(args[3]))
  # Nearly every score is clamped, so autograd's dq is under 1 % of the
  # JAX backward's (0.4 % here), from the few unclamped scores.
  assert np.max(np.abs(q.grad.numpy())) < 1e-2 * np.max(np.abs(want[0]))


def test_plain_backward_gradcheck_f64():
  rng = np.random.default_rng(7)
  q, k, v = (torch.from_numpy(rng.standard_normal((1, 5, 2 * 4))
                              ).requires_grad_() for _ in range(3))
  fn = lambda q, k, v: tattn.AttentionPacked.apply(q, k, v, 2)
  # The exp2 takes the f32-rounded head_dim**-0.5 * log2(e), the backward
  # the exact head_dim**-0.5: they differ by ~1e-7 relative.
  assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-5)


def test_no_grad_takes_the_forward_only():
  q = torch.from_numpy(_inputs(20, seed=0)[0]).requires_grad_()
  with torch.no_grad():
    assert tattn.attention_packed(q, q, q, H).grad_fn is None
  out = tattn.attention_packed(q, q, q, H)
  assert type(out.grad_fn).__name__ == "AttentionPackedBackward"


@pytest.mark.parametrize("hd", [8, 16, 80, 128, 192, 256, 12, 4, 384, 520])
def test_backward_matches_jax_at_head_dims(hd):
  """The plain backward (K4's) at head dim hd (3 heads; 2 at 192, 256 and
  384, `heads=4`, `heads=3` and `heads=2`'s head dims, and at 520, a
  ragged ninth 64-column tile) against the interpreted JAX
  kernel's VJP, with the bounds of the head-dim-64 tests above (f32 and
  bf16)."""
  rng = np.random.default_rng(hd)
  heads = 3 if hd <= 128 else 2
  q, k, v, do = (rng.standard_normal((2, 33, heads * hd)).astype(np.float32)
                 for _ in range(4))
  for dt, jdt, rel in ((torch.float32, jnp.float32, 1e-5),
                       (torch.bfloat16, jnp.bfloat16, 2**-6)):
    args = [torch.from_numpy(a).to(dt).requires_grad_() for a in (q, k, v)]
    tattn.attention_packed(*args, heads).backward(
        torch.from_numpy(do).to(dt))
    fn = lambda q, k, v: jattn.fused_attention_packed(q, k, v, heads, True)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    for a, w in zip(args, vjp(jnp.asarray(do, jdt))):
      w = np.asarray(w.astype(jnp.float32))
      np.testing.assert_allclose(a.grad.float().numpy(), w, rtol=0,
                                 atol=rel * np.max(np.abs(w)))
