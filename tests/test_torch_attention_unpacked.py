"""Port parity: attention on [B, L, H, D] with the max-shift softmax (the
plain versions of K7 and K8, through `fused_attention`).

The same inputs, drawn with numpy, go through the JAX package's
`pallas_attention` and `fused_attention` with their Pallas kernels in
interpret mode and through the port on the CPU; the bf16 backward also at
L = 720, past the length (704) that the card's K8 once took. A float64 gradcheck holds
the plain backward against the numerical derivative of the plain forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.ops import attention as jattn
from small_vision_tpu_torch.ops import _build
from small_vision_tpu_torch.ops import attention as tattn

B, D = 2, 64


def _inputs(l, heads, seed, qk_scale=1.0, b=B):
  rng = np.random.default_rng(seed)
  q, k, v, do = (rng.standard_normal((b, l, heads, D)).astype(np.float32)
                 for _ in range(4))
  return q * qk_scale, k * qk_scale, v, do


def _np(a):
  if isinstance(a, torch.Tensor):
    return a.detach().float().numpy()
  return np.asarray(a.astype(jnp.float32))


CASES = [(16, 2), (37, 2), (37, 3)]


@pytest.mark.parametrize("l,heads", CASES)
def test_forward_matches_jax_f32(l, heads):
  q, k, v, _ = _inputs(l, heads, seed=l)
  want = jattn.pallas_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                interpret=True)
  got = tattn.fused_attention(*(torch.from_numpy(a) for a in (q, k, v)))
  assert got.shape == (B, l, heads, D)
  # The same f32 arithmetic in another summation order.
  np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("l,heads", CASES)
def test_forward_matches_jax_bf16(l, heads):
  q, k, v, _ = _inputs(l, heads, seed=l + 1)
  want = jattn.pallas_attention(
      *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), interpret=True)
  got = tattn.fused_attention(
      *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
  assert got.dtype == torch.bfloat16
  # Both round the probabilities and the output to bf16; a score sum in
  # another order may flip the rounding of a probability: two bf16 ulps
  # (2^-7 relative at most each) of the output's max.
  w = _np(want)
  np.testing.assert_allclose(_np(got), w, rtol=0,
                             atol=2.0**-6 * np.max(np.abs(w)))


def _jax_grads(q, k, v, do, dtype):
  cast = lambda a: jnp.asarray(a, dtype)
  fn = lambda q, k, v: jattn.fused_attention(q, k, v, True)
  _, vjp = jax.vjp(fn, cast(q), cast(k), cast(v))
  return [_np(g) for g in vjp(cast(do))]


def _torch_grads(q, k, v, do, dtype):
  args = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
  tattn.fused_attention(*args).backward(torch.from_numpy(do).to(dtype))
  assert all(a.grad.dtype == dtype and a.grad.shape == a.shape for a in args)
  return [_np(a.grad) for a in args]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_at_vit_h_518(dtype):
  """ViT-H/14@518's length, 1,369 (37 x 37 patches), at its head dim 80,
  two heads: on the card K7's K and V stream through the core's ring
  there (past 384 keys at head dims over 64); the plain version is the
  function at every length. Bounds of the tests above: f32 1e-5, bf16 two
  ulps at unit magnitude."""
  rng = np.random.default_rng(1369)
  q, k, v = (rng.standard_normal((B, 1369, 2, 80)).astype(np.float32)
             for _ in range(3))
  jdt, dt, tol = {"float32": (jnp.float32, torch.float32, 1e-5),
                  "bfloat16": (jnp.bfloat16, torch.bfloat16, 2**-7)}[dtype]
  want = jattn.pallas_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                interpret=True)
  got = tattn.fused_attention(*(torch.from_numpy(a).to(dt)
                                for a in (q, k, v)))
  assert got.dtype == dt and got.shape == (B, 1369, 2, 80)
  np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("l,heads", CASES)
def test_backward_matches_jax_f32(l, heads):
  args = _inputs(l, heads, seed=l + 2)
  for g, w in zip(_torch_grads(*args, torch.float32),
                  _jax_grads(*args, jnp.float32)):
    # The same f32 formulas; the products and row sums run in another
    # order.
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.max(np.abs(w)))


# Past the card kernel's old limit of 704 too: one head of one row at 720.
BWD_BF16_CASES = [(l, h, B) for l, h in CASES] + [(720, 1, 1)]


@pytest.mark.parametrize(
    "l,heads,b", BWD_BF16_CASES,
    ids=[f"{l}-{h}" + ("" if b == B else f"-b{b}")
         for l, h, b in BWD_BF16_CASES])
def test_backward_matches_jax_bf16(l, heads, b):
  args = _inputs(l, heads, seed=l + 3, b=b)
  for g, w in zip(_torch_grads(*args, torch.bfloat16),
                  _jax_grads(*args, jnp.bfloat16)):
    # Both round P (for dV) and dS to bf16 before their products, and the
    # outputs; f32 sums in another order may flip one such rounding, which
    # moves an output by a few bf16 ulps of the largest terms: 2^-6 of the
    # leaf's max.
    np.testing.assert_allclose(g, w, rtol=0, atol=2**-6 * np.max(np.abs(w)))


def test_large_logits_stay_finite():
  """The max shift keeps exp in range where unshifted scores would
  overflow: logits of several hundred."""
  args = _inputs(16, 2, seed=5, qk_scale=8.0)
  got = _torch_grads(*args, torch.float32)
  want = _jax_grads(*args, jnp.float32)
  for g, w in zip(got, want):
    assert np.all(np.isfinite(g))
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.max(np.abs(w)))


def test_plain_backward_gradcheck_f64():
  rng = np.random.default_rng(7)
  q, k, v = (torch.from_numpy(rng.standard_normal((1, 5, 2, 4))
                              ).requires_grad_() for _ in range(3))
  assert torch.autograd.gradcheck(tattn.FusedAttention.apply, (q, k, v),
                                  eps=1e-6, atol=1e-5)


def test_no_grad_takes_the_forward_only_and_counts_no_launch():
  before = dict(_build.LAUNCHES)
  q = torch.from_numpy(_inputs(16, 2, seed=0)[0]).requires_grad_()
  with torch.no_grad():
    assert tattn.fused_attention(q, q, q).grad_fn is None
  out = tattn.fused_attention(q, q, q)
  assert type(out.grad_fn).__name__ == "FusedAttentionBackward"
  assert dict(_build.LAUNCHES) == before  # CPU tensors: plain versions


def test_kernel_wrappers_refuse_cpu_tensors():
  q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="CUDA tensor"):
    tattn.attention_unpacked_fwd(q, q, q)
  with pytest.raises(ValueError, match="CUDA tensor"):
    tattn.attention_unpacked_bwd(q, q, q, q)
