"""Port parity: packed bidirectional attention, plain version and kernel.

The port's plain `attention_packed` is held against the JAX package's
packed Pallas kernel run in interpret mode and against `xla_attention` (the
max-shifted softmax), on packed (B, L, H*64) inputs drawn with numpy; so
are K3's and K7's f32 forwards as the card takes them (3xTF32 products,
emulated on the CPU), against the JAX kernels in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.ops import attention as jattn
from small_vision_tpu_torch.ops import attention as tattn
from tests.test_torch_tf32x3 import HEADS, emulated, inputs

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


@pytest.mark.parametrize("hd", [8, 136, 192, 256, 12, 4, 1])
def test_check_head_dim_takes_multiples_of_8_up_to_256(hd):
  """The kernels' wrappers take every head dim from 1 to 256: the
  multiples of 8 as they are, 136 (a ragged last 64-column tile), 192 and
  256 (`heads=4` and `heads=3` at width 768), and the others on heads
  zero-padded to the next multiple of 8: 12 (`heads=32` at UMD-S's 384),
  4 and 1."""
  assert tattn.MAX_HEAD_DIM >= 256
  tattn.check_head_dim(hd, tattn.NAME)


@pytest.mark.parametrize("hd", [264, 384, 768, 1664, 2048])
def test_check_head_dim_takes_multiples_of_8_up_to_2048(hd):
  """Past 256, up to 2,048: 264 (a ragged fifth 64-column tile), 384 and
  768 (`heads=2` and `heads=1` at width 768), 1,664 (ViT-G in one head)
  and the limit."""
  assert tattn.MAX_HEAD_DIM == 2048
  tattn.check_head_dim(hd, tattn.NAME)


@pytest.mark.parametrize("hd", [2056, 0])
def test_check_head_dim_refuses_the_others_by_name(hd):
  """Past 2,048, or 0, the named error: no plain route."""
  with pytest.raises(ValueError,
                     match=f"{tattn.NAME}: head dim {hd}: the kernels take "
                     "1 to 2048"):
    tattn.check_head_dim(hd, tattn.NAME)


@pytest.mark.parametrize("d,dp", [(1, 8), (4, 8), (8, 8), (12, 16), (13, 16),
                                  (64, 64), (250, 256)])
def test_pad_heads_lays_each_head_out_at_the_next_multiple_of_8(d, dp):
  """`pad_heads`: each head's d columns, then dp - d zeros; `unpad_heads`
  gives the input back, and both return their argument itself where d is
  already a multiple of 8 (no copy at the head dims the kernels take)."""
  assert tattn.padded_head_dim(d) == dp
  t = torch.arange(1, 2 * 3 * 3 * d + 1, dtype=torch.float32).reshape(
      2, 3, 3 * d)
  padded = tattn.pad_heads(t, 3, dp)
  assert padded.shape == (2, 3, 3 * dp) and padded.is_contiguous()
  heads = padded.reshape(2, 3, 3, dp)
  assert torch.equal(heads[..., :d], t.reshape(2, 3, 3, d))
  assert not heads[..., d:].any()
  back = tattn.unpad_heads(padded, 3, d)
  assert torch.equal(back, t) and back.is_contiguous()
  if d == dp:
    assert padded is t and back is padded


def _padded(fn, arrays, heads, d):
  """`fn` (a plain version) run on `arrays` with each of their `heads`
  heads padded to the kernels' head dim and the scale of d, its outputs
  cut back."""
  dp = tattn.padded_head_dim(d)
  out = fn(*(tattn.pad_heads(a, heads, dp) for a in arrays), scale_dim=d)
  return [tattn.unpad_heads(o.contiguous(), heads, d)
          for o in (out if isinstance(out, tuple) else (out,))]


# K3, K4, K7 and K8 at head dims that are not multiples of 8: 12
# (`heads=32` at UMD-S), 4, 13.
@pytest.mark.parametrize("kernel", ["K3", "K4", "K7", "K8"])
@pytest.mark.parametrize("d,heads", [(12, 4), (4, 3), (13, 2)])
def test_padded_heads_give_the_plain_version_at_the_true_head_dim(
    kernel, d, heads):
  """What the wrappers launch: the kernel's arithmetic at the padded head
  dim with the true head dim's scale, the padded columns cut off. Run
  through the plain versions in f64, it equals them at d within 1e-12 of
  the largest output: the zeros add exact zeros, and only the order of a
  BLAS sum of another length may differ."""
  rng = np.random.default_rng(d)
  arrays = [torch.from_numpy(rng.standard_normal((2, 19, heads * d)))
            for _ in range(4)]
  if kernel in ("K3", "K4"):
    fn = {"K3": tattn.attention_packed_plain,
          "K4": tattn.attention_packed_bwd_plain}[kernel]
    n = 3 if kernel == "K3" else 4
    want = fn(*arrays[:n], heads)
    got = _padded(lambda *a, scale_dim: fn(*a, heads, scale_dim=scale_dim),
                  arrays[:n], heads, d)
  else:
    fn = {"K7": tattn.attention_plain, "K8": tattn.attention_bwd_plain}[kernel]
    n = 3 if kernel == "K7" else 4
    arrays = [a.reshape(2, 19, heads, d) for a in arrays[:n]]
    want = fn(*arrays)
    got = _padded(fn, arrays, 1, d)  # [B, L, H, D]: the last axis
  want = want if isinstance(want, tuple) else (want,)
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert g.dtype == torch.float64 and g.shape == w.shape
    assert (g - w).abs().max().item() <= 1e-12 * w.abs().max().item()


def test_scale_log2_is_the_kernels():
  want = np.float32(1.0 / np.sqrt(64)) * np.float32(np.log2(np.e))
  assert tattn.scale_log2(64) == float(want)


# Head dims K3 now takes beside 64: 8 (the probe's quick config), 16
# (runlocal, ViT-mu), 80 (ViT-H), 128 (heads=6 at width 768), 192 and 256
# (heads=4 and heads=3 at width 768: three and four 64-column tiles on the
# card), 384 (heads=2: six tiles, O's columns over two CTAs on the card)
# and 520 (a ragged ninth tile), these four in two heads; 12 (heads=32 at
# UMD-S's 384) and 4, which the card runs on heads zero-padded to 16 and 8.
@pytest.mark.parametrize("hd", [8, 16, 80, 128, 192, 256, 12, 4, 384, 520])
def test_plain_matches_jax_at_head_dims(hd):
  """The plain forward at head dim hd (3 heads, 2 past 128) against the
  interpreted JAX kernel, with the bounds of the head-dim-64 tests above;
  the scale is the head dim's own, rounded as the JAX kernel rounds it."""
  rng = np.random.default_rng(hd)
  heads = 3 if hd <= 128 else 2
  q, k, v = (rng.standard_normal((2, 33, heads * hd)).astype(np.float32)
             for _ in range(3))
  for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                       (torch.bfloat16, jnp.bfloat16, 2**-7)):
    got = tattn.attention_packed(*(torch.from_numpy(a).to(dt)
                                   for a in (q, k, v)), heads).float().numpy()
    want = jattn.pallas_attention_packed(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), heads, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# The lengths of ViT-L/16@512 ("map" 1,024, "tok" 1,025) at head dim 32
# and of ViT-H/14@518 (1,369) at its own head dim, 80: on the card K and V
# stream through K3's ring there (past 320 keys at head dims up to 64, 384
# above), with the arithmetic of the plain version, which is the function
# at every length.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,hd", [(1024, 32), (1025, 32), (1369, 80)])
def test_plain_matches_jax_at_long_lengths(l, hd, dtype):
  """The plain forward (two heads, batch 2) against the interpreted JAX
  kernel, which holds the whole (L, L) score; bounds of the head-dim-64
  tests: f32 1e-5 (the same arithmetic, sums in another order), bf16 two
  ulps at unit magnitude. The row sums run over up to 1,369 terms of at
  most 2^80 and stay finite."""
  rng = np.random.default_rng(l + hd)
  q, k, v = (rng.standard_normal((2, l, 2 * hd)).astype(np.float32)
             for _ in range(3))
  dt, jdt = {"float32": (torch.float32, jnp.float32),
             "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
  tol = 1e-5 if dtype == "float32" else 2**-7
  got = tattn.attention_packed(*(torch.from_numpy(a).to(dt)
                                 for a in (q, k, v)), 2)
  assert got.dtype == dt and got.shape == (2, l, 2 * hd)
  want = jattn.pallas_attention_packed(
      *(jnp.asarray(a, jdt) for a in (q, k, v)), 2, interpret=True)
  np.testing.assert_allclose(got.float().numpy(),
                             np.asarray(want.astype(jnp.float32)),
                             rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", ["K3", "K7"])
def test_3xtf32_forward_matches_jax_f32(kernel):
  """K3's and K7's f32 forwards as the card computes them (3xTF32
  products over the kernel's chunks, emulated on the CPU by
  tests/test_torch_tf32x3.py) against the JAX kernels in f32
  (`pallas_attention_packed`, `pallas_attention`, interpreted) on the same
  numpy inputs at (L, D) = (68, 64), two heads: within 1e-5 of the
  output's largest value."""
  l, d = 68, 64
  q, k, v, _ = inputs(l, d)
  got = emulated(kernel, q, k, v, None, passes=3)[0].numpy()
  qkv = [jnp.asarray(t.numpy()) for t in (q, k, v)]
  if kernel == "K3":
    want = jattn.pallas_attention_packed(*qkv, HEADS, interpret=True)
  else:
    want = jattn.pallas_attention(
        *(t.reshape(1, l, HEADS, d) for t in qkv), interpret=True)
  want = np.asarray(want).reshape(got.shape)
  assert want.dtype == np.float32
  assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
