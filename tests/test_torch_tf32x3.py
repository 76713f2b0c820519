"""The arithmetic of K4's and K8's f32 backwards (3xTF32 products on the
tensor cores, `csrc/sm90_f32x3_attention_bwd.cuh`), on the CPU.

The kernels run on the card only; these tests hold what they are built
on. `attention.split_tf32` splits an f32 value into a tf32 hi part
(rounded to nearest, ties away from zero, as `cvt.rna.tf32.f32`) and a
tf32 lo part of the rest, and hi + lo is the value to within 2^-22 of it.
K4's and K8's formulas, their nine products taken as the kernels take
them (a_lo b_hi + a_hi b_lo + a_hi b_hi of the split f32 operands, summed
in f32), stay within 1e-5 of each output's scale of the float64 plain
versions (`attention_packed_bwd_plain`, `attention_bwd_plain`, which
promote f64 inputs) at (L, D) = (68, 64), (257, 12) and (164, 384); the
same formulas with one TF32 pass (a_hi b_hi) land above 1e-4 there, so
the tolerance tells the two apart. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from small_vision_tpu_torch.ops import attention as attn

SHAPES = [(68, 64), (257, 12), (164, 384)]
HEADS = 2


def _rna_tf32(x):
  """x (float64 array of f32 values) rounded to 11 significant bits, to
  nearest, ties away from zero, by float arithmetic."""
  m, e = np.frexp(x)                       # x = m 2^e, 0.5 <= |m| < 1
  scaled = m * 2.0**11
  return np.sign(scaled) * np.floor(np.abs(scaled) + 0.5) * 2.0**(e - 11)


def test_split_tf32_rounds_to_nearest_ties_away():
  rng = np.random.default_rng(0)
  x = np.concatenate([rng.standard_normal(10_000),
                      rng.standard_normal(1_000) * 1e-30,
                      rng.standard_normal(1_000) * 1e30]).astype(np.float32)
  # Ties: 1 + (2k + 1) 2^-11 lies halfway between two tf32 values.
  ties = (1.0 + (2 * np.arange(64) + 1) * 2.0**-11).astype(np.float32)
  x = np.concatenate([x, ties, -ties, [0.0, -0.0]]).astype(np.float32)
  hi, lo = attn.split_tf32(torch.from_numpy(x))
  want = _rna_tf32(x.astype(np.float64))
  assert np.array_equal(hi.numpy().astype(np.float64), want)
  # Halfway cases go away from zero.
  assert (np.abs(hi.numpy()[-130:-66]) > np.abs(ties)).all()
  assert (np.abs(hi.numpy()[-66:-2]) > np.abs(ties)).all()
  # Both parts are tf32: their 13 low bits are clear.
  for part in (hi, lo):
    assert not (part.view(torch.int32) & 0x1FFF).any()
  want_lo = _rna_tf32((x.astype(np.float64) - hi.numpy()).astype(np.float32)
                      .astype(np.float64))
  assert np.array_equal(lo.numpy().astype(np.float64), want_lo)


def test_split_tf32_is_exact_to_2_pow_minus_22():
  rng = np.random.default_rng(1)
  x = (rng.standard_normal(100_000)
       * 10.0**rng.uniform(-20, 20, 100_000)).astype(np.float32)
  hi, lo = attn.split_tf32(torch.from_numpy(x))
  err = np.abs(hi.double().numpy() + lo.double().numpy()
               - x.astype(np.float64))
  assert (err <= 2.0**-22 * np.abs(x.astype(np.float64))).all()
  assert err.max() > 0   # hi + lo is not x itself: the lo part is rounded


def _product(a, b, passes):
  """a @ b^T (the last dims contracted) of f32 tensors as the kernels take
  it: the split operands' products in float64, summed, rounded to f32.
  passes 3: a_lo b_hi + a_hi b_lo + a_hi b_hi; 1: a_hi b_hi."""
  (ah, al), (bh, bl) = attn.split_tf32(a), attn.split_tf32(b)
  mm = lambda x, y: torch.matmul(x.double(), y.double().transpose(-1, -2))
  out = mm(ah, bh)
  if passes == 3:
    out = mm(al, bh) + mm(ah, bl) + out
  return out.float()


def _bwd_emulated(q, k, v, do, shift, passes):
  """K4's (shift False: exp2 of the clamped scores) or K8's (shift True:
  less the row max) backward on heads-first (B, H, L, D) f32 tensors, as
  the kernels compute it: S = Q K^T and dP = dO V^T; r = 1 / rowsum(e), c
  = rowsum(dP e) r; dS = e (dP - c); dQ = (dS K) r scale, dK = (dS^T r
  scale) Q, dV = (e^T r) dO, every product through `_product`."""
  d = q.shape[-1]
  scale, scale2 = attn.scale_f32(d), attn.scale_log2(d)
  t = _product(q, k, passes) * scale2
  if shift:
    e = torch.exp2(t - t.amax(-1, keepdim=True))
  else:
    e = torch.exp2(torch.clamp(t, -attn.CLAMP, attn.CLAMP))
  r = 1.0 / e.sum(-1, keepdim=True)
  dp = _product(do, v, passes)
  c = (dp * e).sum(-1, keepdim=True) * r
  ds = e * (dp - c)
  t_ = lambda x: x.transpose(-1, -2).contiguous()
  dq = _product(ds, t_(k), passes) * (r * scale)
  dk = _product(t_(ds * (r * scale)), t_(q), passes)
  dv = _product(t_(e * r), t_(do), passes)
  return dq, dk, dv


def _case(l, d, shift, passes):
  """The worst error of the emulated backward against the f64 plain
  version, relative to each output's largest value floored at 1e-2 of the
  largest of the three (as the card tests floor it)."""
  rng = np.random.default_rng(l * 1000 + d)
  q, k, v, do = (torch.from_numpy(
      rng.standard_normal((1, l, HEADS * d)).astype(np.float32))
                 for _ in range(4))
  heads_first = lambda x: x.view(1, l, HEADS, d).transpose(1, 2).contiguous()
  got = _bwd_emulated(*(heads_first(x) for x in (q, k, v, do)), shift,
                      passes)
  got = [g.transpose(1, 2).reshape(1, l, HEADS * d) for g in got]
  f64 = [x.double() for x in (q, k, v, do)]
  if shift:
    want = attn.attention_bwd_plain(*(x.view(1, l, HEADS, d) for x in f64))
    want = [w.reshape(1, l, HEADS * d) for w in want]
  else:
    want = attn.attention_packed_bwd_plain(*f64, HEADS)
  assert all(w.dtype == torch.float64 for w in want)
  top = max(w.abs().max().item() for w in want)
  return max((g.double() - w).abs().max().item()
             / max(w.abs().max().item(), 1e-2 * top)
             for g, w in zip(got, want))


@pytest.mark.parametrize("kernel", ["K4", "K8"])
@pytest.mark.parametrize("l,d", SHAPES)
def test_3xtf32_backward_matches_f64(kernel, l, d):
  err = _case(l, d, kernel == "K8", passes=3)
  assert err <= 1e-5, err


@pytest.mark.parametrize("kernel", ["K4", "K8"])
@pytest.mark.parametrize("l,d", SHAPES)
def test_one_tf32_pass_misses_the_tolerance(kernel, l, d):
  err = _case(l, d, kernel == "K8", passes=1)
  assert err > 1e-4, err
