"""The arithmetic of the f32 attention kernels that take their products
3xTF32 on the tensor cores, on the CPU: K3's and K7's forwards
(`csrc/sm90_f32x3_attention.cuh`) and K4's and K8's backwards
(`csrc/sm90_f32x3_attention_bwd.cuh`).

The kernels run on the card only; these tests hold what they are built
on. `attention.split_tf32` splits an f32 value into a tf32 hi part
(rounded to nearest, ties away from zero, as `cvt.rna.tf32.f32`) and a
tf32 lo part of the rest, and hi + lo is the value to within 2^-22 of it.
The kernels' formulas, their products taken as the kernels take them
(a_lo b_hi + a_hi b_lo + a_hi b_hi of the split f32 operands, summed in
f32) over the kernels' chunks (32 columns of D a score product, the keys
in chunks of `chunk_width(L)`, each chunk's product added in f32), stay
within 1e-5 of each output's scale of the float64 plain versions
(`attention_packed_plain`, `attention_plain` and their backwards, which
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


def chunk_width(l):
  """The key chunk of the f32 kernels (`f32x3::chunk_width`): L split
  into as few chunks of at most 64 as it takes, evened out, rounded up to
  a multiple of 8."""
  chunks = -(-l // 64)
  return (-(-l // chunks) + 7) // 8 * 8


def _f32(x):
  return x.to(torch.float32)


def _scores(q, k, passes):
  """S = q k^T of heads-first f32 tensors as the forwards take it, a pair
  (hi, lo) of f32 tensors whose sum is the score. passes 6, the kernels':
  per 32-column step, q and k split by `split_grid`, big = the p0
  products' sum (exact in f32: asserted), small = q0 k2 + q2 k0 + q1 k1 +
  q0 k1 + q1 k0 (float64, rounded to f32); lo takes small, then hi takes
  big by an f32 two-sum and lo its rounding error. passes 1: one TF32
  pass a 32-column chunk, the chunks added in f32, lo 0."""
  mm = lambda x, y: torch.matmul(x.double(), y.double().transpose(-1, -2))
  hi = lo = None
  for c0 in range(0, q.shape[-1], 32):
    qc, kc = q[..., c0:c0 + 32], k[..., c0:c0 + 32]
    if passes == 1:
      big, small = _product(qc, kc, 1), torch.zeros(())
    else:
      (q0, q1, q2), (k0, k1, k2) = attn.split_grid(qc), attn.split_grid(kc)
      exact = mm(q0, k0)
      big = _f32(exact)
      assert torch.equal(big.double(), exact)
      small = _f32(mm(q0, k2) + mm(q2, k0) + mm(q1, k1) + mm(q0, k1)
                   + mm(q1, k0))
    if hi is None:
      hi, lo = big, small + torch.zeros_like(big)
      continue
    total = hi + big
    b = total - hi
    lo = (lo + small) + ((hi - (total - b)) + (big - b))
    hi = total
  return hi, lo


def _fma(a, b, c):
  """a b + c with one f32 rounding (f32 a, b, c: a b is exact in
  float64)."""
  return _f32(a.double() * b + c.double())


def fwd_emulated(q, k, v, shift, passes):
  """K3's (shift False: exp2 of the clamped scores) or K7's (shift True:
  less the running row max) forward on heads-first (B, H, L, D) f32
  tensors, as the kernel computes it: S = Q K^T as the pair hi + lo
  (`_scores`), t = fma(hi, scale2, lo scale2); then per key chunk e from
  the policy (under MaxShift e = exp2(fma(hi, scale2, -m) + lo scale2),
  the sums and o rescaled by exp2(m - m_new) where the row max grows), o
  = o alpha + e V_chunk; o times 1 / rowsum(e). e V through `_product`
  (3xTF32, or one pass where `passes` is 1)."""
  l = k.shape[-2]
  scale2 = attn.scale_log2(q.shape[-1])
  hi, lo = _scores(q, k, 1 if passes == 1 else 6)
  lo2 = _f32(lo * scale2)
  o = torch.zeros_like(q)
  se = torch.zeros(*q.shape[:-1], 1)
  m = torch.full_like(se, -float("inf"))
  n = chunk_width(l)
  for k0 in range(0, l, n):
    h, s2 = hi[..., k0:k0 + n], lo2[..., k0:k0 + n]
    alpha = torch.ones_like(se)
    if shift:
      m_new = torch.maximum(m, _fma(h, scale2, s2).amax(-1, keepdim=True))
      alpha, m = torch.exp2(m - m_new), m_new
      e = torch.exp2(_fma(h, scale2, -m) + s2)
    else:
      e = torch.exp2(torch.clamp(_fma(h, scale2, s2), -attn.CLAMP,
                                 attn.CLAMP))
    se = se * alpha + e.sum(-1, keepdim=True)
    vt = v[..., k0:k0 + n, :].transpose(-1, -2).contiguous()
    o = o * alpha + _product(e, vt, 1 if passes == 1 else 3)
  return o * (1.0 / se)


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


def inputs(l, d):
  """q, k, v, dO, (1, L, HEADS * D) f32, from a numpy generator seeded
  by the shape."""
  rng = np.random.default_rng(l * 1000 + d)
  return [torch.from_numpy(
      rng.standard_normal((1, l, HEADS * d)).astype(np.float32))
          for _ in range(4)]


def emulated(kernel, q, k, v, do, passes):
  """The kernel's outputs, (1, L, HEADS * D) f32, as `fwd_emulated` or
  `_bwd_emulated` take them."""
  l, d = q.shape[1], q.shape[2] // HEADS
  heads_first = lambda x: x.view(1, l, HEADS, d).transpose(1, 2).contiguous()
  shift = kernel in ("K7", "K8")
  if kernel in ("K3", "K7"):
    got = [fwd_emulated(*(heads_first(x) for x in (q, k, v)), shift,
                        passes)]
  else:
    got = _bwd_emulated(*(heads_first(x) for x in (q, k, v, do)), shift,
                        passes)
  return [g.transpose(1, 2).reshape(1, l, HEADS * d) for g in got]


def _case(kernel, l, d, passes):
  """The worst error of the emulated kernel against the f64 plain
  version, relative to each output's largest value floored at 1e-2 of the
  largest of them (as the card tests floor it)."""
  q, k, v, do = inputs(l, d)
  got = emulated(kernel, q, k, v, do, passes)
  f64 = [x.double() for x in (q, k, v, do)]
  as4 = lambda x: x.view(1, l, HEADS, d)
  if kernel == "K3":
    want = [attn.attention_packed_plain(*f64[:3], HEADS)]
  elif kernel == "K7":
    want = [attn.attention_plain(*map(as4, f64[:3]))]
  elif kernel == "K4":
    want = attn.attention_packed_bwd_plain(*f64, HEADS)
  else:
    want = attn.attention_bwd_plain(*map(as4, f64))
  want = [w.reshape(1, l, HEADS * d) for w in want]
  assert all(w.dtype == torch.float64 for w in want)
  top = max(w.abs().max().item() for w in want)
  return max((g.double() - w).abs().max().item()
             / max(w.abs().max().item(), 1e-2 * top)
             for g, w in zip(got, want))


@pytest.mark.parametrize("kernel", ["K4", "K8"])
@pytest.mark.parametrize("l,d", SHAPES)
def test_3xtf32_backward_matches_f64(kernel, l, d):
  err = _case(kernel, l, d, passes=3)
  assert err <= 1e-5, err


@pytest.mark.parametrize("kernel", ["K3", "K7"])
@pytest.mark.parametrize("l,d", SHAPES)
def test_3xtf32_forward_matches_f64(kernel, l, d):
  err = _case(kernel, l, d, passes=3)
  assert err <= 1e-5, err


@pytest.mark.parametrize("seed", [40, 100, 110])
def test_forward_score_pairs_hold_large_logits(seed):
  """q and k at 30 N(0, 1) and D = 64, as the card's
  `test_f32_unpacked_attention_takes_large_logits` takes them: scores up
  to about 3e4, where half an ulp of an f32 score moves e by 1e-4. The
  emulated K7 forward, its scores a pair, stays within 1e-5 of the
  float64 plain version's largest output."""
  rng = np.random.default_rng(seed)
  q, k, v = (torch.from_numpy((rng.standard_normal((2, 3, 65, 64)) * s)
                              .astype(np.float32)) for s in (30, 30, 1))
  got = fwd_emulated(q, k, v, True, 3)
  as4 = lambda x: x.double().transpose(1, 2)
  want = attn.attention_plain(as4(q), as4(k), as4(v)).transpose(1, 2)
  err = (got.double() - want).abs().max().item()
  assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("kernel", ["K4", "K8", "K3", "K7"])
@pytest.mark.parametrize("l,d", SHAPES)
def test_one_tf32_pass_misses_the_tolerance(kernel, l, d):
  err = _case(kernel, l, d, passes=1)
  assert err > 1e-4, err
