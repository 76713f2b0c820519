"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only, so it also runs where JAX is not
installed: on a machine with a GPU and nvcc,

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(`--noconftest` skips tests/conftest.py, which sets up JAX). The tests
marked `cuda` skip where there is no CUDA device: K1 and K3 (the forwards)
and K2 and K4 (the backwards) against their plain versions at the
training and sampler lengths (K3 and K4 also at the edges of their tiles
and rings and at their own length limits, with 1, 3 and 12 heads and batch
1 and 5), two launches of each backward and of K3 giving the same bits
(three of K2 in a row, also at B = 1, at L = 1, over two groups of batch
rows and at width 1,024 with and without modulation; two K2 launches on
two streams at once against the same two in turn), K3 and K4 past the
±80 clamp, the wrappers refusing what the kernels do
not take (a length 16 past a kernel's limit among them), and the
sampler's no-grad path writing no statistics and launching no backward;
then the fused MLP (K5: also at the training shapes, at a ragged row
count, at width 1,024 and at a hidden width that is not a multiple of 128;
its stage timer), the fused MHA (K6: also at the training shapes,
at ragged lengths, at width 1,024 and at its own length limit) and the
[B, L, H, D] attention with the max-shift softmax (K7, K8) in the same
way (K7 also at its own length limit, two launches giving the same bits;
K8 also at L = 1, at 65, at 720 and 1,024 past its old limit of 704, at
its new limit of 4,096 with batch 1, and with logits around ±1e4),
and the seven arms of the ablation kernel (K9) at lengths that are not a
multiple of 16, at 80 and 144 (multiples of 16 but not of its 64-row
tiles) and at 257, two launches of each giving the same bits, and
`mulmask` with scores near -300, where a zero key of the tile past L would
change the max; and each of the thirteen wrappers (K5-K8 in f32 among
them) launching its kernel from a thread that has run no CUDA work yet,
with the same bits as from the main thread; and the input pipeline's copy onto the card giving the bytes of
the same batches on the CPU; and the int8 matmul (`torch._int_mm`, a
library call) against the CPU's exact integer product, and refusing the
shapes `_int_mm` does not take; K3 and K4 at UMD-L/2's 16 heads of 64
(width 1,024); and the Stable Diffusion VAE (cuDNN, no kernel of the port)
on the card against the CPU at a small shape. K1 and K2 at every width of
the variant tables and the narrow widths of the quick configs (32 ... 2,048,
modulated or not, K2 three launches in a row and on two streams), and K3
and K4 at head dims 8, 16, 80, 104, 128, 136, 192, 200, 248 and 256 (and
24, 40, 72, 96, 120), against the plain versions, two launches giving the
same bits; a width past MAX_WIDTH (8,192) and a head dim of 2,056 raise
the named error, with no plain route. K6, K7, K8 and each arm of K9 at
head dims 8, 16, 80, 88, 104, 128, 136, 192, 200 and 256 (L = 20, 68, 257
and 260) against
their plain versions in the tests of each at head dim 64, two launches
giving the same bits; K3, K6, K7 and K9 past the lengths whose K and V
they keep resident (320 keys at head dims up to 64, 384 up to 128, none
above), where K and V stream through a ring: at 1,024, 1,025 and 4,096
(head dim 64), 1,369 (80) and 1,024 and 4,096 (256), and at head dims 128
and 256 from 384 (1 at 256) to 4,096, K4 and K8 too at 256, two launches
giving the same bits, and 4,097 refused, the limit K4 and K8 share; K3
and K7 streamed at the resident lengths giving the resident launch's
bits; head dims that are not multiples of 8 (1, 4, 12 as `heads=32`
gives at UMD-S's 384, 13), which the wrappers run on heads zero-padded to
the next multiple of 8, in every attention kernel and K6, against the
plain versions at the true head dim; K5 and K6 at widths that are not
multiples of 64 (ViT-mu's 32 -> 128 and 2 heads of 16, SigLIP So400m's
1,152 -> 4,304, a tensor rank's 96 columns) and not multiples of 8 (36 ->
150, padded); head dims 2,056 and 0 refused by all six wrappers, with no
launch. Past 256 (`WIDER_HEAD_DIMS`: 264, 384, 520, 768, 1,024, 1,664 and
2,048, five to 32 tiles a head) K3, K4, K6, K7, K8 and K9's prod and exp2
arms at L = 20 and 65, all seven arms at 520, every kernel at 1,024 and
2,048 from one key to 4,096, two launches of each giving the same bits,
and every chunk count of the outputs' columns (`chunk_tiles`) giving the
same bits at 264 and 768. K1-K4 in f32 (their f32 instances): K1 and K2
at width 768 and the training and sampler lengths, y and dx within 1e-5
of their largest value and the sums within 1e-4, K2 three launches in a
row and two on two streams at once giving the same bits; K1 and K2 in
bf16 and f32 at widths 1, 36, 100, 1,000, 2,080, 4,096 and 8,192, and on
rows off a 16-byte boundary (2- and 1-element loads); K3 and K4 at 12
heads of 64, at L = 1, 63, 65 and 4,096 and at head dims 1, 12, 192, 768
and 2,048, within 1e-4 of each output's largest value, two launches
giving the same bits; the f32 wrappers refusing the bf16 kernels'
options, L = 4,097 and head dim 2,056, and K9 refusing f32; an f32
block under "pallas" and under "pallas_fused" on the card against the
CPU. K5-K8 in f32 (their f32 instances): K5 at widths 1, 36, 768 and
1,024, K6 at head dims 1, 12, 64, 384 and 2,048 and on non-square
projections, K7 and K8 at those head dims, each at L = 1, 257 and 4,096,
within 1e-5 of the output's largest value (K8: 1e-4 of each gradient's),
two launches giving the same bits, counted under the f32 names; their
stage timers; K3 and K4 in f32 giving the bits of their 3xTF32 kernels,
and K6 in f32 those of its SIMT kernels (a digest of their outputs); K3,
K4, K7 and K8 in f32 within 1e-5 of the float64 plain versions at 12
heads of 64 (L = 257), 32 of 12 (L = 68) and 1 of 768 (the forwards also
at head dim 13), and six launches of each giving the same bits at every
key-chunk width the kernels take (L = 68, 257, 4,096, 1) and at head dim
13.
The others check, on the CPU, that the wrappers refuse CPU tensors and
that CPU tensors take the plain versions.
"""

import threading

import numpy as np
import pytest
import torch

from small_vision_tpu_torch.ops import _build
from small_vision_tpu_torch.ops import attention as attn
from small_vision_tpu_torch.ops import fused_block as fb
from small_vision_tpu_torch.ops import layernorm as ln


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  return torch.device("cuda")


def _randn(shape, seed, device, dtype, scale=1.0, shift=0.0):
  a = np.random.default_rng(seed).standard_normal(shape) * scale + shift
  return torch.from_numpy(a.astype(np.float32)).to(device, dtype)


def _ln_args(device, l, modulate, b=8, d=768, seed=0):
  x = _randn((b, l, d), seed, device, torch.bfloat16, 2.0, 0.5)
  gamma = _randn((d,), seed + 1, device, torch.float32, 0.1, 1.0)
  beta = _randn((d,), seed + 2, device, torch.float32, 0.1)
  if not modulate:
    return x, gamma, beta, None, None
  # shift/scale as the block makes them: column slices of one (b, 6d).
  mods = _randn((b, 6 * d), seed + 3, device, torch.bfloat16, 0.3)
  shift, scale = mods.chunk(6, dim=-1)[:2]
  return x, gamma, beta, shift, scale


def test_wrappers_refuse_cpu_tensors():
  x, gamma, beta, _, _ = _ln_args("cpu", 4, False, b=2, d=256)
  with pytest.raises(ValueError, match="CUDA tensor"):
    ln.ln_modulate_fwd(x, gamma, beta)
  q = torch.zeros(1, 4, 128, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="CUDA tensor"):
    attn.attention_packed_fwd(q, q, q, 2)


def test_backward_wrappers_refuse_cpu_tensors():
  x, gamma, beta, _, scale = _ln_args("cpu", 4, True, b=2, d=768)
  stats = torch.zeros(2, 4)
  with pytest.raises(ValueError, match="CUDA tensor"):
    ln.ln_modulate_bwd(x, x, stats, stats, gamma, beta, scale)
  q = torch.zeros(1, 4, 128, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="CUDA tensor"):
    attn.attention_packed_bwd(q, q, q, q, 2)


def test_cpu_tensors_take_the_plain_versions():
  before = dict(_build.LAUNCHES)
  args = _ln_args("cpu", 20, True, b=2, d=256)
  torch.testing.assert_close(ln.ln_modulate(*args),
                             ln.ln_modulate_plain(*args), rtol=0, atol=0)
  q = _randn((2, 20, 128), 5, "cpu", torch.bfloat16)
  torch.testing.assert_close(attn.attention_packed(q, q, q, 2),
                             attn.attention_packed_plain(q, q, q, 2),
                             rtol=0, atol=0)
  assert dict(_build.LAUNCHES) == before  # no kernel counted


def test_cpu_gradients_take_the_plain_backwards():
  before = dict(_build.LAUNCHES)
  x, gamma, beta, shift, scale = (
      None if t is None else t.requires_grad_()
      for t in _ln_args("cpu", 6, True, b=2, d=256))
  ln.ln_modulate(x, gamma, beta, shift, scale).float().sum().backward()
  q = _randn((2, 6, 128), 5, "cpu", torch.bfloat16).requires_grad_()
  attn.attention_packed(q, q, q, 2).float().sum().backward()
  assert x.grad is not None and q.grad is not None
  assert dict(_build.LAUNCHES) == before  # no kernel counted


@pytest.mark.cuda
@pytest.mark.parametrize("l", [260, 257])
@pytest.mark.parametrize("modulate", [False, True])
def test_ln_kernel_matches_plain(cuda, l, modulate):
  args = _ln_args(cuda, l, modulate)
  before = _build.LAUNCHES[ln.NAME]
  got = ln.ln_modulate(*args).float()
  assert _build.LAUNCHES[ln.NAME] == before + 1
  want = ln.ln_modulate_plain(*args).float()
  # One bf16 ulp of the output (2^-7 relative), plus f32 rounding of the
  # O(1) intermediates, which may tip a value across a bf16 tie.
  assert torch.all((got - want).abs() <= 2.0**-7 * want.abs() + 1e-5)


@pytest.mark.cuda
def test_ln_kernel_writes_stats(cuda):
  x, gamma, beta, shift, scale = _ln_args(cuda, 33, True, b=2)
  mean = torch.empty(2, 33, device=cuda)
  rstd = torch.empty(2, 33, device=cuda)
  ln.ln_modulate_fwd(x, gamma, beta, shift, scale, mean=mean, rstd=rstd)
  xf = x.float()
  torch.testing.assert_close(mean, xf.mean(-1), rtol=1e-5, atol=1e-5)
  var = (xf - xf.mean(-1, keepdim=True)).square().mean(-1)
  torch.testing.assert_close(rstd, torch.rsqrt(var + 1e-6), rtol=1e-5,
                             atol=1e-5)


@pytest.mark.cuda
def test_ln_wrapper_refuses_what_the_kernel_does_not_take(cuda):
  x, gamma, beta, shift, scale = _ln_args(cuda, 4, True, b=2)
  # bf16 and f32 run (test_f32_ln_kernels_match_plain); float16 does not.
  with pytest.raises(ValueError, match="got torch.float16"):
    ln.ln_modulate_fwd(x.half(), gamma, beta)
  # Every width from 1 up to MAX_WIDTH runs (test_ln_kernels_at_new_widths);
  # one past it does not.
  wide = ln.MAX_WIDTH + 1
  with pytest.raises(ValueError, match=f"width {wide}"):
    ln.ln_modulate_fwd(torch.zeros(1, 2, wide, dtype=x.dtype, device=cuda),
                       torch.ones(wide, device=cuda),
                       torch.zeros(wide, device=cuda))
  with pytest.raises(ValueError, match="together"):
    ln.ln_modulate_fwd(x, gamma, beta, shift, None)
  with pytest.raises(ValueError, match="contiguous"):
    ln.ln_modulate_fwd(x.transpose(0, 1), gamma, beta)


# The forwards past the heads they keep resident (320 keys at head dims up
# to 64, 384 above), K and V streamed: ViT-L/16@512's 1,024 ("map") and
# 1,025 ("tok": 17 query tiles, so the last CTA's second warpgroup
# recomputes a tile and stores nothing), ViT-H/14@518's 1,369 at head dim
# 80, and 4,096, the limit they share with K4 and K8, also at head dim 256
# (`heads=3` at width 768; three or four tiles a head stream at every
# length): (batch, length, head dim), two heads (four for K6 at 80, whose
# projections took multiples of 64 columns only before its GEMM took
# tails).
LONG_CASES = [(2, 1024, 64), (2, 1025, 64), (1, 1369, 80), (1, 4096, 64),
              (1, 1024, 256), (1, 4096, 256)]
MAX_ATTN_LEN = 4096


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d", [(4, 20, 64), (4, 257, 64), (4, 260, 64)]
                         + LONG_CASES)
def test_attention_kernel_matches_plain(cuda, b, l, d):
  q, k, v = (_randn((b, l, 2 * d), s, cuda, torch.bfloat16)
             for s in range(3))
  before = _build.LAUNCHES[attn.NAME]
  got = attn.attention_packed(q, k, v, 2)
  assert _build.LAUNCHES[attn.NAME] == before + 1
  assert torch.equal(got, attn.attention_packed(q, k, v, 2))  # no atomics
  want = attn.attention_packed_plain(q, k, v, 2).float()
  # Outputs are convex mixes of N(0,1) values rounded to bf16 (ulp 2^-7 at
  # unit magnitude); scores summed in another order may flip the bf16
  # rounding of a weight e: allow two ulps.
  torch.testing.assert_close(got.float(), want, rtol=2**-7, atol=2**-7)


# Lengths where the heads stay resident (up to 320 keys at head dims up to
# 64, 384 above): the edges of the 64-row tiles, odd tile counts (257 and
# 320: five, so the streamed launch's last CTA has an idle warpgroup).
@pytest.mark.cuda
@pytest.mark.parametrize("l,d", [(1, 64), (63, 64), (65, 64), (257, 64),
                                 (320, 64), (200, 80), (384, 128)])
def test_streamed_kernels_give_the_resident_bits(cuda, l, d):
  """K3 and K7 with K and V streamed through the ring (`streamed=True`,
  which the wrappers take past the resident lengths) give the bits of the
  resident launch: the same arithmetic in the same order."""
  q, k, v = (_randn((3, l, 3 * d), 40 + i, cuda, torch.bfloat16)
             for i in range(3))
  assert torch.equal(attn.attention_packed_fwd(q, k, v, 3, streamed=True),
                     attn.attention_packed_fwd(q, k, v, 3))
  q4, k4, v4 = (t.view(3, l, 3, d) for t in (q, k, v))
  assert torch.equal(attn.attention_unpacked_fwd(q4, k4, v4, streamed=True),
                     attn.attention_unpacked_fwd(q4, k4, v4))


# The edges of K3's and K4's 64-row tiles and of their rings of key or
# query blocks; "max" is the kernel's own limit.
EDGE_LENS = (1, 16, 17, 63, 64, 65, 272, "max")


def _edge_len(l, max_len):
  return max_len if l == "max" else l


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("heads", [1, 3, 12])
@pytest.mark.parametrize("l", EDGE_LENS)
def test_attention_kernel_matches_plain_at_the_edges(cuda, l, heads, b):
  l = _edge_len(l, attn._lib()[1](64))
  q, k, v = (_randn((b, l, heads * 64), s, cuda, torch.bfloat16)
             for s in range(3))
  got = attn.attention_packed_fwd(q, k, v, heads).float()
  want = attn.attention_packed_plain(q, k, v, heads).float()
  # As in test_attention_kernel_matches_plain: two bf16 ulps at unit
  # magnitude.
  torch.testing.assert_close(got, want, rtol=2**-7, atol=2**-7)


@pytest.mark.cuda
def test_attention_kernel_clamps_as_the_plain_version(cuda):
  """Scores far past the ±80 clamp: finite outputs that agree."""
  q, k, v = (_randn((2, 20, 2 * 64), s, cuda, torch.bfloat16,
                    40.0 if s < 2 else 1.0) for s in range(3))
  got = attn.attention_packed_fwd(q, k, v, 2).float()
  want = attn.attention_packed_plain(q, k, v, 2).float()
  assert torch.all(torch.isfinite(got))
  torch.testing.assert_close(got, want, rtol=2**-7, atol=2**-7)


@pytest.mark.cuda
def test_attention_kernel_is_deterministic(cuda):
  q, k, v = (_randn((8, 257, 2 * 64), s, cuda, torch.bfloat16)
             for s in range(3))
  assert torch.equal(attn.attention_packed_fwd(q, k, v, 2),
                     attn.attention_packed_fwd(q, k, v, 2))


@pytest.mark.cuda
def test_attention_wrapper_refuses_what_the_kernel_does_not_take(cuda):
  q = torch.zeros(1, 8, 2 * 2056, dtype=torch.bfloat16, device=cuda)
  with pytest.raises(ValueError, match="head dim"):
    attn.attention_packed_fwd(q, q, q, 2)
  # L up to 4,096 at every head dim (the runs: test_attention_kernel_
  # matches_plain); one past it is refused.
  assert attn._lib()[1](64) == attn._lib()[1](128) == MAX_ATTN_LEN
  long = torch.zeros(1, attn._lib()[1](64) + 16, 64, dtype=torch.bfloat16,
                     device=cuda)
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_packed_fwd(long, long, long, 1)


def _ln_bwd_args(device, l, modulate, b=8, d=768, seed=0):
  """K2's inputs: K1's with its statistics, and an upstream gradient."""
  x, gamma, beta, shift, scale = _ln_args(device, l, modulate, b, d, seed)
  xf = x.float()
  mean = xf.mean(-1)
  rstd = torch.rsqrt((xf - mean[..., None]).square().mean(-1) + 1e-6)
  dy = _randn((b, l, d), seed + 4, device, torch.bfloat16)
  return x, dy, mean, rstd, gamma, beta, scale


@pytest.mark.cuda
@pytest.mark.parametrize("l", [68, 164, 257])
@pytest.mark.parametrize("modulate", [False, True])
def test_ln_bwd_kernel_matches_plain(cuda, l, modulate):
  args = _ln_bwd_args(cuda, l, modulate)
  before = _build.LAUNCHES[ln.BWD_NAME]
  got = ln.ln_modulate_bwd(*args)
  assert _build.LAUNCHES[ln.BWD_NAME] == before + 1
  want = ln.ln_modulate_bwd_plain(*args)
  dx, dx_want = got[0].float(), want[0].float()
  # dx is stored in bf16 from O(1) f32 values summed in another order:
  # one bf16 ulp (2^-8 relative, rounding either way) plus f32 noise.
  assert torch.all((dx - dx_want).abs() <= 2.0**-7 * dx_want.abs() + 1e-3)
  for g, w in zip(got[1:], want[1:]):
    if w is None:
      assert g is None
      continue
    # f32 sums of up to B*L = 2,056 O(1) terms in another order (and, for
    # dscale, with gamma and beta factored out): relative to the largest.
    assert g.dtype == torch.float32 and g.shape == w.shape
    torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,modulate", [
    (16, 257, 768, True), (1, 68, 768, True), (8, 1, 768, True),
    (20, 17, 768, False), (8, 164, 1024, True), (8, 164, 1024, False)])
def test_ln_bwd_kernel_is_deterministic(cuda, b, l, d, modulate):
  """Three launches in a row give the same bits: the sums over the batch
  run in a fixed order, and each launch zeroes its own ticket counters
  (B = 1, L = 1, two groups of batch rows, width 1,024)."""
  args = _ln_bwd_args(cuda, l, modulate, b=b, d=d)
  first = ln.ln_modulate_bwd(*args)
  for _ in range(2):
    for a, again in zip(first, ln.ln_modulate_bwd(*args)):
      assert (a is None and again is None) or torch.equal(a, again)
  want = ln.ln_modulate_bwd_plain(*args)
  dx, dx_want = first[0].float(), want[0].float()
  # The tolerances of test_ln_bwd_kernel_matches_plain.
  assert torch.all((dx - dx_want).abs() <= 2.0**-7 * dx_want.abs() + 1e-3)
  for g, w in zip(first[1:], want[1:]):
    if w is not None:
      torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * w.abs().max())


@pytest.mark.cuda
def test_ln_bwd_kernel_on_two_streams_matches_launches_in_turn(cuda):
  """Two launches in flight at once on two streams, at the training shapes
  (128, 257) modulated and (128, 68) plain, give the bits of the same two
  launches one after the other: each launch's ticket counters are its
  own."""
  cases = [_ln_bwd_args(cuda, 257, True, b=128),
           _ln_bwd_args(cuda, 68, False, b=128, seed=7)]
  in_turn = [ln.ln_modulate_bwd(*args) for args in cases]
  for _ in range(5):
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    start = torch.cuda.current_stream(cuda)
    got = []
    for stream, args in zip(streams, cases):
      stream.wait_stream(start)
      with torch.cuda.stream(stream):
        got.append(ln.ln_modulate_bwd(*args))
    for stream in streams:
      start.wait_stream(stream)
    torch.cuda.synchronize(cuda)
    for want, outs in zip(in_turn, got):
      for w, g in zip(want, outs):
        assert (w is None and g is None) or torch.equal(w, g)


@pytest.mark.cuda
def test_ln_bwd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
  x, dy, mean, rstd, gamma, beta, scale = _ln_bwd_args(cuda, 4, True, b=2)
  with pytest.raises(ValueError, match="bfloat16"):
    ln.ln_modulate_bwd(x, dy.float(), mean, rstd, gamma, beta, scale)
  with pytest.raises(ValueError, match="contiguous"):
    ln.ln_modulate_bwd(x, dy.transpose(0, 1), mean, rstd, gamma, beta,
                       scale)
  with pytest.raises(ValueError, match="float32"):
    ln.ln_modulate_bwd(x, dy, mean.half(), rstd, gamma, beta, scale)
  wide = ln.MAX_WIDTH + 8
  with pytest.raises(ValueError, match=f"width {wide}"):
    big = torch.zeros(2, 4, wide, dtype=x.dtype, device=cuda)
    ln.ln_modulate_bwd(big, big, mean, rstd, torch.ones(wide, device=cuda),
                       torch.zeros(wide, device=cuda))


def _qkv_do(device, l, b=4, h=2, seed=0, scale=1.0):
  return [_randn((b, l, h * 64), seed + i, device, torch.bfloat16,
                 scale if i < 2 else 1.0) for i in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("l", [20, 68, 164, 257])
def test_attention_bwd_kernel_matches_plain(cuda, l):
  q, k, v, do = _qkv_do(cuda, l)
  before = _build.LAUNCHES[attn.BWD_NAME]
  got = attn.attention_packed_bwd(q, k, v, do, 2)
  assert _build.LAUNCHES[attn.BWD_NAME] == before + 1
  want = attn.attention_packed_bwd_plain(q, k, v, do, 2)
  for g, w in zip(got, want):
    g, w = g.float(), w.float()
    # bf16 outputs of f32 sums over L terms; the kernel sums in another
    # order, which may flip the bf16 rounding of an e, dO*r or dS product
    # input: a few bf16 ulps of the largest output.
    err = (g - w).abs().max().item()
    assert err <= 2.0**-6 * w.abs().max().item(), (err, w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("heads", [1, 3, 12])
@pytest.mark.parametrize("l", EDGE_LENS)
def test_attention_bwd_kernel_matches_plain_at_the_edges(cuda, l, heads, b):
  l = _edge_len(l, attn._bwd_lib()[1])
  q, k, v, do = _qkv_do(cuda, l, b=b, h=heads)
  got = attn.attention_packed_bwd(q, k, v, do, heads)
  want = attn.attention_packed_bwd_plain(q, k, v, do, heads)
  # As in test_attention_bwd_kernel_matches_plain: a few bf16 ulps of the
  # largest output. At L = 1 dq and dk vanish analytically (one key: dS =
  # e (dP - dP)) and both sides hold f32 round-off of about 1e-7, so each
  # output's scale is floored at 1e-3 of the largest of the three.
  top = max(w.float().abs().max().item() for w in want)
  for g, w in zip(got, want):
    g, w = g.float(), w.float()
    err = (g - w).abs().max().item()
    scale = max(w.abs().max().item(), 1e-3 * top)
    assert err <= 2.0**-6 * scale, (err, scale)


@pytest.mark.cuda
def test_attention_bwd_kernel_clamps_as_the_plain_version(cuda):
  """Past the ±80 clamp both treat it as the identity: finite gradients
  that agree."""
  q, k, v, do = _qkv_do(cuda, 20, scale=40.0)
  got = attn.attention_packed_bwd(q, k, v, do, 2)
  want = attn.attention_packed_bwd_plain(q, k, v, do, 2)
  for g, w in zip(got, want):
    g, w = g.float(), w.float()
    assert torch.all(torch.isfinite(g))
    assert (g - w).abs().max().item() <= 2.0**-6 * w.abs().max().item()


@pytest.mark.cuda
def test_attention_bwd_kernel_is_deterministic(cuda):
  q, k, v, do = _qkv_do(cuda, 257, b=8)
  first = attn.attention_packed_bwd(q, k, v, do, 2)
  second = attn.attention_packed_bwd(q, k, v, do, 2)
  for a, b in zip(first, second):
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_attention_bwd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
  q = torch.zeros(1, 8, 2 * 2056, dtype=torch.bfloat16, device=cuda)
  with pytest.raises(ValueError, match="head dim"):
    attn.attention_packed_bwd(q, q, q, q, 2)
  long = torch.zeros(1, attn._bwd_lib()[1] + 16, 64, dtype=torch.bfloat16,
                     device=cuda)
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_packed_bwd(long, long, long, long, 1)
  q = torch.zeros(1, 8, 128, dtype=torch.bfloat16, device=cuda)
  with pytest.raises(ValueError, match="contiguous"):
    attn.attention_packed_bwd(q, q, q, q.float(), 2)


@pytest.mark.cuda
def test_autograd_functions_launch_the_kernels(cuda):
  x, gamma, beta, shift, scale = (
      t.requires_grad_() for t in _ln_args(cuda, 20, True, b=2))
  q, k, v = (t.requires_grad_() for t in _qkv_do(cuda, 20)[:3])
  _build.reset_launches()
  y = ln.ln_modulate(x, gamma, beta, shift, scale)
  o = attn.attention_packed(q, k, v, 2)
  (y.float().sum() + o.float().sum()).backward()
  assert dict(_build.LAUNCHES) == {ln.NAME: 1, ln.BWD_NAME: 1,
                                   attn.NAME: 1, attn.BWD_NAME: 1}
  assert shift.grad.dtype == torch.bfloat16 and gamma.grad.dtype == \
      torch.float32


@pytest.mark.cuda
def test_no_grad_path_writes_no_stats_and_launches_no_backward(cuda):
  """The sampler's path: K1 without its statistics, K3, and nothing else,
  even on tensors that require grad."""
  x, gamma, beta, shift, scale = (
      t.requires_grad_() for t in _ln_args(cuda, 20, True, b=2))
  q = _qkv_do(cuda, 20)[0].requires_grad_()
  _build.reset_launches()
  with torch.inference_mode():
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = ln.ln_modulate(x, gamma, beta, shift, scale)
    # Only y is allocated: no (B, L) mean/rstd buffers.
    assert torch.cuda.max_memory_allocated() - base <= \
        y.numel() * y.element_size() + 512
    attn.attention_packed(q, q, q, 2)
  assert dict(_build.LAUNCHES) == {ln.NAME: 1, attn.NAME: 1}


# ---------------------------------------------------------------------------
# K5-K8: the fused MLP, the fused MHA and the [B, L, H, D] attention.
# ---------------------------------------------------------------------------


def _mlp_args(device, rows_shape, d=768, hidden=3072, seed=0):
  x = _randn((*rows_shape, d), seed, device, torch.bfloat16)
  w1 = _randn((d, hidden), seed + 1, device, torch.bfloat16, d**-0.5)
  b1 = _randn((hidden,), seed + 2, device, torch.bfloat16, 0.1)
  w2 = _randn((hidden, d), seed + 3, device, torch.bfloat16, hidden**-0.5)
  b2 = _randn((d,), seed + 4, device, torch.bfloat16, 0.1)
  return x, w1, b1, w2, b2


def _mha_args(device, b, l, heads, seed=0, hd=64):
  d = heads * hd
  args = [_randn((b, l, d), seed, device, torch.bfloat16)]
  for i in range(4):
    args += [_randn((d, d), seed + 2 * i + 1, device, torch.bfloat16, d**-0.5),
             _randn((d,), seed + 2 * i + 2, device, torch.bfloat16, 0.1)]
  return args


def _assert_close_to_max(got, want, ulps):
  """Within `ulps` bf16 ulps of the largest value, an ulp taken as 2^-7 of
  it (the spacing of bf16 values lies between 2^-8 and 2^-7 of their
  magnitude)."""
  got, want = got.float(), want.float()
  err = (got - want).abs().max().item()
  assert err <= ulps * 2.0**-7 * want.abs().max().item(), (err,
                                                          want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows_shape,d,hidden", [
    ((3, 20), 768, 3072), ((8, 260), 768, 3072), ((1, 64), 768, 3072),
    ((130,), 768, 3072),
    ((128, 68), 768, 3072), ((128, 164), 768, 3072),  # the training shapes
    ((128, 257), 768, 3072),
    ((3, 65), 768, 3072),  # ragged: not a multiple of 64 or 128 rows
    ((4, 257), 1024, 4096),  # width 1,024
    ((3, 20), 768, 1088),  # hidden a multiple of 64, not of 128
    ((64, 196), 32, 128), ((64, 197), 32, 128),  # ViT-mu: one half stage
    ((8, 256), 1152, 4304),  # SigLIP So400m: hidden not a multiple of 64
    ((3, 20), 40, 176),  # multiples of 8 only
    ((3, 20), 36, 150), ((2, 7), 5, 3)])  # padded to multiples of 8
def test_fused_mlp_kernel_matches_plain(cuda, rows_shape, d, hidden):
  args = _mlp_args(cuda, rows_shape, d, hidden)
  before = _build.LAUNCHES[fb.MLP_NAME]
  got = fb.fused_mlp_fwd(*args)
  assert _build.LAUNCHES[fb.MLP_NAME] == before + 1
  assert got.shape == args[0].shape and got.dtype == torch.bfloat16
  # bf16 hidden activations and outputs on both sides; the f32 sums over
  # the width and the hidden width run in another order, which may flip
  # the rounding of a hidden value and moves an output by about an ulp:
  # allow two.
  _assert_close_to_max(got, fb.fused_mlp_plain(*args), 2)
  assert torch.equal(got, fb.fused_mlp_fwd(*args))  # no atomics


@pytest.mark.cuda
def test_fused_mlp_dispatch_and_refusals(cuda):
  x, w1, b1, w2, b2 = _mlp_args(cuda, (2, 20))
  _build.reset_launches()
  fb.fused_mlp(x, w1, b1, w2, b2)
  assert dict(_build.LAUNCHES) == {fb.MLP_NAME: 1}
  with pytest.raises(ValueError, match="bfloat16"):
    fb.fused_mlp_fwd(x.float(), w1, b1, w2, b2)
  narrow = _mlp_args(cuda, (2, 20), d=256, hidden=1024)
  _assert_close_to_max(fb.fused_mlp_fwd(*narrow), fb.fused_mlp_plain(*narrow),
                       2)
  # A width of 96 (a multiple of 8, not of 64) and a hidden width of 100
  # (padded to 104) run: K5 takes every width since its GEMM took tails.
  for args in (_mlp_args(cuda, (2, 20), d=96, hidden=384),
               (x, w1[:, :100].contiguous(), b1[:100].contiguous(),
                w2[:100].contiguous(), b2)):
    _build.reset_launches()
    got = fb.fused_mlp(*args)
    assert dict(_build.LAUNCHES) == {fb.MLP_NAME: 1}
    assert got.shape == args[0].shape and got.is_contiguous()
    _assert_close_to_max(got, fb.fused_mlp_plain(*args), 2)
  with pytest.raises(ValueError, match="contiguous"):
    fb.fused_mlp_fwd(x.transpose(0, 1), w1, b1, w2, b2)


@pytest.mark.cuda
def test_fused_mlp_stages_launch_both_kernels_and_count_nothing(cuda):
  args = _mlp_args(cuda, (2, 65))
  stages = fb.fused_mlp_stages(*args)
  assert set(stages) == {"up", "down"}
  _build.reset_launches()
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    stages["up"]()
    stages["down"]()
    torch.cuda.synchronize()
  assert not _build.LAUNCHES
  names = " ".join(e.name for e in prof.events())
  assert "fused_mlp_up_kernel" in names and "fused_mlp_down_kernel" in names


MAX_LEN = -1  # stands for the kernel's own length limit, known once built
# K6-K9 at the head dims of the variant tables and the narrow ones, and the
# wide ones of `heads=4` and `heads=3` at width 768 (192, 256; three and
# four 64-column tiles) and two with a ragged last tile (136, 200): (head
# dim, heads), the width heads x head dim (a multiple of 64 for K6's GEMM
# before it took tails; 384, 16 and 39 for the last three); each at
# (batch, length) (2, 20), (2, 68), (2, 257) and (1, 260).
WIDE_HEADS = ((8, 8), (16, 4), (80, 16), (88, 16), (104, 16), (128, 6),
              (136, 8), (192, 4), (200, 8), (256, 3),
              # Not multiples of 8: run on heads zero-padded to 16, 8, 16.
              (12, 32), (4, 4), (13, 3))
WIDE_CASES = [(b, l, heads, hd) for hd, heads in WIDE_HEADS
              for b, l in ((2, 20), (2, 68), (2, 257), (1, 260))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,heads,hd", [
    (3, 20, 12, 64), (2, 37, 3, 64), (4, 260, 12, 64), (4, 257, 12, 64),
    (2, 272, 2, 64),
    (128, 68, 12, 64), (128, 164, 12, 64),  # the training shapes
    (128, 257, 12, 64),
    (3, 65, 12, 64), (3, 200, 12, 64),  # ragged: not a multiple of 16 or 64
    (4, 260, 16, 64),  # width 1,024
    (64, 197, 2, 16), (64, 196, 2, 16),  # ViT-mu: H*D = 32, under a tile
    (2, MAX_LEN, 2, 64)] + WIDE_CASES + [
        (b, l, 4 if d == 80 else 2, d) for b, l, d in LONG_CASES])
def test_fused_mha_kernel_matches_plain(cuda, b, l, heads, hd):
  if l == MAX_LEN:
    l = fb.fused_mha_max_len(hd)
  args = _mha_args(cuda, b, l, heads, hd=hd)
  before = _build.LAUNCHES[fb.MHA_NAME]
  got = fb.fused_mha_fwd(*args, heads)
  assert _build.LAUNCHES[fb.MHA_NAME] == before + 1
  # q, k, v, the probabilities, the head outputs and the output round to
  # bf16 on both sides; sums in another order may flip an inner rounding:
  # two bf16 ulps of the largest output.
  _assert_close_to_max(got, fb.fused_mha_plain(*args, heads), 2)
  assert torch.equal(got, fb.fused_mha_fwd(*args, heads))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,width,heads", [
    (64, 260, 768, 6), (128, 257, 768, 6),  # a tensor rank's 6 of 12 heads
    (3, 65, 256, 2), (2, 37, 128, 4)])      # narrower and wider than square
def test_fused_mha_kernel_non_square_matches_plain(cuda, b, l, width, heads):
  """K6 on (width, heads * 64) projections and a (heads * 64, width)
  out-projection (the Megatron block's shard) against its plain version."""
  hd = heads * 64
  args = [_randn((b, l, width), 1, cuda, torch.bfloat16)]
  for i in range(3):
    args += [_randn((width, hd), 2 * i + 2, cuda, torch.bfloat16,
                    width**-0.5),
             _randn((hd,), 2 * i + 3, cuda, torch.bfloat16, 0.1)]
  args += [_randn((hd, width), 8, cuda, torch.bfloat16, hd**-0.5),
           _randn((width,), 9, cuda, torch.bfloat16, 0.1)]
  got = fb.fused_mha_fwd(*args, heads)
  assert got.shape == (b, l, width)
  _assert_close_to_max(got, fb.fused_mha_plain(*args, heads), 2)
  assert torch.equal(got, fb.fused_mha_fwd(*args, heads))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,width,heads,head_dim", [
    (64, 260, 384, 3, 32),  # a tensor rank's 3 of 12 heads: 96 columns
    (3, 65, 384, 3, 12), (2, 37, 36, 3, 12)])  # head dim (and width) padded
def test_fused_mha_kernel_at_narrow_shards_matches_plain(cuda, b, l, width,
                                                         heads, head_dim):
  """K6 on (width, heads * head_dim) projections that are not multiples
  of 64 columns, or whose head dim is not a multiple of 8 (run on heads
  padded by `pad_mha`), against its plain version; two launches give the
  same bits."""
  hd = heads * head_dim
  args = [_randn((b, l, width), 1, cuda, torch.bfloat16)]
  for i in range(3):
    args += [_randn((width, hd), 2 * i + 2, cuda, torch.bfloat16,
                    width**-0.5),
             _randn((hd,), 2 * i + 3, cuda, torch.bfloat16, 0.1)]
  args += [_randn((hd, width), 8, cuda, torch.bfloat16, hd**-0.5),
           _randn((width,), 9, cuda, torch.bfloat16, 0.1)]
  got = fb.fused_mha_fwd(*args, heads)
  assert got.shape == (b, l, width) and got.is_contiguous()
  _assert_close_to_max(got, fb.fused_mha_plain(*args, heads), 2)
  assert torch.equal(got, fb.fused_mha_fwd(*args, heads))  # no atomics


@pytest.mark.cuda
def test_fused_mha_refuses_what_the_kernel_does_not_take(cuda):
  args = _mha_args(cuda, 1, 8, 2)
  with pytest.raises(ValueError, match="not num_heads 3 heads"):
    fb.fused_mha_fwd(*args, 3)
  # 16 heads of 12 on (64, 192) projections: a head dim that is not a
  # multiple of 8 runs, on heads padded to 16.
  narrow = [args[0][..., :64].contiguous()]
  for i in range(3):
    narrow += [_randn((64, 192), i, cuda, torch.bfloat16, 0.125),
               _randn((192,), i, cuda, torch.bfloat16, 0.1)]
  narrow += [_randn((192, 64), 3, cuda, torch.bfloat16, 192**-0.5),
             _randn((64,), 4, cuda, torch.bfloat16, 0.1)]
  _assert_close_to_max(fb.fused_mha_fwd(*narrow, 16),
                       fb.fused_mha_plain(*narrow, 16), 2)
  # 2 heads of 2,056: past the largest head dim.
  wide = [_randn((1, 8, 4112), 5, cuda, torch.bfloat16)] + [
      torch.zeros(*shape, dtype=torch.bfloat16, device=cuda)
      for shape in ((4112, 4112), (4112,)) * 4]
  with pytest.raises(ValueError, match="head dim 2056"):
    fb.fused_mha_fwd(*wide, 2)
  with pytest.raises(ValueError, match="bfloat16"):
    fb.fused_mha_fwd(args[0].float(), *args[1:], 2)
  # 1,024 keys (one head of 64) run, K and V streamed; one past 4,096 is
  # refused.
  long = _mha_args(cuda, 1, 1024, 1)
  got = fb.fused_mha_fwd(*long, 1)
  assert torch.equal(got, fb.fused_mha_fwd(*long, 1))
  _assert_close_to_max(got, fb.fused_mha_plain(*long, 1), 2)
  assert fb.fused_mha_max_len(64) == MAX_ATTN_LEN
  past = _mha_args(cuda, 1, MAX_ATTN_LEN + 1, 1)
  with pytest.raises(ValueError, match="sequence length"):
    fb.fused_mha_fwd(*past, 1)


@pytest.mark.cuda
def test_fused_block_autograd_launches_the_kernels(cuda):
  """Forward K5 / K6; the MHA's backward recomputes through the packed
  attention (K3) and differentiates it (K4). CPU and card agree."""
  margs = _mha_args(cuda, 2, 37, 2)
  largs = _mlp_args(cuda, (2, 37))
  grads = {}
  for dev in ("cpu", "cuda"):
    m = [t.to(dev).requires_grad_() for t in margs]
    p = [t.to(dev).requires_grad_() for t in largs]
    _build.reset_launches()
    out = fb.fused_mha(*m, 2).float().sum() + fb.fused_mlp(*p).float().sum()
    out.backward()
    if dev == "cuda":
      assert dict(_build.LAUNCHES) == {
          fb.MHA_NAME: 1, fb.MLP_NAME: 1, attn.NAME: 1, attn.BWD_NAME: 1}
    else:
      assert not _build.LAUNCHES
    grads[dev] = [t.grad.float().cpu() for t in m + p]
  for c, g in zip(grads["cpu"], grads["cuda"]):
    # bf16 gradients through bf16 activations, summed in another order.
    err = (c - g).abs().max().item()
    assert err <= 2.0**-5 * max(c.abs().max().item(), 1e-3), err


def _qkv_do_4d(device, l, b=4, h=2, seed=0, scale=1.0, d=64):
  return [_randn((b, l, h, d), seed + i, device, torch.bfloat16,
                 scale if i < 2 else 1.0) for i in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,d", [
    (4, 20, 2, 64), (4, 37, 3, 64), (4, 80, 2, 64), (4, 144, 3, 64),
    (4, 257, 12, 64), (4, 260, 12, 64), (4, MAX_LEN, 1, 64),
    (1, MAX_LEN, 2, 128)] + WIDE_CASES + [(b, l, 2, d)
                                         for b, l, d in LONG_CASES])
def test_unpacked_attention_kernel_matches_plain(cuda, b, l, h, d):
  if l == MAX_LEN:
    l = attn._unpacked_lib()[1](d)
  q, k, v, _ = _qkv_do_4d(cuda, l, b=b, h=h, d=d)
  before = _build.LAUNCHES[attn.UNPACKED_NAME]
  got = attn.fused_attention(q, k, v)
  assert _build.LAUNCHES[attn.UNPACKED_NAME] == before + 1
  # Convex mixes of N(0,1) values rounded to bf16; a score sum in another
  # order may flip the rounding of a probability: two ulps.
  torch.testing.assert_close(got.float(),
                             attn.attention_plain(q, k, v).float(),
                             rtol=2**-7, atol=2**-7)
  assert torch.equal(got, attn.attention_unpacked_fwd(q, k, v))  # no atomics


@pytest.mark.cuda
def test_unpacked_attention_kernel_takes_large_logits(cuda):
  """The max shift: logits of several hundred neither overflow nor lose
  the softmax."""
  q, k, v, do = _qkv_do_4d(cuda, 37, scale=8.0)
  got = attn.attention_unpacked_fwd(q, k, v)
  assert torch.isfinite(got.float()).all()
  torch.testing.assert_close(got.float(),
                             attn.attention_plain(q, k, v).float(),
                             rtol=2**-6, atol=2**-6)
  for g, w in zip(attn.attention_unpacked_bwd(q, k, v, do),
                  attn.attention_bwd_plain(q, k, v, do)):
    assert torch.isfinite(g.float()).all()
    assert (g.float() - w.float()).abs().max().item() <= \
        2.0**-5 * w.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,d", [
    (4, 1, 2, 64), (4, 20, 2, 64), (4, 37, 3, 64), (4, 65, 3, 64),
    (4, 68, 12, 64), (4, 164, 12, 64), (4, 257, 12, 64), (4, 720, 2, 64),
    (4, 1024, 1, 64), (1, MAX_LEN, 1, 64)] + WIDE_CASES + [
        (4, 1024, 1, 256), (1, MAX_LEN, 1, 256)])
def test_unpacked_attention_bwd_kernel_matches_plain(cuda, b, l, h, d):
  """Also at L = 1, at 65 (one key past a 64-row tile), at 720 and 1,024,
  past the 704 the kernel once took, at its own limit (4,096), batch 1,
  at every head dim of WIDE_HEADS, and at 1,024 and 4,096 at head dim
  256."""
  if l == MAX_LEN:
    l = attn._unpacked_bwd_lib()[1]
  q, k, v, do = _qkv_do_4d(cuda, l, b=b, h=h, d=d)
  before = _build.LAUNCHES[attn.UNPACKED_BWD_NAME]
  got = attn.attention_unpacked_bwd(q, k, v, do)
  assert _build.LAUNCHES[attn.UNPACKED_BWD_NAME] == before + 1
  again = attn.attention_unpacked_bwd(q, k, v, do)
  for g, a, w in zip(got, again, attn.attention_bwd_plain(q, k, v, do)):
    assert torch.equal(g, a)  # fixed-order sums: equal bits
    # bf16 outputs of f32 sums over L terms; another order may flip the
    # bf16 rounding of a P or dS input of a product: a few bf16 ulps of
    # the largest output.
    err = (g.float() - w.float()).abs().max().item()
    assert err <= 2.0**-6 * w.float().abs().max().item(), err


@pytest.mark.cuda
def test_unpacked_attention_bwd_kernel_takes_huge_logits(cuda):
  """Logits around ±1e4: every row's probabilities are one-hot after the
  max shift, and nothing overflows. dV = P^T dO is well conditioned there;
  dQ and dK are differences of nearly equal terms, so only finite."""
  q, k, v, do = _qkv_do_4d(cuda, 65, h=3, scale=100.0)
  got = attn.attention_unpacked_bwd(q, k, v, do)
  want = attn.attention_bwd_plain(q, k, v, do)
  for g in got:
    assert torch.isfinite(g.float()).all()
  assert torch.equal(got[2], attn.attention_unpacked_bwd(q, k, v, do)[2])
  err = (got[2].float() - want[2].float()).abs().max().item()
  assert err <= 2.0**-6 * want[2].float().abs().max().item(), err


# Each kernel's wrapper and a function that makes its inputs on a device.
_WRAPPER_CALLS = {
    ln.NAME: (ln.ln_modulate_fwd, lambda d: _ln_args(d, 20, True)),
    ln.BWD_NAME: (ln.ln_modulate_bwd, lambda d: _ln_bwd_args(d, 20, True)),
    attn.NAME: (attn.attention_packed_fwd,
                lambda d: (*_qkv_do(d, 20)[:3], 2)),
    attn.BWD_NAME: (attn.attention_packed_bwd,
                    lambda d: (*_qkv_do(d, 20), 2)),
    fb.MLP_NAME: (fb.fused_mlp_fwd, lambda d: _mlp_args(d, (2, 20))),
    fb.MHA_NAME: (fb.fused_mha_fwd, lambda d: (*_mha_args(d, 3, 20, 12), 12)),
    attn.UNPACKED_NAME: (attn.attention_unpacked_fwd,
                         lambda d: _qkv_do_4d(d, 20)[:3]),
    attn.UNPACKED_BWD_NAME: (attn.attention_unpacked_bwd,
                             lambda d: _qkv_do_4d(d, 20)),
    attn.ABLATE_NAME: (attn.attention_ablate_fwd,
                       lambda d: (*_qkv_do(d, 20)[:3], 2, "prod")),
    fb.MLP_NAME_F32: (fb.fused_mlp_fwd,
                      lambda d: _f32(_mlp_args(d, (2, 20)))),
    fb.MHA_NAME_F32: (fb.fused_mha_fwd,
                      lambda d: _f32(_mha_args(d, 3, 20, 12)) + [12]),
    attn.UNPACKED_NAME_F32: (attn.attention_unpacked_fwd,
                             lambda d: _f32(_qkv_do_4d(d, 20)[:3])),
    attn.UNPACKED_BWD_NAME_F32: (attn.attention_unpacked_bwd,
                                 lambda d: _f32(_qkv_do_4d(d, 20))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_WRAPPER_CALLS))
def test_kernel_launches_from_a_fresh_thread(cuda, name):
  """A thread that has run no CUDA work has no current context (autograd's
  thread, when a kernel's backward is the first thing it runs), and there
  a kernel cannot encode its TMA tensor maps; `_build.launch` binds one.
  The inputs are made here, so the thread runs the wrapper alone."""
  wrapper, make_inputs = _WRAPPER_CALLS[name]
  inputs = make_inputs(cuda)
  torch.cuda.synchronize()
  got = {}

  def body():
    device = torch.cuda.current_device()
    got["out"] = wrapper(*inputs)
    got["same_device"] = torch.cuda.current_device() == device

  worker = threading.Thread(target=body)
  worker.start()
  worker.join(timeout=60)
  assert not worker.is_alive() and "out" in got and got["same_device"]
  torch.cuda.synchronize()
  want = wrapper(*inputs)
  for g, w in zip(*((t,) if torch.is_tensor(t) else t
                    for t in (got["out"], want))):
    assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.cuda
def test_unpacked_attention_autograd_and_refusals(cuda):
  q, k, v, do = _qkv_do_4d(cuda, 20)
  q, k, v = (t.requires_grad_() for t in (q, k, v))
  _build.reset_launches()
  attn.fused_attention(q, k, v).backward(do)
  assert dict(_build.LAUNCHES) == {attn.UNPACKED_NAME: 1,
                                   attn.UNPACKED_BWD_NAME: 1}
  # Head dim 12 runs (on heads padded to 16, `WIDE_HEADS`); 2,056 is past
  # the largest.
  bad = torch.zeros(1, 8, 2, 2056, dtype=torch.bfloat16, device=cuda)
  with pytest.raises(ValueError, match="head dim 2056"):
    attn.attention_unpacked_fwd(bad, bad, bad)
  # K8 takes its limit (4,096: shared memory does not grow with L) and
  # refuses one more.
  assert attn._unpacked_bwd_lib()[1] == 4096
  long = torch.zeros(1, 4097, 1, 64, dtype=torch.bfloat16, device=cuda)
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_unpacked_bwd(long, long, long, long)
  # K7 takes 1,025 keys (K and V streamed) and its limit, K8's 4,096,
  # against its plain version, two launches giving the same bits, and
  # refuses one more.
  assert attn._unpacked_lib()[1](64) == MAX_ATTN_LEN
  for l in (1025, MAX_ATTN_LEN):
    q7, k7, v7 = (_randn((1, l, 2, 64), 80 + i, cuda, torch.bfloat16)
                  for i in range(3))
    got = attn.attention_unpacked_fwd(q7, k7, v7)
    assert torch.equal(got, attn.attention_unpacked_fwd(q7, k7, v7))
    torch.testing.assert_close(got.float(),
                               attn.attention_plain(q7, k7, v7).float(),
                               rtol=2**-7, atol=2**-7)
  past = long[:, :attn._unpacked_lib()[1](64) + 1]
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_unpacked_fwd(past, past, past)
  q = q.detach()
  with pytest.raises(ValueError, match="contiguous"):
    attn.attention_unpacked_fwd(q, q, q.transpose(1, 2))
  # Contiguous but 2 bytes off a 16-byte boundary: TMA cannot read it.
  off = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(
      q.shape)
  with pytest.raises(ValueError, match="16-byte aligned"):
    attn.attention_unpacked_fwd(off, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_fused"])
def test_block_on_the_card_matches_the_cpu(cuda, attn_impl):
  from small_vision_tpu_torch.models import vit
  block = vit.Block(768, None, 12, True, torch.bfloat16, attn_impl)
  gen = torch.Generator().manual_seed(0)
  for name, p in block.named_parameters():
    std = 0.1 if name.endswith("bias") else p.shape[0] ** -0.5
    p.data = torch.randn(p.shape, generator=gen) * std
  block.requires_grad_(False)
  x = _randn((2, 37, 768), 1, "cpu", torch.bfloat16)
  cond = _randn((2, 768), 2, "cpu", torch.bfloat16)
  want = block(x, cond).float()
  got = block.to(cuda)(x.to(cuda), cond.to(cuda)).float().cpu()
  assert (got - want).abs().max().item() <= 3e-2 * want.abs().max().item()


# K9: the tolerance of each arm in bf16 ulps of the largest output (an ulp
# taken as 2^-7 of it): two where p is rounded from f32 scores summed in
# another order, four for bf16exp (the shifted score is rounded to bf16
# before exp), half an ulp for nomm (nothing is summed in another order).
ABLATE_ULPS = {"prod": 2, "nosoftmax": 2, "nomm": 0.5, "bf16exp": 4,
               "exp2": 2, "mulmask": 2, "nomax": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,d", [
    (2, 21, 2, 64), (3, 37, 3, 64),
    # multiples of 16 but not of the 64-row tile
    (2, 80, 2, 64), (2, 144, 3, 64),
    (2, 257, 12, 64)] + WIDE_CASES  # five tiles, the decoder's length
    + [(b, l, 2, d) for b, l, d in LONG_CASES])
@pytest.mark.parametrize("variant", attn.ABLATE_VARIANTS)
def test_attention_ablate_kernel_matches_plain(cuda, variant, b, l, h, d):
  q, k, v = (_randn((b, l, h * d), s, cuda, torch.bfloat16)
             for s in (50, 51, 52))
  _build.reset_launches()
  got = attn.attention_ablate(q, k, v, h, variant)
  assert _build.LAUNCHES == {attn.ABLATE_NAME: 1}
  want = attn.attention_ablate_plain(q, k, v, h, variant)
  assert got.dtype == torch.bfloat16 and got.shape == q.shape
  err = (got.float() - want.float()).abs().max().item()
  top = want.float().abs().max().item()
  assert err <= ABLATE_ULPS[variant] * 2.0**-7 * top, (err, top)
  # No atomics: a second launch gives the same bits.
  assert torch.equal(got, attn.attention_ablate(q, k, v, h, variant))


@pytest.mark.cuda
@pytest.mark.parametrize("l", [80, 144])
def test_attention_ablate_mulmask_ignores_the_tiles_zero_keys(cuda, l):
  """Scores all near -300 (every row's max below -140): were the zero keys
  that the 64-row tile holds past lp = L to join mulmask's max, every
  exp(S - 0) would underflow to 0."""
  b, h = 2, 2
  q = _randn((b, l, h * 64), 53, cuda, torch.float32).abs() * 60
  k = -_randn((b, l, h * 64), 54, cuda, torch.float32).abs()
  v = _randn((b, l, h * 64), 55, cuda, torch.bfloat16)
  q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
  got = attn.attention_ablate(q, k, v, h, "mulmask")
  want = attn.attention_ablate_plain(q, k, v, h, "mulmask")
  assert torch.isfinite(want.float()).all()
  err = (got.float() - want.float()).abs().max().item()
  assert err <= ABLATE_ULPS["mulmask"] * 2.0**-7 * want.float().abs().max(
      ).item(), err


@pytest.mark.cuda
def test_attention_ablate_refuses_what_the_kernel_does_not_take(cuda):
  q = torch.zeros(1, 20, 128, dtype=torch.bfloat16, device=cuda)
  with pytest.raises(ValueError, match="unknown variant"):
    attn.attention_ablate(q, q, q, 2, "fast")
  with pytest.raises(ValueError, match="bfloat16"):
    attn.attention_ablate(q.float(), q.float(), q.float(), 2, "prod")
  with pytest.raises(ValueError, match="width 128 is not num_heads 3"):
    attn.attention_ablate(q, q, q, 3, "prod")
  # L up to 4,096 (the runs: test_attention_ablate_kernel_matches_plain);
  # one past it is refused.
  assert attn._ablate_lib()[1](64) == MAX_ATTN_LEN
  long = torch.zeros(1, MAX_ATTN_LEN + 1, 128, dtype=torch.bfloat16,
                     device=cuda)
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_ablate(long, long, long, 2, "prod")


@pytest.mark.cuda
def test_train_iterator_onto_the_card_gives_the_cpu_bits(cuda, tmp_path):
  """The input pipeline's copy to the card (pinned host memory,
  `non_blocking=True`, 4 workers, 2 batches ahead) gives the bytes of the
  same batches on the CPU, over an epoch boundary."""
  from small_vision_tpu_torch.data import arrays, core, pipeline
  rng = np.random.default_rng(0)
  arrays.write_arrays(str(tmp_path), rng.integers(0, 256, (40, 48, 40, 3),
                                                  dtype=np.uint8),
                      rng.integers(0, 1000, (40,)))
  pp = 'inception_crop(32)|flip_lr|value_range(-1, 1)|keep("image")'

  def take(device, n=5):
    it = pipeline.TrainIterator(core.get("arrays", root=str(tmp_path)), pp,
                                16, device=device, seed=1, num_workers=4)
    gen = iter(it)
    out = [next(gen) for _ in range(n)]
    gen.close()
    return out
  for card, host in zip(take(cuda), take("cpu")):
    assert set(card) == set(host) == {"image", "label", "_id"}
    for k in host:
      assert card[k].is_cuda and torch.equal(card[k].cpu(), host[k])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(17, 64, 8), (300, 768, 3072),
                                   (257, 3072, 768)])
def test_int8_dot_on_the_card_matches_the_plain_integer_version(cuda, m, k,
                                                                 n):
  """`torch._int_mm` on the card against the CPU's exact int64 product:
  the quantized operands and scales equal, the int32 accumulator equal bit
  for bit, the bf16 output within one bf16 ulp of the largest, and the
  straight-through gradients within two bf16 roundings (2^-7) of their
  largest (the card's bf16 products sum in another order)."""
  from small_vision_tpu_torch.ops import quant
  x = _randn((m, k), 60, "cpu", torch.bfloat16)
  w = _randn((k, n), 61, "cpu", torch.bfloat16, k ** -0.5)
  ops = quant.quantized_operands(x, w)
  card_ops = quant.quantized_operands(x.to(cuda), w.to(cuda))
  for got, want in zip(card_ops, ops):
    assert torch.equal(got.cpu(), want)
  acc = quant.int_matmul(card_ops[0], card_ops[2])
  assert acc.dtype == torch.int32 and acc.is_cuda
  assert torch.equal(acc.cpu(), quant.int_matmul(ops[0], ops[2]))
  g = _randn((m, n), 62, "cpu", torch.bfloat16)
  outs = {}
  for dev in ("cpu", cuda):
    xd, wd = (t.to(dev).detach().requires_grad_() for t in (x, w))
    y = quant.int8_dot(xd, wd)
    y.backward(g.to(dev))
    outs[str(dev)] = [t.float().cpu() for t in (y.detach(), xd.grad, wd.grad)]
  (y_cpu, dx_cpu, dw_cpu), (y_gpu, dx_gpu, dw_gpu) = outs["cpu"], outs["cuda"]
  top = y_cpu.abs().max().item()
  assert (y_gpu - y_cpu).abs().max().item() <= 2.0**-7 * top
  for got, want in ((dx_gpu, dx_cpu), (dw_gpu, dw_cpu)):
    assert (got - want).abs().max().item() <= 2.0**-7 * want.abs().max(
        ).item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,what", [
    (16, 64, 8, "more than 16 rows"), (32, 60, 8, "multiples of 8"),
    (32, 64, 12, "multiples of 8")])
def test_int8_dot_refuses_what_int_mm_does_not_take(cuda, m, k, n, what):
  """No fallback: a shape `torch._int_mm` refuses raises, naming it."""
  from small_vision_tpu_torch.ops import quant
  x = _randn((m, k), 63, cuda, torch.bfloat16)
  w = _randn((k, n), 64, cuda, torch.bfloat16)
  with pytest.raises(ValueError, match=rf"\({m}, {k}\) @ \({k}, {n}\).*"
                                       f"{what}"):
    quant.int8_dot(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [68, 164, 257, 260])
def test_attention_kernels_at_16_heads_of_umd_l(cuda, l):
  """K3 and K4 at UMD-L/2's width (1,024: 16 heads of 64) and its lengths,
  two launches of each giving the same bits, against the plain versions
  with the bounds of the 2-head tests above."""
  q, k, v, do = _qkv_do(cuda, l, b=3, h=16, seed=40)
  got = attn.attention_packed_fwd(q, k, v, 16)
  assert torch.equal(got, attn.attention_packed_fwd(q, k, v, 16))
  torch.testing.assert_close(
      got.float(), attn.attention_packed_plain(q, k, v, 16).float(),
      rtol=2**-7, atol=2**-7)
  grads = attn.attention_packed_bwd(q, k, v, do, 16)
  again = attn.attention_packed_bwd(q, k, v, do, 16)
  want = attn.attention_packed_bwd_plain(q, k, v, do, 16)
  for g, a, w in zip(grads, again, want):
    assert torch.equal(g, a)
    err = (g.float() - w.float()).abs().max().item()
    assert err <= 2.0**-6 * w.float().abs().max().item(), err


@pytest.mark.cuda
def test_vae_on_the_card_matches_the_cpu(cuda):
  """The port's AutoencoderKL (cuDNN convolutions, `F.group_norm`, the
  mid-block attention) at channels (32, 64, 64, 64) on two 64x64 images:
  `encode_moments` and `decode` on the card against the CPU, f32 with
  TF32 off, within 1e-5 of each output's largest magnitude (two summation
  orders of f32 through about 30 layers)."""
  from small_vision_tpu_torch.models import vae

  params, encode, decode = vae.load_vae(
      device="cpu", seed=3, block_out_channels=(32, 64, 64, 64))
  with torch.device("meta"):
    model = vae.AutoencoderKL((32, 64, 64, 64))
  model = model.to_empty(device="cpu").requires_grad_(False)
  model.load_state_dict(params)
  x = _randn((2, 64, 64, 3), 50, "cpu", torch.float32, 0.5).clamp(-1, 1)
  z = _randn((2, 8, 8, 4), 51, "cpu", torch.float32)
  tf32 = (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    outs = {}
    for dev in ("cpu", cuda):
      m = model.to(dev)
      with torch.no_grad():
        outs[str(dev)] = [t.cpu() for t in (*m.encode_moments(x.to(dev)),
                                            m.decode(z.to(dev)))]
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
  for g, w in zip(outs["cuda"], outs["cpu"]):
    err = (g - w).abs().max().item()
    assert err <= 1e-5 * w.abs().max().item(), err


# Every width of the ViT and UMD variant tables, the quick configs' 32 and
# 64, and the edges of K2's teams (96, 160: masked vectors; 288; 1,056:
# the first width of two warps a row; 2,048: the widest).
LN_WIDTHS = (32, 64, 96, 160, 192, 288, 384, 512, 1056, 1280, 1408, 1664,
             2048)


@pytest.mark.cuda
@pytest.mark.parametrize("d", LN_WIDTHS)
@pytest.mark.parametrize("modulate", [False, True])
def test_ln_kernels_at_every_width(cuda, d, modulate):
  """K1 and K2 at width d against their plain versions, with the bounds of
  the width-768 tests above (L = 67: a ragged last step of every team
  size); K2 three launches in a row giving the same bits."""
  args = _ln_args(cuda, 67, modulate, b=5, d=d, seed=d)
  got = ln.ln_modulate(*args).float()
  want = ln.ln_modulate_plain(*args).float()
  assert torch.all((got - want).abs() <= 2.0**-7 * want.abs() + 1e-5)
  bargs = _ln_bwd_args(cuda, 67, modulate, b=5, d=d, seed=d)
  first = ln.ln_modulate_bwd(*bargs)
  for _ in range(2):
    for a, again in zip(first, ln.ln_modulate_bwd(*bargs)):
      assert (a is None and again is None) or torch.equal(a, again)
  want = ln.ln_modulate_bwd_plain(*bargs)
  dx, dx_want = first[0].float(), want[0].float()
  assert torch.all((dx - dx_want).abs() <= 2.0**-7 * dx_want.abs() + 1e-3)
  for g, w in zip(first[1:], want[1:]):
    if w is not None:
      torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 384, 1664])
def test_ln_bwd_kernel_at_new_widths_on_two_streams(cuda, d):
  """Two K2 launches in flight at once on two streams give the bits of the
  same launches in turn, at narrow, team-of-16 and two-warp widths."""
  cases = [_ln_bwd_args(cuda, 65, True, b=40, d=d),
           _ln_bwd_args(cuda, 33, False, b=24, d=d, seed=9)]
  in_turn = [ln.ln_modulate_bwd(*args) for args in cases]
  streams = [torch.cuda.Stream(cuda) for _ in cases]
  start = torch.cuda.current_stream(cuda)
  got = []
  for stream, args in zip(streams, cases):
    stream.wait_stream(start)
    with torch.cuda.stream(stream):
      got.append(ln.ln_modulate_bwd(*args))
  for stream in streams:
    start.wait_stream(stream)
  torch.cuda.synchronize(cuda)
  for want, outs in zip(in_turn, got):
    for w, g in zip(want, outs):
      assert (w is None and g is None) or torch.equal(w, g)


HEAD_DIMS = (8, 16, 24, 40, 72, 80, 96, 104, 120, 128, 136, 192, 200, 248,
             256,
             # Not multiples of 8: on heads zero-padded to 8, 8, 16, 16, 256.
             1, 4, 12, 13, 250)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("l", [20, 68, 257])
def test_attention_kernels_at_every_head_dim(cuda, hd, l):
  """K3 and K4 at head dim hd (3 heads, so that a narrow head's padded
  columns would read its neighbour's) against the plain versions with the
  bounds of the head-dim-64 tests above; two launches of each give the
  same bits."""
  q, k, v, do = (_randn((2, l, 3 * hd), 60 + i, cuda, torch.bfloat16)
                 for i in range(4))
  got = attn.attention_packed_fwd(q, k, v, 3)
  assert torch.equal(got, attn.attention_packed_fwd(q, k, v, 3))
  torch.testing.assert_close(
      got.float(), attn.attention_packed_plain(q, k, v, 3).float(),
      rtol=2**-7, atol=2**-7)
  grads = attn.attention_packed_bwd(q, k, v, do, 3)
  again = attn.attention_packed_bwd(q, k, v, do, 3)
  want = attn.attention_packed_bwd_plain(q, k, v, do, 3)
  for g, a, w in zip(grads, again, want):
    assert torch.equal(g, a)
    err = (g.float() - w.float()).abs().max().item()
    assert err <= 2.0**-6 * w.float().abs().max().item(), err


# Head dim 128 (two 64-column tiles a head): the last length whose K and V
# stay resident (384), one past it, and the long lengths up to 4,096.
HD128_LENS = [384, 385, 1024, 1025, 1369, MAX_ATTN_LEN]


# Head dim 256 (four tiles a head, streamed at every length): one key, the
# edges of a 64-row tile, the long lengths and the limit.
HD256_LENS = [1, 64, 65, 1024, 1025, MAX_ATTN_LEN]


def _packed_at_limits(cuda, l, hd):
  q, k, v = (_randn((1, l, 2 * hd), 70 + i, cuda, torch.bfloat16)
             for i in range(3))
  got = attn.attention_packed_fwd(q, k, v, 2)
  assert torch.equal(got, attn.attention_packed_fwd(q, k, v, 2))
  torch.testing.assert_close(
      got.float(), attn.attention_packed_plain(q, k, v, 2).float(),
      rtol=2**-7, atol=2**-7)
  assert attn._lib()[1](hd) == MAX_ATTN_LEN
  long = torch.zeros(1, MAX_ATTN_LEN + 1, hd, dtype=torch.bfloat16,
                     device=cuda)
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_packed_fwd(long, long, long, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("l", HD128_LENS)
def test_attention_kernels_at_head_dim_128_limits(cuda, l):
  """K3 at head dim 128 around its resident length and up to the common
  limit, 4,096, against the plain version, two launches giving the same
  bits; one past 4,096 refused."""
  _packed_at_limits(cuda, l, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("l", HD256_LENS)
def test_attention_kernels_at_head_dim_256_limits(cuda, l):
  """K3 and K4 at head dim 256 from one key to the common limit, 4,096,
  against the plain versions, two launches of each giving the same bits;
  one past 4,096 refused."""
  _packed_at_limits(cuda, l, 256)
  q, k, v, do = (_randn((1, l, 2 * 256), 80 + i, cuda, torch.bfloat16)
                 for i in range(4))
  grads = attn.attention_packed_bwd(q, k, v, do, 2)
  again = attn.attention_packed_bwd(q, k, v, do, 2)
  want = attn.attention_packed_bwd_plain(q, k, v, do, 2)
  # As test_attention_bwd_kernel_matches_plain_at_the_edges: dq and dk
  # vanish at L = 1, so each output's scale is floored at 1e-3 of the
  # largest of the three.
  top = max(w.float().abs().max().item() for w in want)
  for g, a, w in zip(grads, again, want):
    assert torch.equal(g, a)
    err = (g.float() - w.float()).abs().max().item()
    assert err <= 2.0**-6 * max(w.float().abs().max().item(), 1e-3 * top)


@pytest.mark.cuda
@pytest.mark.parametrize("l", HD128_LENS)
def test_max_shift_kernels_at_head_dim_128_limits(cuda, l):
  """K6, K7 and K9 (its production arm) at head dim 128 around their
  resident length and up to 4,096, the limit they share with K8, against
  their plain versions, two launches of each giving the same bits; one
  past 4,096 refused by each."""
  _max_shift_at_limits(cuda, l, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("l", HD256_LENS)
def test_max_shift_kernels_at_head_dim_256_limits(cuda, l):
  """K6, K7 and K9's production arm at head dim 256 from one key to 4,096,
  as at 128."""
  _max_shift_at_limits(cuda, l, 256)


def _max_shift_at_limits(cuda, l, hd):
  assert (attn._unpacked_lib()[1](hd) == fb.fused_mha_max_len(hd)
          == attn._ablate_lib()[1](hd) == attn._unpacked_bwd_lib()[1]
          == MAX_ATTN_LEN)
  q, k, v = (_randn((1, l, 2, hd), 95 + i, cuda, torch.bfloat16)
             for i in range(3))
  got = attn.attention_unpacked_fwd(q, k, v)
  assert torch.equal(got, attn.attention_unpacked_fwd(q, k, v))
  torch.testing.assert_close(got.float(),
                             attn.attention_plain(q, k, v).float(),
                             rtol=2**-7, atol=2**-7)
  q3, k3, v3 = (t.reshape(1, l, 2 * hd) for t in (q, k, v))
  got = attn.attention_ablate_fwd(q3, k3, v3, 2, "exp2")
  assert torch.equal(got, attn.attention_ablate_fwd(q3, k3, v3, 2, "exp2"))
  _assert_close_to_max(got, attn.attention_ablate_plain(q3, k3, v3, 2,
                                                        "exp2"), 2)
  args = _mha_args(cuda, 1, l, 2, hd=hd)
  got = fb.fused_mha_fwd(*args, 2)
  assert torch.equal(got, fb.fused_mha_fwd(*args, 2))
  _assert_close_to_max(got, fb.fused_mha_plain(*args, 2), 2)
  long = torch.zeros(1, MAX_ATTN_LEN + 1, 2, hd, dtype=torch.bfloat16,
                     device=cuda)
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_unpacked_fwd(long, long, long)
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_ablate_fwd(*(long.reshape(1, -1, 2 * hd),) * 3, 2,
                              "exp2")
  x = torch.zeros(1, MAX_ATTN_LEN + 1, 2 * hd, dtype=torch.bfloat16,
                  device=cuda)
  w = torch.zeros(2 * hd, 2 * hd, dtype=torch.bfloat16, device=cuda)
  bias = torch.zeros(2 * hd, dtype=torch.bfloat16, device=cuda)
  with pytest.raises(ValueError, match="sequence length"):
    fb.fused_mha_fwd(x, *(w, bias) * 4, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,heads", [(2056, 1), (0, 8)])
def test_max_shift_wrappers_refuse_head_dims_they_do_not_take(cuda, hd,
                                                              heads):
  """A head dim over 2,048, or of 0, makes each of K6-K9's wrappers raise on
  the card: no plain route, no CPU. (Head dims that are not multiples of 8
  run: `WIDE_HEADS`, `HEAD_DIMS`.)"""
  width = heads * hd
  t4 = torch.zeros(1, 20, heads, hd, dtype=torch.bfloat16, device=cuda)
  t3 = t4.reshape(1, 20, width)
  w = torch.zeros(width, width, dtype=torch.bfloat16, device=cuda)
  bias = torch.zeros(width, dtype=torch.bfloat16, device=cuda)
  _build.reset_launches()
  for fn in (lambda: fb.fused_mha(t3, *(w, bias) * 4, heads),
             lambda: attn.fused_attention(t4, t4, t4),
             lambda: attn.attention_unpacked_bwd(t4, t4, t4, t4),
             lambda: attn.attention_ablate(t3, t3, t3, heads, "prod")):
    with pytest.raises(ValueError, match=f"head dim {hd}"):
      fn()
  assert not _build.LAUNCHES


@pytest.mark.cuda
def test_wrappers_name_the_shapes_the_kernels_refuse(cuda):
  """A head dim of 2,056 and a width past MAX_WIDTH (8,224) raise the
  named error on the card: there is no plain route for a CUDA tensor."""
  q = torch.zeros(1, 8, 2 * 2056, dtype=torch.bfloat16, device=cuda,
                  requires_grad=True)
  for fn in (lambda: attn.attention_packed(q, q, q, 2),
             lambda: attn.attention_packed_bwd(q, q, q, q, 2)):
    with pytest.raises(ValueError, match="head dim 2056"):
      fn()
  wide = ln.MAX_WIDTH + 32
  x, gamma, beta, shift, scale = _ln_args(cuda, 4, True, b=2, d=wide)
  with pytest.raises(ValueError, match=f"width {wide}"):
    ln.ln_modulate(x, gamma, beta, shift, scale)
  xg = x.requires_grad_()
  with pytest.raises(ValueError, match=f"width {wide}"):
    ln.ln_modulate(xg, gamma, beta, shift, scale)


# Head dims past 256, five to 32 tiles a head (S and dP summed over the
# tiles in a loop, the outputs' columns split across CTAs, every operand
# through a ring of tile pairs): a ragged fifth tile (264), `heads=2` and
# `heads=1` at width 768 (384, 768), a ragged ninth (520), UMD-L's width
# in one head (1,024), ViT-G's (1,664) and the limit (2,048).
WIDER_HEAD_DIMS = (264, 384, 520, 768, 1024, 1664, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", WIDER_HEAD_DIMS)
@pytest.mark.parametrize("l", [20, 65])
def test_attention_kernels_past_head_dim_256(cuda, hd, l):
  """K3, K4, K6, K7, K8 and K9's prod and exp2 arms at head dim hd (2
  heads) against their plain versions with the bounds of their tests at
  head dim 64; two launches of each give the same bits."""
  q, k, v, do = (_randn((2, l, 2 * hd), 110 + i, cuda, torch.bfloat16)
                 for i in range(4))
  got = attn.attention_packed_fwd(q, k, v, 2)
  assert torch.equal(got, attn.attention_packed_fwd(q, k, v, 2))
  torch.testing.assert_close(
      got.float(), attn.attention_packed_plain(q, k, v, 2).float(),
      rtol=2**-7, atol=2**-7)
  q4, k4, v4, do4 = (t.view(2, l, 2, hd) for t in (q, k, v, do))
  got = attn.attention_unpacked_fwd(q4, k4, v4)
  assert torch.equal(got, attn.attention_unpacked_fwd(q4, k4, v4))
  torch.testing.assert_close(got.float(),
                             attn.attention_plain(q4, k4, v4).float(),
                             rtol=2**-7, atol=2**-7)
  for bwd, plain, args in (
      (attn.attention_packed_bwd, attn.attention_packed_bwd_plain,
       (q, k, v, do, 2)),
      (attn.attention_unpacked_bwd, attn.attention_bwd_plain,
       (q4, k4, v4, do4))):
    grads, again = bwd(*args), bwd(*args)
    for g, a, w in zip(grads, again, plain(*args)):
      assert torch.equal(g, a)
      err = (g.float() - w.float()).abs().max().item()
      assert err <= 2.0**-6 * w.float().abs().max().item(), err
  for variant in ("prod", "exp2"):
    got = attn.attention_ablate_fwd(q, k, v, 2, variant)
    assert torch.equal(got, attn.attention_ablate_fwd(q, k, v, 2, variant))
    want = attn.attention_ablate_plain(q, k, v, 2, variant).float()
    err = (got.float() - want).abs().max().item()
    assert err <= ABLATE_ULPS[variant] * 2.0**-7 * want.abs().max().item()
  args = _mha_args(cuda, 2, l, 2, hd=hd)
  got = fb.fused_mha_fwd(*args, 2)
  assert torch.equal(got, fb.fused_mha_fwd(*args, 2))
  _assert_close_to_max(got, fb.fused_mha_plain(*args, 2), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", attn.ABLATE_VARIANTS)
def test_attention_ablate_arms_past_head_dim_256(cuda, variant):
  """Each of K9's seven arms at head dim 520 (nine tiles, the last ragged;
  three heads, L = 65) against its plain version, in ABLATE_ULPS."""
  q, k, v = (_randn((2, 65, 3 * 520), 120 + i, cuda, torch.bfloat16)
             for i in range(3))
  got = attn.attention_ablate_fwd(q, k, v, 3, variant)
  assert torch.equal(got, attn.attention_ablate_fwd(q, k, v, 3, variant))
  want = attn.attention_ablate_plain(q, k, v, 3, variant).float()
  err = (got.float() - want).abs().max().item()
  assert err <= ABLATE_ULPS[variant] * 2.0**-7 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [1024, 2048])
@pytest.mark.parametrize("l", HD256_LENS)
def test_attention_kernels_at_wide_head_dim_limits(cuda, l, hd):
  """Every attention kernel at head dims 1,024 and 2,048 from one key to
  the common limit, 4,096, against its plain version, two launches giving
  the same bits, and one past 4,096 refused (as at head dim 256)."""
  _packed_at_limits(cuda, l, hd)
  _max_shift_at_limits(cuda, l, hd)
  q, k, v, do = (_randn((1, l, 2 * hd), 130 + i, cuda, torch.bfloat16)
                 for i in range(4))
  q4, k4, v4, do4 = (t.view(1, l, 2, hd) for t in (q, k, v, do))
  for bwd, plain, args in (
      (attn.attention_packed_bwd, attn.attention_packed_bwd_plain,
       (q, k, v, do, 2)),
      (attn.attention_unpacked_bwd, attn.attention_bwd_plain,
       (q4, k4, v4, do4))):
    grads, again, want = bwd(*args), bwd(*args), plain(*args)
    # dq and dk vanish at L = 1: each output's scale is floored at 1e-3 of
    # the largest of the three (test_attention_kernels_at_head_dim_256_
    # limits).
    top = max(w.float().abs().max().item() for w in want)
    for g, a, w in zip(grads, again, want):
      assert torch.equal(g, a)
      err = (g.float() - w.float()).abs().max().item()
      assert err <= 2.0**-6 * max(w.float().abs().max().item(), 1e-3 * top)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [264, 768])
def test_wide_head_chunks_give_the_same_bits(cuda, hd):
  """Past head dim 256 each CTA computes its chunk of the outputs' columns
  from the whole head's scores: storing 1, 2 or 3 column tiles a CTA
  (`chunk_tiles`) instead of 4 (K3, K7; K4's and K8's dQ) and 1 instead of
  2 (their dK and dV) gives the same bits."""
  q, k, v, do = (_randn((2, 130, 2 * hd), 140 + i, cuda, torch.bfloat16)
                 for i in range(4))
  q4, k4, v4, do4 = (t.view(2, 130, 2, hd) for t in (q, k, v, do))
  o3 = attn.attention_packed_fwd(q, k, v, 2)
  o7 = attn.attention_unpacked_fwd(q4, k4, v4)
  g4 = attn.attention_packed_bwd(q, k, v, do, 2)
  g8 = attn.attention_unpacked_bwd(q4, k4, v4, do4)
  for ct in (1, 2, 3):
    assert torch.equal(o3, attn.attention_packed_fwd(q, k, v, 2,
                                                     chunk_tiles=ct))
    assert torch.equal(o7, attn.attention_unpacked_fwd(q4, k4, v4,
                                                       chunk_tiles=ct))
    for a, b in zip(g4, attn.attention_packed_bwd(q, k, v, do, 2,
                                                  chunk_tiles=ct)):
      assert torch.equal(a, b)
    for a, b in zip(g8, attn.attention_unpacked_bwd(q4, k4, v4, do4,
                                                    chunk_tiles=ct)):
      assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K1-K4 in f32 (`dtype_mm="float32"`), and K1/K2 at every width.
# ---------------------------------------------------------------------------


def _ln_args_dtype(device, l, modulate, b, d, dtype, seed=0):
  """K1's and K2's inputs in `dtype` (x, shift, scale, dy), with K1's
  statistics: (forward args, backward args)."""
  x = _randn((b, l, d), seed, device, dtype, 2.0, 0.5)
  gamma = _randn((d,), seed + 1, device, torch.float32, 0.1, 1.0)
  beta = _randn((d,), seed + 2, device, torch.float32, 0.1)
  shift = scale = None
  if modulate:
    shift, scale = _randn((b, 6 * d), seed + 3, device, dtype,
                          0.3).chunk(6, dim=-1)[:2]
  xf = x.float()
  mean = xf.mean(-1)
  rstd = torch.rsqrt((xf - mean[..., None]).square().mean(-1) + 1e-6)
  dy = _randn((b, l, d), seed + 4, device, dtype)
  return ((x, gamma, beta, shift, scale),
          (x, dy, mean, rstd, gamma, beta, scale))


def _hold_ln(fwd, bwd, dtype):
  """K1 and K2 on `fwd` / `bwd` against their plain versions: K1 two
  launches and K2 three giving the same bits. f32: y and dx within 1e-5
  of their largest value (f32 sums of a row in another order), dgamma,
  dbeta, dshift and dscale within 1e-4 of theirs (f32 sums over B*L rows
  in another order and grouping). bf16: the bounds of
  test_ln_kernels_at_every_width (one bf16 ulp of y and dx)."""
  got = ln.ln_modulate_fwd(*fwd)
  assert torch.equal(got, ln.ln_modulate_fwd(*fwd))
  want = ln.ln_modulate_plain(*fwd).float()
  got = got.float()
  if dtype == torch.float32:
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
  else:
    assert torch.all((got - want).abs() <= 2.0**-7 * want.abs() + 1e-5)
  first = ln.ln_modulate_bwd(*bwd)
  for _ in range(2):
    for a, again in zip(first, ln.ln_modulate_bwd(*bwd)):
      assert (a is None and again is None) or torch.equal(a, again)
  want = ln.ln_modulate_bwd_plain(*bwd)
  dx, dx_want = first[0].float(), want[0].float()
  assert first[0].dtype == dtype
  if dtype == torch.float32:
    assert (dx - dx_want).abs().max() <= 1e-5 * dx_want.abs().max()
  else:
    assert torch.all((dx - dx_want).abs() <= 2.0**-7 * dx_want.abs() + 1e-3)
  for g, w in zip(first[1:], want[1:]):
    if w is not None:
      assert g.dtype == torch.float32
      torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("l", [68, 257, 260])
@pytest.mark.parametrize("modulate", [False, True])
def test_f32_ln_kernels_match_plain(cuda, l, modulate):
  """K1 and K2 in f32 at width 768 (the main path's) at the training and
  sampler lengths, counted under their f32 names (`_hold_ln`)."""
  fwd, bwd = _ln_args_dtype(cuda, l, modulate, 8, 768, torch.float32)
  _build.reset_launches()
  _hold_ln(fwd, bwd, torch.float32)
  assert dict(_build.LAUNCHES) == {ln.NAME_F32: 2, ln.BWD_NAME_F32: 3}


# Widths the bf16 instances do not take (a multiple of 32 up to 2,048):
# one column, the narrow model's 36, 100 (4-element vectors), 1,000 (8,
# not a multiple of 32), 2,080 (two warps a row), 4,096 and 8,192 (the
# limit, eight warps a row); and 768 in f32.
NEW_LN_WIDTHS = (1, 36, 100, 1000, 2080, 4096, 8192)


@pytest.mark.cuda
@pytest.mark.parametrize("d", NEW_LN_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("modulate", [False, True])
def test_ln_kernels_at_new_widths(cuda, d, dtype, modulate):
  """K1 and K2 at width d in bf16 and f32 (`_hold_ln`), L = 67 at batch
  5 (a ragged last step of every team)."""
  fwd, bwd = _ln_args_dtype(cuda, 67, modulate, 5, d, dtype, seed=d)
  _hold_ln(fwd, bwd, dtype)


@pytest.mark.cuda
def test_ln_kernels_take_unaligned_rows(cuda):
  """bf16 at width 768 whose x starts 2 bytes off a 16-byte boundary, and
  modulation rows 770 elements apart: the any-width instances, with
  2-element (4-byte) and 1-element loads, against the plain versions."""
  fwd, bwd = _ln_args_dtype(cuda, 20, True, 3, 768, torch.bfloat16)
  buf = torch.empty(fwd[0].numel() + 1, dtype=torch.bfloat16, device=cuda)
  x = buf[1:].view(fwd[0].shape)
  x.copy_(fwd[0])
  mods = _randn((3, 770 * 2), 9, cuda, torch.bfloat16, 0.3).view(3, 1540)
  shift, scale = mods[:, :768], mods[:, 770:770 + 768]
  assert ln.load_vector(x, 1540, x) == 1 and ln.load_vector(
      fwd[0], 1540, fwd[0], shift, scale) == 2
  _hold_ln((x, *fwd[1:3], shift, scale), (x, *bwd[1:6], scale),
           torch.bfloat16)


@pytest.mark.cuda
def test_ln_bwd_f32_on_two_streams_matches_launches_in_turn(cuda):
  """Two f32 K2 launches in flight at once on two streams give the bits
  of the same launches in turn (the any-width instance's tickets are the
  launch's own, as the bf16 one's)."""
  cases = [_ln_args_dtype(cuda, 257, True, 40, 768, torch.float32)[1],
           _ln_args_dtype(cuda, 68, False, 24, 36, torch.float32, 9)[1]]
  in_turn = [ln.ln_modulate_bwd(*args) for args in cases]
  streams = [torch.cuda.Stream(cuda) for _ in cases]
  start = torch.cuda.current_stream(cuda)
  got = []
  for stream, args in zip(streams, cases):
    stream.wait_stream(start)
    with torch.cuda.stream(stream):
      got.append(ln.ln_modulate_bwd(*args))
  for stream in streams:
    start.wait_stream(stream)
  torch.cuda.synchronize(cuda)
  for want, outs in zip(in_turn, got):
    for w, g in zip(want, outs):
      assert (w is None and g is None) or torch.equal(w, g)


# K3 and K4 in f32: (batch, length, heads, head dim). The main path's 12
# heads of 64 at a training length, the tile edges (1, 63, 65), head dims
# 12 (`heads=32`), 192, 768 (`heads=1`) and 2,048 (the limit), one head
# dim of 1, and the length limit 4,096.
F32_ATTN_CASES = [(4, 257, 12, 64), (2, 1, 3, 64), (3, 63, 2, 64),
                  (3, 65, 2, 64), (2, 68, 32, 12), (2, 164, 4, 192),
                  (1, 257, 1, 768), (1, 65, 1, 2048), (2, 20, 2, 1),
                  (1, 4096, 1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,heads,hd", F32_ATTN_CASES)
def test_f32_attention_kernels_match_plain(cuda, b, l, heads, hd):
  """K3's and K4's f32 instances against the plain versions: o, dq, dk
  and dv within 1e-4 of each output's largest value (f32 sums over L and
  D in another order, through exp2 of scores of a few units), two
  launches giving the same bits, counted under the f32 names."""
  q, k, v, do = (_randn((b, l, heads * hd), 90 + i, cuda, torch.float32)
                 for i in range(4))
  _build.reset_launches()
  got = attn.attention_packed_fwd(q, k, v, heads)
  assert torch.equal(got, attn.attention_packed_fwd(q, k, v, heads))
  want = attn.attention_packed_plain(q, k, v, heads)
  assert (got - want).abs().max() <= 1e-4 * want.abs().max()
  grads = attn.attention_packed_bwd(q, k, v, do, heads)
  again = attn.attention_packed_bwd(q, k, v, do, heads)
  want = attn.attention_packed_bwd_plain(q, k, v, do, heads)
  top = max(w.abs().max().item() for w in want)
  for g, a, w in zip(grads, again, want):
    assert g.dtype == torch.float32 and torch.equal(g, a)
    # dq and dk vanish at L = 1 (one key: dS = e (dP - c) with c = dP
    # but for roundings, which leave f32 round-off of dP, up to ~25 for
    # unit inputs at D = 64, in dq and dk), so each output's scale is
    # floored at 1e-2 of the largest of the three.
    err = (g - w).abs().max().item()
    assert err <= 1e-4 * max(w.abs().max().item(), 1e-2 * top), err
  assert dict(_build.LAUNCHES) == {attn.NAME_F32: 2, attn.BWD_NAME_F32: 2}


# K4's and K8's f32 backwards run their products 3xTF32 on the tensor
# cores (csrc/sm90_f32x3_attention_bwd.cuh): the main path's 12 heads of
# 64 at a training length, `heads=32`'s 12 at L = 68 and `heads=1`'s 768.
F64_ATTN_CASES = [(4, 257, 12, 64), (2, 68, 32, 12), (1, 257, 1, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,heads,hd", F64_ATTN_CASES)
def test_f32_attention_backwards_match_f64(cuda, b, l, heads, hd):
  """K4's and K8's f32 instances within 1e-5 of each output's largest
  value (floored at 1e-2 of the largest of the three) of the float64 plain
  versions: at these unit-scale inputs 3xTF32 products (each operand to
  2^-22) land as close to float64 as f32 FMA sums do."""
  q, k, v, do = (_randn((b, l, heads * hd), 110 + i, cuda, torch.float32)
                 for i in range(4))
  as4 = lambda t: t.view(b, l, heads, hd)
  f64 = [t.double() for t in (q, k, v, do)]
  for got, want in (
      (attn.attention_packed_bwd(q, k, v, do, heads),
       attn.attention_packed_bwd_plain(*f64, heads)),
      (attn.attention_unpacked_bwd(*map(as4, (q, k, v, do))),
       attn.attention_bwd_plain(*map(as4, f64)))):
    top = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
      err = (g.double() - w.view(g.shape)).abs().max().item()
      assert err <= 1e-5 * max(w.abs().max().item(), 1e-2 * top), err


# K3's and K7's f32 forwards also run their products on the TF32 tensor
# cores (csrc/sm90_f32x3_attention.cuh): F64_ATTN_CASES and head dim 13,
# which takes scalar loads.
F64_FWD_CASES = F64_ATTN_CASES + [(2, 37, 3, 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,heads,hd", F64_FWD_CASES)
def test_f32_attention_forwards_match_f64(cuda, b, l, heads, hd):
  """K3's and K7's f32 instances within 1e-5 of the output's largest value
  of the float64 plain versions: their scores are a pair finer than f32,
  their e V product 3xTF32."""
  q, k, v = (_randn((b, l, heads * hd), 130 + i, cuda, torch.float32)
             for i in range(3))
  as4 = lambda t: t.view(b, l, heads, hd)
  f64 = [t.double() for t in (q, k, v)]
  for got, want in (
      (attn.attention_packed_fwd(q, k, v, heads),
       attn.attention_packed_plain(*f64, heads)),
      (attn.attention_unpacked_fwd(*map(as4, (q, k, v))),
       attn.attention_plain(*map(as4, f64)))):
    assert got.dtype == torch.float32 and want.dtype == torch.float64
    err = (got.double() - want.reshape(got.shape)).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


# One shape at each key-chunk width class of the f32 kernels (N = 40, 56,
# 64, 8) and a head dim that takes scalar loads (13).
F32_REPEAT_CASES = [(2, 68, 32, 12), (128, 257, 12, 64), (1, 4096, 1, 64),
                    (2, 1, 3, 64), (2, 37, 3, 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,heads,hd", F32_REPEAT_CASES)
def test_f32_attention_backwards_give_the_same_bits_launch_to_launch(
    cuda, b, l, heads, hd):
  """Six launches each of K4's and K8's f32 instances, and of K3's and
  K7's f32 forwards, on the same inputs and buffers give the same bits
  (every sum in a fixed order, no atomics)."""
  q, k, v, do = (_randn((b, l, heads * hd), 120 + i, cuda, torch.float32)
                 for i in range(4))
  as4 = lambda t: t.view(b, l, heads, hd)
  for call in (lambda: attn.attention_packed_bwd(q, k, v, do, heads),
               lambda: attn.attention_unpacked_bwd(*map(as4, (q, k, v, do))),
               lambda: [attn.attention_packed_fwd(q, k, v, heads)],
               lambda: [attn.attention_unpacked_fwd(*map(as4, (q, k, v)))]):
    first = call()
    for _ in range(5):
      assert all(torch.equal(a, g) for a, g in zip(first, call()))


@pytest.mark.cuda
def test_f32_attention_refuses_what_the_kernels_do_not_take(cuda):
  q = torch.zeros(1, 8, 128, device=cuda)
  with pytest.raises(ValueError, match="options of the bf16 kernels"):
    attn.attention_packed_fwd(q, q, q, 2, streamed=True)
  with pytest.raises(ValueError, match="options of the bf16 kernels"):
    attn.attention_packed_bwd(q, q, q, q, 2, chunk_tiles=1)
  assert attn._f32_lib()[1] == MAX_ATTN_LEN
  long = torch.zeros(1, MAX_ATTN_LEN + 1, 64, device=cuda)
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_packed_fwd(long, long, long, 1)
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_packed_bwd(long, long, long, long, 1)
  wide = torch.zeros(1, 8, 2056, device=cuda)
  with pytest.raises(ValueError, match="head dim 2056"):
    attn.attention_packed_fwd(wide, wide, wide, 1)
  # K7 and K8 in f32 refuse the bf16 kernels' options and what K3's f32
  # instance refuses; K9 takes bf16 only.
  q4 = q.view(1, 8, 2, 64)
  with pytest.raises(ValueError, match="options of the bf16 kernels"):
    attn.attention_unpacked_fwd(q4, q4, q4, streamed=True)
  with pytest.raises(ValueError, match="options of the bf16 kernels"):
    attn.attention_unpacked_bwd(q4, q4, q4, q4, chunk_tiles=1)
  long4 = long.view(1, MAX_ATTN_LEN + 1, 1, 64)
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_unpacked_fwd(long4, long4, long4)
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_unpacked_bwd(long4, long4, long4, long4)
  wide4 = wide.view(1, 8, 1, 2056)
  with pytest.raises(ValueError, match="head dim 2056"):
    attn.attention_unpacked_bwd(wide4, wide4, wide4, wide4)
  with pytest.raises(ValueError, match="must be bfloat16, got"):
    attn.attention_ablate(q, q, q, 2, "prod")


@pytest.mark.cuda
def test_f32_block_under_pallas_fused_matches_the_cpu(cuda):
  """An f32 block under "pallas_fused" (K1, K6 and K5 in f32) on the card
  against the CPU (plain versions), within 1e-4 of the output's largest
  value, and its input gradient (the reference composition's backward:
  K3, K4 and K2 in f32) within 1e-3 of its largest: f32 on both sides,
  sums in another order."""
  from small_vision_tpu_torch.models import vit
  block = vit.Block(768, None, 12, True, torch.float32, "pallas_fused")
  gen = torch.Generator().manual_seed(0)
  for name, p in block.named_parameters():
    std = 0.1 if name.endswith("bias") else p.shape[0] ** -0.5
    p.data = torch.randn(p.shape, generator=gen) * std
  x = _randn((2, 37, 768), 1, "cpu", torch.float32)
  cond = _randn((2, 768), 2, "cpu", torch.float32)
  got = {}
  for dev in ("cpu", "cuda"):
    xi = x.to(dev).clone().requires_grad_()
    _build.reset_launches()
    with torch.no_grad():
      y = block.to(dev)(xi, cond.to(dev))
    launches = dict(_build.LAUNCHES)
    block.to(dev)(xi, cond.to(dev)).square().sum().backward()
    got[dev] = (y.cpu(), xi.grad.cpu(), launches)
  assert got["cuda"][2] == {ln.NAME_F32: 2, fb.MHA_NAME_F32: 1,
                            fb.MLP_NAME_F32: 1}
  for i, tol in ((0, 1e-4), (1, 1e-3)):
    want = got["cpu"][i]
    err = (got["cuda"][i] - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), (i, err)


@pytest.mark.cuda
def test_f32_block_on_the_card_matches_the_cpu(cuda):
  """An f32 block under "pallas" (K1 and K3 in f32) on the card against
  the CPU (plain versions), within 1e-4 of the output's largest value:
  f32 on both sides, sums in another order."""
  from small_vision_tpu_torch.models import vit
  block = vit.Block(768, None, 12, True, torch.float32, "pallas")
  gen = torch.Generator().manual_seed(0)
  for name, p in block.named_parameters():
    std = 0.1 if name.endswith("bias") else p.shape[0] ** -0.5
    p.data = torch.randn(p.shape, generator=gen) * std
  block.requires_grad_(False)
  x = _randn((2, 37, 768), 1, "cpu", torch.float32)
  cond = _randn((2, 768), 2, "cpu", torch.float32)
  want = block(x, cond)
  _build.reset_launches()
  got = block.to(cuda)(x.to(cuda), cond.to(cuda)).cpu()
  assert dict(_build.LAUNCHES) == {ln.NAME_F32: 2, attn.NAME_F32: 1}
  assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# ---------------------------------------------------------------------------
# K5-K8 in f32: the SIMT instances (fused_mlp_f32.cu, fused_mha_f32.cu,
# attention_unpacked_f32.cu).
# ---------------------------------------------------------------------------


def _f32(args):
  return [t.float() if torch.is_tensor(t) else t for t in args]


def _f32_weights(cuda, width, hd, seed):
  """The q, k, v weights and biases and the out-projection of K6 on
  (width, hd) projections, f32."""
  args = []
  for i in range(3):
    args += [_randn((width, hd), seed + 2 * i, cuda, torch.float32,
                    width**-0.5),
             _randn((hd,), seed + 2 * i + 1, cuda, torch.float32, 0.1)]
  return args + [_randn((hd, width), seed + 6, cuda, torch.float32,
                        hd**-0.5),
                 _randn((width,), seed + 7, cuda, torch.float32, 0.1)]


def _close_f32(got, want, tol):
  err = (got - want).abs().max().item()
  assert err <= tol * want.abs().max().item(), (err, want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows_shape,d,hidden", [
    ((64, 260), 768, 3072), ((128, 257), 768, 3072), ((1, 1), 768, 3072),
    ((3, 65), 1024, 4096), ((2, 37), 36, 150), ((4, 257), 1, 1),
    ((2, 20), 1, 4), ((1, 4096), 36, 144)])
def test_f32_fused_mlp_kernel_matches_plain(cuda, rows_shape, d, hidden):
  """K5's f32 instance at widths 1, 36, 768 and 1,024 and rows of 1 to
  4,096 a batch row, unpadded (36 and 150 are not multiples of 4: scalar
  loads): within 1e-5 of the output's largest value (f32 on both sides,
  sums in another order), two launches giving the same bits, counted
  under MLP_NAME_F32."""
  args = _f32(_mlp_args(cuda, rows_shape, d, hidden))
  _build.reset_launches()
  got = fb.fused_mlp_fwd(*args)
  assert got.dtype == torch.float32 and got.shape == args[0].shape
  _close_f32(got, fb.fused_mlp_plain(*args), 1e-5)
  assert torch.equal(got, fb.fused_mlp_fwd(*args))  # no atomics
  assert dict(_build.LAUNCHES) == {fb.MLP_NAME_F32: 2}


# K6, K7 and K8 in f32: (batch, length, heads, head dim). The main path's
# 12 heads of 64 at the sampler's and a training shape, head dims 1, 12
# (`heads=32`), 384 (`heads=2`) and 2,048 (the limit), and L = 1, 257 and
# 4,096 (the limit).
F32_MAX_SHIFT_CASES = [(64, 260, 12, 64), (4, 257, 12, 64), (2, 1, 3, 64),
                       (2, 20, 2, 1), (2, 68, 32, 12), (2, 257, 2, 384),
                       (1, 65, 1, 2048), (1, 1, 1, 2048),
                       (1, 4096, 1, 64), (1, 4096, 2, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,heads,hd", F32_MAX_SHIFT_CASES)
def test_f32_fused_mha_kernel_matches_plain(cuda, b, l, heads, hd):
  """K6's f32 instance (the q, k, v projections and the out-projection on
  the SIMT GEMM, the max-shift attention between) against its plain
  version: within 1e-5 of the output's largest value, two launches giving
  the same bits, counted under MHA_NAME_F32."""
  width = heads * hd
  args = [_randn((b, l, width), 7, cuda, torch.float32),
          *_f32_weights(cuda, width, width, 8), heads]
  _build.reset_launches()
  got = fb.fused_mha_fwd(*args)
  _close_f32(got, fb.fused_mha_plain(*args), 1e-5)
  assert torch.equal(got, fb.fused_mha_fwd(*args))  # no atomics
  assert dict(_build.LAUNCHES) == {fb.MHA_NAME_F32: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,width,heads,hd", [
    (64, 260, 768, 6, 64), (3, 65, 384, 3, 12), (2, 37, 36, 2, 32),
    (2, 20, 100, 3, 1)])
def test_f32_fused_mha_kernel_non_square_matches_plain(cuda, b, l, width,
                                                       heads, hd):
  """K6's f32 instance on (width, heads * hd) projections (a tensor rank's
  6 of 12 heads; a rank's 3 of `heads=32`'s heads of 12; wider and
  narrower than square), unpadded: within 1e-5 of the output's largest
  value, two launches giving the same bits."""
  args = [_randn((b, l, width), 17, cuda, torch.float32),
          *_f32_weights(cuda, width, heads * hd, 18), heads]
  got = fb.fused_mha_fwd(*args)
  assert got.shape == (b, l, width)
  _close_f32(got, fb.fused_mha_plain(*args), 1e-5)
  assert torch.equal(got, fb.fused_mha_fwd(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,heads,hd", F32_MAX_SHIFT_CASES)
def test_f32_unpacked_attention_kernels_match_plain(cuda, b, l, heads, hd):
  """K7's and K8's f32 instances against the plain versions: o within
  1e-5 of its largest value, dq, dk and dv within 1e-4 of each one's
  (floored at 1e-2 of the largest of the three: dq and dk vanish at L =
  1, as in test_f32_attention_kernels_match_plain), two launches giving
  the same bits, counted under the f32 names."""
  q, k, v, do = (_randn((b, l, heads, hd), 30 + i, cuda, torch.float32)
                 for i in range(4))
  _build.reset_launches()
  got = attn.attention_unpacked_fwd(q, k, v)
  assert torch.equal(got, attn.attention_unpacked_fwd(q, k, v))
  _close_f32(got, attn.attention_plain(q, k, v), 1e-5)
  grads = attn.attention_unpacked_bwd(q, k, v, do)
  again = attn.attention_unpacked_bwd(q, k, v, do)
  want = attn.attention_bwd_plain(q, k, v, do)
  top = max(w.abs().max().item() for w in want)
  for g, a, w in zip(grads, again, want):
    assert g.dtype == torch.float32 and torch.equal(g, a)
    err = (g - w).abs().max().item()
    assert err <= 1e-4 * max(w.abs().max().item(), 1e-2 * top), err
  assert dict(_build.LAUNCHES) == {attn.UNPACKED_NAME_F32: 2,
                                   attn.UNPACKED_BWD_NAME_F32: 2}


@pytest.mark.cuda
def test_f32_unpacked_attention_takes_large_logits(cuda):
  """The max shift in f32: logits of several hundred neither overflow nor
  lose the row's largest key, forward and dV."""
  q, k, v, do = (_randn((2, 65, 3, 64), 40 + i, cuda, torch.float32,
                        30.0 if i < 2 else 1.0) for i in range(4))
  got = attn.attention_unpacked_fwd(q, k, v)
  assert torch.isfinite(got).all()
  _close_f32(got, attn.attention_plain(q, k, v), 1e-5)
  grads = attn.attention_unpacked_bwd(q, k, v, do)
  assert all(torch.isfinite(g).all() for g in grads)
  _close_f32(grads[2], attn.attention_bwd_plain(q, k, v, do)[2], 1e-4)


def _device_ms(fn, n=5):
  """Mean device time of one call of `fn` over `n` calls, by CUDA events,
  after one warm-up call."""
  fn()
  torch.cuda.synchronize()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  for _ in range(n):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / n


@pytest.mark.cuda
def test_f32_stage_timers_launch_their_kernels_and_count_nothing(cuda):
  """K5's, K6's and K8's f32 stage timers (K8's three in order:
  statistics, dQ, dK and dV) count no launch, and launch the call's
  kernels one by one: each stage takes device time, and together they take
  that of one call (device times by CUDA events; a CUPTI trace of these
  eight launches lost some kernels' records in a process that had run the
  rest of this file)."""
  f32 = torch.float32
  mlp = _f32(_mlp_args(cuda, (8, 257)))
  mha = [_randn((8, 257, 768), 50, cuda, f32),
         *_f32_weights(cuda, 768, 768, 51), 12]
  q, k, v, do = (_randn((8, 257, 12, 64), 60 + i, cuda, f32)
                 for i in range(4))
  cases = ((fb.fused_mlp_stages(*mlp), lambda: fb.fused_mlp_fwd(*mlp),
            ["up", "down"]),
           (fb.fused_mha_stages(*mha), lambda: fb.fused_mha_fwd(*mha),
            ["qkv_proj", "attention", "out_proj"]),
           (attn.attention_unpacked_bwd_stages(q, k, v, do),
            lambda: attn.attention_unpacked_bwd(q, k, v, do),
            ["stats", "dq", "dkdv"]))
  for stages, call, names in cases:
    assert list(stages) == names
    _build.reset_launches()
    times = [_device_ms(launch) for launch in stages.values()]
    assert not _build.LAUNCHES
    whole = _device_ms(call)
    assert min(times) >= 0.05 * whole, (names, times, whole)
    assert 0.8 <= sum(times) / whole <= 1.25, (names, times, whole)


# sha256 of K3's f32 output bytes on `_f32_digest_inputs` as its forward
# gives them (sm90_f32x3_attention.cuh: the scores a pair on each row's
# grid, e V 3xTF32; built by nvcc 12.8 for sm_90a, -O3, on an H100), of
# K4's f32 dq, dk, dv bytes as its 3xTF32 backward gives them
# (sm90_f32x3_attention_bwd.cuh, the same toolchain),
# and of K6's f32 output on `_f32_mha_digest_inputs` as its SIMT kernels
# give it (simt_f32_gemm.cuh, simt_f32_attention.cuh).
F32_PACKED_DIGESTS = {
    "fwd": "119a91342a3b3167b4582b6db83cc9af635f21dbc21481a9892ec60503c41cfd",
    "bwd": "b1fa057fc1c1e8fa3a00142a4b9760ec94fdae595a1d680103cebd395e02f512",
    "mha": "742fcc1749b698102147c9928204ce77355c67abdc7a6dc86917f62bc3f53753",
}


def _f32_digest_inputs(cuda):
  return [_randn((2, 70, 3 * 64), 70 + i, cuda, torch.float32)
          for i in range(4)]


def _f32_mha_digest_inputs(cuda):
  return [_randn((2, 70, 3 * 64), 80, cuda, torch.float32),
          *_f32_weights(cuda, 3 * 64, 3 * 64, 81), 3]


def _digest(tensors):
  import hashlib
  h = hashlib.sha256()
  for t in tensors:
    h.update(t.cpu().numpy().tobytes())
  return h.hexdigest()


@pytest.mark.cuda
def test_f32_packed_attention_keeps_its_bits(cuda):
  """K3's f32 instance gives the bits of its forward (the scores a pair
  on each row's grid), and K4's those of its 3xTF32 backward, whose
  helpers the forward shares
  (`tools/ab_kernels.py` holds K4 against another tree's library at the
  model's shapes)."""
  q, k, v, do = _f32_digest_inputs(cuda)
  got = _digest([attn.attention_packed_fwd(q, k, v, 3)])
  assert got == F32_PACKED_DIGESTS["fwd"], got
  got = _digest(attn.attention_packed_bwd(q, k, v, do, 3))
  assert got == F32_PACKED_DIGESTS["bwd"], got


@pytest.mark.cuda
def test_f32_fused_mha_keeps_its_bits(cuda):
  """K6's f32 instance gives the bits of its SIMT kernels as they were
  before K3's and K7's f32 forwards left the SIMT attention header, which
  K6's attention stage still runs."""
  got = _digest([fb.fused_mha_fwd(*_f32_mha_digest_inputs(cuda))])
  assert got == F32_PACKED_DIGESTS["mha"], got
