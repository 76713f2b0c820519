"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only, so it also runs where JAX is not
installed: on a machine with a GPU and nvcc,

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(`--noconftest` skips tests/conftest.py, which sets up JAX). The tests
marked `cuda` skip where there is no CUDA device: K1 and K3 (the forwards)
and K2 and K4 (the backwards) against their plain versions at the
training and sampler lengths, two launches of each backward giving the
same bits, the wrappers refusing what the kernels do not take, and the
sampler's no-grad path writing no statistics and launching no backward;
then the fused MLP (K5), the fused MHA (K6) and the [B, L, H, D] attention
with the max-shift softmax (K7, K8) in the same way, and the seven arms of
the ablation kernel (K9) at two small shapes whose length is not a multiple
of 16.
The others check, on the CPU, that the wrappers refuse CPU tensors and
that CPU tensors take the plain versions.
"""

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
  with pytest.raises(ValueError, match="bfloat16"):
    ln.ln_modulate_fwd(x.float(), gamma, beta)
  with pytest.raises(ValueError, match="width"):
    ln.ln_modulate_fwd(x[..., :100].contiguous(), gamma[:100], beta[:100])
  with pytest.raises(ValueError, match="together"):
    ln.ln_modulate_fwd(x, gamma, beta, shift, None)
  with pytest.raises(ValueError, match="contiguous"):
    ln.ln_modulate_fwd(x.transpose(0, 1), gamma, beta)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [20, 257, 260])
def test_attention_kernel_matches_plain(cuda, l):
  q, k, v = (_randn((4, l, 2 * 64), s, cuda, torch.bfloat16)
             for s in range(3))
  before = _build.LAUNCHES[attn.NAME]
  got = attn.attention_packed(q, k, v, 2).float()
  assert _build.LAUNCHES[attn.NAME] == before + 1
  want = attn.attention_packed_plain(q, k, v, 2).float()
  # Outputs are convex mixes of N(0,1) values rounded to bf16 (ulp 2^-7 at
  # unit magnitude); scores summed in another order may flip the bf16
  # rounding of a weight e: allow two ulps.
  torch.testing.assert_close(got, want, rtol=2**-7, atol=2**-7)


@pytest.mark.cuda
def test_attention_wrapper_refuses_what_the_kernel_does_not_take(cuda):
  q = torch.zeros(1, 8, 2 * 32, dtype=torch.bfloat16, device=cuda)
  with pytest.raises(ValueError, match="head dim"):
    attn.attention_packed_fwd(q, q, q, 2)
  long = torch.zeros(1, 4096, 64, dtype=torch.bfloat16, device=cuda)
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
def test_ln_bwd_kernel_is_deterministic(cuda):
  args = _ln_bwd_args(cuda, 257, True, b=16)
  first = ln.ln_modulate_bwd(*args)
  second = ln.ln_modulate_bwd(*args)
  for a, b in zip(first, second):
    assert torch.equal(a, b)


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
  with pytest.raises(ValueError, match="width"):
    small = x[..., :256].contiguous()
    ln.ln_modulate_bwd(small, small, mean, rstd, gamma[:256], beta[:256])


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
  q = torch.zeros(1, 8, 2 * 32, dtype=torch.bfloat16, device=cuda)
  with pytest.raises(ValueError, match="head dim"):
    attn.attention_packed_bwd(q, q, q, q, 2)
  long = torch.zeros(1, 4096, 64, dtype=torch.bfloat16, device=cuda)
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


def _mha_args(device, b, l, heads, seed=0):
  d = heads * 64
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
@pytest.mark.parametrize("rows_shape", [(3, 20), (8, 260), (1, 64), (130,)])
def test_fused_mlp_kernel_matches_plain(cuda, rows_shape):
  args = _mlp_args(cuda, rows_shape)
  before = _build.LAUNCHES[fb.MLP_NAME]
  got = fb.fused_mlp_fwd(*args)
  assert _build.LAUNCHES[fb.MLP_NAME] == before + 1
  assert got.shape == args[0].shape and got.dtype == torch.bfloat16
  # bf16 hidden activations and outputs on both sides; the f32 sums over
  # 768 and 3,072 terms run in another order, which may flip the rounding
  # of a hidden value and moves an output by about an ulp: allow two.
  _assert_close_to_max(got, fb.fused_mlp_plain(*args), 2)


@pytest.mark.cuda
def test_fused_mlp_dispatch_and_refusals(cuda):
  x, w1, b1, w2, b2 = _mlp_args(cuda, (2, 20))
  _build.reset_launches()
  fb.fused_mlp(x, w1, b1, w2, b2)
  assert dict(_build.LAUNCHES) == {fb.MLP_NAME: 1}
  with pytest.raises(ValueError, match="bfloat16"):
    fb.fused_mlp_fwd(x.float(), w1, b1, w2, b2)
  with pytest.raises(ValueError, match="width"):
    fb.fused_mlp_fwd(x[..., :256].contiguous(), w1[:256].contiguous(), b1,
                     w2[:, :256].contiguous(), b2[:256].contiguous())
  with pytest.raises(ValueError, match="multiple"):
    fb.fused_mlp_fwd(x, w1[:, :100].contiguous(), b1[:100].contiguous(),
                     w2[:100].contiguous(), b2)
  with pytest.raises(ValueError, match="contiguous"):
    fb.fused_mlp_fwd(x.transpose(0, 1), w1, b1, w2, b2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,heads", [(3, 20, 12), (2, 37, 3), (4, 260, 12),
                                       (4, 257, 12), (2, 272, 2)])
def test_fused_mha_kernel_matches_plain(cuda, b, l, heads):
  args = _mha_args(cuda, b, l, heads)
  before = _build.LAUNCHES[fb.MHA_NAME]
  got = fb.fused_mha_fwd(*args, heads)
  assert _build.LAUNCHES[fb.MHA_NAME] == before + 1
  # q, k, v, the probabilities, the head outputs and the output round to
  # bf16 on both sides; sums in another order may flip an inner rounding:
  # two bf16 ulps of the largest output.
  _assert_close_to_max(got, fb.fused_mha_plain(*args, heads), 2)
  assert torch.equal(got, fb.fused_mha_fwd(*args, heads))  # no atomics


@pytest.mark.cuda
def test_fused_mha_refuses_what_the_kernel_does_not_take(cuda):
  args = _mha_args(cuda, 1, 8, 2)
  with pytest.raises(ValueError, match="head dim"):
    fb.fused_mha_fwd(*args, 4)
  with pytest.raises(ValueError, match="bfloat16"):
    fb.fused_mha_fwd(args[0].float(), *args[1:], 2)
  long = _mha_args(cuda, 1, 1024, 1)
  with pytest.raises(ValueError, match="sequence length"):
    fb.fused_mha_fwd(*long, 1)


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


def _qkv_do_4d(device, l, b=4, h=2, seed=0, scale=1.0):
  return [_randn((b, l, h, 64), seed + i, device, torch.bfloat16,
                 scale if i < 2 else 1.0) for i in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("l,h", [(20, 2), (37, 3), (257, 12), (260, 12)])
def test_unpacked_attention_kernel_matches_plain(cuda, l, h):
  q, k, v, _ = _qkv_do_4d(cuda, l, h=h)
  before = _build.LAUNCHES[attn.UNPACKED_NAME]
  got = attn.fused_attention(q, k, v)
  assert _build.LAUNCHES[attn.UNPACKED_NAME] == before + 1
  # Convex mixes of N(0,1) values rounded to bf16; a score sum in another
  # order may flip the rounding of a probability: two ulps.
  torch.testing.assert_close(got.float(),
                             attn.attention_plain(q, k, v).float(),
                             rtol=2**-7, atol=2**-7)


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
@pytest.mark.parametrize("l,h", [(20, 2), (37, 3), (68, 12), (164, 12),
                                 (257, 12)])
def test_unpacked_attention_bwd_kernel_matches_plain(cuda, l, h):
  q, k, v, do = _qkv_do_4d(cuda, l, h=h)
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
def test_unpacked_attention_autograd_and_refusals(cuda):
  q, k, v, do = _qkv_do_4d(cuda, 20)
  q, k, v = (t.requires_grad_() for t in (q, k, v))
  _build.reset_launches()
  attn.fused_attention(q, k, v).backward(do)
  assert dict(_build.LAUNCHES) == {attn.UNPACKED_NAME: 1,
                                   attn.UNPACKED_BWD_NAME: 1}
  bad = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16, device=cuda)
  with pytest.raises(ValueError, match="head dim"):
    attn.attention_unpacked_fwd(bad, bad, bad)
  long = torch.zeros(1, 4096, 1, 64, dtype=torch.bfloat16, device=cuda)
  with pytest.raises(ValueError, match="sequence length"):
    attn.attention_unpacked_bwd(long, long, long, long)
  q = q.detach()
  with pytest.raises(ValueError, match="contiguous"):
    attn.attention_unpacked_fwd(q, q, q.transpose(1, 2))


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
@pytest.mark.parametrize("b,l,h", [(2, 21, 2), (3, 37, 3)])
@pytest.mark.parametrize("variant", attn.ABLATE_VARIANTS)
def test_attention_ablate_kernel_matches_plain(cuda, variant, b, l, h):
  q, k, v = (_randn((b, l, h * 64), s, cuda, torch.bfloat16)
             for s in (50, 51, 52))
  _build.reset_launches()
  got = attn.attention_ablate(q, k, v, h, variant)
  assert _build.LAUNCHES == {attn.ABLATE_NAME: 1}
  want = attn.attention_ablate_plain(q, k, v, h, variant)
  assert got.dtype == torch.bfloat16 and got.shape == q.shape
  err = (got.float() - want.float()).abs().max().item()
  top = want.float().abs().max().item()
  assert err <= ABLATE_ULPS[variant] * 2.0**-7 * top, (err, top)


@pytest.mark.cuda
def test_attention_ablate_refuses_what_the_kernel_does_not_take(cuda):
  q = torch.zeros(1, 20, 128, dtype=torch.bfloat16, device=cuda)
  with pytest.raises(ValueError, match="unknown variant"):
    attn.attention_ablate(q, q, q, 2, "fast")
  with pytest.raises(ValueError, match="bfloat16"):
    attn.attention_ablate(q.float(), q.float(), q.float(), 2, "prod")
  with pytest.raises(ValueError, match="width 128 != num_heads"):
    attn.attention_ablate(q, q, q, 4, "prod")
