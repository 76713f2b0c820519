"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only, so it also runs where JAX is not
installed: on a machine with a GPU and nvcc,

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(`--noconftest` skips tests/conftest.py, which sets up JAX). The tests
marked `cuda` skip where there is no CUDA device. The others check, on the
CPU, that the wrappers refuse what the kernels do not take.
"""

import numpy as np
import pytest
import torch

from small_vision_tpu_torch.ops import _build
from small_vision_tpu_torch.ops import attention as attn
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
