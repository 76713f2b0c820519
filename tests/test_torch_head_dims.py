"""Port parity at head dims other than 64: the plain versions of K6 (the
fused MHA), K7 and K8 (attention on [B, L, H, D] with the max-shift
softmax, forward and backward) and K9 (the seven ablation arms), whose
CUDA kernels take every head dim that is a multiple of 8 up to 2,048,
and whose wrappers take the others up to 2,048 on heads zero-padded to one
(12, `heads=32` at UMD-S's 384, and 4 here).

The same inputs, drawn with numpy, go through the JAX package's Pallas
kernels in interpret mode (`_mha_pallas`, `pallas_attention`,
`_pallas_attention_bwd_impl`, and `run_variant`'s kernel body, which the
script builds for the TPU only) and through the port on the CPU, at head
dims 8, 16, 80, 128, 192, 256, 12, 4, 384 and 520 with B <= 2 and L <=
70 (L <= 40 past 256). Each JAX kernel
derives its head dim from the shapes and scales by f32(D**-0.5), as the
port does.

Tolerances, relative to the largest output: f32 1e-5 (the same formulas,
sums in another order); bf16 2^-6, two bf16 ulps (q, k, v, the
probabilities and the outputs round to bf16 on both sides, and a sum in
another order may flip one rounding); K9's arms the ulps of
tests/test_torch_attention_ablate.py.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from small_vision_tpu.ops import attention as jattn
from small_vision_tpu.ops import fused_block as jfb
from small_vision_tpu_torch.ops import attention as tattn
from small_vision_tpu_torch.ops import fused_block as tfb

SCRIPT = (pathlib.Path(__file__).resolve().parent.parent / "scripts"
          / "ablate_attention_kernel.py")
# (head dim, heads, L): the narrow dims of the quick configs, ViT-H's 80,
# the `heads=6` setting's 128, `heads=4`'s and `heads=3`'s 192 and 256
# (three and four 64-column tiles a head on the card), and 12 and 4, which
# are not multiples of 8 (the card's wrappers pad them to 16 and 8);
# `heads=2`'s 384 and 520 (six and nine tiles, the last ragged: the card's
# wide path, O's columns split across CTAs).
CASES = [(8, 8, 21), (16, 4, 37), (80, 2, 70), (128, 2, 45), (192, 2, 33),
         (256, 1, 52), (12, 4, 23), (4, 3, 19), (384, 1, 40), (520, 1, 33)]
IDS = [f"d{d}" for d, _, _ in CASES]
B = 2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}
# K9: bf16 ulps of the largest output, as in test_torch_attention_ablate.
ULPS = {"prod": 2, "nosoftmax": 2, "nomm": 0.5, "bf16exp": 4, "exp2": 2,
        "mulmask": 2, "nomax": 2}


def _np(a):
  if isinstance(a, torch.Tensor):
    return a.detach().float().numpy()
  return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel):
  got, want = _np(got), _np(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  assert np.isfinite(got).all()
  err = np.abs(got - want).max()
  assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _randn(rng, *shape, scale=1.0):
  return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(arrays, dtype):
  jdt, tdt = DTYPES[dtype]
  return ([jnp.asarray(a, jdt) for a in arrays],
          [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,heads,l", CASES, ids=IDS)
def test_fused_mha_plain_matches_the_jax_kernel(hd, heads, l, dtype):
  rng = np.random.default_rng(hd)
  d = hd * heads
  args = [_randn(rng, B, l, d)]
  for _ in range(4):
    args += [_randn(rng, d, d, scale=d**-0.5), _randn(rng, d, scale=0.1)]
  jargs, targs = _both(args, dtype)
  want = jfb._mha_pallas(*jargs, heads, True)
  got = tfb.fused_mha(*targs, heads)
  assert got.dtype == DTYPES[dtype][1]
  _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,heads,l", CASES, ids=IDS)
def test_unpacked_attention_plain_matches_the_jax_kernels(hd, heads, l,
                                                          dtype):
  """K7's forward and K8's backward (through `fused_attention`'s autograd
  on the CPU) against `pallas_attention` and `_pallas_attention_bwd_impl`."""
  rng = np.random.default_rng(hd + 1)
  arrays = [_randn(rng, B, l, heads, hd) for _ in range(4)]
  (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(arrays, dtype)
  _close(tattn.fused_attention(tq, tk, tv),
         jattn.pallas_attention(jq, jk, jv, interpret=True), TOL[dtype])
  want = jattn._pallas_attention_bwd_impl(jq, jk, jv, jdo, interpret=True)
  leaves = [t.requires_grad_() for t in (tq, tk, tv)]
  tattn.fused_attention(*leaves).backward(tdo)
  for t, w in zip(leaves, want):
    assert t.grad.dtype == DTYPES[dtype][1]
    _close(t.grad, w, TOL[dtype])


@functools.cache
def _script():
  spec = importlib.util.spec_from_file_location("ablate_attention_kernel",
                                                SCRIPT)
  module = importlib.util.module_from_spec(spec)
  # The script points JAX's compilation cache at a fixed directory when it
  # is run; a test process keeps the settings it had.
  names = ("jax_compilation_cache_dir",
           "jax_persistent_cache_min_compile_time_secs")
  before = {n: getattr(jax.config, n) for n in names}
  spec.loader.exec_module(module)
  for n, v in before.items():
    jax.config.update(n, v)
  return module


def _run_variant(q, k, v, num_heads, variant):
  """`run_variant`'s pallas_call (its scale, head dim and padded length),
  one block over the batch, interpreted."""
  b, l, hd = q.shape
  d = hd // num_heads
  lp = -(-l // 16) * 16
  spec = pl.BlockSpec((b, lp, hd), lambda i: (i, 0, 0))
  kern = functools.partial(
      _script()._kernel_variant, scale=1.0 / np.sqrt(d), seq_len=l, bb=b,
      num_heads=num_heads, head_dim=d, variant=variant)
  return pl.pallas_call(
      kern, grid=(1,), in_specs=[spec, spec, spec], out_specs=spec,
      out_shape=jax.ShapeDtypeStruct((b, l, hd), q.dtype),
      interpret=True)(q, k, v)


@pytest.mark.parametrize("hd,heads,l", CASES, ids=IDS)
def test_ablation_arms_plain_match_the_jax_kernel(hd, heads, l):
  rng = np.random.default_rng(hd + 2)
  arrays = [_randn(rng, B, l, heads * hd) for _ in range(3)]
  (jq, jk, jv), (tq, tk, tv) = _both(arrays, "bfloat16")
  for variant in tattn.ABLATE_VARIANTS:
    want = _run_variant(jq, jk, jv, heads, variant)
    got = tattn.attention_ablate(tq, tk, tv, heads, variant)
    assert got.dtype == torch.bfloat16
    try:
      _close(got, want, ULPS[variant] * 2.0**-7)
    except AssertionError as e:
      raise AssertionError(f"{variant}: {e}") from None
