"""Port parity: the seven arms of the attention-ablation kernel (K9).

`ops.attention.attention_ablate_plain` (what `attention_ablate` runs for a
CPU tensor, and what the CUDA kernel is held against on the card) against
the JAX body `scripts/ablate_attention_kernel.py::_kernel_variant`, run in
Pallas interpret mode. The script's own `run_variant` has no `interpret`
argument, so the test loads the script from its path and builds the same
`pl.pallas_call` with `interpret=True`. Inputs come from a numpy seed and
go to both sides as bf16, at a length that is not a multiple of 16 (the TPU
tile pads it, which `mulmask` can see) and at three that are (80 is not a
multiple of the card kernel's 64-row tile; 1,024 is past the lengths whose
K and V the card kernel keeps resident). `nomm` and `prod`
are also held against closed-form numpy expressions, so that a misreading
shared by the two versions cannot pass.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from small_vision_tpu_torch.ops import attention as attn

SCRIPT = (pathlib.Path(__file__).resolve().parent.parent / "scripts"
          / "ablate_attention_kernel.py")
HEADS, HEAD_DIM = 2, 64
# Tolerance in bf16 ulps of the largest output (an ulp taken as 2^-7 of
# it): p is rounded to bf16 from f32 scores that the two sides sum in
# another order, and the output is bf16, so two ulps; bf16exp rounds the
# shifted score to bf16 before exp, where a flipped rounding moves e by up
# to 2^-8 |S - m|, so four; nomm has no sum whose order could differ.
ULPS = {"prod": 2, "nosoftmax": 2, "nomm": 0.5, "bf16exp": 4, "exp2": 2,
        "mulmask": 2, "nomax": 2}


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


def _jax_variant(q, k, v, variant):
  """`run_variant`'s pallas_call, one block over the batch, interpreted."""
  script = _script()
  b, l, hd = q.shape
  lp = -(-l // 16) * 16
  spec = pl.BlockSpec((b, lp, hd), lambda i: (i, 0, 0))
  kern = functools.partial(
      script._kernel_variant, scale=1.0 / np.sqrt(HEAD_DIM), seq_len=l, bb=b,
      num_heads=HEADS, head_dim=HEAD_DIM, variant=variant)
  return pl.pallas_call(
      kern, grid=(1,), in_specs=[spec, spec, spec], out_specs=spec,
      out_shape=jax.ShapeDtypeStruct((b, l, hd), q.dtype),
      interpret=True)(q, k, v)


def _inputs(seed, b, l):
  rng = np.random.default_rng(seed)
  return [rng.standard_normal((b, l, HEADS * HEAD_DIM)).astype(np.float32)
          .astype(ml_dtypes.bfloat16) for _ in range(3)]


def _to_torch(a):
  return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _close(got, want, ulps):
  got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
  assert got.shape == want.shape
  assert np.isfinite(got).all()
  err = np.abs(got - want).max()
  assert err <= ulps * 2.0**-7 * np.abs(want).max(), (err, np.abs(want).max())


# 80: a multiple of 16 but not of 64, where the TPU tile has no padded key
# and the card's 64-row tiles have 48 zero keys that no arm may see. 1,024:
# ViT-L/16@512's length, where the card kernel's K and V stream through
# its ring, every pass walking the keys again.
@pytest.mark.parametrize("l", [21, 32, 80, 1024])
@pytest.mark.parametrize("variant", attn.ABLATE_VARIANTS)
def test_plain_matches_the_jax_body(variant, l):
  q, k, v = _inputs(l, 2, l)
  want = _jax_variant(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), variant)
  got = attn.attention_ablate(_to_torch(q), _to_torch(k), _to_torch(v), HEADS,
                              variant)
  assert got.dtype == torch.bfloat16
  _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
         ULPS[variant])


def _heads(a):
  b, l, _ = a.shape
  return np.asarray(a, np.float64).reshape(b, l, HEADS, HEAD_DIM).transpose(
      0, 2, 1, 3)


def _bf16(a):
  return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
      np.float64)


@pytest.mark.parametrize("l", [21, 32])
def test_nomm_closed_form(l):
  """Every score of a row is equal, so every probability is 1/L, and the
  output is bf16(bf16(1/L) * v[i, 0]) on all 64 columns of a head: query
  row i's own value, whatever q and k hold."""
  q, k, v = _inputs(7, 2, l)
  got = attn.attention_ablate_plain(_to_torch(q), _to_torch(k), _to_torch(v),
                                    HEADS, "nomm").float().numpy()
  p = _bf16(np.float32(1.0) / np.float32(l))
  v0 = _heads(v)[..., :1]                                # (B, H, L, 1)
  want = np.broadcast_to(_bf16(p * v0), (2, HEADS, l, HEAD_DIM))
  want = want.transpose(0, 2, 1, 3).reshape(2, l, HEADS * HEAD_DIM)
  np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("l", [21, 32])
def test_prod_closed_form(l):
  """`prod` is softmax(q k^T / 8) v with the probabilities rounded to bf16
  before the second product (computed here in f64)."""
  q, k, v = _inputs(8, 2, l)
  got = attn.attention_ablate_plain(_to_torch(q), _to_torch(k), _to_torch(v),
                                    HEADS, "prod").float().numpy()
  s = np.einsum("bhqd,bhkd->bhqk", _heads(q), _heads(k)) / np.sqrt(HEAD_DIM)
  e = np.exp(s - s.max(-1, keepdims=True))
  o = np.einsum("bhqk,bhkd->bhqd", _bf16(e / e.sum(-1, keepdims=True)),
                _heads(v))
  want = o.transpose(0, 2, 1, 3).reshape(2, l, HEADS * HEAD_DIM)
  _close(got, want, ULPS["prod"])


def test_mulmask_max_sees_the_padded_zero():
  """With L not a multiple of 16 the TPU tile has zero keys past L whose
  scores, 0, join `mulmask`'s row max. Scores that are all well below 0
  (about -20 here, far from where exp leaves the normal f32 range) show it:
  they are shifted by 0 instead of by their max. Both versions must agree
  there."""
  l = 21
  q, k, v = _inputs(9, 1, l)
  q = (np.abs(q.astype(np.float32)) * 2).astype(ml_dtypes.bfloat16)
  k = (-np.abs(k.astype(np.float32)) * 2).astype(ml_dtypes.bfloat16)
  want = _jax_variant(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      "mulmask")
  got = attn.attention_ablate_plain(_to_torch(q), _to_torch(k), _to_torch(v),
                                    HEADS, "mulmask")
  _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
         ULPS["mulmask"])
  s = np.einsum("bhqd,bhkd->bhqk", _heads(q), _heads(k)) / np.sqrt(HEAD_DIM)
  assert s.max() < -5  # every row's max is below the padded keys' 0


def test_wrapper_rules():
  q, k, v = (_to_torch(a) for a in _inputs(1, 1, 16))
  with pytest.raises(ValueError, match="unknown variant"):
    attn.attention_ablate(q, k, v, HEADS, "fast")
  # The launcher takes CUDA tensors only; there is no fallback in it.
  with pytest.raises(ValueError, match="must be a CUDA tensor"):
    attn.attention_ablate_fwd(q, k, v, HEADS, "prod")
