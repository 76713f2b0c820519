"""Port parity: the int8 matmul (`ops/quant.py`) and the model's `quant`
settings, against the JAX package's.

`int8_dot` on CPU tensors takes the plain version, which accumulates in
int64: its quantized operands, scales and int32 accumulator must equal the
JAX function's bit for bit (at K = 3,072 too, where an f32 sum would not be
exact), and its output lie within one bf16 ulp. The straight-through
gradients are held against `jax.vjp`, `quant_error` against JAX's. Then
the depth-2 UMD forward and one bf16 training step under `int8_mlp` and
`int8_all`, the JAX side on `pallas_interpret` / `pallas_fused_interpret`,
within the tolerances of tests/test_torch_models.py and
tests/test_torch_train_step.py; and the JAX precedence: the int8 MLP wins
over the fused MLP, and the fused attention ignores `int8_all`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.ops import quant as jquant
from small_vision_tpu_torch.models import vit as tvit
from small_vision_tpu_torch.ops import quant as tquant
from test_torch_models import TOL, _close, jax_model, torch_model
from test_torch_models import small_config as model_config
from test_torch_train_step import captured  # noqa: F401 (fixture)
from test_torch_train_step import check_step1_grads, run_both
from test_torch_train_step import small_config as step_config

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _operands(m, k, n, dtype, seed):
  """x (m, k) with an outlier, a zero row, a row of exact .5 ties and a
  row whose products with w's column 0 all share one sign (a sum near
  k * 127^2); w (k, n). Returned as f32 numpy holding `dtype`-representable
  values."""
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((m, k)).astype(np.float32)
  x[1, 3] = 40.0
  x[2] = 0.0                          # scale at its floor, 1e-8
  x[4] = np.resize([127.0, 2.5, -3.5, 0.5, -1.5, 6.0], k)  # scale 1: ties
  w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
  sign = rng.choice([-1.0, 1.0], k)
  x[5] = sign * rng.uniform(0.9, 1.0, k)
  w[:, 0] = sign * rng.uniform(0.45, 0.5, k)
  jdt, _ = DTYPES[dtype]
  cast = lambda a: np.array(jnp.asarray(a, jdt).astype(jnp.float32))
  return cast(x), cast(w)


def _tensors(x, w, dtype):
  _, tdt = DTYPES[dtype]
  return torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)


def _bf16_ulp(a):
  """One bf16 ulp at each element's magnitude (2^-7 of its power of 2)."""
  a = np.abs(a.astype(np.float32))
  return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-30))) - 7),
                  0.0)


@pytest.mark.parametrize("m,k,n,dtype", [
    (37, 64, 48, "float32"), (37, 64, 48, "bfloat16"),
    (24, 768, 3072, "bfloat16"), (40, 3072, 96, "bfloat16"),
    (40, 3072, 96, "float32")])
def test_int8_dot_forward_matches_jax(m, k, n, dtype):
  x, w = _operands(m, k, n, dtype, seed=k + n)
  jdt, _ = DTYPES[dtype]
  jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
  tx, tw = _tensors(x, w, dtype)

  # Operands and scales: bit-equal.
  jxq, jsx = jquant._quantize(jx, axis=-1)
  jwq, jsw = jquant._quantize(jw, axis=0)
  xq, sx, wq, sw = tquant.quantized_operands(tx, tw)
  np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
  np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
  np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
  np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
  assert xq[4, :6].tolist() == [127, 2, -4, 0, -2, 6]  # half to even

  # The int32 accumulator: bit-equal (exact on both sides).
  jacc = jax.lax.dot_general(jxq, jwq, (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
  acc = tquant.int_matmul(xq, wq)
  assert acc.dtype == torch.int32
  np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
  if k == 3072:  # sums past 2^24, where f32 accumulation is not exact
    assert int(acc.abs().max()) > 2 ** 24

  # The output: within one bf16 ulp of the JAX output's magnitude.
  got = tquant.int8_dot(tx, tw).float().numpy()
  want = np.asarray(jquant.int8_dot(jx, jw).astype(jnp.float32))
  assert np.all(np.abs(got - want) <= _bf16_ulp(want)), np.max(
      np.abs(got - want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dot_gradients_match_jax_vjp(dtype):
  """Straight-through: dx = g wᵀ in x's dtype, dw = xᵀ g in w's, on a
  (2, 9, 32) x; f32 within 1e-5 of each gradient's max, bf16 within two
  bf16 roundings (2^-7) of it."""
  rng = np.random.default_rng(5)
  x, w = _operands(18, 32, 24, dtype, seed=6)
  x = x.reshape(2, 9, 32)
  g = rng.standard_normal((2, 9, 24)).astype(np.float32)
  jdt, tdt = DTYPES[dtype]
  out, vjp = jax.vjp(jquant.int8_dot, jnp.asarray(x, jdt),
                     jnp.asarray(w, jdt))
  jdx, jdw = vjp(jnp.asarray(g, jdt))
  tx, tw = _tensors(x, w, dtype)
  tx.requires_grad_()
  tw.requires_grad_()
  y = tquant.int8_dot(tx, tw)
  assert y.shape == (2, 9, 24) and y.dtype == tdt
  y.backward(torch.from_numpy(g).to(tdt))
  assert tx.grad.dtype == tw.grad.dtype == tdt
  rel = 1e-5 if dtype == "float32" else 2.0 ** -7
  for got, want in ((tx.grad, jdx), (tw.grad, jdw)):
    _close(got.float().numpy(), np.asarray(want, np.float32), rel)


@pytest.mark.parametrize("outlier", [False, True])
def test_quant_error_matches_jax(outlier):
  """The relative Frobenius error: the same int8 product, the f32 one in
  another summation order (1e-4 relative)."""
  rng = np.random.default_rng(0)
  x = rng.standard_normal((64, 128)).astype(np.float32)
  w = rng.standard_normal((128, 256)).astype(np.float32)
  if outlier:
    x[3, 7] = 1000.0
  got = float(tquant.quant_error(torch.from_numpy(x), torch.from_numpy(w)))
  want = float(jquant.quant_error(jnp.asarray(x), jnp.asarray(w)))
  assert got == pytest.approx(want, rel=1e-4)
  assert got < (0.05 if outlier else 0.02)


def test_int8_dot_refuses_a_device_it_has_no_product_for():
  x = torch.zeros((32, 16), dtype=torch.int8, device="meta")
  with pytest.raises(ValueError, match="CPU or CUDA tensors only"):
    tquant.int_matmul(x, x.T)


# -- the model's quant settings ---------------------------------------------


def _quant_config(quant, attn_impl, dtype="bfloat16"):
  config = model_config(dtype=dtype)
  config["model"].update(quant=quant, attn_impl=attn_impl)
  return config


@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_fused"])
@pytest.mark.parametrize("quant", ["int8_mlp", "int8_all"])
def test_model_forward_matches_jax(quant, attn_impl):
  """Depth 2 + 1 at width 64, bf16, as tests/test_torch_models.py holds
  the bf16 model (TOL["bfloat16"] of max |pred|): a quantized value that
  lands on the other side of a rounding boundary moves its product by one
  step of 1/127 of its row's absmax, which that bound covers."""
  config = _quant_config(quant, attn_impl)
  from small_vision_tpu_torch import convert
  params = convert.init_params(config, seed=4)
  rng = np.random.default_rng(9)
  x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
  t = np.array([0, 400, 999])
  jmodel = jax_model(config)
  jpred, _ = jmodel.apply({"params": jax.tree.map(jnp.asarray, params)},
                          jnp.asarray(x), t=jnp.asarray(t), train=False)
  tpred, _ = torch_model(config, params)(torch.from_numpy(x),
                                          t=torch.from_numpy(t))
  _close(tpred.float().detach().numpy(), np.asarray(jpred, np.float32),
         TOL["bfloat16"])
  # The quantization took effect: the unquantized model differs.
  plain = dict(config, model=dict(config["model"], quant=""))
  ppred, _ = torch_model(plain, params)(torch.from_numpy(x),
                                         t=torch.from_numpy(t))
  assert not torch.equal(ppred, tpred)


@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_fused"])
@pytest.mark.parametrize("quant", ["int8_mlp", "int8_all"])
def test_one_step_matches_jax_bf16(captured, quant, attn_impl):  # noqa: F811
  """One bf16 training step with the bounds of tests/test_torch_train_step
  .py's bf16 test: the loss within 2e-3, each gradient leaf within 5e-2 of
  its max. The key biases, whose gradient is 0 analytically (a shift of
  all of a query's scores leaves its softmax alone), are round-off on both
  sides, and the quantized forward moves that round-off: each side's is
  held under 1e-4 of the global gradient norm instead."""
  config = step_config(dtype="bfloat16", attn_impl=attn_impl)
  config["model"]["quant"] = quant
  names, _, _, history = run_both(config, captured, 1)
  jmeas, tmeas, jnu, tnu = history[0]
  np.testing.assert_allclose(float(tmeas["training_loss"]),
                             float(jmeas["training_loss"]), rtol=2e-3)
  key_bias = [n.endswith("/key/bias") for n in names]
  check_step1_grads([n for n, k in zip(names, key_bias) if not k],
                    (jmeas, tmeas, jnu,
                     [t for t, k in zip(tnu, key_bias) if not k]), 5e-2)
  bound = 1e-4 * float(jmeas["l2_grads"])
  for name, got, k in zip(names, tnu, key_bias):
    if k:
      assert np.max(np.sqrt(got.numpy() / 0.05)) <= bound, name
      assert np.max(np.sqrt(np.asarray(jnu[name]) / 0.05)) <= bound, name


@pytest.mark.parametrize("attn_impl,quant,int8_per_block,fused_mha_calls", [
    ("pallas", "int8_mlp", 2, 0), ("pallas", "int8_all", 6, 0),
    ("pallas_fused", "int8_mlp", 2, 1), ("pallas_fused", "int8_all", 2, 1)])
def test_quant_precedence(monkeypatch, attn_impl, quant, int8_per_block,
                          fused_mha_calls):
  """The int8 MLP wins over the fused MLP (no `fused_mlp` call); the fused
  attention ignores `int8_all` (one `fused_mha` a block, its projections
  not quantized)."""
  calls = {"int8_dot": 0, "fused_mha": 0}

  def count(name, fn):
    def wrapped(*a, **k):
      calls[name] += 1
      return fn(*a, **k)
    return wrapped

  def no_fused_mlp(*a, **k):
    raise AssertionError("the fused MLP ran under an int8 setting")

  monkeypatch.setattr(tvit, "int8_dot", count("int8_dot", tvit.int8_dot))
  monkeypatch.setattr(tvit, "fused_mha", count("fused_mha", tvit.fused_mha))
  monkeypatch.setattr(tvit, "fused_mlp", no_fused_mlp)
  config = _quant_config(quant, attn_impl, dtype="float32")
  from small_vision_tpu_torch import convert
  model = torch_model(config, convert.init_params(config, seed=0))
  x = torch.from_numpy(np.random.default_rng(1).standard_normal(
      (2, 16, 16, 3)).astype(np.float32))
  model(x, t=torch.tensor([3, 5]))
  blocks = 2 + 1
  assert calls == {"int8_dot": int8_per_block * blocks,
                   "fused_mha": fused_mha_calls * blocks}
