"""Port parity: the ViT classifier (`models.vit._ViT`, `MAPHead`, the
position embeddings, `ViT` / `Model` by name) against the JAX package's.

Weights come from `convert.init_params` (every leaf drawn, biases, `cls`
and the head included, so that no product is zero on both sides) and
reach the JAX module as the same flax-named numpy tree.
The model is small: width 64, depth 2, 4 heads, patch 8, 32 px (16
tokens, 17 with the class token). The JAX side runs its Pallas kernels in
interpret mode (`attn_impl="pallas_interpret"` for the port's "pallas"),
the port its plain versions on the CPU.

Tolerances, relative to the largest magnitude of the tensor compared: f32
1e-5 (the same arithmetic in another summation order); bf16 those of the
smoke's phase `model`, 3e-2 of the logits and 5e-2 of each gradient leaf
(every matmul output and the residual stream round to bf16 on both sides,
at places that differ where a rounded value straddles a tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.models import vit as jvit
from small_vision_tpu_torch import convert, models
from small_vision_tpu_torch.models import vit as tvit
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

SMALL = dict(num_classes=10, patch_size=(8, 8), width=64, depth=2,
             num_heads=4, head_zeroinit=False)
F32_TOL, BF16_LOGITS, BF16_GRADS = 1e-5, 3e-2, 5e-2
# The port's attention settings and the JAX package's on the CPU.
JAX_IMPL = {"pallas": "pallas_interpret",
            "pallas_fused": "pallas_fused_interpret", "xla": "xla"}


def _config(**kw):
  return {"model_name": "vit", "model": dict(SMALL, image_size=32, **kw)}


def _jax_model(config):
  kw = {k: v for k, v in config["model"].items() if k != "image_size"}
  kw["attn_impl"] = JAX_IMPL[kw.get("attn_impl", "xla")]
  return jvit.ViT(**kw)


def _port_model(config, params, trainable=False):
  model = train_ae.build_model(config, device="cpu", trainable=trainable)
  model.load_state_dict(convert.params_from_jax(params, model))
  return model


def _image(seed=0, b=2):
  return np.random.default_rng(seed).standard_normal(
      (b, 32, 32, 3)).astype(np.float32)


def _np(a):
  if isinstance(a, torch.Tensor):
    return a.detach().float().numpy()
  return np.asarray(a, np.float32)


def _close(got, want, rel):
  """max |got - want| within `rel` of max |want| (a scale-free bound)."""
  got, want = _np(got), _np(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  err = np.max(np.abs(got - want))
  assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


OUT_KEYS = ("stem", "with_posemb", "encoded", "head_input", "pre_logits_2d",
            "pre_logits", "logits_2d", "logits")


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("posemb", ["learn", "sincos2d"])
@pytest.mark.parametrize("rep_size", [False, 32])
@pytest.mark.parametrize("pool_type", ["map", "gap", "0", "tok"])
def test_vit_matches_jax_f32(pool_type, rep_size, posemb, scan):
  """Every key of `out` at dtype_mm float32 under attn_impl "xla"."""
  config = _config(pool_type=pool_type, rep_size=rep_size, posemb=posemb,
                   scan=scan, dtype_mm="float32", attn_impl="xla")
  params = convert.init_params(config, seed=1)
  image = _image(1)
  want, jout = _jax_model(config).apply({"params": params}, image)
  with torch.no_grad():
    got, tout = _port_model(config, params)(torch.from_numpy(image))
  assert set(tout) == set(jout) == set(OUT_KEYS)
  for key in OUT_KEYS:
    _close(tout[key], jout[key], F32_TOL)
  _close(got, want, F32_TOL)


def _loss_jax(model, image, labels):
  def loss(params):
    logits, _ = model.apply({"params": params}, image)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))
  return loss


def _grads_match(config, rel_logits, rel_grads, params=None, image=None):
  params = convert.init_params(config, seed=2) if params is None else params
  image = _image(2) if image is None else image
  labels = np.array([3, 7])
  jmodel = _jax_model(config)
  want, _ = jmodel.apply({"params": params}, image)
  jgrads = dict(tree_flatten_with_names(
      jax.grad(_loss_jax(jmodel, image, jnp.asarray(labels)))(params)))
  model = _port_model(config, params, trainable=True)
  got, _ = model(torch.from_numpy(image))
  torch.nn.functional.cross_entropy(
      got.float(), torch.from_numpy(labels)).backward()
  _close(got, want, rel_logits)
  tgrads = convert.params_to_jax(
      {n: p.grad for n, p in model.named_parameters()})
  tgrads = dict(tree_flatten_with_names(tgrads))
  assert set(tgrads) == set(jgrads)
  top = max(np.max(np.abs(_np(g))) for g in jgrads.values())
  for name, g in jgrads.items():
    if name.endswith("/key/bias"):
      # The key bias adds one amount to every score of a query, which the
      # softmax cancels: its gradient is zero but for rounding, on both
      # sides; it is held at the scale of the largest gradient.
      for side in (tgrads[name], g):
        assert np.max(np.abs(_np(side))) <= rel_grads * top, name
      continue
    try:
      _close(tgrads[name], g, rel_grads)
    except AssertionError as e:
      raise AssertionError(f"{name}: {e}") from None


@pytest.mark.parametrize("attn_impl,pool_type,scan,dtype", [
    ("pallas", "map", False, "float32"),
    ("pallas_fused", "tok", False, "bfloat16"),
    ("xla", "gap", True, "float32"), ("xla", "0", True, "bfloat16")])
def test_vit_logits_and_gradients_match_jax(attn_impl, pool_type, scan,
                                            dtype):
  """The logits and the gradients of a softmax cross-entropy with respect
  to every parameter (the two Pallas settings run interpreted on the JAX
  side, which is slow: one dtype each)."""
  config = _config(pool_type=pool_type, rep_size=32, scan=scan,
                   dtype_mm=dtype, attn_impl=attn_impl)
  if dtype == "float32":
    _grads_match(config, F32_TOL, F32_TOL)
  else:
    _grads_match(config, BF16_LOGITS, BF16_GRADS)


@pytest.mark.parametrize("pool_type", ["map", "tok"])
def test_vit_mu_matches_jax_under_pallas_fused(pool_type):
  """ViT-mu/16 by name (width 32, depth 1, MLP 128, 2 heads of 16: the
  widths the card's K5 and K6 took once their GEMM took tails) at 64 px
  (16 patches), under "pallas_fused" (the plain K5 and K6 here) against
  the JAX model under "pallas_fused_interpret": the logits and every
  gradient in f32, F32_TOL."""
  config = {"model_name": "vit", "model": dict(
      variant="mu/16", num_classes=10, head_zeroinit=False, image_size=64,
      pool_type=pool_type, dtype_mm="float32", attn_impl="pallas_fused")}
  image = np.random.default_rng(12).standard_normal(
      (2, 64, 64, 3)).astype(np.float32)
  _grads_match(config, F32_TOL, F32_TOL, image=image)


# ViT-L/16@512's grid (32 x 32 patches: L = 1,024, 1,025 with the class
# token) and ViT-H/14@518's (37 x 37: 1,369), the ViT paper's fine-tuning
# resolutions, at the small model's width (patch 8, so 256 and 296 px).
@pytest.mark.parametrize("grid,pool_type", [(32, "tok"), (32, "map"),
                                            (37, "tok"), (37, "map")])
def test_vit_at_fine_tuning_grids_matches_jax(grid, pool_type):
  """A hi-res fine-tune from a 224 px checkpoint: every leaf drawn on the
  14 x 14 grid, the learned posemb carried to the grid by each package's
  `resample_posemb` (the same scipy zoom: the same bits), then the logits
  and the gradients of a softmax cross-entropy under "pallas" (the JAX side
  `pallas_interpret`; on the card K3 and K4 stream at these lengths), f32
  1e-5. `get_posemb`, the class token and MAPHead take the grid as it is."""
  low = _config(pool_type=pool_type, rep_size=32, dtype_mm="float32",
                attn_impl="pallas")
  low["model"]["image_size"] = 8 * 14
  params = convert.init_params(low, seed=8)
  old = params["pos_embedding"]
  assert old.shape == (1, 14 * 14, SMALL["width"])
  new = np.zeros((1, grid * grid, SMALL["width"]), np.float32)
  jpos = np.asarray(jvit.resample_posemb(jnp.asarray(old), jnp.asarray(new)))
  tpos = tvit.resample_posemb(torch.from_numpy(old), torch.from_numpy(new))
  np.testing.assert_array_equal(_np(tpos), jpos)
  high = _config(pool_type=pool_type, rep_size=32, dtype_mm="float32",
                 attn_impl="pallas")
  high["model"]["image_size"] = 8 * grid
  image = np.random.default_rng(grid).standard_normal(
      (2, 8 * grid, 8 * grid, 3)).astype(np.float32)
  _grads_match(high, F32_TOL, F32_TOL, dict(params, pos_embedding=jpos),
               image)


def test_embedding_dropout_takes_jaxs_masks(monkeypatch):
  """Dropout 0.1 in training: JAX's Bernoulli keep masks (the embedding's,
  then each block's three) are captured and handed to the port."""
  config = _config(pool_type="tok", dropout=0.1, dtype_mm="float32",
                   attn_impl="xla")
  params = convert.init_params(config, seed=3)
  image = _image(3)
  masks = []
  bernoulli = jax.random.bernoulli

  def capture(key, p=0.5, shape=None, **kw):
    out = bernoulli(key, p, shape, **kw)
    jax.debug.callback(lambda m: masks.append(np.asarray(m)), out,
                       ordered=True)
    return out
  monkeypatch.setattr(jax.random, "bernoulli", capture)
  want, jout = _jax_model(config).apply(
      {"params": params}, image, train=True,
      rngs={"dropout": jax.random.PRNGKey(0)})
  jax.effects_barrier()
  assert len(masks) == 1 + 3 * SMALL["depth"]
  assert masks[0].shape == (2, 17, 64) and not masks[0].all()
  draws = iter(masks)

  def draw(shape):
    mask = next(draws)
    assert mask.shape == tuple(shape), (mask.shape, shape)
    return torch.from_numpy(np.array(mask))
  with torch.no_grad():
    model = _port_model(config, params)
    got, tout = model(torch.from_numpy(image), train=True, dropout_draw=draw)
    with pytest.raises(StopIteration):
      next(draws)
    _close(tout["encoded"], jout["encoded"], F32_TOL)
    _close(got, want, F32_TOL)
    # Without the draws a training forward raises; evaluation takes none.
    with pytest.raises(ValueError, match="dropout_draw"):
      model(torch.from_numpy(image), train=True)
    evaluated, _ = model(torch.from_numpy(image))
  jeval, _ = _jax_model(config).apply({"params": params}, image)
  _close(evaluated, jeval, F32_TOL)


def test_map_head_matches_jax():
  x = np.random.default_rng(4).standard_normal((3, 17, 64)).astype(
      np.float32)
  jhead = jvit.MAPHead(num_heads=4, mlp_dim=96)
  params = jhead.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
  params = jax.tree.map(
      lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(2), a.shape),
      params)  # live biases too
  want = jhead.apply({"params": params}, jnp.asarray(x))
  head = tvit.MAPHead(64, 96, 4)
  head.load_state_dict(convert.params_from_jax(
      jax.tree.map(np.asarray, params), head))
  with torch.no_grad():
    got = head(torch.from_numpy(x))
  assert got.dtype == torch.float32 and got.shape == (3, 64)
  _close(got, want, F32_TOL)


@pytest.mark.parametrize("h,w,width", [(4, 4, 64), (14, 14, 768), (3, 5, 32)])
def test_posemb_sincos_2d_matches_jax(h, w, width):
  want = jvit.posemb_sincos_2d(h, w, width)
  got = tvit.posemb_sincos_2d(h, w, width)
  assert got.shape == (1, h * w, width) and got.dtype == torch.float32
  # One f32 pow and sin/cos of arguments up to 13: an ulp or two.
  np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
  got16 = tvit.posemb_sincos_2d(h, w, width, dtype=torch.bfloat16)
  assert got16.dtype == torch.bfloat16


def test_resample_posemb_matches_jax():
  old = np.random.default_rng(5).standard_normal((1, 16, 32)).astype(
      np.float32)
  new = np.zeros((1, 49, 32), np.float32)
  want = jvit.resample_posemb(jnp.asarray(old), jnp.asarray(new))
  got = tvit.resample_posemb(torch.from_numpy(old), torch.from_numpy(new))
  assert got.shape == (1, 49, 32) and got.dtype == torch.float32
  np.testing.assert_array_equal(_np(got), _np(want))  # the same scipy call
  same = torch.from_numpy(old)
  assert tvit.resample_posemb(same, torch.zeros(1, 16, 32)) is same


def _flax_shapes(tree):
  return {k: tuple(v.shape) for k, v in tree_flatten_with_names(tree)}


@pytest.mark.parametrize("variant,pool_type", [("B/16", "tok"),
                                               ("H/14", "map")])
def test_variant_params_match_jax_init(variant, pool_type):
  """`ViT(variant=...)` at 224 px holds JAX's parameter names, shapes and
  count (scan=True: one traced block on the JAX side)."""
  kw = dict(num_classes=1000, pool_type=pool_type, scan=True)
  shapes = jax.eval_shape(lambda: jvit.ViT(variant=variant, **kw).init(
      jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))["params"]
  want = _flax_shapes(shapes)
  with torch.device("meta"):
    model = models.get_model_module("vit").Model(variant=variant, **kw)
  got = {}
  for name, t in model.state_dict().items():
    flax_name, conv = convert._flax_leaf(name, t.ndim)
    got[flax_name] = tuple(t.shape[i] for i in (2, 3, 1, 0)) if conv else (
        tuple(t.shape))
  assert got == want
  count = sum(int(np.prod(s)) for s in want.values())
  assert sum(p.numel() for p in model.parameters()) == count


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan", [False, True])
def test_conversion_round_trip_is_bit_exact(scan, dtype):
  """JAX's own init (the posemb and the class token in the stream's dtype,
  bf16 under bf16) into the port's state dict and back, in either block
  layout; the port then gives JAX's logits."""
  config = _config(pool_type="tok", rep_size=True, scan=scan,
                   dtype_mm=dtype, attn_impl="xla")
  image = _image(6)
  jmodel = _jax_model(config)
  params = jmodel.init(jax.random.PRNGKey(3), image)["params"]
  params = jax.tree.map(np.asarray, params)
  model = _port_model(config, params)
  assert model.pos_embedding.dtype == model.cls.dtype == {
      "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
  flat = dict(tree_flatten_with_names(params))
  for layout in (None, not scan, scan):
    back = dict(tree_flatten_with_names(
        convert.params_to_jax(model.state_dict(), stacked=layout)))
    ref = flat if layout in (None, scan) else dict(tree_flatten_with_names(
        convert.stack_blocks(params) if layout else
        convert.unstack_blocks(params)))
    assert set(back) == set(ref)
    for name, a in ref.items():
      np.testing.assert_array_equal(back[name], np.asarray(a, np.float32),
                                    err_msg=name)
  want, _ = jmodel.apply({"params": params}, image)
  with torch.no_grad():
    got, _ = model(torch.from_numpy(image))
  _close(got, want, F32_TOL if dtype == "float32" else BF16_LOGITS)


def test_build_model_builds_the_classifier():
  config = _config(pool_type="map")
  model = train_ae.build_model(config, device="meta")
  assert isinstance(model, tvit._ViT) and not model.training
  assert models.get_model_module("vit") is tvit
  with torch.device("meta"):
    b16 = models.get_model_module("vit").Model(variant="B/16")
  assert b16.embedding.weight.shape == (768, 3, 16, 16)
  assert b16.pos_embedding.shape == (1, 196, 768)
  assert b16.pos_embedding.dtype == torch.bfloat16
  assert len([n for n in b16.state_dict() if n.endswith(
      "LayerNorm_0.scale")]) == 12
  with pytest.raises(ValueError, match="pool type"):
    tvit.ViT(pool_type="cls")


def test_init_params_follow_jaxs_initialisers():
  """`init_train_params` through the classifier's `init_leaf`: zero head
  under `head_zeroinit` (the default), zero biases of the attention, unit
  LayerNorm scales, the posemb's scale 1/sqrt(width); `init_params` draws
  every leaf, those JAX zero-initialises too."""
  config = {"model_name": "vit", "model": dict(
      variant="S/16", num_classes=1000, pool_type="tok", image_size=64)}
  drawn = dict(tree_flatten_with_names(convert.init_params(config, 0)))
  assert all(a.any() for a in drawn.values())
  for name in ("cls", "head/kernel", "head/bias",
               "Transformer/blocks_00/MultiHeadAttention_0/query/bias"):
    assert np.all(drawn[name] != 0), name
  config["model"]["pool_type"] = "map"
  flat = dict(tree_flatten_with_names(convert.init_train_params(config, 0)))
  assert not flat["head/kernel"].any() and not flat["head/bias"].any()
  assert np.all(flat["Transformer/encoder_norm/scale"] == 1)
  assert not flat["Transformer/blocks_00/MultiHeadAttention_0/query/bias"
                  ].any()
  assert abs(flat["pos_embedding"].std() * np.sqrt(384) - 1) < 0.05
  live = dict(tree_flatten_with_names(convert.init_train_params(
      {"model_name": "vit", "model": dict(config["model"],
                                          head_zeroinit=False)}, 0)))
  assert abs(live["head/kernel"].std() * np.sqrt(384) - 1) < 0.05
