"""The port's pp ops, registry and builder against the JAX package's.

Host ops run on the same example with one `np.random.Generator` state
handed to both sides, and must agree exactly (outputs, and the generator
left in the same state): the crops, inception boxes draw for draw, the
general ops, randaug and autoaugment. The bilinear and nearest resizes are
held against the JAX op with TensorFlow (`tf.image.resize`, which the JAX
op calls where TensorFlow imports): at most 1 uint8 level off on at most
0.1 % of pixels; those tests skip where TensorFlow is absent. Device ops
run with the JAX op's own draws injected (the flip's Bernoulli draw,
mixup's Beta draw): f32 outputs within 1 ulp.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from small_vision_tpu.pp import autoaugment as jautoaugment
from small_vision_tpu.pp import builder as jbuilder
from small_vision_tpu.pp import ops_general as jgeneral
from small_vision_tpu.pp import ops_image as jimage
from small_vision_tpu.pp import registry as jregistry
from small_vision_tpu_torch.pp import autoaugment as tautoaugment
from small_vision_tpu_torch.pp import builder as tbuilder
from small_vision_tpu_torch.pp import ops_general as tgeneral
from small_vision_tpu_torch.pp import ops_image as timage
from small_vision_tpu_torch.pp import registry as tregistry

# Resize tolerance against TensorFlow: levels off, share of pixels off.
RESIZE_LEVELS, RESIZE_SHARE = 1, 1e-3


def _img(h=57, w=83, seed=1, dtype=np.uint8):
  rng = np.random.default_rng(seed)
  if dtype == np.uint8:
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
  return (rng.random((h, w, 3)) * 255).astype(dtype)


def _encoded(img, fmt="JPEG"):
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, format=fmt, quality=90)
  return buf.getvalue()


def _both(spec, example, seed=42):
  """(port output, JAX output) of the host stage of `spec` on copies of
  `example`, each with its own generator seeded `seed`; the two generators
  must be left in the same state."""
  outs = []
  for builder in (tbuilder, jbuilder):
    ex = {k: (np.copy(v) if isinstance(v, np.ndarray) else v)
          for k, v in example.items()}
    ex["_rng"] = np.random.default_rng(seed)
    out = builder.get_preprocess_fn(spec)[0](ex)
    outs.append((out, out["_rng"].integers(0, 2**62)))
  (tout, tnext), (jout, jnext) = outs
  assert tnext == jnext, "the generators were left in different states"
  return tout, jout


def _assert_same(tout, jout):
  assert set(tout) == set(jout)
  for k in jout:
    if k == "_rng":
      continue
    np.testing.assert_array_equal(np.asarray(tout[k]), np.asarray(jout[k]))
    assert np.asarray(tout[k]).dtype == np.asarray(jout[k]).dtype, k


# -- the registry and the builder ---------------------------------------------


@pytest.mark.parametrize("spec", [
    "flip_lr", "resize(64)", 'crop(8, pad=4, mode="x")', "value_range(-1, 1)",
    'keep("image", "label")', "resize((32, 48), method='nearest')",
    "fn(x)", "a.b()", "fn(**kw)", "3+4"])
def test_parse_name_matches_jax(spec):
  def outcome(parse):
    try:
      return parse(spec)
    except (ValueError, SyntaxError) as e:
      return type(e).__name__
  assert outcome(tregistry.parse_name) == outcome(jregistry.parse_name)


def test_registry_stages_and_temporary_ops():
  for name in ("decode", "resize", "inception_crop", "central_crop",
               "decode_jpeg_and_inception_crop", "flip_lr", "value_range",
               "onehot", "mixup", "keep", "drop", "copy", "concat",
               "randaug", "autoaugment", "vgg_value_range", "lookup"):
    assert tregistry._REGISTRY[name].stage == \
        jregistry._REGISTRY[name].stage, name
  with tregistry.temporary_ops(
      double=lambda: lambda d: {**d, "x": d["x"] * 2}):
    fn, stage = tregistry.Registry.lookup("double")
    assert stage == "host" and fn({"x": 3})["x"] == 6
  assert not tregistry.Registry.knows("double")
  with pytest.raises(KeyError, match="already registered"):
    tregistry.Registry.register("resize")(lambda: None)
  with pytest.raises(KeyError, match="Unknown pp op"):
    tregistry.Registry.lookup("no_such_op(1)")


@pytest.mark.parametrize("spec", [
    "", "||resize(32)|||", "decode|resize(8)|flip_lr|value_range(-1, 1)",
    'keep("image")|resize(8)|flip_lr|drop("x")|value_range',
    'copy("image", "im2")|flip_lr|copy("image", "im3")',
    "flip_lr|value_range(-1, 1)|onehot(10, key=\"label\")"])
def test_split_stages_matches_jax(spec):
  assert tbuilder.split_stages(spec) == jbuilder.split_stages(spec)


def test_preprocess_fn_binds_stages_and_refuses_host_after_device():
  host, device_pp = tbuilder.get_preprocess_fn(
      'copy("image", "raw")|resize(8)|flip_lr|copy("image", "flat")'
      '|value_range(-1, 1)|keep("image", "raw", "flat")')
  ex = host({"image": _img(), "label": np.int64(1),
             "_rng": np.random.default_rng(0)})
  assert ex["image"].shape == (8, 8, 3) and ex["raw"].shape == (57, 83, 3)
  assert [spec for spec, _, _ in device_pp.ops] == [
      "flip_lr", 'copy("image", "flat")', "value_range(-1, 1)",
      'keep("image", "raw", "flat")']
  batch = {"image": torch.from_numpy(np.stack([ex["image"]] * 2)),
           "raw": torch.zeros(2), "label": torch.zeros(2), "_id": torch.ones(2)}
  out = device_pp(batch, {"flip": torch.tensor([True, False])})
  assert set(out) == {"image", "raw", "flat", "_id"}
  assert out["flat"].dtype == torch.uint8  # copied before value_range
  torch.testing.assert_close(out["image"],
                             out["flat"].float() / 255 * 2 - 1)
  torch.testing.assert_close(out["flat"][0], torch.from_numpy(
      ex["image"]).flip(1))  # the first row was flipped, before the copy
  for spec in ("value_range(-1, 1)|resize(32)", "flip_lr|keep('x')|decode"):
    with pytest.raises(ValueError, match="after device ops"):
      tbuilder.get_preprocess_fn(spec)
    with pytest.raises(ValueError, match="after device ops"):
      jbuilder.get_preprocess_fn(spec)
  host, device_pp = tbuilder.get_preprocess_fn("resize(4)")
  assert device_pp.ops == [] and device_pp.draw(3, None, "cpu") == {}
  with pytest.raises(TypeError, match="dict"):
    host([1])
  with pytest.raises(RuntimeError, match="resize"):
    host({"image": "not an image"})


# -- host image ops --------------------------------------------------------


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_decode_matches_jax(fmt):
  raw = _encoded(_img(40, 30), fmt)
  tout, jout = _both("decode", {"image": raw})
  _assert_same(tout, jout)
  assert tout["image"].shape == (40, 30, 3)
  tout, jout = _both("decode", {"image": np.frombuffer(raw, np.uint8)})
  _assert_same(tout, jout)  # an array of the bytes is decoded too


def _tf_or_skip():
  pytest.importorskip("tensorflow",
                      reason="the JAX op resizes with TensorFlow only "
                             "where TensorFlow is installed")


def _assert_resize_close(got, want):
  assert got.shape == want.shape and got.dtype == want.dtype
  off = np.abs(got.astype(np.int64) - want.astype(np.int64))
  assert off.max() <= RESIZE_LEVELS
  assert (off > 0).mean() <= RESIZE_SHARE


@pytest.mark.parametrize("spec", [
    "resize(64)", "resize((17, 120))", "resize(9, method='nearest')",
    "resize((100, 3), method='nearest')", "resize_small(40)",
    "resize_small(100)", "resize_long(64)", "resize_long(20, 'nearest')",
    "resize(1)"])
@pytest.mark.parametrize("shape", [(57, 83), (128, 96), (5, 300), (1, 1)])
def test_resize_matches_jax_with_tensorflow(spec, shape):
  _tf_or_skip()
  try:
    jbuilder.get_preprocess_fn(spec)[0]({"image": _img(*shape)})
  except RuntimeError:  # an output side of 0: TensorFlow refuses it
    with pytest.raises(RuntimeError, match="must be positive"):
      tbuilder.get_preprocess_fn(spec)[0]({"image": _img(*shape)})
    return
  tout, jout = _both(spec, {"image": _img(*shape)})
  _assert_resize_close(tout["image"], jout["image"])


def test_resize_of_float_images_matches_jax_with_tensorflow():
  _tf_or_skip()
  img = _img(31, 45, dtype=np.float32)
  for spec in ("resize((20, 70))", "resize(8, method='nearest')"):
    tout, jout = _both(spec, {"image": img})
    assert tout["image"].dtype == jout["image"].dtype
    np.testing.assert_allclose(tout["image"], jout["image"], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("method", ["bicubic", "area"])
def test_pil_resizes_match_jax(method):
  tout, jout = _both(f"resize((33, 21), method='{method}')",
                     {"image": _img()})
  _assert_same(tout, jout)


@pytest.mark.parametrize("area_min,area_max", [(5, 100), (80, 100),
                                               (50, 60), (100, 100)])
@pytest.mark.parametrize("shape", [(128, 96), (375, 500), (7, 300), (2, 2)])
def test_inception_boxes_match_jax_draw_for_draw(area_min, area_max, shape):
  for seed in range(20):
    trng, jrng = (np.random.default_rng(seed) for _ in range(2))
    for _ in range(3):
      assert timage._sample_inception_box(trng, *shape, area_min, area_max) \
          == jimage._sample_inception_box(jrng, *shape, area_min, area_max)
    assert trng.integers(0, 2**62) == jrng.integers(0, 2**62)


@pytest.mark.parametrize("spec,resizes", [
    ("inception_crop", False), ("inception_crop(32)", True),
    ("inception_crop(size=16, area_min=80)", True),
    ("inception_crop((24, 40), 50, 90, method='nearest')", True)])
def test_inception_crop_matches_jax(spec, resizes):
  if resizes:
    _tf_or_skip()
  for seed in range(5):
    tout, jout = _both(spec, {"image": _img(90, 70, seed)}, seed=seed)
    _assert_same(tout, jout)


@pytest.mark.parametrize("spec", [
    "central_crop(50)", "central_crop((40, 20))", "central_crop(100)",
    "central_crop((30, 90))", "random_crop(40)", "random_crop((57, 10))",
    "grayscale", "grayscale(keep_channels=False)"])
def test_crops_and_grayscale_match_jax(spec):
  for seed in range(3):
    tout, jout = _both(spec, {"image": _img(57, 83, seed)}, seed=seed)
    _assert_same(tout, jout)


def test_decode_jpeg_and_inception_crop_on_decoded_images_matches_jax():
  _tf_or_skip()
  spec = "decode_jpeg_and_inception_crop(size=32, area_min=40)"
  for seed in range(4):
    tout, jout = _both(spec, {"image": _img(120, 90, seed)}, seed=seed)
    _assert_same(tout, jout)


# -- host general ops --------------------------------------------------------


def test_general_host_ops_match_jax(tmp_path):
  names = tmp_path / "names.txt"
  names.write_text("cat\ndog\nemu\n")
  pairs = tmp_path / "pairs.txt"
  pairs.write_text("cat:7\ndog:3\n")
  npz = tmp_path / "names.npz"
  np.savez(npz, fnames=np.array([b"x", b"y", b"cat"]))
  example = {"image": _img(6, 5), "a": np.arange(6).reshape(2, 3),
             "b": np.ones((2, 2), np.int64), "name": b"cat",
             "col": np.arange(4).reshape(4, 1), "nest": None, "label": 3}
  specs = [
      'concat(("a", "b"), "ab")', 'concat(["a", "a"], "aa", axis=0)',
      'setdefault("label", 5)', 'setdefault("missing", [1, 2])',
      f'lookup("{names}", key="name")', f'lookup("{pairs}", sep=":", '
      'inkey="name", outkey="idx")', f'lookup("{npz}", inkey="name", '
      'outkey="i")', 'lookup({"cat": 1}, inkey="name", outkey="j")',
      'squeeze_last_dim(key="col")', 'pad_to_shape((4, 5), key="a")',
      'pad_to_shape((3, None), 9, "both", key="b")',
      'pad_to_shape((5, 3), where="before", key="a")',
      'reshape((3, 2), key="a")', 'reshape([-1], inkey="a", outkey="flat")',
      'choice(key="a")', 'choice(2, key="image")',
      'choice(9, key="a", fewer_ok=True)', 'copy("a", "a2")',
      'keep("a", "image")', 'drop("image", "name")']
  for spec in specs:
    ex = dict(example)
    ex.pop("nest")
    tout, jout = _both(spec, ex)
    _assert_same(tout, jout)
  nested = {"x": {"y": np.ones(2), "z": {"w": 1}}, "v": 2}
  assert tbuilder.get_preprocess_fn("flatten")[0](dict(nested)).keys() == \
      jbuilder.get_preprocess_fn("flatten")[0](dict(nested)).keys() == \
      {"x/y", "x/z/w", "v"}
  with pytest.raises(RuntimeError, match="exceeds"):
    tbuilder.get_preprocess_fn('pad_to_shape((1, 1), key="a")')[0](
        {"a": np.zeros((2, 2))})


@pytest.mark.parametrize("spec", ["randaug", "randaug(3, 7)",
                                  "randaug(num_layers=4, magnitude=5)",
                                  'autoaugment("v0")', 'autoaugment("test")'])
def test_randaug_and_autoaugment_match_jax(spec):
  for seed in range(12):
    tout, jout = _both(spec, {"image": _img(40, 48, seed)}, seed=seed)
    _assert_same(tout, jout)
  assert tautoaugment.RANDAUG_OPS == jautoaugment.RANDAUG_OPS
  with pytest.raises(ValueError, match="Invalid"):
    tautoaugment.distort_image_with_autoaugment(_img(), "v9",
                                                np.random.default_rng(0))


# -- device ops ---------------------------------------------------------------


def _ulps(got, want):
  """|got - want| in units of the f32 spacing at |want|."""
  want = np.asarray(want, np.float32)
  return np.abs(np.asarray(got, np.float64) - want) / np.spacing(
      np.maximum(np.abs(want), np.float32(1e-30)))


def test_flip_lr_with_the_jax_draw_matches_jax():
  images = _img(16, 16)[None].repeat(7, 0)
  images[:, :, 0] = 0  # rows that differ from their flip
  key = jax.random.PRNGKey(11)
  want = jimage.get_flip_lr()({"image": jnp.asarray(images)}, key)["image"]
  flip = np.asarray(jax.random.bernoulli(key, 0.5, (7,)))
  apply, draw = timage.get_flip_lr()
  got = apply({"image": torch.from_numpy(images)},
              {"flip": torch.from_numpy(flip)})["image"]
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  d = draw(7, torch.Generator().manual_seed(0), "cpu")["flip"]
  assert d.dtype == torch.bool and d.shape == (7,)


@pytest.mark.parametrize("p", [0.1, 0.5, 2.0])
def test_mixup_with_the_jax_draw_matches_jax(p):
  rng = np.random.default_rng(3)
  batch = {"image": rng.standard_normal((6, 8, 8, 3)).astype(np.float32),
           "label": rng.random((6, 10)).astype(np.float32)}
  key = jax.random.PRNGKey(int(p * 10))
  jout = jgeneral.get_mixup(p, fold_in=("image", "label"))(
      {k: jnp.asarray(v) for k, v in batch.items()}, key)
  beta = np.asarray(jax.random.beta(key, p, p))  # the op's own draw
  apply, draw = tgeneral.get_mixup(p, fold_in=("image", "label"))
  tout = apply({k: torch.from_numpy(v) for k, v in batch.items()},
               {"mixup_beta": torch.from_numpy(beta)})
  assert set(tout) == set(jout)
  for k in jout:
    assert _ulps(tout[k].numpy(), jout[k]).max() <= 1, k
  assert float(tout["_mixup_a"]) >= 0.5


@pytest.mark.parametrize("p", [0.1, 1.0, 3.0])
def test_mixup_beta_draws_have_the_beta_moments(p):
  """4,000 draws of the port's Beta(p, p) from a seeded generator: mean
  1/2 and variance 1/(4 (2p + 1)), within 4 standard errors."""
  gen = torch.Generator().manual_seed(0)
  draws = torch.stack([tgeneral._beta(p, gen, "cpu") for _ in range(4000)])
  assert ((draws >= 0) & (draws <= 1)).all()
  var = 1 / (4 * (2 * p + 1))
  assert abs(draws.mean().item() - 0.5) < 4 * (var / 4000) ** 0.5
  assert abs(draws.var().item() - var) < 0.1 * var


def test_value_range_and_normalizations_match_jax():
  images = _img(8, 8)[None].repeat(3, 0)
  key = jax.random.PRNGKey(0)
  for name, args in (("value_range", (-1, 1)), ("value_range", (0, 1, 10,
                                                                 200, True)),
                     ("vgg_value_range", ()), ("clip_value_range", ())):
    module_t = tgeneral if name == "value_range" else timage
    module_j = jgeneral if name == "value_range" else jimage
    want = getattr(module_j, f"get_{name}")(*args)(
        {"image": jnp.asarray(images)}, key)["image"]
    apply, draw = getattr(module_t, f"get_{name}")(*args)
    assert draw is None
    got = apply({"image": torch.from_numpy(images)}, {})["image"]
    assert got.dtype == torch.float32
    assert _ulps(got.numpy(), want).max() <= 1, name


@pytest.mark.parametrize("labels,kw", [
    (np.array([0, 3, 9]), {}), (np.array([[0, 3], [1, 1], [9, 2]]), {}),
    (np.array([[0, 3], [1, 1]]), dict(multi=False)),
    (np.array([4, 2]), dict(on=0.9, off=0.01, key_result="oh"))])
def test_onehot_matches_jax(labels, kw):
  want = jgeneral.get_onehot(10, key="label", **kw)(
      {"label": jnp.asarray(labels)}, None)
  apply, _ = tgeneral.get_onehot(10, key="label", **kw)
  got = apply({"label": torch.from_numpy(labels)}, {})
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
