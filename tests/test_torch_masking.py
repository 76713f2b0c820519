"""Port parity: MAE masking, the masked model forward and `dual_forward`,
and the train step's data (the synthetic source and the device pp).

`random_masking`, `restore_masked` and `sequence_mask_to_image_mask` are
held against the JAX functions with the same uniform noise: indices
exactly equal, kept tokens and the restored sequence bitwise equal. The
model with `mask` > 0 and `dual_forward` are held against the JAX module
(Pallas in interpret mode) with the masking draws the JAX module made,
recovered as tests/test_torch_train_step.py recovers them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.data import synthetic as jsynthetic
from small_vision_tpu.ops import masking as jmask
from small_vision_tpu.pp import ops_general as jpp_general
from small_vision_tpu.pp import ops_image as jpp_image
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.data import pipeline as tpipeline
from small_vision_tpu_torch.data import synthetic as tsynthetic
from small_vision_tpu_torch.ops import masking as tmask
from small_vision_tpu_torch.pp.builder import DevicePP
from test_torch_models import DTYPES, TOL, _close, jax_model, small_config
from test_torch_models import torch_model
from test_torch_train_step import install_capture


@pytest.mark.parametrize("ratio", [0.375, 0.75])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masking_matches_jax_exactly(ratio, dtype):
  jdt, tdt = DTYPES[dtype]
  rng = np.random.default_rng(0)
  x = rng.standard_normal((3, 256, 8)).astype(np.float32)
  key = jax.random.PRNGKey(int(ratio * 8))
  noise = np.asarray(jax.random.uniform(key, (3, 256)))  # as JAX draws it
  jx, jm, jids = jmask.random_masking(jnp.asarray(x, jdt), ratio, key)
  tx, tm, tids = tmask.random_masking(torch.from_numpy(x).to(tdt), ratio,
                                      torch.from_numpy(noise))
  np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
  assert tx.dtype == tdt and tm.dtype == tdt
  np.testing.assert_array_equal(tx.float().numpy(),
                                np.asarray(jx.astype(jnp.float32)))
  np.testing.assert_array_equal(tm.float().numpy(),
                                np.asarray(jm.astype(jnp.float32)))
  assert int(tm.sum()) == 3 * (256 - int(256 * (1 - ratio)))

  token = rng.standard_normal((1, 1, 8)).astype(np.float32)
  jfull = jmask.restore_masked(jx, jnp.asarray(token), jids)
  tfull = tmask.restore_masked(tx, torch.from_numpy(token), tids)
  np.testing.assert_array_equal(tfull.float().numpy(),
                                np.asarray(jfull.astype(jnp.float32)))

  jimg = jmask.sequence_mask_to_image_mask(jm, 4, 64)
  timg = tmask.sequence_mask_to_image_mask(tm, 4, 64)
  assert timg.shape == (3, 64, 64, 1)
  np.testing.assert_array_equal(timg.float().numpy(),
                                np.asarray(jimg.astype(jnp.float32)))


def test_masking_is_stable_on_ties():
  """Equal draws keep their order, as jnp.argsort's stable sort does."""
  x = torch.arange(6.0).reshape(1, 6, 1)
  noise = torch.tensor([[0.5, 0.5, 0.1, 0.5, 0.1, 0.9]])
  kept, _, ids = tmask.random_masking(x, 0.5, noise)
  assert kept.flatten().tolist() == [2.0, 4.0, 0.0]
  np.testing.assert_array_equal(
      ids.numpy(), np.argsort(np.argsort(noise.numpy(), kind="stable"),
                              kind="stable"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_forward_matches_jax(monkeypatch, dtype):
  cap = install_capture(monkeypatch)
  config = small_config(labels=True, dtype=dtype)
  params = convert.init_params(config, seed=4)
  rng = np.random.default_rng(5)
  image = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
  t = np.array([0, 400, 1000], np.int32)
  y = np.array([3, 999, 7], np.int32)
  want, jout = jax_model(config).apply(
      {"params": params}, image, t=t, y=y, mask=0.75,
      rngs={"mae_noise": jax.random.PRNGKey(9)})
  jax.effects_barrier()
  got, tout = torch_model(config, params)(
      torch.from_numpy(image), t=torch.from_numpy(t).long(),
      y=torch.from_numpy(y).long(), mask=0.75,
      mask_noise=torch.from_numpy(cap.uniforms[0.75]))
  np.testing.assert_array_equal(tout["mask"].float().numpy(),
                                np.asarray(jout["mask"], np.float32))
  _close(got.numpy(), np.asarray(want), TOL[dtype])
  _close(tout["pre_logits"].float().numpy(),
         np.asarray(jout["pre_logits"], np.float32), TOL[dtype])


def test_dual_forward_matches_jax(monkeypatch):
  """The shared-decoder training forward: the clean MAE branch at mask
  0.75 and t=0, the noised branch at 0.375 with labels, one label-drop
  draw over the joint batch (training mode)."""
  cap = install_capture(monkeypatch)
  config = small_config(labels=True)
  params = convert.init_params(config, seed=6)
  rng = np.random.default_rng(7)
  img_a = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
  img_b = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
  t_b = np.array([5, 500, 999], np.int32)
  y_b = np.array([1, 2, 3], np.int32)
  keys = {"mae_noise": jax.random.PRNGKey(1), "cfg": jax.random.PRNGKey(2),
          "dropout": jax.random.PRNGKey(3)}
  want, jout_a, jout_b = jax_model(config).apply(
      {"params": params}, img_a, img_b, t_b=t_b, y_b=y_b, mask_a=0.75,
      mask_b=0.375, train=True, method="dual_forward", rngs=keys)
  jax.effects_barrier()
  (drop,) = cap.drops
  model = torch_model(config, params)
  got, out_a, out_b = model.dual_forward(
      torch.from_numpy(img_a), torch.from_numpy(img_b),
      t_b=torch.from_numpy(t_b).long(), y_b=torch.from_numpy(y_b).long(),
      mask_a=0.75, mask_b=0.375, train=True,
      noise_a=torch.from_numpy(cap.uniforms[0.75]),
      noise_b=torch.from_numpy(cap.uniforms[0.375]),
      label_drop=torch.from_numpy(drop))
  assert got.shape == (5, 16, 16, 6)
  _close(got.numpy(), np.asarray(want), TOL["float32"])
  for t_out, j_out in ((out_a, jout_a), (out_b, jout_b)):
    np.testing.assert_array_equal(t_out["mask"].numpy(),
                                  np.asarray(j_out["mask"]))
  with pytest.raises(ValueError, match="train=True"):
    model(torch.from_numpy(img_b), label_drop=torch.from_numpy(drop[2:]))


def test_synthetic_source_matches_jax():
  kw = dict(img_size=16, num_examples=100, pool=40, seed=17)
  jsrc = jsynthetic.DataSource(**kw)
  tsrc = tsynthetic.DataSource(**kw)
  want = list(jsrc.examples(seed=3, epoch=2))
  got = list(tsrc.examples(seed=3, epoch=2))
  for key in ("_id", "image", "label"):
    np.testing.assert_array_equal(np.stack([e[key] for e in got]),
                                  np.stack([e[key] for e in want]))
  # The train iterator runs the epochs back to back: its second batch of
  # 64 spans epochs 0 and 1.
  batches = iter(tpipeline.TrainIterator(tsrc, "", 64, device="cpu", seed=3,
                                         num_workers=1))
  first, second = next(batches), next(batches)
  batches.close()
  order = np.concatenate([[int(e["_id"]) for e in
                           jsrc.examples(seed=3, epoch=e)] for e in (0, 1)])
  np.testing.assert_array_equal(second["_id"].numpy(), order[64:128])
  np.testing.assert_array_equal(second["label"].numpy(), order[64:128] % 1000)
  assert first["image"].dtype == torch.uint8


def test_device_pp_matches_jax():
  """flip_lr then value_range(-1, 1), with the JAX op's own flip draw."""
  rng = np.random.default_rng(8)
  images = rng.integers(0, 256, (6, 8, 8, 3), dtype=np.uint8)
  key = jax.random.PRNGKey(4)
  jbatch = jpp_image.get_flip_lr()({"image": jnp.asarray(images)}, key)
  jbatch = jpp_general.get_value_range(-1, 1)(jbatch, None)
  flip = np.asarray(jax.random.bernoulli(key, 0.5, (6,)))  # the op's draw
  assert flip.any() and not flip.all()
  pp = DevicePP('|flip_lr|value_range(-1, 1)|keep("image", "label")')
  out = pp({"image": torch.from_numpy(images), "label": torch.arange(6),
            "other": 1}, {"flip": torch.from_numpy(flip)})
  assert set(out) == {"image", "label"} and out["image"].dtype == \
      torch.float32
  np.testing.assert_array_equal(out["image"].numpy(),
                                np.asarray(jbatch["image"]))
  draws = pp.draw(6, torch.Generator().manual_seed(0), "cpu")
  assert set(draws) == {"flip"} and draws["flip"].dtype == torch.bool
  with pytest.raises(ValueError, match="host op"):
    DevicePP("decode|flip_lr")
