"""Port parity: `data/latents.py` (the TFRecord latent source without
TensorFlow, and `precompute_latents` into an `arrays` split) against
small_vision_tpu.data.latents, and a latent training step on the written
latents against the JAX `make_update_fn`.

  - The fixture `tests/data/latents_fixture-00000.tfrecord` (4 records)
    is what the JAX writer writes from `fixture_latents` (the latents of
    batch k drawn by numpy with seed 1000 + k, labels 3i + 1): the test
    writes it again and compares every record's features (protobuf may
    order a map's entries either way, so not the bytes). `chip_smoke.py` reads it on
    the card's machine, which has no TensorFlow.
  - The reader on TFRecords written by the JAX `precompute_latents` (8
    records over 3 files): in ordered mode every record and `_id` equal
    to the JAX `DataSource`'s (TensorFlow's reader), and `peek`; the data
    CRCs check; a process shard is the strided slice tf.data's `shard`
    takes; the shuffled order a permutation per (seed, epoch). These skip
    without TensorFlow.
  - The hand decoder on an unpacked Example (a fixed32 field a float and a
    varint label, a legal protobuf encoding that TF's writer does not
    emit), and corrupt records: a wrong length CRC raises; a wrong data
    byte raises with `check_data_crc`.
  - The writer: `precompute_latents` with the tiny VAE (channels 32 x 4,
    32 px images, (4, 4, 4) latents) and injected noise against the JAX
    writer's latents with the same noise, view-major, 2 views of 3 batches
    of 2: within 1e-5 of the largest magnitude (tests/test_torch_vae.py's
    f32 bound), labels exactly.
  - The step: one UMD step with `use_preprocessed_latents` on the first 8
    written latents, read back through the `arrays` source, against the
    JAX step with `use_preprocessed_latents` on the same latents and
    draws: the loss within rtol 1e-5, the gradients' norm within 1e-4,
    each step-1 gradient leaf within 2e-5 of its max
    (tests/test_torch_latent.py's bounds).
"""

import glob
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_latent import (B, LATENT, TINY, _jax_step, _port_step,
                               jax_vae_fns, latent_config)
from test_torch_train_step import check_step1_grads, flat, install_capture

from small_vision_tpu import optim as joptim
from small_vision_tpu.data import latents as jlatents
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.data import core as tcore
from small_vision_tpu_torch.data import latents
from small_vision_tpu_torch.models import vae as tvae

TESTS = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(TESTS, "data", "latents_fixture")
FIXTURE_RECORDS, FIXTURE_BATCH = 4, 2


class _Source:
  """The minimal source both writers read: `images` in order, labels 3i+1."""

  def __init__(self, images):
    self.images = images

  @property
  def total_examples(self):
    return len(self.images)

  def examples(self, *, ordered=False, seed=0, epoch=0):
    del ordered, seed, epoch
    for i, image in enumerate(self.images):
      yield {"image": image, "label": np.int64(3 * i + 1)}


def fixture_latents(k, b):
  """The latents the fixture's `vae_apply` returns at its k-th call
  (chip_smoke.py draws the same)."""
  return np.random.default_rng(1000 + k).standard_normal(
      (b, 32, 32, 4)).astype(np.float32)


def _jax_write(pattern, n, batch, views, per_shard=50_000):
  """The JAX writer on n blank images and `fixture_latents`."""
  pytest.importorskip("tensorflow")
  calls = []

  def vae_apply(images, key):
    del key
    calls.append(1)
    return fixture_latents(len(calls) - 1, images.shape[0])
  jlatents.precompute_latents(
      _Source(np.zeros((n, 2, 2, 3), np.float32)), vae_apply, pattern,
      batch_size=batch, views=views, examples_per_shard=per_shard)
  return sorted(glob.glob(pattern + "-*.tfrecord"))


def _features(path):
  """Each record's features as {name: bytes}: protobuf leaves the order of
  a map's entries to the writer, so records compare by feature."""
  return [{k: bytes(v) for k, v in latents.parse_example(r).items()}
          for r in latents.read_records(path, check_data_crc=True)]


def test_fixture_is_the_jax_writers(tmp_path):
  (path,) = _jax_write(str(tmp_path / "f"), FIXTURE_RECORDS, FIXTURE_BATCH,
                       views=1)
  assert _features(path) == _features(FIXTURE + "-00000.tfrecord")
  src = latents.DataSource(pattern=FIXTURE + "-*.tfrecord",
                           check_data_crc=True)
  got = list(src.examples(ordered=True))
  want = np.concatenate([fixture_latents(k, FIXTURE_BATCH) for k in
                         range(FIXTURE_RECORDS // FIXTURE_BATCH)])
  assert len(got) == src.total_examples == FIXTURE_RECORDS
  for i, ex in enumerate(got):
    np.testing.assert_array_equal(ex["image"], want[i])
    assert ex["label"] == 3 * i + 1 and ex["_id"] == i


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
  pattern = str(tmp_path_factory.mktemp("latents") / "lat")
  files = _jax_write(pattern, 4, 2, views=2, per_shard=3)
  return pattern + "-*.tfrecord", files


def test_reader_matches_the_jax_source(jax_records):
  pattern, files = jax_records
  assert len(files) == 3
  port = latents.DataSource(pattern=pattern, check_data_crc=True)
  jsrc = jlatents.DataSource(pattern=pattern)
  assert port.total_examples == jsrc.total_examples == 8
  got = list(port.examples(ordered=True))
  want = list(jsrc.examples(ordered=True))
  assert len(got) == len(want) == 8
  for g, w in zip(got, want):
    assert sorted(g) == sorted(w) == ["_id", "image", "label"]
    np.testing.assert_array_equal(g["image"], w["image"])
    assert g["image"].dtype == np.float32 and g["image"].shape == (32, 32, 4)
    assert g["label"] == w["label"] and g["_id"] == w["_id"]
  for key in ("image", "label", "_id"):
    np.testing.assert_array_equal(port.peek()[key], jsrc.peek()[key])
  # A process's shard: tf.data's strided `shard`, _ids its own positions.
  tcore.set_process_shard(1, 3)
  try:
    mine = list(port.examples(ordered=True))
  finally:
    tcore.set_process_shard(None)
  assert [int(e["_id"]) for e in mine] == [0, 1, 2]
  for e, w in zip(mine, want[1::3]):
    np.testing.assert_array_equal(e["image"], w["image"])
  # Shuffled: a permutation per (seed, epoch).
  order = lambda s, e: [int(x["label"]) * 1000 + int(x["image"][0, 0, 0] *
                                                     1e3)
                        for x in port.examples(seed=s, epoch=e)]
  ordered = [int(x["label"]) * 1000 + int(x["image"][0, 0, 0] * 1e3)
             for x in got]
  assert sorted(order(0, 0)) == sorted(ordered)
  assert order(0, 0) == order(0, 0) != order(0, 1)


def _field(number, wire, payload):
  key = bytes(_varint(number << 3 | wire))
  if wire == 2:
    return key + bytes(_varint(len(payload))) + payload
  return key + payload


def _varint(x):
  out = []
  while True:
    b = x & 0x7F
    x >>= 7
    out.append(b | (0x80 if x else 0))
    if not x:
      return out


def _frame(data):
  length = struct.pack("<Q", len(data))
  return (length + struct.pack("<I", latents.masked_crc(length)) + data
          + struct.pack("<I", latents.masked_crc(data)))


def test_unpacked_example_and_corrupt_records(tmp_path):
  values = np.arange(4096, dtype=np.float32) / 7
  floats = b"".join(_field(1, 5, struct.pack("<f", v)) for v in values)
  label = _field(1, 0, bytes(_varint(2**64 - 5)))  # int64 -5 as a varint
  feature = lambda name, kind, lst: _field(1, 2, _field(1, 2, name) + _field(
      2, 2, _field(kind, 2, lst)))
  example = _field(1, 2, feature(b"label", 3, label)
                   + feature(b"image", 2, floats))
  path = str(tmp_path / "u.tfrecord")
  with open(path, "wb") as f:
    f.write(_frame(example) * 2)
  got = list(latents.DataSource(pattern=path,
                                check_data_crc=True).examples(ordered=True))
  assert len(got) == 2 and got[1]["_id"] == 1
  np.testing.assert_array_equal(got[0]["image"].ravel(), values)
  assert got[0]["label"] == -5
  raw = bytearray(_frame(example))
  bad_data = bytes(raw[:20]) + bytes([raw[20] ^ 1]) + bytes(raw[21:])
  with open(path, "wb") as f:
    f.write(bad_data)
  with pytest.raises(ValueError, match="corrupt record data"):
    list(latents.read_records(path, check_data_crc=True))
  assert len(list(latents.read_records(path))) == 1  # the data CRC is opt-in
  raw[8] ^= 1
  with open(path, "wb") as f:
    f.write(bytes(raw))
  with pytest.raises(ValueError, match="corrupt record length"):
    list(latents.read_records(path))


N_IMAGES, WRITE_BATCH, VIEWS = 6, 2, 2


@pytest.fixture(scope="module")
def written(tmp_path_factory):
  """The port's and the JAX writer's latents of the same images and noise,
  with the tiny VAE; (port arrays root, JAX latents (flat), JAX labels,
  VAE)."""
  pytest.importorskip("tensorflow")
  tmp = tmp_path_factory.mktemp("written")
  rng = np.random.default_rng(4)
  images = np.clip(rng.standard_normal((N_IMAGES, 32, 32, 3)) * 0.5, -1,
                   1).astype(np.float32)
  calls = N_IMAGES // WRITE_BATCH * VIEWS
  noise = rng.standard_normal((calls, WRITE_BATCH) + LATENT).astype(
      np.float32)
  params, enc, dec = tvae.load_vae(device="cpu", seed=2,
                                   block_out_channels=TINY)
  jmodel = tvae.AutoencoderKL  # noqa: F841 (the port's; JAX's below)
  from small_vision_tpu.models import vae as jvae
  jmodel = jvae.AutoencoderKL(block_out_channels=TINY)
  jparams = convert.vae_to_jax(params)
  port_calls, jax_calls = [], []

  def port_encode(batch, generator):
    assert isinstance(generator, torch.Generator)
    port_calls.append(1)
    return enc(params, torch.from_numpy(noise[len(port_calls) - 1]),
               torch.from_numpy(batch))

  def jax_encode(batch, key):
    del key
    jax_calls.append(1)
    jenc, _ = jax_vae_fns(jmodel, jnp.asarray(noise[len(jax_calls) - 1]))
    return jenc(jparams, None, jnp.asarray(batch))

  root = str(tmp / "arrays" / "train")
  n = latents.precompute_latents(_Source(images), port_encode, root,
                                 batch_size=WRITE_BATCH, views=VIEWS,
                                 device="cpu")
  assert n == N_IMAGES * VIEWS
  pattern = str(tmp / "jax")
  jlatents.precompute_latents(_Source(images), jax_encode, pattern,
                              batch_size=WRITE_BATCH, views=VIEWS)
  flats, labels = [], []
  for path in sorted(glob.glob(pattern + "-*.tfrecord")):
    for record in latents.read_records(path, check_data_crc=True):
      feats = latents.parse_example(record)
      flats.append(latents._values(feats["image"], 2))
      labels.append(int(latents._values(feats["label"], 3)[0]))
  return root, np.stack(flats).reshape((-1,) + LATENT), np.array(labels), (
      params, enc, dec, jmodel, jparams)


def test_writer_matches_the_jax_writer(written):
  root, want, want_labels, _ = written
  got = np.load(os.path.join(root, "images.npy"))
  assert got.shape == want.shape == (N_IMAGES * VIEWS,) + LATENT
  err = np.max(np.abs(got - want)) / np.max(np.abs(want))
  assert err <= 1e-5, err
  labels = np.load(os.path.join(root, "labels.npy"))
  np.testing.assert_array_equal(labels, want_labels)
  np.testing.assert_array_equal(labels, np.tile(
      3 * np.arange(N_IMAGES) + 1, VIEWS))  # view-major


def test_step_on_written_latents_matches_jax(written, monkeypatch):
  """Under attn_impl "xla" on both sides: the point is the latents' path,
  and the JAX step compiles faster without the interpreted kernels."""
  import test_torch_latent
  from small_vision_tpu.models import ae as jae
  monkeypatch.setattr(test_torch_latent, "jax_model", lambda c: jae.Model(
      **{"scan": False, **c["model"]}))
  root, _, _, vae = written
  src = tcore.get(f"arrays:{os.path.dirname(root)}", split="train")
  batch = [ex["image"] for ex, _ in zip(src.examples(ordered=True),
                                        range(B))]
  lat = np.stack(batch).astype(np.float32)
  assert lat.shape == (B,) + LATENT
  cap = install_capture(monkeypatch)
  config = latent_config(pre_latents=True)
  config["model"]["attn_impl"] = "xla"
  params = convert.init_params(config, seed=3)
  rng = np.random.default_rng(21)
  n_noise = B - int(B * config["no_noise_prob"])
  t = rng.integers(0, 1000, (n_noise,)).astype(np.int32)
  noise = rng.standard_normal((n_noise,) + LATENT).astype(np.float32)

  def no_encode(*_):
    raise AssertionError("the encode ran on preprocessed latents")
  jstate, jupdate = _jax_step(config, params, vae[4], no_encode, cap,
                              pre_latents=True)
  keys = jax.random.split(jax.random.PRNGKey(1000), 6)
  jbatch = {"image": lat, "_t": t, "_noise": noise}
  for name, key in zip(("_rng_mae", "_cfg_mae", "_mae_mae", "_rng_dit",
                        "_mae_dit", "_cfg_dit"), keys):
    jbatch[name] = key
  jstate, jmeas = jupdate.with_l2(jstate, jbatch)
  jax.effects_barrier()
  names, tstate, tupdate = _port_step(config, params,
                                      (vae[0], no_encode) + vae[2:])
  draws = {"t": t.astype(np.int64), "noise": noise,
           "mae_noise": cap.uniforms[config["mask_ratio_no_noise"]],
           "dit_noise": cap.uniforms[config["mask_ratio"]]}
  tmeas = tupdate(tstate, {"image": lat}, draws, with_l2=True)
  np.testing.assert_allclose(float(tmeas["training_loss"]),
                             float(jmeas["training_loss"]), rtol=1e-5)
  np.testing.assert_allclose(float(tmeas["l2_grads"]),
                             float(jmeas["l2_grads"]), rtol=1e-4)
  jnu = joptim.find_states(jstate["opt"], optax.ScaleByAdamState)[0].nu
  check_step1_grads(names, (jax.device_get(jmeas), tmeas, flat(jnu),
                            tstate["opt"]["nu"]), 2e-5)
