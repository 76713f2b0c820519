"""The port's input pipeline against the JAX package's.

`TrainIterator`'s batches (`_id`, image and label bytes) against the JAX
`TrainIterator`'s on a 1-device CPU mesh, on the synthetic source and on an
arrays source with a host `inception_crop(32)` op (so that the per-example
rngs keyed (seed, epoch, _id) are held too), from step 0 and after a
`start_step` across an epoch boundary, with 1 and 4 workers;
`MixedSource` and `training()` (mixture ratios, the shared-device-stage
check, the unknown-key check), `make_for_inference` with a host stage (the
zero padding and `_mask`), a worker's exception reaching the consumer, and
the producer thread stopping when the consumer does. All exact.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from small_vision_tpu import parallel
from small_vision_tpu.data import pipeline as jpipeline
from small_vision_tpu.data import core as jcore
from small_vision_tpu.pp import registry as jregistry
from small_vision_tpu_torch.data import arrays as tarrays
from small_vision_tpu_torch.data import core as tcore
from small_vision_tpu_torch.data import pipeline as tpipeline
from small_vision_tpu_torch.pp import builder as tbuilder
from small_vision_tpu_torch.pp import registry as tregistry

PP = 'inception_crop(32)|flip_lr|value_range(-1, 1)|keep("image", "label")'


@pytest.fixture(scope="module")
def mesh():
  return parallel.make_mesh(jax.devices()[:1])


@pytest.fixture
def arrays_root(tmp_path):
  rng = np.random.default_rng(0)
  for split, n in (("train", 40), ("validation", 13)):
    tarrays.write_arrays(
        str(tmp_path / split),
        rng.integers(0, 256, (n, 48, 40, 3), dtype=np.uint8),
        rng.integers(0, 1000, (n,)))
  return str(tmp_path)


def _sources(kind, root):
  if kind == "synthetic":
    kw = dict(img_size=16, num_examples=40, num_classes=10, pool=24)
    return tcore.get("synthetic", **kw), jcore.get("synthetic", **kw), ""
  return (tcore.get(f"arrays:{root}"), jcore.get(f"arrays:{root}"), PP)


def _pipeline_threads():
  return [t for t in threading.enumerate()
          if t.name == "host-input-pipeline"]


def _assert_batches_equal(tbatches, jbatches):
  assert len(tbatches) == len(jbatches)
  for tb, jb in zip(tbatches, jbatches):
    assert set(tb) == set(jb)
    for k in jb:
      want = np.asarray(jb[k])
      got = tb[k].numpy() if isinstance(tb[k], torch.Tensor) else tb[k]
      # JAX holds int64 as int32 (x64 off); the port keeps the host's int64.
      assert got.dtype == want.dtype or (want.dtype, got.dtype) == (
          np.int32, np.int64), k
      np.testing.assert_array_equal(got, want)


def _take(it, n):
  gen = iter(it)
  out = [next(gen) for _ in range(n)]
  gen.close()
  return out


@pytest.mark.parametrize("kind", ["synthetic", "arrays"])
@pytest.mark.parametrize("start_step", [0, 1, 5])
@pytest.mark.parametrize("num_workers", [1, 4])
def test_train_iterator_matches_jax(mesh, arrays_root, kind, start_step,
                                    num_workers):
  """40 examples at batch 16: batches span epochs, and start_step 1 and 5
  resume mid-epoch and after two and a half epochs."""
  tsrc, jsrc, pp = _sources(kind, arrays_root)
  jit = jpipeline.TrainIterator(jsrc, pp, mesh, 16, seed=3, num_workers=1)
  tit = tpipeline.TrainIterator(tsrc, pp, 16, device="cpu", seed=3,
                                num_workers=num_workers, prefetch=1)
  jit.start_step = tit.start_step = start_step
  tbatches = _take(tit, 6)
  _assert_batches_equal(tbatches, _take(jit, 6))
  assert tbatches[0]["image"].dtype == torch.uint8
  assert tbuilder.split_stages(pp)[1] == "|".join(
      spec for spec, _, _ in tit.device_pp.ops)
  if start_step:  # the resumed stream is the straight one's continuation
    straight = _take(tpipeline.TrainIterator(tsrc, pp, 16, device="cpu",
                                             seed=3), start_step + 2)
    _assert_batches_equal(tbatches[:2], straight[start_step:])
  assert not _pipeline_threads()


def test_augmentation_draws_differ_across_epochs(arrays_root):
  tsrc = tcore.get(f"arrays:{arrays_root}")
  b0, b1 = _take(tpipeline.TrainIterator(
      tsrc, "inception_crop(32)", 40, device="cpu", seed=0), 2)
  img0 = b0["image"][np.argsort(b0["_id"].numpy())]
  img1 = b1["image"][np.argsort(b1["_id"].numpy())]
  assert not torch.equal(img0, img1)


def _mark(v):
  def op(ex):
    ex["src"] = np.int64(v)
    return ex
  return op


def _mix_cfg(pp_b='mark(1)|value_range(-1, 1)|keep("image", "src")'):
  syn = lambda n: {"name": "synthetic", "img_size": 8, "num_examples": n,
                   "num_classes": 10}
  return {"data": {"a": 3.0, "b": 1.0},
          "a": {"data": syn(100),
                "pp": 'mark(0)|value_range(-1, 1)|keep("image", "src")'},
          "b": {"data": syn(300), "pp": pp_b},
          "batch_size": 64, "num_workers": 1}


def test_mixture_matches_jax_and_its_ratios(mesh):
  with tregistry.temporary_ops(mark=_mark), \
      jregistry.temporary_ops(mark=_mark):
    tit, tdevice_pp, tn = tpipeline.training(_mix_cfg(), "cpu")
    jit, _, jn = jpipeline.training(_mix_cfg(), mesh)
    assert tn == jn == 400
    tbatches, jbatches = _take(tit, 32), _take(jit, 32)
  _assert_batches_equal(tbatches, jbatches)
  frac_b = np.concatenate([b["src"].numpy() for b in tbatches]).mean()
  assert abs(frac_b - 0.25) < 0.04, frac_b  # 2,048 draws
  assert [s for s, _, _ in tdevice_pp.ops] == [
      "value_range(-1, 1)", 'keep("image", "src")']


def test_mixture_refuses_divergent_device_stages():
  with tregistry.temporary_ops(mark=_mark):
    with pytest.raises(ValueError, match="device pp"):
      tpipeline.training(_mix_cfg('mark(1)|value_range(0, 1)'), "cpu")
  with pytest.raises(ValueError, match="training-only"):
    next(tpipeline.MixedSource([_sources("synthetic", None)[0]],
                               [1.0]).examples(ordered=True))
  with pytest.raises(ValueError, match="positive weight"):
    tpipeline.MixedSource([_sources("synthetic", None)[0]], [0.0])


def test_training_refuses_unknown_input_keys():
  cfg = {"data": {"name": "synthetic", "img_size": 8, "num_examples": 16},
         "batch_size": 8, "pp_fn": "value_range(-1, 1)"}  # `pp`, misspelt
  with pytest.raises(ValueError, match="pp_fn"):
    tpipeline.training(cfg, "cpu")
  cfg = {"data": {"name": "synthetic", "img_size": 8, "num_examples": 16},
         "batch_size": 8, "pp": "value_range(-1, 1)", "seed": 2,
         "num_workers": 3, "prefetch_to_device": 1}
  it, device_pp, n = tpipeline.training(cfg, "cpu")
  assert (n, it.seed, it.num_workers, it.prefetch) == (16, 2, 3, 1)
  assert device_pp is it.device_pp


def test_resume_of_a_source_of_unknown_length_warns_and_restarts(caplog):
  src = _sources("synthetic", None)[0]
  it = tpipeline.TrainIterator(tpipeline.MixedSource([src, src], [1, 1]),
                               "", 16, device="cpu", num_workers=1)
  it.start_step = 5
  with caplog.at_level("WARNING"):
    _take(it, 1)
  assert any("non-deterministic resume" in r.getMessage()
             for r in caplog.records)


@pytest.mark.parametrize("batch_size", [8, 13, 16, 64])
def test_make_for_inference_with_a_host_stage_matches_jax(
    mesh, arrays_root, batch_size):
  """13 validation examples through `central_crop(32)`: the last batch
  zero-padded, `_mask` on the real rows."""
  pp = 'central_crop(32)|value_range(-1, 1)|keep("image", "label")'
  kw = dict(split="validation")
  titer, device_pp, tsteps = tpipeline.make_for_inference(
      tcore.get(f"arrays:{arrays_root}", **kw), pp, batch_size,
      num_workers=2)
  jiter, _, jsteps = jpipeline.make_for_inference(
      jcore.get(f"arrays:{arrays_root}", **kw), pp, mesh, batch_size,
      num_workers=2)
  assert tsteps == jsteps == -(-13 // batch_size)
  tbatches = list(titer())
  _assert_batches_equal(tbatches, list(jiter()))
  mask = np.concatenate([b["_mask"] for b in tbatches])
  assert mask.sum() == 13 and not mask[13:].any()
  assert not tbatches[-1]["image"][mask[-batch_size:] == 0].any()
  assert tbatches[0]["image"].shape[1:] == (32, 32, 3)
  assert [s for s, _, _ in device_pp.ops] == ["value_range(-1, 1)",
                                              'keep("image", "label")']


class _EmptySource(tcore.DataSource):
  """No examples; `peek` gives the template of the padding."""

  total_examples = 0

  def examples(self, *, ordered=False, seed=0, epoch=0):
    return iter(())

  def peek(self):
    return {"image": np.ones((20, 20, 3), np.uint8), "label": np.int64(4),
            "_id": np.int64(0)}


def test_make_for_inference_of_an_empty_source_pads_from_peek():
  iterate, _, n_steps = tpipeline.make_for_inference(
      _EmptySource(), "central_crop(8)", 4)
  batches = list(iterate())
  assert n_steps == len(batches) == 1
  assert set(batches[0]) == {"image", "label", "_id", "_mask"}
  assert batches[0]["image"].shape == (4, 8, 8, 3)
  assert not batches[0]["image"].any() and not batches[0]["_mask"].any()


def _fail_on(bad_id):
  def op(ex):
    if int(ex["_id"]) == bad_id:
      raise ValueError(f"example {bad_id} is corrupt")
    return ex
  return op


@pytest.mark.parametrize("num_workers", [1, 4])
def test_a_worker_exception_reaches_the_consumer(num_workers):
  src = _sources("synthetic", None)[0]
  bad = int(next(src.examples(seed=0, epoch=1))["_id"])
  with tregistry.temporary_ops(fail_on=_fail_on):
    it = tpipeline.TrainIterator(src, f"fail_on({bad})", 8, device="cpu",
                                 num_workers=num_workers, prefetch=0)
    gen, taken = iter(it), 0
    with pytest.raises(RuntimeError, match="worker failed") as e:
      for taken in range(20):
        next(gen)
  assert 1 <= taken <= 10  # epoch 0's batches came out; epoch 1's stop
  chain, cause = [], e.value
  while cause is not None:
    chain.append(str(cause))
    cause = cause.__cause__
  assert any(f"example {bad} is corrupt" in c for c in chain), chain
  assert not _pipeline_threads()


def test_the_producer_stops_with_its_consumer():
  src = _sources("synthetic", None)[0]
  iterate, _, _ = tpipeline.make_for_inference(src, "", 4, num_workers=2)
  gen = iterate()
  next(gen)
  assert len(_pipeline_threads()) == 1
  gen.close()
  assert not _pipeline_threads()
  gen = iter(tpipeline.TrainIterator(src, "", 4, device="cpu"))
  next(gen)
  del gen
  assert not _pipeline_threads()


def test_to_device_keeps_strings_on_the_host():
  batch = {"image": np.zeros((2, 3), np.uint8), "name": np.array([b"a", b"b"]),
           "ok": np.array([True, False]), "w": np.ones(2, np.float32)}
  out = tpipeline.to_device(batch, "cpu")
  assert isinstance(out["name"], np.ndarray)
  assert out["image"].dtype == torch.uint8 and out["ok"].dtype == torch.bool
  assert out["w"].dtype == torch.float32
