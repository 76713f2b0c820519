"""The port's data sources against the JAX package's: `parse_split`, the
arrays source's layouts and its single-split guard, the shuffled orders of
`examples` and `examples_from`, `even_split_range`, `core.get` and
`load_class_names`. Every comparison is exact."""

import os

import numpy as np
import pytest

from small_vision_tpu.data import arrays as jarrays
from small_vision_tpu.data import core as jcore
from small_vision_tpu.data import imagenet as jimagenet
from small_vision_tpu.data import synthetic as jsynthetic
from small_vision_tpu_torch.data import arrays as tarrays
from small_vision_tpu_torch.data import core as tcore
from small_vision_tpu_torch.data import imagenet as timagenet
from small_vision_tpu_torch.data import synthetic as tsynthetic

SPLITS = ["train", "validation", "train[:10]", "train[90:]", "train[5:7]",
          "validation[:10%]", "train[50%:75%]", "train[-10:]", "train[:-3]",
          "train[-200:]", "train[:100000]", "train[7:3]", "train[:]",
          "train[99%:]", "my-split[1:4]", "train[ 2 : 5 ]"]
BAD_SPLITS = ["train[1:2:3]", "tr ain", "train[5]", "train[:101%]",
              "train[x:]", "train[[1:2]]", ""]


@pytest.mark.parametrize("spec", SPLITS)
@pytest.mark.parametrize("n", [0, 1, 64, 100, 200])
def test_parse_split_matches_jax(spec, n):
  jbase, jbounds = jarrays.parse_split(spec)
  tbase, tbounds = tarrays.parse_split(spec)
  assert tbase == jbase
  assert tbounds(n) == jbounds(n)


@pytest.mark.parametrize("spec", BAD_SPLITS)
def test_parse_split_refuses_what_jax_refuses(spec):
  def outcome(parse):
    try:
      parse(spec)[1](100)
      return "ok"
    except ValueError:
      return "ValueError"
  assert outcome(tarrays.parse_split) == outcome(jarrays.parse_split) \
      == "ValueError"


def _write(root, n, seed, labels=True, size=4):
  rng = np.random.default_rng(seed)
  tarrays.write_arrays(
      str(root), rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
      rng.integers(0, 1000, (n,)) if labels else None)


def _same_examples(got, want):
  got, want = list(got), list(want)
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert set(g) == set(w)
    for k in w:
      np.testing.assert_array_equal(g[k], w[k])
      assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype


@pytest.mark.parametrize("labels", [True, False])
@pytest.mark.parametrize("split", ["train", "train[10:40]", "train[25%:]"])
def test_arrays_orders_match_jax(tmp_path, labels, split):
  _write(tmp_path, 50, 0, labels)
  jsrc = jcore.get("arrays", root=str(tmp_path), split=split)
  tsrc = tcore.get("arrays", root=str(tmp_path), split=split)
  assert tsrc.total_examples == jsrc.total_examples
  assert tsrc.num_local_examples == jsrc.num_local_examples
  assert tsrc.num_examples_per_process == jsrc.num_examples_per_process
  assert tsrc.num_classes == jsrc.num_classes
  _same_examples(tsrc.examples(ordered=True), jsrc.examples(ordered=True))
  for seed, epoch in ((0, 0), (0, 1), (3, 0), (3, 7)):
    _same_examples(tsrc.examples(seed=seed, epoch=epoch),
                   jsrc.examples(seed=seed, epoch=epoch))
    for start in (0, 1, 17):
      _same_examples(
          tsrc.examples_from(seed=seed, epoch=epoch, start=start),
          jsrc.examples_from(seed=seed, epoch=epoch, start=start))
  _same_examples([tsrc.peek()], [jsrc.peek()])


def test_arrays_layouts_and_single_split_guard_match_jax(tmp_path):
  """A parent of split directories serves each split; a single-split
  directory serves its own name, "train" and `split_frac`, and refuses
  another split name; a missing directory raises."""
  parent, single = tmp_path / "parent", tmp_path / "single" / "holdout"
  _write(parent / "train", 20, 1)
  _write(parent / "validation", 7, 2)
  _write(single, 12, 3)
  cases = [(parent, dict(split="train")),
           (parent, dict(split="validation")),
           (parent, dict(split="validation[2:5]")),
           (single, dict(split="train")),
           (single, dict(split="holdout[:50%]")),
           (single, dict(split="anything", split_frac=(0.25, 0.75))),
           (single, dict(split="validation")),
           (parent, dict(split="test")),
           (tmp_path / "nowhere", dict())]
  for root, kw in cases:
    outcomes = []
    for module in (jarrays, tarrays):
      try:
        src = module.DataSource(root=str(root), **kw)
        outcomes.append([int(e["_id"]) for e in src.examples(ordered=True)])
      except (ValueError, FileNotFoundError) as e:
        outcomes.append(type(e).__name__)
    assert outcomes[0] == outcomes[1], (root, kw)
  with pytest.raises(ValueError, match="single split"):
    tarrays.DataSource(root=str(single), split="validation")
  with pytest.raises(FileNotFoundError, match="ingest_arrays"):
    tarrays.DataSource(root=str(tmp_path / "nowhere"))


@pytest.mark.parametrize("total,count", [(0, 1), (10, 1), (10, 3), (7, 8),
                                         (50_000, 6), (1, 2)])
def test_even_split_range_matches_jax(total, count):
  for index in range(count):
    assert tcore.even_split_range(total, index, count) == \
        jcore.even_split_range(total, index, count)
  assert tcore.even_split_range(total) == \
      jcore.even_split_range(total, 0, 1)


def test_synthetic_examples_from_matches_jax():
  kw = dict(img_size=8, num_examples=40, pool=16, num_classes=7)
  jsrc, tsrc = jsynthetic.DataSource(**kw), tsynthetic.DataSource(**kw)
  assert tsrc.num_local_examples == jsrc.num_local_examples == 40
  for seed, epoch, start in ((0, 0, 0), (2, 3, 11), (2, 3, 39)):
    _same_examples(tsrc.examples_from(seed=seed, epoch=epoch, start=start),
                   jsrc.examples_from(seed=seed, epoch=epoch, start=start))
  _same_examples([tsrc.peek()], [jsrc.peek()])


def test_core_get_routes_like_jax(tmp_path):
  _write(tmp_path / "train", 9, 4)
  _write(tmp_path / "validation", 5, 5)
  for name, kw in ((f"arrays:{tmp_path}", {}),
                   (f"arrays:{tmp_path}", dict(split="validation")),
                   ("arrays", dict(root=str(tmp_path), split="train[2:]")),
                   ("synthetic", dict(img_size=4, num_examples=6))):
    t, j = tcore.get(name, **kw), jcore.get(name, **kw)
    assert type(t).__module__.startswith("small_vision_tpu_torch.data.")
    _same_examples(t.examples(seed=1, epoch=2), j.examples(seed=1, epoch=2))
  src = tcore.get("mod:small_vision_tpu_torch.data.synthetic", img_size=4,
                  num_examples=3)
  assert src.total_examples == 3


@pytest.mark.parametrize("name", ["tfds", "latents", "imagenet2012",
                                  "cifar10"])
def test_core_get_names_the_arrays_route_for_tfds_names(name):
  with pytest.raises(ValueError, match="arrays:") as e:
    tcore.get(name, split="train")
  assert "ingest_arrays" in str(e.value)


def test_load_class_names_from_a_file_and_its_cache(tmp_path, monkeypatch):
  names = [f"class {i}, n{i:08d}" for i in range(1000)]
  path = tmp_path / "names.txt"
  path.write_text("\n".join(names) + "\n\n")
  assert timagenet.load_class_names(str(path)) == \
      jimagenet.load_class_names(str(path)) == names
  cache = tmp_path / "cache" / "imagenet_classes.txt"
  os.makedirs(cache.parent)
  cache.write_text("\n".join(names))
  monkeypatch.setenv("SV_CLASS_NAMES_CACHE", str(cache))
  assert timagenet.default_cache() == jimagenet._default_cache() == str(cache)
  assert timagenet.load_class_names() == jimagenet.load_class_names() == names
  assert timagenet.load_class_names(cache=str(cache)) == names
  short = tmp_path / "short.txt"
  short.write_text("a\nb\n")
  with pytest.raises(ValueError, match="expected 1000"):
    timagenet.load_class_names(str(short))
  monkeypatch.setenv("SV_CLASS_NAMES_CACHE", str(tmp_path / "missing.txt"))
  with pytest.raises(RuntimeError, match="TFDS"):
    timagenet.load_class_names()
