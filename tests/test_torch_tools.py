"""The port's ingest tool against the JAX package's script: a small class
tree of PIL-written JPEGs (and a PNG and a grayscale JPEG) decoded into an
arrays dataset, bit for bit the script's `ingest_paths` output in `center`
and `stretch` modes; then read back by the port's arrays source."""

import importlib.util
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from small_vision_tpu_torch.data import core as tcore
from small_vision_tpu_torch.tools import ingest_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
  spec = importlib.util.spec_from_file_location(
      "ingest_imagenet_arrays",
      os.path.join(REPO, "scripts", "ingest_imagenet_arrays.py"))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _tree(root):
  """Three classes of images of several sizes and formats."""
  rng = np.random.default_rng(0)
  shapes = [(90, 70), (40, 120), (64, 64), (33, 17), (200, 150)]
  for c, name in enumerate(("n01", "n02", "n03")):
    os.makedirs(root / name)
    for i, (h, w) in enumerate(shapes[c:c + 3]):
      img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
      fmt, ext = (("PNG", "png") if (c, i) == (1, 1) else ("JPEG", "JPEG"))
      if (c, i) == (2, 0):
        img = img.convert("L")
      img.save(root / name / f"img{i}.{ext}", format=fmt, quality=90)
    (root / name / "notes.txt").write_text("not an image")
  return str(root)


@pytest.mark.parametrize("mode", ["center", "stretch"])
def test_ingest_matches_the_jax_script_bit_for_bit(tmp_path, mode):
  pytest.importorskip("tensorflow", reason="the JAX script resizes with "
                      "TensorFlow where it is installed")
  src = _tree(tmp_path / "tree")
  jax_script = _jax_script()
  paths, labels, names = ingest_arrays.list_dir_tree(src)
  jpaths, jlabels, jnames = jax_script.list_dir_tree(src)
  assert paths == jpaths and names == jnames == ["n01", "n02", "n03"]
  np.testing.assert_array_equal(labels, jlabels)
  out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
  ingest_arrays.ingest_paths(paths, labels, out_t, 24, mode, workers=3,
                             class_names=names, log=lambda s: None)
  jax_script.ingest_paths(jpaths, jlabels, out_j, 24, mode, workers=3,
                          class_names=jnames)
  for name in ("images.npy", "labels.npy"):
    np.testing.assert_array_equal(np.load(os.path.join(out_t, name)),
                                  np.load(os.path.join(out_j, name)))
  assert json.load(open(os.path.join(out_t, "meta.json"))) == \
      json.load(open(os.path.join(out_j, "meta.json")))
  src_t = tcore.get("arrays", root=out_t)
  assert src_t.total_examples == 9 and src_t.num_classes == 3


def test_ingest_cli_writes_a_parent_the_config_trains_on(tmp_path):
  src = _tree(tmp_path / "tree")
  root = tmp_path / "arrays"
  for split in ("train", "validation"):
    ingest_arrays.main(["--src", f"dir:{src}", "--out", str(root / split),
                        "--size", "16", "--workers", "2"])
  images = np.load(root / "train" / "images.npy")
  assert images.shape == (9, 16, 16, 3) and images.dtype == np.uint8
  ex = next(tcore.get(f"arrays:{root}", split="validation").examples(
      ordered=True))
  assert ex["image"].shape == (16, 16, 3) and int(ex["label"]) == 0
  flat = tmp_path / "flat"
  os.makedirs(flat)
  buf = io.BytesIO()
  Image.new("RGB", (20, 10)).save(buf, format="JPEG")
  (flat / "a.jpg").write_bytes(buf.getvalue())
  ingest_arrays.main(["--src", f"dir:{flat}", "--out", str(tmp_path / "u"),
                      "--size", "8", "--mode", "stretch"])
  assert not os.path.exists(tmp_path / "u" / "labels.npy")
  with pytest.raises(SystemExit, match="TensorFlow"):
    ingest_arrays.main(["--src", "tfds:imagenet2012", "--out", "x"])
  with pytest.raises(SystemExit, match="unknown --src"):
    ingest_arrays.main(["--src", "s3:bucket", "--out", "x"])
  with pytest.raises(ValueError, match="no input images"):
    ingest_arrays.ingest_paths([], None, str(tmp_path / "e"), 8)
