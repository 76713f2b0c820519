"""The port's native JPEG decoder against the JAX package's.

The port builds its own copy of `sv_dataloader.cpp` with g++ into
`small_vision_tpu_torch/_build/`; on seeded JPEGs written by PIL it must
give the bits of the JAX package's library, for `decode`,
`decode_inception_crop` and the batch call, and report bad JPEGs the same
way. `decode_jpeg_and_inception_crop` then matches the JAX op exactly on
its native path (per example and per chunk). Where the native decoder is
unavailable the op takes its PIL path with the same rng state as the JAX
op's; PIL's crop is then resized by the bilinear resize, held to the
tolerance of tests/test_torch_pp.py against TensorFlow.

The JAX package's library is built by each test process itself, with the
package's own g++ command, into a temporary directory of its own, and the
imported JAX module is pointed at it for the test.
"""

import io
import logging
import os
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image

from small_vision_tpu.data import native_jpeg as jnative
from small_vision_tpu.pp import builder as jbuilder
import small_vision_tpu.pp.ops_general  # noqa: F401 (registers the JAX ops)
import small_vision_tpu.pp.ops_image  # noqa: F401
from small_vision_tpu_torch.data import native_jpeg as tnative
from small_vision_tpu_torch.pp import builder as tbuilder

SHAPES = [(300, 200), (123, 456), (64, 64), (375, 500), (17, 9)]


def _build_jax_library(out_dir):
  """Builds the JAX package's `sv_dataloader.cpp` with its own g++ command
  into `out_dir`; returns the library's path, or the reason it cannot be
  built here (no g++, no libjpeg headers or library)."""
  if shutil.which("g++") is None:
    return None, "g++ is not installed"
  src = os.path.join(jnative._SRC_DIR, "sv_dataloader.cpp")
  so = os.path.join(out_dir, "sv_dataloader.so")
  proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-pthread", src,
                         "-o", so, "-ljpeg"], capture_output=True, text=True)
  if proc.returncode != 0:
    if "jpeglib.h" in proc.stderr or "-ljpeg" in proc.stderr:
      return None, f"libjpeg is missing: {proc.stderr.strip()[-300:]}"
    pytest.fail(f"g++ failed on the JAX package's decoder: {proc.stderr}")
  return so, None


@pytest.fixture(scope="session")
def jax_library(tmp_path_factory):
  """The JAX package's decoder, built by this process alone into its own
  temporary directory. The package builds `_native/sv_dataloader.so` in
  place, so test processes that start at once could load one another's
  half-written file; a private build cannot."""
  return _build_jax_library(str(tmp_path_factory.mktemp("jax_native")))


@pytest.fixture
def native(jax_library, monkeypatch):
  """Both libraries; the JAX package's from this process's own build, the
  port's from its build directory."""
  so, reason = jax_library
  if so is None:
    pytest.skip(f"the JAX package's native decoder does not build here "
                f"({reason}), so there is nothing to hold the port's "
                f"against")
  monkeypatch.setattr(jnative, "_SO_PATH", so)
  monkeypatch.setattr(jnative, "_LIB", None)
  monkeypatch.setattr(jnative, "_TRIED", False)
  if not jnative.available():
    pytest.fail(f"the JAX package's decoder built into {so} but does not "
                "load")
  assert tnative.available(), tnative.status()
  assert tnative.status().startswith("native (sv_dataloader-")
  assert str(tnative.BUILD_DIR).endswith("small_vision_tpu_torch/_build")


def _jpeg(h, w, seed=0, quality=90, mode="RGB"):
  rng = np.random.default_rng(seed)
  base = rng.integers(0, 256, (12, 12, 3), dtype=np.uint8)
  img = Image.fromarray(base).resize((w, h), Image.BILINEAR)
  noise = rng.integers(0, 40, (h, w, 3), dtype=np.uint8)
  img = Image.fromarray(np.asarray(img) // 2 + noise).convert(mode)
  buf = io.BytesIO()
  img.save(buf, format="JPEG", quality=quality)
  return buf.getvalue()


def _png(h, w, seed=0):
  img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, format="PNG")
  return buf.getvalue()


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_decode_is_bit_equal_to_jax(native, mode, quality):
  for i, (h, w) in enumerate(SHAPES):
    raw = _jpeg(h, w, i, quality, mode)
    got, want = tnative.decode(raw), jnative.decode(raw)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out", [(64, 64), (32, 48), (224, 224)])
@pytest.mark.parametrize("areas", [(0.05, 1.0), (0.8, 1.0), (1.0, 1.0)])
def test_decode_inception_crop_is_bit_equal_to_jax(native, out, areas):
  for i, (h, w) in enumerate(SHAPES):
    raw = _jpeg(h, w, i)
    for seed in (0, 1, 2**63 - 1, 12345678901234):
      got = tnative.decode_inception_crop(raw, *out, *areas, seed=seed)
      want = jnative.decode_inception_crop(raw, *out, *areas, seed=seed)
      np.testing.assert_array_equal(got, want)


def test_batch_call_is_bit_equal_to_jax_and_to_single_calls(native):
  raws = [_jpeg(h, w, i) for i, (h, w) in enumerate(SHAPES * 3)]
  seeds = [int(s) for s in np.random.default_rng(5).integers(0, 2**63, 15)]
  got, rcs = tnative.decode_inception_crop_batch(raws, 64, 64, 0.3, 1.0,
                                                 seeds, n_threads=4)
  want, jrcs = jnative.decode_inception_crop_batch(raws, 64, 64, 0.3, 1.0,
                                                   seeds)
  np.testing.assert_array_equal(rcs, jrcs)
  assert (rcs == 0).all() and got.shape == (15, 64, 64, 3)
  np.testing.assert_array_equal(got, want)
  for raw, seed, row in zip(raws, seeds, got):
    np.testing.assert_array_equal(
        row, tnative.decode_inception_crop(raw, 64, 64, 0.3, 1.0, seed))
  empty, empty_rcs = tnative.decode_inception_crop_batch([], 8, 8, 0.5, 1.0,
                                                         [])
  assert empty.shape == (0, 8, 8, 3) and empty_rcs.shape == (0,)


BAD = [b"", b"not a jpeg at all", b"\xff\xd8\xff\xe0" + b"\x00" * 30]


def test_bad_jpegs_are_reported_as_jax_reports_them(native):
  good = _jpeg(40, 30)
  truncated = good[:len(good) // 2]  # libjpeg warns and decodes what it can
  png = _png(20, 20)
  for raw in BAD + [truncated, png]:
    outcomes = []
    for lib in (tnative, jnative):
      row = []
      for call in (lambda: lib.decode(raw),
                   lambda: lib.decode_inception_crop(raw, 16, 16, 0.5, 1.0,
                                                     3)):
        try:
          row.append(call())
        except ValueError as e:
          row.append(str(e))
      outcomes.append(row)
    for got, want in zip(*outcomes):
      if isinstance(want, str):
        assert got == want
      else:
        np.testing.assert_array_equal(got, want)
  raws = [good] + BAD + [truncated, png, good]
  seeds = list(range(len(raws)))
  got, rcs = tnative.decode_inception_crop_batch(raws, 16, 16, 0.5, 1.0,
                                                 seeds)
  want, jrcs = jnative.decode_inception_crop_batch(raws, 16, 16, 0.5, 1.0,
                                                   seeds)
  np.testing.assert_array_equal(rcs, jrcs)
  assert rcs[0] == rcs[-1] == 0 and (rcs[1:4] != 0).all() and rcs[5] != 0
  np.testing.assert_array_equal(got[rcs == 0], want[jrcs == 0])


SPEC = 'decode_jpeg_and_inception_crop(size=32, area_min=30)|keep("image")'


def _examples(raws, seed=9):
  return [{"image": raw, "_id": i,
           "_rng": np.random.default_rng((seed, 0, i))}
          for i, raw in enumerate(raws)]


def _run(builder, raws, batch):
  host = builder.get_preprocess_fn(SPEC)[0]
  exs = _examples(raws)
  outs = host.batch(exs) if batch else [host(ex) for ex in exs]
  return ([o["image"] for o in outs],
          [int(ex["_rng"].integers(0, 2**62)) for ex in exs])


@pytest.mark.parametrize("batch", [False, True])
def test_op_matches_jax_on_the_native_path(native, batch):
  """Per example and per chunk, with a PNG among the JPEGs (the native
  decoder rejects it and PIL decodes it, from the rng as the seed draw
  left it)."""
  pytest.importorskip("tensorflow", reason="the JAX op's PIL path resizes "
                      "with TensorFlow where it is installed")
  raws = [_jpeg(h, w, i) for i, (h, w) in enumerate(SHAPES)]
  raws.insert(2, _png(50, 70))
  got, got_rngs = _run(tbuilder, raws, batch)
  want, want_rngs = _run(jbuilder, raws, batch)
  assert got_rngs == want_rngs
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)
  single, _ = _run(tbuilder, raws, not batch)
  for g, s in zip(got, single):
    np.testing.assert_array_equal(g, s)


def test_pil_path_takes_the_same_rng_state_when_unavailable(native,
                                                            monkeypatch):
  pytest.importorskip("tensorflow", reason="the JAX op's PIL path resizes "
                      "with TensorFlow where it is installed")
  raws = [_jpeg(h, w, i) for i, (h, w) in enumerate(SHAPES)]
  monkeypatch.setattr(tnative, "available", lambda: False)
  monkeypatch.setattr(jnative, "available", lambda: False)
  assert tbuilder.get_preprocess_fn(SPEC)[0].batch(_examples(raws)) is None
  got, got_rngs = _run(tbuilder, raws, False)
  want, want_rngs = _run(jbuilder, raws, False)
  assert got_rngs == want_rngs
  for g, w in zip(got, want):
    off = np.abs(g.astype(int) - w.astype(int))
    assert g.shape == w.shape == (32, 32, 3)
    assert off.max() <= 1 and (off > 0).mean() <= 1e-3


def test_a_failed_build_reports_the_pil_path_once(tmp_path, monkeypatch,
                                                  caplog):
  bad = tmp_path / "broken.cpp"
  bad.write_text("this is not C++\n")
  monkeypatch.setattr(tnative, "_SRC", bad)
  monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
  monkeypatch.setattr(tnative, "_STATE", {})
  with caplog.at_level(logging.WARNING):
    assert not tnative.available()
    assert not tnative.available()
  assert tnative.status().startswith("PIL (native decoder unavailable: g++")
  assert len([r for r in caplog.records if "JPEG decoding" in
              r.getMessage()]) == 1
  with pytest.raises(RuntimeError, match="unavailable"):
    tnative.decode(_jpeg(8, 8))
  host = tbuilder.get_preprocess_fn(SPEC)[0]
  assert host.batch(_examples([_jpeg(20, 20)])) is None
  assert host(_examples([_jpeg(20, 20)])[0])["image"].shape == (32, 32, 3)


def test_a_library_that_does_not_load_is_rebuilt(native, tmp_path,
                                                  monkeypatch):
  """A library left by another machine (here: not a library at all) under
  the source's name is rebuilt, not given up for PIL."""
  monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
  monkeypatch.setattr(tnative, "_STATE", {})
  os.makedirs(tnative.BUILD_DIR)
  tnative._target().write_bytes(b"not an ELF file")
  assert tnative.available(), tnative.status()
  raw = _jpeg(40, 30)
  np.testing.assert_array_equal(tnative.decode(raw), jnative.decode(raw))
