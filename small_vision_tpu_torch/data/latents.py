"""Precomputed VAE latents: the TFRecord source, and the writer into an
`arrays` split.

Counterpart of small_vision_tpu/data/latents.py, without TensorFlow (the
card's machine has neither TF nor protobuf).

The source reads the JAX writer's TFRecord files: records framed as
`uint64 length | uint32 masked crc32c(length) | data | uint32 masked
crc32c(data)`, each a `tf.train.Example` with two features, `image` (the
flat float32 (32, 32, 4) latent) and `label` (one int64), decoded here by
hand from protobuf's wire format (a float list packed as one
length-delimited run of little-endian f32s, or unpacked as one fixed32
field a value; an int64 list likewise as varints). Each record's length
CRC is checked; the data CRC too with `check_data_crc=True` (a pure-Python
CRC over 16 KB a record is slow).

Order and sharding: `ordered=True` reads the files in sorted order, record
by record, which is the JAX source's order. The shuffled order is the
port's own: a permutation of all records per `(seed, epoch)` (tf.data's
shuffle buffer cannot be reproduced without TF; a documented divergence).
Each process takes every `count`-th record of that stream from its
`index` (`core.process_shard()`; tf.data's `shard`), and `_id` is the
position in the process's stream, as in JAX. `peek` is the first record
globally.

`precompute_latents(source, vae_encode, out_root)` encodes a pixel source
into an `arrays` split (`images.npy` float32 (N, 32, 32, 4) at 256 px and
`labels.npy`), written through `np.lib.format.open_memmap` (ImageNet's 4
views are about 84 GB), in the JAX writer's order: view-major, the
source's ordered examples in full batches (a last partial batch is
dropped, as there), each batch's noise from one `torch.Generator`. The
trainer reads it as `data=arrays:<root>` with `use_preprocessed_latents`
and the pp `keep("image", "label")`.
"""

import glob as globlib
import os
import struct
from typing import Iterator

import numpy as np

from small_vision_tpu_torch.data import core

LATENT_SHAPE = (32, 32, 4)

_CRC_TABLE = []
for _i in range(256):
  _c = _i
  for _ in range(8):
    _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
  _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
  """CRC-32C (Castagnoli) of `data`."""
  crc = 0xFFFFFFFF
  for b in data:
    crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
  """TFRecord's masked CRC-32C."""
  crc = crc32c(data)
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_records(path: str, offsets=None, check_data_crc=False):
  """Yields the records of a TFRecord file (at `offsets`, or all in
  order), checking each length's CRC (and the data's)."""
  with open(path, "rb") as f:
    if offsets is not None:
      for off in offsets:
        f.seek(off)
        yield _read_one(f, path, check_data_crc)
      return
    while True:
      rec = _read_one(f, path, check_data_crc)
      if rec is None:
        return
      yield rec


def _read_one(f, path, check_data_crc):
  head = f.read(12)
  if not head:
    return None
  if len(head) != 12:
    raise ValueError(f"{path}: truncated record header")
  length_bytes = head[:8]
  (length,) = struct.unpack("<Q", length_bytes)
  (length_crc,) = struct.unpack("<I", head[8:])
  if masked_crc(length_bytes) != length_crc:
    raise ValueError(f"{path}: corrupt record length at {f.tell() - 12}")
  data = f.read(length)
  tail = f.read(4)
  if len(data) != length or len(tail) != 4:
    raise ValueError(f"{path}: truncated record")
  if check_data_crc and masked_crc(data) != struct.unpack("<I", tail)[0]:
    raise ValueError(f"{path}: corrupt record data")
  return data


def record_offsets(path: str) -> list:
  """The byte offset of every record of a TFRecord file (headers only)."""
  offsets = []
  size = os.path.getsize(path)
  with open(path, "rb") as f:
    pos = 0
    while pos < size:
      f.seek(pos)
      (length,) = struct.unpack("<Q", f.read(8))
      offsets.append(pos)
      pos += 12 + length + 4
  return offsets


def _varint(buf, pos):
  result = shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _fields(buf):
  """(field number, wire type, value) of a protobuf message: the value is
  an int (varint), bytes (length-delimited) or the raw 4 or 8 bytes."""
  pos, n = 0, len(buf)
  while pos < n:
    key, pos = _varint(buf, pos)
    number, wire = key >> 3, key & 7
    if wire == 0:
      value, pos = _varint(buf, pos)
    elif wire == 2:
      size, pos = _varint(buf, pos)
      value, pos = buf[pos:pos + size], pos + size
    elif wire == 5:
      value, pos = buf[pos:pos + 4], pos + 4
    elif wire == 1:
      value, pos = buf[pos:pos + 8], pos + 8
    else:
      raise ValueError(f"protobuf wire type {wire} is not supported")
    yield number, wire, value


def _values(feature, kind):
  """The values of a Feature's float (kind 2) or int64 (kind 3) list, packed
  or not."""
  for number, _, lst in _fields(feature):
    if number != kind:
      continue
    out = []
    for _, wire, v in _fields(lst):
      if kind == 2:
        out.append(np.frombuffer(v, "<f4"))  # packed run or one fixed32
      elif wire == 2:  # packed varints
        pos, vals = 0, []
        while pos < len(v):
          x, pos = _varint(v, pos)
          vals.append(x)
        out.append(np.array(vals, np.uint64).astype(np.int64))
      else:
        out.append(np.array([v], np.uint64).astype(np.int64))
    return np.concatenate(out) if out else np.zeros(0, "<f4" if kind == 2
                                                    else np.int64)
  raise ValueError(f"feature has no {'float' if kind == 2 else 'int64'} "
                   "list")


def parse_example(record: bytes) -> dict:
  """{feature name: raw Feature bytes} of a serialized tf.train.Example."""
  out = {}
  for number, _, features in _fields(memoryview(record)):
    if number != 1:
      continue
    for fnum, _, entry in _fields(features):
      if fnum != 1:
        continue
      key = value = None
      for enum, _, v in _fields(entry):
        if enum == 1:
          key = bytes(v).decode()
        elif enum == 2:
          value = v
      out[key] = value
  return out


def decode_latent(record: bytes) -> dict:
  """{"image": (32, 32, 4) float32, "label": int64} of one record."""
  feats = parse_example(record)
  image = _values(feats["image"], 2)
  (label,) = _values(feats["label"], 3)
  return {"image": image.astype(np.float32).reshape(LATENT_SHAPE),
          "label": np.int64(label)}


class DataSource(core.DataSource):
  """The records of the TFRecord files matching `pattern`."""

  def __init__(self, *, pattern: str = "", num_examples: int = None,
               split: str = "train", check_data_crc: bool = False):
    del split
    if not pattern:
      raise ValueError(
          "the latents source reads TFRecord files: pass pattern= (the "
          "JAX package's precompute_latents output). Or write an arrays "
          "split with data/latents.py::precompute_latents and train on "
          "data=arrays:<root> with use_preprocessed_latents=True and the "
          "pp keep(\"image\", \"label\"); or ingest the images "
          f"(`{core.INGEST_TOOL}`) and train on data=arrays:<root> with "
          "latent_diffusion=True, the step encoding them")
    self.files = sorted(globlib.glob(pattern))
    if not self.files:
      raise ValueError(f"no TFRecord files match {pattern!r}")
    self.check_data_crc = check_data_crc
    self._offsets = None
    self._total = num_examples

  def _index(self) -> list:
    """[(file, offset)] of every record, in the files' order."""
    if self._offsets is None:
      self._offsets = [(f, o) for f in self.files
                       for o in record_offsets(f)]
    return self._offsets

  @property
  def total_examples(self) -> int:
    if self._total is None:
      self._total = len(self._index())
    return self._total

  def _stream(self, ordered, seed, epoch):
    if ordered:
      for f in self.files:
        yield from read_records(f, check_data_crc=self.check_data_crc)
      return
    index = self._index()
    for i in np.random.default_rng((seed, epoch)).permutation(len(index)):
      f, off = index[i]
      yield from read_records(f, [off], self.check_data_crc)

  def examples(self, *, ordered: bool = False, seed: int = 0,
               epoch: int = 0) -> Iterator[dict]:
    index, count = core.process_shard()
    for i, record in enumerate(self._stream(ordered, seed, epoch)):
      if i % count == index:
        yield {**decode_latent(record), "_id": np.int64(i // count)}

  def peek(self) -> dict:
    """The first record globally (on a process whose shard is empty too)."""
    for record in read_records(self.files[0]):
      return {**decode_latent(record), "_id": np.int64(0)}
    raise ValueError(f"no records in {self.files[0]!r}")


def precompute_latents(source, vae_encode, out_root: str, *,
                       batch_size: int = 256, views: int = 4,
                       device="cuda") -> int:
  """Encodes `source`'s images `views` times into the `arrays` split
  `out_root`; returns the number of latents written.

  `vae_encode(images, generator) -> latents` encodes one batch of the
  source's stacked images (pre-processing them as it needs), drawing its
  noise from `generator` (one `torch.Generator(device)` seeded 0 for the
  whole run, as the JAX writer's key). Only full batches are encoded, as
  in the JAX writer."""
  import torch

  n = source.total_examples // batch_size * batch_size
  total = views * n
  os.makedirs(out_root, exist_ok=True)
  images = None  # made at the first batch, in the latents' shape
  labels = np.lib.format.open_memmap(
      os.path.join(out_root, "labels.npy"), mode="w+", dtype=np.int64,
      shape=(total,))
  generator = torch.Generator(device=device).manual_seed(0)
  pos = 0
  for _ in range(views):
    batch, ys = [], []
    for ex in source.examples(ordered=True):
      batch.append(ex["image"])
      ys.append(ex.get("label", 0))
      if len(batch) == batch_size:
        z = vae_encode(np.stack(batch), generator)
        z = z.detach().float().cpu().numpy() if hasattr(z, "detach") else z
        if images is None:
          images = np.lib.format.open_memmap(
              os.path.join(out_root, "images.npy"), mode="w+",
              dtype=np.float32, shape=(total,) + tuple(z.shape[1:]))
        images[pos:pos + batch_size] = z
        labels[pos:pos + batch_size] = ys
        pos += batch_size
        batch, ys = [], []
  if pos != total:
    raise ValueError(f"the source gave {pos // views} of its "
                     f"{source.total_examples} examples")
  if images is not None:
    images.flush()
  labels.flush()
  del images, labels
  return total
