"""Decodes a class-directory tree of images into an `arrays` dataset.

  python -m small_vision_tpu_torch.tools.ingest_arrays \\
      --src dir:/data/imagenet/train --out /data/i1k64/train \\
      [--size 64] [--mode center|stretch] [--workers 16]

Counterpart of scripts/ingest_imagenet_arrays.py for a directory tree: one
subdirectory per class (labels are the sorted subdirectory indices; a flat
directory of images gives no labels), decoded and resized on a thread pool
straight into `{out}/images.npy`, an (N, size, size, 3) uint8 memmap, with
`{out}/labels.npy` (N,) int64 and `{out}/meta.json`. Resize modes:

  center   resize_small(size) + central_crop(size), the eval pp;
  stretch  resize((size, size)), ignoring the aspect ratio.

Run it once for `train/` and once for `validation/` under one root, then
train with `--config ae_i1k.py:data=arrays:<root>`. Decoding takes PIL.
A `tfds:` source needs TensorFlow, which the port does not use: decode the
TFDS split with the JAX package's scripts/ingest_imagenet_arrays.py.
"""

import argparse
import concurrent.futures
import json
import os

import numpy as np

from small_vision_tpu_torch.pp import builder as pp_builder

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".JPEG", ".JPG", ".PNG")


def list_dir_tree(root):
  """(paths, labels or None, class names or None) of an image tree."""
  subdirs = sorted(d for d in os.listdir(root)
                   if os.path.isdir(os.path.join(root, d)))
  if subdirs:
    paths, labels = [], []
    for i, d in enumerate(subdirs):
      for f in sorted(os.listdir(os.path.join(root, d))):
        if f.endswith(_EXTS):
          paths.append(os.path.join(root, d, f))
          labels.append(i)
    return paths, np.asarray(labels, np.int64), subdirs
  paths = [os.path.join(root, f) for f in sorted(os.listdir(root))
           if f.endswith(_EXTS)]
  return paths, None, None


def make_pp(size, mode):
  spec = {"center": f"decode|resize_small({size})|central_crop({size})",
          "stretch": f"decode|resize(({size}, {size}))"}[mode]
  host_fn, _ = pp_builder.get_preprocess_fn(spec)
  return host_fn


def ingest_paths(paths, labels, out, size, mode="center", workers=16,
                 class_names=None, log=print):
  """Decodes and resizes `paths` into {out}/images.npy (+ labels.npy,
  meta.json)."""
  n = len(paths)
  if n == 0:
    raise ValueError("no input images found")
  os.makedirs(out, exist_ok=True)
  images = np.lib.format.open_memmap(
      os.path.join(out, "images.npy"), mode="w+", dtype=np.uint8,
      shape=(n, size, size, 3))
  host_fn = make_pp(size, mode)

  def work(i):
    with open(paths[i], "rb") as f:
      raw = f.read()
    img = host_fn({"image": raw})["image"]
    if img.ndim == 2:  # grayscale
      img = np.stack([img] * 3, axis=-1)
    images[i] = img

  with concurrent.futures.ThreadPoolExecutor(workers) as ex:
    for done, _ in enumerate(ex.map(work, range(n)), start=1):
      if done % 10_000 == 0:
        log(f"  {done}/{n}")
  images.flush()
  del images

  if labels is not None:
    np.save(os.path.join(out, "labels.npy"), np.asarray(labels, np.int64))
  with open(os.path.join(out, "meta.json"), "w") as f:
    json.dump({"n": n, "size": size, "mode": mode,
               "class_names": class_names}, f)
    f.write("\n")
  log(f"wrote {out}: {n} images @ {size}x{size}"
      f"{' + labels' if labels is not None else ''}")


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--src", required=True,
                  help="dir:/path/to/class-tree")
  ap.add_argument("--out", required=True)
  ap.add_argument("--size", type=int, default=64)
  ap.add_argument("--mode", default="center", choices=["center", "stretch"])
  ap.add_argument("--workers", type=int, default=16)
  args = ap.parse_args(argv)

  kind, _, src = args.src.partition(":")
  if kind == "tfds":
    raise SystemExit(
        "--src tfds:... needs TensorFlow, which the port does not use: "
        "decode the split with scripts/ingest_imagenet_arrays.py on a "
        "machine with TFDS, or export it as a directory tree")
  if kind != "dir":
    raise SystemExit(f"unknown --src kind {kind!r} (use dir:<class tree>)")
  paths, labels, names = list_dir_tree(src)
  ingest_paths(paths, labels, args.out, args.size, args.mode, args.workers,
               class_names=names)


if __name__ == "__main__":
  main()
