"""ctypes bindings of the native JPEG decode-and-crop core.

Counterpart of small_vision_tpu/data/native_jpeg.py, on the port's own copy
of the source (`_native/sv_dataloader.cpp`). The first use builds it with
`g++ -O3 -ljpeg` into `small_vision_tpu_torch/_build/`, named by a hash of
the source, and loads it:

  decode(jpeg_bytes)
  decode_inception_crop(jpeg_bytes, out_h, out_w, area_min, area_max, seed)
  decode_inception_crop_batch(jpegs, out_h, out_w, area_min, area_max,
                              seeds)

The calls release the GIL. Where the library cannot be built or loaded (no
g++ or no libjpeg), `available()` is False and the pp ops take their PIL
path, as the JAX package's do; `status()` says which decoder runs and why,
and the first load logs it once.
"""

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import threading

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "_native" / "sv_dataloader.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_STATE = {}  # "lib": the loaded CDLL or None, "status": what runs and why


def _target() -> pathlib.Path:
  h = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
  return BUILD_DIR / f"sv_dataloader-{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path):
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
  cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp), "-ljpeg"]
  proc = subprocess.run(cmd, capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"g++ failed: {proc.stderr.strip()[-400:]}")
  os.replace(tmp, out)  # processes that build at once never load half a file


def _bind(lib):
  lib.sv_decode_inception_crop.restype = ctypes.c_int
  lib.sv_decode_inception_crop.argtypes = [
      ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
      ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
      ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p]
  lib.sv_jpeg_dims.restype = ctypes.c_int
  lib.sv_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)]
  lib.sv_decode.restype = ctypes.c_int
  lib.sv_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                            ctypes.c_void_p]
  lib.sv_decode_inception_crop_batch.restype = ctypes.c_int
  lib.sv_decode_inception_crop_batch.argtypes = [
      ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
      ctypes.c_int, ctypes.c_int, ctypes.c_int,
      ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
      ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p,
      ctypes.POINTER(ctypes.c_int), ctypes.c_int]
  return lib


def _load():
  with _LOCK:
    if "status" not in _STATE:
      out = _target()
      try:
        if not out.exists():
          _build(out)
        try:
          lib = ctypes.CDLL(str(out))
        except OSError:  # built on another machine (a copied tree): rebuild
          _build(out)
          lib = ctypes.CDLL(str(out))
        _STATE["lib"] = _bind(lib)
        _STATE["status"] = f"native ({out.name})"
        logging.info("JPEG decoding: native libjpeg decoder %s", out.name)
      except (OSError, RuntimeError) as e:
        _STATE["lib"] = None
        _STATE["status"] = f"PIL (native decoder unavailable: {e})"
        logging.warning("JPEG decoding: %s", _STATE["status"])
    return _STATE["lib"]


def available() -> bool:
  return _load() is not None


def status() -> str:
  """"native (<library>)" or "PIL (native decoder unavailable: <why>)"."""
  _load()
  return _STATE["status"]


def _lib():
  lib = _load()
  if lib is None:
    raise RuntimeError(f"native JPEG decoder unavailable: {status()}")
  return lib


def decode_inception_crop(jpeg_bytes: bytes, out_h: int, out_w: int,
                          area_min: float, area_max: float, seed: int,
                          ar_lo: float = 0.75, ar_hi: float = 1.33,
                          max_attempts: int = 100) -> np.ndarray:
  """Fused decode, random crop and resize; raises ValueError on a JPEG the
  decoder rejects."""
  lib = _lib()
  out = np.empty((out_h, out_w, 3), np.uint8)
  rc = lib.sv_decode_inception_crop(
      jpeg_bytes, len(jpeg_bytes), out_h, out_w,
      float(area_min), float(area_max), ar_lo, ar_hi, max_attempts,
      ctypes.c_uint64(seed & (2**64 - 1)),
      out.ctypes.data_as(ctypes.c_void_p))
  if rc != 0:
    raise ValueError(f"native jpeg decode failed (rc={rc})")
  return out


def decode_inception_crop_batch(jpegs, out_h: int, out_w: int,
                                area_min: float, area_max: float, seeds,
                                ar_lo: float = 0.75, ar_hi: float = 1.33,
                                max_attempts: int = 100, n_threads: int = 0):
  """`decode_inception_crop` of each of `jpegs` with its seed, in one call
  on the library's own threads (all the cores for `n_threads` 0). Returns
  (out (N, h, w, 3) uint8, rcs (N,) int32, 0 where the image decoded);
  image i is bit-equal to `decode_inception_crop(jpegs[i], ..., seeds[i])`.
  """
  lib = _lib()
  n = len(jpegs)
  out = np.empty((n, out_h, out_w, 3), np.uint8)
  rcs = np.zeros(n, np.int32)
  if n == 0:
    return out, rcs
  # The c_char_p array points into the bytes objects, which `jpegs` keeps
  # alive for the call.
  datas = (ctypes.c_char_p * n)(*jpegs)
  lens = (ctypes.c_size_t * n)(*[len(b) for b in jpegs])
  seeds_arr = (ctypes.c_uint64 * n)(*[int(s) & (2**64 - 1) for s in seeds])
  lib.sv_decode_inception_crop_batch(
      datas, lens, n, out_h, out_w, float(area_min), float(area_max),
      ar_lo, ar_hi, max_attempts, seeds_arr,
      out.ctypes.data_as(ctypes.c_void_p),
      rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
  return out, rcs


def decode(jpeg_bytes: bytes) -> np.ndarray:
  """The whole image, uint8 RGB; raises ValueError on a bad JPEG."""
  lib = _lib()
  h, w = ctypes.c_int(), ctypes.c_int()
  rc = lib.sv_jpeg_dims(jpeg_bytes, len(jpeg_bytes),
                        ctypes.byref(h), ctypes.byref(w))
  if rc != 0:
    raise ValueError(f"bad jpeg header (rc={rc})")
  out = np.empty((h.value, w.value, 3), np.uint8)
  rc = lib.sv_decode(jpeg_bytes, len(jpeg_bytes),
                     out.ctypes.data_as(ctypes.c_void_p))
  if rc != 0:
    raise ValueError(f"native jpeg decode failed (rc={rc})")
  return out
