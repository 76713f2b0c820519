"""Builds the CUDA kernels under `csrc/` with nvcc and loads them by ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and becomes its own shared
library `_build/<name>-<hash>.so`; the hash covers the source, every shared
header `csrc/*.cuh` and the flags, so an edited source or header is rebuilt
and a built one is reused. The first call starts one nvcc per source, all at
once, and waits for them; what nvcc and ptxas said (registers, spills and
shared memory of each kernel) is kept beside each library as
`_build/<name>-<hash>.log`. Nothing is built or loaded at import time, so
CPU-only machines import every module.

Launch counters live here too: each kernel wrapper adds one to its name's
count where it launches, so a run can show that it went through the kernels.
"""

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches by kernel name; `reset_launches()` zeroes them.
LAUNCHES = collections.Counter()


def reset_launches():
  LAUNCHES.clear()


def _nvcc() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc")
  if os.path.exists(default):
    return default
  raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                     "toolkit on PATH or under $CUDA_HOME")


def _target(src: pathlib.Path) -> pathlib.Path:
  h = hashlib.sha256(src.read_bytes())
  for header in sorted(CSRC.glob("*.cuh")):
    h.update(header.name.encode() + header.read_bytes())
  h.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


@functools.cache
def build_all() -> dict:
  """{source stem: path of its .so}; compiles what is missing, in parallel.

  Each library is written under a temporary name and renamed into place, so
  processes that build at the same time never load a half-written file.
  """
  sources = sorted(CSRC.glob("*.cu"))
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  todo = {s: _target(s) for s in sources if not _target(s).exists()}
  procs = []
  for src, out in todo.items():
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    procs.append((src, out, tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
  errors = []
  for src, out, tmp, proc in procs:
    log, _ = proc.communicate()
    if proc.returncode != 0:
      errors.append(f"nvcc failed on {src.name}:\n{log}")
      continue
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
  if errors:
    raise RuntimeError("\n".join(errors))
  return {s.stem: _target(s) for s in sources}


@functools.cache
def library(name: str) -> ctypes.CDLL:
  """The loaded library built from `csrc/<name>.cu`."""
  return ctypes.CDLL(str(build_all()[name]))


def check(status: int, what: str):
  """Raises when a C entry point returned a non-zero cudaError_t."""
  if status != 0:
    raise RuntimeError(f"{what}: CUDA error {status} at launch")
