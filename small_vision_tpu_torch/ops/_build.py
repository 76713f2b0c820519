"""Builds the CUDA kernels under `csrc/` with nvcc and loads them by ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and becomes its own shared
library `_build/<name>-<hash>.so`; the hash covers the source, every shared
header `csrc/*.cuh` and the flags, so an edited source or header is rebuilt
and a built one is reused. The first call starts one nvcc per source, all at
once, and waits for them; what nvcc and ptxas said (registers, spills and
shared memory of each kernel) is kept beside each library as
`_build/<name>-<hash>.log` (`ptxas_report` reads it). A library whose ptxas
report says that wgmma products were serialised for a divergent path (note
C7520) is refused: its kernels would run, at a fraction of their speed.
Nothing is built or loaded at import time, so CPU-only machines import
every module.

The argument types of every C entry point are declared here once, in
`SIGNATURES`, for this tree's libraries and for another checkout's that a
measuring tool builds beside them (`bind`). Kernel wrappers call their entry
points through `launch`, which makes the tensors' device current for the
call. Launch counters live here too: each kernel wrapper adds one to its
name's count where it launches, so a run can show that it went through the
kernels.
"""

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# {source stem: {C entry point: its argument types}}. Every entry point
# returns an int: a cudaError_t, a length limit or a count.
SIGNATURES = {
    # `*_any`: every other dtype (f32) and width, with the dtype (1 for
    # f32) and the elements of a load.
    "ln_modulate": {
        "ln_modulate_fwd": [_P] * 5 + [_I] + [_P] * 3 + [_I, _I, _I, _F, _P],
        "ln_modulate_fwd_any": [_P] * 5 + [_I] + [_P] * 3 + [_I, _I, _I, _F,
                                                             _I, _I, _P],
        "ln_modulate_max_width": [],
        "ln_modulate_any_max_width": []},
    "ln_modulate_bwd": {
        "ln_modulate_bwd": [_P] * 7 + [_I] + [_P] * 6 + [_I, _I, _I, _P],
        "ln_modulate_bwd_any": [_P] * 7 + [_I] + [_P] * 6 + [_I, _I, _I, _I,
                                                             _I, _P],
        "ln_modulate_bwd_work_words": [_I, _I, _I],
        "ln_modulate_bwd_max_width": [],
        "ln_modulate_bwd_any_max_width": []},
    # K3 and K4 in f32 (3xTF32 on wgmma): the forward, and the backward's
    # three kernels with the r and c scratch.
    "attention_packed_f32": {
        "attention_packed_f32_fwd": [_P] * 4 + [_I, _I, _I, _I, _F, _P],
        "attention_packed_f32_bwd": [_P] * 9 + [_I, _I, _I, _I, _F, _F, _P],
        "attention_packed_f32_max_len": [],
        "attention_packed_f32_max_head_dim": []},
    # K5-K8 in f32 (K5, K6 SIMT; K7, K8 3xTF32 on wgmma): the same
    # arguments as their bf16 entry points (K7's and K8's scale that of
    # K3's and K4's f32 ones: scale2, then K8's scale); K8's stage: 0
    # statistics, 1 dQ, 2 dK and dV.
    "fused_mlp_f32": {
        "fused_mlp_f32_fwd": [_P] * 7 + [_I, _I, _I, _P],
        "fused_mlp_f32_up": [_P] * 4 + [_I, _I, _I, _P],
        "fused_mlp_f32_down": [_P] * 4 + [_I, _I, _I, _P]},
    "fused_mha_f32": {
        "fused_mha_f32_fwd": [_P] * 12 + [_I, _I, _I, _I, _I, _F, _P],
        "fused_mha_f32_proj": [_P] * 8 + [_I, _I, _I, _I, _P],
        "fused_mha_f32_attention": [_P, _P, _I, _I, _I, _I, _F, _P],
        "fused_mha_f32_max_len": [],
        "fused_mha_f32_max_head_dim": []},
    "attention_unpacked_f32": {
        "attention_unpacked_f32_fwd": [_P] * 4 + [_I, _I, _I, _I, _F, _P],
        "attention_unpacked_f32_bwd": [_P] * 10 + [_I, _I, _I, _I, _F, _F,
                                                   _P],
        "attention_unpacked_f32_bwd_stage": [_P] * 10 + [_I, _I, _I, _I, _F,
                                                         _F, _I, _P],
        "attention_unpacked_f32_max_len": [],
        "attention_unpacked_f32_max_head_dim": []},
    # `*_fwd_streamed`: K and V streamed at every length (tests and
    # measurement; a tree from before it has no such entry point).
    # `*_chunked`: past head dim 256, fewer output column tiles a CTA than
    # the kernels' own (tests: the same bits at every chunk count).
    "attention_packed": {
        "attention_packed_fwd": [_P] * 4 + [_I, _I, _I, _I, _F, _P],
        "attention_packed_fwd_streamed": [_P] * 4 + [_I, _I, _I, _I, _F, _P],
        "attention_packed_fwd_chunked": [_P] * 4 + [_I, _I, _I, _I, _F, _I,
                                                    _P],
        "attention_packed_max_len": [_I],
        "attention_packed_max_head_dim": []},
    "attention_packed_bwd": {
        "attention_packed_bwd": [_P] * 9 + [_I, _I, _I, _I, _F, _F, _P],
        "attention_packed_bwd_chunked": [_P] * 9 + [_I, _I, _I, _I, _F, _F,
                                                    _I, _P],
        "attention_packed_bwd_max_len": [],
        "attention_packed_bwd_max_head_dim": []},
    "attention_unpacked": {
        "attention_unpacked_fwd": [_P] * 4 + [_I, _I, _I, _I, _F, _P],
        "attention_unpacked_fwd_streamed": [_P] * 4 + [_I, _I, _I, _I, _F,
                                                       _P],
        "attention_unpacked_fwd_chunked": [_P] * 4 + [_I, _I, _I, _I, _F, _I,
                                                      _P],
        "attention_unpacked_max_len": [_I],
        "attention_unpacked_max_head_dim": []},
    "attention_unpacked_bwd": {
        "attention_unpacked_bwd": [_P] * 10 + [_I, _I, _I, _I, _F, _P],
        "attention_unpacked_bwd_chunked": [_P] * 10 + [_I, _I, _I, _I, _F, _I,
                                                       _P],
        "attention_unpacked_bwd_stage": [_P] * 10 + [_I, _I, _I, _I, _F, _I,
                                                     _P],
        "attention_unpacked_bwd_max_len": [],
        "attention_unpacked_bwd_max_head_dim": []},
    "attention_ablate": {
        "attention_ablate_fwd": [_P] * 4 + [_I, _I, _I, _I, _F, _I, _P],
        "attention_ablate_max_len": [_I],
        "attention_ablate_max_head_dim": []},
    "fused_mlp": {
        "fused_mlp_fwd": [_P] * 7 + [_I, _I, _I, _P],
        "fused_mlp_up": [_P] * 4 + [_I, _I, _I, _P],
        "fused_mlp_down": [_P] * 4 + [_I, _I, _I, _P]},
    "fused_mha": {
        "fused_mha_fwd": [_P] * 12 + [_I, _I, _I, _I, _I, _F, _P],
        "fused_mha_proj": [_P] * 8 + [_I, _I, _I, _I, _P],
        "fused_mha_attention": [_P, _P, _I, _I, _I, _I, _F, _P],
        "fused_mha_max_len": [_I],
        "fused_mha_max_head_dim": []},
}

# ptxas's note that a kernel's wgmma products were serialised because of a
# compiler-inserted warpgroup arrive in a divergent path: a build that says
# it fails (`build_all`).
SERIALISED_DIVERGENT = "C7520"

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
    serialised = [k for k, r in ptxas_report(log).items()
                  if SERIALISED_DIVERGENT in r["notes"]]
    if serialised:
      tmp.unlink()
      errors.append(f"ptxas serialised the wgmma products of {src.name} "
                    f"({SERIALISED_DIVERGENT}) in {serialised}")
      continue
    os.replace(tmp, out)
  if errors:
    raise RuntimeError("\n".join(errors))
  return {s.stem: _target(s) for s in sources}


def ptxas_report(log: str) -> dict:
  """{kernel's mangled name: {"registers", "spill_stores", "spill_loads"
  (bytes), "notes": the codes of ptxas's numbered notes on it, such as
  "C7511" or "C7520"}} from the output of nvcc with `-Xptxas -v`."""
  report, name = {}, None
  entry = lambda k: report.setdefault(k, {"registers": None, "spill_stores": 0,
                                          "spill_loads": 0, "notes": []})
  for line in log.splitlines():
    # A kernel's notes may come before the line that names it.
    m = re.search(r"Compiling entry function '([^']+)'", line)
    if m:
      name = m.group(1)
      entry(name)
      continue
    m = re.search(r"\((C\d+)\).* in (?:the )?function '([^']+)'", line)
    if m:
      notes = entry(m.group(2))["notes"]
      if m.group(1) not in notes:
        notes.append(m.group(1))
      continue
    if name is None:
      continue
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    if m:
      report[name]["spill_stores"] = int(m.group(1))
      report[name]["spill_loads"] = int(m.group(2))
    m = re.search(r"Used (\d+) registers", line)
    if m:
      report[name]["registers"] = int(m.group(1))
  return report


def build_log(name: str) -> str:
  """What nvcc and ptxas said when `csrc/<name>.cu` was built."""
  return build_all()[name].with_suffix(".log").read_text()


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
  """`lib`, a library built from a `<name>.cu`, with `SIGNATURES[name]` set
  on each of those entry points that it has (another checkout's library
  may lack some)."""
  for entry, args in SIGNATURES[name].items():
    if hasattr(lib, entry):
      getattr(lib, entry).argtypes = args
      getattr(lib, entry).restype = _I
  return lib


@functools.cache
def library(name: str) -> ctypes.CDLL:
  """The loaded library built from `csrc/<name>.cu`, its entry points
  bound."""
  return bind(ctypes.CDLL(str(build_all()[name])), name)


def check(status: int, what: str):
  """Raises when a C entry point returned a non-zero cudaError_t."""
  if status != 0:
    raise RuntimeError(f"{what}: CUDA error {status} at launch")


_THREAD = threading.local()


def launch(what: str, device: torch.device, entry, *args):
  """Calls the C entry point `entry(*args, stream)`, `stream` being the
  current stream of `device`, with `device` current; raises as `check`
  does. The calling thread's current device is the same afterwards.

  A thread that has run no CUDA work yet (autograd's, when a kernel's
  backward is the first thing it runs) has no current context, and there
  `cuTensorMapEncodeTiled` fails. `torch.cuda.device` does not bind one
  when the device is already the current one, as it is on such a thread;
  `torch.cuda.set_device` does, so each thread's first launch calls it
  (with `device` already current, so the device does not change).
  """
  if device.index != torch.cuda.current_device():
    with torch.cuda.device(device):
      return launch(what, device, entry, *args)
  if not getattr(_THREAD, "has_context", False):
    torch.cuda.set_device(device)
    _THREAD.has_context = True
  check(entry(*args, torch.cuda.current_stream(device).cuda_stream), what)
