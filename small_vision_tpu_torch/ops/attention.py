"""Bidirectional attention on packed (B, L, H*D) tensors, forward.

Counterpart of small_vision_tpu/ops/attention.py::attention_packed (forward
only; the backward comes with the training slice). The softmax is the TPU
kernel's: exp2 of the log2e-scaled scores clamped to ±80 (no max shift), the
row sum over the unrounded f32 e, and e rounded to the input dtype before
the PV product. `attention_packed` runs the plain version for a tensor on
the CPU and the kernel (`csrc/attention_packed.cu`) for a CUDA tensor, and
raises for a CUDA tensor the kernel does not take.
"""

import ctypes
import functools

import numpy as np
import torch

from small_vision_tpu_torch.ops import _build

NAME = "attention_packed_fwd"
HEAD_DIM = 64  # The only head dim the kernel takes.
CLAMP = 80.0   # Softmax stability clamp, in log2 units.


def scale_log2(head_dim: int) -> float:
  """head_dim**-0.5 * log2(e), rounded as the JAX kernel rounds it (f32)."""
  return float(np.float32(
      (1.0 / np.sqrt(head_dim)) * np.float64(np.float32(np.log2(np.e)))))


def attention_packed_plain(q, k, v, num_heads):
  """Plain PyTorch version of `_attn_kernel_packed`'s math."""
  b, l, hd = q.shape
  d = hd // num_heads
  split = lambda t: t.reshape(b, l, num_heads, d).transpose(1, 2).float()
  scores = torch.matmul(split(q), split(k).transpose(-1, -2)) * scale_log2(d)
  e = torch.exp2(torch.clamp(scores, -CLAMP, CLAMP))
  s = e.sum(-1, keepdim=True)
  o = torch.matmul(e.to(q.dtype).float(), split(v)) / s
  return o.to(q.dtype).transpose(1, 2).reshape(b, l, hd)


@functools.cache
def _lib():
  lib = _build.library("attention_packed")
  fn = lib.attention_packed_fwd
  p, i = ctypes.c_void_p, ctypes.c_int
  fn.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, p]
  fn.restype = i
  lib.attention_packed_max_len.argtypes = []
  lib.attention_packed_max_len.restype = i
  return fn, lib.attention_packed_max_len()


def _require(cond, msg):
  if not cond:
    raise ValueError(f"{NAME}: {msg}")


def attention_packed_fwd(q, k, v, num_heads):
  """Launches the CUDA kernel on (B, L, H*64) bf16 contiguous q, k, v."""
  _require(q.is_cuda, "q must be a CUDA tensor")
  _require(q.dim() == 3, f"q must be (B, L, H*D), got {tuple(q.shape)}")
  b, l, hd = q.shape
  _require(hd == num_heads * HEAD_DIM,
           f"width {hd} != num_heads {num_heads} * head dim {HEAD_DIM}")
  for name, t in (("q", q), ("k", k), ("v", v)):
    _require(t.device == q.device and t.dtype == torch.bfloat16
             and t.shape == q.shape and t.is_contiguous()
             and t.data_ptr() % 16 == 0,
             f"{name} must be a contiguous, 16-byte aligned bfloat16 "
             f"{tuple(q.shape)} on {q.device}")
  fn, max_len = _lib()
  _require(l <= max_len, f"sequence length {l} > {max_len}")

  o = torch.empty_like(q)
  if q.numel() == 0:
    return o
  status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l,
              num_heads, scale_log2(HEAD_DIM),
              torch.cuda.current_stream(q.device).cuda_stream)
  _build.check(status, NAME)
  _build.LAUNCHES[NAME] += 1
  return o


def attention_packed(q, k, v, num_heads):
  """The plain version on CPU tensors, the CUDA kernel on CUDA tensors."""
  if q.device.type == "cpu":
    return attention_packed_plain(q, k, v, num_heads)
  return attention_packed_fwd(q, k, v, num_heads)
