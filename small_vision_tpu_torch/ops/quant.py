"""Dynamic int8 matmul with a straight-through backward.

Counterpart of small_vision_tpu/ops/quant.py, which the model runs under
`quant="int8_mlp"` (the MLP's two products) and `"int8_all"` (also the
q, k, v and out-projections):

  - activations: a symmetric scale per row, max(absmax / 127, 1e-8), in f32;
  - weights:     a symmetric scale per column, the same way;
  - values round half to even and clip to [-127, 127];
  - the int8 product accumulates in int32 and is rescaled as
    (acc * sx) * sw in f32, then cast to x's dtype.

The JAX function is a plain `lax.dot_general`, not a Pallas kernel, and
so is the product here a library call: `torch._int_mm` (cuBLASLt's int8
GEMM) for CUDA tensors, which takes more than 16 rows and a K and an N
that are multiples of 8; any other shape raises, naming it. For CPU
tensors the plain version accumulates exactly, in int64 (an f32 sum is
not exact: at K = 3,072 the sums reach 3,072 * 127^2, past 2^24).

`int8_dot`'s backward is straight-through, as the JAX custom VJP: it
differentiates the unquantized product from the saved operands, dx = g
w^T in x's dtype and dw = x^T g cast to w's dtype, so only the forward
pays the quantization error.
"""

import torch

from small_vision_tpu_torch.parallel import collectives

_EPS = 1e-8
INT_MM_MIN_ROWS = 17   # torch._int_mm takes more than 16 rows
INT_MM_MULTIPLE = 8    # ... and a K and an N that are multiples of 8


def quantize(v: torch.Tensor, dim: int, group=None):
  """(int8 values, f32 scale) of `v`, symmetric absmax along `dim` (kept
  as a size-1 axis in the scale). With a `group` the absmax is the max
  over its processes, each holding a block of `dim`."""
  absmax = v.abs().float().amax(dim=dim, keepdim=True)
  collectives.all_reduce(absmax, group, "max")
  # A divisor on the tensor's device: CUDA divides by a host scalar as a
  # product with its reciprocal, which rounds differently from a division.
  scale = (absmax / absmax.new_full((), 127.0)).clamp_min(_EPS)
  q = torch.round(v.float() / scale).clamp(-127, 127)
  return q.to(torch.int8), scale


def int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
  """Exact int32 product of (M, K) and (K, N) int8 matrices: `_int_mm` for
  CUDA tensors, a float64 matmul for CPU tensors (exact: every partial sum
  is an integer of magnitude at most 2^14 K, below 2^53; an int64 matmul
  is not BLAS's and runs some 50 times longer)."""
  if xq.device.type == "cpu":
    if xq.shape[-1] >= 2 ** 39:
      return torch.matmul(xq.long(), wq.long()).to(torch.int32)
    return torch.matmul(xq.double(), wq.double()).to(torch.int32)
  if xq.device.type != "cuda":
    raise ValueError(f"int8 matmul on {xq.device}: CPU or CUDA tensors only")
  (m, k), n = xq.shape, wq.shape[1]
  if m < INT_MM_MIN_ROWS or k % INT_MM_MULTIPLE or n % INT_MM_MULTIPLE:
    raise ValueError(
        f"int8 matmul of ({m}, {k}) @ ({k}, {n}): torch._int_mm takes more "
        f"than 16 rows and a K and an N that are multiples of "
        f"{INT_MM_MULTIPLE}")
  return torch._int_mm(xq, wq)


def quantized_operands(x: torch.Tensor, w: torch.Tensor, group=None):
  """(xq (M, K), sx (M, 1), wq (K, N), sw (1, N)) with x flattened to rows.
  On the card wq is a column-major view (the int8 GEMM's own layout); its
  values are the same. `group`: see `int8_dot`."""
  xq, sx = quantize(x.reshape(-1, x.shape[-1]), -1, group)
  wq_t, sw_t = quantize(w.t(), -1, group)  # per column of w, as rows of w^T
  return xq, sx, wq_t.contiguous().t(), sw_t.t()


def int8_matmul(x: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
  """y = x @ w through int8 operands; x: (..., K), w: (K, N)."""
  xq, sx, wq, sw = quantized_operands(x, w, group)
  acc = int_matmul(xq, wq)
  y = (acc.float() * sx) * sw
  return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[1])


class _Int8Dot(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, w, group):
    ctx.save_for_backward(x, w)
    return int8_matmul(x, w, group)

  @staticmethod
  def backward(ctx, g):
    x, w = ctx.saved_tensors
    g = g.to(x.dtype)
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = torch.matmul(g, w.t().to(x.dtype))
    if ctx.needs_input_grad[1]:
      x2, g2 = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1])
      dw = torch.matmul(x2.t(), g2).to(w.dtype)
    return dx, dw, None


def int8_dot(x: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
  """Quantized forward, straight-through full-precision backward.

  `group`: the tensor-parallel group of a row-split product, whose
  processes each hold a block of the contraction dim K (x's columns and
  w's rows); the absmax of each activation row and of each weight column
  is then the max over the group, so that every process quantizes with
  the scales one process computes over the whole K, and the sum of the
  processes' products is the one process's product up to the rounding of
  each part."""
  return _Int8Dot.apply(x, w, group)


def quant_error(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """Relative Frobenius error of the int8 forward against the f32 product
  (for tests and diagnostics)."""
  exact = torch.matmul(x.float(), w.float())
  approx = int8_matmul(x, w).float()
  return torch.linalg.norm(approx - exact) / torch.linalg.norm(
      exact).clamp_min(_EPS)
