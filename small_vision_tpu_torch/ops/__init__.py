"""Diffusion math and the CUDA kernels with their plain versions.

Importing the package registers the kernels' forwards as the operators
`torch.ops.svt.*` (K1 `ln_modulate_fwd`, K3 `attention_packed_fwd`, K5
`fused_mlp_fwd`, K6 `fused_mha_fwd`), which a graph saved by
`torch.export` (`tools/export_sampler.py`) calls. Nothing is built here.
"""

from small_vision_tpu_torch.ops import attention  # noqa: F401
from small_vision_tpu_torch.ops import fused_block  # noqa: F401
from small_vision_tpu_torch.ops import layernorm  # noqa: F401
