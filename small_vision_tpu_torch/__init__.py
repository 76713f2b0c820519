"""PyTorch/CUDA port of small_vision_tpu for NVIDIA Hopper.

The port mirrors the JAX package's layout (configs, utils, ops, models,
train, tools). Plain tensor code is PyTorch; each Pallas kernel on a ported
path is a CUDA kernel under `csrc/`, built with nvcc at first use
(`ops/_build.py`). Entry points run on the GPU unless the caller passes
`device="cpu"`; on CPU tensors each kernel wrapper runs its plain PyTorch
version instead.
"""
