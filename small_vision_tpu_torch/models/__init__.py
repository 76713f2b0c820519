"""The models: embeddings, ViT blocks and the ViT classifier, the UMD
auto-encoder, the VAE."""

import importlib


def get_model_module(name: str):
  """The module `small_vision_tpu_torch.models.<name>` (its `Model` is the
  factory the trainer builds), as the JAX package's `get_model_module`."""
  return importlib.import_module(f"small_vision_tpu_torch.models.{name}")
