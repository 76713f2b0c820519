"""Random token masking (MAE-style) with static keep-counts.

Counterpart of small_vision_tpu/ops/masking.py. The keep-count is
`len_keep = int(L * (1 - ratio))`; the shuffle is the argsort of uniform
noise (a random permutation per row) and the restore is a gather on its
inverse. The (B, L) uniform noise is an argument, so the caller decides
where the draws come from (the train step's generator, or injected).
"""

import torch


def random_masking(x, mask_ratio: float, noise):
  """Keeps a random `1 - mask_ratio` fraction of tokens per sequence.

  Args:
    x: (B, L, D) token sequence.
    mask_ratio: float in [0, 1).
    noise: (B, L) uniform draws; the kept tokens are the row's smallest.

  Returns:
    x_kept: (B, len_keep, D) the kept tokens, in shuffled order.
    mask: (B, L) in x's dtype; 1 where the token was masked, 0 kept.
    ids_restore: (B, L) inverse permutation for the decoder's gather.
  """
  b, l, d = x.shape
  len_keep = int(l * (1.0 - mask_ratio))
  # Stable, as jnp.argsort is: equal draws keep their order.
  ids_shuffle = torch.argsort(noise, dim=1, stable=True)
  ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)

  ids_keep = ids_shuffle[:, :len_keep]
  x_kept = torch.take_along_dim(x, ids_keep[:, :, None], dim=1)

  # The mask in shuffled order (first len_keep kept), then unshuffled.
  mask_shuffled = (torch.arange(l, device=x.device) >= len_keep).to(x.dtype)
  mask = torch.take_along_dim(mask_shuffled.expand(b, l), ids_restore, dim=1)
  return x_kept, mask, ids_restore


def restore_masked(x_kept, mask_token, ids_restore):
  """Decoder-side inverse: the kept tokens and mask tokens, back in order.

  Args:
    x_kept: (B, len_keep, D) encoder outputs of the kept tokens.
    mask_token: (1, 1, D) embedding for the masked positions.
    ids_restore: (B, L) inverse permutation from `random_masking`.

  Returns:
    (B, L, D) full-length sequence in the original patch order.
  """
  b, len_keep, d = x_kept.shape
  l = ids_restore.shape[1]
  mask_tokens = mask_token.to(x_kept.dtype).expand(b, l - len_keep, d)
  x_full = torch.cat([x_kept, mask_tokens], dim=1)
  return torch.take_along_dim(x_full, ids_restore[:, :, None], dim=1)


def sequence_mask_to_image_mask(mask, patch_size: int, img_size: int):
  """Expands a (B, L) patch mask to a (B, H, W, 1) pixel mask."""
  g = img_size // patch_size
  m = mask.reshape(-1, g, g)
  m = m.repeat_interleave(patch_size, dim=1).repeat_interleave(patch_size,
                                                               dim=2)
  return m[..., None]
