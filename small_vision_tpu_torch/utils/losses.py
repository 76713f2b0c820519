"""Classification and contrastive loss helpers.

Counterpart of small_vision_tpu/utils/losses.py: sigmoid and softmax
cross-entropy (with label smoothing and normalisation options) and the
bidirectional contrastive loss.
"""

from typing import Optional

import torch
import torch.nn.functional as F


def onehot(labels, num_classes, *, on_value=1.0, off_value=0.0):
  x = labels[..., None] == torch.arange(num_classes, device=labels.device)
  return torch.where(x, on_value, off_value).to(torch.float32)


def sigmoid_xent(*, logits, labels, reduction: bool = True):
  """Numerically stable multi-label sigmoid cross-entropy."""
  log_p = F.logsigmoid(logits)
  log_not_p = F.logsigmoid(-logits)
  nll = -torch.sum(labels * log_p + (1.0 - labels) * log_not_p, dim=-1)
  return torch.mean(nll) if reduction else nll


def softmax_xent(*, logits, labels, reduction: bool = True, kl: bool = False,
                 axis: int = -1):
  """Softmax cross-entropy over (possibly soft) label distributions."""
  log_p = F.log_softmax(logits, dim=axis)
  nll = -torch.sum(labels * log_p, dim=axis)
  if kl:
    nll = nll + torch.sum(
        labels * torch.log(torch.clamp(labels, min=1e-8)), dim=axis)
  return torch.mean(nll) if reduction else nll


def weighted_softmax_xent(*, logits, labels, reduction: bool = True,
                          weights: Optional[torch.Tensor] = None,
                          label_smoothing: float = 0.0,
                          normalize: bool = True):
  """Token-weighted xent for (B, L, V) logits and (B, L) int labels."""
  vocab = logits.shape[-1]
  confidence = 1.0 - label_smoothing
  low = label_smoothing / (vocab - 1) if vocab > 1 else 0.0
  soft = onehot(labels, vocab, on_value=confidence, off_value=low)
  loss = -torch.sum(soft * F.log_softmax(logits, dim=-1), dim=-1)
  norm = torch.ones(labels.shape[:1], dtype=torch.float32,
                    device=logits.device) * labels.shape[1]
  if weights is not None:
    loss = loss * weights
    norm = weights.sum(dim=tuple(range(1, weights.ndim)))
  loss = loss.sum(dim=tuple(range(1, loss.ndim)))
  if normalize:
    loss = loss / torch.clamp(norm, min=1.0)
  return torch.mean(loss) if reduction else loss


def bidirectional_contrastive_loss(zimg, ztxt, t=1.0, mask=None,
                                   reduction: bool = False):
  """CLIP-style InfoNCE in both directions over in-batch negatives."""
  logits = torch.matmul(zimg, ztxt.T) * t
  if mask is not None:
    pair = (mask[None, :] * mask[:, None]).bool()
    logits = torch.where(pair, logits, -torch.inf)
  n = zimg.shape[0]
  eye = torch.eye(n, device=zimg.device)
  l1 = -torch.diag(F.log_softmax(logits, dim=1))   # img → txt
  l2 = -torch.diag(F.log_softmax(logits, dim=0))   # txt → img
  loss = 0.5 * (l1 + l2)
  if mask is not None:
    loss = torch.where(mask.bool(), loss, 0.0)
  if reduction:
    denom = mask.sum() if mask is not None else n
    correct = (torch.argmax(logits, dim=1)
               == torch.arange(n, device=zimg.device))
    return loss.sum() / denom, {"ncorrect": torch.sum(
        correct * (mask if mask is not None else 1.0))}
  return loss, {"logits": logits, "eye": eye}
